"""Supervisor of the port's train CLI — the JAX package's
`scripts/supervise.sh` in Python, for `cli/train.py` of this package.

It runs the trainer with `--auto_resume` appended and restarts it by its
exit code until it exits 0 or the restarts run out; the restart command is
the start command, because auto-resume picks up the newest verified
checkpoint in `--out`:

    MAX_RESTARTS=5 python -m ddp_classification_pytorch_tpu_torch.cli.supervise \\
        baseline --dataset synthetic --model tresnet_m --out runs/x [flags...]

Exit codes, as the script classifies them:

- 0: done (logged `action=exit`);
- 2 (config/usage) and 8 (diverged): deterministic — a restart replays
  the same failure — so it stops and exits with them;
- 1 (an unhandled exception) and 9 (pod-inconsistent): restart after
  ``RUNTIME_BACKOFF_S`` (30);
- 3 (backend unreachable), 6 (rendezvous failed) and 10 (pod-unviable):
  outage-shaped, restart after ``OUTAGE_BACKOFF_S`` (300);
- 11 (pod-reform): every rank left together on purpose, restart after
  ``REFORM_BACKOFF_S`` (2);
- anything else (7 from the hang watchdog, a child killed by signal N,
  counted as 128 + N as the shell does): restart after 2 s.

After ``MAX_RESTARTS`` (5) restarts it gives up with the last rc. Every
exit of the child is appended to ``$OUT/restarts.log`` as the script
writes it (``<iso time> host= proc= rc= backoff=Ns attempt=n/max gen=
world= action=``, `gen=` and `world=` from ``$OUT/fleet/membership``);
before each restart the attempt number is max-written into
``$OUT/generation`` (`parallel/fleet.py::advance_generation`), and on an
elastic pod (``FLEET_ELASTIC=1``) a member of the cached membership
respawns with ``FLEET_PROCESS_ID`` / ``FLEET_NUM_PROCESSES`` re-exported
as its rank and size in the re-formed world. The child stays in the
supervisor's process group, so a `host_lost` fault kills both.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

from ..parallel import fleet

TRAIN = ["-m", "ddp_classification_pytorch_tpu_torch.cli.train"]
# rc -> (env knob of its backoff, its default) — the script's case table
BACKOFF = {1: ("RUNTIME_BACKOFF_S", "30"), 9: ("RUNTIME_BACKOFF_S", "30"),
           3: ("OUTAGE_BACKOFF_S", "300"), 6: ("OUTAGE_BACKOFF_S", "300"),
           10: ("OUTAGE_BACKOFF_S", "300"), 11: ("REFORM_BACKOFF_S", "2")}
STOP = {2: "config/usage error",
        8: "training diverged: sentinel hit max_bad_steps consecutive "
           "non-finite steps"}


def out_dir_of(args: Sequence[str]) -> str:
    """The value after the last `--out` ("" without one: no log)."""
    out, prev = "", ""
    for a in args:
        if prev == "--out":
            out = a
        prev = a
    return out


def membership_fields(out: str) -> Dict[str, str]:
    """{"gen", "world"} from the first line of ``$OUT/fleet/membership``
    ("-" each when it is absent or not a membership line)."""
    fields = {"gen": "-", "world": "-"}
    if not out:
        return fields
    try:
        with open(fleet.membership_path(out)) as f:
            line = f.readline().rstrip("\n")
    except OSError:
        return fields
    if line.startswith("gen="):
        fields["gen"] = line[len("gen="):].split(" ")[0]
        fields["world"] = line.rsplit("world=", 1)[-1].split(" ")[0]
    return fields


def backoff_for(rc: int, env: Dict[str, str]) -> str:
    """The backoff of a restartable rc, as the env spells it."""
    knob, default = BACKOFF.get(rc, (None, "2"))
    return (env.get(knob) or default) if knob else default


def reexport_membership(out: str, env: Dict[str, str]) -> None:
    """On an elastic pod, point a member of the cached membership at its
    rank and size in the re-formed world (in `env`); a recovered process
    not yet in it keeps its launch env and rejoins when the survivors
    re-form around it."""
    if env.get("FLEET_ELASTIC", "") in ("", "0") or not out:
        return
    try:
        with open(fleet.membership_path(out)) as f:
            line = f.readline().rstrip("\n")
    except OSError:
        return
    world = line.rsplit("world=", 1)[-1].split(" ")[0]
    me = env.get("FLEET_HOST_ID") or env.get("FLEET_PROCESS_ID") or ""
    if not world or world == line or not me:
        return
    hosts = world.split(",")
    if me in hosts:
        env["FLEET_PROCESS_ID"] = str(hosts.index(me))
        env["FLEET_NUM_PROCESSES"] = str(len(hosts))


def supervise(args: Sequence[str], *, command: Optional[List[str]] = None,
              env: Optional[Dict[str, str]] = None,
              sleep: Callable[[float], None] = time.sleep) -> int:
    """Run `command` (the port's train CLI) with `args` + `--auto_resume`
    until it exits 0, stops or runs out of restarts; returns the rc to
    exit with. `env` is the children's environment (default: this
    process's)."""
    env = dict(os.environ if env is None else env)
    command = command or [sys.executable, *TRAIN]
    max_restarts = int(env.get("MAX_RESTARTS") or 5)
    out = out_dir_of(args)
    host = socket.gethostname() or "?"
    proc = env.get("FLEET_HOST_ID") or env.get("FLEET_PROCESS_ID") or "-"
    n = 0

    def log_event(rc: int, backoff: str, action: str) -> None:
        if not out:
            return
        os.makedirs(out, exist_ok=True)
        mem = membership_fields(out)
        stamp = datetime.datetime.now().astimezone().isoformat(
            timespec="seconds")
        with open(os.path.join(out, "restarts.log"), "a") as f:
            f.write(f"{stamp} host={host} proc={proc} rc={rc} "
                    f"backoff={backoff}s attempt={n}/{max_restarts} "
                    f"gen={mem['gen']} world={mem['world']} "
                    f"action={action}\n")

    while True:
        rc = subprocess.run([*command, *args, "--auto_resume"],
                            env=env).returncode
        if rc < 0:  # killed by signal N: the shell's 128 + N
            rc = 128 - rc
        if rc == 0:
            log_event(0, "0", "exit")
            return 0
        if rc in STOP:
            print(f"[supervise] rc={rc} is deterministic ({STOP[rc]}); "
                  "not restarting", file=sys.stderr, flush=True)
            log_event(rc, "0", "stop")
            return rc
        backoff = backoff_for(rc, env)
        n += 1
        if n > max_restarts:
            print(f"[supervise] giving up after {n} failures (last rc={rc})",
                  file=sys.stderr, flush=True)
            log_event(rc, backoff, "give-up")
            return rc
        print(f"[supervise] trainer exited rc={rc}; restart {n}/"
              f"{max_restarts} (auto-resume, {backoff}s backoff)",
              file=sys.stderr, flush=True)
        log_event(rc, backoff, "restart")
        if out:
            fleet.advance_generation(fleet.generation_path(out), n)
        reexport_membership(out, env)
        sleep(float(backoff))


class Outcome(NamedTuple):
    """What the supervisor exits with: `code` is its trainer's last rc,
    passed through unchanged as the script's `exit $rc` does (catalogued
    where the trainer chose it, 128 + N for a signal death) — a declared
    code attribute, the form the rc-catalogue lint
    (`analysis/lint.py`) accepts for a code that is not a literal."""

    code: int


def main(argv: Optional[Sequence[str]] = None) -> int:
    return supervise(sys.argv[1:] if argv is None else list(argv))


if __name__ == "__main__":
    sys.exit(Outcome(main()).code)
