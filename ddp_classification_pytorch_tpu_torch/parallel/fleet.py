"""Pod-level fault tolerance over torch.distributed — the port's own copy
of the JAX package's `parallel/fleet.py`: the same exceptions and exit
codes, wire format, env knobs, generation, lease and membership files.

Every robustness mechanism below this module is per-process — the
sentinel and the rc taxonomy (train/sentinel.py, cli/train.py),
checksum-verified resume with quarantine (train/checkpoint.py), the
supervisor's restart classification (cli/supervise.py) and the
StepHeartbeat. Over several ranks those pieces fight each other (the
reference can only hang: a crashed `torch.distributed.launch` rank leaves
every peer waiting in an all-reduce that never returns, SURVEY §5):

- rank 0 quarantines a corrupt latest checkpoint and falls back while the
  other ranks pick a different candidate — a silent split-brain resume;
- a rank that stops deterministically (rc 2/8) leaves its peers hanging
  mid-collective until the heartbeat fires a misleading rc 7;
- `init_process_group` has no retry, so uncoordinated supervisor backoffs
  make restarted processes miss each other's rendezvous window.

The mechanisms that close those gaps are all off the hot path (resume
time and epoch boundaries only):

1. **Resume consensus** (`consensus_restore_latest`): rank 0 alone scans,
   verifies and quarantines, and broadcasts the chosen (checkpoint name,
   next_epoch, sha256); every rank restores exactly that file and proves
   it with an all-gathered digest of the restored bytes. Any mismatch is
   the deterministic `PodInconsistent` (rc 9).
2. **Rendezvous retry** (`initialize_with_retry`): bounded exponential
   backoff and a hard deadline around `init_process_group`, with terminal
   failure mapped to `RendezvousFailed` (rc 6). A shared
   ``$OUT/generation`` file (max-written by every supervisor) keeps
   restarted processes on the same attempt number.
3. **Abort propagation** (`FleetCoordinator`): one control collective at
   every epoch boundary carries each rank's abort intent (sentinel
   diverged, SIGTERM received), so a deterministic stop on one rank
   becomes the SAME rc on every rank within one epoch.
4. **Pod chaos** (utils/chaos.py `peer_dead` / `peer_slow` / `host_lost`,
   aimed at one process by ``CHAOS_HOST``) drives the chain end to end.
5. **Elastic re-formation** (``FLEET_ELASTIC=1`` on explicit pods): every
   process keeps a lease file under ``$OUT/fleet/`` (written at
   rendezvous, refreshed at the trainer's log cadence and every epoch
   boundary), and rendezvous derives the membership from the FRESH leases
   instead of the launch env: survivors of a lost process agree on a
   smaller world (sorted surviving host ids → contiguous ranks), prove
   the agreement with the same digest machinery (`PodInconsistent` rc 9),
   and resume through the consensus restore. A world below
   ``FLEET_MIN_PROCESSES`` or off ``--dp`` is `PodUnviable` rc 10; a
   running pod that observes a membership change exits `PodReform` rc 11
   at the epoch boundary so every supervisor restarts it into the
   re-formed world.

The host collectives (`_broadcast_host` / `_allgather_host`) run on the
control plane's gloo group (`parallel/ddp.py::control_group`) as CPU
tensors, one at a time, and are module-level indirection so unit tests
stub them with recorded payloads; `process_count() == 1` short-circuits
every protocol to its local equivalent. torch is imported only where a
collective or a group is made, so the supervisor does not load it.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any, Callable, Optional, Tuple

import numpy as np

# fixed wire sizes for the consensus broadcast (the JAX package's: its
# arrays need static shapes): checkpoint basename + sha256 hex digest.
# The whole choice packs into ONE uint8 buffer → ONE collective: the
# control plane never issues more than one collective at a time.
FLAGS_BYTES = 16  # (found, next_epoch) as little-endian int64 pair
NAME_BYTES = 256
DIGEST_BYTES = 64
WIRE_BYTES = FLAGS_BYTES + NAME_BYTES + DIGEST_BYTES


# ------------------------------------------------------------ exceptions --
class RendezvousFailed(RuntimeError):
    """`init_process_group` never succeeded within the retry
    budget/deadline. rc 6 — outage-shaped (peers may simply not be up
    yet), so the supervisor restarts it after `OUTAGE_BACKOFF_S`."""

    exit_code = 6


class PodInconsistent(RuntimeError):
    """The pod failed the resume digest agreement check: at least one
    host restored different bytes (or nothing) where host 0's broadcast
    named a verified checkpoint. rc 9 — loud and immediate, never a
    silent split-brain resume. Usually a shared-filesystem staleness
    race, so the supervisor retries it with `RUNTIME_BACKOFF_S`."""

    exit_code = 9


class FleetConfigError(ValueError):
    """Malformed ``FLEET_*`` launch env (non-integer
    ``FLEET_NUM_PROCESSES``, a coordinator address that is not
    host:port, a process id outside the world). rc 2 — deterministic:
    restarting replays the same bad env, so the supervisor must stop
    instead of burning its retry budget (previously these surfaced as
    raw tracebacks swallowed into rc 6 retries)."""

    exit_code = 2


class PodUnviable(RuntimeError):
    """The survivor set cannot form a trainable pod: fewer hosts than
    ``FLEET_MIN_PROCESSES``, or a world other than the ``--dp`` the run
    was configured for. rc 10 — deterministic on every
    host (the same lease scan derives the same world), never a hang;
    outage-shaped for the supervisor (dead peers may come back), so
    the supervisor backs off ``OUTAGE_BACKOFF_S`` and retries within its
    restart budget."""

    exit_code = 10


class PodReform(RuntimeError):
    """A running pod observed a membership change at the epoch
    boundary: a member's lease went stale (host lost) or a non-member
    wrote a fresh lease (recovered host rejoining). rc 11 — every host
    exits together so the supervisors restart them into a re-formed
    world at the next generation; the supervisor restarts it fast
    (``REFORM_BACKOFF_S``, default 2 s)."""

    exit_code = 11


class PodAbort(RuntimeError):
    """Coordinated pod stop: some host carried a non-zero abort intent
    into the epoch-boundary exchange. `code` is the process exit code
    EVERY host exits with (the numerically largest intent across the
    pod — deterministic on every host)."""

    def __init__(self, code: int, origin: int = -1, local_code: int = 0,
                 reason: str = ""):
        self.code = int(code)
        self.origin = int(origin)
        self.local_code = int(local_code)
        self.reason = reason
        src = "this host" if local_code == code else f"host {origin}"
        msg = f"pod abort rc {self.code} (from {src})"
        if reason:
            msg += f": {reason}"
        super().__init__(msg)


# ------------------------------------------------- collective primitives --
# Thin, stubbable wrappers: unit tests monkeypatch these to simulate any
# pod topology in one process; a run resolves them against the process
# group (parallel/ddp.py), the collectives on its gloo control group.

def _process_index() -> int:
    from . import ddp

    return ddp.rank()


def _process_count() -> int:
    from . import ddp

    return ddp.world_size()


def _broadcast_host(payload: np.ndarray) -> np.ndarray:
    """Rank 0 → every rank broadcast of a numpy array (the control
    plane's only asymmetric primitive)."""
    import torch
    import torch.distributed as dist

    from . import ddp

    t = torch.from_numpy(np.array(payload, copy=True))
    dist.broadcast(t, src=0, group=ddp.control_group())
    return t.numpy()


def _allgather_host(x: np.ndarray) -> np.ndarray:
    """All-gather a small numpy array; returns shape (process_count, ...)
    in rank order."""
    import torch
    import torch.distributed as dist

    from . import ddp

    t = torch.from_numpy(np.array(x, copy=True))
    out = [torch.empty_like(t) for _ in range(ddp.world_size())]
    dist.all_gather(out, t, group=ddp.control_group())
    return np.stack([o.numpy() for o in out])


def _encode_fixed(text: str, size: int) -> np.ndarray:
    raw = text.encode("utf-8")[:size]
    out = np.zeros(size, np.uint8)
    out[: len(raw)] = np.frombuffer(raw, np.uint8)
    return out


def _decode_fixed(arr: np.ndarray) -> str:
    raw = bytes(np.asarray(arr, np.uint8))
    return raw.rstrip(b"\x00").decode("utf-8", errors="replace")


def pack_choice(found: int, next_epoch: int, name: str,
                digest: str) -> np.ndarray:
    """(found, next_epoch, basename, sha256) → one WIRE_BYTES uint8 buffer."""
    buf = np.zeros(WIRE_BYTES, np.uint8)
    flags = np.asarray([found, next_epoch], "<i8")
    buf[:FLAGS_BYTES] = np.frombuffer(flags.tobytes(), np.uint8)
    buf[FLAGS_BYTES: FLAGS_BYTES + NAME_BYTES] = _encode_fixed(name, NAME_BYTES)
    buf[FLAGS_BYTES + NAME_BYTES:] = _encode_fixed(digest, DIGEST_BYTES)
    return buf


def unpack_choice(buf: np.ndarray):
    """Inverse of `pack_choice` → (found, next_epoch, name, digest)."""
    buf = np.asarray(buf, np.uint8)
    flags = np.frombuffer(bytes(buf[:FLAGS_BYTES]), "<i8")
    name = _decode_fixed(buf[FLAGS_BYTES: FLAGS_BYTES + NAME_BYTES])
    digest = _decode_fixed(buf[FLAGS_BYTES + NAME_BYTES:])
    return int(flags[0]), int(flags[1]), name, digest


# ------------------------------------------------------ resume consensus --
def consensus_restore_latest(ckpt: Any, template_state: Any) -> Tuple[Any, int]:
    """--auto_resume for pods: one decider, one verified answer, proven.

    Host 0 runs the existing scan/verify/quarantine
    (`CheckpointManager.restore_latest_with_provenance`) and broadcasts
    (found, next_epoch, checkpoint basename, sha256). Followers restore
    exactly that file — `restore_exact` checks the bytes hash to the
    broadcast digest and NEVER quarantines (exactly one host renames on
    a corrupt candidate). Every host then contributes its restored-bytes
    digest to an all-gather; any disagreement (a follower restored
    different bytes, or failed to restore at all) raises
    `PodInconsistent` (rc 9). Single-process runs take the plain
    `restore_latest` path unchanged.
    """
    if _process_count() == 1:
        return ckpt.restore_latest(template_state)

    # NOTE alignment contract: between here and the final all-gather, the
    # ONLY collectives any rank may issue are the broadcast and the
    # all-gather themselves. The leader's scan and every restore load the
    # file on the host into the replicated state (no collective), so the
    # leader restoring BEFORE its peers know the choice cannot desync the
    # pod's collective streams.
    if _process_index() == 0:
        state, next_epoch, path, digest = (
            ckpt.restore_latest_with_provenance(template_state))
        found = int(path is not None)
        payload = pack_choice(found, next_epoch,
                              os.path.basename(path) if found else "",
                              digest if found else "")
    else:
        state = template_state
        payload = np.zeros(WIRE_BYTES, np.uint8)

    found, next_epoch, name, expected = unpack_choice(_broadcast_host(payload))
    zero_digest = np.zeros(DIGEST_BYTES, np.uint8)
    local_digest = zero_digest
    if found:
        if _process_index() == 0:
            local_digest = _encode_fixed(expected, DIGEST_BYTES)
        else:
            restored = ckpt.restore_exact(
                template_state, os.path.join(ckpt.out_dir, name), expected)
            if restored is not None:
                state = restored
                local_digest = _encode_fixed(expected, DIGEST_BYTES)
                # resume best-tracking from the shared meta, like host 0
                ckpt.best_metric = ckpt.read_meta().get(
                    "best_metric", float("-inf"))
        print(f"[fleet] host {_process_index()}: consensus resume "
              f"{name} (next_epoch={next_epoch}, "
              f"sha256={expected[:12]}…, "
              f"restored={bool((local_digest != 0).any())})", flush=True)

    gathered = _allgather_host(np.asarray(local_digest, np.uint8))
    gathered = gathered.reshape(-1, DIGEST_BYTES)
    agree = (gathered == gathered[0]).all()
    if not agree:
        bad = sorted(
            int(p) for p in range(gathered.shape[0])
            if not bool((gathered[p] == gathered[0]).all()))
        raise PodInconsistent(
            f"resume digest agreement failed: host(s) {bad} restored "
            "different bytes than host 0's broadcast choice "
            f"({expected[:12]}… for {name or '<fresh start>'}) — refusing a "
            "split-brain resume (rc 9); a shared-filesystem staleness "
            "race usually clears on the supervised retry")
    return state, next_epoch


# ----------------------------------------------------- rendezvous retry --
def backoff_schedule(attempts: int, base_s: float, cap_s: float) -> list:
    """Deterministic exponential schedule (base, 2·base, 4·base, …,
    capped) — shared by every host, so same-generation restarts retry in
    sync instead of drifting."""
    return [min(base_s * (2.0 ** i), cap_s)
            for i in range(max(attempts - 1, 0))]


def _torch_initialize(coordinator: str, num_processes: int,
                      process_id: int, timeout_s: int, device: Any) -> None:
    """One rendezvous attempt: the world group at ``tcp://<coordinator>``
    (rank 0 hosts the store there), `timeout_s` bounding the attempt."""
    from . import ddp

    ddp.init_group(device, f"tcp://{coordinator}", int(num_processes),
                   int(process_id), timeout_s=timeout_s)


def _shutdown_distributed() -> None:
    """Teardown between rendezvous attempts — a group half made by a
    failed attempt must not poison the retry (a no-op without one)."""
    from . import ddp

    ddp.shutdown()


def initialize_with_retry(
    out_dir: str = "",
    *,
    initialize: Optional[Callable[..., None]] = None,
    sleep: Callable[[float], None] = time.sleep,
    env: Optional[dict] = None,
    device: Any = None,
    data_parallel: Optional[int] = None,
) -> int:
    """`init_process_group` with bounded exponential backoff and a hard
    deadline. Returns the generation this attempt belongs to (from the
    shared ``$OUT/generation`` file — the supervisor max-writes its
    attempt number there before every restart, so all processes log and
    pace the same generation).

    Knobs (env, parsed by `validate_fleet_env` — malformed values raise
    `FleetConfigError` rc 2 up front): ``FLEET_COORDINATOR`` (host:port of
    rank 0's store; required here, as the port has no metadata service to
    find a pod from) / ``FLEET_NUM_PROCESSES`` / ``FLEET_PROCESS_ID``,
    ``FLEET_RENDEZVOUS_ATTEMPTS`` (5), ``FLEET_RENDEZVOUS_BACKOFF_S`` (5,
    doubling), ``FLEET_RENDEZVOUS_BACKOFF_CAP_S`` (60),
    ``FLEET_RENDEZVOUS_TIMEOUT_S`` (60, per attempt; also the group's
    collective timeout), ``FLEET_RENDEZVOUS_DEADLINE_S`` (600, hard wall
    across attempts).

    With ``FLEET_ELASTIC=1`` (and an out_dir), every attempt derives the
    world from the FRESH leases instead of the frozen env: write own
    lease → scan → (settle-sleep once if smaller than configured) →
    viability gate (`PodUnviable` rc 10) → the LOWEST surviving host id
    caches the derived view in ``$OUT/fleet/membership`` (bumping the
    generation when the world changed) → initialize with contiguous
    ranks over the sorted survivor ids → digest agreement over the
    joined world (`PodInconsistent` rc 9 on split-brain). The injected
    ``initialize`` receives ``(coordinator, num_processes, process_id)``;
    by default it joins the group on `device` (`parallel/ddp.py`), and
    `data_parallel` (``--dp``) gates viability.

    Terminal failure raises `RendezvousFailed` (rc 6): outage-shaped —
    the peers may simply not have restarted yet — so the supervisor backs
    off `OUTAGE_BACKOFF_S` and tries again rather than giving up fast.
    `PodUnviable`/`PodInconsistent` re-raise immediately (deterministic
    on this lease view — retrying in-process cannot change the answer).
    """
    global _CURRENT_MEMBERSHIP
    e = os.environ if env is None else env
    knobs = validate_fleet_env(e)  # FleetConfigError (rc 2) before any retry
    attempts = knobs["attempts"]
    timeout_s = knobs["timeout_s"]
    deadline = knobs["deadline_s"]
    elastic = bool(out_dir) and elastic_enabled(e)
    gen = read_generation(generation_path(out_dir)) if out_dir else 0
    if initialize is None:
        if not knobs["coordinator"]:
            raise FleetConfigError(
                "--multihost needs FLEET_COORDINATOR (host:port of rank 0), "
                "FLEET_NUM_PROCESSES and FLEET_PROCESS_ID — rc 2: fix the "
                "launch env (torchrun's processes need no --multihost)")
        initialize = lambda c, n, p: _torch_initialize(  # noqa: E731
            c, n, p, timeout_s, device)

    delays = backoff_schedule(attempts, knobs["backoff_s"],
                              knobs["backoff_cap_s"])
    start = time.monotonic()
    last: Optional[BaseException] = None
    for attempt in range(attempts):
        try:
            if elastic:
                host_id = knobs["host_id"]
                gen = read_generation(generation_path(out_dir))
                write_lease(out_dir, host_id, generation=gen,
                            coordinator=knobs["self_coordinator"])
                leases = scan_leases(out_dir, ttl_s=knobs["lease_ttl_s"])
                leases[host_id] = knobs["self_coordinator"]
                if (knobs["num_processes"] is not None
                        and len(leases) < knobs["num_processes"]
                        and knobs["settle_s"] > 0):
                    # first-boot settle: peers may not have written their
                    # first lease yet — don't flap into a shrunken world
                    sleep(knobs["settle_s"])
                    leases = scan_leases(out_dir, ttl_s=knobs["lease_ttl_s"])
                    leases[host_id] = knobs["self_coordinator"]
                world = sorted(leases)
                check_viable(world, min_processes=knobs["min_processes"],
                             data_parallel=data_parallel)
                stored_gen, stored_world = read_membership(out_dir)
                reform = bool(stored_world) and stored_world != world
                if (reform and host_id not in stored_world
                        and world[0] != host_id):
                    # a REJOINER: the survivors are still running the old
                    # world — connecting now would abort against a
                    # coordinator sized without us (observed: an instant
                    # SIGABRT crash storm burning the supervisor's restart
                    # budget). Our fresh lease is the signal; wait in the
                    # retry loop until their epoch-boundary reform check
                    # fires and the membership writer records a world that
                    # contains us. (When WE are the lowest survivor, we
                    # are that writer — fall through and re-form.)
                    raise RuntimeError(
                        f"host {host_id} waiting for survivors "
                        f"{stored_world} to re-form around its fresh "
                        "lease (membership not yet updated)")
                gen = max(gen, stored_gen) + (1 if reform else 0)
                if world[0] == host_id:
                    # single writer: every survivor derives the same view
                    # deterministically; only the lowest id caches it, so
                    # a rejoiner cannot overwrite the survivors' record
                    # before they have re-formed around it
                    if reform:
                        advance_generation(generation_path(out_dir), gen)
                    write_membership(out_dir, gen, world)
                if reform:
                    print(f"[fleet] re-formed pod: world {world} "
                          f"(was {stored_world}) at generation {gen}",
                          flush=True)
                rank = world.index(host_id)
                coord = leases.get(world[0], "") or knobs["coordinator"]
                initialize(coord, len(world), rank)
                _CURRENT_MEMBERSHIP = (gen, tuple(world))
                confirm_membership(world)
                print(f"[fleet] rendezvous ok (generation={gen}, "
                      f"attempt={attempt + 1}/{attempts}, "
                      f"world={','.join(str(h) for h in world)}, "
                      f"rank={rank})", flush=True)
                return gen
            initialize(knobs["coordinator"], knobs["num_processes"] or 0,
                       knobs["process_id"] or 0)
            print(f"[fleet] rendezvous ok "
                  f"(generation={gen}, attempt={attempt + 1}/{attempts})",
                  flush=True)
            return gen
        except (PodUnviable, PodInconsistent):
            _shutdown_distributed()
            raise
        except Exception as exc:  # timeout / connection refused / barrier
            last = exc
            _shutdown_distributed()
            print(f"[fleet] rendezvous attempt {attempt + 1}/{attempts} "
                  f"failed (generation={gen}): {exc}",
                  file=sys.stderr, flush=True)
            if attempt < attempts - 1:
                delay = delays[attempt]
                if time.monotonic() - start + delay > deadline:
                    break
                sleep(delay)
    raise RendezvousFailed(
        f"rendezvous never completed (generation={gen}, "
        f"{attempts} attempts, deadline {deadline:.0f}s): {last} — "
        "rc 6: outage-shaped, the supervisor backs off and retries")


# ------------------------------------------------------ generation file --
def generation_path(out_dir: str) -> str:
    return os.path.join(out_dir, "generation")


def read_generation(path: str) -> int:
    """Current pod generation; 0 when the file is absent or garbled (a
    torn write must not brick the restart chain)."""
    try:
        with open(path) as f:
            return max(int(f.read().strip() or 0), 0)
    except (OSError, ValueError):
        return 0


def advance_generation(path: str, target: int) -> int:
    """Monotonic max-write: records `target` only when it exceeds the
    current value (atomic tmp+replace; concurrent writers observing the
    same generation write the same value and converge). Returns the
    resulting generation. the supervisor performs the same operation in
    shell before each restart."""
    target = int(target)
    cur = read_generation(path)
    if target <= cur:
        return cur
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(str(target) + "\n")
    os.replace(tmp, path)
    return target


# ------------------------------------------------------ elastic pods --
# The (generation, world) this process rendezvoused into — written by the
# elastic path of `initialize_with_retry`, read by FleetCoordinator's
# reform detection so a membership change is judged against the world the
# RUNNING program was built for, not against a file a rejoiner may have
# already rewritten.
_CURRENT_MEMBERSHIP: Optional[Tuple[int, Tuple[int, ...]]] = None


def _env_int(e: dict, key: str) -> Optional[int]:
    raw = str(e.get(key, "") or "").strip()
    if raw == "":
        return None
    try:
        return int(raw)
    except ValueError:
        raise FleetConfigError(
            f"{key}={raw!r} is not an integer — rc 2: fix the launch env "
            "(restarting replays the same bad value)") from None


def _env_float(e: dict, key: str, default: float) -> float:
    raw = str(e.get(key, "") or "").strip()
    if raw == "":
        return default
    try:
        return float(raw)
    except ValueError:
        raise FleetConfigError(
            f"{key}={raw!r} is not a number — rc 2: fix the launch env "
            "(restarting replays the same bad value)") from None


def validate_fleet_env(env: Optional[dict] = None) -> dict:
    """Parse and validate every FLEET_* knob up front, BEFORE any retry
    loop — a malformed value is a deterministic `FleetConfigError`
    (rc 2) with the offending key named, not a raw traceback swallowed
    into rc 6 rendezvous retries. Returns the parsed knobs with
    defaults applied — the JAX package's, less ``local_devices``: a
    process of the port drives one card."""
    e = os.environ if env is None else env
    nprocs = _env_int(e, "FLEET_NUM_PROCESSES")
    pid = _env_int(e, "FLEET_PROCESS_ID")
    coordinator = str(e.get("FLEET_COORDINATOR", "") or "").strip()
    if coordinator:
        host, sep, port = coordinator.rpartition(":")
        if not sep or not host or not port.isdigit():
            raise FleetConfigError(
                f"FLEET_COORDINATOR={coordinator!r} is not host:port — "
                "rc 2: fix the launch env")
        if nprocs is None or pid is None:
            raise FleetConfigError(
                "FLEET_COORDINATOR is set but FLEET_NUM_PROCESSES / "
                "FLEET_PROCESS_ID is missing — rc 2: explicit pods need "
                "all three")
    if nprocs is not None and nprocs < 1:
        raise FleetConfigError(
            f"FLEET_NUM_PROCESSES={nprocs} must be >= 1 — rc 2")
    if pid is not None and nprocs is not None and not 0 <= pid < nprocs:
        raise FleetConfigError(
            f"FLEET_PROCESS_ID={pid} outside the world "
            f"[0, {nprocs}) — rc 2")
    host_id = _env_int(e, "FLEET_HOST_ID")
    if host_id is None:
        host_id = pid if pid is not None else 0
    if host_id < 0:
        raise FleetConfigError(f"FLEET_HOST_ID={host_id} must be >= 0 — rc 2")
    min_procs = _env_int(e, "FLEET_MIN_PROCESSES")
    self_coord = str(e.get("FLEET_COORDINATOR_SELF", "") or "").strip()
    return {
        "coordinator": coordinator,
        "num_processes": nprocs,
        "process_id": pid,
        "host_id": host_id,
        "min_processes": max(min_procs, 1) if min_procs is not None else 1,
        # the address this host would serve as coordinator if it became
        # rank 0 of a re-formed world; host id 0 defaults to the
        # configured coordinator (same process, same bindable port)
        "self_coordinator": self_coord or (coordinator if host_id == 0 else ""),
        "attempts": max(_env_int(e, "FLEET_RENDEZVOUS_ATTEMPTS") or 5, 1),
        "backoff_s": _env_float(e, "FLEET_RENDEZVOUS_BACKOFF_S", 5.0),
        "backoff_cap_s": _env_float(e, "FLEET_RENDEZVOUS_BACKOFF_CAP_S", 60.0),
        "timeout_s": int(_env_float(e, "FLEET_RENDEZVOUS_TIMEOUT_S", 60.0)),
        "deadline_s": _env_float(e, "FLEET_RENDEZVOUS_DEADLINE_S", 600.0),
        "lease_ttl_s": _env_float(e, "FLEET_LEASE_TTL_S", 600.0),
        "settle_s": _env_float(e, "FLEET_LEASE_SETTLE_S", 2.0),
    }


def elastic_enabled(env: Optional[dict] = None) -> bool:
    """Elastic re-formation is opt-in (``FLEET_ELASTIC=1``) and only for
    EXPLICIT pods (coordinator + world from env), as in the JAX package;
    a torchrun launch keeps torchrun's fixed world."""
    e = os.environ if env is None else env
    return (str(e.get("FLEET_ELASTIC", "") or "") not in ("", "0")
            and bool(str(e.get("FLEET_COORDINATOR", "") or "").strip())
            and bool(str(e.get("FLEET_NUM_PROCESSES", "") or "").strip()))


def fleet_dir(out_dir: str) -> str:
    return os.path.join(out_dir, "fleet")


def lease_path(out_dir: str, host_id: int) -> str:
    return os.path.join(fleet_dir(out_dir), f"lease.p{int(host_id)}")


def write_lease(out_dir: str, host_id: int, *, generation: int = 0,
                coordinator: str = "") -> str:
    """Atomically (re)write this host's lease. Freshness is the file
    mtime — every write IS the heartbeat; the payload carries the host
    id, the generation it was serving, and the coordinator address this
    host would serve if it became rank 0 of a re-formed world."""
    d = fleet_dir(out_dir)
    os.makedirs(d, exist_ok=True)
    path = lease_path(out_dir, host_id)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(f"host={int(host_id)} gen={int(generation)} "
                f"coord={coordinator}\n")
    os.replace(tmp, path)
    return path


def scan_leases(out_dir: str, *, ttl_s: float,
                now: Optional[float] = None) -> dict:
    """Fresh leases under ``$OUT/fleet/``: {host_id: coordinator
    candidate}. A lease older than ``ttl_s`` (mtime) is a dead host; a
    torn or vanishing lease file is skipped — scan failures must never
    brick the restart chain."""
    d = fleet_dir(out_dir)
    now = time.time() if now is None else now
    fresh: dict = {}
    try:
        names = os.listdir(d)
    except OSError:
        return fresh
    for name in names:
        suffix = name[len("lease.p"):]
        if not name.startswith("lease.p") or not suffix.isdigit():
            continue
        path = os.path.join(d, name)
        try:
            if now - os.stat(path).st_mtime > ttl_s:
                continue
            coord = ""
            with open(path) as f:
                for tok in f.read().split():
                    if tok.startswith("coord="):
                        coord = tok[len("coord="):]
            fresh[int(suffix)] = coord
        except OSError:
            continue
    return fresh


# ------------------------------------------------------- membership --
def membership_path(out_dir: str) -> str:
    return os.path.join(fleet_dir(out_dir), "membership")


def membership_line(generation: int, world) -> str:
    """One shell- and python-parseable line: ``gen=G world=0,1``."""
    return (f"gen={int(generation)} "
            f"world={','.join(str(int(h)) for h in world)}")


def membership_digest(world) -> str:
    """sha256 of the canonical world — what `confirm_membership`
    all-gathers after rendezvous. Deliberately EXCLUDES the generation:
    supervisors max-write the generation file concurrently, so two
    hosts of one valid world may read adjacent values mid-wave; the
    split-brain being guarded against is a disagreeing WORLD."""
    import hashlib

    canon = ",".join(str(int(h)) for h in sorted(world))
    return hashlib.sha256(canon.encode("utf-8")).hexdigest()


def write_membership(out_dir: str, generation: int, world) -> None:
    """Atomic tmp+replace of ``$OUT/fleet/membership`` — the cache of
    the latest derived view (the leases stay the authority) that
    the supervisor re-reads before each respawn."""
    d = fleet_dir(out_dir)
    os.makedirs(d, exist_ok=True)
    path = membership_path(out_dir)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(membership_line(generation, world) + "\n")
    os.replace(tmp, path)
    # scenario evidence (env-gated no-op outside a drill): the membership
    # generation bump IS the re-formation event S3 tracks across rc 11
    from ..obs.events import emit

    emit("reform", gen=int(generation), world=[int(h) for h in world])


def read_membership(out_dir: str) -> Tuple[int, list]:
    """(generation, world) from the membership file; (0, []) when
    absent or garbled (a torn write must not brick the chain)."""
    try:
        with open(membership_path(out_dir)) as f:
            text = f.read()
    except OSError:
        return 0, []
    gen, world = 0, []
    try:
        for tok in text.split():
            if tok.startswith("gen="):
                gen = int(tok[len("gen="):])
            elif tok.startswith("world="):
                world = [int(x) for x in tok[len("world="):].split(",") if x]
    except ValueError:
        return 0, []
    return gen, world


def check_viable(world, *, min_processes: int = 1,
                 data_parallel: Optional[int] = None) -> None:
    """Deterministic viability gate for a derived survivor world —
    raises `PodUnviable` (rc 10) instead of letting an impossible pod
    rendezvous and hang (or crash into rc 6 retries forever). The port
    is data-parallel only, one card a process: a `data_parallel`
    (``--dp``) other than 0 must equal the world's size (the JAX
    package's mesh test with no model or pipeline axis); None skips it."""
    world = sorted(world)
    if len(world) < max(min_processes, 1):
        raise PodUnviable(
            f"survivor set {world} has {len(world)} host(s), below "
            f"FLEET_MIN_PROCESSES={min_processes} — rc 10: waiting for "
            "lost hosts to rejoin (the supervisor backs off and retries "
            "within its restart budget)")
    if data_parallel and data_parallel != len(world):
        raise PodUnviable(
            f"survivor world {world} has {len(world)} rank(s), which is "
            f"not the configured --dp {data_parallel} — rc 10: pass --dp 0 "
            "or wait for lost hosts")


def confirm_membership(world) -> None:
    """Post-rendezvous split-brain check: every host contributes the
    sha256 of the world it believes it just joined to one all-gather
    (the same digest-agreement machinery as resume consensus). Any
    disagreement is `PodInconsistent` (rc 9) on every host — a pod
    whose members derived different worlds from a racing lease scan
    must die loudly, not train split-brained."""
    if _process_count() == 1:
        return
    local = _encode_fixed(membership_digest(world), DIGEST_BYTES)
    gathered = _allgather_host(np.asarray(local, np.uint8))
    gathered = gathered.reshape(-1, DIGEST_BYTES)
    if not (gathered == gathered[0]).all():
        bad = sorted(
            int(p) for p in range(gathered.shape[0])
            if not bool((gathered[p] == gathered[0]).all()))
        raise PodInconsistent(
            f"membership agreement failed: host(s) {bad} rendezvoused "
            f"with a different world than {sorted(world)} — refusing a "
            "split-brain pod (rc 9); the supervised retry re-derives "
            "membership from the leases")


# ---------------------------------------------------- abort propagation --
class FleetCoordinator:
    """Epoch-boundary abort propagation + elastic reform detection.

    Each host accumulates at most one abort intent (`note_abort`): the
    sentinel's rc 8, a deferred SIGTERM (143), a config-shaped stop.
    At every epoch boundary — BEFORE eval/checkpoint, an aligned point
    every host reaches after the same number of step collectives —
    `check()` all-gathers the intents; any non-zero intent raises
    `PodAbort` on EVERY host with the same deterministic code (the
    numerically largest intent), so one host's stop becomes the pod's
    stop within one epoch instead of an indefinite hang at the next
    collective (and never a misleading heartbeat rc 7).

    On elastic pods the same exchange carries a second lane: each host
    refreshes its lease, re-scans, and flags when the derived world no
    longer matches the one this program rendezvoused into (a member's
    lease expired, or a recovered host wrote a fresh one). Any flag
    raises `PodReform` (rc 11) on every host so the supervisors respawn
    them into the re-formed world — still exactly ONE tiny int32
    all-gather per epoch (an (n, 2) [abort_code, reform_flag] wire; the
    control plane issues one collective at a time, so the two lanes
    share one).

    Strictly off the hot path. Single-process pods short-circuit (no
    collective) but still detect reform locally, making the class
    inert-but-testable everywhere.
    """

    def __init__(self, process_index: Optional[int] = None,
                 process_count: Optional[int] = None, *,
                 out_dir: str = "", host_id: Optional[int] = None,
                 registry: Any = None):
        self.process_index = (_process_index() if process_index is None
                              else int(process_index))
        self.process_count = (_process_count() if process_count is None
                              else int(process_count))
        self.abort_code = 0
        self.abort_reason = ""
        self.out_dir = out_dir
        self.elastic = bool(out_dir) and elastic_enabled()
        if self.elastic:
            knobs = validate_fleet_env()
            self.host_id = (knobs["host_id"] if host_id is None
                            else int(host_id))
            self._coord_candidate = knobs["self_coordinator"]
            self._lease_ttl_s = knobs["lease_ttl_s"]
        else:
            self.host_id = (self.process_index if host_id is None
                            else int(host_id))
            self._coord_candidate = ""
            self._lease_ttl_s = 600.0
        # the (generation, world) the running program was built for
        self.membership = _CURRENT_MEMBERSHIP
        # instruments (trainer passes its registry so these land in
        # $OUT/metrics.prom; standalone use self-observes). All updates
        # happen at lease/epoch cadence — never inside the step.
        if registry is None:
            from ..obs.registry import Registry

            registry = Registry()
        self._gen_gauge = registry.gauge(
            "fleet_generation", "membership generation this program joined")
        self._lease_age_gauge = registry.gauge(
            "fleet_lease_age_seconds",
            "seconds since this host last refreshed its lease")
        self._reforms_counter = registry.counter(
            "fleet_reforms_total",
            "membership changes answered with PodReform (rc 11)")
        self._aborts_counter = registry.counter(
            "fleet_aborts_total",
            "abort intents recorded on this host (propagated as PodAbort)")
        self._gen_gauge.set(self.membership[0] if self.membership else 0)
        self._last_lease_t: Optional[float] = None

    def note_abort(self, code: int, reason: str = "") -> None:
        """Record this host's abort intent (first one wins — the cause,
        not the last symptom)."""
        if code and not self.abort_code:
            self.abort_code = int(code)
            self.abort_reason = reason
            self._aborts_counter.inc()
            print(f"[fleet] host {self.process_index}: abort intent "
                  f"rc {self.abort_code}"
                  + (f" ({reason})" if reason else "")
                  + " — propagating at the epoch boundary", flush=True)

    def refresh_lease(self) -> None:
        """Heartbeat for elastic membership: rewrite this host's lease
        (the mtime IS the freshness signal). Called at the trainer's
        log cadence and every epoch boundary — never inside the step;
        inert on non-elastic pods."""
        if not self.elastic:
            return
        gen = self.membership[0] if self.membership else 0
        now = time.monotonic()
        # staleness since the PREVIOUS refresh — a growing value between
        # scrapes means the loop stopped reaching its lease cadence
        self._lease_age_gauge.set(
            now - self._last_lease_t if self._last_lease_t is not None
            else 0.0)
        self._last_lease_t = now
        # an OSError here fails the run (rc 1, restarted): a lease that
        # silently stops refreshing would read as a lost host
        write_lease(self.out_dir, self.host_id, generation=gen,
                    coordinator=self._coord_candidate)

    def _reform_flag(self) -> int:
        """1 when the lease-derived world no longer matches the world
        this program rendezvoused into, else 0."""
        if not self.elastic or self.membership is None:
            return 0
        self.refresh_lease()
        leases = scan_leases(self.out_dir, ttl_s=self._lease_ttl_s)
        leases[self.host_id] = self._coord_candidate
        return int(tuple(sorted(leases)) != self.membership[1])

    def _exchange(self, reform_flag: int) -> Tuple[int, int, int]:
        """One (n, 2) int32 all-gather of [abort_code, reform_flag] →
        (pod_code, origin, pod_reform). Abort: largest intent across
        the pod + the lowest host index carrying it ((0, -1) when
        nobody aborts). Reform: any host's flag."""
        local = np.asarray([[self.abort_code, int(reform_flag)]], np.int32)
        if self.process_count == 1:
            rows = local
        else:
            rows = _allgather_host(local).reshape(-1, 2)[: self.process_count]
        codes = rows[:, 0]
        code = int(codes.max()) if codes.size else 0
        origin = int(np.argmax(codes == code)) if code else -1
        reform = int(rows[:, 1].max()) if rows.size else 0
        return code, origin, reform

    def exchange_abort(self) -> Tuple[int, int]:
        """(pod_code, origin): the largest intent across the pod and the
        lowest host index carrying it; (0, -1) when nobody aborts."""
        code, origin, _ = self._exchange(0)
        return code, origin

    def check(self) -> None:
        """Run the epoch-boundary exchange; raise `PodAbort` when any
        host (including this one) carries an intent, else `PodReform`
        when any host observed a membership change (abort wins — a
        deterministic stop outranks a reconfiguration)."""
        code, origin, reform = self._exchange(self._reform_flag())
        if code:
            raise PodAbort(code, origin=origin, local_code=self.abort_code,
                           reason=self.abort_reason)
        if reform:
            self._reforms_counter.inc()
            world = list(self.membership[1]) if self.membership else []
            raise PodReform(
                f"pod membership changed (running world {world}) — "
                "rc 11: exiting at the epoch boundary so every "
                "supervisor respawns into the re-formed world at the "
                "next generation")
