"""`scenario` entry point of the port — the supervised train→serve chaos
drill (scenario/) with the port's trainer and servers on the card.

    python -m ddp_classification_pytorch_tpu_torch.cli.scenario \
        --scenario_spec scenario.json --out runs/scenario [--device cpu]

Launches an elastic trainer pod publishing checkpoints into a shared run
dir while serve replicas (fleet members sharing leases and the rolling
drain token) sustain offered load, drives the chaos timeline from the spec
(including `spike_load` offered-load steps and autoscaling when the spec
arms `serve.max_replicas`), then replays the recorded `events.jsonl`
through the S1–S5 invariant checkers. `--check_only` skips the run and
re-checks an existing events file (post-mortem of a red run, and how the
synthetic-timeline tests prove each checker fires).

Every child (trainer host, serve replica) runs on `--device` (default
`cuda`); the CPU only when asked (`--device cpu`, as the tests do).

rc discipline (registered in analysis/lint.py's 0–11 catalogue):

- **0** — run converged AND every invariant held;
- **1** — an invariant was violated, or a supervised process failed
  (trainer rc != 0 through its restart budget, replica drain broke,
  a child on another device than asked, rc-catalogue gate red);
- **2** — malformed `--scenario_spec`, or (under `--check_only`) an
  events file with unknown event kinds / missing required fields
  (deterministic; never retried). A fuzzer replaying corrupt forensics
  must fail loudly, not pass vacuously;
- **3** — no CUDA device and `--device cpu` not asked for (nothing is
  started).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ddp_classification_pytorch_tpu_torch.cli.scenario",
        description="supervised train→serve chaos scenario with "
                    "machine-checked safety/availability invariants",
    )
    p.add_argument("--scenario_spec", required=True,
                   help="path to a scenario JSON file, or an inline JSON "
                        "object (scenario/spec.py has the grammar); "
                        "malformed specs exit rc 2")
    p.add_argument("--out", default="runs/scenario",
                   help="run dir shared by the trainer pod and the serve "
                        "replicas (checkpoints, logs, events.jsonl)")
    p.add_argument("--events", default="",
                   help="events.jsonl path (default <out>/events.jsonl); "
                        "with --check_only, the timeline to re-check")
    p.add_argument("--check_only", action="store_true",
                   help="skip the run: replay an existing events file "
                        "through the invariant checkers only; the file "
                        "is schema-validated (unknown kinds / missing "
                        "fields exit rc 2)")
    p.add_argument("--skip_lint", action="store_true",
                   help="skip the end-of-run rc-catalogue gate "
                        "(analysis/lint.py) and the S4 check — for quick "
                        "iteration, not CI")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the device every child runs on (default cuda; "
                        "rc 3 when cuda is missing and cpu was not asked "
                        "for)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    from ..scenario.spec import SpecError, load_spec

    try:
        spec = load_spec(args.scenario_spec)
    except SpecError as e:
        print(f"[scenario] spec error: {e}", file=sys.stderr)
        raise SystemExit(2) from None

    events_path = args.events or os.path.join(args.out, "events.jsonl")
    run_rc = 0
    if not args.check_only:
        from ..scenario.supervisor import ScenarioSupervisor
        from ..utils.backend_probe import BackendUnavailable, resolve_device

        try:
            resolve_device(args.device)
        except BackendUnavailable as e:
            print(f"[scenario] backend unreachable: --device {args.device}: "
                  f"{e}", file=sys.stderr)
            raise SystemExit(3) from None
        sup = ScenarioSupervisor(spec, args.out, events_path,
                                 skip_lint=args.skip_lint, device=args.device)
        print(f"[scenario] drill: {spec.trainer.hosts} trainer host(s), "
              f"{spec.serve.replicas} serve replica(s), "
              f"{spec.load.rps} rps offered, on {args.device} → {args.out}",
              flush=True)
        run_rc = sup.run()
        for f in sup.failures:
            print(f"[scenario] FAIL: {f}", file=sys.stderr)

    from ..obs.events import read_events, validate_events
    from ..scenario.invariants import check_invariants

    events = read_events(events_path)
    if not events:
        print(f"[scenario] no events at {events_path} — nothing to check",
              file=sys.stderr)
        raise SystemExit(1)
    if args.check_only:
        # a replayed timeline is committed forensics: unknown kinds or
        # missing fields mean the checkers would run on half-evidence
        # and pass vacuously — deterministic rc 2, same as a bad spec
        schema_errors = validate_events(events)
        if schema_errors:
            for err in schema_errors[:10]:
                print(f"[scenario] events error: {err}", file=sys.stderr)
            print(f"[scenario] events error: {len(schema_errors)} schema "
                  f"error(s) in {events_path}", file=sys.stderr)
            raise SystemExit(2)
    restarts = os.path.join(args.out, "restarts.log")
    violations = check_invariants(
        events, spec,
        restarts_logs=[restarts] if os.path.exists(restarts) else None,
        require_lint=not args.skip_lint)
    by_kind: dict = {}
    for e in events:
        by_kind[e["kind"]] = by_kind.get(e["kind"], 0) + 1
    print(f"[scenario] {len(events)} events: "
          + ", ".join(f"{k}={v}" for k, v in sorted(by_kind.items())))
    for v in violations:
        print(f"[scenario] VIOLATION {v}", file=sys.stderr)
    if violations or run_rc != 0:
        print(f"[scenario] RED: {len(violations)} violation(s), "
              f"run rc={run_rc}", file=sys.stderr)
        raise SystemExit(1)
    print("[scenario] GREEN: S1 verified-serve, S2 availability floor, "
          "S3 bounded adoption"
          + ("" if args.skip_lint else ", S4 rc-catalogue gate")
          + ", S5 fleet all held")


if __name__ == "__main__":
    main()
