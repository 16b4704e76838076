"""`fuzz` entry point of the port — coverage-steered property-based search
over the scenario fault space (scenario/fuzz.py).

    python -m ddp_classification_pytorch_tpu_torch.cli.fuzz \
        --seed 0 --budget 20 --out runs/fuzz

A seeded sampler draws valid `ScenarioSpec`s from the grammar (fault
kinds enumerated from utils/chaos.py's FAULT_GRAMMAR), steered by the
persistent coverage ledger (``<out>/fuzz_ledger.json``) toward uncovered
(fault kind × subsystem) pairs. Each spec runs through the chosen runner:

- ``--runner sim`` (default) — a deterministic correct-behavior event
  simulation replayed through the S1–S5 checkers: milliseconds per spec,
  finds checker-vs-model disagreements (checker bugs);
- ``--runner drill`` — the real `ScenarioSupervisor` with subprocesses
  on ``--device`` (default ``cuda``): minutes per spec, finds process
  bugs. Use a small ``--budget``.

On any violation the failing spec is delta-minimized (drop fault → drop
timeline item → shrink timing → shrink topology, re-running after each
cut) and the smallest failing spec + its forensics land under
``<out>/minimized/``, ready to commit as a regression case.

rc discipline (registered in analysis/lint.py's 0–11 catalogue):

- **0** — budget exhausted, every sampled scenario green;
- **1** — a violation was found; the minimized spec was written;
- **2** — bad arguments (non-positive budget/candidates, unknown
  runner; deterministic, never retried);
- **3** — ``--runner drill`` with no CUDA device and ``--device cpu``
  not asked for (nothing is started).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ddp_classification_pytorch_tpu_torch.cli.fuzz",
        description="coverage-steered scenario fuzzing with a "
                    "delta-minimizing shrinker",
    )
    p.add_argument("--seed", type=int, default=0,
                   help="sampler seed; same seed → byte-identical spec "
                        "sequence (a failure reproduces from seed alone)")
    p.add_argument("--budget", type=int, default=20,
                   help="number of scenarios to sample and run (< 1 exits "
                        "rc 2)")
    p.add_argument("--out", default="runs/fuzz",
                   help="artifact dir: fuzz_ledger.json, minimized/ on a "
                        "red, drill run dirs under --runner drill")
    p.add_argument("--ledger", default="",
                   help="coverage ledger path (default <out>/fuzz_ledger"
                        ".json); persists across runs so the next budget "
                        "steers toward still-uncovered pairs")
    p.add_argument("--runner", choices=("sim", "drill"), default="sim",
                   help="sim: deterministic event simulation through the "
                        "checkers (ms/spec); drill: the real supervisor "
                        "(minutes/spec)")
    p.add_argument("--candidates", type=int, default=4,
                   help="specs drawn per sample; the one covering the most "
                        "uncovered ledger pairs runs (1 = no steering)")
    p.add_argument("--max_shrink_runs", type=int, default=200,
                   help="re-run cap for the delta-minimizer")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the drill runner's device for every child "
                        "(default cuda); the sim runner starts nothing")
    return p


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    if args.budget < 1:
        print(f"[fuzz] --budget must be >= 1, got {args.budget}",
              file=sys.stderr)
        raise SystemExit(2)
    if args.candidates < 1:
        print(f"[fuzz] --candidates must be >= 1, got {args.candidates}",
              file=sys.stderr)
        raise SystemExit(2)
    if args.max_shrink_runs < 0:
        print(f"[fuzz] --max_shrink_runs must be >= 0, got "
              f"{args.max_shrink_runs}", file=sys.stderr)
        raise SystemExit(2)

    from ..scenario import fuzz as fuzzlib

    ledger_path = args.ledger or os.path.join(args.out, "fuzz_ledger.json")
    ledger = fuzzlib.CoverageLedger.load(ledger_path)
    if args.runner == "drill":
        from ..utils.backend_probe import BackendUnavailable, resolve_device

        try:
            resolve_device(args.device)
        except BackendUnavailable as e:
            print(f"[fuzz] backend unreachable: --device {args.device}: {e}",
                  file=sys.stderr)
            raise SystemExit(3) from None
        runner = fuzzlib.DrillRunner(os.path.join(args.out, "drills"),
                                     device=args.device)
    else:
        runner = fuzzlib.sim_runner
    fuzzer = fuzzlib.Fuzzer(runner, seed=args.seed,
                            candidates=args.candidates, ledger=ledger,
                            max_shrink_runs=args.max_shrink_runs,
                            log=lambda s: print(f"[fuzz] {s}"))
    result = fuzzer.run(args.budget)
    ledger.save()
    uncovered = ledger.uncovered()
    print(f"[fuzz] coverage: {ledger.distinct()} distinct "
          f"(kind x subsystem) pair(s) over {ledger.specs_run} spec(s) "
          f"({len(uncovered)} still uncovered) → {ledger_path}")

    if not result.found:
        print(f"[fuzz] GREEN: {result.specs_run} scenario(s), every "
              "invariant held")
        return

    mini_dir = os.path.join(args.out, "minimized")
    os.makedirs(mini_dir, exist_ok=True)
    spec_path = os.path.join(mini_dir, "spec.json")
    with open(spec_path, "w") as f:
        f.write(result.minimized.to_json())
    with open(os.path.join(mini_dir, "seed_spec.json"), "w") as f:
        f.write(result.seed_spec.to_json())
    if args.runner == "sim":
        # the minimized forensics, replayable via cli.scenario --check_only
        events = fuzzlib.simulate_events(result.minimized)
        with open(os.path.join(mini_dir, "events.jsonl"), "w") as f:
            for rec in events:
                f.write(json.dumps(rec, sort_keys=True) + "\n")
    with open(os.path.join(mini_dir, "report.json"), "w") as f:
        json.dump({"seed": args.seed, "specs_run": result.specs_run,
                   "shrink_runs": result.shrink_runs,
                   "violations": [str(v) for v in result.violations]},
                  f, indent=2, sort_keys=True)
        f.write("\n")
    for v in result.violations:
        print(f"[fuzz] VIOLATION {v}", file=sys.stderr)
    print(f"[fuzz] RED: failure found at spec {result.specs_run}/"
          f"{args.budget}, minimized in {result.shrink_runs} run(s) → "
          f"{spec_path}", file=sys.stderr)
    raise SystemExit(1)


if __name__ == "__main__":
    main()
