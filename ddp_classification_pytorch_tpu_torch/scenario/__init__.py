"""Continuous train→serve chaos scenario — the port's own copy of the JAX
package's `scenario/`, driving the port's processes on the card.

One supervisor composes every robustness layer of the port: an elastic
trainer pod (`cli/supervise.py` over `cli/train.py`, `FLEET_ELASTIC`)
publishes verified checkpoints into a shared run dir while serve replicas
(`cli/serve.py --watch --fleet_dir`) answer offered HTTP load, a
declarative chaos timeline injects train- AND serve-side faults, and every
observable transition — publish, verify, quarantine, swap, 503, re-form
generation bump — lands in one machine-readable `events.jsonl`. The
invariant checker replays that timeline and asserts the five contracts
(S1 verified-serve, S2 availability floor, S3 bounded adoption, S4 the
end-of-run rc-catalogue gate, S5 fleet: wave exclusivity / survivor
convergence / spike elasticity).

Submodules (standard library only — the supervisor starts the trainer and
server processes instead of importing their torch stacks):

- `events`     — re-export of `obs/events.py` (the event log, the
                 env-gated `emit()` hook and the schema);
- `spec`       — the `--scenario_spec` JSON grammar + validation (rc 2),
                 with a lossless `ScenarioSpec.to_json` round trip;
- `invariants` — S1–S5 checkers over a parsed event timeline;
- `supervisor` — the process orchestrator behind `cli/scenario.py`;
- `report`     — the run's numbers read back from its events (adoption
                 seconds, the lowest availability window, request
                 latency, restarts, spike → scale-out);
- `fuzz`       — coverage-steered search over the fault space with a
                 delta-minimizing shrinker (`cli/fuzz.py`).
"""
