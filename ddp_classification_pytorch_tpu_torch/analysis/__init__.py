"""Program-invariant analysis of the port — so far the one pass the
scenario's end-of-run gate (S4) needs: the rc catalogue of `cli/`
(`analysis/lint.py`). The JAX package's other passes (host-sync and
jit-registration lint, the jaxpr, sharding and dtype audits) audit JAX
programs and are not ported (ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict


@dataclass
class Finding:
    """One invariant violation, as the JAX package's `analysis.Finding`:
    `check` names the detector, `where` locates it (file:line), `evidence`
    carries a machine-readable payload."""

    check: str
    where: str
    message: str
    evidence: Dict[str, Any] = field(default_factory=dict)

    def __str__(self) -> str:  # the CLI's one-line rendering
        return f"[{self.check}] {self.where}: {self.message}"
