"""Console output. The port runs one process on one card, so rank 0 is the
only rank and `host0_print` prints."""

from __future__ import annotations

from typing import Any


def host0_print(*a: Any, **kw: Any) -> None:
    print(*a, **kw)
