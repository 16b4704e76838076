"""The port's verified weights file: a `torch.save`d `state_dict` with a
sha256 sidecar — the counterpart of the JAX package's
`train/checkpoint.py` write/verify discipline (`checkpoint.py:255-316`).

- `save` writes the bytes to a temp file and `os.replace`s it into place
  (no torn file on preemption), then writes `<path>.sha256` the same way,
  strictly after the file: a crash in between leaves a file without a
  sidecar, never a sidecar vouching for unwritten bytes.
- `restore` verifies the sidecar before it loads. A missing sidecar or a
  digest mismatch is a `ValueError` (rc 2 in the serve CLI: deterministic,
  a supervisor must not retry it).

Reading the JAX package's flax msgpack checkpoints is not ported yet: the
GPU machine has no `msgpack` (ROADMAP.md). `models/convert.py` carries
weights across from flax trees already in memory.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, Mapping

import torch


def checksum_path(path: str) -> str:
    return path + ".sha256"


def _sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(chunk), b""):
            h.update(block)
    return h.hexdigest()


def save(state_dict: Mapping[str, torch.Tensor], path: str) -> str:
    """Atomically write `state_dict` (moved to the CPU) and its sidecar;
    returns the file's sha256."""
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, tmp)
    os.replace(tmp, path)
    digest = _sha256_file(path)
    sc_tmp = f"{checksum_path(path)}.{os.getpid()}.tmp"
    with open(sc_tmp, "w") as f:
        f.write(digest + "\n")
    os.replace(sc_tmp, checksum_path(path))
    return digest


def restore(path: str) -> Dict[str, torch.Tensor]:
    """Verify `path` against its sidecar, then load its `state_dict` on the
    CPU (tensors only: `weights_only=True`)."""
    sidecar = checksum_path(path)
    if not os.path.isfile(path):
        raise ValueError(f"checkpoint {path} does not exist")
    if not os.path.isfile(sidecar):
        raise ValueError(f"checkpoint {path} has no sha256 sidecar "
                         f"({sidecar}); refusing unverified weights")
    with open(sidecar) as f:
        expected = f.read().strip()
    actual = _sha256_file(path)
    if actual != expected:
        raise ValueError(f"checkpoint {path} fails its sha256: file "
                         f"{actual}, sidecar {expected}")
    return torch.load(path, map_location="cpu", weights_only=True)
