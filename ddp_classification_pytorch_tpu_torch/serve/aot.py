"""The AOT sidecar: a joining serve replica loads the kernel libraries a
first replica built, instead of building them — the port's counterpart of
the JAX package's `serve/aot.py`.

The JAX package banks each bucket's compiled XLA executable. A CUDA graph
cannot leave its process, so every replica captures its own graphs (one
per bucket and serve device, milliseconds each); what a joining replica
would otherwise pay for is the kernel libraries, which `ops/_build.py`
builds with `nvcc` at first use. The warm engine banks them next to the
checkpoint, and `ServingEngine.warmup()` of the next replica loads them and
asserts that it built nothing (`engine.aot_hit`).

Sidecar layout (every write atomic: tmp + `os.replace`; the manifest
LAST, so a torn publish leaves payloads without a manifest, a plain miss):

    <aot_dir>/manifest.json         fingerprint + program + per-library digests
    <aot_dir>/lib<name>-<hash>.so   the libraries, under ops/_build.py's names

The manifest is keyed by

- an environment fingerprint: the format version, torch's version and
  its CUDA version, the card's name and compute capability, the visible
  card count, the serve devices and the bucket set;
- a program: each banked library's file name, which `_build.library_path`
  derives from the nvcc flags, the sources and their headers (the
  counterpart of the JAX package's StableHLO digest), and a digest of the
  served model's structure (`state_dict` keys, shapes and dtypes), so a
  sidecar of another model is not taken for this one's.

The staleness/corruption ladder on load, rung for rung as the JAX
package's `load_bucket_executables` (each rung falls back to building; a
stale or torn sidecar never takes a replica down):

- manifest missing → miss; unparseable → quarantined (`*.corrupt`), miss;
- fingerprint mismatch (the bucket set included) → miss;
- program drift (a library's sources, headers or flags changed, or the
  model's structure) → miss;
- a payload whose bytes do not hash to the manifest's sha256 (torn write,
  bit rot) → that payload quarantined like a torn checkpoint
  (`train/checkpoint.py::quarantine_file`), the whole load a miss.

A verified payload is placed into the build directory under its
`library_path` name (tmp + `os.replace`), where `_build.build` finds it
and runs no `nvcc`.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, Optional, Sequence

from ..ops import _build
from ..train.checkpoint import quarantine_file
from ..utils.logging import host0_print

MANIFEST = "manifest.json"
FORMAT_VERSION = 1


def kernel_libraries() -> Dict[str, Sequence[str]]:
    """Each kernel library of the port: its name → its sources."""
    from ..ops import flash_attention, fused_abn

    return {"fused_abn": fused_abn.SOURCES,
            "flash_attention": flash_attention.SOURCES}


def library_files() -> Dict[str, str]:
    """Each library's file name for the sources as they are now."""
    return {name: os.path.basename(_build.library_path(name, sources))
            for name, sources in kernel_libraries().items()}


def _sha256_bytes(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def model_digest(model: Any) -> str:
    """sha256 of a served model's structure: its `state_dict` keys, shapes
    and dtypes (not its values: a hot reload keeps the sidecar valid)."""
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(f"{k}:{tuple(v.shape)}:{v.dtype};".encode())
    return h.hexdigest()


def env_fingerprint(devices: Sequence[Any], buckets: Sequence[int]
                    ) -> Dict[str, Any]:
    """Everything besides the program that a library built here may not
    survive: another torch or CUDA build, another card, another layout of
    serve devices or buckets."""
    import torch

    dev = torch.device(devices[0])
    cuda = dev.type == "cuda"
    return {
        "format_version": FORMAT_VERSION,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device_name": torch.cuda.get_device_name(dev) if cuda else dev.type,
        "compute_capability": (".".join(map(str, torch.cuda.get_device_capability(
            dev))) if cuda else None),
        "device_count": torch.cuda.device_count() if cuda else 1,
        "serve_devices": len(devices),
        "buckets": sorted(int(b) for b in buckets),
    }


def _atomic_write(path: str, data: bytes) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def save_kernel_libraries(aot_dir: str, devices: Sequence[Any],
                          buckets: Sequence[int], model: Any) -> bool:
    """Bank the kernel libraries built in this checkout's build directory.
    Returns True on a complete publish. Failures are reported, never
    raised: banking is an optimization, and the replica that just warmed
    up serves fine without it. Payloads land first, the manifest strictly
    last."""
    try:
        os.makedirs(aot_dir, exist_ok=True)
        manifest = env_fingerprint(devices, buckets)
        entries: Dict[str, Any] = {}
        for name, fname in library_files().items():
            path = os.path.join(_build.BUILD_DIR, fname)
            if not os.path.isfile(path):
                continue  # not on this path: never built here
            with open(path, "rb") as f:
                blob = f.read()
            _atomic_write(os.path.join(aot_dir, fname), blob)
            entries[name] = {"library": fname,
                             "payload_sha256": _sha256_bytes(blob),
                             "bytes": len(blob)}
        manifest["program"] = {"model": model_digest(model),
                               "libraries": {n: e["library"]
                                             for n, e in entries.items()}}
        manifest["entries"] = entries
        _atomic_write(os.path.join(aot_dir, MANIFEST),
                      json.dumps(manifest, indent=1, sort_keys=True).encode())
        return True
    except Exception as e:  # noqa: BLE001 — banking must never kill serving
        host0_print(f"[serve] AOT sidecar publish failed ({e!r}) — replicas "
                    "will build the kernel libraries until the next "
                    "successful warmup")
        return False


def load_kernel_libraries(aot_dir: str, devices: Sequence[Any],
                          buckets: Sequence[int], model: Any
                          ) -> Optional[Dict[str, str]]:
    """Place the banked libraries into the build directory and return
    {name: path}, or None = miss (the caller builds as usual)."""
    manifest_path = os.path.join(aot_dir, MANIFEST)
    try:
        with open(manifest_path, "rb") as f:
            raw = f.read()
    except OSError:
        return None
    try:
        manifest = json.loads(raw)
        if not isinstance(manifest, dict):
            raise ValueError("not a JSON object")
    except ValueError:
        quarantine_file(manifest_path, "aot manifest unparseable",
                        kind="aot manifest")
        return None

    want = env_fingerprint(devices, buckets)
    got = {k: manifest.get(k) for k in want}
    if got != want:
        drift = sorted(k for k in want if got[k] != want[k])
        host0_print(f"[serve] AOT sidecar fingerprint mismatch on {drift} — "
                    "falling back to building")
        return None

    entries = manifest.get("entries")
    program = manifest.get("program")
    current = library_files()
    if (not isinstance(entries, dict) or not isinstance(program, dict)
            or program.get("model") != model_digest(model)
            or program.get("libraries") != {
                n: e.get("library") for n, e in entries.items()}
            or any(current.get(n) != e.get("library")
                   for n, e in entries.items())):
        host0_print("[serve] AOT sidecar program drift (kernel sources or "
                    "model changed since bank) — falling back to building")
        return None

    blobs: Dict[str, bytes] = {}
    for name, entry in sorted(entries.items()):
        path = os.path.join(aot_dir, entry["library"])
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError:
            return None
        if _sha256_bytes(blob) != entry.get("payload_sha256"):
            quarantine_file(path, "aot payload digest mismatch",
                            kind="aot payload")
            return None
        blobs[name] = blob

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    out: Dict[str, str] = {}
    for name, blob in blobs.items():
        dst = os.path.join(_build.BUILD_DIR, entries[name]["library"])
        if not os.path.isfile(dst):
            _atomic_write(dst, blob)
        out[name] = dst
    return out
