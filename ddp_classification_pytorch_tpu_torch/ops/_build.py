"""Build the port's CUDA sources into shared libraries with a plain C
interface, at first use, with `nvcc` for Hopper (`sm_90a`).

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o lib<name>-<hash>.so <sources>

No PyTorch headers are included, so a build takes seconds, not the minutes
`torch.utils.cpp_extension.load` needs. The library lands in
`ops/build/` (git-ignored), named by a hash of the flags, the sources and
every header they include with `#include "..."` (found beside the file
that includes it, followed through headers that include others): a
changed source or header builds anew, an unchanged set is reused. Each
build writes to a name private to its process and then `os.replace`s it
into place, so two processes building at once cannot hand each other a
half-written file.
nvcc's output (register and shared-memory use from `-Xptxas -v`) is kept in
`<library>.log`. A missing `nvcc` or a failed build raises `BuildError`.
Each library `build` compiles calls every function in `BUILD_LISTENERS`
with `("build:<name>", <source hash>)` once it has landed: the compile
sentinel (`analysis/compile_sentinel.py`) listens there, so a build after
warmup is a steady-state event. A library found already built calls none.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
from typing import Callable, List, Sequence

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
DEFAULT_CUDA_HOME = "/usr/local/cuda"  # the toolkit's default install
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


# called with (event name, signature) after each nvcc build that landed
BUILD_LISTENERS: List[Callable[[str, str], None]] = []


class BuildError(RuntimeError):
    """nvcc is missing, or it refused a source."""


def find_nvcc() -> str:
    """`$CUDA_HOME/bin/nvcc` (or `$CUDA_PATH`), else `nvcc` on PATH, else
    the toolkit's default install at /usr/local/cuda."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        home = os.environ.get(env)
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(DEFAULT_CUDA_HOME, "bin", "nvcc")
    if os.path.isfile(default):
        return default
    raise BuildError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                     "(the port's kernels are built from ops/csrc/ at first "
                     "use)")


_LOCAL_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def local_headers(sources: Sequence[str]) -> List[str]:
    """The headers `sources` include with `#include "..."` that exist beside
    the including file, and the headers those include, each once, in the
    order first met. System headers (`<...>`) are not followed."""
    found: List[str] = []
    stack = list(reversed(sources))
    while stack:
        path = stack.pop()
        with open(path, "rb") as f:
            names = _LOCAL_INCLUDE.findall(f.read())
        for name in reversed(names):
            dep = os.path.normpath(os.path.join(os.path.dirname(path),
                                                name.decode()))
            if os.path.isfile(dep) and dep not in found:
                found.append(dep)
                stack.append(dep)
    return found


def library_path(name: str, sources: Sequence[str]) -> str:
    """Where the library for these sources, their local headers and the
    flags lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [*sources, *local_headers(sources)]:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(name: str, sources: Sequence[str]) -> str:
    """Path of the built library, compiling it if no build of these exact
    sources exists yet."""
    out = library_path(name, sources)
    if os.path.isfile(out):
        return out
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *sources]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise BuildError(f"nvcc failed (rc {proc.returncode}) building {name}:\n"
                         f"{' '.join(cmd)}\n{proc.stdout}")
    with open(f"{tmp}.log", "w") as f:
        f.write(proc.stdout)
    os.replace(f"{tmp}.log", f"{out}.log")
    os.replace(tmp, out)
    for listener in list(BUILD_LISTENERS):
        listener(f"build:{name}", os.path.basename(out))
    return out
