"""Import guard: the torch port and `chip_smoke.py` load with jax, flax,
optax, the JAX package and PIL refused at import time (the port decodes
images with its native dataplane only).

A fresh interpreter installs a meta-path finder that refuses those names —
the exact module name or its dotted prefix only, so
`ddp_classification_pytorch_tpu_torch` (whose name merely starts with the
JAX package's) is not caught — then imports every module of the port and
`chip_smoke.py`, and finally checks that none of the refused modules got in
some other way.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "ddp_classification_pytorch_tpu_torch"

_GUARD = r"""
import importlib, importlib.util, os, sys

BLOCKED = ("jax", "flax", "optax", "ddp_classification_pytorch_tpu", "PIL")

def blocked(name):
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)

for name in [m for m in sys.modules if blocked(m)]:
    del sys.modules[name]

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError(f"import of {name!r} refused by the port's guard")
        return None

sys.meta_path.insert(0, Refuse())
repo, port = sys.argv[1], sys.argv[2]
sys.path.insert(0, repo)
names = []
for root, _, files in os.walk(os.path.join(repo, port)):
    for f in sorted(files):
        if f.endswith(".py"):
            rel = os.path.relpath(os.path.join(root, f), repo)[:-3]
            mod = rel.replace(os.sep, ".")
            names.append(mod[: -len(".__init__")] if mod.endswith(".__init__") else mod)
for name in sorted(names):
    importlib.import_module(name)
for name in ("models.resnet", "models.batchnorm", "parallel.ddp",
             "ops.arcface", "ops.cdr", "ops.nested", "models.heads",
             "ops.labelnoise", "data.plc", "train.plc_loop"):
    assert f"{port}.{name}" in names, name
# the item route's decoder is the port's own C++ source, built from the
# repo (it includes the dataplane's source; PIL stays refused)
assert os.path.isfile(os.path.join(repo, port, "data", "csrc", "decode.cpp"))
spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(repo, "chip_smoke.py"))
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m in sys.modules if blocked(m))
assert not leaked, leaked
print("imported", len(names), "modules + chip_smoke")
"""


def _run(code: str):
    return subprocess.run([sys.executable, "-c", code, REPO, PORT], cwd=REPO,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_nothing_of_jax():
    proc = _run(_GUARD)
    assert proc.returncode == 0, proc.stderr
    assert "+ chip_smoke" in proc.stdout


def test_guard_refuses_the_jax_package_but_not_the_port_prefix():
    """The guard has teeth: the JAX package itself is refused, while the
    port's longer name that shares its prefix is not."""
    probe = _GUARD.split("repo, port = sys.argv[1], sys.argv[2]")[0] + (
        "sys.path.insert(0, sys.argv[1])\n"
        "import ddp_classification_pytorch_tpu_torch\n"
        "try:\n"
        "    import ddp_classification_pytorch_tpu.config\n"
        "except ImportError as e:\n"
        "    print('refused:', e)\n")
    proc = _run(probe)
    assert proc.returncode == 0, proc.stderr
    assert "refused: import of 'ddp_classification_pytorch_tpu'" in proc.stdout
