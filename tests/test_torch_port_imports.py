"""Import guard: the torch port and `chip_smoke.py` load with jax, flax,
optax, the JAX package and PIL refused at import time (the port decodes
training images with its native dataplane; PIL decodes HTTP request bodies
only, imported inside `serve/http.py::decode_image` at request time —
`test_pil_is_imported_only_in_the_http_decoder` scans the package's
source for every other import of it).

A fresh interpreter installs a meta-path finder that refuses those names —
the exact module name or its dotted prefix only, so
`ddp_classification_pytorch_tpu_torch` (whose name merely starts with the
JAX package's) is not caught — then imports every module of the port and
`chip_smoke.py`, and finally checks that none of the refused modules got in
some other way.
"""

import ast
import os
import subprocess
import sys

from torch_port_threads import one_torch_thread  # noqa: F401

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
             "ops.labelnoise", "data.plc", "train.plc_loop", "obs.events",
             "serve.fleet", "serve.reload", "serve.http", "utils.chaos",
             "parallel.fleet", "cli.supervise", "scenario.spec",
             "scenario.invariants", "scenario.supervisor", "scenario.fuzz",
             "analysis.lint", "cli.scenario", "cli.fuzz", "models.vgg",
             "models.torch_oracle", "models.import_torch",
             "cli.verify_import", "obs.trace", "utils.debug_nans"):
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


def _pil_imports(tree):
    """(enclosing function names, line) of each import of PIL in a module's
    syntax tree: `import PIL...`, `from PIL... import ...`, and
    `importlib.import_module` / `__import__` of a literal PIL name."""
    found = []

    def is_pil(name):
        return name == "PIL" or name.startswith("PIL.")

    def visit(node, scope):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            scope = scope + (node.name,)
        hit = False
        if isinstance(node, ast.Import):
            hit = any(is_pil(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            hit = node.level == 0 and is_pil(node.module or "")
        elif isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(
                f, "id", "")
            hit = name in ("import_module", "__import__") and is_pil(
                node.args[0].value)
        if hit:
            found.append((scope, node.lineno))
        for child in ast.iter_child_nodes(node):
            visit(child, scope)

    visit(tree, ())
    return found


def test_pil_is_imported_only_in_the_http_decoder():
    """The one import of PIL in the port's package is inside
    `serve/http.py`'s `decode_image` (the HTTP front end's decoder, at
    request time); no other module or function of it imports PIL.
    `chip_smoke.py` makes and decodes its test images with PIL inside the
    HTTP phase's functions only (never at import)."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        smoke = _pil_imports(ast.parse(f.read()))
    assert smoke and all(scope for scope, _ in smoke), smoke
    found = {}
    files = []
    for root, _, names in os.walk(os.path.join(REPO, PORT)):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            hits = _pil_imports(ast.parse(f.read(), path))
        if hits:
            found[os.path.relpath(path, REPO)] = hits
    http = os.path.join(PORT, "serve", "http.py")
    assert list(found) == [http], found
    assert [scope for scope, _ in found[http]] == [("decode_image",)]
    # the scan has teeth: it finds each form of the import, at any depth
    probe = ast.parse("import PIL.Image\n"
                      "def f():\n    from PIL import Image\n"
                      "class C:\n    def g(self):\n"
                      "        importlib.import_module('PIL')\n"
                      "from .PIL import x\n")
    assert [s for s, _ in _pil_imports(probe)] == [(), ("f",), ("C", "g")]
