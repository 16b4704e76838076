"""AST lint: rc-catalogue discipline of the port's CLIs — the JAX package's
rc-catalogue pass (`analysis/lint.py` there), word for word.

Every deliberate exit in `cli/` must use a code from the documented
failure-mode matrix: supervisors (`cli/supervise.py`, the scenario
supervisor) classify restart-vs-stop by rc, so an uncatalogued code
silently falls into the wrong recovery bucket. Literal exits are checked
against RC_CATALOGUE; non-literal exits are allowed only when they read a
declared `exit_code`/`code` attribute (SentinelDiverged.exit_code,
PodAbort.code, …) — the pattern the CLIs use for class-carried codes.

`lint_rc_source` lints a source string, so tests prove the detector trips
on a known-bad sample without planting bad files in the package.

    python -m ddp_classification_pytorch_tpu_torch.analysis.lint

lints the port's `cli/` and exits 0 (clean) or 1 (findings, one line each);
the scenario supervisor runs it as the end-of-run gate and records its rc
in the `lint` event that S4 reads.
"""

from __future__ import annotations

import ast
import os
from typing import List, Optional, Sequence, Tuple

from . import Finding

# the documented exit codes (the failure-mode matrix + the benchmark's 5
# "deadline" row + the elastic pod codes: 10 pod-unviable, 11 pod-reform);
# signal deaths (130/137/143) are raised by the runtime, never by our code,
# so they are deliberately NOT listed
RC_CATALOGUE = frozenset({0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11})


def _called_name(call: ast.Call) -> Tuple[str, Optional[str]]:
    """(attr-or-name, receiver-name) of a call: `sys.exit(x)` →
    ('exit', 'sys'), `SystemExit(x)` → ('SystemExit', None)."""
    f = call.func
    if isinstance(f, ast.Name):
        return f.id, None
    if isinstance(f, ast.Attribute):
        recv = f.value.id if isinstance(f.value, ast.Name) else None
        return f.attr, recv
    return "", None


def _exit_code_findings(call_args: Sequence[ast.expr], where: str,
                        raiser: str) -> List[Finding]:
    if not call_args:  # SystemExit()/sys.exit() → rc 0, catalogued
        return []
    arg = call_args[0]
    if (isinstance(arg, ast.IfExp) and isinstance(arg.body, ast.Constant)
            and isinstance(arg.orelse, ast.Constant)):
        # `0 if ok else 1`: both branches must be catalogued literals
        return (_exit_code_findings([arg.body], where, raiser)
                + _exit_code_findings([arg.orelse], where, raiser))
    if isinstance(arg, ast.Constant):
        if isinstance(arg.value, bool) or not isinstance(arg.value, int):
            return [Finding("rc-catalogue", where,
                            f"{raiser} with a non-integer code {arg.value!r} "
                            "maps to rc 1 — use a catalogued code")]
        if arg.value not in RC_CATALOGUE:
            return [Finding("rc-catalogue", where,
                            f"{raiser}({arg.value}) is not in the documented "
                            f"rc catalogue {sorted(RC_CATALOGUE)} "
                            "(docs/operations.md failure-mode matrix)")]
        return []
    # non-literal: allowed only for declared code attributes
    if isinstance(arg, ast.Attribute) and arg.attr in ("exit_code", "code"):
        return []
    return [Finding("rc-catalogue", where,
                    f"{raiser} with an unrecognized dynamic code "
                    f"`{ast.unparse(arg)}` — use a literal from the catalogue "
                    "or a declared `.exit_code`/`.code` attribute")]


def lint_rc_source(src: str, path: str = "<fixture>") -> List[Finding]:
    """rc-catalogue lint over one source string: every `sys.exit(...)`,
    `os._exit(...)`, and `raise SystemExit(...)` site."""
    findings: List[Finding] = []
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Call):
            name, recv = _called_name(node)
            where = f"{path}:{node.lineno}"
            if name == "exit" and recv in ("sys", "os"):
                findings.extend(_exit_code_findings(
                    node.args, where, f"{recv}.exit"))
            elif name == "_exit" and recv == "os":
                findings.extend(_exit_code_findings(node.args, where, "os._exit"))
            elif name == "SystemExit":
                findings.extend(_exit_code_findings(node.args, where, "SystemExit"))
    return findings


def lint_rc_sites(paths: Optional[Sequence[str]] = None) -> List[Finding]:
    """rc-catalogue lint over the port's CLI package (or explicit paths):
    the surface supervisors classify by exit code."""
    if paths is None:
        cli_dir = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "cli")
        paths = sorted(os.path.join(cli_dir, f) for f in os.listdir(cli_dir)
                       if f.endswith(".py"))
    findings: List[Finding] = []
    for path in paths:
        with open(path) as f:
            findings.extend(lint_rc_source(f.read(), os.path.basename(path)))
    return findings


def main() -> None:
    """Lint `cli/`, print each finding, exit 0 (clean) or 1 (findings)."""
    findings = lint_rc_sites()
    for f in findings:
        print(f)
    print(f"[lint] rc-catalogue: {len(findings)} finding(s)")
    raise SystemExit(1 if findings else 0)


if __name__ == "__main__":
    main()
