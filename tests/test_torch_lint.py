"""ktpu-lint over the port: the engine's framework-agnostic rules run on
kubernetes_tpu_torch (the engine takes the package as its target), plus
the port's own device-sync rule.

The JAX package's device-sync rule knows jax's transfer idioms; the port
syncs through torch.  Its rule here: in ops/, models/ and parallel/, in
every module that imports torch, each implicit host synchronization —
`.item()`,
`.tolist()`, `.cpu()`, `torch.nonzero` / `.nonzero()`, and `int()`,
`bool()` or `float()` of a reduction (`t.sum()`, `t.any()`, ...) — carries
a `# sync-point: <why>` comment on its line or in the comment block
directly above (the runtime twin, testing.sanitizers.SyncGuard, allows
exactly those sites).  Host numpy is no sync: an expression rooted at
`np.` is skipped, and a site or a whole function that computes on host
arrays says so with `# host-array: <why>`.
"""

from __future__ import annotations

import ast
import pathlib
import textwrap

import pytest

from tools.ktpulint.engine import FileView, LintContext, dotted, run_lint

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = "kubernetes_tpu_torch"

AGNOSTIC_RULES = ("span-lifecycle", "timeline-stage-paired", "escape-reason",
                  "profiling-gated", "lock-discipline", "net-timeout",
                  "retry-backoff", "eviction-confinement",
                  "overload-metric-reason", "bind-conflict-handled",
                  "process-safe-state", "metric-documented")


def port_context(targets=None) -> LintContext:
    return LintContext(REPO, targets=targets or [REPO / PKG],
                       package_name=PKG)


@pytest.mark.parametrize("rule", AGNOSTIC_RULES)
def test_engine_rule_clean_on_port(rule):
    findings = run_lint(port_context(), [rule])
    assert not findings, "\n".join(f.render() for f in findings)


def test_engine_rules_see_the_port():
    """The rules above are not vacuous: the port's files are their
    targets, and the span and timeline rules find their call sites."""
    ctx = port_context()
    rels = {v.rel for v in ctx.files()}
    assert f"{PKG}/ops/backend.py" in rels
    assert f"{PKG}/ops/flatten.py" in rels
    backend = ctx.view(f"{PKG}/ops/backend.py").text
    assert "start_span(" in backend and "default_timeline.record(" in backend


# -- the port's device-sync rule --------------------------------------------

SYNC_ATTRS = {"item", "tolist", "cpu"}
REDUCTIONS = {"sum", "any", "all", "max", "min", "amax", "amin",
              "count_nonzero"}


def _root_name(e: ast.AST) -> str | None:
    while isinstance(e, (ast.Call, ast.Attribute, ast.Subscript)):
        e = e.func if isinstance(e, ast.Call) else e.value
    return e.id if isinstance(e, ast.Name) else None


def _marked(view: FileView, line: int, kind: str) -> bool:
    """`# <kind>:` on `line` or in the comment block directly above it."""
    tag = f"# {kind}:"
    if tag in view.lines[line - 1]:
        return True
    ln = line - 1
    while ln >= 1 and view.lines[ln - 1].lstrip().startswith("#"):
        if tag in view.lines[ln - 1]:
            return True
        ln -= 1
    return False


def _sync_kind(call: ast.Call) -> str | None:
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr in SYNC_ATTRS and not call.args:
        return None if _root_name(f.value) == "np" else f".{f.attr}()"
    if dotted(f) == "torch.nonzero":
        return "torch.nonzero"
    if isinstance(f, ast.Attribute) and f.attr == "nonzero" \
            and _root_name(f.value) not in ("np", "torch"):
        return ".nonzero()"
    if (isinstance(f, ast.Name) and f.id in ("int", "bool", "float")
            and len(call.args) == 1 and isinstance(call.args[0], ast.Call)):
        inner = call.args[0].func
        if (isinstance(inner, ast.Attribute) and inner.attr in REDUCTIONS
                and _root_name(inner.value) != "np"):
            return f"{f.id}(.{inner.attr}())"
    return None


def device_sync_findings(view: FileView) -> list[tuple[int, str]]:
    """(line, what) of every unannotated implicit host sync in `view`."""
    if "import torch" not in view.text or view.tree is None:
        return []
    host_defs = [fn for fn in ast.walk(view.tree)
                 if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
                 and _marked(view, fn.lineno, "host-array")]
    host_lines = {ln for fn in host_defs
                  for ln in range(fn.lineno, fn.end_lineno + 1)}
    out = []
    for n in ast.walk(view.tree):
        if not isinstance(n, ast.Call):
            continue
        what = _sync_kind(n)
        if (what and n.lineno not in host_lines
                and not _marked(view, n.lineno, "sync-point")
                and not _marked(view, n.lineno, "host-array")):
            out.append((n.lineno, what))
    return sorted(out)


def _hot_views():
    ctx = port_context([REPO / PKG / "ops", REPO / PKG / "models",
                        REPO / PKG / "parallel"])
    return list(ctx.files())


def test_device_sync_sites_are_annotated():
    found = [f"{v.rel}:{line}: {what} without # sync-point:"
             for v in _hot_views() for line, what in device_sync_findings(v)]
    assert not found, "\n".join(found)


def test_device_sync_scans_the_step():
    """The rule reads the modules that hold the step and the kernels'
    wrappers, and the step's annotated syncs are in them."""
    views = {v.rel: v for v in _hot_views()}
    for rel in ("models/assign.py", "models/preempt.py", "ops/kernels.py",
                "ops/backend.py", "parallel/mesh.py", "parallel/backend.py",
                "parallel/census.py"):
        assert f"{PKG}/{rel}" in views
    assign = views[f"{PKG}/models/assign.py"].text
    assert assign.count("# sync-point:") >= 7


def _view(tmp_path, src: str) -> FileView:
    path = tmp_path / "mod.py"
    path.write_text(textwrap.dedent(src))
    return FileView(path, "mod.py")


@pytest.mark.parametrize("src, want", [
    ("n = int(active.sum())", ["int(.sum())"]),
    ("go = bool(active.any())", ["bool(.any())"]),
    ("x = t.item()", [".item()"]),
    ("xs = t.tolist()", [".tolist()"]),
    ("h = t.cpu()", [".cpu()"]),
    ("i = torch.nonzero(m)", ["torch.nonzero"]),
    ("i = m.nonzero()", [".nonzero()"]),
    ("xs = np.asarray(a, np.int64).tolist()", []),
    ("i = np.nonzero(m)[0].tolist()", []),
    ("n = int(np.count_nonzero(m))", []),
    ("# sync-point: read the count\nn = int(active.sum())", []),
    ("n = int(active.sum())  # sync-point: read the count", []),
    ("# host-array: numpy\nn = float(acc.sum())", []),
    ("# host-array: numpy rows\ndef f(a):\n    return float(a.sum())", []),
    ("def f(a):\n    return float(a.sum())", ["float(.sum())"]),
])
def test_device_sync_rule_cases(tmp_path, src, want):
    view = _view(tmp_path, "import torch\n" + src + "\n")
    assert [w for _line, w in device_sync_findings(view)] == want


def test_device_sync_rule_skips_modules_without_torch(tmp_path):
    view = _view(tmp_path, "import numpy as np\nn = int(a.sum())\n")
    assert device_sync_findings(view) == []


def test_replicated_partition_rules_carry_their_reason():
    """Every rule of the sharded path's table that replicates an array
    (spec ()) says why on its line, as the JAX table does."""
    src = (REPO / PKG / "parallel" / "mesh.py").read_text().splitlines()
    rules = [ln for ln in src if ln.lstrip().startswith("(r\"^")]
    replicated = [ln for ln in rules if ln.rstrip().endswith(
        ("()),", "()),  ")) or "()),  #" in ln]
    assert len(rules) == 6 and len(replicated) == 3
    for ln in replicated:
        assert "# replicated-ok:" in ln, ln
