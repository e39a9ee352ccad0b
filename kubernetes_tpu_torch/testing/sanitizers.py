"""Runtime sanitizers for the GPU batch pipeline: the dynamic half of the
port's lint rules (tests/test_torch_lint.py).

The counterparts of the JAX package's tools/ktpulint/sanitizers.py:

* SyncGuard (the twin of transfer_guard): torch.cuda.set_sync_debug_mode
  for the scope, every implicit host synchronization (a device-to-host
  copy that waits, `.item()`, `int(t.sum())`, `torch.nonzero`, ...)
  recorded with its call site, the first frame inside this package.  A
  site is allowed when its line, or the comment block directly above it,
  carries `# sync-point: <why>` (the static rule asks the same).  In
  "error" mode an unannotated sync raises at the call; in "warn" mode it
  is only recorded (`unannotated()`).  The port's eager step reads counts
  back every wave, so the syncs per wave are a measurement, not a
  failure.  Explicit waits (CUDA events, torch.cuda.synchronize) are not
  what sync debug mode reports.

* BuildCounter (the twin of CompileCounter): the nvcc compiles started
  and the kernel libraries loaded inside the scope (ops/_build.COUNTS).
  Warmup builds and loads; steady-state waves must do neither.

* LockOrderChecker / OrderedLock: wrap threading locks to record the
  acquisition-order graph per thread; a cycle (A->B and B->A) is a latent
  deadlock even if the run never interleaved it.  Verifies the informer's
  documented `_dispatch_lock -> _lock, never the reverse` contract.

Reference: torch.cuda.set_sync_debug_mode; Go's -race acquisition-order
heuristic for the lock checker.
"""

from __future__ import annotations

import ast
import functools
import linecache
import re
import threading
import traceback
import warnings
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_SELF = Path(__file__).resolve()
_SYNC_POINT = re.compile(r"#\s*sync-point:")
# the text torch's sync debug mode warns with
_SYNC_WARNING = "called a synchronizing CUDA operation"


@functools.lru_cache(maxsize=None)
def _statement_starts(path: str) -> dict[int, int]:
    """line -> first line of the innermost statement of `path` spanning it
    (for the lines of multi-line statements)."""
    try:
        tree = ast.parse(Path(path).read_text())
    except (OSError, SyntaxError, ValueError):
        return {}
    starts: dict[int, int] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.stmt):
            continue
        # a compound statement's own lines are its header, not its body
        body = getattr(node, "body", None)
        end = body[0].lineno - 1 if body else node.end_lineno
        for ln in range(node.lineno + 1, end + 1):
            if starts.get(ln, 0) < node.lineno:
                starts[ln] = node.lineno
    return starts


def annotated(path: str, line: int) -> bool:
    """True when `# sync-point:` is on `line` of `path` or in the comment
    block directly above it, or, for a line inside a multi-line statement,
    on the statement's first line or above that (where the static rule
    looks)."""
    if _annotated_line(path, line):
        return True
    start = _statement_starts(path).get(line)
    return start is not None and _annotated_line(path, start)


def _annotated_line(path: str, line: int) -> bool:
    text = linecache.getline(path, line)
    if _SYNC_POINT.search(text):
        return True
    ln = line - 1
    while ln >= 1:
        above = linecache.getline(path, ln).strip()
        if not above.startswith("#"):
            return False
        if _SYNC_POINT.search(above):
            return True
        ln -= 1
    return False


def call_site(stack) -> tuple[str, int] | None:
    """(file, line) of the innermost frame of `stack` (a list of
    traceback.FrameSummary, outermost first) that lies inside this package
    and outside this module, or None."""
    for frame in reversed(stack):
        p = Path(frame.filename).resolve()
        if p == _SELF:
            continue
        if _PKG in p.parents:
            return str(p), frame.lineno
    return None


class UnannotatedSync(RuntimeError):
    """An implicit host synchronization at a site without `# sync-point:`."""


class SyncGuard:
    """Record every implicit CUDA synchronization inside the block.

        with SyncGuard("error") as g:
            run_waves()
        print(g.syncs, g.sites)

    `syncs` counts them, `sites` maps (file, line) -> count (None for a
    sync outside this package), `unannotated()` lists the sites that lack
    a `# sync-point:` comment.  "error" raises UnannotatedSync at such a
    site."""

    def __init__(self, mode: str = "warn"):
        if mode not in ("warn", "error"):
            raise ValueError(f"SyncGuard mode {mode!r}: warn or error")
        self.mode = mode
        self.syncs = 0
        self.sites: dict[tuple[str, int] | None, int] = {}
        self._lock = threading.Lock()

    def note(self, stack) -> None:
        """Record one synchronization whose Python stack is `stack`."""
        site = call_site(stack)
        with self._lock:
            self.syncs += 1
            self.sites[site] = self.sites.get(site, 0) + 1
        if self.mode == "error" and (site is None or not annotated(*site)):
            raise UnannotatedSync(
                "implicit CUDA synchronization at "
                f"{'outside the package' if site is None else '%s:%d' % site}"
                " without a `# sync-point:` comment")

    def unannotated(self) -> list:
        return sorted((s for s in self.sites
                       if s is None or not annotated(*s)),
                      key=lambda s: ("", 0) if s is None else s)

    def __enter__(self) -> "SyncGuard":
        import torch
        self._catcher = warnings.catch_warnings()
        self._catcher.__enter__()
        warnings.filterwarnings("always", message=_SYNC_WARNING)
        self._show = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if _SYNC_WARNING in str(message):
                self.note(traceback.extract_stack()[:-1])
            else:
                self._show(message, category, filename, lineno, file, line)

        warnings.showwarning = show
        self._prev_mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc) -> None:
        import torch
        torch.cuda.set_sync_debug_mode(self._prev_mode)
        self._catcher.__exit__(*exc)


class BuildCounter:
    """nvcc compiles started (`builds`) and kernel libraries loaded
    (`loads`) inside the block, by source name.

        with BuildCounter() as bc:
            run_waves()
        assert bc.count == 0, (bc.builds, bc.loads)
    """

    def __enter__(self) -> "BuildCounter":
        from ..ops import _build
        self._counts = _build.COUNTS
        self._start = {k: dict(v) for k, v in self._counts.items()}
        return self

    def __exit__(self, *exc) -> None:
        def delta(kind):
            now, then = self._counts[kind], self._start[kind]
            return {k: n - then.get(k, 0) for k, n in now.items()
                    if n != then.get(k, 0)}
        self.builds = delta("builds")
        self.loads = delta("loads")
        self.count = sum(self.builds.values()) + sum(self.loads.values())


class OrderedLock:
    """Proxy around a Lock/RLock that reports acquisitions to a
    LockOrderChecker.  Context-manager and acquire/release compatible,
    so it can be swapped into an object's lock attributes."""

    def __init__(self, name: str, inner, checker: "LockOrderChecker"):
        self.name = name
        self._inner = inner
        self._checker = checker

    def acquire(self, *a, **kw):
        got = self._inner.acquire(*a, **kw)
        if got:
            self._checker._note_acquire(self.name)
        return got

    def release(self) -> None:
        self._checker._note_release(self.name)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class LockOrderChecker:
    """Builds the held->acquired edge graph across all threads.

        checker = LockOrderChecker()
        obj._lock = checker.wrap("_lock", obj._lock)
        obj._dispatch_lock = checker.wrap("_dispatch_lock", obj._dispatch_lock)
        ... run threaded workload ...
        assert not checker.violations()
    """

    def __init__(self) -> None:
        self._tls = threading.local()
        self._graph_lock = threading.Lock()
        # (outer, inner) -> first observed, with edge de-dup
        self.edges: set[tuple[str, str]] = set()

    def wrap(self, name: str, lock) -> OrderedLock:
        return OrderedLock(name, lock, self)

    def _stack(self) -> list[str]:
        if not hasattr(self._tls, "stack"):
            self._tls.stack = []
        return self._tls.stack

    def _note_acquire(self, name: str) -> None:
        stack = self._stack()
        new_edges = {(held, name) for held in stack
                     if held != name}  # re-entrant self-acquire is not an edge
        if new_edges - self.edges:
            with self._graph_lock:
                self.edges |= new_edges
        stack.append(name)

    def _note_release(self, name: str) -> None:
        stack = self._stack()
        if name in stack:
            # remove the innermost occurrence (re-entrant locks release LIFO)
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] == name:
                    del stack[i]
                    break

    def violations(self) -> list[tuple[str, str]]:
        """Edge pairs observed in BOTH directions — each is a latent
        ABBA deadlock regardless of whether this run interleaved it."""
        with self._graph_lock:
            return sorted({(a, b) for (a, b) in self.edges
                           if (b, a) in self.edges and a < b})
