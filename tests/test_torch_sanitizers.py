"""The port's runtime sanitizers (kubernetes_tpu_torch/testing/sanitizers.py)
on the CPU.

SyncGuard's site rules (the `# sync-point:` comment on the line or in the
comment block above it; the first frame inside the package) and its
warning hook, with torch's sync debug mode stubbed (this build has no
CUDA; tests/test_torch_cuda.py runs it on the card); BuildCounter over
ops/_build's counts; and LockOrderChecker, copied from the JAX package's
tools/ktpulint/sanitizers.py, with its self-tests and pointed at the
port's informer (`_dispatch_lock -> _lock, never the reverse`).
"""

from __future__ import annotations

import threading
import traceback
import warnings
from pathlib import Path

import pytest
import torch

from kubernetes_tpu_torch.ops import _build
from kubernetes_tpu_torch.testing import sanitizers
from kubernetes_tpu_torch.testing.sanitizers import (
    BuildCounter, LockOrderChecker, SyncGuard, UnannotatedSync, annotated,
    call_site,
)
import kubernetes_tpu_torch.testing as port_testing
from torch_cases import SEQ_CAPS, port_side

PKG = Path(sanitizers.__file__).resolve().parent.parent
ASSIGN = str(PKG / "models" / "assign.py")


def _line_of(path: str, text: str) -> int:
    lines = Path(path).read_text().splitlines()
    return next(i + 1 for i, ln in enumerate(lines) if text in ln)


def test_annotated_reads_the_line_and_the_block_above(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("x = 1\n"
                   "# sync-point: a count\n"
                   "# more words\n"
                   "n = int(t.sum())\n"
                   "m = int(t.sum())  # sync-point: inline\n"
                   "k = int(t.sum())\n")
    assert annotated(str(src), 4)
    assert annotated(str(src), 5)
    assert not annotated(str(src), 6)
    assert not annotated(str(src), 1)


def test_annotated_follows_a_multiline_statement_to_its_first_line(
        tmp_path):
    """A sync reported on a continuation line (the frame's line of a
    multi-line call) counts as annotated when the statement's first line
    is, as the static rule reads it; a compound statement's header does not
    annotate its body."""
    src = tmp_path / "m.py"
    src.write_text("# sync-point: not for the whole function\n"
                   "def f(t):\n"
                   "    # sync-point: one host read\n"
                   "    x = (t.sum()\n"
                   "         .tolist())\n"
                   "    y = (t.sum()\n"
                   "         .tolist())\n"
                   "    if (t.any()  # sync-point: the branch\n"
                   "            .item()):\n"
                   "        z = t.item()\n")
    assert annotated(str(src), 5)
    assert not annotated(str(src), 7)
    assert annotated(str(src), 9)
    assert not annotated(str(src), 10)


def test_the_steps_count_reads_are_annotated():
    for text in ("n_active = int(active.sum())",
                 "h = torch.nonzero(claims >= 0).squeeze(1)",
                 "act = torch.nonzero(active).squeeze(1)",
                 "bool(active.any())"):
        assert annotated(ASSIGN, _line_of(ASSIGN, text)), text


def test_call_site_is_the_first_package_frame():
    inner = traceback.FrameSummary(str(Path(sanitizers.__file__)), 10, "x")
    pkg = traceback.FrameSummary(ASSIGN, 359, "_wave_loop")
    outside = traceback.FrameSummary("/usr/lib/python3/warnings.py", 1, "w")
    assert call_site([outside, pkg, outside, inner]) == (ASSIGN, 359)
    assert call_site([outside]) is None


@pytest.mark.parametrize("mode", ["warn", "error"])
def test_note_allows_only_annotated_sites(mode):
    g = SyncGuard(mode)
    good = traceback.FrameSummary(
        ASSIGN, _line_of(ASSIGN, "n_active = int(active.sum())"), "f")
    bad = traceback.FrameSummary(
        ASSIGN, _line_of(ASSIGN, "def _wave_loop("), "f")
    g.note([good])
    g.note([good])
    if mode == "error":
        with pytest.raises(UnannotatedSync):
            g.note([bad])
    else:
        g.note([bad])
    assert g.syncs == 3
    assert g.sites[(ASSIGN, good.lineno)] == 2
    assert g.unannotated() == [(ASSIGN, bad.lineno)]


def test_guard_mode_is_checked():
    with pytest.raises(ValueError):
        SyncGuard("raise")


@pytest.fixture
def stub_sync_debug(monkeypatch):
    modes = ["default"]
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda m: modes.append(m))
    return modes


def test_guard_hooks_the_sync_warning(stub_sync_debug):
    """Inside the block torch's sync warning is recorded (here from this
    file: a site outside the package), other warnings pass through, and
    the debug mode is restored on exit."""
    with SyncGuard("warn") as g:
        for _ in range(3):
            warnings.warn("called a synchronizing CUDA operation")
        with pytest.warns(UserWarning, match="unrelated"):
            warnings.warn("unrelated")
    assert g.syncs == 3 and g.sites == {None: 3}
    assert g.unannotated() == [None]
    assert stub_sync_debug == ["default", "warn", "default"]


def test_guard_error_mode_raises_at_the_sync(stub_sync_debug):
    with pytest.raises(UnannotatedSync):
        with SyncGuard("error"):
            warnings.warn("called a synchronizing CUDA operation")
    assert stub_sync_debug[-1] == "default"


def test_build_counter_counts_builds_and_loads(monkeypatch):
    monkeypatch.setattr(_build, "COUNTS", {"builds": {"claims": 2},
                                           "loads": {}})
    with BuildCounter() as bc:
        _build.COUNTS["builds"]["claims"] += 1
        _build.COUNTS["loads"]["preempt"] = 1
    assert bc.builds == {"claims": 1} and bc.loads == {"preempt": 1}
    assert bc.count == 2


def test_cpu_waves_build_nothing():
    """The CPU runs the plain versions: no build, no library load."""
    s = port_side(8, SEQ_CAPS)
    s.cache.add_node(s.node("n0", cpu="8", mem="8Gi"))
    with BuildCounter() as bc:
        for k in range(3):
            pods = [s.pod(f"p{k}-{i}", cpu="100m") for i in range(4)]
            s.assume(pods, s.backend.assign(s.infos(pods), s.snapshot()))
    assert bc.count == 0, (bc.builds, bc.loads)


# -- what the CPU can see of the card's syncs ------------------------------

_A = torch.ops.aten
# ops that read data back to the host on CUDA whatever their operands
_READS_BACK = {_A._local_scalar_dense, _A.nonzero, _A.masked_select,
               _A.unique_dim, _A._unique2, _A.unique_consecutive,
               _A.bincount, _A.equal, _A.is_nonzero, _A.argwhere,
               _A.repeat_interleave}
# ... and the gathers and scatters that do so with a boolean index
_BOOL_INDEXED = {_A.index, _A.index_put, _A.index_put_}


class _SyncProbe:
    """On CPU tensors, the package sites whose code synchronizes on CUDA as
    far as it shows on the CPU: ops that read data back (a scalar, a
    count, a boolean-mask gather) and host data copied to the device
    (torch.tensor / torch.as_tensor with a device)."""

    def __init__(self, monkeypatch):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_leaves
        self.sites: dict = {}
        probe = self

        def note():
            site = call_site(traceback.extract_stack()[:-2])
            probe.sites[site] = probe.sites.get(site, 0) + 1

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                op = func.overloadpacket
                if op in _READS_BACK or (op in _BOOL_INDEXED and any(
                        isinstance(x, torch.Tensor) and x.dtype == torch.bool
                        for x in tree_leaves(args[1:2]))):
                    note()
                return func(*args, **(kwargs or {}))

        self.mode = Mode()
        for name in ("tensor", "as_tensor"):
            inner = getattr(torch, name)

            def upload(data, *a, _inner=inner, **kw):
                if kw.get("device") is not None and not isinstance(
                        data, torch.Tensor):
                    note()
                return _inner(data, *a, **kw)
            monkeypatch.setattr(torch, name, upload)

    def unannotated(self):
        return [s for s in self.sites if s is not None and not annotated(*s)]


def _zoned_side(n_nodes, batch):
    s = port_side(batch, dict(SEQ_CAPS, n_cap=max(64, n_nodes)))
    for i in range(n_nodes):
        s.cache.add_node(port_testing.make_node(f"n{i}")
                         .capacity(cpu="8", mem="16Gi", pods=110)
                         .zone(f"z{i % 3}").build())
    return s


def _run_plain(probe):
    s = _zoned_side(12, 32)
    batches = [[s.pod(f"p{k}-{i}", cpu="100m") for i in range(32)]
               for k in range(3)]
    s.assume(batches[0], s.backend.assign(s.infos(batches[0]), s.snapshot()))
    with probe.mode:
        for pods in batches[1:]:
            s.assume(pods, s.backend.assign(s.infos(pods), s.snapshot()))


def _run_full(probe):
    s = _zoned_side(12, 32)
    zone = "topology.kubernetes.io/zone"

    def pod(name):
        return (port_testing.make_pod(name).req(cpu="100m", mem="64Mi")
                .labels(app="spread")
                .topology_spread(zone, max_skew=1,
                                 match_labels={"app": "spread"}).build())
    batches = [[pod(f"p{k}-{i}") for i in range(32)] for k in range(3)]
    s.assume(batches[0], s.backend.assign(s.infos(batches[0]), s.snapshot()))
    with probe.mode:
        for pods in batches[1:]:
            s.assume(pods, s.backend.assign(s.infos(pods), s.snapshot()))
    assert s.backend.stats.get("plain", 0) == 0


def _run_preempt(probe):
    s = port_side(8, dict(SEQ_CAPS, v_cap=8))
    for i in range(8):
        s.cache.add_node(port_testing.make_node(f"n{i}")
                         .capacity(cpu="4", mem="32Gi").build())
        for k in range(4):
            s.cache.add_pod(port_testing.make_pod(f"low-{i}-{k}")
                            .req(cpu="900m", mem="500Mi").node(f"n{i}")
                            .build())
    snap = s.snapshot()
    s.backend.assign([], snap)
    node_ord_of = {ni.name: i for i, ni in enumerate(snap.list())}
    pre = [port_testing.make_pod(f"pre-{j}").priority(10)
           .req(cpu="3000m", mem="500Mi").build() for j in range(8)]
    s.backend.preempt_batch(s.infos(pre[:2]), node_ord_of)
    with probe.mode:
        res, esc = s.backend.preempt_batch(s.infos(pre), node_ord_of)
    assert not esc and all(r is not None for r in res)


@pytest.mark.parametrize("path", ["plain", "full", "preempt"])
def test_cpu_visible_syncs_sit_at_annotated_sites(monkeypatch, path):
    """The plain step, the full (constraint) step and a preemption wave,
    run on the CPU under a probe of what synchronizes on CUDA: every
    package site it finds carries `# sync-point:` (SyncGuard asks the same
    on the card, where it also sees device-to-host copies)."""
    probe = _SyncProbe(monkeypatch)
    {"plain": _run_plain, "full": _run_full, "preempt": _run_preempt}[path](
        probe)
    assert any(s is not None for s in probe.sites), probe.sites
    assert not probe.unannotated(), probe.unannotated()


def test_scan_reads_nothing_back_inside_its_pod_loop(monkeypatch):
    """The snapshot scan (models/assign.py _scan_pods) on a batch of every
    constraint kind, host ports, pins, PreferNoSchedule taints and
    namespaceSelector terms, under the probe: no site inside the pod loop
    reads back (the placed node stays on the device: an .item(), a
    bool() or a nonzero there would show as a read), and whatever the
    probe sees outside it is annotated."""
    import inspect

    from kubernetes_tpu_torch.models import assign
    from torch_cases import make_full_case, snapshot_node
    caps, state, static, batch, _p = make_full_case("every_kind")
    fn = assign.build_assign_fn(caps, mode="scan", device="cpu")
    probe = _SyncProbe(monkeypatch)
    with probe.mode:
        out = fn(snapshot_node(state, static), batch)
    assert (out["assignments"] >= 0).any()
    src, first = inspect.getsourcelines(assign._scan_pods)
    loop = range(first, first + len(src))
    inside = [s for s in probe.sites if s is not None
              and s[0].endswith("models/assign.py") and s[1] in loop]
    assert not inside, inside
    assert not probe.unannotated(), probe.unannotated()


# -- LockOrderChecker (tools/ktpulint/sanitizers.py's, copied) -------------

def test_consistent_order_is_clean():
    checker = LockOrderChecker()
    a = checker.wrap("A", threading.Lock())
    b = checker.wrap("B", threading.Lock())

    def use():
        with a:
            with b:
                pass

    t = threading.Thread(target=use)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    use()
    assert ("A", "B") in checker.edges
    assert checker.violations() == []


def test_inverted_order_flags_latent_abba():
    checker = LockOrderChecker()
    a = checker.wrap("A", threading.Lock())
    b = checker.wrap("B", threading.Lock())
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    assert checker.violations() == [("A", "B")]


def test_reentrant_self_acquire_is_not_an_edge():
    checker = LockOrderChecker()
    r = checker.wrap("R", threading.RLock())
    with r:
        with r:
            pass
    assert checker.edges == set()
    assert checker.violations() == []


def test_port_informer_dispatch_before_indexer_never_reversed():
    """The port's informer: registration replays under _dispatch_lock and
    snapshots under _lock while readers list and get; the documented edge
    appears and its reverse never does."""
    from kubernetes_tpu_torch.client.informer import Informer

    inf = Informer(None, "pods")
    checker = LockOrderChecker()
    inf._lock = checker.wrap("_lock", inf._lock)
    inf._dispatch_lock = checker.wrap("_dispatch_lock", inf._dispatch_lock)
    inf._indexer["default/p"] = {
        "metadata": {"name": "p", "namespace": "default"}}
    inf._synced.set()
    seen: list = []
    done = threading.Event()

    def reader():
        done.wait(timeout=5)
        for _ in range(50):
            inf.list()
            inf.get("default", "p")

    threads = [threading.Thread(target=reader) for _ in range(4)]
    for t in threads:
        t.start()
    inf.add_event_handler(lambda typ, obj, old: seen.append(typ))
    inf.add_bulk_event_handler(lambda triples: seen.extend(triples))
    done.set()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert seen
    assert ("_dispatch_lock", "_lock") in checker.edges
    assert checker.violations() == []
