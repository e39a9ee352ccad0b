"""The port's tracing spans held against the JAX package's on the CPU.

The same store contents (plain dicts from a numpy seed) are scheduled
through each package's Scheduler (the JAX side's TPUBatchBackend at
KTPU_PALLAS=0, the port's TorchBatchBackend(device="cpu",
claims_noise="murmur")) with a tracer that samples every batch: each
batch's trace must hold the same span names under the same parents, with
equal attributes on the backend's spans (the feasible-node count and the
per-plugin mask and score densities among them).  An untraced scheduler
records nothing, and the batch telemetry reaches the scheduler's
histograms through _drain_backend_telemetry, traced or not.
"""

import importlib

import numpy as np
import pytest

pytest.importorskip("jax")

from torch_cases import (  # noqa: E402
    PORT_PKG as PORT, Stack, mixed_nodes, mixed_pods,
)

JAX = "kubernetes_tpu"
ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"

# tests/test_tracing.py's pipeline spans (the batch root's tree)
PIPELINE_SPANS = {"schedule_batch", "queue.pop", "snapshot.flatten",
                  "plugin.filter_masks", "plugin.score",
                  "plugin.assign_solve", "tpu.h2d", "tpu.d2h", "bind"}
BACKEND_SPANS = ("snapshot.flatten", "plugin.filter_masks", "plugin.score",
                 "plugin.assign_solve", "tpu.h2d", "tpu.d2h")


@pytest.fixture
def pallas_off(monkeypatch):
    monkeypatch.setenv("KTPU_PALLAS", "0")


def zoned_nodes(seed, n):
    def make(testing):
        rng = np.random.default_rng(seed)
        out = []
        for i in range(n):
            w = (testing.make_node(f"z{i}")
                 .capacity(cpu=str(int(rng.integers(4, 9))), mem="16Gi")
                 .labels(**{HOST: f"z{i}", "disk": "ssd" if i % 2 else "hdd"})
                 .zone("abc"[i % 3]))
            if i % 4 == 3:
                w = w.taint("dedicated", "infra", "PreferNoSchedule")
            out.append(w.build())
        return out
    return make


def constraint_mix(seed, n):
    """Plain pods, node selectors, zone spread, hostname anti-affinity,
    host ports and tolerations, mixed: every mask density is nonzero."""
    def make(testing):
        rng = np.random.default_rng(seed)
        out = []
        for i in range(n):
            w = testing.make_pod(f"m{i:03d}").req(
                cpu=f"{int(rng.integers(1, 4)) * 100}m", mem="128Mi")
            kind = i % 6
            if kind == 1:
                w = w.node_selector(disk="ssd")
            elif kind == 2:
                w = w.labels(app="spread").topology_spread(
                    ZONE, max_skew=2, match_labels={"app": "spread"})
            elif kind == 3:
                w = w.labels(app="anti").pod_affinity(
                    HOST, {"app": "anti"}, anti=True)
            elif kind == 4:
                w = w.host_port(8000 + i)
            elif kind == 5:
                w = w.toleration("dedicated", "infra", "PreferNoSchedule")
            out.append(w.build())
        return out
    return make


def traced_run(pkg, make_nodes, make_pods, batch=24, rate=1_000_000):
    """Schedule every pod with the loop stepped by hand; returns the spans
    and the scheduler's gathered metric registry."""
    tracing = importlib.import_module(f"{pkg}.component_base.tracing")
    provider = tracing.TracerProvider(sampling_rate_per_million=rate)
    s = Stack(pkg, batch)
    s.sched.configure_tracing(provider)
    try:
        n = s.load(make_nodes, make_pods)
        done = 0
        while done < n:
            step = s.sched.schedule_step(timeout=0)
            assert step, "the queue ran dry before every pod was popped"
            done += step
        s.sched._flush_pending()
    finally:
        s.stop()   # drains the binder: every bind span has ended
    return provider.snapshot(), s


def by_trace(spans):
    """[(cycle, {span name: (parent name, attributes)})] per batch root,
    in cycle order."""
    ids = {sp.span_id: sp for sp in spans}
    out = []
    for root in spans:
        if root.name != "schedule_batch":
            continue
        fam = {}
        for sp in spans:
            if sp.trace_id == root.trace_id and sp is not root:
                parent = ids.get(sp.parent_span_id)
                fam.setdefault(sp.name, []).append(
                    (parent.name if parent is not None else None,
                     dict(sp.attributes)))
        out.append((root.attributes.get("cycle"), fam))
    return sorted(out, key=lambda t: t[0])


@pytest.mark.parametrize("case", ["plain", "constraints"])
def test_spans_match_the_reference(pallas_off, case):
    if case == "plain":
        nodes, pods = mixed_nodes(31, 10), mixed_pods(32, 60)
    else:
        nodes, pods = zoned_nodes(33, 12), constraint_mix(34, 60)
    ref, _ = traced_run(JAX, nodes, pods)
    got, _ = traced_run(PORT, nodes, pods)
    assert {sp.name for sp in got} == {sp.name for sp in ref}
    assert PIPELINE_SPANS <= {sp.name for sp in got}
    ref_t, got_t = by_trace(ref), by_trace(got)
    assert [c for c, _ in got_t] == [c for c, _ in ref_t]
    for (cycle, g), (_c, r) in zip(got_t, ref_t):
        assert set(g) == set(r), cycle
        for name in g:
            # the same parents, span for span
            assert [p for p, _a in g[name]] == [p for p, _a in r[name]], \
                (cycle, name)
        for name in BACKEND_SPANS:
            if name in r:
                assert [a for _p, a in g[name]] == [a for _p, a in r[name]], \
                    (cycle, name)


def test_topology_of_a_bound_batch():
    """tests/test_tracing.py's topology: tpu.h2d and tpu.d2h under
    plugin.assign_solve; the backend spans, bind and queue.pop under the
    root; every parent id resolves inside the trace."""
    spans, _ = traced_run(PORT, mixed_nodes(41, 8), mixed_pods(42, 30),
                          batch=16)
    roots = [sp for sp in spans if sp.name == "schedule_batch"]
    root, fam = next(
        (r, f) for r in roots
        for f in [[sp for sp in spans if sp.trace_id == r.trace_id]]
        if "bind" in {sp.name for sp in f})
    assert {sp.name for sp in fam} >= PIPELINE_SPANS
    ids = {sp.span_id for sp in fam}
    assert all(sp.parent_span_id in ids for sp in fam
               if sp.parent_span_id is not None)
    by_name = {sp.name: sp for sp in fam}
    solve = by_name["plugin.assign_solve"]
    assert by_name["tpu.h2d"].parent_span_id == solve.span_id
    assert by_name["tpu.d2h"].parent_span_id == solve.span_id
    for name in ("bind", "queue.pop", "snapshot.flatten",
                 "plugin.filter_masks", "plugin.score",
                 "plugin.assign_solve"):
        assert by_name[name].parent_span_id == root.span_id, name
    assert by_name["tpu.h2d"].attributes["variant"] == "plain"
    assert solve.attributes["pods"] == 16
    assert by_name["plugin.filter_masks"].attributes["feasible_nodes"] == 8
    assert all(sp.end_time is not None for sp in fam)


def test_untraced_scheduler_emits_nothing():
    """No configure_tracing call: no provider, and the backend opens no
    span (its _trace_parent finds no current span)."""
    from kubernetes_tpu_torch.component_base import tracing
    s = Stack(PORT, 8)
    opened = []
    real = tracing.Tracer.start_span

    def spy(self, *a, **kw):
        opened.append(a[0] if a else kw.get("name"))
        return real(self, *a, **kw)

    tracing.Tracer.start_span = spy
    try:
        n = s.load(mixed_nodes(43, 4), mixed_pods(44, 8))
        s.schedule_all(n)
        s.sched._flush_pending()
    finally:
        tracing.Tracer.start_span = real
        s.stop()
    assert s.sched.tracer_provider is None
    assert opened == []
    assert all(name for name, _r in s.outcome().values())


def test_unsampled_batches_open_no_backend_span():
    """A tracer that samples nothing: the roots end unsampled and the
    backend computes no span and no score density."""
    calls = []
    spans, s = None, None
    from kubernetes_tpu_torch.ops.backend import TorchBatchBackend
    real = TorchBatchBackend._score_densities

    def spy(self, batch, n):
        calls.append(n)
        return real(self, batch, n)

    TorchBatchBackend._score_densities = spy
    try:
        spans, s = traced_run(PORT, mixed_nodes(45, 4), mixed_pods(46, 16),
                              batch=8, rate=0)
    finally:
        TorchBatchBackend._score_densities = real
    assert not any(sp.name in BACKEND_SPANS for sp in spans)
    assert calls == []


@pytest.mark.parametrize("traced", [False, True])
def test_drain_fills_feasible_nodes(traced):
    """_drain_backend_telemetry: scheduler_tpu_feasible_nodes holds one
    observation per batch, scheduler_tpu_mask_density every plugin family
    and tpu_batch_waves the waves, traced or not."""
    nodes, pods = zoned_nodes(47, 9), constraint_mix(48, 36)
    if traced:
        _spans, s = traced_run(PORT, nodes, pods, batch=12)
    else:
        s = Stack(PORT, 12)
        try:
            n = s.load(nodes, pods)
            for _ in range(3):
                s.schedule_all(n // 3)
        finally:
            s.stop()
    gathered = s.sched.metrics.prom.registry.gather()
    count, total = gathered["scheduler_tpu_feasible_nodes"][()]
    assert count == 3 and total == 3 * 9
    dens = gathered["scheduler_tpu_mask_density"]
    assert {k[0] for k in dens} >= {"NodeAffinity", "InterPodAffinity",
                                    "PodTopologySpread", "TaintToleration",
                                    "NodePorts"}
    waves, _ = gathered["scheduler_tpu_batch_waves"][()]
    assert waves == 3
    assert s.backend.drain_batch_telemetry() == []


def _loop_outcome(armed: bool):
    """Every pod of a seeded constraint mix through the port's Scheduler at
    depth 2, with tracing (every batch sampled), the timeline and the
    census armed — a census before every step — or with none of them."""
    from kubernetes_tpu_torch.component_base import timeline as tlmod
    from kubernetes_tpu_torch.component_base import tracing
    s = Stack(PORT, 12, depth=2)
    s.sched._flight_est = float("inf")   # keep the pipeline two deep
    if armed:
        tlmod.default_timeline.reset()
        tlmod.default_timeline.configure(enabled=True)
        s.sched.configure_tracing(tracing.TracerProvider(
            sampling_rate_per_million=1_000_000))
        s.sched.configure_profiling(None, None, census=True,
                                    timeline=tlmod.default_timeline)
    try:
        n = s.load(zoned_nodes(51, 9), constraint_mix(52, 48))
        done = 0
        while done < n:
            if armed:
                assert set(s.sched.run_device_census()) == {"torch"}
            step = s.sched.schedule_step(timeout=0)
            assert step
            done += step
        s.sched._flush_pending()
    finally:
        s.stop()
        if armed:
            stages = {r["stage"] for r in tlmod.default_timeline.intervals()}
            tlmod.default_timeline.configure(enabled=False)
            tlmod.default_timeline.reset()
            assert {"patch", "h2d", "device-step", "d2h"} <= stages
    return s.outcome()


def test_observability_armed_keeps_every_placement():
    """Tracing, the timeline and the census armed leave every
    spec.nodeName (and PodScheduled reason) as a run with them off."""
    off = _loop_outcome(False)
    on = _loop_outcome(True)
    assert on == off
    assert sum(1 for name, _r in off.values() if name) >= 40
