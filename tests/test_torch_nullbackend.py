"""The port's nulled-device backend (ops/nullbackend.py) held against the
JAX package's on the CPU.

NullBatchBackend has no device and no noise: given the same nodes and pods
(dicts from a numpy seed, through each package's own Cache and PodInfo),
both packages' dispatch must return the same (node, status code) per pod,
bit for bit, batch after batch: uniform and mixed requests, pods deleted
and nodes added or resized between batches (the epoch skip and the dirty
recount), idle-time prefetch, constraint pods (they escape with SKIP), a
vocabulary overflow, and the per-batch stats.  FlightDelayBackend pins a
wave's flight from its dispatch, as the JAX wrapper does.  Through the
harness, null_device and make_batch_backend("null") build it by name, and
the shrunk SchedulingHostNull and SchedulingMixedEscapes workloads bind
what the JAX harness binds on its null device.
"""

import copy
import time

import numpy as np
import pytest

pytest.importorskip("jax")

import kubernetes_tpu.scheduler.cache as jax_cache  # noqa: E402
import kubernetes_tpu.scheduler.types as jax_types  # noqa: E402
import kubernetes_tpu.testing as jax_testing  # noqa: E402
from kubernetes_tpu.ops import nullbackend as jax_null  # noqa: E402
from kubernetes_tpu.ops.flatten import Caps as JaxCaps  # noqa: E402
import kubernetes_tpu_torch.scheduler.cache as port_cache  # noqa: E402
import kubernetes_tpu_torch.scheduler.types as port_types  # noqa: E402
import kubernetes_tpu_torch.testing as port_testing  # noqa: E402
from kubernetes_tpu_torch import perf as port_perf  # noqa: E402
from kubernetes_tpu_torch.ops import backend as port_backend  # noqa: E402
from kubernetes_tpu_torch.ops import nullbackend as port_null  # noqa: E402
from kubernetes_tpu_torch.ops.flatten import Caps  # noqa: E402
from torch_cases import CAPS, SEQ_CAPS, Side, outcome  # noqa: E402

ZONE = "topology.kubernetes.io/zone"


def sides(batch_size, caps=SEQ_CAPS):
    return (Side(jax_cache, jax_types, jax_testing,
                 jax_null.NullBatchBackend(JaxCaps(**caps),
                                           batch_size=batch_size), None),
            Side(port_cache, port_types, port_testing,
                 port_null.NullBatchBackend(Caps(**caps),
                                            batch_size=batch_size), None))


def run_both(scenario, batch_size=24, caps=SEQ_CAPS):
    """Run `scenario(side)` on both packages; it yields batches of pod
    dicts, each dispatched, resolved and assumed before the next."""
    got = []
    for s in sides(batch_size, caps):
        out = []
        for pods in scenario(s):
            res = s.backend.dispatch(s.infos(pods), s.cache.flatten_view())()
            s.assume(pods, res)
            out.append(outcome(res))
        got.append((out, dict(s.backend.stats)))
    return got


def seeded_nodes(s, rng, n):
    for i in range(n):
        s.cache.add_node(s.node(f"n{i}", cpu=str(int(rng.integers(2, 9))),
                                mem=f"{int(rng.integers(4, 17))}Gi",
                                pods=int(rng.integers(3, 12))))


def scenario_uniform_fill(s):
    """Uniform batches over seeded nodes until the cluster is full: the
    lowest-index fill, the per-resource slot count and the pod cap."""
    rng = np.random.default_rng(3)
    seeded_nodes(s, rng, 12)
    for k in range(5):
        yield [s.pod(f"u{k}-{i}", cpu="300m", mem="256Mi")
               for i in range(24)]


def scenario_mixed_requests(s):
    """Batches whose pods request differently (the batch's largest request
    per resource sizes every claim: mixed batches under-pack)."""
    rng = np.random.default_rng(5)
    seeded_nodes(s, rng, 10)
    for k in range(4):
        yield [s.pod(f"m{k}-{i}",
                     cpu=f"{int(rng.integers(1, 9)) * 100}m",
                     mem=f"{int(rng.integers(1, 9)) * 128}Mi")
               for i in range(int(rng.integers(5, 25)))]


def scenario_external_changes(s):
    """Between batches: assumed pods forgotten (dirty rows recount), a
    node added and a node resized (the epoch skip must not hide them),
    and an idle-time prefetch that carries its rows into the next
    dispatch's recount."""
    rng = np.random.default_rng(7)
    seeded_nodes(s, rng, 8)
    first = [s.pod(f"e0-{i}", cpu="500m", mem="512Mi") for i in range(20)]
    yield first
    placed = s.backend.dispatch(s.infos([]), s.cache.flatten_view())()
    assert placed == []
    ns = s.cache.update_snapshot(s.cache_mod.Snapshot())
    for name in ("n0", "n1"):
        for pi in list(ns.get(name).pods)[:2]:
            s.cache.forget_pod(pi.pod)
    yield [s.pod(f"e1-{i}", cpu="500m", mem="512Mi") for i in range(20)]
    s.cache.add_node(s.node("late", cpu="16", mem="64Gi", pods=20))
    yield [s.pod(f"e2-{i}", cpu="500m", mem="512Mi") for i in range(24)]
    s.cache.update_node(s.node("n3", cpu="32", mem="64Gi", pods=40))
    s.backend.prefetch(s.cache.flatten_view())
    yield [s.pod(f"e3-{i}", cpu="500m", mem="512Mi") for i in range(24)]


def scenario_constraint_pods_escape(s):
    """Pods with a node selector, zone spread or anti-affinity escape to
    the per-pod oracle (SKIP): the null device has no constraint solver;
    the plain pods beside them still place."""
    for i in range(6):
        s.cache.add_node(s.testing.make_node(f"z{i}")
                         .capacity(cpu="8", mem="16Gi")
                         .labels(disk="ssd" if i % 2 else "hdd")
                         .zone("abc"[i % 3]).build())
    t = s.testing
    yield [t.make_pod("plain-0").req(cpu="100m").build(),
           t.make_pod("sel").req(cpu="100m").node_selector(disk="ssd")
           .build(),
           t.make_pod("spread").req(cpu="100m").labels(app="w")
           .topology_spread(ZONE, max_skew=1, match_labels={"app": "w"})
           .build(),
           t.make_pod("plain-1").req(cpu="100m").build()]


def scenario_vocab_overflow(s):
    """More distinct scalar resources than the caps hold: the batch comes
    back SKIP with the overflow's message, and the next batch re-syncs."""
    s.cache.add_node(s.node("n0", cpu="8", mem="8Gi"))
    yield [s.pod("ok-0", cpu="100m")]
    for j in range(3):
        s.cache.add_node(s.node(f"x{j}", cpu="8",
                                **{f"example.com/r{j}": "4"}))
    yield [s.pod("over-0", cpu="100m")]
    yield [s.pod("over-1", cpu="100m")]


SCENARIOS = {
    "uniform_fill": scenario_uniform_fill,
    "mixed_requests": scenario_mixed_requests,
    "external_changes": scenario_external_changes,
    "constraint_pods_escape": scenario_constraint_pods_escape,
    "vocab_overflow": scenario_vocab_overflow,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_null_dispatch_matches_reference(name):
    (want, jax_stats), (got, stats) = run_both(SCENARIOS[name])
    assert got == want
    assert stats == jax_stats
    assert any(n for batch in got for n, _ in batch) or name == \
        "vocab_overflow"


def test_null_scenarios_place_and_skip():
    """What the scenarios are about actually happens."""
    (_, _), (fill, stats) = run_both(scenario_uniform_fill)
    placed = [n for batch in fill for n, _ in batch if n]
    assert 0 < len(placed) < 5 * 24        # the cluster fills up
    assert stats["batches"] == 5
    (_, _), (esc, _) = run_both(scenario_constraint_pods_escape)
    codes = [c for _, c in esc[0]]
    assert esc[0][0][0] and esc[0][3][0]
    assert codes[1] == codes[2] == port_types.SKIP
    (_, _), (over, _) = run_both(scenario_vocab_overflow,
                                 caps=dict(CAPS, s_cap=1))
    assert over[0][0][0] == "n0"
    assert over[1][0] == (None, port_types.SKIP)
    (_, _), (ext, stats) = run_both(scenario_external_changes)
    assert stats.get("epoch_skips", 0) >= 1
    assert any(n == "late" for batch in ext for n, _ in batch)


def test_vocab_overflow_matches_reference_at_small_caps():
    (want, jax_stats), (got, stats) = run_both(scenario_vocab_overflow,
                                               caps=dict(CAPS, s_cap=1))
    assert got == want and stats == jax_stats


# -- FlightDelayBackend ----------------------------------------------------

class _Stub:
    supports_pipelining = True

    def __init__(self):
        self.stats = {"batches": 0}

    def dispatch(self, pods, snapshot):
        self.stats["batches"] += 1
        return lambda: ["ok"] * len(pods)

    def warmup(self):
        self.warmed = True


def test_flight_delay_pins_wave_wall_and_credits_overlap():
    """tests/test_perf_workloads.py's FlightDelayBackend case on the port:
    the flight clock starts at dispatch, so host work between dispatch and
    resolve counts against it; non-callable returns pass through."""
    stub = _Stub()
    fb = port_null.FlightDelayBackend(stub, flight_s=0.2)
    assert fb.supports_pipelining is True
    fb.warmup()
    assert stub.warmed and fb.stats is stub.stats
    t0 = time.monotonic()
    assert fb.dispatch([1, 2], None)() == ["ok", "ok"]
    assert time.monotonic() - t0 >= 0.2
    resolve = fb.dispatch([1], None)
    time.sleep(0.15)
    t0 = time.monotonic()
    resolve()
    assert time.monotonic() - t0 < 0.15

    class _Inline:
        def dispatch(self, pods, snapshot):
            return [("n0", None)]

    assert port_null.FlightDelayBackend(_Inline(), 0.2).dispatch(
        [1], None) == [("n0", None)]


# -- by name through the harness --------------------------------------------

def test_make_batch_backend_builds_null_by_name():
    b = port_backend.make_batch_backend("null", Caps(**CAPS), batch_size=8)
    assert isinstance(b, port_null.NullBatchBackend)
    assert b.supports_pipelining is False
    # the kind the caller names and nothing else: "tpu" stays the device
    t = port_backend.make_batch_backend("tpu", Caps(**CAPS), batch_size=8,
                                        device="cpu")
    assert isinstance(t, port_backend.TorchBatchBackend)


def test_setup_cluster_wraps_by_request():
    from kubernetes_tpu_torch.ops.faults import (
        ChaosBatchBackend, OverloadSchedule,
    )
    cluster = port_perf.setup_cluster(
        caps=Caps(**CAPS), batch_size=8, null_device=True,
        chaos_schedule=OverloadSchedule(seed=1), device_flight_s=0.01)
    try:
        fb = cluster.scheduler.profiles["default-scheduler"].batch_backend
        assert isinstance(fb, port_null.FlightDelayBackend)
        assert isinstance(fb.inner, ChaosBatchBackend)
        assert isinstance(fb.inner.inner, port_null.NullBatchBackend)
    finally:
        cluster.shutdown()
    cluster = port_perf.setup_cluster(caps=Caps(**CAPS), batch_size=8,
                                      device="cpu")
    try:
        b = cluster.scheduler.profiles["default-scheduler"].batch_backend
        assert isinstance(b, port_backend.TorchBatchBackend)
    finally:
        cluster.shutdown()


def _shrunk(perf_mod, name, node_div, pod_div):
    cfg = copy.deepcopy(perf_mod.load_workloads()[name])
    for op in cfg["workloadTemplate"]:
        if op["opcode"] == "createNodes":
            op["count"] = max(2, op["count"] // node_div)
        elif op["opcode"] == "createPods":
            op["count"] = max(4, op["count"] // pod_div)
        elif op["opcode"] == "barrier":
            op["timeout"] = 120.0
    return cfg


@pytest.mark.parametrize("name,node_div,pod_div", [
    ("SchedulingBasicLarge", 25, 25), ("SchedulingMixedEscapes", 10, 20)])
def test_null_device_workload_binds_as_the_reference(name, node_div,
                                                     pod_div):
    """The host-ceiling shape (SchedulingHostNull's workload) and the
    blended escape workload on both packages' null device: both barriers
    pass, the same pods are created and bound, and MixedEscapes reports a
    non-zero escape rate (its Gt node-affinity pods take the per-pod
    oracle) while the plain workload escapes nothing."""
    jax_perf = pytest.importorskip("kubernetes_tpu.perf")
    runs = {}
    for side, perf_mod, kw in (("jax", jax_perf, {"tpu": True}),
                               ("port", port_perf, {})):
        n_nodes = next(op["count"] for op in _shrunk(
            perf_mod, name, node_div, pod_div)["workloadTemplate"]
            if op["opcode"] == "createNodes")
        summary, stats = perf_mod.run_named_workload(
            _shrunk(perf_mod, name, node_div, pod_div),
            caps=perf_mod.caps_for_nodes(n_nodes), batch_size=512,
            null_device=True, **kw)
        runs[side] = (stats["barrier_ok"], summary.total_pods,
                      stats["created_pods"], stats["escape_rate"] > 0,
                      stats["schedule_attempts"]["error"]
                      if "schedule_attempts" in stats else 0)
    assert runs["port"] == runs["jax"]
    assert runs["port"][0] is True
    assert runs["port"][3] is (name == "SchedulingMixedEscapes")
