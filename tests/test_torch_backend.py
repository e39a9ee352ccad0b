"""Backend-level parity: the JAX package's TPUBatchBackend under
KTPU_PALLAS=0 against the port's TorchBatchBackend(device="cpu",
claims_noise="murmur"), driven with the same plain pod and node dicts
through each package's own Cache and PodInfo.

The (node, status code) lists must be identical: on tests/test_tpu_batch.py's
plain-variant scenarios (TestResourceFit, the taint and unschedulable-node
cases, the first randomized resource workload), and on a multi-batch sequence with pod
deletions between batches (row patches), a node add (static patch) and a
forced full refresh.  The port's depth-2 pipeline (dispatch k+1 before
resolve k, a fenced wave included) equals its depth-1 run.  The full
(constraint) variant's scenarios are in tests/test_torch_backend_full.py.
"""

import random

import numpy as np
import pytest

pytest.importorskip("jax")

import kubernetes_tpu.scheduler.cache as jax_cache  # noqa: E402
import kubernetes_tpu.scheduler.types as jax_types  # noqa: E402
import kubernetes_tpu.testing as jax_testing  # noqa: E402
from kubernetes_tpu.ops import backend as jax_backend  # noqa: E402
from kubernetes_tpu.ops.flatten import Caps as JaxCaps  # noqa: E402
import kubernetes_tpu_torch.scheduler.types as port_types  # noqa: E402
from kubernetes_tpu_torch.ops import backend as port_backend  # noqa: E402
from torch_cases import (  # noqa: E402
    CAPS, SEQ_BATCH, SEQ_CAPS, Side, outcome, port_side, sequence,
)

def jax_side(batch_size, caps=CAPS, **kw):
    """The JAX package's stack; `kw` go to TPUBatchBackend."""
    return Side(jax_cache, jax_types, jax_testing,
                jax_backend.TPUBatchBackend(JaxCaps(**caps),
                                            batch_size=batch_size, **kw),
                jax_backend.FLUSH_FIRST)


@pytest.fixture
def sides(monkeypatch):
    monkeypatch.setenv("KTPU_PALLAS", "0")

    def make(batch_size, caps=CAPS):
        return jax_side(batch_size, caps), port_side(batch_size, caps)
    return make


def scenario_basic_fit_and_overflow(s):
    s.cache.add_node(s.node("n1", cpu="1", mem="2Gi"))
    return [[s.pod(f"p{i}", cpu="600m") for i in range(3)]]


def scenario_spreads_across_nodes(s):
    for i in range(4):
        s.cache.add_node(s.node(f"n{i}", cpu="1", mem="2Gi"))
    return [[s.pod(f"p{i}", cpu="600m") for i in range(4)]]


def scenario_respects_existing_usage(s):
    s.cache.add_node(s.node("n1", cpu="1"))
    s.cache.add_node(s.node("n2", cpu="1"))
    s.cache.add_pod(s.pod("e", node="n1", cpu="900m"))
    return [[s.pod("p", cpu="500m")]]


def scenario_pod_count_limit(s):
    s.cache.add_node(s.node("n1", cpu="8", mem="8Gi", pods=2))
    return [[s.pod(f"p{i}", cpu="100m") for i in range(3)]]


def scenario_scalar_resources(s):
    s.cache.add_node(s.node("n1", cpu="8", **{"google.com/tpu": "4"}))
    s.cache.add_node(s.node("n2", cpu="8"))
    return [[s.pod("p", cpu="1", **{"google.com/tpu": "4"}),
             s.pod("q", cpu="1", **{"google.com/tpu": "4"})]]


def scenario_taints(s):
    s.cache.add_node(s.testing.make_node("n1").taint("dedicated", "db")
                     .build())
    s.cache.add_node(s.testing.make_node("n2").build())
    return [[s.testing.make_pod("p").build()],
            [s.testing.make_pod("q").toleration("dedicated", "db",
                                                "NoSchedule").build()]]


def scenario_unschedulable_node(s):
    s.cache.add_node(s.testing.make_node("n1").unschedulable().build())
    s.cache.add_node(s.testing.make_node("n2").build())
    return [[s.testing.make_pod("p").build()]]


def scenario_random_resource_workloads(s):
    """TestOracleParity.test_random_resource_workloads' first trial."""
    rng = random.Random(42)
    for i in range(8):
        s.cache.add_node(s.node(f"n{i}", cpu=f"{rng.randint(1, 8)}",
                                mem=f"{rng.randint(2, 16)}Gi"))
    return [[s.pod(f"t0p{i}", cpu=f"{rng.randint(100, 2000)}m",
                   mem=f"{rng.randint(128, 4096)}Mi") for i in range(16)]]


# tests/test_tpu_batch.py's plain-variant scenarios, batch sizes kept
PLAIN_SCENARIOS = {
    "basic_fit_and_overflow": (scenario_basic_fit_and_overflow, 4),
    "spreads_across_nodes": (scenario_spreads_across_nodes, 4),
    "respects_existing_usage": (scenario_respects_existing_usage, 2),
    "pod_count_limit": (scenario_pod_count_limit, 4),
    "scalar_resources": (scenario_scalar_resources, 2),
    "taints": (scenario_taints, 2),
    "unschedulable_node": (scenario_unschedulable_node, 1),
    "random_resource_workloads": (scenario_random_resource_workloads, 16),
}


@pytest.mark.parametrize("name", sorted(PLAIN_SCENARIOS))
def test_plain_scenarios(sides, name):
    build, batch_size = PLAIN_SCENARIOS[name]
    out = []
    for s in sides(batch_size):
        out.append([outcome(s.backend.assign(s.infos(pods), s.snapshot()))
                    for pods in build(s)])
    assert out[0] == out[1]
    assert any(name for batch in out[1] for name, _ in batch)


def test_patch_refresh_sequence_matches_reference(sides):
    (jax_out, jax_stats), (port_out, port_stats) = (
        sequence(s) for s in sides(SEQ_BATCH, SEQ_CAPS))
    assert port_out == jax_out
    # the sequence reached every path it is meant to cover
    assert port_stats["patched_rows"] > 0
    assert port_stats.get("static_patched_rows", 0) > 0
    assert port_stats["full_refresh"] >= 2
    assert sum(1 for b in port_out for name, _ in b if name) > 40


def test_depth_two_equals_depth_one():
    def port():
        return port_side(SEQ_BATCH, SEQ_CAPS)
    one, _ = sequence(port(), depth=1)
    two, stats = sequence(port(), depth=2)
    assert two == one
    assert stats["batches"] == 6
    assert stats.get("fence_replays", 0) == 1
    assert stats["flush_first"] == 1


def test_depth_two_fenced_wave_equals_depth_one():
    """A patch-carrying dispatch over an in-flight wave rides the pipeline
    FENCED and is re-run from the mirror at its resolve."""
    def run(depth):
        s = port_side(8, SEQ_CAPS)
        for i in range(6):
            s.cache.add_node(s.node(f"n{i}", cpu="4", mem="8Gi"))
        view = s.cache.flatten_view()
        first = [s.pod(f"a{i}", cpu="500m") for i in range(8)]
        second = [s.pod(f"b{i}", cpu="700m") for i in range(8)]
        r1 = s.backend.dispatch(s.infos(first), view)
        if depth == 1:
            out1 = r1()
            s.assume(first, out1)
        s.cache.add_pod(s.pod("ext", node="n0", cpu="1"))  # external change
        r2 = s.backend.dispatch(s.infos(second), view)
        assert r2 is not s.flush_first
        if depth == 2:
            out1 = r1()
            s.assume(first, out1)
        return outcome(out1), outcome(r2()), s.backend.stats
    a1, a2, _ = run(1)
    b1, b2, stats = run(2)
    assert (b1, b2) == (a1, a2)
    assert stats.get("fence_replays", 0) == 1


def test_generation_fence_recovers():
    """A device state the host never committed (here: a lost step) trips
    the fence; the wave re-runs from the mirror and matches a clean run."""
    def run(lose_state):
        s = port_side(8, SEQ_CAPS)
        for i in range(4):
            s.cache.add_node(s.node(f"n{i}", cpu="2", mem="4Gi"))
        view = s.cache.flatten_view()
        out = outcome(s.backend.assign(
            s.infos([s.pod(f"a{i}", cpu="500m") for i in range(8)]), view))
        if lose_state:
            s.backend._state["gen"] += 7
        out2 = outcome(s.backend.assign(
            s.infos([s.pod(f"b{i}", cpu="300m") for i in range(8)]), view))
        return out, out2, s.backend.stats
    clean = run(False)
    healed = run(True)
    assert healed[:2] == clean[:2]
    assert healed[2].get("gen_stale_waves", 0) == 1


def test_empty_name_guard():
    """decode_results never binds to nodeName "": such a row is an ERROR."""
    out = port_backend.decode_results(np.array([0, 1, -1]), 3, 4, set(),
                                      ["n0", "", None], "no fit")
    assert out[0] == ("n0", None)
    assert out[1][0] is None and out[1][1].code == port_types.ERROR
    assert out[2][1].code == port_types.UNSCHEDULABLE
