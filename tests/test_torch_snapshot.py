"""The port's single-device snapshot form (models/assign.py
make_assign_core / build_assign_fn) held against the JAX package's
build_assign_fn on the CPU.

mode="scan" is the strict one-pod-at-a-time solver, JAX's parity oracle
(kubernetes_tpu/models/assign.py _make_scan_core); no JAX test reaches it,
so these cases are its only guard.  mode="wave" is the full variant's
waves on one shard at murmur (the JAX single-device core runs
ALL_FEATURES, so it never takes the Pallas kernel).  The same cluster,
encoded by the port's flatten copy, goes through both packages: the JAX
function takes batch.materialized(caps, pod_specs keys), the port's the
PodBatch.  Every output key is compared bit for bit: the tolerance is 0.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from kubernetes_tpu.models import assign as jax_assign  # noqa: E402
from kubernetes_tpu.ops.flatten import Caps as JaxCaps  # noqa: E402
from kubernetes_tpu.parallel import mesh as jax_mesh  # noqa: E402
from kubernetes_tpu_torch import testing as port_testing  # noqa: E402
from kubernetes_tpu_torch.models import assign  # noqa: E402
from kubernetes_tpu_torch.ops.flatten import (  # noqa: E402
    BatchEncoder, Caps, ClusterTensors,
)
from kubernetes_tpu_torch.parallel import mesh  # noqa: E402
from kubernetes_tpu_torch.scheduler.cache import Cache, Snapshot  # noqa: E402
from kubernetes_tpu_torch.scheduler.types import PodInfo  # noqa: E402
from test_torch_sharded_assign import random_workload, workload  # noqa: E402
from torch_cases import (  # noqa: E402
    FULL_CASES, SNAPSHOT_CASES, make_full_case, snapshot_node,
)

SCAN_KEYS = ("assignments", "used", "npods")
WAVE_KEYS = ("assignments", "waves", "used", "used_nz", "npods",
             "port_mask", "cd_sg", "cd_asg")
CASES = sorted(FULL_CASES) + sorted(SNAPSHOT_CASES)
WEIGHTS = {"fit": 1.5, "balanced": 0.7, "taint": 1.3, "spread": 2.5,
           "affinity": 0.6}
SMALL_CAPS = dict(n_cap=32, l_cap=64, kl_cap=32, t_cap=8, pt_cap=8, s_cap=2,
                  sg_cap=8, asg_cap=8)

_JAX_FNS = {}


def run_jax(caps, node, batch, mode, weights=None):
    """JAX's build_assign_fn, compiled once per (caps, P, mode, weights)."""
    jcaps = JaxCaps(**vars(caps))
    key = (tuple(sorted(vars(caps).items())), batch.p_cap, mode,
           tuple(sorted((weights or {}).items())))
    if key not in _JAX_FNS:
        _JAX_FNS[key] = jax_assign.build_assign_fn(jcaps, weights, mode)
    pods = {k: jnp.asarray(v) for k, v in batch.materialized(
        jcaps, tuple(jax_mesh.pod_specs())).items()}
    out = _JAX_FNS[key]({k: jnp.asarray(v) for k, v in node.items()}, pods)
    return {k: np.asarray(v) for k, v in out.items()}


def run_port(caps, node, batch, mode, weights=None):
    return assign.build_assign_fn(caps, weights, mode=mode,
                                  device="cpu")(node, batch)


def assert_same(port, ref, mode, what=""):
    keys = SCAN_KEYS if mode == "scan" else WAVE_KEYS
    assert set(port) == set(keys), sorted(port)
    for k in keys:
        np.testing.assert_array_equal(np.asarray(port[k]), ref[k],
                                      err_msg=f"{k} {what}")


def case_inputs(name):
    caps, state, static, batch, _patches = make_full_case(name)
    return caps, snapshot_node(state, static), batch


def encode(caps, nodes, pods, existing=()):
    """(whole node arrays, PodBatch, ClusterTensors) from the port's
    flatten."""
    cache = Cache()
    for n in nodes:
        cache.add_node(n)
    for p in existing:
        cache.add_pod(p)
    t = ClusterTensors(caps)
    t.update_from_snapshot(cache.update_snapshot(Snapshot()))
    batch = BatchEncoder(t, len(pods)).encode([PodInfo(p) for p in pods])
    assert not batch.escape
    cd_sg, cd_asg = t.domain_base_counts()
    node = {k: getattr(t, k).copy() for k in mesh.NODE_KEYS
            if k not in ("cd_sg", "cd_asg")}
    node.update(cd_sg=cd_sg, cd_asg=cd_asg)
    return node, batch, t


@pytest.mark.parametrize("name", CASES)
def test_scan_matches_jax(name):
    caps, node, batch = case_inputs(name)
    port = run_port(caps, node, batch, "scan")
    assert_same(port, run_jax(caps, node, batch, "scan"), "scan", name)
    assert (port["assignments"] >= 0).any()


@pytest.mark.parametrize("name", CASES)
def test_wave_matches_jax(name):
    caps, node, batch = case_inputs(name)
    port = run_port(caps, node, batch, "wave")
    assert_same(port, run_jax(caps, node, batch, "wave"), "wave", name)


@pytest.mark.parametrize("name", ["scores_varied", "prefer_taints",
                                  "preferred", "spread_soft"])
@pytest.mark.parametrize("mode", ["scan", "wave"])
def test_custom_weights_match_jax(mode, name):
    """Every score weight away from its default: XLA folds fit and
    balanced into the constants they multiply, contracts the fit sum and
    (in the scan) the taint term, and hoists the wave's taint product out
    of its loop (ROADMAP R12)."""
    caps, node, batch = case_inputs(name)
    port = run_port(caps, node, batch, mode, WEIGHTS)
    assert_same(port, run_jax(caps, node, batch, mode, WEIGHTS), mode, name)


@pytest.mark.parametrize("mode", ["scan", "wave"])
def test_sharded_assign_workload(mode):
    """tests/test_sharded_assign.py's workload: zone spread, hostname
    anti-affinity and plain pods; the constraints hold."""
    caps = Caps(**SMALL_CAPS)
    nodes, pods = workload()
    node, batch, t = encode(caps, nodes, pods)
    port = run_port(caps, node, batch, mode)
    assert_same(port, run_jax(caps, node, batch, mode), mode)
    names = [t.node_name(r) if r >= 0 else None for r in port["assignments"]]
    solo = names[6:10]
    assert None not in solo and len(set(solo)) == 4
    zones = [n[0] for n in names[:6]]
    assert zones.count("a") == 3 and zones.count("b") == 3


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("mode", ["scan", "wave"])
def test_seeded_workloads(mode, seed):
    caps = Caps(**SMALL_CAPS)
    node, batch, _t = encode(caps, *random_workload(seed))
    port = run_port(caps, node, batch, mode)
    assert_same(port, run_jax(caps, node, batch, mode), mode, f"seed={seed}")


@pytest.mark.parametrize("mode", ["scan", "wave"])
def test_no_feasible_node(mode):
    """Pods no node can take (too large, a selector no node matches, a
    pin to a node that cannot hold them) stay -1 and commit nothing;
    the pods around them place as JAX places them."""
    t = port_testing
    caps = Caps(**SMALL_CAPS)
    nodes = [t.make_node(f"n{i}").capacity(cpu="2", mem="4Gi").build()
             for i in range(4)]
    big = t.make_pod("big").req(cpu="8").build()
    picky = t.make_pod("picky").req(cpu="100m").build()
    picky["spec"]["nodeSelector"] = {"disk": "ssd"}
    pinned = t.make_pod("pinned").req(cpu="3").node("n2").build()
    pods = ([t.make_pod("a").req(cpu="500m").build(), big, picky, pinned]
            + [t.make_pod(f"b{i}").req(cpu="900m", mem="1Gi").build()
               for i in range(4)])
    node, batch, _t = encode(caps, nodes, pods)
    port = run_port(caps, node, batch, mode)
    assert_same(port, run_jax(caps, node, batch, mode), mode)
    assert (port["assignments"][1:4] == -1).all()
    assert (port["assignments"][[0, 4, 5, 6, 7]] >= 0).all()


@pytest.mark.parametrize("mode", ["scan", "wave"])
def test_fills_nodes_to_maxpods(mode):
    """Three nodes of two pods each and ten small pods: six place, the
    pod cap stops the rest."""
    t = port_testing
    caps = Caps(**SMALL_CAPS)
    nodes = [t.make_node(f"n{i}").capacity(cpu="8", mem="16Gi", pods=2)
             .build() for i in range(3)]
    pods = [t.make_pod(f"p{i}").req(cpu="100m", mem="64Mi").build()
            for i in range(10)]
    node, batch, _t = encode(caps, nodes, pods)
    port = run_port(caps, node, batch, mode)
    assert_same(port, run_jax(caps, node, batch, mode), mode)
    assert int((port["assignments"] >= 0).sum()) == 6
    np.testing.assert_array_equal(port["npods"][:3], [2.0, 2.0, 2.0])


def test_mirrored_nodes_take_the_fused_sum_of_squares():
    """Two nodes whose cpu and memory utilizations are each other's
    (1/52 and 1/3 after the pod): their scores are equal on paper, and
    only XLA's fma(d1, d1, d0*d0) under the balanced score's sqrt breaks
    the tie, towards the second node (R12).  Unfused, the first would
    win."""
    t = port_testing
    caps = Caps(**SMALL_CAPS)
    nodes = [t.make_node("a").capacity(cpu="5200m", mem="384Mi").build(),
             t.make_node("b").capacity(cpu="300m", mem="6656Mi").build()]
    pods = [t.make_pod(f"p{i}").req(cpu="100m", mem="128Mi").build()
            for i in range(4)]
    node, batch, _t = encode(caps, nodes, pods)
    port = run_port(caps, node, batch, "scan")
    assert_same(port, run_jax(caps, node, batch, "scan"), "scan")
    np.testing.assert_array_equal(port["assignments"], [1, 0, 1, 0])


@pytest.mark.parametrize("name", ["every_kind", "spread_hard_tail",
                                  "mixed_patched"])
def test_wave_is_the_one_shard_sharded_form(name):
    """The snapshot wave runs the step the sharded snapshot form runs on
    a one-shard mesh: the same answers, waves and aggregates."""
    caps, node, batch = case_inputs(name)
    want = mesh.build_sharded_assign_fn(
        caps, mesh.make_mesh("cpu"), batch.p_cap)(node, batch)
    got = run_port(caps, node, batch, "wave")
    for k in WAVE_KEYS:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)


def test_snapshot_leaves_its_inputs_alone():
    caps, node, batch = case_inputs("every_kind")
    before = {k: np.array(v, copy=True) for k, v in node.items()}
    tensors = {k: torch.as_tensor(v) for k, v in node.items()}
    for mode in ("scan", "wave"):
        run_port(caps, node, batch, mode)
        run_port(caps, tensors, batch, mode)
    for k, v in before.items():
        np.testing.assert_array_equal(node[k], v, err_msg=k)
        np.testing.assert_array_equal(tensors[k].numpy(), v, err_msg=k)


def test_bad_arguments_raise():
    caps, node, batch = case_inputs("selectors")
    with pytest.raises(ValueError, match="mode"):
        assign.build_assign_fn(caps, mode="auction", device="cpu")
    fn = assign.build_assign_fn(caps, device="cpu", p_cap=batch.p_cap + 1)
    with pytest.raises(ValueError, match="slots"):
        fn(node, batch)
