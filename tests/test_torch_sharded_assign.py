"""The port's sharded step (parallel/mesh.py, models/assign.py _Comm)
held against the JAX package's on the CPU.

JAX runs on its 8 virtual CPU devices (tests/conftest.py); the port on a
mesh of eight CPU shards (make_mesh("cpu", shards=8)), where the
collectives are torch operations on the shards' lists.  The same cluster,
encoded by the port's flatten copy, goes through JAX's
build_sharded_assign_fn / build_sharded_step_fn and the port's: the
assignments and every aggregate (used, used_nz, npods, port_mask, cd_sg,
cd_asg) must be equal, bit for bit.  The port's sharded step on one shard
and on several must also equal its single-device step at murmur noise
(the sharded path's rule, quirk R3).  Mirrors
tests/test_sharded_assign.py:79-215.
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
from kubernetes_tpu_torch.models.assign import _Comm  # noqa: E402
from kubernetes_tpu_torch.models.carry import (  # noqa: E402
    state_from_reference, state_to_numpy,
)
from kubernetes_tpu_torch.ops.flatten import (  # noqa: E402
    BatchEncoder, Caps, ClusterTensors,
)
from kubernetes_tpu_torch.parallel import census, mesh  # noqa: E402
from kubernetes_tpu_torch.scheduler.cache import Cache, Snapshot  # noqa: E402
from kubernetes_tpu_torch.scheduler.types import PodInfo  # noqa: E402
from torch_cases import (  # noqa: E402
    FULL_CASES, K_CAP, STEP_CASES, make_full_case, make_step_case,
    step_patches,
)

AGG = ("used", "used_nz", "npods", "port_mask", "cd_sg", "cd_asg")
CAPS = dict(n_cap=32, l_cap=64, kl_cap=32, t_cap=8, pt_cap=8, s_cap=2,
            sg_cap=8, asg_cap=8)


def make_node(name, zone, cpu, mem):
    return (port_testing.make_node(name).zone(zone)
            .labels(**{"kubernetes.io/hostname": name})
            .capacity(cpu=cpu, mem=mem).build())


def workload():
    """tests/test_sharded_assign.py's workload: 16 nodes in two zones,
    zone spread, hostname anti-affinity and plain pods."""
    nodes = ([make_node(f"a{i}", "a", "2", "4Gi") for i in range(8)]
             + [make_node(f"b{i}", "b", "2", "4Gi") for i in range(8)])
    mk = port_testing.make_pod
    pods = (
        [mk(f"web{i}").labels(app="web").req(cpu="500m", mem="512Mi")
         .topology_spread("topology.kubernetes.io/zone", max_skew=1,
                          match_labels={"app": "web"}).build()
         for i in range(6)]
        + [mk(f"solo{i}").labels(app="solo").req(cpu="250m")
           .pod_affinity("kubernetes.io/hostname", {"app": "solo"}, anti=True)
           .build() for i in range(4)]
        + [mk(f"plain{i}").req(cpu="100m", mem="128Mi").build()
           for i in range(6)])
    return nodes, pods


def random_workload(seed, n_nodes=16, n_pods=32):
    """tests/test_sharded_assign.py's seeded cluster and constraint-mixed
    pod batch (the same draws from the same seed)."""
    import random as _random
    rng = _random.Random(seed)
    zones = ["a", "b", "c"][:rng.randint(2, 3)]
    nodes = []
    for i in range(n_nodes):
        z = zones[i % len(zones)]
        nodes.append(make_node(f"{z}{i}", z, str(rng.choice([1, 2, 4])),
                               f"{rng.choice([2, 4, 8])}Gi"))
    mk = port_testing.make_pod
    pods = []
    for i in range(n_pods):
        kind = rng.choice(["spread", "anti", "affinity", "plain", "plain"])
        cpu = f"{rng.choice([100, 250, 500])}m"
        mem = f"{rng.choice([64, 128, 256])}Mi"
        if kind == "spread":
            pods.append(mk(f"sp{i}").labels(app=f"web{i % 3}")
                        .req(cpu=cpu, mem=mem)
                        .topology_spread("topology.kubernetes.io/zone",
                                         max_skew=rng.randint(1, 2),
                                         match_labels={"app": f"web{i % 3}"})
                        .build())
        elif kind == "anti":
            pods.append(mk(f"an{i}").labels(app=f"solo{i % 2}").req(cpu=cpu)
                        .pod_affinity("kubernetes.io/hostname",
                                      {"app": f"solo{i % 2}"}, anti=True)
                        .build())
        elif kind == "affinity":
            pods.append(mk(f"af{i}").labels(app="pair").req(cpu=cpu, mem=mem)
                        .pod_affinity("topology.kubernetes.io/zone",
                                      {"app": "pair"}).build())
        else:
            pods.append(mk(f"pl{i}").req(cpu=cpu, mem=mem).build())
    rng.shuffle(pods)
    return nodes, pods


def encode(caps, nodes, pods, batch_size):
    """(tensors, whole node arrays, PodBatch) from the port's flatten."""
    cache = Cache()
    for n in nodes:
        cache.add_node(n)
    t = ClusterTensors(caps)
    t.update_from_snapshot(cache.update_snapshot(Snapshot()))
    batch = BatchEncoder(t, batch_size).encode([PodInfo(p) for p in pods])
    assert not batch.escape
    cd_sg, cd_asg = t.domain_base_counts()
    node = {k: getattr(t, k).copy() for k in mesh.NODE_KEYS
            if k not in ("cd_sg", "cd_asg")}
    node.update(cd_sg=cd_sg, cd_asg=cd_asg)
    return t, node, batch


_JAX_FNS = {}


def run_jax(caps, node, batch, devices=None):
    """JAX's sharded assignment, compiled once per (caps, mesh, TAIL_P):
    the cases vary only the data, as in tests/test_sharded_assign.py."""
    jcaps = JaxCaps(**vars(caps))
    key = (tuple(sorted(vars(caps).items())), len(devices or jax.devices()),
           jax_assign.TAIL_P, batch.p_cap)
    if key not in _JAX_FNS:
        _JAX_FNS[key] = jax_mesh.build_sharded_assign_fn(
            jcaps, jax_mesh.make_mesh(devices))
    fn = _JAX_FNS[key]
    pods = {k: jnp.asarray(v) for k, v in batch.materialized(
        jcaps, tuple(jax_mesh.pod_specs())).items()}
    out = fn({k: jnp.asarray(v) for k, v in node.items()}, pods)
    return {k: np.asarray(v) for k, v in out.items()}


def run_port(caps, node, batch, shards):
    fn = mesh.build_sharded_assign_fn(caps, mesh.make_mesh("cpu", shards),
                                      batch.p_cap)
    return fn(node, batch)


def assert_same(port, ref, what=""):
    np.testing.assert_array_equal(port["assignments"], ref["assignments"],
                                  err_msg=f"assignments {what}")
    assert int(port["waves"]) == int(ref["waves"]), what
    for k in AGG:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=f"{k} {what}")


@pytest.fixture(scope="module")
def caps():
    return Caps(**CAPS)


def test_eight_shards_match_the_jax_mesh(caps):
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    t, node, batch = encode(caps, *workload(), 16)
    port = run_port(caps, node, batch, 8)
    assert_same(port, run_jax(caps, node, batch))
    # and the constraints hold (test_sharded_respects_constraints)
    names = [t.node_name(r) if r >= 0 else None for r in port["assignments"]]
    solo = names[6:10]
    assert None not in solo and len(set(solo)) == 4
    zones = [n[0] for n in names[:6]]
    assert zones.count("a") == 3 and zones.count("b") == 3


@pytest.mark.parametrize("seed", range(6))
def test_seeded_parity(caps, seed):
    _t, node, batch = encode(caps, *random_workload(seed), 32)
    port = run_port(caps, node, batch, 8)
    assert_same(port, run_jax(caps, node, batch), f"seed={seed}")
    assert (port["assignments"] >= 0).any()


@pytest.mark.parametrize("seed", range(3))
def test_tail_compaction_parity(caps, seed, monkeypatch):
    """JAX's compacted-tail waves forced (TAIL_P < P): the port's full
    variant compacts every wave, and the answers stay equal."""
    monkeypatch.setattr(jax_assign, "TAIL_P", 16)
    monkeypatch.setattr(assign, "TAIL_P", 16)
    _t, node, batch = encode(caps, *random_workload(seed, n_nodes=8), 32)
    assert_same(run_port(caps, node, batch, 8),
                run_jax(caps, node, batch), f"seed={seed}")


@pytest.mark.parametrize("seed", range(2))
def test_three_shards_with_a_rounded_n_cap(seed):
    """A mesh that does not divide n_cap=32: n_cap rounds to 33, and the
    padding row (valid 0, maxpods 0) never wins."""
    caps = census.round_caps_to_mesh(Caps(**CAPS), 3)
    assert caps.n_cap == 33
    _t, node, batch = encode(caps, *random_workload(seed, n_nodes=30), 32)
    port = run_port(caps, node, batch, 3)
    assert_same(port, run_jax(caps, node, batch, jax.devices()[:3]),
                f"seed={seed}")
    assert not (port["assignments"] >= 30).any()
    assert port["npods"][30:].sum() == 0


def jax_step_inputs(caps, state, static, b, P, patches):
    """JAX build_sharded_step_fn's (state, static, pods, prows, pvals)
    for a plain step case: the pod fields the plain variant does not
    read are zeros."""
    from kubernetes_tpu.parallel.census import abstract_step_inputs
    _st, _sta, pods_abs, _pr, _pv = abstract_step_inputs(
        JaxCaps(**vars(caps)), P, K_CAP)
    pods = {k: np.zeros(v.shape, v.dtype) for k, v in pods_abs.items()}
    pods.update(req=b.req, req_nz=b.req_nz, p_valid=b.p_valid,
                untol_hard=b.untol_hard)
    pods["node_row"] = np.full(P, -1, np.int32)
    full_static = {k: np.zeros(v.shape, v.dtype) for k, v in _sta.items()}
    full_static.update(static)
    prows = np.full(K_CAP, -1, np.int32)
    pvals = np.zeros((K_CAP, 2 * caps.r + 1 + caps.pt_cap), np.float32)
    if patches:
        rows, vals = step_patches(caps)
        prows[:len(rows)] = rows
        pvals[:len(rows)] = vals
    return ({k: jnp.asarray(v) for k, v in state.items()},
            {k: jnp.asarray(v) for k, v in full_static.items()},
            {k: jnp.asarray(v) for k, v in pods.items()},
            jnp.asarray(prows), jnp.asarray(pvals))


def port_plain_buf(caps, b, P, patches):
    spec = assign.PackSpec(caps, P, K_CAP, plain=True)
    rows, vals = step_patches(caps) if patches else (None, None)
    return torch.from_numpy(assign.pack_pod_batch(b, spec, rows, vals))


def port_sharded_step(caps, state, static, buf, P, shards, features):
    m = mesh.make_mesh("cpu", shards)
    step = mesh.build_sharded_step_fn(caps, m, P, k_cap=K_CAP,
                                      features=features)
    arrays = {**{k: v for k, v in state.items()}, **static}
    placed = mesh.split_arrays(arrays, m)
    st = {k: placed[k] for k in mesh.STATE_KEYS}
    stat = {k: placed[k] for k in static}
    st, a, waves, gen = step(st, stat, buf)
    out = mesh.gather_arrays({k: st[k] for k in AGG})
    out.update(assignments=a.numpy(), waves=int(waves), gen=int(gen))
    return out


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_plain_step_matches_the_jax_sharded_step(name, monkeypatch):
    """The plain variant (the claims kernel's plain version per shard at
    its node offset) against JAX's sharded plain step, row patches and the
    compacted tail (TAIL_P lowered to 16) included."""
    monkeypatch.setattr(jax_assign, "TAIL_P", 16)
    monkeypatch.setattr(assign, "TAIL_P", 16)
    n_cap, P, identical, seed, patches = STEP_CASES[name]
    caps, state, static, b = make_step_case(n_cap, min(P, 64), identical,
                                            seed)
    P = b.req.shape[0]
    jfn = jax_mesh.build_sharded_step_fn(
        JaxCaps(**vars(caps)), jax_mesh.make_mesh(), k_cap=K_CAP,
        features=jax_assign.PLAIN_FEATURES)
    jst, ja, jw, jg = jfn(*jax_step_inputs(caps, state, static, b, P,
                                           patches))
    port = port_sharded_step(caps, state, static,
                             port_plain_buf(caps, b, P, patches), P, 8,
                             assign.PLAIN_FEATURES)
    np.testing.assert_array_equal(port["assignments"], np.asarray(ja))
    assert port["waves"] == int(jw) and port["gen"] == int(jg)
    for k in AGG:
        np.testing.assert_array_equal(port[k], np.asarray(jst[k]), err_msg=k)
    assert (port["assignments"] >= 0).any()


def single_device(caps, state, static, buf, P, features):
    fn, _spec = assign.build_packed_assign_fn(
        caps, P, K_CAP, features=features, max_waves=assign.MAX_WAVES,
        claims_noise="murmur", device="cpu")
    st, stat = state_from_reference(state, static, "cpu")
    st, res = fn(st, stat, buf)
    out, _ = state_to_numpy(st)
    res = res.numpy()
    out.update(assignments=res[:-2], waves=int(res[-2]), gen=int(res[-1]))
    return out


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_plain_sharded_step_equals_single_device(name, shards):
    n_cap, P, identical, seed, patches = STEP_CASES[name]
    caps, state, static, b = make_step_case(n_cap, P, identical, seed)
    buf = port_plain_buf(caps, b, P, patches)
    want = single_device(caps, state, static, buf, P, assign.PLAIN_FEATURES)
    got = port_sharded_step(caps, state, static, buf, P, shards,
                            assign.PLAIN_FEATURES)
    for k in ("assignments", "waves", "gen") + AGG:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("shards", [1, 8])
@pytest.mark.parametrize("name", sorted(FULL_CASES))
def test_full_sharded_step_equals_single_device(name, shards):
    caps, state, static, batch, patches = make_full_case(name)
    P = batch.p_cap
    rows, vals = patches if patches else (None, None)
    buf = torch.from_numpy(assign.pack_pod_batch(
        batch, assign.PackSpec(caps, P, K_CAP), rows, vals))
    want = single_device(caps, state, static, buf, P, assign.ALL_FEATURES)
    got = port_sharded_step(caps, state, static, buf, P, shards,
                            assign.ALL_FEATURES)
    for k in ("assignments", "waves", "gen") + AGG:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -- the collectives --------------------------------------------------------

def comm_case(S, n_loc=6, rows=8, H=10, seed=0):
    rng = np.random.default_rng(seed)
    comm = _Comm(["cpu"] * S, n_loc)
    whole = rng.integers(-1, 5, (rows, S * n_loc)).astype(np.int32)
    arrs = [torch.from_numpy(whole[:, s * n_loc:(s + 1) * n_loc].copy())
            for s in range(S)]
    gidx = torch.from_numpy(rng.integers(-1, S * n_loc, H))
    return comm, whole, arrs, [gidx] * S, gidx.numpy()


@pytest.mark.parametrize("fill", [0.0, -1.0])
def test_gather_cols_rs_is_the_slab_of_gather_cols(fill):
    S = 4
    comm, whole, arrs, gidx, g = comm_case(S)
    want = np.where(g >= 0, whole[:, np.clip(g, 0, None)], int(fill))
    full = comm.gather_cols(arrs, gidx, fill)
    for s in range(S):
        np.testing.assert_array_equal(full[s].numpy(), want)
    ar_bytes = comm.counts["call"]["all-reduce"]
    comm.reset_counts()
    slabs = comm.gather_cols_rs(arrs, gidx, fill)
    w = whole.shape[0] // S
    for s in range(S):
        np.testing.assert_array_equal(slabs[s].numpy(),
                                      want[s * w:(s + 1) * w])
    rs = comm.counts["call"]
    assert rs["reduce-scatter"] * S == want.nbytes
    # the all-reduce form's result bytes (its fill's [H] flags aside)
    fill_flags = (g.size * 4) if fill else 0
    assert ar_bytes - fill_flags == want.nbytes
    assert rs["reduce-scatter"] * S == ar_bytes - fill_flags


def test_one_shard_comm_is_the_identity():
    comm, whole, arrs, gidx, g = comm_case(1)
    x = [torch.arange(5.0)]
    m = [torch.tensor([[True, False], [False, True]])]
    v = [torch.tensor([[3.0, 1.0], [2.0, 7.0]])]
    assert comm.psum(x)[0] is x[0]
    assert comm.all_gather(x)[0] is x[0]
    assert comm.bcast(x[0])[0] is x[0]
    idx, best = comm.row_argmax(x, [torch.arange(5)])
    assert idx[0].tolist() == list(range(5)) and best[0] is x[0]
    np.testing.assert_array_equal(comm.rowmax(v, m, 0.0)[0].numpy(),
                                  [[3.0], [7.0]])
    np.testing.assert_array_equal(comm.any_rows(m)[0].numpy(), [True, True])
    np.testing.assert_array_equal(
        comm.gather_cols_rs(arrs, gidx, -1)[0].numpy(),
        np.where(g >= 0, whole[:, np.clip(g, 0, None)], -1))
    assert not any(comm.counts["call"].values())
    assert comm.slabs(7) == [(0, 0, 7)]


def test_row_argmax_takes_the_first_shard_among_equal_bests():
    comm = _Comm(["cpu"] * 3, 10)
    bests = [torch.tensor([1.0, 5.0, -1e9]), torch.tensor([2.0, 5.0, -1e9]),
             torch.tensor([2.0, 4.0, -1e9])]
    idxs = [torch.tensor([3, 7, -1]), torch.tensor([1, 2, -1]),
            torch.tensor([0, 9, -1])]
    j, best = comm.row_argmax(bests, idxs)
    assert j[0].tolist() == [11, 7, -1]
    assert best[0].tolist() == [2.0, 5.0, -1e9]
    assert comm.counts["call"]["all-gather calls"] == 2


def test_collective_record_is_the_jax_census_shape():
    counts = {"call": {"broadcast": 40, "broadcast calls": 2},
              "wave": {"all-reduce": 64, "all-reduce calls": 4,
                       "all-gather": 0, "all-gather calls": 0}}
    rec = census.collective_record(counts, waves=2)
    assert rec["per_wave_bytes"] == 32 and rec["per_call_bytes"] == 40
    ar = rec["collectives"]["all-reduce (wave)"]
    assert ar == {"op": "all-reduce", "count": 2.0, "bytes": 16.0,
                  "per_wave": True}
    assert ar["count"] * ar["bytes"] == rec["per_wave_bytes"]


def test_partition_rules_are_exhaustive():
    specs = mesh.node_specs()
    assert specs["used"] == (mesh.NODE_AXIS, None)
    assert specs["dom_sg"] == (None, mesh.NODE_AXIS)
    assert specs["cd_sg"] == () and mesh.state_specs()["gen"] == ()
    with pytest.raises(ValueError, match="no partition rule"):
        mesh.match_partition_rules(mesh.NODE_PARTITION_RULES, ["mystery"])
    m = mesh.make_mesh("cpu", shards=4)
    arrays = {"used": np.arange(16.0).reshape(8, 2),
              "dom_sg": np.arange(16).reshape(2, 8),
              "cd_sg": np.ones((2, 8), np.float32)}
    placed = mesh.split_arrays(arrays, m)
    assert [p.shape for p in placed["dom_sg"]] == [(2, 2)] * 4
    back = mesh.gather_arrays(placed)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v)
    with pytest.raises(ValueError, match="divide"):
        mesh.split_arrays({"npods": np.zeros(6)}, m)
