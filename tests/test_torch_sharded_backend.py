"""ShardedTorchBatchBackend (parallel/backend.py) against the JAX
package's ShardedTPUBatchBackend, on the CPU.

JAX runs on its 8 virtual CPU devices (tests/conftest.py), the port on a
mesh of eight CPU shards.  Each scenario runs once per package on the same
cluster and pods, and the per-pod (node, status code) lists must be equal;
the JAX tests' own checks are held on the port's answers too.  Mirrors
tests/test_sharded_backend.py:16 (the Scheduler end to end on a mesh:
spec.nodeName and the PodScheduled reason per pod, against the JAX
Scheduler) and tests/test_sharded_stress.py:41-201 (domains split across
shards, cross-shard anti-affinity, FLUSH_FIRST under node churn, external
writers on the patch path, the pipelined epoch skip, and placement parity
with the single-device backend).
"""

import pytest

pytest.importorskip("jax")

import kubernetes_tpu.scheduler.cache as jax_cache  # noqa: E402
import kubernetes_tpu.scheduler.types as jax_types  # noqa: E402
from kubernetes_tpu import testing as jax_testing  # noqa: E402
from kubernetes_tpu.ops import backend as jax_backend  # noqa: E402
from kubernetes_tpu.ops.flatten import Caps as JaxCaps  # noqa: E402
from kubernetes_tpu.parallel.backend import ShardedTPUBatchBackend  # noqa: E402
from kubernetes_tpu_torch.ops import backend as port_backend  # noqa: E402
from kubernetes_tpu_torch.ops.flatten import Caps  # noqa: E402
from kubernetes_tpu_torch.parallel.backend import (  # noqa: E402
    ShardedTorchBatchBackend,
)
from kubernetes_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from torch_cases import (  # noqa: E402
    PORT_PKG, Side, Stack, outcome, port_cache, port_testing, port_types,
)

CAPS = dict(l_cap=64, kl_cap=32, t_cap=8, pt_cap=8, s_cap=2, sg_cap=16,
            asg_cap=16)
ZONES = "zabcdefgh"


def side(pkg, n_cap, batch):
    caps = dict(CAPS, n_cap=n_cap)
    if pkg == "jax":
        return Side(jax_cache, jax_types, jax_testing,
                    ShardedTPUBatchBackend(JaxCaps(**caps), batch_size=batch),
                    jax_backend.FLUSH_FIRST)
    return Side(port_cache, port_types, port_testing,
                ShardedTorchBatchBackend(Caps(**caps), batch_size=batch,
                                         mesh=make_mesh("cpu", shards=8)),
                port_backend.FLUSH_FIRST)


def build_cluster(s, n_nodes, zones=4, cpu="8", mem="32Gi"):
    """Nodes round-robin over zones: consecutive rows land on the SAME
    shard (contiguous slabs), so a zone's members span every shard."""
    for i in range(n_nodes):
        s.cache.add_node(s.testing.make_node(f"s{i}").zone(ZONES[i % zones])
                         .labels(**{"kubernetes.io/hostname": f"s{i}"})
                         .capacity(cpu=cpu, mem=mem).build())
    return s.snapshot()


def spread_pod(s, name):
    return (s.testing.make_pod(name).labels(app="web").req(cpu="100m")
            .topology_spread("topology.kubernetes.io/zone", max_skew=1,
                             match_labels={"app": "web"}).build())


def anti_pod(s, name):
    return (s.testing.make_pod(name).labels(app="solo").req(cpu="100m")
            .pod_affinity("kubernetes.io/hostname", {"app": "solo"},
                          anti=True).build())


def per_zone(names):
    out = {}
    for nm in names:
        zone = ZONES[int(nm[1:]) % 4]
        out[zone] = out.get(zone, 0) + 1
    return out


def both(scenario, n_cap, batch):
    """The scenario's outcomes (a list of per-batch outcome lists) on each
    package: (port's, JAX's), asserted equal."""
    port = scenario(side("port", n_cap, batch))
    ref = scenario(side("jax", n_cap, batch))
    assert port == ref
    return port


def test_spread_across_shard_split_zones():
    """64 nodes / 4 zones / 8 shards: every zone spans every shard;
    maxSkew=1 over 32 pods stays balanced globally."""
    def run(s):
        snap = build_cluster(s, 64, zones=4)
        pods = [spread_pod(s, f"sp{i}") for i in range(32)]
        return [outcome(s.backend.assign(s.infos(pods), snap))]
    (got,) = both(run, 64, 32)
    names = [nm for nm, _code in got]
    assert all(names)
    zones = per_zone(names)
    assert max(zones.values()) - min(zones.values()) <= 1, zones


def test_anti_affinity_hostname_cross_shard():
    """One pod per hostname: with 24 nodes over 8 shards the anti-affinity
    self-conflicts hold across shard boundaries within one batch."""
    def run(s):
        snap = build_cluster(s, 24)
        pods = [anti_pod(s, f"aa{i}") for i in range(24)]
        return [outcome(s.backend.assign(s.infos(pods), snap))]
    (got,) = both(run, 24, 24)
    names = [nm for nm, _code in got]
    assert all(names) and len(set(names)) == 24


def test_anti_affinity_saturation_rejects_the_rest():
    """More anti-affinity pods than hosts: exactly n_nodes place."""
    def run(s):
        snap = build_cluster(s, 16)
        pods = [anti_pod(s, f"ov{i}") for i in range(24)]
        return [outcome(s.backend.assign(s.infos(pods), snap))]
    (got,) = both(run, 16, 24)
    names = [nm for nm, _code in got if nm]
    assert len(names) == 16 and len(set(names)) == 16


def test_spread_state_persists_across_batches():
    """Domain counts committed by batch k constrain batch k+1: the
    replicated count tables stay coherent with the sharded node state."""
    def run(s):
        snap = build_cluster(s, 64, zones=4)
        return [outcome(s.backend.assign(
            s.infos([spread_pod(s, f"b{r}-{i}") for i in range(16)]), snap))
            for r in range(4)]
    got = both(run, 64, 16)
    names = [nm for batch in got for nm, _code in batch]
    assert all(names)
    zones = per_zone(names)
    assert max(zones.values()) - min(zones.values()) <= 1, zones


def test_flush_first_under_node_churn():
    """A node appears while batch k is in flight: the next dispatch
    refuses (FLUSH_FIRST), then succeeds after k resolves, and the new
    node is used."""
    def run(s):
        s.backend.warmup()
        snap = build_cluster(s, 8, cpu="2")

        def pods(tag):
            return s.infos([s.testing.make_pod(f"{tag}{i}").req(cpu="1")
                            .build() for i in range(8)])
        resolve1 = s.backend.dispatch(pods("k"), snap)
        assert resolve1 is not s.flush_first
        s.cache.add_node(s.testing.make_node("late-node")
                         .capacity(cpu="64", mem="64Gi").build())
        snap2 = s.snapshot()
        assert s.backend.dispatch(pods("j"), snap2) is s.flush_first
        assert s.backend.stats["flush_first"] >= 1
        first = outcome(resolve1())
        resolve2 = s.backend.dispatch(pods("j"), snap2)
        assert resolve2 is not s.flush_first
        return [first, outcome(resolve2())]
    first, second = both(run, 32, 8)
    assert all(nm for nm, _code in first)
    assert [nm for nm, _code in second].count("late-node") == 8


def test_external_writer_rides_the_patch_path():
    """Another writer binds pods onto a node between batches: the diff
    lands as row patches (no full refresh) and the step sees the reduced
    capacity."""
    def run(s):
        snap = build_cluster(s, 4, cpu="2")
        w0 = outcome(s.backend.assign(
            s.infos([s.testing.make_pod("w0").req(cpu="100m").build()]),
            snap))
        refreshes = s.backend.stats["full_refresh"]
        for i in range(2):
            s.cache.add_pod(s.testing.make_pod(f"ext{i}").req(cpu="1")
                            .node("s0").build())
        got = outcome(s.backend.assign(
            s.infos([s.testing.make_pod(f"w1-{i}").req(cpu="1").build()
                     for i in range(4)]), s.snapshot()))
        assert s.backend.stats["full_refresh"] == refreshes
        assert s.backend.stats["patched_rows"] >= 1
        return [w0, got]
    _w0, got = both(run, 32, 4)
    names = [nm for nm, _code in got]
    assert all(names) and "s0" not in names


def test_pipelined_epoch_skip_no_patches():
    """Back-to-back batches with no external change ride the epoch fast
    path: no patches and no refresh after the first."""
    def run(s):
        snap = build_cluster(s, 8)
        out = [outcome(s.backend.assign(
            s.infos([s.testing.make_pod("e0").req(cpu="100m").build()]),
            snap))]
        refreshes = s.backend.stats["full_refresh"]
        patched = s.backend.stats["patched_rows"]
        for r in range(3):
            out.append(outcome(s.backend.assign(
                s.infos([s.testing.make_pod(f"e{r}-{i}").req(cpu="100m")
                         .build() for i in range(8)]), snap)))
        assert s.backend.stats["full_refresh"] == refreshes
        assert s.backend.stats["patched_rows"] == patched
        return out
    got = both(run, 32, 8)
    assert all(nm for batch in got for nm, _code in batch)


def test_constraint_workload_matches_the_single_device_backend():
    """The same mixed constraint workload through the sharded backend and
    TorchBatchBackend at murmur noise (its full variant at the batch
    size): identical placements, the sharded step being the same math."""
    def pods(s):
        out = []
        for i in range(24):
            w = s.testing.make_pod(f"px{i}").req(cpu="200m")
            if i % 3 == 0:
                w = w.labels(app="web").topology_spread(
                    "topology.kubernetes.io/zone", max_skew=1,
                    match_labels={"app": "web"})
            elif i % 3 == 1:
                w = w.labels(app="db").pod_affinity(
                    "kubernetes.io/hostname", {"app": "db"}, anti=True)
            out.append(w.build())
        return out
    sharded = side("port", 32, 24)
    single = Side(port_cache, port_types, port_testing,
                  port_backend.TorchBatchBackend(
                      Caps(**CAPS, n_cap=32), batch_size=24, device="cpu",
                      claims_noise="murmur", full_batch_cap=24),
                  port_backend.FLUSH_FIRST)
    got = []
    for s in (sharded, single):
        snap = build_cluster(s, 32, zones=4)
        got.append(outcome(s.backend.assign(s.infos(pods(s)), snap)))
    assert got[0] == got[1]
    assert all(nm for nm, _code in got[0])


def sharded_stack(pkg, batch):
    """torch_cases.Stack with the package's sharded backend."""
    caps = dict(CAPS, n_cap=64)
    if pkg == PORT_PKG:
        backend = ShardedTorchBatchBackend(
            Caps(**caps), batch_size=batch, mesh=make_mesh("cpu", shards=8))
    else:
        backend = ShardedTPUBatchBackend(JaxCaps(**caps), batch_size=batch)
    return Stack(pkg, batch, caps=caps, backend=backend)


def test_scheduler_end_to_end_on_the_mesh_matches_jax():
    """The Scheduler over the sharded backend (store -> informers -> queue
    -> the sharded step -> assume -> bind), batches popped in turn: the
    port binds every pod where the JAX Scheduler does, within capacity, and
    an infeasible pod comes back Unschedulable through the same path."""
    def nodes(testing):
        return [testing.make_node(f"mesh-{i}").zone("abc"[i % 3])
                .capacity(cpu="8", mem="32Gi").build() for i in range(24)]

    def pods(testing):
        return ([testing.make_pod(f"mp{i:02d}").req(cpu="500m", mem="512Mi")
                 .build() for i in range(40)]
                + [testing.make_pod("mp-huge").req(cpu="64").build()])
    out = {}
    for pkg in (PORT_PKG, "kubernetes_tpu"):
        s = sharded_stack(pkg, 16)
        try:
            left = s.load(nodes, pods)
            while left:
                n = min(16, left)
                s.schedule_all(n)
                left -= n
        finally:
            s.stop()
        out[pkg] = s.outcome()
    assert out[PORT_PKG] == out["kubernetes_tpu"]
    port = out[PORT_PKG]
    assert port["mp-huge"] == (None, "Unschedulable")
    placed = [nm for name, (nm, _r) in port.items() if name != "mp-huge"]
    assert all(placed)
    assert max(placed.count(n) for n in set(placed)) <= 16


def test_census_counts_a_waves_collectives_and_leaves_the_backend_alone():
    """device_census on 8 CPU shards: one step of each variant on a clone
    (the state, _gen and the launch count unchanged), and the plain wave's
    collective bytes by kind, one shard's result each as the JAX census
    counts them: all-reduce of the claim flags (int32 [P]), the claimed
    nodes' free capacity (f32 [R, P]), pod counts and caps (f32 [P]);
    all-gather of the shards' bests and indices ([8, P] each); broadcast of
    the active and accepted pods to the shards."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.parallel.mesh import gather_arrays
    s = side("port", 64, 32)
    snap = build_cluster(s, 64)
    b = s.backend
    b.warmup()
    b.assign(s.infos([s.testing.make_pod(f"c{i}").req(cpu="100m").build()
                      for i in range(32)]), snap)
    before = gather_arrays({k: v for k, v in b._state.items()})
    gen, launches = b._gen, dict(kernels.LAUNCHES)
    census = b.device_census()
    after = gather_arrays({k: v for k, v in b._state.items()})
    assert b._gen == gen and kernels.LAUNCHES == launches
    for k, v in before.items():
        assert (after[k] == v).all(), k
    assert set(census) == {"full", "plain"}
    plain = census["plain"]
    P, R = 32, b.caps.r
    per_wave = {r["op"]: r["bytes"] * r["count"]
                for r in plain["collectives"].values() if r["per_wave"]}
    assert plain["waves"] == 1 and plain["mesh_devices"] == 8
    assert per_wave == {"all-reduce": 4 * P + 4 * R * P + 2 * 4 * P,
                        "all-gather": 2 * 4 * 8 * P,
                        "broadcast": P + 4 * P}
    assert plain["per_wave_bytes"] == sum(per_wave.values())
    assert census["full"]["per_wave_bytes"] > 0


def test_warm_start_resumes_the_stream(tmp_path):
    """checkpoint_mirror on a sharded backend after one batch, warm_start
    of a fresh one (on another mesh) from the file and a cache primed with
    its objects: every row adopted, and the next batch placed as the
    uninterrupted backend places it."""
    a = side("port", 32, 16)
    nodes = [a.testing.make_node(f"w{i}").zone(ZONES[i % 4])
             .capacity(cpu="4", mem="8Gi").build() for i in range(24)]
    for n in nodes:
        a.cache.add_node(n)

    def pods(tag):
        return [a.testing.make_pod(f"{tag}{i}").req(cpu="300m", mem="256Mi")
                .build() for i in range(16)]
    first = pods("f")
    bound = []
    for pod, (name, _st) in zip(first, a.backend.assign(a.infos(first),
                                                        a.snapshot())):
        assert name
        bound.append({**pod, "spec": {**pod["spec"], "nodeName": name}})
        a.cache.add_pod(bound[-1])
    path = str(tmp_path / "sharded.ckpt")
    info = a.backend.checkpoint_mirror(
        path, snapshot=a.cache.flatten_view(),
        resource_versions={"nodes": 1, "pods": 1},
        objects={"nodes": nodes, "pods": bound})
    b = ShardedTorchBatchBackend(Caps(**CAPS, n_cap=32), batch_size=16,
                                 mesh=make_mesh("cpu", shards=4))
    warm = b.warm_start(path)
    assert warm["nodes"] == info["nodes"] == 24
    assert warm["lineage"] == "sharded"
    cache_b = port_cache.Cache()
    for n in warm["objects"]["nodes"]:
        cache_b.add_node(n)
    for p in warm["objects"]["pods"]:
        cache_b.add_pod(p)
    assert b.warm_align(cache_b.flatten_view()) == 0
    assert b.stats.get("warm_adopted", 0) == 24
    second = pods("s")
    want = outcome(a.backend.assign(a.infos(second), a.snapshot()))
    got = outcome(b.assign(a.infos(second), cache_b.flatten_view()))
    assert got == want and all(n for n, _code in got)
