"""Backend-level parity of the full (constraint) variant: the JAX
package's TPUBatchBackend under KTPU_PALLAS=0 against the port's
TorchBatchBackend(device="cpu", claims_noise="murmur"), driven with the
same pod, node and namespace dicts through each package's own Cache and
PodInfo.  The (node, status code) lists must be identical on:

  * tests/test_tpu_batch.py's TestSelectorsAndTaints,
    TestTopologyAndAffinity, TestNamespaceSelectorTensors (relabel and
    delete included) and TestTailCompaction scenarios (the JAX side with
    TAIL_P cut to 2, so its compacted tail runs), and
    TestStragglerRetryKernel (JAX KTPU_FULL_MAIN_WAVES=2 and 3, the port
    full_main_waves the same: a capped main step, and at 2 the retry
    step);
  * a constraint batch larger than full_cap, which runs in chunks;
  * the non-pipelined churn streams of tests/test_churn_parity.py with
    constraint pods, seeds 7 and 23, each through its package's Cache.
"""

import copy
import random

import pytest

pytest.importorskip("jax")

from kubernetes_tpu.models import assign as jax_assign  # noqa: E402
from kubernetes_tpu.ops import backend as jax_backend  # noqa: E402
from kubernetes_tpu.ops.flatten import Caps as JaxCaps  # noqa: E402
import kubernetes_tpu_torch.scheduler.cache as port_cache  # noqa: E402
import kubernetes_tpu_torch.scheduler.types as port_types  # noqa: E402
from kubernetes_tpu_torch.api import meta as port_meta  # noqa: E402
from kubernetes_tpu_torch.ops import backend as port_backend  # noqa: E402
from kubernetes_tpu_torch.ops.flatten import Caps  # noqa: E402
from test_churn_parity import (  # noqa: E402
    build_ops, run_scenario, small_caps,
)
from test_torch_backend import jax_side  # noqa: E402
from torch_cases import CAPS, outcome, port_side  # noqa: E402

HOST = "kubernetes.io/hostname"
ZONE = "topology.kubernetes.io/zone"


@pytest.fixture(scope="module")
def jax_step_cache():
    """Share the JAX package's compiled steps across this module's
    backends: a step is a pure function of (state, static, buffer), so a
    backend may reuse another's compiled step of the same shape, weights,
    wave cap and TAIL_P."""
    real = jax_backend.build_packed_assign_fn
    built = {}

    def cached(caps, p_cap, k_cap=1024, weights=None, **kw):
        key = (tuple(sorted(vars(caps).items())), p_cap, k_cap,
               tuple(sorted((weights or {}).items())),
               tuple(sorted(kw.get("features", ()))),
               "features" in kw, kw.get("max_waves"), jax_assign.TAIL_P)
        if key not in built:
            built[key] = real(caps, p_cap, k_cap, weights, **kw)
        return built[key]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_backend, "build_packed_assign_fn", cached)
        yield


@pytest.fixture
def sides(monkeypatch, jax_step_cache):
    monkeypatch.setenv("KTPU_PALLAS", "0")

    def make(batch_size, caps=CAPS, main_waves=0, **kw):
        if main_waves:
            monkeypatch.setenv("KTPU_FULL_MAIN_WAVES", str(main_waves))
        j = jax_side(batch_size, caps, **kw)
        monkeypatch.delenv("KTPU_FULL_MAIN_WAVES", raising=False)
        return j, port_side(batch_size, caps, full_main_waves=main_waves,
                            **kw)
    return make


def run(s, steps):
    """Each step is a batch (a list of pod dicts, assigned against a fresh
    snapshot and bulk-assumed) or a callable(side) event."""
    out = []
    for step in steps:
        if callable(step):
            step(s)
            continue
        res = s.backend.assign(s.infos(step), s.snapshot())
        s.assume(step, res)
        out.append(outcome(res))
    return out


def host_node(s, name, **labels):
    return s.testing.make_node(name).labels(**{HOST: name}, **labels).build()


# -- TestSelectorsAndTaints ------------------------------------------------

def sc_node_selector(s):
    s.cache.add_node(s.testing.make_node("n1").labels(disk="hdd").build())
    s.cache.add_node(s.testing.make_node("n2").labels(disk="ssd").build())
    return [[s.testing.make_pod("p").node_selector(disk="ssd").build()]]


def sc_node_affinity_in(s):
    s.cache.add_node(s.testing.make_node("n1").labels(zone="a").build())
    s.cache.add_node(s.testing.make_node("n2").labels(zone="b").build())
    return [[s.testing.make_pod("p").node_affinity_in("zone", ["b", "c"])
             .build()]]


def sc_taints(s):
    s.cache.add_node(s.testing.make_node("n1").taint("dedicated", "db")
                     .build())
    s.cache.add_node(s.testing.make_node("n2").build())
    return [[s.testing.make_pod("p").build()],
            [s.testing.make_pod("q").toleration("dedicated", "db",
                                                "NoSchedule").build()]]


def sc_unschedulable_node(s):
    s.cache.add_node(s.testing.make_node("n1").unschedulable().build())
    s.cache.add_node(s.testing.make_node("n2").build())
    return [[s.testing.make_pod("p").build()]]


def sc_node_name_pin(s):
    s.cache.add_node(s.testing.make_node("n1").build())
    s.cache.add_node(s.testing.make_node("n2").build())
    return [[s.testing.make_pod("p").node("n2").build()]]


def sc_host_port_conflict(s):
    s.cache.add_node(s.testing.make_node("n1").build())
    s.cache.add_node(s.testing.make_node("n2").build())
    return [[s.testing.make_pod(f"p{i}").host_port(8080).build()
             for i in range(3)]]


# -- TestTopologyAndAffinity -----------------------------------------------

def sc_spread_hard(s):
    s.cache.add_node(s.testing.make_node("a1").zone("a").build())
    s.cache.add_node(s.testing.make_node("b1").zone("b").build())
    return [[s.testing.make_pod(f"p{i}").labels(app="web").topology_spread(
        ZONE, max_skew=1, match_labels={"app": "web"}).build()
        for i in range(4)]]


def sc_anti_intra_batch(s):
    for i in range(3):
        s.cache.add_node(host_node(s, f"n{i}"))
    return [[s.testing.make_pod(f"p{i}").labels(app="web").pod_affinity(
        HOST, {"app": "web"}, anti=True).build() for i in range(3)]]


def sc_anti_vs_existing(s):
    s.cache.add_node(host_node(s, "n1"))
    s.cache.add_node(host_node(s, "n2"))
    s.cache.add_pod(s.testing.make_pod("e").labels(app="web").node("n1")
                    .build())
    return [[s.testing.make_pod("p").labels(app="web").pod_affinity(
        HOST, {"app": "web"}, anti=True).build()]]


def sc_existing_anti_blocks(s):
    s.cache.add_node(host_node(s, "n1"))
    s.cache.add_node(host_node(s, "n2"))
    s.cache.add_pod(s.testing.make_pod("e").labels(app="web").node("n1")
                    .pod_affinity(HOST, {"app": "web"}, anti=True).build())
    return [[s.testing.make_pod("p").labels(app="web").build()]]


def sc_required_affinity(s):
    s.cache.add_node(s.testing.make_node("n1").zone("a").build())
    s.cache.add_node(s.testing.make_node("n2").zone("b").build())
    s.cache.add_pod(s.testing.make_pod("e").labels(app="db").node("n1")
                    .build())
    return [[s.testing.make_pod("p").pod_affinity(ZONE, {"app": "db"})
             .build()]]


def sc_affinity_bootstrap(s):
    s.cache.add_node(s.testing.make_node("n1").zone("a").build())
    return [[s.testing.make_pod("p").labels(app="web").pod_affinity(
        ZONE, {"app": "web"}).build()]]


def sc_affinity_chain(s):
    s.cache.add_node(s.testing.make_node("n1").zone("a").build())
    s.cache.add_node(s.testing.make_node("n2").zone("b").build())
    return [[s.testing.make_pod("lead").labels(app="db").build(),
             s.testing.make_pod("follow").pod_affinity(ZONE, {"app": "db"})
             .build()]]


def sc_preferred_affinity(s):
    s.cache.add_node(s.testing.make_node("n1").zone("a").build())
    s.cache.add_node(s.testing.make_node("n2").zone("b").build())
    s.cache.add_pod(s.testing.make_pod("e").labels(app="cache").node("n1")
                    .build())
    return [[s.testing.make_pod("p").pod_affinity(
        ZONE, {"app": "cache"}, preferred_weight=10).build()]]


# -- TestNamespaceSelectorTensors ------------------------------------------

def make_ns(name, **labels):
    return {"apiVersion": "v1", "kind": "Namespace",
            "metadata": {"name": name, "labels": dict(labels)}}


def ns_term(match, ns_match):
    return {"topologyKey": HOST, "labelSelector": {"matchLabels": match},
            "namespaceSelector": {"matchLabels": ns_match}}


def ns_anti(match, ns_match):
    return {"podAntiAffinity": {
        "requiredDuringSchedulingIgnoredDuringExecution": [
            ns_term(match, ns_match)]}}


def namespaces(*objs):
    def add(s):
        for ns in objs:
            s.backend.note_namespace_event("ADDED", ns)
    return add


def sc_ns_anti_vs_existing(s):
    s.cache.add_node(host_node(s, "n1"))
    s.cache.add_node(host_node(s, "n2"))
    s.cache.add_pod(s.testing.make_pod("e", "team-a").labels(app="web")
                    .node("n1").build())
    pod = s.testing.make_pod("p").labels(app="web").build()
    pod["spec"]["affinity"] = ns_anti({"app": "web"}, {"team": "dev"})
    return [namespaces(make_ns("team-a", team="dev"),
                       make_ns("team-b", team="ops")), [pod]]


def sc_ns_ignores_unselected(s):
    s.cache.add_node(host_node(s, "n1"))
    s.cache.add_pod(s.testing.make_pod("e", "team-b").labels(app="web")
                    .node("n1").build())
    pod = s.testing.make_pod("p").labels(app="web").build()
    pod["spec"]["affinity"] = ns_anti({"app": "web"}, {"team": "dev"})
    return [namespaces(make_ns("team-a", team="dev"),
                       make_ns("team-b", team="ops")), [pod]]


def sc_ns_preferred(s):
    s.cache.add_node(host_node(s, "n1"))
    s.cache.add_node(host_node(s, "n2"))
    s.cache.add_pod(s.testing.make_pod("e", "team-a").labels(app="cache")
                    .node("n1").build())
    pod = s.testing.make_pod("p").build()
    pod["spec"]["affinity"] = {"podAffinity": {
        "preferredDuringSchedulingIgnoredDuringExecution": [
            {"weight": 10,
             "podAffinityTerm": ns_term({"app": "cache"}, {"team": "dev"})}]}}
    return [namespaces(make_ns("team-a", team="dev")), [pod]]


def sc_ns_relabeled(s):
    s.cache.add_node(host_node(s, "n1"))
    s.cache.add_node(host_node(s, "n2"))
    s.cache.add_pod(s.testing.make_pod("e", "team-a").labels(app="db")
                    .node("n1").build())

    def affinity_pod(name):
        p = s.testing.make_pod(name).build()
        p["spec"]["affinity"] = {"podAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": [
                ns_term({"app": "db"}, {"team": "dev"})]}}
        return p

    def relabel(s):
        s.backend.note_namespace_event("MODIFIED",
                                       make_ns("team-a", team="ops"))
    return [namespaces(make_ns("team-a", team="dev")), [affinity_pod("p1")],
            relabel, [affinity_pod("p2")]]


def sc_ns_deleted(s):
    s.cache.add_node(host_node(s, "n1"))
    s.cache.add_pod(s.testing.make_pod("e", "team-a").labels(app="web")
                    .node("n1").build())

    def anti_pod(name):
        p = s.testing.make_pod(name).labels(app="web").build()
        p["spec"]["affinity"] = ns_anti({"app": "web"}, {"team": "dev"})
        return p

    def delete(s):
        s.backend.note_namespace_event("DELETED",
                                       make_ns("team-a", team="dev"))
    return [namespaces(make_ns("team-a", team="dev")), [anti_pod("p1")],
            delete, [anti_pod("p2")]]


def sc_ns_randomized(s, trial):
    rng = random.Random(7 + trial)
    ns_labels = {"ns-a": {"team": "dev"}, "ns-b": {"team": "dev"},
                 "ns-c": {"team": "ops"}, "default": {}}
    for i in range(6):
        s.cache.add_node(host_node(s, f"n{i}"))
    pods = []
    for i in range(12):
        ns = rng.choice(list(ns_labels))
        p = s.testing.make_pod(f"t{trial}p{i}", ns).req(cpu="50m").build()
        p["metadata"]["labels"] = {"app": rng.choice(["web", "db"])}
        if rng.random() < 0.5:
            p["spec"]["affinity"] = ns_anti(
                {"app": p["metadata"]["labels"]["app"]},
                {"team": rng.choice(["dev", "ops"])})
        pods.append(p)
    return [namespaces(*(make_ns(n, **lab) for n, lab in ns_labels.items())),
            pods]


# -- TestStragglerRetryKernel and TestTailCompaction -----------------------

def sc_straggler_retry(s):
    for i in range(48):
        s.cache.add_node(s.testing.make_node(f"n{i}").zone("abc"[i % 3])
                         .capacity(cpu="64", mem="256Gi", pods=200).build())
    return [[s.testing.make_pod(f"sp{i}").labels(app="s").req(cpu="100m")
             .topology_spread(ZONE, max_skew=1, match_labels={"app": "s"})
             .build() for i in range(128)]]


def sc_tail_spread(s):
    for i in range(9):
        s.cache.add_node(s.testing.make_node(f"n{i}").zone(f"z{i % 3}")
                         .capacity(cpu="8", mem="32Gi", pods=100).build())
    return [[s.testing.make_pod(f"p{i}").req(cpu="100m", mem="64Mi")
             .labels(app="s")
             .topology_spread(ZONE, max_skew=1, match_labels={"app": "s"})
             .build() for i in range(12)]]


def sc_tail_anti(s):
    for i in range(8):
        s.cache.add_node(s.testing.make_node(f"n{i}").labels(**{HOST: f"n{i}"})
                         .capacity(cpu="8", mem="32Gi", pods=100).build())
    return [[s.testing.make_pod(f"q{i}").req(cpu="100m", mem="64Mi")
             .labels(app="a").pod_affinity(HOST, {"app": "a"}, anti=True)
             .build() for i in range(8)]]


def sc_chunked(s):
    """A constraint batch two and a half times full_cap: spread,
    anti-affinity and host ports mixed, chunked with the state chained
    chunk to chunk; then pods bound from outside (row patches, which ride
    the first chunk only) and a second oversized batch."""
    rng = random.Random(5)
    for i in range(12):
        s.cache.add_node(s.testing.make_node(f"n{i}").zone("abc"[i % 3])
                         .labels(**{HOST: f"n{i}"})
                         .capacity(cpu="8", mem="32Gi", pods=40).build())
    pods = []
    for i in range(40):
        w = s.testing.make_pod(f"c{i}").req(
            cpu=rng.choice(("100m", "300m", "1")), mem="256Mi")
        k = i % 3
        if k == 0:
            w.labels(app="s").topology_spread(ZONE, max_skew=1,
                                              match_labels={"app": "s"})
        elif k == 1:
            w.labels(app="a").pod_affinity(HOST, {"app": "a"}, anti=True)
        else:
            w.host_port(9000)
        pods.append(w.build())

    def external(s):
        for i in range(3):
            s.cache.add_pod(s.testing.make_pod(f"x{i}").req(cpu="2")
                            .node(f"n{i}").build())
    return [pods[:20], external, pods[20:]]


CAPS64 = dict(CAPS, n_cap=64)
# name -> (build, batch size, caps, backend options, JAX TAIL_P or None).
# Batch sizes are rounded up to a few shared ones (4, 12, 16) so the JAX
# steps compile once per size; a batch's padding slots hold no pod.
SCENARIOS = {
    "node_selector": (sc_node_selector, 4, CAPS, {}, None),
    "node_affinity_in": (sc_node_affinity_in, 4, CAPS, {}, None),
    "taints": (sc_taints, 4, CAPS, {}, None),
    "unschedulable_node": (sc_unschedulable_node, 4, CAPS, {}, None),
    "node_name_pin": (sc_node_name_pin, 4, CAPS, {}, None),
    "host_port_conflict_intra_batch": (sc_host_port_conflict, 4, CAPS, {},
                                       None),
    "spread_hard_intra_batch": (sc_spread_hard, 4, CAPS, {}, None),
    "anti_affinity_intra_batch": (sc_anti_intra_batch, 4, CAPS, {}, None),
    "anti_affinity_vs_existing": (sc_anti_vs_existing, 4, CAPS, {}, None),
    "existing_pod_anti_affinity_blocks_incoming": (
        sc_existing_anti_blocks, 4, CAPS, {}, None),
    "required_affinity_colocates": (sc_required_affinity, 4, CAPS, {}, None),
    "affinity_bootstrap": (sc_affinity_bootstrap, 4, CAPS, {}, None),
    "affinity_chain_within_batch": (sc_affinity_chain, 4, CAPS, {}, None),
    "preferred_affinity_scores": (sc_preferred_affinity, 4, CAPS,
                                  {"weights": {"affinity": 1000.0}}, None),
    "ns_anti_affinity_vs_existing": (sc_ns_anti_vs_existing, 4, CAPS, {},
                                     None),
    "ns_selector_ignores_unselected_namespace": (
        sc_ns_ignores_unselected, 4, CAPS, {}, None),
    "ns_preferred_affinity_colocates": (
        sc_ns_preferred, 4, CAPS, {"weights": {"affinity": 1000.0}}, None),
    "ns_relabeled_seen_by_next_batch": (sc_ns_relabeled, 4, CAPS, {}, None),
    "ns_deleted_seen_by_next_batch": (sc_ns_deleted, 4, CAPS, {}, None),
    **{f"ns_randomized_anti_{t}": (
        lambda s, t=t: sc_ns_randomized(s, t), 16, CAPS, {}, None)
       for t in range(3)},
    "tail_spread_places_fully": (sc_tail_spread, 12, CAPS, {}, 2),
    "tail_anti_affinity": (sc_tail_anti, 12, CAPS, {}, 2),
    "chunked_over_full_cap": (sc_chunked, 20, CAPS,
                              {"full_batch_cap": 8}, None),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_full_scenarios(sides, monkeypatch, name):
    build, batch_size, caps, kw, tail_p = SCENARIOS[name]
    if tail_p is not None:
        monkeypatch.setattr(jax_assign, "TAIL_P", tail_p)
    jax_s, port_s = sides(batch_size, caps, **kw)
    want = run(jax_s, build(jax_s))
    got = run(port_s, build(port_s))
    assert got == want
    assert any(n for batch in got for n, _ in batch)
    if kw.get("full_batch_cap"):
        assert port_s.backend.full_cap == kw["full_batch_cap"]
        assert port_s.backend.stats["batches"] == 2
        assert port_s.backend.stats["patched_rows"] > 0


@pytest.mark.parametrize("main_waves", [2, 3])
def test_straggler_retry_matches_reference(sides, main_waves):
    """Capped main step plus the retry step on both sides: at 2 waves the
    stragglers go through the retry step, at 3 the main step places
    every pod."""
    jax_s, port_s = sides(128, CAPS64, main_waves=main_waves)
    want = run(jax_s, sc_straggler_retry(jax_s))
    got = run(port_s, sc_straggler_retry(port_s))
    assert got == want
    assert sum(1 for n, _ in got[0] if n) == 128
    retries = port_s.backend.stats.get("retries", 0)
    assert retries == jax_s.backend.stats.get("retries", 0)
    assert port_s.backend.stats["waves"] == jax_s.backend.stats["waves"]
    assert retries >= (main_waves == 2)


def test_full_cap_rule_matches_reference():
    """On the CPU the port sizes full_cap by the JAX package's rule."""
    for n_cap, batch in ((16, 256), (64, 8192), (110080, 8192),
                         (5632, 8192), (400_000, 8192)):
        j = jax_backend.TPUBatchBackend(JaxCaps(n_cap=n_cap),
                                        batch_size=batch)
        t = port_backend.TorchBatchBackend(Caps(n_cap=n_cap),
                                           batch_size=batch, device="cpu")
        assert t.full_cap == j.full_cap, n_cap


# -- test_churn_parity.py's non-pipelined constraint streams ---------------

def _port_event(cache, backend, kind, node):
    node = copy.deepcopy(node)
    if kind == "DELETED":
        cache.remove_node(node)
    elif kind == "ADDED":
        cache.add_node(node)
    else:
        cache.update_node(node)
    backend.note_node_event(kind, port_meta.name(node), cache.flatten_view())


def run_port_scenario(backend, ops):
    """test_churn_parity.run_scenario on the port's Cache and PodInfo."""
    cache = port_cache.Cache()
    waves = []
    for op in ops:
        if op[0] == "event":
            _port_event(cache, backend, op[1], op[2])
        elif op[0] == "compact":
            with backend._lock:
                backend.tensors.compact()
        else:
            pod_objs = [copy.deepcopy(p) for p in op[1]]
            resolve = backend.dispatch(
                [port_types.PodInfo(p) for p in pod_objs],
                cache.flatten_view())
            assert resolve is not port_backend.FLUSH_FIRST
            for kind, _t, node in op[2]:
                _port_event(cache, backend, kind, node)
            out = []
            for pod, (name, status) in zip(pod_objs, resolve()):
                out.append((name, None if status is None else status.code))
                if name:
                    bound = copy.deepcopy(pod)
                    bound.setdefault("spec", {})["nodeName"] = name
                    cache.add_pod(bound)
            waves.append(out)
    return waves


@pytest.mark.parametrize("seed", [7, 23])
def test_churn_constraint_streams_match_reference(monkeypatch, seed):
    monkeypatch.setenv("KTPU_PALLAS", "0")
    ops = build_ops(seed, rounds=4, base_nodes=10, constraint_pods=True)
    _cache, want = run_scenario(
        jax_backend.TPUBatchBackend(small_caps(), batch_size=16), ops)
    port = port_backend.TorchBatchBackend(
        Caps(**vars(small_caps())), batch_size=16, device="cpu",
        claims_noise="murmur")
    got = run_port_scenario(port, ops)
    assert got == want
    assert port.stats["event_patches"] > 0
    assert any(n for w in got for n, _ in w)


def test_group_registered_after_own_binds_keeps_the_pod_caps():
    """Own placements, then a batch whose encode registers a new selector
    group while the epoch fast path skipped the tensor sync: the domain
    counts then differ from the mirror and the device state is refreshed
    from the host tensors, which must first catch up with the backend's
    own binds.  Under the JAX package's rule (refresh from the unsynced
    tensors) the device forgot 250 placed pods here and filled 110-pod
    nodes to 115-141; the port keeps every node at its cap and places
    exactly the capacity that is left."""
    from kubernetes_tpu_torch import testing
    from kubernetes_tpu_torch.scheduler.cache import Cache, Snapshot
    from kubernetes_tpu_torch.scheduler.types import PodInfo

    def pod(name, color=None, affinity=None):
        p = testing.make_pod(name).req(cpu="100m", mem="128Mi")
        p = (p.labels(color=color) if color else p).build()
        if affinity:
            p["spec"]["affinity"] = affinity
        return p

    def term(color):
        return {"topologyKey": HOST,
                "labelSelector": {"matchLabels": {"color": color}}}

    red = {"podAffinity": {"preferredDuringSchedulingIgnoredDuringExecution":
                           [{"weight": 1, "podAffinityTerm": term("red")}]}}
    green = {"podAntiAffinity": {
        "requiredDuringSchedulingIgnoredDuringExecution": [term("green")]}}
    cache = Cache()
    for i in range(3):
        cache.add_node(testing.make_node(f"n{i}").capacity(
            cpu="32", mem="256Gi", pods=110).labels(**{HOST: f"n{i}"})
            .build())
    backend = port_backend.TorchBatchBackend(
        Caps(n_cap=64, l_cap=64, kl_cap=32, t_cap=8, pt_cap=8, s_cap=2,
             sg_cap=8, asg_cap=8), batch_size=256, device="cpu",
        claims_noise="murmur")
    view = cache.flatten_view()

    def run(pods):
        infos = [PodInfo(p) for p in pods]
        out = backend.assign(infos, view)
        items = []
        for pi, (node, _st) in zip(infos, out):
            if node:
                bound = {**pi.pod, "spec": {**pi.pod["spec"],
                                            "nodeName": node}}
                items.append((bound, pi.clone_with_pod(bound)))
        assert not any(cache.assume_pods(items))
        return sum(1 for node, _st in out if node)

    assert run([pod(f"red{i}", "red", red) for i in range(200)]) == 200
    assert run([pod(f"plain{i}") for i in range(50)]) == 50
    skips = backend.stats.get("epoch_skips", 0)
    placed = run([pod("green0", "green", green)]
                 + [pod(f"more{i}") for i in range(120)])
    per_node = {ni.name: len(ni.pods)
                for ni in cache.update_snapshot(Snapshot()).list()}
    assert per_node == {"n0": 110, "n1": 110, "n2": 110}
    assert placed == 330 - 250
    assert backend.stats.get("epoch_skips", 0) == skips


def test_collided_buckets_on_an_empty_cluster_stay_unschedulable(
        monkeypatch):
    """ROADMAP Q5.  SchedulingHighCardinality's first batch can run ahead
    of the node informer: 64 pods of 64 anti-affinity services (eight
    selector-group slots, so the buckets collide) against a cache with no
    node yet.  Nothing can fit there, so the device's no-fit verdicts
    are exact: the port reports every pod UNSCHEDULABLE and escapes none.
    (The JAX backend re-proves the collided pods one by one, 63 escapes
    with ("BatchEncoder", "bucket_collision"): the reference quirk R10.)
    Once the nodes arrive, the same pods go through a forced full refresh
    on the collided buckets and all bind, one service a host, with no
    escape, as in the JAX backend."""
    monkeypatch.setenv("KTPU_PALLAS", "0")
    from kubernetes_tpu_torch.perf import load_workloads
    from kubernetes_tpu_torch.perf.scheduler_perf import _default_pod
    caps = dict(CAPS, n_cap=64, sg_cap=8, asg_cap=8, c_cap=2, ns_cap=256)
    op = copy.deepcopy(load_workloads()["SchedulingHighCardinality"]
                       ["workloadTemplate"][1])
    pods = [_default_pod(i, op) for i in range(64)]
    got = {}
    for name, s in (("port", port_side(64, caps)),
                    ("jax", jax_side(64, caps))):
        s.backend.warmup()
        view = s.cache.flatten_view()
        first = outcome(s.backend.dispatch(s.infos(pods), view)())
        escapes = s.backend.drain_escape_reasons()
        for i in range(50):
            s.cache.add_node(s.testing.make_node(f"n{i}").labels(
                **{HOST: f"n{i}"}).capacity(cpu="32", mem="256Gi",
                                            pods=110).build())
        s.backend.abandon_wave()    # the next dispatch refreshes in full
        second = s.backend.dispatch(s.infos(pods), view)()
        got[name] = (first, escapes, outcome(second),
                     s.backend.drain_escape_reasons(), dict(s.backend.stats))
    first, escapes, second, escapes2, stats = got["port"]
    assert first == [(None, port_types.UNSCHEDULABLE)] * 64
    assert escapes == {}
    assert stats["full_refresh"] >= 2 and stats["waves_reflattened"] >= 1
    assert escapes2 == {} and all(n is not None for n, _c in second)
    assert second == got["jax"][2] and got["jax"][3] == {}
    # the reference re-proves the collided pods instead (R10)
    assert got["jax"][1] == {("BatchEncoder", "bucket_collision"): 63}
