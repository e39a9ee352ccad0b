"""Batched preemption on the port held against the JAX package on the CPU.

Module level: the port's plain dry run (K7, models/preempt.py
preempt_dry_run_reference) against kubernetes_tpu.models.preempt.
preempt_dry_run, all seven outputs bit for bit, and the port's
preempt_candidates (K8) against the JAX one, rows and counts, with forced
ties and k past the feasible count.

Backend level: TorchBatchBackend(device="cpu").preempt_batch against
TPUBatchBackend.preempt_batch on every scenario of
tests/test_preempt_batch.py, the remote-seam ones over a port worker (HTTP and
gRPC) too: node, sorted victims, violations, escapes and the
wave order must be identical, and the port's answers must equal its own
sequential Evaluator oracle.  Then the victim channel: a second wave
after binds on two nodes takes the row-overwrite path and answers as a
backend that uploads in full.
"""

import importlib
import random

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from kubernetes_tpu.models import preempt as jax_preempt  # noqa: E402
from kubernetes_tpu_torch.models import preempt as port_preempt  # noqa: E402
from preempt_kernel_model import (  # noqa: E402
    SlotCapExceeded, dry_run_model,
)
from torch_cases import (  # noqa: E402
    CANDIDATE_CASES, DRY_RUN_CASES, PORT_PKG, candidates_case,
    dry_run_inputs, port_tensors,
)

JAX = "kubernetes_tpu"
OUTPUTS = ("cand", "viol", "highest", "psum", "nvic", "victims",
           "overflow_hit")


@pytest.fixture
def pallas_off(monkeypatch):
    monkeypatch.setenv("KTPU_PALLAS", "0")


# -- module level ------------------------------------------------------------

def assert_planes_equal(want, got):
    for name, w, g in zip(OUTPUTS, want, got):
        w = np.asarray(w)
        g = g.numpy() if torch.is_tensor(g) else g
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("case", sorted(DRY_RUN_CASES))
def test_dry_run_reference_matches_jax(case):
    args = dry_run_inputs(case)
    want = jax_preempt.preempt_dry_run(*args)
    got = port_preempt.preempt_dry_run_reference(*port_tensors(args))
    assert_planes_equal(want, got)
    assert np.asarray(want[0]).any(), "no candidate in the case"


FLAT_CASES = sorted(c for c in DRY_RUN_CASES if c.startswith("flat_"))


@pytest.mark.parametrize("case", sorted(DRY_RUN_CASES))
def test_kernel_order_of_work_matches_reference(case):
    """tests/preempt_kernel_model.py, the kernel's order of work (live-slot
    compaction, reprieve order over live slots, reuse by key, sums over
    eligible slots and victims only) on numpy f32 scalars, equals the
    plain version bit for bit."""
    args = dry_run_inputs(case)
    want = port_preempt.preempt_dry_run_reference(*port_tensors(args))
    assert_planes_equal([w.numpy() for w in want], dry_run_model(*args))


@pytest.mark.parametrize("case", sorted(DRY_RUN_CASES))
def test_kernel_order_of_work_with_one_block_of_pods(case):
    """The same with every pod in one block, the kernel's grid when all
    node blocks are resident at once: one compaction against the highest
    priority of all pods, keys reused across 64-pod chunk edges."""
    args = dry_run_inputs(case)
    want = port_preempt.preempt_dry_run_reference(*port_tensors(args))
    assert_planes_equal([w.numpy() for w in want],
                        dry_run_model(*args, pp=len(args[14])))


@pytest.mark.parametrize("case", FLAT_CASES)
def test_kernel_order_of_work_at_narrow_blocks(case):
    """The same with 7-pod blocks: every block edge cuts a run of equal
    keys, and each block's highest priority compacts its own live slots."""
    args = dry_run_inputs(case)
    want = port_preempt.preempt_dry_run_reference(*port_tensors(args))
    assert_planes_equal([w.numpy() for w in want],
                        dry_run_model(*args, pp=7))


def test_flatten_cases_have_what_they_claim():
    """The flatten-shaped cases: slots ascending with PAD at the tail,
    nodes with no live slot and with all V, runs of one key across the
    64-pod block edge with inactive pods inside, keys that change pod to
    pod, one priority with two requests, prefix-only eligibility and
    equal-priority slots split by their PDB bit."""
    for case in FLAT_CASES:
        params = DRY_RUN_CASES[case][1]
        lead = params[6] if len(params) > 6 else 0
        # the pod-side arrays past the leading run
        a = [x[lead:] if i >= 12 else x
             for i, x in enumerate(dry_run_inputs(case))]
        vprio, vpdb, req, prio, gidx, active = (a[6], a[8], a[13], a[14],
                                                a[12], a[16])
        V = vprio.shape[1]
        assert (np.diff(vprio.astype(np.int64), axis=1) >= 0).all()
        live = (vprio != port_preempt.I32_MAX).sum(1)
        assert (live == 0).any() and (live == V).any()
        assert (a[7][vprio == port_preempt.I32_MAX] == 0).all()
        same = ((prio[1:] == prio[:-1]) & (gidx[1:] == gidx[:-1])
                & (req[1:] == req[:-1]).all(1))
        assert same[62:64].all() and not active[63:65].any()
        assert (~same[20:40]).all()
        assert ((prio[1:20] == prio[:19]) & ~(req[1:20] == req[:19]).all(1)
                ).all()
        elig = vprio[None] < prio[:, None, None]
        assert (elig.any(2) & ~elig.all(2) & (live > 0)[None]).any()
        split = ((vprio[:, 1:] == vprio[:, :-1])
                 & (vpdb[:, 1:] < vpdb[:, :-1]))
        assert split.any()


def test_kernel_order_of_work_needs_the_live_cap():
    """A k_cap below a node's live slots is refused (the kernel traps),
    and live_slot_cap is the count of non-PAD slots."""
    args = dry_run_inputs("flat_130x90")
    cap = port_preempt.live_slot_cap(args[6])
    assert cap == port_preempt.live_slot_cap(torch.from_numpy(args[6])) == 16
    with pytest.raises(SlotCapExceeded):
        dry_run_model(*args, k_cap=cap - 1)


def test_psum_above_2_24_is_the_jax_rounding():
    """Victim priorities above 2^24: the f32 priority sum rounds, and it
    rounds as the JAX program's does (same order, same steps)."""
    args = dry_run_inputs("37x1000")
    want = jax_preempt.preempt_dry_run(*args)
    got = port_preempt.preempt_dry_run_reference(*port_tensors(args))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    victims = np.asarray(want[5])
    exact = (victims * args[6][None].astype(np.int64)).sum(-1)
    assert (np.asarray(want[3]).astype(np.float64) != exact).any(), \
        "no inexact priority sum: the case does not reach past 2^24"


def test_cpu_wrappers_are_the_plain_version():
    """On CPU tensors preempt_dry_run is the plain version, and
    dry_run_planes packs its victims into words that unpack to them."""
    t = port_tensors(dry_run_inputs("20x200_v32_t40"))
    ref = port_preempt.preempt_dry_run_reference(*t)
    assert_planes_equal([x.numpy() for x in ref],
                        port_preempt.preempt_dry_run(*t))
    planes = port_preempt.dry_run_planes(*t)
    assert planes[5].dtype == torch.int32
    assert_planes_equal(
        [x.numpy() for x in ref],
        (*planes[:5], port_preempt.unpack_victims(planes[5], 32), planes[6]))


def test_reprieve_order_is_the_jax_lexsort():
    args = dry_run_inputs("37x1000")
    vprio, vpdb = args[6], args[8]
    V = vprio.shape[1]
    want = np.lexsort((np.broadcast_to(np.arange(V), vprio.shape),
                       -vprio.astype(np.int64), -vpdb), axis=-1)
    got = port_preempt.reprieve_order(torch.from_numpy(vprio),
                                      torch.from_numpy(vpdb))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", sorted(CANDIDATE_CASES))
def test_candidates_match_jax(case):
    *shape, k = CANDIDATE_CASES[case]
    args = candidates_case(*shape)
    want_rows, want_count = jax_preempt.preempt_candidates(*args, k)
    rows, count = port_preempt.preempt_candidates(*port_tensors(args), k)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want_rows))
    np.testing.assert_array_equal(count.numpy(), np.asarray(want_count))
    assert rows.dtype == torch.int32 and count.dtype == torch.int32
    if case == "k_past_feasible":
        assert (rows.numpy() == -1).any()
    if case.startswith("ties"):
        # every node alike: a pod's scores are one constant plus the hash
        # term, and equal scores do occur among its feasible rows
        P, N = args[8].shape[0], args[0].shape[0]
        tie = port_preempt._tie_noise(P, N, "cpu").numpy()
        score = np.float32(-1e5) + tie * (np.float32(0.1) / np.float32(65536))
        assert all(len(np.unique(score[p])) < 20 for p in range(P))


# -- backend level: tests/test_preempt_batch.py's scenarios ---------------

SMALL_CAPS = dict(n_cap=16, l_cap=64, kl_cap=32, t_cap=8, pt_cap=8, s_cap=2,
                  sg_cap=8, asg_cap=8, v_cap=8)


class Side:
    """One package's preemption stack: client, framework, cache snapshot
    and a synced batch backend."""

    def __init__(self, pkg, nodes, victims, pdbs=(), caps=SMALL_CAPS):
        def m(name):
            return importlib.import_module(f"{pkg}.{name}")
        self.pkg = pkg
        client_mod, sched_mod = m("client"), m("scheduler")
        self.types, self.cache_mod = m("scheduler.types"), m("scheduler.cache")
        self.Evaluator = m("scheduler.preemption").Evaluator
        self.CycleState = m("scheduler.framework").CycleState
        self.client = client_mod.LocalClient(m("store.kv").MemoryStore())
        factory = client_mod.SharedInformerFactory(self.client)
        self.fw = sched_mod.new_default_framework(self.client, factory)
        for pdb in pdbs:
            self.client.create(m("client.clientset").PDBS, pdb)
        self.cache = self.cache_mod.Cache()
        for n in nodes:
            self.cache.add_node(n)
        for p in victims:
            self.cache.add_pod(p)
        self.snap = self.cache.update_snapshot(self.cache_mod.Snapshot())
        backends = m("ops.backend")
        c = m("ops.flatten").Caps(**caps)
        self.backend = (backends.TPUBatchBackend(c, batch_size=8)
                        if pkg == JAX else
                        backends.TorchBatchBackend(c, batch_size=8,
                                                   device="cpu"))
        self.backend.assign([], self.snap)
        for pdb in pdbs:
            self.backend.note_pdb_event("ADDED", pdb)

    def infos(self, pods):
        return [self.types.PodInfo(p) for p in pods]

    def wave(self, pods, nominated=()):
        noms = [(self.types.PodInfo(p), node) for p, node in nominated]
        node_ord_of = {ni.name: i for i, ni in enumerate(self.snap.list())}
        res, esc = self.backend.preempt_batch(self.infos(pods), node_ord_of,
                                              noms)
        got = [None if r is None else (r[0], sorted(r[1]), r[2])
               for r in res]
        return got, esc, list(self.backend.last_wave_order)

    def oracle(self, pods, order, nominated=()):
        """The per-pod Evaluator along `order`, each winner's nomination
        folded before the next pod (tests/test_preempt_batch.py)."""
        infos = self.infos(pods)
        noms = [(self.types.PodInfo(p), node) for p, node in nominated]

        class _Nom:
            def nominated_pods_for_node(self, name):
                return [pi for pi, n in noms if n == name]

        self.fw.handle.nominator = _Nom()
        want = [None] * len(infos)
        ev = self.Evaluator(self.fw, self.client)
        for i in order:
            cands = ev.find_candidates(self.CycleState(), infos[i], {},
                                       self.snap)
            if cands:
                best = ev.select_candidate(cands)
                want[i] = (best.node_name, sorted(v.key for v in best.victims),
                           best.num_pdb_violations)
                noms.append((infos[i], want[i][0]))
        return want


def scenario_random(seed):
    def make(testing):
        rng = random.Random(seed)
        n_nodes = rng.randint(3, 10)
        nodes = [testing.make_node(f"n{i}")
                 .capacity(cpu=str(rng.choice([1, 2, 4])), mem="32Gi")
                 .build() for i in range(n_nodes)]
        victims = [testing.make_pod(f"v{i}").priority(rng.randint(0, 4))
                   .req(cpu=f"{rng.choice([100, 200, 400, 800])}m")
                   .node(f"n{rng.randrange(n_nodes)}").build()
                   for i in range(rng.randint(4, 24))]
        pre = [testing.make_pod(f"p{j}").priority(rng.choice([5, 10, 20]))
               .req(cpu=f"{rng.choice([500, 1000, 2000, 3500])}m").build()
               for j in range(rng.randint(2, 8))]
        return dict(nodes=nodes, victims=victims, pre=pre)
    return make


def scenario_nominated(seed):
    def make(testing):
        rng = random.Random(100 + seed)
        nodes = [testing.make_node(f"n{i}").capacity(cpu="2", mem="8Gi")
                 .build() for i in range(4)]
        victims = [testing.make_pod(f"v{i}").priority(1).req(cpu="600m")
                   .node(f"n{i % 4}").build() for i in range(8)]
        nom = testing.make_pod("nom").priority(50).req(cpu="1500m").build()
        pre = [testing.make_pod(f"p{j}").priority(10).req(cpu="1500m")
               .build() for j in range(3)]
        return dict(nodes=nodes, victims=victims, pre=pre,
                    nominated=[(nom, f"n{rng.randrange(4)}")])
    return make


def scenario_taints(testing):
    nodes = [testing.make_node("clean").capacity(cpu="1", mem="4Gi").build(),
             testing.make_node("tainted").capacity(cpu="1", mem="4Gi")
             .taint("dedicated", "gpu", "NoSchedule").build()]
    victims = [testing.make_pod("vc").priority(1).req(cpu="800m")
               .node("clean").build(),
               testing.make_pod("vt").priority(1).req(cpu="800m")
               .node("tainted").build()]
    pre = [testing.make_pod("p0").priority(10).req(cpu="800m").build(),
           testing.make_pod("p1").priority(10).req(cpu="800m")
           .toleration("dedicated", "gpu", "NoSchedule").build()]
    return dict(nodes=nodes, victims=victims, pre=pre)


DB_PDB = {"metadata": {"name": "db-pdb", "namespace": "default"},
          "spec": {"selector": {"matchLabels": {"app": "db"}}},
          "status": {"disruptionsAllowed": 0}}


def scenario_pdb_violations(testing):
    nodes = [testing.make_node("a").capacity(cpu="1", mem="4Gi").build(),
             testing.make_node("b").capacity(cpu="1", mem="4Gi").build()]
    victims = [testing.make_pod("covered").priority(1).labels(app="db")
               .req(cpu="800m").node("a").build(),
               testing.make_pod("free").priority(1).labels(app="web")
               .req(cpu="800m").node("b").build()]
    pre = [testing.make_pod("p").priority(10).req(cpu="800m").build()]
    return dict(nodes=nodes, victims=victims, pre=pre, pdbs=[DB_PDB])


def scenario_reprieve(testing):
    nodes = [testing.make_node("n").capacity(cpu="2", mem="8Gi").build()]
    victims = [testing.make_pod("hi-v").priority(3).req(cpu="700m")
               .node("n").build(),
               testing.make_pod("lo-v").priority(1).req(cpu="700m")
               .node("n").build()]
    pre = [testing.make_pod("p").priority(10).req(cpu="700m").build()]
    return dict(nodes=nodes, victims=victims, pre=pre)


def scenario_zero_victims(testing):
    nodes = [testing.make_node("empty").capacity(cpu="4", mem="8Gi").build()]
    pre = [testing.make_pod("p").priority(10).req(cpu="1").build()]
    return dict(nodes=nodes, victims=[], pre=pre)


def scenario_overflow(testing):
    nodes = [testing.make_node("full").capacity(cpu="2", mem="8Gi").build()]
    victims = [testing.make_pod(f"v{i}").priority(1).req(cpu="300m")
               .node("full").build() for i in range(4)]
    pre = [testing.make_pod("p").priority(10).req(cpu="1500m").build()]
    return dict(nodes=nodes, victims=victims, pre=pre,
                caps=dict(SMALL_CAPS, v_cap=2))


def scenario_foreign_pdb(testing):
    nodes = [testing.make_node("a").capacity(cpu="1", mem="4Gi").build()]
    victims = [testing.make_pod("v").priority(1).req(cpu="800m")
               .node("a").build()]
    pre = [testing.make_pod("p").priority(10).req(cpu="800m").build()]
    return dict(nodes=nodes, victims=victims, pre=pre, pdbs=[{
        "metadata": {"name": "other", "namespace": "kube-system"},
        "spec": {"selector": {"matchLabels": {"app": "x"}}},
        "status": {"disruptionsAllowed": 0}}], oracle=False)


def scenario_pdb_with_budget(testing):
    nodes = [testing.make_node("a").capacity(cpu="1", mem="4Gi").build()]
    victims = [testing.make_pod("v").priority(1).labels(app="db")
               .req(cpu="800m").node("a").build()]
    pre = [testing.make_pod("p").priority(10).req(cpu="800m").build()]
    pdb = {**DB_PDB, "metadata": {"name": "roomy", "namespace": "default"},
           "status": {"disruptionsAllowed": 2}}
    return dict(nodes=nodes, victims=victims, pre=pre, pdbs=[pdb])


def scenario_dense_two_chunks(testing):
    """PreemptionDense's shape (8 residents of 900m on 8-CPU nodes) with
    more preemptors than one dry-run chunk holds (PREEMPT_P_CAP = 256),
    at two priorities: the second chunk re-proves nodes the first chunk's
    winners claimed, several preemptors sharing a node."""
    nodes = [testing.make_node(f"n{i}").capacity(cpu="8", mem="32Gi")
             .build() for i in range(36)]
    victims = [testing.make_pod(f"v{i:03d}").priority(i % 3)
               .req(cpu="900m", mem="128Mi").node(f"n{i % 36}").build()
               for i in range(288)]
    pre = [testing.make_pod(f"p{j:03d}").priority(10 + 10 * (j % 2))
           .req(cpu="1800m", mem="128Mi").build() for j in range(270)]
    return dict(nodes=nodes, victims=victims, pre=pre,
                caps=dict(SMALL_CAPS, n_cap=64, v_cap=16))


SCENARIOS = {
    **{f"random-{s}": scenario_random(s) for s in range(6)},
    **{f"nominated-{s}": scenario_nominated(s) for s in range(3)},
    "taints": scenario_taints,
    "pdb-violations": scenario_pdb_violations,
    "reprieve": scenario_reprieve,
    "zero-victims": scenario_zero_victims,
    "escape-victim-overflow": scenario_overflow,
    "escape-pdb-scope": scenario_foreign_pdb,
    "pdb-with-budget": scenario_pdb_with_budget,
    "dense-two-chunks": scenario_dense_two_chunks,
}

# what tests/test_preempt_batch.py pins about each scenario's answer
EXPECT = {
    "taints": lambda got, esc: [g[0] for g in got] == ["clean", "tainted"],
    "pdb-violations": lambda got, esc: got[0][0] == "b" and got[0][2] == 0,
    "reprieve": lambda got, esc: got[0][1] == ["default/lo-v"],
    "zero-victims": lambda got, esc: got == [None],
    "escape-victim-overflow": lambda got, esc: (
        esc == {0: "victim_overflow"} and got == [None]),
    "escape-pdb-scope": lambda got, esc: esc == {0: "pdb_scope"},
    "pdb-with-budget": lambda got, esc: got[0][2] == 0,
    # a node takes four winners of each priority: a nomination claims
    # capacity only against pods of its priority or lower
    "dense-two-chunks": lambda got, esc: (
        sum(1 for g in got if g) == 243
        and max(sum(1 for g in got if g and g[0] == n)
                for n in {g[0] for g in got if g}) == 8),
}


def run_side(pkg, scenario):
    mod = importlib.import_module(f"{pkg}.testing")
    s = scenario(mod)
    side = Side(pkg, s["nodes"], s["victims"], s.get("pdbs", ()),
                s.get("caps", SMALL_CAPS))
    got, esc, order = side.wave(s["pre"], s.get("nominated", ()))
    return side, s, got, esc, order


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_preempt_batch_matches_jax(pallas_off, name):
    _j, _s, jgot, jesc, jorder = run_side(JAX, SCENARIOS[name])
    side, s, got, esc, order = run_side(PORT_PKG, SCENARIOS[name])
    assert (got, esc, order) == (jgot, jesc, jorder)
    assert side.backend.drain_escape_reasons() == \
        _j.backend.drain_escape_reasons()
    if name in EXPECT:
        assert EXPECT[name](got, esc), (got, esc)
    if not esc:
        assert sorted(order) == list(range(len(s["pre"])))
    if s.get("oracle", True):
        # the port against its own sequential Evaluator, pod by pod
        want = side.oracle(s["pre"], order, s.get("nominated", ()))
        assert [got[i] for i in order] == [want[i] for i in order]
        assert all(got[i] is None for i in esc)


def test_escape_tallies_reach_the_drain():
    side, _s, _got, esc, _order = run_side(PORT_PKG, scenario_overflow)
    assert esc == {0: "victim_overflow"}
    assert side.backend.drain_escape_reasons() == {
        ("DefaultPreemption", "victim_overflow"): 1}
    assert side.backend.drain_escape_reasons() == {}


def test_preempt_candidates_match_jax(pallas_off):
    """The legacy tier's candidate names, backend level."""
    outs = {}
    for pkg in (JAX, PORT_PKG):
        s = scenario_random(3)(importlib.import_module(f"{pkg}.testing"))
        side = Side(pkg, s["nodes"], s["victims"])
        outs[pkg] = side.backend.preempt_candidates(side.infos(s["pre"]),
                                                    k=4)
    assert outs[PORT_PKG] == outs[JAX]
    assert any(outs[PORT_PKG])


def test_victim_occupancy_matches_jax(pallas_off):
    occ = {}
    for pkg in (JAX, PORT_PKG):
        side, *_rest = run_side(pkg, scenario_random(1))
        occ[pkg] = side.backend.victim_occupancy()
    assert occ[PORT_PKG] == occ[JAX] > 0.0


# -- the victim channel ---------------------------------------------------

def test_second_wave_patches_victim_rows():
    """A wave, then pods bound on two nodes, then a second wave: the
    second re-encodes and overwrites just those rows, and answers as a
    backend that uploads the victim tensors in full."""
    from kubernetes_tpu_torch import testing
    caps = dict(SMALL_CAPS, n_cap=64)
    s = scenario_random(4)(testing)
    side = Side(PORT_PKG, s["nodes"], s["victims"], caps=caps)
    side.wave(s["pre"])
    before = side.backend.stats.get("vict_patched_rows", 0)
    for i, node in enumerate(("n0", "n2")):
        side.cache.add_pod(testing.make_pod(f"late{i}").priority(0)
                           .req(cpu="300m").node(node).build())
    side.snap = side.cache.update_snapshot(side.snap)
    side.backend.assign([], side.snap)
    second = side.wave(s["pre"])
    assert side.backend.stats.get("vict_patched_rows", 0) == before + 2
    fresh = Side(PORT_PKG, s["nodes"], s["victims"], caps=caps)
    for i, node in enumerate(("n0", "n2")):
        fresh.cache.add_pod(testing.make_pod(f"late{i}").priority(0)
                            .req(cpu="300m").node(node).build())
    fresh.snap = fresh.cache.update_snapshot(fresh.snap)
    fresh.backend.assign([], fresh.snap)
    assert fresh.wave(s["pre"]) == second
    assert "vict_patched_rows" not in fresh.backend.stats
    for k, v in fresh.backend._static_vict.items():
        assert torch.equal(side.backend._static_vict[k], v), k


def test_live_slot_cap_follows_the_victim_rows():
    """The backend's k_cap for the dry-run kernel is the live-slot count
    of the resident victim tensors, and a row patch that adds a victim to
    the fullest node raises it."""
    from kubernetes_tpu_torch import testing
    s = scenario_random(4)(testing)
    side = Side(PORT_PKG, s["nodes"], s["victims"],
                caps=dict(SMALL_CAPS, n_cap=64, v_cap=16))
    side.wave(s["pre"])
    b = side.backend
    cap = b._vict_live_cap
    assert cap == port_preempt.live_slot_cap(b._static_vict["vict_prio"]) > 0
    counts = (b.tensors.vict_prio != port_preempt.I32_MAX).sum(1)
    full = b.tensors.row_names[int(counts.argmax())]
    side.cache.add_pod(testing.make_pod("late").priority(0).req(cpu="100m")
                       .node(full).build())
    side.snap = side.cache.update_snapshot(side.snap)
    b.assign([], side.snap)
    side.wave(s["pre"])
    assert b._vict_live_cap == cap + 1 == port_preempt.live_slot_cap(
        b._static_vict["vict_prio"])


def test_wave_after_own_binds_sees_their_victims():
    """A preemption wave, then low-priority pods placed by the backend's
    own batches and assumed into the cache (no external change, so the
    next dispatch takes the epoch fast path and skips the tensor sync),
    then a second wave: it must see every pod on every node, as the
    sequential Evaluator on the cache's snapshot does.  Under the JAX
    package's rule (victim rows marked only by a tensor sync) the second
    wave read the rows as the first had encoded them and found no
    candidate; the port marks the rows its own placements land on."""
    from kubernetes_tpu_torch import testing
    from kubernetes_tpu_torch.client import LocalClient, SharedInformerFactory
    from kubernetes_tpu_torch.ops import backend as port_backend
    from kubernetes_tpu_torch.ops.flatten import Caps
    from kubernetes_tpu_torch.scheduler import new_default_framework
    from kubernetes_tpu_torch.scheduler.cache import Cache, Snapshot
    from kubernetes_tpu_torch.scheduler.framework import CycleState
    from kubernetes_tpu_torch.scheduler.preemption import Evaluator
    from kubernetes_tpu_torch.scheduler.types import PodInfo
    from kubernetes_tpu_torch.store import kv
    cache = Cache()
    for i in range(4):
        cache.add_node(testing.make_node(f"n{i}").capacity(
            cpu="4", mem="32Gi").build())
    backend = port_backend.TorchBatchBackend(
        Caps(**SMALL_CAPS), batch_size=16, device="cpu",
        claims_noise="murmur")
    view = cache.flatten_view()

    def place(names):
        infos = [PodInfo(testing.make_pod(n).req(cpu="900m", mem="500Mi")
                         .build()) for n in names]
        items = []
        for pi, (node, _st) in zip(infos, backend.assign(infos, view)):
            assert node
            pod = {**pi.pod, "spec": {**pi.pod["spec"], "nodeName": node}}
            items.append((pod, pi.clone_with_pod(pod)))
        assert not any(cache.assume_pods(items))

    hi = PodInfo(testing.make_pod("hi").priority(10)
                 .req(cpu="3000m", mem="500Mi").build())
    place([f"low{k}" for k in range(4)])
    snap = cache.update_snapshot(Snapshot())
    order = {ni.name: i for i, ni in enumerate(snap.list())}
    first, _esc = backend.preempt_batch([hi], order)
    assert first[0] is not None and len(first[0][1]) == 1
    skips = backend.stats.get("epoch_skips", 0)
    place([f"low{k}" for k in range(4, 16)])   # every node now holds 4
    assert backend.stats.get("epoch_skips", 0) == skips + 1
    got, esc = backend.preempt_batch([hi], order)
    assert not esc and got[0] is not None
    client = LocalClient(kv.MemoryStore())
    fw = new_default_framework(client, SharedInformerFactory(client))
    ev = Evaluator(fw, client)
    snap = cache.update_snapshot(Snapshot())
    best = ev.select_candidate(ev.find_candidates(CycleState(), hi, {}, snap))
    assert (got[0][0], sorted(got[0][1]), got[0][2]) == (
        best.node_name, sorted(v.key for v in best.victims),
        best.num_pdb_violations)
    assert len(got[0][1]) == 3


def test_batch_escape_tallies_match_jax(pallas_off):
    """The dispatch's per-(plugin, reason) escape tallies (what the
    scheduler adds to scheduler_tpu_escape_total) equal the JAX backend's:
    a Gt node-affinity pod the encoder does not carry, a nominated pod
    whose nominated node has no room (its per-pod re-proof), and plain
    pods that place."""
    from test_torch_backend import jax_side
    from torch_cases import outcome, port_side
    got = {}
    for name, s in (("jax", jax_side(8)), ("port", port_side(8))):
        s.cache.add_node(s.node("full", cpu="1", mem="2Gi"))
        s.cache.add_node(s.node("roomy", cpu="8", mem="16Gi"))
        s.cache.add_pod(s.pod("resident", node="full", cpu="900m"))
        t = s.testing
        gt = t.make_pod("gt").req(cpu="100m").build()
        gt["spec"]["affinity"] = {"nodeAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": {
                "nodeSelectorTerms": [{"matchExpressions": [
                    {"key": "rack", "operator": "Gt", "values": ["3"]}]}]}}}
        nominated = t.make_pod("nom").req(cpu="500m").build()
        nominated["status"] = {"nominatedNodeName": "full"}
        pods = [s.pod("plain-0", cpu="100m"), gt, nominated,
                s.pod("plain-1", cpu="100m")]
        res = s.backend.dispatch(s.infos(pods), s.snapshot())()
        got[name] = (outcome(res), s.backend.drain_escape_reasons())
        assert s.backend.drain_escape_reasons() == {}
    assert got["port"] == got["jax"]
    assert got["port"][1] == {("NodeAffinity", "gt_lt_operator"): 1,
                              ("DefaultPreemption", "nominated_node_stale"): 1}


# -- the remote seam (tests/test_preempt_batch.py TestRemoteSeamParity) ------

@pytest.fixture(params=["http", "grpc"])
def seam_workers(request, pallas_off):
    """A port worker (CPU) and a JAX worker over the same transport,
    stopped in the finalizer."""
    pytest.importorskip("grpc")
    from kubernetes_tpu.ops import remote as jax_remote
    from kubernetes_tpu_torch.ops import remote as port_remote
    started = {}
    try:
        started[PORT_PKG] = port_remote.make_worker(request.param,
                                                    device="cpu").start()
        started[JAX] = (jax_remote.GrpcDeviceWorker() if request.param ==
                        "grpc" else jax_remote.DeviceWorker()).start()
        yield started
    finally:
        for w in started.values():
            w.stop()


def remote_cluster(testing):
    nodes = [testing.make_node(f"n{i}").capacity(cpu="2", mem="8Gi").build()
             for i in range(4)]
    victims = [testing.make_pod(f"v{i}").priority(1 + i % 3)
               .req(cpu=f"{400 + 200 * (i % 3)}m").node(f"n{i % 4}").build()
               for i in range(10)]
    pre = [testing.make_pod(f"p{j}").priority(10).req(cpu="1800m").build()
           for j in range(4)]
    return nodes, victims, pre


def remote_side(pkg, worker):
    """`pkg`'s Side with its synced backend swapped for a remote client on
    `worker`."""
    nodes, victims, pre = remote_cluster(
        importlib.import_module(f"{pkg}.testing"))
    side = Side(pkg, nodes, victims)
    remote_mod = importlib.import_module(f"{pkg}.ops.remote")
    caps = importlib.import_module(f"{pkg}.ops.flatten").Caps(**SMALL_CAPS)
    cls = (remote_mod.RemoteTPUBatchBackend if pkg == JAX
           else remote_mod.RemoteTorchBatchBackend)
    local = side.backend
    side.backend = cls(worker.url, caps, batch_size=8)
    side.backend.assign([], side.snap)
    return side, local, pre


@pytest.mark.parametrize("kill", [False, True],
                         ids=["remote_matches_local", "kill_resync"])
def test_remote_seam_preempt_matches_jax(seam_workers, kill):
    """The dry run over the wire: the victim tensors ride /static, the
    kernel runs worker-side through /preempt, and the answers equal the
    in-process backend's and the JAX package's over its own worker.  With
    kill: the worker restarts between two waves, the client's resync
    replays the victim-carrying static checkpoint, and the second wave
    answers as the first."""
    got = {}
    for pkg in (PORT_PKG, JAX):
        side, local, pre = remote_side(pkg, seam_workers[pkg])
        try:
            first = side.wave(pre)
            if kill:
                seam_workers[pkg].simulate_restart()
                second = side.wave(pre)
                assert side.backend.seam_stats["resyncs"] >= 1
                assert second == first
            side.backend, remote = local, side.backend
            want = side.wave(pre)
        finally:
            remote.close()
        assert first == want and first[1] == {}
        got[pkg] = first
    assert got[PORT_PKG] == got[JAX]
