"""Seeded inputs shared by the kubernetes_tpu_torch tests.

Imports neither jax nor kubernetes_tpu, so the CUDA cases
(tests/test_torch_cuda.py) run on a machine without them; the parity tests
feed the same inputs to the JAX package (the scheduler loop's Stack builds
either package's control plane by name and imports it then).
"""

import importlib
import threading
import time

import numpy as np

import kubernetes_tpu_torch.scheduler.cache as port_cache
import kubernetes_tpu_torch.scheduler.types as port_types
import kubernetes_tpu_torch.testing as port_testing
from kubernetes_tpu_torch.ops import backend as port_backend
from kubernetes_tpu_torch.ops.flatten import Caps

# -- claims kernel: tests/test_pallas_kernels.py's shapes and edge cases ----

R = 6
SHAPES = [(8, 64), (20, 700), (130, 520)]


def random_case(P, N):
    """tests/test_pallas_kernels.py's generator for shape (P, N)."""
    rng = np.random.default_rng(P * 1000 + N)
    req = rng.uniform(0, 4, (P, R)).astype(np.float32)
    req[:, 3:] = 0
    alloc = rng.uniform(2, 16, (N, R)).astype(np.float32)
    alloc[:, 3:] = 0
    used = rng.uniform(0, 4, (N, R)).astype(np.float32)
    used[:, 3:] = 0
    return dict(req=req, req_nz=req.copy(), active=rng.random(P) > 0.1,
                alloc=alloc, used=used, used_nz=used.copy(),
                npods=rng.integers(0, 5, N).astype(np.float32),
                maxpods=np.full(N, 110, np.float32),
                smask=rng.random((P, N)) > 0.25)


def no_feasible_case():
    P, N = 9, 130
    return dict(req=np.full((P, R), 100.0, np.float32),
                req_nz=np.full((P, R), 100.0, np.float32),
                active=np.ones(P, bool), alloc=np.ones((N, R), np.float32),
                used=np.zeros((N, R), np.float32),
                used_nz=np.zeros((N, R), np.float32),
                npods=np.zeros(N, np.float32),
                maxpods=np.full(N, 10, np.float32),
                smask=np.ones((P, N), bool))


def scalar_gate_case():
    # pod wants 1 unit of scalar resource r=3; only node 1 has it
    P, N = 1, 200
    req = np.zeros((P, R), np.float32)
    req[0, 3] = 1.0
    alloc = np.zeros((N, R), np.float32)
    alloc[:, :2] = 8.0
    alloc[1, 3] = 2.0
    return dict(req=req, req_nz=req.copy(), active=np.ones(P, bool),
                alloc=alloc, used=np.zeros((N, R), np.float32),
                used_nz=np.zeros((N, R), np.float32),
                npods=np.zeros(N, np.float32),
                maxpods=np.full(N, 10, np.float32),
                smask=np.ones((P, N), bool))


def wide_case(P, N, R_, seed):
    """random_case's distributions over R_ resource columns, all of them
    requested, with a 4-pod cap so that full nodes appear."""
    rng = np.random.default_rng(seed)
    req = rng.uniform(0, 4, (P, R_)).astype(np.float32)
    used = rng.uniform(0, 4, (N, R_)).astype(np.float32)
    return dict(req=req, req_nz=req.copy(), active=rng.random(P) > 0.1,
                alloc=rng.uniform(2, 16, (N, R_)).astype(np.float32),
                used=used, used_nz=used.copy(),
                npods=rng.integers(0, 5, N).astype(np.float32),
                maxpods=np.full(N, 4, np.float32),
                smask=rng.random((P, N)) > 0.25)


def identical_nodes_case(P, N, same_pods):
    """Every node alike, so every feasible cell of a pod ties on score and
    the noise with the first-index rule decides; with same_pods every pod
    requests alike too (the kernel's shared-fit path)."""
    c = random_case(P, N)
    c["alloc"][:, :3] = 16.0
    c["used"][:, :3] = 1.0
    c["used_nz"] = c["used"].copy()
    c["npods"][:] = 1
    if same_pods:
        c["req"][:] = c["req"][0]
    c["req"] *= 0.3
    c["req_nz"] = c["req"].copy()
    return c


def dead_tiles_case():
    """A compacted tail's shape: few live pods, so whole pod tiles of the
    kernel (1,024 pods at 8 per thread) hold no live pod."""
    c = random_case(2600, 96)
    c["active"][:] = False
    c["active"][[0, 3, 5, 17, 40, 1000, 2100, 2599]] = True
    return c


CLAIMS_CASES = {f"{P}x{N}": (lambda P=P, N=N: random_case(P, N))
                for P, N in SHAPES}
CLAIMS_CASES["no_feasible"] = no_feasible_case
CLAIMS_CASES["scalar_gate"] = scalar_gate_case
# the CUDA kernel's edges: P and N off every tile and slice multiple, ties
# on every node (prune + first index), dead pod tiles, R at both ends
CLAIMS_CASES["67x2053"] = lambda: random_case(67, 2053)
CLAIMS_CASES["identical_nodes"] = lambda: identical_nodes_case(70, 900, True)
CLAIMS_CASES["identical_nodes_mixed_pods"] = \
    lambda: identical_nodes_case(45, 700, False)
CLAIMS_CASES["dead_tiles"] = dead_tiles_case
CLAIMS_CASES["r2"] = lambda: wide_case(50, 300, 2, 1)
CLAIMS_CASES["r16"] = lambda: wide_case(37, 301, 16, 2)


def run_claims(c, noise, device="cpu", fn=None, nodes=None, node_offset=0):
    """One claims call (the wrapper by default) on case `c`; `nodes`, a
    slice of the node axis, runs it on those nodes only, at
    `node_offset`."""
    import torch
    from kubernetes_tpu_torch.ops import kernels
    fn = kernels.claims if fn is None else fn

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    n = slice(None) if nodes is None else nodes
    static = kernels.prepare_static(t(c["req"]), t(c["req_nz"]),
                                    t(c["alloc"][n]), t(c["maxpods"][n]),
                                    t(c["smask"][:, n].T))
    kw = {"node_offset": node_offset} if node_offset else {}
    idx, best = fn(static, t(c["active"]), t(c["used"][n]),
                   t(c["used_nz"][n]), t(c["npods"][n]), noise=noise, **kw)
    return idx.cpu().numpy(), best.cpu().numpy()


# -- the plain step: one resident state and one packed batch --------------
#
# Request data are integer milli-CPU and byte counts that are multiples of
# 2^20, as real pods encode (flatten.py _encode_resource), so every
# per-node sum is exact in f32.

STEP_CAPS = dict(l_cap=8, kl_cap=8, t_cap=4, pt_cap=4, s_cap=1, sg_cap=2,
                 asg_cap=2, c_cap=2)
K_CAP = 16
# (n_cap, p_cap, identical nodes, seed, row patches)
STEP_CASES = {
    "identical": (64, 40, True, 1, False),
    "mixed": (64, 40, False, 2, False),
    "identical_tail": (256, 700, True, 3, False),
    "mixed_tail_patched": (256, 700, False, 4, True),
}


class Batch:
    """The PodBatch fields the plain wire format reads."""


def make_step_case(n_cap, p_cap, identical, seed):
    caps = Caps(n_cap=n_cap, **STEP_CAPS)
    rng = np.random.default_rng(seed)
    R_, N, P = caps.r, n_cap, p_cap
    n_real = N - 3                      # padding rows stay invalid
    alloc = np.zeros((N, R_), np.float32)
    used = np.zeros((N, R_), np.float32)
    maxpods = np.zeros(N, np.float32)
    if identical:                       # the noise decides every claim
        alloc[:n_real, 0] = 4000
        alloc[:n_real, 1] = 16 * 2**30
        maxpods[:n_real] = 8
    else:
        alloc[:n_real, 0] = rng.integers(1, 9, n_real) * 1000
        alloc[:n_real, 1] = rng.integers(2, 33, n_real) * 2**30
        used[:n_real, 0] = rng.integers(0, 8, n_real) * 100
        used[:n_real, 1] = rng.integers(0, 16, n_real) * 2**26
        maxpods[:n_real] = 110
    valid = np.zeros(N, bool)
    valid[:n_real] = True
    taint = np.zeros((N, caps.t_cap), np.float32)
    taint[rng.random(N) < 0.1, 0] = 1
    state = {"used": used, "used_nz": used.copy(),
             "npods": rng.integers(0, 2, N).astype(np.float32) * valid,
             "port_mask": np.zeros((N, caps.pt_cap), np.float32),
             "cd_sg": np.zeros((caps.sg_cap, N), np.float32),
             "cd_asg": np.zeros((caps.asg_cap, N), np.float32),
             "gen": np.int32(5)}
    static = {"alloc": alloc, "maxpods": maxpods, "valid": valid,
              "taint_mask": taint}
    b = Batch()
    b.req = np.zeros((P, R_), np.float32)
    b.req[:, 0] = rng.integers(1, 10, P) * 100
    b.req[:, 1] = rng.integers(1, 8, P) * 2**27
    b.req_nz = b.req.copy()
    b.p_valid = rng.random(P) < 0.95
    b.untol_hard = np.zeros((P, caps.t_cap), np.float32)
    b.untol_hard[rng.random(P) < 0.5, 0] = 1
    return caps, state, static, b


def step_patches(caps):
    rows = np.array([1, 4, 7], np.int32)
    vals = np.zeros((3, 2 * caps.r + 1 + caps.pt_cap), np.float32)
    vals[:, 0] = 300
    vals[:, caps.r] = 300
    vals[:, 1] = 2**30
    vals[:, caps.r + 1] = 2**30
    vals[:, 2 * caps.r] = 2
    return rows, vals


def run_port_step(caps, p_cap, state, static, buf, noise, device="cpu"):
    """The port's step from `state`: (state arrays, result) as numpy."""
    import torch
    from kubernetes_tpu_torch.models import assign, carry
    fn, _spec = assign.build_packed_assign_fn(
        caps, p_cap, K_CAP, features=assign.PLAIN_FEATURES,
        claims_noise=noise, device=device)
    st, stat = carry.state_from_reference(state, static, device)
    st, res = fn(st, stat, torch.from_numpy(buf).to(device))
    st_np, _ = carry.state_to_numpy(st)
    return st_np, res.cpu().numpy()


# -- the backend: one scheduling stack per package -------------------------

CAPS = dict(n_cap=16, l_cap=64, kl_cap=32, t_cap=8, pt_cap=8, s_cap=2,
            sg_cap=8, asg_cap=8)
SEQ_CAPS = dict(CAPS, n_cap=64)
SEQ_BATCH = 24


class Side:
    """One package's scheduling stack: Cache, PodInfo, builders, backend."""

    def __init__(self, cache_mod, types, testing, backend, flush_first):
        self.cache_mod, self.types, self.testing = cache_mod, types, testing
        self.backend, self.flush_first = backend, flush_first
        self.cache = cache_mod.Cache()

    def node(self, name, **cap):
        return self.testing.make_node(name).capacity(**cap).build()

    def pod(self, name, node=None, **req):
        w = self.testing.make_pod(name).req(**req)
        return (w.node(node) if node else w).build()

    def snapshot(self):
        return self.cache.update_snapshot(self.cache_mod.Snapshot())

    def infos(self, pods):
        return [self.types.PodInfo(p) for p in pods]

    def assume(self, pods, results):
        """The scheduler's batch tail: bulk-assume every placed pod."""
        items = []
        for pod, (name, _st) in zip(pods, results):
            if name:
                bound = {**pod, "spec": {**pod["spec"], "nodeName": name}}
                items.append((bound, self.types.PodInfo(bound)))
        assert not any(self.cache.assume_pods(items))


def port_side(batch_size, caps=CAPS, device="cpu", noise="murmur", **kw):
    """The port's stack; `kw` go to TorchBatchBackend (weights,
    full_batch_cap, full_main_waves)."""
    return Side(port_cache, port_types, port_testing,
                port_backend.TorchBatchBackend(Caps(**caps),
                                               batch_size=batch_size,
                                               device=device,
                                               claims_noise=noise, **kw),
                port_backend.FLUSH_FIRST)


def outcome(results):
    return [(name, None if st is None else st.code) for name, st in results]


def sequence(s, depth=1):
    """Six batches over a growing cluster, returning each batch's outcome
    and the backend's stats: batch 1 is clean, pods of batch 0 are deleted
    before batch 2 (row patches), a node is added before batch 3 (static
    patch) and a watchdog cancel forces a full refresh before batch 5.
    depth=2 dispatches each batch before resolving the previous one, the
    way the scheduler pipelines: batch 1 overlaps batch 0, batch 2 rides
    the pipeline fenced, batch 3 meets FLUSH_FIRST and drains first."""
    rng = np.random.default_rng(11)
    for i in range(20):
        s.cache.add_node(s.node(f"n{i}", cpu=str(int(rng.integers(2, 9))),
                                mem=f"{int(rng.integers(4, 17))}Gi",
                                pods=int(rng.integers(4, 12))))
    view = s.cache.flatten_view()
    batches = [[s.pod(f"b{k}-{i}", cpu=f"{int(rng.integers(1, 9)) * 100}m",
                      mem=f"{int(rng.integers(1, 9)) * 128}Mi")
                for i in range(SEQ_BATCH)] for k in range(6)]
    results = {}
    pending = None   # (k, resolve) of the batch in flight

    def finish(k, resolve):
        results[k] = resolve()
        s.assume(batches[k], results[k])

    for k in range(6):
        if depth == 1 or k == 5:
            if pending is not None:
                finish(*pending)
                pending = None
        if k == 2:     # delete assumed pods of batch 0: their rows patch
            for pod, (name, _st) in list(zip(batches[0], results[0]))[:6]:
                if name:
                    s.cache.forget_pod({**pod, "spec": {**pod["spec"],
                                                        "nodeName": name}})
        elif k == 3:
            s.cache.add_node(s.node("n-late", cpu="16", mem="64Gi"))
        elif k == 5:   # watchdog cancel: full refresh on the next dispatch
            s.backend.abandon_wave()
        resolve = s.backend.dispatch(s.infos(batches[k]), view)
        if resolve is s.flush_first:
            finish(*pending)
            pending = None
            resolve = s.backend.dispatch(s.infos(batches[k]), view)
        if pending is not None:
            finish(*pending)
        pending = (k, resolve)
    finish(*pending)
    return [outcome(results[k]) for k in range(6)], s.backend.stats


# -- the full (constraint) step: seeded clusters and constraint batches ----
#
# Nodes and pods are plain dicts built from a seed; the port's encoder
# (ops/flatten.py, a copy of the JAX package's) turns them into the
# resident state, the static arrays and a packed batch.  Nodes share one
# capacity (unless the case name ends in "varied"), so the noise decides
# among equally scored nodes.

FULL_CAPS = dict(n_cap=64, l_cap=32, kl_cap=16, t_cap=8, pt_cap=8, s_cap=1,
                 sg_cap=8, asg_cap=8, g_cap=2, kg_cap=2, c_cap=2, ns_cap=8)
FULL_P = 48
FULL_P_TAIL = 600           # > TAIL_P: the JAX cohort and compacted tail run
ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
NAMESPACES = {"team-a": {"team": "dev"}, "team-b": {"team": "dev"},
              "team-c": {"team": "ops"}}


def _expr(key, op, values=None):
    e = {"key": key, "operator": op}
    if values is not None:
        e["values"] = list(values)
    return e


def _node_affinity(pod, *exprs):
    pod["spec"].setdefault("affinity", {})["nodeAffinity"] = {
        "requiredDuringSchedulingIgnoredDuringExecution": {
            "nodeSelectorTerms": [{"matchExpressions": list(exprs)}]}}


def _pod_term(pod, kind, key, match, weight=None, ns_match=None):
    term = {"topologyKey": key, "labelSelector": {"matchLabels": match}}
    if ns_match is not None:
        term["namespaceSelector"] = {"matchLabels": ns_match}
    aff = pod["spec"].setdefault("affinity", {}).setdefault(kind, {})
    if weight is None:
        aff.setdefault("requiredDuringSchedulingIgnoredDuringExecution",
                       []).append(term)
    else:
        aff.setdefault("preferredDuringSchedulingIgnoredDuringExecution",
                       []).append({"weight": weight, "podAffinityTerm": term})


def _full_nodes(rng, n, testing, prefer_taints=False, varied=False):
    out = []
    for i in range(n):
        cpu, mem = "16", "64Gi"
        if varied:
            cpu = f"{int(rng.integers(4, 33))}"
            mem = f"{int(rng.integers(8, 129))}Gi"
        w = (testing.make_node(f"n{i}").capacity(cpu=cpu, mem=mem,
                                                 pods=40)
             .zone("abc"[i % 3]).labels(**{HOST: f"n{i}"})
             .labels(disk="ssd" if rng.random() < 0.5 else "hdd",
                     tier="abc"[int(rng.integers(0, 3))]))
        if rng.random() < 0.3:
            w.labels(gpu="yes")
        if prefer_taints:
            for t in ("spot", "old"):
                if rng.random() < 0.4:
                    w.taint(t, "", "PreferNoSchedule")
        if rng.random() < 0.05:
            w.taint("dedicated", "db", "NoSchedule")
        out.append(w.build())
    return out


def _existing(rng, testing, nodes, n, anti=False, ns=False):
    pods = []
    for i in range(n):
        namespace = (str(rng.choice(list(NAMESPACES))) if ns else "default")
        p = (testing.make_pod(f"e{i}", namespace)
             .req(cpu=f"{int(rng.integers(1, 20)) * 50}m",
                  mem=f"{int(rng.integers(1, 40)) * 64}Mi")
             .labels(app=str(rng.choice(["web", "db", "cache"])))
             .node(nodes[int(rng.integers(0, len(nodes)))]["metadata"]["name"])
             .build())
        if anti and rng.random() < 0.6:
            _pod_term(p, "podAntiAffinity", HOST, {"app": "web"})
        pods.append(p)
    return pods


def _case_selectors(rng, i, testing):
    p = testing.make_pod(f"p{i}").req(cpu=f"{int(rng.integers(1, 9)) * 100}m",
                                      mem="256Mi").build()
    k = i % 6
    if k == 0:
        p["spec"]["nodeSelector"] = {"disk": "ssd"}
    elif k == 1:
        _node_affinity(p, _expr("tier", "In", ["a", "b"]))
    elif k == 2:
        _node_affinity(p, _expr("tier", "NotIn", ["c"]))
    elif k == 3:
        _node_affinity(p, _expr("gpu", "Exists"))
    elif k == 4:
        _node_affinity(p, _expr("gpu", "DoesNotExist"),
                       _expr("disk", "In", ["hdd"]))
    return p


def _case_prefer(rng, i, testing):
    w = testing.make_pod(f"p{i}").req(cpu="300m", mem="256Mi")
    if i % 3 == 0:
        w.toleration("spot", effect="PreferNoSchedule", operator="Exists")
    if i % 5 == 0:
        w.toleration("dedicated", "db", "NoSchedule")
    return w.build()


def _case_pin(rng, i, testing):
    w = testing.make_pod(f"p{i}").req(cpu="2", mem="1Gi")
    if i % 2 == 0:
        w.node(f"n{int(rng.integers(0, 6))}")
    return w.build()


def _case_ports(rng, i, testing):
    return (testing.make_pod(f"p{i}").req(cpu="100m", mem="64Mi")
            .host_port(int(rng.choice([8080, 9090, 7070]))).build())


def _case_spread(rng, i, testing):
    return (testing.make_pod(f"p{i}").req(cpu="100m", mem="64Mi")
            .labels(app="s")
            .topology_spread(ZONE, max_skew=1, match_labels={"app": "s"})
            .build())


def _case_anti(rng, i, testing):
    return (testing.make_pod(f"p{i}").req(cpu="100m", mem="64Mi")
            .labels(app="anti")
            .pod_affinity(HOST, {"app": "anti"}, anti=True).build())


def _case_anti_existing(rng, i, testing):
    w = testing.make_pod(f"p{i}").req(cpu="200m", mem="64Mi")
    if i % 2 == 0:
        w.labels(app="web")
    else:
        w.pod_affinity(HOST, {"app": "db"}, anti=True)
    return w.build()


def _case_affinity(rng, i, testing):
    w = testing.make_pod(f"p{i}").req(cpu="200m", mem="64Mi")
    if i % 3 == 0:      # self-affine group: the first needs the bootstrap
        w.labels(app="grp").pod_affinity(ZONE, {"app": "grp"})
    elif i % 3 == 1:    # affinity to existing pods
        w.pod_affinity(ZONE, {"app": "db"})
    return w.build()


def _case_preferred(rng, i, testing):
    p = testing.make_pod(f"p{i}").req(cpu="200m", mem="64Mi").build()
    if i % 2 == 0:
        _pod_term(p, "podAffinity", ZONE, {"app": "cache"},
                  weight=int(rng.integers(1, 100)))
    else:
        _pod_term(p, "podAntiAffinity", HOST, {"app": "web"},
                  weight=int(rng.integers(1, 100)))
    return p


def _case_spread_soft(rng, i, testing):
    # ScheduleAnyway over zones and hosts against existing app=web pods,
    # so the domain counts (and the spread weight) differ across nodes
    return (testing.make_pod(f"p{i}").req(cpu="100m", mem="64Mi")
            .labels(app="web")
            .topology_spread(HOST if i % 2 else ZONE, max_skew=1,
                             when="ScheduleAnyway",
                             match_labels={"app": "web"}).build())


def _case_scores(rng, i, testing):
    # varied requests on varied nodes: the fit score, not the noise,
    # decides most claims (the fused multiply-add of kernels.fit_score)
    return (testing.make_pod(f"p{i}")
            .req(cpu=f"{int(rng.integers(1, 40)) * 25}m",
                 mem=f"{int(rng.integers(1, 64)) * 32}Mi")
            .labels(app="web")
            .topology_spread(ZONE, max_skew=3, when="ScheduleAnyway",
                             match_labels={"app": "web"}).build())


def _case_ns(rng, i, testing):
    ns = str(rng.choice(list(NAMESPACES) + ["default"]))
    p = (testing.make_pod(f"p{i}", ns).req(cpu="100m", mem="64Mi")
         .labels(app=str(rng.choice(["web", "db"]))).build())
    if i % 2 == 0:
        _pod_term(p, "podAntiAffinity", HOST, {"app": "web"},
                  ns_match={"team": "dev"})
    else:
        _pod_term(p, "podAffinity", ZONE, {"app": "db"},
                  ns_match={"team": "dev"})
    return p


def _case_mixed(rng, i, testing):
    maker = [_case_selectors, _case_prefer, _case_ports, _case_spread,
             _case_anti, _case_preferred, _case_spread_soft][i % 7]
    return maker(rng, i, testing)


def _case_close(rng, i, testing):
    # identical requests with a selector every node passes: the nodes'
    # scores lie within the noise of each other (see make_full_case), so
    # the noise and the scores' last bits decide the claims together
    p = testing.make_pod(f"p{i}").req(cpu="100m", mem="128Mi").build()
    _node_affinity(p, _expr("disk", "Exists"))
    return p


# name -> (pod builder, pods, nodes, existing pods, existing anti terms,
#          namespaced, PreferNoSchedule taints, row patches); "varied"
# nodes differ in capacity, "gated" namespace masks close some columns
# (the step's namespace fold then decides, as on a stale host encoding)
FULL_CASES = {
    "selectors": (_case_selectors, FULL_P, 40, 0, False, False, False, False),
    "prefer_taints": (_case_prefer, FULL_P, 40, 0, False, False, True, False),
    "node_name_pin": (_case_pin, FULL_P, 40, 0, False, False, False, False),
    "host_ports": (_case_ports, FULL_P, 12, 0, False, False, False, False),
    "spread_hard_tail": (_case_spread, FULL_P_TAIL, 60, 30, False, False,
                         False, False),
    "anti_hostname": (_case_anti, FULL_P, 40, 0, False, False, False, False),
    "anti_existing": (_case_anti_existing, FULL_P, 20, 24, True, False, False,
                      False),
    "affinity_bootstrap": (_case_affinity, FULL_P, 30, 6, False, False, False,
                           False),
    "preferred": (_case_preferred, FULL_P, 30, 20, False, False, False, False),
    "spread_soft": (_case_spread_soft, FULL_P, 30, 20, False, False, False,
                    False),
    "ns_selector": (_case_ns, FULL_P, 20, 20, False, True, False, False),
    "ns_selector_gated": (_case_ns, FULL_P, 20, 20, False, True, False,
                          False),
    "scores_varied": (_case_scores, FULL_P_TAIL, 60, 90, False, False, True,
                      False),
    "scores_close": (_case_close, FULL_P_TAIL, 60, 0, False, False, False,
                     False),
    "mixed_patched": (_case_mixed, FULL_P, 40, 10, True, False, True, True),
}


def _case_every_kind(rng, i, testing):
    maker = [_case_selectors, _case_prefer, _case_pin, _case_ports,
             _case_spread, _case_anti, _case_affinity, _case_preferred,
             _case_spread_soft, _case_ns][i % 10]
    return maker(rng, i, testing)


# the snapshot form's own cases (FULL_CASES' layout): every constraint
# kind, host ports, PreferNoSchedule taints, nodeName pins and
# namespaceSelector terms in one batch, beside existing pods in several
# namespaces (anti-affinity terms against them, of existing pods or of
# batch pods, would push the namespaced pods past c_cap: anti_existing
# and mixed_patched carry those)
SNAPSHOT_CASES = {
    "every_kind": (_case_every_kind, FULL_P, 40, 20, False, True, True,
                   False),
    "every_kind_tail": (_case_every_kind, FULL_P_TAIL, 60, 30, False, True,
                        True, False),
}


def make_full_case(name, seed=0, n_nodes=None):
    """(caps, state, static, batch, patches) for FULL_CASES[name] (or
    SNAPSHOT_CASES[name]): the state and static numpy arrays from the
    port's ClusterTensors, the batch from its BatchEncoder (no pod
    escapes), the row patches (or None) for the buffer.  `n_nodes`
    overrides the case's node count (n_cap grows to hold them)."""
    from kubernetes_tpu_torch.ops.flatten import BatchEncoder, ClusterTensors
    if name in FULL_CASES:
        spec, base = FULL_CASES[name], sorted(FULL_CASES).index(name) * 100
    else:
        spec = SNAPSHOT_CASES[name]
        base = 10_000 + sorted(SNAPSHOT_CASES).index(name) * 100
    build, P, n_nodes_case, n_exist, anti, ns, prefer, patched = spec
    rng = np.random.default_rng(base + seed)
    n_nodes = n_nodes or n_nodes_case
    caps = Caps(**dict(FULL_CAPS, n_cap=max(FULL_CAPS["n_cap"],
                                            -(-n_nodes // 64) * 64)))
    cache = port_cache.Cache()
    nodes = _full_nodes(rng, n_nodes, port_testing, prefer,
                        varied=name.endswith("varied"))
    for n in nodes:
        cache.add_node(n)
    for p in _existing(rng, port_testing, nodes, n_exist, anti, ns):
        cache.add_pod(p)
    if name == "scores_close":   # node i holds (i+1) milli-CPU and MiB
        for i, n in enumerate(nodes):
            cache.add_pod(port_testing.make_pod(f"c{i}")
                          .req(cpu=f"{i + 1}m", mem=f"{i + 1}Mi")
                          .node(n["metadata"]["name"]).build())
    t = ClusterTensors(caps)
    for nm, labels in NAMESPACES.items():
        t.note_namespace({"apiVersion": "v1", "kind": "Namespace",
                          "metadata": {"name": nm, "labels": labels}})
    pods = [port_types.PodInfo(build(rng, i, port_testing))
            for i in range(P)]
    t.update_from_snapshot_tracked(cache.flatten_view())
    batch = BatchEncoder(t, P).encode(pods)
    assert not batch.escape, batch.escape_reasons
    cd_sg, cd_asg = t.domain_base_counts()
    state = {"used": t.used.copy(), "used_nz": t.used_nz.copy(),
             "npods": t.npods.copy(), "port_mask": t.port_mask.copy(),
             "cd_sg": cd_sg, "cd_asg": cd_asg, "gen": np.int32(3)}
    static = {k: getattr(t, k).copy() for k in (
        "alloc", "maxpods", "valid", "taint_mask", "label_mask", "key_mask",
        "dom_sg", "dom_asg", "sg_ns_mask", "asg_ns_mask")}
    if name.endswith("gated"):
        for k in ("sg_ns_mask", "asg_ns_mask"):
            static[k] = (static[k] * (rng.random(static[k].shape) < 0.5)
                         ).astype(np.float32)
    patches = None
    if patched:
        rows = np.array([1, 4, 7], np.int32)
        vals = np.zeros((3, 2 * caps.r + 1 + caps.pt_cap), np.float32)
        vals[:, 0] = 8000
        vals[:, caps.r] = 8000
        vals[:, 1] = 2**33
        vals[:, caps.r + 1] = 2**33
        vals[:, 2 * caps.r] = 3
        vals[0, 2 * caps.r + 1] = 1     # a host port taken on row 1
        patches = (rows, vals)
    return caps, state, static, batch, patches


def snapshot_node(state, static):
    """The snapshot form's whole node arrays from a case's state and
    static dicts (every key but gen)."""
    return {**static, **{k: v for k, v in state.items() if k != "gen"}}


def run_port_full_step(caps, p_cap, state, static, buf, device="cpu",
                       weights=None):
    """The port's full step from `state`: (state arrays, result) numpy."""
    import torch
    from kubernetes_tpu_torch.models import assign, carry
    fn, _spec = assign.build_packed_assign_fn(
        caps, p_cap, K_CAP, weights, features=assign.ALL_FEATURES,
        device=device)
    st, stat = carry.state_from_reference(state, static, device)
    st, res = fn(st, stat, torch.from_numpy(buf).to(device))
    st_np, _ = carry.state_to_numpy(st)
    return st_np, res.cpu().numpy()


# -- batched preemption: the dry run (K7) and the candidate rows (K8) ------
#
# Arguments in the JAX programs' order, numpy, from a seed.  Requests are
# integer milli-CPU-like counts, except with wide=True: floats over many
# magnitudes, where the order of every f32 sum shows.

I32_MAX = 2**31 - 1


def dry_run_case(P, N, V, R, G, T, seed, wide=False):
    """Nodes with PAD slots, PDB bits, overflow rows, 0/1 taints and G
    groups of nominations; pods with inactive rows and priorities at the
    clamp bounds and above 2^24 (victims' too)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    alloc = rng.integers(1, 9, (N, R)).astype(f) * 1000
    used = rng.integers(0, 8, (N, R)).astype(f) * 500
    vreq = rng.integers(0, 6, (N, V, R)).astype(f) * 300
    if wide:
        alloc = (rng.standard_normal((N, R))
                 * 10.0 ** rng.integers(-2, 6, (N, R))).astype(f)
        vreq = np.abs(rng.standard_normal((N, V, R))
                      * 10.0 ** rng.integers(-3, 6, (N, V, R))).astype(f)
    vprio = rng.integers(-5, 20, (N, V)).astype(np.int32)
    vprio[rng.random((N, V)) < 0.1] = rng.integers(2**25, I32_MAX - 2)
    vprio[rng.random((N, V)) < 0.05] = -I32_MAX + 1      # the clamp floor
    vprio[rng.random((N, V)) < 0.3] = I32_MAX            # PAD slots
    prio = rng.integers(0, 25, P).astype(np.int32)
    prio[rng.random(P) < 0.1] = rng.integers(2**25, I32_MAX - 1)
    prio[rng.random(P) < 0.2] = I32_MAX - 1              # the clamp ceiling
    return (alloc, used, rng.integers(0, 6, N).astype(f),
            rng.integers(3, 10, N).astype(f), rng.random(N) < 0.9,
            (rng.random((N, T)) < 0.2).astype(f), vprio, vreq,
            (rng.random((N, V)) < 0.3).astype(f), rng.random(N) < 0.05,
            (rng.integers(0, 3, (G, N, R)) * 400).astype(f),
            rng.integers(0, 2, (G, N)).astype(f),
            rng.integers(0, G, P).astype(np.int32),
            (rng.integers(0, 8, (P, R)) * 400).astype(f), prio,
            (rng.random((P, T)) < 0.3).astype(f), rng.random(P) < 0.85)


def flatten_dry_run_case(P, N, V, R, T, seed, lead=0):
    """Dry-run inputs shaped as ops/flatten.py writes them
    (_encode_vict_row): each node's slots ascending by priority, PAD
    (I32_MAX, request 0, no PDB bit) at the tail, invalid rows all PAD,
    overflow only on full rows; the pods drawn from five templates as a
    FitError wave is, each pod's group the rank of its priority.  Covers
    runs of one template across the 64-pod block edge with inactive pods
    inside, interleaved templates (the key changes pod to pod), two
    templates of one priority with different requests, nodes with no live
    slot and nodes with all V live, pod priorities between the slots' (only
    a prefix eligible), and equal-priority slots that differ only in their
    PDB bit (the reprieve order departs from slot order).  lead > 0 puts
    that many pods of the first template (no untolerated taint) first, so
    that the first 64-pod chunk has none and a later one has."""
    rng = np.random.default_rng(seed)
    f = np.float32
    live = rng.integers(0, V + 1, N)
    live[:3], live[3:6] = 0, V
    valid = rng.random(N) < 0.9
    valid[:6] = True
    live[~valid] = 0
    levels = np.array([-3, 0, 2, 5, 8, 2**25 + 3, 2**26 + 1], np.int32)
    vprio = np.full((N, V), I32_MAX, np.int32)
    vreq = np.zeros((N, V, R), f)
    vpdb = np.zeros((N, V), f)
    for n in range(N):
        k = live[n]
        vprio[n, :k] = np.sort(rng.choice(levels, k, p=[.1, .3, .15, .2, .1,
                                                        .1, .05]))
        vreq[n, :k] = rng.integers(0, 6, (k, R)) * 250
        vpdb[n, :k] = rng.random(k) < 0.4
    over = (live == V) & (rng.random(N) < 0.5)
    over[3] = False
    npods = (live + rng.integers(0, 3, N)).astype(f)
    maxpods = npods + rng.integers(0, 4, N).astype(f)
    taint = (rng.random((N, T)) < 0.2) & (rng.random((N, 1)) < 0.3)

    tpl_prio = np.array([6, 6, 1, 9, 2**26 + 7], np.int32)
    tpl_req = (rng.integers(0, 8, (5, R)) * 400).astype(f)
    tpl_untol = rng.random((5, T)) < 0.2
    tpl_untol[:3] = False
    seq = [0] * lead
    seq += [i % 2 for i in range(20)]         # one priority, two requests
    seq += [(3, 4, 2)[i % 3] for i in range(20)]  # keys change pod to pod
    seq += [0] * 60                           # a run across pod 64
    seq = np.array((seq + list(rng.integers(0, 5, P)))[:P])
    active = rng.random(P) < 0.9
    active[[i + lead for i in (45, 63, 64, 70) if i + lead < P]] = False
    prio = tpl_prio[seq]
    groups = np.unique(prio)
    G = len(groups)
    return (rng.integers(2, 9, (N, R)).astype(f) * 1000,
            rng.integers(0, 8, (N, R)).astype(f) * 500, npods, maxpods,
            valid, taint.astype(f), vprio, vreq, vpdb, over,
            (rng.integers(0, 3, (G, N, R)) * 400
             * (rng.random((G, N, 1)) < 0.3)).astype(f),
            (rng.integers(0, 2, (G, N))
             * (rng.random((G, N)) < 0.3)).astype(f),
            np.searchsorted(groups, prio).astype(np.int32), tpl_req[seq],
            prio, tpl_untol[seq].astype(f), active)


# name -> (generator, arguments).  dry_run_case's (P, N, V, R, G, T, seed,
# wide): ragged N, P of 1 / 37 / 70, V of 8 / 16 / 32, R of 2-12, T past
# one 32-bit word; flatten_dry_run_case's (P, N, V, R, T, seed[, lead]):
# two to four 64-pod blocks, V of 16 and 32
DRY_RUN_CASES = {
    "37x1000": (dry_run_case, (37, 1000, 16, 6, 3, 8, 1, False)),
    "1x503_v8_r5": (dry_run_case, (1, 503, 8, 5, 1, 4, 2, False)),
    "70x300_r8_wide": (dry_run_case, (70, 300, 16, 8, 2, 31, 3, True)),
    "20x200_v32_t40": (dry_run_case, (20, 200, 32, 5, 2, 40, 4, False)),
    "3x130_r2": (dry_run_case, (3, 130, 16, 2, 1, 1, 5, False)),
    "66x257_r12_t64": (dry_run_case, (66, 257, 16, 12, 3, 64, 6, False)),
    "flat_130x90": (flatten_dry_run_case, (130, 90, 16, 6, 16, 21)),
    "flat_200x64_t40": (flatten_dry_run_case, (200, 64, 16, 6, 40, 22)),
    "flat_v32_90x70_r5": (flatten_dry_run_case, (90, 70, 32, 5, 8, 23)),
    "flat_late_taints_200x60": (flatten_dry_run_case,
                                (200, 60, 16, 6, 16, 24, 70)),
}


def dry_run_inputs(name):
    """The numpy inputs of DRY_RUN_CASES[name]."""
    gen, args = DRY_RUN_CASES[name]
    return gen(*args)


def candidates_case(P, N, R, G, seed, ties=False, wide=False):
    """K8's inputs.  ties=True makes every node alike with 100,000
    reclaimable pods, so a pod's scores differ only by the hash term (at
    most 0.1), and the f32 spacing at 100,000 (2^-7) rounds that to a
    dozen values: most scores tie and the node index decides (past 2^16
    nodes the hash itself repeats too)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    alloc = rng.integers(1, 9, (N, R)).astype(f) * 1000
    used = (alloc * rng.uniform(0.5, 1.0, (N, R))).astype(f)
    rec = (rng.integers(0, 4, (G, N, R)) * 350).astype(f)
    rec_np = rng.integers(0, 4, (G, N)).astype(f)
    if ties:
        alloc[:], used[:], rec[:], rec_np[:] = 4000, 3600, 1800, 1e5
    if wide:
        alloc = (rng.uniform(0, 1, (N, R))
                 * 10.0 ** rng.integers(-3, 9, (N, R))).astype(f)
        used = (alloc * rng.uniform(0, 1.2, (N, R))).astype(f)
        rec = (rng.uniform(0, 1, (G, N, R))
               * 10.0 ** rng.integers(-3, 9, (G, N, R))).astype(f)
    return (alloc, used, rng.integers(0, 8, N).astype(f),
            rng.integers(4, 10, N).astype(f), rng.random(N) < 0.95, rec,
            rec_np, rng.integers(0, G, P).astype(np.int32),
            (rng.integers(0, 6, (P, R)) * 500).astype(f),
            rng.random(P) < 0.9)


# (P, N, R, G, seed, ties, wide, k)
CANDIDATE_CASES = {
    "37x1000": (37, 1000, 6, 3, 1, False, False, 16),
    "ties_256x700": (256, 700, 6, 1, 2, True, False, 16),
    "ties_300x5000": (300, 5000, 6, 1, 5, True, False, 16),
    "ties_hash_wrap": (3, 70_000, 6, 1, 6, True, False, 16),
    "k_past_feasible": (5, 40, 5, 2, 3, False, False, 40),
    "wide": (64, 3000, 8, 2, 4, False, True, 16),
}


def port_tensors(args, device="cpu"):
    import torch
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in args]


# -- the scheduler loop: one package's control plane, stepped by hand ------

PORT_PKG = "kubernetes_tpu_torch"
LOOP_CAPS = dict(n_cap=64, l_cap=64, kl_cap=32, t_cap=8, pt_cap=8, s_cap=2,
                 sg_cap=8, asg_cap=8)


def code_of(path):
    """The module's AST with every docstring taken out."""
    import ast
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:]
    return ast.dump(tree)


def wait_for(predicate, timeout=30.0, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


class Stack:
    """One package's control plane: store, client, informers, default
    framework and a Scheduler whose one profile holds that package's batch
    backend (the port's on `device`, at murmur noise).  `pkg` names the
    package; only the JAX side's tests pass "kubernetes_tpu".  `backend`
    replaces the default backend (a sharded one, say)."""

    def __init__(self, pkg, batch_size, caps=LOOP_CAPS, depth=1, device="cpu",
                 backend=None, **backend_kw):
        def m(name):
            return importlib.import_module(f"{pkg}.{name}")
        self.pkg = pkg
        self.kv, self.meta, self.testing = m("store.kv"), m("api.meta"), \
            m("testing")
        clientset = m("client.clientset")
        self.NODES, self.PODS = clientset.NODES, clientset.PODS
        client_mod, sched_mod = m("client"), m("scheduler")
        caps = m("ops.flatten").Caps(**caps)
        backends = m("ops.backend")
        if backend is not None:
            self.backend = backend
        elif pkg == "kubernetes_tpu":
            self.backend = backends.TPUBatchBackend(
                caps, batch_size=batch_size, **backend_kw)
        else:
            self.backend = backends.TorchBatchBackend(
                caps, batch_size=batch_size, device=device,
                claims_noise="murmur", **backend_kw)
        self.store = self.kv.MemoryStore()
        self.client = client_mod.LocalClient(self.store)
        self.factory = client_mod.SharedInformerFactory(self.client)
        fw = sched_mod.new_default_framework(self.client, self.factory)
        self.profile = sched_mod.Profile(fw, batch_backend=self.backend,
                                         batch_size=batch_size)
        self.sched = sched_mod.Scheduler(
            self.client, self.factory, {"default-scheduler": self.profile},
            pipeline_depth=depth)

    def load(self, make_nodes, make_pods):
        """Create the objects (builders get this package's testing kit),
        start the informers and wait until the cache holds every node and
        the active queue every pod."""
        nodes, pods = make_nodes(self.testing), make_pods(self.testing)
        for n in nodes:
            self.client.create(self.NODES, n)
        for p in pods:
            self.client.create(self.PODS, p)
        self.factory.start()
        self.factory.wait_for_cache_sync()
        assert wait_for(lambda: self.sched.cache.node_count() == len(nodes)
                        and self.sched.queue.stats()["active"] == len(pods))
        return len(pods)

    def node_milli_cpu(self, name):
        """Allocatable CPU of a node as the scheduler's cache holds it."""
        snapshot = importlib.import_module(
            f"{self.pkg}.scheduler.cache").Snapshot()
        ni = self.sched.cache.update_snapshot(snapshot).get(name)
        return ni.allocatable.milli_cpu

    def schedule_all(self, n):
        """Pop the batch and schedule it (the loop thread is not running)."""
        batch = self.sched.queue.pop_batch(n, timeout=0)
        assert len(batch) == n
        self.sched.schedule_batch(self.profile, batch)

    def stop(self):
        self.sched.stop()   # drains the binder worker inline
        self.factory.stop()

    def outcome(self):
        """{pod: (nodeName, PodScheduled reason or None)} from the store."""
        pods, _ = self.store.list(self.PODS)
        out = {}
        for p in pods:
            reason = next((c.get("reason") for c in
                           (p.get("status") or {}).get("conditions") or ()
                           if c.get("type") == "PodScheduled"), None)
            out[self.meta.name(p)] = (self.meta.pod_node_name(p) or None,
                                      reason)
        return out


def mixed_nodes(seed, n):
    def make(testing):
        rng = np.random.default_rng(seed)
        return [testing.make_node(f"n{i}")
                .capacity(cpu=str(int(rng.integers(2, 9))),
                          mem=f"{int(rng.integers(4, 17))}Gi",
                          pods=int(rng.integers(8, 40))).build()
                for i in range(n)]
    return make


def mixed_pods(seed, n, prefix="p"):
    def make(testing):
        rng = np.random.default_rng(seed)
        return [testing.make_pod(f"{prefix}{i:04d}")
                .req(cpu=f"{int(rng.integers(1, 9)) * 50}m",
                     mem=f"{int(rng.integers(1, 9)) * 64}Mi").build()
                for i in range(n)]
    return make


def grow_cpu(node):
    for key in ("capacity", "allocatable"):
        node["status"][key]["cpu"] = "64"
    return node


def pipelined_run(pkg, deadline=None, n_batches=4, per_batch=24,
                  device="cpu"):
    """n_batches batches stepped through schedule_step at depth 2; a node
    joins after the first dispatch (the second dispatch then meets
    FLUSH_FIRST with the first batch in flight), and a node is resized
    after the second (the MODIFIED event reaches the backend through
    note_node_event before the third dispatch).  With `deadline` the
    overload watchdog resolves every wave on a wave-resolve thread.
    Returns the outcome, the backend's stats and the names of the threads
    resolve() ran on."""
    s = Stack(pkg, per_batch, depth=2, device=device)
    # the scheduler retires an in-flight batch early once its residency
    # passes an adaptive flight estimate (0.25 s at start), so on a loaded
    # host batch 0 could retire inside its own schedule_step and the
    # second dispatch would find nothing in flight; an infinite estimate
    # keeps every batch in the pipeline until the depth or a flush
    # retires it, which is the order this run is about
    s.sched._flight_est = float("inf")
    threads = set()
    if pkg == PORT_PKG:
        dispatch = s.backend.dispatch

        def traced_dispatch(infos, view):
            resolve = dispatch(infos, view)
            if not callable(resolve):
                return resolve

            def traced():
                threads.add(threading.current_thread().name)
                return resolve()
            return traced
        s.backend.dispatch = traced_dispatch
    if deadline is not None:
        cfg = importlib.import_module(f"{pkg}.scheduler.config")
        s.sched.configure_overload(cfg.OverloadPolicy(
            engagement="always", queue_cap=0, slo_p99_ms=0.0,
            escape_rate_threshold=0.0, wave_deadline=deadline))
    try:
        n = s.load(mixed_nodes(9, 10),
                   mixed_pods(10, n_batches * per_batch))
        late = s.testing.make_node("late").capacity(cpu="16",
                                                     mem="32Gi").build()
        for k in range(n_batches):
            assert s.sched.schedule_step(timeout=0) == per_batch
            if k == 0:
                s.client.create(s.NODES, late)
                assert wait_for(
                    lambda: s.sched.cache.node_count() == 11)
            elif k == 1:
                s.client.guaranteed_update(s.NODES, "", "n0", grow_cpu)
                assert wait_for(lambda: s.node_milli_cpu("n0") == 64000)
        s.sched._flush_pending()
        assert n == n_batches * per_batch
    finally:
        s.stop()
    return s.outcome(), dict(s.backend.stats), threads


# -- bench --instances: the parameters a run passes, recorded ---------------

class _SpecRecorder:
    """make_node / make_pod stand-in: records the spec, builds a name."""

    def __init__(self, rec, name, *_args):
        self.rec, self.name = rec, name

    def capacity(self, **kw):
        self.rec["node_spec"].add(tuple(sorted(kw.items())))
        return self

    def req(self, **kw):
        self.rec["pod_spec"].add(tuple(sorted(kw.items())))
        return self

    def build(self):
        return self.name


def record_scaleout(monkeypatch, pkg, bench_mod, run):
    """Call `run()` (bench.py's run_scaleout or the port's, from
    `bench_mod`) with `pkg`'s store, client, harness, make_node, make_pod
    and the bench module's sleep replaced by recorders: nothing is built and no
    scheduler runs; every pass binds all its pods at once.  Returns (what
    run() returned, the record): per pass the store's arguments, the
    caps_for_nodes argument, each instance's setup_cluster arguments (the
    store as the pass's index) and ScaleOutPolicy, the sleeps, and the
    sizes of the node and pod chunks with the node and pod specs."""
    import dataclasses

    def m(name):
        return importlib.import_module(f"{pkg}.{name}")
    rec = {"stores": [], "caps": [], "clusters": [], "policies": [],
           "sleeps": [], "nodes": [], "pods": [], "node_spec": set(),
           "pod_spec": set()}

    class Store:
        def __init__(self, **kw):
            self.index = len(rec["stores"])
            rec["stores"].append(kw)

    class Client:
        def __init__(self, store):
            self.store = store

        def create_bulk(self, resource, objs):
            rec[resource].append(len(objs))

    class Scheduler:
        def __init__(self, kw):
            self.kw = kw

        def configure_scaleout(self, policy):
            rec["policies"].append(dataclasses.asdict(policy))

        def expose_metrics(self):
            return ""

    class Cluster:
        def __init__(self, kw):
            self.scheduler = Scheduler(kw)

        def shutdown(self):
            pass

    def setup_cluster(**kw):
        kw["store"] = kw["store"].index
        rec["clusters"].append(kw)
        return Cluster(kw)

    class Collector:
        def __init__(self, store):
            pass

        def start(self):
            pass

        def stop(self):
            pass

        def bound_total(self):
            return sum(rec["pods"])

    class Clock:
        monotonic = staticmethod(time.monotonic)

        @staticmethod
        def sleep(s):
            rec["sleeps"].append(s)

    def caps_for_nodes(n):
        rec["caps"].append(n)
        return ("caps", n)

    monkeypatch.setattr(m("store.kv"), "MemoryStore", Store)
    monkeypatch.setattr(m("client.clientset"), "LocalClient", Client)
    monkeypatch.setattr(m("perf.scheduler_perf"), "setup_cluster",
                        setup_cluster)
    monkeypatch.setattr(m("perf.scheduler_perf"), "ThroughputCollector",
                        Collector)
    monkeypatch.setattr(m("perf"), "caps_for_nodes", caps_for_nodes)
    for name in ("make_node", "make_pod"):
        monkeypatch.setattr(m("testing"), name,
                            lambda *a, **_k: _SpecRecorder(rec, *a))
    monkeypatch.setattr(bench_mod, "time", Clock)
    return run(), rec
