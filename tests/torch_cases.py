"""Seeded inputs shared by the kubernetes_tpu_torch tests.

Imports neither jax nor kubernetes_tpu, so the CUDA cases
(tests/test_torch_cuda.py) run on a machine without them; the parity tests
feed the same inputs to the JAX package.
"""

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


def run_claims(c, noise, device="cpu", fn=None):
    """One claims call (the wrapper by default) on case `c`."""
    import torch
    from kubernetes_tpu_torch.ops import kernels
    fn = kernels.claims if fn is None else fn

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    static = kernels.prepare_static(t(c["req"]), t(c["req_nz"]), t(c["alloc"]),
                                    t(c["maxpods"]), t(c["smask"].T))
    idx, best = fn(static, t(c["active"]), t(c["used"]), t(c["used_nz"]),
                   t(c["npods"]), noise=noise)
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
    fn, _spec = assign.build_packed_assign_fn(caps, p_cap, K_CAP,
                                              claims_noise=noise,
                                              device=device)
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


def port_side(batch_size, caps=CAPS, device="cpu", noise="murmur"):
    return Side(port_cache, port_types, port_testing,
                port_backend.TorchBatchBackend(Caps(**caps),
                                               batch_size=batch_size,
                                               device=device,
                                               claims_noise=noise),
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
