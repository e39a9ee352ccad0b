"""Batched preemption — the device half of PostFilter.

Counterpart of kubernetes_tpu/models/preempt.py (reference:
pkg/scheduler/framework/preemption/preemption.go, DryRunPreemption :579).
Two device programs:

  K8 `preempt_candidates`: per failed pod, the top-k node rows where
      evicting every lower-priority pod would make it fit (the legacy tier:
      the host Evaluator re-proves each candidate).  Plain torch.
  K7 `preempt_dry_run`: the dry run itself, per (pod, node): evict every
      lower-priority victim, fit-check, then the greedy reprieve
      (PDB-violating victims first, then highest priority, then slot
      order), emitting pickOneNodeForPreemption's key planes and the
      victim masks.  A plain torch version (`preempt_dry_run_reference`,
      step by step the JAX program) and a CUDA kernel (csrc/preempt.cu).

`dry_run_planes` is what the backend calls: the kernel for CUDA tensors
(victims as one int32 bit word per (pod, node), bit v = slot v), the plain
version, packed the same way, for CPU tensors.  On CUDA a build or launch
failure raises; nothing falls back, and nothing but the kernel (and its
output allocations and the overflow plane's memset) runs: the kernel reads
the 0/1 taint planes as they are.  Each kernel launch adds one to
`kernels.LAUNCHES["preempt"]`.

Exactness against the JAX programs, as XLA compiles them on the CPU (their
optimized IR, dumped with XLA_FLAGS=--xla_dump_to, and a probe with
wide-range floats): every sum over victim slots (`freed`, `psum`, `viol`,
`nvic`) and K8's headroom sum over resources is sequential in ascending
index from +0; no product is contracted into an add (K7's products are by
0/1 weights and exact anyway; K8's score is `(headroom * 1e-9 - rec_np)
+ tie * (0.1 / 65536)`, three rounded operations).  `jax.lax.top_k`
returns the lower index first among equal values: a stable descending
sort does the same.  `psum` is an f32 sum of priorities and inexact above
2^24 the way the JAX program's is: same order, same roundings.
"""

from __future__ import annotations

import ctypes

import torch

NEG = -1e30
I32_MAX = 2**31 - 1
EPS = 1e-6
# the victim bit word is 32 bits wide
V_MAX = 32


# -- K8: top-k candidate rows (the legacy tier) ----------------------------

def _tie_noise(P: int, N: int, device) -> torch.Tensor:
    """f32[P, N]: ((p * 2654435761) ^ (n * 40503)) mod 2^16 as f32, the
    JAX program's uint32 hash.  Only the low 16 bits survive the modulus,
    and those of a product do not depend on its bits above 2^32, so int64
    arithmetic gives them exactly."""
    p = torch.arange(P, dtype=torch.int64, device=device)[:, None]
    n = torch.arange(N, dtype=torch.int64, device=device)[None, :]
    return (((p * 2654435761) ^ (n * 40503)) & 0xFFFF).to(torch.float32)


def preempt_candidates(alloc, used, npods, maxpods, valid, reclaim,
                       reclaim_np, group_idx, req, active, k: int):
    """Per failed pod: top-k candidate node rows where preempting every
    lower-priority pod would make it fit.

    alloc/used f32[N,R]; npods/maxpods f32[N]; valid bool[N];
    reclaim f32[G,N,R] and reclaim_np f32[G,N], what each priority group
    can reclaim; group_idx i32[P]; req f32[P,R]; active bool[P].  Returns
    (rows i32[P,k], feasible_count i32[P]) on the inputs' device; rows
    past the feasible candidates are -1."""
    dev = alloc.device
    f32 = torch.float32
    gi = group_idx.long()
    rec = reclaim[gi]                               # [P,N,R]
    rec_np = reclaim_np[gi]                         # [P,N]
    free = alloc[None] - (used[None] - rec)
    fits = (req[:, None, :] <= free + EPS).all(-1)
    fits &= (npods[None] - rec_np + 1.0) <= maxpods[None]
    fits &= valid[None]
    fits &= rec_np > 0.0
    fits &= active[:, None]
    # rank: fewest potential victims first, then per-pod hash noise, then
    # normalized headroom (see the JAX program for why)
    denom = torch.clamp(alloc, min=1e-9)
    headroom = torch.zeros(fits.shape, dtype=f32, device=dev)
    for r in range(alloc.shape[1]):
        headroom = headroom + torch.clamp(free[..., r], min=0.0) / denom[:, r]
    P, N = fits.shape
    tie_scale = torch.tensor(0.1, dtype=f32, device=dev) / 65536.0
    score = (headroom * torch.tensor(1e-9, dtype=f32, device=dev)
             - rec_np) + _tie_noise(P, N, dev) * tie_scale
    score = torch.where(fits, score, torch.tensor(NEG, dtype=f32,
                                                  device=dev))
    vals, rows = torch.sort(score, dim=1, descending=True, stable=True)
    vals, rows = vals[:, :k], rows[:, :k]
    rows = torch.where(vals > NEG / 2, rows, torch.full_like(rows, -1))
    return rows.to(torch.int32), fits.sum(1, dtype=torch.int32)


# -- K7: the dry run --------------------------------------------------------

def reprieve_order(vict_prio, vict_pdb):
    """i64[N, V]: each node's reprieve order, jnp.lexsort((slot, -prio,
    -pdb)): PDB-covered victims first, then highest priority, then slot.
    Stable sorts from the least significant key up."""
    N, V = vict_prio.shape
    order = torch.arange(V, device=vict_prio.device).expand(N, V)
    by_prio = torch.sort(-vict_prio.long(), dim=1, stable=True).indices
    order = order.gather(1, by_prio)
    by_pdb = torch.sort(-vict_pdb.gather(1, order), dim=1, stable=True).indices
    return order.gather(1, by_pdb)


def _sum_slots(x):
    """Sum over the last axis, in ascending index from +0: the order of
    the JAX program's reductions on the CPU."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for v in range(x.shape[-1]):
        acc = acc + x[..., v]
    return acc


def preempt_dry_run_reference(alloc, used, npods, maxpods, valid, taint_mask,
                              vict_prio, vict_req, vict_pdb, vict_over,
                              nom_used, nom_np, group_idx, req, prio,
                              untol_hard, active):
    """The plain torch dry run, step by step the JAX program.

    alloc/used f32[N,R]; npods/maxpods f32[N]; valid bool[N]; taint_mask
    f32[N,T]; vict_prio i32[N,V] (VICT_PAD-filled); vict_req f32[N,V,R];
    vict_pdb f32[N,V]; vict_over bool[N]; nom_used f32[G,N,R] / nom_np
    f32[G,N], the capacity claimed by pods nominated at >= each group's
    priority; group_idx i32[P]; req f32[P,R]; prio i32[P]; untol_hard
    f32[P,T]; active bool[P].  Returns (cand bool[P,N], viol f32[P,N],
    highest i32[P,N], psum f32[P,N], nvic f32[P,N], victims bool[P,N,V],
    overflow_hit bool[P])."""
    P, R = req.shape
    N, V = vict_prio.shape
    dev = alloc.device
    gi = group_idx.long()

    # a PAD slot's priority is I32_MAX, above any clamped real priority,
    # so the single compare also masks empty slots
    elig = vict_prio[None] < prio[:, None, None]                 # [P,N,V]
    eligf = elig.to(torch.float32)
    freed = torch.zeros((P, N, R), dtype=torch.float32, device=dev)
    for v in range(V):                 # the einsum over v, in its order
        freed = freed + eligf[:, :, v, None] * vict_req[None, :, v, :]
    freed_np = _sum_slots(eligf)                                 # [P,N]

    eff_used = used[None] + nom_used[gi]                         # [P,N,R]
    eff_np = npods[None] + nom_np[gi]                            # [P,N]
    taint_ok = (untol_hard @ taint_mask.T) == 0.0                # 0/1: exact

    free0 = alloc[None] - eff_used + freed
    slack0 = maxpods[None] - (eff_np - freed_np)
    fits0 = (req[:, None, :] <= free0 + EPS).all(-1)
    fits0 &= slack0 >= 1.0
    fits0 &= valid[None] & taint_ok
    fits0 &= freed_np > 0.0            # empty `potential` -> no candidate
    fits0 &= active[:, None]

    # greedy re-add in the node's reprieve order: V steps, each "does the
    # preemptor still fit with this victim back?"
    ordv = reprieve_order(vict_prio, vict_pdb)                   # [N,V]
    rows = torch.arange(N, device=dev)
    free, slack = free0, slack0
    reprieved = torch.zeros((P, N, V), dtype=torch.bool, device=dev)
    for s in range(V):
        j = ordv[:, s]                                           # [N]
        elig_j = elig[:, rows, j]                                # [P,N]
        free_try = free - vict_req[rows, j][None]
        ok = elig_j & (req[:, None, :] <= free_try + EPS).all(-1)
        ok &= (slack - 1.0) >= 1.0
        free = torch.where(ok[..., None], free_try, free)
        slack = torch.where(ok, slack - 1.0, slack)
        reprieved[:, rows, j] = ok

    victims = elig & ~reprieved
    victf = victims.to(torch.float32)
    nvic = _sum_slots(victf)
    viol = _sum_slots(victf * vict_pdb[None])
    highest = torch.where(victims, vict_prio[None],
                          torch.tensor(-I32_MAX, dtype=torch.int32,
                                       device=dev)).amax(-1)
    highest = torch.where(nvic > 0.0, highest, torch.zeros_like(highest))
    psum = _sum_slots(victf * vict_prio[None].to(torch.float32))

    # overflow rows carry a truncated victim set: never a candidate here;
    # the caller escapes any preemptor that can reach one
    cand = fits0 & (nvic > 0.0) & ~vict_over[None]
    overflow_hit = (vict_over[None] & valid[None] & taint_ok
                    & active[:, None]).any(1)
    return cand, viol, highest, psum, nvic, victims, overflow_hit


# -- bit words --------------------------------------------------------------

def _to_i32(x):
    """int64 holding an unsigned 32-bit value -> the int32 of its bits."""
    return (x - ((x >> 31) & 1) * (1 << 32)).to(torch.int32)


def pack_bits(mask):
    """bool[..., W] -> int32[..., ceil(W / 32)]: bit b of word w is
    mask[..., 32 w + b]."""
    W = mask.shape[-1]
    words = max(1, -(-W // 32))
    padded = torch.zeros((*mask.shape[:-1], words * 32), dtype=torch.int64,
                         device=mask.device)
    padded[..., :W] = mask.to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=mask.device) \
        << torch.arange(32, device=mask.device)
    return _to_i32((padded.view(*mask.shape[:-1], words, 32)
                    * weights).sum(-1))


def unpack_victims(words, V: int):
    """int32[P,N] victim words -> bool[P,N,V]."""
    shifts = torch.arange(V, dtype=torch.int32, device=words.device)
    return ((words[..., None] >> shifts) & 1).to(torch.bool)


# -- the kernel -------------------------------------------------------------

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from ..ops import _build
        lib = _build.load("preempt")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.preempt_dry_run_launch.argtypes = [p] * 17 + [i] * 8 + [p] * 8
        lib.preempt_dry_run_launch.restype = i
        lib.preempt_occupancy.argtypes = [i, i, i, p]
        lib.preempt_occupancy.restype = i
        lib.preempt_max_resources.restype = i
        lib.preempt_max_taints.restype = i
        _lib = lib
    return _lib


def live_slot_cap(vict_prio) -> int:
    """The kernel's k_cap for these victim slots: the largest count of a
    node's slots whose priority is below I32_MAX (PAD), the only slots
    that can be eligible.  numpy or torch; on a CUDA tensor this syncs."""
    if vict_prio.shape[0] == 0:
        return 0
    return int((vict_prio != I32_MAX).sum(1).max())


def _require(t, name, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"preempt_dry_run: {name} must be a contiguous {dtype} tensor of "
            f"shape {tuple(shape)} on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")


def prepared_launch(alloc, used, npods, maxpods, valid, taint_mask,
                    vict_prio, vict_req, vict_pdb, vict_over, nom_used,
                    nom_np, group_idx, req, prio, untol_hard, active, *,
                    k_cap=None, pods_per_block=None):
    """Check the CUDA inputs and allocate the planes once: returns
    (launch, planes), where each launch() runs csrc/preempt.cu into the
    same planes (cand, viol, highest, psum, nvic, victim words, overflow
    hit) on the current stream and counts one launch.  k_cap: see
    dry_run_planes.  pods_per_block imposes the pods a block walks
    (default: the kernel's grid rule, all P when every node block is
    resident at once, else 64)."""
    from ..ops import kernels
    dev = alloc.device
    P, R = req.shape
    N, V = vict_prio.shape
    G = nom_np.shape[0]
    T = taint_mask.shape[1]
    lib = _kernel_lib()
    if R > lib.preempt_max_resources():
        raise ValueError(f"preempt_dry_run: R={R} resources exceeds the "
                         f"kernel's {lib.preempt_max_resources()}")
    if T > lib.preempt_max_taints():
        raise ValueError(f"preempt_dry_run: T={T} taints exceeds the "
                         f"kernel's {lib.preempt_max_taints()}")
    if not 1 <= V <= V_MAX:
        raise ValueError(f"preempt_dry_run: V={V} victim slots; the kernel "
                         f"takes 1..{V_MAX}")
    if P == 0 or N == 0:
        raise ValueError("preempt_dry_run: empty pod or node axis")
    f32, i32, b = torch.float32, torch.int32, torch.bool
    for t, name, dtype, shape in (
            (alloc, "alloc", f32, (N, R)), (used, "used", f32, (N, R)),
            (npods, "npods", f32, (N,)), (maxpods, "maxpods", f32, (N,)),
            (valid, "valid", b, (N,)), (taint_mask, "taint_mask", f32, (N, T)),
            (vict_prio, "vict_prio", i32, (N, V)),
            (vict_req, "vict_req", f32, (N, V, R)),
            (vict_pdb, "vict_pdb", f32, (N, V)),
            (vict_over, "vict_over", b, (N,)),
            (nom_used, "nom_used", f32, (G, N, R)),
            (nom_np, "nom_np", f32, (G, N)),
            (group_idx, "group_idx", i32, (P,)), (req, "req", f32, (P, R)),
            (prio, "prio", i32, (P,)), (untol_hard, "untol_hard", f32, (P, T)),
            (active, "active", b, (P,))):
        _require(t, name, dtype, shape, dev)
    if k_cap is None:
        k_cap = live_slot_cap(vict_prio)
    if not 0 <= k_cap <= V:
        raise ValueError(f"preempt_dry_run: k_cap={k_cap} outside 0..{V}")
    ppb = 0 if pods_per_block is None else pods_per_block
    if ppb < 0 or (ppb and -(-P // ppb) > 65535):
        raise ValueError(f"preempt_dry_run: pods_per_block={ppb} for P={P}")
    planes = (torch.empty((P, N), dtype=b, device=dev),
              torch.empty((P, N), dtype=f32, device=dev),
              torch.empty((P, N), dtype=i32, device=dev),
              torch.empty((P, N), dtype=f32, device=dev),
              torch.empty((P, N), dtype=f32, device=dev),
              torch.empty((P, N), dtype=i32, device=dev),
              torch.empty(P, dtype=b, device=dev))
    inputs = (alloc, used, npods, maxpods, valid, taint_mask, vict_prio,
              vict_req, vict_pdb, vict_over, nom_used, nom_np, group_idx, req,
              prio, untol_hard, active)

    def launch():
        # the closure holds the tensors whose pointers the kernel reads
        err = lib.preempt_dry_run_launch(
            *(x.data_ptr() for x in inputs), P, N, V, R, G, T, k_cap, ppb,
            *(x.data_ptr() for x in planes),
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(
                f"preempt kernel launch failed: cudaError {err}")
        kernels.LAUNCHES["preempt"] += 1

    return launch, planes


def kernel_occupancy(R: int, T: int, k_cap: int) -> dict:
    """The kernel's launch shape on this card for R resources, T taints
    and k_cap live slots: registers and spill bytes a thread, dynamic
    shared bytes and node rows a block, resident blocks and warps an SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    lib = _kernel_lib()
    out = (ctypes.c_int * 5)()
    err = lib.preempt_occupancy(R, T, k_cap, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"preempt occupancy query failed: cudaError {err}")
    regs, smem, tn, blocks, local = list(out)
    return {"registers": regs, "spill_bytes": local, "smem_bytes": smem,
            "block_rows": tn, "blocks_per_sm": blocks,
            "warps_per_sm": blocks * tn // 32}


def dry_run_planes(alloc, used, npods, maxpods, valid, taint_mask, vict_prio,
                   vict_req, vict_pdb, vict_over, nom_used, nom_np,
                   group_idx, req, prio, untol_hard, active, *, k_cap=None):
    """The dry run with the victims as words: (cand, viol, highest, psum,
    nvic, victim words int32[P,N], overflow_hit), on the inputs' device.
    CUDA tensors launch csrc/preempt.cu; CPU tensors run the plain
    version and pack its victims.

    k_cap sizes the kernel's shared memory: at least live_slot_cap(
    vict_prio), the largest count of a node's non-PAD slots; a caller
    that holds the slots on the host passes it, otherwise it is one
    reduction here (a sync).  A smaller k_cap is a device-side error, not
    a wrong answer.  The kernel skips slots that are not eligible (not
    victims) instead of adding 0 * x for them: the same sums for finite
    requests and PDB values (flatten.py writes no other), not for an
    infinite or NaN one in such a slot."""
    args = (alloc, used, npods, maxpods, valid, taint_mask, vict_prio,
            vict_req, vict_pdb, vict_over, nom_used, nom_np, group_idx, req,
            prio, untol_hard, active)
    dev = alloc.device
    if dev.type == "cuda":
        launch, planes = prepared_launch(*args, k_cap=k_cap)
        launch()
        return planes
    if dev.type != "cpu":
        raise ValueError(f"preempt_dry_run: unsupported device {dev}")
    out = preempt_dry_run_reference(*args)
    return (*out[:5], pack_bits(out[5])[..., 0], out[6])


def preempt_dry_run(alloc, used, npods, maxpods, valid, taint_mask,
                    vict_prio, vict_req, vict_pdb, vict_over, nom_used,
                    nom_np, group_idx, req, prio, untol_hard, active):
    """The JAX program's signature and result tuple (cand, viol, highest,
    psum, nvic, victims bool[P,N,V], overflow_hit): the plain version on
    CPU tensors, the kernel (victim words expanded) on CUDA tensors."""
    args = (alloc, used, npods, maxpods, valid, taint_mask, vict_prio,
            vict_req, vict_pdb, vict_over, nom_used, nom_np, group_idx, req,
            prio, untol_hard, active)
    if alloc.device.type == "cpu":
        return preempt_dry_run_reference(*args)
    out = dry_run_planes(*args)
    return (*out[:5], unpack_victims(out[5], vict_prio.shape[1]), out[6])
