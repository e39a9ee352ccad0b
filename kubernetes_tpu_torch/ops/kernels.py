"""The claims kernel: fused mask + score + noise + per-pod argmax.

Counterpart of kubernetes_tpu/ops/pallas_kernels.py.  One call computes,
for every (pod, node) cell, resource fit over R resources and the pod-count
cap, the static mask and the pod's active bit, LeastAllocated +
BalancedAllocation over cpu/mem, and a deterministic tie-break noise; then,
per pod, the lowest node index among the maxima of `score + noise` over the
feasible nodes.  It returns claims int32[P] (-1 when no node is feasible)
and best f32[P] (NEG when none is).

`claims()` launches the hand-written CUDA kernel (csrc/claims.cu) for CUDA
tensors and runs `claims_reference`, the same function in plain torch, for
CPU tensors.  On CUDA a build or launch failure raises; it never falls back.
Each launch adds one to `LAUNCHES["claims"]`, a module-level count that a
caller wrapping `claims` cannot move.

Two noise rules, chosen by the `noise` argument:
  "sin"    - the Pallas kernel's fract(sin(gp*12.9898 + gn*78.233) *
             43758.5453) * 1e-3 (pallas_kernels.py:121-128).  f32 sin of
             large arguments differs in the last bits between
             implementations; the kernel and the plain version both take
             the correctly rounded one (f64 sin, rounded), so they agree,
             but the reference's may differ by an ulp, and one ulp moves
             the noise by ~2.6e-6: against the reference this rule is held
             by tolerance, never bit for bit.
  "murmur" - the XLA wave body's murmur3-finalizer hash at 0.05 / 2^24
             (models/assign.py:331-338): integer arithmetic, reproducible
             bit for bit on any device.
The noise is keyed on (pod_ids[p], node index); pod_ids defaults to
arange(P).  The compacted tail passes the pods' original batch positions.

XLA, compiling the JAX reference on the CPU, contracts a*b + c*d into
fma(a, b, c*d).  The score and the sin argument here (and in the CUDA
kernel) fuse exactly those products, so both noise rules see the
reference's scores bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

NEG = -1e9
SIN_NOISE = 1e-3        # pallas_kernels.TIE_NOISE
MURMUR_NOISE = 0.05     # models/assign.TIE_NOISE
NOISE_KINDS = ("sin", "murmur")
_M32 = 0xFFFFFFFF
# pods per chunk of the plain version: bounds its [chunk, N] planes
_REF_CELLS = 1 << 25
# the mask's row stride is P rounded up to this many bytes, so that the
# kernel reads every pod group's bytes of a node row with one aligned
# vector load (csrc/claims.cu)
MASK_ALIGN = 16
# kernel launches by kernel name, counted where each wrapper launches
# (the preempt kernel's wrapper is models/preempt.py)
LAUNCHES = {"claims": 0, "preempt": 0}


def mask_stride(P: int) -> int:
    return -(-P // MASK_ALIGN) * MASK_ALIGN


def prepare_static(req, req_nz, alloc, maxpods, smask_t):
    """Batch-invariant inputs, built ONCE per batch outside the wave loop.

    req, req_nz f32[P, R]; alloc f32[N, R]; maxpods f32[N]; smask_t is the
    static mask node-major, [N, P], as bool or uint8 (stored as uint8: the
    Pallas f32 [P, N] plane is 4x the bytes for the same bits).  The stored
    mask is [N, mask_stride(P)]: pad columns are 0 (infeasible), and the
    rows start 16-byte aligned.  At a P that is already a multiple of 16
    (the wave's 16,384 and the tail's 512) nothing is copied."""
    P, R = req.shape
    N = alloc.shape[0]
    if smask_t.shape != (N, P):
        raise ValueError(f"smask_t shape {tuple(smask_t.shape)} != {(N, P)}")
    smask_t = smask_t.to(torch.uint8).contiguous()
    ld = mask_stride(P)
    if ld != P or smask_t.data_ptr() % MASK_ALIGN:
        padded = torch.zeros((N, ld), dtype=torch.uint8,
                             device=smask_t.device)
        padded[:, :P] = smask_t
        smask_t = padded
    return {
        "req": req.contiguous().float(),
        "req_nz": req_nz.contiguous().float(),
        "alloc": alloc.contiguous().float(),
        "maxpods": maxpods.contiguous().float(),
        "smask_t": smask_t,
        "shape": (P, N, R),
    }


def _mul32(x, c: int):
    """(x * c) mod 2^32 for int64 x in [0, 2^32): split so no product
    leaves int64 (torch has no usable uint32 arithmetic)."""
    return ((x * (c & 0xFFFF)) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def murmur_noise(pod_ids, n_nodes: int):
    """f32[len(pod_ids), n_nodes] murmur3-finalizer noise, bit-equal to
    the JAX package's uint32 formula (models/assign.py:331-338)."""
    dev = pod_ids.device
    pp = pod_ids.to(torch.int64)[:, None]
    gn = torch.arange(n_nodes, dtype=torch.int64, device=dev)[None, :]
    hx = _mul32(pp, 0x9E3779B1) ^ _mul32(gn, 0x85EBCA77)
    hx ^= hx >> 16
    hx = _mul32(hx, 0x85EBCA6B)
    hx ^= hx >> 13
    hx = _mul32(hx, 0xC2B2AE35)
    hx ^= hx >> 16
    scale = torch.tensor(MURMUR_NOISE / (1 << 24), dtype=torch.float32,
                         device=dev)
    return (hx >> 8).to(torch.float32) * scale


def fma32(a, b, c):
    """f32 fused multiply-add a * b + c with one rounding, through f64:
    the product of two f32 values is exact in f64, and for the operands
    this module passes (score terms in [0, 200], sin arguments below 2^24
    built from integer pod/node ids) the f64 sum is exact too, so the one
    rounding to f32 is the fma's."""
    return (a.double() * b.double() + c.double()).float()


def sin_noise(pod_ids, n_nodes: int):
    """f32[len(pod_ids), n_nodes] sin-hash noise of the Pallas kernel.
    The argument is fma(gn, 78.233, gp * 12.9898): the reference kernel,
    compiled by XLA on the CPU, fuses the node term's product into the
    sum (unfused, some cells get another argument and so an unrelated
    noise).  sin itself is taken in f64 and rounded to f32, i.e. the
    correctly rounded f32 sin: torch's f32 sin on the CPU is not
    reproducible from run to run (a thread's chunk can come back ~1e-4
    off), and the f64 route is."""
    dev = pod_ids.device
    gp = pod_ids.to(torch.float32)[:, None]
    gn = torch.arange(n_nodes, dtype=torch.float32, device=dev)[None, :]
    c2 = torch.tensor(78.233, dtype=torch.float32, device=dev)
    arg = fma32(gn, c2, gp * 12.9898)
    h = torch.sin(arg.double()).float() * 43758.5453
    return (h - torch.floor(h)) * SIN_NOISE


def fit_score(ucpu, umem):
    """LeastAllocated + BalancedAllocation from the cpu/mem utilizations:
    (2 - ucpu - umem) * 50 + (1 - |ucpu - umem| * 0.5) * 100, with the
    first product fused into the sum — exactly how the reference's XLA
    compilation on the CPU evaluates it (it contracts a*b + c*d into
    fma(a, b, c*d)), so the murmur rule stays bit-identical to it."""
    fifty = torch.tensor(50.0, dtype=torch.float32, device=ucpu.device)
    return fma32(2.0 - ucpu - umem, fifty,
                 (1.0 - torch.abs(ucpu - umem) * 0.5) * 100.0)


def utilizations(req_nz, alloc, used_nz):
    """cpu and mem utilizations [rows, N] after adding each row's request:
    min(used + request, alloc) / alloc per node, 1 where alloc is 0."""
    one = torch.ones((), dtype=torch.float32, device=alloc.device)
    utils = []
    for r in range(2):
        a = alloc[None, :, r]
        u = used_nz[None, :, r] + req_nz[:, r, None]
        utils.append(torch.where(
            a > 0, torch.minimum(u / torch.clamp(a, min=1.0), one), one))
    return utils


def _check_noise(noise: str) -> None:
    if noise not in NOISE_KINDS:
        raise ValueError(f"noise={noise!r}: must be one of {NOISE_KINDS}")


def claims_reference(static, active, used, used_nz, npods, noise="sin",
                     pod_ids=None):
    """Plain torch version of the claims kernel (same arguments and
    results as `claims`), computed in pod chunks of [chunk, N] planes."""
    _check_noise(noise)
    P, N, R = static["shape"]
    dev = used.device
    if pod_ids is None:
        pod_ids = torch.arange(P, dtype=torch.int32, device=dev)
    req, req_nz = static["req"], static["req_nz"]
    alloc, maxpods, smask_t = static["alloc"], static["maxpods"], static["smask_t"]
    avail = alloc - used
    cap_ok = (npods + 1.0 <= maxpods)[None, :]
    claims_out = torch.empty(P, dtype=torch.int32, device=dev)
    best_out = torch.empty(P, dtype=torch.float32, device=dev)
    step = max(1, _REF_CELLS // max(N, 1))
    for lo in range(0, P, step):
        hi = min(P, lo + step)
        fit = cap_ok
        for r in range(R):
            fit = fit & (req[lo:hi, r, None] <= avail[None, :, r])
        mask = (smask_t[:, lo:hi].T != 0) & fit & active[lo:hi, None].bool()
        score = fit_score(*utilizations(req_nz[lo:hi], alloc, used_nz))
        ids = pod_ids[lo:hi]
        nz = murmur_noise(ids, N) if noise == "murmur" else sin_noise(ids, N)
        masked = torch.where(mask, score + nz,
                             torch.full((), NEG, dtype=torch.float32,
                                        device=dev))
        best, idx = torch.max(masked, dim=1)   # first index of the max
        claims_out[lo:hi] = torch.where(best > NEG / 2, idx,
                                        torch.full_like(idx, -1)).int()
        best_out[lo:hi] = best
    return claims_out, best_out


_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from . import _build
        lib = _build.load("claims")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.claims_launch.argtypes = [p] * 10 + [i] * 4 + [p] * 5
        lib.claims_launch.restype = i
        lib.claims_num_slices.argtypes = [i, i]
        lib.claims_num_slices.restype = i
        lib.claims_max_resources.restype = i
        _lib = lib
    return _lib


def _require(t, name, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"claims: {name} must be a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {device}; got {t.dtype} {tuple(t.shape)} "
            f"on {t.device}")


def claims(static, active, used, used_nz, npods, noise="sin",
           pod_ids=None):
    """Fused mask+score+argmax -> (claims int32[P], best f32[P]).

    static comes from prepare_static; active is bool[P]; used/used_nz
    f32[N, R]; npods f32[N]; pod_ids int32[P] keys the noise (default
    arange(P)).  CPU tensors run claims_reference; CUDA tensors launch
    csrc/claims.cu and count the launch in `LAUNCHES["claims"]`."""
    _check_noise(noise)
    dev = used.device
    if dev.type == "cpu":
        return claims_reference(static, active, used, used_nz, npods, noise,
                                pod_ids)
    if dev.type != "cuda":
        raise ValueError(f"claims: unsupported device {dev}")
    P, N, R = static["shape"]
    lib = _kernel_lib()
    if R > lib.claims_max_resources():
        raise ValueError(f"claims: R={R} resources exceeds the kernel's "
                         f"{lib.claims_max_resources()}")
    if pod_ids is None:
        pod_ids = torch.arange(P, dtype=torch.int32, device=dev)
    f32 = torch.float32
    _require(static["req"], "req", f32, (P, R), dev)
    _require(static["req_nz"], "req_nz", f32, (P, R), dev)
    _require(static["alloc"], "alloc", f32, (N, R), dev)
    _require(static["maxpods"], "maxpods", f32, (N,), dev)
    _require(static["smask_t"], "smask_t", torch.uint8, (N, mask_stride(P)),
             dev)
    if static["smask_t"].data_ptr() % MASK_ALIGN:
        raise ValueError("claims: smask_t must start 16-byte aligned "
                         "(use prepare_static)")
    _require(active, "active", torch.bool, (P,), dev)
    _require(pod_ids, "pod_ids", torch.int32, (P,), dev)
    _require(used, "used", f32, (N, R), dev)
    _require(used_nz, "used_nz", f32, (N, R), dev)
    _require(npods, "npods", f32, (N,), dev)
    # scratch rows: the node slices' partials, then the slices' shared
    # per-pod records
    rows = lib.claims_num_slices(P, N)
    part_best = torch.empty((rows, P), dtype=f32, device=dev)
    part_idx = torch.empty((rows, P), dtype=torch.int32, device=dev)
    out_claims = torch.empty(P, dtype=torch.int32, device=dev)
    out_best = torch.empty(P, dtype=f32, device=dev)
    err = lib.claims_launch(
        static["req"].data_ptr(), static["req_nz"].data_ptr(),
        active.data_ptr(), pod_ids.data_ptr(), static["alloc"].data_ptr(),
        used.data_ptr(), used_nz.data_ptr(), npods.data_ptr(),
        static["maxpods"].data_ptr(), static["smask_t"].data_ptr(),
        P, N, R, int(noise == "murmur"),
        part_best.data_ptr(), part_idx.data_ptr(), out_claims.data_ptr(),
        out_best.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"claims kernel launch failed: cudaError {err}")
    LAUNCHES["claims"] += 1
    return out_claims, out_best
