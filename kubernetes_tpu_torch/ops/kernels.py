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
caller wrapping `claims` cannot move; inside `launch_tally()` the launches
of the calling thread go to the tally instead (the device census counts
its own step's launches there and leaves `LAUNCHES` as it found it).

The work one call must do lives here too, beside the kernel: its bytes
(`claims_bytes`) and its operations on given inputs (`claims_work`,
`claims_bounds`), over the peak rates of one H100 below.  chip_smoke.py's
bounds and the backend's device census read these counts.

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
`node_offset` makes the nodes one shard of a longer node axis
(parallel/mesh.py): the murmur node term hashes node_offset + n, so a
shard's noise and claims equal the matching columns of the whole axis'
(JAX's gn = offset + arange(n_loc), models/assign.py:315), while claims
stay local indices.  The sin rule is the single-device Pallas kernel's and
is never sharded (quirk R3): it raises at a non-zero offset.

XLA, compiling the JAX reference on the CPU, contracts a*b + c*d into
fma(a, b, c*d).  The score and the sin argument here (and in the CUDA
kernel) fuse exactly those products, so both noise rules see the
reference's scores bit for bit.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

import numpy as np
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
# each kernel's CUDA symbols, as torch.profiler names their launches
KERNEL_SYMBOLS = {"claims": ("claims_slice_kernel", "claims_fold_kernel"),
                  "preempt": ("dry_run_kernel",)}

# Peak rates of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its
# 700 W power limit): the denominators of every bound computed here.
H100_HBM_BYTES_PER_S = 3.35e12
H100_FP32_OPS_PER_S = 67e12      # FP32 outside the tensor cores
H100_FP64_OPS_PER_S = 34e12      # FP64 outside the tensor cores
# Operations of one claims call, counted three ways (claims_bounds).
#  "first revision": the first kernel revision's definition: per live
#   cell the mask and cap tests and R compares; per feasible cell the
#   utilizations, score, add and running max (SCORE_OPS) and the noise.
#  "candidates" and "required": the work the inputs need.  Per live cell
#   the mask test; per distinct (pod request, node) pair R compares and
#   the cap test, and where they fit the utilizations and score
#   (PAIR_SCORE_OPS); per noisy cell the noise, add and running max.
#   "candidates" takes the noise on every feasible cell within NOISE_MAX
#   of its pod's best score; "required" only on the cells any exact
#   algorithm must evaluate: those whose upper bound fl(score + NOISE_MAX)
#   lies above the pod's answer, or equals it at a lower node index, and
#   the answer itself.
# The noise: f32 operations (murmur's integer hash counted as 14 of its
# 16), and for sin one f64 sin counted as 20 f64 operations.
FIT_OPS_BASE = 2
SCORE_OPS = 20
MASK_OPS = 1
PAIR_SCORE_OPS = 18
PICK_OPS = 2
NOISE_OPS = {"sin": 12, "murmur": 16}
SIN_F64_OPS = {"sin": 20, "murmur": 0}
# the largest value each noise rule returns (csrc/claims.cu NOISE_MAX)
NOISE_MAX = {"sin": np.float32(1e-3),
             "murmur": np.float32(16777215.0) * np.float32(0.05 / 2**24)}

_tally_local = threading.local()


class LaunchTally:
    """The kernel launches (`launches`, by LAUNCHES' names) and the wrapper
    calls (`calls`: (kernel name, {inputs}) in call order) of one thread
    inside `launch_tally()`."""

    def __init__(self):
        self.launches = {name: 0 for name in LAUNCHES}
        self.calls: list[tuple[str, dict]] = []


@contextlib.contextmanager
def launch_tally():
    """Within the block the calling thread's launches count in the yielded
    LaunchTally, not in LAUNCHES, and its wrapper calls are recorded with
    their inputs.  Other threads count as before."""
    prev = getattr(_tally_local, "tally", None)
    tally = _tally_local.tally = LaunchTally()
    try:
        yield tally
    finally:
        _tally_local.tally = prev


def count_launch(name: str) -> None:
    """One launch of kernel `name`: in this thread's tally if one is open,
    else in LAUNCHES.  Called by each wrapper where it launches."""
    tally = getattr(_tally_local, "tally", None)
    (LAUNCHES if tally is None else tally.launches)[name] += 1


def note_call(name: str, **inputs) -> None:
    """Record a wrapper call's inputs in this thread's open tally (no-op
    without one: the main path pays one attribute read)."""
    tally = getattr(_tally_local, "tally", None)
    if tally is not None:
        tally.calls.append((name, inputs))


def bound(nbytes: float, f32_ops: float = 0.0,
          f64_ops: float = 0.0) -> tuple[float, str]:
    """(ms, "bytes" | "operations"): the least time one H100 takes to move
    `nbytes` and to do the operations, the larger of the two."""
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = (f32_ops / H100_FP32_OPS_PER_S
             + f64_ops / H100_FP64_OPS_PER_S) * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


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


def murmur_noise(pod_ids, n_nodes: int, node_offset: int = 0):
    """f32[len(pod_ids), n_nodes] murmur3-finalizer noise of nodes
    node_offset .. node_offset + n_nodes - 1, bit-equal to the JAX
    package's uint32 formula (models/assign.py:331-338)."""
    dev = pod_ids.device
    pp = pod_ids.to(torch.int64)[:, None]
    gn = torch.arange(node_offset, node_offset + n_nodes, dtype=torch.int64,
                      device=dev)[None, :]
    hx = _mul32(pp, 0x9E3779B1) ^ _mul32(gn, 0x85EBCA77)
    hx ^= hx >> 16
    hx = _mul32(hx, 0x85EBCA6B)
    hx ^= hx >> 13
    hx = _mul32(hx, 0xC2B2AE35)
    hx ^= hx >> 16
    # sync-point: a constant uploaded (the full step's noise table is
    # built once)
    scale = torch.tensor(MURMUR_NOISE / (1 << 24), dtype=torch.float32,
                         device=dev)
    return (hx >> 8).to(torch.float32) * scale


def fma32(a, b, c):
    """f32 fused multiply-add a * b + c with one rounding, through f64:
    the product of two f32 values is exact in f64, and for the operands
    this module passes (score terms in [0, 200], sin arguments below 2^24
    built from integer pod/node ids) the f64 sum is exact too, so the one
    rounding to f32 is the fma's.  `b` may be a Python float holding an
    f32 value (a folded constant)."""
    b = b.double() if torch.is_tensor(b) else float(b)
    return (a.double() * b + c.double()).float()


# pi/2 as four parts of 26 significant bits each: k * part is exact in f64
# for |k| < 2^27, so sin64's first reduction step is exact
_PIO2 = (1.5707963109016418, 1.5893254712295857e-08, 6.123233932053594e-17,
         6.368317055225283e-25)
# fdlibm's __kernel_sin and __kernel_cos coefficients (k_sin.c, k_cos.c)
_SIN_C = (-1.66666666666666324348e-01, 8.33333333332248946124e-03,
          -1.98412698298579493134e-04, 2.75573137070700676789e-06,
          -2.50507602534068634195e-08, 1.58969099521155010221e-10)
_COS_C = (4.16666666666666019037e-02, -1.38888888888741095749e-03,
          2.48015872894767294178e-05, -2.75573143513906633035e-07,
          2.08757232129817482790e-09, -1.13596475577881948265e-11)


def _horner(z, coef):
    out = torch.full_like(z, coef[-1])
    for c in coef[-2::-1]:
        out = out * z + c
    return out


def sin64(x):
    """sin of an f64 tensor with |x| < 2^26, within one ulp, from IEEE
    additions and multiplications alone: a Cody-Waite reduction by pi/2
    in four 26-bit parts (the remainder kept as a double-double), then
    fdlibm's sin and cos kernels on [-pi/4, pi/4].  So the answer is the
    same bits on every device and every CPU thread.  torch.sin on f64
    CPU tensors is not: on the H100 machine's CPU, one intra-op thread's
    chunk of a [4096, 5632] plane came back from another code path in
    about one fresh process in ten (ROADMAP Q4)."""
    k = torch.round(x * 0.6366197723675814)
    t = x - k * _PIO2[0]                     # exact
    b = -(k * _PIO2[1])                      # exact
    hi = t + b                               # TwoSum(t, b)
    bb = hi - t
    lo = ((t - (hi - bb)) + (b - bb)) - k * _PIO2[2] - k * _PIO2[3]
    r = hi + lo                              # Fast2Sum: r + y = hi + lo
    y = lo - (r - hi)
    z = r * r
    v = z * r
    s = r - ((z * (0.5 * y - v * _horner(z, _SIN_C[1:]))) - y
             - v * _SIN_C[0])
    zr = z * _horner(z, _COS_C)
    ax = r.abs()
    # fdlibm's qx: |r| / 4 with the low 32 bits cleared, 0.28125 above
    # 0.78125, 0 below 0.3
    q4 = ((ax * 0.25).view(torch.int64) & ~0xFFFFFFFF).view(torch.float64)
    qx = torch.where(ax > 0.78125, torch.full_like(ax, 0.28125),
                     torch.where(ax < 0.3, torch.zeros_like(ax), q4))
    c = (1.0 - qx) - ((0.5 * z - qx) - (z * zr - r * y))
    quad = k.to(torch.int64) & 3
    out = torch.where((quad & 1) == 1, c, s)
    return torch.where(quad >= 2, -out, out)


def sin_noise(pod_ids, n_nodes: int):
    """f32[len(pod_ids), n_nodes] sin-hash noise of the Pallas kernel.
    The argument is fma(gn, 78.233, gp * 12.9898): the reference kernel,
    compiled by XLA on the CPU, fuses the node term's product into the
    sum (unfused, some cells get another argument and so an unrelated
    noise).  sin itself is taken in f64 (sin64) and rounded to f32,
    i.e. the correctly rounded f32 sin but where the f64 value lies
    within an ulp of an f32 rounding boundary: torch's f32 sin on the
    CPU is not reproducible from run to run (a thread's chunk can come
    back ~1e-4 off), and neither, rarely, is its f64 sin."""
    dev = pod_ids.device
    gp = pod_ids.to(torch.float32)[:, None]
    gn = torch.arange(n_nodes, dtype=torch.float32, device=dev)[None, :]
    # sync-point: a constant uploaded (the plain version)
    c2 = torch.tensor(78.233, dtype=torch.float32, device=dev)
    arg = fma32(gn, c2, gp * 12.9898)
    h = sin64(arg.double()).float() * 43758.5453
    return (h - torch.floor(h)) * SIN_NOISE


def fit_score(ucpu, umem, c_fit: float = 50.0, c_bal: float = 100.0):
    """LeastAllocated + BalancedAllocation from the cpu/mem utilizations:
    (2 - ucpu - umem) * c_fit + (1 - |ucpu - umem| * 0.5) * c_bal, with
    the first product fused into the sum — exactly how the reference's XLA
    compilation on the CPU evaluates it (it contracts a*b + c*d into
    fma(a, b, c*d)), so the murmur rule stays bit-identical to it.  The
    constants are 50 * w_fit and 100 * w_bal rounded to f32, as XLA folds
    a score weight into the constant it multiplies (score_constants)."""
    # sync-point: a constant uploaded, once a call (the full step's waves)
    c = torch.tensor(c_fit, dtype=torch.float32, device=ucpu.device)
    return fma32(2.0 - ucpu - umem, c,
                 (1.0 - torch.abs(ucpu - umem) * 0.5) * c_bal)


def score_constants(w: dict) -> tuple[float, float]:
    """(c_fit, c_bal): 50 * w["fit"] and 100 * w["balanced"] rounded to
    f32.  XLA folds w * (x * 50) into x * fl(50 w) before it contracts
    the sum of the two terms (ROADMAP R4, R12); with weights of 1.0 they
    are 50 and 100."""
    return (float(np.float32(50.0) * np.float32(w["fit"])),
            float(np.float32(100.0) * np.float32(w["balanced"])))


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


def _check_noise(noise: str, node_offset: int = 0) -> None:
    if noise not in NOISE_KINDS:
        raise ValueError(f"noise={noise!r}: must be one of {NOISE_KINDS}")
    if node_offset < 0 or (node_offset and noise != "murmur"):
        raise ValueError(f"node_offset={node_offset}: a shard's offset is "
                         "non-negative and takes the murmur noise")


def claims_reference(static, active, used, used_nz, npods, noise="sin",
                     pod_ids=None, node_offset: int = 0):
    """Plain torch version of the claims kernel (same arguments and
    results as `claims`), computed in pod chunks of [chunk, N] planes."""
    _check_noise(noise, node_offset)
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
        nz = (murmur_noise(ids, N, node_offset) if noise == "murmur"
              else sin_noise(ids, N))
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
        lib.claims_launch.argtypes = [p] * 10 + [i] * 5 + [p] * 5
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
           pod_ids=None, node_offset: int = 0):
    """Fused mask+score+argmax -> (claims int32[P], best f32[P]).

    static comes from prepare_static; active is bool[P]; used/used_nz
    f32[N, R]; npods f32[N]; pod_ids int32[P] keys the noise (default
    arange(P)); node_offset is the first node's index on the whole node
    axis when the nodes are one shard of it (murmur only).  CPU tensors
    run claims_reference; CUDA tensors launch csrc/claims.cu and count the
    launch in `LAUNCHES["claims"]`."""
    _check_noise(noise, node_offset)
    note_call("claims", shape=static["shape"], active=active, noise=noise)
    dev = used.device
    if dev.type == "cpu":
        return claims_reference(static, active, used, used_nz, npods, noise,
                                pod_ids, node_offset)
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
    # the launch goes to the tensors' card (a shard's may not be the
    # current one): the library reads the current device
    with torch.cuda.device(dev):
        # scratch rows: the node slices' partials, then the slices' shared
        # per-pod records
        rows = lib.claims_num_slices(P, N)
        part_best = torch.empty((rows, P), dtype=f32, device=dev)
        part_idx = torch.empty((rows, P), dtype=torch.int32, device=dev)
        out_claims = torch.empty(P, dtype=torch.int32, device=dev)
        out_best = torch.empty(P, dtype=f32, device=dev)
        err = lib.claims_launch(
            static["req"].data_ptr(), static["req_nz"].data_ptr(),
            active.data_ptr(), pod_ids.data_ptr(),
            static["alloc"].data_ptr(), used.data_ptr(), used_nz.data_ptr(),
            npods.data_ptr(), static["maxpods"].data_ptr(),
            static["smask_t"].data_ptr(), P, N, R, int(noise == "murmur"),
            node_offset, part_best.data_ptr(), part_idx.data_ptr(),
            out_claims.data_ptr(), out_best.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"claims kernel launch failed: cudaError {err}")
    count_launch("claims")
    return out_claims, out_best


# -- the work of one call ---------------------------------------------------

def claims_bytes(P: int, N: int, R: int) -> int:
    """Bytes one claims call must move: each input read once (the uint8
    mask [N, P], req and req_nz [P, R] f32, active [P] bool, pod_ids [P]
    i32, alloc, used and used_nz [N, R] f32, npods and maxpods [N] f32)
    and each output written once (claims i32 and best f32 [P])."""
    return (N * P + 2 * P * R * 4 + P + P * 4 + 3 * N * R * 4 + 2 * N * 4
            + P * 8)


def claims_work(args, noise, answer):
    """Counts of the work one claims call on these inputs needs: live
    cells, feasible cells, distinct (request, node) pairs and those that
    fit, candidate cells (feasible, score within NOISE_MAX of the pod's
    best score) and required cells (see the operation counts above);
    `args` is (static, active, used, used_nz, npods), `answer` the plain
    version's (claims, best) on the same inputs."""
    static, active, used, used_nz, npods = args
    P, N, R = static["shape"]
    claim, best = answer
    dev = used.device
    avail = static["alloc"] - used
    cap_ok = npods + 1.0 <= static["maxpods"]
    one = torch.ones((), device=dev)
    nmax = torch.tensor(float(NOISE_MAX[noise]), dtype=torch.float32,
                        device=dev)
    node = torch.arange(N, device=dev)[None, :]

    def fits(req):
        fit = cap_ok[None, :].expand(req.shape[0], N)
        for r in range(R):
            fit = fit & (req[:, r, None] <= avail[None, :, r])
        return fit

    def scores(req_nz):
        utils = []
        for r in range(2):
            a = static["alloc"][None, :, r]
            u = used_nz[None, :, r] + req_nz[:, r, None]
            utils.append(torch.where(
                a > 0, torch.minimum(u / torch.clamp(a, min=1.0), one), one))
        return fit_score(*utils)

    live = active.bool()
    uniq = torch.unique(torch.cat([static["req"], static["req_nz"]], 1)[live],
                        dim=0)
    # sync-point: measurement counts, read once per call (not the main path)
    n = {"live": int(live.sum()) * N, "pairs": uniq.shape[0] * N,
         "pairs fit": 0, "feasible": 0, "candidates": 0, "required": 0}
    step = max(1, (1 << 25) // N)
    for lo in range(0, uniq.shape[0], step):
        # sync-point: measurement count
        n["pairs fit"] += int(fits(uniq[lo:lo + step, :R]).sum())
    for lo in range(0, P, step):
        hi = min(P, lo + step)
        fit = (fits(static["req"][lo:hi])
               & (static["smask_t"][:, lo:hi].T != 0) & live[lo:hi, None])
        score = scores(static["req_nz"][lo:hi])
        top = torch.where(fit, score, torch.full_like(score, -3e38)).amax(1)
        upper = score + nmax
        b, c = best[lo:hi, None], claim[lo:hi, None]
        # sync-point: measurement counts
        n["feasible"] += int(fit.sum())
        # sync-point: measurement counts
        n["candidates"] += int((fit & (score + nmax >= top[:, None])).sum())
        # sync-point: measurement counts
        n["required"] += int((fit & ((upper > b) | ((upper == b)
                                                     & (node <= c)))).sum())
    return n


def claims_bounds(args, noise, answer):
    """{"first revision" | "candidates" | "required": (ms, by), "cells":
    counts} for one claims call on these inputs: the larger of the bytes
    it must move (claims_bytes) over HBM bandwidth and its operations,
    counted three ways (above), over the FP32 and FP64 peaks."""
    P, N, R = args[0]["shape"]
    nbytes = claims_bytes(P, N, R)
    n = claims_work(args, noise, answer)
    out = {"first revision": bound(
        nbytes, n["live"] * (FIT_OPS_BASE + R)
        + n["feasible"] * (SCORE_OPS + NOISE_OPS[noise]),
        n["feasible"] * SIN_F64_OPS[noise])}
    needed = (n["live"] * MASK_OPS + n["pairs"] * (R + 1)
              + n["pairs fit"] * PAIR_SCORE_OPS)
    for name in ("candidates", "required"):
        out[name] = bound(nbytes,
                          needed + n[name] * (NOISE_OPS[noise] + PICK_OPS),
                          n[name] * SIN_F64_OPS[noise])
    out["cells"] = n
    return out
