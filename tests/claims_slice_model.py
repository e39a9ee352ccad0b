"""A CPU model of the claims kernel's node slices and their shared prune
record (csrc/claims.cu), for ROADMAP Q4.

The kernel cuts the node axis into slices, one block per (pod block,
slice); each thread walks its slice's nodes in ascending order, keeps
each pod's running (best, index) and skips the noise of a cell whose
upper bound fl(score + NOISE_MAX) cannot beat the pod's bar: its own best
so far, and the best cell any slice has published in the per-pod record
(a 64-bit atomicMax of value, then lower index).  A block publishes its
improved bests and reads the record at each staged node-row tile (every
TNS nodes of its slice) and once at the end; a fold then takes the
slices' partials in ascending order with the strict rule.  Which slice
publishes first depends on timing, so the claim that the record never
changes an answer is a claim about every order of those publishes.

`emulate` runs that loop with one Python generator a (pod block, slice),
vectorized over the block's pods, yielding at every share point, and a
scheduler that decides which task runs next (`ORDERS`): every slice alone
first, in ascending or descending order, all reads before any publish,
round robin, the slice holding each pod's answer last or first, and
seeded random interleavings.  The cell values are the plain version's
(kernels.claims_reference's mask, score and noise): the model tests the
prune and the fold, not the arithmetic, which tests/test_torch_kernels.py
and the card's phase 3 hold.

The geometry comes from claims.cu's own constants (read from the source):
pods per thread, threads per block, the slice width for an SM count.
"""

import random
import re
from pathlib import Path

import numpy as np
import torch

from kubernetes_tpu_torch.ops import kernels

CU = (Path(kernels.__file__).resolve().parent / "csrc" / "claims.cu")
NEG = np.float32(-1e9)
H100_SMS = 132


def _constants() -> dict:
    src = CU.read_text()
    out = {}
    for name in ("PT", "BLOCKS_PER_SM", "MAX_SLICES", "THREADS", "TNS"):
        out[name] = int(re.search(rf"constexpr int {name} = (\d+);",
                                  src)[1])
    out["TN"] = 256 // out["PT"]
    assert "constexpr int TN = 256 / PT;" in src
    return out


C = _constants()


def cdiv(a, b):
    return -(-a // b)


def pt_for(R):
    return C["PT"] if (R <= 8 or C["PT"] == 4) else C["PT"] // 2


def block_threads(P, K):
    return min(C["THREADS"], cdiv(cdiv(P, K), 32) * 32)


def slice_width(P, N, sms=H100_SMS):
    tpb = block_threads(P, C["PT"])
    pod_blocks = cdiv(P, tpb * C["PT"])
    want = C["BLOCKS_PER_SM"] * sms
    slices = max(1, min(cdiv(want, pod_blocks), cdiv(N, C["TN"]),
                        C["MAX_SLICES"]))
    return cdiv(cdiv(N, slices), C["TN"]) * C["TN"]


def record_key(v: np.ndarray, n: np.ndarray) -> np.ndarray:
    """claims.cu record_key: ordered value bits, then ~index."""
    u = v.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = np.where(u & 0x80000000, (~u) & 0xFFFFFFFF, u | 0x80000000)
    return (u << np.uint64(32)) | ((~n.astype(np.int64)) & 0xFFFFFFFF
                                   ).astype(np.uint64)


def record_bar(key: np.ndarray, n_lo: int, broken=False) -> np.ndarray:
    """claims.cu record_bar: the bar a published cell sets for a slice
    starting at n_lo (-inf where nothing was published).  broken=True
    drops the index rule (a mutation the tests expect to fail)."""
    o = (key >> np.uint64(32)).astype(np.uint32)
    bits = np.where(o & 0x80000000, o & 0x7FFFFFFF, ~o).astype(np.uint32)
    v = bits.view(np.float32)
    m = (~(key & np.uint64(0xFFFFFFFF)).astype(np.uint32)).astype(np.int64)
    bar = np.where((m < n_lo) | broken, v,
                   np.nextafter(v, np.float32(-np.inf)))
    return np.where(key == 0, np.float32(-np.inf), bar).astype(np.float32)


def planes(static, active, used, used_nz, npods, noise, pod_ids=None):
    """(live mask, value, upper) [P, N] of one claims call: the cells the
    kernel visits (static mask, fit, pod cap, live pod), fl(score +
    noise) and fl(score + NOISE_MAX), from the plain version's pieces."""
    P, N, R = static["shape"]
    if pod_ids is None:
        pod_ids = torch.arange(P, dtype=torch.int32)
    req, req_nz = static["req"], static["req_nz"]
    alloc, maxpods = static["alloc"], static["maxpods"]
    avail = alloc - used
    fit = (npods + 1.0 <= maxpods)[None, :]
    for r in range(R):
        fit = fit & (req[:, r, None] <= avail[None, :, r])
    mask = (static["smask_t"][:, :P].T != 0) & fit & active[:, None].bool()
    score = kernels.fit_score(*kernels.utilizations(req_nz, alloc, used_nz))
    nz = (kernels.murmur_noise(pod_ids, N) if noise == "murmur"
          else kernels.sin_noise(pod_ids, N))
    nmax = torch.tensor(kernels.NOISE_MAX[noise], dtype=torch.float32)
    return (mask.numpy(), (score + nz).numpy(), (score + nmax).numpy())


def _task(b, s, p_lo, p_hi, n_lo, n_hi, mask, value, upper, rec, out,
          broken):
    """One block (pods [p_lo, p_hi)) of one slice (nodes [n_lo, n_hi)),
    yielding at each share point (claims.cu run_slice, share_records)."""
    k = p_hi - p_lo
    best = np.full(k, NEG, np.float32)
    idx = np.full(k, -1, np.int64)
    bar = np.full(k, NEG, np.float32)
    dirty = np.zeros(k, bool)
    live = mask[p_lo:p_hi, n_lo:n_hi].any(1)
    out["cells"] = out.get("cells", 0)

    def share():
        # publish this block's improved bests, then read every pod's
        sel = dirty & live
        if sel.any():
            keys = record_key(best[sel], idx[sel])
            rows = np.nonzero(sel)[0] + p_lo
            rec[rows] = np.maximum(rec[rows], keys)
        bar[live] = np.maximum(bar[live],
                               record_bar(rec[p_lo:p_hi], n_lo,
                                          broken)[live])
        dirty[:] = False

    for n0 in range(n_lo, n_hi, C["TNS"]):
        yield "read"
        share()
        for n in range(n0, min(n0 + C["TNS"], n_hi)):
            m = mask[p_lo:p_hi, n]
            if not m.any():
                continue
            need = m & ~(upper[p_lo:p_hi, n] <= bar)
            out["cells"] += int(need.sum())
            v = value[p_lo:p_hi, n]
            upd = need & (v > best)
            best[upd] = v[upd]
            idx[upd] = n
            bar[upd] = np.maximum(bar[upd], v[upd])
            dirty |= upd
    yield "publish"
    share()
    out["best"][s, p_lo:p_hi] = best
    out["idx"][s, p_lo:p_hi] = idx


def _answer_slices(value, mask, w):
    """The slice holding each pod block's first answer (for the orders
    that run it first or last)."""
    masked = np.where(mask, value, NEG)
    return masked.argmax(1) // w


ORDERS = ("ascending", "descending", "reads_first", "round_robin",
          "answer_last", "answer_first", "random0", "random1", "random2")


def emulate(mask, value, upper, R, order, sms=H100_SMS, broken=False,
            width=None):
    """(claims int32[P], best f32[P], stats) of one claims call under the
    task order `order` (ORDERS), with the kernel's slice width for `sms`
    SMs or `width` nodes a slice (a whole number of mask tiles; a smaller
    card's geometry); `broken` breaks record_bar's index rule."""
    P, N = value.shape
    K = pt_for(R)
    pods = block_threads(P, K) * K
    w = width or slice_width(P, N, sms)
    S = cdiv(N, w)
    rec = np.zeros(P, np.uint64)
    out = {"best": np.full((S, P), NEG, np.float32),
           "idx": np.full((S, P), -1, np.int64)}
    tasks = {}
    for b, p_lo in enumerate(range(0, P, pods)):
        p_hi = min(P, p_lo + pods)
        for s in range(S):
            tasks[(b, s)] = _task(b, s, p_lo, p_hi, s * w,
                                  min(N, s * w + w), mask, value, upper,
                                  rec, out, broken)
    keys = sorted(tasks)
    if order == "descending":
        keys = sorted(keys, key=lambda t: (t[0], -t[1]))
    elif order.startswith("answer"):
        ans = _answer_slices(value, mask, w)
        lead = {}
        for b, p_lo in enumerate(range(0, P, pods)):
            vals, counts = np.unique(ans[p_lo:p_lo + pods],
                                     return_counts=True)
            lead[b] = int(vals[counts.argmax()])
        last = order == "answer_last"
        keys = sorted(keys, key=lambda t: (
            (t[1] == lead[t[0]]) if last else (t[1] != lead[t[0]]), t))
    elif order.startswith("random"):
        random.Random(int(order[6:])).shuffle(keys)
    if order in ("reads_first", "round_robin") or order.startswith("random"):
        # interleave: every task runs to its next yield in turn; with
        # reads_first every task reads before any publishes
        rng = random.Random(order)
        live = list(keys)
        while live:
            nxt = []
            for t in live:
                try:
                    next(tasks[t])
                    nxt.append(t)
                except StopIteration:
                    pass
            if order.startswith("random"):
                rng.shuffle(nxt)
            live = nxt
    else:
        for t in keys:          # each task alone, start to end
            for _ in tasks[t]:
                pass
    # the fold: ascending slices, strict rule
    best = np.full(P, NEG, np.float32)
    idx = np.full(P, -1, np.int64)
    for s in range(S):
        upd = out["best"][s] > best
        best[upd] = out["best"][s][upd]
        idx[upd] = out["idx"][s][upd]
    claims = np.where((best > NEG / 2) & (idx < N), idx, -1).astype(np.int32)
    return claims, best, {"slices": S, "slice_w": w, "blocks": len(tasks),
                          "noise_cells": out["cells"],
                          "live_cells": int(mask.sum())}
