"""Batched pod->node assignment on the GPU: the wave step, both variants.

Counterpart of kubernetes_tpu/models/assign.py.  Every pending pod claims
its best node at once, conflicts are resolved in pod (queue) order with
[P,P] prefix sums, the accepted claims commit into the resident aggregates,
and the losers retry next wave against the updated state.

The PLAIN variant (no selectors, ports, constraints, pins or
PreferNoSchedule taints) claims through the claims kernel; once the
still-active pods fit TAIL_P, they are gathered to the front and finish on
a [TAIL_P, N] sub-batch.

The FULL variant (the JAX package's ALL_FEATURES) adds node selectors and
affinity, PreferNoSchedule scores, nodeName pins, host ports, topology
spread, pod (anti-)affinity and the anti-affinity of existing pods: the
static masks of _static_mask_and_score, the constraint-slot loop of the XLA
wave body, and the port, anti-affinity, spread-quota, bootstrap and
existing-anti blocks of _resolve_and_commit with the spread cohort's
water-filling.  Like the JAX full variant it reaches no hand kernel: its
claims are torch operations on [rows, N] planes, built in chunks of rows.
Tail compaction (A:761-781, gathering the active pods to the front in
ascending order) runs at EVERY wave here: each wave computes claims for the
active pods only and resolves conflicts among the claimants only.  The
JAX main loop and its compacted tail give the same answers, because a wave
is row-wise up to the claims and an inactive or claimless pod takes part in
no conflict (every [P,P] term is gated by both pods' claims).

The full step marks its stages for torch.profiler (record_function
"full.static", "full.claims", "full.resolve" and, inside the resolve,
"full.cohort"); without a profiler they cost a few microseconds a wave.

Differences from the JAX version, none of which changes a result:
  * the wave loop is a Python loop; its condition reads one count from
    the device per wave;
  * the resident state is updated in place (JAX donated it);
  * commits go through index_add_ / scatter_add_ over the accepted claims
    instead of [P,N] one-hot matmuls.  Both are bit-equal whenever every
    per-node sum is exact in f32, which holds for integer milli-CPU and
    byte counts at MiB granularity (flatten.py _encode_resource) and for
    the 0/1 domain counts: the order of exact additions does not matter.
    The same argument covers the [P,P] prefix sums E @ req, which is why
    TF32 must stay off for them;
  * 0/1 products of bit vectors (taints, ports, existing-anti groups, key
    DoesNotExist) are ANDs of bitmasks, and the selector einsums are ORs
    over the pods' label ids: equal to the JAX counts' "> 0" / "== 0";
  * the plain static mask is built node-major as uint8 from the pods' and
    nodes' taint bitmasks, never as an f32 [P,N] plane.

XLA, compiling the reference on the CPU, contracts one inexact product in
either wave body: the fit score's (2-ucpu-umem)*50 into
fma(2-ucpu-umem, 50, (1-|d|*0.5)*100) (ROADMAP R4); kernels.fit_score does
the same.  Every other product that feeds an add there is exact (integer
counts and weights, powers of two) or reaches the add through a select.

The compacted plain tail always uses the murmur noise keyed on the pods'
original batch positions, as the JAX tail runs the XLA wave body after a
Pallas main phase (quirk R1); the plain main phase uses `claims_noise`.
The full variant uses the murmur noise throughout, as the JAX one does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops import kernels
from ..ops.flatten import (
    C_AFFINITY, C_ANTI_AFFINITY, C_PREF_AFFINITY, C_SPREAD_HARD,
    C_SPREAD_SCORE, Caps,
)

TAIL_P = 512  # compacted straggler sub-batch size (tail compaction)
MAX_WAVES = 128  # the plain variant's wave ceiling (it converges in O(contention))
COHORT_ITERS = 3  # spread water-filling fixpoint rounds per wave
AGGREGATE_KEYS = ("used", "used_nz", "npods", "port_mask", "cd_sg", "cd_asg")
STATE_KEYS = AGGREGATE_KEYS + ("gen",)
ALL_FEATURES = frozenset({"selectors", "ports", "constraints", "asg", "pin",
                          "prefer"})
PLAIN_FEATURES = frozenset()
SEL_V = 8       # max ids per any-of label group
FORB_V = 8      # max forbidden label ids per pod
KEY_V = 4       # max ids per Exists key group
# row chunk for node-major [rows, P] temporaries (static mask build)
_MASK_CELLS = 1 << 27
# row chunk for the full variant's pod-major [rows, N] planes
_FULL_CELLS = 1 << 26


# ---------------------------------------------------------------------------
# Packed transport (numpy; copy of the JAX package's wire format)
# ---------------------------------------------------------------------------

class PackSpec:
    """Offsets for the single packed pod+patch buffer.

    plain=True is the PLAIN-variant wire format: req/req_nz plus an
    untol_hard bitmask and validity per pod.  The full format adds the
    constraint floats, the bitmask words and the selector id blocks.  Both
    end in a bounded row-patch section."""

    def __init__(self, caps: Caps, p_cap: int, k_cap: int,
                 plain: bool = False):
        if caps.t_cap > 31 or caps.pt_cap > 31:
            raise ValueError("bitmask packing caps: t_cap, pt_cap <= 31")
        if (caps.sg_cap > 31 or caps.asg_cap > 31 or caps.g_cap > 31
                or caps.kg_cap > 31 or caps.kl_cap > 62):
            raise ValueError("bitmask packing caps: sg_cap, asg_cap, g_cap, "
                             "kg_cap <= 31 and kl_cap <= 62")
        self.caps, self.p_cap, self.k_cap = caps, p_cap, k_cap
        self.plain = plain
        C, G, KG = caps.c_cap, caps.g_cap, caps.kg_cap
        if plain:
            self.f_f = 2 * caps.r
            self.f_i = 2  # untol_hard bits | p_valid
        else:
            self.f_f = 2 * caps.r + 3 * C
            # 13 fixed int columns, then the constraint and id blocks
            self.f_i = 13 + 2 * C + G * SEL_V + FORB_V + KG * KEY_V
        self.f_patch = 2 * caps.r + 1 + caps.pt_cap
        self.a = p_cap * self.f_f
        self.b = p_cap * self.f_i
        self.total = self.a + self.b + k_cap + k_cap * self.f_patch


def _bits(mask_2d: np.ndarray) -> np.ndarray:
    """[P,W<=31] 0/1 float -> int32 bitmask [P]."""
    w = mask_2d.shape[1]
    return (mask_2d.astype(np.int64) @ (1 << np.arange(w, dtype=np.int64))
            ).astype(np.int32)


def pack_pod_batch(batch, spec: PackSpec,
                   patch_rows: np.ndarray | None = None,
                   patch_vals: np.ndarray | None = None,
                   out: np.ndarray | None = None) -> np.ndarray:
    """PodBatch (+ optional row patches) -> single 1-D f32 buffer.

    `out`, when given, is a preallocated f32[spec.total] staging buffer:
    every slot is overwritten here, so a recycled buffer needs no
    clearing."""
    caps, P, K = spec.caps, spec.p_cap, spec.k_cap
    C, G, KG = caps.c_cap, caps.g_cap, caps.kg_cap
    rows = np.full(K, -1, np.int32)
    vals = np.zeros((K, spec.f_patch), np.float32)
    if patch_rows is not None and len(patch_rows):
        n = min(len(patch_rows), K)
        rows[:n] = patch_rows[:n]
        vals[:n] = patch_vals[:n]
    if spec.plain:
        pf = np.concatenate([batch.req, batch.req_nz],
                            axis=1).astype(np.float32)
        pi = np.zeros((P, spec.f_i), np.int32)
        pi[:, 0] = _bits(batch.untol_hard)
        pi[:, 1] = batch.p_valid.astype(np.int32)
        return _pack_out(spec, pf, pi, rows, vals, out)
    # full wire format: materialize the lazy (None == zeros) fields
    for nm in ("untol_prefer", "ports", "key_forb", "match_asg", "inc_asg",
               "inc_sg", "pod_ns", "sel_any_active", "key_any_active",
               "node_row", "c_kind", "c_sg", "c_maxskew", "c_selfmatch",
               "c_weight", "sel_ids", "sel_forb_ids", "key_ids"):
        batch.ensure(caps, nm)
    pf = np.concatenate([batch.req, batch.req_nz, batch.c_maxskew,
                         batch.c_selfmatch, batch.c_weight],
                        axis=1).astype(np.float32)
    pi = np.zeros((P, spec.f_i), np.int32)
    pi[:, 0] = _bits(batch.untol_hard)
    pi[:, 1] = _bits(batch.untol_prefer)
    pi[:, 2] = _bits(batch.ports)
    kf = batch.key_forb
    pi[:, 3] = _bits(kf[:, :31])
    pi[:, 4] = _bits(kf[:, 31:62]) if kf.shape[1] > 31 else 0
    pi[:, 5] = _bits(np.minimum(batch.match_asg, 1))
    pi[:, 6] = _bits(np.minimum(batch.inc_asg, 1))
    pi[:, 7] = _bits(np.minimum(batch.inc_sg, 1))
    pi[:, 8] = _bits(batch.sel_any_active)
    pi[:, 9] = _bits(batch.key_any_active)
    pi[:, 10] = batch.p_valid.astype(np.int32)
    pi[:, 11] = batch.node_row
    pi[:, 12] = batch.pod_ns
    o = 13
    pi[:, o:o + C] = batch.c_kind
    o += C
    pi[:, o:o + C] = batch.c_sg
    o += C
    pi[:, o:o + G * SEL_V] = batch.sel_ids.reshape(P, G * SEL_V)
    o += G * SEL_V
    pi[:, o:o + FORB_V] = batch.sel_forb_ids
    o += FORB_V
    pi[:, o:o + KG * KEY_V] = batch.key_ids.reshape(P, KG * KEY_V)
    return _pack_out(spec, pf, pi, rows, vals, out)


def _pack_out(spec: PackSpec, pf, pi, rows, vals,
              out: np.ndarray | None) -> np.ndarray:
    """Assemble the wire buffer: concatenate (fresh allocation) or fill
    `out` segment-by-segment — each segment is fully overwritten."""
    if out is None:
        return np.concatenate([
            pf.ravel(), pi.view(np.float32).ravel(),
            rows.view(np.float32), vals.ravel()]).astype(np.float32)
    a, b, K = spec.a, spec.b, spec.k_cap
    out[:a] = pf.ravel()
    out[a:a + b] = pi.view(np.float32).ravel()
    out[a + b:a + b + K] = rows.view(np.float32)
    out[a + b + K:] = vals.ravel()
    return out


# ---------------------------------------------------------------------------
# Device step
# ---------------------------------------------------------------------------

def _unbits(word, width: int):
    """int32 [P] bitmask -> f32 [P, width] of 0/1."""
    shifts = torch.arange(width, dtype=torch.int32, device=word.device)
    return ((word[:, None] >> shifts) & 1).to(torch.float32)


def _unpack(buf, spec: PackSpec):
    """Wire buffer (f32 tensor) -> (pod dict, patch rows, patch values).
    The int sections are reinterpreted in place (.view).  Bit vectors stay
    int32 words (`*_bits`) where the step only ANDs them; the ones it
    multiplies, folds or commits are decoded to 0/1 floats."""
    caps, P, K = spec.caps, spec.p_cap, spec.k_cap
    R, C, G, KG = caps.r, caps.c_cap, caps.g_cap, caps.kg_cap
    pf = buf[:spec.a].view(P, spec.f_f)
    pi = buf[spec.a:spec.a + spec.b].view(torch.int32).view(P, spec.f_i)
    prow = buf[spec.a + spec.b:spec.a + spec.b + K].view(torch.int32)
    pval = buf[spec.a + spec.b + K:].view(K, spec.f_patch)
    if spec.plain:
        pod = {"req": pf[:, :R], "req_nz": pf[:, R:2 * R],
               "untol_bits": pi[:, 0], "p_valid": pi[:, 1] > 0}
        return pod, prow, pval
    KL = caps.kl_cap
    # key_forb spans two words: bits 0..30 of word 3, then KL-31 of word 4
    lo_w = min(KL, 31)
    kf = pi[:, 3].to(torch.int64) & ((1 << lo_w) - 1)
    if KL > 31:
        kf |= (pi[:, 4].to(torch.int64) & ((1 << (KL - 31)) - 1)) << 31
    o = 13
    pod = {
        "req": pf[:, :R], "req_nz": pf[:, R:2 * R],
        "c_maxskew": pf[:, 2 * R:2 * R + C],
        "c_selfmatch": pf[:, 2 * R + C:2 * R + 2 * C],
        "c_weight": pf[:, 2 * R + 2 * C:2 * R + 3 * C],
        "untol_bits": pi[:, 0], "prefer_bits": pi[:, 1],
        "port_bits": pi[:, 2], "keyforb_bits": kf,
        "ports": _unbits(pi[:, 2], caps.pt_cap),
        "match_asg": _unbits(pi[:, 5], caps.asg_cap),
        "inc_asg": _unbits(pi[:, 6], caps.asg_cap),
        "inc_sg": _unbits(pi[:, 7], caps.sg_cap),
        "sel_active": _unbits(pi[:, 8], G) > 0,
        "key_active": _unbits(pi[:, 9], KG) > 0,
        "p_valid": pi[:, 10] > 0,
        "node_row": pi[:, 11], "pod_ns": pi[:, 12],
        "c_kind": pi[:, o:o + C], "c_sg": pi[:, o + C:o + 2 * C],
    }
    o += 2 * C
    pod["sel_ids"] = pi[:, o:o + G * SEL_V].reshape(P, G, SEL_V)
    o += G * SEL_V
    pod["forb_ids"] = pi[:, o:o + FORB_V]
    o += FORB_V
    pod["key_ids"] = pi[:, o:o + KG * KEY_V].reshape(P, KG, KEY_V)
    return pod, prow, pval


def _apply_patches(state: dict, prow, pval, caps: Caps) -> None:
    """Overwrite patched node rows of the dynamic aggregates in place
    (prow=-1 is a no-op).  Same arithmetic as the JAX version: each row
    gets (new - cur) * valid added, so a padding row adds zero."""
    R = caps.r
    n = state["used"].shape[0]
    r = prow.clamp(0, n - 1).long()
    vf = (prow >= 0).to(torch.float32)[:, None]
    for key, new in (("used", pval[:, :R]), ("used_nz", pval[:, R:2 * R]),
                     ("npods", pval[:, 2 * R:2 * R + 1]),
                     ("port_mask", pval[:, 2 * R + 1:])):
        arr = state[key]
        view = arr.view(n, -1)
        view.index_add_(0, r, (new - view[r]) * vf)


def taint_bits(taint_mask) -> torch.Tensor:
    """Node taint rows [N, T<=31] (0/1) -> int32 bitmask [N]."""
    w = taint_mask.shape[1]
    weights = (1 << torch.arange(w, dtype=torch.int64,
                                 device=taint_mask.device))
    return ((taint_mask > 0).to(torch.int64) * weights).sum(1).to(torch.int32)


def static_mask_t(valid, node_taint_bits, untol_bits) -> torch.Tensor:
    """uint8 [N, P]: node n is statically eligible for pod p when it is
    valid and carries no taint the pod fails to tolerate.  The JAX
    version's (untol_hard @ taint_mask.T) == 0 counts shared 0/1 bits;
    an AND of the two bitmasks is zero exactly when that count is."""
    N, P = valid.shape[0], untol_bits.shape[0]
    out = torch.empty((N, P), dtype=torch.uint8, device=valid.device)
    step = max(1, _MASK_CELLS // max(P, 1))
    for lo in range(0, N, step):
        hi = min(N, lo + step)
        ok = (node_taint_bits[lo:hi, None] & untol_bits[None, :]) == 0
        out[lo:hi] = ok & valid[lo:hi, None]
    return out


class _SubBatch:
    """The pod-side inputs one wave loop reads."""

    def __init__(self, req, req_nz, smask_t, pod_ids, static, earlier):
        self.kstatic = kernels.prepare_static(req, req_nz, static["alloc"],
                                              static["maxpods"], smask_t)
        self.req, self.req_nz = self.kstatic["req"], self.kstatic["req_nz"]
        self.pod_ids = pod_ids
        self.earlier = earlier


def _wave(static, state, b: _SubBatch, assigned, active, noise):
    """One wave: claims, conflict resolution in pod order, commit.
    Mutates the state aggregates in place; returns (assigned, active)."""
    used, used_nz, npods = state["used"], state["used_nz"], state["npods"]
    alloc, maxpods = static["alloc"], static["maxpods"]
    n = alloc.shape[0]
    avail = alloc - used
    claims, _best = kernels.claims(b.kstatic, active, used, used_nz, npods,
                                   noise=noise, pod_ids=b.pod_ids)
    has = claims >= 0
    # E[p, q] = 1 when q < p claimed the same node (both claims live)
    E = ((claims[:, None] == claims[None, :]) & has[:, None] & has[None, :]
         & b.earlier).to(torch.float32)
    prefR = E @ b.req                                    # [P,R]
    prefN = E.sum(1)                                     # [P]
    cl = claims.clamp(0, n - 1).long()
    hasf = has[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=used.device)
    avail_claim = torch.where(hasf, avail[cl], zero)
    npods_claim = torch.where(has, npods[cl], zero)
    maxp_claim = torch.where(has, maxpods[cl], zero)
    res_ok = (b.req + prefR <= avail_claim).all(1)
    res_ok &= npods_claim + prefN + 1.0 <= maxp_claim
    accept = has & active & res_ok
    # commit: index_add_ of exact per-node sums == the JAX one-hot matmul
    rows = cl[accept]
    used.index_add_(0, rows, b.req[accept])
    used_nz.index_add_(0, rows, b.req_nz[accept])
    npods.index_add_(0, rows, torch.ones_like(rows, dtype=torch.float32))
    assigned = torch.where(accept, claims, assigned)
    progress = accept.any()
    active = active & ~accept & progress  # no progress -> give up
    return assigned, active


def _wave_loop(static, state, b, assigned, active, noise, waves,
               max_waves, stop_at):
    """Run waves while some pod is active, under the wave ceiling, and
    while more than `stop_at` pods are active (one count read per
    wave).  Returns (assigned, active, waves)."""
    while waves < max_waves:
        n_active = int(active.sum())
        if n_active == 0 or n_active <= stop_at:
            break
        assigned, active = _wave(static, state, b, assigned, active, noise)
        waves += 1
    return assigned, active, waves


# ---------------------------------------------------------------------------
# The full variant
# ---------------------------------------------------------------------------

def _row_chunks(n_rows: int, n_cols: int, cells: int = _FULL_CELLS):
    """(lo, hi) row ranges whose [rows, n_cols] planes hold ~`cells`."""
    step = max(1, cells // max(n_cols, 1))
    for lo in range(0, n_rows, step):
        yield lo, min(n_rows, lo + step)


def _popcount(x):
    """Set bits of each int32 (bit 31 clear), SWAR."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def _bit_columns(mask) -> torch.Tensor:
    """[N, W<=62] 0/1 rows -> int64 bitmask [N]."""
    w = mask.shape[1]
    weights = 1 << torch.arange(w, dtype=torch.int64, device=mask.device)
    return ((mask > 0).to(torch.int64) * weights).sum(1)


def _fold_ns_masks(static: dict, pod: dict) -> None:
    """Namespace gate for namespaceSelector terms (A:228-250): AND each
    pod's group membership (inc_sg, match_asg) with the per-slot namespace
    masks' column of the pod's namespace.  inc_asg is not gated: it marks
    the pod as a term carrier.  No-op when the static arrays carry no
    namespace masks."""
    sgm = static.get("sg_ns_mask")
    if sgm is None:
        return
    col = pod["pod_ns"].long()
    pod["inc_sg"] = pod["inc_sg"] * sgm[:, col].T
    asgm = static.get("asg_ns_mask")
    if asgm is not None:
        pod["match_asg"] = pod["match_asg"] * asgm[:, col].T


def _any_id(table_t, ids, slots):
    """OR over id slots of table_t rows: [rows, N] bool, True where the
    node carries any of the row's valid ids (-1 pads).  `slots` lists the
    slot positions some pod of the batch fills."""
    n_ids, n = table_t.shape
    out = torch.zeros((ids.shape[0], n), dtype=torch.bool,
                      device=table_t.device)
    for k in slots:
        idk = ids[:, k]
        ok = (idk >= 0) & (idk < n_ids)
        out |= table_t[idk.clamp(0, n_ids - 1).long()] & ok[:, None]
    return out


class _Full:
    """One call's batch-wide inputs of the full variant: the pod fields,
    the node-side tables derived from the static arrays, which selector
    groups, id slots, constraint kinds, ports and existing-anti groups the
    batch uses (read once, so the waves skip what no pod needs), and the
    [P,N] static planes."""

    def __init__(self, caps: Caps, static: dict, pod: dict, noise, w: dict):
        self.caps, self.static, self.pod, self.noise, self.w = (
            caps, static, pod, noise, w)
        dev = pod["req"].device
        N = static["alloc"].shape[0]
        self.N = N
        self.node_idx = torch.arange(N, device=dev)
        _fold_ns_masks(static, pod)
        self.c_sg = pod["c_sg"].clamp(min=0).long()
        self.match_bits = _bit_columns(pod["match_asg"]).to(torch.int32)
        P = pod["req"].shape[0]
        C, G, KG = caps.c_cap, caps.g_cap, caps.kg_cap
        # what the batch uses, in one host read
        uses = iter(torch.cat([
            torch.stack([(pod["c_kind"] == k).any(0)
                         for k in range(6)]).flatten(),
            pod["sel_active"].any(0), pod["key_active"].any(0),
            (pod["sel_ids"] >= 0).any(0).flatten(),
            (pod["forb_ids"] >= 0).any(0),
            (pod["key_ids"] >= 0).any(0).flatten(),
            (pod["match_asg"] > 0).any(0) & (pod["inc_asg"] > 0).any(0),
            torch.stack([(pod["port_bits"] != 0).any(),
                         (pod["prefer_bits"] != 0).any(),
                         (pod["keyforb_bits"] != 0).any(),
                         (self.match_bits != 0).any()]),
        ]).tolist())

        def take(n):
            return [next(uses) for _ in range(n)]

        def used(n):
            return [i for i, u in enumerate(take(n)) if u]
        by_kind = [take(C) for _k in range(6)]
        # constraint kinds per slot (C_NONE left out); the slots in use
        self.kinds = [{k for k in range(1, 6) if by_kind[k][c]}
                      for c in range(C)]
        self.slots = [c for c in range(C) if self.kinds[c]]
        self.groups = used(G)
        self.key_groups = used(KG)
        self.sel_slots = [used(SEL_V) for _g in range(G)]
        self.forb_slots = used(FORB_V)
        self.key_slots = [used(KEY_V) for _g in range(KG)]
        self.asg_slots = used(caps.asg_cap)
        self.any_ports, self.any_prefer, self.any_keyforb, self.any_match = (
            take(4))
        self.sel_mask = torch.empty((P, N), dtype=torch.bool, device=dev)
        self.static_mask = torch.empty((P, N), dtype=torch.bool, device=dev)
        self.static_score = (torch.empty((P, N), dtype=torch.float32,
                                         device=dev)
                             if self.any_prefer else None)
        with torch.profiler.record_function("full.static"):
            self._static_mask_and_score()

    def _static_mask_and_score(self) -> None:
        """Vectorized P x N feasibility independent of in-batch placements
        (A:176-225), in chunks of rows: sel_mask (node selector and
        affinity only: the spread min-match domain set), static_mask
        (sel_mask and taints and the nodeName pin) and static_score (the
        PreferNoSchedule score, 0..100; None when no pod of the batch
        fails to tolerate a PreferNoSchedule taint: then it is 100 in
        every cell, as mx == 0 makes it)."""
        st, pod = self.static, self.pod
        valid = st["valid"].bool()
        label_t = (st["label_mask"] > 0).T.contiguous()     # [L, N]
        key_t = (st["key_mask"] > 0).T.contiguous()         # [KL, N]
        tbits = taint_bits(st["taint_mask"])
        kbits = _bit_columns(st["key_mask"]) if self.any_keyforb else None
        P = pod["req"].shape[0]
        for lo, hi in _row_chunks(P, self.N):
            sel = valid[None, :].expand(hi - lo, self.N).clone()
            for g in self.groups:
                hits = _any_id(label_t, pod["sel_ids"][lo:hi, g],
                               self.sel_slots[g])
                sel &= hits | ~pod["sel_active"][lo:hi, g, None]
            for g in self.key_groups:
                hits = _any_id(key_t, pod["key_ids"][lo:hi, g],
                               self.key_slots[g])
                sel &= hits | ~pod["key_active"][lo:hi, g, None]
            if self.forb_slots:
                sel &= ~_any_id(label_t, pod["forb_ids"][lo:hi],
                                self.forb_slots)
            if kbits is not None:
                sel &= (pod["keyforb_bits"][lo:hi, None] & kbits[None, :]) == 0
            self.sel_mask[lo:hi] = sel
            row = pod["node_row"][lo:hi, None]
            smask = (sel & ((pod["untol_bits"][lo:hi, None] & tbits[None, :])
                            == 0)
                     & ((row < 0) | (self.node_idx[None, :] == row)))
            self.static_mask[lo:hi] = smask
            if self.static_score is not None:
                cnt = _popcount(pod["prefer_bits"][lo:hi, None]
                                & tbits[None, :]).to(torch.float32)
                mx = torch.where(smask, cnt, 0.0).amax(1, keepdim=True)
                self.static_score[lo:hi] = torch.where(
                    mx > 0, (mx - cnt) * 100.0 / torch.clamp(mx, min=1.0),
                    100.0)


def _node_side(f: _Full, state: dict) -> dict:
    """Per-wave node-side inputs: free capacity, the pod-count cap, the
    host-port and existing-anti-group bitmasks, and the [SG,N] domain
    counts gathered once at the group level (A:401-442)."""
    st = f.static
    dom_sg, dom_asg = st["dom_sg"], st["dom_asg"]
    out = {"avail": st["alloc"] - state["used"],
           "cap_ok": state["npods"] + 1.0 <= st["maxpods"],
           "gath_sg_all": torch.where(
               dom_sg >= 0,
               state["cd_sg"].gather(1, dom_sg.clamp(min=0).long()), 0.0)}
    if f.any_ports:
        out["port_bits"] = _bit_columns(state["port_mask"]).to(torch.int32)
    if f.any_match:
        acnt = torch.where(
            dom_asg >= 0,
            state["cd_asg"].gather(1, dom_asg.clamp(min=0).long()), 0.0)
        out["asg_bits"] = _bit_columns((acnt > 0).T).to(torch.int32)
    return out


def _claims_full(f: _Full, state: dict, node: dict, rows):
    """The XLA wave body (A:411-492) for pod rows `rows`: the fit, host-
    port and existing-anti masks, LeastAllocated + BalancedAllocation, the
    PreferNoSchedule score, the constraint-slot loop (required spread,
    affinity and anti-affinity masks, spread and preferred-affinity
    scores), murmur noise and the masked first-index argmax.  Returns
    (claims int64 [rows] with -1 where nothing is feasible, minmatch f32
    [rows, C], affinity-bootstrap flags bool [rows, C])."""
    pod, st, w = f.pod, f.static, f.w
    dom_sg, cd_sg = st["dom_sg"], state["cd_sg"]
    R, C = f.caps.r, f.caps.c_cap
    dev = rows.device
    B = rows.shape[0]
    claims = torch.empty(B, dtype=torch.int64, device=dev)
    minm = torch.zeros((B, C), dtype=torch.float32, device=dev)
    boot = torch.zeros((B, C), dtype=torch.bool, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    for lo, hi in _row_chunks(B, f.N):
        r = rows[lo:hi]
        req = pod["req"][r]
        mask = f.static_mask[r] & node["cap_ok"][None, :]
        for k in range(R):
            mask &= req[:, k, None] <= node["avail"][None, :, k]
        if f.any_ports:
            mask &= (pod["port_bits"][r, None] & node["port_bits"][None, :]) == 0
        if f.any_match:
            mask &= (f.match_bits[r, None] & node["asg_bits"][None, :]) == 0
        score = kernels.fit_score(*kernels.utilizations(
            pod["req_nz"][r], st["alloc"], state["used_nz"]))
        score = score + (f.static_score[r] if f.static_score is not None
                         else 100.0)
        for c in f.slots:
            kinds = f.kinds[c]
            kind = pod["c_kind"][r, c]
            sg = f.c_sg[r, c]
            kb = kind[:, None]
            gathered = node["gath_sg_all"][sg]                 # [rows, N]
            has_dom = dom_sg[sg] >= 0
            if kinds & {C_SPREAD_HARD, C_AFFINITY, C_ANTI_AFFINITY}:
                selfm = pod["c_selfmatch"][r, c]
                ok = torch.ones_like(mask)
                if C_SPREAD_HARD in kinds:
                    elig = f.sel_mask[r] & has_dom
                    mm = torch.where(elig, gathered, inf).amin(1)
                    mm = torch.where(torch.isfinite(mm), mm, 0.0)
                    minm[lo:hi, c] = mm
                    spread_ok = ((gathered + selfm[:, None] - mm[:, None])
                                 <= pod["c_maxskew"][r, c, None]) & has_dom
                    ok = torch.where(kb == C_SPREAD_HARD, spread_ok, ok)
                if C_AFFINITY in kinds:
                    bt = (cd_sg[sg].sum(1) == 0) & (selfm > 0)
                    boot[lo:hi, c] = (kind == C_AFFINITY) & bt
                    aff_ok = ((gathered > 0) | bt[:, None]) & has_dom
                    ok = torch.where(kb == C_AFFINITY, aff_ok, ok)
                if C_ANTI_AFFINITY in kinds:
                    anti_ok = ~has_dom | (gathered == 0)
                    ok = torch.where(kb == C_ANTI_AFFINITY, anti_ok, ok)
                mask &= ok
            if C_SPREAD_SCORE in kinds:
                smx = torch.where(mask, gathered, 0.0).amax(1, keepdim=True)
                smn = torch.where(mask, gathered, inf).amin(1, keepdim=True)
                smn = torch.where(torch.isfinite(smn), smn, 0.0)
                rng = torch.clamp(smx - smn, min=1.0)
                spread_score = (smx - gathered) * 100.0 / rng
                score = score + torch.where(kb == C_SPREAD_SCORE,
                                            w["spread"] * spread_score, 0.0)
            if C_PREF_AFFINITY in kinds:
                cw = (w["affinity"] * pod["c_weight"][r, c])[:, None]
                score = score + torch.where(kb == C_PREF_AFFINITY,
                                            cw * gathered, 0.0)
        masked = torch.where(mask, score + f.noise[r], kernels.NEG)
        _best, idx = torch.max(masked, dim=1)   # first index of the max
        claims[lo:hi] = torch.where(mask.any(1), idx, -1)
    return claims, minm, boot


def _rowmin_masked(f: _Full, vals_sg, rows_pod, sg):
    """min over the node axis of vals_sg[sg] where the pod's sel_mask and
    the group's domain allow, inf -> 0 (the cohort's floor)."""
    out = torch.empty(rows_pod.shape[0], dtype=torch.float32,
                      device=rows_pod.device)
    dom_sg = f.static["dom_sg"]
    for lo, hi in _row_chunks(rows_pod.shape[0], f.N):
        s = sg[lo:hi]
        elig = f.sel_mask[rows_pod[lo:hi]] & (dom_sg[s] >= 0)
        out[lo:hi] = torch.where(elig, vals_sg[s], float("inf")).amin(1)
    return torch.where(torch.isfinite(out), out, 0.0)


def _resolve_and_commit(f: _Full, state: dict, node: dict, idx, cl, minm,
                        boot):
    """Conflict resolution in pod order among the claimants `idx` (pod
    rows, ascending) of nodes `cl`, then the commit (A:494-739, the
    single-device form): the resource prefix sums, host-port conflicts,
    per-slot anti-affinity serialization, the static spread quota and the
    affinity bootstrap, existing-anti conflicts, the spread cohort's
    water-filling, and the commit of every aggregate.  Returns the accept
    mask over the claimants."""
    pod, st = f.pod, f.static
    used, used_nz, npods = state["used"], state["used_nz"], state["npods"]
    cd_sg, cd_asg = state["cd_sg"], state["cd_asg"]
    dom_sg, dom_asg = st["dom_sg"], st["dom_asg"]
    H = idx.shape[0]
    dev = idx.device
    ar = torch.arange(H, device=dev)
    earlier = ar[None, :] < ar[:, None]                   # q < p
    req, req_nz = pod["req"][idx], pod["req_nz"][idx]
    E = (cl[:, None] == cl[None, :]) & earlier            # earlier same-node
    Ef = E.to(torch.float32)
    prefR = Ef @ req                                      # [H,R]
    prefN = Ef.sum(1)
    res_ok = (req + prefR <= node["avail"][cl]).all(1)
    res_ok &= npods[cl] + prefN + 1.0 <= st["maxpods"][cl]
    bad = ~res_ok
    if f.any_ports:
        pb = pod["port_bits"][idx]
        bad |= (E & ((pb[:, None] & pb[None, :]) != 0)).any(1)
    spread_over = torch.zeros(H, dtype=torch.bool, device=dev)
    inc_sg_t = pod["inc_sg"][idx].T > 0                  # [SG,H]
    slot = {}
    for c in f.slots:
        kinds = f.kinds[c]
        kind = pod["c_kind"][idx, c]
        sg = f.c_sg[idx, c]
        Dpq = dom_sg[sg[:, None], cl[None, :]]           # dom of q's claim
        own = dom_sg[sg, cl]                              # under p's sg
        q_incs = inc_sg_t[sg]                             # [H,H]
        M = earlier & (Dpq == own[:, None]) & (own[:, None] >= 0) & q_incs
        del Dpq
        k_same = M.sum(1).to(torch.float32)
        if C_ANTI_AFFINITY in kinds:
            bad |= (kind == C_ANTI_AFFINITY) & (k_same > 0)
        if C_SPREAD_HARD in kinds:
            own_ix = own.clamp(min=0).long()
            over = (cd_sg[sg, own_ix] + pod["c_selfmatch"][idx, c] + k_same
                    - minm[:, c]) > pod["c_maxskew"][idx, c]
            spread_over |= (kind == C_SPREAD_HARD) & (own >= 0) & over
        if C_AFFINITY in kinds:
            bad |= boot[:, c] & (earlier & q_incs).any(1)
        slot[c] = (M, own, sg, kind)
    for a in f.asg_slots:
        dom_a = dom_asg[a, cl]
        same = (dom_a[:, None] == dom_a[None, :]) & (dom_a[:, None] >= 0)
        carriers = pod["inc_asg"][idx, a] > 0
        bad |= (pod["match_asg"][idx, a] > 0) & (
            earlier & same & carriers[None, :]).any(1)
    accept = ~bad & ~spread_over
    hard = [c for c in slot if C_SPREAD_HARD in f.kinds[c]]
    if hard:
        n_hard = (pod["c_kind"][idx] == C_SPREAD_HARD).sum(1)
        cand = ~bad & spread_over & (n_hard <= 1)
        pools = {}
        for c in hard:
            _M, own, _sg, kind = slot[c]
            is_spread = (kind == C_SPREAD_HARD) & (own >= 0)
            pools[c] = (is_spread,
                        torch.nonzero(cand & is_spread).squeeze(1))
        if any(rows.numel() for _s, rows in pools.values()):
            with torch.profiler.record_function("full.cohort"):
                accept = _cohort(f, state, idx, cl, accept, cand, slot,
                                 pools, inc_sg_t)
    # ---- commit: rejected claims add zeros ----
    accf = accept.to(torch.float32)
    used.index_add_(0, cl, req * accf[:, None])
    used_nz.index_add_(0, cl, req_nz * accf[:, None])
    npods.index_add_(0, cl, accf)
    if f.any_ports:
        state["port_mask"].index_add_(0, cl, pod["ports"][idx]
                                      * accf[:, None])
        state["port_mask"].clamp_(max=1.0)
    dom_acc = dom_sg[:, cl]                               # [SG,H]
    cd_sg.scatter_add_(1, dom_acc.clamp(min=0).long(),
                       pod["inc_sg"][idx].T * accf * (dom_acc >= 0))
    dom_acc_a = dom_asg[:, cl]                            # [ASG,H]
    cd_asg.scatter_add_(1, dom_acc_a.clamp(min=0).long(),
                        pod["inc_asg"][idx].T * accf * (dom_acc_a >= 0))
    return accept


def _cohort(f: _Full, state, idx, cl, accept, cand, slot, pools, inc_sg_t):
    """The spread cohort's water-filling admission (A:606-705): a pour
    onto a current-minimum domain is always sequentially valid, so a
    candidate at new-rank r' in domain d admits when count_d +
    committed_d + r' + self <= min over eligible domains of (count +
    committed + pool) + maxSkew.  COHORT_ITERS fixpoint rounds.  `pools`
    maps each hard-spread slot to (its spread claimants, the candidates
    among them): the floor is only read for candidates, so it is only
    computed for them."""
    pod, dom_sg = f.pod, f.static["dom_sg"]
    cd_sg = state["cd_sg"]
    dom_acc0 = dom_sg[:, cl]                              # [SG,H]
    ix0 = dom_acc0.clamp(min=0).long()
    inc0 = inc_sg_t & (dom_acc0 >= 0)
    dom_ix = dom_sg.clamp(min=0).long()
    committed = accept
    for _it in range(COHORT_ITERS):
        new_ok = cand & ~committed
        m_sg = torch.zeros_like(cd_sg).scatter_add_(
            1, ix0, (inc0 & committed[None, :]).to(torch.float32))
        pool = torch.zeros_like(cd_sg).scatter_add_(
            1, ix0, (inc0 & new_ok[None, :]).to(torch.float32))
        fill = cd_sg + m_sg + pool
        gath = torch.where(dom_sg >= 0, fill.gather(1, dom_ix), float("inf"))
        ok_all = new_ok
        for c, (is_spread, rows) in pools.items():
            M, own, sg, _kind = slot[c]
            level = torch.zeros(idx.shape[0], dtype=torch.float32,
                                device=idx.device)
            if rows.numel():
                level[rows] = _rowmin_masked(f, gath, idx[rows], sg[rows])
            level = level + pod["c_maxskew"][idx, c]
            rprime = (M & new_ok[None, :]).sum(1).to(torch.float32)
            own_ix = own.clamp(min=0).long()
            cond = (cd_sg[sg, own_ix] + m_sg[sg, own_ix] + rprime
                    + pod["c_selfmatch"][idx, c]) <= level
            ok_all = ok_all & (~is_spread | cond)
        committed = committed | (new_ok & ok_all)
    return committed


def _full_wave(f: _Full, state: dict, assigned, active, act):
    """One wave of the full variant over the active pods `act`
    (ascending): the claims, the resolve among the claimants, the commit.
    Mutates the state aggregates, `assigned` and `active` in place."""
    with torch.profiler.record_function("full.claims"):
        node = _node_side(f, state)
        claims, minm, boot = _claims_full(f, state, node, act)
    h = torch.nonzero(claims >= 0).squeeze(1)
    idx, cl = act[h], claims[h]
    with torch.profiler.record_function("full.resolve"):
        accept = _resolve_and_commit(f, state, node, idx, cl, minm[h],
                                     boot[h])
    assigned[idx] = torch.where(accept, cl.to(torch.int32), assigned[idx])
    active[idx] = ~accept
    active &= accept.any()  # no progress -> give up


def build_packed_assign_fn(caps: Caps, p_cap: int, k_cap: int = 1024,
                           weights: dict[str, float] | None = None,
                           features: frozenset = ALL_FEATURES,
                           max_waves: int | None = None,
                           claims_noise: str = "sin", device=None):
    """fn(state, static_node, buf) -> (state, result).

    `state` holds the resident aggregates (STATE_KEYS) and is updated in
    place; `static_node` holds alloc, maxpods, valid and taint_mask, and
    for the full variant also label_mask, key_mask, dom_sg, dom_asg and
    (optionally) sg_ns_mask and asg_ns_mask; `buf` is the f32 wire buffer
    from pack_pod_batch, on the device.  `result` is int32[p_cap+2]: the
    assigned node row per pod slot (-1 when unplaced), the wave count, and
    the state generation after this step.

    `features` is PLAIN_FEATURES or ALL_FEATURES, the JAX package's two
    variants.  `max_waves` overrides the wave ceiling (128 plain,
    max(128, p_cap) full: hard constraints can serialize admission).
    `claims_noise` ("sin" or "murmur") is the plain main phase's
    tie-break rule; the full variant's is murmur.  `weights` overrides the
    spread and affinity score weights; the fit, balanced and taint
    weights stay 1.0, the only values whose float contraction in the
    reference is established (ROADMAP R4)."""
    if claims_noise not in kernels.NOISE_KINDS:
        raise ValueError(f"claims_noise={claims_noise!r}: must be one of "
                         f"{kernels.NOISE_KINDS}")
    if features not in (PLAIN_FEATURES, ALL_FEATURES):
        raise ValueError("features: PLAIN_FEATURES or ALL_FEATURES")
    w = {"fit": 1.0, "balanced": 1.0, "spread": 2.0, "affinity": 1.0,
         "taint": 1.0, **(weights or {})}
    if (w["fit"], w["balanced"], w["taint"]) != (1.0, 1.0, 1.0):
        raise ValueError("weights: fit, balanced and taint must stay 1.0")
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        # TF32 keeps ~10 mantissa bits: the [P,P] prefix sums E @ req would
        # round request sums and admit or reject the wrong pods
        raise RuntimeError("the wave step needs full-f32 matmuls: turn "
                           "TF32 off (torch.backends.cuda.matmul.allow_tf32"
                           " = False, float32 matmul precision 'highest')")
    dev = resolve_device(device)
    plain = features == PLAIN_FEATURES
    spec = PackSpec(caps, p_cap, k_cap, plain=plain)
    if max_waves is None:
        max_waves = MAX_WAVES if plain else max(MAX_WAVES, p_cap)

    def finish(state, assigned, waves):
        state["gen"] += 1
        result = torch.empty(p_cap + 2, dtype=torch.int32, device=dev)
        result[:p_cap] = assigned
        result[p_cap] = waves
        result[p_cap + 1] = state["gen"]
        return state, result

    if not plain:
        noise = []   # murmur noise keyed on (pod slot, node), built once

        def fn_full(state, static_node, buf):
            pod, prow, pval = _unpack(buf, spec)
            _apply_patches(state, prow, pval, caps)
            n = static_node["alloc"].shape[0]
            if not noise or noise[0].shape[1] != n:
                table = torch.empty((p_cap, n), dtype=torch.float32,
                                    device=dev)
                ids = torch.arange(p_cap, dtype=torch.int32, device=dev)
                for lo, hi in _row_chunks(p_cap, n, _FULL_CELLS // 4):
                    table[lo:hi] = kernels.murmur_noise(ids[lo:hi], n)
                noise[:] = [table]
            f = _Full(caps, static_node, pod, noise[0], w)
            assigned = torch.full((p_cap,), -1, dtype=torch.int32,
                                  device=dev)
            active = pod["p_valid"].clone()
            waves = 0
            while waves < max_waves:
                act = torch.nonzero(active).squeeze(1)  # one count read
                if not act.numel():
                    break
                _full_wave(f, state, assigned, active, act)
                waves += 1
            return finish(state, assigned, waves)

        return fn_full, spec

    tail_p = TAIL_P if p_cap > TAIL_P else 0
    pod_ids = torch.arange(p_cap, dtype=torch.int32, device=dev)
    earlier = torch.tril(torch.ones((p_cap, p_cap), dtype=torch.bool,
                                    device=dev), diagonal=-1)
    earlier_tail = earlier[:tail_p, :tail_p] if tail_p else None

    def fn(state, static_node, buf):
        pod, prow, pval = _unpack(buf, spec)
        _apply_patches(state, prow, pval, caps)
        smask = static_mask_t(static_node["valid"],
                              taint_bits(static_node["taint_mask"]),
                              pod["untol_bits"])
        main = _SubBatch(pod["req"], pod["req_nz"], smask, pod_ids,
                         static_node, earlier)
        assigned = torch.full((p_cap,), -1, dtype=torch.int32, device=dev)
        active = pod["p_valid"].clone()
        assigned, active, waves = _wave_loop(
            static_node, state, main, assigned, active, claims_noise, 0,
            max_waves, tail_p)
        if tail_p and waves < max_waves and bool(active.any()):
            # gather the (at most tail_p) still-active pods to the front in
            # ascending index order; padding rows gather INACTIVE pods,
            # which commit nothing in the sub-loop
            idx = torch.argsort((~active).to(torch.uint8),
                                stable=True)[:tail_p]
            sub = _SubBatch(pod["req"][idx], pod["req_nz"][idx],
                            smask[:, idx], idx.to(torch.int32), static_node,
                            earlier_tail)
            sub_assigned, sub_active, waves = _wave_loop(
                static_node, state, sub, assigned[idx], active[idx],
                "murmur", waves, max_waves, 0)
            assigned[idx] = sub_assigned
            active[idx] = sub_active
        return finish(state, assigned, waves)

    return fn, spec
