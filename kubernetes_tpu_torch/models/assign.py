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

One step serves one device and a mesh of node shards alike (make_step
over a _Comm, the counterpart of JAX's shard_map'd core, A:93-173 and
A:292-792): every node-side array is a list of per-shard row slabs, the
pod side and the replicated count tables live on the first shard's
device, and every reduction over the node axis goes through the comm
(psum, row max/min, the global first-index argmax, gathers by global
node).  On a plain wave each shard launches the claims kernel over its
own nodes at its node offset; on a full wave each shard builds its
[rows, n_loc] planes.  The resolve reads the claimed nodes' columns
through gather_cols, the constraint slots' [H,H] blocks are resolved per
pod slab, and each shard commits the accepted claims in its slab.  With
one shard every collective is the identity and the step is the
single-device one (build_packed_assign_fn).  The sharded path's plain
noise is murmur (quirk R3: JAX's sharded path never runs Pallas).

The full step marks its stages for torch.profiler (record_function
"full.static", "full.claims", "full.resolve" and, inside the resolve,
"full.cohort"); without a profiler they cost a few microseconds a wave.

Differences from the JAX version, none of which changes a result:
  * the wave loop is a Python loop; its condition reads one count from
    the device per wave;
  * the resident state is updated in place (JAX donated it);
  * commits go through index_add_ / scatter_add_ over the claims, the
    rejected ones (and, per shard, the other shards' nodes) adding zeros,
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
the same.  A score weight folds into the constant it multiplies first
(50 * w_fit, 100 * w_bal, rounded to f32), and the taint weight's product
is hoisted out of the wave loop, so it is rounded on its own.  Every other
product that feeds an add there is exact (integer counts and weights,
powers of two) or reaches the add through a select.

The snapshot form (make_assign_core / build_assign_fn, A:272-282,
A:929-934) runs one batch on whole node arrays: mode="wave" is the full
step above on one shard at murmur with the 128-wave ceiling (R11), and
mode="scan" the strict one-pod-at-a-time solver, the parity oracle
(_make_scan_core, A:794-926; see _scan_pods for its contraction points,
ROADMAP R12).

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


# ---------------------------------------------------------------------------
# Collectives: the node axis split across shards
# ---------------------------------------------------------------------------

COLLECTIVE_KINDS = ("all-reduce", "reduce-scatter", "all-gather",
                    "broadcast")
INF = float("inf")


class _Comm:
    """The reduction layer of the wave step (A:93-173) over a mesh of node
    shards driven by one controller: shard s holds node rows
    [s * n_loc, (s + 1) * n_loc) on devices[s]; the pod side and the
    replicated aggregates live on devices[0] (`home`).  A collective is
    torch arithmetic on the shards' tensors, with a copy where two shards'
    devices differ (none when shards share a card or the CPU).  A
    replicated result is a list with one copy per shard, so shard s reads
    its own.  With one shard every operation is the identity, as
    axis_name=None is in JAX.

    Each collective adds the bytes of one shard's result to `counts`
    (phase -> kind -> bytes; calls under kind + " calls"), the quantity the
    JAX census reads off the HLO: all-reduce the whole result,
    reduce-scatter one slab, all-gather the gathered array.  "broadcast" is
    the port's own kind: pod-side arrays and aggregates computed once on
    home and copied to the shards, which JAX computes or holds on every
    shard.  `phase` ("call" or "wave") says which tally counts; a
    one-shard comm counts nothing.  The counts are those of a mesh of
    distinct devices, whether or not the shards share one."""

    def __init__(self, devices, n_loc: int = 0):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices or len({d.type for d in self.devices}) > 1:
            raise ValueError("a mesh is one or more devices of one type")
        self.n_shards = len(self.devices)
        self.home = self.devices[0]
        self.n_loc = n_loc
        self.phase = "call"
        self.reset_counts()

    def reset_counts(self) -> None:
        self.counts = {ph: {k: 0 for kind in COLLECTIVE_KINDS
                            for k in (kind, kind + " calls")}
                       for ph in ("call", "wave")}

    def _count(self, kind: str, t) -> None:
        if self.n_shards > 1:
            tally = self.counts[self.phase]
            tally[kind] += t.numel() * t.element_size()
            tally[kind + " calls"] += 1

    def to(self, x, s: int):
        """x on shard s's device."""
        d = self.devices[s]
        return x if x.device == d else x.to(d, non_blocking=True)

    def replicated(self, x) -> list:
        """One copy of home's x per shard, uncounted (a result's spread)."""
        return [self.to(x, s) for s in range(self.n_shards)]

    def bcast(self, x) -> list:
        """A home array computed once, copied to every shard."""
        self._count("broadcast", x)
        return self.replicated(x)

    def bcast_tree(self, tree: dict) -> list[dict]:
        """bcast of every array of a dict: one dict per shard."""
        if self.n_shards == 1:
            return [tree]
        per = {k: self.bcast(v) for k, v in tree.items()}
        return [{k: v[s] for k, v in per.items()}
                for s in range(self.n_shards)]

    def my_offset(self, s: int) -> int:
        return s * self.n_loc

    def slabs(self, rows: int) -> list[tuple[int, int, int]]:
        """(shard, lo, hi): the contiguous row slab each shard resolves."""
        S = self.n_shards
        return [(s, s * rows // S, (s + 1) * rows // S) for s in range(S)]

    def _reduce(self, xs, op) -> list:
        if self.n_shards == 1:
            return list(xs)
        out = xs[0]
        for x in xs[1:]:
            out = op(out, x.to(self.home, non_blocking=True))
        self._count("all-reduce", out)
        return self.replicated(out)

    def psum(self, xs) -> list:
        return self._reduce(xs, torch.add)

    def por(self, flags) -> list:
        """any across shards of each shard's bool array (JAX: a psum of
        int32, then > 0)."""
        if self.n_shards == 1:
            return list(flags)
        return [t > 0 for t in self.psum([f.to(torch.int32) for f in flags])]

    def any_rows(self, ms) -> list:
        """any over the node axis of [P, n_loc] bool -> [P]."""
        return self.por([m.any(-1) for m in ms])

    def rowmax(self, xs, masks, fill) -> list:
        return self._reduce([torch.where(m, x, fill).amax(-1, keepdim=True)
                             for x, m in zip(xs, masks)], torch.maximum)

    def rowmin(self, xs, masks, fill) -> list:
        return self._reduce([torch.where(m, x, fill).amin(-1, keepdim=True)
                             for x, m in zip(xs, masks)], torch.minimum)

    def all_gather(self, xs) -> list:
        """The shards' pieces concatenated along dim 0 (tiled)."""
        if self.n_shards == 1:
            return list(xs)
        out = torch.cat([x.to(self.home, non_blocking=True) for x in xs])
        self._count("all-gather", out)
        return self.replicated(out)

    def row_argmax(self, bests, idxs) -> tuple[list, list]:
        """Global (index, best) per row from each shard's first-index
        argmax over its nodes (A:120-131): the first shard among equal
        bests, then that shard's local index."""
        if self.n_shards == 1:
            return list(idxs), list(bests)
        best_all = torch.stack([b.to(self.home, non_blocking=True)
                                for b in bests])
        idx_all = torch.stack([i.to(self.home, non_blocking=True)
                               for i in idxs])
        self._count("all-gather", best_all)
        self._count("all-gather", idx_all)
        shard = torch.argmax(best_all, 0)           # first among equals
        p = torch.arange(best_all.shape[1], device=self.home)
        j = (shard * self.n_loc).to(idx_all.dtype) + idx_all[shard, p]
        return self.replicated(j), self.replicated(best_all[shard, p])

    def _owned(self, arrs, gidx):
        """Each shard's addends of a gather by global column: its own
        columns' values, zeros elsewhere; and which columns it owns."""
        vals, seen = [], []
        for s, (arr, g) in enumerate(zip(arrs, gidx)):
            local = g - self.my_offset(s)
            inr = (local >= 0) & (local < self.n_loc) & (g >= 0)
            v = arr.index_select(-1, local.clamp(0, self.n_loc - 1).long())
            vals.append(torch.where(inr, v, torch.zeros((), dtype=v.dtype,
                                                        device=v.device)))
            seen.append(inr)
        return vals, seen

    def _fill(self, outs, seen, fill) -> list:
        if fill == 0:
            return outs
        seen = self.por(seen)
        return [torch.where(sn, o, fill if o.is_floating_point()
                            else int(fill)) for o, sn in zip(outs, seen)]

    def gather_cols(self, arrs, gidx, fill=0.0) -> list:
        """arr[..., gidx] for GLOBAL node indices gidx (replicated: one
        copy per shard), where arrs[s] holds shard s's columns (node axis
        last).  The psum of the owners' values, as JAX's: exactly one shard
        owns a column and the others add zeros (so an owner's -0.0 comes
        out +0.0 on a mesh, as in JAX).  An out-of-range index (-1) yields
        `fill`."""
        vals, seen = self._owned(arrs, gidx)
        return self._fill(self.psum(vals), seen, fill)

    def gather_cols_rs(self, arrs, gidx, fill=0.0) -> list:
        """gather_cols, slab form: the same addends, but shard s keeps only
        its s-th slab of the leading axis (a reduce-scatter), so it
        receives 1/S of the all-reduce's bytes.  The leading axis must
        divide by the mesh size."""
        S = self.n_shards
        if S == 1:
            return self.gather_cols(arrs, gidx, fill)
        L = arrs[0].shape[0]
        if L % S:
            raise ValueError(f"gather_cols_rs: {L} rows do not divide by "
                             f"{S} shards")
        w = L // S
        vals, seen = self._owned(arrs, gidx)
        slabs = []
        for s in range(S):
            slab = self.to(vals[0][s * w:(s + 1) * w], s)
            for v in vals[1:]:
                slab = slab + self.to(v[s * w:(s + 1) * w], s)
            slabs.append(slab)
        self._count("reduce-scatter", slabs[0])
        return self._fill(slabs, seen, fill)


# ---------------------------------------------------------------------------
# The plain variant
# ---------------------------------------------------------------------------

class _SubBatch:
    """The pod-side inputs one wave loop reads: the claims kernel's static
    inputs on every shard (requests, the shard's node arrays and static
    mask [n_loc, P]), the noise keys and rule, and the [P,P] queue order."""

    def __init__(self, comm, nodes, req, req_nz, smasks, pod_ids, earlier,
                 noise):
        reqs, req_nzs = comm.bcast(req), comm.bcast(req_nz)
        self.kstatic = [kernels.prepare_static(reqs[s], req_nzs[s],
                                               nd["alloc"], nd["maxpods"],
                                               smasks[s])
                        for s, nd in enumerate(nodes)]
        self.reqs = [k["req"] for k in self.kstatic]
        self.req_nzs = [k["req_nz"] for k in self.kstatic]
        self.req = self.reqs[0]
        self.pod_ids = comm.bcast(pod_ids)
        self.earlier = earlier
        self.noise = noise


def _commit_rows(comm, cl, weight, n_loc: int, s: int):
    """(local rows, weights) of shard s's commit: the claims that land in
    its slab keep their weight, the others (and -1) add zeros."""
    local = cl - comm.my_offset(s)
    inside = (local >= 0) & (local < n_loc)
    return local.clamp(0, n_loc - 1).long(), weight * inside


def _wave(comm, nodes, b: _SubBatch, assigned, active):
    """One wave: claims, conflict resolution in pod order, commit.
    Mutates the shards' aggregates in place; returns (assigned, active).
    Each shard claims over its own nodes (the kernel at its node offset),
    the shards' bests combine through row_argmax, the resolve runs on the
    home device over the claimed nodes' gathered columns, and each shard
    commits the accepted claims that land in its slab."""
    n_loc = nodes[0]["alloc"].shape[0]
    actives = comm.bcast(active)
    got = [kernels.claims(b.kstatic[s], actives[s], nd["used"],
                          nd["used_nz"], nd["npods"], noise=b.noise,
                          pod_ids=b.pod_ids[s],
                          node_offset=comm.my_offset(s))
           for s, nd in enumerate(nodes)]
    has_r = comm.por([c >= 0 for c, _best in got])
    idx_r, _best_r = comm.row_argmax([bst for _c, bst in got],
                                     [c for c, _bst in got])
    cl_r = [torch.where(h, j, -1) for h, j in zip(has_r, idx_r)]
    claims, has = cl_r[0], has_r[0]
    # E[p, q] = 1 when q < p claimed the same node (both claims live)
    E = ((claims[:, None] == claims[None, :]) & has[:, None] & has[None, :]
         & b.earlier).to(torch.float32)
    prefR = E @ b.req                                    # [P,R]
    prefN = E.sum(1)                                     # [P]
    avail_claim = comm.gather_cols(
        [(nd["alloc"] - nd["used"]).T for nd in nodes], cl_r)[0].T
    npods_claim = comm.gather_cols([nd["npods"] for nd in nodes], cl_r)[0]
    maxp_claim = comm.gather_cols([nd["maxpods"] for nd in nodes], cl_r)[0]
    res_ok = (b.req + prefR <= avail_claim).all(1)
    res_ok &= npods_claim + prefN + 1.0 <= maxp_claim
    accept = has & active & res_ok
    # commit: index_add_ of exact per-node sums == the JAX one-hot matmul;
    # rejected claims add zeros
    accfs = comm.bcast(accept.to(torch.float32))
    for s, nd in enumerate(nodes):
        rows, wt = _commit_rows(comm, cl_r[s], accfs[s], n_loc, s)
        nd["used"].index_add_(0, rows, b.reqs[s] * wt[:, None])
        nd["used_nz"].index_add_(0, rows, b.req_nzs[s] * wt[:, None])
        nd["npods"].index_add_(0, rows, wt)
    assigned = torch.where(accept, claims, assigned)
    progress = accept.any()
    active = active & ~accept & progress  # no progress -> give up
    return assigned, active


def _wave_loop(comm, nodes, b, assigned, active, waves, max_waves, stop_at):
    """Run waves while some pod is active, under the wave ceiling, and
    while more than `stop_at` pods are active (one count read per
    wave).  Returns (assigned, active, waves)."""
    while waves < max_waves:
        # sync-point: one count read a wave decides whether another runs
        n_active = int(active.sum())
        if n_active == 0 or n_active <= stop_at:
            break
        assigned, active = _wave(comm, nodes, b, assigned, active)
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


# the pod-side fields the shards read (copied to each shard once a call)
_SHARD_POD_KEYS = ("req", "req_nz", "untol_bits", "prefer_bits", "port_bits",
                   "keyforb_bits", "sel_active", "key_active", "node_row",
                   "c_kind", "c_selfmatch", "c_maxskew", "c_weight",
                   "sel_ids", "forb_ids", "key_ids")


class _Full:
    """One call's batch-wide inputs of the full variant: the pod fields
    (on home, and the ones the shards read on every shard), the node
    shards and the replicated arrays, which selector groups, id slots,
    constraint kinds, ports and existing-anti groups the batch uses (read
    once, so the waves skip what no pod needs), and each shard's
    [P, n_loc] static planes."""

    def __init__(self, caps: Caps, comm, nodes: list, rep: dict, pod: dict,
                 noises: list, w: dict):
        self.caps, self.comm, self.nodes, self.rep, self.pod = (
            caps, comm, nodes, rep, pod)
        self.noises, self.w = noises, w
        self.c_score = kernels.score_constants(w)
        # the PreferNoSchedule score of a batch that tolerates every such
        # taint: 100 in every cell, times the taint weight
        self.taint_full = float(np.float32(100.0) * np.float32(w["taint"]))
        self.n_loc = N = nodes[0]["alloc"].shape[0]
        self.node_idx = [comm.my_offset(s) + torch.arange(N, device=d)
                         for s, d in enumerate(comm.devices)]
        _fold_ns_masks(rep, pod)
        self.c_sg = pod["c_sg"].clamp(min=0).long()
        self.match_bits = _bit_columns(pod["match_asg"]).to(torch.int32)
        P = pod["req"].shape[0]
        C, G, KG = caps.c_cap, caps.g_cap, caps.kg_cap
        # sync-point: what the batch uses, in one host read
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
        self.pods = comm.bcast_tree(
            {**{k: pod[k] for k in _SHARD_POD_KEYS}, "c_sg": self.c_sg,
             "match_bits": self.match_bits})

        def plane(dtype):
            return [torch.empty((P, N), dtype=dtype, device=d)
                    for d in comm.devices]
        self.sel_mask = plane(torch.bool)
        self.static_mask = plane(torch.bool)
        self.static_score = plane(torch.float32) if self.any_prefer else None
        with torch.profiler.record_function("full.static"):
            self._static_mask_and_score()

    def _static_mask_and_score(self) -> None:
        """Vectorized P x N feasibility independent of in-batch placements
        (A:176-225), in chunks of rows, per shard: sel_mask (node selector
        and affinity only: the spread min-match domain set), static_mask
        (sel_mask and taints and the nodeName pin) and static_score (the
        PreferNoSchedule score, 0..100, its row max over every shard; None
        when no pod of the batch fails to tolerate a PreferNoSchedule
        taint: then it is 100 in every cell, as mx == 0 makes it)."""
        tabs = []
        for st in self.nodes:
            tabs.append({
                "valid": st["valid"].bool(),
                "label_t": (st["label_mask"] > 0).T.contiguous(),  # [L, N]
                "key_t": (st["key_mask"] > 0).T.contiguous(),      # [KL, N]
                "tbits": taint_bits(st["taint_mask"]),
                "kbits": (_bit_columns(st["key_mask"]) if self.any_keyforb
                          else None)})
        P = self.pod["req"].shape[0]
        for lo, hi in _row_chunks(P, self.n_loc):
            smasks, cnts = [], []
            for s, (tab, pod) in enumerate(zip(tabs, self.pods)):
                sel = tab["valid"][None, :].expand(hi - lo, self.n_loc).clone()
                for g in self.groups:
                    hits = _any_id(tab["label_t"], pod["sel_ids"][lo:hi, g],
                                   self.sel_slots[g])
                    sel &= hits | ~pod["sel_active"][lo:hi, g, None]
                for g in self.key_groups:
                    hits = _any_id(tab["key_t"], pod["key_ids"][lo:hi, g],
                                   self.key_slots[g])
                    sel &= hits | ~pod["key_active"][lo:hi, g, None]
                if self.forb_slots:
                    sel &= ~_any_id(tab["label_t"], pod["forb_ids"][lo:hi],
                                    self.forb_slots)
                if tab["kbits"] is not None:
                    sel &= (pod["keyforb_bits"][lo:hi, None]
                            & tab["kbits"][None, :]) == 0
                self.sel_mask[s][lo:hi] = sel
                row = pod["node_row"][lo:hi, None]
                smask = (sel & ((pod["untol_bits"][lo:hi, None]
                                 & tab["tbits"][None, :]) == 0)
                         & ((row < 0) | (self.node_idx[s][None, :] == row)))
                self.static_mask[s][lo:hi] = smask
                smasks.append(smask)
                if self.static_score is not None:
                    cnts.append(_popcount(pod["prefer_bits"][lo:hi, None]
                                          & tab["tbits"][None, :])
                                .to(torch.float32))
            if self.static_score is not None:
                mxs = self.comm.rowmax(cnts, smasks, 0.0)
                for s, (mx, cnt) in enumerate(zip(mxs, cnts)):
                    self.static_score[s][lo:hi] = torch.where(
                        mx > 0, (mx - cnt) * 100.0 / torch.clamp(mx, min=1.0),
                        100.0)


def _node_side(f: _Full) -> list[dict]:
    """Per-wave node-side inputs of every shard: free capacity, the
    pod-count cap, the host-port and existing-anti-group bitmasks, and the
    [SG, n_loc] domain counts gathered once at the group level (A:401-442)
    from its copy of the replicated count tables."""
    cds = f.comm.bcast(f.rep["cd_sg"])
    cdas = f.comm.bcast(f.rep["cd_asg"]) if f.any_match else None
    out = []
    for s, st in enumerate(f.nodes):
        dom_sg, dom_asg = st["dom_sg"], st["dom_asg"]
        nd = {"avail": st["alloc"] - st["used"],
              "cap_ok": st["npods"] + 1.0 <= st["maxpods"],
              "cd_sg": cds[s],
              "gath_sg_all": torch.where(
                  dom_sg >= 0, cds[s].gather(1, dom_sg.clamp(min=0).long()),
                  0.0)}
        if f.any_ports:
            nd["port_bits"] = _bit_columns(st["port_mask"]).to(torch.int32)
        if f.any_match:
            acnt = torch.where(
                dom_asg >= 0,
                cdas[s].gather(1, dom_asg.clamp(min=0).long()), 0.0)
            nd["asg_bits"] = _bit_columns((acnt > 0).T).to(torch.int32)
        out.append(nd)
    return out


def _claims_full(f: _Full, node: list, rows):
    """The XLA wave body (A:411-492) for pod rows `rows`: the fit, host-
    port and existing-anti masks, LeastAllocated + BalancedAllocation, the
    PreferNoSchedule score, the constraint-slot loop (required spread,
    affinity and anti-affinity masks, spread and preferred-affinity
    scores), murmur noise and the masked first-index argmax, each shard
    over its own nodes, the node-axis reductions through the comm.
    Returns (claims int64 [rows] of global nodes, -1 where nothing is
    feasible; minmatch f32 [rows, C]; affinity-bootstrap flags bool
    [rows, C]), on home."""
    comm, w = f.comm, f.w
    R, C = f.caps.r, f.caps.c_cap
    dev = comm.home
    B = rows.shape[0]
    claims = torch.empty(B, dtype=torch.int64, device=dev)
    minm = torch.zeros((B, C), dtype=torch.float32, device=dev)
    boot = torch.zeros((B, C), dtype=torch.bool, device=dev)
    rows_r = comm.bcast(rows)
    shards = list(zip(f.nodes, node, f.pods))
    for lo, hi in _row_chunks(B, f.n_loc):
        rr = [r[lo:hi] for r in rows_r]
        masks, scores = [], []
        for s, (st, nd, pod) in enumerate(shards):
            r = rr[s]
            req = pod["req"][r]
            mask = f.static_mask[s][r] & nd["cap_ok"][None, :]
            for k in range(R):
                mask &= req[:, k, None] <= nd["avail"][None, :, k]
            if f.any_ports:
                mask &= (pod["port_bits"][r, None]
                         & nd["port_bits"][None, :]) == 0
            if f.any_match:
                mask &= (pod["match_bits"][r, None]
                         & nd["asg_bits"][None, :]) == 0
            score = kernels.fit_score(*kernels.utilizations(
                pod["req_nz"][r], st["alloc"], st["used_nz"]), *f.c_score)
            masks.append(mask)
            # XLA hoists w_taint * static_score out of the wave loop: a
            # product rounded on its own, then added (R12)
            scores.append(score + (f.static_score[s][r] * w["taint"]
                                   if f.static_score is not None
                                   else f.taint_full))
        for c in f.slots:
            kinds = f.kinds[c]
            kind = [pod["c_kind"][r, c] for (_st, _nd, pod), r
                    in zip(shards, rr)]
            sg = [pod["c_sg"][r, c] for (_st, _nd, pod), r in zip(shards, rr)]
            gathered = [nd["gath_sg_all"][g] for (_st, nd, _p), g
                        in zip(shards, sg)]                # [rows, n_loc]
            has_dom = [st["dom_sg"][g] >= 0 for (st, _nd, _p), g
                       in zip(shards, sg)]
            if kinds & {C_SPREAD_HARD, C_AFFINITY, C_ANTI_AFFINITY}:
                selfm = [pod["c_selfmatch"][r, c] for (_st, _nd, pod), r
                         in zip(shards, rr)]
                oks = [torch.ones_like(m) for m in masks]
                if C_SPREAD_HARD in kinds:
                    mms = comm.rowmin(
                        gathered, [f.sel_mask[s][r] & hd for s, (r, hd)
                                   in enumerate(zip(rr, has_dom))], INF)
                    mms = [torch.where(torch.isfinite(mm), mm, 0.0)
                           for mm in mms]
                    minm[lo:hi, c] = mms[0][:, 0]
                    for s, (_st, _nd, pod) in enumerate(shards):
                        spread_ok = ((gathered[s] + selfm[s][:, None]
                                      - mms[s])
                                     <= pod["c_maxskew"][rr[s], c, None]
                                     ) & has_dom[s]
                        oks[s] = torch.where(kind[s][:, None] == C_SPREAD_HARD,
                                             spread_ok, oks[s])
                if C_AFFINITY in kinds:
                    for s, (_st, nd, _pod) in enumerate(shards):
                        bt = (nd["cd_sg"][sg[s]].sum(1) == 0) & (selfm[s] > 0)
                        if s == 0:
                            boot[lo:hi, c] = (kind[0] == C_AFFINITY) & bt
                        aff_ok = ((gathered[s] > 0) | bt[:, None]) \
                            & has_dom[s]
                        oks[s] = torch.where(kind[s][:, None] == C_AFFINITY,
                                             aff_ok, oks[s])
                if C_ANTI_AFFINITY in kinds:
                    for s in range(len(shards)):
                        anti_ok = ~has_dom[s] | (gathered[s] == 0)
                        oks[s] = torch.where(
                            kind[s][:, None] == C_ANTI_AFFINITY, anti_ok,
                            oks[s])
                for m, ok in zip(masks, oks):
                    m &= ok
            if C_SPREAD_SCORE in kinds:
                smxs = comm.rowmax(gathered, masks, 0.0)
                smns = comm.rowmin(gathered, masks, INF)
                for s in range(len(shards)):
                    smn = torch.where(torch.isfinite(smns[s]), smns[s], 0.0)
                    rng = torch.clamp(smxs[s] - smn, min=1.0)
                    spread_score = (smxs[s] - gathered[s]) * 100.0 / rng
                    scores[s] = scores[s] + torch.where(
                        kind[s][:, None] == C_SPREAD_SCORE,
                        w["spread"] * spread_score, 0.0)
            if C_PREF_AFFINITY in kinds:
                for s, (_st, _nd, pod) in enumerate(shards):
                    cw = (w["affinity"] * pod["c_weight"][rr[s], c])[:, None]
                    scores[s] = scores[s] + torch.where(
                        kind[s][:, None] == C_PREF_AFFINITY,
                        cw * gathered[s], 0.0)
        bests, idxs = [], []
        for s, (m, sc) in enumerate(zip(masks, scores)):
            masked = torch.where(m, sc + f.noises[s][rr[s]], kernels.NEG)
            best, idx = torch.max(masked, dim=1)   # first index of the max
            bests.append(best)
            idxs.append(idx)
        has = comm.any_rows(masks)[0]
        j = comm.row_argmax(bests, idxs)[0][0]
        claims[lo:hi] = torch.where(has, j, -1)
    return claims, minm, boot


def _rowmin_masked(f: _Full, gath, rows_pod, sg):
    """min over the node axis, across the shards, of gath[s][sg] where
    the pod's sel_mask and the group's domain allow, inf -> 0 (the
    cohort's floor)."""
    comm = f.comm
    out = torch.empty(rows_pod.shape[0], dtype=torch.float32,
                      device=comm.home)
    rows_r, sg_r = comm.bcast(rows_pod), comm.bcast(sg)
    for lo, hi in _row_chunks(rows_pod.shape[0], f.n_loc):
        eligs, vals = [], []
        for s, st in enumerate(f.nodes):
            g = sg_r[s][lo:hi]
            eligs.append(f.sel_mask[s][rows_r[s][lo:hi]]
                         & (st["dom_sg"][g] >= 0))
            vals.append(gath[s][g])
        out[lo:hi] = comm.rowmin(vals, eligs, INF)[0][:, 0]
    return torch.where(torch.isfinite(out), out, 0.0)


def _slot_slabs(f: _Full, dom_cl, pc, c, kinds):
    """Slot c's [H,H] conflict block, resolved per pod slab (A:532-559,
    the rs form): shard s builds rows [lo, hi) of M[p, q] = "q < p claimed
    into p's domain under p's selector group and increments it" from its
    copy of the claimed nodes' domain table dom_cl [SG, H] (a row-select:
    no [H,H] collective), and its rows' counts come back through an
    all-gather.  Returns (the slabs of M, k_same f32 [H], and for an
    affinity slot whether any earlier claimant increments p's group)."""
    comm = f.comm
    Ms, k_same, inc_any = [], [], []
    for s, lo, hi in comm.slabs(dom_cl[0].shape[1]):
        d = comm.devices[s]
        H = dom_cl[s].shape[1]
        sg = pc[s]["c_sg"][lo:hi, c]
        p_ix = torch.arange(lo, hi, device=d)
        earlier = torch.arange(H, device=d)[None, :] < p_ix[:, None]
        Dpq = dom_cl[s][sg]                               # dom of q's claim
        own = Dpq[torch.arange(hi - lo, device=d), p_ix]  # under p's sg
        q_incs = pc[s]["inc_sg_t"][sg]                    # [rows, H]
        M = earlier & (Dpq == own[:, None]) & (own[:, None] >= 0) & q_incs
        del Dpq
        Ms.append(M)
        k_same.append(M.sum(1).to(torch.float32))
        if C_AFFINITY in kinds:
            inc_any.append((earlier & q_incs).any(1))
    return (Ms, comm.all_gather(k_same)[0],
            comm.all_gather(inc_any)[0] if inc_any else None)


def _resolve_and_commit(f: _Full, node: list, idx, cl, minm, boot):
    """Conflict resolution in pod order among the claimants `idx` (pod
    rows, ascending) of global nodes `cl`, then the commit (A:494-739):
    the resource prefix sums, host-port conflicts, per-slot anti-affinity
    serialization, the static spread quota and the affinity bootstrap,
    existing-anti conflicts, the spread cohort's water-filling, and the
    commit of every aggregate.  The claimed nodes' columns come through
    gather_cols; the constraint slots' [H,H] blocks are resolved per pod
    slab (_slot_slabs); each shard commits the accepted claims in its
    slab, and the replicated count tables commit on home.  Returns the
    accept mask over the claimants."""
    comm, pod, rep = f.comm, f.pod, f.rep
    cd_sg, cd_asg = rep["cd_sg"], rep["cd_asg"]
    H = idx.shape[0]
    dev = comm.home
    ar = torch.arange(H, device=dev)
    earlier = ar[None, :] < ar[:, None]                   # q < p
    cl_r = comm.bcast(cl)
    avail_cl = comm.gather_cols([nd["avail"].T for nd in node], cl_r)[0].T
    npods_cl = comm.gather_cols([st["npods"] for st in f.nodes], cl_r)[0]
    maxp_cl = comm.gather_cols([st["maxpods"] for st in f.nodes], cl_r)[0]
    dom_cl = comm.gather_cols([st["dom_sg"] for st in f.nodes], cl_r,
                              fill=-1)                    # [SG,H] per shard
    dom_acl = comm.gather_cols([st["dom_asg"] for st in f.nodes], cl_r,
                               fill=-1)[0]                # [ASG,H]
    req, req_nz = pod["req"][idx], pod["req_nz"][idx]
    E = (cl[:, None] == cl[None, :]) & earlier            # earlier same-node
    Ef = E.to(torch.float32)
    prefR = Ef @ req                                      # [H,R]
    prefN = Ef.sum(1)
    res_ok = (req + prefR <= avail_cl).all(1)
    res_ok &= npods_cl + prefN + 1.0 <= maxp_cl
    bad = ~res_ok
    if f.any_ports:
        pb = pod["port_bits"][idx]
        bad |= (E & ((pb[:, None] & pb[None, :]) != 0)).any(1)
    spread_over = torch.zeros(H, dtype=torch.bool, device=dev)
    inc_sg_t = pod["inc_sg"][idx].T > 0                  # [SG,H]
    pc = comm.bcast_tree({"c_sg": f.c_sg[idx], "inc_sg_t": inc_sg_t})
    slot = {}
    for c in f.slots:
        kinds = f.kinds[c]
        kind = pod["c_kind"][idx, c]
        sg = f.c_sg[idx, c]
        own = dom_cl[0][sg, ar]                          # p's own domain
        Ms, k_same, inc_any = _slot_slabs(f, dom_cl, pc, c, kinds)
        if C_ANTI_AFFINITY in kinds:
            bad |= (kind == C_ANTI_AFFINITY) & (k_same > 0)
        if C_SPREAD_HARD in kinds:
            own_ix = own.clamp(min=0).long()
            over = (cd_sg[sg, own_ix] + pod["c_selfmatch"][idx, c] + k_same
                    - minm[:, c]) > pod["c_maxskew"][idx, c]
            spread_over |= (kind == C_SPREAD_HARD) & (own >= 0) & over
        if C_AFFINITY in kinds:
            bad |= boot[:, c] & inc_any
        slot[c] = (Ms, own, sg, kind)
    for a in f.asg_slots:
        dom_a = dom_acl[a]
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
            _Ms, own, _sg, kind = slot[c]
            is_spread = (kind == C_SPREAD_HARD) & (own >= 0)
            # sync-point: the spread cohort's pods, read back per slot
            rows = torch.nonzero(cand & is_spread).squeeze(1)
            pools[c] = (is_spread, rows)
        if any(rows.numel() for _s, rows in pools.values()):
            with torch.profiler.record_function("full.cohort"):
                accept = _cohort(f, idx, dom_cl[0], accept, cand, slot,
                                 pools, inc_sg_t)
    # ---- commit: rejected claims (and other shards' nodes) add zeros ----
    accf = accept.to(torch.float32)
    pcom = comm.bcast_tree({"accf": accf, "req": req, "req_nz": req_nz,
                            **({"ports": pod["ports"][idx]}
                               if f.any_ports else {})})
    for s, st in enumerate(f.nodes):
        rows, wt = _commit_rows(comm, cl_r[s], pcom[s]["accf"], f.n_loc, s)
        st["used"].index_add_(0, rows, pcom[s]["req"] * wt[:, None])
        st["used_nz"].index_add_(0, rows, pcom[s]["req_nz"] * wt[:, None])
        st["npods"].index_add_(0, rows, wt)
        if f.any_ports:
            st["port_mask"].index_add_(0, rows,
                                       pcom[s]["ports"] * wt[:, None])
            st["port_mask"].clamp_(max=1.0)
    dom_acc = dom_cl[0]                                   # [SG,H]
    cd_sg.scatter_add_(1, dom_acc.clamp(min=0).long(),
                       pod["inc_sg"][idx].T * accf * (dom_acc >= 0))
    cd_asg.scatter_add_(1, dom_acl.clamp(min=0).long(),
                        pod["inc_asg"][idx].T * accf * (dom_acl >= 0))
    return accept


def _cohort(f: _Full, idx, dom_acc0, accept, cand, slot, pools, inc_sg_t):
    """The spread cohort's water-filling admission (A:606-705): a pour
    onto a current-minimum domain is always sequentially valid, so a
    candidate at new-rank r' in domain d admits when count_d +
    committed_d + r' + self <= min over eligible domains of (count +
    committed + pool) + maxSkew.  COHORT_ITERS fixpoint rounds.  `pools`
    maps each hard-spread slot to (its spread claimants, the candidates
    among them): the floor is only read for candidates, so it is only
    computed for them.  dom_acc0 [SG,H] holds the claimed nodes' domains;
    r' counts through each slot's M slabs, the floor through a rowmin
    across the shards."""
    comm, pod = f.comm, f.pod
    cd_sg = f.rep["cd_sg"]
    ix0 = dom_acc0.clamp(min=0).long()
    inc0 = inc_sg_t & (dom_acc0 >= 0)
    dom_ix = [st["dom_sg"].clamp(min=0).long() for st in f.nodes]
    slabs = comm.slabs(idx.shape[0])
    committed = accept
    for _it in range(COHORT_ITERS):
        new_ok = cand & ~committed
        m_sg = torch.zeros_like(cd_sg).scatter_add_(
            1, ix0, (inc0 & committed[None, :]).to(torch.float32))
        pool = torch.zeros_like(cd_sg).scatter_add_(
            1, ix0, (inc0 & new_ok[None, :]).to(torch.float32))
        fills = comm.bcast(cd_sg + m_sg + pool)
        gath = [torch.where(st["dom_sg"] >= 0, fl.gather(1, ix), INF)
                for st, fl, ix in zip(f.nodes, fills, dom_ix)]
        new_oks = comm.bcast(new_ok)
        ok_all = new_ok
        for c, (is_spread, rows) in pools.items():
            Ms, own, sg, _kind = slot[c]
            level = torch.zeros(idx.shape[0], dtype=torch.float32,
                                device=idx.device)
            if rows.numel():
                level[rows] = _rowmin_masked(f, gath, idx[rows], sg[rows])
            level = level + pod["c_maxskew"][idx, c]
            rprime = comm.all_gather([
                (M & new_oks[s][None, :]).sum(1).to(torch.float32)
                for (s, _lo, _hi), M in zip(slabs, Ms)])[0]
            own_ix = own.clamp(min=0).long()
            cond = (cd_sg[sg, own_ix] + m_sg[sg, own_ix] + rprime
                    + pod["c_selfmatch"][idx, c]) <= level
            ok_all = ok_all & (~is_spread | cond)
        committed = committed | (new_ok & ok_all)
    return committed


def _full_wave(f: _Full, assigned, active, act):
    """One wave of the full variant over the active pods `act`
    (ascending): the claims, the resolve among the claimants, the commit.
    Mutates the aggregates, `assigned` and `active` in place."""
    with torch.profiler.record_function("full.claims"):
        node = _node_side(f)
        claims, minm, boot = _claims_full(f, node, act)
    # sync-point: the claiming pods' count sizes the conflict pass
    h = torch.nonzero(claims >= 0).squeeze(1)
    idx, cl = act[h], claims[h]
    with torch.profiler.record_function("full.resolve"):
        accept = _resolve_and_commit(f, node, idx, cl, minm[h], boot[h])
    assigned[idx] = torch.where(accept, cl.to(torch.int32), assigned[idx])
    active[idx] = ~accept
    active &= accept.any()  # no progress -> give up


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

def _check_step_args(claims_noise, features, weights) -> dict:
    if claims_noise not in kernels.NOISE_KINDS:
        raise ValueError(f"claims_noise={claims_noise!r}: must be one of "
                         f"{kernels.NOISE_KINDS}")
    if features not in (PLAIN_FEATURES, ALL_FEATURES):
        raise ValueError("features: PLAIN_FEATURES or ALL_FEATURES")
    w = {"fit": 1.0, "balanced": 1.0, "spread": 2.0, "affinity": 1.0,
         "taint": 1.0, **(weights or {})}
    if (features == PLAIN_FEATURES
            and (w["fit"], w["balanced"], w["taint"]) != (1.0, 1.0, 1.0)):
        # the claims kernel bakes the default fit and balanced weights in
        # (the JAX plain path leaves Pallas for its XLA body then)
        raise ValueError("weights: the plain variant keeps fit, balanced "
                         "and taint at 1.0")
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        # TF32 keeps ~10 mantissa bits: the [P,P] prefix sums E @ req would
        # round request sums and admit or reject the wrong pods
        raise RuntimeError("the wave step needs full-f32 matmuls: turn "
                           "TF32 off (torch.backends.cuda.matmul.allow_tf32"
                           " = False, float32 matmul precision 'highest')")
    return w


def make_step(caps: Caps, comm: _Comm, p_cap: int, k_cap: int = 1024,
              weights: dict[str, float] | None = None,
              features: frozenset = ALL_FEATURES,
              max_waves: int | None = None, claims_noise: str = "sin"):
    """The wave step over `comm`'s shards: (step(nodes, rep, buf) ->
    result, spec).  `nodes[s]` holds shard s's node arrays (the dynamic
    DYN_STATE keys, updated in place, and the static ones the variant
    reads), `rep` the replicated ones on the home device (cd_sg, cd_asg
    and gen, updated in place; sg_ns_mask and asg_ns_mask when present),
    `buf` the packed wire buffer on home.  `result` is int32[p_cap+2] on
    home: the assigned GLOBAL node row per pod slot (-1 when unplaced), the
    wave count, and the state generation after this step.  The row
    patches are global rows: each shard applies the ones in its slab."""
    w = _check_step_args(claims_noise, features, weights)
    if claims_noise == "sin" and comm.n_shards > 1:
        raise ValueError("the sin noise is the single-device rule (R3): a "
                         "sharded step takes claims_noise='murmur'")
    dev = comm.home
    plain = features == PLAIN_FEATURES
    spec = PackSpec(caps, p_cap, k_cap, plain=plain)
    if max_waves is None:
        max_waves = MAX_WAVES if plain else max(MAX_WAVES, p_cap)

    def start(nodes, buf):
        comm.n_loc = nodes[0]["alloc"].shape[0]
        comm.phase = "call"
        pod, prow, pval = _unpack(buf, spec)
        prows, pvals = comm.bcast(prow), comm.bcast(pval)
        for s, nd in enumerate(nodes):
            local = prows[s] - comm.my_offset(s)
            _apply_patches(nd, torch.where(
                (prows[s] >= 0) & (local >= 0) & (local < comm.n_loc),
                local, -1), pvals[s], caps)
        return pod

    if not plain:
        run = make_full_run(caps, comm, p_cap, w, max_waves)

        def step_full(nodes, rep, buf):
            return run(nodes, rep, start(nodes, buf))

        return step_full, spec

    tail_p = TAIL_P if p_cap > TAIL_P else 0
    pod_ids = torch.arange(p_cap, dtype=torch.int32, device=dev)
    earlier = torch.tril(torch.ones((p_cap, p_cap), dtype=torch.bool,
                                    device=dev), diagonal=-1)
    earlier_tail = earlier[:tail_p, :tail_p] if tail_p else None

    def step(nodes, rep, buf):
        pod = start(nodes, buf)
        untols = comm.bcast(pod["untol_bits"])
        smasks = [static_mask_t(nd["valid"], taint_bits(nd["taint_mask"]),
                                u) for nd, u in zip(nodes, untols)]
        main = _SubBatch(comm, nodes, pod["req"], pod["req_nz"], smasks,
                         pod_ids, earlier, claims_noise)
        assigned = torch.full((p_cap,), -1, dtype=torch.int32, device=dev)
        active = pod["p_valid"].clone()
        comm.phase = "wave"
        assigned, active, waves = _wave_loop(
            comm, nodes, main, assigned, active, 0, max_waves, tail_p)
        # sync-point: whether the compacted tail runs
        if tail_p and waves < max_waves and bool(active.any()):
            # gather the (at most tail_p) still-active pods to the front in
            # ascending index order; padding rows gather INACTIVE pods,
            # which commit nothing in the sub-loop
            idx = torch.argsort((~active).to(torch.uint8),
                                stable=True)[:tail_p]
            idxs = comm.bcast(idx)
            sub = _SubBatch(comm, nodes, pod["req"][idx], pod["req_nz"][idx],
                            [sm[:, i] for sm, i in zip(smasks, idxs)],
                            idx.to(torch.int32), earlier_tail, "murmur")
            sub_assigned, sub_active, waves = _wave_loop(
                comm, nodes, sub, assigned[idx], active[idx], waves,
                max_waves, 0)
            assigned[idx] = sub_assigned
            active[idx] = sub_active
        return _finish(comm, rep, assigned, waves, p_cap)

    return step, spec


def _finish(comm, rep, assigned, waves: int, p_cap: int):
    """The step's result int32[p_cap+2] on home: the assigned rows, the
    wave count, the state generation (bumped here)."""
    comm.phase = "call"
    rep["gen"] += 1
    result = torch.empty(p_cap + 2, dtype=torch.int32, device=comm.home)
    result[:p_cap] = assigned
    # sync-point: the host's wave count copied in (a pageable copy)
    result[p_cap] = waves
    result[p_cap + 1] = rep["gen"]
    return result


def make_full_run(caps: Caps, comm: _Comm, p_cap: int, w: dict,
                  max_waves: int):
    """The full variant's waves on an unpacked pod dict: run(nodes, rep,
    pod) -> int32[p_cap+2] as make_step's step (which unpacks the wire
    buffer, applies its row patches and calls this); `w` the checked
    score weights.  The snapshot form calls it on a pod dict built from
    the batch's arrays (_pod_tensors)."""
    noise = []   # per shard: murmur noise keyed on (pod slot, node)
    dev = comm.home

    def run(nodes, rep, pod):
        comm.n_loc = n = nodes[0]["alloc"].shape[0]
        if not noise or noise[0].shape[1] != n:
            tables = []
            for s, d in enumerate(comm.devices):
                table = torch.empty((p_cap, n), dtype=torch.float32,
                                    device=d)
                ids = torch.arange(p_cap, dtype=torch.int32, device=d)
                for lo, hi in _row_chunks(p_cap, n, _FULL_CELLS // 4):
                    table[lo:hi] = kernels.murmur_noise(
                        ids[lo:hi], n, comm.my_offset(s))
                tables.append(table)
            noise[:] = tables
        f = _Full(caps, comm, nodes, rep, pod, noise, w)
        assigned = torch.full((p_cap,), -1, dtype=torch.int32, device=dev)
        active = pod["p_valid"].clone()
        waves = 0
        comm.phase = "wave"
        while waves < max_waves:
            # sync-point: one count read a wave (the active pods)
            act = torch.nonzero(active).squeeze(1)
            if not act.numel():
                break
            _full_wave(f, assigned, active, act)
            waves += 1
        return _finish(comm, rep, assigned, waves, p_cap)

    return run


DYN_STATE = ("used", "used_nz", "npods", "port_mask")
REP_STATE = ("cd_sg", "cd_asg", "gen")
NS_MASKS = ("sg_ns_mask", "asg_ns_mask")


def build_packed_assign_fn(caps: Caps, p_cap: int, k_cap: int = 1024,
                           weights: dict[str, float] | None = None,
                           features: frozenset = ALL_FEATURES,
                           max_waves: int | None = None,
                           claims_noise: str = "sin", device=None):
    """fn(state, static_node, buf) -> (state, result): the single-device
    step (make_step over a one-shard comm).

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
    score weights; the plain variant keeps fit, balanced and taint at 1.0
    (the claims kernel bakes them in), the full one takes any (their
    contraction in the reference: ROADMAP R4, R12)."""
    comm = _Comm([resolve_device(device)])
    step, spec = make_step(caps, comm, p_cap, k_cap, weights, features,
                           max_waves, claims_noise)

    def fn(state, static_node, buf):
        node = {k: v for k, v in static_node.items() if k not in NS_MASKS}
        node.update({k: state[k] for k in DYN_STATE})
        rep = {k: state[k] for k in REP_STATE}
        rep.update({k: static_node[k] for k in NS_MASKS if k in static_node})
        result = step([node], rep, buf)
        state["gen"] = rep["gen"]
        return state, result

    return fn, spec


# ---------------------------------------------------------------------------
# The snapshot form and the strict scan (the parity oracle)
# ---------------------------------------------------------------------------

SNAPSHOT_STATIC = ("alloc", "maxpods", "valid", "taint_mask", "label_mask",
                   "key_mask", "dom_sg", "dom_asg")


def _snapshot_arrays(node: dict, dev) -> tuple[dict, dict]:
    """Whole node arrays (numpy or tensors, parallel/mesh.NODE_KEYS) ->
    (node, rep) of fresh tensors on `dev`, which a step updates in place:
    the node-side arrays, and the replicated ones (cd_sg, cd_asg, a zero
    generation and the namespace masks when given)."""
    def put(a):
        # sync-point: a pageable host-to-device copy (the call's inputs)
        return torch.as_tensor(a).to(dev, copy=True).contiguous()
    nd = {k: put(node[k]) for k in SNAPSHOT_STATIC + DYN_STATE}
    rep = {k: put(node[k]) for k in ("cd_sg", "cd_asg")}
    rep["gen"] = torch.zeros((), dtype=torch.int32, device=dev)
    rep.update({k: put(node[k]) for k in NS_MASKS
                if node.get(k) is not None})
    return nd, rep


def _numpy(t) -> np.ndarray:
    # sync-point: a result pulled to the host, once a call
    return t.cpu().numpy()


# the PodBatch fields the step reads, densified before _pod_tensors
_BATCH_FIELDS = ("untol_prefer", "ports", "key_forb", "match_asg", "inc_asg",
                 "inc_sg", "pod_ns", "sel_any_active", "key_any_active",
                 "node_row", "c_kind", "c_sg", "c_maxskew", "c_selfmatch",
                 "c_weight", "sel_ids", "sel_forb_ids", "key_ids")


def _pod_tensors(batch, caps: Caps, dev) -> dict:
    """A PodBatch -> the pod dict _unpack makes of its full wire format,
    straight from the batch's arrays: no wire format, so the key
    bitmask holds up to 64 keys (the packed one 62).  0/1 vectors become
    int32 bit words where the step ANDs them and 0/1 floats where it
    multiplies or commits them."""
    if max(caps.t_cap, caps.pt_cap, caps.asg_cap, caps.g_cap,
           caps.kg_cap) > 31 or caps.kl_cap > 64:
        raise ValueError("bitmask caps: t_cap, pt_cap, asg_cap, g_cap, "
                         "kg_cap <= 31 and kl_cap <= 64")
    for nm in _BATCH_FIELDS:
        batch.ensure(caps, nm)

    def put(a, dtype):
        # sync-point: the batch's pageable uploads, once a call
        return torch.as_tensor(np.ascontiguousarray(a, dtype)).to(dev)

    def word(a):
        return put(_bits(np.asarray(a) > 0), np.int32)

    kf = np.asarray(batch.key_forb) > 0
    keyforb = (kf.astype(np.uint64) << np.arange(kf.shape[1], dtype=np.uint64)
               ).sum(1, dtype=np.uint64).view(np.int64)
    return {
        "req": put(batch.req, np.float32),
        "req_nz": put(batch.req_nz, np.float32),
        "c_maxskew": put(batch.c_maxskew, np.float32),
        "c_selfmatch": put(batch.c_selfmatch, np.float32),
        "c_weight": put(batch.c_weight, np.float32),
        "untol_bits": word(batch.untol_hard),
        "prefer_bits": word(batch.untol_prefer),
        "port_bits": word(batch.ports), "keyforb_bits": put(keyforb, np.int64),
        "ports": put(np.asarray(batch.ports) > 0, np.float32),
        "match_asg": put(np.asarray(batch.match_asg) > 0, np.float32),
        "inc_asg": put(np.asarray(batch.inc_asg) > 0, np.float32),
        "inc_sg": put(np.asarray(batch.inc_sg) > 0, np.float32),
        "sel_active": put(np.asarray(batch.sel_any_active) > 0, bool),
        "key_active": put(np.asarray(batch.key_any_active) > 0, bool),
        "p_valid": put(batch.p_valid, bool),
        "node_row": put(batch.node_row, np.int32),
        "pod_ns": put(batch.pod_ns, np.int32),
        "c_kind": put(batch.c_kind, np.int32),
        "c_sg": put(batch.c_sg, np.int32),
        "sel_ids": put(batch.sel_ids, np.int32),
        "forb_ids": put(batch.sel_forb_ids, np.int32),
        "key_ids": put(batch.key_ids, np.int32),
    }


def make_assign_core(caps: Caps, weights: dict[str, float] | None = None,
                     mode: str = "wave", device=None, p_cap: int | None = None):
    """The single-device snapshot form (A:272-282): fn(node, batch) ->
    dict of numpy arrays, for whole node arrays `node` (alloc, used,
    used_nz, npods, maxpods, valid, taint_mask, label_mask, key_mask,
    port_mask, dom_sg, dom_asg, cd_sg, cd_asg; sg_ns_mask and asg_ns_mask
    optional; numpy or tensors, never written) and a PodBatch
    (ops/flatten.BatchEncoder), on `device` (CUDA unless the caller names
    another).

    mode="wave": the full variant's waves on one shard (make_full_run
    over a one-device _Comm), murmur noise, at most MAX_WAVES waves (the
    JAX core's 128, R11); returns assignments, waves, used, used_nz,
    npods, port_mask, cd_sg and cd_asg (A:782-784).  mode="scan": the
    strict sequential solver (A:794-926); returns assignments, used and
    npods (A:924).  `p_cap`, when given, is the only batch size the fn
    takes; by default each batch's own.  `weights` overrides the score
    weights (fit, balanced, spread, affinity, taint)."""
    if mode not in ("wave", "scan"):
        raise ValueError(f"mode={mode!r}: 'wave' or 'scan'")
    dev = resolve_device(device)
    w = _check_step_args("murmur", ALL_FEATURES, weights)
    comm = _Comm([dev])
    runs = {}

    def assign(node: dict, batch) -> dict:
        P = batch.p_cap
        if p_cap is not None and P != p_cap:
            raise ValueError(f"batch of {P} slots; this fn takes {p_cap}")
        nd, rep = _snapshot_arrays(node, dev)
        pod = _pod_tensors(batch, caps, dev)
        if mode == "scan":
            assigned = _scan_batch(caps, w, nd, rep, pod)
            return {"assignments": _numpy(assigned),
                    "used": _numpy(nd["used"]), "npods": _numpy(nd["npods"])}
        if P not in runs:
            runs[P] = make_full_run(caps, comm, P, w, MAX_WAVES)
        result = _numpy(runs[P]([nd], rep, pod))
        out = {"assignments": result[:P], "waves": int(result[P])}
        out.update({k: _numpy(nd[k]) for k in DYN_STATE})
        out.update({k: _numpy(rep[k]) for k in ("cd_sg", "cd_asg")})
        return out

    return assign


def build_assign_fn(caps: Caps, weights: dict[str, float] | None = None,
                    mode: str = "wave", device=None, p_cap: int | None = None):
    """Single-device assignment: fn(node, batch) -> dict (A:929-934); see
    make_assign_core.  torch has no jit to wrap it in: the steps are
    plain torch operations."""
    return make_assign_core(caps, weights, mode, device, p_cap)


def _scan_batch(caps: Caps, w: dict, nd: dict, rep: dict, pod: dict):
    """The scan over one batch's pod dict on nd's device: the static
    planes and the batch-wide flags come from _Full (the rows are
    independent, so the planes are those A:813-814 builds up front), then
    _scan_pods places the pods one at a time.  Returns the assigned node
    row per pod slot (int32, -1 unplaced)."""
    dev = nd["alloc"].device
    f = _Full(caps, _Comm([dev], nd["alloc"].shape[0]), [nd], rep, pod,
              [None], w)
    # sync-point: whether a placement can change what a later pod reads
    # (the domain counts of the used slots, the existing-anti groups), one
    # read a call
    inc_sg, inc_asg = torch.stack([(f.pod["inc_sg"] > 0).any(),
                                   (f.pod["inc_asg"] > 0).any()]).tolist()
    return _scan_pods(f, commit_sg=bool(inc_sg and f.slots),
                      commit_asg=bool(inc_asg and f.any_match))


def _asg_bits(cd_asg, dom_a_ix, has_dom_a):
    """int32 [N]: bit a set where node n's domain of existing-anti group a
    holds a carrier (A:829-831's acnt > 0)."""
    acnt = torch.where(has_dom_a, cd_asg.gather(1, dom_a_ix), 0.0)
    return _bit_columns((acnt > 0).T).to(torch.int32)


def _scan_pods(f: _Full, commit_sg: bool, commit_asg: bool):
    """The strict one-pod-at-a-time placement (A:819-915), term by term:
    the static row, the resource fit over every resource, the host-port
    and existing-anti checks, LeastAllocated and BalancedAllocation over
    cpu and memory, the PreferNoSchedule score, the constraint slots in
    use (required spread with its min-match over the pod's selector nodes
    that have the domain, affinity with its bootstrap, anti-affinity, the
    spread and preferred-affinity scores), the first-index argmax (-1
    when nothing is feasible), and the commit through the placed node.
    Nothing is read back to the host: the placed node stays a 0-d tensor,
    and a pod with no feasible node commits zeros at row 0, as the JAX
    one-hot adds zeros everywhere.  A slot, kind, port or anti-group
    check that no pod of the batch uses would add 0.0 or AND True, so it
    is skipped; commit_sg / commit_asg say whether a placement can change
    the counts a later pod reads.

    XLA, compiling the reference on the CPU, contracts two products here
    (ROADMAP R12): the sum of squares under the sqrt, fma(d1, d1, d0*d0),
    and the fit score, fma(1 - std, fl(100 w_bal), sum(1 - util) *
    fl(50 w_fit)); the PreferNoSchedule term is fma(static, w_taint,
    score), an add when w_taint is 1.  The spread and preferred-affinity
    products reach their adds through a select and are rounded alone."""
    caps, pod, nd, rep, w = f.caps, f.pod, f.nodes[0], f.rep, f.w
    dev = f.comm.home
    P = pod["req"].shape[0]
    c_fit, c_bal = f.c_score
    alloc, maxpods = nd["alloc"], nd["maxpods"]
    used, used_nz, npods, ports = (nd["used"], nd["used_nz"], nd["npods"],
                                   nd["port_mask"])
    cd_sg, cd_asg = rep["cd_sg"], rep["cd_asg"]
    a_pos, a_div = alloc[:, :2] > 0, alloc[:, :2].clamp(min=1.0)
    one = torch.ones((), dtype=torch.float32, device=dev)
    dom_ix, has_dom_all = nd["dom_sg"].clamp(min=0).long(), nd["dom_sg"] >= 0
    dom_a_ix = nd["dom_asg"].clamp(min=0).long()
    has_dom_a = nd["dom_asg"] >= 0
    # flat offsets of each group's row in the count tables
    sg_cells = torch.arange(caps.sg_cap, device=dev) * cd_sg.shape[1]
    asg_cells = torch.arange(caps.asg_cap, device=dev) * cd_asg.shape[1]
    asg_bits = (_asg_bits(cd_asg, dom_a_ix, has_dom_a) if f.any_match
                else None)
    static_mask, sel_mask = f.static_mask[0], f.sel_mask[0]
    static_score = f.static_score[0] if f.static_score is not None else None
    w_taint = float(np.float32(w["taint"]))
    assigned = torch.empty(P, dtype=torch.int32, device=dev)
    for p in range(P):
        req = pod["req"][p]
        mask = (static_mask[p] & (npods + 1.0 <= maxpods)
                & (req <= alloc - used).all(1))
        if f.any_ports:
            mask &= torch.mv(ports, pod["ports"][p]) == 0
        if asg_bits is not None:
            if commit_asg and p:
                asg_bits = _asg_bits(cd_asg, dom_a_ix, has_dom_a)
            mask &= (f.match_bits[p] & asg_bits) == 0
        u = used_nz[:, :2] + pod["req_nz"][p, :2]
        util = torch.where(a_pos, torch.minimum(u / a_div, one), one)
        d = util - (util.sum(1) * 0.5)[:, None]
        sq = kernels.fma32(d[:, 1], d[:, 1], d[:, 0] * d[:, 0])
        score = kernels.fma32(1.0 - torch.sqrt(sq * 0.5), c_bal,
                              (1.0 - util).sum(1) * c_fit)
        if w_taint == 1.0:
            score = score + (static_score[p] if static_score is not None
                             else 100.0)
        else:
            score = kernels.fma32(static_score[p] if static_score is not None
                                  else torch.full_like(score, 100.0),
                                  w_taint, score)
        for c in f.slots:
            kinds, kind = f.kinds[c], pod["c_kind"][p, c]
            sg = f.c_sg[p, c:c + 1]
            has_dom = has_dom_all.index_select(0, sg)[0]
            cnt_row = cd_sg.index_select(0, sg)[0]
            gathered = torch.where(
                has_dom, cnt_row[dom_ix.index_select(0, sg)[0]], 0.0)
            selfm = pod["c_selfmatch"][p, c]
            # the kinds are exclusive: AND over the hard kinds in use of
            # "ok or another kind" is A:860-864's nested select
            if C_SPREAD_HARD in kinds:
                mm = torch.where(sel_mask[p] & has_dom, gathered, INF).amin()
                mm = torch.where(torch.isfinite(mm), mm, 0.0)
                mask &= ((((gathered + selfm) - mm <= pod["c_maxskew"][p, c])
                          & has_dom) | (kind != C_SPREAD_HARD))
            if C_AFFINITY in kinds:
                boot = (cnt_row.sum() == 0) & (selfm > 0)
                mask &= (((gathered > 0) | boot) & has_dom) | (
                    kind != C_AFFINITY)
            if C_ANTI_AFFINITY in kinds:
                mask &= ~has_dom | (gathered == 0) | (kind != C_ANTI_AFFINITY)
            if C_SPREAD_SCORE in kinds:
                smx = torch.where(mask, gathered, 0.0).amax()
                smn = torch.where(mask, gathered, INF).amin()
                smn = torch.where(torch.isfinite(smn), smn, 0.0)
                rng = torch.clamp(smx - smn, min=1.0)
                spread = (smx - gathered) * 100.0 / rng * w["spread"]
                score = score + torch.where(kind == C_SPREAD_SCORE, spread,
                                            0.0)
            if C_PREF_AFFINITY in kinds:
                cw = w["affinity"] * pod["c_weight"][p, c]
                score = score + torch.where(kind == C_PREF_AFFINITY,
                                            cw * gathered, 0.0)
        feasible = mask & pod["p_valid"][p]
        _best, j = torch.where(feasible, score, kernels.NEG).max(0)
        ok = feasible.any()
        assigned[p] = torch.where(ok, j, -1)
        # commit through node j (weight 0 when nothing was feasible)
        okf, jv = ok.to(torch.float32), j.view(1)
        used.index_add_(0, jv, (req * okf)[None])
        used_nz.index_add_(0, jv, (pod["req_nz"][p] * okf)[None])
        npods.index_add_(0, jv, okf.view(1))
        if f.any_ports:
            ports.index_add_(0, jv, (pod["ports"][p] * okf)[None])
            ports.index_copy_(0, jv, ports.index_select(0, jv).clamp_(max=1.0))
        # the domain counts through j's domains: one cell a group
        if commit_sg:
            dj = nd["dom_sg"].index_select(1, jv)[:, 0]
            cd_sg.view(-1).index_add_(0, sg_cells + dj.clamp(min=0).long(),
                                      pod["inc_sg"][p] * (dj >= 0) * okf)
        if commit_asg:
            dj = nd["dom_asg"].index_select(1, jv)[:, 0]
            cd_asg.view(-1).index_add_(
                0, asg_cells + dj.clamp(min=0).long(),
                pod["inc_asg"][p] * (dj >= 0) * okf)
    return assigned
