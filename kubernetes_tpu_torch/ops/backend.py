"""TorchBatchBackend — the bridge between the scheduler and the GPU step.

Counterpart of kubernetes_tpu/ops/backend.py's TPUBatchBackend: it
flattens the snapshot delta into tensors (ops/flatten.py), runs
feasibility + score + assignment on the device (models/assign.py) and
hands back per-pod placements by node name.  A batch that uses node
selectors or affinity, PreferNoSchedule taints, nodeName pins, host ports,
topology spread or pod (anti-)affinity runs the FULL step variant, the
rest the PLAIN one (claims kernel); an oversized full batch runs in chunks
of `full_cap` pods, chaining the resident state chunk to chunk.

Transport design (unchanged from the JAX backend):
  * node dynamic aggregates (used/npods/ports/domain counts) live ON DEVICE
    between batches; the step updates them in place.
  * a host numpy mirror replays the step's commits; each batch the
    authoritative snapshot arrays are diffed against the mirror, and rows
    changed by EXTERNAL events (pod deleted, bind forgotten, node resized)
    ride a bounded row-patch section of the single packed upload.  A
    mismatch beyond the patch budget falls back to a full refresh.
  * the static node arrays split in two: STATIC_CORE, which every step
    reads, and STATIC_SEL (label/key masks, topology domains, namespace
    masks), which only the full variant reads and which uploads lazily.
  * the pod batch is ONE 1-D f32 buffer (ints bitcast), packed into a
    pinned host staging buffer and copied to the device asynchronously;
    the result vector comes back into pinned memory behind a CUDA event
    that resolve() waits on.
  * a generation counter in the device state fences every resolve: a
    result whose generation is not the one the host expects was computed
    on state the host never committed, and the wave is re-run from the
    mirror.
  * batched preemption (PostFilter's device half, `preempt_batch`) reads
    the victim tensors, a third upload channel (STATIC_VICT) that refreshes
    only at preemption time: a full upload or a row overwrite, like the
    static arrays.

Checkpointed warm start (checkpoint_mirror / warm_start) writes and reads
the JAX package's KTPUCKPT v1 format: a checkpoint written by either
package's backend installs in the other's.

Observability, as the JAX backend's: tracing spans under the scheduler's
sampled batch root (_trace_parent), the per-batch telemetry
(drain_batch_telemetry, drain_escape_reasons), the wave timeline's patch,
h2d, device-step and d2h intervals (on the card from CUDA events,
_WaveClock) and a device census (device_census: one step of each variant
on a clone of the resident state, under torch.profiler, a dispatch-mode
byte count and the FLOP counter).

The remote device worker (ops/remote.py) holds this class's device half
in another process: RemoteTorchBatchBackend overrides the methods that
touch the device (_device_step, _upload_static, _ensure_vict,
_preempt_step, _full_refresh, _restore_state_from_mirror, warmup).
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import io
import logging
import os
import pickle
import pkgutil
import threading
import time
import types
import zlib
from typing import Sequence

import numpy as np
import torch

from ..api import meta
from ..component_base import tracing
from ..component_base.timeline import default_timeline
from ..device import resolve_device
from ..models.assign import (
    ALL_FEATURES, PLAIN_FEATURES, PackSpec, build_packed_assign_fn,
    pack_pod_batch,
)
from ..models.carry import STATIC_CORE, STATIC_SEL
from ..scheduler.batch_backend import BatchBackend
from ..scheduler.cache import Snapshot
from ..scheduler.types import ERROR, SKIP, UNSCHEDULABLE, PodInfo, Status
from .flatten import (
    C_AFFINITY, C_ANTI_AFFINITY, C_PREF_AFFINITY, C_SPREAD_HARD,
    C_SPREAD_SCORE, CORE_R, BatchEncoder, Caps, ClusterTensors, PodBatch,
    VocabFullError, gather_pod_batch, slice_pod_batch,
)

logger = logging.getLogger(__name__)

DYN_FIELDS = ("used", "used_nz", "npods", "port_mask")

# the full variant's device bytes per (pod, node row) cell of one step at
# its peak, over-estimated (models/assign.py keeps ~10 bytes a cell and a
# bounded chunk of [rows, N] temporaries; chip_smoke.py phase (d) prints
# the measured number), and the share of free device memory its batch cap
# may plan for (default_full_cap)
FULL_BYTES_PER_CELL = 24
FULL_MEM_SHARE = 0.5

# victim tensors (batched preemption): binds dirty victim rows every batch,
# but the re-encode and the upload happen only at preemption time, keyed by
# tensors.vict_version, and never invalidate the static arrays
STATIC_VICT = ("vict_prio", "vict_req", "vict_pdb", "vict_over")

# dispatch() sentinel: an earlier batch is still in flight and this batch
# needs a refresh or a static change, which would clobber the in-flight
# batch's device-side accounting.  The caller must resolve the in-flight
# batch and finish its tail (so the authoritative tensors catch up), then
# re-dispatch.
FLUSH_FIRST = object()


# -- checkpointed warm start -------------------------------------------------
#
# A checkpoint is the HOST half of the backend only: the ClusterTensors
# (numpy arrays + slot allocator + vocabularies + selector-group buckets)
# plus per-node adoption digests and the informer resourceVersions the
# state was current at.  Device state is absent: the backend rebuilds it
# from the installed tensors on the first dispatch (_full_refresh,
# _upload_static), on its own device, which is what makes the format
# portable across the JAX package's backends and this one.
#
# The format is the JAX package's (kubernetes_tpu/ops/backend.py), byte
# for byte in its header and field for field in its payload.  The payload
# is a pickle, and a pickle names the classes of the objects it holds.
# Both packages hold the same flatten.py, so the classes are the same
# code under two package names: this backend writes every class of this
# package under the JAX package's name (resolved by the reader through
# pkgutil.resolve_name) and reads either name as its own class.  So the
# JAX reader's plain pickle.loads gets its own classes, and this package
# never imports the other.

CHECKPOINT_MAGIC = b"KTPUCKPT"

# Payload schema: exactly the keys the warm-start reader consumes, the
# JAX package's CHECKPOINT_FIELDS at the same version; changing them is a
# format change for both packages.
CHECKPOINT_FIELDS = (
    "caps",
    "batch_size",
    "lineage",
    "objects",
    "resource_versions",
    "tensors",
    "warm_digests",
)
CHECKPOINT_SCHEMA_VERSION = 1

# the package name a checkpoint's classes are written under, and this one
_WIRE_PKG = "kubernetes_tpu"
_OWN_PKG = __name__.split(".", 1)[0]


class CheckpointError(RuntimeError):
    """Checkpoint unusable (missing, corrupt, schema/caps mismatch).
    warm_start raises BEFORE touching any backend state, so the caller
    falls back to an ordinary cold start — never partial installs."""


def _own_name(module: str) -> str:
    """A module name of either package as this package's."""
    if module == _WIRE_PKG or module.startswith(_WIRE_PKG + "."):
        return _OWN_PKG + module[len(_WIRE_PKG):]
    return module


def _resolve_own(name: str):
    """pkgutil.resolve_name for a checkpoint's class references, with the
    package mapped to this one."""
    module, _, attr = name.partition(":")
    return pkgutil.resolve_name(f"{_own_name(module)}:{attr}")


class _CheckpointPickler(pickle.Pickler):
    """Writes this package's classes and functions under the JAX package's
    module names (pkgutil.resolve_name("kubernetes_tpu...:Name"))."""

    def reducer_override(self, obj):
        if isinstance(obj, (type, types.FunctionType)):
            module = getattr(obj, "__module__", "") or ""
            if module == _OWN_PKG or module.startswith(_OWN_PKG + "."):
                wire = _WIRE_PKG + module[len(_OWN_PKG):]
                return pkgutil.resolve_name, (f"{wire}:{obj.__qualname__}",)
        return NotImplemented


class _CheckpointUnpickler(pickle.Unpickler):
    """Reads class references of either package as this package's."""

    def find_class(self, module, name):
        if module == "pkgutil" and name == "resolve_name":
            return _resolve_own
        return super().find_class(_own_name(module), name)


def _warm_digest(ni) -> tuple:
    """Content signature of one NodeInfo, comparable ACROSS processes
    (generation counters are per-process and useless here): the node
    object's resourceVersion plus the resident pod set with per-pod
    resourceVersions.  Equal digests => the row encode would be
    bit-identical, so the checkpointed row can be adopted as-is."""
    return (meta.resource_version(ni.node),
            tuple(sorted((pi.key, meta.resource_version(pi.pod))
                         for pi in ni.pods)))


def _apply_static_patch(static: dict, rows, alloc_v, maxpods_v, valid_v,
                        taint_v) -> None:
    """Row-wise overwrite of the RESIDENT core static arrays, in place, so
    a handful of changed nodes costs a few KB of transfer instead of a
    full re-upload.  `rows` are distinct and carry no padding (the JAX
    version pads to bound its jit shapes and drops the padding out of
    bounds; eager torch needs neither)."""
    static["alloc"][rows] = alloc_v
    static["maxpods"][rows] = maxpods_v
    static["valid"][rows] = valid_v
    static["taint_mask"][rows] = taint_v


def _apply_sel_patch(sel: dict, rows, label_v, key_v, dom_sg_v,
                     dom_asg_v) -> None:
    """Row-wise overwrite of the resident selector-side static arrays
    (same contract as _apply_static_patch).  The namespace masks have no
    node axis and ride full uploads only."""
    sel["label_mask"][rows] = label_v
    sel["key_mask"][rows] = key_v
    sel["dom_sg"][:, rows] = dom_sg_v
    sel["dom_asg"][:, rows] = dom_asg_v


def _apply_vict_patch(vict: dict, rows, prio_v, req_v, pdb_v,
                      over_v) -> None:
    """Row-wise overwrite of the resident victim tensors (same contract as
    _apply_static_patch)."""
    vict["vict_prio"][rows] = prio_v
    vict["vict_req"][rows] = req_v
    vict["vict_pdb"][rows] = pdb_v
    vict["vict_over"][rows] = over_v


def _trace_parent():
    """The scheduler-installed batch root span for THIS thread (see
    component_base/tracing use_span), or None when the pipeline is
    untraced or the root was not sampled — callers then skip every span
    and attribute computation, so tracing off costs nothing on the
    dispatch path."""
    span = tracing.current_span()
    if span is None or not span.sampled:
        return None
    return span


def _to_host(*tensors) -> list[np.ndarray]:
    """One device-to-host pull: CUDA tensors are copied into pinned host
    memory behind a single CUDA event, which is then waited on; CPU
    tensors are copied; numpy arrays (planes that arrived over the remote
    seam) pass through."""
    if tensors and not torch.is_tensor(tensors[0]):
        return list(tensors)
    if not tensors or tensors[0].device.type != "cuda":
        return [t.numpy().copy() for t in tensors]
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return [h.numpy() for h in host]


def decode_results(assignments, n: int, batch_size: int, escapes: set,
                   row_names: list, no_fit_msg: str,
                   nofit_escapes: set | None = None
                   ) -> list[tuple[str | None, Status | None]]:
    """Map each pod slot to (node_name, status).  `row_names` is the
    tensors' row_names list CAPTURED AT DISPATCH — a later dispatch may
    recycle rows, so names must resolve against the batch's own view.  It
    is a list of STRINGS on purpose: the zero-copy cache view shares live
    NodeInfos whose .node the cache nulls in place when a drained node
    still holds pods, so resolving NodeInfo.name across the
    dispatch->resolve gap can yield "" — and a bind to nodeName "" is a
    silently lost pod (nothing ever requeues it).

    `nofit_escapes`: pods whose constraints rode COLLIDED (shared)
    selector-group buckets — for them a no-fit verdict is an upper-bound
    artifact, so they go to the per-pod oracle instead of
    UNSCHEDULABLE."""
    rows = np.asarray(assignments, np.int64).tolist()  # ONE bulk convert
    results: list[tuple[str | None, Status | None]] = []
    for i in range(n):
        if i >= batch_size or (escapes and i in escapes):
            results.append((None, Status(SKIP, "escape to per-pod path")))
            continue
        row = rows[i]
        if row < 0 and nofit_escapes and i in nofit_escapes:
            results.append((None, Status(
                SKIP, "no-fit under shared constraint buckets; "
                      "per-pod re-proof")))
            continue
        if row < 0:
            results.append((None, Status(UNSCHEDULABLE, no_fit_msg)))
            continue
        name = row_names[row]
        if not name:
            # invariant violation (device placed onto an invalid row):
            # surface it loudly — the device-side capacity claim is now
            # phantom until the next refresh, and silently reporting
            # "no feasible node" would mask the encoding bug
            results.append((None, Status(
                ERROR, f"device assigned row {row} with no node name "
                       "(encoder/valid-mask bug)")))
        else:
            results.append((name, None))
    return results


def record_batch_stats(stats: dict, lock, results, n: int) -> None:
    """Escape accounting: pods seen / pods skipped to the per-pod oracle."""
    esc = sum(1 for _nm, s in results if s is not None and s.is_skip())
    with lock:
        stats["pods"] = stats.get("pods", 0) + n
        stats["escaped"] = stats.get("escaped", 0) + esc


class ResidentHostMirror:
    """Host-side replay mirror: the device keeps the node dynamics
    resident; the host mirror replays the step's commit rules so the next
    dispatch can diff authoritative-vs-mirror and upload only externally
    changed rows.  Consumers provide: self.tensors, self._mirror,
    self._f_patch, self._k_cap, self.batch_size, self.caps, self._lock,
    self._unresolved, self._carry_dirty, self._last_epoch, self.stats."""

    # warm-start adoption digests ({node name: _warm_digest}), installed
    # by warm_start and consumed one-shot by _try_warm_adopt.  The class
    # default is an always-empty dict (never mutated: every touch is
    # guarded by truthiness) so cold-started backends pay nothing.
    _warm_pending: dict = {}

    def prefetch(self, snapshot) -> None:
        """Idle-time tensor sync: absorb node churn into the host arrays
        while nothing is queued or in flight, so the next dispatch's
        tracked update sees only fresh deltas.  Re-encoded rows carry into
        the next dispatch's patch diff."""
        with self._lock:
            if self._unresolved:
                return
            if self._warm_pending:
                self._warm_sweep(snapshot)
            epoch_fn = getattr(snapshot, "epoch", None)
            epoch = epoch_fn() if epoch_fn is not None else None
            if epoch is not None and epoch == self._last_epoch:
                return  # nothing external changed: the scan is a no-op
            t_sync = time.monotonic()
            try:
                dirty = set(self.tensors.update_from_snapshot_tracked(
                    snapshot))
            except VocabFullError:
                self._state = None  # force a refresh on next dispatch
                return
            finally:
                self.stats["flatten_seconds"] = self.stats.get(
                    "flatten_seconds", 0.0) + (time.monotonic() - t_sync)
            self._carry_dirty |= dirty
            self._last_epoch = epoch

    def _needs_full(self, batch: PodBatch) -> bool:
        """Batches using selectors/constraints/ports/pins need the
        constraint-carrying kernel variant.  Lazy PodBatch fields: None ==
        all-zeros == feature absent."""
        def nz(a):
            return a is not None and a.any()
        t = self.tensors
        return bool(
            t.sgs or t.asgs or nz(batch.c_kind)
            or nz(batch.sel_any_active) or nz(batch.key_any_active)
            or nz(batch.sel_forb) or nz(batch.key_forb)
            or nz(batch.ports) or nz(batch.untol_prefer)
            or (batch.node_row is not None and (batch.node_row >= 0).any()))

    # the census pod's cpu (milli) and memory (bytes) when no row holds a
    # pod yet: SchedulingBasic's pod
    CENSUS_DEFAULT_REQ = (100.0, 128.0 * 2**20)

    def _census_req(self) -> np.ndarray:
        """The census pod's request: per core resource the smallest nonzero
        used / npods over the rows holding pods, as the device state has
        them (the mirror; the host tensors before the first step)."""
        t = self.tensors
        src = self._mirror if self._mirror is not None else {
            "used": t.used, "npods": t.npods}
        req = np.zeros(self.caps.r, np.float32)
        rows = t.valid & (src["npods"] > 0)
        for r, default in enumerate(self.CENSUS_DEFAULT_REQ):
            per_pod = src["used"][rows, r] / src["npods"][rows]
            per_pod = per_pod[per_pod > 0]
            req[r] = per_pod.min() if per_pod.size else default
        return req

    def _diff_patches(self, dirty_rows) -> tuple[np.ndarray, np.ndarray] | None:
        """Rows where authoritative != mirror (read-only; mirror untouched).
        None -> too many (refresh)."""
        t, m = self.tensors, self._mirror
        if not dirty_rows:
            return np.empty(0, np.int32), np.empty((0, self._f_patch),
                                                   np.float32)
        cand = np.fromiter(dirty_rows, np.int64, len(dirty_rows))
        changed = ((t.used[cand] != m["used"][cand]).any(axis=1)
                   | (t.used_nz[cand] != m["used_nz"][cand]).any(axis=1)
                   | (t.npods[cand] != m["npods"][cand])
                   | (t.port_mask[cand] != m["port_mask"][cand]).any(axis=1))
        rows_a = cand[changed].astype(np.int32)
        if len(rows_a) > self._k_cap:
            return None
        if not len(rows_a):
            return np.empty(0, np.int32), np.empty((0, self._f_patch),
                                                   np.float32)
        vals = np.concatenate([
            t.used[rows_a], t.used_nz[rows_a], t.npods[rows_a][:, None],
            t.port_mask[rows_a]], axis=1).astype(np.float32)
        return rows_a, vals

    def _sync_mirror_rows(self, rows_a: np.ndarray) -> None:
        """Bring the mirror in line with what the device will hold after the
        row patch uploads authoritative values."""
        t, m = self.tensors, self._mirror
        for f in DYN_FIELDS:
            m[f][rows_a] = getattr(t, f)[rows_a]

    def _mirror_from_tensors(self, cd_sg: np.ndarray,
                             cd_asg: np.ndarray) -> None:
        t = self.tensors
        self._mirror = {
            "used": t.used.copy(), "used_nz": t.used_nz.copy(),
            "npods": t.npods.copy(), "port_mask": t.port_mask.copy(),
            "cd_sg": cd_sg.copy(), "cd_asg": cd_asg.copy(),
        }

    def _replay(self, batch: PodBatch, assignments: np.ndarray) -> None:
        """Apply the step's commit rules to the host mirror (vectorized:
        np.add.at / maximum.at accumulate correctly when many pods land on
        the same row), and mark the rows this batch placed pods on for a
        victim re-encode.

        The victim rows re-encode at preemption time from the rows' live
        NodeInfos, but only the rows marked since the last preemption
        wave; a tensor sync marks the rows it re-encodes.  The epoch fast
        path skips that sync when every cache change since the last one
        was this backend's own placements, so without the mark here a
        row's victim slots could stay as an earlier wave encoded them,
        missing the pods placed since, and a preemptor would find no
        victims where the cache holds them."""
        t, m = self.tensors, self._mirror
        n = min(len(assignments), self.batch_size)
        rows = np.asarray(assignments[:n], np.int64)
        placed = np.nonzero(rows >= 0)[0]
        if placed.size == 0:
            return
        prow = rows[placed]
        t.vict_dirty_rows.update(np.unique(prow).tolist())
        np.add.at(m["used"], prow, batch.req[placed])
        np.add.at(m["used_nz"], prow, batch.req_nz[placed])
        np.add.at(m["npods"], prow, 1.0)
        if batch.ports is not None:
            np.maximum.at(m["port_mask"], prow, batch.ports[placed])
        if batch.inc_sg is not None:
            for sg in range(len(t.sgs)):
                inc = placed[batch.inc_sg[placed, sg] > 0]
                if inc.size:
                    d = t.dom_sg[sg, rows[inc]]
                    np.add.at(m["cd_sg"][sg], d[d >= 0], 1.0)
        if batch.inc_asg is not None:
            for a in range(len(t.asgs)):
                inc = placed[batch.inc_asg[placed, a] > 0]
                if inc.size:
                    d = t.dom_asg[a, rows[inc]]
                    np.add.at(m["cd_asg"][a], d[d >= 0], 1.0)

    # -- event-driven tensor maintenance (incremental flatten) -----------

    # compact when tombstoned slots exceed n_cap / COMPACT_TOMBSTONE_DIV
    # (and never while a wave is in flight — it references rows by index)
    COMPACT_TOMBSTONE_DIV = 16

    def note_node_event(self, event_type: str, name: str, view) -> None:
        """Node informer feed: apply one add/update/delete event as a
        targeted row patch on the resident host tensors, so the wave-time
        drain finds the row already generation-current and the device
        upload shrinks to the genuinely-changed rows.  `view` is the
        cache's CacheFlattenView; the NodeInfo is read under the cache
        lock (backend lock -> cache lock, the order dispatch takes).  Any
        patch-path error leaves the event pending for the wave-time drain
        — the full re-flatten is the recovery path, never lost state."""
        run_node = getattr(view, "run_locked_node", None)
        if run_node is None:
            return
        t0 = time.monotonic()
        with self._lock:
            t = self.tensors

            def _apply(ni):
                if ni is None:
                    if self._warm_pending:
                        self._warm_pending.pop(name, None)
                    return t.patch_remove(name)
                if self._warm_pending and self._try_warm_adopt(name, ni):
                    return None  # row adopted verbatim: nothing dirty
                return t.patch_node(name, ni)

            try:
                row = run_node(name, _apply)
            except VocabFullError:
                self._state = None  # force a refresh on next dispatch
                return
            except Exception:
                logger.exception(
                    "node event patch failed; deferring to wave drain")
                return
            finally:
                self.stats["patch_seconds"] = self.stats.get(
                    "patch_seconds", 0.0) + (time.monotonic() - t0)
            if row is not None:
                self._carry_dirty.add(row)
                self.stats["event_patches"] = self.stats.get(
                    "event_patches", 0) + 1

    def _maybe_compact(self) -> None:
        """Reclaim tombstoned row slots (caller holds the backend lock).
        Skipped while any wave is in flight: an in-flight batch resolves
        against rows captured by index at dispatch.  Steady-state
        reclamation lives in the dispatch gate, where it is anchored to
        the wave boundary and cannot vary with pipeline depth; this is the
        boot-time entry for the warm-start path."""
        t = self.tensors
        if self._unresolved:
            return
        if (t.tombstone_count() * self.COMPACT_TOMBSTONE_DIV
                >= self.caps.n_cap):
            if t.compact():
                self.stats["compactions"] = self.stats.get(
                    "compactions", 0) + 1

    def maintenance_snapshot(self) -> dict:
        """Tensor-maintenance readout for the observatory: occupancy /
        tombstone gauges plus the patched-vs-reflattened wave counters
        (scheduler.expose_metrics incs the counter metrics by deltas)."""
        with self._lock:
            t = self.tensors
            s = self.stats
            return {
                "row_occupancy": t.row_occupancy(),
                "tombstone_rows": t.tombstone_count(),
                "waves_patched": s.get("waves_patched", 0),
                "waves_reflattened": s.get("waves_reflattened", 0),
                "event_patches": s.get("event_patches", 0),
                "compactions": s.get("compactions", 0),
                "gen_stale_waves": s.get("gen_stale_waves", 0),
                "patch_seconds": s.get("patch_seconds", 0.0),
                "flatten_seconds": s.get("flatten_seconds", 0.0),
            }

    def _restore_state_from_mirror(self) -> None:
        """Generation-fence recovery: rebuild the device wave state from
        the host replay mirror — which already includes every replay
        committed so far, so re-running a fenced wave's retained buffers
        against this state reproduces exactly what a healthy wave would
        have produced.  Bumping the host generation FIRST also fences any
        pipelined successor dispatched off the stale lineage: it
        self-heals at its own resolve."""
        m = self._mirror
        self._gen += 1
        # sync-point: pageable host-to-device copies (a recovery)
        state = {k: torch.tensor(m[k], device=self.device) for k in
                 ("used", "used_nz", "npods", "port_mask",
                  "cd_sg", "cd_asg")}
        # sync-point: a pageable host-to-device copy (a recovery)
        state["gen"] = torch.tensor(self._gen, dtype=torch.int32,
                                    device=self.device)
        self._state = state
        self.stats["gen_recoveries"] = self.stats.get(
            "gen_recoveries", 0) + 1

    # -- checkpointed warm start -----------------------------------------

    def checkpoint_mirror(self, path: str, *, snapshot=None,
                          resource_versions=None, objects=None) -> dict:
        """Serialize the resident host state to `path` (atomic
        tmp+rename): tensors, per-node adoption digests, the informer
        resourceVersions the state was current at, and optionally the
        raw objects to prime a restarted informer with.  Taken under the
        backend lock between waves (the drain path resolves in-flight
        work first), so the payload is a consistent cut.

        Pass `snapshot` (the cache flatten view) to catch the tensors up
        with binds committed after the last drain before cutting.  A
        digest is only recorded for rows whose generation markers are
        current with the NodeInfo they alias — node_infos are the live
        cache objects, mutated in place after encode, so a stale row's
        digest would certify content the tensors don't hold."""
        with self._lock:
            t = self.tensors
            if snapshot is not None:
                t.update_from_snapshot_tracked(snapshot)
            digests = {}
            for row, ni in enumerate(t.node_infos):
                if (ni is not None and t.valid[row]
                        and t.gen[row] == ni.generation
                        and t.node_gen[row] == ni.node_generation):
                    digests[ni.name] = _warm_digest(ni)
            # Serialize a shallow copy with the NodeInfo graph stripped:
            # node_infos are THIS process's live cache objects — the
            # restarted process rebuilds its own from the primed informer
            # and re-links them row-by-row through _try_warm_adopt, so
            # shipping the graph only bloats the blob and dominates the
            # unpickle.  _dyn_digest goes with it: warm_start resets both
            # before install.  The numpy arrays are shared references;
            # pickle copies them into the blob untouched.  Classes are
            # written under the JAX package's names (_CheckpointPickler).
            t_ser = copy.copy(t)
            t_ser.node_infos = [None] * t.caps.n_cap
            t_ser._dyn_digest = [None] * t.caps.n_cap
            payload = {
                "caps": dataclasses.asdict(self.caps),
                "batch_size": self.batch_size,
                "lineage": self.lineage,
                "objects": objects,
                "resource_versions": dict(resource_versions or {}),
                "tensors": t_ser,
                "warm_digests": digests,
            }
            # cyclic GC off for the bulk dump: the serializer allocates
            # many temporaries and every generational collection re-walks
            # the (large, live) cache heap a draining scheduler holds
            gc_was = gc.isenabled()
            gc.disable()
            try:
                out = io.BytesIO()
                _CheckpointPickler(out, protocol=pickle.HIGHEST_PROTOCOL
                                   ).dump(payload)
                blob = out.getvalue()
            finally:
                if gc_was:
                    gc.enable()
        header = (CHECKPOINT_MAGIC
                  + CHECKPOINT_SCHEMA_VERSION.to_bytes(4, "big")
                  + zlib.crc32(blob).to_bytes(4, "big"))
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(header + blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return {"path": path, "bytes": len(header) + len(blob),
                "nodes": len(digests)}

    def warm_start(self, path: str) -> dict:
        """Install a checkpoint into this (freshly constructed) backend.

        Validation happens before any mutation: bad magic, schema-version
        mismatch, body corruption or caps mismatch raise CheckpointError
        and leave the backend untouched (the caller cold-starts).  On
        success the tensors are installed with every per-process currency
        marker reset stale — gen/node_gen/_dyn_digest carry ANOTHER
        process's cache counters, and a coincidental match against this
        process's generations would let _sync_rows/patch_node silently
        skip a changed row.  Rows regain currency only through
        _try_warm_adopt's content-digest check as the (primed) informer
        replays them; anything unadopted re-encodes through the ordinary
        sync paths.  Returns {resource_versions, objects, nodes,
        lineage} so the caller can prime its informers and re-sync only
        the delta since the checkpoint.  The payload's classes may be
        either package's (_CheckpointUnpickler reads both as this one's);
        the installed tensors are host arrays, and the first dispatch
        uploads them to this backend's device."""
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError as e:
            raise CheckpointError(f"checkpoint unreadable: {e}") from e
        hlen = len(CHECKPOINT_MAGIC) + 8
        if len(raw) < hlen or not raw.startswith(CHECKPOINT_MAGIC):
            raise CheckpointError("not a ktpu checkpoint (bad magic)")
        version = int.from_bytes(raw[len(CHECKPOINT_MAGIC):
                                     len(CHECKPOINT_MAGIC) + 4], "big")
        if version != CHECKPOINT_SCHEMA_VERSION:
            raise CheckpointError(
                f"checkpoint schema v{version} != supported "
                f"v{CHECKPOINT_SCHEMA_VERSION}")
        crc = int.from_bytes(raw[hlen - 4:hlen], "big")
        # memoryview, not raw[hlen:]: slicing would copy the body (a
        # second body-sized buffer) before the unpickle
        blob = memoryview(raw)[hlen:]
        if zlib.crc32(blob) != crc:
            raise CheckpointError("checkpoint body corrupt (crc mismatch)")
        # cyclic GC off for the bulk load: unpickling the object payload
        # allocates many small containers, and with a warm cache heap
        # already resident each generational collection re-walks it all
        gc_was = gc.isenabled()
        gc.disable()
        try:
            payload = _CheckpointUnpickler(io.BytesIO(blob)).load()
        except Exception as e:  # noqa: BLE001 - any unpickle failure
            raise CheckpointError(f"checkpoint undecodable: {e}") from e
        finally:
            if gc_was:
                gc.enable()
        if (not isinstance(payload, dict)
                or set(payload) != set(CHECKPOINT_FIELDS)):
            raise CheckpointError("checkpoint payload shape mismatch")
        if payload["caps"] != dataclasses.asdict(self.caps):
            raise CheckpointError(
                "checkpoint caps do not match this backend's caps")
        t = payload["tensors"]
        with self._lock:
            # stale-currency reset: see docstring.  Full-upload flags are
            # forced so the first dispatch rebuilds every device channel
            # from the installed tensors (a detached tensor set: no device
            # copy exists yet to desynchronize).
            t.gen[:] = -1
            t.node_gen[:] = -1
            t._dyn_digest = [None] * t.caps.n_cap
            t.static_full = True
            t.vict_full = True
            t.static_dirty_rows = set()
            self.tensors = t
            self.encoder = BatchEncoder(t, self.batch_size)
            self._state = None
            self._static_node = None
            self._static_version = -1
            self._static_sel = None
            self._static_vict = None
            self._vict_version = -1
            self._vict_live_cap = 0
            self._mirror = None
            self._unresolved = []
            self._carry_dirty = set()
            self._last_epoch = None
            self._fence_pending = 0
            self._stage_pins.clear()
            self._warm_pending = dict(payload["warm_digests"])
            self.stats["warm_starts"] = self.stats.get(
                "warm_starts", 0) + 1
        return {"resource_versions": payload["resource_versions"],
                "objects": payload["objects"],
                "nodes": len(payload["warm_digests"]),
                "lineage": payload["lineage"]}

    def _try_warm_adopt(self, name: str, ni) -> bool:
        """Adopt one checkpointed row for a live NodeInfo (caller holds
        the backend lock; the NodeInfo is read under the cache lock).
        One-shot per name: the digest is popped, and only an exact
        content match restores the row's generation currency — a
        mismatch (node or pods changed across the restart) leaves the
        row stale so patch_node/_sync_rows re-encode it."""
        dg = self._warm_pending.pop(name, None)
        if dg is None:
            return False
        t = self.tensors
        row = t.row_of.get(name)
        if row is None or not t.valid[row] or dg != _warm_digest(ni):
            return False
        t.node_infos[row] = ni
        # digest-proven adoption: the row's encoded content already
        # equals this NodeInfo, only the currency stamps move
        t.gen[row] = ni.generation
        t.node_gen[row] = ni.node_generation
        self.stats["warm_adopted"] = self.stats.get("warm_adopted", 0) + 1
        return True

    def _warm_sweep(self, snapshot) -> int:
        """One-shot warm alignment (caller holds the backend lock): in a
        single pass under the cache lock, adopt every checkpointed row
        whose live NodeInfo content-matches its digest, drop rows for
        nodes no longer live (deleted during the restart window), and
        retire the leftover digests — from here on the ordinary sync
        paths own every row.  The initial informer replay arrives as a
        BULK ADDED burst (scheduler._on_node_events) that bypasses
        note_node_event, so the first prefetch/dispatch calls this
        before its snapshot sync.  Returns the rows dropped."""
        t = self.tensors
        dropped = 0

        def go(infos):
            nonlocal dropped
            live = set()
            for ni in infos:
                live.add(ni.name)
                self._try_warm_adopt(ni.name, ni)
            for name in list(t.row_of):
                if name not in live and t.patch_remove(name) is not None:
                    dropped += 1

        run_locked = getattr(snapshot, "run_locked", None)
        if run_locked is not None:
            run_locked(go)
        else:
            go(snapshot.node_info_list)
        self._warm_pending = {}
        if dropped:
            self._maybe_compact()
        return dropped

    def warm_align(self, snapshot) -> int:
        """Public wrapper around the warm sweep, for callers that want
        alignment at a deterministic point — right after cache sync —
        instead of lazily at the first wave.  Returns the rows dropped."""
        with self._lock:
            if not self._warm_pending:
                return 0
            return self._warm_sweep(snapshot)


class _StagedBuffer:
    """One pinned host staging buffer of the upload ring: `host` is the
    f32 tensor, `array` its numpy view (what pack_pod_batch fills), and
    `uploaded` the CUDA event recorded after its host->device copy was
    enqueued (None on the CPU or before the first upload)."""

    def __init__(self, total: int, pin: bool):
        self.host = torch.empty(total, dtype=torch.float32, pin_memory=pin)
        self.array = self.host.numpy()
        self.uploaded = None

    def upload_done(self) -> bool:
        return self.uploaded is None or self.uploaded.query()


class _Result:
    """The step's result vector on its way to the host: a pinned copy and
    the CUDA event behind which it lands (None on the CPU).  `timed` (the
    timeline armed) makes `ready` a timing event and adds `copied`, one
    recorded just before the copy: the d2h interval on the card."""

    def __init__(self, device_result, device, timed: bool = False):
        self.copied = None
        if device.type == "cuda":
            if timed:
                self.copied = torch.cuda.Event(enable_timing=True)
                self.copied.record()
            self.host = torch.empty(device_result.shape,
                                    dtype=device_result.dtype,
                                    pin_memory=True)
            self.host.copy_(device_result, non_blocking=True)
            self.ready = torch.cuda.Event(enable_timing=timed)
            self.ready.record()
        else:
            self.host, self.ready = device_result, None

    def get(self) -> np.ndarray:
        if self.ready is not None:
            self.ready.synchronize()
        return self.host.numpy()


class _WaveClock:
    """One wave's timeline marks, made only while profiling.timeline is
    armed: h2d from pack start to launch, device-step from launch until
    the last result landed (fence re-runs included), d2h nested inside it.
    On CUDA the device-step and d2h bounds are timing events on the stream
    (the launch event fires when the stream reaches the wave, which at
    depth 2 can be after the host launched it; the end is the last
    result's `ready` event, not the moment the host called resolve), mapped
    onto time.monotonic() through the backend's clock anchor.  On the CPU,
    as in the JAX package, they are host times: the launch, and the pull at
    resolve."""

    def __init__(self, backend: "TorchBatchBackend"):
        self.backend = backend
        self.cuda = backend.device.type == "cuda"
        self.t_h2d = time.monotonic()
        self.t_launch = self.t_pull = None
        self.launch_ev = None
        self.results: list[_Result] = []

    def launch(self) -> None:
        """Just before the wave's first step is enqueued (dispatch)."""
        self.t_launch = time.monotonic()
        if self.cuda:
            self.launch_ev = torch.cuda.Event(enable_timing=True)
            self.launch_ev.record()
        default_timeline.record("h2d", self.t_h2d, self.t_launch)

    def pull(self) -> None:
        """resolve() starts pulling the results."""
        self.t_pull = time.monotonic()

    def record(self) -> None:
        """Every result of the wave landed: commit device-step and d2h."""
        t_end = time.monotonic()
        if not self.cuda:
            default_timeline.record("device-step", self.t_launch, t_end)
            default_timeline.record("d2h", self.t_pull, t_end)
            return
        mono = self.backend._event_clock()
        legs = [(mono(r.copied), mono(r.ready)) for r in self.results]
        default_timeline.record("device-step", mono(self.launch_ev),
                                max(t1 for _t0, t1 in legs))
        for t0, t1 in legs:
            default_timeline.record("d2h", t0, t1)


def _traffic_mode():
    """A TorchDispatchMode whose `bytes` sums the operand and result bytes
    of every aten op run under it — the unfused traffic of the code —
    leaving out views and allocations, which move nothing."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    skip = {torch.ops.aten.empty, torch.ops.aten.empty_strided,
            torch.ops.aten.empty_like}

    def nbytes(tree) -> int:
        return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
                   if isinstance(x, torch.Tensor))

    class Traffic(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.bytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not func.is_view and func.overloadpacket not in skip:
                self.bytes += nbytes((args, kwargs)) + nbytes(out)
            return out

    return Traffic()


def default_full_cap(n_cap: int, device: torch.device) -> int:
    """The full variant's batch cap (before the batch-size clamp): the
    largest power of two in [256, 4096] whose step fits.  On CUDA the fit
    is FULL_MEM_SHARE of the device's free memory over FULL_BYTES_PER_CELL
    per (pod, node row) cell; on the CPU it is the JAX package's rule (an
    11e9-byte budget at 64 bytes per cell), so both packages chunk the same
    batches the same way."""
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        fit = int(free * FULL_MEM_SHARE / (FULL_BYTES_PER_CELL * n_cap))
    else:
        fit = int(11e9 / (64 * n_cap))
    cap = 4096
    while cap > 256 and cap > fit:
        cap //= 2
    return cap


def clone_state(state: dict) -> dict:
    """A copy of a resident state: tensors cloned, per-shard lists of them
    cloned piece by piece."""
    return {k: [p.clone() for p in v] if isinstance(v, list) else v.clone()
            for k, v in state.items()}


def census_run(device, stepped: set, variant, fn, state, static, buf, pods,
               req) -> dict:
    """One census step of `variant` (see TorchBatchBackend.device_census)
    on `device`: `fn(state, static, buf) -> (state, result)` on a clone of
    the state (a dict of tensors, or of per-shard lists of them), under
    torch.profiler, the traffic mode and FlopCounterMode; `stepped` holds
    the variants whose first call already ran."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    from . import kernels
    cuda = device.type == "cuda"
    if variant not in stepped:
        # a step's first call builds what it caches (the full step's
        # noise table): run it once on another clone, unmeasured
        with kernels.launch_tally():
            fn(clone_state(state), static, buf)
        stepped.add(variant)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if cuda else [])
    traffic = _traffic_mode()
    with profile(activities=acts) as prof:
        with kernels.launch_tally() as tally, \
                FlopCounterMode(display=False) as flops, traffic:
            _state, rd = fn(state, static, buf)
        if cuda:
            # sync-point: the census waits for its own step
            torch.cuda.synchronize(device)
    # sync-point: the census reads its step's wave count
    waves = int(rd[-2].cpu())
    device_ms = {}
    total_ms = 0.0
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            total_ms += e.self_device_time_total / 1e3
            for name, symbols in kernels.KERNEL_SYMBOLS.items():
                if any(sym in e.key for sym in symbols):
                    device_ms[name] = (device_ms.get(name, 0.0)
                                       + e.self_device_time_total / 1e3)
    hand = {}
    for name, inputs in tally.calls:
        k = hand.setdefault(name, {"bytes": 0, "ops": 0})
        if name == "claims":
            P, N, R = inputs["shape"]
            k["bytes"] += kernels.claims_bytes(P, N, R)
            # the mask test every live cell needs: a floor on the
            # operations (chip_smoke.py counts them in full)
            # sync-point: the census counts its own calls' live pods
            k["ops"] += (int(inputs["active"].sum()) * N
                         * kernels.MASK_OPS)
    out_k = {}
    hand_bytes = hand_ops = 0
    for name, k in hand.items():
        launches = tally.launches.get(name, 0)
        ms, by = kernels.bound(k["bytes"], k["ops"])
        out_k[name] = {"launches": launches,
                       "device_ms": device_ms.get(name, 0.0),
                       "bytes": k["bytes"], "bound_ms": ms,
                       "bound_by": by}
        if launches:
            hand_bytes += k["bytes"]
            hand_ops += k["ops"]
    return {"collectives": {}, "per_call_bytes": 0, "per_wave_bytes": 0,
            "cost": {"flops": float(flops.get_total_flops() + hand_ops),
                     "bytes_accessed": float(traffic.bytes
                                             + hand_bytes)},
            "kernels": out_k, "device_ms": total_ms, "waves": waves,
            "batch": {"pods": pods,
                      "req": [float(x) for x in req[:CORE_R]]}}


class TorchBatchBackend(ResidentHostMirror, BatchBackend):
    """The scheduling step behind the BatchBackend contract, on `device`
    (CUDA unless the caller asks for the CPU).  `claims_noise` picks the
    plain main phase's tie-break rule: "sin" (the Pallas kernel's, the
    default) or "murmur" (the XLA wave body's, bit-reproducible); the full
    variant always uses murmur.  `weights` overrides the spread and
    affinity score weights.  `full_batch_cap` fixes the full variant's
    batch cap (default: default_full_cap).  `full_main_waves` > 0 caps the
    full step's waves and drains the leftovers through a small retry step
    (the JAX package's KTPU_FULL_MAIN_WAVES); 0 runs every wave in the
    main step."""

    # the checkpoint payload's "lineage": which backend wrote it; the
    # census and its gauges are labelled by it too (census_kind)
    lineage = "torch"

    STAGE_RING_MAX = 16
    TELEMETRY_PENDING_MAX = 64  # per-batch telemetry dicts awaiting a drain
    RETRY_ROUNDS_MAX = 32  # defensive bound; rounds stop at no progress

    def __init__(self, caps: Caps | None = None, batch_size: int = 256,
                 k_cap: int = 1024, device=None, claims_noise: str = "sin",
                 weights: dict[str, float] | None = None,
                 full_batch_cap: int | None = None,
                 full_main_waves: int = 0):
        self.device = resolve_device(device)
        self.caps = caps or Caps()
        self.batch_size = batch_size
        self.claims_noise = claims_noise
        self.tensors = ClusterTensors(self.caps)
        self.encoder = BatchEncoder(self.tensors, batch_size)
        if full_batch_cap is None:
            full_batch_cap = default_full_cap(self.caps.n_cap, self.device)
        self.full_cap = min(full_batch_cap, batch_size)
        self.full_main_waves = full_main_waves
        self._weights = weights
        self._spec_plain: PackSpec | None = None
        self._fn_plain = None  # built lazily on first plain batch
        self._fn_full = None   # built lazily / in warmup
        self._spec_full: PackSpec | None = None
        self._fn_full_small = None   # straggler retry step (lazy)
        self._spec_full_small: PackSpec | None = None
        self._static_sel = None   # selector-side static arrays (lazy)
        self._k_cap = k_cap
        self._f_patch = 2 * self.caps.r + 1 + self.caps.pt_cap
        self._lock = threading.Lock()
        # device-resident state + host replay mirror
        self._state = None          # dict of device tensors (STATE_KEYS)
        self._static_node = None    # dict of device tensors (STATIC_CORE)
        self._static_version = -1
        self._static_vict = None    # dict of device tensors (STATIC_VICT)
        self._vict_live_cap = 0     # live_slot_cap of the resident slots
        self._vict_version = -1
        self._mirror: dict[str, np.ndarray] | None = None
        # dispatched-but-unresolved batches (pipeline bookkeeping) and node
        # rows whose dirtiness must survive an early-exit dispatch attempt
        self._unresolved: list[object] = []
        self._carry_dirty: set[int] = set()
        # cache external-mutation epoch at last tensor sync: when the view
        # reports the same epoch, every change since was our own replayed
        # binds and the whole re-encode + mirror diff is skipped
        self._last_epoch: int | None = None
        # host-side expectation of the device state-generation counter:
        # _device_step bumps it 1:1 with the step's own gen+1, so a resolve
        # whose result tail disagrees proves the wave chained on state the
        # host never committed
        self._gen = 0
        # >0 while a fenced wave (dispatched with mid-pipeline patches
        # deliberately excluded from its upload) has not yet resolved; its
        # first device run is stale by construction and the authoritative
        # result comes from the mirror-restored re-run at its resolve
        self._fence_pending = 0
        # host staging ring for packed upload buffers.  A buffer is PINNED
        # (in _stage_pins) until the wave that packed into it resolves or
        # is abandoned — it is retained for a possible fenced re-run — and
        # is handed out again only once its host->device copy completed.
        self._stage_ring: list[_StagedBuffer] = []
        self._stage_pins: set[int] = set()
        self.stats = {"batches": 0, "full_refresh": 0, "patched_rows": 0,
                      "waves": 0, "flush_first": 0, "waves_patched": 0,
                      "waves_reflattened": 0, "event_patches": 0,
                      "patch_seconds": 0.0, "flatten_seconds": 0.0}
        # per-(plugin, reason) escape tallies (the batched preemption's
        # DefaultPreemption escapes), drained by the scheduler as counter
        # deltas; own lock, since the tallies are taken under self._lock
        self._esc_lock = threading.Lock()
        self._escape_pending: dict[tuple[str, str], int] = {}
        # per-batch telemetry ({pods, feasible_nodes, mask_density,
        # waves}), bounded, drained by the scheduler under _esc_lock
        self._telemetry_pending: list[dict] = []
        # (CUDA timing event, time.monotonic()) taken after a synchronize:
        # maps the timeline's event times onto the host clock
        self._clock_anchor = None
        # step variants run at least once (the full step builds its noise
        # table at its first call): the census warms the others first
        self._stepped: set[str] = set()

    @property
    def census_kind(self) -> str:
        return self.lineage

    # -- namespace and PDB events ----------------------------------------

    def note_namespace_event(self, event_type: str, obj, old=None) -> None:
        """Namespace informer feed: keep the flattener's namespace-label
        cache (namespaceSelector resolution) in sync, under the backend
        lock, so a relabel lands between batches and the next encode sees
        the new resolved sets."""
        with self._lock:
            self.tensors.note_namespace(obj, deleted=event_type == "DELETED")

    def note_pdb_event(self, event_type: str, obj, old=None) -> None:
        """PodDisruptionBudget informer feed: keeps the flattener's PDB
        cache in sync, so the victim tensors' PDB-coverage bits stay exact.
        The bits re-encode lazily at the next preemption wave."""
        with self._lock:
            self.tensors.note_pdb(obj, deleted=event_type == "DELETED")

    # -- device sync -----------------------------------------------------

    def warmup(self) -> None:
        """Build the kernels and both step variants, upload the static
        arrays and the resident state, and run an all-invalid batch
        through each variant and an all-inactive chunk through the
        preemption dry run before the first real batch, so none of it
        lands inside the first scheduling cycle or preemption wave.  An
        all-invalid batch leaves the resident state unchanged."""
        with self._lock:
            if self._static_node is None:
                self._upload_static()
            cd_sg, cd_asg = self.tensors.domain_base_counts()
            if self._state is None:
                self._full_refresh(cd_sg, cd_asg)
            if self.device.type == "cuda":
                from . import _build, kernels
                _build.build()         # every csrc/*.cu, one nvcc each
                kernels._kernel_lib()  # load csrc/claims.cu
            batch = self.encoder.encode([])
            self._ensure_full()
            runs = [("full", self._spec_full,
                     slice_pod_batch(batch, 0, 0, self.full_cap))]
            if self.full_main_waves:
                self._ensure_full_small()
                runs.append(("full_small", self._spec_full_small,
                             slice_pod_batch(batch, 0, 0, self._retry_cap())))
            self._ensure_plain()
            runs.append(("plain", self._spec_plain, batch))
            for variant, spec, b in runs:
                staged = self._stage_buf(spec.total)
                try:
                    pack_pod_batch(b, spec, out=staged.array)
                    self._device_step(variant, staged).get()
                finally:
                    self._stage_pins.discard(id(staged))
            self._warm_preempt()
            if self.device.type == "cuda" and default_timeline.enabled:
                self._anchor_clock()

    def _anchor_clock(self) -> None:
        """One (timing event, host time) pair, taken after a synchronize:
        the origin _event_clock maps the timeline's CUDA events through."""
        torch.cuda.synchronize(self.device)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ev.synchronize()
        self._clock_anchor = (ev, time.monotonic())

    def _event_clock(self):
        """A function from a completed CUDA timing event to its
        time.monotonic() reading; the anchor is taken at warmup when the
        timeline is armed by then, else here, once."""
        if self._clock_anchor is None:
            self._anchor_clock()
        ev0, t0 = self._clock_anchor
        return lambda ev: t0 + ev0.elapsed_time(ev) / 1e3

    def _warm_preempt(self) -> None:
        """Make the victim tensors resident and run the dry run once on an
        all-inactive chunk of the common single-group shape (on CUDA this
        loads csrc/preempt.cu), so neither lands in the first preemption
        wave.  Inactive pods are no candidates and hit no overflow."""
        self._ensure_vict()
        c = self.caps
        P = self.PREEMPT_P_CAP
        _to_host(*self._preempt_step({
            "req": np.zeros((P, c.r), np.float32),
            "prio": np.zeros(P, np.int32),
            "untol_hard": np.zeros((P, c.t_cap), np.float32),
            "group_idx": np.zeros(P, np.int32),
            "nom_used": np.zeros((1, c.n_cap, c.r), np.float32),
            "nom_np": np.zeros((1, c.n_cap), np.float32),
            "active": np.zeros(P, bool)}))

    # -- device census ---------------------------------------------------

    def device_census(self, variants: tuple = ("full", "plain"),
                      req=None) -> dict:
        """Cost census of the step variants, the counterpart of the JAX
        backend's (which lowers each variant and reads XLA's cost
        analysis): torch cannot cost a step without running it, so this
        runs ONE step of each variant on a clone of the resident state
        (the device state, the static arrays and `_gen`, the mirror and
        kernels.LAUNCHES are left as they were), on a fixed batch:
        every slot valid (batch_size pods, full_cap for the full variant),
        each pod requesting the smallest nonzero per-pod cpu and memory
        among the rows that hold pods (used / npods), or
        CENSUS_DEFAULT_REQ on an empty cluster, and tolerating every
        taint.  The step runs under torch.profiler (kernel launches and
        device time), a dispatch mode that sums the operand and result
        bytes of every aten op (views and allocations aside: the unfused
        traffic) and FlopCounterMode.  The hand kernels are invisible to
        both modes: each adds the bytes of its calls from the count beside
        it (kernels.claims_bytes) where it launched (on the CPU their
        plain versions ran as aten ops and are counted as such).

        Returns {variant: {"collectives": {}, "per_call_bytes": 0,
        "per_wave_bytes": 0 (one device), "cost": {"flops",
        "bytes_accessed"}, "kernels": {name: {"launches", "device_ms",
        "bytes", "bound_ms", "bound_by"}}, "device_ms", "waves",
        "batch": {"pods", "req"}}}; device_ms are 0.0 off the card.
        `req` overrides the census pod's request (the remote worker,
        which keeps no host copy of the state, takes its client's).  The
        clone is taken under the backend lock and the steps run outside
        it, so a census does not stall a concurrent dispatch.  torch's
        profiler allows one session a process: never run a census inside
        another profiler's window."""
        names = [v for v in ("full", "plain") if v in variants]
        with self._lock:
            plans = [self._census_plan(v, req) for v in names]
        return {v: census_run(self.device, self._stepped, v, *plan)
                for v, plan in zip(names, plans)}

    def _census_plan(self, variant: str, req=None) -> tuple:
        """(step fn, cloned state, static arrays, packed batch on the
        device, pods, request) for one census step (caller holds the
        lock)."""
        t = self.tensors

        def dev(a):
            # sync-point: a pageable host-to-device copy (between waves)
            return torch.tensor(a, device=self.device)

        if self._state is not None:
            state = clone_state(self._state)
        else:
            cd_sg, cd_asg = t.domain_base_counts()
            state = {"used": dev(t.used), "used_nz": dev(t.used_nz),
                     "npods": dev(t.npods), "port_mask": dev(t.port_mask),
                     "cd_sg": dev(cd_sg), "cd_asg": dev(cd_asg),
                     "gen": dev(np.int32(self._gen))}
        static = (self._static_node if self._static_node is not None
                  and self._static_version == t.static_version
                  else {k: dev(getattr(t, k)) for k in STATIC_CORE})
        batch = self.encoder.encode([])
        if variant == "full":
            fn, spec, pods = self._ensure_full(), self._spec_full, self.full_cap
            static = {**static,
                      **(self._static_sel if self._static_sel is not None
                         and self._static_version == t.static_version
                         else {k: dev(getattr(t, k)) for k in STATIC_SEL})}
            batch = slice_pod_batch(batch, 0, 0, pods)
        else:
            fn, spec, pods = self._ensure_plain(), self._spec_plain, \
                self.batch_size
        if req is None:
            req = self._census_req()
        batch = dataclasses.replace(
            batch, req=np.tile(req, (pods, 1)), req_nz=np.tile(req, (pods, 1)),
            p_valid=np.ones(pods, bool))
        # sync-point: the census batch's pageable upload
        buf = torch.from_numpy(pack_pod_batch(batch, spec)).to(self.device)
        return fn, state, static, buf, pods, req

    def _stage_buf(self, total: int) -> _StagedBuffer:
        """Hand out a host staging buffer of `total` f32 slots from the
        ring (caller holds the lock): one that no unresolved wave retains
        and whose last upload has completed.  The ring is bounded; under
        deep pipelines overflow buffers are one-shot allocations."""
        for sb in self._stage_ring:
            if (sb.host.numel() == total and id(sb) not in self._stage_pins
                    and sb.upload_done()):
                self._stage_pins.add(id(sb))
                return sb
        sb = _StagedBuffer(total, pin=self.device.type == "cuda")
        if len(self._stage_ring) < self.STAGE_RING_MAX:
            self._stage_ring.append(sb)
        self._stage_pins.add(id(sb))
        return sb

    def _device_step(self, variant: str, staged: _StagedBuffer,
                     clock: _WaveClock | None = None) -> _Result:
        """Run one packed batch through the `variant` step ("plain",
        "full" or "full_small") and return the result vector's handle,
        registered with the wave's timeline `clock` when one is given.
        Everything above this call is host bookkeeping; everything below
        is device execution."""
        if variant == "plain":
            fn, static = self._fn_plain, self._static_node
        else:
            self._ensure_sel()
            fn = (self._fn_full if variant == "full"
                  else self._ensure_full_small())
            static = {**self._static_node, **self._static_sel}
        if self.device.type == "cuda":
            buf = staged.host.to(self.device, non_blocking=True)
            staged.uploaded = torch.cuda.Event()
            staged.uploaded.record()
        else:
            buf = staged.host
        self._state, rd = fn(self._state, static, buf)
        self._stepped.add(variant)
        self._gen += 1  # the step computes the identical state.gen + 1
        res = _Result(rd, self.device, timed=clock is not None)
        if clock is not None:
            clock.results.append(res)
        return res

    def _ensure_sel(self) -> None:
        """Upload the selector-side static arrays if they are not resident
        (lazy: only the full variant reads them; once resident,
        _upload_static keeps them current)."""
        if self._static_sel is None:
            t = self.tensors
            # sync-point: pageable host-to-device copies (first full step)
            self._static_sel = {k: torch.tensor(getattr(t, k),
                                                device=self.device)
                                for k in STATIC_SEL}

    def _ensure_full(self):
        if self._fn_full is None:
            self._fn_full, self._spec_full = build_packed_assign_fn(
                self.caps, self.full_cap, self._k_cap, self._weights,
                features=ALL_FEATURES,
                max_waves=self.full_main_waves or None, device=self.device)
        return self._fn_full

    def _retry_cap(self) -> int:
        # small: straggler waves serialize when every leftover claims the
        # current-minimum spread domain, and chunk-to-chunk state chaining
        # re-balances claims between chunks anyway
        return min(128, self.full_cap)

    def _ensure_full_small(self):
        """The straggler retry step: the full variant at a small P with
        the exhaustive wave budget, so capped-main leftovers drain at
        ~(P_small/P)^2 of a main wave's [P,P] cost and the no-progress
        fixpoint is kept."""
        if self._fn_full_small is None:
            self._fn_full_small, self._spec_full_small = \
                build_packed_assign_fn(
                    self.caps, self._retry_cap(), self._k_cap, self._weights,
                    features=ALL_FEATURES, device=self.device)
        return self._fn_full_small

    def _ensure_plain(self):
        if self._fn_plain is None:
            self._fn_plain, self._spec_plain = build_packed_assign_fn(
                self.caps, self.batch_size, self._k_cap,
                features=PLAIN_FEATURES, claims_noise=self.claims_noise,
                device=self.device)
        return self._fn_plain

    S_PATCH_MAX = 8192  # above this many dirty rows a full upload is cheaper

    def _upload_static(self) -> None:
        """Sync the device's static node arrays with the host tensors: a
        full upload when forced (first upload, vocab column backfills, or
        very many dirty rows), otherwise a row-wise overwrite of the
        resident arrays.  The selector-side arrays (STATIC_SEL) follow
        only when resident: otherwise the full variant's first step
        uploads them (_ensure_sel) — at 100k nodes they are ~140 MB that
        the plain variant never reads."""
        t = self.tensors
        rows = t.static_dirty_rows
        full = (self._static_node is None or t.static_full
                or len(rows) > self.S_PATCH_MAX
                or len(rows) * 8 > self.caps.n_cap)

        def dev(a):
            # sync-point: a pageable host-to-device copy (between waves)
            return torch.tensor(a, device=self.device)

        if full:
            self._static_node = {k: dev(getattr(t, k)) for k in STATIC_CORE}
            if self._static_sel is not None:
                self._static_sel = {k: dev(getattr(t, k))
                                    for k in STATIC_SEL}
        elif rows:
            rows_a = np.array(sorted(rows), np.int64)
            rows_t = dev(rows_a)
            _apply_static_patch(self._static_node, rows_t,
                                dev(t.alloc[rows_a]), dev(t.maxpods[rows_a]),
                                dev(t.valid[rows_a]),
                                dev(t.taint_mask[rows_a]))
            if self._static_sel is not None:
                _apply_sel_patch(self._static_sel, rows_t,
                                 dev(t.label_mask[rows_a]),
                                 dev(t.key_mask[rows_a]),
                                 dev(t.dom_sg[:, rows_a]),
                                 dev(t.dom_asg[:, rows_a]))
            self.stats["static_patched_rows"] = self.stats.get(
                "static_patched_rows", 0) + len(rows)
        t.static_dirty_rows = set()
        t.static_full = False
        self._static_version = t.static_version

    def _ensure_vict(self) -> None:
        """Re-encode the dirty victim rows and sync the resident victim
        tensors (STATIC_VICT): a full upload when forced (first upload, a
        PDB change, many rows), otherwise a row-wise overwrite, under
        _upload_static's rule."""
        t = self.tensors
        rows = t.refresh_victims()
        if (self._static_vict is not None and not t.vict_full
                and self._vict_version == t.vict_version):
            return
        full = (self._static_vict is None or t.vict_full or rows is None
                or len(rows) > self.S_PATCH_MAX
                or len(rows) * 8 > self.caps.n_cap)

        def dev(a):
            # sync-point: a pageable host-to-device copy (between waves)
            return torch.tensor(a, device=self.device)

        if full:
            self._static_vict = {k: dev(getattr(t, k)) for k in STATIC_VICT}
        else:
            rows_a = np.asarray(rows, np.int64)
            _apply_vict_patch(self._static_vict, dev(rows_a),
                              dev(t.vict_prio[rows_a]),
                              dev(t.vict_req[rows_a]),
                              dev(t.vict_pdb[rows_a]),
                              dev(t.vict_over[rows_a]))
            self.stats["vict_patched_rows"] = self.stats.get(
                "vict_patched_rows", 0) + len(rows)
        t.vict_full = False
        self._vict_version = t.vict_version
        # the dry-run kernel's shared-memory size, from the host copy
        from ..models.preempt import live_slot_cap
        self._vict_live_cap = live_slot_cap(t.vict_prio)

    def _full_refresh(self, cd_sg: np.ndarray, cd_asg: np.ndarray) -> None:
        t = self.tensors

        def dev(a):
            # sync-point: a pageable host-to-device copy (between waves)
            return torch.tensor(a, device=self.device)

        self._state = {
            "used": dev(t.used), "used_nz": dev(t.used_nz),
            "npods": dev(t.npods), "port_mask": dev(t.port_mask),
            "cd_sg": dev(cd_sg), "cd_asg": dev(cd_asg),
            "gen": dev(np.int32(self._gen)),
        }
        self._mirror_from_tensors(cd_sg, cd_asg)
        self.stats["full_refresh"] += 1

    # -- stuck-wave watchdog support -------------------------------------

    def abandon_wave(self) -> None:
        """Watchdog cancel: a cancelled wave's pods were requeued and never
        assumed, so its in-flight device accounting must not chain into
        the next dispatch.  Drop the pipeline bookkeeping and force a full
        tensor refresh from the authoritative cache view on the next
        batch.  Lock acquisition is best-effort with a short timeout: the
        stuck resolve may hold the lock, and the watchdog must not hang
        behind it; replacing _state/_last_epoch and clearing _unresolved
        only widens the next dispatch's refresh."""
        got = self._lock.acquire(timeout=0.1)
        try:
            self._unresolved.clear()
            self._state = None
            self._last_epoch = None
            self._fence_pending = 0
            self._stage_pins.clear()
            self.stats["abandoned_waves"] = (
                self.stats.get("abandoned_waves", 0) + 1)
        finally:
            if got:
                self._lock.release()

    # -- BatchBackend ----------------------------------------------------

    def _tracked_sync(self, snapshot) -> set[int]:
        """Bring the host tensors up to the snapshot (caller holds the
        lock); returns the rows it changed.  The wave timeline's patch
        leg."""
        t_sync = time.monotonic()
        dirty = set(self.tensors.update_from_snapshot_tracked(snapshot))
        t_end = time.monotonic()
        self.stats["flatten_seconds"] += t_end - t_sync
        if default_timeline.enabled:
            default_timeline.record("patch", t_sync, t_end)
        return dirty

    def dispatch(self, pod_infos: Sequence[PodInfo], snapshot: Snapshot):
        """Host prep + device dispatch.  Returns resolve() -> results, or
        the FLUSH_FIRST sentinel.

        Pipelining over an in-flight batch is allowed when this batch is
        clean (no patches, no refresh, no static change — the device chains
        its own resident accounting) OR when it needs only dynamic row
        patches and no fence is already pending: that wave dispatches
        FENCED — gen-bumped so its first device run provably goes stale
        and the authoritative answer comes from the mirror-restored re-run
        at its resolve.  A full refresh or a static change returns
        FLUSH_FIRST instead: the caller must resolve the in-flight batch
        AND finish its assume tail, then call dispatch again — the dirty
        rows from this attempt are carried over so no external change is
        lost.  A constraint batch (one that needs the full variant) larger
        than `full_cap` runs in chunks that chain the resident state; the
        row patches ride the first chunk.

        Observability, as the JAX backend's: under a sampled batch root
        span (the scheduler's, see _trace_parent) the batch gets the
        snapshot.flatten, plugin.filter_masks, plugin.score and
        plugin.assign_solve spans, tpu.h2d and tpu.d2h under the last;
        with the timeline armed it records patch, h2d, device-step and
        d2h (_WaveClock).  Off, neither costs more than a read."""
        parent = _trace_parent()
        with self._lock:
            if self._warm_pending:
                self._warm_sweep(snapshot)
            # epoch fast path: if every cache change since the last sync
            # came from this backend's own batches (bulk assume + confirm),
            # the mirror replay already holds the truth — skip the O(nodes)
            # re-encode and the diff outright
            epoch_fn = getattr(snapshot, "epoch", None)
            epoch = epoch_fn() if epoch_fn is not None else None
            skip_sync = (epoch is not None and self._state is not None
                         and epoch == self._last_epoch
                         and not self._carry_dirty)
            f_sp = (parent.tracer.start_span("snapshot.flatten",
                                             parent=parent)
                    if parent is not None else None)
            try:
                if skip_sync:
                    dirty = set()
                else:
                    dirty = self._tracked_sync(snapshot) | self._carry_dirty
                    self._last_epoch = epoch
                batch = self.encoder.encode(list(pod_infos))
                if (skip_sync and self._static_version
                        != self.tensors.static_version):
                    # the encode registered a selector group, so the domain
                    # counts are compared with the mirror below and a
                    # mismatch refreshes the device state from the host
                    # tensors; the skipped sync left those behind this
                    # backend's own binds since the last one, and a refresh
                    # from them would drop those pods from the device's
                    # accounting (nodes filled past their caps).  Nothing
                    # external changed (same epoch), so no row moves: sync
                    # now.
                    dirty = self._tracked_sync(snapshot)
                    skip_sync = False
            except VocabFullError as e:
                logger.warning("tensorization overflow (%s); batch -> oracle "
                               "path", e)
                # the tracked update may have partially applied: force a
                # full dynamic refresh on the next successful dispatch
                self._state = None
                self._carry_dirty = set()
                reason = ("constraint_capacity" if "constraint" in str(e)
                          else "vocab_full")
                self._tally_escape_pairs(
                    {("BatchEncoder", reason): len(pod_infos)})
                if f_sp is not None:
                    f_sp.add_event("vocab_overflow", error=str(e))
                    f_sp.end()
                results = [(None, Status(SKIP, str(e)))] * len(pod_infos)
                return lambda: results
            if f_sp is not None:
                f_sp.set_attribute("pods", len(pod_infos))
                f_sp.set_attribute("escaped", len(batch.escape))
                f_sp.set_attribute("dirty_rows", len(dirty))
                f_sp.set_attribute("sync_skipped", bool(skip_sync))
                f_sp.end()
            n_live = len(pod_infos)
            if n_live and not batch.p_valid[:min(n_live,
                                                self.batch_size)].any():
                # every pod escaped at encode: nothing for the device.  The
                # synced dirty rows carry so the next REAL dispatch diffs
                # them.
                self._carry_dirty = dirty
                self.stats["all_escape_skips"] = self.stats.get(
                    "all_escape_skips", 0) + 1
                self._tally_batch_escapes(batch, n_live)
                if parent is not None:
                    parent.add_event("all_escape_skip", pods=n_live)
                results = [
                    (None, Status(SKIP, "escape to per-pod path"))
                    ] * n_live

                def resolve_escaped():
                    record_batch_stats(self.stats, self._lock, results,
                                       n_live)
                    return results

                return resolve_escaped

            # per-plugin batch telemetry: the filter-mask densities and the
            # device feasibility domain, queued (at resolve, with the wave
            # count) for the scheduler's tpu_mask_density /
            # tpu_feasible_nodes metrics and, under a sampled root, set as
            # span attributes with the score-term densities.  The step fuses
            # filter, score and solve, so these two spans time the host
            # telemetry pass; the solve span below is the device's phase.
            fm_sp = (parent.tracer.start_span("plugin.filter_masks",
                                              parent=parent)
                     if parent is not None else None)
            # host-array: the host tensors' valid rows
            feasible = int(self.tensors.valid.sum())
            # a no-fit verdict on a pod riding a collided selector bucket is
            # re-proved pod by pod (the bucket's counts are upper bounds),
            # but only where a node exists: with no valid row (a batch that
            # ran ahead of the node informer) nothing could have fit, so the
            # verdict is exact and the pods stay UNSCHEDULABLE
            nofit = set(batch.nofit_oracle) if feasible else set()
            telem = {
                "pods": n_live,
                "feasible_nodes": feasible,
                "mask_density": self._mask_densities(batch, n_live),
            }
            if fm_sp is not None:
                fm_sp.set_attribute("feasible_nodes",
                                    telem["feasible_nodes"])
                for plugin, d in telem["mask_density"].items():
                    fm_sp.set_attribute(plugin, round(d, 4))
                fm_sp.end()
            sc_sp = (parent.tracer.start_span("plugin.score", parent=parent)
                     if parent is not None else None)
            if sc_sp is not None:
                for term, d in self._score_densities(batch, n_live).items():
                    sc_sp.set_attribute(term, round(d, 4))
                sc_sp.end()

            inflight = bool(self._unresolved)
            # deterministic compaction point: compaction order is visible
            # in row tie-breaks, so it is anchored to the wave boundary
            # (draining the pipeline first) to keep depth-1 and depth-2
            # runs bit-identical
            if (self.tensors.tombstone_count() * self.COMPACT_TOMBSTONE_DIV
                    >= self.caps.n_cap):
                if inflight:
                    self._carry_dirty = dirty
                    self.stats["flush_first"] += 1
                    return FLUSH_FIRST
                if self.tensors.compact():
                    self.stats["compactions"] = self.stats.get(
                        "compactions", 0) + 1
            static_changed = self._static_version != self.tensors.static_version
            if skip_sync and not static_changed:
                patches = (np.empty(0, np.int32),
                           np.empty((0, self._f_patch), np.float32))
                needs_refresh = needs_patch = False
            else:
                cd_sg, cd_asg = self.tensors.domain_base_counts()
                patches = None
                if self._state is not None:
                    if (np.array_equal(cd_sg, self._mirror["cd_sg"])
                            and np.array_equal(cd_asg, self._mirror["cd_asg"])):
                        patches = self._diff_patches(sorted(dirty))
                needs_refresh = self._state is None or patches is None
                needs_patch = patches is not None and len(patches[0]) > 0
            # pipeline admission: a full re-encode can never overlap an
            # in-flight wave, and only ONE fenced wave may ride the
            # pipeline at a time.  STATIC changes never fence: the static
            # arrays are swapped in place, and a predecessor's fenced
            # re-run at resolve would read the new arrays.
            will_fence = False
            if inflight and (needs_refresh or static_changed):
                self._carry_dirty = dirty
                self.stats["flush_first"] += 1
                return FLUSH_FIRST
            if inflight and needs_patch:
                if self._fence_pending:
                    self._carry_dirty = dirty
                    self.stats["flush_first"] += 1
                    return FLUSH_FIRST
                will_fence = True

            if static_changed:
                self._upload_static()
            if needs_refresh:
                self._full_refresh(cd_sg, cd_asg)
                patches = (np.empty(0, np.int32),
                           np.empty((0, self._f_patch), np.float32))
            elif needs_patch:
                self._sync_mirror_rows(patches[0])
            if will_fence:
                # the patch VALUES travel via the mirror rows just synced,
                # never via the retained upload buffer: the in-flight
                # predecessor's replay will ADD its commits onto those
                # mirror rows before this wave's re-run, and a buffer-borne
                # patch would SET them back, wiping its commits
                self.stats["patched_rows"] += len(patches[0])
                patches = (np.empty(0, np.int32),
                           np.empty((0, self._f_patch), np.float32))
                self._gen += 1  # guarantee this wave's fence trips
                self._fence_pending += 1
                self.stats["fenced_waves"] = self.stats.get(
                    "fenced_waves", 0) + 1
            self.stats["waves_reflattened" if needs_refresh
                       else "waves_patched"] += 1
            self._carry_dirty = set()
            self.stats["patched_rows"] += len(patches[0])
            self.stats["epoch_skips"] = self.stats.get("epoch_skips", 0) + (
                1 if skip_sync else 0)

            n = len(pod_infos)
            empty = (np.empty(0, np.int32),
                     np.empty((0, self._f_patch), np.float32))
            # plugin.assign_solve spans launch -> resolve (ended by
            # resolve() below); tpu.h2d covers pack + upload + launch
            # inside it
            solve_sp = (parent.tracer.start_span("plugin.assign_solve",
                                                 parent=parent)
                        if parent is not None else None)
            h2d_sp = (parent.tracer.start_span("tpu.h2d", parent=solve_sp)
                      if solve_sp is not None else None)
            clock = _WaveClock(self) if default_timeline.enabled else None
            # chunk tuples retain the staged buffer, the variant and the
            # expected device generation, so a fenced resolve can re-run
            # the identical chunks from the restored state
            chunks = []
            if self._needs_full(batch):
                self._ensure_full()
                if n > self.full_cap:
                    # oversized constraint batch: chunk through the capped
                    # full step; the resident state chains chunk to chunk,
                    # so intra-batch accounting stays exact
                    spans = [(lo, min(lo + self.full_cap, n))
                             for lo in range(0, n, self.full_cap)]
                elif self.full_cap == self.batch_size:
                    spans = [(0, self.batch_size)]
                else:
                    spans = [(0, n)]
                p = patches
                for lo, hi in spans:
                    cb = (batch if hi - lo == self.batch_size
                          else slice_pod_batch(batch, lo, hi, self.full_cap))
                    staged = self._stage_buf(self._spec_full.total)
                    pack_pod_batch(cb, self._spec_full, p[0], p[1],
                                   out=staged.array)
                    p = empty
                    if clock is not None and not chunks:
                        clock.launch()
                    chunks.append((self._device_step("full", staged, clock),
                                   lo, hi, "full", staged, self._gen))
            else:
                self.stats["plain"] = self.stats.get("plain", 0) + 1
                self._ensure_plain()
                staged = self._stage_buf(self._spec_plain.total)
                pack_pod_batch(batch, self._spec_plain, patches[0],
                               patches[1], out=staged.array)
                if clock is not None:
                    clock.launch()
                chunks.append((self._device_step("plain", staged, clock), 0,
                               self.batch_size, "plain", staged, self._gen))
            if h2d_sp is not None:
                h2d_sp.set_attribute("chunks", len(chunks))
                h2d_sp.set_attribute("variant", chunks[0][3])
                h2d_sp.set_attribute("patched_rows", int(len(patches[0])))
                h2d_sp.end()
            self.stats["batches"] += 1
            holder = object()
            self._unresolved.append(holder)
            # row->name view AT DISPATCH: a later dispatch may recycle rows,
            # so resolve() must not read the live tensors
            row_names = list(self.tensors.row_names)
            was_full = self._needs_full(batch)

        def resolve() -> list[tuple[str | None, Status | None]]:
            nonlocal will_fence
            batch_waves = 0
            try:
                with self._lock:
                    assignments = np.full(self.batch_size, -1, np.int64)
                    d2h_sp = (solve_sp.tracer.start_span("tpu.d2h",
                                                         parent=solve_sp)
                              if solve_sp is not None else None)
                    if clock is not None:
                        clock.pull()
                    # a fenced wave is stale BY CONSTRUCTION: start from the
                    # fence flag so the replay below is unconditional for it
                    stale = bool(will_fence)
                    raw = []
                    for pending, _lo, _hi, _variant, _staged, expect in chunks:
                        result = pending.get()
                        stale = stale or int(result[-1]) != expect
                        raw.append(result)
                    if stale:
                        # generation fence tripped: rebuild the state from
                        # the replay mirror and re-run the retained chunks
                        # in order — identical inputs against the
                        # authoritative state
                        if will_fence:
                            self.stats["fence_replays"] = self.stats.get(
                                "fence_replays", 0) + 1
                        else:
                            logger.warning(
                                "generation-stale wave (device gen "
                                "mismatch); re-running %d chunk(s) from "
                                "restored state", len(chunks))
                            self.stats["gen_stale_waves"] = self.stats.get(
                                "gen_stale_waves", 0) + 1
                        self._restore_state_from_mirror()
                        raw = [self._device_step(variant, staged,
                                                 clock).get()
                               for _p, _lo, _hi, variant, staged, _e
                               in chunks]
                    if clock is not None:
                        clock.record()
                    for result, (_p, lo, hi, *_rest) in zip(raw, chunks):
                        assignments[lo:hi] = result[:-2][:hi - lo]
                        batch_waves += int(result[-2])
                    if d2h_sp is not None:
                        d2h_sp.set_attribute("chunks", len(chunks))
                        d2h_sp.end()
                    self.stats["waves"] += batch_waves
                    self._replay(batch, assignments)
                    if was_full and self.full_main_waves:
                        self._retry_stragglers(batch, assignments, n)
                    try:
                        self._unresolved.remove(holder)
                    except ValueError:  # pragma: no cover - double resolve
                        pass
            finally:
                # the pins and the fence slot free even when the resolve
                # fails: a fence that never cleared would wedge every
                # future patch dispatch behind FLUSH_FIRST
                for _p, _lo, _hi, _variant, staged, _e in chunks:
                    self._stage_pins.discard(id(staged))
                if will_fence:
                    self._fence_pending = max(0, self._fence_pending - 1)
                    will_fence = False
            if solve_sp is not None:
                solve_sp.set_attribute("waves", batch_waves)
                solve_sp.set_attribute("pods", n)
                solve_sp.end()
            out = decode_results(assignments, n, self.batch_size,
                                 set(batch.escape), row_names,
                                 "no feasible node (GPU batch filter)",
                                 nofit_escapes=nofit)
            self._tally_batch_escapes(batch, n, assignments, nofit)
            telem["waves"] = batch_waves
            with self._esc_lock:
                self._telemetry_pending.append(telem)
                del self._telemetry_pending[:-self.TELEMETRY_PENDING_MAX]
            record_batch_stats(self.stats, self._lock, out, n)
            return out

        return resolve

    def _retry_stragglers(self, batch, assignments: np.ndarray,
                          n: int) -> None:
        """Drain a capped main run's leftovers through the small retry
        step (caller holds the lock; mutates `assignments` in place).
        Rounds re-offer the unplaced pods in chunks of _retry_cap() until
        a round places nothing or one chunk held them all (that chunk ran
        the exhaustive wave budget: the fixpoint).  Retry steps chain the
        same resident state as ordinary batches, and the mirror replay is
        additive."""
        self._ensure_full_small()
        skip = set(batch.escape)
        cap = self._retry_cap()
        for _round in range(self.RETRY_ROUNDS_MAX):
            left = [i for i in range(min(n, self.batch_size))
                    if assignments[i] < 0 and i not in skip]
            if not left:
                return
            one_chunk = len(left) <= cap
            placed_this_round = 0
            for lo in range(0, len(left), cap):
                idx = left[lo:lo + cap]
                rb = gather_pod_batch(batch, idx, cap)
                staged = self._stage_buf(self._spec_full_small.total)
                try:
                    pack_pod_batch(rb, self._spec_full_small,
                                   out=staged.array)
                    res = self._device_step("full_small", staged).get()
                    if int(res[-1]) != self._gen:
                        # generation fence: restore from the mirror (which
                        # already holds this batch's replays) and re-post
                        self.stats["gen_stale_waves"] = self.stats.get(
                            "gen_stale_waves", 0) + 1
                        self._restore_state_from_mirror()
                        res = self._device_step("full_small", staged).get()
                finally:
                    self._stage_pins.discard(id(staged))
                self.stats["waves"] += int(res[-2])
                sub = res[:-2]
                self._replay(rb, sub)
                for j, orig in enumerate(idx):
                    if sub[j] >= 0:
                        assignments[orig] = sub[j]
                        placed_this_round += 1
            self.stats["retries"] = self.stats.get("retries", 0) + 1
            if not placed_this_round or one_chunk:
                return

    def assign(self, pod_infos: Sequence[PodInfo], snapshot: Snapshot
               ) -> list[tuple[str | None, Status | None]]:
        resolve = self.dispatch(pod_infos, snapshot)
        if resolve is FLUSH_FIRST:
            raise RuntimeError("FLUSH_FIRST with no pipelined caller")
        return resolve()

    # -- escape tallies ----------------------------------------------------

    def _tally_escape_pairs(self, pairs: dict) -> None:
        with self._esc_lock:
            pend = self._escape_pending
            for key, cnt in pairs.items():
                pend[key] = pend.get(key, 0) + cnt

    def _tally_batch_escapes(self, batch: PodBatch, n: int,
                             assignments=None, nofit=None) -> None:
        """Accumulate this batch's per-(plugin, reason) escape counts.
        Encoder escapes carry their reason from flatten.escape_reasons;
        a no-fit verdict on a pod of `nofit` (default: the batch's
        nofit_oracle) is a per-pod re-proof: a nominated pod's carries the
        encoder's ("DefaultPreemption", "nominated_node_stale"), a
        collided-bucket pod's is attributed to the encoder's shared-bucket
        transport."""
        pend: dict = {}
        esc = set(batch.escape)
        for i in esc:
            if i < n:
                key = (batch.escape_reasons.get(i)
                       or ("BatchEncoder", "unencodable"))
                pend[key] = pend.get(key, 0) + 1
        for i in (set(batch.nofit_oracle) if nofit is None else nofit):
            if (i < n and i not in esc and i < self.batch_size
                    and (assignments is None or assignments[i] < 0)):
                key = (batch.escape_reasons.get(i)
                       or ("BatchEncoder", "bucket_collision"))
                pend[key] = pend.get(key, 0) + 1
        if pend:
            self._tally_escape_pairs(pend)

    def drain_escape_reasons(self) -> dict:
        """Pop the pending {(plugin, reason): count} escape tallies; the
        scheduler incs scheduler_tpu_escape_total by these deltas."""
        with self._esc_lock:
            out, self._escape_pending = self._escape_pending, {}
        return out

    # -- batch telemetry ---------------------------------------------------

    def drain_batch_telemetry(self) -> list[dict]:
        """Pop the pending per-batch telemetry dicts ({pods,
        feasible_nodes, mask_density, waves}) for the scheduler's gauge
        and histogram updates."""
        with self._esc_lock:
            out, self._telemetry_pending = self._telemetry_pending, []
        return out

    # host-array: the encoded batch's numpy fields
    def _mask_densities(self, batch: PodBatch, n: int) -> dict[str, float]:
        """Per-plugin-family constraint-mask density: the fraction of the
        batch's live slots carrying an active mask for that family.  The
        device step fuses filter and score, so these host numbers are what
        'how selective was this batch' means per plugin."""
        nl = max(1, min(n, self.batch_size))

        def rows(a):
            if a is None:
                return None
            return (a[:nl].reshape(nl, -1) != 0).any(axis=1)

        def dens(*arrays):
            acc = None
            for a in arrays:
                r = rows(a)
                if r is not None:
                    acc = r if acc is None else (acc | r)
            return float(acc.sum()) / nl if acc is not None else 0.0

        def kind_dens(*kinds):
            if batch.c_kind is None:
                return 0.0
            ck = batch.c_kind[:nl]
            acc = np.zeros(nl, bool)
            for k in kinds:
                acc |= (ck == k).any(axis=1)
            return float(acc.sum()) / nl

        out = {
            "NodeAffinity": dens(batch.sel_any_active, batch.key_any_active,
                                 batch.sel_forb, batch.key_forb),
            "InterPodAffinity": kind_dens(C_AFFINITY, C_ANTI_AFFINITY,
                                          C_PREF_AFFINITY),
            "PodTopologySpread": kind_dens(C_SPREAD_HARD, C_SPREAD_SCORE),
            "TaintToleration": dens(batch.untol_hard, batch.untol_prefer),
            "NodePorts": dens(batch.ports),
        }
        if batch.node_row is not None:
            out["NodeName"] = float(
                (batch.node_row[:nl] >= 0).sum()) / nl
        return out

    # host-array: the encoded batch's numpy fields
    def _score_densities(self, batch: PodBatch, n: int) -> dict[str, float]:
        """Score-phase twin of _mask_densities: the soft (weight-carrying)
        terms the step's score accumulation reads."""
        nl = max(1, min(n, self.batch_size))
        out = {"preferred_affinity": 0.0, "prefer_no_schedule": 0.0}
        if batch.c_weight is not None:
            out["preferred_affinity"] = float(
                (batch.c_weight[:nl] != 0).any(axis=1).sum()) / nl
        if batch.untol_prefer is not None:
            out["prefer_no_schedule"] = float(
                (batch.untol_prefer[:nl] != 0).any(axis=1).sum()) / nl
        return out

    # -- batched preemption (PostFilter's device half) -------------------

    # failed pods per dry-run call (padded); at n_cap 110,080 the kernel's
    # planes for a chunk are ~0.6 GB
    PREEMPT_P_CAP = 256
    PREEMPT_G_CAP = 8    # distinct priority groups per call

    def _req_vec(self, res) -> np.ndarray:
        """Resource -> the flattener's [R] request layout (core columns +
        scalar-vocab slots)."""
        from .flatten import CORE_R
        v = np.zeros(self.caps.r, np.float32)
        v[0] = res.milli_cpu
        v[1] = res.memory
        v[2] = res.ephemeral_storage
        for name, val in (res.scalar or {}).items():
            sid = self.tensors.scalar_vocab.lookup(name)
            if sid is not None:  # victims with unknown scalars reclaim
                v[CORE_R + sid] = val  # nothing the incoming pod can use
        return v

    def preempt_candidates(self, pod_infos: Sequence[PodInfo], k: int = 16
                           ) -> list[list[str] | None]:
        """For each FitError pod, the top-k candidate node names where
        removing every lower-priority pod would make it fit (K8,
        models/preempt.py), best first.  None = this pod needs a host full
        scan (priority-group overflow).  The host re-proves every
        candidate with the full filter set, so this is a candidate LIMIT,
        never a wrong answer."""
        from ..models.preempt import preempt_candidates as dev_fn
        out: list[list[str] | None] = [None] * len(pod_infos)
        with self._lock:
            t = self.tensors
            prios = sorted({pi.priority for pi in pod_infos})
            groups = prios[:self.PREEMPT_G_CAP]
            gid_of = {p: g for g, p in enumerate(groups)}
            G, N, R = max(len(groups), 1), self.caps.n_cap, self.caps.r
            reclaim = np.zeros((G, N, R), np.float32)
            reclaim_np = np.zeros((G, N), np.float32)
            thresholds = np.asarray(groups or [0], np.float32)
            for row, ni in enumerate(t.node_infos):
                if ni is None or not t.valid[row]:
                    continue
                for vp in ni.pods:
                    gmask = vp.priority < thresholds  # groups this victim
                    if not gmask.any():               # is reclaimable for
                        continue
                    rv = self._req_vec(vp.request)
                    reclaim[gmask, row] += rv
                    reclaim_np[gmask, row] += 1.0
            row_names = list(t.row_names)

            def dev(a):
                # sync-point: a pageable host-to-device copy (between waves)
                return torch.tensor(a, device=self.device)
            node_args = [dev(a) for a in (t.alloc, t.used, t.npods,
                                          t.maxpods, t.valid, reclaim,
                                          reclaim_np)]

        P = self.PREEMPT_P_CAP
        idxs = [i for i, pi in enumerate(pod_infos)
                if pi.priority in gid_of]
        for at in range(0, len(idxs), P):
            chunk = idxs[at:at + P]
            req = np.zeros((P, self.caps.r), np.float32)
            group_idx = np.zeros(P, np.int32)
            active = np.zeros(P, bool)
            for j, i in enumerate(chunk):
                req[j] = self._req_vec(pod_infos[i].request)
                group_idx[j] = gid_of[pod_infos[i].priority]
                active[j] = True
            rows, _count = _to_host(*dev_fn(
                *node_args, dev(group_idx), dev(req), dev(active), k))
            for j, i in enumerate(chunk):
                out[i] = [row_names[r] for r in rows[j] if r >= 0
                          and row_names[r] is not None]
        return out

    def victim_occupancy(self) -> float:
        """Fraction of victim slots in use across live rows (the
        tpu_victim_occupancy gauge feed)."""
        with self._lock:
            return self.tensors.victim_occupancy()

    def _preempt_step(self, body: dict):
        """Run one padded preemptor chunk (`body`: numpy pod-side arrays
        and nominations) through the dry run against the RESIDENT node
        state and victim tensors; returns the device planes of
        models/preempt.dry_run_planes (victims as bit words).  Everything
        above is host bookkeeping; this is the device call."""
        from ..models.preempt import dry_run_planes
        t = self.tensors
        st = self._state

        def dev(a):
            # sync-point: a pageable host-to-device copy (between waves)
            return torch.tensor(a, device=self.device)

        used = st["used"] if st is not None else dev(t.used)
        npods = st["npods"] if st is not None else dev(t.npods)
        s = self._static_node
        v = self._static_vict
        return dry_run_planes(
            s["alloc"], used, npods, s["maxpods"], s["valid"],
            s["taint_mask"], v["vict_prio"], v["vict_req"], v["vict_pdb"],
            v["vict_over"], dev(body["nom_used"]), dev(body["nom_np"]),
            dev(body["group_idx"]), dev(body["req"]), dev(body["prio"]),
            dev(body["untol_hard"]), dev(body["active"]),
            k_cap=self._vict_live_cap)

    def preempt_batch(self, pod_infos: Sequence[PodInfo],
                      node_ord_of: dict, nominated=()):
        """Device-side DryRunPreemption for a wave of plain,
        preemption-eligible failed pods: per pod, the reference-selected
        candidate node + exact victim set + PDB violation count, one
        dry-run call per PREEMPT_P_CAP chunk instead of a host dry run per
        (pod, node) pair.

        The dry run returns the per-(pod, node) planes; selection happens
        HERE, in caller order, so one wave conflict-resolves without a
        device call per preemptor: unclaimed nodes keep their planes
        untouched (a nomination only changes its own node's columns), and
        a node claimed by an earlier winner is either proved closed by a
        host feasibility bound or re-proved exactly by a host replay of
        the dry run with the claims folded in — identical to running the
        sequential Evaluator pod by pod, nominating each winner before the
        next.

        node_ord_of: {node_name: snapshot.list() position}, the selection
        tie-break of last resort.  nominated: [(PodInfo, node_name)] pods
        holding nominations, folded into per-priority-group claimed
        capacity as RunFilterPluginsWithNominatedPods does (only
        >=-priority nominations claim).

        Returns (results, escapes): results[i] = (node_name, [victim pod
        keys], num_pdb_violations) when a candidate was selected, None when
        there is none; escapes[i] = a reason string when pod i must fall
        back to the per-pod Evaluator (such i have results[i] = None).
        Anything the dry run does not model escapes with its reason."""
        n = len(pod_infos)
        out: list[tuple | None] = [None] * n
        escapes: dict[int, str] = {}
        # the serialization the wave's answers are exact against: live
        # indices in finalization order (commit or proved-None)
        self.last_wave_order: list[int] = []
        with self._lock:
            t = self.tensors
            self.stats["preempt_waves"] = self.stats.get(
                "preempt_waves", 0) + 1
            live: list[int] = []
            if t.asgs or t.ns_anti_kv or t.ns_anti_complex:
                # resident anti-affinity groups can veto the preemptor in
                # the Evaluator's full filter set, which the dry run does
                # not model: the wave falls back wholesale
                for i in range(n):
                    escapes[i] = "constraint_groups"
            else:
                # PDB parity gate: the coverage bit is computed against ALL
                # blocking PDBs, the Evaluator lists only the preemptor's
                # namespace; they agree iff every blocking PDB lives there
                bns = {ns for ns, _sel in t.pdb_blocking()}
                for i, pi in enumerate(pod_infos):
                    if bns and bns != {pi.key.split("/", 1)[0]}:
                        escapes[i] = "pdb_scope"
                    else:
                        live.append(i)
                prios = sorted({pod_infos[i].priority for i in live})
                if len(prios) > self.PREEMPT_G_CAP:
                    keep = set(prios[:self.PREEMPT_G_CAP])
                    for i in list(live):
                        if pod_infos[i].priority not in keep:
                            escapes[i] = "priority_groups"
                    live = [i for i in live if i not in escapes]
                    prios = prios[:self.PREEMPT_G_CAP]
            if live:
                from .flatten import untolerated_hard
                self._ensure_vict()
                if (self._static_node is None
                        or self._static_version != t.static_version):
                    self._upload_static()
                if self._state is None:
                    # a preemption wave before any dispatch: make the
                    # dynamic state resident, so the dry run and the host
                    # bound below read the same used/npods
                    cd_sg, cd_asg = t.domain_base_counts()
                    self._full_refresh(cd_sg, cd_asg)
                G, N, R = len(prios), self.caps.n_cap, self.caps.r
                gid_of = {p: g for g, p in enumerate(prios)}
                node_ord = np.full(N, 2**31 - 1, np.int32)
                for name, pos in node_ord_of.items():
                    row = t.row_of.get(name)
                    if row is not None and t.valid[row]:
                        node_ord[row] = pos
                row_names = list(t.row_names)
                vict_keys = [list(ks) if ks else [] for ks in t.vict_keys]
                # host copies for the post-claim feasibility bound: the
                # resident aggregates the dry run reads, in one pull
                alloc_h = np.asarray(t.alloc, np.float32)
                used_h, npods_h = self._resident_aggregates()
                maxpods_h = np.asarray(t.maxpods, np.float32)
                taint_h = np.asarray(t.taint_mask, np.float32)
                vict_prio_h = np.asarray(t.vict_prio, np.int32)
                vict_req_h = np.asarray(t.vict_req, np.float32)
                I32M = 2**31 - 1

                def _pick(mask, kviol, khigh, kpsum, knvic):
                    # pickOneNodeForPreemption: lexicographic min over
                    # (violations, highest victim priority, priority sum,
                    # victim count, snapshot order); node_ord is unique,
                    # so exactly one row survives
                    m = mask.copy()
                    for key, sent in ((kviol, np.inf), (khigh, I32M),
                                      (kpsum, np.inf), (knvic, np.inf),
                                      (node_ord, I32M)):
                        kmin = np.min(np.where(m, key, sent))
                        m &= key == kmin
                    return int(np.argmax(m))

                P = self.PREEMPT_P_CAP
                nom_used = np.zeros((G, N, R), np.float32)
                nom_np = np.zeros((G, N), np.float32)
                for npi, nnode in nominated:
                    row = t.row_of.get(nnode)
                    if row is None or not t.valid[row]:
                        continue
                    rv = self._req_vec(npi.request)
                    for g, p in enumerate(prios):
                        if npi.priority >= p:
                            nom_used[g, row] += rv
                            nom_np[g, row] += 1.0
                # THIS wave's winners: row -> [(claimant priority, request
                # vector)].  Claims are not re-sent to the device: a claimed
                # candidate is re-proved host-side by _host_dry_run below.
                claimed_rows = np.zeros(N, bool)
                claims_by_row: dict[int, list] = {}
                vict_pdb_h = np.asarray(t.vict_pdb, np.float32)
                V = vict_prio_h.shape[1]
                # per-node reprieve order, the dry run's
                slot = np.broadcast_to(np.arange(V), vict_prio_h.shape)
                ordv_h = np.lexsort(
                    (slot, -vict_prio_h, -vict_pdb_h), axis=-1)
                eps32 = np.float32(1e-6)

                # host-array: the victim slots' host copies
                def _host_dry_run(rc, prio_j, req_j, g_j):
                    """The dry run for ONE (pod, claimed node) pair with the
                    wave's claims on that node folded in as >=-priority
                    nominations: f32 and the same reprieve order, so the
                    key is what the device would have given with the
                    claims resident.  Returns (key, victim_mask,
                    violations) or None when the node yields no
                    candidate."""
                    elig = vict_prio_h[rc] < prio_j
                    nelig = float(elig.sum())
                    if nelig == 0.0:
                        return None
                    freed = (elig[:, None].astype(np.float32)
                             * vict_req_h[rc]).sum(axis=0, dtype=np.float32)
                    cl_used = np.zeros(R, np.float32)
                    cl_np = np.float32(0.0)
                    for cp, crv in claims_by_row[rc]:
                        if cp >= prio_j:
                            cl_used = cl_used + crv
                            cl_np += np.float32(1.0)
                    free = (alloc_h[rc] - (used_h[rc]
                                           + nom_used[g_j, rc] + cl_used)
                            + freed).astype(np.float32)
                    slack = np.float32(
                        maxpods_h[rc] - (npods_h[rc] + nom_np[g_j, rc]
                                         + cl_np - nelig))
                    if not (np.all(req_j <= free + eps32) and slack >= 1.0):
                        return None
                    reprieved = np.zeros(V, bool)
                    for s in ordv_h[rc]:
                        if not elig[s]:
                            continue
                        ftry = free - vict_req_h[rc, s]
                        if (np.all(req_j <= ftry + eps32)
                                and (slack - 1.0) >= 1.0):
                            free = ftry
                            slack = np.float32(slack - 1.0)
                            reprieved[s] = True
                    vict = elig & ~reprieved
                    nv = float(vict.sum())
                    if nv == 0.0:
                        return None
                    viol = float((vict_pdb_h[rc] * vict).sum(
                        dtype=np.float32))
                    high = int(vict_prio_h[rc][vict].max())
                    ps = float((vict_prio_h[rc].astype(np.float32)
                                * vict).sum(dtype=np.float32))
                    return ((viol, high, ps, nv, int(node_ord[rc])),
                            vict, int(viol))

                for at in range(0, len(live), P):
                    chunk = live[at:at + P]
                    self.stats["preempt_chunks"] = self.stats.get(
                        "preempt_chunks", 0) + 1
                    req = np.zeros((P, R), np.float32)
                    prio = np.zeros(P, np.int32)
                    untol = np.zeros((P, self.caps.t_cap), np.float32)
                    gidx = np.zeros(P, np.int32)
                    active = np.zeros(P, bool)
                    for j, i in enumerate(chunk):
                        pi = pod_infos[i]
                        req[j] = self._req_vec(pi.request)
                        prio[j] = min(max(pi.priority, -(2**31) + 2),
                                      2**31 - 2)
                        untol[j] = untolerated_hard(t, pi)
                        gidx[j] = gid_of[pi.priority]
                        active[j] = True
                    (cand, kviol, khigh, kpsum, knvic, vwords,
                     overflow) = self._pull(*self._preempt_step({
                         "req": req, "prio": prio, "untol_hard": untol,
                         "group_idx": gidx, "nom_used": nom_used,
                         "nom_np": nom_np, "active": active}))
                    for j, i in enumerate(chunk):
                        if overflow[j]:
                            # a reachable node carries a truncated victim
                            # set: the pod re-proves host-side
                            escapes[i] = "victim_overflow"
                            continue
                        cj = cand[j]
                        # best OPEN node straight from the planes
                        best = None
                        open_m = cj & ~claimed_rows
                        if open_m.any():
                            r = _pick(open_m, kviol[j], khigh[j],
                                      kpsum[j], knvic[j])
                            best = ((float(kviol[j, r]), int(khigh[j, r]),
                                     float(kpsum[j, r]), float(knvic[j, r]),
                                     int(node_ord[r])),
                                    r, None, int(kviol[j, r]))
                        # a node claimed by an earlier winner may still be
                        # this pod's true minimum (capacity sharing): every
                        # claimed row is re-gated from scratch (the planes
                        # are claim-blind both ways): taints, then a cheap
                        # closure bound (every eligible victim evicted,
                        # claims charged), then the exact replay
                        for rc in np.nonzero(claimed_rows)[0]:
                            if float(untol[j] @ taint_h[rc]) != 0.0:
                                continue
                            elig = vict_prio_h[rc] < prio[j]
                            freed = (vict_req_h[rc][elig].sum(axis=0)
                                     if elig.any() else 0.0)
                            free_ub = (alloc_h[rc] - used_h[rc]
                                       - nom_used[gidx[j], rc] + freed)
                            # host-array: the eligible victims' count
                            n_elig = float(elig.sum())
                            slack_ub = (maxpods_h[rc]
                                        - (npods_h[rc]
                                           + nom_np[gidx[j], rc]
                                           - n_elig))
                            for cp, crv in claims_by_row[rc]:
                                if cp >= prio[j]:
                                    free_ub = free_ub - crv
                                    slack_ub -= 1.0
                            if not (np.all(req[j] <= free_ub + 1e-6)
                                    and slack_ub >= 1.0):
                                continue  # provably closed post-claim
                            res = _host_dry_run(rc, int(prio[j]),
                                                req[j], int(gidx[j]))
                            if res is None:
                                continue
                            ckey, cvict, cviol = res
                            if best is None or ckey < best[0]:
                                best = (ckey, int(rc), cvict, cviol)
                        if best is None:
                            # no open candidate and every claimed row proved
                            # closed or victimless post-claim: the
                            # sequential Evaluator finds none either
                            self.last_wave_order.append(i)
                            continue
                        _key, r, cvict, viol_out = best
                        keys = vict_keys[r]
                        if cvict is None:
                            word = int(vwords[j, r])
                            vs = [keys[s] for s in range(len(keys))
                                  if (word >> s) & 1]
                        else:
                            vs = [keys[s] for s in range(len(keys))
                                  if cvict[s]]
                        out[i] = (row_names[r], vs, viol_out)
                        self.last_wave_order.append(i)
                        claimed_rows[r] = True
                        claims_by_row.setdefault(r, []).append(
                            (int(prio[j]), req[j].copy()))
        if escapes:
            tl: dict = {}
            for reason in escapes.values():
                key = ("DefaultPreemption", reason)
                tl[key] = tl.get(key, 0) + 1
            self._tally_escape_pairs(tl)
        return out, escapes

    def _pull(self, *planes) -> list[np.ndarray]:
        """The dry run's planes to the host: one pull per chunk."""
        return _to_host(*planes)

    def _resident_aggregates(self) -> list[np.ndarray]:
        """Host copies of the resident used and npods, in one pull: what
        the dry run reads, for preempt_batch's post-claim bound."""
        return _to_host(self._state["used"], self._state["npods"])


def make_batch_backend(kind: str = "tpu", caps: Caps | None = None,
                       batch_size: int = 256,
                       weights: dict[str, float] | None = None,
                       k_cap: int = 1024, device=None, **kw):
    """Construct a BatchBackend by kind — the seam the `backend:` config
    stanza (scheduler/config.BackendPolicy) and the perf harness resolve
    through, with the JAX package's vocabulary so one config file loads in
    both packages:

      tpu      the single-device resident step: TorchBatchBackend on
               `device` (CUDA unless the caller names another)
      sharded  the multi-device path: ShardedTorchBatchBackend
               (parallel/backend.py) on `mesh` (keyword), else on
               make_mesh(device, shards=`shards`): by default every
               visible CUDA device, one shard each
      null     the host pipeline with the device step nulled
               (ops/nullbackend.py, numpy only: the host-ceiling
               measurement; `device` does not apply).  Only a caller
               that names it gets it: no other kind falls back to it."""
    if kind == "tpu":
        return TorchBatchBackend(caps, batch_size=batch_size,
                                 weights=weights, k_cap=k_cap,
                                 device=device, **kw)
    if kind == "sharded":
        from ..parallel.backend import ShardedTorchBatchBackend
        from ..parallel.mesh import make_mesh
        mesh = kw.pop("mesh", None)
        shards = kw.pop("shards", None)
        if mesh is None:
            mesh = make_mesh(device, shards=shards)
        return ShardedTorchBatchBackend(caps, batch_size=batch_size,
                                        weights=weights, mesh=mesh,
                                        k_cap=k_cap, **kw)
    if kind == "null":
        from .nullbackend import NullBatchBackend
        return NullBatchBackend(caps or Caps(), batch_size=batch_size)
    raise ValueError(f"unknown batch backend kind {kind!r} "
                     "(expected tpu, sharded or null)")
