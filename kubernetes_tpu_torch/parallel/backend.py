"""Sharded batch backend: the scheduler's device path over a mesh of node
shards.

Counterpart of kubernetes_tpu/parallel/backend.py's ShardedTPUBatchBackend.
The node axis shards across the mesh (parallel/mesh.py, one controller
driving every shard), the pod batch and the domain-count tables live on
the mesh's first device, and a batch runs one sharded step (the plain
variant, claims kernel per shard, or the full one).

The transport is the single-device backend's (ops/backend.py): node
DYNAMICS (used/npods/ports/domain counts) live resident on the shards and
chain batch to batch; a host mirror replays the step's commit rules;
external changes ride the bounded row patch of the packed upload, whose
global rows each shard applies to its own slab; statics re-upload on
static_version changes (the selector-side ones only once the full variant
has run).  supports_pipelining is True under the same FLUSH_FIRST
protocol, the same generation fence and the same epoch skip.  The wave
timeline records patch, h2d, device-step and d2h as the single-device
backend does (ops/backend.py _WaveClock, on CUDA events).

Like the JAX class it has no preempt_batch: preemption takes the
scheduler's legacy tier on this backend.
"""

from __future__ import annotations

import logging
import threading
from typing import Sequence

import numpy as np
import torch

from ..component_base.timeline import default_timeline
from ..models.assign import (
    ALL_FEATURES, DYN_STATE, PLAIN_FEATURES, _Comm, pack_pod_batch,
)
from ..models.carry import STATIC_CORE, STATIC_SEL
from ..ops.backend import (
    FLUSH_FIRST, ResidentHostMirror, TorchBatchBackend, _Result, _WaveClock,
    census_run, clone_state, decode_results, record_batch_stats,
)
from ..ops.flatten import BatchEncoder, Caps, ClusterTensors, VocabFullError
from ..scheduler.batch_backend import BatchBackend
from ..scheduler.cache import Snapshot
from ..scheduler.types import SKIP, PodInfo, Status
from .mesh import Mesh, ShardedStep, make_mesh, split_arrays

logger = logging.getLogger(__name__)


class ShardedTorchBatchBackend(ResidentHostMirror, BatchBackend):
    """The sharded step behind the BatchBackend contract, on `mesh`
    (default: every visible CUDA device, one shard each).  The plain main
    phase takes the murmur noise, the sharded rule (quirk R3), so on one
    shard it places exactly as TorchBatchBackend(claims_noise="murmur")
    with the full variant at batch_size."""

    # resident device-state chaining: batch k+1 may dispatch while k is in
    # flight, as long as no refresh or static change is needed
    supports_pipelining = True
    census_kind = "sharded"
    lineage = "sharded"

    def __init__(self, caps: Caps | None = None, batch_size: int = 256,
                 weights: dict[str, float] | None = None,
                 mesh: Mesh | None = None, k_cap: int = 1024):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.device = self.mesh.home
        self.caps = caps or Caps()
        n_dev = self.mesh.size
        if self.caps.n_cap % n_dev != 0:
            # the shards need an even node split; round up instead of
            # making operators do mesh math (100k nodes on any mesh just
            # works, at the cost of a few padding rows)
            from .census import round_caps_to_mesh
            n_was = self.caps.n_cap
            round_caps_to_mesh(self.caps, n_dev)
            logger.warning(
                "n_cap %d not divisible by %d devices; rounded up to %d "
                "(%.2f%% padding overhead)", n_was, n_dev, self.caps.n_cap,
                100.0 * (self.caps.n_cap - n_was) / n_was)
        self.batch_size = batch_size
        self.tensors = ClusterTensors(self.caps)
        self.encoder = BatchEncoder(self.tensors, batch_size)
        self._weights = weights
        self._k_cap = k_cap
        self._f_patch = 2 * self.caps.r + 1 + self.caps.pt_cap
        # one comm for both variants: the census reads its counts
        self.comm = _Comm(self.mesh.devices)
        self._fn = None        # the full variant (built in warmup)
        self._fn_plain = None  # lazily built; most batches are plain
        self._lock = threading.Lock()
        self._state = None          # STATE_KEYS: per-shard lists + home
        self._static_node = None    # STATIC_CORE, per-shard lists
        self._static_sel = None     # STATIC_SEL (lazy: the full variant)
        self._static_version = -1
        self._mirror: dict[str, np.ndarray] | None = None
        self._unresolved: list[object] = []
        self._carry_dirty: set[int] = set()
        self._last_epoch: int | None = None  # see ops/backend.py epoch skip
        # host expectation of the device state-generation counter (the
        # resolve fence — see ops/backend.py)
        self._gen = 0
        # steady-state pipeline fence (see ops/backend.py): >0 while a
        # fenced wave — dispatched with its patches deliberately held
        # back in the mirror — has not yet resolved and replayed
        self._fence_pending = 0
        # what warm_start resets (the victim channel stays absent here)
        self._static_vict = None
        self._vict_version = -1
        self._vict_live_cap = 0
        self._stage_pins: set[int] = set()
        self._clock_anchor = None
        self._stepped: set[str] = set()
        self.stats = {"batches": 0, "waves": 0, "full_refresh": 0,
                      "patched_rows": 0, "flush_first": 0,
                      "waves_patched": 0, "waves_reflattened": 0,
                      "event_patches": 0, "patch_seconds": 0.0,
                      "flatten_seconds": 0.0}

    # the single-device backend's namespace feed and clock, unchanged
    note_namespace_event = TorchBatchBackend.note_namespace_event
    _tracked_sync = TorchBatchBackend._tracked_sync
    _anchor_clock = TorchBatchBackend._anchor_clock
    _event_clock = TorchBatchBackend._event_clock

    # -- device sync -----------------------------------------------------

    def _ensure_full(self) -> ShardedStep:
        if self._fn is None:
            self._fn = ShardedStep(self.caps, self.mesh, self.batch_size,
                                   self._k_cap, self._weights, ALL_FEATURES,
                                   comm=self.comm)
        return self._fn

    def _ensure_plain(self) -> ShardedStep:
        if self._fn_plain is None:
            self._fn_plain = ShardedStep(
                self.caps, self.mesh, self.batch_size, self._k_cap,
                self._weights, PLAIN_FEATURES, comm=self.comm)
        return self._fn_plain

    def warmup(self) -> None:
        """Build the kernels and both step variants, upload the static
        arrays and the resident state, and run an all-invalid batch
        through each variant before the first real batch (an all-invalid
        batch leaves the resident state unchanged)."""
        with self._lock:
            if self._static_node is None:
                self._upload_static()
            if self._state is None:
                cd_sg, cd_asg = self.tensors.domain_base_counts()
                self._full_refresh(cd_sg, cd_asg)
            if self.device.type == "cuda":
                from ..ops import _build, kernels
                _build.build()         # every csrc/*.cu, one nvcc each
                kernels._kernel_lib()  # load csrc/claims.cu
            batch = self.encoder.encode([])
            for variant in ("full", "plain"):
                self._device_step(variant, self._pack(batch, variant)).get()
            if self.device.type == "cuda" and default_timeline.enabled:
                self._anchor_clock()

    def _pack(self, batch, variant: str, prows=None, pvals=None):
        """The batch's wire buffer for `variant`, in pinned host memory on
        CUDA (kept by the wave for a fenced re-run)."""
        fn = self._ensure_full() if variant == "full" else self._ensure_plain()
        host = torch.empty(fn.spec.total, dtype=torch.float32,
                           pin_memory=self.device.type == "cuda")
        pack_pod_batch(batch, fn.spec, prows, pvals, out=host.numpy())
        return host

    def _upload_static(self) -> None:
        """Sync the shards' static node arrays with the host tensors: a
        full upload of STATIC_CORE, and of STATIC_SEL when resident (the
        full variant's first step uploads it, _device_step)."""
        t = self.tensors
        self._static_node = split_arrays({k: getattr(t, k)
                                         for k in STATIC_CORE}, self.mesh)
        if self._static_sel is not None:
            self._static_sel = split_arrays({k: getattr(t, k)
                                            for k in STATIC_SEL}, self.mesh)
        t.static_dirty_rows = set()  # full upload covers them
        t.static_full = False
        self._static_version = t.static_version

    def _full_refresh(self, cd_sg: np.ndarray, cd_asg: np.ndarray) -> None:
        t = self.tensors
        self._state = split_arrays({
            "used": t.used, "used_nz": t.used_nz, "npods": t.npods,
            "port_mask": t.port_mask, "cd_sg": cd_sg, "cd_asg": cd_asg,
            "gen": np.int32(self._gen)}, self.mesh)
        self._mirror_from_tensors(cd_sg, cd_asg)
        self.stats["full_refresh"] += 1

    def _restore_state_from_mirror(self) -> None:
        """Gen-stale recovery (see ops/backend.py): re-seed the shards'
        state from the host mirror on a fresh generation lineage."""
        self._gen += 1
        m = self._mirror
        self._state = split_arrays({**{k: m[k] for k in DYN_STATE + (
            "cd_sg", "cd_asg")}, "gen": np.int32(self._gen)}, self.mesh)
        self.stats["gen_recoveries"] = self.stats.get(
            "gen_recoveries", 0) + 1

    def _variant(self, variant: str) -> tuple:
        """The `variant` step and the static arrays it reads; the
        selector-side ones upload at the full variant's first step."""
        if variant == "plain":
            return self._ensure_plain(), self._static_node
        if self._static_sel is None:
            self._static_sel = split_arrays(
                {k: getattr(self.tensors, k) for k in STATIC_SEL}, self.mesh)
        return self._ensure_full(), {**self._static_node, **self._static_sel}

    def _device_step(self, variant: str, host, clock=None) -> _Result:
        """Upload one packed batch and run the `variant` step on the
        resident shards; returns the result vector's handle."""
        fn, static = self._variant(variant)
        buf = host.to(self.device, non_blocking=True)
        rd = fn.run(self._state, static, buf)
        self._stepped.add(variant)
        self._gen += 1  # the step computes the identical state.gen + 1
        res = _Result(rd, self.device, timed=clock is not None)
        if clock is not None:
            clock.results.append(res)
        return res

    # -- device census ---------------------------------------------------

    def device_census(self, variants: tuple = ("full", "plain")) -> dict:
        """Cost census of the sharded step variants (as
        TorchBatchBackend.device_census: one step of each on a clone of
        the resident state, every slot valid, each pod requesting the
        census request, at parallel/census.step_shapes, which the clone
        must match), plus the comm's collective bytes by kind, per wave
        and per call (census.collective_record: the counts of the
        measured step, which resets them as it starts).  Leaves the
        state, `_gen`, the mirror and kernels.LAUNCHES as they were."""
        import dataclasses

        from .census import collective_record, step_shapes
        names = [v for v in ("full", "plain") if v in variants]
        shapes = step_shapes(self.caps, self.mesh.size, self.batch_size,
                             self._k_cap)
        out = {}
        with self._lock:
            if self._state is None:
                cd_sg, cd_asg = self.tensors.domain_base_counts()
                self._full_refresh(cd_sg, cd_asg)
            req = self._census_req()
            batch = self.encoder.encode([])
            batch = dataclasses.replace(
                batch, req=np.tile(req, (self.batch_size, 1)),
                req_nz=np.tile(req, (self.batch_size, 1)),
                p_valid=np.ones(self.batch_size, bool))
            plans = []
            for v in names:
                host = self._pack(batch, v)
                fn, static = self._variant(v)
                state = clone_state(self._state)
                got = {k: tuple((a[0] if isinstance(a, list) else a).shape)
                       for k, a in {**state, **static}.items()}
                want = {**shapes["state"], **{k: shapes["static"][k]
                                              for k in static}}
                if got != want or host.shape != shapes["buf"][v]:
                    raise RuntimeError(f"census: the {v} step's inputs "
                                       f"{got} are not the census shapes "
                                       f"{want}")
                # sync-point: the census batch's upload
                plans.append((v, fn, state, static, host.to(self.device)))

        def measured(fn):
            def step(state, static, buf):
                self.comm.reset_counts()
                return state, fn.run(state, static, buf)
            return step
        for v, fn, state, static, buf in plans:
            out[v] = census_run(self.device, self._stepped, v, measured(fn),
                                state, static, buf, self.batch_size, req)
            out[v].update(collective_record(self.comm.counts,
                                            out[v]["waves"]))
            out[v]["mesh_devices"] = self.mesh.size
            out[v]["n_cap"] = self.caps.n_cap
        return out

    # -- BatchBackend ----------------------------------------------------

    def dispatch(self, pod_infos: Sequence[PodInfo], snapshot: Snapshot):
        """Host prep + sharded dispatch: returns resolve() -> results, or
        the FLUSH_FIRST sentinel, under ops/backend.py's admission rules
        (a clean batch pipelines, a patched one rides fenced, a refresh or
        static change flushes first)."""
        with self._lock:
            if self._warm_pending:
                self._warm_sweep(snapshot)
            # epoch fast path (see ops/backend.py dispatch): unchanged
            # cache epoch == all changes since last sync were our own
            # replayed binds — skip the O(nodes) re-encode + diff
            epoch_fn = getattr(snapshot, "epoch", None)
            epoch = epoch_fn() if epoch_fn is not None else None
            skip_sync = (epoch is not None and self._state is not None
                         and epoch == self._last_epoch
                         and not self._carry_dirty)
            try:
                if skip_sync:
                    dirty = set()
                else:
                    dirty = self._tracked_sync(snapshot) | self._carry_dirty
                    self._last_epoch = epoch
                batch = self.encoder.encode(list(pod_infos))
                if (skip_sync and self._static_version
                        != self.tensors.static_version):
                    # a selector group registered by the encode: sync
                    # before the domain counts are compared (ops/backend.py
                    # dispatch, quirk R9)
                    dirty = self._tracked_sync(snapshot)
                    skip_sync = False
            except VocabFullError as e:
                logger.warning("tensorization overflow (%s); batch -> "
                               "oracle path", e)
                self._state = None
                self._carry_dirty = set()
                results = [(None, Status(SKIP, str(e)))] * len(pod_infos)
                return lambda: results

            inflight = bool(self._unresolved)
            # deterministic compaction point (see ops/backend.py)
            if (self.tensors.tombstone_count() * self.COMPACT_TOMBSTONE_DIV
                    >= self.caps.n_cap):
                if inflight:
                    self._carry_dirty = dirty
                    self.stats["flush_first"] += 1
                    return FLUSH_FIRST
                if self.tensors.compact():
                    self.stats["compactions"] = self.stats.get(
                        "compactions", 0) + 1
            static_changed = (self._static_version
                              != self.tensors.static_version)
            empty = (np.empty(0, np.int32),
                     np.empty((0, self._f_patch), np.float32))
            if skip_sync and not static_changed:
                patches = empty
                needs_refresh = needs_patch = False
            else:
                cd_sg, cd_asg = self.tensors.domain_base_counts()
                patches = None
                if self._state is not None and self._mirror is not None:
                    if (np.array_equal(cd_sg, self._mirror["cd_sg"])
                            and np.array_equal(cd_asg, self._mirror["cd_asg"])):
                        patches = self._diff_patches(sorted(dirty))
                needs_refresh = self._state is None or patches is None
                needs_patch = patches is not None and len(patches[0]) > 0
            # pipeline admission (see ops/backend.py)
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
                patches = empty
            elif needs_patch:
                self._sync_mirror_rows(patches[0])
            self.stats["patched_rows"] += len(patches[0])
            if will_fence:
                # the patch VALUES travel via the mirror rows just synced,
                # never via the retained upload (see ops/backend.py)
                patches = empty
                self._gen += 1  # guarantee this wave's fence trips
                self._fence_pending += 1
                self.stats["fenced_waves"] = self.stats.get(
                    "fenced_waves", 0) + 1
            self.stats["waves_reflattened" if needs_refresh
                       else "waves_patched"] += 1
            self._carry_dirty = set()
            self.stats["epoch_skips"] = self.stats.get("epoch_skips", 0) + (
                1 if skip_sync else 0)

            # a no-fit verdict on a collided selector bucket is re-proved
            # pod by pod, but only where a node exists (ops/backend.py)
            nofit = (set(batch.nofit_oracle) if self.tensors.valid.any()
                     else set())
            variant = "full" if self._needs_full(batch) else "plain"
            if variant == "plain":
                self.stats["plain"] = self.stats.get("plain", 0) + 1
            clock = _WaveClock(self) if default_timeline.enabled else None
            host = self._pack(batch, variant, *patches)
            if clock is not None:
                clock.launch()
            pending = self._device_step(variant, host, clock)
            expect_gen = self._gen
            self.stats["batches"] += 1
            holder = object()
            self._unresolved.append(holder)
            # names, not NodeInfos: live NodeInfos can have .node nulled
            # in place mid-wave (cache drain of a node still holding pods)
            row_names = list(self.tensors.row_names)  # view at dispatch

        n = len(pod_infos)

        def resolve():
            nonlocal will_fence
            try:
                with self._lock:
                    if clock is not None:
                        clock.pull()
                    result = pending.get()
                    if int(result[-1]) != expect_gen or will_fence:
                        # generation fence tripped: re-seed the shards from
                        # the mirror and replay the batch on the fresh
                        # lineage; for a fenced wave this IS the steady-
                        # state discipline, not an anomaly
                        if will_fence:
                            self.stats["fence_replays"] = self.stats.get(
                                "fence_replays", 0) + 1
                        else:
                            logger.warning(
                                "sharded state generation mismatch "
                                "(device %d, expected %d); re-seeding "
                                "from host mirror", int(result[-1]),
                                expect_gen)
                            self.stats["gen_stale_waves"] = (
                                self.stats.get("gen_stale_waves", 0) + 1)
                        self._restore_state_from_mirror()
                        result = self._device_step(variant, host,
                                                   clock).get()
                    if clock is not None:
                        clock.record()
                    assignments = result[:-2]
                    self.stats["waves"] += int(result[-2])
                    self._replay(batch, assignments)
                    try:
                        self._unresolved.remove(holder)
                    except ValueError:  # pragma: no cover - double resolve
                        pass
            finally:
                # the fence slot frees even on a failed resolve, or every
                # future patch dispatch wedges behind FLUSH_FIRST
                if will_fence:
                    self._fence_pending = max(0, self._fence_pending - 1)
                    will_fence = False
            out = decode_results(
                assignments, n, self.batch_size, set(batch.escape),
                row_names, "no feasible node (sharded batch filter)",
                nofit_escapes=nofit)
            record_batch_stats(self.stats, self._lock, out, n)
            return out

        return resolve

    def abandon_wave(self) -> None:
        """Stuck-wave watchdog cancel (see ops/backend.py abandon_wave:
        same best-effort lock and the same safety argument).  Drops the
        pipeline bookkeeping, the resident sharded state, and any
        pending fence; the next dispatch full-refreshes from the
        authoritative cache view."""
        got = self._lock.acquire(timeout=0.1)
        try:
            self._unresolved.clear()
            self._state = None
            self._last_epoch = None
            self._fence_pending = 0
            self.stats["abandoned_waves"] = (
                self.stats.get("abandoned_waves", 0) + 1)
        finally:
            if got:
                self._lock.release()

    def assign(self, pod_infos: Sequence[PodInfo], snapshot: Snapshot):
        resolve = self.dispatch(pod_infos, snapshot)
        if resolve is FLUSH_FIRST:  # pragma: no cover - sync caller
            raise RuntimeError("FLUSH_FIRST with no pipelined caller")
        return resolve()
