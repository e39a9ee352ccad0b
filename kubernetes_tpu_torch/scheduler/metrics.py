"""Scheduler metrics.

Reference: pkg/scheduler/metrics/metrics.go:30-200 — the full named metric
set, registered on the shared component-base registry with the same
stability levels and the same exponential latency buckets
(ExponentialBuckets(0.001, 2, 15), metrics.go:58-65).  The queue exposes
pending_pods{queue=active|backoff|unschedulable} and the framework runtime
records per-extension-point / per-plugin duration histograms.
"""

from __future__ import annotations

from ..component_base import metrics as cbm

SCHEDULER_SUBSYSTEM = "scheduler"

# SLO-boundary fix: the upstream exponential ladder straddles the paper's
# 10 ms target between 0.008 and 0.016, so "p99 < 10ms" could not be read
# off the histogram — the 0.010 boundary is inserted explicitly.
_LATENCY_BUCKETS = sorted(cbm.exponential_buckets(0.001, 2, 15) + [0.010])


class Metrics:
    """One bundle per scheduler process (tests get isolated registries)."""

    def __init__(self, registry: cbm.Registry | None = None):
        self.registry = registry or cbm.Registry()
        r = self.registry
        self.schedule_attempts = cbm.Counter(
            "scheduler_schedule_attempts_total",
            "Number of attempts to schedule pods, by result.",
            labels=("result", "profile"), stability=cbm.STABLE)
        self.scheduling_attempt_duration = cbm.Histogram(
            "scheduler_scheduling_attempt_duration_seconds",
            "Scheduling attempt latency (algorithm + binding).",
            labels=("result", "profile"), buckets=_LATENCY_BUCKETS,
            stability=cbm.STABLE)
        self.scheduling_algorithm_duration = cbm.Histogram(
            "scheduler_scheduling_algorithm_duration_seconds",
            "Scheduling algorithm latency.",
            labels=("profile",), buckets=_LATENCY_BUCKETS)
        self.pod_scheduling_duration = cbm.Histogram(
            "scheduler_pod_scheduling_duration_seconds",
            "E2e pod scheduling latency, from first attempt to bound.",
            labels=("attempts",),
            buckets=cbm.exponential_buckets(0.001, 2, 20),
            stability=cbm.STABLE)
        self.pod_scheduling_attempts = cbm.Histogram(
            "scheduler_pod_scheduling_attempts",
            "Number of attempts to successfully schedule a pod.",
            buckets=[1, 2, 4, 8, 16], stability=cbm.STABLE)
        self.framework_extension_point_duration = cbm.Histogram(
            "scheduler_framework_extension_point_duration_seconds",
            "Latency for running all plugins of an extension point.",
            labels=("extension_point", "status", "profile"),
            buckets=cbm.exponential_buckets(0.0001, 2, 12))
        self.plugin_execution_duration = cbm.Histogram(
            "scheduler_plugin_execution_duration_seconds",
            "Duration for running a plugin at a specific extension point.",
            labels=("plugin", "extension_point", "status"),
            buckets=cbm.exponential_buckets(0.00001, 1.5, 20))
        self.pending_pods = cbm.Gauge(
            "scheduler_pending_pods",
            "Pending pods by queue: active, backoff, unschedulable, gated.",
            labels=("queue",), stability=cbm.STABLE)
        self.queue_incoming_pods = cbm.Counter(
            "scheduler_queue_incoming_pods_total",
            "Pods added to scheduling queues by event and queue.",
            labels=("queue", "event"), stability=cbm.STABLE)
        self.preemption_attempts = cbm.Counter(
            "scheduler_preemption_attempts_total",
            "Total preemption attempts in the cluster.", stability=cbm.STABLE)
        self.preemption_victims = cbm.Histogram(
            "scheduler_preemption_victims",
            "Number of selected preemption victims.",
            buckets=cbm.linear_buckets(5, 5, 10), stability=cbm.STABLE)
        self.cache_size = cbm.Gauge(
            "scheduler_scheduler_cache_size",
            "Number of nodes, pods, and assumed pods in the cache.",
            labels=("type",))
        self.unschedulable_reasons = cbm.Gauge(
            "scheduler_unschedulable_pods",
            "Pods the scheduler found unschedulable, by plugin and profile.",
            labels=("plugin", "profile"))
        self.goroutines = cbm.Gauge(
            "scheduler_goroutines",
            "Number of running binding goroutines.", labels=("operation",))
        # TPU-path additions (no upstream analogue): batch shape + device time
        self.tpu_batch_size = cbm.Histogram(
            "scheduler_tpu_batch_size",
            "Pods per TPU assignment batch.",
            buckets=[1, 8, 32, 64, 128, 256, 512, 1024])
        self.tpu_device_duration = cbm.Histogram(
            "scheduler_tpu_device_duration_seconds",
            "Device time per TPU assignment batch.",
            buckets=_LATENCY_BUCKETS)
        # remote-seam resilience (ops/remote.py + ops/failover.py): the
        # scheduler loop pushes batch-failure events; the backend's own
        # cumulative counters (retries/resyncs/failovers) are snapshotted
        # into the _state gauge at expose time (Scheduler.expose_metrics)
        self.tpu_seam_events = cbm.Counter(
            "scheduler_tpu_seam_events_total",
            "Remote TPU seam events observed by the scheduling loop "
            "(batch_failures, requeued_pods).",
            labels=("event",))
        self.tpu_seam_state = cbm.Gauge(
            "scheduler_tpu_seam_state",
            "Cumulative remote-seam resilience counters (retries, resyncs, "
            "state_lost, failovers, recloses...), snapshotted from the "
            "batch backend at expose time.",
            labels=("counter",))
        self.tpu_seam_breaker = cbm.Gauge(
            "scheduler_tpu_seam_breaker_open",
            "Circuit-breaker state per backend rung (1 = open/failed over).",
            labels=("rung",))
        # batch-telemetry additions (observability PR): WHY pods leave the
        # device batch path, and how selective each batch was.  The escape
        # counter is drained from the backend's per-batch reason tallies in
        # _finish_batch (Counter is inc-only, so the scheduler applies
        # deltas, never snapshots).
        self.tpu_escape_total = cbm.Counter(
            "scheduler_tpu_escape_total",
            "Pods escaped from the TPU batch path to the per-pod oracle, "
            "by owning plugin and escape reason (e.g. namespace_selector).",
            labels=("plugin", "reason"))
        self.tpu_mask_density = cbm.Gauge(
            "scheduler_tpu_mask_density",
            "Fraction of batch pods carrying an active constraint mask for "
            "a plugin family, from the most recent dispatched batch.",
            labels=("plugin",))
        self.tpu_feasible_nodes = cbm.Histogram(
            "scheduler_tpu_feasible_nodes",
            "Schedulable node rows per dispatched batch (the device "
            "feasibility domain before per-pod filter masks).",
            buckets=cbm.exponential_buckets(1, 4, 10))
        self.tpu_batch_waves = cbm.Histogram(
            "scheduler_tpu_batch_waves",
            "Device assignment-solver waves per batch.",
            buckets=[1, 2, 4, 8, 16, 32, 64, 128, 256, 512])
        self.tpu_victim_occupancy = cbm.Gauge(
            "scheduler_tpu_victim_occupancy",
            "Fraction of per-node victim tensor slots (v_cap) holding a "
            "resident pod, from the most recent victim-tensor refresh.")
        # overload-protection additions (overload: stanza): bounded
        # admission sheds, escape-storm deferrals, watchdog cancels, and
        # the AIMD wave-size / breaker state gauges.  Shed tallies
        # accumulate inside the queue and are drained at expose time
        # (same drain discipline as the escape counter above).
        self.queue_shed_total = cbm.Counter(
            "scheduler_queue_shed_total",
            "Pods shed from activeQ to the backoff tier by bounded "
            "admission, by shed reason and pod priority band.",
            labels=("reason", "priority_band"))
        self.overload_deferred_total = cbm.Counter(
            "scheduler_overload_deferred_total",
            "Escaped pods deferred to the backoff tier by the open "
            "escape-storm breaker instead of the per-pod oracle, by "
            "dominant escape reason.",
            labels=("reason",))
        self.overload_wave_cancel_total = cbm.Counter(
            "scheduler_overload_wave_cancel_total",
            "Waves cancelled by the stuck-wave watchdog, by reason.",
            labels=("reason",))
        self.overload_wave_size = cbm.Gauge(
            "scheduler_overload_wave_size",
            "Current AIMD-controlled dispatch wave size.")
        self.overload_breaker_open = cbm.Gauge(
            "scheduler_overload_breaker_open",
            "Escape-storm breaker state (1 = open: escapes deferred).")
        # signal-driven engagement (overload: engagement): the hysteresis
        # state machine that decides WHEN the four layers above act.
        # Transitions are counted at the edge (scheduler loop thread is
        # the only writer); the gauge is refreshed at expose time.
        self.overload_engaged = cbm.Gauge(
            "scheduler_overload_engaged",
            "Overload engagement state (1 = engaged or cooling: the "
            "admission/AIMD/breaker/watchdog layers are active; 0 = "
            "disengaged or arming: quiescent).")
        self.overload_transition_total = cbm.Counter(
            "scheduler_overload_transition_total",
            "Engagement state-machine transitions, by from/to state and "
            "trigger reason (slo_burn, queue_growth, blip, calm, "
            "re_pressure, cooled, config).",
            labels=("from", "to", "reason"))
        # scale-out additions (scaleOut: stanza): optimistic-bind races
        # between cooperating scheduler instances, resolved at commit time
        # (Omega shared-state model).  The loser classifies each conflicted
        # pod into an outcome: requeued / lost_to_peer /
        # already_bound_same_node / fenced.
        self.bind_conflict_total = cbm.Counter(
            "scheduler_bind_conflict_total",
            "Pods whose bind was rejected because a peer scheduler "
            "instance claimed them first (or this instance lost its "
            "lease), by conflict outcome.",
            labels=("outcome",))
        self.informer_relist_total = cbm.Counter(
            "informer_relist_total",
            "Informer list/watch restarts, by resource and reason "
            "(too_old = watch window expired, error = list/watch failed).",
            labels=("resource", "reason"))
        # performance-observatory additions (profiling: stanza): the
        # device cost census commits the offline collective-census tool's
        # numbers as gauges (set once per census run, at warmup), the
        # host profiler drains per-stage host seconds at expose time
        # (inc-only deltas, same drain discipline as the escape counter),
        # and the SLO tracker publishes rolling-window latency quantiles
        # + multi-window burn rates — the arm/disarm signal for adaptive
        # overload engagement.
        self.tpu_wave_collective_bytes = cbm.Gauge(
            "tpu_wave_collective_bytes",
            "ICI-collective bytes PER WAVE in the compiled scheduling "
            "step (collectives inside the wave loop), by collective op "
            "and backend-variant — the runtime twin of "
            "tools/collective_census.py, bit-identical at equal shapes.",
            labels=("collective", "backend"))
        self.tpu_step_collective_bytes = cbm.Gauge(
            "tpu_step_collective_bytes",
            "ICI-collective bytes ONCE PER STEP in the compiled "
            "scheduling step (outside the wave loop), by collective op "
            "and backend-variant.",
            labels=("collective", "backend"))
        self.tpu_wave_flops = cbm.Gauge(
            "tpu_wave_flops",
            "XLA cost-analysis flops of one compiled scheduling step, "
            "by backend and kernel variant.",
            labels=("backend", "variant"))
        self.tpu_step_hbm_bytes = cbm.Gauge(
            "tpu_step_hbm_bytes",
            "XLA cost-analysis bytes accessed (HBM traffic proxy) of one "
            "compiled scheduling step, by backend and kernel variant.",
            labels=("backend", "variant"))
        self.host_stage_seconds = cbm.Counter(
            "scheduler_host_stage_seconds",
            "Sampled host CPU-attribution seconds per pipeline stage "
            "(informer, submitter, resolver, binder, queue...), drained "
            "from the sampling profiler at expose time.",
            labels=("stage",))
        self.slo_latency_ms = cbm.Gauge(
            "scheduler_slo_latency_ms",
            "Rolling-window submit-to-bind scheduling latency quantiles "
            "against the SLO target, in milliseconds.",
            labels=("quantile",))
        self.slo_burn_rate = cbm.Gauge(
            "scheduler_slo_burn_rate",
            "SLO error-budget burn rate per lookback window (1.0 = "
            "budget consumed exactly at the sustainable rate; the "
            "multi-window AND arms overload engagement).",
            labels=("window",))
        # incremental-flatten additions (tensor-maintenance PR): how each
        # dispatched wave synced the resident device tensors (patched in
        # place vs full re-flatten/refresh — the perf headline), plus the
        # row-slot allocator's occupancy/tombstone pressure, snapshotted
        # from the backend's maintenance counters at expose time (waves
        # are inc-only deltas, occupancy is a point-in-time gauge).
        self.tpu_tensor_waves = cbm.Counter(
            "scheduler_tpu_tensor_waves_total",
            "Dispatched device waves by tensor-maintenance mode: patched "
            "(targeted row patches / event patches / no-op) vs "
            "reflattened (full snapshot re-encode + state refresh).",
            labels=("mode",))
        self.tpu_tensor_occupancy = cbm.Gauge(
            "scheduler_tpu_tensor_occupancy",
            "Fraction of node-tensor row slots (n_cap) bound to a live "
            "node in the resident ClusterTensors row allocator.")
        self.tpu_tensor_tombstones = cbm.Gauge(
            "scheduler_tpu_tensor_tombstones",
            "Node-tensor row slots released by node deletion but not yet "
            "reclaimed by compaction (tombstoned rows).")
        # zero-downtime-operations additions: config hot-reload outcomes
        # (SIGHUP / supervisor RPC re-reading the dynamic stanzas; a
        # rejected reload keeps the old config live)
        self.config_reload_total = cbm.Counter(
            "scheduler_config_reload_total",
            "Config hot-reload attempts, by result (applied = dynamic "
            "stanzas installed, rejected = validation failed and the old "
            "config stayed live).",
            labels=("result",))
        # wave-timeline additions (profiling.timeline): interval-union
        # derived views of the pipeline — idle share and overlap are
        # point-in-time gauges recomputed from the interval ring at
        # expose time; the per-pod decomposition histogram is observed
        # at bind-commit (and therefore only when the timeline is on).
        self.wave_device_idle_share = cbm.Gauge(
            "scheduler_wave_device_idle_share",
            "Wall-clock fraction of the recent timeline window during "
            "which NO device stage (h2d/device-step/d2h) was in flight, "
            "computed by interval union over the stage-interval ring — "
            "correct under wave pipelining, unlike 1 - sum(stages)/wall.")
        self.stage_overlap_ratio = cbm.Gauge(
            "scheduler_stage_overlap_ratio",
            "Per pipeline stage: fraction of the stage's own busy time "
            "(interval union) during which at least one OTHER stage was "
            "also in flight. 0 = fully serial; pipelining drives the "
            "device stages toward 1.",
            labels=("stage",))
        self.pod_latency_ms = cbm.Histogram(
            "scheduler_pod_latency_ms",
            "Per-pod e2e latency decomposition in milliseconds, by "
            "telescoped segment (queue/form/device/resolve/bind/watch): "
            "segment boundaries are wave-timeline wall marks, so the "
            "segments of one pod sum to its e2e by construction.",
            labels=("segment",),
            buckets=cbm.exponential_buckets(0.25, 2, 16))
        r.must_register(
            self.schedule_attempts, self.scheduling_attempt_duration,
            self.scheduling_algorithm_duration, self.pod_scheduling_duration,
            self.pod_scheduling_attempts,
            self.framework_extension_point_duration,
            self.plugin_execution_duration, self.pending_pods,
            self.queue_incoming_pods, self.preemption_attempts,
            self.preemption_victims, self.cache_size,
            self.unschedulable_reasons, self.goroutines,
            self.tpu_batch_size, self.tpu_device_duration,
            self.tpu_seam_events, self.tpu_seam_state,
            self.tpu_seam_breaker, self.tpu_escape_total,
            self.tpu_mask_density, self.tpu_feasible_nodes,
            self.tpu_batch_waves, self.tpu_victim_occupancy,
            self.queue_shed_total, self.overload_deferred_total,
            self.overload_wave_cancel_total, self.overload_wave_size,
            self.overload_breaker_open, self.overload_engaged,
            self.overload_transition_total, self.bind_conflict_total,
            self.informer_relist_total, self.tpu_wave_collective_bytes,
            self.tpu_step_collective_bytes, self.tpu_wave_flops,
            self.tpu_step_hbm_bytes, self.host_stage_seconds,
            self.slo_latency_ms, self.slo_burn_rate,
            self.tpu_tensor_waves, self.tpu_tensor_occupancy,
            self.tpu_tensor_tombstones, self.config_reload_total,
            self.wave_device_idle_share, self.stage_overlap_ratio,
            self.pod_latency_ms)

    def expose(self) -> str:
        return self.registry.expose()
