"""KubeSchedulerConfiguration — the scheduler's component config.

Reference: pkg/scheduler/apis/config/ (types.go:41 KubeSchedulerConfiguration,
types.go:100+ KubeSchedulerProfile/Plugins/PluginSet, types_pluginargs.go)
and apis/config/v1/default_plugins.go:28 (the single MultiPoint default
list + the enabled/disabled merge rules).  Shape accepted (JSON, YAML or
dict; JSON needs no PyYAML):

  apiVersion: kubescheduler.config.k8s.io/v1
  kind: KubeSchedulerConfiguration
  parallelism: 16
  percentageOfNodesToScore: 0
  podInitialBackoffSeconds: 1
  podMaxBackoffSeconds: 10
  profiles:
    - schedulerName: default-scheduler
      percentageOfNodesToScore: 0
      plugins:
        multiPoint:
          enabled: [{name: Coscheduling}]
          disabled: [{name: ImageLocality}]     # or [{name: "*"}]
        score:
          disabled: [{name: NodeResourcesFit}]  # point-scoped disable
          enabled: [{name: TaintToleration, weight: 3}]
      pluginConfig:
        - name: NodeResourcesFit
          args: {strategy: MostAllocated}
  extenders:
    - urlPrefix: http://127.0.0.1:9000
      filterVerb: filter
      weight: 2
  remoteSeam:                # deadlines/retries for the TPU worker seam
    stepTimeoutSeconds: 30   # (ops/remote.py; no upstream analogue)
    maxRetries: 3
    failureThreshold: 3
    probeIntervalSeconds: 5
  tracing:                       # batch-pipeline span sampling
    samplingRatePerMillion: 10000  # (component_base/tracing.py; mirrors
    maxSpans: 4096                 #  apiserver TracingConfiguration's
    maxTraces: 256                 #  samplingRatePerMillion field)
  overload:                   # closed-loop overload protection (no upstream
    queueCap: 16384           #  analogue; see OverloadPolicy below)
    sloP99Ms: 250
    escapeRateThreshold: 0.5
    waveDeadlineSeconds: 30
  scaleOut:                   # N cooperating instances over one store
    instanceCount: 4          #  (Omega-style optimistic binding; see
    instanceIndex: 1          #  ScaleOutPolicy / scheduler/scaleout.py)
    partitionBy: nodePoolRing # or namespaceHash
    leaseDurationSeconds: 2

Merge semantics (default_plugins.go mergePlugins):
  1. start from the default MultiPoint list;
  2. multiPoint.disabled removes names ("*" clears the list);
  3. multiPoint.enabled appends (weight applies to Score);
  4. each point's .disabled masks that point only ("*" masks every default);
  5. each point's .enabled appends plugins to that point only.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any

from .extender import build_extenders
from .framework import Framework, Handle
from .plugins import (
    DEFAULT_PLUGINS, DEFAULT_SCORE_WEIGHTS, build_default_plugins,
    in_tree_registry,
)

EXTENSION_POINTS = ("queueSort", "preFilter", "filter", "postFilter",
                    "preScore", "score", "reserve", "permit", "preBind",
                    "bind", "postBind")


class ConfigError(ValueError):
    pass


@dataclass
class ProfileConfig:
    scheduler_name: str = "default-scheduler"
    percentage_of_nodes_to_score: int = 0
    plugins: dict[str, Any] = field(default_factory=dict)
    plugin_config: dict[str, dict] = field(default_factory=dict)


@dataclass
class RemoteSeamPolicy:
    """Deadline/retry/failover policy for the remote TPU worker seam
    (ops/remote.py RemoteTPUBatchBackend, ops/failover.py ladder).

    Configured via the `remoteSeam:` stanza (see load_config); defaults
    reproduce the historical single 120s deadline but add bounded retries.
    Deadlines are per verb: /init covers kernel compilation, /step covers
    one device round trip, /health is a liveness probe and must stay
    small so an open circuit breaker probes cheaply."""

    init_timeout: float = 120.0     # includes worker-side XLA compile
    static_timeout: float = 120.0
    refresh_timeout: float = 120.0
    step_timeout: float = 120.0
    health_timeout: float = 5.0
    max_retries: int = 3            # per logical post, transient errors only
    retry_base: float = 0.05        # exponential backoff: base * 2^(n-1)
    retry_max: float = 2.0
    retry_jitter: float = 0.5       # +/- fraction of the backoff, seeded rng
    resync_attempts: int = 3        # state-lost recoveries per logical post
    failure_threshold: int = 3      # K consecutive failures open the breaker
    probe_interval: float = 5.0     # seconds between half-open health probes
    journal_cap: int = 512          # replayable steps between checkpoints

    def timeout_for(self, verb: str) -> float:
        if verb.startswith("/step"):
            return self.step_timeout
        return {"/init": self.init_timeout, "/static": self.static_timeout,
                "/refresh": self.refresh_timeout,
                "/health": self.health_timeout}.get(verb, self.step_timeout)

    def backoff(self, attempt: int, rng) -> float:
        """Delay before retry `attempt` (1-based): exponential, capped,
        jittered from the caller's seeded rng (deterministic in tests,
        decorrelated across clients in production)."""
        d = min(self.retry_max, self.retry_base * (2 ** max(0, attempt - 1)))
        if self.retry_jitter > 0.0:
            d *= 1.0 - self.retry_jitter / 2.0 + self.retry_jitter * rng.random()
        return d


# remoteSeam YAML key -> RemoteSeamPolicy field
_SEAM_FIELDS = {
    "initTimeoutSeconds": "init_timeout",
    "staticTimeoutSeconds": "static_timeout",
    "refreshTimeoutSeconds": "refresh_timeout",
    "stepTimeoutSeconds": "step_timeout",
    "healthTimeoutSeconds": "health_timeout",
    "maxRetries": "max_retries",
    "retryBaseSeconds": "retry_base",
    "retryMaxSeconds": "retry_max",
    "retryJitter": "retry_jitter",
    "resyncAttempts": "resync_attempts",
    "failureThreshold": "failure_threshold",
    "probeIntervalSeconds": "probe_interval",
    "journalCap": "journal_cap",
}


def _parse_remote_seam(data: dict) -> RemoteSeamPolicy:
    kwargs = {}
    for key, value in (data or {}).items():
        if key not in _SEAM_FIELDS:
            raise ConfigError(f"unknown remoteSeam key {key!r}")
        kwargs[_SEAM_FIELDS[key]] = value
    policy = RemoteSeamPolicy(**kwargs)
    for f in ("init_timeout", "static_timeout", "refresh_timeout",
              "step_timeout", "health_timeout", "retry_base", "retry_max",
              "probe_interval"):
        if getattr(policy, f) <= 0:
            raise ConfigError(f"remoteSeam {f} must be positive")
    if policy.max_retries < 0 or policy.resync_attempts < 0:
        raise ConfigError("remoteSeam retry counts must be >= 0")
    if policy.failure_threshold < 1:
        raise ConfigError("remoteSeam failureThreshold must be >= 1")
    if not 0.0 <= policy.retry_jitter <= 1.0:
        raise ConfigError("remoteSeam retryJitter must be in [0,1]")
    if policy.journal_cap < 1:
        raise ConfigError("remoteSeam journalCap must be >= 1")
    return policy


@dataclass
class BackendPolicy:
    """Device batch-backend selection (`backend:` stanza).

    kind picks the BatchBackend implementation the harness constructs
    (ops/backend.make_batch_backend): "tpu" is the single-chip resident
    kernel, "sharded" the mesh-partitioned shard_map path
    (parallel/backend.py — node tensors live sharded, conflict matrices
    resolve via reduce-scatter), "null" the host-only pipeline with the
    device step nulled.  batchSize/kCap 0 mean "harness default" so the
    stanza can pin just the kind.

    pipeline_depth (the nested `pipeline: {depth: N}` sub-stanza) sets
    how many waves may be in flight at once: 2 (the default) overlaps
    wave N's resolve/bind with wave N+1's device step; 1 is the strictly
    serial arm kept as the bit-parity A/B baseline.  Hot-reloadable via
    SIGHUP — lowering the depth drains excess in-flight waves on the
    next cycle rather than cancelling them."""

    kind: str = "tpu"
    batch_size: int = 0
    k_cap: int = 0
    pipeline_depth: int = 2

    @property
    def selected(self) -> bool:
        return self.kind != "tpu" or bool(self.batch_size or self.k_cap)


# backend YAML key -> BackendPolicy field
_BACKEND_FIELDS = {
    "kind": "kind",
    "batchSize": "batch_size",
    "kCap": "k_cap",
}

BACKEND_KINDS = ("tpu", "sharded", "null")


def _parse_backend(data: dict) -> BackendPolicy:
    kwargs = {}
    for key, value in (data or {}).items():
        if key == "pipeline":
            if not isinstance(value, dict):
                raise ConfigError("backend pipeline must be a mapping")
            for pk, pv in value.items():
                if pk != "depth":
                    raise ConfigError(f"unknown backend pipeline key {pk!r}")
                if pv not in (1, 2):
                    raise ConfigError(
                        f"backend pipeline depth must be 1 or 2; got {pv!r}")
                kwargs["pipeline_depth"] = pv
            continue
        if key not in _BACKEND_FIELDS:
            raise ConfigError(f"unknown backend key {key!r}")
        kwargs[_BACKEND_FIELDS[key]] = value
    policy = BackendPolicy(**kwargs)
    if policy.kind not in BACKEND_KINDS:
        raise ConfigError(
            f"backend kind must be one of {', '.join(BACKEND_KINDS)}; "
            f"got {policy.kind!r}")
    if policy.batch_size < 0 or policy.k_cap < 0:
        raise ConfigError("backend batchSize/kCap must be >= 0")
    return policy


@dataclass
class TracingPolicy:
    """Batch-pipeline trace sampling (component_base/tracing.py).

    Configured via the `tracing:` stanza; the field name mirrors the
    upstream apiserver TracingConfiguration (samplingRatePerMillion).
    Rate 0 (the default) disables tracing entirely — the scheduler never
    attaches a tracer, so the hot path pays nothing."""

    sampling_rate_per_million: int = 0
    max_spans: int = 4096       # flight-recorder span ring bound
    max_traces: int = 256       # /debug/traces trace ring bound

    @property
    def enabled(self) -> bool:
        return self.sampling_rate_per_million > 0


# tracing YAML key -> TracingPolicy field
_TRACING_FIELDS = {
    "samplingRatePerMillion": "sampling_rate_per_million",
    "maxSpans": "max_spans",
    "maxTraces": "max_traces",
}


def _parse_tracing(data: dict) -> TracingPolicy:
    kwargs = {}
    for key, value in (data or {}).items():
        if key not in _TRACING_FIELDS:
            raise ConfigError(f"unknown tracing key {key!r}")
        kwargs[_TRACING_FIELDS[key]] = value
    policy = TracingPolicy(**kwargs)
    if not 0 <= policy.sampling_rate_per_million <= 1_000_000:
        raise ConfigError(
            "tracing samplingRatePerMillion must be in [0, 1000000]")
    if policy.max_spans < 1 or policy.max_traces < 1:
        raise ConfigError("tracing ring bounds must be >= 1")
    return policy


@dataclass
class ProfilingPolicy:
    """Continuous performance observatory (component_base/profiling.py).

    Configured via the `profiling:` stanza; everything defaults OFF so
    an unconfigured scheduler attaches no sampler thread, runs no
    census compile, and pays nothing on the hot path.

      enabled          master switch: starts the process-wide sampling
                       host profiler (sys._current_frames() at
                       1000/sampleIntervalMs Hz) behind /debug/profile
                       and feeds scheduler_host_stage_seconds{stage}.
      census           device cost census: at warmup the backend lowers
                       its compiled step variants and exports
                       tpu_wave_collective_bytes / tpu_wave_flops /
                       tpu_step_hbm_bytes gauges (costs one extra AOT
                       compile per variant, off the hot path).
      sloTargetMs      rolling-window scheduling-latency SLO target fed
                       by submit->bind latencies; p50/p95/p99 and
                       multi-window burn rates export as
                       scheduler_slo_latency_ms / scheduler_slo_burn_rate
                       (the arm/disarm signal for adaptive overload
                       engagement).
      timeline         wave timeline (component_base/timeline.py): every
                       pipeline stage records bounded (wave, stage,
                       start, end, thread) intervals, deriving
                       scheduler_wave_device_idle_share (interval
                       union), per-stage overlap ratios, the per-pod
                       scheduler_pod_latency_ms{segment} decomposition
                       and /debug/timeline (JSON + Chrome trace).
      timelineRing     bounded interval-ring capacity per process."""

    enabled: bool = False
    census: bool = False
    sample_interval_ms: float = 5.0
    max_stacks: int = 512
    slo_target_ms: float = 10.0
    slo_objective: float = 0.99
    burn_windows_s: tuple = (60.0, 300.0, 3600.0)
    timeline: bool = False
    timeline_ring: int = 4096


# profiling YAML key -> ProfilingPolicy field
_PROFILING_FIELDS = {
    "enabled": "enabled",
    "census": "census",
    "sampleIntervalMs": "sample_interval_ms",
    "maxStacks": "max_stacks",
    "sloTargetMs": "slo_target_ms",
    "sloObjective": "slo_objective",
    "burnWindowsSeconds": "burn_windows_s",
    "timeline": "timeline",
    "timelineRing": "timeline_ring",
}


def _parse_profiling(data: dict) -> ProfilingPolicy:
    kwargs = {}
    for key, value in (data or {}).items():
        if key not in _PROFILING_FIELDS:
            raise ConfigError(f"unknown profiling key {key!r}")
        kwargs[_PROFILING_FIELDS[key]] = value
    if "burn_windows_s" in kwargs:
        kwargs["burn_windows_s"] = tuple(
            float(w) for w in kwargs["burn_windows_s"])
    policy = ProfilingPolicy(**kwargs)
    if policy.sample_interval_ms <= 0:
        raise ConfigError("profiling sampleIntervalMs must be positive")
    if policy.max_stacks < 1:
        raise ConfigError("profiling maxStacks must be >= 1")
    if policy.slo_target_ms <= 0:
        raise ConfigError("profiling sloTargetMs must be positive")
    if not 0.0 < policy.slo_objective < 1.0:
        raise ConfigError("profiling sloObjective must be in (0,1)")
    if not policy.burn_windows_s or any(w <= 0
                                        for w in policy.burn_windows_s):
        raise ConfigError("profiling burnWindowsSeconds must be positive")
    if policy.timeline_ring < 1:
        raise ConfigError("profiling timelineRing must be >= 1")
    return policy


@dataclass
class OverloadPolicy:
    """Closed-loop overload protection for the batch pipeline.

    Configured via the `overload:` stanza and ON BY DEFAULT since the
    signal-driven engagement controller landed: an unconfigured
    scheduler carries protective defaults for every layer, but the
    layers only ACT while the engagement state machine (`engagement:
    auto`, scheduler._EngagementController) is engaged — armed by the
    SLO burn-rate breach signal with queue-depth growth as the
    secondary trigger, released with dwell-time hysteresis.  A healthy
    box therefore pays a few branch checks per wave, not the ~3x
    throughput cost the always-on policy used to charge.
    `engagement: always` restores the legacy behavior (every layer
    active whenever its knob is non-zero); `engagement: off` disables
    the stanza entirely.  Four independent layers (in the spirit of
    Borg's overload-tolerant admission and the stability patterns in
    ops/failover.py):

      queue_cap        bounded admission — activeQ depth cap; excess pods
                       are shed lowest-priority-first (youngest first
                       within a priority) into the backoff tier, never
                       dropped.  Pods at/above shed_protect_priority and
                       pods older than shed_protect_age are never shed,
                       so the cap is soft with respect to protected pods
                       and every pod is eventually admitted.
      slo_p99_ms       adaptive wave sizing — AIMD control of the dispatch
                       batch size against this per-wave latency SLO:
                       multiplicative decrease on breach, additive
                       increase while under it and backlogged.
      escape_rate_threshold
                       escape-storm breaker — when a batch's SKIP (escape)
                       rate exceeds this fraction for breaker_threshold
                       consecutive batches, escapes are deferred into the
                       backoff tiers instead of flooding the per-pod
                       oracle; a probe batch every breaker_probe_interval
                       re-closes the breaker once escapes subside.
      wave_deadline    stuck-wave watchdog — a wave whose results have not
                       landed this many seconds after dispatch is
                       cancelled: the backend abandons the wave and the
                       pods requeue through the BackendUnavailableError
                       path."""

    queue_cap: int = 16384              # 0 = unbounded (admission off)
    shed_protect_priority: int = 1000   # >= this priority: never shed
    shed_protect_age: float = 30.0      # queued longer than this: never shed
    slo_p99_ms: float = 250.0           # 0 = adaptive wave sizing off
    wave_min: int = 16                  # AIMD floor for the wave size
    wave_increase: int = 32             # additive increase per good wave
    wave_decrease: float = 0.5          # multiplicative decrease on breach
    escape_rate_threshold: float = 0.5  # 0 = escape-storm breaker off
    escape_min_batch: int = 64          # smaller batches never count as storms
    breaker_threshold: int = 3          # consecutive storm batches to open
    breaker_probe_interval: float = 5.0  # seconds between probe batches
    wave_deadline: float = 120.0        # 0 = stuck-wave watchdog off
    # -- engagement state machine (scheduler._EngagementController) -------
    engagement: str = "auto"            # auto | always | off
    arm_samples: int = 2                # consecutive pressure waves to engage
    engage_dwell: float = 5.0           # min calm seconds before cooling
    cool_dwell: float = 10.0            # cooling seconds before disengaging
    queue_growth_factor: float = 2.0    # depth > factor*wave AND growing

    @property
    def enabled(self) -> bool:
        return (self.engagement != "off"
                and (self.queue_cap > 0 or self.slo_p99_ms > 0
                     or self.escape_rate_threshold > 0
                     or self.wave_deadline > 0))


# overload YAML key -> OverloadPolicy field
_OVERLOAD_FIELDS = {
    "queueCap": "queue_cap",
    "shedProtectPriority": "shed_protect_priority",
    "shedProtectAgeSeconds": "shed_protect_age",
    "sloP99Ms": "slo_p99_ms",
    "waveMin": "wave_min",
    "waveIncrease": "wave_increase",
    "waveDecrease": "wave_decrease",
    "escapeRateThreshold": "escape_rate_threshold",
    "escapeMinBatch": "escape_min_batch",
    "breakerThreshold": "breaker_threshold",
    "breakerProbeIntervalSeconds": "breaker_probe_interval",
    "waveDeadlineSeconds": "wave_deadline",
    "engagement": "engagement",
    "armSamples": "arm_samples",
    "engageDwellSeconds": "engage_dwell",
    "coolDwellSeconds": "cool_dwell",
    "queueGrowthFactor": "queue_growth_factor",
}


def _parse_overload(data: dict) -> OverloadPolicy:
    kwargs = {}
    for key, value in (data or {}).items():
        if key not in _OVERLOAD_FIELDS:
            raise ConfigError(f"unknown overload key {key!r}")
        kwargs[_OVERLOAD_FIELDS[key]] = value
    policy = OverloadPolicy(**kwargs)
    for f in ("queue_cap", "slo_p99_ms", "wave_deadline"):
        if getattr(policy, f) < 0:
            raise ConfigError(f"overload {f} must be >= 0 (0 disables)")
    if policy.shed_protect_age <= 0:
        raise ConfigError("overload shedProtectAgeSeconds must be positive")
    if policy.wave_min < 1 or policy.wave_increase < 1:
        raise ConfigError("overload waveMin/waveIncrease must be >= 1")
    if not 0.0 < policy.wave_decrease < 1.0:
        raise ConfigError("overload waveDecrease must be in (0,1)")
    if not 0.0 <= policy.escape_rate_threshold <= 1.0:
        raise ConfigError("overload escapeRateThreshold must be in [0,1]")
    if policy.escape_min_batch < 1:
        raise ConfigError("overload escapeMinBatch must be >= 1")
    if policy.breaker_threshold < 1:
        raise ConfigError("overload breakerThreshold must be >= 1")
    if policy.breaker_probe_interval <= 0:
        raise ConfigError("overload breakerProbeIntervalSeconds must be positive")
    if policy.engagement not in ("auto", "always", "off"):
        raise ConfigError(
            "overload engagement must be auto, always or off")
    if policy.arm_samples < 1:
        raise ConfigError("overload armSamples must be >= 1")
    if policy.engage_dwell < 0 or policy.cool_dwell < 0:
        raise ConfigError(
            "overload engageDwellSeconds/coolDwellSeconds must be >= 0")
    if policy.queue_growth_factor <= 0:
        raise ConfigError("overload queueGrowthFactor must be positive")
    return policy


@dataclass
class ScaleOutPolicy:
    """Horizontal scale-out: this process is instance `instance_index` of
    `instance_count` cooperating schedulers sharing one store.

    Configured via the `scaleOut:` stanza; instance_count=1 (the default)
    disables the whole layer.  The cluster is partitioned with a
    node-pool ring (scheduler/scaleout.py): node and pod keys hash onto
    `ring_slices` virtual slices, and live instances own slices
    round-robin — when an instance's lease lapses, survivors recompute
    the same map and absorb its slices with no coordination.
    partition_by="namespaceHash" is the fallback for clusters whose node
    names hash unevenly: pods partition by namespace and every instance
    sees all nodes.  Binding stays optimistic either way: ownership only
    reduces contention, the compare-and-bind precondition (kv.bind_many)
    is what prevents double-binds during churn windows."""

    instance_count: int = 1             # 1 = scale-out layer off
    instance_index: int = 0             # this process's identity
    partition_by: str = "nodePoolRing"  # or "namespaceHash"
    ring_slices: int = 64               # virtual slices on the ring
    lease_duration: float = 2.0         # unrenewed this long = dead
    renew_interval: float = 0.5         # lease heartbeat period

    @property
    def enabled(self) -> bool:
        return self.instance_count > 1


# scaleOut YAML key -> ScaleOutPolicy field
_SCALEOUT_FIELDS = {
    "instanceCount": "instance_count",
    "instanceIndex": "instance_index",
    "partitionBy": "partition_by",
    "ringSlices": "ring_slices",
    "leaseDurationSeconds": "lease_duration",
    "renewIntervalSeconds": "renew_interval",
}


def _parse_scaleout(data: dict) -> ScaleOutPolicy:
    kwargs = {}
    for key, value in (data or {}).items():
        if key not in _SCALEOUT_FIELDS:
            raise ConfigError(f"unknown scaleOut key {key!r}")
        kwargs[_SCALEOUT_FIELDS[key]] = value
    policy = ScaleOutPolicy(**kwargs)
    if policy.instance_count < 1:
        raise ConfigError("scaleOut instanceCount must be >= 1")
    if not 0 <= policy.instance_index < policy.instance_count:
        raise ConfigError(
            "scaleOut instanceIndex must be in [0, instanceCount)")
    if policy.partition_by not in ("nodePoolRing", "namespaceHash"):
        raise ConfigError(
            "scaleOut partitionBy must be nodePoolRing or namespaceHash")
    if policy.ring_slices < policy.instance_count:
        raise ConfigError("scaleOut ringSlices must be >= instanceCount")
    if policy.lease_duration <= 0:
        raise ConfigError("scaleOut leaseDurationSeconds must be positive")
    if not 0 < policy.renew_interval < policy.lease_duration:
        raise ConfigError("scaleOut renewIntervalSeconds must be in "
                          "(0, leaseDurationSeconds)")
    return policy


@dataclass
class SchedulerConfig:
    parallelism: int = 16
    percentage_of_nodes_to_score: int = 0
    pod_initial_backoff: float = 1.0
    pod_max_backoff: float = 10.0
    profiles: list[ProfileConfig] = field(default_factory=list)
    extenders: list[dict] = field(default_factory=list)
    remote_seam: RemoteSeamPolicy = field(default_factory=RemoteSeamPolicy)
    backend: BackendPolicy = field(default_factory=BackendPolicy)
    tracing: TracingPolicy = field(default_factory=TracingPolicy)
    overload: OverloadPolicy = field(default_factory=OverloadPolicy)
    scale_out: ScaleOutPolicy = field(default_factory=ScaleOutPolicy)
    profiling: ProfilingPolicy = field(default_factory=ProfilingPolicy)


def _read_source(source: str) -> Any:
    """A path's contents, or the text itself, parsed: JSON with the
    standard library (a .json path, or text that parses as JSON), any
    other document with PyYAML, imported only then."""
    try:
        with open(source) as f:
            text = f.read()
    except OSError:
        text, path = source, None
    else:
        path = source
    if not text.strip():
        return None
    try:
        return json.loads(text)
    except ValueError as e:
        if path is not None and path.endswith(".json"):
            raise ConfigError(f"{path}: invalid JSON: {e}") from None
    try:
        import yaml
    except ImportError:
        raise ConfigError(
            "the config is not JSON and PyYAML (the yaml package) is not "
            "installed: give the configuration as JSON") from None
    return yaml.safe_load(text)


def load_config(source: str | dict) -> SchedulerConfig:
    """Parse + validate a KubeSchedulerConfiguration (path, JSON or YAML
    text, or dict).  Mirrors apis/config/validation/.  Unlike the JAX
    package's, a JSON source needs no PyYAML (the card's machine has
    none)."""
    if isinstance(source, str):
        data = _read_source(source)
    else:
        data = source
    data = data or {}
    kind = data.get("kind", "KubeSchedulerConfiguration")
    if kind != "KubeSchedulerConfiguration":
        raise ConfigError(f"unexpected kind {kind!r}")

    cfg = SchedulerConfig(
        parallelism=data.get("parallelism", 16),
        percentage_of_nodes_to_score=data.get("percentageOfNodesToScore", 0),
        pod_initial_backoff=data.get("podInitialBackoffSeconds", 1.0),
        pod_max_backoff=data.get("podMaxBackoffSeconds", 10.0),
        extenders=data.get("extenders") or [],
        remote_seam=_parse_remote_seam(data.get("remoteSeam")),
        backend=_parse_backend(data.get("backend")),
        tracing=_parse_tracing(data.get("tracing")),
        overload=_parse_overload(data.get("overload")),
        scale_out=_parse_scaleout(data.get("scaleOut")),
        profiling=_parse_profiling(data.get("profiling")),
    )
    if cfg.parallelism <= 0:
        raise ConfigError("parallelism must be positive")
    if not 0 <= cfg.percentage_of_nodes_to_score <= 100:
        raise ConfigError("percentageOfNodesToScore must be in [0,100]")

    known = set(in_tree_registry())
    seen_names: set[str] = set()
    for p in data.get("profiles") or [{}]:
        name = p.get("schedulerName", "default-scheduler")
        if name in seen_names:
            raise ConfigError(f"duplicate profile {name!r}")
        seen_names.add(name)
        plugins = p.get("plugins") or {}
        for point, pset in plugins.items():
            if point not in EXTENSION_POINTS + ("multiPoint",):
                raise ConfigError(f"unknown extension point {point!r}")
            for entry in list((pset or {}).get("enabled") or ()):
                if entry["name"] not in known:
                    raise ConfigError(
                        f"unknown plugin {entry['name']!r} in {point}.enabled")
        plugin_config = {pc["name"]: pc.get("args") or {}
                         for pc in p.get("pluginConfig") or ()}
        cfg.profiles.append(ProfileConfig(
            scheduler_name=name,
            percentage_of_nodes_to_score=p.get(
                "percentageOfNodesToScore",
                cfg.percentage_of_nodes_to_score),
            plugins=plugins, plugin_config=plugin_config))
    return cfg


def _merge_plugin_sets(plugins_cfg: dict
                       ) -> tuple[list[str], dict[str, int],
                                  dict[str, set[str]], dict[str, list[str]]]:
    """Apply the default_plugins.go merge. Returns:
    (base plugin names, score weights, per-plugin disabled points,
     per-point extra plugin names)."""
    weights = dict(DEFAULT_SCORE_WEIGHTS)
    base = list(DEFAULT_PLUGINS)

    mp = plugins_cfg.get("multiPoint") or {}
    disabled = [d["name"] for d in mp.get("disabled") or ()]
    if "*" in disabled:
        base = []
    else:
        base = [n for n in base if n not in disabled]
    for e in mp.get("enabled") or ():
        if e["name"] not in base:
            base.append(e["name"])
        if "weight" in e:
            weights[e["name"]] = e["weight"]

    disabled_points: dict[str, set[str]] = {}
    extra_points: dict[str, list[str]] = {}
    for point in EXTENSION_POINTS:
        pset = plugins_cfg.get(point) or {}
        for d in pset.get("disabled") or ():
            if d["name"] == "*":
                for n in base:
                    disabled_points.setdefault(n, set()).add(point)
            else:
                disabled_points.setdefault(d["name"], set()).add(point)
        for e in pset.get("enabled") or ():
            extra_points.setdefault(point, []).append(e["name"])
            if point == "score" and "weight" in e:
                weights[e["name"]] = e["weight"]
            # point-scoped enable overrides a point-scoped "*" disable
            disabled_points.get(e["name"], set()).discard(point)
    return base, weights, disabled_points, extra_points


def build_framework_from_profile(client, informer_factory,
                                 profile_cfg: ProfileConfig,
                                 out_of_tree_registry=None) -> Framework:
    """profile.NewMap body for one profile (profile/profile.go:48), with
    WithFrameworkOutOfTreeRegistry merge (scheduler.go:180)."""
    registry = in_tree_registry()
    if out_of_tree_registry:
        overlap = set(registry) & set(out_of_tree_registry)
        if overlap:
            raise ConfigError(
                f"out-of-tree plugins shadow in-tree: {sorted(overlap)}")
        registry.update(out_of_tree_registry)

    base, weights, disabled_points, extra_points = _merge_plugin_sets(
        profile_cfg.plugins)
    extra_names = [n for names in extra_points.values() for n in names]
    all_names = base + [n for n in extra_names if n not in base]
    for n in all_names:
        if n not in registry:
            raise ConfigError(f"unknown plugin {n!r}")

    handle = Handle(client=client, informer_factory=informer_factory)
    plugins = [registry[n](profile_cfg.plugin_config.get(n), handle)
               for n in all_names]

    extra_only = {n for n in extra_names if n not in base}

    def point_filter(name: str, point: str) -> bool:
        if point in disabled_points.get(name, ()):
            return False
        if name in extra_only:
            # enabled only at the points that named it
            return name in extra_points.get(point, ())
        return True

    return Framework(profile_cfg.scheduler_name, plugins,
                     score_weights=weights, handle=handle,
                     point_filter=point_filter)


def scheduler_from_config(client, informer_factory, cfg: SchedulerConfig,
                          out_of_tree_registry=None):
    """Setup (cmd/kube-scheduler/app/server.go:307): config -> Scheduler."""
    from .queue import SchedulingQueue  # noqa: F401  (backoff knobs below)
    from .scheduler import Profile, Scheduler

    profiles = {}
    for pc in cfg.profiles or [ProfileConfig()]:
        fw = build_framework_from_profile(client, informer_factory, pc,
                                          out_of_tree_registry)
        profiles[pc.scheduler_name] = Profile(
            fw, percentage_of_nodes_to_score=pc.percentage_of_nodes_to_score)
    sched = Scheduler(client, informer_factory, profiles,
                      extenders=build_extenders(cfg.extenders))
    sched.queue._initial_backoff = cfg.pod_initial_backoff
    sched.queue._max_backoff = cfg.pod_max_backoff
    # backends are constructed by the harness (bench/perf/tests), not
    # here: hang the seam policy off the scheduler so whoever wires a
    # RemoteTPUBatchBackend into a profile picks up the configured
    # deadlines/retry budget instead of the hard-coded defaults
    sched.remote_seam_policy = cfg.remote_seam
    # same contract for the device backend: the stanza records WHICH
    # backend the harness should build (ops/backend.make_batch_backend),
    # construction stays with bench/perf/tests
    sched.backend_policy = cfg.backend
    sched.pipeline_depth = max(1, cfg.backend.pipeline_depth)
    if cfg.overload.enabled:
        sched.configure_overload(cfg.overload)
    if cfg.scale_out.enabled:
        sched.configure_scaleout(cfg.scale_out)
        # deterministic per-instance relist offset: when every instance
        # restarts its watch at once (store compaction, apiserver blip),
        # the LISTs arrive index-staggered instead of as one herd
        if hasattr(informer_factory, "set_relist_stagger"):
            informer_factory.set_relist_stagger(
                0.1 * cfg.scale_out.instance_index)
    if cfg.tracing.enabled:
        # the process-wide provider backs /debug/traces on the apiserver's
        # HTTP mux; tests that want isolation construct their own provider
        # and call configure_tracing directly
        from ..component_base import tracing
        tracing.default_tracer_provider.configure(
            sampling_rate_per_million=cfg.tracing.sampling_rate_per_million,
            max_spans=cfg.tracing.max_spans,
            max_traces=cfg.tracing.max_traces)
        sched.configure_tracing(tracing.default_tracer_provider)
    if (cfg.profiling.enabled or cfg.profiling.census
            or cfg.profiling.timeline):
        # the process-wide profiler backs /debug/profile on the apiserver
        # and device-worker muxes (tracing's default-provider pattern);
        # tests wanting isolation construct their own HostProfiler and
        # call configure_profiling directly.  Default-off: this branch is
        # the ONLY place the sampler starts, the census arms, or the
        # wave timeline's default ring is enabled.
        from ..component_base import profiling
        from ..component_base import timeline as cb_timeline
        profiler = None
        if cfg.profiling.enabled:
            profiler = profiling.default_host_profiler
            profiler.interval = cfg.profiling.sample_interval_ms / 1000.0
            profiler.max_stacks = cfg.profiling.max_stacks
            profiler.start()
        timeline = None
        if cfg.profiling.timeline:
            timeline = cb_timeline.default_timeline
            timeline.configure(enabled=True,
                               ring=cfg.profiling.timeline_ring)
        slo = profiling.SLOTracker(
            target_ms=cfg.profiling.slo_target_ms,
            objective=cfg.profiling.slo_objective,
            windows=cfg.profiling.burn_windows_s)
        sched.configure_profiling(profiler, slo, census=cfg.profiling.census,
                                  timeline=timeline)
    return sched
