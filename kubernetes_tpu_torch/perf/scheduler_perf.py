"""scheduler_perf — the reference's scale benchmark harness, ported.

Reference: test/integration/scheduler_perf/
  scheduler_perf_test.go:57-63  workload opcodes: createNodes / createPods /
                                churn / barrier / sleep
  util.go:79  mustSetupScheduler (in-proc apiserver + real scheduler)
  util.go:288-355  throughputCollector: samples scheduled-pod count at a
                   fixed window -> SchedulingThroughput Average/PercNN
  config/performance-config.yaml  workload definitions

Workloads are dict configs of this shape (perf/config/
performance-config.json holds them, the JAX package's YAML as JSON):

  name: SchedulingBasic
  workloadTemplate:
    - opcode: createNodes
      count: 500
    - opcode: createPods
      count: 500
      podTemplate: {...}         # optional; default is a small-request pod
    - opcode: barrier            # wait until all pending pods scheduled
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any

from ..api import meta
from ..client import LocalClient, SharedInformerFactory
from ..client.clientset import NODES, PODS
from ..scheduler import Profile, Scheduler, new_default_framework
from ..store import kv
from ..testing import make_node, make_pod

DEFAULT_SAMPLE_INTERVAL = 1.0  # util.go: 1s window


@dataclass
class ThroughputSummary:
    average: float = 0.0
    perc50: float = 0.0
    perc90: float = 0.0
    perc99: float = 0.0
    total_pods: int = 0
    duration: float = 0.0

    def to_dict(self) -> dict:
        return {"Average": round(self.average, 1), "Perc50": round(self.perc50, 1),
                "Perc90": round(self.perc90, 1), "Perc99": round(self.perc99, 1),
                "TotalPods": self.total_pods,
                "DurationSeconds": round(self.duration, 2)}


class ThroughputCollector:
    """Samples scheduled-pod deltas per window (util.go:288-355).

    Counts via a pods WATCH instead of re-listing the store: at 100k+
    pods the reference-style full scan costs ~0.4s of GIL per 1s sample
    (plus the barrier's polling scans), which measurably throttles the
    pipeline being measured.  The watch is O(events) and the store emits
    each bind exactly once."""

    def __init__(self, store: kv.MemoryStore, interval: float = DEFAULT_SAMPLE_INTERVAL):
        self.store = store
        self.interval = interval
        self.samples: list[float] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._start_time = 0.0
        self._count = 0           # pods observed bound since start()
        self._count_lock = threading.Lock()
        self._scheduled: set[str] = set()
        self._watch: kv.Watch | None = None
        self._base = 0            # pods already bound when start() ran
        self._frozen_at = 0.0     # freeze(): end of the measured window
        self._frozen_count = 0
        self._frozen_samples: list[float] = []
        self._last_sched_at = 0.0  # drain time of the newest bind seen

    def scheduled_total(self) -> int:
        """Pods bound since start() (drain-backed; cheap)."""
        with self._count_lock:
            return self._count

    def bound_total(self) -> int:
        """ALL bound pods: pre-start (warm-up ops) + since start().
        Barriers use this; the throughput window uses scheduled_total."""
        with self._count_lock:
            return self._base + self._count

    def _drain(self) -> None:
        evs = self._watch.next_batch(timeout=0.05)
        if not evs:
            return
        new = 0
        seen = self._scheduled
        DELETED = kv.DELETED
        for ev in evs:
            o = ev.object
            md = o["metadata"]
            ns = md.get("namespace", "")
            k = f"{ns}/{md['name']}" if ns else md["name"]
            if ev.type == DELETED:
                seen.discard(k)
            elif (o.get("spec") or {}).get("nodeName"):
                if k not in seen:
                    seen.add(k)
                    new += 1
        if new:
            with self._count_lock:
                self._count += new
                self._last_sched_at = time.monotonic()

    @property
    def started(self) -> bool:
        return self._start_time != 0.0

    @property
    def frozen(self) -> bool:
        return self._frozen_at != 0.0

    def start(self) -> None:
        # watch first, then count what was already bound (warm-up ops
        # before the measured one): a bind landing between the two is
        # seen by BOTH, so seed the dedup set from the scan — it can
        # only overcount the base, never undercount bound_total
        self._watch = self.store.watch(PODS)
        items, _rv = self.store.list(PODS, None)
        for o in items:
            if (o.get("spec") or {}).get("nodeName"):
                md = o["metadata"]
                ns = md.get("namespace", "")
                self._scheduled.add(f"{ns}/{md['name']}" if ns
                                    else md["name"])
        self._base = len(self._scheduled)
        # the window opens AFTER the O(pods) seeding scan: the measured
        # createPods haven't been created yet, so no bind can be missed,
        # and the scan's duration must not deflate the reported rate
        self._start_time = time.monotonic()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def freeze(self) -> None:
        """Close the measurement window NOW (the measured op's barrier
        completed): samples/duration after this point are excluded, like
        the reference cancelling its collector right after the measured
        createPods' waitUntil (scheduler_perf_test.go:744-751).  Watch
        draining continues so scheduled_total stays usable for later
        barriers."""
        self._drain()
        with self._count_lock:
            self._frozen_count = self._count
            # end the window at the drain that saw the final bind, not
            # at barrier detection: the barrier polls at 50 ms, so its
            # detection latency would quantize the window and read as
            # up to a few percent of phantom throughput loss on short
            # runs (the --timeline A/B measures exactly this margin)
            self._frozen_at = self._last_sched_at or time.monotonic()
        self._frozen_samples = list(self.samples)

    def _run(self) -> None:
        window_start = time.monotonic()
        window_count = 0
        while not self._stop.is_set():
            self._drain()
            now = time.monotonic()
            if now - window_start >= self.interval:
                cur = self.scheduled_total()
                self.samples.append((cur - window_count)
                                    / (now - window_start))
                window_start, window_count = now, cur

    def stop(self) -> ThroughputSummary:
        self._stop.set()
        if self._thread:
            self._thread.join(2.0)
        self._drain()  # pick up the tail
        if self._watch is not None:
            self._watch.stop()
        if self.frozen:
            # window closed at the measured barrier; trailing ops
            # (sleep/churn/later floods) are excluded
            total = self._frozen_count
            dur = max(self._frozen_at - self._start_time, 1e-9)
            self.samples = self._frozen_samples
        else:
            end = time.monotonic()
            total = self.scheduled_total()
            dur = max(end - self._start_time, 1e-9)
        s = ThroughputSummary(total_pods=total, duration=dur,
                              average=total / dur)
        if self.samples:
            xs = sorted(self.samples)
            def perc(p: float) -> float:
                return xs[min(int(len(xs) * p), len(xs) - 1)]
            s.perc50, s.perc90, s.perc99 = perc(0.50), perc(0.90), perc(0.99)
        return s


@dataclass
class PerfCluster:
    store: object               # MemoryStore, or the HTTPClient when the
    client: object              # apiserver runs out of process (it only
    factory: SharedInformerFactory  # needs .watch()/.list())
    scheduler: Scheduler
    worker: object = None       # in-process device worker (remote_seam)
    front: object = None        # _FrontDoor when via_http

    def shutdown(self) -> None:
        self.scheduler.stop()
        # after scheduler.stop(): the final flush still needs the seam
        for p in self.scheduler.profiles.values():
            close = getattr(p.batch_backend, "close", None)
            if close is not None:
                close()
        if self.worker is not None:
            self.worker.stop()
        self.factory.stop()
        self.client.close()  # event-broadcaster thread
        if self.front is not None:
            self.front.stop()


@dataclass
class _FrontDoor:
    """The apiserver of a via_http cluster: in process (`server`) or a
    child process (`proc`), over a WAL in `tmpdir`."""
    store: object
    client: object
    server: object = None
    proc: object = None
    tmpdir: object = None

    def stop(self) -> None:
        if self.server is not None:
            self.server.stop()
        if self.proc is not None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except Exception:  # noqa: BLE001 - then kill + reap
                self.proc.kill()
                self.proc.wait()
        if self.tmpdir is not None:
            self.tmpdir.cleanup()


# no controllers run in the harness, so the admission plugins that depend
# on them come off: the reference harness disables exactly these
# (scheduler_perf/util.go:84-85)
_HARNESS_DISABLED_ADMISSION = ("ServiceAccount", "TaintNodesByCondition",
                               "Priority")


def _front_door(via_http) -> _FrontDoor:
    """Start the apiserver a via_http cluster speaks to: RBAC, the default
    admission chain and a WAL-backed store, with a bearer token the
    scheduler and the submitter share.  via_http="process" runs it as
    `python -m kubernetes_tpu_torch.cmd.apiserver` in a child process and
    waits (30 s at most) for its /healthz."""
    import secrets as pysecrets
    import tempfile

    from ..client.http_client import HTTPClient
    tmpdir = tempfile.TemporaryDirectory(prefix="bench-wal-")
    token = pysecrets.token_urlsafe(16)
    if via_http != "process":
        from ..apiserver import APIServer
        store = kv.MemoryStore(history=1_000_000, durable_dir=tmpdir.name)
        server = APIServer(store, token=token, enable_rbac=True,
                           enable_default_admission=True,
                           disable_admission_plugins=frozenset(
                               _HARNESS_DISABLED_ADMISSION)).start()
        return _FrontDoor(store, HTTPClient.from_url(server.url, token=token),
                          server=server, tmpdir=tmpdir)
    import os
    import socket as socketlib
    import subprocess
    import sys
    with socketlib.socket() as s:  # pick a free port
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubernetes_tpu_torch.cmd.apiserver",
         "--secure-port", str(port), "--token", token,
         "--authorization-mode", "RBAC",
         "--enable-default-admission",
         "--disable-admission-plugins", ",".join(_HARNESS_DISABLED_ADMISSION),
         "--data-dir", tmpdir.name],
        # from the directory that holds the package, whatever the caller's
        cwd=os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    client = HTTPClient.from_url(f"http://127.0.0.1:{port}", token=token)
    front = _FrontDoor(client, client, proc=proc, tmpdir=tmpdir)
    deadline = time.monotonic() + 30
    while True:
        try:
            client._request("GET", "/healthz")
            # the collector watches through the HTTP client
            return front
        except Exception:  # noqa: BLE001 - still starting
            if proc.poll() is not None or time.monotonic() > deadline:
                front.stop()
                raise RuntimeError("apiserver process failed to start")
            time.sleep(0.1)


def setup_cluster(caps=None, batch_size: int = 512,
                  store: kv.MemoryStore | None = None,
                  pipeline_depth: int = 1,
                  admission_interval: float = 0.0,
                  via_http: bool = False,
                  null_device: bool = False,
                  percentage_of_nodes_to_score: int = 0,
                  remote_seam: str | None = None,
                  backend_kind: str = "tpu",
                  tracing_provider=None,
                  overload=None,
                  chaos_schedule=None,
                  profiling_policy=None,
                  device_flight_s: float = 0.0,
                  device=None, mesh=None) -> PerfCluster:
    """mustSetupScheduler (util.go:79): in-proc everything, no kubelet.

    pipeline_depth/admission_interval select latency mode (scheduler.py):
    depth ~4 + a few-ms admission interval turns the batch path into
    overlapped micro-batches for p99-targeted runs.

    The profile's batch backend comes from
    ops/backend.make_batch_backend(backend_kind): "tpu" is
    TorchBatchBackend on `device` (CUDA unless the caller names the CPU;
    without a GPU the default raises), "sharded" ShardedTorchBatchBackend
    on `mesh` (parallel/mesh.make_mesh; default: a mesh of `device`, every
    visible CUDA device when none is named), "null" the host pipeline with the
    device step nulled (ops/nullbackend.py).  It is built and warmed up on
    the caller's thread, before the informers start.  null_device=True
    asks for the "null" kind whatever backend_kind says (the host-ceiling
    row); it is a measurement the caller names, never a fallback.
    tracing_provider attaches a component_base.tracing.TracerProvider to
    the scheduler (configure_tracing); overload takes a
    config.OverloadPolicy (configure_overload); chaos_schedule takes an
    ops.faults.OverloadSchedule and wraps the backend in
    ChaosBatchBackend (slow and all-escape waves); device_flight_s > 0
    wraps it in FlightDelayBackend (every wave's flight pinned to at least
    that wall time).

    remote_seam routes the batch backend through the device worker seam
    (ops/remote.py): "http" or "grpc" starts an in-process DeviceWorker
    or GrpcDeviceWorker on `device` (PerfCluster.worker, stopped at
    shutdown after the backend's transport closes), and a URL
    ("http://host:port", "grpc://host:port") drives a worker that runs in
    another process (python -m kubernetes_tpu_torch.cmd.tpu_worker).
    Either way the profile's backend is a RemoteTorchBatchBackend; the
    device is the worker's.

    via_http runs the FRONT DOOR: a real apiserver with RBAC, the default
    admission chain and WAL durability, and the scheduler (informers,
    binds, events) plus the workload submitter all speaking HTTP to it:
    the reference harness's shape (util.go:79-108 schedules through a
    real apiserver), which measures what LocalClient bypasses.
    via_http="process" runs the apiserver as a separate OS process
    (`python -m kubernetes_tpu_torch.cmd.apiserver`), the reference's
    deployment shape: its JSON, admission and WAL work run on their own
    interpreter instead of sharing the scheduler's GIL.  The batch
    backend stays on `device` either way.
    profiling_policy.census runs the backend's device census after its
    warmup (TorchBatchBackend.device_census: one step of each variant on a
    clone of the resident state).
    """
    if via_http and store is not None:
        raise ValueError("via_http builds its own WAL-backed store; "
                         "a caller-provided store would be ignored")
    from ..utils.gctune import tune_for_throughput
    tune_for_throughput()  # CPython gen-2 pauses cost ~35% at bench scale
    from ..ops.backend import make_batch_backend
    from ..ops.flatten import Caps
    worker = None
    if remote_seam and not null_device:
        from ..ops.remote import RemoteTorchBatchBackend, make_worker
        url = remote_seam
        if "://" not in remote_seam:
            worker = make_worker(remote_seam, device=device).start()
            url = worker.url
        try:
            backend = RemoteTorchBatchBackend(url, caps or Caps(),
                                              batch_size=batch_size)
            backend.warmup()
        except BaseException:
            if worker is not None:
                worker.stop()
            raise
    else:
        kind = "null" if null_device else backend_kind
        backend = make_batch_backend(
            kind, caps or Caps(), batch_size=batch_size, device=device,
            **({"mesh": mesh} if kind == "sharded" else {}))
        backend.warmup()
    if chaos_schedule is not None:
        from ..ops.faults import ChaosBatchBackend
        backend = ChaosBatchBackend(backend, chaos_schedule)
    if device_flight_s > 0:
        from ..ops.nullbackend import FlightDelayBackend
        backend = FlightDelayBackend(backend, device_flight_s)
    # the front door starts once the backend is built and warm, so a
    # device fault leaves no apiserver behind
    front = None
    if via_http:
        front = _front_door(via_http)
        store, client = front.store, front.client
    else:
        store = store or kv.MemoryStore(history=1_000_000)
        client = LocalClient(store)
    factory = SharedInformerFactory(client)
    fw = new_default_framework(client, factory)
    profiles = {"default-scheduler": Profile(
        fw, batch_backend=backend, batch_size=batch_size,
        percentage_of_nodes_to_score=percentage_of_nodes_to_score)}
    sched = Scheduler(client, factory, profiles,
                      pipeline_depth=pipeline_depth,
                      admission_interval=admission_interval)
    if overload is not None:
        sched.configure_overload(overload)
    if tracing_provider is not None:
        sched.configure_tracing(tracing_provider)
    if profiling_policy is not None and (profiling_policy.enabled
                                         or profiling_policy.census
                                         or profiling_policy.timeline):
        # same wiring scheduler_from_config applies for the profiling:
        # stanza — bench --profile reuses the ProfilingPolicy dataclass
        from ..component_base import profiling as cbp
        profiler = None
        if profiling_policy.enabled:
            profiler = cbp.default_host_profiler
            profiler.reset()
            profiler.interval = profiling_policy.sample_interval_ms / 1000.0
            profiler.max_stacks = profiling_policy.max_stacks
            profiler.start()
        slo = cbp.SLOTracker(
            target_ms=profiling_policy.slo_target_ms,
            objective=profiling_policy.slo_objective,
            windows=profiling_policy.burn_windows_s)
        timeline = None
        if profiling_policy.timeline:
            # arm the process-local interval ring the backends record
            # into (bench --timeline rides the same switch the
            # profiling: stanza flips)
            from ..component_base import timeline as cb_timeline
            timeline = cb_timeline.default_timeline
            timeline.configure(enabled=True,
                               ring=profiling_policy.timeline_ring)
            timeline.reset()
        sched.configure_profiling(profiler, slo,
                                  census=profiling_policy.census,
                                  timeline=timeline)
        if profiling_policy.enabled or profiling_policy.census:
            sched.run_device_census()
    factory.start()
    factory.wait_for_cache_sync()
    sched.run()
    return PerfCluster(store, client, factory, sched, worker=worker,
                       front=front)


# -- workload ops (scheduler_perf_test.go opcodes) -------------------------

def _default_pod(i: int, params: dict) -> dict:
    """Build pod #i for a createPods op.  The op's invariant shape is
    built ONCE and cached on the params dict; each pod is then a Python
    `meta.deep_copy` + name fill.  That copy holds the GIL on the
    submission thread, which competes with the pipeline being measured:
    it is the loop's first host cost at 100k (a native copier is ROADMAP
    queue 1 item 9)."""
    tmpl = params.get("_pod_tmpl_cache")
    if tmpl is None:
        w = make_pod(params.get("podNamePrefix", "pod-"),
                     params.get("namespace", "default"))
        user_tmpl = params.get("podTemplate") or {}
        if user_tmpl:
            pod = meta.deep_copy(w.build())
            spec = meta.deep_copy(user_tmpl.get("spec") or {})
            pod["spec"].update(spec)
            if "metadata" in user_tmpl:
                md = meta.deep_copy(user_tmpl["metadata"])
                name = pod["metadata"]["name"]
                ns = pod["metadata"]["namespace"]
                pod["metadata"].update(md)
                pod["metadata"]["name"] = name
                pod["metadata"]["namespace"] = ns
        else:
            pod = w.req(cpu=params.get("cpu", "100m"),
                        mem=params.get("memory", "128Mi")).build()
        tmpl = params["_pod_tmpl_cache"] = pod
    pod = meta.deep_copy(tmpl)
    pod["metadata"]["name"] = params.get("podNamePrefix", "pod-") + str(i)
    nrr = params.get("namespaceRoundRobin")
    if nrr:
        # pod #i lands in {prefix}{i % count} — the NSSelector
        # workloads' createPodSets analog (N pods per init namespace)
        pod["metadata"]["namespace"] = (
            f"{nrr.get('prefix', 'init-ns-')}{i % int(nrr['count'])}")
    ds = params.get("distinctServices")
    if ds:
        # high-label-cardinality shape: pod #i belongs to service
        # svc-{i%ds}; its labels AND its (anti-)affinity selectors track
        # the service, so the workload carries `ds` distinct selector
        # groups (the regime that overflows fixed selector-group caps)
        svc = f"svc-{i % int(ds)}"
        pod["metadata"].setdefault("labels", {})["app"] = svc
        aff = (pod.get("spec") or {}).get("affinity") or {}
        for side in ("podAntiAffinity", "podAffinity"):
            for term in (aff.get(side) or {}).get(
                    "requiredDuringSchedulingIgnoredDuringExecution") or ():
                sel = term.get("labelSelector")
                if sel and "matchLabels" in sel:
                    sel["matchLabels"] = {"app": svc}
    esc = params.get("escapeEvery")
    if esc and i % int(esc) == 0:
        # every Nth pod carries a Gt node-affinity term — one of the
        # constraint shapes the tensor path deliberately does NOT encode
        # (flatten._encode_affinity_terms escapes Gt/Lt), so these pods
        # measure the blended tensor+oracle regime and a non-zero
        # escape_rate (the honest-coverage bench config)
        pod["spec"]["affinity"] = {"nodeAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": {
                "nodeSelectorTerms": [{"matchExpressions": [
                    {"key": "ktpu.io/rack", "operator": "Gt",
                     "values": ["9"]}]}]}}}
    pg = params.get("podGroups")
    if pg:
        # gang membership: contiguous blocks of minMember pods per group
        # (the Coscheduling workload; BASELINE tracked config #4)
        size = pg.get("minMember", 10)
        group = f"{pg.get('namePrefix', 'pg-')}{i // size}"
        pod["metadata"].setdefault("labels", {})[
            "scheduling.x-k8s.io/pod-group"] = group
    return pod


def _default_node(i: int, params: dict) -> dict:
    """Node #i: template + Python `meta.deep_copy`, like _default_pod
    (ROADMAP queue 1 item 9)."""
    tmpl = params.get("_node_tmpl_cache")
    if tmpl is None:
        w = make_node(params.get("nodeNamePrefix", "node-"))
        w.capacity(cpu=params.get("cpu", "32"),
                   mem=params.get("memory", "256Gi"),
                   pods=params.get("pods", 110))
        w.labels(**dict(params.get("labels") or {}))
        tmpl = params["_node_tmpl_cache"] = w.build()
    node = meta.deep_copy(tmpl)
    name = params.get("nodeNamePrefix", "node-") + str(i)
    node["metadata"]["name"] = name
    labels = node["metadata"].setdefault("labels", {})
    if params.get("zones"):
        zones = params["zones"]
        labels["topology.kubernetes.io/zone"] = zones[i % len(zones)]
    if params.get("rackLabels"):
        # numeric label for Gt/Lt node-affinity workloads (the operator
        # pair the tensor encoding does NOT carry — those pods escape to
        # the per-pod oracle by design)
        labels["ktpu.io/rack"] = str(i % int(params["rackLabels"]))
    labels.setdefault("kubernetes.io/hostname", name)
    return node


def _bulk_create(client, resource: str, count: int, offset: int,
                 build, op: dict, chunk: int = 512) -> None:
    """createNodes/createPods submission: chunked bulk writes through the
    client's create_bulk (LocalClient's ownership-transfer one, or
    HTTPClient's bulk POST; the reference harness pumps objects through a
    5000-QPS/5000-burst client, util.go:92)."""
    if count >= 256:
        for lo in range(0, count, chunk):
            client.create_bulk(resource, [
                build(offset + i, op)
                for i in range(lo, min(lo + chunk, count))])
    elif count >= 64 and not isinstance(client, LocalClient):
        # remote client (HTTP): fan the submission over a few
        # connections, as the reference harness pumps through a
        # concurrent rate-limited client (util.go:92); HTTPClient keeps
        # one keep-alive connection per thread
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=8) as pool:
            list(pool.map(
                lambda i: client.create(resource, build(offset + i, op)),
                range(count)))
    else:
        for i in range(count):
            client.create(resource, build(offset + i, op))


def wait_for_pods_scheduled(cluster: PerfCluster, want: int,
                            timeout: float = 600.0, namespace=None,
                            collector: ThroughputCollector | None = None
                            ) -> bool:
    """barrier opcode: wait until `want` pods have nodeName set.

    With a collector the check is its watch-backed counter (O(1));
    the full-scan fallback costs O(pods) per poll and throttles the
    pipeline at 100k+ pods."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if collector is not None and collector.started and namespace is None:
            n = collector.bound_total()
        else:
            items, _ = cluster.store.list(PODS, namespace)
            n = sum(1 for p in items if meta.pod_node_name(p))
        if n >= want:
            return True
        time.sleep(0.05)
    return False


def is_measured(op: dict, ops: list[dict]) -> bool:
    """Reference collectMetrics semantics (scheduler_perf_test.go:716-751):
    when any createPods op declares collectMetrics, ONLY those ops are
    measured — earlier createPods are warm-up, outside the throughput
    window.  Templates without the flag keep the old behavior (every
    createPods measured, the first opens the window).  Shared by the
    harness and bench.py's count/rate overrides so they can't diverge."""
    if op.get("opcode", "createPods") != "createPods":
        return False
    any_cm = any(o.get("collectMetrics") for o in ops
                 if o.get("opcode") == "createPods")
    return op.get("collectMetrics", not any_cm)


def run_workload(cluster: PerfCluster, ops: list[dict],
                 collector: ThroughputCollector | None = None) -> dict:
    """Execute a workloadTemplate op list. Returns op stats."""
    created_pods = 0
    created_nodes = 0
    # pods expected to actually schedule: createPods ops marked
    # skipWaitToCompletion (the Unschedulable workload's parked pods,
    # performance-config.yaml:437-443) are excluded from barrier targets
    expected_scheduled = 0
    stats: dict[str, Any] = {}
    churn_stop: list[threading.Event] = []
    storm_drivers: list = []
    for op in ops:
        opcode = op["opcode"]
        if opcode == "createNodes":
            t_nodes = time.monotonic()
            _bulk_create(cluster.client, NODES, op["count"], created_nodes,
                         _default_node, op)
            created_nodes += op["count"]
            stats["create_nodes_s"] = (stats.get("create_nodes_s", 0.0)
                                       + time.monotonic() - t_nodes)
        elif opcode == "createNamespaces":
            # namespace objects with labels (the NSSelector workloads'
            # namespace-with-labels.yaml shape)
            from ..client.clientset import NAMESPACES
            prefix = op.get("prefix", "ns-")
            for i in range(op["count"]):
                nsobj = meta.new_object("Namespace", f"{prefix}{i}",
                                        namespace=None)
                if op.get("labels"):
                    nsobj["metadata"]["labels"] = dict(op["labels"])
                try:
                    cluster.client.create(NAMESPACES, nsobj)
                except kv.ConflictError:
                    pass
        elif opcode == "createPods":
            if collector is not None and not collector.started \
                    and is_measured(op, ops):
                # measurement window opens with the first measured pods
                # (reference: CollectMetrics on the createPods op)
                stats["flatten_before_window_s"] = sum(
                    p.batch_backend.stats.get("flatten_seconds", 0.0)
                    for p in cluster.scheduler.profiles.values()
                    if p.batch_backend is not None)
                collector.start()
                if hasattr(cluster.scheduler, "metrics") \
                        and stats.get("barrier_ok", True):
                    # the warm-up barrier saw the binds in the STORE; the
                    # scheduler records each e2e entry only after its bulk
                    # commit returns, so briefly wait for the metric to
                    # catch up or in-flight warm-up latencies would land
                    # after the watermark and pollute the measured e2e.
                    # Skipped when the warm-up barrier already failed
                    # (the mark can never reach the target), and bounded
                    # by progress: a stalled mark exits early.
                    m = cluster.scheduler.metrics
                    deadline = time.monotonic() + 5.0
                    last, last_change = m.e2e_mark(), time.monotonic()
                    while (last < expected_scheduled
                           and time.monotonic() < deadline):
                        time.sleep(0.005)
                        cur = m.e2e_mark()
                        if cur != last:
                            last, last_change = cur, time.monotonic()
                        elif time.monotonic() - last_change > 0.25:
                            break  # mark stopped advancing
                    stats["e2e_mark"] = m.e2e_mark()
            rate = op.get("ratePerSecond")
            if rate:
                # paced arrival (the reference harness's client-QPS knob,
                # util.go:92): steady load below capacity is what the
                # p99-latency target is ABOUT — a full-backlog dump makes
                # p99 the backlog drain time by construction
                chunk = max(1, int(rate) // 100)  # 10ms ticks
                next_t = time.monotonic()
                for lo in range(0, op["count"], chunk):
                    hi = min(lo + chunk, op["count"])
                    _bulk_create(cluster.client, PODS, hi - lo,
                                 created_pods + lo, _default_pod, op)
                    next_t += (hi - lo) / rate
                    delay = next_t - time.monotonic()
                    if delay > 0:
                        time.sleep(delay)
            else:
                _bulk_create(cluster.client, PODS, op["count"],
                             created_pods, _default_pod, op)
            created_pods += op["count"]
            if not op.get("skipWaitToCompletion"):
                expected_scheduled += op["count"]
        elif opcode == "createPodGroups":
            from ..client.clientset import PODGROUPS
            prefix = op.get("namePrefix", "pg-")
            for i in range(op["count"]):
                pg = meta.new_object("PodGroup", f"{prefix}{i}", "default")
                pg["spec"] = {"minMember": op.get("minMember", 10),
                              "scheduleTimeoutSeconds": op.get(
                                  "scheduleTimeoutSeconds", 120)}
                cluster.client.create(PODGROUPS, pg)
        elif opcode == "barrier":
            want = op.get("count", expected_scheduled)
            ok = wait_for_pods_scheduled(cluster, want,
                                         timeout=op.get("timeout", 600.0),
                                         collector=collector)
            stats["barrier_ok"] = ok
            if collector is not None and collector.started \
                    and not collector.frozen:
                # measured window closes at the barrier that covers the
                # measured createPods (reference: collectorCancel right
                # after waitUntilPodsScheduled)
                collector.freeze()
        elif opcode == "sleep":
            time.sleep(op.get("duration", 1.0))
        elif opcode == "churn":
            # background create/delete loop (scheduler_perf churn op,
            # scheduler_perf_test.go churnOp).  mode=recreate keeps
            # `number` live copies of each templated object, deleting the
            # oldest as new ones land (SchedulingWithMixedChurn cycles a
            # capacity-0 node, an unschedulable high-priority pod, and a
            # service every interval — each a different event source for
            # the scheduler's requeue gating).
            ev = threading.Event()
            churn_stop.append(ev)
            interval = op.get("intervalMilliseconds", 500) / 1000.0
            mode = op.get("mode", "create")
            objects = op.get("objects", ["pod"])
            number = op.get("number", 1)

            def churn_objects(i: int) -> list[tuple[str, str | None, str, dict]]:
                from ..client.clientset import SERVICES
                out = []
                for kind in objects:
                    name = f"churn-{kind}-{i}"
                    if kind == "node":
                        n = make_node(name).capacity(cpu="1", mem="1Gi",
                                                     pods=0).build()
                        out.append((NODES, None, name, n))
                    elif kind == "service":
                        svc = meta.new_object("Service", name, "churn")
                        svc["spec"] = {"selector": {"app": "foo"},
                                       "ports": [{"protocol": "TCP",
                                                  "port": 8080}]}
                        out.append((SERVICES, "churn", name, svc))
                    elif mode == "recreate":
                        # pod: high-priority, oversized (never schedules;
                        # pod-high-priority-large-cpu.yaml shape)
                        p = make_pod(name, "churn").req(cpu="9",
                                                        mem="500Mi").build()
                        p["spec"]["priority"] = 10
                        out.append((PODS, "churn", name, p))
                    else:  # legacy create-mode churn: tiny schedulable pod
                        p = make_pod(name, "churn").req(cpu="1m").build()
                        out.append((PODS, "churn", name, p))
                return out

            def churn_loop(ev=ev, interval=interval):
                from collections import deque
                live: deque = deque()
                i = 0
                while not ev.wait(interval):
                    for res, ns, name, obj in churn_objects(i):
                        try:
                            cluster.client.create(res, obj)
                            live.append((res, ns, name))
                        except kv.StoreError:
                            pass
                    while len(live) > number * len(objects):
                        res, ns, name = live.popleft()
                        try:
                            cluster.client.delete(res, ns, name)
                        except kv.StoreError:
                            pass
                    if mode != "recreate":
                        # legacy create mode: delete immediately
                        while live:
                            res, ns, name = live.popleft()
                            try:
                                cluster.client.delete(res, ns, name)
                            except kv.StoreError:
                                pass
                    i += 1

            threading.Thread(target=churn_loop, daemon=True).start()
        elif opcode == "nodeStorm":
            # seeded topology churn (ChurnStormSchedule + NodeStormDriver):
            # floods node adds / drains / relabels through the informer
            # while pod floods are in flight, stressing the backend's row
            # patches, between-wave compaction and pipelined gen fences.
            # Background thread like churn; stepped at a fixed interval,
            # stopped at end-of-workload with the same stop-event list.
            from ..ops.faults import ChurnStormSchedule, NodeStormDriver
            storm_sched = ChurnStormSchedule(
                seed=op.get("seed", 0),
                add_rate=op.get("addRate", 0.0),
                drain_rate=op.get("drainRate", 0.0),
                relabel_rate=op.get("relabelRate", 0.0))
            prefix = op.get("nodeNamePrefix", "node-")
            driver = NodeStormDriver(
                cluster.client, storm_sched,
                [f"{prefix}{i}" for i in range(created_nodes)],
                min_nodes=op.get("minNodes", max(1, created_nodes // 2)),
                max_nodes=op.get("maxNodes", max(4, created_nodes * 2)),
                cpu=op.get("cpu", "32"), mem=op.get("memory", "256Gi"),
                rack_labels=op.get("rackLabels", 0))
            storm_drivers.append(driver)
            ev = threading.Event()
            churn_stop.append(ev)
            interval = op.get("intervalMilliseconds", 50) / 1000.0
            max_steps = op.get("steps", 0)

            def storm_loop(ev=ev, driver=driver, interval=interval,
                           max_steps=max_steps):
                while not ev.wait(interval):
                    if max_steps and driver.steps >= max_steps:
                        return
                    driver.step()

            threading.Thread(target=storm_loop, daemon=True).start()
        else:
            raise ValueError(f"unknown opcode {opcode!r}")
    for ev in churn_stop:
        ev.set()
    stats["created_pods"] = created_pods
    stats["created_nodes"] = created_nodes
    if storm_drivers:
        stats["storm"] = {
            "steps": sum(d.steps for d in storm_drivers),
            "injected": {k: sum(d.injected[k] for d in storm_drivers)
                         for k in storm_drivers[0].injected},
            "live_nodes": sum(len(d._names) for d in storm_drivers),
        }
    return stats


def run_named_workload(config: dict, caps=None,
                       batch_size: int = 512, pipeline_depth: int = 1,
                       admission_interval: float = 0.0,
                       via_http: bool = False,
                       null_device: bool = False,
                       percentage_of_nodes_to_score: int = 0,
                       remote_seam: str | None = None,
                       backend_kind: str = "tpu",
                       tracing_provider=None,
                       overload=None,
                       chaos_schedule=None,
                       profiling_policy=None,
                       device_flight_s: float = 0.0,
                       device=None, mesh=None,
                       store: kv.MemoryStore | None = None,
                       after=None
                       ) -> tuple[ThroughputSummary, dict]:
    """Run one workload config end to end; returns (throughput, stats).
    `device` goes to the batch backend (CUDA unless the caller names the
    CPU), `mesh` to the sharded one (backend_kind="sharded").  Pass `store` to read the cluster's objects after the run (the
    cluster shuts down before this returns); `after(cluster)` runs once
    the stats are read, before the shutdown.  Outside the measured window:
    stats["setup_s"] is setup_cluster's wall time (backend build and
    warmup, informer sync), stats["create_nodes_s"] that of the
    createNodes ops, stats["flatten_before_window_s"] the backend's
    snapshot flatten seconds until the window opened."""
    t_setup = time.monotonic()
    cluster = setup_cluster(
        store=store, device=device, mesh=mesh,
        caps=caps, batch_size=batch_size,
        pipeline_depth=pipeline_depth,
        admission_interval=admission_interval,
        via_http=via_http, null_device=null_device,
        percentage_of_nodes_to_score=percentage_of_nodes_to_score,
        remote_seam=remote_seam, backend_kind=backend_kind,
        tracing_provider=tracing_provider,
        overload=overload, chaos_schedule=chaos_schedule,
        profiling_policy=profiling_policy,
        device_flight_s=device_flight_s)
    setup_s = time.monotonic() - t_setup
    collector = ThroughputCollector(cluster.store)
    try:
        ops = config["workloadTemplate"]
        t0 = time.monotonic()
        # The collector starts AT the first createPods op, not here: the
        # reference runs its throughputCollector only while the measured
        # createPods op is in flight (scheduler_perf_test.go:716-751,
        # CollectMetrics gates collector run/cancel around createPods +
        # waitUntil), so node-preparation floods are outside the window.
        stats = run_workload(cluster, ops, collector)
        if not collector.started:  # no createPods op in workload
            collector.start()
        summary = collector.stop()
        stats["wall"] = time.monotonic() - t0
        stats["setup_s"] = setup_s
        stats["e2e"] = cluster.scheduler.metrics.e2e_summary(
            since=stats.get("e2e_mark", 0))
        with cluster.scheduler.metrics.lock:
            stats["schedule_attempts"] = dict(
                cluster.scheduler.metrics.schedule_attempts)
        if cluster.scheduler.metrics.preemption_attempts:
            stats["preemption_attempts"] = (
                cluster.scheduler.metrics.preemption_attempts)
        from ..utils import stagelat
        if stagelat.ENABLED:
            stats["stage_latency"] = stagelat.summary()
            stagelat.reset()  # don't bleed into the next workload
        if tracing_provider is not None and cluster.worker is not None:
            # worker-side spans (parented into the client trace through
            # the propagated traceparent), for the Chrome export
            stats["worker_spans"] = cluster.worker.tracer_provider.snapshot()
        for p in cluster.scheduler.profiles.values():
            if p.batch_backend is not None:
                stats["backend_stats"] = dict(p.batch_backend.stats)
                pods = stats["backend_stats"].get("pods", 0)
                esc = stats["backend_stats"].get("escaped", 0)
                if pods:
                    stats["escape_rate"] = round(esc / pods, 4)
                injected = getattr(p.batch_backend, "injected", None)
                if injected is not None:  # ChaosBatchBackend wrapper
                    stats["chaos_injected"] = dict(injected)
                maint_fn = getattr(p.batch_backend,
                                   "maintenance_snapshot", None)
                if maint_fn is not None:
                    # incremental-flatten readout: patched-vs-reflattened
                    # wave counts + the snapshot.patch / snapshot.flatten
                    # host seconds every BENCH row reports
                    stats["tensor_maintenance"] = maint_fn()
                break
        if profiling_policy is not None and (profiling_policy.enabled
                                             or profiling_policy.census):
            # the performance-observatory read-out bench --profile emits
            # as the PROFILE artifact: per-stage host attribution, the
            # device census, and the SLO window view
            sched = cluster.scheduler
            if sched._profiler is not None:
                sched._profiler.stop()
                stats["host_stages"] = sched._profiler.stage_seconds()
                stats["profile_samples"] = sched._profiler.samples_total()
                stats["hot_stacks"] = sched._profiler.top_stacks(10)
            if sched._census:
                stats["device_census"] = sched._census
            if sched._slo is not None:
                stats["slo"] = {
                    **sched._slo.quantiles(),
                    "burn_rates": sched._slo.burn_rates(),
                }
        if profiling_policy is not None and profiling_policy.timeline:
            # wave-timeline read-out: expose_metrics drains the worker
            # seam (remote backend) into the ring and refreshes the
            # union-derived gauges, then the summary + per-segment
            # quantiles land in the BENCH row
            sched = cluster.scheduler
            sched.expose_metrics()
            tl = sched._timeline
            if tl is not None:
                stats["timeline"] = {
                    **tl.snapshot_summary(),
                    "pods_decomposed": len(tl.pods()),
                    "segments": sched.metrics.segment_summary(),
                }
        if overload is not None:
            cluster.scheduler.expose_metrics()  # drain shed/defer tallies
            prom = cluster.scheduler.metrics.prom
            tuner = cluster.scheduler._wave_tuner
            stats["overload"] = {
                "shed": {f"{r}/{b}": v for (r, b), v
                         in prom.queue_shed_total.values().items()},
                "deferred": sum(
                    prom.overload_deferred_total.values().values()),
                "wave_cancels": sum(
                    prom.overload_wave_cancel_total.values().values()),
                "final_wave": (tuner.current() if tuner is not None
                               else batch_size),
                "engagement": cluster.scheduler.overload_engagement,
                "transitions": {
                    f"{f}->{t}/{r}": v for (f, t, r), v
                    in prom.overload_transition_total.values().items()},
            }
        if after is not None:
            after(cluster)
        return summary, stats
    finally:
        cluster.shutdown()
