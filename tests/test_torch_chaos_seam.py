"""The port's fault-tolerant remote seam (ops/remote.py, ops/faults.py,
ops/failover.py) under tests/test_chaos_seam.py's seeded faults, held
against the JAX package's on the CPU.

Each transport-fault and restart case runs the same schedule through the
port's RemoteTorchBatchBackend on a port worker (device="cpu",
claims_noise="murmur") and through the JAX package's
RemoteTPUBatchBackend on its own worker (KTPU_PALLAS=0), over HTTP and
over gRPC: the (node, status) lists, the faults that fired and the
client's seam counters (retries, resyncs, state lost, corrupt frames,
give-ups) must be the same, and equal to an in-process backend's
placements where the JAX test holds them to that.  The failover ladder's
cases run one script against both packages' FailoverBatchBackend and
compare every breaker transition and counter; the scheduler's requeue,
the remoteSeam stanza and the seeded chaotic weather run on the port.

Every worker is stopped in a fixture finalizer and every test runs under
a deadline (SIGALRM).
"""

import signal
import time

import pytest

pytest.importorskip("jax")
pytest.importorskip("grpc")

from kubernetes_tpu.ops import failover as jax_failover  # noqa: E402
from kubernetes_tpu.ops import faults as jax_faults  # noqa: E402
from kubernetes_tpu.scheduler import scheduler as jax_scheduler  # noqa: E402
from kubernetes_tpu_torch.api import meta  # noqa: E402
from kubernetes_tpu_torch.client import (  # noqa: E402
    LocalClient, SharedInformerFactory,
)
from kubernetes_tpu_torch.client.clientset import NODES, PODS  # noqa: E402
from kubernetes_tpu_torch.ops import failover as port_failover  # noqa: E402
from kubernetes_tpu_torch.ops import faults as port_faults  # noqa: E402
from kubernetes_tpu_torch.ops.backend import TorchBatchBackend  # noqa: E402
from kubernetes_tpu_torch.ops.flatten import Caps  # noqa: E402
from kubernetes_tpu_torch.ops.remote import WorkerProtocolError  # noqa: E402
from kubernetes_tpu_torch.scheduler import (  # noqa: E402
    Profile, Scheduler, new_default_framework,
)
from kubernetes_tpu_torch.scheduler import scheduler as port_scheduler  # noqa: E402,E501
from kubernetes_tpu_torch.scheduler.config import (  # noqa: E402
    ConfigError, RemoteSeamPolicy, load_config,
)
from kubernetes_tpu_torch.store import kv  # noqa: E402
from test_torch_remote import CAPS, PKGS, outcome  # noqa: E402

DEADLINE_S = 150
FAULTS = {"port": port_faults, "jax": jax_faults}


@pytest.fixture(autouse=True)
def deadline():
    def expire(*_a):
        raise TimeoutError(f"seam test exceeded {DEADLINE_S} s")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture(autouse=True)
def pallas_off(monkeypatch):
    monkeypatch.setenv("KTPU_PALLAS", "0")


def fast_policy(pkg="port", **kw):
    kw.setdefault("retry_base", 0.005)
    kw.setdefault("retry_max", 0.05)
    if pkg == "jax":
        from kubernetes_tpu.scheduler.config import RemoteSeamPolicy as P
        return P(**kw)
    return RemoteSeamPolicy(**kw)


@pytest.fixture(params=["http", "grpc"])
def kind(request):
    return request.param


@pytest.fixture
def workers(kind):
    """A private port worker and JAX worker per test (kills mint new
    epochs)."""
    started = {}
    try:
        for name, pkg in PKGS.items():
            started[name] = pkg.worker(kind)
        yield started
    finally:
        for w in started.values():
            w.stop()


def kill_on_nth_step(faults, n):
    """tests/test_chaos_seam.py's KillOnNthStep, on `faults`'s
    FaultSchedule: restart the worker right before its Nth /step."""

    class KillOnNthStep(faults.FaultSchedule):
        def __init__(self):
            super().__init__()
            self.steps = 0
            self.fired = False

        def action(self, call_index, verb):
            if verb.startswith("/step"):
                self.steps += 1
                if self.steps == n and not self.fired:
                    self.fired = True
                    self.rng.random()  # one draw per call
                    return faults.KILL
            return super().action(call_index, verb)
    return KillOnNthStep()


def faulty(name, worker, schedule, **kw):
    """(client, transport) of package `name` behind FaultyTransport."""
    pkg = PKGS[name]
    transport = FAULTS[name].FaultyTransport(
        pkg.remote.transport_for(worker.url), schedule,
        on_kill=worker.simulate_restart)
    kw.setdefault("policy", fast_policy(name))
    return pkg.client(worker.url, transport=transport, **kw), transport


def both(workers, make_schedule, run, **kw):
    """Run `run(pkg, client)` on both packages under their own copy of the
    schedule; returns {name: (result, injected, seam_stats)}."""
    out = {}
    for name, pkg in PKGS.items():
        client, transport = faulty(name, workers[name],
                                   make_schedule(FAULTS[name]), **kw)
        try:
            out[name] = (run(pkg, client), dict(transport.injected),
                         dict(client.seam_stats))
        finally:
            client.close()
    return out


def nodes(pkg, n, cpu="4", mem="16Gi", prefix="n"):
    return [pkg.testing.make_node(f"{prefix}{i}").capacity(cpu=cpu, mem=mem)
            .build() for i in range(n)]


def spread_pods(pkg, n=12):
    return [pkg.testing.make_pod(f"s{i}").labels(app="web").req(cpu="100m")
            .topology_spread("topology.kubernetes.io/zone", max_skew=2,
                             match_labels={"app": "web"}).build()
            for i in range(n)]


def zone_nodes(pkg, n=9):
    return [pkg.testing.make_node(f"z{i}").zone("abc"[i % 3])
            .capacity(cpu="8", mem="32Gi").build() for i in range(n)]


def local_outcome(pods_fn, nodes_fn, **kw):
    pkg = PKGS["port"]
    local = TorchBatchBackend(Caps(**CAPS), device="cpu",
                              claims_noise="murmur", **kw)
    return outcome(local.assign(pkg.infos(pods_fn(pkg)),
                                pkg.snapshot(nodes_fn(pkg))))


class TestTransportFaults:
    def test_drops_are_retried_transparently(self, workers):
        """Scripted drops on the static/refresh path: the bounded retry
        absorbs them; placements equal an in-process run's."""
        def pods(pkg):
            return [pkg.testing.make_pod(f"p{i}").req(cpu="500m",
                                                      mem="512Mi").build()
                    for i in range(16)]

        def run(pkg, client):
            return outcome(client.assign(pkg.infos(pods(pkg)),
                                         pkg.snapshot(nodes(pkg, 8))))
        got = both(workers, lambda f: f.FaultSchedule(
            script={1: f.DROP, 2: f.DROP, 4: f.DROP}), run)
        assert got["port"] == got["jax"]
        res, injected, stats = got["port"]
        assert res == local_outcome(pods, lambda p: nodes(p, 8),
                                    batch_size=256)
        assert injected["drop"] == 3
        assert stats["retries"] >= 3 and stats["giveups"] == 0

    def test_delays_within_deadline_are_harmless(self, workers):
        def run(pkg, client):
            return outcome(client.assign(pkg.infos(
                [pkg.testing.make_pod(f"d{i}").req(cpu="100m").build()
                 for i in range(8)]), pkg.snapshot(nodes(pkg, 4))))
        got = both(workers, lambda f: f.FaultSchedule(
            seed=7, delay_rate=0.5, delay_s=0.005), run)
        assert got["port"] == got["jax"]
        assert all(n is not None for n, _c in got["port"][0])
        assert got["port"][1]["delay"] > 0

    def test_corrupt_frame_detected_and_retry_dedups(self, workers):
        """A corrupted /step response trips the CRC check; the retry
        carries the same seq, so the worker serves its cached response
        without re-applying the step."""
        def run(pkg, client):
            snap = pkg.snapshot([pkg.testing.make_node("solo").capacity(
                cpu="2", mem="8Gi").build()])
            return [outcome(client.assign(pkg.infos(
                [pkg.testing.make_pod(p).req(cpu=c).build()]), snap))
                for p, c in (("c0", "1500m"), ("c1", "400m"))]
        got = both(workers, lambda f: f.FaultSchedule(script={3: f.CORRUPT}),
                   run)
        assert got["port"] == got["jax"]
        res, injected, stats = got["port"]
        assert res[0][0][0] == "solo" and res[1][0][0] == "solo"
        assert injected["corrupt"] == 1 and stats["corrupt_frames"] == 1

    def test_malformed_step_is_a_clean_client_error(self, workers):
        """A malformed /step body: a structured, non-retryable client
        error; the worker keeps serving."""
        pkg = PKGS["port"]
        client = pkg.client(workers["port"].url, policy=fast_policy())
        try:
            with pytest.raises(WorkerProtocolError):
                client._post("/step?variant=full", b"\x01\x02\x03")
            with pytest.raises(WorkerProtocolError):
                client._post("/step?variant=plain", b"\x00" * 8)
            assert client.seam_stats["retries"] == 0
            out = client.assign(pkg.infos([pkg.testing.make_pod("ok").req(
                cpu="100m").build()]), pkg.snapshot(nodes(pkg, 1, prefix="m")))
            assert out[0][0] == "m0"
        finally:
            client.close()

    def test_unreachable_worker_exhausts_into_unavailable(self):
        """Retries against a dead address give up, promptly, with the
        scheduler-visible BackendUnavailableError subclass."""
        for name, pkg in PKGS.items():
            sched = port_scheduler if name == "port" else jax_scheduler
            with pytest.raises(sched.BackendUnavailableError):
                pkg.client("http://127.0.0.1:9", policy=fast_policy(
                    name, max_retries=2, init_timeout=0.5))


class TestRestartResync:
    def test_kill_mid_stream_resyncs_bit_identical(self, workers):
        """Kill and restart the worker between the chunks of a batch: the
        client resyncs (init, static, refresh, the journal) and the
        placements equal an uninterrupted in-process run's."""
        def run(pkg, client):
            return outcome(client.assign(pkg.infos(spread_pods(pkg)),
                                         pkg.snapshot(zone_nodes(pkg))))
        got = both(workers, lambda f: kill_on_nth_step(f, 2), run,
                   batch_size=16, full_batch_cap=4)
        assert got["port"] == got["jax"]
        res, injected, stats = got["port"]
        assert injected["kill"] == 1
        assert stats["resyncs"] >= 1 and stats["state_lost"] >= 1
        assert res == local_outcome(spread_pods, zone_nodes, batch_size=16,
                                    full_batch_cap=4)

    def test_ns_selector_tensors_round_trip_with_kill(self, workers):
        """The namespace tensors (per-pod ids in the packed buffer, the
        per-group masks in /static) survive a kill and resync: placements
        equal the in-process backend's fed the same namespace events, with
        no escape."""
        namespaces = [
            {"metadata": {"name": "ns-dev-a", "labels": {"team": "dev"}}},
            {"metadata": {"name": "ns-dev-b", "labels": {"team": "dev"}}},
            {"metadata": {"name": "ns-ops", "labels": {"team": "ops"}}},
        ]

        def anti_pod(pkg, name, ns):
            p = pkg.testing.make_pod(name, ns).labels(color="green").req(
                cpu="100m").build()
            p["spec"]["affinity"] = {"podAntiAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [
                    {"topologyKey": "kubernetes.io/hostname",
                     "labelSelector": {"matchLabels": {"color": "green"}},
                     "namespaceSelector": {"matchLabels": {
                         "team": "dev"}}}]}}
            return p

        ns_cycle = ["ns-dev-a", "ns-dev-b", "ns-ops", "default"]

        def run_on(pkg, backend):
            for ns in namespaces:
                backend.note_namespace_event("ADDED", ns)
            snap = pkg.snapshot([pkg.testing.make_node(f"h{i}").labels(
                **{"kubernetes.io/hostname": f"h{i}"}).capacity(
                cpu="8", mem="32Gi").build() for i in range(6)])
            out = [outcome(backend.assign(pkg.infos(
                [anti_pod(pkg, f"{b}{i}", ns_cycle[i % 4])
                 for i in range(4)]), snap)) for b in "ab"]
            return out, backend.drain_escape_reasons()

        got = both(workers, lambda f: kill_on_nth_step(f, 2), run_on,
                   batch_size=8)
        assert got["port"] == got["jax"]
        (res, escapes), injected, stats = got["port"]
        assert injected["kill"] == 1 and stats["resyncs"] >= 1
        local = TorchBatchBackend(Caps(**CAPS), batch_size=8, device="cpu",
                                  claims_noise="murmur")
        assert (res, escapes) == run_on(PKGS["port"], local)
        assert escapes == {}

    def test_kill_mid_preemption_wave_resyncs_bit_identical(self, workers):
        """The worker dies right before a /preempt post: the client
        replays the victim-carrying static checkpoint and the refresh,
        and the dry run's decisions equal an in-process run's."""
        def make(f):
            class KillOnFirstPreempt(f.FaultSchedule):
                injectable = True

                def action(self, call_index, verb):
                    self.rng.random()
                    if verb == "/preempt" and self.injectable:
                        self.injectable = False
                        return f.KILL
                    return f.NONE
            return KillOnFirstPreempt()

        def run_on(pkg, backend):
            cache = pkg.cache_mod.Cache()
            for n in nodes(pkg, 4, cpu="2", mem="8Gi", prefix="pn"):
                cache.add_node(n)
            for i in range(8):
                cache.add_pod(pkg.testing.make_pod(f"pv{i}").priority(1)
                              .req(cpu="700m").node(f"pn{i % 4}").build())
            snap = cache.update_snapshot(pkg.cache_mod.Snapshot())
            backend.assign([], snap)
            pre = pkg.infos([pkg.testing.make_pod(f"pp{j}").priority(10)
                             .req(cpu="1600m").build() for j in range(3)])
            order = {ni.name: i for i, ni in enumerate(snap.list())}
            return backend.preempt_batch(pre, order)

        got = both(workers, make, run_on)
        assert got["port"] == got["jax"]
        (res, esc), injected, stats = got["port"]
        assert injected["kill"] == 1 and stats["resyncs"] >= 1
        assert esc == {} and all(r is not None for r in res)
        local = TorchBatchBackend(Caps(**CAPS), batch_size=8, device="cpu",
                                  claims_noise="murmur")
        assert (res, esc) == run_on(PKGS["port"], local)

    def test_kill_then_more_batches_keep_chaining(self, workers):
        """Claims committed before and replayed after the kill constrain
        later batches."""
        def run(pkg, client):
            snap = pkg.snapshot([pkg.testing.make_node("small").capacity(
                cpu="1", mem="2Gi").build()])
            return [outcome(client.assign(pkg.infos(
                [pkg.testing.make_pod(p).req(cpu="800m").build()]), snap))
                for p in ("a", "b")]
        got = both(workers, lambda f: kill_on_nth_step(f, 2), run,
                   batch_size=4)
        assert got["port"] == got["jax"]
        res, _inj, stats = got["port"]
        assert res[0][0][0] == "small" and res[1][0][0] is None
        assert stats["resyncs"] >= 1


# -- the failover ladder: one script, both packages --------------------------

def stub_rung(pkg_name, node="fb-0"):
    sched = port_scheduler if pkg_name == "port" else jax_scheduler

    class StubRung(sched.BatchBackend if pkg_name == "jax"
                   else port_failover.BatchBackend):
        """Fails the next N dispatches, then assigns every pod to `node`."""

        def __init__(self):
            self.node = node
            self.fail_next = 0
            self.healthy = True
            self.dispatches = 0
            self.stats = {"batches": 0}

        def health(self):
            if not self.healthy:
                raise RuntimeError("stub rung down")
            return {"ok": True}

        def dispatch(self, pod_infos, snapshot):
            self.dispatches += 1
            if self.fail_next > 0:
                self.fail_next -= 1
                raise sched.BackendUnavailableError("injected rung failure")
            results = [(self.node, None) for _ in pod_infos]
            self.stats["batches"] += 1
            return lambda: results
    return StubRung()


def ladder_trace(pkg_name, script):
    """Run `script(ladder, a, b, step)` on package `pkg_name`'s ladder;
    `step(label)` records the breakers and counters."""
    failover = port_failover if pkg_name == "port" else jax_failover
    sched = port_scheduler if pkg_name == "port" else jax_scheduler
    trace = []

    def make(**kw):
        a, b = stub_rung(pkg_name, "a0"), stub_rung(pkg_name, "b0")
        return failover.FailoverBatchBackend(
            [("remote", a), ("inproc", b)], **kw), a, b

    def step(ladder, label, result=None):
        trace.append((label, ladder.breaker_state(),
                      dict(ladder.seam_stats), result))

    script(make, step, sched.BackendUnavailableError)
    return trace


def opens_and_fails_over(make, step, unavailable):
    ladder, a, _b = make(failure_threshold=2, probe_interval=100.0)
    a.fail_next = 2
    for i in range(2):
        with pytest.raises(unavailable):
            ladder.dispatch([1], None)
        step(ladder, f"fail {i}")
    out = ladder.dispatch([1, 2], None)()
    step(ladder, "served", [n for n, _ in out])
    step(ladder, "remote dispatches", a.dispatches)


def probes_and_recloses(make, step, unavailable):
    ladder, a, _b = make(failure_threshold=1, probe_interval=0.03)
    a.fail_next, a.healthy = 1, False
    with pytest.raises(unavailable):
        ladder.dispatch([1], None)
    step(ladder, "opened")
    time.sleep(0.05)
    step(ladder, "down probe", ladder.dispatch([1], None)()[0][0])
    a.healthy = True
    time.sleep(0.05)
    step(ladder, "failed back", ladder.dispatch([1], None)()[0][0])


def all_open_degrades(make, step, unavailable):
    ladder, a, b = make(failure_threshold=1, probe_interval=100.0)
    a.fail_next, b.fail_next = 1, 1
    for i in range(2):
        with pytest.raises(unavailable):
            ladder.dispatch([1], None)
        step(ladder, f"fail {i}")
    out = ladder.dispatch([1, 2, 3], None)()
    step(ladder, "oracle", [(n, s.is_skip()) for n, s in out])
    step(ladder, "snapshot", ladder.seam_snapshot())


def resolve_failure_counts(make, step, unavailable):
    ladder, a, _b = make(failure_threshold=1, probe_interval=100.0)

    def boom():
        raise unavailable("resolve-side failure")
    a.dispatch = lambda pods, snap: boom
    with pytest.raises(unavailable):
        ladder.dispatch([1], None)()
    step(ladder, "after resolve failure")


LADDER = {f.__name__: f for f in (opens_and_fails_over, probes_and_recloses,
                                  all_open_degrades,
                                  resolve_failure_counts)}


@pytest.mark.parametrize("name", sorted(LADDER))
def test_failover_ladder_matches_reference(name):
    port = ladder_trace("port", LADDER[name])
    assert port == ladder_trace("jax", LADDER[name])
    if name == "opens_and_fails_over":
        assert port[1][1] == {"remote": 1.0, "inproc": 0.0}
        assert port[2][3] == ["b0", "b0"] and port[3][3] == 2
    elif name == "probes_and_recloses":
        assert port[1][3] == "b0" and port[1][2]["failed_probes"] >= 1
        assert port[2][3] == "a0" and port[2][1]["remote"] == 0.0
    elif name == "all_open_degrades":
        assert port[2][3] == [(None, True)] * 3
        assert port[3][3]["failovers"] == 2
    else:
        assert port[0][1]["remote"] == 1.0


def test_ladder_forwards_to_the_active_rung():
    """Telemetry, escapes and stats reach the rungs as the JAX ladder
    sends them; the census kind follows the active rung."""
    pkg = PKGS["port"]
    local = TorchBatchBackend(Caps(**CAPS), batch_size=8, device="cpu",
                              claims_noise="murmur")
    ladder = port_failover.FailoverBatchBackend([("inproc", local)])
    snap = pkg.snapshot(nodes(pkg, 2))
    ladder.assign(pkg.infos([pkg.testing.make_pod("f0").req(
        cpu="100m").build()]), snap)
    assert [t["pods"] for t in ladder.drain_batch_telemetry()] == [1]
    assert ladder.drain_escape_reasons() == {}
    assert ladder.census_kind == "failover-torch"
    assert ladder.stats["batches"] == 1


# -- the scheduler and the config ---------------------------------------------

def wait_for(pred, timeout=60.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


class TestSchedulerRequeue:
    def test_failed_batches_reenter_backoff_and_still_bind(self):
        """A backend that fails twice: the pods re-enter the backoff tier
        and bind once it recovers, none dropped or marked
        unschedulable."""
        store = kv.MemoryStore()
        client = LocalClient(store)
        factory = SharedInformerFactory(client)
        fw = new_default_framework(client, factory)
        flaky = stub_rung("port")
        flaky.fail_next = 2
        sched = Scheduler(client, factory, {"default-scheduler": Profile(
            fw, batch_backend=flaky, batch_size=8)})
        sched.queue._initial_backoff = 0.05
        sched.queue._max_backoff = 0.2
        factory.start()
        factory.wait_for_cache_sync()
        sched.run()
        try:
            client.create(NODES, PKGS["port"].testing.make_node("fb-0")
                          .capacity(cpu="8", mem="32Gi").build())
            for i in range(5):
                client.create(PODS, PKGS["port"].testing.make_pod(f"fb{i}")
                              .req(cpu="100m").build())
            assert wait_for(lambda: all(
                meta.pod_node_name(p)
                for p in client.list(PODS, "default")[0]), timeout=30)
            assert sched.metrics.prom.tpu_seam_events.value(
                "batch_failures") == 2.0
            assert sched.metrics.prom.tpu_seam_events.value(
                "requeued_pods") > 0
        finally:
            sched.stop()
            factory.stop()


class TestSeamPolicyConfig:
    def test_remote_seam_stanza_parses(self):
        cfg = load_config({
            "apiVersion": "kubescheduler.config.k8s.io/v1",
            "kind": "KubeSchedulerConfiguration",
            "remoteSeam": {"stepTimeoutSeconds": 7.5, "maxRetries": 5,
                           "retryBaseSeconds": 0.01, "failureThreshold": 4,
                           "probeIntervalSeconds": 1.0, "journalCap": 64},
        })
        p = cfg.remote_seam
        assert (p.step_timeout, p.init_timeout, p.max_retries,
                p.failure_threshold, p.journal_cap) == (7.5, 120.0, 5, 4, 64)

    def test_unknown_seam_key_rejected(self):
        with pytest.raises(ConfigError):
            load_config({"apiVersion": "kubescheduler.config.k8s.io/v1",
                         "kind": "KubeSchedulerConfiguration",
                         "remoteSeam": {"stepDeadline": 7.5}})

    def test_policy_backoff_bounded(self):
        import random
        p = RemoteSeamPolicy(retry_base=0.1, retry_max=1.0, retry_jitter=0.5)
        rng = random.Random(0)
        delays = [p.backoff(a, rng) for a in range(1, 12)]
        assert all(0.0 <= d <= 1.5 for d in delays) and delays[0] < 1.0

    def test_legacy_timeout_arg_still_respected(self, workers):
        client = PKGS["port"].client(workers["port"].url, timeout=33.0)
        try:
            assert client.timeout == 33.0
            assert client.policy.step_timeout == 33.0
            assert client.policy.init_timeout == 33.0
        finally:
            client.close()


def test_full_scheduler_through_seeded_chaos(workers):
    """tests/test_chaos_seam.py's storm on the port: seeded drops, delays
    and corrupt frames and one worker kill under a live Scheduler.  Every
    pod binds, no node is over-committed (a double binding would overflow
    one), the kill fired and the client resynced."""
    schedule = kill_on_nth_step(port_faults, 3)
    schedule.drop_rate = 0.10
    schedule.delay_rate = 0.25
    schedule.corrupt_rate = 0.08
    schedule.delay_s = 0.003
    backend, transport = faulty("port", workers["port"], schedule,
                                batch_size=8,
                                policy=fast_policy(max_retries=6))
    store = kv.MemoryStore()
    client = LocalClient(store)
    factory = SharedInformerFactory(client)
    fw = new_default_framework(client, factory)
    sched = Scheduler(client, factory, {"default-scheduler": Profile(
        fw, batch_backend=backend, batch_size=8)})
    sched.queue._initial_backoff = 0.05
    factory.start()
    factory.wait_for_cache_sync()
    sched.run()
    try:
        for i in range(4):
            client.create(NODES, PKGS["port"].testing.make_node(f"cw-{i}")
                          .capacity(cpu="10", mem="40Gi").build())
        for i in range(40):
            client.create(PODS, PKGS["port"].testing.make_pod(f"cp{i}")
                          .req(cpu="1").build())
        assert wait_for(lambda: all(
            meta.pod_node_name(p)
            for p in client.list(PODS, "default")[0]), timeout=120)
        per_node: dict = {}
        for p in client.list(PODS, "default")[0]:
            per_node[meta.pod_node_name(p)] = per_node.get(
                meta.pod_node_name(p), 0) + 1
        assert all(v <= 10 for v in per_node.values()), per_node
        assert sum(per_node.values()) == 40
        assert transport.injected["kill"] == 1
        assert backend.seam_stats["resyncs"] >= 1
    finally:
        sched.stop()
        factory.stop()
        backend.close()
