"""In-process scale-out in the port (scheduler/scaleout.py, the scale-out
half of ops/faults.py, Scheduler.configure_scaleout, perf.bench's
--instances) held against the JAX package on the CPU.

  (a) ScaleOutCoordinator: the same policies, keys, lease tables and clock
      give the same owns_pod / owns_node / live / self_live / set_live /
      sweep / tick answers and the same Lease objects in the store, for
      every instance_count 1-4 and both partition_by modes, through
      failover, retire / revive and the boot grace.  The clock is a
      now_fn and every tick names its `now`.
  (b) ScaleOutSchedule and InstanceChurner: the same seeds and scripts make
      the same decisions, log and injected counts.
  (c) Two instances per package over one store, the loop thread not
      started: each instance pops and schedules its batch in a fixed
      order; the JAX side holds TPUBatchBackend at KTPU_PALLAS=0, the
      port TorchBatchBackend(device="cpu", claims_noise="murmur").  Every
      pod's spec.nodeName and PodScheduled reason are identical in the two
      stores, also when instance 0 is retired and its wave is fenced into
      backoff.
  (d) Live loops, shrunk as in tests/test_scaleout.py: the port's
      instances (batch profile on the CPU, and the per-pod profile) beside
      the JAX package's per-pod instances on the same script: a steady
      state with no conflict, a failover mid-wave, kill then revive, and
      namespaceHash under a retire; no pod bound twice or lost in either
      package, the same churn log, and in the steady state the same
      instance placing each pod.  Each test has a SIGALRM deadline.
  (e) run_scaleout(2, device="cpu") at a small size binds every pod and
      returns bench.py's keys.
Then the port's one addition, which the JAX package lacks: while the
loop runs, the coordinator renews its lease from a thread of its own
(scheduler/scaleout.py "Lease renewal"), so a loop iteration longer than
the lease does not lapse a live instance, while a loop stalled past
LOOP_STALL_LEASES leases still fails over; both held against the JAX
package's loop-only renewal on a hand clock.
"""

import importlib
import itertools
import signal
import time

import pytest

pytest.importorskip("jax")

from torch_cases import (  # noqa: E402
    LOOP_CAPS, PORT_PKG as PORT, mixed_nodes, mixed_pods, record_scaleout,
    wait_for,
)

JAX = "kubernetes_tpu"
PKGS = (JAX, PORT)
DEADLINE_S = 120


def m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def policy(pkg, index, count, **kw):
    return m(pkg, "scheduler.config").ScaleOutPolicy(
        instance_count=count, instance_index=index, **kw)


def coordinator(pkg, index, count, now_fn=None, **kw):
    so = m(pkg, "scheduler.scaleout")
    return so.ScaleOutCoordinator(policy(pkg, index, count, **kw),
                                  **({} if now_fn is None
                                     else {"now_fn": now_fn}))


@pytest.fixture
def deadline():
    """Each test's own deadline: SIGALRM raises in the test's thread."""
    def expire(*_a):
        raise TimeoutError(f"scale-out test exceeded {DEADLINE_S} s")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture
def pallas_off(monkeypatch):
    monkeypatch.setenv("KTPU_PALLAS", "0")


# -- (a) the coordinator ----------------------------------------------------

POD_KEYS = [(ns, f"p-{i}") for ns in ("", "default", "team-a", "kube-system")
            for i in range(50)]
NODE_NAMES = [f"node-{i}" for i in range(120)] + ["sn-0", "ch-7", "z"]


def answers(co):
    return ([co.owns_pod(ns, name) for ns, name in POD_KEYS],
            [co.owns_node(n) for n in NODE_NAMES], co.live, co.self_live,
            co.index)


def test_module_constants_match():
    j, p = m(JAX, "scheduler.scaleout"), m(PORT, "scheduler.scaleout")
    assert (p.LEASE_NAMESPACE, p.LEASE_PREFIX) == (j.LEASE_NAMESPACE,
                                                   j.LEASE_PREFIX)
    for key in [*(f"{ns}/{n}" for ns, n in POD_KEYS), *NODE_NAMES]:
        for slices in (1, 7, 64, 257):
            assert p._slice(key, slices) == j._slice(key, slices)


@pytest.mark.parametrize("mode", ["nodePoolRing", "namespaceHash"])
@pytest.mark.parametrize("count", [1, 2, 3, 4])
def test_ownership_and_failover_match(count, mode):
    """Ownership per instance, then every membership view (each subset of
    the instances, empty included): set_live's answer and every ownership
    answer equal; retire fences at once, revive lifts it."""
    for slices in (64, max(64, 16 * count), 5 + count):
        for i in range(count):
            cos = [coordinator(pkg, i, count, partition_by=mode,
                               ring_slices=slices) for pkg in PKGS]
            assert answers(cos[0]) == answers(cos[1])
            for r in range(count + 1):
                for live in itertools.combinations(range(count), r):
                    changed = [c.set_live(live) for c in cos]
                    assert changed[0] == changed[1], live
                    assert answers(cos[0]) == answers(cos[1]), live
                    assert [c.set_live(live) for c in cos] == [False, False]
            for c in cos:
                c.set_live(range(count))
                c.retire()
            assert answers(cos[0]) == answers(cos[1])
            assert not cos[1].self_live
            for c in cos:
                c.revive()
            assert answers(cos[0]) == answers(cos[1])


def lease_run(pkg, count, mode):
    """A scripted lease table on one store driven by a hand clock: every
    instance ticks, instance 0 retires and lapses, the last instance never
    renews (the boot grace ends for it), instance 0 revives.  Returns
    every tick's answer with the membership and ownership after it, and
    the Lease objects in the store (name, holder, renewTime,
    resourceVersion)."""
    kv, clientset = m(pkg, "store.kv"), m(pkg, "client.clientset")
    client = clientset.LocalClient(kv.MemoryStore())
    clock = [100.0]
    cos = [coordinator(pkg, i, count, now_fn=lambda: clock[0],
                       partition_by=mode, lease_duration=2.0,
                       renew_interval=0.5) for i in range(count)]
    silent = count - 1 if count > 2 else None   # never renews
    trace = []

    def tick_all(t, explicit=True):
        clock[0] = t
        for c in cos:
            if c.index == silent:
                continue
            got = c.tick(client, t) if explicit else c.tick(client)
            trace.append((t, c.index, got, answers(c)))
    for t in (100.0, 100.2, 100.6, 101.1):
        tick_all(t)
    cos[0].retire()
    trace.append(("retired", answers(cos[0])))
    for t in (101.6, 102.1, 102.6, 103.1, 103.6, 104.1):
        tick_all(t, explicit=t > 103.0)
    clock[0] = 104.5
    cos[0].revive()
    trace.append(("revived", answers(cos[0])))
    for t in (104.6, 105.1, 105.6, 108.0):
        tick_all(t)
    leases, _ = client.list(clientset.LEASES)
    table = sorted((l["metadata"]["namespace"], l["metadata"]["name"],
                    l["spec"]["holderIdentity"], l["spec"]["renewTime"],
                    l["metadata"]["resourceVersion"], l["kind"],
                    l["apiVersion"]) for l in leases)
    return trace, table


@pytest.mark.parametrize("mode", ["nodePoolRing", "namespaceHash"])
@pytest.mark.parametrize("count", [1, 2, 3, 4])
def test_lease_ticks_and_table_match(count, mode):
    jt, jl = lease_run(JAX, count, mode)
    pt, pl = lease_run(PORT, count, mode)
    assert pt == jt
    assert pl == jl
    if count > 1:
        # the script did move the membership: a retire lapsed, a revive
        # rejoined
        assert any(step[2] for step in pt if len(step) == 4)
        assert len(pl) == (count if count <= 2 else count - 1)


@pytest.mark.parametrize("pkg", PKGS)
def test_boot_grace_and_sweep(pkg):
    """An instance whose lease never appeared is live for one
    lease_duration after this coordinator's boot (or revive), then dead;
    the answers are the JAX package's at every step."""
    kv, clientset = m(pkg, "store.kv"), m(pkg, "client.clientset")
    client = clientset.LocalClient(kv.MemoryStore())
    clock = [50.0]
    co = coordinator(pkg, 0, 3, now_fn=lambda: clock[0], lease_duration=1.0,
                     renew_interval=0.25)
    steps = []
    for t in (50.0, 50.5, 51.0, 51.01, 51.5):
        steps.append((co.sweep(client, t), co.live))
    co.heartbeat(client, 51.5)
    steps.append((co.sweep(client, 52.0), co.live))
    clock[0] = 60.0
    co.revive()
    steps.append((co.sweep(client, 60.5), co.live))
    steps.append((co.sweep(client, 61.5), co.live))
    assert steps == [(False, (0, 1, 2)), (False, (0, 1, 2)),
                     (False, (0, 1, 2)), (True, ()), (False, ()),
                     (True, (0,)), (True, (1, 2)), (True, ())]


# -- (b) the churners ---------------------------------------------------------

SCHEDULES = [
    dict(seed=0, instance_count=2),
    dict(seed=7, instance_count=3, kill_rate=0.2),
    dict(seed=7, instance_count=3, kill_rate=0.2,
         script={3: ("kill_instance", 1)}),
    dict(seed=11, instance_count=4, kill_rate=0.15, revive_rate=0.25),
    dict(seed=3, instance_count=2, kill_rate=0.5, revive_rate=0.5,
         script={0: ("kill_instance", 0), 5: ("revive_instance", 1),
                 9: ("none", -1)}),
]


@pytest.mark.parametrize("case", range(len(SCHEDULES)))
def test_schedule_decisions_match(case):
    kw = SCHEDULES[case]
    got = [m(pkg, "ops.faults").ScaleOutSchedule(**kw) for pkg in PKGS]
    assert [got[0].action(i) for i in range(400)] == [
        got[1].action(i) for i in range(400)]
    j, p = m(JAX, "ops.faults"), m(PORT, "ops.faults")
    assert (p.KILL_INSTANCE, p.REVIVE_INSTANCE, p.NONE) == (
        j.KILL_INSTANCE, j.REVIVE_INSTANCE, j.NONE)


@pytest.mark.parametrize("min_live", [1, 2])
@pytest.mark.parametrize("case", range(len(SCHEDULES)))
def test_churner_decisions_match(case, min_live):
    """Each package's InstanceChurner over its own coordinators: every
    step's answer, the coordinators' fence after it, the log and the
    injected counts are equal; the min_live floor holds."""
    kw = SCHEDULES[case]
    runs = {}
    for pkg in PKGS:
        faults = m(pkg, "ops.faults")
        cos = [coordinator(pkg, i, kw["instance_count"])
               for i in range(kw["instance_count"])]
        churn = faults.InstanceChurner(cos, faults.ScaleOutSchedule(**kw),
                                       min_live=min_live)
        steps = []
        for _ in range(200):
            steps.append((churn.step(), tuple(c.self_live for c in cos)))
            assert sum(c.self_live for c in cos) >= min(
                min_live, kw["instance_count"])
        runs[pkg] = (steps, churn.log, churn.injected, churn.waves)
    assert runs[PORT] == runs[JAX]
    if case and min_live < kw["instance_count"]:
        assert runs[PORT][1], "the schedule never changed anything"


# -- (c) two instances per package, stepped by hand --------------------------

def build_instances(pkg, count, batch_size, mode="nodePoolRing"):
    """`count` instances of `pkg`'s Scheduler over one MemoryStore, each
    with its own client, informers, framework and batch backend and a
    ScaleOutCoordinator on a still clock (no tick runs: the membership is
    every instance)."""
    kv, client_mod = m(pkg, "store.kv"), m(pkg, "client")
    sched_mod, backends = m(pkg, "scheduler"), m(pkg, "ops.backend")
    so = m(pkg, "scheduler.scaleout")
    caps = m(pkg, "ops.flatten").Caps(**LOOP_CAPS)
    store = kv.MemoryStore()
    out = []
    for i in range(count):
        client = client_mod.LocalClient(store)
        factory = client_mod.SharedInformerFactory(client)
        fw = sched_mod.new_default_framework(client, factory)
        if pkg == JAX:
            backend = backends.TPUBatchBackend(caps, batch_size=batch_size)
        else:
            backend = backends.TorchBatchBackend(
                caps, batch_size=batch_size, device="cpu",
                claims_noise="murmur")
        profile = sched_mod.Profile(fw, batch_backend=backend,
                                    batch_size=batch_size)
        sched = sched_mod.Scheduler(client, factory,
                                    {"default-scheduler": profile})
        sched.configure_scaleout(so.ScaleOutCoordinator(
            policy(pkg, i, count, partition_by=mode), now_fn=lambda: 0.0))
        out.append((sched, factory, profile))
    return store, out


def outcome(pkg, store):
    meta, clientset = m(pkg, "api.meta"), m(pkg, "client.clientset")
    pods, _ = store.list(clientset.PODS)
    out = {}
    for p in pods:
        reason = next((c.get("reason") for c in
                       (p.get("status") or {}).get("conditions") or ()
                       if c.get("type") == "PodScheduled"), None)
        out[meta.name(p)] = (meta.pod_node_name(p) or None, reason)
    return out


def hand_stepped(pkg, retire_first):
    """16 mixed nodes and 40 mixed pods (seeded) in one store, two
    instances on the node-pool ring: each instance's informers hold its
    own slice; instance 0 then instance 1 pop every pod they own and
    schedule it as one batch.  With retire_first instance 0 is retired
    before its batch.  Returns the store's outcome, each instance's owned
    nodes and pods, and instance 0's fenced count and queue."""
    testing, clientset = m(pkg, "testing"), m(pkg, "client.clientset")
    store, insts = build_instances(pkg, 2, 48)
    client = m(pkg, "client").LocalClient(store)
    nodes, pods = mixed_nodes(21, 16)(testing), mixed_pods(22, 40)(testing)
    meta = m(pkg, "api.meta")
    owned = []
    for sched, _f, _p in insts:
        owned.append((
            {meta.name(n) for n in nodes
             if sched.scaleout.owns_node(meta.name(n))},
            {meta.name(p) for p in pods
             if sched.scaleout.owns_pod("default", meta.name(p))}))
    for n in nodes:
        client.create(clientset.NODES, n)
    for p in pods:
        client.create(clientset.PODS, p)
    try:
        for (sched, factory, _p), (my_nodes, my_pods) in zip(insts, owned):
            factory.start()
            factory.wait_for_cache_sync()
            assert wait_for(
                lambda s=sched, n=my_nodes, q=my_pods:
                s.cache.node_count() == len(n)
                and s.queue.stats()["active"] == len(q))
        if retire_first:
            insts[0][0].scaleout.retire()
        for (sched, _f, profile), (_n, my_pods) in zip(insts, owned):
            batch = sched.queue.pop_batch(len(my_pods), timeout=0)
            assert len(batch) == len(my_pods)
            sched.schedule_batch(profile, batch)
    finally:
        for sched, factory, _p in insts:
            sched.stop()    # drains the binder worker inline
            factory.stop()
    first = insts[0][0]
    fenced = first.metrics.prom.bind_conflict_total.value("fenced")
    queued = first.queue.stats()
    return outcome(pkg, store), owned, fenced, queued


@pytest.mark.parametrize("retire_first", [False, True],
                         ids=["steady", "instance-0-fenced"])
def test_hand_stepped_instances_match(pallas_off, retire_first):
    got = {pkg: hand_stepped(pkg, retire_first) for pkg in PKGS}
    (jout, jowned, jfenced, jq), (pout, powned, pfenced, pq) = (
        got[JAX], got[PORT])
    assert powned == jowned
    assert all(nodes and pods for nodes, pods in powned)
    assert pout == jout
    assert pfenced == jfenced
    assert {k: pq.get(k, 0) for k in ("active", "backoff", "unschedulable")
            } == {k: jq.get(k, 0) for k in ("active", "backoff",
                                            "unschedulable")}
    # every placed pod is on a node its own instance owns
    for i, (nodes, pods) in enumerate(powned):
        for name in pods:
            node = pout[name][0]
            if retire_first and i == 0:
                assert node is None, name
            elif node is not None:
                assert node in nodes, (name, node)
    placed = [v for v in pout.values() if v[0]]
    if retire_first:
        assert pfenced == len(powned[0][1]) > 0
        assert pq.get("backoff", 0) == len(powned[0][1])
        assert len(placed) > 0
    else:
        assert pfenced == 0.0 and len(placed) > len(pout) // 2


# -- (d) live loops -------------------------------------------------------------

def live_policy(pkg, index, count, **kw):
    """tests/test_scaleout.py's chaos_policy: 1.5 s leases renewed every
    0.25 s."""
    kw.setdefault("lease_duration", 1.5)
    kw.setdefault("renew_interval", 0.25)
    return policy(pkg, index, count, **kw)


def new_instance(pkg, store, pol, batch):
    """One running instance: the port's with a TorchBatchBackend profile on
    the CPU (batch) or the per-pod profile; the JAX package's per-pod, as
    tests/test_scaleout.py builds it."""
    client_mod, sched_mod = m(pkg, "client"), m(pkg, "scheduler")
    client = client_mod.LocalClient(store)
    factory = client_mod.SharedInformerFactory(client)
    fw = sched_mod.new_default_framework(client, factory)
    if batch:
        caps = m(pkg, "ops.flatten").Caps(**LOOP_CAPS)
        backend = m(pkg, "ops.backend").TorchBatchBackend(
            caps, batch_size=32, device="cpu")
        profile = sched_mod.Profile(fw, batch_backend=backend, batch_size=32)
    else:
        profile = sched_mod.Profile(fw)
    sched = sched_mod.Scheduler(client, factory,
                                {"default-scheduler": profile})
    sched.configure_scaleout(pol)
    factory.start()
    factory.wait_for_cache_sync()
    sched.run()
    return sched, factory


class Ledger:
    """Every nodeName each pod key ever carried, from the store's pod
    history (tests/test_scaleout.py's BindLedger)."""

    def __init__(self, pkg, store):
        self.seen: dict[str, set[str]] = {}
        self._watch = store.watch(m(pkg, "client.clientset").PODS,
                                  since_rv=0)

    def drain(self):
        for ev in self._watch.next_batch(timeout=0.0):
            md = ev.object.get("metadata") or {}
            node = (ev.object.get("spec") or {}).get("nodeName")
            if node:
                self.seen.setdefault(
                    f"{md.get('namespace')}/{md.get('name')}", set()).add(node)
        return self.seen

    def stop(self):
        self._watch.stop()


def bound_pods(pkg, client, namespaces=("default",)):
    meta, clientset = m(pkg, "api.meta"), m(pkg, "client.clientset")
    return {f"{ns}/{meta.name(p)}": meta.pod_node_name(p)
            for ns in namespaces for p in client.list(clientset.PODS, ns)[0]
            if meta.pod_node_name(p)}


def run_churn(pkg, batch, n_instances, n_nodes, n_pods, script, waves,
              seed=0, **policy_kw):
    """tests/test_scaleout.py's run_churn for package `pkg`: n_instances
    over one store, a seeded InstanceChurner stepped once a wave of pods,
    each kill held until every live survivor has swept the victim out,
    every instance revived after the flood.  Proves every pod bound
    exactly once and returns (instances, churner, bound pods, ledger)."""
    kv, testing = m(pkg, "store.kv"), m(pkg, "testing")
    clientset, faults = m(pkg, "client.clientset"), m(pkg, "ops.faults")
    store = kv.MemoryStore(history=1_000_000)
    admin = m(pkg, "client").LocalClient(store)
    ledger = Ledger(pkg, store)
    for i in range(n_nodes):
        admin.create(clientset.NODES, testing.make_node(f"ch-{i}").build())
    instances = [new_instance(pkg, store,
                              live_policy(pkg, i, n_instances, **policy_kw),
                              batch)
                 for i in range(n_instances)]
    churner = faults.InstanceChurner(
        [s.scaleout for s, _ in instances],
        faults.ScaleOutSchedule(seed=seed, instance_count=n_instances,
                                script=script), min_live=1)
    per_wave = max(1, n_pods // waves)
    created = 0
    try:
        for _w in range(waves):
            for _ in range(per_wave):
                if created < n_pods:
                    admin.create(clientset.PODS, testing.make_pod(
                        f"cp-{created}").req(cpu="50m").build())
                    created += 1
            act = churner.step()
            if act and act[0] == faults.KILL_INSTANCE:
                victim = act[1]
                survivors = [s.scaleout for s, _ in instances
                             if s.scaleout.index != victim
                             and s.scaleout.self_live]
                assert wait_for(lambda: all(
                    victim not in so.live for so in survivors)), (
                    f"survivors never observed the death of {victim}")
            ledger.drain()
            time.sleep(0.05)
        while created < n_pods:
            admin.create(clientset.PODS, testing.make_pod(
                f"cp-{created}").req(cpu="50m").build())
            created += 1
        for s, _ in instances:
            s.scaleout.revive()
        assert wait_for(lambda: len(bound_pods(pkg, admin)) == n_pods,
                        timeout=60.0), (
            f"{pkg}: {len(bound_pods(pkg, admin))}/{n_pods} bound; churn "
            f"log {churner.log}")
        seen = ledger.drain()
        moved = {k: v for k, v in seen.items() if len(v) > 1}
        assert not moved, f"{pkg}: pods bound to more than one node: {moved}"
        assert len(seen) == n_pods   # zero lost pods
        return instances, churner, bound_pods(pkg, admin), seen
    finally:
        for s, f in instances:
            s.stop()
            f.stop()
        ledger.stop()


def conflicts(sched):
    return sum(sched.metrics.prom.bind_conflict_total.values().values())


PROFILES = pytest.mark.parametrize("batch", [True, False],
                                   ids=["batch", "per-pod"])


@PROFILES
def test_live_steady_state(deadline, batch):
    """No churn: the partitions schedule side by side with zero conflicts,
    and each pod is placed by the same instance in both packages (on a
    node that instance owns).  Leases of 30 s: no test here waits for a
    lapse, so a loaded machine cannot fence a live instance."""
    runs = {}
    for pkg in PKGS:
        instances, churner, bound, _seen = run_churn(
            pkg, batch and pkg == PORT, 2, 8, 40, {}, 4,
            lease_duration=30.0)
        assert sum(conflicts(s) for s, _ in instances) == 0.0, pkg
        owner = {k: next(s.scaleout.index for s, _ in instances
                         if s.scaleout.owns_node(node))
                 for k, node in bound.items()}
        for k, idx in owner.items():
            assert instances[idx][0].scaleout.owns_pod(*k.split("/")), k
        runs[pkg] = (owner, churner.log)
    assert runs[PORT] == runs[JAX]


@PROFILES
def test_live_failover_mid_wave(deadline, batch):
    """Instance 0 dies after the first wave: the survivor absorbs its ring
    slice (its cache then tracks every node) and every pod lands exactly
    once, in both packages."""
    runs = {}
    for pkg in PKGS:
        instances, churner, bound, _seen = run_churn(
            pkg, batch and pkg == PORT, 2, 8, 60,
            {1: ("kill_instance", 0)}, 6)
        assert churner.injected["kill_instance"] == 1
        have_nodes, _, _ = instances[1][0].cache.comparison_snapshot()
        runs[pkg] = (churner.log, dict(churner.injected), len(have_nodes),
                     sorted(bound))
    assert runs[PORT] == runs[JAX]
    assert runs[PORT][2] == 8


@PROFILES
def test_live_kill_then_revive(deadline, batch):
    runs = {}
    for pkg in PKGS:
        instances, churner, bound, _seen = run_churn(
            pkg, batch and pkg == PORT, 2, 8, 60,
            {1: ("kill_instance", 0), 3: ("revive_instance", 0)}, 6)
        assert churner.injected["kill_instance"] == 1
        assert churner.injected["revive_instance"] == 1
        runs[pkg] = (churner.log, dict(churner.injected), sorted(bound))
    assert runs[PORT] == runs[JAX]


@PROFILES
def test_live_namespace_hash_under_retire(deadline, batch):
    """namespaceHash: pods partition by namespace and both instances see
    every node; instance 0 retires with 30 pods in three namespaces
    pending, and instance 1 binds them all, none twice."""
    runs = {}
    namespaces = ("default", "team-a", "team-b")
    for pkg in PKGS:
        kv, testing = m(pkg, "store.kv"), m(pkg, "testing")
        clientset = m(pkg, "client.clientset")
        store = kv.MemoryStore(history=1_000_000)
        admin = m(pkg, "client").LocalClient(store)
        ledger = Ledger(pkg, store)
        for i in range(8):
            admin.create(clientset.NODES, testing.make_node(f"nh-{i}").build())
        instances = [new_instance(pkg, store, live_policy(
            pkg, i, 2, partition_by="namespaceHash", lease_duration=0.4,
            renew_interval=0.1), batch and pkg == PORT) for i in range(2)]
        try:
            assert all(s.scaleout.owns_node("nh-3") for s, _ in instances)
            for ns in namespaces:
                for i in range(10):
                    admin.create(clientset.PODS, testing.make_pod(
                        f"np-{i}", ns).req(cpu="50m").build())
            instances[0][0].scaleout.retire()
            assert wait_for(lambda: len(bound_pods(
                pkg, admin, namespaces)) == 30, timeout=60.0), pkg
            seen = ledger.drain()
            assert not {k: v for k, v in seen.items() if len(v) > 1}
            assert len(seen) == 30
            owners = {ns: [s.scaleout.index for s, _ in instances
                           if s.scaleout.owns_pod(ns, "x")]
                      for ns in namespaces}
            runs[pkg] = (sorted(seen), owners)
        finally:
            for s, f in instances:
                s.stop()
                f.stop()
            ledger.stop()
    assert runs[PORT] == runs[JAX]


# -- (e) the bench entry ----------------------------------------------------------

@pytest.fixture(scope="module")
def jax_bench():
    import pathlib
    import sys
    root = str(pathlib.Path(__file__).resolve().parent.parent)
    sys.path.insert(0, root)
    try:
        import bench as jax_bench_mod
    finally:
        sys.path.remove(root)
    return jax_bench_mod


def test_run_scaleout_binds_every_pod_with_bench_py_keys(
        deadline, jax_bench, monkeypatch):
    from kubernetes_tpu_torch.perf import bench
    ours = bench.run_scaleout(2, device="cpu", nodes=200, pods=1000,
                              batch=128)
    assert list(ours["BENCH_SCALEOUT"]) == ["1", "2"]
    for n, row in ours["BENCH_SCALEOUT"].items():
        assert "error" not in row, (n, row)
        assert row["bound"] == 1000 and row["pods_per_s"] > 0
        assert row["conflict_rate"] == 0.0, row
    monkeypatch.setenv("BENCH_SCALEOUT_NODES", "200")
    monkeypatch.setenv("BENCH_SCALEOUT_PODS", "1000")
    monkeypatch.setenv("BENCH_SCALEOUT_BATCH", "128")
    theirs, _rec = record_scaleout(monkeypatch, JAX, jax_bench,
                                   lambda: jax_bench.run_scaleout(2))
    assert sorted(ours) == sorted(theirs)
    assert {k: v for k, v in ours.items() if k != "BENCH_SCALEOUT"} == {
        k: v for k, v in theirs.items() if k != "BENCH_SCALEOUT"}
    for n, row in theirs["BENCH_SCALEOUT"].items():
        assert sorted(ours["BENCH_SCALEOUT"][n]) == sorted(row), n


# -- the shared store's compare-and-bind --------------------------------------

def bind_script(seed):
    """Pods in three namespaces, then four bulk binds: fresh pods, pods
    bound already (by the earlier call or twice in one call), missing
    pods, an empty node name, stale and current expect_rv."""
    import numpy as np
    rng = np.random.default_rng(seed)
    pods = [("" if i % 7 == 0 else f"ns-{i % 3}", f"p-{i}")
            for i in range(60)]
    calls = []
    for _c in range(4):
        call = []
        for _ in range(40):
            ns, nm = (pods[int(rng.integers(len(pods)))]
                      if rng.random() < 0.92 else ("ns-0", "gone"))
            node = "" if rng.random() < 0.05 else f"n-{int(rng.integers(8))}"
            entry = (ns, nm, node)
            if rng.random() < 0.3:
                entry += (int(rng.integers(1, 130)),)
            call.append(entry)
        calls.append(call)
    return pods, calls


def run_binds(pkg, seed, interfere=None):
    kv, api = m(pkg, "store.kv"), m(pkg, "api.meta")
    store = kv.MemoryStore()
    pods, calls = bind_script(seed)
    for ns, nm in pods:
        md = {"name": nm, "uid": f"u-{nm}", "creationTimestamp": 1.0}
        if ns:
            md["namespace"] = ns
        store.create("pods", {"metadata": md, "spec": {}})
    watch = store.watch("pods", since_rv=0)
    seen = []
    for call in calls:
        if interfere is not None:
            interfere(store, call)
        for obj, err in store.bind_many("pods", call):
            seen.append((type(err).__name__, str(err)) if err is not None
                        else (api.resource_version(obj),
                              obj["spec"]["nodeName"],
                              obj["status"]["conditions"]))
    events = [(e.type, e.revision, e.object["metadata"]["name"],
               e.object["spec"].get("nodeName")) for e in watch.next_batch(1)]
    watch.stop()
    return seen, events, store.revision, store.list("pods")[0]


@pytest.mark.parametrize("seed", range(4))
def test_bind_many_matches_the_jax_store(seed):
    """The port's bind_many builds the bound pods outside the store lock
    and commits under it; on the same script it returns the same results
    and errors, emits the same events and stores the same objects as the
    JAX package's single locked pass."""
    assert run_binds(PORT, seed) == run_binds(JAX, seed)


def test_bind_many_redoes_a_pod_written_since_its_read(monkeypatch):
    """A pod bound by another writer between bind_many's read and its
    commit: the commit sees the stored object changed, redoes the entry
    under the lock and reports the BindConflict the JAX store reports
    when that write lands first."""
    kv = m(PORT, "store.kv")
    build = kv._bound_pod
    raced = []

    def racing(resource, key, entry, cur, transform):
        if not raced and key == "ns-1/p-1" and cur is not None:
            raced.append(key)  # outside the lock: a peer binds it first
            store.bind_many("pods", [("ns-1", "p-1", "peer-node")])
        return build(resource, key, entry, cur, transform)
    store = kv.MemoryStore()
    for nm in ("p-0", "p-1"):
        store.create("pods", {"metadata": {"namespace": "ns-1", "name": nm},
                              "spec": {}})
    monkeypatch.setattr(kv, "_bound_pod", racing)
    out = store.bind_many("pods", [("ns-1", "p-0", "n-0"),
                                   ("ns-1", "p-1", "n-1")])
    assert raced and out[0][1] is None
    assert out[0][0]["spec"]["nodeName"] == "n-0"
    assert isinstance(out[1][1], kv.BindConflict)
    assert out[1][1].current_node == "peer-node"
    assert store.get("pods", "ns-1", "p-1")["spec"]["nodeName"] == "peer-node"


# -- the port's lease renewal off the loop --------------------------------------

def lease_renewed(store, index):
    leases, _ = store.list(m(PORT, "client.clientset").LEASES)
    return next((l["spec"]["renewTime"] for l in leases
                 if l["metadata"]["name"].endswith(f"-{index}")), None)


def test_heartbeat_thread_renews_until_retired_or_stopped(deadline):
    """On a hand clock renew_off_loop renews the lease, a retired
    coordinator does not and a revived one does again.  start_heartbeat's
    thread renews at once; stop_heartbeat ends it and no renewal follows;
    both calls are idempotent.  The JAX package has no such thread:
    tick() alone renews there."""
    kv, clientset = m(PORT, "store.kv"), m(PORT, "client.clientset")
    store = kv.MemoryStore()
    client = clientset.LocalClient(store)
    clock = [100.0]
    co = coordinator(PORT, 0, 2, now_fn=lambda: clock[0],
                     lease_duration=2.0, renew_interval=0.5)
    assert co.renew_off_loop(client) and lease_renewed(store, 0) == 100.0
    clock[0] = 101.0
    co.retire()
    assert not co.renew_off_loop(client)
    assert lease_renewed(store, 0) == 100.0
    co.revive()
    assert co.renew_off_loop(client) and lease_renewed(store, 0) == 101.0
    live = coordinator(PORT, 1, 2, lease_duration=2.0, renew_interval=0.02)
    live.start_heartbeat(client)
    live.start_heartbeat(client)
    assert wait_for(lambda: lease_renewed(store, 1) is not None)
    beat = live._beat[1]
    live.stop_heartbeat()
    live.stop_heartbeat()
    assert not beat.is_alive() and live._beat is None
    held = lease_renewed(store, 1)
    time.sleep(0.1)
    assert lease_renewed(store, 1) == held


STALL_AT = 10.0


def stall_views(pkg, stall):
    """Two coordinators of `pkg` over one store on a hand clock (2 s
    leases, 0.5 s renewal) tick every 0.25 s; from STALL_AT instance 0's
    loop stalls for `stall` s while the port's renewal thread still
    steps every renew_interval (the JAX package has none), then ticks
    again.  Returns [(t, instance 1's live view)] from STALL_AT to 5 s
    after the stall."""
    kv, clientset = m(pkg, "store.kv"), m(pkg, "client.clientset")
    client = clientset.LocalClient(kv.MemoryStore())
    clock = [0.0]
    cos = [coordinator(pkg, i, 2, now_fn=lambda: clock[0],
                       lease_duration=2.0, renew_interval=0.5)
           for i in range(2)]
    renew = getattr(cos[0], "renew_off_loop", None)
    views = []
    for k in range(int((STALL_AT + stall + 5.0) * 4)):
        t = clock[0] = k * 0.25
        if not STALL_AT <= t < STALL_AT + stall:
            cos[0].tick(client, t)
        elif renew is not None and k % 2 == 0:
            renew(client, t)
        cos[1].tick(client, t)
        if t >= STALL_AT:
            views.append((t, cos[1].live))
    return views


def first_lapse(views):
    return next((t for t, live in views if live == (1,)), None)


def test_a_stalled_loop_keeps_its_lease():
    """A loop stalled three leases long, within the window: the port's
    instance keeps its lease (its peer's view stays (0, 1)); the JAX
    package's, which renews on the loop only, lapses one lease after its
    last tick and rejoins when it ticks again."""
    assert {live for _t, live in stall_views(PORT, 6.0)} == {(0, 1)}
    theirs = stall_views(JAX, 6.0)
    assert STALL_AT < first_lapse(theirs) <= STALL_AT + 2.5
    assert theirs[-1][1] == (0, 1)


def test_a_hung_loop_fails_over():
    """A loop stalled past LOOP_STALL_LEASES leases: the renewal thread
    stops with it, so the peer sweeps the instance out one lease after
    the window (the JAX package: one lease after the last tick), and the
    instance rejoins when its loop ticks again."""
    window = m(PORT, "scheduler.scaleout").LOOP_STALL_LEASES * 2.0
    stall = window + 20.0
    ours, theirs = stall_views(PORT, stall), stall_views(JAX, stall)
    assert STALL_AT + window < first_lapse(ours) <= STALL_AT + window + 2.5
    assert all(live == (1,) for t, live in ours
               if STALL_AT + window + 2.5 <= t < STALL_AT + stall)
    assert STALL_AT < first_lapse(theirs) <= STALL_AT + 2.5
    assert ours[-1][1] == theirs[-1][1] == (0, 1)


def test_heartbeat_follows_the_loop_and_the_coordinator():
    """run() starts the renewal of an attached coordinator; attaching one
    to a running Scheduler starts it, detaching or replacing it stops the
    old one, and stop() stops it."""
    store = m(PORT, "store.kv").MemoryStore()
    client_mod, sched_mod = m(PORT, "client"), m(PORT, "scheduler")
    client = client_mod.LocalClient(store)
    factory = client_mod.SharedInformerFactory(client)
    sched = sched_mod.new_scheduler(client, factory)
    first = coordinator(PORT, 0, 2)
    sched.configure_scaleout(first)
    assert first._beat is None          # the loop is not running yet
    factory.start()
    sched.run()
    try:
        assert first._beat is not None
        second = coordinator(PORT, 0, 2)
        sched.configure_scaleout(second)
        assert first._beat is None and second._beat is not None
        sched.configure_scaleout(None)
        assert second._beat is None and sched.scaleout is None
        sched.configure_scaleout(second)
        assert second._beat is not None
    finally:
        sched.stop()
        factory.stop()
    assert second._beat is None
