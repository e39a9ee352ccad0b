"""Store replication in the port (kubernetes_tpu_torch/store/replica.py)
held against the JAX package's store/replica.py on the CPU.

  (a) tests/test_store_replica.py's fifteen scenarios on the port's
      classes: the bootstrap snapshot, every verb streamed, the follower's
      watch, write refusal until promotion, revision continuity, the
      primary killed mid-storm with zero acknowledged writes lost,
      informers relisting on the promoted follower, the follower's WAL,
      sealed tombstones, degraded async shipping, partition ->
      auto-promotion -> fence -> rejoin, the stale hub fenced, fencing
      with no follower, and watches spanning a rejoin.
  (b) Parity: one seeded script of verbs (create, create_many, update,
      delete, guaranteed_update, and bind_many with conflicts, expect_rv
      and empty node names) through a JAX primary -> follower pair and a
      port pair: the same answers, the same shipped records, and two
      followers with the same tables, revision and epoch and the same
      watch events (type, key, resourceVersion, object).
  (c) Across the wire: a port follower of a JAX hub and a JAX follower of
      a port hub, each ending equal to its primary.

Every wait has its own bound; sync_timeout is 30 s wherever zero loss is
asserted, as in the JAX file.
"""

import importlib
import importlib.util
import json
import threading

import numpy as np
import pytest

pytest.importorskip("jax")

from torch_cases import PORT_PKG as PORT, wait_for  # noqa: E402

from chip_smoke import BlackholeProxy  # noqa: E402
from kubernetes_tpu_torch.api import meta  # noqa: E402
from kubernetes_tpu_torch.client import (  # noqa: E402
    LocalClient, SharedInformerFactory,
)
from kubernetes_tpu_torch.store import kv  # noqa: E402
from kubernetes_tpu_torch.store.replica import (  # noqa: E402
    FollowerStore, ReplicationHub,
)
from kubernetes_tpu_torch.testing import make_pod  # noqa: E402

JAX = "kubernetes_tpu"
PKGS = (JAX, PORT)

requires_crypto = pytest.mark.skipif(
    importlib.util.find_spec("cryptography") is None,
    reason="KMS sealing needs the cryptography package")


def m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def mkpair(**hub_kw):
    # the JAX file's generous sync timeout: the zero-loss scenarios must
    # never take the degraded-async path under a loaded run
    hub_kw.setdefault("sync_timeout", 30.0)
    primary = kv.MemoryStore(history=10_000)
    hub = ReplicationHub(primary, **hub_kw).start()
    follower = FollowerStore(history=10_000)
    follower.follow(*hub.address)
    return primary, hub, follower


# -- (a) the JAX file's scenarios on the port -------------------------------

class TestReplication:
    def test_bootstrap_snapshot(self):
        primary = kv.MemoryStore(history=10_000)
        for i in range(20):
            primary.create("pods", make_pod(f"pre-{i}").build())
        hub = ReplicationHub(primary).start()
        follower = FollowerStore()
        follower.follow(*hub.address)
        items, rv = follower.list("pods", "default")
        assert len(items) == 20
        assert rv == primary._rev
        hub.stop()

    def test_streaming_all_verbs(self):
        primary, hub, follower = mkpair()
        primary.create("pods", make_pod("a").build())
        primary.create_many("pods", [make_pod(f"m-{i}").build()
                                     for i in range(5)])
        primary.bind_many("pods", [("default", "a", "n1")])
        primary.guaranteed_update(
            "pods", "default", "m-0",
            lambda p: (p.setdefault("status", {}).update(
                phase="Running") or p))
        primary.delete("pods", "default", "m-4")
        # sync mode: by the time the last write returned, the follower
        # has acked everything
        items, _ = follower.list("pods", "default")
        assert {meta.name(p) for p in items} == {"a", "m-0", "m-1", "m-2",
                                                 "m-3"}
        assert follower.get("pods", "default", "a")["spec"][
            "nodeName"] == "n1"
        assert follower.get("pods", "default", "m-0")["status"][
            "phase"] == "Running"
        hub.stop()

    def test_follower_watch_sees_stream(self):
        primary, hub, follower = mkpair()
        w = follower.watch("pods")
        primary.create("pods", make_pod("w1").build())
        ev = w.next(timeout=5.0)
        assert ev is not None and ev.type == kv.ADDED
        assert meta.name(ev.object) == "w1"
        primary.delete("pods", "default", "w1")
        ev = w.next(timeout=5.0)
        assert ev is not None and ev.type == kv.DELETED
        assert meta.name(ev.object) == "w1"
        w.stop()
        hub.stop()

    def test_follower_rejects_writes_until_promoted(self):
        primary, hub, follower = mkpair()
        with pytest.raises(kv.StoreError):
            follower.create("pods", make_pod("nope").build())
        follower.promote()
        follower.create("pods", make_pod("yep").build())
        assert follower.get("pods", "default", "yep")
        hub.stop()

    def test_promoted_revision_continues(self):
        primary, hub, follower = mkpair()
        primary.create("pods", make_pod("r1").build())
        rev_before = follower._rev
        follower.promote()
        created = follower.create("pods", make_pod("r2").build())
        assert meta.resource_version(created) > rev_before
        hub.stop()


class TestFailover:
    def test_kill_primary_promote_zero_lost_writes(self):
        """A writer hammers the primary; the primary 'dies' (hub torn down
        mid-storm); the follower is promoted; every write the primary
        acknowledged to the writer exists on the promoted follower."""
        primary, hub, follower = mkpair()
        acked: list[str] = []
        stop = threading.Event()

        def writer():
            i = 0
            while not stop.is_set() and i < 500:
                name = f"storm-{i}"
                try:
                    primary.create("pods", make_pod(name).build())
                except kv.StoreError:  # pragma: no cover - late failure
                    break
                acked.append(name)  # returned == acknowledged
                i += 1

        t = threading.Thread(target=writer)
        t.start()
        # the writer is cut off first: a create racing the kill is an
        # in-flight, never-acknowledged write, outside the loss contract
        assert wait_for(lambda: len(acked) > 100, timeout=10.0)
        stop.set()
        t.join(timeout=10.0)
        assert not t.is_alive()
        hub.stop()  # primary gone
        follower.promote()
        items, _ = follower.list("pods", "default")
        have = {meta.name(p) for p in items}
        missing = [n for n in acked if n not in have]
        assert not missing, f"lost {len(missing)} acked writes: {missing[:5]}"

    def test_informers_relist_against_promoted_follower(self):
        primary, hub, follower = mkpair()
        for i in range(10):
            primary.create("pods", make_pod(f"p-{i}").build())
        hub.stop()
        follower.promote()
        client = LocalClient(follower)
        factory = SharedInformerFactory(client)
        informer = factory.informer("pods")
        factory.start()
        assert factory.wait_for_cache_sync(timeout=10.0)
        assert len(informer.list()) == 10
        seen = threading.Event()
        informer.add_event_handler(
            lambda t, o, old: seen.set() if meta.name(o) == "after" else None)
        client.create("pods", make_pod("after").build())
        assert seen.wait(5.0)
        factory.stop()
        client.close()

    def test_follower_wal_persists_replicated_writes(self, tmp_path):
        """A durable follower survives its own restart with the replicated
        state: replicated records re-enter its WAL, not just its tables."""
        primary = kv.MemoryStore(history=10_000)
        hub = ReplicationHub(primary, sync_timeout=30.0).start()
        follower = FollowerStore(durable_dir=str(tmp_path))
        follower.follow(*hub.address)
        for i in range(25):
            primary.create("pods", make_pod(f"dur-{i}").build())
        hub.stop()
        follower.promote()
        follower.create("pods", make_pod("post-promote").build())
        follower.close()  # release the WAL flock ("crash" + restart)
        reborn = kv.MemoryStore(history=10_000, durable_dir=str(tmp_path))
        items, _ = reborn.list("pods", "default")
        names = {meta.name(p) for p in items}
        assert "post-promote" in names
        assert {f"dur-{i}" for i in range(25)} <= names

    @requires_crypto
    def test_sealed_resource_tombstones_ship_metadata_only(self):
        """Deleting an encrypted-at-rest resource does not ship its
        plaintext body over the replication link."""
        from kubernetes_tpu_torch.store.encryption import (
            EnvelopeTransformer, LocalKMS,
        )
        t = EnvelopeTransformer(LocalKMS())
        primary = kv.MemoryStore(history=10_000,
                                 transformers={"secrets": t})
        shipped = []

        class SpyHub:
            def ship(self, recs):
                shipped.extend(recs)

        primary._repl = SpyHub()
        sec = meta.new_object("Secret", "s1", "default")
        sec["data"] = {"password": "aHVudGVyMg=="}
        primary.create("secrets", sec)
        primary.delete("secrets", "default", "s1")
        del_recs = [r for r in shipped if r[0] != "P"]
        assert del_recs, "delete record not shipped"
        tomb = del_recs[0][4]
        assert "data" not in tomb  # metadata only
        assert tomb["metadata"]["name"] == "s1"
        # PUT records ship sealed (ciphertext), never plaintext
        put_recs = [r for r in shipped if r[0] == "P"]
        assert put_recs and put_recs[0][4].get("data") != sec["data"]

    def test_degraded_async_when_follower_dies(self):
        """A dead follower does not freeze the primary (a bounded sync
        wait, then degraded async)."""
        primary, hub, follower = mkpair(sync_timeout=0.5)
        follower._conn.close()  # follower dies ungracefully
        for i in range(3):
            primary.create("pods", make_pod(f"alive-{i}").build())
        assert primary.get("pods", "default", "alive-2")
        hub.stop()


class TestAutomatedFailover:
    """Fencing epochs, the failure detector and auto-promotion: partition
    the primary mid-storm, auto-promote, the old primary rejoins and is
    fenced, zero acked-write loss, watches resume."""

    def _mk_fencing_pair(self, grace=5.0):
        # the original primary is itself a promoted FollowerStore so the
        # deposed-rejoin path can run on it
        primary = FollowerStore(history=10_000).promote()
        hub = ReplicationHub(primary, sync=True, fencing=True,
                             sync_timeout=2.0,
                             heartbeat_interval=0.1).start()
        proxy = BlackholeProxy(*hub.address)
        follower = FollowerStore(history=10_000)
        follower.follow(*proxy.address)
        follower.auto_promote_after(grace)
        return primary, hub, proxy, follower

    def test_partition_auto_promote_fence_rejoin(self):
        primary, hub, proxy, follower = self._mk_fencing_pair()
        acked: list[str] = []
        stop = threading.Event()
        fenced_seen = threading.Event()

        def storm():
            i = 0
            while not stop.is_set():
                name = f"storm-{i}"
                try:
                    primary.create("pods", make_pod(name).build())
                    acked.append(name)  # create returned == acked
                except kv.FencedError:
                    fenced_seen.set()
                    return
                except kv.StoreError:
                    return
                i += 1

        w = follower.watch("pods")
        t = threading.Thread(target=storm, daemon=True)
        t.start()
        assert wait_for(lambda: len(acked) > 50, timeout=20.0), \
            "storm never got going"
        proxy.freeze()  # the partition: silent both ways
        assert fenced_seen.wait(20.0), "old primary never fenced"
        assert follower.promoted_event.wait(30.0), \
            "follower never auto-promoted"
        stop.set()
        t.join(5.0)
        assert follower.epoch > primary.epoch
        items, _ = follower.list("pods", "default")
        have = {o["metadata"]["name"] for o in items}
        missing = [n for n in acked if n not in have]
        assert not missing, f"acked writes lost in failover: {missing[:5]}"
        follower.create("pods", make_pod("post-failover").build())
        with pytest.raises(kv.FencedError):
            primary.create("pods", make_pod("split-brain").build())
        seen = set()
        while "post-failover" not in seen:
            evs = w.next_batch(timeout=1.0)
            if not evs:
                break
            seen.update(ev.object["metadata"]["name"] for ev in evs)
        assert "post-failover" in seen
        hub.stop()
        hub2 = ReplicationHub(follower, sync=True,
                              heartbeat_interval=0.1).start()
        primary.rejoin(*hub2.address)
        items, _ = primary.list("pods", "default")
        names = {o["metadata"]["name"] for o in items}
        assert "post-failover" in names
        assert not any(n.startswith("split-brain") for n in names)
        with pytest.raises(kv.StoreError):
            primary.create("pods", make_pod("direct").build())
        follower.create("pods", make_pod("after-rejoin").build())
        assert wait_for(lambda: any(
            o["metadata"]["name"] == "after-rejoin"
            for o in primary.list("pods", "default")[0]),
            timeout=10.0), "rejoined replica not streaming"
        hub2.stop()
        proxy.close()

    def test_stale_primary_hello_fences_the_stale_hub(self):
        """A hub that learns of a newer epoch from a connecting follower's
        hello fences itself rather than serve a stale snapshot."""
        stale = FollowerStore(history=10_000).promote()  # epoch 1
        hub = ReplicationHub(stale, sync=False).start()
        newer = FollowerStore(history=10_000)
        newer._seen_epoch = 5  # has seen a much newer primary term
        with pytest.raises(kv.StoreError):
            newer.follow(*hub.address)
        with pytest.raises(kv.FencedError):
            stale.create("pods", make_pod("stale-write").build())
        hub.stop()

    def test_fencing_mode_refuses_unreplicated_commit(self):
        """fencing=True and no follower: a write fails instead of acking
        unreplicated."""
        primary = FollowerStore(history=10_000).promote()
        hub = ReplicationHub(primary, sync=True, fencing=True,
                             sync_timeout=0.2).start()
        with pytest.raises(kv.FencedError):
            primary.create("pods", make_pod("lonely").build())
        hub.stop()


class TestRejoinWatchConsistency:
    """A watcher opened on a deposed primary before it rejoins observes
    DELETED for every key of its dirty tail the new primary lacks, the new
    primary's additions, and strictly monotonic revisions."""

    def test_watcher_spanning_rejoin_sees_deletes_and_monotonic_rvs(self):
        a = FollowerStore(history=10_000).promote()
        hub_a = ReplicationHub(a, sync=True, sync_timeout=30.0).start()
        b = FollowerStore(history=10_000)
        b.follow(*hub_a.address)
        for i in range(5):
            a.create("pods", make_pod(f"keep-{i}").build())
        assert wait_for(lambda: len(b.list("pods", "default")[0]) == 5)
        hub_a.stop()  # A partitioned away; it commits a dirty tail
        for i in range(3):
            a.create("pods", make_pod(f"dirty-{i}").build())
        b.promote()
        b.create("pods", make_pod("new-0").build())
        b.delete("pods", "default", "keep-0")
        w = a.watch("pods")
        rev_before = a._rev
        hub_b = ReplicationHub(b, sync=True, sync_timeout=30.0,
                               heartbeat_interval=0.1).start()
        a.rejoin(*hub_b.address)
        b.create("pods", make_pod("new-1").build())
        assert wait_for(lambda: any(
            o["metadata"]["name"] == "new-1"
            for o in a.list("pods", "default")[0]), timeout=10.0)
        events = []
        while True:
            batch = w.next_batch(timeout=1.0)
            if not batch:
                break
            events.extend(batch)
        w.stop()
        hub_b.stop()
        deleted = {ev.object["metadata"]["name"] for ev in events
                   if ev.type == kv.DELETED}
        added = {ev.object["metadata"]["name"] for ev in events
                 if ev.type == kv.ADDED}
        assert {"dirty-0", "dirty-1", "dirty-2", "keep-0"} <= deleted, \
            f"missing tombstones; saw {deleted}"
        assert {"new-0", "new-1"} <= added
        revs = [ev.revision for ev in events]
        assert all(y > x for x, y in zip(revs, revs[1:])), \
            f"non-monotonic watch revisions: {revs}"
        assert revs and revs[0] > rev_before
        for ev in events:
            if ev.type == kv.DELETED:
                assert ev.object["metadata"]["resourceVersion"] == \
                    ev.revision
        a_names = {o["metadata"]["name"]
                   for o in a.list("pods", "default")[0]}
        b_names = {o["metadata"]["name"]
                   for o in b.list("pods", "default")[0]}
        assert a_names == b_names
        assert not any(n.startswith("dirty-") for n in a_names)

    def test_resume_watch_from_old_term_rev_gets_too_old(self):
        """A client holding a pre-rejoin resourceVersion relists
        (TooOldError) instead of resuming into the new term's numbers."""
        a = FollowerStore(history=10_000).promote()
        hub_a = ReplicationHub(a, sync=True, sync_timeout=30.0).start()
        b = FollowerStore(history=10_000)
        b.follow(*hub_a.address)
        for i in range(4):
            a.create("pods", make_pod(f"t-{i}").build())
        assert wait_for(lambda: len(b.list("pods", "default")[0]) == 4)
        old_rv = a._rev - 2
        hub_a.stop()
        b.promote()
        b.create("pods", make_pod("term2").build())
        hub_b = ReplicationHub(b, sync=True, sync_timeout=30.0).start()
        a.rejoin(*hub_b.address)
        with pytest.raises(kv.TooOldError):
            a.watch("pods", since_rv=old_rv)
        hub_b.stop()


# -- (b) parity: one seeded script through both packages --------------------

POOL = 40                 # pod names the script draws from
NODES = ("n-0", "n-1", "n-2", "n-3", "")   # "" is refused by bind_many


def norm(x):
    """JSON's view of a value: what crosses the wire."""
    return json.loads(json.dumps(x, sort_keys=True))


def make_obj(kind, name, k, labels=None):
    """A fixed object: uid and creationTimestamp set, so that the stores
    keep them and both packages hold the same bytes."""
    obj = {"apiVersion": "v1", "kind": kind,
           "metadata": {"name": name, "namespace": "default",
                        "uid": f"uid-{name}-{k}",
                        "creationTimestamp": 1_700_000_000.0 + k,
                        "labels": dict(labels or {"k": str(k)})}}
    if kind == "Pod":
        obj["spec"] = {"containers": [{
            "name": "c", "image": "pause",
            "resources": {"requests": {"cpu": "100m",
                                       "memory": "128Mi"}}}]}
        obj["status"] = {"phase": "Pending"}
    else:
        obj["data"] = {"v": str(k)}
    return obj


def verb_script(seed=11, steps=260):
    """Seeded verbs as data (numpy's generator): (verb, args).  Each
    verb's arguments name pods by index; the runner resolves what it
    needs from the primary it runs on, the same way in both packages."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(steps):
        r = rng.random()
        if r < 0.22:
            out.append(("create", ("pods", int(rng.integers(POOL)), k)))
        elif r < 0.30:
            out.append(("create", ("configmaps",
                                   int(rng.integers(8)), k)))
        elif r < 0.42:
            idx = sorted({int(i) for i in
                          rng.integers(POOL, size=rng.integers(1, 7))})
            out.append(("create_many", (idx, k)))
        elif r < 0.52:
            out.append(("update", (int(rng.integers(POOL)), k,
                                   bool(rng.random() < 0.2))))
        elif r < 0.60:
            out.append(("delete", (int(rng.integers(POOL)),
                                   bool(rng.random() < 0.2))))
        elif r < 0.70:
            out.append(("guaranteed_update", (int(rng.integers(POOL)), k)))
        else:
            entries = []
            for _ in range(int(rng.integers(1, 9))):
                i = int(rng.integers(POOL))
                node = NODES[int(rng.integers(len(NODES)))]
                # expect_rv: none, the stored one, or a stale one
                rv_mode = int(rng.integers(3))
                entries.append((i, node, rv_mode))
            if rng.random() < 0.3 and entries:
                entries.append(entries[0])  # the same pod twice
            out.append(("bind_many", (entries,)))
    return out


def answer(fn):
    """A verb's outcome in comparable form: the returned object(s), or
    the error's class and message."""
    try:
        return ("ok", norm(fn()))
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return ("err", type(e).__name__, str(e))


def run_script(pkg, primary, script):
    not_found = m(pkg, "store.kv").NotFoundError
    outcomes = []
    for verb, args in script:
        if verb == "create":
            res, i, k = args
            kind = "Pod" if res == "pods" else "ConfigMap"
            name = f"p-{i}" if res == "pods" else f"cm-{i}"
            outcomes.append(answer(lambda: primary.create(
                res, make_obj(kind, name, k))))
        elif verb == "create_many":
            idx, k = args
            outcomes.append(answer(lambda: [
                (norm(o), type(e).__name__ if e else None)
                for o, e in primary.create_many(
                    "pods", [make_obj("Pod", f"p-{i}", k) for i in idx])]))
        elif verb == "update":
            i, k, stale = args

            def upd():
                cur = primary.get("pods", "default", f"p-{i}")
                new = json.loads(json.dumps(cur))
                new["metadata"]["labels"] = {"updated": str(k)}
                rv = meta.resource_version(cur)
                return primary.update("pods", new,
                                      expect_rv=rv - 1 if stale else rv)
            outcomes.append(answer(upd))
        elif verb == "delete":
            i, stale = args

            def dele():
                rv = None
                if stale:
                    rv = meta.resource_version(
                        primary.get("pods", "default", f"p-{i}")) - 1
                return primary.delete("pods", "default", f"p-{i}",
                                      expect_rv=rv)
            outcomes.append(answer(dele))
        elif verb == "guaranteed_update":
            i, k = args

            def bump(p, k=k):
                p.setdefault("status", {})["phase"] = f"Running-{k}"
                return p
            outcomes.append(answer(lambda: primary.guaranteed_update(
                "pods", "default", f"p-{i}", bump)))
        else:
            (entries,) = args
            bindings = []
            for i, node, rv_mode in entries:
                name = f"p-{i}"
                if rv_mode == 0:
                    bindings.append(("default", name, node))
                    continue
                try:
                    rv = meta.resource_version(
                        primary.get("pods", "default", name))
                except not_found:
                    rv = 1
                bindings.append(("default", name, node,
                                 rv if rv_mode == 1 else rv - 1))
            outcomes.append(answer(lambda: [
                (norm(o), None if e is None else
                 (type(e).__name__, str(e)))
                for o, e in primary.bind_many("pods", bindings)]))
    return outcomes


def drain(w):
    evs = []
    while True:
        batch = w.next_batch(timeout=0.2)
        if not batch:
            return evs
        evs.extend(batch)


def replicated_run(pkg, script):
    """The script through `pkg`'s primary -> follower pair (sync, 30 s):
    outcomes, shipped records, the follower's tables, revision, epochs
    (before and after promotion) and watch events."""
    kvm, rep = m(pkg, "store.kv"), m(pkg, "store.replica")
    primary = kvm.MemoryStore(history=10_000)
    for i in range(5):   # the bootstrap snapshot carries these
        primary.create("pods", make_obj("Pod", f"pre-{i}", i))
    hub = rep.ReplicationHub(primary, sync_timeout=30.0).start()
    shipped = []
    ship = hub.ship

    def spy(recs):
        shipped.append(norm([list(r) for r in recs]))
        return ship(recs)
    hub.ship = spy
    follower = rep.FollowerStore(history=10_000)
    follower.follow(*hub.address)
    watches = {res: follower.watch(res) for res in ("pods", "configmaps")}
    try:
        outcomes = run_script(pkg, primary, script)
        # sync mode: every write returned after its record was applied
        # and acknowledged, so the follower holds them all
        events = {res: [(ev.type, meta.namespaced_name(ev.object),
                         ev.revision, norm(ev.object)) for ev in drain(w)]
                  for res, w in watches.items()}
        state = {"data": norm(follower._data), "rev": follower._rev,
                 "epoch": follower.epoch,
                 "seen_epoch": follower._seen_epoch}
        assert norm(primary._data) == state["data"]
        assert primary._rev == state["rev"]
        follower.promote()
        state["promoted_epoch"] = follower.epoch
        return outcomes, shipped, state, events
    finally:
        for w in watches.values():
            w.stop()
        hub.stop()


def test_parity_seeded_script():
    script = verb_script()
    verbs = {v for v, _ in script}
    assert verbs == {"create", "create_many", "update", "delete",
                     "guaranteed_update", "bind_many"}
    got = {pkg: replicated_run(pkg, script) for pkg in PKGS}
    (jo, js, jst, jev), (po, ps, pst, pev) = got[JAX], got[PORT]
    assert po == jo
    assert ps == js
    assert pst == jst
    assert pev == jev
    # the script reached every branch it names: binds, their conflicts,
    # the refused empty node name, expect_rv conflicts and deletes
    flat = json.dumps(jo)
    for what in ("BindConflict", "empty node name refused",
                 "moved past resourceVersion", "already bound",
                 "NotFoundError", "AlreadyExistsError", "ConflictError"):
        assert what in flat, what
    assert sum(len(r) for r in js) > 100
    assert {ev[0] for evs in jev.values() for ev in evs} == {
        kv.ADDED, kv.MODIFIED, kv.DELETED}


# -- (c) across the wire ----------------------------------------------------

@pytest.mark.parametrize("hub_pkg,follower_pkg", [(JAX, PORT), (PORT, JAX)],
                         ids=["port-follows-jax", "jax-follows-port"])
def test_cross_package_follow(hub_pkg, follower_pkg):
    kvm, rep = m(hub_pkg, "store.kv"), m(hub_pkg, "store.replica")
    frep = m(follower_pkg, "store.replica")
    primary = rep.FollowerStore(history=10_000).promote()
    for i in range(6):
        primary.create("pods", make_obj("Pod", f"pre-{i}", i))
    hub = rep.ReplicationHub(primary, sync=True, fencing=True,
                             sync_timeout=30.0,
                             heartbeat_interval=0.1).start()
    follower = frep.FollowerStore(history=10_000)
    follower.follow(*hub.address)
    w = follower.watch("pods")
    try:
        assert norm(follower._data) == norm(primary._data)
        run_script(hub_pkg, primary, verb_script(seed=23, steps=120))
        assert norm(follower._data) == norm(primary._data)
        assert follower._rev == primary._rev
        assert follower._seen_epoch == primary.epoch == 1
        events = drain(w)
        assert events and all(y.revision > x.revision
                              for x, y in zip(events, events[1:]))
        # the follower fails over and the deposed primary rejoins it,
        # across the packages the other way round
        hub.stop()
        follower.promote()
        assert follower.epoch == 2
        follower.create("pods", make_obj("Pod", "after", 999))
        hub2 = frep.ReplicationHub(follower, sync=True,
                                   sync_timeout=30.0).start()
        try:
            primary.rejoin(*hub2.address)
            assert norm(primary._data) == norm(follower._data)
            with pytest.raises(kvm.StoreError):
                primary.create("pods", make_obj("Pod", "direct", 1000))
        finally:
            hub2.stop()
    finally:
        w.stop()
        hub.stop()
