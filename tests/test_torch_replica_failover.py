"""The port's scheduler through a failover of its store, on the CPU.

  (a) chip_smoke.py's phase 34 at a small size with device="cpu": 200
      nodes of SchedulingBasicHTTP's shape, 100 warm-up pods and a flood
      of 900, batch 128, depth 2; scheduler A over a fencing primary whose
      follower sits behind a forwarder that freezes once 200 flood binds
      are acknowledged; the follower promotes itself and scheduler B over
      it binds the rest; the deposed primary rejoins.  replica_failover
      runs every check of the phase but the kernel counts (no kernel runs
      on the CPU): no acknowledged bind lost or moved, every pod bound
      exactly once within caps, the epoch up by one, the rejoined
      primary's pods equal to the promoted store's, plain batches and no
      escape.  The partition is placed by A's own acknowledged binds (the
      freeze runs right after the bind_many call that crosses the mark
      returns), so no step waits on a timer's luck; sync_timeout and
      grace are wider than the card's (5 s and 8 s against 2 s and 5 s) so
      a loaded run never fences before the partition.
  (b) What the scheduler does with FencedError from bind_many: the wave's
      pods go back to the queue (the "fenced" conflict outcome), none is
      counted as scheduled or left in the cache; once the store takes
      writes again every pod binds, exactly once.  Fenced two ways: the
      store fenced before the wave (the flag) and a fencing hub with no
      follower (the commit's ship raises after the table took the wave:
      a dirty tail the scheduler must not count).
Each test runs under a SIGALRM deadline.
"""

import signal
import time

import pytest

pytest.importorskip("jax")

import chip_smoke  # noqa: E402
from kubernetes_tpu_torch.client import LocalClient  # noqa: E402
from kubernetes_tpu_torch.client.clientset import PODS  # noqa: E402
from kubernetes_tpu_torch.perf import caps_for_nodes  # noqa: E402
from kubernetes_tpu_torch.perf.scheduler_perf import (  # noqa: E402
    _bulk_create, _default_node, _default_pod, setup_cluster,
)
from kubernetes_tpu_torch.store import kv  # noqa: E402
from kubernetes_tpu_torch.store.replica import (  # noqa: E402
    FollowerStore, ReplicationHub,
)
from torch_cases import wait_for  # noqa: E402

DEADLINE_S = 240


@pytest.fixture
def deadline():
    def expire(*_a):
        raise TimeoutError(f"failover test exceeded {DEADLINE_S} s")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def test_phase34_small_on_cpu(deadline):
    warm, flood, freeze_at = 100, 900, 200
    got = chip_smoke.replica_failover(
        nodes=200, warm=warm, flood=flood, freeze_at=freeze_at, batch=128,
        device="cpu", sync_timeout=5.0, grace=8.0)
    # the partition came after the mark, in whole waves of A's binds
    assert freeze_at <= got["frozen_at"] < flood
    assert got["acked"] == warm + got["frozen_at"]
    # B bound exactly what the promoted store held unbound
    assert got["b_bound"] == flood - got["frozen_at"]
    assert got["epochs"] == (1, 2)
    assert got["fenced"]["fenced"] > 0
    assert got["fenced"]["lost_to_peer"] == 0
    # the order of the failover: the primary fenced, then the follower
    # promoted, then B's binds; A saw FencedError after the fence
    assert 0 < got["to_store_fenced"] < got["to_promoted"] \
        < got["to_b_first"]
    assert got["to_store_fenced"] <= got["to_fenced"]
    # no kernel runs on the CPU: the wrappers took their plain versions
    assert got["launches"] == {"A": 0, "B": 0}
    (a_batches, _), = got["batches"][0]
    (b_batches, _), = got["batches"][1]
    assert a_batches > 0 and b_batches > 0


def fenced_cluster(how, n_nodes=20, n_pods=96, batch=32):
    """A store with nodes and pods, fenced `how`, and a scheduler over
    it on the CPU."""
    store = FollowerStore(history=100_000).promote()
    hub = None
    client = LocalClient(store)
    _bulk_create(client, "nodes", n_nodes, 0, _default_node, {})
    _bulk_create(client, "pods", n_pods, 0, _default_pod,
                 {"podNamePrefix": "fenced-"})
    client.close()
    if how == "flag":
        store.fence("fenced for the test")
    else:
        hub = ReplicationHub(store, sync=True, fencing=True,
                             sync_timeout=0.2).start()
    cluster = setup_cluster(caps=caps_for_nodes(n_nodes), batch_size=batch,
                            store=store, pipeline_depth=2, device="cpu")
    return store, hub, cluster


@pytest.mark.parametrize("how", ["flag", "hub"])
def test_fenced_bind_wave_requeues(deadline, how):
    n_pods = 96
    store, hub, cluster = fenced_cluster(how, n_pods=n_pods)
    sched = cluster.scheduler
    try:
        def fenced():
            counts = chip_smoke.conflict_counts([cluster])
            return counts["fenced"] >= n_pods
        assert wait_for(fenced, timeout=60.0)
        assert store._fenced
        with sched.metrics.lock:
            assert sched.metrics.schedule_attempts["scheduled"] == 0
        # between two fenced waves the cache holds none of the pods
        assert wait_for(lambda: sched.cache.pod_count() == 0, timeout=30.0)
        counts = chip_smoke.conflict_counts([cluster])
        assert counts["lost_to_peer"] == counts["requeued"] == 0
        pods, _ = store.list(PODS)
        assert len(pods) == n_pods
        # every pod is the queue's again (active or backing off between
        # its fenced waves), none dropped
        def queued():
            return len({f"{p['metadata']['namespace']}/"
                        f"{p['metadata']['name']}"
                        for p in sched.queue.pending_pods()[0]})
        assert wait_for(lambda: queued() == n_pods, timeout=30.0), \
            f"{queued()} of {n_pods} pods queued"
        dirty = sum(1 for p in pods if (p.get("spec") or {}).get("nodeName"))
        if how == "flag":
            # nothing reached the table; lift the fence and every pod
            # binds, once
            assert dirty == 0
            watch = chip_smoke.BindWatch(cluster.client)
            store._fenced = False
            t0 = time.monotonic()
            assert wait_for(lambda: watch.bound("default/fenced-")
                            >= n_pods, timeout=60.0), \
                f"{watch.bound('default/fenced-')} of {n_pods} bound " \
                f"{time.monotonic() - t0:.1f} s after the fence lifted"
            watch.close()
            assert set(watch.binds.values()) == {1}
            assert not watch.changed
            with sched.metrics.lock:
                assert sched.metrics.schedule_attempts["scheduled"] == \
                    n_pods
        else:
            # the first wave reached the table before its ship failed:
            # a dirty tail the scheduler neither counted nor cached
            assert 0 < dirty <= 32
            with pytest.raises(kv.FencedError):
                store.create(PODS, _default_pod(0, {"podNamePrefix": "x-"}))
    finally:
        cluster.shutdown()
        if hub is not None:
            hub.stop()
