"""The port's chaos schedules and wrappers (ops/faults.py) held against the
JAX package's on the CPU.

For the same seed, rates and script, OverloadSchedule and
ChurnStormSchedule must make the same decision at every step as the JAX
ones (tests/test_churn_storm.py's cases: seeded determinism, the one-draw
stream stability, quiet zero rates, bands that partition the unit
interval), and NodeStormDriver must apply the same actions to the same
nodes and leave the same node objects in its store (the driver cases of
tests/test_churn_storm.py: adds with rack labels, the min-nodes floor, the
max-nodes ceiling, relabels through guaranteed_update, drained victims
never drained twice).  ChaosBatchBackend, wrapped around the same stub
backend under the same schedule, returns the same results, counts the same
injected faults and drains the same escape reasons as the JAX wrapper, and
forwards the batch telemetry, the device census and its label as the JAX
wrapper does.
"""

import time

import pytest

pytest.importorskip("jax")

from kubernetes_tpu.ops import faults as jax_faults  # noqa: E402
from kubernetes_tpu.client.clientset import LocalClient as JaxClient  # noqa: E402,E501
from kubernetes_tpu.store import kv as jax_kv  # noqa: E402
import kubernetes_tpu.testing as jax_testing  # noqa: E402
import kubernetes_tpu.scheduler.types as jax_types  # noqa: E402
from kubernetes_tpu_torch.ops import faults as port_faults  # noqa: E402
from kubernetes_tpu_torch.client.clientset import (  # noqa: E402
    NODES, LocalClient as PortClient,
)
from kubernetes_tpu_torch.store import kv as port_kv  # noqa: E402
import kubernetes_tpu_torch.testing as port_testing  # noqa: E402
import kubernetes_tpu_torch.scheduler.types as port_types  # noqa: E402

SIDES = {"jax": (jax_faults, JaxClient, jax_kv, jax_testing, jax_types),
         "port": (port_faults, PortClient, port_kv, port_testing,
                  port_types)}


def test_constants_equal_the_reference():
    for name in ("NONE", "SLOW", "ALL_ESCAPE", "NODE_ADD", "NODE_DRAIN",
                 "NODE_RELABEL"):
        assert getattr(port_faults, name) == getattr(jax_faults, name)


# -- OverloadSchedule ------------------------------------------------------

OVERLOAD_CASES = {
    "bench_flood": dict(seed=42, slow_rate=0.05, slow_s=0.05,
                        all_escape_rate=0.1),
    "escape_heavy": dict(seed=3, all_escape_rate=0.2),
    "slow_heavy": dict(seed=9, slow_rate=0.6, slow_s=0.01),
    "scripted": dict(seed=5, slow_rate=0.2, all_escape_rate=0.2,
                     script={0: "all_escape", 7: "slow", 8: "none"}),
    "quiet": dict(seed=1),
}


@pytest.mark.parametrize("case", sorted(OVERLOAD_CASES))
def test_overload_schedule_streams_match(case):
    kw = OVERLOAD_CASES[case]
    a = jax_faults.OverloadSchedule(**kw)
    b = port_faults.OverloadSchedule(**kw)
    want = [a.action(i) for i in range(400)]
    got = [b.action(i) for i in range(400)]
    assert got == want
    if case == "bench_flood":
        assert {"slow", "all_escape", "none"} <= set(got)


def test_overload_script_keeps_the_stream():
    """A scripted wave consumes one draw like any other."""
    plain = port_faults.OverloadSchedule(seed=11, slow_rate=0.3,
                                         all_escape_rate=0.3)
    scripted = port_faults.OverloadSchedule(seed=11, slow_rate=0.3,
                                            all_escape_rate=0.3,
                                            script={4: "slow"})
    p = [plain.action(i) for i in range(20)]
    s = [scripted.action(i) for i in range(20)]
    assert s[4] == "slow" and s[:4] == p[:4] and s[5:] == p[5:]


# -- ChaosBatchBackend -----------------------------------------------------

class _Inner:
    """A backend stub: places pod i on node n{i % 3}, tallies one escape
    reason per dispatch, and records which optional calls reached it."""

    supports_pipelining = True

    def __init__(self):
        self.stats = {"batches": 0}
        self.calls = []

    def dispatch(self, pods, snapshot):
        self.stats["batches"] += 1
        out = [(f"n{i % 3}", None) for i in range(len(pods))]
        return lambda: out

    def drain_escape_reasons(self):
        return {("Stub", "reason"): 1}

    def warmup(self):
        self.calls.append("warmup")

    def prefetch(self, view):
        self.calls.append("prefetch")

    def note_node_event(self, event_type, name, view):
        self.calls.append(("node", event_type, name))

    def maintenance_snapshot(self):
        return {"waves_patched": 3}

    def abandon_wave(self):
        self.calls.append("abandon")


def _drive_chaos(side, waves=40):
    faults, *_rest, types = SIDES[side]
    sched = faults.OverloadSchedule(seed=7, slow_rate=0.1, slow_s=0.001,
                                    all_escape_rate=0.2,
                                    script={3: faults.ALL_ESCAPE})
    inner = _Inner()
    chaos = faults.ChaosBatchBackend(inner, sched)
    outs, escapes = [], {}
    for w in range(waves):
        res = chaos.dispatch([object()] * (w % 5 + 1), None)()
        outs.append([(n, None if s is None else (s.code, s.message()))
                     for n, s in res])
        for k, v in chaos.drain_escape_reasons().items():
            escapes[k] = escapes.get(k, 0) + v
    return outs, dict(chaos.injected), chaos.waves, escapes, inner, chaos


def test_chaos_backend_matches_reference():
    want = _drive_chaos("jax")
    got = _drive_chaos("port")
    assert got[:4] == want[:4]
    outs, injected, waves, escapes, inner, _ = got
    assert waves == 40 and injected["all_escape"] >= 1
    assert injected["slow"] >= 1
    assert escapes[("chaos", "injected_all_escape")] > 0
    # an all-escape wave never reaches the inner backend
    assert inner.stats["batches"] == 40 - injected["all_escape"]


def test_chaos_backend_forwards_and_delays():
    inner = _Inner()
    chaos = port_faults.ChaosBatchBackend(inner, port_faults.OverloadSchedule(
        script={0: port_faults.SLOW}, slow_s=0.05))
    chaos.warmup()
    chaos.prefetch(None)
    chaos.note_node_event("ADDED", "n9", None)
    chaos.abandon_wave()
    assert inner.calls == ["warmup", "prefetch", ("node", "ADDED", "n9"),
                           "abandon"]
    assert chaos.stats is inner.stats
    assert chaos.maintenance_snapshot() == {"waves_patched": 3}
    assert chaos.supports_pipelining is True
    assert chaos.health() is True
    t0 = time.monotonic()
    assert chaos.assign([1, 2], None) == [("n0", None), ("n1", None)]
    assert time.monotonic() - t0 >= 0.05
    assert chaos.injected == {"slow": 1, "all_escape": 0}

    class _Flush:
        def dispatch(self, pods, snapshot):
            return "FLUSH"

    assert port_faults.ChaosBatchBackend(
        _Flush(), port_faults.OverloadSchedule()).dispatch([1], None) \
        == "FLUSH"


class _Observed(_Inner):
    """_Inner with the observability hooks: batch telemetry, a census and
    its label."""

    census_kind = "stub"

    def drain_batch_telemetry(self):
        return [{"pods": 3, "feasible_nodes": 7, "waves": 1,
                 "mask_density": {"NodeAffinity": 0.5}}]

    def device_census(self, variants=("full", "plain")):
        return {v: {"cost": {"flops": 1.0}} for v in variants}


@pytest.mark.parametrize("side", sorted(SIDES))
@pytest.mark.parametrize("hook", ["drain_batch_telemetry", "device_census",
                                  "device_census_plain", "census_kind"])
def test_chaos_observability_forwarders(side, hook):
    """drain_batch_telemetry, device_census and census_kind reach the
    inner backend, and a bare inner gives the JAX wrapper's defaults ([],
    {}, "chaos"); the port's wrapper answers as the JAX one does."""
    faults = SIDES[side][0]
    observed = faults.ChaosBatchBackend(_Observed(), faults.OverloadSchedule())
    bare = faults.ChaosBatchBackend(_Inner(), faults.OverloadSchedule())
    if hook == "census_kind":
        got = (observed.census_kind, bare.census_kind)
        want = ("stub", "chaos")
    elif hook == "device_census_plain":
        got = (observed.device_census(variants=("plain",)),
               bare.device_census(variants=("plain",)))
        want = ({"plain": {"cost": {"flops": 1.0}}}, {})
    else:
        got = (getattr(observed, hook)(), getattr(bare, hook)())
        want = (getattr(_Observed(), hook)(),
                [] if hook == "drain_batch_telemetry" else {})
    assert got == want


def test_chaos_forwards_the_port_backends_census_and_telemetry():
    """Around a TorchBatchBackend on the CPU: the census labelled "torch",
    and each dispatched batch's telemetry, pass through the wrapper."""
    from torch_cases import SEQ_CAPS, port_side
    s = port_side(8, SEQ_CAPS)
    s.cache.add_node(s.node("n0", cpu="8", mem="8Gi"))
    chaos = port_faults.ChaosBatchBackend(s.backend,
                                          port_faults.OverloadSchedule())
    pods = [s.pod(f"p{i}", cpu="100m") for i in range(3)]
    chaos.assign(s.infos(pods), s.snapshot())
    assert chaos.census_kind == "torch"
    telem = chaos.drain_batch_telemetry()
    assert [(t["pods"], t["feasible_nodes"]) for t in telem] == [(3, 1)]
    census = chaos.device_census(variants=("plain",))
    assert list(census) == ["plain"] and census["plain"]["waves"] >= 1


# -- ChurnStormSchedule (tests/test_churn_storm.py TestChurnStormSchedule) -

def _storm_schedule(faults, **kw):
    base = dict(seed=7, add_rate=0.3, drain_rate=0.2, relabel_rate=0.3)
    base.update(kw)
    return faults.ChurnStormSchedule(**base)


STORM_CASES = {
    "default": {},
    "scripted": {"script": {11: ("node_drain", 0.5)}},
    "quiet": {"seed": 3, "add_rate": 0.0, "drain_rate": 0.0,
              "relabel_rate": 0.0},
    "full_bands": {"seed": 1, "add_rate": 0.4, "drain_rate": 0.3,
                   "relabel_rate": 0.3},
    "workload": {"seed": 42, "add_rate": 0.35, "drain_rate": 0.25,
                 "relabel_rate": 0.3},
}


@pytest.mark.storm
@pytest.mark.parametrize("case", sorted(STORM_CASES))
def test_churn_storm_schedule_streams_match(case):
    a = _storm_schedule(jax_faults, **STORM_CASES[case])
    b = _storm_schedule(port_faults, **STORM_CASES[case])
    want = [a.action(i) for i in range(3000)]
    got = [b.action(i) for i in range(3000)]
    assert got == want
    if case == "quiet":
        assert all(act == "none" for act, _ in got)
    if case == "full_bands":
        for act in ("node_add", "node_drain", "node_relabel"):
            fr = [f for a_, f in got if a_ == act]
            assert fr and min(fr) < 0.1 and max(fr) > 0.9
    if case == "scripted":
        assert got[11] == ("node_drain", 0.5)


# -- NodeStormDriver (tests/test_churn_storm.py TestNodeStormDriver) -------

def _storm_run(side, n, steps, sched_kw, drv_kw):
    """Apply `steps` storm steps to a fresh store of `n` base nodes; returns
    the driver's log, counters and step count, its per-step results and the
    store's nodes (name -> labels and capacity)."""
    faults, client_cls, kv, testing, _types = SIDES[side]
    client = client_cls(kv.MemoryStore())
    names = []
    for i in range(n):
        name = f"base-{i}"
        client.create(NODES, testing.make_node(name)
                      .capacity(cpu="8", mem="32Gi").build())
        names.append(name)
    drv = faults.NodeStormDriver(client, _storm_schedule(faults, **sched_kw),
                                 names, **drv_kw)
    results = [drv.step() for _ in range(steps)]
    items, _ = client.list(NODES, "")
    nodes = {o["metadata"]["name"]: (o["metadata"].get("labels", {}),
                                     o["status"].get("capacity"))
             for o in items}
    return (drv.log, dict(drv.injected), drv.steps, results, nodes,
            list(drv._names))


DRIVER_CASES = {
    "adds_with_racks": (4, 5, dict(add_rate=1.0, drain_rate=0.0,
                                   relabel_rate=0.0), dict(rack_labels=3)),
    "drain_floor": (4, 10, dict(add_rate=0.0, drain_rate=1.0,
                                relabel_rate=0.0), dict(min_nodes=2)),
    "add_ceiling": (4, 10, dict(add_rate=1.0, drain_rate=0.0,
                                relabel_rate=0.0), dict(max_nodes=6)),
    "relabels": (3, 6, dict(add_rate=0.0, drain_rate=0.0,
                            relabel_rate=1.0), {}),
    "mixed_no_redrain": (6, 40, dict(add_rate=0.4, drain_rate=0.6,
                                     relabel_rate=0.0), dict(min_nodes=1)),
    "workload_shape": (20, 200, dict(seed=42, add_rate=0.35,
                                     drain_rate=0.25, relabel_rate=0.3),
                       dict(min_nodes=10, max_nodes=40, cpu="32",
                            mem="256Gi", rack_labels=20)),
}


@pytest.mark.storm
@pytest.mark.parametrize("case", sorted(DRIVER_CASES))
def test_node_storm_driver_matches_reference(case):
    n, steps, sched_kw, drv_kw = DRIVER_CASES[case]
    want = _storm_run("jax", n, steps, sched_kw, drv_kw)
    got = _storm_run("port", n, steps, sched_kw, drv_kw)
    assert got == want
    log, injected, n_steps, results, nodes, live = got
    assert n_steps == steps
    assert sum(injected.values()) == len(log) == sum(
        1 for r in results if r is not None)
    if case == "adds_with_racks":
        assert set(nodes) >= {f"storm-{i}" for i in range(5)}
        assert all(nodes[f"storm-{i}"][0]["ktpu.io/rack"] in "012"
                   for i in range(5))
    if case == "drain_floor":
        assert len(nodes) == 2 and injected["node_drain"] == 2
    if case == "add_ceiling":
        assert len(nodes) == 6
    if case == "relabels":
        assert injected["node_relabel"] == 6
        assert [e[0] for e in log] == list(range(6))
    if case in ("mixed_no_redrain", "workload_shape"):
        drained = [nm for _, a, nm in log if a == "node_drain"]
        assert drained and len(drained) == len(set(drained))
        assert set(live) == set(nodes)
