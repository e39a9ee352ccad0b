"""The port's bench rows (kubernetes_tpu_torch/perf/bench.py CONFIGS) held
against the JAX package's bench.py, and the new row kinds run on the CPU.

Every single-device row of bench.py's EXTRA_CONFIGS is in the port with
bench.py's own parameters (workload, sizes, batch, depth, admission
window, rate, percentage of nodes to score, two passes, the nulled device,
the overload shape, the barrier budget; the seam rows' transport, faults
and timeout; the front-door rows' apiserver, in process or a process of
its own).  The overload shape builds the same policy and
chaos schedule as bench.py's.  At a tiny size on the CPU: a two_pass row
runs twice and keeps the better pass (a failed pass fails the row), the
host-ceiling row runs on the
nulled device (no device work, nothing escapes), the overload flood
reports its chaos and overload counters, and the churn storm reports its
storm with the drained nodes' pods counted apart.
"""

import dataclasses
import sys
from pathlib import Path

import pytest

from kubernetes_tpu_torch.perf import bench

ROOT = Path(__file__).resolve().parent.parent
# bench.py rows that need modules the port does not have yet
NOT_PORTED: dict[str, str] = {}
PARAMS = ("workload", "nodes", "pods", "batch", "depth", "admission_ms",
          "rate", "pct_nodes", "two_pass", "null", "overload", "seam",
          "faulty", "http")


@pytest.fixture(scope="module")
def jax_bench():
    pytest.importorskip("jax")
    sys.path.insert(0, str(ROOT))
    try:
        import bench as jax_bench_mod
    finally:
        sys.path.remove(str(ROOT))
    return jax_bench_mod


def test_every_single_device_row_is_ported(jax_bench):
    ours = set(bench.CONFIGS)
    theirs = set(jax_bench.EXTRA_CONFIGS)
    assert theirs - ours == set(NOT_PORTED)
    # the port's own: bench.py's headline workload at 5k nodes, and the
    # node storm as a row of its own
    assert ours - theirs == {"SchedulingBasic", "SchedulingChurnStorm"}


@pytest.mark.parametrize("name", sorted(set(bench.CONFIGS)
                                        - {"SchedulingBasic",
                                           "SchedulingChurnStorm"}))
def test_row_parameters_equal_bench_py(jax_bench, name):
    ours, theirs = bench.CONFIGS[name], jax_bench.EXTRA_CONFIGS[name]
    for key in PARAMS:
        assert ours.get(key) == theirs.get(key), (name, key)
    assert ours.get("timeout", 900.0) == theirs.get("timeout", 900.0)


def test_basic_row_is_bench_py_headline_shape(jax_bench):
    c = bench.CONFIGS["SchedulingBasic"]
    assert (c["nodes"], c["pods"], c["batch"], c["depth"]) == (
        jax_bench.N_NODES, jax_bench.N_PODS, jax_bench.BATCH,
        jax_bench.DEPTH)


def test_overload_shape_equals_bench_py(jax_bench):
    for batch in (64, 4096):
        policy, chaos = bench.overload_shape(batch)
        jpolicy, jchaos = jax_bench._overload_shape(batch)
        assert dataclasses.asdict(policy) == dataclasses.asdict(jpolicy)
        assert [chaos.action(i) for i in range(200)] == [
            jchaos.action(i) for i in range(200)]
        assert (chaos.slow_s, chaos.slow_rate, chaos.all_escape_rate) == (
            jchaos.slow_s, jchaos.slow_rate, jchaos.all_escape_rate)


# -- the new row kinds at a tiny size on the CPU ----------------------------

@pytest.mark.parametrize("name", ["TopologySpreading",
                                  "SchedulingBasicPaced1k"])
def test_two_pass_row_keeps_the_better_pass(name):
    """Two passes in this process, both returned in run order: the higher
    pods/s is kept, or for a paced row the lower p99."""
    row, results = bench.run_config(name, device="cpu", nodes=30, pods=300,
                                    batch=128)
    d = row["detail"]
    assert len(results) == 2
    assert not any("error" in r for r in results) and "second_pass" in d
    if bench.CONFIGS[name].get("rate"):
        assert d["pod_e2e_p99_ms"] <= d["second_pass"]["p99_ms"]
    else:
        assert row["value"] >= d["second_pass"]["pods_per_s"]
    for r in results:
        placed = r["detail"]["placements"]
        assert placed["bound"] == placed["pods"]


def test_a_failed_pass_fails_the_row(monkeypatch):
    """The better pass is kept, but an error in the other one still makes
    the row's error and bench's exit code."""
    calls = []

    def run_once(**kw):
        calls.append(kw)
        out = {"value": 100.0 * len(calls), "wall_s": 1.0, "nodes": 1,
               "pods": 1, "detail": {"pod_e2e_p99_ms": 1.0}}
        if len(calls) == 1:
            out["error"] = "pods left unscheduled"
        return out
    monkeypatch.setattr(bench, "run_once", run_once)
    row, results = bench.run_config("TopologySpreading")
    assert [r["value"] for r in results] == [100.0, 200.0]
    assert row["value"] == 200.0
    assert row["detail"]["error"] == "pods left unscheduled"
    assert row["detail"]["second_pass"]["error"] == "pods left unscheduled"
    calls.clear()
    assert bench.main(["--config", "TopologySpreading"]) == 1


def test_host_null_row_runs_without_the_device():
    from kubernetes_tpu_torch.ops import kernels
    before = dict(kernels.LAUNCHES)
    row, (res,) = bench.run_config("SchedulingHostNull", nodes=50, pods=600,
                                   batch=256)
    d = row["detail"]
    assert "error" not in res and row["value"] > 0
    assert d["backend"] == "null" and d["escape_rate"] == 0.0
    assert d["placements"]["bound"] == d["placements"]["pods"] == 600 + 1000
    assert d["placements"]["nodes_over_capacity"] == 0
    assert "waves" not in res["stats"]["backend_stats"]
    assert kernels.LAUNCHES == before


def test_overload_flood_row_reports_chaos():
    row, (res,) = bench.run_config("SchedulingOverloadFlood", device="cpu",
                                   nodes=60, pods=1200, batch=256)
    d = row["detail"]
    assert "error" not in res
    assert d["placements"]["bound"] == d["placements"]["pods"]
    assert d["placements"]["nodes_over_capacity"] == 0
    assert sum(d["chaos_injected"].values()) > 0
    assert d["overload"]["engagement"] == "always"
    assert not any(k.endswith(("/system", "/high"))
                   for k in d["overload"]["shed"])
    assert d["escape_rate"] > 0   # escapeEvery: 50, and all-escape waves


def test_churn_storm_row_counts_drained_nodes_apart():
    row, (res,) = bench.run_config("SchedulingChurnStorm", device="cpu",
                                   nodes=40, pods=1500, batch=256)
    d = row["detail"]
    assert "error" not in res
    inj = d["storm"]["injected"]
    assert inj["node_add"] > 0 and inj["node_relabel"] > 0
    placed = d["placements"]
    assert placed["bound"] == placed["pods"]
    assert placed["nodes_over_capacity"] == 0
    assert "on_removed_nodes" in placed
    assert d["overload"]["engagement"] in (
        "disengaged", "arming", "engaged", "cooling")


@pytest.mark.parametrize("name,pods", [("SchedulingBasic", 120),
                                       ("CoschedulingGang", 120),
                                       ("SchedulingPodAntiAffinity", 40),
                                       ("SchedulingHighCardinality", 120)])
def test_profiled_batch_of_the_rows_own_pods(name, pods):
    """profile_pods: one more batch of the workload's own pods after the
    run (gang pods with their groups and hostname anti-affinity pods in a
    namespace of their own, so they fit beside the run's), every pod
    attempted, the placements read before it."""
    res = bench.run_once(**bench.pass_args(name, 40, pods, 64),
                         device="cpu", profile_pods=30)
    d = res["detail"]
    assert "error" not in res
    prof = d["profiled_batch"]
    assert prof["done"] and prof["pods"] == 30
    assert prof["wall_ms"] > 0 and prof["busy_ms"] >= 0
    assert d["placements"]["pods"] == res["stats"]["created_pods"]
    assert d["waves_per_batch"] >= 1


def test_seam_sizes_and_fault_schedule_equal_bench_py(jax_bench,
                                                      monkeypatch):
    """run_seam's sizes are run_seam_micro's defaults, and the faulty
    row's schedule decides as bench.py's _BenchFaultSchedule on the same
    calls (weather, the kill at the 3rd /step, the 4-call outage from the
    8th)."""
    import inspect
    src = inspect.getsource(jax_bench.run_seam_micro)
    assert f'"BENCH_SEAM_NODES", "{bench.SEAM_NODES}"' in src
    assert f'"BENCH_SEAM_BATCH", "{bench.SEAM_BATCH}"' in src
    assert f"ROUNDS = {bench.SEAM_ROUNDS}" in src
    # bench.py builds its schedule inside run_seam_micro: capture it
    from kubernetes_tpu.ops import faults as jax_faults
    made = []
    real = jax_faults.FaultyTransport

    class Capture(real):
        def __init__(self, inner, schedule, on_kill=None):
            made.append(schedule)
            raise RuntimeError("captured")
    monkeypatch.setattr(jax_faults, "FaultyTransport", Capture)
    monkeypatch.setenv("BENCH_SEAM_NODES", "4")
    with pytest.raises(RuntimeError, match="captured"):
        jax_bench.run_seam_micro("http", faulty=True)
    theirs, ours = made[0], bench.BenchFaultSchedule()
    verbs = (["/init", "/static", "/refresh"]
             + ["/step?variant=plain", "/static"] * 20)
    assert [ours.action(i, v) for i, v in enumerate(verbs)] == [
        theirs.action(i, v) for i, v in enumerate(verbs)]


@pytest.mark.parametrize("name", ["RemoteSeamGrpc", "RemoteSeamFaulty"])
def test_seam_rows_on_the_cpu(name):
    """Each seam row at a tiny size: every round placed; the clean row's
    remote and in-process placements equal; the faulty row kills, resyncs,
    fails over and back, and its remote rounds before the outage equal the
    in-process run's."""
    pytest.importorskip("grpc")
    row, results = bench.run_config(name, device="cpu", nodes=60, batch=64)
    d = row["detail"]
    assert results == [] and "error" not in d, d
    assert d["placed"] == [64] * 6
    if name == "RemoteSeamGrpc":
        assert d["assignments_equal"] and d["seam"] == "grpc"
    else:
        assert d["injected"]["kill"] == 1
        assert d["failover"]["remote_resyncs"] >= 1
        assert d["failover"]["failovers"] >= 1
        assert d["breakers"]["remote"] == 0.0 and d["remote_rounds_equal"]
