"""The wave timeline through the port's pipeline, on the CPU.

The port of tests/test_timeline.py's armed-pipeline cases: a shrunk
SchedulingBasicLarge with profiling.timeline armed yields per-pod segments
that sum to each pod's e2e within 1%, on the null device and on
TorchBatchBackend(device="cpu"); the backend records the patch, h2d,
device-step and d2h stages (the null device none of them); with the
stanza off the ring stays empty.  Then the stages' order within one wave,
and perf.bench --timeline writing its artifact.
"""

import copy
import json

import pytest

from kubernetes_tpu_torch.component_base import timeline as tlmod
from kubernetes_tpu_torch.perf import (
    caps_for_nodes, load_workloads, run_named_workload,
)
from kubernetes_tpu_torch.perf import bench
from kubernetes_tpu_torch.perf.scheduler_perf import is_measured
from kubernetes_tpu_torch.scheduler.config import ProfilingPolicy
from torch_cases import SEQ_BATCH, SEQ_CAPS, port_side

BACKEND_STAGES = {"patch", "h2d", "device-step", "d2h"}


def shrunk_basic(nodes: int, pods: int, timeout: float = 120.0) -> dict:
    cfg = copy.deepcopy(load_workloads()["SchedulingBasicLarge"])
    tpl = cfg["workloadTemplate"]
    for op in tpl:
        if op["opcode"] == "createNodes":
            op["count"] = nodes
        elif op["opcode"] == "createPods" and is_measured(op, tpl):
            op["count"] = pods
        elif op["opcode"] == "barrier":
            op["timeout"] = timeout
    return cfg


@pytest.fixture
def ring():
    tlmod.default_timeline.reset()
    yield tlmod.default_timeline
    tlmod.default_timeline.configure(enabled=False)
    tlmod.default_timeline.reset()


@pytest.mark.parametrize("null_device", [True, False])
def test_decomposition_telescopes_within_one_percent(ring, null_device):
    _summary, stats = run_named_workload(
        shrunk_basic(50, 400), caps=caps_for_nodes(50), batch_size=128,
        null_device=null_device, device="cpu",
        profiling_policy=ProfilingPolicy(timeline=True))
    assert stats.get("barrier_ok"), stats
    tl_stats = stats.get("timeline")
    assert tl_stats, "the harness did not surface timeline stats"
    assert tl_stats["device_idle_share"] is not None
    assert tl_stats["intervals"] > 0
    stages = set(tl_stats["stages"])
    assert {"batch-form", "resolve", "bind-commit"} <= stages, stages
    if null_device:
        assert not stages & {"h2d", "device-step", "d2h"}, stages
    else:
        assert BACKEND_STAGES <= stages, stages
        assert 0.0 <= tl_stats["device_idle_share"] < 1.0
    rows = ring.pods()
    assert rows, "no pods decomposed"
    for row in rows:
        seg_sum = sum(row["segments_ms"].values())
        assert seg_sum == pytest.approx(row["e2e_ms"], rel=0.01, abs=1e-6)
        assert all(v >= 0.0 for v in row["segments_ms"].values())
    segsum = tl_stats["segments"]
    assert segsum and all(s["count"] == len(rows) for s in segsum.values())
    assert set(segsum) <= set(tlmod.POD_SEGMENTS)


def test_default_off_leaves_ring_empty(ring):
    _summary, stats = run_named_workload(
        shrunk_basic(20, 100), caps=caps_for_nodes(20), batch_size=64,
        device="cpu")
    assert stats.get("barrier_ok"), stats
    assert "timeline" not in stats
    assert ring.intervals() == []
    assert ring.pods() == []


def test_off_backend_makes_no_wave_clock(ring, monkeypatch):
    """Disarmed, the backend builds no _WaveClock (and so no event)."""
    from kubernetes_tpu_torch.ops import backend
    made = []
    real = backend._WaveClock.__init__

    def spy(self, b):
        made.append(1)
        real(self, b)

    monkeypatch.setattr(backend._WaveClock, "__init__", spy)
    s = port_side(SEQ_BATCH, SEQ_CAPS)
    s.cache.add_node(s.node("n0", cpu="8", mem="8Gi"))
    pods = [s.pod(f"p{i}", cpu="100m") for i in range(4)]
    s.backend.assign(s.infos(pods), s.snapshot())
    assert made == [] and ring.intervals() == []
    ring.configure(enabled=True)
    s.backend.assign(s.infos([s.pod("q", cpu="100m")]), s.snapshot())
    assert made == [1]


def test_stages_of_one_wave_nest(ring):
    """One batch on the backend: patch before h2d, h2d ends where the
    device step starts (the launch), d2h inside device-step, and every
    interval is attributed to the wave the thread scopes."""
    ring.configure(enabled=True)
    s = port_side(SEQ_BATCH, SEQ_CAPS)
    for i in range(6):
        s.cache.add_node(s.node(f"n{i}", cpu="4", mem="8Gi"))
    pods = [s.pod(f"p{i}", cpu="300m") for i in range(SEQ_BATCH)]
    with ring.use_wave(7):
        resolve = s.backend.dispatch(s.infos(pods), s.snapshot())
        results = resolve()
    assert all(name for name, _st in results)
    rows = {r["stage"]: r for r in ring.intervals()}
    assert set(rows) == BACKEND_STAGES
    assert all(r["wave"] == 7 for r in rows.values())
    patch, h2d, dev, d2h = (rows[k] for k in ("patch", "h2d",
                                               "device-step", "d2h"))
    assert patch["t1_unix_s"] <= h2d["t0_unix_s"]
    assert h2d["t1_unix_s"] == pytest.approx(dev["t0_unix_s"], abs=1e-9)
    assert dev["t0_unix_s"] <= d2h["t0_unix_s"] <= d2h["t1_unix_s"]
    assert d2h["t1_unix_s"] == pytest.approx(dev["t1_unix_s"], abs=1e-9)
    marks = ring.wave_marks(7)
    assert set(marks) == BACKEND_STAGES


def test_fenced_rerun_stays_inside_device_step(ring):
    """A fenced wave (row patches over an in-flight wave) re-runs from the
    mirror at resolve; device-step still ends after the re-run landed and
    the wave records one d2h."""
    ring.configure(enabled=True)
    s = port_side(SEQ_BATCH, SEQ_CAPS)
    for i in range(6):
        s.cache.add_node(s.node(f"n{i}", cpu="4", mem="8Gi"))
    view = s.cache.flatten_view()
    first = [s.pod(f"a{i}", cpu="200m") for i in range(8)]
    r0 = s.backend.dispatch(s.infos(first), view)
    out0 = r0()
    s.assume(first, out0)
    second = [s.pod(f"b{i}", cpu="200m") for i in range(8)]
    r1 = s.backend.dispatch(s.infos(second), view)
    # a pod deleted while the second wave is in flight: the third patches
    bound = next(p for p, (n, _) in zip(first, out0) if n)
    s.cache.forget_pod({**bound, "spec": {**bound["spec"],
                                          "nodeName": out0[0][0]}})
    third = [s.pod(f"c{i}", cpu="200m") for i in range(8)]
    r2 = s.backend.dispatch(s.infos(third), view)
    assert callable(r2)
    s.assume(second, r1())
    r2()
    assert s.backend.stats.get("fenced_waves", 0) == 1
    devs = [r for r in ring.intervals() if r["stage"] == "device-step"]
    d2hs = [r for r in ring.intervals() if r["stage"] == "d2h"]
    assert len(devs) == len(d2hs) == 3
    last_dev, last_d2h = devs[-1], d2hs[-1]
    assert last_dev["t0_unix_s"] <= last_d2h["t0_unix_s"]
    assert last_d2h["t1_unix_s"] <= last_dev["t1_unix_s"] + 1e-9


def test_bench_timeline_writes_its_artifact(ring, tmp_path, capsys):
    out = tmp_path / "timeline.json"
    assert bench.main(["--timeline", "--device", "cpu", "--nodes", "30",
                       "--pods", "200", "--batch", "64",
                       "--out", str(out)]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["barrier_ok"] and row["timeline_file"] == str(out)
    assert row["timed_pods_per_s"] > 0 and row["untimed_pods_per_s"] > 0
    assert BACKEND_STAGES <= set(row["stages"])
    doc = json.loads(out.read_text())
    assert doc["rows"][0]["pods_decomposed"] > 0
    names = {e.get("name") for e in doc["chrome_trace"]["traceEvents"]}
    assert {"h2d", "device-step", "d2h"} <= names
    # the off pass left the ring disarmed
    assert not ring.enabled
