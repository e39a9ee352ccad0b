"""TorchBatchBackend.device_census on the CPU.

The census runs one step of each variant on a clone of the resident
state (ops/backend.py); here: its structure and determinism (the port of
tests/test_profiling.py's single-chip census case; the JAX census pin's
expectations are not carried over), that it leaves the placements, the
resident state, `_gen`, the mirror and kernels.LAUNCHES as they were,
that it runs outside the backend lock, the kernels' launch tally, and the
profiling: stanza's census through setup_cluster and
Scheduler.run_device_census setting the tpu_wave_flops and
tpu_step_hbm_bytes gauges, and perf.bench --profile's artifact.
"""

import json
import threading

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch import perf as port_perf
from kubernetes_tpu_torch.models import carry
from kubernetes_tpu_torch.ops import kernels
from kubernetes_tpu_torch.ops.faults import ChaosBatchBackend, OverloadSchedule
from kubernetes_tpu_torch.perf import bench
from kubernetes_tpu_torch.store import kv
from torch_cases import SEQ_BATCH, SEQ_CAPS, port_side, sequence

RECORD_KEYS = {"collectives", "per_call_bytes", "per_wave_bytes", "cost",
               "kernels", "device_ms", "waves", "batch"}


def loaded_side(batch=SEQ_BATCH):
    """A port stack with nodes and one resolved batch: resident state,
    mirror and pods on rows."""
    s = port_side(batch, SEQ_CAPS)
    rng = np.random.default_rng(3)
    for i in range(12):
        s.cache.add_node(s.node(f"n{i}", cpu=str(int(rng.integers(2, 9))),
                                mem="8Gi"))
    pods = [s.pod(f"p{i}", cpu=f"{int(rng.integers(2, 6)) * 100}m",
                  mem="256Mi") for i in range(batch)]
    s.assume(pods, s.backend.assign(s.infos(pods), s.snapshot()))
    return s


def test_census_structure():
    s = loaded_side()
    c = s.backend.device_census()
    assert list(c) == ["full", "plain"]
    for variant, rec in c.items():
        assert set(rec) == RECORD_KEYS, variant
        # one device: no collectives
        assert rec["collectives"] == {}
        assert rec["per_wave_bytes"] == 0 and rec["per_call_bytes"] == 0
        assert rec["cost"]["bytes_accessed"] > 0
        assert rec["waves"] >= 1
        assert rec["device_ms"] == 0.0   # no card
    plain = c["plain"]
    assert plain["cost"]["flops"] > 0
    assert plain["batch"]["pods"] == SEQ_BATCH
    assert c["full"]["batch"]["pods"] == s.backend.full_cap
    k = plain["kernels"]["claims"]
    P, N, R = SEQ_BATCH, SEQ_CAPS["n_cap"], s.backend.caps.r
    # one claims call a wave, each counted by the shared byte count
    assert k["bytes"] == plain["waves"] * kernels.claims_bytes(P, N, R)
    assert k["launches"] == 0 and k["bound_by"] == "bytes"
    assert k["bound_ms"] == pytest.approx(
        k["bytes"] / kernels.H100_HBM_BYTES_PER_S * 1e3)
    assert c["full"]["kernels"] == {}   # the full variant reaches no hand kernel


@pytest.mark.parametrize("variants", [("plain",), ("full",),
                                      ("full", "plain")])
def test_census_deterministic(variants):
    """The same census twice is identical, counts and structure."""
    s = loaded_side()
    a = s.backend.device_census(variants=variants)
    b = s.backend.device_census(variants=variants)
    assert list(a) == list(variants if len(variants) == 1
                           else ("full", "plain"))
    assert a == b


def test_census_request_reads_the_rows():
    """The census pod requests the smallest nonzero per-pod cpu and memory
    among the rows holding pods; an empty cluster gets the default."""
    s = port_side(8, SEQ_CAPS)
    s.cache.add_node(s.node("n0", cpu="8", mem="8Gi"))
    c = s.backend.device_census(variants=("plain",))
    assert c["plain"]["batch"]["req"][:2] == list(
        s.backend.CENSUS_DEFAULT_REQ)
    s = loaded_side()
    mirror = s.backend._mirror
    rows = mirror["npods"] > 0
    want = (mirror["used"][rows, 0] / mirror["npods"][rows]).min()
    got = s.backend.device_census(variants=("plain",))["plain"]["batch"]
    assert got["req"][0] == pytest.approx(float(want))


def test_census_leaves_the_backend_as_it_found_it():
    s = loaded_side()
    b = s.backend
    state0, _ = carry.state_to_numpy(b._state)
    mirror0 = {k: v.copy() for k, v in b._mirror.items()}
    gen0, launches0 = b._gen, dict(kernels.LAUNCHES)
    stats0 = dict(b.stats)
    b.device_census()
    state1, _ = carry.state_to_numpy(b._state)
    assert all(np.array_equal(state0[k], state1[k]) for k in state0)
    assert all(np.array_equal(mirror0[k], b._mirror[k]) for k in mirror0)
    assert b._gen == gen0
    assert kernels.LAUNCHES == launches0
    assert b.stats == stats0
    assert b._unresolved == [] and b._stage_pins == set()


def test_census_between_batches_keeps_placements():
    """The multi-batch sequence (row patches, a node add, a forced
    refresh) places every pod as it does without a census, with one
    census before each dispatch."""
    plain_out, _ = sequence(port_side(SEQ_BATCH, SEQ_CAPS))
    s = port_side(SEQ_BATCH, SEQ_CAPS)
    dispatch = s.backend.dispatch
    gens = []

    def census_then_dispatch(infos, view):
        before = s.backend._gen
        s.backend.device_census()
        gens.append(s.backend._gen - before)
        return dispatch(infos, view)

    s.backend.dispatch = census_then_dispatch
    out, _ = sequence(s)
    assert out == plain_out
    assert gens and set(gens) == {0}


def test_census_runs_outside_the_lock(monkeypatch):
    """The clone is taken under the backend lock; the step runs outside
    it (a concurrent dispatch is not stalled by a census)."""
    from kubernetes_tpu_torch.ops import backend as port_backend
    s = loaded_side()
    b = s.backend
    held = []
    real = port_backend.census_run

    def spy(*a, **kw):
        held.append(b._lock.locked())
        return real(*a, **kw)

    monkeypatch.setattr(port_backend, "census_run", spy)
    b.device_census()
    assert held == [False, False]


def test_launch_tally_keeps_launches_off_the_count():
    before = dict(kernels.LAUNCHES)
    try:
        with kernels.launch_tally() as tally:
            kernels.count_launch("claims")
            kernels.note_call("claims", shape=(4, 8, 6))
            seen = []
            t = threading.Thread(
                target=lambda: seen.append(kernels.count_launch("claims")))
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
        assert tally.launches == {"claims": 1, "preempt": 0}
        assert tally.calls == [("claims", {"shape": (4, 8, 6)})]
        # the other thread's launch counted where it always does
        assert kernels.LAUNCHES["claims"] == before["claims"] + 1
        kernels.count_launch("preempt")
        assert kernels.LAUNCHES["preempt"] == before["preempt"] + 1
    finally:
        kernels.LAUNCHES.update(before)


def test_claims_wrapper_notes_its_calls():
    static = kernels.prepare_static(
        torch.ones(3, 6), torch.ones(3, 6), torch.full((5, 6), 4.0),
        torch.full((5,), 110.0), torch.ones(5, 3, dtype=torch.bool))
    args = (static, torch.ones(3, dtype=torch.bool), torch.zeros(5, 6),
            torch.zeros(5, 6), torch.zeros(5))
    with kernels.launch_tally() as tally:
        kernels.claims(*args, noise="murmur")
    assert [name for name, _ in tally.calls] == ["claims"]
    assert tally.calls[0][1]["shape"] == (3, 5, 6)
    assert tally.launches["claims"] == 0   # the CPU runs the plain version


def test_claims_bytes_count():
    """The bytes one claims call moves: mask, requests, pod ids and
    active bits, node state, and the two outputs (ops/kernels.py)."""
    P, N, R = 16384, 110_080, 6
    want = (N * P + 2 * P * R * 4 + P + P * 4 + 3 * N * R * 4 + 2 * N * 4
            + P * 8)
    assert kernels.claims_bytes(P, N, R) == want
    ms, by = kernels.bound(want)
    assert by == "bytes" and round(ms, 4) == 0.5413


def test_census_through_chaos_forwarders():
    s = loaded_side()
    chaos = ChaosBatchBackend(s.backend, OverloadSchedule(seed=1))
    assert chaos.census_kind == "torch"
    assert chaos.device_census(variants=("plain",)) == \
        s.backend.device_census(variants=("plain",))


def _gauges(sched):
    m = sched.metrics.prom
    return m.tpu_wave_flops.values(), m.tpu_step_hbm_bytes.values()


def test_run_device_census_sets_the_gauges():
    from kubernetes_tpu_torch.client import LocalClient, SharedInformerFactory
    from kubernetes_tpu_torch.ops import backend as port_backend
    from kubernetes_tpu_torch.scheduler import (Profile, Scheduler,
                                                new_default_framework)
    client = LocalClient(kv.MemoryStore())
    factory = SharedInformerFactory(client)
    backend = port_backend.make_batch_backend(
        "tpu", port_perf.caps_for_nodes(8), batch_size=16, device="cpu")
    sched = Scheduler(client, factory, {"default-scheduler": Profile(
        new_default_framework(client, factory), batch_backend=backend,
        batch_size=16)})
    try:
        assert sched.run_device_census() == {}   # not armed
        sched.configure_profiling(None, None, census=True)
        census = sched.run_device_census()
    finally:
        client.close()
    assert list(census) == ["torch"]
    assert set(census["torch"]) == {"full", "plain"}
    flops, hbm = _gauges(sched)
    assert set(hbm) == {("torch", "full"), ("torch", "plain")}
    assert flops[("torch", "plain")] == census["torch"]["plain"]["cost"][
        "flops"] > 0
    assert hbm[("torch", "plain")] == census["torch"]["plain"]["cost"][
        "bytes_accessed"]


def test_setup_cluster_census_sets_the_gauges():
    from kubernetes_tpu_torch.scheduler.config import ProfilingPolicy
    cluster = port_perf.setup_cluster(
        profiling_policy=ProfilingPolicy(census=True), device="cpu",
        caps=port_perf.caps_for_nodes(8), batch_size=16)
    try:
        flops, hbm = _gauges(cluster.scheduler)
        census = cluster.scheduler._census
    finally:
        cluster.shutdown()
    assert set(census["torch"]) == {"full", "plain"}
    assert hbm[("torch", "plain")] > 0 and hbm[("torch", "full")] > 0
    assert flops[("torch", "plain")] > 0


def test_bench_profile_writes_its_artifact(tmp_path, capsys):
    out = tmp_path / "profile.json"
    assert bench.main(["--profile", "--device", "cpu", "--nodes", "30",
                       "--pods", "200", "--batch", "64",
                       "--out", str(out)]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["barrier_ok"] and row["profile_file"] == str(out)
    assert set(row["census"]) == {"torch-full", "torch-plain"}
    assert row["census"]["torch-plain"]["bytes_accessed"] > 0
    assert row["profiled_pods_per_s"] > 0 and row["unprofiled_pods_per_s"] > 0
    doc = json.loads(out.read_text())
    assert set(doc["device_census"]["torch"]) == {"full", "plain"}
    assert doc["rows"][0]["profile_samples"] > 0

