"""The port's batch telemetry held against the JAX package's, exactly.

The per-plugin mask densities, the score-term densities and the drained
per-batch dicts ({pods, feasible_nodes, mask_density, waves}) are host
numpy over the encoded PodBatch, so TorchBatchBackend's must equal
TPUBatchBackend's bit for bit: on tests/torch_cases.py's constraint
batches (FULL_CASES, encoded by the port's flattener, a copy of the JAX
one) and a plain batch, and drained after the same dispatches through
each package's own stack (the plain multi-batch sequence and a constraint
mix).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

from kubernetes_tpu.ops import backend as jax_backend  # noqa: E402
from kubernetes_tpu.ops.flatten import Caps as JaxCaps  # noqa: E402
from kubernetes_tpu_torch.ops import backend as port_backend  # noqa: E402
from kubernetes_tpu_torch.ops.flatten import Caps  # noqa: E402
from test_torch_backend import jax_side  # noqa: E402
from torch_cases import (  # noqa: E402
    CAPS, FULL_CAPS, FULL_CASES, SEQ_BATCH, SEQ_CAPS, make_full_case,
    port_side, sequence,
)

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"


def backends(caps: dict, batch_size: int):
    return (jax_backend.TPUBatchBackend(JaxCaps(**caps),
                                        batch_size=batch_size),
            port_backend.TorchBatchBackend(Caps(**caps),
                                           batch_size=batch_size,
                                           device="cpu"))


@pytest.mark.parametrize("name", sorted(FULL_CASES))
def test_densities_equal_on_constraint_batches(name):
    _caps, _state, _static, batch, _patches = make_full_case(name)
    P = batch.p_cap
    ref, got = backends(FULL_CAPS, P)
    for n in (P, P // 3, 1):
        want_m = ref._mask_densities(batch, n)
        want_s = ref._score_densities(batch, n)
        assert got._mask_densities(batch, n) == want_m
        assert got._score_densities(batch, n) == want_s
        assert list(got._mask_densities(batch, n)) == list(want_m)


def test_densities_nonzero_somewhere():
    """The constraint cases exercise every plugin family's density."""
    seen = set()
    for name in FULL_CASES:
        _c, _s, _st, batch, _p = make_full_case(name)
        _ref, got = backends(FULL_CAPS, batch.p_cap)
        dens = {**got._mask_densities(batch, batch.p_cap),
                **got._score_densities(batch, batch.p_cap)}
        seen |= {k for k, v in dens.items() if v > 0}
    assert seen >= {"NodeAffinity", "InterPodAffinity", "PodTopologySpread",
                    "TaintToleration", "NodePorts", "NodeName",
                    "preferred_affinity", "prefer_no_schedule"}


def test_densities_equal_on_a_plain_batch():
    s = port_side(SEQ_BATCH, SEQ_CAPS)
    rng = np.random.default_rng(5)
    pods = [s.pod(f"p{i}", cpu=f"{int(rng.integers(1, 9)) * 100}m")
            for i in range(SEQ_BATCH - 5)]
    batch = s.backend.encoder.encode(s.infos(pods))
    ref, got = backends(SEQ_CAPS, SEQ_BATCH)
    want = ref._mask_densities(batch, len(pods))
    assert got._mask_densities(batch, len(pods)) == want
    assert set(want.values()) == {0.0}
    assert got._score_densities(batch, len(pods)) == \
        ref._score_densities(batch, len(pods))


def test_drained_telemetry_equal_on_the_sequence(monkeypatch):
    """Six plain batches (row patches, a node add, a forced refresh): one
    dict per batch, equal key for key."""
    monkeypatch.setenv("KTPU_PALLAS", "0")
    j, p = jax_side(SEQ_BATCH, SEQ_CAPS), port_side(SEQ_BATCH, SEQ_CAPS)
    out_j, _ = sequence(j)
    out_p, _ = sequence(p)
    assert out_p == out_j
    want = j.backend.drain_batch_telemetry()
    got = p.backend.drain_batch_telemetry()
    assert len(got) == 6
    assert got == want
    assert p.backend.drain_batch_telemetry() == []


def constraint_batches(s):
    for i in range(9):
        s.cache.add_node(
            s.testing.make_node(f"z{i}").capacity(cpu="8", mem="16Gi")
            .labels(**{HOST: f"z{i}", "disk": "ssd" if i % 2 else "hdd"})
            .zone("abc"[i % 3]).build())
    out = []
    for k in range(2):
        pods = []
        for i in range(CAPS_BATCH):
            w = s.testing.make_pod(f"c{k}-{i}").req(cpu="200m", mem="128Mi")
            if i % 4 == 1:
                w = w.node_selector(disk="ssd")
            elif i % 4 == 2:
                w = w.labels(app="sp").topology_spread(
                    ZONE, max_skew=1, match_labels={"app": "sp"})
            elif i % 4 == 3:
                w = w.labels(app="an").pod_affinity(HOST, {"app": "an"},
                                                    anti=True)
            pods.append(w.build())
        out.append(pods)
    return out


CAPS_BATCH = 12


def test_drained_telemetry_equal_on_constraint_batches(monkeypatch):
    monkeypatch.setenv("KTPU_PALLAS", "0")
    caps = dict(CAPS, g_cap=2, kg_cap=2, c_cap=2)
    j, p = jax_side(CAPS_BATCH, caps), port_side(CAPS_BATCH, caps)
    for s in (j, p):
        for pods in constraint_batches(s):
            results = s.backend.assign(s.infos(pods), s.snapshot())
            s.assume(pods, results)
    want = j.backend.drain_batch_telemetry()
    got = p.backend.drain_batch_telemetry()
    assert len(got) == 2 and got == want
    assert all(t["mask_density"]["PodTopologySpread"] > 0 for t in got)


def test_telemetry_queue_is_bounded():
    """At most TELEMETRY_PENDING_MAX dicts wait for a drain, the newest."""
    s = port_side(4, SEQ_CAPS)
    s.cache.add_node(s.node("n0", cpu="64", mem="64Gi", pods=110))
    cap = s.backend.TELEMETRY_PENDING_MAX
    for k in range(cap + 3):
        pods = [s.pod(f"b{k}-{i}", cpu="10m") for i in range(k % 4 + 1)]
        s.backend.assign(s.infos(pods), s.snapshot())
    got = s.backend.drain_batch_telemetry()
    assert len(got) == cap
    assert [t["pods"] for t in got[-4:]] == [
        k % 4 + 1 for k in range(cap - 1, cap + 3)]
