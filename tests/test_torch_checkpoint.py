"""Checkpointed warm start across lineages: the JAX package's
TPUBatchBackend (KTPU_PALLAS=0) and the port's TorchBatchBackend
(device="cpu", claims_noise="murmur") read each other's KTPUCKPT v1 files.

The pattern of tests/test_churn_parity.py's warm-start parity: a seeded
event + wave stream (build_ops, constraint pods included) runs up to a
wave boundary on one backend, which writes checkpoint_mirror; a FRESH
backend of the other package warm-starts from the file, its FRESH cache is
primed with the checkpoint's objects (a restarted informer's replay), and
it runs the rest of the stream.  In both directions every checkpointed row
is adopted verbatim and every wave (before and after the restart) assigns
bit for bit what an uninterrupted run assigns, and the adopted tensors
equal a from-scratch re-encode.  A corrupt body, a wrong schema version, a
bad magic and wrong caps raise CheckpointError before the backend changes.
"""

import copy

import numpy as np
import pytest

pytest.importorskip("jax")

import kubernetes_tpu.scheduler.cache as jax_cache  # noqa: E402
import kubernetes_tpu.scheduler.types as jax_types  # noqa: E402
from kubernetes_tpu.ops import backend as jax_backend  # noqa: E402
import kubernetes_tpu_torch.scheduler.cache as port_cache  # noqa: E402
import kubernetes_tpu_torch.scheduler.types as port_types  # noqa: E402
from kubernetes_tpu_torch.api import meta  # noqa: E402
from kubernetes_tpu_torch.ops import backend as port_backend  # noqa: E402
from kubernetes_tpu_torch.ops.flatten import Caps  # noqa: E402
from test_churn_parity import (  # noqa: E402
    _PARITY_FIELDS, _split_at_wave, build_ops, run_scenario, small_caps,
)

JAX, PORT = "jax", "port"
PKG = {JAX: (jax_cache, jax_types, jax_backend),
       PORT: (port_cache, port_types, port_backend)}


def make_backend(side):
    if side == JAX:
        return jax_backend.TPUBatchBackend(small_caps(), batch_size=16)
    return port_backend.TorchBatchBackend(
        Caps(**vars(small_caps())), batch_size=16, device="cpu",
        claims_noise="murmur")


def _event(side, cache, backend, kind, node):
    node = copy.deepcopy(node)
    if kind == "DELETED":
        cache.remove_node(node)
    elif kind == "ADDED":
        cache.add_node(node)
    else:
        cache.update_node(node)
    backend.note_node_event(kind, meta.name(node), cache.flatten_view())


def run_tracked(side, backend, cache, ops, store):
    """test_churn_parity._run_tracked on `side`'s Cache and PodInfo: run
    the ops and keep `store`, the objects a restarted informer is primed
    with (the latest object of each live node, every bound pod)."""
    _cache_mod, types, backend_mod = PKG[side]
    waves = []

    def apply(kind, node):
        name = meta.name(node)
        if kind == "DELETED":
            store["nodes"].pop(name, None)
        else:
            store["nodes"][name] = node
        _event(side, cache, backend, kind, node)

    for op in ops:
        if op[0] == "event":
            apply(op[1], op[2])
        elif op[0] == "compact":
            with backend._lock:
                backend.tensors.compact()
        else:
            pod_objs = [copy.deepcopy(p) for p in op[1]]
            resolve = backend.dispatch([types.PodInfo(p) for p in pod_objs],
                                       cache.flatten_view())
            assert resolve is not backend_mod.FLUSH_FIRST
            for kind, _t, node in op[2]:
                apply(kind, node)
            w = []
            for pod, (name, status) in zip(pod_objs, resolve()):
                w.append((name, None if status is None else status.code))
                if name:
                    bound = copy.deepcopy(pod)
                    bound.setdefault("spec", {})["nodeName"] = name
                    cache.add_pod(bound)
                    store["pods"].append(bound)
            waves.append(w)
    return waves


def restart_across(writer, reader, ops, split_wave, path):
    """Run `ops` up to split_wave on a `writer` backend, checkpoint it,
    resume the rest on a fresh `reader` backend primed from the file.
    Returns (reader backend, its cache, every wave, checkpoint info)."""
    first, rest = _split_at_wave(ops, split_wave)
    a = make_backend(writer)
    cache_a = PKG[writer][0].Cache()
    store = {"nodes": {}, "pods": []}
    waves = run_tracked(writer, a, cache_a, first, store)
    info = a.checkpoint_mirror(
        path, snapshot=cache_a.flatten_view(),
        resource_versions={"nodes": 1, "pods": 1},
        objects={"nodes": [copy.deepcopy(n) for n in store["nodes"].values()],
                 "pods": [copy.deepcopy(p) for p in store["pods"]]})
    b = make_backend(reader)
    warm = b.warm_start(path)
    assert warm["nodes"] == info["nodes"] > 0
    assert warm["lineage"] == ("tpu" if writer == JAX else "torch")
    # the reader's own classes, whichever package wrote the file
    own = "kubernetes_tpu" if reader == JAX else "kubernetes_tpu_torch"
    assert type(b.tensors).__module__ == f"{own}.ops.flatten"
    assert all(type(g).__module__ == f"{own}.ops.flatten"
               for g in b.tensors.sgs + b.tensors.asgs)
    cache_b = PKG[reader][0].Cache()
    for n in warm["objects"]["nodes"]:
        cache_b.add_node(n)
    for p in warm["objects"]["pods"]:
        cache_b.add_pod(p)
    assert b.warm_align(cache_b.flatten_view()) == 0
    # every checkpointed row matches the primed replay: all adopted
    assert b.stats.get("warm_adopted", 0) == info["nodes"]
    assert b.stats.get("warm_starts", 0) == 1
    waves += run_tracked(reader, b, cache_b, rest, store)
    return b, cache_b, waves, info


def reencode_parity(side, backend, cache):
    """test_churn_parity.assert_full_reencode_parity on `side`'s cache."""
    with backend._lock:
        backend.tensors.update_from_snapshot_tracked(cache.flatten_view())
        t = copy.deepcopy(backend.tensors)
    before = {k: np.array(getattr(t, k), copy=True) for k in _PARITY_FIELDS}
    rows = dict(t.row_of)
    t.gen[:] = -1
    t.node_gen[:] = -1
    t.update_from_snapshot_tracked(
        cache.update_snapshot(PKG[side][0].Snapshot()))
    assert dict(t.row_of) == rows
    for k in _PARITY_FIELDS:
        np.testing.assert_array_equal(before[k], np.asarray(getattr(t, k)),
                                      err_msg=k)


@pytest.fixture
def control(monkeypatch):
    """The uninterrupted stream on the JAX backend (the port's equals it:
    tests/test_torch_backend_full.py's churn streams)."""
    monkeypatch.setenv("KTPU_PALLAS", "0")

    def run(ops):
        _cache, waves = run_scenario(
            jax_backend.TPUBatchBackend(small_caps(), batch_size=16), ops)
        return waves
    return run


@pytest.mark.upgrade
@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX),
                                           (PORT, PORT)])
@pytest.mark.parametrize("seed,split", [(42, 2), (7, 1)])
def test_warm_start_across_lineages(tmp_path, control, writer, reader,
                                    seed, split):
    ops = build_ops(seed, rounds=3, base_nodes=9, constraint_pods=True)
    want = control(ops)
    b, cache_b, waves, _info = restart_across(
        writer, reader, ops, split, str(tmp_path / "cross.ckpt"))
    assert waves == want
    assert any(n for w in waves for n, _ in w)
    reencode_parity(reader, b, cache_b)


def test_port_checkpoint_names_the_reference_classes(tmp_path):
    """The port writes its classes under the JAX package's module names
    and never imports that package to do it."""
    b = make_backend(PORT)
    cache = port_cache.Cache()
    cache.add_node(port_testing_node("n0"))
    b.prefetch(cache.flatten_view())
    path = tmp_path / "names.ckpt"
    b.checkpoint_mirror(str(path), snapshot=cache.flatten_view())
    body = path.read_bytes()
    assert b"kubernetes_tpu.ops.flatten:ClusterTensors" in body
    assert b"kubernetes_tpu_torch" not in body


def port_testing_node(name):
    from kubernetes_tpu_torch.testing import make_node
    return make_node(name).capacity(cpu="4", mem="8Gi").build()


def _checkpoint(tmp_path, writer=PORT):
    b = make_backend(writer)
    cache = PKG[writer][0].Cache()
    store = {"nodes": {}, "pods": []}
    ops = build_ops(5, rounds=2, base_nodes=6)
    run_tracked(writer, b, cache, ops, store)
    path = tmp_path / "good.ckpt"
    b.checkpoint_mirror(str(path), snapshot=cache.flatten_view())
    return path


def _corrupt_body(raw):
    raw = bytearray(raw)
    raw[-7] ^= 0xFF
    return bytes(raw)


def _wrong_version(raw):
    return raw[:8] + (2).to_bytes(4, "big") + raw[12:]


def _bad_magic(raw):
    return b"NOTACKPT" + raw[8:]


def _truncated(raw):
    return raw[:10]


BROKEN = {"corrupt_body": (_corrupt_body, "crc"),
          "wrong_version": (_wrong_version, "schema v2"),
          "bad_magic": (_bad_magic, "bad magic"),
          "truncated": (_truncated, "bad magic")}


@pytest.mark.parametrize("writer", [JAX, PORT])
@pytest.mark.parametrize("case", sorted(BROKEN))
def test_bad_checkpoint_raises_before_any_change(tmp_path, monkeypatch,
                                                 writer, case):
    monkeypatch.setenv("KTPU_PALLAS", "0")
    good = _checkpoint(tmp_path, writer).read_bytes()
    mutate, match = BROKEN[case]
    bad = tmp_path / f"{case}.ckpt"
    bad.write_bytes(mutate(good))
    b = make_backend(PORT)
    tensors, stats = b.tensors, dict(b.stats)
    with pytest.raises(port_backend.CheckpointError, match=match):
        b.warm_start(str(bad))
    assert b.tensors is tensors and b.stats == stats
    assert not b._warm_pending


@pytest.mark.parametrize("writer", [JAX, PORT])
def test_wrong_caps_raise_before_any_change(tmp_path, monkeypatch, writer):
    monkeypatch.setenv("KTPU_PALLAS", "0")
    path = _checkpoint(tmp_path, writer)
    other = port_backend.TorchBatchBackend(
        Caps(**{**vars(small_caps()), "n_cap": 64}), batch_size=16,
        device="cpu")
    tensors = other.tensors
    with pytest.raises(port_backend.CheckpointError, match="caps"):
        other.warm_start(str(path))
    assert other.tensors is tensors and "warm_starts" not in other.stats


def test_missing_file_raises(tmp_path):
    with pytest.raises(port_backend.CheckpointError, match="unreadable"):
        make_backend(PORT).warm_start(str(tmp_path / "absent.ckpt"))


def test_format_constants_equal_the_reference():
    assert port_backend.CHECKPOINT_MAGIC == jax_backend.CHECKPOINT_MAGIC
    assert (port_backend.CHECKPOINT_SCHEMA_VERSION
            == jax_backend.CHECKPOINT_SCHEMA_VERSION)
    assert port_backend.CHECKPOINT_FIELDS == jax_backend.CHECKPOINT_FIELDS
