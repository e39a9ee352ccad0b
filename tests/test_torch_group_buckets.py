"""The port's shared selector-group buckets (ops/flatten.py GroupBucket)
held against the JAX package's: a bucket looks its single-(key, value)
members up by the pod's labels instead of matching every member, and the
counts it gives must stay those of the JAX mirror.

Same seeded cluster (numpy) in both packages: nodes with resident pods of
many services, then hundreds of selector groups registered into a few
slots, so most registrations join a shared bucket and recount the
residents.  Compared exactly: the bucket of every group, every count row
(cnt_sg, cnt_asg) and every bucket's verdict on every resident pod.
"""

import numpy as np
import pytest

import kubernetes_tpu.api.labels as jlabels
import kubernetes_tpu.ops.flatten as jflat
import kubernetes_tpu.scheduler.cache as jcache
import kubernetes_tpu.scheduler.types as jtypes
import kubernetes_tpu_torch.api.labels as tlabels
import kubernetes_tpu_torch.ops.flatten as tflat
import kubernetes_tpu_torch.scheduler.cache as tcache
import kubernetes_tpu_torch.scheduler.types as ttypes

HOST = "kubernetes.io/hostname"
ZONE = "topology.kubernetes.io/zone"
N_NODES = 24
N_SVC = 40


def _cluster(seed):
    """Nodes (two zones) and resident pods: a service label from N_SVC,
    a tier label on some, a namespace of two, a few being deleted."""
    rng = np.random.default_rng(seed)
    nodes = [{"metadata": {"name": f"n{i}", "labels": {
        HOST: f"n{i}", ZONE: f"z{i % 2}"}},
        "status": {"allocatable": {"cpu": "64", "memory": "256Gi",
                                   "pods": "110"}}}
        for i in range(N_NODES)]
    pods = []
    for j in range(int(rng.integers(60, 120))):
        labels = {"app": f"svc-{int(rng.integers(N_SVC))}"}
        if rng.random() < 0.4:
            labels["tier"] = ("web", "db", "cache")[int(rng.integers(3))]
        md = {"name": f"p{j}", "uid": f"u{j}", "labels": labels,
              "namespace": ("default", "other")[int(rng.random() < 0.2)]}
        if rng.random() < 0.05:
            md["deletionTimestamp"] = "2026-01-01T00:00:00Z"
        pods.append({"metadata": md, "spec": {
            "nodeName": f"n{int(rng.integers(N_NODES))}",
            "containers": [{"name": "c", "resources": {
                "requests": {"cpu": "100m"}}}]}})
    return nodes, pods


def _selectors(seed):
    """Selector dicts in registration order: mostly one exact label (the
    per-service shape), with In of two values, NotIn, Exists and
    two-requirement selectors among them, each with its topology key and
    namespaces."""
    rng = np.random.default_rng(seed + 1)
    out = []
    for k in range(int(rng.integers(150, 250))):
        shape = int(rng.integers(6))
        svc = f"svc-{int(rng.integers(N_SVC + 5))}"
        if shape <= 2:
            sel = {"matchLabels": {"app": svc}}
        elif shape == 3:
            sel = {"matchExpressions": [{"key": "app", "operator": "In",
                                         "values": [svc, "svc-1"]}]}
        elif shape == 4:
            sel = {"matchExpressions": [
                {"key": "tier", "operator": ("NotIn", "Exists")[k % 2],
                 **({"values": ["db"]} if k % 2 == 0 else {})}]}
        else:
            sel = {"matchLabels": {"app": svc, "tier": "web"}}
        ns = (("default",), ("default", "other"))[int(rng.random() < 0.3)]
        out.append((sel, (HOST, ZONE)[int(rng.random() < 0.25)], ns,
                    bool(rng.random() < 0.8)))
    return out


def _mirror(flat, labels, cache_mod, types_mod, nodes, pods, sels):
    cache = cache_mod.Cache()
    for n in nodes:
        cache.add_node(n)
    for p in pods:
        cache.add_pod(p)
    t = flat.ClusterTensors(flat.Caps(n_cap=32, sg_cap=5, asg_cap=3))
    t.update_from_snapshot_tracked(cache.flatten_view())
    got = []
    for sel, topo, ns, shareable in sels:
        g = flat.SelectorGroup(topo, labels.selector_from_dict(sel),
                               frozenset(ns))
        got.append((t.register_sg(g, shareable=shareable),
                    t.register_asg(flat.SelectorGroup(
                        topo, labels.selector_from_dict(sel),
                        frozenset(ns)))))
    infos = [types_mod.PodInfo(p) for p in pods]
    verdicts = [[b.matches_pod(pi) for pi in infos]
                for b in (*t.sgs, *t.asgs)]
    return t, got, verdicts


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_shared_buckets_equal_jax(seed):
    nodes, pods = _cluster(seed)
    sels = _selectors(seed)
    jt, jgot, jv = _mirror(jflat, jlabels, jcache, jtypes, nodes, pods,
                           sels)
    tt, tgot, tv = _mirror(tflat, tlabels, tcache, ttypes, nodes, pods,
                           sels)
    assert any(b.collided for b in tt.sgs)   # the joins were exercised
    assert tgot == jgot
    assert tv == jv
    np.testing.assert_array_equal(tt.cnt_sg, jt.cnt_sg)
    np.testing.assert_array_equal(tt.dom_sg, jt.dom_sg)
    np.testing.assert_array_equal(tt.cnt_asg, jt.cnt_asg)


@pytest.mark.parametrize("seed", [0, 1])
def test_bucket_verdict_is_any_member(seed):
    """Each bucket's verdict on a pod is whether any of its members
    matches it (the definition the index must keep)."""
    nodes, pods = _cluster(seed)
    t, _, verdicts = _mirror(tflat, tlabels, tcache, ttypes, nodes, pods,
                             _selectors(seed))
    infos = [ttypes.PodInfo(p) for p in pods]
    want = [[any(g.matches_pod(pi) for g in b.groups) for pi in infos]
            for b in (*t.sgs, *t.asgs)]
    assert verdicts == want
