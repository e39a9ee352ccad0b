"""The port's api/meta.deep_copy held against the JAX package's (its
native JSON copier, utils/fastcopy.py, with copy.deepcopy as fallback):
the same copy of every tree, the copy independent of the original, and
the same fallback for what is not a JSON tree."""

import copy

import numpy as np
import pytest

from kubernetes_tpu.api import meta as jmeta
from kubernetes_tpu_torch.api import meta as tmeta
from kubernetes_tpu_torch.testing import make_node, make_pod


def _random_tree(rng, depth=0):
    kind = int(rng.integers(7 if depth < 5 else 4))
    if kind == 0:
        return None
    if kind == 1:
        return bool(rng.random() < 0.5)
    if kind == 2:
        return (int(rng.integers(-9, 9)), float(rng.random()))[
            int(rng.random() < 0.5)]
    if kind == 3:
        return f"s{int(rng.integers(100))}"
    if kind == 4:
        return [_random_tree(rng, depth + 1)
                for _ in range(int(rng.integers(4)))]
    if kind == 5:
        return tuple(_random_tree(rng, depth + 1)
                     for _ in range(int(rng.integers(3))))
    return {f"k{i}": _random_tree(rng, depth + 1)
            for i in range(int(rng.integers(4)))}


def _objects():
    pod = (make_pod("p-1").labels(app="web", tier="db").req(cpu="10m",
           memory="16Mi").pod_affinity("kubernetes.io/hostname",
                                       {"app": "web"}, anti=True).build())
    node = make_node("n-1").capacity(cpu="64", mem="256Gi",
                                     pods=1000).build()
    return [pod, node] + [_random_tree(np.random.default_rng(s))
                          for s in range(12)]


@pytest.mark.parametrize("obj", _objects())
def test_same_copy_as_jax(obj):
    got, want = tmeta.deep_copy(obj), jmeta.deep_copy(obj)
    assert got == want == obj
    assert type(got) is type(want)


@pytest.mark.parametrize("seed", range(4))
def test_copy_is_independent(seed):
    obj = {"metadata": {"labels": {"a": "b"}},
           "spec": {"list": [{"x": [1, 2]}, {"y": {}}],
                    "tup": ({"z": []},)},
           "seed": seed}
    got = tmeta.deep_copy(obj)
    got["metadata"]["labels"]["a"] = "c"
    got["spec"]["list"][0]["x"].append(3)
    got["spec"]["tup"][0]["z"].append(1)
    assert obj["metadata"]["labels"]["a"] == "b"
    assert obj["spec"]["list"][0]["x"] == [1, 2]
    assert obj["spec"]["tup"][0]["z"] == []


class _Opaque:
    def __init__(self):
        self.inner = {"a": [1]}


@pytest.mark.parametrize("leaf", [{1, 2}, _Opaque(), b"raw"])
def test_non_json_falls_back_to_deepcopy(leaf):
    obj = {"a": [leaf], "b": {"c": leaf}}
    got = tmeta.deep_copy(obj)
    want = copy.deepcopy(obj)
    # copy.deepcopy keeps the aliasing of the two references to the leaf
    assert (got["a"][0] is got["b"]["c"]) == (want["a"][0] is want["b"]["c"])
    assert got["a"][0] is not leaf or isinstance(leaf, bytes)
    jgot = jmeta.deep_copy(obj)
    assert (jgot["a"][0] is jgot["b"]["c"]) == (got["a"][0] is got["b"]["c"])
