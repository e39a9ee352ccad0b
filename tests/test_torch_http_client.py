"""The wire across packages: the port's HTTPClient
(kubernetes_tpu_torch/client/http_client.py) against the JAX package's
APIServer, and the JAX HTTPClient against the port's.  Each script runs
once with the JAX client against the JAX server (the reference) and once
across the packages; what the client returns (objects, lists, watch
events, per-item bulk results, the error a status maps to, with its code)
must be equal, with only uid, creationTimestamp and a managed field's time
exempt.  Then LocalClient.apply (server-side apply in process) gives the
same objects in both packages over a few apply sequences.
"""

import pytest

from torch_front_door import (
    ADMIN, DEV, ROOTS, TOKENS, Side, normalise, package, wait_for,
)

JAX, PORT = ROOTS


def _pod(pkg, name, cpu="100m", labels=None):
    return pkg.testing.make_pod(name).req(cpu=cpu, mem="64Mi").labels(
        **(labels or {})).build()


def _node(pkg, name):
    return pkg.testing.make_node(name).capacity(cpu="4", mem="8Gi").build()


def _error(exc):
    """An error as the client raised it: its class name, and the status
    code for an HTTPError."""
    return (type(exc).__name__, getattr(exc, "code", None))


def _try(out, fn, *args, **kwargs):
    try:
        res = fn(*args, **kwargs)
    except Exception as e:  # noqa: BLE001 - the error is the result
        out.append(("error", _error(e)))
        return None
    out.append(("ok", normalise(res)))
    return res


# -- the scripts: (client package, client, admin client) -> transcript ----

def bulk_and_list(pkg, c, dev):
    out = []
    c.create(pkg.clientset.NODES, _node(pkg, "n1"))
    c.create_bulk(pkg.clientset.PODS,
                  [_pod(pkg, f"p{i}", labels={"i": str(i % 2)})
                   for i in range(300)])
    items, rv = c.list(pkg.clientset.PODS)
    out.append((len(items), rv, normalise(items[:3])))
    items, rv = c.list(pkg.clientset.PODS, "default")
    out.append((len(items), rv))
    _try(out, c.create_bulk, pkg.clientset.PODS,
         [_pod(pkg, "p0"), _pod(pkg, "new")])      # one already exists
    out.append(len(c.list(pkg.clientset.PODS)[0]))
    return out


def watch_stream(pkg, c, dev):
    out = []
    _, rv = c.list(pkg.clientset.PODS)
    c.create(pkg.clientset.PODS, _pod(pkg, "a"))
    c.create(pkg.clientset.PODS, _pod(pkg, "b"))
    cur = c.get(pkg.clientset.PODS, "default", "a")
    cur["metadata"]["labels"] = {"v": "2"}
    c.update(pkg.clientset.PODS, cur)
    c.delete(pkg.clientset.PODS, "default", "b")
    w = c.watch(pkg.clientset.PODS, since_rv=rv)
    evs = []
    try:
        assert wait_for(lambda: evs.extend(w.next_batch(timeout=0.2) or ())
                        or len(evs) >= 4)
    finally:
        w.stop()
    out.append([(e.type, normalise(e.object)) for e in evs])
    return out


def bind_and_bind_many(pkg, c, dev):
    out = []
    for n in ("n1", "n2"):
        c.create(pkg.clientset.NODES, _node(pkg, n))
    for i in range(4):
        c.create(pkg.clientset.PODS, _pod(pkg, f"p{i}"))
    p0 = c.get(pkg.clientset.PODS, "default", "p0")
    _try(out, c.bind, p0, "n1")
    _try(out, c.bind, p0, "n2")                     # already bound: 409
    res = c.bind_many([("default", "p1", "n1"), ("default", "p2", "n2"),
                       ("default", "p0", "n2"), ("default", "nope", "n1")])
    out.append([(normalise(o), e and _error(e)) for o, e in res])
    out.append(sorted((p["metadata"]["name"], p["spec"].get("nodeName"))
                      for p in c.list(pkg.clientset.PODS)[0]))
    return out


def status_errors(pkg, c, dev):
    out = []
    PODS = pkg.clientset.PODS
    _try(out, c.get, PODS, "default", "missing")            # 404
    created = _try(out, c.create, PODS, _pod(pkg, "p"))
    _try(out, c.create, PODS, _pod(pkg, "p"))               # 409 exists
    fresh = c.get(PODS, "default", "p")
    fresh["metadata"]["labels"] = {"v": "1"}
    _try(out, c.update, PODS, fresh)
    created["metadata"]["labels"] = {"v": "stale"}
    _try(out, c.update, PODS, created)                      # 409 stale
    _try(out, dev.list, PODS)                               # 403
    _try(out, dev.create, PODS, _pod(pkg, "q"))             # 403
    _try(out, c.delete, PODS, "default", "missing")         # 404
    return out


def patch_and_apply(pkg, c, dev):
    out = []
    PODS = pkg.clientset.PODS
    c.create(PODS, _pod(pkg, "p", labels={"a": "1"}))
    _try(out, c.patch, PODS, "default", "p",
         {"metadata": {"labels": {"b": "2"}}})
    _try(out, c.patch, PODS, "default", "p",
         {"metadata": {"labels": {"a": None}}},
         patch_type="application/merge-patch+json")
    cm = {"apiVersion": "v1", "kind": "ConfigMap",
          "metadata": {"name": "cm", "namespace": "default"},
          "data": {"k": "v"}}
    _try(out, c.apply, "configmaps", cm, field_manager="one")
    _try(out, c.apply, "configmaps", {**cm, "data": {"k": "w"}},
         field_manager="two")                               # conflict
    _try(out, c.apply, "configmaps", {**cm, "data": {"k": "w"}},
         field_manager="two", force=True)
    return out


def informer_sync(pkg, c, dev):
    """A SharedInformerFactory of the client's package syncs over the HTTP
    watch and sees later writes."""
    PODS = pkg.clientset.PODS
    for i in range(5):
        c.create(PODS, _pod(pkg, f"p{i}"))
    factory = pkg.client.SharedInformerFactory(c)
    inf = factory.informer(PODS)
    factory.start()
    try:
        assert factory.wait_for_cache_sync(timeout=20)
        c.create(PODS, _pod(pkg, "late"))
        c.delete(PODS, "default", "p0")
        assert wait_for(lambda: len(inf.list()) == 5
                        and inf.get("default", "late") is not None)
        return [sorted(p["metadata"]["name"] for p in inf.list())]
    finally:
        factory.stop()


SCRIPTS = {f.__name__: f for f in (bulk_and_list, watch_stream,
                                   bind_and_bind_many, status_errors,
                                   patch_and_apply, informer_sync)}


def _run(script, client_root, server_root):
    side = Side(server_root)
    pkg = package(client_root)
    c = pkg.http_client.HTTPClient.from_url(side.server.url, token=ADMIN)
    dev = pkg.http_client.HTTPClient.from_url(side.server.url, token=DEV)
    try:
        return script(pkg, c, dev)
    finally:
        c.close()
        dev.close()
        side.stop()


@pytest.mark.parametrize("client_root,server_root", [(PORT, JAX),
                                                     (JAX, PORT)],
                         ids=["port-client-jax-server",
                              "jax-client-port-server"])
@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_wire_across_packages_equal_jax(name, client_root, server_root):
    assert DEV in TOKENS
    want = _run(SCRIPTS[name], JAX, JAX)
    got = _run(SCRIPTS[name], client_root, server_root)
    assert got == want


# -- LocalClient.apply: server-side apply in process ---------------------

def _deploy(replicas=None, image=None, labels=None):
    spec = {}
    if replicas is not None:
        spec["replicas"] = replicas
    if image is not None:
        spec["template"] = {"spec": {"containers": [{"name": "web",
                                                     "image": image}]}}
    d = {"apiVersion": "apps/v1", "kind": "Deployment",
         "metadata": {"name": "web", "namespace": "default"}, "spec": spec}
    if labels:
        d["metadata"]["labels"] = labels
    return d


APPLY_SEQUENCES = {
    "create_then_merge": [
        ("kubectl", _deploy(2, "nginx:1"), False),
        ("kubectl", _deploy(3, "nginx:1", {"team": "a"}), False)],
    "two_managers_conflict_then_force": [
        ("kubectl", _deploy(2, "nginx:1"), False),
        ("hpa", _deploy(5), False),
        ("hpa", _deploy(5), True),
        ("kubectl", _deploy(None, "nginx:2"), False)],
    "dropped_field_is_removed": [
        ("kubectl", _deploy(2, "nginx:1", {"team": "a", "tier": "fe"}),
         False),
        ("kubectl", _deploy(2, "nginx:1", {"team": "a"}), False),
        ("other", _deploy(None, None, {"owner": "x"}), False)],
}


@pytest.mark.parametrize("name", sorted(APPLY_SEQUENCES))
def test_local_client_apply_equal_jax(name):
    results = []
    for root in ROOTS:
        pkg = package(root)
        client = pkg.clientset.LocalClient(pkg.kv.MemoryStore())
        out = []
        try:
            for manager, obj, force in APPLY_SEQUENCES[name]:
                _try(out, client.apply, "deployments", obj, manager,
                     force=force)
            out.append(normalise(client.get("deployments", "default",
                                            "web")))
        finally:
            client.close()
        results.append(out)
    assert results[0] == results[1]
    assert results[0][0][0] == "ok"
