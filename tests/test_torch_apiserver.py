"""The port's apiserver (kubernetes_tpu_torch/apiserver) held against the
JAX package's: each package's APIServer runs in process on port 0 over a
fresh MemoryStore of its own, with the scheduler_perf harness's flags
(tests/torch_front_door.py), and the same scripted requests (method, path,
body, bearer user) go to both.  Status codes and JSON bodies must be
equal, resourceVersions included; only uid, creationTimestamp, a managed
field's time, an audit event's timestamp and /version's platform are
exempt.  Each script also asserts the status codes it expects, so a case
shows the behaviour it is named for on both sides.  The scenarios follow
the JAX package's own tests of each module (test_apiserver*.py,
test_rbac.py, test_admission_breadth.py, test_ssa.py, test_crd_depth.py,
test_flowcontrol_fairness.py, test_discovery.py, test_core_versions.py,
test_aggregator_kms.py).
"""

import importlib.util
import json

import pytest

from torch_front_door import (
    ADMIN, DEV, ROOTS, SCHED, normalise, package, start_pair, wait_for,
    watch_events,
)

P = "/api/v1/namespaces/default/pods"
N = "/api/v1/nodes"
DEPLOY = "/apis/apps/v1/namespaces/default/deployments"
APPLY = "application/apply-patch+yaml"


def pod(name, ns="default", labels=None, node=None, **spec):
    md = {"name": name, "namespace": ns}
    if labels:
        md["labels"] = labels
    sp = {"containers": [{"name": "c", "image": "img"}], **spec}
    if node:
        sp["nodeName"] = node
    return {"apiVersion": "v1", "kind": "Pod", "metadata": md, "spec": sp}


def node(name, labels=None):
    return {"apiVersion": "v1", "kind": "Node",
            "metadata": {"name": name, "labels": labels or {}},
            "status": {"allocatable": {"cpu": "4", "memory": "8Gi",
                                       "pods": "110"}}}


def deployment(replicas=2, image="nginx:1", labels=None):
    d = {"apiVersion": "apps/v1", "kind": "Deployment",
         "metadata": {"name": "web", "namespace": "default"},
         "spec": {"replicas": replicas,
                  "selector": {"matchLabels": {"app": "web"}},
                  "template": {"metadata": {"labels": {"app": "web"}},
                               "spec": {"containers": [
                                   {"name": "web", "image": image}]}}}}
    if labels:
        d["metadata"]["labels"] = labels
    return d


class Transcript:
    """What one side answered, step by step, normalised."""

    def __init__(self, side):
        self.side = side
        self.lines = []

    def __call__(self, method, path, body=None, want=None, token=ADMIN,
                 ctype=None):
        status, data = self.side.call(method, path, body, token, ctype)
        self.lines.append((method, path, status, normalise(data)))
        assert want is None or status == want, (
            self.side.pkg.root, method, path, status, data)
        return data


# -- the scripts (each runs once against each side) ------------------------

def crud(t):
    t("POST", P, pod("p1"), 201)
    got = t("GET", P + "/p1", want=200)
    got["metadata"]["labels"] = {"v": "2"}
    t("PUT", P + "/p1", got, 200)
    t("GET", P, want=200)
    t("DELETE", P + "/p1", want=200)
    t("GET", P + "/p1", want=404)
    t("DELETE", P + "/p1", want=404)


def conflicts(t):
    created = t("POST", P, pod("p"), 201)
    t("POST", P, pod("p"), 409)                       # already exists
    fresh = json.loads(json.dumps(created))
    fresh["metadata"]["labels"] = {"v": "2"}
    t("PUT", P + "/p", fresh, 200)
    created["metadata"]["labels"] = {"v": "stale"}
    t("PUT", P + "/p", created, 409)                  # stale resourceVersion


def cluster_scoped_nodes(t):
    t("POST", N, node("n1", {"zone": "a"}), 201)
    t("POST", N, node("n2", {"zone": "b"}), 201)
    t("GET", N + "/n1", want=200)
    t("GET", N, want=200)
    t("DELETE", N + "/n2", want=200)
    t("GET", N, want=200)


def label_selectors(t):
    for i, (app, tier) in enumerate([("web", "fe"), ("web", "be"),
                                     ("db", "be")]):
        t("POST", P, pod(f"p{i}", labels={"app": app, "tier": tier}), 201)
    t("GET", P + "?labelSelector=app%3Dweb", want=200)
    t("GET", P + "?labelSelector=app%3Dweb%2Ctier%21%3Dfe", want=200)
    t("GET", P + "?labelSelector=tier+in+%28be%29", want=200)
    t("GET", "/api/v1/pods?labelSelector=app", want=200)


def field_selectors(t):
    t("POST", P, pod("a", node="n1"), 201)
    t("POST", P, pod("b", node="n2"), 201)
    t("POST", P, pod("c"), 201)
    t("GET", P + "?fieldSelector=spec.nodeName%3Dn1", want=200)
    t("GET", P + "?fieldSelector=spec.nodeName%3D", want=200)
    t("GET", P + "?fieldSelector=metadata.name%21%3Da", want=200)
    t("GET", P + "?fieldSelector=spec.bogus%3Dx", want=200)   # no match
    t("GET", P + "?fieldSelector=nooperator", want=400)


def rbac_allow_deny(t):
    t("POST", N, node("n1"), 201)
    t("GET", P, token=SCHED, want=200)                # scheduler lists pods
    t("GET", N, token=SCHED, want=200)
    t("POST", P, pod("p"), 201)
    t("POST", P + "/p/binding",
      {"apiVersion": "v1", "kind": "Binding", "metadata": {"name": "p"},
       "target": {"kind": "Node", "name": "n1"}}, 201, token=SCHED)
    t("DELETE", N + "/n1", token=SCHED, want=403)     # not its verb
    t("GET", P, token=DEV, want=403)                  # no binding names dev
    t("GET", P, token="no-such-token", want=401)
    t("GET", "/healthz", token=None, want=200)        # non-resource: open


def rbac_rolebinding(t):
    """A Role and a RoleBinding (written to the store, as test_rbac.py
    does) grant the devs group read access to one namespace only."""
    t("POST", "/api/v1/namespaces",
      {"apiVersion": "v1", "kind": "Namespace",
       "metadata": {"name": "team"}}, 201)
    t("GET", "/api/v1/namespaces/team/pods", token=DEV, want=403)
    meta, rbac, store = t.side.pkg.meta, t.side.pkg.rbac, t.side.store
    role = meta.new_object("Role", "reader", "team")
    role["rules"] = [{"verbs": ["get", "list"], "resources": ["pods"]}]
    store.create(rbac.ROLES, role)
    rb = meta.new_object("RoleBinding", "devs-read", "team")
    rb["roleRef"] = {"kind": "Role", "name": "reader"}
    rb["subjects"] = [{"kind": "Group", "name": "devs"}]
    store.create(rbac.ROLEBINDINGS, rb)
    t("POST", "/api/v1/namespaces/team/pods", pod("x", ns="team"), 201)
    t("GET", "/api/v1/namespaces/team/pods", token=DEV, want=200)
    t("GET", "/api/v1/namespaces/team/pods/x", token=DEV, want=200)
    t("GET", P, token=DEV, want=403)                  # only its namespace
    t("POST", "/api/v1/namespaces/team/pods", pod("y", ns="team"),
      token=DEV, want=403)                            # only its verbs


def admission_defaults(t):
    t("POST", "/api/v1/namespaces/default/limitranges",
      {"apiVersion": "v1", "kind": "LimitRange",
       "metadata": {"name": "lr", "namespace": "default"},
       "spec": {"limits": [{"type": "Container",
                            "defaultRequest": {"cpu": "250m",
                                               "memory": "64Mi"},
                            "default": {"cpu": "500m"}}]}}, 201)
    # LimitRanger fills requests/limits, DefaultTolerationSeconds adds
    # the not-ready/unreachable tolerations
    t("POST", P, pod("d"), 201)
    t("GET", P + "/d", want=200)


def admission_rejections(t):
    t("POST", "/api/v1/namespaces/nowhere/pods", pod("x", ns="nowhere"),
      want=403)                                       # NamespaceLifecycle
    t("POST", "/api/v1/namespaces",
      {"apiVersion": "v1", "kind": "Namespace",
       "metadata": {"name": "locked", "labels": {
           "pod-security.kubernetes.io/enforce": "baseline"}}}, 201)
    t("POST", "/api/v1/namespaces/locked/pods",
      pod("priv", ns="locked", hostNetwork=True), want=403)   # PodSecurity
    t("POST", "/api/v1/namespaces/locked/pods", pod("ok", ns="locked"),
      want=201)
    t("POST", "/api/v1/namespaces/default/resourcequotas",
      {"apiVersion": "v1", "kind": "ResourceQuota",
       "metadata": {"name": "q", "namespace": "default"},
       "spec": {"hard": {"pods": "1"}}}, 201)
    t("POST", P, pod("first"), 201)
    t("POST", P, pod("second"), 403)                  # ResourceQuota
    t("DELETE", "/api/v1/namespaces/default", want=403)   # immortal


def patches(t):
    t("POST", P, pod("p", labels={"a": "1"}), 201)
    t("PATCH", P + "/p", {"metadata": {"labels": {"b": "2", "a": None}}},
      200, ctype="application/merge-patch+json")
    t("PATCH", P + "/p",
      [{"op": "add", "path": "/metadata/labels/c", "value": "3"},
       {"op": "replace", "path": "/spec/containers/0/image",
        "value": "img:2"}], 200, ctype="application/json-patch+json")
    t("PATCH", P + "/p",
      [{"op": "test", "path": "/metadata/labels/c", "value": "nope"}],
      ctype="application/json-patch+json")            # a failed test op
    t("PATCH", P + "/p",
      {"spec": {"containers": [{"name": "side", "image": "s"}]}}, 200,
      ctype="application/strategic-merge-patch+json")   # merges by name
    t("PATCH", P + "/p",
      {"spec": {"containers": [{"name": "side", "$patch": "delete"}]}},
      200, ctype="application/strategic-merge-patch+json")
    t("GET", P + "/p", want=200)


def server_side_apply(t):
    t("PATCH", DEPLOY + "/web?fieldManager=kubectl",
      deployment(replicas=2), 201, ctype=APPLY)      # create on apply
    t("PATCH", DEPLOY + "/web?fieldManager=kubectl",
      deployment(replicas=2), 200, ctype=APPLY)      # same value: no-op
    t("PATCH", DEPLOY + "/web?fieldManager=hpa",
      {"apiVersion": "apps/v1", "kind": "Deployment",
       "metadata": {"name": "web", "namespace": "default"},
       "spec": {"replicas": 9}}, 409, ctype=APPLY)   # owned by kubectl
    t("PATCH", DEPLOY + "/web?fieldManager=hpa&force=true",
      {"apiVersion": "apps/v1", "kind": "Deployment",
       "metadata": {"name": "web", "namespace": "default"},
       "spec": {"replicas": 9}}, 200, ctype=APPLY)   # force takes it
    t("PATCH", DEPLOY + "/web?fieldManager=kubectl",
      deployment(replicas=9, image="nginx:2", labels={"team": "a"}), 200,
      ctype=APPLY)
    t("GET", DEPLOY + "/web", want=200)


THING_SCHEMA = {
    "type": "object",
    "properties": {"spec": {
        "type": "object",
        "properties": {"replicas": {"type": "integer", "default": 1},
                       "limit": {"type": "integer"}},
        "x-kubernetes-validations": [
            {"rule": "self.replicas <= 10",
             "message": "replicas must be at most 10"},
            {"rule": "!has(self.limit) || self.replicas <= self.limit"}]}}}


def crd_cel(t):
    t("POST", "/apis/apiextensions.k8s.io/v1/customresourcedefinitions",
      {"apiVersion": "apiextensions.k8s.io/v1",
       "kind": "CustomResourceDefinition",
       "metadata": {"name": "things.d.io"},
       "spec": {"group": "d.io", "scope": "Namespaced",
                "names": {"plural": "things", "kind": "Thing"},
                "versions": [{"name": "v1", "served": True,
                              "storage": True,
                              "schema": {"openAPIV3Schema": THING_SCHEMA}}]}},
      201)
    things = "/apis/d.io/v1/namespaces/default/things"

    def thing(name, **spec):
        return {"apiVersion": "d.io/v1", "kind": "Thing",
                "metadata": {"name": name, "namespace": "default"},
                "spec": spec}
    t("POST", things, thing("ok", junk="pruned", limit=5), 201)
    t("POST", things, thing("big", replicas=11), 422)   # CEL rejects
    t("POST", things, thing("cross", replicas=5, limit=3), 422)
    t("GET", things, want=200)


def discovery(t):
    t("GET", "/api", want=200)
    t("GET", "/api/v1", want=200)
    t("GET", "/apis", want=200)
    t("GET", "/apis/apps", want=200)
    t("GET", "/apis/apps/v1", want=200)
    t("GET", "/apis/no.such.group", want=404)
    t("GET", "/apis/apps/v9", want=404)


def openapi(t):
    t("GET", "/openapi/v2", want=200)
    t("GET", "/openapi/v3", want=200)
    t("GET", "/openapi/v3/api/v1", want=200)
    t("GET", "/openapi/v3/apis/apps/v1", want=200)


def core_versions(t):
    v2 = "/api/v2alpha1/namespaces/default/pods"
    t("POST", v2, {"apiVersion": "v2alpha1", "kind": "Pod",
                   "metadata": {"name": "cv2", "namespace": "default"},
                   "spec": {"containers": [{"name": "c"}],
                            "scheduling": {"priority": 9}}}, 201)
    t("GET", P + "/cv2", want=200)                   # read back at v1
    t("POST", P, pod("cv1", priority=7, schedulerName="default-scheduler"),
      201)
    t("GET", v2 + "/cv1", want=200)                  # read at v2
    t("GET", v2, want=200)                           # list converts
    t("GET", "/api/v2alpha1", want=200)


def health_and_version(t):
    for path in ("/healthz", "/readyz", "/livez", "/version"):
        t("GET", path, want=200)


def bulk_and_binding(t):
    t("POST", N, node("n1"), 201)
    t("POST", P, {"kind": "List", "apiVersion": "v1",
                  "items": [pod(f"b{i}") for i in range(5)]}, 201)
    t("POST", P, {"kind": "List", "apiVersion": "v1",
                  "items": [pod("b0"), pod("b9")]}, 201)   # one exists
    t("POST", P + "/b1/binding",
      {"apiVersion": "v1", "kind": "Binding", "metadata": {"name": "b1"},
       "target": {"kind": "Node", "name": "n1"}}, 201)
    t("POST", P + "/b1/binding",
      {"apiVersion": "v1", "kind": "Binding", "metadata": {"name": "b1"},
       "target": {"kind": "Node", "name": "n1"}}, 409)    # already bound
    t("GET", P, want=200)


SCRIPTS = {f.__name__: f for f in (
    crud, conflicts, cluster_scoped_nodes, label_selectors, field_selectors,
    rbac_allow_deny, rbac_rolebinding, admission_defaults,
    admission_rejections, patches, server_side_apply, crd_cel, discovery,
    openapi, core_versions, health_and_version, bulk_and_binding)}


def _platform_exempt(lines):
    """/version's platform is the one field the port reports differently
    ("gpu", the device its scheduler runs on)."""
    out = []
    for method, path, status, body in lines:
        if path == "/version":
            assert body.pop("platform") in ("tpu", "gpu")
        out.append((method, path, status, body))
    return out


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_answers_equal_jax(name):
    sides = start_pair()
    try:
        lines = []
        for side in sides:
            t = Transcript(side)
            SCRIPTS[name](t)
            lines.append(_platform_exempt(t.lines))
    finally:
        for side in sides:
            side.stop()
    assert lines[0] == lines[1]


def test_version_reports_gpu():
    sides = start_pair()
    try:
        (_, jv), (_, pv) = (s.call("GET", "/version") for s in sides)
    finally:
        for side in sides:
            side.stop()
    assert (jv["platform"], pv["platform"]) == ("tpu", "gpu")
    assert jv["gitVersion"] == pv["gitVersion"]


# -- watch from a resourceVersion ------------------------------------------

def _writes(t):
    t("POST", P, pod("w1"), 201)
    t("POST", P, pod("w2"), 201)
    t("PATCH", P + "/w1", {"metadata": {"labels": {"v": "2"}}}, 200,
      ctype="application/merge-patch+json")
    t("DELETE", P + "/w2", want=200)
    t("POST", "/api/v1/namespaces/other/pods", pod("x", ns="other"))


@pytest.mark.parametrize("path", [
    P + "?watch=true&resourceVersion={rv}",
    "/api/v1/pods?watch=true&resourceVersion={rv}",
    P + "?watch=true&resourceVersion={rv}&fieldSelector=metadata.name%3Dw1",
])
def test_watch_from_resource_version_equal_jax(path):
    sides = start_pair()
    try:
        seqs = []
        for side in sides:
            _, lst = side.call("GET", P)
            rv = lst["metadata"]["resourceVersion"]
            t = Transcript(side)
            _writes(t)
            want = 2 if "fieldSelector" in path else 4
            evs = watch_events(side.port, path.format(rv=rv), want)
            seqs.append([(e["type"], normalise(e["object"])) for e in evs])
            assert len(evs) == want, (side.pkg.root, evs)
    finally:
        for side in sides:
            side.stop()
    assert [ty for ty, _ in seqs[0]] == [ty for ty, _ in seqs[1]]
    assert seqs[0] == seqs[1]


# -- flow control: a one-seat level that rejects ---------------------------

def _shed_level(side):
    """test_flowcontrol_fairness.py's Reject level, from stored objects:
    every request classifies to a one-seat level that queues nothing."""
    meta, fc, store = side.pkg.meta, side.pkg.flowcontrol, side.store
    plc = meta.new_object("PriorityLevelConfiguration", "shed", None)
    plc["spec"] = {"type": "Limited", "limited": {
        "nominalConcurrencyShares": 1, "limitResponse": {"type": "Reject"}}}
    store.create(fc.PRIORITYLEVELS, plc)
    fs = meta.new_object("FlowSchema", "shed-all", None)
    fs["spec"] = {"priorityLevelConfiguration": {"name": "shed"},
                  "matchingPrecedence": 1, "rules": []}
    store.create(fc.FLOWSCHEMAS, fs)
    flow = side.server.flow
    assert wait_for(lambda: flow.classify("system:admin", "get", "pods")
                    .name == "shed")
    return flow.levels["shed"]


def _with_flow(pkg):
    return {"flow_dispatcher": pkg.flowcontrol.Dispatcher(queue_timeout=2.0)}


def test_flowcontrol_429_under_one_seat_equal_jax():
    sides = start_pair(extra=_with_flow)
    try:
        lines = []
        for side in sides:
            t = Transcript(side)
            t("POST", P, pod("a"), 201)
            level = _shed_level(side)
            assert level.acquire("holder", timeout=1.0)
            try:
                t("POST", P, pod("b"), 429)           # the seat is held
                t("GET", P + "/a", want=429)
            finally:
                level.release()
            t("POST", P, pod("b"), 201)
            assert level.rejected == 2
            lines.append(t.lines)
    finally:
        for side in sides:
            side.stop()
    assert lines[0] == lines[1]


# -- audit lines -------------------------------------------------------------

def _audited(pkg):
    return {"audit_logger": pkg.audit.AuditLogger(pkg.audit.Policy(
        [pkg.audit.PolicyRule("RequestResponse", resources=["pods"]),
         pkg.audit.PolicyRule("Metadata")]))}


def test_audit_lines_equal_jax():
    sides = start_pair(extra=_audited)
    try:
        events = []
        for side in sides:
            t = Transcript(side)
            t("POST", P, pod("a"), 201)
            t("GET", P + "/a", want=200)
            t("GET", P, token=DEV, want=403)
            t("POST", N, node("n1"), 201)
            t("DELETE", P + "/a", want=200)
            evs = side.server.audit.snapshot()
            for e in evs:
                assert e.pop("requestReceivedTimestamp") > 0
            events.append(normalise(evs))
    finally:
        for side in sides:
            side.stop()
    assert events[0] and events[0] == events[1]


# -- encryption at rest across packages ------------------------------------

requires_crypto = pytest.mark.skipif(
    importlib.util.find_spec("cryptography") is None,
    reason="AES-GCM sealing needs the cryptography package")


@requires_crypto
@pytest.mark.parametrize("writer", ROOTS)
def test_secret_sealed_by_one_package_opens_in_the_other(writer, tmp_path):
    """A Secret written through one package's EnvelopeTransformer (its
    store holds only the envelope) is read back in clear through the
    other's, from the same KEK ring on disk."""
    reader = ROOTS[1 - ROOTS.index(writer)]
    w, r = package(writer), package(reader)
    key_file = str(tmp_path / "kms-keys.json")
    wt = w.encryption.EnvelopeTransformer(w.encryption.LocalKMS(key_file))
    secret = {"apiVersion": "v1", "kind": "Secret",
              "metadata": {"name": "s", "namespace": "default"},
              "data": {"token": "c2VjcmV0"}}
    sealed = wt.encrypt_obj(json.loads(json.dumps(secret)))
    assert wt.is_encrypted(sealed) and "c2VjcmV0" not in json.dumps(sealed)
    rt = r.encryption.EnvelopeTransformer(r.encryption.LocalKMS(key_file))
    assert rt.is_encrypted(sealed)
    assert rt.decrypt_obj(sealed) == wt.decrypt_obj(sealed) == secret


@requires_crypto
def test_encrypted_store_behind_each_apiserver_equal_jax(tmp_path):
    """--encrypt-secrets' shape: each package's apiserver over a store with
    the secrets transformer.  The API serves the clear object the same
    way on both; each store holds only the envelope, which the other
    package's transformer on the same KEK ring opens."""
    key_file = str(tmp_path / "kms-keys.json")
    transformer = {}

    def encrypted(pkg):
        return {"transformers": {"secrets": transformer[pkg.root]}}
    for root in ROOTS:
        enc = package(root).encryption
        transformer[root] = enc.EnvelopeTransformer(enc.LocalKMS(key_file))
    sides = start_pair(store_extra=encrypted)
    try:
        lines, sealed = [], []
        for side in sides:
            t = Transcript(side)
            t("POST", "/api/v1/namespaces/default/secrets",
              {"apiVersion": "v1", "kind": "Secret",
               "metadata": {"name": "s", "namespace": "default"},
               "data": {"k": "dg=="}}, 201)
            t("GET", "/api/v1/namespaces/default/secrets/s", want=200)
            lines.append(t.lines)
            sealed.append(side.store._data["secrets"]["default/s"])
    finally:
        for side in sides:
            side.stop()
    assert lines[0] == lines[1]
    for i, root in enumerate(ROOTS):
        assert "dg==" not in json.dumps(sealed[i])
        other = transformer[ROOTS[1 - i]]
        assert other.is_encrypted(sealed[i])
        assert other.decrypt_obj(sealed[i])["data"] == {"k": "dg=="}
