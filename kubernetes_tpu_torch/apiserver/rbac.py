"""RBAC authorization — the authorizer stage of the handler chain.

Reference semantics:
  staging/src/k8s.io/apiserver/pkg/server/config.go:815 — authorization
    runs on every request, after authn/APF, before routing;
  plugin/pkg/auth/authorizer/rbac/rbac.go — RBACAuthorizer walks
    ClusterRoleBindings (cluster-wide grants) and RoleBindings (namespace
    grants), resolving each roleRef to its rule list;
  pkg/registry/rbac/validation/rule.go — rule matching: verbs,
    apiGroups, resources ("pods/status" form for subresources, "*"
    wildcards), resourceNames;
  plugin/pkg/auth/authorizer/rbac/bootstrappolicy/ — the default
    cluster roles every control-plane component is born with.

Design: policy objects are ordinary resources in the store (roles /
rolebindings namespaced; clusterroles / clusterrolebindings
cluster-scoped).  The authorizer compiles them into a per-subject index
and watches the four resources, recompiling lazily after a change — the
hot path is two dict lookups plus rule scans for one subject, no store
reads.  Identity comes from the authn stage as (user, [groups]).

The in-process LocalClient bypasses HTTP and therefore authorization, by
construction: the enforcement seam is the apiserver handler chain, same
as the reference (a process that holds the store object IS the apiserver
process).
"""

from __future__ import annotations

import threading

from ..api import meta
from ..store import kv

ROLES = "roles"
CLUSTERROLES = "clusterroles"
ROLEBINDINGS = "rolebindings"
CLUSTERROLEBINDINGS = "clusterrolebindings"

RBAC_RESOURCES = (ROLES, CLUSTERROLES, ROLEBINDINGS, CLUSTERROLEBINDINGS)

SUPERUSER_GROUP = "system:masters"


class Attributes:
    """One authorization question (authorizer.Attributes)."""

    __slots__ = ("user", "groups", "verb", "resource", "subresource",
                 "namespace", "name")

    def __init__(self, user: str, groups: tuple[str, ...], verb: str,
                 resource: str, subresource: str = "",
                 namespace: str = "", name: str = ""):
        self.user = user
        self.groups = groups
        self.verb = verb
        self.resource = resource
        self.subresource = subresource
        self.namespace = namespace
        self.name = name


def _rule_matches(rule: dict, attrs: Attributes) -> bool:
    verbs = rule.get("verbs") or []
    if "*" not in verbs and attrs.verb not in verbs:
        return False
    resources = rule.get("resources") or []
    target = attrs.resource
    if attrs.subresource:
        target = f"{attrs.resource}/{attrs.subresource}"
    ok = False
    for r in resources:
        if r == "*" or r == target:
            ok = True
            break
        # "*/status" matches any resource's status subresource
        if attrs.subresource and r == f"*/{attrs.subresource}":
            ok = True
            break
    if not ok:
        return False
    names = rule.get("resourceNames") or []
    if names and attrs.name not in names:
        return False
    return True


class RBACAuthorizer:
    """Compiles bindings into {subject: grants} and answers authorize().

    Subjects are "User:<name>" / "Group:<name>" strings.  Grants are
    (namespace_or_None, rules) pairs: None namespace = cluster-wide.
    """

    def __init__(self, store: kv.MemoryStore):
        self._store = store
        self._lock = threading.Lock()
        self._index: dict[str, list[tuple[str | None, list[dict]]]] = {}
        self._dirty = True
        self._watches = []
        for res in RBAC_RESOURCES:
            w = store.watch(res)
            self._watches.append(w)
            t = threading.Thread(target=self._watch_loop, args=(w,),
                                 name=f"rbac-watch-{res}", daemon=True)
            t.start()

    def stop(self) -> None:
        for w in self._watches:
            w.stop()

    def _watch_loop(self, w: kv.Watch) -> None:
        while True:
            evs = w.next_batch(timeout=None)
            if not evs and w.stopped:
                return
            if evs:
                with self._lock:
                    self._dirty = True

    # -- compilation -----------------------------------------------------

    def _role_rules(self, kind: str, name: str, namespace: str) -> list[dict]:
        try:
            if kind == "ClusterRole":
                obj = self._store.get(CLUSTERROLES, "", name)
            else:
                obj = self._store.get(ROLES, namespace, name)
        except kv.NotFoundError:
            return []  # dangling roleRef grants nothing (reference behavior)
        return obj.get("rules") or []

    def _recompile(self) -> None:
        index: dict[str, list[tuple[str | None, list[dict]]]] = {}

        def add(subjects, scope_ns, rules):
            if not rules:
                return
            for s in subjects or []:
                skey = f"{s.get('kind', 'User')}:{s.get('name', '')}"
                index.setdefault(skey, []).append((scope_ns, rules))

        crbs, _ = self._store.list(CLUSTERROLEBINDINGS)
        for b in crbs:
            ref = b.get("roleRef") or {}
            rules = self._role_rules("ClusterRole", ref.get("name", ""), "")
            add(b.get("subjects"), None, rules)
        rbs, _ = self._store.list(ROLEBINDINGS)
        for b in rbs:
            ns = meta.namespace(b)
            ref = b.get("roleRef") or {}
            # a RoleBinding may reference a ClusterRole but only grants it
            # INSIDE its own namespace (rbac.go AppliesTo)
            rules = self._role_rules(ref.get("kind", "Role"),
                                     ref.get("name", ""), ns)
            add(b.get("subjects"), ns, rules)
        self._index = index

    # -- the authorizer stage --------------------------------------------

    def authorize(self, attrs: Attributes) -> bool:
        if SUPERUSER_GROUP in attrs.groups:
            return True  # the privileged-group authorizer ahead of RBAC
        with self._lock:
            if self._dirty:
                self._recompile()
                self._dirty = False
            index = self._index
        subjects = [f"User:{attrs.user}"]
        subjects += [f"Group:{g}" for g in attrs.groups]
        for skey in subjects:
            for scope_ns, rules in index.get(skey, ()):
                if scope_ns is not None and scope_ns != attrs.namespace:
                    continue
                for rule in rules:
                    if _rule_matches(rule, attrs):
                        return True
        return False


NODE_USER_PREFIX = "system:node:"
NODES_GROUP = "system:nodes"

# what a kubelet may read broadly (informers watch cluster-wide; field-
# selector-scoped watches are a non-goal here)
_NODE_READABLE = frozenset({
    "pods", "nodes", "services", "endpointslices", "configmaps",
    "persistentvolumeclaims", "persistentvolumes", "leases", "podgroups",
})


class NodeAuthorizer:
    """Scope a kubelet credential to ITS OWN node's objects.

    Reference: plugin/pkg/auth/authorizer/node/ — the node authorizer
    walks a graph from the node to the objects its pods reference, and
    the NodeRestriction admission plugin pins writes to the node's own
    identity.  Reduced here to the load-bearing rules:

      - writes to nodes/leases only for the node's OWN name
      - pod writes (status reports) only for pods BOUND to this node
      - secret gets only when a pod on this node references the secret
        (volumes or env); secret list/watch denied
      - broad reads for the informer-watched resources
      - event creation allowed (kubelets report)

    Handles ONLY system:node:* users in system:nodes; everything else
    falls through (False) to the next authorizer in the union."""

    def __init__(self, store: kv.MemoryStore):
        self._store = store

    def _pod_on_node(self, namespace: str, name: str, node: str) -> bool:
        try:
            pod = self._store.get("pods", namespace, name)
        except kv.NotFoundError:
            return False
        return (pod.get("spec") or {}).get("nodeName") == node

    def _secret_referenced(self, namespace: str, name: str,
                           node: str) -> bool:
        """graph.go lite: is `name` referenced by any pod on `node`?"""
        try:
            pods, _ = self._store.list("pods", namespace)
        except kv.StoreError:
            return False
        for pod in pods:
            spec = pod.get("spec") or {}
            if spec.get("nodeName") != node:
                continue
            for ref in spec.get("imagePullSecrets") or ():
                if ref.get("name") == name:
                    return True
            for vol in spec.get("volumes") or ():
                if ((vol.get("secret") or {}).get("secretName")) == name:
                    return True
                for src in ((vol.get("projected") or {})
                            .get("sources")) or ():
                    if ((src.get("secret") or {}).get("name")) == name:
                        return True
            containers = list(spec.get("containers") or ())
            containers += list(spec.get("initContainers") or ())
            for c in containers:
                for env in c.get("env") or ():
                    ref = ((env.get("valueFrom") or {})
                           .get("secretKeyRef") or {})
                    if ref.get("name") == name:
                        return True
                for src in c.get("envFrom") or ():
                    if ((src.get("secretRef") or {}).get("name")) == name:
                        return True
        return False

    def authorize(self, attrs: Attributes) -> bool:
        if not attrs.user.startswith(NODE_USER_PREFIX) \
                or NODES_GROUP not in attrs.groups:
            return False
        node = attrs.user[len(NODE_USER_PREFIX):]
        verb, res = attrs.verb, attrs.resource
        if verb in ("get", "list", "watch"):
            if res in _NODE_READABLE:
                return True
            if res == "secrets" and verb == "get":
                return self._secret_referenced(attrs.namespace,
                                               attrs.name, node)
            return False
        if res == "events":
            return verb == "create"
        if res == "nodes":
            # update/patch/delete pinned to own name; create has no
            # name at authz time (NodeRestriction admission would pin
            # it) — allow, registration is the join flow
            return verb == "create" or attrs.name == node
        if res == "leases":
            # node heartbeat leases live ONLY in kube-node-lease
            # (upstream pins the namespace the same way) — a kubelet
            # cert must not forge identity leases elsewhere
            if attrs.namespace != "kube-node-lease":
                return False
            return verb == "create" or attrs.name == node
        if res == "pods":
            if verb in ("update", "patch"):
                return self._pod_on_node(attrs.namespace, attrs.name,
                                         node)
            return False
        if res == "certificatesigningrequests":
            return verb == "create"
        return False


class CompositeAuthorizer:
    """Union of authorization modes (--authorization-mode=Node,RBAC):
    any module granting wins; all abstaining/denying denies."""

    def __init__(self, authorizers: list):
        self.authorizers = authorizers

    def authorize(self, attrs: Attributes) -> bool:
        return any(a.authorize(attrs) for a in self.authorizers)

    def stop(self) -> None:
        for a in self.authorizers:
            stop = getattr(a, "stop", None)
            if stop is not None:
                stop()


# -- bootstrap policy ----------------------------------------------------

def _role(name: str, rules: list[dict]) -> dict:
    obj = meta.new_object("ClusterRole", name, None)
    obj["rules"] = rules
    return obj


def _binding(name: str, role: str, subjects: list[dict]) -> dict:
    obj = meta.new_object("ClusterRoleBinding", name, None)
    obj["roleRef"] = {"kind": "ClusterRole", "name": role}
    obj["subjects"] = subjects
    return obj


def _user(name: str) -> dict:
    return {"kind": "User", "name": name}


def _group(name: str) -> dict:
    return {"kind": "Group", "name": name}


READ = ["get", "list", "watch"]
WRITE = ["create", "update", "patch", "delete"]


def bootstrap_policy(store: kv.MemoryStore) -> None:
    """Default roles + bindings for the control-plane components
    (bootstrappolicy/policy.go ClusterRoles()/ClusterRoleBindings(),
    reduced to the verbs this control plane actually issues).
    Idempotent — crash-only restart safe."""
    roles = [
        _role("cluster-admin",
              [{"verbs": ["*"], "apiGroups": ["*"], "resources": ["*"]}]),
        _role("system:kube-scheduler", [
            {"verbs": READ, "resources": [
                "pods", "nodes", "namespaces", "services", "replicasets",
                "statefulsets", "replicationcontrollers",
                "poddisruptionbudgets", "persistentvolumeclaims",
                "persistentvolumes", "storageclasses", "csinodes",
                "podgroups", "priorityclasses"]},
            {"verbs": ["create"], "resources": ["pods/binding", "bindings"]},
            {"verbs": ["update", "patch"], "resources": ["pods/status"]},
            {"verbs": ["delete"], "resources": ["pods"]},  # preemption
            {"verbs": ["create", "patch", "update"], "resources": ["events"]},
            {"verbs": ["get", "create", "update"], "resources": ["leases"]},
        ]),
        _role("system:kube-controller-manager", [
            {"verbs": READ, "resources": ["*"]},
            {"verbs": WRITE, "resources": [
                "pods", "replicasets", "services", "endpoints",
                "endpointslices", "serviceaccounts", "secrets", "configmaps",
                "leases", "events", "namespaces", "podgroups",
                "persistentvolumes", "persistentvolumeclaims",
                "volumeattachments", "certificatesigningrequests",
                "poddisruptionbudgets", "horizontalpodautoscalers"]},
            {"verbs": ["update", "patch"], "resources": [
                "*/status", "*/scale", "nodes", "deployments", "jobs",
                "cronjobs", "statefulsets", "daemonsets",
                "replicationcontrollers", "certificatesigningrequests/status",
                "certificatesigningrequests/approval"]},
            {"verbs": ["delete"], "resources": ["nodes"]},  # node lifecycle
        ]),
        _role("system:node", [
            {"verbs": READ, "resources": [
                "pods", "nodes", "services", "configmaps", "secrets",
                "persistentvolumeclaims", "persistentvolumes"]},
            {"verbs": ["create", "update", "patch"], "resources": [
                "nodes", "nodes/status", "pods/status", "events", "leases"]},
            {"verbs": ["create"], "resources": [
                "certificatesigningrequests"]},
            {"verbs": ["delete"], "resources": ["pods"]},  # eviction/own-pod
        ]),
        _role("system:kube-proxy", [
            {"verbs": READ, "resources": [
                "services", "endpoints", "endpointslices", "nodes"]},
            {"verbs": ["create", "patch", "update"], "resources": ["events"]},
        ]),
        _role("system:basic-user", [
            # any authenticated user may ask "can I?" (SelfSubjectAccessReview)
            {"verbs": ["create"],
             "resources": ["selfsubjectaccessreviews"]},
        ]),
        _role("system:node-bootstrapper", [
            # a joining node's bootstrap-token identity may submit CSRs,
            # watch for the issued certificate, and replace a stale CSR
            # left by an earlier failed join
            {"verbs": ["create", "get", "list", "watch", "delete"],
             "resources": ["certificatesigningrequests"]},
        ]),
        # user-facing roles (aggregationRule reduced to static rules)
        _role("admin", [
            {"verbs": ["*"], "resources": ["*"]}]),
        _role("edit", [
            {"verbs": READ + WRITE, "resources": [
                "pods", "deployments", "replicasets", "statefulsets",
                "daemonsets", "jobs", "cronjobs", "services", "endpoints",
                "configmaps", "secrets", "persistentvolumeclaims",
                "horizontalpodautoscalers", "poddisruptionbudgets"]}]),
        _role("view", [
            {"verbs": READ, "resources": [
                "pods", "deployments", "replicasets", "statefulsets",
                "daemonsets", "jobs", "cronjobs", "services", "endpoints",
                "configmaps", "persistentvolumeclaims",
                "horizontalpodautoscalers", "poddisruptionbudgets"]}]),
    ]
    bindings = [
        _binding("cluster-admin", "cluster-admin",
                 [_group(SUPERUSER_GROUP)]),
        _binding("system:kube-scheduler", "system:kube-scheduler",
                 [_user("system:kube-scheduler")]),
        _binding("system:kube-controller-manager",
                 "system:kube-controller-manager",
                 [_user("system:kube-controller-manager")]),
        _binding("system:node", "system:node",
                 # cert-authenticated kubelets (system:nodes via the
                 # cert's O field) are scoped by the NodeAuthorizer,
                 # not this broad role; plain-HTTP clusters have no
                 # cert authn, so the bootstrap-token identity keeps
                 # node rights here
                 [_group("system:bootstrappers")]),
        _binding("system:node-bootstrapper", "system:node-bootstrapper",
                 [_group("system:bootstrappers")]),
        _binding("system:basic-user", "system:basic-user",
                 [_group("system:authenticated")]),
        _binding("system:kube-proxy", "system:kube-proxy",
                 [_user("system:kube-proxy")]),
    ]
    for obj in roles:
        try:
            store.create(CLUSTERROLES, obj)
        except kv.AlreadyExistsError:
            pass
    for obj in bindings:
        try:
            store.create(CLUSTERROLEBINDINGS, obj)
        except kv.AlreadyExistsError:
            pass
    # kube-public/cluster-info is readable ANONYMOUSLY — the kubeadm join
    # trust bootstrap depends on it (bootstrappolicy: the
    # kubeadm:bootstrap-signer-clusterinfo Role + binding in kube-public)
    info_role = meta.new_object("Role", "kubeadm:bootstrap-signer-clusterinfo",
                                "kube-public")
    info_role["rules"] = [{"verbs": ["get"], "resources": ["configmaps"],
                           "resourceNames": ["cluster-info"]}]
    info_rb = meta.new_object("RoleBinding",
                              "kubeadm:bootstrap-signer-clusterinfo",
                              "kube-public")
    info_rb["roleRef"] = {"kind": "Role",
                          "name": "kubeadm:bootstrap-signer-clusterinfo"}
    info_rb["subjects"] = [_user("system:anonymous"),
                           _group("system:unauthenticated")]
    for res, obj in ((ROLES, info_role), (ROLEBINDINGS, info_rb)):
        try:
            store.create(res, obj)
        except kv.AlreadyExistsError:
            pass
