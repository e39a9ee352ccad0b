"""Group/version/resource discovery + a minimal OpenAPI v2 document.

Reference: staging/src/k8s.io/apiserver/pkg/endpoints/discovery/ —
  GET /api                  APIVersions
  GET /api/v1               APIResourceList (core resources+subresources)
  GET /apis                 APIGroupList (group -> versions/preferred)
  GET /apis/{g}             APIGroup
  GET /apis/{g}/{v}         APIResourceList
  GET /openapi/v2           swagger skeleton (kube-openapi aggregation)

This is what lets a foreign client (kubectl, the aggregator, client
generators) resolve resources from the SERVER instead of a baked-in
table; cli/kubectl.py falls back to these endpoints for resources its
static map doesn't know (CRD-defined kinds included).
"""

from __future__ import annotations

from .. import __version__

# core (legacy "/api/v1") resources: plural -> (Kind, shortNames)
CORE_KINDS: dict[str, tuple[str, tuple[str, ...]]] = {
    "pods": ("Pod", ("po",)),
    "nodes": ("Node", ("no",)),
    "services": ("Service", ("svc",)),
    "endpoints": ("Endpoints", ("ep",)),
    "events": ("Event", ("ev",)),
    "namespaces": ("Namespace", ("ns",)),
    "configmaps": ("ConfigMap", ("cm",)),
    "secrets": ("Secret", ()),
    "serviceaccounts": ("ServiceAccount", ("sa",)),
    "persistentvolumeclaims": ("PersistentVolumeClaim", ("pvc",)),
    "persistentvolumes": ("PersistentVolume", ("pv",)),
    "replicationcontrollers": ("ReplicationController", ("rc",)),
    "podgroups": ("PodGroup", ("pg",)),
    "resourcequotas": ("ResourceQuota", ("quota",)),
    "limitranges": ("LimitRange", ("limits",)),
}

# grouped resources: plural -> Kind, shortNames (group comes from the
# server's BUILTIN_GROUPS routing table so the two can't diverge)
GROUP_KINDS: dict[str, tuple[str, tuple[str, ...]]] = {
    "deployments": ("Deployment", ("deploy",)),
    "replicasets": ("ReplicaSet", ("rs",)),
    "statefulsets": ("StatefulSet", ("sts",)),
    "daemonsets": ("DaemonSet", ("ds",)),
    "jobs": ("Job", ()),
    "cronjobs": ("CronJob", ("cj",)),
    "poddisruptionbudgets": ("PodDisruptionBudget", ("pdb",)),
    "priorityclasses": ("PriorityClass", ("pc",)),
    "storageclasses": ("StorageClass", ("sc",)),
    "csinodes": ("CSINode", ()),
    "volumeattachments": ("VolumeAttachment", ()),
    "leases": ("Lease", ()),
    "customresourcedefinitions": ("CustomResourceDefinition",
                                  ("crd", "crds")),
    "horizontalpodautoscalers": ("HorizontalPodAutoscaler", ("hpa",)),
    "certificatesigningrequests": ("CertificateSigningRequest", ("csr",)),
    "endpointslices": ("EndpointSlice", ()),
    "apiservices": ("APIService", ()),
    "flowschemas": ("FlowSchema", ()),
    "prioritylevelconfigurations": ("PriorityLevelConfiguration", ()),
}

# non-v1 preferred versions (everything else serves v1)
GROUP_PREFERRED_VERSION = {"autoscaling": "v2"}

STANDARD_VERBS = ["create", "delete", "deletecollection", "get", "list",
                  "patch", "update", "watch"]

# subresources surfaced in discovery: (parent plural, subresource, kind,
# verbs) — mirrors the server's SUBRESOURCES/NODE_STREAM routing
_SUBRESOURCES = [
    ("pods", "status", "Pod", ["get", "patch", "update"]),
    ("pods", "binding", "Binding", ["create"]),
    ("pods", "eviction", "Eviction", ["create"]),
    ("pods", "log", "Pod", ["get"]),
    ("pods", "exec", "PodExecOptions", ["create", "get"]),
    ("pods", "attach", "PodAttachOptions", ["create", "get"]),
    ("pods", "portforward", "PodPortForwardOptions", ["create", "get"]),
    ("serviceaccounts", "token", "TokenRequest", ["create"]),
]


def _resource_entry(plural: str, kind: str, namespaced: bool,
                    short_names: tuple[str, ...] = ()) -> dict:
    entry = {"name": plural, "singularName": kind.lower(), "kind": kind,
             "namespaced": namespaced, "verbs": STANDARD_VERBS}
    if short_names:
        entry["shortNames"] = list(short_names)
    return entry


def api_versions() -> dict:
    from ..api import core_versions as corever
    return {"kind": "APIVersions",
            "versions": list(corever.SERVED_VERSIONS)}


def core_versioned_resource_list(version: str,
                                 cluster_scoped: frozenset[str]) -> dict:
    """Resource list for a NON-hub core version: only the resources the
    conversion seam serves there (api/core_versions)."""
    from ..api import core_versions as corever
    resources = []
    served = set()
    for plural, (kind, shorts) in sorted(CORE_KINDS.items()):
        if corever.handles(plural, version):
            served.add(plural)
            resources.append(_resource_entry(
                plural, kind, plural not in cluster_scoped, shorts))
    for parent, sub, kind, verbs in _SUBRESOURCES:
        if parent in served:
            resources.append({"name": f"{parent}/{sub}", "kind": kind,
                              "namespaced": True, "verbs": verbs})
    return {"kind": "APIResourceList", "groupVersion": version,
            "resources": resources}


def core_resource_list(cluster_scoped: frozenset[str],
                       scalable: set[str]) -> dict:
    resources = []
    for plural, (kind, shorts) in sorted(CORE_KINDS.items()):
        resources.append(_resource_entry(
            plural, kind, plural not in cluster_scoped, shorts))
        if plural in scalable:
            resources.append({"name": f"{plural}/scale", "kind": "Scale",
                              "namespaced": True,
                              "verbs": ["get", "patch", "update"]})
    for parent, sub, kind, verbs in _SUBRESOURCES:
        resources.append({"name": f"{parent}/{sub}", "kind": kind,
                          "namespaced": True, "verbs": verbs})
    return {"kind": "APIResourceList", "groupVersion": "v1",
            "resources": resources}


def _version_rank(v: str):
    """kube version-priority ordering: v2 > v1 > v1beta2 > v1beta1 >
    v1alpha1 > anything unparseable (pkg/version kubeVersionPriority)."""
    import re
    m = re.fullmatch(r"v(\d+)(?:(alpha|beta)(\d+)?)?", v)
    if not m:
        return (-1, 0, 0, v)
    major = int(m.group(1))
    stage = {"alpha": 0, "beta": 1, None: 2}[m.group(2)]
    return (0, major, stage, int(m.group(3) or 0))


def _group_versions(group: str, builtin_groups: dict, crd_registry,
                    extra: dict[str, set] | None = None) -> list[str]:
    """Versions the server actually serves for `group` — builtin groups
    contribute their routed version, CRDs their served versions,
    aggregated APIServices their registered versions.  No phantom v1
    for groups that only exist at other versions."""
    versions: set[str] = set()
    if group in builtin_groups:
        versions.add(GROUP_PREFERRED_VERSION.get(group, "v1"))
    for info in crd_registry.resources():
        if info["group"] == group:
            versions.update(info["versions"])
    versions.update((extra or {}).get(group, ()))
    return sorted(versions, key=_version_rank, reverse=True)


def _api_group(group: str, versions: list[str]) -> dict:
    preferred = versions[0]
    return {"name": group,
            "versions": [{"groupVersion": f"{group}/{v}", "version": v}
                         for v in versions],
            "preferredVersion": {"groupVersion": f"{group}/{preferred}",
                                 "version": preferred}}


def group_list(builtin_groups: dict, crd_registry,
               extra: dict[str, set] | None = None) -> dict:
    groups = (set(builtin_groups) | crd_registry.groups()
              | set(extra or ()))
    out = []
    for g in sorted(groups):
        versions = _group_versions(g, builtin_groups, crd_registry, extra)
        if versions:
            out.append(dict(_api_group(g, versions), kind="APIGroup"))
    return {"kind": "APIGroupList", "groups": out}


def api_group(group: str, builtin_groups: dict, crd_registry,
              extra: dict[str, set] | None = None) -> dict | None:
    versions = _group_versions(group, builtin_groups, crd_registry, extra)
    if not versions:
        return None
    return dict(_api_group(group, versions), kind="APIGroup",
                apiVersion="v1")


def group_resource_list(group: str, version: str, builtin_groups: dict,
                        cluster_scoped: frozenset[str], scalable: set[str],
                        crd_registry) -> dict | None:
    resources = []
    if version == GROUP_PREFERRED_VERSION.get(group, "v1"):
        for plural in sorted(builtin_groups.get(group, ())):
            kind, shorts = GROUP_KINDS.get(plural, (plural.title(), ()))
            resources.append(_resource_entry(
                plural, kind, plural not in cluster_scoped, shorts))
            if plural in scalable:
                resources.append({"name": f"{plural}/scale",
                                  "kind": "Scale", "namespaced": True,
                                  "verbs": ["get", "patch", "update"]})
    for info in crd_registry.resources():
        if info["group"] == group and version in info["versions"]:
            resources.append(_resource_entry(
                info["plural"], info["kind"], info["namespaced"],
                tuple(info.get("short_names") or ())))
    if not resources:
        return None
    return {"kind": "APIResourceList",
            "groupVersion": f"{group}/{version}", "resources": resources}


def openapi_v2(builtin_groups: dict, cluster_scoped: frozenset[str],
               crd_registry) -> dict:
    """A skeleton swagger doc: enough structure (paths keyed by route,
    definitions keyed by group/version/kind) for a client to enumerate
    what the server serves — kube-openapi's aggregated spec shape
    without per-field schemas for built-ins; CRDs embed their real
    openAPIV3Schema."""
    paths: dict[str, dict] = {}
    definitions: dict[str, dict] = {}

    def add(gv_prefix: str, gv_key: str, plural: str, kind: str,
            namespaced: bool, schema: dict | None = None):
        base = (f"{gv_prefix}/namespaces/{{namespace}}/{plural}"
                if namespaced else f"{gv_prefix}/{plural}")
        paths[base] = {"get": {}, "post": {}}
        paths[base + "/{name}"] = {"get": {}, "put": {}, "patch": {},
                                   "delete": {}}
        definitions[f"{gv_key}.{kind}"] = schema or {
            "type": "object",
            "x-kubernetes-group-version-kind": [
                {"group": gv_key.rpartition("/")[0] if "/" in gv_key
                 else "", "kind": kind,
                 "version": gv_key.rpartition("/")[2]}]}

    for plural, (kind, _) in CORE_KINDS.items():
        add("/api/v1", "v1", plural, kind, plural not in cluster_scoped)
    for group, plurals in builtin_groups.items():
        version = GROUP_PREFERRED_VERSION.get(group, "v1")
        for plural in plurals:
            kind, _ = GROUP_KINDS.get(plural, (plural.title(), ()))
            add(f"/apis/{group}/{version}", f"{group}/{version}", plural,
                kind, plural not in cluster_scoped)
    for info in crd_registry.resources():
        for version in info["versions"]:
            add(f"/apis/{info['group']}/{version}",
                f"{info['group']}/{version}", info["plural"],
                info["kind"], info["namespaced"],
                schema=info["schemas"].get(version) or None)
    from .openapi_schemas import install
    install(definitions)  # real field trees for the load-bearing kinds
    return {"swagger": "2.0",
            "info": {"title": "kubernetes-tpu", "version": __version__},
            "paths": paths, "definitions": definitions}


# -- OpenAPI v3 (kube-openapi handler3: a discovery index of per-
# group-version documents, lazily fetched by clients) ------------------

def openapi_v3_index(builtin_groups: dict, crd_registry) -> dict:
    """GET /openapi/v3: group-version -> server-relative doc URL."""
    from ..api import core_versions as corever
    gvs = [f"api/{v}" for v in corever.SERVED_VERSIONS]
    for group in builtin_groups:
        version = GROUP_PREFERRED_VERSION.get(group, "v1")
        gvs.append(f"apis/{group}/{version}")
    for info in crd_registry.resources():
        for version in info["versions"]:
            gvs.append(f"apis/{info['group']}/{version}")
    return {"paths": {gv: {"serverRelativeURL": f"/openapi/v3/{gv}"}
                      for gv in sorted(set(gvs))}}


def _v2_schema_to_v3(node):
    """Rewrite swagger-2 $refs into OpenAPI-3 component refs, deep."""
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            if k == "$ref" and isinstance(v, str) \
                    and v.startswith("#/definitions/"):
                out[k] = "#/components/schemas/" + v[len("#/definitions/"):]
            else:
                out[k] = _v2_schema_to_v3(v)
        return out
    if isinstance(node, list):
        return [_v2_schema_to_v3(x) for x in node]
    return node


def openapi_v3_group(gv: str, builtin_groups: dict,
                     cluster_scoped: frozenset[str],
                     crd_registry) -> dict | None:
    """GET /openapi/v3/{gv}: an OpenAPI 3.0 document for one
    group-version, built from the same source of truth as the v2 doc
    (paths filtered to the gv; definitions -> components.schemas with
    rewritten refs).  None for anything not in the /openapi/v3 index
    (a real apiserver 404s un-indexed keys — 'apis' or 'apis/apps'
    must not return a merged catch-all document)."""
    index = openapi_v3_index(builtin_groups, crd_registry)["paths"]
    if gv not in index:
        return None
    full = openapi_v2(builtin_groups, cluster_scoped, crd_registry)
    prefix = "/" + gv + "/"
    paths = {p: spec for p, spec in full["paths"].items()
             if p.startswith(prefix)}
    if not paths and gv.startswith("api/"):
        # non-hub core version: the v2 doc only carries hub paths;
        # synthesize this version's routes from the conversion seam's
        # served-resource table so the doc is never empty
        from ..api import core_versions as corever
        version = gv[len("api/"):]
        for plural, (kind, _s) in CORE_KINDS.items():
            if not corever.handles(plural, version):
                continue
            namespaced = plural not in cluster_scoped
            base = (f"/api/{version}/namespaces/{{namespace}}/{plural}"
                    if namespaced else f"/api/{version}/{plural}")
            paths[base] = {"get": {}, "post": {}}
            paths[base + "/{name}"] = {"get": {}, "put": {},
                                       "patch": {}, "delete": {}}
    schemas = _v2_schema_to_v3(full["definitions"])
    return {"openapi": "3.0.0",
            "info": {"title": "kubernetes-tpu", "version": __version__},
            "paths": paths,
            "components": {"schemas": schemas}}
