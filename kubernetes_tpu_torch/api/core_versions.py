"""Multi-version serving for CORE API types (hub-and-spoke conversion).

Reference: pkg/apis/core/v1/conversion.go + defaults.go and
apimachinery/pkg/runtime/scheme.go — the reference converts every core
object between its internal hub type and the served v1 on each request,
which is what makes versioned evolution / rolling upgrades possible.
Here the stored v1 form IS the hub, and additional served versions
declare a pair of pure conversion functions to/from it, exactly the
seam CRDs use (apiserver/crd.py convert/to_storage) but for built-ins.

The served v2alpha1 Pod regroups the scheduling knobs that v1 scatters
across spec/status into one `spec.scheduling` stanza:

    v1                              v2alpha1
    spec.schedulerName          ->  spec.scheduling.schedulerName
    spec.priority               ->  spec.scheduling.priority
    spec.priorityClassName      ->  spec.scheduling.priorityClassName
    spec.preemptionPolicy       ->  spec.scheduling.preemptionPolicy
    status.nominatedNodeName    ->  status.scheduling.nominatedNodeName

Everything else passes through untouched (unknown fields survive the
round trip in both directions).  v2alpha1 defaulting fills
scheduling.schedulerName="default-scheduler", mirroring v1's
SetDefaults_PodSpec schedulerName default.
"""

from __future__ import annotations

HUB = "v1"
SERVED_VERSIONS = ("v1", "v2alpha1")

_SPEC_FIELDS = ("schedulerName", "priority", "priorityClassName",
                "preemptionPolicy")


def _pod_to_v2alpha1(pod: dict) -> dict:
    out = dict(pod)
    out["apiVersion"] = "v2alpha1"
    spec = dict(pod.get("spec") or {})
    sched = dict(spec.pop("scheduling", None) or {})
    for f in _SPEC_FIELDS:
        if f in spec:
            sched[f] = spec.pop(f)
    if sched:
        spec["scheduling"] = sched
    out["spec"] = spec
    status = pod.get("status")
    if status and "nominatedNodeName" in status:
        status = dict(status)
        st_sched = dict(status.get("scheduling") or {})
        st_sched["nominatedNodeName"] = status.pop("nominatedNodeName")
        status["scheduling"] = st_sched
        out["status"] = status
    return out


def _pod_to_v1(pod: dict) -> dict:
    out = dict(pod)
    out["apiVersion"] = "v1"
    spec = dict(pod.get("spec") or {})
    sched = spec.pop("scheduling", None)
    if sched:
        for f in _SPEC_FIELDS:
            if f in sched:
                spec[f] = sched[f]
        extra = {k: v for k, v in sched.items() if k not in _SPEC_FIELDS}
        if extra:
            spec["scheduling"] = extra  # unknown subfields survive
    out["spec"] = spec
    status = pod.get("status")
    if status and "scheduling" in status:
        status = dict(status)
        st_sched = dict(status["scheduling"])
        if "nominatedNodeName" in st_sched:
            status["nominatedNodeName"] = st_sched.pop("nominatedNodeName")
        if st_sched:
            status["scheduling"] = st_sched
        else:
            status.pop("scheduling")
        out["status"] = status
    return out


def _pod_default_v2alpha1(pod: dict) -> dict:
    spec = pod.get("spec")
    if spec is None:
        return pod
    sched = spec.get("scheduling")
    if sched is None or sched.get("schedulerName") in (None, ""):
        pod = dict(pod)
        spec = dict(spec)
        sched = dict(sched or {})
        sched["schedulerName"] = "default-scheduler"
        spec["scheduling"] = sched
        pod["spec"] = spec
    return pod


# resource -> version -> (from_hub, to_hub, default_or_None)
_CONVERTERS: dict[str, dict[str, tuple]] = {
    "pods": {
        "v2alpha1": (_pod_to_v2alpha1, _pod_to_v1, _pod_default_v2alpha1),
    },
}


# ---- v1 (hub) write-time defaulting ---------------------------------------
# pkg/apis/core/v1/defaults.go — the load-bearing defaults every
# reference client may assume are present on a stored object.  All
# functions MUTATE in place and only fill MISSING fields (idempotent),
# so re-running on updates/patches can never clobber user intent.

_VOLUME_MODE_RESOURCES = ("persistentvolumes", "persistentvolumeclaims")


def _default_container(c: dict) -> None:
    """SetDefaults_Container (defaults.go): pull policy by image tag,
    termination message fields, port protocol, probe timings."""
    if not c.get("imagePullPolicy"):
        image = c.get("image") or ""
        tag = image.rpartition(":")[2] if ":" in image.rpartition("/")[2] \
            else ""
        c["imagePullPolicy"] = ("Always" if tag in ("", "latest")
                                else "IfNotPresent")
    c.setdefault("terminationMessagePath", "/dev/termination-log")
    c.setdefault("terminationMessagePolicy", "File")
    for p in c.get("ports") or ():
        p.setdefault("protocol", "TCP")
    for probe_key in ("livenessProbe", "readinessProbe", "startupProbe"):
        probe = c.get(probe_key)
        if probe is not None:
            probe.setdefault("timeoutSeconds", 1)
            probe.setdefault("periodSeconds", 10)
            probe.setdefault("successThreshold", 1)
            probe.setdefault("failureThreshold", 3)
            if "httpGet" in probe:
                probe["httpGet"].setdefault("scheme", "HTTP")


def _default_pod_v1(pod: dict) -> None:
    """SetDefaults_Pod/PodSpec (defaults.go:118-199)."""
    spec = pod.setdefault("spec", {})
    spec.setdefault("restartPolicy", "Always")
    spec.setdefault("dnsPolicy", "ClusterFirst")
    spec.setdefault("schedulerName", "default-scheduler")
    spec.setdefault("terminationGracePeriodSeconds", 30)
    spec.setdefault("enableServiceLinks", True)
    spec.setdefault("securityContext", {})
    all_containers = list(spec.get("containers") or ()) + list(
        spec.get("initContainers") or ())
    for c in all_containers:
        _default_container(c)
    if spec.get("hostNetwork"):
        # hostNetwork ports bind the node: hostPort defaults to
        # containerPort, for init containers too (defaults.go
        # SetDefaults_Pod defaultHostNetworkPorts on both lists)
        for c in all_containers:
            for p in c.get("ports") or ():
                if p.get("containerPort") and not p.get("hostPort"):
                    p["hostPort"] = p["containerPort"]
    for v in spec.get("volumes") or ():
        # volume-source mode defaults (0644 == 420 decimal)
        for key in ("secret", "configMap", "downwardAPI", "projected"):
            if key in v and isinstance(v[key], dict):
                v[key].setdefault("defaultMode", 420)
        if "hostPath" in v and isinstance(v["hostPath"], dict):
            v["hostPath"].setdefault("type", "")


def _default_service_v1(svc: dict) -> None:
    """SetDefaults_Service (defaults.go:80-117)."""
    spec = svc.setdefault("spec", {})
    spec.setdefault("sessionAffinity", "None")
    spec.setdefault("type", "ClusterIP")
    if spec["sessionAffinity"] == "ClientIP":
        cfg = spec.setdefault("sessionAffinityConfig", {})
        cfg.setdefault("clientIP", {}).setdefault("timeoutSeconds", 10800)
    for p in spec.get("ports") or ():
        p.setdefault("protocol", "TCP")
        if "targetPort" not in p and "port" in p:
            p["targetPort"] = p["port"]
    if spec["type"] in ("NodePort", "LoadBalancer"):
        spec.setdefault("externalTrafficPolicy", "Cluster")
    spec.setdefault("internalTrafficPolicy", "Cluster")


def _default_node_v1(node: dict) -> None:
    """SetDefaults_NodeStatus: allocatable mirrors capacity when unset."""
    status = node.get("status")
    if status and status.get("capacity") and not status.get("allocatable"):
        status["allocatable"] = dict(status["capacity"])


def _default_pv_v1(pv: dict) -> None:
    spec = pv.setdefault("spec", {})
    spec.setdefault("persistentVolumeReclaimPolicy", "Retain")
    spec.setdefault("volumeMode", "Filesystem")
    pv.setdefault("status", {}).setdefault("phase", "Pending")


def _default_pvc_v1(pvc: dict) -> None:
    pvc.setdefault("spec", {}).setdefault("volumeMode", "Filesystem")
    pvc.setdefault("status", {}).setdefault("phase", "Pending")


def _default_secret_v1(secret: dict) -> None:
    secret.setdefault("type", "Opaque")


def _default_namespace_v1(ns: dict) -> None:
    ns.setdefault("status", {}).setdefault("phase", "Active")


def _default_endpoints_v1(ep: dict) -> None:
    for subset in ep.get("subsets") or ():
        for p in subset.get("ports") or ():
            p.setdefault("protocol", "TCP")


_V1_DEFAULTERS = {
    "pods": _default_pod_v1,
    "services": _default_service_v1,
    "nodes": _default_node_v1,
    "persistentvolumes": _default_pv_v1,
    "persistentvolumeclaims": _default_pvc_v1,
    "secrets": _default_secret_v1,
    "namespaces": _default_namespace_v1,
    "endpoints": _default_endpoints_v1,
}


def default_v1(resource: str, obj: dict) -> dict:
    """Apply v1 write-time defaulting in place and return obj (the
    apiserver's write pipeline calls this for every core hub-form
    write; defaults.go runs at decode the same way).  Unknown resources
    pass through."""
    fn = _V1_DEFAULTERS.get(resource)
    if fn is not None and isinstance(obj, dict):
        fn(obj)
    return obj


def handles(resource: str, version: str) -> bool:
    """Is `resource` served at non-hub `version`?"""
    return version in _CONVERTERS.get(resource, ())


def convert(resource: str, obj: dict, target_version: str,
            default: bool = True) -> dict:
    """Serve a stored (hub-form) object at target_version; hub target is
    the identity.  Pure: never mutates the input.

    default=False gives conversion WITHOUT the served version's
    defaulting — for internal round trips (SSA merge, patch-base
    conversion) where injected defaults would masquerade as user-written
    fields."""
    if target_version == HUB:
        return obj
    entry = _CONVERTERS.get(resource, {}).get(target_version)
    if entry is None:
        return obj
    from_hub, _to_hub, defaulter = entry
    out = from_hub(obj)
    if default and defaulter is not None:
        out = defaulter(out)
    return out


def convert_many(resource: str, objs: list[dict],
                 target_version: str) -> list[dict]:
    if target_version == HUB or not handles(resource, target_version):
        return objs
    return [convert(resource, o, target_version) for o in objs]


def to_storage(resource: str, obj: dict, from_version: str,
               default: bool = True) -> dict:
    """A request body written at from_version -> the stored hub form.
    Per-version defaulting runs BEFORE conversion (the reference defaults
    in the served version's types, then converts to the hub); pass
    default=False on internal conversions that must not invent fields."""
    if from_version == HUB:
        return obj
    entry = _CONVERTERS.get(resource, {}).get(from_version)
    if entry is None:
        return obj
    _from_hub, to_hub, defaulter = entry
    if default and defaulter is not None:
        obj = defaulter(obj)
    return to_hub(obj)
