"""Structural OpenAPI v2 schemas for the load-bearing built-in kinds.

The reference aggregates generated per-field swagger docs for every type
(kube-openapi over `staging/src/k8s.io/api/*/types.go` comment docs);
here the hot kinds carry hand-maintained structural schemas — enough for
`kubectl explain`, client validation, and discovery tooling to walk real
field trees with descriptions.  Kinds not listed fall back to the
skeleton definition (discovery.py openapi_v2 add()).
"""

from __future__ import annotations


def _obj(description: str, properties: dict | None = None,
         required: list[str] | None = None, gvk: list[dict] | None = None,
         additional=None) -> dict:
    d: dict = {"type": "object", "description": description}
    if properties:
        d["properties"] = properties
    if required:
        d["required"] = required
    if gvk:
        d["x-kubernetes-group-version-kind"] = gvk
    if additional is not None:
        d["additionalProperties"] = additional
    return d


def _s(description: str) -> dict:
    return {"type": "string", "description": description}


def _i(description: str) -> dict:
    return {"type": "integer", "description": description}


def _b(description: str) -> dict:
    return {"type": "boolean", "description": description}


def _arr(items: dict, description: str) -> dict:
    return {"type": "array", "items": items, "description": description}


def _ref(key: str, description: str = "") -> dict:
    d: dict = {"$ref": f"#/definitions/{key}"}
    if description:
        d["description"] = description
    return d


def _map(description: str) -> dict:
    return _obj(description, additional={"type": "string"})


# -- shared sub-definitions ----------------------------------------------

DEFINITIONS: dict[str, dict] = {
    "v1.ObjectMeta": _obj(
        "Standard object metadata (apimachinery/pkg/apis/meta/v1).",
        {
            "name": _s("Unique name within a namespace. Immutable."),
            "namespace": _s("Namespace scoping the object; 'default' "
                            "when unset on namespaced resources."),
            "labels": _map("String keys/values used by selectors."),
            "annotations": _map("Arbitrary non-identifying metadata."),
            "uid": _s("System-generated unique id, stable for the "
                      "object's lifetime."),
            "resourceVersion": _s("Opaque version for optimistic "
                                  "concurrency and watch resumption."),
            "creationTimestamp": _s("Server-assigned RFC3339 creation "
                                    "time."),
            "deletionTimestamp": _s("Set when deletion is requested; "
                                    "the object is terminating."),
            "generation": _i("Sequence number incremented on spec "
                             "changes."),
            "ownerReferences": _arr(
                _obj("Owner of this object (controller GC roots).", {
                    "apiVersion": _s("Owner apiVersion."),
                    "kind": _s("Owner kind."),
                    "name": _s("Owner name."),
                    "uid": _s("Owner uid."),
                    "controller": _b("True when the managing "
                                     "controller."),
                    "blockOwnerDeletion": _b(
                        "Owner cannot be deleted until this "
                        "dependent is gone (foreground GC)."),
                }),
                "Objects depended on by this one; GC deletes the object "
                "when all owners are gone."),
            "finalizers": _arr(_s("Finalizer key."),
                               "Must be emptied before deletion "
                               "completes."),
            "managedFields": _arr(
                _obj("Field ownership entry (server-side apply)."),
                "Per-manager field ownership used by server-side "
                "apply conflict detection."),
        }),
    "v1.ResourceRequirements": _obj(
        "Compute resource requests/limits (pkg/api/v1/resource).",
        {
            "requests": _map("Minimum resources required: cpu "
                             "(milli-units, e.g. '250m'), memory "
                             "(e.g. '256Mi'), ephemeral-storage, and "
                             "extended resources."),
            "limits": _map("Maximum resources allowed; same keys as "
                           "requests."),
        }),
    "v1.ContainerPort": _obj(
        "Network port exposed by a container.",
        {
            "name": _s("IANA_SVC_NAME, unique within the pod."),
            "containerPort": _i("Port number on the pod's IP."),
            "hostPort": _i("Port on the host node; constrains "
                           "scheduling (NodePorts plugin)."),
            "hostIP": _s("Host IP to bind the hostPort to."),
            "protocol": _s("TCP, UDP or SCTP; defaults to TCP."),
        }, required=["containerPort"]),
    "v1.EnvVar": _obj(
        "Environment variable in a container.",
        {
            "name": _s("Variable name."),
            "value": _s("Literal value."),
            "valueFrom": _obj("Source for the value (fieldRef, "
                              "configMapKeyRef, secretKeyRef)."),
        }, required=["name"]),
    "v1.VolumeMount": _obj(
        "Mount of a pod volume into a container.",
        {
            "name": _s("Matches a pod volume name."),
            "mountPath": _s("Path within the container."),
            "readOnly": _b("Mounted read-only when true."),
            "subPath": _s("Sub-path within the volume."),
        }, required=["name", "mountPath"]),
    "v1.Probe": _obj(
        "Health check performed against a container "
        "(kubelet prober).",
        {
            "exec": _obj("Command probe: exit 0 == healthy.", {
                "command": _arr(_s("argv element."),
                                "Command to run in the container."),
            }),
            "httpGet": _obj("HTTP probe: 2xx/3xx == healthy.", {
                "path": _s("Request path."),
                "port": _i("Port to connect to."),
                "host": _s("Host header override."),
                "scheme": _s("HTTP or HTTPS."),
            }),
            "tcpSocket": _obj("TCP probe: connect success == healthy.", {
                "port": _i("Port to connect to."),
            }),
            "initialDelaySeconds": _i("Delay before the first probe."),
            "periodSeconds": _i("Probe interval; default 10s."),
            "timeoutSeconds": _i("Per-probe timeout; default 1s."),
            "successThreshold": _i("Consecutive successes to be "
                                   "healthy; default 1."),
            "failureThreshold": _i("Consecutive failures to be "
                                   "unhealthy; default 3."),
        }),
    "v1.Container": _obj(
        "A single container within a pod (core/v1 Container).",
        {
            "name": _s("DNS_LABEL, unique within the pod. Immutable."),
            "image": _s("Container image reference."),
            "command": _arr(_s("argv element."),
                            "Entrypoint override (not run in a shell)."),
            "args": _arr(_s("argument."), "Arguments to the entrypoint."),
            "workingDir": _s("Working directory."),
            "ports": _arr(_ref("v1.ContainerPort"),
                          "Ports exposed by the container; hostPort "
                          "entries constrain scheduling."),
            "env": _arr(_ref("v1.EnvVar"), "Environment variables."),
            "resources": _ref("v1.ResourceRequirements",
                              "Requests drive scheduling (NodeResourcesFit"
                              "); limits drive QoS class."),
            "volumeMounts": _arr(_ref("v1.VolumeMount"),
                                 "Pod volumes mounted into this "
                                 "container."),
            "livenessProbe": _ref("v1.Probe",
                                  "Failure restarts the container."),
            "readinessProbe": _ref("v1.Probe",
                                   "Failure removes the pod from "
                                   "service endpoints."),
            "startupProbe": _ref("v1.Probe",
                                 "Gates liveness/readiness until "
                                 "first success."),
            "imagePullPolicy": _s("Always, IfNotPresent or Never."),
            "securityContext": _obj("Per-container security options."),
        }, required=["name"]),
    "v1.Toleration": _obj(
        "Marks the pod as tolerating a matching node taint "
        "(TaintToleration plugin).",
        {
            "key": _s("Taint key; empty + Exists matches all."),
            "operator": _s("Exists or Equal (default Equal)."),
            "value": _s("Taint value to equal."),
            "effect": _s("NoSchedule, PreferNoSchedule or NoExecute; "
                         "empty matches all."),
            "tolerationSeconds": _i("For NoExecute: seconds the pod "
                                    "stays bound after the taint "
                                    "appears."),
        }),
    "v1.LabelSelector": _obj(
        "Label query over a set of objects "
        "(apimachinery LabelSelector).",
        {
            "matchLabels": _map("Exact-match key/value requirements, "
                                "ANDed."),
            "matchExpressions": _arr(
                _obj("Set-based requirement.", {
                    "key": _s("Label key."),
                    "operator": _s("In, NotIn, Exists or "
                                   "DoesNotExist."),
                    "values": _arr(_s("value."),
                                   "Values for In/NotIn."),
                }),
                "Set-based requirements, ANDed with matchLabels."),
        }),
    "v1.TopologySpreadConstraint": _obj(
        "Even-spread constraint over topology domains "
        "(PodTopologySpread plugin).",
        {
            "maxSkew": _i("Max allowed difference in matching-pod "
                          "counts between domains."),
            "topologyKey": _s("Node label key defining the domains "
                              "(e.g. topology.kubernetes.io/zone)."),
            "whenUnsatisfiable": _s("DoNotSchedule (hard) or "
                                    "ScheduleAnyway (scoring)."),
            "labelSelector": _ref("v1.LabelSelector",
                                  "Pods counted per domain."),
        }, required=["maxSkew", "topologyKey", "whenUnsatisfiable"]),
    "v1.Affinity": _obj(
        "Scheduling affinity rules (NodeAffinity / InterPodAffinity "
        "plugins).",
        {
            "nodeAffinity": _obj("Node label constraints.", {
                "requiredDuringSchedulingIgnoredDuringExecution": _obj(
                    "Hard node selector terms (filter)."),
                "preferredDuringSchedulingIgnoredDuringExecution": _arr(
                    _obj("Weighted preference (score)."),
                    "Soft node preferences."),
            }),
            "podAffinity": _obj("Attract toward nodes/domains running "
                                "matching pods."),
            "podAntiAffinity": _obj("Repel from nodes/domains running "
                                    "matching pods."),
        }),
    "v1.PodSpec": _obj(
        "Desired pod behavior (core/v1 PodSpec).",
        {
            "containers": _arr(_ref("v1.Container"),
                               "Containers in the pod; at least one. "
                               "Cannot be added/removed in place."),
            "initContainers": _arr(_ref("v1.Container"),
                                   "Run to completion, in order, "
                                   "before containers start."),
            "nodeName": _s("Node the pod is bound to; set by the "
                           "scheduler via the binding subresource."),
            "nodeSelector": _map("Hard node-label requirements "
                                 "(NodeAffinity filter)."),
            "affinity": _ref("v1.Affinity"),
            "tolerations": _arr(_ref("v1.Toleration"),
                                "Taints this pod tolerates."),
            "topologySpreadConstraints": _arr(
                _ref("v1.TopologySpreadConstraint"),
                "Even-spread constraints over topology domains."),
            "schedulerName": _s("Profile that schedules this pod; "
                                "default-scheduler when unset."),
            "priority": _i("Resolved priority value (admission fills "
                           "it from priorityClassName)."),
            "priorityClassName": _s("PriorityClass to resolve "
                                    "priority from."),
            "preemptionPolicy": _s("PreemptLowerPriority (default) or "
                                   "Never."),
            "restartPolicy": _s("Always, OnFailure or Never."),
            "terminationGracePeriodSeconds": _i(
                "Seconds allowed for graceful shutdown; default 30."),
            "serviceAccountName": _s("ServiceAccount for API "
                                     "credentials."),
            "volumes": _arr(_obj("Pod volume definition."),
                            "Volumes mountable by containers."),
            "hostNetwork": _b("Use the host's network namespace."),
            "overhead": _map("Resource overhead of the pod sandbox "
                             "(RuntimeClass)."),
        }, required=["containers"]),
    "v1.PodStatus": _obj(
        "Most recently observed pod state (written by kubelet and "
        "scheduler).",
        {
            "phase": _s("Pending, Running, Succeeded, Failed or "
                        "Unknown."),
            "conditions": _arr(
                _obj("Condition entry.", {
                    "type": _s("PodScheduled, Ready, Initialized, "
                               "ContainersReady."),
                    "status": _s("True, False or Unknown."),
                    "reason": _s("Machine-readable reason (e.g. "
                                 "Unschedulable)."),
                    "message": _s("Human-readable detail."),
                }),
                "Current service state conditions."),
            "podIP": _s("Pod's primary IP, assigned at sandbox "
                        "creation."),
            "hostIP": _s("IP of the node the pod runs on."),
            "containerStatuses": _arr(
                _obj("Per-container runtime status."),
                "Status of each container in spec.containers."),
            "nominatedNodeName": _s("Node nominated by preemption; "
                                    "scheduler tries it first."),
            "startTime": _s("Time the kubelet acknowledged the pod."),
            "qosClass": _s("Guaranteed, Burstable or BestEffort."),
        }),
    "v1.NodeStatus": _obj(
        "Most recently observed node state (kubelet status loop).",
        {
            "capacity": _map("Total resources: cpu, memory, pods, "
                             "ephemeral-storage, extended resources."),
            "allocatable": _map("Resources available for pods "
                                "(capacity minus reserved); the "
                                "scheduler fits against these."),
            "conditions": _arr(
                _obj("Node condition.", {
                    "type": _s("Ready, MemoryPressure, DiskPressure, "
                               "PIDPressure, NetworkUnavailable."),
                    "status": _s("True, False or Unknown."),
                    "reason": _s("Machine-readable reason."),
                }),
                "Observed conditions; Ready gates scheduling."),
            "addresses": _arr(_obj("Node address.", {
                "type": _s("InternalIP, ExternalIP or Hostname."),
                "address": _s("The address."),
            }), "Reachable addresses."),
            "nodeInfo": _obj("Static node info (kubelet version, OS, "
                             "architecture)."),
            "images": _arr(_obj("Image present on the node."),
                           "Container images on this node (image "
                           "locality scoring)."),
        }),
    "v1.Taint": _obj(
        "Repels pods that do not tolerate it (node.spec.taints).",
        {
            "key": _s("Taint key."),
            "value": _s("Taint value."),
            "effect": _s("NoSchedule, PreferNoSchedule or NoExecute."),
            "timeAdded": _s("When added (NoExecute only)."),
        }, required=["key", "effect"]),
    "v1.ServicePort": _obj(
        "Port exposed by a Service.",
        {
            "name": _s("Name, unique in the service; required when "
                       "multiple ports."),
            "port": _i("Port exposed by the service."),
            "targetPort": _i("Port (or named port) on the backend "
                             "pods."),
            "nodePort": _i("Node-wide port for NodePort/LoadBalancer "
                           "services (allocated from the node port "
                           "range when unset)."),
            "protocol": _s("TCP, UDP or SCTP; default TCP."),
        }, required=["port"]),
    "v1.PodTemplateSpec": _obj(
        "Pod template stamped out by workload controllers.",
        {
            "metadata": _ref("v1.ObjectMeta",
                             "Labels here must satisfy the parent's "
                             "selector."),
            "spec": _ref("v1.PodSpec"),
        }),
}


# -- top-level kinds ------------------------------------------------------

def _kind(gv: str, kind: str, description: str, spec: dict | None,
          status: dict | None, extra: dict | None = None) -> dict:
    group, _, version = gv.rpartition("/")
    props = {
        "apiVersion": _s("Schema version of this representation."),
        "kind": _s("REST resource this object represents."),
        "metadata": _ref("v1.ObjectMeta"),
    }
    if spec is not None:
        props["spec"] = spec
    if status is not None:
        props["status"] = status
    if extra:
        props.update(extra)
    return _obj(description, props,
                gvk=[{"group": group, "version": version, "kind": kind}])


KIND_SCHEMAS: dict[str, dict] = {
    "v1.Pod": _kind(
        "v1", "Pod",
        "A group of containers scheduled onto one node and sharing its "
        "network/storage context (ref pkg/apis/core/types.go Pod).",
        _ref("v1.PodSpec", "Desired behavior."),
        _ref("v1.PodStatus", "Observed state.")),
    "v1.Node": _kind(
        "v1", "Node",
        "A worker machine; pods are bound to nodes by the scheduler.",
        _obj("Node configuration.", {
            "unschedulable": _b("Excludes the node from scheduling "
                                "(kubectl cordon)."),
            "taints": _arr(_ref("v1.Taint"),
                           "Taints repelling non-tolerating pods."),
            "podCIDR": _s("Pod IP range assigned to the node."),
            "providerID": _s("Cloud provider node id."),
        }),
        _ref("v1.NodeStatus", "Observed state.")),
    "v1.Service": _kind(
        "v1", "Service",
        "Named abstraction over a set of pods: a virtual IP and port "
        "list load-balanced to selected backends (kube-proxy).",
        _obj("Service behavior.", {
            "selector": _map("Pods with these labels back the "
                             "service; endpoints are derived "
                             "continuously."),
            "ports": _arr(_ref("v1.ServicePort"),
                          "Exposed ports."),
            "type": _s("ClusterIP, NodePort, LoadBalancer or "
                       "ExternalName."),
            "clusterIP": _s("Virtual IP; allocated when unset; "
                            "'None' for headless services."),
            "sessionAffinity": _s("None or ClientIP (sticky "
                                  "backends)."),
            "externalName": _s("CNAME target for ExternalName "
                               "services."),
        }),
        _obj("Observed state.", {
            "loadBalancer": _obj("Ingress points of the external "
                                 "load balancer."),
        })),
    "v1.Namespace": _kind(
        "v1", "Namespace",
        "Scope for names and policy; namespaced objects live inside "
        "exactly one.",
        _obj("Behavior.", {
            "finalizers": _arr(_s("finalizer."),
                               "Must empty before the namespace is "
                               "fully deleted."),
        }),
        _obj("Lifecycle state.", {
            "phase": _s("Active or Terminating."),
        })),
    "v1.ConfigMap": _kind(
        "v1", "ConfigMap",
        "Non-secret configuration as key/value pairs, consumable as "
        "env vars or volumes.",
        None, None,
        extra={"data": _map("UTF-8 configuration entries."),
               "binaryData": _map("Base64 binary entries."),
               "immutable": _b("Data cannot change when true.")}),
    "v1.Secret": _kind(
        "v1", "Secret",
        "Sensitive data (tokens, keys, certs); base64-encoded at rest.",
        None, None,
        extra={"data": _map("Base64-encoded entries."),
               "stringData": _map("Write-only plain entries, merged "
                                  "into data."),
               "type": _s("Opaque, kubernetes.io/service-account-token, "
                          "kubernetes.io/tls, ...")}),
    "v1.Event": _kind(
        "v1", "Event",
        "A report of something that happened to an object (scheduler "
        "decisions, kubelet lifecycle, controller actions).",
        None, None,
        extra={
            "involvedObject": _obj("The object this event is about.", {
                "kind": _s("Kind."), "namespace": _s("Namespace."),
                "name": _s("Name."), "uid": _s("UID."),
            }),
            "reason": _s("Short machine-readable reason (e.g. "
                         "Scheduled, FailedScheduling)."),
            "message": _s("Human-readable description."),
            "type": _s("Normal or Warning."),
            "count": _i("Times this event occurred (aggregation)."),
            "source": _obj("Reporting component.", {
                "component": _s("e.g. default-scheduler."),
                "host": _s("Node name."),
            }),
        }),
    "apps/v1.Deployment": _kind(
        "apps/v1", "Deployment",
        "Declarative updates for ReplicaSets: rolling upgrades, "
        "rollback, pause/resume (pkg/controller/deployment).",
        _obj("Desired state.", {
            "replicas": _i("Desired pod count; default 1."),
            "selector": _ref("v1.LabelSelector",
                             "Must match template labels. Immutable."),
            "template": _ref("v1.PodTemplateSpec"),
            "strategy": _obj("Replacement strategy.", {
                "type": _s("RollingUpdate (default) or Recreate."),
                "rollingUpdate": _obj("Rolling update bounds.", {
                    "maxUnavailable": _i("Pods that may be down "
                                         "during update."),
                    "maxSurge": _i("Pods over desired during "
                                   "update."),
                }),
            }),
            "minReadySeconds": _i("Seconds a new pod must be ready "
                                  "to count as available."),
            "revisionHistoryLimit": _i("Old ReplicaSets retained for "
                                       "rollback; default 10."),
            "paused": _b("Rollouts suspended when true."),
        }),
        _obj("Observed state.", {
            "replicas": _i("Total pods tracked."),
            "updatedReplicas": _i("Pods at the current template."),
            "readyReplicas": _i("Ready pods."),
            "availableReplicas": _i("Ready for minReadySeconds."),
            "observedGeneration": _i("Generation acted on."),
            "conditions": _arr(_obj("Deployment condition."),
                               "Available / Progressing state."),
        })),
    "apps/v1.ReplicaSet": _kind(
        "apps/v1", "ReplicaSet",
        "Maintains a stable set of replica pods "
        "(pkg/controller/replicaset).",
        _obj("Desired state.", {
            "replicas": _i("Desired pod count."),
            "selector": _ref("v1.LabelSelector"),
            "template": _ref("v1.PodTemplateSpec"),
            "minReadySeconds": _i("Readiness dwell before counting "
                                  "available."),
        }),
        _obj("Observed state.", {
            "replicas": _i("Current pod count."),
            "readyReplicas": _i("Ready pods."),
            "availableReplicas": _i("Available pods."),
            "fullyLabeledReplicas": _i("Pods matching all template "
                                       "labels."),
            "observedGeneration": _i("Generation acted on."),
        })),
    "apps/v1.StatefulSet": _kind(
        "apps/v1", "StatefulSet",
        "Ordered, identity-preserving replicas with stable names "
        "(pkg/controller/statefulset).",
        _obj("Desired state.", {
            "replicas": _i("Desired pod count."),
            "selector": _ref("v1.LabelSelector"),
            "template": _ref("v1.PodTemplateSpec"),
            "serviceName": _s("Headless service owning the pod DNS "
                              "identities."),
            "podManagementPolicy": _s("OrderedReady (default) or "
                                      "Parallel."),
            "updateStrategy": _obj("RollingUpdate (partitioned) or "
                                   "OnDelete."),
        }),
        _obj("Observed state.", {
            "replicas": _i("Current pods."),
            "readyReplicas": _i("Ready pods."),
            "currentRevision": _s("Revision of current pods."),
            "updateRevision": _s("Revision being rolled to."),
        })),
    "apps/v1.DaemonSet": _kind(
        "apps/v1", "DaemonSet",
        "Runs one pod per (matching) node "
        "(pkg/controller/daemon).",
        _obj("Desired state.", {
            "selector": _ref("v1.LabelSelector"),
            "template": _ref("v1.PodTemplateSpec",
                             "Node selection comes from the "
                             "template's affinity/tolerations."),
            "updateStrategy": _obj("RollingUpdate or OnDelete."),
        }),
        _obj("Observed state.", {
            "desiredNumberScheduled": _i("Nodes that should run the "
                                         "daemon pod."),
            "currentNumberScheduled": _i("Nodes running it."),
            "numberReady": _i("Nodes with a ready daemon pod."),
            "numberMisscheduled": _i("Nodes running it that should "
                                     "not."),
        })),
    "batch/v1.Job": _kind(
        "batch/v1", "Job",
        "Runs pods to completion; tracks successes "
        "(pkg/controller/job).",
        _obj("Desired state.", {
            "completions": _i("Successful pods required; default 1."),
            "parallelism": _i("Max pods running at once."),
            "backoffLimit": _i("Retries before marking failed; "
                               "default 6."),
            "activeDeadlineSeconds": _i("Wall-clock bound for the "
                                        "whole job."),
            "selector": _ref("v1.LabelSelector"),
            "template": _ref("v1.PodTemplateSpec"),
            "completionMode": _s("NonIndexed (default) or Indexed."),
            "suspend": _b("No pods are created while true."),
        }),
        _obj("Observed state.", {
            "active": _i("Running pods."),
            "succeeded": _i("Pods that completed successfully."),
            "failed": _i("Pods that failed."),
            "conditions": _arr(_obj("Complete / Failed condition."),
                               "Terminal state conditions."),
            "startTime": _s("When the controller started the job."),
            "completionTime": _s("When the job completed."),
        })),
    "autoscaling/v2.HorizontalPodAutoscaler": _kind(
        "autoscaling/v2", "HorizontalPodAutoscaler",
        "Scales a workload's replica count to hold a metric target "
        "(pkg/controller/podautoscaler).",
        _obj("Autoscaler spec.", {
            "scaleTargetRef": _obj("Workload to scale.", {
                "apiVersion": _s("Target apiVersion."),
                "kind": _s("Target kind."),
                "name": _s("Target name."),
            }),
            "minReplicas": _i("Lower bound; default 1."),
            "maxReplicas": _i("Upper bound."),
            "metrics": _arr(_obj("Metric source (Resource/Pods/"
                                 "Object/External)."),
                            "Targets driving the scale decision."),
        }),
        _obj("Observed state.", {
            "currentReplicas": _i("Current count."),
            "desiredReplicas": _i("Last computed target."),
            "conditions": _arr(_obj("ScalingActive / AbleToScale "
                                    "condition."),
                               "Autoscaler conditions."),
        })),
}


def install(definitions: dict[str, dict]) -> None:
    """Overlay the structural schemas onto an openapi_v2 definitions
    map: shared sub-definitions first, then top-level kinds (replacing
    skeletons of the same key)."""
    for key, schema in DEFINITIONS.items():
        definitions.setdefault(key, schema)
    for key, schema in KIND_SCHEMAS.items():
        definitions[key] = schema
