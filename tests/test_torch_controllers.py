"""The controller manager in the port (kubernetes_tpu_torch/controllers/)
held against the JAX package's on the CPU.

  (a) Every module is a copy: its code, docstrings aside, is the JAX
      package's module of the same name (31 modules); the port's
      cmd/cluster.py takes the JAX binary's flags plus --device.
  (b) Parity scripts (fixed, with no random input), each run through
      both packages' ControllerManagers on a store of their own, one
      step at a time, each step waited out until the store takes no
      write for 0.5 s; a fake kubelet in the script binds each new pod
      to a node and reports it Running and Ready with an IP (each
      owner's pods in the order they were created), or Succeeded for a
      Job's pod.  The stores must then hold the same objects once each
      is normalized: the random suffixes of pod, Job-pod and token
      names, uids, resourceVersions, timestamps and generated secrets
      taken out.  pod-template-hash and the
      EndpointSlice port-group id are compared as they are.  The scripts:
      a Deployment behind a Service rolled out, updated and scaled up and
      down; three Deployments deleted with Foreground, Background and
      Orphan propagation; a StatefulSet, a DaemonSet and a Job; a
      namespace with a ResourceQuota, deleted; PodGC's sweep over pods of
      a deleted node and over terminated pods past a threshold.  CronJob,
      HPA and node lifecycle run on a hand clock (reconcile_once(now), and
      the lifecycle monitor with its module's clock replaced).
  (c) ROADMAP R15, pinned in both packages: an update creates the new
      ReplicaSet at the whole replica count at once and leaves the old one
      whole until new pods turn Ready.

Every wait has its own bound, and every manager stops in a finalizer.
"""

import ast
import hashlib
import importlib
import json
import pathlib
import re
import time
import types
import zlib

import pytest

pytest.importorskip("jax")

from torch_cases import PORT_PKG as PORT, code_of, wait_for  # noqa: E402

JAX = "kubernetes_tpu"
PKGS = (JAX, PORT)
ROOT = pathlib.Path(__file__).resolve().parent.parent
T0 = 4_000_000_020.0   # the hand clock's start, well after any real time


def m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


# -- (a) every module a copy ------------------------------------------------

MODULES = sorted(p.stem for p in (ROOT / JAX / "controllers").glob("*.py"))


@pytest.mark.parametrize("name", MODULES)
def test_module_is_a_copy(name):
    assert len(MODULES) == 31
    assert code_of(ROOT / PORT / "controllers" / f"{name}.py") == \
        code_of(ROOT / JAX / "controllers" / f"{name}.py")


def flags_of(path):
    """The first argument of every add_argument call in the module."""
    return [node.args[0].value for node in ast.walk(ast.parse(
        path.read_text())) if isinstance(node, ast.Call)
        and getattr(node.func, "attr", None) == "add_argument"]


def test_cluster_flags_are_the_jax_binarys_plus_device():
    jax_flags = flags_of(ROOT / JAX / "cmd" / "cluster.py")
    port_flags = flags_of(ROOT / PORT / "cmd" / "cluster.py")
    assert sorted(port_flags) == sorted(jax_flags + ["--device"])


def test_registry_and_defaults_match():
    jm, pm = m(JAX, "controllers.manager"), m(PORT, "controllers.manager")
    assert pm.DEFAULT_CONTROLLERS == jm.DEFAULT_CONTROLLERS
    assert {k: v.__name__ for k, v in pm.ControllerManager.CTORS.items()} \
        == {k: v.__name__ for k, v in jm.ControllerManager.CTORS.items()}
    assert set(pm.DEFAULT_CONTROLLERS) <= set(pm.ControllerManager.CTORS)


# -- (b) seeded parity scripts ----------------------------------------------

HAND_CLOCKED = ("cronjob", "horizontalpodautoscaler", "nodelifecycle")
N_NODES = 4


def obj(kind, name, ns="default", **fields):
    md = {"name": name}
    if ns is not None:
        md["namespace"] = ns
    return {"apiVersion": "v1", "kind": kind, "metadata": md, **fields}


def node(i):
    n = obj("Node", f"n{i}", None)
    n["metadata"]["labels"] = {"kubernetes.io/hostname": f"n{i}"}
    rl = {"cpu": "8", "memory": "32Gi", "pods": "110"}
    n["status"] = {"capacity": rl, "allocatable": rl,
                   "conditions": [{"type": "Ready", "status": "True"}]}
    return n


def template(app, image="img:v1", annotations=None):
    md = {"labels": {"app": app}}
    if annotations:
        md["annotations"] = annotations
    return {"metadata": md, "spec": {"containers": [{
        "name": "c0", "image": image,
        "resources": {"requests": {"cpu": "100m", "memory": "128Mi"}}}]}}


def workload(kind, name, replicas=None, ns="default", **spec):
    o = obj(kind, name, ns)
    o["apiVersion"] = "apps/v1"
    o["spec"] = {"selector": {"matchLabels": {"app": name}},
                 "template": template(name), **spec}
    if replicas is not None:
        o["spec"]["replicas"] = replicas
    return o


def service(name, ns="default"):
    return obj("Service", name, ns, spec={
        "selector": {"app": name},
        "ports": [{"name": "http", "port": 80, "protocol": "TCP"}]})


class Cluster:
    """One package's controller manager and Endpoints controller on a
    store of its own with N_NODES nodes.  `hand` names controllers built
    on the same informers but never run (the script calls them); they
    and `skip` stay out of the manager."""

    def __init__(self, pkg, hand=(), skip=HAND_CLOCKED):
        self.pkg = pkg
        self.store = m(pkg, "store.kv").MemoryStore()
        client_mod = m(pkg, "client")
        self.client = client_mod.LocalClient(self.store)
        self.factory = client_mod.SharedInformerFactory(self.client)
        mgr = m(pkg, "controllers.manager")
        for i in range(N_NODES):
            self.client.create("nodes", node(i))
        self.mgr = mgr.ControllerManager(
            self.client, self.factory, tuple(
                c for c in mgr.DEFAULT_CONTROLLERS if c not in skip))
        self.hand = {name: mgr.ControllerManager.CTORS[name](
            self.client, self.factory) for name in hand}
        # as cmd/cluster.py runs it: beside the manager
        self.endpoints = m(pkg, "controllers.endpoints").EndpointsController(
            self.client, self.factory)
        self.seen = {}   # pods run, by owner
        self.factory.start()
        self.factory.wait_for_cache_sync()
        self.mgr.run()
        self.endpoints.run()

    def stop(self):
        self.endpoints.stop()
        self.mgr.stop()
        self.factory.stop()

    def settle(self, quiet=0.5, timeout=30.0):
        """Wait until the store takes no write for `quiet` s."""
        deadline = time.monotonic() + timeout
        rev = self.store.revision
        while True:
            time.sleep(quiet)
            now = self.store.revision
            if now == rev:
                return
            assert time.monotonic() < deadline, \
                f"{self.pkg}: the store still takes writes after {timeout} s"
            rev = now

    def run_pods(self):
        """The fake kubelet: every pod not yet running bound (a DaemonSet
        pod to its pinned node) and reported Running and Ready, or
        Succeeded if a Job owns it.  The k-th pod of an owner, in the
        order the pods were created, takes node n(k mod N_NODES) and an
        IP made of the owner's name and k, so neither depends on how two
        owners' creations interleave.  Returns how many it ran."""
        meta = m(self.pkg, "api.meta")
        pods = [p for p in self.client.list("pods")[0]
                if not (p.get("status") or {}).get("phase")
                and meta.deletion_timestamp(p) is None]
        pods.sort(key=lambda p: int(meta.uid(p).rsplit("-", 1)[1], 16))
        for p in pods:
            refs = p["metadata"].get("ownerReferences") or [{}]
            owner = refs[0].get("name", meta.name(p))
            k = self.seen[owner] = self.seen.get(owner, -1) + 1
            pin = [f["values"][0] for t in (
                ((p["spec"].get("affinity") or {}).get("nodeAffinity") or {})
                .get("requiredDuringSchedulingIgnoredDuringExecution") or {}
            ).get("nodeSelectorTerms", ()) for f in t.get("matchFields", ())]
            target = meta.pod_node_name(p) or (pin[0] if pin else
                                                f"n{k % N_NODES}")
            job = refs[0].get("kind") == "Job"
            ip = f"10.{zlib.crc32(owner.encode()) % 250}.{k // 250}.{k % 250}"

            def run(o, target=target, job=job, ip=ip):
                o["spec"]["nodeName"] = target
                o["status"] = {
                    "phase": "Succeeded" if job else "Running", "podIP": ip,
                    "conditions": [{"type": "Ready",
                                    "status": "False" if job else "True"}]}
                return o
            self.client.guaranteed_update("pods", meta.namespace(p),
                                          meta.name(p), run)
        return len(pods)

    def drive(self):
        """Settle, then run the pods and settle again until none waits."""
        self.settle()
        while self.run_pods():
            self.settle()

    def state(self):
        """Every object in the store, normalized, by resource."""
        return {res: sorted(json.dumps(normalize(o), sort_keys=True)
                            for o in self.client.list(res)[0])
                for res in sorted(self.store._data)}


DROPPED = {"uid", "resourceVersion", "managedFields", "ca.crt", "token",
           "generation"}
SORTED = {"addresses", "endpoints", "ownerReferences", "secrets"}
RANDOM = ((re.compile(r"-[0-9a-f]{5}-[0-9a-f]{5}(?![0-9a-z])"), "-*-*"),
          (re.compile(r"-[0-9a-f]{5}(?![0-9a-z-])"), "-*"),
          (re.compile(r"default-token-[0-9a-f]{6}"), "default-token-*"))


def normalize(o, key=None):
    """`o` without what a run chooses at random or by the clock: the keys
    of DROPPED and every key ending in Time or Timestamp, the random name
    suffixes of RANDOM in every string, and the order of the lists named
    in SORTED."""
    if isinstance(o, dict):
        return {k: normalize(v, k) for k, v in o.items()
                if k not in DROPPED and not k.endswith(("Time", "Timestamp"))}
    if isinstance(o, list):
        out = [normalize(v) for v in o]
        return sorted(out, key=json.dumps) if key in SORTED else out
    if isinstance(o, str):
        for pat, rep in RANDOM:
            o = pat.sub(rep, o)
    return o


def both(script, **kw):
    """The script's normalized end state in each package."""
    out = {}
    for pkg in PKGS:
        c = Cluster(pkg, **kw)
        try:
            script(c)
            c.settle()
            out[pkg] = c.state()
        finally:
            c.stop()
    return out


def assert_same(states):
    j, p = states[JAX], states[PORT]
    assert j.keys() == p.keys()
    for res in j:
        assert j[res] == p[res], res


def rollout_script(c):
    c.client.create("services", service("web"))
    c.client.create("deployments", workload("Deployment", "web", 3))
    c.drive()

    def edit(**spec):
        def patch(o):
            o["spec"].update(spec)
            return o
        c.client.guaranteed_update("deployments", "default", "web", patch)
        c.drive()
    edit(template=template("web", "img:v2"))
    edit(replicas=5)
    edit(replicas=2)


def test_deployment_and_service_plane_match():
    states = both(rollout_script)
    assert_same(states)
    rs = [json.loads(o) for o in states[PORT]["replicasets"]]
    hashes = {o["metadata"]["labels"]["pod-template-hash"] for o in rs}
    dep = m(PORT, "controllers.deployment")
    assert hashes == {dep.template_hash(template("web", image))
                      for image in ("img:v1", "img:v2")}
    gid = hashlib.sha256(repr((("http", 80, "TCP"),)).encode()).hexdigest()
    assert [json.loads(o)["metadata"]["name"]
            for o in states[PORT]["endpointslices"]] == [f"web-{gid[:8]}-0"]
    eps = json.loads(states[PORT]["endpoints"][0])
    assert len(eps["subsets"][0]["addresses"]) == 2


def gc_script(c):
    for policy in ("Foreground", "Background", "Orphan"):
        c.client.create("deployments", workload("Deployment", policy.lower(),
                                                2))
    c.drive()
    for policy in ("Foreground", "Background", "Orphan"):
        c.client.delete("deployments", "default", policy.lower(),
                        propagation_policy=policy)
        c.settle()


def test_garbage_collector_policies_match():
    states = both(gc_script)
    assert_same(states)
    rs = [json.loads(o) for o in states[PORT]["replicasets"]]
    assert [o["metadata"]["name"].split("-")[0] for o in rs] == ["orphan"]
    assert not rs[0]["metadata"].get("ownerReferences")
    pods = [json.loads(o)["metadata"]["name"] for o in states[PORT]["pods"]]
    assert len(pods) == 2 and all(p.startswith("orphan-") for p in pods)


def workloads_script(c):
    c.client.create("statefulsets", workload("StatefulSet", "db", 3,
                                             serviceName="db"))
    c.client.create("daemonsets", workload("DaemonSet", "agent"))
    job = obj("Job", "batch", spec={"completions": 3, "parallelism": 2,
                                    "template": template("batch")})
    job["apiVersion"] = "batch/v1"
    job["spec"]["template"]["spec"]["restartPolicy"] = "Never"
    c.client.create("jobs", job)
    c.drive()


def test_workload_controllers_match():
    states = both(workloads_script)
    assert_same(states)
    pods = [json.loads(o) for o in states[PORT]["pods"]]
    names = sorted(p["metadata"]["name"] for p in pods)
    assert [n for n in names if n.startswith("db-")] == \
        ["db-0", "db-1", "db-2"]
    assert sum(n.startswith("agent-") for n in names) == N_NODES
    assert sum(n.startswith("batch-") for n in names) == 3
    job = json.loads(states[PORT]["jobs"][0])
    assert job["status"]["succeeded"] == 3


def namespace_script(c, delete):
    c.client.create("namespaces", obj("Namespace", "team", None))
    quota = obj("ResourceQuota", "q", "team", spec={"hard": {
        "pods": "10", "requests.cpu": "2", "requests.memory": "4Gi"}})
    c.client.create("resourcequotas", quota)
    c.client.create("replicasets", workload("ReplicaSet", "app", 3, "team"))
    c.client.create("services", service("app", "team"))
    c.drive()
    if delete:
        c.client.delete("namespaces", None, "team")


def test_namespace_and_quota_match():
    states = both(lambda c: namespace_script(c, delete=False))
    assert_same(states)
    q = json.loads(states[PORT]["resourcequotas"][0])
    assert q["status"]["used"]["pods"] in ("3", 3)
    states = both(lambda c: namespace_script(c, delete=True))
    assert_same(states)
    for res in ("pods", "replicasets", "resourcequotas", "services",
                "endpoints", "endpointslices", "serviceaccounts"):
        assert not [o for o in states[PORT].get(res, ())
                    if json.loads(o)["metadata"].get("namespace") == "team"
                    ], res


def podgc_script(c):
    c.client.create("replicasets", workload("ReplicaSet", "app", 8))
    c.drive()
    c.mgr.controllers["replicaset"].stop()   # keep the victims' count
    meta = m(c.pkg, "api.meta")
    pods = sorted(c.client.list("pods")[0],
                  key=lambda p: int(meta.uid(p).rsplit("-", 1)[1], 16))
    for p in pods[:3]:
        def end(o):
            o["status"]["phase"] = "Succeeded"
            return o
        c.client.guaranteed_update("pods", "default", meta.name(p), end)
    c.client.delete("nodes", None, "n3")
    c.settle()
    gc = c.mgr.controllers["podgc"]
    gc.threshold = 1
    gc.gc_once()


def test_podgc_matches():
    states = both(podgc_script)
    assert_same(states)
    pods = [json.loads(o) for o in states[PORT]["pods"]]
    assert all(p["spec"]["nodeName"] != "n3" for p in pods)
    assert sum(p["status"]["phase"] == "Succeeded" for p in pods) == 1


def cronjob_script(c):
    cj = obj("CronJob", "tick", spec={
        "schedule": "*/2 * * * *", "concurrencyPolicy": "Forbid",
        "successfulJobsHistoryLimit": 2,
        "jobTemplate": {"spec": {"completions": 1,
                                 "template": template("tick")}}})
    cj["apiVersion"] = "batch/v1"
    c.client.create("cronjobs", cj)
    c.settle()
    cron = c.hand["cronjob"]
    for k in range(8):
        cron.reconcile_once(T0 + 60 * k)
        c.drive()


def test_cronjob_on_a_hand_clock_matches():
    states = both(cronjob_script, hand=("cronjob",))
    assert_same(states)
    # due every even minute: T0 + 60, 180, 300 and 420; the two newest
    # finished Jobs kept beside the last one
    jobs = sorted(json.loads(o)["metadata"]["name"]
                  for o in states[PORT]["jobs"])
    first = int(T0 // 60)
    assert jobs == [f"tick-{first + k}" for k in (3, 5, 7)]
    cj = m(PORT, "controllers.cronjob")
    assert cj.CronSchedule("*/2 * * * *").next_after(T0 + 300) == T0 + 420


def hpa_script(c):
    usage = {"metrics.kubernetes.io/cpu-usage": "180m"}
    dep = workload("Deployment", "web", 2)
    dep["spec"]["template"] = template("web", annotations=usage)
    c.client.create("deployments", dep)
    hpa = obj("HorizontalPodAutoscaler", "web", spec={
        "scaleTargetRef": {"kind": "Deployment", "name": "web",
                           "apiVersion": "apps/v1"},
        "minReplicas": 1, "maxReplicas": 6,
        "metrics": [{"type": "Resource", "resource": {
            "name": "cpu", "target": {"type": "Utilization",
                                      "averageUtilization": 60}}}]})
    hpa["apiVersion"] = "autoscaling/v2"
    c.client.create("horizontalpodautoscalers", hpa)
    c.drive()
    auto = c.hand["horizontalpodautoscaler"]
    for k in range(4):
        auto.reconcile_once(T0 + 15 * k)
        c.drive()


def test_hpa_on_a_hand_clock_matches():
    states = both(hpa_script, hand=("horizontalpodautoscaler",))
    assert_same(states)
    dep = json.loads(states[PORT]["deployments"][0])
    assert dep["spec"]["replicas"] == 6


def lifecycle_script(c, monkeypatch):
    mod = m(c.pkg, "controllers.nodelifecycle")
    now = [T0]
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(
        time=lambda: now[0]))
    for i, renew in ((0, T0), (1, T0 - 100)):
        lease = obj("Lease", f"n{i}", "kube-node-lease",
                    spec={"holderIdentity": f"n{i}", "renewTime": renew,
                          "leaseDurationSeconds": 40})
        c.client.create("leases", lease)
    c.client.create("replicasets", workload("ReplicaSet", "app", 4))
    c.drive()
    c.mgr.controllers["replicaset"].stop()   # keep the evictions visible
    life = c.hand["nodelifecycle"]
    now[0] = T0 + 10
    life._monitor()
    c.settle()
    c.client.guaranteed_update(
        "leases", "kube-node-lease", "n1",
        lambda o: {**o, "spec": {**o["spec"], "renewTime": T0 + 20}})
    c.settle()
    now[0] = T0 + 30
    life._monitor()


def test_node_lifecycle_on_a_hand_clock_matches(monkeypatch):
    states = both(lambda c: lifecycle_script(c, monkeypatch),
                  hand=("nodelifecycle",))
    assert_same(states)
    pods = [json.loads(o) for o in states[PORT]["pods"]]
    assert len(pods) == 3 and all(p["spec"]["nodeName"] != "n1"
                                  for p in pods)
    n1 = next(json.loads(o) for o in states[PORT]["nodes"]
              if json.loads(o)["metadata"]["name"] == "n1")
    assert not n1["spec"].get("taints")


# -- (c) R15: the whole-count surge -----------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_r15_an_update_surges_the_whole_replica_count(pkg):
    c = Cluster(pkg)
    try:
        c.client.create("deployments", workload("Deployment", "web", 4))
        c.drive()

        def v2(o):
            o["spec"]["template"] = template("web", "img:v2")
            return o
        c.client.guaranteed_update("deployments", "default", "web", v2)
        c.settle()   # the new pods stay pending: no kubelet runs them
        rs = {o["metadata"]["labels"]["pod-template-hash"]: o["spec"]
              ["replicas"] for o in c.client.list("replicasets")[0]}
        dep = m(pkg, "controllers.deployment")
        assert rs == {dep.template_hash(template("web")): 4,
                      dep.template_hash(template("web", "img:v2")): 4}
        assert len(c.client.list("pods")[0]) == 8
        c.run_pods()
        assert wait_for(lambda: sorted(
            o["spec"]["replicas"] for o in c.client.list("replicasets")[0])
            == [0, 4], timeout=30)
    finally:
        c.stop()


# -- (d) R16: a sync that lists before it checks its expectations -----------

@pytest.mark.parametrize("pkg", PKGS)
def test_r16_replicaset_lists_pods_before_its_expectations(pkg):
    """The ReplicaSet controller lists its pods from the informer first
    and asks its expectations second: creations the informer delivers
    between the two satisfy the expectations while the list misses them,
    so the sync creates the whole count again (upstream asks first)."""
    store = m(pkg, "store.kv").MemoryStore()
    client_mod = m(pkg, "client")
    client = client_mod.LocalClient(store)
    factory = client_mod.SharedInformerFactory(client)
    rsc = m(pkg, "controllers.replicaset").ReplicaSetController(
        client, factory)
    factory.start()
    try:
        factory.wait_for_cache_sync()
        client.create("replicasets", workload("ReplicaSet", "app", 3))
        assert wait_for(lambda: rsc.rs_informer.get("default", "app"),
                        timeout=10)
        factory.stop()   # from here on the informers deliver nothing
        rsc.sync("default/app")
        assert len(client.list("pods")[0]) == 3
        assert not rsc.expectations.satisfied("default/app")

        def lagging(ns=None):
            # the list misses the three creations, whose ADDED events
            # arrive just after it
            for _ in range(3):
                rsc.expectations.creation_observed("default/app")
            return []
        rsc.pod_informer.list = lagging
        rsc.sync("default/app")
        assert len(client.list("pods")[0]) == 6
    finally:
        factory.stop()
