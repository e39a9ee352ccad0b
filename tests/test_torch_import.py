"""kubernetes_tpu_torch stands alone: it imports and runs a CPU step (and
a sharded one, on a mesh of CPU shards, and the entry point's snapshot
step, and builds scale-out coordinators and steps a churner, and takes a
Lease with the scheduler binary's elector and compares a cache with its
debugger) with jax and
kubernetes_tpu unimportable, and no module of it (nor
chip_smoke.py) names either in an import statement."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

_BLOCKED_RUN = r"""
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "kubernetes_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import kubernetes_tpu_torch
from kubernetes_tpu_torch.ops.backend import TorchBatchBackend
from kubernetes_tpu_torch.ops.flatten import Caps
from kubernetes_tpu_torch.scheduler.cache import Cache
from kubernetes_tpu_torch.scheduler.types import PodInfo
from kubernetes_tpu_torch.testing import make_node, make_pod

cache = Cache()
for i in range(3):
    cache.add_node(make_node(f"n{i}").capacity(cpu="2", mem="4Gi").build())
backend = TorchBatchBackend(Caps(n_cap=16, l_cap=16, kl_cap=8, t_cap=4,
                                 pt_cap=4, s_cap=1, sg_cap=2, asg_cap=2),
                            batch_size=4, device="cpu")
pods = [PodInfo(make_pod(f"p{i}").req(cpu="500m", mem="1Gi").build())
        for i in range(4)]
out = backend.assign(pods, cache.flatten_view())
assert all(name for name, _ in out), out
from kubernetes_tpu_torch.parallel.backend import ShardedTorchBatchBackend
from kubernetes_tpu_torch.parallel.mesh import make_mesh
import kubernetes_tpu_torch.parallel.census
sharded = ShardedTorchBatchBackend(
    Caps(n_cap=16, l_cap=16, kl_cap=8, t_cap=4, pt_cap=4, s_cap=1, sg_cap=2,
         asg_cap=2), batch_size=4, mesh=make_mesh("cpu", shards=4))
cache = Cache()
for i in range(3):
    cache.add_node(make_node(f"n{i}").capacity(cpu="2", mem="4Gi").build())
out = sharded.assign(pods, cache.flatten_view())
assert all(name for name, _ in out), out
from kubernetes_tpu_torch.entry import entry
fn, args = entry(device="cpu")
assert (fn(*args)["assignments"] >= 0).all()
from kubernetes_tpu_torch.ops.faults import InstanceChurner, ScaleOutSchedule
from kubernetes_tpu_torch.scheduler.config import ScaleOutPolicy
from kubernetes_tpu_torch.scheduler.scaleout import ScaleOutCoordinator
cos = [ScaleOutCoordinator(ScaleOutPolicy(instance_count=2,
                                          instance_index=i))
       for i in range(2)]
assert sum(c.owns_node("n0") for c in cos) == 1
InstanceChurner(cos, ScaleOutSchedule(instance_count=2)).step()
import kubernetes_tpu_torch.cmd.scheduler
from kubernetes_tpu_torch.client import LocalClient, SharedInformerFactory
from kubernetes_tpu_torch.client.leaderelection import LeaderElector
from kubernetes_tpu_torch.scheduler import (
    Profile, Scheduler, new_default_framework)
from kubernetes_tpu_torch.scheduler.debugger import CacheDebugger
from kubernetes_tpu_torch.store import kv
lc = LocalClient(kv.MemoryStore())
assert LeaderElector(lc, "lock", identity="x")._try_acquire_or_renew()
factory = SharedInformerFactory(lc)
sched = Scheduler(lc, factory,
                  {"default-scheduler": Profile(new_default_framework(
                      lc, factory))})
diff = CacheDebugger(sched, lc).compare()
assert not any(v for side in diff.values() for v in side.values()), diff
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "kubernetes_tpu"))
assert not bad, bad
print("OK", [name for name, _ in out])
"""


def test_imports_and_steps_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("OK"), proc.stdout


_BLOCKED_YAML = r"""
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "kubernetes_tpu", "yaml"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import kubernetes_tpu_torch.client
import kubernetes_tpu_torch.perf.bench
import kubernetes_tpu_torch.scheduler
import kubernetes_tpu_torch.apiserver
import kubernetes_tpu_torch.apiserver.aggregator
import kubernetes_tpu_torch.apiserver.discovery
import kubernetes_tpu_torch.client.http_client
import kubernetes_tpu_torch.cmd.apiserver
import kubernetes_tpu_torch.store.encryption
from kubernetes_tpu_torch.apiserver import APIServer
from kubernetes_tpu_torch.client.http_client import HTTPClient
from kubernetes_tpu_torch.store import kv

server = APIServer(kv.MemoryStore(), token="t").start()
try:
    client = HTTPClient.from_url(server.url, token="t")
    assert client._request("GET", "/version")["platform"] == "gpu"
    client.create("pods", {"apiVersion": "v1", "kind": "Pod",
                           "metadata": {"name": "p", "namespace": "default"},
                           "spec": {"containers": [{"name": "c"}]}})
    assert len(client.list("pods")[0]) == 1
    client.close()
finally:
    server.stop()
from kubernetes_tpu_torch.perf import load_workloads
from kubernetes_tpu_torch.scheduler.config import load_config

names = load_workloads()
assert "SchedulingBasicLarge" in names and len(names) > 20, sorted(names)
assert load_config({"backend": {"kind": "tpu"}}).backend.kind == "tpu"
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "kubernetes_tpu", "yaml"))
assert not bad, bad
print("OK", len(names))
"""


def test_scheduler_and_perf_import_with_yaml_blocked():
    """The card machine has no PyYAML: the port's scheduler, client and
    perf harness import and read the workloads without it, and its
    apiserver serves and its HTTPClient talks to it."""
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_YAML], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("OK"), proc.stdout


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    [*(ROOT / "kubernetes_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py"]
    if "_build" not in p.parts))
def test_no_jax_or_reference_import(path):
    roots = _imported_roots(ROOT / path)
    assert not roots & {"jax", "jaxlib", "kubernetes_tpu"}, (path, roots)


def test_the_scan_covers_the_sharded_path():
    scanned = {str(p.relative_to(ROOT)) for p in
               (ROOT / "kubernetes_tpu_torch").rglob("*.py")}
    for name in ("__init__", "mesh", "census", "backend"):
        assert f"kubernetes_tpu_torch/parallel/{name}.py" in scanned


FRONT_DOOR = ("api/fields", "api/core_versions", "store/encryption",
              *(f"apiserver/{m}" for m in (
                  "__init__", "patch", "managedfields", "egress", "audit",
                  "authn", "rbac", "flowcontrol", "cel", "crd", "admission",
                  "aggregator", "openapi_schemas", "discovery", "server")),
              "client/http_client", "cmd/apiserver")


def test_the_scan_covers_the_front_door():
    scanned = {str(p.relative_to(ROOT)) for p in
               (ROOT / "kubernetes_tpu_torch").rglob("*.py")}
    for name in FRONT_DOOR:
        assert f"kubernetes_tpu_torch/{name}.py" in scanned, name


SCALE_OUT = ("scheduler/scaleout", "ops/faults", "perf/bench")


def test_the_scan_covers_the_scale_out():
    scanned = {str(p.relative_to(ROOT)) for p in
               (ROOT / "kubernetes_tpu_torch").rglob("*.py")}
    for name in SCALE_OUT:
        assert f"kubernetes_tpu_torch/{name}.py" in scanned, name


BINARY = ("cmd/scheduler", "client/leaderelection", "scheduler/debugger",
          "scheduler/config")


def test_the_scan_covers_the_binary():
    scanned = {str(p.relative_to(ROOT)) for p in
               (ROOT / "kubernetes_tpu_torch").rglob("*.py")}
    for name in BINARY:
        assert f"kubernetes_tpu_torch/{name}.py" in scanned, name


KUBELET = (*(f"kubelet/{m}" for m in (
    "__init__", "qos", "checkpoint", "cri", "images", "pod_workers",
    "probes", "status_manager", "eviction", "cm", "streams", "server",
    "hollow", "kubelet")), "cmd/kubelet")


def test_the_scan_covers_the_kubelet():
    scanned = {str(p.relative_to(ROOT)) for p in
               (ROOT / "kubernetes_tpu_torch").rglob("*.py")}
    for name in KUBELET:
        assert f"kubernetes_tpu_torch/{name}.py" in scanned, name


_BLOCKED_KUBELET = r"""
import sys, tempfile, time

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "kubernetes_tpu", "yaml"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import kubernetes_tpu_torch.cmd.kubelet
from kubernetes_tpu_torch.api import meta
from kubernetes_tpu_torch.client import LocalClient, SharedInformerFactory
from kubernetes_tpu_torch.kubelet import KubeletServer, start_hollow_nodes
from kubernetes_tpu_torch.kubelet.cm import ContainerManager
from kubernetes_tpu_torch.kubelet.kubelet import Kubelet
from kubernetes_tpu_torch.store import kv

client = LocalClient(kv.MemoryStore())
factory = SharedInformerFactory(client)
factory.start()
factory.wait_for_cache_sync()
server = KubeletServer().start()
kubelets = start_hollow_nodes(client, factory, 2, kubelet_server=server,
                              heartbeat_interval=3600)
kubelets.append(Kubelet(client, factory, "full-0",
                        root_dir=tempfile.mkdtemp(),
                        heartbeat_interval=3600).start())
ContainerManager().admit_pod({"metadata": {"uid": "u"}, "spec": {}})
for node in ("hollow-1", "full-0"):
    pod = meta.new_object("Pod", "p-" + node, "default")
    pod["spec"] = {"nodeName": node, "containers": [{"name": "c0"}]}
    client.create("pods", pod)
for _ in range(500):
    phases = [(p.get("status") or {}).get("phase")
              for p in client.list("pods")[0]]
    if phases == ["Running", "Running"]:
        break
    time.sleep(0.01)
assert phases == ["Running", "Running"], phases
for k in kubelets:
    k.stop()
server.stop()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "kubernetes_tpu", "yaml"))
assert not bad, bad
print("OK")
"""


def test_kubelet_runs_with_jax_blocked():
    """The node agent imports and runs hollow nodes, a full kubelet and
    the container manager with jax, the JAX package and PyYAML
    unimportable (the card machine has no jax)."""
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_KUBELET], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("OK"), proc.stdout


def test_default_device_without_gpu_raises():
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from kubernetes_tpu_torch.ops.backend import TorchBatchBackend
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchBatchBackend()


CONTROLLERS = (*(f"controllers/{p.stem}" for p in sorted(
    (ROOT / "kubernetes_tpu" / "controllers").glob("*.py"))), "cmd/cluster")


def test_the_scan_covers_the_controllers():
    scanned = {str(p.relative_to(ROOT)) for p in
               (ROOT / "kubernetes_tpu_torch").rglob("*.py")}
    assert len(CONTROLLERS) == 32
    for name in CONTROLLERS:
        assert f"kubernetes_tpu_torch/{name}.py" in scanned, name


_BLOCKED_CONTROLLERS = r"""
import importlib, pkgutil, sys, time

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "kubernetes_tpu", "yaml"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import kubernetes_tpu_torch.cmd.cluster
import kubernetes_tpu_torch.controllers as controllers
for mod in pkgutil.iter_modules(controllers.__path__):
    importlib.import_module("kubernetes_tpu_torch.controllers." + mod.name)
from kubernetes_tpu_torch.client import LocalClient, SharedInformerFactory
from kubernetes_tpu_torch.controllers import ControllerManager
from kubernetes_tpu_torch.controllers.endpoints import EndpointsController
from kubernetes_tpu_torch.store import kv

client = LocalClient(kv.MemoryStore())
factory = SharedInformerFactory(client)
mgr = ControllerManager(client, factory)
endpoints = EndpointsController(client, factory)
factory.start()
factory.wait_for_cache_sync()
mgr.run()
endpoints.run()
rs = {"apiVersion": "apps/v1", "kind": "ReplicaSet",
      "metadata": {"name": "r", "namespace": "default"},
      "spec": {"replicas": 2, "selector": {"matchLabels": {"app": "r"}},
               "template": {"metadata": {"labels": {"app": "r"}},
                            "spec": {"containers": [{"name": "c0"}]}}}}
client.create("replicasets", rs)
for _ in range(500):
    if len(client.list("pods")[0]) == 2:
        break
    time.sleep(0.01)
assert len(client.list("pods")[0]) == 2
endpoints.stop()
mgr.stop()
factory.stop()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "kubernetes_tpu", "yaml"))
assert not bad, bad
print("OK", len(mgr.controllers))
"""


def test_controllers_run_with_jax_blocked():
    """The controller manager, every controller module and the cluster
    binary import, and a ReplicaSet gets its pods, with jax, the JAX
    package and PyYAML unimportable (the card machine has no jax)."""
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_CONTROLLERS],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("OK"), proc.stdout
