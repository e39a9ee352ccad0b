"""kubernetes_tpu_torch stands alone: it imports and runs a CPU step (and
a sharded one, on a mesh of CPU shards, and the entry point's snapshot
step) with jax and kubernetes_tpu unimportable, and no module of it (nor
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


def test_default_device_without_gpu_raises():
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from kubernetes_tpu_torch.ops.backend import TorchBatchBackend
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchBatchBackend()
