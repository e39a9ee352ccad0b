"""The process supervisor's import rule and bench.py's --processes row in
the port.

  * kubernetes_tpu_torch.scheduler.procrun, ops/faults.py's process-true
    churner and upgrade pair and perf/bench.py import and build with jax
    and kubernetes_tpu unimportable, and the argv the supervisor builds
    names no module of the JAX package (the import scan of
    tests/test_torch_import.py covers every port file, these among them);
  * the port's run_scaleout_proc passes what bench.py's does at its
    defaults, both run with the supervisor, the ledger, make_node,
    make_pod and the bench module's sleep replaced by recorders; and
    `--processes N` prints bench.py's row and fails its exit code on a
    double bind or a pod lost across the crash.
"""

import importlib
import json
import pathlib
import subprocess
import sys
import time

import pytest

from kubernetes_tpu_torch.perf import bench
from torch_cases import _SpecRecorder

ROOT = pathlib.Path(__file__).resolve().parent.parent

_BLOCKED_RUN = r"""
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "kubernetes_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import kubernetes_tpu_torch.perf.bench
from kubernetes_tpu_torch.client import LocalClient
from kubernetes_tpu_torch.ops.faults import (
    ProcessChurner, ScaleOutSchedule, UpgradeDriver, UpgradeSchedule)
from kubernetes_tpu_torch.scheduler.procrun import (
    ProcCluster, WireBindLedger)
from kubernetes_tpu_torch.store import kv

cluster = ProcCluster(2, backend="tpu", device="cpu")
cluster.url, cluster.token, cluster._api_port = "http://x:1", "t", 1
argv = cluster.child_argv(0) + cluster.apiserver_argv()
assert not any(a.startswith("kubernetes_tpu.") for a in argv), argv
assert UpgradeDriver(cluster, UpgradeSchedule()).steps == 0
assert ProcessChurner(cluster, ScaleOutSchedule()).waves == 0
assert WireBindLedger(LocalClient(kv.MemoryStore())).bound_total() == 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "kubernetes_tpu"))
assert not bad, bad
print("OK")
"""


def test_supervisor_imports_and_builds_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("OK"), proc.stdout


def test_the_import_scan_covers_the_supervisor():
    """tests/test_torch_import.py scans every .py file under the port;
    the supervisor's modules are among them."""
    scanned = {str(p.relative_to(ROOT)) for p in
               (ROOT / "kubernetes_tpu_torch").rglob("*.py")}
    for name in ("scheduler/procrun", "ops/faults", "perf/bench"):
        assert f"kubernetes_tpu_torch/{name}.py" in scanned, name


@pytest.fixture(scope="module")
def jax_bench():
    pytest.importorskip("jax")
    sys.path.insert(0, str(ROOT))
    try:
        import bench as jax_bench_mod
    finally:
        sys.path.remove(str(ROOT))
    return jax_bench_mod


def record_scaleout_proc(monkeypatch, pkg, bench_mod, run):
    """Call `run()` (bench.py's run_scaleout_proc or the port's) with
    `pkg`'s ProcCluster, WireBindLedger, make_node, make_pod and the bench
    module's sleep replaced by recorders: no process starts; every pod
    created is bound at once.  Returns (what run() returned, the record):
    each pass's ProcCluster arguments, the children it killed, the
    sleeps, and the sizes of the node and pod chunks with their specs."""
    def m(name):
        return importlib.import_module(f"{pkg}.{name}")
    rec = {"clusters": [], "kills": [], "sleeps": [], "nodes": [],
           "pods": [], "node_spec": set(), "pod_spec": set()}

    class Admin:
        def create_bulk(self, resource, objs):
            rec[resource].append(len(objs))

    class Cluster:
        def __init__(self, n, **kw):
            rec["clusters"].append((n, kw))
            self.n, self.live = n, set(range(n))

        def start(self):
            return self

        def admin_client(self):
            return Admin()

        def metrics_texts(self):
            return []

        def alive(self, index):
            return index in self.live

        def live_indices(self):
            return sorted(self.live)

        def kill(self, index):
            rec["kills"].append((self.n, index))
            self.live.discard(index)

        def shutdown(self):
            pass

    class Ledger:
        def __init__(self, client):
            pass

        def bound_total(self):
            return sum(rec["pods"])

        def assert_no_double_binds(self):
            pass

        def stop(self):
            pass

    class Clock:
        monotonic = staticmethod(time.monotonic)

        @staticmethod
        def sleep(s):
            rec["sleeps"].append(s)

    monkeypatch.setattr(m("scheduler.procrun"), "ProcCluster", Cluster)
    monkeypatch.setattr(m("scheduler.procrun"), "WireBindLedger", Ledger)
    for name in ("make_node", "make_pod"):
        monkeypatch.setattr(m("testing"), name,
                            lambda *a, **_k: _SpecRecorder(rec, *a))
    monkeypatch.setattr(bench_mod, "time", Clock)
    return run(), rec


def test_processes_run_passes_bench_py_parameters(jax_bench, monkeypatch):
    """The port's run_scaleout_proc passes what bench.py's does at its
    defaults (BENCH_SCALEOUT_* unset): each pass's ProcCluster arguments
    (the null device), the replication sleep, the node and pod chunks and
    specs, the crash sub-pass's kill of child 0 above one process and its
    extra pods, and the counts 1, 2, 4 and N; the port's cluster also
    takes device and child_env, None here.  The rows' keys and counts are
    bench.py's."""
    for var in ("NODES", "PODS", "BATCH", "TIMEOUT"):
        monkeypatch.delenv(f"BENCH_SCALEOUT_{var}", raising=False)
    theirs, jrec = record_scaleout_proc(
        monkeypatch, "kubernetes_tpu", jax_bench,
        lambda: jax_bench.run_scaleout_proc(5))
    ours, prec = record_scaleout_proc(
        monkeypatch, "kubernetes_tpu_torch", bench,
        lambda: bench.run_scaleout_proc(5))
    for _n, kw in prec["clusters"]:
        assert kw.pop("device") is None and kw.pop("child_env") is None
    assert prec == jrec
    assert list(ours["BENCH_SCALEOUT_PROC"]) == \
        list(theirs["BENCH_SCALEOUT_PROC"]) == ["1", "2", "4", "5"]
    assert {k: v for k, v in ours.items() if k != "BENCH_SCALEOUT_PROC"} \
        == {k: v for k, v in theirs.items() if k != "BENCH_SCALEOUT_PROC"}
    for n, row in theirs["BENCH_SCALEOUT_PROC"].items():
        mine = ours["BENCH_SCALEOUT_PROC"][n]
        assert sorted(mine) == sorted(row)
        for key in ("bound", "double_binds", "conflicts", "conflict_rate"):
            assert mine[key] == row[key]
        if "churn" in row:
            assert {k: v for k, v in mine["churn"].items() if k != "wall_s"} \
                == {k: v for k, v in row["churn"].items() if k != "wall_s"}
    assert (ours["nodes"], ours["pods"], ours["batch"]) == (
        20_000, 60_000, 4096)
    assert prec["clusters"][0] == (1, {"backend": "null", "batch_size": 4096,
                                       "nodes": 20_000})
    assert prec["kills"] == [(2, 0), (4, 0), (5, 0)]
    assert prec["sleeps"] == [3.0] * 4
    assert set(prec["nodes"]) == {10_000} and len(prec["nodes"]) == 8
    assert prec["pods"] == [10_000] * 6 + ([10_000] * 6 + [3000]) * 3


def test_processes_cli_prints_one_row(monkeypatch, capsys):
    """--processes N runs run_scaleout_proc with --nodes/--pods/--batch
    and prints bench.py's row; a pass with a pod lost across its crash
    fails the exit code."""
    seen = {}

    def run_scaleout_proc(n, nodes, pods, batch):
        seen.update(n=n, nodes=nodes, pods=pods, batch=batch)
        return {"nodes": 7, "pods": 9, "batch": 3, "BENCH_SCALEOUT_PROC": {
            "1": {"pods_per_s": 5.0, "double_binds": 0},
            "2": {"pods_per_s": 8.0, "double_binds": 0,
                  "churn": {"zero_lost": seen.get("lost", True),
                            "double_binds": 0}}}}
    monkeypatch.setattr(bench, "run_scaleout_proc", run_scaleout_proc)
    assert bench.main(["--processes", "2", "--nodes", "7", "--pods",
                       "9"]) == 0
    assert seen == {"n": 2, "nodes": 7, "pods": 9, "batch": None}
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["value"] == 8.0 and out["detail"]["mode"] == "scaleout-proc"
    seen["lost"] = False
    assert bench.main(["--processes"]) == 1 and seen["n"] == 2
