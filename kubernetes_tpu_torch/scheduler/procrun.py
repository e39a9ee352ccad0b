"""Process-true scale-out: supervisor for N scheduler OS processes.

A copy of kubernetes_tpu/scheduler/procrun.py (host code, its logic
unchanged) but for what the children run on.  The supervisor spawns the
port's own modules: `python -m kubernetes_tpu_torch.cmd.apiserver` and
`python -m kubernetes_tpu_torch.scheduler.procrun --child`.  A child
whose backend is `tpu` or `sharded` runs its batch backend on --device
(CUDA unless the supervisor names another, as ProcCluster(device=...)
does): without a GPU such a child exits non-zero with
device.resolve_device's message instead of carrying on on the CPU.  A
`none` or `null` child never touches a device.  Where the JAX package's
supervisor sets JAX_PLATFORMS=cpu for its host-only children, this one
sets nothing.  The child_entry class attribute is the argv head that
starts a child; a harness that wraps the child points it elsewhere.  The
random token goes on a command line as --token=TOKEN, where the JAX
package writes --token TOKEN: one token in 64 starts with "-", which
argparse would take for an option.

Reference analog: cmd/kube-scheduler as a separate binary per replica with
--leader-elect=false (the Omega-style multi-scheduler deployment), plus
test/integration/util's StartApiserver — separate processes wired only
through the apiserver, never through shared memory.

In one interpreter (scheduler/scaleout.py, perf.bench --instances) the
GIL serializes the instances' host work.  This module makes the topology
process-true:

  ProcCluster   spawns the apiserver process plus N scheduler children,
                each a FULL scheduler: its own informers over HTTP, its
                own backend, its own Lease — configured purely through
                the existing `scaleOut:` stanza.  Readiness is a stdout
                handshake (KTPU_SCHED_READY line) + a per-child /readyz
                (503 while draining or lease-fenced); /healthz is pure
                process liveness.  rolling_restart() composes drain/
                respawn/readiness into the zero-downtime upgrade.
  child_main    the child entrypoint: SIGTERM triggers a graceful drain
                (retire the lease -> fence binds -> flush/requeue ->
                exit 0); SIGKILL is the crash path the churn chaos uses
                (ops/faults.ProcessChurner).
  WireBindLedger  the cross-process double-bind detector: tails the
                apiserver's pod watch from rv=0 and records every
                nodeName a pod key has EVER carried.

perf.bench --processes N drives ProcCluster and federates the children's
/metrics text (component_base/profiling.federate_texts) into one
BENCH_SCALEOUT_PROC row.
"""

from __future__ import annotations

import argparse
import http.server
import logging
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

logger = logging.getLogger(__name__)

READY_PREFIX = "KTPU_SCHED_READY"
# the kinds whose backend runs on a torch device (--device)
DEVICE_BACKENDS = ("tpu", "sharded")
_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", ".."))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# -- child ----------------------------------------------------------------


class _ChildHTTP(http.server.BaseHTTPRequestHandler):
    """Per-child observability endpoint: /metrics (Prometheus text the
    supervisor federates), /healthz (pure liveness: the process is up
    and serving — restart probes key off this) and /readyz (readiness:
    503 while draining or lease-fenced, so a rolling upgrade skips the
    instance without a liveness probe killing it mid-drain)."""

    sched = None  # class attribute, set per server instance below

    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler contract
        sched = self.server.sched  # type: ignore[attr-defined]
        if self.path == "/metrics":
            body = sched.expose_metrics().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
        elif self.path == "/healthz":
            body = b"ok"
            self.send_response(200)
            self.send_header("Content-Type", "text/plain")
        elif self.path.startswith("/debug/timeline"):
            # per-child wave timeline (the supervisor federates these);
            # ?format=chrome serves a Perfetto-loadable trace
            import json as _json

            from ..component_base import timeline as cb_timeline
            tl = cb_timeline.default_timeline
            body = (_json.dumps(tl.to_chrome_trace())
                    if "chrome" in self.path
                    else tl.debug_json()).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
        elif self.path == "/readyz":
            so = sched.scaleout
            draining = getattr(self.server, "draining", False)
            fenced = so is not None and not so.self_live
            ok = not draining and not fenced
            body = (b"ok" if ok
                    else b"draining" if draining else b"fenced")
            self.send_response(200 if ok else 503)
            self.send_header("Content-Type", "text/plain")
            # engagement posture rides a header, not the body: probes
            # and the rolling upgrade pin the (status, body) contract
            self.send_header("X-Overload-Engagement",
                             getattr(sched, "overload_engagement", "off"))
        else:
            body = b"not found"
            self.send_response(404)
            self.send_header("Content-Type", "text/plain")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):  # pragma: no cover - silence per-request spam
        pass


def _install_race_probes(client) -> None:
    """Test-only bind shims, armed by env (see tests/test_torch_procrun.py,
    the cross-process conflict taxonomy):

      KTPU_PROC_BIND_HOLD=<seconds>  delay this child's FIRST bind write,
          opening a compute-before-peer-commit / commit-after window.
      KTPU_PROC_BIND_DIVERT=<node>   rewrite this child's FIRST bind to
          <node> — the peer acting on a divergent partition view.

    Both wrap the live HTTP client, so the raced commit still travels the
    real wire path: bulk 409 rehydration, conflict re-fetch, taxonomy."""
    hold = float(os.environ.get("KTPU_PROC_BIND_HOLD", "0") or 0)
    divert = os.environ.get("KTPU_PROC_BIND_DIVERT", "")
    if not hold and not divert:
        return
    fired: list[bool] = []
    real_bind, real_bind_many = client.bind, client.bind_many

    def bind(pod, node_name, expect_rv=None):
        if not fired:
            fired.append(True)
            if hold:
                time.sleep(hold)
            if divert:
                node_name = divert
        return real_bind(pod, node_name, expect_rv)

    def bind_many(bindings):
        if not fired:
            fired.append(True)
            if hold:
                time.sleep(hold)
            if divert:
                bindings = [(b[0], b[1], divert, *b[3:]) for b in bindings]
        return real_bind_many(bindings)

    client.bind, client.bind_many = bind, bind_many


def child_main(args) -> int:
    """One scheduler instance as an OS process.  Everything it knows
    about the topology comes from the scaleOut: stanza; everything it
    knows about the cluster comes over the wire.

    Zero-downtime hooks: --warm-dir arms checkpointed warm-start (load
    the mirror checkpoint + prime the informers at its resourceVersions
    on boot; write a fresh checkpoint on SIGTERM drain), --config names
    a KubeSchedulerConfiguration whose DYNAMIC stanzas apply at boot and
    re-apply on SIGHUP (Scheduler.reload_config: invalid files are
    rejected with the old config kept live).

    --device names the torch device of a `tpu` or `sharded` backend; it
    is resolved before the child connects, and a device that is not
    there ends the child non-zero with resolve_device's message."""
    from ..client.clientset import NODES, PODS
    from ..client.http_client import HTTPClient
    from ..client.informer import SharedInformerFactory
    from .config import load_config, scheduler_from_config

    logging.basicConfig(
        level=logging.INFO,
        format=f"sched[{args.instance_index}] %(levelname)s %(message)s")
    device = None
    if args.backend in DEVICE_BACKENDS:
        from ..device import resolve_device
        try:
            device = resolve_device(args.device)
        except RuntimeError as e:
            raise SystemExit(f"ktpu-procrun: {e}") from None
    client = HTTPClient.from_url(args.server, token=args.token or None)
    _install_race_probes(client)
    factory = SharedInformerFactory(client)
    stanza: dict = {"kind": "KubeSchedulerConfiguration",
                    "backend": {"kind": args.backend
                                if args.backend != "none" else "null",
                                "batchSize": args.batch_size}}
    if os.environ.get("KTPU_PROC_TIMELINE") == "1":
        # arm the wave-timeline ring in every child (the supervisor's
        # federated_timeline()/supervisor_metrics_text() read it back
        # over /debug/timeline) — same stanza path a --config file uses
        stanza["profiling"] = {"timeline": True}
    if args.instance_count > 1:
        stanza["scaleOut"] = {
            "instanceCount": args.instance_count,
            "instanceIndex": args.instance_index,
            "ringSlices": max(64, 16 * args.instance_count),
            "leaseDurationSeconds": args.lease_duration,
            "renewIntervalSeconds": args.renew_interval,
        }
    sched = scheduler_from_config(client, factory, load_config(stanza))
    backend = None
    if args.backend != "none":
        # the harness half of the backend: stanza contract — construct
        # the device backend the config named and hang it on the profile
        from ..ops.backend import make_batch_backend
        from ..perf import caps_for_nodes
        backend = make_batch_backend(sched.backend_policy.kind,
                                     caps_for_nodes(max(args.nodes, 256)),
                                     batch_size=args.batch_size,
                                     device=device)
        backend.warmup()
        profile = next(iter(sched.profiles.values()))
        profile.batch_backend = backend
        profile.batch_size = args.batch_size
        sched.pipeline_depth = 2
    if args.config:
        # boot-time config: same validation as the SIGHUP path; a bad
        # file fails the boot loudly instead of running half-configured
        sched.reload_config(args.config)

    # checkpointed warm-start: install the mirror BEFORE informers start
    # so the primed replay's events land on adoption-pending rows
    warm_path = None
    if args.warm_dir and backend is not None \
            and hasattr(backend, "warm_start"):
        from ..ops.backend import CheckpointError
        warm_path = os.path.join(args.warm_dir,
                                 f"sched-{args.instance_index}.ckpt")
        if os.path.exists(warm_path):
            try:
                warm = backend.warm_start(warm_path)
            except CheckpointError as e:
                logger.warning("checkpoint %s rejected (%s); cold start",
                               warm_path, e)
            else:
                objs = warm.get("objects") or {}
                rvs = warm.get("resource_versions") or {}
                for res in (NODES, PODS):
                    if res in objs and res in rvs:
                        factory.informer(res).prime(objs[res], rvs[res])
                logger.info("warm start: %d rows pending adoption from %s",
                            warm["nodes"], warm_path)

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _ChildHTTP)
    server.sched = sched  # type: ignore[attr-defined]
    server.draining = False  # type: ignore[attr-defined]
    threading.Thread(target=server.serve_forever,
                     name="child-metrics", daemon=True).start()

    stop = threading.Event()
    reload_req = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    signal.signal(signal.SIGHUP, lambda *a: reload_req.set())

    factory.start()
    if not factory.wait_for_cache_sync(60.0):
        logger.error("cache sync timed out; exiting")
        return 1
    if backend is not None and hasattr(backend, "warm_align"):
        # sweep any rows the primed replay's bulk path did not visit
        # (adopt current ones, drop rows whose node died while we were
        # down) so the first wave starts from a fully-reconciled mirror
        backend.warm_align(sched.cache.flatten_view())
    sched.run()
    # readiness handshake: the supervisor tails our stdout for this line
    print(f"{READY_PREFIX} index={args.instance_index} pid={os.getpid()} "
          f"metrics_port={server.server_address[1]}", flush=True)

    while not stop.wait(0.2):
        if reload_req.is_set():
            reload_req.clear()
            if not args.config:
                logger.warning("SIGHUP ignored: no --config file to reload")
                continue
            try:
                outcome = sched.reload_config(args.config)
            except Exception as e:  # noqa: BLE001 - keep old config live
                logger.warning("config reload rejected: %s", e)
            else:
                logger.info("config reloaded: %s", outcome)
    # graceful drain (SIGTERM): fail readiness, then retire the lease
    # FIRST so the bind fence rejects any wave still in flight (nothing
    # new reaches the store), then stop the loop — its shutdown path
    # flushes/requeues in-flight work so peers absorbing our partition
    # find every pod in the store.
    server.draining = True  # type: ignore[attr-defined]
    if sched.scaleout is not None:
        sched.scaleout.retire()
    sched.stop()
    if warm_path is not None:
        # the loop is quiesced and the informers still hold their last
        # applied revisions: cut the warm-start checkpoint the respawned
        # instance resumes from
        try:
            nodes_inf = factory.informer(NODES)
            pods_inf = factory.informer(PODS)
            cut = backend.checkpoint_mirror(
                warm_path, snapshot=sched.cache.flatten_view(),
                resource_versions={NODES: nodes_inf.last_rv,
                                   PODS: pods_inf.last_rv},
                objects={NODES: nodes_inf.list(),
                         PODS: pods_inf.list()})
            logger.info("checkpointed %d rows (%d bytes) to %s",
                        cut["nodes"], cut["bytes"], cut["path"])
        except Exception:  # noqa: BLE001 - drain must still exit 0
            logger.exception("checkpoint write failed; next start is cold")
    factory.stop()
    server.shutdown()
    return 0


# -- supervisor -----------------------------------------------------------


class _Child:
    """One scheduler child: Popen + stdout tail + readiness state."""

    def __init__(self, index: int):
        self.index = index
        self.proc: subprocess.Popen | None = None
        self.metrics_port: int | None = None
        self.ready = threading.Event()
        self.lines: list[str] = []  # guarded-by: _lock
        self._lock = threading.Lock()

    def tail(self, n: int = 20) -> list[str]:
        with self._lock:
            return self.lines[-n:]

    def _reader(self, proc: subprocess.Popen) -> None:
        for raw in proc.stdout:  # type: ignore[union-attr]
            line = raw.rstrip("\n")
            with self._lock:
                self.lines.append(line)
                del self.lines[:-200]
            if line.startswith(READY_PREFIX):
                for tok in line.split():
                    if tok.startswith("metrics_port="):
                        self.metrics_port = int(tok.split("=", 1)[1])
                self.ready.set()


class ProcCluster:
    """Supervisor: one apiserver process + N scheduler processes.

    Lifecycle: start() spawns everything and blocks on the readiness
    handshake; kill(i) is the crash path (SIGKILL, no drain — the
    victim's lease lapses and survivors absorb its ring slices);
    drain(i) is the graceful path (SIGTERM -> lease retire -> flush ->
    exit 0); respawn(i) brings an instance back with its old identity.
    rolling_restart() composes them into the zero-downtime upgrade:
    drain -> respawn -> /readyz, one instance at a time, the scale-out
    ring re-homing each drained instance's slices to survivors meanwhile.
    hot_reload(i) relays SIGHUP (config re-read, requires config_path);
    handoff_apiserver() replaces the apiserver over its WAL (requires
    data_dir).  shutdown() drains every child then the apiserver.
    Context-manager friendly so a failing test can never leak processes
    (tests add the conftest proc_reaper belt on top).

    device names the children's torch device (--device); None leaves
    the child's default, CUDA.  It applies to `tpu` and `sharded`
    children only."""

    # argv after sys.executable that starts one scheduler child
    child_entry = ("-m", "kubernetes_tpu_torch.scheduler.procrun", "--child")

    def __init__(self, n_instances: int, *, backend: str = "none",
                 batch_size: int = 1024, nodes: int = 256,
                 lease_duration: float = 1.5, renew_interval: float = 0.25,
                 solo_ownership: bool = False,
                 child_env: dict[int, dict[str, str]] | None = None,
                 ready_timeout: float = 120.0,
                 warm_dir: str | None = None,
                 config_path: str | None = None,
                 data_dir: str | None = None,
                 device=None):
        self.n = n_instances
        self.backend = backend
        self.batch_size = batch_size
        self.nodes = nodes
        self.lease_duration = lease_duration
        self.renew_interval = renew_interval
        # solo_ownership: every child runs instanceCount=1 (scale-out
        # layer off) so ALL children own ALL pods — the deliberate-race
        # topology the cross-process conflict tests use
        self.solo = solo_ownership
        self.child_env = child_env or {}
        self.ready_timeout = ready_timeout
        self.warm_dir = warm_dir      # children checkpoint/warm-start here
        self.config_path = config_path  # children re-read this on SIGHUP
        self.data_dir = data_dir      # apiserver WAL dir (handoff needs it)
        self.device = device          # the children's --device
        self.url: str | None = None
        self.token: str | None = None
        self.drain_escalations = 0  # SIGTERM hangs escalated to SIGKILL
        self._api: subprocess.Popen | None = None
        self._api_port: int | None = None
        self._api_log = None  # captured apiserver stdout/stderr (tempfile)
        self._children: dict[int, _Child] = {}
        self._clients: list = []  # admin HTTPClients handed out

    # -- apiserver --------------------------------------------------------

    def _start_apiserver(self) -> None:
        import secrets

        if self.token is None:
            self.token = secrets.token_urlsafe(16)
        # A fresh start may retry on a new port: _free_port() closes its
        # probe socket before the server rebinds the number, so another
        # process can race it away (EADDRINUSE kills the child before it
        # serves).  A handoff restart gets NO retry — the children hold
        # the old URL, so the replacement must win the same port back.
        fresh = self._api_port is None
        for attempt in range(3 if fresh else 1):
            if fresh:
                self._api_port = _free_port()
            self.url = f"http://127.0.0.1:{self._api_port}"
            argv = self.apiserver_argv()
            self._close_api_log()
            self._api_log = tempfile.TemporaryFile(mode="w+",
                                                   encoding="utf-8",
                                                   errors="replace")
            self._api = subprocess.Popen(
                argv, stdout=self._api_log, stderr=subprocess.STDOUT,
                cwd=_REPO_ROOT)
            try:
                self._wait_apiserver_healthy(60.0)
                return
            except RuntimeError:
                died = self._api.poll() is not None
                if not (fresh and died and attempt < 2):
                    self.shutdown()
                    raise
                logger.warning("apiserver died during start (port race?),"
                               " retrying on a fresh port")
                self._api_port = None

    def apiserver_argv(self) -> list[str]:
        # AlwaysAllow + no admission: this supervisor exists to measure
        # the SCHEDULER topology; perf/scheduler_perf.py via_http keeps
        # the RBAC+admission front-door configuration
        # --token=VALUE: token_urlsafe may start with "-", which argparse
        # would read as the next option after a bare --token
        argv = [sys.executable, "-m", "kubernetes_tpu_torch.cmd.apiserver",
                "--secure-port", str(self._api_port),
                f"--token={self.token}"]
        if self.data_dir:
            argv += ["--data-dir", self.data_dir]
        return argv

    def _api_log_tail(self, limit: int = 2000) -> str:
        log = getattr(self, "_api_log", None)
        if log is None:
            return ""
        try:
            log.seek(0)
            return log.read()[-limit:]
        except (OSError, ValueError):
            return ""

    def _close_api_log(self) -> None:
        log = getattr(self, "_api_log", None)
        if log is not None:
            try:
                log.close()
            except OSError:
                pass
            self._api_log = None

    def _wait_apiserver_healthy(self, timeout: float) -> None:
        from ..client.http_client import HTTPClient
        client = HTTPClient.from_url(self.url, token=self.token)
        deadline = time.monotonic() + timeout
        while True:
            try:
                client._request("GET", "/healthz")
                return
            except Exception:  # noqa: BLE001 - still starting
                died = self._api.poll() is not None
                if died or time.monotonic() > deadline:
                    tail = self._api_log_tail()
                    why = ("apiserver died during start" if died else
                           f"apiserver not healthy after {timeout:.0f}s")
                    if tail:
                        why += f"; last output:\n{tail}"
                    raise RuntimeError(why) from None
                time.sleep(0.1)

    def admin_client(self):
        from ..client.http_client import HTTPClient
        cl = HTTPClient.from_url(self.url, token=self.token)
        self._clients.append(cl)
        return cl

    # -- children ---------------------------------------------------------

    def child_argv(self, index: int) -> list[str]:
        count = 1 if self.solo else self.n
        argv = [sys.executable, *self.child_entry,
                "--server", self.url, f"--token={self.token}",
                "--instance-index", str(0 if self.solo else index),
                "--instance-count", str(count),
                "--backend", self.backend,
                "--batch-size", str(self.batch_size),
                "--nodes", str(self.nodes),
                "--lease-duration", str(self.lease_duration),
                "--renew-interval", str(self.renew_interval)]
        if self.device is not None:
            argv += ["--device", str(self.device)]
        if self.warm_dir:
            argv += ["--warm-dir", self.warm_dir]
        if self.config_path:
            argv += ["--config", self.config_path]
        return argv

    def _spawn(self, index: int) -> _Child:
        child = _Child(index)
        env = dict(os.environ)
        env["PYTHONUNBUFFERED"] = "1"
        env.update(self.child_env.get(index, {}))
        argv = self.child_argv(index)
        child.proc = subprocess.Popen(
            argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=_REPO_ROOT, env=env)
        threading.Thread(target=child._reader, args=(child.proc,),
                         name=f"child-tail-{index}", daemon=True).start()
        self._children[index] = child
        return child

    def start(self) -> "ProcCluster":
        self._start_apiserver()
        for i in range(self.n):
            self._spawn(i)
        self.wait_ready(range(self.n))
        return self

    def wait_ready(self, indices) -> None:
        deadline = time.monotonic() + self.ready_timeout
        for i in indices:
            child = self._children[i]
            while not child.ready.wait(
                    min(1.0, max(0.0, deadline - time.monotonic()))):
                if child.proc is not None and child.proc.poll() is not None:
                    raise RuntimeError(
                        f"scheduler child {i} exited rc="
                        f"{child.proc.returncode} before READY; tail: "
                        f"{child.tail()}")
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"scheduler child {i} not READY after "
                        f"{self.ready_timeout}s; tail: {child.tail()}")

    def alive(self, index: int) -> bool:
        c = self._children.get(index)
        return (c is not None and c.proc is not None
                and c.proc.poll() is None)

    def live_indices(self) -> list[int]:
        return [i for i in self._children if self.alive(i)]

    def kill(self, index: int) -> None:
        """Crash path: SIGKILL, no drain — the chaos ladder's
        KILL_INSTANCE made process-true."""
        c = self._children.get(index)
        if c is None or c.proc is None:
            return
        try:
            c.proc.kill()
        except OSError:
            pass
        c.proc.wait()
        c.ready.clear()

    def drain(self, index: int, timeout: float = 20.0) -> int | None:
        """Graceful path: SIGTERM -> the child retires its lease, flushes
        in-flight work and exits 0.  Escalates to SIGKILL on a hang —
        recorded in scheduler_proc_drain_escalated_total (see
        supervisor_metrics_text) — so a stuck child can never wedge a
        rolling upgrade: failover proceeds, the victim's lease lapses
        and survivors absorb its slices exactly as on a crash."""
        c = self._children.get(index)
        if c is None or c.proc is None:
            return None
        if c.proc.poll() is None:
            try:
                c.proc.terminate()
            except OSError:
                pass
            try:
                c.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self.drain_escalations += 1
                logger.warning(
                    "child %d ignored SIGTERM for %.1fs; escalating to "
                    "SIGKILL (drain_escalations=%d)", index, timeout,
                    self.drain_escalations)
                c.proc.kill()
                c.proc.wait()
        c.ready.clear()
        return c.proc.returncode

    def respawn(self, index: int, wait_ready: bool = True) -> None:
        if self.alive(index):
            return
        self._spawn(index)
        if wait_ready:
            self.wait_ready([index])

    # -- zero-downtime operations ----------------------------------------

    def wait_child_ready(self, index: int, timeout: float = 60.0) -> None:
        """Block until child `index` answers /readyz 200 — the HTTP half
        of readiness on top of the stdout handshake (a fenced or
        draining instance answers 503 there while still live)."""
        import urllib.error
        import urllib.request
        c = self._children[index]
        deadline = time.monotonic() + timeout
        while True:
            if c.metrics_port is not None:
                try:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{c.metrics_port}/readyz",
                            timeout=5.0) as resp:
                        if resp.status == 200:
                            return
                except (urllib.error.URLError, OSError):
                    pass
            if not self.alive(index):
                raise RuntimeError(
                    f"child {index} died while waiting for /readyz; "
                    f"tail: {c.tail()}")
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"child {index} not ready after {timeout}s; "
                    f"tail: {c.tail()}")
            time.sleep(0.05)

    def rolling_restart(self, *, drain_timeout: float = 20.0,
                        ready_timeout: float = 60.0) -> list[int]:
        """Zero-downtime upgrade of the scheduler topology: cycle every
        live child through drain -> respawn -> readiness, never taking
        more than one instance out at a time.  During each drain window
        the scale-out ring re-homes the drained instance's slices to
        survivors (lease retire on SIGTERM), so pods keep binding
        throughout; with warm_dir set each child checkpoints its mirror
        on the way down and warm-starts on the way up.  Returns the
        indices rolled, in order."""
        if self.config_path:
            # Pre-flight the config file: a respawned child fail-fasts on
            # an unparseable --config, so starting the roll would drain a
            # HEALTHY replica and then fail to bring its successor up —
            # the classic bad-config-plus-restart outage.  Refuse before
            # any drain instead (the running children keep their last
            # good config either way).
            from .config import ConfigError, load_config
            try:
                load_config(self.config_path)
            except ConfigError as e:
                raise RuntimeError(
                    f"refusing rolling restart: {self.config_path} would "
                    f"kill respawned children: {e}") from e
        rolled: list[int] = []
        for i in sorted(self._children):
            if not self.alive(i):
                continue
            self.drain(i, timeout=drain_timeout)
            self.respawn(i, wait_ready=True)
            self.wait_child_ready(i, timeout=ready_timeout)
            rolled.append(i)
        return rolled

    def hot_reload(self, index: int | None = None) -> list[int]:
        """Relay SIGHUP to one child (or every live child): each re-reads
        config_path and applies the dynamic stanzas without restarting;
        an invalid file is rejected child-side with the old config kept
        live.  Returns the indices signalled."""
        if not self.config_path:
            raise RuntimeError("hot_reload requires config_path")
        targets = ([index] if index is not None
                   else [i for i in sorted(self._children) if self.alive(i)])
        signalled = []
        for i in targets:
            c = self._children.get(i)
            if c is None or c.proc is None or c.proc.poll() is not None:
                continue
            c.proc.send_signal(signal.SIGHUP)
            signalled.append(i)
        return signalled

    def handoff_apiserver(self, timeout: float = 30.0) -> None:
        """Replace the apiserver process over its durable store: SIGTERM
        the old one (its shutdown fsyncs the WAL), start the replacement
        on the SAME port + token + data dir, and wait for /healthz.  WAL
        recovery restores every object and the revision counter, so the
        children never need repointing: their HTTP clients reconnect
        per-request, and their watches — whose windows died with the old
        process — raise TooOld and relist through the normal recovery
        path.  Requires data_dir (an in-memory store cannot hand off)."""
        if not self.data_dir:
            raise RuntimeError("handoff_apiserver requires data_dir")
        if self._api is not None:
            self._api.terminate()
            try:
                self._api.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self._api.kill()
                self._api.wait()
            self._api = None
        self._start_apiserver()

    def supervisor_metrics_text(self) -> str:
        """Supervisor-side counters in exposition format — appended to
        the children's federated texts by the bench/ops tooling.  These
        are process-management tallies the children cannot see (they are
        the ones being SIGKILLed), plus a per-child idle-share line
        federated from the children's /debug/timeline rings."""
        lines = ["# TYPE scheduler_proc_drain_escalated_total counter",
                 f"scheduler_proc_drain_escalated_total "
                 f"{float(self.drain_escalations)}",
                 "# TYPE scheduler_proc_wave_device_idle_share gauge"]
        for i, doc in sorted(self.timeline_snapshots().items()):
            idle = doc.get("device_idle_share")
            if idle is not None:
                lines.append(f'scheduler_proc_wave_device_idle_share'
                             f'{{instance="{i}"}} {float(idle)}')
        return "\n".join(lines) + "\n"

    def timeline_snapshots(self) -> dict[int, dict]:
        """One /debug/timeline pull per live child: instance index ->
        the child's timeline debug doc (summary + interval rows).  A
        child with the timeline disabled answers with enabled=false and
        empty rows — included so the caller sees the full topology."""
        import json as _json
        import urllib.request
        out: dict[int, dict] = {}
        for i in sorted(self._children):
            c = self._children[i]
            if not self.alive(i) or c.metrics_port is None:
                continue
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{c.metrics_port}"
                        f"/debug/timeline", timeout=10.0) as resp:
                    out[i] = _json.loads(resp.read().decode())
            except (OSError, ValueError):  # died or torn mid-pull: skip
                continue
        return out

    def federated_timeline(self):
        """Merge every live child's interval rows into one supervisor
        Timeline (rows are wall-anchored by each child's own clock, so
        the merge is plain concatenation — same contract as the remote
        seam's worker drain) and return it.  Use .snapshot_summary() for
        the cluster-wide idle share or .to_chrome_trace() for one
        Perfetto doc with per-child process lanes."""
        from ..component_base import timeline as cb_timeline
        tl = cb_timeline.Timeline(
            ring=65536, enabled=True, proc="supervisor")
        for i, doc in sorted(self.timeline_snapshots().items()):
            rows = doc.get("interval_rows") or []
            # re-tag the lane so per-child attribution survives the merge
            tl.ingest([dict(r, proc=f"sched{i}") for r in rows])
        return tl

    def metrics_texts(self) -> list[str]:
        """One /metrics pull per live child — the raw exposition bodies
        component_base/profiling.federate_texts merges (the true
        cross-process federation path its parser exists for)."""
        import urllib.request
        out = []
        for i in sorted(self._children):
            c = self._children[i]
            if not self.alive(i) or c.metrics_port is None:
                continue
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{c.metrics_port}/metrics",
                        timeout=10.0) as resp:
                    out.append(resp.read().decode())
            except OSError:  # child died mid-pull: skip, don't fail
                continue
        return out

    def shutdown(self) -> None:
        for i in list(self._children):
            try:
                self.drain(i, timeout=10.0)
            except Exception:  # noqa: BLE001 - teardown must not raise
                pass
        if self._api is not None:
            self._api.terminate()
            try:
                self._api.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                self._api.kill()
                self._api.wait()
            self._api = None
        self._close_api_log()

    def __enter__(self) -> "ProcCluster":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()


class WireBindLedger:
    """Cross-process double-bind detector: tails the apiserver's pod
    watch from rv=0 (the store's full event history) and records every
    nodeName a pod key has EVER carried.  A pod bound exactly once has
    one node in its set; a pod two PROCESSES both committed would show
    two — the assertion no amount of in-process mocking can fake."""

    def __init__(self, client):
        self.nodes_seen: dict[str, set[str]] = {}
        # first wall-clock moment this LEDGER saw each pod carry a
        # nodeName — the external observation timestamp the timeline's
        # per-pod `watch` segment is stitched from
        # (component_base/timeline.stitch_watch_segments)
        self.observed_at: dict[str, float] = {}
        from ..client.clientset import PODS
        self._pods = PODS
        self._client = client
        self._watch = client.watch(PODS, since_rv=0)

    def _record(self, obj) -> None:
        md = obj.get("metadata") or {}
        key = f"{md.get('namespace')}/{md.get('name')}"
        node = (obj.get("spec") or {}).get("nodeName")
        if node:
            self.nodes_seen.setdefault(key, set()).add(node)
            self.observed_at.setdefault(key, time.time())

    def _rearm(self) -> None:
        """The streaming watch EOFs when the apiserver hands off to a
        WAL-recovered replacement.  Re-arm against the successor: rv=0
        replay when the history still reaches back that far, else LIST
        (each pod's current nodeName is still a bind record) and watch
        from the list revision — reflector.go's relist-on-TooOld,
        applied to the test oracle.  A refused connection (mid-handoff
        gap) leaves the ledger stopped; the next drain retries."""
        from ..store import kv
        try:
            self._watch = self._client.watch(self._pods, since_rv=0)
            return
        except kv.TooOldError:
            pass
        except OSError:
            return
        try:
            items, rv = self._client.list(self._pods)
            for obj in items:
                self._record(obj)
            self._watch = self._client.watch(self._pods, since_rv=rv)
        except (kv.TooOldError, OSError):
            return

    def drain(self, timeout: float = 0.05):
        if getattr(self._watch, "stopped", False):
            self._rearm()
        for ev in self._watch.next_batch(timeout=timeout):
            self._record(ev.object)
        return self.nodes_seen

    def bound_total(self) -> int:
        self.drain()
        return len(self.nodes_seen)

    def assert_no_double_binds(self) -> None:
        self.drain()
        moved = {k: v for k, v in self.nodes_seen.items() if len(v) > 1}
        assert not moved, f"pods bound to more than one node: {moved}"

    def stop(self) -> None:
        self._watch.stop()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="ktpu-procrun")
    ap.add_argument("--child", action="store_true",
                    help="run as one scheduler instance (supervisor use)")
    ap.add_argument("--server", default="http://127.0.0.1:8080")
    ap.add_argument("--token", default="")
    ap.add_argument("--instance-index", type=int, default=0)
    ap.add_argument("--instance-count", type=int, default=1)
    ap.add_argument("--backend", default="none",
                    choices=["none", "null", "tpu", "sharded"],
                    help="batch backend kind; none = per-pod host path")
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--nodes", type=int, default=256,
                    help="expected node count (backend capacity sizing)")
    ap.add_argument("--lease-duration", type=float, default=1.5)
    ap.add_argument("--renew-interval", type=float, default=0.25)
    ap.add_argument("--warm-dir", default="",
                    help="checkpoint dir: write the mirror checkpoint on "
                         "drain, warm-start from it on boot")
    ap.add_argument("--config", default="",
                    help="KubeSchedulerConfiguration file whose dynamic "
                         "stanzas apply at boot and re-apply on SIGHUP")
    ap.add_argument("--device", default="cuda",
                    help="torch device of a tpu or sharded backend")
    args = ap.parse_args(argv)
    if not args.child:
        ap.error("supervisor mode is library-only: use ProcCluster; "
                 "--child is the process entrypoint")
    sys.exit(child_main(args))


if __name__ == "__main__":
    main()
