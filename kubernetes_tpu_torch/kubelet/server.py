"""Kubelet HTTP server: logs/exec/attach/portForward/checkpoint/stats.

Reference: pkg/kubelet/server/server.go:949-967 — the kubelet serves
  /pods /healthz /stats/summary /configz
  /containerLogs/{ns}/{pod}/{container}
  /exec/{ns}/{pod}/{container}   /attach/...   /portForward/{ns}/{pod}
  /checkpoint/{ns}/{pod}/{container}
with the interactive endpoints upgrading to a multiplexed stream that a
CRI streaming server backs (cri-api api.proto Exec/Attach/PortForward).

Redesign for the hollow fleet: ONE process-wide server fronts every
hollow kubelet (kubemark runs hundreds of nodes per process; a listener
per node would be pure socket overhead).  Each request resolves
{ns, pod} across registered kubelets — node identity stays intact
because every node advertises this server in its own
status.daemonEndpoints.  The stream protocol is `streams.py`'s framed
upgrade, the plain-HTTP stand-in for the reference's SPDY.

A copy of kubernetes_tpu/kubelet/server.py: the same classes, names and
logic, over this package's api/, client/ and store/.
The port's apiserver tunnels to it through node status daemonEndpoints,
as the JAX package's does.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from . import streams

logger = logging.getLogger(__name__)


class _ExecIO:
    """FrameSock -> CRI exec adapter: stdin demux + stdout/stderr mux.

    A dedicated reader thread drains the socket so stdin reads can't
    miss interleaved resize/close frames; exec scripts block on the
    queue, matching a real shell blocking on read(0)."""

    def __init__(self, fs: streams.FrameSock):
        import queue
        self.fs = fs
        self._stdin: queue.Queue[bytes | None] = queue.Queue()
        self.resizes: list[dict] = []
        t = threading.Thread(target=self._pump, daemon=True)
        t.start()

    def _pump(self) -> None:
        while True:
            frame = self.fs.recv()
            if frame is None:
                self._stdin.put(None)
                return
            ch, payload = frame
            if ch == streams.STDIN:
                self._stdin.put(payload)
            elif ch == streams.RESIZE:
                try:
                    self.resizes.append(json.loads(payload.decode()))
                except json.JSONDecodeError:
                    pass
            elif ch == streams.CLOSE and payload == bytes([streams.STDIN]):
                self._stdin.put(None)

    def read_stdin(self) -> bytes | None:
        return self._stdin.get()

    def write_stdout(self, data: bytes) -> None:
        self.fs.send(streams.STDOUT, data)

    def write_stderr(self, data: bytes) -> None:
        self.fs.send(streams.STDERR, data)


class _ConnClosedProbe:
    """Event-shaped view of "has the HTTP client hung up?".

    A GET log stream is half-duplex: the client sends nothing after the
    request, so EOF (readable socket + empty peek) is the only
    disconnect signal.  read_logs polls is_set() between waits."""

    def __init__(self, conn):
        self.conn = conn

    def is_set(self) -> bool:
        import select
        import socket as socketlib
        try:
            readable, _, _ = select.select([self.conn], [], [], 0)
            if not readable:
                return False
            return self.conn.recv(1, socketlib.MSG_PEEK) == b""
        except OSError:
            return True


class _PortIO:
    """FrameSock -> CRI port-forward adapter (data/error channels)."""

    def __init__(self, fs: streams.FrameSock):
        self.fs = fs

    def read_data(self) -> bytes | None:
        while True:
            frame = self.fs.recv()
            if frame is None:
                return None
            ch, payload = frame
            if ch == streams.PF_DATA:
                return payload
            if ch == streams.CLOSE:
                return None

    def write_data(self, data: bytes) -> None:
        self.fs.send(streams.PF_DATA, data)

    def error(self, message: str) -> None:
        self.fs.send(streams.PF_ERROR, message.encode())


class KubeletServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._kubelets: dict[str, object] = {}
        self._lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # see apiserver/server.py: Nagle + delayed ACK costs 40ms
            # per request on two-write responses
            disable_nagle_algorithm = True

            def log_message(self, *a):  # quiet
                pass

            def _json(self, code: int, obj: dict) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _err(self, code: int, message: str) -> None:
                self._json(code, {"kind": "Status", "status": "Failure",
                                  "code": code, "message": message})

            def _resolve(self, ns: str, pod: str, container: str | None):
                """-> (runtime, sandbox, container id) or None+response."""
                hit = outer.lookup(ns, pod)
                if hit is None:
                    self._err(404, f"pod {ns}/{pod} not found on node")
                    return None
                kubelet, state = hit
                if container is None:
                    if len(state["containers"]) != 1:
                        self._err(400, "container name required")
                        return None
                    cid = next(iter(state["containers"].values()))
                else:
                    cid = state["containers"].get(container)
                    if cid is None:
                        self._err(404, f"container {container!r} not found")
                        return None
                return kubelet.runtime, state["sandbox"], cid

            # ---- routes ----

            def do_GET(self):
                self._handle()

            def do_POST(self):
                self._handle()

            def _handle(self):
                u = urlparse(self.path)
                q = parse_qs(u.query)
                parts = [p for p in u.path.split("/") if p]
                try:
                    if not parts:
                        self._err(404, "not found")
                    elif parts[0] == "healthz":
                        body = b"ok"
                        self.send_response(200)
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                    elif parts[0] == "pods":
                        self._serve_pods(q)
                    elif parts[0] == "stats":
                        self._serve_stats()
                    elif parts[0] == "containerLogs" and len(parts) == 4:
                        self._serve_logs(parts[1], parts[2], parts[3], q)
                    elif parts[0] in ("exec", "attach") and len(parts) == 4:
                        self._serve_exec(parts[0], parts[1], parts[2],
                                         parts[3], q)
                    elif parts[0] == "portForward" and len(parts) == 3:
                        self._serve_portforward(parts[1], parts[2], q)
                    elif parts[0] == "checkpoint" and len(parts) == 4:
                        self._serve_checkpoint(parts[1], parts[2], parts[3])
                    else:
                        self._err(404, f"no handler for {u.path}")
                except (BrokenPipeError, ConnectionResetError):
                    self.close_connection = True

            def _serve_pods(self, q) -> None:
                node = (q.get("node") or [None])[0]
                items = []
                with outer._lock:
                    kubelets = list(outer._kubelets.items())
                for name, k in kubelets:
                    if node is not None and name != node:
                        continue
                    items += [{"namespace": ns, "name": pod, "node": name}
                              for ns, pod in k.list_pod_keys()]
                self._json(200, {"kind": "PodList", "items": items})

            def _serve_stats(self) -> None:
                with outer._lock:
                    kubelets = list(outer._kubelets.items())
                nodes = []
                for name, k in kubelets:
                    pods = k.list_pod_keys()
                    nodes.append({"nodeName": name, "numPods": len(pods),
                                  "pods": [{"podRef": {"namespace": ns,
                                                       "name": pod}}
                                           for ns, pod in pods]})
                self._json(200, {"node": nodes[0] if len(nodes) == 1
                                 else None, "nodes": nodes})

            def _serve_logs(self, ns, pod, container, q) -> None:
                got = self._resolve(ns, pod, container)
                if got is None:
                    return
                runtime, _, cid = got
                follow = (q.get("follow") or ["false"])[0] == "true"
                tail = q.get("tailLines")
                try:
                    tail_n = int(tail[0]) if tail else None
                except ValueError:
                    self._err(400, f"invalid tailLines {tail[0]!r}")
                    return
                self.send_response(200)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Connection", "close")
                self.end_headers()
                self.close_connection = True
                # a quiet follow writes nothing, so a vanished client is
                # only visible on the socket itself — probe it each idle
                # poll or the handler thread leaks until container exit
                stop = _ConnClosedProbe(self.connection) if follow \
                    else None
                try:
                    for line in runtime.read_logs(cid, follow=follow,
                                                  tail=tail_n, stop=stop):
                        self.wfile.write(line.encode())
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError, OSError):
                    pass

            def _serve_exec(self, kind, ns, pod, container, q) -> None:
                got = self._resolve(ns, pod, container)
                if got is None:
                    return
                runtime, _, cid = got
                fs = streams.accept_upgrade(self)
                if fs is None:
                    return
                io = _ExecIO(fs)
                tty = (q.get("tty") or ["false"])[0] == "true"
                try:
                    if kind == "exec":
                        code = runtime.exec_stream(
                            cid, q.get("command") or [], io, tty=tty)
                    else:
                        code = runtime.attach_stream(cid, io, tty=tty)
                    fs.send_status(code)
                except (BrokenPipeError, ConnectionResetError, OSError):
                    pass
                finally:
                    fs.close()

            def _serve_portforward(self, ns, pod, q) -> None:
                got_pod = outer.lookup(ns, pod)
                if got_pod is None:
                    self._err(404, f"pod {ns}/{pod} not found on node")
                    return
                kubelet, state = got_pod
                try:
                    port = int((q.get("port") or ["0"])[0])
                except ValueError:
                    self._err(400, "bad port")
                    return
                fs = streams.accept_upgrade(self)
                if fs is None:
                    return
                try:
                    kubelet.runtime.portforward_stream(
                        state["sandbox"], port, _PortIO(fs))
                except (BrokenPipeError, ConnectionResetError, OSError):
                    pass
                finally:
                    fs.close()

            def _serve_checkpoint(self, ns, pod, container) -> None:
                if self.command != "POST":
                    self._err(405, "POST required")
                    return
                got = self._resolve(ns, pod, container)
                if got is None:
                    return
                runtime, _, cid = got
                archive = runtime.checkpoint_container(cid)
                self._json(200, {"items": [archive]})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address
        self._thread: threading.Thread | None = None

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "KubeletServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="kubelet-server", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    # -- registry --------------------------------------------------------

    def register(self, kubelet) -> None:
        with self._lock:
            self._kubelets[kubelet.node_name] = kubelet

    def unregister(self, kubelet) -> None:
        with self._lock:
            if self._kubelets.get(kubelet.node_name) is kubelet:
                del self._kubelets[kubelet.node_name]

    def lookup(self, ns: str, pod: str):
        with self._lock:
            kubelets = list(self._kubelets.values())
        for k in kubelets:
            state = k.lookup_pod(ns, pod)
            if state is not None:
                return k, state
        return None
