"""Interactive streams in the port (kubernetes_tpu_torch/kubelet/streams.py
and server.py) held against the JAX package's on the CPU.

  (a) The frame protocol: FrameSock frames written by either package are
      read by the other over a socketpair (every channel, a payload that
      spans several reads, half-close, the exit-status frames, EOF), and
      parse_exit_status reads the same payloads alike.
  (b) tests/test_streaming.py's exec, logs, attach, port-forward,
      kubelet-endpoint, subresource-routing and protocol scenarios that
      need no kubectl, driven through streams.open_upgrade (and the log
      subresource's plain GET) against each package's apiserver, which
      tunnels through node status daemonEndpoints to that package's
      KubeletServer in front of two hollow nodes; every scenario runs on
      both packages with the same expectations, and the error messages
      of the refused streams are equal.
  (c) Across the packages: the port's apiserver tunnels to the JAX
      package's KubeletServer, and the JAX apiserver to the port's.
"""

import http.client
import importlib
import json
import socket
import threading
import time
from urllib.parse import urlencode

import pytest

pytest.importorskip("jax")

from torch_cases import PORT_PKG as PORT, wait_for  # noqa: E402

JAX = "kubernetes_tpu"
PKGS = (JAX, PORT)


def m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


# -- (a) the frame protocol across the packages -----------------------------

@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)])
def test_frames_cross_decode(writer, reader):
    ws, rs = m(writer, "kubelet.streams"), m(reader, "kubelet.streams")
    a, b = socket.socketpair()
    fa, fb = ws.FrameSock(a), rs.FrameSock(b)
    frames = [(ws.STDOUT, b"x" * 70000), (ws.STDERR, b"err\n"),
              (ws.STDIN, b""), (ws.RESIZE, b'{"Width": 80, "Height": 24}'),
              (ws.PF_DATA, bytes(range(256)) * 3), (ws.PF_ERROR, b"no")]
    done = threading.Event()

    def write():
        for ch, payload in frames:
            fa.send(ch, payload)
        fa.send_close(ws.STDIN)
        fa.send_status(0)
        fa.send_status(7, "boom")
        fa.send_status(3)
        fa.close()
        done.set()
    threading.Thread(target=write, daemon=True).start()
    got = [fb.recv() for _ in range(len(frames) + 4)]
    assert fb.recv() is None
    assert done.wait(5)
    fb.close()
    assert got[:len(frames)] == frames
    assert got[len(frames)] == (rs.CLOSE, bytes([rs.STDIN]))
    statuses = [rs.parse_exit_status(p) for ch, p in got[-3:]]
    assert {ch for ch, _ in got[-3:]} == {rs.ERROR}
    assert statuses == [(0, ""), (7, "boom"),
                        (3, "command terminated with exit code 3")]
    assert (ws.STDIN, ws.STDOUT, ws.STDERR, ws.ERROR, ws.RESIZE,
            ws.PF_DATA, ws.PF_ERROR, ws.CLOSE, ws.PROTOCOL, ws.MAX_FRAME) \
        == (rs.STDIN, rs.STDOUT, rs.STDERR, rs.ERROR, rs.RESIZE,
            rs.PF_DATA, rs.PF_ERROR, rs.CLOSE, rs.PROTOCOL, rs.MAX_FRAME)


EXIT_PAYLOADS = [
    b'{"status": "Success"}', b"", b"{}", b"not json",
    json.dumps({"status": "Failure", "message": "boom", "details": {
        "causes": [{"reason": "ExitCode", "message": "9"}]}}).encode(),
    json.dumps({"status": "Failure", "details": {"causes": [
        {"reason": "ExitCode", "message": "x"}]}}).encode(),
    json.dumps({"status": "Failure", "message": "m"}).encode()]


@pytest.mark.parametrize("payload", EXIT_PAYLOADS)
def test_exit_status_parse_matches(payload):
    assert m(PORT, "kubelet.streams").parse_exit_status(payload) == \
        m(JAX, "kubelet.streams").parse_exit_status(payload)


def test_oversized_frame_refused_alike():
    for pkg in PKGS:
        s = m(pkg, "kubelet.streams")
        a, b = socket.socketpair()
        a.sendall(s._HEADER.pack(s.STDOUT, s.MAX_FRAME + 1))
        with pytest.raises(s.StreamError):
            s.FrameSock(b).recv()
        a.close()
        b.close()


# -- (b) the scenarios through each package's apiserver ---------------------

class Cluster:
    """One package's apiserver in process, a KubeletServer and two hollow
    nodes on the same store; pods are pre-bound (no scheduler)."""

    def __init__(self, api_pkg, kubelet_pkg=None):
        kubelet_pkg = kubelet_pkg or api_pkg
        self.kv = m(api_pkg, "store.kv")
        self.store = self.kv.MemoryStore(history=100_000)
        self.server = m(api_pkg, "apiserver").APIServer(self.store).start()
        # the kubelets run over a client of their own package's on the
        # apiserver's store: both stores hold JSON objects alike
        self.local = m(kubelet_pkg, "client").LocalClient(self.store)
        self.factory = m(kubelet_pkg, "client").SharedInformerFactory(
            self.local)
        self.factory.start()
        self.factory.wait_for_cache_sync()
        self.ks = m(kubelet_pkg, "kubelet").KubeletServer().start()
        self.kubelets = m(kubelet_pkg, "kubelet").start_hollow_nodes(
            self.local, self.factory, 2, kubelet_server=self.ks,
            heartbeat_interval=3600)
        self.meta = m(kubelet_pkg, "api.meta")
        url = self.server.url.split("//", 1)[1]
        self.host, port = url.rsplit(":", 1)
        self.port = int(port)

    def stop(self):
        for k in self.kubelets:
            k.stop()
        self.ks.stop()
        self.factory.stop()
        self.server.stop()
        self.local.close()

    def run_pod(self, name, node="hollow-0", containers=None,
                annotations=None):
        pod = self.meta.new_object("Pod", name, "default")
        if annotations:
            pod["metadata"]["annotations"] = annotations
        pod["spec"] = {"nodeName": node,
                       "containers": containers or [{"name": "c0",
                                                     "image": "img"}]}
        self.local.create("pods", pod)
        assert wait_for(lambda: (self.local.get("pods", "default", name)
                                 .get("status") or {}).get("phase")
                        == "Running")

    def open(self, path):
        return m(PORT, "kubelet.streams").open_upgrade(
            self.host, self.port, path)

    def exec(self, name, command, stdin=None, container=None):
        """(exit code, stdout, stderr) as kubectl exec reads them, or
        ("refused", message) when the upgrade is refused."""
        s = m(PORT, "kubelet.streams")
        q = [("command", c) for c in command] + [("stdout", "true"),
                                                 ("stderr", "true")]
        if container:
            q.append(("container", container))
        if stdin is not None:
            q.append(("stdin", "true"))
        try:
            fs = self.open(f"/api/v1/namespaces/default/pods/{name}/exec?"
                           + urlencode(q))
        except s.StreamError as e:
            return "refused", str(e)
        if stdin is not None:
            fs.send(s.STDIN, stdin)
        fs.send_close(s.STDIN)
        code, out, err = 1, [], []
        try:
            while True:
                frame = fs.recv()
                if frame is None:
                    break
                ch, payload = frame
                if ch == s.STDOUT:
                    out.append(payload)
                elif ch == s.STDERR:
                    err.append(payload)
                elif ch == s.ERROR:
                    code, msg = s.parse_exit_status(payload)
                    if code and msg:
                        err.append(msg.encode())
                    break
        finally:
            fs.close()
        return code, b"".join(out).decode(), b"".join(err).decode()

    def logs(self, name, **q):
        conn = http.client.HTTPConnection(self.host, self.port, timeout=30)
        try:
            path = f"/api/v1/namespaces/default/pods/{name}/log"
            if q:
                path += "?" + urlencode(q)
            conn.request("GET", path)
            resp = conn.getresponse()
            return resp.status, resp.read().decode()
        finally:
            conn.close()

    def kubelet_request(self, method, path):
        conn = socket.create_connection((self.ks.host, self.ks.port),
                                        timeout=10.0)
        conn.sendall(f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
                     f"Connection: close\r\n\r\n".encode())
        data = b""
        while True:
            chunk = conn.recv(65536)
            if not chunk:
                break
            data += chunk
        conn.close()
        head, _, body = data.partition(b"\r\n\r\n")
        return int(head.split()[1]), body


@pytest.fixture(scope="module", params=PKGS)
def cluster(request):
    c = Cluster(request.param)
    yield c
    c.stop()


class TestExec:
    def test_echo_round_trip(self, cluster):
        cluster.run_pod("exec-echo")
        assert cluster.exec("exec-echo", ["echo", "hello", "tpu"]) == \
            (0, "hello tpu\n", "")

    def test_stdin_cat(self, cluster):
        cluster.run_pod("exec-cat")
        assert cluster.exec("exec-cat", ["cat"], stdin=b"line1\nline2\n") \
            == (0, "line1\nline2\n", "")

    def test_exit_codes_and_stderr(self, cluster):
        cluster.run_pod("exec-codes")
        assert cluster.exec("exec-codes", ["true"])[0] == 0
        assert cluster.exec("exec-codes", ["false"])[0] == 1
        code, _out, err = cluster.exec("exec-codes", ["no-such-binary"])
        assert code == 127 and "command not found" in err
        assert cluster.exec("exec-codes", ["sh", "-c", "exit 42"])[0] == 42

    def test_env_and_hostname(self, cluster):
        cluster.run_pod("exec-env", containers=[{
            "name": "c0", "image": "img",
            "env": [{"name": "MODE", "value": "tpu"}]}])
        assert "MODE=tpu" in cluster.exec("exec-env", ["env"])[1]
        assert cluster.exec("exec-env", ["hostname"])[1].strip() == \
            "exec-env"

    def test_tar_round_trip(self, cluster):
        cluster.run_pod("exec-tar")
        code, out, _ = cluster.exec("exec-tar", ["sh", "-c", "echo x"])
        assert (code, out) == (0, "x\n")
        import io
        import tarfile
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w") as tf:
            ti = tarfile.TarInfo("d/f.txt")
            ti.size = 3
            tf.addfile(ti, io.BytesIO(b"abc"))
        assert cluster.exec("exec-tar", ["tar", "xf", "-", "-C", "/tmp"],
                            stdin=buf.getvalue())[0] == 0
        assert cluster.exec("exec-tar", ["cat", "/tmp/d/f.txt"]) == \
            (0, "abc", "")

    def test_missing_pod_and_container(self, cluster):
        got = cluster.exec("nope", ["true"])
        assert got[0] == "refused"
        cluster.run_pod("exec-badctr")
        got = cluster.exec("exec-badctr", ["true"], container="zz")
        assert got[0] == "refused" and "not found" in got[1]

    def test_unscheduled_pod_rejected(self, cluster):
        pod = cluster.meta.new_object("Pod", "exec-pending", "default")
        pod["spec"] = {"containers": [{"name": "c0", "image": "img"}]}
        cluster.local.create("pods", pod)
        got = cluster.exec("exec-pending", ["true"])
        assert got[0] == "refused" and "not scheduled" in got[1]


class TestLogs:
    def test_basic_and_tail(self, cluster):
        cluster.run_pod("logs-basic")
        assert cluster.logs("logs-basic") == (200, "c0 starting\nc0 ready\n")
        assert cluster.logs("logs-basic", tailLines=1) == (200,
                                                           "c0 ready\n")

    def test_follow_sees_ticks_until_exit(self, cluster):
        # the runtime makes ticks only while something reads a running
        # container's state, so the container must outlive the pod's
        # start by a margin a loaded run keeps
        cluster.run_pod("logs-follow", annotations={
            "hollow/run-seconds": "3",
            "hollow/log-interval-seconds": "0.25"})
        t0 = time.monotonic()
        code, text = cluster.logs("logs-follow", follow="true")
        assert code == 200
        assert "tick 0" in text and "tick 1" in text
        assert time.monotonic() - t0 >= 0.8

    def test_container_selection(self, cluster):
        cluster.run_pod("logs-two", containers=[
            {"name": "a", "image": "img"}, {"name": "b", "image": "img"}])
        assert cluster.logs("logs-two", container="b") == \
            (200, "b starting\nb ready\n")
        code, body = cluster.logs("logs-two")
        assert code == 400 and "container name required" in body


class TestAttach:
    def test_attach_streams_console(self, cluster):
        s = m(PORT, "kubelet.streams")
        cluster.run_pod("attach-1", annotations={
            "hollow/run-seconds": "3",
            "hollow/log-interval-seconds": "0.2"})
        fs = cluster.open("/api/v1/namespaces/default/pods/attach-1/attach?"
                          "stdout=true&stderr=true&stdin=true")
        fs.send(s.STDIN, b"typed\n")
        out, code = [], None
        try:
            while True:
                frame = fs.recv()
                if frame is None:
                    break
                ch, payload = frame
                if ch == s.STDOUT:
                    out.append(payload.decode())
                elif ch == s.ERROR:
                    code, _ = s.parse_exit_status(payload)
                    break
        finally:
            fs.close()
        text = "".join(out)
        assert code == 0
        assert "tick" in text and "typed" in text
        assert "starting" not in text


class TestPortForward:
    def test_round_trip(self, cluster):
        s = m(PORT, "kubelet.streams")
        cluster.run_pod("pf-1", containers=[{
            "name": "c0", "image": "img",
            "ports": [{"containerPort": 9090}]}])
        fs = cluster.open("/api/v1/namespaces/default/pods/pf-1/"
                          "portforward?port=9090")
        try:
            assert fs.recv() == (s.PF_DATA, b"hollow-port 9090\n")
            fs.send(s.PF_DATA, b"ping")
            assert fs.recv() == (s.PF_DATA, b"ping")
            fs.send_close(s.PF_DATA)
        finally:
            fs.close()

    def test_undeclared_port_refused(self, cluster):
        s = m(PORT, "kubelet.streams")
        cluster.run_pod("pf-2")
        fs = cluster.open("/api/v1/namespaces/default/pods/pf-2/"
                          "portforward?port=7777")
        try:
            ch, payload = fs.recv()
            assert ch == s.PF_ERROR
            assert b"connection refused" in payload
        finally:
            fs.close()


class TestKubeletEndpoints:
    def test_healthz_pods_stats(self, cluster):
        cluster.run_pod("ep-1")
        assert cluster.kubelet_request("GET", "/healthz") == (200, b"ok")
        code, body = cluster.kubelet_request("GET", "/pods?node=hollow-0")
        assert code == 200
        assert "ep-1" in {i["name"] for i in json.loads(body)["items"]}
        code, body = cluster.kubelet_request("GET", "/stats/summary")
        assert code == 200
        assert any(n["numPods"] for n in json.loads(body)["nodes"])

    def test_checkpoint(self, cluster):
        cluster.run_pod("ep-ckpt")
        code, body = cluster.kubelet_request(
            "POST", "/checkpoint/default/ep-ckpt/c0")
        assert code == 200
        items = json.loads(body)["items"]
        assert len(items) == 1 and items[0].startswith("checkpoint-c0")
        assert cluster.kubelet_request(
            "GET", "/checkpoint/default/ep-ckpt/c0")[0] == 405

    def test_upgrade_required_without_header(self, cluster):
        cluster.run_pod("ep-up")
        code, body = cluster.kubelet_request(
            "POST", "/exec/default/ep-up/c0?command=true")
        assert code == 400 and b"upgrade" in body.lower()


class TestSubresourceRouting:
    def test_write_verbs_rejected_and_parent_safe(self, cluster):
        import urllib.error
        import urllib.request
        cluster.run_pod("sub-guard")
        base = (f"http://{cluster.host}:{cluster.port}"
                f"/api/v1/namespaces/default/pods/sub-guard")
        for verb, sub in (("DELETE", "exec"), ("PUT", "log"),
                          ("PATCH", "attach"), ("DELETE", "portforward")):
            req = urllib.request.Request(f"{base}/{sub}", method=verb,
                                         data=b"{}")
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(req)
            assert exc.value.code == 405, (verb, sub)
        cluster.local.get("pods", "default", "sub-guard")

    def test_stream_subresources_are_pods_only(self, cluster):
        import urllib.error
        import urllib.request
        req = urllib.request.Request(
            f"http://{cluster.host}:{cluster.port}"
            f"/api/v1/namespaces/default/configmaps/x/log")
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req)
        assert exc.value.code == 404


class TestStreamProtocol:
    def test_frame_round_trip(self):
        s = m(PORT, "kubelet.streams")
        a, b = socket.socketpair()
        fa, fb = s.FrameSock(a), s.FrameSock(b)
        fa.send(s.STDOUT, b"x" * 70000)
        fa.send_close(s.STDIN)
        assert fb.recv() == (s.STDOUT, b"x" * 70000)
        assert fb.recv() == (s.CLOSE, bytes([s.STDIN]))
        fa.close()
        assert fb.recv() is None
        fb.close()

    def test_exit_status_parse(self):
        s = m(PORT, "kubelet.streams")
        assert s.parse_exit_status(
            json.dumps({"status": "Success"}).encode()) == (0, "")
        code, msg = s.parse_exit_status(json.dumps({
            "status": "Failure", "message": "boom",
            "details": {"causes": [{"reason": "ExitCode",
                                    "message": "7"}]}}).encode())
        assert code == 7 and msg == "boom"


REFUSALS = [("nope", ["true"], None), ("refused-badctr", ["true"], "zz"),
            ("refused-pending", ["true"], None)]


def test_refusals_read_alike():
    """The refused streams' messages are the same text in both
    packages."""
    got = {}
    for pkg in PKGS:
        c = Cluster(pkg)
        try:
            c.run_pod("refused-badctr")
            pod = c.meta.new_object("Pod", "refused-pending", "default")
            pod["spec"] = {"containers": [{"name": "c0", "image": "img"}]}
            c.local.create("pods", pod)
            got[pkg] = [c.exec(name, cmd, container=ctr)
                        for name, cmd, ctr in REFUSALS]
            got[pkg].append(c.logs("nope"))
        finally:
            c.stop()
    assert all(r[0] == "refused" for r in got[PORT][:3])
    assert got[PORT] == got[JAX]


# -- (c) across the packages ------------------------------------------------

@pytest.mark.parametrize("api_pkg,kubelet_pkg", [(PORT, JAX), (JAX, PORT)])
def test_apiserver_tunnels_to_the_other_packages_kubelet(api_pkg,
                                                         kubelet_pkg):
    c = Cluster(api_pkg, kubelet_pkg)
    try:
        c.run_pod("cross")
        assert c.exec("cross", ["echo", "across"]) == (0, "across\n", "")
        assert c.logs("cross") == (200, "c0 starting\nc0 ready\n")
    finally:
        c.stop()
