"""Channel-framed bidirectional streaming over an HTTP/1.1 Upgrade.

Reference contract: the kubelet's interactive endpoints speak a
multiplexed stream protocol negotiated by HTTP upgrade — SPDY in
`staging/src/k8s.io/apimachinery/pkg/util/httpstream/spdy/` with the
channel semantics of `staging/src/k8s.io/apiserver/pkg/util/wsstream/`
(remotecommand v4: stdin/stdout/stderr/error/resize channels, JSON exit
status on the error channel).

This framework serves everything over plain HTTP/1.1, so the transport
is redesigned rather than translated: a `ktpu-stream` upgrade followed
by length-prefixed frames, one byte of channel + uint32 big-endian
payload length.  Every party that only moves bytes (the apiserver's
node tunnel, kubectl port-forward's socket pump) never parses frames —
the protocol is endpoint-to-endpoint, which is what lets the apiserver
relay stay a blind byte pump exactly like the reference's
UpgradeAwareProxy (`pkg/registry/core/pod/rest/subresources.go` ->
`proxy.NewUpgradeAwareHandler`).

Channels (remotecommand v4 numbering for the first five):
  0 stdin   client -> server
  1 stdout  server -> client
  2 stderr  server -> client
  3 error   server -> client, one JSON status object, ends the stream
  4 resize  client -> server, JSON {"Width": w, "Height": h}
  5 data    port-forward payload (both directions)
  6 perror  port-forward error (server -> client)
  255 close half-close notification; payload is the closed channel byte

A copy of kubernetes_tpu/kubelet/streams.py: the same classes, names and
logic, over this package's api/, client/ and store/.
Frames are the JAX package's, byte for byte: either package's endpoint
talks to the other's.
"""

from __future__ import annotations

import json
import socket
import struct

PROTOCOL = "ktpu-stream"

STDIN, STDOUT, STDERR, ERROR, RESIZE = 0, 1, 2, 3, 4
PF_DATA, PF_ERROR = 5, 6
CLOSE = 255

_HEADER = struct.Struct("!BI")
MAX_FRAME = 4 << 20


class StreamError(Exception):
    """Transport-level failure (bad handshake, oversized frame)."""


class FrameSock:
    """Frame reader/writer over a connected socket.

    Writes are locked per-frame so concurrent producers (stdout pump +
    error status) interleave at frame granularity; reads are expected
    from a single consumer thread.
    """

    def __init__(self, sock: socket.socket):
        import threading
        self.sock = sock
        self._wlock = threading.Lock()
        self._rbuf = b""

    # -- write ----------------------------------------------------------

    def send(self, channel: int, payload: bytes = b"") -> None:
        with self._wlock:
            self.sock.sendall(_HEADER.pack(channel, len(payload)) + payload)

    def send_close(self, channel: int) -> None:
        self.send(CLOSE, bytes([channel]))

    def send_status(self, exit_code: int, message: str = "") -> None:
        """Terminal status on the error channel (remotecommand v4 shape)."""
        if exit_code == 0:
            body = {"status": "Success"}
        else:
            body = {"status": "Failure", "reason": "NonZeroExitCode",
                    "message": message or f"command terminated with "
                                          f"exit code {exit_code}",
                    "details": {"causes": [{"reason": "ExitCode",
                                            "message": str(exit_code)}]}}
        self.send(ERROR, json.dumps(body).encode())

    # -- read -----------------------------------------------------------

    def _read_exact(self, n: int) -> bytes | None:
        while len(self._rbuf) < n:
            try:
                chunk = self.sock.recv(65536)
            except OSError:
                return None
            if not chunk:
                return None
            self._rbuf += chunk
        out, self._rbuf = self._rbuf[:n], self._rbuf[n:]
        return out

    def recv(self) -> tuple[int, bytes] | None:
        """Next (channel, payload), or None at EOF/reset."""
        head = self._read_exact(_HEADER.size)
        if head is None:
            return None
        channel, length = _HEADER.unpack(head)
        if length > MAX_FRAME:
            raise StreamError(f"frame of {length} bytes exceeds cap")
        payload = self._read_exact(length) if length else b""
        if payload is None:
            return None
        return channel, payload

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


def parse_exit_status(payload: bytes) -> tuple[int, str]:
    """Exit code + message from an ERROR-channel status frame."""
    try:
        st = json.loads(payload.decode() or "{}")
    except json.JSONDecodeError:
        return 1, payload.decode(errors="replace")
    if st.get("status") == "Success":
        return 0, ""
    for cause in ((st.get("details") or {}).get("causes") or ()):
        if cause.get("reason") == "ExitCode":
            try:
                return int(cause.get("message", 1)), st.get("message", "")
            except ValueError:
                pass
    return 1, st.get("message", "")


# -- server side (inside a BaseHTTPRequestHandler) ----------------------

def accept_upgrade(handler) -> FrameSock | None:
    """Complete the 101 handshake on `handler` and hand back the raw
    connection as a FrameSock.  Returns None (after writing a 400) when
    the client didn't ask for our protocol."""
    conn_hdr = (handler.headers.get("Connection") or "").lower()
    if (handler.headers.get("Upgrade") != PROTOCOL
            or "upgrade" not in conn_hdr):
        body = json.dumps({"kind": "Status", "status": "Failure",
                           "code": 400, "reason": "BadRequest",
                           "message": f"upgrade to {PROTOCOL} required"})
        handler.send_response(400)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Content-Length", str(len(body)))
        handler.end_headers()
        handler.wfile.write(body.encode())
        return None
    handler.send_response_only(101, "Switching Protocols")
    handler.send_header("Upgrade", PROTOCOL)
    handler.send_header("Connection", "Upgrade")
    handler.end_headers()
    handler.wfile.flush()
    handler.close_connection = True
    return FrameSock(handler.connection)


# -- client side --------------------------------------------------------

def open_upgrade(host: str, port: int, path: str,
                 headers: dict[str, str] | None = None,
                 timeout: float = 30.0, ssl_context=None) -> FrameSock:
    """POST `path` with an upgrade request; raise StreamError carrying
    the server's error body on anything but 101.  `ssl_context` wraps
    the connection for a TLS apiserver."""
    sock = socket.create_connection((host, port), timeout=timeout)
    if ssl_context is not None:
        sock = ssl_context.wrap_socket(sock, server_hostname=host)
    try:
        req = [f"POST {path} HTTP/1.1", f"Host: {host}:{port}",
               "Connection: Upgrade", f"Upgrade: {PROTOCOL}"]
        for k, v in (headers or {}).items():
            req.append(f"{k}: {v}")
        sock.sendall(("\r\n".join(req) + "\r\n\r\n").encode())
        # read the response head
        head = b""
        while b"\r\n\r\n" not in head:
            chunk = sock.recv(4096)
            if not chunk:
                raise StreamError("connection closed during handshake")
            head += chunk
            if len(head) > 65536:
                raise StreamError("oversized handshake response")
        head_text, _, rest = head.partition(b"\r\n\r\n")
        lines = head_text.decode(errors="replace").split("\r\n")
        try:
            status = int(lines[0].split()[1])
        except (IndexError, ValueError):
            raise StreamError(f"bad status line {lines[0]!r}") from None
        if status != 101:
            # non-upgrade response: collect what body we can for the error
            hdrs = {}
            for ln in lines[1:]:
                k, _, v = ln.partition(":")
                hdrs[k.strip().lower()] = v.strip()
            want = int(hdrs.get("content-length") or 0)
            body = rest
            sock.settimeout(5.0)
            while len(body) < want:
                chunk = sock.recv(4096)
                if not chunk:
                    break
                body += chunk
            message = body.decode(errors="replace")
            try:
                message = json.loads(message).get("message", message)
            except (json.JSONDecodeError, AttributeError):
                pass
            raise StreamError(f"upgrade refused: {status} {message}")
        sock.settimeout(None)
        fs = FrameSock(sock)
        fs._rbuf = rest  # frames may ride the handshake packet
        return fs
    except Exception:
        sock.close()
        raise
