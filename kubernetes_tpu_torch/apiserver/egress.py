"""Egress selector — how the apiserver dials OUT (the konnectivity seam).

Reference: staging/src/k8s.io/apiserver/pkg/server/egressselector/
  egress_selector.go:40 — outbound connections are classified by traffic
  type (Cluster: webhooks/aggregated APIs on cluster networks; Master:
  control-plane peers; Etcd: storage) and each type resolves to a dialer.
  The default is a direct dial; deployments with isolated node networks
  plug in the konnectivity client, which tunnels through a proxy server.

Here the seam is a process-global EgressSelector the aggregator,
admission webhooks, and scheduler extender consult for every outbound
request.  Two dialers ship:
  DirectDialer       — plain urllib (the default; zero behavior change)
  HTTPConnectDialer  — tunnels TCP through an HTTP CONNECT proxy (the
                       konnectivity-server protocol's public analog),
                       demonstrating that isolated-network deployments
                       only swap the dialer, never the callers.
"""

from __future__ import annotations

import http.client
import socket
import threading
import urllib.request

CLUSTER = "cluster"
MASTER = "master"
ETCD = "etcd"


class DirectDialer:
    """Default: dial the target directly."""

    def open(self, req: urllib.request.Request, timeout: float):
        return urllib.request.urlopen(req, timeout=timeout)


class HTTPConnectDialer:
    """Tunnel through an HTTP CONNECT proxy (egress_selector.go's
    http-connect protocol).  Only http:// targets — this control plane
    serves plain HTTP."""

    def __init__(self, proxy_host: str, proxy_port: int):
        self.proxy_host = proxy_host
        self.proxy_port = proxy_port

    def open(self, req: urllib.request.Request, timeout: float):
        host = req.host.rsplit(":", 1)[0]
        port = int(req.host.rsplit(":", 1)[1]) if ":" in req.host else 80
        conn = http.client.HTTPConnection(self.proxy_host, self.proxy_port,
                                          timeout=timeout)
        conn.set_tunnel(host, port)
        path = req.selector or "/"
        conn.request(req.get_method(), path, body=req.data,
                     headers=dict(req.header_items()))
        resp = conn.getresponse()
        # adapt to the urlopen-ish contract callers use (read/close/status)
        resp.url = req.full_url
        if resp.status >= 400:
            raise urllib.error.HTTPError(req.full_url, resp.status,
                                         resp.reason, resp.headers, resp)
        return resp


class EgressSelector:
    """network-context -> dialer registry (EgressSelector.Lookup)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._dialers: dict[str, object] = {}
        self._default = DirectDialer()

    def register(self, network: str, dialer) -> None:
        with self._lock:
            self._dialers[network] = dialer

    def reset(self, network: str | None = None) -> None:
        with self._lock:
            if network is None:
                self._dialers.clear()
            else:
                self._dialers.pop(network, None)

    def lookup(self, network: str):
        with self._lock:
            return self._dialers.get(network, self._default)

    def open(self, network: str, req: urllib.request.Request,
             timeout: float):
        """Dial `req` through the network's dialer."""
        return self.lookup(network).open(req, timeout)


# the process-global selector every outbound caller consults; tests and
# deployments swap dialers here (server startup wiring in the reference)
default_selector = EgressSelector()
