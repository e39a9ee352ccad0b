"""Both packages' apiservers side by side, for the front door's parity tests
(test_torch_apiserver.py, test_torch_http_client.py).

`start_pair(**kwargs)` starts the JAX package's APIServer and the port's,
each in process on port 0 over a fresh MemoryStore of its own, with the
scheduler_perf harness's flags (a bearer token, RBAC, the default
admission chain without ServiceAccount, TaintNodesByCondition and
Priority) unless the caller overrides them.  `call` sends one raw request
and returns (status, JSON body); `normalise` blanks the fields that
differ between two runs by nature (uid, creationTimestamp, a managed
field's time) and nothing else.
"""

from __future__ import annotations

import http.client
import importlib
import json
import time
from types import SimpleNamespace

ROOTS = ("kubernetes_tpu", "kubernetes_tpu_torch")

ADMIN = "admin-token"          # the harness's token: a superuser
SCHED = "sched-token"          # system:kube-scheduler (bootstrap roles)
DEV = "dev-token"              # a user no binding names, until one does
TOKENS = {SCHED: ("system:kube-scheduler", ()),
          DEV: ("dev", ("devs",))}
HARNESS_DISABLED = frozenset(("ServiceAccount", "TaintNodesByCondition",
                              "Priority"))


def package(root: str) -> SimpleNamespace:
    """The modules of one package the tests reach, by short name."""
    names = {"apiserver": "apiserver", "server": "apiserver.server",
             "rbac": "apiserver.rbac", "flowcontrol": "apiserver.flowcontrol",
             "audit": "apiserver.audit", "managedfields":
             "apiserver.managedfields", "kv": "store.kv",
             "encryption": "store.encryption", "meta": "api.meta",
             "http_client": "client.http_client",
             "clientset": "client.clientset", "client": "client",
             "testing": "testing", "scheduler": "scheduler"}
    return SimpleNamespace(root=root, **{
        k: importlib.import_module(f"{root}.{v}") for k, v in names.items()})


def harness_kwargs(pkg: SimpleNamespace) -> dict:
    return dict(token=ADMIN, tokens=dict(TOKENS), enable_rbac=True,
                enable_default_admission=True,
                disable_admission_plugins=HARNESS_DISABLED)


class Side:
    """One package's running apiserver and its store."""

    def __init__(self, root: str, extra=None, store_extra=None):
        self.pkg = package(root)
        self.store = self.pkg.kv.MemoryStore(
            **(store_extra(self.pkg) if store_extra is not None else {}))
        kwargs = harness_kwargs(self.pkg)
        if extra is not None:
            kwargs.update(extra(self.pkg))
        self.server = self.pkg.apiserver.APIServer(self.store,
                                                   **kwargs).start()
        self.port = self.server.port

    def call(self, method, path, body=None, token=ADMIN, ctype=None):
        return call(self.port, method, path, body, token, ctype)

    def stop(self):
        self.server.stop()


def start_pair(extra=None, store_extra=None) -> list[Side]:
    """[jax side, port side]; `extra(pkg)` returns APIServer keyword
    arguments built from that package's modules, `store_extra(pkg)` the
    MemoryStore's."""
    sides = []
    try:
        for root in ROOTS:
            sides.append(Side(root, extra, store_extra))
    except BaseException:
        for s in sides:
            s.stop()
        raise
    return sides


def call(port: int, method: str, path: str, body=None, token=ADMIN,
         ctype: str | None = None, timeout: float = 20.0):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    headers = {}
    if token is not None:
        headers["Authorization"] = f"Bearer {token}"
    payload = None
    if body is not None:
        payload = body if isinstance(body, (bytes, str)) else json.dumps(body)
        headers["Content-Type"] = ctype or "application/json"
    try:
        conn.request(method, path, body=payload, headers=headers)
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    try:
        parsed = json.loads(data) if data else None
    except ValueError:
        parsed = data.decode(errors="replace")
    return resp.status, parsed


def watch_events(port: int, path: str, want: int, token=ADMIN,
                 deadline_s: float = 20.0) -> list[dict]:
    """Open a watch stream, read until `want` non-bookmark events came
    (or the deadline passed), close it."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=deadline_s)
    conn.request("GET", path, headers={"Authorization": f"Bearer {token}"})
    resp = conn.getresponse()
    assert resp.status == 200, resp.status
    out = []
    deadline = time.monotonic() + deadline_s
    try:
        while len(out) < want and time.monotonic() < deadline:
            line = resp.readline()
            if not line:
                break
            if not line.strip():
                continue
            ev = json.loads(line)
            if ev.get("type") != "BOOKMARK":
                out.append(ev)
    finally:
        conn.close()
    return out


VOLATILE = ("uid", "creationTimestamp")


def normalise(o):
    """A copy of a response with the per-run fields blanked: every `uid`
    and `creationTimestamp`, and the `time` of a managedFields entry."""
    if isinstance(o, dict):
        out = {}
        for k, v in o.items():
            if k in VOLATILE:
                out[k] = "<volatile>"
            elif k == "managedFields" and isinstance(v, list):
                out[k] = [normalise({**e, "time": "<volatile>"}
                                    if isinstance(e, dict) and "time" in e
                                    else e) for e in v]
            else:
                out[k] = normalise(v)
        return out
    if isinstance(o, list):
        return [normalise(v) for v in o]
    return o


def wait_for(pred, timeout: float = 20.0, step: float = 0.01) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(step)
    return pred()
