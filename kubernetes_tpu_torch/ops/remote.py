"""Remote device worker: the scheduler <-> device-worker seam as a process
boundary.

Counterpart of kubernetes_tpu/ops/remote.py, with torch state behind the
same verbs and the same bytes on the wire (a client of either package
talks to a worker of either package).  BASELINE.json's design keeps the
apiserver-facing scheduler untouched and crosses a gRPC shim to a device
worker ("tensorized snapshot request -> assignment response"); the in-tree
precedent for an out-of-process scheduling hook is the HTTP extender
(pkg/scheduler/extender.go).

  * `_WorkerCore` owns a TorchBatchBackend on the WORKER's device (CUDA
    unless the worker was started on the CPU) and serves its device half
    behind the verbs: /init (shape config), /static (the static arrays,
    the victim tensors once preemption engages), /refresh (the dynamic
    state), /step?variant=plain|full|full_small (one packed pod+patch
    buffer in, the result vector out: the claims kernel runs on every
    plain wave), /preempt (one chunk of the dry run: the preemption
    kernel), /census (TorchBatchBackend.device_census on the resident
    state), /timeline (drain the worker's wave timeline) and /health.
    `DeviceWorker` serves them over HTTP/1.1, `GrpcDeviceWorker` over
    gRPC (HTTP/2), each packed buffer one message with identity
    serializers.
  * `RemoteTorchBatchBackend` IS TorchBatchBackend with the methods that
    touch the device overridden to post the same bytes: all host
    bookkeeping (ClusterTensors, encoder, mirror replay, patch diffing,
    chunking, the preemption wave's selection) is shared code.

Fault model, as the JAX package's:

  * worker errors are classified (`state_lost` / `invalid_request` /
    `internal`: HTTP 409 / 400 / 500, gRPC FAILED_PRECONDITION /
    INVALID_ARGUMENT / INTERNAL); the client's ladder tells retryable
    transport faults (TransientSeamError) from fatal protocol errors
    (WorkerProtocolError) from a restarted, state-lost worker
    (WorkerStateLostError);
  * every success is CRC-framed (magic + crc32), and every state-mutating
    post carries a sequence number: the worker caches (last_seq,
    last_response) and answers a duplicate from the cache without
    re-applying the step, so a retry after a corrupt frame is exactly
    once;
  * the worker holds an EPOCH minted at start or reset; a client pinning
    a stale epoch gets `state_lost` and resyncs: re-/init, the
    checkpointed /static and /refresh bodies, then the journal of steps
    posted since the checkpoint.  The kernels are deterministic, so the
    rebuilt resident state is bit-identical to an uninterrupted run's;
  * per-verb deadlines and bounded jittered retries come from
    scheduler/config.RemoteSeamPolicy; exhausted retries raise
    WorkerUnavailableError, a BackendUnavailableError: the scheduler
    requeues the batch and the failover ladder (ops/failover.py) may
    trip its breaker.

The device census is served over the seam: the port's census runs a
step on a clone of the resident state, which lives in the worker's
process, so RemoteTorchBatchBackend.device_census posts /census (the JAX
client lowers the step on its own side and never sends the verb).
"""

from __future__ import annotations

import io
import json
import logging
import os
import random
import struct
import threading
import time
import zlib
from dataclasses import replace
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..component_base import metrics as cbm
from ..component_base import profiling
from ..component_base import timeline as cb_timeline
from ..component_base import tracing
from ..device import resolve_device
from ..models.carry import STATIC_CORE, STATIC_SEL
from ..scheduler.config import RemoteSeamPolicy
from ..scheduler.scheduler import BackendUnavailableError
from .backend import STATIC_VICT, TorchBatchBackend, _to_host
from .flatten import Caps

logger = logging.getLogger(__name__)


def _dump_arrays(arrays: dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _load_arrays(blob: bytes) -> dict[str, np.ndarray]:
    return dict(np.load(io.BytesIO(blob)))


# -- response framing ----------------------------------------------------
# Every SUCCESS payload travels behind an 8-byte header: magic u32 +
# crc32(payload) u32, little-endian.  A flipped bit anywhere surfaces as
# CorruptFrameError (retryable; the worker's seq cache makes the retry
# exactly-once) instead of silently mis-decoding an assignment vector.

_FRAME_MAGIC = 0x5550_544B  # b"KTPU" little-endian
_FRAME_HEADER = struct.Struct("<II")


def _frame(payload: bytes) -> bytes:
    return _FRAME_HEADER.pack(_FRAME_MAGIC,
                              zlib.crc32(payload) & 0xFFFFFFFF) + payload


def _unframe(blob: bytes, verb: str = "?") -> bytes:
    if len(blob) < _FRAME_HEADER.size:
        raise CorruptFrameError(verb, f"short frame ({len(blob)} bytes)")
    magic, crc = _FRAME_HEADER.unpack_from(blob)
    payload = blob[_FRAME_HEADER.size:]
    if magic != _FRAME_MAGIC:
        raise CorruptFrameError(verb, f"bad magic 0x{magic:08x}")
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise CorruptFrameError(verb, "crc mismatch")
    return payload


# -- error ladder --------------------------------------------------------

class SeamError(BackendUnavailableError):
    """Base for remote-seam failures.  Subclasses the scheduler's
    BackendUnavailableError so an error that escapes the backend makes
    the scheduler requeue the batch instead of killing the loop."""

    retryable = False
    error_class = "transport"

    def __init__(self, verb: str, msg: str):
        super().__init__(f"{verb}: {msg}")
        self.verb = verb


class TransientSeamError(SeamError):
    """Connection refused/reset, deadline exceeded, 5xx, UNAVAILABLE:
    worth retrying against the same worker."""

    retryable = True


class CorruptFrameError(TransientSeamError):
    error_class = "corrupt_frame"


class WorkerStateLostError(SeamError):
    """409 / FAILED_PRECONDITION: the worker answered but has no (or the
    wrong incarnation of) resident state — it restarted.  Triggers the
    client-side resync replay, not a plain retry."""

    error_class = "state_lost"


class WorkerProtocolError(SeamError):
    """400 / INVALID_ARGUMENT: the request itself is malformed (shape or
    framing bug).  Deterministic — retrying cannot help."""

    error_class = "protocol"


class WorkerUnavailableError(TransientSeamError):
    """The retry budget is exhausted (or a restarted worker cannot be
    resynced).  What dispatch/resolve raise upward to the scheduler and
    the failover ladder."""

    error_class = "unavailable"


# -- worker side ---------------------------------------------------------

# error classes on the wire (the `class` field of an error body / the
# prefix of a gRPC details string)
E_STATE_LOST = "state_lost"
E_INVALID = "invalid_request"
E_INTERNAL = "internal"

# the /preempt request's pod-side arrays and the response's planes
PREEMPT_IN = ("req", "prio", "untol_hard", "group_idx", "nom_used",
              "nom_np", "active")
PREEMPT_OUT = ("cand", "viol", "highest", "psum", "nvic", "victims",
               "overflow")


class WorkerError(Exception):
    """A classified handler failure; the serving layer maps error_class
    to the transport's status vocabulary."""

    def __init__(self, error_class: str, msg: str):
        super().__init__(msg)
        self.error_class = error_class


def _new_epoch() -> int:
    # incarnation token, not a counter: two workers (or one worker
    # restarted) must not collide, so draw it from the OS
    return int.from_bytes(os.urandom(4), "little") | 1


def victim_bools(words: np.ndarray, V: int) -> np.ndarray:
    """Victim words int32[P, N] (bit s = slot s) -> bool[P, N, V], the
    /preempt response's `victims` (the JAX program's form)."""
    w = words.astype(np.int64) & 0xFFFFFFFF
    return ((w[..., None] >> np.arange(V, dtype=np.int64)) & 1).astype(bool)


def victim_words(victims: np.ndarray) -> np.ndarray:
    """bool[P, N, V] -> int64[P, N] words (bit s = slot s), the form
    TorchBatchBackend.preempt_batch reads."""
    V = victims.shape[-1]
    return (victims.astype(np.int64)
            << np.arange(V, dtype=np.int64)).sum(-1)


class _WorkerCore:
    """The device half of TorchBatchBackend, transport-agnostic: both the
    HTTP DeviceWorker and the gRPC GrpcDeviceWorker serve exactly these
    verbs over the same byte payloads.

    The backend lives on `device` (CUDA unless the worker is started on
    the CPU), never on one the client names.  `claims_noise` is the plain
    step's tie-break rule for a client whose /init names none (the JAX
    package's client sends none).  State beyond the backend: `_epoch`
    (incarnation token; a client pinning a stale epoch gets `state_lost`)
    and the one-deep dedup cache `(_last_seq, _last_resp)`: the client is
    a single ordered writer, so one slot makes every retried post
    exactly-once.

    Tracing: a verb served under a sampled W3C traceparent opens a
    `worker.<verb>` span in the worker's own TracerProvider, parented by
    ids into the client's batch trace (served at /debug/traces).  The
    wave timeline is always on (bounded, idle when nobody drains it):
    /step records `device-step` from the launch to the result's event."""

    def __init__(self, device=None, claims_noise: str = "sin"):
        self.device = resolve_device(device)
        self.claims_noise = claims_noise
        self._lock = threading.Lock()
        self._backend: TorchBatchBackend | None = None
        self._epoch = _new_epoch()
        self._last_seq: int | None = None
        self._last_resp = None
        self.tracer_provider = tracing.TracerProvider()
        self._tracer = self.tracer_provider.tracer("tpu-worker")
        self.timeline = cb_timeline.Timeline(enabled=True, proc="worker")
        # verbs served, by verb (the chip smoke's read that /step and
        # /preempt ran on this worker)
        self.served: dict[str, int] = {}

    def reset(self) -> None:
        """Simulate a crash+restart in place: resident state and the
        dedup cache are gone; a fresh epoch is minted (the chaos harness's
        kill, DeviceWorker.simulate_restart)."""
        with self._lock:
            self._backend = None
            self._epoch = _new_epoch()
            self._last_seq = None
            self._last_resp = None

    def handle(self, path: str, body: bytes, epoch: int | None = None,
               seq: int | None = None, traceparent: str | None = None):
        """Returns (payload, worker_epoch); raises WorkerError with an
        error class on any failure.  A malformed traceparent is ignored
        (W3C: never fail the request over telemetry)."""
        ctx = tracing.parse_traceparent(traceparent)
        if ctx is None or not ctx.sampled:
            return self._handle(path, body, epoch, seq)
        with self._tracer.start_span(
                "worker." + path.lstrip("/").split("?", 1)[0],
                context=ctx) as span:
            span.set_attribute("process", "worker")
            span.set_attribute("verb", path)
            span.set_attribute("bytes", len(body))
            try:
                return self._handle(path, body, epoch, seq)
            except WorkerError as e:
                span.add_event("worker_error", error_class=e.error_class,
                               error=str(e))
                raise

    def _handle(self, path: str, body: bytes, epoch: int | None = None,
                seq: int | None = None):
        with self._lock:
            verb = path.split("?", 1)[0]
            self.served[verb] = self.served.get(verb, 0) + 1
            if path == "/health":
                # liveness + incarnation, served before /init and without
                # consuming a seq: the breaker's half-open probe
                return ({"ok": True, "epoch": self._epoch,
                         "initialized": self._backend is not None},
                        self._epoch)
            if path == "/timeline":
                # the drain, served like /health; rows are wall-anchored
                # by this process's clock, so the client ingests them
                return ({"intervals": self.timeline.intervals(drain=True)},
                        self._epoch)
            if seq is not None and seq == self._last_seq \
                    and self._last_resp is not None:
                # duplicate delivery (a retry after a lost or corrupt
                # response): the cached response, NOT a second step
                return (self._last_resp, self._epoch)
            if path == "/init":
                out = self._init(body)
            else:
                if self._backend is None:
                    raise WorkerError(E_STATE_LOST,
                                      "worker not initialized (/init first)")
                if epoch is not None and epoch != self._epoch:
                    raise WorkerError(
                        E_STATE_LOST,
                        f"epoch mismatch (client {epoch}, worker "
                        f"{self._epoch}): worker restarted")
                out = self._apply(path, body)
            if seq is not None:
                self._last_seq, self._last_resp = seq, out
            return (out, self._epoch)

    def _init(self, body: bytes):
        try:
            cfg = json.loads(body)
            caps = Caps(**cfg["caps"])
        except (ValueError, TypeError, KeyError) as e:
            raise WorkerError(E_INVALID, f"bad /init body: {e!r}")
        kind = cfg.get("backend_kind", "tpu")
        if kind != "tpu":
            raise WorkerError(
                E_INVALID, f"worker backend kind {kind!r} unsupported "
                "(only 'tpu'; sharded is mesh-local)")
        try:
            b = TorchBatchBackend(
                caps, batch_size=cfg["batch_size"],
                k_cap=cfg.get("k_cap", 1024), device=self.device,
                claims_noise=cfg.get("claims_noise") or self.claims_noise,
                weights=cfg.get("weights"),
                full_batch_cap=cfg.get("full_batch_cap"),
                full_main_waves=cfg.get("full_main_waves") or 0)
            b._ensure_full()
            if b.full_main_waves:
                b._ensure_full_small()
            b._ensure_plain()
            if self.device.type == "cuda":
                from . import _build, kernels
                _build.build()
                kernels._kernel_lib()
        except Exception as e:  # noqa: BLE001 — classify, don't die
            self._backend = None
            raise WorkerError(E_INTERNAL, f"/init failed: {e!r}")
        self._backend = b
        return {"ok": True, "full_cap": b.full_cap, "epoch": self._epoch}

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        # sync-point: a pageable host-to-device copy (between waves)
        return torch.tensor(a, device=self.device)

    def _apply(self, path: str, body: bytes):
        b = self._backend
        if path == "/static":
            try:
                arrays = _load_arrays(body)
                static_node = {k: self._dev(arrays[k]) for k in STATIC_CORE}
                static_sel = {k: self._dev(arrays[k]) for k in STATIC_SEL}
            except (ValueError, KeyError, OSError) as e:
                raise WorkerError(E_INVALID, f"bad /static body: {e!r}")
            b._static_node = static_node
            # both halves resident: the worker's host tensors are empty,
            # so nothing may rebuild them from there (the census reads
            # the resident arrays while their version is current)
            b._static_sel = static_sel
            b._static_version = b.tensors.static_version
            if all(k in arrays for k in STATIC_VICT):
                # the victim tensors ride the same body once the client's
                # preemption path engaged
                from ..models.preempt import live_slot_cap
                b._static_vict = {k: self._dev(arrays[k])
                                  for k in STATIC_VICT}
                b._vict_live_cap = live_slot_cap(arrays["vict_prio"])
            return {"ok": True}
        if path == "/refresh":
            try:
                arrays = _load_arrays(body)
            except (ValueError, OSError) as e:
                raise WorkerError(E_INVALID, f"bad /refresh body: {e!r}")
            b._state = {k: self._dev(v) for k, v in arrays.items()}
            return {"ok": True}
        if path.startswith("/step"):
            return self._step(b, path.rsplit("=", 1)[-1], body)
        if path == "/preempt":
            return self._preempt(b, body)
        if path == "/census":
            return self._census(b, body)
        raise WorkerError(E_INVALID, f"unknown verb {path!r}")

    def _census(self, b: TorchBatchBackend, body: bytes):
        # the census steps a clone of the resident state: read-only, so a
        # retry or a replay cannot double-apply anything.  The census
        # pod's request comes from the client's mirror (the worker keeps
        # no host copy of the state)
        if b._state is None or b._static_node is None:
            raise WorkerError(E_STATE_LOST, "no resident static or dynamic "
                              "state (/static and /refresh first)")
        try:
            cfg = json.loads(body)
            variants = tuple(cfg["variants"])
            req = np.asarray(cfg["req"], np.float32)
        except (ValueError, TypeError, KeyError) as e:
            raise WorkerError(E_INVALID, f"bad /census body: {e!r}")
        if req.shape != (b.caps.r,):
            raise WorkerError(E_INVALID, f"bad /census body: req of shape "
                              f"{req.shape}, caps take ({b.caps.r},)")
        try:
            return b.device_census(variants, req=req)
        except Exception as e:  # noqa: BLE001 — classify, don't die
            raise WorkerError(E_INTERNAL, f"/census failed: {e!r}")

    def _step(self, b: TorchBatchBackend, variant: str, body: bytes):
        specs = {"plain": b._spec_plain, "full": b._spec_full}
        if variant == "full_small":
            b._ensure_full_small()
            specs["full_small"] = b._spec_full_small
        spec = specs.get(variant)
        if spec is None:
            raise WorkerError(E_INVALID, f"unknown variant {variant!r}")
        if len(body) != 4 * spec.total:
            raise WorkerError(
                E_INVALID, f"malformed /step body: {len(body)} bytes, the "
                f"{variant} step takes {4 * spec.total}")
        if b._static_node is None or b._state is None:
            raise WorkerError(E_STATE_LOST, "no resident static or dynamic "
                              "state (/static and /refresh first)")
        staged = b._stage_buf(spec.total)
        try:
            # into the backend's (pinned) staging ring, whose upload is
            # asynchronous, not a read-only view of the request bytes
            staged.array[:] = np.frombuffer(body, np.float32)
            t0 = time.monotonic()
            res = b._device_step(variant, staged)
            # sync-point: the worker waits for the result's event
            out = res.get()
            self.timeline.record("device-step", t0, time.monotonic())
            return out.astype(np.int32).tobytes()
        except WorkerError:
            raise
        except (ValueError, TypeError, KeyError, IndexError) as e:
            raise WorkerError(E_INVALID, f"malformed /step body: {e!r}")
        except Exception as e:  # noqa: BLE001 — classify, don't die
            raise WorkerError(E_INTERNAL, f"/step failed: {e!r}")
        finally:
            b._stage_pins.discard(id(staged))

    def _preempt(self, b: TorchBatchBackend, body: bytes):
        # the dry run against the RESIDENT static, victim and dynamic
        # arrays; read-only (never journaled client-side), so a retry or a
        # post-resync replay cannot double-apply anything
        if b._static_vict is None:
            raise WorkerError(E_STATE_LOST, "no resident victim tensors "
                              "(/static with a victim section first)")
        if b._state is None or b._static_node is None:
            raise WorkerError(E_STATE_LOST, "no resident dynamic state "
                              "(/refresh first)")
        try:
            arrays = _load_arrays(body)
            planes = _to_host(*b._preempt_step(
                {k: arrays[k] for k in PREEMPT_IN}))
        except WorkerError:
            raise
        except (ValueError, TypeError, KeyError, IndexError, OSError) as e:
            raise WorkerError(E_INVALID, f"malformed /preempt body: {e!r}")
        except Exception as e:  # noqa: BLE001 — classify, don't die
            raise WorkerError(E_INTERNAL, f"/preempt failed: {e!r}")
        V = b._static_vict["vict_prio"].shape[1]
        planes[5] = victim_bools(planes[5], V)
        return _dump_arrays(dict(zip(PREEMPT_OUT, planes)))


class DeviceWorker:
    """The device half of TorchBatchBackend behind HTTP, with the
    observability pages: /debug/traces, /debug/timeline (?format=chrome),
    /debug/profile, /debug/kernels (the hand kernels' launches in this
    process and the verbs served; ?reset=1 zeroes the launches) and
    /metrics."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, device=None,
                 claims_noise: str = "sin"):
        self._core = _WorkerCore(device, claims_noise)
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                logger.debug("tpu-worker: " + fmt, *args)

            def _body(self) -> bytes:
                n = int(self.headers.get("Content-Length") or 0)
                return self.rfile.read(n) if n else b""

            def _reply(self, code: int, body: bytes = b"{}",
                       ctype: str = "application/json",
                       epoch: int | None = None) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                if epoch is not None:
                    self.send_header("X-KTPU-Epoch", str(epoch))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/debug/traces":
                    self._reply(200, server._core.tracer_provider
                                .debug_traces_json().encode())
                elif self.path.startswith("/debug/timeline"):
                    tl = server._core.timeline
                    if "chrome" in self.path:
                        body = json.dumps(tl.to_chrome_trace()).encode()
                    else:
                        body = tl.debug_json().encode()
                    self._reply(200, body)
                elif self.path == "/debug/profile":
                    self._reply(200, profiling.default_host_profiler
                                .collapsed().encode(), "text/plain")
                elif self.path == "/metrics":
                    self._reply(200, cbm.default_registry.expose().encode(),
                                "text/plain; version=0.0.4")
                elif self.path.startswith("/debug/kernels"):
                    # this process's hand-kernel launches (ops/kernels.py
                    # LAUNCHES) and the verbs served; ?reset=1 zeroes the
                    # launches after reading them
                    from . import kernels
                    body = json.dumps({"launches": dict(kernels.LAUNCHES),
                                       "served": dict(server._core.served)})
                    if "reset=1" in self.path:
                        for k in kernels.LAUNCHES:
                            kernels.LAUNCHES[k] = 0
                    self._reply(200, body.encode())
                elif self.path in ("/healthz", "/health"):
                    self._reply(200, json.dumps({"ok": True}).encode())
                else:
                    self._reply(404, b'{"error": "not found"}')

            def do_POST(self):
                try:
                    epoch = self.headers.get("X-KTPU-Epoch")
                    seq = self.headers.get("X-KTPU-Seq")
                    out, w_epoch = server._core.handle(
                        self.path, self._body(),
                        epoch=int(epoch) if epoch is not None else None,
                        seq=int(seq) if seq is not None else None,
                        traceparent=self.headers.get("X-KTPU-Traceparent"))
                except WorkerError as e:
                    code = {E_STATE_LOST: 409, E_INVALID: 400}.get(
                        e.error_class, 500)
                    logger.warning("tpu-worker: %s -> %d %s: %s",
                                   self.path, code, e.error_class, e)
                    self._reply(code, json.dumps(
                        {"error": str(e), "class": e.error_class}).encode())
                    return
                except Exception as e:  # noqa: BLE001 — report, don't die
                    logger.exception("tpu-worker: %s failed", self.path)
                    self._reply(500, json.dumps(
                        {"error": str(e), "class": E_INTERNAL}).encode())
                    return
                if not isinstance(out, bytes):
                    out = json.dumps(out or {}).encode()
                self._reply(200, _frame(out), "application/octet-stream",
                            epoch=w_epoch)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self._thread: threading.Thread | None = None

    @property
    def url(self) -> str:
        return f"http://{self.httpd.server_address[0]}:{self.port}"

    @property
    def tracer_provider(self):
        """The worker-side span flight recorder (/debug/traces; bench
        --trace merges it into the Chrome export)."""
        return self._core.tracer_provider

    @property
    def core(self) -> _WorkerCore:
        return self._core

    def start(self) -> "DeviceWorker":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="tpu-worker", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()

    def simulate_restart(self) -> None:
        """Chaos hook: drop resident state and mint a new epoch, keeping
        the socket (protocol-identical to a crash and a same-port
        restart)."""
        self._core.reset()


# gRPC method name <-> worker verb; the messages are the packed byte
# buffers themselves (identity serializers, no protobuf copy)
GRPC_SERVICE = "ktpu.TPUWorker"
_GRPC_VERBS = {
    "Init": "/init",
    "Static": "/static",
    "Refresh": "/refresh",
    "StepFull": "/step?variant=full",
    "StepFullSmall": "/step?variant=full_small",
    "StepPlain": "/step?variant=plain",
    "Preempt": "/preempt",
    "Census": "/census",
    "Timeline": "/timeline",
    "Health": "/health",
}
_GRPC_MSG_CAP = 512 << 20
_GRPC_OPTIONS = [
    ("grpc.max_receive_message_length", _GRPC_MSG_CAP),
    ("grpc.max_send_message_length", _GRPC_MSG_CAP),
]


def grpc_available() -> bool:
    """Whether the grpc package imports here (the gRPC seam needs it;
    the HTTP seam does not)."""
    import importlib.util
    return importlib.util.find_spec("grpc") is not None


class GrpcDeviceWorker:
    """The device half of TorchBatchBackend behind gRPC (HTTP/2): the
    same verbs and payloads as DeviceWorker (a shared _WorkerCore), each
    packed buffer one message.  grpc is imported here, not at module
    import."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, device=None,
                 claims_noise: str = "sin"):
        import grpc

        self._core = _WorkerCore(device, claims_noise)
        core = self._core
        status_of = {E_STATE_LOST: grpc.StatusCode.FAILED_PRECONDITION,
                     E_INVALID: grpc.StatusCode.INVALID_ARGUMENT,
                     E_INTERNAL: grpc.StatusCode.INTERNAL}

        def _unary(verb_path):
            def call(request: bytes, context) -> bytes:
                md = dict(context.invocation_metadata() or ())
                epoch = md.get("ktpu-epoch")
                seq = md.get("ktpu-seq")
                try:
                    out, _w_epoch = core.handle(
                        verb_path, request,
                        epoch=int(epoch) if epoch is not None else None,
                        seq=int(seq) if seq is not None else None,
                        traceparent=md.get("ktpu-traceparent"))
                except WorkerError as e:
                    logger.warning("tpu-worker(grpc): %s -> %s: %s",
                                   verb_path, e.error_class, e)
                    context.abort(
                        status_of.get(e.error_class,
                                      grpc.StatusCode.INTERNAL),
                        f"{e.error_class}: {e}")
                except Exception as e:  # noqa: BLE001 — report, don't die
                    logger.exception("tpu-worker(grpc): %s failed",
                                     verb_path)
                    context.abort(grpc.StatusCode.INTERNAL,
                                  f"{E_INTERNAL}: {e}")
                if isinstance(out, bytes):
                    return _frame(out)
                return _frame(json.dumps(out or {}).encode())
            return call

        handlers = {
            name: grpc.unary_unary_rpc_method_handler(_unary(path))
            for name, path in _GRPC_VERBS.items()}
        from concurrent import futures
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=4,
                                       thread_name_prefix="tpu-worker-grpc"),
            options=_GRPC_OPTIONS)
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(GRPC_SERVICE, handlers),))
        self.port = self._server.add_insecure_port(f"{host}:{port}")
        self._host = host

    @property
    def url(self) -> str:
        return f"grpc://{self._host}:{self.port}"

    @property
    def tracer_provider(self):
        """See DeviceWorker.tracer_provider."""
        return self._core.tracer_provider

    @property
    def core(self) -> _WorkerCore:
        return self._core

    def start(self) -> "GrpcDeviceWorker":
        self._server.start()
        return self

    def stop(self) -> None:
        self._server.stop(grace=1.0).wait()

    def simulate_restart(self) -> None:
        """Chaos hook: see DeviceWorker.simulate_restart."""
        self._core.reset()


def make_worker(kind: str = "http", host: str = "127.0.0.1", port: int = 0,
                device=None, claims_noise: str = "sin"):
    """A DeviceWorker ("http") or GrpcDeviceWorker ("grpc"), not started."""
    if kind not in ("http", "grpc"):
        raise ValueError(f"worker kind {kind!r}: 'http' or 'grpc'")
    cls = GrpcDeviceWorker if kind == "grpc" else DeviceWorker
    return cls(host, port, device=device, claims_noise=claims_noise)


# -- client transports ---------------------------------------------------
# One interface: post(verb, body, timeout=, epoch=, seq=) -> framed bytes,
# raising the classified SeamError ladder.  ops/faults.py FaultyTransport
# wraps either implementation.

class _HttpTransport:
    """Client side of the HTTP/1.1 seam: one pooled keep-alive connection
    per thread (http.client connections are not thread-safe), retried
    ONCE on a stale keep-alive socket; the retry is safe even mid-flight
    because the worker dedups by (epoch, seq).  http.client does not
    raise on 4xx/5xx, so the status is classified here."""

    kind = "http"

    def __init__(self, base_url: str):
        import http.client as _hc
        import urllib.parse as _up

        self.base_url = base_url
        parts = _up.urlsplit(base_url)
        self._hc = _hc
        self._host = parts.hostname or "127.0.0.1"
        self._port = parts.port or 80
        self._prefix = parts.path.rstrip("/")
        self._local = threading.local()
        self._lock = threading.Lock()
        self._conns: list = []  # every conn ever pooled, for close()

    def _conn(self, timeout: float):
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = self._hc.HTTPConnection(self._host, self._port,
                                           timeout=timeout)
            self._local.conn = conn
            with self._lock:
                self._conns.append(conn)
        # this request's deadline: on the object for the next connect and
        # on a live socket
        conn.timeout = timeout
        if conn.sock is not None:
            conn.sock.settimeout(timeout)
        return conn

    def _drop_conn(self) -> None:
        conn = getattr(self._local, "conn", None)
        self._local.conn = None
        if conn is not None:
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)
            try:
                conn.close()
            except OSError:
                pass

    def post(self, verb: str, body: bytes, *, timeout: float,
             epoch: int | None = None, seq: int | None = None,
             traceparent: str | None = None) -> bytes:
        headers = {"Content-Type": "application/octet-stream"}
        if epoch is not None:
            headers["X-KTPU-Epoch"] = str(epoch)
        if seq is not None:
            headers["X-KTPU-Seq"] = str(seq)
        if traceparent is not None:
            headers["X-KTPU-Traceparent"] = traceparent
        last: Exception | None = None
        for _attempt in range(2):  # the second only for a stale socket
            conn = self._conn(timeout)
            try:
                conn.request("POST", self._prefix + verb, body=body,
                             headers=headers)
                resp = conn.getresponse()
                raw = resp.read()
                status = resp.status
            except (self._hc.HTTPException, OSError) as e:
                self._drop_conn()
                last = e
                continue
            if status < 400:
                return raw
            try:
                info = json.loads(raw)
                cls, msg = info.get("class", ""), info.get("error", "")
            except (ValueError, UnicodeDecodeError):
                cls, msg = "", repr(raw[:200])
            if status == 409 or cls == E_STATE_LOST:
                raise WorkerStateLostError(verb, msg) from None
            if 400 <= status < 500:
                raise WorkerProtocolError(
                    verb, f"HTTP {status} ({cls or 'error'}): {msg}"
                ) from None
            raise TransientSeamError(
                verb, f"HTTP {status} ({cls or 'error'}): {msg}") from None
        # both attempts died on the wire: the network or the worker
        # process, not the request
        raise TransientSeamError(verb, repr(last)) from None

    def close(self) -> None:
        with self._lock:
            conns, self._conns = self._conns, []
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass


class _GrpcTransport:
    """Client side of the gRPC seam: verb path -> unary call with
    identity (bytes) serializers; epoch/seq ride call metadata."""

    kind = "grpc"

    def __init__(self, target: str):
        import grpc

        self._grpc = grpc
        self._channel = grpc.insecure_channel(target,
                                              options=_GRPC_OPTIONS)
        self._calls = {
            path: self._channel.unary_unary(f"/{GRPC_SERVICE}/{name}")
            for name, path in _GRPC_VERBS.items()}

    def post(self, verb: str, body: bytes, *, timeout: float,
             epoch: int | None = None, seq: int | None = None,
             traceparent: str | None = None) -> bytes:
        md = []
        if epoch is not None:
            md.append(("ktpu-epoch", str(epoch)))
        if seq is not None:
            md.append(("ktpu-seq", str(seq)))
        if traceparent is not None:
            md.append(("ktpu-traceparent", traceparent))
        try:
            return self._calls[verb](body, timeout=timeout,
                                     metadata=tuple(md) or None)
        except self._grpc.RpcError as e:
            sc = self._grpc.StatusCode
            code = e.code()
            details = e.details() or ""
            if (code == sc.FAILED_PRECONDITION
                    or details.startswith(E_STATE_LOST)):
                raise WorkerStateLostError(verb, details) from None
            if code in (sc.INVALID_ARGUMENT, sc.UNIMPLEMENTED,
                        sc.UNAUTHENTICATED, sc.PERMISSION_DENIED):
                raise WorkerProtocolError(
                    verb, f"{code.name}: {details}") from None
            # UNAVAILABLE / DEADLINE_EXCEEDED / INTERNAL / UNKNOWN / ...
            raise TransientSeamError(
                verb, f"{code.name}: {details}") from None

    def close(self) -> None:
        self._channel.close()


def transport_for(worker_url: str):
    url = worker_url.rstrip("/")
    if url.startswith("grpc://"):
        return _GrpcTransport(url[len("grpc://"):])
    return _HttpTransport(url)


# the /refresh (and checkpoint) body: exactly the mirror's keys
_REFRESH_KEYS = ("used", "used_nz", "npods", "port_mask", "cd_sg", "cd_asg")


class _Posted:
    """A /step's result vector, already on the host: the _Result
    interface (get()) resolve() reads."""

    def __init__(self, host: np.ndarray):
        self.host = host

    def get(self) -> np.ndarray:
        return self.host


class RemoteTorchBatchBackend(TorchBatchBackend):
    """TorchBatchBackend whose device half lives in a device worker.

    Everything but the device-touching methods is inherited: tensors,
    encoder, mirror replay, patch diffing, chunking, FLUSH_FIRST and the
    preemption wave's selection run here, and the packed bytes a local
    card would get go over the wire.  The client holds no device state:
    its host-side torch work (the legacy tier's candidate ranking) runs
    on the CPU, and full_batch_cap=None lets the worker size the full
    variant's cap on its own device.

    Resilience (module docstring): per-verb deadlines, bounded jittered
    retries, seq-deduped exactly-once posts, and a checkpoint + journal:

      * checkpoint — at the first dispatch after the pipeline drains, the
        host mirror as a ready-to-post /refresh body (the mirror IS the
        device state when nothing is unresolved), and the journal
        cleared; /static and /refresh posts are checkpoints themselves;
      * journal — every /step body posted since the checkpoint.  On
        `state_lost`: re-/init, the checkpointed static and refresh, the
        journal, then the failed post under a fresh seq;
      * degradation — with no checkpoint or an overflowed journal
        (journal_cap), WorkerUnavailableError: the scheduler requeues the
        batch and the next dispatch rebuilds the worker's state from the
        authoritative tensors.  Slower, never wrong."""

    census_kind = "remote"

    def __init__(self, worker_url: str, caps: Caps | None = None,
                 batch_size: int = 256,
                 weights: dict[str, float] | None = None,
                 k_cap: int = 1024, full_batch_cap: int | None = None,
                 timeout: float | None = None,
                 policy: RemoteSeamPolicy | None = None,
                 transport=None, rng_seed: int = 0,
                 claims_noise: str = "sin", full_main_waves: int = 0):
        self.worker_url = worker_url.rstrip("/")
        if policy is None:
            policy = RemoteSeamPolicy()
        if timeout is not None:
            # one deadline for every verb
            policy = replace(policy, init_timeout=timeout,
                             static_timeout=timeout, refresh_timeout=timeout,
                             step_timeout=timeout)
        self.policy = policy
        self.timeout = policy.step_timeout
        self._rng = random.Random(rng_seed)
        self._transport = (transport if transport is not None
                           else transport_for(self.worker_url))
        self._seq = 0
        self._epoch: int | None = None
        self._needs_reinit = False
        self._ckpt_static_body: bytes | None = None
        self._ckpt_refresh_body: bytes | None = None
        self._journal: list[tuple[str, bytes]] = []
        self._journal_overflow = False
        self.seam_stats = {"retries": 0, "resyncs": 0, "state_lost": 0,
                           "corrupt_frames": 0, "giveups": 0}
        super().__init__(caps, batch_size=batch_size, k_cap=k_cap,
                         device="cpu", claims_noise=claims_noise,
                         weights=weights,
                         full_batch_cap=full_batch_cap or batch_size,
                         full_main_waves=full_main_waves)
        self._init_body = json.dumps({
            "caps": vars(self.caps), "batch_size": batch_size,
            "weights": weights, "k_cap": k_cap, "backend_kind": "tpu",
            "full_batch_cap": full_batch_cap,
            "full_main_waves": full_main_waves,
            "claims_noise": claims_noise}).encode()
        got = json.loads(self._post("/init", self._init_body))
        self.full_cap = got["full_cap"]
        self._epoch = got.get("epoch")

    def device_census(self, variants: tuple = ("full", "plain")) -> dict:
        """TorchBatchBackend.device_census run by the worker on its
        resident state (/census): the static arrays and the state are
        made resident first, as a dispatch would, and the census pod's
        request is this side's (from the mirror).  Equal to the
        in-process census on the same state but for device_ms, which the
        worker's device reads."""
        with self._lock:
            self._seam_prepare()
            if (self._static_node is None
                    or self._static_version != self.tensors.static_version):
                self._upload_static()
            if self._state is None:
                self._full_refresh(*self.tensors.domain_base_counts())
            req = self._census_req()
        body = json.dumps({"variants": list(variants),
                           "req": [float(x) for x in req]}).encode()
        return json.loads(self._call("/census", body, None))

    # -- resilient transport ---------------------------------------------

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def _post_once(self, verb: str, body: bytes, seq: int | None) -> bytes:
        # the scheduler's current (root) span rides the post as a W3C
        # traceparent, so the worker's verb spans parent into the client
        # trace, after retries and resyncs too
        span = tracing.current_span()
        tp = (span.traceparent()
              if span is not None and span.sampled else None)
        out = self._transport.post(verb, body,
                                   timeout=self.policy.timeout_for(verb),
                                   epoch=self._epoch, seq=seq,
                                   traceparent=tp)
        try:
            return _unframe(out, verb)
        except CorruptFrameError:
            self.seam_stats["corrupt_frames"] += 1
            raise

    def _call(self, verb: str, body: bytes, seq: int | None,
              allow_resync: bool = True) -> bytes:
        """One logical post: bounded retries with exponential backoff and
        seeded jitter for transient faults, a transparent resync for a
        state-lost worker, an immediate raise for protocol errors."""
        p = self.policy
        attempt = 0
        resyncs = 0
        need_resync = False
        while True:
            try:
                if need_resync:
                    need_resync = False
                    self._resync()
                return self._post_once(verb, body, seq)
            except WorkerStateLostError:
                self.seam_stats["state_lost"] += 1
                if not allow_resync or verb == "/init":
                    raise
                resyncs += 1
                if resyncs > p.resync_attempts:
                    self.seam_stats["giveups"] += 1
                    raise
                need_resync = True
                self._seam_event("seam_resync", verb=verb, resync=resyncs)
                # the failed post replays under a FRESH seq: the old
                # seq's dedup slot died with the worker's state
                seq = self._next_seq() if seq is not None else None
            except WorkerUnavailableError:
                raise  # a nested resync already gave up
            except TransientSeamError as e:
                attempt += 1
                if attempt > p.max_retries:
                    self.seam_stats["giveups"] += 1
                    raise WorkerUnavailableError(
                        verb, f"retries exhausted "
                        f"({p.max_retries}): {e}") from e
                self.seam_stats["retries"] += 1
                self._seam_event("seam_retry", verb=verb, attempt=attempt,
                                 error_class=e.error_class)
                time.sleep(p.backoff(attempt, self._rng))

    @staticmethod
    def _seam_event(name: str, **attrs) -> None:
        span = tracing.current_span()
        if span is not None and span.sampled:
            span.add_event(name, **attrs)

    def _post(self, verb: str, body: bytes) -> bytes:
        """A state-mutating post: one seq for its lifetime (retries dedup
        worker-side); successful steps are journaled for a resync."""
        out = self._call(verb, body, self._next_seq())
        if verb.startswith("/step"):
            self._journal.append((verb, body))
            if len(self._journal) > self.policy.journal_cap:
                # no transparent replay any more: the next quiescent
                # dispatch re-checkpoints; a restart before then degrades
                self._journal_overflow = True
                del self._journal[:]
        return out

    def _reinit(self) -> None:
        got = json.loads(self._call("/init", self._init_body,
                                    self._next_seq(), allow_resync=False))
        if got["full_cap"] != self.full_cap:
            raise WorkerProtocolError(
                "/init", f"full_cap changed across restart "
                f"({self.full_cap} -> {got['full_cap']})")
        self._epoch = got.get("epoch")

    def _resync(self) -> None:
        """The worker lost its resident state (restart): rebuild it to
        exactly the post-last-successful-step state and carry on."""
        self.seam_stats["resyncs"] += 1
        if (self._ckpt_static_body is None
                or self._ckpt_refresh_body is None or self._journal_overflow):
            self._degrade()
            raise WorkerUnavailableError(
                "/resync", "worker restarted with no replayable checkpoint; "
                "batch requeued, device state rebuilds next dispatch")
        logger.warning(
            "remote seam: worker state lost; resyncing (init + static + "
            "refresh + %d journaled steps)", len(self._journal))
        self._epoch = None  # accept whichever incarnation answers
        self._reinit()
        self._call("/static", self._ckpt_static_body, self._next_seq(),
                   allow_resync=False)
        self._call("/refresh", self._ckpt_refresh_body, self._next_seq(),
                   allow_resync=False)
        for verb, body in self._journal:
            self._call(verb, body, self._next_seq(), allow_resync=False)

    def _degrade(self) -> None:
        """No replayable checkpoint: forget the device state so the next
        dispatch re-inits and uploads static + refresh from the
        authoritative tensors (the failed batch's pods were requeued,
        never bound)."""
        self._needs_reinit = True
        self._epoch = None
        self._static_node = None
        self._state = None
        self._mirror = None
        self._ckpt_refresh_body = None
        del self._journal[:]
        self._journal_overflow = False

    # -- checkpointing hooks ---------------------------------------------

    def dispatch(self, pod_infos, snapshot):
        with self._lock:
            self._seam_prepare()
        return super().dispatch(pod_infos, snapshot)

    def _seam_prepare(self) -> None:
        if self._needs_reinit:
            self._reinit()
            self._needs_reinit = False
        if ((self._journal or self._journal_overflow)
                and not self._unresolved and self._mirror is not None):
            # quiescent: every dispatched step was resolved and replayed
            # into the mirror, so the mirror == the worker's state (gen
            # rides along: G_ckpt + len(journal) == the client's counter)
            self._ckpt_refresh_body = _dump_arrays(
                {**{k: self._mirror[k] for k in _REFRESH_KEYS},
                 "gen": np.asarray(self._gen, np.int32)})
            del self._journal[:]
            self._journal_overflow = False

    def health(self, timeout: float | None = None) -> dict:
        """One /health round trip (raises the SeamError ladder): the
        failover breaker's half-open probe."""
        out = self._transport.post(
            "/health", b"",
            timeout=timeout if timeout is not None
            else self.policy.health_timeout,
            epoch=None, seq=None)
        return json.loads(_unframe(out, "/health"))

    def close(self) -> None:
        self._transport.close()

    # -- the device seam, remoted ---------------------------------------

    def _ensure_full(self):
        if self._spec_full is None:
            from ..models.assign import PackSpec
            self._spec_full = PackSpec(self.caps, self.full_cap, self._k_cap)
        return None  # the worker holds the step

    def _ensure_full_small(self):
        if self._spec_full_small is None:
            from ..models.assign import PackSpec
            self._spec_full_small = PackSpec(self.caps, self._retry_cap(),
                                             self._k_cap)
        return None

    def _ensure_plain(self):
        if self._spec_plain is None:
            from ..models.assign import PackSpec
            self._spec_plain = PackSpec(self.caps, self.batch_size,
                                        self._k_cap, plain=True)
        return None

    def _device_step(self, variant: str, staged, clock=None) -> _Posted:
        out = self._post(f"/step?variant={variant}", staged.array.tobytes())
        self._gen += 1  # the worker's step computed state.gen + 1
        res = _Posted(np.frombuffer(out, np.int32))
        if clock is not None:
            clock.results.append(res)
        return res

    def _upload_static(self) -> None:
        t = self.tensors
        arrays = {k: getattr(t, k) for k in STATIC_CORE + STATIC_SEL}
        if self._static_vict is not None:
            # once preemption engaged the victim section rides every
            # static body: the body is the resync checkpoint, so a
            # restarted worker gets the victim tensors back too
            arrays.update({k: getattr(t, k) for k in STATIC_VICT})
        body = _dump_arrays(arrays)
        self._post("/static", body)
        self._ckpt_static_body = body  # the post IS the checkpoint
        self._static_node = True  # sentinel: the worker holds the arrays
        t.static_dirty_rows = set()
        t.static_full = False
        self._static_version = t.static_version

    def _ensure_vict(self) -> None:
        """The victim tensors travel inside a full /static body (no wire
        patch path: preemption waves are rare and the body is the
        checkpoint)."""
        t = self.tensors
        t.refresh_victims()
        if (self._static_vict is not None and not t.vict_full
                and self._vict_version == t.vict_version):
            return
        self._static_vict = True  # sentinel: the worker holds the arrays
        self._upload_static()
        t.vict_full = False
        self._vict_version = t.vict_version

    def _preempt_step(self, body: dict):
        """One padded preemptor chunk to the worker's /preempt verb (the
        dry-run kernel against ITS resident arrays).  Read-only, never
        journaled: a state-lost worker resyncs (replaying the
        victim-carrying static checkpoint) and the re-post answers the
        same."""
        out = _load_arrays(self._post("/preempt", _dump_arrays(body)))
        planes = [out[k] for k in PREEMPT_OUT]
        planes[5] = victim_words(planes[5])
        return tuple(planes)

    def _resident_aggregates(self) -> list[np.ndarray]:
        """The worker's used and npods are not read across the seam: the
        mirror stands in (it IS the worker's state once every dispatched
        batch resolved; before the first refresh, the host tensors)."""
        src = self._mirror if self._mirror is not None else {
            "used": self.tensors.used, "npods": self.tensors.npods}
        return [src["used"], src["npods"]]

    def drain_worker_timeline(self) -> list:
        """Pull (and clear) the worker's timeline ring across the seam:
        no seq, no resync (the worker serves it epoch-blind, like
        /health); the caller treats a seam error as an empty drain."""
        out = self._call("/timeline", b"", None, allow_resync=False)
        return json.loads(out).get("intervals", [])

    def _full_refresh(self, cd_sg: np.ndarray, cd_asg: np.ndarray) -> None:
        t = self.tensors
        body = _dump_arrays({
            "used": t.used, "used_nz": t.used_nz, "npods": t.npods,
            "port_mask": t.port_mask, "cd_sg": cd_sg, "cd_asg": cd_asg,
            "gen": np.asarray(self._gen, np.int32)})
        self._post("/refresh", body)
        # a refresh replaces the worker's state: it IS a checkpoint, and
        # every journaled step before it is obsolete
        self._ckpt_refresh_body = body
        del self._journal[:]
        self._journal_overflow = False
        self._state = True  # sentinel: the worker holds the arrays
        self._mirror_from_tensors(cd_sg, cd_asg)
        self.stats["full_refresh"] += 1

    def _restore_state_from_mirror(self) -> None:
        """Gen-stale recovery over the wire: the host mirror as a fresh
        /refresh body on a bumped generation (a checkpoint too)."""
        self._gen += 1
        body = _dump_arrays({
            **{k: self._mirror[k] for k in _REFRESH_KEYS},
            "gen": np.asarray(self._gen, np.int32)})
        self._post("/refresh", body)
        self._ckpt_refresh_body = body
        del self._journal[:]
        self._journal_overflow = False
        self._state = True
        self.stats["gen_recoveries"] = self.stats.get("gen_recoveries", 0) + 1

    def warmup(self) -> None:
        """The worker builds its steps and kernels at /init; this uploads
        the static arrays and the state, runs an all-invalid batch through
        each variant and an all-inactive chunk through the dry run on the
        worker, so none of it lands in the first scheduling cycle."""
        from ..models.assign import pack_pod_batch
        from .flatten import slice_pod_batch
        with self._lock:
            self._seam_prepare()
            if self._static_node is None:
                self._upload_static()
            if self._state is None:
                cd_sg, cd_asg = self.tensors.domain_base_counts()
                self._full_refresh(cd_sg, cd_asg)
            batch = self.encoder.encode([])
            self._ensure_full()
            runs = [("full", self._spec_full,
                     slice_pod_batch(batch, 0, 0, self.full_cap))]
            if self.full_main_waves:
                self._ensure_full_small()
                runs.append(("full_small", self._spec_full_small,
                             slice_pod_batch(batch, 0, 0, self._retry_cap())))
            self._ensure_plain()
            runs.append(("plain", self._spec_plain, batch))
            for variant, spec, b in runs:
                staged = self._stage_buf(spec.total)
                try:
                    pack_pod_batch(b, spec, out=staged.array)
                    self._device_step(variant, staged)
                finally:
                    self._stage_pins.discard(id(staged))
            self._warm_preempt()
