"""Fake CRI runtime.

Reference: the CRI contract (staging/src/k8s.io/cri-api/pkg/apis/runtime/v1/
api.proto — RunPodSandbox/StopPodSandbox/RemovePodSandbox, CreateContainer/
StartContainer/StopContainer/RemoveContainer, ListContainers, PullImage...)
and the kubemark fake (pkg/kubelet/cri/remote/fake/): an in-process
implementation that tracks sandbox/container state machines without running
anything.  Method names follow the proto rpcs; this is the seam where a
real gRPC runtime (containerd) would plug in.

A copy of kubernetes_tpu/kubelet/cri.py: the same classes, names and
logic, over this package's api/, client/ and store/.
"""

from __future__ import annotations

import threading
import time
import uuid

SANDBOX_READY = "SANDBOX_READY"
SANDBOX_NOTREADY = "SANDBOX_NOTREADY"

CREATED = "CONTAINER_CREATED"
RUNNING = "CONTAINER_RUNNING"
EXITED = "CONTAINER_EXITED"


class FakeRuntimeService:
    def __init__(self, start_latency: float = 0.0):
        self._lock = threading.Lock()
        self._sandboxes: dict[str, dict] = {}
        self._containers: dict[str, dict] = {}
        self._images: set[str] = set()
        self.start_latency = start_latency
        # streaming seam (api.proto Exec/Attach/PortForward rpcs): log
        # lines + a condvar for `follow`, checkpoint archives
        self._log_cond = threading.Condition(self._lock)
        self._checkpoints: dict[str, dict] = {}

    # -- RuntimeService --------------------------------------------------

    def run_pod_sandbox(self, config: dict) -> str:
        if self.start_latency:
            time.sleep(self.start_latency)
        sid = uuid.uuid4().hex[:12]
        with self._lock:
            self._sandboxes[sid] = {"id": sid, "state": SANDBOX_READY,
                                    "config": config,
                                    "createdAt": time.time()}
        return sid

    def stop_pod_sandbox(self, sandbox_id: str) -> None:
        with self._lock:
            sb = self._sandboxes.get(sandbox_id)
            if sb:
                sb["state"] = SANDBOX_NOTREADY
            for c in self._containers.values():
                if c["sandboxId"] == sandbox_id and c["state"] == RUNNING:
                    c["state"] = EXITED
                    c["exitCode"] = 137

    def remove_pod_sandbox(self, sandbox_id: str) -> None:
        with self._lock:
            self._sandboxes.pop(sandbox_id, None)
            self._containers = {cid: c for cid, c in self._containers.items()
                                if c["sandboxId"] != sandbox_id}

    def create_container(self, sandbox_id: str, config: dict) -> str:
        cid = uuid.uuid4().hex[:12]
        with self._lock:
            self._containers[cid] = {
                "id": cid, "sandboxId": sandbox_id, "state": CREATED,
                "name": config.get("name", ""), "image": config.get("image", ""),
                "config": config, "createdAt": time.time(), "exitCode": None,
            }
        return cid

    def start_container(self, container_id: str) -> None:
        if self.start_latency:
            time.sleep(self.start_latency)
        with self._lock:
            c = self._containers[container_id]
            c["state"] = RUNNING
            c["startedAt"] = time.time()
            name = c["name"] or container_id
            c["logs"] = [f"{name} starting\n", f"{name} ready\n"]
            interval = (c["config"].get("annotations") or {}).get(
                "hollow/log-interval-seconds")
            if interval is not None:
                try:
                    every = float(interval)
                except (TypeError, ValueError):
                    every = 0.0
                if every > 0:  # <=0 would spin _advance_clock forever
                    c["logEvery"] = every
                    c["nextLogAt"] = c["startedAt"] + every
                    c["logSeq"] = 0
            self._log_cond.notify_all()
            # hollow semantics: a container may declare it exits by itself
            run_for = (c["config"].get("annotations") or {}).get("hollow/run-seconds")
            if run_for is not None:
                c["exitAt"] = c["startedAt"] + float(run_for)
                c["plannedExitCode"] = int(
                    (c["config"].get("annotations") or {}).get("hollow/exit-code", 0))

    def stop_container(self, container_id: str, timeout: float = 0) -> None:
        with self._lock:
            c = self._containers.get(container_id)
            if c and c["state"] == RUNNING:
                c["state"] = EXITED
                c["exitCode"] = 137

    def remove_container(self, container_id: str) -> None:
        with self._lock:
            self._containers.pop(container_id, None)

    def list_containers(self, sandbox_id: str | None = None) -> list[dict]:
        with self._lock:
            self._advance_clock()
            return [dict(c) for c in self._containers.values()
                    if sandbox_id is None or c["sandboxId"] == sandbox_id]

    def pod_sandbox_status(self, sandbox_id: str) -> dict | None:
        with self._lock:
            sb = self._sandboxes.get(sandbox_id)
            return dict(sb) if sb else None

    def _advance_clock(self) -> None:
        now = time.time()
        logged = False
        for c in self._containers.values():
            if c["state"] == RUNNING and c.get("exitAt") and now >= c["exitAt"]:
                c["state"] = EXITED
                c["exitCode"] = c.get("plannedExitCode", 0)
            while (c["state"] == RUNNING and c.get("logEvery")
                   and now >= c["nextLogAt"]):
                c["logs"].append(f"tick {c['logSeq']}\n")
                c["logSeq"] += 1
                c["nextLogAt"] += c["logEvery"]
                logged = True
        if logged:
            self._log_cond.notify_all()

    # -- streaming (api.proto Exec/Attach/PortForward/ReattachContainer;
    # the reference runtime returns a streaming-server URL from these
    # rpcs — in-process, the seam is a direct call taking an IO adapter
    # with read_stdin()/write_stdout()/write_stderr()) ------------------

    def read_logs(self, container_id: str, follow: bool = False,
                  tail: int | None = None, stop=None, poll: float = 0.1,
                  since_index: int | None = None):
        """Yield log lines; with follow, block for appends until the
        container exits or `stop` (an Event) is set.  `since_index`
        pins the start position eagerly captured by the caller (attach
        must snapshot the tail BEFORE it starts pumping stdin, or an
        immediate write lands in the skipped prefix)."""
        sent = 0
        with self._log_cond:
            c = self._containers.get(container_id)
            if c is None:
                raise KeyError(container_id)
            logs = c.setdefault("logs", [])
            if since_index is not None:
                sent = min(since_index, len(logs))
            elif tail is not None:
                sent = max(0, len(logs) - tail)
        while True:
            with self._log_cond:
                self._advance_clock()
                c = self._containers.get(container_id)
                if c is None:
                    return
                batch = c["logs"][sent:]
                sent += len(batch)
                done = not follow or c["state"] != RUNNING
                if not batch and not done:
                    # timed wait doubles as the tick/exit poll
                    self._log_cond.wait(poll)
            yield from batch
            if batch:
                continue
            if done or (stop is not None and stop.is_set()):
                return

    def exec_stream(self, container_id: str, command: list[str], io,
                    tty: bool = False) -> int:
        """Scripted in-container shell; returns the exit code.

        The hollow runtime executes nothing, so exec semantics are a
        deterministic script over the container's config — enough to
        exercise the full kubectl<->apiserver<->kubelet plumbing the
        reference drives through a real shell."""
        with self._lock:
            c = self._containers.get(container_id)
            if c is None or c["state"] != RUNNING:
                io.write_stderr(b"container not running\n")
                return 126
            cfg = dict(c["config"])
            # the container's in-memory filesystem persists across execs
            # (lives on the container entry, not the config copy)
            files = c.setdefault("files", {})
            sandbox = self._sandboxes.get(c["sandboxId"]) or {}
            hostname = (sandbox.get("config") or {}).get("name", "")
        return self._run_scripted(command, io, cfg, hostname, files)

    def _run_scripted(self, argv: list[str], io, cfg: dict,
                      hostname: str, files: dict | None = None) -> int:
        if not argv:
            io.write_stderr(b"no command\n")
            return 126
        cmd, args = argv[0], argv[1:]
        if cmd in ("sh", "/bin/sh", "bash") and len(args) >= 2 \
                and args[0] == "-c":
            inner = args[1].split()
            if inner[:1] == ["exit"]:
                try:
                    return int(inner[1]) if len(inner) > 1 else 0
                except ValueError:
                    return 2
            return self._run_scripted(inner, io, cfg, hostname, files)
        if cmd == "echo":
            io.write_stdout((" ".join(args) + "\n").encode())
            return 0
        if cmd == "cat" and not args:
            while True:
                data = io.read_stdin()
                if data is None:
                    return 0
                io.write_stdout(data)
        if cmd == "env":
            env = cfg.get("env") or [{"name": "PATH", "value": "/usr/bin"}]
            for e in env:
                io.write_stdout(f"{e['name']}={e.get('value', '')}\n".encode())
            io.write_stdout(f"HOSTNAME={hostname}\n".encode())
            return 0
        if cmd == "hostname":
            io.write_stdout((hostname + "\n").encode())
            return 0
        if cmd == "true":
            return 0
        if cmd == "false":
            return 1
        if cmd == "exit":
            try:
                return int(args[0]) if args else 0
            except ValueError:
                return 2
        if cmd == "sleep":
            try:
                time.sleep(min(float(args[0]), 10.0) if args else 0.0)
            except ValueError:
                return 2
            return 0
        if cmd == "tar":
            return self._run_tar(args, io, files if files is not None else {})
        if cmd == "cat":
            files = files if files is not None else {}
            code = 0
            for path in args:
                data = files.get(self._normpath(path))
                if data is None:
                    io.write_stderr(
                        f"cat: {path}: No such file or directory\n".encode())
                    code = 1
                else:
                    io.write_stdout(data)
            return code
        if cmd == "ls":
            files = files if files is not None else {}
            prefix = self._normpath(args[0]) if args else "/"
            names = sorted(p for p in files
                           if p == prefix or p.startswith(
                               prefix.rstrip("/") + "/"))
            if args and not names:
                io.write_stderr(
                    f"ls: {args[0]}: No such file or directory\n".encode())
                return 1
            io.write_stdout(("\n".join(names) + "\n").encode())
            return 0
        io.write_stderr(f"sh: {cmd}: command not found\n".encode())
        return 127

    @staticmethod
    def _normpath(path: str) -> str:
        import posixpath
        return posixpath.normpath("/" + path.lstrip("/"))

    def _run_tar(self, args: list[str], io, files: dict) -> int:
        """Scripted `tar` over the container's in-memory files — the
        transport kubectl cp rides (reference: kubectl/pkg/cmd/cp/cp.go
        execs `tar cf -` / `tar xmf -` in the container)."""
        import io as pyio
        import tarfile

        flags = args[0].lstrip("-") if args else ""
        rest = args[1:]
        chdir = "/"
        members: list[str] = []
        i = 0
        while i < len(rest):
            if rest[i] == "-C" and i + 1 < len(rest):
                chdir = rest[i + 1]
                i += 2
            elif rest[i] == "-":
                i += 1  # archive == stdin/stdout, implied
            else:
                members.append(rest[i])
                i += 1
        if "c" in flags:
            buf = pyio.BytesIO()
            with tarfile.open(fileobj=buf, mode="w") as tf:
                for m in members:
                    full = self._normpath(
                        m if m.startswith("/") else chdir + "/" + m)
                    hits = {p: d for p, d in files.items()
                            if p == full or p.startswith(
                                full.rstrip("/") + "/")}
                    if not hits:
                        io.write_stderr(
                            f"tar: {m}: No such file or directory\n".encode())
                        return 2
                    for p, d in sorted(hits.items()):
                        ti = tarfile.TarInfo(p.lstrip("/"))
                        ti.size = len(d)
                        tf.addfile(ti, pyio.BytesIO(d))
            data = buf.getvalue()
            step = 1 << 20  # stream frame cap (streams.MAX_FRAME)
            for at in range(0, len(data), step):
                io.write_stdout(data[at:at + step])
            return 0
        if "x" in flags:
            chunks = []
            while True:
                data = io.read_stdin()
                if data is None:
                    break
                chunks.append(data)
            try:
                with tarfile.open(fileobj=pyio.BytesIO(b"".join(chunks)),
                                  mode="r") as tf:
                    for ti in tf.getmembers():
                        if not ti.isfile():
                            continue
                        dest = self._normpath(chdir + "/" + ti.name)
                        files[dest] = tf.extractfile(ti).read()
            except tarfile.TarError as e:
                io.write_stderr(f"tar: {e}\n".encode())
                return 2
            return 0
        io.write_stderr(b"tar: need c or x\n")
        return 2

    def attach_stream(self, container_id: str, io, stop=None,
                      tty: bool = False) -> int:
        """Attach to the scripted console: stream log appends to stdout;
        stdin lines are appended to the log (as if the entrypoint read
        them) and echoed back when tty."""
        import threading
        done = threading.Event()

        def pump_stdin():
            while not done.is_set():
                data = io.read_stdin()
                if data is None:
                    return
                with self._log_cond:
                    c = self._containers.get(container_id)
                    if c is None:
                        return
                    c.setdefault("logs", []).append(
                        data.decode(errors="replace"))
                    self._log_cond.notify_all()

        with self._log_cond:
            c = self._containers.get(container_id)
            start = len(c.get("logs") or ()) if c else 0
        t = threading.Thread(target=pump_stdin, daemon=True)
        t.start()
        try:
            for line in self.read_logs(container_id, follow=True,
                                       since_index=start, stop=stop):
                io.write_stdout(line.encode())
        finally:
            done.set()
        return 0

    def portforward_stream(self, sandbox_id: str, port: int, io) -> None:
        """Scripted pod network: a declared containerPort answers with a
        banner then echoes; anything else refuses (the contract a real
        CRI implements by dialing the pod's netns)."""
        with self._lock:
            declared = {
                p.get("containerPort")
                for c in self._containers.values()
                if c["sandboxId"] == sandbox_id and c["state"] == RUNNING
                for p in (c["config"].get("ports") or ())}
        if port not in declared:
            io.error(f"connection refused: port {port} not declared")
            return
        io.write_data(f"hollow-port {port}\n".encode())
        while True:
            data = io.read_data()
            if data is None:
                return
            io.write_data(data)

    def checkpoint_container(self, container_id: str) -> str:
        """CRI CheckpointContainer (api.proto): snapshot the container's
        fake state; returns the archive name the kubelet reports."""
        with self._lock:
            c = self._containers.get(container_id)
            if c is None:
                raise KeyError(container_id)
            archive = (f"checkpoint-{c['name'] or container_id}-"
                       f"{int(time.time())}.tar")
            self._checkpoints[archive] = {
                "container": dict(c, config=dict(c["config"])),
                "at": time.time()}
        return archive

    # -- ImageService ----------------------------------------------------

    def pull_image(self, image: str) -> str:
        with self._lock:
            self._images.add(image)
        return image

    def list_images(self) -> list[str]:
        with self._lock:
            return sorted(self._images)
