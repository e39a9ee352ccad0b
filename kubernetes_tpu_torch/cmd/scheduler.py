"""kube-scheduler entry point (reference: cmd/kube-scheduler/app/server.go).

    python -m kubernetes_tpu_torch.cmd.scheduler --server URL --token T \
        --tpu-batch --leader-elect --batch-size 4096 --node-capacity 5632

Supports the `tpu-batch` profile: --tpu-batch enables the batched
Filter/Score/Assign backend (TorchBatchBackend) for the default profile,
with --batch-size and --node-capacity knobs; --device names its torch
device (default cuda: without a GPU the binary exits non-zero unless
--device cpu is given).  --config reads a KubeSchedulerConfiguration
(JSON needs no PyYAML).  With --leader-elect the scheduling loop starts
only while this process holds the kube-system/kube-scheduler Lease.  SIGUSR2 logs the
cache dump and the cache-vs-apiserver comparison; SIGTERM and SIGINT
stop the loop.  As in the reference, SIGTERM does not release the Lease:
a follower takes over once it expires.  Counterpart of
kubernetes_tpu/cmd/scheduler.py.
"""

from __future__ import annotations

import argparse
import logging
import signal
import threading


def _batch_backend(args):
    """The profile's TorchBatchBackend on --device, warmed up; a device
    that is not there ends the process with resolve_device's message."""
    from ..device import resolve_device
    from ..ops.backend import TorchBatchBackend
    from ..ops.flatten import Caps
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"tpu-scheduler: {e}") from None
    backend = TorchBatchBackend(Caps(n_cap=args.node_capacity),
                                batch_size=args.batch_size, device=device)
    backend.warmup()
    return backend


def main(argv=None) -> None:
    from ..utils.gctune import tune_for_throughput
    tune_for_throughput()
    ap = argparse.ArgumentParser(prog="tpu-scheduler")
    ap.add_argument("--server", default="http://127.0.0.1:8080")
    ap.add_argument("--token", default=None)
    ap.add_argument("--config", default=None,
                    help="KubeSchedulerConfiguration path (JSON or YAML)")
    ap.add_argument("--leader-elect", action="store_true")
    ap.add_argument("--tpu-batch", action="store_true",
                    help="enable the batch scheduling backend on --device")
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--node-capacity", type=int, default=8192)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("-v", "--verbosity", type=int, default=1)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbosity > 4 else logging.INFO)

    from ..client.http_client import HTTPClient
    from ..client.informer import SharedInformerFactory
    from ..client.leaderelection import LeaderElector
    from ..scheduler import Profile, Scheduler, new_default_framework

    client = HTTPClient.from_url(args.server, args.token)
    factory = SharedInformerFactory(client)
    if args.config:
        from ..scheduler.config import load_config, scheduler_from_config
        sched = scheduler_from_config(client, factory, load_config(args.config))
        if args.tpu_batch:
            backend = _batch_backend(args)
            for profile in sched.profiles.values():
                profile.batch_backend = backend
                profile.batch_size = args.batch_size
    else:
        fw = new_default_framework(client, factory)
        if args.tpu_batch:
            profile = Profile(fw, batch_backend=_batch_backend(args),
                              batch_size=args.batch_size)
        else:
            profile = Profile(fw)
        sched = Scheduler(client, factory, {"default-scheduler": profile})
    factory.start()
    factory.wait_for_cache_sync()

    stop = threading.Event()
    if args.leader_elect:
        elector = LeaderElector(client, "kube-scheduler",
                                on_started_leading=sched.run,
                                on_stopped_leading=stop.set)
        elector.run()
    else:
        sched.run()
    print("scheduler running"
          + (" (tpu-batch profile)" if args.tpu_batch else " (per-pod)"),
          flush=True)
    from ..scheduler.debugger import CacheDebugger
    CacheDebugger(sched, client).listen_for_signal()  # SIGUSR2 dump+compare
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    stop.wait()
    sched.stop()


if __name__ == "__main__":
    main()
