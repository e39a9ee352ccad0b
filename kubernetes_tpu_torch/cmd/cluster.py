"""All-in-one local cluster (reference: the 'hack/local-up-cluster.sh'
developer experience + kubeadm's role as the bootstrap path).

    python -m kubernetes_tpu_torch.cmd.cluster --secure-port 18080 \
        --nodes 3 --tpu-batch [--device cpu]

Starts apiserver + scheduler + controller-manager + N hollow nodes in one
process, serving the REST API so kubectl and other processes can attach.
Counterpart of kubernetes_tpu/cmd/cluster.py, with these departures only:
--device names the torch device of the --tpu-batch scheduler's
TorchBatchBackend (default cuda: without a GPU the binary exits non-zero
unless --device cpu is given; it never falls back to the CPU), and
--tpu-worker URL drives a RemoteTorchBatchBackend against a
cmd/tpu_worker.py process; and the start-up hint names this package's
kubectl.  The hollow kubelets run in this process over
the LocalClient, so their status writes (ROADMAP R14(a)) reach the
controllers' pod handlers here too.  SIGTERM and SIGINT stop the kubelets
one by one, then the controllers, the scheduler and the apiserver.
"""

from __future__ import annotations

import argparse
import logging
import signal
import threading


def _batch_backend(args):
    """The profile's batch backend, warmed up: a TorchBatchBackend on
    --device, or a RemoteTorchBatchBackend against --tpu-worker; a device
    that is not there ends the process with resolve_device's message."""
    from ..ops.flatten import Caps
    caps = Caps(n_cap=max(1024, args.nodes * 2))
    if args.tpu_worker:
        from ..ops.remote import RemoteTorchBatchBackend
        backend = RemoteTorchBatchBackend(args.tpu_worker, caps,
                                          batch_size=args.batch_size)
    else:
        from ..device import resolve_device
        from ..ops.backend import TorchBatchBackend
        try:
            device = resolve_device(args.device)
        except RuntimeError as e:
            raise SystemExit(f"tpu-cluster: {e}") from None
        backend = TorchBatchBackend(caps, batch_size=args.batch_size,
                                    device=device)
    backend.warmup()
    return backend


def main(argv=None) -> None:
    from ..utils.gctune import tune_for_throughput
    tune_for_throughput()
    ap = argparse.ArgumentParser(prog="tpu-cluster")
    ap.add_argument("--secure-port", type=int, default=8080)
    ap.add_argument("--nodes", type=int, default=3)
    ap.add_argument("--tpu-batch", action="store_true")
    ap.add_argument("--tpu-worker", default=None,
                    help="URL of an external tpu-worker process "
                         "(cmd/tpu_worker.py); default runs the device "
                         "backend in-process")
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the in-process --tpu-batch "
                         "backend (default cuda)")
    ap.add_argument("--devices-per-node", type=int, default=0,
                    help="give each hollow node N google.com/tpu devices "
                         "(exercises the kubelet device/topology managers)")
    ap.add_argument("--data-dir", default=None,
                    help="directory for the store's WAL + snapshots; "
                         "omitting it runs memory-only (no durability)")
    ap.add_argument("-v", "--verbosity", type=int, default=1)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbosity > 4 else logging.INFO)

    from ..apiserver import APIServer
    from ..client.clientset import LocalClient
    from ..client.informer import SharedInformerFactory
    from ..controllers import ControllerManager
    from ..controllers.endpoints import EndpointsController
    from ..kubelet import KubeletServer, start_hollow_nodes
    from ..scheduler import Profile, Scheduler, new_default_framework
    from ..store import kv

    store = kv.MemoryStore(history=1_000_000, durable_dir=args.data_dir)
    server = APIServer(store, port=args.secure_port).start()
    client = LocalClient(store)
    factory = SharedInformerFactory(client)

    fw = new_default_framework(client, factory)
    if args.tpu_batch:
        profile = Profile(fw, batch_backend=_batch_backend(args),
                          batch_size=args.batch_size)
    else:
        profile = Profile(fw)
    sched = Scheduler(client, factory, {"default-scheduler": profile})
    mgr = ControllerManager(client, factory)
    endpoints = EndpointsController(client, factory)

    factory.start()
    factory.wait_for_cache_sync()
    sched.run()
    mgr.run()
    endpoints.run()
    kubelet_server = KubeletServer().start()
    if args.devices_per_node > 0:
        from ..kubelet import HollowKubelet
        from ..kubelet.cm import ContainerManager, DevicePlugin
        kubelets = []
        num_numa = 2
        for i in range(args.nodes):
            cmgr = ContainerManager(num_cpus=32, memory_bytes=256 << 30,
                                    num_numa=num_numa)
            cmgr.devices.register(DevicePlugin("google.com/tpu", {
                f"tpu{d}": d * num_numa // args.devices_per_node
                for d in range(args.devices_per_node)}))
            kubelets.append(HollowKubelet(
                client, factory, f"hollow-{i}", container_manager=cmgr,
                kubelet_server=kubelet_server).start())
    else:
        kubelets = start_hollow_nodes(client, factory, args.nodes,
                                      kubelet_server=kubelet_server)

    print(f"cluster up: apiserver={server.url} nodes={args.nodes} "
          f"scheduler={'tpu-batch' if args.tpu_batch else 'per-pod'}")
    print(f"try: python -m kubernetes_tpu_torch.cli.kubectl --server "
          f"{server.url} get nodes")
    stop = threading.Event()
    from ..scheduler.debugger import CacheDebugger
    CacheDebugger(sched, client).listen_for_signal()  # SIGUSR2 dump+compare
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    stop.wait()
    for k in kubelets:
        k.stop()
    kubelet_server.stop()
    endpoints.stop()
    mgr.stop()
    sched.stop()
    server.stop()


if __name__ == "__main__":
    main()
