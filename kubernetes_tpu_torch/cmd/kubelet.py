"""kubelet entry point — hollow node(s) (reference: cmd/kubelet + cmd/kubemark).

    python -m kubernetes_tpu_torch.cmd.kubelet --server URL --token T \
        --hollow-nodes N
    python -m kubernetes_tpu_torch.cmd.kubelet --server URL --token T \
        --full --node-name NODE --root-dir DIR

--hollow-nodes N registers N hollow nodes, hollow-0 ... hollow-(N-1), each
with its Lease in kube-node-lease, all in this process behind one shared
pod informer; --full runs the full kubelet (pod workers, probes, eviction,
image GC, checkpoints under --root-dir) as --node-name, restoring its
checkpoint first; with neither, one hollow node named --node-name.  It
talks to the apiserver through HTTPClient; SIGTERM and SIGINT stop it.
One token serves every node of the process, so against an apiserver
with the node authorizer it needs a token that may write any node's
objects.  As in the reference, the node names do not depend on the
process (ROADMAP R14(c)): two hollow binaries against one apiserver claim
the same nodes.  Each hollow node holds two threads, and SIGTERM stops the
nodes one by one on the main thread while the others' threads run on, so
the time to exit varies with their load (ROADMAP R14(f)).  Counterpart of kubernetes_tpu/cmd/kubelet.py, with the
same code.
"""

from __future__ import annotations

import argparse
import logging
import signal
import socket
import threading


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="tpu-kubelet")
    ap.add_argument("--server", default="http://127.0.0.1:8080")
    ap.add_argument("--token", default=None)
    ap.add_argument("--node-name", default=socket.gethostname())
    ap.add_argument("--cpu", default="32")
    ap.add_argument("--memory", default="256Gi")
    ap.add_argument("--max-pods", type=int, default=110)
    ap.add_argument("--hollow-nodes", type=int, default=0,
                    help="kubemark mode: register N hollow nodes instead of one")
    ap.add_argument("--full", action="store_true",
                    help="run the full kubelet (pod workers, probes, "
                         "eviction, image GC, checkpoints) instead of hollow")
    ap.add_argument("--root-dir", default=None,
                    help="checkpoint/state directory for --full")
    ap.add_argument("-v", "--verbosity", type=int, default=1)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbosity > 4 else logging.INFO)

    from ..client.http_client import HTTPClient
    from ..client.informer import SharedInformerFactory
    from ..kubelet import HollowKubelet, start_hollow_nodes

    client = HTTPClient.from_url(args.server, args.token)
    factory = SharedInformerFactory(client)
    factory.start()
    factory.wait_for_cache_sync()
    if args.hollow_nodes:
        kubelets = start_hollow_nodes(client, factory, args.hollow_nodes,
                                      cpu=args.cpu, memory=args.memory,
                                      pods=args.max_pods)
        print(f"kubemark: {args.hollow_nodes} hollow nodes registered")
    elif args.full:
        from ..kubelet.kubelet import Kubelet
        kl = Kubelet(client, factory, args.node_name, root_dir=args.root_dir,
                     cpu=args.cpu, memory=args.memory, pods=args.max_pods)
        kl.restore_state()  # crash-only restart path
        kubelets = [kl.start()]
        print(f"kubelet (full) running as node {args.node_name}")
    else:
        kubelets = [HollowKubelet(client, factory, args.node_name,
                                  cpu=args.cpu, memory=args.memory,
                                  pods=args.max_pods).start()]
        print(f"kubelet running as node {args.node_name}")
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    stop.wait()
    for k in kubelets:
        k.stop()


if __name__ == "__main__":
    main()
