"""Standalone device worker: the out-of-process batch backend.

Run it beside the card and point a RemoteTorchBatchBackend (or the
harness's setup_cluster(remote_seam=URL)) at the URL it prints:

    python3 -m kubernetes_tpu_torch.cmd.tpu_worker --port 0 --device cuda

It prints `tpu-worker listening on <url>` on one line once it serves,
and stops on SIGTERM or SIGINT.  --port 0 picks a free port; --device
names the torch device of the worker's TorchBatchBackend (default cuda;
without a GPU that raises unless --device cpu); --claims-noise is the
plain step's tie-break rule for a client that names none (the JAX
package's client).  Counterpart of
kubernetes_tpu/cmd/tpu_worker.py.
"""

from __future__ import annotations

import argparse
import logging
import signal
import threading


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="tpu-worker")
    ap.add_argument("--bind-address", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9090,
                    help="0 picks a free port")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--claims-noise", default="sin",
                    choices=("sin", "murmur"))
    ap.add_argument("-v", "--verbosity", type=int, default=1)
    args = ap.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbosity > 4 else logging.INFO)

    from ..ops.remote import make_worker

    worker = make_worker("http", host=args.bind_address, port=args.port,
                         device=args.device,
                         claims_noise=args.claims_noise).start()
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    print(f"tpu-worker listening on {worker.url}", flush=True)
    stop.wait()
    worker.stop()


if __name__ == "__main__":
    main()
