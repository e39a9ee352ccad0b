"""kube-apiserver entry point (reference: cmd/kube-apiserver).

    python -m kubernetes_tpu_torch.cmd.apiserver --secure-port 8080

serves the port's apiserver over a MemoryStore (WAL-backed with
--data-dir) and prints "apiserver listening on URL" once it accepts
requests.  The harness's via_http="process" branch spawns it."""

from __future__ import annotations

import argparse
import logging
import signal
import threading


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="tpu-apiserver")
    ap.add_argument("--bind-address", default="127.0.0.1")
    ap.add_argument("--secure-port", type=int, default=8080)
    ap.add_argument("--token", default=None, help="static bearer token authn")
    ap.add_argument("--token-file", default=None,
                    help="token auth file: one 'token,user,group1|group2' "
                         "line per credential (reference --token-auth-file)")
    ap.add_argument("--authorization-mode", default="AlwaysAllow",
                    choices=["AlwaysAllow", "RBAC"])
    ap.add_argument("--encrypt-secrets", action="store_true",
                    help="KMS envelope encryption of Secrets at rest "
                         "(EncryptionConfiguration kms provider equivalent)")
    ap.add_argument("--data-dir", default=None,
                    help="directory for the store's WAL + snapshots; "
                         "omitting it runs memory-only (no durability)")
    ap.add_argument("--enable-default-admission", action="store_true",
                    help="run the in-tree admission chain (the bench's "
                         "front-door configuration)")
    ap.add_argument("--disable-admission-plugins", default="",
                    help="comma-separated plugin names to remove from "
                         "the default chain (the reference harness "
                         "disables ServiceAccount,TaintNodesByCondition,"
                         "Priority when no controllers run — "
                         "scheduler_perf/util.go:84-85)")
    ap.add_argument("-v", "--verbosity", type=int, default=1)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbosity > 4 else logging.INFO)

    from ..apiserver import APIServer
    from ..store import kv

    transformers = None
    if args.encrypt_secrets:
        import os
        from ..store.encryption import EnvelopeTransformer, LocalKMS
        key_file = None
        if args.data_dir:  # durable store needs a durable KEK ring
            os.makedirs(args.data_dir, exist_ok=True)
            key_file = os.path.join(args.data_dir, "kms-keys.json")
        transformers = {"secrets": EnvelopeTransformer(
            LocalKMS(key_file=key_file))}
    tokens = None
    if args.token_file:
        tokens = {}
        with open(args.token_file) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                tok, user, *rest = line.split(",")
                groups = tuple(g for g in (rest[0].split("|") if rest else ())
                               if g)
                tokens[tok] = (user, groups)
    store = kv.MemoryStore(history=1_000_000, transformers=transformers,
                           durable_dir=args.data_dir)
    server = APIServer(
        store, host=args.bind_address, port=args.secure_port,
        token=args.token, tokens=tokens,
        enable_rbac=args.authorization_mode == "RBAC",
        enable_default_admission=args.enable_default_admission,
        disable_admission_plugins=frozenset(
            p for p in args.disable_admission_plugins.split(",")
            if p)).start()
    print(f"apiserver listening on {server.url}", flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    stop.wait()
    server.stop()


if __name__ == "__main__":
    main()
