"""Per-pod host helpers, pure Python.

The JAX package backs these with a native CPython extension; the port
keeps only the Python versions, so it has no native build besides its
CUDA kernels.  Consumers:

  scheduler/scheduler.py  _finish_batch  -> build_assumed, clone_podinfos
  scheduler/scheduler.py  _bulk_bind_commit -> binding_rows
  client/informer.py      _list_and_watch -> watch_apply
  ops/flatten.py          encode         -> req_columns
  scheduler/types.py      PodInfo.update -> pod_scan_into"""

from __future__ import annotations


def build_assumed(pods: list, node_names: list) -> list:
    """[{**pod, "spec": {**spec, "nodeName": n}}] for each (pod, n).
    2-level shallow copies: nested values are never mutated in place on
    this path (store reads hand out copies)."""
    return [{**pod, "spec": {**(pod.get("spec") or {}), "nodeName": n}}
            for pod, n in zip(pods, node_names)]


def req_columns(pod_infos: list, req, req_nz) -> None:
    """Fill req[i,0:3] / req_nz[i,0:3] (float32 C-contiguous) from
    pod_infos[i].request / .request_nonzero."""
    req[:len(pod_infos), 0] = [pi.request.milli_cpu for pi in pod_infos]
    req[:len(pod_infos), 1] = [pi.request.memory for pi in pod_infos]
    req[:len(pod_infos), 2] = [pi.request.ephemeral_storage
                               for pi in pod_infos]
    req_nz[:len(pod_infos), 0] = [pi.request_nonzero.milli_cpu
                                  for pi in pod_infos]
    req_nz[:len(pod_infos), 1] = [pi.request_nonzero.memory
                                  for pi in pod_infos]
    req_nz[:len(pod_infos), 2] = [pi.request_nonzero.ephemeral_storage
                                  for pi in pod_infos]


def pod_scan_into(pod: dict, pi, defaults: tuple):
    """PodInfo fast-path hook.  Without the native scanner every pod takes
    the full Python path in PodInfo.update, so this always answers False."""
    return False


def clone_podinfos(infos: list, pods: list) -> list:
    """Batch clone_with_pod (scheduler batch tail)."""
    return [pi.clone_with_pod(pod) for pi, pod in zip(infos, pods)]


def watch_apply(events: list, indexer: dict) -> list:
    """Informer watch-burst apply: update the indexer from a batch of
    watch events and return the (type, obj, prev) dispatch triples.
    Caller holds the informer locks."""
    from ..api import meta
    from ..store import kv
    triples = []
    for ev in events:
        key = meta.namespaced_name(ev.object)
        if ev.type == kv.DELETED:
            prev = indexer.pop(key, None)
            triples.append((kv.DELETED, ev.object, prev))
        else:
            prev = indexer.get(key)
            indexer[key] = ev.object
            triples.append((kv.MODIFIED if prev is not None
                            else kv.ADDED, ev.object, prev))
    return triples


def binding_rows(ready: list) -> list:
    """(namespace, name, node) wire rows from the bulk-bind ready tuples
    (state, qpi, node, assumed)."""
    from ..api import meta
    return [(meta.namespace(q.pod), meta.name(q.pod), node)
            for _, q, node, _ in ready]
