"""Patch application: JSON merge patch, JSON patch, strategic merge patch.

Reference: the three patch content types the kube-apiserver accepts
(staging/src/k8s.io/apiserver/pkg/endpoints/handlers/patch.go):
  application/merge-patch+json           RFC 7386 (vendored evanphx/json-patch)
  application/json-patch+json            RFC 6902 op list
  application/strategic-merge-patch+json apimachinery/pkg/util/strategicpatch

Strategic merge is the Kubernetes-specific one: lists tagged
patchStrategy=merge in the API types merge element-wise by a patch *merge
key* instead of being replaced wholesale.  The merge-key table below covers
the core types (containers by name, tolerations-by-key is actually atomic
upstream — kept replace — env by name, ports by containerPort, volumes by
name, ...), plus the $patch: delete/replace directives.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List

# path-suffix -> merge key for strategic list merges (from the
# +patchMergeKey tags in staging/src/k8s.io/api/core/v1/types.go)
STRATEGIC_MERGE_KEYS: Dict[str, str] = {
    "containers": "name",
    "initContainers": "name",
    "ephemeralContainers": "name",
    "volumes": "name",
    "env": "name",
    "ports": "containerPort",
    "volumeMounts": "mountPath",
    "imagePullSecrets": "name",
    "hostAliases": "ip",
    "conditions": "type",
    "taints": "key",
    "addresses": "type",
    "finalizers": None,  # set-style (patchStrategy=merge, scalar)
}


class PatchError(ValueError):
    pass


# -- RFC 7386 JSON merge patch --------------------------------------------

def json_merge_patch(target: Any, patch: Any) -> Any:
    if not isinstance(patch, dict):
        return copy.deepcopy(patch)
    if not isinstance(target, dict):
        target = {}
    result = dict(target)
    for k, v in patch.items():
        if v is None:
            result.pop(k, None)
        else:
            result[k] = json_merge_patch(result.get(k), v)
    return result


# -- RFC 6902 JSON patch ---------------------------------------------------

def _ptr_tokens(pointer: str) -> List[str]:
    if pointer == "":
        return []
    if not pointer.startswith("/"):
        raise PatchError("invalid JSON pointer %r" % pointer)
    return [t.replace("~1", "/").replace("~0", "~")
            for t in pointer[1:].split("/")]


def _ptr_walk(doc: Any, tokens: List[str]):
    """-> (parent, last_token); resolves all but the last token."""
    cur = doc
    for t in tokens[:-1]:
        if isinstance(cur, list):
            cur = cur[int(t)]
        elif isinstance(cur, dict):
            if t not in cur:
                raise PatchError("path not found: %r" % t)
            cur = cur[t]
        else:
            raise PatchError("cannot traverse %r" % t)
    return cur, (tokens[-1] if tokens else None)


def json_patch(target: Any, ops: List[dict]) -> Any:
    doc = copy.deepcopy(target)
    for op in ops:
        try:
            doc = _apply_op(doc, op)
        except PatchError:
            raise
        except (ValueError, IndexError, KeyError, TypeError) as e:
            raise PatchError("invalid patch op %s: %s" % (op, e))
    return doc


def _apply_op(doc: Any, op: dict) -> Any:
    kind = op.get("op")
    tokens = _ptr_tokens(op.get("path", ""))
    value = op.get("value")
    if not tokens:  # whole-document ops
        if kind in ("replace", "add"):
            return copy.deepcopy(value)
        if kind == "test":
            if doc != value:
                raise PatchError("test failed at root")
            return doc
        raise PatchError("unsupported root op %r" % kind)
    parent, last = _ptr_walk(doc, tokens)
    if kind == "add":
        if isinstance(parent, list):
            idx = len(parent) if last == "-" else int(last)
            parent.insert(idx, copy.deepcopy(value))
        else:
            parent[last] = copy.deepcopy(value)
    elif kind == "replace":
        if isinstance(parent, list):
            parent[int(last)] = copy.deepcopy(value)
        else:
            if last not in parent:
                raise PatchError("replace of missing key %r" % last)
            parent[last] = copy.deepcopy(value)
    elif kind == "remove":
        if isinstance(parent, list):
            del parent[int(last)]
        else:
            if last not in parent:
                raise PatchError("remove of missing key %r" % last)
            del parent[last]
    elif kind == "test":
        cur = parent[int(last)] if isinstance(parent, list) else parent.get(last)
        if cur != value:
            raise PatchError("test failed at %s" % op.get("path"))
    elif kind in ("move", "copy"):
        src = _ptr_tokens(op.get("from", ""))
        sparent, slast = _ptr_walk(doc, src)
        val = (sparent[int(slast)] if isinstance(sparent, list)
               else sparent[slast])
        if kind == "move":
            if isinstance(sparent, list):
                del sparent[int(slast)]
            else:
                del sparent[slast]
        if isinstance(parent, list):
            idx = len(parent) if last == "-" else int(last)
            parent.insert(idx, copy.deepcopy(val))
        else:
            parent[last] = copy.deepcopy(val)
    else:
        raise PatchError("unknown op %r" % kind)
    return doc


# -- strategic merge patch -------------------------------------------------

def strategic_merge_patch(target: Any, patch: Any, field: str = "") -> Any:
    if isinstance(patch, dict):
        if patch.get("$patch") == "replace":
            out = {k: copy.deepcopy(v) for k, v in patch.items()
                   if k != "$patch"}
            return out
        if not isinstance(target, dict):
            target = {}
        result = dict(target)
        for k, v in patch.items():
            if k == "$patch":
                continue
            if v is None:
                result.pop(k, None)
            else:
                result[k] = strategic_merge_patch(result.get(k), v, k)
        return result
    if isinstance(patch, list):
        merge_key = STRATEGIC_MERGE_KEYS.get(field, "__absent__")
        if merge_key == "__absent__":
            return copy.deepcopy(patch)  # atomic list: replace
        if merge_key is None:
            # set-style scalar list: union, patch order last
            base = [x for x in (target or []) if x not in patch]
            return base + copy.deepcopy(patch)
        return _merge_list_by_key(target or [], patch, merge_key)
    return copy.deepcopy(patch)


def _merge_list_by_key(target: List[dict], patch: List[dict],
                       key: str) -> List[dict]:
    out = [copy.deepcopy(x) for x in target]
    index = {x.get(key): i for i, x in enumerate(out)
             if isinstance(x, dict)}
    for p in patch:
        if not isinstance(p, dict):
            out.append(copy.deepcopy(p))
            continue
        k = p.get(key)
        if p.get("$patch") == "delete":
            if k in index:
                out = [x for x in out
                       if not (isinstance(x, dict) and x.get(key) == k)]
                index = {x.get(key): i for i, x in enumerate(out)
                         if isinstance(x, dict)}
            continue
        if k in index:
            out[index[k]] = strategic_merge_patch(out[index[k]], p)
        else:
            out.append(copy.deepcopy(p))
            index[k] = len(out) - 1
    return out


CONTENT_TYPE_HANDLERS = {
    "application/merge-patch+json": json_merge_patch,
    "application/json-patch+json": json_patch,
    "application/strategic-merge-patch+json": strategic_merge_patch,
}


def apply_patch(content_type: str, target: Any, patch: Any) -> Any:
    fn = CONTENT_TYPE_HANDLERS.get(content_type.split(";")[0].strip())
    if fn is None:
        raise PatchError("unsupported patch content type %r" % content_type)
    return fn(target, patch)
