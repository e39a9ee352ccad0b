"""Server-side apply: managedFields tracking + conflict detection.

Reference semantics (not implementation):
  staging/src/k8s.io/apimachinery/pkg/util/managedfields/ — every write
    records which *field manager* owns which fields, as a fieldsV1 trie
    in metadata.managedFields;
  sigs.k8s.io/structured-merge-diff — apply = three-way merge driven by
    ownership: an Apply operation (PATCH application/apply-patch+yaml)
    sets exactly the fields in the applied config, REMOVES fields the
    same manager applied before but dropped, and CONFLICTS (409) when it
    would overwrite a field another manager owns with a different value
    — unless force=true steals ownership;
  Update operations (PUT / other PATCH) take ownership of every field
    they change (last-write-wins, no conflicts).

Design: ownership is a set of *leaf paths*.  A path step is one of
  ("f", key)       map field
  ("k", keyjson)   associative-list element, keyed like k:{"name":"c1"}
                   by the strategic merge key (patch.STRATEGIC_MERGE_KEYS)
  ("v", valjson)   set-style scalar list element (e.g. finalizers)
Lists without a merge key are atomic: the whole list is one leaf.  The
wire form in metadata.managedFields[].fieldsV1 is the standard trie
("f:spec": {"f:replicas": {}}), converted losslessly to/from leaf sets.

The merge itself operates on the flattened form: conflict checks compare
applied values with live values at the intersection of leaf sets, and
object construction sets/deletes values path by path.  That makes every
rule (removal, co-ownership, stealing) a set operation — much simpler to
verify than a recursive three-way merge, at the cost of re-walking the
object per path (objects here are control-plane sized, not data).
"""

from __future__ import annotations

import copy
import json
import time
from typing import Any

from ..store.kv import ConflictError
from .patch import STRATEGIC_MERGE_KEYS

APPLY_CONTENT_TYPE = "application/apply-patch+yaml"

# metadata bookkeeping fields that are never owned by a manager
_UNOWNED_META = frozenset({
    "name", "namespace", "uid", "resourceVersion", "generation",
    "creationTimestamp", "deletionTimestamp", "managedFields", "selfLink",
})


class ApplyConflict(ConflictError):
    """Another manager owns a field the apply wants to change (409).
    A ConflictError subclass so both transports (LocalClient in-process,
    HTTPClient via the 409 mapping) surface the same exception type."""

    def __init__(self, conflicts: list[tuple[str, tuple]]):
        self.conflicts = conflicts  # [(manager, path), ...]
        names = sorted({m for m, _ in conflicts})
        paths = ", ".join(path_str(p) for _, p in conflicts[:5])
        super().__init__(
            f"apply conflicts with manager(s) {names} on: {paths}"
            + (" ..." if len(conflicts) > 5 else ""))


def path_str(path: tuple) -> str:
    out = []
    for kind, key in path:
        if kind == "f":
            out.append(f".{key}")
        elif kind == "k":
            out.append(f"[{key}]")
        else:
            out.append(f"[={key}]")
    return "".join(out) or "."


# -- flatten an object to leaf paths -------------------------------------

def leaves_of(obj: dict, *, _top: bool = True) -> set[tuple]:
    """All leaf paths present in obj (ownership universe of a write)."""
    acc: set[tuple] = set()
    _walk(obj, (), acc, top=_top)
    return acc


def _walk(val: Any, path: tuple, acc: set[tuple], top: bool = False,
          field: str = "") -> None:
    if isinstance(val, dict):
        items = val.items()
        for k, v in items:
            if top and k in ("apiVersion", "kind"):
                continue
            if path == (("f", "metadata"),) and k in _UNOWNED_META:
                continue
            _walk(v, path + (("f", k),), acc, field=k)
        if not val and path:
            acc.add(path)  # empty map: owned as a unit
        return
    if isinstance(val, list):
        mk = STRATEGIC_MERGE_KEYS.get(field, "__atomic__")
        if mk == "__atomic__":
            acc.add(path)  # atomic list: one leaf
            return
        if mk is None:  # set of scalars
            for x in val:
                acc.add(path + (("v", json.dumps(x, sort_keys=True)),))
            if not val and path:
                acc.add(path)
            return
        for item in val:
            if not isinstance(item, dict) or mk not in item:
                acc.add(path)  # unkeyable element: fall back to atomic
                return
            kj = json.dumps({mk: item[mk]}, sort_keys=True)
            _walk(item, path + (("k", kj),), acc, field=field)
        if not val and path:
            acc.add(path)
        return
    acc.add(path)  # scalar


# -- value access by path -------------------------------------------------

_MISSING = object()


def get_at(obj: Any, path: tuple) -> Any:
    cur = obj
    for kind, key in path:
        if kind == "f":
            if not isinstance(cur, dict) or key not in cur:
                return _MISSING
            cur = cur[key]
        elif kind == "k":
            want = json.loads(key)
            if not isinstance(cur, list):
                return _MISSING
            for item in cur:
                if isinstance(item, dict) and all(
                        item.get(k) == v for k, v in want.items()):
                    cur = item
                    break
            else:
                return _MISSING
        else:  # v: membership
            want = json.loads(key)
            if not isinstance(cur, list) or want not in cur:
                return _MISSING
            cur = want
    return cur


def set_at(obj: dict, path: tuple, value: Any) -> None:
    """Create containers along `path` and set the leaf to `value`."""
    cur = obj
    for i, (kind, key) in enumerate(path):
        last = i == len(path) - 1
        if kind == "f":
            if last:
                cur[key] = value
                return
            nkind = path[i + 1][0]
            nxt = cur.get(key)
            if nkind == "f":
                if not isinstance(nxt, dict):
                    nxt = cur[key] = {}
            else:
                if not isinstance(nxt, list):
                    nxt = cur[key] = []
            cur = nxt
        elif kind == "k":
            want = json.loads(key)
            for item in cur:
                if isinstance(item, dict) and all(
                        item.get(k) == v for k, v in want.items()):
                    break
            else:
                item = dict(want)
                cur.append(item)
            if last:
                # replace the element wholesale (value carries the key)
                item.clear()
                item.update(value)
                return
            cur = item
        else:  # v: ensure membership
            want = json.loads(key)
            if want not in cur:
                cur.append(want)
            return


def delete_at(obj: dict, path: tuple) -> None:
    if not path:
        return
    parent = get_at(obj, path[:-1]) if len(path) > 1 else obj
    if parent is _MISSING:
        return
    kind, key = path[-1]
    if kind == "f":
        if isinstance(parent, dict):
            parent.pop(key, None)
    elif kind == "k":
        want = json.loads(key)
        if isinstance(parent, list):
            parent[:] = [it for it in parent
                         if not (isinstance(it, dict) and all(
                             it.get(k) == v for k, v in want.items()))]
    else:
        want = json.loads(key)
        if isinstance(parent, list) and want in parent:
            parent.remove(want)


# -- fieldsV1 wire form ---------------------------------------------------

def leaves_to_trie(leaves: set[tuple]) -> dict:
    root: dict = {}
    for path in sorted(leaves):
        node = root
        for kind, key in path:
            node = node.setdefault(f"{kind}:{key}", {})
        node["."] = {}
    return root


def trie_to_leaves(trie: dict, prefix: tuple = ()) -> set[tuple]:
    acc: set[tuple] = set()
    for k, sub in trie.items():
        if k == ".":
            if prefix:
                acc.add(prefix)
            continue
        kind, _, key = k.partition(":")
        acc |= trie_to_leaves(sub, prefix + ((kind, key),))
    return acc


# -- managedFields entries ------------------------------------------------

def read_managers(obj: dict) -> dict[tuple[str, str], set[tuple]]:
    """{(manager, operation): leaf set} from metadata.managedFields."""
    out = {}
    for entry in (obj.get("metadata") or {}).get("managedFields") or []:
        key = (entry.get("manager", ""), entry.get("operation", "Update"))
        out[key] = trie_to_leaves(entry.get("fieldsV1") or {})
    return out


def write_managers(obj: dict, managers: dict[tuple[str, str], set[tuple]],
                   now: float | None = None) -> None:
    entries = []
    for (mgr, op), leaves in sorted(managers.items()):
        if not leaves:
            continue
        entries.append({"manager": mgr, "operation": op,
                        "apiVersion": obj.get("apiVersion", "v1"),
                        "time": now if now is not None else time.time(),
                        "fieldsV1": leaves_to_trie(leaves)})
    md = obj.setdefault("metadata", {})
    if entries:
        md["managedFields"] = entries
    else:
        md.pop("managedFields", None)


# -- the two write paths --------------------------------------------------

def apply_merge(live: dict | None, applied: dict, manager: str,
                force: bool = False) -> dict:
    """Three-way apply (the SSA PATCH verb).  Returns the new object;
    raises ApplyConflict unless force steals the contested fields.

    live=None means create-on-apply: the applied config becomes the
    object and the manager owns everything it set.
    """
    applied_leaves = leaves_of(applied)
    if live is None:
        new = copy.deepcopy(applied)
        write_managers(new, {(manager, "Apply"): applied_leaves})
        return new

    managers = read_managers(live)
    mine_key = (manager, "Apply")
    mine_prev = managers.get(mine_key, set())

    # conflicts: another manager owns a leaf I'm applying with a new value
    conflicts = []
    for (mgr, op), theirs in managers.items():
        if mgr == manager:
            continue
        for path in applied_leaves & theirs:
            want = get_at(applied, path)
            have = get_at(live, path)
            if want != have:
                conflicts.append(((mgr, op), path))
    if conflicts and not force:
        raise ApplyConflict([(m, p) for (m, _), p in
                             sorted(conflicts, key=lambda c: c[1])])
    for mkey, path in conflicts:  # force: steal ownership
        managers[mkey].discard(path)

    new = copy.deepcopy(live)
    # removal: fields I applied before, dropped now, and nobody else owns
    others_all = set()
    for key, theirs in managers.items():
        if key != mine_key:
            others_all |= theirs
    # delete deepest-first so children vanish before their parents are
    # (possibly) deleted as emptied containers
    for path in sorted(mine_prev - applied_leaves, key=len, reverse=True):
        if path not in others_all:
            delete_at(new, path)
    # set every applied leaf
    for path in sorted(applied_leaves, key=len):
        val = get_at(applied, path)
        if val is _MISSING:
            continue
        if val == {} or val == []:
            # an applied EMPTY container claims the container's
            # existence, not its (possibly co-owned) contents
            if get_at(new, path) is _MISSING:
                set_at(new, path, val)
            continue
        set_at(new, path, val)
    managers[mine_key] = applied_leaves
    write_managers(new, managers)
    return new


def track_update(live: dict | None, new: dict, manager: str) -> None:
    """Ownership bookkeeping for a non-apply write (PUT / RFC patch):
    the manager takes every leaf it changed or added; leaves that
    disappeared stop being owned by anyone (managedfields Update op).
    Mutates `new` in place."""
    managers = read_managers(live) if live is not None else {}
    new_leaves = leaves_of(new)
    if live is not None:
        old_leaves = leaves_of(live)
        changed = {p for p in new_leaves
                   if get_at(new, p) != get_at(live, p)}
        removed = old_leaves - new_leaves
    else:
        changed = set(new_leaves)
        removed = set()
    if changed or removed:
        for key, theirs in managers.items():
            theirs -= changed
            theirs -= removed
        mine = managers.setdefault((manager, "Update"), set())
        mine |= changed
    write_managers(new, managers)
