"""CustomResourceDefinition serving.

Reference: staging/src/k8s.io/apiextensions-apiserver — CRD objects create
new REST resources at /apis/{group}/{version}/...; custom objects are
validated against the CRD's openAPIV3Schema (structural-schema subset:
type, required, properties, items, enum, minimum/maximum, pattern) and
stored like any built-in.  The coscheduling PodGroup CRD rides this.

Depth beyond the basic registry (each maps to an apiextensions
subsystem):
  - structural pruning + defaulting (pkg/apiserver/schema/pruning,
    defaulting): unknown fields are dropped on write unless
    x-kubernetes-preserve-unknown-fields; schema `default`s fill absent
    fields
  - CEL validation rules (pkg/apiserver/schema/cel):
    x-kubernetes-validations [{rule, message}] evaluated against `self`
    (+ `oldSelf` on update) at every schema level, via cel.py
  - multi-version + conversion (pkg/apiserver/conversion): objects are
    STORED at the single storage version and converted on the wire;
    strategy None rewrites apiVersion, strategy Webhook POSTs a
    ConversionReview to the configured URL
  - status/scale subresources (pkg/registry/customresource): served
    only when spec.subresources declares them; scale reads/writes
    through the configured JSON paths
"""

from __future__ import annotations

import re
import threading
from typing import Dict, List, Optional

CRDS = "customresourcedefinitions"


class ValidationError(ValueError):
    pass


# -- structural schema: pruning + defaulting -----------------------------

def prune(obj, schema: dict, root: bool = True):
    """Drop fields not in the structural schema (pruning.Prune):
    unknown fields vanish on write instead of persisting as junk.
    x-kubernetes-preserve-unknown-fields or a non-False
    additionalProperties keeps a subtree as-is."""
    if not schema or schema.get("x-kubernetes-preserve-unknown-fields"):
        return obj
    if isinstance(obj, dict):
        props = schema.get("properties")
        addl = schema.get("additionalProperties")
        if props is None and not isinstance(addl, dict):
            return obj  # untyped object: nothing to prune against
        out = {}
        for key, val in obj.items():
            if root and key in ("apiVersion", "kind", "metadata"):
                out[key] = val  # ObjectMeta is never pruned
            elif props is not None and key in props:
                out[key] = prune(val, props[key], root=False)
            elif isinstance(addl, dict):
                # map values prune against the value schema
                out[key] = prune(val, addl, root=False)
            elif addl not in (None, False):
                out[key] = val
        return out
    if isinstance(obj, list) and schema.get("items"):
        return [prune(v, schema["items"], root=False) for v in obj]
    return obj


def apply_defaults(obj, schema: dict):
    """Fill absent fields carrying a schema `default`
    (defaulting.Default) — applied after pruning, before validation."""
    if not schema:
        return obj
    if isinstance(obj, dict):
        props = schema.get("properties") or {}
        for key, sub in props.items():
            if key not in obj and "default" in sub:
                import copy
                obj[key] = copy.deepcopy(sub["default"])
            if key in obj:
                obj[key] = apply_defaults(obj[key], sub)
        addl = schema.get("additionalProperties")
        if isinstance(addl, dict):
            for key in obj:
                if key not in props:
                    obj[key] = apply_defaults(obj[key], addl)
    elif isinstance(obj, list) and schema.get("items"):
        obj = [apply_defaults(v, schema["items"]) for v in obj]
    return obj


def validate_rules(obj, schema: dict, old=None, path: str = "") -> None:
    """x-kubernetes-validations: CEL rules hold at every schema level,
    with `self` bound to the value at that level (schema/cel/validation
    .go).  A rule error fails the write, same as a false rule."""
    if not schema:
        return
    from . import cel
    where = path or "<root>"
    for entry in schema.get("x-kubernetes-validations") or ():
        rule = entry.get("rule")
        if not rule:
            continue
        if old is None and "oldSelf" in rule:
            # transition rules only run where an old value exists to
            # correlate against (cel/validation.go) — never on create
            continue
        try:
            ok = cel.evaluate(rule, obj, old)
        except cel.CELError as e:
            raise ValidationError(
                f"{where}: rule {rule!r} errored: {e}") from None
        if not ok:
            raise ValidationError(
                f"{where}: {entry.get('message') or 'failed rule: ' + rule}")
    if isinstance(obj, dict):
        props = schema.get("properties") or {}
        for key, sub in props.items():
            if key in obj:
                old_val = old.get(key) if isinstance(old, dict) else None
                validate_rules(obj[key], sub, old_val, f"{path}.{key}")
        addl = schema.get("additionalProperties")
        if isinstance(addl, dict):
            for key, val in obj.items():
                if key not in props:
                    old_val = (old.get(key)
                               if isinstance(old, dict) else None)
                    validate_rules(val, addl, old_val, f"{path}.{key}")
    elif isinstance(obj, list) and schema.get("items"):
        for i, val in enumerate(obj):
            validate_rules(val, schema["items"], None, f"{path}[{i}]")


def validate_schema(obj, schema: dict, path: str = "") -> None:
    """Validate obj against an openAPIV3Schema subset."""
    if not schema:
        return
    typ = schema.get("type")
    where = path or "<root>"
    if typ == "object" or (typ is None and "properties" in schema):
        if not isinstance(obj, dict):
            raise ValidationError("%s: expected object" % where)
        props = schema.get("properties", {})
        for req in schema.get("required", []):
            if req not in obj:
                raise ValidationError("%s: missing required field %r"
                                      % (where, req))
        for key, val in obj.items():
            if key in props:
                validate_schema(val, props[key], path + "." + key)
            elif schema.get("additionalProperties") is False:
                raise ValidationError("%s: unknown field %r" % (where, key))
    elif typ == "array":
        if not isinstance(obj, list):
            raise ValidationError("%s: expected array" % where)
        items = schema.get("items")
        if items:
            for i, v in enumerate(obj):
                validate_schema(v, items, "%s[%d]" % (path, i))
    elif typ == "string":
        if not isinstance(obj, str):
            raise ValidationError("%s: expected string" % where)
        pat = schema.get("pattern")
        if pat and not re.search(pat, obj):
            raise ValidationError("%s: does not match pattern %s"
                                  % (where, pat))
    elif typ == "integer":
        if not isinstance(obj, int) or isinstance(obj, bool):
            raise ValidationError("%s: expected integer" % where)
    elif typ == "number":
        if not isinstance(obj, (int, float)) or isinstance(obj, bool):
            raise ValidationError("%s: expected number" % where)
    elif typ == "boolean":
        if not isinstance(obj, bool):
            raise ValidationError("%s: expected boolean" % where)
    if "enum" in schema and obj not in schema["enum"]:
        raise ValidationError("%s: %r not in enum %s"
                              % (where, obj, schema["enum"]))
    if isinstance(obj, (int, float)) and not isinstance(obj, bool):
        if "minimum" in schema and obj < schema["minimum"]:
            raise ValidationError("%s: %s below minimum %s"
                                  % (where, obj, schema["minimum"]))
        if "maximum" in schema and obj > schema["maximum"]:
            raise ValidationError("%s: %s above maximum %s"
                                  % (where, obj, schema["maximum"]))


class CRDRegistry:
    """Tracks established CRDs; maps (group, plural) -> serving info."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._by_plural: Dict[str, dict] = {}

    def establish(self, crd_obj: dict, dry_run: bool = False) -> dict:
        """Validate + index a CRD object; returns it with status set.

        dry_run validates and stamps status WITHOUT indexing — callers
        run that before the store write (422 on bad spec) and commit
        the index only after the write succeeds, so a CAS-rejected
        update can't change what the server serves."""
        spec = crd_obj.get("spec") or {}
        group = spec.get("group")
        names = spec.get("names") or {}
        plural = names.get("plural")
        kind = names.get("kind")
        if not group or not plural or not kind:
            raise ValidationError(
                "CRD needs spec.group, spec.names.plural, spec.names.kind")
        versions = spec.get("versions") or [{"name": "v1", "served": True,
                                             "storage": True}]
        served = [v for v in versions if v.get("served", True)]
        if not served:
            raise ValidationError("CRD has no served versions")
        storage = [v["name"] for v in versions if v.get("storage")]
        if len(storage) > 1:
            raise ValidationError("CRD declares %d storage versions; "
                                  "exactly one allowed" % len(storage))
        if not storage and len(versions) > 1:
            # a single version is unambiguously the storage version;
            # multiple versions with none flagged would make the
            # storage form arbitrary (apiextensions requires exactly
            # one storage=true)
            raise ValidationError(
                "multi-version CRD must flag exactly one storage version")
        conversion = spec.get("conversion") or {"strategy": "None"}
        strategy = conversion.get("strategy", "None")
        if strategy not in ("None", "Webhook"):
            raise ValidationError(f"unknown conversion strategy "
                                  f"{strategy!r}")
        if strategy == "Webhook" and not ((conversion.get("webhook") or {})
                                          .get("clientConfig") or {}
                                          ).get("url"):
            raise ValidationError(
                "Webhook conversion needs webhook.clientConfig.url")
        info = {
            "group": group, "plural": plural, "kind": kind,
            "singular": names.get("singular", kind.lower()),
            "short_names": names.get("shortNames", []),
            "namespaced": spec.get("scope", "Namespaced") == "Namespaced",
            "versions": [v["name"] for v in served],
            "storage_version": storage[0] if storage
            else served[0]["name"],
            "schemas": {v["name"]: ((v.get("schema") or {})
                                    .get("openAPIV3Schema") or {})
                        for v in served},
            "conversion": conversion,
            "subresources": spec.get("subresources") or {},
        }
        if not dry_run:
            with self._lock:
                self._by_plural[plural] = info
                for short in info["short_names"]:
                    self._by_plural.setdefault(short, info)
        crd_obj.setdefault("status", {})["conditions"] = [
            {"type": "Established", "status": "True"}]
        return crd_obj

    def remove(self, crd_obj: dict) -> None:
        names = (crd_obj.get("spec") or {}).get("names") or {}
        with self._lock:
            info = self._by_plural.pop(names.get("plural", ""), None)
            if info:
                for short in info["short_names"]:
                    if self._by_plural.get(short) is info:
                        del self._by_plural[short]

    def lookup(self, plural: str) -> Optional[dict]:
        with self._lock:
            return self._by_plural.get(plural)

    def groups(self) -> set:
        """API groups currently served by established CRDs.  The aggregator
        treats these as locally-served (the reference's autoregister
        controller pins Local APIServices for CRD groups)."""
        with self._lock:
            return {info["group"] for info in self._by_plural.values()}

    def resources(self) -> List[dict]:
        with self._lock:
            seen = []
            for info in self._by_plural.values():
                if info not in seen:
                    seen.append(info)
            return seen

    def validate_object(self, plural: str, version: str, obj: dict) -> None:
        info = self.lookup(plural)
        if info is None:
            raise ValidationError("no CRD for resource %r" % plural)
        if version not in info["versions"]:
            raise ValidationError("version %r not served for %r"
                                  % (version, plural))
        schema = info["schemas"].get(version) or {}
        validate_schema(obj, schema)

    def coerce(self, plural: str, version: str, obj: dict,
               old: dict | None = None) -> dict:
        """The full custom-resource write pipeline: prune unknown
        fields, apply defaults, validate the structural schema, then
        the CEL rules (with oldSelf on update).  Returns the object to
        persist."""
        info = self.lookup(plural)
        if info is None:
            raise ValidationError("no CRD for resource %r" % plural)
        if version not in info["versions"]:
            raise ValidationError("version %r not served for %r"
                                  % (version, plural))
        schema = info["schemas"].get(version) or {}
        obj = prune(obj, schema)
        obj = apply_defaults(obj, schema)
        validate_schema(obj, schema)
        if old is not None:
            # transition rules compare same-shaped objects: the stored
            # old object converts to the REQUEST version first
            old = self.convert(plural, old, version)
        validate_rules(obj, schema, old)
        return obj

    # -- multi-version conversion ----------------------------------------

    def convert(self, plural: str, obj: dict, target_version: str) -> dict:
        """Serve `obj` at target_version (conversion/converter.go).

        None strategy: same schema at every version — only apiVersion
        is rewritten.  Webhook: POST a ConversionReview to the CRD's
        configured URL and take the returned converted object."""
        return self.convert_many(plural, [obj], target_version)[0]

    def convert_many(self, plural: str, objs: list[dict],
                     target_version: str) -> list[dict]:
        """Batch conversion: one ConversionReview for every object that
        needs converting (the protocol's `objects` list), so a list of
        N webhook-strategy objects costs one round trip, not N."""
        info = self.lookup(plural)
        if info is None:
            return objs
        need = [i for i, o in enumerate(objs)
                if (o.get("apiVersion") or "").rpartition("/")[2]
                not in ("", target_version)]
        if not need:
            return objs
        out = list(objs)
        if info["conversion"].get("strategy", "None") == "None":
            for i in need:
                converted = dict(objs[i])
                converted["apiVersion"] = \
                    f"{info['group']}/{target_version}"
                out[i] = converted
            return out
        converted = self._webhook_convert(info, [objs[i] for i in need],
                                          target_version)
        for slot, obj in zip(need, converted):
            out[slot] = obj
        return out

    def _webhook_convert(self, info: dict, objs: list[dict],
                         target_version: str) -> list[dict]:
        import json
        import urllib.request
        import uuid
        url = info["conversion"]["webhook"]["clientConfig"]["url"]
        review = {
            "kind": "ConversionReview",
            "apiVersion": "apiextensions.k8s.io/v1",
            "request": {"uid": uuid.uuid4().hex,
                        "desiredAPIVersion":
                            f"{info['group']}/{target_version}",
                        "objects": objs},
        }
        req = urllib.request.Request(
            url, data=json.dumps(review).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=10) as resp:
                body = json.loads(resp.read())
        except (OSError, ValueError) as e:
            raise ValidationError(
                f"conversion webhook {url} failed: {e}") from None
        response = body.get("response") or {}
        if (response.get("result") or {}).get("status") == "Failure":
            raise ValidationError(
                "conversion webhook rejected: "
                + str((response.get("result") or {}).get("message")))
        converted = response.get("convertedObjects") or []
        if len(converted) != len(objs):
            raise ValidationError(
                "conversion webhook returned %d objects for %d inputs"
                % (len(converted), len(objs)))
        return converted

    def to_storage(self, plural: str, obj: dict) -> dict:
        info = self.lookup(plural)
        if info is None:
            return obj
        return self.convert(plural, obj, info["storage_version"])

    # -- subresource declarations ----------------------------------------

    def has_status_subresource(self, plural: str) -> bool:
        info = self.lookup(plural)
        return bool(info and "status" in info["subresources"])

    def scale_paths(self, plural: str) -> Optional[dict]:
        info = self.lookup(plural)
        if info is None:
            return None
        return info["subresources"].get("scale")
