"""Field selectors (apimachinery/pkg/fields): comma-joined dotted-path
equality terms — `spec.nodeName=X`, `metadata.name!=y`, `a.b==c`.

The load-bearing consumer is the reference kubelet's
spec.nodeName=<node> pod watch (pkg/kubelet/config/apiserver.go:38).
Shared by the apiserver (list/watch fieldSelector params) and kubectl
(--field-selector), so the two sides cannot drift.
"""

from __future__ import annotations


def field_of(obj: dict, dotted: str):
    """Dotted-path read ('spec.nodeName' -> obj['spec']['nodeName']);
    None when any hop is missing."""
    cur = obj
    for part in dotted.split("."):
        if not isinstance(cur, dict):
            return None
        cur = cur.get(part)
    return cur


def _term_value(obj: dict, path: str) -> str:
    v = field_of(obj, path.strip())
    # absent compares as '' — but present falsy values (0, False) must
    # keep their string form, so no `or ""` coercion
    return "" if v is None else str(v)


def matches_field_selector(obj: dict, selector: str) -> bool:
    """True when obj satisfies every term.  Raises ValueError on a
    malformed selector (a term with no operator) — the reference
    apiserver answers 400 'invalid field selector', never
    silently-match-everything."""
    for part in selector.split(","):
        part = part.strip()
        if not part:
            continue
        if "!=" in part:
            k, v = part.split("!=", 1)
            if _term_value(obj, k) == v.strip():
                return False
        elif "=" in part:
            k, _, v = part.partition("=")
            if _term_value(obj, k) != v.lstrip("=").strip():
                return False
        else:
            raise ValueError(f"invalid field selector term {part!r}")
    return True


def validate_field_selector(selector: str) -> None:
    """Raise ValueError for malformed selectors (probe with an empty
    object; only syntax matters)."""
    matches_field_selector({}, selector)
