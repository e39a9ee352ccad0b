"""Feature gates.

Reference: staging/src/k8s.io/component-base/featuregate/feature_gate.go —
a mutable map of named features with prerelease stages (Alpha default-off,
Beta default-on, GA locked-on), set from a --feature-gates key=value list;
plus pkg/features/kube_features.go, the per-project gate catalogue.

Semantics reproduced: unknown gate -> error; setting a GA/locked gate to a
non-default value -> error; Enabled() on an unknown gate -> error (catches
typos at call sites, as upstream does).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Mapping

ALPHA = "ALPHA"
BETA = "BETA"
GA = "GA"
DEPRECATED = "DEPRECATED"


@dataclass(frozen=True)
class FeatureSpec:
    default: bool
    prerelease: str = ALPHA
    lock_to_default: bool = False


class FeatureGate:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._specs: Dict[str, FeatureSpec] = {}
        self._enabled: Dict[str, bool] = {}

    def add(self, features: Mapping[str, FeatureSpec]) -> "FeatureGate":
        with self._lock:
            for name, spec in features.items():
                known = self._specs.get(name)
                if known is not None and known != spec:
                    raise ValueError("feature gate %r already registered "
                                     "with different spec" % name)
                self._specs[name] = spec
        return self

    def set_from_map(self, values: Mapping[str, bool]) -> None:
        with self._lock:
            for name, val in values.items():
                spec = self._specs.get(name)
                if spec is None:
                    raise ValueError("unrecognized feature gate: %s" % name)
                if spec.lock_to_default and val != spec.default:
                    raise ValueError(
                        "cannot set feature gate %s to %v, feature is locked"
                        " to %s" % (name, val, spec.default))
                self._enabled[name] = bool(val)

    def set(self, spec_str: str) -> None:
        """Parse 'Gate1=true,Gate2=false' (the --feature-gates flag form)."""
        values: Dict[str, bool] = {}
        for part in spec_str.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError("missing bool value for %s" % part)
            k, v = part.split("=", 1)
            lv = v.strip().lower()
            if lv not in ("true", "false"):
                raise ValueError("invalid value %r for feature gate %s"
                                 % (v, k))
            values[k.strip()] = lv == "true"
        self.set_from_map(values)

    def enabled(self, name: str) -> bool:
        with self._lock:
            if name in self._enabled:
                return self._enabled[name]
            spec = self._specs.get(name)
            if spec is None:
                raise ValueError("feature %r is not registered" % name)
            return spec.default

    def known_features(self) -> Dict[str, FeatureSpec]:
        with self._lock:
            return dict(self._specs)

    def deep_copy(self) -> "FeatureGate":
        fg = FeatureGate()
        with self._lock:
            fg._specs = dict(self._specs)
            fg._enabled = dict(self._enabled)
        return fg


# Project gate catalogue (pkg/features/kube_features.go analogue).  The
# TPU-specific gates control the batched backend the way upstream gates
# control scheduler features.
DEFAULT_FEATURES: Dict[str, FeatureSpec] = {
    # scheduler
    "TPUBatchAssign": FeatureSpec(default=True, prerelease=BETA),
    "TPUShardedAssign": FeatureSpec(default=True, prerelease=BETA),
    "TPUPallasKernels": FeatureSpec(default=True, prerelease=ALPHA),
    "PodSchedulingReadiness": FeatureSpec(default=False, prerelease=ALPHA),
    "PodDisruptionConditions": FeatureSpec(default=True, prerelease=BETA),
    "MinDomainsInPodTopologySpread": FeatureSpec(default=True, prerelease=BETA),
    "NodeInclusionPolicyInPodTopologySpread": FeatureSpec(default=True,
                                                          prerelease=BETA),
    # control plane
    "APIPriorityAndFairness": FeatureSpec(default=True, prerelease=BETA),
    "ServerSideApply": FeatureSpec(default=True, prerelease=GA,
                                   lock_to_default=True),
    "CustomResourceDefinitions": FeatureSpec(default=True, prerelease=GA,
                                             lock_to_default=True),
    # node
    "GracefulNodeShutdown": FeatureSpec(default=True, prerelease=BETA),
    "ContainerCheckpoint": FeatureSpec(default=False, prerelease=ALPHA),
    "KubeletTracing": FeatureSpec(default=False, prerelease=ALPHA),
}


default_feature_gate = FeatureGate().add(DEFAULT_FEATURES)
