"""In-tree plugins + registry.

Reference: pkg/scheduler/framework/plugins/registry.go:47-80 (all plugins),
apis/config/v1/default_plugins.go:28-56 (default enablement + weights).
"""

from __future__ import annotations

from ..framework import Handle, Plugin, Registry
from .coscheduling import Coscheduling
from .defaultbinder import DefaultBinder
from .defaultpreemption import DefaultPreemption
from .interpodaffinity import InterPodAffinity
from .nodebasic import (
    ImageLocality, NodeAffinity, NodeName, NodePorts, NodeUnschedulable,
    TaintToleration,
)
from .noderesources import NodeResourcesBalancedAllocation, NodeResourcesFit
from .nodevolumelimits import NodeVolumeLimits
from .podtopologyspread import PodTopologySpread
from .queuesort import PrioritySort
from .selectorspread import SelectorSpread
from .volumebinding import VolumeBinding
from .volumerestrictions import VolumeRestrictions
from .volumezone import VolumeZone

# default score weights (default_plugins.go: NodeResourcesBalancedAllocation 1,
# ImageLocality 1, InterPodAffinity 1, NodeResourcesFit 1, NodeAffinity 1,
# PodTopologySpread 2, TaintToleration 1)
DEFAULT_SCORE_WEIGHTS = {
    "NodeResourcesBalancedAllocation": 1,
    "ImageLocality": 1,
    "InterPodAffinity": 1,
    "NodeResourcesFit": 1,
    "NodeAffinity": 1,
    "PodTopologySpread": 2,
    "TaintToleration": 1,
}


def in_tree_registry() -> Registry:
    """Name -> factory(args, handle) (runtime/registry.go)."""
    return {
        "PrioritySort": lambda args, h: PrioritySort(),
        "NodeName": lambda args, h: NodeName(),
        "NodePorts": lambda args, h: NodePorts(),
        "NodeUnschedulable": lambda args, h: NodeUnschedulable(),
        "NodeAffinity": lambda args, h: NodeAffinity(),
        "TaintToleration": lambda args, h: TaintToleration(),
        "ImageLocality": lambda args, h: ImageLocality(),
        "NodeResourcesFit": lambda args, h: NodeResourcesFit(**(args or {})),
        "NodeResourcesBalancedAllocation":
            lambda args, h: NodeResourcesBalancedAllocation(**(args or {})),
        "PodTopologySpread": lambda args, h: PodTopologySpread(),
        "InterPodAffinity": lambda args, h: InterPodAffinity(h),
        "DefaultBinder": lambda args, h: DefaultBinder(h.client),
        "DefaultPreemption": lambda args, h: DefaultPreemption(h.client),
        "Coscheduling": lambda args, h: Coscheduling(h.client, h),
        "VolumeBinding":
            lambda args, h: VolumeBinding(h.client, h.informer_factory),
        "VolumeRestrictions":
            lambda args, h: VolumeRestrictions(h.informer_factory),
        "VolumeZone": lambda args, h: VolumeZone(h.informer_factory),
        "NodeVolumeLimits":
            lambda args, h: NodeVolumeLimits(h.informer_factory),
        "SelectorSpread": lambda args, h: SelectorSpread(h.informer_factory),
    }


DEFAULT_PLUGINS = [
    "PrioritySort",
    "NodeUnschedulable",
    "NodeName",
    "NodePorts",
    "NodeAffinity",
    "NodeResourcesFit",
    "TaintToleration",
    "PodTopologySpread",
    "InterPodAffinity",
    "NodeResourcesBalancedAllocation",
    "ImageLocality",
    "VolumeBinding",
    "VolumeRestrictions",
    "VolumeZone",
    "NodeVolumeLimits",
    "DefaultPreemption",
    "DefaultBinder",
]
# SelectorSpread is registered but not default-enabled (default_plugins.go:
# PodTopologySpread subsumed it in v1.25+).


def build_default_plugins(handle: Handle, enabled: list[str] | None = None,
                          plugin_args: dict[str, dict] | None = None) -> list[Plugin]:
    registry = in_tree_registry()
    plugin_args = plugin_args or {}
    return [registry[name](plugin_args.get(name), handle)
            for name in (enabled or DEFAULT_PLUGINS)]
