"""The scheduler (reference: pkg/scheduler): cache, queue, framework and
plugins, the scheduling loop, and the BatchBackend contract the GPU
backend (ops/backend.py) implements."""

from __future__ import annotations

from ..client.clientset import Client
from ..client.informer import SharedInformerFactory
from .batch_backend import BatchBackend  # noqa: F401
from .cache import Cache, Snapshot  # noqa: F401
from .config import (  # noqa: F401
    SchedulerConfig, load_config, scheduler_from_config,
)
from .extender import Extender, HTTPExtender  # noqa: F401
from .framework import CycleState, Framework, Handle  # noqa: F401
from .plugins import (  # noqa: F401
    DEFAULT_PLUGINS, DEFAULT_SCORE_WEIGHTS, build_default_plugins,
)
from .queue import SchedulingQueue  # noqa: F401
from .scheduler import Profile, Scheduler  # noqa: F401
from .types import (  # noqa: F401
    FitError, NodeInfo, PodInfo, QueuedPodInfo, Status,
)


def new_default_framework(client: Client, informer_factory=None,
                          profile_name: str = "default-scheduler",
                          enabled: list[str] | None = None,
                          plugin_args: dict | None = None,
                          score_weights: dict[str, int] | None = None
                          ) -> Framework:
    handle = Handle(client=client, informer_factory=informer_factory)
    plugins = build_default_plugins(handle, enabled, plugin_args)
    return Framework(profile_name, plugins,
                     score_weights=score_weights or DEFAULT_SCORE_WEIGHTS,
                     handle=handle)


def new_scheduler(client: Client, informer_factory: SharedInformerFactory,
                  profiles: dict[str, Profile] | None = None) -> Scheduler:
    """scheduler.New (scheduler.go:239) with default profile."""
    if profiles is None:
        fw = new_default_framework(client, informer_factory)
        profiles = {"default-scheduler": Profile(fw)}
    return Scheduler(client, informer_factory, profiles)
