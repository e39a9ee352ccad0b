"""Controller manager: runs the controller fleet behind leader election.

Reference: cmd/kube-controller-manager/app/controllermanager.go:425-467 —
one process, shared informer factory, leader-elected, each controller with
its own workqueue + workers.

A copy of kubernetes_tpu/controllers/manager.py: the same classes,
names and logic, over this package's api/, client/ and store/.
A controller whose constructor raises ModuleNotFoundError (the CSR
signer and the root-CA publisher without the cryptography package) is
left out with a warning, and the rest run.
"""

from __future__ import annotations

import logging
import threading

from ..client.clientset import Client
from ..client.informer import SharedInformerFactory
from ..client.leaderelection import LeaderElector
from .cronjob import CronJobController
from .daemonset import DaemonSetController
from .deployment import DeploymentController
from .disruption import DisruptionController
from .garbagecollector import GarbageCollector
from .storageversion import StorageVersionGC
from .hpa import HorizontalPodAutoscaler
from .job import JobController
from .namespace import NamespaceController
from .nodelifecycle import NodeLifecycleController
from .podgc import PodGCController
from .replicaset import ReplicaSetController
from .resourcequota import ResourceQuotaController
from .serviceaccount import ServiceAccountController
from .statefulset import StatefulSetController
from .bootstrap import BootstrapSigner, TokenCleaner
from .certificates import (
    CSRApprovingController, CSRCleanerController, CSRSigningController,
)
from .endpointslice import EndpointSliceController
from .nodeipam import NodeIpamController
from .replication import ReplicationControllerController
from .rootca import RootCACertPublisher
from .ttl import TTLController
from .ttlafterfinished import TTLAfterFinishedController
from .clusterroleaggregation import ClusterRoleAggregationController
from .endpointslicemirroring import EndpointSliceMirroringController
from .volume import (
    AttachDetachController, EphemeralVolumeController,
    PersistentVolumeController, PVCProtectionController,
    PVProtectionController, VolumeExpandController,
)

logger = logging.getLogger(__name__)

# startup list mirrors controllermanager.go:425-467; bootstrapsigner and
# tokencleaner are registered but off by default, same as the reference
# (controllermanager.go ControllersDisabledByDefault); nodeipam is gated on
# --allocate-node-cidrs there, off by default here too
DEFAULT_CONTROLLERS = ("deployment", "replicaset", "statefulset", "daemonset",
                       "job", "cronjob", "garbagecollector", "nodelifecycle",
                       "disruption", "namespace", "resourcequota",
                       "serviceaccount", "podgc", "ttlafterfinished",
                       "horizontalpodautoscaler", "endpointslice",
                       "replicationcontroller", "csrapproving", "csrsigning",
                       "csrcleaner", "ttl", "root-ca-cert-publisher",
                       "persistentvolume-binder", "pvc-protection",
                       "pv-protection", "attachdetach", "ephemeral-volume",
                       "storage-version-gc", "clusterrole-aggregation",
                       "endpointslicemirroring", "persistentvolume-expander")


class ControllerManager:
    # name -> constructor; the complete registry (controllermanager.go's
    # NewControllerInitializers).  Class-level so tooling/tests can audit
    # that every controller is wired without instantiating anything.
    CTORS = {
            "deployment": DeploymentController,
            "replicaset": ReplicaSetController,
            "statefulset": StatefulSetController,
            "daemonset": DaemonSetController,
            "job": JobController,
            "cronjob": CronJobController,
            "garbagecollector": GarbageCollector,
            "nodelifecycle": NodeLifecycleController,
            "disruption": DisruptionController,
            "namespace": NamespaceController,
            "resourcequota": ResourceQuotaController,
            "serviceaccount": ServiceAccountController,
            "podgc": PodGCController,
            "ttlafterfinished": TTLAfterFinishedController,
            "horizontalpodautoscaler": HorizontalPodAutoscaler,
            "endpointslice": EndpointSliceController,
            "replicationcontroller": ReplicationControllerController,
            "csrapproving": CSRApprovingController,
            "csrsigning": CSRSigningController,
            "csrcleaner": CSRCleanerController,
            "ttl": TTLController,
            "root-ca-cert-publisher": RootCACertPublisher,
            "storage-version-gc": StorageVersionGC,
            "persistentvolume-binder": PersistentVolumeController,
            "pvc-protection": PVCProtectionController,
            "pv-protection": PVProtectionController,
            "attachdetach": AttachDetachController,
            "ephemeral-volume": EphemeralVolumeController,
            "clusterrole-aggregation": ClusterRoleAggregationController,
            "endpointslicemirroring": EndpointSliceMirroringController,
            "persistentvolume-expander": VolumeExpandController,
            # registered but disabled by default (reference parity):
            "nodeipam": NodeIpamController,
            "tokencleaner": TokenCleaner,
            "bootstrapsigner": BootstrapSigner,
    }

    def __init__(self, client: Client, factory: SharedInformerFactory,
                 controllers: tuple[str, ...] = DEFAULT_CONTROLLERS,
                 leader_elect: bool = False, identity: str | None = None):
        self.client = client
        self.factory = factory
        self.controllers: dict[str, object] = {}
        for name in controllers:
            try:
                self.controllers[name] = self.CTORS[name](client, factory)
            except ModuleNotFoundError as e:
                # optional-dependency gate (e.g. the CSR signer needs the
                # cryptography package): run degraded rather than not at all
                logger.warning("controller %s disabled: %s", name, e)
        self._elector: LeaderElector | None = None
        self._leader_elect = leader_elect
        self._identity = identity
        self._running = False

    def run(self) -> None:
        if self._leader_elect:
            self._elector = LeaderElector(
                self.client, "kube-controller-manager",
                identity=self._identity,
                on_started_leading=self._start_all,
                on_stopped_leading=self._stop_all)
            self._elector.run()
        else:
            self._start_all()

    def _start_all(self) -> None:
        if self._running:
            return
        self._running = True
        for name, c in self.controllers.items():
            logger.info("starting controller %s", name)
            c.run()

    def _stop_all(self) -> None:
        if not self._running:
            return
        self._running = False
        for c in self.controllers.values():
            c.stop()

    def stop(self) -> None:
        if self._elector:
            self._elector.stop()
        self._stop_all()
