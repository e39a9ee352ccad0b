"""Preemption evaluator.

Reference: pkg/scheduler/framework/preemption/preemption.go
  Evaluator.Preempt (:146): eligibility -> findCandidates (:206) ->
  SelectCandidate (:307) -> prepareCandidate (evict victims, nominate).
  DryRunPreemption (:579): per candidate node, remove lower-priority pods
  until the pod fits, then re-add as many victims as possible
  (highest-priority first) while it still fits — minimizing disruption.
  Candidate order: fewest PDB violations, then highest victim priority
  lowest, then smallest priority sum, then fewest victims
  (pickOneNodeForPreemption).

PodDisruptionBudget accounting is the minimal faithful subset: a victim
covered by a PDB with disruptionsAllowed <= 0 counts as a violation.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

from ..api import meta
from ..api.labels import selector_from_dict
from ..api.meta import Obj
from ..client.clientset import PDBS, PODS, Client
from .cache import Snapshot
from .framework import CycleState, Framework
from .types import (
    SUCCESS, UNSCHEDULABLE, UNSCHEDULABLE_AND_UNRESOLVABLE,
    NodeInfo, PodInfo, Status, is_success,
)

logger = logging.getLogger(__name__)


@dataclass
class Candidate:
    node_name: str
    victims: list[PodInfo] = field(default_factory=list)
    num_pdb_violations: int = 0


def evict_victims(client: Client, victims: list[PodInfo],
                  preemptor_key: str, node_name: str) -> None:
    """THE eviction site (prepareCandidate's delete+event loop).  Both
    the per-pod Evaluator and the batched bulk-commit path route here —
    a static check (tests/test_verify_static.py) pins that no other
    scheduler code issues pod deletes, so preemption accounting
    (events, metrics, victim dedup) can never fork."""
    for v in victims:
        try:
            client.delete(PODS, meta.namespace(v.pod), meta.name(v.pod))
            client.create_event(
                v.pod, "Preempted",
                f"Preempted by {preemptor_key} on node {node_name}")
        except Exception as e:  # noqa: BLE001 - victim may be gone already
            logger.info("preemption: victim %s delete failed: %s", v.key, e)


class Evaluator:
    def __init__(self, framework: Framework, client: Client,
                 observer=None):
        self.fw = framework
        self.client = client
        # observer(victim_count) — feeds preemption_attempts_total /
        # preemption_victims (metrics.go preemption counters)
        self.observer = observer

    # -- entry (preemption.go:146) ---------------------------------------

    def preempt(self, state: CycleState, pod_info: PodInfo,
                node_statuses: dict[str, Status], snapshot: Snapshot
                ) -> tuple[str | None, Status]:
        if not self._pod_eligible(pod_info, snapshot):
            return None, Status(UNSCHEDULABLE, "pod is not eligible for preemption")
        candidates = self.find_candidates(state, pod_info, node_statuses, snapshot)
        if not candidates:
            return None, Status(UNSCHEDULABLE, "no preemption candidates")
        best = self.select_candidate(candidates)
        status = self._prepare_candidate(best, pod_info)
        if not is_success(status):
            return None, status
        if self.observer is not None:
            self.observer(len(best.victims))
        return best.node_name, Status(SUCCESS)

    def preempt_among(self, state: CycleState, pod_info: PodInfo,
                      node_infos: list[NodeInfo], snapshot: Snapshot
                      ) -> tuple[str | None, Status]:
        """preempt() restricted to a pre-filtered candidate node list —
        the host tail of the batched TPU preemption path (the device
        already proved these nodes resource-feasible after victim
        removal; the exact reprieve/PDB dry-run still runs here, so
        victim selection semantics match the per-pod path)."""
        if not self._pod_eligible(pod_info, snapshot):
            return None, Status(UNSCHEDULABLE, "pod is not eligible for preemption")
        pdbs = self._list_pdbs(meta.namespace(pod_info.pod))
        candidates = []
        for ni in node_infos:
            cand = self._dry_run_on_node(state, pod_info, ni, pdbs)
            if cand is not None:
                candidates.append(cand)
        if not candidates:
            return None, Status(UNSCHEDULABLE, "no preemption candidates")
        best = self.select_candidate(candidates)
        status = self._prepare_candidate(best, pod_info)
        if not is_success(status):
            return None, status
        if self.observer is not None:
            self.observer(len(best.victims))
        return best.node_name, Status(SUCCESS)

    def _pod_eligible(self, pod_info: PodInfo, snapshot: Snapshot) -> bool:
        """podEligibleToPreemptOthers: if the pod already nominated a node
        and a victim there is still terminating, wait instead of preempting
        again."""
        nom = pod_info.nominated_node_name
        if nom:
            ni = snapshot.get(nom)
            if ni is not None:
                for pi in ni.pods:
                    if (meta.deletion_timestamp(pi.pod) is not None
                            and pi.priority < pod_info.priority):
                        return False
        preemption_policy = (pod_info.pod.get("spec") or {}).get(
            "preemptionPolicy", "PreemptLowerPriority")
        return preemption_policy != "Never"

    # -- candidates (preemption.go:206,579) ------------------------------

    def find_candidates(self, state: CycleState, pod_info: PodInfo,
                        node_statuses: dict[str, Status],
                        snapshot: Snapshot) -> list[Candidate]:
        pdbs = self._list_pdbs(meta.namespace(pod_info.pod))
        out: list[Candidate] = []
        for ni in snapshot.list():
            st = node_statuses.get(ni.name)
            # nodes that failed UnschedulableAndUnresolvable can't be fixed
            # by preemption (:225 nodesWherePreemptionMightHelp)
            if st is not None and st.code == UNSCHEDULABLE_AND_UNRESOLVABLE:
                continue
            cand = self._dry_run_on_node(state, pod_info, ni, pdbs)
            if cand is not None:
                out.append(cand)
        return out

    def _dry_run_on_node(self, state: CycleState, pod_info: PodInfo,
                         ni: NodeInfo, pdbs: list[tuple]) -> Candidate | None:
        """selectVictimsOnNode: remove ALL lower-priority pods, check fit,
        then re-add (highest priority first, PDB-violating last) while the
        pod still fits."""
        node_copy = ni.clone()
        state_copy = state.clone()
        potential = [pi for pi in ni.pods if pi.priority < pod_info.priority]
        if not potential:
            return None
        for v in potential:
            self._remove_pod(state_copy, pod_info, v, node_copy)
        # the fit checks run WITH nominated pods (defaultpreemption.go
        # SelectVictimsOnNode -> RunFilterPluginsWithNominatedPods):
        # an equal-or-higher-priority pod already nominated onto this
        # node claims its capacity, so two preemptors in one failed
        # batch cannot both nominate the same slot and cascade into
        # repeat preemption rounds (observed: 3x preemption attempts
        # per pod and a 37% escape storm before this)
        filter_fn = self.fw.run_filter_plugins_with_nominated_pods
        if not is_success(filter_fn(state_copy, pod_info, node_copy)):
            return None

        violating, non_violating = [], []
        for v in potential:
            (violating if self._violates_pdb(v, pdbs) else non_violating).append(v)
        victims: list[PodInfo] = []
        num_violations = 0

        def reprieve(v: PodInfo, counts_violation: bool) -> None:
            nonlocal num_violations
            self._add_pod(state_copy, pod_info, v, node_copy)
            if is_success(filter_fn(state_copy, pod_info, node_copy)):
                return  # pod still fits with v back -> v is spared
            self._remove_pod(state_copy, pod_info, v, node_copy)
            victims.append(v)
            if counts_violation:
                num_violations += 1

        for v in sorted(violating, key=lambda p: -p.priority):
            reprieve(v, True)
        for v in sorted(non_violating, key=lambda p: -p.priority):
            reprieve(v, False)
        if not victims:
            return None
        return Candidate(ni.name, victims, num_violations)

    def _remove_pod(self, state, pod_info, victim, node_info):
        node_info.remove_pod(victim.pod)
        for p in self.fw.pre_filter:
            p.remove_pod(state, pod_info, victim, node_info)

    def _add_pod(self, state, pod_info, victim, node_info):
        node_info.add_pod(victim)
        for p in self.fw.pre_filter:
            p.add_pod(state, pod_info, victim, node_info)

    # -- selection (preemption.go:307 pickOneNodeForPreemption) ----------

    @staticmethod
    def select_candidate(candidates: list[Candidate]) -> Candidate:
        def key(c: Candidate):
            highest = max((v.priority for v in c.victims), default=0)
            prio_sum = sum(v.priority for v in c.victims)
            return (c.num_pdb_violations, highest, prio_sum, len(c.victims))
        return min(candidates, key=key)

    # -- prepare (evict + nominate) --------------------------------------

    def _prepare_candidate(self, cand: Candidate, pod_info: PodInfo) -> Status:
        evict_victims(self.client, cand.victims, pod_info.key, cand.node_name)
        return Status(SUCCESS)

    # -- PDBs ------------------------------------------------------------

    def _list_pdbs(self, namespace: str) -> list[tuple]:
        try:
            items, _ = self.client.list(PDBS, namespace)
        except Exception:  # noqa: BLE001
            return []
        out = []
        for pdb in items:
            spec = pdb.get("spec") or {}
            sel = selector_from_dict(spec.get("selector") or {})
            allowed = (pdb.get("status") or {}).get("disruptionsAllowed", 0)
            out.append((sel, allowed))
        return out

    @staticmethod
    def _violates_pdb(victim: PodInfo, pdbs: list[tuple]) -> bool:
        return any(sel.matches(victim.labels) and allowed <= 0
                   for sel, allowed in pdbs)
