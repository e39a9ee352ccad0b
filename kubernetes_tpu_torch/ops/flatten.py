"""Snapshot -> tensor flattener (the tensorization source for the TPU path).

Reference semantics being tensorized:
  NodeInfo/Resource aggregates   pkg/scheduler/framework/types.go:375,426
  incremental snapshotting       internal/cache/cache.go:197 (generation diff)
  NodeResourcesFit               plugins/noderesources/fit.go:253
  TaintToleration / NodeAffinity / NodePorts / NodeUnschedulable
  PodTopologySpread match counts filtering.go:40-51 (per-(key,value) counts)
  InterPodAffinity count maps    filtering.go:90-230

Scheme (see SURVEY.md §7 step 1):
  * All categorical data (label key=value pairs, label keys, taints, host
    ports, scalar resource names) goes through capped vocabularies ->
    integer ids -> dense 0/1 masks.  Vocab caps are static so jitted shapes
    never change; overflow routes the affected pod to the per-pod oracle
    path (the escape hatch) rather than producing wrong answers.
  * Node rows re-encode ONLY when their NodeInfo generation advanced
    (mirrors UpdateSnapshot's delta copy).  Rows are reused via a free list,
    so the node axis is stable across batches and padded to n_cap.
  * Topology-sensitive constraints (spread / pod (anti-)affinity) compile
    to "selector groups": a (topology_key, selector, namespaces) triple.
    Per node we maintain cnt[sg, row] = matching pods on that node; per
    batch the per-domain base counts are one bincount away.  The greedy
    assignment scan (models/assign.py) then updates these counts on device
    as it places pods, which is what gives the batch the same semantics as
    the reference's one-pod-at-a-time loop with assume() in between
    (SURVEY.md §7 hard part #1).

Everything here is host-side numpy; device arrays are built/updated by
ops/backend.py from these buffers.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field

import numpy as np

from ..api import meta
from ..api.labels import (
    EXISTS, GT, IN, LT, NOT_IN, DOES_NOT_EXIST, Selector, selector_from_dict,
)
from ..api.meta import Obj
from ..scheduler.cache import Snapshot
from ..scheduler.plugins.nodebasic import toleration_tolerates_taint
from ..scheduler.types import NodeInfo, PodInfo
from ..utils.fasthost import req_columns

logger = logging.getLogger(__name__)

# resource slot layout: [cpu_milli, memory, ephemeral] + scalar slots
CORE_R = 3

# constraint kinds (c_kind)
C_NONE = 0
C_SPREAD_HARD = 1      # DoNotSchedule topology spread
C_AFFINITY = 2         # required pod affinity term
C_ANTI_AFFINITY = 3    # required pod anti-affinity term
C_SPREAD_SCORE = 4     # ScheduleAnyway topology spread
C_PREF_AFFINITY = 5    # preferred pod (anti-)affinity, weight signed

UNSCHEDULABLE_TAINT = ("node.kubernetes.io/unschedulable", "", "NoSchedule")

# victim-tensor priority padding: empty slots sort AFTER every real pod
# (priorities are int32; kept as i32 on device — f32 loses exactness
# above 2^24 and the reprieve/tie-break ordering must be bit-faithful)
VICT_PAD = np.int32(2**31 - 1)


class VocabFullError(Exception):
    pass


class Vocab:
    """String-ish -> dense id with a hard cap (static shapes for jit)."""

    def __init__(self, cap: int):
        self.cap = cap
        self.ids: dict = {}
        self.items: list = []

    def get(self, key, create: bool = True) -> int | None:
        idx = self.ids.get(key)
        if idx is None and create:
            if len(self.items) >= self.cap:
                raise VocabFullError(f"vocab cap {self.cap} exceeded by {key!r}")
            idx = len(self.items)
            self.ids[key] = idx
            self.items.append(key)
        return idx

    def lookup(self, key) -> int | None:
        return self.ids.get(key)

    def __len__(self) -> int:
        return len(self.items)


@dataclass
class SelectorGroup:
    """(topology_key, selector, namespaces) — the unit of count bookkeeping.

    namespaceSelector terms resolve to a CONCRETE namespace set at
    registration (ClusterTensors.group_for_term); such groups keep the
    selector and base namespaces around so a namespace relabel can
    re-resolve the set in place (_refresh_ns_groups)."""

    topology_key: str
    selector: Selector
    namespaces: frozenset[str]
    ns_selector: Selector | None = None      # resolved-from selector, if any
    base_namespaces: frozenset[str] | None = None  # term's explicit namespaces

    def key(self):
        return (self.topology_key, self.selector, self.namespaces)

    def matches_pod(self, pi: PodInfo) -> bool:
        return (meta.namespace(pi.pod) in self.namespaces
                and self.selector.matches(pi.labels))


class GroupBucket:
    """One sg/asg tensor slot, possibly shared by several DISTINCT
    selector groups (hash-bucketed once the cap is full — the
    high-label-cardinality regime: thousands of per-service
    anti-affinity selectors vs a few dozen tensor slots).

    A shared bucket's counts are the UNION over its member groups —
    an UPPER BOUND on any single member's true count.  Sharing is only
    sound for constraints that treat counts as BLOCKERS (required
    anti-affinity; preferred terms, where inflation merely distorts a
    score): over-counts then only over-block, so a device-allowed
    placement is always truly legal, and a no-fit verdict for a pod
    riding a collided bucket escapes to the per-pod oracle.  Required
    AFFINITY and DoNotSchedule spread treat counts as ENABLERS — a
    union count could falsely satisfy them — so those constraints only
    ever use EXCLUSIVE (single-group) slots and keep the old
    full-registry escape behavior (allow_share gating in
    register_sg).  Wrong answers stay structurally impossible; only
    the escape rate varies with cardinality (backend stats)."""

    __slots__ = ("topology_key", "groups", "allow_share", "_by_kv",
                 "_complex")

    def __init__(self, group: SelectorGroup, allow_share: bool = False):
        self.topology_key = group.topology_key
        self.groups: list[SelectorGroup] = []
        self.allow_share = allow_share
        # members by their single exact (key, value), and the rest
        self._by_kv: dict[tuple[str, str], list[SelectorGroup]] = {}
        self._complex: list[SelectorGroup] = []
        self.add(group)

    def add(self, group: SelectorGroup) -> None:
        self.groups.append(group)
        kv = _exact_kv(group)
        if kv is None:
            self._complex.append(group)
        else:
            self._by_kv.setdefault(kv, []).append(group)

    def __getstate__(self):
        # a checkpoint holds the JAX package's fields only (either
        # package reads the other's); the index is rebuilt on load
        return None, {"topology_key": self.topology_key,
                      "groups": self.groups,
                      "allow_share": self.allow_share}

    def __setstate__(self, state) -> None:
        _, fields = state
        self.topology_key = fields["topology_key"]
        self.allow_share = fields["allow_share"]
        self.groups, self._by_kv, self._complex = [], {}, []
        for group in fields["groups"]:
            self.add(group)

    @property
    def collided(self) -> bool:
        return len(self.groups) > 1

    def matches_pod(self, pi: PodInfo) -> bool:
        # a single-(key, value) member can match only a pod that carries
        # that label: look members up by the pod's labels, so a bucket of
        # a thousand per-service groups costs a few lookups a pod, not a
        # thousand selector matches (register_sg recounts every resident
        # pod against the bucket at each join)
        for kv in pi.labels.items():
            for g in self._by_kv.get(kv, ()):
                if g.matches_pod(pi):
                    return True
        return any(g.matches_pod(pi) for g in self._complex)


def _stable_group_hash(group: SelectorGroup) -> int:
    """Deterministic bucket seed (hash() is per-process randomized,
    which would make escape sets differ run to run)."""
    import zlib
    reqs = tuple(sorted(
        (r.key, r.operator, tuple(sorted(r.values or ())))
        for r in group.selector.requirements))
    return zlib.crc32(repr((group.topology_key, reqs,
                            tuple(sorted(group.namespaces)))).encode())


def _exact_kv(group: SelectorGroup) -> tuple[str, str] | None:
    """(key, value) when the group's selector is a single exact match —
    the dominant shape (per-service matchLabels) — else None."""
    reqs = group.selector.requirements
    if (len(reqs) == 1 and reqs[0].operator == IN
            and len(reqs[0].values or ()) == 1):
        return (reqs[0].key, reqs[0].values[0])
    return None


@dataclass
class Caps:
    """Static tensor capacities. All jitted shapes derive from these."""

    # caps marked (packed) are bounded by the bitmask wire format
    # (models/assign.PackSpec): <=31 for one-word masks, kl_cap <= 62.
    n_cap: int = 1024          # node rows
    l_cap: int = 512           # label (key,value) vocab
    kl_cap: int = 62           # label key vocab (packed)
    t_cap: int = 31            # taint vocab (packed)
    pt_cap: int = 31           # host-port vocab (packed)
    s_cap: int = 5             # scalar resource slots
    sg_cap: int = 16           # selector groups (spread/affinity counts)
    asg_cap: int = 16          # anti-affinity groups of existing pods
    g_cap: int = 4             # any-of label groups per pod (node selector)
    kg_cap: int = 2            # any-of key groups per pod (Exists)
    c_cap: int = 6             # constraints per pod
    ns_cap: int = 256          # namespace vocab (namespaceSelector masks)
    v_cap: int = 16            # victim slots per node (batched preemption)

    @property
    def r(self) -> int:
        return CORE_R + self.s_cap


class ClusterTensors:
    """Host mirror of the snapshot as SoA numpy arrays, incrementally updated."""

    def __init__(self, caps: Caps | None = None):
        self.caps = caps or Caps()
        c = self.caps
        self.alloc = np.zeros((c.n_cap, c.r), np.float32)
        self.used = np.zeros((c.n_cap, c.r), np.float32)
        self.used_nz = np.zeros((c.n_cap, c.r), np.float32)
        self.npods = np.zeros(c.n_cap, np.float32)
        self.maxpods = np.zeros(c.n_cap, np.float32)
        self.valid = np.zeros(c.n_cap, bool)
        self.taint_mask = np.zeros((c.n_cap, c.t_cap), np.float32)
        self.label_mask = np.zeros((c.n_cap, c.l_cap), np.float32)
        self.key_mask = np.zeros((c.n_cap, c.kl_cap), np.float32)
        self.port_mask = np.zeros((c.n_cap, c.pt_cap), np.float32)
        # selector-group machinery
        self.dom_sg = np.full((c.sg_cap, c.n_cap), -1, np.int32)
        self.cnt_sg = np.zeros((c.sg_cap, c.n_cap), np.float32)
        self.dom_asg = np.full((c.asg_cap, c.n_cap), -1, np.int32)
        self.cnt_asg = np.zeros((c.asg_cap, c.n_cap), np.float32)

        self.scalar_vocab = Vocab(c.s_cap)
        self.label_vocab = Vocab(c.l_cap)
        self.key_vocab = Vocab(c.kl_cap)
        self.taint_vocab = Vocab(c.t_cap)   # entries: (key, value, effect)
        self.port_vocab = Vocab(c.pt_cap)   # entries: (protocol, port)
        self.domain_vocabs: dict[str, Vocab] = {}  # topo key -> value vocab

        # sg/asg slots are BUCKETS: one group each until the cap fills,
        # then distinct groups hash-share slots (see GroupBucket)
        self.sgs: list[GroupBucket] = []
        self._sg_ids: dict = {}
        self.asgs: list[GroupBucket] = []
        self._asg_ids: dict = {}
        # (key, value) -> [(idx, group)] for single-exact-kv selectors
        # (cross-pod matching in O(pod labels), not O(groups));
        # non-exact selectors go to the short linear-scan lists
        self._sg_kv_index: dict = {}
        self._sg_complex: list = []
        self._asg_kv_index: dict = {}
        self._asg_complex: list = []

        # namespaceSelector resolution: Namespace-object labels cached
        # from the informer feed (note_namespace/set_namespace_labels);
        # terms resolve to concrete namespace sets against it at encode
        # time, memoized until the cache changes (ns_version).  The
        # namespace vocab + per-slot masks are the DEVICE side: column =
        # namespace id, last column = namespaces outside the vocab.
        # All-ones rows (the init state, kept for every plain-namespace
        # group) make the kernel's namespace AND a no-op, so batches
        # without namespaceSelector terms pay nothing.
        self.ns_labels: dict[str, dict] = {}
        self.ns_version = 0
        self._ns_memo: dict = {}           # (base, ns_selector) -> frozenset
        self.ns_vocab = Vocab(c.ns_cap)
        self.sg_ns_mask = np.ones((c.sg_cap, c.ns_cap + 1), np.float32)
        self.asg_ns_mask = np.ones((c.asg_cap, c.ns_cap + 1), np.float32)

        # ns-anti guard: the conservative FALLBACK for namespaceSelector
        # anti-affinity terms whose group could NOT be registered (asg
        # bucket overflow) — any later pod whose labels could match one
        # of the unregistered selectors escapes to the oracle, so a
        # device placement can never violate them.  Armed at escape
        # time, never disarmed; zero cost while unarmed.  (Terms whose
        # group DID register need no guard: their counts/masks cover
        # them on the device path.)
        self.ns_anti_kv: set[tuple[str, str]] = set()
        self.ns_anti_complex = False

        self.row_of: dict[str, int] = {}
        self.node_infos: list[NodeInfo | None] = [None] * c.n_cap
        # registration-time name per row.  Dispatch snapshots THIS list to
        # resolve assignments, never NodeInfo.name: the zero-copy cache
        # view (CacheFlattenView) shares LIVE NodeInfos, and the cache
        # nulls .node in place when a drained node still holds pods — a
        # wave resolving across that mutation would read name "" and bind
        # pods to an empty nodeName (silently lost; nothing requeues them)
        self.row_names: list[str | None] = [None] * c.n_cap
        self.gen = np.zeros(c.n_cap, np.int64)
        self.node_gen = np.full(c.n_cap, -1, np.int64)  # last static encode
        self._free = list(range(c.n_cap - 1, -1, -1))
        # released rows park here instead of going straight back to _free:
        # a row freed mid-wave must not be re-assigned to a new node while
        # an in-flight wave still references it by index.  compact()
        # (called by the backend between waves, or forcibly by _sync_rows
        # when _free empties) scrubs the group columns and recycles them.
        self._tombstones: set[int] = set()
        # patch_gen counts patch/compaction API applications; every
        # mutation through patch_node/patch_remove/compact bumps it (the
        # tensor-patch-discipline lint keys off this counter)
        self.patch_gen = 0
        # per-row dynamic-aggregate digest for the bulk re-encode skip:
        # bind-shaped churn (assume→confirm cycles) advances NodeInfo
        # generations without changing the encoded aggregates; a matching
        # digest means the row's dynamic columns are already current
        self._dyn_digest: list = [None] * c.n_cap
        # rows that have EVER held data: a pristine row's arrays are still
        # their init zeros, so the fresh-flood encode can skip the ~360
        # floats/row of zero-fills (at 100k nodes those writes alone cost
        # ~0.3s inside the first scheduling window)
        self._ever_used = np.zeros(c.n_cap, bool)
        # static_version tracks arrays that rarely change (labels, taints,
        # alloc, domains); the device cache keys off it so binding a pod —
        # which dirties used/npods only — doesn't trigger a multi-MB
        # re-upload of the label/key masks every batch.
        self.version = 0         # any host-array mutation
        self.static_version = 0  # label/key/taint/alloc/dom/valid mutations
        # row-incremental static upload support: rows whose static fields
        # changed since the backend's last upload; static_full forces a
        # whole-array re-upload (column backfills touch every row)
        self.static_dirty_rows: set[int] = set()
        self.static_full = True

        # victim tensors (batched preemption / DryRunPreemption): per-node
        # resident pods sorted ascending by priority.  PAD slots carry
        # VICT_PAD so `vict_prio < preemptor_prio` masks them out for any
        # real priority.  Maintained LAZILY: hot paths (binds) only mark
        # rows dirty here; refresh_victims() re-encodes at preempt time so
        # the per-bind cost is one set.add.  vict_version is a SEPARATE
        # upload channel from static_version — victim rebuilds must not
        # invalidate the static cache (that would force a multi-MB label
        # re-upload per preemption wave).
        self.vict_prio = np.full((c.n_cap, c.v_cap), VICT_PAD, np.int32)
        self.vict_req = np.zeros((c.n_cap, c.v_cap, c.r), np.float32)
        self.vict_pdb = np.zeros((c.n_cap, c.v_cap), np.float32)
        self.vict_over = np.zeros(c.n_cap, bool)
        # host-side victim identities per row (slot-aligned with
        # vict_prio); None for rows never victim-encoded
        self.vict_keys: list[list | None] = [None] * c.n_cap
        self.vict_version = 0
        self.vict_dirty_rows: set[int] = set()
        self.vict_full = True
        # PDB cache from the informer: (namespace, name) -> (namespace,
        # Selector, disruptionsAllowed).  The device bit marks victims
        # covered by a BLOCKING pdb (allowed <= 0); pdb_version feeds the
        # victim-refresh staleness check.
        self.pdbs: dict[tuple, tuple] = {}
        self.pdb_version = 0
        self._vict_pdb_version = -1

    # -- vocab helpers ---------------------------------------------------

    def ensure_label_id(self, pair: tuple[str, str]) -> int:
        """Get-or-create a (key,value) label id, backfilling the node column
        for all live rows on creation."""
        lid = self.label_vocab.lookup(pair)
        if lid is not None:
            return lid
        lid = self.label_vocab.get(pair)
        k, v = pair
        for row, ni in enumerate(self.node_infos):
            if ni is not None and self.valid[row] and ni.node is not None:
                if meta.labels(ni.node).get(k) == v:
                    self.label_mask[row, lid] = 1.0
        self.version += 1
        self.static_version += 1
        self.static_full = True  # column fill: every row changed
        return lid

    def ensure_key_id(self, key: str) -> int:
        kid = self.key_vocab.lookup(key)
        if kid is not None:
            return kid
        kid = self.key_vocab.get(key)
        for row, ni in enumerate(self.node_infos):
            if ni is not None and self.valid[row] and ni.node is not None:
                if key in meta.labels(ni.node):
                    self.key_mask[row, kid] = 1.0
        self.version += 1
        self.static_version += 1
        self.static_full = True  # column fill: every row changed
        return kid

    # -- namespace resolution (namespaceSelector terms) ------------------

    def resolve_namespaces(self, base: frozenset,
                           ns_selector: Selector) -> frozenset:
        """base ∪ {namespaces whose labels match ns_selector}, mirroring
        the oracle's AffinityTerm.matches exactly: a namespace must have
        a cached OBJECT to match (an empty match-all selector matches
        only known namespaces), and empty labels {} DO match a match-all
        selector.  Memoized until the namespace cache changes."""
        memo_key = (base, ns_selector)
        got = self._ns_memo.get(memo_key)
        if got is None:
            got = frozenset(base) | {
                ns for ns, lbl in self.ns_labels.items()
                if ns_selector.matches(lbl)}
            self._ns_memo[memo_key] = got
        return got

    def term_group_key(self, term):
        """The sg/asg id-map key for an affinity term: plain terms keep
        the raw (topology_key, selector, namespaces) triple; terms with
        a namespaceSelector key on the RESOLVED namespace set."""
        if term.ns_selector is None:
            return (term.topology_key, term.selector, term.namespaces)
        return (term.topology_key, term.selector,
                self.resolve_namespaces(term.namespaces, term.ns_selector))

    def group_for_term(self, term) -> SelectorGroup:
        """SelectorGroup for an affinity term, with any namespaceSelector
        resolved against the namespace-label cache."""
        if term.ns_selector is None:
            return SelectorGroup(term.topology_key, term.selector,
                                 term.namespaces)
        return SelectorGroup(
            term.topology_key, term.selector,
            self.resolve_namespaces(term.namespaces, term.ns_selector),
            ns_selector=term.ns_selector, base_namespaces=term.namespaces)

    def intern_namespaces(self, namespaces) -> bool:
        """Intern namespaces into the device vocab; False when the vocab
        cannot hold them all (the registering pod then escapes with
        reason namespace_vocab_overflow — the group itself still
        registers with exact host-side counts and an all-ones mask)."""
        ok = True
        for ns in namespaces:
            try:
                self.ns_vocab.get(ns)
            except VocabFullError:
                ok = False
        return ok

    def set_namespace_labels(self, name: str, labels: dict | None) -> None:
        """Update the namespace-label cache (labels=None: namespace
        deleted) and re-resolve every registered namespaceSelector group
        against it.  Deterministic invalidation: the NEXT batch encodes
        against the new resolution — no TTL, no staleness window beyond
        informer delivery."""
        if labels is None:
            if name not in self.ns_labels:
                return
            del self.ns_labels[name]
        else:
            labels = dict(labels)
            if self.ns_labels.get(name) == labels:
                return
            self.ns_labels[name] = labels
        self.ns_version += 1
        self._ns_memo.clear()
        self._refresh_ns_groups()

    def note_namespace(self, obj: Obj, deleted: bool = False) -> None:
        """Feed one Namespace informer event into the cache."""
        self.set_namespace_labels(
            meta.name(obj), None if deleted else meta.labels(obj))

    # -- PDB cache (batched preemption victim bits) -----------------------

    def note_pdb(self, obj: Obj, deleted: bool = False) -> None:
        """Feed one PodDisruptionBudget informer event into the cache.
        Mirrors the Evaluator's _list_pdbs shape: (selector, allowed)
        pairs, allowed defaulting to 0 when status is absent."""
        key = (meta.namespace(obj), meta.name(obj))
        if deleted:
            if self.pdbs.pop(key, None) is None:
                return
        else:
            spec = obj.get("spec") or {}
            status = obj.get("status") or {}
            entry = (key[0], selector_from_dict(spec.get("selector") or {}),
                     int(status.get("disruptionsAllowed", 0)))
            if self.pdbs.get(key) == entry:
                return
            self.pdbs[key] = entry
        self.pdb_version += 1

    def pdb_blocking(self) -> list[tuple]:
        """(namespace, selector) pairs of BLOCKING pdbs (allowed <= 0) —
        the only ones whose coverage counts as a violation in the
        Evaluator's _violates_pdb."""
        return [(ns, sel) for ns, sel, allowed in self.pdbs.values()
                if allowed <= 0]

    def _refresh_ns_groups(self) -> None:
        """Re-resolve registered namespaceSelector groups after a
        namespace-label change: group membership sets, id-map keys,
        per-node counts and the device namespace masks all follow the
        new resolution in one pass."""
        changed = False
        for is_sg in (True, False):
            buckets = self.sgs if is_sg else self.asgs
            ids = self._sg_ids if is_sg else self._asg_ids
            for idx, bucket in enumerate(buckets):
                touched = False
                for g in bucket.groups:
                    if g.ns_selector is None:
                        continue
                    new = self.resolve_namespaces(g.base_namespaces,
                                                  g.ns_selector)
                    if new == g.namespaces:
                        continue
                    old_key = g.key()
                    if ids.get(old_key) == idx:
                        del ids[old_key]
                    g.namespaces = new
                    ids[g.key()] = idx
                    touched = True
                if not touched:
                    continue
                changed = True
                for row, ni in enumerate(self.node_infos):
                    if ni is None or not self.valid[row]:
                        continue
                    if is_sg:
                        self._encode_sg_row(idx, row, ni)
                    else:
                        self._encode_asg_row(idx, row, ni)
                self.intern_namespaces(
                    ns for g in bucket.groups for ns in g.namespaces)
                self._ns_mask_row_update(idx, bucket, is_sg)
        if changed:
            self.version += 1
            self.static_version += 1
            self.static_full = True

    def _ns_mask_row_update(self, idx: int, bucket: GroupBucket,
                            is_sg: bool) -> bool:
        """Device namespace mask for one sg/asg slot (column = namespace
        vocab id; last column = outside-vocab namespaces).  The host
        fold is authoritative — it sets inc/match bits from the same
        resolved sets — so the mask is enforcement, not semantics: a
        stale or fallback row can only over-block, never admit a
        placement the resolution forbids.  Plain members and
        outside-vocab namespaces therefore fall back to all-ones (the
        kernel AND becomes a no-op)."""
        mask = self.sg_ns_mask if is_sg else self.asg_ns_mask
        row = np.zeros(self.caps.ns_cap + 1, np.float32)
        exact = True
        for g in bucket.groups:
            if g.ns_selector is None:
                exact = False   # plain member: its namespaces aren't interned
                break
            for ns in g.namespaces:
                nid = self.ns_vocab.lookup(ns)
                if nid is None:
                    exact = False
                    break
                row[nid] = 1.0
            if not exact:
                break
        if not exact:
            row[:] = 1.0
        # report row-value changes: mask mutations are NOT row-patchable
        # (no node axis), so callers must force a full static re-upload
        changed = not np.array_equal(mask[idx], row)
        mask[idx] = row
        return changed

    def domain_id(self, topo_key: str, value: str) -> int:
        vocab = self.domain_vocabs.get(topo_key)
        if vocab is None:
            vocab = self.domain_vocabs[topo_key] = Vocab(self.caps.n_cap)
        return vocab.get(value)

    def _dom_row_for_key(self, key: str,
                         exclude: GroupBucket | None = None) -> np.ndarray:
        """[n_cap] domain-id row for a topology key.

        The row depends only on (key, node labels) — never on the group —
        so any existing bucket with the same key already holds it; copy
        instead of touching every node again (a high-cardinality flood
        registers thousands of same-key groups in one encode pass).
        `exclude` is the bucket being registered (its row is not yet
        encoded)."""
        for arr, buckets in ((self.dom_sg, self.sgs),
                             (self.dom_asg, self.asgs)):
            for j, b in enumerate(buckets):
                if b.topology_key == key and b is not exclude:
                    return arr[j].copy()
        row = np.full(self.caps.n_cap, -1, np.int32)
        for r, ni in enumerate(self.node_infos):
            if ni is None or not self.valid[r] or ni.node is None:
                continue
            val = meta.labels(ni.node).get(key)
            if val is not None:
                row[r] = self.domain_id(key, val)
        return row

    @staticmethod
    def _probe_bucket(buckets: list[GroupBucket],
                      group: SelectorGroup) -> int | None:
        """Slot for a group once the cap is full: hash start + linear
        probe to a SHAREABLE bucket with the SAME topology key (dom
        rows are per-topology-key, so cross-key sharing would corrupt
        domain ids; exclusive slots serve count-as-enabler constraints
        and must never be joined).  None when no compatible bucket
        exists."""
        cap = len(buckets)
        start = _stable_group_hash(group) % cap
        for probe in range(cap):
            b = buckets[(start + probe) % cap]
            if b.allow_share and b.topology_key == group.topology_key:
                return (start + probe) % cap
        return None

    def _index_group(self, kv_index: dict, complex_list: list,
                     idx: int, group: SelectorGroup) -> None:
        kv = _exact_kv(group)
        if kv is not None:
            kv_index.setdefault(kv, []).append((idx, group))
        else:
            complex_list.append((idx, group))

    def register_sg(self, group: SelectorGroup,
                    shareable: bool = False) -> int | None:
        """Returns sg index, backfilling counts for all live rows.

        shareable=True (count-as-BLOCKER constraints: required
        anti-affinity, preferred/score terms): beyond the cap the group
        hash-shares a bucket (GroupBucket upper-bound semantics).
        shareable=False (count-as-ENABLER: required affinity,
        DoNotSchedule spread): the group needs an exclusive slot —
        None when the registry is full OR the group already lives in a
        shared bucket (escape hatch, exactly the pre-bucketing
        behavior)."""
        idx = self._sg_ids.get(group.key())
        if idx is not None:
            if not shareable:
                if self.sgs[idx].collided:
                    return None  # exact counts required; slot is shared
                # pin the slot: an enabler-constraint user means no
                # later overflow group may join it
                self.sgs[idx].allow_share = False
            return idx
        if len(self.sgs) < self.caps.sg_cap:
            idx = len(self.sgs)
            self.sgs.append(GroupBucket(group, allow_share=shareable))
            is_new_bucket = True
        else:
            if not shareable:
                return None
            idx = self._probe_bucket(self.sgs, group)
            if idx is None:
                return None
            self.sgs[idx].add(group)
            is_new_bucket = False
        self._sg_ids[group.key()] = idx
        self._index_group(self._sg_kv_index, self._sg_complex, idx, group)
        mask_changed = False
        if group.ns_selector is not None or self.sgs[idx].collided:
            # a namespaceSelector member (or a join that may widen a
            # selective row) re-derives the slot's namespace mask
            mask_changed = self._ns_mask_row_update(idx, self.sgs[idx], True)
        # Registration cost discipline (a 2000-service flood registers
        # its whole vocabulary inside ONE batch encode): a new bucket
        # copies/derives its dom row in one vectorized step; a JOIN can
        # only change counts on nodes that hold pods matching the new
        # member, so empty nodes are skipped and nothing is bumped when
        # nothing changed (the bump would force a static re-upload and a
        # pipeline flush PER REGISTRATION — measured 26s of a 26s
        # high-cardinality run before this).
        bucket = self.sgs[idx]
        if is_new_bucket:
            self.dom_sg[idx] = self._dom_row_for_key(bucket.topology_key,
                                                     exclude=bucket)
        changed = is_new_bucket or mask_changed
        for row, ni in enumerate(self.node_infos):
            if ni is None or not ni.pods or not self.valid[row]:
                continue
            new = sum(1 for pi in ni.pods
                      if not meta.deletion_timestamp(pi.pod)
                      and bucket.matches_pod(pi))
            if new != self.cnt_sg[idx, row]:
                self.cnt_sg[idx, row] = new
                changed = True
        if changed:
            self.version += 1
            self.static_version += 1  # dom_sg/cnt_sg rows changed
            self.static_full = True
        return idx

    def register_asg(self, group: SelectorGroup) -> int | None:
        idx = self._asg_ids.get(group.key())
        if idx is not None:
            return idx
        if len(self.asgs) < self.caps.asg_cap:
            idx = len(self.asgs)
            # asg counts only ever BLOCK (existing-pod anti-affinity),
            # so every asg slot is shareable
            self.asgs.append(GroupBucket(group, allow_share=True))
            is_new_bucket = True
        else:
            idx = self._probe_bucket(self.asgs, group)
            if idx is None:
                return None
            self.asgs[idx].add(group)
            is_new_bucket = False
        self._asg_ids[group.key()] = idx
        self._index_group(self._asg_kv_index, self._asg_complex, idx,
                          group)
        mask_changed = False
        if group.ns_selector is not None or self.asgs[idx].collided:
            mask_changed = self._ns_mask_row_update(idx, self.asgs[idx],
                                                    False)
        # same registration cost discipline as register_sg: vectorized
        # dom row for new buckets, count deltas only on nodes that hold
        # anti-affinity pods, version bumps only when something changed
        if is_new_bucket:
            self.dom_asg[idx] = self._dom_row_for_key(
                group.topology_key, exclude=self.asgs[idx])
        ids = self._asg_ids
        term_key = self.term_group_key
        changed = is_new_bucket or mask_changed
        for row, ni in enumerate(self.node_infos):
            if (ni is None or not self.valid[row]
                    or not ni.pods_with_required_anti_affinity):
                continue
            n = 0
            for pi in ni.pods_with_required_anti_affinity:
                for term in pi.required_anti_affinity_terms:
                    if ids.get(term_key(term)) == idx:
                        n += 1
            if n != self.cnt_asg[idx, row]:
                self.cnt_asg[idx, row] = n
                changed = True
        if changed:
            self.version += 1
            self.static_version += 1  # dom_asg/cnt_asg rows changed
            self.static_full = True
        return idx

    # -- node encoding ---------------------------------------------------

    def update_from_snapshot(self, snapshot: Snapshot) -> bool:
        """Incremental refresh; returns True if anything changed."""
        return bool(self.update_from_snapshot_tracked(snapshot))

    def update_from_snapshot_tracked(self, snapshot) -> list[int]:
        """Incremental refresh; returns the rows re-encoded this call.

        Accepts either an immutable scheduler Snapshot or a zero-copy
        cache view (scheduler/cache.py CacheFlattenView): views run the
        whole re-encode under the cache lock so rows are never encoded
        from a NodeInfo mid-mutation, and skip the per-dirty-node clone
        the Snapshot path pays.  Views that can feed the changed-node
        delta (run_locked_dirty) skip the O(nodes) membership scan too."""
        if not os.environ.get("KTPU_FORCE_REFLATTEN"):
            # A/B baseline knob: when set, skip the changed-node delta so
            # every sync pays the O(nodes) full scan (the pre-incremental
            # world bench measures the maintenance win against)
            run_dirty = getattr(snapshot, "run_locked_dirty", None)
            if run_dirty is not None:
                return run_dirty(self._update_from_dirty)
        run_locked = getattr(snapshot, "run_locked", None)
        if run_locked is not None:
            return run_locked(self._update_from_nodes_tracked)
        return self._update_from_nodes_tracked(snapshot.node_info_list)

    def _sync_rows(self, named_infos) -> list[int]:
        """Re-encode every (name, NodeInfo) whose generation advanced;
        returns the touched rows.  Bind-only dirt (node_generation
        unchanged, no ports/scalars/selector groups) takes a BULK columnar
        re-encode: at bench shapes every batch dirties one row per bound
        pod, and the per-row _encode_node costs ~30µs x 16k rows."""
        dirty: list[int] = []
        bulk: list = []  # (row, ni) pairs eligible for the columnar path
        fresh_bulk: list = []  # brand-new podless rows (creation floods)
        bulk_ok = not self.sgs and not self.asgs
        row_of, gen, valid = self.row_of, self.gen, self.valid
        digests = self._dyn_digest
        for name, ni in named_infos:
            row = row_of.get(name)
            if row is None:
                if not self._free and self._tombstones:
                    self.compact()
                if not self._free:
                    raise VocabFullError(
                        f"node capacity {self.caps.n_cap} exceeded")
                row = self._free.pop()
                row_of[name] = row
                self.row_names[row] = name
                gen[row] = -1
            if gen[row] != ni.generation:
                if (bulk_ok and valid[row]
                        and self.node_gen[row] == ni.node_generation
                        and not ni.used_ports
                        and not ni.requested.scalar):
                    req, nz = ni.requested, ni.non_zero_requested
                    dg = (req.milli_cpu, req.memory, req.ephemeral_storage,
                          nz.milli_cpu, nz.memory, nz.ephemeral_storage,
                          len(ni.pods))
                    if digests[row] == dg:
                        # identical aggregates (snapshot paths clone
                        # NodeInfos per update): record the generation and
                        # NodeInfo identity, skip the rewrite + upload
                        self.node_infos[row] = ni
                        gen[row] = ni.generation
                        self.vict_dirty_rows.add(row)
                        continue
                    digests[row] = dg
                    bulk.append((row, ni))
                elif (bulk_ok and not valid[row] and ni.node is not None
                        and not ni.pods and not ni.used_ports
                        and not ni.allocatable.scalar):
                    fresh_bulk.append((row, ni))
                else:
                    self._encode_node(row, ni)
                gen[row] = ni.generation
                dirty.append(row)
        if bulk:
            self._encode_dynamic_bulk(bulk)
        if fresh_bulk:
            self._encode_fresh_bulk(fresh_bulk)
        if dirty:
            # resident-pod set may have changed on these rows; victim
            # tensors re-encode lazily at preempt time
            self.vict_dirty_rows.update(dirty)
        return dirty

    def _encode_fresh_bulk(self, pairs: list) -> None:
        """Columnar encode for brand-new podless rows — the node-creation
        flood shape (100k registrations before any pod exists).  The
        per-row _encode_node costs ~30µs; this path is ~4µs/row: dynamic
        fields are zero-filled column-wise, alloc/maxpods come from list
        comprehensions, and only taints/labels stay per-row (short dict
        loops, vocab lookups only)."""
        rows = np.fromiter((r for r, _ in pairs), np.int64, len(pairs))
        infos = [ni for _, ni in pairs]
        node_infos = self.node_infos
        for row, ni in pairs:
            node_infos[row] = ni
        # zero-fill only rows that have ever held data; pristine rows are
        # still their init zeros (the 100k-registration flood writes none)
        stale = rows[self._ever_used[rows]]
        if len(stale):
            for arr in (self.used, self.used_nz, self.port_mask, self.alloc,
                        self.taint_mask, self.label_mask, self.key_mask):
                arr[stale] = 0.0
            self.npods[stale] = 0.0
        self._ever_used[rows] = True
        self.alloc[rows, 0] = [ni.allocatable.milli_cpu for ni in infos]
        self.alloc[rows, 1] = [ni.allocatable.memory for ni in infos]
        self.alloc[rows, 2] = [ni.allocatable.ephemeral_storage
                               for ni in infos]
        self.maxpods[rows] = [ni.allocatable.allowed_pod_number
                              for ni in infos]
        self.node_gen[rows] = [ni.node_generation for ni in infos]
        self.valid[rows] = True
        tm, lm, km = self.taint_mask, self.label_mask, self.key_mask
        lv, kv = self.label_vocab.lookup, self.key_vocab.lookup
        tv = self.taint_vocab.get
        for row, ni in pairs:
            node = ni.node
            spec = node.get("spec") or {}
            taints = spec.get("taints")
            if taints or spec.get("unschedulable"):
                taints = list(taints or ())
                if spec.get("unschedulable"):
                    taints.append({"key": UNSCHEDULABLE_TAINT[0],
                                   "value": UNSCHEDULABLE_TAINT[1],
                                   "effect": UNSCHEDULABLE_TAINT[2]})
                for t in taints:
                    tm[row, tv((t.get("key", ""), t.get("value", ""),
                                t.get("effect", "")))] = 1.0
            for k, v in meta.labels(node).items():
                lid = lv((k, v))
                if lid is not None:
                    lm[row, lid] = 1.0
                kid = kv(k)
                if kid is not None:
                    km[row, kid] = 1.0
        self.static_version += 1
        self.static_dirty_rows.update(rows.tolist())

    def _release_row(self, name: str) -> int | None:
        row = self.row_of.pop(name, None)
        if row is None:
            return None
        self.valid[row] = False
        self.node_infos[row] = None
        self.row_names[row] = None
        self.node_gen[row] = -1
        self._dyn_digest[row] = None
        self._tombstones.add(row)
        self.static_version += 1
        self.static_dirty_rows.add(row)
        self.vict_dirty_rows.add(row)
        return row

    def compact(self) -> int:
        """Reclaim tombstoned row slots: scrub the selector-group columns
        a dead row may still carry (valid=False masks it on device, but a
        recycled slot must start clean) and return the slots to the free
        list.  Called by the backend between waves (never while a wave is
        in flight — an in-flight wave references rows by index) and
        forcibly by _sync_rows when the free list empties.  Selector-group
        SLOTS are buckets and stay permanent; only node rows recycle."""
        if not self._tombstones:
            return 0
        rows = sorted(self._tombstones, reverse=True)
        arr = np.asarray(rows, np.int64)
        self.cnt_sg[:, arr] = 0.0
        self.dom_sg[:, arr] = -1
        self.cnt_asg[:, arr] = 0.0
        self.dom_asg[:, arr] = -1
        self._tombstones.clear()
        self._free.extend(rows)
        self.static_dirty_rows.update(rows)
        self.version += 1
        self.static_version += 1
        self.patch_gen += 1
        return len(rows)

    def tombstone_count(self) -> int:
        return len(self._tombstones)

    def row_occupancy(self) -> float:
        """Fraction of node-row capacity holding a live node."""
        return len(self.row_of) / self.caps.n_cap

    # -- event-driven patch API (incremental flatten) --------------------
    # Informer deltas land here between waves so the resident tensors stay
    # current without a per-wave snapshot re-encode; the wave-time drain
    # (update_from_snapshot_tracked) remains the authoritative backstop —
    # a row patched here is generation-current and skips re-encode there.

    def patch_node(self, name: str, ni: NodeInfo) -> int | None:
        """Apply one node add/update event as a targeted row patch.
        Returns the touched row (for the backend's dirty-row upload), or
        None when the row is already generation-current.  Raises
        VocabFullError only if compaction cannot free a slot."""
        row = self.row_of.get(name)
        if row is None:
            if not self._free and self._tombstones:
                self.compact()
            if not self._free:
                raise VocabFullError(
                    f"node capacity {self.caps.n_cap} exceeded")
            row = self._free.pop()
            self.row_of[name] = row
            self.row_names[row] = name
            self.gen[row] = -1
        elif self.gen[row] == ni.generation:
            return None
        self._encode_node(row, ni)
        self.gen[row] = ni.generation
        self.vict_dirty_rows.add(row)
        self.version += 1
        self.patch_gen += 1
        return row

    def patch_remove(self, name: str) -> int | None:
        """Apply one node delete event: tombstone the row (reclaimed by a
        later compact()).  Returns the released row or None."""
        row = self._release_row(name)
        if row is not None:
            self.version += 1
            self.patch_gen += 1
        return row

    def _update_from_dirty(self, pairs, removed_names) -> list[int]:
        """Incremental sync from a changed-node delta (CacheFlattenView.
        run_locked_dirty): O(changed) instead of O(nodes)."""
        dirty = self._sync_rows(pairs)
        for name in removed_names:
            row = self._release_row(name)
            if row is not None:
                dirty.append(row)
        if dirty:
            self.version += 1
        return dirty

    def _update_from_nodes_tracked(self, node_info_list) -> list[int]:
        dirty = self._sync_rows((ni.name, ni) for ni in node_info_list)
        live = {ni.name for ni in node_info_list}
        for name in list(self.row_of):
            if name not in live:
                row = self._release_row(name)
                if row is not None:
                    dirty.append(row)
        if dirty:
            self.version += 1
        return dirty

    def _encode_dynamic_bulk(self, pairs: list) -> None:
        """Columnar dynamic re-encode for rows whose static side is
        untouched and whose aggregates carry no scalars/ports — five
        column fills instead of ~10 numpy ops per row."""
        rows = np.fromiter((r for r, _ in pairs), np.int64, len(pairs))
        infos = [ni for _, ni in pairs]
        node_infos = self.node_infos
        for (row, ni) in pairs:  # snapshot paths clone NodeInfos per update
            node_infos[row] = ni
        self._ever_used[rows] = True
        self.used[rows, 0] = [ni.requested.milli_cpu for ni in infos]
        self.used[rows, 1] = [ni.requested.memory for ni in infos]
        self.used[rows, 2] = [ni.requested.ephemeral_storage for ni in infos]
        self.used[rows[:, None], np.arange(CORE_R, self.caps.r)[None, :]] = 0.0
        nz = [ni.non_zero_requested for ni in infos]
        self.used_nz[rows, 0] = [r.milli_cpu for r in nz]
        self.used_nz[rows, 1] = [r.memory for r in nz]
        self.used_nz[rows, 2] = [r.ephemeral_storage for r in nz]
        self.used_nz[rows[:, None],
                     np.arange(CORE_R, self.caps.r)[None, :]] = 0.0
        self.npods[rows] = [len(ni.pods) for ni in infos]
        self.port_mask[rows] = 0.0

    def _encode_resource(self, out: np.ndarray, res) -> None:
        out[0] = res.milli_cpu
        out[1] = res.memory
        out[2] = res.ephemeral_storage
        out[CORE_R:] = 0.0
        for name, v in res.scalar.items():
            try:
                out[CORE_R + self.scalar_vocab.get(name)] = v
            except VocabFullError:
                raise

    def _encode_node(self, row: int, ni: NodeInfo) -> None:
        c = self.caps
        node = ni.node
        self.node_infos[row] = ni
        self._ever_used[row] = True
        self._dyn_digest[row] = None  # full encode: bulk digest is stale

        # ---- dynamic fields (change on every bind; cheap to upload) ----
        self._encode_resource(self.used[row], ni.requested)
        self._encode_resource(self.used_nz[row], ni.non_zero_requested)
        self.npods[row] = len(ni.pods)
        self.port_mask[row] = 0.0
        for proto, _ip, port in ni.used_ports:
            self.port_mask[row, self.port_vocab.get((proto, port))] = 1.0
        for sg_idx in range(len(self.sgs)):
            self._encode_sg_row(sg_idx, row, ni)
        for asg_idx in range(len(self.asgs)):
            self._encode_asg_row(asg_idx, row, ni)

        # restart window: a RESIDENT pod can carry a namespaceSelector
        # anti term whose group was never registered in this process —
        # registration happens on the ENCODE path of incoming pods, and
        # after a scheduler restart a bound pod never re-encodes.  Arm
        # the conservative guard for any such term during the first
        # snapshot sync so an incoming pod that could match it defers to
        # the oracle instead of silently violating the unencoded
        # constraint.  (Groups that DO register later keep exact device
        # counts; the guard stays armed — conservative, never wrong.)
        ids, term_key = self._asg_ids, self.term_group_key
        for pi in ni.pods_with_required_anti_affinity:
            for term in pi.required_anti_affinity_terms:
                if term.ns_selector is not None \
                        and term_key(term) not in ids:
                    self.arm_ns_anti_guard(term)

        # ---- static fields (labels/taints/alloc) ----
        # Binds dirty only dynamic fields; NodeInfo.node_generation advances
        # only when the node OBJECT changed, so rows dirtied by pod traffic
        # skip the static rebuild entirely (the dominant case: every batch
        # dirties one row per bound pod).
        if self.valid[row] and self.node_gen[row] == ni.node_generation:
            return
        # compare before write so routine no-op refreshes never bump
        # static_version (a bump forces a multi-MB device re-upload);
        # node_gen is recorded only after every fallible encode below
        # succeeds, so a VocabFullError mid-encode retries next dispatch
        fresh = not self.valid[row]
        if fresh:
            # creation flood fast path (100k nodes register before any pod
            # exists): encode straight into the target rows (zero-filled
            # first — a recycled row holds stale values) instead of
            # building temporaries and diffing them against a row that is
            # invalid anyway
            alloc_new = self.alloc[row]
            alloc_new[:] = 0.0
            taint_new = self.taint_mask[row]
            taint_new[:] = 0.0
            label_new = self.label_mask[row]
            label_new[:] = 0.0
            key_new = self.key_mask[row]
            key_new[:] = 0.0
        else:
            alloc_new = np.zeros(c.r, np.float32)
            taint_new = np.zeros(c.t_cap, np.float32)
            label_new = np.zeros(c.l_cap, np.float32)
            key_new = np.zeros(c.kl_cap, np.float32)
        self._encode_resource(alloc_new, ni.allocatable)
        taints = list((node.get("spec") or {}).get("taints") or ())
        if (node.get("spec") or {}).get("unschedulable"):
            taints.append({"key": UNSCHEDULABLE_TAINT[0],
                           "value": UNSCHEDULABLE_TAINT[1],
                           "effect": UNSCHEDULABLE_TAINT[2]})
        for t in taints:
            tid = self.taint_vocab.get(
                (t.get("key", ""), t.get("value", ""), t.get("effect", "")))
            taint_new[tid] = 1.0
        # labels — vocab ids are created by POD-side references only (a
        # per-node-unique label like kubernetes.io/hostname would otherwise
        # grow the vocab O(N)); node rows just set bits for known ids, and
        # ensure_label_id/ensure_key_id backfill columns when a pod first
        # references a label.
        labels = meta.labels(node)
        for k, v in labels.items():
            lid = self.label_vocab.lookup((k, v))
            if lid is not None:
                label_new[lid] = 1.0
            kid = self.key_vocab.lookup(k)
            if kid is not None:
                key_new[kid] = 1.0

        if fresh:
            self.valid[row] = True
            self.maxpods[row] = ni.allocatable.allowed_pod_number
            self.static_version += 1
            self.static_dirty_rows.add(row)
            self.node_gen[row] = ni.node_generation
            return
        static_changed = (
            self.maxpods[row] != ni.allocatable.allowed_pod_number
            or not np.array_equal(self.alloc[row], alloc_new)
            or not np.array_equal(self.taint_mask[row], taint_new)
            or not np.array_equal(self.label_mask[row], label_new)
            or not np.array_equal(self.key_mask[row], key_new))
        if static_changed:
            self.alloc[row] = alloc_new
            self.maxpods[row] = ni.allocatable.allowed_pod_number
            self.taint_mask[row] = taint_new
            self.label_mask[row] = label_new
            self.key_mask[row] = key_new
            self.static_version += 1
            self.static_dirty_rows.add(row)
        elif self.sgs or self.asgs:
            # a node-object change can move the row's topology domain
            # (dom_sg/dom_asg) without touching any compared array; mark
            # the row so an incremental static upload carries the doms
            self.static_dirty_rows.add(row)
        self.node_gen[row] = ni.node_generation

    def _encode_sg_row(self, sg_idx: int, row: int, ni: NodeInfo) -> None:
        bucket = self.sgs[sg_idx]
        labels = meta.labels(ni.node) if ni.node else {}
        val = labels.get(bucket.topology_key)
        self.dom_sg[sg_idx, row] = (self.domain_id(bucket.topology_key, val)
                                    if val is not None else -1)
        # each pod counts ONCE if it matches ANY member (the same
        # per-pod semantics as encode()'s inc_sg and the mirror replay —
        # per-(pod,group) counting would diverge between full refresh
        # and replay on shared buckets)
        self.cnt_sg[sg_idx, row] = sum(
            1 for pi in ni.pods
            if not meta.deletion_timestamp(pi.pod)
            and bucket.matches_pod(pi))

    def _encode_asg_row(self, asg_idx: int, row: int, ni: NodeInfo) -> None:
        bucket = self.asgs[asg_idx]
        labels = meta.labels(ni.node) if ni.node else {}
        val = labels.get(bucket.topology_key)
        self.dom_asg[asg_idx, row] = (self.domain_id(bucket.topology_key,
                                                     val)
                                      if val is not None else -1)
        # pods on this node carrying an anti-affinity term == any member
        # (namespaceSelector terms compare by their RESOLVED group key)
        ids = self._asg_ids
        term_key = self.term_group_key
        n = 0
        for pi in ni.pods_with_required_anti_affinity:
            for term in pi.required_anti_affinity_terms:
                if ids.get(term_key(term)) == asg_idx:
                    n += 1
        self.cnt_asg[asg_idx, row] = n

    def arm_ns_anti_guard(self, term) -> None:
        """Record one namespaceSelector ANTI term in the conservative
        guard (ns_anti_kv/ns_anti_complex, see __init__): later pods
        whose labels could match the selector escape to the oracle, so
        a device placement can never violate the unencoded term."""
        kv = _exact_kv(SelectorGroup("", term.selector, frozenset()))
        if kv is not None:
            self.ns_anti_kv.add(kv)
        else:
            self.ns_anti_complex = True

    # -- per-batch domain base counts ------------------------------------

    def domain_base_counts(self) -> tuple[np.ndarray, np.ndarray]:
        """cd0_sg[SG, n_cap], cd0_asg[ASG, n_cap]: per-domain counts
        (domain ids index into the n_cap-sized axis; counts of matching pods
        aggregated from per-node counts via bincount)."""
        c = self.caps
        cd_sg = np.zeros((c.sg_cap, c.n_cap), np.float32)
        for i in range(len(self.sgs)):
            m = self.valid & (self.dom_sg[i] >= 0)
            if m.any():
                bc = np.bincount(self.dom_sg[i][m], weights=self.cnt_sg[i][m],
                                 minlength=c.n_cap)
                cd_sg[i] = bc[:c.n_cap]
        cd_asg = np.zeros((c.asg_cap, c.n_cap), np.float32)
        for i in range(len(self.asgs)):
            m = self.valid & (self.dom_asg[i] >= 0)
            if m.any():
                bc = np.bincount(self.dom_asg[i][m], weights=self.cnt_asg[i][m],
                                 minlength=c.n_cap)
            else:
                bc = np.zeros(c.n_cap, np.float32)
            cd_asg[i] = bc[:c.n_cap]
        return cd_sg, cd_asg

    def node_name(self, row: int) -> str | None:
        ni = self.node_infos[row]
        return ni.name if ni is not None else None

    # -- victim tensors (batched preemption) ------------------------------

    def refresh_victims(self) -> list[int] | None:
        """Re-encode victim rows marked dirty since the last refresh (plus
        ALL rows when the PDB cache changed — coverage bits are global).
        Called at preempt time, not on the bind hot path.  Returns the
        re-encoded rows (patch candidates), None when nothing changed."""
        if self._vict_pdb_version != self.pdb_version:
            # PDB change flips coverage bits on any row; re-encode all
            # live rows and force a full upload
            self.vict_dirty_rows.update(
                row for row, ni in enumerate(self.node_infos)
                if ni is not None)
            self._vict_pdb_version = self.pdb_version
            self.vict_full = True
        if not self.vict_dirty_rows:
            return None
        blocking = self.pdb_blocking()
        rows = sorted(self.vict_dirty_rows)
        for row in rows:
            self._encode_vict_row(row, blocking)
        self.vict_dirty_rows.clear()
        self.vict_version += 1
        return rows

    def _encode_vict_row(self, row: int, blocking: list) -> None:
        """Victim slots for one node row: ALL resident pods (terminating
        included — the Evaluator's `potential` list keeps them; eligibility
        gating happens host-side), stable-sorted ascending by priority to
        mirror `sorted(ni.pods)` order under the reprieve lexsort.  Rows
        holding more than v_cap lower-priority candidates overflow: the
        device answer would be built from a truncated victim set, so the
        row sets vict_over and any preemptor that can reach it escapes
        with reason victim_overflow."""
        c = self.caps
        ni = self.node_infos[row]
        self.vict_prio[row] = VICT_PAD
        self.vict_req[row] = 0.0
        self.vict_pdb[row] = 0.0
        self.vict_over[row] = False
        if ni is None or not self.valid[row]:
            self.vict_keys[row] = None
            return
        pods = ni.pods
        order = sorted(range(len(pods)), key=lambda j: pods[j].priority)
        if len(order) > c.v_cap:
            self.vict_over[row] = True
            order = order[:c.v_cap]
        keys = []
        for slot, j in enumerate(order):
            pi = pods[j]
            # clamp keeps negation safe in the kernel's lexsort (int32
            # -(-2^31) wraps) and PAD strictly above any real priority
            self.vict_prio[row, slot] = np.int32(
                min(max(pi.priority, -(2**31) + 2), 2**31 - 2))
            try:
                self._encode_resource(self.vict_req[row, slot], pi.request)
            except VocabFullError:
                # a victim whose scalars can't be represented would free
                # resources the kernel can't see; conservative overflow
                self.vict_over[row] = True
            if blocking:
                labels = meta.labels(pi.pod)
                if any(sel.matches(labels) for _, sel in blocking):
                    self.vict_pdb[row, slot] = 1.0
            keys.append(pi.key)
        self.vict_keys[row] = keys

    def victim_occupancy(self) -> float:
        """Fraction of victim slots in use across live rows (gauge feed)."""
        live = self.valid
        if not live.any():
            return 0.0
        used = (self.vict_prio[live] != VICT_PAD).sum()
        return float(used) / float(live.sum() * self.caps.v_cap)


def untolerated_hard(t: ClusterTensors, pi: PodInfo) -> np.ndarray:
    """[t_cap] hard-untolerated taint vector for one pod — the standalone
    twin of BatchEncoder._encode_taints' untol_hard section, for callers
    without a PodBatch (the batched preemption path)."""
    out = np.zeros(t.caps.t_cap, np.float32)
    for tid, (key, value, effect) in enumerate(t.taint_vocab.items):
        if effect not in ("NoSchedule", "NoExecute"):
            continue
        taint = {"key": key, "value": value, "effect": effect}
        if not any(toleration_tolerates_taint(tol, taint)
                   for tol in pi.tolerations):
            out[tid] = 1.0
    return out


@dataclass
class PodBatch:
    """Encoded pod-side tensors for one batch (P = p_cap, padded).

    Constraint-side fields are LAZY: None means "all zeros / -1" (the
    field was never touched by any pod in the batch).  A 16k-pod plain
    batch otherwise allocates ~100 MB of dense zeros per dispatch —
    sel_any alone is [P, G, L] f32 — which measured as the single
    biggest host cost of the batch path.  `ensure()` materializes a
    field on first write; consumers treat None as zeros (pack: plain
    spec never reads them; full spec materializes; _needs_full /
    _replay: None-aware)."""

    p_cap: int
    req: np.ndarray            # f32[P, R]
    req_nz: np.ndarray         # f32[P, R]  (non-zero defaults, for scoring)
    p_valid: np.ndarray        # bool[P]
    untol_hard: np.ndarray     # f32[P, T]  1 = taint t blocks this pod
    untol_prefer: np.ndarray = None   # f32[P, T]  PreferNoSchedule not tolerated
    sel_any: np.ndarray = None        # f32[P, G, L] any-of label groups
    sel_any_active: np.ndarray = None  # f32[P, G]
    sel_forb: np.ndarray = None       # f32[P, L]  forbidden label ids (NotIn)
    key_any: np.ndarray = None        # f32[P, KG, KL] Exists groups
    key_any_active: np.ndarray = None  # f32[P, KG]
    key_forb: np.ndarray = None       # f32[P, KL] DoesNotExist
    ports: np.ndarray = None          # f32[P, PT] requested host ports
    node_row: np.ndarray = None       # i32[P] pinned node row or -1 (None = all -1)
    c_kind: np.ndarray = None         # i32[P, C]
    c_sg: np.ndarray = None           # i32[P, C] selector-group index
    c_maxskew: np.ndarray = None      # f32[P, C]
    c_selfmatch: np.ndarray = None    # f32[P, C]
    c_weight: np.ndarray = None       # f32[P, C] (preferred terms; signed)
    inc_sg: np.ndarray = None         # f32[P, SG]  assigning pod bumps sg counts
    inc_asg: np.ndarray = None        # f32[P, ASG] pod carries this anti group
    match_asg: np.ndarray = None      # f32[P, ASG] pod labels match anti group
    pod_ns: np.ndarray = None         # i32[P] namespace vocab id (ns_cap=unknown)
    # id-based duals of the dense selector arrays (for packed transport;
    # -1 padded; see models/assign.PackSpec)
    sel_ids: np.ndarray = None        # i32[P, G, 8]
    sel_forb_ids: np.ndarray = None   # i32[P, 8]
    key_ids: np.ndarray = None        # i32[P, KG, 4]
    escape: list[int] = field(default_factory=list)  # batch positions for oracle path
    # position -> (plugin, reason) for every escape above: WHICH
    # constraint term forced the pod off the device path (feeds
    # scheduler_tpu_escape_total and the batch span attributes)
    escape_reasons: dict = field(default_factory=dict)
    # positions whose constraints touch a COLLIDED bucket (shared sg/asg
    # slot): a no-fit verdict for these is an upper-bound artifact, not
    # proof — the scheduler re-proves them on the per-pod oracle instead
    # of declaring unschedulable
    nofit_oracle: list[int] = field(default_factory=list)

    _SHAPES = None  # caps-dependent; filled by shapes()

    def shapes(self, caps: "Caps") -> dict:
        c, P = caps, self.p_cap
        return {
            "untol_prefer": ((P, c.t_cap), np.float32, 0.0),
            "sel_any": ((P, c.g_cap, c.l_cap), np.float32, 0.0),
            "sel_any_active": ((P, c.g_cap), np.float32, 0.0),
            "sel_forb": ((P, c.l_cap), np.float32, 0.0),
            "key_any": ((P, c.kg_cap, c.kl_cap), np.float32, 0.0),
            "key_any_active": ((P, c.kg_cap), np.float32, 0.0),
            "key_forb": ((P, c.kl_cap), np.float32, 0.0),
            "ports": ((P, c.pt_cap), np.float32, 0.0),
            "node_row": ((P,), np.int32, -1),
            "c_kind": ((P, c.c_cap), np.int32, 0),
            "c_sg": ((P, c.c_cap), np.int32, -1),
            "c_maxskew": ((P, c.c_cap), np.float32, 0.0),
            "c_selfmatch": ((P, c.c_cap), np.float32, 0.0),
            "c_weight": ((P, c.c_cap), np.float32, 0.0),
            "inc_sg": ((P, c.sg_cap), np.float32, 0.0),
            "inc_asg": ((P, c.asg_cap), np.float32, 0.0),
            "match_asg": ((P, c.asg_cap), np.float32, 0.0),
            "pod_ns": ((P,), np.int32, c.ns_cap),
            "sel_ids": ((P, c.g_cap, 8), np.int32, -1),
            "sel_forb_ids": ((P, 8), np.int32, -1),
            "key_ids": ((P, c.kg_cap, 4), np.int32, -1),
        }

    def ensure(self, caps: "Caps", name: str) -> np.ndarray:
        """Materialize a lazy field (None -> its zero/-1-filled array)."""
        arr = getattr(self, name)
        if arr is None:
            shape, dtype, fill = self.shapes(caps)[name]
            arr = (np.zeros(shape, dtype) if fill == 0.0
                   else np.full(shape, fill, dtype))
            setattr(self, name, arr)
        return arr

    def materialized(self, caps: "Caps", keys) -> dict:
        """Dense arrays for `keys` — the ONE place consumers that need
        every field (mesh upload, dryrun, tests) densify a batch."""
        return {k: self.ensure(caps, k) for k in keys}


def slice_pod_batch(batch: "PodBatch", lo: int, hi: int,
                    p_cap: int) -> "PodBatch":
    """Rows [lo, hi) of a PodBatch re-padded to p_cap — the chunking
    primitive for running an oversized batch through a kernel compiled at
    a smaller P (the constraint-carrying variant's HBM cap at large
    n_cap).  The contiguous special case of gather_pod_batch."""
    return gather_pod_batch(batch, range(lo, hi), p_cap)


def gather_pod_batch(batch: "PodBatch", idx, p_cap: int) -> "PodBatch":
    """Rows `idx` of a PodBatch re-padded to p_cap.  Two callers: the
    chunking path (contiguous `range`, one view-copy per field — the
    hot path for oversized constraint batches) and the straggler retry
    (scattered positions, fancy indexing)."""
    import dataclasses
    n = len(idx)
    contiguous = isinstance(idx, range) and idx.step == 1
    ix = None if contiguous else np.asarray(idx, np.int64)
    fields = {}
    for f in dataclasses.fields(PodBatch):
        if f.name in ("p_cap", "escape", "escape_reasons", "nofit_oracle"):
            continue
        arr = getattr(batch, f.name)
        if arr is None:
            fields[f.name] = None
            continue
        out = np.zeros((p_cap,) + arr.shape[1:], arr.dtype)
        if contiguous:
            out[:n] = arr[idx.start:idx.stop]
        else:
            out[:n] = arr[ix]
        fields[f.name] = out
    if fields.get("node_row") is not None:
        fields["node_row"][n:] = -1
    if contiguous:
        lo, hi = idx.start, idx.stop
        fields["escape"] = [e - lo for e in batch.escape if lo <= e < hi]
        fields["escape_reasons"] = {e - lo: r for e, r
                                    in batch.escape_reasons.items()
                                    if lo <= e < hi}
        fields["nofit_oracle"] = [e - lo for e in batch.nofit_oracle
                                  if lo <= e < hi]
    else:
        pos = {orig: j for j, orig in enumerate(idx)}
        fields["escape"] = [pos[e] for e in batch.escape if e in pos]
        fields["escape_reasons"] = {pos[e]: r for e, r
                                    in batch.escape_reasons.items()
                                    if e in pos}
        fields["nofit_oracle"] = [pos[e] for e in batch.nofit_oracle
                                  if e in pos]
    return PodBatch(p_cap=p_cap, **fields)


class BatchEncoder:
    """Encodes a list of PodInfos against a ClusterTensors instance."""

    def __init__(self, tensors: ClusterTensors, p_cap: int):
        self.t = tensors
        self.p_cap = p_cap
        # (plugin, reason) for the pod currently failing _encode_pod —
        # read by encode() when it routes the pod to the escape list
        self._escape_reason: tuple | None = None

    def _esc(self, plugin: str, reason: str) -> bool:
        """Record why the in-flight pod can't be tensor-encoded and
        return False (the _encode_pod escape convention)."""
        self._escape_reason = (plugin, reason)
        return False

    def encode(self, pod_infos: list[PodInfo]) -> PodBatch:
        t, c = self.t, self.t.caps
        P = self.p_cap
        b = PodBatch(
            p_cap=P,
            req=np.zeros((P, c.r), np.float32),
            req_nz=np.zeros((P, c.r), np.float32),
            p_valid=np.zeros(P, bool),
            untol_hard=np.zeros((P, c.t_cap), np.float32),
        )
        pods = pod_infos[:P]
        n = len(pods)
        if n:
            # request vectors column-wise in bulk (the rows are fresh
            # zeros, so only the core columns + rare scalars need writes;
            # a per-pod _encode_resource pair cost ~3µs/pod); one native
            # pass when built (utils/fasthost), list-comp columns otherwise
            req_columns(pods if isinstance(pods, list) else list(pods),
                        b.req, b.req_nz)
        # plain fast path: a pod with no selectors/affinity/constraints/
        # ports/pins/scalars needs NO per-field writes beyond the bulk
        # request columns above — p_valid plus (when the taint vocab is
        # non-empty and the pod carries no tolerations) one precomputed
        # untolerated row.  This skips _encode_pod entirely for the
        # dominant workload shape (~10µs/pod at bench scale).
        taint_items = t.taint_vocab.items
        if taint_items:
            base_hard = np.zeros(c.t_cap, np.float32)
            base_prefer = np.zeros(c.t_cap, np.float32)
            for tid, (_k, _v, effect) in enumerate(taint_items):
                if effect in ("NoSchedule", "NoExecute"):
                    base_hard[tid] = 1.0
                elif effect == "PreferNoSchedule":
                    base_prefer[tid] = 1.0
            any_prefer = bool(base_prefer.any())
        is_plain = self._is_plain
        # ns-anti guard: once armed (a namespaceSelector anti-affinity
        # term could not REGISTER — asg bucket overflow), any pod whose
        # labels could match one of those selectors must take the
        # oracle too — zero cost while unarmed, which is now the normal
        # state (registered ns terms are covered by resolved groups +
        # namespace masks, not the guard).  Arming can happen MID-batch
        # (the arming pod's _encode_pod runs inside this loop): the
        # post-loop re-scan below retroactively escapes earlier
        # same-batch pods the live guard missed.
        guard_n0 = len(t.ns_anti_kv) + int(t.ns_anti_complex)
        guard_kv = t.ns_anti_kv if guard_n0 else None
        guard_all = t.ns_anti_complex
        for i, pi in enumerate(pods):
            if guard_kv is not None and (
                    guard_all
                    or any(kv in guard_kv for kv in pi.labels.items())):
                b.escape.append(i)
                b.escape_reasons[i] = ("InterPodAffinity",
                                       "ns_anti_guard")
                continue
            if is_plain(pi):
                b.p_valid[i] = True
                if taint_items and not pi.tolerations:
                    b.untol_hard[i] = base_hard
                    if any_prefer:
                        b.ensure(c, "untol_prefer")[i] = base_prefer
                    continue
                elif not taint_items:
                    continue
                # plain pod WITH tolerations vs a live taint vocab:
                # only the taint section of the slow path applies
                self._encode_taints(b, i, pi)
                continue
            try:
                self._escape_reason = None
                ok = self._encode_pod(b, i, pi)
            except VocabFullError as e:
                ok = False
                self._escape_reason = (
                    "BatchEncoder",
                    "constraint_capacity" if "constraint" in str(e)
                    else "vocab_full")
            if ok:
                b.p_valid[i] = True
            else:
                b.escape.append(i)
                b.escape_reasons[i] = (self._escape_reason
                                       or ("BatchEncoder", "unencodable"))
        if len(t.ns_anti_kv) + int(t.ns_anti_complex) != guard_n0:
            # the guard armed during THIS encode: retroactively escape
            # earlier pods in the batch that the live check missed
            esc = set(b.escape)
            for i, pi in enumerate(pods):
                if i in esc or not b.p_valid[i]:
                    continue
                if t.ns_anti_complex or any(
                        kv in t.ns_anti_kv for kv in pi.labels.items()):
                    b.p_valid[i] = False
                    b.escape.append(i)
                    b.escape_reasons[i] = ("InterPodAffinity",
                                           "ns_anti_guard")
        # cross-pod: inc/match rows vs the registered groups — via the
        # exact-kv index (O(pod labels)) + the short complex-selector
        # scan, so 2000 per-service groups don't cost 2000 matches/pod
        if t.sgs or t.asgs:
            inc_sg = b.ensure(c, "inc_sg") if t.sgs else None
            match_asg = b.ensure(c, "match_asg") if t.asgs else None
            inc_asg = b.ensure(c, "inc_asg") if t.asgs else None
            kvi_sg, cx_sg = t._sg_kv_index, t._sg_complex
            kvi_asg, cx_asg = t._asg_kv_index, t._asg_complex
            asg_ids = t._asg_ids
            term_key = t.term_group_key
            # per-pod namespace ids for the device masks — only when a
            # namespaceSelector group has interned namespaces (plain
            # workloads leave the vocab empty and pod_ns lazy, so
            # batches without such terms pay nothing)
            pod_ns = b.ensure(c, "pod_ns") if len(t.ns_vocab) else None
            ns_lookup = t.ns_vocab.lookup
            for i, pi in enumerate(pods):
                if pod_ns is not None:
                    nid = ns_lookup(meta.namespace(pi.pod))
                    if nid is not None:
                        pod_ns[i] = nid
                if not b.p_valid[i]:
                    continue
                if inc_sg is not None:
                    for kv in pi.labels.items():
                        for idx, g in kvi_sg.get(kv, ()):
                            if g.matches_pod(pi):
                                inc_sg[i, idx] = 1.0
                    for idx, g in cx_sg:
                        if g.matches_pod(pi):
                            inc_sg[i, idx] = 1.0
                if match_asg is not None:
                    for kv in pi.labels.items():
                        for idx, g in kvi_asg.get(kv, ()):
                            if g.matches_pod(pi):
                                match_asg[i, idx] = 1.0
                    for idx, g in cx_asg:
                        if g.matches_pod(pi):
                            match_asg[i, idx] = 1.0
                    for term in pi.required_anti_affinity_terms:
                        idx = asg_ids.get(term_key(term))
                        if idx is not None:
                            inc_asg[i, idx] += 1.0
        # collided-bucket post-pass (AFTER all registrations, so buckets
        # that became shared mid-batch are seen): any pod whose
        # constraints reference a shared slot — or that matches a shared
        # anti-affinity bucket — gets the no-fit-means-oracle marker,
        # because its device verdict rides upper-bound counts
        col_sg = [i for i, bk in enumerate(t.sgs) if bk.collided]
        col_asg = [i for i, bk in enumerate(t.asgs) if bk.collided]
        if col_sg or col_asg:
            flagged = np.zeros(P, bool)
            if col_sg and b.c_sg is not None:
                # only HARD blocker constraints can turn an inflated
                # count into a false no-fit; preferred/score slots on a
                # shared bucket distort a score, never feasibility
                hard = b.c_kind == C_ANTI_AFFINITY
                flagged |= (np.isin(b.c_sg, col_sg) & hard).any(axis=1)
            if col_asg and b.match_asg is not None:
                flagged |= (b.match_asg[:, col_asg] > 0).any(axis=1)
            flagged &= b.p_valid
            b.nofit_oracle.extend(np.nonzero(flagged)[0].tolist())
        return b

    @staticmethod
    def _is_plain(pi: PodInfo) -> bool:
        """True when the pod touches none of the constraint-side fields.
        Precomputed by PodInfo.update (types.py) where every input is
        already in hand — PodInfo.plain's checks mirror _encode_pod's
        write sites exactly, so a plain=True pod can never diverge from
        what the fast path assumes."""
        return pi.plain

    def _encode_taints(self, b: PodBatch, i: int, pi: PodInfo) -> None:
        """Taint section of the pod encode (shared by slow path and the
        plain-with-tolerations case): mark every vocab taint this pod
        does NOT tolerate."""
        t, c = self.t, self.t.caps
        for tid, (key, value, effect) in enumerate(t.taint_vocab.items):
            taint = {"key": key, "value": value, "effect": effect}
            tolerated = any(toleration_tolerates_taint(tol, taint)
                            for tol in pi.tolerations)
            if not tolerated:
                if effect in ("NoSchedule", "NoExecute"):
                    b.untol_hard[i, tid] = 1.0
                elif effect == "PreferNoSchedule":
                    b.ensure(c, "untol_prefer")[i, tid] = 1.0

    @staticmethod
    def _push_id(arr: np.ndarray, i: int, lid: int) -> bool:
        """Append lid into the -1-padded id row arr[i]; False if full."""
        row = arr[i]
        for v in range(row.shape[0]):
            if row[v] < 0:
                row[v] = lid
                return True
        return False

    def _arm_ns_anti_guard(self, term) -> None:
        """Record one namespaceSelector ANTI term in the conservative
        guard — the fallback for terms whose group could NOT register
        (asg bucket overflow).  Delegates to the tensors' own arming
        path (also used by the restart-window resident scan)."""
        self.t.arm_ns_anti_guard(term)

    def _cover_ns_anti_terms(self, pi: PodInfo) -> None:
        """Pre-register the resolved ANTI groups of a namespaceSelector
        pod — called before any escape path, so even if the pod escapes
        (nominated node, volumes, overflow), its anti constraint is
        still enforced on the device path once the oracle binds it (the
        bound pod's terms count into cnt_asg via the resolved term
        key).  Only registration failure arms the conservative guard."""
        t = self.t
        for term in pi.required_anti_affinity_terms:
            if term.ns_selector is None:
                continue
            sg = t.group_for_term(term)
            t.intern_namespaces(sg.namespaces)  # mask falls back all-ones
            if t.register_asg(sg) is None:
                self._arm_ns_anti_guard(term)

    # returns False -> escape to oracle path
    def _encode_pod(self, b: PodBatch, i: int, pi: PodInfo) -> bool:
        t, c = self.t, self.t.caps
        if pi.has_ns_selector_terms:
            # namespaceSelector terms resolve to concrete namespace sets
            # against the cached Namespace labels and encode like any
            # other term; the pre-pass keeps anti terms enforced on every
            # escape route out of this function
            self._cover_ns_anti_terms(pi)
        if pi.nominated_node_name:
            # nominated-first fast path (the reference tries the nominated
            # node before the full list): pin the pod to its nominated row
            # and let the device prove the fit.  No-fit is NOT proof of
            # unschedulability — victims may still be terminating — so the
            # position also rides nofit_oracle: a no-fit verdict yields
            # SKIP and the per-pod oracle re-evaluates against the full
            # node list, exactly today's semantics.  Only a nomination
            # whose node left the cluster escapes outright (a genuine
            # re-evaluation, distinct reason in scheduler_tpu_escape_total).
            row = t.row_of.get(pi.nominated_node_name)
            if row is None or not t.valid[row]:
                return self._esc("DefaultPreemption", "nominated_node_stale")
            b.ensure(c, "node_row")[i] = row
            b.nofit_oracle.append(i)
            b.escape_reasons[i] = ("DefaultPreemption", "nominated_node_stale")
        for v in (pi.pod.get("spec") or {}).get("volumes") or ():
            if (v.get("persistentVolumeClaim") or v.get("gcePersistentDisk")
                    or v.get("awsElasticBlockStore") or v.get("azureDisk")
                    or v.get("iscsi") or v.get("csi")):
                # volume binding/zones/limits are deeply stateful (PVC/PV/
                # StorageClass lookups + API writes at PreBind): oracle path
                return self._esc("VolumeBinding", "stateful_volume")
        # (core request columns were filled column-wise in encode();
        # scalar resources are rare enough to stay per-pod — and their
        # VocabFullError must route this pod to the escape path)
        if pi.request.scalar:
            for name, v in pi.request.scalar.items():
                b.req[i, CORE_R + t.scalar_vocab.get(name)] = v
        if pi.request_nonzero.scalar:
            for name, v in pi.request_nonzero.scalar.items():
                b.req_nz[i, CORE_R + t.scalar_vocab.get(name)] = v

        # taints: mark every vocab taint this pod does NOT tolerate
        self._encode_taints(b, i, pi)

        # spec.nodeName pin
        want = (pi.pod.get("spec") or {}).get("nodeName")
        if want:
            row = t.row_of.get(want)
            if row is None:
                return self._esc("NodeName", "unknown_node")
            b.ensure(c, "node_row")[i] = row

        # node selector + required node affinity -> any-of groups / forbidden
        groups: list[list[int]] = []
        key_groups: list[list[int]] = []
        for k, v in pi.node_selector.items():
            groups.append([t.ensure_label_id((k, v))])
        if pi.node_affinity_required:
            enc = self._encode_affinity_terms(pi.node_affinity_required,
                                              groups, key_groups, b, i)
            if not enc:
                return False
        if len(groups) > c.g_cap or len(key_groups) > c.kg_cap:
            return self._esc("NodeAffinity", "group_overflow")
        if groups:
            sel_ids = b.ensure(c, "sel_ids")
            sel_any_active = b.ensure(c, "sel_any_active")
            sel_any = b.ensure(c, "sel_any")
            for g, ids in enumerate(groups):
                if len(ids) > sel_ids.shape[2]:
                    # any-of group too wide for packed transport
                    return self._esc("NodeAffinity", "group_overflow")
                sel_any_active[i, g] = 1.0
                for v, lid in enumerate(ids):
                    sel_any[i, g, lid] = 1.0
                    sel_ids[i, g, v] = lid
        if key_groups:
            key_ids = b.ensure(c, "key_ids")
            key_any_active = b.ensure(c, "key_any_active")
            key_any = b.ensure(c, "key_any")
            for g, ids in enumerate(key_groups):
                if len(ids) > key_ids.shape[2]:
                    return self._esc("NodeAffinity", "group_overflow")
                key_any_active[i, g] = 1.0
                for v, kid in enumerate(ids):
                    key_any[i, g, kid] = 1.0
                    key_ids[i, g, v] = kid
        if pi.node_affinity_preferred:
            # node-affinity scoring: oracle path (rare)
            return self._esc("NodeAffinity", "preferred_terms")

        # host ports
        if pi.host_ports:
            ports = b.ensure(c, "ports")
            for proto, ip, port in pi.host_ports:
                if ip not in ("0.0.0.0", "", None):
                    # per-IP port semantics: oracle path
                    return self._esc("NodePorts", "host_port_ip")
                ports[i, t.port_vocab.get((proto, port))] = 1.0

        # constraints
        ci = 0

        def add_constraint(kind, sg_idx, maxskew=0.0, selfmatch=0.0, weight=0.0):
            nonlocal ci
            if ci >= c.c_cap or sg_idx is None:
                raise VocabFullError("constraint capacity")
            b.ensure(c, "c_kind")[i, ci] = kind
            b.ensure(c, "c_sg")[i, ci] = sg_idx
            b.ensure(c, "c_maxskew")[i, ci] = maxskew
            b.ensure(c, "c_selfmatch")[i, ci] = selfmatch
            b.ensure(c, "c_weight")[i, ci] = weight
            ci += 1

        ns = meta.namespace(pi.pod)
        for tsc in pi.topology_spread_constraints:
            sel = selector_from_dict(tsc.get("labelSelector"))
            sg = SelectorGroup(tsc["topologyKey"], sel, frozenset([ns]))
            kind = (C_SPREAD_HARD
                    if tsc.get("whenUnsatisfiable", "DoNotSchedule") == "DoNotSchedule"
                    else C_SPREAD_SCORE)
            # DoNotSchedule treats counts as enablers of admission
            # (skew vs min) -> exclusive slot; ScheduleAnyway is
            # scoring-only -> shareable
            add_constraint(kind, t.register_sg(
                sg, shareable=kind == C_SPREAD_SCORE),
                maxskew=tsc.get("maxSkew", 1),
                selfmatch=1.0 if sel.matches(pi.labels) else 0.0)
        for term in pi.required_affinity_terms:
            sg = t.group_for_term(term)
            if (term.ns_selector is not None
                    and not t.intern_namespaces(sg.namespaces)):
                return self._esc("InterPodAffinity",
                                 "namespace_vocab_overflow")
            # counts ENABLE here (gathered>0 satisfies): exclusive only
            add_constraint(C_AFFINITY, t.register_sg(sg),
                           selfmatch=1.0 if sg.matches_pod(pi) else 0.0)
        for term in pi.required_anti_affinity_terms:
            sg = t.group_for_term(term)
            if (term.ns_selector is not None
                    and not t.intern_namespaces(sg.namespaces)):
                # the group itself registered in _cover_ns_anti_terms
                # (exact host counts, all-ones mask); only the encoding
                # pod takes the oracle
                return self._esc("InterPodAffinity",
                                 "namespace_vocab_overflow")
            # counts BLOCK here: sharing is sound (upper bounds)
            add_constraint(C_ANTI_AFFINITY, t.register_sg(sg,
                                                          shareable=True))
            if t.register_asg(sg) is None:
                if term.ns_selector is not None:
                    self._arm_ns_anti_guard(term)
                return self._esc("InterPodAffinity", "anti_group_overflow")
        for term in pi.preferred_affinity_terms:
            sg = t.group_for_term(term)
            if (term.ns_selector is not None
                    and not t.intern_namespaces(sg.namespaces)):
                return self._esc("InterPodAffinity",
                                 "namespace_vocab_overflow")
            # scoring only: inflation distorts a score, never legality
            add_constraint(C_PREF_AFFINITY,
                           t.register_sg(sg, shareable=True),
                           weight=float(term.weight))
        for term in pi.preferred_anti_affinity_terms:
            sg = t.group_for_term(term)
            if (term.ns_selector is not None
                    and not t.intern_namespaces(sg.namespaces)):
                return self._esc("InterPodAffinity",
                                 "namespace_vocab_overflow")
            add_constraint(C_PREF_AFFINITY,
                           t.register_sg(sg, shareable=True),
                           weight=-float(term.weight))
        return True

    def _encode_affinity_terms(self, terms, groups, key_groups, b, i) -> bool:
        """Required node-affinity terms (OR over terms, AND within).

        Encodable cases:
          - single term: each requirement becomes its own group
          - multiple terms, each a single positive requirement: union group
        """
        t = self.t
        if any(fields.requirements for _, fields in terms):
            # matchFields (metadata.name): oracle path
            return self._esc("NodeAffinity", "match_fields")
        if len(terms) == 1:
            lab, fields = terms[0]
            for req in lab.requirements:
                if req.operator == IN:
                    groups.append([t.ensure_label_id((req.key, v))
                                   for v in req.values])
                elif req.operator == EXISTS:
                    key_groups.append([t.ensure_key_id(req.key)])
                elif req.operator == NOT_IN:
                    for v in req.values:
                        lid = t.ensure_label_id((req.key, v))
                        b.ensure(t.caps, "sel_forb")[i, lid] = 1.0
                        if not self._push_id(b.ensure(t.caps, "sel_forb_ids"),
                                             i, lid):
                            return self._esc("NodeAffinity",
                                             "not_in_overflow")
                elif req.operator == DOES_NOT_EXIST:
                    # key_forb travels as a dense bitmask; no id list needed
                    b.ensure(t.caps, "key_forb")[
                        i, t.ensure_key_id(req.key)] = 1.0
                else:  # Gt/Lt
                    return self._esc("NodeAffinity", "gt_lt_operator")
            return True
        union: list[int] = []
        for lab, fields in terms:
            reqs = lab.requirements
            if len(reqs) != 1 or reqs[0].operator != IN:
                return self._esc("NodeAffinity", "multi_term")
            for v in reqs[0].values:
                union.append(t.ensure_label_id((reqs[0].key, v)))
        groups.append(union)
        return True
