"""API Priority & Fairness.

Reference: staging/src/k8s.io/apiserver/pkg/util/flowcontrol —
FlowSchemas classify requests into PriorityLevels; each level runs a
fair queueing system (fairqueuing/queueset/queueset.go):

  - a level owns Q bounded queues and S seats
  - each flow (distinguisher: the user) is dealt a HAND of H queues by
    shuffle sharding (shufflesharding/dealer.go) and enqueues on the
    shortest queue in its hand — an elephant flow can fill at most its
    own hand while a mouse flow's hand almost surely contains an
    uncrowded queue
  - seats dispatch round-robin across non-empty queues, one request
    per queue per turn — the fairness that keeps one noisy client from
    starving a peer at the same level (the upstream virtual-time WFQ
    reduces to this when all requests cost one seat)
  - a full queue or a timed-out wait is a 429 with Retry-After

Configuration is API-object driven like the reference's apf_controller:
`bind_store()` lists+watches FlowSchema / PriorityLevelConfiguration
objects (group flowcontrol.apiserver.k8s.io) and rebuilds the dispatch
table on change; code-built defaults serve until objects exist.
"""

from __future__ import annotations

import hashlib
import logging
import threading
import time
from collections import deque
from typing import Callable, List, Optional

logger = logging.getLogger(__name__)

FLOWSCHEMAS = "flowschemas"
PRIORITYLEVELS = "prioritylevelconfigurations"

DEFAULT_LEVELS = (
    # (name, seats, queues, queue_length, exempt)
    ("exempt", 0, 0, 0, True),
    ("leader-election", 10, 16, 50, False),
    ("workload-high", 40, 128, 50, False),
    ("workload-low", 20, 128, 50, False),
    ("global-default", 20, 128, 50, False),
    ("catch-all", 5, 1, 50, False),
)


class RejectedError(Exception):
    """Surfaces as HTTP 429 Too Many Requests."""


def shuffle_shard_hand(flow_key: str, queues: int,
                       hand_size: int) -> list[int]:
    """Deal `hand_size` distinct queue indices for a flow
    (shufflesharding/dealer.go): consume the flow hash as a mixed-radix
    number; each digit picks among the not-yet-dealt queues."""
    if queues <= hand_size:
        return list(range(queues))
    entropy = int.from_bytes(
        hashlib.sha256(flow_key.encode()).digest()[:16], "big")
    hand: list[int] = []
    for i in range(hand_size):
        pick = entropy % (queues - i)
        entropy //= (queues - i)
        # map pick onto the queues not already in the hand
        for dealt in sorted(hand):
            if pick >= dealt:
                pick += 1
        hand.append(pick)
    return hand


class _Waiter:
    __slots__ = ("event", "admitted")

    def __init__(self):
        self.event = threading.Event()
        self.admitted = False


class PriorityLevel:
    def __init__(self, name: str, seats: int, queues: int = 64,
                 queue_length: int = 50, exempt: bool = False,
                 hand_size: int | None = None):
        self.name = name
        self.seats = seats
        self.exempt = exempt
        self.queue_length = queue_length
        self.queues = max(1, queues)
        self.hand_size = (max(1, min(8, self.queues)) if hand_size is None
                          else max(1, min(hand_size, self.queues)))
        self._lock = threading.Lock()
        self._queues: list[deque[_Waiter]] = [deque()
                                              for _ in range(self.queues)]
        self._rr = 0  # round-robin cursor over queues
        self._in_flight = 0
        self._waiting = 0
        # metrics
        self.dispatched = 0
        self.rejected = 0
        self.timed_out = 0

    # -- queueing core ---------------------------------------------------

    def _dispatch_locked(self) -> None:
        """Hand free seats to queued requests, one per non-empty queue
        per round-robin turn (queueset dispatching)."""
        while self._in_flight < self.seats and self._waiting > 0:
            for step in range(self.queues):
                qi = (self._rr + step) % self.queues
                if self._queues[qi]:
                    waiter = self._queues[qi].popleft()
                    self._rr = (qi + 1) % self.queues
                    self._waiting -= 1
                    self._in_flight += 1
                    self.dispatched += 1
                    waiter.admitted = True
                    waiter.event.set()
                    break
            else:
                return  # queues empty (waiting counter raced)

    def acquire(self, flow_key: str = "", timeout: float = 15.0) -> bool:
        if self.exempt:
            with self._lock:
                self.dispatched += 1
            return True
        with self._lock:
            if self._in_flight < self.seats and self._waiting == 0:
                self._in_flight += 1
                self.dispatched += 1
                return True
            # shuffle-sharded queue assignment: shortest queue in hand
            hand = shuffle_shard_hand(flow_key, self.queues,
                                      self.hand_size)
            qi = min(hand, key=lambda i: len(self._queues[i]))
            if len(self._queues[qi]) >= self.queue_length:
                self.rejected += 1
                raise RejectedError(
                    "too many queued requests for flow %r at priority "
                    "level %s" % (flow_key, self.name))
            waiter = _Waiter()
            self._queues[qi].append(waiter)
            self._waiting += 1
            # a seat may have freed while we were classifying
            self._dispatch_locked()
        if waiter.event.wait(timeout):
            return True
        with self._lock:
            if waiter.admitted:
                # dispatch won the race with the timeout
                return True
            try:
                self._queues[qi].remove(waiter)
                self._waiting -= 1
            except ValueError:
                pass
            self.timed_out += 1
        raise RejectedError("request timed out in priority level queue "
                            + self.name)

    def release(self) -> None:
        if self.exempt:
            return
        with self._lock:
            self._in_flight = max(0, self._in_flight - 1)
            self._dispatch_locked()

    def reconfigure(self, seats: int, queues: int, queue_length: int,
                    hand_size: int | None) -> None:
        """Apply a config change IN PLACE: in-flight requests hold
        tickets referencing this object, so replacing it would strand
        their seats forever.  Waiters in removed queues re-home
        round-robin; new headroom dispatches immediately."""
        with self._lock:
            self.seats = seats
            self.queue_length = queue_length
            new_n = max(1, queues)
            if new_n != self.queues:
                waiters = [w for q in self._queues for w in q]
                self._queues = [deque() for _ in range(new_n)]
                for i, w in enumerate(waiters):
                    self._queues[i % new_n].append(w)
                self.queues = new_n
                self._rr = 0
            self.hand_size = (max(1, min(8, self.queues))
                              if hand_size is None
                              else max(1, min(hand_size, self.queues)))
            self._dispatch_locked()

    def stats(self) -> dict:
        with self._lock:
            return {"in_flight": self._in_flight, "waiting": self._waiting,
                    "dispatched": self.dispatched, "rejected": self.rejected,
                    "timed_out": self.timed_out}


class FlowSchema:
    """Matches requests to a priority level (flowcontrol FlowSchema)."""

    def __init__(self, name: str, level: str, matching_precedence: int = 1000,
                 match: Optional[Callable[[str, str, str], bool]] = None):
        self.name = name
        self.level = level
        self.matching_precedence = matching_precedence
        self.match = match or (lambda user, verb, resource: True)


def _schema_from_object(obj: dict) -> FlowSchema | None:
    """Compile a stored FlowSchema object into a matcher.

    Spec shape (flowcontrol.apiserver.k8s.io/v1 FlowSchema): rules of
    {subjects: [{kind: User|Group|ServiceAccount, name}], resourceRules:
    [{verbs, resources}]}; '*' wildcards match everything."""
    spec = obj.get("spec") or {}
    level = ((spec.get("priorityLevelConfiguration") or {})
             .get("name"))
    if not level:
        return None
    rules = spec.get("rules") or []

    def match(user: str, verb: str, resource: str,
              groups: tuple[str, ...] = ()) -> bool:
        if not rules:
            return True
        for rule in rules:
            subjects = rule.get("subjects") or []
            subject_ok = not subjects
            for s in subjects:
                kind = s.get("kind")
                name = (s.get("name") or
                        (s.get("user") or {}).get("name") or
                        (s.get("group") or {}).get("name") or "")
                if kind == "User" and name in ("*", user):
                    subject_ok = True
                elif kind == "Group" and (name == "*" or name in groups):
                    subject_ok = True
                elif kind == "ServiceAccount" and user.startswith(
                        "system:serviceaccount:"):
                    sa = s.get("serviceAccount") or {}
                    want = (f"system:serviceaccount:"
                            f"{sa.get('namespace', '')}:"
                            f"{sa.get('name', '')}")
                    if sa.get("name") == "*" and user.startswith(
                            f"system:serviceaccount:"
                            f"{sa.get('namespace', '')}:"):
                        subject_ok = True
                    elif user == want:
                        subject_ok = True
            if not subject_ok:
                continue
            rrules = rule.get("resourceRules") or []
            if not rrules:
                if rule.get("nonResourceRules"):
                    # this filter only classifies RESOURCE requests — a
                    # nonResourceRules-only rule (e.g. the bootstrap
                    # /healthz 'probes' schema) must not match here
                    continue
                return True
            for rr in rrules:
                verbs = rr.get("verbs") or ["*"]
                resources = rr.get("resources") or ["*"]
                if ("*" in verbs or verb in verbs) and \
                        ("*" in resources or resource in resources):
                    return True
        return False

    fs = FlowSchema(obj.get("metadata", {}).get("name", "?"), level,
                    spec.get("matchingPrecedence", 1000))
    fs.match_with_groups = match
    fs.match = lambda u, v, r: match(u, v, r, ())
    return fs


def _level_params(obj: dict) -> tuple[str, dict] | None:
    """PriorityLevelConfiguration -> (name, PriorityLevel kwargs)."""
    spec = obj.get("spec") or {}
    name = obj.get("metadata", {}).get("name")
    if not name:
        return None
    if spec.get("type") == "Exempt":
        return name, {"seats": 0, "queues": 0, "queue_length": 0,
                      "exempt": True}
    limited = spec.get("limited") or {}
    seats = limited.get("nominalConcurrencyShares", 20)
    response = limited.get("limitResponse") or {}
    if response.get("type") == "Reject":
        # at-capacity requests 429 immediately: no queues to wait in
        return name, {"seats": seats, "queues": 1, "queue_length": 0,
                      "hand_size": 1}
    queuing = response.get("queuing") or {}
    return name, {"seats": seats,
                  "queues": queuing.get("queues", 64),
                  "queue_length": queuing.get("queueLengthLimit", 50),
                  "hand_size": queuing.get("handSize")}


class Dispatcher:
    """The WithPriorityAndFairness filter (config.go:823)."""

    def __init__(self, levels=DEFAULT_LEVELS,
                 schemas: Optional[List[FlowSchema]] = None,
                 queue_timeout: float = 15.0):
        self._lock = threading.Lock()
        self.levels = {name: PriorityLevel(name, seats, queues, qlen, exempt)
                       for name, seats, queues, qlen, exempt in levels}
        self.queue_timeout = queue_timeout
        self.schemas = sorted(schemas if schemas is not None
                              else self._default_schemas(),
                              key=lambda s: s.matching_precedence)
        self._stop = threading.Event()
        self._watch_thread: threading.Thread | None = None

    @staticmethod
    def _default_schemas() -> List[FlowSchema]:
        return [
            FlowSchema("system-leader-election", "leader-election", 100,
                       lambda u, v, r: r == "leases"),
            FlowSchema("kube-system-service-accounts", "workload-high", 900,
                       lambda u, v, r: u.startswith("system:")),
            FlowSchema("global-default", "global-default", 9900),
            FlowSchema("catch-all", "catch-all", 10000),
        ]

    # -- API-object configuration (apf_controller.go) --------------------

    def bind_store(self, store) -> None:
        """Drive configuration from stored FlowSchema /
        PriorityLevelConfiguration objects: list now, watch for changes.
        Stored objects REPLACE the code defaults for their name;
        deleting one reverts to the default.  The watch resumes from
        the reload's own list revision — an object written between the
        two would otherwise be lost to both."""
        self._store = store
        self._defaults = {name: dict(seats=seats, queues=queues,
                                     queue_length=qlen, exempt=exempt)
                          for name, seats, queues, qlen, exempt
                          in DEFAULT_LEVELS}
        since_rv = self._reload()
        self._watch_thread = threading.Thread(
            target=self._watch_loop, args=(since_rv,),
            name="apf-config-watch", daemon=True)
        self._watch_thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _reload(self) -> int:
        plcs, rv1 = self._store.list(PRIORITYLEVELS)
        schemas_objs, rv2 = self._store.list(FLOWSCHEMAS)
        desired: dict[str, dict] = {
            name: dict(params) for name, params in self._defaults.items()}
        for obj in plcs:
            got = _level_params(obj)
            if got is not None:
                desired[got[0]] = got[1]
        with self._lock:
            for name, params in desired.items():
                existing = self.levels.get(name)
                if existing is not None and not existing.exempt \
                        and not params.get("exempt"):
                    # reconfigure IN PLACE: live tickets reference this
                    # object, so swapping it would strand their seats
                    existing.reconfigure(
                        params["seats"], params["queues"],
                        params["queue_length"], params.get("hand_size"))
                elif existing is None or bool(params.get("exempt")) \
                        != existing.exempt:
                    self.levels[name] = PriorityLevel(name, **params)
            for name in [n for n in self.levels if n not in desired]:
                del self.levels[name]  # PLC deleted, no default: gone
            stored = []
            for obj in schemas_objs:
                fs = _schema_from_object(obj)
                if fs is not None and fs.level in self.levels:
                    stored.append(fs)
            names = {fs.name for fs in stored}
            kept = [s for s in self._default_schemas()
                    if s.name not in names]
            self.schemas = sorted(stored + kept,
                                  key=lambda s: s.matching_precedence)
        return min(rv1, rv2)

    def _watch_loop(self, since_rv: int) -> None:
        watches = [self._store.watch(FLOWSCHEMAS, since_rv=since_rv),
                   self._store.watch(PRIORITYLEVELS, since_rv=since_rv)]
        try:
            while not self._stop.is_set():
                changed = False
                for w in watches:
                    ev = w.next(timeout=0.5)
                    while ev is not None:
                        changed = True
                        ev = w.next(timeout=0.0)
                if changed:
                    self._reload()
        finally:
            for w in watches:
                w.stop()

    # -- request path ----------------------------------------------------

    def classify(self, user: str, verb: str, resource: str,
                 groups: tuple[str, ...] = ()) -> PriorityLevel:
        with self._lock:
            schemas = list(self.schemas)
            levels = dict(self.levels)
        for schema in schemas:
            matcher = getattr(schema, "match_with_groups", None)
            hit = (matcher(user, verb, resource, groups) if matcher
                   else schema.match(user, verb, resource))
            if hit:
                level = levels.get(schema.level)
                if level is not None:
                    return level
        return levels["catch-all"]

    class _Ticket:
        __slots__ = ("level",)

        def __init__(self, level: PriorityLevel):
            self.level = level

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            self.level.release()

    def admit(self, user: str, verb: str, resource: str,
              groups: tuple[str, ...] = ()) -> "Dispatcher._Ticket":
        """Raises RejectedError (-> 429) or returns a context manager that
        holds a seat for the request's duration.  The flow
        distinguisher is the user (FlowDistinguisherMethodByUser)."""
        level = self.classify(user, verb, resource, groups)
        level.acquire(flow_key=user, timeout=self.queue_timeout)
        return self._Ticket(level)

    def stats(self) -> dict:
        with self._lock:
            levels = dict(self.levels)
        return {name: lvl.stats() for name, lvl in levels.items()}
