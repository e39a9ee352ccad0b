"""Audit logging.

Reference: staging/src/k8s.io/apiserver/pkg/audit + plugin/pkg/audit/log —
a policy maps requests to audit levels (None/Metadata/Request/
RequestResponse); events are emitted at stage RequestReceived and
ResponseComplete as JSON lines to a log backend.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Callable, List, Optional, TextIO

LEVEL_NONE = "None"
LEVEL_METADATA = "Metadata"
LEVEL_REQUEST = "Request"
LEVEL_REQUEST_RESPONSE = "RequestResponse"

_LEVELS = [LEVEL_NONE, LEVEL_METADATA, LEVEL_REQUEST, LEVEL_REQUEST_RESPONSE]


class PolicyRule:
    def __init__(self, level: str, resources: Optional[List[str]] = None,
                 verbs: Optional[List[str]] = None,
                 users: Optional[List[str]] = None):
        self.level = level
        self.resources = resources
        self.verbs = verbs
        self.users = users

    def matches(self, user: str, verb: str, resource: str) -> bool:
        return ((self.resources is None or resource in self.resources)
                and (self.verbs is None or verb in self.verbs)
                and (self.users is None or user in self.users))


class Policy:
    """First matching rule wins (audit policy semantics)."""

    def __init__(self, rules: Optional[List[PolicyRule]] = None,
                 default_level: str = LEVEL_METADATA):
        self.rules = list(rules or ())
        self.default_level = default_level

    def level_for(self, user: str, verb: str, resource: str) -> str:
        for rule in self.rules:
            if rule.matches(user, verb, resource):
                return rule.level
        return self.default_level


class AuditLogger:
    def __init__(self, policy: Optional[Policy] = None,
                 sink: Optional[Callable[[dict], None]] = None,
                 stream: Optional[TextIO] = None,
                 max_events: int = 10000):
        self.policy = policy or Policy()
        self.sink = sink
        self.stream = stream
        self.max_events = max_events
        self._lock = threading.Lock()
        self.events: List[dict] = []  # in-memory ring (tests, /debug)
        self._counter = 0

    def log(self, stage: str, user: str, verb: str, resource: str,
            namespace: str = "", name: str = "", code: int = 0,
            obj: Optional[dict] = None) -> Optional[dict]:
        level = self.policy.level_for(user, verb, resource)
        if level == LEVEL_NONE:
            return None
        with self._lock:
            self._counter += 1
            audit_id = "audit-%d" % self._counter
        event = {
            "kind": "Event", "apiVersion": "audit.k8s.io/v1",
            "auditID": audit_id, "stage": stage, "level": level,
            "verb": verb.lower(),
            "user": {"username": user},
            "objectRef": {"resource": resource, "namespace": namespace,
                          "name": name},
            "requestReceivedTimestamp": time.time(),
        }
        if code:
            event["responseStatus"] = {"code": code}
        if obj is not None and level in (LEVEL_REQUEST,
                                         LEVEL_REQUEST_RESPONSE):
            event["requestObject"] = obj
        with self._lock:
            self.events.append(event)
            if len(self.events) > self.max_events:
                del self.events[: len(self.events) - self.max_events]
            if self.stream is not None:  # serialize writers: no interleaving
                self.stream.write(json.dumps(event) + "\n")
                self.stream.flush()
        if self.sink is not None:
            self.sink(event)
        return event

    def snapshot(self) -> List[dict]:
        with self._lock:
            return list(self.events)
