"""CronJob controller.

Reference: pkg/controller/cronjob/ — cron-schedule parsing (robfig/cron
vendored upstream; a standard 5-field parser here), per-tick Job creation
named <cronjob>-<scheduled-unix-minute>, concurrencyPolicy
Allow/Forbid/Replace, suspend, and successful/failed jobs history limits.
Time-driven: a ticker thread reconciles every `tick` seconds;
reconcile_once(now) is the testable core.

A copy of kubernetes_tpu/controllers/cronjob.py: the same classes,
names and logic, over this package's api/, client/ and store/.
"""

from __future__ import annotations

import logging
import threading
import time

from ..api import meta
from ..api.meta import Obj
from ..client.clientset import CRONJOBS, JOBS, Client
from ..client.informer import SharedInformerFactory
from ..store import kv
from .base import is_owned_by, owner_ref

logger = logging.getLogger(__name__)


class CronParseError(ValueError):
    pass


def _parse_field(field: str, lo: int, hi: int) -> set[int]:
    out: set[int] = set()
    for part in field.split(","):
        try:
            step = 1
            if "/" in part:
                part, step_s = part.split("/", 1)
                step = int(step_s)
            if step <= 0:
                raise CronParseError("step must be positive: %r" % field)
            if part == "*" or part == "":
                rng = range(lo, hi + 1)
            elif "-" in part:
                a, b = part.split("-", 1)
                rng = range(int(a), int(b) + 1)
            else:
                rng = range(int(part), int(part) + 1)
        except ValueError:
            raise CronParseError("invalid cron field %r" % field)
        for v in rng:
            if v < lo or v > hi:
                raise CronParseError("value %d out of range [%d,%d]"
                                     % (v, lo, hi))
            # steps anchor at the range start (vixie cron: 1-23/2 = odd)
            if (v - rng.start) % step == 0:
                out.add(v)
    return out


class CronSchedule:
    """Standard 5-field cron: minute hour day-of-month month day-of-week."""

    def __init__(self, expr: str):
        fields = expr.split()
        if len(fields) != 5:
            raise CronParseError("cron expression needs 5 fields: %r" % expr)
        self.minutes = _parse_field(fields[0], 0, 59)
        self.hours = _parse_field(fields[1], 0, 23)
        self.dom = _parse_field(fields[2], 1, 31)
        self.months = _parse_field(fields[3], 1, 12)
        self.dow = _parse_field(fields[4], 0, 6)  # 0 = Sunday
        self._dom_star = fields[2] == "*"
        self._dow_star = fields[4] == "*"
        # reject never-matching dom/month combos ('0 0 31 2 *') at parse
        # time: otherwise next_after scans its whole horizon every tick.
        # Only the dom-governed case (dow='*') can be infeasible — with a
        # restricted dow, vixie OR semantics still fires on dow matches.
        if not self._dom_star and self._dow_star:
            max_day = {1: 31, 2: 29, 3: 31, 4: 30, 5: 31, 6: 30, 7: 31,
                       8: 31, 9: 30, 10: 31, 11: 30, 12: 31}
            if all(min(self.dom) > max_day[m] for m in self.months):
                raise CronParseError(
                    "schedule never matches: day-of-month %s in months %s"
                    % (sorted(self.dom), sorted(self.months)))

    def matches(self, t: time.struct_time) -> bool:
        if t.tm_min not in self.minutes or t.tm_hour not in self.hours \
                or t.tm_mon not in self.months:
            return False
        dom_ok = t.tm_mday in self.dom
        dow_ok = ((t.tm_wday + 1) % 7) in self.dow  # struct_time: Mon=0
        if self._dom_star and self._dow_star:
            return True
        if self._dom_star:
            return dow_ok
        if self._dow_star:
            return dom_ok
        return dom_ok or dow_ok  # vixie cron OR semantics

    def next_after(self, ts: float, horizon_days: int = 366) -> float | None:
        """Next matching minute strictly after ts."""
        t = int(ts // 60 + 1) * 60
        for _ in range(horizon_days * 24 * 60):
            if self.matches(time.localtime(t)):
                return float(t)
            t += 60
        return None


class CronJobController:
    name = "cronjob"

    def __init__(self, client: Client, factory: SharedInformerFactory,
                 tick: float = 10.0):
        self.client = client
        self.cj_informer = factory.informer(CRONJOBS)
        self.job_informer = factory.informer(JOBS)
        self.tick = tick
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def run(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=self.name)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.wait(self.tick):
            try:
                self.reconcile_once(time.time())
            except Exception:  # noqa: BLE001
                logger.exception("cronjob reconcile failed")

    # -- core (syncCronJob) ----------------------------------------------

    def reconcile_once(self, now: float) -> None:
        for cj in self.cj_informer.list(None):
            try:
                self._sync_one(cj, now)
            except Exception as e:  # noqa: BLE001 — one bad CronJob must
                logger.error("cronjob %s: %s", meta.namespaced_name(cj), e)

    def _sync_one(self, cj: Obj, now: float) -> None:
        spec = cj.get("spec") or {}
        if spec.get("suspend"):
            return
        sched = CronSchedule(spec.get("schedule", ""))
        ns, name = meta.namespace(cj), meta.name(cj)
        status = cj.get("status") or {}
        last = status.get("lastScheduleTime", 0.0)
        created = meta.creation_timestamp(cj) or 0.0
        # the most recent scheduled minute <= now after `last`, never
        # before the CronJob existed (upstream getRecentUnmetScheduleTimes)
        due = None
        t = sched.next_after(max(last, created, now - 24 * 3600))
        while t is not None and t <= now:
            due = t
            t = sched.next_after(t)
        if due is None:
            return
        active = [j for j in self.job_informer.list(ns)
                  if is_owned_by(j, cj) and not self._job_finished(j)]
        policy = spec.get("concurrencyPolicy", "Allow")
        if active and policy == "Forbid":
            return
        if active and policy == "Replace":
            for j in active:
                try:
                    self.client.delete(JOBS, ns, meta.name(j))
                except kv.NotFoundError:
                    pass
        self._create_job(cj, due)
        self._record_schedule(ns, name, due)
        self._gc_history(cj, ns, spec)

    @staticmethod
    def _job_finished(job: Obj) -> bool:
        conds = (job.get("status") or {}).get("conditions") or []
        return any(c.get("type") in ("Complete", "Failed")
                   and c.get("status") == "True" for c in conds)

    def _create_job(self, cj: Obj, due: float) -> None:
        ns = meta.namespace(cj)
        job_name = f"{meta.name(cj)}-{int(due // 60)}"
        tmpl = ((cj.get("spec") or {}).get("jobTemplate") or {})
        job = meta.new_object("Job", job_name, ns)
        job["metadata"]["ownerReferences"] = [owner_ref(cj, "CronJob")]
        job["metadata"]["annotations"] = {
            "cronjob.kubernetes.io/scheduled-at": str(due)}
        job["spec"] = meta.deep_copy(tmpl.get("spec") or {})
        try:
            self.client.create(JOBS, job)
        except kv.AlreadyExistsError:
            pass  # already created for this tick (idempotent name)

    def _record_schedule(self, ns: str, name: str, due: float) -> None:
        def patch(o):
            o.setdefault("status", {})["lastScheduleTime"] = due
            return o
        try:
            self.client.guaranteed_update(CRONJOBS, ns, name, patch)
        except kv.NotFoundError:
            pass

    def _gc_history(self, cj: Obj, ns: str, spec: dict) -> None:
        keep_ok = spec.get("successfulJobsHistoryLimit", 3)
        keep_bad = spec.get("failedJobsHistoryLimit", 1)
        finished = [j for j in self.job_informer.list(ns)
                    if is_owned_by(j, cj) and self._job_finished(j)]
        by_time = sorted(finished, key=lambda j: float(
            (j["metadata"].get("annotations") or {})
            .get("cronjob.kubernetes.io/scheduled-at", 0)))
        ok = [j for j in by_time if any(
            c.get("type") == "Complete" and c.get("status") == "True"
            for c in (j.get("status") or {}).get("conditions", []))]
        bad = [j for j in by_time if j not in ok]
        for j in ok[:-keep_ok] if keep_ok else ok:
            self._delete_job(ns, meta.name(j))
        for j in bad[:-keep_bad] if keep_bad else bad:
            self._delete_job(ns, meta.name(j))

    def _delete_job(self, ns: str, name: str) -> None:
        try:
            self.client.delete(JOBS, ns, name)
        except kv.NotFoundError:
            pass
