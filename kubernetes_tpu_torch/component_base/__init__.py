"""Component-base: shared plumbing imported by every binary.

Reference: staging/src/k8s.io/component-base/ (SURVEY.md §2.5) — metrics
(Prometheus wrappers with stability levels), featuregate, logs, tracing,
configz, version.  Re-expressed as small Python modules; every cmd/ binary
and the scheduler import from here.
"""

from . import configz, featuregate, logs, metrics, tracing  # noqa: F401
