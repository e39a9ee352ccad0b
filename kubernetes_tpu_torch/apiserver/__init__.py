"""REST+watch API server (reference: kube-apiserver serving stack)."""

from .server import AdmissionError, APIServer, status_error  # noqa: F401
