"""/configz registry.

Reference: component-base/configz — each binary installs its live
component configuration under a named key, served as JSON at /configz for
debugging.  The apiserver exposes this registry.
"""

from __future__ import annotations

import threading
from typing import Any, Dict


class Registry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._configs: Dict[str, Any] = {}

    def install(self, name: str, config: Any) -> None:
        with self._lock:
            self._configs[name] = config

    def delete(self, name: str) -> None:
        with self._lock:
            self._configs.pop(name, None)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._configs)


default_registry = Registry()


def install(name: str, config: Any) -> None:
    default_registry.install(name, config)
