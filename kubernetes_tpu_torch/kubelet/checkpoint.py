"""Checkpoint manager: atomic, checksummed, file-backed state.

Reference: pkg/kubelet/checkpointmanager — device-manager/cpu-manager
allocation state survives kubelet restarts via checkpoints written
atomically (tmp file + rename) with a checksum guarding torn writes;
corrupt checkpoints surface as errors, not silent garbage.

A copy of kubernetes_tpu/kubelet/checkpoint.py: the same classes, names and
logic, over this package's api/, client/ and store/.
The file format is the JAX package's byte for byte: either package reads
the other's checkpoints.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Any, List, Optional


class CorruptCheckpointError(Exception):
    pass


def _checksum(payload: str) -> str:
    return hashlib.sha256(payload.encode()).hexdigest()


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()

    def _path(self, name: str) -> str:
        if "/" in name or name.startswith("."):
            raise ValueError("invalid checkpoint name %r" % name)
        return os.path.join(self.directory, name)

    def create_checkpoint(self, name: str, data: Any) -> None:
        payload = json.dumps(data, sort_keys=True)
        doc = json.dumps({"data": payload, "checksum": _checksum(payload)})
        path = self._path(name)
        tmp = path + ".tmp"
        with self._lock:
            with open(tmp, "w") as f:
                f.write(doc)
                f.flush()
                os.fsync(f.fileno())
            os.rename(tmp, path)  # atomic on POSIX

    def get_checkpoint(self, name: str) -> Any:
        path = self._path(name)
        with self._lock:
            try:
                with open(path) as f:
                    doc = json.load(f)
            except FileNotFoundError:
                raise KeyError(name)
            except (json.JSONDecodeError, ValueError):
                raise CorruptCheckpointError(name)
        payload = doc.get("data")
        if payload is None or doc.get("checksum") != _checksum(payload):
            raise CorruptCheckpointError(name)
        return json.loads(payload)

    def remove_checkpoint(self, name: str) -> None:
        with self._lock:
            try:
                os.remove(self._path(name))
            except FileNotFoundError:
                pass

    def list_checkpoints(self) -> List[str]:
        with self._lock:
            return sorted(n for n in os.listdir(self.directory)
                          if not n.endswith(".tmp"))
