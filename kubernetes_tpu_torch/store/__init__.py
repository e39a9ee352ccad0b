"""Versioned store with watch (etcd-equivalent)."""

from .kv import (  # noqa: F401
    ADDED, MODIFIED, DELETED, BOOKMARK,
    AlreadyExistsError, ConflictError, MemoryStore, NotFoundError, StoreError,
    TooOldError, Watch, WatchEvent,
)
