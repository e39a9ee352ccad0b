"""Write-ahead log + snapshots: disk durability for the cluster store.

The reference's crash-only control plane works because etcd persists every
revision (staging/src/k8s.io/apiserver/pkg/storage/etcd3/store.go:154,331;
etcd's WAL + periodic snapshots).  This module gives MemoryStore the same
property without an external process:

  * every mutation appends a checksummed, length-prefixed record to an
    append-only log (one os.write per store operation — batched ops like
    create_many/bind_many append the whole burst in a single write);
  * a snapshot is a full table dump at one revision.  Taking one is split
    so the expensive part runs OFF the store lock: begin_snapshot()
    (called under the lock) rotates the live log to a numbered segment and
    returns instantly; finish_snapshot() (any thread, no lock) serializes
    the captured state, writes a temp file, fsyncs, atomically renames,
    fsyncs the directory, and only then drops the rotated segments whose
    records the snapshot now covers (compaction — etcd snapshot + WAL
    segment drop);
  * recovery loads the snapshot (if any) and replays rotated segments in
    order, then the live log, skipping records at or below the snapshot
    revision and stopping cleanly at the first torn or corrupt record (a
    crash mid-append loses at most the torn tail, never the prefix — etcd
    WAL CRC semantics);
  * an exclusive flock on the directory rejects a second process pointed
    at the same data dir (etcd's member-dir lock) before it can interleave
    records.

Values land on disk exactly as the table holds them, i.e. AFTER the
at-rest envelope transformer ran (store/encryption.py), so encrypted
resources stay encrypted in both log and snapshot.

Durability level: by default records reach the OS page cache (survives
process SIGKILL, the failure mode the control plane plans for); pass
fsync=True to survive machine power loss at a heavy per-write cost.

Record wire format (little-endian):
    u32 payload_len | u32 crc32(payload) | payload
payload = compact JSON, one of
    ["P", rev, resource, key, obj]   -- put (create/update/bind)
    ["D", rev, resource, key]        -- delete
"""

from __future__ import annotations

import fcntl
import json
import os
import re
import struct
import zlib

_HDR = struct.Struct("<II")

PUT = "P"
DELETE = "D"


def _encode(payload: bytes) -> bytes:
    return _HDR.pack(len(payload), zlib.crc32(payload)) + payload


def _fsync_dir(directory: str) -> None:
    """Make a rename in `directory` itself durable (fsyncing the file is
    not enough: the new directory entry lives in the parent's pages)."""
    fd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class LockedError(Exception):
    """Another live process holds this data directory."""


class WriteAheadLog:
    """Append-only log + snapshot pair rooted at one directory.

    Appends and begin_snapshot() are called by MemoryStore under its own
    lock, which guarantees file order == revision order; finish_snapshot()
    and recover() are safe without it.
    """

    LOG = "wal.log"
    SNAP = "snapshot.json"
    LOCK = "LOCK"
    _SEG = re.compile(r"^wal\.log\.(\d+)$")

    def __init__(self, directory: str, fsync: bool = False,
                 truncate_log_to: int | None = None,
                 pending_records: int = 0):
        self.dir = directory
        self.fsync = fsync
        # records written since the last completed snapshot (a recovered
        # log's replayed records count toward it, so a process that
        # restarts often still compacts)
        self.records_since_snapshot = pending_records
        os.makedirs(directory, exist_ok=True)
        # one writer per data dir (etcd member-dir flock): held for the
        # process lifetime, released by the OS on any exit
        self._lock_f = open(os.path.join(directory, self.LOCK), "w")
        try:
            fcntl.flock(self._lock_f, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            self._lock_f.close()
            raise LockedError(
                f"data dir {directory!r} is locked by another process")
        self._path = os.path.join(directory, self.LOG)
        if truncate_log_to is not None and os.path.exists(self._path) \
                and os.path.getsize(self._path) > truncate_log_to:
            # drop a torn tail found during recovery so new appends start
            # at a record boundary
            with open(self._path, "r+b") as f:
                f.truncate(truncate_log_to)
        self._f = open(self._path, "ab")

    # -- append ----------------------------------------------------------

    def append_put(self, rev: int, resource: str, key: str, obj) -> None:
        self.append_many([(PUT, rev, resource, key, obj)])

    def append_delete(self, rev: int, resource: str, key: str) -> None:
        self.append_many([(DELETE, rev, resource, key)])

    def append_many(self, entries) -> None:
        """entries: iterable of (op, rev, resource, key[, obj]) tuples."""
        chunks = []
        for e in entries:
            payload = json.dumps(list(e), separators=(",", ":"),
                                 default=_jsonify).encode()
            chunks.append(_encode(payload))
        if not chunks:
            return
        self._f.write(b"".join(chunks))
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        self.records_since_snapshot += len(chunks)

    # -- snapshot / compaction -------------------------------------------

    def _segments(self) -> list[str]:
        """Rotated log segments, oldest first."""
        segs = []
        for name in os.listdir(self.dir):
            m = self._SEG.match(name)
            if m:
                segs.append((int(m.group(1)), name))
        return [os.path.join(self.dir, n) for _, n in sorted(segs)]

    def begin_snapshot(self) -> None:
        """Rotate the live log to a numbered segment (cheap; called under
        the store lock so no append can race the rotation).  Every record
        so far is now frozen in segments; finish_snapshot() covers them."""
        self._f.close()
        segs = self._segments()
        nxt = 1
        if segs:
            nxt = int(segs[-1].rsplit(".", 1)[1]) + 1
        os.replace(self._path, f"{self._path}.{nxt}")
        self._f = open(self._path, "ab")
        if self.fsync:
            _fsync_dir(self.dir)
        self.records_since_snapshot = 0

    def finish_snapshot(self, rev: int, data: dict) -> None:
        """Serialize + persist state at `rev`, then drop covered segments.

        `data` must be a shallow copy captured at the same moment
        begin_snapshot() rotated the log (object values are immutable by
        the store's sharing contract, so a 2-level copy is a consistent
        image).  Runs without the store lock — this is the expensive part.

        Crash ordering: tmp write + fsync, atomic rename, DIRECTORY fsync
        (so the rename itself is durable), and only then segment removal.
        A crash at any point leaves either old-snapshot + all segments or
        new-snapshot + possibly-some segments, both of which recover().
        """
        body = json.dumps({"rev": rev, "data": data},
                          separators=(",", ":"), default=_jsonify).encode()
        blob = _encode(body)  # same len+crc framing guards the snapshot
        tmp = os.path.join(self.dir, self.SNAP + ".tmp")
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.dir, self.SNAP))
        _fsync_dir(self.dir)
        for seg in self._segments():
            os.remove(seg)

    # -- recovery --------------------------------------------------------

    @classmethod
    def recover(cls, directory: str) -> tuple[int, dict, int, int]:
        """Load (rev, {resource: {key: obj}}, valid_log_bytes, n_replayed).

        Missing files mean a fresh store.  A corrupt snapshot is a hard
        error (it was fsynced + atomically renamed; damage is real).  A
        corrupt or torn record tail is expected after a crash and stops
        that file's replay; valid_log_bytes marks the boundary in the LIVE
        log so the caller can cut the tail before appending again.
        """
        rev = 0
        data: dict[str, dict] = {}
        snap_path = os.path.join(directory, cls.SNAP)
        if os.path.exists(snap_path):
            with open(snap_path, "rb") as f:
                blob = f.read()
            body = _next_record(blob, 0, strict=True)[0]
            snap = json.loads(body)
            rev = snap["rev"]
            data = snap["data"]
        # rotated segments (a snapshot that never finished), then live log
        segs = []
        if os.path.isdir(directory):
            for name in os.listdir(directory):
                m = cls._SEG.match(name)
                if m:
                    segs.append((int(m.group(1)), name))
        paths = [os.path.join(directory, n) for _, n in sorted(segs)]
        live = os.path.join(directory, cls.LOG)
        if os.path.exists(live):
            paths.append(live)
        valid = 0
        replayed = 0
        for path in paths:
            with open(path, "rb") as f:
                blob = f.read()
            off = 0
            while True:
                rec = _next_record(blob, off, strict=False)
                if rec is None:
                    break
                body, off = rec
                if path == live:
                    valid = off
                entry = json.loads(body)
                op, erev = entry[0], entry[1]
                if erev <= rev:
                    continue  # already in the snapshot
                rev = erev
                replayed += 1
                if op == PUT:
                    _, _, resource, key, obj = entry
                    data.setdefault(resource, {})[key] = obj
                else:
                    _, _, resource, key = entry
                    data.get(resource, {}).pop(key, None)
        return rev, data, valid, replayed

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:  # pragma: no cover
            pass
        try:
            self._lock_f.close()  # releases the flock
        except OSError:  # pragma: no cover
            pass


def _next_record(blob: bytes, off: int, strict: bool):
    """Decode one framed record at `off`; None on clean EOF or torn tail."""
    if off == len(blob):
        return None
    if off + _HDR.size > len(blob):
        if strict:
            raise CorruptRecord("truncated header")
        return None
    length, crc = _HDR.unpack_from(blob, off)
    start = off + _HDR.size
    end = start + length
    if end > len(blob):
        if strict:
            raise CorruptRecord("truncated payload")
        return None
    payload = blob[start:end]
    if zlib.crc32(payload) != crc:
        if strict:
            raise CorruptRecord("checksum mismatch")
        return None
    return payload, end


class CorruptRecord(Exception):
    pass


def _jsonify(o):
    """Last-resort encoder for non-JSON scalars that leak into objects
    (the API layer keeps objects JSON-shaped; this guards test fixtures)."""
    return str(o)
