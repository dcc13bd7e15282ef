"""Durable storage: the write-ahead log and the request store.

Rebuild of the reference's storage layer (reference:
simplewal/simplewal.go:22-109 over tidwall/wal; reqstore/reqstore.go:24-100
over BadgerDB) as dependency-free file formats:

- FileWal: an append-only segmented log of (index, Persistent) records.
  Appends go to the active segment; ``truncate(index)`` (truncate-front)
  deletes whole segments below the index and tombstones the rest via a
  head-index marker; ``sync`` fsyncs.  Records are length-prefixed canonical
  encodings with a CRC so torn tails are detected and discarded on load.
- FileRequestStore: an append-only intent log of store/commit records with
  an in-memory index; ``uncommitted`` replays stores minus commits at
  startup; compaction rewrites the live set on open.

Both stores expose a group-commit API on top of their synchronous
``sync()``: ``sync_token()`` registers a durability request and returns a
ticket; ``wait(token)`` blocks until an fsync issued *after* the ticket
has completed.  A single background syncer drains all outstanding tickets
with one ``os.fsync``, so k in-flight batches (the pipelined processor
keeps several) pay ~1 fsync instead of k.  The coalescing ratio is
observable as ``mirbft_*_group_commit_batches`` / ``mirbft_*_fsyncs_total``
and the honest per-waiter latency (issue-to-durable, including queueing)
as ``mirbft_*_group_sync_wait_seconds``.

The on-disk bytes are the JAX package's, record for record, and so are
the snapshot staging files (state transfer) and app-state files (``app/``).
"""

from __future__ import annotations

import os
import struct
import threading
import time
import zlib

from .. import pb, wire
from ..obsv import hooks

_REC_HEADER = struct.Struct("<IQI")  # payload_len, index, crc32(payload)
_SEGMENT_TARGET = 4 * 1024 * 1024


def _fsync_dir(path: str) -> None:
    """fsync a directory: os.replace/creat/unlink order *data*, but the
    directory entry itself is not durable until the directory inode is
    synced — without this, a crash after compaction/truncation can come
    back up with the pre-rename file (or both, or neither)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # platform without directory fds
    try:
        os.fsync(fd)
    except OSError:
        pass  # some filesystems refuse dir fsync; best effort
    finally:
        os.close(fd)


def _tree_bytes(path: str) -> int:
    """Sum of regular-file sizes under ``path``; races with concurrent
    rotation/compaction count a vanished file as zero."""
    total = 0
    for root, _dirs, files in os.walk(path):
        for name in files:
            try:
                total += os.stat(os.path.join(root, name)).st_size
            except OSError:
                continue
    return total


class CorruptWal(Exception):
    pass


class _GroupCommit:
    """Ticketed fsync coalescer shared by FileWal and FileRequestStore.

    ``token()`` hands out monotonically increasing tickets; a lazily
    started syncer thread snapshots the highest outstanding ticket, runs
    the owner's ``sync()`` once, and marks every ticket up to the
    snapshot complete.  Waiters observe their own issue-to-durable
    latency, so the histogram stays honest about queueing delay rather
    than reporting only the fsync syscall time."""

    def __init__(self, sync_fn, name: str, batches_metric: str, wait_metric: str):
        self._sync_fn = sync_fn
        self._name = name
        self._batches_metric = batches_metric
        self._wait_metric = wait_metric
        self._cv = threading.Condition()
        self._requested = 0  # guarded-by: _cv
        self._completed = 0  # guarded-by: _cv
        self._issue_ts: dict[int, float] = {}  # guarded-by: _cv
        self._error: BaseException | None = None  # guarded-by: _cv
        self._stopping = False  # guarded-by: _cv
        self._thread: threading.Thread | None = None  # guarded-by: _cv

    def token(self) -> int:
        with self._cv:
            if self._stopping:
                raise OSError(f"{self._name}: storage closed")
            if self._error is not None:
                raise self._error
            self._requested += 1
            token = self._requested
            self._issue_ts[token] = time.perf_counter()
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name=self._name, daemon=True
                )
                self._thread.start()
            self._cv.notify_all()
            return token

    def wait(self, token: int, timeout: float | None = None) -> bool:
        """Block until the ticket's data is durable.  Returns False on
        timeout; raises the syncer's error (e.g. a failing disk) or
        OSError if the store was closed with the ticket uncovered."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._cv:
            while self._completed < token:
                if self._error is not None:
                    self._issue_ts.pop(token, None)
                    raise self._error
                if self._stopping:
                    self._issue_ts.pop(token, None)
                    raise OSError(f"{self._name}: closed before sync completed")
                if deadline is None:
                    self._cv.wait()
                else:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        return False
                    self._cv.wait(timeout=remaining)
            start = self._issue_ts.pop(token, None)
        if hooks.enabled and start is not None:
            hooks.metrics.histogram(self._wait_metric).observe(
                time.perf_counter() - start
            )
        return True

    def _run(self) -> None:
        while True:
            with self._cv:
                while self._completed >= self._requested and not self._stopping:
                    self._cv.wait()
                if self._stopping:
                    return
                target = self._requested
                prev = self._completed
            try:
                self._sync_fn()
            except BaseException as err:
                with self._cv:
                    self._error = err
                    self._cv.notify_all()
                return
            with self._cv:
                self._completed = max(self._completed, target)
                self._cv.notify_all()
            if hooks.enabled:
                hooks.metrics.counter(self._batches_metric).inc(target - prev)

    def stop(self, flush: bool) -> None:
        """Join the syncer.  ``flush=True`` (clean close: the owner has
        just run a final ``sync()``) marks all tickets complete;
        ``flush=False`` (crash) leaves them uncovered so waiters fail."""
        with self._cv:
            self._stopping = True
            if flush and self._error is None:
                self._completed = self._requested
            self._issue_ts.clear()
            self._cv.notify_all()
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)


class FileWal:
    """Write(index, entry) / truncate(index) / sync + load_all replay.

    Layout: <dir>/segments/<first_index>.wal + <dir>/head containing the
    logical head index (entries below it are dead even if still on disk).
    """

    def __init__(self, path: str):
        self.path = path
        self.seg_dir = os.path.join(path, "segments")
        os.makedirs(self.seg_dir, exist_ok=True)
        self._head_path = os.path.join(path, "head")
        self._head_index = self._read_head()  # guarded-by: _lock
        self._entries = self._load_from_disk()  # guarded-by: _lock
        self._active = None  # guarded-by: _lock
        self._active_size = 0  # guarded-by: _lock
        self._needs_sync = False  # guarded-by: _lock
        # Segment rotation threshold.  Truncation can only unlink whole
        # dead segments, so disk reclamation is quantized to this size;
        # short soaks shrink it so steady-state disk usage sawtooths
        # instead of growing for the whole observation window.
        self.segment_target = _SEGMENT_TARGET
        # Fault-injection seam (chaos/live.py): called with no arguments
        # immediately before every fsync; raising OSError from it models a
        # failing disk.  None in production.
        self.fault_hook = None
        # Coarse mutex, like the reference simplewal's (simplewal.go:22-109):
        # the pooled processor runs persist and commit lanes concurrently.
        self._lock = threading.Lock()
        self._group = _GroupCommit(
            self.sync,
            name=f"storage-sync-wal-{os.path.basename(path) or 'wal'}",
            batches_metric="mirbft_wal_group_commit_batches",
            wait_metric="mirbft_wal_group_sync_wait_seconds",
        )

    # -- load ----------------------------------------------------------------

    def _read_head(self) -> int:
        try:
            with open(self._head_path, "rb") as f:
                return int(f.read().decode() or "0")
        except FileNotFoundError:
            return 0

    def _segments(self):
        names = []
        for name in os.listdir(self.seg_dir):
            if name.endswith(".wal"):
                names.append(int(name[:-4]))
        return sorted(names)

    def _load_from_disk(self):  # holds: _lock
        entries = []
        for first in self._segments():
            path = os.path.join(self.seg_dir, f"{first}.wal")
            with open(path, "rb") as f:
                data = f.read()
            pos = 0
            while pos < len(data):
                if pos + _REC_HEADER.size > len(data):
                    break  # torn tail
                length, index, crc = _REC_HEADER.unpack_from(data, pos)
                start = pos + _REC_HEADER.size
                payload = data[start : start + length]
                if len(payload) < length or zlib.crc32(payload) != crc:
                    break  # torn/corrupt tail: discard the rest
                entries.append((index, pb.decode(pb.Persistent, payload)))
                pos = start + length
        return [(i, e) for i, e in entries if i >= self._head_index]

    def load_all(self, for_each) -> None:
        """Invoke for_each(index, pb.Persistent) over the live log.

        Snapshots under the lock, then calls back outside it: replay
        callbacks re-enter the stores (e.g. writing during recovery),
        and holding _lock across them would deadlock."""
        with self._lock:
            entries = list(self._entries)
        for index, entry in entries:
            for_each(index, entry)

    # -- runtime interface ---------------------------------------------------

    def _open_active(self, first_index: int):  # holds: _lock
        path = os.path.join(self.seg_dir, f"{first_index}.wal")
        created = not os.path.exists(path)
        self._active = open(path, "ab")
        self._active_size = self._active.tell()
        if created:
            _fsync_dir(self.seg_dir)

    def write(self, index: int, entry: pb.Persistent) -> None:
        with self._lock:
            self._write_locked(index, entry)

    def _write_locked(self, index: int, entry: pb.Persistent) -> None:  # holds: _lock
        if self._entries and index != self._entries[-1][0] + 1:
            raise CorruptWal(
                f"non-contiguous append: {index} after {self._entries[-1][0]}"
            )
        payload = pb.encode(entry)
        if self._active is None or self._active_size >= self.segment_target:
            if self._active is not None:
                self._active.flush()
                os.fsync(self._active.fileno())
                self._active.close()
            self._open_active(index)
        record = _REC_HEADER.pack(len(payload), index, zlib.crc32(payload))
        self._active.write(record + payload)
        self._active_size += len(record) + len(payload)
        self._entries.append((index, entry))
        self._needs_sync = True
        if hooks.enabled:
            hooks.metrics.counter("mirbft_wal_appends_total").inc()

    def truncate(self, index: int) -> None:
        """Truncate-front: drop every entry with index < the given index."""
        with self._lock:
            self._truncate_locked(index)

    def _truncate_locked(self, index: int) -> None:  # holds: _lock
        self._head_index = index
        with open(self._head_path + ".tmp", "wb") as f:
            f.write(str(index).encode())
            f.flush()
            os.fsync(f.fileno())
        os.replace(self._head_path + ".tmp", self._head_path)
        _fsync_dir(self.path)
        self._entries = [(i, e) for i, e in self._entries if i >= index]
        # Remove whole segments that ended below the head.
        segments = self._segments()
        unlinked = False
        for seg_first, seg_next in zip(segments, segments[1:]):
            if seg_next <= index:
                seg_path = os.path.join(self.seg_dir, f"{seg_first}.wal")
                if self._active is not None and self._active.name == seg_path:
                    continue
                os.unlink(seg_path)
                unlinked = True
        if unlinked:
            _fsync_dir(self.seg_dir)

    def sync(self) -> None:
        with self._lock:
            if self._active is not None and self._needs_sync:
                if self.fault_hook is not None:
                    self.fault_hook()
                start = time.perf_counter() if hooks.enabled else 0.0
                self._active.flush()
                os.fsync(self._active.fileno())
                self._needs_sync = False
                if hooks.enabled:
                    m = hooks.metrics
                    m.counter("mirbft_wal_fsyncs_total").inc()
                    m.histogram("mirbft_wal_fsync_seconds").observe(
                        time.perf_counter() - start
                    )

    def persisted(self) -> bool:
        """Whether the log holds an entry and everything written is
        fsynced: a restart from this WAL then has a log to load."""
        with self._lock:
            return bool(self._entries) and not self._needs_sync

    def sync_token(self) -> int:
        """Group-commit: register a durability request covering everything
        written so far; redeem with ``wait(token)``."""
        return self._group.token()

    def wait(self, token: int, timeout: float | None = None) -> bool:
        return self._group.wait(token, timeout)

    def disk_bytes(self) -> int:
        """On-disk footprint (head file + segments); for the resource
        sampler's ``mirbft_resource_disk_bytes{store="wal"}`` series."""
        return _tree_bytes(self.path)

    def close(self) -> None:
        try:
            self.sync()
        except OSError:
            # Final fsync failed (e.g. an armed fault hook): tickets stay
            # uncovered so pending waiters fail instead of being lied to.
            self._group.stop(flush=False)
        else:
            self._group.stop(flush=True)
        with self._lock:
            if self._active is not None:
                self._active.close()
                self._active = None

    def crash(self) -> None:
        """Crash-kill teardown: release the file handle WITHOUT the
        close-time fsync, modeling power loss.  Unsynced appends may or
        may not survive — exactly the window the durable-prefix invariant
        must tolerate."""
        self._group.stop(flush=False)
        with self._lock:
            if self._active is not None:
                self._active.close()
                self._active = None


_REQ_HEADER = struct.Struct("<BII")  # op, ack_len, data_len
_OP_STORE = 1
_OP_COMMIT = 2

# Live compaction trigger for the request store's intent log: rewrite
# the live set once the log passes the size floor AND is mostly dead
# weight.  Without it the append-only log grows for the whole process
# lifetime (compaction only ran at open), which the resource-leak soak
# would rightly flag as disk growth.
_COMPACT_MIN_BYTES = 4 * 1024 * 1024
_COMPACT_DEAD_RATIO = 4


def _log_records(log_path: str):
    """(op, ack, payload, record bytes) of each whole record of a request
    log, in the order written; stops at a torn or undecodable tail."""
    try:
        with open(log_path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return
    pos = 0
    while pos + _REQ_HEADER.size <= len(data):
        op, ack_len, data_len = _REQ_HEADER.unpack_from(data, pos)
        pos += _REQ_HEADER.size
        if pos + ack_len + data_len > len(data):
            return  # torn tail
        try:
            ack = pb.decode(pb.RequestAck, data[pos : pos + ack_len])
        except ValueError:
            return
        payload = data[pos + ack_len : pos + ack_len + data_len]
        pos += ack_len + data_len
        yield op, ack, payload, _REQ_HEADER.size + ack_len + data_len


def logged_stores(path: str) -> list:
    """Every (ack, data) STORE record in the request log of the store
    at ``path``, committed or not, read without replay or compaction
    (opening a ``FileRequestStore`` drops the committed ones): what the
    store was handed since its log was last compacted, at its open or
    live past ``_COMPACT_MIN_BYTES``."""
    return [
        (ack, payload)
        for op, ack, payload, _size in _log_records(
            os.path.join(path, "requests.log"))
        if op == _OP_STORE
    ]


class FileRequestStore:
    """store/get/commit/sync + uncommitted replay.

    An intent log: STORE records carry (ack, data); COMMIT records carry the
    ack only.  The live (uncommitted) set is the stores minus the commits;
    compaction rewrites just the live set — at open, and live whenever
    the log exceeds ``compact_min_bytes`` while being mostly dead weight
    (so long-running processes reclaim disk instead of growing forever).
    """

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._log_path = os.path.join(path, "requests.log")
        # key -> (ack, data, record_bytes); record_bytes feeds the live
        # size the compaction trigger compares the log against.
        self._index: dict[bytes, tuple] = {}  # guarded-by: _lock
        self._replay()
        self._compact()
        self._file = open(self._log_path, "ab")  # guarded-by: _lock
        self.compact_min_bytes = _COMPACT_MIN_BYTES
        self._log_size = self._file.tell()  # guarded-by: _lock
        self._live_size = self._log_size  # guarded-by: _lock
        # Pre-fsync fault seam, mirroring FileWal.fault_hook.
        self.fault_hook = None
        # store/commit run from different pooled lanes (reference reqstore
        # wraps BadgerDB, which is internally synchronized; our file log
        # needs the mutex).
        self._lock = threading.Lock()
        self._group = _GroupCommit(
            self.sync,
            name=f"storage-sync-reqstore-{os.path.basename(path) or 'reqs'}",
            batches_metric="mirbft_reqstore_group_commit_batches",
            wait_metric="mirbft_reqstore_group_sync_wait_seconds",
        )

    @staticmethod
    def _key(ack: pb.RequestAck) -> bytes:
        return (
            wire.encode_varint(ack.client_id)
            + wire.encode_varint(ack.req_no)
            + ack.digest
        )

    def _replay(self) -> None:  # holds: _lock
        for op, ack, payload, size in _log_records(self._log_path):
            if op == _OP_STORE:
                self._index[self._key(ack)] = (ack, payload, size)
            elif op == _OP_COMMIT:
                self._index.pop(self._key(ack), None)

    def _compact(self) -> None:  # holds: _lock
        tmp = self._log_path + ".tmp"
        with open(tmp, "wb") as f:
            for ack, data, _size in self._index.values():
                self._write_record(f, _OP_STORE, ack, data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._log_path)
        _fsync_dir(self.path)

    def _maybe_compact_locked(self) -> None:  # holds: _lock
        if self._log_size < self.compact_min_bytes:
            return
        if self._log_size <= _COMPACT_DEAD_RATIO * max(self._live_size, 1):
            return
        self._file.flush()
        self._file.close()
        self._compact()
        self._file = open(self._log_path, "ab")
        self._log_size = self._file.tell()
        self._live_size = self._log_size
        if hooks.enabled:
            hooks.metrics.counter("mirbft_reqstore_compactions_total").inc()

    @staticmethod
    def _write_record(f, op: int, ack: pb.RequestAck, data: bytes) -> int:
        ack_bytes = pb.encode(ack)
        f.write(_REQ_HEADER.pack(op, len(ack_bytes), len(data)))
        f.write(ack_bytes)
        f.write(data)
        return _REQ_HEADER.size + len(ack_bytes) + len(data)

    # -- runtime interface ---------------------------------------------------

    def store(self, ack: pb.RequestAck, data: bytes) -> None:
        with self._lock:
            size = self._write_record(self._file, _OP_STORE, ack, data or b"")
            self._log_size += size
            key = self._key(ack)
            old = self._index.pop(key, None)
            if old is not None:
                self._live_size -= old[2]
            self._index[key] = (ack, data or b"", size)
            self._live_size += size
            if hooks.enabled:
                hooks.metrics.counter("mirbft_reqstore_appends_total").inc()

    def get(self, ack: pb.RequestAck) -> bytes | None:
        with self._lock:
            entry = self._index.get(self._key(ack))
        return entry[1] if entry is not None else None

    def commit(self, ack: pb.RequestAck) -> None:
        with self._lock:
            self._log_size += self._write_record(
                self._file, _OP_COMMIT, ack, b""
            )
            old = self._index.pop(self._key(ack), None)
            if old is not None:
                self._live_size -= old[2]
            self._maybe_compact_locked()

    def sync(self) -> None:
        with self._lock:
            if self.fault_hook is not None:
                self.fault_hook()
            start = time.perf_counter() if hooks.enabled else 0.0
            self._file.flush()
            os.fsync(self._file.fileno())
            if hooks.enabled:
                m = hooks.metrics
                m.counter("mirbft_reqstore_fsyncs_total").inc()
                m.histogram("mirbft_reqstore_fsync_seconds").observe(
                    time.perf_counter() - start
                )

    def uncommitted(self, for_each) -> None:
        """Invoke for_each(ack) for every stored-but-uncommitted request, in
        deterministic key order.

        Snapshots under the lock, then calls back outside it: replay
        callbacks re-enter the store (propose paths store/commit), and
        holding _lock across them would deadlock."""
        with self._lock:
            acks = [self._index[key][0] for key in sorted(self._index)]
        for ack in acks:
            for_each(ack)

    def pending_count(self) -> int:
        """Stored-but-uncommitted entries.  Duplicate stores overwrite in
        place, so under a duplication flood this is the memory-bound
        evidence the chaos audit reads: at most one pending entry per
        distinct request."""
        with self._lock:
            return len(self._index)

    def sync_token(self) -> int:
        """Group-commit ticket, mirroring FileWal.sync_token."""
        return self._group.token()

    def wait(self, token: int, timeout: float | None = None) -> bool:
        return self._group.wait(token, timeout)

    def disk_bytes(self) -> int:
        """On-disk footprint of the intent log; for the resource
        sampler's ``mirbft_resource_disk_bytes{store="reqstore"}``."""
        return _tree_bytes(self.path)

    def close(self) -> None:
        try:
            self.sync()
        except OSError:
            self._group.stop(flush=False)
        else:
            self._group.stop(flush=True)
        with self._lock:
            self._file.close()

    def crash(self) -> None:
        """Crash-kill teardown: release the handle without the orderly
        fsync (see FileWal.crash).  In-process simulation cannot drop the
        page cache, but the skipped fsync still distinguishes the crash
        path from clean shutdown for the durable-prefix audit."""
        self._group.stop(flush=False)
        with self._lock:
            self._file.close()


# -- snapshot staging (state transfer) ---------------------------------------
#
# The transfer engine (runtime/transfer.py) stages a verified snapshot to
# disk *before* adoption so a crash mid-install restarts cleanly: the core
# re-emits state_transfer on restart (TEntry > CEntry in the WAL), the
# engine finds the staged blob for the same target, and completes the
# install without re-fetching.  All fsync-bearing snapshot file I/O lives
# here (lint rules W10/W17).


def write_snapshot_file(path: str, blob: bytes) -> None:
    """Atomically persist a snapshot blob: tmp + fsync + rename + dir
    fsync, so ``path`` either holds the complete blob or does not exist —
    a torn staging file can never be mistaken for a verified snapshot."""
    directory = os.path.dirname(path) or "."
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(directory)


def read_snapshot_file(path: str) -> bytes | None:
    """Read a staged snapshot blob, or None when absent."""
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError:
        return None


def remove_snapshot_file(path: str) -> None:
    """Discard a staged snapshot (post-install or on target change); the
    unlink is made durable so a crash cannot resurrect a consumed blob."""
    directory = os.path.dirname(path) or "."
    try:
        os.unlink(path)
    except OSError:
        return
    _fsync_dir(directory)


# -- application state (replicated app snapshots) -----------------------------
#
# The app commit stream (app/stream.py) persists its state as
# ONE atomic blob: the applied consensus seq_no, the apply index, the
# journal chain, and the state machine's own snapshot travel together,
# so a crash at any instant leaves either the old complete state or the
# new complete state — never an applied-index that disagrees with the
# entries actually absorbed (the double-apply-after-restart bug class).
# All fsync-bearing app-state file I/O lives here (lint rules W10/W18).


def write_app_state(path: str, blob: bytes) -> None:
    """Atomically persist an app-state blob (tmp + fsync + rename + dir
    fsync): the applied-index inside the blob can never be observed
    without the state it describes."""
    write_snapshot_file(path, blob)


def read_app_state(path: str) -> bytes | None:
    """Read a persisted app-state blob, or None when absent."""
    return read_snapshot_file(path)


def remove_app_state(path: str) -> None:
    """Durably discard a persisted app-state blob."""
    remove_snapshot_file(path)
