"""The apply/commit-stream API.

``CommitStream`` is the public boundary between the consensus engine and
a replicated state machine: it implements the runtime ``Log`` contract
(``apply``/``snap``), delivers every committed op to the registered app
exactly once per **apply index** — a monotone counter over ops in the
consensus order, identical on every replica — and persists that index
*inside* the app snapshot blob so a restart (or a snapshot install via
runtime/transfer.py) resumes without re-applying or gap-applying.

Threading: ``apply`` runs on the processor's commit path and only
*enqueues* into a bounded queue; a dedicated app thread drains it and
invokes the state machine.  When the app is slow the queue fills and
``apply`` blocks — backpressure propagates into the commit stage instead
of heap growth.  ``snap`` drains the queue (checkpoints capture a
consistent prefix) and then writes one atomic blob via
``storage.write_app_state``: applied seq, apply index, journal chain and
state-machine snapshot travel together, so no crash point can leave an
applied-index that disagrees with the state it describes (the
double-apply-after-restart bug class).

The checkpoint **value** returned by ``snap`` is a digest binding the
whole blob, so the 2f+1 checkpoint certificate certifies the full app
state — an installing node verifies the received blob against the
certified value before adopting it.
"""

from __future__ import annotations

import hashlib
import struct
import threading
import time
from collections import OrderedDict

from ..core.quorum import bit_is_set
from ..obsv import hooks
from ..obsv.bqueue import BoundedQueue
from ..runtime import storage
from ..runtime.processor import Log

_STATE_MAGIC = b"MAPP1"
_BINDING_DOMAIN = b"mirbft-app-state/1"
_KEPT_SNAPSHOTS = 4


def encode_state(applied_seq: int, applied_index: int, chain: bytes,
                 app_blob: bytes) -> bytes:
    return (
        _STATE_MAGIC
        + struct.pack(">QQI", applied_seq, applied_index, len(chain))
        + chain
        + struct.pack(">I", len(app_blob))
        + app_blob
    )


def decode_state(blob: bytes):
    """-> (applied_seq, applied_index, chain, app_blob) or None."""
    if blob[: len(_STATE_MAGIC)] != _STATE_MAGIC:
        return None
    try:
        off = len(_STATE_MAGIC)
        applied_seq, applied_index, clen = struct.unpack_from(">QQI", blob, off)
        off += 20
        chain = blob[off : off + clen]
        off += clen
        (alen,) = struct.unpack_from(">I", blob, off)
        off += 4
        app_blob = blob[off : off + alen]
        if len(chain) != clen or len(app_blob) != alen:
            return None
        return applied_seq, applied_index, chain, app_blob
    except struct.error:
        return None


def state_binding(blob: bytes) -> bytes:
    """The checkpoint value for an app-state blob: certificate-bound."""
    return hashlib.sha256(_BINDING_DOMAIN + blob).digest()


class _Waiter:
    """One write's completion handle: resolved on the app thread when the
    op applies, carrying (apply_index, state-machine result)."""

    __slots__ = ("event", "index", "result")

    def __init__(self):
        self.event = threading.Event()
        self.index = 0
        self.result = None

    def wait(self, timeout):
        if not self.event.wait(timeout):
            return None
        return self.index, self.result


class _Item:
    __slots__ = ("seq", "index", "client_id", "req_no", "data", "last")

    def __init__(self, seq, index, client_id, req_no, data, last):
        self.seq = seq
        self.index = index
        self.client_id = client_id
        self.req_no = req_no
        self.data = data
        self.last = last


_STOP = object()


def _committed_at(client, req_no: int) -> bool:
    """Whether a checkpoint's ``NetworkClient`` state holds ``req_no``
    committed: below its low watermark, or set in its committed mask."""
    return req_no < client.low_watermark or bit_is_set(
        client.committed_mask, req_no - client.low_watermark
    )


class CommitStream(Log):
    def __init__(
        self,
        app,
        *,
        node_id: int = 0,
        state_path: str | None = None,
        queue_depth: int = 256,
        data_source=None,
        chain_source=None,
    ):
        self.app = app
        self.node_id = node_id
        self.state_path = state_path
        self.data_source = data_source  # callable(RequestAck) -> bytes|None
        self.chain_source = chain_source  # callable() -> journal chain
        self.queue_depth = queue_depth
        self._queue = BoundedQueue("app.apply", maxsize=queue_depth)
        self._cv = threading.Condition()
        # App-thread frontier: the exactly-once floor.
        self.applied_seq = 0
        self.applied_index = 0
        # Commit-thread frontier: ops accepted from consensus (the
        # read-index barrier target for committed reads).
        self.enqueued_seq = 0
        self.enqueued_index = 0
        self.installs = 0
        self.snapshots_taken = 0
        self._waiters: dict = {}  # (client_id, req_no) -> _Waiter
        self._snapshots: OrderedDict = OrderedDict()  # value -> blob
        self.last_snapshot_blob: bytes | None = None
        self._stopped = False
        if state_path is not None:
            blob = storage.read_app_state(state_path)
            if blob is not None:
                self._adopt_blob(blob)
        self._thread = threading.Thread(
            target=self._run, name=f"app-stream-{node_id}", daemon=True
        )
        self._thread.start()

    # -- restart / install ------------------------------------------------

    def _adopt_blob(self, blob: bytes) -> None:
        decoded = decode_state(blob)
        if decoded is None:
            raise ValueError("corrupt app-state blob")
        applied_seq, applied_index, _chain, app_blob = decoded
        self.app.restore(app_blob)
        with self._cv:
            self.applied_seq = applied_seq
            self.applied_index = applied_index
            self.enqueued_seq = applied_seq
            self.enqueued_index = applied_index
            self._cv.notify_all()
        self.last_snapshot_blob = blob
        self._snapshots[state_binding(blob)] = blob

    def replay(self, entries) -> None:
        """Re-apply journaled ops above the persisted snapshot floor —
        ``entries`` as from ``DurableChainLog.drain_replay``: the restart
        path's bridge between the last checkpoint and the crash point."""
        for seq, ops in entries:
            if seq <= self.enqueued_seq:
                continue
            self._enqueue(seq, [(cid, rno, data) for cid, rno, _dig, data in ops])

    def install(self, app_bytes: bytes, value: bytes, seq_no: int) -> bool:
        """Snapshot-install fast-forward (state transfer): verify the blob
        binds to the certified checkpoint value, then jump the applied
        index/seq to the snapshot — the skipped range is never applied."""
        if state_binding(app_bytes) != value:
            return False
        decoded = decode_state(app_bytes)
        if decoded is None:
            return False
        self.drain()
        self._adopt_blob(app_bytes)
        if self.state_path is not None:
            storage.write_app_state(self.state_path, app_bytes)
        self.installs += 1
        self._gauge()
        return True

    def answer_installed(self, network_state, seq_no: int) -> int:
        """After a snapshot install at ``seq_no``: answer every write
        waiter whose request the installed checkpoint's client states
        show committed.  Its op was applied inside the snapshot, so no
        result for it was ever computed here; the waiter gets
        ``{"installed_seq": seq_no}`` at index 0 and the frontend answers
        from its own record of the op.  (The JAX package leaves such a
        waiter to time out.)  Returns how many it answered."""
        clients = {c.id: c for c in network_state.clients}
        answered = []
        with self._cv:
            for key in list(self._waiters):
                client = clients.get(key[0])
                if client is not None and _committed_at(client, key[1]):
                    answered.append(self._waiters.pop(key))
        for waiter in answered:
            waiter.index = 0
            waiter.result = {"installed_seq": seq_no}
            waiter.event.set()
        return len(answered)

    @staticmethod
    def chain_of(app_bytes: bytes) -> bytes | None:
        """The journal chain bound inside an app-state blob (the worker
        adopts it into the durable journal on install)."""
        decoded = decode_state(app_bytes)
        return None if decoded is None else decoded[2]

    # -- Log contract ------------------------------------------------------

    def apply(self, q_entry) -> None:
        if q_entry.seq_no <= self.enqueued_seq:
            return  # WAL replay of an already-delivered entry
        ops = []
        for ack in q_entry.requests:
            data = self.data_source(ack) if self.data_source is not None else b""
            ops.append((ack.client_id, ack.req_no, data or b""))
        self._enqueue(q_entry.seq_no, ops)

    def _enqueue(self, seq: int, ops) -> None:
        if not ops:
            # Empty batch: advance the seq frontier with a marker op.
            self._queue.put(_Item(seq, 0, None, None, b"", True))
        else:
            for pos, (client_id, req_no, data) in enumerate(ops):
                self.enqueued_index += 1
                item = _Item(
                    seq,
                    self.enqueued_index,
                    client_id,
                    req_no,
                    data,
                    pos == len(ops) - 1,
                )
                self._queue.put(item)  # blocks when full: backpressure
        self.enqueued_seq = seq

    def snap(self, network_config, clients_state) -> bytes:
        self.drain()
        chain = self.chain_source() if self.chain_source is not None else b""
        blob = encode_state(
            self.applied_seq, self.applied_index, chain, self.app.snapshot()
        )
        value = state_binding(blob)
        if self.state_path is not None:
            storage.write_app_state(self.state_path, blob)
        self.last_snapshot_blob = blob
        self._snapshots[value] = blob
        while len(self._snapshots) > _KEPT_SNAPSHOTS:
            self._snapshots.popitem(last=False)
        self.snapshots_taken += 1
        self._gauge()
        return value

    def snapshot_blob(self, value: bytes) -> bytes | None:
        """The blob whose binding is ``value`` (for note_checkpoint)."""
        return self._snapshots.get(value)

    def adopt(self, value: bytes, seq_no: int) -> None:
        """Direct chain adoption is the legacy chain-log path; a KV-mode
        install goes through ``install`` with the full blob instead."""
        raise NotImplementedError(
            "CommitStream state transfer goes through install()"
        )

    # -- app thread --------------------------------------------------------

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is _STOP:
                return
            result = None
            if item.client_id is not None:
                result = self.app.apply(
                    item.client_id, item.req_no, item.seq, item.index, item.data
                )
            with self._cv:
                if item.client_id is not None:
                    self.applied_index = item.index
                    waiter = self._waiters.pop(
                        (item.client_id, item.req_no), None
                    )
                else:
                    waiter = None
                if item.last:
                    self.applied_seq = item.seq
                self._cv.notify_all()
            if waiter is not None:
                waiter.index = item.index
                waiter.result = result
                waiter.event.set()
            if item.last:
                self._gauge()

    def _gauge(self) -> None:
        if hooks.enabled:
            hooks.metrics.gauge("mirbft_app_applied_index").set(
                self.applied_index
            )

    # -- waiters and the read-index barrier --------------------------------

    def register_waiter(self, client_id: int, req_no: int) -> _Waiter:
        """Register *before* proposing: resolved when (client_id, req_no)
        applies.  A duplicate of an already-applied op never resolves —
        callers time out and read back instead."""
        waiter = _Waiter()
        with self._cv:
            self._waiters[(client_id, req_no)] = waiter
        return waiter

    def cancel_waiter(self, client_id: int, req_no: int) -> None:
        with self._cv:
            self._waiters.pop((client_id, req_no), None)

    def frontier(self) -> int:
        """The committed frontier: ops delivered from consensus so far.
        A committed read's barrier target — covering the read's issue
        point means every op committed before the read was issued (as
        seen by this replica) has been applied."""
        return self.enqueued_index

    def read_barrier(self, min_index: int = 0, timeout: float | None = 5.0):
        """Block until the applied index covers max(frontier-at-issue,
        ``min_index``) — the PBFT §4.1 read optimization's local wait.
        -> (ok, waited_seconds, applied_index)."""
        start = time.monotonic()
        with self._cv:
            target = max(self.enqueued_index, min_index)
            ok = self._cv.wait_for(
                lambda: self.applied_index >= target or self._stopped,
                timeout=timeout,
            )
            applied = self.applied_index
        waited = time.monotonic() - start
        if hooks.enabled:
            hooks.metrics.histogram(
                "mirbft_app_read_barrier_wait_seconds"
            ).observe(waited)
        return ok and applied >= target, waited, applied

    def drain(self, timeout: float | None = 30.0) -> bool:
        """Wait until the app thread has absorbed everything enqueued."""
        with self._cv:
            return self._cv.wait_for(
                lambda: (
                    self.applied_index >= self.enqueued_index
                    and self.applied_seq >= self.enqueued_seq
                )
                or self._stopped,
                timeout=timeout,
            )

    # -- status / lifecycle ------------------------------------------------

    def status(self) -> dict:
        with self._cv:
            return {
                "applied_seq": self.applied_seq,
                "applied_index": self.applied_index,
                "enqueued_seq": self.enqueued_seq,
                "enqueued_index": self.enqueued_index,
                "queue_len": self._queue.qsize(),
                "queue_depth": self.queue_depth,
                "waiters": len(self._waiters),
                "installs": self.installs,
                "snapshots": self.snapshots_taken,
            }

    def close(self) -> None:
        with self._cv:
            if self._stopped:
                return
            self._stopped = True
            self._cv.notify_all()
        self._queue.put(_STOP)
        self._thread.join(timeout=5.0)


class AppLog(Log):
    """The worker's Log in app mode: the durable journal (chaos ground
    truth, local replay source) composed with the commit stream.  On
    construction, journaled ops above the stream's persisted snapshot
    floor are replayed into the state machine — the journal fsyncs every
    apply, the snapshot bounds how much of it must be re-run."""

    def __init__(self, journal, stream: CommitStream):
        self.journal = journal
        self.stream = stream
        stream.chain_source = lambda: journal.chain
        stream.replay(journal.drain_replay(stream.applied_seq))

    @property
    def chain(self) -> bytes:
        return self.journal.chain

    @property
    def commits(self) -> list:
        return self.journal.commits

    def apply(self, q_entry) -> None:
        self.journal.apply(q_entry)
        self.stream.apply(q_entry)

    def snap(self, network_config, clients_state) -> bytes:
        self.journal.snap(network_config, clients_state)
        return self.stream.snap(network_config, clients_state)

    def install(self, app_bytes: bytes, value: bytes, seq_no: int) -> bool:
        """State-transfer install: verify + adopt blob into the stream,
        then jump the journal chain to the chain bound inside it."""
        chain = CommitStream.chain_of(app_bytes)
        if chain is None or not self.stream.install(app_bytes, value, seq_no):
            return False
        self.journal.adopt(chain, seq_no)
        return True

    def close(self) -> None:
        self.stream.close()
        self.journal.close()

    def crash(self) -> None:
        self.stream.close()
        self.journal.crash()
