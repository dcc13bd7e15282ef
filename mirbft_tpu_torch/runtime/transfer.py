"""Checkpoint-anchored snapshot state transfer over the real transport.

The core's ``actions.state_transfer`` contract (commitstate.transfer_to)
says *what* to adopt — a 2f+1-certified ``(seq_no, value)`` checkpoint —
but not *how* to obtain it; until this module, harness embedders "served"
the transfer by reaching into a peer's in-memory state, which cannot work
across a real multi-process cluster.  This is the real subsystem:

- **Donor side.** Every replica keeps the last few checkpoint-anchored
  snapshots (``note_checkpoint``): the application log state, the
  network state, and the reqstore slice above the checkpoint, serialized
  into one deterministic blob.  A snapshot REQUEST streams the blob back
  as bounded, digest-chained CHUNK frames; a request for a snapshot the
  donor no longer holds (or holds under a different certificate value)
  is NACKed so the fetcher fails over immediately instead of timing out.

- **Fetcher side.** ``begin(target)`` starts (or resumes) a fetch; the
  embedder's consumer loop drives ``poll()``.  Donors are tried in a
  seeded rotation with per-chunk timeouts, jittered-backoff retry, and
  donor failover.  Chunks verify incrementally against a digest chain
  seeded from the certified ``(seq_no, value)`` — a frame corrupted in
  flight, truncated, or served for the wrong certificate breaks the
  chain and is rejected with evidence counters.  The reassembled blob
  must decode to the exact certified target (the 2f+1 checkpoint
  certificate is the adoption authority) before anything is installed.

- **Crash safety.** A verified blob is staged to disk atomically
  (storage.write_snapshot_file) *before* installation.  If the process
  dies mid-install, the core re-emits ``state_transfer`` on restart (the
  WAL holds a TEntry newer than any CEntry), the engine finds the staged
  blob for the same target, and completes locally without the network.

Wire format (docs/STATE_TRANSFER.md): frames travel under the
transport's reserved ``_XFER_SRC`` lane and are varint-framed:

    REQUEST = kind=1, seq_no, len(value), value, resume_index
    CHUNK   = kind=2, seq_no, index, total, digest[32], len(payload), payload
    NACK    = kind=3, seq_no

Chain rule: ``d_0 = sha256(domain || seq_no || len(value) || value)``,
``d_i = sha256(d_{i-1} || payload_i)``; chunk ``i`` carries ``d_{i+1}``
computed over its own payload, so the fetcher can verify each chunk on
arrival with no buffering beyond the blob itself.

Threading: ``on_frame`` runs on transport read threads and only mutates
engine state under the lock (donor-side chunk sends are enqueue-only);
``poll`` runs on the embedder's consumer thread and owns every callback
into the embedder/node, so installs never race the consensus loop.
"""

from __future__ import annotations

import hashlib
import os
import random
import threading
import time

from .. import pb, wire
from ..obsv import hooks
from ..resilience import Backoff
from .msgfilter import MalformedMessage, check_snapshot_chunk
from .storage import (
    read_snapshot_file,
    remove_snapshot_file,
    write_snapshot_file,
)

_DOMAIN = b"mirbft-snapshot-v1"
_DIGEST_LEN = 32

_KIND_REQUEST = 1
_KIND_CHUNK = 2
_KIND_NACK = 3

# Donor-side retention: snapshots for the newest N noted checkpoints.
# Three matches the protocol's three active checkpoint windows, plus one
# of slack for a fetcher racing a window slide.
_RETAIN_SNAPSHOTS = 4


def _counter(name: str, **labels) -> None:
    if hooks.enabled:
        hooks.metrics.counter(name, **labels).inc()


class Snapshot:
    """One decoded checkpoint-anchored snapshot."""

    __slots__ = ("seq_no", "value", "network_state", "app_bytes", "requests")

    def __init__(
        self,
        seq_no: int,
        value: bytes,
        network_state: pb.NetworkState,
        app_bytes: bytes,
        requests: list[tuple[pb.RequestAck, bytes]],
    ):
        self.seq_no = seq_no
        self.value = value
        self.network_state = network_state
        self.app_bytes = app_bytes
        self.requests = requests


# -- snapshot blob codec ------------------------------------------------------


def _put_bytes(parts: list, data: bytes) -> None:
    parts.append(wire.encode_varint(len(data)))
    parts.append(data)


def _take_bytes(blob: bytes, pos: int) -> tuple[bytes, int]:
    length, pos = wire.decode_varint(blob, pos)
    end = pos + length
    if end > len(blob):
        raise ValueError("snapshot field overruns blob")
    return blob[pos:end], end


def encode_snapshot(snap: Snapshot) -> bytes:
    parts: list = [wire.encode_varint(snap.seq_no)]
    _put_bytes(parts, snap.value)
    _put_bytes(parts, pb.encode(snap.network_state))
    _put_bytes(parts, snap.app_bytes)
    parts.append(wire.encode_varint(len(snap.requests)))
    for ack, data in snap.requests:
        _put_bytes(parts, pb.encode(ack))
        _put_bytes(parts, data or b"")
    return b"".join(parts)


def decode_snapshot(blob: bytes) -> Snapshot:
    """Decode a snapshot blob; raises ValueError on any malformation."""
    seq_no, pos = wire.decode_varint(blob, 0)
    value, pos = _take_bytes(blob, pos)
    ns_bytes, pos = _take_bytes(blob, pos)
    network_state = pb.decode(pb.NetworkState, ns_bytes)
    app_bytes, pos = _take_bytes(blob, pos)
    count, pos = wire.decode_varint(blob, pos)
    requests = []
    for _ in range(count):
        ack_bytes, pos = _take_bytes(blob, pos)
        data, pos = _take_bytes(blob, pos)
        requests.append((pb.decode(pb.RequestAck, ack_bytes), data))
    if pos != len(blob):
        raise ValueError("trailing bytes after snapshot")
    return Snapshot(seq_no, value, network_state, app_bytes, requests)


# -- chunk framing ------------------------------------------------------------


def chain_seed(seq_no: int, value: bytes) -> bytes:
    """Anchor the digest chain to the certified target: a snapshot served
    for any other (seq_no, value) fails verification at the first chunk."""
    h = hashlib.sha256()
    h.update(_DOMAIN)
    h.update(wire.encode_varint(seq_no))
    h.update(wire.encode_varint(len(value)))
    h.update(value)
    return h.digest()


def chain_next(prev: bytes, payload: bytes) -> bytes:
    return hashlib.sha256(prev + payload).digest()


def split_chunks(blob: bytes, chunk_bytes: int) -> list[bytes]:
    """Slice a blob into bounded chunk payloads (always at least one, so
    an empty blob still round-trips as a single empty chunk)."""
    if chunk_bytes < 1:
        raise ValueError("chunk_bytes must be >= 1")
    if not blob:
        return [b""]
    return [
        blob[i : i + chunk_bytes] for i in range(0, len(blob), chunk_bytes)
    ]


def encode_request(seq_no: int, value: bytes, resume_index: int) -> bytes:
    parts = [
        wire.encode_varint(_KIND_REQUEST),
        wire.encode_varint(seq_no),
    ]
    _put_bytes(parts, value)
    parts.append(wire.encode_varint(resume_index))
    return b"".join(parts)


def encode_chunk(
    seq_no: int, index: int, total: int, digest: bytes, payload: bytes
) -> bytes:
    parts = [
        wire.encode_varint(_KIND_CHUNK),
        wire.encode_varint(seq_no),
        wire.encode_varint(index),
        wire.encode_varint(total),
        digest,
    ]
    _put_bytes(parts, payload)
    return b"".join(parts)


def encode_nack(seq_no: int) -> bytes:
    return wire.encode_varint(_KIND_NACK) + wire.encode_varint(seq_no)


def decode_frame(body: bytes) -> tuple:
    """Decode one transfer frame into a tagged tuple; raises ValueError
    on malformation (the caller drops the frame, like the transport does
    for undecodable pb.Msg frames)."""
    kind, pos = wire.decode_varint(body, 0)
    if kind == _KIND_REQUEST:
        seq_no, pos = wire.decode_varint(body, pos)
        value, pos = _take_bytes(body, pos)
        resume, pos = wire.decode_varint(body, pos)
        return ("request", seq_no, value, resume)
    if kind == _KIND_CHUNK:
        seq_no, pos = wire.decode_varint(body, pos)
        index, pos = wire.decode_varint(body, pos)
        total, pos = wire.decode_varint(body, pos)
        if pos + _DIGEST_LEN > len(body):
            raise ValueError("chunk frame too short for digest")
        digest = body[pos : pos + _DIGEST_LEN]
        payload, _pos = _take_bytes(body, pos + _DIGEST_LEN)
        return ("chunk", seq_no, index, total, digest, payload)
    if kind == _KIND_NACK:
        seq_no, _pos = wire.decode_varint(body, pos)
        return ("nack", seq_no)
    raise ValueError(f"unknown transfer frame kind {kind}")


# -- the engine ---------------------------------------------------------------

_COUNTER_KEYS = (
    "snapshots_noted",
    "snapshots_served",
    "snapshots_nacked",
    "snapshots_installed",
    "snapshots_resumed_staged",
    "snapshots_failed",
    "chunks_served",
    "chunks_received",
    "chunk_bytes_received",
    "chunks_rejected_corrupt",
    "chunks_rejected_oversized",
    "chunks_stale",
    "request_timeouts",
    "donor_failovers",
    "retries",
)


class TransferEngine:
    """Donor and fetcher for checkpoint-anchored snapshots.

    ``duct`` abstracts the frame path: ``duct.send(dest, body)`` must be
    non-blocking fire-and-forget (TcpTransport.send_transfer, or a direct
    in-process call in tests/loadgen).  Inbound frames are fed to
    ``on_frame(sender_id, body)``.

    Embedder callbacks (all invoked from the ``poll()`` thread):

    - ``install(snapshot) -> pb.NetworkState | None``: apply the app
      state and reqstore slice; return the network state to adopt, or
      None to veto (counts as a failed verification).
    - ``complete(target, network_state)``: forward to
      ``Node.state_transfer_complete``.
    - ``failed(target)``: forward to ``Node.state_transfer_failed`` —
      the core re-emits ``state_transfer`` and the embedder calls
      ``begin`` again, so giving up here is a retry, not a dead end.
    """

    def __init__(
        self,
        node_id: int,
        duct,
        *,
        staging_dir: str,
        peers=(),
        limits=None,
        install=None,
        complete=None,
        failed=None,
        chunk_timeout_s: float = 2.0,
        attempts_per_donor: int = 2,
        donor_rounds: int = 2,
        clock=time.monotonic,
        seed: int = 0,
    ):
        self.node_id = node_id
        self.duct = duct
        self.limits = limits
        self.install = install
        self.complete = complete
        self.failed = failed
        self.chunk_timeout_s = chunk_timeout_s
        self.attempts_per_donor = attempts_per_donor
        self.donor_rounds = donor_rounds
        self.clock = clock
        # staging_dir None = memory-only embedder (loadgen): no staged
        # blob, so crash-resume degrades to a plain re-fetch.
        self.staging_path = (
            os.path.join(staging_dir, "snapshot.staged")
            if staging_dir is not None
            else None
        )
        self._rng = random.Random(seed ^ (node_id << 16))
        self._backoff = Backoff(
            base=0.05, cap=max(chunk_timeout_s, 0.05), rng=self._rng
        )

        self._lock = threading.Lock()
        self._peers = [p for p in peers if p != node_id]  # guarded-by: _lock
        # Donor cache: seq_no -> (value, blob).  guarded-by: _lock
        self._snapshots: dict[int, tuple[bytes, bytes]] = {}
        # Fetcher state.  guarded-by: _lock
        self._phase = "idle"  # idle | init | fetching | waiting | ready
        self._target = None  # StateTarget-like (seq_no, value)
        self._donors: list[int] = []
        self._donor_idx = 0
        self._attempts = 0
        self._rounds = 0
        self._chunks: list[bytes] = []
        self._chain = b""
        self._total: int | None = None
        self._deadline = 0.0
        self._wait_until = 0.0
        # Outgoing fetch requests queued under the lock, sent after it is
        # released (_flush_outgoing).  Sending through the duct while
        # holding the lock self-deadlocks under a synchronous duct (the
        # loadgen's in-process duct delivers the donor's chunk response
        # re-entrantly on the same thread, which re-enters _on_chunk and
        # blocks on the non-reentrant lock) — and even over sockets a
        # blocking send would stall every other engine entry point.
        self._outgoing: list[tuple[int, bytes]] = []  # guarded-by: _lock
        self.counters = {key: 0 for key in _COUNTER_KEYS}

    # -- donor side ----------------------------------------------------------

    def note_checkpoint(
        self,
        seq_no: int,
        value: bytes,
        network_state: pb.NetworkState,
        app_bytes: bytes,
        requests,
    ) -> None:
        """Record a locally stable checkpoint as a servable snapshot.
        Called by the embedder when it captures a CheckpointResult; keeps
        the newest ``_RETAIN_SNAPSHOTS`` anchors."""
        blob = encode_snapshot(
            Snapshot(seq_no, value, network_state, app_bytes, list(requests))
        )
        with self._lock:
            self._snapshots[seq_no] = (value, blob)
            for old in sorted(self._snapshots)[:-_RETAIN_SNAPSHOTS]:
                del self._snapshots[old]
            self.counters["snapshots_noted"] += 1

    def set_peers(self, peers) -> None:
        """Replace the donor candidate set (a joining cluster learns new
        members after boot).  Takes effect on the next fetch round."""
        with self._lock:
            self._peers = [p for p in peers if p != self.node_id]

    def _serve(self, seq_no: int, value: bytes, resume: int):
        """Build the response frames for a REQUEST (lock held); returns
        ``(frames, served)`` — the bodies to send after the lock is
        released, and whether this was a serve (vs a NACK)."""
        entry = self._snapshots.get(seq_no)
        if entry is None or entry[0] != value:
            self.counters["snapshots_nacked"] += 1
            return [encode_nack(seq_no)], False
        _value, blob = entry
        chunk_bytes = getattr(self.limits, "max_snapshot_chunk_bytes", 256 * 1024)
        payloads = split_chunks(blob, chunk_bytes)
        total = len(payloads)
        if resume >= total:
            resume = 0  # nonsense resume point: restart the stream
        digest = chain_seed(seq_no, value)
        frames = []
        for index, payload in enumerate(payloads):
            digest = chain_next(digest, payload)
            if index >= resume:
                frames.append(
                    encode_chunk(seq_no, index, total, digest, payload)
                )
        self.counters["snapshots_served"] += 1
        self.counters["chunks_served"] += len(frames)
        return frames, True

    # -- frame ingress (transport read threads) -------------------------------

    def on_frame(self, sender: int, body: bytes) -> None:
        try:
            frame = decode_frame(body)
        except ValueError:
            with self._lock:
                self.counters["chunks_rejected_corrupt"] += 1
            _counter(
                "mirbft_transfer_chunks_total", outcome="rejected_corrupt"
            )
            return
        if frame[0] == "request":
            _tag, seq_no, value, resume = frame
            with self._lock:
                responses, served = self._serve(seq_no, value, resume)
            for response in responses:
                self.duct.send(sender, response)
            _counter(
                "mirbft_transfer_snapshots_total",
                outcome="served" if served else "nacked",
            )
            return
        if frame[0] == "chunk":
            self._on_chunk(sender, *frame[1:])
            self._flush_outgoing()
            return
        # NACK: the donor cannot serve this target — fail over now.
        _tag, seq_no = frame
        with self._lock:
            if (
                self._phase in ("fetching", "waiting")
                and self._target is not None
                and self._target.seq_no == seq_no
                and self._current_donor() == sender
            ):
                self._rotate_donor_locked()
        self._flush_outgoing()

    def _on_chunk(
        self,
        sender: int,
        seq_no: int,
        index: int,
        total: int,
        digest: bytes,
        payload: bytes,
    ) -> None:
        with self._lock:
            target = self._target
            if (
                self._phase != "fetching"
                or target is None
                or target.seq_no != seq_no
                or self._current_donor() != sender
            ):
                self.counters["chunks_stale"] += 1
                _counter("mirbft_transfer_chunks_total", outcome="stale")
                return
            try:
                check_snapshot_chunk(len(payload), total, self.limits)
            except MalformedMessage as err:
                # Byzantine donor: bounded ingress rejected the frame.
                self.counters["chunks_rejected_oversized"] += 1
                _counter(
                    "mirbft_transfer_chunks_total",
                    outcome="rejected_oversized",
                )
                _counter(
                    "mirbft_byzantine_rejections_total", kind=err.kind
                )
                self._rotate_donor_locked()
                return
            if index != len(self._chunks) or (
                self._total is not None and total != self._total
            ):
                # Duplicate or out-of-order within one TCP stream means a
                # donor restart mid-serve (its rebuilt blob may differ):
                # drop the frame; the chunk timeout re-requests.
                self.counters["chunks_stale"] += 1
                _counter("mirbft_transfer_chunks_total", outcome="stale")
                return
            expected = chain_next(self._chain, payload)
            if digest != expected:
                # Corrupted/truncated/forged in flight: reject with
                # evidence and abandon this donor's stream.
                self.counters["chunks_rejected_corrupt"] += 1
                _counter(
                    "mirbft_transfer_chunks_total", outcome="rejected_corrupt"
                )
                _counter(
                    "mirbft_byzantine_rejections_total", kind="corrupt"
                )
                self._rotate_donor_locked()
                return
            self._chain = expected
            self._chunks.append(payload)
            self._total = total
            self._deadline = self.clock() + self.chunk_timeout_s
            self.counters["chunks_received"] += 1
            self.counters["chunk_bytes_received"] += len(payload)
            _counter("mirbft_transfer_chunks_total", outcome="received")
            if len(self._chunks) == total:
                self._phase = "ready"

    # -- fetcher side ---------------------------------------------------------

    def begin(self, target) -> None:
        """Start fetching ``target`` (an object with seq_no/value).
        Idempotent while a fetch for the same target is in flight; a new
        target preempts the old fetch."""
        with self._lock:
            if (
                self._target is not None
                and self._phase != "idle"
                and self._target.seq_no == target.seq_no
                and self._target.value == target.value
            ):
                return
            self._target = target
            self._phase = "init"
            self._reset_stream_locked()
            self._donors = sorted(self._peers)
            self._rng.shuffle(self._donors)
            self._donor_idx = 0
            self._rounds = 0
            self._backoff.reset()

    def transferring(self) -> bool:
        with self._lock:
            return self._phase != "idle"

    def poll(self) -> None:
        """Advance the fetch state machine; called from the embedder's
        consumer loop (and directly by deterministic tests).  All
        embedder callbacks happen here."""
        actions = []
        with self._lock:
            now = self.clock()
            if self._phase == "init":
                actions = self._poll_init_locked()
            elif self._phase == "fetching" and now > self._deadline:
                self.counters["request_timeouts"] += 1
                self._attempts += 1
                if self._attempts < self.attempts_per_donor:
                    self.counters["retries"] += 1
                    _counter(
                        "mirbft_transfer_snapshots_total", outcome="retry"
                    )
                    self._wait_until = now + self._backoff.next()
                    self._phase = "waiting"
                else:
                    self._rotate_donor_locked()
            elif self._phase == "waiting" and now >= self._wait_until:
                self._send_request_locked(resume=len(self._chunks))
            elif self._phase == "ready":
                actions = self._poll_ready_locked()
            elif self._phase == "failed":
                actions = [self._fail_locked()]
        self._flush_outgoing()
        for action in actions:
            action()

    def _poll_init_locked(self) -> list:  # holds: _lock
        target = self._target
        blob = (
            read_snapshot_file(self.staging_path)
            if self.staging_path is not None
            else None
        )
        if blob is not None:
            snap = self._verify_blob(blob, target)
            if snap is not None:
                self.counters["snapshots_resumed_staged"] += 1
                _counter(
                    "mirbft_transfer_snapshots_total",
                    outcome="resumed_staged",
                )
                return [lambda: self._install(snap, staged=True)]
            # Staged blob is for another target (or torn semantics can't
            # happen — the write is atomic): discard and fetch fresh.
            remove_snapshot_file(self.staging_path)
        if not self._donors:
            return [self._fail_locked()]
        self._send_request_locked(resume=0)
        return []

    def _poll_ready_locked(self) -> list:  # holds: _lock
        target = self._target
        blob = b"".join(self._chunks)
        snap = self._verify_blob(blob, target)
        if snap is None:
            # Chain-valid but semantically wrong (a byzantine donor can
            # chain arbitrary bytes to the right anchor): certificate
            # verification is the final authority.
            self.counters["chunks_rejected_corrupt"] += 1
            _counter(
                "mirbft_transfer_chunks_total", outcome="rejected_corrupt"
            )
            _counter("mirbft_byzantine_rejections_total", kind="corrupt")
            self._rotate_donor_locked()
            return []
        if self.staging_path is not None:
            write_snapshot_file(self.staging_path, blob)
        return [lambda: self._install(snap, staged=False)]

    def _verify_blob(self, blob: bytes, target) -> Snapshot | None:
        """The adoption rule: the blob must decode cleanly and carry
        exactly the 2f+1-certified (seq_no, value) of the target."""
        try:
            snap = decode_snapshot(blob)
        except ValueError:
            return None
        if target is None:
            return None
        if snap.seq_no != target.seq_no or snap.value != target.value:
            return None
        if snap.network_state is None:
            return None
        return snap

    def _install(self, snap: Snapshot, staged: bool) -> None:
        """Apply a verified snapshot (poll thread, lock released)."""
        with self._lock:
            target = self._target
        network_state = (
            self.install(snap) if self.install else snap.network_state
        )
        if network_state is None:
            # Embedder veto: the blob passed certificate checks but the
            # application refused it.  A staged blob is now poisoned —
            # discard it and fetch fresh; a freshly fetched one means
            # the donor is bad — fail over.
            self._discard_staged()
            with self._lock:
                if staged:
                    if self._donors:
                        self._send_request_locked(resume=0)
                    else:
                        self._phase = "failed"
                else:
                    self._rotate_donor_locked()
            self._flush_outgoing()
            return
        with self._lock:
            self._phase = "idle"
            self.counters["snapshots_installed"] += 1
        _counter("mirbft_transfer_snapshots_total", outcome="installed")
        if self.complete is not None:
            self.complete(target, network_state)
        self._discard_staged()

    def _discard_staged(self) -> None:
        if self.staging_path is not None:
            remove_snapshot_file(self.staging_path)

    # -- fetch-state helpers (lock held) --------------------------------------

    def _current_donor(self) -> int | None:
        if not self._donors:
            return None
        return self._donors[self._donor_idx % len(self._donors)]

    def _reset_stream_locked(self) -> None:
        self._chunks = []
        self._total = None
        target = self._target
        self._chain = (
            chain_seed(target.seq_no, target.value) if target else b""
        )

    def _send_request_locked(self, resume: int) -> None:  # holds: _lock
        donor = self._current_donor()
        target = self._target
        self._phase = "fetching"
        self._deadline = self.clock() + self.chunk_timeout_s
        if resume == 0:
            self._reset_stream_locked()
        # Queue, don't send: the caller flushes after releasing the lock.
        self._outgoing.append(
            (donor, encode_request(target.seq_no, target.value, resume))
        )

    def _flush_outgoing(self) -> None:
        """Send queued fetch requests with the lock released (see the
        _outgoing comment in __init__)."""
        while True:
            with self._lock:
                if not self._outgoing:
                    return
                donor, frame = self._outgoing.pop(0)
            self.duct.send(donor, frame)

    def _rotate_donor_locked(self) -> None:  # holds: _lock
        """Abandon the current donor's stream and move to the next; after
        ``donor_rounds`` full cycles, report failure to the core (which
        re-emits state_transfer, restarting the whole fetch)."""
        self._attempts = 0
        self._backoff.reset()
        self._donor_idx += 1
        if not self._donors or self._donor_idx % len(self._donors) == 0:
            self._rounds += 1
            if not self._donors or self._rounds >= self.donor_rounds:
                # Every donor exhausted: hand the verdict to the next
                # poll() so the failure callback fires on the embedder's
                # consumer thread, like every other callback.
                self._phase = "failed"
                return
        self.counters["donor_failovers"] += 1
        _counter(
            "mirbft_transfer_snapshots_total", outcome="donor_failover"
        )
        self._send_request_locked(resume=0)

    def _fail_locked(self):
        target = self._target
        self._phase = "idle"
        self.counters["snapshots_failed"] += 1
        _counter("mirbft_transfer_snapshots_total", outcome="failed")

        def fire():
            if self.failed is not None:
                self.failed(target)

        return fire

    # -- introspection --------------------------------------------------------

    def status(self) -> dict:
        """Snapshot for status.py's transfer section."""
        with self._lock:
            target = self._target
            return {
                "phase": self._phase,
                "target_seq_no": target.seq_no if target else None,
                "donor": self._current_donor()
                if self._phase in ("fetching", "waiting")
                else None,
                "chunks_received": len(self._chunks),
                "total_chunks": self._total,
                "cached_snapshots": sorted(self._snapshots),
                "counters": dict(self.counters),
            }
