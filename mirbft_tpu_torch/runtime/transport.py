"""TCP transport: the Link contract over real sockets (the DCN path).

The reference deliberately ships no transport — the entire contract is
``Link.Send(dest, msg)``, fire-and-forget and unreliable-by-assumption
(reference: processor.go:23-25); the protocol tolerates loss via
retransmit ticks.  This module is the consumer-side implementation for
multi-host deployments: length-prefixed frames of the deterministic wire
codec over persistent TCP connections between replica hosts.

Fault model (the hardening layer over the bare Link contract):

- ``send`` never blocks the caller: frames enqueue onto a bounded
  per-peer outbound queue drained by a dedicated sender thread, so one
  stalled peer cannot block broadcast to the others.
- The sender thread (re)connects lazily and retries failed connections
  with exponential backoff + full jitter (resilience.Backoff), so a
  restarted peer is re-dialed automatically and a recovering peer is not
  met with a connection storm from the whole mesh.
- Queue overflow drops the *oldest* frame (newest protocol messages
  supersede older ones); every drop, failure, and reconnect is counted
  and surfaced via ``counters()`` / ``status.transport_status`` so chaos
  runs can assert on observed fault counts.
- ``close(drain_timeout=...)`` optionally flushes queued frames over
  live connections before tearing down, and shuts the write side down
  first so peers observe a clean EOF rather than a reset.

Authentication note: the reference makes source authentication the
caller's job (mirbft.go:297-301).  Frames carry a claimed source id; a
production deployment wraps the sockets in mutually-authenticated TLS and
checks the claim against the peer certificate.  In-process and test use
trust the header, exactly like the reference's test transports.

Frame format: [u32 little-endian total length][varint source][pb.Msg].

Clock-sync hello: the first frame on every freshly dialed connection is
a hello — the reserved source id ``_HELLO_SRC`` followed by the dialer's
node id and its ``perf_counter_ns`` monotonic anchor.  The receiver
records ``local_anchor - remote_anchor`` per peer (``clock_offsets()``),
which obsv/merge.py uses to align per-node trace timelines.  The
estimate absorbs the hello's one-way network latency; on a single host
CLOCK_MONOTONIC is system-wide so it is exact up to that latency.  Old
frames are unaffected: a hello is just a frame whose source id no real
node can carry.
"""

from __future__ import annotations

import collections
import random
import select
import socket
import struct
import threading
import time

from .. import pb, wire
from ..obsv import hooks
from ..obsv.bqueue import QueueTelemetry
from ..resilience import Backoff
from .processor import Link

_LEN = struct.Struct("<I")
_LEN_PLACEHOLDER = bytes(_LEN.size)
_MAX_FRAME = 64 * 1024 * 1024

# Sender-side coalescing: one wakeup drains up to this many payload bytes
# from the peer queue into a single sendall.  Bounds the transient buffer
# a deep queue can force while still amortizing syscalls over bursts.
_COALESCE_BYTES = 512 * 1024

# Count buckets for mirbft_transport_frames_per_write (frames, not
# seconds — powers of two up to the 1024-frame queue depth).
_FRAMES_PER_WRITE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


def _set_nodelay(conn: socket.socket) -> None:
    """Disable Nagle: consensus frames are latency-critical and the
    sender already coalesces bursts explicitly, so the kernel delaying
    small writes only adds round-trip stalls.  Applied to both dialed and
    accepted sockets — Nagle is per-direction, so one side is not enough."""
    try:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass  # non-TCP or platform oddity: coalescing still works

# Reserved frame source id marking a clock-sync hello.  Real node ids are
# small integers assigned by NetworkConfig; 2**62 keeps the varint within
# the codec's 64-bit bound while staying unmistakably out of range.
_HELLO_SRC = 1 << 62

# Reserved frame source id marking a client proposal: the payload after
# the id is a bare pb.Request (not a pb.Msg), delivered to node.propose.
# This keeps every socket a client endpoint needs inside this module —
# loadgen and the cluster supervisor submit through a TcpTransport
# instead of opening raw sockets of their own (lint rule W9).
_PROPOSE_SRC = (1 << 62) + 1

# Reserved frame source id marking a state-transfer frame: the payload
# after the id is an opaque transfer body (runtime/transfer.py codec, not
# a pb.Msg), delivered to the sink installed via set_transfer_sink.
# Snapshot chunks ride the same sockets and per-peer queues as protocol
# traffic, so partitions/latency/adversary seams apply to them for free.
_XFER_SRC = (1 << 62) + 2


class LinkLatency:
    """Emulated one-way link latency: frames to the peer are held on the
    sender queue until ``delay + U(0, jitter)`` has elapsed since enqueue.
    Deterministic per (seed, peer): chaos/bench runs with the same seed
    see the same jitter sequence.  Emulation happens before the real
    socket write, so it composes with (and adds to) genuine network
    latency — loopback clusters gain a WAN rung without root or ``tc``."""

    __slots__ = ("delay_s", "jitter_s", "_rng")

    def __init__(self, delay_s: float, jitter_s: float = 0.0, seed: int = 0):
        if delay_s < 0 or jitter_s < 0:
            raise ValueError("latency delay/jitter must be >= 0")
        self.delay_s = delay_s
        self.jitter_s = jitter_s
        self._rng = random.Random(seed)

    def due(self, now: float) -> float:
        if self.jitter_s:
            return now + self.delay_s + self._rng.random() * self.jitter_s
        return now + self.delay_s


def _hello_frame(node_id: int, link_auth=None, peer_id: int = -1) -> bytes:
    payload = (
        wire.encode_varint(_HELLO_SRC)
        + wire.encode_varint(node_id)
        + wire.encode_varint(time.perf_counter_ns())
    )
    if link_auth is not None:
        payload = link_auth.seal(peer_id, payload)
    return _LEN.pack(len(payload)) + payload


def _frame_outcome(outcome: str, n: int = 1) -> None:
    """Mirror the per-channel counters into the metrics registry (the
    channel attributes remain the source of truth for counters())."""
    if hooks.enabled:
        hooks.metrics.counter(
            "mirbft_transport_frames_total", outcome=outcome
        ).inc(n)


def _dial_outcome(outcome: str) -> None:
    if hooks.enabled:
        hooks.metrics.counter(
            "mirbft_transport_reconnects_total", outcome=outcome
        ).inc()


class TransportFault:
    """Fault-injection seam consulted on the transport's hot paths.

    Chaos drivers (chaos/live.py) subclass this and assign an instance to
    ``TcpTransport.fault``; production leaves the attribute ``None`` so
    the seam costs one attribute read per send/dial.  Both hooks run on
    transport-internal threads and must not block.
    """

    def on_dial(self, peer_id: int) -> bool:
        """Return False to fail this dial attempt (counted as a
        ``faulted`` reconnect outcome; the normal backoff applies)."""
        return True

    def on_send(self, peer_id: int, frame: bytes) -> bool:
        """Return False to drop this frame before it is enqueued
        (counted as a ``dropped_fault`` frame outcome)."""
        return True


class _PeerChannel:
    """Outbound lane to one peer: a bounded frame queue plus the sender
    thread that owns connecting, retrying, and draining it."""

    def __init__(self, transport: "TcpTransport", peer_id: int):  # holds: _lock
        self.transport = transport
        self.peer_id = peer_id
        # Without latency emulation the deque holds bare frames; with a
        # LinkLatency installed it holds (due_monotonic, frame) pairs and
        # the sender drains only frames whose due time has passed.
        self.queue: collections.deque = collections.deque()  # guarded-by: cv
        self.latency: LinkLatency | None = transport._link_latency.get(
            peer_id
        )  # guarded-by: cv
        self.cv = threading.Condition()
        self.closed = False  # guarded-by: cv
        self._drain_deadline = 0.0  # guarded-by: cv
        self.backoff = Backoff(
            base=transport.backoff_base, cap=transport.backoff_cap
        )
        # Backpressure telemetry (obsv/bqueue.py): the deque cannot be
        # swapped for a BoundedQueue (latency pairs + drop-oldest +
        # coalesced drain under one cv), so the channel drives the
        # QueueTelemetry handle at its own put/drain points.  Wait is
        # head-of-line age: the stamp of the oldest queued frame,
        # observed when a drain finally picks the head up.
        self.telemetry = QueueTelemetry(f"transport.peer{peer_id}")
        self._head_enqueued_at = 0.0  # guarded-by: cv
        # Drop/retry accounting (read via TcpTransport.counters()).
        self.enqueued = 0  # guarded-by: cv
        self.sent = 0  # guarded-by: cv
        self.dropped_overflow = 0  # guarded-by: cv
        self.dropped_closed = 0  # guarded-by: cv
        self.send_failures = 0  # guarded-by: cv
        self.connect_failures = 0  # guarded-by: cv
        self.connects = 0  # guarded-by: cv
        self.thread = threading.Thread(
            target=self._run,
            name=f"tcp-send-{transport.node_id}-{peer_id}",
            daemon=True,
        )
        self.thread.start()

    def enqueue(self, frame: bytes) -> None:
        with self.cv:
            if self.closed:
                self.dropped_closed += 1
                _frame_outcome("dropped_closed")
                return
            if len(self.queue) >= self.transport.queue_depth:
                self.queue.popleft()
                self.dropped_overflow += 1
                _frame_outcome("dropped_overflow")
                self.telemetry.saturated()
            lat = self.latency
            if lat is None:
                self.queue.append(frame)
            else:
                self.queue.append((lat.due(time.monotonic()), frame))
            self.enqueued += 1
            _frame_outcome("enqueued")
            if hooks.enabled:
                if len(self.queue) == 1:
                    self._head_enqueued_at = time.perf_counter()
                self.telemetry.depth(len(self.queue))
            self.cv.notify()

    def close(self, drain_timeout: float) -> None:
        with self.cv:
            self.closed = True
            self._drain_deadline = time.monotonic() + drain_timeout
            self.cv.notify()

    # -- sender thread -------------------------------------------------------

    def _run(self) -> None:
        frames: list[bytes] = []
        while True:
            with self.cv:
                while not self.queue and not self.closed:
                    self.cv.wait()
                if self.closed and (
                    not self.queue
                    or time.monotonic() >= self._drain_deadline
                ):
                    self.dropped_closed += len(self.queue)
                    _frame_outcome("dropped_closed", len(self.queue))
                    self.queue.clear()
                    return
                lat = self.latency
                if lat is not None and not self.closed:
                    # Emulated link latency: hold the head frame until its
                    # due time (closing drains immediately — teardown must
                    # not wait out a WAN profile).
                    wait = self.queue[0][0] - time.monotonic()
                    if wait > 0:
                        self.cv.wait(timeout=wait)
                        continue
                # Coalesce: drain the burst (up to a byte budget) so many
                # queued frames cost one sendall instead of one syscall
                # each.  Frames left past the budget go on the next wakeup.
                frames.clear()
                budget = _COALESCE_BYTES
                if lat is None:
                    while self.queue and budget > 0:
                        frame = self.queue.popleft()
                        frames.append(frame)
                        budget -= len(frame)
                else:
                    now = time.monotonic()
                    while self.queue and budget > 0 and (
                        self.closed or self.queue[0][0] <= now
                    ):
                        frame = self.queue.popleft()[1]
                        frames.append(frame)
                        budget -= len(frame)
                    if not frames:
                        continue  # head not due yet (raced with enqueue)
                if hooks.enabled and frames:
                    now = time.perf_counter()
                    if self._head_enqueued_at:
                        self.telemetry.wait(
                            max(0.0, now - self._head_enqueued_at)
                        )
                    # Frames left past the coalesce budget become the
                    # new head; their age restarts at this drain.
                    self._head_enqueued_at = now if self.queue else 0.0
                    self.telemetry.depth(len(self.queue))
            entry = self._ensure_connected()
            if entry is None:
                # Shut down while connecting/backing off: the burst (and
                # the rest of the queue, handled above) is dropped.
                with self.cv:
                    self.dropped_closed += len(frames)
                    _frame_outcome("dropped_closed", len(frames))
                continue
            conn, send_lock = entry
            buf = frames[0] if len(frames) == 1 else b"".join(frames)
            try:
                # Peer-death probe before committing the whole burst to
                # one write: a FIN/RST already queued on the socket means
                # the write would "succeed" into a dead connection and a
                # coalesced burst would vanish in a single syscall (the
                # old frame-at-a-time loop got per-frame error probes for
                # free).  A zero-timeout readability check + MSG_PEEK is
                # cheap per burst and lets the burst requeue *unsent*.
                # (select, not MSG_DONTWAIT: the dialed socket is in
                # timeout mode, where a bare recv blocks in Python's
                # select loop regardless of recv flags.)
                readable, _, _ = select.select([conn], [], [], 0)
                if readable and conn.recv(1, socket.MSG_PEEK) == b"":
                    raise OSError("peer closed connection")
                with send_lock:
                    conn.sendall(buf)
            except OSError:
                with self.cv:
                    self.send_failures += 1
                _frame_outcome("send_failure")
                self._drop_conn(entry)
                # Put the burst back at the head, oldest first, so
                # delivery resumes in order after reconnect; whatever
                # would overflow is dropped from the burst's tail.
                with self.cv:
                    space = self.transport.queue_depth - len(self.queue)
                    keep = frames[: max(space, 0)]
                    for frame in reversed(keep):
                        # Already-due placeholder on latency links: the
                        # emulated delay was served before the first try.
                        self.queue.appendleft(
                            frame if self.latency is None else (0.0, frame)
                        )
                    dropped = len(frames) - len(keep)
                    if dropped:
                        self.dropped_overflow += dropped
                        _frame_outcome("dropped_overflow", dropped)
                continue
            with self.cv:
                self.sent += len(frames)
                _frame_outcome("sent", len(frames))
            if hooks.enabled:
                hooks.metrics.histogram(
                    "mirbft_transport_frames_per_write",
                    buckets=_FRAMES_PER_WRITE_BUCKETS,
                ).observe(len(frames))

    def _ensure_connected(self):
        """Return the live (socket, lock) entry for this peer, dialing with
        backoff until connected or the channel/transport closes."""
        transport = self.transport
        while True:
            with transport._lock:
                entry = transport._conns.get(self.peer_id)
                address = transport._peers.get(self.peer_id)
            if entry is not None:
                return entry
            with self.cv:
                chan_closed = self.closed
            closing = transport._closed.is_set() or chan_closed
            if closing or address is None:
                # No new connections once closing; draining only flushes
                # over connections that already exist.
                return None
            fault = transport.fault
            if fault is not None and not fault.on_dial(self.peer_id):
                _dial_outcome("faulted")
                delay = self.backoff.next()
                with self.cv:
                    self.connect_failures += 1
                    if not self.closed:
                        self.cv.wait(timeout=delay)
                continue
            try:
                conn = socket.create_connection(
                    address, timeout=transport.dial_timeout
                )
            except TimeoutError:
                # Dial deadline: a peer that accepts SYNs but never
                # completes (or a black-holing firewall) cannot pin the
                # sender thread longer than dial_timeout per attempt.
                _dial_outcome("timeout")
                delay = self.backoff.next()
                with self.cv:
                    self.connect_failures += 1
                    if not self.closed:
                        self.cv.wait(timeout=delay)
                continue
            except OSError:
                _dial_outcome("failed")
                delay = self.backoff.next()
                with self.cv:
                    self.connect_failures += 1
                    if not self.closed:
                        self.cv.wait(timeout=delay)
                continue
            self.backoff.reset()
            _set_nodelay(conn)
            entry = (conn, threading.Lock())
            with transport._lock:
                if transport._closed.is_set():
                    conn.close()
                    return None
                existing = transport._conns.setdefault(self.peer_id, entry)
            if existing is not entry:
                conn.close()
                entry = existing
            else:
                with self.cv:
                    self.connects += 1
                _dial_outcome("connected")
                # First frame on a fresh connection: the clock-sync
                # hello (monotonic anchor for trace alignment).  Best
                # effort — a failed hello just means the sender loop
                # discovers the dead socket on the next frame.
                conn_, send_lock = entry
                try:
                    with send_lock:
                        conn_.sendall(
                            _hello_frame(
                                transport.node_id,
                                transport.link_auth,
                                self.peer_id,
                            )
                        )
                except OSError:
                    pass
            return entry

    def _drop_conn(self, entry) -> None:
        transport = self.transport
        with transport._lock:
            if transport._conns.get(self.peer_id) is entry:
                del transport._conns[self.peer_id]
        entry[0].close()


class TcpTransport:
    """One replica's endpoint: a listening socket delivering inbound
    messages to the local Node, and queue-backed outbound links with
    automatic reconnection."""

    def __init__(
        self,
        node_id: int,
        host: str = "127.0.0.1",
        port: int = 0,
        queue_depth: int = 1024,
        backoff_base: float = 0.05,
        backoff_cap: float = 2.0,
        dial_timeout: float = 5.0,
        link_auth=None,
    ):
        self.node_id = node_id
        # Per-link MAC authenticator (crypto/mac.LinkAuthenticator) for
        # the replica plane: node/hello/transfer frames carry a sealed
        # tag verified (and stripped) at ingress, keyed by the claimed
        # source.  The client propose lane is exempt — client requests
        # are authenticated by Ed25519 signatures, not link MACs (the
        # PBFT split: signatures for requests/certificates, MACs for
        # replica channels).  None disables authentication entirely.
        self.link_auth = link_auth
        # kind -> count of frames rejected at the MAC check; mirrored to
        # mirbft_mac_rejections_total (chaos evidence + dashboards).
        self.mac_rejections: dict[str, int] = {}  # guarded-by: _lock
        self.queue_depth = queue_depth
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.dial_timeout = dial_timeout
        # Fault-injection seam (TransportFault); None in production.
        self.fault: TransportFault | None = None
        # peer id -> LinkLatency for emulated WAN links (see
        # set_link_latency); empty in production.
        self._link_latency: dict[int, LinkLatency] = {}  # guarded-by: _lock
        # Frame-encoder scratch: per-thread bytearray (multiple processor
        # stage threads may send concurrently) plus the precomputed source
        # id varint every outbound frame starts with.
        self._scratch = threading.local()
        self._src_prefix = wire.encode_varint(node_id)
        self._node = None
        # Inbound state-transfer frames (see set_transfer_sink); None
        # until a transfer engine attaches, and such frames drop.
        self._transfer_sink = None
        # Inbound client-lane override (see set_propose_sink); None
        # routes proposes straight to the node.
        self._propose_sink = None
        self._peers: dict[int, tuple] = {}  # guarded-by: _lock
        # id -> (socket, per-connection send lock).  The transport-wide
        # _lock guards only the maps; each peer's sends run on its own
        # sender thread so one stalled peer cannot block the others.
        self._conns: dict[int, tuple[socket.socket, threading.Lock]] = {}  # guarded-by: _lock
        self._channels: dict[int, _PeerChannel] = {}  # guarded-by: _lock
        # Sends to peers never registered via connect(): dropped, counted.
        self.dropped_unknown = 0  # guarded-by: _lock
        # Frames suppressed by the fault seam (chaos runs only).
        self.dropped_fault = 0  # guarded-by: _lock
        # peer id -> (local perf_counter_ns - peer perf_counter_ns),
        # estimated from the clock-sync hello on each inbound connection.
        self._clock_offsets: dict[int, int] = {}  # guarded-by: _lock
        # Accepted inbound sockets.  close() must shutdown+close these too:
        # leaving them open keeps their read threads blocked in recv, keeps
        # the port occupied past a rebind, and — worse — lets a "closed"
        # transport keep delivering frames to its sink.
        self._accepted: set[socket.socket] = set()  # guarded-by: _lock
        # Reader threads for accepted sockets, tracked so close() can join
        # them: a daemon thread parked in recv survives close() otherwise,
        # and 100 start/stop cycles then leak 100 threads.
        self._read_threads: set[threading.Thread] = set()  # guarded-by: _lock
        self._lock = threading.Lock()
        self._closed = threading.Event()

        self._server = socket.create_server((host, port))
        self.address = self._server.getsockname()
        self._accept_thread = threading.Thread(
            target=self._accept_loop,
            name=f"tcp-accept-{node_id}",
            daemon=True,
        )
        self._accept_thread.start()

    # -- wiring ----------------------------------------------------------------

    def serve(self, node) -> None:
        """Attach the local Node; inbound frames become node.step calls."""
        self._node = node

    def connect(self, peer_id: int, address: tuple) -> None:
        """Register a peer's address; connections are opened lazily on the
        first send and re-dialed with backoff after failures."""
        with self._lock:
            self._peers[peer_id] = tuple(address)

    def set_link_latency(
        self,
        peer_id: int,
        delay_s: float,
        jitter_s: float = 0.0,
        seed: int = 0,
    ) -> None:
        """Install emulated one-way latency on the outbound link to
        ``peer_id`` (``delay_s`` fixed + uniform jitter up to
        ``jitter_s``, deterministic per seed).  Takes effect for frames
        enqueued after the call; frames already queued keep whatever
        representation they were enqueued with, so set latency before
        traffic starts (the cluster runner configures links at boot)."""
        lat = LinkLatency(delay_s, jitter_s, seed=seed ^ (peer_id << 8))
        with self._lock:
            self._link_latency[peer_id] = lat
            channel = self._channels.get(peer_id)
        if channel is not None:
            with channel.cv:
                if channel.queue:
                    raise RuntimeError(
                        "set_link_latency on a link with queued frames"
                    )
                channel.latency = lat
                channel.cv.notify()

    # -- outbound --------------------------------------------------------------

    def link(self) -> Link:
        transport = self

        class _TcpLink(Link):
            def send(self, dest: int, msg: pb.Msg) -> None:
                transport._send(dest, msg)

        return _TcpLink()

    def _channel(self, dest: int) -> _PeerChannel | None:
        with self._lock:
            channel = self._channels.get(dest)
            if channel is not None:
                return channel
            if dest not in self._peers or self._closed.is_set():
                return None
            channel = _PeerChannel(self, dest)
            self._channels[dest] = channel
            return channel

    def _encode_frame(self, msg: pb.Msg) -> bytes:
        """Frame one message reusing a per-thread bytearray scratch: the
        naive ``_LEN.pack(len(p)) + p`` spelling allocates (and copies)
        two intermediate bytes objects per message; here the length
        placeholder is patched in place and only the final immutable
        ``bytes`` (required — frames outlive the call on peer queues) is
        allocated."""
        buf = getattr(self._scratch, "buf", None)
        if buf is None:
            buf = self._scratch.buf = bytearray()
        del buf[:]
        buf += _LEN_PLACEHOLDER
        buf += self._src_prefix
        buf += pb.encode(msg)
        _LEN.pack_into(buf, 0, len(buf) - _LEN.size)
        return bytes(buf)

    def _sealed_frame(self, dest: int, msg: pb.Msg) -> bytes:
        """MAC-authenticated framing: the tag covers source id + body and
        is keyed per destination link, so the scratch fast path (which is
        destination-independent) does not apply."""
        payload = self.link_auth.seal(
            dest, self._src_prefix + pb.encode(msg)
        )
        return _LEN.pack(len(payload)) + payload

    def _send(self, dest: int, msg: pb.Msg) -> None:
        if self.link_auth is not None:
            frame = self._sealed_frame(dest, msg)
        else:
            frame = self._encode_frame(msg)
        fault = self.fault
        if fault is not None and not fault.on_send(dest, frame):
            with self._lock:
                self.dropped_fault += 1
            _frame_outcome("dropped_fault")
            return  # injected loss: indistinguishable from the network's
        channel = self._channel(dest)
        if channel is None:
            with self._lock:
                self.dropped_unknown += 1
            _frame_outcome("dropped_unknown")
            return  # unknown peer: dropped, like any unreachable host
        channel.enqueue(frame)

    def propose(self, dest: int, request: pb.Request) -> None:
        """Client-side submission: frame a bare pb.Request under the
        reserved ``_PROPOSE_SRC`` id and enqueue it to ``dest`` (which
        must be ``connect``-ed first).  The receiving transport hands the
        request to its node's ``propose`` — the open-loop load generator
        and the cluster supervisor submit through this instead of opening
        sockets of their own.  Fire-and-forget like ``send``: duplicate
        submission on timeout is the client model, and the protocol's
        dedup absorbs it."""
        payload = (
            wire.encode_varint(_PROPOSE_SRC)
            + wire.encode_varint(self.node_id)
            + pb.encode(request)
        )
        frame = _LEN.pack(len(payload)) + payload
        channel = self._channel(dest)
        if channel is None:
            with self._lock:
                self.dropped_unknown += 1
            _frame_outcome("dropped_unknown")
            return
        channel.enqueue(frame)

    def send_transfer(self, dest: int, body: bytes) -> None:
        """State-transfer lane: frame an opaque transfer body (the
        runtime/transfer.py chunk codec) under the reserved ``_XFER_SRC``
        id and enqueue it to ``dest``.  The receiving transport hands
        ``(sender_id, body)`` to the sink installed via
        ``set_transfer_sink``.  Fire-and-forget like ``send``: the
        transfer engine owns timeouts, retry, and donor failover."""
        payload = (
            wire.encode_varint(_XFER_SRC)
            + wire.encode_varint(self.node_id)
            + body
        )
        if self.link_auth is not None:
            payload = self.link_auth.seal(dest, payload)
        frame = _LEN.pack(len(payload)) + payload
        fault = self.fault
        if fault is not None and not fault.on_send(dest, frame):
            with self._lock:
                self.dropped_fault += 1
            _frame_outcome("dropped_fault")
            return
        channel = self._channel(dest)
        if channel is None:
            with self._lock:
                self.dropped_unknown += 1
            _frame_outcome("dropped_unknown")
            return
        channel.enqueue(frame)

    def set_propose_sink(self, sink) -> None:
        """Route inbound client-lane requests through ``sink(request)``
        instead of ``node.propose`` — the speculative ingress verify
        stage installs itself here (runtime/ingress.py)."""
        self._propose_sink = sink

    def set_transfer_sink(self, sink) -> None:
        """Install the inbound state-transfer handler: ``sink(sender_id,
        body)`` is called on a transport read thread for every
        ``_XFER_SRC`` frame and must not block (the transfer engine
        queues the frame and returns)."""
        self._transfer_sink = sink

    def counters(self) -> dict:
        """Per-peer drop/retry accounting for dashboards and chaos gates
        (see status.transport_status for the dataclass view)."""
        with self._lock:
            channels = dict(self._channels)
            connected = set(self._conns)
            dropped_unknown = self.dropped_unknown
            dropped_fault = self.dropped_fault
            mac_rejections = dict(self.mac_rejections)
        peers = {}
        for peer_id, ch in channels.items():
            with ch.cv:
                peers[peer_id] = {
                    "connected": peer_id in connected,
                    "queue_depth": len(ch.queue),
                    "enqueued": ch.enqueued,
                    "sent": ch.sent,
                    "dropped_overflow": ch.dropped_overflow,
                    "dropped_closed": ch.dropped_closed,
                    "send_failures": ch.send_failures,
                    "connect_failures": ch.connect_failures,
                    "connects": ch.connects,
                }
        return {
            "dropped_unknown": dropped_unknown,
            "dropped_fault": dropped_fault,
            "mac_rejections": mac_rejections,
            "peers": peers,
        }

    # -- inbound ---------------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                conn, _addr = self._server.accept()
            except OSError:
                return  # closed
            _set_nodelay(conn)
            thread = threading.Thread(
                target=self._read_loop,
                args=(conn,),
                name=f"tcp-read-{self.node_id}",
                daemon=True,
            )
            with self._lock:
                if self._closed.is_set():
                    conn.close()
                    return
                self._accepted.add(conn)
                self._read_threads.add(thread)
            thread.start()

    def _read_loop(self, conn: socket.socket) -> None:
        try:
            while not self._closed.is_set():
                header = self._read_exact(conn, _LEN.size)
                if header is None:
                    return
                (length,) = _LEN.unpack(header)
                if length == 0 or length > _MAX_FRAME:
                    return  # corrupt stream: drop the connection
                payload = self._read_exact(conn, length)
                if payload is None:
                    return
                self._deliver(payload)
        finally:
            with self._lock:
                self._accepted.discard(conn)
                self._read_threads.discard(threading.current_thread())
            conn.close()

    @staticmethod
    def _read_exact(conn: socket.socket, n: int) -> bytes | None:
        buf = b""
        while len(buf) < n:
            try:
                chunk = conn.recv(n - len(buf))
            except OSError:
                return None
            if not chunk:
                return None
            buf += chunk
        return buf

    def clock_offsets(self) -> dict[int, int]:
        """Peer id -> estimated (local - peer) monotonic offset in ns,
        learned from clock-sync hellos.  Feed to
        ``Tracer.set_clock_sync`` so obsv/merge.py can align this node's
        trace with its peers'."""
        with self._lock:
            return dict(self._clock_offsets)

    def _mac_reject(self, kind: str) -> None:
        with self._lock:
            self.mac_rejections[kind] = self.mac_rejections.get(kind, 0) + 1
        if hooks.enabled:
            hooks.metrics.counter(
                "mirbft_mac_rejections_total", kind=kind
            ).inc()

    def _open_sealed(self, payload: bytes, source: int, offset: int):
        """MAC ingress check: verify + strip the per-link tag of a
        replica-plane frame (msgfilter.check_frame_mac).  Returns the
        verified payload, or None after counting the rejection."""
        if source in (_HELLO_SRC, _XFER_SRC):
            # Reserved lanes carry the sender id as the next varint; the
            # claimed id selects the link key, and a forged claim fails
            # the tag check like any other tamper.
            peer, _ = wire.decode_varint(payload, offset)
        else:
            peer = source
        from .msgfilter import check_frame_mac

        body, kind = check_frame_mac(self.link_auth, peer, payload)
        if body is None:
            self._mac_reject(kind)
            return None
        return body

    def _deliver(self, payload: bytes) -> None:
        if self._closed.is_set():
            return  # closed transport must never deliver
        try:
            source, offset = wire.decode_varint(payload, 0)
            if self.link_auth is not None and source != _PROPOSE_SRC:
                # Replica-plane frames must carry a valid link MAC; the
                # client propose lane is signature-authenticated instead.
                payload = self._open_sealed(payload, source, offset)
                if payload is None:
                    return
            if source == _HELLO_SRC:
                peer_id, offset = wire.decode_varint(payload, offset)
                remote_ns, _ = wire.decode_varint(payload, offset)
                with self._lock:
                    self._clock_offsets[peer_id] = (
                        time.perf_counter_ns() - remote_ns
                    )
                return
            if source == _XFER_SRC:
                sender_id, offset = wire.decode_varint(payload, offset)
                sink = self._transfer_sink
                if sink is not None:
                    sink(sender_id, payload[offset:])
                return
            if source == _PROPOSE_SRC:
                _client_ep, offset = wire.decode_varint(payload, offset)
                request = pb.decode(pb.Request, payload[offset:])
            else:
                msg = pb.decode(pb.Msg, payload[offset:])
        except ValueError:
            return  # malformed frame from a faulty peer: dropped
        from .node import NodeStopped

        if source == _PROPOSE_SRC:
            # Client-lane delivery: the speculative ingress stage (see
            # set_propose_sink / runtime/ingress.py) takes precedence
            # over the direct node.propose path.
            sink = self._propose_sink
            node = self._node
            try:
                if sink is not None:
                    sink(request)
                elif node is not None:
                    node.propose(request)
            except (ValueError, NodeStopped):
                pass
            return
        node = self._node
        if node is None:
            return  # not serving yet: dropped
        try:
            node.step(source, msg)
        except (ValueError, NodeStopped):
            return  # failed preflight validation / local shutdown: dropped

    # -- shutdown --------------------------------------------------------------

    def close(self, drain_timeout: float = 0.0) -> None:
        """Tear down the transport.  With ``drain_timeout > 0`` the sender
        threads first flush queued frames over connections that are already
        established (no new dials once closing)."""
        self._closed.set()
        # shutdown() wakes the accept thread's blocked accept() NOW.  With
        # close() alone the blocked syscall pins the file description, so
        # the kernel keeps the socket in LISTEN: a "closed" transport kept
        # completing handshakes (and peers' reconnects black-holed into
        # immediately-discarded connections) until the next accept wake.
        try:
            self._server.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._server.close()
        with self._lock:
            channels = list(self._channels.values())
        for channel in channels:
            channel.close(drain_timeout)
        for channel in channels:
            channel.thread.join(timeout=max(drain_timeout, 0) + 5)
        with self._lock:
            conns = [conn for conn, _lock in self._conns.values()]
            self._conns.clear()
            accepted = list(self._accepted)
            self._accepted.clear()
        for conn in conns:
            # Half-close first: the peer's reader sees a clean EOF for any
            # frames already in flight instead of a reset.
            try:
                conn.shutdown(socket.SHUT_WR)
            except OSError:
                pass
            conn.close()
        for conn in accepted:
            # shutdown unblocks the read thread's recv immediately; close
            # alone would leave it blocked and the port ESTABLISHED.
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            conn.close()
        # Join the accept/read threads so close() returning means no
        # transport thread is still running (no leaks across restarts).
        self._accept_thread.join(timeout=5)
        with self._lock:
            readers = list(self._read_threads)
        current = threading.current_thread()
        for thread in readers:
            if thread is not current:
                thread.join(timeout=5)
