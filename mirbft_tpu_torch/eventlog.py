"""Recorded event logs: serialize, redact, read back, replay, diff.

Rebuild of the reference's eventlog package + testengine player
(reference: eventlog/interceptor.go:84-378, eventlog/recorderpb/recorder.proto,
testengine/player.go:91-147).  Because every state-machine input is a
serializable StateEvent (the determinism discipline), a gzip stream of
``RecordedEvent{node_id, time_ms, state_event}`` captures *everything*
needed to re-execute a run: the Player feeds a recorded log into fresh
StateMachines and must land in the identical state.  This file format is
what the mircat-equivalent CLI (mirbft_tpu_torch.cat) and the non-determinism
finder (first_divergence) operate on.

Format: gzip member containing, per event, a varint length prefix followed
by the canonical ``wire`` encoding of RecordedEvent.  Request payloads are
redacted by default (digests identify them; the bytes themselves are
application data, reference: eventlog/interceptor.go:219-299) — redaction
does not affect replayability because digests re-enter via recorded
EventActionResults, never by re-hashing.
"""

from __future__ import annotations

import gzip
import queue
import threading
import time
import zlib
from dataclasses import dataclass, field, replace

from . import pb, wire
from .core.state_machine import StateMachine


@dataclass
class RecordedEvent:
    node_id: int = 0
    time_ms: int = 0
    state_event: pb.StateEvent | None = None


RecordedEvent._spec_ = (
    ("node_id", wire.U64),
    ("time_ms", wire.U64),
    ("state_event", wire.Nested(pb.StateEvent)),
)
wire.check_spec(RecordedEvent)


# ---------------------------------------------------------------------------
# Redaction
# ---------------------------------------------------------------------------


def redact_event(event: pb.StateEvent) -> pb.StateEvent:
    """Return a copy with request payloads emptied (digests kept).

    Covers every place request data rides a state event: proposals, inbound
    ForwardRequest msgs, and the request/verify hash-result origins
    (reference: eventlog/interceptor.go:219-299)."""
    inner = event.type
    if isinstance(inner, pb.EventPropose) and inner.request is not None:
        if not inner.request.data:
            return event
        return pb.StateEvent(
            type=pb.EventPropose(request=replace(inner.request, data=b""))
        )
    if isinstance(inner, pb.EventProposeBatch):
        if not any(r.data for r in inner.requests):
            return event
        return pb.StateEvent(
            type=pb.EventProposeBatch(
                requests=[
                    replace(r, data=b"") if r.data else r
                    for r in inner.requests
                ]
            )
        )
    if isinstance(inner, pb.EventStep) and isinstance(
        inner.msg.type if inner.msg else None, pb.ForwardRequest
    ):
        fwd = inner.msg.type
        if not fwd.request_data:
            return event
        return pb.StateEvent(
            type=pb.EventStep(
                source=inner.source,
                msg=pb.Msg(type=replace(fwd, request_data=b"")),
            )
        )
    if isinstance(inner, pb.EventStepBatch):
        if not any(
            isinstance(m.type, pb.ForwardRequest) and m.type.request_data
            for m in inner.msgs
        ):
            return event
        return pb.StateEvent(
            type=pb.EventStepBatch(
                source=inner.source,
                msgs=[
                    pb.Msg(type=replace(m.type, request_data=b""))
                    if isinstance(m.type, pb.ForwardRequest)
                    and m.type.request_data
                    else m
                    for m in inner.msgs
                ],
            )
        )
    if isinstance(inner, pb.EventActionResults):
        redacted = []
        changed = False
        for hr in inner.digests:
            origin = hr.type
            if isinstance(origin, pb.HashOriginRequest) and origin.request is not None and origin.request.data:
                origin = replace(origin, request=replace(origin.request, data=b""))
                changed = True
            elif isinstance(origin, pb.HashOriginVerifyRequest) and origin.request_data:
                origin = replace(origin, request_data=b"")
                changed = True
            redacted.append(pb.HashResult(digest=hr.digest, type=origin))
        if not changed:
            return event
        return pb.StateEvent(
            type=pb.EventActionResults(
                digests=redacted, checkpoints=inner.checkpoints
            )
        )
    return event


# ---------------------------------------------------------------------------
# Writer / Reader
# ---------------------------------------------------------------------------


def write_recorded_event(stream, recorded: RecordedEvent) -> None:
    body = wire.encode(recorded)
    stream.write(wire.encode_varint(len(body)))
    stream.write(body)


def read_recorded_events(stream):
    """Yield RecordedEvents from a raw (already-decompressed) stream."""
    buf = stream.read()
    pos = 0
    while pos < len(buf):
        size, pos = wire.decode_varint(buf, pos)
        if pos + size > len(buf):
            raise ValueError("truncated recorded event")
        yield wire.decode(RecordedEvent, buf[pos : pos + size])
        pos += size


def _read_gzip_prefix(path: str) -> bytes:
    """Decompress as much of a (possibly torn) gzip file as possible.

    zlib's decompressobj hands back everything decodable before the point
    of truncation/corruption (gzip.GzipFile instead discards its buffered
    output when the end-of-stream marker is missing)."""
    with open(path, "rb") as raw:
        data = raw.read()
    out = bytearray()
    pos = 0
    while pos < len(data):
        decomp = zlib.decompressobj(wbits=47)  # auto gzip/zlib header
        try:
            out += decomp.decompress(data[pos:])
        except zlib.error:
            break  # corrupt member; keep what we have
        if not decomp.eof or not decomp.unused_data:
            break  # torn tail, or single complete member
        pos = len(data) - len(decomp.unused_data)
    return bytes(out)


class EventLogWriter:
    """Synchronous gzip event-log writer."""

    def __init__(self, path: str, redact: bool = True):
        self.path = path
        self.redact = redact
        self._gz = gzip.open(path, "wb")

    def write(self, node_id: int, time_ms: int, event: pb.StateEvent) -> None:
        if self.redact:
            event = redact_event(event)
        self.write_recorded(
            RecordedEvent(node_id=node_id, time_ms=time_ms, state_event=event)
        )

    def write_recorded(self, recorded: RecordedEvent) -> None:
        """Write an already-redacted RecordedEvent as-is."""
        write_recorded_event(self._gz, recorded)

    def close(self) -> None:
        self._gz.close()


class Recorder:
    """Async buffered interceptor for the runtime Node (reference:
    eventlog/interceptor.go:84-217): events are queued (default depth 5000,
    drop-newest on overflow with a counter) and written by a background
    thread, so the serializer never blocks on disk.

    Use ``recorder.interceptor(node_id)`` as ``Config.event_interceptor``.
    """

    def __init__(self, path: str, redact: bool = True, buffer_size: int = 5000,
                 time_source=None):
        self._writer = EventLogWriter(path, redact=redact)
        self._queue: queue.Queue = queue.Queue(maxsize=buffer_size)
        self._time = time_source or (lambda: int(time.time() * 1000))
        self.dropped = 0
        self._closed = threading.Event()
        self._thread = threading.Thread(
            target=self._drain, name="eventlog-recorder", daemon=True
        )
        self._thread.start()

    def interceptor(self, node_id: int):
        def intercept(event: pb.StateEvent) -> None:
            try:
                self._queue.put_nowait((node_id, self._time(), event))
            except queue.Full:
                self.dropped += 1

        return intercept

    def _drain(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            node_id, time_ms, event = item
            self._writer.write(node_id, time_ms, event)

    def close(self) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        self._queue.put(None)
        self._thread.join(timeout=10)
        if self._thread.is_alive():
            # Drain stalled (e.g. hung disk): leave the file open rather
            # than closing it under the writer thread, which would corrupt
            # the log mid-record.
            return
        self._writer.close()


def read_log(path: str, strict: bool = False) -> list:
    """Read a recorded log into a list of RecordedEvents.

    By default a torn tail (crashed writer, SIGKILL mid-write) yields the
    intact prefix — the whole point of the log is post-mortem debugging, so
    the reader must survive exactly the runs that died badly.  ``strict``
    raises on any truncation instead."""
    if strict:
        with gzip.open(path, "rb") as gz:
            return list(read_recorded_events(gz))
    buf = _read_gzip_prefix(path)
    events = []
    pos = 0
    while pos < len(buf):
        try:
            size, body_pos = wire.decode_varint(buf, pos)
            if body_pos + size > len(buf):
                break  # torn final record
            events.append(
                wire.decode(RecordedEvent, buf[body_pos : body_pos + size])
            )
        except ValueError:
            break  # corrupt tail; keep the intact prefix
        pos = body_pos + size
    return events


def write_log(path: str, events, redact: bool = True) -> None:
    """Write an iterable of (node_id, time_ms, pb.StateEvent) tuples."""
    writer = EventLogWriter(path, redact=redact)
    try:
        for node_id, time_ms, event in events:
            writer.write(node_id, time_ms, event)
    finally:
        writer.close()


# ---------------------------------------------------------------------------
# Player
# ---------------------------------------------------------------------------


@dataclass
class PlayedNode:
    machine: StateMachine
    applied: int = 0
    actions: list = field(default_factory=list)  # last event's Actions


class Player:
    """Replays a recorded log against fresh StateMachines (reference:
    testengine/player.go:91-147).  Events must appear in the recorded order;
    each node's machine sees exactly the inputs it saw live, so its state —
    and Status() — must be identical at every index."""

    def __init__(self, events: list, logger=None):
        self.events = events
        self.logger = logger
        self.nodes: dict[int, PlayedNode] = {}
        self.position = 0

    def node(self, node_id: int) -> PlayedNode:
        played = self.nodes.get(node_id)
        if played is None:
            played = PlayedNode(machine=StateMachine(logger=self.logger))
            self.nodes[node_id] = played
        return played

    def step(self) -> RecordedEvent | None:
        if self.position >= len(self.events):
            return None
        recorded = self.events[self.position]
        self.position += 1
        played = self.node(recorded.node_id)
        if (
            isinstance(recorded.state_event.type, pb.EventInitialize)
            and played.applied > 0
        ):
            # A second Initialize on a node is a recorded restart: the live
            # run booted a fresh StateMachine (engine restart / runtime
            # process restart), so the replay must too.
            played.machine = StateMachine(logger=self.logger)
        actions = played.machine.apply_event(recorded.state_event)
        played.applied += 1
        played.actions = actions
        return recorded

    def play(self, upto: int | None = None) -> None:
        """Apply events until the log is exhausted (or `upto` total)."""
        limit = len(self.events) if upto is None else min(upto, len(self.events))
        while self.position < limit:
            self.step()


# ---------------------------------------------------------------------------
# Non-determinism finder
# ---------------------------------------------------------------------------


def first_divergence(events_a: list, events_b: list):
    """Compare two recorded logs event-by-event; returns None when equal, or
    (index, event_a | None, event_b | None) at the first divergence
    (reference: testengine/eventlog_test.go:23-60, the disabled finder)."""
    for i, (ea, eb) in enumerate(zip(events_a, events_b)):
        if wire.encode(ea) != wire.encode(eb):
            return i, ea, eb
    if len(events_a) != len(events_b):
        i = min(len(events_a), len(events_b))
        return (
            i,
            events_a[i] if i < len(events_a) else None,
            events_b[i] if i < len(events_b) else None,
        )
    return None


# ---------------------------------------------------------------------------
# Testengine adapter
# ---------------------------------------------------------------------------


class EngineLog:
    """Adapter collecting a testengine run into RecordedEvents (and
    optionally straight to disk): pass ``.interceptor`` as the Recorder's
    interceptor kwarg."""

    def __init__(self, path: str | None = None, redact: bool = True):
        self.events: list[RecordedEvent] = []
        self.redact = redact
        self._writer = (
            EventLogWriter(path, redact=redact) if path is not None else None
        )

    def interceptor(self, node: int, time_ms: int, event: pb.StateEvent) -> None:
        if self.redact:
            event = redact_event(event)
        self.events.append(
            RecordedEvent(node_id=node, time_ms=time_ms, state_event=event)
        )
        if self._writer is not None:
            # Already redacted above; don't double-copy.
            self._writer.write_recorded(self.events[-1])

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
