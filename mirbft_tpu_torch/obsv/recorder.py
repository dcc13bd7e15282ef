"""Black-box flight recorder: bounded ring of events, crash-safe dumps.

Every node (thread-cluster replica, OS-process worker, chaos engine)
keeps a ``FlightRecorder``: a fixed-capacity ring of the last N
StateEvents, span milestones, and resource/metric snapshots.  The ring
is preallocated — recording overwrites slots in place, so steady-state
recording does no list growth and stays cheap enough to leave on.

Dumps are *segment files* written atomically (tmp + ``os.replace``)
and rotated over a small fixed set of names, so:

- a SIGKILL mid-write can tear only the tmp file, never a committed
  segment — the previous segment survives intact;
- continuous autoflush (every ``autoflush_every`` records) means even
  a worker that is killed with no chance to run cleanup leaves a
  recent segment behind for the supervisor to reap.

``python -m mirbft_tpu_torch.obsv --postmortem <dir>`` loads every node's
newest segment, converts each to a Chrome trace carrying the same
``clock_sync`` metadata the live tracer emits, and routes them through
``obsv/merge.py`` — one cross-node, clock-aligned causal timeline
ending at the failure.
"""

from __future__ import annotations

import json
import os
import threading
import time

SCHEMA = "mirbft-flight/1"

#: Segment names cycled per node; 2 is enough for the crash-safety
#: argument (the newest committed segment plus the one being replaced).
SEGMENT_KEEP = 2

_KINDS = ("event", "milestone", "resource", "note")


class FlightRecorder:
    """Bounded per-node ring buffer with atomic on-disk dumps.

    ``node`` labels the dump (int node id or a string like ``"bench"``).
    ``dump_dir`` is where segments land; ``None`` keeps the recorder
    purely in-memory (``flush`` then returns the dump dict's path as
    ``None`` but the dump is still available via ``snapshot``).
    ``registry`` (an obsv ``Registry``) receives
    ``mirbft_recorder_records_total{kind}`` /
    ``mirbft_recorder_overwritten_total`` counter deltas at flush time
    — counting at flush keeps ``record()`` off the metrics path.
    """

    def __init__(
        self,
        node,
        dump_dir=None,
        capacity=512,
        autoflush_every=256,
        registry=None,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.node = node
        self.dump_dir = dump_dir
        self.capacity = int(capacity)
        self.autoflush_every = int(autoflush_every) if autoflush_every else 0
        self.registry = registry
        self._ring = [None] * self.capacity
        self._next = 0  # monotone record counter; slot = _next % capacity
        self._t0_ns = time.perf_counter_ns()
        self._offsets_ns = {}
        self._flush_seq = 0
        self._kind_counts = {kind: 0 for kind in _KINDS}
        self._counted = {kind: 0 for kind in _KINDS}
        self._counted_overwritten = 0
        self._lock = threading.Lock()
        self._flush_lock = threading.Lock()
        self.last_dump_path = None
        if dump_dir:
            os.makedirs(dump_dir, exist_ok=True)

    # ------------------------------------------------------------------
    # Recording
    # ------------------------------------------------------------------

    def record(self, kind, name, node=None, args=None):
        """Append one entry to the ring (O(1), no allocation growth)."""
        ts_us = (time.perf_counter_ns() - self._t0_ns) / 1000.0
        entry = {
            "ts_us": ts_us,
            "kind": kind,
            "name": name,
            "node": self.node if node is None else node,
        }
        if args:
            entry["args"] = args
        with self._lock:
            self._ring[self._next % self.capacity] = entry
            self._next += 1
            if kind in self._kind_counts:
                self._kind_counts[kind] += 1
            else:
                self._kind_counts[kind] = 1
            due = (
                self.autoflush_every
                and self.dump_dir
                and self._next % self.autoflush_every == 0
            )
        if due:
            self.flush("auto")

    def record_event(self, name, node=None, args=None):
        self.record("event", name, node, args)

    def record_milestone(self, name, node=None, args=None):
        self.record("milestone", name, node, args)

    def record_resources(self, sample, node=None):
        self.record("resource", "resource.sample", node, sample)

    def record_note(self, name, node=None, args=None):
        """Out-of-band marker (e.g. ``invariant.violation``)."""
        self.record("note", name, node, args)

    def set_clock_offsets(self, offsets_ns):
        """Peer id -> (local - peer) perf_counter_ns, from the transport
        hello handshake; lets --postmortem align this node's dump with
        its peers' exactly like live trace merging."""
        with self._lock:
            self._offsets_ns = {
                str(k): int(v) for k, v in (offsets_ns or {}).items()
            }

    # ------------------------------------------------------------------
    # Dumping
    # ------------------------------------------------------------------

    def snapshot(self, reason="snapshot"):
        """The dump payload dict (oldest-first entries), without I/O."""
        with self._lock:
            total = self._next
            start = max(0, total - self.capacity)
            entries = [
                self._ring[i % self.capacity] for i in range(start, total)
            ]
            dump = {
                "schema": SCHEMA,
                "node": self.node,
                "reason": reason,
                "flush_seq": self._flush_seq,
                "t0_ns": self._t0_ns,
                "offsets_ns": dict(self._offsets_ns),
                "capacity": self.capacity,
                "recorded": total,
                "overwritten": start,
                "entries": entries,
            }
        return dump

    def flush(self, reason="flush"):
        """Write the current ring to an atomic segment file.

        Returns the segment path, or None when no ``dump_dir`` is set.
        Counter deltas since the last flush land on the registry here.
        """
        # One flush at a time, in the order of their sequence numbers: two
        # flushes of one segment name (seq k and k + SEGMENT_KEEP, say the
        # exporter's /dump and a serializer's autoflush) would otherwise
        # share its temporary file, and the later rename finds it gone
        # (ROADMAP queue 3).
        with self._flush_lock:
            return self._flush(reason)

    def _flush(self, reason):
        dump = self.snapshot(reason)
        self._count(dump)
        if not self.dump_dir:
            return None
        with self._lock:
            seq = self._flush_seq
            self._flush_seq += 1
        dump["flush_seq"] = seq
        name = f"node{self.node}-{seq % SEGMENT_KEEP}.flight.json"
        path = os.path.join(self.dump_dir, name)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(dump, fh)
        os.replace(tmp, path)
        self.last_dump_path = path
        return path

    def _count(self, dump):
        """Emit counter deltas since the last flush onto the registry.

        record() only bumps a plain dict under the ring lock; the
        registry (label lookup, cardinality check) is touched here, off
        the recording hot path.
        """
        if self.registry is None:
            return
        with self._lock:
            deltas = {
                kind: self._kind_counts.get(kind, 0) - self._counted.get(kind, 0)
                for kind in self._kind_counts
            }
            for kind in self._kind_counts:
                self._counted[kind] = self._kind_counts[kind]
            delta_over = dump["overwritten"] - self._counted_overwritten
            self._counted_overwritten = dump["overwritten"]
        for kind, delta in sorted(deltas.items()):
            if delta > 0:
                self.registry.counter(
                    "mirbft_recorder_records_total", kind=kind
                ).inc(delta)
        if delta_over > 0:
            self.registry.counter("mirbft_recorder_overwritten_total").inc(
                delta_over
            )


# ----------------------------------------------------------------------
# Postmortem: dumps -> merged causal timeline
# ----------------------------------------------------------------------


def dump_to_trace(dump):
    """Convert one flight dump into a merge-compatible Chrome trace.

    Entries become ph:"i" instants with ``cat = "flight.<kind>"``
    (merge's flow normalization only touches ``cat == "flow"``, so
    flight instants pass through untouched), plus the ``clock_sync``
    metadata record merge.py aligns on.
    """
    node = dump.get("node", 0)
    events = [
        {
            "name": "thread_name",
            "ph": "M",
            "pid": 0,
            "tid": node,
            "args": {"name": f"node {node} flight"},
        },
        {
            "name": "clock_sync",
            "ph": "M",
            "pid": 0,
            "tid": 0,
            "args": {
                "node": node,
                "t0_ns": dump.get("t0_ns", 0),
                "offsets_ns": dump.get("offsets_ns") or {},
            },
        },
    ]
    for entry in dump.get("entries", ()):
        if not entry:
            continue
        event = {
            "name": entry.get("name", "?"),
            "cat": f"flight.{entry.get('kind', 'event')}",
            "ph": "i",
            "s": "t",
            "pid": 0,
            "tid": entry.get("node", node),
            "ts": float(entry.get("ts_us", 0.0)),
        }
        if entry.get("args"):
            event["args"] = entry["args"]
        events.append(event)
    return {"traceEvents": events}


def load_dumps(dump_dir):
    """Newest parseable flight dump per node under ``dump_dir``.

    Walks recursively (the supervisor nests per-node ``flight/``
    directories), skips torn/unparseable files (a crashed writer's tmp
    leftovers), and keeps the highest ``flush_seq`` per node.
    """
    best = {}
    for root, _dirs, files in os.walk(dump_dir):
        for name in sorted(files):
            if not name.endswith(".flight.json"):
                continue
            path = os.path.join(root, name)
            try:
                with open(path, "r", encoding="utf-8") as fh:
                    dump = json.load(fh)
            except (OSError, ValueError):
                continue
            if dump.get("schema") != SCHEMA:
                continue
            node = dump.get("node", name)
            seq = dump.get("flush_seq", -1)
            kept = best.get(node)
            if kept is None or seq > kept[0]:
                best[node] = (seq, path, dump)
    return {node: (path, dump) for node, (seq, path, dump) in best.items()}


def annotate_dump(path, **extra):
    """Atomically add keys to a committed dump (supervisor reap stamps
    ``reason="sigkill-reaped"`` etc.). Returns True on success."""
    try:
        with open(path, "r", encoding="utf-8") as fh:
            dump = json.load(fh)
    except (OSError, ValueError):
        return False
    dump.update(extra)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(dump, fh)
    os.replace(tmp, path)
    return True


def render_timeline(merged, limit=200):
    """Human-readable tail of a merged postmortem trace.

    The last ``limit`` instants, oldest first, one line each — the
    timeline by construction ends at the failure (the violation note is
    the last thing recorded before the flush).
    """
    instants = [
        ev
        for ev in merged.get("traceEvents", ())
        if ev.get("ph") == "i" and str(ev.get("cat", "")).startswith("flight.")
    ]
    instants.sort(key=lambda ev: ev.get("ts", 0.0))
    tail = instants[-limit:]
    lines = []
    for ev in tail:
        ts_ms = float(ev.get("ts", 0.0)) / 1000.0
        kind = str(ev.get("cat", ""))[len("flight."):]
        args = ev.get("args")
        detail = ""
        if args:
            detail = " " + json.dumps(args, sort_keys=True, default=str)
        lines.append(
            f"{ts_ms:12.3f}ms node={ev.get('pid')} "
            f"[{kind}] {ev.get('name')}{detail}"
        )
    return "\n".join(lines)


def postmortem(dump_dir, out_path=None, limit=200):
    """Merge every node's newest dump into one causal timeline.

    Returns ``{"nodes", "dumps", "merged", "timeline"}``; writes the
    merged Chrome trace to ``out_path`` when given.  Raises
    FileNotFoundError when the directory holds no parseable dumps.
    """
    dumps = load_dumps(dump_dir)
    if not dumps:
        raise FileNotFoundError(f"no flight dumps under {dump_dir!r}")
    from .merge import merge_traces

    ordered = sorted(dumps.items(), key=lambda item: str(item[0]))
    traces = [dump_to_trace(dump) for _node, (_path, dump) in ordered]
    merged = merge_traces(traces)
    if out_path is not None:
        with open(out_path, "w", encoding="utf-8") as fh:
            json.dump(merged, fh)
    return {
        "nodes": [node for node, _ in ordered],
        "dumps": {str(node): path for node, (path, _dump) in ordered},
        "merged": merged,
        "timeline": render_timeline(merged, limit=limit),
    }
