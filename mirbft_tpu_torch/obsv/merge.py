"""Merge N per-node Chrome traces into one Perfetto-loadable timeline.

Each input trace is one node's view of the run: milestone instants, flow
records (``ph: "s"/"t"/"f"`` keyed by the stable id
``"<epoch>.<seq_no>.<bucket>"``), and whatever spans the node captured.
The merge gives every node its own Perfetto *process* lane (``pid`` =
node id, named via ``process_name`` metadata) and aligns timestamps
using each trace's ``clock_sync`` metadata:

- ``t0_ns`` — the tracer's monotonic birth anchor.  Event ``ts`` values
  are microseconds relative to it, so the absolute monotonic time of an
  event is ``t0_ns + ts * 1000``.
- ``offsets_ns`` — peer id -> (reference clock - peer clock), estimated
  at handshake time.  The TCP transport exchanges ``perf_counter_ns``
  anchors in its hello frame; the testengine's nodes share one process
  clock so its offsets are zero (the alignment path still runs, it is
  just the identity).

Caveats (documented in docs/OBSERVABILITY.md): offsets estimated from a
one-way hello absorb the network latency of that hello, so cross-host
alignment is accurate to ~one-way-latency; on a single host all
processes share CLOCK_MONOTONIC and alignment is exact.

Flow hygiene: per flow id the merge keeps the earliest ``s`` and the
latest ``f`` and demotes duplicates to ``t`` (every node opens its own
view of a sequence's flow, but a merged flow must have exactly one
start/finish).  Ids seen only as steps (checkpoint flows) are promoted —
earliest record becomes ``s``, latest ``f`` — and ids with a single
record are dropped.  Finally, a 1 µs anchor slice is synthesized under
each flow record so Perfetto has a slice to bind the arrows to
(flow events attach to slices, not instants).
"""

from __future__ import annotations

import json

from .trace import CLOCK_SYNC

_FLOW_PHS = ("s", "t", "f")


def split_node_traces(tracer, nodes):
    """Split one testengine tracer into per-node Chrome trace objects.

    The testengine drives every node in one process with one tracer,
    keying milestones by ``tid`` = node id.  This produces the N
    per-node trace files a real deployment would write, each carrying a
    ``clock_sync`` anchor (shared ``t0_ns``, zero offsets — handshake
    estimation against yourself) so the merge path is identical for
    simulated and TCP runs.  Events on non-node tids (process-wide
    crypto/flush spans) are not attributable to one node and are left
    out.
    """
    node_set = set(nodes)
    out = {}
    for node in nodes:
        out[node] = {
            "traceEvents": [
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": 0,
                    "tid": node,
                    "args": {"name": f"node {node}"},
                },
                {
                    "name": CLOCK_SYNC,
                    "ph": "M",
                    "pid": 0,
                    "tid": 0,
                    "args": {
                        "node": node,
                        "t0_ns": tracer.t0_ns,
                        "offsets_ns": {str(p): 0 for p in node_set if p != node},
                    },
                },
            ]
        }
    for event in tracer.events:
        tid = event.get("tid")
        if tid in node_set:
            out[tid]["traceEvents"].append(dict(event))
    return out


def _clock_sync_of(trace):
    for event in trace.get("traceEvents", ()):
        if event.get("ph") == "M" and event.get("name") == CLOCK_SYNC:
            return event.get("args") or {}
    return {}


def aligned_events(traces):
    """Align per-node traces onto the reference node's absolute clock.

    Returns ``(shifted, plans)``: ``shifted`` is a list of
    ``(abs_us, node, event)`` where ``abs_us`` is the event's absolute
    time on the reference node's CLOCK_MONOTONIC in microseconds (NOT
    rebased to zero — critpath joins these against loadgen's raw
    ``monotonic_ns`` stamps, which live on the same clock when loadgen
    runs on the reference host); ``plans`` is the sorted
    ``(node, clock_sync, trace)`` list.  The reference clock is the
    lowest node id's; its ``offsets_ns`` map shifts every peer lane.
    Metadata (``ph: "M"``) events are excluded.
    """
    traces = list(traces)
    plans = []
    for i, trace in enumerate(traces):
        sync = _clock_sync_of(trace)
        node = sync.get("node", i)
        plans.append((node, sync, trace))
    plans.sort(key=lambda p: p[0])
    if not plans:
        return [], []

    ref_node, ref_sync, _ = plans[0]
    ref_offsets = ref_sync.get("offsets_ns") or {}

    shifted = []  # (abs_us, node, event)
    for node, sync, trace in plans:
        t0_ns = sync.get("t0_ns", 0)
        offset_ns = 0 if node == ref_node else int(ref_offsets.get(str(node), 0))
        for event in trace.get("traceEvents", ()):
            if event.get("ph") == "M":
                continue
            ev = dict(event)
            abs_us = (t0_ns + offset_ns) / 1000.0 + float(ev.get("ts", 0.0))
            shifted.append((abs_us, node, ev))
    return shifted, plans


def merge_traces(traces):
    """Merge per-node trace objects into one Chrome trace object.

    ``traces`` is an iterable of parsed Chrome trace dicts, each ideally
    carrying ``clock_sync`` metadata.  Traces without it get node ids
    assigned by position and no clock shift (documented degradation).
    """
    shifted, plans = aligned_events(traces)
    if not plans:
        return {"traceEvents": []}

    merged = []
    if shifted:
        base_us = min(abs_us for abs_us, _, _ in shifted)
    else:
        base_us = 0.0
    for abs_us, node, ev in shifted:
        ev["ts"] = abs_us - base_us
        ev["pid"] = node
        merged.append(ev)
    merged.sort(key=lambda e: e["ts"])

    _normalize_flows(merged)
    merged.extend(_flow_anchors(merged))

    meta = []
    for node, sync, trace in plans:
        meta.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": node,
                "tid": 0,
                "args": {"name": f"node {node}"},
            }
        )
        for event in trace.get("traceEvents", ()):
            if event.get("ph") == "M" and event.get("name") == "thread_name":
                ev = dict(event)
                ev["pid"] = node
                meta.append(ev)
    return {"traceEvents": meta + merged}


def _normalize_flows(events):
    """Rewrite flow phases in-place so each id has exactly one s and one
    f (earliest/latest), steps in between; single-record ids are
    removed."""
    by_id = {}
    for event in events:
        if event.get("cat") == "flow" and event.get("ph") in _FLOW_PHS:
            by_id.setdefault(event["id"], []).append(event)
    drop = []
    for records in by_id.values():
        if len(records) < 2:
            drop.extend(records)
            continue
        records.sort(key=lambda e: e["ts"])
        for record in records:
            record["ph"] = "t"
            record.pop("bp", None)
        records[0]["ph"] = "s"
        records[-1]["ph"] = "f"
        records[-1]["bp"] = "e"
    for record in drop:
        events.remove(record)


def _flow_anchors(events):
    """1 µs ph:"X" slices under each flow record: Perfetto binds flow
    arrows to slices, and milestone instants are not slices."""
    anchors = []
    for event in events:
        if event.get("cat") == "flow" and event.get("ph") in _FLOW_PHS:
            anchors.append(
                {
                    "name": event["name"],
                    "cat": "flow_anchor",
                    "ph": "X",
                    "pid": event["pid"],
                    "tid": event["tid"],
                    "ts": event["ts"],
                    "dur": 1.0,
                }
            )
    return anchors


def merge_files(paths, out_path=None):
    """Load per-node trace JSON files, merge, optionally write.

    Returns the merged trace object.
    """
    traces = []
    for path in paths:
        with open(path, "r", encoding="utf-8") as f:
            traces.append(json.load(f))
    merged = merge_traces(traces)
    if out_path is not None:
        with open(out_path, "w", encoding="utf-8") as f:
            json.dump(merged, f)
    return merged
