"""Per-request critical-path ledger: saturation attribution.

Answers the question the capacity rung raises but cannot answer alone:
when p95 breaks at some arrival rate, *which phase* of a request's
lifecycle absorbed the wait, and *on which node*?  The evidence is the
milestone instants every node's tracer already records (``seq.allocated``
… ``seq.committed``, with ``args.node/seq``), aligned onto the reference
node's clock by :func:`obsv.merge.aligned_events`, optionally joined —
by sequence number — with the loadgen's per-request submit→commit
records (``StepResult.records``), which live on the same
CLOCK_MONOTONIC when loadgen runs on the reference host.

Phase vocabulary (each phase is one edge of the aligned timeline):

    ingress    client submit -> first ``seq.allocated``        (needs join)
    hash       first allocated -> first ``seq.preprepared``    (digest verify
               on the owning leader)
    transmit   first preprepared -> last node's preprepared    (preprepare
               propagation; the straggler node closes it)
    quorum     last preprepared -> first ``seq.commit_quorum`` (prepare +
               commit vote collection)
    commit     first commit_quorum -> first ``seq.committed``  (persist /
               barrier / log apply on the committing node — corroborate
               with the ``mirbft_queue_*`` series for proc.persist /
               proc.barrier)
    apply      committed on the observing node -> client-observed
               commit                                          (needs join)

Without loadgen records the ledger still builds (one row per committed
flow, ingress/apply absent); with them it is one row per committed
request.  The extractor buckets rows into latency percentile bands and
reports, per band, mean residency per phase, the dominant phase, and
the node that most often closed it — the saturation attribution the
``mirbft-capacity/1`` artifact embeds at the knee.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

from .merge import aligned_events

#: Ledger phases in lifecycle order.
PHASES = ("ingress", "hash", "transmit", "quorum", "commit", "apply")

#: Default latency percentile bands for attribution.
BANDS = ((0.0, 0.50), (0.50, 0.95), (0.95, 0.99), (0.99, 1.0))

_ALLOCATED = "seq.allocated"
_PREPREPARED = "seq.preprepared"
_COMMIT_QUORUM = "seq.commit_quorum"
_COMMITTED = "seq.committed"


@dataclass
class FlowRecord:
    """One committed request's (or flow's) phase residency, microseconds."""

    seq: int
    epoch: int | None = None
    bucket: int | None = None
    client_id: int | None = None
    req_no: int | None = None
    total_us: float = 0.0
    phases: dict = field(default_factory=dict)  # phase -> residency µs
    phase_nodes: dict = field(default_factory=dict)  # phase -> closing node


def _collect_marks(shifted):
    """seq -> {milestone -> {node -> abs_us (earliest)}} plus
    seq -> (epoch, bucket) from milestone instants."""
    marks: dict = {}
    meta: dict = {}
    for abs_us, node, event in shifted:
        if event.get("ph") != "i":
            continue
        name = event.get("name", "")
        if not name.startswith("seq."):
            continue
        args = event.get("args") or {}
        seq = args.get("seq")
        if seq is None:
            continue
        anode = args.get("node", node)
        per_node = marks.setdefault(seq, {}).setdefault(name, {})
        if anode not in per_node or abs_us < per_node[anode]:
            per_node[anode] = abs_us
        if seq not in meta and "epoch" in args and "bucket" in args:
            meta[seq] = (args["epoch"], args["bucket"])
    return marks, meta


def _first(per_node):
    """(abs_us, node) of the earliest node mark, or None."""
    if not per_node:
        return None
    node = min(per_node, key=lambda n: (per_node[n], n))
    return per_node[node], node


def _last(per_node):
    """(abs_us, node) of the latest node mark, or None."""
    if not per_node:
        return None
    node = max(per_node, key=lambda n: (per_node[n], -n))
    return per_node[node], node


def _consensus_phases(seq_marks):
    """The four join-free phases from one seq's milestone marks.

    Returns ``(phases, phase_nodes, allocated_first, committed_first)``;
    edges whose milestones are missing are simply absent (a flow scored
    mid-run can lack its allocated mark).  Residencies are clamped at
    zero: alignment is exact on one host and ~one-way-latency across
    hosts, and a negative residency is attribution noise, not signal.
    """
    phases: dict = {}
    nodes: dict = {}
    alloc = _first(seq_marks.get(_ALLOCATED, {}))
    pp_first = _first(seq_marks.get(_PREPREPARED, {}))
    pp_last = _last(seq_marks.get(_PREPREPARED, {}))
    cq = _first(seq_marks.get(_COMMIT_QUORUM, {}))
    committed = _first(seq_marks.get(_COMMITTED, {}))

    def edge(phase, start, end):
        if start is not None and end is not None:
            phases[phase] = max(0.0, end[0] - start[0])
            nodes[phase] = end[1]

    edge("hash", alloc, pp_first)
    edge("transmit", pp_first, pp_last)
    edge("quorum", pp_last, cq)
    edge("commit", cq, committed)
    return phases, nodes, alloc, committed


def build_ledger(traces, records=None):
    """Build the per-request ledger from per-node Chrome traces.

    ``traces`` — iterable of parsed trace dicts (clock_sync metadata
    aligns them; see merge.py).  ``records`` — optional loadgen
    per-request dicts (``StepResult.records``); when given, the ledger
    is one row per committed request (ingress/apply resolved from the
    submit/commit stamps), otherwise one row per committed flow.
    Returns a list of :class:`FlowRecord` sorted by ``total_us``.
    """
    shifted, _plans = aligned_events(traces)
    marks, meta = _collect_marks(shifted)

    ledger = []
    if records:
        for rec in records:
            seq = rec.get("seq")
            seq_marks = marks.get(seq)
            if seq_marks is None:
                continue  # no trace evidence for this commit
            phases, nodes, alloc, _committed = _consensus_phases(seq_marks)
            submit_us = rec["submit_ns"] / 1000.0
            commit_us = rec["commit_ns"] / 1000.0
            if alloc is not None:
                phases["ingress"] = max(0.0, alloc[0] - submit_us)
                nodes["ingress"] = alloc[1]
            obs_node = rec.get("node")
            committed_at = marks.get(seq, {}).get(_COMMITTED, {})
            applied = committed_at.get(obs_node)
            if applied is None:
                applied_first = _first(committed_at)
                applied = applied_first[0] if applied_first else None
            if applied is not None:
                phases["apply"] = max(0.0, commit_us - applied)
                nodes["apply"] = obs_node
            epoch, bucket = meta.get(seq, (None, None))
            ledger.append(
                FlowRecord(
                    seq=seq,
                    epoch=epoch,
                    bucket=bucket,
                    client_id=rec.get("client_id"),
                    req_no=rec.get("req_no"),
                    total_us=max(0.0, commit_us - submit_us),
                    phases=phases,
                    phase_nodes=nodes,
                )
            )
    else:
        for seq, seq_marks in marks.items():
            phases, nodes, alloc, committed = _consensus_phases(seq_marks)
            if alloc is None or committed is None:
                continue
            epoch, bucket = meta.get(seq, (None, None))
            ledger.append(
                FlowRecord(
                    seq=seq,
                    epoch=epoch,
                    bucket=bucket,
                    total_us=max(0.0, committed[0] - alloc[0]),
                    phases=phases,
                    phase_nodes=nodes,
                )
            )
    ledger.sort(key=lambda r: r.total_us)
    return ledger


def attribute(ledger, bands=BANDS):
    """Per-band saturation attribution over a sorted ledger.

    Each band ``(lo, hi)`` covers ledger rows ranked by total latency in
    ``[lo*n, hi*n)`` (the top band includes the slowest row).  Per band:
    mean residency per phase, the dominant phase (largest mean), and the
    node that most often closed it.  Bands with no rows are omitted.
    """
    rows = sorted(ledger, key=lambda r: r.total_us)
    n = len(rows)
    out = []
    for lo, hi in bands:
        start = int(lo * n)
        stop = n if hi >= 1.0 else int(hi * n)
        band_rows = rows[start:stop]
        if not band_rows:
            continue
        phase_sum = {phase: 0.0 for phase in PHASES}
        phase_count = {phase: 0 for phase in PHASES}
        node_votes: dict = {phase: {} for phase in PHASES}
        for row in band_rows:
            for phase, us in row.phases.items():
                phase_sum[phase] += us
                phase_count[phase] += 1
                node = row.phase_nodes.get(phase)
                if node is not None:
                    votes = node_votes[phase]
                    votes[node] = votes.get(node, 0) + 1
        phase_us = {
            phase: phase_sum[phase] / phase_count[phase]
            for phase in PHASES
            if phase_count[phase]
        }
        if not phase_us:
            continue
        dominant = max(phase_us, key=lambda p: (phase_us[p], p))
        votes = node_votes[dominant]
        dominant_node = (
            max(votes, key=lambda nd: (votes[nd], -nd)) if votes else None
        )
        out.append(
            {
                "band": f"p{lo * 100:g}-p{hi * 100:g}",
                "count": len(band_rows),
                "total_us_mean": sum(r.total_us for r in band_rows)
                / len(band_rows),
                "phase_us": phase_us,
                "dominant_phase": dominant,
                "dominant_node": dominant_node,
            }
        )
    return out


def attribution_table(attribution):
    """ASCII table for the ``--critpath`` CLI (µs means per band)."""
    header = f"{'band':<10} {'count':>6} {'total_us':>10} "
    header += " ".join(f"{phase:>9}" for phase in PHASES)
    header += f"  {'dominant':<10} {'node':>4}"
    lines = [header, "-" * len(header)]
    if not attribution:
        lines.append("(no joined flows — is clock_sync metadata present?)")
    for band in attribution:
        cells = " ".join(
            f"{band['phase_us'].get(phase, 0.0):>9.1f}" for phase in PHASES
        )
        node = band["dominant_node"]
        lines.append(
            f"{band['band']:<10} {band['count']:>6} "
            f"{band['total_us_mean']:>10.1f} {cells}  "
            f"{band['dominant_phase']:<10} "
            f"{node if node is not None else '-':>4}"
        )
    return "\n".join(lines)


def ledger_from_dir(path):
    """Load a run directory: per-node ``trace*.json`` files — flat, or
    one level down in ``node*/`` subdirectories (the cluster
    supervisor's root layout) — plus an optional ``records.json``
    (loadgen per-request records).  Returns ``(ledger, n_traces)``."""
    trace_paths = sorted(
        os.path.join(path, name)
        for name in os.listdir(path)
        if name.startswith("trace") and name.endswith(".json")
    )
    if not trace_paths:
        trace_paths = sorted(
            os.path.join(path, sub, name)
            for sub in os.listdir(path)
            if sub.startswith("node")
            and os.path.isdir(os.path.join(path, sub))
            for name in os.listdir(os.path.join(path, sub))
            if name.startswith("trace") and name.endswith(".json")
        )
    traces = []
    for trace_path in trace_paths:
        with open(trace_path, "r", encoding="utf-8") as f:
            traces.append(json.load(f))
    records = None
    records_path = os.path.join(path, "records.json")
    if os.path.exists(records_path):
        with open(records_path, "r", encoding="utf-8") as f:
            records = json.load(f)
    return build_ledger(traces, records=records), len(traces)
