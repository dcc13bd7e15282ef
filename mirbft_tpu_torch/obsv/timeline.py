"""Consensus timeline profiler.

Reconstructs the per-(node, seq) lifecycle from the protocol-milestone
instant events the instrumented core emits —

    seq.allocated      batch allocated to a sequence (request arrival
                       at the consensus layer)
    seq.preprepared    digest verified, preprepare applied
    seq.prepared       prepare quorum reached
    seq.commit_quorum  commit quorum reached (state COMMITTED)
    seq.committed      batch applied to the node's log
    ckpt.stable        checkpoint covering the seq went stable

— and emits p50/p95/p99 per protocol phase:

    preprepare   seq.allocated      -> seq.preprepared
    prepare      seq.preprepared    -> seq.prepared
    commit       seq.prepared       -> seq.commit_quorum
    checkpoint   seq.commit_quorum  -> first ckpt.stable with
                 checkpoint seq >= seq at the same node

Under the testengine every milestone carries ``args.sim_ms`` (the
Recorder's simulated clock), and the profiler prefers it — phase
durations are then deterministic simulated milliseconds.  Without it
(runtime spans) it falls back to the monotonic wall timestamp (``ts``,
microseconds, converted to ms).
"""

from __future__ import annotations

from dataclasses import dataclass

PHASES = ("preprepare", "prepare", "commit", "checkpoint")

_PHASE_EDGES = {
    "preprepare": ("seq.allocated", "seq.preprepared"),
    "prepare": ("seq.preprepared", "seq.prepared"),
    "commit": ("seq.prepared", "seq.commit_quorum"),
}

_MILESTONES = frozenset(
    name for edge in _PHASE_EDGES.values() for name in edge
) | {"seq.committed"}


@dataclass
class PhaseStats:
    phase: str
    count: int
    p50: float
    p95: float
    p99: float


def _percentile(sorted_samples, q):
    """Nearest-rank percentile on a pre-sorted list."""
    n = len(sorted_samples)
    return sorted_samples[min(n - 1, int(q * n))]


class TimelineProfiler:
    """Feed it milestone instants, ask for per-phase latency stats."""

    def __init__(self):
        # (node, seq) -> {milestone name -> time_ms}
        self._marks = {}
        # node -> [(ckpt_seq, time_ms)] in arrival order
        self._ckpts = {}

    @staticmethod
    def _event_time_ms(event):
        args = event.get("args") or {}
        sim = args.get("sim_ms")
        if sim is not None:
            return float(sim)
        return event.get("ts", 0.0) / 1000.0

    def add_event(self, event):
        if event.get("ph") != "i":
            return
        name = event.get("name", "")
        args = event.get("args") or {}
        node = args.get("node")
        seq = args.get("seq")
        if node is None or seq is None:
            return
        t = self._event_time_ms(event)
        if name in _MILESTONES:
            self._marks.setdefault((node, seq), {}).setdefault(name, t)
        elif name == "ckpt.stable":
            self._ckpts.setdefault(node, []).append((seq, t))

    @classmethod
    def from_events(cls, events):
        profiler = cls()
        for event in events:
            profiler.add_event(event)
        return profiler

    @classmethod
    def from_tracer(cls, tracer):
        return cls.from_events(tracer.events)

    @classmethod
    def from_chrome_trace(cls, trace):
        """``trace`` is the loaded JSON object ({"traceEvents": [...]})."""
        return cls.from_events(trace.get("traceEvents", ()))

    def phase_samples(self):
        """phase -> list of duration samples (ms)."""
        samples = {phase: [] for phase in PHASES}
        for (node, seq), marks in self._marks.items():
            for phase, (start, end) in _PHASE_EDGES.items():
                if start in marks and end in marks:
                    samples[phase].append(marks[end] - marks[start])
            cq = marks.get("seq.commit_quorum")
            if cq is not None:
                stable = self._first_stable_after(node, seq, cq)
                if stable is not None:
                    samples["checkpoint"].append(stable - cq)
        return samples

    def _first_stable_after(self, node, seq, not_before):
        best = None
        for ckpt_seq, t in self._ckpts.get(node, ()):
            if ckpt_seq >= seq and t >= not_before:
                if best is None or t < best:
                    best = t
        return best

    def stats(self):
        """[PhaseStats] for phases that collected at least one sample."""
        out = []
        all_samples = self.phase_samples()
        for phase in PHASES:
            samples = sorted(all_samples[phase])
            if not samples:
                continue
            out.append(
                PhaseStats(
                    phase=phase,
                    count=len(samples),
                    p50=_percentile(samples, 0.50),
                    p95=_percentile(samples, 0.95),
                    p99=_percentile(samples, 0.99),
                )
            )
        return out

    def table(self):
        """ASCII latency table (ms) for the CLI."""
        rows = self.stats()
        lines = [
            f"{'phase':<12} {'count':>7} {'p50_ms':>10} "
            f"{'p95_ms':>10} {'p99_ms':>10}",
            "-" * 53,
        ]
        if not rows:
            lines.append("(no milestone events collected)")
        for s in rows:
            lines.append(
                f"{s.phase:<12} {s.count:>7} {s.p50:>10.3f} "
                f"{s.p95:>10.3f} {s.p99:>10.3f}"
            )
        return "\n".join(lines)
