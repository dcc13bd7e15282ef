"""The knee finder: max-sustainable-rate-at-SLO capacity search.

PBFT's evaluation warns that throughput collapses past saturation;
Mir-BFT's plots the same cliff at WAN scale.  This module locates our
cliff — the *knee* — by stepping an arrival-rate measurement until the
latency SLO's p95 breaks, then binary-searching the break point.  The
measurement itself is injected (``measure(rate) -> StepResult``-duck),
so the search is unit-testable against synthetic latency/rate curves
and the bench rung supplies a real ``LoadGenerator.run_step`` closure.

The output is the ``mirbft-capacity/1`` artifact: per config
(lan/wan profile × serial/pipelined processor) the measured
rate→p50/p95/p99 curve, the knee rate, and — when the caller provides
it — the per-phase critical-path attribution at the knee
(obsv/critpath.py).  ``obsv --diff`` gates ``knee_rate_per_sec``
PR-over-PR exactly like a p95 regression: the series name carries the
``per_sec`` token, so a knee that moves down fails the diff.
"""

from __future__ import annotations

from dataclasses import dataclass, field

SCHEMA = "mirbft-capacity/1"


@dataclass
class KneeResult:
    """One config's capacity search outcome."""

    slo_p95_ms: float
    steps: list = field(default_factory=list)  # measurement dicts, in order
    knee_rate_per_sec: float | None = None  # highest rate meeting the SLO
    located: bool = False  # False: SLO never broke within the budget

    @property
    def max_measured_ok(self) -> float:
        """Highest rate that passed (0.0 if none did)."""
        return max(
            (s["rate_per_sec"] for s in self.steps if s["ok"]), default=0.0
        )


def _step_doc(rate, result, ok):
    return {
        "rate_per_sec": float(rate),
        "p50_ms": float(getattr(result, "p50_ms", 0.0)),
        "p95_ms": float(getattr(result, "p95_ms", 0.0)),
        "p99_ms": float(getattr(result, "p99_ms", 0.0)),
        "goodput_per_sec": float(getattr(result, "goodput_per_sec", 0.0)),
        "committed": int(getattr(result, "committed", 0)),
        "ok": bool(ok),
    }


def find_knee(
    measure,
    start_rate: float,
    slo_p95_ms: float,
    *,
    step_factor: float = 2.0,
    max_rate: float = float("inf"),
    max_steps: int = 12,
    resolution: float = 0.15,
    min_goodput_ratio: float = 0.0,
) -> KneeResult:
    """Locate the max sustainable rate whose measured p95 meets the SLO.

    Phase 1 ramps geometrically from ``start_rate`` by ``step_factor``
    until a measurement breaks the SLO (p95 above ``slo_p95_ms``, or
    nothing committed), ``max_rate`` is cleared, or ``max_steps``
    measurements are spent.  Phase 2 binary-searches between the last
    passing and first failing rates until the bracket is within
    ``resolution`` (relative) or the budget runs out; the knee is the
    highest passing rate.

    ``min_goodput_ratio`` additionally requires goodput to keep up with
    the offered rate: past hard saturation almost nothing commits, so
    the p95 of the few survivors is a tiny-sample lottery that can land
    under the SLO and read as a pass.  Requiring
    ``goodput >= ratio * rate`` makes the collapse fail the probe
    regardless of how the surviving sample's percentile falls.

    No knee within budget — the SLO never broke — returns
    ``located=False`` with ``knee_rate_per_sec=None``: the honest
    verdict, not a fabricated knee (the caller should widen
    ``max_rate`` or the step budget).  Symmetrically, if *no* probe
    ever passes (the SLO never held, even as the search descends toward
    zero), the result is also ``located=False``: a knee of 0.0 is not a
    capacity, it is a wedged or starved cluster, and it must not drag
    down the artifact's min-across-configs headline.
    """
    result = KneeResult(slo_p95_ms=slo_p95_ms)

    def probe(rate):
        step = measure(rate)
        ok = (
            getattr(step, "committed", 0) > 0
            and getattr(step, "p95_ms", float("inf")) <= slo_p95_ms
            and getattr(step, "goodput_per_sec", 0.0)
            >= min_goodput_ratio * rate
        )
        result.steps.append(_step_doc(rate, step, ok))
        return ok

    # Phase 1: geometric ramp to bracket the knee.
    rate = float(start_rate)
    last_pass = None
    first_fail = None
    while len(result.steps) < max_steps:
        if probe(rate):
            last_pass = rate
            next_rate = rate * step_factor
            if next_rate > max_rate:
                break
            rate = next_rate
        else:
            first_fail = rate
            break

    if first_fail is None:
        # SLO never broke: no knee within the rate/step budget.
        result.knee_rate_per_sec = None
        result.located = False
        return result

    # Phase 2: binary search inside (last_pass, first_fail).
    lo = last_pass if last_pass is not None else 0.0
    hi = first_fail
    while len(result.steps) < max_steps and (hi - lo) > resolution * hi:
        mid = (lo + hi) / 2.0
        if mid <= 0.0:
            break
        if probe(mid):
            lo = mid
        else:
            hi = mid
    if last_pass is None and lo == 0.0:
        # Every probe failed, including the binary search's descent
        # toward zero: the SLO never *held*, so there is no sustainable
        # rate to report.  Claiming a located knee of 0.0 would poison
        # the artifact's min-across-configs headline with a number that
        # reflects a wedged or starved cluster, not a capacity.
        result.knee_rate_per_sec = None
        result.located = False
        return result
    result.knee_rate_per_sec = lo
    result.located = True
    return result


def config_doc(
    name: str,
    result: KneeResult,
    *,
    profile: str | None = None,
    processor: str | None = None,
    attribution=None,
    **extra,
) -> dict:
    """One config's entry for the capacity artifact."""
    doc = {
        "config": name,
        "slo_p95_ms": result.slo_p95_ms,
        "located": result.located,
        "knee_rate_per_sec": result.knee_rate_per_sec,
        "steps": list(result.steps),
    }
    if profile is not None:
        doc["profile"] = profile
    if processor is not None:
        doc["processor"] = processor
    if attribution is not None:
        # obsv.critpath.attribute() output at the knee: which phase
        # dominated each latency band, and on which node.
        doc["attribution"] = attribution
    doc.update(extra)
    return doc


def artifact(configs: list, **meta) -> dict:
    """Assemble the ``mirbft-capacity/1`` artifact.

    The headline ``knee_rate_per_sec`` is the *minimum* located knee
    across configs — the cluster is only as fast as its slowest
    configuration, and the diff gate should catch any config's knee
    moving down even when the others hold.
    """
    located = [
        c["knee_rate_per_sec"]
        for c in configs
        if c.get("located") and c.get("knee_rate_per_sec") is not None
    ]
    doc = {
        "schema": SCHEMA,
        "configs": list(configs),
        "knee_rate_per_sec": min(located) if located else None,
    }
    if meta:
        doc["meta"] = dict(meta)
    return doc
