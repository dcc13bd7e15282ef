"""The latency-SLO gate and its timeline-compatible artifact.

A load run reduces to a JSON artifact (schema ``mirbft-loadgen-slo/1``)
holding, per arrival-rate step, the offered rate, goodput, duplicate
count, and the p50/p95/p99 submit→commit latencies.  The artifact is a
first-class ``obsv --diff`` input: ``obsv.diff.extract_series`` flattens
it to ``step.<name>.<metric>`` series, the higher-/lower-is-better
direction rules already understand ``goodput_per_sec`` and ``*_ms``,
and the diff CLI exits nonzero on regression — the same gate the
timeline profiles use, pointed at latency SLOs.

``check_slo`` is the absolute gate (this artifact against fixed
bounds); ``obsv --diff`` is the relative gate (this artifact against a
baseline artifact).  bench.py's ``live_mp_*`` rung embeds the artifact
under the run payload's ``"loadgen"`` key so one bench JSON carries
both views.
"""

from __future__ import annotations

import json

SCHEMA = "mirbft-loadgen-slo/1"


# Per-step read/write latency split, present only when the step object
# carries it (the KV app rung's KvStepResult does; the raw-bytes
# generator's StepResult does not) — consumers must treat these keys as
# optional.
_RW_KEYS = (
    "reads",
    "reads_failed",
    "writes",
    "read_goodput_per_sec",
    "write_goodput_per_sec",
    "read_p50_ms",
    "read_p95_ms",
    "read_p99_ms",
    "write_p50_ms",
    "write_p95_ms",
    "write_p99_ms",
)


def artifact(steps: list, **meta) -> dict:
    """Assemble the SLO artifact from ``StepResult``s (or any objects
    with the same fields)."""
    docs = []
    for step in steps:
        entry = {
            "name": step.name,
            "offered_rate_per_sec": step.offered_rate_per_sec,
            "duration_s": step.duration_s,
            "submitted": step.submitted,
            "duplicates": step.duplicates,
            "committed": step.committed,
            "timed_out": step.timed_out,
            "goodput_per_sec": step.goodput_per_sec,
            "p50_ms": step.p50_ms,
            "p95_ms": step.p95_ms,
            "p99_ms": step.p99_ms,
        }
        for key in _RW_KEYS:
            value = getattr(step, key, None)
            if value is not None:
                entry[key] = value
        docs.append(entry)
    doc = {"schema": SCHEMA, "steps": docs}
    if meta:
        doc["meta"] = dict(meta)
    return doc


def write_artifact(path: str, doc: dict) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")


def load_artifact(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as fh:
        doc = json.load(fh)
    if not str(doc.get("schema", "")).startswith("mirbft-loadgen-slo"):
        raise ValueError(f"{path} is not a loadgen SLO artifact")
    return doc


def check_slo(
    doc: dict,
    p95_ms: float | None = None,
    p99_ms: float | None = None,
    min_goodput_ratio: float = 0.0,
    max_timed_out: int = 0,
) -> list:
    """Absolute gate: every step must meet the latency bounds, commit at
    least ``min_goodput_ratio`` of its offered rate, and strand at most
    ``max_timed_out`` requests.  Returns violation strings (empty =
    pass)."""
    violations = []
    for step in doc["steps"]:
        name = step["name"]
        if p95_ms is not None and step["p95_ms"] > p95_ms:
            violations.append(
                f"{name}: p95 {step['p95_ms']:.1f}ms > SLO {p95_ms:.1f}ms"
            )
        if p99_ms is not None and step["p99_ms"] > p99_ms:
            violations.append(
                f"{name}: p99 {step['p99_ms']:.1f}ms > SLO {p99_ms:.1f}ms"
            )
        floor = step["offered_rate_per_sec"] * min_goodput_ratio
        if step["goodput_per_sec"] < floor:
            violations.append(
                f"{name}: goodput {step['goodput_per_sec']:.1f}/s below "
                f"{min_goodput_ratio:.0%} of offered "
                f"{step['offered_rate_per_sec']:.1f}/s"
            )
        if step["timed_out"] > max_timed_out:
            violations.append(
                f"{name}: {step['timed_out']} requests never committed "
                f"(allowed: {max_timed_out})"
            )
    return violations
