"""Timeline-diff regression gate: compare two trace/bench artifacts.

``python -m mirbft_tpu_torch.obsv --diff A B [--threshold PCT]`` loads two
artifacts, extracts a flat ``{series_name: value}`` mapping from each,
and reports per-series deltas with a machine-readable verdict.  Exit
status is the gate: nonzero iff any gated series regressed by at least
the threshold (so CI can chain BENCH_r*.json artifacts rung-to-rung).

Supported artifact shapes (auto-detected):

- **Chrome trace JSON** (``traceEvents`` key): fed through the
  consensus TimelineProfiler; series are
  ``phase.<name>.{p50,p95,p99}_ms`` plus ``phase.<name>.count``.
- **bench.py JSON** (``metric``/``stages`` keys): numeric top-level
  fields (rates, p99s, walls), per-stage ``seconds`` from ``stages``,
  and per-stage engine gauges from ``engine_gauges``.  A nested
  ``loadgen`` SLO artifact (the live_mp_* rungs embed one) contributes
  its per-step series too.
- **loadgen SLO JSON** (``schema: mirbft-loadgen-slo/…``): per
  arrival-rate step, ``step.<name>.{goodput_per_sec,p50_ms,p95_ms,
  p99_ms,committed_reqs,…}`` — so a latency-SLO regression between two
  load runs gates exactly like a timeline regression (``duplicates``
  and ``timed_out`` are reported as informational).
- **capacity JSON** (``schema: mirbft-capacity/…``, or nested under a
  bench JSON's ``capacity`` key): per config,
  ``knee.<config>.knee_rate_per_sec`` (a knee moving *down* gates) and
  ``knee.<config>.p95_at_knee_ms``, plus the headline
  ``knee_rate_per_sec``.

Direction is inferred per series name: throughput-like series
(``per_sec``, ``rate``, ``count``, ``events``) regress when they *drop*;
latency-like series (``p50/p95/p99``, ``ms``, ``seconds``, ``wall``)
regress when they *rise*; anything else is reported but never gates.

Resource-leak gating: when artifact B carries leak verdicts (a bench
JSON with a ``soak.leak`` mapping, or a standalone ``mirbft-soak/…``
artifact), any metric whose verdict is ``growing`` is a
``leak_failures`` entry and fails the diff exactly like a p95
regression — RSS or on-disk growth gates PRs, not just speed.

Device-plane gating: a bench ``device`` section contributes
``device.<fn>.retraces`` (gated: retrace *growth* between rungs is a
regression) and kernel timing series, and three absolute failures —
a retrace-budget breach in B, any shadow-oracle divergence recorded in
B, or a nonzero ``soak.divergence`` count — land in
``device_failures`` and fail the diff regardless of A.

Recovery: ``load_artifact`` accepts either a bench summary JSON or a
``BENCH_stream.jsonl`` journal (auto-detected) — when the summary is
missing or torn (rc=124 runs), the journal's ``final`` line or, failing
that, its stage lines reconstruct the artifact, so the perf trajectory
is never empty.
"""

from __future__ import annotations

import json

from .timeline import TimelineProfiler

DEFAULT_THRESHOLD_PCT = 10.0

_HIGHER_BETTER = ("per_sec", "rate", "count", "events", "reqs", "verified")
_LOWER_BETTER = (
    "p50", "p95", "p99", "_ms", "ms_", "seconds", "wall", "sim_ms", "retrace",
)


def direction(name):
    """'higher', 'lower', or None (informational only)."""
    lowered = name.lower()
    if any(tok in lowered for tok in _HIGHER_BETTER):
        return "higher"
    if any(tok in lowered for tok in _LOWER_BETTER):
        return "lower"
    return None


def _loadgen_series(doc, prefix=""):
    """Per-step series from a ``mirbft-loadgen-slo`` artifact.  The
    ``committed`` count is exposed as ``committed_reqs`` so the
    direction rules read it as throughput-like; ``duplicates`` and
    ``timed_out`` match no direction token and stay informational."""
    series = {}
    for step in doc.get("steps") or []:
        base = f"{prefix}step.{step.get('name', 'step')}."
        for key, out in (
            ("offered_rate_per_sec", "offered_rate_per_sec"),
            ("goodput_per_sec", "goodput_per_sec"),
            ("p50_ms", "p50_ms"),
            ("p95_ms", "p95_ms"),
            ("p99_ms", "p99_ms"),
            ("committed", "committed_reqs"),
            ("duplicates", "duplicates"),
            ("timed_out", "timed_out"),
            # KV app-rung splits (present only in app workload artifacts);
            # the *_ms / goodput_per_sec suffixes reuse the existing
            # direction tokens, so these gate without new rules.
            ("read_p50_ms", "read_p50_ms"),
            ("read_p95_ms", "read_p95_ms"),
            ("read_p99_ms", "read_p99_ms"),
            ("write_p50_ms", "write_p50_ms"),
            ("write_p95_ms", "write_p95_ms"),
            ("write_p99_ms", "write_p99_ms"),
            ("read_goodput_per_sec", "read_goodput_per_sec"),
            ("write_goodput_per_sec", "write_goodput_per_sec"),
            ("reads_failed", "reads_failed"),
        ):
            value = step.get(key)
            if isinstance(value, (int, float)) and not isinstance(value, bool):
                series[base + out] = float(value)
    return series


def _capacity_series(doc, prefix=""):
    """Series from a ``mirbft-capacity`` artifact (loadgen/knee.py).

    ``knee_rate_per_sec`` carries the ``per_sec`` token, so a knee that
    moves down between artifacts gates as a regression exactly like a
    p95 rise; ``p95_at_knee_ms`` (the p95 of the highest passing step)
    gates lower-is-better.  A config whose knee was not located within
    budget contributes no knee series (absent, not zero — a located
    knee appearing later must not diff against a fake 0).
    """
    series = {}
    top = doc.get("knee_rate_per_sec")
    if isinstance(top, (int, float)) and not isinstance(top, bool):
        series[f"{prefix}knee_rate_per_sec"] = float(top)
    for config in doc.get("configs") or []:
        name = config.get("config", "config")
        knee = config.get("knee_rate_per_sec")
        if isinstance(knee, (int, float)) and not isinstance(knee, bool):
            series[f"{prefix}knee.{name}.knee_rate_per_sec"] = float(knee)
        passing = [
            s
            for s in config.get("steps") or []
            if s.get("ok") and isinstance(s.get("rate_per_sec"), (int, float))
        ]
        if passing:
            at_knee = max(passing, key=lambda s: s["rate_per_sec"])
            p95 = at_knee.get("p95_ms")
            if isinstance(p95, (int, float)) and not isinstance(p95, bool):
                series[f"{prefix}knee.{name}.p95_at_knee_ms"] = float(p95)
    return series


def extract_series(artifact):
    """Flatten one parsed artifact into ``{series_name: float}``."""
    if str(artifact.get("schema", "")).startswith("mirbft-loadgen-slo"):
        return _loadgen_series(artifact)
    if str(artifact.get("schema", "")).startswith("mirbft-capacity"):
        return _capacity_series(artifact)
    if "traceEvents" in artifact:
        profiler = TimelineProfiler.from_chrome_trace(artifact)
        series = {}
        for stats in profiler.stats():
            series[f"phase.{stats.phase}.count"] = float(stats.count)
            series[f"phase.{stats.phase}.p50_ms"] = stats.p50
            series[f"phase.{stats.phase}.p95_ms"] = stats.p95
            series[f"phase.{stats.phase}.p99_ms"] = stats.p99
        return series
    series = {}
    for key, value in artifact.items():
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            series[key] = float(value)
    for stage, info in (artifact.get("stages") or {}).items():
        seconds = (info or {}).get("seconds")
        if isinstance(seconds, (int, float)):
            series[f"stage.{stage}.seconds"] = float(seconds)
    for stage, gauges in (artifact.get("engine_gauges") or {}).items():
        for gauge, value in (gauges or {}).items():
            if isinstance(value, (int, float)):
                series[f"engine.{stage}.{gauge}"] = float(value)
    loadgen_doc = artifact.get("loadgen")
    if isinstance(loadgen_doc, dict):
        series.update(_loadgen_series(loadgen_doc, prefix="loadgen."))
    app_doc = artifact.get("loadgen_app")
    if isinstance(app_doc, dict):
        series.update(_loadgen_series(app_doc, prefix="loadgen_app."))
    capacity_doc = artifact.get("capacity")
    if isinstance(capacity_doc, dict):
        series.update(_capacity_series(capacity_doc, prefix="capacity."))
    device = artifact.get("device")
    if isinstance(device, dict):
        for fn, n in sorted((device.get("retraces") or {}).items()):
            if isinstance(n, (int, float)) and not isinstance(n, bool):
                series[f"device.{fn}.retraces"] = float(n)
        for kernel, info in sorted((device.get("kernel_seconds") or {}).items()):
            mean = (info or {}).get("mean_ms")
            if isinstance(mean, (int, float)) and not isinstance(mean, bool):
                series[f"device.{kernel}.mean_ms"] = float(mean)
            calls = (info or {}).get("count")
            if isinstance(calls, (int, float)) and not isinstance(calls, bool):
                # "calls" deliberately matches no direction token: launch
                # counts vary run-to-run and must not gate.
                series[f"device.{kernel}.calls"] = float(calls)
        for dirn, n in sorted((device.get("transfer_bytes") or {}).items()):
            if isinstance(n, (int, float)) and not isinstance(n, bool):
                series[f"device.transfer.{dirn}"] = float(n)
    for metric, verdict in sorted(extract_leaks(artifact).items()):
        for key in ("first", "last", "rel_pct_per_min"):
            value = verdict.get(key)
            if isinstance(value, (int, float)) and not isinstance(value, bool):
                series[f"soak.{metric}.{key}"] = float(value)
    return series


def extract_leaks(artifact):
    """``{metric: leak_verdict_dict}`` from a bench or soak artifact.

    Bench JSON nests the verdicts under ``soak.leak``; a standalone
    soak artifact (``schema: mirbft-soak/…``) carries ``leak`` at the
    top level.  Anything else yields an empty mapping.
    """
    if str(artifact.get("schema", "")).startswith("mirbft-soak"):
        leaks = artifact.get("leak") or {}
    else:
        soak = artifact.get("soak")
        leaks = (soak.get("leak") or {}) if isinstance(soak, dict) else {}
    return {
        name: verdict
        for name, verdict in leaks.items()
        if isinstance(verdict, dict)
    }


def diff_series(a, b, threshold_pct=DEFAULT_THRESHOLD_PCT):
    """Compare two series maps; returns the verdict dict.

    ``delta_pct`` is signed toward "worse": positive means B regressed
    relative to A by that percentage, regardless of direction.
    """
    regressions = []
    improvements = []
    unchanged = []
    informational = []
    for name in sorted(set(a) & set(b)):
        va, vb = a[name], b[name]
        dirn = direction(name)
        if va == vb:
            unchanged.append(name)
            continue
        if va == 0:
            # No baseline to take a percentage of; report, never gate.
            informational.append({"series": name, "a": va, "b": vb})
            continue
        raw_pct = (vb - va) / abs(va) * 100.0
        if dirn is None:
            informational.append(
                {"series": name, "a": va, "b": vb, "change_pct": raw_pct}
            )
            continue
        worse_pct = raw_pct if dirn == "lower" else -raw_pct
        entry = {
            "series": name,
            "a": va,
            "b": vb,
            "direction": dirn,
            "delta_pct": worse_pct,
        }
        if worse_pct >= threshold_pct:
            regressions.append(entry)
        else:
            improvements.append(entry)
    return {
        "threshold_pct": threshold_pct,
        "ok": not regressions,
        "regressions": regressions,
        "improvements": improvements,
        "unchanged": unchanged,
        "informational": informational,
        "only_a": sorted(set(a) - set(b)),
        "only_b": sorted(set(b) - set(a)),
    }


def recover_stream(path):
    """Reconstruct a bench artifact from a ``BENCH_stream.jsonl`` journal.

    The ``final`` line, when present, IS the artifact.  Otherwise (the
    run was killed mid-flight) the stage lines rebuild a reduced
    artifact — per-stage seconds/status/compile_s — under the schema
    ``mirbft-bench-recovered/1`` with ``recovered: true`` so consumers
    can tell a rescued rung from a clean one.  Torn trailing lines
    (SIGKILL mid-write) are skipped, not fatal.
    """
    header = None
    final = None
    stages = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # torn tail line from a killed run
            if not isinstance(rec, dict):
                continue
            kind = rec.get("kind")
            if kind == "header":
                header = rec
            elif kind == "stage":
                name = rec.get("stage", "?")
                stages[name] = {
                    k: v
                    for k, v in rec.items()
                    if k not in ("kind", "stage", "schema")
                }
            elif kind == "final" and isinstance(rec.get("payload"), dict):
                final = rec["payload"]
    if final is not None:
        return final
    doc = {
        "schema": "mirbft-bench-recovered/1",
        "recovered": True,
        "stages": stages,
    }
    if header is not None:
        doc["pid"] = header.get("pid")
    return doc


def load_artifact(path):
    """Load one artifact: a JSON document, or a bench-stream journal
    (``.jsonl`` — or any file whose body is line-JSON) recovered via
    :func:`recover_stream`."""
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except ValueError:
        return recover_stream(path)
    if isinstance(doc, dict) and doc.get("kind") == "header" and str(
        doc.get("schema", "")
    ).startswith("mirbft-bench-stream"):
        # A one-line journal (header only, run died before any stage).
        return recover_stream(path)
    if isinstance(doc, dict) and isinstance(doc.get("parsed"), dict) and (
        "cmd" in doc and "rc" in doc
    ):
        # A committed BENCH_r*.json wrapper ({n, cmd, rc, tail, parsed}):
        # the bench payload lives under "parsed" — diff that, so the
        # PR-over-PR gate compares the actual series instead of the
        # wrapper's bookkeeping fields.
        return doc["parsed"]
    return doc


def diff_files(path_a, path_b, threshold_pct=DEFAULT_THRESHOLD_PCT):
    """Load, extract, and diff two artifact files (summary JSON or
    bench-stream journals — see :func:`load_artifact`)."""
    a = load_artifact(path_a)
    b = load_artifact(path_b)
    report = diff_series(
        extract_series(a), extract_series(b), threshold_pct=threshold_pct
    )
    apply_leak_gate(report, b)
    apply_device_gate(report, b)
    report["a"] = str(path_a)
    report["b"] = str(path_b)
    return report


def apply_leak_gate(report, artifact_b):
    """Fold B's leak verdicts into a diff report (in place).

    A ``growing`` verdict in the *new* artifact fails the gate
    regardless of what A looked like — a leak is absolute, not
    relative.  Verdicts from A are irrelevant: they gated A's own PR.
    """
    failures = []
    for metric, verdict in sorted(extract_leaks(artifact_b).items()):
        if verdict.get("verdict") == "growing":
            failures.append(
                {
                    "series": f"soak.{metric}",
                    "verdict": "growing",
                    "confidence": verdict.get("confidence"),
                    "rel_pct_per_min": verdict.get("rel_pct_per_min"),
                    "first": verdict.get("first"),
                    "last": verdict.get("last"),
                }
            )
    report["leak_failures"] = failures
    report["ok"] = report["ok"] and not failures
    return report


def apply_device_gate(report, artifact_b):
    """Fold B's device-plane verdicts into a diff report (in place).

    Absolute failures, like leaks: a retrace-budget breach or any
    recorded scalar/vector divergence in the *new* artifact fails the
    gate regardless of A."""
    failures = []
    device = artifact_b.get("device")
    if isinstance(device, dict):
        budget = device.get("retrace_budget")
        retraces = device.get("retraces") or {}
        for fn in device.get("retrace_breaches") or ():
            failures.append(
                {
                    "series": f"device.{fn}.retraces",
                    "kind": "retrace_budget",
                    "count": retraces.get(fn),
                    "budget": budget,
                }
            )
        total = device.get("divergence_total")
        if isinstance(total, (int, float)) and total > 0:
            failures.append(
                {
                    "series": "device.divergence_total",
                    "kind": "divergence",
                    "count": total,
                }
            )
    soak = artifact_b.get("soak")
    if isinstance(soak, dict):
        div = soak.get("divergence")
        if isinstance(div, (int, float)) and div > 0:
            failures.append(
                {
                    "series": "soak.divergence",
                    "kind": "divergence",
                    "count": div,
                }
            )
    report["device_failures"] = failures
    report["ok"] = report["ok"] and not failures
    return report


def render_report(report):
    """Human-readable summary lines for the CLI."""
    lines = [
        f"diff {report.get('a', 'A')} -> {report.get('b', 'B')} "
        f"(threshold {report['threshold_pct']:g}%)"
    ]
    for entry in report["regressions"]:
        lines.append(
            f"  REGRESSED {entry['series']}: {entry['a']:g} -> {entry['b']:g} "
            f"({entry['delta_pct']:+.1f}% worse)"
        )
    for entry in report["improvements"]:
        lines.append(
            f"  ok        {entry['series']}: {entry['a']:g} -> {entry['b']:g} "
            f"({entry['delta_pct']:+.1f}% worse)"
        )
    for entry in report.get("leak_failures", ()):
        lines.append(
            f"  LEAK      {entry['series']}: {entry['first']:g} -> "
            f"{entry['last']:g} ({entry['rel_pct_per_min']:+.1f}%/min, "
            f"confidence {entry['confidence']:.2f})"
        )
    for entry in report.get("device_failures", ()):
        if entry["kind"] == "retrace_budget":
            lines.append(
                f"  DEVICE    {entry['series']}: {entry['count']} retraces "
                f"(budget {entry['budget']})"
            )
        else:
            lines.append(
                f"  DEVICE    {entry['series']}: {entry['count']} "
                "scalar/vector divergence(s)"
            )
    lines.append(
        f"  unchanged: {len(report['unchanged'])}  "
        f"informational: {len(report['informational'])}  "
        f"only-in-one: {len(report['only_a']) + len(report['only_b'])}"
    )
    verdict = "ok"
    if report["regressions"]:
        verdict = "REGRESSION"
    elif report.get("leak_failures"):
        verdict = "LEAK"
    elif report.get("device_failures"):
        verdict = "DEVICE"
    lines.append("VERDICT: " + verdict)
    return "\n".join(lines)
