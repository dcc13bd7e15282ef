"""The port's observability plane (``mirbft_tpu_torch/obsv``) held against
the JAX package's (``mirbft_tpu/obsv``) on the same inputs.

Mirrors ``tests/test_obsv.py``: every case runs once through each package
and the outputs must be equal exactly — registry snapshots and
expositions, trace events (their names, phases, ids and arguments; the
tracer's ``ts``/``dur`` are wall clock and are held only to the original
case's bounds), timeline tables in simulated ms, merged traces' lanes and
flows, diff reports, the CLI's exit codes and JSON verdicts, the node's
HTTP endpoints.  The port's engine runs its digests on the SHA-256
kernel's plain version (``AsyncKernelHashPlane(device="cpu")``); its CLI
with ``--device cpu``.  Two parity checks come on top: both packages'
``extract_series`` on every committed ``BENCH_r0*.json``, and the CLI's
phase table of the same seeded run in each package.  Last, the port's
live rung traced at a small size: its exporters scraped mid-run, its
per-process traces stamped with the hellos' clock offsets, their ledger.

``tests/test_obsv.py:296`` (``test_chaos_recovery_metric_matches_report``)
drives the chaos runner; its mirror is in ``tests/test_torch_chaos_mirrors.py``
with the chaos runner's other mirrors.

Every case that enables a package's process-global hooks disables them in
a ``finally``.
"""

import importlib
import json
import queue as stdlib_queue
import socket
import subprocess
import sys
import time
import types
from pathlib import Path
from urllib.error import HTTPError
from urllib.request import urlopen

import pytest

REPO = Path(__file__).resolve().parent.parent
BENCH_FILES = sorted(REPO.glob("BENCH_r0*.json"))


def _package(root):
    """The modules a case needs from one package, by the same names."""
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    ns = types.SimpleNamespace(
        root=root,
        hooks=mod("obsv.hooks"),
        metrics=mod("obsv.metrics"),
        trace=mod("obsv.trace"),
        timeline=mod("obsv.timeline"),
        merge=mod("obsv.merge"),
        diff=mod("obsv.diff"),
        exporter=mod("obsv.exporter"),
        bqueue=mod("obsv.bqueue"),
        status=mod("status"),
        engine=mod("testengine.engine"),
        manglers=mod("testengine.manglers"),
        config=mod("runtime.config"),
        node=mod("runtime.node"),
    )
    return ns


JAX = _package("mirbft_tpu")
TORCH = _package("mirbft_tpu_torch")
BOTH = (JAX, TORCH)


def recorder(p, *args, **kwargs):
    """The package's BasicRecorder; the port's on the kernel's plain
    version."""
    if p is TORCH:
        from mirbft_tpu_torch.testengine.crypto_plane import (
            AsyncKernelHashPlane,
        )

        kwargs.setdefault("hash_plane", AsyncKernelHashPlane(device="cpu"))
    return p.engine.BasicRecorder(*args, **kwargs)


def same(fn):
    """Run ``fn`` on each package; the results must be equal."""
    jax_out, torch_out = fn(JAX), fn(TORCH)
    assert torch_out == jax_out
    return torch_out


def untimed(events):
    """Trace events without their wall-clock stamps."""
    return [
        {k: v for k, v in e.items() if k not in ("ts", "dur")} for e in events
    ]


# ---------------------------------------------------------------------------
# Registry semantics
# ---------------------------------------------------------------------------


def test_counter_gauge_histogram_basics():
    def case(p):
        reg = p.metrics.Registry(strict=False)
        c = reg.counter("c_total")
        c.inc()
        c.inc(4)
        assert c.value == 5
        assert reg.counter("c_total") is c
        g = reg.gauge("g")
        g.set(2.5)
        h = reg.histogram("h_seconds", buckets=(0.1, 1.0))
        for v in (0.05, 0.5, 50.0):
            h.observe(v)
        assert h.sum == pytest.approx(50.55)
        return c.value, g.value, h.count, h.bucket_counts, reg.snapshot()

    assert same(case)[:4] == (5, 2.5, 3, [1, 1])


def test_labels_key_distinct_series():
    def case(p):
        reg = p.metrics.Registry(strict=False)
        a = reg.counter("x_total", path="device")
        b = reg.counter("x_total", path="host")
        a.inc(3)
        b.inc(1)
        assert a is not b
        assert reg.counter("x_total", path="device") is a
        return reg.snapshot()["x_total"]

    snap = same(case)
    assert snap["kind"] == "counter"
    assert {s["labels"]["path"]: s["value"] for s in snap["series"]} == {
        "device": 3, "host": 1}


def test_strict_registry_rejects_uncataloged_names():
    def case(p):
        reg = p.metrics.Registry()
        with pytest.raises(KeyError):
            reg.counter("mirbft_not_a_real_metric_total")
        reg.counter("mirbft_wal_appends_total").inc()
        return reg.snapshot()

    same(case)
    assert TORCH.metrics.CATALOG == JAX.metrics.CATALOG
    assert TORCH.metrics.CATALOG_LABELS == JAX.metrics.CATALOG_LABELS


def test_kind_mismatch_raises():
    def case(p):
        reg = p.metrics.Registry(strict=False)
        reg.counter("m")
        with pytest.raises(TypeError):
            reg.gauge("m")
        return reg.snapshot()

    same(case)


def test_null_registry_is_shared_noop_singletons():
    def case(p):
        m = p.metrics
        reg = m.null_registry()
        assert reg is m.null_registry()
        assert reg.counter("anything", a="b") is m.NULL_COUNTER
        assert reg.gauge("anything") is m.NULL_GAUGE
        assert reg.histogram("anything") is m.NULL_HISTOGRAM
        m.NULL_COUNTER.inc(10)
        m.NULL_GAUGE.set(3)
        m.NULL_HISTOGRAM.observe(1.0)
        return m.NULL_COUNTER.value, reg.snapshot(), reg.prometheus_text()

    assert same(case) == (0, {}, "")


def test_prometheus_exposition_format():
    def case(p):
        reg = p.metrics.Registry(strict=False)
        reg.counter("req_total", path="device").inc(7)
        h = reg.histogram("lat_seconds", buckets=(0.1, 1.0))
        for v in (0.05, 0.5, 5.0):
            h.observe(v)
        return reg.prometheus_text()

    text = same(case)
    lines = text.splitlines()
    assert "# TYPE req_total counter" in lines
    assert 'req_total{path="device"} 7' in lines
    assert "# TYPE lat_seconds histogram" in lines
    assert 'lat_seconds_bucket{le="0.1"} 1' in lines
    assert 'lat_seconds_bucket{le="1.0"} 2' in lines
    assert 'lat_seconds_bucket{le="+Inf"} 3' in lines
    assert "lat_seconds_count 3" in lines
    assert any(line.startswith("lat_seconds_sum ") for line in lines)
    assert text.endswith("\n")


def test_json_dump_round_trips():
    def case(p):
        reg = p.metrics.Registry(strict=False)
        reg.gauge("g", scenario='a b"c').set(1)
        return json.loads(reg.to_json())

    parsed = same(case)
    assert parsed["g"]["series"][0]["labels"] == {"scenario": 'a b"c'}


# ---------------------------------------------------------------------------
# Tracer / Chrome trace validity
# ---------------------------------------------------------------------------


def _assert_well_nested(events):
    by_tid = {}
    for e in events:
        if e["ph"] == "X":
            by_tid.setdefault(e["tid"], []).append((e["ts"], e["ts"] + e["dur"]))
    for spans in by_tid.values():
        for i, (s1, e1) in enumerate(spans):
            for s2, e2 in spans[i + 1:]:
                overlap = max(s1, s2) < min(e1, e2)
                contained = (s1 <= s2 and e2 <= e1) or (s2 <= s1 and e1 <= e2)
                assert not overlap or contained, (spans,)


def test_chrome_trace_is_valid_and_nested(tmp_path):
    def case(p):
        tracer = p.trace.Tracer()
        tracer.name_thread(0, "node 0")
        with tracer.span("outer", cat="t", tid=0):
            with tracer.span("inner", cat="t", tid=0):
                pass
            tracer.instant("mark", cat="consensus", tid=0, args={"seq": 1})
        with tracer.span("later", cat="t", tid=0):
            pass
        out = tmp_path / f"{p.root}.json"
        tracer.write(str(out))
        events = json.loads(out.read_text())["traceEvents"]
        xs = [e for e in events if e["ph"] == "X"]
        for e in xs:
            assert e["ts"] >= 0 and e["dur"] >= 0
        by_name = {e["name"]: e for e in xs}
        assert by_name["later"]["ts"] >= (
            by_name["outer"]["ts"] + by_name["outer"]["dur"])
        _assert_well_nested(events)
        return untimed(events)

    events = same(case)
    meta = [e for e in events if e["ph"] == "M"]
    assert meta and meta[0]["args"]["name"] == "node 0"
    assert {e["name"] for e in events if e["ph"] == "X"} == {
        "outer", "inner", "later"}
    inst = [e for e in events if e["ph"] == "i"]
    assert inst[0]["s"] == "t" and inst[0]["args"]["seq"] == 1


def test_complete_records_backdated_span():
    def case(p):
        tracer = p.trace.Tracer()
        tracer._t0_ns -= 300_000_000
        tracer.complete("flush", cat="crypto", tid=-1, dur_s=0.25)
        (e,) = tracer.events
        assert e["dur"] == pytest.approx(250_000, rel=0.01)
        assert e["ts"] >= 0
        return untimed(tracer.events)

    assert same(case)[0]["ph"] == "X"


def test_complete_clamps_to_tracer_birth():
    def case(p):
        tracer = p.trace.Tracer()
        tracer.complete("early", dur_s=10.0)
        (e,) = tracer.events
        assert e["ts"] >= 0
        assert e["dur"] < 10.0 * 1e6
        return untimed(tracer.events)

    same(case)


# ---------------------------------------------------------------------------
# Timeline profiler
# ---------------------------------------------------------------------------


def test_timeline_profiler_synthetic_edges():
    def inst(name, node, seq, t):
        return {"ph": "i", "name": name,
                "args": {"node": node, "seq": seq, "sim_ms": t}}

    events = [
        inst("seq.allocated", 0, 1, 0),
        inst("seq.preprepared", 0, 1, 10),
        inst("seq.prepared", 0, 1, 40),
        inst("seq.commit_quorum", 0, 1, 70),
        inst("ckpt.stable", 0, 20, 500),
        inst("seq.allocated", 1, 1, 5),
        inst("seq.preprepared", 1, 1, 25),
    ]

    def case(p):
        prof = p.timeline.TimelineProfiler.from_events(events)
        return ([vars(s) for s in prof.stats()], prof.phase_samples(),
                prof.table())

    stats_list, samples, _table = same(case)
    stats = {s["phase"]: s for s in stats_list}
    assert stats["preprepare"]["count"] == 2
    assert sorted(samples["preprepare"]) == [10, 20]
    assert stats["prepare"]["p50"] == 30
    assert stats["commit"]["p50"] == 30
    assert stats["checkpoint"]["count"] == 1
    assert stats["checkpoint"]["p50"] == 430
    assert TORCH.timeline.PHASES == JAX.timeline.PHASES


def test_timeline_profiler_on_seeded_run():
    def case(p):
        metrics, tracer = p.hooks.enable(trace=True)
        try:
            rec = recorder(p, 4, 4, 30, batch_size=2, seed=0, record=False)
            rec.drain_clients(max_steps=2_000_000)
        finally:
            p.hooks.disable()
        prof = p.timeline.TimelineProfiler.from_tracer(tracer)
        snap = metrics.snapshot()
        assert snap["mirbft_sm_events_total"]["series"]
        assert snap["mirbft_sm_apply_seconds"]["series"][0]["count"] > 0
        prof2 = p.timeline.TimelineProfiler.from_chrome_trace(
            tracer.chrome_trace())
        assert [vars(s) for s in prof2.stats()] == [
            vars(s) for s in prof.stats()]
        return [vars(s) for s in prof.stats()], prof.table(), (
            snap["mirbft_sm_events_total"]["series"])

    stats_list, _table, _events = same(case)
    stats = {s["phase"]: s for s in stats_list}
    assert set(stats) == set(TORCH.timeline.PHASES)
    for s in stats.values():
        assert s["count"] > 0
        assert 0 <= s["p50"] <= s["p95"] <= s["p99"]


def test_disabled_hooks_leave_no_trace():
    def case(p):
        assert not p.hooks.enabled
        rec = recorder(p, 4, 2, 4, batch_size=2, seed=0, record=False)
        events = rec.drain_clients(max_steps=500_000)
        assert p.hooks.metrics is None and p.hooks.tracer is None
        return events

    same(case)


# ---------------------------------------------------------------------------
# Status fold + the manglers' counters
# ---------------------------------------------------------------------------


def test_metrics_status_fold():
    def case(p):
        assert p.status.metrics_status().enabled is False
        reg = p.metrics.Registry(strict=False)
        reg.counter("mirbft_demo_total").inc(2)
        status = p.status.metrics_status(reg)
        assert status.enabled
        assert "mirbft_demo_total" in status.pretty()
        return json.loads(status.to_json()), status.pretty()

    assert same(case)[0]["enabled"] is True


def test_mangler_drop_and_duplicate_counters():
    def case(p):
        m = p.manglers
        dropper = m.rule(m.is_step(), m.percent(20)).drop()
        doubler = m.rule(m.is_step(), m.percent(20)).duplicate(100)
        rec = recorder(p, 4, 2, 4, batch_size=2, seed=3, record=False,
                       manglers=[dropper, doubler])
        events = rec.drain_clients(max_steps=500_000)
        return events, dropper.dropped, doubler.duplicated

    _events, dropped, duplicated = same(case)
    assert dropped > 0 and duplicated > 0


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _cli(root, *args, timeout=300):
    extra = ("--device", "cpu") if root == TORCH.root and not any(
        a.startswith("--diff") or a in ("--critpath", "--merge", "--postmortem")
        for a in args) else ()
    return subprocess.run(
        [sys.executable, "-m", f"{root}.obsv", *args, *extra],
        cwd=REPO, capture_output=True, text=True, timeout=timeout,
    )


def _table(stdout):
    return stdout.split("consensus phase latency (simulated ms):\n", 1)[1]


def test_cli_smoke_writes_trace(tmp_path):
    tables = {}
    for p in BOTH:
        out = tmp_path / f"{p.root}.json"
        proc = _cli(p.root, "--nodes", "4", "--clients", "2", "--reqs", "6",
                    "--trace", str(out))
        assert proc.returncode == 0, proc.stderr
        assert "phase" in proc.stdout and "p99_ms" in proc.stdout
        trace = json.loads(out.read_text())
        assert any(e["ph"] == "i" for e in trace["traceEvents"])
        tables[p.root] = _table(proc.stdout).split("\n\n")[0]
    assert tables[TORCH.root] == tables[JAX.root]


def test_cli_run_phase_table_matches_reference(tmp_path):
    """The CLI's default run (4 nodes, 4 clients x 60, BatchSize 2, seed
    0) with per-node traces: the run line's events and simulated ms and
    the phase table equal the JAX run's exactly; the port's per-node
    traces and their merge hold the same milestones."""
    outs = {}
    for p in BOTH:
        trace_dir = tmp_path / p.root
        proc = _cli(p.root, "--trace-dir", str(trace_dir))
        assert proc.returncode == 0, proc.stderr
        run_line = next(line for line in proc.stdout.splitlines()
                        if line.startswith("run:"))
        outs[p.root] = (run_line.split("-> ")[1],
                        _table(proc.stdout).split("\n\n")[0])
        merged = json.loads((trace_dir / "merged.trace.json").read_text())
        outs[p.root] += (sorted(
            (e["pid"], e["name"], e["args"]["seq"], e["args"]["sim_ms"])
            for e in merged["traceEvents"]
            if e.get("ph") == "i" and e["name"].startswith("seq.")),)
    assert outs[TORCH.root] == outs[JAX.root]
    assert outs[TORCH.root][0] == "468 events, sim 4190 ms"


# ---------------------------------------------------------------------------
# Flow events, per-node traces, merge
# ---------------------------------------------------------------------------


def _flow_records(events):
    return [e for e in events
            if e.get("cat") == "flow" and e["ph"] in ("s", "t", "f")]


def _four_node_traces(p):
    _, tracer = p.hooks.enable(trace=True)
    try:
        rec = recorder(p, 4, 4, 30, batch_size=2, seed=0, record=False)
        rec.drain_clients(max_steps=2_000_000)
    finally:
        p.hooks.disable()
    per_node = p.merge.split_node_traces(tracer, range(4))
    return per_node, p.merge.merge_traces(per_node.values())


@pytest.fixture(scope="module")
def four_node_traces():
    """Each package's (per-node traces, merged trace) of one seeded run."""
    return {p.root: _four_node_traces(p) for p in BOTH}


def _flows_by_id(events):
    by_id = {}
    for record in _flow_records(events):
        by_id.setdefault(record["id"], []).append(record)
    return by_id


def test_flow_events_well_formed_per_node(four_node_traces):
    per_node, _ = four_node_traces[TORCH.root]
    jax_per_node, _ = four_node_traces[JAX.root]
    assert set(per_node) == set(jax_per_node) == {0, 1, 2, 3}
    for node, trace in per_node.items():
        flows = _flow_records(trace["traceEvents"])
        assert flows, f"node {node} recorded no flow events"
        assert untimed(flows) == untimed(
            _flow_records(jax_per_node[node]["traceEvents"]))
        triples = set()
        for flow_id, records in _flows_by_id(flows).items():
            if flow_id.startswith(("c.", "e.")):
                continue
            epoch, seq, bucket = (int(x) for x in flow_id.split("."))
            assert (epoch, seq, bucket) not in triples
            triples.add((epoch, seq, bucket))
            phases = [r["ph"] for r in records]
            assert phases.count("s") == 1, (node, flow_id, phases)
            assert phases.count("f") == 1, (node, flow_id, phases)
            assert seq % 4 == bucket


def test_merged_trace_connects_three_plus_lanes(four_node_traces):
    _, merged = four_node_traces[TORCH.root]
    _, jax_merged = four_node_traces[JAX.root]
    events = json.loads(json.dumps(merged))["traceEvents"]
    for e in events:
        assert "ph" in e and "pid" in e and "ts" in e or e["ph"] == "M"
    by_id = _flows_by_id(events)
    assert by_id, "merged trace lost its flow records"
    jax_by_id = _flows_by_id(jax_merged["traceEvents"])
    assert {k: sorted((r["pid"], r["name"]) for r in v)
            for k, v in by_id.items()} == {
        k: sorted((r["pid"], r["name"]) for r in v)
        for k, v in jax_by_id.items()}
    spanning = [
        flow_id for flow_id, records in by_id.items()
        if not flow_id.startswith(("c.", "e."))
        and len({r["pid"] for r in records}) >= 3
    ]
    assert spanning
    for flow_id, records in by_id.items():
        records.sort(key=lambda r: r["ts"])
        phases = [r["ph"] for r in records]
        assert phases.count("s") == 1 and phases.count("f") == 1
        assert phases[0] == "s" and phases[-1] == "f", (flow_id, phases)
    assert any(flow_id.startswith("c.") for flow_id in by_id)


_MILESTONE_ORDER = {
    "seq.allocated": 0,
    "seq.preprepared": 1,
    "seq.prepared": 2,
    "seq.commit_quorum": 3,
    "seq.committed": 4,
}


def test_merged_trace_milestones_monotonic_per_lane(four_node_traces):
    lanes = {}
    for root, (_, merged) in four_node_traces.items():
        per_lane_seq = {}
        for e in merged["traceEvents"]:
            if e.get("ph") == "i" and e["name"] in _MILESTONE_ORDER:
                key = (e["pid"], e["args"]["seq"])
                per_lane_seq.setdefault(key, []).append(e)
        assert per_lane_seq
        for (pid, seq), events in per_lane_seq.items():
            assert all(e["ts"] >= 0 for e in events)
            ordered = sorted(events, key=lambda e: _MILESTONE_ORDER[e["name"]])
            times = [e["ts"] for e in ordered]
            assert times == sorted(times), (pid, seq)
        lanes[root] = {k: sorted(e["name"] for e in v)
                       for k, v in per_lane_seq.items()}
    assert lanes[TORCH.root] == lanes[JAX.root]


def test_merge_aligns_clock_offsets():
    t0_a = 50_000_000_000
    t0_b = 2_000_000
    offset_ab = (t0_a + 10_000_000) - (t0_b + 3_000_000)

    def trace(node, t0, ts_us, offsets):
        return {"traceEvents": [
            {"name": "clock_sync", "ph": "M", "pid": 0, "tid": 0,
             "args": {"node": node, "t0_ns": t0, "offsets_ns": offsets}},
            {"name": "seq.prepared", "cat": "flow", "ph": "t", "id": "1.5.0",
             "pid": 0, "tid": node, "ts": ts_us},
        ]}

    def case(p):
        return p.merge.merge_traces([
            trace(0, t0_a, 10_000.0, {"1": offset_ab}),
            trace(1, t0_b, 3_000.0, {}),
        ])

    merged = same(case)
    flows = _flow_records(merged["traceEvents"])
    assert len(flows) == 2
    assert abs(flows[0]["ts"] - flows[1]["ts"]) < 1e-6
    assert {f["pid"] for f in flows} == {0, 1}
    assert sorted(f["ph"] for f in flows) == ["f", "s"]


# ---------------------------------------------------------------------------
# Span sampling
# ---------------------------------------------------------------------------


def test_span_sampling_is_deterministic_and_spares_milestones():
    def case(p):
        def spans_kept(seed):
            tracer = p.trace.Tracer(sampler=p.trace.SpanSampler(0.25, seed=seed))
            for i in range(100):
                with tracer.span(f"s{i}", tid=0):
                    pass
            return [e["name"] for e in tracer.events if e["ph"] == "X"]

        kept_a = spans_kept(seed=0)
        assert kept_a == spans_kept(seed=0)
        assert kept_a != spans_kept(seed=1)
        tracer = p.trace.Tracer(sampler=p.trace.SpanSampler(0.01, seed=0))
        for seq in range(50):
            tracer.instant("seq.allocated", cat="consensus", tid=0)
            tracer.flow_milestone("seq.allocated", 0, seq, epoch=1, bucket=0)
        return (kept_a, sum(e["ph"] == "i" for e in tracer.events),
                len(_flow_records(tracer.events)))

    kept_a, instants, flows = same(case)
    assert len(kept_a) == 25 and instants == 50 and flows == 50


def test_hooks_expose_sample_rate():
    def case(p):
        try:
            _, tracer = p.hooks.enable(trace=True, sample_rate=0.5,
                                       sample_seed=3)
            got = (p.hooks.sample_rate, tracer._sampler.stride)
        finally:
            p.hooks.disable()
        return got, p.hooks.sample_rate

    assert same(case) == ((0.5, 2), None)


# ---------------------------------------------------------------------------
# Label catalog + cardinality budget
# ---------------------------------------------------------------------------


def test_strict_registry_rejects_undeclared_labels():
    def case(p):
        reg = p.metrics.Registry()
        with pytest.raises(KeyError):
            reg.counter("mirbft_wal_appends_total", bogus="x")
        reg.counter("mirbft_seq_milestones_total", milestone="seq.prepared",
                    epoch="1", bucket="0").inc()
        reg.counter("mirbft_seq_milestones_total",
                    milestone="seq.committed").inc()
        return reg.snapshot()

    same(case)


def test_cardinality_budget_rejects_registration():
    def case(p):
        reg = p.metrics.Registry()
        for i in range(p.metrics.DEFAULT_CARDINALITY):
            reg.counter("mirbft_chaos_dropped_total", scenario=f"s{i}").inc()
        with pytest.raises(p.metrics.CardinalityError):
            reg.counter("mirbft_chaos_dropped_total", scenario="one-too-many")
        return reg.counter("mirbft_chaos_dropped_total", scenario="s0").value

    assert same(case) == 1


def test_milestone_degrades_gracefully_over_budget():
    def case(p):
        saved = p.metrics.CARDINALITY.get("mirbft_seq_milestones_total")
        p.metrics.CARDINALITY["mirbft_seq_milestones_total"] = 1
        try:
            reg, tracer = p.hooks.enable(trace=True)
            p.hooks.milestone("seq.prepared", 0, 1, epoch=1, bucket=0)
            p.hooks.milestone("seq.prepared", 0, 2, epoch=2, bucket=1)
            snap = reg.snapshot()["mirbft_seq_milestones_total"]["series"]
            return snap, untimed(tracer.events)
        finally:
            p.hooks.disable()
            p.metrics.CARDINALITY["mirbft_seq_milestones_total"] = saved

    snap, events = same(case)
    assert len(snap) == 1
    assert sum(e["ph"] == "i" for e in events) == 2


# ---------------------------------------------------------------------------
# Live HTTP endpoints on the runtime node
# ---------------------------------------------------------------------------


def _get(url, timeout=5):
    with urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.read().decode("utf-8")


def test_node_endpoints_round_trip():
    def case(p):
        metrics, _ = p.hooks.enable()
        node = None
        try:
            metrics.counter("mirbft_wal_appends_total").inc(3)
            node = p.node.Node.start_new(
                p.config.Config(id=0, metrics_port=0),
                p.node.standard_initial_network_state(1, [0]),
            )
            host, port = node.metrics_address
            base = f"http://{host}:{port}"
            code, metrics_text = _get(base + "/metrics")
            assert code == 200
            code, status_text = _get(base + "/status")
            assert code == 200
            code, health = _get(base + "/healthz")
            assert code == 200
            with pytest.raises(HTTPError) as err:
                _get(base + "/nope")
            missing = err.value.code
        finally:
            p.hooks.disable()
            if node is not None:
                node.stop()
        with pytest.raises(OSError):
            socket.create_connection((host, port), timeout=1).close()
        # The rest of the exposition (the serializer's own series, its
        # wall-clock histograms) depends on when the scrape lands.
        wal_lines = [line for line in metrics_text.splitlines()
                     if "mirbft_wal_appends_total" in line]
        return (wal_lines, sorted(json.loads(status_text)),
                json.loads(health), missing)

    wal_lines, status, health, missing = same(case)
    assert "# TYPE mirbft_wal_appends_total counter" in wal_lines
    assert "mirbft_wal_appends_total 3" in wal_lines
    assert status
    assert health == {"ok": True, "node_id": 0, "ready": True}
    assert missing == 404


def test_node_endpoint_dump_and_readiness(tmp_path):
    """``/dump`` flushes the wired flight recorder (503 without one) and
    ``set_ready`` flips ``/healthz``, as on the JAX node."""
    def case(p):
        rec_mod = importlib.import_module(f"{p.root}.obsv.recorder")
        node = p.node.Node.start_new(
            p.config.Config(id=0, metrics_port=0),
            p.node.standard_initial_network_state(1, [0]),
        )
        try:
            host, port = node.metrics_address
            base = f"http://{host}:{port}"
            with pytest.raises(HTTPError) as err:
                _get(base + "/dump")
            no_recorder = err.value.code
            node.set_ready(False)
            _, health = _get(base + "/healthz")
            dump_dir = tmp_path / p.root
            p.hooks.enable(recorder=rec_mod.FlightRecorder(
                0, dump_dir=str(dump_dir)))
            try:
                code, body = _get(base + "/dump")
            finally:
                p.hooks.disable()
            path = Path(json.loads(body)["path"])
            assert path.parent == dump_dir and path.exists()
        finally:
            node.stop()
        return no_recorder, json.loads(health), code, path.name

    no_recorder, health, code, name = same(case)
    assert (no_recorder, code) == (503, 200)
    assert health == {"ok": True, "node_id": 0, "ready": False}
    assert name == "node0-0.flight.json"


def test_node_endpoint_off_by_default():
    def case(p):
        node = p.node.Node.start_new(
            p.config.Config(id=0), p.node.standard_initial_network_state(1, [0])
        )
        try:
            return node.metrics_address, node._exporter
        finally:
            node.stop()

    assert same(case) == (None, None)


def test_metrics_endpoint_reports_disabled_hooks():
    def case(p):
        assert not p.hooks.enabled
        exporter = p.exporter.ObsvExporter(
            registry_fn=lambda: p.hooks.metrics if p.hooks.enabled else None
        )
        try:
            host, port = exporter.address
            return _get(f"http://{host}:{port}/metrics")
        finally:
            exporter.close()

    code, text = same(case)
    assert code == 200 and "disabled" in text


def _hang_up_early(p, capsys) -> str:
    """One ``/status`` whose answer takes 0.3 s, asked by a client that
    resets its connection first; what the server then wrote on stderr."""
    import struct

    exporter = p.exporter.ObsvExporter(
        status_fn=lambda: (time.sleep(0.3), {"ok": True})[1]
    )
    try:
        client = socket.create_connection(exporter.address, timeout=5)
        client.sendall(b"GET /status HTTP/1.1\r\nHost: x\r\n\r\n")
        time.sleep(0.05)
        # SO_LINGER 0: close sends a reset, so the answer's write fails.
        client.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                          struct.pack("ii", 1, 0))
        client.close()
        deadline = time.monotonic() + 1.5
        err = ""
        while time.monotonic() < deadline and "Error" not in err:
            time.sleep(0.1)
            err += capsys.readouterr().err
        return err
    finally:
        exporter.close()


def test_a_scraper_that_hangs_up_leaves_no_traceback(capsys):
    """A supervisor's readiness poll gives up after 1 s; a worker that
    answers later writes into a reset connection.  The JAX exporter's
    server prints the BrokenPipe/ConnectionReset traceback on stderr (a
    worker log holding it reads as a fault); the port's answers no one
    and prints nothing."""
    ref = _hang_up_early(JAX, capsys)
    assert "Traceback" in ref
    assert "BrokenPipeError" in ref or "ConnectionResetError" in ref
    assert _hang_up_early(TORCH, capsys) == ""


# ---------------------------------------------------------------------------
# Timeline-diff regression gate
# ---------------------------------------------------------------------------


def _milestone_trace(prepare_ms, seqs=40):
    events = []
    for seq in range(1, seqs + 1):
        base = seq * 1000
        for name, offset in (
            ("seq.allocated", 0),
            ("seq.preprepared", 10),
            ("seq.prepared", 10 + prepare_ms),
            ("seq.commit_quorum", 15 + prepare_ms),
        ):
            events.append({
                "name": name, "ph": "i", "s": "t", "pid": 0, "tid": 0,
                "ts": 0,
                "args": {"node": 0, "seq": seq, "sim_ms": base + offset},
            })
    return {"traceEvents": events}


def test_diff_flags_p95_regression_on_traces():
    def case(p):
        a = p.diff.extract_series(_milestone_trace(prepare_ms=50))
        b = p.diff.extract_series(_milestone_trace(prepare_ms=100))
        return (a, p.diff.diff_series(a, b, threshold_pct=10.0),
                p.diff.diff_series(a, dict(a), threshold_pct=10.0))

    a, report, equal = same(case)
    assert a["phase.prepare.p95_ms"] == 50
    assert not report["ok"]
    assert "phase.prepare.p95_ms" in {r["series"] for r in report["regressions"]}
    assert equal["ok"] and not equal["regressions"]


def test_diff_direction_heuristics():
    a = {"committed_reqs_per_sec": 100.0, "rung3_verify_p99_ms": 10.0}
    b = {"committed_reqs_per_sec": 50.0, "rung3_verify_p99_ms": 20.0}

    def case(p):
        return (p.diff.diff_series(a, b, threshold_pct=10.0),
                p.diff.diff_series(b, a, threshold_pct=10.0),
                [p.diff.direction(name) for name in (
                    "goodput_per_sec", "p95_ms", "wall", "calls", "rate")])

    worse, better, directions = same(case)
    assert {r["series"] for r in worse["regressions"]} == set(a)
    assert better["ok"]
    assert directions == ["higher", "lower", "lower", None, "higher"]


def test_diff_cli_verdicts(tmp_path):
    base = {
        "metric": "committed_reqs_per_sec_per_chip",
        "value": 900.0,
        "prepare_p95_ms": 40.0,
        "stages": {"ladder_host": {"status": "ok", "seconds": 12.0}},
        "engine_gauges": {"ladder_host": {"events": 5000, "sim_ms": 800}},
    }
    regressed = dict(base, prepare_p95_ms=80.0)
    a, b, eq = tmp_path / "a.json", tmp_path / "b.json", tmp_path / "eq.json"
    a.write_text(json.dumps(base))
    b.write_text(json.dumps(regressed))
    eq.write_text(json.dumps(base))
    verdicts = {}
    for p in BOTH:
        bad = _cli(p.root, "--diff", str(a), str(b), "--threshold", "25")
        assert bad.returncode == 1, bad.stdout + bad.stderr
        bad_verdict = json.loads(bad.stdout.strip().splitlines()[-1])
        assert bad_verdict["ok"] is False
        assert any(r["series"] == "prepare_p95_ms"
                   for r in bad_verdict["regressions"])
        good = _cli(p.root, "--diff", str(a), str(eq), "--threshold", "25")
        assert good.returncode == 0, good.stdout + good.stderr
        good_verdict = json.loads(good.stdout.strip().splitlines()[-1])
        assert good_verdict["ok"] is True and not good_verdict["regressions"]
        verdicts[p.root] = (bad.stdout, good.stdout)
    assert verdicts[TORCH.root] == verdicts[JAX.root]


@pytest.mark.parametrize("path", BENCH_FILES, ids=lambda p: p.name)
def test_extract_series_matches_reference_on_bench_artifacts(path):
    """Both packages' ``load_artifact`` + ``extract_series`` give the same
    map on every committed bench artifact (exact)."""
    jax_series = JAX.diff.extract_series(JAX.diff.load_artifact(str(path)))
    series = TORCH.diff.extract_series(TORCH.diff.load_artifact(str(path)))
    assert series == jax_series
    assert series


def test_diff_files_on_bench_artifacts_match_reference():
    """Rung over rung, both packages' reports on the committed artifacts
    are equal (every pair of neighbours)."""
    for older, newer in zip(BENCH_FILES, BENCH_FILES[1:]):
        assert TORCH.diff.diff_files(str(older), str(newer)) == (
            JAX.diff.diff_files(str(older), str(newer)))


def test_load_artifact_recovers_bench_stream(tmp_path):
    """A ``BENCH_stream.jsonl`` journal: its ``final`` line, or, when the
    run was cut, its stage lines under the recovered schema (a torn tail
    line skipped) — as the JAX package reads them."""
    header = {"kind": "header", "schema": "mirbft-bench-stream/1", "pid": 7}
    stage = {"kind": "stage", "stage": "ladder", "status": "ok",
             "seconds": 3.5}
    final = {"kind": "final", "payload": {"metric": "m", "value": 2.0}}
    cut = tmp_path / "cut.jsonl"
    cut.write_text("\n".join(json.dumps(r) for r in (header, stage))
                   + '\n{"kind": "sta')
    whole = tmp_path / "whole.jsonl"
    whole.write_text("\n".join(json.dumps(r) for r in (header, stage, final)))
    lone = tmp_path / "lone.json"
    lone.write_text(json.dumps(header))

    def case(p):
        return [p.diff.load_artifact(str(f)) for f in (cut, whole, lone)]

    recovered, finished, header_only = same(case)
    assert recovered == {"schema": "mirbft-bench-recovered/1",
                         "recovered": True, "pid": 7,
                         "stages": {"ladder": {"status": "ok",
                                               "seconds": 3.5}}}
    assert finished == {"metric": "m", "value": 2.0}
    assert header_only["recovered"] is True


def test_device_gate_reads_the_ports_device_report():
    """The diff's device gate reads the keys the port's
    ``obsv/device.py`` ``report`` emits: a budget breach and a divergence
    in B fail it, in each package alike."""
    from mirbft_tpu_torch.obsv import device

    report = device.report(TORCH.metrics.Registry())
    assert {"retraces", "retrace_budget", "retrace_breaches",
            "divergence_total"} <= set(report)
    bad = dict(report, retraces={"sha256_digest": 9},
               retrace_breaches=["sha256_digest"], divergence_total=2)

    def case(p):
        clean = p.diff.apply_device_gate(
            p.diff.diff_series({}, {}), {"device": report})
        gated = p.diff.apply_device_gate(
            p.diff.diff_series({}, {}), {"device": bad})
        return clean, gated, p.diff.render_report(gated)

    clean, gated, text = same(case)
    assert clean["ok"] and not clean["device_failures"]
    assert not gated["ok"]
    assert [f["kind"] for f in gated["device_failures"]] == [
        "retrace_budget", "divergence"]
    assert "VERDICT: DEVICE" in text


# ---------------------------------------------------------------------------
# Bounded-queue backpressure telemetry (obsv/bqueue.py)
# ---------------------------------------------------------------------------


def test_bounded_queue_emits_uniform_series():
    def case(p):
        try:
            metrics, _ = p.hooks.enable()
            q = p.bqueue.BoundedQueue("test.stage", maxsize=2)
            q.put("a")
            q.put("b")
            with pytest.raises(stdlib_queue.Full):
                q.put("c", block=False)
            got = [q.get(), q.get_nowait()]
            with pytest.raises(stdlib_queue.Empty):
                q.get_nowait()
            snap = metrics.snapshot()
            depth = {tuple(s["labels"].items()): s["value"]
                     for s in snap["mirbft_queue_depth"]["series"]}
            wait = snap["mirbft_queue_wait_seconds"]["series"][0]
            sat = snap["mirbft_queue_saturated_total"]["series"][0]
            return got, depth, wait["labels"], wait["count"], sat
        finally:
            p.hooks.disable()

    got, depth, wait_labels, wait_count, sat = same(case)
    assert got == ["a", "b"]
    assert depth[(("queue", "test.stage"),)] == 0
    assert wait_labels == {"queue": "test.stage"} and wait_count == 2
    assert sat["labels"] == {"queue": "test.stage"} and sat["value"] == 1


def test_bounded_queue_disabled_is_silent_and_unstamped():
    def case(p):
        assert not p.hooks.enabled
        q = p.bqueue.BoundedQueue("test.cold", maxsize=4)
        q.put("cold")
        try:
            metrics, _ = p.hooks.enable()
            assert q.get() == "cold"
            snap = metrics.snapshot()
            waits = snap.get("mirbft_queue_wait_seconds", {}).get("series", [])
            depths = {s["labels"]["queue"]: s["value"]
                      for s in snap["mirbft_queue_depth"]["series"]}
            return [s for s in waits if s["labels"] == {"queue": "test.cold"}
                    and s["count"]], depths.get("test.cold")
        finally:
            p.hooks.disable()

    assert same(case) == ([], 0)


def test_queue_telemetry_rebinds_across_enable_cycles():
    def case(p):
        telemetry = p.bqueue.QueueTelemetry("test.longlived")
        try:
            first, _ = p.hooks.enable()
            telemetry.saturated()
            p.hooks.disable()
            telemetry.saturated()
            second, _ = p.hooks.enable()
            telemetry.saturated()

            def get(reg):
                return [s["value"] for s in reg.snapshot()
                        .get("mirbft_queue_saturated_total", {})
                        .get("series", [])
                        if s["labels"] == {"queue": "test.longlived"}]

            return get(first), get(second)
        finally:
            p.hooks.disable()

    assert same(case) == ([1], [1])


def test_queue_telemetry_cardinality_degrades_not_crashes():
    names = ("mirbft_queue_depth", "mirbft_queue_wait_seconds",
             "mirbft_queue_saturated_total")

    def case(p):
        saved = {name: p.metrics.CARDINALITY.get(name) for name in names}
        p.metrics.CARDINALITY["mirbft_queue_depth"] = 1
        try:
            metrics, _ = p.hooks.enable()
            q_ok = p.bqueue.BoundedQueue("test.within", maxsize=2)
            q_over = p.bqueue.BoundedQueue("test.over", maxsize=2)
            q_ok.put(1)
            q_over.put(2)
            got = q_over.get()
            return got, {s["labels"]["queue"] for s in metrics.snapshot()
                         ["mirbft_queue_depth"]["series"]}
        finally:
            p.hooks.disable()
            for name, value in saved.items():
                p.metrics.CARDINALITY[name] = value

    assert same(case) == (2, {"test.within"})


def test_hot_path_queues_ride_the_shim():
    import inspect

    def case(p):
        processor = importlib.import_module(f"{p.root}.runtime.processor")
        stream = importlib.import_module(f"{p.root}.app.stream")
        transport = importlib.import_module(f"{p.root}.runtime.transport")
        tracker = importlib.import_module(f"{p.root}.core.device_tracker")
        proc_src = inspect.getsource(processor)
        return (
            [f'BoundedQueue("{stage}"' in proc_src for stage in (
                "proc.persist", "proc.barrier", "proc.transmit",
                "proc.commit")],
            'BoundedQueue("app.apply"' in inspect.getsource(stream),
            "QueueTelemetry(" in inspect.getsource(transport),
            'QueueTelemetry("device.ack_stage")' in inspect.getsource(tracker),
        )

    assert same(case) == ([True] * 4, True, True, True)


# ---------------------------------------------------------------------------
# Tracer open-flow table bound
# ---------------------------------------------------------------------------


def test_tracer_flow_table_bounded_eviction():
    def case(p):
        try:
            metrics, tracer = p.hooks.enable(trace=True)
            tracer._max_open_flows = 4
            for seq in range(10):
                tracer.flow_milestone("seq.allocated", 0, seq, epoch=1,
                                      bucket=0)
            open_flows, abandoned = len(tracer._flows), tracer.abandoned_flows
            value = metrics.snapshot()["mirbft_flow_abandoned_total"][
                "series"][0]["value"]
            tracer.flow_milestone("seq.committed", 0, 9)
            return open_flows, abandoned, value, (0, 9) in tracer._flows
        finally:
            p.hooks.disable()

    assert same(case) == (4, 6, 6, False)


def test_tracer_flow_eviction_without_registry_still_counts():
    def case(p):
        tracer = p.trace.Tracer(max_open_flows=2)
        for seq in range(5):
            tracer.flow_milestone("seq.allocated", 0, seq, epoch=1, bucket=0)
        return len(tracer._flows), tracer.abandoned_flows

    assert same(case) == (2, 3)


# ---------------------------------------------------------------------------
# Bucket backlog gauges + imbalance in status
# ---------------------------------------------------------------------------


def test_imbalance_ratio_exact():
    vectors = ([], [0, 0, 0, 0], [2, 2, 2, 2], [1, 2, 3, 10], [0, 0, 0, 6])
    got = same(lambda p: [p.status._imbalance_ratio(v) for v in vectors])
    assert got == [0.0, 0.0, 1.0, 4.0, 6.0]


def test_bucket_backlog_gauges_and_status_fold():
    def case(p):
        try:
            metrics, _ = p.hooks.enable()
            rec = recorder(p, 4, 2, 6, batch_size=2, seed=0, record=False)
            rec.drain_clients(max_steps=1_000_000)
            series = metrics.snapshot()["mirbft_bucket_backlog"]["series"]
        finally:
            p.hooks.disable()
        status = p.status.state_machine_status(rec.machines[0])
        return (series, status.bucket_backlog, status.bucket_imbalance,
                status.pretty())

    series, backlog, imbalance, pretty = same(case)
    assert series
    assert len({s["labels"]["bucket"] for s in series}) == len(series)
    assert backlog and all(n == 0 for n in backlog)
    assert imbalance == 0.0
    assert "backlog:" in pretty and "imbalance max/median" in pretty


# ---------------------------------------------------------------------------
# Clock alignment of live traces
# ---------------------------------------------------------------------------


class _Sink:
    """Enough of a Node for a transport to deliver into."""

    def step(self, source, msg):
        pass

    def propose(self, request):
        pass


@pytest.mark.parametrize("root", [JAX.root, TORCH.root])
def test_hello_offsets_on_one_host_are_the_hellos_latency(root):
    """The offsets a live node stamps into its trace (``clock_offsets()``
    of its transport, learned from each peer's hello) are what merge.py
    shifts the peer's lane by.  On one host every process reads the same
    CLOCK_MONOTONIC, so the exact offset is 0; both packages estimate the
    hello's one-way latency instead, a positive number, and two events at
    one instant land that far apart in the merge (ROADMAP queue 3: a
    reference behaviour the port keeps)."""
    transport_mod = importlib.import_module(f"{root}.runtime.transport")
    merge = importlib.import_module(f"{root}.obsv.merge")
    reference = transport_mod.TcpTransport(0)  # the lowest id: merge's clock
    peer = transport_mod.TcpTransport(1)
    try:
        reference.serve(_Sink())
        peer.connect(0, reference.address)
        peer.link().send(0, importlib.import_module(f"{root}.pb").Msg(
            type=importlib.import_module(f"{root}.pb").Suspect(epoch=1)))
        deadline = time.monotonic() + 10
        while (1 not in reference.clock_offsets()
               and time.monotonic() < deadline):
            time.sleep(0.01)
        offset = reference.clock_offsets()[1]
    finally:
        peer.close(0)
        reference.close(0)
    assert 0 < offset < 10**9
    # One process, one clock: both nodes' tracers share t0 and stamp the
    # same instant with the same ts.
    traces = [
        {"traceEvents": [
            {"name": "clock_sync", "ph": "M", "pid": 0, "tid": 0,
             "args": {"node": node, "t0_ns": 5_000_000,
                      "offsets_ns": {"1": offset} if node == 0 else {}}},
            {"name": "seq.committed", "ph": "i", "pid": 0, "tid": node,
             "ts": 1000.0, "args": {"node": node, "seq": 1}},
        ]}
        for node in (0, 1)
    ]
    shifted, _plans = merge.aligned_events(traces)
    times = {node: abs_us for abs_us, node, _event in shifted}
    assert times[1] - times[0] == pytest.approx(offset / 1000.0)


def test_traced_live_rung_serves_endpoints_and_merges(tmp_path):
    """The live rung traced at a small size, the digests on the kernel's
    plain version: every node's exporter answers mid-run (its SHA-256
    launches on ``/metrics``), each node's trace carries its peers'
    hello offsets, and the merged ledger holds every committed flow."""
    from mirbft_tpu_torch import bench
    from mirbft_tpu_torch.obsv import critpath

    def scrape(addresses):
        out = {}
        for n, (host, port) in addresses.items():
            _, text = _get(f"http://{host}:{port}/metrics")
            _, health = _get(f"http://{host}:{port}/healthz")
            out[n] = (text, json.loads(health))
        return out

    settings = bench.LiveSettings(clients=4, reqs_per_client=20,
                                  target_commits=60, fsync_floor_s=0.0,
                                  deadline_s=60)
    live = bench.live_cluster_rate("cuda-pipelined", device="cpu",
                                   settings=settings, trace_dir=str(tmp_path),
                                   on_running=scrape)
    assert sorted(live["scraped"]) == [0, 1, 2, 3]
    for n, (text, health) in live["scraped"].items():
        assert health == {"ok": True, "ready": True, "node_id": n}
        assert 'mirbft_crypto_flush_total{path="device",plane="hash"}' in text
    for n, path in enumerate(live["traces"]):
        [sync] = [e["args"] for e in json.loads(Path(path).read_text())[
            "traceEvents"] if e.get("name") == "clock_sync"]
        assert sync["node"] == n
        assert set(sync["offsets_ns"]) == {str(m) for m in range(4) if m != n}
    ledger, n_traces = critpath.ledger_from_dir(str(tmp_path))
    assert n_traces == 4
    assert len(ledger) >= max(live["committed_seqs"]) - sum(
        live["abandoned_flows"]) > 0
