"""The port's critical-path ledger, knee finder and capacity gate
(``mirbft_tpu_torch/obsv/critpath.py``, ``loadgen/knee.py``) held
against the JAX package's on the same inputs.

Mirrors every case of ``tests/test_critpath.py``: each synthetic
fixture (skewed per-node clocks, loadgen records, latency curves) goes
through both packages, and the outputs must be equal exactly — ledger
rows field for field, attribution bands, knee steps and capacity
artifacts, the CLI's JSON verdict line and exit codes.  Then the
ledger of a seeded 4-node engine run, traced in each package (the port
on its SHA-256 kernel's plain version), where every field but the
wall-clock residencies must be equal.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest

from mirbft_tpu.loadgen import knee as jax_knee
from mirbft_tpu.obsv import critpath as jax_critpath
from mirbft_tpu_torch.loadgen import knee as torch_knee
from mirbft_tpu_torch.obsv import critpath as torch_critpath

REPO = Path(__file__).resolve().parents[1]
PACKAGES = {"jax": "mirbft_tpu", "torch": "mirbft_tpu_torch"}

# Every synthetic node's clock is skewed differently; the offsets below
# make (t0_ns + offset_ns) identical across nodes, so an event's local
# ``ts`` (µs since its own t0) doubles as its absolute time after
# alignment — fixtures can state timelines in one shared µs domain.
_T0 = {0: 1_000_000_000, 1: 500_000_000, 2: 2_000_000_000}
_REF_OFFSETS = {"1": 500_000_000, "2": -1_000_000_000}
_BASE_US = 1_000_000.0  # (t0 + offset) / 1000 for every node


def _node_trace(node, instants):
    events = [
        {
            "name": "clock_sync",
            "ph": "M",
            "pid": 0,
            "tid": 0,
            "args": {
                "node": node,
                "t0_ns": _T0[node],
                "offsets_ns": _REF_OFFSETS if node == 0 else {},
            },
        }
    ]
    for ts, name, args in instants:
        events.append(
            {
                "name": name,
                "cat": "consensus",
                "ph": "i",
                "pid": 0,
                "tid": node,
                "ts": float(ts),
                "args": args,
            }
        )
    return {"traceEvents": events}


def _milestones(seq, *, alloc, pp, cq, committed, epoch=1, bucket=0):
    def args(node, with_meta=False):
        a = {"node": node, "seq": seq, "sim_ms": 0}
        if with_meta:
            a.update(epoch=epoch, bucket=bucket)
        return a

    out = {0: [], 1: [], 2: []}
    ts, node = alloc
    out[node].append((ts, "seq.allocated", args(node, with_meta=True)))
    for node, ts in pp.items():
        out[node].append((ts, "seq.preprepared", args(node, with_meta=True)))
    ts, node = cq
    out[node].append((ts, "seq.commit_quorum", args(node)))
    for node, ts in committed.items():
        out[node].append((ts, "seq.committed", args(node)))
    return out


def _merge_instants(*per_seq):
    traces = []
    for node in (0, 1, 2):
        instants = []
        for seq_map in per_seq:
            instants.extend(seq_map[node])
        traces.append(_node_trace(node, instants))
    return traces


def _transmit_bound_seq(seq, t):
    """hash 500, transmit 3000 (node 2 closes), quorum 500, commit 200."""
    return _milestones(
        seq,
        alloc=(t + 1000, 0),
        pp={0: t + 1500, 1: t + 2500, 2: t + 4500},
        cq=(t + 5000, 0),
        committed={0: t + 5200, 1: t + 5300, 2: t + 6000},
    )


def _quorum_bound_seq(seq, t):
    """hash 100, transmit 200, quorum 900 (node 1 closes cq), commit 50."""
    return _milestones(
        seq,
        alloc=(t + 100, 0),
        pp={0: t + 200, 1: t + 300, 2: t + 400},
        cq=(t + 1300, 1),
        committed={0: t + 1400, 1: t + 1350, 2: t + 1500},
    )


def _record(**over):
    record = {
        "client_id": 7,
        "req_no": 3,
        "seq": 5,
        "node": 1,
        "submit_ns": int((_BASE_US + 400) * 1000),
        "commit_ns": int((_BASE_US + 5800) * 1000),
    }
    record.update(over)
    return record


def _rows(ledger):
    return [dataclasses.asdict(row) for row in ledger]


def _both_ledgers(traces, records=None):
    """The ledger from each package on the same input; equal exactly."""
    jax_rows = _rows(jax_critpath.build_ledger(traces, records))
    torch_rows = _rows(torch_critpath.build_ledger(traces, records))
    assert torch_rows == jax_rows
    return torch_critpath.build_ledger(traces, records)


def test_ledger_exact_phases_across_skewed_clocks():
    ledger = _both_ledgers(_merge_instants(_transmit_bound_seq(5, 0)))
    assert len(ledger) == 1
    row = ledger[0]
    assert row.seq == 5
    assert row.epoch == 1 and row.bucket == 0
    assert row.phases == {
        "hash": 500.0,
        "transmit": 3000.0,
        "quorum": 500.0,
        "commit": 200.0,
    }
    assert row.phase_nodes["transmit"] == 2
    assert row.phase_nodes["hash"] == 0
    assert row.phase_nodes["commit"] == 0
    assert row.total_us == 4200.0


def test_ledger_joins_loadgen_records_for_ingress_and_apply():
    traces = _merge_instants(_transmit_bound_seq(5, 0))
    ledger = _both_ledgers(traces, [_record()])
    assert len(ledger) == 1
    row = ledger[0]
    assert row.client_id == 7 and row.req_no == 3
    assert row.phases["ingress"] == 600.0
    assert row.phases["apply"] == 500.0
    assert row.phase_nodes["apply"] == 1
    assert row.total_us == 5400.0
    assert _both_ledgers(traces, [_record(seq=999)]) == []


def test_attribution_bands_pick_dominant_phase_and_node():
    traces = _merge_instants(
        _quorum_bound_seq(10, 0),
        _quorum_bound_seq(11, 10_000),
        _transmit_bound_seq(20, 20_000),
        _transmit_bound_seq(21, 30_000),
    )
    ledger = _both_ledgers(traces)
    assert [r.seq for r in ledger] == [10, 11, 20, 21]
    split = ((0.0, 0.5), (0.5, 1.0))
    bands = torch_critpath.attribute(ledger, bands=split)
    assert bands == jax_critpath.attribute(
        jax_critpath.build_ledger(traces), bands=split
    )
    assert [b["band"] for b in bands] == ["p0-p50", "p50-p100"]
    fast, slow = bands
    assert fast["count"] == 2 and slow["count"] == 2
    assert fast["dominant_phase"] == "quorum"
    assert fast["dominant_node"] == 1
    assert fast["phase_us"]["quorum"] == 900.0
    assert slow["dominant_phase"] == "transmit"
    assert slow["dominant_node"] == 2
    assert slow["phase_us"]["transmit"] == 3000.0
    table = torch_critpath.attribution_table(bands)
    assert table == jax_critpath.attribution_table(bands)
    assert "transmit" in table and "quorum" in table
    assert "p50-p100" in table


def test_ledger_from_dir_reads_cluster_layout(tmp_path):
    traces = _merge_instants(_transmit_bound_seq(5, 0))
    for i, trace in enumerate(traces):
        node_dir = tmp_path / f"node{i}"
        node_dir.mkdir()
        (node_dir / "trace.json").write_text(json.dumps(trace))
    (tmp_path / "records.json").write_text(json.dumps([_record()]))
    ledger, n_traces = torch_critpath.ledger_from_dir(str(tmp_path))
    jax_ledger, jax_n = jax_critpath.ledger_from_dir(str(tmp_path))
    assert (n_traces, _rows(ledger)) == (jax_n, _rows(jax_ledger))
    assert n_traces == 3
    assert len(ledger) == 1 and ledger[0].phases["ingress"] == 600.0


def _cli(package, *args):
    return subprocess.run(
        [sys.executable, "-m", f"{package}.obsv", *args],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=120,
    )


def test_critpath_cli_renders_attribution(tmp_path):
    traces = _merge_instants(
        _quorum_bound_seq(10, 0), _transmit_bound_seq(20, 20_000)
    )
    for i, trace in enumerate(traces):
        (tmp_path / f"trace{i}.json").write_text(json.dumps(trace))
    empty = tmp_path / "empty"
    empty.mkdir()
    outs = {}
    for name, package in PACKAGES.items():
        proc = _cli(package, "--critpath", str(tmp_path))
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "2 committed flow(s)" in proc.stdout
        outs[name] = proc.stdout
        # Empty/missing dirs are a distinct, nonzero exit.
        assert _cli(package, "--critpath", str(empty)).returncode == 2
    assert outs["torch"] == outs["jax"]
    verdict = json.loads(outs["torch"].strip().splitlines()[-1])
    assert verdict["bands"]
    assert verdict["bands"][0]["dominant_phase"] in torch_critpath.PHASES


# ---------------------------------------------------------------------------
# Knee finder
# ---------------------------------------------------------------------------


class _Step:
    def __init__(self, rate, p95_ms, committed=None, duration_s=1.0):
        self.committed = int(rate if committed is None else committed)
        self.p95_ms = p95_ms
        self.p50_ms = p95_ms / 2
        self.p99_ms = p95_ms * 1.2
        self.goodput_per_sec = self.committed / duration_s


def _synthetic_curve(capacity=450.0, base_ms=40.0):
    def measure(rate):
        if rate <= capacity:
            return _Step(rate, base_ms + rate / 50.0)
        return _Step(rate, base_ms * 50.0)

    return measure


def _both_knees(measure, start, **kwargs):
    """find_knee in each package on one latency curve; equal exactly."""
    jax_result = jax_knee.find_knee(measure, start, **kwargs)
    result = torch_knee.find_knee(measure, start, **kwargs)
    assert dataclasses.asdict(result) == dataclasses.asdict(jax_result)
    return result


def test_find_knee_brackets_synthetic_capacity():
    result = _both_knees(
        _synthetic_curve(capacity=450.0),
        50.0,
        slo_p95_ms=100.0,
        max_steps=12,
        resolution=0.05,
    )
    assert result.located
    assert 400.0 <= result.knee_rate_per_sec <= 450.0
    assert result.knee_rate_per_sec == result.max_measured_ok
    rates = [s["rate_per_sec"] for s in result.steps]
    assert rates[:4] == [50.0, 100.0, 200.0, 400.0]
    assert all(s["ok"] for s in result.steps[:4])
    assert not result.steps[4]["ok"]


def test_find_knee_no_knee_within_budget_is_honest():
    result = _both_knees(
        _synthetic_curve(capacity=10_000.0),
        50.0,
        slo_p95_ms=1_000.0,
        max_rate=200.0,
        max_steps=12,
    )
    assert not result.located
    assert result.knee_rate_per_sec is None
    assert all(s["ok"] for s in result.steps)
    assert result.max_measured_ok == 200.0


def test_find_knee_all_fail_is_not_a_located_zero_knee():
    result = _both_knees(
        lambda rate: _Step(rate, 50_000.0),
        16.0,
        slo_p95_ms=8_000.0,
        max_steps=7,
    )
    assert not result.located
    assert result.knee_rate_per_sec is None
    assert result.max_measured_ok == 0.0
    assert not any(s["ok"] for s in result.steps)
    doc = torch_knee.artifact([torch_knee.config_doc("wedged", result)])
    assert doc == jax_knee.artifact([jax_knee.config_doc("wedged", result)])
    assert doc["knee_rate_per_sec"] is None


def test_find_knee_goodput_criterion_fails_collapsed_probe():
    def measure(rate):
        if rate <= 100.0:
            return _Step(rate, 50.0)
        return _Step(rate, 60.0, committed=1)

    loose = _both_knees(measure, 50.0, slo_p95_ms=100.0, max_steps=4)
    assert not loose.located
    strict = _both_knees(
        measure, 50.0, slo_p95_ms=100.0, max_steps=8, min_goodput_ratio=0.5
    )
    assert strict.located
    assert strict.knee_rate_per_sec <= 100.0


# ---------------------------------------------------------------------------
# Capacity artifact + diff gate
# ---------------------------------------------------------------------------


def _capacity_artifact(knee_mod, knee_rate):
    result = knee_mod.find_knee(
        _synthetic_curve(capacity=knee_rate),
        50.0,
        slo_p95_ms=100.0,
        max_steps=12,
        resolution=0.05,
    )
    return knee_mod.artifact(
        [
            knee_mod.config_doc(
                "pipelined-lan", result, profile="lan", processor="pipelined"
            )
        ],
        nodes=8,
    )


def test_capacity_artifact_schema_and_headline():
    doc = _capacity_artifact(torch_knee, 450.0)
    assert doc == _capacity_artifact(jax_knee, 450.0)
    assert torch_knee.SCHEMA == jax_knee.SCHEMA
    assert doc["schema"] == torch_knee.SCHEMA
    assert doc["knee_rate_per_sec"] == doc["configs"][0]["knee_rate_per_sec"]
    assert doc["configs"][0]["located"]


def test_diff_gates_injected_knee_regression(tmp_path):
    good = _capacity_artifact(torch_knee, 450.0)
    bad = _capacity_artifact(torch_knee, 220.0)
    a = tmp_path / "a.json"
    b = tmp_path / "b.json"
    a.write_text(json.dumps(good))
    b.write_text(json.dumps(bad))
    pa = tmp_path / "pa.json"
    pb = tmp_path / "pb.json"
    pa.write_text(json.dumps({"metric": "x", "value": 1.0, "capacity": good}))
    pb.write_text(json.dumps({"metric": "x", "value": 1.0, "capacity": bad}))
    verdicts = {}
    for name, package in PACKAGES.items():
        proc = _cli(package, "--diff", str(a), str(b), "--threshold", "10")
        assert proc.returncode == 1, proc.stdout + proc.stderr
        verdict = json.loads(proc.stdout.strip().splitlines()[-1])
        assert any(
            "knee_rate_per_sec" in r["series"] for r in verdict["regressions"]
        )
        proc = _cli(package, "--diff", str(a), str(a), "--threshold", "10")
        assert proc.returncode == 0, proc.stdout + proc.stderr
        proc = _cli(package, "--diff", str(pa), str(pb), "--threshold", "10")
        assert proc.returncode == 1, proc.stdout + proc.stderr
        embedded = json.loads(proc.stdout.strip().splitlines()[-1])
        assert any(
            r["series"].startswith("capacity.")
            for r in embedded["regressions"]
        )
        verdicts[name] = (verdict, embedded)
    assert verdicts["torch"] == verdicts["jax"]


# ---------------------------------------------------------------------------
# The ledger of a seeded engine run, traced in each package
# ---------------------------------------------------------------------------


def _engine_ledger(package):
    """A 4-node seeded engine run traced; its per-node traces split as
    the CLI writes them, and their ledger (no loadgen records)."""
    if package == "jax":
        from mirbft_tpu.obsv import hooks
        from mirbft_tpu.obsv.merge import split_node_traces
        from mirbft_tpu.testengine.engine import BasicRecorder

        plane = {}
    else:
        from mirbft_tpu_torch.obsv import hooks
        from mirbft_tpu_torch.obsv.merge import split_node_traces
        from mirbft_tpu_torch.testengine.crypto_plane import (
            AsyncKernelHashPlane,
        )
        from mirbft_tpu_torch.testengine.engine import BasicRecorder

        plane = {"hash_plane": AsyncKernelHashPlane(device="cpu")}
    critpath = jax_critpath if package == "jax" else torch_critpath
    _, tracer = hooks.enable(trace=True)
    try:
        rec = BasicRecorder(4, 4, 30, batch_size=2, seed=0, record=False,
                            **plane)
        rec.drain_clients(max_steps=2_000_000)
    finally:
        hooks.disable()
    traces = list(split_node_traces(tracer, range(4)).values())
    return critpath.build_ledger(traces)


def _structure(ledger):
    """Every field of a ledger row but its wall-clock residencies."""
    return sorted(
        (row.seq, row.epoch, row.bucket, row.client_id, row.req_no,
         sorted(row.phases), sorted(row.phase_nodes.items()))
        for row in ledger
    )


@pytest.mark.parametrize("field", ["rows", "phase_nodes"])
def test_engine_run_ledger_matches_reference(field):
    """Tolerance: exact on every field but ``total_us`` and the phase
    residencies, which are wall-clock (the tracer stamps perf_counter)."""
    jax_ledger = _engine_ledger("jax")
    ledger = _engine_ledger("torch")
    assert len(ledger) == len(jax_ledger) == 60  # 4 x 30 / batch 2
    if field == "rows":
        assert [r.seq for r in sorted(ledger, key=lambda r: r.seq)] == list(
            range(1, 61)
        )
        assert _structure(ledger) == _structure(jax_ledger)
    else:
        for row in ledger:
            assert set(row.phases) == {"hash", "transmit", "quorum", "commit"}
            assert all(us >= 0.0 for us in row.phases.values())
        assert [sorted(r.phase_nodes.items()) for r in sorted(
            ledger, key=lambda r: r.seq)] == [
            sorted(r.phase_nodes.items())
            for r in sorted(jax_ledger, key=lambda r: r.seq)
        ]
