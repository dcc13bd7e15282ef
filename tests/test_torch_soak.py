"""The port's resource telemetry and soak rung (``obsv/resources.py``,
``obsv/recorder.py`` ``postmortem``, ``bench.soak_run``) and the diff
gate's leak and device verdicts, held against the JAX package's on the
same inputs.

Mirrors ``tests/test_recorder.py:131, :149, :160, :182-239`` (the
postmortem merge and its CLI, the leak verdicts, ``sample_process``, the
diff's leak gate) and ``:287`` (the soak smoke, here at 6 s on
``device="cpu"``: the digests on the SHA-256 kernel's plain version),
and ``tests/test_device_obsv.py:320, :339, :361, :373`` (the device gate,
the device series, the bench-stream recovery).  Tolerance: exact
equality of every output, except the process's own readings (RSS, fds,
threads, wall-clock stamps), which are held to the original cases'
bounds.

``tests/test_device_obsv.py:398`` and ``:413`` (``--recover``, the budget
clamp) are mirrored in ``tests/test_torch_bench_main.py``, beside the
bench ``main`` they call.

New here: the port's sampler counts a failed tick instead of hiding it,
and a sampler told it watches a card fails the tick that cannot read the
card's allocator.
"""

import copy
import json
import time

import pytest

from mirbft_tpu.obsv import diff as jax_diff
from mirbft_tpu.obsv import recorder as jax_recorder
from mirbft_tpu.obsv import resources as jax_resources
from mirbft_tpu.obsv.__main__ import main as jax_obsv_main
from mirbft_tpu_torch.obsv import device as torch_device
from mirbft_tpu_torch.obsv import diff as torch_diff
from mirbft_tpu_torch.obsv import recorder as torch_recorder
from mirbft_tpu_torch.obsv import resources as torch_resources
from mirbft_tpu_torch.obsv.__main__ import main as torch_obsv_main
from mirbft_tpu_torch.obsv.metrics import Registry

MAINS = {"jax": jax_obsv_main, "torch": torch_obsv_main}


# ----------------------------------------------------------------------
# Postmortem merge round-trip
# ----------------------------------------------------------------------


@pytest.fixture()
def four_node_dumps(tmp_path):
    """Four nodes' dumps written by the port's FlightRecorder (the JAX
    package reads the same schema)."""
    for node in range(4):
        rec = torch_recorder.FlightRecorder(
            node, dump_dir=str(tmp_path), autoflush_every=0
        )
        rec.set_clock_offsets(
            {peer: node * 1000 for peer in range(4) if peer != node}
        )
        for i in range(10):
            rec.record_event("commit", args={"seq": i})
        rec.record_milestone("checkpoint.stable", args={"seq": 9})
        rec.flush("exit")
    return str(tmp_path)


def test_postmortem_merges_four_nodes(four_node_dumps, tmp_path):
    out = str(tmp_path / "merged.json")
    result = torch_recorder.postmortem(four_node_dumps, out_path=out)
    ref = jax_recorder.postmortem(four_node_dumps)
    assert result["nodes"] == ref["nodes"] == [0, 1, 2, 3]
    assert result["merged"] == ref["merged"]
    assert result["timeline"] == ref["timeline"]
    merged = json.loads(open(out).read())
    instants = [
        ev for ev in merged["traceEvents"]
        if ev.get("ph") == "i" and ev.get("cat", "").startswith("flight.")
    ]
    assert len(instants) == 44
    assert {ev["pid"] for ev in instants} == {0, 1, 2, 3}
    assert result["timeline"].splitlines()
    assert "checkpoint.stable" in result["timeline"]


def test_postmortem_cli_round_trip(four_node_dumps, tmp_path, capsys):
    texts = {}
    for name, main in MAINS.items():
        out = str(tmp_path / f"cli-{name}.json")
        assert main(["--postmortem", four_node_dumps, "--out", out]) == 0
        assert json.loads(open(out).read())["traceEvents"]
        texts[name] = capsys.readouterr().out.replace(out, "OUT")
    assert "4 node dump(s)" in texts["torch"]
    assert texts["torch"] == texts["jax"]


def test_postmortem_empty_dir_is_distinct_error(tmp_path):
    for main in MAINS.values():
        assert main(["--postmortem", str(tmp_path)]) == 2


def test_dump_to_trace_carries_clock_sync():
    rec = torch_recorder.FlightRecorder(2)
    rec.set_clock_offsets({0: -500, 1: 250})
    rec.record_event("x")
    trace = torch_recorder.dump_to_trace(rec.snapshot())
    assert trace == jax_recorder.dump_to_trace(rec.snapshot())
    sync = [ev for ev in trace["traceEvents"] if ev["name"] == "clock_sync"]
    assert sync and sync[0]["args"]["offsets_ns"] == {"0": -500, "1": 250}


# ----------------------------------------------------------------------
# Leak verdicts
# ----------------------------------------------------------------------


def _verdict(series, **kwargs):
    """Both packages' verdict on one series; equal exactly."""
    got = torch_resources.leak_verdict(series, **kwargs)
    assert got == jax_resources.leak_verdict(series, **kwargs)
    return got


def test_leak_verdict_growing_on_linear_series():
    v = _verdict([(t * 1.0, 1_000_000 + t * 5_000) for t in range(60)])
    assert v["verdict"] == "growing"
    assert v["confidence"] > 0.9
    assert v["rel_pct_per_min"] > 5.0
    assert v["n"] == 60


def test_leak_verdict_flat_on_constant_and_noisy_series():
    flat = _verdict([(t * 1.0, 1_000_000) for t in range(60)])
    assert flat["verdict"] == "flat"
    assert flat["confidence"] == 1.0
    noisy = _verdict(
        [(t * 1.0, 1_000_000 + (7 * t % 13 - 6) * 1_000) for t in range(60)]
    )
    assert noisy["verdict"] == "flat"


def test_leak_verdict_sawtooth_is_confident_flat():
    v = _verdict([(t * 1.0, 1_000_000 + (t % 10) * 400_000)
                  for t in range(60)])
    assert v["verdict"] == "flat"
    assert v["r2"] < 0.5
    assert v["confidence"] > 0.5


def test_leak_verdict_short_series_stays_flat():
    v = _verdict([(t * 1.0, 100 + t * 50) for t in range(5)])
    assert v["verdict"] == "flat"


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_leak_verdict_matches_reference_on_seeded_series(seed):
    """Seeded series (a trend, noise, a sawtooth, gaps of None) through
    both packages at the soak's threshold and at a tight one."""
    import random

    rng = random.Random(seed)
    slope = rng.choice([0.0, 50.0, 5_000.0])
    series = [
        (t * 0.5, None if rng.random() < 0.05 else
         1_000_000 + slope * t + rng.randrange(-20_000, 20_000)
         + (t % rng.randrange(3, 12)) * rng.choice([0, 1_000, 100_000]))
        for t in range(rng.randrange(2, 90))
    ]
    _verdict(series)
    _verdict(series, threshold_pct_per_min=0.5, min_samples=4, min_r2=0.2)


def test_sample_process_reports_real_resources(tmp_path):
    (tmp_path / "blob").write_bytes(b"x" * 4096)
    sample = torch_resources.sample_process(dirs={"store": str(tmp_path)})
    ref = jax_resources.sample_process(dirs={"store": str(tmp_path)})
    assert set(sample) == set(ref)
    assert sample["rss_bytes"] > 1_000_000
    assert sample["open_fds"] > 0
    assert sample["threads"] >= 1
    assert sample["disk.store"] == ref["disk.store"] >= 4096
    assert torch_resources.dir_bytes(str(tmp_path / "absent")) == 0


# ----------------------------------------------------------------------
# The resource sampler
# ----------------------------------------------------------------------


def _fake_card(monkeypatch, sample):
    monkeypatch.setattr(torch_device, "memory_sample", lambda: sample)


def test_sampler_feeds_gauges_and_keeps_device_series_out_of_the_fit(
        tmp_path, monkeypatch):
    _fake_card(monkeypatch, {"live_buffers": 3, "live_buffer_bytes": 4096,
                             "hbm_bytes": 1 << 21})
    reg = Registry()
    sampler = torch_resources.ResourceSampler(
        registry=reg, dirs={"wal": str(tmp_path)}, device="cuda")
    for _ in range(3):
        sample = sampler.sample_once()
    assert sample["device.hbm_bytes"] == 1 << 21
    series = sampler.snapshot_series()
    assert len(series["device.live_buffers"]) == 3
    assert set(sampler.verdicts()) == {
        "rss_bytes", "open_fds", "threads", "disk.wal"}
    assert reg.gauge("mirbft_device_hbm_bytes").value == 1 << 21
    assert reg.gauge("mirbft_device_live_buffers").value == 3
    assert reg.gauge("mirbft_resource_disk_bytes", store="wal").value == 0
    assert reg.gauge("mirbft_resource_threads").value >= 1
    assert sampler.failed_ticks == 0


def test_sampler_on_a_card_counts_a_tick_it_cannot_read(monkeypatch):
    """Told it watches a card, the sampler fails the tick whose allocator
    gauges are unreadable, and its loop counts every failed tick: a soak
    gates on the count instead of a series that quietly lacks the card."""
    _fake_card(monkeypatch, None)
    sampler = torch_resources.ResourceSampler(interval_s=0.05, device="cuda")
    with pytest.raises(RuntimeError, match="allocator"):
        sampler.sample_once()
    sampler.start()
    deadline = time.monotonic() + 10.0
    while sampler.failed_ticks < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    sampler.stop()
    assert sampler.failed_ticks >= 2
    assert "allocator" in sampler.last_error
    assert not any(name.startswith("device.")
                   for name in sampler.snapshot_series())
    # On the CPU no card is asked for: the same reading is a good tick.
    cpu = torch_resources.ResourceSampler(device="cpu")
    assert "device.hbm_bytes" not in cpu.sample_once()
    assert cpu.failed_ticks == 0


def test_sampler_counts_a_failed_tick_and_keeps_sampling(monkeypatch):
    calls = []

    def flaky(dirs=None):
        calls.append(1)
        if len(calls) == 2:
            raise OSError("/proc raced away")
        return {"rss_bytes": 1, "open_fds": 1, "threads": 1}

    monkeypatch.setattr(torch_resources, "sample_process", flaky)
    _fake_card(monkeypatch, None)
    sampler = torch_resources.ResourceSampler(interval_s=0.05).start()
    deadline = time.monotonic() + 10.0
    while len(calls) < 4 and time.monotonic() < deadline:
        time.sleep(0.01)
    sampler.stop()
    assert sampler.failed_ticks == 1
    assert "raced away" in sampler.last_error
    assert len(sampler.snapshot_series()["rss_bytes"]) == len(calls) - 1


# ----------------------------------------------------------------------
# Diff gate consumes soak verdicts
# ----------------------------------------------------------------------


def _bench_artifact(leak):
    return {
        "schema": "mirbft-bench/1",
        "stages": {},
        "soak": {"seconds": 30.0, "commits": 100, "leak": leak},
    }


def test_diff_leak_gate_fails_on_growing(tmp_path):
    a = tmp_path / "a.json"
    b = tmp_path / "b.json"
    a.write_text(json.dumps(_bench_artifact({})))
    b.write_text(json.dumps(_bench_artifact({
        "rss_bytes": {"verdict": "growing", "confidence": 0.97,
                      "rel_pct_per_min": 12.0, "first": 1e6, "last": 2e6},
        "open_fds": {"verdict": "flat", "confidence": 1.0},
    })))
    report = torch_diff.diff_files(str(a), str(b))
    assert report == jax_diff.diff_files(str(a), str(b))
    assert not report["ok"]
    assert [f["series"] for f in report["leak_failures"]] == ["soak.rss_bytes"]
    assert "LEAK" in torch_diff.render_report(report)
    assert torch_diff.render_report(report) == jax_diff.render_report(report)
    for main in MAINS.values():
        assert main(["--diff", str(a), str(b)]) == 1
    b.write_text(json.dumps(_bench_artifact(
        {"rss_bytes": {"verdict": "flat", "confidence": 0.9}})))
    for main in MAINS.values():
        assert main(["--diff", str(a), str(b)]) == 0


# ----------------------------------------------------------------------
# The device gate and the bench-stream recovery
# ----------------------------------------------------------------------


def _write(tmp_path, name, doc):
    path = tmp_path / name
    path.write_text(json.dumps(doc))
    return path


def _device_section(**overrides):
    section = {
        "kernel_seconds": {},
        "retraces": {},
        "retrace_budget": 8,
        "retrace_breaches": [],
        "transfer_bytes": {},
        "divergence_total": 0,
    }
    section.update(overrides)
    return section


def test_diff_gate_fails_on_breach_divergence_and_soak(tmp_path):
    base = {"metric": "bench", "sha_per_sec": 10.0}
    pa = _write(tmp_path, "a.json", dict(base, device=_device_section()))
    for main in MAINS.values():
        assert main(["--diff", str(pa), str(pa)]) == 0
    breach = dict(base, device=_device_section(
        retraces={"poly": 9}, retrace_breaches=["poly"]))
    divergent = dict(base, device=_device_section(divergence_total=3))
    soaked = dict(base, soak={"divergence": 2})
    for bad in (breach, divergent, soaked):
        pb_path = _write(tmp_path, "b.json", bad)
        report = torch_diff.diff_files(pa, pb_path)
        assert report == jax_diff.diff_files(pa, pb_path)
        assert report["ok"] is False
        assert report["device_failures"]
        for main in MAINS.values():
            assert main(["--diff", str(pa), str(pb_path)]) == 1


def test_device_series_extraction_gates_retraces_not_calls():
    doc = {"device": _device_section(
        retraces={"fn_a": 3},
        kernel_seconds={"k": {"count": 7, "total_s": 0.7, "mean_ms": 100.0}},
        transfer_bytes={"h2d": 1024},
    )}
    series = torch_diff.extract_series(doc)
    assert series == jax_diff.extract_series(doc)
    assert series["device.fn_a.retraces"] == 3.0
    assert series["device.k.mean_ms"] == 100.0
    assert series["device.k.calls"] == 7.0
    assert series["device.transfer.h2d"] == 1024.0
    assert torch_diff.direction("device.fn_a.retraces") == "lower"
    assert torch_diff.direction("device.k.mean_ms") == "lower"
    assert torch_diff.direction("device.k.calls") is None


def test_load_artifact_prefers_journal_final_line(tmp_path):
    payload = {"metric": "bench", "sha_per_sec": 10.0}
    lines = [
        {"schema": "mirbft-bench-stream/1", "kind": "header", "pid": 123},
        {"kind": "stage", "stage": "sha", "seconds": 1.5, "status": "ok"},
        {"kind": "final", "payload": payload},
    ]
    path = tmp_path / "BENCH_stream.jsonl"
    path.write_text("\n".join(json.dumps(line) for line in lines) + "\n")
    assert torch_diff.load_artifact(path) == payload
    assert jax_diff.load_artifact(path) == payload


def test_load_artifact_rebuilds_killed_run_from_stage_lines(tmp_path):
    lines = [
        json.dumps({"schema": "mirbft-bench-stream/1", "kind": "header",
                    "pid": 99}),
        json.dumps({"kind": "stage", "stage": "sha", "seconds": 1.5,
                    "status": "ok"}),
        json.dumps({"kind": "stage", "stage": "ed", "seconds": 2.5,
                    "status": "ok"}),
    ]
    path = tmp_path / "BENCH_stream.jsonl"
    path.write_text("\n".join(lines) + "\n" + '{"kind": "stage", "sta')
    doc = torch_diff.load_artifact(path)
    assert doc == jax_diff.load_artifact(path)
    assert doc["recovered"] is True
    assert doc["schema"].startswith("mirbft-bench-recovered")
    assert doc["pid"] == 99
    assert doc["stages"]["sha"]["seconds"] == 1.5
    series = torch_diff.extract_series(doc)
    assert series == jax_diff.extract_series(doc)
    assert series["stage.sha.seconds"] == 1.5
    assert series["stage.ed.seconds"] == 2.5


# ----------------------------------------------------------------------
# Soak smoke (seconds-scale)
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def soak():
    from mirbft_tpu_torch import bench

    return bench.soak_run(duration_s=6.0, sample_interval_s=0.25,
                          device="cpu")


def test_soak_smoke_commits_and_emits_verdicts(soak):
    assert soak["commits"] > 0
    assert soak["samples"] >= 8
    assert set(soak["leak"]) == {
        "rss_bytes", "open_fds", "threads", "disk.reqstore", "disk.wal"}
    for verdict in soak["leak"].values():
        assert verdict["verdict"] in ("flat", "growing")
    assert soak["leak"]["open_fds"]["verdict"] == "flat"
    assert soak["leak"]["threads"]["verdict"] == "flat"


def test_soak_smoke_on_the_kernels_plain_version(soak):
    """The port's additions to the document: every digest launched (on
    the CPU, the kernel's plain version), none on the host, no frame
    dropped, no failed tick, no divergence; no card, so no ``device.*``
    series."""
    assert soak["device"] == "cpu"
    assert soak["launches"] > 0 and soak["device_digests"] > 0
    assert soak["host_digests"] == 0
    assert soak["frames_dropped"] == [0, 0, 0, 0]
    assert soak["failed_ticks"] == 0 and soak["last_error"] is None
    assert soak["divergence"] == 0
    assert soak["device_samples"] == 0


def test_soak_artifact_through_the_diff_gate(soak, tmp_path):
    """As chip_smoke's phase 19 does: the soak's artifact against itself
    passes both packages' gate; one verdict set ``growing`` fails it."""
    doc = {"soak": soak}
    flat = copy.deepcopy(doc)
    for verdict in flat["soak"]["leak"].values():
        verdict["verdict"] = "flat"
    grown = copy.deepcopy(flat)
    grown["soak"]["leak"]["rss_bytes"]["verdict"] = "growing"
    a = _write(tmp_path, "a.json", flat)
    b = _write(tmp_path, "b.json", grown)
    for main in MAINS.values():
        assert main(["--diff", str(a), str(a)]) == 0
        assert main(["--diff", str(a), str(b)]) == 1
    assert torch_diff.diff_files(a, b) == jax_diff.diff_files(a, b)
