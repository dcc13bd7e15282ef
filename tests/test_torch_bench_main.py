"""The port's bench ``main`` (``python -m mirbft_tpu_torch.bench``) held to the
JAX package's root ``bench.py``.

Mirrors the 11 cases of ``tests/test_bench.py`` on the port's
``StageRunner``, ``Watchdog`` and ``BenchStream`` (the SIGKILL-mid-rung case
on ``mirbft_tpu_torch.bench``), ``tests/test_device_obsv.py:398, :413``
(``--recover`` and the budget clamp) and the ``start_capture`` cases of
``tests/test_device_obsv.py:104-195``, each capture case run through both
packages' ``obsv/device.py`` and compared.  Then ``main(device="cpu")``
with every stage function replaced by a stub: its stage names and payload
keys equal the JAX ``main``'s (read from its source, as
``tests/test_bench.py:114`` reads it), every value is present but the keys
null by design, a stage's error returns 1 and a budget timeout 0 (rung 5's
too, with its keys null and the stage told to stop), and on
``cuda`` without a card ``main`` prints one JSON line naming the missing
card and runs no stage.  Tolerance: exact; the wall-clock fields are held
to the original cases' bounds.
"""

import ast
import inspect
import json
import os
import pathlib
import signal
import subprocess
import sys
import textwrap
import threading
import time
import types

import numpy as np
import pytest
import torch

import bench as jax_bench
from mirbft_tpu.obsv import device as jax_device
from mirbft_tpu.obsv.metrics import Registry as JaxRegistry
from mirbft_tpu_torch import bench
from mirbft_tpu_torch import loadgen
from mirbft_tpu_torch.obsv import device, hooks
from mirbft_tpu_torch.obsv.diff import apply_device_gate
from mirbft_tpu_torch.obsv.metrics import Registry

REPO = pathlib.Path(__file__).resolve().parent.parent


# -- tests/test_bench.py, on the port ------------------------------------------


def test_stage_runner_marks_wedged_stage_timeout():
    runner = bench.StageRunner(budget_s=60.0, registry=Registry(),
                               stage_budget_s=0.2)
    release = threading.Event()
    try:
        result = runner.run("wedged", lambda: release.wait(timeout=30.0))
        assert result is None
        assert runner.status["wedged"]["status"] == "timeout"
        # Later stages still run on the remaining budget.
        assert runner.run("after", lambda: "ok") == "ok"
        assert runner.status["after"]["status"] == "ok"
    finally:
        release.set()


def test_stage_runner_records_errors_without_crashing():
    runner = bench.StageRunner(budget_s=60.0, registry=Registry())

    def boom():
        raise RuntimeError("stage blew up")

    assert runner.run("bad", boom) is None
    entry = runner.status["bad"]
    assert entry["status"] == "error"
    assert "stage blew up" in entry["detail"]
    report = runner.stage_report()
    assert report["bad"]["seconds"] is not None


def test_stage_runner_skips_disabled_and_exhausted_stages():
    runner = bench.StageRunner(budget_s=60.0, registry=Registry())
    assert runner.run("off", lambda: 1, enabled=False, detail="why") is None
    assert runner.status["off"] == {"status": "skipped", "detail": "why"}
    runner.deadline = time.monotonic()  # no runway left
    assert runner.run("late", lambda: 1) is None
    assert runner.status["late"]["detail"] == "budget exhausted"


def test_watchdog_emits_final_json_and_names_wedged_stage():
    """A stage that never yields: the watchdog still gets the final JSON
    line out, marks the stage timeout, and exits with 1."""
    runner = bench.StageRunner(budget_s=60.0, registry=Registry())
    lines, codes = [], []
    dog = bench.Watchdog(
        runner, deadline_s=0.1, emit=lines.append, exit_fn=codes.append
    )
    dog.start()
    release = threading.Event()
    try:
        t = threading.Thread(
            target=lambda: runner.run(
                "stuck", lambda: release.wait(timeout=30.0)
            ),
            daemon=True,
        )
        t.start()
        assert dog.fired.wait(timeout=5.0), "watchdog never fired"
    finally:
        release.set()
    assert codes == [1]
    payload = json.loads(lines[0])
    assert payload["watchdog_fired"] is True
    assert payload["wedged_stage"] == "stuck"
    assert payload["stages"]["stuck"]["status"] == "timeout"
    assert payload["metric"] == "committed_reqs_per_sec_per_chip"
    assert payload["value"] is None


def test_watchdog_cancel_prevents_firing():
    runner = bench.StageRunner(budget_s=60.0, registry=Registry())
    lines, codes = [], []
    dog = bench.Watchdog(
        runner, deadline_s=0.05, emit=lines.append, exit_fn=codes.append
    )
    dog.start()
    dog.cancel()
    time.sleep(0.15)
    assert not dog.fired.is_set()
    assert lines == [] and codes == []
    dog.fire("too late")  # after cancel: a no-op
    assert lines == [] and codes == []


def test_watchdog_fire_is_idempotent():
    runner = bench.StageRunner(budget_s=60.0, registry=Registry())
    lines, codes = [], []
    dog = bench.Watchdog(
        runner, deadline_s=60.0, emit=lines.append, exit_fn=codes.append
    )
    dog.fire("first")
    dog.fire("second")
    assert len(lines) == 1 and codes == [1]


def test_live_payload_keys_present_in_main_schema():
    """The acceptance keys, spelled as a reader greps for them, in the
    port's payload literal."""
    src = inspect.getsource(bench._run_stages)
    for key in (
        "live_reqs_per_sec_serial", "live_reqs_per_sec_pipelined",
        "live_pipelined_speedup", "live_attack_goodput_per_sec",
        "live_attack_commit_p95_ms", "live_attack_clean_goodput_per_sec",
        "live_attack_clean_commit_p95_ms", "live_attack_goodput_ratio",
    ):
        assert f'"{key}"' in src, key


def test_bench_stream_journals_stages_as_they_finish(tmp_path):
    path = str(tmp_path / "stream.jsonl")
    stream = bench.BenchStream(path)
    registry = Registry()
    runner = bench.StageRunner(budget_s=60.0, registry=registry,
                               stream=stream)
    assert runner.run("fast", lambda: 41 + 1) == 42
    # The stage line is durable before any later stage runs.
    lines = [json.loads(line) for line in open(path)]
    assert lines[0]["kind"] == "header"
    assert lines[0]["schema"] == bench.BenchStream.SCHEMA
    assert lines[0]["schema"] == jax_bench.BenchStream.SCHEMA
    assert lines[-1] == {
        "kind": "stage",
        "stage": "fast",
        "seconds": lines[-1]["seconds"],
        "status": "ok",
    }
    runner.run("boom", lambda: 1 / 0)
    stream.final({"metric": "m", "value": 1.0})
    stream.close()
    lines = [json.loads(line) for line in open(path)]
    assert [line["kind"] for line in lines] == [
        "header", "stage", "stage", "final"
    ]
    assert lines[2]["stage"] == "boom" and lines[2]["status"] == "error"
    assert lines[3]["payload"]["value"] == 1.0


def test_bench_stream_swallows_unwritable_path(tmp_path):
    stream = bench.BenchStream(str(tmp_path / "no" / "such" / "dir.jsonl"))
    stream.final({"x": 1})  # must not raise
    stream.close()


def test_stage_runner_warmup_excluded_from_timed_window():
    registry = Registry()
    runner = bench.StageRunner(budget_s=60.0, registry=registry)
    result = runner.run(
        "warm",
        lambda: time.sleep(0.02) or "done",
        warmup=lambda: time.sleep(0.15),
    )
    assert result == "done"
    entry = runner.status["warm"]
    assert entry["status"] == "ok"
    assert entry["compile_s"] >= 0.15
    timed = registry.gauge("mirbft_bench_stage_seconds", stage="warm").value
    compile_s = registry.gauge(
        "mirbft_bench_stage_compile_seconds", stage="warm"
    ).value
    assert compile_s >= 0.15
    assert timed < compile_s  # the warm-up stayed out of the stage's time


def test_stream_survives_sigkill_mid_rung(tmp_path):
    """SIGKILL while a stage is mid-flight leaves a valid journal carrying
    every stage that already finished."""
    path = str(tmp_path / "BENCH_stream.jsonl")
    script = (
        "import threading\n"
        "from mirbft_tpu_torch import bench\n"
        "from mirbft_tpu_torch.obsv.metrics import Registry\n"
        f"stream = bench.BenchStream({path!r})\n"
        "runner = bench.StageRunner(budget_s=600.0, registry=Registry(),\n"
        "                           stream=stream)\n"
        "runner.run('first', lambda: 'ok')\n"
        "runner.run('second', lambda: 'ok')\n"
        "print('RUNGS-DONE', flush=True)\n"
        "runner.run('wedged', threading.Event().wait)\n"
    )
    proc = subprocess.Popen(
        [sys.executable, "-c", script], cwd=str(REPO),
        stdout=subprocess.PIPE, text=True,
    )
    try:
        assert proc.stdout.readline().strip() == "RUNGS-DONE"
        proc.kill()  # SIGKILL: no atexit, no flush handlers
        proc.wait(timeout=30)
        assert proc.returncode == -signal.SIGKILL
    finally:
        if proc.poll() is None:
            proc.kill()
    lines = [json.loads(line) for line in open(path)]  # every line parses
    assert [line["kind"] for line in lines] == ["header", "stage", "stage"]
    assert [line["stage"] for line in lines[1:]] == ["first", "second"]
    assert all(line["status"] == "ok" for line in lines[1:])


# -- tests/test_device_obsv.py:398, :413 -----------------------------------------


def test_bench_recover_cli_prints_recovered_json(tmp_path, capsys):
    payload = {"metric": "bench", "sha_per_sec": 10.0}
    path = tmp_path / "BENCH_stream.jsonl"
    path.write_text(
        json.dumps({"schema": "mirbft-bench-stream/1", "kind": "header"})
        + "\n"
        + json.dumps({"kind": "final", "payload": payload})
        + "\n"
    )
    assert bench.recover_main([str(path)]) == 0
    assert json.loads(capsys.readouterr().out) == payload
    assert bench.recover_main([str(tmp_path / "missing.jsonl")]) == 1
    assert "error" in json.loads(capsys.readouterr().out)


def test_bench_budget_clamps_to_harness_timeout():
    grace = bench.WATCHDOG_GRACE_S + bench.HARNESS_MARGIN_S
    env = {"BENCH_BUDGET_S": "100000", "BENCH_HARNESS_TIMEOUT_S": "870"}
    assert bench.effective_budget_s(env) == 870.0 - grace
    env = {"BENCH_BUDGET_S": "120", "BENCH_HARNESS_TIMEOUT_S": "870"}
    assert bench.effective_budget_s(env) == 120.0
    # The defaults already fit under the harness timeout with margin.
    assert bench.effective_budget_s({}) == bench.DEFAULT_BUDGET_S


@pytest.mark.parametrize("env", [
    {},
    {"BENCH_BUDGET_S": "40"},
    {"BENCH_BUDGET_S": "1100"},
    {"BENCH_BUDGET_S": "1100", "BENCH_HARNESS_TIMEOUT_S": "1290"},
    {"BENCH_BUDGET_S": "5", "BENCH_HARNESS_TIMEOUT_S": "100"},
    {"BENCH_HARNESS_TIMEOUT_S": "120"},
    {"BENCH_HARNESS_TIMEOUT_S": "60"},
    {"BENCH_BUDGET_S": "700", "BENCH_HARNESS_TIMEOUT_S": "0"},
    {"BENCH_BUDGET_S": "0.5"},
])
def test_effective_budget_equals_the_jax_packages(env):
    assert bench.effective_budget_s(env) == jax_bench.effective_budget_s(env)


def test_bench_constants_equal_the_jax_packages():
    for name in ("DEFAULT_BUDGET_S", "HARNESS_TIMEOUT_S", "HARNESS_MARGIN_S",
                 "BENCH_RETRACE_BUDGET", "WATCHDOG_GRACE_S", "DEFAULT_SOAK_S",
                 "NODES", "CLIENTS", "REQS_PER_CLIENT", "BATCH_SIZE",
                 "READY_LATENCY_MS", "RUNG5_NODES", "RUNG5_CLIENTS",
                 "RUNG5_REQS"):
        assert getattr(bench, name) == getattr(jax_bench, name), name
    assert bench.StageRunner.MIN_RUNWAY_S == jax_bench.StageRunner.MIN_RUNWAY_S


# -- the start_capture cases of tests/test_device_obsv.py:104-195 ----------------


def _capture(package, registry, budget=None):
    """Run ``package``'s capture on ``registry`` with the hooks off."""
    package.reset()
    package.start_capture(registry, retrace_budget=budget)


@pytest.fixture
def hooks_off(monkeypatch):
    from mirbft_tpu.obsv import hooks as jax_hooks

    monkeypatch.setattr(hooks, "enabled", False)
    monkeypatch.setattr(jax_hooks, "enabled", False)
    yield
    for package in (device, jax_device):
        package.stop_capture()
        package.reset()


def test_capture_kernel_histogram_roundtrips_through_strict_catalog(hooks_off):
    reports = []
    for package, registry in ((device, Registry()), (jax_device, JaxRegistry())):
        _capture(package, registry)

        @package.instrument("toy_kernel")
        def f(x):
            return x + 1

        a = np.zeros(16, dtype=np.uint32)
        f(a)
        f(a)
        rep = package.report(registry)
        kern = rep["kernel_seconds"]["toy_kernel"]
        assert kern["count"] == 2
        assert kern["total_s"] >= 0.0 and kern["mean_ms"] >= 0.0
        series = registry.snapshot()["mirbft_device_kernel_seconds"]["series"]
        assert series[0]["labels"] == {"kernel": "toy_kernel"}
        reports.append(rep)
        package.stop_capture()
    port, ref = reports
    for key in ("retraces", "retrace_budget", "retrace_breaches",
                "divergence_total"):
        assert port[key] == ref[key], key
    assert port["retraces"] == {"f": 1} and port["retrace_breaches"] == []
    # The port counts a copy where the plane makes it (``transfer``), not
    # the arguments' bytes: an instrumented call on host arrays moves none.
    assert port["transfer_bytes"] == {}
    assert ref["transfer_bytes"] == {"h2d": 2 * a.nbytes, "d2h": 2 * a.nbytes}


def test_capture_counts_transfers_with_the_hooks_off(hooks_off):
    registry = Registry()
    _capture(device, registry)
    card = types.SimpleNamespace(type="cuda")
    device.transfer("h2d", 64, card)
    device.transfer("d2h", 32, card)
    device.transfer("h2d", 1024, torch.device("cpu"))  # no copy to a card
    assert device.report(registry)["transfer_bytes"] == {"h2d": 64, "d2h": 32}
    device.stop_capture()
    device.transfer("h2d", 64, card)  # capture off, hooks off: nothing
    assert device.report(registry)["transfer_bytes"] == {"h2d": 64, "d2h": 32}


def test_capture_shape_polymorphic_caller_trips_retrace_budget(hooks_off):
    reports = []
    for package, registry in ((device, Registry()), (jax_device, JaxRegistry())):
        _capture(package, registry, budget=2)

        @package.instrument("poly", fn_name="poly")
        def g(x):
            return x

        for n in range(1, 5):  # four distinct shapes
            g(np.zeros(n, dtype=np.uint8))
        rep = package.report(registry)
        assert rep["retraces"]["poly"] == 4
        assert rep["retrace_budget"] == 2
        assert "poly" in rep["retrace_breaches"]
        reports.append({k: rep[k] for k in (
            "retraces", "retrace_budget", "retrace_breaches")})
        package.stop_capture()
        # stop_capture restores the default budget.
        default = {device: device.RETRACE_BUDGET,
                   jax_device: jax_device.DEFAULT_RETRACE_BUDGET}[package]
        assert package.report(registry)["retrace_budget"] == default
    assert reports[0] == reports[1]
    report = {"ok": True}
    apply_device_gate(report, {"device": dict(reports[0])})
    assert report["ok"] is False
    [failure] = report["device_failures"]
    assert failure["kind"] == "retrace_budget"
    assert failure["series"] == "device.poly.retraces"


def test_capture_sequence_lengths_bucket_to_pow2_signatures(hooks_off):
    for package, registry in ((device, Registry()), (jax_device, JaxRegistry())):
        _capture(package, registry)

        @package.instrument("seqy", fn_name="seqy")
        def g(items):
            return items

        for n in (5, 6, 7, 8):  # all bucket to 8: one launch shape
            g(list(range(n)))
        assert package.report(registry)["retraces"]["seqy"] == 1
        g(list(range(9)))  # bucket 16: a new one
        assert package.report(registry)["retraces"]["seqy"] == 2
        package.stop_capture()


def test_capture_wins_over_the_hooks_registry(monkeypatch):
    """With both a capture and the hooks on, a launch lands in the
    capture's registry only, in both packages."""
    from mirbft_tpu.obsv import hooks as jax_hooks

    for package, hook_module, make in (
        (device, hooks, Registry), (jax_device, jax_hooks, JaxRegistry),
    ):
        captured, hooked = make(), make()
        hook_module.enable(registry=hooked)
        try:
            _capture(package, captured)

            @package.instrument("both", fn_name="both")
            def h(x):
                return x

            h(np.zeros(4, dtype=np.uint8))
            assert package.report(captured)["kernel_seconds"]["both"][
                "count"] == 1
            assert "both" not in package.report(hooked)["kernel_seconds"]
        finally:
            package.stop_capture()
            package.reset()
            hook_module.disable()


# -- main, with every stage stubbed --------------------------------------------------


def _jax_ackplane_keys() -> set:
    tree = ast.parse(inspect.getsource(jax_bench.ackplane_run))
    returns = [n.value for n in ast.walk(tree)
               if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)]
    final = max(returns, key=lambda node: len(node.keys))
    return {k.value for k in final.keys} - {"ack_events_counter"}


def _jax_rung3_stats_keys() -> set:
    tree = ast.parse(inspect.getsource(jax_bench.rung3_run))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and node.targets[0].id == "stats"):
            return {k.value for k in node.value.keys}
    raise AssertionError("no stats dict in the JAX rung3_run")


def jax_main_schema() -> tuple:
    """(stage names in order, payload keys) of the JAX ``main``, from its
    source: the ``payload`` literal, its ``**`` entries (rung 3's stats,
    the ackplane rung's keys), its subscript assignments and its
    ``update``."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(jax_bench.main)))
    stages, keys = [], set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "run"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "runner"):
            stages.append((node.lineno, node.args[0].value))
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(getattr(t, "id", None) == "payload"
                        for t in node.targets):
            for key, value in zip(node.value.keys, node.value.values):
                if key is not None:
                    keys.add(key.value)
                elif isinstance(value, ast.Name):
                    assert value.id == "rung3_stats"
                    keys |= _jax_rung3_stats_keys()
                else:
                    assert isinstance(value, ast.DictComp)
                    keys |= {f"ackplane_{k}" for k in _jax_ackplane_keys()}
        if isinstance(node, ast.Assign) and isinstance(
                node.targets[0], ast.Subscript) and getattr(
                node.targets[0].value, "id", None) == "payload":
            keys.add(node.targets[0].slice.value)
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "update"
                and getattr(node.func.value, "id", None) == "payload"):
            keys |= {k.value for k in node.args[0].keys}
    return [name for _line, name in sorted(stages)], keys


#: Null in every port payload: no XLA route, no offload calibration (no
#: host route to calibrate against).
NULL_BY_DESIGN = {
    "kernel_compressions_per_sec_xla",
    "crypto_plane_device_rtt_ms",
    "crypto_plane_min_device_rows",
}

#: The rung-5 keys, null when its stage does not finish.
RUNG5_KEYS = {"rung5_committed_reqs_per_sec", "rung5_engine_events"}


def _step(name, cls=loadgen.StepResult, **extra):
    step = cls(name=name, offered_rate_per_sec=25.0, duration_s=2.0,
               submitted=50, committed=50, latencies_ms=[10.0, 20.0], **extra)
    step.finalize()
    return step


def _clean_workers(n: int) -> dict:
    """A worker rung's exit codes and evidence where every worker exited
    0 and logged no fault."""
    return {
        "exit_codes": {node: [0] for node in range(n)},
        "evidence": {node: {"log_faults": []} for node in range(n)},
    }


class Stubs:
    """Every stage function of the port's bench, returning the shapes the
    real ones return; ``calls`` lists the stages that ran."""

    def __init__(self):
        self.calls = []
        self.release = threading.Event()

    def install(self, monkeypatch, **override):
        def stub(name, value):
            def fn(*_args, **_kwargs):
                self.calls.append(name)
                if name in override:
                    return override[name]()
                return value() if callable(value) else value
            monkeypatch.setattr(bench, name, fn)

        kv = loadgen.KvStepResult(
            name="app-kv-mixed", offered_rate_per_sec=0.0, duration_s=4.0,
            submitted=160, committed=160, reads=80, writes=80,
            latencies_ms=[5.0, 9.0], read_latencies_ms=[5.0],
            write_latencies_ms=[9.0],
        )
        kv.finalize()
        stub("live_cluster_rate", {"rate": 300.0, "p95_ms": 40.0})
        stub("soak_run", {"seconds": 30.0, "commits": 280, "leak": {}})
        stub("live_attack_run", {
            "clean_rate": 350.0, "clean_p95_ms": 40.0, "flood_rate": 280.0,
            "flood_p95_ms": 80.0, "flooded": 1000,
        })
        stub("live_mp_run", lambda: {
            "steps": [_step("cuda-poisson-25")], "goodput_per_sec": 25.0,
            "p95_ms": 300.0, **_clean_workers(4),
        })
        stub("reconfig_run", lambda: {
            "steps": [_step("reconfig-steady"), _step("reconfig-add-node")],
            "evidence": {"adoptions": 4, "joined": True},
            "exit_codes": _clean_workers(5)["exit_codes"],
            "kernels": _clean_workers(5)["evidence"],
        })
        stub("app_run", lambda: {"step": kv, **_clean_workers(8)})
        stub("knee_run", {"schema": "mirbft-capacity/1",
                          "knee_rate_per_sec": 128.0, "configs": []})
        stub("warm_kernel_shapes", None)
        stub("ladder_run", lambda: bench.RungResult(
            (2.5, 26000, b"\x01" * 32, 9000)))
        stub("kernel_microbench", {
            "chain_rate": 1.79e10, "kernel_digest_rate": 1.6e9,
            "host_rate": 1.0e6,
        })
        stub("sha256_microbench_warmup", 0.1)
        stub("ed25519_microbench", (1.0e5, 130.0))
        stub("ed25519_microbench_warmup", None)
        stub("rung3_run", lambda: bench.RungResult((
            380.0, 5.2, 43280, 8192, {
                "rung3_speculative_admits": 8192,
                "rung3_speculative_evictions": 0,
                "rung3_forced_joins": 0,
                "rung3_device_verifies": 8192,
                "rung3_host_verifies": 0,
            }, 7000)))
        stub("rung4_run", {
            "reqs_per_sec": 6.8, "events": 241543, "certificates": 1,
            "aggregate_ms": 1.5, "sim_ms": 5077,
        })
        stub("rung5_run", {
            "reqs_per_sec": 0.9, "events": 5442215, "sim_ms": 40901,
        })
        stub("ackplane_run", lambda: {
            **{key: 1 for key in bench.ACKPLANE_KEYS},
            "frame": 12500, "step_launches": 24, "sweep_launches": 1,
            "plane": {}, "ack_events_counter": {},
        })
        return self


@pytest.fixture
def bench_env(monkeypatch, tmp_path):
    monkeypatch.setenv("BENCH_STREAM_PATH", str(tmp_path / "stream.jsonl"))
    monkeypatch.setenv("BENCH_STAGE_BUDGET_S", "60")
    for name in ("BENCH_BUDGET_S", "BENCH_HARNESS_TIMEOUT_S", "BENCH_SOAK_S",
                 "BENCH_RETRACE_BUDGET"):
        monkeypatch.delenv(name, raising=False)
    return tmp_path


def _main(capsys, device="cpu") -> tuple:
    rc = bench.main(device=device)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1, lines
    return rc, json.loads(lines[0])


def test_main_schema_equals_the_jax_mains(bench_env, monkeypatch, capsys):
    stubs = Stubs().install(monkeypatch)
    rc, payload = _main(capsys)
    assert rc == 0
    jax_stages, jax_keys = jax_main_schema()
    assert list(payload["stages"]) == jax_stages == list(bench.STAGES)
    assert set(payload) == jax_keys
    assert {k for k, v in payload.items() if v is None} == NULL_BY_DESIGN
    for name, entry in payload["stages"].items():
        assert entry["status"] == "ok", (name, entry)
    assert list(payload["stages"])[-1] == "rung5"
    assert payload["rung5_engine_events"] == 5442215
    assert payload["rung5_committed_reqs_per_sec"] == 0.9
    assert payload["engine_gauges"]["rung5"] == {"events": 5442215,
                                                 "sim_ms": 40901}
    assert payload["stages"]["sha256_microbench"]["compile_s"] >= 0.0
    assert payload["ladder_consistent"] is True
    assert payload["rung3_engine_events"] == 43280
    assert payload["rung4_engine_events"] == 241543
    assert payload["crypto_plane_host_digests"] == 0
    assert payload["device"]["retrace_breaches"] == []
    assert payload["device"]["retrace_budget"] == bench.BENCH_RETRACE_BUDGET
    assert payload["engine_gauges"]["rung3"] == {"events": 43280,
                                                 "sim_ms": 7000}
    assert "8 worker processes" in payload["app_config"]
    assert payload["loadgen_app"]["meta"]["cluster"] == "mp-app"
    assert "cuda" in payload["live_config"]
    # The capture stops with main.
    assert device._capture_registry is None
    assert "live_cluster_rate" in stubs.calls


def test_main_journal_recovers_to_the_printed_payload(bench_env, monkeypatch,
                                                      capsys):
    Stubs().install(monkeypatch)
    rc, payload = _main(capsys)
    assert rc == 0
    path = bench_env / "stream.jsonl"
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert lines[0]["kind"] == "header"
    assert [line["stage"] for line in lines[1:-1]] == list(bench.STAGES)
    assert lines[-1] == {"kind": "final", "payload": payload}
    assert bench.recover_main([str(path)]) == 0
    assert json.loads(capsys.readouterr().out) == payload


def test_a_stage_error_returns_1(bench_env, monkeypatch, capsys):
    def broken():
        raise RuntimeError("the ladder kernel did not launch")

    Stubs().install(monkeypatch, rung3_run=broken)
    rc, payload = _main(capsys)
    assert rc == 1
    entry = payload["stages"]["rung3"]
    assert entry["status"] == "error"
    assert "did not launch" in entry["detail"]
    # The other stages ran and kept their figures.
    assert payload["stages"]["rung4"]["status"] == "ok"
    assert payload["rung4_engine_events"] == 241543
    assert payload["rung3_engine_events"] is None


def _faulty(result: dict, fault: str) -> dict:
    """``result`` with node 1 exiting 5 or logging a traceback."""
    out = {key: dict(value) if isinstance(value, dict) else value
           for key, value in result.items()}
    evidence = "kernels" if "kernels" in out else "evidence"
    if fault == "exit":
        out["exit_codes"][1] = [5]
    else:
        out[evidence][1] = {"log_faults": [
            "Traceback (most recent call last): | RuntimeError: boom"]}
    return out


@pytest.mark.parametrize("fault", ["exit", "log"])
@pytest.mark.parametrize("stage, fn", [
    ("live_mp_serial", "live_mp_run"),
    ("live_mp_pipelined", "live_mp_run"),
    ("live_mp_reconfig", "reconfig_run"),
    ("app_kv", "app_run"),
])
def test_a_worker_fault_fails_its_stage(bench_env, monkeypatch, capsys,
                                        stage, fn, fault):
    """A worker that exits non-zero, or whose log shows a fault, ends its
    stage ``error`` with the node named, and the bench returns 1; the
    payload keeps its keys."""
    Stubs().install(monkeypatch)
    clean = getattr(bench, fn)
    # live_mp_run runs twice: the serial stage's call, then the pipelined.
    faulty_call = 2 if stage == "live_mp_pipelined" else 1
    calls = []

    def stage_fn(*args, **kwargs):
        calls.append(1)
        result = clean(*args, **kwargs)
        return _faulty(result, fault) if len(calls) == faulty_call else result

    monkeypatch.setattr(bench, fn, stage_fn)
    rc, payload = _main(capsys)
    assert rc == 1
    _stages, jax_keys = jax_main_schema()
    # No key added; the app artifact goes with its stage, as in the JAX
    # main.
    missing = {"loadgen_app"} if stage == "app_kv" else set()
    assert set(payload) == jax_keys - missing
    for name, entry in payload["stages"].items():
        want = "error" if name == stage else "ok"
        assert entry["status"] == want, (name, entry)
    detail = payload["stages"][stage]["detail"]
    assert "worker fault" in detail and "node 1" in detail
    assert ("exit codes [5]" if fault == "exit" else "RuntimeError: boom") \
        in detail


def test_a_ladder_mismatch_returns_1(bench_env, monkeypatch, capsys):
    walls = iter([(2.5, 26000, b"\x01" * 32, 9000),
                  (2.4, 26001, b"\x01" * 32, 9000)])
    Stubs().install(monkeypatch,
                    ladder_run=lambda: bench.RungResult(next(walls)))
    rc, payload = _main(capsys)
    assert rc == 1
    assert payload["ladder_consistent"] is False


def test_a_budget_timeout_returns_0(bench_env, monkeypatch, capsys):
    stubs = Stubs()
    monkeypatch.setenv("BENCH_STAGE_BUDGET_S", "0.3")
    stubs.install(monkeypatch, soak_run=lambda: stubs.release.wait(30.0))
    try:
        rc, payload = _main(capsys)
    finally:
        stubs.release.set()
    assert rc == 0
    assert payload["stages"]["soak"]["status"] == "timeout"
    assert payload["soak"] is None
    assert payload["stages"]["ackplane"]["status"] == "ok"


def test_a_rung5_timeout_leaves_its_keys_null_and_returns_0(
        bench_env, monkeypatch, capsys):
    """Rung 5 past its stage budget: ``timeout``, both keys null, the
    payload printed and rc 0; the stage was told to stop."""
    monkeypatch.setenv("BENCH_STAGE_BUDGET_S", "0.3")
    Stubs().install(monkeypatch)
    seen = {}

    def wedged(**kwargs):
        seen.update(kwargs)
        seen["stopped"] = kwargs["cancel"].wait(30.0)

    monkeypatch.setattr(bench, "rung5_run", wedged)
    rc, payload = _main(capsys)
    assert rc == 0
    assert payload["stages"]["rung5"]["status"] == "timeout"
    assert {k for k, v in payload.items() if v is None} == (
        NULL_BY_DESIGN | RUNG5_KEYS)
    assert "rung5" not in payload["engine_gauges"]
    assert seen["device"] == "cpu" and seen["cancel"].is_set()


def test_rung5_stops_at_its_next_event_once_cancelled():
    cancel = threading.Event()
    cancel.set()
    with pytest.raises(bench.StageCancelled, match="stopped at 1 events"):
        bench.rung5_run(device="cpu", nodes=4, clients=2, crash_node=3,
                        cancel=cancel)


def test_stage_runner_cancels_an_overrunning_stage():
    """The runner sets ``cancel`` when a stage overruns; a stage that
    polls it ends instead of running on beside the later stages."""
    runner = bench.StageRunner(budget_s=60.0, registry=Registry(),
                               stage_budget_s=0.2)
    ended = threading.Event()

    def polling():
        cancel = runner.cancel
        while not cancel.wait(0.01):
            pass
        ended.set()

    assert runner.run("slow", polling) is None
    assert runner.status["slow"]["status"] == "timeout"
    assert ended.wait(5.0)
    assert runner.run("after", lambda: "ok") == "ok"
    assert not runner.cancel.is_set()


def test_no_card_prints_one_error_line_and_runs_no_stage(
        bench_env, monkeypatch, capsys):
    stubs = Stubs().install(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, payload = _main(capsys, device="cuda")
    assert rc == 1
    assert "no CUDA card" in payload["error"]
    assert payload["value"] is None
    assert stubs.calls == []
    assert not (bench_env / "stream.jsonl").exists()


def test_the_module_without_a_card_exits_1_with_its_error(tmp_path):
    """``python -m mirbft_tpu_torch.bench`` on a host with no card."""
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="",
               BENCH_STREAM_PATH=str(tmp_path / "stream.jsonl"))
    proc = subprocess.run(
        [sys.executable, "-m", "mirbft_tpu_torch.bench"], cwd=tmp_path,
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 1, proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == 1
    payload = json.loads(lines[0])
    assert "no CUDA card" in payload["error"]
    assert not (tmp_path / "stream.jsonl").exists()
