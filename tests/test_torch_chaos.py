"""The port's chaos campaign (``mirbft_tpu_torch/chaos``) on the
deterministic engine, held against the JAX package's (``mirbft_tpu/chaos``).

Mirrors ``tests/test_chaos.py``: its 21 tier-1 cases and its two slow
full-matrix cases.  Every scenario run goes through both packages on one
seed, the port's with its kernels on the CPU (``device="cpu"``: the
SHA-256, Ed25519 and BLS G1 kernels' plain versions).  Tolerance: exact
equality of verdict, violation, events, simulated ms, commits and the
counters, apart from the named fault-seam counters:

- ``fallback_digests`` and ``sig_fallbacks`` count the JAX planes' host
  rescues; the port has no host route, so they read 0 in the port;
- the port's own counters (``PORT_ONLY``): its breakers' probes, the rows
  it re-launched on a kernel, ``host_digests`` (0 by construction), its
  digest launches and each kernel wrapper's launches (0 on the CPU,
  where no kernel is launched).

The two device cases (``:212``, ``:280``) assert the port's retry
counters where the original asserts ``fallback_digests > 0`` and
``sig_fallbacks >= 1``: a failed launch is re-launched on the kernel.

On top: the pinned reference campaign (``tests/chaos_reference.py``),
regenerated from the JAX package for the smoke rows here and for every
row in the slow lane; the port's smoke rows against it; a persistent
device fault raising ``DevicePlaneError``; the CLI against the JAX CLI;
and the two reference failures of the full matrix shown on both packages.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest

import chaos_pin
import chaos_reference
from mirbft_tpu import pb as ref_pb
from mirbft_tpu.chaos import invariants as ref_invariants
from mirbft_tpu.chaos import runner as ref_runner
from mirbft_tpu.chaos import scenarios as ref_scenarios
from mirbft_tpu.testengine import BasicRecorder as RefRecorder
from mirbft_tpu.testengine.manglers import partition as ref_partition
from mirbft_tpu_torch import pb
from mirbft_tpu_torch.chaos import (
    ADVERSARY_SMOKE_NAMES,
    SMOKE_NAMES,
    CrashSnapshot,
    InvariantViolation,
    adversary_matrix,
    adversary_smoke_matrix,
    check_censorship_liveness,
    check_corruption_rejected,
    check_durable_prefix,
    check_flood_bounded,
    check_no_fork,
    check_no_fork_under_equivocation,
    matrix,
    run_campaign,
    run_scenario,
    smoke_matrix,
)
from mirbft_tpu_torch.chaos import invariants as port_invariants
from mirbft_tpu_torch.chaos.scenarios import _flaky_plane
from mirbft_tpu_torch.testengine import BasicRecorder
from mirbft_tpu_torch.testengine.crypto_plane import (
    AsyncKernelHashPlane,
    DevicePlaneError,
)
from mirbft_tpu_torch.testengine.manglers import partition

ROOT = Path(__file__).resolve().parent.parent

BY_NAME = {s.name: s for s in matrix()}
ADV_BY_NAME = {s.name: s for s in adversary_matrix()}
REF_BY_NAME = {s.name: s for s in ref_scenarios.matrix()}
REF_ADV_BY_NAME = {s.name: s for s in ref_scenarios.adversary_matrix()}

#: The JAX planes' host-rescue counters: 0 in the port.
FALLBACKS = ("fallback_digests", "sig_fallbacks")
#: Counters only the port keeps.
PORT_ONLY = frozenset({
    "breaker_probes", "device_retries", "sig_breaker_trips",
    "sig_breaker_probes", "sig_device_retries", "host_digests",
    "digest_launches", "launches_sha256", "launches_ed25519_decompress",
    "launches_ed25519_ladder", "launches_bls_g1",
})


def _same(ref, port) -> None:
    """The tolerance of every scenario case (module docstring)."""
    assert chaos_pin.row(port) == chaos_pin.row(ref)
    assert port.violation == ref.violation
    ref_counters = {k: v for k, v in ref.counters.items()
                    if k not in FALLBACKS}
    port_counters = {k: v for k, v in port.counters.items()
                     if k not in FALLBACKS and k not in PORT_ONLY}
    assert port_counters == ref_counters
    for key in FALLBACKS:
        assert port.counters.get(key, 0) == 0
    assert port.counters["host_digests"] == 0
    assert port.counters["launches_sha256"] == 0  # the plain route


def _pair(name: str, seed: int, adversary=False):
    ref = (REF_ADV_BY_NAME if adversary else REF_BY_NAME)[name]
    port = (ADV_BY_NAME if adversary else BY_NAME)[name]
    ref_result = ref_runner.run_scenario(ref, seed=seed)
    port_result = run_scenario(port, seed=seed, device="cpu")
    _same(ref_result, port_result)
    return port_result


# ---------------------------------------------------------------------------
# Partition mangler semantics
# ---------------------------------------------------------------------------


def _step_event(module_pb, source):
    return module_pb.StateEvent(
        type=module_pb.EventStep(
            source=source, msg=module_pb.Msg(type=module_pb.Suspect(epoch=0))
        )
    )


def _verdicts(module_pb, recorder, make, calls):
    m = make()
    out = []
    for at, node, kind, source in calls:
        event = (module_pb.StateEvent(type=module_pb.EventTick())
                 if kind == "tick" else _step_event(module_pb, source))
        got = m(recorder, at, node, event)
        out.append(None if got is None else (got[0], got[1]))
    return out, m.dropped


def _recorders():
    return (
        RefRecorder(node_count=4, client_count=1, reqs_per_client=1),
        BasicRecorder(node_count=4, client_count=1, reqs_per_client=1,
                      hash_plane=AsyncKernelHashPlane(device="cpu")),
    )


def test_partition_blocks_only_cross_group_inside_window():
    calls = [(500, 0, "step", 1), (1000, 0, "step", 1), (4999, 1, "step", 0),
             (3000, 3, "step", 2), (3000, 0, "tick", None),
             (5000, 0, "step", 1)]
    ref_rec, port_rec = _recorders()
    ref = _verdicts(ref_pb, ref_rec, lambda: ref_partition(
        [[0], [1, 2, 3]], from_ms=1000, until_ms=5000), calls)
    port = _verdicts(pb, port_rec, lambda: partition(
        [[0], [1, 2, 3]], from_ms=1000, until_ms=5000), calls)
    assert port == ref
    assert port == ([(500, 0), None, None, (3000, 3), (3000, 0), (5000, 0)],
                    2)


def test_partition_ignores_unlisted_nodes():
    calls = [(100, 0, "step", 2), (100, 2, "step", 0)]
    ref_rec, port_rec = _recorders()
    ref = _verdicts(ref_pb, ref_rec, lambda: ref_partition(
        [[0], [1]], from_ms=0, until_ms=10_000), calls)
    port = _verdicts(pb, port_rec, lambda: partition(
        [[0], [1]], from_ms=0, until_ms=10_000), calls)
    assert port == ref == ([(100, 0), (100, 2)], 0)


# ---------------------------------------------------------------------------
# Invariant checker detects violations (on doctored evidence), both packages
# ---------------------------------------------------------------------------


def _tiny_converged():
    ref = RefRecorder(node_count=4, client_count=1, reqs_per_client=3)
    ref.drain_clients(max_steps=200_000)
    port = BasicRecorder(node_count=4, client_count=1, reqs_per_client=3,
                         hash_plane=AsyncKernelHashPlane(device="cpu"))
    port.drain_clients(max_steps=200_000)
    assert port.node_states[0].committed_reqs == (
        ref.node_states[0].committed_reqs)
    return ref, port


def _verdict(check, *args, **kwargs):
    """``None`` if ``check`` passes, else its violation's text."""
    try:
        check(*args, **kwargs)
    except InvariantViolation as violation:
        return str(violation)
    except ref_invariants.InvariantViolation as violation:
        return str(violation)
    return None


def _on_both(name, doctor=None, *args, **kwargs):
    """Run invariant ``name`` of both packages on a converged run of each,
    doctored alike by ``doctor(recorder)``; the verdicts must agree."""
    ref, port = _tiny_converged()
    if doctor is not None:
        doctor(ref)
        doctor(port)
    got = _verdict(getattr(port_invariants, name), port, *args, **kwargs)
    assert got == _verdict(getattr(ref_invariants, name), ref, *args,
                           **kwargs)
    return got


def test_no_fork_passes_then_detects_doctored_fork():
    _ref, port = _tiny_converged()
    assert check_no_fork(port)

    def fork(rec):
        client, req_no, seq = rec.node_states[1].committed_reqs[0]
        rec.node_states[1].committed_reqs[0] = (client, req_no + 1000, seq)

    assert "fork at seq" in _on_both("check_no_fork", fork)


def test_no_fork_detects_duplicate_commit():
    def dup(rec):
        rec.node_states[2].committed_reqs.append(
            rec.node_states[2].committed_reqs[-1])

    assert _on_both("check_no_fork", dup) is not None


def test_durable_prefix_detects_lost_and_rewritten_commits():
    ref, port = _tiny_converged()
    final = port.node_states[0].committed_reqs
    cases = [
        (list(final[:2]), None),
        (list(final) + [(99, 99, 999)], "lost commits"),
        ([(98, 98, 998)] + list(final[1:2]), "rewrote durable history"),
    ]
    for committed, want in cases:
        got = _verdict(check_durable_prefix, port, [
            CrashSnapshot(node=0, at_ms=100, committed=committed)])
        ref_got = _verdict(ref_invariants.check_durable_prefix, ref, [
            ref_invariants.CrashSnapshot(node=0, at_ms=100,
                                         committed=committed)])
        assert got == ref_got
        assert (got is None) if want is None else (want in got)


def test_corruption_rejected_requires_exactly_100_percent():
    for args, want in (((5, 5), None), ((4, 5), "rejected 4 of 5"),
                       ((6, 5), "rejected 6 of 5"), ((0, 0), "vacuous")):
        got = _verdict(check_corruption_rejected, *args)
        assert got == _verdict(ref_invariants.check_corruption_rejected,
                               *args)
        assert (got is None) if want is None else (want in got)


def test_no_fork_under_equivocation_detects_divergence_and_vacuity():
    variants = {(1, 1): ((b"real",), (b"variant",))}
    assert _on_both("check_no_fork_under_equivocation", None,
                    variants) is None
    assert "vacuous" in _on_both("check_no_fork_under_equivocation", None,
                                 {})
    assert "never suspected" in _on_both(
        "check_no_fork_under_equivocation", None, variants,
        expect_suspicion=True)

    def diverge(rec):
        rec.node_states[1].app_chain = "doctored-divergent-chain"

    assert "diverge" in _on_both("check_no_fork_under_equivocation",
                                 diverge, variants)


def test_censorship_liveness_detects_starvation_lateness_and_vacuity():
    ref, port = _tiny_converged()
    cid = next(iter(port.clients))
    cases = [
        (({(cid, 0)}, {(cid, 0): 1}), None),
        ((set(), {}), "vacuous"),
        (({(cid, 999)}, {}), "never committed"),
        (({(cid, 0)}, {(cid, 0): 5}), "more than 3 epoch"),
        (({(cid, 0)}, {(cid, 0): 0}), "vacuous"),
    ]
    for (censored, rotations), want in cases:
        got = _verdict(check_censorship_liveness, port, censored, rotations,
                       k=3)
        assert got == _verdict(ref_invariants.check_censorship_liveness, ref,
                               censored, rotations, k=3)
        assert (got is None) if want is None else (want in got)


def test_flood_bounded_detects_duplicates_and_unbounded_growth():
    assert _on_both("check_flood_bounded", None, flooded=10) is None
    assert "vacuous" in _on_both("check_flood_bounded", None, flooded=0)
    assert "checkpoint truncation" in _on_both(
        "check_flood_bounded", None, flooded=10, wal_bound=0)

    def dup(rec):
        rec.node_states[2].committed_reqs.append(
            rec.node_states[2].committed_reqs[-1])

    assert "exactly-once" in _on_both("check_flood_bounded", dup,
                                      flooded=10)
    assert check_flood_bounded is port_invariants.check_flood_bounded
    assert check_no_fork_under_equivocation is (
        port_invariants.check_no_fork_under_equivocation)


# ---------------------------------------------------------------------------
# The tier-1 smoke subset: one scenario per disruption family
# ---------------------------------------------------------------------------


@pytest.mark.chaos
def test_smoke_partition_heals():
    result = _pair("partition-minority", 0)
    assert result.passed, result.violation
    assert result.counters["partition_drops"] > 0


@pytest.mark.chaos
def test_smoke_crash_restart_durable():
    result = _pair("crash-restart", 1)
    assert result.passed, result.violation
    assert result.counters["crashes"] == 1


@pytest.mark.chaos
def test_smoke_device_plane_failure_does_not_stall():
    """The injected device loss tripped the breaker; where the JAX plane
    falls back to the host oracle (``fallback_digests > 0``), the port
    re-launched the batch on the kernel (``device_retries > 0``, no
    fallback, no host digest), and a probe re-closed the circuit."""
    result = _pair("device-digest-dies", 2)
    assert result.passed, result.violation
    assert result.counters["device_errors"] > 0
    assert result.counters["device_retries"] > 0
    assert result.counters["fallback_digests"] == 0
    assert result.counters["host_digests"] == 0
    assert result.counters["breaker_trips"] >= 1
    assert result.counters["breaker"] == "closed"


@pytest.mark.chaos
def test_smoke_names_cover_three_disruption_families():
    names = set(SMOKE_NAMES)
    assert names == set(ref_scenarios.SMOKE_NAMES)
    assert {s.name for s in smoke_matrix()} == names
    assert any("partition" in n for n in names)
    assert any("crash" in n for n in names)
    assert any("device" in n for n in names)


@pytest.mark.chaos
def test_smoke_campaign_reproducible_from_seed():
    first = run_campaign(smoke_matrix(), seed=42, device="cpu")
    second = run_campaign(smoke_matrix(), seed=42, device="cpu")
    ref = ref_runner.run_campaign(ref_scenarios.smoke_matrix(), seed=42)
    assert first.passed and second.passed
    for a, b, r in zip(first.results, second.results, ref.results):
        assert (a.name, a.events, a.sim_ms, a.commits) == (
            b.name, b.events, b.sim_ms, b.commits)
        _same(r, a)


# ---------------------------------------------------------------------------
# Replay-idempotency regression: the bug the campaign caught
# ---------------------------------------------------------------------------


@pytest.mark.chaos
def test_restart_replay_does_not_reapply_committed_batches():
    """A node that crashes with commits beyond its last stable checkpoint
    while a concurrent partition keeps the network from moving past GC
    must not re-apply batches its durable app already executed."""
    result = _pair("partition-plus-crash", 14)
    assert result.passed, result.violation


# ---------------------------------------------------------------------------
# Epoch-change-targeted and signed-mode scenarios (deterministic engine)
# ---------------------------------------------------------------------------


@pytest.mark.chaos
def test_leader_isolation_forces_epoch_change_exactly_once():
    result = _pair("leader-isolation-epoch-change", 7)
    assert result.passed, result.violation
    assert result.counters["epoch"] >= 1
    assert result.commits > 0


@pytest.mark.chaos
@pytest.mark.slow
def test_signed_mode_verifier_death_walks_breaker_to_recovery():
    """Signed mode: the signature kernels die mid-run; the breaker trips,
    and where the JAX plane verifies the batch on the host oracle
    (``sig_fallbacks >= 1``) the port verifies it again on the Ed25519
    kernels through a probe (``sig_device_retries >= 1``, no fallback),
    which re-closes the circuit, all without stalling commits.  Slow lane
    here: the plain Ed25519 makes it a minute of CPU; ``chip_smoke.py``
    phase 20b runs it on the kernels with the pinned breaker walk."""
    result = _pair("signed-verifier-dies", 3)
    assert result.passed, result.violation
    assert result.counters["sig_device_errors"] >= 1
    assert result.counters["sig_device_retries"] >= 1
    assert result.counters["sig_fallbacks"] == 0
    assert result.counters["sig_breaker"] == "closed"


# ---------------------------------------------------------------------------
# The tier-1 adversary smoke: equivocation + duplication flood
# ---------------------------------------------------------------------------


@pytest.mark.chaos
def test_adversary_smoke_equivocation_forces_suspicion():
    result = _pair("equivocate-majority-suspect", 0, adversary=True)
    assert result.passed, result.violation
    assert result.counters["equivocated"] > 0
    assert result.counters["epoch"] >= 2


@pytest.mark.chaos
def test_adversary_smoke_flood_commits_exactly_once():
    result = _pair("flood-duplicate-proposes", 1, adversary=True)
    assert result.passed, result.violation
    assert result.counters["flooded"] > 0


@pytest.mark.chaos
def test_adversary_smoke_names_cover_two_attack_families():
    assert {s.name for s in adversary_smoke_matrix()} == set(
        ADVERSARY_SMOKE_NAMES)
    assert ADVERSARY_SMOKE_NAMES == ref_scenarios.ADVERSARY_SMOKE_NAMES
    assert len(ADVERSARY_SMOKE_NAMES) == 2


# ---------------------------------------------------------------------------
# Epoch-baseline regression
# ---------------------------------------------------------------------------


@pytest.mark.chaos
def test_expect_epoch_change_rejects_boot_epoch():
    def quiet(scenario):
        return dataclasses.replace(
            scenario, name="quiet-expect-epoch-change", partitions=(),
            expect_epoch_change=True)

    ref = ref_runner.run_scenario(quiet(REF_BY_NAME["partition-minority"]),
                                  seed=0)
    result = run_scenario(quiet(BY_NAME["partition-minority"]), seed=0,
                          device="cpu")
    _same(ref, result)
    assert not result.passed
    assert "boot epoch" in result.violation


# ---------------------------------------------------------------------------
# The pinned reference campaign
# ---------------------------------------------------------------------------


def _smoke_names(which: str) -> set:
    names = SMOKE_NAMES if which == "matrix" else ADVERSARY_SMOKE_NAMES
    return set(names)


@pytest.mark.chaos
@pytest.mark.parametrize("which", ["matrix", "adversary_matrix"])
def test_pinned_smoke_rows_equal_the_jax_campaign(which):
    """The pin's smoke rows (and breaker walk) regenerated from the JAX
    package at their campaign seeds."""
    pin = chaos_reference.MATRIX if which == "matrix" else (
        chaos_reference.ADVERSARY)
    names = _smoke_names(which)
    rows, walks = chaos_pin.reference_rows(which, names)
    assert rows == {name: pin[name] for name in names}
    assert walks == {name: chaos_reference.BREAKER[name]
                     for name in walks}


@pytest.mark.chaos
@pytest.mark.parametrize("which", ["matrix", "adversary_matrix"])
def test_port_smoke_rows_equal_the_pin(which):
    """The port's smoke scenarios at their campaign seeds give the pinned
    rows, and each device scenario the pinned breaker walk."""
    scenarios = matrix() if which == "matrix" else adversary_matrix()
    pin = chaos_reference.MATRIX if which == "matrix" else (
        chaos_reference.ADVERSARY)
    names = _smoke_names(which)
    results = [run_scenario(s, seed=index, device="cpu")
               for index, s in enumerate(scenarios) if s.name in names]
    rows, walks = chaos_pin.port_rows(results)
    assert rows == {name: chaos_reference.LATE_DIGEST.get(name, pin[name])
                    for name in names}
    assert walks == {name: chaos_reference.BREAKER[name] for name in walks}
    assert all(r.counters["host_digests"] == 0 for r in results)


@pytest.mark.chaos
def test_persistent_device_fault_raises():
    """A device that stays dead past the run: the breaker re-opens on
    every probe, the launch runs out of attempts, and the run raises
    ``DevicePlaneError`` instead of computing a digest anywhere else."""
    dead = dataclasses.replace(
        BY_NAME["device-digest-dies"], name="device-digest-dead",
        hash_plane=_flaky_plane("die", fail_from=1, fail_until=10 ** 9))
    with pytest.raises(DevicePlaneError, match="attempts failed"):
        run_scenario(dead, seed=2, device="cpu")


@pytest.mark.chaos
def test_cli_smoke_exits_as_the_jax_cli():
    """``python -m mirbft_tpu_torch.chaos --smoke --device cpu`` and the
    JAX CLI's ``--smoke`` exit alike (0: every smoke scenario passed) and
    print the same scenario lines, apart from the port's own counters."""
    def run(argv):
        return subprocess.run(
            [sys.executable, "-m", *argv], cwd=ROOT, capture_output=True,
            text=True, timeout=600)

    ref = run(["mirbft_tpu.chaos", "--smoke", "--json"])
    port = run(["mirbft_tpu_torch.chaos", "--smoke", "--device", "cpu",
                "--json"])
    assert port.returncode == ref.returncode == 0, port.stderr[-2000:]
    ref_doc, port_doc = json.loads(ref.stdout), json.loads(port.stdout)
    assert port_doc["passed"] == ref_doc["passed"]
    assert [chaos_pin.first_words(s["violation"]) + s["name"]
            for s in port_doc["scenarios"]] == [
        chaos_pin.first_words(s["violation"]) + s["name"]
        for s in ref_doc["scenarios"]]
    for r, p in zip(ref_doc["scenarios"], port_doc["scenarios"]):
        assert (p["events"], p["sim_ms"], p["commits"]) == (
            r["events"], r["sim_ms"], r["commits"])


@pytest.mark.chaos
@pytest.mark.parametrize("name,want", [
    ("ack-loss-70pct", "recovery took 156870ms of simulated time"),
    ("crash-staggered-pair", "no commits at all after the"),
])
def test_reference_failures_of_the_full_matrix_on_both_packages(name, want):
    """The JAX campaign's own two failures at seed 0 (ROADMAP queue 3):
    the deterministic engine gives both packages the same events and the
    same violation, so the failure is the reference's."""
    index = [s.name for s in matrix()].index(name)
    ref = ref_runner.run_scenario(REF_BY_NAME[name], seed=index)
    port = run_scenario(BY_NAME[name], seed=index, device="cpu")
    _same(ref, port)
    assert not port.passed and chaos_pin.first_words(port.violation) == want
    assert chaos_pin.row(port) == chaos_reference.MATRIX[name]


# ---------------------------------------------------------------------------
# The full matrices (slow lane; also: python -m mirbft_tpu_torch.chaos)
# ---------------------------------------------------------------------------


def _campaign_against_pin(scenarios, pin):
    campaign = run_campaign(scenarios, seed=0, device="cpu")
    rows, walks = chaos_pin.port_rows(campaign.results)
    assert rows == {name: chaos_reference.LATE_DIGEST.get(name, value)
                    for name, value in pin.items()}
    assert walks == {name: chaos_reference.BREAKER[name] for name in walks}
    for result in campaign.results:
        for key in FALLBACKS:
            assert result.counters.get(key, 0) == 0
        assert result.counters["host_digests"] == 0
    return campaign


@pytest.mark.chaos
@pytest.mark.slow
def test_full_campaign_equals_the_reference():
    """The whole matrix gives the JAX campaign's rows, its two reference
    failures included (the original asserts every scenario passes; the
    JAX package fails the same two on this tree)."""
    campaign = _campaign_against_pin(matrix(), chaos_reference.MATRIX)
    assert len(campaign.results) >= 12
    failed = {r.name for r in campaign.results if not r.passed}
    assert failed == {"ack-loss-70pct", "crash-staggered-pair"}


@pytest.mark.chaos
@pytest.mark.slow
def test_full_adversary_campaign_passes_all_invariants():
    campaign = _campaign_against_pin(adversary_matrix(),
                                     chaos_reference.ADVERSARY)
    assert len(campaign.results) >= 10
    assert campaign.passed, campaign.report()


@pytest.mark.chaos
@pytest.mark.slow
@pytest.mark.parametrize("which", ["matrix", "adversary_matrix"])
def test_pinned_rows_equal_the_jax_campaign(which):
    pin = chaos_reference.MATRIX if which == "matrix" else (
        chaos_reference.ADVERSARY)
    rows, walks = chaos_pin.reference_rows(which)
    assert rows == pin
    assert walks == {name: chaos_reference.BREAKER[name] for name in walks}
    late, _ = chaos_pin.reference_rows(which, late_digest=True)
    assert {name: value for name, value in late.items()
            if value != pin[name]} == {
        name: value for name, value in chaos_reference.LATE_DIGEST.items()
        if name in pin}
