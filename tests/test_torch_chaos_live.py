"""The port's live chaos driver (``mirbft_tpu_torch/chaos/live.py``) held
against the JAX package's on real loopback TCP clusters.

Mirrors ``tests/test_chaos_live.py``.  Every replica builds the port's
``cuda`` processor on ``device="cpu"`` (the SHA-256 kernel's plain
version) under the original's wall-clock budgets.  A live run is not
deterministic, so the tolerance is the verdict class: the port's run and
the JAX run of the same scenario and seed both pass (or both fail with the
same reference violation), and a passing run has no fork and no request
committed twice (``check_no_fork`` over every node's durable commit log,
inside the driver).

Tier-1 runs one smoke scenario a package (``partition-minority``), the
leak checks and the flood A/B at a tiny size; every other live case runs
in the slow lane, since live clusters of both packages load the host that
the rest of the suite shares, and a loaded host misses the live tier's
wall-clock bounds.

Two cases run only on the card (``tests/test_torch_chip.py``):
``:177`` (the signed verifier's death) and ``:196`` (corrupted signed
proposals).  Their signature plane runs on the Ed25519 kernels, whose
plain version takes ~0.5 s a verification call on this CPU: the live
driver verifies each proposal before delivering it, so deliveries fall
seconds apart while the replicas suspect a silent leader after 4 ticks
of 40 ms, and the cluster churns through epochs without converging.  The
slow campaigns here run every unsigned scenario of each matrix; the card
runs both matrices whole (``chip_smoke.py`` phase 20).

On top, the live reference failures (ROADMAP queue 3), each shown on
both packages: ``crash-restart``'s crash before a slow node has persisted
anything, the empty window's bucket backlog, the forged-request probe
racing convergence, a censored commit's rotations read at a late poll,
and ``transfer-corrupt-stream``, vacuous in a share of runs.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import pytest

from mirbft_tpu.chaos import live_adversary_matrix as ref_live_adversary
from mirbft_tpu.chaos import live_matrix as ref_live_matrix
from mirbft_tpu.chaos import run_live_scenario as ref_run_live
from mirbft_tpu.chaos.scenarios import (
    transfer_corrupt_scenario as ref_transfer_corrupt,
)
from mirbft_tpu_torch import pb
from mirbft_tpu_torch.chaos import (
    LIVE_SMOKE_NAMES,
    live_adversary_matrix,
    live_matrix,
    run_live_scenario,
)
from mirbft_tpu_torch.chaos.live import LiveCluster
from mirbft_tpu_torch.chaos.scenarios import transfer_corrupt_scenario
from mirbft_tpu_torch.runtime import Config, Node, TcpTransport
from mirbft_tpu_torch.runtime.node import standard_initial_network_state


ROOT = Path(__file__).resolve().parent.parent

BY_NAME = {s.name: s for s in live_matrix()}
ADV_BY_NAME = {s.name: s for s in live_adversary_matrix()}
REF_BY_NAME = {s.name: s for s in ref_live_matrix()}
REF_ADV_BY_NAME = {s.name: s for s in ref_live_adversary()}

RUNTIME_THREAD_PREFIXES = (
    "mirbft-serializer-",
    "tcp-",
    "live-consumer-",
    "proc-pipe-",
    "storage-sync-",
)


def _runtime_threads() -> list:
    return [
        t
        for t in threading.enumerate()
        if t.name.startswith(RUNTIME_THREAD_PREFIXES)
    ]


def _port(scenario, seed, **kwargs):
    return run_live_scenario(scenario, seed=seed, budget_s=60.0,
                             processor="cuda", device="cpu", **kwargs)


def _pair(name: str, seed: int, adversary=False):
    """The JAX run and the port's run of one scenario and seed; the
    verdict class must agree."""
    ref = ref_run_live((REF_ADV_BY_NAME if adversary else REF_BY_NAME)[name],
                       seed=seed, budget_s=60.0)
    port = _port((ADV_BY_NAME if adversary else BY_NAME)[name], seed)
    assert port.passed == ref.passed, (port.violation, ref.violation)
    assert port.counters["digest_launches"] and all(
        port.counters["digest_launches"])
    return ref, port


def _bind_retrying(node_id: int, port: int) -> TcpTransport:
    deadline = time.monotonic() + 10
    while True:
        try:
            return TcpTransport(node_id, port=port, dial_timeout=1.0)
        except OSError:
            if port == 0 or time.monotonic() >= deadline:
                raise
            time.sleep(0.02)


# ---------------------------------------------------------------------------
# Tier-1: live smoke under a wall-clock budget
# ---------------------------------------------------------------------------


@pytest.mark.chaos
@pytest.mark.parametrize("name", [
    # One scenario a package in tier-1; the other runs in the slow lane.
    name if name == "partition-minority"
    else pytest.param(name, marks=pytest.mark.slow)
    for name in LIVE_SMOKE_NAMES
])
def test_live_smoke_scenario_survives_real_fault(name):
    start = time.monotonic()
    _ref, result = _pair(name, 0)
    elapsed = time.monotonic() - start
    assert result.passed, f"{name}: {result.violation}"
    assert result.commits > 0
    assert result.counters["tcp_connects"] > 0
    assert elapsed < 2 * 75.0, f"{name}: {elapsed:.1f}s for both packages"


@pytest.mark.chaos
def test_live_smoke_leaves_no_runtime_threads():
    result = _port(BY_NAME["partition-minority"], 1)
    assert result.passed, result.violation
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and _runtime_threads():
        time.sleep(0.05)
    leaked = _runtime_threads()
    assert not leaked, f"leaked threads: {[t.name for t in leaked]}"


# ---------------------------------------------------------------------------
# Tier-1: 100 start/stop cycles leak nothing and rebind their ports
# ---------------------------------------------------------------------------


def test_hundred_node_transport_cycles_leak_free():
    baseline = len(_runtime_threads())
    state = standard_initial_network_state(2, [1])
    port_a = port_b = 0
    for _cycle in range(100):
        ta = _bind_retrying(0, port_a)
        tb = _bind_retrying(1, port_b)
        port_a, port_b = ta.address[1], tb.address[1]
        node_a = Node.start_new(Config(id=0), state)
        node_b = Node.start_new(Config(id=1), state)
        ta.serve(node_a)
        tb.serve(node_b)
        ta.connect(1, tb.address)
        tb.connect(0, ta.address)
        ta.link().send(1, pb.Msg(type=pb.Suspect(epoch=0)))
        tb.link().send(0, pb.Msg(type=pb.Suspect(epoch=0)))
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            sent_a = ta.counters()["peers"].get(1, {}).get("sent", 0)
            sent_b = tb.counters()["peers"].get(0, {}).get("sent", 0)
            if sent_a >= 1 and sent_b >= 1:
                break
            time.sleep(0.005)
        node_a.stop()
        node_b.stop()
        ta.close()
        tb.close()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and len(_runtime_threads()) > baseline:
        time.sleep(0.05)
    residue = _runtime_threads()
    assert len(residue) <= baseline, (
        f"thread leak after 100 cycles: {[t.name for t in residue]}"
    )


# ---------------------------------------------------------------------------
# Epoch-change-targeted scenarios; the flood over real sockets
# ---------------------------------------------------------------------------


@pytest.mark.chaos
@pytest.mark.slow
def test_live_leader_isolation_forces_real_epoch_change():
    _ref, result = _pair("leader-isolation-epoch-change", 1)
    assert result.passed, result.violation
    assert result.counters["epoch"] >= 1
    assert result.counters["epoch_active_events"] >= 1
    assert result.commits > 0


@pytest.mark.chaos
@pytest.mark.slow
def test_live_adversary_flood_absorbed_on_real_sockets():
    _ref, result = _pair("flood-duplicate-proposes", 0, adversary=True)
    assert result.passed, result.violation
    assert result.counters["flooded"] > 0
    assert result.commits > 0


_QUIET_RUN = """
import dataclasses
from {pkg}.chaos import live_matrix, run_live_scenario
scenario = {{s.name: s for s in live_matrix()}}["partition-minority"]
quiet = dataclasses.replace(scenario, name="quiet-expect-epoch-change",
                            partitions=(), expect_epoch_change=True)
result = run_live_scenario(quiet, seed=0, budget_s=60.0{extra})
print("RESULT", result.passed, result.violation)
"""


def _fresh(script: str, pkg: str, extra: str = "") -> str:
    """A live run in an interpreter of its own, its ``RESULT`` line.  In
    a process that has already run several live clusters, a quiet 4-node
    run sometimes changes epoch for real (the JAX case is unsteady so,
    ROADMAP queue 3, item 1), and then ``expect_epoch_change`` is rightly
    met; a cold process is also what the crash-restart race needs."""
    done = subprocess.run(
        [sys.executable, "-c", script.format(pkg=pkg, extra=extra)],
        cwd=ROOT, capture_output=True, text=True, timeout=180,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    lines = [line for line in done.stdout.splitlines()
             if line.startswith("RESULT")]
    assert lines, done.stderr[-2000:]
    return lines[-1]


def test_live_attack_run_holds_the_rungs_gates_under_the_flood():
    """The flood A/B (``bench.live_attack_run``) at a tiny size on the
    plain version: both halves reach the target with no request committed
    twice and one chain prefix (``live_cluster_rate`` raises otherwise),
    every hash request launched and none on the host; only the flooded
    half proposes copies, 3 past each proposal on every node."""
    from mirbft_tpu_torch import bench

    settings = dataclasses.replace(
        bench.LIVE, clients=2, reqs_per_client=10, target_commits=20,
        batch_size=1, tick_s=0.05, fsync_floor_s=0.0, deadline_s=60.0,
        checkpoint_interval=20, suspect_ticks=100,
    )
    attack = bench.live_attack_run("cuda", device="cpu", settings=settings)
    assert attack["copies"] == bench.LIVE_ATTACK_COPIES == 3
    assert attack["clean_flooded"] == 0
    first_pass = settings.nodes * settings.clients * settings.reqs_per_client
    assert attack["flooded"] >= 3 * first_pass
    for half in ("clean", "flood"):
        run = attack[half]
        assert run["host_digests"] == 0
        assert run["device_digests"] == run["hash_requests"] > 0
        assert max(run["commits"]) >= settings.target_commits
    assert attack["clean_rate"] > 0 and attack["flood_rate"] > 0


@pytest.mark.chaos
@pytest.mark.slow
def test_live_expect_epoch_change_rejects_boot_epoch():
    for got in (_fresh(_QUIET_RUN, "mirbft_tpu"),
                _fresh(_QUIET_RUN, "mirbft_tpu_torch", ', device="cpu"')):
        assert got.startswith("RESULT False") and "boot epoch" in got, got


# ---------------------------------------------------------------------------
# The live reference failures, on both packages
# ---------------------------------------------------------------------------


_CRASH_RESTART_RUN = """
import time
from {pkg}.chaos import live_matrix, run_live_scenario
from {pkg}.runtime.node import Node

# Every node hands out no Actions for its first 0.5 s, as a JAX node in a
# cold process does while its first step imports numpy
# (core/device_tracker.py).
born = {{}}
ready = Node.ready

def slow_ready(self, timeout=None):
    first = born.setdefault(id(self), time.monotonic())
    if time.monotonic() - first < 0.5:
        time.sleep(timeout or 0.01)
        return None
    return ready(self, timeout)

Node.ready = slow_ready
scenario = {{s.name: s for s in live_matrix()}}["crash-restart"]
result = run_live_scenario(scenario, seed=0, budget_s=60.0{extra})
print("RESULT", result.passed, result.counters.get("crashes"),
      all(result.counters.get("digest_launches", [0])), result.violation)
"""


@pytest.mark.chaos
@pytest.mark.slow
def test_live_crash_restart_with_a_slow_first_step():
    """The JAX driver starts its fault clock before boot.  In a cold
    process a JAX node's first step imports numpy, so node 1 has persisted
    nothing when ``crash-restart``'s crash lands 0.24 s in, and its restart
    refuses the empty WAL (the JAX CLI's ``--live --smoke`` fails so at
    seed 0).  The port's driver starts the clock once every bootstrap log
    is fsynced (``LiveCluster._await_persisted_boot``), the fault instants
    as authored, and passes.  Both packages' nodes get the same slow first
    step, each package in an interpreter of its own."""
    ref = _fresh(_CRASH_RESTART_RUN, "mirbft_tpu")
    assert ref.startswith("RESULT False") and "restart with empty WAL" in ref
    port = _fresh(_CRASH_RESTART_RUN, "mirbft_tpu_torch",
                  ', processor="cuda", device="cpu"')
    # Passed, one crash, every node (node 1 rejoined) launched digests.
    assert port.startswith("RESULT True 1 True"), port


@pytest.mark.chaos
@pytest.mark.slow
def test_cli_live_smoke_on_the_plain_versions():
    """``python -m mirbft_tpu_torch.chaos --live --smoke --device cpu``
    exits 0 with both smoke scenarios passed.  The JAX CLI's ``--live
    --smoke`` exits 0 too, except when its ``crash-restart`` loses the
    race above (ROADMAP queue 3)."""
    done = subprocess.run(
        [sys.executable, "-m", "mirbft_tpu_torch.chaos", "--live", "--smoke",
         "--device", "cpu", "--json"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    doc = json.loads(done.stdout)
    assert doc["passed"]
    assert [s["name"] for s in doc["scenarios"]] == list(LIVE_SMOKE_NAMES)


def test_bucket_backlog_of_an_empty_window():
    """An active epoch whose window is empty (its last rows garbage-
    collected at the epoch's end) has no backlog.  The JAX package reads
    its low watermark regardless and raises IndexError, which kills the
    serializer on the next tick when metrics are on (seen in the live
    ``censor-client-rotation``, both packages); the port returns zeros."""
    from mirbft_tpu.core.active_epoch import ActiveEpoch as RefActiveEpoch
    from mirbft_tpu_torch.core.active_epoch import ActiveEpoch

    def empty(cls):
        epoch = cls.__new__(cls)
        epoch.sequences = []
        epoch.buckets = [object()] * 4
        epoch.commit_state = types.SimpleNamespace(low_watermark=40)
        return epoch

    with pytest.raises(IndexError):
        empty(RefActiveEpoch).bucket_backlog()
    assert empty(ActiveEpoch).bucket_backlog() == [0, 0, 0, 0]


def test_censored_commit_counts_the_rotations_at_its_first_apply():
    """A censored request's rotation count is the one read when it first
    commits.  The JAX driver reads it when its next 0.2 s poll sees the
    commit, and epochs of 40 sequences at a 40 ms tick can rotate in
    between (the live ``censor-client-rotation`` read up to two rotations
    late, and failed its bound of 3 at a count of 4 on the card).  Here
    the cluster moves two rotations between the apply and the poll: the
    JAX driver counts 3, the port 1."""
    import functools

    from mirbft_tpu import pb as ref_pb
    from mirbft_tpu.app.journal import DurableChainLog as RefChainLog
    from mirbft_tpu.chaos.live import LiveCluster as RefLiveCluster
    from mirbft_tpu.obsv import hooks as ref_hooks
    from mirbft_tpu.obsv.metrics import Registry as RefRegistry
    from mirbft_tpu_torch.app.journal import DurableChainLog
    from mirbft_tpu_torch.chaos.live import LiveReplica
    from mirbft_tpu_torch.chaos.runner import FIRST_WORKING_EPOCH
    from mirbft_tpu_torch.obsv import hooks
    from mirbft_tpu_torch.obsv.metrics import Registry

    name = "censor-client-rotation"
    pair = (4, 3)

    def rotations(pkg_hooks, registry, cluster, apply):
        cluster._start = time.monotonic()
        pkg_hooks.enable(registry=registry, trace=False)
        try:
            def rotate_to(rotation):
                pkg_hooks.metrics.counter(
                    "mirbft_epoch_events_total", event="active",
                    epoch=str(FIRST_WORKING_EPOCH + rotation)).inc()

            rotate_to(1)
            cluster._censors[0].censored_pairs.add(pair)
            apply()
            rotate_to(3)
            cluster._track_censored_commits()
            return cluster.commit_rotations[pair]
        finally:
            pkg_hooks.disable()
            cluster.replicas = [None]
            cluster.teardown()

    ref = RefLiveCluster(REF_ADV_BY_NAME[name], 0, 0.04, 60.0, 40)
    ref_log = RefChainLog(os.path.join(ref.root, "app.log"), 0,
                          on_commit=ref._on_commit)
    ref.replicas = [types.SimpleNamespace(app_log=ref_log)]

    def ref_apply():
        ref_log.apply(ref_pb.QEntry(seq_no=1, requests=[
            ref_pb.RequestAck(client_id=pair[0], req_no=pair[1],
                              digest=bytes(32))]))
        ref_log.close()

    assert rotations(ref_hooks, RefRegistry(), ref, ref_apply) == 3

    port = LiveCluster(ADV_BY_NAME[name], 0, 0.04, 60.0, 40, device="cpu")
    replica = types.SimpleNamespace(cluster=port)
    replica.app_log = DurableChainLog(
        os.path.join(port.root, "app.log"), 0,
        on_commit=functools.partial(LiveReplica._on_commit, replica))

    def port_apply():
        replica.app_log.apply(pb.QEntry(seq_no=1, requests=[
            pb.RequestAck(client_id=pair[0], req_no=pair[1],
                          digest=bytes(32))]))
        replica.app_log.close()

    assert rotations(hooks, Registry(), port, port_apply) == 1


def test_a_suspicion_before_the_first_commit_is_on_record():
    """The live ``censor-client-rotation`` passes ``censor_k`` rotations
    when a node suspects the first working epoch before its first commit
    (ROADMAP queue 3).  The port's driver notes such a node from its
    outgoing link; a later suspicion, another epoch's or another message
    is not noted, and every message still goes out.  ``chip_smoke.py``
    accepts the scenario's late-rotation failure only with that cause on
    record."""
    import chip_smoke
    from mirbft_tpu_torch.chaos.live import _SuspectWatch
    from mirbft_tpu_torch.chaos.runner import FIRST_WORKING_EPOCH

    cluster = LiveCluster(ADV_BY_NAME["censor-client-rotation"], 0, 0.04,
                          60.0, 40, device="cpu")
    sent = []
    link = types.SimpleNamespace(send=lambda dest, msg: sent.append(dest))
    log = types.SimpleNamespace(last_seq=0)
    replica = types.SimpleNamespace(cluster=cluster, node_id=2, app_log=log)
    watch = _SuspectWatch(link, replica)
    try:
        watch.send(1, pb.Msg(type=pb.Suspect(epoch=FIRST_WORKING_EPOCH + 1)))
        watch.send(1, pb.Msg(type=pb.Preprepare(seq_no=1, epoch=1)))
        log.last_seq = 3
        watch.send(1, pb.Msg(type=pb.Suspect(epoch=FIRST_WORKING_EPOCH)))
        assert cluster.suspected_before_commit == set()
        log.last_seq = 0
        watch.send(3, pb.Msg(type=pb.Suspect(epoch=FIRST_WORKING_EPOCH)))
        assert cluster.suspected_before_commit == {2}
        assert sent == [1, 1, 1, 3]
    finally:
        cluster.teardown()

    late = types.SimpleNamespace(
        name="censor-client-rotation", passed=False,
        violation="censored requests took more than 3 epoch rotations to "
        "commit: [((4, 9), 4)]", counters={"suspected_before_commit": [2]})
    assert chip_smoke.live_classified(late)
    assert chip_smoke.classified_note(late).endswith(
        "suspected_before_commit [2]")
    vacuous = types.SimpleNamespace(
        name="transfer-corrupt-stream", passed=False, counters={},
        violation="transfer attack touched no frames (vacuous)")
    assert chip_smoke.live_classified(vacuous)
    assert chip_smoke.classified_note(vacuous) == (
        "transfer-corrupt-stream: the classified failure (ROADMAP queue 3)")
    late.counters["suspected_before_commit"] = []
    assert not chip_smoke.live_classified(late)
    late.violation = "censored requests never committed: [(4, 9)]"
    late.counters["suspected_before_commit"] = [2]
    assert not chip_smoke.live_classified(late)


def test_convergence_waits_for_the_forged_request_probe():
    """A signed run converges only once the proposer's first pass, its
    forged-request probe included, is over: a probe still verifying when
    the last request commits would otherwise read as a forged request let
    through (the JAX driver's ``forged_rejected is not True``)."""
    cluster = LiveCluster(BY_NAME["partition-minority"], 0, 0.04, 60.0, 40,
                          device="cpu")
    log = types.SimpleNamespace(commits=[(1, 0, 1)], chain=b"c")
    cluster.replicas = [types.SimpleNamespace(app_log=log)] * 4
    expected = {(1, 0)}
    assert not cluster._converged(expected)
    cluster._first_pass.set()
    assert cluster._converged(expected)
    cluster.replicas = [None] * 4
    cluster.teardown()


VACUOUS_TRANSFER = "transfer attack touched no frames (vacuous)"


def transfer_verdict(result) -> str:
    """``transfer-corrupt-stream``'s verdict class: ``rejected`` (every
    corrupted chunk refused, the fetch completed through an honest
    donor) or ``vacuous`` (node 2 caught up without fetching a chunk from
    its corrupting donor, so the attack touched nothing)."""
    if result.passed:
        assert result.counters["transfer_corrupted"] > 0
        assert result.counters["transfer_rejected"] >= 1
        return "rejected"
    assert VACUOUS_TRANSFER in result.violation, result.violation
    return "vacuous"


@pytest.mark.chaos
@pytest.mark.slow
def test_live_transfer_corrupt_stream_on_both_packages():
    """``transfer-corrupt-stream`` at the seed the live adversary campaign
    gives it (6).  Whether rebooted node 2 fetches a chunk from node 0,
    its corrupting donor, depends on timing: in some runs it catches up
    without, the attack touches no frame and the run fails as vacuous.
    Both packages do this (ROADMAP queue 3): six runs a package at seed 6
    were all vacuous here, and the JAX package's own seed-0 case
    (``tests/test_transfer_engine.py:646``) was vacuous in one run of two.
    Each package's run must end in one of the two classes, never in a
    fork, a stall or any other failure."""
    ref = ref_run_live(ref_transfer_corrupt(), seed=6, budget_s=60.0)
    port = _port(transfer_corrupt_scenario(), 6)
    assert transfer_verdict(ref) in ("rejected", "vacuous")
    assert transfer_verdict(port) in ("rejected", "vacuous")
    assert port.counters["divergences"] == 0


# ---------------------------------------------------------------------------
# The campaigns (slow lane): every unsigned scenario on the CPU
# ---------------------------------------------------------------------------


#: The live campaigns' reference failure at seed 0 (ROADMAP queue 3).
LIVE_REFERENCE_FAILURES = {"transfer-corrupt-stream": VACUOUS_TRANSFER}


def _unsigned_campaign(scenarios):
    """Every unsigned scenario at the seed ``run_live_campaign(seed=0)``
    gives it (its index in the matrix); returns the failures."""
    failures = {}
    for index, scenario in enumerate(scenarios):
        if scenario.signed:
            continue
        result = _port(scenario, index)
        assert result.counters["digest_launches"] and all(
            result.counters["digest_launches"]), scenario.name
        if not result.passed:
            failures[scenario.name] = result.violation
    return failures


@pytest.mark.chaos
@pytest.mark.slow
def test_live_full_campaign():
    """The live matrix's unsigned scenarios against real clusters: crash,
    partition, loss, leader isolation, failing fsyncs."""
    assert _unsigned_campaign(live_matrix()) == {}


@pytest.mark.chaos
@pytest.mark.slow
def test_live_adversary_campaign():
    """The live adversary matrix's unsigned scenarios: equivocating,
    censoring and flooding leaders, forged MACs and aggregate
    certificates, and the corrupted snapshot stream, behind
    frame-rewriting socket proxies; the one failure is the reference's."""
    failures = _unsigned_campaign(live_adversary_matrix())
    assert set(failures) <= set(LIVE_REFERENCE_FAILURES), failures
    for name, violation in failures.items():
        assert LIVE_REFERENCE_FAILURES[name] in violation
