"""The port's multi-process cluster (``mirbft_tpu_torch/cluster/``) held
against the JAX package's (``mirbft_tpu/cluster/``).

Mirrors ``tests/test_cluster.py``: the WAN profile maps, the handshake
files, the mp matrix's shape and rejections (same names, same scenario
fields, same ``ValueError`` text), the submit/teardown race and the lock
graph of the supervisor and its client transport.  Beside them: the
``kv_mp_matrix`` derivation (``tests/test_app.py:751``), the worker spec
of both supervisors for the same arguments (equal key for key but the
port's ``device`` and the processor kind), a default supervisor on a
machine without a card (``WorkerDied`` naming the missing card), and one
real worker process on ``device="cpu"`` through boot, commits, SIGKILL,
restart from disk and a graceful stop.

The slow lane runs real clusters of worker processes: the 4-node
lifecycle and mp crash-restart on both packages, the KV mp scenarios
(``tests/test_app.py:768``), join and removal under a partition
(``tests/test_transfer_engine.py:609, :629``), and the bench's
multi-process, reconfiguration and knee rungs at a small size.  Every
port worker runs the ``cuda*`` processors on ``device="cpu"`` (the
SHA-256 kernel's plain version); the JAX workers run their own default.
A live run is not deterministic, so the tolerance is the verdict: both
packages' runs pass, with one chain and every request committed once.
"""

import dataclasses
import json
import os
import socket
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from mirbft_tpu import pb as ref_pb
from mirbft_tpu.chaos.scenarios import Adversary as RefAdversary
from mirbft_tpu.chaos.scenarios import Scenario as RefScenario
from mirbft_tpu.chaos.scenarios import StorageFault as RefStorageFault
from mirbft_tpu.cluster import ClusterSupervisor as RefSupervisor
from mirbft_tpu.cluster import WAN_PROFILES as REF_WAN_PROFILES
from mirbft_tpu.cluster import mp_matrix as ref_mp_matrix
from mirbft_tpu.cluster import profile_latency as ref_profile_latency
from mirbft_tpu.cluster.chaos_mp import (
    _reject_unsupported as ref_reject_unsupported,
)
from mirbft_tpu.cluster.chaos_mp import kv_mp_matrix as ref_kv_mp_matrix
from mirbft_tpu.cluster.chaos_mp import (
    mp_adversary_matrix as ref_mp_adversary_matrix,
)
from mirbft_tpu.cluster.chaos_mp import run_mp_scenario as ref_run_mp_scenario
from mirbft_tpu.cluster.worker import read_json as ref_read_json
from mirbft_tpu.cluster.worker import write_json_atomic as ref_write_json
from mirbft_tpu_torch import pb
from mirbft_tpu_torch.chaos.scenarios import Adversary, Scenario, StorageFault
from mirbft_tpu_torch.cluster import (
    MP_SMOKE_NAMES,
    WAN_PROFILES,
    ClusterSupervisor,
    WorkerDied,
    mp_matrix,
    profile_latency,
    retry_storm_scenario,
)
from mirbft_tpu_torch.cluster.chaos_mp import (
    KV_MP_SMOKE_NAMES,
    _reject_unsupported,
    kv_mp_matrix,
    mp_adversary_matrix,
    run_mp_scenario,
)
from mirbft_tpu_torch.cluster.worker import read_json, write_json_atomic

ROOT = Path(__file__).resolve().parent.parent


def _scenario_fields(scenario) -> dict:
    """A scenario's fields as plain data, comparable across packages."""
    return json.loads(json.dumps(dataclasses.asdict(scenario), default=repr))


# -- tier-1: profiles, handshake files, matrix shape -------------------------


def test_wan_profiles_lower_to_per_link_latency_maps():
    assert set(WAN_PROFILES) == {"lan", "wan", "geo"}
    assert profile_latency("lan", 4) == {}  # loopback baseline: no emulation
    wan = profile_latency("wan", 4)
    assert set(wan) == {0, 1, 2, 3}
    assert wan[2] == {"delay_ms": 30.0, "jitter_ms": 5.0}
    geo = profile_latency("geo", 3)
    assert geo[0]["delay_ms"] > wan[0]["delay_ms"]
    with pytest.raises(ValueError):
        profile_latency("lunar", 4)


@pytest.mark.parametrize("nodes", [1, 4, 8])
@pytest.mark.parametrize("profile", ["lan", "wan", "geo"])
def test_profiles_are_the_jax_packages(profile, nodes):
    assert WAN_PROFILES == REF_WAN_PROFILES
    assert profile_latency(profile, nodes) == ref_profile_latency(
        profile, nodes
    )


def test_unknown_profile_raises_the_jax_packages_text():
    with pytest.raises(ValueError) as port:
        profile_latency("lunar", 4)
    with pytest.raises(ValueError) as ref:
        ref_profile_latency("lunar", 4)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize(
    "write, read",
    [(write_json_atomic, read_json), (ref_write_json, ref_read_json)],
    ids=["port", "jax"],
)
def test_handshake_files_are_atomic_and_torn_reads_are_none(
    tmp_path, write, read
):
    path = str(tmp_path / "address.json")
    assert read(path) is None  # absent
    write(path, {"pid": 42, "transport_port": 9})
    assert read(path) == {"pid": 42, "transport_port": 9}
    assert not os.path.exists(path + ".tmp")  # no droppings
    # A torn/partial file (a non-atomic writer mid-flight) reads as None
    # rather than raising into the poll loop.
    with open(path, "w", encoding="utf-8") as fh:
        fh.write('{"pid": 4')
    assert read(path) is None


def test_handshake_files_cross_packages(tmp_path):
    path = str(tmp_path / "peers.json")
    write_json_atomic(path, {"peers": {"1": ["127.0.0.1", 7]}})
    assert ref_read_json(path) == read_json(path)
    with open(path, "rb") as fh:
        port_bytes = fh.read()
    ref_write_json(path, {"peers": {"1": ["127.0.0.1", 7]}})
    with open(path, "rb") as fh:
        assert fh.read() == port_bytes


def test_mp_matrix_is_the_smoke_pair_plus_the_dedup_storm():
    names = [scenario.name for scenario in mp_matrix()]
    assert names[: len(MP_SMOKE_NAMES)] == list(MP_SMOKE_NAMES)
    assert "retry-storm-dedup" in names
    storm = retry_storm_scenario()
    assert storm.node_count == 4
    assert not storm.crashes and not storm.partitions


@pytest.mark.parametrize(
    "port_matrix, ref_matrix",
    [
        (mp_matrix, ref_mp_matrix),
        (mp_adversary_matrix, ref_mp_adversary_matrix),
        (kv_mp_matrix, ref_kv_mp_matrix),
    ],
    ids=["mp_matrix", "mp_adversary_matrix", "kv_mp_matrix"],
)
def test_mp_matrices_are_the_jax_packages(port_matrix, ref_matrix):
    port, ref = port_matrix(), ref_matrix()
    assert [s.name for s in port] == [s.name for s in ref]
    for mine, theirs in zip(port, ref):
        assert _scenario_fields(mine) == _scenario_fields(theirs), mine.name


def _unsupported(scenario_cls, storage_cls, adversary_cls, name):
    if name == "storage":
        return scenario_cls(
            name="storage", description="",
            storage_faults=(
                storage_cls(at_ms=0, node=0, restart_delay_ms=1000),
            ),
        )
    if name == "signed":
        return scenario_cls(name="signed", description="", signed=True)
    if name == "lossy":
        return scenario_cls(name="lossy", description="", drop_pct=10)
    if name == "equivocate":
        return scenario_cls(
            name="equivocate", description="",
            adversaries=(adversary_cls(kind="equivocate", node=0),),
        )
    return scenario_cls(
        name="everything", description="", signed=True, drop_pct=5,
        storage_faults=(storage_cls(at_ms=0, node=0, restart_delay_ms=1),),
    )


@pytest.mark.parametrize(
    "name", ["storage", "signed", "lossy", "equivocate", "everything"]
)
def test_mp_driver_rejects_faults_it_cannot_lower(name):
    with pytest.raises(ValueError) as port:
        _reject_unsupported(
            _unsupported(Scenario, StorageFault, Adversary, name)
        )
    with pytest.raises(ValueError) as ref:
        ref_reject_unsupported(
            _unsupported(RefScenario, RefStorageFault, RefAdversary, name)
        )
    assert str(port.value) == str(ref.value)


def test_the_shipped_mp_matrices_lower():
    for scenario in mp_matrix() + mp_adversary_matrix() + kv_mp_matrix():
        _reject_unsupported(scenario)  # the shipped matrices must be clean


def test_kv_mp_matrix_derives_from_the_smoke_pair():
    scenarios = {s.name: s for s in kv_mp_matrix()}
    assert sorted(scenarios) == sorted(KV_MP_SMOKE_NAMES)
    for scenario in scenarios.values():
        assert scenario.notes["app"] == "kv"
        assert "kv" in scenario.tags
        assert scenario.notes["kv_sessions"] >= 2


# -- tier-1: the supervisor without workers -----------------------------------


SPEC_CASES = {
    "default": dict(node_count=4, client_ids=[1, 2]),
    "wan": dict(node_count=4, client_ids=[1], profile="wan",
                latency_seed=3, batch_size=4, tick_seconds=0.25),
    "join": dict(node_count=5, client_ids=[1, 2, 9], deferred_nodes=(4,),
                 checkpoint_interval=5, proxied=True,
                 network_config={"nodes": [0, 1, 2, 3], "f": 1,
                                 "number_of_buckets": 4,
                                 "checkpoint_interval": 5,
                                 "max_epoch_length": 50}),
    "kv-traced-signed": dict(node_count=4, client_ids=[1, 2, 3], app="kv",
                             trace=True, link_auth=True, auth_secret="s",
                             signed_ingress=True),
}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_worker_specs_are_the_jax_supervisors(tmp_path, case):
    """For the same arguments the port's spec equals the JAX one key for
    key, but for the port's ``device`` and the processor kind (the
    port's default is its ``cuda``, the JAX package's ``serial``)."""
    kwargs = SPEC_CASES[case]
    root = str(tmp_path / "cluster")
    port = ClusterSupervisor(root=root, **kwargs)
    ref = RefSupervisor(root=root, **kwargs)
    assert port.processor == "cuda" and ref.processor == "serial"
    assert port.device == "cuda"
    for node in range(kwargs["node_count"]):
        for fresh, transport_port in ((True, 0), (False, 4321)):
            mine = port._spec(node, fresh, transport_port)
            theirs = ref._spec(node, fresh, transport_port)
            assert mine.pop("device") == "cuda"
            assert mine.pop("processor") == "cuda"
            assert theirs.pop("processor") == "serial"
            assert mine == theirs
    joined = port._spec(0, True, 0, network_config={"nodes": [0, 1]})
    assert joined["network_config"] == {"nodes": [0, 1]}
    assert ClusterSupervisor(root=root, device="cpu")._spec(0, True, 0)[
        "device"] == "cpu"


def _wait_for(predicate, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def test_supervisor_submit_teardown_race_is_a_clean_error(tmp_path):
    """submit() runs on load-generator threads while teardown() closes and
    None-s the client transport on the driver thread.  The handle is
    snapshotted under the supervisor lock, so a loser of the race sees
    RuntimeError (or a harmless propose into a closing transport) — never
    an AttributeError off a None handle."""
    sup = ClusterSupervisor(
        node_count=2, client_ids=[1], root=str(tmp_path / "cluster")
    )
    request = pb.Request(client_id=1, req_no=0, data=b"race")
    # Unstarted: the clean error, not AttributeError.
    with pytest.raises(RuntimeError):
        sup.submit(0, request)

    class _StubTransport:
        def propose(self, node_id, req):
            pass

        def close(self, node_id):
            pass

    errors = []
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            try:
                sup.submit(0, request)
            except RuntimeError:
                pass
            except BaseException as exc:  # AttributeError == the old bug
                errors.append(exc)
                return

    worker = threading.Thread(target=hammer)
    worker.start()
    try:
        for _ in range(300):
            with sup._lock:
                sup._client_transport = _StubTransport()
            sup.teardown()  # closes + None-s the handle, no nodes to stop
    finally:
        stop.set()
        worker.join(timeout=10.0)
    assert not worker.is_alive()
    assert not errors, errors
    with pytest.raises(RuntimeError):
        sup.submit(0, request)


def test_cluster_lock_acquisition_graph_is_acyclic(tmp_path, monkeypatch):
    """Dynamic lock-order harness (tools/analysis/lockorder): submit
    threads drive the port supervisor's client TcpTransport (reconnect
    backoff against a dead peer included) while the driver thread tears
    down, with every threading primitive in the supervisor and transport
    instrumented; the cross-thread lock graph must stay cycle-free."""
    sys.path.insert(0, str(ROOT / "tools"))
    from analysis.lockorder import LockMonitor, _InstrumentedLock

    from mirbft_tpu_torch.cluster import supervisor as supervisor_mod
    from mirbft_tpu_torch.runtime import transport as transport_mod

    monitor = LockMonitor()
    proxy = monitor.threading_proxy()
    monkeypatch.setattr(supervisor_mod, "threading", proxy)
    monkeypatch.setattr(transport_mod, "threading", proxy)

    sup = ClusterSupervisor(
        node_count=2, client_ids=[1], root=str(tmp_path / "cluster")
    )
    assert isinstance(sup._lock, _InstrumentedLock)
    client = transport_mod.TcpTransport(
        supervisor_mod._CLIENT_NODE_ID,
        port=0,
        backoff_base=0.01,
        backoff_cap=0.05,
        dial_timeout=0.2,
    )
    assert isinstance(client._lock, _InstrumentedLock)
    # A bound-but-not-listening port refuses connections deterministically,
    # so sends exercise the channel cv's reconnect-backoff waits.
    dead = socket.socket()
    dead.bind(("127.0.0.1", 0))
    try:
        client.connect(0, dead.getsockname())
        with sup._lock:
            sup._client_transport = client
        request = pb.Request(client_id=1, req_no=0, data=b"lockorder")

        def hammer():
            for _ in range(50):
                try:
                    sup.submit(0, request)
                except RuntimeError:
                    return
                time.sleep(0.001)

        threads = [threading.Thread(target=hammer) for _ in range(2)]
        for t in threads:
            t.start()
        time.sleep(0.05)
        sup.teardown()
        for t in threads:
            t.join(timeout=10.0)
            assert not t.is_alive()
    finally:
        dead.close()
        client.close(0)
    monitor.assert_no_cycles()


def test_the_fault_clock_stops_while_a_worker_boots():
    """A join or restart blocks until its worker is ready, seconds on a
    card; the mp driver's fault clock (and the proposer's first pass)
    stop meanwhile, so the scenario's later instants keep their place
    relative to its traffic (the JAX driver's clock runs on)."""
    from mirbft_tpu_torch.cluster.chaos_mp import _MpDriver

    seen = []

    def boot():
        seen.append(driver._clock_running.is_set())
        time.sleep(0.3)

    driver = _MpDriver(retry_storm_scenario(), 0.04, 10.0, 8, "cuda",
                       device="cpu")
    try:
        driver._start = time.monotonic()
        driver._booting(boot)
        assert seen == [False] and driver._clock_running.is_set()
        assert driver.now_ms() < 150
    finally:
        driver.supervisor.teardown()


# -- tier-1: real worker processes --------------------------------------------


def test_default_supervisor_without_a_card_raises_worker_died(tmp_path):
    """The supervisor's workers run on ``cuda`` unless asked for ``cpu``;
    on a machine without a card the first worker exits at boot, and
    ``start()`` raises ``WorkerDied`` with the log naming the card."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default workers would run")
    sup = ClusterSupervisor(root=str(tmp_path / "cluster"))
    try:
        with pytest.raises(WorkerDied, match="no CUDA card is present"):
            sup.start(timeout_s=60.0)
    finally:
        sup.teardown()
    codes = sup.exit_codes()
    assert any(c == [2] for c in codes.values()), codes
    assert sup.alive_nodes() == []


def test_one_worker_commits_restarts_from_disk_and_stops_cleanly(tmp_path):
    """A 1-node cluster (f = 0) on cuda-pipelined, ``device="cpu"``:
    three requests commit, SIGKILL, a restart from the WAL on the same
    port, three more commit, and a graceful stop (exit 0) whose
    metrics.json shows the kernel's plain version hashing every digest."""
    deadline = time.monotonic() + 60.0
    sup = ClusterSupervisor(
        node_count=1, client_ids=[1], root=str(tmp_path / "cluster"),
        processor="cuda-pipelined", device="cpu", keep_root=True,
    )

    def submit(req_nos):
        for q in req_nos:
            sup.submit(0, pb.Request(client_id=1, req_no=q, data=b"%d" % q))

    def committed():
        return {(c, q) for c, q, _s in sup.committed(0)}

    try:
        sup.start(timeout_s=deadline - time.monotonic())
        submit(range(3))
        _wait_for(lambda: {(1, q) for q in range(3)} <= committed(),
                  deadline - time.monotonic(), "the first three commits")
        port = sup.nodes[0].transport_port
        sup.kill(0, graceful=False)
        assert sup.alive_nodes() == []
        sup.restart(0, timeout_s=deadline - time.monotonic())
        assert sup.nodes[0].transport_port == port
        submit(range(3, 6))
        _wait_for(lambda: {(1, q) for q in range(6)} <= committed(),
                  deadline - time.monotonic(), "three more after restart")
        pairs = [(c, q) for c, q, _s in sup.committed(0)]
        assert len(pairs) == len(set(pairs)) == 6
    finally:
        sup.teardown()
    assert time.monotonic() < deadline
    assert sup.exit_codes() == {0: [-9, 0]}
    evidence = sup.evidence[0]
    assert evidence["processors"] == ["cuda-pipelined"]
    assert evidence["flushes"]["hash/device"] > 0
    assert evidence["launches"] > 0 and evidence["host_digests"] == 0
    assert evidence["log_faults"] == []
    metrics = read_json(str(tmp_path / "cluster" / "node0" / "metrics.json"))
    series = metrics["mirbft_crypto_flush_total"]["series"]
    assert any(s["labels"] == {"plane": "hash", "path": "device"}
               and s["value"] > 0 for s in series)


def test_worker_drain_fault_is_not_swallowed(tmp_path, capsys):
    """A fault raised while the processor drains at shutdown is written to
    the log and turns the exit code nonzero (the JAX worker passes it)."""
    from mirbft_tpu_torch.cluster import worker as worker_mod

    class _Faulty:
        def close(self):
            raise RuntimeError("CUDA error: an illegal memory access")

    spec = {"node_id": 0, "node_count": 1, "client_ids": [1],
            "dir": str(tmp_path / "node0"), "root": str(tmp_path),
            "device": "cpu", "processor": "cuda-pipelined"}
    worker = worker_mod.Worker(spec)
    worker.processor = _Faulty()
    fault = worker._shutdown(graceful=True)
    assert fault == worker_mod.EXIT_DRAIN_FAULT
    assert "processor drain failed" in capsys.readouterr().err


# Each node's (exit codes, whether the supervisor SIGKILLed that
# incarnation) and the faults ``worker_faults`` must name.
EXIT_CASES = {
    "clean": ([([0], [False]), ([-9, 0], [True, False])], []),
    "teardown-escalated": (
        [([0], [False]), ([-9], [False])],
        ["node 1 exited -9 after a SIGTERM"],
    ),
    "drain-fault": (
        [([5], [False]), ([0], [False])],
        ["node 0 exited 5 after a SIGTERM"],
    ),
    "died-before-the-crash": (
        [([0], [False]), ([3, 0], [True, False])],
        ["node 1 exited 3 after a SIGKILL"],
    ),
}


@pytest.mark.parametrize("case", sorted(EXIT_CASES))
def test_a_worker_exit_the_supervisor_did_not_cause_fails_the_scenario(
        tmp_path, monkeypatch, case):
    """``worker_faults`` names every incarnation that did not end as the
    supervisor ended it (0 after a SIGTERM, -9 after a crash's SIGKILL),
    and ``run_mp_scenario`` fails a scenario whose invariants all held
    when one is named: a worker hung in its drain and SIGKILLed by the
    teardown, or one that exited 5, must not pass the chaos gate."""
    from mirbft_tpu_torch.cluster import chaos_mp

    nodes, want = EXIT_CASES[case]
    sup = ClusterSupervisor(node_count=len(nodes), client_ids=[1],
                            root=str(tmp_path / "cluster"), device="cpu")
    for handle, (codes, killed) in zip(sup.nodes, nodes):
        handle.exit_codes, handle.sigkilled = list(codes), list(killed)

    class _Driver:
        """The mp driver's surface ``run_mp_scenario`` reads, with no
        workers: the run converges at once with nothing committed."""

        heal_times_ms: list = []
        commit_times_ms: list = []
        snapshots: list = []
        events_fired = 0
        _start = None
        reconfig_payload = None
        flood_specs: list = []

        def __init__(self, *_args, **_kwargs):
            self.supervisor = sup

        def run(self):
            return 0

        def scale_s(self, seconds):
            return seconds

        def evidence(self):
            return SimpleNamespace(node_count=0, node_states=[])

        def teardown(self):
            sup.teardown()

    monkeypatch.setattr(chaos_mp, "_MpDriver", _Driver)
    scenario = next(s for s in mp_matrix() if s.name == "crash-restart")
    assert sup.worker_faults() == want
    result = run_mp_scenario(scenario, device="cpu")
    assert result.counters["worker_faults"] == want
    assert result.passed == (not want)
    assert result.violation == "; ".join(want)


# -- slow: real clusters -------------------------------------------------------


def _lifecycle(supervisor_cls, request_cls, root, **kwargs):
    """tests/test_cluster.py:218 on one package: boot, a broadcast commit
    on every node, SIGKILL node 3, restart it from disk, a fresh request
    committed on node 3's recovered log, teardown, postmortem."""
    sup = supervisor_cls(node_count=4, client_ids=[1], root=root, **kwargs)
    try:
        sup.start(timeout_s=120.0)
        for node_id in sup.node_ids:
            health = sup.healthz(node_id)
            assert health and health.get("ready") is True, health
        request = request_cls(client_id=1, req_no=0, data=b"mp-smoke")
        for node_id in sup.node_ids:
            sup.submit(node_id, request)
        _wait_for(lambda: all(
            (1, 0) in {(c, q) for (c, q, _s) in sup.committed(n)}
            for n in sup.node_ids
        ), 60.0, "commit on all four nodes")
        sup.kill(3, graceful=False)
        _wait_for(lambda: 3 not in sup.alive_nodes(), 10.0, "node 3 death")
        assert sup.healthz(3) is None
        assert sorted(sup.alive_nodes()) == [0, 1, 2]
        dumps = sup.flight_dumps()
        assert 3 in dumps, dumps
        with open(dumps[3]) as fh:
            victim = json.load(fh)
        assert victim["reason"] == "sigkill-reaped"
        assert victim["entries"]
        sup.restart(3, timeout_s=120.0)
        _wait_for(lambda: 3 in sup.alive_nodes(), 10.0, "node 3 restart")
        health = sup.healthz(3)
        assert health and health.get("ready") is True
        request2 = request_cls(client_id=1, req_no=1, data=b"post-restart")
        for node_id in sup.node_ids:
            sup.submit(node_id, request2)
        _wait_for(
            lambda: (1, 1) in {(c, q) for (c, q, _s) in sup.committed(3)},
            60.0, "post-restart commit on node 3",
        )
        commits = [sup.committed(n) for n in sup.node_ids]
    finally:
        sup.teardown()
    assert sup.alive_nodes() == []
    for per_node in commits:
        pairs = [(c, q) for c, q, _s in per_node]
        assert len(pairs) == len(set(pairs))
    return sup


def _reference_fault(root) -> str:
    """Which known reference fault a failed JAX cluster run shows: a node
    whose serializer died of a commit quorum during its transfer (ROADMAP
    queue 3, item 14), or a node that fell behind and caught up by a
    snapshot, so its app.log holds an adopt record where the others
    applied the request (a follower's late digest stalls its sequence,
    queue 3, item 2).  Empty when neither shows."""
    logs = "".join(
        path.read_text(errors="replace")
        for path in sorted(Path(root).glob("node*/worker.log"))
    )
    if "must never commit during state transfer" in logs:
        return "commit during transfer"
    for path in sorted(Path(root).glob("node*/transfer.json")):
        counters = (ref_read_json(str(path)) or {}).get("counters", {})
        if counters.get("snapshots_installed", 0):
            return "caught up by a snapshot"
    return ""


@pytest.mark.slow
def test_supervisor_lifecycle_on_both_packages(tmp_path):
    """The port's run passes.  The JAX run passes, or fails of one of the
    reference faults ``_reference_fault`` names (the port repaired
    both)."""
    from mirbft_tpu.obsv.recorder import postmortem as ref_postmortem
    from mirbft_tpu_torch.obsv.recorder import postmortem

    try:
        _lifecycle(RefSupervisor, ref_pb.Request, str(tmp_path / "jax"))
    except AssertionError as err:
        assert _reference_fault(tmp_path / "jax"), err
    sup = _lifecycle(ClusterSupervisor, pb.Request, str(tmp_path / "port"),
                     processor="cuda-pipelined", device="cpu")
    assert sup.exit_codes()[3] == [-9, 0]
    assert all(e["host_digests"] == 0 and e["launches"] > 0
               and not e["log_faults"] for e in sup.evidence.values())
    for path, merge in ((tmp_path / "jax", ref_postmortem),
                        (tmp_path / "port", postmortem)):
        result = merge(str(path))
        assert set(result["nodes"]) == {0, 1, 2, 3}
        assert result["timeline"].splitlines()


@pytest.mark.slow
@pytest.mark.chaos
def test_mp_chaos_crash_restart_scenario_on_both_packages():
    """The port's run passes.  The JAX run passes, or node 1 was killed
    before its first persist and its restart refuses the empty WAL
    (ROADMAP queue 3, item 8: the port's worker goes ready only once its
    bootstrap log is fsynced)."""
    ref = ref_run_mp_scenario(
        next(s for s in ref_mp_matrix() if s.name == "crash-restart"),
        seed=0, budget_s=240.0,
    )
    port = run_mp_scenario(
        next(s for s in mp_matrix() if s.name == "crash-restart"),
        seed=0, budget_s=240.0, processor="cuda-pipelined", device="cpu",
    )
    assert ref.passed or "restart with empty WAL" in ref.violation, (
        ref.violation)
    assert port.passed, port.violation
    assert port.counters["exit_codes"][1] == [-9, 0]
    assert port.counters["host_digests"] == 0


@pytest.mark.slow
@pytest.mark.chaos
@pytest.mark.parametrize("name", ["kv-crash-restart", "kv-partition-minority"])
def test_kv_mp_chaos_scenario_linearizable_reads(name):
    scenario = next(s for s in kv_mp_matrix() if s.name == name)
    result = run_mp_scenario(scenario, seed=0, budget_s=240.0, device="cpu")
    assert result.passed, result.violation
    assert result.counters["kv_reads"] > 0
    assert result.counters["kv_writes"] > 0
    assert result.counters["kv_overlaps"] > 0


@pytest.mark.slow
@pytest.mark.chaos
def test_mp_join_under_partition():
    from mirbft_tpu_torch.cluster.chaos_mp import (
        join_under_partition_scenario,
    )

    result = run_mp_scenario(
        join_under_partition_scenario(), seed=0, budget_s=300.0, device="cpu"
    )
    assert result.passed, result.violation
    assert result.counters["snapshots_installed"] >= 1
    assert result.counters["catchup_ms"] >= 0


@pytest.mark.slow
@pytest.mark.chaos
def test_mp_remove_under_partition():
    from mirbft_tpu_torch.cluster.chaos_mp import (
        remove_under_partition_scenario,
    )

    result = run_mp_scenario(
        remove_under_partition_scenario(), seed=0, budget_s=300.0,
        device="cpu",
    )
    assert result.passed, result.violation
    assert result.counters["removed"] == 1


@pytest.mark.slow
def test_live_mp_run_small():
    from mirbft_tpu_torch import bench

    out = bench.live_mp_run("cuda-pipelined", device="cpu", rates=(10.0,),
                            step_s=1.0, drain_s=15.0)
    step = out["steps"][0]
    assert step.submitted > 0 and step.committed == step.submitted
    assert len(set(out["chains"])) == 1
    assert not out["duplicates"] and not out["missing"]
    assert all(codes == [0] for codes in out["exit_codes"].values())
    assert all(e["flushes"]["hash/device"] > 0 and e["host_digests"] == 0
               for e in out["evidence"].values())


@pytest.mark.slow
def test_reconfig_run_small():
    from mirbft_tpu_torch import bench

    out = bench.reconfig_run(device="cpu", step_s=2.0, drain_s=10.0)
    assert out["evidence"]["adoptions"] > 0 and out["evidence"]["joined"]
    assert out["evidence"]["snapshots_installed"] >= 1
    assert not out["duplicates"]
    assert all(codes == [0] for codes in out["exit_codes"].values())


@pytest.mark.slow
def test_knee_run_small():
    from mirbft_tpu_torch import bench

    artifact = bench.knee_run(
        device="cpu", configs=(("cuda-lan", "cuda", "lan", True, 2),),
        nodes=4, step_s=1.0, drain_s=6.0,
    )
    config = artifact["configs"][0]
    assert config["processor"] == "cuda" and len(config["steps"]) >= 1
    assert all(codes == [0] for codes in config["exit_codes"].values())
    assert all(e["flushes"]["hash/device"] > 0
               for e in config["evidence"].values())

