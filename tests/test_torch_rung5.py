"""BASELINE rung 5 (``bench.rung5_run``) and the JAX package's rung-5
ingredient tests, each case through both packages.

Rung 5: the port's ``rung5_run(device="cpu")`` (the SHA-256 kernel's
plain version computing every digest) against the JAX recipe
(``tests/rung5_cases.py``, the JAX ``bench.rung5_run`` with its shape as
keywords) at 16-node cuts of the JAX schedule: equal events, simulated
ms, chain, commits and the crashed node's record.  A crash during the
RequestAck flood loses the acks in flight to the node; restarted, it
cannot certify the first batches' requests, commits nothing, and comes
back only by installing the checkpoint at seq 100, as node 200 does at
the full shape.  A crash before the flood leaves it ordering on from its
WAL.  The slow tier runs that road at 256 nodes; the full shape's pin
(``tests/rung5_stage.py``'s ``PIN``) runs behind ``MIRBFT_TPU_HEAVY``.

The ingredient tests mirror ``tests/test_testengine.py:338`` (the
combined storm), ``tests/test_state_transfer.py`` (3 cases), ``:216``
(256 nodes under WAN jitter, slow) and ``:254`` (the full storm, HEAVY);
``:463`` (crash and restart) is mirrored in ``test_torch_manglers.py``.
Every run goes through both engines on one seed and must give the same
events, simulated ms, chains, committed (client, req_no, seq) per node
and, where the run records, every recorded event on the wire.  None of
these cases needs the port's late-digest advance (ROADMAP queue 3, item
2) patched into the JAX ``Sequence``: each equals the JAX package as it
is, and so do the rung-5 cuts.  The rung-5 recipe takes the patch all
the same, as the JAX run the rung is held against, and the full storm
(not run here) too.
"""

import os

import pytest

from chaos_pin import _late_digest_advances
from mirbft_tpu import pb as ref_pb
from mirbft_tpu.testengine import BasicRecorder as RefRecorder
from mirbft_tpu.testengine import RuntimeParameters as RefParameters
from mirbft_tpu.testengine import manglers as ref_manglers
from mirbft_tpu_torch import bench, pb
from mirbft_tpu_torch.testengine import BasicRecorder, RuntimeParameters
from mirbft_tpu_torch.testengine import manglers
from mirbft_tpu_torch.testengine.crypto_plane import CoalescingHashPlane
from rung5_cases import CUTS, jax_rung5
from rung5_stage import PIN

HEAVY = pytest.mark.skipif(
    not os.environ.get("MIRBFT_TPU_HEAVY"),
    reason="tens of minutes a package on the host event loop; set "
    "MIRBFT_TPU_HEAVY=1 to run",
)


# -- rung 5 -----------------------------------------------------------------------


def _both(**shape) -> tuple:
    port = bench.rung5_run(device="cpu", **shape)
    ref = jax_rung5(**shape)
    assert ref["chains"] == [port["chain"]]
    for key in ("events", "sim_ms", "commits", "crash"):
        assert port[key] == ref[key], key
    return port, ref


@pytest.mark.parametrize("cut", list(CUTS))
def test_rung5_cut_equals_the_jax_recipe(cut):
    nodes, clients, crash_node, crash_after, down_for = CUTS[cut]
    port, _ref = _both(nodes=nodes, clients=clients, crash_node=crash_node,
                       crash_after=crash_after, down_for=down_for)
    assert port["commits"] == [clients]
    assert port["host_digests"] == 0 and port["device_digests"] > 0
    crash = port["crash"]
    assert crash["committed_anywhere_at_crash"] == 0
    assert crash["first_commit_ms"] is not None
    if cut == "before-the-ack-flood":
        # Nothing but a tick was in flight to it: it orders on from its
        # WAL with the others and installs nothing.
        assert crash["returned_by"] == "wal-replay" and not crash["installs"]
        assert crash["first_commit_ms"] < 10_000
    else:
        # Its peers' acks died with it: it sits at 0 commits while the
        # others commit and garbage-collect checkpoints 20-80, and comes
        # back only by installing the certified checkpoint at seq 100.
        assert crash["returned_by"] == "snapshot"
        assert crash["installs"] == [(crash["first_commit_ms"], 100)]
        assert crash["first_commit_ms"] == port["sim_ms"] > 40_000
        assert crash["last_seq"] == 100
    if cut == "during-the-ack-flood":
        assert (port["events"], port["sim_ms"]) == (27197, 41403)
        assert (crash["crash_ms"], crash["restart_ms"]) == (282, 2120)


@pytest.mark.parametrize("cut", ["during-the-ack-flood",
                                 "before-the-ack-flood"])
def test_rung5_cut_equals_the_unpatched_jax_recipe(cut):
    """The late-digest advance makes no difference on rung 5's roads."""
    nodes, clients, crash_node, crash_after, down_for = CUTS[cut]
    shape = dict(nodes=nodes, clients=clients, crash_node=crash_node,
                 crash_after=crash_after, down_for=down_for)
    port = bench.rung5_run(device="cpu", **shape)
    ref = jax_rung5(late_digest=False, **shape)
    assert ref["chains"] == [port["chain"]]
    for key in ("events", "sim_ms", "commits", "crash"):
        assert port[key] == ref[key], key


@pytest.mark.slow
def test_rung5_at_256_nodes_takes_the_full_shapes_road():
    """256 nodes, the JAX schedule, 64 clients: the crash lands during
    the RequestAck flood and before the first commit, and node 200 comes
    back by installing the checkpoint at seq 100, on both packages.  No
    cut at 256 nodes is much cheaper than the rung (~20 min a package on
    the CPU): its length is node 200's ~41 simulated s of waiting for seq
    100, at ~130k events a simulated second."""
    port, _ref = _both(nodes=256, clients=64, crash_node=200,
                       crash_after=20_000, down_for=40_000)
    assert (port["events"], port["sim_ms"]) == (5441087, 41401)
    crash = port["crash"]
    assert crash["committed_anywhere_at_crash"] == 0
    assert crash["returned_by"] == "snapshot"
    assert crash["installs"] == [(crash["first_commit_ms"], 100)]


@HEAVY
@pytest.mark.slow
def test_rung5_full_shape_pin():
    """The rung as the bench runs it, one ``drain_clients`` call, on both
    packages: the pinned events, simulated ms and chain."""
    port, _ref = _both(nodes=bench.RUNG5_NODES, clients=bench.RUNG5_CLIENTS,
                       crash_node=bench.RUNG5_CRASH_NODE,
                       crash_after=bench.RUNG5_CRASH_AFTER,
                       down_for=bench.RUNG5_DOWN_FOR)
    assert {key: port[key] for key in PIN} == PIN
    assert port["crash"]["crash_ms"] == 275
    assert port["crash"]["restart_ms"] == 288
    assert port["crash"]["installs"] == [(40901, 100)]


# -- the ingredient tests, through both engines ------------------------------------


class _Package:
    """One package's engine pieces, so each scenario is written once."""

    def __init__(self, port: bool):
        self.port = port
        self.pb = pb if port else ref_pb
        self.manglers = manglers if port else ref_manglers
        self.params = RuntimeParameters if port else RefParameters
        self._recorder = BasicRecorder if port else RefRecorder

    def recorder(self, *args, **kwargs):
        if self.port:
            kwargs.setdefault("hash_plane", CoalescingHashPlane())
        return self._recorder(*args, **kwargs)


def _outcome(r, module_pb) -> tuple:
    return (
        r.event_count,
        r.now,
        {n: s.app_chain.hex() for n, s in r.node_states.items()},
        {n: list(s.committed_reqs) for n, s in r.node_states.items()},
        [(when, node, module_pb.encode(event))
         for when, node, event in r.recorded_events],
    )


def _run_both(scenario, late_digest: bool):
    """``scenario(package)`` on the port and on the JAX package (with the
    late-digest advance where asked); both must decide the same.
    Returns the port's recorder."""
    port = scenario(_Package(True))
    if late_digest:
        with _late_digest_advances():
            ref = scenario(_Package(False))
    else:
        ref = scenario(_Package(False))
    assert _outcome(port, pb) == _outcome(ref, ref_pb)
    return port


def _chains(r) -> dict:
    return {
        n: r.node_states[n].app_chain.hex()
        for n in range(r.node_count)
        if not r.node_states[n].crashed
    }


def _adopted(r, module_pb) -> list:
    return [
        (t, n) for (t, n, e) in r.recorded_events
        if isinstance(e.type, module_pb.EventTransfer)
        and e.type.c_entry.network_state is not None
    ]


def _combined_storm(p):
    """tests/test_testengine.py:338: a silenced leader forces an epoch
    change while node 2 crashes, stays down past garbage collection and
    restarts."""
    m = p.manglers
    r = p.recorder(
        node_count=4, client_count=2, reqs_per_client=40, batch_size=2,
        manglers=[m.rule(m.from_source(0), m.is_step(),
                         m.until_time(6_000)).drop()],
    )
    for _ in range(3000):
        r.step()
    r.crash(2)
    for _ in range(120000):
        if r.fully_committed():
            break
        r.step()
    r.restart(2)
    r.drain_until(
        lambda rr: rr.machines[2].epoch_tracker is not None
        and rr.machines[2].epoch_tracker.current_epoch is not None,
        max_steps=600000,
    )
    r.drain_clients(max_steps=600000)
    for _ in range(200000):
        if len(set(_chains(r).values())) == 1:
            break
        if not r.step():
            break
    return r


def test_combined_storm_crash_and_transfer_matches_reference():
    r = _run_both(_combined_storm, late_digest=False)
    epochs = {n: r.machines[n].epoch_tracker.current_epoch.number
              for n in range(4)}
    assert min(epochs.values()) >= 1, epochs
    assert len(set(_chains(r).values())) == 1


def _late_start(p):
    """tests/test_state_transfer.py:17: node 3 down from t=0 while the
    others commit 80 requests; on reboot it must transfer."""
    r = p.recorder(node_count=4, client_count=2, reqs_per_client=40)
    r.crash(3)
    r.schedule_restart(3, 40_000)
    r.drain_clients(max_steps=1_000_000)
    r.drain_until(lambda rec: rec.committed_at(3) >= 80,
                  max_steps=1_000_000)
    return r


def _crash_past_gc(p):
    """tests/test_state_transfer.py:42: node 2 crashed after 10 commits,
    restarted 60 s later."""
    r = p.recorder(node_count=4, client_count=2, reqs_per_client=40)
    r.drain_until(lambda rec: rec.committed_at(2) >= 10, max_steps=1_000_000)
    r.crash(2)
    r.schedule_restart(2, 60_000)
    r.drain_clients(max_steps=1_000_000)
    r.drain_until(lambda rec: rec.committed_at(2) >= 80,
                  max_steps=1_000_000)
    return r


def _dsl_past_gc(p):
    """tests/test_state_transfer.py:60: the DSL's crash_and_restart_after
    crashes node 2 from inside the mangling pipeline for 60 s."""
    m = p.manglers
    r = p.recorder(
        node_count=4, client_count=2, reqs_per_client=40,
        manglers=[m.rule(m.to_node(2), m.is_step(), m.after_events(120),
                         m.once()).crash_and_restart_after(60_000)],
    )
    r.drain_clients(max_steps=1_000_000)
    r.drain_until(lambda rec: rec.committed_at(2) >= 80,
                  max_steps=1_000_000)
    return r


@pytest.mark.parametrize("scenario, node", [
    (_late_start, 3), (_crash_past_gc, 2), (_dsl_past_gc, 2),
], ids=["late-start", "crash-past-gc", "dsl-crash-past-gc"])
def test_state_transfer_matches_reference(scenario, node):
    r = _run_both(scenario, late_digest=False)
    chains = {n: r.node_states[n].app_chain for n in range(4)}
    assert len(set(chains.values())) == 1 and chains[node] != b""
    adopted = _adopted(r, pb)
    if scenario is not _crash_past_gc:  # the JAX case asserts none there
        assert adopted and all(n == node for _t, n in adopted)
    for n in range(4):
        pairs = [(c, q) for c, q, _s in r.node_states[n].committed_reqs]
        assert len(pairs) == len(set(pairs))


def _wan_state(p, nodes, client_ids, width):
    return p.pb.NetworkState(
        config=p.pb.NetworkConfig(
            nodes=list(range(nodes)),
            f=(nodes - 1) // 3,
            number_of_buckets=4,
            checkpoint_interval=20,
            max_epoch_length=200,
        ),
        clients=[p.pb.NetworkClient(id=c, width=width, low_watermark=0)
                 for c in client_ids],
    )


def _wan_256(p):
    """tests/test_testengine.py:216: 256 nodes, 2 clients x 2, 30 ms of
    link jitter."""
    nodes = 256
    r = p.recorder(
        nodes, 2, 2, batch_size=10, record=False,
        network_state=_wan_state(p, nodes, [nodes, nodes + 1], 100),
        params=p.params(link_jitter=30),
    )
    r.drain_clients(max_steps=60_000_000)
    return r


@pytest.mark.slow
def test_two_hundred_fifty_six_node_wan_matches_reference():
    r = _run_both(_wan_256, late_digest=False)
    assert len(set(_chains(r).values())) == 1


def _full_storm(p):
    """tests/test_testengine.py:254: 256 nodes, 10,000 clients, a silenced
    leader for 4 s, node 200 crashed and restarted."""
    m = p.manglers
    nodes = 256
    client_ids = [nodes + i for i in range(10_000)]
    r = p.recorder(
        nodes, 10_000, 1, batch_size=200, record=False,
        network_state=_wan_state(p, nodes, client_ids, 2),
        params=p.params(link_jitter=20),
        manglers=[m.rule(m.from_source(1), m.is_step(),
                         m.until_time(4000)).drop()],
    )
    for _ in range(50_000):
        r.step()
    r.crash(200)
    for _ in range(100_000):
        r.step()
    r.schedule_restart(200, delay=0)
    r.drain_clients(max_steps=400_000_000)
    return r


@HEAVY
@pytest.mark.slow
def test_rung5_storm_full_scale_matches_reference():
    r = _run_both(_full_storm, late_digest=True)
    assert len(set(_chains(r).values())) == 1
    assert all(r.committed_at(n) == 10_000 for n in range(256))
    epochs = {r.machines[n].epoch_tracker.current_epoch.number
              for n in range(256)}
    assert min(epochs) >= 1
