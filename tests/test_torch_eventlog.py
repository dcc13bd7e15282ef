"""The port's event log (mirbft_tpu_torch/eventlog.py) held against the JAX
package's.

Mirrors tests/test_eventlog.py on the port: round trip, redaction, replay
to the live run's status, replay to an index, replay of a crash/restart
run, a torn log yielding its intact prefix, first divergence, and the
async recorder on a live node.  Across packages: a log written by the
port reads back in the JAX package's ``read_log`` and the reverse, with
equal events, and a run of the port's engine logs the same bytes as the
JAX engine's on the same seed."""

import pytest

from mirbft_tpu import eventlog as ref_eventlog
from mirbft_tpu import pb as ref_pb
from mirbft_tpu.testengine import BasicRecorder as RefRecorder
from mirbft_tpu_torch import pb
from mirbft_tpu_torch.eventlog import (
    EngineLog,
    Player,
    RecordedEvent,
    Recorder,
    first_divergence,
    read_log,
    redact_event,
    write_log,
)
from mirbft_tpu_torch.status import state_machine_status
from mirbft_tpu_torch.testengine import BasicRecorder
from mirbft_tpu_torch.testengine.crypto_plane import (
    AsyncKernelHashPlane,
    CoalescingHashPlane,
)


def port_recorder(*shape, **kwargs):
    kwargs.setdefault("hash_plane", CoalescingHashPlane())
    return BasicRecorder(*shape, **kwargs)


def _sample_events(module_pb=pb):
    return [
        (0, 10, module_pb.StateEvent(type=module_pb.EventPropose(
            request=module_pb.Request(client_id=4, req_no=1, data=b"payload")
        ))),
        (1, 20, module_pb.StateEvent(type=module_pb.EventStep(
            source=0,
            msg=module_pb.Msg(type=module_pb.RequestAck(
                client_id=4, req_no=1, digest=b"\xaa" * 32
            )),
        ))),
        (0, 30, module_pb.StateEvent(type=module_pb.EventTick())),
    ]


def _wire(events, module_pb) -> list:
    return [(e.node_id, e.time_ms, module_pb.encode(e.state_event))
            for e in events]


def test_round_trip(tmp_path):
    path = str(tmp_path / "log.gz")
    write_log(path, _sample_events(), redact=False)
    events = read_log(path)
    assert [e.node_id for e in events] == [0, 1, 0]
    assert [e.time_ms for e in events] == [10, 20, 30]
    assert events[0].state_event.type.request.data == b"payload"
    assert isinstance(events[2].state_event.type, pb.EventTick)


def test_redaction(tmp_path):
    path = str(tmp_path / "log.gz")
    write_log(path, _sample_events())  # redact=True default
    events = read_log(path)
    req = events[0].state_event.type.request
    assert req.data == b"" and req.client_id == 4 and req.req_no == 1
    assert events[1].state_event.type.msg.type.digest == b"\xaa" * 32

    fwd = pb.StateEvent(type=pb.EventStep(
        source=2,
        msg=pb.Msg(type=pb.ForwardRequest(
            request_ack=pb.RequestAck(client_id=4, req_no=1,
                                      digest=b"\xbb" * 32),
            request_data=b"secret",
        )),
    ))
    red = redact_event(fwd)
    assert red.type.msg.type.request_data == b""
    assert red.type.msg.type.request_ack.digest == b"\xbb" * 32
    assert fwd.type.msg.type.request_data == b"secret"


@pytest.mark.parametrize("redact", [False, True], ids=["raw", "redacted"])
def test_logs_cross_packages_both_ways(tmp_path, redact):
    """The port's log reads back in the JAX package's reader and the JAX
    package's in the port's, with equal events; the files are the same
    bytes on the wire."""
    ours = str(tmp_path / "port.gz")
    theirs = str(tmp_path / "ref.gz")
    write_log(ours, _sample_events(pb), redact=redact)
    ref_eventlog.write_log(theirs, _sample_events(ref_pb), redact=redact)
    assert _wire(ref_eventlog.read_log(ours), ref_pb) == _wire(
        read_log(ours), pb)
    assert _wire(read_log(theirs), pb) == _wire(
        ref_eventlog.read_log(theirs), ref_pb)
    assert _wire(read_log(ours), pb) == _wire(read_log(theirs), pb)


def test_engine_runs_log_the_same_events_in_both_packages(tmp_path):
    """A 4-node run of each engine on one seed, logged through each
    package's EngineLog: the port's log, read by the JAX reader, equals
    the JAX engine's log event for event."""
    ours, theirs = str(tmp_path / "port.gz"), str(tmp_path / "ref.gz")
    log = EngineLog(ours)
    r = BasicRecorder(4, 2, 3, interceptor=log.interceptor,
                      hash_plane=AsyncKernelHashPlane(device="cpu"))
    r.drain_clients(max_steps=100000)
    log.close()
    ref_log = ref_eventlog.EngineLog(theirs)
    ref = RefRecorder(4, 2, 3, interceptor=ref_log.interceptor)
    ref.drain_clients(max_steps=100000)
    ref_log.close()
    assert r.event_count == ref.event_count
    assert _wire(ref_eventlog.read_log(ours), ref_pb) == _wire(
        ref_eventlog.read_log(theirs), ref_pb)


def test_replay_matches_live_run(tmp_path):
    path = str(tmp_path / "run.gz")
    log = EngineLog(path)
    r = port_recorder(4, 2, 5, interceptor=log.interceptor)
    r.drain_clients(max_steps=100000)
    log.close()

    events = read_log(path)
    assert len(events) == r.event_count
    player = Player(events)
    player.play()
    for node_id, live_machine in r.machines.items():
        replayed = player.nodes[node_id].machine
        assert state_machine_status(replayed) == state_machine_status(
            live_machine
        ), f"replayed status diverged at node {node_id}"


def test_replay_to_index_is_prefix_consistent(tmp_path):
    path = str(tmp_path / "run.gz")
    log = EngineLog(path)
    r = port_recorder(1, 1, 3, interceptor=log.interceptor)
    r.drain_clients(max_steps=20000)
    log.close()
    events = read_log(path)

    player = Player(events)
    player.play(upto=len(events) // 2)
    assert player.position == len(events) // 2
    player.play()
    assert player.position == len(events)
    assert state_machine_status(player.nodes[0].machine) == (
        state_machine_status(r.machines[0])
    )


def test_replay_of_crash_restart_run():
    """A second EventInitialize on a node means a fresh StateMachine, as
    the live engine's restart did."""
    from mirbft_tpu_torch.testengine.manglers import (
        after_events,
        is_step,
        once,
        rule,
        to_node,
    )

    log = EngineLog()
    r = port_recorder(
        4, 2, 8, interceptor=log.interceptor,
        manglers=[rule(to_node(1), is_step(), after_events(30), once())
                  .crash_and_restart_after(5000)],
    )
    r.drain_clients(max_steps=600000)

    player = Player(log.events)
    player.play()
    for node_id, live in r.machines.items():
        assert state_machine_status(
            player.nodes[node_id].machine
        ) == state_machine_status(live)


def test_torn_log_yields_intact_prefix(tmp_path):
    path = str(tmp_path / "log.gz")
    write_log(path, _sample_events(), redact=False)
    raw = open(path, "rb").read()

    torn = str(tmp_path / "torn.gz")
    with open(torn, "wb") as f:
        f.write(raw[:-5])
    events = read_log(torn)
    assert 1 <= len(events) <= 3
    assert events[0].node_id == 0
    # The JAX package's reader yields the same prefix.
    assert _wire(ref_eventlog.read_log(torn), ref_pb) == _wire(events, pb)

    with pytest.raises((EOFError, OSError, ValueError)):
        read_log(torn, strict=True)


def test_first_divergence():
    log_a = EngineLog()
    r1 = port_recorder(1, 1, 3, interceptor=log_a.interceptor)
    r1.drain_clients(max_steps=20000)
    log_b = EngineLog()
    r2 = port_recorder(1, 1, 3, interceptor=log_b.interceptor)
    r2.drain_clients(max_steps=20000)

    assert first_divergence(log_a.events, log_b.events) is None

    mutated = list(log_b.events)
    mutated[5] = RecordedEvent(
        node_id=mutated[5].node_id,
        time_ms=mutated[5].time_ms + 1,
        state_event=mutated[5].state_event,
    )
    div = first_divergence(log_a.events, mutated)
    assert div is not None and div[0] == 5

    div = first_divergence(log_a.events, log_a.events[:-2])
    assert div is not None and div[0] == len(log_a.events) - 2
    assert div[2] is None


def test_async_recorder_runtime(tmp_path):
    """The runtime interceptor on a live port node: buffered, off-thread,
    and the log replays to the node's final state."""
    from test_torch_runtime import (
        Replica,
        ThreadTransport,
        await_commits,
        make_requests,
    )

    from mirbft_tpu_torch.runtime import Config, build_processor
    from mirbft_tpu_torch.runtime.node import standard_initial_network_state

    recorder = Recorder(str(tmp_path / "node0.gz"))
    transport = ThreadTransport()
    state = standard_initial_network_state(1, [1])
    replica = Replica(
        0, transport.link(0), tmp_path, state,
        config=Config(id=0, processor="serial",
                      event_interceptor=recorder.interceptor(0)),
        processor=lambda r: build_processor(
            r.node, r.link, r.app_log, r.wal, r.reqstore, device="cpu",
        ),
    )
    transport.register(0, replica.node)
    try:
        requests = make_requests(pb, 1, 5)
        for request in requests:
            replica.node.propose(request)
        await_commits([replica], {(1, r.req_no) for r in requests})
    finally:
        transport.unregister(0)
        replica.stop()
    recorder.close()
    assert recorder.dropped == 0

    events = read_log(str(tmp_path / "node0.gz"))
    assert len(events) > 0
    player = Player(events)
    player.play()
    assert state_machine_status(player.nodes[0].machine) == (
        state_machine_status(replica.node._machine)
    )
