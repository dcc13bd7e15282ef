"""The port's network layer (mirbft_tpu_torch.runtime: msgfilter,
TcpTransport) against the JAX package's: every case of
tests/test_msgfilter.py (ingress frame bounds and their rejection kinds)
and tests/test_transport.py (a 4-node cluster over localhost TCP, peer
death and reconnect, close, dribbled and corrupt frames, backoff, queue
overflow, a transport killed and restored, dial timeouts, the fault seam,
the clock-sync hello, TCP_NODELAY, the frame encoder), each run on both
packages on one input.  Where a case produces bytes or a rejection kind,
the two packages' are held equal too.

Not mirrored: the wall-clock half of tests/test_transport.py:723 (the
scratch frame encoder no slower than twice the naive spelling).  It times
two loops of a few milliseconds on a loaded machine, which says nothing
of either package; the byte equality it guards is kept, across packages.
"""

import hashlib
import queue
import socket as socketlib
import struct
import threading
import time
from types import SimpleNamespace

import pytest

import mirbft_tpu.obsv.hooks as ref_hooks
import mirbft_tpu.runtime as ref_runtime
import mirbft_tpu.runtime.msgfilter as ref_msgfilter
import mirbft_tpu.runtime.node as ref_node
import mirbft_tpu.runtime.processor as ref_processor
import mirbft_tpu.runtime.transport as ref_transport
import mirbft_tpu_torch.obsv.hooks as port_hooks
import mirbft_tpu_torch.runtime as port_runtime
import mirbft_tpu_torch.runtime.msgfilter as port_msgfilter
import mirbft_tpu_torch.runtime.node as port_node
import mirbft_tpu_torch.runtime.processor as port_processor
import mirbft_tpu_torch.runtime.transport as port_transport
from mirbft_tpu import pb as ref_pb
from mirbft_tpu import wire as ref_wire
from mirbft_tpu_torch import pb as port_pb
from mirbft_tpu_torch import wire as port_wire

PACKAGES = {
    "jax": SimpleNamespace(
        pb=ref_pb, wire=ref_wire, runtime=ref_runtime, node=ref_node,
        processor=ref_processor, transport=ref_transport,
        msgfilter=ref_msgfilter, hooks=ref_hooks,
    ),
    "port": SimpleNamespace(
        pb=port_pb, wire=port_wire, runtime=port_runtime, node=port_node,
        processor=port_processor, transport=port_transport,
        msgfilter=port_msgfilter, hooks=port_hooks,
    ),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def _other(pkg):
    """The package the case is held against."""
    return PACKAGES["jax"] if pkg is PACKAGES["port"] else PACKAGES["port"]


# -- tests/test_msgfilter.py ----------------------------------------------------


def _ack(pb, digest=b"d" * 32, client=4, req_no=0):
    return pb.RequestAck(client_id=client, req_no=req_no, digest=digest)


def _kind(pkg, call):
    with pytest.raises(pkg.msgfilter.MalformedMessage) as excinfo:
        call()
    return excinfo.value.kind


def _kinds(pkg, build, *config):
    """The rejection kind of ``build(pb)`` on this package and the other:
    they must agree."""
    kinds = []
    for p in (pkg, _other(pkg)):
        cfg = [p.runtime.Config(**config[0])] if config else []
        msg = p.pb.Msg(type=build(p.pb))
        kinds.append(_kind(p, lambda: p.msgfilter.pre_process(msg, *cfg)))
    assert kinds[0] == kinds[1], kinds
    return kinds[0]


def test_honest_messages_pass_default_limits(pkg):
    pb, pre_process = pkg.pb, pkg.msgfilter.pre_process

    def _msg(inner):
        return pb.Msg(type=inner)

    pre_process(_msg(pb.Preprepare(seq_no=1, epoch=1, batch=[_ack(pb)])))
    pre_process(_msg(pb.Prepare(seq_no=1, epoch=1, digest=b"d" * 32)))
    pre_process(_msg(pb.Commit(seq_no=1, epoch=1, digest=b"d" * 32)))
    pre_process(_msg(_ack(pb)))
    pre_process(
        _msg(pb.ForwardRequest(request_ack=_ack(pb), request_data=b"x" * 64))
    )
    pre_process(
        _msg(pb.ForwardBatch(seq_no=1, request_acks=[_ack(pb)],
                             digest=b"d" * 32))
    )


def test_structural_rejections_keep_malformed_kind(pkg):
    pb, pre_process = pkg.pb, pkg.msgfilter.pre_process
    assert _kind(pkg, lambda: pre_process(pb.Msg(type=None))) == "malformed"
    assert _kinds(pkg, lambda p: p.ForwardRequest(request_ack=None)) == (
        "malformed")
    assert _kinds(pkg, lambda p: p.NewEpoch(new_config=None)) == "malformed"


def test_oversized_preprepare_batch_rejected(pkg):
    kind = _kinds(pkg, lambda p: p.Preprepare(
        seq_no=1, epoch=1, batch=[_ack(p, req_no=i) for i in range(300)]))
    assert kind == "oversized_batch"


def test_oversized_forward_batch_rejected(pkg):
    kind = _kinds(pkg, lambda p: p.ForwardBatch(
        seq_no=1, request_acks=[_ack(p, req_no=i) for i in range(300)],
        digest=b""))
    assert kind == "oversized_batch"


def test_oversized_payload_rejected(pkg):
    kind = _kinds(pkg, lambda p: p.ForwardRequest(
        request_ack=_ack(p), request_data=b"x" * (1024 * 1024 + 1)))
    assert kind == "oversized_payload"


OVERSIZED_DIGESTS = {
    "Prepare": lambda p: p.Prepare(seq_no=1, epoch=1, digest=b"d" * 65),
    "Commit": lambda p: p.Commit(seq_no=1, epoch=1, digest=b"d" * 65),
    "RequestAck": lambda p: p.RequestAck(client_id=4, req_no=0,
                                         digest=b"d" * 65),
    "FetchBatch": lambda p: p.FetchBatch(seq_no=1, digest=b"d" * 65),
    "FetchRequest": lambda p: p.FetchRequest(client_id=4, req_no=0,
                                             digest=b"d" * 65),
    "ForwardBatch": lambda p: p.ForwardBatch(seq_no=1, request_acks=[],
                                             digest=b"d" * 65),
    "Preprepare": lambda p: p.Preprepare(
        seq_no=1, epoch=1, batch=[_ack(p, digest=b"d" * 65)]),
    "ForwardRequest": lambda p: p.ForwardRequest(
        request_ack=_ack(p, digest=b"d" * 65)),
}


@pytest.mark.parametrize("inner", sorted(OVERSIZED_DIGESTS))
def test_oversized_digest_rejected_everywhere(pkg, inner):
    assert _kinds(pkg, OVERSIZED_DIGESTS[inner]) == "oversized_digest"


def test_config_limits_override_defaults(pkg):
    pb = pkg.pb
    limits = dict(id=0, max_batch_acks=2, max_request_bytes=16,
                  max_digest_bytes=32)
    pkg.msgfilter.pre_process(
        pb.Msg(type=pb.Preprepare(seq_no=1, epoch=1,
                                  batch=[_ack(pb), _ack(pb, req_no=1)])),
        pkg.runtime.Config(**limits),
    )
    kind = _kinds(pkg, lambda p: p.Preprepare(
        seq_no=1, epoch=1, batch=[_ack(p, req_no=i) for i in range(3)]),
        limits)
    assert kind == "oversized_batch"
    kind = _kinds(pkg, lambda p: p.ForwardRequest(
        request_ack=_ack(p), request_data=b"x" * 17), limits)
    assert kind == "oversized_payload"
    kind = _kinds(pkg, lambda p: p.Prepare(digest=b"d" * 33), limits)
    assert kind == "oversized_digest"


def test_node_step_counts_rejections_by_kind(pkg):
    """Node.step enforces its Config bounds and labels the rejection
    metric with the taxonomy kind before the transport drops the frame."""
    pb = pkg.pb
    metrics, _ = pkg.hooks.enable()
    node = None
    try:
        node = pkg.runtime.Node.start_new(
            config=pkg.runtime.Config(id=0, max_batch_acks=4),
            initial_network_state=pkg.node.standard_initial_network_state(
                4, [4]),
        )
        with pytest.raises(pkg.msgfilter.MalformedMessage):
            node.step(1, pb.Msg(type=pb.Preprepare(
                seq_no=1, epoch=1,
                batch=[_ack(pb, req_no=i) for i in range(5)])))
        counter = metrics.counter(
            "mirbft_byzantine_rejections_total", kind="oversized_batch"
        )
        assert counter.value == 1
    finally:
        if node is not None:
            node.stop()
        pkg.hooks.disable()


# -- tests/test_transport.py: a cluster over TCP --------------------------------


class _ChainLogBody:
    def __init__(self):
        self.chain = b""
        self.commits = []
        self.commit_events = queue.Queue()

    def apply(self, q_entry):
        for ack in q_entry.requests:
            h = hashlib.sha256()
            h.update(self.chain)
            h.update(ack.digest)
            self.chain = h.digest()
            self.commits.append((ack.client_id, ack.req_no))
            self.commit_events.put((ack.client_id, ack.req_no))

    def snap(self, network_config, clients_state):
        return self.chain


def _chain_log(pkg):
    """tests/test_transport.py's ``_ChainLog``, on this package's Log."""
    cls = type("_ChainLog", (_ChainLogBody, pkg.processor.Log), {})
    return cls()


class _MemWal:
    def __init__(self):
        self.entries = []

    def write(self, index, entry):
        self.entries.append((index, entry))

    def truncate(self, index):
        self.entries = [(i, e) for i, e in self.entries if i >= index]

    def sync(self):
        pass


class _MemReqStore:
    def __init__(self):
        self.reqs = {}

    def store(self, ack, data):
        self.reqs[ack.digest] = data

    def get(self, ack):
        return self.reqs.get(ack.digest)

    def commit(self, ack):
        self.reqs.pop(ack.digest, None)

    def sync(self):
        pass


class _TcpReplica:
    def __init__(self, pkg, node_id, initial_state, registry):
        self.pkg = pkg
        rt = pkg.runtime
        self.transport = rt.TcpTransport(node_id)
        self.node = rt.Node.start_new(rt.Config(id=node_id), initial_state)
        self.transport.serve(self.node)
        self.app_log = _chain_log(pkg)
        self.processor = pkg.processor.SerialProcessor(
            self.node,
            self.transport.link(),
            self.app_log,
            _MemWal(),
            _MemReqStore(),
        )
        # Out-of-band state fetch registry (the consumer's job; a real
        # deployment fetches snapshots over its own channel).
        self.registry = registry
        registry[node_id] = self
        self.checkpoints = {}  # seq_no -> (value, pb.NetworkState)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._consume, daemon=True)

    def start(self):
        self._thread.start()

    def _consume(self):
        pb, stopped = self.pkg.pb, self.pkg.node.NodeStopped
        last_tick = time.monotonic()
        while not self._stop.is_set():
            actions = self.node.ready(timeout=0.01)
            if actions is not None:
                results = self.processor.process(actions)
                for cr in results.checkpoints:
                    self.checkpoints[cr.checkpoint.seq_no] = (
                        cr.value,
                        pb.NetworkState(
                            config=cr.checkpoint.network_config,
                            clients=cr.checkpoint.clients_state,
                            pending_reconfigurations=list(
                                cr.reconfigurations
                            ),
                        ),
                    )
                if results.digests or results.checkpoints:
                    try:
                        self.node.add_results(results)
                    except stopped:
                        return
                if actions.state_transfer is not None:
                    self._serve_transfer(actions.state_transfer)
            if time.monotonic() - last_tick >= 0.05:
                last_tick = time.monotonic()
                try:
                    self.node.tick()
                except stopped:
                    return

    def _serve_transfer(self, target):
        stopped = self.pkg.node.NodeStopped
        for node_id, peer in list(self.registry.items()):
            if node_id == self.node.config.id:
                continue
            entry = peer.checkpoints.get(target.seq_no)
            if entry is None or entry[0] != target.value:
                continue
            value, network_state = entry
            self.app_log.chain = value  # adopt the app state wholesale
            try:
                self.node.state_transfer_complete(target, network_state)
            except stopped:
                pass
            return
        try:
            self.node.state_transfer_failed(target)
        except stopped:
            pass

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)
        self.node.stop()
        self.transport.close()


def _mesh(pkg, n=4):
    state = pkg.node.standard_initial_network_state(n, [9])
    registry = {}
    replicas = [_TcpReplica(pkg, i, state, registry) for i in range(n)]
    for a in replicas:
        for b in replicas:
            if a is not b:
                a.transport.connect(b.node.config.id, b.transport.address)
    for replica in replicas:
        replica.start()
    return replicas


def _converge(replicas, expected, what):
    """A replica that fell behind may adopt a peer checkpoint by state
    transfer, so the skipped requests land in its app state without
    commit events: the gate is one chain across all, with at least one
    replica having observed every commit directly."""
    deadline = time.monotonic() + 120
    while True:
        full = [
            r for r in replicas
            if expected <= {(c, n) for c, n in r.app_log.commits}
        ]
        chains = {r.app_log.chain for r in replicas}
        if full and len(chains) == 1 and b"" not in chains:
            return
        assert time.monotonic() < deadline, (
            f"no convergence {what}: "
            f"{[len(set(r.app_log.commits)) for r in replicas]} commits, "
            f"{len(chains)} chains; "
            f"exits={[r.node.exit_error for r in replicas]}"
        )
        time.sleep(0.05)


def test_four_node_consensus_over_tcp(pkg):
    pb = pkg.pb
    replicas = _mesh(pkg)
    try:
        requests = [
            pb.Request(client_id=9, req_no=i, data=b"%d" % i)
            for i in range(12)
        ]
        for request in requests[:6]:
            for replica in replicas:
                replica.node.propose(request)

        # Mid-run teardown of one node's outbound connections: the frames
        # in flight die with the sockets; retransmission must recover.
        time.sleep(0.3)
        with replicas[0].transport._lock:
            conns = [c for c, _lock in replicas[0].transport._conns.values()]
            replicas[0].transport._conns.clear()
        for conn in conns:
            conn.close()

        for request in requests[6:]:
            for replica in replicas:
                replica.node.propose(request)
        _converge(replicas, {(9, r.req_no) for r in requests}, "")
        for replica in replicas:
            assert len(replica.app_log.commits) == len(
                set(replica.app_log.commits)
            ), "duplicate commit!"
    finally:
        for replica in replicas:
            replica.stop()
    assert all(r.node.exit_error is None for r in replicas)


# -- tests/test_transport.py: failure paths --------------------------------------


def _rebind(pkg, node_id, addr, timeout=10.0):
    """Re-create a transport on a just-closed address (the OS may hold the
    port briefly; retry until it frees)."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            return pkg.runtime.TcpTransport(node_id, host=addr[0],
                                            port=addr[1])
        except OSError:
            if time.monotonic() >= deadline:
                raise
            time.sleep(0.1)


def _suspect(pkg, epoch):
    return pkg.pb.Msg(type=pkg.pb.Suspect(epoch=epoch))


def _wait(cond, seconds=5.0):
    deadline = time.monotonic() + seconds
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)


def test_send_to_down_peer_drops_silently(pkg):
    """A send to a registered peer with nothing listening is dropped (the
    Link contract is fire-and-forget; retransmit ticks recover)."""
    t = pkg.runtime.TcpTransport(0)
    # A bound-but-not-listening port refuses connections deterministically
    # (a freed ephemeral port can be self-connected to on localhost).
    dead = socketlib.socket()
    dead.bind(("127.0.0.1", 0))
    dead_addr = dead.getsockname()
    try:
        t.connect(1, dead_addr)
        t.link().send(1, _suspect(pkg, 3))  # must not raise
        assert 1 not in t._conns  # no connection was cached
    finally:
        dead.close()
        t.close()


class _Sink:
    def __init__(self, record=lambda source, msg: (source, type(msg.type).__name__)):
        self.received = []
        self._record = record

    def step(self, source, msg):
        self.received.append(self._record(source, msg))


def test_peer_death_mid_stream_and_reconnect(pkg):
    """Killing the receiving transport mid-stream drops frames; a new
    transport on the same port is reconnected to lazily and receives."""
    sink = _Sink()
    received = sink.received
    sender = pkg.runtime.TcpTransport(0)
    receiver = pkg.runtime.TcpTransport(1)
    try:
        sender.connect(1, receiver.address)
        receiver.serve(sink)
        sender.link().send(1, _suspect(pkg, 1))
        _wait(lambda: received)
        assert received == [(0, "Suspect")]

        # Peer dies: the established connection breaks.  Sends during the
        # outage drop (possibly after one failed write flushes the stale
        # connection).
        addr = receiver.address
        receiver.close()
        time.sleep(0.05)
        for _ in range(3):
            sender.link().send(1, _suspect(pkg, 2))
            time.sleep(0.02)

        # Peer restarts on the same address: the next send reconnects.
        receiver = _rebind(pkg, 1, addr)
        receiver.serve(sink)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            sender.link().send(1, _suspect(pkg, 9))
            if len(received) > 1:
                break
            time.sleep(0.05)
        assert len(received) > 1, "no delivery after peer restart"
    finally:
        sender.close()
        receiver.close()


def test_no_delivery_after_close(pkg):
    """A frame sent after close() must NOT reach the sink: close() tears
    down accepted inbound connections and delivery gates on the closed
    flag, so a "dead" replica cannot keep consuming messages."""
    sink = _Sink()
    received = sink.received
    sender = pkg.runtime.TcpTransport(0)
    receiver = pkg.runtime.TcpTransport(1)
    try:
        sender.connect(1, receiver.address)
        receiver.serve(sink)
        sender.link().send(1, _suspect(pkg, 1))
        _wait(lambda: received)
        assert received == [(0, "Suspect")]

        receiver.close()
        # The sender still holds an ESTABLISHED connection; with a leak,
        # these frames would arrive at the closed receiver's sink.
        for _ in range(5):
            sender.link().send(1, _suspect(pkg, 2))
            time.sleep(0.02)
        time.sleep(0.2)
        assert received == [(0, "Suspect")], (
            f"closed transport delivered frames: {received[1:]}"
        )
        # And the receiver's read threads actually exited (close() clears
        # _accepted itself, so inspect the threads, not the set).
        readers = []

        def gone():
            readers[:] = [
                t for t in threading.enumerate()
                if t.name == "tcp-read-1" and t.is_alive()
            ]
            return not readers

        _wait(gone)
        assert not readers, "read threads still blocked in recv after close()"
    finally:
        sender.close()
        receiver.close()


def test_partial_and_corrupt_frames(pkg):
    """Dribbled frames are reassembled; truncated frames die with their
    connection; oversized or zero length headers drop the connection; a
    well-formed frame with garbage payload is dropped without crashing."""
    pb, wire = pkg.pb, pkg.wire
    sink = _Sink()
    received = sink.received
    t = pkg.runtime.TcpTransport(7)
    t.serve(sink)
    try:
        payload = wire.encode_varint(3) + pb.encode(
            pb.Msg(type=pb.Suspect(epoch=5))
        )
        other = _other(pkg)
        assert payload == other.wire.encode_varint(3) + other.pb.encode(
            other.pb.Msg(type=other.pb.Suspect(epoch=5)))
        frame = struct.pack("<I", len(payload)) + payload

        # 1. One byte at a time: must reassemble.
        s = socketlib.create_connection(t.address)
        for b in frame:
            s.sendall(bytes([b]))
            time.sleep(0.001)
        _wait(lambda: received)
        assert received == [(3, "Suspect")]

        # 2. Truncated frame then close: dropped, no delivery, no crash.
        s2 = socketlib.create_connection(t.address)
        s2.sendall(frame[: len(frame) // 2])
        s2.close()

        # 3. Oversized length header: connection dropped immediately.
        s3 = socketlib.create_connection(t.address)
        s3.sendall(struct.pack("<I", 1 << 31))
        # 4. Garbage payload in a well-formed frame: dropped.
        s4 = socketlib.create_connection(t.address)
        junk = b"\xff" * 40
        s4.sendall(struct.pack("<I", len(junk)) + junk)
        time.sleep(0.2)
        assert received == [(3, "Suspect")]  # nothing else got through

        # The transport still works after all of that.
        s5 = socketlib.create_connection(t.address)
        s5.sendall(frame)
        _wait(lambda: len(received) >= 2)
        assert received[-1] == (3, "Suspect")
        for sock in (s, s3, s4, s5):
            sock.close()
    finally:
        t.close()


def test_reconnect_backoff_resumes_delivery_without_redial(pkg):
    """Kill a peer's listener mid-stream, keep sending, restart the
    listener: the sender's per-peer channel retries with backoff and the
    queued frames arrive WITHOUT any further send() calls."""
    sink = _Sink(lambda source, msg: msg.type.epoch)
    received = sink.received
    sender = pkg.runtime.TcpTransport(0, backoff_base=0.02, backoff_cap=0.2)
    receiver = pkg.runtime.TcpTransport(1)
    try:
        sender.connect(1, receiver.address)
        receiver.serve(sink)
        sender.link().send(1, _suspect(pkg, 0))
        _wait(lambda: received)
        assert received == [0]

        # Listener dies.  Frames sent during the outage queue on the
        # sender's channel while it re-dials with backoff.
        addr = receiver.address
        receiver.close()
        time.sleep(0.05)
        for epoch in range(1, 6):
            sender.link().send(1, _suspect(pkg, epoch))
        time.sleep(0.3)  # several failed dial attempts accumulate
        counters = sender.counters()["peers"][1]
        assert counters["connect_failures"] + counters["send_failures"] > 0

        # Listener restarts on the same address.  NO further sends: the
        # still-queued frames must flush via the channel's own reconnect.
        receiver = _rebind(pkg, 1, addr)
        receiver.serve(sink)
        _wait(lambda: 5 in received, 10.0)
        assert 5 in received, (
            f"queued frames not redelivered after restart: {received}"
        )
        assert received == sorted(received), f"reordered: {received}"
        counters = sender.counters()["peers"][1]
        assert counters["connects"] >= 2, "no automatic re-dial happened"
    finally:
        sender.close()
        receiver.close()


def test_outbound_queue_overflow_drops_oldest_with_accounting(pkg):
    """A peer that is down long enough overflows its bounded queue; the
    oldest frames drop and the drop counter reflects exactly how many."""
    sender = pkg.runtime.TcpTransport(0, queue_depth=4, backoff_base=0.05)
    dead = socketlib.socket()
    dead.bind(("127.0.0.1", 0))
    try:
        sender.connect(1, dead.getsockname())
        for epoch in range(10):
            sender.link().send(1, _suspect(pkg, epoch))

        def overflowed():
            c = sender.counters()["peers"][1]
            return c["enqueued"] == 10 and c["dropped_overflow"] >= 5

        _wait(overflowed)
        c = sender.counters()["peers"][1]
        assert c["enqueued"] == 10
        # Depth 4 of 10: at least 5 oldest frames dropped (6 unless the
        # sender thread had already popped one into flight).
        assert c["dropped_overflow"] in (5, 6)
        assert c["queue_depth"] <= 4 and c["sent"] == 0
    finally:
        dead.close()
        sender.close()


def test_consensus_survives_transport_kill_and_restore(pkg):
    """A replica's entire transport dies mid-run and is replaced (same
    port); the network keeps committing and the revived replica
    converges."""
    pb = pkg.pb
    replicas = _mesh(pkg)
    try:
        requests = [
            pb.Request(client_id=9, req_no=i, data=b"%d" % i)
            for i in range(10)
        ]
        for request in requests[:5]:
            for replica in replicas:
                replica.node.propose(request)
        time.sleep(0.3)

        # Node 3's transport dies wholesale and is replaced on the same
        # port; peers reconnect lazily on their next sends.
        victim = replicas[3]
        addr = victim.transport.address
        victim.transport.close()
        time.sleep(0.1)
        victim.transport = _rebind(pkg, 3, addr)
        victim.transport.serve(victim.node)
        for b in replicas:
            if b is not victim:
                victim.transport.connect(b.node.config.id, b.transport.address)
        # The processor holds the old link object; swap in the new one.
        victim.processor.link = victim.transport.link()

        for request in requests[5:]:
            for replica in replicas:
                replica.node.propose(request)
        _converge(replicas, {(9, r.req_no) for r in requests},
                  "after transport restore")
    finally:
        for replica in replicas:
            replica.stop()
    assert all(r.node.exit_error is None for r in replicas)


def test_dial_timeout_bounds_blackholed_connects(pkg, monkeypatch):
    """A peer that black-holes SYNs must not pin the sender thread: every
    dial attempt carries the transport's ``dial_timeout`` and a
    TimeoutError walks the normal backoff."""
    seen_timeouts = []

    def _blackhole(address, timeout=None, **_kw):
        seen_timeouts.append(timeout)
        raise TimeoutError("SYN black-holed")

    sender = pkg.runtime.TcpTransport(0, dial_timeout=0.123,
                                      backoff_base=0.01, backoff_cap=0.05)
    try:
        monkeypatch.setattr(
            pkg.transport.socket, "create_connection", _blackhole
        )
        sender.connect(1, ("127.0.0.1", 1))
        sender.link().send(1, _suspect(pkg, 0))
        _wait(lambda: sender.counters()["peers"].get(1, {}).get(
            "connect_failures", 0) >= 2)
        assert sender.counters()["peers"][1]["connect_failures"] >= 2
        assert seen_timeouts and all(t == 0.123 for t in seen_timeouts)
    finally:
        monkeypatch.undo()
        sender.close()


def test_transport_fault_seam_injects_send_and_dial_loss(pkg):
    """on_send=False frames vanish with ``dropped_fault`` accounting,
    on_dial=False fails dials into the ordinary backoff path, and clearing
    the fault restores delivery with no other intervention."""
    fault = pkg.transport.TransportFault

    class _DropSends(fault):
        def on_send(self, peer_id, frame):
            return False

    class _FailDials(fault):
        def on_dial(self, peer_id):
            return False

    sink = _Sink(lambda source, msg: msg.type.epoch)
    received = sink.received
    sender = pkg.runtime.TcpTransport(0, backoff_base=0.01, backoff_cap=0.05)
    receiver = pkg.runtime.TcpTransport(1)
    try:
        sender.connect(1, receiver.address)
        receiver.serve(sink)

        sender.fault = _DropSends()
        for epoch in range(3):
            sender.link().send(1, _suspect(pkg, epoch))
        assert sender.counters()["dropped_fault"] == 3
        time.sleep(0.1)
        assert received == []

        # Dial faults: the frame enqueues but no connection can form.
        sender.fault = _FailDials()
        sender.link().send(1, _suspect(pkg, 7))
        _wait(lambda: sender.counters()["peers"][1]["connect_failures"] >= 2)
        assert sender.counters()["peers"][1]["connect_failures"] >= 2
        assert received == []

        # Fault cleared: the queued frame flushes via the normal re-dial.
        sender.fault = None
        _wait(lambda: received == [7])
        assert received == [7]
    finally:
        sender.close()
        receiver.close()


def test_clock_sync_hello_records_offset(pkg):
    """The first frame on a fresh dial is the clock-sync hello: the
    receiver learns the dialer's monotonic anchor and exposes the
    (local - peer) offset, bounded by the hello's in-flight latency."""
    sink = _Sink()
    received = sink.received
    sender = pkg.runtime.TcpTransport(0)
    receiver = pkg.runtime.TcpTransport(1)
    try:
        sender.connect(1, receiver.address)
        receiver.serve(sink)
        sender.link().send(1, _suspect(pkg, 1))
        _wait(lambda: received)
        # The hello is transparent to the protocol stream...
        assert received == [(0, "Suspect")]
        # ...but the receiver learned the dialer's clock offset.
        _wait(lambda: 0 in receiver.clock_offsets())
        offsets = receiver.clock_offsets()
        assert 0 in offsets, "no clock offset learned from hello"
        assert 0 <= offsets[0] < 1_000_000_000
        # The sender never dialed back, so it learned nothing.
        assert receiver.node_id not in sender.clock_offsets()
    finally:
        sender.close()
        receiver.close()


def test_nodelay_set_on_both_directions_of_established_pair(pkg):
    """TCP_NODELAY must hold on the dialed socket AND the accepted one:
    Nagle is per-direction."""
    sink = _Sink()
    sender = pkg.runtime.TcpTransport(0)
    receiver = pkg.runtime.TcpTransport(1)
    try:
        receiver.serve(sink)
        sender.connect(1, receiver.address)
        sender.link().send(1, _suspect(pkg, 1))
        _wait(lambda: 1 in sender._conns and receiver._accepted)
        assert 1 in sender._conns, "dial never completed"
        assert receiver._accepted, "accept never completed"

        dialed, _lock = sender._conns[1]
        accepted = next(iter(receiver._accepted))
        for sock, which in ((dialed, "dialed"), (accepted, "accepted")):
            assert (
                sock.getsockopt(socketlib.IPPROTO_TCP, socketlib.TCP_NODELAY)
                != 0
            ), f"TCP_NODELAY not set on the {which} socket"
    finally:
        sender.close()
        receiver.close()


def test_frame_encoder_scratch_matches_naive_encoding(pkg):
    """The bytearray-scratch frame encoder emits byte-identical frames to
    the naive two-allocation spelling, and to the other package's."""
    other = _other(pkg)
    t = pkg.runtime.TcpTransport(0)
    u = other.runtime.TcpTransport(0)
    try:
        _len = struct.Struct("<I")  # must match transport._LEN
        for e in range(8):
            msg = _suspect(pkg, e)
            payload = t._src_prefix + pkg.pb.encode(msg)
            naive = _len.pack(len(payload)) + payload
            assert t._encode_frame(msg) == naive
            assert u._encode_frame(_suspect(other, e)) == naive
            # The scratch is reused: a second encode is the same bytes.
            assert t._encode_frame(msg) == naive
    finally:
        t.close()
        u.close()
