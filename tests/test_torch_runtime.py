"""The port's live node held against the JAX package's.

Real serializer threads, real files, an in-process transport (the six
processor kinds of tests/test_runtime.py::test_four_node_runtime, the
``cuda*`` kinds on the kernel's plain version) and real TCP (a mixed
cluster of two JAX nodes and two port nodes), with state transfer served
by each package's TransferEngine.  Also: the ``Cuda*``
processors' digests against the host kinds', the pipelined persist→send
barrier and group commit (mirroring tests/test_pipeline.py), and the WAL
and request store read across packages byte for byte."""

import dataclasses
import hashlib
import queue
import threading
import time

import pytest

from mirbft_tpu import pb as jax_pb
from mirbft_tpu.core.preimage import host_digest
from mirbft_tpu.runtime import Config as JaxConfig
from mirbft_tpu.runtime import FileRequestStore as JaxRequestStore
from mirbft_tpu.runtime import FileWal as JaxWal
from mirbft_tpu.runtime import Node as JaxNode
from mirbft_tpu.runtime import SerialProcessor as JaxSerialProcessor
from mirbft_tpu.runtime import TcpTransport as JaxTcpTransport
from mirbft_tpu.runtime.node import (
    standard_initial_network_state as jax_initial_state,
)
from mirbft_tpu.runtime.transfer import TransferEngine as JaxTransferEngine
from mirbft_tpu_torch import bench, pb
from mirbft_tpu_torch.core import actions as act
from mirbft_tpu_torch.runtime import (
    PROCESSOR_KINDS,
    Config,
    CudaPipelinedProcessor,
    CudaProcessor,
    FileRequestStore,
    FileWal,
    Node,
    PipelinedProcessor,
    SerialProcessor,
    TcpTransport,
    build_processor,
)
from mirbft_tpu_torch.runtime.node import (
    NodeStopped,
    standard_initial_network_state,
)
from mirbft_tpu_torch.runtime.processor import (
    AUDIT_PER_SHAPE,
    Link,
    Log,
    ProcessorClosed,
    _CudaHashMixin,
)
from mirbft_tpu_torch.runtime.transfer import TransferEngine

KINDS = ["serial", "cuda", "pool", "cuda-pool", "pipelined", "cuda-pipelined"]
CUDA_KINDS = [k for k in KINDS if k.startswith("cuda")]


# -- harness (tests/test_runtime.py's, on the port) ---------------------------


class ThreadTransport:
    """Channel-matrix fake transport (reference: stress_test.go:68-151)."""

    def __init__(self):
        self.nodes = {}
        self.engines = {}
        self.lock = threading.Lock()

    def register(self, node_id, node, engine=None):
        with self.lock:
            self.nodes[node_id] = node
            self.engines[node_id] = engine

    def unregister(self, node_id):
        with self.lock:
            self.nodes.pop(node_id, None)
            self.engines.pop(node_id, None)

    def duct(self, source: int):
        """The transfer frames' path: send == the dest engine's
        on_frame (TransferEngine sends with its lock released)."""
        transport = self

        class _Duct:
            def send(self, dest, body):
                with transport.lock:
                    engine = transport.engines.get(dest)
                if engine is not None:
                    engine.on_frame(source, body)

        return _Duct()

    def link(self, source: int) -> Link:
        transport = self

        class _Link(Link):
            def send(self, dest, msg):
                with transport.lock:
                    node = transport.nodes.get(dest)
                if node is None:
                    return
                try:
                    node.step(source, msg)
                except NodeStopped:
                    pass

        return _Link()


class HashChainLog(Log):
    def __init__(self):
        self.chain = b""
        self.commits = []  # [(client_id, req_no, seq_no)]
        self.commit_events = queue.Queue()
        self.adopted = None  # seq_no of a peer checkpoint installed

    def apply(self, q_entry):
        for ack in q_entry.requests:
            h = hashlib.sha256()
            h.update(self.chain)
            h.update(ack.digest)
            self.chain = h.digest()
            self.commits.append((ack.client_id, ack.req_no, q_entry.seq_no))
            self.commit_events.put((ack.client_id, ack.req_no))

    def snap(self, network_config, clients_state):
        return self.chain


class _TcpDuct:
    """TransferEngine frames over a TcpTransport's transfer lane."""

    def __init__(self, transport):
        self.transport = transport

    def send(self, dest, body):
        self.transport.send_transfer(dest, body)


class Replica:
    """One node: serializer + consumer loop thread + storage.  The consumer
    counts the hash requests it hands to the processor and serves state
    transfer through its package's TransferEngine over ``duct``: every
    stable checkpoint is noted as a servable snapshot, and a node that
    falls behind its peers' stable checkpoint fetches one from them and
    adopts it (the reference consumer's job, mirbft.go:426-459)."""

    def __init__(self, node_id, link, tmp_path, state, node_cls=Node,
                 config=None, processor=None, tick_seconds=0.05, peers=(),
                 duct=None):
        self.node_id = node_id
        self.peers = peers
        self.pb = pb if node_cls is Node else jax_pb
        self.checkpoints = {}  # seq_no -> (value, NetworkState)
        self.dir = tmp_path / f"node{node_id}"
        self.tick_seconds = tick_seconds
        self.app_log = HashChainLog()
        self.wal_cls = FileWal if node_cls is Node else JaxWal
        self.wal = self.wal_cls(str(self.dir / "wal"))
        store_cls = FileRequestStore if node_cls is Node else JaxRequestStore
        self.reqstore = store_cls(str(self.dir / "reqs"))
        self.node = node_cls.start_new(config, state)
        self.link = link
        engine_cls = TransferEngine if node_cls is Node else JaxTransferEngine
        self.engine = engine_cls(
            node_id,
            duct,
            staging_dir=str(self.dir),
            peers=list(state.config.nodes),
            limits=config,
            install=self._install_snapshot,
            complete=self.node.state_transfer_complete,
            failed=self.node.state_transfer_failed,
            chunk_timeout_s=0.25,
        )
        self.processor = processor(self)
        if hasattr(self.processor, "on_results"):
            self.processor.on_results = self._capture_checkpoints
        self.hash_requests = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._consume, name=f"consumer-{node_id}", daemon=True
        )
        self._thread.start()

    def _capture_checkpoints(self, results):
        for cr in results.checkpoints:
            seq_no = cr.checkpoint.seq_no
            if seq_no in self.checkpoints:
                continue  # the pipelined kinds report through both paths
            state = self.pb.NetworkState(
                config=cr.checkpoint.network_config,
                clients=cr.checkpoint.clients_state,
                pending_reconfigurations=list(cr.reconfigurations),
            )
            self.checkpoints[seq_no] = (cr.value, state)
            requests = []
            self.reqstore.uncommitted(
                lambda ack: requests.append((ack, self.reqstore.get(ack)))
            )
            # The app state is the hash chain, which the checkpoint value
            # is: the snapshot carries it as its app bytes.
            self.engine.note_checkpoint(
                seq_no, cr.value, state, cr.value, requests
            )

    def _install_snapshot(self, snap):
        """TransferEngine install callback: adopt the app state (the
        chain, certified as the checkpoint value) and the donor's
        uncommitted-request slice; the node then persists the CEntry."""
        if snap.app_bytes != snap.value:
            return None
        self.app_log.chain = snap.value
        self.app_log.adopted = snap.seq_no
        for ack, data in snap.requests:
            self.reqstore.store(ack, data)
        return snap.network_state

    def _consume(self):
        last_tick = time.monotonic()
        while not self._stop.is_set():
            actions = self.node.ready(timeout=0.01)
            if actions is not None:
                self.hash_requests += len(actions.hashes)
                results = self.processor.process(actions)
                self._capture_checkpoints(results)
                if results.digests or results.checkpoints:
                    try:
                        self.node.add_results(results)
                    except Exception:  # either package's NodeStopped
                        return
            now = time.monotonic()
            if now - last_tick >= self.tick_seconds:
                last_tick = now
                try:
                    self.node.tick()
                except Exception:
                    return
            try:
                if actions is not None and actions.state_transfer is not None:
                    self.engine.begin(actions.state_transfer)
                self.engine.poll()
            except Exception:  # either package's NodeStopped
                return

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)
        self.node.stop()
        if hasattr(self.processor, "close"):
            self.processor.close()
        self.wal.close()
        self.reqstore.close()


def await_commits(replicas, expected, timeout=120.0):
    """Wait until every replica has committed all of ``expected``, or has
    installed a peer's checkpoint by state transfer and reached the chain
    of a replica that committed them all (a node that falls behind adopts
    the requests below the checkpoint in the snapshot)."""
    deadline = time.monotonic() + timeout
    got = {r.node_id: set() for r in replicas}
    while True:
        for replica in replicas:
            while True:
                try:
                    got[replica.node_id].add(
                        replica.app_log.commit_events.get_nowait()
                    )
                except queue.Empty:
                    break
        full = {r.app_log.chain for r in replicas if expected <= got[r.node_id]}
        if full and all(
            expected <= got[r.node_id]
            or (r.app_log.adopted is not None and r.app_log.chain in full)
            for r in replicas
        ):
            return
        assert time.monotonic() < deadline, (
            "timed out: commits per node "
            f"{ {n: len(g & expected) for n, g in got.items()} } of "
            f"{len(expected)}; adopted "
            f"{[r.app_log.adopted for r in replicas]}; exits "
            f"{[r.node.exit_error for r in replicas]}"
        )
        time.sleep(0.01)


def make_requests(module_pb, client_id, count):
    return [
        module_pb.Request(client_id=client_id, req_no=r, data=b"%d" % r)
        for r in range(count)
    ]


def assert_exactly_once_and_one_chain(replicas):
    for replica in replicas:
        commits = [(c, r) for c, r, _s in replica.app_log.commits]
        assert len(commits) == len(set(commits)), "duplicate commit!"
    assert len({r.app_log.chain for r in replicas}) == 1


# -- four nodes, six kinds ----------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_four_node_runtime(tmp_path, kind):
    """4-node exactly-once commitment with agreeing chains under each kind;
    the cuda kinds send every digest of the run to the kernel's plain
    version (device='cpu'), none to hashlib."""
    transport = ThreadTransport()
    state = standard_initial_network_state(4, [7, 8])
    replicas = []
    try:
        for i in range(4):
            replica = Replica(
                i, transport.link(i), tmp_path, state, peers=replicas,
                config=Config(id=i, processor=kind),
                processor=lambda r: build_processor(
                    r.node, r.link, r.app_log, r.wal, r.reqstore,
                    device="cpu",
                ),
                duct=transport.duct(i),
            )
            transport.register(i, replica.node, replica.engine)
            replicas.append(replica)
        requests = make_requests(pb, 7, 10) + make_requests(pb, 8, 10)
        for request in requests:
            for replica in replicas:
                replica.node.propose(request)
        await_commits(replicas, {(r.client_id, r.req_no) for r in requests})
        assert_exactly_once_and_one_chain(replicas)
    finally:
        for replica in replicas:
            transport.unregister(replica.node_id)
            replica.stop()
    assert all(r.node.exit_error is None for r in replicas)
    for replica in replicas:
        proc = replica.processor
        assert type(proc) is PROCESSOR_KINDS[kind]
        if kind in CUDA_KINDS:
            assert proc.host_digests == 0
            assert proc.device_digests == replica.hash_requests > 0
            assert proc.launches > 0 and proc.kernel_ms == 0.0
            assert proc.device.type == "cpu"


def test_held_node_catches_up_through_the_transfer_engine(tmp_path):
    """Node 3's inbound frames are held (bench's harness wrapper) while
    the others commit until their low watermarks are two checkpoint
    intervals past it; released, it fetches a snapshot from them through
    TransferEngine over the in-process duct, installs it, and reaches
    their chain."""
    transport = ThreadTransport()
    state = standard_initial_network_state(4, [7, 8])
    interval = state.config.checkpoint_interval
    replicas = []
    try:
        for i in range(4):
            replica = Replica(
                i, transport.link(i), tmp_path, state, peers=replicas,
                config=Config(id=i, processor="cuda"),
                processor=lambda r: build_processor(
                    r.node, r.link, r.app_log, r.wal, r.reqstore,
                    device="cpu",
                ),
                duct=transport.duct(i),
            )
            transport.register(i, replica.node, replica.engine)
            replicas.append(replica)
        held = bench._HeldInbound(replicas[3].node)
        target = 2 * interval
        requests = make_requests(pb, 7, 3 * interval)
        for request in requests:
            for replica in replicas:
                replica.node.propose(request)
        deadline = time.monotonic() + 60.0
        while min(
            r.node.status(timeout=5.0).low_watermark for r in replicas[:3]
        ) < target:
            assert time.monotonic() < deadline, "the others stalled"
            time.sleep(0.05)
        assert replicas[3].node.status(timeout=5.0).low_watermark == 0
        assert held.release() > 0
        await_commits(replicas, {(r.client_id, r.req_no) for r in requests})
        assert replicas[3].engine.counters["snapshots_installed"] >= 1
        assert replicas[3].engine.counters["chunks_rejected_corrupt"] == 0
        assert replicas[3].app_log.adopted is not None
        assert_exactly_once_and_one_chain(replicas)
    finally:
        for replica in replicas:
            transport.unregister(replica.node_id)
            replica.stop()
    assert all(r.node.exit_error is None for r in replicas)


def _hash_actions(n=7):
    actions = act.Actions()
    actions.hashes = [
        act.HashRequest(
            data=[b"chunk-a-%d" % i, b"chunk-b", bytes([i]) * (i + 1) * 9],
            origin=pb.HashResult(digest=b"", type=pb.HashOriginRequest()),
        )
        for i in range(n)
    ]
    return actions


@pytest.mark.parametrize("kind", CUDA_KINDS)
def test_cuda_processor_and_serial_agree_on_a_hash_batch(kind):
    """The same hash batch through a Cuda* processor's launch and a
    SerialProcessor's hashlib gives equal digests, equal to the JAX
    package's host digest (tests/test_runtime.py:337)."""
    actions = _hash_actions()
    proc = PROCESSOR_KINDS[kind].__new__(PROCESSOR_KINDS[kind])
    proc._init_device("cpu")
    serial = SerialProcessor.__new__(SerialProcessor)
    host = serial._hash(actions)
    pending = proc._dispatch_device(actions.hashes)
    device = proc._collect_device(actions.hashes, pending)
    inline = proc._hash(actions)
    assert [r.digest for r in device] == [r.digest for r in host]
    assert [r.digest for r in inline] == [r.digest for r in host]
    assert [r.request for r in device] == actions.hashes
    assert host[3].digest == host_digest(actions.hashes[3].data)
    assert proc.launches == 2 and proc.device_digests == 14
    assert proc.host_digests == 0


def test_build_processor_kinds_and_tpu_names(tmp_path):
    class _Node:
        config = Config(id=0)

    wal, store = FileWal(str(tmp_path / "w")), FileRequestStore(
        str(tmp_path / "r")
    )
    try:
        assert Config(id=0).processor == "cuda"
        proc = build_processor(_Node(), None, None, wal, store, device="cpu")
        assert type(proc).__name__ == "CudaProcessor"
        for tpu, cuda in (("tpu", "cuda"), ("tpu-pool", "cuda-pool"),
                          ("tpu-pipelined", "cuda-pipelined")):
            with pytest.raises(ValueError, match=repr(cuda)):
                build_processor(_Node(), None, None, wal, store, kind=tpu)
            with pytest.raises(ValueError, match=repr(cuda)):
                Config(id=0, processor=tpu)
        with pytest.raises(ValueError, match="unknown processor kind"):
            build_processor(_Node(), None, None, wal, store, kind="gpu")
        assert set(PROCESSOR_KINDS) == set(KINDS)
    finally:
        wal.close()
        store.close()


def test_metrics_port_serves_the_exporter():
    """``Config.metrics_port=0`` starts the exporter on an ephemeral port:
    ``/metrics``, ``/status``, ``/healthz`` and a 404 answer as the JAX
    node's do, and ``stop()`` closes the socket."""
    import json
    import socket
    import urllib.error
    import urllib.request

    from mirbft_tpu_torch.obsv import hooks as port_hooks

    def get(path):
        try:
            with urllib.request.urlopen(f"http://{host}:{port}{path}",
                                        timeout=5) as resp:
                return resp.status, resp.read().decode("utf-8")
        except urllib.error.HTTPError as err:
            return err.code, ""

    metrics, _ = port_hooks.enable()
    node = None
    try:
        metrics.counter("mirbft_wal_appends_total").inc(3)
        node = Node.start_new(Config(id=0, metrics_port=0),
                              standard_initial_network_state(1, [0]))
        host, port = node.metrics_address
        code, text = get("/metrics")
        assert code == 200 and "mirbft_wal_appends_total 3" in text
        code, text = get("/status")
        assert code == 200 and json.loads(text)
        code, text = get("/healthz")
        assert code == 200
        assert json.loads(text) == {"ok": True, "ready": True, "node_id": 0}
        assert get("/nope")[0] == 404
    finally:
        port_hooks.disable()
        if node is not None:
            node.stop()
    with pytest.raises(OSError):
        socket.create_connection((host, port), timeout=1).close()


def test_status_endpoint_answers_ahead_of_a_backlog():
    """ROADMAP queue 3: a node's ``/status`` (``_status_json``, what the
    exporter calls) with 3 s of events queued ahead of it.  The JAX node
    puts the ask at the back of the serializer's inbox and gives up after
    its 2-s deadline (None, the exporter's 503), as a live node did in the
    start burst of the traced live rung on the card; the port's node
    answers before the serializer's next item."""
    def ask_behind_a_backlog(node_cls, config_cls, initial_state):
        slow = threading.Event()

        def interceptor(_event):
            if slow.is_set():
                time.sleep(0.02)

        node = node_cls.start_new(
            config_cls(id=0, event_interceptor=interceptor),
            initial_state(1, [0]),
        )
        try:
            assert node.status(timeout=5.0) is not None  # initialised
            slow.set()
            for _ in range(150):  # 150 events x 20 ms
                node.tick()
            began = time.perf_counter()
            answer = node._status_json()
            return answer, time.perf_counter() - began
        finally:
            slow.clear()
            node.stop()

    jax_answer, jax_s = ask_behind_a_backlog(
        JaxNode, JaxConfig, jax_initial_state)
    answer, port_s = ask_behind_a_backlog(
        Node, Config, standard_initial_network_state)
    assert jax_answer is None and jax_s >= 2.0
    assert answer is not None and port_s < 1.0, port_s


def test_shadow_stride_wires_the_divergence_oracle():
    """With hooks on, Config.shadow_stride installs a ShadowSampler at that
    stride (as the JAX package's Node does), and audit_divergence runs the
    oracle on the serializer thread: a fresh node has nothing to diverge."""
    from mirbft_tpu_torch.obsv import hooks
    from mirbft_tpu_torch.obsv.shadow import ShadowSampler

    hooks.enable()
    try:
        node = Node.start_new(
            Config(id=0, shadow_stride=4), standard_initial_network_state(1, [1])
        )
        try:
            assert isinstance(hooks.shadow, ShadowSampler)
            assert hooks.shadow.stride == 4
            assert node.audit_divergence() == []
        finally:
            node.stop()
        assert node.audit_divergence() is None  # stopped
    finally:
        hooks.disable()


def test_node_on_the_device_plane_audits_clean():
    """Config.ack_plane and Config.ack_device reach the node's tracker (the
    device plane, on the plain versions), and the oracle, run on the
    serializer, finds the tracker consistent.  The serializer makes the
    tracker when it initialises the node, so the tracker is read only
    after the audit's answer: in a fresh process that initialisation
    first imports the device plane's modules, and the test thread would
    read the tracker before it exists."""
    node = Node.start_new(
        Config(id=0, ack_plane="device", ack_device="cpu"),
        standard_initial_network_state(1, [1]),
    )
    try:
        assert node.audit_divergence(timeout=60.0) == []
        tracker = node._machine.client_tracker
        assert tracker._ack_plane == "device" and tracker._device_ok
    finally:
        node.stop()


def test_attach_app_returns_the_commit_stream():
    """Node.attach_app (ported with app/stream.py) registers the app behind
    a CommitStream and app_status reads its frontier; stopping the node
    closes the stream."""
    from mirbft_tpu_torch.app import CommitStream, KvStore

    node = Node.start_new(Config(id=0), standard_initial_network_state(1, [1]))
    try:
        assert node.app_status() is None
        stream = node.attach_app(KvStore(), queue_depth=16)
        assert isinstance(stream, CommitStream) and node.app_stream is stream
        status = node.app_status()
        assert status["applied_index"] == 0 and status["queue_depth"] == 16
    finally:
        node.stop()


# -- a mixed cluster over TCP -------------------------------------------------


class LateDigests:
    """A processor wrapper that hands its node the digests ``delay_s``
    late, from a timer thread, as a slow hash on a live node would: the
    peers' Prepares and the owner's Commit come in first."""

    def __init__(self, inner, node, delay_s):
        self.inner = inner
        self.node = node
        self.delay_s = delay_s

    def process(self, actions):
        results = self.inner.process(actions)
        if results.digests:
            timer = threading.Timer(
                self.delay_s, self._deliver, args=(results.digests,)
            )
            timer.daemon = True
            timer.start()
        return act.ActionResults(digests=[], checkpoints=results.checkpoints)

    def _deliver(self, digests):
        try:
            self.node.add_results(act.ActionResults(digests=digests))
        except NodeStopped:
            pass

    def __getattr__(self, name):  # the inner processor's counters
        return getattr(self.inner, name)


LATE_S = 0.05  # past a loopback Commit round, short of a state transfer


def _run_mixed_cluster(tmp_path, late_node=None):
    """Nodes 0-1 the JAX package's (serial), nodes 2-3 the port's (cuda on
    the plain version), over TcpTransport; ``late_node`` (a port node)
    gets its digests ``LATE_S`` late.  Commits 2 clients x 8 requests through
    every node and returns the replicas once all are in."""
    clients = [7, 8]
    packages = {
        0: (JaxNode, JaxConfig, JaxTcpTransport, jax_pb,
            jax_initial_state(4, clients)),
        1: (JaxNode, JaxConfig, JaxTcpTransport, jax_pb,
            jax_initial_state(4, clients)),
        2: (Node, Config, TcpTransport, pb,
            standard_initial_network_state(4, clients)),
        3: (Node, Config, TcpTransport, pb,
            standard_initial_network_state(4, clients)),
    }
    transports, replicas = {}, []
    try:
        for i, (node_cls, config_cls, transport_cls, _pb, state) in (
            packages.items()
        ):
            transport = transport_cls(
                i, backoff_base=0.02, backoff_cap=0.25, dial_timeout=1.0
            )
            transports[i] = transport
            if node_cls is Node:
                config = config_cls(id=i, processor="cuda")

                def make(r, late=(i == late_node)):
                    proc = build_processor(
                        r.node, r.link, r.app_log, r.wal, r.reqstore,
                        device="cpu",
                    )
                    return LateDigests(proc, r.node, LATE_S) if late else proc
            else:
                config = config_cls(id=i, processor="serial")

                def make(r):
                    return JaxSerialProcessor(
                        r.node, r.link, r.app_log, r.wal, r.reqstore
                    )
            replica = Replica(
                i, transport.link(), tmp_path, state, node_cls=node_cls,
                config=config, processor=make, peers=replicas,
                duct=_TcpDuct(transport),
            )
            transport.set_transfer_sink(replica.engine.on_frame)
            transport.serve(replica.node)
            replicas.append(replica)
        for i in transports:
            for j in transports:
                if i != j:
                    transports[i].connect(j, transports[j].address)
        expected = set()
        for i, replica in enumerate(replicas):
            module_pb = packages[i][3]
            for client_id in clients:
                for request in make_requests(module_pb, client_id, 8):
                    replica.node.propose(request)
                    expected.add((client_id, request.req_no))
        await_commits(replicas, expected)
        assert_exactly_once_and_one_chain(replicas)
        seqs = {
            tuple(r.app_log.commits[: len(expected)])
            for r in replicas if r.app_log.adopted is None
        }
        assert len(seqs) == 1, "the packages committed different sequences"
    finally:
        for replica in replicas:
            replica.stop()
        for transport in transports.values():
            transport.close(0)
    assert all(r.node.exit_error is None for r in replicas)
    for port in (replicas[2].processor, replicas[3].processor):
        assert port.host_digests == 0 and port.device_digests > 0
    return replicas


def test_mixed_cluster_two_jax_nodes_two_port_nodes_over_tcp(tmp_path):
    """Over TcpTransport, nodes 0-1 are the JAX package's (serial) and
    nodes 2-3 the port's (cuda on the plain version): one request set
    commits exactly once everywhere with one chain, so the wire, the state
    machine and the storage agree across packages."""
    _run_mixed_cluster(tmp_path)


def test_mixed_cluster_with_a_port_follower_digest_late(tmp_path, monkeypatch):
    """The mixed cluster with port node 3's digests ``LATE_S`` late: its batch
    digests come in after the owner's Commit (the case where the JAX
    package's sequence stays READY, ROADMAP queue 3).  Node 3 prepares on
    each such digest, every node commits the one request set exactly once,
    and the chains agree."""
    from mirbft_tpu_torch.core import sequence as port_sequence

    late_digests = []  # (node, state after) of digests after the owner's vote
    original = port_sequence.Sequence.apply_batch_hash_result

    def watched(self, digest):
        owner_in = (
            self.owner != self.my_config.id
            and self.state == port_sequence.SeqState.READY
            and self._node_choice(self.owner).state
            > port_sequence._NodeState.UNINITIALIZED
        )
        actions = original(self, digest)
        if owner_in:
            late_digests.append((self.my_config.id, self.state))
        return actions

    monkeypatch.setattr(
        port_sequence.Sequence, "apply_batch_hash_result", watched
    )
    replicas = _run_mixed_cluster(tmp_path, late_node=3)
    on_late_node = [state for node, state in late_digests if node == 3]
    assert on_late_node, "no digest of node 3 came after the owner's Commit"
    assert port_sequence.SeqState.READY not in on_late_node
    assert all(r.app_log.commits for r in replicas)


# -- storage across packages --------------------------------------------------


def _wal_entries(module_pb):
    return [
        (1, module_pb.Persistent(type=module_pb.ECEntry(epoch_number=1))),
        (2, module_pb.Persistent(type=module_pb.CEntry(
            seq_no=0, checkpoint_value=b"\x05" * 32,
            network_state=(
                jax_initial_state if module_pb is jax_pb
                else standard_initial_network_state
            )(4, [7, 8]),
        ))),
        (3, module_pb.Persistent(type=module_pb.ECEntry(epoch_number=3))),
    ]


def _tree(path):
    return {
        p.relative_to(path).as_posix(): p.read_bytes()
        for p in sorted(path.rglob("*")) if p.is_file()
    }


def _write_wal(cls, module_pb, path):
    wal = cls(str(path))
    for index, entry in _wal_entries(module_pb):
        wal.write(index, entry)
    wal.truncate(2)
    wal.sync()
    wal.close()


def _write_store(cls, module_pb, path):
    store = cls(str(path))
    acks = [
        module_pb.RequestAck(client_id=7, req_no=r, digest=bytes([r]) * 32)
        for r in range(4)
    ]
    for ack in acks:
        store.store(ack, b"data-%d" % ack.req_no)
    store.commit(acks[1])
    store.sync()
    store.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_wal_and_request_store_cross_packages_byte_for_byte(tmp_path, writer):
    """A WAL and a request store written by one package are read back by
    the other, entry for entry; both packages write identical bytes."""
    sides = {
        "jax": (JaxWal, JaxRequestStore, jax_pb),
        "port": (FileWal, FileRequestStore, pb),
    }
    reader = "port" if writer == "jax" else "jax"
    w_wal, w_store, w_pb = sides[writer]
    r_wal, r_store, r_pb = sides[reader]
    _write_wal(w_wal, w_pb, tmp_path / "wal")
    _write_store(w_store, w_pb, tmp_path / "reqs")

    wal = r_wal(str(tmp_path / "wal"))
    loaded = []
    wal.load_all(lambda i, e: loaded.append((i, r_pb.encode(e))))
    wal.close()
    want = [(i, w_pb.encode(e)) for i, e in _wal_entries(w_pb) if i >= 2]
    assert loaded == want

    store = r_store(str(tmp_path / "reqs"))
    pending = []
    store.uncommitted(lambda ack: pending.append(
        (ack.req_no, store.get(ack))
    ))
    store.close()
    assert sorted(pending) == [(0, b"data-0"), (2, b"data-2"), (3, b"data-3")]

    _write_wal(r_wal, r_pb, tmp_path / "wal2")
    _write_store(r_store, r_pb, tmp_path / "reqs2")
    _write_wal(w_wal, w_pb, tmp_path / "wal3")
    _write_store(w_store, w_pb, tmp_path / "reqs3")
    assert _tree(tmp_path / "wal2") == _tree(tmp_path / "wal3")
    assert _tree(tmp_path / "reqs2") == _tree(tmp_path / "reqs3")


# -- the pipelined persist→send barrier (tests/test_pipeline.py) --------------


class _FakeNode:
    def __init__(self):
        self.config = Config(id=0)
        self.stepped = []
        self.results = []

    def step(self, replica, msg):
        self.stepped.append((replica, msg))

    def add_results(self, results):
        self.results.append(results)


class _RecordingLink:
    def __init__(self):
        self.sent = []

    def send(self, dest, msg):
        self.sent.append((dest, msg))


class _NullLog:
    def apply(self, q_entry):
        pass

    def snap(self, network_config, clients_state):
        return b"snap"


def _persist_send_actions(index=1):
    ack = pb.RequestAck(client_id=1, req_no=index, digest=b"\x07" * 32)
    actions = act.Actions()
    actions.store_request(
        pb.ForwardRequest(request_ack=ack, request_data=b"payload")
    )
    actions.persist(index, pb.Persistent(type=pb.ECEntry(epoch_number=index)))
    actions.send([1], pb.Msg(type=pb.Suspect(epoch=index)))
    return actions


PIPELINES = {
    "pipelined": lambda *a: PipelinedProcessor(*a),
    "cuda-pipelined": lambda *a: CudaPipelinedProcessor(*a, device="cpu"),
}


def _build(tmp_path, kind, wal=None, store=None):
    node = _FakeNode()
    link = _RecordingLink()
    wal = wal if wal is not None else FileWal(str(tmp_path / "wal"))
    store = store if store is not None else FileRequestStore(
        str(tmp_path / "reqs")
    )
    proc = PIPELINES[kind](node, link, _NullLog(), wal, store)
    return node, link, wal, store, proc


def _await_park(proc, deadline_s=5.0):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        with proc._mutex:
            if proc._error is not None:
                return proc._error
        time.sleep(0.01)
    raise AssertionError("pipeline never parked on the injected fault")


def test_group_commit_coalesces_fsyncs(tmp_path):
    wal = FileWal(str(tmp_path / "wal"))
    syncs = []
    gate = threading.Event()

    def hook():
        syncs.append(time.monotonic())
        gate.wait(timeout=5.0)

    try:
        for i in range(5):
            wal.write(i, pb.Persistent(type=pb.ECEntry(epoch_number=i)))
        wal.fault_hook = hook
        tokens = [wal.sync_token() for _ in range(5)]
        gate.set()
        for token in tokens:
            assert wal.wait(token, timeout=5.0)
        assert len(syncs) <= 2, f"{len(syncs)} fsyncs for 5 tickets"
    finally:
        wal.fault_hook = None
        wal.close()


def test_group_commit_token_covers_earlier_writes(tmp_path):
    wal = FileWal(str(tmp_path / "wal"))
    for i in range(10):
        wal.write(i, pb.Persistent(type=pb.ECEntry(epoch_number=i)))
    token = wal.sync_token()
    assert wal.wait(token, timeout=5.0)
    wal.crash()
    wal2 = FileWal(str(tmp_path / "wal"))
    loaded = []
    wal2.load_all(lambda i, e: loaded.append(i))
    assert loaded == list(range(10))
    wal2.close()


def test_group_commit_propagates_disk_errors_to_waiters(tmp_path):
    store = FileRequestStore(str(tmp_path / "reqs"))
    store.store(pb.RequestAck(client_id=1, req_no=1, digest=b"\x01" * 32),
                b"data")

    def dying_disk():
        raise OSError("injected: disk died")

    store.fault_hook = dying_disk
    token = store.sync_token()
    with pytest.raises(OSError, match="disk died"):
        store.wait(token, timeout=5.0)
    with pytest.raises(OSError):
        store.sync_token()
    store.fault_hook = None
    store.crash()


def test_group_commit_crash_close_fails_uncovered_tickets(tmp_path):
    wal = FileWal(str(tmp_path / "wal"))
    wal.write(1, pb.Persistent(type=pb.ECEntry(epoch_number=1)))

    def dying_disk():
        raise OSError("injected: disk died at fsync")

    wal.fault_hook = dying_disk
    token = wal.sync_token()
    wal.crash()
    with pytest.raises(OSError):
        wal.wait(token, timeout=5.0)
    wal2 = FileWal(str(tmp_path / "wal"))
    wal2.write(2, pb.Persistent(type=pb.ECEntry(epoch_number=2)))
    token = wal2.sync_token()
    wal2.close()
    assert wal2.wait(token, timeout=5.0)


@pytest.mark.parametrize("kind", list(PIPELINES))
@pytest.mark.parametrize("disk", ["wal", "reqstore"])
def test_no_send_escapes_when_a_sync_fails(tmp_path, kind, disk):
    """The disk dies at one store's sync: the barrier holds every send of
    that batch, the error surfaces from a later process() call, and the
    WAL replays a clean prefix."""
    node, link, wal, store, proc = _build(tmp_path, kind)
    target = wal if disk == "wal" else store

    def dying_disk():
        raise OSError(f"injected: {disk} disk died")

    try:
        target.fault_hook = dying_disk
        proc.process(_persist_send_actions(1))
        err = _await_park(proc)
        assert f"{disk} disk died" in str(err)
        assert link.sent == [] and node.stepped == []
        with pytest.raises(OSError, match=f"{disk} disk died"):
            proc.process(_persist_send_actions(2))
    finally:
        proc.close(wait=False)
        target.fault_hook = None
        store.crash()
        wal.crash()
    wal2 = FileWal(str(tmp_path / "wal"))
    wal2.load_all(lambda i, e: None)
    wal2.close()


@pytest.mark.parametrize("kind", list(PIPELINES))
def test_crash_between_wal_sync_and_transmit_replays(tmp_path, kind):
    node, link, wal, store, proc = _build(tmp_path, kind)

    def crashing_transmit(actions):
        raise RuntimeError("injected: crashed before transmit")

    proc._transmit = crashing_transmit
    try:
        proc.process(_persist_send_actions(1))
        err = _await_park(proc)
        assert "crashed before transmit" in str(err)
        assert link.sent == [] and node.stepped == []
    finally:
        proc.close(wait=False)
        store.crash()
        wal.crash()
    wal2 = FileWal(str(tmp_path / "wal"))
    loaded = []
    wal2.load_all(lambda i, e: loaded.append(i))
    assert loaded == [1]
    wal2.close()


@pytest.mark.parametrize("kind", list(PIPELINES))
def test_send_happens_only_after_both_stores_durable(tmp_path, kind):
    node, link, wal, store, proc = _build(tmp_path, kind)
    sync_times = {}

    def observing(name):
        def hook():
            sync_times.setdefault(name, time.monotonic())

        return hook

    wal.fault_hook = observing("wal")
    store.fault_hook = observing("store")
    try:
        proc.process(_persist_send_actions(1))
        deadline = time.monotonic() + 5.0
        while not link.sent and time.monotonic() < deadline:
            time.sleep(0.005)
        send_time = time.monotonic()
        assert link.sent, "send never happened"
        assert {"wal", "store"} <= set(sync_times)
        assert max(sync_times.values()) <= send_time
    finally:
        wal.fault_hook = None
        store.fault_hook = None
        proc.close()
        store.close()
        wal.close()


@pytest.mark.parametrize("kind", list(PIPELINES))
def test_pipeline_delivers_results_internally(tmp_path, kind):
    """process() returns empty results; digests (hash worker) and
    checkpoint values (commit stage) arrive via node.add_results, and the
    digest is the host's."""
    node, link, wal, store, proc = _build(tmp_path, kind)
    seen = []
    proc.on_results = seen.append
    try:
        actions = act.Actions()
        actions.hash([b"preimage"], None)
        actions.commits.append(
            act.CommitAction(
                checkpoint=act.CheckpointReq(
                    seq_no=10, network_config=None, clients_state=[]
                )
            )
        )
        out = proc.process(actions)
        assert not out.digests and not out.checkpoints
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            digests = [d for r in node.results for d in r.digests]
            ckpts = [c for r in node.results for c in r.checkpoints]
            if digests and ckpts:
                break
            time.sleep(0.005)
        assert [d.digest for d in digests] == [host_digest([b"preimage"])]
        assert ckpts[0].value == b"snap"
        assert seen
    finally:
        proc.close()
        store.close()
        wal.close()
    if kind == "cuda-pipelined":
        assert proc.device_digests == 1 and proc.host_digests == 0


@pytest.mark.parametrize("kind", list(PIPELINES))
def test_closed_processor_rejects_new_batches(tmp_path, kind):
    node, link, wal, store, proc = _build(tmp_path, kind)
    proc.close()
    with pytest.raises(ProcessorClosed):
        proc.process(_persist_send_actions(1))
    store.close()
    wal.close()


def test_cuda_kinds_are_the_mixin_and_host_kinds_are_not():
    for kind, cls in PROCESSOR_KINDS.items():
        assert issubclass(cls, _CudaHashMixin) == (kind in CUDA_KINDS)


# -- the owner's commit before a follower's batch digest ----------------------


def _sequence(module_pb, sequence_module, persisted_module):
    network = module_pb.NetworkConfig(nodes=[0, 1, 2, 3], f=1,
                                      number_of_buckets=4)
    return sequence_module.Sequence(
        owner=0, epoch=4, seq_no=5,
        persisted=persisted_module.Persisted(), network_config=network,
        my_config=module_pb.InitialParameters(id=1),
    )


def test_follower_digest_after_the_owners_commit_advances():
    """A follower whose batch digest arrives after the owner's Commit (a
    slow hash on a live cluster): the JAX package's duplicate guard leaves
    the sequence in READY for good; the port prepares it (ROADMAP queue 3).
    With the digest first, both prepare alike."""
    from mirbft_tpu.core import persisted as jax_persisted
    from mirbft_tpu.core import sequence as jax_sequence
    from mirbft_tpu_torch.core import persisted as port_persisted
    from mirbft_tpu_torch.core import sequence as port_sequence

    results = {}
    for name, module_pb, seq_mod, pers_mod in (
        ("jax", jax_pb, jax_sequence, jax_persisted),
        ("port", pb, port_sequence, port_persisted),
    ):
        acks = [module_pb.RequestAck(client_id=9, req_no=7, digest=b"d" * 32)]
        late = _sequence(module_pb, seq_mod, pers_mod)
        late.allocate(list(acks), None)
        late.apply_commit_msg(0, b"x" * 32)  # the owner's Commit
        sends = late.apply_batch_hash_result(b"x" * 32).sends
        early = _sequence(module_pb, seq_mod, pers_mod)
        early.allocate(list(acks), None)
        early.apply_batch_hash_result(b"x" * 32)
        results[name] = (late.state.name, len(sends), early.state.name)
    assert results["jax"] == ("READY", 0, "PREPREPARED")
    assert results["port"] == ("PREPREPARED", 1, "PREPREPARED")


# -- the live rung's launch audit and its processes ---------------------------


def test_launch_audit_counts_every_shape_and_keeps_the_first():
    """With ``samples`` set, every launch counts under its packed shape and
    the first AUDIT_PER_SHAPE of a shape keep their preimages and the
    digests read back."""
    proc = CudaProcessor.__new__(CudaProcessor)
    proc._init_device("cpu")
    proc.samples = {}
    # 3 or 2 preimages of at most 43 bytes pack to (8 rows, 1 block); 9,
    # the longest 97 bytes, to (16 rows, 2 blocks).
    sizes = [3] * (AUDIT_PER_SHAPE + 2) + [9, 2]
    for n in sizes:
        hashes = _hash_actions(n).hashes
        proc._collect_device(hashes, proc._dispatch_device(hashes))
    assert {shape: n for shape, (n, _kept) in proc.samples.items()} == {
        (8, 1): AUDIT_PER_SHAPE + 3, (16, 2): 1,
    }
    kept = proc.samples[(8, 1)][1]
    assert len(kept) == AUDIT_PER_SHAPE
    for preimages, raw in kept + proc.samples[(16, 2)][1]:
        want = b"".join(hashlib.sha256(m).digest() for m in preimages)
        assert raw[: len(want)] == want
    assert proc.launches == len(sizes)


def test_cuda_processor_audits_nothing_unless_asked():
    proc = CudaProcessor.__new__(CudaProcessor)
    proc._init_device("cpu")
    hashes = _hash_actions(3).hashes
    proc._collect_device(hashes, proc._dispatch_device(hashes))
    assert proc.samples is None and proc.launches == 1


@pytest.mark.parametrize("kind", ["serial", "cuda"])
def test_live_rung_runs_each_node_in_a_process_of_its_own(kind):
    """The port's live rung (bench.live_cluster_rate) at a tiny size on the
    CPU: four node processes over loopback TCP reach the target with no
    request committed twice; under ``cuda`` (the plain version) every hash
    request was launched, none hashed on the host, and the audit saw every
    launch's shape."""
    settings = dataclasses.replace(
        bench.LIVE, clients=2, reqs_per_client=10, target_commits=20,
        batch_size=1, tick_s=0.05, fsync_floor_s=0.0, deadline_s=60.0,
        checkpoint_interval=20, suspect_ticks=100,
    )
    result = bench.live_cluster_rate(kind, device="cpu", settings=settings)
    assert max(result["commits"]) >= 20 and len(result["commits"]) == 4
    assert result["rate"] > 0 and result["p95_ms"] > 0
    assert result["hash_requests"] > 0
    if kind == "serial":
        assert "samples" not in result
        return
    assert result["host_digests"] == 0
    assert result["device_digests"] == result["hash_requests"]
    assert result["launches"] > 0
    assert result["wrapper_launches"] == 0  # the plain route counts none
    samples = result["samples"]
    assert sum(n for n, _kept in samples.values()) == result["launches"]
    for (rows, _blocks), (_n, kept) in samples.items():
        for preimages, raw in kept:
            want = b"".join(hashlib.sha256(m).digest() for m in preimages)
            assert raw[: len(want)] == want and len(raw) == 32 * rows


def test_live_rung_rejects_an_unknown_kind():
    with pytest.raises(ValueError, match="unknown processor kind"):
        bench.live_cluster_rate("tpu", device="cpu")
