"""An in-process cluster backend for the load generator.

``InProcessCluster`` satisfies the generator's duck interface with N
real runtime ``Node``s in one process: direct-call links (no sockets),
in-memory WAL/request-store stubs honouring the storage contract, and a
hash-chain app log that stamps each commit with ``time.monotonic_ns()``.
It runs the full submit→consensus→commit→latency pipeline without
process spawns or fsyncs: the CPU tests' cluster, and on a card the
signed-ingress and KV rungs (``bench.ingress_run``, ``bench.app_run``).

Every node hashes on the ``cuda-pipelined`` processor, on ``cuda``
unless the caller passes ``device="cpu"`` (the digest kernel's plain
version); a host processor kind (``serial``, ``pool``, ``pipelined``)
runs only when the caller names it.  Without a card the default raises
before any node starts.

The consumer loop per node is the standard runtime embedding: ready →
process → add_results, with wall-clock ticks and the real TransferEngine
(over a direct in-process duct, memory-only staging) serving state
transfer.
"""

from __future__ import annotations

import hashlib
import threading
import time

from .. import pb
from ..app import KvFrontend, KvStore
from ..app import kvstore as kv_ops
from ..app.stream import CommitStream
from ..ops.batching import resolve_device
from ..runtime import PROCESSOR_KINDS, Config, Node, build_processor
from ..runtime.node import NodeStopped, standard_initial_network_state
from ..runtime.processor import Link, Log, _CudaHashMixin
from ..runtime.reconfig import checkpoint_network_state
from ..runtime.transfer import TransferEngine


class MemWal:
    """The WAL storage contract, in memory (sync points are no-ops)."""

    def __init__(self):
        self.entries: dict = {}  # index -> encoded entry
        self.fault_hook = None

    def write(self, index: int, entry) -> None:
        self.entries[index] = entry

    def truncate(self, index: int) -> None:
        for stale in [i for i in self.entries if i < index]:
            del self.entries[stale]

    def sync(self) -> None:
        if self.fault_hook is not None:
            self.fault_hook()

    def sync_token(self) -> int:
        return 0

    def wait(self, token: int, timeout: float | None = None) -> bool:
        return True  # every ticket is durable at once in memory

    def load_all(self, for_each) -> None:
        for index in sorted(self.entries):
            for_each(index, self.entries[index])

    def close(self) -> None:
        pass

    crash = close


class MemRequestStore:
    """The request-store contract, in memory."""

    def __init__(self):
        self.data: dict = {}  # (client_id, req_no, digest) -> payload
        self.committed: set = set()
        self.fault_hook = None

    @staticmethod
    def _key(ack) -> tuple:
        return (ack.client_id, ack.req_no, bytes(ack.digest))

    def store(self, ack, data: bytes) -> None:
        self.data[self._key(ack)] = data

    def get(self, ack):
        return self.data.get(self._key(ack))

    def commit(self, ack) -> None:
        self.committed.add(self._key(ack))

    def sync(self) -> None:
        if self.fault_hook is not None:
            self.fault_hook()

    def sync_token(self) -> int:
        return 0

    def wait(self, token: int, timeout: float | None = None) -> bool:
        return True  # every ticket is durable at once in memory

    def uncommitted(self, for_each) -> None:
        for key, data in self.data.items():
            if key not in self.committed:
                client_id, req_no, digest = key
                for_each(
                    pb.RequestAck(
                        client_id=client_id, req_no=req_no, digest=digest
                    ),
                    data,
                )

    def close(self) -> None:
        pass

    crash = close


class MemChainLog(Log):
    """Hash-chain application state with monotonic commit stamps."""

    def __init__(self, node_id: int, sink):
        self.node_id = node_id
        self.sink = sink  # callable(node_id, client_id, req_no, seq, ts_ns)
        self.chain = b""
        self.commits: list = []  # [(client_id, req_no, seq)]
        self.last_seq = 0

    def apply(self, q_entry: pb.QEntry) -> None:
        if q_entry.seq_no <= self.last_seq:
            return
        ts_ns = time.monotonic_ns()
        for ack in q_entry.requests:
            h = hashlib.sha256()
            h.update(self.chain)
            h.update(ack.digest)
            self.chain = h.digest()
            self.commits.append((ack.client_id, ack.req_no, q_entry.seq_no))
            self.sink(
                self.node_id, ack.client_id, ack.req_no, q_entry.seq_no, ts_ns
            )
        self.last_seq = q_entry.seq_no

    def adopt(self, value: bytes, seq_no: int) -> None:
        self.chain = value
        if seq_no > self.last_seq:
            self.last_seq = seq_no

    def snap(self, network_config, clients_state) -> bytes:
        return self.chain


class _MemAppLog(Log):
    """KV mode: the chain log (commit stamps for the generator) composed
    with the commit stream — the in-process analogue of ``app.AppLog``
    without the durable journal."""

    def __init__(self, chain_log: MemChainLog, stream: CommitStream):
        self.chain_log = chain_log
        self.stream = stream
        stream.chain_source = lambda: chain_log.chain

    @property
    def chain(self) -> bytes:
        return self.chain_log.chain

    def apply(self, q_entry: pb.QEntry) -> None:
        self.chain_log.apply(q_entry)
        self.stream.apply(q_entry)

    def snap(self, network_config, clients_state) -> bytes:
        self.chain_log.snap(network_config, clients_state)
        return self.stream.snap(network_config, clients_state)

    def install(self, app_bytes: bytes, value: bytes, seq_no: int) -> bool:
        chain = CommitStream.chain_of(app_bytes)
        if chain is None or not self.stream.install(app_bytes, value, seq_no):
            return False
        self.chain_log.adopt(chain, seq_no)
        return True


class KvSession:
    """An in-process KV session over the frontends: the loopback
    equivalent of ``app.service.KvClient`` (same write broadcast and
    read-barrier semantics, direct calls instead of sockets)."""

    def __init__(self, cluster: "InProcessCluster", client_id: int,
                 home: int = 0):
        self.cluster = cluster
        self.client_id = client_id
        self.home = home
        self.req_no = 0
        self.session_index = 0

    def _observe(self, resp: dict) -> dict:
        for field in ("index", "version", "frontier"):
            val = resp.get(field)
            if isinstance(val, int) and val > self.session_index:
                self.session_index = val
        return resp

    def _write(self, data: bytes, timeout: float) -> dict:
        # Client windows open at req_no 0 and advance in order.
        req_no = self.req_no
        self.req_no += 1
        stream = self.cluster.replicas[self.home].stream
        waiter = stream.register_waiter(self.client_id, req_no)
        request = pb.Request(
            client_id=self.client_id, req_no=req_no, data=data
        )
        # The Mir client contract: broadcast the write to every node.
        for node_id in self.cluster.node_ids:
            self.cluster.submit(node_id, request)
        got = waiter.wait(timeout)
        if got is None:
            stream.cancel_waiter(self.client_id, req_no)
            return {"status": "timeout"}
        index, result = got
        return self._observe(
            {
                "status": (result or {}).get("outcome", "ok"),
                "version": (result or {}).get("version", index),
                "index": index,
            }
        )

    def put(self, key: str, value: bytes, timeout: float = 10.0) -> dict:
        return self._write(kv_ops.encode_put(key, value), timeout)

    def delete(self, key: str, timeout: float = 10.0) -> dict:
        return self._write(kv_ops.encode_delete(key), timeout)

    def cas(self, key: str, expect_version: int, value: bytes,
            timeout: float = 10.0) -> dict:
        return self._write(
            kv_ops.encode_cas(key, expect_version, value), timeout
        )

    def get(self, key: str, mode: str = "committed",
            timeout: float = 10.0) -> dict:
        frontend = self.cluster.replicas[self.home].frontend
        resp = frontend.execute(
            {
                "op": "get",
                "key": key,
                "mode": mode,
                "min_index": self.session_index if mode == "committed" else 0,
                "timeout": timeout,
            }
        )
        if resp.get("status") in ("ok", "not_found"):
            self._observe(resp)
        return resp


class _DirectLink(Link):
    """Same-process message passing: send == dest.step(source, msg)."""

    def __init__(self, cluster, source: int):
        self.cluster = cluster
        self.source = source

    def send(self, dest: int, msg: pb.Msg) -> None:
        replica = self.cluster.replicas[dest]
        if replica is None:
            return
        try:
            replica.node.step(self.source, msg)
        except (NodeStopped, ValueError):
            pass


class _DirectDuct:
    """Same-process transfer duct: send == dest engine's on_frame."""

    def __init__(self, cluster, source: int):
        self.cluster = cluster
        self.source = source

    def send(self, dest: int, body: bytes) -> None:
        replica = self.cluster.replicas[dest]
        if replica is None:
            return
        replica.engine.on_frame(self.source, body)


class _InProcReplica:
    def __init__(self, cluster, node_id: int, initial_state, processor: str):
        self.cluster = cluster
        self.node_id = node_id
        self.app_log = MemChainLog(node_id, cluster._on_commit)
        self.wal = MemWal()
        self.reqstore = MemRequestStore()
        config = Config(
            id=node_id,
            batch_size=cluster.batch_size,
            processor=processor,
        )
        self.node = Node.start_new(config, initial_state)
        self.stream = None
        self.frontend = None
        if cluster.app == "kv":
            self.store = KvStore()
            self.stream = self.node.attach_app(
                self.store,
                queue_depth=cluster.app_queue_depth,
                data_source=self.reqstore.get,
            )
            self.app_log = _MemAppLog(self.app_log, self.stream)
            self.frontend = KvFrontend(
                self.stream, self.store, self.node.propose
            )
        self.processor = build_processor(
            self.node,
            _DirectLink(cluster, node_id),
            self.app_log,
            self.wal,
            self.reqstore,
            device=cluster.device,
        )
        self.checkpoints: dict = {}
        if hasattr(self.processor, "on_results"):
            self.processor.on_results = self._capture_checkpoints
        self.engine = TransferEngine(
            node_id,
            _DirectDuct(cluster, node_id),
            staging_dir=None,  # memory-only embedder: no crash resume
            peers=list(initial_state.config.nodes),
            limits=config,
            install=self._install_snapshot,
            complete=self.node.state_transfer_complete,
            failed=self.node.state_transfer_failed,
            chunk_timeout_s=0.25,
        )
        self.failed = None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._consume,
            name=f"loadgen-consumer-{node_id}",
            daemon=True,
        )

    def _capture_checkpoints(self, results) -> None:
        for cr in results.checkpoints:
            network_state = checkpoint_network_state(cr)
            self.checkpoints[cr.checkpoint.seq_no] = (cr.value, network_state)
            requests: list = []
            self.reqstore.uncommitted(
                lambda ack, data: requests.append((ack, data))
            )
            if self.stream is not None:
                app_bytes = (
                    self.stream.snapshot_blob(cr.value)
                    or self.stream.last_snapshot_blob
                    or b""
                )
            else:
                app_bytes = self.app_log.chain
            self.engine.note_checkpoint(
                cr.checkpoint.seq_no,
                cr.value,
                network_state,
                app_bytes,
                requests,
            )

    def _install_snapshot(self, snap):
        """TransferEngine install callback: adopt the app state (in KV
        mode the verified full state blob) and the donor's
        uncommitted-request slice, then let the node persist the
        checkpoint CEntry."""
        if self.stream is not None:
            if not self.app_log.install(
                snap.app_bytes, snap.value, snap.seq_no
            ):
                return None
            self.stream.answer_installed(snap.network_state, snap.seq_no)
        else:
            self.app_log.adopt(snap.value, snap.seq_no)
        for ack, data in snap.requests:
            self.reqstore.store(ack, data)
        return snap.network_state

    def _consume(self) -> None:
        tick_seconds = self.cluster.tick_seconds
        last_tick = time.monotonic()
        try:
            while not self._stop.is_set():
                actions = self.node.ready(timeout=0.01)
                if actions is not None:
                    results = self.processor.process(actions)
                    self._capture_checkpoints(results)
                    if results.digests or results.checkpoints:
                        self.node.add_results(results)
                now = time.monotonic()
                if now - last_tick >= tick_seconds:
                    last_tick = now
                    self.node.tick()
                if actions is not None and actions.state_transfer is not None:
                    self.engine.begin(actions.state_transfer)
                self.engine.poll()
        except NodeStopped:
            pass
        except Exception as err:  # noqa: BLE001 — surfaced via cluster.check()
            self.failed = err

    def stop(self) -> None:
        self._stop.set()
        closer = getattr(self.processor, "close", None)
        if closer is not None:
            try:
                closer()
            except Exception:  # noqa: BLE001 — teardown is best-effort
                pass
        if self._thread.ident is not None:
            self._thread.join(timeout=10)
        self.node.stop()


class InProcessCluster:
    """N runtime nodes behind the load generator's duck interface."""

    def __init__(
        self,
        node_count: int = 4,
        client_ids=None,
        *,
        batch_size: int = 1,
        processor: str = "cuda-pipelined",
        device="cuda",
        tick_seconds: float = 0.02,
        app: str | None = None,
        app_queue_depth: int = 256,
    ):
        cls = PROCESSOR_KINDS.get(processor)
        # Resolved before any node starts: no card raises here, and no
        # kind falls back to another.
        self.device = (
            resolve_device(device)
            if cls is not None and issubclass(cls, _CudaHashMixin)
            else None
        )
        self.batch_size = batch_size
        self.tick_seconds = tick_seconds
        self.app = app
        self.app_queue_depth = app_queue_depth
        self.client_ids = list(client_ids) if client_ids else [1, 2]
        self._lock = threading.Lock()
        self._commits: list = []
        state = standard_initial_network_state(node_count, self.client_ids)
        self.replicas = [
            _InProcReplica(self, n, state, processor)
            for n in range(node_count)
        ]
        for replica in self.replicas:
            replica._thread.start()

    @property
    def node_ids(self) -> list:
        return [replica.node_id for replica in self.replicas]

    def _on_commit(self, node_id, client_id, req_no, seq, ts_ns) -> None:
        with self._lock:
            self._commits.append((node_id, client_id, req_no, seq, ts_ns))

    def submit(self, node_id: int, request: pb.Request) -> None:
        try:
            self.replicas[node_id].node.propose(request)
        except (NodeStopped, ValueError):
            pass

    def poll_commits(self) -> list:
        with self._lock:
            out = self._commits
            self._commits = []
        return out

    def kv_session(self, client_id: int, home: int = 0) -> KvSession:
        """A KV session over the in-process frontends (requires
        ``app="kv"``); ``client_id`` must be a registered client id."""
        if self.app != "kv":
            raise RuntimeError("kv_session requires InProcessCluster(app='kv')")
        return KvSession(self, client_id, home)

    def check(self) -> None:
        """Raise the first consumer/serializer failure, if any."""
        for replica in self.replicas:
            if replica.failed is not None:
                raise replica.failed
            if replica.node.exit_error is not None:
                raise replica.node.exit_error

    def close(self) -> None:
        for replica in self.replicas:
            replica.stop()

    def __enter__(self) -> "InProcessCluster":
        return self

    def __exit__(self, *_exc) -> None:
        self.close()
