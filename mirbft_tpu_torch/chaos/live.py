"""Live-cluster chaos: the fault campaign against the real TCP runtime.

The deterministic runner (runner.py) executes scenarios on the simulated
testengine; this driver lowers the *same* structured Scenario schema onto
a real cluster: N ``runtime.Node`` instances over ``TcpTransport`` on
loopback, with real serializer/consumer threads, real WAL/reqstore files,
and real fsyncs.  Faults become what they are in production:

- ``PartitionWindow``  -> socket-level partition proxies, one per directed
  transport edge; cutting an edge closes its listener so the dialing
  sender thread walks its reconnect backoff, healing re-binds the port.
- ``CrashPoint``       -> crash-kill the replica (no final fsync) and
  reboot it from its on-disk WAL/reqstore via ``Node.restart``.
- ``StorageFault``     -> the WAL/reqstore fsync seams start raising
  OSError; the runtime fails loudly, the driver crash-kills it, and the
  reboot gets healthy storage.
- ``drop_pct``         -> a seeded ``TransportFault`` dropping frames at
  the send seam (surfaced via the transport's ``dropped_fault`` counter).
- ``signed``           -> clients Ed25519-sign, the driver verifies at
  ingress through the scenario's SignaturePlane on the Ed25519 kernels
  (flaky backends walk the breaker exactly as under the deterministic
  engine), and one forged request must be stopped cold.
- ``Adversary``        -> Byzantine attacks on content and ordering.
  Wire attacks (equivocate / censor / corrupt / flood of peer messages)
  become frame-rewriting ``AdversaryProxy`` edges that parse the
  transport's length-prefixed frames and rewrite, drop, or multiply
  them; proposal attacks (corrupt / censor / flood of client
  submissions) are driven at the client seam, with signed-mode
  corruption gated through the ingress SignaturePlane exactly as the
  engine's authentication filter would.

After convergence the same invariant checkers audit the run — no fork,
durable prefix across every crash-restart, bounded recovery — plus the
liveness invariant: commits *resume* within the bound after the last
heal/restart instant.  Epoch-change scenarios are additionally asserted
through the obsv ``epoch.active`` milestone counter, so the run proves
the change happened through the same telemetry operators would watch.

Scenario fault instants are authored in simulated ms against the
testengine's 500ms tick; the driver re-times them against its real tick
period (``scale_s``), so "isolated past the suspect timeout" means the
same thing under both engines.

Every replica builds the port's processor ``processor`` (``cuda`` by
default: each Actions batch's digests in one launch of the SHA-256
kernel), signed ingress verifies on the Ed25519 kernels, and the
certificate audit aggregates on the BLS G1 kernel, all on ``device``:
``cuda`` unless the caller asks for ``cpu`` (the kernels' plain
versions).  Each replica's digest launches are counted across its
restarts (``digest_launches``).
"""

from __future__ import annotations

import os
import random
import shutil
import socket
import tempfile
import threading
import time
from types import SimpleNamespace

from .. import pb, wire
from ..obsv import hooks
from ..obsv.metrics import Registry
from ..ops.batching import resolve_device
from ..resilience import CircuitBreaker
from ..runtime import (
    Config,
    FileRequestStore,
    FileWal,
    Node,
    build_processor,
)
from ..runtime.node import NodeStopped, standard_initial_network_state
from ..runtime.reconfig import checkpoint_network_state
from ..runtime.transfer import _KIND_CHUNK, TransferEngine
from ..runtime.transport import (
    _HELLO_SRC,
    _LEN,
    _XFER_SRC,
    TcpTransport,
    TransportFault,
)
from ..crypto.mac import TAG_LEN as _MAC_TAG_LEN
from ..testengine.manglers import _flip_bytes, _variant_digest
from .invariants import (
    CrashSnapshot,
    InvariantViolation,
    audit_aggregate_certs,
    check_aggregate_cert_rejected,
    check_bounded_recovery,
    check_censorship_liveness,
    check_commit_resumption,
    check_corruption_rejected,
    check_durable_prefix,
    check_mac_rejected,
    check_no_fork,
    check_no_fork_under_equivocation,
    check_transfer_corruption_rejected,
)
from ..obsv.recorder import FlightRecorder
from ..ops import kernel_launches
from .runner import (
    FIRST_WORKING_EPOCH,
    ROTATION_BUCKETS,
    CampaignResult,
    ScenarioResult,
    dump_on_violation,
)
from .scenarios import Scenario, live_matrix

# The deterministic testengine ticks every 500 simulated ms; scenario
# fault instants are authored on that clock.
SIM_TICK_MS = 500

# Wall-clock floor for the scaled recovery bound: scheduler and fsync
# jitter on a loaded CI host must not fail a scenario whose scaled bound
# would otherwise be a couple of seconds.
MIN_RECOVERY_BOUND_MS = 15_000

# How long the fault clock waits for every replica's bootstrap log to
# reach disk (LiveCluster._await_persisted_boot).
BOOT_PERSIST_TIMEOUT_S = 30.0


def _shutdown_close(sock) -> None:
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


class DropFault(TransportFault):
    """Uniform seeded frame loss at the transport send seam — the live
    lowering of ``Scenario.drop_pct``.  One instance is shared by every
    node's transport (matching the deterministic engine's single drop
    mangler); the RNG is locked because each transport calls ``on_send``
    from its own serializer/consumer threads."""

    def __init__(self, drop_pct: int, seed: int):
        self.drop_pct = drop_pct
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def on_send(self, peer_id: int, frame: bytes) -> bool:
        if self.drop_pct <= 0:
            return True
        with self._lock:
            return self._rng.random() * 100.0 >= self.drop_pct


class PartitionProxy:
    """A directed socket-level forwarder for one transport edge.

    Node A is told peer B lives at this proxy's address; each accepted
    connection dials the real upstream and two pump threads shuttle
    bytes.  While cut, the listener is *closed*: the dialing side's
    sender thread sees ECONNREFUSED and walks its reconnect backoff —
    exactly what a firewalled peer produces.  Healing re-binds the same
    port, so addresses registered via ``transport.connect`` stay valid
    across any number of cut/heal cycles and node restarts."""

    def __init__(self, upstream: tuple):
        self.upstream = tuple(upstream)
        self.cut_count = 0
        self._lock = threading.Lock()
        self._cut = False
        self._closed = False
        self._pipes: set = set()
        self._threads: list = []
        self._server = None
        self._accept_thread = None
        self._open_listener(("127.0.0.1", 0))
        self.address = self._server.getsockname()

    def _open_listener(self, address) -> None:
        server = socket.create_server(address)
        thread = threading.Thread(
            target=self._accept_loop,
            args=(server,),
            name="chaos-proxy-accept",
            daemon=True,
        )
        self._server = server
        self._accept_thread = thread
        thread.start()

    def set_cut(self, cut: bool) -> None:
        with self._lock:
            if self._closed or cut == self._cut:
                return
            self._cut = cut
            pipes = list(self._pipes) if cut else []
        if cut:
            self.cut_count += 1
            self._close_listener()
            for pipe in pipes:
                _shutdown_close(pipe)
        else:
            # SO_REUSEADDR (create_server default) makes the same-port
            # re-bind immediate; retry briefly for scheduler races.
            deadline = time.monotonic() + 10
            while True:
                try:
                    self._open_listener(self.address)
                    return
                except OSError:
                    if time.monotonic() >= deadline:
                        raise
                    time.sleep(0.02)

    def _close_listener(self) -> None:
        server, thread = self._server, self._accept_thread
        if server is None:
            return
        try:
            server.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        server.close()
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=5)

    def _accept_loop(self, server) -> None:
        while True:
            try:
                conn, _addr = server.accept()
            except OSError:
                return  # listener closed (cut or shutdown)
            with self._lock:
                stale = self._closed or self._cut or self._server is not server
            if stale:
                _shutdown_close(conn)
                continue
            try:
                up = socket.create_connection(self.upstream, timeout=2.0)
            except OSError:
                _shutdown_close(conn)
                continue
            with self._lock:
                if self._closed or self._cut or self._server is not server:
                    _shutdown_close(conn)
                    _shutdown_close(up)
                    continue
                self._pipes.add(conn)
                self._pipes.add(up)
                pumps = [
                    threading.Thread(
                        target=self._pump,
                        args=(conn, up),
                        name="chaos-proxy-pump",
                        daemon=True,
                    ),
                    threading.Thread(
                        target=self._pump,
                        args=(up, conn),
                        name="chaos-proxy-pump",
                        daemon=True,
                    ),
                ]
                self._threads.extend(pumps)
            for pump in pumps:
                pump.start()

    def _pump(self, src, dst) -> None:
        try:
            while True:
                data = src.recv(65536)
                if not data:
                    break
                dst.sendall(data)
        except OSError:
            pass
        finally:
            with self._lock:
                self._pipes.discard(src)
                self._pipes.discard(dst)
            _shutdown_close(src)
            _shutdown_close(dst)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            pipes = list(self._pipes)
            threads = list(self._threads)
        self._close_listener()
        for pipe in pipes:
            _shutdown_close(pipe)
        for thread in threads:
            thread.join(timeout=5)


class AdversaryProxy(PartitionProxy):
    """A frame-rewriting PartitionProxy: the live lowering of the
    adversary DSL's wire attacks.  The forward pump (dialer -> upstream)
    reassembles the transport's ``[u32 len][varint source][pb.Msg]``
    frames and hands each decoded message to ``mangle(source, msg)``,
    which returns ``None`` (pass through unchanged) or a replacement
    list: ``[]`` censors the frame, a rewritten message corrupts or
    equivocates it, and extra copies flood the receiver.  Snapshot
    state-transfer frames (the reserved ``_XFER_SRC`` lane) are opaque
    bytes, not pb.Msg; they go to ``mangle_transfer(body)`` with the
    same None / [] / replacement-list contract, so an adversary can
    corrupt, truncate, or censor a transfer stream in flight.
    Clock-sync hellos and client-proposal frames (the other reserved
    source ids) always pass untouched, as does the reverse pump — real
    peer links are one-way, so only the forward byte stream carries
    frames.

    ``mangle_raw(source, payload)`` is the byte-level seam for attacks
    below the message layer — MAC-tag forgery against link-authenticated
    frames, which must stay structurally parseable so the rejection is
    attributable to the MAC check alone.  It sees node-lane frames only
    (reserved source ids pass) and returns a replacement payload or None;
    when it rewrites a frame, the message-level manglers are skipped (a
    forged frame never reaches the decoder anyway)."""

    def __init__(
        self, upstream: tuple, mangle, mangle_transfer=None, mangle_raw=None
    ):
        self.mangle = mangle
        self.mangle_transfer = mangle_transfer
        self.mangle_raw = mangle_raw
        super().__init__(upstream)

    def _pump(self, src, dst) -> None:
        try:
            forward = dst.getpeername() == self.upstream
        except OSError:
            forward = False
        if not forward or (
            self.mangle is None
            and self.mangle_transfer is None
            and self.mangle_raw is None
        ):
            return super()._pump(src, dst)
        buf = bytearray()
        try:
            while True:
                data = src.recv(65536)
                if not data:
                    break
                buf += data
                out = bytearray()
                while len(buf) >= _LEN.size:
                    (length,) = _LEN.unpack(buf[: _LEN.size])
                    if len(buf) < _LEN.size + length:
                        break
                    payload = bytes(buf[_LEN.size : _LEN.size + length])
                    del buf[: _LEN.size + length]
                    out += self._rewrite(payload)
                if out:
                    dst.sendall(bytes(out))
        except OSError:
            pass
        finally:
            with self._lock:
                self._pipes.discard(src)
                self._pipes.discard(dst)
            _shutdown_close(src)
            _shutdown_close(dst)

    def _rewrite(self, payload: bytes) -> bytes:
        original = _LEN.pack(len(payload)) + payload
        try:
            source, offset = wire.decode_varint(payload, 0)
            if source == _XFER_SRC:
                return self._rewrite_transfer(payload, offset, original)
            if source >= _HELLO_SRC:
                return original  # hello / client-proposal frame
            if self.mangle_raw is not None:
                twisted = self.mangle_raw(source, payload)
                if twisted is not None:
                    return _LEN.pack(len(twisted)) + twisted
            msg = pb.decode(pb.Msg, payload[offset:])
        except ValueError:
            return original  # not ours to judge: the receiver drops it
        if self.mangle is None:
            return original
        replacement = self.mangle(source, msg)
        if replacement is None:
            return original
        prefix = payload[:offset]
        out = bytearray()
        for new_msg in replacement:
            body = prefix + pb.encode(new_msg)
            out += _LEN.pack(len(body)) + body
        return bytes(out)

    def _rewrite_transfer(self, payload, offset, original):
        """Hand a state-transfer frame body (sender varint preserved, so
        the fetcher's donor check still attributes it) to the transfer
        mangler."""
        if self.mangle_transfer is None:
            return original
        _sender, body_start = wire.decode_varint(payload, offset)
        replacement = self.mangle_transfer(payload[body_start:])
        if replacement is None:
            return original
        prefix = payload[:body_start]
        out = bytearray()
        for new_body in replacement:
            framed = prefix + new_body
            out += _LEN.pack(len(framed)) + framed
        return bytes(out)


# DurableChainLog moved to mirbft_tpu/app/journal.py when the real
# application layer landed (it is the app's durable journal, not a chaos
# artifact); re-exported here so existing imports keep working.
from ..app.journal import DurableChainLog  # noqa: E402,F401


class _TransportDuct:
    """TransferEngine's send seam over the real transport's reserved
    ``_XFER_SRC`` lane (so transfer frames ride the same proxied TCP
    links — and the same partitions and adversaries — as consensus)."""

    def __init__(self, transport):
        self.transport = transport

    def send(self, dest: int, body: bytes) -> None:
        self.transport.send_transfer(dest, body)


class _SuspectWatch:
    """A replica's outgoing link, noting whether the node suspected the
    first working epoch before it had applied any entry: the start of the
    epoch-change cascade that carries a censored request past ``censor_k``
    rotations when a first commit comes later than the suspicion timeout
    (ROADMAP queue 3)."""

    def __init__(self, link, replica):
        self._link = link
        self._replica = replica

    def send(self, dest: int, msg: pb.Msg) -> None:
        inner = msg.type
        if (
            isinstance(inner, pb.Suspect)
            and inner.epoch == FIRST_WORKING_EPOCH
            and self._replica.app_log.last_seq == 0
        ):
            self._replica.cluster.note_early_suspicion(self._replica.node_id)
        self._link.send(dest, msg)


class LiveReplica:
    """One real node: serializer (inside Node), consumer loop thread,
    TCP transport wired through the cluster's partition proxies, and
    on-disk WAL/reqstore/app-log under the cluster's scratch root."""

    def __init__(self, cluster, node_id: int, initial_state=None, port=0):
        self.cluster = cluster
        self.node_id = node_id
        self.dir = os.path.join(cluster.root, f"node{node_id}")
        os.makedirs(self.dir, exist_ok=True)
        self.app_log = DurableChainLog(
            os.path.join(self.dir, "app.log"),
            node_id,
            on_commit=self._on_commit,
        )
        self.wal = FileWal(os.path.join(self.dir, "wal"))
        self.reqstore = FileRequestStore(os.path.join(self.dir, "reqs"))
        config = Config(
            id=node_id,
            batch_size=cluster.scenario.batch_size,
            processor=cluster.processor,
            link_auth=bool(cluster.auth_secret),
            auth_secret=cluster.auth_secret,
        )
        self.config = config
        if initial_state is not None:
            self.node = Node.start_new(config, initial_state)
        else:
            self.node = Node.restart(config, self.wal, self.reqstore)
        self.transport = self._bind(port)
        self.port = self.transport.address[1]
        if cluster.drop_fault is not None:
            self.transport.fault = cluster.drop_fault
        self.transport.serve(self.node)
        self.processor = build_processor(
            self.node,
            _SuspectWatch(self.transport.link(), self),
            self.app_log,
            self.wal,
            self.reqstore,
            device=cluster.device,
        )
        # seq_no -> (value, pb.NetworkState): local view of this node's
        # own stable checkpoints (snapshot material lives in the engine).
        self.checkpoints: dict = {}
        # Pipelined executors hand results to the node internally; the
        # checkpoint capture below must route through their seam.
        if hasattr(self.processor, "on_results"):
            self.processor.on_results = self._capture_checkpoints
        # Real snapshot state transfer over the transport's reserved
        # lane; staged under the node dir, so a crash mid-transfer
        # resumes from the verified staged blob after restart.
        self.engine = TransferEngine(
            node_id,
            _TransportDuct(self.transport),
            staging_dir=self.dir,
            peers=[
                p
                for p in range(cluster.scenario.node_count)
                if p != node_id
            ],
            limits=config,
            install=self._install_snapshot,
            complete=self.node.state_transfer_complete,
            failed=self.node.state_transfer_failed,
            chunk_timeout_s=max(cluster.tick_seconds * 10, 0.5),
        )
        self.transport.set_transfer_sink(self.engine.on_frame)
        self.failed = None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._consume,
            name=f"live-consumer-{node_id}",
            daemon=True,
        )

    def _bind(self, port: int) -> TcpTransport:
        """Bind the transport; a restart re-binds the node's original
        port (retrying through TIME_WAIT) so the partition proxies'
        upstream addresses stay valid across the reboot."""
        link_auth = None
        if self.config.link_auth:
            from ..crypto.mac import LinkAuthenticator

            link_auth = LinkAuthenticator(
                self.node_id, self.config.auth_secret
            )
        deadline = time.monotonic() + 10
        while True:
            try:
                return TcpTransport(
                    self.node_id,
                    port=port,
                    backoff_base=0.02,
                    backoff_cap=0.25,
                    dial_timeout=1.0,
                    link_auth=link_auth,
                )
            except OSError:
                if port == 0 or time.monotonic() >= deadline:
                    raise
                time.sleep(0.02)

    def wire(self) -> None:
        for peer_id in range(self.cluster.scenario.node_count):
            if peer_id != self.node_id:
                proxy = self.cluster.proxies[(self.node_id, peer_id)]
                self.transport.connect(peer_id, proxy.address)

    def start_consumer(self) -> None:
        self._thread.start()

    def arm_storage_fault(self) -> None:
        def fail() -> None:
            raise OSError("injected fsync failure (chaos StorageFault)")

        self.wal.fault_hook = fail
        self.reqstore.fault_hook = fail

    def _capture_checkpoints(self, results) -> None:
        for cr in results.checkpoints:
            network_state = checkpoint_network_state(cr)
            self.checkpoints[cr.checkpoint.seq_no] = (cr.value, network_state)
            requests: list = []

            def _collect(ack, _data=None):
                # FileRequestStore.uncommitted hands only the ack; the
                # payload is a separate read.
                data = self.reqstore.get(ack)
                if data is not None:
                    requests.append((ack, data))

            self.reqstore.uncommitted(_collect)
            self.engine.note_checkpoint(
                cr.checkpoint.seq_no,
                cr.value,
                network_state,
                self.app_log.chain,
                requests,
            )

    def _install_snapshot(self, snap):
        """TransferEngine install callback: adopt the app chain (an
        fsynced adopt record) and the donor's uncommitted-request slice,
        then let the node persist the checkpoint CEntry."""
        self.app_log.adopt(snap.value, snap.seq_no)
        for ack, data in snap.requests:
            self.reqstore.store(ack, data)
        self.reqstore.sync()
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
        except Exception as err:  # noqa: BLE001 — injected faults land here
            self.failed = err

    def _on_commit(self, node_id: int, nreqs: int) -> None:
        # Called by the app log right after it appended ``nreqs`` commits.
        self.cluster._on_commit(node_id, self.app_log.commits[-nreqs:])

    def snapshot(self, at_ms: int) -> CrashSnapshot:
        return CrashSnapshot(
            node=self.node_id, at_ms=at_ms, committed=list(self.app_log.commits)
        )

    def kill(self, graceful: bool = False) -> None:
        """Tear the replica down.  ``graceful=False`` models kill -9 as
        closely as an in-process harness can: storage handles close
        without their shutdown fsync, so only what the runtime already
        synced is durable."""
        self._stop.set()
        closer = getattr(self.processor, "close", None)
        if closer is not None and not graceful:
            # Crash-kill: park the pipeline *before* joining the consumer
            # — a consumer blocked in a backpressure put must be released,
            # and in-flight batches are abandoned like any other un-synced
            # work under kill -9.
            try:
                closer(wait=False)
            except TypeError:
                closer()  # PoolProcessor.close takes no args
        if self._thread.ident is not None:
            self._thread.join(timeout=10)
        if closer is not None and graceful:
            # Clean shutdown: drain in-flight batches (commits land, the
            # WAL/reqstore group syncers flush) before storage closes.
            closer()
        self.transport.close(0)
        self.node.stop()
        if graceful:
            self.wal.close()
            self.reqstore.close()
            self.app_log.close()
        else:
            self.wal.crash()
            self.reqstore.crash()
            self.app_log.crash()
        self.cluster.digest_launches[self.node_id] += getattr(
            self.processor, "launches", 0
        )


class _LiveAdversary:
    """Wall-clock lowering of one structured ``Adversary`` spec: the
    attack window re-timed against the cluster's tick period, a seeded
    RNG behind a lock (proxy pump threads and the proposer thread fire
    concurrently), and the same evidence counters the deterministic
    manglers expose — so the invariant checkers audit both engines on
    identical inputs."""

    def __init__(self, spec, cluster, seed: int):
        self.spec = spec
        self.cluster = cluster
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.corrupted = 0
        self.corrupted_proposes = 0
        self.rejections = 0
        self.flooded = 0
        self.censored = 0
        self.corrupted_transfer = 0
        self.censored_transfer = 0
        self.forged_macs = 0
        self.censored_pairs: set = set()
        self.variants: dict = {}
        self.from_s = cluster.scale_s(spec.from_ms)
        self.until_s = (
            None if spec.until_ms is None else cluster.scale_s(spec.until_ms)
        )

    def active(self) -> bool:
        start = self.cluster._start
        if start is None:
            return False
        now_s = time.monotonic() - start
        if now_s < self.from_s:
            return False
        return self.until_s is None or now_s < self.until_s

    def fires(self) -> bool:
        if self.spec.rate_pct >= 100:
            return True
        with self._lock:
            return self._rng.random() * 100.0 < self.spec.rate_pct

    def flip(self, data: bytes) -> bytes:
        with self._lock:
            return _flip_bytes(data, self._rng, self.spec.byte_flips)

    def wire_kind_matches(self, msg: pb.Msg) -> bool:
        return type(msg.type).__name__ in self.spec.msg_kinds

    def attacks_transfer(self) -> bool:
        """Is this spec a snapshot state-transfer stream attack?  The
        DSL names the surface ``msg_kinds=("SnapshotChunk",)`` — not a
        pb wire type, so the pb-frame manglers never match it."""
        return "SnapshotChunk" in self.spec.msg_kinds and self.spec.kind in (
            "corrupt",
            "censor",
        )

    def applies_to_transfer_edge(self, a: int, b: int) -> bool:
        """Does this adversary attack transfer frames on edge a -> b?
        ``node`` scopes the compromised sender/link (-1 = any edge);
        ``victims`` optionally restricts the fetching side."""
        if not self.attacks_transfer():
            return False
        spec = self.spec
        if spec.victims and b not in spec.victims:
            return False
        return spec.node < 0 or spec.node == a

    def mangle_transfer(self, body: bytes):
        """Apply this adversary to one transfer frame body; returns None
        (untouched) or the replacement list.  Only CHUNK frames are
        attacked — they carry the snapshot bytes whose digest chain the
        fetcher must hold against exactly this adversary."""
        if not self.active() or not self.fires():
            return None
        try:
            kind, _pos = wire.decode_varint(body, 0)
        except ValueError:
            return None
        if kind != _KIND_CHUNK:
            return None
        if self.spec.kind == "censor":
            with self._lock:
                self.censored_transfer += 1
            return []
        # Corrupt: alternate bit-flips with tail truncation, both of
        # which the fetcher's chained digests must catch.
        with self._lock:
            truncate = len(body) > 2 and self._rng.random() < 0.5
        if truncate:
            mutated = body[: max(1, len(body) // 2)]
        else:
            mutated = self.flip(body)
        with self._lock:
            self.corrupted_transfer += 1
        return [mutated]

    def applies_to_mac_edge(self, a: int, b: int) -> bool:
        """Does this adversary forge MAC tags on directed edge a -> b?"""
        spec = self.spec
        if spec.kind != "forge_mac":
            return False
        if spec.victims and b not in spec.victims:
            return False
        return spec.node < 0 or spec.node == a

    def mangle_mac(self, payload: bytes):
        """Flip one byte of the frame's trailing MAC tag: the frame stays
        structurally parseable (varints and message body untouched), so
        the receiver's rejection is attributable to the authenticator
        check alone.  Returns the forged payload, or None to pass."""
        if not self.active() or not self.fires():
            return None
        if len(payload) <= _MAC_TAG_LEN:
            return None
        with self._lock:
            pos = len(payload) - 1 - self._rng.randrange(_MAC_TAG_LEN)
            mask = self._rng.randint(1, 255)
            self.forged_macs += 1
        forged = bytearray(payload)
        forged[pos] ^= mask
        return bytes(forged)

    def applies_to_edge(self, a: int, b: int) -> bool:
        """Does this adversary attack frames on directed edge a -> b?"""
        spec = self.spec
        if self.attacks_transfer():
            return False  # transfer-lane attack, not a pb wire attack
        if spec.kind == "equivocate":
            return spec.node == a and b in spec.victims
        if spec.kind == "censor":
            return spec.node == b
        if spec.kind in ("corrupt", "flood"):
            if spec.msg_kinds == ("Propose",):
                return False  # client-seam attack, not a wire attack
            return spec.node < 0 or spec.node == a
        return False

    def mangle_wire(self, msg: pb.Msg):
        """Apply this adversary to one framed message; returns None
        (untouched) or the replacement list."""
        spec = self.spec
        inner = msg.type
        if not self.active():
            return None
        if spec.kind == "equivocate":
            if not isinstance(inner, pb.Preprepare) or not inner.batch:
                return None
            if not self.fires():
                return None
            variant_batch = [
                pb.RequestAck(
                    client_id=ack.client_id,
                    req_no=ack.req_no,
                    digest=_variant_digest(ack.digest),
                )
                for ack in inner.batch
            ]
            with self._lock:
                self.variants[(inner.epoch, inner.seq_no)] = (
                    tuple(ack.digest for ack in inner.batch),
                    tuple(ack.digest for ack in variant_batch),
                )
            return [
                pb.Msg(
                    type=pb.Preprepare(
                        seq_no=inner.seq_no,
                        epoch=inner.epoch,
                        batch=variant_batch,
                    )
                )
            ]
        if spec.kind == "censor":
            if isinstance(inner, pb.RequestAck):
                pair = (inner.client_id, inner.req_no)
            elif isinstance(inner, pb.ForwardRequest):
                ack = inner.request_ack
                if ack is None:
                    return None
                pair = (ack.client_id, ack.req_no)
            else:
                return None
            if pair[0] not in spec.victims:
                return None
            with self._lock:
                self.censored += 1
                self.censored_pairs.add(pair)
            return []
        if not self.wire_kind_matches(msg) or not self.fires():
            return None
        if spec.kind == "flood":
            with self._lock:
                self.flooded += spec.copies
            return [msg] * (1 + spec.copies)
        if spec.kind == "corrupt":
            mutated = self._corrupt_msg(inner)
            if mutated is None:
                return None
            with self._lock:
                self.corrupted += 1
            return [pb.Msg(type=mutated)]
        return None

    def _corrupt_msg(self, inner):
        if isinstance(inner, pb.RequestAck):
            return pb.RequestAck(
                client_id=inner.client_id,
                req_no=inner.req_no,
                digest=self.flip(inner.digest),
            )
        if isinstance(inner, pb.Prepare):
            return pb.Prepare(
                seq_no=inner.seq_no,
                epoch=inner.epoch,
                digest=self.flip(inner.digest),
            )
        if isinstance(inner, pb.Commit):
            return pb.Commit(
                seq_no=inner.seq_no,
                epoch=inner.epoch,
                digest=self.flip(inner.digest),
            )
        if isinstance(inner, pb.ForwardRequest):
            return pb.ForwardRequest(
                request_ack=inner.request_ack,
                request_data=self.flip(inner.request_data),
            )
        if isinstance(inner, pb.Preprepare) and inner.batch:
            with self._lock:
                index = self._rng.randrange(len(inner.batch))
            batch = list(inner.batch)
            victim = batch[index]
            batch[index] = pb.RequestAck(
                client_id=victim.client_id,
                req_no=victim.req_no,
                digest=self.flip(victim.digest),
            )
            return pb.Preprepare(
                seq_no=inner.seq_no, epoch=inner.epoch, batch=batch
            )
        return None


class LiveCluster:
    """The driver: boots N replicas behind partition proxies, runs the
    paced client load, fires the scenario's fault schedule at scaled
    wall-clock instants, and reports convergence evidence."""

    def __init__(
        self,
        scenario: Scenario,
        seed: int,
        tick_seconds: float,
        budget_s: float,
        max_reqs_per_client: int,
        processor: str = "cuda",
        device="cuda",
    ):
        self.scenario = scenario
        self.seed = seed
        self.tick_seconds = tick_seconds
        self.budget_s = budget_s
        # Executor kind every replica builds (Config.processor): the same
        # fault matrix must hold under serial, pooled, and pipelined, on
        # the host or on the card's kernels.
        self.processor = processor
        self.device = resolve_device(device)
        # Live runs pay real fsyncs per commit; the deterministic matrix's
        # larger request counts (sized for client-window coverage) are
        # clamped so each scenario stays inside its wall-clock budget.
        self.reqs_per_client = min(scenario.reqs_per_client, max_reqs_per_client)
        # A scenario-supplied network state (e.g. a short max_epoch_length
        # for bucket-rotation scenarios) is mirrored into the live boot;
        # its client ids then ARE the live client ids, so client-targeted
        # adversaries mean the same thing under both engines.
        self._boot_state = (
            scenario.network_state() if scenario.network_state else None
        )
        if self._boot_state is not None:
            self.clients = [c.id for c in self._boot_state.clients]
        else:
            self.clients = list(range(1, scenario.client_count + 1))
        self.live_adversaries = [
            _LiveAdversary(spec, self, seed * 1013 + index)
            for index, spec in enumerate(scenario.adversaries)
        ]
        self._censors = [
            adv
            for adv in self.live_adversaries
            if adv.spec.kind == "censor" and not adv.attacks_transfer()
        ]
        self._propose_corrupters = [
            adv
            for adv in self.live_adversaries
            if adv.spec.kind == "corrupt"
            and adv.spec.msg_kinds == ("Propose",)
        ]
        self._propose_flooders = [
            adv
            for adv in self.live_adversaries
            if adv.spec.kind == "flood" and adv.spec.msg_kinds == ("Propose",)
        ]
        # (client_id, req_no) -> epoch rotations observed when the
        # censored request first committed anywhere (censorship-liveness
        # evidence, mirroring the deterministic runner).
        self.commit_rotations: dict = {}
        # (client_id, req_no) -> epoch rotations read at the request's
        # first apply on any replica.  The JAX package's driver reads the
        # rotation when its 0.2 s poll first sees the commit; epochs of 40
        # sequences at a 40 ms tick rotate faster than that, so its count
        # runs up to two rotations late.
        self.first_commit_rotation: dict = {}
        # Nodes that suspected the first working epoch before they had
        # applied anything (_SuspectWatch).
        self.suspected_before_commit: set = set()
        # MAC-authenticated replica channels: one cluster-wide secret
        # (derived from the seed so runs are reproducible); every
        # replica's transport derives per-link keys from it.
        self.auth_secret = (
            b"mirbft-live-auth-%d" % seed if scenario.link_auth else b""
        )
        self.root = tempfile.mkdtemp(prefix=f"mirbft-live-{scenario.name}-")
        self.replicas: list = [None] * scenario.node_count
        self.ports = [0] * scenario.node_count
        # node -> digest launches of its killed incarnations.
        self.digest_launches = [0] * scenario.node_count
        self.proxies: dict = {}  # (src, dst) -> PartitionProxy
        self.drop_fault = (
            DropFault(scenario.drop_pct, seed) if scenario.drop_pct else None
        )
        self._lock = threading.Lock()
        self.commit_times_ms: list = []
        self.heal_times_ms: list = []
        self.snapshots: list = []
        self.events_fired = 0
        self.requests: dict = {}
        self.signer = None
        self.plane = None
        self.forged_rejected = None
        self._start = None
        self._proposer_stop = threading.Event()
        self._proposer = None
        # Set once the proposer's first pass, the forged-request probe
        # included, is over: convergence waits for it.  The JAX package's
        # driver does not, so a probe still verifying when the last
        # request commits reads as a forged request let through.
        self._first_pass = threading.Event()
        if scenario.signed:
            from ..testengine.signing import (
                SignaturePlane,
                batch_verifier,
                make_signer,
            )

            self.signer = make_signer()
            self.plane = (
                scenario.signature_plane(self.device)
                if scenario.signature_plane
                else SignaturePlane(batch_verifier(self.device),
                                    breaker=CircuitBreaker())
            )

    # -- time ----------------------------------------------------------------

    def scale_s(self, sim_ms: int) -> float:
        """Simulated ms (authored against the 500ms testengine tick) to
        wall seconds under this cluster's real tick period."""
        return sim_ms / SIM_TICK_MS * self.tick_seconds

    def now_ms(self) -> int:
        return int((time.monotonic() - self._start) * 1000)

    def _on_commit(self, _node_id: int, commits: list) -> None:
        with self._lock:
            self.commit_times_ms.append(self.now_ms())
            fresh = self._censors and any(
                (c, q) not in self.first_commit_rotation
                for c, q, _s in commits
            )
        if not fresh:
            return
        rotation = self._current_rotation()
        with self._lock:
            # Two replicas may apply the same entry at once: the earlier
            # reading wins, since rotations only grow.
            for c, q, _s in commits:
                seen = self.first_commit_rotation.get((c, q), rotation)
                self.first_commit_rotation[(c, q)] = min(seen, rotation)

    def note_early_suspicion(self, node_id: int) -> None:
        with self._lock:
            self.suspected_before_commit.add(node_id)

    # -- topology ------------------------------------------------------------

    def alive_replicas(self) -> list:
        return [r for r in self.replicas if r is not None]

    def boot(self) -> None:
        state = self._boot_state or standard_initial_network_state(
            self.scenario.node_count, self.clients
        )
        for n in range(self.scenario.node_count):
            self.replicas[n] = LiveReplica(self, n, initial_state=state)
            self.ports[n] = self.replicas[n].port
        for a in range(self.scenario.node_count):
            for b in range(self.scenario.node_count):
                if a != b:
                    upstream = self.replicas[b].transport.address
                    mangle = self._edge_mangler(a, b)
                    mangle_transfer = self._edge_transfer_mangler(a, b)
                    mangle_raw = self._edge_raw_mangler(a, b)
                    self.proxies[(a, b)] = (
                        AdversaryProxy(
                            upstream, mangle, mangle_transfer, mangle_raw
                        )
                        if mangle is not None
                        or mangle_transfer is not None
                        or mangle_raw is not None
                        else PartitionProxy(upstream)
                    )
        for replica in self.replicas:
            replica.wire()
            replica.start_consumer()

    def _edge_mangler(self, a: int, b: int):
        """Compose the wire-attacking adversaries for directed edge
        a -> b into one frame-mangle callback, or None for honest
        edges (which then get a plain byte-pumping PartitionProxy)."""
        advs = [
            adv
            for adv in self.live_adversaries
            if adv.applies_to_edge(a, b)
        ]
        if not advs:
            return None

        def mangle(_source: int, msg: pb.Msg):
            frames = [msg]
            changed = False
            for adv in advs:
                next_frames = []
                for frame in frames:
                    replacement = adv.mangle_wire(frame)
                    if replacement is None:
                        next_frames.append(frame)
                    else:
                        changed = True
                        next_frames.extend(replacement)
                frames = next_frames
            return frames if changed else None

        return mangle

    def _edge_transfer_mangler(self, a: int, b: int):
        """Compose the snapshot-transfer-stream adversaries for directed
        edge a -> b into one body-mangle callback, or None."""
        advs = [
            adv
            for adv in self.live_adversaries
            if adv.applies_to_transfer_edge(a, b)
        ]
        if not advs:
            return None

        def mangle_transfer(body: bytes):
            bodies = [body]
            changed = False
            for adv in advs:
                next_bodies = []
                for item in bodies:
                    replacement = adv.mangle_transfer(item)
                    if replacement is None:
                        next_bodies.append(item)
                    else:
                        changed = True
                        next_bodies.extend(replacement)
                bodies = next_bodies
            return bodies if changed else None

        return mangle_transfer

    def _edge_raw_mangler(self, a: int, b: int):
        """Compose the MAC-forging adversaries for directed edge a -> b
        into one raw-payload callback, or None.  Raw manglers see the
        undecoded node-lane frame payload (varints + body + MAC tag) and
        may return a replacement payload; they run before, and preempt,
        the message-level manglers for that frame."""
        advs = [
            adv
            for adv in self.live_adversaries
            if adv.applies_to_mac_edge(a, b)
        ]
        if not advs:
            return None

        def mangle_raw(source: int, payload: bytes):
            for adv in advs:
                forged = adv.mangle_mac(payload)
                if forged is not None:
                    return forged
            return None

        return mangle_raw

    def _edges_across(self, groups):
        group_of = {}
        for gi, group in enumerate(groups):
            for node in group:
                group_of[node] = gi
        for a in range(self.scenario.node_count):
            for b in range(self.scenario.node_count):
                if a != b and group_of.get(a) != group_of.get(b):
                    yield (a, b)

    def _set_partition(self, groups, cut: bool) -> None:
        for edge in self._edges_across(groups):
            self.proxies[edge].set_cut(cut)

    def _crash(self, node: int) -> None:
        replica = self.replicas[node]
        if replica is None:
            return
        self.snapshots.append(replica.snapshot(self.now_ms()))
        self.replicas[node] = None
        replica.kill()

    def _restart(self, node: int) -> None:
        if self.replicas[node] is not None:
            # A storage-fault victim whose fsync never fired (no persist
            # traffic): force the kill so the reboot still exercises
            # restart-from-disk.
            self._crash(node)
        replica = LiveReplica(self, node, initial_state=None, port=self.ports[node])
        replica.wire()
        replica.start_consumer()
        self.replicas[node] = replica
        with self._lock:
            self.heal_times_ms.append(self.now_ms())

    # -- client load ---------------------------------------------------------

    def start_proposer(self, last_event_s: float) -> None:
        self._proposer = threading.Thread(
            target=self._propose_all,
            args=(last_event_s,),
            name="chaos-live-proposer",
            daemon=True,
        )
        self._proposer.start()

    def _propose_all(self, last_event_s: float) -> None:
        requests: dict = {}
        for req_no in range(self.reqs_per_client):
            for client_id in self.clients:
                payload = b"%d" % req_no
                data = (
                    self.signer(client_id, req_no, payload)
                    if self.signer is not None
                    else payload
                )
                requests[(client_id, req_no)] = data
        self.requests = requests
        # Pace the initial pass past the last fault instant so every
        # disruption lands mid-traffic AND a tail of fresh proposals
        # arrives after the final heal — the commit-resumption invariant
        # measures real post-heal progress, not leftovers.
        span_s = max(last_event_s * 1.25, 0.4)
        gap = span_s / max(len(requests), 1)
        for (client_id, req_no), data in requests.items():
            if self._proposer_stop.wait(gap):
                return
            if self.plane is not None and not self.plane.valid(
                client_id, req_no, data
            ):
                continue  # ingress auth rejected (never for honest clients)
            for replica in self.alive_replicas():
                self._adversarial_deliver(replica, client_id, req_no, data)
        if self.plane is not None:
            # Ingress authentication must stop a forged request cold: the
            # real payload with one signature byte flipped.
            client_id = self.clients[0]
            good = requests[(client_id, 0)]
            forged = good[:-96] + bytes([good[-96] ^ 0xFF]) + good[-95:]
            self.forged_rejected = not self.plane.valid(client_id, 0, forged)
        self._first_pass.set()
        # Client retry: keep nudging stragglers (restarted nodes, frames
        # lost to drops/partitions) until the driver declares convergence.
        # Re-proposing an already-committed req_no is safe: the ack
        # filter drops below-watermark acks as PAST.
        while not self._proposer_stop.wait(0.3):
            for replica in self.alive_replicas():
                committed = {(c, q) for c, q, _s in replica.app_log.commits}
                for (client_id, req_no), data in requests.items():
                    if (client_id, req_no) not in committed:
                        self._adversarial_deliver(
                            replica, client_id, req_no, data
                        )
                # Stale-echo flood: while the attack window is open, an
                # already-committed request is re-submitted per round —
                # the live analogue of the DSL's delayed echoes, which
                # watermark dedup must drop as PAST.
                for adv in self._propose_flooders:
                    if committed and adv.active() and adv.fires():
                        client_id, req_no = next(iter(committed))
                        self._propose_one(
                            replica,
                            client_id,
                            req_no,
                            requests.get((client_id, req_no), b""),
                        )
                        with adv._lock:
                            adv.flooded += 1

    def _adversarial_deliver(self, replica, client_id, req_no, data) -> None:
        """One client->replica delivery through the adversary layer:
        censoring leaders never learn the request, corrupted deliveries
        must die at the ingress signature gate, flooded deliveries are
        multiplied."""
        for adv in self._censors:
            if (
                replica.node_id == adv.spec.node
                and client_id in adv.spec.victims
                and adv.active()
            ):
                with adv._lock:
                    adv.censored += 1
                    adv.censored_pairs.add((client_id, req_no))
                return
        for adv in self._propose_corrupters:
            spec = adv.spec
            if (
                (not spec.victims or replica.node_id in spec.victims)
                and adv.active()
                and adv.fires()
            ):
                bad = adv.flip(data)
                with adv._lock:
                    adv.corrupted += 1
                    adv.corrupted_proposes += 1
                if self.plane is not None and not self.plane.valid(
                    client_id, req_no, bad
                ):
                    with adv._lock:
                        adv.rejections += 1
                    return  # ingress auth refused the corrupted delivery
                # Unsigned (or a verification hole): the corrupted bytes
                # go in and the digest audit must catch any divergence.
                self._propose_one(replica, client_id, req_no, bad)
                return
        self._propose_one(replica, client_id, req_no, data)
        for adv in self._propose_flooders:
            if adv.active() and adv.fires():
                for _ in range(adv.spec.copies):
                    self._propose_one(replica, client_id, req_no, data)
                with adv._lock:
                    adv.flooded += adv.spec.copies

    def _propose_one(self, replica, client_id, req_no, data) -> None:
        try:
            replica.node.propose(
                pb.Request(client_id=client_id, req_no=req_no, data=data)
            )
        except (NodeStopped, ValueError):
            pass  # node stopped/crashed concurrently: the retry pass covers it

    # -- the drive loop ------------------------------------------------------

    def schedule(self) -> list:
        events = []
        for window in self.scenario.partitions:
            events.append((self.scale_s(window.from_ms), 0, "cut", window.groups))
            events.append((self.scale_s(window.until_ms), 1, "heal", window.groups))
        for point in self.scenario.crashes:
            events.append((self.scale_s(point.at_ms), 2, "crash", point.node))
            events.append(
                (
                    self.scale_s(point.at_ms + point.restart_delay_ms),
                    3,
                    "restart",
                    point.node,
                )
            )
        for fault in self.scenario.storage_faults:
            events.append(
                (self.scale_s(fault.at_ms), 4, "storage_fault", fault.node)
            )
            events.append(
                (
                    self.scale_s(fault.at_ms + fault.restart_delay_ms),
                    5,
                    "restart",
                    fault.node,
                )
            )
        events.sort(key=lambda e: (e[0], e[1]))
        return events

    def _fire(self, kind: str, payload, armed: set) -> None:
        if kind == "cut":
            self._set_partition(payload, True)
        elif kind == "heal":
            self._set_partition(payload, False)
            with self._lock:
                self.heal_times_ms.append(self.now_ms())
        elif kind == "crash":
            self._crash(payload)
        elif kind == "storage_fault":
            replica = self.replicas[payload]
            if replica is not None:
                replica.arm_storage_fault()
                armed.add(payload)
        elif kind == "restart":
            self._restart(payload)

    def _reap(self, armed: set) -> None:
        """Crash-kill replicas whose consumer died on an injected storage
        fault; any *uninjected* death is a real bug and fails the run."""
        for n, replica in enumerate(self.replicas):
            if replica is None:
                continue
            if replica.failed is not None:
                if n in armed:
                    self._crash(n)
                else:
                    raise InvariantViolation(
                        f"node {n} consumer died without an injected fault: "
                        f"{replica.failed!r}"
                    )
            elif replica.node.exit_error is not None:
                raise InvariantViolation(
                    f"node {n} serializer died: {replica.node.exit_error!r}"
                )

    def _converged(self, expected: set) -> bool:
        """The TCP-tier convergence criterion: every node is up, at least
        one committed the full request set, and all app chains agree (a
        restarted node may have adopted part of the history via state
        transfer rather than committing it individually)."""
        replicas = list(self.replicas)
        if any(r is None for r in replicas) or not self._first_pass.is_set():
            return False
        full = False
        chains = set()
        for replica in replicas:
            pairs = {(c, q) for c, q, _s in replica.app_log.commits}
            if expected <= pairs:
                full = True
            chains.add(replica.app_log.chain)
        return full and len(chains) == 1 and b"" not in chains

    def _await_persisted_boot(self) -> None:
        """Start the fault clock once every replica's bootstrap log is
        fsynced.  A crash before that leaves an empty WAL, which
        ``Node.restart`` refuses.  The JAX package's driver starts its
        clock before boot, so a node whose first step is slow (its first
        step imports numpy, which a cold process has not loaded) is still
        unpersisted at an early crash instant: ``crash-restart``'s first
        crash lands 0.24 s in (ROADMAP queue 3).  Fault instants stay as
        authored, counted from this start."""
        deadline = time.monotonic() + BOOT_PERSIST_TIMEOUT_S
        while not all(r.wal.persisted() for r in self.replicas):
            self._reap(set())
            if time.monotonic() >= deadline:
                raise InvariantViolation(
                    f"bootstrap logs not on disk within "
                    f"{BOOT_PERSIST_TIMEOUT_S:.0f}s"
                )
            time.sleep(0.002)
        self._start = time.monotonic()

    def run(self) -> int:
        """Boot, drive the schedule, and return the convergence instant
        (wall ms since start); raises InvariantViolation on timeout or an
        uninjected node death."""
        self._start = time.monotonic()
        self.boot()
        self._await_persisted_boot()
        events = self.schedule()
        last_event_s = events[-1][0] if events else 0.0
        self.start_proposer(last_event_s)
        expected = {
            (client_id, req_no)
            for client_id in self.clients
            for req_no in range(self.reqs_per_client)
        }
        deadline = self._start + self.budget_s
        armed: set = set()
        while time.monotonic() < deadline:
            now_s = time.monotonic() - self._start
            while events and events[0][0] <= now_s:
                _at, _order, kind, payload = events.pop(0)
                self.events_fired += 1
                self._fire(kind, payload, armed)
            self._reap(armed)
            if not events and self._converged(expected):
                if self._censors:
                    self._track_censored_commits()
                return self.now_ms()
            time.sleep(0.01)
        commits = [
            len(r.app_log.commits) if r is not None else None
            for r in self.replicas
        ]
        raise InvariantViolation(
            f"no convergence within the {self.budget_s:.0f}s budget "
            f"(per-node commits: {commits}, epochs: {self._epoch_states()}, "
            f"events unfired: {len(events)})"
        )

    def _current_rotation(self) -> int:
        """Epoch rotations past the boot-negotiated working epoch, read
        from the obsv ``epoch.active`` milestone labels — the same
        telemetry an operator would watch."""
        best = 0
        if hooks.enabled:
            snap = hooks.metrics.snapshot().get("mirbft_epoch_events_total")
            if snap:
                for series in snap["series"]:
                    labels = series["labels"]
                    if labels.get("event") != "active":
                        continue
                    try:
                        best = max(best, int(labels.get("epoch", "0")))
                    except ValueError:
                        continue
        return max(0, best - FIRST_WORKING_EPOCH)

    def _track_censored_commits(self) -> None:
        pending: set = set()
        for adv in self._censors:
            with adv._lock:
                pending |= adv.censored_pairs
        with self._lock:
            for pair in pending:
                if pair in self.first_commit_rotation:
                    self.commit_rotations[pair] = (
                        self.first_commit_rotation[pair]
                    )

    def _epoch_states(self) -> list:
        """Per-node ``epoch/state`` diagnostic strings for the timeout
        report (a wedged epoch change reads very differently from a
        transport-level stall)."""
        states = []
        for replica in self.replicas:
            if replica is None:
                states.append("down")
                continue
            try:
                status = replica.node.status(timeout=2.0)
            except NodeStopped:
                status = None
            if status is None or status.epoch_tracker is None:
                states.append("?")
            else:
                et = status.epoch_tracker
                states.append(f"{et.number}/{et.state}")
        return states

    def teardown(self) -> None:
        self._proposer_stop.set()
        if self._proposer is not None and self._proposer.ident is not None:
            self._proposer.join(timeout=10)
        for n, replica in enumerate(self.replicas):
            if replica is not None:
                self.replicas[n] = None
                replica.kill(graceful=True)
        for proxy in self.proxies.values():
            proxy.close()
        shutil.rmtree(self.root, ignore_errors=True)


class _LiveEvidence:
    """Adapter handing the shared invariant checkers (invariants.py) the
    recorder-shaped view they audit, backed by the cluster's durable
    per-node commit logs."""

    def __init__(self, replicas: list):
        self.node_count = len(replicas)
        self.node_states = [
            SimpleNamespace(
                committed_reqs=list(replica.app_log.commits),
                app_chain=replica.app_log.chain,
                crashed=False,
            )
            for replica in replicas
        ]
        # client_id -> committed_anywhere req_no set, for the
        # censorship-liveness audit.
        anywhere: dict = {}
        for state in self.node_states:
            for client_id, req_no, _seq in state.committed_reqs:
                anywhere.setdefault(client_id, set()).add(req_no)
        self.clients = {
            client_id: SimpleNamespace(committed_anywhere=req_nos)
            for client_id, req_nos in anywhere.items()
        }


def _epoch_active_total(registry) -> int:
    """Count obsv ``epoch.active`` milestone events for epochs *beyond*
    the boot-negotiated working epoch.  Every run activates
    FIRST_WORKING_EPOCH at startup (the bootstrap WAL's FEntry ends epoch
    0, so the cluster negotiates epoch 1 before the first commit), so
    only later activations are evidence of a forced change."""
    snap = registry.snapshot().get("mirbft_epoch_events_total")
    if not snap:
        return 0
    total = 0
    for series in snap["series"]:
        labels = series["labels"]
        if labels.get("event") != "active":
            continue
        try:
            epoch = int(labels.get("epoch", "0"))
        except ValueError:
            continue
        if epoch > FIRST_WORKING_EPOCH:
            total += series["value"]
    return int(total)


def _audit_live_adversaries(scenario, cluster, registry, result) -> None:
    """Run the Byzantine invariants over the live evidence — the same
    checkers the deterministic runner uses, fed from the cluster's
    durable commit logs and the adversaries' attack counters.  Raises
    InvariantViolation."""
    advs = cluster.live_adversaries
    if not advs and not scenario.link_auth and not scenario.cert_audit:
        return
    corrupted = sum(adv.corrupted for adv in advs)
    corrupted_proposes = sum(adv.corrupted_proposes for adv in advs)
    rejections = sum(adv.rejections for adv in advs)
    flooded = sum(adv.flooded for adv in advs)
    censored = sum(adv.censored for adv in advs)
    variants: dict = {}
    censored_pairs: set = set()
    for adv in advs:
        variants.update(adv.variants)
        censored_pairs |= adv.censored_pairs
    evidence = _LiveEvidence(cluster.replicas)

    if corrupted:
        result.counters["corrupted"] = corrupted
    if scenario.signed and corrupted_proposes:
        result.counters["rejections"] = rejections
        check_corruption_rejected(rejections, corrupted_proposes)
    if variants:
        result.counters["equivocated"] = len(variants)
        # Suspicion (expect_epoch_change) is asserted separately via the
        # epoch.active milestones, which live nodes emit; here the live
        # audit holds the no-fork half of the equivocation invariant.
        check_no_fork_under_equivocation(
            evidence, variants, expect_suspicion=False
        )
    if cluster._censors:
        result.counters["censored"] = censored
        result.counters["suspected_before_commit"] = sorted(
            cluster.suspected_before_commit
        )
        k = scenario.notes.get("censor_k", 3)
        check_censorship_liveness(
            evidence, censored_pairs, cluster.commit_rotations, k
        )
        rotations = list(cluster.commit_rotations.values())
        result.counters["rotations_max"] = max(rotations, default=0)
        histogram = registry.histogram(
            "mirbft_censored_commit_epochs",
            buckets=ROTATION_BUCKETS,
            scenario=scenario.name,
        )
        for rotation in rotations:
            histogram.observe(rotation)
    if any(adv.attacks_transfer() for adv in advs):
        transfer_corrupted = sum(adv.corrupted_transfer for adv in advs)
        transfer_censored = sum(adv.censored_transfer for adv in advs)
        result.counters["transfer_corrupted"] = transfer_corrupted
        result.counters["transfer_censored"] = transfer_censored
        rejected = sum(
            replica.engine.counters["chunks_rejected_corrupt"]
            for replica in cluster.alive_replicas()
        )
        result.counters["transfer_rejected"] = rejected
        if transfer_corrupted:
            check_transfer_corruption_rejected(rejected, transfer_corrupted)
        elif transfer_censored <= 0:
            raise InvariantViolation(
                "transfer attack touched no frames (vacuous)"
            )
    if any(adv.spec.kind == "flood" for adv in advs):
        result.counters["flooded"] = flooded
        if flooded <= 0:
            raise InvariantViolation(
                "flood scenario injected no echoes (vacuous)"
            )
        # Exactly-once is already held by check_no_fork on the durable
        # logs; bounded memory is held at the request-store seam (echoes
        # deduplicate to at most one pending entry per distinct request).
        total = len(cluster.clients) * cluster.reqs_per_client
        for replica in cluster.alive_replicas():
            pending = replica.reqstore.pending_count()
            if pending > total:
                raise InvariantViolation(
                    f"flood grew node {replica.node_id}'s request store "
                    f"to {pending} pending entries for {total} distinct "
                    "requests"
                )
    if scenario.link_auth and any(
        adv.spec.kind == "forge_mac" for adv in advs
    ):
        forged = sum(adv.forged_macs for adv in advs)
        mac_rejections = sum(
            sum(replica.transport.mac_rejections.values())
            for replica in cluster.alive_replicas()
        )
        result.counters["forged_macs"] = forged
        result.counters["mac_rejections"] = mac_rejections
        # Live audit is lossy (a forged frame can die with a torn-down
        # connection before the receiver's MAC check sees it), so the
        # bound is 0 < rejections <= forged; the none-accepted half is
        # held by no-fork/convergence on the durable logs.
        check_mac_rejected(mac_rejections, forged, exact=False)
    if scenario.cert_audit:
        _audit_live_certs(scenario, cluster, result)


def _audit_live_certs(scenario, cluster, result) -> None:
    """Re-derive aggregate checkpoint certificates from the live nodes'
    captured checkpoints and run the forgery audit through the qc seam:
    every quorum of matching stable checkpoints yields one BLS aggregate
    certificate, each genuine certificate must verify, and per-cert
    forgeries (mismatched statement, wrong signer set) must all be
    rejected.  Raises InvariantViolation."""
    from ..crypto import qc
    from ..testengine.certs import node_seed, statement

    f = (scenario.node_count - 1) // 3
    quorum = 2 * f + 1
    stable: dict = {}
    for replica in cluster.alive_replicas():
        for seq, (value, _state) in replica.checkpoints.items():
            stable.setdefault((seq, value), set()).add(replica.node_id)
    certs: dict = {}
    for (seq, value), nodes in sorted(stable.items()):
        signers = tuple(sorted(nodes)[:quorum])
        if len(signers) < quorum:
            continue
        votes = [
            qc.sign_vote(node_seed(n), statement(seq, value))
            for n in signers
        ]
        certs[(seq, value)] = (
            signers,
            qc.aggregate(votes, use_device=True, device=cluster.device),
        )
    if not certs:
        raise InvariantViolation(
            "cert audit found no quorum-stable checkpoints (vacuous)"
        )
    genuine_ok, genuine_total, forged_rejected, forged_total = (
        audit_aggregate_certs(certs)
    )
    result.counters["certs"] = genuine_total
    result.counters["cert_forgeries_rejected"] = forged_rejected
    check_aggregate_cert_rejected(
        genuine_ok, genuine_total, forged_rejected, forged_total
    )


def run_live_scenario(
    scenario: Scenario,
    seed: int = 0,
    registry: Registry | None = None,
    tick_seconds: float = 0.04,
    budget_s: float = 90.0,
    max_reqs_per_client: int = 40,
    processor: str = "cuda",
    device="cuda",
) -> ScenarioResult:
    """Execute one scenario against a real loopback cluster and audit
    every invariant.  Invariant violations are reported in the result,
    never raised; harness bugs propagate.  The replicas build
    ``processor`` and every kernel runs on ``device`` (``cuda`` unless
    the caller asks for ``cpu``).

    Observability is required (epoch milestones and transport counters
    are part of the evidence): if hooks are not already enabled, they are
    enabled around the run with ``registry`` (or a fresh one) and
    restored after."""
    device = resolve_device(device)
    launches_before = kernel_launches()
    own_hooks = not hooks.enabled
    if own_hooks:
        hooks.enable(
            registry=registry if registry is not None else Registry(),
            trace=False,
        )
    registry = hooks.metrics
    # Reuse the session flight recorder if one is wired; otherwise lend a
    # scenario-local ring to the hooks so node milestones land in the
    # postmortem dump attached on invariant failure.
    recorder = hooks.recorder
    own_recorder = recorder is None
    if own_recorder:
        recorder = FlightRecorder(f"chaos-live-{scenario.name}")
        hooks.recorder = recorder
    recorder.record_note(
        "scenario.start", args={"scenario": scenario.name, "seed": seed}
    )
    result = ScenarioResult(name=scenario.name, seed=seed, passed=False)
    epoch_active_before = _epoch_active_total(registry)
    cluster = LiveCluster(
        scenario,
        seed,
        tick_seconds,
        budget_s,
        max_reqs_per_client,
        processor=processor,
        device=device,
    )
    try:
        try:
            converged_ms = cluster.run()
            heals = cluster.heal_times_ms
            last_heal = max(heals) if heals else 0
            bound_ms = max(
                int(cluster.scale_s(scenario.recovery_bound_ms) * 1000),
                MIN_RECOVERY_BOUND_MS,
            )
            gauge = registry.gauge(
                "mirbft_chaos_live_recovery_ms", scenario=scenario.name
            )
            gauge.set(converged_ms - last_heal)
            result.counters["recovery_ms"] = gauge.value
            check_bounded_recovery(converged_ms, last_heal, bound_ms)
            if heals:
                check_commit_resumption(
                    cluster.commit_times_ms, last_heal, bound_ms
                )
            evidence = _LiveEvidence(cluster.replicas)
            check_no_fork(evidence)
            check_durable_prefix(evidence, cluster.snapshots)
            # Live form of check_no_vector_divergence: the oracle must run
            # on each serializer thread (the tracker is thread-confined),
            # so ask every live node to audit itself.
            divergences = 0
            for replica in cluster.alive_replicas():
                try:
                    divs = replica.node.audit_divergence(timeout=5.0)
                except Exception:
                    divs = None  # stopping/stopped replica: nothing to audit
                if divs:
                    divergences += len(divs)
                    first = divs[0]
                    raise InvariantViolation(
                        f"node {replica.node_id}: vector ack path diverged "
                        f"from the scalar reference in {len(divs)} place(s); "
                        f"first: {first['component']} at client "
                        f"{first['client_id']} req_no {first['req_no']} "
                        f"({first['detail']})"
                    )
            result.counters["divergences"] = divergences
            if scenario.expect_epoch_change:
                delta = _epoch_active_total(registry) - epoch_active_before
                result.counters["epoch_active_events"] = delta
                if delta <= 0:
                    raise InvariantViolation(
                        "scenario expected an epoch change but the obsv "
                        "epoch.active milestone never fired past the boot "
                        f"epoch ({FIRST_WORKING_EPOCH})"
                    )
                epochs = []
                for replica in cluster.alive_replicas():
                    status = replica.node.status(timeout=5.0)
                    if status is not None and status.epoch_tracker is not None:
                        epochs.append(status.epoch_tracker.number)
                result.counters["epoch"] = max(epochs) if epochs else 0
                # Every run negotiates FIRST_WORKING_EPOCH at boot, so a
                # node still there has seen no change at all.
                if not epochs or max(epochs) <= FIRST_WORKING_EPOCH:
                    raise InvariantViolation(
                        "scenario expected an epoch change but every node "
                        f"still reports the boot epoch (epochs {epochs})"
                    )
            if cluster.plane is not None:
                result.counters["sig_device_errors"] = (
                    cluster.plane.device_errors
                )
                result.counters["sig_fallbacks"] = (
                    cluster.plane.fallback_verifies
                )
                result.counters["sig_breaker"] = cluster.plane.breaker.state
                result.counters["sig_breaker_trips"] = (
                    cluster.plane.breaker.trips
                )
                result.counters["sig_breaker_probes"] = (
                    cluster.plane.breaker.probes
                )
                result.counters["sig_device_retries"] = (
                    cluster.plane.device_retries
                )
                if cluster.forged_rejected is not True:
                    raise InvariantViolation(
                        "a forged request passed ingress signature "
                        "verification"
                    )
            _audit_live_adversaries(scenario, cluster, registry, result)
            result.passed = True
        except InvariantViolation as violation:
            result.violation = str(violation)
            result.dump = dump_on_violation(
                recorder, scenario.name, seed, violation
            )
        result.events = cluster.events_fired
        result.sim_ms = cluster.now_ms() if cluster._start is not None else 0
        result.commits = sum(
            len(replica.app_log.commits)
            for replica in cluster.alive_replicas()
        )
        if cluster.snapshots:
            result.counters["crashes"] = len(cluster.snapshots)
        tcp = {"connects": 0, "connect_failures": 0, "send_failures": 0}
        dropped_fault = 0
        for replica in cluster.alive_replicas():
            counters = replica.transport.counters()
            dropped_fault += counters["dropped_fault"]
            for peer in counters["peers"].values():
                tcp["connects"] += peer["connects"]
                tcp["connect_failures"] += peer["connect_failures"]
                tcp["send_failures"] += peer["send_failures"]
        result.counters["tcp_connects"] = tcp["connects"]
        if tcp["connect_failures"]:
            result.counters["tcp_connect_failures"] = tcp["connect_failures"]
        if tcp["send_failures"]:
            result.counters["tcp_send_failures"] = tcp["send_failures"]
        if dropped_fault:
            result.counters["dropped_fault"] = dropped_fault
        # The port's own: each node's digest launches over all its
        # incarnations, and each kernel's launches in this run.
        launches = list(cluster.digest_launches)
        for replica in cluster.alive_replicas():
            launches[replica.node_id] += getattr(
                replica.processor, "launches", 0
            )
        result.counters["digest_launches"] = launches
        after = kernel_launches()
        for name, count in launches_before.items():
            result.counters[name] = after[name] - count
    finally:
        cluster.teardown()
        if own_recorder and hooks.recorder is recorder:
            hooks.recorder = None
        if own_hooks:
            hooks.disable()
    return result


def run_live_campaign(
    scenarios: list | None = None,
    seed: int = 0,
    tick_seconds: float = 0.04,
    budget_s: float = 90.0,
    processor: str = "cuda",
    device="cuda",
) -> CampaignResult:
    """Run a scenario list (default: the live matrix) against real
    clusters, one at a time, under derived per-scenario seeds, with
    ``processor`` replicas and the kernels on ``device``."""
    device = resolve_device(device)
    if scenarios is None:
        scenarios = live_matrix()
    campaign = CampaignResult(seed=seed)
    for index, scenario in enumerate(scenarios):
        campaign.results.append(
            run_live_scenario(
                scenario,
                seed=seed + index,
                tick_seconds=tick_seconds,
                budget_s=budget_s,
                processor=processor,
                device=device,
            )
        )
    return campaign
