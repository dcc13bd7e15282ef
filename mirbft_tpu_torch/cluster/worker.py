"""The per-node worker process: one OS process per consensus node.

``python -m mirbft_tpu_torch.cluster --spec <node_dir>/spec.json`` runs one
node end to end: storage under the node directory, a serializer-owned
protocol core (``runtime.Node``), a ``TcpTransport`` mesh link, and the
standard consumer loop driving the selected processor.  The supervisor
(supervisor.py) owns process lifecycle; this module owns everything that
happens inside one process.

The spec's ``device`` names the card the worker's kernels run on:
``cuda`` (the default) or ``cpu`` (their plain versions).  A worker asked
for ``cuda`` on a machine without a card writes why to its log and exits
nonzero at boot; it never carries on on the host.  The processor is the
spec's ``processor`` kind, the port's ``cuda`` by default: every digest of
an Actions batch in one launch of the SHA-256 kernel.  With
``signed_ingress`` the client requests pass the Ed25519 kernels
(``signing.batch_verifier(device)``) before they reach ``node.propose``,
and every batch the verifier is handed is journaled with its verdicts
(``_BatchJournal``), so a caller can replay each launch, count the
launches a batch should have made and see that no forgery was admitted.

Boot is a two-phase handshake over the shared filesystem (every process
runs on one host — the multi-*process* cluster is about real OS-level
isolation, kill -9 fidelity, and true parallelism, not distribution):

1. The worker binds its transport + metrics ports, then atomically
   writes ``address.json`` (tmp + rename) with its pid and bound ports.
   ``/healthz`` reports ``ready: false`` during this window.
2. The supervisor collects every node's ``address.json``, builds the
   (optionally proxied) peer address map, and writes ``peers.json`` into
   each node directory.  The worker polls for that file, dials every
   peer, applies the spec's per-link latency profile, starts its
   consumer loop, and flips ``/healthz`` to ``ready: true`` once its
   bootstrap log is fsynced — so one HTTP poll tells the supervisor the
   true mesh is wired and a SIGKILL from then on leaves a WAL that
   ``Node.restart`` accepts.  (The JAX worker goes ready before its first
   persist; a crash that lands first leaves an empty WAL and its restart
   dies, ROADMAP queue 3.)

State transfer runs over the real transport: each worker feeds its
stable checkpoints (app chain + uncommitted-request slice) to a
``runtime.transfer.TransferEngine``, which serves digest-chained
snapshot chunks to behind peers on the transport's reserved transfer
lane and fetches/verifies/installs them when this node is the one
behind (staging the verified blob under the node dir, so SIGKILL
mid-transfer resumes without the network after restart).  Workers still
append every checkpoint they compute to ``checkpoints.jsonl`` — the
supervisor's progress monitor reads it — and periodically publish the
engine's counters to ``transfer.json`` for the chaos audits, with the
wall-clock time of every install.  In KV mode ``app.json`` carries the
commit stream's status and the KvStore's digest (the SHA-256 of its
snapshot, recomputed only when the applied index moved), so replicas can
be compared byte for byte from outside.
Checkpoint records are soft state — rebuilt from consensus on restart —
so they are flushed but not fsynced.

Each incarnation also publishes its kernel evidence to
``kernels-<pid>.json`` on the same cadence and at a graceful stop: its
processor's launches and digests (device and host), each kernel
wrapper's launch count in this process, and the ingress stage's batches
and verify errors.  A SIGKILLed incarnation leaves its last publication,
so the supervisor sums every incarnation of a node.

Workers also re-poll ``peers.json`` while running: when the supervisor
grows the mesh (``join_node``), every incumbent picks up the newcomer's
address on the next poll and dials it, so the joiner can receive
checkpoint broadcasts and serve/fetch snapshots without any restart.

On SIGTERM the worker drains the processor, closes storage cleanly, and
dumps a final ``metrics.json`` registry snapshot; SIGKILL (the chaos
crash path) gets none of that, which is exactly the point.  A fault
raised while the processor drains (a device fault surfacing at the last
readback) is written to the log and the worker exits 5; an ingress
stage that failed a verify launch exits 6.

Exit codes: 0 a clean stop, 2 boot or wiring failed, 3 the consumer loop
died, 4 the serializer died, 5 the processor's drain raised, 6 a verify
launch of the ingress stage failed.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time

from .. import pb
from ..app import AppLog, DurableChainLog, KvFrontend, KvService, KvStore
from ..chaos.live import _TransportDuct
from ..obsv import hooks
from ..obsv.metrics import Registry
from ..obsv.recorder import FlightRecorder
from ..obsv.resources import ResourceSampler
from ..ops import kernel_launches
from ..ops.batching import resolve_device
from ..runtime import (
    Config,
    FileRequestStore,
    FileWal,
    Node,
    build_processor,
)
from ..runtime.node import NodeStopped, standard_initial_network_state
from ..runtime.reconfig import checkpoint_network_state
from ..runtime.transfer import TransferEngine
from ..runtime.transport import TcpTransport

# How long the worker waits for the supervisor's peers.json before
# concluding it was orphaned.
_PEERS_TIMEOUT_S = 60.0

# Fixed-port rebinds retry through TIME_WAIT for this long (restart path).
_BIND_RETRY_S = 10.0

# Exit codes past the JAX worker's 2-4 (see the module docstring).
EXIT_DRAIN_FAULT = 5
EXIT_VERIFY_FAULT = 6


def write_json_atomic(path: str, payload: dict) -> None:
    """Write ``payload`` via tmp + rename so readers never see a torn
    file — the handshake files (address.json, peers.json) are polled by
    another process."""
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(payload, fh)
    os.replace(tmp, path)


def read_json(path: str) -> dict | None:
    """Best-effort read of a handshake file; None while absent."""
    try:
        with open(path, "r", encoding="utf-8") as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


class Worker:
    """One consensus node inside its own OS process."""

    def __init__(self, spec: dict):
        self.spec = spec
        self.node_id = int(spec["node_id"])
        self.dir = spec["dir"]
        self.root = spec["root"]
        self.tick_seconds = float(spec.get("tick_seconds", 0.04))
        self._stop = threading.Event()
        self.processor = None
        os.makedirs(self.dir, exist_ok=True)
        # The card first: without one a cuda worker raises here, before
        # it binds a port or touches its storage.
        self.device = str(resolve_device(spec.get("device", "cuda")))
        if self.device.startswith("cuda"):
            import torch

            torch.cuda.init()  # the sampler reads the card's allocator

        registry = Registry()
        # The black box: a bounded ring continuously autoflushed to
        # atomic segments under <dir>/flight/, so even kill -9 (which
        # skips _shutdown entirely) leaves a recent dump for the
        # supervisor to reap and `obsv --postmortem` to merge.
        self.recorder = FlightRecorder(
            self.node_id,
            dump_dir=os.path.join(self.dir, "flight"),
            capacity=int(spec.get("flight_capacity", 512)),
            autoflush_every=int(spec.get("flight_autoflush", 256)),
            registry=registry,
        )
        # Spec "trace": capture milestone instants/flows in-process and
        # dump <dir>/trace.json on graceful shutdown (clock_sync-stamped
        # at stop, so obsv --critpath / --merge can align the nodes).
        self._trace = bool(spec.get("trace", False))
        _, self.tracer = hooks.enable(
            registry=registry, trace=self._trace, recorder=self.recorder
        )
        self.wal = FileWal(os.path.join(self.dir, "wal"))
        self.reqstore = FileRequestStore(os.path.join(self.dir, "reqs"))
        # The KV app (spec "app": "kv") layers the commit stream + state
        # machine over the durable journal; journal payload mode makes
        # the journal the restart replay source for the state machine.
        self.app_kind = spec.get("app")
        self._journal = DurableChainLog(
            os.path.join(self.dir, "app.log"),
            self.node_id,
            timestamps=True,
            data_source=(
                self.reqstore.get if self.app_kind == "kv" else None
            ),
        )
        self.sampler = ResourceSampler(
            registry=registry,
            recorder=self.recorder,
            interval_s=float(spec.get("resource_interval_s", 1.0)),
            dirs={
                "wal": os.path.join(self.dir, "wal"),
                "reqstore": os.path.join(self.dir, "reqs"),
            },
            node=self.node_id,
            device=self.device,
        ).start()
        config = Config(
            id=self.node_id,
            batch_size=int(spec.get("batch_size", 1)),
            processor=spec.get("processor", Config.processor),
            metrics_port=0,
            link_auth=bool(spec.get("link_auth", False)),
            auth_secret=str(spec.get("auth_secret", "")).encode(),
        )
        self.config = config
        if spec.get("fresh", True):
            # Scenario override (join/catch-up tests shrink the window so
            # a joiner falls a full certified checkpoint behind quickly);
            # identical in every spec, so fresh boots stay deterministic.
            ci = spec.get("checkpoint_interval")
            explicit = spec.get("network_config")
            if explicit:
                # A reconfiguration boot: the genesis config is dictated
                # verbatim (for a joiner, the exact target config the
                # committed Reconfiguration carries; for incumbents, the
                # pre-reconfig member subset) — membership authority is
                # the committed op, not the process roster.
                state = pb.NetworkState(
                    config=pb.NetworkConfig(
                        nodes=[int(n) for n in explicit["nodes"]],
                        f=int(explicit["f"]),
                        number_of_buckets=int(explicit["number_of_buckets"]),
                        checkpoint_interval=int(
                            explicit["checkpoint_interval"]
                        ),
                        max_epoch_length=int(explicit["max_epoch_length"]),
                    ),
                    clients=[
                        pb.NetworkClient(id=int(cid), width=100)
                        for cid in spec["client_ids"]
                    ],
                )
            else:
                state = standard_initial_network_state(
                    int(spec["node_count"]),
                    list(spec["client_ids"]),
                    checkpoint_interval=int(ci) if ci else None,
                )
            # A provisioned-but-not-yet-running member set (join-under-
            # fire): boot every worker with the running subset as the
            # bootstrap leaders, so absent members own no buckets until
            # they actually join.
            leaders = spec.get("initial_leaders")
            self.node = Node.start_new(
                config,
                state,
                initial_leaders=(
                    [int(n) for n in leaders] if leaders else None
                ),
            )
        else:
            self.node = Node.restart(config, self.wal, self.reqstore)
        self.app_stream = None
        self.kv_service = None
        if self.app_kind == "kv":
            self.kv_store = KvStore()
            self.app_stream = self.node.attach_app(
                self.kv_store,
                state_path=os.path.join(self.dir, "app.state"),
                queue_depth=int(spec.get("app_queue_depth", 256)),
                data_source=self.reqstore.get,
            )
            # Composition replays journaled ops above the persisted
            # snapshot floor into the state machine.
            self.app_log = AppLog(self._journal, self.app_stream)
            self.kv_service = KvService(
                KvFrontend(self.app_stream, self.kv_store, self.node.propose)
            )
        else:
            self.app_log = self._journal
        # Not ready until the peer mesh is dialed (phase 2 below).
        self.node.set_ready(False)
        self.transport = self._bind(int(spec.get("transport_port", 0)))
        self.engine = TransferEngine(
            self.node_id,
            _TransportDuct(self.transport),
            staging_dir=self.dir,
            peers=[
                p
                for p in range(int(spec["node_count"]))
                if p != self.node_id
            ],
            limits=config,
            install=self._install_snapshot,
            complete=self.node.state_transfer_complete,
            failed=self.node.state_transfer_failed,
            chunk_timeout_s=float(spec.get("transfer_chunk_timeout_s", 1.0)),
        )
        self._installs_unix: list = []
        self._store_digest = (None, "")  # (applied_index, KvStore digest hex)
        self.transport.set_transfer_sink(self.engine.on_frame)
        # Spec "signed_ingress": client requests carry Ed25519 trailers
        # (loadgen ClientModel signed=True) and are speculatively
        # admitted through the batched verify stage on the Ed25519
        # kernels — survivors reach node.propose, forgeries are evicted.
        self.ingress = None
        self.batch_journal = None
        if bool(spec.get("signed_ingress", False)):
            from ..runtime.ingress import SpeculativeIngress
            from ..testengine import signing

            self.batch_journal = _BatchJournal(
                os.path.join(self.dir, f"ingress-batches-{os.getpid()}.jsonl"),
                signing.batch_verifier(self.device),
            )
            self.ingress = SpeculativeIngress(
                self.node.propose, self.batch_journal,
                name=f"ingress-{self.node_id}",
            )
            self.transport.set_propose_sink(self.ingress.submit)
        self._checkpoint_file = open(
            os.path.join(self.dir, "checkpoints.jsonl"), "a", encoding="utf-8"
        )
        self._announced: set = set()
        self._dialed: set = set()

    # -- boot handshake ------------------------------------------------------

    def _bind(self, port: int) -> TcpTransport:
        """Bind the transport; restarts re-bind the recorded port
        (retrying through TIME_WAIT) so peers' registered addresses and
        the supervisor's proxies stay valid across the reboot."""
        deadline = time.monotonic() + _BIND_RETRY_S
        while True:
            try:
                link_auth = None
                if self.config.link_auth:
                    from ..crypto.mac import LinkAuthenticator

                    link_auth = LinkAuthenticator(
                        self.node_id, self.config.auth_secret
                    )
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

    def announce(self) -> None:
        doc = {
            "pid": os.getpid(),
            "transport_port": self.transport.address[1],
            "metrics_port": self.node.metrics_address[1],
        }
        if self.kv_service is not None:
            doc["app_port"] = self.kv_service.port
        write_json_atomic(os.path.join(self.dir, "address.json"), doc)

    def wire(self) -> None:
        """Phase 2: wait for peers.json, dial the mesh, apply the link
        latency profile, go ready."""
        peers_path = os.path.join(self.dir, "peers.json")
        deadline = time.monotonic() + _PEERS_TIMEOUT_S
        while True:
            peers_doc = read_json(peers_path)
            if peers_doc is not None:
                break
            if self._stop.is_set():
                return
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"node {self.node_id}: no peers.json after "
                    f"{_PEERS_TIMEOUT_S:.0f}s (supervisor gone?)"
                )
            time.sleep(0.02)
        self.transport.serve(self.node)
        self._dial_peers(peers_doc)
        self.processor = build_processor(
            self.node,
            self.transport.link(),
            self.app_log,
            self.wal,
            self.reqstore,
            device=self.device,
        )
        if hasattr(self.processor, "on_results"):
            self.processor.on_results = self._capture_checkpoints
        # The transport's hello handshake measured peer clock offsets;
        # stamp them into the recorder so --postmortem aligns this
        # node's dump with its peers' exactly like live trace merging.
        # Hellos come with a peer's first frame, so _shutdown stamps
        # them again once the run is over.
        self._stamp_clock_offsets()
        if self.tracer is not None:
            self.tracer.name_thread(self.node_id, f"node {self.node_id}")
        self.recorder.record_note("worker.ready", args={"pid": os.getpid()})
        # Commit a baseline segment now: a SIGKILL that lands before the
        # first autoflush threshold must still find a dump to annotate.
        self.recorder.flush("ready")

    def _stamp_clock_offsets(self) -> None:
        offsets = self.transport.clock_offsets()
        self.recorder.set_clock_offsets(offsets)
        if self.tracer is not None:
            self.tracer.set_clock_sync(self.node_id, offsets)

    def _dial_peers(self, peers_doc: dict) -> None:
        """Dial every peer in a peers.json document that is not yet
        connected.  Idempotent, so the run loop's periodic re-poll only
        adds newcomers (supervisor ``join_node``) — and the transfer
        engine's donor list grows with the mesh."""
        latency = self.spec.get("latency", {})
        seed = int(self.spec.get("latency_seed", 0))
        added = False
        for peer_str, address in peers_doc.get("peers", {}).items():
            peer_id = int(peer_str)
            if peer_id == self.node_id or peer_id in self._dialed:
                continue
            link = latency.get(peer_str) or latency.get(str(peer_id))
            if link:
                # Before connect(): the per-peer channel picks its
                # LinkLatency up at creation, so no frame ever bypasses
                # the emulated delay.
                self.transport.set_link_latency(
                    peer_id,
                    float(link.get("delay_ms", 0.0)) / 1000.0,
                    jitter_s=float(link.get("jitter_ms", 0.0)) / 1000.0,
                    seed=seed,
                )
            self.transport.connect(peer_id, tuple(address))
            self._dialed.add(peer_id)
            added = True
        if added:
            self.engine.set_peers(sorted(self._dialed))

    # -- checkpoints / state transfer ---------------------------------------

    def _capture_checkpoints(self, results) -> None:
        for cr in results.checkpoints:
            seq_no = cr.checkpoint.seq_no
            if seq_no in self._announced:
                continue
            self._announced.add(seq_no)
            state = checkpoint_network_state(cr)
            self._checkpoint_file.write(
                json.dumps(
                    {
                        "seq": seq_no,
                        "value": cr.value.hex(),
                        "state": pb.encode(state).hex(),
                    }
                )
                + "\n"
            )
            self._checkpoint_file.flush()
            requests: list = []

            def _collect(ack, _data=None):
                # FileRequestStore.uncommitted hands only the ack; the
                # payload is a separate read.
                data = self.reqstore.get(ack)
                if data is not None:
                    requests.append((ack, data))

            self.reqstore.uncommitted(_collect)
            if self.app_stream is not None:
                # The certified value binds the full app-state blob; ship
                # the blob so an installer can verify + adopt the whole
                # state machine, not just the chain.
                app_bytes = (
                    self.app_stream.snapshot_blob(cr.value)
                    or self.app_stream.last_snapshot_blob
                    or b""
                )
            else:
                app_bytes = self.app_log.chain
            self.engine.note_checkpoint(
                seq_no, cr.value, state, app_bytes, requests
            )

    def _install_snapshot(self, snap):
        """TransferEngine install callback: adopt the app state (an
        fsynced adopt record; in KV mode the verified full state blob)
        and the donor's uncommitted-request slice, then let the node
        persist the checkpoint CEntry."""
        if self.app_stream is not None:
            if not self.app_log.install(
                snap.app_bytes, snap.value, snap.seq_no
            ):
                return None  # blob does not bind to the certified value
            self.app_stream.answer_installed(snap.network_state, snap.seq_no)
        else:
            self.app_log.adopt(snap.value, snap.seq_no)
        for ack, data in snap.requests:
            self.reqstore.store(ack, data)
        self.reqstore.sync()
        self._installs_unix.append(time.time())
        return snap.network_state

    def kernel_evidence(self) -> dict:
        """This incarnation's work on the kernels: the processor's
        launches and digests, each wrapper's launches in this process,
        and the ingress stage's batches and verify errors."""
        from ..ops import ed25519

        doc = {
            "pid": os.getpid(),
            "device": self.device,
            "processor": self.config.processor,
            **kernel_launches(),
            "launches_ed25519_decompress_by_rows": dict(
                ed25519.decompress.launches_by_rows
            ),
            "launches_ed25519_ladder_by_rows": dict(
                ed25519.ladder.launches_by_rows
            ),
        }
        processor = self.processor
        if processor is not None:
            doc.update(
                launches=int(getattr(processor, "launches", 0)),
                device_digests=int(getattr(processor, "device_digests", 0)),
                host_digests=int(getattr(processor, "host_digests", 0)),
                kernel_ms=float(getattr(processor, "kernel_ms", 0.0)),
            )
        if self.ingress is not None:
            doc["ingress"] = {
                "admitted": self.ingress.admitted,
                "dropped_overflow": self.ingress.dropped_overflow,
                "batches": self.ingress.batches,
                "delivered": self.ingress.delivered,
                "evicted": self.ingress.evicted,
                "verify_errors": self.ingress.verify_errors,
                "last_error": (
                    repr(self.ingress.last_error)
                    if self.ingress.last_error is not None
                    else None
                ),
            }
        return doc

    def _publish_transfer_status(self) -> None:
        """Expose the engine's phase and evidence counters for the
        supervisor's chaos audits (corruption-rejection, catch-up), and
        this incarnation's kernel evidence."""
        try:
            write_json_atomic(
                os.path.join(self.dir, "transfer.json"),
                {
                    **self.engine.status(),
                    "installs_unix": list(self._installs_unix),
                },
            )
            write_json_atomic(
                os.path.join(self.dir, "reconfig.json"),
                self.node.reconfig_status(),
            )
            if self.app_stream is not None:
                status = self.app_stream.status()
                # The store changes only when an apply or an install moves
                # the applied index: hash it again only then.
                if self._store_digest[0] != status["applied_index"]:
                    self._store_digest = (
                        status["applied_index"], self.kv_store.digest().hex()
                    )
                write_json_atomic(
                    os.path.join(self.dir, "app.json"),
                    {**status, "store_sha256": self._store_digest[1]},
                )
            if self.batch_journal is not None:
                self.batch_journal.flush()
            write_json_atomic(
                os.path.join(self.dir, f"kernels-{os.getpid()}.json"),
                self.kernel_evidence(),
            )
        except OSError:
            pass  # monitoring is best-effort; never kill the consumer

    # -- the consumer loop ---------------------------------------------------

    def run(self) -> int:
        """Drive the node until SIGTERM (or serializer death); returns
        the process exit code."""
        last_tick = time.monotonic()
        last_poll = last_tick
        code = 0
        ready = False
        try:
            while not self._stop.is_set():
                actions = self.node.ready(timeout=0.01)
                if actions is not None:
                    results = self.processor.process(actions)
                    self._capture_checkpoints(results)
                    if results.digests or results.checkpoints:
                        self.node.add_results(results)
                if not ready and self.wal.persisted():
                    ready = True
                    self.node.set_ready(True)
                now = time.monotonic()
                if now - last_tick >= self.tick_seconds:
                    last_tick = now
                    self.node.tick()
                if actions is not None and actions.state_transfer is not None:
                    self.engine.begin(actions.state_transfer)
                self.engine.poll()
                if now - last_poll >= 0.5:
                    last_poll = now
                    peers_doc = read_json(
                        os.path.join(self.dir, "peers.json")
                    )
                    if peers_doc is not None:
                        self._dial_peers(peers_doc)
                    self._publish_transfer_status()
                if self.node.retired and actions is None:
                    # An adopted reconfiguration removed this node and the
                    # action queue has drained: exit gracefully.  The
                    # survivors already drop our messages at ingress, so
                    # lingering only wastes their inbound filters.
                    self.recorder.record_note("worker.retired")
                    break
        except NodeStopped:
            pass
        except Exception as err:  # noqa: BLE001 — report, then die nonzero
            print(f"node {self.node_id} consumer died: {err!r}", file=sys.stderr)
            code = 3
        if self.node.exit_error is not None:
            print(
                f"node {self.node_id} serializer died: "
                f"{self.node.exit_error!r}",
                file=sys.stderr,
            )
            code = 4
        fault = self._shutdown(graceful=code == 0)
        return code or fault

    def stop(self) -> None:
        self._stop.set()

    def _shutdown(self, graceful: bool) -> int:
        """Stop everything this process runs.  Returns 0, or the exit
        code of a fault the stop itself found: the processor's drain
        raised (``EXIT_DRAIN_FAULT``) or the ingress stage failed a
        verify launch (``EXIT_VERIFY_FAULT``); either is written to the
        log, never swallowed."""
        fault = 0
        self.sampler.stop()
        if self.kv_service is not None:
            self.kv_service.close()
        try:
            self.recorder.record_note(
                "worker.shutdown", args={"graceful": graceful}
            )
            self.recorder.flush("exit" if graceful else "sigterm")
        except OSError:
            pass  # a full disk must not block the rest of teardown
        closer = getattr(self.processor, "close", None)
        if closer is not None:
            try:
                closer()  # drain in-flight batches before storage closes
            except Exception as err:  # noqa: BLE001 — logged, exits nonzero
                print(
                    f"node {self.node_id} processor drain failed: {err!r}",
                    file=sys.stderr,
                )
                fault = EXIT_DRAIN_FAULT
        if self.ingress is not None:
            # Until its thread ends: a process that exits while that
            # thread is inside a verify launch aborts (SIGABRT, exit -6)
            # as the interpreter finalises.  The supervisor's SIGKILL
            # bounds a launch that never returns.
            self.ingress.close(drain_timeout=0.5, join_timeout=None)
            if self.ingress.verify_errors:
                print(
                    f"node {self.node_id} ingress verify failed "
                    f"{self.ingress.verify_errors} time(s): "
                    f"{self.ingress.last_error!r}",
                    file=sys.stderr,
                )
                fault = fault or EXIT_VERIFY_FAULT
        self._publish_transfer_status()
        if self.batch_journal is not None:
            self.batch_journal.close()
        self.transport.close(0.5)
        self.node.stop()
        self._checkpoint_file.close()
        if graceful:
            self.wal.close()
            self.reqstore.close()
            self.app_log.close()
            snapshot = hooks.metrics.snapshot() if hooks.enabled else {}
            write_json_atomic(
                os.path.join(self.dir, "metrics.json"), snapshot
            )
            if self.tracer is not None:
                # The peers' hellos arrive with their first frames: the
                # offsets learned during the run go into the trace.
                self._stamp_clock_offsets()
                try:
                    self.tracer.write(os.path.join(self.dir, "trace.json"))
                except OSError:
                    pass  # trace dump is best-effort, like the recorder
        else:
            self.wal.crash()
            self.reqstore.crash()
            self.app_log.crash()
        hooks.disable()
        sys.stderr.flush()
        return fault


class _BatchJournal:
    """The signed-ingress verifier, journaled: ``verify`` wrapped so that
    every batch it is handed is kept as one JSON line,
    ``{"items": [[client_id, req_no, data hex], ...], "verdicts": [...]}``
    (``verdicts`` null when the launch raised).  The lines wait in memory
    and reach ``path`` at ``flush`` (the worker's 0.5 s status publish and
    its shutdown), so the verify thread makes no write of its own; a
    SIGKILL loses at most the last 0.5 s.  The file grows by every
    payload the node is sent, hex-encoded, for as long as the worker
    runs, and goes with the node's directory."""

    def __init__(self, path: str, verify):
        self._verify = verify
        self._file = open(path, "a", encoding="utf-8")
        self._lines: list = []  # guarded-by: _lock
        self._lock = threading.Lock()

    def __call__(self, items: list) -> list:
        verdicts = None
        try:
            verdicts = self._verify(items)
            return verdicts
        finally:
            line = json.dumps({
                "items": [[cid, req_no, data.hex()]
                          for cid, req_no, data in items],
                "verdicts": (None if verdicts is None
                             else [bool(v) for v in verdicts]),
            })
            with self._lock:
                self._lines.append(line)

    def flush(self) -> None:
        with self._lock:
            lines, self._lines = self._lines, []
            if lines and not self._file.closed:
                self._file.write("".join(line + "\n" for line in lines))
                self._file.flush()

    def close(self) -> None:
        self.flush()
        with self._lock:
            self._file.close()


def run_worker(spec_path: str) -> int:
    """Entry point for ``python -m mirbft_tpu_torch.cluster --spec <path>``."""
    with open(spec_path, "r", encoding="utf-8") as fh:
        spec = json.load(fh)
    try:
        worker = Worker(spec)
    except Exception as err:  # noqa: BLE001 — boot failure must exit nonzero
        print(
            f"node {spec.get('node_id')} boot failed: {err!r}",
            file=sys.stderr,
        )
        return 2

    def _on_term(_signum, _frame):
        worker.stop()

    signal.signal(signal.SIGTERM, _on_term)
    signal.signal(signal.SIGINT, _on_term)
    worker.announce()
    try:
        worker.wire()
    except Exception as err:  # noqa: BLE001 — boot failure must exit nonzero
        print(f"node {worker.node_id} wiring failed: {err!r}", file=sys.stderr)
        worker._shutdown(graceful=False)
        return 2
    return worker.run()
