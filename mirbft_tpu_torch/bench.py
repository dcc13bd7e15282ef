"""The port's benchmarks: the SHA-256 kernel microbenchmark, the live rung,
the ack-plane rung, rung 4, and the signed-ingress and KV service rungs.

Counterparts of parts of the JAX package's ``bench.py``, with its
constants and its measurement protocols:

- ``sha256_microbench_warmup`` and ``kernel_microbench`` (``bench.py:481-569``):
  the chain kernel's throughput in compressions per second, the digest
  kernel checked against hashlib first, and hashlib's own rate beside them.
  The JAX package timed an XLA and a Pallas route; the port has one route,
  the hand-written chain kernel (``csrc/sha256.cu``).
- ``live_cluster_rate`` (``bench.py:982-1175``): committed requests per
  second of a real 4-node cluster — serializer threads, ``TcpTransport``
  over loopback, on-disk WAL and request store with real fsyncs plus an
  emulated 40 ms flush floor, one consumer thread per node driving
  ``build_processor(kind)`` — measured to the 1600th commit.  Each node
  runs in a process of its own, as a deployment's nodes do.
- ``ackplane_run`` (``bench.py:246-480``): the host ack plane and the
  device ack plane under one seeded ack storm of 100,000 clients, with the
  divergence oracle's verdict and a cross-plane parity check.

- ``ingress_run`` and ``app_run`` (``bench.py:133-180``): the live node as
  a replicated service on the in-process cluster: signed client ingress
  on the Ed25519 kernels under the multi-process rung's traffic, and the
  KV service under the app rung's sessions, with a lagging replica that
  catches up by state transfer.

All run on ``cuda`` unless the caller passes ``device="cpu"`` (the kernels'
plain versions; the tests' route), and raise without a card.
``chip_smoke.py`` (phases 10, 11, 13, 15, 16 and 17) runs them on a card.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import multiprocessing
import multiprocessing.connection
import os
import random
import shutil
import tempfile
import threading
import time
import traceback

import numpy as np
import torch

CHAIN_BATCH = 32768
CHAIN_ITERS = 4096  # 134M compressions a launch
CHAIN_REPS = 4
MSG_BYTES = 640  # 20 request acks x 32-byte digests -> 11 blocks
MSG_BLOCKS = 11
HOST_MESSAGES = 8192
DIGEST_CHECK_MESSAGES = 64



# -- ack-plane rung -------------------------------------------------------------
#
# Host vs device ack plane under one seeded ack storm (the JAX package's
# bench.py:246-480, its constants): 3 sources each ack every client's req
# 0 in a shuffled order, absorbed by a host-plane tracker (step_ack_many:
# scalar fallbacks and the _FastAcks columnar path) and by the device
# plane's column-native ingest (submit_columns + flush).  The frame size
# divides the client count so every device batch pads to one power-of-two
# bucket.  Each side's first frame is its untimed warm-up; events/s
# compares steady state only.  The boundary drain (materializing adoptions
# and crossings back into the host objects) is the device plane's cost
# alone and is reported on its own.
ACKPLANE_CLIENTS = 100_000
ACKPLANE_FRAME = ACKPLANE_CLIENTS // 8
ACKPLANE_SOURCES = (1, 2, 3)
ACKPLANE_SEED = 0xACC5
ACKPLANE_AUDIT_SLOTS = 2048


def _ackplane_tracker(n_clients, ack_plane, device):
    """A standalone ClientTracker at bench scale (no engine): genesis
    checkpoint with n_clients width-1 windows, 4 nodes f=1."""
    from . import pb
    from .core.client_tracker import ClientTracker
    from .core.msgbuffers import NodeBuffers
    from .core.persisted import Persisted

    state = pb.NetworkState(
        config=pb.NetworkConfig(
            nodes=[0, 1, 2, 3],
            f=1,
            number_of_buckets=4,
            checkpoint_interval=5,
            max_epoch_length=50,
        ),
        clients=[
            pb.NetworkClient(id=cid, width=1, low_watermark=0)
            for cid in range(n_clients)
        ],
    )
    persisted = Persisted()
    persisted.add_c_entry(
        pb.CEntry(seq_no=0, checkpoint_value=b"genesis", network_state=state)
    )
    my = pb.InitialParameters(id=0, buffer_size=1 << 20)
    ct = ClientTracker(persisted, NodeBuffers(my), my, ack_plane=ack_plane,
                       ack_device=device)
    ct.reinitialize()
    return ct


def ackplane_run(registry=None, *, device="cuda", clients=ACKPLANE_CLIENTS):
    """Host vs device ack plane under the same seeded ack storm.

    Returns the JAX package's ``ackplane_*`` keys: steady-state ack
    events/s per plane (and the device/host ratio), committed
    (strong-certified) reqs/s on the device plane, the boundary drain and
    sweep seconds, the sampled divergence-oracle verdict and a sampled
    cross-plane object-parity check; numbers unrounded.  ``registry``
    turns the hooks on for the run (the ack metrics, and the device
    programs' times and launch shapes through ``obsv.device``).  The device
    plane runs on ``device``; it raises where it cannot be built."""
    from . import pb
    from .core.device_tracker import _combine_limbs
    from .obsv import hooks, shadow
    from .ops import ack_plane

    n_clients = clients
    frame = n_clients // 8
    rng = np.random.default_rng(ACKPLANE_SEED)
    dig_mat = rng.integers(0, 256, size=(n_clients, 32), dtype=np.uint8)
    orders = {s: rng.permutation(n_clients) for s in ACKPLANE_SOURCES}

    if registry is not None:
        hooks.enable(registry=registry)
    try:
        # -- host plane ------------------------------------------------------
        host = _ackplane_tracker(n_clients, "host", device)
        host_build_s = host_steady_s = 0.0
        host_steady_events = 0
        first = True
        for s in ACKPLANE_SOURCES:
            order = orders[s]
            for lo in range(0, n_clients, frame):
                idx = order[lo:lo + frame]
                msgs = [
                    pb.Msg(
                        type=pb.RequestAck(
                            client_id=int(c), req_no=0,
                            digest=dig_mat[c].tobytes(),
                        )
                    )
                    for c in idx.tolist()
                ]
                t0 = time.perf_counter()
                host.step_ack_many(s, msgs)
                dt = time.perf_counter() - t0
                if first:
                    host_build_s, first = dt, False
                else:
                    host_steady_s += dt
                    host_steady_events += len(msgs)

        # -- device plane ----------------------------------------------------
        devt = _ackplane_tracker(n_clients, "device", device)
        t0 = time.perf_counter()
        plane = devt._build_device()
        dev_build_s = time.perf_counter() - t0
        launches = (ack_plane.ack_step.launches,
                    ack_plane.quorum_sweep.launches)
        zeros = np.zeros(frame, dtype=np.int64)
        dev_compile_s = dev_steady_s = 0.0
        dev_steady_events = 0
        out_of_window = 0
        first = True
        for s in ACKPLANE_SOURCES:
            order = orders[s]
            for lo in range(0, n_clients, frame):
                idx = order[lo:lo + frame].astype(np.int64)
                t0 = time.perf_counter()
                out = plane.submit_columns(
                    s, idx, zeros[:len(idx)], dig_mat[idx]
                )
                plane.flush(drain=None)
                dt = time.perf_counter() - t0
                out_of_window += len(out)
                if first:
                    dev_compile_s, first = dt, False
                else:
                    dev_steady_s += dt
                    dev_steady_events += len(idx)

        # Boundary drain: adoptions, weak/strong crossings and ready marks
        # materialize into the host objects (column-only ingest, so any
        # fallback row raises: the zero-fallback gate).
        t0 = time.perf_counter()
        plane.drain_events(devt)
        drain_s = time.perf_counter() - t0
        # Quorum-certificate tally across every (client, window) bucket in
        # one device pass.
        t0 = time.perf_counter()
        certs = plane.quorum_sweep()
        sweep_s = time.perf_counter() - t0
        launches = (ack_plane.ack_step.launches - launches[0],
                    ack_plane.quorum_sweep.launches - launches[1])

        # Sampled divergence audit; any finding also lands in
        # mirbft_divergence_total.
        sample = rng.choice(
            n_clients, size=min(ACKPLANE_AUDIT_SLOTS, n_clients),
            replace=False,
        )
        slots = [int(c) * plane.w_pad for c in sample.tolist()]
        divs = shadow.audit_tracker(devt, slots=slots)
        if registry is not None:
            for d in divs:
                registry.counter(
                    "mirbft_divergence_total", component=d["component"]
                ).inc()

        # Cross-plane parity on the same sampled clients: the host objects
        # must match the device plane's authoritative state slot for slot
        # (the device-side objects hold stale lower bounds by contract, so
        # voter masks read from the device snapshot).
        dev_snap = plane.host_snapshot()
        parity_mismatches = 0
        for c in sample.tolist():
            h = host.clients[c].req_no_map[0]
            d = devt.clients[c].req_no_map[0]
            slot = int(c) * plane.w_pad
            if (
                set(h.strong_requests) != set(d.strong_requests)
                or set(h.weak_requests) != set(d.weak_requests)
                or h.non_null_voters
                != _combine_limbs(dev_snap["nonnull"][slot])
            ):
                parity_mismatches += 1

        host_rate = host_steady_events / host_steady_s if host_steady_s else None
        dev_rate = dev_steady_events / dev_steady_s if dev_steady_s else None
        device_s = dev_steady_s + dev_compile_s + sweep_s
        counters = {}
        if registry is not None:
            snap = registry.snapshot().get("mirbft_ack_events_total") or {}
            for series in snap.get("series", ()):
                counters[dict(series["labels"]).get("plane")] = series["value"]
        return {
            "clients": n_clients,
            "frame": frame,
            "events_total": len(ACKPLANE_SOURCES) * n_clients,
            "host_events_per_sec": host_rate,
            "host_build_s": host_build_s,
            "device_events_per_sec": dev_rate,
            "device_build_s": dev_build_s,
            "device_compile_s": dev_compile_s,
            "device_vs_host": (
                dev_rate / host_rate if dev_rate and host_rate else None
            ),
            "committed_reqs_per_sec": (
                certs["strong_certs"] / device_s if device_s > 0 else None
            ),
            "strong_certs": certs["strong_certs"],
            "weak_certs": certs["weak_certs"],
            "drain_seconds": drain_s,
            "sweep_seconds": sweep_s,
            "fallback_rows": plane.acks_fallback,
            "dropped_rows": plane.acks_dropped + out_of_window,
            "divergences": len(divs),
            "parity_mismatches": parity_mismatches,
            "ack_events_counter": counters,
            "step_launches": launches[0],
            "sweep_launches": launches[1],
            "plane": {"c_pad": plane.c_pad, "w_pad": plane.w_pad,
                      "limbs": plane.limbs, "device": str(plane.device)},
        }
    finally:
        if registry is not None:
            hooks.disable()


@dataclasses.dataclass(frozen=True)
class LiveSettings:
    """The live rung's settings.  The defaults, ``LIVE``, are the JAX
    package's (bench.py:122-131): 4 nodes, 16 clients x 110 requests,
    BatchSize 10, checkpoint interval 50, a 40 ms flush floor on every
    fsync of the WAL and the request store, timed to the 1600th commit on
    any node.  Tests pass a smaller one."""

    nodes: int = 4
    clients: int = 16
    reqs_per_client: int = 110
    target_commits: int = 1600
    batch_size: int = 10
    tick_s: float = 0.5
    checkpoint_interval: int = 50
    suspect_ticks: int = 10_000
    fsync_floor_s: float = 0.040
    deadline_s: float = 120.0


LIVE = LiveSettings()
LIVE_START_TIMEOUT_S = 120.0  # a node's process: import, build, listen
LIVE_RETRY_S = 0.5  # a node re-proposes what it has not committed
LIVE_SCRAPE_AFTER_S = 1.0  # a traced run's endpoints are read this long in

LIVE_KINDS = (
    "serial", "cuda", "pool", "cuda-pool", "pipelined", "cuda-pipelined",
)


# -- the kernel microbenchmark ------------------------------------------------


def _random_block(rng, batch: int, device) -> torch.Tensor:
    words = rng.integers(0, 2**32, size=(batch, 16), dtype=np.uint32)
    return torch.from_numpy(words.view(np.int32)).to(device)


def sha256_microbench_warmup(device="cuda") -> float:
    """Build and load the kernels (the first launch builds
    ``csrc/sha256.cu`` with nvcc when no library is cached) and run each
    once, outside the timed reps.  Returns the seconds it took."""
    from .ops.batching import pack_preimages, resolve_device, to_tensors
    from .ops.sha256 import sha256_chain_checksum, sha256_digest_words

    device = resolve_device(device)
    start = time.perf_counter()
    rng = np.random.default_rng(1)
    int(sha256_chain_checksum(_random_block(rng, 128, device), iters=2))
    packed = pack_preimages([rng.bytes(MSG_BYTES)])
    sha256_digest_words(*to_tensors(packed, device)).cpu()
    return time.perf_counter() - start


def kernel_microbench(
    device="cuda",
    *,
    batch: int = CHAIN_BATCH,
    iters: int = CHAIN_ITERS,
    reps: int = CHAIN_REPS,
    host_messages: int = HOST_MESSAGES,
    seed: int = 0,
) -> dict:
    """The chain kernel's throughput, by the JAX package's protocol: a
    fresh random (batch, 16) block for every rep, all of a rep's
    ``batch * iters`` compressions in one launch, and the checksum's
    readback as the only sync.  Each rep is timed by CUDA events around the
    launch and by the host's clock around launch and readback; the rate is
    taken from the fastest rep's device time (from the wall on the CPU).

    Before any rate counts, the digest kernel must agree with hashlib on
    ``DIGEST_CHECK_MESSAGES`` messages of ``MSG_BYTES`` (11 blocks).

    Returns ``chain_rate`` (compressions/s), ``kernel_digest_rate``
    (``chain_rate / MSG_BLOCKS``: 640-byte digests/s), ``host_rate``
    (hashlib's 640-byte digests/s on one host thread), and each rep's
    ``rep_ms`` (CUDA events; None on the CPU), ``rep_wall_ms`` and
    ``checksums`` (uint32)."""
    from .ops.batching import pack_preimages, resolve_device, to_tensors
    from .ops.sha256 import (
        sha256_chain_checksum,
        sha256_digest_words,
        words_to_digests,
    )

    device = resolve_device(device)
    on_card = device.type == "cuda"
    rng = np.random.default_rng(seed)

    sample = [rng.bytes(MSG_BYTES) for _ in range(DIGEST_CHECK_MESSAGES)]
    raw = words_to_digests(
        sha256_digest_words(*to_tensors(pack_preimages(sample), device))
    )
    for i, message in enumerate(sample):
        if raw[32 * i : 32 * i + 32] != hashlib.sha256(message).digest():
            raise AssertionError(f"digest kernel != hashlib on message {i}")

    rep_ms, rep_wall_ms, checksums = [], [], []
    for _ in range(reps):
        block = _random_block(rng, batch, device)
        if on_card:
            torch.cuda.synchronize(device)  # the block's copy, off the clock
            began = torch.cuda.Event(enable_timing=True)
            ended = torch.cuda.Event(enable_timing=True)
        start = time.perf_counter()
        if on_card:
            began.record()
        out = sha256_chain_checksum(block, iters=iters)
        if on_card:
            ended.record()
        checksum = int(out) & 0xFFFFFFFF  # the readback: the only sync
        rep_wall_ms.append((time.perf_counter() - start) * 1e3)
        rep_ms.append(began.elapsed_time(ended) if on_card else None)
        checksums.append(checksum)

    best_ms = min(rep_ms) if on_card else min(rep_wall_ms)
    chain_rate = batch * iters / (best_ms / 1e3)

    messages = [rng.bytes(MSG_BYTES) for _ in range(host_messages)]
    start = time.perf_counter()
    for message in messages:
        hashlib.sha256(message).digest()
    host_rate = len(messages) / (time.perf_counter() - start)

    return {
        "chain_rate": chain_rate,
        "kernel_digest_rate": chain_rate / MSG_BLOCKS,
        "host_rate": host_rate,
        "batch": batch,
        "iters": iters,
        "reps": reps,
        "rep_ms": rep_ms,
        "rep_wall_ms": rep_wall_ms,
        "checksums": checksums,
    }


# -- the live rung ---------------------------------------------------------------


class ChainLog:
    """In-memory hash-chain application for the live rung (the JAX bench's
    ``_MemChainLog``): the app hashes every committed ack into a chain but
    never touches disk — durability is the WAL's job.  It also keeps what
    the rung checks: every chain value in commit order (nodes must agree on
    the prefix they share), the first-commit instant of every request, and
    the requests committed more than once."""

    def __init__(self):
        self.chain = b""
        self.chains: list = []  # the chain after each committed ack
        self.commits: set = set()  # {(client_id, req_no)}
        self.commit_times: dict = {}  # {(client_id, req_no): perf_counter}
        self.duplicates: list = []

    def apply(self, q_entry) -> None:
        for ack in q_entry.requests:
            h = hashlib.sha256()
            h.update(self.chain)
            h.update(ack.digest)
            self.chain = h.digest()
            self.chains.append(self.chain)
            key = (ack.client_id, ack.req_no)
            if key in self.commits:
                self.duplicates.append(key)
            else:
                self.commits.add(key)
                self.commit_times[key] = time.perf_counter()

    def snap(self, network_config, clients_state) -> bytes:
        return self.chain


def _transport_drops(transport) -> int:
    """Frames a transport dropped: overflowed, unknown peer, closed."""
    counters = transport.counters()
    return counters["dropped_unknown"] + sum(
        peer["dropped_overflow"] + peer["dropped_closed"]
        for peer in counters["peers"].values()
    )


def _node_summary(node) -> str:
    """Epoch, epoch state and low watermark, for a stalled run's report."""
    status = node.status(timeout=2.0)
    if status is None:
        return "no status"
    tracker = status.epoch_tracker
    epoch = "none" if tracker is None else f"{tracker.number} {tracker.state}"
    return f"epoch {epoch} low watermark {status.low_watermark}"


def _p95(values: list):
    if not values:
        return None
    values = sorted(values)
    return values[min(len(values) - 1, int(0.95 * len(values)))]


def _live_node(n: int, kind: str, device: str, settings: LiveSettings,
               root: str, conn, trace_dir=None) -> None:
    """One node of the live rung, in a process of its own, steered by the
    parent over ``conn``: it sends ``("address", address)``, receives every
    node's address, connects and sends ``("ready", None)``; on ``"go"`` it
    proposes every request to its node, re-proposes what its node has not
    committed every ``LIVE_RETRY_S``, sends ``("reached", instant)`` once
    its node has committed the target (the instant of the target-th first
    commit, on the monotonic clock that every process shares) and, on
    ``"stop"``, shuts down and sends ``("result", {...})``.  A failure
    sends ``("error", traceback)``.  With ``trace_dir`` the node runs
    traced (see ``live_cluster_rate``)."""
    try:
        _run_live_node(n, kind, device, settings, root, conn, trace_dir)
    except BaseException:  # noqa: BLE001 — reported to the parent
        try:
            conn.send(("error", f"node {n}:\n{traceback.format_exc()}"))
        except OSError:
            pass  # the parent is gone
    finally:
        conn.close()


def _run_live_node(n, kind, device, settings, root, conn,
                   trace_dir=None) -> None:
    from . import pb
    from .obsv import hooks
    from .obsv.recorder import FlightRecorder
    from .ops.sha256 import sha256_digest_words
    from .runtime import (
        Config,
        FileRequestStore,
        FileWal,
        Node,
        TcpTransport,
        build_processor,
    )
    from .runtime.node import NodeStopped, standard_initial_network_state
    from .runtime.processor import _CudaHashMixin

    client_ids = list(range(1, settings.clients + 1))
    state = standard_initial_network_state(
        settings.nodes, client_ids,
        checkpoint_interval=settings.checkpoint_interval,
        # Planned epoch rotation past the run: rotation triggers state
        # transfer on lagging nodes, which this rung does not measure.
        max_epoch_length=10 * settings.checkpoint_interval,
    )
    node_dir = os.path.join(root, f"node{n}")
    os.makedirs(node_dir)
    wal = FileWal(os.path.join(node_dir, "wal"))
    store = FileRequestStore(os.path.join(node_dir, "reqs"))
    if settings.fsync_floor_s > 0:
        # Emulated flush latency on every fsync, through the stores'
        # pre-fsync seam (identical for every kind).
        def floor():
            time.sleep(settings.fsync_floor_s)

        wal.fault_hook = floor
        store.fault_hook = floor
    app_log = ChainLog()
    tracer = recorder = None
    if trace_dir is not None:
        # Traced: the tracer, the metrics registry and a flight recorder
        # behind the node's HTTP exporter on an ephemeral port.
        recorder = FlightRecorder(
            n, dump_dir=os.path.join(trace_dir, f"flight{n}")
        )
        _registry, tracer = hooks.enable(trace=True, recorder=recorder)
        tracer.name_thread(n, f"node {n}")
    node = Node.start_new(
        Config(
            id=n, batch_size=settings.batch_size, processor=kind,
            suspect_ticks=settings.suspect_ticks,
            metrics_port=None if trace_dir is None else 0,
        ),
        state,
    )
    # Each peer's send queue drops its oldest frame past its depth.  At the
    # start every node acks every request to every peer in one Actions
    # batch (1760 frames a peer at the JAX package's settings, past the
    # default depth of 1024), and with suspicion pushed past the run a
    # protocol frame dropped in that burst is never recovered: the queue
    # holds twice the burst.
    transport = TcpTransport(
        n, backoff_base=0.02, backoff_cap=0.25, dial_timeout=1.0,
        queue_depth=max(1024, 2 * settings.clients * settings.reqs_per_client),
    )
    processor = None
    stop = threading.Event()
    consumer = None
    try:
        transport.serve(node)
        processor = build_processor(
            node, transport.link(), app_log, wal, store, device=device
        )
        on_card_kind = isinstance(processor, _CudaHashMixin)
        if on_card_kind:
            processor.samples = {}
        conn.send(("address", (transport.address, node.metrics_address)))
        for m, address in conn.recv().items():
            if m != n:
                transport.connect(m, address)

        requested = [0]  # hash requests handed to the processor
        failures: list = []

        def consume():
            last_tick = time.monotonic()
            try:
                while not stop.is_set():
                    actions = node.ready(timeout=0.01)
                    if actions is not None:
                        requested[0] += len(actions.hashes)
                        results = processor.process(actions)
                        if results.digests or results.checkpoints:
                            node.add_results(results)
                    now = time.monotonic()
                    if now - last_tick >= settings.tick_s:
                        last_tick = now
                        node.tick()
            except NodeStopped:
                pass
            except Exception as exc:  # noqa: BLE001 — raised below
                failures.append(exc)

        consumer = threading.Thread(
            target=consume, name=f"torch-live-consumer-{n}", daemon=True
        )
        consumer.start()
        conn.send(("ready", None))
        conn.recv()  # "go"

        expected = {
            (client_id, req_no)
            for client_id in client_ids
            for req_no in range(settings.reqs_per_client)
        }
        propose_times: dict = {}

        def propose(pending):
            for client_id, req_no in sorted(pending):
                propose_times.setdefault(
                    (client_id, req_no), time.perf_counter()
                )
                try:
                    node.propose(pb.Request(
                        client_id=client_id, req_no=req_no,
                        data=b"%d" % req_no,
                    ))
                except (NodeStopped, ValueError):
                    pass

        propose(expected)
        reached = False
        last_retry = time.monotonic()
        while not conn.poll(0.005):
            if failures:
                raise failures[0]
            if not reached and len(app_log.commits) >= settings.target_commits:
                reached = True
                instants = sorted(app_log.commit_times.values())
                conn.send(("reached", instants[settings.target_commits - 1]))
            now = time.monotonic()
            if now - last_retry >= LIVE_RETRY_S:
                # Below-watermark acks are dropped as PAST, so duplicates
                # are harmless.
                last_retry = now
                propose(expected - app_log.commits)
        conn.recv()  # "stop"
        summary = _node_summary(node)
        drops = _transport_drops(transport)  # before the shutdown drops any
    finally:
        stop.set()
        if consumer is not None:
            consumer.join(timeout=10)
        closer = getattr(processor, "close", None)
        if closer is not None:
            closer()  # drain in-flight batches, flush group syncers
        transport.close(0)
        node.stop()
        wal.close()
        store.close()

    result = {
        "commits": len(app_log.commits),
        "chains": app_log.chains,
        "duplicates": app_log.duplicates,
        "p95_ms": _p95([
            1e3 * (when - propose_times[key])
            for key, when in app_log.commit_times.items()
            if key in propose_times
        ]),
        "hash_requests": requested[0],
        "frames_dropped": drops,
        "summary": summary,
    }
    if tracer is not None:
        hooks.disable()
        # A peer's hello, and with it the offset merge.py aligns its lane
        # by, comes with the peer's first frame (connections open on the
        # first send): stamp the offsets once the run is over.
        offsets = transport.clock_offsets()
        tracer.set_clock_sync(n, offsets)
        recorder.set_clock_offsets(offsets)
        path = os.path.join(trace_dir, f"trace{n}.json")
        tracer.write(path)
        result.update(
            trace=path,
            clock_offsets_ns=offsets,
            abandoned_flows=tracer.abandoned_flows,
            committed_seqs=len({
                event["args"]["seq"] for event in tracer.events
                if event.get("ph") == "i"
                and event.get("name") == "seq.committed"
            }),
        )
    if on_card_kind:
        result.update(
            device_digests=processor.device_digests,
            host_digests=processor.host_digests,
            launches=processor.launches,
            kernel_ms=processor.kernel_ms,
            wrapper_launches=sha256_digest_words.launches,
            samples=processor.samples,
        )
    conn.send(("result", result))


def _receive(conn, tag: str, timeout_s: float, n: int):
    """The value of node ``n``'s next ``tag`` message; a ``reached`` that
    comes first is skipped.  Raises on an error message, on silence past
    the timeout, and when the node's process is gone."""
    deadline = time.monotonic() + timeout_s
    while True:
        left = deadline - time.monotonic()
        if left <= 0 or not conn.poll(left):
            raise RuntimeError(f"live node {n}: no {tag!r} in {timeout_s} s")
        try:
            got, value = conn.recv()
        except EOFError:
            raise RuntimeError(f"live node {n}: its process ended") from None
        if got == "error":
            raise RuntimeError(f"live node failed: {value}")
        if got == tag:
            return value


def live_cluster_rate(kind: str, *, device="cuda",
                      settings: LiveSettings = LIVE, trace_dir=None,
                      on_running=None) -> dict:
    """Committed requests per second of a real loopback TCP cluster under
    executor ``kind``, measured from the first proposal until any node has
    committed ``settings.target_commits`` requests; ``LIVE`` is the JAX
    package's live rung.  Each node runs in a process of its own (spawned:
    no node shares an interpreter lock with another), listens on a
    loopback port and writes its WAL and request store under one temp dir.
    ``device`` is where the ``cuda*`` kinds run (``cpu``: the kernel's
    plain version); the host kinds hash with hashlib, but the rung, like
    every entry point of the port, still raises on ``cuda`` without a card.

    Raises unless: the target is reached before the deadline, no node
    commits a request twice, and the nodes agree on the chain prefix they
    share.  For a ``cuda*`` kind also unless no digest came from the host,
    every hash request of every node was launched, and the kernel
    launched.  A live TCP run is not deterministic: chains are compared
    between the nodes of one run, never between runs.

    Returns the rate, the p95 commit latency (first proposal to first
    commit on the node with the most commits), and the counts; for a
    ``cuda*`` kind also the nodes' launches as their wrappers counted them
    (``wrapper_launches``) and the launch audit (``samples``: every packed
    shape launched, with its launch count and some of its launches'
    preimages and digests; see ``_CudaHashMixin``).

    ``trace_dir`` runs every node traced: the tracer (its clock anchor and,
    at stop, the peers' offsets from the transport's hellos), the
    metrics registry, a flight recorder dumping under
    ``trace_dir/flight<n>``, and the HTTP exporter on an ephemeral port
    (``Config.metrics_port=0``) whose address comes back over the node's
    pipe.  ``on_running(addresses)``, given ``{node: (host, port)}`` of the
    exporters, is called once ``LIVE_SCRAPE_AFTER_S`` after the first
    proposal, while the nodes run; its value is returned as ``scraped``.
    Each node writes ``trace_dir/trace<n>.json`` when it stops, and the
    result gains ``traces`` and, per node, the clock offsets, the
    tracer's abandoned flows and the sequences it traced as committed."""
    from .ops.batching import resolve_device
    from .ops.sha256 import _kernel_library
    from .runtime.processor import PROCESSOR_KINDS, _CudaHashMixin

    device = resolve_device(device)
    if kind not in PROCESSOR_KINDS:
        raise ValueError(f"unknown processor kind {kind!r}")
    on_card_kind = issubclass(PROCESSOR_KINDS[kind], _CudaHashMixin)
    if on_card_kind and device.type == "cuda":
        _kernel_library()  # build once, before the nodes load it
    root = tempfile.mkdtemp(prefix=f"mirbft-torch-live-{kind}-")
    context = multiprocessing.get_context("spawn")
    conns, processes = [], []
    try:
        for n in range(settings.nodes):
            ours, theirs = context.Pipe()
            process = context.Process(
                target=_live_node,
                args=(n, kind, str(device), settings, root, theirs,
                      trace_dir),
                name=f"torch-live-node-{n}", daemon=True,
            )
            process.start()
            theirs.close()
            conns.append(ours)
            processes.append(process)
        announced = {
            n: _receive(conn, "address", LIVE_START_TIMEOUT_S, n)
            for n, conn in enumerate(conns)
        }
        addresses = {n: pair[0] for n, pair in announced.items()}
        exporters = {n: pair[1] for n, pair in announced.items()}
        for conn in conns:
            conn.send(addresses)
        for n, conn in enumerate(conns):
            _receive(conn, "ready", LIVE_START_TIMEOUT_S, n)
        start = time.perf_counter()
        for conn in conns:
            conn.send("go")
        deadline = start + settings.deadline_s
        reached = None
        scraped = None
        while reached is None and time.perf_counter() < deadline:
            if on_running is not None and scraped is None and (
                time.perf_counter() - start >= LIVE_SCRAPE_AFTER_S
            ):
                scraped = on_running(exporters)
            for conn in multiprocessing.connection.wait(conns, timeout=0.05):
                try:
                    got, value = conn.recv()
                except EOFError:
                    raise RuntimeError(
                        f"live node {conns.index(conn)}: its process ended"
                    ) from None
                if got == "error":
                    raise RuntimeError(f"live node failed: {value}")
                if got == "reached":
                    reached = value if reached is None else min(reached, value)
        for conn in conns:
            conn.send("stop")
        nodes = [
            _receive(conn, "result", LIVE_START_TIMEOUT_S, n)
            for n, conn in enumerate(conns)
        ]
    finally:
        for conn in conns:
            conn.close()  # a node still waiting for the parent sees EOF
        for process in processes:
            process.join(timeout=30)
            if process.is_alive():
                process.kill()
                process.join()
        shutil.rmtree(root, ignore_errors=True)

    commits = [node["commits"] for node in nodes]
    drops = [node["frames_dropped"] for node in nodes]
    if reached is None:
        raise RuntimeError(
            f"live rung ({kind}) did not reach {settings.target_commits} "
            f"commits within {settings.deadline_s:.0f} s (per-node commits: "
            f"{commits}; frames dropped per node: {drops}; nodes: "
            f"{[node['summary'] for node in nodes]})"
        )
    duplicates = [node["duplicates"] for node in nodes]
    if any(duplicates):
        raise AssertionError(f"live rung ({kind}): committed twice: {duplicates}")
    shared = min(len(node["chains"]) for node in nodes)
    if shared and len({node["chains"][shared - 1] for node in nodes}) != 1:
        raise AssertionError(
            f"live rung ({kind}): the nodes' chains differ within the first "
            f"{shared} commits"
        )
    elapsed = reached - start
    result = {
        "kind": kind,
        "rate": settings.target_commits / elapsed,
        "elapsed_s": elapsed,
        "commits": commits,
        "shared_prefix": shared,
        "hash_requests": sum(node["hash_requests"] for node in nodes),
        "frames_dropped": drops,
        "p95_ms": max(nodes, key=lambda node: node["commits"])["p95_ms"],
    }
    if trace_dir is not None:
        result.update(
            traces=[node["trace"] for node in nodes],
            clock_offsets_ns=[node["clock_offsets_ns"] for node in nodes],
            abandoned_flows=[node["abandoned_flows"] for node in nodes],
            committed_seqs=[node["committed_seqs"] for node in nodes],
            scraped=scraped,
        )
    if on_card_kind:
        samples: dict = {}
        for node in nodes:
            for shape, (launches, kept) in node["samples"].items():
                entry = samples.setdefault(shape, [0, []])
                entry[0] += launches
                entry[1].extend(kept)
        result.update(
            device=str(device),
            samples=samples,
            **{
                key: sum(node[key] for node in nodes)
                for key in ("device_digests", "host_digests", "launches",
                            "kernel_ms", "wrapper_launches")
            },
        )
        if result["host_digests"] != 0:
            raise AssertionError(f"live rung ({kind}): digests on the host")
        if result["device_digests"] != result["hash_requests"]:
            raise AssertionError(
                f"live rung ({kind}): {result['device_digests']} digests "
                f"launched for {result['hash_requests']} hash requests"
            )
        if result["launches"] <= 0:
            raise AssertionError(f"live rung ({kind}): the kernel never ran")
        if sum(launches for launches, _kept in samples.values()) != (
            result["launches"]
        ):
            raise AssertionError(
                f"live rung ({kind}): the audit missed launches"
            )
    return result


# -- ladder rung 4 --------------------------------------------------------------
#
# BASELINE ladder rung 4 (the JAX package's bench.py:763-841, its constants):
# 128 nodes (f = 42) over a WAN of 30 ms link jitter, 32 clients x 16
# requests, BatchSize 20, 4 rotating leader buckets, checkpoints every 20
# sequences, and a targeted fault: half of node 120's frames die in the
# first two simulated seconds (a seeded drop mangler).  Every Checkpoint a
# node broadcasts is a BLS vote; 2f + 1 = 85 votes on one statement make a
# checkpoint quorum certificate, aggregated in one launch of the BLS kernel.
RUNG4_NODES = 128
RUNG4_CLIENTS = 32
RUNG4_REQS = 16
RUNG4_BATCH_SIZE = 20
RUNG4_DROP_SOURCE = 120


def rung4_run(*, device="cuda") -> dict:
    """BASELINE ladder rung 4 on the kernel hash plane and the kernel
    certificate plane (``device="cpu"``: their plain versions).  No route
    goes to the host: a digest or an aggregate that cannot run raises.

    Runs to full commitment, then on until a checkpoint quorum has formed,
    as the JAX package's rung does; aggregates the pending certificates
    (timed: ``aggregate_ms``, host clock around the call, which reads the
    result back) and checks the first one with one pairing equation, and a
    tampered statement against it.  Returns committed req/s over the
    run's wall, engine events, certificates, the aggregate's ms, simulated
    ms, the app chain, the commit counts, the mangler's casualties, the
    planes' counters, and the first certificate with its votes."""
    from . import pb
    from .testengine.certs import CheckpointCertPlane
    from .testengine.crypto_plane import AsyncKernelHashPlane
    from .testengine.engine import BasicRecorder, RuntimeParameters
    from .testengine.manglers import (
        from_source,
        is_step,
        percent,
        rule,
        until_time,
    )

    f = (RUNG4_NODES - 1) // 3
    client_ids = [RUNG4_NODES + i for i in range(RUNG4_CLIENTS)]
    state = pb.NetworkState(
        config=pb.NetworkConfig(
            nodes=list(range(RUNG4_NODES)),
            f=f,
            number_of_buckets=4,
            checkpoint_interval=20,
            max_epoch_length=200,
        ),
        clients=[
            pb.NetworkClient(id=c, width=16, low_watermark=0)
            for c in client_ids
        ],
    )
    certs = CheckpointCertPlane(quorum=2 * f + 1, use_device=True,
                                device=device)
    hash_plane = AsyncKernelHashPlane(device=device)
    drop = rule(
        from_source(RUNG4_DROP_SOURCE), is_step(), percent(50),
        until_time(2000),
    ).drop()
    start = time.perf_counter()
    rec = BasicRecorder(
        RUNG4_NODES,
        RUNG4_CLIENTS,
        RUNG4_REQS,
        batch_size=RUNG4_BATCH_SIZE,
        network_state=state,
        record=False,
        hash_plane=hash_plane,
        checkpoint_certs=certs,
        params=RuntimeParameters(link_jitter=30),
        manglers=[drop],
    )
    rec.drain_clients(max_steps=20_000_000)
    # Run on until at least one checkpoint quorum has formed.
    extra = 0
    while not (certs._pending or certs._certs) and extra < 2_000_000:
        rec.step()
        extra += 1
    wall = time.perf_counter() - start
    chains = {rec.node_states[n].app_chain for n in range(RUNG4_NODES)}
    if len(chains) != 1:
        raise AssertionError(f"rung 4: the nodes hold {len(chains)} chains")
    total = RUNG4_CLIENTS * RUNG4_REQS
    start = time.perf_counter()
    certificates = certs.certificates()
    agg_ms = 1e3 * (time.perf_counter() - start)
    if not certificates:
        raise AssertionError("rung 4: no checkpoint certificate formed")
    (seq, value), (signers, asig) = sorted(certificates.items())[0]
    verified = CheckpointCertPlane.verify(seq, value, signers, asig)
    tampered = CheckpointCertPlane.verify(seq, value + b"!", signers, asig)
    if not verified or tampered:
        raise AssertionError(
            f"rung 4: the certificate at {seq} verified {verified}, its "
            f"tampered statement {tampered}"
        )
    return {
        "reqs_per_sec": total / wall,
        "events": rec.event_count,
        "certificates": len(certificates),
        "aggregate_ms": agg_ms,
        "sim_ms": rec.now,
        "wall_s": wall,
        "chain": chains.pop().hex(),
        "commits": sorted({rec.committed_at(n) for n in range(RUNG4_NODES)}),
        "dropped": drop.dropped,
        "device_batches": certs.device_batches,
        "host_folds": certs.host_folds,
        "device_digests": hash_plane.device_digests,
        "host_digests": hash_plane.host_digests,
        "hash_launches": hash_plane.launches,
        "kernel_ms": hash_plane.kernel_ms,
        "certificate": (seq, value, signers, asig),
        "votes": [certs._votes[(seq, value)][n] for n in signers],
        "quorum": 2 * f + 1,
    }


# -- the live node as a replicated service ----------------------------------
#
# Two rungs on the in-process cluster (loadgen/inproc.py: N real Nodes in
# one process, direct-call links, in-memory storage, the real
# TransferEngine), every node on the cuda-pipelined processor.
#
# Signed ingress: the JAX package's multi-process rung traffic
# (bench.py:133-144, 1192-1229): 4 nodes, BatchSize 4, clients 1-3 under
# standard_client_models signed, Poisson steps at 25/50/100 req/s of 2 s
# each, arrivals seeded with the rate, generator seed 11, 25 s of drain.
# Each node's propose sits behind a SpeculativeIngress whose verifier is
# signing.batch_verifier() (as mirbft_tpu/cluster/worker.py:251-265
# installs it), so every batch of client requests goes through one launch
# of each Ed25519 kernel.  On top, every INGRESS_FORGE_EVERY-th request
# gets a forged twin (one seeded bit of S flipped) sent to the same nodes.
INGRESS_NODES = 4
INGRESS_CLIENTS = (1, 2, 3)
INGRESS_BATCH_SIZE = 4
INGRESS_RATES = (25.0, 50.0, 100.0)
INGRESS_STEP_S = 2.0
INGRESS_DRAIN_S = 25.0
INGRESS_SEED = 11
INGRESS_TICK_S = 0.04  # the JAX package's ClusterSupervisor default
INGRESS_FORGE_EVERY = 8
INGRESS_SETTLE_S = 30.0  # every node commits every request, after drain

# The KV service: the JAX package's app rung (bench.py:157-180,
# 1331-1381): 8 nodes, 4 closed-loop sessions x 40 ops, read ratio 0.5,
# kv_client_models, committed reads through the read-index barrier,
# BatchSize 1, tick 0.25 s, op timeout 20 s, workload seed 7.  Then a
# lagging replica: its inbound protocol frames are held until the others
# have garbage-collected APP_LAG_CHECKPOINTS checkpoints past it, and on
# release it must catch up by state transfer.
APP_NODES = 8
APP_SESSIONS = 4
APP_OPS_PER_SESSION = 40
APP_BATCH_SIZE = 1
APP_TICK_S = 0.25
APP_READ_RATIO = 0.5
APP_OP_TIMEOUT_S = 20.0
APP_SEED = 7
APP_LAG_CHECKPOINTS = 2
APP_CONVERGE_S = 60.0
APP_LAG_TIMEOUT_S = 120.0  # to reach the hold's target; again to catch up


class _IngressFront:
    """The load generator's cluster for the signed-ingress rung: node ids
    and commit polling are the in-process cluster's, and ``submit`` hands
    the request to the node's ingress stage instead of its propose.  Every
    ``forge_every``-th distinct request gets a forged twin, one seeded bit
    of its signature's S flipped, submitted to each node right after the
    honest request's first submission there."""

    def __init__(self, cluster, ingress: dict, forge_every: int, seed: int):
        from . import pb
        from .testengine.signing import PK_LEN, SIG_LEN

        self._request = pb.Request
        self._s_at = (SIG_LEN // 2 + PK_LEN, PK_LEN)  # S: data[-64:-32]
        self.cluster = cluster
        self.ingress = ingress
        self.forge_every = forge_every
        self._rng = random.Random(seed)
        self.node_ids = cluster.node_ids
        self.commits: list = []  # every observation the generator polled
        self.honest: dict = {}  # (client, req_no) -> data
        self.forged: dict = {}  # (client, req_no) -> forged data
        self.forged_to: dict = {n: 0 for n in self.node_ids}
        self._sent: set = set()  # (client, req_no, node) forgeries sent

    def _forge(self, data: bytes) -> bytes:
        start, end = self._s_at
        s = bytearray(data[-start:-end])
        bit = self._rng.randrange(8 * len(s))
        s[bit // 8] ^= 1 << (bit % 8)
        return data[:-start] + bytes(s) + data[-end:]

    def poll_commits(self) -> list:
        got = self.cluster.poll_commits()
        self.commits.extend(got)
        return got

    def submit(self, node_id: int, request) -> None:
        key = (request.client_id, request.req_no)
        if key not in self.honest:
            self.honest[key] = request.data
            if len(self.honest) % self.forge_every == 0:
                self.forged[key] = self._forge(request.data)
        self.ingress[node_id].submit(request)
        forged = self.forged.get(key)
        if forged is not None and (*key, node_id) not in self._sent:
            self._sent.add((*key, node_id))
            self.forged_to[node_id] += 1
            self.ingress[node_id].submit(self._request(
                client_id=request.client_id, req_no=request.req_no,
                data=forged,
            ))


def ingress_rows(items: list) -> list:
    """The rows one ingress batch hands the Ed25519 kernels: the items
    that pass the host's checks (``signing.identified``, then
    ``marshal_light``'s range checks), marshalled, in order.
    ``signing.kernel_verifier`` launches exactly these, or nothing."""
    from .ops.ed25519 import marshal_light
    from .testengine import signing

    rows = (marshal_light(*t) for t in signing.identified(items)[1])
    return [row for row in rows if row is not None]


def ingress_run(*, device="cuda", rates=INGRESS_RATES, trace_dir=None) -> dict:
    """The signed-ingress rung (see the constants above).  Returns each
    step's loadgen result beside its ingress batches (sizes and verify
    wall) and the nodes' epochs after it, every ingress batch's items in order (``batches``: what the
    kernels were asked), each node's ingress counters and the forgeries
    it was sent, each node's commits as (client, req_no) -> times and as
    (client, req_no, seq) observations, the snapshots each node installed
    with the last one's checkpoint seq_no, whether any forged bytes
    reached a node's request store, the nodes' chains, and the
    processors' digest counters.  The caller holds them to the rung's gates.

    ``rates`` picks the Poisson steps (default: all three).  ``trace_dir``
    runs the rung traced: the tracer is on from the cluster's start to the
    end of the drain, and each node's share of it goes to
    ``trace_dir/trace<n>.json`` (``obsv.merge.split_node_traces``: the
    nodes share this process's clock), every step's per-request commit
    records to ``trace_dir/records.json`` — the run directory
    ``python -m mirbft_tpu_torch.obsv --critpath`` reads."""
    from . import loadgen
    from .crypto import ed25519_host
    from .obsv import hooks
    from .runtime.ingress import SpeculativeIngress
    from .testengine import signing

    for cid in INGRESS_CLIENTS:
        signing.register_pk(
            cid, ed25519_host.public_key(signing.client_seed(cid))
        )
    verify = signing.batch_verifier(device)
    batches: list = []
    batches_lock = threading.Lock()

    def recorded(items):
        with batches_lock:
            batches.append(list(items))
        return verify(items)

    tracer = None
    if trace_dir is not None:
        _registry, tracer = hooks.enable(trace=True)
    models = {
        cid: dataclasses.replace(model, signed=True)
        for cid, model in loadgen.standard_client_models(
            list(INGRESS_CLIENTS)
        ).items()
    }
    cluster = loadgen.InProcessCluster(
        node_count=INGRESS_NODES,
        client_ids=list(INGRESS_CLIENTS),
        batch_size=INGRESS_BATCH_SIZE,
        processor="cuda-pipelined",
        device=device,
        tick_seconds=INGRESS_TICK_S,
    )
    ingress = {}
    try:
        for replica in cluster.replicas:
            ingress[replica.node_id] = SpeculativeIngress(
                replica.node.propose, recorded,
                name=f"ingress-{replica.node_id}",
            )
        front = _IngressFront(
            cluster, ingress, INGRESS_FORGE_EVERY, INGRESS_SEED
        )
        generator = loadgen.LoadGenerator(front, models, seed=INGRESS_SEED)
        steps = []
        start = time.perf_counter()
        for rate in rates:
            before = {n: len(s.flush_sizes) for n, s in ingress.items()}
            step = generator.run_step(
                f"ingress-poisson-{int(rate)}",
                loadgen.PoissonArrivals(rate, seed=int(rate)),
                duration_s=INGRESS_STEP_S,
                drain_s=INGRESS_DRAIN_S,
            )
            sizes, walls = [], []
            for n, stage in ingress.items():
                sizes += stage.flush_sizes[before[n]:]
                walls += stage.flush_wall_s[before[n]:]
            steps.append({"step": step, "batch_sizes": sizes,
                          "verify_wall_s": walls,
                          "epochs": _epochs(cluster)})
        # Every node commits every honest request (the generator stops at
        # the first node's commit), or installs a snapshot and reaches the
        # chain of a node that committed them all.
        want = set(front.honest)
        deadline = time.monotonic() + INGRESS_SETTLE_S
        while time.monotonic() < deadline:
            front.poll_commits()
            per_node = {n: set() for n in cluster.node_ids}
            for node, cid, req_no, _seq, _ts in front.commits:
                per_node[node].add((cid, req_no))
            full = {
                r.app_log.chain for r in cluster.replicas
                if want <= per_node[r.node_id]
            }
            if full and all(
                want <= per_node[r.node_id] or (
                    r.engine.counters["snapshots_installed"]
                    and r.app_log.chain in full
                )
                for r in cluster.replicas
            ):
                break
            time.sleep(0.05)
        for stage in ingress.values():
            stage.flush(timeout=10.0)
        wall = time.perf_counter() - start
        cluster.check()
        commits = {n: collections.Counter() for n in cluster.node_ids}
        for node, cid, req_no, _seq, _ts in front.commits:
            commits[node][(cid, req_no)] += 1
        forged = set(front.forged.values())
        forged_stored = sum(
            1 for replica in cluster.replicas
            for data in replica.reqstore.data.values() if data in forged
        )
        out = {
            "steps": steps,
            "wall_s": wall,
            "batches": batches,
            "honest": want,
            "forged": len(front.forged),
            "forged_to": dict(front.forged_to),
            "forged_stored": forged_stored,
            "commits": commits,
            "observed": list(front.commits),
            "ingress": {
                n: {
                    "admitted": s.admitted, "delivered": s.delivered,
                    "evicted": s.evicted, "batches": s.batches,
                    "verify_errors": s.verify_errors,
                    "last_error": s.last_error,
                    "dropped_overflow": s.dropped_overflow,
                }
                for n, s in ingress.items()
            },
            "chains": {r.node_id: r.app_log.chain for r in cluster.replicas},
            "transfers": {
                r.node_id: (
                    r.engine.counters["snapshots_installed"],
                    r.engine.status()["target_seq_no"],
                )
                for r in cluster.replicas
            },
        }
    finally:
        for stage in ingress.values():
            stage.close()
        cluster.close()
        if tracer is not None:
            hooks.disable()
    if tracer is not None:
        from .obsv.merge import split_node_traces

        for node, trace in split_node_traces(tracer, cluster.node_ids).items():
            with open(os.path.join(trace_dir, f"trace{node}.json"), "w",
                      encoding="utf-8") as f:
                json.dump(trace, f)
        with open(os.path.join(trace_dir, "records.json"), "w",
                  encoding="utf-8") as f:
            json.dump([r for step in steps for r in step["step"].records], f)
        out["abandoned_flows"] = tracer.abandoned_flows
    # Read once every node has stopped: the wrappers' counts end there too.
    out.update(_digest_counters(cluster))
    return out


def _epochs(cluster) -> list:
    """Each node's current epoch number (an epoch change shows here)."""
    out = []
    for replica in cluster.replicas:
        tracker = replica.node.status(timeout=5.0).epoch_tracker
        out.append(None if tracker is None else tracker.number)
    return out


def _digest_counters(cluster) -> dict:
    procs = [r.processor for r in cluster.replicas]
    return {
        "device_digests": sum(p.device_digests for p in procs),
        "host_digests": sum(p.host_digests for p in procs),
        "hash_launches": sum(p.launches for p in procs),
        "kernel_ms": sum(p.kernel_ms for p in procs),
    }


class _HeldInbound:
    """Holds one node's inbound protocol frames (the direct links' calls
    into its ``step``) until ``release``, which delivers them in arrival
    order and lets later frames through.  A harness wrapper only: client
    proposals and transfer frames take other paths and are not held."""

    def __init__(self, node):
        self._step = node.step
        self._lock = threading.Lock()
        self._held: list = []
        self.holding = True
        node.step = self.step

    def step(self, source, msg) -> None:
        with self._lock:
            if self.holding:
                self._held.append((source, msg))
                return
        self._step(source, msg)

    def release(self) -> int:
        from .runtime.node import NodeStopped

        with self._lock:
            held, self._held = self._held, []
            for source, msg in held:
                try:
                    self._step(source, msg)
                except (NodeStopped, ValueError):
                    pass  # dropped, as the direct link drops it
            self.holding = False
        return len(held)


def _kv_converged(replicas, timeout_s: float) -> bool:
    """Wait until every replica's commit stream sits at one applied index
    and every KvStore snapshot is the same bytes."""
    deadline = time.monotonic() + timeout_s
    while True:
        indexes = {r.stream.status()["applied_index"] for r in replicas}
        if len(indexes) == 1 and len(
            {r.store.snapshot() for r in replicas}
        ) == 1:
            return True
        if time.monotonic() > deadline:
            return False
        time.sleep(0.05)


def app_run(*, device="cuda", ops_per_session=APP_OPS_PER_SESSION,
            nodes=APP_NODES, tick_s=APP_TICK_S) -> dict:
    """The KV rung (see the constants above), then the lagging replica.
    ``ops_per_session``, ``nodes`` and ``tick_s`` shrink it for the CPU
    tests.  Returns the workload's step and history, the linearizable-reads
    evidence (``{"violation": message}`` when the audit fails), whether the replicas converged to one KvStore snapshot, the
    digest counters, and the held replica's catch-up: frames
    held, its engine's counters, the transfer's bytes, chunks and wall,
    whether its snapshot equals the others', and the committed reads
    served from it against a caught-up replica's values."""
    from . import loadgen
    from .chaos.invariants import InvariantViolation, check_linearizable_reads
    from .runtime.node import standard_initial_network_state

    client_ids = list(range(1, APP_SESSIONS + 1))
    lag_node = nodes - 1  # no session is homed on it
    start = time.perf_counter()
    cluster = loadgen.InProcessCluster(
        node_count=nodes,
        client_ids=client_ids,
        batch_size=APP_BATCH_SIZE,
        processor="cuda-pipelined",
        device=device,
        tick_seconds=tick_s,
        app="kv",
    )
    try:
        sessions = {
            cid: cluster.kv_session(cid, home=i % nodes)
            for i, cid in enumerate(client_ids)
        }
        workload = loadgen.KvWorkload(
            sessions,
            loadgen.kv_client_models(client_ids, read_ratio=APP_READ_RATIO),
            seed=APP_SEED,
        )
        step = workload.run_step(
            "app-kv-mixed",
            ops_per_session=ops_per_session,
            op_timeout_s=APP_OP_TIMEOUT_S,
        )
        try:
            evidence = check_linearizable_reads(workload.history)
        except InvariantViolation as err:
            evidence = {"violation": str(err)}
        converged = _kv_converged(cluster.replicas, APP_CONVERGE_S)
        snapshot = cluster.replicas[0].store.snapshot()
        out = {
            "step": step,
            "history": workload.history,
            "linearizable": evidence,
            "converged": converged,
            "snapshot_bytes": len(snapshot),
            "workload_wall_s": time.perf_counter() - start,
        }
        interval = standard_initial_network_state(
            nodes, client_ids
        ).config.checkpoint_interval
        out["lag"] = _lagging_replica(cluster, sessions, lag_node, interval)
        cluster.check()
        out["wall_s"] = time.perf_counter() - start
    finally:
        cluster.close()
    # Read once every node has stopped: the wrappers' counts end there too.
    out.update(_digest_counters(cluster))
    return out


def _lagging_replica(cluster, sessions, lag_node, interval) -> dict:
    """Hold ``lag_node``'s inbound frames while the sessions write, until
    every other node's low watermark sits ``APP_LAG_CHECKPOINTS``
    checkpoint intervals past the held node's; stop writing, release, and
    wait for the held node to install a snapshot and reach the others'
    KvStore bytes.  Then read every written key from it, committed."""
    from .runtime.transfer import decode_frame

    timeout_s = APP_LAG_TIMEOUT_S
    replicas = cluster.replicas
    lagger = replicas[lag_node]
    others = [r for r in replicas if r.node_id != lag_node]
    low0 = lagger.node.status(timeout=5.0).low_watermark
    target = low0 + APP_LAG_CHECKPOINTS * interval
    received = {"bytes": 0, "chunks": 0, "first": None}
    on_frame = lagger.engine.on_frame

    def counting(sender, body):
        try:
            frame = decode_frame(body)
        except ValueError:
            frame = ("?",)
        if frame[0] == "chunk":
            received["bytes"] += len(frame[5])
            received["chunks"] += 1
            if received["first"] is None:
                received["first"] = time.perf_counter()
        on_frame(sender, body)

    lagger.engine.on_frame = counting
    held = _HeldInbound(lagger.node)
    stop = threading.Event()
    written: dict = {}
    written_lock = threading.Lock()

    def writer(cid, session):
        i = 0
        while not stop.is_set():
            key = f"lag-{cid}-{i % 8}"
            value = b"%d:%d" % (cid, i)
            resp = session.put(key, value, timeout=APP_OP_TIMEOUT_S)
            if resp.get("status") == "ok":
                with written_lock:
                    written[key] = value
            i += 1

    threads = [
        threading.Thread(target=writer, args=(cid, s), daemon=True)
        for cid, s in sorted(sessions.items())
    ]
    hold_start = time.perf_counter()
    for thread in threads:
        thread.start()
    deadline = time.monotonic() + timeout_s
    lows = []
    while time.monotonic() < deadline:
        lows = [r.node.status(timeout=5.0).low_watermark for r in others]
        if min(lows) >= target:
            break
        time.sleep(0.1)
    stop.set()
    for thread in threads:
        thread.join(timeout=APP_OP_TIMEOUT_S + 5)
    hold_s = time.perf_counter() - hold_start
    released_at = time.perf_counter()
    frames = held.release()
    caught_up = False
    installed_at = None
    while time.monotonic() < deadline + timeout_s:
        if installed_at is None and lagger.engine.counters[
            "snapshots_installed"
        ]:
            installed_at = time.perf_counter()
        if installed_at is not None and _kv_converged(replicas, 0.0):
            caught_up = True
            break
        time.sleep(0.05)
    reads = []
    if caught_up:
        reader = cluster.kv_session(
            min(sessions), home=lag_node
        )
        reader.session_index = others[0].stream.status()["applied_index"]
        for key, value in sorted(written.items()):
            resp = reader.get(key, mode="committed",
                              timeout=APP_OP_TIMEOUT_S)
            reads.append((key, value.hex(), resp))
    counters = dict(lagger.engine.counters)
    return {
        "node": lag_node,
        "low_watermark_before": low0,
        "target_low_watermark": target,
        "others_low_watermarks": lows,
        "frames_held": frames,
        "hold_s": hold_s,
        "writes": len(written),
        "caught_up": caught_up,
        "transfer_s": (
            None if installed_at is None else installed_at - released_at
        ),
        "transfer_bytes": received["bytes"],
        "transfer_chunks": received["chunks"],
        "engine": counters,
        "snapshot_equal": caught_up and lagger.store.snapshot() == (
            others[0].store.snapshot()
        ),
        "reads": reads,
        "reads_ok": bool(reads) and all(
            resp.get("status") == "ok" and resp.get("value") == want
            for _key, want, resp in reads
        ),
    }


# -- the soak rung ---------------------------------------------------------------
#
# The resource-leak gate's evidence (the JAX package's bench.py:229-245,
# 1511-1735, its constants): a small live cluster (no fsync floor — the
# soak watches resources, not latency) under continuous client traffic for
# BENCH_SOAK_S seconds while obsv.resources samples RSS, open fds, threads,
# the WAL and request-store bytes on disk and the card's allocator; the
# rung reports least-squares leak verdicts that ``obsv --diff`` turns into
# a gate.  Its processor is ``cuda-pipelined``: every digest on the SHA-256
# kernel.  All four nodes run in one process, and the load is light by
# design: the consumers share one interpreter lock, and a saturated cluster
# starves whichever node loses the scheduling race.
SOAK_NODES = 4
SOAK_CLIENTS = 4
SOAK_BATCH_SIZE = 10
SOAK_WINDOW = 4  # outstanding requests a client, below the client width
SOAK_PUSH_S = 0.25
SOAK_CHECKPOINT_INTERVAL = 10
DEFAULT_SOAK_S = 30.0


class _SoakChainLog:
    """Chain log for the soak with commit accounting in O(outstanding
    window): per client, the contiguous committed prefix (``floor``, the
    next uncommitted req_no) plus the sparse set of commits above it.  The
    live rung's ``ChainLog`` keeps every commit, which over a long soak
    would itself read as an RSS leak."""

    def __init__(self, clients):
        self.chain = b""
        self.total = 0
        self._floor = {cid: 0 for cid in clients}
        self._above = {cid: set() for cid in clients}

    def apply(self, q_entry) -> None:
        for ack in q_entry.requests:
            h = hashlib.sha256()
            h.update(self.chain)
            h.update(ack.digest)
            self.chain = h.digest()
            floor = self._floor.get(ack.client_id)
            if floor is None or ack.req_no < floor:
                continue
            above = self._above[ack.client_id]
            if ack.req_no in above:
                continue
            above.add(ack.req_no)
            self.total += 1
            while floor in above:
                above.discard(floor)
                floor += 1
            self._floor[ack.client_id] = floor

    def snap(self, network_config, clients_state) -> bytes:
        return self.chain

    def committed(self, cid: int) -> int:
        return self._floor[cid] + len(self._above[cid])

    def missing(self, cid: int, below: int) -> list:
        """Uncommitted req_nos < ``below``, O(outstanding window)."""
        above = self._above[cid]
        return [
            rn for rn in range(self._floor[cid], below) if rn not in above
        ]


def soak_run(duration_s=None, sample_interval_s=0.5, registry=None, *,
             device="cuda") -> dict:
    """Resource-leak soak: ``SOAK_NODES`` real Nodes over loopback TCP with
    on-disk WAL and request store, ``cuda-pipelined`` processors, under
    continuous windowed client traffic for ``duration_s`` (default
    ``BENCH_SOAK_S``, else 30 s), while an ``obsv.resources.ResourceSampler``
    tracks RSS, open fds, threads, the WAL and request-store trees and, on
    ``cuda``, the card's allocator.

    Returns the JAX rung's document — ``seconds``, ``commits``,
    ``samples``, ``leak`` (a least-squares ``flat``/``growing`` verdict a
    series, the settle-in fifth of each series dropped: ramping from an
    empty store reads as growth that is not a leak) and ``divergence``
    (the shadow oracle's end-of-soak sweep) — plus the kernel's launches
    (``launches``, as the processors counted them, and ``device_digests``,
    ``host_digests``), ``device_samples`` (points in the ``device.*``
    series), the sampler's ``failed_ticks`` and ``last_error``, and
    ``frames_dropped`` by the transports.  The caller gates on them.
    ``device="cpu"`` runs the kernel's plain version; on ``cuda`` without
    a card the rung raises."""
    from . import pb
    from .obsv.metrics import Registry
    from .obsv.resources import ResourceSampler, leak_verdict
    from .ops.batching import resolve_device
    from .runtime import (
        Config,
        FileRequestStore,
        FileWal,
        Node,
        TcpTransport,
        build_processor,
    )
    from .runtime.node import NodeStopped, standard_initial_network_state

    device = resolve_device(device)
    if duration_s is None:
        duration_s = float(os.environ.get("BENCH_SOAK_S", DEFAULT_SOAK_S))
    if registry is None:
        registry = Registry()
    root = tempfile.mkdtemp(prefix="mirbft-torch-soak-")
    clients = list(range(1, SOAK_CLIENTS + 1))
    # Frequent stable checkpoints on purpose: WAL truncation and client GC
    # are part of steady state — without them disk growth is by design.
    # Planned epoch rotation stays deferred past the soak, so rotation
    # noise cannot masquerade as a resource trend.
    state = standard_initial_network_state(
        SOAK_NODES, clients,
        checkpoint_interval=SOAK_CHECKPOINT_INTERVAL,
        max_epoch_length=100 * SOAK_CHECKPOINT_INTERVAL,
    )
    nodes, transports, processors = [], [], []
    wals, stores, logs = [], [], []
    stop = threading.Event()
    threads = []
    failures: list = []

    def consume(node, processor):
        last_tick = time.monotonic()
        try:
            while not stop.is_set():
                actions = node.ready(timeout=0.01)
                if actions is not None:
                    results = processor.process(actions)
                    if results.digests or results.checkpoints:
                        node.add_results(results)
                now = time.monotonic()
                if now - last_tick >= LIVE.tick_s:
                    last_tick = now
                    node.tick()
        except NodeStopped:
            pass
        except Exception as exc:  # noqa: BLE001 — raised by the rung
            failures.append(exc)

    sampler = ResourceSampler(
        registry=registry,
        interval_s=sample_interval_s,
        dirs={
            "wal": os.path.join(root, "wal"),
            "reqstore": os.path.join(root, "reqs"),
        },
        node="bench-soak",
        device=device,
    )
    try:
        for n in range(SOAK_NODES):
            # All WALs under one parent (and the request stores under
            # another) so each family is one sampled disk series.
            wal = FileWal(os.path.join(root, "wal", f"node{n}"))
            store = FileRequestStore(os.path.join(root, "reqs", f"node{n}"))
            # Small reclamation quanta, sized to the soak's write rate, so
            # rotation and compaction fire every few seconds and steady
            # state is a sawtooth the fit reads as flat.
            wal.segment_target = 4 * 1024
            store.compact_min_bytes = 8 * 1024
            app_log = _SoakChainLog(clients)
            node = Node.start_new(
                Config(
                    id=n,
                    batch_size=SOAK_BATCH_SIZE,
                    processor="cuda-pipelined",
                    suspect_ticks=LIVE.suspect_ticks,
                ),
                state,
            )
            transport = TcpTransport(
                n, backoff_base=0.02, backoff_cap=0.25, dial_timeout=1.0
            )
            transport.serve(node)
            processor = build_processor(
                node, transport.link(), app_log, wal, store, device=device
            )
            nodes.append(node)
            transports.append(transport)
            processors.append(processor)
            wals.append(wal)
            stores.append(store)
            logs.append(app_log)
        for n in range(SOAK_NODES):
            for m in range(SOAK_NODES):
                if n != m:
                    transports[n].connect(m, transports[m].address)
        for n in range(SOAK_NODES):
            thread = threading.Thread(
                target=consume,
                args=(nodes[n], processors[n]),
                name=f"torch-soak-consumer-{n}",
                daemon=True,
            )
            threads.append(thread)
            thread.start()

        def propose_all(cid, rn):
            request = pb.Request(client_id=cid, req_no=rn, data=b"%d" % rn)
            for node in nodes:
                try:
                    node.propose(request)
                except (NodeStopped, ValueError):
                    pass

        sampler.start()
        start = time.perf_counter()
        end = start + duration_s
        next_req = {cid: 0 for cid in clients}
        last_push = 0.0
        last_retry = 0.0
        while time.perf_counter() < end:
            if failures:
                raise failures[0]
            now = time.monotonic()
            winner = max(logs, key=lambda log: log.total)
            if now - last_push >= SOAK_PUSH_S:
                # Sliding-window open loop: SOAK_WINDOW fresh requests
                # outstanding past each client's commits on the fastest
                # node.
                last_push = now
                for cid in clients:
                    while next_req[cid] < winner.committed(cid) + SOAK_WINDOW:
                        propose_all(cid, next_req[cid])
                        next_req[cid] += 1
            if now - last_retry >= 0.5:
                # Straggler repair, as in the live rung: re-propose every
                # req_no a log still misses below the proposed mark
                # (below-watermark duplicates are dropped as PAST).
                last_retry = now
                for cid in clients:
                    gaps = set()
                    for log in logs:
                        gaps.update(log.missing(cid, next_req[cid]))
                    for rn in sorted(gaps):
                        propose_all(cid, rn)
            time.sleep(0.02)
        elapsed = time.perf_counter() - start
        sampler.stop()
        if failures:
            raise failures[0]
        series = sampler.snapshot_series()
        # device.* series ride the sampler's cadence but stay out of the
        # leak fit (ResourceSampler.verdicts says why).
        leak = {
            name: leak_verdict(samples[len(samples) // 5:])
            for name, samples in series.items()
            if not name.startswith("device.")
        }
        # End-of-soak divergence sweep: every node runs the shadow oracle
        # on its serializer thread; a nonzero count fails obsv --diff.
        divergence = 0
        for node in nodes:
            divs = node.audit_divergence(timeout=5.0)
            if divs:
                divergence += len(divs)
        drops = [_transport_drops(transport) for transport in transports]
        return {
            "seconds": round(elapsed, 1),
            "commits": max((log.total for log in logs), default=0),
            "samples": max((len(s) for s in series.values()), default=0),
            "leak": leak,
            "divergence": divergence,
            "device": str(device),
            "launches": sum(p.launches for p in processors),
            "device_digests": sum(p.device_digests for p in processors),
            "host_digests": sum(p.host_digests for p in processors),
            "device_samples": max(
                (len(s) for name, s in series.items()
                 if name.startswith("device.")),
                default=0,
            ),
            "failed_ticks": sampler.failed_ticks,
            "last_error": sampler.last_error,
            "frames_dropped": drops,
        }
    finally:
        sampler.stop()
        stop.set()
        for thread in threads:
            thread.join(timeout=10)
        for processor in processors:
            closer = getattr(processor, "close", None)
            if closer is not None:
                closer()
        for transport in transports:
            transport.close(0)
        for node in nodes:
            node.stop()
        for wal in wals:
            wal.close()
        for store in stores:
            store.close()
        shutil.rmtree(root, ignore_errors=True)
