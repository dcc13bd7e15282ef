"""The port's benchmarks: the SHA-256 kernel microbenchmark and the live rung.

Counterparts of two parts of the JAX package's ``bench.py``, with its
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

Both run on ``cuda`` unless the caller passes ``device="cpu"`` (the kernels'
plain versions; the tests' route), and raise without a card.
``chip_smoke.py`` (phases 10 and 11) runs both on a card.
"""

from __future__ import annotations

import dataclasses
import hashlib
import multiprocessing
import multiprocessing.connection
import os
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
               root: str, conn) -> None:
    """One node of the live rung, in a process of its own, steered by the
    parent over ``conn``: it sends ``("address", address)``, receives every
    node's address, connects and sends ``("ready", None)``; on ``"go"`` it
    proposes every request to its node, re-proposes what its node has not
    committed every ``LIVE_RETRY_S``, sends ``("reached", instant)`` once
    its node has committed the target (the instant of the target-th first
    commit, on the monotonic clock that every process shares) and, on
    ``"stop"``, shuts down and sends ``("result", {...})``.  A failure
    sends ``("error", traceback)``."""
    try:
        _run_live_node(n, kind, device, settings, root, conn)
    except BaseException:  # noqa: BLE001 — reported to the parent
        try:
            conn.send(("error", f"node {n}:\n{traceback.format_exc()}"))
        except OSError:
            pass  # the parent is gone
    finally:
        conn.close()


def _run_live_node(n, kind, device, settings, root, conn) -> None:
    from . import pb
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
    node = Node.start_new(
        Config(
            id=n, batch_size=settings.batch_size, processor=kind,
            suspect_ticks=settings.suspect_ticks,
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
        conn.send(("address", transport.address))
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
                      settings: LiveSettings = LIVE) -> dict:
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
    preimages and digests; see ``_CudaHashMixin``)."""
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
                args=(n, kind, str(device), settings, root, theirs),
                name=f"torch-live-node-{n}", daemon=True,
            )
            process.start()
            theirs.close()
            conns.append(ours)
            processes.append(process)
        addresses = {
            n: _receive(conn, "address", LIVE_START_TIMEOUT_S, n)
            for n, conn in enumerate(conns)
        }
        for conn in conns:
            conn.send(addresses)
        for n, conn in enumerate(conns):
            _receive(conn, "ready", LIVE_START_TIMEOUT_S, n)
        start = time.perf_counter()
        for conn in conns:
            conn.send("go")
        deadline = start + settings.deadline_s
        reached = None
        while reached is None and time.perf_counter() < deadline:
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
