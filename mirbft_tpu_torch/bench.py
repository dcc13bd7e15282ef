"""The port's bench: ``python -m mirbft_tpu_torch.bench [--device cpu]``
runs every stage of the JAX package's root ``bench.py`` and prints one JSON
object under its key and stage names; ``--recover [journal]`` rebuilds the
object from the stage journal of a run that was killed.

Counterparts of the JAX package's ``bench.py``, with its constants and its
measurement protocols:

- ``main`` and its machinery (``bench.py:47-75, 1729-2522``):
  ``BenchStream`` (the fsynced stage journal, ``BENCH_STREAM_PATH``), ``StageRunner`` (each stage on a
  daemon thread under one budget, ``BENCH_BUDGET_S`` clamped under
  ``BENCH_HARNESS_TIMEOUT_S``, its warm-up outside the timed window),
  ``Watchdog``, ``main`` and ``recover_main``.  The JAX host processor
  kinds map to their kernel twins (serial -> cuda, pipelined ->
  cuda-pipelined).  Where the JAX ``main`` exits 0 after a stage's
  exception, the port's returns 1: a kernel that fails to build or launch
  must not read as a bench that passed;
- ``ladder_run`` and ``warm_kernel_shapes`` (``bench.py:572-619``): rung 2,
  the engine at 16 nodes x 64 clients x 100 requests on the kernel hash
  plane, and the host plane's run it must replay;
- ``ed25519_microbench`` (``bench.py:622-668``): both Ed25519 kernels
  against the pure-Python oracle;
- ``rung3_run`` (``bench.py:671-760``): rung 3, 64 nodes x 1024 signed
  clients x 8, speculative verification on the Ed25519 kernels;
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
- ``rung4_run`` (``bench.py:763-841``): rung 4 with BLS certificates.
- ``rung5_run`` (``bench.py:844-930``): rung 5, 256 nodes x 1024 clients
  with a follower crashed and restarted, every digest on the SHA-256
  kernel.
- ``app_run`` (``bench.py:1331-1381``): the KV service under the app
  rung's sessions through the service sockets of worker processes, then a
  replica stopped and restarted from its disk that catches up by state
  transfer; ``ingress_run``: signed client ingress (the multi-process
  rung's traffic) on the in-process cluster.
- ``soak_run`` (``bench.py:229-245, 1511-1735``): the resource-leak soak.
- ``live_mp_run``, ``reconfig_run`` and ``knee_run`` (``bench.py:133-155,
  183-221, 1192-1330, 1384-1510``): the multi-process rungs, one worker
  process a node under ``cluster.ClusterSupervisor`` — the open-loop
  Poisson steps (signed too: ``SpeculativeIngress`` on the Ed25519
  kernels in every worker, each batch journaled, forged twins), the
  add-node reconfiguration A/B, and the capacity knee with its critical
  path; each worker's exit codes and kernel evidence come back with them.

All run on ``cuda`` unless the caller passes ``device="cpu"`` (the kernels'
plain versions; the tests' route), and raise without a card.
``chip_smoke.py`` (phases 3, 4, 8, 10, 11, 13, 15-17, 22 and 24) runs them on
a card, ``tests/cluster_rungs.py`` the knee.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import hashlib
import json
import multiprocessing
import multiprocessing.connection
import os
import random
import shutil
import signal
import sys
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
ACKPLANE_CLIENTS = int(os.environ.get("BENCH_ACKPLANE_CLIENTS", "100000"))
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

# The live flood A/B (the JAX package's bench.py:222-228): the paper's
# request-duplication flood at the client seam, every submission delivered
# (1 + copies) times to every node.  The dedup tax is the goodput and p95
# delta against a clean run of the same kind in the same call.
LIVE_ATTACK_COPIES = 3


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


class RungResult(tuple):
    """The JAX rung's return tuple, unpacked as the JAX ``main`` unpacks
    it, with the run's evidence beside it as attributes (the planes, the
    recorder's per-node state, CPU seconds) for callers that gate on more
    than the tuple (``chip_smoke.py`` phases 3, 4, 8 and 12)."""

    def __new__(cls, values, **evidence):
        result = super().__new__(cls, values)
        result.__dict__.update(evidence)
        return result


class _CollectorSeconds:
    """Seconds the cyclic garbage collector spends inside the block."""

    def __init__(self):
        self.seconds = 0.0
        self._start = 0.0

    def _on_gc(self, phase, _info):
        if phase == "start":
            self._start = time.perf_counter()
        else:
            self.seconds += time.perf_counter() - self._start

    def __enter__(self):
        gc.callbacks.append(self._on_gc)
        return self

    def __exit__(self, *_exc):
        gc.callbacks.remove(self._on_gc)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# -- ladder rung 2 ---------------------------------------------------------------
#
# The BASELINE ladder metric (the JAX package's bench.py:85-99, 572-619): a
# full engine run, 16 nodes (f = 5), 64 clients x 100 requests, BatchSize
# 200, every digest through the hash plane, with a 400 ms modelled
# Actions -> Results round trip applied to every plane alike.
NODES = 16
CLIENTS = 64
REQS_PER_CLIENT = 100
BATCH_SIZE = 200
READY_LATENCY_MS = 400  # modelled Actions -> Results crypto-plane RTT


def ladder_run(hash_plane=None, *, device="cuda",
               reqs_per_client=REQS_PER_CLIENT,
               ready_latency=READY_LATENCY_MS, **recorder_kw):
    """Rung 2 to full commitment on ``hash_plane``: the kernel plane
    (``AsyncKernelHashPlane``, warmed by ``warm_kernel_shapes``) or, when
    None, the host plane (``CoalescingHashPlane``, hashlib), the JAX
    rung's host baseline.  ``reqs_per_client`` and ``ready_latency``
    (None: the engine's default parameters) cut it to the determinism
    anchor; ``recorder_kw`` reaches ``BasicRecorder`` (the device ack
    plane).

    Earlier runs' garbage is collected first, outside the clock: each
    recorder holds reference cycles, and a full collection of several
    dead ones inside a timed run costs seconds.  On a card the clock
    stops after a synchronize.

    Returns the JAX tuple ``(wall s, events, app chain, simulated ms)``
    as a ``RungResult`` whose attributes hold the CPU seconds of the
    process (``cpu_s``), of its main thread (``thread_s``) and in the
    collector (``gc_s``), each node's chain (``chains``) and committed
    sequence (``committed``), the commit counts (``counts``) and the
    plane.  Raises when the nodes' chains differ."""
    from .ops.batching import resolve_device
    from .testengine.crypto_plane import CoalescingHashPlane
    from .testengine.engine import BasicRecorder, RuntimeParameters

    device = resolve_device(device)
    if hash_plane is None:
        hash_plane = CoalescingHashPlane()
    params = (
        RuntimeParameters(ready_latency=ready_latency)
        if ready_latency is not None else RuntimeParameters()
    )
    gc.collect()
    with _CollectorSeconds() as collector:
        cpu = (time.process_time(), time.thread_time())
        start = time.perf_counter()
        rec = BasicRecorder(
            NODES, CLIENTS, reqs_per_client, batch_size=BATCH_SIZE,
            params=params, hash_plane=hash_plane,
            # Steady-state timing: the recorded-events list is not
            # consensus work.
            record=False, **recorder_kw,
        )
        events = rec.drain_clients(max_steps=20_000_000)
        _sync(device)
        wall = time.perf_counter() - start
        cpu = (time.process_time() - cpu[0], time.thread_time() - cpu[1])
    chains = {n: s.app_chain for n, s in rec.node_states.items()}
    if len(set(chains.values())) != 1:
        raise AssertionError("rung 2: the nodes diverged")
    return RungResult(
        (wall, events, chains[0], rec.now),
        cpu_s=cpu[0], thread_s=cpu[1], gc_s=collector.seconds,
        chains=chains,
        committed={n: list(s.committed_reqs)
                   for n, s in rec.node_states.items()},
        counts=[rec.committed_at(n) for n in range(NODES)],
        plane=hash_plane,
    )


def warm_kernel_shapes(plane) -> None:
    """Launch every packed shape the rung can give the SHA-256 kernel, one
    a block bucket (1 to 128 blocks at ``plane.rows_for`` rows: request
    and ack preimages pad to 1 block, a full batch's 200 acks x 32 B to
    128), on the plane's device, before the timed run: the first launch
    loads the library, and each shape's first launch pays its allocations."""
    from .ops.sha256 import sha256_digest_words

    for bucket in (1, 2, 4, 8, 16, 32, 64, 128):
        rows = plane.rows_for(bucket)
        blocks = torch.zeros((rows, bucket, 16), dtype=torch.int32,
                             device=plane.device)
        n_blocks = torch.ones((rows,), dtype=torch.int32, device=plane.device)
        sha256_digest_words(blocks, n_blocks).cpu()


# -- the Ed25519 microbenchmark --------------------------------------------------
#
# Batched signature verification (the JAX package's bench.py:622-668):
# both Ed25519 kernels on 4096 distinct signatures (seed i signs
# b"bench-request-%d" % i) against the pure-Python host oracle.
ED25519_BATCH = 4096
ED25519_HOST_SAMPLE = 64
SIGN_PROCESSES = 8  # a corpus of this many rows or more signs in a pool
SIGN_POOL_MIN_ROWS = 256


def _microbench_row(i: int) -> tuple:
    from .crypto import ed25519_host

    seed = i.to_bytes(32, "little")
    message = b"bench-request-%d" % i
    return (ed25519_host.public_key(seed), message,
            ed25519_host.sign(seed, message))


def ed25519_corpus(batch: int = ED25519_BATCH) -> list:
    """[(public key, message, signature)] of the microbenchmark, seed ``i``
    signing ``b"bench-request-%d" % i``; signed in a pool of spawned
    processes from ``SIGN_POOL_MIN_ROWS`` rows (the same bytes)."""
    if batch < SIGN_POOL_MIN_ROWS:
        return [_microbench_row(i) for i in range(batch)]
    context = multiprocessing.get_context("spawn")
    with context.Pool(SIGN_PROCESSES) as pool:
        return pool.map(_microbench_row, range(batch), chunksize=64)


def ed25519_microbench_warmup(batch: int = ED25519_BATCH, *,
                              device="cuda") -> None:
    """Build and load both Ed25519 kernels and launch them once at the
    microbenchmark's batch, outside the timed window."""
    from .crypto import ed25519_host
    from .ops.ed25519 import verify_batch_pallas

    seed = (0).to_bytes(32, "little")
    message = b"bench-warmup"
    pk, sig = ed25519_host.public_key(seed), ed25519_host.sign(seed, message)
    if not all(verify_batch_pallas([pk] * batch, [message] * batch,
                                   [sig] * batch, device=device)):
        raise AssertionError("ed25519 warm-up: a valid signature failed")


def ed25519_microbench(batch: int = ED25519_BATCH, *,
                       device="cuda") -> tuple:
    """Both Ed25519 kernels through the port's verify entry point
    (``ops.ed25519.verify_batch_pallas``: host marshalling, the
    decompression and ladder launches, the readback) against the
    pure-Python host oracle.  The corpus (``ed25519_corpus``) verifies
    once, all true, untimed; then two timed calls on distinct inputs (each
    message with ``!``, then ``?``, appended) must reject every row, and
    the faster one counts.  The oracle is timed over the first
    ``ED25519_HOST_SAMPLE`` rows.  Returns the JAX pair (kernel verifies/s,
    host verifies/s)."""
    from .crypto import ed25519_host
    from .ops.batching import resolve_device
    from .ops.ed25519 import verify_batch_pallas

    device = resolve_device(device)
    corpus = ed25519_corpus(batch)
    pks, msgs, sigs = map(list, zip(*corpus))
    if not all(verify_batch_pallas(pks, msgs, sigs, device=device)):
        raise AssertionError("ed25519 microbench: a valid signature failed")
    times = []
    for rep in (b"!", b"?"):  # distinct inputs a timed call; best of 2
        flipped = [m + rep for m in msgs]
        start = time.perf_counter()
        got = verify_batch_pallas(pks, flipped, sigs, device=device)
        times.append(time.perf_counter() - start)
        if any(got):
            raise AssertionError(
                "ed25519 microbench: a flipped message verified"
            )
    kernel_rate = batch / min(times)

    sample = corpus[:ED25519_HOST_SAMPLE]
    start = time.perf_counter()
    for pk, msg, sig in sample:
        if not ed25519_host.verify(pk, msg, sig):
            raise AssertionError("ed25519 microbench: the oracle rejected")
    host_rate = len(sample) / (time.perf_counter() - start)
    return kernel_rate, host_rate


# -- ladder rung 3 ---------------------------------------------------------------
#
# BASELINE ladder rung 3 (the JAX package's bench.py:671-760, constants in
# testengine/rung3.py): 64 nodes (f = 21), 1024 Ed25519-signed clients x
# 8 requests, BatchSize 200, speculative batched ingress verification on
# both Ed25519 kernels and every digest on the SHA-256 kernel.


def _p99(seconds: list):
    """The 99th percentile of ``seconds``, in ms (None when empty)."""
    if not seconds:
        return None
    ms = sorted(1e3 * s for s in seconds)
    return ms[min(len(ms) - 1, int(0.99 * len(ms)))]


def rung3_run(*, device="cuda", nodes=None, clients=None, reqs=None,
              presigned=None) -> tuple:
    """Rung 3 to full commitment on a ``SpeculativeSignaturePlane`` and an
    ``AsyncKernelHashPlane`` on ``device``.  ``nodes``, ``clients`` and
    ``reqs`` default to ``testengine/rung3.py``'s; the clients sign before
    the clock starts (``presigned``, from ``rung3.presign`` at the same
    cut, else signed here, in a pool of spawned processes from
    ``SIGN_POOL_MIN_ROWS`` requests).

    Raises unless the nodes hold one chain and every node committed every
    request.  Returns the JAX tuple ``(committed req/s, verify p99 ms,
    events, verified, stats, simulated ms)``, ``stats`` the JAX
    ``rung3_*`` counters, as a ``RungResult`` whose attributes hold the
    app chain (``chain``, hex), the wall, the CPU seconds (``cpu_s``,
    ``thread_s``, ``gc_s``) and the two planes (``signature_plane``,
    ``hash_plane``)."""
    from .ops.batching import resolve_device
    from .testengine import rung3
    from .testengine.crypto_plane import AsyncKernelHashPlane
    from .testengine.engine import BasicRecorder
    from .testengine.signing import SpeculativeSignaturePlane

    device = resolve_device(device)
    nodes = rung3.NODES if nodes is None else nodes
    clients = rung3.CLIENTS if clients is None else clients
    reqs = rung3.REQS if reqs is None else reqs
    total = clients * reqs
    if presigned is None:
        presigned = rung3.presign(
            SIGN_PROCESSES if total >= SIGN_POOL_MIN_ROWS else 1,
            nodes=nodes, clients=clients, reqs=reqs,
        )
    plane = SpeculativeSignaturePlane(device=device)
    hash_plane = AsyncKernelHashPlane(device=device)
    gc.collect()
    with _CollectorSeconds() as collector:
        cpu = (time.process_time(), time.thread_time())
        start = time.perf_counter()
        rec = BasicRecorder(
            nodes, clients, reqs, batch_size=rung3.BATCH_SIZE,
            network_state=rung3.network_state(nodes, clients),
            signer=lambda cid, rn, _payload: presigned[(cid, rn)],
            signature_plane=plane, hash_plane=hash_plane, record=False,
        )
        events = rec.drain_clients(max_steps=50_000_000)
        _sync(device)
        wall = time.perf_counter() - start
        cpu = (time.process_time() - cpu[0], time.thread_time() - cpu[1])
    chains = {rec.node_states[n].app_chain for n in range(nodes)}
    if len(chains) != 1:
        raise AssertionError(f"rung 3: the nodes hold {len(chains)} chains")
    if not all(rec.committed_at(n) == total for n in range(nodes)):
        raise AssertionError(f"rung 3: not every node committed {total}")
    p99_ms = _p99(plane.flush_wall_s)
    stats = {
        "rung3_speculative_admits": plane.admitted,
        "rung3_speculative_evictions": plane.speculative_evictions,
        "rung3_forced_joins": plane.forced_joins,
        "rung3_device_verifies": plane.device_verifies,
        "rung3_host_verifies": plane.host_verifies,
    }
    return RungResult(
        (total / wall, p99_ms, events, sum(plane.flush_sizes), stats,
         rec.now),
        chain=chains.pop().hex(), wall_s=wall, cpu_s=cpu[0],
        thread_s=cpu[1], gc_s=collector.seconds, signature_plane=plane,
        hash_plane=hash_plane,
    )


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
               root: str, conn, trace_dir=None, flood_copies=0) -> None:
    """One node of the live rung, in a process of its own, steered by the
    parent over ``conn``: it sends ``("address", address)``, receives every
    node's address, connects and sends ``("ready", None)``; on ``"go"`` it
    proposes every request to its node, re-proposes what its node has not
    committed every ``LIVE_RETRY_S``, sends ``("reached", instant)`` once
    its node has committed the target (the instant of the target-th first
    commit, on the monotonic clock that every process shares) and, on
    ``"stop"``, shuts down and sends ``("result", {...})``.  A failure
    sends ``("error", traceback)``.  With ``trace_dir`` the node runs
    traced, and with ``flood_copies`` every proposal is made ``1 +
    flood_copies`` times (see ``live_cluster_rate``)."""
    try:
        _run_live_node(n, kind, device, settings, root, conn, trace_dir,
                       flood_copies)
    except BaseException:  # noqa: BLE001 — reported to the parent
        try:
            conn.send(("error", f"node {n}:\n{traceback.format_exc()}"))
        except OSError:
            pass  # the parent is gone
    finally:
        conn.close()


def _run_live_node(n, kind, device, settings, root, conn,
                   trace_dir=None, flood_copies=0) -> None:
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
        flooded = [0]  # copies proposed past the first

        def propose(pending):
            for client_id, req_no in sorted(pending):
                propose_times.setdefault(
                    (client_id, req_no), time.perf_counter()
                )
                request = pb.Request(
                    client_id=client_id, req_no=req_no, data=b"%d" % req_no,
                )
                for _copy in range(1 + flood_copies):
                    try:
                        node.propose(request)
                    except (NodeStopped, ValueError):
                        pass
                flooded[0] += flood_copies

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
        "flooded": flooded[0],
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
                      on_running=None, flood_copies=0) -> dict:
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
    every hash request of every node was launched, the kernel launched,
    the audit saw every launch (on a card: as many as the wrappers
    counted), and every kept launch read back hashlib's digests.  A live TCP run is not deterministic: chains are compared
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
    tracer's abandoned flows and the sequences it traced as committed.

    ``flood_copies`` > 0 turns the client seam hostile, as the JAX
    package's rung does (bench.py:1100-1116): every node's process
    proposes every request ``1 + flood_copies`` times to its node, on
    the first pass and on every retry, and ``flooded`` counts the copies
    past the first.  Dedup must absorb them: the gates above hold under
    the flood."""
    from .ops.batching import resolve_device
    from .ops.sha256 import _IV as _SHA256_IV
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
                      trace_dir, flood_copies),
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
        "flooded": sum(node["flooded"] for node in nodes),
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
        if device.type == "cuda" and (
            result["wrapper_launches"] != result["launches"]
        ):
            raise AssertionError(
                f"live rung ({kind}): the wrappers counted "
                f"{result['wrapper_launches']} launches, the processors "
                f"{result['launches']}"
            )
        # Each kept launch read back hashlib's digests, and the IV (an
        # empty row's state) in its padding rows.
        iv = b"".join(word.to_bytes(4, "big") for word in _SHA256_IV)
        for shape, (_launches, kept) in samples.items():
            for preimages, raw in kept:
                want = b"".join(hashlib.sha256(m).digest() for m in preimages)
                if raw != want + iv * (shape[0] - len(preimages)):
                    raise AssertionError(
                        f"live rung ({kind}): a launch of shape {shape} "
                        "read back digests that are not hashlib's"
                    )
    return result


def live_attack_run(kind: str = "cuda", *, device="cuda",
                    settings: LiveSettings = LIVE) -> dict:
    """The live flood A/B (the JAX package's bench.py:1177-1189): the same
    executor ``kind`` first under honest clients, then under a
    client-seam duplication flood (every submission delivered ``1 +
    LIVE_ATTACK_COPIES`` times to every node, the Mir paper's
    request-duplication attack).  Both halves are ``live_cluster_rate``
    runs and hold its gates: no request committed twice, one chain prefix
    and, for a ``cuda*`` kind, every digest launched on the kernel and
    none on the host.  Returns each half's goodput (``rate``), p95 commit
    latency and flooded submissions, and both halves' results."""
    clean = live_cluster_rate(kind, device=device, settings=settings)
    flood = live_cluster_rate(
        kind, device=device, settings=settings,
        flood_copies=LIVE_ATTACK_COPIES,
    )
    if flood["flooded"] <= 0:
        raise AssertionError(f"live flood ({kind}): no copy was proposed")
    return {
        "kind": kind,
        "copies": LIVE_ATTACK_COPIES,
        "clean_rate": clean["rate"],
        "clean_p95_ms": clean["p95_ms"],
        "clean_flooded": clean["flooded"],
        "flood_rate": flood["rate"],
        "flood_p95_ms": flood["p95_ms"],
        "flooded": flood["flooded"],
        "clean": clean,
        "flood": flood,
    }

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


# BASELINE ladder rung 5 (the JAX package's bench.py:839-930, its recipe):
# 256 nodes (f = 85) over a WAN of 20 ms link jitter, 1024 clients x 1
# request, BatchSize 200, 4 rotating leader buckets, checkpoints every 20
# sequences, and a follower (node 200) crashed after 20,000 engine steps
# and restarted from its durable state 40,000 steps later.  At this shape
# both land before the first commit (~275 and ~288 simulated ms); the
# restarted node then sits at 0 commits until it installs the others'
# checkpoint at seq 100 by state transfer (PERF.md §5 and §6).
RUNG5_NODES = 256
RUNG5_CLIENTS = 1024
RUNG5_REQS = 1
RUNG5_BATCH_SIZE = 200
RUNG5_JITTER_MS = 20
RUNG5_CRASH_NODE = 200
RUNG5_CRASH_AFTER = 20_000
RUNG5_DOWN_FOR = 40_000
RUNG5_MAX_STEPS = 50_000_000


class StageCancelled(Exception):
    """Raised inside a stage at its next engine event once the stage's
    budget has run out (``StageRunner.cancel``)."""


class Rung5Watch:
    """Rung 5's interceptor: the crashed node's record and, every
    ``every`` events, a progress line (a dict) to ``progress``.

    It records each snapshot the node installs (a state transfer
    delivered to it, at simulated ms) and the simulated ms of the first
    event after its restart at which its commits had grown.  It reads only
    what both packages' recorders and state machines share, so the JAX
    recipe can be watched with it too.  With ``cancel`` (an event) set,
    the next engine event raises ``StageCancelled``."""

    def __init__(self, crash_node: int, total: int, *, progress=None,
                 every: int = 50_000, cancel=None):
        self.rec = None
        self.crash_node = crash_node
        self.total = total
        self.progress = progress
        self.every = every
        self.cancel = cancel
        self.installs: list = []  # [(simulated ms, seq)]
        self.commits_at_restart = None
        self.first_commit_ms = None
        self.started = time.perf_counter()

    def watch(self, rec) -> None:
        self.rec = rec
        rec.interceptor = self

    def restarted(self) -> None:
        self.commits_at_restart = self.rec.committed_at(self.crash_node)

    def __call__(self, node, now, event) -> None:
        rec = self.rec
        if self.cancel is not None and self.cancel.is_set():
            raise StageCancelled(f"stopped at {rec.event_count} events")
        if (
            self.first_commit_ms is None
            and self.commits_at_restart is not None
            and rec.committed_at(self.crash_node) > self.commits_at_restart
        ):
            self.first_commit_ms = now
        if (
            node == self.crash_node
            and type(event.type).__name__ == "EventTransfer"
            and event.type.c_entry.network_state is not None
        ):
            self.installs.append((now, event.type.c_entry.seq_no))
        if self.progress is not None and rec.event_count % self.every == 0:
            self.progress(self.line())

    def outcome(self) -> dict:
        """After the drain: the simulated ms of the crashed node's first
        commit after its restart, its installs, whether its first commit
        came from a snapshot or it ordered on from its replayed WAL, and
        its last committed seq."""
        rec, node = self.rec, self.crash_node
        if (
            self.first_commit_ms is None
            and rec.committed_at(node) > self.commits_at_restart
        ):
            self.first_commit_ms = rec.now  # committed in the last event
        first = self.installs[0] if self.installs else None
        return {
            "first_commit_ms": self.first_commit_ms,
            "installs": self.installs,
            "returned_by": (
                "snapshot"
                if first is not None
                and self.first_commit_ms is not None
                and first[0] <= self.first_commit_ms
                else "wal-replay"
            ),
            "last_seq": rec.node_states[node].last_committed,
        }

    def line(self) -> dict:
        """Wall, events, simulated ms; the nodes short of every request;
        the crashed node's commits, last committed seq, epoch and whether
        a transfer is in flight; node 0's last seq and checkpoint."""
        rec, node = self.rec, self.crash_node
        machine = rec.machines[node]
        epoch = machine.epoch_tracker.current_epoch
        zero = rec.node_states[0]
        return {
            "wall_s": round(time.perf_counter() - self.started, 3),
            "events": rec.event_count,
            "sim_ms": rec.now,
            "short": sum(
                rec.committed_at(n) < self.total
                for n in range(rec.node_count)
            ),
            "node": node,
            "commits": rec.committed_at(node),
            "last_seq": rec.node_states[node].last_committed,
            "epoch": None if epoch is None else epoch.number,
            "transferring": machine.commit_state.transferring,
            "node0_seq": zero.last_committed,
            "node0_checkpoint": max(zero.checkpoints, default=0),
        }


def rung5_run(*, device="cuda", hash_plane=None, nodes=RUNG5_NODES,
              clients=RUNG5_CLIENTS, crash_node=RUNG5_CRASH_NODE,
              crash_after=RUNG5_CRASH_AFTER, down_for=RUNG5_DOWN_FOR,
              max_steps=RUNG5_MAX_STEPS, progress=None, every=50_000,
              cancel=None) -> dict:
    """BASELINE ladder rung 5 on the kernel hash plane
    (``AsyncKernelHashPlane(device)``; ``device="cpu"``: its plain
    version).  ``hash_plane`` replaces it (a sizing run on the CPU may
    pass a ``CoalescingHashPlane``: the events do not depend on the
    plane).  The keywords cut the rung for tests; ``progress``,
    ``every`` and ``cancel`` go to its ``Rung5Watch``.

    Steps the engine ``crash_after`` times, crashes ``crash_node``, steps
    ``down_for`` more, schedules its restart at once, then drains every
    request in one ``drain_clients(max_steps)`` call, as the JAX rung
    does.  Raises ``AssertionError`` unless the nodes hold one chain, every
    node committed every request and, on the kernel plane, no digest ran
    on the host.  Returns committed req/s over the run's wall, engine
    events, simulated ms, the wall, the chain, the commit counts, the
    hash plane's counters and the crashed node's record (``crash``)."""
    from . import pb
    from .ops.batching import resolve_device
    from .testengine.crypto_plane import AsyncKernelHashPlane
    from .testengine.engine import BasicRecorder, RuntimeParameters

    device = resolve_device(device)
    if hash_plane is None:
        hash_plane = AsyncKernelHashPlane(device=device)
    total = clients * RUNG5_REQS
    watch = Rung5Watch(crash_node, total, progress=progress, every=every,
                       cancel=cancel)
    start = time.perf_counter()
    rec = BasicRecorder(
        nodes,
        clients,
        RUNG5_REQS,
        batch_size=RUNG5_BATCH_SIZE,
        network_state=pb.NetworkState(
            config=pb.NetworkConfig(
                nodes=list(range(nodes)),
                f=(nodes - 1) // 3,
                number_of_buckets=4,
                checkpoint_interval=20,
                max_epoch_length=200,
            ),
            clients=[
                pb.NetworkClient(id=nodes + i, width=2, low_watermark=0)
                for i in range(clients)
            ],
        ),
        record=False,
        hash_plane=hash_plane,
        params=RuntimeParameters(link_jitter=RUNG5_JITTER_MS),
    )
    watch.watch(rec)
    for _ in range(crash_after):
        rec.step()
    crash = {
        "node": crash_node,
        "crash_ms": rec.now,
        "crash_events": rec.event_count,
        "committed_anywhere_at_crash": sum(
            len(c.committed_anywhere) for c in rec.clients.values()
        ),
    }
    rec.crash(crash_node)
    for _ in range(down_for):
        rec.step()
    rec.schedule_restart(crash_node, delay=0)
    crash["restart_ms"] = rec.now
    crash["restart_events"] = rec.event_count
    watch.restarted()
    events = rec.drain_clients(max_steps=max_steps)
    _sync(device)
    wall = time.perf_counter() - start
    chains = {rec.node_states[n].app_chain for n in range(nodes)}
    if len(chains) != 1:
        raise AssertionError(f"rung 5: the nodes hold {len(chains)} chains")
    commits = sorted({rec.committed_at(n) for n in range(nodes)})
    if commits != [total]:
        raise AssertionError(
            f"rung 5: commits {commits}, not {total} at every node"
        )
    kernel_plane = isinstance(hash_plane, AsyncKernelHashPlane)
    if kernel_plane and hash_plane.host_digests:
        raise AssertionError(
            f"rung 5: {hash_plane.host_digests} digests ran on the host"
        )
    crash.update(watch.outcome())
    return {
        "reqs_per_sec": total / wall,
        "events": events,
        "sim_ms": rec.now,
        "wall_s": wall,
        "chain": chains.pop().hex(),
        "commits": commits,
        "device_digests": getattr(hash_plane, "device_digests", 0),
        "host_digests": hash_plane.host_digests,
        "hash_launches": getattr(hash_plane, "launches", 0),
        "kernel_ms": getattr(hash_plane, "kernel_ms", 0.0),
        "crash": crash,
    }


# -- the live node as a replicated service ----------------------------------
#
# Two rungs, every node on the cuda-pipelined processor, each on worker
# processes (``live_mp_run(signed=True)``, ``app_run``); the signed one
# also on the in-process cluster (loadgen/inproc.py: N real Nodes in one
# process, direct-call links, in-memory storage; ``ingress_run``, traced
# in one process).
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
# lagging replica: stopped until the others have garbage-collected
# APP_LAG_CHECKPOINTS checkpoints past it; restarted, it must catch up by
# state transfer.
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
    """The load generator's cluster for the signed-ingress rungs: node ids
    and commit polling are the cluster's, and ``submit`` hands the request
    to ``deliver(node_id, request)``: the node's ingress stage in process,
    or the supervisor's submission to a worker, whose transport hands it
    to the worker's ingress stage.  Every ``forge_every``-th distinct
    request gets a forged twin, one seeded bit of its signature's S
    flipped, submitted to each node right after the honest request's
    first submission there."""

    def __init__(self, cluster, deliver, forge_every: int, seed: int):
        from . import pb
        from .testengine.signing import PK_LEN, SIG_LEN

        self._request = pb.Request
        self._s_at = (SIG_LEN // 2 + PK_LEN, PK_LEN)  # S: data[-64:-32]
        self.cluster = cluster
        self.deliver = deliver
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
        self.deliver(node_id, request)
        forged = self.forged.get(key)
        if forged is not None and (*key, node_id) not in self._sent:
            self._sent.add((*key, node_id))
            self.forged_to[node_id] += 1
            self.deliver(node_id, self._request(
                client_id=request.client_id, req_no=request.req_no,
                data=forged,
            ))


def _register_client_keys(client_ids) -> None:
    """Register each signing client's public key in this process, as a
    replica's configuration would hand it (``ingress_rows`` and the host
    checks read them)."""
    from .crypto import ed25519_host
    from .testengine import signing

    for cid in client_ids:
        signing.register_pk(
            cid, ed25519_host.public_key(signing.client_seed(cid))
        )


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
    from .obsv import hooks
    from .runtime.ingress import SpeculativeIngress
    from .testengine import signing

    _register_client_keys(INGRESS_CLIENTS)
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
            cluster, lambda n, request: ingress[n].submit(request),
            INGRESS_FORGE_EVERY, INGRESS_SEED,
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


def _app_states(supervisor) -> dict:
    """node id -> the KV worker's last ``app.json`` (its commit stream's
    status and the SHA-256 of its KvStore snapshot), for the live nodes
    that have published one."""
    from .cluster.worker import read_json

    out = {}
    for handle in supervisor.nodes:
        doc = read_json(os.path.join(handle.dir, "app.json"))
        if handle.alive and doc is not None:
            out[handle.node_id] = doc
    return out


def _transfer_states(supervisor) -> dict:
    """node id -> the worker's last ``transfer.json`` (the engine's
    status and counters, each install's time)."""
    from .cluster.worker import read_json

    return {
        h.node_id: read_json(os.path.join(h.dir, "transfer.json")) or {}
        for h in supervisor.nodes
    }


def _installs(transfers: dict) -> dict:
    return {
        n: int(doc.get("counters", {}).get("snapshots_installed", 0))
        for n, doc in transfers.items()
    }


def _kv_workers_converged(supervisor, timeout_s: float) -> dict | None:
    """Wait until every worker of the cluster reports one app chain, one
    applied index and one KvStore digest, and return the ``app.json``
    documents that did (None after ``timeout_s``): a write the home node
    rejected but a peer proposed may still commit after the step, so a
    second read need not agree.  The index counts the KV ops applied; the
    applied seq is no common point, since an idle cluster's leaders go on
    committing empty batches and each worker publishes its seq at its own
    moment."""
    deadline = time.monotonic() + timeout_s
    while True:
        states = _app_states(supervisor)
        chains = set(supervisor.chains())
        if (
            len(states) == len(supervisor.nodes)
            and len(chains) == 1 and "" not in chains
            and len({d["applied_index"] for d in states.values()}) == 1
            and len({d["store_sha256"] for d in states.values()}) == 1
        ):
            return states
        if time.monotonic() > deadline:
            return None
        time.sleep(0.1)


def _stall_report(supervisor) -> dict:
    """node id -> (low watermark, high watermark, epoch number, epoch
    state, applied seq): what a cluster that did not converge shows, read
    from each worker's ``/status`` and ``app.json``."""
    states = _app_states(supervisor)
    out = {}
    for n in supervisor.node_ids:
        doc = supervisor.status(n) or {}
        epoch = doc.get("epoch_tracker") or {}
        out[n] = (doc.get("low_watermark"), doc.get("high_watermark"),
                  epoch.get("number"), epoch.get("state"),
                  states.get(n, {}).get("applied_seq"))
    return out


def _low_watermark(supervisor, node: int, timeout_s: float = 30.0) -> int:
    """One node's low watermark, read from its ``/status``."""
    deadline = time.monotonic() + timeout_s
    while True:
        doc = supervisor.status(node)
        if doc is not None:
            return int(doc["low_watermark"])
        if time.monotonic() > deadline:
            raise TimeoutError(f"node {node}: no /status in {timeout_s} s")
        time.sleep(0.1)


def _worker_summary(supervisor) -> dict:
    """What a worker rung reports of its processes once torn down: each
    worker's exit codes, log faults and kernel evidence, and the digest
    counters summed over the workers (``kernel_evidence``)."""
    evidence = supervisor.evidence
    return {
        "exit_codes": supervisor.exit_codes(),
        "log_faults": {n: e["log_faults"] for n, e in evidence.items()},
        "evidence": evidence,
        "device_digests": sum(e["device_digests"] for e in evidence.values()),
        "host_digests": sum(e["host_digests"] for e in evidence.values()),
        "hash_launches": sum(e["launches"] for e in evidence.values()),
        "launches_sha256": sum(
            e["launches_sha256"] for e in evidence.values()),
        "kernel_ms": sum(e["kernel_ms"] for e in evidence.values()),
    }


def app_run(*, device="cuda", ops_per_session=APP_OPS_PER_SESSION,
            nodes=APP_NODES, tick_s=APP_TICK_S) -> dict:
    """The KV rung as the JAX bench runs it (its ``app_run``,
    bench.py:1331-1381): ``nodes`` worker processes with the KV service on
    the cuda-pipelined processor (the kernel twin of the JAX
    ``pipelined``), not proxied, one ``KvClient`` a session over the
    workers' service sockets, the sessions homed on the first nodes in
    turn.  Then, on the same cluster, the last node (no session's home) is
    stopped, the sessions write until every other worker's low watermark
    sits ``APP_LAG_CHECKPOINTS`` checkpoint intervals past its own, and it
    restarts from its own disk and must catch up by state transfer.
    ``ops_per_session``, ``nodes`` and ``tick_s`` shrink it for the CPU
    tests.

    Returns the workload's step and history, the linearizable-reads
    evidence (``{"violation": message}`` when the audit fails), whether
    every worker reached one app chain, applied index and KvStore digest
    (``converged``; if not, each worker's watermarks, epoch and applied
    seq as ``stall``), the snapshots each worker installed during the step
    (``step_installs``), the lagging replica's catch-up (``lag``), and,
    read once every worker has stopped, each worker's ``exit_codes``,
    ``log_faults`` and ``boot_seconds`` and the digest counters summed
    over the workers."""
    from . import loadgen
    from .app.service import KvClient
    from .chaos.invariants import InvariantViolation, check_linearizable_reads
    from .cluster import ClusterSupervisor
    from .ops.batching import resolve_device
    from .runtime.node import standard_initial_network_state

    resolve_device(device)
    client_ids = list(range(1, APP_SESSIONS + 1))
    lag_node = nodes - 1
    start = time.perf_counter()
    supervisor = ClusterSupervisor(
        node_count=nodes,
        client_ids=client_ids,
        batch_size=APP_BATCH_SIZE,
        processor="cuda-pipelined",
        tick_seconds=tick_s,
        app="kv",
        device=device,
    )
    sessions: dict = {}
    try:
        supervisor.start()
        # Every worker publishes its service port at boot; wait for the
        # full mesh so session homes spread across the nodes.
        deadline = time.monotonic() + 30.0
        addresses = supervisor.app_addresses()
        while len(addresses) < nodes and time.monotonic() < deadline:
            time.sleep(0.1)
            addresses = supervisor.app_addresses()
        if len(addresses) < nodes:
            raise RuntimeError(
                f"{len(addresses)} of {nodes} KV service endpoints published"
            )
        homes = sorted(addresses)
        sessions = {
            cid: KvClient(addresses, cid, home=homes[i % len(homes)])
            for i, cid in enumerate(client_ids)
        }
        workload = loadgen.KvWorkload(
            sessions,
            loadgen.kv_client_models(client_ids, read_ratio=APP_READ_RATIO),
            seed=APP_SEED,
        )
        installs_before = _installs(_transfer_states(supervisor))
        step = workload.run_step(
            "app-kv-mixed",
            ops_per_session=ops_per_session,
            op_timeout_s=APP_OP_TIMEOUT_S,
        )
        try:
            evidence = check_linearizable_reads(workload.history)
        except InvariantViolation as err:
            evidence = {"violation": str(err)}
        states = _kv_workers_converged(supervisor, APP_CONVERGE_S)
        converged = states is not None
        stall = None if converged else _stall_report(supervisor)
        installs_after = _installs(_transfer_states(supervisor))
        if states is None:
            states = _app_states(supervisor)
        out = {
            "step": step,
            "history": workload.history,
            "linearizable": evidence,
            "converged": converged,
            "stall": stall,
            "store_digests": {
                n: d["store_sha256"] for n, d in states.items()},
            "applied": {n: (d["applied_seq"], d["applied_index"])
                        for n, d in states.items()},
            "step_installs": {
                n: installs_after[n] - installs_before[n]
                for n in installs_after
            },
            "homes": {cid: s.home for cid, s in sessions.items()},
            "workload_wall_s": time.perf_counter() - start,
        }
        interval = standard_initial_network_state(
            nodes, client_ids
        ).config.checkpoint_interval
        out["lag"] = _restarted_replica(
            supervisor, sessions, lag_node, interval
        )
        out["wall_s"] = time.perf_counter() - start
    finally:
        for session in sessions.values():
            session.close()
        supervisor.teardown()
    out.update(_worker_summary(supervisor))
    out["boot_seconds"] = {
        h.node_id: list(h.boot_seconds) for h in supervisor.nodes
    }
    return out


def _restarted_replica(supervisor, sessions, lag_node, interval) -> dict:
    """Stop ``lag_node`` (SIGTERM and drain), write through the others
    until every other worker's low watermark sits ``APP_LAG_CHECKPOINTS``
    checkpoint intervals past the stopped node's, stop writing, restart it
    from its own disk, and wait for it to install a snapshot and reach the
    others' app chain, applied index and KvStore digest.  Then read
    every written key from it, committed."""
    from .app.service import KvClient
    from .cluster.worker import read_json

    timeout_s = APP_LAG_TIMEOUT_S
    others = [n for n in supervisor.node_ids if n != lag_node]
    for i, (_cid, session) in enumerate(sorted(sessions.items())):
        if session.home == lag_node:
            session.home = others[i % len(others)]
    low0 = _low_watermark(supervisor, lag_node)
    supervisor.kill(lag_node, graceful=True)
    # Its last app.json, written as it stopped.
    seq0 = (read_json(os.path.join(
        supervisor.nodes[lag_node].dir, "app.json")) or {}).get("applied_seq")
    target = low0 + APP_LAG_CHECKPOINTS * interval
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
    down_start = time.perf_counter()
    for thread in threads:
        thread.start()
    deadline = time.monotonic() + timeout_s
    lows = []
    while time.monotonic() < deadline:
        lows = [_low_watermark(supervisor, n) for n in others]
        if min(lows) >= target:
            break
        time.sleep(0.2)
    stop.set()
    for thread in threads:
        thread.join(timeout=APP_OP_TIMEOUT_S + 5)
    down_s = time.perf_counter() - down_start
    missed = max(_app_states(supervisor)[n]["applied_seq"] for n in others)
    restart_unix = time.time()
    restart_at = time.perf_counter()
    supervisor.restart(lag_node)
    addresses = supervisor.app_addresses()
    for session in sessions.values():
        session.set_addresses(addresses)
    states = _kv_workers_converged(supervisor, timeout_s)
    caught_up = states is not None
    caught_up_s = time.perf_counter() - restart_at
    transfer = _transfer_states(supervisor)[lag_node]
    counters = dict(transfer.get("counters", {}))
    installs = transfer.get("installs_unix") or []
    reads = []
    if caught_up:
        reader = KvClient(addresses, min(sessions), home=lag_node)
        try:
            reader.session_index = max(
                s.session_index for s in sessions.values())
            for key, value in sorted(written.items()):
                resp = reader.get(key, mode="committed",
                                  timeout=APP_OP_TIMEOUT_S)
                reads.append((key, value.hex(), resp))
        finally:
            reader.close()
    return {
        "node": lag_node,
        "homes": {cid: s.home for cid, s in sessions.items()},
        "low_watermark_before": low0,
        "target_low_watermark": target,
        "others_low_watermarks": lows,
        "applied_seq_before": seq0,
        "seqs_missed": None if seq0 is None else missed - seq0,
        "down_s": down_s,
        "boot_s": supervisor.nodes[lag_node].boot_seconds[-1],
        "writes": len(written),
        "caught_up": caught_up,
        "caught_up_s": caught_up_s,
        "transfer_s": installs[0] - restart_unix if installs else None,
        "transfer_bytes": int(counters.get("chunk_bytes_received", 0)),
        "transfer_chunks": int(counters.get("chunks_received", 0)),
        "engine": counters,
        "snapshot_equal": caught_up and len(
            {d["store_sha256"] for d in states.values()}) == 1,
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


# -- the multi-process rungs ---------------------------------------------------

# Multi-process rung (the JAX bench.py:133-144, 1192-1229): the same 4-node
# consensus, but one real OS process per node (cluster/ supervisor +
# workers) under open-loop Poisson load from the loadgen package, stepped
# through LIVE_MP_RATE_STEPS offered rates: the latency *distribution*
# under a fixed offered rate, the SLO view.  Every worker's processor
# hashes on the SHA-256 kernel.
LIVE_MP_NODES = 4
LIVE_MP_RATE_STEPS = (25.0, 50.0, 100.0)
LIVE_MP_STEP_DURATION_S = 2.0
LIVE_MP_DRAIN_S = 25.0
LIVE_MP_BATCH_SIZE = 4
LIVE_MP_CLIENTS = (1, 2, 3)
LIVE_MP_SEED = 11
LIVE_MP_SETTLE_S = 30.0  # every node on one chain, after the last drain

# Reconfig A/B inside the mp rung (the JAX bench.py:146-155, 1232-1330):
# one Poisson rate measured twice on the same cluster — steady state, then
# again while a committed add-node reconfiguration adopts at the
# checkpoint boundary and the joiner boots via snapshot transfer.
LIVE_MP_RECONFIG_RATE = 25.0
LIVE_MP_RECONFIG_STEP_S = 4.0
LIVE_MP_RECONFIG_ADMIN_CLIENT = 9
LIVE_MP_RECONFIG_CI = 5

# Knee rung (the JAX bench.py:183-221, 1384-1510): max-sustainable-rate-at-
# SLO capacity search (loadgen/knee.py) on a real KNEE_NODES-process
# cluster, honest clients only, tick APP_TICK_S; the traced config joins
# the load generator's records with the workers' clock-aligned trace.json
# milestones (obsv/critpath.py) for the per-phase attribution at the knee.
KNEE_NODES = 8
KNEE_BATCH_SIZE = 1
KNEE_SLO_P95_MS = 8000.0
KNEE_MIN_GOODPUT_RATIO = 0.6
KNEE_START_RATE = 16.0
KNEE_MAX_RATE = 256.0
KNEE_STEP_DURATION_S = 2.0
KNEE_DRAIN_S = 12.0
# (name, processor, profile, traced, max_steps): the JAX rows' shape, each
# processor the JAX kind's kernel twin (serial -> cuda, pipelined ->
# cuda-pipelined), so every digest of the knee runs on the SHA-256 kernel.
KNEE_CONFIGS = (
    ("cuda-lan", "cuda", "lan", True, 7),
    ("cuda-pipelined-lan", "cuda-pipelined", "lan", False, 4),
)


def _cluster_outcome(supervisor) -> dict:
    """What a multi-process rung's gates read off its supervisor: each
    node's commits and chain, the (client, req_no) pairs committed more
    than once on a node, and each worker's boot seconds.  Call before
    ``teardown``; the exit codes and kernel evidence come after it."""
    chains = supervisor.chains()
    duplicates = []
    commits = []
    for handle in supervisor.nodes:
        pairs = collections.Counter((c, q) for c, q, _s in handle.commits)
        commits.append(len(pairs))
        duplicates.extend(
            (handle.node_id, c, q) for (c, q), n in pairs.items() if n > 1
        )
    return {
        "chains": chains,
        "commits": commits,
        "duplicates": duplicates,
        "boot_seconds": [list(h.boot_seconds) for h in supervisor.nodes],
    }


def _settle(supervisor, want: set, timeout_s: float,
            every_node: bool = False) -> None:
    """Wait until every node's app chain is the same and every request in
    ``want`` is committed on some node (the generator stops at the first
    node's commit) or, with ``every_node``, on every node that installed
    no snapshot, or ``timeout_s`` passes; the caller gates on what it
    reads after."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        chains = set(supervisor.chains())
        per_node = {
            h.node_id: {(c, q) for c, q, _s in h.commits}
            for h in supervisor.nodes
        }
        if every_node:
            installed = _installs(_transfer_states(supervisor))
            done = all(want <= per_node[n] or installed[n] for n in per_node)
        else:
            done = want <= set().union(*per_node.values())
        if len(chains) == 1 and "" not in chains and done:
            return
        time.sleep(0.1)


def _read_batch_journals(directory: str) -> tuple:
    """The ingress batches one worker's verifier was handed, in order,
    and its verdicts on each (None where the launch raised), from its
    ``ingress-batches-<pid>.jsonl`` (every incarnation's): each batch a
    list of (client_id, req_no, data)."""
    import glob

    batches, verdicts = [], []
    for path in sorted(glob.glob(
            os.path.join(directory, "ingress-batches-*.jsonl"))):
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                if line.strip():
                    doc = json.loads(line)
                    batches.append([(cid, req_no, bytes.fromhex(data))
                                    for cid, req_no, data in doc["items"]])
                    verdicts.append(doc["verdicts"])
    return batches, verdicts


def _signed_outcome(supervisor, front, want: set) -> dict:
    """What the signed-ingress gates read off a torn-down worker cluster
    (its root kept): each worker's journaled ingress batches, its commits
    by request and their seqs, its snapshots installed with the last
    one's checkpoint seq_no, its ingress counters, the forged bytes
    found in its request store, and the Ed25519 wrappers' launches by
    rows summed over the workers.

    Two counts hold the forged twins: ``forged_admitted``, the forged
    items the verifiers judged valid (their journaled verdicts), and
    ``forged_stored``, the forged payloads among every STORE record of
    each worker's request log, read raw (``storage.logged_stores``), so
    a forgery that was stored and then committed counts too.  That scan
    sees the whole run only if no compaction rewrote the log after boot:
    ``stored`` (node id -> the (client, req_no) of its STORE records)
    lets the caller check that every request the node committed is
    there."""
    from .runtime.storage import logged_stores

    batches, batch_nodes, verdicts = [], [], []
    for handle in supervisor.nodes:
        mine, judged = _read_batch_journals(handle.dir)
        batches.extend(mine)
        verdicts.extend(judged)
        batch_nodes.extend([handle.node_id] * len(mine))
    forged = set(front.forged.values())
    stores = {
        h.node_id: logged_stores(os.path.join(h.dir, "reqs"))
        for h in supervisor.nodes
    }
    transfers = _transfer_states(supervisor)
    evidence = supervisor.evidence
    launches_by_rows = {}
    for name in ("ed25519_decompress", "ed25519_ladder"):
        counts = collections.Counter()
        for e in evidence.values():
            counts.update(e[f"launches_{name}_by_rows"])
        launches_by_rows[name] = counts
    return {
        "batches": batches,
        "batch_nodes": batch_nodes,
        "verdicts": verdicts,
        "honest": want,
        "forged": len(front.forged),
        "per_node_commits": {
            h.node_id: collections.Counter(
                (c, q) for c, q, _s in h.commits)
            for h in supervisor.nodes
        },
        "seq_of": {
            (c, q): s for h in supervisor.nodes for c, q, s in h.commits
        },
        "transfers": {
            n: (int(doc.get("counters", {}).get("snapshots_installed", 0)),
                doc.get("target_seq_no"))
            for n, doc in transfers.items()
        },
        "ingress": {
            n: {
                key: e.get(f"ingress_{key}", 0)
                for key in ("admitted", "delivered", "evicted", "batches",
                            "verify_errors", "dropped_overflow")
            }
            for n, e in evidence.items()
        },
        "forged_admitted": sum(
            1 for items, judged in zip(batches, verdicts)
            for (_c, _q, data), ok in zip(items, judged or ())
            if ok and data in forged
        ),
        "forged_stored": sum(
            1 for records in stores.values()
            for _ack, data in records if data in forged
        ),
        "stored": {
            n: {(ack.client_id, ack.req_no) for ack, _data in records}
            for n, records in stores.items()
        },
        "launches_by_rows": launches_by_rows,
    }


def live_mp_run(kind: str = "cuda-pipelined", *, device="cuda",
                rates=LIVE_MP_RATE_STEPS,
                step_s=LIVE_MP_STEP_DURATION_S,
                drain_s=LIVE_MP_DRAIN_S, signed=False) -> dict:
    """One open-loop load run against a real multi-process cluster under
    executor ``kind``: LIVE_MP_NODES worker processes on ``device``,
    Poisson arrivals stepped through ``rates``, the standard hostile
    client mix (honest / slow+mixed-size / retry-storm), generator seed
    11, each step seeded by its rate.  ``signed`` is the signed-ingress
    rung's traffic on workers: the clients sign, every worker admits their
    requests through ``SpeculativeIngress`` on the Ed25519 kernels, and
    every INGRESS_FORGE_EVERY-th request gets a forged twin.

    Returns ``steps`` (loadgen StepResults ready for the SLO artifact),
    ``goodput_per_sec`` and ``p95_ms`` at the top rate, the requests
    ``submitted`` (honest) and, when signed, the ``forged_to`` each
    node, then, once every node holds one chain (or LIVE_MP_SETTLE_S
    passed), the cluster's ``chains``, per-node ``commits`` and
    ``duplicates``, the honest
    requests committed nowhere (``missing``), each worker's
    ``boot_seconds``, ``exit_codes`` and kernel ``evidence``
    (``ClusterSupervisor.kernel_evidence``) and the digest counters
    summed over the workers.  Signed, the settle waits for every honest
    request on every node that installed no snapshot, and the result adds
    ``_signed_outcome``'s keys: the batches every worker's verifier was
    handed and its verdicts, read back from its journal, and what its
    request log was handed, read after teardown."""
    from . import loadgen
    from .cluster import ClusterSupervisor
    from .ops.batching import resolve_device

    resolve_device(device)
    client_ids = list(LIVE_MP_CLIENTS)
    models = loadgen.standard_client_models(client_ids)
    if signed:
        _register_client_keys(client_ids)
        models = {
            cid: dataclasses.replace(model, signed=True)
            for cid, model in models.items()
        }
    supervisor = ClusterSupervisor(
        node_count=LIVE_MP_NODES,
        client_ids=client_ids,
        batch_size=LIVE_MP_BATCH_SIZE,
        processor=kind,
        signed_ingress=signed,
        device=device,
        keep_root=signed,  # the request stores are read after teardown
    )
    signed_out = {}
    try:
        try:
            supervisor.start()
            front = None
            if signed:
                front = _IngressFront(
                    supervisor, supervisor.submit, INGRESS_FORGE_EVERY,
                    INGRESS_SEED,
                )
            generator = loadgen.LoadGenerator(
                front or supervisor, models, seed=LIVE_MP_SEED
            )
            steps = []
            start = time.perf_counter()
            for rate in rates:
                steps.append(
                    generator.run_step(
                        f"{kind}-poisson-{int(rate)}",
                        loadgen.PoissonArrivals(rate, seed=int(rate)),
                        duration_s=step_s,
                        drain_s=drain_s,
                    )
                )
            want = generator.submitted()
            _settle(supervisor, want, LIVE_MP_SETTLE_S, every_node=signed)
            wall = time.perf_counter() - start
            outcome = _cluster_outcome(supervisor)
            committed = {
                (c, q) for h in supervisor.nodes for c, q, _s in h.commits
            }
        finally:
            supervisor.teardown()
        if signed:
            signed_out = _signed_outcome(supervisor, front, want)
    finally:
        if signed:
            shutil.rmtree(supervisor.root, ignore_errors=True)
    top = steps[-1]
    return {
        "steps": steps,
        "wall_s": wall,
        "goodput_per_sec": top.goodput_per_sec,
        "p95_ms": top.p95_ms,
        "submitted": len(want),
        "forged_to": dict(front.forged_to) if signed else {},
        "missing": sorted(want - committed),
        **outcome,
        **_worker_summary(supervisor),
        **signed_out,
    }


def reconfig_run(*, device="cuda", processor="cuda",
                 step_s=LIVE_MP_RECONFIG_STEP_S,
                 drain_s=LIVE_MP_DRAIN_S) -> dict:
    """Membership-change A/B on the mp cluster: the same open-loop Poisson
    step measured twice — in steady state, then while an admin client's
    committed ``pb.NetworkConfig`` grows the node set 4 -> 5, the
    incumbents adopt at the checkpoint boundary, and the joiner boots with
    the committed target config and catches up via snapshot transfer.
    Every worker runs ``processor`` on ``device`` (``cuda``: the twin of
    the JAX rung's ``serial``).

    Returns ``steps`` (the two loadgen StepResults), ``evidence``
    (``adoptions`` over the incumbents, ``joined``, and the joiner's
    ``snapshots_installed`` from its transfer counters) and, as
    ``live_mp_run``, ``chains``, ``commits``, ``duplicates``,
    ``boot_seconds``, ``exit_codes`` and the workers' ``kernels``."""
    from . import loadgen, pb
    from .cluster import ClusterSupervisor
    from .cluster.worker import read_json
    from .ops.batching import resolve_device
    from .runtime.reconfig import encode_reconfig_request

    resolve_device(device)
    client_ids = list(LIVE_MP_CLIENTS)
    admin = LIVE_MP_RECONFIG_ADMIN_CLIENT
    incumbent = {
        "nodes": [0, 1, 2, 3],
        "f": 1,
        "number_of_buckets": 4,
        "checkpoint_interval": LIVE_MP_RECONFIG_CI,
        "max_epoch_length": 10 * LIVE_MP_RECONFIG_CI,
    }
    target = dict(incumbent, nodes=[0, 1, 2, 3, 4])
    reconfig_payload = encode_reconfig_request(
        [pb.Reconfiguration(type=pb.NetworkConfig(**target))]
    )
    supervisor = ClusterSupervisor(
        node_count=5,
        client_ids=client_ids + [admin],
        batch_size=LIVE_MP_BATCH_SIZE,
        processor=processor,
        deferred_nodes=(4,),
        network_config=incumbent,
        device=device,
    )
    evidence = {"adoptions": 0, "joined": False, "snapshots_installed": 0}
    failures: list = []
    stop = threading.Event()

    def reconfigure():
        # Submit (resubmitting until adoption — client-window dedup
        # absorbs duplicates), then spawn the joiner with the committed
        # target config the moment any incumbent reports adoption.
        request = pb.Request(client_id=admin, req_no=0, data=reconfig_payload)
        last_submit = 0.0
        try:
            while not stop.is_set():
                adopted = 0
                for node in incumbent["nodes"]:
                    doc = read_json(os.path.join(
                        supervisor.nodes[node].dir, "reconfig.json"))
                    adopted += int((doc or {}).get("adopted", 0) or 0)
                evidence["adoptions"] = adopted
                if adopted > 0:
                    supervisor.join_node(4, network_config=target)
                    evidence["joined"] = True
                    return
                if time.monotonic() - last_submit >= 1.0:
                    for node_id in supervisor.alive_nodes():
                        supervisor.submit(node_id, request)
                    last_submit = time.monotonic()
                time.sleep(0.2)
        except Exception as exc:  # noqa: BLE001 — raised by the caller
            failures.append(exc)

    try:
        supervisor.start()
        generator = loadgen.LoadGenerator(
            supervisor,
            loadgen.standard_client_models(client_ids),
            seed=13,
        )
        steady = generator.run_step(
            "reconfig-steady",
            loadgen.PoissonArrivals(LIVE_MP_RECONFIG_RATE, seed=7),
            duration_s=step_s,
            drain_s=drain_s,
        )
        worker = threading.Thread(target=reconfigure, daemon=True)
        worker.start()
        during = generator.run_step(
            "reconfig-add-node",
            loadgen.PoissonArrivals(LIVE_MP_RECONFIG_RATE, seed=8),
            duration_s=step_s,
            # Longer drain than the steady arm: the adoption epoch roll
            # can spiral on a starved CPU and commit resumption then
            # takes tens of seconds; a timed-out tail here would report
            # a liveness failure as a latency number.
            drain_s=4 * drain_s,
        )
        worker.join(timeout=90.0)
        if failures:
            raise failures[0]
        if evidence["adoptions"] <= 0:
            raise RuntimeError(
                "reconfig A/B is vacuous: no incumbent adopted the "
                "reconfiguration within the measurement window"
            )
        if evidence["joined"]:
            # The joiner publishes its transfer counters every 0.5 s.
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                doc = read_json(os.path.join(
                    supervisor.nodes[4].dir, "transfer.json")) or {}
                counters = doc.get("counters", {})
                evidence["snapshots_installed"] = int(
                    counters.get("snapshots_installed", 0)
                ) + int(counters.get("snapshots_resumed_staged", 0))
                if evidence["snapshots_installed"]:
                    break
                time.sleep(0.1)
        outcome = _cluster_outcome(supervisor)
    finally:
        stop.set()
        supervisor.teardown()
    return {
        "steps": [steady, during],
        "evidence": evidence,
        **outcome,
        "exit_codes": supervisor.exit_codes(),
        "kernels": supervisor.evidence,
    }


def knee_run(*, device="cuda", configs=KNEE_CONFIGS, nodes=KNEE_NODES,
             step_s=KNEE_STEP_DURATION_S, drain_s=KNEE_DRAIN_S) -> dict:
    """Capacity-knee rung: per ``configs`` entry, boot a ``nodes``-worker
    cluster on ``device``, hand ``loadgen.knee.find_knee`` a real
    ``LoadGenerator.run_step`` closure, and locate the max sustainable
    rate whose p95 still meets KNEE_SLO_P95_MS.  The traced config's
    workers dump clock_sync-stamped trace.json on teardown; those are
    joined with the knee probe's per-request records into a critpath
    ledger for the per-phase attribution at the knee.

    Returns the ``mirbft-capacity/1`` artifact, each config's entry with
    its workers' ``exit_codes`` and kernel ``evidence`` beside it."""
    from . import loadgen
    from .cluster import ClusterSupervisor
    from .loadgen import knee as kneemod
    from .loadgen.clients import ClientModel
    from .obsv import critpath
    from .ops.batching import resolve_device

    resolve_device(device)
    docs = []
    for name, kind, profile, traced, max_steps in configs:
        client_ids = [1, 2, 3, 4]
        supervisor = ClusterSupervisor(
            node_count=nodes,
            client_ids=client_ids,
            batch_size=KNEE_BATCH_SIZE,
            processor=kind,
            profile=profile,
            tick_seconds=APP_TICK_S,
            trace=traced,
            # Teardown must not delete the traced root: the workers
            # write trace.json during the SIGTERM handshake and we read
            # them back after the processes exit.
            keep_root=traced,
            device=device,
        )
        root = supervisor.root
        records_by_rate: dict = {}
        try:
            supervisor.start()
            generator = loadgen.LoadGenerator(
                supervisor,
                {cid: ClientModel() for cid in client_ids},
                seed=13,
            )
            # Discarded warm step: the first commits after boot pay
            # epoch setup and cold caches, which would contaminate the
            # lowest-rate probe's percentiles.
            generator.run_step(
                f"{name}-warm",
                loadgen.PoissonArrivals(KNEE_START_RATE / 2, seed=5),
                duration_s=step_s,
                drain_s=drain_s / 2,
            )

            def measure(rate):
                step = generator.run_step(
                    f"{name}-knee-{rate:.1f}",
                    loadgen.PoissonArrivals(rate, seed=int(rate * 8) or 1),
                    duration_s=step_s,
                    drain_s=drain_s,
                )
                records_by_rate[float(rate)] = step.records
                return step

            # Coarse resolution on purpose, as in the JAX rung: a probe
            # past saturation can wedge the cluster in epoch suspicion
            # for longer than the drain window.
            result = kneemod.find_knee(
                measure,
                KNEE_START_RATE,
                KNEE_SLO_P95_MS,
                max_rate=KNEE_MAX_RATE,
                max_steps=max_steps,
                resolution=0.25,
                min_goodput_ratio=KNEE_MIN_GOODPUT_RATIO,
            )
        finally:
            supervisor.teardown()
        attribution = None
        if traced:
            try:
                traces = []
                for n in range(nodes):
                    path = os.path.join(root, f"node{n}", "trace.json")
                    if os.path.exists(path):
                        with open(path) as fh:
                            traces.append(json.load(fh))
                # Attribute the knee probe itself (the highest passing
                # rate); fall back to every record when the search never
                # passed so the artifact still carries an attribution.
                records = records_by_rate.get(
                    result.knee_rate_per_sec
                    if result.knee_rate_per_sec is not None
                    else -1.0
                ) or [
                    record
                    for step_records in records_by_rate.values()
                    for record in step_records
                ]
                if traces:
                    ledger = critpath.build_ledger(traces, records)
                    if ledger:
                        attribution = critpath.attribute(ledger)
            finally:
                shutil.rmtree(root, ignore_errors=True)
        doc = kneemod.config_doc(
            name,
            result,
            profile=profile,
            processor=kind,
            attribution=attribution,
            nodes=nodes,
            clients=len(client_ids),
        )
        doc["exit_codes"] = supervisor.exit_codes()
        doc["evidence"] = supervisor.evidence
        docs.append(doc)
    return kneemod.artifact(
        docs,
        nodes=nodes,
        tick_seconds=APP_TICK_S,
        step_duration_s=step_s,
        drain_s=drain_s,
        client_model="honest",
    )


# -- main: every stage under one budget ------------------------------------------
#
# ``python -m mirbft_tpu_torch.bench`` (the JAX package's bench.py:1729-2522):
# every stage above under one wall-clock budget, each stage journaled the
# moment it finishes, and one JSON object on stdout under the JAX key and
# stage names.  The JAX host processor kinds map to their kernel twins
# (serial -> cuda, pipelined -> cuda-pipelined).

# Wall-clock budget for the whole bench (seconds), sized so budget +
# watchdog grace + margin clears the harness's 870 s kill.
DEFAULT_BUDGET_S = 600.0

# The harness kills the process outright at this wall time (override with
# BENCH_HARNESS_TIMEOUT_S); the budget is clamped so budget + grace +
# margin lands under it: an oversized BENCH_BUDGET_S degrades to skipped
# tail stages, never to a kill that leaves no JSON.
HARNESS_TIMEOUT_S = 870.0
HARNESS_MARGIN_S = 60.0

# Launch-shape budget a function for the whole-run device capture
# (override with BENCH_RETRACE_BUDGET): the ladder sweeps its bucket
# shapes, so the bench's budget is looser than ``obsv.device``'s.
BENCH_RETRACE_BUDGET = 32

# Runway past the budget before the hard watchdog fires: for a stage that
# cannot be timed out cooperatively (a native call that starves the
# interpreter), with margin under the harness's kill.
WATCHDOG_GRACE_S = 60.0

METRIC = "committed_reqs_per_sec_per_chip"

# The kernel sources the stages launch (csrc/<name>.cu).
KERNEL_SOURCES = ("sha256", "ed25519", "ack_plane", "bls_g1")

# The JAX stages, in the JAX order.
STAGES = (
    "live_serial", "live_pipelined", "soak", "live_under_attack",
    "live_mp_serial", "live_mp_pipelined", "live_mp_reconfig", "app_kv",
    "knee", "warm_calibrate", "ladder_kernel", "ladder_host",
    "sha256_microbench", "ed25519_microbench", "rung3", "rung4",
    "ackplane", "rung5",
)

# The ackplane rung's keys the JAX payload carries (as ``ackplane_<key>``).
ACKPLANE_KEYS = (
    "clients", "events_total", "host_events_per_sec", "host_build_s",
    "device_events_per_sec", "device_build_s", "device_compile_s",
    "device_vs_host", "committed_reqs_per_sec", "strong_certs",
    "weak_certs", "drain_seconds", "sweep_seconds", "fallback_rows",
    "dropped_rows", "divergences", "parity_mismatches",
)

class BenchStream:
    """Crash-proof stage journal: one fsynced JSON line the moment each
    stage finishes, so a SIGKILL (or the harness's timeout) on the newest
    stage cannot erase the stages that already passed.

    Line kinds: ``header`` (schema and pid), one ``stage`` line a stage
    with its status, seconds and ``compile_s``, and a trailing ``final``
    line carrying the payload.  ``obsv.diff.recover_stream`` rebuilds a
    run with no ``final`` line from its stage lines.  Every write is best
    effort: a full disk must not take the bench down with it."""

    SCHEMA = "mirbft-bench-stream/1"

    def __init__(self, path):
        self.path = path
        self._fh = None
        try:
            self._fh = open(path, "w", encoding="utf-8")
        except OSError:
            return
        self._line({"schema": self.SCHEMA, "kind": "header",
                    "pid": os.getpid()})

    def _line(self, obj) -> None:
        if self._fh is None:
            return
        try:
            self._fh.write(json.dumps(obj) + "\n")
            self._fh.flush()
            os.fsync(self._fh.fileno())
        except (OSError, ValueError, TypeError):
            pass

    def stage(self, name, entry, registry) -> None:
        seconds = registry.gauge(
            "mirbft_bench_stage_seconds", stage=name
        ).value
        self._line({"kind": "stage", "stage": name, "seconds": seconds,
                    **entry})

    def final(self, payload) -> None:
        self._line({"kind": "final", "payload": payload})

    def close(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None


class StageRunner:
    """Time-boxed stages under one monotonic deadline.

    Each stage runs on a daemon thread joined against the remaining
    budget; a stage that overruns is marked ``timeout`` (its thread is
    abandoned: the process ends with ``os._exit``), and the stages after
    it are ``skipped`` once the budget is gone.  A stage's wall lands in
    the ``mirbft_bench_stage_seconds`` gauge, which the payload reads
    back.  ``stage_budget_s`` (``BENCH_STAGE_BUDGET_S``) also caps each
    stage alone.

    A stage's ``warmup`` runs on the same thread just before ``fn``, so
    kernel builds and first launches stay outside the timed window: its
    seconds go to ``compile_s`` (gauge
    ``mirbft_bench_stage_compile_seconds``) and the stage's seconds time
    ``fn`` alone.  With a ``stream`` every finished stage is journaled at
    once."""

    # Don't bother starting a stage with less runway than this.
    MIN_RUNWAY_S = 5.0

    def __init__(self, budget_s: float, registry, stage_budget_s=None,
                 stream=None):
        self.deadline = time.monotonic() + budget_s
        self.registry = registry
        self.stage_budget_s = stage_budget_s
        self.stream = stream
        self.status: dict = {}  # stage -> {"status": ..., ["detail": ...]}
        # The stage running now (None between stages): the watchdog names
        # it when join() itself is wedged.
        self.current = None
        # Set when the running stage overruns its budget; a stage that
        # polls it stops instead of running on beside the payload.
        self.cancel = threading.Event()

    def remaining(self) -> float:
        return self.deadline - time.monotonic()

    def run(self, name: str, fn, enabled: bool = True, detail: str = "",
            warmup=None):
        """Run one stage; returns fn() or None (skipped, timeout, error)."""
        try:
            return self._run(name, fn, enabled, detail, warmup)
        finally:
            if self.stream is not None:
                self.stream.stage(
                    name, self.status.get(name, {}), self.registry
                )

    def _run(self, name, fn, enabled, detail, warmup):
        entry: dict = {"status": "skipped"}
        if detail:
            entry["detail"] = detail
        self.status[name] = entry
        self.registry.gauge("mirbft_bench_stage_seconds", stage=name)
        if not enabled:
            return None
        runway = self.remaining()
        if runway < self.MIN_RUNWAY_S:
            entry["detail"] = "budget exhausted"
            return None
        if self.stage_budget_s is not None:
            runway = min(runway, self.stage_budget_s)
        box: dict = {}

        def work():
            try:
                if warmup is not None:
                    warm_start = time.perf_counter()
                    warmup()
                    box["compile_s"] = round(
                        time.perf_counter() - warm_start, 3
                    )
                fn_start = time.perf_counter()
                box["result"] = fn()
                box["fn_s"] = round(time.perf_counter() - fn_start, 3)
            except BaseException as exc:  # reported; the bench goes on
                box["error"] = f"{type(exc).__name__}: {exc}"

        self.cancel = threading.Event()
        thread = threading.Thread(
            target=work, daemon=True, name=f"bench-{name}"
        )
        start = time.perf_counter()
        self.current = name
        try:
            thread.start()
            thread.join(timeout=runway)
        finally:
            self.current = None
        if "compile_s" in box:
            entry["compile_s"] = box["compile_s"]
            self.registry.gauge(
                "mirbft_bench_stage_compile_seconds", stage=name
            ).set(box["compile_s"])
        self.registry.gauge("mirbft_bench_stage_seconds", stage=name).set(
            box.get("fn_s", round(time.perf_counter() - start, 3))
        )
        if thread.is_alive():
            self.cancel.set()
            entry["status"] = "timeout"
            return None
        if "error" in box:
            entry["status"] = "error"
            entry["detail"] = box["error"]
            return None
        entry["status"] = "ok"
        entry.pop("detail", None)  # the skip reason no longer applies
        return box["result"]

    def stage_report(self) -> dict:
        """Status and seconds a stage, the seconds read from the registry."""
        return {
            name: {
                **info,
                "seconds": self.registry.gauge(
                    "mirbft_bench_stage_seconds", stage=name
                ).value,
            }
            for name, info in self.status.items()
        }


class Watchdog:
    """The bench's last guarantee of a final JSON line on stdout.

    The runner's cooperative timeouts need the main thread to return from
    ``join``; a stage wedged inside a native call that starves the
    interpreter stops that.  This daemon timer needs only a brief
    scheduling window: it marks the running stage ``timeout``, emits the
    final JSON with ``watchdog_fired: true``, and exits with 1.
    ``emit`` and ``exit_fn`` are injectable, so a test can wedge a stage
    without ending its own process."""

    def __init__(self, runner, deadline_s, emit=None, exit_fn=None,
                 stream=None):
        self.runner = runner
        self.deadline_s = deadline_s
        self.emit = emit if emit is not None else print
        self.exit_fn = exit_fn if exit_fn is not None else os._exit
        self.stream = stream
        self.fired = threading.Event()
        self._cancelled = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="bench-watchdog", daemon=True
        )

    def start(self) -> None:
        self._thread.start()

    def cancel(self) -> None:
        self._cancelled.set()

    def _run(self) -> None:
        if self._cancelled.wait(self.deadline_s):
            return
        self.fire("hard watchdog fired")

    def fire(self, reason: str) -> None:
        """Emit the final JSON line and exit.  Idempotent; also where the
        SIGALRM backstop lands."""
        if self.fired.is_set() or self._cancelled.is_set():
            return
        self.fired.set()
        wedged = self.runner.current
        if wedged is not None:
            entry = self.runner.status.get(wedged)
            if entry is not None:
                entry["status"] = "timeout"
                entry["detail"] = reason
        try:
            stages = self.runner.stage_report()
        except Exception:  # never let reporting block the exit
            stages = {}
        payload = {
            "metric": METRIC,
            "value": None,
            "watchdog_fired": True,
            "wedged_stage": wedged,
            "stages": stages,
        }
        try:
            if self.stream is not None:
                self.stream.final(payload)
            self.emit(json.dumps(payload))
            sys.stdout.flush()
        finally:
            self.exit_fn(1)


def _round(value, digits=1):
    return None if value is None else round(value, digits)


def _fold_engine(registry, stage, events, sim_ms):
    """Record one engine stage's events and simulated ms as
    ``mirbft_engine_*`` series labelled by stage; the payload's
    ``engine_gauges`` reads them back from the registry."""
    if events is not None:
        registry.counter("mirbft_engine_events_total", stage=stage).inc(events)
    if sim_ms is not None:
        registry.gauge("mirbft_engine_sim_ms", stage=stage).set(sim_ms)


def _engine_gauges(registry) -> dict:
    """{stage: {events, sim_ms}} from the registry snapshot."""
    snap = registry.snapshot()
    out: dict = {}
    for metric, key in (
        ("mirbft_engine_events_total", "events"),
        ("mirbft_engine_sim_ms", "sim_ms"),
    ):
        for series in snap.get(metric, {}).get("series", []):
            stage = series["labels"].get("stage")
            if stage is not None:
                out.setdefault(stage, {})[key] = series["value"]
    return out


def effective_budget_s(environ=None) -> float:
    """The stage budget used: ``BENCH_BUDGET_S`` clamped so budget +
    watchdog grace lands inside ``BENCH_HARNESS_TIMEOUT_S`` with margin."""
    env = os.environ if environ is None else environ
    budget_s = float(env.get("BENCH_BUDGET_S", DEFAULT_BUDGET_S))
    harness_s = float(env.get("BENCH_HARNESS_TIMEOUT_S", HARNESS_TIMEOUT_S))
    ceiling = harness_s - WATCHDOG_GRACE_S - HARNESS_MARGIN_S
    if ceiling > 0:
        budget_s = min(budget_s, ceiling)
    return budget_s


def main(device="cuda") -> int:
    """Run every stage on ``device`` and print one JSON object.

    Returns 1 when no card is present on ``cuda`` (the JSON names it and
    no stage runs), when a stage ends in ``error``, or when the ladder's
    kernel run does not replay its host run; else 0 (a stage past its
    budget, or skipped, leaves 0)."""
    from .obsv import device as device_obsv
    from .obsv.metrics import Registry
    from .ops.batching import resolve_device

    try:
        on_card = resolve_device(device).type == "cuda"
    except RuntimeError as exc:
        print(json.dumps({"metric": METRIC, "value": None,
                          "error": f"{type(exc).__name__}: {exc}"}))
        return 1
    if on_card:
        # Every source the stages launch, one nvcc each, all at once and
        # before the first stage: no stage's clock holds a build.
        from . import _build

        start = time.perf_counter()
        _build.build_all(KERNEL_SOURCES)
        print(f"bench: {', '.join(KERNEL_SOURCES)} built in "
              f"{time.perf_counter() - start:.3f} s", file=sys.stderr)
    budget_s = effective_budget_s()
    stage_budget = os.environ.get("BENCH_STAGE_BUDGET_S")
    registry = Registry()
    # The device capture spans the whole run (independent of the hooks,
    # which stages toggle): program times, launch shapes and transfer
    # bytes land in the payload's "device" section that obsv --diff gates.
    device_obsv.reset()
    device_obsv.start_capture(
        registry,
        retrace_budget=int(
            os.environ.get("BENCH_RETRACE_BUDGET", BENCH_RETRACE_BUDGET)
        ),
    )
    stream = BenchStream(
        os.environ.get("BENCH_STREAM_PATH", "BENCH_stream.jsonl")
    )
    runner = StageRunner(
        budget_s,
        registry,
        stage_budget_s=float(stage_budget) if stage_budget else None,
        stream=stream,
    )
    watchdog = Watchdog(
        runner, deadline_s=budget_s + WATCHDOG_GRACE_S, stream=stream
    )
    watchdog.start()
    alarm = threading.current_thread() is threading.main_thread() and (
        hasattr(signal, "SIGALRM")
    )
    if alarm:
        # Backstop for the backstop: if even the watchdog thread is
        # starved, SIGALRM lands on the same exit path.
        previous = signal.signal(
            signal.SIGALRM,
            lambda _sig, _frm: watchdog.fire("SIGALRM backstop fired"),
        )
        signal.alarm(int(budget_s + WATCHDOG_GRACE_S + 30))
    try:
        payload, consistent = _run_stages(runner, registry, device, budget_s)
    finally:
        device_obsv.stop_capture()
        if alarm:
            signal.alarm(0)
            signal.signal(signal.SIGALRM, previous)
    watchdog.cancel()
    stream.final(payload)
    stream.close()
    print(json.dumps(payload))
    failed = any(
        entry["status"] == "error" for entry in runner.status.values()
    )
    return 1 if failed or consistent is False else 0


def workers_clean(result: dict, evidence_key: str = "evidence") -> dict:
    """A worker rung's result, or ``RuntimeError`` naming every worker
    that exited non-zero or whose log shows a fault: the stage running it
    then ends ``error`` with that detail, not ``ok``."""
    faults = [
        f"node {node} exit codes {codes}"
        for node, codes in sorted(result["exit_codes"].items())
        if any(code != 0 for code in codes)
    ]
    faults += [
        f"node {node} log: {e['log_faults'][0]}"
        for node, e in sorted(result[evidence_key].items())
        if e["log_faults"]
    ]
    if faults:
        raise RuntimeError("worker fault: " + "; ".join(faults))
    return result


def _run_stages(runner, registry, device, budget_s) -> tuple:
    """The JAX stages in the JAX order; returns (payload, whether the
    ladder's kernel run replayed its host run, None if either is
    missing)."""
    from . import loadgen
    from .obsv import device as device_obsv
    from .testengine import rung3
    from .testengine.crypto_plane import AsyncKernelHashPlane

    # The live rungs run first: sockets and fsyncs, not kernels in this
    # process, so a pathological stage downstream cannot starve them.
    live_serial = runner.run(
        "live_serial",
        lambda: live_cluster_rate("cuda", device=device)["rate"],
    )
    live_pipelined = runner.run(
        "live_pipelined",
        lambda: live_cluster_rate("cuda-pipelined", device=device)["rate"],
    )
    soak_s = float(os.environ.get("BENCH_SOAK_S", DEFAULT_SOAK_S))
    soak = runner.run(
        "soak",
        lambda: soak_run(duration_s=soak_s, registry=registry, device=device),
        enabled=soak_s > 0,
        detail="BENCH_SOAK_S=0",
    )
    attack = runner.run(
        "live_under_attack", lambda: live_attack_run("cuda", device=device)
    )
    if attack is None:
        attack = dict.fromkeys(("clean_rate", "clean_p95_ms", "flood_rate",
                                "flood_p95_ms", "flooded"))
    mp_serial = runner.run(
        "live_mp_serial",
        lambda: workers_clean(live_mp_run("cuda", device=device)),
    )
    mp_pipelined = runner.run(
        "live_mp_pipelined",
        lambda: workers_clean(live_mp_run("cuda-pipelined", device=device)),
    )
    mp_steps = []
    for result in (mp_serial, mp_pipelined):
        if result is not None:
            mp_steps.extend(result["steps"])
    mp_reconfig = runner.run(
        "live_mp_reconfig",
        lambda: workers_clean(reconfig_run(device=device), "kernels"),
    )
    reconfig_steady = reconfig_during = None
    reconfig_evidence = {}
    if mp_reconfig is not None:
        reconfig_steady, reconfig_during = mp_reconfig["steps"]
        reconfig_evidence = mp_reconfig["evidence"]
        mp_steps.extend(mp_reconfig["steps"])
    app = runner.run("app_kv", lambda: workers_clean(app_run(device=device)))
    app_steps = [app["step"]] if app is not None else []
    app_top = app_steps[-1] if app_steps else None
    capacity = runner.run("knee", lambda: knee_run(device=device))

    def warm_calibrate():
        # The kernel plane's launch shapes, each launched once.  The port
        # has no offload calibration: every digest goes to the kernel.
        plane = AsyncKernelHashPlane(device=device)
        warm_kernel_shapes(plane)
        return plane

    plane = runner.run("warm_calibrate", warm_calibrate)
    ladder = runner.run(
        "ladder_kernel",
        lambda: ladder_run(hash_plane=plane, device=device),
        enabled=plane is not None,
        detail="needs warm_calibrate",
    )
    tpu_wall, events, chain, ladder_sim = (
        ladder if ladder is not None else (None,) * 4
    )
    _fold_engine(registry, "ladder_kernel", events, ladder_sim)
    host = runner.run("ladder_host", lambda: ladder_run(device=device))
    host_wall, host_events, host_chain, host_sim = (
        host if host is not None else (None,) * 4
    )
    _fold_engine(registry, "ladder_host", host_events, host_sim)
    # The kernel run must replay the host run exactly: the same events
    # and app chain.  Only checkable when both ran.
    consistent = None
    if ladder is not None and host is not None:
        consistent = events == host_events and chain == host_chain

    micro = runner.run(
        "sha256_microbench",
        lambda: kernel_microbench(device),
        warmup=lambda: sha256_microbench_warmup(device),
    )
    ed = runner.run(
        "ed25519_microbench",
        lambda: ed25519_microbench(device=device),
        warmup=lambda: ed25519_microbench_warmup(device=device),
    )
    ed_kernel_rate, ed_host_rate = ed if ed is not None else (None, None)
    r3 = runner.run("rung3", lambda: rung3_run(device=device))
    rung3_rate, rung3_p99, rung3_events, rung3_verified, rung3_stats, r3_sim = (
        r3 if r3 is not None else (None, None, None, None, {}, None)
    )
    _fold_engine(registry, "rung3", rung3_events, r3_sim)
    r4 = runner.run("rung4", lambda: rung4_run(device=device))
    rung4 = r4 if r4 is not None else dict.fromkeys(
        ("reqs_per_sec", "events", "certificates", "aggregate_ms", "sim_ms")
    )
    _fold_engine(registry, "rung4", rung4["events"], rung4["sim_ms"])
    ackplane = runner.run(
        "ackplane", lambda: ackplane_run(registry, device=device)
    )
    r5 = runner.run(
        "rung5", lambda: rung5_run(device=device, cancel=runner.cancel)
    )
    rung5 = r5 if r5 is not None else dict.fromkeys(
        ("reqs_per_sec", "events", "sim_ms")
    )
    _fold_engine(registry, "rung5", rung5["events"], rung5["sim_ms"])

    total_reqs = CLIENTS * REQS_PER_CLIENT
    committed_rate = total_reqs / tpu_wall if tpu_wall else None
    p99_ms = None
    if plane is not None and ladder is not None:
        p99_ms = _p99(plane.flush_wall_s) or 0.0
    chain_rate = micro["chain_rate"] if micro is not None else None

    payload = {
        "metric": METRIC,
        "value": _round(committed_rate),
        "live_reqs_per_sec_serial": _round(live_serial),
        "live_reqs_per_sec_pipelined": _round(live_pipelined),
        "live_pipelined_speedup": (
            round(live_pipelined / live_serial, 3)
            if live_serial and live_pipelined
            else None
        ),
        "live_config": (
            f"{LIVE.nodes} nodes f={(LIVE.nodes - 1) // 3}, "
            f"{LIVE.clients} clients, first {LIVE.target_commits} of "
            f"{LIVE.clients * LIVE.reqs_per_client} reqs, "
            f"batch_size={LIVE.batch_size}, loopback TCP, on-disk "
            "WAL/reqstore, emulated flush latency "
            f"{LIVE.fsync_floor_s * 1e3:.0f}ms/fsync; processors cuda "
            "(serial) and cuda-pipelined (pipelined), every digest on the "
            "SHA-256 kernel, one process a node"
        ),
        "live_attack_goodput_per_sec": _round(attack["flood_rate"]),
        "live_attack_commit_p95_ms": _round(attack["flood_p95_ms"], 2),
        "live_attack_clean_goodput_per_sec": _round(attack["clean_rate"]),
        "live_attack_clean_commit_p95_ms": _round(attack["clean_p95_ms"], 2),
        "live_attack_goodput_ratio": (
            round(attack["flood_rate"] / attack["clean_rate"], 3)
            if attack["flood_rate"] and attack["clean_rate"]
            else None
        ),
        "live_attack_flooded_submissions": attack["flooded"],
        "live_attack_config": (
            f"duplication flood: every submission x{1 + LIVE_ATTACK_COPIES} "
            "to every node, cuda processor, same cluster shape as "
            "live_config; p95 is first-submission to first-commit on the "
            "node with the most commits"
        ),
        "live_mp_goodput_per_sec_serial": _round(
            mp_serial["goodput_per_sec"] if mp_serial else None
        ),
        "live_mp_p95_ms_serial": _round(
            mp_serial["p95_ms"] if mp_serial else None, 2
        ),
        "live_mp_goodput_per_sec_pipelined": _round(
            mp_pipelined["goodput_per_sec"] if mp_pipelined else None
        ),
        "live_mp_p95_ms_pipelined": _round(
            mp_pipelined["p95_ms"] if mp_pipelined else None, 2
        ),
        "live_mp_config": (
            f"{LIVE_MP_NODES} worker processes, open-loop Poisson at "
            f"{'/'.join(str(int(r)) for r in LIVE_MP_RATE_STEPS)} req/s "
            f"x {LIVE_MP_STEP_DURATION_S:.0f}s, "
            f"batch_size={LIVE_MP_BATCH_SIZE}, client mix: honest + "
            "slow/mixed-size + retry-storm; processors cuda (serial) and "
            "cuda-pipelined (pipelined)"
        ),
        "reconfig_steady_goodput_per_sec": _round(
            reconfig_steady.goodput_per_sec if reconfig_steady else None
        ),
        "reconfig_steady_p95_ms": _round(
            reconfig_steady.p95_ms if reconfig_steady else None, 2
        ),
        "reconfig_window_goodput_per_sec": _round(
            reconfig_during.goodput_per_sec if reconfig_during else None
        ),
        "reconfig_window_p95_ms": _round(
            reconfig_during.p95_ms if reconfig_during else None, 2
        ),
        "reconfig_adoptions": reconfig_evidence.get("adoptions"),
        "reconfig_joiner_booted": reconfig_evidence.get("joined"),
        "reconfig_config": (
            f"4 -> 5 nodes via a committed pb.NetworkConfig from admin "
            f"client {LIVE_MP_RECONFIG_ADMIN_CLIENT}, ci="
            f"{LIVE_MP_RECONFIG_CI}, Poisson "
            f"{int(LIVE_MP_RECONFIG_RATE)} req/s x "
            f"{LIVE_MP_RECONFIG_STEP_S:.0f}s per arm, cuda processor"
        ),
        "app_goodput_per_sec": _round(
            app_top.goodput_per_sec if app_top else None
        ),
        "app_read_p50_ms": _round(app_top.read_p50_ms if app_top else None, 2),
        "app_read_p95_ms": _round(app_top.read_p95_ms if app_top else None, 2),
        "app_read_p99_ms": _round(app_top.read_p99_ms if app_top else None, 2),
        "app_write_p50_ms": _round(
            app_top.write_p50_ms if app_top else None, 2
        ),
        "app_write_p95_ms": _round(
            app_top.write_p95_ms if app_top else None, 2
        ),
        "app_write_p99_ms": _round(
            app_top.write_p99_ms if app_top else None, 2
        ),
        "app_config": (
            f"{APP_NODES} worker processes with the KV service, "
            f"{APP_SESSIONS} closed-loop sessions x "
            f"{APP_OPS_PER_SESSION} ops, read_ratio={APP_READ_RATIO}, "
            "uniform + Zipf keys, mixed payload sizes, committed-mode "
            "reads (read-index barrier), cuda-pipelined processors"
        ),
        "knee_rate_per_sec": _round(
            capacity.get("knee_rate_per_sec") if capacity else None, 1
        ),
        "knee_config": (
            f"{KNEE_NODES} worker processes, honest open-loop Poisson "
            f"probes x {KNEE_STEP_DURATION_S:.0f}s, SLO p95 <= "
            f"{KNEE_SLO_P95_MS:.0f}ms + goodput >= "
            f"{KNEE_MIN_GOODPUT_RATIO:.0%} of offered, geometric ramp "
            f"from {KNEE_START_RATE:.0f} req/s + binary search; configs: "
            + ", ".join(c[0] for c in KNEE_CONFIGS)
        ),
        "unit": "reqs/s",
        "vs_baseline": (
            round(host_wall / tpu_wall, 3) if tpu_wall and host_wall else None
        ),
        "ladder_consistent": consistent,
        "config": (
            f"{NODES} nodes f={(NODES - 1) // 3}, {CLIENTS} clients, "
            f"batch_size={BATCH_SIZE}, {total_reqs} reqs, "
            f"ready_latency={READY_LATENCY_MS}ms, "
            "every digest via the async SHA-256 kernel plane (no host "
            "route)"
        ),
        "p99_batch_digest_ms": _round(p99_ms, 2),
        "engine_events": events,
        "kernel_compressions_per_sec": _round(chain_rate),
        # The JAX package timed an XLA and a Pallas route; the port has
        # one, the hand-written chain kernel, under the Pallas key.
        "kernel_compressions_per_sec_xla": None,
        "kernel_compressions_per_sec_pallas": _round(chain_rate),
        "kernel_digests_per_sec_640B": _round(
            micro["kernel_digest_rate"] if micro else None
        ),
        "kernel_vs_hashlib": (
            round(micro["kernel_digest_rate"] / micro["host_rate"], 3)
            if micro else None
        ),
        "ed25519_verifies_per_sec": _round(ed_kernel_rate),
        "ed25519_vs_host_python": (
            round(ed_kernel_rate / ed_host_rate, 3) if ed else None
        ),
        "rung3_committed_reqs_per_sec": _round(rung3_rate),
        "rung3_verify_p99_ms": _round(rung3_p99, 2),
        "rung3_config": (
            f"{rung3.NODES} nodes f={(rung3.NODES - 1) // 3}, "
            f"{rung3.CLIENTS} ed25519-signed clients, "
            f"{rung3.CLIENTS * rung3.REQS} reqs, "
            f"batch_size={rung3.BATCH_SIZE}, "
            "speculative batched ingress verification on the Ed25519 "
            "kernels"
        ),
        "rung3_engine_events": rung3_events,
        "rung3_verified_requests": rung3_verified,
        **rung3_stats,
        "rung4_committed_reqs_per_sec": _round(rung4["reqs_per_sec"]),
        "rung4_config": (
            f"{RUNG4_NODES} nodes f={(RUNG4_NODES - 1) // 3}, "
            f"{RUNG4_CLIENTS} clients, 30ms WAN jitter + drop "
            "mangler, BLS checkpoint certs aggregated on the card"
        ),
        "rung4_engine_events": rung4["events"],
        "rung4_bls_certificates": rung4["certificates"],
        "rung4_bls_aggregate_ms": _round(rung4["aggregate_ms"], 2),
        "rung5_committed_reqs_per_sec": _round(rung5["reqs_per_sec"]),
        "rung5_config": (
            f"{RUNG5_NODES} nodes f={(RUNG5_NODES - 1) // 3}, "
            f"{RUNG5_CLIENTS} clients, {RUNG5_JITTER_MS}ms WAN jitter, "
            f"follower {RUNG5_CRASH_NODE} crashed and restarted before the "
            "first commit, back by state transfer"
        ),
        "rung5_engine_events": rung5["events"],
        **{
            f"ackplane_{key}": (ackplane or {}).get(key)
            for key in ACKPLANE_KEYS
        },
        "ackplane_config": (
            f"{ACKPLANE_CLIENTS} clients (width-1 windows), 4 nodes f=1, "
            f"{len(ACKPLANE_SOURCES)} sources acking every req 0 in "
            f"seeded shuffled frames of {ACKPLANE_FRAME}; events/s is "
            "steady state (each plane's first frame is its build "
            "window); committed = strong-certified slots per second of "
            "device ingest + quorum sweep; boundary drain reported "
            "separately"
        ),
        "soak": soak,
        "soak_config": (
            f"{SOAK_NODES} nodes f={(SOAK_NODES - 1) // 3}, "
            f"{SOAK_CLIENTS} clients, sliding window {SOAK_WINDOW}, "
            f"cuda-pipelined processors, {soak_s:.0f}s "
            "(BENCH_SOAK_S), on-disk WAL/reqstore, obsv resource "
            "sampler @0.5s"
        ),
        "bench_budget_s": budget_s,
        "bench_stage_budget_s": runner.stage_budget_s,
        "stages": runner.stage_report(),
        "engine_gauges": _engine_gauges(registry),
        "device": device_obsv.report(registry),
    }
    if mp_steps:
        payload["loadgen"] = loadgen.artifact(
            mp_steps,
            cluster="mp",
            nodes=LIVE_MP_NODES,
            rate_steps=list(LIVE_MP_RATE_STEPS),
        )
    if capacity is not None:
        payload["capacity"] = capacity
    if app_steps:
        payload["loadgen_app"] = loadgen.artifact(
            app_steps,
            cluster="mp-app",
            nodes=APP_NODES,
            sessions=APP_SESSIONS,
            read_ratio=APP_READ_RATIO,
        )
    if plane is not None:
        payload.update(
            {
                "crypto_plane_digests": sum(plane.flush_sizes),
                "crypto_plane_overlapped_launches": plane.launches,
                # A digest demanded before its wave launched: the port
                # launches that wave on the kernel (no host route).
                "crypto_plane_demand_host_flushes": plane.demand_flushes,
                "crypto_plane_device_digests": plane.device_digests,
                "crypto_plane_host_digests": plane.host_digests,
                # No host route to rescue to, and no calibration (ROADMAP,
                # "Standing gap"): 0, null, null.
                "crypto_plane_rescued_digests": 0,
                "crypto_plane_device_rtt_ms": None,
                "crypto_plane_min_device_rows": None,
            }
        )
    return payload, consistent


def recover_main(argv) -> int:
    """``python -m mirbft_tpu_torch.bench --recover [journal]``: print the
    payload recovered from a ``BENCH_stream.jsonl`` journal (its
    ``final`` line when the run finished, a stage-only artifact when it
    was killed)."""
    from .obsv.diff import recover_stream

    path = argv[0] if argv else os.environ.get(
        "BENCH_STREAM_PATH", "BENCH_stream.jsonl"
    )
    try:
        payload = recover_stream(path)
    except OSError as exc:
        print(json.dumps({"error": f"{type(exc).__name__}: {exc}"}))
        return 1
    print(json.dumps(payload))
    return 0


def cli(argv) -> int:
    """``python -m mirbft_tpu_torch.bench [--device cpu]`` runs the bench;
    ``--recover [journal]`` recovers an artifact.  An exception outside
    the stages still prints one JSON line, with its ``error``."""
    if argv and argv[0] == "--recover":
        return recover_main(argv[1:])
    parser = argparse.ArgumentParser(
        prog="python -m mirbft_tpu_torch.bench",
        description="Run the port's bench and print one JSON object.",
    )
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the kernels run (cpu: their plain "
                        "versions)")
    args = parser.parse_args(argv)
    try:
        return main(device=args.device)
    except BaseException as exc:  # noqa: BLE001 — the contract is one line
        print(json.dumps({"metric": METRIC, "value": None,
                          "error": f"{type(exc).__name__}: {exc}"}))
        return 1


if __name__ == "__main__":
    # Through the package's module, so spawned node processes pickle
    # references to mirbft_tpu_torch.bench, not to this script's copy.
    from mirbft_tpu_torch.bench import cli as _cli

    rc = _cli(sys.argv[1:])
    sys.stdout.flush()
    sys.stderr.flush()
    # Abandoned timed-out stage threads may still be inside a launch; a
    # plain return can hang in interpreter teardown.
    os._exit(rc)
