"""Drive the PyTorch port on one NVIDIA card, end to end, and check it.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit:

    python3 chip_smoke.py [--profile PATH] [--live-rounds N]

Phases (any failure raises and the script exits nonzero):

1. print the card's name and power limit; build the SHA-256 (digest and
   chain), Ed25519, ack-plane, BLS G1 and sharded-plane kernels from
   ``mirbft_tpu_torch/csrc/{sha256,ed25519,ack_plane,bls_g1,parallel}.cu`` (one
   ``nvcc`` each, started together) and print ptxas's register, spill and
   shared-memory report (the ladder's dynamic shared memory beside it);
2. hold the SHA-256 kernel against its plain PyTorch version and hashlib,
   bit for bit: block-boundary lengths, rows with fewer blocks than the
   bucket, padding rows, the main path's two launch shapes, (8192, 1, 16)
   and (256, 128, 16), with protocol preimages, and all eight bucket
   shapes (8192, 1) ... (256, 128) with ragged rows, through the entry
   point (which takes the one-thread body for 1-block buckets and the
   warp-specialised body above);
3. the determinism anchor: 16 nodes x 64 clients x 25 requests, BatchSize
   200, every digest from the kernel: 2320 events, one app chain, 1600
   commits per node;
4. the main path at ladder rung 2 (``mirbft_tpu_torch.bench.ladder_run``:
   16 nodes, 64 clients x 100 requests, BatchSize 200, ready_latency 400
   ms): the host plane and the kernel
   plane in four pairs of alternating order (host, kernel, kernel, host,
   ...); events, app chains and committed sequences must be equal, the
   kernel must have launched, and no digest may come from the host.  Each
   run starts after a full collection of the earlier runs' garbage and
   prints its wall, the CPU seconds of the process and of its main thread,
   the seconds in the cyclic collector, the plane's host seconds at
   submit, at launch and blocked at flush, and the kernel's launches by
   packed (rows, blocks) shape; with ``--profile PATH`` one more host run and one more kernel
   run go under cProfile and their top functions are written to PATH;
5. the SHA-256 kernel's time at all eight bucket shapes (CUDA events over
   many launches after a warm-up), through the entry point, beside its
   throughput bound, its chain floor (the longest row's rounds at 3
   dependent instructions of 4 cycles each) and the plain version's time;
6. the rung-3 clients sign their requests (a process pool, before any
   clock); then both Ed25519 kernels against their plain versions and the
   RFC 8032 oracle on one corpus, launched at exactly n = 1, 3, 7, 8, 256,
   512, 513, 1024 and 4096 rows (256 and 512 are the main path's launches
   in phases 7 and 8; 1, 3, 7 and 513 leave the quad ladder's warps or
   blocks part empty): valid signatures, corrupted R, corrupted S, wrong messages, keys
   with no square root, x = 0 with the sign bit set, small-order keys (the
   identity, a point of order 8), R with no root; host-rejected rows (y >=
   p, S >= L, bad lengths) come on top of the n and must not reach a
   kernel.  Verdicts and decompressed points must be equal.  Then the
   decompress kernel alone on the decompression corpus (every branch of
   RFC 8032 5.1.3: no square root, x = 0 with the sign bit set, roots that
   need sqrt(-1), the identity, a point of order 8) repeated to m = 1, 3,
   7, 8, 1024, 1025 and 8192 rows, against its plain version and the
   oracle, bit for bit.  On each of the n corpora the host route too:
   ``marshal_signature`` rejects exactly the rows the device route rejects
   (on the host or by a decompression ok flag of 0), and the extended
   ladder on the rest, on the card and as its plain version, equals the
   oracle and the device route's verdicts;
7. a signed engine run, 16 nodes x 64 clients x 4 requests, BatchSize 200,
   with a forged request at every node: the async signature plane on the
   kernels against the host-oracle plane; equal events, app chains,
   committed sequences and recorded events, no forgery committed, every
   request rejected on the host or launched, at a shape phase 6 compared;
8. rung 3 at full scale (``mirbft_tpu_torch.bench.rung3_run``, the JAX
   package's bench.py:671-760: 64 nodes, f = 21, 1024 signed
   clients x 8 requests, BatchSize 200, phase 6's presigned requests) with
   the speculative signature
   plane and the kernel hash plane: the event count and app chain head of
   the JAX package's own run, 8192 commits on every node, every verify and
   every digest on the card; committed req/s, the verify p99, the kernels'
   device time and the card's idle share; the SHA-256 launches by packed
   shape at rungs 2 and 3, each times its gap to the larger of bound and
   chain floor;
9. the three Ed25519 kernels' times at n = 512, 1024 and 4096 (CUDA
   events over launches queued behind a spin kernel) beside their bounds
   and chain floors, rung 3's launches at each n times the gap to the
   larger of the two, and the plain versions' times at n = 512; and the
   host's time a row to marshal for each route (``marshal_light``,
   ``marshal_signature``);
10. the SHA-256 chain kernel against its plain version, exactly, at
    (1024, 16) and the ragged (1000, 16) blocks, at the full batch of
    32768 rows, and at the microbenchmark's full 4096 iterations on 128
    rows; then the port's kernel microbenchmark at full size
    (``mirbft_tpu_torch.bench.kernel_microbench``: 32768 rows x 4096
    chained compressions x 4 reps): compressions/s, the kernel's time
    beside its bound, hashlib's rate;
11. the live rung (``mirbft_tpu_torch.bench.live_cluster_rate``, the JAX
    package's bench.py:122-131 settings unchanged: 4 nodes over loopback
    TCP, 16 clients x 110 requests, BatchSize 10, real fsyncs plus a 40 ms
    floor, to the 1600th commit) under the processor kinds serial, pool,
    cuda-pool, pipelined and cuda-pipelined (cuda runs in phase 24, as the
    bench's ``live_serial`` stage, which must pass the same
    ``live_cluster_rate`` gates).  Each must reach the
    target, commit no request twice and keep the nodes' chains agreeing;
    each cuda kind must launch every hash request and none on the host.
    Each node runs in a process of its own and counts its launches there
    from 0.  Every launch of the cuda kinds records its packed shape, and
    the first launches of each shape keep their preimages and the digests
    they read back: those digests must equal hashlib's, and each kept
    launch, replayed through the kernel at its shape, must equal the plain
    version and the live launch.  Each live shape is timed on its first kept
    launch's preimages beside its floors, with round 1's launches x gap.
    Committed req/s and p95 commit latency per kind;
12. the device ack plane's two kernels (``csrc/ack_plane.cu``: the step,
    one cooperative launch, and the sweep) against their
    plain versions on the card, bit for bit, on seeded batches of 1024,
    4096 and 65536 rows at limbs 1, 2 and 3 (tests/ack_plane_cases.py:
    duplicates, several candidates for one virgin slot, conflicting
    digests, committed, slow, foreign and padding rows), and on the
    crossing case at 16384 and 65536 rows (one virgin slot hit from the
    grid's first block, the middle, and the last block: the first adopts,
    the middle falls back, the last applies): every
    state array, the packed row outputs, the sweep's totals and tick, and
    the adoption scratch empty after each step; then the 16x64x25 anchor
    again with every node's ack plane on the card: 2320 events and phase
    3's chain, every step counted;
13. the ack-plane rung at the JAX package's size
    (``mirbft_tpu_torch.bench.ackplane_run``: 100,000 clients, frames of
    12,500 rows, sources 1-3, seed 0xACC5, 2048 audited slots), its
    device plane on the card: 0 fallback rows, 0 dropped rows, 0
    divergences, 0 parity mismatches, every client certified weak and
    strong; host and device events/s, committed req/s, drain and sweep
    seconds; then each kernel's CUDA-event time on the rung's own batches
    (each source's first frame on the state it met) and the anchor's
    launch shape, beside its byte bound (bytes / 3.35 TB/s), its launch
    floor (an empty kernel launched as the step is, timed the same way)
    and its plain version's time, and the launches of the rung's run; the
    sweep also against its plain version, twice in a row and one launch
    each, on tests/ack_plane_cases.py's sweep planes (8193 to 262,145
    slots at limbs 1-4, every slot class, an all-certified plane of 4096
    slots a block, arrays off 16 bytes);
14. the BLS G1 aggregation kernel (``csrc/bls_g1.cu``) against its plain
    version on the card, bit for bit, and its affine points against the
    host fold (``bls_host.aggregate_g1``), on tests/bls_cases.py's seeded
    certificates: absent voters in the middle, a certificate with no vote
    (None), one voter twice, P with -P, the generator, and the launches
    (4, 4), rung 4's (4, 128), (64, 128) and rung 5's (4, 256), and
    launches of exactly 1, 85 and 200 voter slots (widths no split of a
    certificate's lanes divides: leading, middle and all-absent voters, a
    doubling and P + -P); then its
    time at (4, 128) and (64, 128) (CUDA events over launches queued
    behind a spin kernel) beside its bound (its integer instructions over
    the INT32 rate, its bytes over 3.35 TB/s), its chain floor (the
    longest certificate's chain of additions) with the kernel's share of
    it, and the plain version's time;
15. ladder rung 4 at full scale (``mirbft_tpu_torch.bench.rung4_run``, the
    JAX package's bench.py:763-841: 128 nodes, f = 42, 32 clients x 16
    requests, BatchSize 20, 30 ms link jitter, half of node 120's frames
    dropped for 2 simulated seconds, checkpoint certificates of 85 BLS
    votes) on the kernel hash plane and the kernel certificate plane: the
    JAX package's event count and app chain, 512 commits on every node, a
    certificate aggregated by the kernel (counted; no host fold) that
    verifies while a tampered statement fails, equal to
    ``bls_host.aggregate_g1`` of its votes, every digest on the card;
    committed req/s, the aggregate's device ms on the rung's votes, and
    the card's idle share;
16. signed ingress on 4 worker processes
    (``mirbft_tpu_torch.bench.live_mp_run(signed=True)``, the JAX
    package's multi-process rung, bench.py:133-144: BatchSize 4, clients
    1-3 under ``standard_client_models`` signed, Poisson steps at 25, 50
    and 100 req/s of 2 s each, generator seed 11, 25 s of drain), every
    worker on the cuda-pipelined processor with a ``SpeculativeIngress``
    on ``signing.batch_verifier("cuda")`` in front of its propose that
    journals every batch, and a seeded forged twin (one bit of S flipped)
    of every 8th request sent to the same workers: every honest request
    committed exactly once on every node (a node that fell behind and
    installed a snapshot holds the requests below its checkpoint through
    it), no forged bytes in any worker's request store (opened from its
    directory after teardown), each node's evictions equal to the
    forgeries it was sent, 0 verifier errors, 0 dropped, one chain, every
    worker exiting 0 with no log fault, every digest on the card (the
    SHA-256 wrappers' launches equal the processors', summed over the
    workers), and each Ed25519 kernel launched once for each journaled
    batch with a row left after the host's rejects, at that many rows (the
    workers' counts by rows); the first batch at each row count is
    replayed here through the kernels and their plain versions on the
    card (bit for bit) and its verdicts against the host oracle.  Per
    step: goodput, p50 and p95 submit-to-commit latency; the batch sizes;
17. the replicated KV service on 8 worker processes
    (``mirbft_tpu_torch.bench.app_run``, the JAX package's app rung,
    bench.py:157-180, 1331-1381: ``app="kv"``, not proxied, 4 closed-loop
    ``KvClient`` sessions x 40 ops over the workers' service sockets,
    read ratio 0.5, ``kv_client_models``, committed reads through the
    read-index barrier, BatchSize 1, tick 0.25 s, op timeout 20 s, seed 7)
    on the cuda-pipelined processor: 0 ops timed out (the snapshots each
    worker installed during the step printed beside it),
    ``check_linearizable_reads`` passing, one KvStore digest on every
    worker, every digest on the card; then node 7 stopped while the
    sessions write until the others' low watermarks are two checkpoint
    intervals past its own, restarted from its disk and caught up
    through ``TransferEngine``: a snapshot installed, 0 chunks rejected,
    its KvStore equal, committed reads served from it; every worker exits
    0 with no log fault.  Read and write p50/p95/p99, goodput, the seqs it
    missed, the transfer's bytes, chunks and wall from restart to install,
    and the card's idle share;
18. the observability plane on the card: (a) ``python -m
    mirbft_tpu_torch.obsv --nodes 4 --trace-dir DIR`` (its entry point, in
    this process) on the SHA-256 kernel, whose events and phase table
    (simulated ms) must equal the same run's with ``--device cpu``; its
    four per-node traces merged onto four lanes and their critical-path
    ledger one row a committed flow; (b) the live rung's shape on
    cuda-pipelined with every node traced and serving its exporter on an
    ephemeral port (``Config.metrics_port=0``, the address back over the
    node's pipe): while it runs, ``/metrics`` (the SHA-256 kernel's
    launches, > 0 on every node), ``/status`` and ``/healthz`` on every
    node, ``/dump`` once (a flight segment on disk) and a 404; after it
    the four per-process traces merged with the clock offsets of the
    transport's hellos and ``--critpath`` on the directory, the ledger at
    least the committed flows less the tracer's evictions; (c) one 50
    req/s step of phase 16's traffic on 4 in-process nodes
    (``bench.ingress_run``, one process, one clock) traced, per-node traces and
    the loadgen's commit records in one directory, and the critical-path
    attribution by latency band printed (both Ed25519 kernels and the
    SHA-256 kernel launched);
19. the soak (``mirbft_tpu_torch.bench.soak_run``, the JAX package's
    bench.py:229-245, 1511-1735: 4 nodes over loopback TCP, on-disk WAL
    and request store, cuda-pipelined, 4 clients, BatchSize 10, a window
    of 4, 30 s) with the resource sampler on the card: commits, 0
    divergences, the card's allocator series not empty, 0 failed sampler
    ticks, 0 frames dropped, every digest on the card; each series' leak
    verdict; ``obsv --diff`` of its artifact against itself exits 0 and
    against a copy with one verdict set ``growing`` exits nonzero;
20. the chaos campaign on the card: both deterministic matrices equal to
    the JAX campaign's pinned rows, the injected device faults ridden out
    on the kernels, a persistent one raising, the live matrices on
    ``cuda`` and ``cuda-pipelined`` replicas;
21. the live flood A/B (``bench.live_attack_run``);
22. the multi-process cluster (``mirbft_tpu_torch.cluster``), one worker
    process a node, every worker on ``cuda-pipelined`` and ``cuda``:
    (a) 4 workers boot, commit 40 requests submitted to every node (each
    worker's ``/status`` and ``/metrics`` read mid-run), node 3 is
    SIGKILLed, 40 more commit on the others, node 3 restarts from disk on
    its port, catches up to one chain, and 8 more commit on all four;
    (b) ``bench.live_mp_run`` (the JAX ``live_mp_run``: 4 workers,
    BatchSize 4, the standard client mix, Poisson 25/50/100 req/s; its
    signed form is phase 16);
    (d) ``python -m mirbft_tpu_torch.chaos --live --cluster mp --smoke``,
    started in the background beside phase 15 and collected here;
    (e) ``bench.reconfig_run`` (a committed reconfiguration adds node 4,
    which catches up by a snapshot).  Every worker must exit 0 (or -9
    where SIGKILLed), log no fault, show device hash flushes in its
    ``metrics.json`` and make no digest on the host; one chain, no
    request committed twice or never;
23. the sharded plane (``mirbft_tpu_torch.parallel``, ``entry.py``, the
    ack plane's client axis) on meshes that name the card several times:
    (c) the device-plane anchor with every node's ack plane on 4 client
    blocks, ``[cuda:0] * 4``: 2320 events, phase 3's chain, each flush's
    4 steps merged by one ``shard_sum``; (d) ``entry()`` and
    ``dryrun_multichip(4, devices=[cuda:0] * 4)`` (the counts read just
    after these two are the kernels line's launches); then (a)
    ``tally_columns`` and ``shard_sum`` (with and without a threshold)
    against their plain versions, bit for bit, at (8, 16), (128, 4096)
    and (256, 65536) int8 and at the main path's sums, each timed beside
    its launch floor, its byte bound and the library call
    (``votes.sum(0, dtype=torch.int32)``); (b) the three sharded
    functions on ``[cuda:0]`` and ``[cuda:0] * 4`` equal to the unsharded
    kernels (the Ed25519 verify takes the JAX function's host-decompressed
    rows through the extended ladder, a launch a shard, counted from 0
    just before each call for the kernels line; its verdicts accept the
    valid half and reject the corrupted half, as the oracle), their
    launches counted, and timed against the unsharded call;
24. the bench's ``main``: ``python -m mirbft_tpu_torch.bench`` in a process
    of its own with ``BENCH_BUDGET_S=40``, ``BENCH_SOAK_S=0`` and its
    journal in a temp dir: exit 0, one JSON line last with the JAX
    package's stages in its order, each ``ok``, ``timeout`` or skipped for
    the budget (the soak by design; rung 5 only ``timeout`` or skipped for
    the budget, never ``error``), ``live_serial`` ``ok``
    (the cuda processor, every digest on the SHA-256 kernel, the live
    rung's gates); the journal a header, a line a stage and the payload;
    ``--recover`` on it the same payload; ``obsv --diff`` of the artifact
    against itself exit 0 (these two through their command lines' entry
    functions, in this process).  Whatever the bench left running is
    stopped after.

It then prints the kernels as one JSON line, the card's name and power
limit, and, last, the result line the chip check reads.  Without a CUDA
card it prints nothing to stdout and exits 1.
"""

from __future__ import annotations

import argparse
import collections
import cProfile
import gc
import hashlib
import io
import json
import multiprocessing
import pstats
import random
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

SEED = 20261016
NODES, CLIENTS, BATCH_SIZE = 16, 64, 200
ANCHOR_REQS = 25
RUNG2_PAIRS = 4  # host/kernel pairs (~8 s each: the script's time limit)
SIGNED_REQS = 4  # phase 7: 16 nodes x 64 clients x 4 signed requests
FORGED_REQ_NO = 99
# The JAX package's own rung-3 run on a CPU (SpeculativeSignaturePlane with
# its host batch authority): tests/test_torch_signing.py::
# test_reference_rung3_anchor pins the same two numbers.
RUNG3_EVENTS = 43280
RUNG3_CHAIN = "12951e5407835b23b58650b2b28549b9404f5ecd6bafca472ff60a59b1f0e2cc"
ED25519_SHAPES = (512, 1024, 4096)  # signatures per launch, timed
# The packed (rows, blocks) shapes of the engine's eight block buckets
# (AsyncKernelHashPlane.rows_for): phase 2 holds each, with ragged rows,
# against plain and hashlib; phase 5 times each with full rows.
SHA256_SHAPES = (
    (8192, 1), (8192, 2), (8192, 4), (4096, 8), (2048, 16), (1024, 32),
    (512, 64), (256, 128),
)
# Phase 10: (rows, iterations) held against the plain version (on the
# host: its launches are all overhead), the last at the microbenchmark's
# full 4096 iterations (on 128 rows: the host plain version costs ~4.6 ms
# an iteration, little more for 1000 rows; (1000, 16) has the ragged
# rows); and the iterations the plain version is timed at on the full
# batch on the card (its 4096 would take about a minute of small
# launches).
CHAIN_COMPARED = ((1024, 16), (1000, 16), (32768, 8), (128, 4096))
CHAIN_PLAIN_ITERS = 64
# Launch shapes held against the plain versions and the oracle: the timed
# ones, small and ragged ones (a quad ladder's warp or block part empty),
# and phase 7's wave of 64 clients x 4 requests.
ED25519_COMPARED = tuple(sorted(
    (1, 3, 7, 8, CLIENTS * SIGNED_REQS, 513, *ED25519_SHAPES)
))
# The decompression corpus repeated to these rows: ragged warps, a full
# group, the 512- and 4096-signature launches' points and one past.
DECOMPRESS_CORPUS_ROWS = (1, 3, 7, 8, 1024, 1025, 8192)
POOL_PROCESSES = 8
# Phase 11's processor kinds: every live kind but cuda, which the bench's
# live_serial stage runs in phase 24 under the same live_cluster_rate
# gates, and which phase 24 requires to end ok.
PHASE11_KINDS = ("serial", "pool", "cuda-pool", "pipelined", "cuda-pipelined")
ANCHOR_W_PAD = 128  # the anchor's ack plane: windows of 101 slots, padded
# Phase 12: the crossing case's batch sizes: the rung's, the largest
# bucket, and a coalesced flush of 262144 rows, where the last crossing
# row is a thread's second on an H100's step grid.
ACK_CROSSING_ROWS = (16384, 65536, 262144)
# Phase 14: the BLS kernel timed at rung 4's launch and at a full batch.
BLS_TIMED = ((4, 128), (64, 128))
# The JAX package's own rung-4 run on a CPU (bench.py:763-841):
# tests/test_torch_bls.py::test_rung4_equals_the_jax_rung holds the port's
# run to it.
RUNG4_EVENTS = 241543
RUNG4_CHAIN = "6c355228b675df19bd7b97b1628fb59d5b55a1578529f10b7f74d961c42ea485"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
INT32_LANES_PER_SM = 64  # Hopper SM: 4 partitions x 16 INT32 lanes
IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def sm_clock_mhz() -> float:
    return float(nvidia_smi("clocks.sm").split()[0])


def max_sm_clock_mhz() -> float:
    """The SM clock the card's peak rates assume (its boost clock)."""
    return float(nvidia_smi("clocks.max.sm").split()[0])


def as_uint32(words):
    """int32 digest words -> int64 holding the uint32 values."""
    import torch

    return words.to(torch.int64) & 0xFFFFFFFF


def digests_of(words) -> list:
    from mirbft_tpu_torch.ops.sha256 import words_to_digests

    raw = words_to_digests(words)
    return [raw[i : i + 32] for i in range(0, len(raw), 32)]


def compare_case(label, messages, block_floor, batch_floor):
    """kernel == plain == hashlib on one packed batch; returns the max
    absolute difference between kernel and plain words (0 when equal)."""
    import torch

    from mirbft_tpu_torch.ops.batching import pack_preimages, to_tensors
    from mirbft_tpu_torch.ops.sha256 import (
        sha256_digest_words,
        sha256_digest_words_plain,
    )

    packed = pack_preimages(
        messages, block_floor=block_floor, batch_floor=batch_floor
    )
    blocks, n_blocks = to_tensors(packed, "cuda")
    kernel = sha256_digest_words(blocks, n_blocks)
    torch.cuda.synchronize()
    plain = sha256_digest_words_plain(blocks, n_blocks)
    err = int((as_uint32(kernel) - as_uint32(plain)).abs().max())
    check(err == 0, f"{label}: kernel != plain (max abs err {err})")
    got = digests_of(kernel)
    for i, msg in enumerate(messages):
        check(got[i] == hashlib.sha256(msg).digest(),
              f"{label}: row {i} (len {len(msg)}) != hashlib")
    padding = as_uint32(kernel[len(messages):]).cpu()
    check(bool((padding == torch.tensor(IV)).all()),
          f"{label}: padding rows do not return the IV")
    live = packed.n_blocks[: len(messages)]
    print(
        f"  {label}: shape {tuple(blocks.shape)}, {len(messages)} live rows "
        f"({int(live.min())}-{int(live.max())} blocks), "
        f"{blocks.shape[0] - len(messages)} padding rows: "
        "kernel == plain == hashlib"
    )
    return err, packed


def main_path_batches(rng) -> dict:
    """The main path's two launch shapes, filled with protocol preimages:
    request digests (1-block bucket, 8192 rows) and full BatchSize-200
    batch digests (200 ack digests x 32 B = 101 blocks, 128-block bucket,
    256 rows)."""
    from mirbft_tpu_torch import pb
    from mirbft_tpu_torch.core import preimage

    requests = [
        b"".join(preimage.request_hash_data(pb.Request(
            client_id=NODES + rng.randrange(CLIENTS), req_no=rng.randrange(100),
            data=b"%d:%d" % (rng.randrange(10**6), rng.randrange(100)),
        )))
        for _ in range(8192)
    ]
    batches = [
        b"".join(preimage.batch_hash_data([
            pb.RequestAck(digest=rng.randbytes(32)) for _ in range(BATCH_SIZE)
        ]))
        for _ in range(256)
    ]
    return {(8192, 1, 16): (requests, 1, 8192), (256, 128, 16): (batches, 128, 256)}


def bucket_lengths(rng, rows: int, bucket: int, ragged: bool) -> list:
    """Message lengths for one bucket's launch.  Full: every row pads to
    the bucket (from bucket/2 + 1 blocks up to bucket blocks; 0-55 bytes
    for the 1-block bucket), as the engine's full chunks are.  Ragged: 40
    padding rows, one row of the bucket's longest length, and the rest
    anywhere from 0 bytes up, so most rows have fewer live blocks than the
    bucket."""
    top = bucket * 64 - 9  # the longest message that pads to the bucket
    if ragged:
        return [rng.randrange(0, top + 1) for _ in range(rows - 41)] + [top]
    low = 0 if bucket == 1 else 32 * bucket - 8
    return [rng.randrange(low, top + 1) for _ in range(rows)]


def profile_rung2(make_plane, path_label, out) -> None:
    """One rung-2 run under cProfile; its 40 costliest functions by own
    time go to ``out``."""
    from mirbft_tpu_torch import bench as port_bench

    profiler = cProfile.Profile()
    profiler.enable()
    wall, events, _chain, _sim = port_bench.ladder_run(make_plane())
    profiler.disable()
    text = io.StringIO()
    pstats.Stats(profiler, stream=text).sort_stats("tottime").print_stats(40)
    out.write(f"== rung 2 {path_label} under cProfile: {events} events, "
              f"wall {wall:.6f} s\n{text.getvalue()}\n")


def time_device(launch, reps):
    """(device ms per launch, host ms per call) of ``launch()``.  The
    device time is taken with CUDA events around ``reps`` launches queued
    behind a spin kernel, so they run back to back and the host's per-call
    cost (tens of microseconds, longer than a 1-block SHA-256 launch) is
    not in it."""
    import torch

    for _ in range(10):
        launch()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(reps):
        launch()
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - start) * 1e3 / reps
    began = torch.cuda.Event(enable_timing=True)
    ended = torch.cuda.Event(enable_timing=True)
    # Hold the stream for ~2x the time the host needs to queue the launches.
    torch.cuda._sleep(int(2 * call_ms * 1e-3 * reps * 2e9))
    began.record()
    for _ in range(reps):
        launch()
    ended.record()
    ended.synchronize()
    return began.elapsed_time(ended) / reps, call_ms


def time_plain(blocks, n_blocks):
    import torch

    from mirbft_tpu_torch.ops.sha256 import sha256_digest_words_plain

    torch.cuda.synchronize()
    start = time.perf_counter()
    sha256_digest_words_plain(blocks, n_blocks)
    torch.cuda.synchronize()
    return (time.perf_counter() - start) * 1e3


def digest_cost(packed, ms: float, sms: int) -> dict:
    """The digest kernel's floors on one packed batch, at the SM clock read
    now: the throughput bound (integer instructions over the INT32 rate,
    bytes over 3.35 TB/s) and the chain floor (the longest row's rounds,
    ``ops/sha256.py::chain_floor_cycles``); which binds, and ``ms``'s gap
    to it."""
    from mirbft_tpu_torch.ops.sha256 import (
        INT_OPS_PER_COMPRESSION,
        chain_floor_cycles,
    )

    clock = sm_clock_mhz()
    compressions = int(packed.n_blocks.sum())
    rows = packed.blocks.shape[0]
    ops_ms = (
        compressions * INT_OPS_PER_COMPRESSION
        / (sms * INT32_LANES_PER_SM * clock * 1e6) * 1e3
    )
    moved = compressions * 64 + rows * (4 + 32)
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    longest = int(packed.n_blocks.max())
    chain_ms = chain_floor_cycles(longest) / (clock * 1e3)
    return dict(
        compressions=compressions, bytes=moved, sms=sms, sm_clock_mhz=clock,
        ops_bound_ms=ops_ms, bytes_bound_ms=bytes_ms, bound_ms=bound_ms,
        bound_by="operations" if ops_ms >= bytes_ms else "bytes",
        longest_row_blocks=longest, chain_floor_ms=chain_ms,
        binds="chain floor" if chain_ms >= bound_ms else "throughput bound",
        gap_ms=ms - max(bound_ms, chain_ms),
    )


def describe_cost(cost: dict, ms: float) -> str:
    from mirbft_tpu_torch.ops.sha256 import (
        DEPENDENT_ISSUE_CYCLES,
        INT_OPS_PER_COMPRESSION,
        ROUND_CHAIN,
    )

    binding = max(cost["bound_ms"], cost["chain_floor_ms"])
    return (
        f"throughput bound {cost['bound_ms']:.6f} ms ({cost['bound_by']}: "
        f"{cost['compressions']} compressions x {INT_OPS_PER_COMPRESSION} "
        f"int ops / ({cost['sms']} SMs x {INT32_LANES_PER_SM} INT32 lanes x "
        f"{cost['sm_clock_mhz']:.0f} MHz) = {cost['ops_bound_ms']:.6f} ms; "
        f"{cost['bytes']} bytes / 3.35 TB/s = {cost['bytes_bound_ms']:.6f} "
        f"ms); chain floor {cost['chain_floor_ms']:.6f} ms (the longest "
        f"row's {cost['longest_row_blocks']} blocks x 64 rounds x "
        f"{ROUND_CHAIN} dependent instructions x {DEPENDENT_ISSUE_CYCLES} "
        f"cycles); the {cost['binds']} binds: {100 * binding / ms:.2f}% of it"
    )


def ptxas_report(text: str) -> dict:
    """{kernel name: (registers, stack bytes, spill store bytes, spill load
    bytes, static shared memory bytes)} from nvcc's ``-Xptxas -v``
    output."""
    report = {}
    for block in text.split("Compiling entry function ")[1:]:
        mangled = block.split("'")[1]
        name = re.search(r"mirbft_\w+?_kernel", mangled).group(0)
        stack, stores, loads = map(int, re.search(
            r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
            r"(\d+) bytes spill loads", block).groups())
        registers = int(re.search(r"Used (\d+) registers", block).group(1))
        smem = re.search(r"(\d+) bytes smem", block)
        report[name] = (registers, stack, stores, loads,
                        int(smem.group(1)) if smem else 0)
    return report


def oracle_row(row):
    """The RFC 8032 oracle on one (pk, msg, sig) row: its verdict and the
    affine (x, y) of A and of R, or None where a point does not decode.
    Runs in pool workers."""
    from mirbft_tpu_torch.crypto import ed25519_host as host

    pk, msg, sig = row

    def affine(encoded):
        point = host.decompress(encoded) if len(encoded) == 32 else None
        return None if point is None else point[:2]

    return host.verify(pk, msg, sig), affine(pk), affine(sig[:32])


def encode_point(y: int, sign: int = 0) -> bytes:
    return int.to_bytes(y | (sign << 255), 32, "little")


def ack_plane_cases():
    """tests/ack_plane_cases.py: the seeded step and sweep cases, shared
    with the tests and the host rehearsal."""
    tests = str(Path(__file__).resolve().parent / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import ack_plane_cases

    return ack_plane_cases


def bls_cases():
    """tests/bls_cases.py: the seeded certificates of the BLS kernel's
    launches, shared with the tests and the host rehearsal."""
    tests = str(Path(__file__).resolve().parent / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import bls_cases

    return bls_cases


def compare_bls(label, certs, voters, width=None) -> tuple:
    """The BLS kernel and its plain version on the card, on one launch's
    inputs (``width``: exactly that many voter slots, not padded): outputs
    bit for bit equal, affine points equal to the host fold.  Returns the
    CPU inputs, the kernel's affine points and the plain version's wall ms
    (one call, synchronised: its hundreds of thousands of small launches
    make a second call a waste)."""
    import torch

    from mirbft_tpu_torch.ops import bls_g1

    arrays = [torch.from_numpy(a) for a in
              bls_cases().pack(certs, voters, width)]
    dev = [a.cuda() for a in arrays]
    out = bls_g1.aggregate_points(*dev)
    torch.cuda.synchronize()
    start = time.perf_counter()
    plain = bls_g1.aggregate_plain(*dev)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - start) * 1e3
    check(torch.equal(out, plain),
          f"bls {label}: kernel != plain at {tuple(arrays[3].shape)}")
    points = [bls_g1.to_affine(xyz) for xyz in bls_g1.canonical(out)]
    check(points[: len(certs)] == bls_cases().host_sums(certs),
          f"bls {label}: != the host fold")
    check(all(p is None for p in points[len(certs):]),
          f"bls {label}: a padding certificate is not the identity")
    return arrays, points, plain_ms


def bls_bounds(mask, sms: int, clock: float) -> dict:
    """The BLS kernel's bound on one launch's data: its integer
    instructions over the INT32 rate and its bytes over 3.35 TB/s, and
    its chain floor (``ops/bls_g1.py``: what this mask needs)."""
    from mirbft_tpu_torch.ops import bls_g1

    ops = bls_g1.aggregate_ops(mask)
    moved = bls_g1.aggregate_bytes(mask)
    ops_ms = ops / (sms * INT32_LANES_PER_SM * clock * 1e6) * 1e3
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    return dict(
        int_ops=ops, bytes=moved, ops_bound_ms=ops_ms, bytes_bound_ms=bytes_ms,
        bound_ms=max(ops_ms, bytes_ms),
        bound_by="operations" if ops_ms >= bytes_ms else "bytes",
        chain_floor_ms=bls_g1.chain_floor_cycles(mask) / (clock * 1e3),
        additions=sum(bls_g1.needed_additions(mask)),
    )


def compare_step(label, state0, batch, kw):
    """The step's kernel and plain version on two clones of ``state0`` on
    the card; raises unless the packed row outputs and all seven state
    arrays are equal and the adoption scratch is empty afterwards.
    Returns (row outputs, kernel state, plain state)."""
    import torch

    from mirbft_tpu_torch.ops import ack_plane

    cases = ack_plane_cases()
    kernel_state = [t.clone() for t in state0]
    plain_state = [t.clone() for t in state0]
    c_pad, w_pad, _limbs = state0[0].shape
    first = ack_plane.new_first(c_pad * w_pad, "cuda")
    out = ack_plane.ack_step(*kernel_state, batch, first=first, **kw)
    want = ack_plane.ack_step_plain(*plain_state, batch, **kw)
    check(torch.equal(out, want), f"{label}: row outputs differ")
    for name, got, expected in zip(cases.STATE, kernel_state, plain_state):
        check(torch.equal(got, expected), f"{label}: {name} differs")
    check(bool((first == ack_plane.FIRST_NONE).all()),
          f"{label}: the adoption scratch is not empty after the step")
    return out, kernel_state, plain_state


def compare_sweep(label, kernel_state, plain_state, kw) -> list:
    """The sweep's kernel on ``kernel_state`` and plain version on
    ``plain_state`` (equal states on the card); raises unless the totals
    and the rewritten ticks are equal.  Returns the totals."""
    import torch

    from mirbft_tpu_torch.ops import ack_plane

    totals = ack_plane.quorum_sweep(
        *(kernel_state[i] for i in (0, 3, 4, 5, 6)), **kw
    ).tolist()
    plain_totals = ack_plane.quorum_sweep_plain(
        *(plain_state[i] for i in (0, 3, 4, 5, 6)), **kw
    ).tolist()
    check(totals == plain_totals,
          f"{label}: sweep totals {totals} != {plain_totals}")
    check(torch.equal(kernel_state[6], plain_state[6]),
          f"{label}: sweep tick differs")
    return totals


def compare_sweep_plane(slots: int, limbs: int, kind: str) -> list:
    """One of tests/ack_plane_cases.py's ``SWEEP_ON_CARD`` planes through
    the sweep's kernel and its plain version on the card, twice in a row
    (the second after the first's ticket reset); raises unless the totals
    and ticks are equal each time and each sweep counted exactly one
    launch.  Returns the totals."""
    import torch

    from mirbft_tpu_torch.ops import ack_plane

    cases = ack_plane_cases()
    case, kernel, plain = cases.sweep_on_card(SEED + slots + limbs, slots,
                                              limbs, kind, "cuda")
    kw = dict(weak_q=case["weak_q"], strong_q=case["strong_q"])
    label = f"ack sweep ({slots} slots, {limbs} limbs, {kind})"
    for rep in range(2):
        before = ack_plane.quorum_sweep.launches
        totals = ack_plane.quorum_sweep(*kernel, **kw).tolist()
        check(ack_plane.quorum_sweep.launches == before + 1,
              f"{label}: {ack_plane.quorum_sweep.launches - before} launches")
        want = ack_plane.quorum_sweep_plain(*plain, **kw).tolist()
        check(totals == want,
              f"{label}, sweep {rep + 1}: totals {totals} != {want}")
        check(torch.equal(kernel[4], plain[4]),
              f"{label}, sweep {rep + 1}: tick differs")
    if kind == "certified":
        check(totals == [slots, slots, 0], f"{label}: totals {totals}")
    return totals


def compare_ack(rows: int, limbs: int) -> dict:
    """One seeded case through both kernels and their plain versions on
    the card (``compare_step``, then ``compare_sweep`` on the states it
    left).  Returns the case's row classes."""
    from mirbft_tpu_torch.ops import ack_plane

    cases = ack_plane_cases()
    case = cases.make_case(SEED + rows * 3 + limbs, rows, limbs)
    kw = dict(weak_q=case["weak_q"], strong_q=case["strong_q"])
    label = f"ack step ({rows} rows, {limbs} limbs)"
    out, kernel_state, plain_state = compare_step(
        label, cases.torch_state(case, "cuda"),
        cases.torch_batch(case, "cuda"), kw,
    )
    totals = compare_sweep(label, kernel_state, plain_state, kw)
    classes = {k: int(v.sum()) for k, v in
               ack_plane.unpack_step(out.cpu()).items() if k != "newcount"}
    check(all(classes.values()), f"{label}: a row class is empty: {classes}")
    return {"rows": rows, "limbs": limbs, "classes": classes,
            "sweep": totals}


def compare_crossing(rows: int) -> tuple:
    """The crossing case (tests/ack_plane_cases.py) through
    ``compare_step``: one virgin slot hit from the grid's first block,
    the middle, and the last rows.  Raises unless the first row adopts
    and applies, the middle one falls back and the last applies; returns
    (adopt, applied, fallback) of the three and, for each, which of its
    thread's rows it is (0 the first; ``ack_plane.step_grid``)."""
    from mirbft_tpu_torch.ops import ack_plane

    cases = ack_plane_cases()
    case = cases.make_crossing_case(SEED + rows, rows, 1)
    kw = dict(weak_q=case["weak_q"], strong_q=case["strong_q"])
    out, _, _ = compare_step(f"ack step, crossing case ({rows} rows)",
                             cases.torch_state(case, "cuda"),
                             cases.torch_batch(case, "cuda"), kw)
    res = ack_plane.unpack_step(out.cpu())
    got = [[int(res[k][r]) for k in ("adopt", "applied", "fallback")]
           for r in cases.crossing_rows(rows)]
    check(got == [[1, 1, 0], [0, 0, 1], [0, 1, 0]],
          f"ack step, crossing case ({rows} rows): rows {got}")
    threads, _ = ack_plane.step_grid(rows)
    return got, [r // threads for r in cases.crossing_rows(rows)]


def launch_floor(rows: int) -> float:
    """Device ms of the empty kernel launched as the ack step is at
    ``rows`` rows (``ack_plane.empty_step``: the same grid), timed as
    the step is (``time_events``): the yardstick a step of one launch is
    read against."""
    from mirbft_tpu_torch.ops import ack_plane

    return time_events(lambda: [], lambda: ack_plane.empty_step(rows))


def time_events(make_args, launch, reps=20):
    """Device ms of ``launch(*args)``, each on fresh ``make_args()`` (the
    step changes its state), with CUDA events around the launch queued
    behind a spin kernel so the host's launch cost is not in it: the
    median of ``reps``."""
    import torch

    times = []
    for rep in range(reps + 3):
        args = make_args()
        torch.cuda.synchronize()
        began = torch.cuda.Event(enable_timing=True)
        ended = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        began.record()
        launch(*args)
        ended.record()
        ended.synchronize()
        if rep >= 3:
            times.append(began.elapsed_time(ended))
    return statistics.median(times)


def time_wall(make_args, launch, reps=5):
    """Wall ms of ``launch(*args)`` on fresh args, synchronised: the
    median of ``reps`` (the plain versions, whose many small launches
    the host queues one by one)."""
    import torch

    times = []
    for _ in range(reps + 1):
        args = make_args()
        torch.cuda.synchronize()
        start = time.perf_counter()
        launch(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return statistics.median(times[1:])


def rung_step_inputs(n_clients: int, source: int, c_pad: int, w_pad: int):
    """The ack-plane rung's first frame of ``source`` and the state it
    meets (the rung's seed and orders): source 1 adopts every slot, 2
    crosses the weak quorum, 3 the strong.  Returns (state, batch) on the
    card."""
    import numpy as np
    import torch

    from mirbft_tpu_torch import bench as port_bench
    from mirbft_tpu_torch.ops.ack_plane import BATCH_COLS, SLOW

    rng = np.random.default_rng(port_bench.ACKPLANE_SEED)
    dig_mat = rng.integers(0, 256, size=(n_clients, 32), dtype=np.uint8)
    orders = {s: rng.permutation(n_clients)
              for s in port_bench.ACKPLANE_SOURCES}
    frame = n_clients // 8
    total = c_pad * w_pad
    flags = np.full((c_pad, w_pad), SLOW, dtype=np.uint8)
    flags[:n_clients] = 0  # each client's window: req 0 and req 1
    flags = flags.reshape(total)
    words = dig_mat.view(np.int32)
    canon = np.zeros((total, 8), dtype=np.int32)
    agree = np.zeros(total, dtype=np.int32)
    if source > 1:
        canon[np.arange(n_clients) * w_pad] = words
        agree[np.arange(n_clients) * w_pad] = (1 << source) - 2
    canon_ok = canon.any(axis=1)
    idx = orders[source][:frame]
    batch = np.zeros((16384, BATCH_COLS), dtype=np.int32)
    batch[:frame, 0] = idx
    batch[:frame, 2] = source
    batch[:frame, 3] = 1
    batch[:frame, 4:] = words[idx]
    shape = (c_pad, w_pad)
    state = [
        torch.from_numpy(agree.reshape(shape + (1,))),
        torch.from_numpy(agree.reshape(shape + (1,)).copy()),
        torch.from_numpy(canon.reshape(shape + (8,))),
        torch.from_numpy(canon_ok.reshape(shape)),
        torch.from_numpy(flags.reshape(shape)),
        torch.zeros(shape, dtype=torch.bool),
        torch.zeros(shape, dtype=torch.uint8),
    ]
    return [t.to("cuda") for t in state], torch.from_numpy(batch).to("cuda")


def ed25519_corpus():
    """tests/ed25519_corpus.py: the encodings that take every branch of
    point decompression, shared with the tests and the host rehearsal."""
    tests = str(Path(__file__).resolve().parent / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import ed25519_corpus

    return ed25519_corpus


def rung3_row(presigned, key, kind: int):
    """(pk, msg, sig) of a presigned rung-3 request: valid (kind 0),
    corrupted R (1), corrupted S (2) or a wrong message (3)."""
    from mirbft_tpu_torch.testengine.signing import signing_message, split_signed

    payload, sig, pk = split_signed(presigned[key])
    msg = signing_message(key[0], key[1], payload)
    if kind == 1:
        sig = bytes([sig[0] ^ 2]) + sig[1:]
    elif kind == 2:
        sig = sig[:40] + bytes([sig[40] ^ 8]) + sig[41:]
    elif kind == 3:
        msg += b"?"
    return pk, msg, sig


def signature_corpus(presigned) -> tuple:
    """Phase 6's corpus: 4096 rows that reach the kernels (the edge rows,
    then presigned rung-3 requests, valid and corrupted in turn), whose
    prefixes are the corpora at every n (n = 8 holds the first 8 edge
    rows), and the rows the host rejects, added to every corpus."""
    from mirbft_tpu_torch.crypto import ed25519_host as host

    keys = sorted(presigned)
    pk, msg, sig = rung3_row(presigned, keys[0], 0)
    r = 77  # a signature [r]B, r that the identity as key satisfies
    r_sig = host.compress(
        host.scalar_mult(r, host.to_extended(host.BASE))
    ) + r.to_bytes(32, "little")
    rows = [rung3_row(presigned, keys[0], kind) for kind in range(4)] + [
        (encode_point(2), b"m", r_sig),  # A has no square root
        (encode_point(1), b"m", r_sig),  # A = identity (small order)
        (encode_point(1, 1), b"m", r_sig),  # x = 0 with the sign bit set
        (ed25519_corpus().order8_encoding(), b"m", r_sig),  # A of order 8
        (pk, msg, encode_point(2) + sig[32:]),  # R has no square root
    ]
    fill = max(ED25519_COMPARED) - len(rows)
    rows += [rung3_row(presigned, keys[1 + i], i % 4) for i in range(fill)]
    rejects = [
        (encode_point(host.P), msg, sig),  # y_A >= p
        (pk, msg, encode_point(host.P + 5) + sig[32:]),  # y_R >= p
        (pk, msg, sig[:32] + host.L.to_bytes(32, "little")),  # S >= L
        (pk[:31], msg, sig),  # bad key length
        (pk, msg, sig[:63]),  # bad signature length
    ]
    return rows, rejects


def compare_ed25519(n, rows, oracle) -> int:
    """Both kernels against their plain versions and the oracle on one
    corpus, of which exactly n rows reach the kernels; returns the max
    absolute difference between kernel and plain outputs (0 when
    equal)."""
    import torch

    from mirbft_tpu_torch.ops import ed25519

    live = [
        (i, ed25519.marshal_light(*row)) for i, row in enumerate(rows)
    ]
    live = [(i, m) for i, m in live if m is not None]
    check(len(live) == n, f"ed25519 n={n}: {len(live)} rows reach the kernels")
    enc, s_words, k_words = (
        torch.from_numpy(a).to("cuda")
        for a in ed25519.pack_rows([m for _i, m in live])
    )
    xy, ok = ed25519.decompress(enc)
    verdicts = ed25519.ladder(xy, ok, s_words, k_words)
    torch.cuda.synchronize()
    plain_xy, plain_ok = ed25519.decompress_plain(enc)
    plain_verdicts = ed25519.ladder_plain(plain_xy, plain_ok, s_words, k_words)
    err = max(
        int((xy - plain_xy).abs().max()), int((ok - plain_ok).abs().max()),
        int((verdicts - plain_verdicts).abs().max()),
    )
    check(err == 0, f"ed25519 n={n}: kernel != plain (max abs err {err})")
    xy, ok, verdicts = xy.cpu().numpy(), ok.cpu().tolist(), verdicts.cpu()
    m = len(live)
    for j, (i, _row) in enumerate(live):
        expect, a_point, r_point = oracle[i]
        check(bool(verdicts[j]) == expect, f"ed25519 n={n}: row {i} verdict")
        for slot, point in ((j, a_point), (m + j, r_point)):
            check(bool(ok[slot]) == (point is not None),
                  f"ed25519 n={n}: row {i} decompression ok flag")
            if point is not None:
                got = tuple(ed25519.limbs_to_int(xy[slot, c]) for c in (0, 1))
                check(got == tuple(point), f"ed25519 n={n}: row {i} point")
    pks, msgs, sigs = map(list, zip(*rows))
    got = ed25519.verify_batch(pks, msgs, sigs, device="cuda").tolist()
    check(got == [o[0] for o in oracle[: len(rows)]],
          f"ed25519 n={n}: verify_batch != oracle")
    accepted = sum(got)
    device_verdicts = {i: int(verdicts[j]) for j, (i, _row) in enumerate(live)}
    device_rejects = set(range(len(rows))) - {
        i for j, (i, _row) in enumerate(live) if ok[j] and ok[m + j]}
    host_err, host_n = compare_host_route(n, rows, oracle, device_verdicts,
                                          device_rejects)
    print(f"  ed25519 n={n}: {m} rows reach the kernels ({2 * m} points), "
          f"{len(rows) - m} rejected on the host, {accepted} accepted, "
          f"{sum(ok)} points decode: kernel == plain == oracle; host route: "
          f"{host_n} rows decompress on the host, the others exactly the "
          f"device route's rejects, ladder_extended == plain == oracle == "
          f"the device route")
    return max(err, host_err)


def compare_host_route(n, rows, oracle, device_verdicts, device_rejects):
    """The host route on phase 6's corpus: ``marshal_signature`` rejects
    exactly the rows the device route rejects (on the host, or by a
    decompression ok flag of 0), and the extended ladder on the rest, on
    the card and as its plain version, equals the oracle and the device
    route's verdicts.  Returns (max abs err kernel vs plain, rows)."""
    import torch

    from mirbft_tpu_torch.ops import ed25519

    marshalled = [ed25519.marshal_signature(*row) for row in rows]
    host_rejects = {i for i, h in enumerate(marshalled) if h is None}
    check(host_rejects == device_rejects,
          f"ed25519 n={n}: marshal_signature rejects rows "
          f"{sorted(host_rejects ^ device_rejects)} unlike the device route")
    live = [i for i, h in enumerate(marshalled) if h is not None]
    if not live:
        return 0, 0
    s_words, k_words, neg_a, r_xy = (
        torch.from_numpy(a).to("cuda")
        for a in ed25519.pack_signature_rows([marshalled[i] for i in live])
    )
    verdicts = ed25519.ladder_extended(neg_a, r_xy, s_words, k_words)
    torch.cuda.synchronize()
    plain = ed25519.ladder_extended_plain(neg_a, r_xy, s_words, k_words)
    err = int((verdicts - plain).abs().max())
    check(err == 0, f"ed25519 n={n}: ladder_extended != plain ({err})")
    for row, verdict in zip(live, verdicts.cpu().tolist()):
        check(bool(verdict) == oracle[row][0],
              f"ed25519 n={n}: row {row} ladder_extended verdict")
        check(verdict == device_verdicts[row],
              f"ed25519 n={n}: row {row} host route != device route")
    return err, len(live)


def compare_decompress_corpus(m: int) -> int:
    """The decompress kernel on the decompression corpus (every branch of
    RFC 8032 5.1.3) repeated to m rows, against its plain version and the
    oracle, bit for bit; returns the max absolute difference from plain
    (0)."""
    import torch

    from mirbft_tpu_torch.crypto import ed25519_host as host
    from mirbft_tpu_torch.ops import ed25519

    corpus = ed25519_corpus().decompression_corpus()
    oracle = [host.decompress(e) for e in corpus]
    encodings = (corpus * (m // len(corpus) + 1))[:m]
    enc = torch.from_numpy(ed25519._words(encodings)).to("cuda")
    xy, ok = ed25519.decompress(enc)
    torch.cuda.synchronize()
    plain_xy, plain_ok = ed25519.decompress_plain(enc)
    err = max(int((xy - plain_xy).abs().max()),
              int((ok - plain_ok).abs().max()))
    check(err == 0, f"decompress corpus m={m}: kernel != plain ({err})")
    xy, ok = xy.cpu(), ok.cpu().tolist()
    for i in range(m):
        point = oracle[i % len(corpus)]
        check(ok[i] == (point is not None),
              f"decompress corpus m={m}: row {i} ok flag")
        if point is not None:
            got = tuple(ed25519.limbs_to_int(xy[i, c]) for c in (0, 1))
            check(got == tuple(point[:2]),
                  f"decompress corpus m={m}: row {i} point")
    return err


def signed_engine_run(plane, signer):
    """Phase 7's run: events, wall s, and what the run decides (app chains,
    committed sequences, recorded events on the wire)."""
    import torch

    from mirbft_tpu_torch import pb
    from mirbft_tpu_torch.testengine import BasicRecorder

    gc.collect()
    start = time.perf_counter()
    rec = BasicRecorder(
        NODES, CLIENTS, SIGNED_REQS, batch_size=BATCH_SIZE, signer=signer,
        signature_plane=plane,
    )
    forged = pb.Request(
        client_id=NODES, req_no=FORGED_REQ_NO, data=b"evil" + b"\x01" * 96
    )
    for node in range(NODES):
        rec._schedule(
            0, node, pb.StateEvent(type=pb.EventPropose(request=forged))
        )
    events = rec.drain_clients(max_steps=20_000_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    committed = {n: list(s.committed_reqs) for n, s in rec.node_states.items()}
    check(all(rn != FORGED_REQ_NO for reqs in committed.values()
              for _c, rn, _s in reqs), "phase 7: a forged request committed")
    decided = (
        {n: s.app_chain for n, s in rec.node_states.items()}, committed,
        [(when, node, pb.encode(event))
         for when, node, event in rec.recorded_events],
    )
    return events, wall, decided, rec


def p99_ms(seconds: list) -> float:
    ms = sorted(1e3 * s for s in seconds)
    return ms[min(len(ms) - 1, int(0.99 * len(ms)))]


def ed25519_bounds(n: int, sms: int, clock: float) -> dict:
    """Each Ed25519 kernel's bound at n signatures: integer instructions
    over the INT32 instruction rate, and bytes over 3.35 TB/s; and its
    chain floor, one row's chain of dependent instructions at 4 cycles each
    (``ops/ed25519.py::chain_floor_cycles``)."""
    from mirbft_tpu_torch.ops import ed25519

    rate = sms * INT32_LANES_PER_SM * clock * 1e6
    consts = ed25519.CONST_ROWS * ed25519.NLIMB * 4
    shapes = {
        # 2n points: 32 bytes in, (x, y) 80 bytes and a flag out
        "decompress": (2 * n * ed25519.int_ops_per_row(ed25519.DECOMPRESS_OPS),
                       2 * n * (32 + 80 + 4) + consts),
        # n rows: two points and two flags in, S and k, a verdict out
        "ladder": (n * ed25519.int_ops_per_row(ed25519.LADDER_OPS),
                   n * (2 * 80 + 2 * 4 + 64 + 4) + consts),
        # n rows: -A extended (160 bytes) and R affine (80) in, S and k, a
        # verdict out
        "ladder_extended": (
            n * ed25519.int_ops_per_row(ed25519.LADDER_EXTENDED_OPS),
            n * (160 + 80 + 64 + 4) + consts),
    }
    out = {}
    for name, (ops, moved) in shapes.items():
        ops_ms = ops / rate * 1e3
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        chain_ms = ed25519.chain_floor_cycles(name) / (clock * 1e3)
        out[name] = dict(
            int_ops=ops, bytes=moved, ops_bound_ms=ops_ms,
            bytes_bound_ms=bytes_ms, bound_ms=bound_ms,
            bound_by="operations" if ops_ms >= bytes_ms else "bytes",
            chain_floor_ms=chain_ms,
            binds="chain floor" if chain_ms >= bound_ms else "throughput bound",
        )
    return out


def bls_phases(sms: int, t0: float) -> dict:
    """Phases 14 and 15: the BLS G1 kernel against its plain version and
    timed, then ladder rung 4 at full scale.  Returns what the kernels
    line reads."""
    from mirbft_tpu_torch import bench as port_bench
    from mirbft_tpu_torch.ops import bls_g1
    from mirbft_tpu_torch.ops.sha256 import sha256_digest_words

    # -- phase 14: the BLS G1 aggregation kernel == plain == host fold -------

    # Bounds and chain floors at the boost clock (the idle card reads far
    # lower between launches); the clock sampled after each timing beside.
    bls_clock = max_sm_clock_mhz()
    bls_timed = {}
    for label, certs, voters in bls_cases().cases():
        arrays, points, plain_ms = compare_bls(label, certs, voters)
        shape = tuple(arrays[3].shape)
        print(f"  bls {label}: kernel == plain at {shape}, == the host fold"
              f" ({sum(p is None for p in points[: len(certs)])} "
              "identities)")
        if label.startswith("edges (4, 4)"):
            check(points[1] is None and points[3] is None,
                  "bls: the empty or the cancelling certificate is not None")
        if shape in BLS_TIMED and shape not in bls_timed:
            bls_timed[shape] = arrays, plain_ms
    for label, certs, width in bls_cases().width_cases():
        arrays, points, _ = compare_bls(label, certs, None, width)
        check(points[2] is None, f"bls {label}: no vote is not None")
        print(f"  bls {label}: kernel == plain at "
              f"{tuple(arrays[3].shape)}, == the host fold")
    bls_shapes = []
    for shape in BLS_TIMED:
        arrays, plain_ms = bls_timed[shape]
        dev = [a.cuda() for a in arrays]
        ms, call_ms = time_device(lambda dev=dev: bls_g1.aggregate_points(*dev),
                                  reps=20)
        sampled = sm_clock_mhz()
        bound = bls_bounds(arrays[3], sms, bls_clock)
        bls_shapes.append({"shape": list(shape), "ms": ms, "call_ms": call_ms,
                           "plain_ms": plain_ms, "sampled_clock_mhz": sampled,
                           "chain_floor_share": bound["chain_floor_ms"] / ms,
                           **bound})
        print(f"  bls kernel at {shape}: {ms:.6f} ms (CUDA events, 20 "
              f"launches behind a spin kernel; host call {call_ms:.6f} ms), "
              f"bound {bound['bound_ms']:.6f} ms by {bound['bound_by']} "
              f"({bound['int_ops']} integer instructions for "
              f"{bound['additions']} additions / {sms} SMs x 64 lanes at "
              f"{bls_clock:.0f} MHz (sampled after: {sampled:.0f} MHz) = "
              f"{bound['ops_bound_ms']:.6f} ms; "
              f"{bound['bytes']} bytes / 3.35 TB/s = "
              f"{bound['bytes_bound_ms']:.6f} ms), chain floor "
              f"{bound['chain_floor_ms']:.6f} ms "
              f"({100 * bound['chain_floor_ms'] / ms:.2f}% of the kernel's "
              f"time), plain "
              f"{plain_ms:.6f} ms (wall, one call on the card); library_ms "
              "null (no PyTorch call adds G1 points)")
    launches = len(bls_cases().cases()) + len(bls_cases().width_cases())
    print(f"phase 14 ok: the BLS G1 kernel == plain, bit for bit, and == "
          f"the host fold on {launches} launches (done at "
          f"{time.perf_counter() - t0:.1f} s)")

    # -- phase 15: ladder rung 4 at full scale ---------------------------------
    # Phase 22d's CLI runs on worker processes beside this single-core rung.
    _CLUSTER_CHAOS["run"] = start_cluster_chaos()
    bls_g1.aggregate_points.launches = 0
    bls_g1.aggregate_points.launches_by_shape.clear()
    sha256_digest_words.launches = 0
    rung4 = port_bench.rung4_run(device="cuda")
    rung4_launches = {"bls_aggregate": bls_g1.aggregate_points.launches,
                      "sha256_digest": sha256_digest_words.launches}
    rung4_shapes = dict(bls_g1.aggregate_points.launches_by_shape)
    check(rung4["events"] == RUNG4_EVENTS,
          f"rung 4: {rung4['events']} events, the JAX package's run "
          f"{RUNG4_EVENTS}")
    check(rung4["chain"] == RUNG4_CHAIN, f"rung 4: chain {rung4['chain']}")
    check(rung4["commits"] == [port_bench.RUNG4_CLIENTS
                               * port_bench.RUNG4_REQS],
          f"rung 4: commits per node {rung4['commits']}")
    check(rung4["certificates"] >= 1 and rung4["device_batches"] >= 1
          and rung4["host_folds"] == 0,
          f"rung 4: {rung4['certificates']} certificates, "
          f"{rung4['device_batches']} launches, {rung4['host_folds']} host "
          "folds")
    check(rung4_launches["bls_aggregate"] == rung4["device_batches"],
          f"rung 4: BLS launches {rung4_launches}")
    check(rung4["host_digests"] == 0 and rung4["device_digests"] > 0
          and rung4_launches["sha256_digest"] == rung4["hash_launches"],
          f"rung 4: digests device {rung4['device_digests']} host "
          f"{rung4['host_digests']}, launches {rung4_launches}")
    seq, value, signers, asig = rung4["certificate"]
    check(len(signers) == rung4["quorum"], f"rung 4: {len(signers)} signers")
    check(asig == bls_cases().host_sums([rung4["votes"]])[0],
          "rung 4: the aggregate != bls_host.aggregate_g1 of its votes")
    rung4_arrays, _, _ = compare_bls("rung 4's votes", [rung4["votes"]],
                                     None)
    rung4_dev = [a.cuda() for a in rung4_arrays]
    rung4_ms = time_events(lambda: rung4_dev, bls_g1.aggregate_points)
    rung4_bound = bls_bounds(rung4_arrays[3], sms, bls_clock)
    device_ms = rung4["kernel_ms"] + rung4_ms
    print(
        f"phase 15 ok: rung 4 {port_bench.RUNG4_NODES} nodes (f = "
        f"{(port_bench.RUNG4_NODES - 1) // 3}) x {port_bench.RUNG4_CLIENTS} "
        f"clients x {port_bench.RUNG4_REQS}, 30 ms link jitter, node "
        f"{port_bench.RUNG4_DROP_SOURCE}'s drop mangler ({rung4['dropped']} "
        f"frames dropped): {rung4['events']} events, chain "
        f"{RUNG4_CHAIN[:16]}..., {rung4['commits'][0]} commits on every "
        f"node, {rung4['sim_ms']} simulated ms; wall {rung4['wall_s']:.6f} "
        f"s, {rung4['reqs_per_sec']:.3f} committed req/s; "
        f"{rung4['certificates']} certificate(s) at seq {seq} from "
        f"{len(signers)} votes, aggregated by the kernel in "
        f"{rung4['device_batches']} launch(es) at {sorted(rung4_shapes)} "
        f"(0 host folds), {rung4['aggregate_ms']:.6f} ms wall for "
        f"certificates(), the kernel {rung4_ms:.6f} ms on the rung's votes "
        f"(CUDA events, median of 20; == plain, == the host fold; chain "
        f"floor {rung4_bound['chain_floor_ms']:.6f} ms); verifies, a tampered"
        f" statement fails; digests device {rung4['device_digests']} host "
        f"{rung4['host_digests']} in {rung4['hash_launches']} launches, "
        f"sha256 {rung4['kernel_ms']:.6f} ms; launches {rung4_launches}; "
        f"card idle {100 * (1 - device_ms / 1e3 / rung4['wall_s']):.4f}% of "
        f"wall (done at {time.perf_counter() - t0:.1f} s)"
    )
    return dict(shapes=bls_shapes, rung4_ms=rung4_ms, clock=bls_clock,
                launches=rung4_launches["bls_aggregate"])


def compare_ingress_launch(items: list) -> tuple:
    """Replay one ingress batch: its rows through both Ed25519 kernels and
    through their plain versions on the card, bit for bit, and the batch's
    verdicts from the kernels against the host oracle's.  Returns (rows,
    max_abs_err)."""
    import torch

    from mirbft_tpu_torch import bench as port_bench
    from mirbft_tpu_torch.ops import ed25519
    from mirbft_tpu_torch.testengine import signing

    rows = port_bench.ingress_rows(items)
    enc, s_words, k_words = (
        torch.from_numpy(a).to("cuda") for a in ed25519.pack_rows(rows)
    )
    xy, ok = ed25519.decompress(enc)
    verdicts = ed25519.ladder(xy, ok, s_words, k_words)
    torch.cuda.synchronize()
    plain_xy, plain_ok = ed25519.decompress_plain(enc)
    plain_verdicts = ed25519.ladder_plain(plain_xy, plain_ok, s_words, k_words)
    err = max(
        int((xy - plain_xy).abs().max()), int((ok - plain_ok).abs().max()),
        int((verdicts - plain_verdicts).abs().max()),
    )
    check(err == 0, f"ingress n={len(rows)}: kernel != plain (max abs err "
          f"{err})")
    check(signing.kernel_verifier(items, device="cuda")
          == signing.host_verifier(items),
          f"ingress n={len(rows)}: kernel verdicts != the host oracle's")
    return len(rows), err


def service_phases(t0: float) -> dict:
    """Phases 16 and 17, each on worker processes: signed ingress, then the
    replicated KV service and a restarted replica.  Each worker counts its
    wrappers' launches from 0 (a process of its own) and reports them;
    the sums over the workers are what the kernels line reads."""
    from mirbft_tpu_torch import bench as port_bench

    # -- phase 16: signed ingress on 4 workers ---------------------------------
    start = time.perf_counter()
    ing = port_bench.live_mp_run(CLUSTER_PROCESSOR, device="cuda",
                                 rates=port_bench.INGRESS_RATES, signed=True)
    ing_wall = time.perf_counter() - start
    for step in ing["steps"]:
        print(
            f"  ingress {step.name}: submitted {step.submitted}, committed "
            f"{step.committed}, timed out {step.timed_out}, retries "
            f"{step.duplicates}; goodput {step.goodput_per_sec:.3f} req/s, "
            f"submit-to-commit p50 {step.p50_ms:.3f} ms p95 "
            f"{step.p95_ms:.3f} ms"
        )
    sizes = collections.Counter(len(b) for b in ing["batches"])
    print(f"  ingress batches by worker {dict(collections.Counter(ing['batch_nodes']))}"
          f", by size {sorted(sizes.items())} (size, count); ingress "
          f"counters {ing['ingress']}; boot {ing['boot_seconds']} s")
    totals = check_workers("16", ing["evidence"], ing["exit_codes"],
                           signed=True)
    judged_invalid = collections.Counter()
    for n, items, verdicts in zip(ing["batch_nodes"], ing["batches"],
                                  ing["verdicts"]):
        check(verdicts is not None and len(verdicts) == len(items),
              f"ingress node {n}: a journaled batch of {len(items)} items "
              f"has verdicts {verdicts}")
        judged_invalid[n] += len(items) - sum(verdicts or ())
    for n, stage in sorted(ing["ingress"].items()):
        check(stage["verify_errors"] == 0,
              f"ingress node {n}: {stage['verify_errors']} verifier errors")
        check(stage["dropped_overflow"] == 0,
              f"ingress node {n}: {stage['dropped_overflow']} dropped")
        check(stage["evicted"] == ing["forged_to"][n] == judged_invalid[n],
              f"ingress node {n}: evicted {stage['evicted']}, sent "
              f"{ing['forged_to'][n]} forgeries, journaled "
              f"{judged_invalid[n]} invalid verdicts")
    # A node that fell behind and installed a snapshot holds the requests
    # below its checkpoint through the snapshot: each request it did not
    # commit itself must sit at or below that checkpoint's seq_no.
    adopted = 0
    for n, commits in sorted(ing["per_node_commits"].items()):
        missing = ing["honest"] - set(commits)
        installed, cp_seq = ing["transfers"][n]
        check(not missing or (installed and all(
            ing["seq_of"][key] <= cp_seq for key in missing)),
              f"ingress node {n}: committed {len(commits)} of "
              f"{len(ing['honest'])} requests; missing {sorted(missing)[:8]}"
              f", snapshots installed {ing['transfers']}")
        check(not commits or max(commits.values()) == 1,
              f"ingress node {n}: a request committed twice")
        # The raw scan of the request log saw the whole run only if no
        # compaction dropped a record: every committed request is there.
        check(set(commits) <= ing["stored"][n],
              f"ingress node {n}: {len(set(commits) - ing['stored'][n])} "
              f"committed requests have no STORE record in its log")
        adopted += len(missing)
    check(not ing["missing"] and not ing["duplicates"],
          f"ingress: never committed {ing['missing'][:5]}, twice "
          f"{ing['duplicates'][:5]}")
    check(ing["forged_admitted"] == 0 and ing["forged_stored"] == 0,
          f"ingress: {ing['forged_admitted']} forged requests judged valid, "
          f"{ing['forged_stored']} stored in a worker's request log")
    check(len(set(ing["chains"])) == 1 and "" not in ing["chains"],
          f"ingress: chains {ing['chains']}")
    for step in ing["steps"]:
        check(step.timed_out == 0,
              f"ingress {step.name}: {step.timed_out} requests timed out")
    # Each journaled batch with a row left after the host's rejects is one
    # launch of each kernel at that many rows in its worker; the first
    # batch at each row count is replayed through kernel and plain here
    # (outside the counted run).
    batch_rows = [len(port_bench.ingress_rows(b)) for b in ing["batches"]]
    launched = collections.Counter(n for n in batch_rows if n)
    ing_launches = {
        "sha256_digest": totals["launches_sha256"],
        "ed25519_decompress": totals["launches_ed25519_decompress"],
        "ed25519_ladder": totals["launches_ed25519_ladder"],
    }
    check(ing_launches["ed25519_decompress"] == ing_launches["ed25519_ladder"]
          == sum(launched.values()) > 0,
          f"ingress: launches {ing_launches}, {sum(launched.values())} "
          f"batches with rows of {len(batch_rows)}")
    by_rows = ing["launches_by_rows"]
    check(by_rows["ed25519_ladder"] == launched
          and by_rows["ed25519_decompress"] == collections.Counter(
              {2 * n: c for n, c in launched.items()}),
          f"ingress: ladder launches by rows "
          f"{sorted(by_rows['ed25519_ladder'].items())}, decompress "
          f"{sorted(by_rows['ed25519_decompress'].items())}, batches "
          f"{sorted(launched.items())}")
    check(ing["host_digests"] == 0 and ing["device_digests"] > 0
          and ing_launches["sha256_digest"] == ing["hash_launches"],
          f"ingress: digests device {ing['device_digests']} host "
          f"{ing['host_digests']} in {ing['hash_launches']} launches, the "
          f"wrappers counted {ing_launches}")
    replayed, ing_err = {}, 0
    for items, n in zip(ing["batches"], batch_rows):
        if n and n not in replayed:
            rows, err = compare_ingress_launch(items)
            check(rows == n, f"ingress replay: {rows} rows, journaled {n}")
            replayed[n] = len(items)
            ing_err = max(ing_err, err)
    evicted = sum(s["evicted"] for s in ing["ingress"].values())
    print(
        f"phase 16 ok: signed ingress on {port_bench.LIVE_MP_NODES} workers "
        f"({CLUSTER_PROCESSOR}), BatchSize {port_bench.LIVE_MP_BATCH_SIZE}, "
        f"Poisson {'/'.join(str(int(r)) for r in port_bench.INGRESS_RATES)} "
        f"req/s x {port_bench.LIVE_MP_STEP_DURATION_S} s: "
        f"{len(ing['honest'])} honest requests committed once on every node "
        f"({adopted} of them through the snapshots installed, by node: "
        f"{ {n: t[0] for n, t in ing['transfers'].items()} }), "
        f"{ing['forged']} forged twins ({evicted} evictions, one a forgery a "
        f"node), none judged valid, none in a request log; 0 verifier "
        f"errors, 0 dropped; one "
        f"chain; every worker exited 0, no log fault; "
        f"{len(ing['batches'])} journaled ingress batches, "
        f"{sum(launched.values())} with rows: one launch of each Ed25519 "
        f"kernel each at {len(launched)} row counts {sorted(launched)}, each "
        f"replayed kernel == plain (max_abs_err {ing_err}) == oracle; digests"
        f" device {ing['device_digests']} host {ing['host_digests']} in "
        f"{ing['hash_launches']} launches; wrapper launches {ing_launches}; "
        f"the rung {ing_wall:.3f} s, the phase {time.perf_counter() - start:.3f}"
        f" s (done at {time.perf_counter() - t0:.1f} s)"
    )

    # -- phase 17: the KV service on 8 workers and a restarted replica ---------
    start = time.perf_counter()
    app = port_bench.app_run(device="cuda")
    app_wall = time.perf_counter() - start
    step = app["step"]
    lag = app["lag"]
    # Queue 3, item 16: a snapshot install may orphan its home node's
    # write waiter; which workers installed one during the step says
    # whether a timed-out op is that.
    print(f"  app: snapshots installed during the step, by worker "
          f"{app['step_installs']}; session homes {app['homes']}; boot "
          f"{app['boot_seconds']} s")
    check(step.timed_out == 0,
          f"app: {step.timed_out} ops timed out (snapshots installed during "
          f"the step by worker {app['step_installs']}, homes {app['homes']})")
    check("violation" not in app["linearizable"],
          f"app: {app['linearizable'].get('violation')}")
    check(app["converged"] and len(app["store_digests"]) == port_bench.APP_NODES
          and len(set(app["store_digests"].values())) == 1,
          f"app: the workers' KvStore digests {app['store_digests']}, "
          f"(applied seq, applied index) {app['applied']}; (low, high, epoch,"
          f" epoch state, applied seq) by worker {app['stall']}")
    # The stopped worker's second incarnation may hash nothing after its
    # install: its flushes are checked through its first.
    app_totals = check_workers("17", app["evidence"], app["exit_codes"],
                               nodes=range(port_bench.APP_NODES - 1))
    for n, e in sorted(app["evidence"].items()):
        check(e["device_digests"] > 0 and e["host_digests"] == 0,
              f"app: node {n} digests device {e['device_digests']} host "
              f"{e['host_digests']}")
    check(all(codes == [0] * len(codes) for codes in app["exit_codes"].values()),
          f"app: exit codes {app['exit_codes']}")
    app_launches = {"sha256_digest": app_totals["launches_sha256"]}
    check(app["host_digests"] == 0 and app["device_digests"] > 0
          and app_launches["sha256_digest"] == app["hash_launches"],
          f"app: digests device {app['device_digests']} host "
          f"{app['host_digests']} in {app['hash_launches']} launches, the "
          f"wrappers counted {app_launches}")
    engine = lag["engine"]
    check(lag["caught_up"] and engine.get("snapshots_installed", 0) >= 1,
          f"app: the restarted replica did not catch up: {lag}")
    check(engine["chunks_rejected_corrupt"] == 0
          and engine["chunks_rejected_oversized"] == 0,
          f"app: the restarted replica rejected chunks: {engine}")
    check(lag["snapshot_equal"], "app: the restarted replica's KvStore differs")
    check(lag["reads_ok"], f"app: committed reads from the restarted replica: "
          f"{lag['reads'][:4]}")
    idle = 100 * (1 - app["kernel_ms"] / 1e3 / app["wall_s"])
    print(
        f"  app: {step.submitted} ops ({step.reads} reads, {step.writes} "
        f"writes) in {step.duration_s:.3f} s: read p50 {step.read_p50_ms:.3f}"
        f" p95 {step.read_p95_ms:.3f} p99 {step.read_p99_ms:.3f} ms, write "
        f"p50 {step.write_p50_ms:.3f} p95 {step.write_p95_ms:.3f} p99 "
        f"{step.write_p99_ms:.3f} ms; goodput {step.goodput_per_sec:.3f} "
        f"ops/s (reads {step.read_goodput_per_sec:.3f}, writes "
        f"{step.write_goodput_per_sec:.3f}); linearizable reads "
        f"{app['linearizable']}"
    )
    print(
        f"  app restarted replica {lag['node']}: down {lag['down_s']:.3f} s "
        f"while {lag['writes']} keys were written and the others' low "
        f"watermarks moved from {lag['low_watermark_before']} to "
        f"{min(lag['others_low_watermarks'])} (target "
        f"{lag['target_low_watermark']}), {lag['seqs_missed']} seqs missed; "
        f"boot {lag['boot_s']:.3f} s, restart to install "
        f"{lag['transfer_s']:.3f} s, to one KvStore digest "
        f"{lag['caught_up_s']:.3f} s; transfer {lag['transfer_bytes']} "
        f"bytes in {lag['transfer_chunks']} chunks; engine {engine}; "
        f"{len(lag['reads'])} committed reads from it == the writes"
    )
    print(
        f"phase 17 ok: the KV service on {port_bench.APP_NODES} workers "
        f"({CLUSTER_PROCESSOR}, app kv, not proxied), "
        f"{port_bench.APP_SESSIONS} KvClient sessions x "
        f"{port_bench.APP_OPS_PER_SESSION} ops over the service sockets, 0 "
        f"timed out, reads linearizable, one KvStore digest "
        f"({next(iter(app['store_digests'].values()))[:16]}...) on every "
        f"worker; node "
        f"{lag['node']} stopped and restarted from its disk installed "
        f"{engine['snapshots_installed']} snapshot(s), 0 chunks rejected, "
        f"equal KvStore bytes, committed reads == the writes; every worker "
        f"exited 0, no log fault; digests device {app['device_digests']} "
        f"host {app['host_digests']} in {app['hash_launches']} launches, "
        f"{app['kernel_ms']:.6f} ms of kernel spans (CUDA events around each"
        f" launch) over {app['wall_s']:.3f} s: the card idle at least "
        f"{idle:.4f}%; wrapper launches {app_launches}; the rung "
        f"{app_wall:.3f} s, the phase {time.perf_counter() - start:.3f} s "
        f"(done at {time.perf_counter() - t0:.1f} s)"
    )
    return dict(ingress_launches=ing_launches, app_launches=app_launches,
                ingress_err=ing_err, replayed=sorted(replayed))


def http_get(address, path: str) -> tuple:
    """(status, body) of one GET on a node's exporter; an HTTP error
    status is returned, not raised."""
    import urllib.error
    import urllib.request

    host, port = address
    try:
        with urllib.request.urlopen(f"http://{host}:{port}{path}",
                                    timeout=10) as resp:
            return resp.status, resp.read().decode("utf-8")
    except urllib.error.HTTPError as err:
        return err.code, err.read().decode("utf-8")


def prom_value(text: str, name: str, **labels) -> float:
    """The value of one series in a Prometheus text exposition (0 when
    the series is absent)."""
    for line in text.splitlines():
        if not line.startswith(name + "{") and not line.startswith(name + " "):
            continue
        head, _, value = line.rpartition(" ")
        got = dict(re.findall(r'(\w+)="([^"]*)"', head))
        if all(got.get(k) == v for k, v in labels.items()):
            return float(value)
    return 0.0


def run_obsv_cli(argv: list) -> tuple:
    """``python -m mirbft_tpu_torch.obsv ARGV`` in this process (so the
    wrappers' counts see its launches): (exit code, standard output)."""
    import contextlib

    from mirbft_tpu_torch.obsv.__main__ import main as obsv_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = obsv_main(argv)
    return rc, out.getvalue()


def engine_table(text: str) -> tuple:
    """The run line's events and simulated ms, and the phase table, of an
    ``obsv`` engine run's output."""
    run = re.search(r"-> (\d+) events, sim (\d+) ms", text)
    table = text.split("consensus phase latency (simulated ms):\n", 1)[1]
    return int(run.group(1)), int(run.group(2)), table.split("\n\n", 1)[0]


def committed_flows(traces: list) -> int:
    """Distinct sequence numbers with a ``seq.committed`` milestone."""
    return len({
        event["args"]["seq"]
        for trace in traces for event in trace["traceEvents"]
        if event.get("ph") == "i" and event.get("name") == "seq.committed"
    })


def epoch_changes(traces: list) -> dict:
    """Each node's epoch milestones in a run's traces: node -> [(name,
    epoch, seconds from the run's first event)]."""
    from mirbft_tpu_torch.obsv.merge import aligned_events

    shifted, _plans = aligned_events(traces)
    if not shifted:
        return {}
    base = min(abs_us for abs_us, _node, _event in shifted)
    out: dict = {}
    for abs_us, node, event in sorted(shifted, key=lambda x: x[0]):
        name = event.get("name", "")
        if event.get("ph") == "i" and name.startswith("epoch."):
            out.setdefault(node, []).append(
                (name, event["args"]["epoch"],
                 round((abs_us - base) / 1e6, 3)))
    return out


def obsv_phases(t0: float) -> dict:
    """Phases 18 and 19: the observability plane on the card (the engine
    CLI, a traced live cluster behind its exporters, a traced ingress step
    and its critical path), then the soak and its diff gate.  Returns what
    the kernels line reads."""
    import copy
    import shutil
    import tempfile

    from mirbft_tpu_torch import bench as port_bench
    from mirbft_tpu_torch.obsv import critpath, merge
    from mirbft_tpu_torch.ops import ed25519
    from mirbft_tpu_torch.ops.sha256 import sha256_digest_words

    root = Path(tempfile.mkdtemp(prefix="chip-smoke-obsv-"))
    try:
        # -- phase 18a: the instrumented engine run, card against CPU ----------
        runs = {}
        for device in ("cpu", "cuda"):
            trace_dir = root / f"engine-{device}"
            sha256_digest_words.launches = 0
            began = time.perf_counter()
            rc, text = run_obsv_cli(["--nodes", "4", "--trace-dir",
                                     str(trace_dir), "--device", device])
            check(rc == 0, f"obsv --device {device}: exit {rc}")
            runs[device] = (engine_table(text), sha256_digest_words.launches,
                            time.perf_counter() - began, trace_dir)
        (events, sim_ms, table), engine_launches, engine_s, trace_dir = (
            runs["cuda"])
        check(runs["cpu"][0] == runs["cuda"][0],
              f"obsv: the card's run {runs['cuda'][0]} != the CPU's "
              f"{runs['cpu'][0]}")
        check(engine_launches > 0, "obsv: the SHA-256 kernel never launched")
        paths = sorted(trace_dir.glob("node*.trace.json"))
        traces = [json.loads(p.read_text()) for p in paths]
        merged = merge.merge_files(paths, out_path=root / "engine.json")
        lanes = {e["pid"] for e in merged["traceEvents"] if e.get("ph") != "M"}
        flows = committed_flows(traces)
        ledger = critpath.build_ledger(traces)
        check(len(paths) == 4 and lanes == {0, 1, 2, 3},
              f"obsv: merged lanes {lanes} of {len(paths)} traces")
        check(len(ledger) == flows > 0,
              f"obsv: {len(ledger)} ledger rows for {flows} committed flows")
        for line in table.splitlines():
            print(f"  {line}")
        print(f"phase 18a ok: python -m mirbft_tpu_torch.obsv --nodes 4 on "
              f"the card: {events} events, sim {sim_ms} ms, the phase table "
              f"(simulated ms) equal to --device cpu's; {engine_launches} "
              f"SHA-256 launches in {engine_s:.3f} s (the CPU run "
              f"{runs['cpu'][2]:.3f} s); 4 per-node traces merged into "
              f"{len(merged['traceEvents'])} events on lanes {sorted(lanes)};"
              f" ledger {len(ledger)} rows = {flows} committed flows "
              f"(done at {time.perf_counter() - t0:.1f} s)")

        # -- phase 18b: the live rung traced, behind its exporters -------------
        live_dir = root / "live"
        live_dir.mkdir()

        status_s = {}  # each node's /status round trip

        def timed_get(n, address, path):
            began = time.perf_counter()
            answer = http_get(address, path)
            if path == "/status":
                status_s[n] = round(time.perf_counter() - began, 6)
            return answer

        def scrape(addresses):
            got = {n: {path: timed_get(n, address, path)
                       for path in ("/metrics", "/status", "/healthz")}
                   for n, address in sorted(addresses.items())}
            got["dump"] = http_get(addresses[0], "/dump")
            got["missing"] = http_get(addresses[0], "/missing")
            return got

        live = port_bench.live_cluster_rate(
            "cuda-pipelined", device="cuda", trace_dir=str(live_dir),
            on_running=scrape)
        scraped = live["scraped"]
        check(scraped is not None, "live traced: the run ended before the "
              "endpoints were read")
        scraped_launches = {}
        for n in range(port_bench.LIVE.nodes):
            code, text = scraped[n]["/metrics"]
            check(code == 200, f"live node {n}: /metrics {code}")
            scraped_launches[n] = prom_value(
                text, "mirbft_crypto_flush_total", plane="hash", path="device")
            code, text = scraped[n]["/status"]
            check(code == 200 and "epoch_tracker" in text,
                  f"live node {n}: /status {code} {text[:80]!r}")
            code, text = scraped[n]["/healthz"]
            check(code == 200 and json.loads(text) == {
                "ok": True, "ready": True, "node_id": n},
                  f"live node {n}: /healthz {code} {text!r}")
        check(all(v > 0 for v in scraped_launches.values()),
              f"live traced: SHA-256 launches on /metrics {scraped_launches}")
        code, text = scraped["dump"]
        dump_path = json.loads(text).get("path") if code == 200 else None
        check(dump_path is not None and Path(dump_path).exists(),
              f"live node 0: /dump {code} {text!r}")
        check(scraped["missing"][0] == 404,
              f"live node 0: an unknown path gave {scraped['missing'][0]}")
        live_merged = merge.merge_files(live["traces"],
                                        out_path=live_dir / "merged.json")
        live_lanes = {e["pid"] for e in live_merged["traceEvents"]
                      if e.get("ph") != "M"}
        check(live_lanes == set(range(port_bench.LIVE.nodes)),
              f"live traced: merged lanes {live_lanes}")
        rc, text = run_obsv_cli(["--critpath", str(live_dir)])
        check(rc == 0, f"live traced: obsv --critpath exit {rc}")
        live_ledger, n_traces = critpath.ledger_from_dir(str(live_dir))
        live_flows = max(live["committed_seqs"])
        evicted = sum(live["abandoned_flows"])
        check(n_traces == port_bench.LIVE.nodes
              and len(live_ledger) >= live_flows - evicted,
              f"live traced: {len(live_ledger)} ledger rows from {n_traces} "
              f"traces, {live_flows} committed flows, {evicted} evicted")
        live_launches = live["wrapper_launches"]
        check(live_launches == live["launches"] > 0,
              f"live traced: wrappers {live_launches}, processors "
              f"{live['launches']}")
        for line in text.splitlines()[2:-1]:
            print(f"  {line}")
        # The nodes share this host's CLOCK_MONOTONIC, so the exact offsets
        # are 0; the hellos' estimates absorb each hello's latency.
        same_clock = []
        for path in live["traces"]:
            trace = json.loads(Path(path).read_text())
            for event in trace["traceEvents"]:
                if event.get("ph") == "M" and event.get("name") == "clock_sync":
                    event["args"]["offsets_ns"] = {
                        peer: 0 for peer in event["args"]["offsets_ns"]}
            same_clock.append(trace)
        print("  live traced, the same ledger with every offset 0 (one host, "
              "one clock):")
        for line in critpath.attribution_table(critpath.attribute(
                critpath.build_ledger(same_clock))).splitlines():
            print(f"  {line}")
        print(f"  live traced: clock offsets (ns, the hellos' estimates; one "
              f"host) {live['clock_offsets_ns']}; SHA-256 launches on "
              f"/metrics at {port_bench.LIVE_SCRAPE_AFTER_S} s "
              f"{ {n: int(v) for n, v in scraped_launches.items()} }; /dump "
              f"wrote {dump_path}")
        print(f"phase 18b ok: the live rung on cuda-pipelined, traced, "
              f"{live['rate']:.3f} req/s to the "
              f"{port_bench.LIVE.target_commits}th commit, p95 "
              f"{live['p95_ms']:.3f} ms, frames dropped "
              f"{live['frames_dropped']}; /metrics, /status, /healthz on "
              f"every node (/status round trips s {status_s}), /dump once, "
              f"404 past them; 4 traces merged into "
              f"{len(live_merged['traceEvents'])} events; ledger "
              f"{len(live_ledger)} rows >= {live_flows} committed flows - "
              f"{evicted} evicted; {live_launches} SHA-256 launches "
              f"(done at {time.perf_counter() - t0:.1f} s)")

        # -- phase 18c: one traced 50 req/s ingress step, its critical path ----
        ing_dir = root / "ingress"
        ing_dir.mkdir()
        sha256_digest_words.launches = 0
        ed25519.decompress.launches = ed25519.ladder.launches = 0
        ing = port_bench.ingress_run(device="cuda", rates=(50.0,),
                                     trace_dir=str(ing_dir))
        ing_launches = {
            "sha256_digest": sha256_digest_words.launches,
            "ed25519_decompress": ed25519.decompress.launches,
            "ed25519_ladder": ed25519.ladder.launches,
        }
        step = ing["steps"][0]["step"]
        check(step.committed > 0 and step.timed_out == 0,
              f"ingress traced: committed {step.committed}, timed out "
              f"{step.timed_out}")
        check(all(v > 0 for v in ing_launches.values())
              and ing["host_digests"] == 0
              and ing_launches["sha256_digest"] == ing["hash_launches"],
              f"ingress traced: launches {ing_launches}, digests host "
              f"{ing['host_digests']} in {ing['hash_launches']} launches")
        check(all(s["verify_errors"] == 0 and s["dropped_overflow"] == 0
                  for s in ing["ingress"].values()),
              f"ingress traced: {ing['ingress']}")
        rc, text = run_obsv_cli(["--critpath", str(ing_dir)])
        check(rc == 0, f"ingress traced: obsv --critpath exit {rc}")
        ing_ledger, _ = critpath.ledger_from_dir(str(ing_dir))
        attribution = critpath.attribute(ing_ledger)
        check(len(ing_ledger) >= len(step.records) - ing["abandoned_flows"]
              and attribution,
              f"ingress traced: {len(ing_ledger)} ledger rows for "
              f"{len(step.records)} commits, {ing['abandoned_flows']} "
              "evicted")
        for line in critpath.attribution_table(attribution).splitlines():
            print(f"  {line}")
        tail = [b for b in attribution if b["band"] in ("p95-p99", "p99-p100")]
        ing_traces = [json.loads(p.read_text())
                      for p in sorted(ing_dir.glob("trace*.json"))]
        for node, changes in sorted(epoch_changes(ing_traces).items()):
            print(f"  ingress traced, node {node} epoch milestones (name, "
                  f"epoch, s from the first event): {changes}")
        print(f"  ingress traced, the p95 and above: "
              f"{[(b['band'], b['count'], round(b['total_us_mean']), b['dominant_phase'], b['dominant_node']) for b in tail]}; "
              f"the nodes' epochs after it {ing['steps'][0]['epochs']}")
        print(f"phase 18c ok: one 50 req/s step of phase 16's traffic on "
              f"in-process nodes traced: {step.committed} committed, p50 {step.p50_ms:.3f} ms "
              f"p95 {step.p95_ms:.3f} ms; ledger {len(ing_ledger)} rows of "
              f"{len(step.records)} commits joined to the 4 nodes' "
              f"milestones; launches {ing_launches} "
              f"(done at {time.perf_counter() - t0:.1f} s)")

        # -- phase 19: the soak and the diff gate -------------------------------
        sha256_digest_words.launches = 0
        soak = port_bench.soak_run()
        soak_launches = sha256_digest_words.launches
        check(soak["commits"] > 0, "soak: nothing committed")
        check(soak["divergence"] == 0,
              f"soak: {soak['divergence']} divergences")
        check(soak["device_samples"] > 0,
              "soak: the card's allocator series is empty")
        check(soak["failed_ticks"] == 0,
              f"soak: {soak['failed_ticks']} failed sampler ticks, last "
              f"{soak['last_error']}")
        check(sum(soak["frames_dropped"]) == 0,
              f"soak: frames dropped {soak['frames_dropped']}")
        check(soak["host_digests"] == 0
              and soak_launches == soak["launches"] > 0,
              f"soak: launches {soak_launches}, processors "
              f"{soak['launches']}, host digests {soak['host_digests']}")
        for name, verdict in sorted(soak["leak"].items()):
            print(f"  soak {name}: {verdict['verdict']} (confidence "
                  f"{verdict['confidence']:.3f}, {verdict['rel_pct_per_min']:.3f}"
                  f" %/min, r2 {verdict['r2']:.3f}, n {verdict['n']}, "
                  f"first {verdict['first']}, last {verdict['last']})")
        clean = root / "soak.json"
        clean.write_text(json.dumps({"soak": soak}))
        rc_clean, _ = run_obsv_cli(["--diff", str(clean), str(clean)])
        bad = copy.deepcopy(soak)
        first = sorted(bad["leak"])[0]
        bad["leak"][first]["verdict"] = "growing"
        grown = root / "soak-growing.json"
        grown.write_text(json.dumps({"soak": bad}))
        rc_grown, text = run_obsv_cli(["--diff", str(clean), str(grown)])
        check(rc_clean == 0, f"soak: obsv --diff on itself exit {rc_clean}")
        check(rc_grown != 0 and "LEAK" in text,
              f"soak: obsv --diff with {first} growing exit {rc_grown}")
        print(f"phase 19 ok: the soak, {port_bench.SOAK_NODES} nodes on "
              f"cuda-pipelined over loopback TCP with on-disk stores, "
              f"{soak['seconds']} s: {soak['commits']} commits, "
              f"{soak['samples']} samples ({soak['device_samples']} of the "
              f"card's allocator), 0 failed ticks, 0 divergences, 0 frames "
              f"dropped; {soak_launches} SHA-256 launches, "
              f"{soak['device_digests']} digests; obsv --diff exit 0 on "
              f"itself, {rc_grown} with {first} set growing "
              f"(done at {time.perf_counter() - t0:.1f} s)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return dict(engine=engine_launches, live=live_launches,
                ingress=ing_launches, soak=soak_launches)


def chaos_reference():
    """tests/chaos_reference.py: the JAX package's deterministic chaos
    campaign at seed 0, pinned (rows and breaker walks)."""
    tests = str(Path(__file__).resolve().parent / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import chaos_reference

    return chaos_reference


CHAOS_WORDS = 6  # words of a violation the pin keeps
#: The live campaigns' classified failures (ROADMAP queue 3), each as
#: (the violation's words, the counter that must show the cause or None):
#: the rebooted node catches up without a chunk from its corrupting donor
#: (item 9); a censored request commits past ``censor_k`` rotations after a
#: node suspected the first working epoch before its first commit, a wall-
#: clock race the port's hashlib processor loses too (item 17).
LIVE_CLASSIFIED = {
    "transfer-corrupt-stream": (
        "transfer attack touched no frames (vacuous)", None),
    "censor-client-rotation": (
        "censored requests took more than 3 epoch rotations",
        "suspected_before_commit"),
}


def live_classified(result) -> bool:
    """A live failure of the classified kind, with its cause on record."""
    words, cause = LIVE_CLASSIFIED.get(result.name, (None, None))
    return (words is not None and words in result.violation
            and (cause is None or bool(result.counters.get(cause))))


def classified_note(result) -> str:
    """The line phase 20d prints for a classified failure."""
    _words, cause = LIVE_CLASSIFIED[result.name]
    note = f"{result.name}: the classified failure (ROADMAP queue 3)"
    if cause is not None:
        note += f", {cause} {result.counters.get(cause)}"
    return note
SIGNED_SCENARIOS = ("corrupt-propose-signed", "signed-verifier-dies")


def chaos_launches() -> dict:
    """``ops.kernel_launches()`` under the kernels line's names."""
    from mirbft_tpu_torch.ops import kernel_launches

    got = kernel_launches()
    return {"sha256_digest": got["launches_sha256"],
            "ed25519_decompress": got["launches_ed25519_decompress"],
            "ed25519_ladder": got["launches_ed25519_ladder"],
            "bls_aggregate": got["launches_bls_g1"]}


def chaos_row(result) -> tuple:
    return (result.passed, result.events, result.sim_ms, result.commits,
            " ".join(result.violation.split()[:CHAOS_WORDS]))


def chaos_table(title: str, results, wall_s: float, live: bool) -> None:
    print(f"  {title} ({wall_s:.3f} s): scenario, verdict, events, "
          f"{'wall ms' if live else 'sim ms'}, commits, launches sha256 / "
          "decompress / ladder / bls")
    for r in results:
        c = r.counters
        print(f"    {r.name:<30} {'ok  ' if r.passed else 'FAIL'} "
              f"{r.events:>6} {r.sim_ms:>7} {r.commits:>5}  "
              f"{c['launches_sha256']} / {c['launches_ed25519_decompress']} / "
              f"{c['launches_ed25519_ladder']} / {c['launches_bls_g1']}"
              + (f" per node {c['digest_launches']}" if live else "")
              + (f" [{r.violation[:90]}]" if r.violation else ""))


def chaos_phases(t0: float) -> dict:
    """Phases 20-21: the chaos campaign on the card, and the live flood
    A/B.  Returns each kernel's launches in each phase."""
    import dataclasses

    from mirbft_tpu_torch import bench as port_bench
    from mirbft_tpu_torch.chaos import (
        adversary_matrix,
        live_adversary_matrix,
        live_matrix,
        live_smoke_matrix,
        matrix,
        run_campaign,
        run_live_campaign,
        run_scenario,
    )
    from mirbft_tpu_torch.ops import zero_kernel_launches
    from mirbft_tpu_torch.chaos.scenarios import SLOW_TIMEOUT_S, _flaky_plane
    from mirbft_tpu_torch.testengine.crypto_plane import DevicePlaneError

    pin = chaos_reference()

    # -- phase 20a-b: the deterministic matrices, pinned, on the kernels ------
    zero_kernel_launches()
    det = {}
    for label, scenarios, rows in (
        ("matrix", matrix(), pin.MATRIX),
        ("adversary_matrix", adversary_matrix(), pin.ADVERSARY),
    ):
        start = time.perf_counter()
        campaign = run_campaign(scenarios, seed=0, device="cuda")
        wall = time.perf_counter() - start
        chaos_table(f"phase 20a {label}() at seed 0 on the card",
                    campaign.results, wall, live=False)
        got = {r.name: chaos_row(r) for r in campaign.results}
        want = {name: pin.LATE_DIGEST.get(name, row)
                for name, row in rows.items()}
        check(got == want, f"chaos {label}: rows differ from the pin: "
              f"{ {n: (got.get(n), w) for n, w in want.items() if got.get(n) != w} }")
        for r in campaign.results:
            c = r.counters
            # The fallback counters are 0 by construction (the planes have
            # no host route); the gate holds the port to it.
            check(c["host_digests"] == 0
                  and c.get("fallback_digests", 0) == 0
                  and c.get("sig_fallbacks", 0) == 0,
                  f"chaos {r.name}: host digests {c['host_digests']}, "
                  f"fallbacks {c.get('fallback_digests')} "
                  f"{c.get('sig_fallbacks')}")
            # A short read is a real launch the plane does not keep.
            check(c["launches_sha256"] >= c["digest_launches"] > 0,
                  f"chaos {r.name}: SHA-256 launches {c['launches_sha256']}"
                  f", plane {c['digest_launches']}")
            if r.name in SIGNED_SCENARIOS:
                check(c["launches_ed25519_ladder"] > 0
                      and c["launches_ed25519_decompress"] > 0,
                      f"chaos {r.name}: no Ed25519 launch")
            if r.name == "forged-aggregate-cert":
                check(c["launches_bls_g1"] > 0,
                      f"chaos {r.name}: no BLS launch")
            if r.name in pin.BREAKER:
                prefix = "sig_" if r.name == "signed-verifier-dies" else ""
                walk = {"trips": c[f"{prefix}breaker_trips"],
                        "probes": c[f"{prefix}breaker_probes"],
                        "state": c[f"{prefix}breaker"],
                        "errors": c[f"{prefix}device_errors"],
                        "timeouts": c.get(f"{prefix}device_timeouts", 0)}
                check(walk == pin.BREAKER[r.name],
                      f"chaos {r.name}: breaker walk {walk}, pinned "
                      f"{pin.BREAKER[r.name]}")
                retries = c[f"{prefix}device_retries"]
                if r.name in ("device-digest-dies",
                              "device-digest-short-read",
                              "signed-verifier-dies"):
                    check(retries > 0, f"chaos {r.name}: no retry")
                print(f"  phase 20b {r.name}: breaker {walk}, "
                      f"{retries} rows re-launched on the kernel, 0 host")
        det[label] = len(campaign.results)
    det_launches = chaos_launches()
    print(f"phase 20a-b ok: {det['matrix']} + {det['adversary_matrix']} "
          f"scenarios equal the JAX campaign's pinned rows (the two "
          f"reference failures included), the device faults ridden out on "
          f"the kernels with the pinned breaker walks (hang deadline "
          f"{SLOW_TIMEOUT_S} s); launches {det_launches} "
          f"(done at {time.perf_counter() - t0:.1f} s)")

    # -- phase 20c: a persistent fault raises ---------------------------------
    dead = dataclasses.replace(
        {s.name: s for s in matrix()}["device-digest-dies"],
        name="device-digest-dead",
        hash_plane=_flaky_plane("die", fail_from=1, fail_until=10 ** 9))
    try:
        run_scenario(dead, seed=11, device="cuda")
    except DevicePlaneError as err:
        raised = str(err)
    else:
        raised = None
    check(raised is not None and "attempts failed" in raised,
          f"chaos: a persistent fault did not raise ({raised})")
    print(f"phase 20c ok: a device that stays dead raises DevicePlaneError: "
          f"{raised}")

    # -- phase 20d: the live campaigns on cuda replicas -----------------------
    zero_kernel_launches()
    live_runs = {}
    for label, scenarios, processor in (
        ("live_matrix", live_matrix(), "cuda"),
        ("live_adversary_matrix", live_adversary_matrix(), "cuda"),
        ("live_smoke_matrix", live_smoke_matrix(), "cuda-pipelined"),
    ):
        start = time.perf_counter()
        campaign = run_live_campaign(scenarios, seed=0, processor=processor,
                                     device="cuda")
        wall = time.perf_counter() - start
        chaos_table(f"phase 20d {label}() at seed 0 on {processor}",
                    campaign.results, wall, live=True)
        for r in campaign.results:
            c = r.counters
            check(r.passed or live_classified(r),
                  f"live {r.name} on {processor}: {r.violation}")
            if not r.passed:
                print(f"    {classified_note(r)}")
            check(all(n > 0 for n in c["digest_launches"])
                  and c["launches_sha256"] > 0,
                  f"live {r.name}: SHA-256 launches per node "
                  f"{c['digest_launches']}, wrapper {c['launches_sha256']}")
            if r.name in SIGNED_SCENARIOS:
                check(c["launches_ed25519_ladder"] > 0
                      and c["launches_ed25519_decompress"] > 0,
                      f"live {r.name}: no Ed25519 launch")
            if r.name == "forged-aggregate-cert":
                check(c["launches_bls_g1"] > 0,
                      f"live {r.name}: no BLS launch")
        live_runs[label] = (sum(r.passed for r in campaign.results),
                            len(campaign.results), wall)
    live_launches = chaos_launches()
    print(f"phase 20d ok: live campaigns passed {live_runs} (passed, run, "
          f"wall s); every failure the classified one; no fork, no request "
          f"committed twice; launches {live_launches} "
          f"(done at {time.perf_counter() - t0:.1f} s)")

    # -- phase 21: the live flood A/B -----------------------------------------
    attack = port_bench.live_attack_run("cuda")
    flood_launches = (attack["clean"]["wrapper_launches"]
                      + attack["flood"]["wrapper_launches"])
    check(attack["flooded"] > 0 and attack["clean_flooded"] == 0,
          f"flood: flooded {attack['flooded']}, clean "
          f"{attack['clean_flooded']}")
    for half in ("clean", "flood"):
        run = attack[half]
        check(run["host_digests"] == 0
              and run["device_digests"] == run["hash_requests"],
              f"flood {half}: {run['device_digests']} digests launched for "
              f"{run['hash_requests']} requests, {run['host_digests']} host")
    print(f"phase 21 ok: the live flood A/B on cuda (x{attack['copies']} "
          f"copies): clean {attack['clean_rate']:.3f} req/s p95 "
          f"{attack['clean_p95_ms']:.3f} ms; flooded "
          f"{attack['flood_rate']:.3f} req/s p95 "
          f"{attack['flood_p95_ms']:.3f} ms, {attack['flooded']} flooded "
          f"submissions; commits {attack['clean']['commits']} / "
          f"{attack['flood']['commits']}, 0 duplicates, one chain prefix, "
          f"0 host digests; {flood_launches} SHA-256 launches "
          f"(done at {time.perf_counter() - t0:.1f} s)")
    return dict(det=det_launches, live=live_launches, flood=flood_launches)


CLUSTER_PROCESSOR = "cuda-pipelined"
CLUSTER_REQS = 40  # 22a: requests a stage, each submitted to every node
CLUSTER_COMMIT_S = 90.0  # 22a: a stage's commits on every live node
CLUSTER_CHAOS_S = 600  # 22d: the chaos CLI's three scenarios
# Phase 22d's CLI, once started (start_cluster_chaos).
_CLUSTER_CHAOS: dict = {}


def start_cluster_chaos() -> dict:
    """Start phase 22d, ``python -m mirbft_tpu_torch.chaos --live --cluster
    mp --smoke``, in the background, in a temp dir of its own.  The whole
    script starts it beside phase 15, whose rung keeps one core busy for
    80-120 s while the CLI mostly waits on its workers' boots;
    ``cluster_phases`` collects and checks it."""
    import os
    import tempfile

    scratch = tempfile.TemporaryDirectory()
    handle = start_module(
        ["mirbft_tpu_torch.chaos", "--live", "--cluster", "mp", "--smoke",
         "--processor", CLUSTER_PROCESSOR, "--json"],
        dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent)),
        cwd=scratch.name,
    )
    handle["scratch"] = scratch
    return handle
CLUSTER_KERNELS = ("launches_sha256", "launches_ed25519_decompress",
                   "launches_ed25519_ladder")


def check_workers(label: str, evidence: dict, exit_codes: dict,
                  signed: bool = False, nodes=None) -> dict:
    """Every worker of a multi-process phase exited cleanly (0, or -9
    where it was SIGKILLed and restarted), wrote no fault to its log, ran
    the cuda-pipelined processor, made every digest on the card (device
    hash flushes > 0, 0 host digests) and, when ``signed``, verified its
    ingress on the Ed25519 kernels with no failed launch.  ``nodes``
    limits the device checks (a joiner may install a snapshot and hash
    nothing).  Returns the wrappers' launches summed over the workers."""
    for node, codes in sorted(exit_codes.items()):
        check(codes and codes[-1] == 0 and all(c in (0, -9) for c in codes),
              f"{label}: node {node} exit codes {codes}, worker.log: "
              f"{evidence.get(node, {}).get('log_faults', [])[:3]}")
    totals = dict.fromkeys(CLUSTER_KERNELS, 0)
    for node, e in sorted(evidence.items()):
        check(not e["log_faults"],
              f"{label}: node {node} worker.log: {e['log_faults'][:3]}")
        check(e["host_digests"] == 0,
              f"{label}: node {node} made {e['host_digests']} host digests")
        check(e["processors"] == [CLUSTER_PROCESSOR],
              f"{label}: node {node} ran {e['processors']}")
        for key in CLUSTER_KERNELS:
            totals[key] += e[key]
        if nodes is not None and node not in nodes:
            continue
        flushes = e.get("flushes", {})
        check(flushes.get("hash/device", 0) > 0 and e["launches"] > 0
              and e["launches_sha256"] >= e["launches"],
              f"{label}: node {node} hash flushes {flushes}, launches "
              f"{e['launches']}, wrapper {e['launches_sha256']}")
        if signed:
            check(flushes.get("signature/ingress", 0) > 0
                  and e.get("ingress_verify_errors", 0) == 0
                  and e["launches_ed25519_decompress"] > 0
                  and e["launches_ed25519_ladder"] > 0,
                  f"{label}: node {node} ingress flushes {flushes}, verify "
                  f"errors {e.get('ingress_verify_errors')}, Ed25519 "
                  f"launches {e['launches_ed25519_decompress']} / "
                  f"{e['launches_ed25519_ladder']}")
    return totals


def describe_steps(steps) -> str:
    return "; ".join(
        f"{s.name}: {s.submitted} submitted, {s.committed} committed, "
        f"{s.timed_out} timed out, goodput {s.goodput_per_sec:.3f} req/s, "
        f"p50 {s.p50_ms:.3f} ms, p95 {s.p95_ms:.3f} ms"
        for s in steps
    )


def cluster_phases(t0: float) -> dict:
    """Phase 22: the multi-process cluster, one worker process a node on
    the card (``mirbft_tpu_torch.cluster``).  Returns the kernels'
    launches, summed over every worker of the phase."""
    import os
    import tempfile

    from mirbft_tpu_torch import bench as port_bench
    from mirbft_tpu_torch import pb
    from mirbft_tpu_torch.cluster import ClusterSupervisor
    from mirbft_tpu_torch.cluster.worker import read_json

    launches = dict.fromkeys(CLUSTER_KERNELS, 0)
    phase_start = time.perf_counter()

    def add(counts):
        for key in CLUSTER_KERNELS:
            launches[key] += counts.get(key, 0)

    # -- phase 22a: lifecycle: boot, commit, SIGKILL, restart, teardown ------
    start = time.perf_counter()
    sup = ClusterSupervisor(node_count=4, client_ids=[1],
                            processor=CLUSTER_PROCESSOR, device="cuda")

    def submit_all(req_nos):
        for q in req_nos:
            request = pb.Request(client_id=1, req_no=q, data=b"mp-%d" % q)
            for node in sup.alive_nodes():
                sup.submit(node, request)

    def await_commits(req_nos, nodes, what):
        want = {(1, q) for q in req_nos}
        deadline = time.monotonic() + CLUSTER_COMMIT_S
        while time.monotonic() < deadline:
            if all(want <= {(c, q) for c, q, _s in sup.committed(n)}
                   for n in nodes):
                return
            time.sleep(0.05)
        check(False, f"22a: {what}: commits "
              f"{[len(sup.committed(n)) for n in nodes]} after "
              f"{CLUSTER_COMMIT_S} s")

    def one_chain(what):
        deadline = time.monotonic() + CLUSTER_COMMIT_S
        while time.monotonic() < deadline:
            chains = sup.chains()
            if len(set(chains)) == 1 and "" not in chains:
                return chains
            time.sleep(0.05)
        check(False, f"22a: {what}: chains {[c[:12] for c in chains]}")

    try:
        sup.start()
        boot = [h.boot_seconds[0] for h in sup.nodes]
        submit_all(range(CLUSTER_REQS))
        await_commits(range(CLUSTER_REQS), range(4), "the first stage")
        # The exporter of every worker, mid-run: /status answered, the
        # kernel's flushes on /metrics.
        for handle in sup.nodes:
            address = ("127.0.0.1", handle.metrics_port)
            status, _body = http_get(address, "/status")
            check(status == 200, f"22a: node {handle.node_id} /status "
                  f"gave {status}")
            _code, text = http_get(address, "/metrics")
            flushes = prom_value(text, "mirbft_crypto_flush_total",
                                 plane="hash", path="device")
            check(flushes > 0, f"22a: node {handle.node_id} /metrics shows "
                  f"{flushes} device hash flushes")
        sup.kill(3, graceful=False)
        check(sup.alive_nodes() == [0, 1, 2], "22a: node 3 did not die")
        stage2 = range(CLUSTER_REQS, 2 * CLUSTER_REQS)
        submit_all(stage2)
        await_commits(stage2, range(3), "the second stage, node 3 down")
        restart_at = time.perf_counter()
        sup.restart(3)
        restart_s = time.perf_counter() - restart_at
        # Node 3 catches up from its WAL and its peers, by a snapshot when
        # the others have moved past its window; then it commits new
        # requests with them.
        one_chain("node 3's catch-up")
        caught_up_s = time.perf_counter() - restart_at
        transfer = read_json(os.path.join(sup.nodes[3].dir, "transfer.json"))
        stage3 = range(2 * CLUSTER_REQS, 2 * CLUSTER_REQS + 8)
        submit_all(stage3)
        await_commits(stage3, range(4), "after node 3's catch-up")
        chains = one_chain("the end")
        per_node = [sup.committed(n) for n in range(4)]
    finally:
        sup.teardown()
    for n, commits in enumerate(per_node):
        pairs = [(c, q) for c, q, _s in commits]
        check(len(pairs) == len(set(pairs)),
              f"22a: node {n} committed a request twice")
    codes = sup.exit_codes()
    check(codes[3] == [-9, 0], f"22a: node 3 exit codes {codes[3]}")
    counts = check_workers("22a", sup.evidence, codes)
    add(counts)
    print(f"phase 22a ok: 4 workers on {CLUSTER_PROCESSOR}, boot "
          f"{[round(b, 3) for b in boot]} s, {CLUSTER_REQS} requests "
          f"committed on every node, node 3 SIGKILLed, {CLUSTER_REQS} more "
          f"on the other three, node 3 back from disk on port "
          f"{sup.nodes[3].transport_port} in {restart_s:.3f} s (boot "
          f"{sup.nodes[3].boot_seconds[-1]:.3f} s), on the others' chain "
          f"{caught_up_s:.3f} s after its restart (snapshots installed "
          f"{(transfer or {}).get('counters', {}).get('snapshots_installed')}"
          f"), 8 more on all four, one "
          f"chain {chains[0][:16]}..., commits {[len(c) for c in per_node]}, "
          f"exit codes {codes}; per worker device hash flushes "
          f"{[e['flushes'].get('hash/device') for e in sup.evidence.values()]}"
          f", launches {[e['launches'] for e in sup.evidence.values()]}, 0 "
          f"host digests; wrapper launches {counts} "
          f"({time.perf_counter() - start:.1f} s, done at "
          f"{time.perf_counter() - t0:.1f} s)")

    def gate_mp(label, out):
        check(len(set(out["chains"])) == 1 and "" not in out["chains"],
              f"{label}: chains {out['chains']}")
        check(not out["duplicates"],
              f"{label}: committed twice: {out['duplicates'][:5]}")
        check(not out["missing"],
              f"{label}: never committed: {out['missing'][:5]}")
        counts = check_workers(label, out["evidence"], out["exit_codes"])
        add(counts)
        return counts

    # -- phase 22b: the JAX live_mp_run configuration on workers --------------
    start = time.perf_counter()
    out = port_bench.live_mp_run(CLUSTER_PROCESSOR, device="cuda")
    counts = gate_mp("22b", out)
    print(f"phase 22b ok: live_mp_run on {port_bench.LIVE_MP_NODES} workers, "
          f"BatchSize {port_bench.LIVE_MP_BATCH_SIZE}: "
          f"{describe_steps(out['steps'])}; boot {out['boot_seconds']} s; "
          f"one chain, commits {out['commits']}, none twice, none missing; "
          f"device hash flushes "
          f"{[e['flushes'].get('hash/device') for e in out['evidence'].values()]}"
          f", 0 host digests; wrapper launches {counts} "
          f"({time.perf_counter() - start:.1f} s, done at "
          f"{time.perf_counter() - t0:.1f} s)")

    # -- phase 22d: the chaos CLI on worker processes --------------------------
    # Started beside phase 15 when the whole script runs (start_cluster_chaos).
    start = time.perf_counter()
    chaos_run = _CLUSTER_CHAOS.pop("run", None) or start_cluster_chaos()
    started = chaos_run["start"] - t0
    rc, stdout, stderr = finish_module(chaos_run, CLUSTER_CHAOS_S)
    chaos_run["scratch"].cleanup()
    check(rc == 0,
          f"22d: chaos --cluster mp exited {rc}:\n"
          f"{stdout[-3000:]}\n{stderr[-3000:]}")
    campaign = json.loads(stdout)
    names = []
    for r in campaign["scenarios"]:
        c = r["counters"]
        names.append(r["name"])
        check(r["passed"] and c["host_digests"] == 0 and not c["log_faults"]
              and all(n > 0 for n in c["hash_flushes"])
              and c["launches_sha256"] > 0,
              f"22d: {r['name']}: {r['violation']} {c}")
        for node, codes in enumerate(c["exit_codes"]):
            check(codes and codes[-1] == 0
                  and all(code in (0, -9) for code in codes)
                  and not c["worker_faults"],
                  f"22d: {r['name']}: node {node} exit codes {codes}, "
                  f"worker faults {c['worker_faults']}")
        launches["launches_sha256"] += c["launches_sha256"]
        print(f"  22d {r['name']}: passed, wall {r['sim_ms']} ms, commits "
              f"{r['commits']}, recovery {c.get('recovery_ms')} ms, exit "
              f"codes {c['exit_codes']}, device hash flushes "
              f"{c['hash_flushes']}, wrapper launches {c['launches_sha256']}")
    check(sorted(names) == ["crash-restart", "partition-minority",
                            "retry-storm-dedup"], f"22d: ran {names}")
    print(f"phase 22d ok: python -m mirbft_tpu_torch.chaos --live --cluster "
          f"mp --smoke --processor {CLUSTER_PROCESSOR} exited 0 (started at "
          f"{started:.1f} s, waited "
          f"{time.perf_counter() - start:.1f} s for it here, done at "
          f"{time.perf_counter() - t0:.1f} s)")

    # -- phase 22e: the reconfiguration A/B -----------------------------------
    start = time.perf_counter()
    out = port_bench.reconfig_run(device="cuda", processor=CLUSTER_PROCESSOR)
    ev = out["evidence"]
    check(ev["adoptions"] > 0 and ev["joined"]
          and ev["snapshots_installed"] >= 1,
          f"22e: adoptions {ev['adoptions']}, joined {ev['joined']}, "
          f"snapshots installed {ev['snapshots_installed']}")
    check(not out["duplicates"], f"22e: committed twice: "
          f"{out['duplicates'][:5]}")
    counts = check_workers("22e", out["kernels"], out["exit_codes"],
                           nodes=range(4))
    add(counts)
    print(f"phase 22e ok: reconfig_run: {describe_steps(out['steps'])}; "
          f"adoptions {ev['adoptions']}, node 4 joined and installed "
          f"{ev['snapshots_installed']} snapshot(s); chains "
          f"{[c[:12] for c in out['chains']]}, commits {out['commits']}; "
          f"boot {out['boot_seconds']} s; exit codes {out['exit_codes']}; "
          f"wrapper launches {counts} ({time.perf_counter() - start:.1f} s, "
          f"done at {time.perf_counter() - t0:.1f} s)")
    launches["wall_s"] = time.perf_counter() - phase_start
    print(f"phase 22 ok: 22a, 22b, 22d, 22e in {launches['wall_s']:.3f} s "
          f"(done at {time.perf_counter() - t0:.1f} s)")
    return launches


PARALLEL_SHARDS = 4  # phase 23's mesh: [cuda:0] * 4
PARALLEL_TALLY_SHAPES = ((8, 16), (128, 4096), (256, 65536))
# shard_sum at the main path's sums (the sweep's 3 totals, the dryrun's 16
# seqs, the anchor's 2048-row step outputs) and at the tally's widths.
PARALLEL_SUM_WIDTHS = (3, 16, 2048, 4096, 65536)
PARALLEL_SUM_THRESHOLD = 1 << 20
PARALLEL_DIGEST_ROWS = 8192  # sharded_sha256: request digests, (8192, 1)
PARALLEL_VERIFY_ROWS = 64  # sharded_ed25519_verify: half corrupted


def parallel_phases(t0: float, anchor_chains: dict) -> dict:
    """Phase 23: the sharded plane on meshes that name the card several
    times.  Returns, for ``tally_columns`` and ``shard_sum``, the head
    shape's numbers and every shape's, and the launches of the main path's
    run."""
    import numpy as np
    import torch

    from mirbft_tpu_torch import bench as port_bench
    from mirbft_tpu_torch import entry as port_entry
    from mirbft_tpu_torch.crypto import ed25519_host
    from mirbft_tpu_torch.ops import ack_plane, tally
    from mirbft_tpu_torch.ops import ed25519 as ed_ops
    from mirbft_tpu_torch.ops.batching import pack_preimages, to_tensors
    from mirbft_tpu_torch.ops.sha256 import (
        sha256_digest_words,
        sha256_digest_words_plain,
    )
    from mirbft_tpu_torch.parallel import sharding
    from mirbft_tpu_torch.testengine.crypto_plane import AsyncKernelHashPlane

    start = time.perf_counter()
    card = torch.device("cuda", 0)
    mesh = sharding.make_mesh(devices=[card] * PARALLEL_SHARDS)
    counted = {
        "tally_columns": tally.tally_columns,
        "shard_sum": tally.shard_sum,
        "ack_step": ack_plane.ack_step,
        "ack_sweep": ack_plane.quorum_sweep,
        "sha256_digest": sha256_digest_words,
        "ed25519_decompress": ed_ops.decompress,
        "ed25519_ladder": ed_ops.ladder,
        "ed25519_ladder_extended": ed_ops.ladder_extended,
    }

    def zero():
        for fn in counted.values():
            fn.launches = 0

    def read():
        return {name: fn.launches for name, fn in counted.items()}

    # -- 23c-d: the main path, counts from 0 just before, read just after ------
    zero()
    plane = AsyncKernelHashPlane()
    result = port_bench.ladder_run(
        plane, reqs_per_client=ANCHOR_REQS, ready_latency=None,
        ack_plane="device", ack_device=mesh)
    anchor = read()
    wall, events, _chain, _sim = result
    chains, counts = result.chains, result.counts
    check(events == 2320, f"phase 23c: the 4-shard anchor gave {events} "
          "events")
    check(chains == anchor_chains,
          "phase 23c: app chains differ from phase 3's")
    check(all(count == CLIENTS * ANCHOR_REQS for count in counts),
          "phase 23c: not every node committed 1600 requests")
    check(plane.host_digests == 0, "phase 23c: a digest came from the host")
    # A flush: a step a shard, one shard_sum; a sweep likewise.
    flushes = anchor["ack_step"] // PARALLEL_SHARDS
    sweeps = anchor["ack_sweep"] // PARALLEL_SHARDS
    check(flushes > 0 and anchor["ack_step"] == PARALLEL_SHARDS * flushes
          and anchor["ack_sweep"] == PARALLEL_SHARDS * sweeps
          and anchor["shard_sum"] == flushes + sweeps,
          f"phase 23c: launches {anchor}")
    print(f"phase 23c ok: device-plane anchor {NODES}x{CLIENTS}x"
          f"{ANCHOR_REQS}, every node's ack plane on {PARALLEL_SHARDS} "
          f"client blocks of [cuda:0] * {PARALLEL_SHARDS} -> {events} events "
          f"in {wall:.3f} s, phase 3's chain; launches {anchor}")
    forward, args = port_entry.entry()
    words = forward(*args)
    check(torch.equal(words, sha256_digest_words_plain(*args)),
          "phase 23d: entry()'s digests differ from the plain version's")
    dry = port_entry.dryrun_multichip(
        PARALLEL_SHARDS, devices=[card] * PARALLEL_SHARDS)
    main_launches = read()
    for name in ("tally_columns", "shard_sum", "ack_step", "sha256_digest"):
        check(main_launches[name] > 0,
              f"phase 23: {name} was not launched on the main path")
    print(f"phase 23d ok: entry() {tuple(args[0].shape)} -> "
          f"{tuple(words.shape)} == plain; dryrun_multichip on "
          f"{dry['devices']}: digests == hashlib, mask {dry['mask']}; "
          f"main-path launches {main_launches}")

    # -- 23a: the two kernels against their plain versions, and timed ----------
    rng = np.random.default_rng(SEED)
    tally_shapes = []
    for rows, cols in PARALLEL_TALLY_SHAPES:
        votes = torch.from_numpy(
            rng.integers(-128, 128, (rows, cols), dtype=np.int8)).to(card)
        check(torch.equal(tally.tally_columns(votes),
                          tally.tally_columns_plain(votes)),
              f"phase 23a: tally_columns != plain at {(rows, cols)}")
        nbytes = tally.tally_bytes(votes)
        tally_shapes.append({
            "shape": [rows, cols],
            "ms": time_events(lambda v=votes: [v], tally.tally_columns),
            "plain_ms": time_wall(lambda v=votes: [v],
                                  tally.tally_columns_plain),
            "library_ms": time_events(
                lambda v=votes: [v], lambda v: v.sum(0, dtype=torch.int32)),
            "launch_floor_ms": time_events(
                lambda: [], lambda c=cols: tally.empty_tally(c)),
            "bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        })
    sum_shapes = []
    for n in PARALLEL_SUM_WIDTHS:
        parts = torch.from_numpy(rng.integers(
            -(1 << 31), 1 << 31, (PARALLEL_SHARDS, n)).astype(np.int32)
        ).to(card)
        for threshold in (None, PARALLEL_SUM_THRESHOLD):
            check(torch.equal(tally.shard_sum(parts, threshold),
                              tally.shard_sum_plain(parts, threshold)),
                  f"phase 23a: shard_sum != plain at {(PARALLEL_SHARDS, n)}"
                  f", threshold {threshold}")
        nbytes = tally.shard_sum_bytes(parts)
        sum_shapes.append({
            "shape": [PARALLEL_SHARDS, n],
            "ms": time_events(lambda p=parts: [p], tally.shard_sum),
            "mask_ms": time_events(lambda p=parts: [p], lambda p: (
                tally.shard_sum(p, PARALLEL_SUM_THRESHOLD))),
            "plain_ms": time_wall(lambda p=parts: [p], tally.shard_sum_plain),
            "library_ms": time_events(
                lambda p=parts: [p], lambda p: p.sum(0, dtype=torch.int32)),
            "launch_floor_ms": time_events(
                lambda: [], lambda n=n: tally.empty_shard_sum(n)),
            "bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        })
    for label, shapes in (("tally_columns", tally_shapes),
                          ("shard_sum", sum_shapes)):
        for e in shapes:
            print(f"  {label} {tuple(e['shape'])}: kernel {e['ms']:.6f} ms "
                  f"(CUDA events, median of 20, one launch), launch floor "
                  f"{e['launch_floor_ms']:.6f} ms, bound {e['bound_ms']:.6f} "
                  f"ms ({e['bytes']} bytes / 3.35 TB/s), "
                  f"{100 * e['bound_ms'] / e['ms']:.2f}% of bound; library "
                  f"{e['library_ms']:.6f} ms (.sum(0, dtype=torch.int32)); "
                  f"plain {e['plain_ms']:.6f} ms (wall)"
                  + (f"; with a threshold {e['mask_ms']:.6f} ms"
                     if "mask_ms" in e else ""))
    print(f"phase 23a ok: tally_columns == plain at "
          f"{list(PARALLEL_TALLY_SHAPES)} int8, shard_sum == plain with and "
          f"without a threshold at {PARALLEL_SHARDS} x "
          f"{list(PARALLEL_SUM_WIDTHS)}, max_abs_err 0")

    # -- 23b: the sharded functions against the unsharded kernels --------------
    messages = [rng.bytes(int(n)) for n in rng.integers(
        0, 56, PARALLEL_DIGEST_ROWS)]
    packed = pack_preimages(messages, batch_floor=PARALLEL_SHARDS)
    votes = rng.integers(0, 2, (256, 65536)).astype(np.int8)
    threshold = 171  # a 2f + 1 of 256 voters
    triples = []
    for i in range(PARALLEL_VERIFY_ROWS):
        seed = i.to_bytes(32, "little")
        msg = b"phase-23-%d" % i
        pk, sig = ed25519_host.public_key(seed), ed25519_host.sign(seed, msg)
        triples.append((pk, msg + (b"!" if i % 2 else b""), sig))
    oracle = [ed25519_host.verify(*t) for t in triples]
    check(oracle == [i % 2 == 0 for i in range(PARALLEL_VERIFY_ROWS)],
          "phase 23b: the oracle's verdicts")
    # The JAX function's inputs: rows decompressed on the host, packed to
    # a multiple of the mesh size.
    rows = [ed_ops.marshal_signature(*t) for t in triples]
    verify_args = ed_ops.pack_signature_rows(rows, batch_floor=PARALLEL_SHARDS)
    want_words = sha256_digest_words(*to_tensors(packed, card))
    want_mask = (torch.from_numpy(votes).to(card).sum(0, dtype=torch.int32)
                 >= threshold)
    want_verdicts = ed_ops.launch_signature_rows(rows, card)
    check((want_verdicts != 0).tolist() == oracle,
          "phase 23b: the unsharded verdicts")
    unsharded = {
        "sharded_sha256": lambda: sha256_digest_words(
            *to_tensors(packed, card)),
        "sharded_quorum_tally": lambda: tally.shard_sum(
            tally.tally_columns(torch.from_numpy(votes).to(card))
            .unsqueeze(0), threshold),
        "sharded_ed25519_verify": lambda: ed_ops.launch_signature_rows(
            rows, card),
    }
    sharded = []
    x4_launches = 0  # the extended ladder's, on X4's path
    for shards in (1, PARALLEL_SHARDS):
        m = sharding.make_mesh(devices=[card] * shards)
        calls = {
            "sharded_sha256": (lambda f=sharding.sharded_sha256(m): f(
                packed.blocks, packed.n_blocks)),
            "sharded_quorum_tally": (
                lambda f=sharding.sharded_quorum_tally(m): f(votes,
                                                             threshold)),
            "sharded_ed25519_verify": (
                lambda f=sharding.sharded_ed25519_verify(m): f(
                    *verify_args)),
        }
        wants = {"sharded_sha256": want_words,
                 "sharded_quorum_tally": want_mask,
                 "sharded_ed25519_verify": want_verdicts}
        launches = {
            "sharded_sha256": {"sha256_digest": shards},
            "sharded_quorum_tally": {"tally_columns": shards,
                                     "shard_sum": 1},
            "sharded_ed25519_verify": {"ed25519_ladder_extended": shards},
        }
        for name, call in calls.items():
            if name == "sharded_ed25519_verify":
                ed_ops.ladder_extended.launches = 0  # X4's path from 0
            before = read()
            got = call()
            torch.cuda.synchronize()
            after = read()
            if name == "sharded_ed25519_verify":
                x4_launches += ed_ops.ladder_extended.launches
            made = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
            check(made == launches[name],
                  f"phase 23b: {name} on {shards} shards launched {made}")
            check(torch.equal(got, wants[name]),
                  f"phase 23b: {name} on {shards} shards != the unsharded "
                  "kernels")
            sharded.append({
                "what": name, "shards": shards,
                "ms": time_events(lambda: [], call, reps=10),
                "wall_ms": time_wall(lambda: [], call),
                "unsharded_ms": time_events(lambda: [], unsharded[name],
                                            reps=10),
                "unsharded_wall_ms": time_wall(lambda: [], unsharded[name]),
                "launches": made,
            })
    check(x4_launches == 1 + PARALLEL_SHARDS,
          f"phase 23b: the extended ladder launched {x4_launches} times on "
          f"X4's path, not {1 + PARALLEL_SHARDS}")
    for e in sharded:
        print(f"  {e['what']} on [cuda:0] * {e['shards']}: "
              f"{e['ms']:.6f} ms (CUDA events around the call, median of "
              f"10), {e['wall_ms']:.6f} ms wall; unsharded "
              f"{e['unsharded_ms']:.6f} ms, {e['unsharded_wall_ms']:.6f} "
              f"ms wall; launches {e['launches']}")
    phase_s = time.perf_counter() - start
    print(f"phase 23b ok: sharded_sha256 ({PARALLEL_DIGEST_ROWS} rows), "
          f"sharded_quorum_tally (256 x 65536), sharded_ed25519_verify "
          f"({PARALLEL_VERIFY_ROWS} host-decompressed rows through the "
          f"extended ladder, the valid half accepted, the corrupted half "
          f"rejected, as the oracle) on [cuda:0] and [cuda:0] * "
          f"{PARALLEL_SHARDS} == the unsharded kernels; the extended "
          f"ladder launched {x4_launches} times on X4's path")
    print(f"phase 23 ok in {phase_s:.1f} s (done at "
          f"{time.perf_counter() - t0:.1f} s)")
    return {
        "tally_columns": {"head": tally_shapes[-1], "shapes": tally_shapes},
        "shard_sum": {"head": sum_shapes[2], "shapes": sum_shapes},
        "launches": main_launches,
        "anchor_launches": anchor,
        "sharded": sharded,
        "x4_extended_launches": x4_launches,
    }


BENCH_ENV = {"BENCH_BUDGET_S": "40", "BENCH_SOAK_S": "0"}  # phase 24
BENCH_TIMEOUT_S = 300  # phase 24's bench: budget, watchdog grace, margin


def start_module(argv: list, env: dict, cwd=None) -> dict:
    """Start ``python -m ...`` (from the checkout's root, or ``cwd``) in a
    session of its own, its output to files, so waiting for it does not
    wait for children that hold its pipes.  If this script ends before
    ``finish_module`` (a phase failed), ``atexit`` kills the session."""
    import atexit
    import tempfile

    out = tempfile.TemporaryFile("w+")
    err = tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", *argv],
        cwd=cwd or Path(__file__).resolve().parent, env=env, stdout=out,
        stderr=err, text=True, start_new_session=True,
    )
    handle = {"proc": proc, "out": out, "err": err,
              "start": time.perf_counter()}
    handle["kill"] = lambda: _kill_session(proc)
    atexit.register(handle["kill"])
    return handle


def _kill_session(proc) -> None:
    import os
    import signal

    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def finish_module(handle: dict, timeout_s: float) -> tuple:
    """Wait for a ``start_module`` command; when it exits, whatever it
    left running (a timed-out stage's node processes) is killed.  (rc,
    stdout, stderr)."""
    import atexit

    proc = handle["proc"]
    try:
        proc.wait(timeout=timeout_s)
    finally:
        handle["kill"]()
        atexit.unregister(handle["kill"])
    out, err = handle["out"], handle["err"]
    out.seek(0)
    err.seek(0)
    try:
        return proc.returncode, out.read(), err.read()
    finally:
        out.close()
        err.close()


def run_module(argv: list, env: dict, timeout_s: float) -> tuple:
    """``python -m ...`` from the checkout's root, waited for
    (``start_module``, ``finish_module``).  (rc, stdout, stderr)."""
    return finish_module(start_module(argv, env), timeout_s)


def bench_phase(t0: float) -> dict:
    """Phase 24: ``python -m mirbft_tpu_torch.bench`` under a 40 s budget,
    the soak off, its journal in a temp dir: rc 0, one JSON line last with
    the JAX stages in the JAX order, each ``ok`` or past the budget
    (``timeout``, or ``skipped`` with the budget exhausted; the soak
    skipped by design), ``live_serial`` ``ok``, rung 5 ``timeout`` or
    skipped with the budget exhausted (never ``error``); the journal a
    header, a line a stage and the payload; ``--recover`` on it the same
    payload; ``obsv --diff`` of the artifact against itself exit 0."""
    import contextlib
    import os
    import tempfile

    from mirbft_tpu_torch import bench as port_bench

    start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-bench-") as tmp:
        journal = Path(tmp) / "BENCH_stream.jsonl"
        env = dict(os.environ, BENCH_STREAM_PATH=str(journal), **BENCH_ENV)
        rc, out, err = run_module(["mirbft_tpu_torch.bench"], env,
                                  BENCH_TIMEOUT_S)
        check(rc == 0, f"phase 24: the bench exited {rc}: {out[-2000:]} "
              f"{err[-4000:]}")
        payload = json.loads(out.splitlines()[-1])
        stages = payload["stages"]
        check(list(stages) == list(port_bench.STAGES),
              f"phase 24: stages {list(stages)}")
        by_design = {"soak": "BENCH_SOAK_S=0",
                     "ladder_kernel": "needs warm_calibrate"}
        for name, entry in stages.items():
            status, detail = entry["status"], entry.get("detail")
            check(status == "ok" or status == "timeout"
                  or (status == "skipped"
                      and detail in (by_design.get(name), "budget exhausted")),
                  f"phase 24: stage {name} {entry}")
        check(stages["live_serial"]["status"] == "ok",
              f"phase 24: live_serial {stages['live_serial']}")
        check(stages["soak"]["status"] == "skipped",
              "phase 24: the soak ran")
        rung5 = stages["rung5"]
        check(rung5["status"] == "timeout"
              or (rung5["status"] == "skipped"
                  and rung5.get("detail") == "budget exhausted"),
              f"phase 24: rung 5 {rung5} (at a 40 s budget it must run out "
              "of budget)")
        lines = [json.loads(line) for line in journal.read_text().splitlines()]
        check(lines[0]["kind"] == "header"
              and [line.get("stage") for line in lines[1:-1]]
              == list(port_bench.STAGES)
              and all(line["status"] == stages[line["stage"]]["status"]
                      for line in lines[1:-1])
              and lines[-1] == {"kind": "final", "payload": payload},
              "phase 24: the journal is not a header, a line a stage and "
              "the payload")
        # --recover and obsv --diff in this process: their entry points'
        # own functions, without two more interpreters' start-up.
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rc = port_bench.cli(["--recover", str(journal)])
        check(rc == 0 and json.loads(text.getvalue()) == payload,
              f"phase 24: --recover gave rc {rc}: {text.getvalue()[-2000:]}")
        artifact = Path(tmp) / "bench.json"
        artifact.write_text(json.dumps(payload))
        rc, out = run_obsv_cli(["--diff", str(artifact), str(artifact)])
        check(rc == 0, f"phase 24: obsv --diff of the artifact against "
              f"itself exited {rc}: {out[-2000:]}")
    wall = time.perf_counter() - start
    print(
        f"phase 24 ok: python -m mirbft_tpu_torch.bench with "
        f"BENCH_BUDGET_S={BENCH_ENV['BENCH_BUDGET_S']} BENCH_SOAK_S=0: rc "
        "0, the JAX stages in the JAX order ("
        + ", ".join(f"{name} {entry['status']} {entry['seconds']}"
                    for name, entry in stages.items())
        + f"); live {payload['live_reqs_per_sec_serial']} / "
        f"{payload['live_reqs_per_sec_pipelined']} req/s; the journal, "
        "--recover and obsv --diff against itself agree; phase wall "
        f"{wall:.1f} s (done at {time.perf_counter() - t0:.1f} s)"
    )
    return {"wall_s": wall, "stages": stages}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", metavar="PATH",
                        help="write cProfile tables of a host and a kernel "
                        "rung-2 run to PATH")
    parser.add_argument("--live-rounds", type=int, default=1, metavar="N",
                        help="run phase 11's kinds N times (a stall "
                        "fails the script; the kernels line reads round 1)")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is present", file=sys.stderr)
        return 1

    from mirbft_tpu_torch import _build
    from mirbft_tpu_torch import bench as port_bench
    from mirbft_tpu_torch.ops.batching import pack_preimages, to_tensors
    from mirbft_tpu_torch.ops.sha256 import sha256_digest_words
    from mirbft_tpu_torch.ops.sha256 import (
        DEPENDENT_ISSUE_CYCLES as SHA256_ISSUE_CYCLES,
        ROUND_CHAIN as SHA256_ROUND_CHAIN,
        chain_floor_cycles as sha256_chain_floor_cycles,
    )
    from mirbft_tpu_torch.testengine.crypto_plane import (
        AsyncKernelHashPlane,
        CoalescingHashPlane,
    )

    card = nvidia_smi("name,power.limit")
    kind = torch.cuda.get_device_name(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {kind}, {sms} SMs")

    # -- phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all(["sha256", "ed25519", "ack_plane", "bls_g1",
                             "parallel"])
    build_s = time.perf_counter() - t0
    print(f"phase 1 ok: sha256.cu (digest, chain), ed25519.cu, "
          f"ack_plane.cu (step, sweep), bls_g1.cu and parallel.cu (tally, "
          f"shard sum) built for sm_90a in {build_s:.3f} s (one nvcc each, "
          f"together)")
    ptxas = {}
    for name, lib in libs.items():
        text = lib.with_suffix(".ptxas.txt").read_text()
        for line in text.splitlines():
            print(f"  {line.strip()}")
        ptxas.update(ptxas_report(text))
    from mirbft_tpu_torch.ops import ed25519 as ed25519_ops

    dynamic = dict.fromkeys(
        ("mirbft_ed25519_ladder_kernel",
         "mirbft_ed25519_ladder_extended_kernel"),
        ed25519_ops.ladder_smem_bytes())
    for kernel, (regs, stack, stores, loads, smem) in sorted(ptxas.items()):
        print(f"  {kernel}: {regs} registers, {stack} bytes stack frame, "
              f"{stores} bytes spill stores, {loads} bytes spill loads, "
              f"{smem} bytes static shared memory, "
              f"{dynamic.get(kernel, 0)} bytes dynamic shared memory")

    # -- phase 2: kernel == plain == hashlib ---------------------------------
    rng = random.Random(SEED)
    max_err = 0
    edge = [rng.randbytes(n) for n in (0, 55, 56, 63, 64, 119, 120)]
    err, _ = compare_case("block boundaries", edge, 1, 8)
    max_err = max(max_err, err)
    ragged = [rng.randbytes(rng.randrange(0, 900)) for _ in range(300)]
    err, _ = compare_case("n_blocks < max_blocks", ragged, 32, 384)
    max_err = max(max_err, err)
    shapes = main_path_batches(rng)
    packed_by_shape = {}
    for shape, (msgs, block_floor, rows) in shapes.items():
        err, packed = compare_case(f"main path {shape}", msgs, block_floor, rows)
        check(packed.blocks.shape == shape, f"packed {packed.blocks.shape}")
        packed_by_shape[shape] = packed
        max_err = max(max_err, err)
    for rows, bucket in SHA256_SHAPES:
        lengths = bucket_lengths(rng, rows, bucket, ragged=True)
        err, packed = compare_case(
            f"ragged ({rows}, {bucket}, 16)",
            [rng.randbytes(n) for n in lengths], bucket, rows,
        )
        check(packed.blocks.shape == (rows, bucket, 16),
              f"ragged: packed {packed.blocks.shape}")
        max_err = max(max_err, err)
    print(f"phase 2 ok: kernel == plain == hashlib at every bucket shape, "
          f"max_abs_err {max_err}")

    # -- phase 3: the 16x64x25 anchor on the kernel plane --------------------
    plane = AsyncKernelHashPlane()
    sha256_digest_words.launches = 0
    result = port_bench.ladder_run(
        plane, reqs_per_client=ANCHOR_REQS, ready_latency=None)
    wall, events, _chain, _sim = result
    chains, counts = result.chains, result.counts
    anchor_chains = chains
    anchor_launches = sha256_digest_words.launches
    check(events == 2320, f"anchor gave {events} events, not 2320")
    check(len(set(chains.values())) == 1, "anchor: app chains differ")
    check(
        all(count == CLIENTS * ANCHOR_REQS for count in counts),
        "anchor: not every node committed 1600 requests",
    )
    check(anchor_launches > 0 and plane.host_digests == 0,
          "anchor: digests did not all come from the kernel")
    print(
        f"phase 3 ok: anchor {NODES}x{CLIENTS}x{ANCHOR_REQS} BatchSize "
        f"{BATCH_SIZE} -> {events} events, one chain, "
        f"{CLIENTS * ANCHOR_REQS} commits per node; {anchor_launches} "
        f"launches, {plane.device_digests} digests on the card"
    )

    # -- phase 4: rung 2, host and kernel planes in turns --------------------
    runs = []
    order = []
    for pair in range(RUNG2_PAIRS):
        order += ["host", "kernel"] if pair % 2 == 0 else ["kernel", "host"]
    for label in order:
        if label == "host":
            plane = CoalescingHashPlane()
        else:
            plane = AsyncKernelHashPlane()
        sha256_digest_words.launches = 0
        result = port_bench.ladder_run(plane)
        wall, events, _chain, _sim = result
        cpu = (result.cpu_s, result.thread_s, result.gc_s)
        chains, committed = result.chains, result.committed
        launches = sha256_digest_words.launches
        committed_reqs = CLIENTS * port_bench.REQS_PER_CLIENT
        kernel_ms = getattr(plane, "kernel_ms", 0.0)
        blocking_s = sum(plane.flush_wall_s)
        line = (
            f"  rung 2 {label}: {NODES}x{CLIENTS}x"
            f"{port_bench.REQS_PER_CLIENT} BatchSize "
            f"{BATCH_SIZE}: {events} events, wall {wall:.6f} s, "
            f"{committed_reqs / wall:.3f} committed req/s, cpu process "
            f"{cpu[0]:.6f} s main thread {cpu[1]:.6f} s collector "
            f"{cpu[2]:.6f} s, launches "
            f"{launches}, plane submit {plane.submit_s:.6f} s, plane "
            f"launch {getattr(plane, 'launch_s', 0.0):.6f} s, plane "
            f"blocking {blocking_s:.6f} s"
        )
        if label == "kernel":
            check(launches > 0, "rung 2: the kernel never launched")
            check(plane.host_digests == 0, "rung 2: digests went to the host")
            check(launches == plane.launches, "rung 2: launch counts differ")
            line += (
                f", kernel device time {kernel_ms:.6f} ms (card idle "
                f"{100 * (1 - kernel_ms / 1e3 / wall):.4f}% of wall), digests "
                f"device {plane.device_digests} host {plane.host_digests}, "
                f"by bucket {dict(sorted(plane.bucket_digests.items()))}, "
                f"launches by packed shape (rows, blocks) "
                f"{dict(sorted(plane.shape_launches.items()))}, "
                f"demand flushes {plane.demand_flushes}"
            )
            check(sum(plane.shape_launches.values()) == launches,
                  "rung 2: launches by shape do not add up")
        else:
            line += f", digests host {plane.host_digests}"
        print(line)
        runs.append(dict(
            shape_launches=getattr(plane, "shape_launches", {}),
            label=label, events=events, wall=wall, cpu=cpu, chains=chains,
            # Host seconds in the plane: submit, plus launches and waits
            # (flush_wall_s holds both on the kernel plane).
            plane_s=plane.submit_s + blocking_s,
            committed=committed, launches=launches, kernel_ms=kernel_ms,
            digests=plane.device_digests if label == "kernel"
            else plane.host_digests,
        ))
    first = runs[0]
    for run in runs[1:]:
        check(run["events"] == first["events"], "rung 2: event counts differ")
        check(run["chains"] == first["chains"], "rung 2: app chains differ")
        check(run["committed"] == first["committed"],
              "rung 2: committed sequences differ")
        check(run["digests"] == first["digests"], "rung 2: digest counts differ")
    check(len(set(first["chains"].values())) == 1, "rung 2: nodes diverged")
    main_launches = next(r["launches"] for r in runs if r["label"] == "kernel")
    rung2_shapes = next(
        r["shape_launches"] for r in runs if r["label"] == "kernel"
    )
    medians = {}
    for label in ("host", "kernel"):
        mine = [r for r in runs if r["label"] == label]
        medians[label] = (
            f"wall {statistics.median(r['wall'] for r in mine):.6f} s, cpu "
            f"{statistics.median(r['cpu'][0] for r in mine):.6f} s, main "
            f"thread {statistics.median(r['cpu'][1] for r in mine):.6f} s, "
            f"plane {statistics.median(r['plane_s'] for r in mine):.6f} s"
        )
        print(f"  rung 2 {label} walls (s): "
              + ", ".join(f"{r['wall']:.6f}" for r in mine))
    # Each pair's kernel run minus its host run.
    pairs = [
        {r["label"]: r for r in runs[i : i + 2]}
        for i in range(0, len(runs), 2)
    ]
    wall_deltas = [p["kernel"]["wall"] - p["host"]["wall"] for p in pairs]
    plane_deltas = [p["kernel"]["plane_s"] - p["host"]["plane_s"] for p in pairs]
    print(
        "phase 4 ok: the kernel runs match the host runs (events, app "
        f"chains, committed sequences); {RUNG2_PAIRS} pairs; medians host "
        f"{medians['host']}; kernel {medians['kernel']}; kernel minus host "
        "wall per pair (s): " + ", ".join(f"{d:+.6f}" for d in wall_deltas)
        + f"; median {statistics.median(wall_deltas):+.6f} s; kernel wins "
        f"{sum(d < 0 for d in wall_deltas)} of {len(pairs)}; kernel minus "
        f"host plane s, median {statistics.median(plane_deltas):+.6f} s"
    )
    if args.profile:
        with open(args.profile, "w") as out:
            profile_rung2(CoalescingHashPlane, "host", out)
            profile_rung2(AsyncKernelHashPlane, "kernel", out)
        print(f"  cProfile tables of a host and a kernel run: {args.profile}")

    # -- phase 5: kernel time, bound, chain floor, plain time ---------------
    # Every bucket shape: the main path's two with protocol preimages (as
    # phase 2 packed them), the other six with rows that fill the bucket.
    per_shape = []
    for rows, bucket in SHA256_SHAPES:
        packed = packed_by_shape.get((rows, bucket, 16))
        data = "protocol preimages"
        if packed is None:
            lengths = bucket_lengths(rng, rows, bucket, ragged=False)
            packed = pack_preimages([rng.randbytes(n) for n in lengths],
                                    block_floor=bucket, batch_floor=rows)
            data = "rows that fill the bucket"
        check(packed.blocks.shape == (rows, bucket, 16),
              f"phase 5: packed {packed.blocks.shape}")
        blocks, n_blocks = to_tensors(packed, "cuda")
        reps = 400 if bucket == 1 else 100
        ms, call_ms = time_device(
            lambda: sha256_digest_words(blocks, n_blocks), reps
        )
        cost = digest_cost(packed, ms, sms)
        plain_ms = time_plain(blocks, n_blocks)
        per_shape.append(dict(
            shape=[rows, bucket, 16], data=data, ms=ms, call_ms=call_ms,
            plain_ms=plain_ms, **cost, library_ms=None,
            launches_rung2=rung2_shapes.get((rows, bucket), 0),
        ))
        print(
            f"  kernel time ({rows}, {bucket}, 16), {data}: {ms:.6f} ms over "
            f"{reps} launches ({call_ms:.6f} ms a call on the host clock); "
            + describe_cost(cost, ms) + f"; plain {plain_ms:.3f} ms; "
            "library_ms null (no PyTorch call computes SHA-256)"
        )
    print("phase 5 ok")

    print(f"phase 5 done at {time.perf_counter() - t0:.1f} s")
    rung2_launches = main_launches

    from mirbft_tpu_torch.ops import ed25519
    from mirbft_tpu_torch.testengine import rung3
    from mirbft_tpu_torch.testengine.signing import (
        AsyncSignaturePlane,
        SignaturePlane,
        host_verifier,
        make_signer,
    )

    # -- phase 6: Ed25519 kernels == plain == oracle -------------------------
    start = time.perf_counter()
    presigned = rung3.presign(processes=POOL_PROCESSES)
    presign_s = time.perf_counter() - start
    print(f"  rung-3 clients signed {len(presigned)} requests in "
          f"{presign_s:.3f} s ({POOL_PROCESSES} processes)")
    rows, rejects = signature_corpus(presigned)
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(POOL_PROCESSES) as pool:
        oracle = pool.map(oracle_row, rows + rejects, chunksize=64)
    reject_oracle = oracle[len(rows):]
    check(not any(o[0] for o in reject_oracle), "a host reject verifies")
    ed_err = 0
    for n in ED25519_COMPARED:
        ed_err = max(ed_err, compare_ed25519(
            n, rows[:n] + rejects, oracle[:n] + reject_oracle
        ))
    for m in DECOMPRESS_CORPUS_ROWS:
        ed_err = max(ed_err, compare_decompress_corpus(m))
    print(f"phase 6 ok: ed25519 kernels (the host route's extended ladder "
          f"too) == plain == oracle at n = "
          f"{', '.join(map(str, ED25519_COMPARED))}; decompress == plain == "
          f"oracle on the decompression corpus repeated to m = "
          f"{', '.join(map(str, DECOMPRESS_CORPUS_ROWS))} rows; "
          f"max_abs_err {ed_err} (done at {time.perf_counter() - t0:.1f} s)")

    # -- phase 7: signed engine run, kernels against the host oracle ---------
    signatures: dict = {}
    sign = make_signer()

    def signer(cid, rn, payload):
        key = (cid, rn, payload)
        if key not in signatures:
            signatures[key] = sign(cid, rn, payload)
        return signatures[key]

    host_plane = SignaturePlane(host_verifier)
    host_events, host_wall, host_decided, _ = signed_engine_run(
        host_plane, signer
    )
    async_plane = AsyncSignaturePlane()
    ed25519.decompress.launches = ed25519.ladder.launches = 0
    events, wall, decided, rec = signed_engine_run(async_plane, signer)
    signed_launches = (ed25519.decompress.launches, ed25519.ladder.launches)
    check(events == host_events, f"phase 7: {events} != {host_events} events")
    check(decided[0] == host_decided[0], "phase 7: app chains differ")
    check(decided[1] == host_decided[1], "phase 7: committed sequences differ")
    check(decided[2] == host_decided[2], "phase 7: recorded events differ")
    check(len(set(decided[0].values())) == 1, "phase 7: nodes diverged")
    # Every distinct request was rejected on the host (the forgery) or
    # launched, in waves of a shape phase 6 held against the oracle.
    check(async_plane.device_verifies == CLIENTS * SIGNED_REQS
          and async_plane.host_rejects == 1,
          f"phase 7: {async_plane.device_verifies} verifies on the card, "
          f"{async_plane.host_rejects} host rejects")
    check(set(async_plane.flush_sizes) <= set(ED25519_COMPARED),
          f"phase 7: waves of {async_plane.flush_sizes} rows")
    check(signed_launches[1] == async_plane.launches > 0,
          "phase 7: the ladder launches do not match the plane's")
    check(rec.hash_plane.host_digests == 0, "phase 7: a digest on the host")
    print(
        f"phase 7 ok: signed {NODES}x{CLIENTS}x{SIGNED_REQS} BatchSize "
        f"{BATCH_SIZE} with a forged request at every node: {events} events "
        f"on both planes, equal chains, commits and recorded events "
        f"({len(decided[2])}); host plane wall {host_wall:.6f} s, "
        f"{sum(host_plane.flush_sizes)} host verifies; async plane wall "
        f"{wall:.6f} s, {async_plane.device_verifies} verifies on the card "
        f"in {async_plane.launches} waves ({async_plane.demand_flushes} "
        f"demanded), host rejects {async_plane.host_rejects}, kernel "
        f"{async_plane.kernel_ms:.6f} ms; rejections "
        f"{rec.byzantine_rejections} (done at "
        f"{time.perf_counter() - t0:.1f} s)"
    )

    # -- phase 8: rung 3 at full scale ---------------------------------------
    sha256_digest_words.launches = 0
    ed25519.decompress.launches = ed25519.ladder.launches = 0
    ed25519.decompress.launches_by_rows.clear()
    ed25519.ladder.launches_by_rows.clear()
    r3 = port_bench.rung3_run(presigned=presigned)
    rate, _p99, events, _verified, _stats, _sim = r3
    plane, hash_plane = r3.signature_plane, r3.hash_plane
    wall, cpu = r3.wall_s, (r3.cpu_s, r3.thread_s)
    # Rung 3's launches of each Ed25519 kernel by the signatures they
    # verified (decompression's rows are two points a signature).
    rung3_ed_launches = {
        "decompress": {rows // 2: count for rows, count in
                       ed25519.decompress.launches_by_rows.items()},
        "ladder": dict(ed25519.ladder.launches_by_rows),
    }
    rung3_launches = {
        "sha256_digest": sha256_digest_words.launches,
        "ed25519_decompress": ed25519.decompress.launches,
        "ed25519_ladder": ed25519.ladder.launches,
    }
    # One chain, and every request committed on every node: rung3_run
    # raises otherwise.
    total = rung3.CLIENTS * rung3.REQS
    check(events == RUNG3_EVENTS, f"rung 3: {events} events, not {RUNG3_EVENTS}")
    check(r3.chain == RUNG3_CHAIN, f"rung 3: app chain {r3.chain}")
    check(plane.speculative_evictions == 0, "rung 3: evictions")
    check(plane.device_verifies == total and plane.host_rejects == 0,
          f"rung 3: {plane.device_verifies} verifies on the card")
    check(set(plane.flush_sizes) <= set(ED25519_COMPARED),
          f"rung 3: bursts of {sorted(set(plane.flush_sizes))} rows")
    check(hash_plane.host_digests == 0, "rung 3: a digest on the host")
    check(all(count > 0 for count in rung3_launches.values()),
          f"rung 3: a kernel never launched: {rung3_launches}")
    for name, by_n in rung3_ed_launches.items():
        check(sum(by_n.values()) == rung3_launches["ed25519_" + name],
              f"rung 3: {name} launches by rows do not add up")
        check(set(by_n) <= set(ED25519_SHAPES),
              f"rung 3: {name} launches at n phase 9 does not time: "
              f"{sorted(set(by_n) - set(ED25519_SHAPES))}")
    device_ms = plane.kernel_ms + hash_plane.kernel_ms
    check(sum(hash_plane.shape_launches.values()) == hash_plane.launches
          == rung3_launches["sha256_digest"],
          "rung 3: launches by shape do not add up")
    for entry in per_shape:
        shape = tuple(entry["shape"][:2])
        entry["launches_rung3"] = hash_plane.shape_launches.get(shape, 0)
        gap = entry["gap_ms"]
        entry["launches_x_gap_ms"] = {
            "rung2": entry["launches_rung2"] * gap,
            "rung3": entry["launches_rung3"] * gap,
        }
    unknown = set(hash_plane.shape_launches) | set(rung2_shapes)
    unknown -= {tuple(e["shape"][:2]) for e in per_shape}
    check(not unknown, f"SHA-256 launches at shapes phase 5 did not time: "
          f"{sorted(unknown)}")
    print(
        "  sha256 launches by packed shape (rows, blocks), rung 2 / rung 3, "
        "and launches x (ms - the larger of bound and chain floor): "
        + "; ".join(
            f"{tuple(e['shape'][:2])}: {e['launches_rung2']} / "
            f"{e['launches_rung3']}, {e['launches_x_gap_ms']['rung2']:.6f} / "
            f"{e['launches_x_gap_ms']['rung3']:.6f} ms"
            for e in per_shape
        )
    )
    print(
        f"phase 8 ok: rung 3 {rung3.NODES} nodes x {rung3.CLIENTS} clients x "
        f"{rung3.REQS} BatchSize {rung3.BATCH_SIZE}: {events} events, chain "
        f"{RUNG3_CHAIN[:16]}..., {total} commits on every node; wall "
        f"{wall:.6f} s, {rate:.3f} committed req/s; verify p99 "
        f"{p99_ms(plane.flush_wall_s):.6f} ms over {len(plane.flush_wall_s)} "
        f"bursts (max {1e3 * max(plane.flush_wall_s):.6f} ms, sum "
        f"{sum(plane.flush_wall_s):.6f} s); verifies device "
        f"{plane.device_verifies} host rejects {plane.host_rejects}, evictions "
        f"{plane.speculative_evictions}, forced joins {plane.forced_joins}; "
        f"digests device {hash_plane.device_digests} host "
        f"{hash_plane.host_digests}; launches {rung3_launches}, sha256 by "
        f"packed shape {dict(sorted(hash_plane.shape_launches.items()))}; "
        "device time "
        f"ed25519 {plane.kernel_ms:.6f} ms + sha256 "
        f"{hash_plane.kernel_ms:.6f} ms, card idle "
        f"{100 * (1 - device_ms / 1e3 / wall):.4f}% of wall; cpu process "
        f"{cpu[0]:.6f} s main thread {cpu[1]:.6f} s collector "
        f"{r3.gc_s:.6f} s; hash plane submit "
        f"{hash_plane.submit_s:.6f} s launch {hash_plane.launch_s:.6f} s "
        f"blocking {sum(hash_plane.flush_wall_s):.6f} s in "
        f"{hash_plane.launches} launches (done at "
        f"{time.perf_counter() - t0:.1f} s)"
    )

    # -- phase 9: Ed25519 kernel times, bounds, plain times ------------------
    ed_shapes = {"ed25519_decompress": [], "ed25519_ladder": [],
                 "ed25519_ladder_extended": []}
    marshal_us = []  # per n: (marshal_light, marshal_signature) us a row
    for n in ED25519_SHAPES:
        triples = [rung3_row(presigned, key, i % 4)
                   for i, key in enumerate(sorted(presigned)[:n])]
        start = time.perf_counter()
        marshalled = [ed25519.marshal_light(*t) for t in triples]
        light_us = (time.perf_counter() - start) * 1e6 / n
        enc, s_words, k_words = (
            torch.from_numpy(a).to("cuda")
            for a in ed25519.pack_rows(marshalled)
        )
        # The host route's rows: valid, corrupted S, wrong message (a
        # corrupted R may not decompress, and every row must launch).
        triples = [rung3_row(presigned, key, (0, 2, 3)[i % 3])
                   for i, key in enumerate(sorted(presigned)[:n])]
        start = time.perf_counter()
        host_rows = [ed25519.marshal_signature(*t) for t in triples]
        host_us = (time.perf_counter() - start) * 1e6 / n
        check(None not in host_rows, f"phase 9: a host-route row at n={n} "
              "does not decompress")
        marshal_us.append({"n": n, "marshal_light_us": light_us,
                           "marshal_signature_us": host_us})
        ext_s, ext_k, neg_a, r_xy = (
            torch.from_numpy(a).to("cuda")
            for a in ed25519.pack_signature_rows(host_rows)
        )
        xy, ok = ed25519.decompress(enc)
        dec_ms, dec_call = time_device(lambda: ed25519.decompress(enc), 50)
        lad_ms, lad_call = time_device(
            lambda: ed25519.ladder(xy, ok, s_words, k_words), 20
        )
        ext_ms, ext_call = time_device(
            lambda: ed25519.ladder_extended(neg_a, r_xy, ext_s, ext_k), 20
        )
        clock = sm_clock_mhz()
        bounds = ed25519_bounds(n, sms, clock)
        plain = {}
        if n == ED25519_SHAPES[0]:
            for name, fn in (
                ("decompress", lambda: ed25519.decompress_plain(enc)),
                ("ladder", lambda: ed25519.ladder_plain(xy, ok, s_words,
                                                        k_words)),
                ("ladder_extended", lambda: ed25519.ladder_extended_plain(
                    neg_a, r_xy, ext_s, ext_k)),
            ):
                torch.cuda.synchronize()
                start = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                plain[name] = (time.perf_counter() - start) * 1e3
        for name, ms, call_ms in (("decompress", dec_ms, dec_call),
                                  ("ladder", lad_ms, lad_call),
                                  ("ladder_extended", ext_ms, ext_call)):
            bound = bounds[name]
            floor = max(bound["bound_ms"], bound["chain_floor_ms"])
            launches = rung3_ed_launches.get(name, {}).get(n, 0)
            ed_shapes["ed25519_" + name].append(dict(
                n=n, rows=2 * n if name == "decompress" else n, ms=ms,
                call_ms=call_ms, plain_ms=plain.get(name), library_ms=None,
                sm_clock_mhz=clock, launches_rung3=launches,
                gap_ms=ms - floor, launches_x_gap_ms=launches * (ms - floor),
                **bound,
            ))
            print(
                f"  {name} n={n}: {ms:.6f} ms a launch ({call_ms:.6f} ms a "
                f"call on the host clock); bound {bound['bound_ms']:.6f} ms "
                f"({bound['bound_by']}: {bound['int_ops']} int ops / ({sms} "
                f"SMs x {INT32_LANES_PER_SM} INT32 lanes x {clock:.0f} MHz) "
                f"= {bound['ops_bound_ms']:.6f} ms; {bound['bytes']} bytes / "
                f"3.35 TB/s = {bound['bytes_bound_ms']:.6f} ms); chain floor "
                f"{bound['chain_floor_ms']:.6f} ms (one row's dependent "
                f"chain, 4 cycles an instruction); the {bound['binds']} "
                f"binds: {100 * floor / ms:.2f}% of it; rung 3 launched it "
                f"{launches} times at n={n}: launches x gap "
                f"{launches * (ms - floor):.6f} ms"
                + (f"; plain {plain[name]:.3f} ms" if plain else "")
                + "; library_ms null (no PyTorch call verifies Ed25519)"
            )
    for e in marshal_us:
        print(f"  host marshalling n={e['n']} on this machine's host: "
              f"marshal_light {e['marshal_light_us']:.3f} us a row (the "
              f"device route's), marshal_signature "
              f"{e['marshal_signature_us']:.3f} us a row (the host route's: "
              f"two decompressions)")
    print(f"phase 9 ok (done at {time.perf_counter() - t0:.1f} s)")

    # -- phase 10: the chain kernel and the kernel microbenchmark -----------
    from mirbft_tpu_torch.ops.sha256 import (
        chain_int_ops,
        sha256_chain_checksum,
        sha256_chain_checksum_plain,
    )

    generator = torch.Generator().manual_seed(SEED)
    chain_err = 0
    for rows, iters in CHAIN_COMPARED:
        block = torch.randint(
            -2**31, 2**31 - 1, (rows, 16), dtype=torch.int32,
            generator=generator,
        ).to("cuda")
        got = int(sha256_chain_checksum(block, iters=iters)) & 0xFFFFFFFF
        want = int(
            sha256_chain_checksum_plain(block.cpu(), iters=iters)
        ) & 0xFFFFFFFF
        err = abs(got - want)
        chain_err = max(chain_err, err)
        check(err == 0, f"chain ({rows}, 16) x {iters}: kernel {got} != "
              f"plain {want}")
        print(f"  chain ({rows}, 16) x {iters} iterations: kernel == plain "
              f"({got:#010x})")
    warm_s = port_bench.sha256_microbench_warmup()
    sha256_chain_checksum.launches = 0
    micro = port_bench.kernel_microbench()
    chain_launches = sha256_chain_checksum.launches
    check(chain_launches == port_bench.CHAIN_REPS,
          f"microbench: {chain_launches} chain launches")
    chain_ms = min(micro["rep_ms"])
    clock = sm_clock_mhz()
    chain_ops = chain_int_ops(micro["batch"], micro["iters"])
    chain_ops_ms = (
        chain_ops / (sms * INT32_LANES_PER_SM * clock * 1e6) * 1e3
    )
    chain_bytes = micro["batch"] * 64 + 4
    chain_bytes_ms = chain_bytes / HBM_BYTES_PER_S * 1e3
    chain_bound_ms = max(chain_ops_ms, chain_bytes_ms)
    chain_bound_by = "operations" if chain_ops_ms >= chain_bytes_ms else "bytes"
    # One row's chain: its iterations are serial compressions of one block.
    chain_floor_ms = (
        sha256_chain_floor_cycles(micro["iters"]) / (clock * 1e3)
    )
    full = torch.randint(
        -2**31, 2**31 - 1, (port_bench.CHAIN_BATCH, 16), dtype=torch.int32,
        generator=generator,
    ).to("cuda")
    torch.cuda.synchronize()
    start = time.perf_counter()
    sha256_chain_checksum_plain(full, iters=CHAIN_PLAIN_ITERS)
    torch.cuda.synchronize()
    chain_plain_ms = (time.perf_counter() - start) * 1e3
    print(
        f"phase 10 ok: chain kernel == plain, max_abs_err {chain_err}; "
        f"microbench {micro['batch']} rows x {micro['iters']} iterations x "
        f"{micro['reps']} reps (warm-up {warm_s:.3f} s): rep ms (CUDA "
        f"events) " + ", ".join(f"{ms:.6f}" for ms in micro["rep_ms"])
        + "; wall ms " + ", ".join(f"{ms:.6f}" for ms in micro["rep_wall_ms"])
        + f"; chain_rate {micro['chain_rate']:.6e} compressions/s, "
        f"kernel_digest_rate {micro['kernel_digest_rate']:.6e} 640-byte "
        f"digests/s, host_rate {micro['host_rate']:.3f} hashlib digests/s; "
        f"kernel {chain_ms:.6f} ms, bound {chain_bound_ms:.6f} ms "
        f"({chain_bound_by}: {chain_ops} int ops / ({sms} SMs x "
        f"{INT32_LANES_PER_SM} INT32 lanes x {clock:.0f} MHz) = "
        f"{chain_ops_ms:.6f} ms; {chain_bytes} bytes / 3.35 TB/s = "
        f"{chain_bytes_ms:.6f} ms); chain floor {chain_floor_ms:.6f} ms (a "
        f"row's {micro['iters']} serial compressions x 64 rounds x "
        f"{SHA256_ROUND_CHAIN} x {SHA256_ISSUE_CYCLES} cycles), so the "
        + ("chain floor" if chain_floor_ms >= chain_bound_ms
           else "throughput bound")
        + " binds; "
        f"{100 * chain_bound_ms / chain_ms:.2f}% "
        f"of bound; plain {chain_plain_ms:.3f} ms at {CHAIN_PLAIN_ITERS} "
        f"iterations of the full batch; library_ms null (no PyTorch call "
        f"computes SHA-256) (done at {time.perf_counter() - t0:.1f} s)"
    )

    # -- phase 11: the live rung under every processor kind -----------------
    # Each node runs in a process of its own; its wrapper's count starts at
    # 0 with the process and is read when the run stops.  The kind the
    # bench's live_serial stage runs (phase 24) is not run here again.
    live = []
    for live_round, live_kind in (
        (r, k) for r in range(args.live_rounds) for k in PHASE11_KINDS
    ):
        gc.collect()
        result = port_bench.live_cluster_rate(live_kind)
        result["round"] = live_round
        live.append(result)
        line = (
            f"  live round {live_round + 1} {live_kind}: "
            f"{port_bench.LIVE.target_commits} commits "
            f"in {result['elapsed_s']:.6f} s, {result['rate']:.3f} committed "
            f"req/s, p95 {result['p95_ms']:.3f} ms, per-node commits "
            f"{result['commits']}, shared chain prefix "
            f"{result['shared_prefix']}, hash requests "
            f"{result['hash_requests']}, frames dropped "
            f"{result['frames_dropped']}"
        )
        if live_kind.startswith("cuda"):
            # live_cluster_rate also holds the wrappers' count to the
            # processors' and every kept launch's digests to hashlib's.
            idle = 100 * (1 - result["kernel_ms"] / 1e3 / result["elapsed_s"])
            line += (
                f", digests device {result['device_digests']} host "
                f"{result['host_digests']}, launches {result['launches']}, "
                f"kernel spans {result['kernel_ms']:.6f} ms (CUDA events "
                "around each launch; they hold whatever host time passes "
                "between the events, so the card is idle at least "
                f"{idle:.4f}% of the run)"
            )
        print(line)
    live_cuda = [r for r in live if r["kind"].startswith("cuda")]
    live_launches = sum(
        r["wrapper_launches"] for r in live_cuda if r["round"] == 0
    )

    # The launch audit: every shape the live launches had, and each kept
    # launch replayed through the kernel (outside the counted runs) against
    # plain and the live launch (live_cluster_rate held the live launch's
    # read-back digests to hashlib's).
    from mirbft_tpu_torch.ops.sha256 import (
        sha256_digest_words_plain,
        words_to_digests,
    )

    live_shapes: dict = {}
    round0_shapes: dict = {}
    first_kept: dict = {}
    live_err, replayed = 0, 0
    for result in live_cuda:
        for shape, (launches, kept) in result["samples"].items():
            check(kept, f"live {result['kind']}: {launches} launches of "
                  f"shape {shape}, none kept for the audit")
            live_shapes[shape] = live_shapes.get(shape, 0) + launches
            if result["round"] == 0:
                round0_shapes[shape] = round0_shapes.get(shape, 0) + launches
            first_kept.setdefault(shape, kept[0][0])
            for preimages, raw in kept:
                packed = pack_preimages(preimages)
                check(packed.blocks.shape[:2] == shape,
                      f"replay packs {packed.blocks.shape[:2]}, not {shape}")
                blocks, n_blocks = to_tensors(packed, "cuda")
                kernel = sha256_digest_words(blocks, n_blocks).cpu()
                plain = sha256_digest_words_plain(blocks.cpu(), n_blocks.cpu())
                err = int((as_uint32(kernel) - as_uint32(plain)).abs().max())
                live_err = max(live_err, err)
                check(err == 0, f"live shape {shape}: kernel != plain")
                check(words_to_digests(kernel) == raw,
                      f"live shape {shape}: replay != the live launch")
                replayed += 1
    check(sum(live_shapes.values()) == sum(
        r["wrapper_launches"] for r in live_cuda
    ), "live rung: launches whose shape the audit did not see")
    max_err = max(max_err, live_err)
    # Each live shape timed on its first kept launch's preimages, through
    # the entry point, beside its floors; launches x gap over round 1.
    live_per_shape = []
    for shape in sorted(first_kept):
        packed = pack_preimages(first_kept[shape])
        blocks, n_blocks = to_tensors(packed, "cuda")
        ms, call_ms = time_device(
            lambda: sha256_digest_words(blocks, n_blocks), 200
        )
        cost = digest_cost(packed, ms, sms)
        launches = round0_shapes.get(shape, 0)
        live_per_shape.append(dict(
            shape=[*shape, 16], ms=ms, call_ms=call_ms, **cost,
            launches_live=launches, launches_x_gap_ms=launches * cost["gap_ms"],
        ))
        print(f"  live shape {shape}: {ms:.6f} ms a launch, "
              + describe_cost(cost, ms)
              + f"; {launches} launches in round 1 x gap "
              f"{launches * cost['gap_ms']:.6f} ms")
    live_gap_ms = sum(e["launches_x_gap_ms"] for e in live_per_shape)
    print(
        "phase 11 ok: the live rung reached "
        f"{port_bench.LIVE.target_commits} commits under "
        f"{', '.join(PHASE11_KINDS)} in "
        f"{args.live_rounds} round(s), no "
        "request committed twice, the chains agree; committed req/s "
        + ", ".join(f"{r['kind']} {r['rate']:.3f}" for r in live)
        + "; p95 ms "
        + ", ".join(f"{r['kind']} {r['p95_ms']:.3f}" for r in live)
        + " (in round order)"
        + f"; {sum(live_shapes.values())} SHA-256 launches in "
        f"{len(live_shapes)} packed shapes (rows, blocks): "
        + ", ".join(f"{shape} x{n}" for shape, n in sorted(live_shapes.items()))
        + f"; {replayed} of them kept: read-back digests == hashlib, "
        f"replay kernel == plain == hashlib, max_abs_err {live_err}; "
        f"launches x gap over round 1's shapes {live_gap_ms:.6f} ms (done "
        f"at {time.perf_counter() - t0:.1f} s)"
    )

    # -- phase 12: the ack plane's kernels == plain; the anchor on them -----
    from mirbft_tpu_torch.obsv import device as obsv_device
    from mirbft_tpu_torch.obsv.metrics import Registry
    from mirbft_tpu_torch.ops import ack_plane

    ack_cases = [compare_ack(rows, limbs)
                 for rows in (1024, 4096, 65536) for limbs in (1, 2, 3)]
    for c in ack_cases:
        print(f"  ack plane ({c['rows']} rows, {c['limbs']} limbs): kernel "
              f"== plain; rows {c['classes']}; sweep {c['sweep']}")
    for rows in ACK_CROSSING_ROWS:
        crossing, nth = compare_crossing(rows)
        print(f"  ack step, crossing case ({rows} rows): kernel == plain; "
              f"rows {crossing} (adopt, applied, fallback) adopt, fall back,"
              f" apply; each its thread's row {nth} (0 the first)")
    ack_step_fn = ack_plane.ack_step
    ack_step_fn.launches = 0
    ack_step_fn.launches_by_rows.clear()
    sha256_digest_words.launches = 0
    plane = AsyncKernelHashPlane()
    result = port_bench.ladder_run(
        plane, reqs_per_client=ANCHOR_REQS, ready_latency=None,
        ack_plane="device", ack_device="cuda",
    )
    wall, events, _chain, _sim = result
    chains, counts = result.chains, result.counts
    anchor_steps = dict(ack_step_fn.launches_by_rows)
    check(events == 2320, f"device-plane anchor gave {events} events")
    check(chains == anchor_chains,
          "device-plane anchor: app chains differ from phase 3's")
    check(all(count == CLIENTS * ANCHOR_REQS for count in counts),
          "device-plane anchor: not every node committed 1600 requests")
    check(ack_step_fn.launches > 0, "device-plane anchor: no ack step launched")
    check(sha256_digest_words.launches > 0 and plane.host_digests == 0,
          "device-plane anchor: digests did not all come from the kernel")
    print(
        f"phase 12 ok: the ack plane's step and sweep == plain at "
        f"{len(ack_cases)} cases (1024/4096/65536 rows x limbs 1/2/3) and "
        f"the crossing case at {ACK_CROSSING_ROWS} rows, "
        f"max_abs_err 0; device-plane anchor {NODES}x{CLIENTS}x{ANCHOR_REQS} "
        f"-> {events} events in {wall:.3f} s, phase 3's chain "
        f"{next(iter(chains.values())).hex()[:16]}..., "
        f"{ack_step_fn.launches} ack steps by padded rows {anchor_steps} "
        f"(done at {time.perf_counter() - t0:.1f} s)"
    )

    # -- phase 13: the ack-plane rung at 100,000 clients ----------------------
    from mirbft_tpu_torch.ops import tally as tally_ops

    registry = Registry()
    obsv_device.reset()
    ack_step_fn.launches = 0
    ack_step_fn.launches_by_rows.clear()
    ack_plane.quorum_sweep.launches = 0
    ack_plane.quorum_sweep.launches_by_rows.clear()
    tally_ops.shard_sum.launches = 0
    rung = port_bench.ackplane_run(registry, device="cuda")
    rung_launches = {"ack_step": ack_step_fn.launches,
                     "ack_sweep": ack_plane.quorum_sweep.launches,
                     "shard_sum": tally_ops.shard_sum.launches}
    rung_step_rows = dict(ack_step_fn.launches_by_rows)
    n_clients = rung["clients"]
    check(rung["fallback_rows"] == 0, f"rung: {rung['fallback_rows']} "
          "fallback rows")
    check(rung["dropped_rows"] == 0, f"rung: {rung['dropped_rows']} dropped")
    check(rung["divergences"] == 0, f"rung: {rung['divergences']} divergences")
    check(rung["parity_mismatches"] == 0,
          f"rung: {rung['parity_mismatches']} parity mismatches")
    # Three agreeing sources certify every single-slot client at f = 1
    # (weak f + 1 = 2, strong 2f + 1 = 3).
    check(rung["strong_certs"] == n_clients and rung["weak_certs"] == n_clients,
          f"rung: {rung['weak_certs']} weak, {rung['strong_certs']} strong "
          f"certificates of {n_clients} clients")
    # The plane's mesh is the one card: a flush launches its step and a
    # sweep its sweep, and nothing is summed across shards.
    check(rung_launches["ack_step"] == rung["step_launches"] == 24
          and rung_launches["ack_sweep"] == 1
          and rung_launches["shard_sum"] == 0,
          f"rung: launches {rung_launches}")
    capture = obsv_device.report(registry)
    print(
        f"  rung: {n_clients} clients, {rung['events_total']} ack events; "
        f"host {rung['host_events_per_sec']:.3f} events/s, device "
        f"{rung['device_events_per_sec']:.3f} events/s (device/host "
        f"{rung['device_vs_host']:.6f}); committed "
        f"{rung['committed_reqs_per_sec']:.3f} req/s; drain "
        f"{rung['drain_seconds']:.6f} s, sweep {rung['sweep_seconds']:.6f} s;"
        f" host build {rung['host_build_s']:.6f} s, device build "
        f"{rung['device_build_s']:.6f} s, first frame "
        f"{rung['device_compile_s']:.6f} s; plane {rung['plane']}; "
        f"{rung['strong_certs']} strong, {rung['weak_certs']} weak; launches "
        f"{rung_launches}, steps by padded rows {rung_step_rows}; programs "
        f"by CUDA events in the run {capture['kernel_seconds']}, launch "
        f"shapes {capture['retraces']}"
    )

    # Each kernel on the rung's own batches and at the anchor's shape, held
    # against its plain version there first, then timed.
    c_pad, w_pad = rung["plane"]["c_pad"], rung["plane"]["w_pad"]
    rung_kw = dict(weak_q=2, strong_q=3)
    ack_shapes = []
    for source in port_bench.ACKPLANE_SOURCES:
        state0, batch = rung_step_inputs(n_clients, source, c_pad, w_pad)
        _out, _kernel_state, after = compare_step(
            f"ack step, rung source {source}", state0, batch, rung_kw
        )
        step_bytes = ack_plane.step_bytes(batch, state0, after)
        first = ack_plane.new_first(c_pad * w_pad, "cuda")

        def fresh(state0=state0, batch=batch):
            return [t.clone() for t in state0] + [batch]

        ms = time_events(fresh, lambda *a, first=first: ack_plane.ack_step(
            *a, first=first, **rung_kw))
        plain_ms = time_wall(fresh, lambda *a: ack_plane.ack_step_plain(
            *a, **rung_kw))
        ack_shapes.append({
            "what": f"rung source {source}", "rows": batch.shape[0],
            "state": [c_pad, w_pad, 1], "ms": ms, "plain_ms": plain_ms,
            "launch_floor_ms": launch_floor(batch.shape[0]),
            "bytes": step_bytes,
            "bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
        })
    cases = ack_plane_cases()
    anchor_rows = max(anchor_steps, key=anchor_steps.get)
    # The anchor's plane: 64 clients of windows of 101 padded to 128 slots.
    anchor_case = cases.make_case(SEED, anchor_rows, 1, c_pad=CLIENTS,
                                  w_pad=ANCHOR_W_PAD)
    anchor_state = cases.torch_state(anchor_case, "cuda")
    anchor_batch = cases.torch_batch(anchor_case, "cuda")
    anchor_first = ack_plane.new_first(CLIENTS * ANCHOR_W_PAD, "cuda")

    def fresh_anchor():
        return [t.clone() for t in anchor_state] + [anchor_batch]

    kw = dict(weak_q=anchor_case["weak_q"], strong_q=anchor_case["strong_q"])
    _out, _kernel_state, after = compare_step(
        f"ack step, anchor shape ({anchor_rows} rows)", anchor_state,
        anchor_batch, kw,
    )
    step_bytes = ack_plane.step_bytes(anchor_batch, anchor_state, after)
    ack_shapes.append({
        "what": "anchor shape, a seeded case", "rows": anchor_rows,
        "state": [CLIENTS, ANCHOR_W_PAD, 1],
        "ms": time_events(fresh_anchor, lambda *a: ack_plane.ack_step(
            *a, first=anchor_first, **kw)),
        "plain_ms": time_wall(fresh_anchor, lambda *a: ack_plane.ack_step_plain(
            *a, **kw)),
        "launch_floor_ms": launch_floor(anchor_rows),
        "bytes": step_bytes,
        "bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
    })
    sweep_state, _batch = rung_step_inputs(n_clients, 3, c_pad, w_pad)
    sweep_state[0][:] = 0b1110  # every live slot certified, as at the end
    sweep_totals = compare_sweep(
        "ack sweep, the rung's final state",
        [t.clone() for t in sweep_state], [t.clone() for t in sweep_state],
        rung_kw,
    )
    check(sweep_totals == [n_clients, n_clients, 0],
          f"ack sweep, the rung's final state: totals {sweep_totals}")
    sweep_cases = [(plane, compare_sweep_plane(*plane))
                   for plane in ack_plane_cases().SWEEP_ON_CARD]
    sweep_args = [sweep_state[i] for i in (0, 3, 4, 5, 6)]

    def fresh_sweep():
        return [t.clone() for t in sweep_args]

    sweep_ms = time_events(fresh_sweep, lambda *a: ack_plane.quorum_sweep(
        *a, **rung_kw))
    sweep_plain_ms = time_wall(fresh_sweep, lambda *a: (
        ack_plane.quorum_sweep_plain(*a, **rung_kw)))
    sweep_bytes = ack_plane.sweep_bytes(*(sweep_state[i] for i in (0, 3, 4)))
    sweep_bound_ms = sweep_bytes / HBM_BYTES_PER_S * 1e3
    # The empty kernel launched as the sweep is: its grid, an ordinary
    # launch.
    sweep_floor_ms = time_events(
        lambda: [], lambda: ack_plane.empty_sweep(c_pad * w_pad))
    sweep_grid = ack_plane.sweep_grid(c_pad * w_pad)
    for e in ack_shapes:
        print(f"  ack step, {e['what']}: ({e['rows']} rows) on state "
              f"{e['state']}: kernel {e['ms']:.6f} ms (CUDA events, median "
              f"of 20, one launch), launch floor {e['launch_floor_ms']:.6f} "
              f"ms (the empty kernel launched as the step is, timed the "
              f"same way), bound {e['bound_ms']:.6f} ms "
              f"({e['bytes']} bytes / 3.35 TB/s), "
              f"{100 * e['bound_ms'] / e['ms']:.2f}% of bound; plain "
              f"{e['plain_ms']:.6f} ms (wall)")
    for (slots, limbs, plane), totals in sweep_cases:
        print(f"  ack sweep ({slots} slots, {limbs} limbs, {plane}): kernel "
              f"== plain twice in a row, one launch each; totals {totals}")
    print(f"  ack sweep on the rung's final state {[c_pad, w_pad, 1]}: "
          f"kernel {sweep_ms:.6f} ms, launch floor {sweep_floor_ms:.6f} ms "
          f"(the empty kernel launched as the sweep is: "
          f"{sweep_grid[0]} blocks of {sweep_grid[1]}, {sweep_grid[2]} "
          f"slots a thread, an ordinary launch), "
          f"bound {sweep_bound_ms:.6f} ms "
          f"({sweep_bytes} bytes / 3.35 TB/s), "
          f"{100 * sweep_bound_ms / sweep_ms:.2f}% of bound; plain "
          f"{sweep_plain_ms:.6f} ms (wall); library_ms null for both (no "
          f"PyTorch call computes either function)")
    rung_step_ms = statistics.mean(e["ms"] for e in ack_shapes[:3])
    rung_step_bound = statistics.mean(e["bound_ms"] for e in ack_shapes[:3])
    rung_step_plain = statistics.mean(e["plain_ms"] for e in ack_shapes[:3])
    rung_step_floor = statistics.mean(
        e["launch_floor_ms"] for e in ack_shapes[:3])
    print(f"phase 13 ok: the ack-plane rung at {n_clients} clients, 0 "
          f"fallback, 0 dropped, 0 divergences, 0 parity mismatches, every "
          f"client weak and strong; step kernel == plain on the rung's three "
          f"batches and at the anchor's shape, sweep kernel == plain on the "
          f"rung's final state and on {len(sweep_cases)} seeded planes; "
          f"step {rung_step_ms:.6f} ms a launch "
          f"(mean of the rung's three sources) x {rung_launches['ack_step']}"
          f" launches, sweep {sweep_ms:.6f} ms x "
          f"{rung_launches['ack_sweep']} (done at "
          f"{time.perf_counter() - t0:.1f} s)")

    bls = bls_phases(sms, t0)
    service = service_phases(t0)
    observed = obsv_phases(t0)
    chaos = chaos_phases(t0)
    cluster = cluster_phases(t0)
    par = parallel_phases(t0, anchor_chains)
    bench_phase(t0)

    head = per_shape[0]
    kernels = [{
        "name": "sha256_digest",
        "route": "cuda",
        "source": "mirbft_tpu_torch/csrc/sha256.cu",
        "replaces": "mirbft_tpu/ops/sha256_pallas.py:102",
        "launches": rung2_launches,
        "launches_rung3": rung3_launches["sha256_digest"],
        "launches_live": live_launches,
        "launches_ingress": service["ingress_launches"]["sha256_digest"],
        "launches_app": service["app_launches"]["sha256_digest"],
        "launches_obsv_engine": observed["engine"],
        "launches_live_traced": observed["live"],
        "launches_ingress_traced": observed["ingress"]["sha256_digest"],
        "launches_soak": observed["soak"],
        "launches_chaos": chaos["det"]["sha256_digest"],
        "launches_chaos_live": chaos["live"]["sha256_digest"],
        "launches_flood": chaos["flood"],
        "launches_cluster": cluster["launches_sha256"],
        "live_shapes": [
            [*shape, n] for shape, n in sorted(live_shapes.items())
        ],
        "live_per_shape": live_per_shape,
        "matched_plain": max_err == 0,
        "max_abs_err": max_err,
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": None,
        "chain_floor_ms": head["chain_floor_ms"],
        "shape": head["shape"],
        "per_shape": per_shape,
        "ptxas": ptxas.get("mirbft_sha256_digest_kernel"),
        "ptxas_specialised": ptxas.get("mirbft_sha256_digest_ws_kernel"),
    }]
    for name, replaces in (
        ("ed25519_decompress", "mirbft_tpu/ops/ed25519_pallas.py:410"),
        ("ed25519_ladder", "mirbft_tpu/ops/ed25519_pallas.py:356"),
    ):
        shapes = ed_shapes[name]
        head = shapes[0]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "mirbft_tpu_torch/csrc/ed25519.cu",
            "replaces": replaces,
            "launches": rung3_launches[name],
            "launches_ingress": service["ingress_launches"][name],
            "launches_ingress_traced": observed["ingress"][name],
            "launches_chaos": chaos["det"][name],
            "launches_chaos_live": chaos["live"][name],
            "ingress_rows_replayed": service["replayed"],
            "matched_plain": ed_err == 0 and service["ingress_err"] == 0,
            "max_abs_err": max(ed_err, service["ingress_err"]),
            "ms": head["ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "library_ms": None,
            "chain_floor_ms": head["chain_floor_ms"],
            "shape": [head["rows"]],
            "per_shape": shapes,
            "ptxas": ptxas.get(f"mirbft_{name}_kernel"),
            "dynamic_smem_bytes": dynamic.get(f"mirbft_{name}_kernel", 0),
        })
    shapes = ed_shapes["ed25519_ladder_extended"]
    head = shapes[0]
    kernels.append({
        "name": "ed25519_ladder_extended",
        "route": "cuda",
        "source": "mirbft_tpu_torch/csrc/ed25519.cu",
        "replaces": "mirbft_tpu/ops/ed25519_pallas.py:341",
        "launches": par["x4_extended_launches"],
        "launches_note": "phase 23b: sharded_ed25519_verify on [cuda:0] "
                         "and [cuda:0] * 4, a launch a shard",
        "matched_plain": ed_err == 0,
        "max_abs_err": ed_err,
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": None,
        "chain_floor_ms": head["chain_floor_ms"],
        "shape": [head["rows"]],
        "per_shape": shapes,
        "marshal_us": marshal_us,
        "ptxas": ptxas.get("mirbft_ed25519_ladder_extended_kernel"),
        "dynamic_smem_bytes": dynamic["mirbft_ed25519_ladder_extended_kernel"],
    })
    kernels.insert(1, {
        "name": "sha256_chain",
        "route": "cuda",
        "source": "mirbft_tpu_torch/csrc/sha256.cu",
        "replaces": "mirbft_tpu/ops/sha256_pallas.py:121",
        "launches": chain_launches,
        "launches_note": "the kernel microbenchmark's; no system path "
                         "launches it",
        "matched_plain": chain_err == 0,
        "max_abs_err": chain_err,
        "ms": chain_ms,
        "plain_ms": chain_plain_ms,
        "plain_iters": CHAIN_PLAIN_ITERS,
        "bound_ms": chain_bound_ms,
        "bound_by": chain_bound_by,
        "chain_floor_ms": chain_floor_ms,
        "library_ms": None,
        "shape": [micro["batch"], 16],
        "iters": micro["iters"],
        "rep_ms": micro["rep_ms"],
        "chain_rate": micro["chain_rate"],
        "int_ops": chain_ops,
        "sm_clock_mhz": clock,
        "ptxas": ptxas.get("mirbft_sha256_chain_kernel"),
    })
    kernels.append({
        "name": "ack_step",
        "route": "cuda",
        "source": "mirbft_tpu_torch/csrc/ack_plane.cu",
        "replaces": "mirbft_tpu/core/device_tracker.py:169",
        "launches": rung_launches["ack_step"],
        "launches_note": "one count a step, and one kernel launch a step "
                         "(classify, apply and finish in one cooperative "
                         "grid), phase 13's rung",
        "design": "cooperative grid: one launch, a block of 256 threads a "
                  "256 rows up to the blocks the card holds at once, grid "
                  "barriers between the phases, a thread's first 8 rows "
                  "in registers and any later row's class in its output "
                  "word (a cluster of up to 8 blocks was slower: 8 SMs)",
        "step_grid_threads": ack_plane.step_grid(ack_shapes[0]["rows"])[0],
        "launches_anchor": sum(anchor_steps.values()),
        "matched_plain": True,
        "max_abs_err": 0,
        "ms": rung_step_ms,
        "plain_ms": rung_step_plain,
        "bound_ms": rung_step_bound,
        "bound_by": "bytes",
        "library_ms": None,
        "launch_floor_ms": rung_step_floor,
        "shape": [ack_shapes[0]["rows"], 12],
        "per_shape": ack_shapes,
        "ptxas": {"mirbft_ack_step_kernel":
                  ptxas.get("mirbft_ack_step_kernel")},
    })
    kernels.append({
        "name": "ack_sweep",
        "route": "cuda",
        "source": "mirbft_tpu_torch/csrc/ack_plane.cu",
        "replaces": "mirbft_tpu/core/device_tracker.py:342",
        "launches": rung_launches["ack_sweep"],
        "matched_plain": True,
        "max_abs_err": 0,
        "ms": sweep_ms,
        "plain_ms": sweep_plain_ms,
        "bound_ms": sweep_bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
        "launch_floor_ms": sweep_floor_ms,
        "shape": [c_pad, w_pad, 1],
        "grid": list(sweep_grid),
        "ptxas": ptxas.get("mirbft_ack_sweep_kernel"),
    })
    bls_head = bls["shapes"][0]
    kernels.append({
        "name": "bls_aggregate",
        "route": "cuda",
        "source": "mirbft_tpu_torch/csrc/bls_g1.cu",
        "replaces": "mirbft_tpu/ops/bls_g1.py:182",
        "launches": bls["launches"],
        "launches_note": "phase 15's rung 4 (one launch a batch of pending "
                         "certificates)",
        "launches_chaos": chaos["det"]["bls_aggregate"],
        "launches_chaos_live": chaos["live"]["bls_aggregate"],
        "matched_plain": True,
        "max_abs_err": 0,
        "ms": bls_head["ms"],
        "plain_ms": bls_head["plain_ms"],
        "bound_ms": bls_head["bound_ms"],
        "bound_by": bls_head["bound_by"],
        "library_ms": None,
        "chain_floor_ms": bls_head["chain_floor_ms"],
        "chain_floor_share": bls_head["chain_floor_share"],
        "shape": bls_head["shape"],
        "per_shape": bls["shapes"],
        "rung4_ms": bls["rung4_ms"],
        "sm_clock_mhz": bls["clock"],
        "ptxas": ptxas.get("mirbft_bls_g1_aggregate_kernel"),
    })
    for name, replaces in (
        ("tally_columns", "mirbft_tpu/parallel/sharding.py:128"),
        ("shard_sum", "mirbft_tpu/parallel/sharding.py:129"),
    ):
        line = par[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "mirbft_tpu_torch/csrc/parallel.cu",
            "replaces": replaces,
            "launches": par["launches"][name],
            "launches_note": "phase 23's main path: the device-plane anchor "
                             "on [cuda:0] * 4, entry() and "
                             "dryrun_multichip(4) on [cuda:0] * 4",
            "launches_anchor": par["anchor_launches"][name],
            "matched_plain": True,
            "max_abs_err": 0,
            **{key: line["head"][key] for key in (
                "ms", "plain_ms", "bound_ms", "library_ms",
                "launch_floor_ms", "shape")},
            "bound_by": "bytes",
            "per_shape": line["shapes"],
            "ptxas": ptxas.get(f"mirbft_{name}_kernel"),
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
