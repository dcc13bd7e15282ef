"""Drive the PyTorch port on one NVIDIA card, end to end, and check it.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit:

    python3 chip_smoke.py [--profile PATH] [--live-rounds N]

Phases (any failure raises and the script exits nonzero):

1. print the card's name and power limit; build the SHA-256 (digest and
   chain) and Ed25519 kernels from ``mirbft_tpu_torch/csrc/{sha256,ed25519}.cu``
   (one ``nvcc`` each, started together) and print ptxas's register and
   spill report;
2. hold the SHA-256 kernel against its plain PyTorch version and hashlib,
   bit for bit: block-boundary lengths, rows with fewer blocks than the
   bucket, padding rows, and the main path's two launch shapes,
   (8192, 1, 16) and (256, 128, 16);
3. the determinism anchor: 16 nodes x 64 clients x 25 requests, BatchSize
   200, every digest from the kernel: 2320 events, one app chain, 1600
   commits per node;
4. the main path at ladder rung 2 (16 nodes, 64 clients x 100 requests,
   BatchSize 200, ready_latency 400 ms): the host plane and the kernel
   plane in ten pairs of alternating order (host, kernel, kernel, host,
   ...); events, app chains and committed sequences must be equal, the
   kernel must have launched, and no digest may come from the host.  Each
   run starts after a full collection of the earlier runs' garbage and
   prints its wall, the CPU seconds of the process and of its main thread,
   the seconds in the cyclic collector, and the plane's host seconds at
   submit, at launch and blocked at flush; with ``--profile PATH`` one more host run and one more kernel
   run go under cProfile and their top functions are written to PATH;
5. the SHA-256 kernel's time at both launch shapes (CUDA events over many
   launches after a warm-up) beside its bound and the plain version's time;
6. the rung-3 clients sign their requests (a process pool, before any
   clock); then both Ed25519 kernels against their plain versions and the
   RFC 8032 oracle on one corpus, launched at exactly n = 8, 256, 512, 1024
   and 4096 rows (256 and 512 are the main path's launches in phases 7 and
   8): valid signatures, corrupted R, corrupted S, wrong messages, keys
   with no square root, x = 0 with the sign bit set, small-order keys (the
   identity, a point of order 8), R with no root; host-rejected rows (y >=
   p, S >= L, bad lengths) come on top of the n and must not reach a
   kernel.  Verdicts and decompressed points must be equal;
7. a signed engine run, 16 nodes x 64 clients x 4 requests, BatchSize 200,
   with a forged request at every node: the async signature plane on the
   kernels against the host-oracle plane; equal events, app chains,
   committed sequences and recorded events, no forgery committed, every
   request rejected on the host or launched, at a shape phase 6 compared;
8. rung 3 at full scale (bench.py:671-760: 64 nodes, f = 21, 1024 signed
   clients x 8 requests, BatchSize 200) with the speculative signature
   plane and the kernel hash plane: the event count and app chain head of
   the JAX package's own run, 8192 commits on every node, every verify and
   every digest on the card; committed req/s, the verify p99, the kernels'
   device time and the card's idle share;
9. both Ed25519 kernels' times at n = 512, 1024 and 4096 (CUDA events over
   launches queued behind a spin kernel) beside their bounds, and the plain
   versions' times at n = 512;
10. the SHA-256 chain kernel against its plain version, exactly, at
    (1024, 16) and the ragged (1000, 16) blocks, at the full batch of
    32768 rows, and at the full 4096 iterations on 1000 rows; then the port's kernel microbenchmark at full size
    (``mirbft_tpu_torch.bench.kernel_microbench``: 32768 rows x 4096
    chained compressions x 4 reps): compressions/s, the kernel's time
    beside its bound, hashlib's rate;
11. the live rung (``mirbft_tpu_torch.bench.live_cluster_rate``, the JAX
    package's bench.py:122-131 settings unchanged: 4 nodes over loopback
    TCP, 16 clients x 110 requests, BatchSize 10, real fsyncs plus a 40 ms
    floor, to the 1600th commit) under each processor kind: serial, cuda,
    pool, cuda-pool, pipelined, cuda-pipelined.  Each must reach the
    target, commit no request twice and keep the nodes' chains agreeing;
    each cuda kind must launch every hash request and none on the host.
    Each node runs in a process of its own and counts its launches there
    from 0.  Every launch of the cuda kinds records its packed shape, and
    the first launches of each shape keep their preimages and the digests
    they read back: those digests must equal hashlib's, and each kept
    launch, replayed through the kernel at its shape, must equal the plain
    version and hashlib.  Committed req/s and p95 commit latency per kind.

It then prints the kernels as one JSON line, the card's name and power
limit, and, last, the result line the chip check reads.  Without a CUDA
card it prints nothing to stdout and exits 1.
"""

from __future__ import annotations

import argparse
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

SEED = 20261016
NODES, CLIENTS, BATCH_SIZE = 16, 64, 200
ANCHOR_REQS, RUNG2_REQS = 25, 100
READY_LATENCY_MS = 400
RUNG2_PAIRS = 10  # host/kernel pairs: the run-to-run spread is wide
SIGNED_REQS = 4  # phase 7: 16 nodes x 64 clients x 4 signed requests
FORGED_REQ_NO = 99
# The JAX package's own rung-3 run on a CPU (SpeculativeSignaturePlane with
# its host batch authority): tests/test_torch_signing.py::
# test_reference_rung3_anchor pins the same two numbers.
RUNG3_EVENTS = 43280
RUNG3_CHAIN = "12951e5407835b23b58650b2b28549b9404f5ecd6bafca472ff60a59b1f0e2cc"
ED25519_SHAPES = (512, 1024, 4096)  # signatures per launch, timed
# Phase 10: (rows, iterations) held against the plain version (on the
# host: its launches are all overhead), the last at the microbenchmark's
# full 4096 iterations; and the iterations the plain version is timed at
# on the full batch on the card (its 4096 would take about a minute of
# small launches).
CHAIN_COMPARED = ((1024, 16), (1000, 16), (32768, 8), (1000, 4096))
CHAIN_PLAIN_ITERS = 64
# Launch shapes held against the plain versions and the oracle: the timed
# ones, a small one, and phase 7's wave of 64 clients x 4 requests.
ED25519_COMPARED = (8, CLIENTS * SIGNED_REQS, *ED25519_SHAPES)
POOL_PROCESSES = 8
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


class GcTimer:
    """Seconds the cyclic collector spends while ``timing`` is set."""

    def __init__(self):
        self.seconds = 0.0
        self.timing = False
        self._start = 0.0
        gc.callbacks.append(self._on_gc)

    def _on_gc(self, phase, _info):
        if not self.timing:
            return
        if phase == "start":
            self._start = time.perf_counter()
        else:
            self.seconds += time.perf_counter() - self._start


GC_TIMER = GcTimer()


def run_engine(reqs_per_client, plane, ready_latency=None):
    """Drive the engine to full commitment; returns events, wall s,
    (process, main thread, collector) CPU s, app chains, committed
    sequences and per-node commit counts.

    The garbage of earlier runs is collected first, outside the clock: each
    recorder holds reference cycles, and a full collection of several dead
    ones inside a timed run costs seconds."""
    import torch

    from mirbft_tpu_torch.testengine import BasicRecorder, RuntimeParameters

    params = (
        RuntimeParameters(ready_latency=ready_latency)
        if ready_latency is not None else None
    )
    gc.collect()
    GC_TIMER.seconds, GC_TIMER.timing = 0.0, True
    cpu = (time.process_time(), time.thread_time())
    start = time.perf_counter()
    rec = BasicRecorder(
        NODES, CLIENTS, reqs_per_client, batch_size=BATCH_SIZE,
        params=params, hash_plane=plane, record=False,
    )
    events = rec.drain_clients(max_steps=20_000_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    cpu = (
        time.process_time() - cpu[0], time.thread_time() - cpu[1],
        GC_TIMER.seconds,
    )
    GC_TIMER.timing = False
    chains = {n: s.app_chain for n, s in rec.node_states.items()}
    committed = {n: list(s.committed_reqs) for n, s in rec.node_states.items()}
    counts = [rec.committed_at(n) for n in range(NODES)]
    return events, wall, cpu, chains, committed, counts


def profile_rung2(make_plane, path_label, out) -> None:
    """One rung-2 run under cProfile; its 40 costliest functions by own
    time go to ``out``."""
    profiler = cProfile.Profile()
    profiler.enable()
    events, wall, _cpu, _chains, _committed, _counts = run_engine(
        RUNG2_REQS, make_plane(), READY_LATENCY_MS
    )
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


def ptxas_report(text: str) -> dict:
    """{kernel name: (registers, stack bytes, spill store bytes, spill load
    bytes)} from nvcc's ``-Xptxas -v`` output."""
    report = {}
    for block in text.split("Compiling entry function ")[1:]:
        mangled = block.split("'")[1]
        name = re.search(r"mirbft_\w+?_kernel", mangled).group(0)
        stack, stores, loads = map(int, re.search(
            r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
            r"(\d+) bytes spill loads", block).groups())
        registers = int(re.search(r"Used (\d+) registers", block).group(1))
        report[name] = (registers, stack, stores, loads)
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


def order8_encoding() -> bytes:
    """A point of order 8: the torsion part of the first small-y point
    that has one."""
    from mirbft_tpu_torch.crypto import ed25519_host as host

    for y in range(2, 100):
        point = host.decompress(encode_point(y))
        if point is None:
            continue
        torsion = host.scalar_mult(host.L, point)
        if not host.point_equal(host.scalar_mult(4, torsion), host.IDENTITY):
            return host.compress(torsion)
    raise AssertionError("no point of order 8 found")


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
        (order8_encoding(), b"m", r_sig),  # A of order 8
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
    print(f"  ed25519 n={n}: {m} rows reach the kernels ({2 * m} points), "
          f"{len(rows) - m} rejected on the host, {accepted} accepted, "
          f"{sum(ok)} points decode: kernel == plain == oracle")
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
    over the INT32 instruction rate, and bytes over 3.35 TB/s."""
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
    }
    out = {}
    for name, (ops, moved) in shapes.items():
        ops_ms = ops / rate * 1e3
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        out[name] = dict(
            int_ops=ops, bytes=moved, ops_bound_ms=ops_ms,
            bytes_bound_ms=bytes_ms, bound_ms=max(ops_ms, bytes_ms),
            bound_by="operations" if ops_ms >= bytes_ms else "bytes",
        )
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", metavar="PATH",
                        help="write cProfile tables of a host and a kernel "
                        "rung-2 run to PATH")
    parser.add_argument("--live-rounds", type=int, default=1, metavar="N",
                        help="run phase 11's six kinds N times (a stall "
                        "fails the script; the kernels line reads round 1)")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is present", file=sys.stderr)
        return 1

    from mirbft_tpu_torch import _build
    from mirbft_tpu_torch.ops.batching import pack_preimages, to_tensors
    from mirbft_tpu_torch.ops.sha256 import (
        INT_OPS_PER_COMPRESSION,
        sha256_digest_words,
    )
    from mirbft_tpu_torch.testengine import BasicRecorder
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
    libs = _build.build_all(["sha256", "ed25519"])
    build_s = time.perf_counter() - t0
    print(f"phase 1 ok: sha256.cu (digest, chain) and ed25519.cu built for "
          f"sm_90a in "
          f"{build_s:.3f} s (one nvcc each, together)")
    ptxas = {}
    for name, lib in libs.items():
        text = lib.with_suffix(".ptxas.txt").read_text()
        for line in text.splitlines():
            print(f"  {line.strip()}")
        ptxas.update(ptxas_report(text))
    for kernel, (regs, stack, stores, loads) in sorted(ptxas.items()):
        print(f"  {kernel}: {regs} registers, {stack} bytes stack frame, "
              f"{stores} bytes spill stores, {loads} bytes spill loads")

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
    print(f"phase 2 ok: kernel == plain == hashlib, max_abs_err {max_err}")

    # -- phase 3: the 16x64x25 anchor on the kernel plane --------------------
    plane = AsyncKernelHashPlane()
    sha256_digest_words.launches = 0
    events, wall, _cpu, chains, _, counts = run_engine(ANCHOR_REQS, plane)
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
        events, wall, cpu, chains, committed, _counts = run_engine(
            RUNG2_REQS, plane, READY_LATENCY_MS
        )
        launches = sha256_digest_words.launches
        committed_reqs = CLIENTS * RUNG2_REQS
        kernel_ms = getattr(plane, "kernel_ms", 0.0)
        blocking_s = sum(plane.flush_wall_s)
        line = (
            f"  rung 2 {label}: {NODES}x{CLIENTS}x{RUNG2_REQS} BatchSize "
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
                f"demand flushes {plane.demand_flushes}"
            )
        else:
            line += f", digests host {plane.host_digests}"
        print(line)
        runs.append(dict(
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

    # -- phase 5: kernel time, bound, plain time -----------------------------
    per_shape = []
    for shape, packed in packed_by_shape.items():
        blocks, n_blocks = to_tensors(packed, "cuda")
        reps = 400 if shape[1] == 1 else 100
        ms, call_ms = time_device(
            lambda: sha256_digest_words(blocks, n_blocks), reps
        )
        clock = sm_clock_mhz()
        compressions = int(packed.n_blocks.sum())
        ops_ms = (
            compressions * INT_OPS_PER_COMPRESSION
            / (sms * INT32_LANES_PER_SM * clock * 1e6) * 1e3
        )
        moved = compressions * 64 + blocks.shape[0] * (4 + 32)
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
        plain_ms = time_plain(blocks, n_blocks)
        per_shape.append(dict(
            shape=list(shape), compressions=compressions, ms=ms,
            call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            ops_bound_ms=ops_ms, bytes_bound_ms=bytes_ms, sm_clock_mhz=clock,
            library_ms=None,
        ))
        print(
            f"  kernel time {shape}: {ms:.6f} ms over {reps} launches "
            f"({call_ms:.6f} ms a call on the host clock); bound "
            f"{bound_ms:.6f} ms ({bound_by}: {compressions} compressions x "
            f"{INT_OPS_PER_COMPRESSION} int ops / ({sms} SMs x "
            f"{INT32_LANES_PER_SM} INT32 lanes x {clock:.0f} MHz) = "
            f"{ops_ms:.6f} ms; {moved} bytes / 3.35 TB/s = {bytes_ms:.6f} "
            f"ms), {100 * bound_ms / ms:.2f}% of bound; plain {plain_ms:.3f} "
            "ms; library_ms null (no PyTorch call computes SHA-256)"
        )
    print("phase 5 ok")

    print(f"phase 5 done at {time.perf_counter() - t0:.1f} s")
    rung2_launches = main_launches

    from mirbft_tpu_torch.ops import ed25519
    from mirbft_tpu_torch.testengine import rung3
    from mirbft_tpu_torch.testengine.signing import (
        AsyncSignaturePlane,
        SignaturePlane,
        SpeculativeSignaturePlane,
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
    print(f"phase 6 ok: ed25519 kernels == plain == oracle at n = "
          f"{', '.join(map(str, ED25519_COMPARED))}; max_abs_err {ed_err} "
          f"(done at {time.perf_counter() - t0:.1f} s)")

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
    plane = SpeculativeSignaturePlane()
    gc.collect()
    sha256_digest_words.launches = 0
    ed25519.decompress.launches = ed25519.ladder.launches = 0
    GC_TIMER.seconds, GC_TIMER.timing = 0.0, True
    cpu = (time.process_time(), time.thread_time())
    start = time.perf_counter()
    rec = BasicRecorder(
        rung3.NODES, rung3.CLIENTS, rung3.REQS, batch_size=rung3.BATCH_SIZE,
        network_state=rung3.network_state(),
        signer=lambda cid, rn, _payload: presigned[(cid, rn)],
        signature_plane=plane, record=False,
    )
    events = rec.drain_clients(max_steps=50_000_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    cpu = (time.process_time() - cpu[0], time.thread_time() - cpu[1])
    GC_TIMER.timing = False
    rung3_launches = {
        "sha256_digest": sha256_digest_words.launches,
        "ed25519_decompress": ed25519.decompress.launches,
        "ed25519_ladder": ed25519.ladder.launches,
    }
    total = rung3.CLIENTS * rung3.REQS
    chains = {rec.node_states[n].app_chain.hex() for n in range(rung3.NODES)}
    hash_plane = rec.hash_plane
    check(events == RUNG3_EVENTS, f"rung 3: {events} events, not {RUNG3_EVENTS}")
    check(chains == {RUNG3_CHAIN}, f"rung 3: app chains {chains}")
    check(all(rec.committed_at(n) == total for n in range(rung3.NODES)),
          f"rung 3: not every node committed {total} requests")
    check(plane.speculative_evictions == 0, "rung 3: evictions")
    check(plane.device_verifies == total and plane.host_rejects == 0,
          f"rung 3: {plane.device_verifies} verifies on the card")
    check(set(plane.flush_sizes) <= set(ED25519_COMPARED),
          f"rung 3: bursts of {sorted(set(plane.flush_sizes))} rows")
    check(hash_plane.host_digests == 0, "rung 3: a digest on the host")
    check(all(count > 0 for count in rung3_launches.values()),
          f"rung 3: a kernel never launched: {rung3_launches}")
    device_ms = plane.kernel_ms + hash_plane.kernel_ms
    print(
        f"phase 8 ok: rung 3 {rung3.NODES} nodes x {rung3.CLIENTS} clients x "
        f"{rung3.REQS} BatchSize {rung3.BATCH_SIZE}: {events} events, chain "
        f"{RUNG3_CHAIN[:16]}..., {total} commits on every node; wall "
        f"{wall:.6f} s, {total / wall:.3f} committed req/s; verify p99 "
        f"{p99_ms(plane.flush_wall_s):.6f} ms over {len(plane.flush_wall_s)} "
        f"bursts (max {1e3 * max(plane.flush_wall_s):.6f} ms, sum "
        f"{sum(plane.flush_wall_s):.6f} s); verifies device "
        f"{plane.device_verifies} host rejects {plane.host_rejects}, evictions "
        f"{plane.speculative_evictions}, forced joins {plane.forced_joins}; "
        f"digests device {hash_plane.device_digests} host "
        f"{hash_plane.host_digests}; launches {rung3_launches}; device time "
        f"ed25519 {plane.kernel_ms:.6f} ms + sha256 "
        f"{hash_plane.kernel_ms:.6f} ms, card idle "
        f"{100 * (1 - device_ms / 1e3 / wall):.4f}% of wall; cpu process "
        f"{cpu[0]:.6f} s main thread {cpu[1]:.6f} s collector "
        f"{GC_TIMER.seconds:.6f} s; hash plane submit "
        f"{hash_plane.submit_s:.6f} s launch {hash_plane.launch_s:.6f} s "
        f"blocking {sum(hash_plane.flush_wall_s):.6f} s in "
        f"{hash_plane.launches} launches (done at "
        f"{time.perf_counter() - t0:.1f} s)"
    )

    # -- phase 9: Ed25519 kernel times, bounds, plain times ------------------
    ed_shapes = {"ed25519_decompress": [], "ed25519_ladder": []}
    for n in ED25519_SHAPES:
        marshalled = [
            ed25519.marshal_light(*rung3_row(presigned, key, i % 4))
            for i, key in enumerate(sorted(presigned)[:n])
        ]
        enc, s_words, k_words = (
            torch.from_numpy(a).to("cuda")
            for a in ed25519.pack_rows(marshalled)
        )
        xy, ok = ed25519.decompress(enc)
        dec_ms, dec_call = time_device(lambda: ed25519.decompress(enc), 50)
        lad_ms, lad_call = time_device(
            lambda: ed25519.ladder(xy, ok, s_words, k_words), 20
        )
        clock = sm_clock_mhz()
        bounds = ed25519_bounds(n, sms, clock)
        plain = {}
        if n == ED25519_SHAPES[0]:
            for name, fn in (
                ("decompress", lambda: ed25519.decompress_plain(enc)),
                ("ladder", lambda: ed25519.ladder_plain(xy, ok, s_words,
                                                        k_words)),
            ):
                torch.cuda.synchronize()
                start = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                plain[name] = (time.perf_counter() - start) * 1e3
        for name, ms, call_ms in (("decompress", dec_ms, dec_call),
                                  ("ladder", lad_ms, lad_call)):
            bound = bounds[name]
            ed_shapes["ed25519_" + name].append(dict(
                n=n, rows=2 * n if name == "decompress" else n, ms=ms,
                call_ms=call_ms, plain_ms=plain.get(name), library_ms=None,
                sm_clock_mhz=clock, **bound,
            ))
            print(
                f"  {name} n={n}: {ms:.6f} ms a launch ({call_ms:.6f} ms a "
                f"call on the host clock); bound {bound['bound_ms']:.6f} ms "
                f"({bound['bound_by']}: {bound['int_ops']} int ops / ({sms} "
                f"SMs x {INT32_LANES_PER_SM} INT32 lanes x {clock:.0f} MHz) "
                f"= {bound['ops_bound_ms']:.6f} ms; {bound['bytes']} bytes / "
                f"3.35 TB/s = {bound['bytes_bound_ms']:.6f} ms), "
                f"{100 * bound['bound_ms'] / ms:.2f}% of bound"
                + (f"; plain {plain[name]:.3f} ms" if plain else "")
                + "; library_ms null (no PyTorch call verifies Ed25519)"
            )
    print(f"phase 9 ok (done at {time.perf_counter() - t0:.1f} s)")

    # -- phase 10: the chain kernel and the kernel microbenchmark -----------
    from mirbft_tpu_torch import bench as port_bench
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
        f"{chain_bytes_ms:.6f} ms), {100 * chain_bound_ms / chain_ms:.2f}% "
        f"of bound; plain {chain_plain_ms:.3f} ms at {CHAIN_PLAIN_ITERS} "
        f"iterations of the full batch; library_ms null (no PyTorch call "
        f"computes SHA-256) (done at {time.perf_counter() - t0:.1f} s)"
    )

    # -- phase 11: the live rung under every processor kind -----------------
    # Each node runs in a process of its own; its wrapper's count starts at
    # 0 with the process and is read when the run stops.
    live = []
    for live_round, live_kind in (
        (r, k) for r in range(args.live_rounds) for k in port_bench.LIVE_KINDS
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
            check(result["wrapper_launches"] == result["launches"] > 0,
                  f"live {live_kind}: the wrappers counted "
                  f"{result['wrapper_launches']} launches, the processors "
                  f"{result['launches']}")
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

    # The launch audit: every shape the live launches had, each kept
    # launch's read-back digests against hashlib, and its replay through
    # the kernel (outside the counted runs) against plain and hashlib.
    from mirbft_tpu_torch.ops.sha256 import (
        sha256_digest_words_plain,
        words_to_digests,
    )

    iv_bytes = b"".join(word.to_bytes(4, "big") for word in IV)
    live_shapes: dict = {}
    live_err, replayed = 0, 0
    for result in live_cuda:
        for shape, (launches, kept) in result["samples"].items():
            check(kept, f"live {result['kind']}: {launches} launches of "
                  f"shape {shape}, none kept for the audit")
            live_shapes[shape] = live_shapes.get(shape, 0) + launches
            for preimages, raw in kept:
                want = b"".join(hashlib.sha256(m).digest() for m in preimages)
                pad_rows = shape[0] - len(preimages)
                check(raw == want + iv_bytes * pad_rows,
                      f"live {result['kind']}: a launch of shape {shape} "
                      "read back digests that are not hashlib's")
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
    print(
        "phase 11 ok: the live rung reached "
        f"{port_bench.LIVE.target_commits} commits under every kind in "
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
        f"replay kernel == plain == hashlib, max_abs_err {live_err} (done "
        f"at {time.perf_counter() - t0:.1f} s)"
    )

    head = per_shape[0]
    kernels = [{
        "name": "sha256_digest",
        "route": "cuda",
        "source": "mirbft_tpu_torch/csrc/sha256.cu",
        "replaces": "mirbft_tpu/ops/sha256_pallas.py:102",
        "launches": rung2_launches,
        "launches_rung3": rung3_launches["sha256_digest"],
        "launches_live": live_launches,
        "live_shapes": [
            [*shape, n] for shape, n in sorted(live_shapes.items())
        ],
        "matched_plain": max_err == 0,
        "max_abs_err": max_err,
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": None,
        "shape": head["shape"],
        "per_shape": per_shape,
        "ptxas": ptxas.get("mirbft_sha256_digest_kernel"),
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
            "matched_plain": ed_err == 0,
            "max_abs_err": ed_err,
            "ms": head["ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "library_ms": None,
            "shape": [head["rows"]],
            "per_shape": shapes,
            "ptxas": ptxas.get(f"mirbft_{name}_kernel"),
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
        "library_ms": None,
        "shape": [micro["batch"], 16],
        "iters": micro["iters"],
        "rep_ms": micro["rep_ms"],
        "chain_rate": micro["chain_rate"],
        "int_ops": chain_ops,
        "sm_clock_mhz": clock,
        "ptxas": ptxas.get("mirbft_sha256_chain_kernel"),
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
