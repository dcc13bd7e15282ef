"""The CUDA kernels on the card: SHA-256 bit-exact with its plain version
and hashlib, launched and counted on the engine's commit path; the two
Ed25519 kernels equal to their plain versions and the RFC 8032 oracle
(decompression also on the corpus that takes each of its branches), and
the signed engine run on them equal to the host-oracle run; the extended
ladder (the host route's) equal to its plain version, the oracle and the
device route; the ack plane's two kernels; and the BLS G1 aggregation
kernel equal to its plain version and the host fold, with no host fold
behind it; and the live
chaos campaign's two signed scenarios, whose Ed25519 kernels' plain
versions are too slow on a CPU for the live protocol's timers.

Marked ``gpu``: each test skips, with its reason, where no CUDA card is
present (the kernel has no CPU mode).  Run them on a machine with a card:

    python -m pytest tests/test_torch_chip.py -m gpu
"""

import hashlib
import random

import pytest
import torch

from ack_plane_cases import SWEEP_ON_CARD
from ed25519_corpus import decompression_corpus
from mirbft_tpu_torch import pb
from mirbft_tpu_torch.crypto import ed25519_host
from mirbft_tpu_torch.ops import ed25519
from mirbft_tpu_torch.ops import sha256 as port
from mirbft_tpu_torch.ops.batching import pack_preimages, to_tensors
from mirbft_tpu_torch.testengine import BasicRecorder
from mirbft_tpu_torch.testengine import signing
from mirbft_tpu_torch.testengine.crypto_plane import (
    AsyncKernelHashPlane,
    CoalescingHashPlane,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "lengths,block_floor,batch_floor",
    [
        ([0, 55, 56, 63, 64, 119, 120], 1, 8),
        ([random.Random(5).randrange(0, 900) for _ in range(100)], 32, 256),
        ([20] * 8192, 1, 8192),  # request digests, (8192, 1, 16)
        ([6400] * 256, 128, 256),  # BatchSize-200 batch digests
    ],
    ids=["boundaries", "ragged", "requests", "batches"],
)
def test_kernel_matches_plain_and_hashlib(card, lengths, block_floor, batch_floor):
    rng = random.Random(len(lengths))
    messages = [rng.randbytes(n) for n in lengths]
    packed = pack_preimages(
        messages, block_floor=block_floor, batch_floor=batch_floor
    )
    blocks, n_blocks = to_tensors(packed, card)
    before = port.sha256_digest_words.launches
    words = port.sha256_digest_words(blocks, n_blocks)
    torch.cuda.synchronize()
    assert port.sha256_digest_words.launches == before + 1
    assert torch.equal(words, port.sha256_digest_words_plain(blocks, n_blocks))
    raw = port.words_to_digests(words)
    for i, msg in enumerate(messages):
        assert raw[32 * i : 32 * i + 32] == hashlib.sha256(msg).digest()


# The shapes AsyncKernelHashPlane.rows_for gives the engine's buckets.
BUCKET_SHAPES = [(8192, 1), (8192, 2), (8192, 4), (4096, 8), (2048, 16),
                 (1024, 32), (512, 64), (256, 128)]


@pytest.mark.parametrize("rows,bucket", BUCKET_SHAPES,
                         ids=[f"{r}x{b}" for r, b in BUCKET_SHAPES])
def test_every_bucket_shape_matches_plain_and_hashlib(card, rows, bucket):
    """Ragged rows (1 block up to the bucket's last) and padding rows, at
    each shape the engine launches (the 1-block bucket takes the
    one-thread body, the others the warp-specialised one): the entry
    point, counted once, the plain version and hashlib agree."""
    rng = random.Random(rows * bucket)
    top = bucket * 64 - 9  # the longest message the bucket holds
    lengths = [rng.randrange(0, top + 1) for _ in range(rows - 40)] + [top]
    messages = [rng.randbytes(n) for n in lengths]
    packed = pack_preimages(messages, block_floor=bucket, batch_floor=rows)
    assert packed.blocks.shape == (rows, bucket, 16)
    blocks, n_blocks = to_tensors(packed, card)
    before = port.sha256_digest_words.launches
    words = port.sha256_digest_words(blocks, n_blocks)
    torch.cuda.synchronize()
    assert port.sha256_digest_words.launches == before + 1
    plain = port.sha256_digest_words_plain(blocks, n_blocks)
    assert torch.equal(words, plain)
    raw = port.words_to_digests(words)
    want = b"".join(hashlib.sha256(m).digest() for m in messages)
    assert raw[: len(want)] == want
    iv = port.words_to_digests(port._to_int32(torch.tensor([port._IV])))
    assert raw[len(want):] == iv * (rows - len(messages))


def test_kernel_plane_run_matches_host_plane(card):
    host = BasicRecorder(4, 2, 10, batch_size=2, hash_plane=CoalescingHashPlane())
    host_count = host.drain_clients(max_steps=100000)
    plane = AsyncKernelHashPlane(device=card, chunk_rows=16)
    kernel = BasicRecorder(4, 2, 10, batch_size=2, hash_plane=plane)
    assert kernel.drain_clients(max_steps=100000) == host_count
    for n in range(4):
        assert kernel.node_states[n].app_chain == host.node_states[n].app_chain
        assert (
            kernel.node_states[n].committed_reqs
            == host.node_states[n].committed_reqs
        )
    assert plane.launches > 0
    assert plane.host_digests == 0
    assert plane.kernel_ms > 0


def test_engine_default_plane_is_the_kernel_on_the_card(card):
    before = port.sha256_digest_words.launches
    recorder = BasicRecorder(4, 2, 10, batch_size=2)
    assert recorder.drain_clients(max_steps=100000) > 0
    plane = recorder.hash_plane
    assert isinstance(plane, AsyncKernelHashPlane)
    assert plane.device.type == "cuda"
    assert port.sha256_digest_words.launches - before == plane.launches > 0
    assert plane.host_digests == 0


def signature_corpus(n: int) -> tuple:
    """n rows that all reach the kernels: signatures (valid, corrupted R,
    corrupted S, wrong message in turn), then a key with no square root,
    the identity as key with a signature it satisfies, and x = 0 with the
    sign bit set; the first n of them (at least one signature)."""
    rng = random.Random(n)
    pks, msgs, sigs = [], [], []
    for i in range(max(n - 3, 1)):
        seed = rng.randbytes(32)
        msg = rng.randbytes(20)
        pk, sig = ed25519_host.public_key(seed), ed25519_host.sign(seed, msg)
        if i % 4 == 1:
            sig = bytes([sig[0] ^ 2]) + sig[1:]
        elif i % 4 == 2:
            sig = sig[:40] + bytes([sig[40] ^ 8]) + sig[41:]
        elif i % 4 == 3:
            msg += b"?"
        pks.append(pk)
        msgs.append(msg)
        sigs.append(sig)
    r_point = ed25519_host.scalar_mult(77, ed25519_host.to_extended(
        ed25519_host.BASE))
    r_sig = ed25519_host.compress(r_point) + (77).to_bytes(32, "little")
    for y_enc in (2, 1, 1 | 1 << 255):
        pks.append(y_enc.to_bytes(32, "little"))
        msgs.append(b"m")
        sigs.append(r_sig)
    return pks[:n], msgs[:n], sigs[:n]


# 256, 512: the main path's launches; 1, 3, 7, 513: quads that leave a
# warp or a block ragged; 4096: 128 blocks of 32 signatures.
@pytest.mark.parametrize("n", [1, 3, 7, 8, 256, 512, 513, 4096])
def test_ed25519_kernels_match_plain_and_oracle(card, n):
    pks, msgs, sigs = signature_corpus(n)
    rows = [ed25519.marshal_light(*t) for t in zip(pks, msgs, sigs)]
    assert len(rows) == n and None not in rows
    enc, s_words, k_words = (
        torch.from_numpy(a).to(card) for a in ed25519.pack_rows(rows)
    )
    before = (ed25519.decompress.launches, ed25519.ladder.launches)
    xy, ok = ed25519.decompress(enc)
    verdicts = ed25519.ladder(xy, ok, s_words, k_words)
    torch.cuda.synchronize()
    assert (ed25519.decompress.launches, ed25519.ladder.launches) == (
        before[0] + 1, before[1] + 1,
    )
    plain_xy, plain_ok = ed25519.decompress_plain(enc)
    assert torch.equal(xy, plain_xy) and torch.equal(ok, plain_ok)
    assert torch.equal(verdicts, ed25519.ladder_plain(xy, ok, s_words, k_words))
    encodings = pks + [sig[:32] for sig in sigs]
    for i, encoded in enumerate(encodings):
        point = ed25519_host.decompress(encoded)
        assert bool(ok[i]) == (point is not None)
        if point is not None:
            assert ed25519.limbs_to_int(xy[i, 0].cpu()) == point[0]
            assert ed25519.limbs_to_int(xy[i, 1].cpu()) == point[1]
    expect = [ed25519_host.verify(*t) for t in zip(pks, msgs, sigs)]
    assert verdicts.cpu().tolist() == [int(v) for v in expect]
    if n >= 4:
        assert any(expect) and not all(expect)  # forgeries among them
    assert ed25519.verify_batch(pks, msgs, sigs, device=card).tolist() == expect


# The host route at the device route's shapes: every row the host accepts
# (the corpus's corrupted R may not decompress), every other -A scaled to
# Z != 1 from the second half on.
@pytest.mark.parametrize("n", [1, 3, 7, 8, 256, 512, 513, 4096])
def test_extended_ladder_matches_plain_oracle_and_device_route(card, n):
    pks, msgs, sigs = signature_corpus(n)
    triples = list(zip(pks, msgs, sigs))
    marshalled = [ed25519.marshal_signature(*t) for t in triples]
    live = [i for i, m in enumerate(marshalled) if m is not None]
    rng = random.Random(n)
    rows = []
    for j, i in enumerate(live):
        s, k, neg_a, r = marshalled[i]
        if j % 2 and j >= len(live) // 2:
            lam = rng.randrange(2, ed25519.P)
            neg_a = tuple(c * lam % ed25519.P for c in neg_a)
        rows.append((s, k, neg_a, r))
    s_words, k_words, neg_a, r_xy = (
        torch.from_numpy(a).to(card)
        for a in ed25519.pack_signature_rows(rows)
    )
    before = ed25519.ladder_extended.launches
    verdicts = ed25519.ladder_extended(neg_a, r_xy, s_words, k_words)
    torch.cuda.synchronize()
    assert ed25519.ladder_extended.launches == before + 1
    assert torch.equal(verdicts, ed25519.ladder_extended_plain(
        neg_a, r_xy, s_words, k_words))
    expect = [ed25519_host.verify(*t) for t in triples]
    assert verdicts.cpu().tolist() == [int(expect[i]) for i in live]
    device_route = ed25519.verify_batch(pks, msgs, sigs, device=card)
    assert [device_route[i] for i in live] == [expect[i] for i in live]


# The decompression corpus (every branch of RFC 8032 5.1.3), repeated to m
# rows: 1, 3 and 7 leave a group's warp ragged, 8 fills one, 1024 and 8192
# are the main path's 512- and 4096-signature launches, 1025 one past.
@pytest.mark.parametrize("m", [1, 3, 7, 8, 1024, 1025, 8192])
def test_decompress_matches_plain_and_oracle_on_the_corpus(card, m):
    corpus = decompression_corpus()
    oracle = [ed25519_host.decompress(e) for e in corpus]
    encodings = (corpus * (m // len(corpus) + 1))[:m]
    enc = torch.from_numpy(ed25519._words(encodings)).to(card)
    before = ed25519.decompress.launches
    xy, ok = ed25519.decompress(enc)
    torch.cuda.synchronize()
    assert ed25519.decompress.launches == before + 1
    plain_xy, plain_ok = ed25519.decompress_plain(enc)
    assert torch.equal(xy, plain_xy) and torch.equal(ok, plain_ok)
    xy, ok = xy.cpu(), ok.cpu().tolist()
    for i in range(m):
        point = oracle[i % len(corpus)]
        assert ok[i] == (point is not None)
        if point is not None:
            assert ed25519.limbs_to_int(xy[i, 0]) == point[0]
            assert ed25519.limbs_to_int(xy[i, 1]) == point[1]


def test_signed_run_on_the_card_matches_the_host_run(card):
    def run(plane):
        recorder = BasicRecorder(
            4, 2, 5, signer=signing.make_signer(), signature_plane=plane,
        )
        forged = pb.Request(client_id=4, req_no=99, data=b"evil" + b"\x01" * 96)
        for node in range(4):
            recorder._schedule(
                0, node, pb.StateEvent(type=pb.EventPropose(request=forged))
            )
        events = recorder.drain_clients(max_steps=200000)
        return events, {
            n: (s.app_chain, list(s.committed_reqs))
            for n, s in recorder.node_states.items()
        }

    host_run = run(signing.SignaturePlane(signing.host_verifier))
    plane = signing.AsyncSignaturePlane(device=card)
    before = ed25519.ladder.launches
    assert run(plane) == host_run
    assert all(
        rn != 99 for _chain, reqs in host_run[1].values() for _c, rn, _s in reqs
    )
    assert plane.host_verifies == 0
    assert (plane.device_verifies, plane.host_rejects) == (10, 1)
    assert ed25519.ladder.launches - before == plane.launches > 0
    assert plane.kernel_ms > 0


@pytest.mark.parametrize(
    "batch,iters",
    [(1024, 1), (1024, 16), (1000, 3), (32768, 8)],
    ids=["tile", "tile-16", "ragged", "full-batch"],
)
def test_chain_kernel_matches_plain(card, batch, iters):
    generator = torch.Generator().manual_seed(batch + iters)
    block = torch.randint(
        -2**31, 2**31 - 1, (batch, 16), dtype=torch.int32,
        generator=generator,
    ).to(card)
    before = port.sha256_chain_checksum.launches
    got = port.sha256_chain_checksum(block, iters=iters)
    assert port.sha256_chain_checksum.launches == before + 1
    assert got.device.type == "cuda" and got.shape == ()
    want = port.sha256_chain_checksum_plain(block, iters=iters)
    assert int(got) == int(want)


def test_cuda_four_node_live_run_on_the_card(card):
    """The live rung's cluster, cut to 2 clients x 10 requests without the
    flush floor: 4 nodes, each in a process of its own, over TCP, every
    digest on the kernel; every launch's shape audited, and the kept
    launches' read-back digests equal hashlib's."""
    import dataclasses
    import hashlib

    from mirbft_tpu_torch.bench import LIVE, live_cluster_rate

    result = live_cluster_rate("cuda", device=card, settings=dataclasses.replace(
        LIVE, clients=2, reqs_per_client=10, target_commits=20,
        batch_size=1, tick_s=0.05, fsync_floor_s=0.0, deadline_s=60.0,
        checkpoint_interval=20, suspect_ticks=100,
    ))
    assert result["host_digests"] == 0
    assert result["device_digests"] == result["hash_requests"] > 0
    assert result["wrapper_launches"] == result["launches"] > 0
    assert result["kernel_ms"] > 0
    samples = result["samples"]
    assert sum(launches for launches, _kept in samples.values()) == (
        result["launches"]
    )
    for (rows, _blocks), (_launches, kept) in samples.items():
        assert kept
        for preimages, raw in kept:
            want = b"".join(hashlib.sha256(m).digest() for m in preimages)
            assert raw[: len(want)] == want and len(raw) == 32 * rows


# -- the device ack plane -------------------------------------------------------

ACK_CASES = [(1024, 1), (1024, 2), (4096, 3), (65536, 1)]


@pytest.mark.parametrize("rows,limbs", ACK_CASES,
                         ids=[f"rows{r}-limbs{l}" for r, l in ACK_CASES])
def test_ack_plane_kernels_equal_their_plain_versions(card, rows, limbs):
    """The step's one launch and the sweep on seeded cases holding
    every row class (tests/ack_plane_cases.py), against the plain versions
    on the same card, bit for bit: every state array, the packed row
    outputs, the sweep's totals and tick; the adoption scratch is empty
    again after the step; one launch counted each."""
    from ack_plane_cases import make_case, torch_batch, torch_state
    from mirbft_tpu_torch.ops import ack_plane

    case = make_case(rows * 13 + limbs, rows, limbs)
    kw = dict(weak_q=case["weak_q"], strong_q=case["strong_q"])
    kernel_state = torch_state(case, card)
    plain_state = torch_state(case, card)
    batch = torch_batch(case, card)
    first = ack_plane.new_first(case["c_pad"] * case["w_pad"], card)
    before = (ack_plane.ack_step.launches, ack_plane.quorum_sweep.launches)
    out = ack_plane.ack_step(*kernel_state, batch, first=first, **kw)
    want = ack_plane.ack_step_plain(*plain_state, batch, **kw)
    assert torch.equal(out, want)
    for got, expected in zip(kernel_state, plain_state):
        assert torch.equal(got, expected)
    assert bool((first == ack_plane.FIRST_NONE).all())
    totals = ack_plane.quorum_sweep(
        kernel_state[0], kernel_state[3], kernel_state[4], kernel_state[5],
        kernel_state[6], **kw,
    )
    plain_totals = ack_plane.quorum_sweep_plain(
        plain_state[0], plain_state[3], plain_state[4], plain_state[5],
        plain_state[6], **kw,
    )
    assert totals.tolist() == plain_totals.tolist()
    assert torch.equal(kernel_state[6], plain_state[6])
    assert (ack_plane.ack_step.launches,
            ack_plane.quorum_sweep.launches) == (before[0] + 1, before[1] + 1)


#: (rows, where the crossing case's last row falls on an H100's step
#: grid): "first" a thread's first row, "register" a later row the thread
#: keeps in registers, "output" a row past those, whose class waits in its
#: output word between the phases.
ACK_CROSSING = [(16384, "first"), (65536, "first"), (262144, "register"),
                (2097152, "output")]


@pytest.mark.parametrize("rows,where", ACK_CROSSING,
                         ids=[f"rows{r}" for r, _ in ACK_CROSSING])
def test_ack_step_adoption_across_the_cluster(card, rows, where):
    """The crossing case (tests/ack_plane_cases.py): one virgin slot hit by
    a row of the grid's first block, a row in the middle with another
    digest, and one of the last rows with the first digest, at every
    place a row can sit on the step's grid (``where``).  Kernel == plain
    bit for bit; the first row adopts, the middle one falls back, the last
    applies."""
    from ack_plane_cases import crossing_rows, make_crossing_case, torch_batch
    from ack_plane_cases import torch_state
    from mirbft_tpu_torch.ops import ack_plane

    threads, register_rows = ack_plane.step_grid(rows, card)
    nth = crossing_rows(rows)[-1] // threads
    assert where == ("first" if nth == 0 else
                     "register" if nth < register_rows else "output"), (
        threads, register_rows, nth)
    case = make_crossing_case(rows * 3 + 1, rows, 1)
    kw = dict(weak_q=case["weak_q"], strong_q=case["strong_q"])
    kernel_state = torch_state(case, card)
    plain_state = torch_state(case, card)
    batch = torch_batch(case, card)
    first = ack_plane.new_first(case["c_pad"] * case["w_pad"], card)
    out = ack_plane.ack_step(*kernel_state, batch, first=first, **kw)
    assert torch.equal(out, ack_plane.ack_step_plain(*plain_state, batch, **kw))
    for got, expected in zip(kernel_state, plain_state):
        assert torch.equal(got, expected)
    assert bool((first == ack_plane.FIRST_NONE).all())
    res = ack_plane.unpack_step(out.cpu())
    first_row, middle, last = crossing_rows(rows)
    assert [bool(res["adopt"][r]) for r in (first_row, middle, last)] == [
        True, False, False]
    assert [bool(res["applied"][r]) for r in (first_row, middle, last)] == [
        True, False, True]


@pytest.mark.parametrize("slots,limbs,kind", SWEEP_ON_CARD,
                         ids=[f"slots{s}-limbs{l}-{k}"
                              for s, l, k in SWEEP_ON_CARD])
def test_ack_sweep_kernel_equals_plain_twice_one_launch_each(card, slots,
                                                             limbs, kind):
    """tests/ack_plane_cases.py's ``SWEEP_ON_CARD`` planes (slots past a
    multiple of 16, limbs 1-4, the all-certified plane of 4096 slots a
    block, arrays off 16 bytes): the sweep kernel against its plain
    version on the same card, twice in a row (the second sweep after the
    first's ticket reset), the totals and the rewritten tick bit for bit
    each time, exactly one launch counted a sweep, and the grid the
    wrapper reports."""
    from ack_plane_cases import sweep_classes, sweep_on_card
    from mirbft_tpu_torch.ops import ack_plane

    case, kernel, plain = sweep_on_card(slots * 5 + limbs, slots, limbs,
                                        kind, card)
    if kind != "certified":
        assert all(sweep_classes(case).values())
    kw = dict(weak_q=case["weak_q"], strong_q=case["strong_q"])
    blocks, threads, group = ack_plane.sweep_grid(slots, card)
    assert (threads, group) == (256, 8)
    assert blocks == min(1024, -(-slots // (threads * group)))
    for _ in range(2):
        before = ack_plane.quorum_sweep.launches
        totals = ack_plane.quorum_sweep(*kernel, **kw)
        assert ack_plane.quorum_sweep.launches == before + 1
        want = ack_plane.quorum_sweep_plain(*plain, **kw)
        assert totals.tolist() == want.tolist()
        assert torch.equal(kernel[4], plain[4])
    if kind == "certified":
        assert totals.tolist() == [slots, slots, 0]


def _width_one_tracker(clients: int, device: str, flush_rows: int):
    from mirbft_tpu_torch.core.client_tracker import ClientTracker
    from mirbft_tpu_torch.core.msgbuffers import NodeBuffers
    from mirbft_tpu_torch.core.persisted import Persisted

    state = pb.NetworkState(
        config=pb.NetworkConfig(nodes=[0, 1, 2, 3], f=1, number_of_buckets=4,
                                checkpoint_interval=5, max_epoch_length=50),
        clients=[pb.NetworkClient(id=cid, width=1, low_watermark=0)
                 for cid in range(clients)],
    )
    persisted = Persisted()
    persisted.add_c_entry(pb.CEntry(seq_no=0, checkpoint_value=b"genesis",
                                    network_state=state))
    my = pb.InitialParameters(id=0, buffer_size=1 << 20)
    tracker = ClientTracker(persisted, NodeBuffers(my), my,
                            ack_plane="device", ack_device=device,
                            ack_flush_rows=flush_rows)
    tracker.reinitialize()
    return tracker


#: (clients, padded rows of the one coalesced step, which of its thread's
#: rows the last ack is on an H100's step grid at least).
COALESCED = [(40000, 131072, 0), (87000, 262144, 1)]


@pytest.mark.parametrize("clients,rows,nth", COALESCED,
                         ids=[f"rows{r}" for _, r, _ in COALESCED])
def test_device_plane_coalesced_flush_past_the_largest_bucket(card, clients,
                                                               rows, nth):
    """Three sources ack every one of ``clients`` width-1 clients, and the
    tracker's ``ack_flush_rows`` coalesces the three frames into one step
    of ``rows`` padded rows (past the 65536-row bucket) through
    ``DeviceClientPlane``.  Client 0's first ack is row 0 (it adopts); its
    ack from source 3, the batch's last row, carries another digest and
    falls back (the scalar path then holds its slot).  Against the same storm on the plane's plain version: one
    step each, the same counters, state and sweep; the oracle finds
    nothing."""
    import numpy as np

    from mirbft_tpu_torch.core.device_tracker import batch_rows
    from mirbft_tpu_torch.obsv import shadow
    from mirbft_tpu_torch.ops import ack_plane

    n = 3 * clients
    assert batch_rows(n) == rows
    threads, _ = ack_plane.step_grid(rows, card)
    assert (n - 1) // threads >= nth, (threads, n)
    rng = np.random.default_rng(clients)
    digests = rng.integers(0, 256, size=(clients, 32), dtype=np.uint8)
    other = bytes(rng.integers(0, 256, size=32, dtype=np.uint8))
    frames = {}
    for source in (1, 2, 3):
        order = (np.arange(clients) if source == 1
                 else rng.permutation(clients))
        if source == 3:
            order = np.concatenate([order[order != 0], [0]])
        frames[source] = [
            pb.Msg(type=pb.RequestAck(
                client_id=int(c), req_no=0,
                digest=other if (source, c) == (3, 0)
                else digests[c].tobytes()))
            for c in order.tolist()]
    planes = {}
    for device in ("cuda", "cpu"):
        tracker = _width_one_tracker(clients, device, flush_rows=n)
        before = (ack_plane.ack_step.launches,
                  ack_plane.ack_step.launches_by_rows[rows])
        for source in (1, 2, 3):
            tracker.step_ack_many(source, frames[source])
        plane = tracker._device
        if device == "cuda":
            assert (ack_plane.ack_step.launches,
                    ack_plane.ack_step.launches_by_rows[rows]) == (
                        before[0] + 1, before[1] + 1)
            assert shadow.audit_tracker(tracker) == []
        planes[device] = (
            plane.batches, plane.acks_applied, plane.acks_fallback,
            {k: v.copy() for k, v in plane.host_snapshot().items()},
            plane.quorum_sweep(),
        )
    cuda, cpu = planes["cuda"], planes["cpu"]
    assert cuda[:3] == cpu[:3] == (1, n - 1, 1)
    for name, array in cuda[3].items():
        np.testing.assert_array_equal(array, cpu[3][name], err_msg=name)
    # Client 0's conflicting ack, replayed on the scalar path, takes its
    # slot off the dense plane; every other client is weak and strong.
    assert cuda[4] == cpu[4] == {"weak_certs": clients - 1,
                                 "strong_certs": clients - 1,
                                 "committed": 0}


def test_device_plane_tracker_on_the_card(card):
    """A tracker on the device plane on the card: a three-source storm
    certifies every slot, the oracle finds nothing, and the sweep's totals
    come from the kernel."""
    from mirbft_tpu_torch.core.client_tracker import ClientTracker
    from mirbft_tpu_torch.core.msgbuffers import NodeBuffers
    from mirbft_tpu_torch.core.persisted import Persisted
    from mirbft_tpu_torch.core.preimage import host_digest, request_hash_data
    from mirbft_tpu_torch.obsv import shadow
    from mirbft_tpu_torch.ops import ack_plane

    state = pb.NetworkState(
        config=pb.NetworkConfig(nodes=[0, 1, 2, 3], f=1, number_of_buckets=4,
                                checkpoint_interval=5, max_epoch_length=50),
        clients=[pb.NetworkClient(id=7, width=100, low_watermark=0)],
    )
    persisted = Persisted()
    persisted.add_c_entry(pb.CEntry(seq_no=0, checkpoint_value=b"genesis",
                                    network_state=state))
    my = pb.InitialParameters(id=0, buffer_size=1 << 20)
    tracker = ClientTracker(persisted, NodeBuffers(my), my,
                            ack_plane="device")
    tracker.reinitialize()
    acks = []
    for i in range(40):
        request = pb.Request(client_id=7, req_no=i, data=b"tx")
        acks.append(pb.RequestAck(
            client_id=7, req_no=i,
            digest=host_digest(request_hash_data(request)),
        ))
    before = ack_plane.ack_step.launches
    for source in (1, 2, 3):
        tracker.step_ack_many(source, [pb.Msg(type=a) for a in acks])
    plane = tracker._device
    assert plane.device.type == "cuda"
    assert ack_plane.ack_step.launches == before + 3
    assert plane.acks_fallback == 0
    assert shadow.audit_tracker(tracker) == []
    assert plane.quorum_sweep() == {
        "weak_certs": 40, "strong_certs": 40, "committed": 0,
    }


# -- BLS G1 aggregation ---------------------------------------------------------


def _bls_small_cases():
    import bls_cases

    return bls_cases.cases(full=False)


@pytest.mark.parametrize("index", range(4),
                         ids=["edges-4x4", "edges-4x8", "random-4x4",
                              "rung4-4x128"])
def test_bls_kernel_equals_its_plain_version(card, index):
    """tests/bls_cases.py's small cases: the kernel's (batch, 3, 12) output
    bit for bit equal to the plain version's on the same inputs, counted
    once, and its affine points equal to the host fold."""
    import bls_cases

    from mirbft_tpu_torch.ops import bls_g1

    label, certs, voters = _bls_small_cases()[index]
    arrays = [torch.from_numpy(a) for a in
              bls_g1.pack_certificates(certs, voters)]
    before = bls_g1.aggregate_points.launches
    out = bls_g1.aggregate_points(*(a.to(card) for a in arrays))
    torch.cuda.synchronize()
    assert bls_g1.aggregate_points.launches == before + 1
    assert torch.equal(out.cpu(), bls_g1.aggregate_plain(*arrays)), label
    points = [bls_g1.to_affine(xyz) for xyz in bls_g1.canonical(out)]
    assert points[: len(certs)] == bls_cases.host_sums(certs), label


@pytest.mark.parametrize("index", range(3), ids=["width1", "width85",
                                                  "width200"])
def test_bls_kernel_at_widths_no_lane_split_divides(card, index):
    """tests/bls_cases.py's width cases (1, 85 and 200 slots, not padded:
    leading, middle and all-absent voters, a doubling, P + -P): the
    kernel's output bit for bit equal to the plain version's, the affine
    points to the host fold."""
    import bls_cases

    from mirbft_tpu_torch.ops import bls_g1

    label, certs, width = bls_cases.width_cases()[index]
    arrays = [torch.from_numpy(a) for a in bls_cases.pack(certs, width=width)]
    out = bls_g1.aggregate_points(*(a.to(card) for a in arrays))
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), bls_g1.aggregate_plain(*arrays)), label
    points = [bls_g1.to_affine(xyz) for xyz in bls_g1.canonical(out)]
    assert points == bls_cases.host_sums(certs), label


def test_bls_aggregate_raises_rather_than_folding_on_the_host(card,
                                                              monkeypatch):
    """qc.aggregate on the card: a malformed point raises (nothing falls
    back to bls_host), inputs the wrapper refuses raise, and a good call
    never reaches the host fold."""
    import bls_cases

    from mirbft_tpu_torch.crypto import bls_host, qc
    from mirbft_tpu_torch.ops import bls_g1

    pool = bls_cases.point_pool(4)
    want = bls_host.aggregate_g1(pool)

    def no_host_fold(_points):
        raise AssertionError("folded on the host")

    monkeypatch.setattr(bls_host, "aggregate_g1", no_host_fold)
    with pytest.raises(ValueError):
        qc.aggregate([pool[0], (bls_host.P, 0)])
    assert qc.aggregate(pool) == want
    xs, ys, zs, mask = (torch.from_numpy(a).to(card) for a in
                        bls_g1.pack_certificates([pool], 4))
    with pytest.raises(ValueError):
        bls_g1.aggregate_points(xs, ys, zs.cpu(), mask)
    with pytest.raises(TypeError):
        bls_g1.aggregate_points(xs.to(torch.int64), ys, zs, mask)


# -- the live node as a replicated service ---------------------------------------


def _ingress_items(n: int) -> list:
    """n signed requests (client_id, req_no, data) for clients 1-3: valid
    ones with forgeries among them (a flipped bit of S, a signature for
    another req_no), each reaching the kernels."""
    signer = signing.make_signer()
    items = []
    for i in range(n):
        cid, req_no = 1 + i % 3, i
        data = signer(cid, req_no, b"op-%d" % i)
        if i % 5 == 3:
            flipped = bytearray(data)
            flipped[-64] ^= 1 << (i % 8)
            data = bytes(flipped)
        elif i % 5 == 4:
            req_no += 1
        items.append((cid, req_no, data))
    return items


@pytest.mark.parametrize("n", [1, 7, 100, 256])
def test_ingress_batch_verifier_on_the_card_equals_plain(card, n):
    """batch_verifier("cuda") on a batch of valid signatures and forgeries:
    one launch of each Ed25519 kernel at n rows, verdicts equal to the
    plain versions' (batch_verifier("cpu")) and the host oracle's."""
    from mirbft_tpu_torch import bench

    items = _ingress_items(n)
    assert len(bench.ingress_rows(items)) == n
    verifier = signing.batch_verifier()
    assert verifier.device.type == "cuda"
    before = (ed25519.decompress.launches, ed25519.ladder.launches)
    got = verifier(items)
    assert (ed25519.decompress.launches, ed25519.ladder.launches) == (
        before[0] + 1, before[1] + 1,
    )
    assert got == signing.batch_verifier("cpu")(items)
    assert got == signing.host_verifier(items)
    if n >= 5:
        assert any(got) and not all(got)


def test_kv_cluster_smoke_on_the_card(card):
    """A 4-node InProcessCluster(app="kv") on its default processor,
    cuda-pipelined on the card: read-your-writes through the committed
    read barrier, cas, a read from another node, every digest launched."""
    import time

    from mirbft_tpu_torch.loadgen import InProcessCluster

    before = port.sha256_digest_words.launches
    with InProcessCluster(node_count=4, client_ids=[1, 2], app="kv") as cluster:
        assert all(r.processor.device.type == "cuda" for r in cluster.replicas)
        s1 = cluster.kv_session(1, home=0)
        put = s1.put("alpha", b"v1", timeout=30.0)
        assert put["status"] == "ok", put
        got = s1.get("alpha", timeout=30.0)
        assert bytes.fromhex(got["value"]) == b"v1"
        cas = s1.cas("alpha", put["version"], b"v2", timeout=30.0)
        assert cas["status"] == "ok", cas
        s2 = cluster.kv_session(2, home=1)
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            other = s2.get("alpha", timeout=30.0)
            if other.get("version") == cas["version"]:
                break
            time.sleep(0.05)
        assert bytes.fromhex(other["value"]) == b"v2"
        cluster.check()
    procs = [r.processor for r in cluster.replicas]
    assert sum(p.host_digests for p in procs) == 0
    launches = sum(p.launches for p in procs)
    assert launches > 0
    assert port.sha256_digest_words.launches - before == launches


# -- the live chaos campaign's signed scenarios ------------------------------------


def test_live_signed_mode_verifier_death_recovers_on_the_card(card):
    """``tests/test_chaos_live.py:177`` on the card: the signature kernels
    die mid-run (calls [1, 2) of the flaky verifier), the breaker trips,
    a probe verifies the batch again on the Ed25519 kernels and re-closes
    it, commits continue, and the forged-request probe is rejected (inside
    the run).  No verdict comes from the host."""
    from mirbft_tpu_torch.chaos import live_matrix, run_live_scenario

    scenario = {s.name: s for s in live_matrix()}["signed-verifier-dies"]
    result = run_live_scenario(scenario, seed=2, budget_s=60.0, device=card)
    assert result.passed, result.violation
    assert result.counters["sig_device_errors"] >= 1
    assert result.counters["sig_device_retries"] >= 1
    assert result.counters["sig_fallbacks"] == 0
    assert result.counters["launches_ed25519_ladder"] > 0
    assert all(result.counters["digest_launches"])
    assert result.commits > 0


def test_live_adversary_corruption_rejected_on_the_card(card):
    """``tests/test_chaos_live.py:196`` on the card: corrupted proposal
    deliveries over real TCP die at the signed ingress on the Ed25519
    kernels (rejections == corruptions) while honest copies commit."""
    from mirbft_tpu_torch.chaos import live_adversary_matrix, run_live_scenario

    scenario = {s.name: s for s in live_adversary_matrix()}[
        "corrupt-propose-signed"]
    result = run_live_scenario(scenario, seed=0, budget_s=60.0, device=card)
    assert result.passed, result.violation
    assert result.counters["corrupted"] > 0
    assert result.counters["rejections"] == result.counters["corrupted"]
    assert result.counters["launches_ed25519_ladder"] > 0
    assert result.commits > 0


# -- the sharded plane (chip_smoke phase 23) ------------------------------------

TALLY_SHAPES = [(8, 16), (128, 4096), (256, 65536), (37, 300), (5, 129)]


@pytest.mark.parametrize("rows,cols", TALLY_SHAPES,
                         ids=[f"{r}x{c}" for r, c in TALLY_SHAPES])
def test_tally_and_shard_sum_kernels_equal_their_plain_versions(card, rows,
                                                               cols):
    """Phase 23a: the column sums of a seeded int8 vote block (every int8
    value; word loads, and byte loads at ragged widths and from a base off
    4 bytes) and the sum of 4 shards' partials, with and without a
    threshold, bit for bit against the plain versions on the same card;
    one launch counted each."""
    from mirbft_tpu_torch.ops import tally

    gen = torch.Generator().manual_seed(rows * 7919 + cols)
    votes = torch.randint(-128, 128, (rows, cols), generator=gen,
                          dtype=torch.int8).to(card)
    before = (tally.tally_columns.launches, tally.shard_sum.launches)
    sums = tally.tally_columns(votes)
    assert torch.equal(sums, tally.tally_columns_plain(votes))
    assert torch.equal(sums, votes.sum(0, dtype=torch.int32))
    off = torch.empty(rows * cols + 1, dtype=torch.int8, device=card)
    off[1:] = votes.reshape(-1)
    shifted = off[1:].view(rows, cols)
    assert torch.equal(tally.tally_columns(shifted), sums)
    parts = torch.randint(-(1 << 31), 1 << 31, (4, cols), generator=gen,
                          dtype=torch.int64).to(torch.int32).to(card)
    assert torch.equal(tally.shard_sum(parts), tally.shard_sum_plain(parts))
    for threshold in (0, int(sums.float().mean()), 1 << 30):
        assert torch.equal(tally.shard_sum(parts, threshold),
                           tally.shard_sum_plain(parts, threshold))
    torch.cuda.synchronize()
    assert (tally.tally_columns.launches, tally.shard_sum.launches) == (
        before[0] + 2, before[1] + 4)


@pytest.mark.parametrize("shards", [1, 4])
def test_sharded_functions_on_the_card_equal_the_unsharded_kernels(card,
                                                                   shards):
    """Phase 23b: the three sharded functions on ``[cuda:0] * shards``
    against one unsharded call of their kernels: digest words, quorum
    masks, and Ed25519 verdicts of host-decompressed rows through the
    extended ladder, one launch a shard (valid rows accepted, corrupted
    ones rejected)."""
    import numpy as np

    from mirbft_tpu_torch.parallel import sharding

    mesh = sharding.make_mesh(devices=[card] * shards)
    rng = random.Random(shards)
    messages = [rng.randbytes(rng.randrange(0, 500)) for _ in range(64)]
    packed = pack_preimages(messages, batch_floor=shards)
    words = sharding.sharded_sha256(mesh)(packed.blocks, packed.n_blocks)
    assert torch.equal(words, port.sha256_digest_words(
        *to_tensors(packed, card)))

    votes = np.random.default_rng(shards).integers(
        0, 2, (16 * shards, 1000)).astype(np.int8)
    mask = sharding.sharded_quorum_tally(mesh)(votes, 9 * shards)
    want = (votes.astype(np.int32).sum(axis=0) >= 9 * shards).tolist()
    assert mask.device.type == "cuda" and mask.tolist() == want

    rows = []
    for i in range(8):
        seed = bytes([i + 1]) * 32
        msg = b"phase-23-%d" % i
        pk, sig = ed25519_host.public_key(seed), ed25519_host.sign(seed, msg)
        rows.append(ed25519.marshal_signature(
            pk, msg + (b"!" if i % 2 else b""), sig))
    before = ed25519.ladder_extended.launches
    got = sharding.sharded_ed25519_verify(mesh)(
        *ed25519.pack_signature_rows(rows, batch_floor=shards))
    assert ed25519.ladder_extended.launches == before + shards
    single = ed25519.launch_signature_rows(rows, device=card)
    assert torch.equal(got, single)
    assert (got != 0).tolist() == [i % 2 == 0 for i in range(8)]


def test_four_shard_device_plane_on_the_card_equals_one_device(card):
    """Phase 23c's plane, small: a 4-shard ack plane on ``[cuda:0] * 4``
    and a one-device plane on the card take one storm of acks from three
    sources (a fourth voting a fork on some slots) frame by frame: the same
    sweep and every state array equal; the one-device plane launches no
    shard_sum, the 4-shard one a shard_sum a flush and a sweep."""
    from mirbft_tpu_torch.core.client_tracker import ClientTracker
    from mirbft_tpu_torch.core.msgbuffers import NodeBuffers
    from mirbft_tpu_torch.core.persisted import Persisted
    from mirbft_tpu_torch.ops import tally
    from mirbft_tpu_torch.parallel import sharding

    def tracker(ack_device):
        persisted = Persisted()
        persisted.add_c_entry(pb.CEntry(
            seq_no=0, checkpoint_value=b"genesis",
            network_state=pb.NetworkState(
                config=pb.NetworkConfig(
                    nodes=list(range(4)), f=1, number_of_buckets=4,
                    checkpoint_interval=5, max_epoch_length=50),
                clients=[pb.NetworkClient(id=c, width=4, low_watermark=0)
                         for c in range(100)])))
        my = pb.InitialParameters(id=0, buffer_size=1 << 20)
        ct = ClientTracker(persisted, NodeBuffers(my), my,
                           ack_plane="device", ack_device=ack_device)
        ct.reinitialize()
        return ct

    rng = random.Random(23)
    digests = {(c, r): rng.randbytes(32) for c in range(100) for r in range(4)}
    frames = []
    for source in (1, 2, 3, 0):
        keys = list(digests)
        rng.shuffle(keys)
        msgs = [pb.Msg(type=pb.RequestAck(
            client_id=c, req_no=r,
            digest=rng.randbytes(32) if source == 0 and rng.random() < 0.3
            else digests[(c, r)])) for c, r in keys]
        frames += [(source, msgs[lo:lo + 128])
                   for lo in range(0, len(msgs), 128)]
    planes = []
    for ack_device in (card, sharding.make_mesh(devices=[card] * 4)):
        ct = tracker(ack_device)
        before = tally.shard_sum.launches
        for source, msgs in frames:
            ct.step_ack_many(source, msgs)
        certs = ct._device.quorum_sweep()
        torch.cuda.synchronize()
        planes.append((ct._device, certs, tally.shard_sum.launches - before))
    (one, certs1, sums1), (four, certs4, sums4) = planes
    assert (one.mesh.size, four.mesh.size) == (1, 4)
    assert certs1 == certs4 and certs1["strong_certs"] > 0
    assert sums1 == 0 and sums4 == four.batches + 1
    snaps = one.host_snapshot(), four.host_snapshot()
    for name in snaps[0]:
        assert (snaps[0][name] == snaps[1][name]).all(), name
