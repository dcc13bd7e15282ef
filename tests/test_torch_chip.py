"""The CUDA kernels on the card: SHA-256 bit-exact with its plain version
and hashlib, launched and counted on the engine's commit path; the two
Ed25519 kernels equal to their plain versions and the RFC 8032 oracle
(decompression also on the corpus that takes each of its branches), and
the signed engine run on them equal to the host-oracle run.

Marked ``gpu``: each test skips, with its reason, where no CUDA card is
present (the kernel has no CPU mode).  Run them on a machine with a card:

    python -m pytest tests/test_torch_chip.py -m gpu
"""

import hashlib
import random

import pytest
import torch

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
    """The step's three launches and the sweep on seeded cases holding
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
