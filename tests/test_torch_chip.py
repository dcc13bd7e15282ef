"""The CUDA kernels on the card: SHA-256 bit-exact with its plain version
and hashlib, launched and counted on the engine's commit path; the two
Ed25519 kernels equal to their plain versions and the RFC 8032 oracle, and
the signed engine run on them equal to the host-oracle run.

Marked ``gpu``: each test skips, with its reason, where no CUDA card is
present (the kernel has no CPU mode).  Run them on a machine with a card:

    python -m pytest tests/test_torch_chip.py -m gpu
"""

import hashlib
import random

import pytest
import torch

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
    """n rows that all reach the kernels: n - 3 signatures (valid,
    corrupted R, corrupted S, wrong message in turn), then a key with no
    square root, the identity as key with a signature it satisfies, and
    x = 0 with the sign bit set."""
    rng = random.Random(n)
    pks, msgs, sigs = [], [], []
    for i in range(n - 3):
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
    return pks, msgs, sigs


@pytest.mark.parametrize("n", [8, 256, 512])  # 256, 512: the main path's
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
    assert ed25519.verify_batch(pks, msgs, sigs, device=card).tolist() == expect


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
