"""The port bench's three new stage functions against the JAX package's, on
the CPU at a cut both packages take through their module constants: rung 2
(``ladder_run``, 16 nodes x 64 clients x 25 requests), rung 3
(``rung3_run``, 8 nodes x 16 signed clients x 2) and the Ed25519
microbenchmark (``ed25519_microbench`` at 8 signatures).  The port runs the
kernels' plain versions (``device="cpu"``); the JAX package runs its own
bench functions unedited, with ``REQS_PER_CLIENT`` and the ``RUNG3_*``
constants patched for the run.  Tolerance: exact (events, app chains,
verified counts, corpus bytes, verdicts)."""

import pytest

import bench as jax_bench
from mirbft_tpu.crypto import ed25519_host as jax_ed25519_host
from mirbft_tpu.testengine import engine as jax_engine
from mirbft_tpu_torch import bench
from mirbft_tpu_torch.ops.ed25519 import verify_batch_pallas
from mirbft_tpu_torch.testengine import rung3
from mirbft_tpu_torch.testengine.crypto_plane import AsyncKernelHashPlane

LADDER_REQS = 25
RUNG3_CUT = {"nodes": 8, "clients": 16, "reqs": 2}


@pytest.fixture(scope="module")
def jax_ladder():
    saved = jax_bench.REQS_PER_CLIENT
    jax_bench.REQS_PER_CLIENT = LADDER_REQS
    try:
        return jax_bench.ladder_run()
    finally:
        jax_bench.REQS_PER_CLIENT = saved


@pytest.mark.parametrize("plane", ["host", "kernel"])
def test_ladder_run_equals_the_jax_rung(jax_ladder, plane):
    _wall, jax_events, jax_chain, jax_sim = jax_ladder
    hash_plane = (AsyncKernelHashPlane(device="cpu") if plane == "kernel"
                  else None)
    result = bench.ladder_run(hash_plane, device="cpu",
                              reqs_per_client=LADDER_REQS)
    wall, events, chain, sim = result
    assert (events, chain, sim) == (jax_events, jax_chain, jax_sim)
    assert set(result.chains.values()) == {jax_chain}
    assert result.counts == [bench.CLIENTS * LADDER_REQS] * bench.NODES
    assert wall > 0 and result.cpu_s > 0
    if plane == "kernel":
        assert result.plane.launches > 0 and result.plane.host_digests == 0
    else:
        assert result.plane.host_digests > 0


def test_warm_kernel_shapes_launches_every_bucket_once(monkeypatch):
    from mirbft_tpu_torch.ops import sha256

    shapes = []

    def recording(blocks, n_blocks):
        shapes.append((tuple(blocks.shape), tuple(n_blocks.shape)))
        return sha256.sha256_digest_words_plain(blocks, n_blocks)

    monkeypatch.setattr(sha256, "sha256_digest_words", recording)
    plane = AsyncKernelHashPlane(device="cpu", chunk_rows=256)
    bench.warm_kernel_shapes(plane)
    buckets = (1, 2, 4, 8, 16, 32, 64, 128)
    assert shapes == [((plane.rows_for(b), b, 16), (plane.rows_for(b),))
                      for b in buckets]


def test_rung3_run_equals_the_jax_rung(monkeypatch):
    made = []
    make = jax_engine.BasicRecorder

    def capturing(*args, **kwargs):
        made.append(make(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(jax_engine, "BasicRecorder", capturing)
    monkeypatch.setattr(jax_bench, "RUNG3_NODES", RUNG3_CUT["nodes"])
    monkeypatch.setattr(jax_bench, "RUNG3_CLIENTS", RUNG3_CUT["clients"])
    monkeypatch.setattr(jax_bench, "RUNG3_REQS", RUNG3_CUT["reqs"])
    _rate, _p99, jax_events, jax_verified, jax_stats, jax_sim = (
        jax_bench.rung3_run()
    )
    [rec] = made
    jax_chains = {rec.node_states[n].app_chain.hex()
                  for n in range(RUNG3_CUT["nodes"])}

    result = bench.rung3_run(device="cpu", **RUNG3_CUT)
    plane = result.signature_plane
    rate, p99, events, verified, stats, sim = result
    total = RUNG3_CUT["clients"] * RUNG3_CUT["reqs"]
    assert (events, verified, sim) == (jax_events, jax_verified, jax_sim)
    assert {result.chain} == jax_chains
    assert rate > 0 and p99 >= 0
    # The same counters; every verify on the kernels (the JAX run on a CPU
    # takes its host batch authority).
    assert set(stats) == set(jax_stats)
    assert stats["rung3_device_verifies"] == total
    assert stats["rung3_host_verifies"] == 0
    assert jax_stats["rung3_host_verifies"] == total
    for key in ("rung3_speculative_admits", "rung3_speculative_evictions",
                "rung3_forced_joins"):
        assert stats[key] == jax_stats[key], key
    assert plane.device_verifies == total
    assert result.hash_plane.host_digests == 0


def test_rung3_presign_at_a_cut_is_the_rungs_signing():
    presigned = rung3.presign(**RUNG3_CUT)
    ids = rung3.client_ids(RUNG3_CUT["nodes"], RUNG3_CUT["clients"])
    assert sorted(presigned) == [
        (cid, rn) for cid in ids for rn in range(RUNG3_CUT["reqs"])
    ]
    state = rung3.network_state(RUNG3_CUT["nodes"], RUNG3_CUT["clients"])
    assert list(state.config.nodes) == list(range(RUNG3_CUT["nodes"]))
    assert state.config.f == (RUNG3_CUT["nodes"] - 1) // 3
    assert [c.id for c in state.clients] == ids


def test_ed25519_microbench_corpus_and_verdicts():
    batch = 8
    corpus = bench.ed25519_corpus(batch)
    want = []
    for i in range(batch):
        seed = i.to_bytes(32, "little")
        msg = b"bench-request-%d" % i
        want.append((jax_ed25519_host.public_key(seed), msg,
                     jax_ed25519_host.sign(seed, msg)))
    assert corpus == want
    pks, msgs, sigs = map(list, zip(*corpus))
    assert list(verify_batch_pallas(pks, msgs, sigs, device="cpu")) == [
        jax_ed25519_host.verify(pk, m, s) for pk, m, s in corpus
    ] == [True] * batch
    for rep in (b"!", b"?"):
        flipped = [m + rep for m in msgs]
        assert list(verify_batch_pallas(pks, flipped, sigs, device="cpu")) \
            == [jax_ed25519_host.verify(pk, m, s)
                for pk, m, s in zip(pks, flipped, sigs)] == [False] * batch
    bench.ed25519_microbench_warmup(batch, device="cpu")
    kernel_rate, host_rate = bench.ed25519_microbench(batch, device="cpu")
    assert kernel_rate > 0 and host_rate > 0
