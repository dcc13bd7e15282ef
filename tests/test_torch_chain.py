"""The chain checksum of the kernel microbenchmark, held against the JAX
package's XLA function and its Pallas kernel (interpret mode, slow tier),
and the launch counters under threads.

``iters`` stays at 1-5: the JAX package's Pallas compression is fully
unrolled and slow to compile and interpret on a CPU."""

import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirbft_tpu.ops.sha256 import sha256_chain_checksum as jax_chain
from mirbft_tpu.ops.sha256_pallas import (
    sha256_chain_checksum_pallas as jax_chain_pallas,
)
from mirbft_tpu_torch import bench
from mirbft_tpu_torch.core import actions as act
from mirbft_tpu_torch.ops import sha256 as port
from mirbft_tpu_torch.runtime.processor import CudaProcessor


def _block(batch, seed):
    return np.random.default_rng(seed).integers(
        0, 2**32, size=(batch, 16), dtype=np.uint32
    )


def _port(words, iters):
    out = port.sha256_chain_checksum(
        torch.from_numpy(words.view(np.int32)), iters=iters
    )
    assert out.shape == () and out.dtype == torch.int32
    return int(out) & 0xFFFFFFFF


@pytest.mark.parametrize("iters", [1, 2, 5])
def test_chain_checksum_equals_the_jax_xla_function(iters):
    words = _block(1024, seed=iters)
    want = int(np.asarray(jax_chain(jnp.asarray(words), iters=iters)))
    assert _port(words, iters) == want


@pytest.mark.slow
@pytest.mark.parametrize("iters", [1, 2])
def test_chain_checksum_equals_the_pallas_kernel_interpreted(iters):
    """Slow tier: CPU XLA compiles the interpreted kernel's unrolled
    compression for many minutes (``python -m pytest
    tests/test_torch_chain.py -m slow``)."""
    words = _block(1024, seed=10 + iters)
    want = int(np.asarray(
        jax_chain_pallas(jnp.asarray(words), iters=iters, interpret=True)
    ))
    assert _port(words, iters) == want


@pytest.mark.parametrize("batch", [1000, 1, 129])
def test_chain_checksum_ragged_batches(batch):
    """Any batch, unlike the Pallas kernel's multiples of 1024: the plain
    version against the XLA function, which takes any batch too."""
    words = _block(batch, seed=batch)
    want = int(np.asarray(jax_chain(jnp.asarray(words), iters=2)))
    assert _port(words, 2) == want


def test_chain_checksum_zero_iters_sums_the_iv():
    iv_sum = sum(port._IV) & 0xFFFFFFFF
    assert _port(_block(3, seed=0), 0) == (3 * iv_sum) & 0xFFFFFFFF


def test_chain_checksum_rejects_bad_inputs():
    with pytest.raises(ValueError, match="batch, 16"):
        port.sha256_chain_checksum(torch.zeros((4, 8), dtype=torch.int32),
                                   iters=1)
    with pytest.raises(TypeError, match="int32"):
        port.sha256_chain_checksum(torch.zeros((4, 16), dtype=torch.int64),
                                   iters=1)
    with pytest.raises(ValueError, match="iters"):
        port.sha256_chain_checksum(torch.zeros((4, 16), dtype=torch.int32),
                                   iters=-1)


def test_pallas_name_is_the_same_function():
    assert port.sha256_chain_checksum_pallas is port.sha256_chain_checksum


def test_plain_route_does_not_count_launches():
    """Only a kernel launch counts."""
    before = port.sha256_chain_checksum.launches
    _port(_block(8, seed=1), 1)
    assert port.sha256_chain_checksum.launches == before


def test_kernel_microbench_on_the_cpu_at_a_tiny_size():
    result = bench.kernel_microbench(
        "cpu", batch=64, iters=2, reps=2, host_messages=64, seed=3
    )
    assert result["chain_rate"] > 0 and result["host_rate"] > 0
    assert result["kernel_digest_rate"] == pytest.approx(
        result["chain_rate"] / bench.MSG_BLOCKS
    )
    assert result["rep_ms"] == [None, None]
    assert len(result["rep_wall_ms"]) == 2
    # The checksums are the chain over the reps' blocks: recompute them
    # from the same generator (64 digest-check messages come first).
    rng = np.random.default_rng(3)
    for _ in range(bench.DIGEST_CHECK_MESSAGES):
        rng.bytes(bench.MSG_BYTES)
    for checksum in result["checksums"]:
        words = rng.integers(0, 2**32, size=(64, 16), dtype=np.uint32)
        want = int(np.asarray(jax_chain(jnp.asarray(words), iters=2)))
        assert checksum == want


def test_microbench_constants_are_the_jax_benchs():
    import bench as jax_bench

    assert (bench.CHAIN_BATCH, bench.CHAIN_ITERS, bench.CHAIN_REPS) == (
        jax_bench.CHAIN_BATCH, jax_bench.CHAIN_ITERS, jax_bench.CHAIN_REPS
    )
    assert (bench.MSG_BYTES, bench.MSG_BLOCKS) == (
        jax_bench.MSG_BYTES, jax_bench.MSG_BLOCKS
    )
    for name in ("NODES", "CLIENTS", "REQS_PER_CLIENT", "TARGET_COMMITS",
                 "BATCH_SIZE", "TICK_S", "CHECKPOINT_INTERVAL",
                 "SUSPECT_TICKS", "FSYNC_FLOOR_S", "DEADLINE_S"):
        assert getattr(bench.LIVE, name.lower()) == getattr(
            jax_bench, "LIVE_" + name
        ), name


# -- counters under threads ---------------------------------------------------


@pytest.fixture
def preemption_storm():
    """Switch threads every 10 us, so a read-modify-write that is not
    under a lock loses counts."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    yield
    sys.setswitchinterval(old)


def _run_threads(target, n=8):
    barrier = threading.Barrier(n)

    def run():
        barrier.wait()
        target()

    threads = [threading.Thread(target=run) for _ in range(n)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=120)
        assert not thread.is_alive(), "a counting thread did not finish"


def test_launch_counter_counts_exactly_from_8_threads(preemption_storm):
    def fake():
        pass

    fake.launches = 0

    def launch_many():
        for _ in range(2000):
            port._count_launch(fake)

    _run_threads(launch_many)
    assert fake.launches == 8 * 2000


def test_processor_counters_count_exactly_from_8_threads(preemption_storm):
    """Eight threads dispatch and collect on the plain route through one
    processor: launches and digests count every call."""
    proc = CudaProcessor.__new__(CudaProcessor)
    proc._init_device("cpu")
    hashes = [
        act.HashRequest(data=[b"m-%d" % i], origin=None) for i in range(3)
    ]

    def work():
        for _ in range(5):
            proc._collect_device(hashes, proc._dispatch_device(hashes))

    _run_threads(work)
    assert proc.launches == 8 * 5
    assert proc.device_digests == 8 * 5 * 3
    assert proc.host_digests == 0
