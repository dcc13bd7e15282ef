"""BLS12-381 in the port: the host oracle (crypto/bls_host.py), the
aggregation's plain version (ops/bls_g1.py) against the JAX package's XLA
program, the certificate seam (crypto/qc.py) and the certificate plane
(testengine/certs.py) against the JAX package's.

The JAX program (``mirbft_tpu/ops/bls_g1.py::_aggregate``) runs here with
``jax.disable_jit()``: its own operations one by one, which on the CPU
takes seconds where compiling the scan takes half a minute a shape (the
slow tier compiles it once).  Its inputs cross with ``from_jax_limbs``
and the canonical (X, Y, Z) must be equal, not only the affine points.
Tests that pair go under ``slow``, as tests/test_bls.py's do."""

import jax
import numpy as np
import pytest
import torch

import bls_cases
from mirbft_tpu.ops import bls_g1 as ref_bls_g1
from mirbft_tpu.testengine import BasicRecorder as RefRecorder
from mirbft_tpu.testengine.certs import CheckpointCertPlane as RefCertPlane
from mirbft_tpu_torch.crypto import bls_host as bls
from mirbft_tpu_torch.crypto import qc
from mirbft_tpu_torch.ops import bls_g1
from mirbft_tpu_torch.testengine import BasicRecorder
from mirbft_tpu_torch.testengine.certs import CheckpointCertPlane
from mirbft_tpu_torch.testengine.crypto_plane import AsyncKernelHashPlane


def jax_inputs(certs, voters):
    """The JAX package's packing (aggregate_signatures): (batch, width, 30)
    Montgomery limbs, R = 2^390, Z = 1."""
    xs, _ys, _zs, mask = bls_g1.pack_certificates(certs, voters)
    batch, width = mask.shape
    out = [np.zeros((batch, width, ref_bls_g1.NLIMB), np.int32)
           for _ in range(3)]
    for b, cert in enumerate(certs):
        for v, point in enumerate(cert):
            if point is not None:
                out[0][b, v] = ref_bls_g1._to_mont(point[0])
                out[1][b, v] = ref_bls_g1._to_mont(point[1])
                out[2][b, v] = ref_bls_g1._to_mont(1)
    return (*out, mask)


def jax_canonical(out) -> list:
    out = np.asarray(out)
    return [tuple(ref_bls_g1._from_mont(out[b, k]) for k in range(3))
            for b in range(out.shape[0])]


@pytest.fixture(scope="module")
def pool():
    return bls_cases.point_pool(8)


def test_generators_and_orders():
    assert bls.g1_on_curve(bls.G1)
    assert bls.g2_on_curve(bls.G2)
    assert bls.pt_mul(bls.FP, bls.R, bls.G1) is None
    assert bls.pt_mul(bls.FP2, bls.R, bls.G2) is None


@pytest.mark.parametrize("case", [0, 1], ids=["edges-4x4", "edges-4x8"])
def test_aggregate_plain_equals_the_jax_program(pool, case):
    """Absent voters in the middle, a certificate with no vote, a doubling,
    P + -P, the generator: canonical (X, Y, Z) equal to the JAX program's,
    and the affine points to the host fold."""
    label, certs, voters = bls_cases.edge_cases(pool)[case]
    xs, ys, zs, mask = jax_inputs(certs, voters)
    with jax.disable_jit():
        want = jax_canonical(ref_bls_g1._aggregate(xs, ys, zs, mask))
    got = bls_g1.canonical(bls_g1.aggregate_plain(
        *bls_g1.from_jax_limbs(xs, ys, zs, mask)))
    assert got == want, label
    points = [bls_g1.to_affine(xyz) for xyz in got[: len(certs)]]
    assert points == bls_cases.host_sums(certs)
    if case == 0:  # the empty and the cancelling certificates
        assert points[1] is None and points[3] is None
    else:  # P + -P + Q
        assert points[2] == pool[1]


@pytest.mark.slow
def test_aggregate_plain_equals_the_compiled_jax_program(pool):
    """The same at (4, 8) against the jitted program (the XLA compile)."""
    _label, certs, voters = bls_cases.edge_cases(pool)[1]
    xs, ys, zs, mask = jax_inputs(certs, voters)
    want = jax_canonical(ref_bls_g1._aggregate(xs, ys, zs, mask))
    got = bls_g1.canonical(bls_g1.aggregate_plain(
        *bls_g1.from_jax_limbs(xs, ys, zs, mask)))
    assert got == want


def test_from_jax_limbs_keeps_every_value(pool):
    certs = [[pool[0], None, pool[1]], [pool[2]]]
    xs, ys, zs, mask = jax_inputs(certs, 4)
    port = bls_g1.from_jax_limbs(xs, ys, zs, mask)
    for jax_arr, ours in zip((xs, ys, zs), port[:3]):
        assert ours.dtype == torch.int32 and ours.shape == (4, 4, 12)
        for b in range(4):
            for v in range(4):
                assert bls_g1.from_mont(ours[b, v].numpy()) == (
                    ref_bls_g1._from_mont(jax_arr[b, v]))
    assert torch.equal(port[3], torch.from_numpy(mask))


@pytest.mark.parametrize("index", range(4))
def test_aggregate_signatures_on_the_cpu_equals_the_host_fold(index):
    """The seeded cases (tests/bls_cases.py) of the small set through the
    entry point on the CPU: each certificate's point equals
    bls_host.aggregate_g1 of its votes."""
    label, certs, voters = bls_cases.cases(full=False)[index]
    got = bls_g1.aggregate_signatures(certs, voters, device="cpu")
    assert got == bls_cases.host_sums(certs), label


def test_leading_absent_voters_leave_the_sum_as_it_is(pool):
    """The identity plus the identity is the identity, so a certificate's
    (X : Y : Z) depends only on its slots from the first live voter on
    (``needed_additions``); every later absent slot scales it."""
    a, b = pool[:2]

    def run(cert, width):
        arrays = [torch.from_numpy(x)[:, :width].contiguous()
                  for x in bls_g1.pack_certificates([cert], 4)]
        out = bls_g1.aggregate_plain(*arrays)
        return bls_g1.canonical(out)[0], arrays[3]

    lead, lead_mask = run([None, None, a, b], 4)
    bare, _ = run([a, b], 2)  # the packer's floor is 4: cut to 2 slots
    tail, tail_mask = run([a, b, None, None], 4)
    assert lead == bare
    assert tail != bare  # two absent slots after b scale (X : Y : Z)
    assert bls_g1.to_affine(tail) == bls_g1.to_affine(bare) == (
        bls.aggregate_g1([a, b]))
    assert bls_g1.needed_additions(lead_mask) == [2, 0, 0, 0]
    assert bls_g1.needed_additions(tail_mask) == [4, 0, 0, 0]


def test_bounds_count_what_the_data_needs(pool):
    certs = [bls_cases.quorum_certificate(pool, 85)]
    _xs, _ys, _zs, mask = bls_g1.pack_certificates(certs, 128)
    assert mask.shape == (4, 128)
    assert bls_g1.needed_additions(mask) == [128, 0, 0, 0]
    assert bls_g1.aggregate_ops(mask) == 128 * bls_g1.int_ops_per_addition()
    assert bls_g1.int_ops_per_addition() == 12 * 324 + 22 * 36 + 5 * 24
    assert bls_g1.aggregate_bytes(mask) == (
        4 * 128 * 4 + 85 * 3 * 12 * 4 + 4 * 3 * 12 * 4)
    assert bls_g1.chain_floor_cycles(mask) == (
        128 * bls_g1.ADDITION_CHAIN * bls_g1.DEPENDENT_LATENCY_CYCLES)


def test_wrapper_checks_its_inputs():
    xs, ys, zs, mask = (torch.from_numpy(a) for a in
                        bls_g1.pack_certificates([[None]], 4))
    with pytest.raises(TypeError):
        bls_g1.aggregate_points(xs.to(torch.int64), ys, zs, mask)
    with pytest.raises(ValueError):
        bls_g1.aggregate_points(xs[:, :2], ys, zs, mask)
    with pytest.raises(ValueError):
        bls_g1.aggregate_points(xs, ys, zs, mask.to("meta"))


def test_malformed_points_raise_instead_of_folding_on_the_host(pool,
                                                              monkeypatch):
    """The device route never gives way to the host fold: a malformed
    point raises, and with the host fold broken the route still works."""
    for bad in [(bls.P, 1), (1,), "point", (1.0, 2)]:
        with pytest.raises(ValueError):
            qc.aggregate([pool[0], bad], device="cpu")

    def no_host_fold(_points):
        raise AssertionError("folded on the host")

    want = bls.aggregate_g1(pool[:3])
    monkeypatch.setattr(bls, "aggregate_g1", no_host_fold)
    assert qc.aggregate(pool[:3], device="cpu") == want
    with pytest.raises(AssertionError, match="folded on the host"):
        qc.aggregate(pool[:3], use_device=False)


def test_device_route_equals_the_explicit_host_fold(pool):
    assert qc.aggregate(pool[:5], device="cpu") == qc.aggregate(
        pool[:5], use_device=False)
    assert qc.aggregate([pool[0], bls_cases.negate(pool[0])],
                        device="cpu") is None


def test_the_default_device_raises_without_a_card(pool):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs the kernel")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        qc.aggregate(pool[:3])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bls_g1.aggregate_signatures([pool[:3]])
    plane = CheckpointCertPlane(quorum=1)
    plane._votes[(20, b"v")] = {0: pool[0]}
    plane._pending.append((20, b"v"))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        plane.certificates()


def _plane_run(recorder_cls, plane, **kwargs):
    r = recorder_cls(4, 2, 60, batch_size=2, checkpoint_certs=plane,
                     **kwargs)
    r.drain_clients(max_steps=400000)
    return r


def test_certificate_plane_equals_the_jax_plane():
    """A 4-node run through each engine with each package's plane: the
    JAX plane folds on the host (its oracle), the port's aggregates with
    the plain version; equal events, statements, signers and points."""
    ref_plane = RefCertPlane(quorum=3, use_device=False)
    ref = _plane_run(RefRecorder, ref_plane)
    plane = CheckpointCertPlane(quorum=3, device="cpu")
    port = _plane_run(BasicRecorder, plane,
                      hash_plane=AsyncKernelHashPlane(device="cpu"))
    assert port.event_count == ref.event_count
    ours, theirs = plane.certificates(), ref_plane.certificates()
    assert len(ours) >= 2
    assert ours == theirs
    assert plane.host_folds == 0 and plane.device_batches == 1
    for (_seq, _value), (signers, asig) in ours.items():
        assert len(signers) == 3 and asig is not None


@pytest.mark.slow
def test_quorum_certificate_end_to_end():
    msg = b"checkpoint seq=40 value=ab12"
    seeds = [bytes([i]) * 4 for i in range(4)]
    pks = [bls.public_key(s) for s in seeds]
    quorum = [0, 1, 3]
    sigs = [bls.sign(seeds[i], msg) for i in quorum]
    asig = qc.aggregate(sigs, device="cpu")
    assert bls.verify_aggregate([pks[i] for i in quorum], msg, asig)
    assert not bls.verify_aggregate([pks[i] for i in quorum], msg + b"!", asig)
    assert not bls.verify_aggregate([pks[i] for i in (0, 1, 2)], msg, asig)
    assert not qc.verify_cert([pks[i] for i in quorum], msg, (1, 2))


@pytest.mark.slow
def test_plane_certificates_verify():
    plane = CheckpointCertPlane(quorum=3, device="cpu")
    _plane_run(BasicRecorder, plane,
               hash_plane=AsyncKernelHashPlane(device="cpu"))
    (seq_no, value), (signers, asig) = sorted(plane.certificates().items())[0]
    assert CheckpointCertPlane.verify(seq_no, value, signers, asig)
    assert not CheckpointCertPlane.verify(seq_no + 1, value, signers, asig)
    assert not CheckpointCertPlane.verify(seq_no, value + b"x", signers, asig)


@pytest.mark.slow
def test_rung4_equals_the_jax_rung():
    """Both packages' rung 4 at full scale, the port's on its plain
    versions: the same events, app chain, commits and first certificate.
    The JAX package's run (bench.py:763-841) gives 241,543 events and the
    chain chip_smoke.py pins."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import bench as ref_bench
    import mirbft_tpu.testengine.engine as ref_engine
    from mirbft_tpu_torch import bench

    made = []
    basic = ref_engine.BasicRecorder

    def capture(*args, **kwargs):
        made.append(basic(*args, **kwargs))
        return made[-1]

    ref_engine.BasicRecorder = capture
    try:
        _rate, events, n_certs, _ms, sim_ms = ref_bench.rung4_run()
    finally:
        ref_engine.BasicRecorder = basic
    ref = made[-1]
    port = bench.rung4_run(device="cpu")
    assert port["events"] == events == 241543
    assert port["sim_ms"] == sim_ms
    assert port["certificates"] == n_certs
    assert port["chain"] == ref.node_states[0].app_chain.hex()
    assert port["commits"] == [512]
    assert port["host_folds"] == 0 and port["device_batches"] == 1
    seq, value, signers, asig = port["certificate"]
    assert asig == bls.aggregate_g1(port["votes"])
