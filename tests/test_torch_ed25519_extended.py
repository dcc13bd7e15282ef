"""The port's host route of Ed25519 verification (mirbft_tpu_torch.ops.ed25519:
``marshal_signature``, ``pack_signature_rows``, ``from_jax_rows`` and the
extended ladder's plain version) on the CPU, held against the JAX
package's ``ops/ed25519.py`` route on the same inputs: its
``marshal_signature``, its ``pack_rows`` arrays, and ``ladder_impl`` under
``jax.jit``, the XLA twin of the Pallas ``_ladder_kernel`` with the same
input form (-A extended, R affine).  Verdicts and converted limbs are
compared exactly.  The CUDA kernel is held against the plain version in
tests/test_torch_chip.py, chip_smoke.py and, on the host,
tests/test_torch_rehearse.py."""

import collections
import functools
import random

import numpy as np
import pytest
import torch

from ed25519_corpus import decompression_corpus
from mirbft_tpu.ops import ed25519 as jax_ed25519
from mirbft_tpu_torch.crypto import ed25519_host as host
from mirbft_tpu_torch.ops import ed25519 as port
from test_torch_ed25519 import edge_signatures, signed_corpus

P, L = host.P, host.L


def _rows(rng) -> list:
    """10 signed rows (valid, corrupted R, corrupted S, wrong message in
    turn) and the edge rows of tests/test_torch_ed25519.py, as (pk, msg,
    sig)."""
    pks, msgs, sigs = signed_corpus(10, rng)
    epks, emsgs, esigs = edge_signatures()
    return list(zip(pks + epks, msgs + emsgs, sigs + esigs))


def _accepted(rows) -> list:
    """The rows both packages' ``marshal_signature`` accept."""
    return [row for row in rows if port.marshal_signature(*row) is not None]


def _corpus_rows() -> list:
    """Each encoding of the decompression corpus as a key (under a
    signature the identity key satisfies) and as R (under a valid key and
    S), then the edge rows: every branch of decompression on both points,
    and the host's structural rejects."""
    r = 12345
    r_enc = host.compress(host.scalar_mult(r, host.to_extended(host.BASE)))
    r_sig = r_enc + int.to_bytes(r, 32, "little")
    good_pk = host.public_key(b"\x02" * 32)
    good_sig = host.sign(b"\x02" * 32, b"m")
    rows = []
    for enc in decompression_corpus():
        rows.append((enc, b"m", r_sig))
        rows.append((good_pk, b"m", enc + good_sig[32:]))
    return rows + list(zip(*edge_signatures()))


@functools.lru_cache(maxsize=None)
def _jax_case(seed: int, batch_floor: int = 8) -> tuple:
    """(the accepted rows, the JAX ``pack_rows`` arrays of their JAX
    ``marshal_signature`` rows) for ``_rows(Random(seed))``."""
    rows = _accepted(_rows(random.Random(seed)))
    marshalled = [jax_ed25519.marshal_signature(*row) for row in rows]
    return rows, jax_ed25519.pack_rows(marshalled, batch_floor=batch_floor)


def _jax_verdicts(packed) -> list:
    return np.asarray(jax_ed25519._ladder(*packed)).astype(int).tolist()


def _port_verdicts(packed_jax) -> list:
    s_words, k_words, neg_a, r_xy = (
        torch.from_numpy(a) for a in port.from_jax_rows(*packed_jax)
    )
    return port.ladder_extended(neg_a, r_xy, s_words, k_words).tolist()


def _scaled(packed, seed: int):
    """The JAX arrays with each row's -A times its own seeded lambda
    (X, Y, Z, T all: the same point, Z != 1)."""
    rng = random.Random(seed)
    s_bits, k_bits, neg_a, r_aff = packed
    lams = [rng.randrange(2, P) for _ in range(len(s_bits))]
    scaled = tuple(
        np.stack([
            jax_ed25519.int_to_limbs(jax_ed25519.limbs_to_int(row) * lam % P)
            for row, lam in zip(np.asarray(coord), lams)
        ])
        for coord in neg_a
    )
    return s_bits, k_bits, scaled, r_aff


def test_from_jax_rows_equals_the_ports_own_packing():
    """The JAX ``pack_rows`` arrays, converted, hold exactly the limbs and
    words ``pack_signature_rows`` makes from the port's rows; its padding
    rows repeat row 0."""
    rows, packed = _jax_case(7)
    n = len(rows)
    assert len(packed[0]) == 16 > n
    got = port.from_jax_rows(*packed)
    want = port.pack_signature_rows(
        [port.marshal_signature(*row) for row in rows])
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        assert np.array_equal(g[:n], w)
        assert all(np.array_equal(g[i], w[0]) for i in range(n, len(g)))
    # Padded only to a multiple of batch_floor, not to a power of two.
    padded = port.pack_signature_rows(
        [port.marshal_signature(*row) for row in rows], batch_floor=5)
    assert len(padded[0]) == -(-n // 5) * 5
    with pytest.raises(ValueError, match="at least one row"):
        port.pack_signature_rows([])


def test_extended_ladder_equals_the_jax_ladder_impl():
    """``ladder_extended_plain`` and the JAX ``ladder_impl`` (jit, CPU) on
    the same converted ``pack_rows`` arrays, padding rows included: equal
    verdicts, and the oracle's on every real row."""
    rows, packed = _jax_case(7)
    want = _jax_verdicts(packed)
    got = _port_verdicts(packed)
    assert got == want
    oracle = [int(host.verify(*row)) for row in rows]
    assert got[: len(rows)] == oracle
    assert any(oracle) and not all(oracle)
    assert got[len(rows):] == [oracle[0]] * (len(got) - len(rows))


def test_extended_ladder_takes_any_extended_representation():
    """-A scaled by a seeded lambda a row (Z != 1), as the JAX kernel's
    contract allows: the same verdicts on both packages as at Z = 1."""
    rows, packed = _jax_case(7)
    scaled = _scaled(packed, seed=11)
    assert all(
        jax_ed25519.limbs_to_int(z) != 1 for z in np.asarray(scaled[2][2]))
    want = _jax_verdicts(packed)
    assert _jax_verdicts(scaled) == want
    assert _port_verdicts(scaled) == want


def test_marshal_signature_rejects_the_rows_the_jax_one_rejects():
    """Over the decompression corpus (as key and as R), the edge rows and
    ten signed rows: None on exactly the same rows, equal ints elsewhere
    (the JAX scalars are 256 MSB-first bits)."""
    rows = _corpus_rows() + _rows(random.Random(3))
    rejected = 0
    for row in rows:
        ours = port.marshal_signature(*row)
        theirs = jax_ed25519.marshal_signature(*row)
        assert (ours is None) == (theirs is None), row
        if ours is None:
            rejected += 1
            continue
        s, k, neg_a, r = ours
        bits = [int("".join(map(str, b.tolist())), 2) for b in theirs[:2]]
        assert (s, k) == tuple(bits)
        assert tuple(neg_a) == tuple(theirs[2])
        assert tuple(r) == tuple(theirs[3])
    assert 0 < rejected < len(rows)


def test_host_route_and_device_route_agree_over_the_corpus():
    """Every row of the decompression corpus and the edge rows through the
    host route (``marshal_signature``, then the extended ladder) and the
    device route (``verify_batch``): the same verdicts, the oracle's."""
    rows = _corpus_rows()
    marshalled = [port.marshal_signature(*row) for row in rows]
    live = [i for i, m in enumerate(marshalled) if m is not None]
    verdicts = port.launch_signature_rows(
        [marshalled[i] for i in live], device="cpu").tolist()
    host_route = [False] * len(rows)
    for i, v in zip(live, verdicts):
        host_route[i] = bool(v)
    device_route = port.verify_batch(*map(list, zip(*rows)), device="cpu")
    assert host_route == device_route.tolist()
    assert host_route == [host.verify(*row) for row in rows]
    assert any(host_route)


def test_launch_signature_rows_pads_to_the_batch_floor():
    rows, _packed = _jax_case(7)
    marshalled = [port.marshal_signature(*row) for row in rows]
    got = port.launch_signature_rows(marshalled, device="cpu", batch_floor=4)
    assert got.shape == (-(-len(rows) // 4) * 4,)
    assert got[: len(rows)].tolist() == [
        int(host.verify(*row)) for row in rows]


def test_extended_ladder_refuses_bad_shapes_and_devices():
    rows, _packed = _jax_case(7)
    s_words, k_words, neg_a, r_xy = (
        torch.from_numpy(a) for a in port.pack_signature_rows(
            [port.marshal_signature(*row) for row in rows[:2]])
    )
    with pytest.raises(ValueError, match="neg_a must be"):
        port.ladder_extended(neg_a[:, :3], r_xy, s_words, k_words)
    with pytest.raises(TypeError, match="int32"):
        port.ladder_extended(neg_a.long(), r_xy, s_words, k_words)
    with pytest.raises(ValueError, match="no ed25519 path"):
        port.ladder_extended(*(t.to("meta") for t in (
            neg_a, r_xy, s_words, k_words)))
    empty = port.ladder_extended(neg_a[:0], r_xy[:0], s_words[:0],
                                 k_words[:0])
    assert empty.shape == (0,)


def test_extended_ladder_op_counts_per_row(monkeypatch):
    """``LADDER_EXTENDED_OPS`` is the plain version's calls: the ladder's
    without -A's negation and its T product."""
    counts = collections.Counter()
    mul = port._fe_mul

    def counted(name, fn):
        def wrapper(*args):
            counts[name] += 1
            return fn(*args)

        return wrapper

    monkeypatch.setattr(port, "_fe_mul", counted("mul", mul))
    monkeypatch.setattr(port, "_fe_sq", counted("sqr", lambda f: mul(f, f)))
    monkeypatch.setattr(port, "_fe_add", counted("addsub", port._fe_add))
    monkeypatch.setattr(port, "_fe_sub", counted("addsub", port._fe_sub))
    monkeypatch.setattr(
        port, "_fe_canonical", counted("canonical", port._fe_canonical)
    )
    pks, msgs, sigs = signed_corpus(1, random.Random(5))
    s_words, k_words, neg_a, r_xy = (
        torch.from_numpy(a) for a in port.pack_signature_rows(
            [port.marshal_signature(pks[0], msgs[0], sigs[0])])
    )
    assert port.ladder_extended_plain(
        neg_a, r_xy, s_words, k_words).tolist() == [1]
    assert dict(counts) == port.LADDER_EXTENDED_OPS
    assert port.LADDER_EXTENDED_STAGES == port.LADDER_STAGES - 1
    assert (port.chain_floor_cycles("ladder")
            > port.chain_floor_cycles("ladder_extended"))


@pytest.mark.slow
def test_extended_ladder_equals_the_pallas_ladder_kernel_in_interpret_mode():
    """The Pallas ``_ladder_kernel`` itself, run by ``pl.pallas_call(...,
    interpret=True)`` on one (1, 8) tile built here, against the port's
    plain version on the same converted rows.  Slow and large: on an
    8-core CPU it had not finished after 78 minutes, by which time the
    process held about 50 GB, so run it only on a host with that memory
    to spare."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from mirbft_tpu.ops import ed25519_pallas as jax_pallas

    rows, packed = _jax_case(7)
    rows = rows[:8]
    s_bits, k_bits, neg_a, r_aff = (
        packed[0][:8], packed[1][:8],
        tuple(np.asarray(c)[:8] for c in packed[2]),
        tuple(np.asarray(c)[:8] for c in packed[3]),
    )

    def windows(bits):
        return np.asarray(bits).reshape(8, 64, 4) @ np.array([8, 4, 2, 1])

    def tile(x):  # (8, ...) -> (..., 1, 8)
        return jnp.asarray(np.moveaxis(np.asarray(x, np.int32), 0, -1)
                           [..., None, :])

    shape = (1, 8)
    out = pl.pallas_call(
        functools.partial(jax_pallas._ladder_kernel, shape=shape),
        out_shape=jax.ShapeDtypeStruct((1, 1, 8), jnp.int32),
        grid=(1,),
        in_specs=[
            pl.BlockSpec((64, 1, 8), lambda i: (0, 0, 0)),
            pl.BlockSpec((64, 1, 8), lambda i: (0, 0, 0)),
            pl.BlockSpec((4, 20, 1, 8), lambda i: (0, 0, 0, 0)),
            pl.BlockSpec((2, 20, 1, 8), lambda i: (0, 0, 0, 0)),
        ],
        out_specs=pl.BlockSpec((1, 1, 8), lambda i: (0, 0, 0)),
        interpret=True,
    )(
        tile(windows(s_bits)), tile(windows(k_bits)),
        tile(np.stack(neg_a, axis=1)), tile(np.stack(r_aff, axis=1)),
    )
    want = np.asarray(out).reshape(8).tolist()
    got = _port_verdicts((s_bits, k_bits, neg_a, r_aff))
    assert got == want == [int(host.verify(*row)) for row in rows]
