"""The port's Ed25519 (mirbft_tpu_torch.ops.ed25519) on the CPU, held
against the JAX package and the RFC 8032 oracle on the same inputs.

CPU tensors take the kernels' plain PyTorch versions.  The port's field
elements are 10 limbs of radix 2^25.5 and the JAX package's 20 limbs of
13 bits, so field results are compared as integers mod p (exactly);
verdicts and decompressed points are compared exactly.  The CUDA kernels
are held against the plain versions in tests/test_torch_chip.py and
chip_smoke.py."""

import collections
import random

import numpy as np
import pytest
import torch

from mirbft_tpu.crypto import ed25519_host as ref_host
from mirbft_tpu.ops import ed25519 as jax_ed25519
from mirbft_tpu.ops import ed25519_pallas as jax_pallas
from mirbft_tpu_torch.crypto import ed25519_host as host
from mirbft_tpu_torch.ops import ed25519 as port

P, L = host.P, host.L
FIELD_VALUES = [0, 1, 19, P - 1, P, P + 1, 2**255 - 1]
FIELD_VALUES += [random.Random(1).randrange(2**260)]


def to_port(jax_limbs) -> np.ndarray:
    """The JAX package's limbs (values below 2^260) -> the port's limbs of
    the same value mod p (folded below 2^255 by 2^255 = 19)."""
    value = jax_ed25519.limbs_to_int(jax_limbs)
    while value >= 1 << 255:
        value = (value & ((1 << 255) - 1)) + 19 * (value >> 255)
    return port.int_to_limbs(value)


def port_field(values) -> torch.Tensor:
    jax_limbs = [jax_ed25519.int_to_limbs(v) for v in values]
    return torch.from_numpy(np.stack([to_port(x) for x in jax_limbs])).to(
        torch.int64
    )


PORT_OPS = {
    "mul": lambda a, b: port._fe_mul(a, b),
    "sqr": lambda a, _b: port._fe_sq(a),
    "add": lambda a, b: port._fe_add(a, b),
    "sub": lambda a, b: port._fe_sub(a, b),
    "canonical": lambda a, _b: port._fe_canonical(a),
}
BIGINT_OPS = {
    "mul": lambda x, y: x * y,
    "sqr": lambda x, _y: x * x,
    "add": lambda x, y: x + y,
    "sub": lambda x, y: x - y,
    "canonical": lambda x, _y: x,
}


@pytest.mark.parametrize("op", ["mul", "add", "sub", "canonical"])
def test_field_ops_match_the_jax_xla_ops(op):
    import jax.numpy as jnp

    vals = FIELD_VALUES
    a_np = np.stack([jax_ed25519.int_to_limbs(v) for v in vals])
    b_np = np.stack([jax_ed25519.int_to_limbs(v) for v in reversed(vals)])
    a, b = jnp.asarray(a_np), jnp.asarray(b_np)
    jax_out = {
        "mul": lambda: jax_ed25519._mul(a, b),
        "add": lambda: jax_ed25519._add(a, b),
        "sub": lambda: jax_ed25519._sub(a, b),
        "canonical": lambda: jax_ed25519._canonical(jax_ed25519._carry(a)),
    }[op]()
    ours = PORT_OPS[op](port_field(vals), port_field(list(reversed(vals))))
    for i, (x, y) in enumerate(zip(vals, reversed(vals))):
        expect = BIGINT_OPS[op](x, y) % P
        assert jax_ed25519.limbs_to_int(jax_out[i]) % P == expect
        assert port.limbs_to_int(ours[i]) % P == expect
    if op == "canonical":
        # Canonical limbs are the value in [0, p), each limb in [0, 2^w).
        assert [port.limbs_to_int(r) for r in ours] == [v % P for v in vals]
        assert bool((ours >= 0).all())


@pytest.fixture(scope="module")
def pallas_field_results():
    """The Pallas slab field helpers in interpret mode on a (1, 8) tile, as
    tests/test_ed25519.py runs them."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    nlimb = jax_ed25519.NLIMB

    def kernel(a_ref, b_ref, mul_ref, sqr_ref, add_ref, sub_ref, can_ref):
        a = [a_ref[i, :, :] for i in range(nlimb)]
        b = [b_ref[i, :, :] for i in range(nlimb)]
        outs = (
            (mul_ref, jax_pallas._mul(a, b)),
            (sqr_ref, jax_pallas._sqr(a)),
            (add_ref, jax_pallas._add(a, b)),
            (sub_ref, jax_pallas._sub(a, b)),
            (can_ref, jax_pallas._canonical(jax_pallas._carry(a))),
        )
        for ref, limbs in outs:
            for i, v in enumerate(limbs):
                ref[i, :, :] = v

    def tile(ints):
        arr = np.stack([jax_ed25519.int_to_limbs(v) for v in ints])
        return jnp.moveaxis(jnp.asarray(arr), 0, 1).reshape(nlimb, 1, 8)

    shape = jax.ShapeDtypeStruct((nlimb, 1, 8), jnp.int32)
    outs = pl.pallas_call(kernel, out_shape=(shape,) * 5, interpret=True)(
        tile(FIELD_VALUES), tile(list(reversed(FIELD_VALUES)))
    )
    names = ("mul", "sqr", "add", "sub", "canonical")
    return {
        name: np.moveaxis(np.asarray(o).reshape(nlimb, 8), 0, 1)
        for name, o in zip(names, outs)
    }


@pytest.mark.parametrize("op", ["mul", "sqr", "add", "sub", "canonical"])
def test_field_ops_match_the_pallas_ops(pallas_field_results, op):
    vals = FIELD_VALUES
    ours = PORT_OPS[op](port_field(vals), port_field(list(reversed(vals))))
    for i, (x, y) in enumerate(zip(vals, reversed(vals))):
        expect = BIGINT_OPS[op](x, y) % P
        theirs = jax_ed25519.limbs_to_int(pallas_field_results[op][i]) % P
        assert theirs == port.limbs_to_int(ours[i]) % P == expect


def test_products_stay_reduced_through_long_chains():
    """The carry bounds of the module note: after any chain of products,
    sums and differences every limb stays within 2^w (so the next product
    cannot overflow int64)."""
    rng = random.Random(9)
    vals = [rng.randrange(P) for _ in range(16)] + [0, 1, P - 1]
    x = port_field(vals)
    y = port_field(list(reversed(vals)))
    expect = list(vals)
    for _ in range(40):
        x = port._fe_mul(port._fe_sub(x, y), port._fe_add(x, y))
        expect = [(e * e - f * f) % P for e, f in zip(expect, reversed(vals))]
        limit = torch.tensor([1 << w for w in port.WIDTHS])
        assert bool((x.abs() <= limit).all())
    assert [port.limbs_to_int(r) % P for r in x] == expect


def test_int_limbs_round_trip():
    rng = random.Random(2)
    for v in [0, 1, P - 1, P, 2**255 - 1] + [rng.randrange(2**255) for _ in range(50)]:
        limbs = port.int_to_limbs(v)
        assert port.limbs_to_int(limbs) == v
        assert all(0 <= int(x) < 1 << w for x, w in zip(limbs, port.WIDTHS))
    with pytest.raises(ValueError):
        port.int_to_limbs(1 << 255)


def test_constants_table():
    table = port.constants()
    assert table.shape == (port.CONST_ROWS, port.NLIMB)
    assert port.limbs_to_int(table[port.CONST_D]) == host.D
    assert port.limbs_to_int(table[port.CONST_D2]) == 2 * host.D % P
    sqrt_m1 = port.limbs_to_int(table[port.CONST_SQRT_M1])
    assert sqrt_m1 * sqrt_m1 % P == P - 1
    for j in range(16):
        row = port.CONST_BTABLE + 4 * j
        x, y, z, t = (port.limbs_to_int(table[row + c]) for c in range(4))
        expect = host.scalar_mult(j, host.to_extended(host.BASE))
        assert host.point_equal((x, y, z, t), expect)
        assert z == 1 and t == x * y % P


# -- decompression --------------------------------------------------------


def encode(y: int, sign: int) -> bytes:
    return int.to_bytes(y | (sign << 255), 32, "little")


def decompress_branch(y: int):
    """Which branch of RFC 8032 §5.1.3 step 3 y takes: "root", "sqrt-1" or
    None (no square root)."""
    u, v = (y * y - 1) % P, (host.D * y * y + 1) % P
    cand = u * pow(v, 3, P) * pow(u * pow(v, 7, P), (P - 5) // 8, P) % P
    if v * cand * cand % P == u:
        return "root"
    if v * cand * cand % P == (-u) % P:
        return "sqrt-1"
    return None


def order8_point() -> bytes:
    """The encoding of a point of order 8 (found from the torsion part of
    small-y points)."""
    for y in range(2, 100):
        pt = host.decompress(encode(y, 0))
        if pt is None:
            continue
        torsion = host.scalar_mult(L, pt)
        if not host.point_equal(host.scalar_mult(4, torsion), host.IDENTITY):
            return host.compress(torsion)
    raise AssertionError("no point of order 8 found")


def edge_encodings() -> list:
    encs = [encode(y, s) for y in (0, 1, 2, 3, 7, 9, 10, P - 1) for s in (0, 1)]
    encs.append(order8_point())
    rng = random.Random(4)
    for _ in range(24):
        raw = bytearray(rng.randbytes(32))
        raw[31] &= 0xBF  # y < 2^254 < p
        encs.append(bytes(raw))
    return encs


def test_edge_corpus_covers_every_branch():
    branches = collections.Counter()
    for e in edge_encodings():
        raw = int.from_bytes(e, "little")
        y, sign = raw & ((1 << 255) - 1), raw >> 255
        branch = decompress_branch(y)
        x = host._recover_x(y, 0) if branch else None
        branches[branch] += 1
        if x == 0 and sign:
            branches["x=0, sign set"] += 1
        if x:
            branches[("parity", (x & 1) ^ sign)] += 1
    assert branches[None] and branches["root"] and branches["sqrt-1"]
    assert branches["x=0, sign set"]
    assert branches[("parity", 0)] and branches[("parity", 1)]


def test_decompress_plain_matches_the_host_oracle():
    encs = edge_encodings()
    xy, ok = port.decompress(torch.from_numpy(port._words(encs)))
    assert xy.dtype == ok.dtype == torch.int32
    for i, e in enumerate(encs):
        expect = ref_host.decompress(e)
        assert host.decompress(e) == expect
        assert bool(ok[i]) == (expect is not None), e.hex()
        if expect is not None:
            assert port.limbs_to_int(xy[i, 0]) == expect[0]
            assert port.limbs_to_int(xy[i, 1]) == expect[1]


# -- verification -----------------------------------------------------------


def signed_corpus(n: int, rng) -> tuple:
    """n signatures: valid, corrupted R, corrupted S, wrong message, in
    turn (as tests/test_ed25519.py builds them)."""
    pks, msgs, sigs = [], [], []
    for i in range(n):
        seed = rng.randbytes(32)
        msg = rng.randbytes(rng.randrange(1, 80))
        pk, sig = host.public_key(seed), host.sign(seed, msg)
        kind = i % 4
        if kind == 1:
            sig = bytes([sig[0] ^ 2]) + sig[1:]
        elif kind == 2:
            sig = sig[:40] + bytes([sig[40] ^ 8]) + sig[41:]
        elif kind == 3:
            msg = msg + b"?"
        pks.append(pk)
        msgs.append(msg)
        sigs.append(sig)
    return pks, msgs, sigs


def edge_signatures() -> tuple:
    """Small-order keys, undecodable points and host-rejected rows."""
    r = 12345
    r_enc = host.compress(host.scalar_mult(r, host.to_extended(host.BASE)))
    s_r = int.to_bytes(r, 32, "little")
    good_pk = host.public_key(b"\x01" * 32)
    good_sig = host.sign(b"\x01" * 32, b"m")
    rows = [
        (encode(1, 0), b"m", r_enc + s_r),  # A = identity: [S]B == R
        (encode(1, 1), b"m", r_enc + s_r),  # x = 0 with the sign bit set
        (order8_point(), b"m", r_enc + s_r),  # A of order 8
        (encode(2, 0), b"m", r_enc + s_r),  # A has no square root
        (good_pk, b"m", encode(2, 0) + good_sig[32:]),  # R has no root
        (encode(P, 0), b"m", good_sig),  # y_A >= p: host reject
        (good_pk, b"m", encode(P + 3, 0) + good_sig[32:]),  # y_R >= p
        (good_pk, b"m", good_sig[:32] + int.to_bytes(L, 32, "little")),
        (good_pk[:31], b"m", good_sig),  # bad key length
        (good_pk, b"m", good_sig[:63]),  # bad signature length
        (good_pk, b"m", good_sig),  # valid
    ]
    return tuple(list(col) for col in zip(*rows))


def corpus(rng) -> tuple:
    pks, msgs, sigs = signed_corpus(10, rng)
    epks, emsgs, esigs = edge_signatures()
    return pks + epks, msgs + emsgs, sigs + esigs


@pytest.mark.parametrize(
    "verify",
    [
        lambda *c: port.verify_batch(*c, device="cpu"),
        lambda *c: port.verify_batch(*c, chunk=3, device="cpu"),
        lambda *c: port.verify_batch_pallas(*c, device="cpu"),
    ],
    ids=["verify_batch", "verify_batch_chunk3", "verify_batch_pallas"],
)
def test_verify_matches_the_jax_package_and_the_oracle(verify):
    pks, msgs, sigs = corpus(random.Random(42))
    expect = [ref_host.verify(*t) for t in zip(pks, msgs, sigs)]
    assert [host.verify(*t) for t in zip(pks, msgs, sigs)] == expect
    assert expect[10] and not expect[11]  # identity key accepted; x=0 not
    assert any(expect) and not all(expect)
    got = verify(pks, msgs, sigs)
    assert got.dtype == bool and got.tolist() == expect
    jax_got = jax_ed25519.verify_batch(pks, msgs, sigs, chunk=8)
    assert jax_got.tolist() == expect


def test_rfc8032_vectors():
    seed1 = bytes.fromhex(
        "9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60"
    )
    pk1 = host.public_key(seed1)
    assert pk1.hex() == (
        "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a"
    )
    sig1 = host.sign(seed1, b"")
    assert sig1.hex() == (
        "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e0652249015"
        "55fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"
    )
    seed2 = bytes.fromhex(
        "4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb"
    )
    msg2 = bytes.fromhex("72")
    pk2, sig2 = host.public_key(seed2), host.sign(seed2, msg2)
    assert sig2.hex() == (
        "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69d"
        "a085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00"
    )
    assert host.verify(pk2, msg2, sig2)
    got = port.verify_batch([pk1, pk2, pk1], [b"", msg2, b"x"],
                            [sig1, sig2, sig1], device="cpu")
    assert got.tolist() == [True, True, False]


def test_marshal_light_rejects_the_same_rows_as_the_jax_package():
    pks, msgs, sigs = corpus(random.Random(7))
    for triple in zip(pks, msgs, sigs):
        assert port.marshal_light(*triple) == jax_pallas.marshal_light(*triple)
    rejected = [port.marshal_light(*t) is None for t in zip(pks, msgs, sigs)]
    assert rejected[-6:] == [True, True, True, True, True, False]


def test_pack_rows_launches_exactly_n_rows():
    pks, msgs, sigs = signed_corpus(5, random.Random(3))
    rows = [port.marshal_light(*t) for t in zip(pks, msgs, sigs)]
    enc, s_words, k_words = port.pack_rows(rows)
    assert enc.shape == (10, 8) and s_words.shape == k_words.shape == (5, 8)
    assert enc.dtype == s_words.dtype == np.int32
    assert enc[:5].tobytes() == b"".join(pks)
    assert port.launch_rows(rows, device="cpu").shape == (5,)
    with pytest.raises(ValueError, match="at least one"):
        port.launch_rows([], device="cpu")


def test_field_op_counts_per_row(monkeypatch):
    """The bounds' op counts are the plain versions' calls, which are the
    kernels' calls."""
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
    enc, s_words, k_words = (
        torch.from_numpy(a)
        for a in port.pack_rows([port.marshal_light(pks[0], msgs[0], sigs[0])])
    )
    xy, ok = port.decompress_plain(enc[:1])
    assert dict(counts) == port.DECOMPRESS_OPS
    xy, ok = port.decompress_plain(enc)
    counts.clear()
    assert port.ladder_plain(xy, ok, s_words, k_words).tolist() == [1]
    assert dict(counts) == port.LADDER_OPS
    assert port.int_ops_per_row(port.LADDER_OPS) > 100 * port.int_ops_per_row(
        {"mul": 1}
    )


def test_other_devices_raise():
    enc = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no ed25519 path"):
        port.decompress(enc)
