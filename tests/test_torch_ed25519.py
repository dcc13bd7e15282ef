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
from ed25519_corpus import decompression_corpus, order8_encoding
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
    sqrt_m1 = port.limbs_to_int(table[port.CONST_SQRT_M1])
    assert sqrt_m1 * sqrt_m1 % P == P - 1


def test_constant_2d_is_the_oracles():
    table = port.constants()
    assert port.limbs_to_int(table[port.CONST_D2]) == 2 * host.D % P
    assert port.limbs_to_int(table[port.CONST_D2]) == 2 * ref_host.D % P


@pytest.mark.parametrize("j", range(16))
def test_niels_rows_are_the_oracles_multiples_of_b(j):
    """Row j of the [j]B table: (y - x, y + x, 2d x y) of the affine point
    [j]B from the host oracle (the identity for j = 0)."""
    table = port.constants()
    row = port.CONST_NIELS + 3 * j
    ymx, ypx, t2d = (port.limbs_to_int(table[row + c]) for c in range(3))
    expect = ref_host.scalar_mult(j, ref_host.to_extended(ref_host.BASE))
    z_inv = pow(expect[2], P - 2, P)
    x, y = expect[0] * z_inv % P, expect[1] * z_inv % P
    assert (ymx, ypx, t2d) == ((y - x) % P, (y + x) % P, 2 * host.D * x * y % P)
    # Back to the point: x = (ypx - ymx) / 2, y = (ypx + ymx) / 2.
    half = pow(2, P - 2, P)
    point = ((ypx - ymx) * half % P, (ypx + ymx) * half % P)
    assert host.point_equal((*point, 1, point[0] * point[1] % P), expect)
    if j == 0:
        assert (ymx, ypx, t2d) == (1, 1, 0)


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


def test_edge_corpus_covers_every_branch():
    branches = collections.Counter()
    for e in decompression_corpus():
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
    encs = decompression_corpus()
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
        (order8_encoding(), b"m", r_enc + s_r),  # A of order 8
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
    """The bounds' op counts are the plain versions' calls, which follow
    the kernels' formulas."""
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


def test_ladder_products_per_row_in_the_new_formulas():
    """The ladder's products a row, from the formulas and the windows: a
    doubling 4 squarings and 4 products, an addition of a cached [j](-A) 8
    products, of a Niels [j]B 7 (no d product, and 2 Z1 a sum), a
    conversion to cached form 1; each doubling or addition one product
    fewer where only a doubling or the comparison reads it, since neither
    reads T.  -A's T (1), 15 conversions, 14 table additions (each read by
    a conversion, so with T), 64 windows, 2 products against R."""
    doubling = {"sqr": 4, "mul": 4}
    cached_add, niels_add = 8, 7
    # A window: doublings 1-3 feed a doubling, doubling 4 the [j]B
    # addition, which feeds the [j](-A) addition, which feeds the next
    # window's first doubling or, in the last window, the comparison.
    reads_t = [False, False, False, True]
    window = sum(doubling["mul"] - (not t) for t in reads_t)
    window += niels_add + (cached_add - 1)
    assert window == 27
    products = 1 + 15 * 1 + 14 * cached_add + 64 * window + 2
    assert port.LADDER_OPS["mul"] == products == 1858
    assert port.LADDER_OPS["sqr"] == 64 * 4 * doubling["sqr"] == 1024
    # Against the one-thread ladder of extended [j]B points (2305: 9
    # products an addition, T made by every doubling and addition): 3 a
    # window from the cached and Niels forms, 4 a window from T, 1 less a
    # row for -A's T computed once.
    assert 2305 - port.LADDER_OPS["mul"] == 64 * 3 - 1 + 64 * 4


def test_ladder_stage_count_and_chain_floor():
    """The quad ladder's product stages on one row's path, and the chain
    floor they give: each stage a product's or squaring's least chain
    (three accumulators a column, a parallel carry of two rounds) plus a
    shuffle, a select and an add, 4 cycles a dependent instruction."""
    assert port.LADDER_STAGES == 2 + 14 * 3 + 64 * (4 * 2 + 2 * 2) + 1 == 813
    assert port.CARRY_CHAIN == (2 + 1 + 2) + (2 + 1 + 1) == 9
    assert port.MUL_CHAIN == 4 + 2 + 9 == 15
    assert port.SQR_CHAIN == 2 + 2 + 9 == 13
    assert port.LADDER_SQR_STAGES == 64 * 4
    assert port.chain_floor_cycles("ladder") == (
        (813 - 256) * (15 + 3) + 256 * (13 + 3)
    ) * 4
    assert port.chain_floor_cycles("decompress") == (17 * 15 + 255 * 13) * 4
    # Decompression's chain is all of its squarings and all of its
    # products but the two off the path (u v^3 and x sqrt(-1)).
    assert port.DECOMPRESS_CHAIN_SQR == port.DECOMPRESS_OPS["sqr"]
    assert port.DECOMPRESS_CHAIN_MUL == port.DECOMPRESS_OPS["mul"] - 2


def test_other_devices_raise():
    enc = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no ed25519 path"):
        port.decompress(enc)


def test_ladder_carry_bounds_hold():
    """The bounds csrc/ed25519.cu states for its lazy sums, checked by
    interval arithmetic: a carried element's limbs are within
    U_w = 2^(w-1) (1 + 2^-9); a product of a 4-term f and a 3-term g (the
    widest the ladder makes) keeps its premultiplied limbs in int32 and its
    columns in int64; ref10's 12-step carry chain brings such columns back
    within U_w; and so does a squaring of a 2-term element."""
    widths = port.WIDTHS
    carried = [(1 << (w - 1)) * (1 + 2**-9) for w in widths]

    def columns(f, g, square=False):
        col = [0.0] * 10
        for i in range(10):
            for j in range(i if square else 0, 10):
                a = f[i] * (2 if i % 2 and j % 2 else 1)
                if square and i != j:
                    a *= 2
                b = g[j] * (19 if i + j >= 10 else 1)
                assert a < 2**31 and b < 2**31  # int32 operands
                col[(i + j) % 10] += a * b
        assert max(col) < 2**63  # int64 columns
        return col

    def chain(col):
        h = list(col)
        for i in (0, 4, 1, 5, 2, 6, 3, 7, 4, 8, 9, 0):
            w = widths[i]
            c = (h[i] + (1 << (w - 1))) // (1 << w) + 1  # a carry's size
            h[i] = 1 << (w - 1)
            if i == 9:
                h[0] += 19 * c
            else:
                h[i + 1] += c
        return h

    term = lambda k: [k * u for u in carried]  # noqa: E731
    for f, g, square in (
        (term(4), term(3), False),  # doubling: F E
        (term(2), term(2), False),  # addition: E F, G H; stage A
        (term(2), term(2), True),   # doubling: (X + Y)^2
    ):
        out = chain(columns(f, g, square))
        assert all(h <= u for h, u in zip(out, carried)), out


def split_columns(f, g, pair):
    """Pair ``pair``'s two columns of f g as decompression's split product
    forms them (csrc/ed25519.cu::sp_product): f's pair P with g's pair
    (pair - P) mod 5, and its odd limb with g's pair (pair - P - 1) mod 5
    in the even column, g times 19 where the pair index wraps, f's odd limb
    doubled in the even column.  Returns the columns and the premultiplied
    operands (exact on integers, bounds on magnitudes)."""
    lo = hi = 0
    operands = []
    for p in range(5):
        r, r1 = (pair - p) % 5, (pair - p - 1) % 5
        w, w1 = (19 if p > pair else 1), (19 if p + 1 > pair else 1)
        fe, fo = f[2 * p], f[2 * p + 1]
        g_lo, g_hi, g1_hi = w * g[2 * r], w * g[2 * r + 1], w1 * g[2 * r1 + 1]
        operands += [2 * fo, g_lo, g_hi, g1_hi]
        lo += fe * g_lo + 2 * fo * g1_hi
        hi += fe * g_hi + fo * g_lo
    return (lo, hi), operands


def test_split_product_forms_the_schoolbook_columns():
    """Every pair's two columns, as the split product forms them, equal the
    plain product's columns exactly (the same terms and factors)."""
    rng = random.Random(6)
    for _ in range(20):
        f = [rng.randrange(-(1 << w), 1 << w) for w in port.WIDTHS]
        g = [rng.randrange(-(1 << w), 1 << w) for w in port.WIDTHS]
        want = (torch.tensor(f)[port._IDX] * torch.tensor(g) * port._COEF).sum(-1)
        got = [c for pair in range(5) for c in split_columns(f, g, pair)[0]]
        assert got == want.tolist()


def test_split_carry_bounds_hold():
    """The bounds csrc/ed25519.cu states for decompression's split
    product, checked by interval arithmetic on magnitudes.  Operands with
    |limb| < 2^w (y's raw limbs, the constants, and every carried element,
    whose limbs are within U_w = 2^(w-1) (1 + 2^-9)): the doubled odd limbs
    and 19 g fit int32, the columns int64.  The split carry (each pair
    rounds its low column into its high one and that; the high column's
    carry goes to the next pair's owner, pair 4's times 19 to pair 0; the
    low column rounds once more into the high one) brings a product's or a
    squaring's columns, and a sum's or difference's of two carried
    elements, back within U_w, which every product accepts.  And the chain
    floor's parallel carry (ops/ed25519.py::CARRY_CHAIN): two rounds of
    every limb at once bring the ladder's widest columns (a 4-term times a
    3-term product, as test_ladder_carry_bounds_hold forms them) back
    within U_w."""
    widths = port.WIDTHS
    carried = [(1 << (w - 1)) * (1 + 2**-9) for w in widths]
    raw = [float(1 << w) for w in widths]

    def carry_size(value, w):  # |round(value / 2^w)| at most
        return (value + (1 << (w - 1))) / (1 << w) + 1

    def split_carry(cols):
        out, carries = [], []
        for pair in range(5):
            lo, hi = cols[2 * pair], cols[2 * pair + 1]
            hi += carry_size(lo, 26)
            carries.append(carry_size(hi, 25))
        for pair in range(5):
            lo = (1 << 25) + carries[pair - 1] * (19 if pair == 0 else 1)
            out += [1 << 25, (1 << 24) + carry_size(lo, 26)]
        return out

    for f, g in ((raw, raw), (carried, carried)):
        cols = []
        for pair in range(5):
            pair_cols, operands = split_columns(f, g, pair)
            assert max(operands) < 2**31  # int32 operands
            cols += pair_cols
        assert max(cols) < 2**63  # int64 columns
        out = split_carry(cols)
        assert all(h <= u for h, u in zip(out, carried)), out
    sums = split_carry([2 * u for u in carried])
    assert all(h <= u for h, u in zip(sums, carried)), sums

    def parallel_round(cols):
        carries = [carry_size(h, w) for h, w in zip(cols, widths)]
        return [(1 << (w - 1)) + carries[k - 1] * (19 if k == 0 else 1)
                for k, w in enumerate(widths)]

    widest = [0.0] * 10
    for i in range(10):
        for j in range(10):
            a = 4 * carried[i] * (2 if i % 2 and j % 2 else 1)
            b = 3 * carried[j] * (19 if i + j >= 10 else 1)
            widest[(i + j) % 10] += a * b
    assert max(widest) < 2**61.2
    out = parallel_round(parallel_round(widest))
    assert all(h <= u for h, u in zip(out, carried)), out
