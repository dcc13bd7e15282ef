"""Pure-Python BLS12-381 multi-signatures — the host reference.

BASELINE ladder rung 4 calls for BLS quorum-certificate aggregation: 2f+1
replicas sign the same (seq_no, digest) statement, the aggregate signature
is the sum of the G1 signature points, the aggregate public key the sum of
the G2 key points, and one pairing equation verifies the whole quorum:

    e(asig, G2gen) == e(H(m), apk)

This module implements the curve from the public parameters: the Fp2/Fp6/
Fp12 tower, affine group law on E(Fp): y^2 = x^3 + 4 and the twist
E'(Fp2): y^2 = x^3 + 4(1+u), the optimal-ate Miller loop with the
untwist into E(Fp12), and a naive final exponentiation.  Hashing to G1 is
try-and-increment with cofactor clearing (structurally sound; not the
IETF hash-to-curve ciphersuite — fine for an oracle and test signer, do
not use as a production ciphersuite).  Nothing here is constant-time.

The device side (ops/bls_g1.py) aggregates G1 points in batch; this
module is its correctness oracle and performs the pairing verification
(a host-sized job: two pairings per certificate, independent of quorum
size)."""

from __future__ import annotations

import hashlib

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
# BLS parameter x (the curve was generated from it); negative.
X_ABS = 0xD201000000010000
H1_COFACTOR = 0x396C8C005555E1568C00AAAB0000AAAB

G1_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1
G2_X = (
    0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
    0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
)
G2_Y = (
    0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
    0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
)


# -- Fp ---------------------------------------------------------------------


def _inv(a: int) -> int:
    return pow(a, P - 2, P)


# -- Fp2 = Fp[u] / (u^2 + 1) ------------------------------------------------


def f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_mul(a, b):
    return (
        (a[0] * b[0] - a[1] * b[1]) % P,
        (a[0] * b[1] + a[1] * b[0]) % P,
    )


def f2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def f2_inv(a):
    d = _inv((a[0] * a[0] + a[1] * a[1]) % P)
    return (a[0] * d % P, (-a[1]) * d % P)


F2_ZERO = (0, 0)
F2_ONE = (1, 0)
XI = (1, 1)  # the sextic-twist non-residue 1 + u


# -- Fp6 = Fp2[v] / (v^3 - xi);  Fp12 = Fp6[w] / (w^2 - v) -------------------
# Elements: Fp6 = (c0, c1, c2) of Fp2; Fp12 = (c0, c1) of Fp6.


def f6_add(a, b):
    return tuple(f2_add(x, y) for x, y in zip(a, b))


def f6_sub(a, b):
    return tuple(f2_sub(x, y) for x, y in zip(a, b))


def f6_neg(a):
    return tuple(f2_neg(x) for x in a)


def f6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = f2_mul(a0, b0)
    t1 = f2_mul(a1, b1)
    t2 = f2_mul(a2, b2)
    c0 = f2_add(t0, f2_mul(XI, f2_sub(f2_mul(f2_add(a1, a2), f2_add(b1, b2)), f2_add(t1, t2))))
    c1 = f2_add(
        f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)), f2_add(t0, t1)),
        f2_mul(XI, t2),
    )
    c2 = f2_add(f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)), f2_add(t0, t2)), t1)
    return (c0, c1, c2)


def f6_mul_by_xi(a):
    # v * (c0 + c1 v + c2 v^2) = xi*c2 + c0 v + c1 v^2
    return (f2_mul(XI, a[2]), a[0], a[1])


def f6_inv(a):
    a0, a1, a2 = a
    c0 = f2_sub(f2_mul(a0, a0), f2_mul(XI, f2_mul(a1, a2)))
    c1 = f2_sub(f2_mul(XI, f2_mul(a2, a2)), f2_mul(a0, a1))
    c2 = f2_sub(f2_mul(a1, a1), f2_mul(a0, a2))
    t = f2_add(
        f2_mul(a0, c0),
        f2_mul(XI, f2_add(f2_mul(a2, c1), f2_mul(a1, c2))),
    )
    ti = f2_inv(t)
    return (f2_mul(c0, ti), f2_mul(c1, ti), f2_mul(c2, ti))


F6_ZERO = (F2_ZERO, F2_ZERO, F2_ZERO)
F6_ONE = (F2_ONE, F2_ZERO, F2_ZERO)


def f12_add(a, b):
    return (f6_add(a[0], b[0]), f6_add(a[1], b[1]))


def f12_sub(a, b):
    return (f6_sub(a[0], b[0]), f6_sub(a[1], b[1]))


def f12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = f6_mul(a0, b0)
    t1 = f6_mul(a1, b1)
    c0 = f6_add(t0, f6_mul_by_xi(t1))
    c1 = f6_sub(f6_sub(f6_mul(f6_add(a0, a1), f6_add(b0, b1)), t0), t1)
    return (c0, c1)


def f12_inv(a):
    a0, a1 = a
    t = f6_sub(f6_mul(a0, a0), f6_mul_by_xi(f6_mul(a1, a1)))
    ti = f6_inv(t)
    return (f6_mul(a0, ti), f6_neg(f6_mul(a1, ti)))


def f12_conj(a):
    return (a[0], f6_neg(a[1]))  # a^(p^6)


F12_ONE = (F6_ONE, F6_ZERO)


def f12_pow(a, e: int):
    out = F12_ONE
    base = a
    while e:
        if e & 1:
            out = f12_mul(out, base)
        base = f12_mul(base, base)
        e >>= 1
    return out


def _f12_scalar(c: int):
    return (((c % P, 0), F2_ZERO, F2_ZERO), F6_ZERO)


def _f12_from_f2(c):
    return ((c, F2_ZERO, F2_ZERO), F6_ZERO)


# w and its powers (w = (0, 1) in the Fp6[w] tower).
W = (F6_ZERO, F6_ONE)


# -- affine group law (generic over a field given by ops) --------------------


class _Field:
    """Operation bundle so one group law serves Fp, Fp2 and Fp12."""

    def __init__(self, add, sub, mul, inv, neg, zero, one):
        self.add, self.sub, self.mul, self.inv, self.neg = add, sub, mul, inv, neg
        self.zero, self.one = zero, one


FP = _Field(
    lambda a, b: (a + b) % P,
    lambda a, b: (a - b) % P,
    lambda a, b: a * b % P,
    _inv,
    lambda a: (-a) % P,
    0,
    1,
)
FP2 = _Field(f2_add, f2_sub, f2_mul, f2_inv, f2_neg, F2_ZERO, F2_ONE)
FP12 = _Field(f12_add, f12_sub, f12_mul, f12_inv, lambda a: f12_sub((F6_ZERO, F6_ZERO), a), (F6_ZERO, F6_ZERO), F12_ONE)


def pt_add(field: _Field, p1, p2):
    """Affine addition; None is the point at infinity."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 == field.neg(y2) or y1 != y2:
            return None
        # doubling: lambda = 3 x^2 / 2 y  (a = 0)
        num = field.mul(field.mul(x1, x1), _three(field))
        den = field.inv(field.add(y1, y1))
    else:
        num = field.sub(y2, y1)
        den = field.inv(field.sub(x2, x1))
    lam = field.mul(num, den)
    x3 = field.sub(field.sub(field.mul(lam, lam), x1), x2)
    y3 = field.sub(field.mul(lam, field.sub(x1, x3)), y1)
    return (x3, y3)


def _three(field: _Field):
    return field.add(field.add(field.one, field.one), field.one)


def _jac_double(field: _Field, p):
    """Jacobian doubling on y^2 = x^3 + b (a = 0; dbl-2009-l)."""
    x, y, z = p
    a = field.mul(x, x)
    b = field.mul(y, y)
    c = field.mul(b, b)
    t = field.add(x, b)
    d = field.sub(field.sub(field.mul(t, t), a), c)
    d = field.add(d, d)
    e = field.add(field.add(a, a), a)
    f = field.mul(e, e)
    x3 = field.sub(f, field.add(d, d))
    c8 = field.add(c, c)
    c8 = field.add(c8, c8)
    c8 = field.add(c8, c8)
    y3 = field.sub(field.mul(e, field.sub(d, x3)), c8)
    z3 = field.mul(field.add(y, y), z)
    return (x3, y3, z3)


def _jac_add_affine(field: _Field, p, q):
    """Jacobian p + affine q (madd-2007-bl); q must not be infinity."""
    x1, y1, z1 = p
    x2, y2 = q
    z1z1 = field.mul(z1, z1)
    u2 = field.mul(x2, z1z1)
    s2 = field.mul(field.mul(y2, z1), z1z1)
    if u2 == x1:
        if s2 == y1:
            return _jac_double(field, p)
        return None  # p + (-p)
    h = field.sub(u2, x1)
    hh = field.mul(h, h)
    i = field.add(field.add(hh, hh), field.add(hh, hh))
    j = field.mul(h, i)
    r = field.sub(s2, y1)
    r = field.add(r, r)
    v = field.mul(x1, i)
    x3 = field.sub(field.sub(field.mul(r, r), j), field.add(v, v))
    y1j = field.mul(y1, j)
    y3 = field.sub(
        field.mul(r, field.sub(v, x3)), field.add(y1j, y1j)
    )
    z3 = field.mul(field.add(z1, z1), h)
    return (x3, y3, z3)


def pt_mul(field: _Field, scalar: int, point):
    """Double-and-add in Jacobian coordinates (one inversion at the end —
    the affine group law pays a field inversion per addition, which makes
    signing/keygen ~20x slower)."""
    if point is None or scalar == 0:
        return None
    acc = None  # Jacobian accumulator; None is infinity
    for i in range(scalar.bit_length() - 1, -1, -1):
        if acc is not None:
            acc = _jac_double(field, acc)
        if (scalar >> i) & 1:
            if acc is None:
                acc = (point[0], point[1], field.one)
            else:
                acc = _jac_add_affine(field, acc, point)
        if acc is not None and acc[2] == field.zero:
            acc = None
    if acc is None:
        return None
    zi = field.inv(acc[2])
    zi2 = field.mul(zi, zi)
    return (
        field.mul(acc[0], zi2),
        field.mul(acc[1], field.mul(zi2, zi)),
    )


def pt_neg(field: _Field, point):
    if point is None:
        return None
    return (point[0], field.neg(point[1]))


G1 = (G1_X, G1_Y)
G2 = (G2_X, G2_Y)


def g1_on_curve(point) -> bool:
    if point is None:
        return True
    x, y = point
    return (y * y - (x * x * x + 4)) % P == 0


def g2_on_curve(point) -> bool:
    if point is None:
        return True
    x, y = point
    b = f2_mul((4, 0), XI)  # 4(1 + u)
    return f2_sub(f2_mul(y, y), f2_add(f2_mul(x, f2_mul(x, x)), b)) == F2_ZERO


# -- untwist E'(Fp2) -> E(Fp12) ----------------------------------------------
# The twist is M-type with b' = 4*xi and w^6 = xi in this tower, so
# psi(x', y') = (x' / w^2, y' / w^3): then y^2 = y'^2/xi = (x'^3 + 4 xi)/xi
# = x^3 + 4 (checked at import below).

_W2_INV = f12_inv(f12_pow(W, 2))
_W3_INV = f12_inv(f12_pow(W, 3))


def _untwist(q):
    if q is None:
        return None
    x = f12_mul(_f12_from_f2(q[0]), _W2_INV)
    y = f12_mul(_f12_from_f2(q[1]), _W3_INV)
    return (x, y)


def _on_e_fp12(point) -> bool:
    x, y = point
    return f12_sub(
        f12_mul(y, y), f12_add(f12_mul(x, f12_mul(x, x)), _f12_scalar(4))
    ) == (F6_ZERO, F6_ZERO)


assert _on_e_fp12(_untwist(G2)), "untwist map does not land on E(Fp12)"


# -- pairing -----------------------------------------------------------------


def _line(field: _Field, a, b, point):
    """Evaluate the line through a and b (or the tangent at a, when a==b)
    at `point`; a, b must not be inverses of each other."""
    xa, ya = a
    xb, yb = b
    xp, yp = point
    if xa == xb and ya == yb:
        num = field.mul(field.mul(xa, xa), _three(field))
        den = field.add(ya, ya)
    else:
        num = field.sub(yb, ya)
        den = field.sub(xb, xa)
    if den == field.zero:
        # vertical line: x - xa
        return field.sub(xp, xa)
    lam = field.mul(num, field.inv(den))
    return field.sub(field.sub(yp, ya), field.mul(lam, field.sub(xp, xa)))


def _miller_loop(q12, p12):
    f = F12_ONE
    t = q12
    for i in range(X_ABS.bit_length() - 2, -1, -1):
        f = f12_mul(f12_mul(f, f), _line(FP12, t, t, p12))
        t = pt_add(FP12, t, t)
        if (X_ABS >> i) & 1:
            f = f12_mul(f, _line(FP12, t, q12, p12))
            t = pt_add(FP12, t, q12)
    # x is negative for BLS12-381: conjugate the result.
    return f12_conj(f)


def pairing(p, q) -> tuple:
    """e(p, q) for p in G1(Fp) affine, q in G2'(Fp2) affine; None inputs
    (infinity) give the identity."""
    if p is None or q is None:
        return F12_ONE
    p12 = (_f12_scalar(p[0]), _f12_scalar(p[1]))
    f = _miller_loop(_untwist(q), p12)
    # final exponentiation: (p^12 - 1) / r, easy part then naive hard part
    f = f12_mul(f12_conj(f), f12_inv(f))  # f^(p^6 - 1)
    f = f12_mul(f12_pow(f, P * P), f)  # ^(p^2 + 1)
    return f12_pow(f, (P**4 - P**2 + 1) // R)


# -- keys, signing, aggregation ---------------------------------------------


def secret_key(seed: bytes) -> int:
    return int.from_bytes(hashlib.sha512(b"bls-sk" + seed).digest(), "big") % R


def public_key(seed: bytes):
    """pk = [sk]G2 (affine Fp2 pair)."""
    return pt_mul(FP2, secret_key(seed), G2)


def hash_to_g1(message: bytes):
    """Try-and-increment with cofactor clearing (not the IETF suite)."""
    ctr = 0
    while True:
        x = (
            int.from_bytes(
                hashlib.sha256(b"bls-h2c" + ctr.to_bytes(4, "big") + message).digest(),
                "big",
            )
            % P
        )
        rhs = (x * x * x + 4) % P
        y = pow(rhs, (P + 1) // 4, P)
        if y * y % P == rhs:
            point = (x, min(y, P - y))
            return pt_mul(FP, H1_COFACTOR, point)
        ctr += 1


def sign(seed: bytes, message: bytes):
    return pt_mul(FP, secret_key(seed), hash_to_g1(message))


def aggregate_g1(points):
    out = None
    for point in points:
        out = pt_add(FP, out, point)
    return out


def aggregate_g2(points):
    out = None
    for point in points:
        out = pt_add(FP2, out, point)
    return out


def verify_aggregate(pks, message: bytes, asig) -> bool:
    """Quorum-cert check: everyone signed the same message.
    e(asig, G2) == e(H(m), apk)."""
    if asig is None or not g1_on_curve(asig):
        return False
    # Subgroup check: an on-curve point with a cofactor component would be
    # accepted by the pairing equation's bilinear structure; require
    # r·asig = O so the signature is in the order-r subgroup.
    if pt_mul(FP, R, asig) is not None:
        return False
    apk = aggregate_g2(pks)
    if apk is None:
        return False
    return pairing(asig, G2) == pairing(hash_to_g1(message), apk)


def verify(pk, message: bytes, sig) -> bool:
    return verify_aggregate([pk], message, sig)
