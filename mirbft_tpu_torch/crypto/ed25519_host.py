"""Pure-Python Ed25519 (RFC 8032) — the host reference implementation.

This is the correctness oracle for the batched Ed25519 kernels
(ops/ed25519.py), and the signer used by test harnesses (signing is a
client-side operation; replicas only ever verify — reference: the library
leaves request authentication to the consumer, mirbft.go:297-301, which is
exactly the seam BASELINE.md rung 3 fills with batched sig-verify).

Implemented straight from the RFC 8032 specification over Python bigints.
Not constant-time — fine for a verifier oracle and test signer; never use
for production signing keys.
"""

from __future__ import annotations

import hashlib

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P

_BY = (4 * pow(5, P - 2, P)) % P
_BX = None  # computed below


def _inv(x: int) -> int:
    return pow(x, P - 2, P)


def _sqrt_ratio(u: int, v: int) -> int | None:
    """x with x^2 * v == u (mod P), or None (RFC 8032 §5.1.3)."""
    cand = (u * pow(v, 3, P)) % P * pow((u * pow(v, 7, P)) % P, (P - 5) // 8, P) % P
    if (v * cand * cand) % P == u % P:
        return cand
    if (v * cand * cand) % P == (-u) % P:
        return (cand * pow(2, (P - 1) // 4, P)) % P
    return None


def _recover_x(y: int, sign: int) -> int | None:
    if y >= P:
        return None
    u = (y * y - 1) % P
    v = (D * y * y + 1) % P
    x = _sqrt_ratio(u, v)
    if x is None:
        return None
    if x == 0 and sign == 1:
        return None
    if x % 2 != sign:
        x = P - x
    return x


_BX = _recover_x(_BY, 0)
BASE = (_BX, _BY)  # the standard base point B


# -- point arithmetic (extended twisted Edwards, a = -1) ---------------------


def point_add(p, q):
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = 2 * t1 * t2 * D % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


IDENTITY = (0, 1, 1, 0)


def to_extended(affine):
    x, y = affine
    return (x, y, 1, x * y % P)


def scalar_mult(scalar: int, point) -> tuple:
    acc = IDENTITY
    addend = point
    while scalar:
        if scalar & 1:
            acc = point_add(acc, addend)
        addend = point_add(addend, addend)
        scalar >>= 1
    return acc


def point_negate(p):
    x, y, z, t = p
    return ((-x) % P, y, z, (-t) % P)


def point_equal(p, q) -> bool:
    x1, y1, z1, _ = p
    x2, y2, z2, _ = q
    return (x1 * z2 - x2 * z1) % P == 0 and (y1 * z2 - y2 * z1) % P == 0


def compress(p) -> bytes:
    x, y, z, _ = p
    zi = _inv(z)
    x, y = x * zi % P, y * zi % P
    return int.to_bytes(y | ((x & 1) << 255), 32, "little")


def decompress(data: bytes):
    """Encoded point -> extended coordinates, or None if invalid."""
    if len(data) != 32:
        return None
    raw = int.from_bytes(data, "little")
    sign = raw >> 255
    y = raw & ((1 << 255) - 1)
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


# -- RFC 8032 keygen / sign / verify ----------------------------------------


def _clamp(h: bytes) -> int:
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a


def public_key(seed: bytes) -> bytes:
    h = hashlib.sha512(seed).digest()
    return compress(scalar_mult(_clamp(h), to_extended(BASE)))


def sign(seed: bytes, message: bytes) -> bytes:
    h = hashlib.sha512(seed).digest()
    a = _clamp(h)
    pk = compress(scalar_mult(a, to_extended(BASE)))
    r = int.from_bytes(hashlib.sha512(h[32:] + message).digest(), "little") % L
    r_enc = compress(scalar_mult(r, to_extended(BASE)))
    k = (
        int.from_bytes(
            hashlib.sha512(r_enc + pk + message).digest(), "little"
        )
        % L
    )
    s = (r + k * a) % L
    return r_enc + int.to_bytes(s, 32, "little")


def verify(pk: bytes, message: bytes, signature: bytes) -> bool:
    if len(signature) != 64:
        return False
    a = decompress(pk)
    r = decompress(signature[:32])
    if a is None or r is None:
        return False
    s = int.from_bytes(signature[32:], "little")
    if s >= L:
        return False
    k = (
        int.from_bytes(
            hashlib.sha512(signature[:32] + pk + message).digest(), "little"
        )
        % L
    )
    # [s]B == R + [k]A  <=>  [s]B + [k](-A) == R
    lhs = point_add(
        scalar_mult(s, to_extended(BASE)),
        scalar_mult(k, point_negate(a)),
    )
    return point_equal(lhs, r)
