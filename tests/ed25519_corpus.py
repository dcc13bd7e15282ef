"""Point encodings that take every branch of Ed25519 point decompression
(RFC 8032 5.1.3), for the tests, the host rehearsal
(tests/rehearse_cuda.py) and chip_smoke.py.  The port's host oracle
(mirbft_tpu_torch.crypto.ed25519_host) decides what each one decodes to."""

from __future__ import annotations

import random

from mirbft_tpu_torch.crypto import ed25519_host as host


def order8_encoding() -> bytes:
    """A point of order 8: the torsion part of the first small-y point
    that has one."""
    for y in range(2, 100):
        point = host.decompress(int.to_bytes(y, 32, "little"))
        if point is None:
            continue
        torsion = host.scalar_mult(host.L, point)
        if not host.point_equal(host.scalar_mult(4, torsion), host.IDENTITY):
            return host.compress(torsion)
    raise AssertionError("no point of order 8 found")


def decompression_corpus() -> list:
    """41 encodings: y = 0, 1, 2, 3, 7, 9, 10 and p - 1, each with either
    sign bit (no square root, x = 0 with the sign bit set, roots that need
    sqrt(-1), the identity), a point of order 8, and 24 random y < 2^254
    from a seed."""
    encs = [
        int.to_bytes(y | (sign << 255), 32, "little")
        for y in (0, 1, 2, 3, 7, 9, 10, host.P - 1)
        for sign in (0, 1)
    ]
    encs.append(order8_encoding())
    rng = random.Random(4)
    for _ in range(24):
        raw = bytearray(rng.randbytes(32))
        raw[31] &= 0xBF  # y < 2^254 < p
        encs.append(bytes(raw))
    return encs
