"""Seeded certificates for the BLS G1 aggregation kernel and its plain
version, built with the port's host oracle (``crypto/bls_host.py``).

Each case is ``(label, certs, voters)``: ``certs`` a list of certificates,
each a list of affine G1 points or None for an absent voter, ``voters``
the width to pad to (None: the longest certificate's).  The shapes are
the launches (batch, width) that ``ops/bls_g1.pack_certificates`` makes
of them: rung 4's (4, 128) (one certificate of 85 votes, f = 42), rung
5's (4, 256) (171 votes, f = 85), a full (64, 128) and a small (4, 4),
and two edge launches: absent voters in the middle of a certificate, a
certificate with no vote (its sum is the identity: None), one voter twice
(the addition doubles), P with -P (the identity again) and the
generator.  ``width_cases`` adds launches at widths 1, 85 and 200, which
no split of a certificate's lanes divides.

Points are the signatures of a few seeds over one statement, and sums of
those (an affine addition is far cheaper than a signature), so a case
needs a handful of signatures however wide it is.  The port's tests, the
host rehearsal of the CUDA source (tests/rehearse_cuda.py), the gpu tests
and the card (chip_smoke.py) all take the same cases.
"""

from __future__ import annotations

import random

SEED = 0xB15
SIGNED = 8  # signatures a pool starts from


def point_pool(count: int, seed: int = SEED) -> list:
    """``count`` distinct G1 points: the first SIGNED signatures of seeded
    keys over one statement, then each the sum of the one before and one
    of the signatures."""
    from mirbft_tpu_torch.crypto import bls_host

    rng = random.Random(seed)
    base = [
        bls_host.sign(b"bls-case-%d-%d" % (seed, i), b"checkpoint 20 case")
        for i in range(min(count, SIGNED))
    ]
    pool = list(base)
    while len(pool) < count:
        pool.append(bls_host.pt_add(bls_host.FP, pool[-1],
                                    base[rng.randrange(len(base))]))
    return pool


def negate(point):
    from mirbft_tpu_torch.crypto import bls_host

    return (point[0], (-point[1]) % bls_host.P)


def generator():
    from mirbft_tpu_torch.crypto import bls_host

    return (bls_host.G1_X, bls_host.G1_Y)


def quorum_certificate(pool: list, votes: int) -> list:
    """One certificate as the certificate plane sends it: ``votes``
    signatures from voter 0 on (the sorted signers), padded to ``width``
    by the packer."""
    return [pool[i % len(pool)] for i in range(votes)]


def random_certificates(rng, pool: list, batch: int, width: int) -> list:
    """``batch`` certificates of ``width`` slots, each voter present with
    probability 2/3 and at least one present."""
    certs = []
    for _ in range(batch):
        cert = [pool[rng.randrange(len(pool))] if rng.random() < 2 / 3
                else None for _ in range(width)]
        if all(p is None for p in cert):
            cert[rng.randrange(width)] = pool[rng.randrange(len(pool))]
        certs.append(cert)
    return certs


def edge_cases(pool: list) -> list:
    a, b, c, d, e, f = pool[:6]
    return [
        ("edges (4, 4): absent voters in the middle, no vote, a doubling, "
         "P + -P", [
             [a, None, None, b],
             [None, None, None, None],
             [c, c, None, d],
             [e, negate(e)],
         ], 4),
        ("edges (4, 8): the generator, a doubled generator, P + -P + Q, a "
         "last voter alone", [
             [generator()],
             [generator(), generator(), generator()],
             [a, negate(a), b],
             [None] * 7 + [f],
         ], 8),
    ]


def cases(seed: int = SEED, full: bool = True) -> list:
    """The seeded cases: the two edge launches, (4, 4) and rung 4's
    (4, 128); with ``full`` also (64, 128) and (4, 256)."""
    rng = random.Random(seed)
    pool = point_pool(256 if full else 96, seed)
    out = edge_cases(pool)
    out.append(("(4, 4): four random certificates",
                random_certificates(rng, pool, 4, 4), 4))
    out.append(("(4, 128): rung 4, one certificate of 85 votes",
                [quorum_certificate(pool, 85)], 128))
    if full:
        out.append(("(64, 128): 64 random certificates",
                    random_certificates(rng, pool, 64, 128), 128))
        out.append(("(4, 256): rung 5's f = 85, one certificate of 171 "
                    "votes", [quorum_certificate(pool, 171)], 256))
    return out


#: Launch widths no lane split divides: one voter, rung 4's 85 votes, and
#: 200 (``width_cases``; the packer would round each up to a power of two,
#: ``pack`` keeps it).
WIDTHS = (1, 85, 200)


def width_cases(seed: int = SEED) -> list:
    """``(label, certs, width)`` for each of ``WIDTHS``: four certificates
    of exactly ``width`` slots, with leading absent voters, absent voters
    in the middle, every voter absent, and a doubling (one point twice in
    a row) beside a cancelling pair (P then -P), the rest drawn from the
    pool.  At width 1 the first two are one vote each and the last a lone
    vote."""
    rng = random.Random(seed + 1)
    pool = point_pool(24, seed)
    out = []
    for width in WIDTHS:
        votes = [pool[rng.randrange(len(pool))] for _ in range(width)]
        third = width // 3
        leading = [None] * third + votes[third:]
        middle = votes[:third] + [None] * third + votes[2 * third:]
        double = ([pool[0], pool[0], pool[1], negate(pool[1])]
                  + votes[4:])[:width]
        out.append((f"width {width}: leading, middle and all absent "
                    "voters, a doubling and P + -P",
                    [leading, middle, [None] * width, double], width))
    return out


def pack(certs: list, voters: int | None = None, width: int | None = None):
    """``bls_g1.pack_certificates`` as numpy arrays, cut to exactly
    ``width`` voter slots when it is given (contiguous copies)."""
    import numpy as np

    from mirbft_tpu_torch.ops import bls_g1

    arrays = bls_g1.pack_certificates(certs, voters or width)
    if width is None:
        return arrays
    return tuple(np.ascontiguousarray(a[:, :width]) for a in arrays)


def host_sums(certs: list) -> list:
    """The host oracle's aggregate of each certificate (None: identity)."""
    from mirbft_tpu_torch.crypto import bls_host

    return [bls_host.aggregate_g1([p for p in cert if p is not None])
            for cert in certs]
