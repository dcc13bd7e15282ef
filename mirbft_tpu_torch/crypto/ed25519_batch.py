"""Host-side batched Ed25519 verification via random linear combination.

The per-request host oracle (`ed25519_host.verify`) costs two full
double-and-add scalar multiplications per signature — ~5 ms each on a
commodity core, which is what drove BENCH_r04's rung3 verify p99 to
seconds.  Batch verification collapses a whole wave into **one**
multi-scalar multiplication:

    accept the batch  iff  [sum z_i s_i mod L] B
                           == sum [z_i] R_i + sum [z_i k_i mod L] A_i

where ``z_i`` are deterministic ~128-bit Fiat-Shamir coefficients bound
to the entire batch transcript.  A forged item survives only if the
adversary can predict the transcript hash — the standard RLC soundness
argument (probability <= 2^-127).  For an all-valid batch each term is
the identity exactly (the oracle demands equality, not cofactored
equality), so there are **no false rejections**: when the combined check
fails, a binary-split descent isolates the offenders and every verdict
it emits is bit-identical to ``ed25519_host.verify``.

The multi-scalar multiplication uses Pippenger's bucket method over the
same extended twisted-Edwards arithmetic as the host oracle — this
module adds no new curve code, only a different schedule over
`ed25519_host.point_add`.  Cost is roughly ``ceil(b/w) * (n + 2^w)``
point additions for ``n`` terms of ``b``-bit scalars, i.e. well under a
millisecond per signature at wave sizes the rung3 harness produces,
against 5+ ms for the sequential oracle.

In this package it is the host reference that tests hold the Ed25519
kernels' verdicts against, and the route ``testengine.signing.rlc_verifier``
takes when a caller names it.  Nothing on the device route calls it: the
signature planes and ``signing.batch_verifier()`` verify on the kernels
(``ops/ed25519.py``) and raise without a card.
"""

from __future__ import annotations

import hashlib

from . import ed25519_host as host

# Number of random-linear-combination coefficient bits.  128 keeps the
# forgery bound at 2^-127 while halving the MSM windows the R_i terms
# occupy relative to full-width scalars.
Z_BITS = 128

_L = host.L
_B_EXT = host.to_extended(host.BASE)


def _marshal(pk: bytes, message: bytes, signature: bytes):
    """Structural admission, mirroring the oracle's early-outs.

    Returns ``(s, k, A_ext, R_ext)`` or None when the item can never
    verify (bad lengths, non-decodable points, s >= L) — such items are
    rejected on the host without joining the combined check, exactly as
    `ops.ed25519.marshal_signature` rejects them before device launch.
    """
    if len(pk) != 32 or len(signature) != 64:
        return None
    A = host.decompress(pk)
    if A is None:
        return None
    R = host.decompress(signature[:32])
    if R is None:
        return None
    s = int.from_bytes(signature[32:], "little")
    if s >= _L:
        return None
    k = (
        int.from_bytes(
            hashlib.sha512(signature[:32] + pk + message).digest(), "little"
        )
        % _L
    )
    return s, k, A, R


def _coefficients(items) -> list:
    """Deterministic Fiat-Shamir RLC coefficients.

    One SHA-512 transcript binds every (pk, sig, message) in the batch;
    per-item coefficients are derived from the transcript root and the
    item index.  Deterministic derivation keeps the deterministic engine
    replayable; binding the full batch means an adversary choosing any
    item has no freedom over its own (or its neighbours') coefficient.
    """
    root = hashlib.sha512()
    root.update(b"mirbft-ed25519-rlc-v1")
    for pk, message, signature in items:
        root.update(pk)
        root.update(signature)
        root.update(hashlib.sha512(message).digest())
    seed = root.digest()
    out = []
    for i in range(len(items)):
        z = int.from_bytes(
            hashlib.sha512(seed + i.to_bytes(8, "little")).digest(), "little"
        )
        # Top bit forced so every coefficient is full-width and nonzero.
        out.append((z % (1 << Z_BITS)) | (1 << (Z_BITS - 1)))
    return out


def msm(pairs) -> tuple:
    """Pippenger multi-scalar multiplication: sum [scalar] point.

    ``pairs`` is a sequence of ``(scalar, extended_point)``; returns an
    extended point.  Window width adapts to the term count; windows above
    a term's scalar width never touch it, so the 128-bit R-coefficients
    cost half the windows of the 253-bit s/k terms.
    """
    pairs = [(s, p) for s, p in pairs if s]
    if not pairs:
        return host.IDENTITY
    max_bits = max(s.bit_length() for s, _ in pairs)
    n = len(pairs)
    # Balance ceil(b/w)*n window additions against ceil(b/w)*2^w bucket
    # collapses; near-optimal w tracks log2(n).
    w = max(2, min(12, n.bit_length() - 1))
    mask = (1 << w) - 1
    windows = (max_bits + w - 1) // w
    acc = host.IDENTITY
    for win in range(windows - 1, -1, -1):
        if acc is not host.IDENTITY:
            for _ in range(w):
                acc = host.point_add(acc, acc)
        shift = win * w
        buckets = [None] * (mask + 1)
        for s, p in pairs:
            idx = (s >> shift) & mask
            if not idx:
                continue
            cur = buckets[idx]
            buckets[idx] = p if cur is None else host.point_add(cur, p)
        running = host.IDENTITY
        total = host.IDENTITY
        for idx in range(mask, 0, -1):
            b = buckets[idx]
            if b is not None:
                running = host.point_add(running, b)
            if running is not host.IDENTITY:
                total = host.point_add(total, running)
        acc = host.point_add(acc, total)
    return acc


def _combined_check(marshalled, coefficients) -> bool:
    """The one-MSM batch equation over already-marshalled items."""
    c = 0
    pairs = []
    for (s, k, A_ext, R_ext), z in zip(marshalled, coefficients):
        c = (c + z * s) % _L
        pairs.append((z, host.point_negate(R_ext)))
        pairs.append(((z * k) % _L, host.point_negate(A_ext)))
    pairs.append((c, _B_EXT))
    return host.point_equal(msm(pairs), host.IDENTITY)


def _descend(items, marshalled, verdicts, indices) -> None:
    """Binary-split isolation of failing items inside a failed batch.

    Each leaf (single item) is decided by the exact oracle equation, so
    descent verdicts match `ed25519_host.verify` bit-for-bit.
    """
    if len(indices) == 1:
        i = indices[0]
        s, k, A_ext, R_ext = marshalled[i]
        lhs = msm([(s, _B_EXT), (k, host.point_negate(A_ext))])
        verdicts[i] = host.point_equal(lhs, R_ext)
        return
    sub_items = [items[i] for i in indices]
    sub_marshalled = [marshalled[i] for i in indices]
    if _combined_check(sub_marshalled, _coefficients(sub_items)):
        for i in indices:
            verdicts[i] = True
        return
    mid = len(indices) // 2
    _descend(items, marshalled, verdicts, indices[:mid])
    _descend(items, marshalled, verdicts, indices[mid:])


def verify_batch(items, chunk: int = 64) -> list:
    """Batch-verify ``[(pk, message, signature), ...]`` -> list of bool.

    Verdicts are equivalent to calling `ed25519_host.verify` per item
    (identical on every input the descent touches; the all-valid fast
    path accepts exactly the sets the oracle accepts).  ``chunk`` bounds
    the wave a single combined check covers, which bounds the wall time
    of one verification burst — the rung3 p99 ledger measures these
    bursts, so the default keeps each under the 100 ms SLO on a
    commodity core while retaining most of the amortization.
    """
    verdicts = [False] * len(items)
    live: list[int] = []
    marshalled: dict[int, tuple] = {}
    for i, (pk, message, signature) in enumerate(items):
        m = _marshal(bytes(pk), bytes(message), bytes(signature))
        if m is None:
            continue
        marshalled[i] = m
        live.append(i)
    for base in range(0, len(live), chunk):
        indices = live[base : base + chunk]
        sub_items = [items[i] for i in indices]
        sub_marshalled = [marshalled[i] for i in indices]
        if _combined_check(sub_marshalled, _coefficients(sub_items)):
            for i in indices:
                verdicts[i] = True
        else:
            _descend(
                [items[i] for i in range(len(items))],
                [marshalled.get(i) for i in range(len(items))],
                verdicts,
                indices,
            )
    return verdicts
