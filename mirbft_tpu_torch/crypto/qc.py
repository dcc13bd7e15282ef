"""Aggregate quorum certificates: the sanctioned BLS seam.

A quorum certificate proves 2f+1 replicas vouched for the same
statement.  Naively that is 2f+1 signature verifications per
certificate; with BLS aggregation the certificate carries **one** G1
point and costs one pairing check regardless of quorum size — the
second leg of the three-tier authentication model.

This module wraps the host reference (`bls_host`) and the aggregation
kernel (`ops/bls_g1`) behind a small vote/aggregate/verify API so
consumers (testengine/certs.py) never touch raw pairing primitives.
Verification outcomes are mirrored to
``mirbft_cert_aggregate_verifies_total{outcome}`` when hooks are live.
"""

from __future__ import annotations

from ..obsv import hooks
from . import bls_host


def secret_key(seed: bytes) -> int:
    return bls_host.secret_key(seed)


def public_key(seed: bytes):
    """Voter public key ([sk]G2) for a vote seed."""
    return bls_host.public_key(seed)


def sign_vote(seed: bytes, statement: bytes):
    """One replica's G1 vote share over a certificate statement."""
    return bls_host.sign(seed, statement)


def verify_vote(pk, statement: bytes, sig) -> bool:
    """Individual vote check — the descent primitive when an aggregate
    fails and the votes are still at hand."""
    return bls_host.verify(pk, statement, sig)


def aggregate(sigs, use_device: bool = True, device="cuda"):
    """Collapse vote shares into one aggregate signature point.

    ``use_device`` sends the points to ``ops/bls_g1`` on ``device``: the
    kernel on ``cuda`` (which raises without a card), its plain version on
    ``cpu``.  A failure raises; nothing folds on the host instead.
    ``use_device=False`` is the explicit host fold.  Accepts a list of G1
    points, returns one G1 point (None for the identity).
    """
    if use_device:
        from ..ops import bls_g1

        return bls_g1.aggregate_signatures([list(sigs)], device=device)[0]
    return bls_host.aggregate_g1(list(sigs))


def _record(outcome: str) -> None:
    if hooks.enabled:
        hooks.metrics.counter(
            "mirbft_cert_aggregate_verifies_total", outcome=outcome
        ).inc()


def verify_cert(pks, statement: bytes, asig) -> bool:
    """One-shot certificate check: pairing equation over the aggregate.

    ``pks`` are the signer public keys (the certificate's signer
    bitmap resolved to keys), ``statement`` the certified bytes, and
    ``asig`` the aggregate G1 point.  A mismatched signer set, tampered
    statement, or forged point all fail the single pairing check — no
    per-vote work.  A malformed point is a rejection, not an error.
    """
    try:
        ok = bool(bls_host.verify_aggregate(list(pks), statement, asig))
    except Exception:
        ok = False
    _record("ok" if ok else "rejected")
    return ok
