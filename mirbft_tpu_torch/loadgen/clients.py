"""Client behaviour models for the load generator.

An arrival process says *when* a request enters; a ``ClientModel`` says
*how*: payload sizing (fixed or mixed), added submit lag (a slow client
whose requests reach the cluster late), and the retry-storm policy — a
client that re-submits a request it believes timed out, fanned out to
several nodes at once.  Retries are the hostile case request dedup
exists for (PAPER.md's duplicate-suppression claim); the generator
counts them separately so goodput never double-counts a retried commit.
"""

from __future__ import annotations

import random
from dataclasses import dataclass


@dataclass(frozen=True)
class ClientModel:
    """How one client misbehaves (or doesn't)."""

    # Fixed payload size, or choose-per-request from payload_choices.
    payload_bytes: int = 32
    payload_choices: tuple = ()  # e.g. (16, 256, 4096) for mixed sizes
    # A slow client: its requests arrive this long after their planned
    # open-loop instant.
    submit_lag_s: float = 0.0
    # Retry storm: when a request is uncommitted for retry_timeout_s,
    # re-submit it to retry_fanout distinct nodes (round-robin over the
    # cluster); None disables retries.
    retry_timeout_s: float | None = None
    retry_fanout: int = 1
    # KV workload shape (consumed by the app-rung driver; the raw-bytes
    # generator ignores these).  read_ratio is the probability an op is a
    # read; key_space keys named k0..k{n-1}; key_dist picks which —
    # "uniform", or "zipf" with exponent zipf_s (rank-1 hottest).
    read_ratio: float = 0.0
    key_space: int = 64
    key_dist: str = "uniform"
    zipf_s: float = 1.1
    # Signed mode: the generator wraps every payload with the Ed25519
    # trailer (testengine/signing wire format: payload || sig || pk) at
    # plan-build time, so mp/live rungs drive real signed traffic
    # through the socket path and the replicas' speculative ingress
    # stage verifies it (docs/CRYPTO.md).  Signing at plan build keeps
    # retries byte-identical, which dedup requires.
    signed: bool = False

    def __post_init__(self):
        if self.payload_bytes <= 0:
            raise ValueError("payload_bytes must be positive")
        if self.submit_lag_s < 0:
            raise ValueError("submit_lag_s must be >= 0")
        if self.retry_timeout_s is not None and self.retry_timeout_s <= 0:
            raise ValueError("retry_timeout_s must be positive")
        if self.retry_fanout < 1:
            raise ValueError("retry_fanout must be >= 1")
        if not 0.0 <= self.read_ratio <= 1.0:
            raise ValueError("read_ratio must be in [0, 1]")
        if self.key_space < 1:
            raise ValueError("key_space must be >= 1")
        if self.key_dist not in ("uniform", "zipf"):
            raise ValueError("key_dist must be 'uniform' or 'zipf'")
        if self.zipf_s <= 0:
            raise ValueError("zipf_s must be positive")

    def is_read(self, rng: random.Random) -> bool:
        return self.read_ratio > 0.0 and rng.random() < self.read_ratio

    def key(self, rng: random.Random) -> str:
        """Draw a key per key_dist.  The zipf draw is the standard
        inverse-CDF over harmonic weights, precomputed once per model."""
        if self.key_dist == "uniform" or self.key_space == 1:
            return f"k{rng.randrange(self.key_space)}"
        cdf = _zipf_cdf(self.key_space, self.zipf_s)
        point = rng.random()
        lo, hi = 0, len(cdf) - 1
        while lo < hi:
            mid = (lo + hi) // 2
            if cdf[mid] < point:
                lo = mid + 1
            else:
                hi = mid
        return f"k{lo}"

    def payload(self, rng: random.Random, req_no: int) -> bytes:
        size = (
            rng.choice(self.payload_choices)
            if self.payload_choices
            else self.payload_bytes
        )
        # Stamp the req_no, pad deterministically: payloads differ per
        # request but replays of the same (client, req_no) are identical,
        # which dedup requires.
        stamp = b"%d:" % req_no
        return (stamp + b"x" * size)[: max(size, len(stamp))]


_ZIPF_CDFS: dict = {}


def _zipf_cdf(n: int, s: float) -> list:
    cdf = _ZIPF_CDFS.get((n, s))
    if cdf is None:
        weights = [1.0 / (rank**s) for rank in range(1, n + 1)]
        total = sum(weights)
        acc = 0.0
        cdf = []
        for w in weights:
            acc += w / total
            cdf.append(acc)
        cdf[-1] = 1.0
        _ZIPF_CDFS[(n, s)] = cdf
    return cdf


# The mix exercised by the bench rung: one honest client, one slow
# client with mixed payload sizes, one retry-stormer.
def standard_client_models(client_ids) -> dict:
    """Assign models round-robin over ``(honest, slow+mixed, stormy)``."""
    models = (
        ClientModel(),
        ClientModel(payload_choices=(16, 256, 1024), submit_lag_s=0.05),
        ClientModel(retry_timeout_s=1.0, retry_fanout=2),
    )
    return {
        client_id: models[i % len(models)]
        for i, client_id in enumerate(client_ids)
    }


def kv_client_models(client_ids, read_ratio: float = 0.5) -> dict:
    """The app-rung mix: every client reads and writes; payload sizes
    alternate between small-value and mixed, key distributions between
    uniform and a Zipf hot set (the skew PAPER.md's bucket rotation is
    supposed to absorb)."""
    models = (
        ClientModel(read_ratio=read_ratio, key_space=64),
        ClientModel(
            read_ratio=read_ratio,
            key_space=64,
            key_dist="zipf",
            payload_choices=(16, 256, 1024),
        ),
    )
    return {
        client_id: models[i % len(models)]
        for i, client_id in enumerate(client_ids)
    }
