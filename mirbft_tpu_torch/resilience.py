"""Backoff for the transport's reconnect attempts.

``Backoff`` paces ``runtime/transport.py``'s redials: exponential delay
growth with full jitter, so a mesh of replicas hammering one recovering
peer does not synchronize into connection storms.

The JAX package's ``CircuitBreaker`` (which routes a failing device call
to the host oracle) is not carried over: the port has no host route on
its kernel paths.
"""

from __future__ import annotations

import random


class Backoff:
    """Exponential backoff with full jitter (delay drawn uniformly from
    (0, min(cap, base * factor**attempt)]), the AWS-style policy that
    decorrelates retry storms."""

    def __init__(
        self,
        base: float = 0.05,
        factor: float = 2.0,
        cap: float = 2.0,
        rng: random.Random | None = None,
    ):
        self.base = base
        self.factor = factor
        self.cap = cap
        self.attempt = 0
        self._rng = rng or random.Random()

    def next(self) -> float:
        """Delay (seconds) to sleep before the next attempt."""
        ceiling = min(self.cap, self.base * self.factor**self.attempt)
        # Stop growing the exponent once the ceiling has reached the cap:
        # a permanently-dead peer retries forever, and an unbounded
        # ``attempt`` eventually overflows ``factor**attempt`` (a float
        # OverflowError around attempt ~1024 kills the sender thread).
        if ceiling < self.cap:
            self.attempt += 1
        return ceiling * (0.5 + 0.5 * self._rng.random())

    def reset(self) -> None:
        self.attempt = 0
