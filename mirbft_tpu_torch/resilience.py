"""Shared fault-tolerance primitives: circuit breaking and backoff.

- ``CircuitBreaker`` guards the crypto planes' kernel launches
  (testengine/crypto_plane.py, testengine/signing.py): after a run of
  consecutive failed launches the breaker *opens*, and periodically lets
  one probe through (*half-open*) to detect recovery.  The port has no
  host route: a failed launch is re-launched on the kernel when the
  breaker grants a probe, and the plane raises ``DevicePlaneError`` when
  it denies one, so an open breaker means no kernel attempt and a raise.
  Probing is count-based, not clock-based, so the deterministic
  testengine stays reproducible from its seed.

- ``Backoff`` paces the transport's reconnect attempts
  (runtime/transport.py): exponential delay growth with full jitter, so a
  mesh of replicas hammering one recovering peer does not synchronize
  into connection storms.
"""

from __future__ import annotations

import random

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"


class CircuitBreaker:
    """Deterministic consecutive-failure circuit breaker.

    States: *closed* (calls allowed), *open* (calls denied; the port's
    planes raise), *half-open* (one probe allowed).  ``failure_threshold``
    consecutive failures open the breaker; while open, every
    ``probe_interval``-th denied call is converted into a half-open probe.
    A probe success closes the breaker; a probe failure re-opens it and
    restarts the probe countdown.
    """

    def __init__(self, failure_threshold: int = 3, probe_interval: int = 8):
        assert failure_threshold >= 1 and probe_interval >= 1
        self.failure_threshold = failure_threshold
        self.probe_interval = probe_interval
        self.state = CLOSED
        self.consecutive_failures = 0
        self._denied_since_probe = 0
        # Telemetry (surfaced via status.crypto_plane_status).
        self.failures = 0
        self.successes = 0
        self.trips = 0
        self.probes = 0

    def allow(self) -> bool:
        """Should the caller attempt the guarded dependency right now?"""
        if self.state == CLOSED:
            return True
        if self.state == HALF_OPEN:
            # A probe is already in flight from this caller's perspective;
            # further calls before its verdict are denied.
            return False
        self._denied_since_probe += 1
        if self._denied_since_probe >= self.probe_interval:
            self._denied_since_probe = 0
            self.state = HALF_OPEN
            self.probes += 1
            return True
        return False

    def record_success(self) -> None:
        self.successes += 1
        self.consecutive_failures = 0
        self.state = CLOSED

    def record_failure(self) -> None:
        self.failures += 1
        self.consecutive_failures += 1
        if self.state == HALF_OPEN:
            # The probe failed: straight back to open.
            self.state = OPEN
            self._denied_since_probe = 0
        elif self.consecutive_failures >= self.failure_threshold:
            if self.state != OPEN:
                self.trips += 1
            self.state = OPEN
            self._denied_since_probe = 0


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
