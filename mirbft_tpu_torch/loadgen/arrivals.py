"""Open-loop arrival processes.

An arrival process plans *when* requests enter the system, independent
of how fast the system absorbs them — the defining property of open-loop
load (closed-loop generators hide saturation by self-throttling; an
open-loop one exposes it as queueing delay, which is what a latency SLO
must observe).

Every process is deterministic under its seed: ``offsets(duration_s)``
returns the full sorted plan up front, so a run can be replayed and the
offered rate is an artifact input rather than a measurement.
"""

from __future__ import annotations

import math
import random


class PoissonArrivals:
    """Memoryless arrivals at a constant offered rate (exponential
    inter-arrival gaps) — the canonical open-loop reference load."""

    def __init__(self, rate_per_sec: float, seed: int = 0):
        if rate_per_sec <= 0:
            raise ValueError("rate_per_sec must be positive")
        self.rate_per_sec = rate_per_sec
        self.seed = seed

    def offsets(self, duration_s: float) -> list:
        rng = random.Random((self.seed << 1) ^ 0x9E3779B9)
        out = []
        t = rng.expovariate(self.rate_per_sec)
        while t < duration_s:
            out.append(t)
            t += rng.expovariate(self.rate_per_sec)
        return out


class BurstyArrivals:
    """On-off bursts: Poisson at ``rate_per_sec * burst_factor`` during
    ``on_s`` windows, silent during ``off_s`` windows.  The long-run
    average rate stays near ``rate_per_sec * burst_factor * duty`` —
    bursts probe queue buildup and drain, not steady state."""

    def __init__(
        self,
        rate_per_sec: float,
        burst_factor: float = 4.0,
        on_s: float = 0.5,
        off_s: float = 1.0,
        seed: int = 0,
    ):
        if rate_per_sec <= 0 or burst_factor <= 0:
            raise ValueError("rates must be positive")
        if on_s <= 0 or off_s < 0:
            raise ValueError("window lengths must be positive")
        self.rate_per_sec = rate_per_sec
        self.burst_factor = burst_factor
        self.on_s = on_s
        self.off_s = off_s
        self.seed = seed

    def offsets(self, duration_s: float) -> list:
        rng = random.Random((self.seed << 1) ^ 0xB5297A4D)
        burst_rate = self.rate_per_sec * self.burst_factor
        period = self.on_s + self.off_s
        out = []
        window_start = 0.0
        while window_start < duration_s:
            t = window_start + rng.expovariate(burst_rate)
            on_end = min(window_start + self.on_s, duration_s)
            while t < on_end:
                out.append(t)
                t += rng.expovariate(burst_rate)
            window_start += period
        return out


class DiurnalArrivals:
    """A smooth rate ramp between ``low`` and ``high`` over ``period_s``
    (one squashed "day"), realised by thinning a Poisson stream at the
    peak rate — arrival density follows the instantaneous rate exactly."""

    def __init__(
        self,
        low_rate_per_sec: float,
        high_rate_per_sec: float,
        period_s: float = 10.0,
        seed: int = 0,
    ):
        if low_rate_per_sec < 0 or high_rate_per_sec <= 0:
            raise ValueError("rates must be positive")
        if high_rate_per_sec < low_rate_per_sec:
            raise ValueError("high rate must be >= low rate")
        if period_s <= 0:
            raise ValueError("period_s must be positive")
        self.low = low_rate_per_sec
        self.high = high_rate_per_sec
        self.period_s = period_s
        self.seed = seed

    def rate_at(self, t: float) -> float:
        phase = (1.0 - math.cos(2.0 * math.pi * t / self.period_s)) / 2.0
        return self.low + (self.high - self.low) * phase

    def offsets(self, duration_s: float) -> list:
        rng = random.Random((self.seed << 1) ^ 0x1B873593)
        out = []
        t = rng.expovariate(self.high)
        while t < duration_s:
            if rng.random() * self.high < self.rate_at(t):
                out.append(t)
            t += rng.expovariate(self.high)
        return out
