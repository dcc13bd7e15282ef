"""Device-plane fault injection for the chaos campaign.

The crypto planes (testengine/crypto_plane.py, testengine/signing.py) take
a pluggable kernel call; ``FlakyDigestBackend`` wraps one with a
deterministic call-indexed failure window so a scenario can make the
device die, lie (short reads), or hang (exceed the plane's deadline) for a
stretch of the run and then recover, walking the circuit breaker through
trip -> probe -> re-close without any wall-clock nondeterminism in *what*
fails (only call indices decide).  The planes have no host route: a failed
call is re-launched on the kernel while the breaker grants a probe."""

from __future__ import annotations

import time

from ..testengine.crypto_plane import DevicePlaneError

MODES = ("die", "short", "slow")


class FlakyDigestBackend:
    """A digest call, ``(blocks, n_blocks) -> words``, that misbehaves for
    calls ``fail_from <= i < fail_until`` (0-indexed) and is healthy
    otherwise.  ``backend`` is the plane's launch: the SHA-256 kernel on
    ``cuda``, its plain version on ``cpu``.

    Modes:

    - ``die``:   raise DevicePlaneError (device lost mid-wave).
    - ``short``: return half the digest rows (a lying readback).
    - ``slow``:  sleep ``delay_s`` before answering correctly; pair with
      a plane ``timeout_s`` below ``delay_s`` so the breaker counts it.

    While the plane's breaker is open the backend is only reached by
    probes, so the call index, and therefore the recovery point, stays
    deterministic for a given scenario.
    """

    def __init__(
        self,
        fail_from: int = 0,
        fail_until: int = 0,
        mode: str = "die",
        delay_s: float = 0.002,
        backend=None,
    ):
        assert mode in MODES, f"mode must be one of {MODES}"
        if backend is None:
            from ..ops.sha256 import sha256_digest_words as backend
        self.fail_from = fail_from
        self.fail_until = fail_until
        self.mode = mode
        self.delay_s = delay_s
        self.backend = backend
        self.calls = 0
        self.injected = 0

    def __call__(self, blocks, n_blocks):
        index = self.calls
        self.calls += 1
        if self.fail_from <= index < self.fail_until:
            self.injected += 1
            if self.mode == "die":
                raise DevicePlaneError(
                    f"injected device loss (call {index})"
                )
            if self.mode == "short":
                words = self.backend(blocks, n_blocks)
                return words[: words.shape[0] // 2]
            time.sleep(self.delay_s)
        return self.backend(blocks, n_blocks)


class FlakyVerifierBackend:
    """The signature-plane twin of FlakyDigestBackend: a batch verifier
    (items of ``(client_id, req_no, data)`` -> verdicts) that misbehaves
    for calls ``fail_from <= i < fail_until`` and is healthy otherwise.
    ``backend`` is ``signing.batch_verifier(device)``: the Ed25519 kernels
    on ``cuda``, their plain versions on ``cpu``.  Same call-indexed
    determinism: while the plane's breaker is open only probes reach the
    backend, so the recovery point is fixed per scenario."""

    def __init__(
        self,
        fail_from: int = 0,
        fail_until: int = 0,
        mode: str = "die",
        delay_s: float = 0.002,
        backend=None,
    ):
        assert mode in MODES, f"mode must be one of {MODES}"
        if backend is None:
            from ..testengine.signing import batch_verifier

            backend = batch_verifier()
        self.fail_from = fail_from
        self.fail_until = fail_until
        self.mode = mode
        self.delay_s = delay_s
        self.backend = backend
        self.calls = 0
        self.injected = 0

    def __call__(self, items: list) -> list:
        index = self.calls
        self.calls += 1
        if self.fail_from <= index < self.fail_until:
            self.injected += 1
            if self.mode == "die":
                raise DevicePlaneError(
                    f"injected verifier loss (call {index})"
                )
            if self.mode == "short":
                return self.backend(items)[: len(items) // 2]
            time.sleep(self.delay_s)
        return self.backend(items)
