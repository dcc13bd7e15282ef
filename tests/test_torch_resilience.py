"""The port's resilience primitives (``mirbft_tpu_torch/resilience.py``) and
the crypto planes' fault seam held against the JAX package's.

Mirrors ``tests/test_resilience.py``:

- the breaker cases (``:29, :41, :53``) and the Backoff cases (``:62,
  :72``): the same calls on both packages' objects give the same states,
  counters and delays, exactly;
- the plane cases (``:104-:195``) as their port counterparts.  Where the
  JAX plane recomputes a failed batch on the host oracle, the port's
  re-launches it on the kernel (its plain version here) while the breaker
  grants a probe, and raises ``DevicePlaneError`` when it denies one or
  after ``LAUNCH_ATTEMPTS``.  So each case holds the values against
  hashlib (or the verdicts against the host oracle) in both packages, the
  JAX plane's counters as the original case does, and the port's retry
  counters where the original holds ``fallback_*``, which read 0 in the
  port;
- the status snapshot (``:278``), whose breaker ends closed in the port
  (the probe inside the launch re-closed it) and open in the JAX package.

Not applicable: ``test_async_plane_launch_failure_host_rescues`` (``:143``)
and the three ``test_async_signature_plane_*`` cases (``:204-:239``).  They
test the host rescue of the JAX package's asynchronous planes, and the
port's ``AsyncKernelHashPlane`` has no host route (its launch failure is
the persistent-fault case below) while its ``AsyncSignaturePlane`` and
``SpeculativeSignaturePlane`` are off the chaos campaign's path and keep
no breaker (ROADMAP).
"""

import hashlib
import random

import pytest

from mirbft_tpu import resilience as ref_resilience
from mirbft_tpu.chaos.faults import FlakyDigestBackend as RefFlakyDigest
from mirbft_tpu.status import crypto_plane_status as ref_status
from mirbft_tpu.testengine.crypto_plane import (
    CoalescingHashPlane as RefCoalescingPlane,
)
from mirbft_tpu.testengine.signing import SignaturePlane as RefSignaturePlane
from mirbft_tpu.testengine.signing import host_verifier as ref_host_verifier
from mirbft_tpu_torch import resilience
from mirbft_tpu_torch.chaos.faults import (
    FlakyDigestBackend,
    FlakyVerifierBackend,
)
from mirbft_tpu_torch.ops.sha256 import sha256_digest_words
from mirbft_tpu_torch.resilience import (
    CLOSED,
    HALF_OPEN,
    OPEN,
    Backoff,
    CircuitBreaker,
)
from mirbft_tpu_torch.status import crypto_plane_status
from mirbft_tpu_torch.testengine.crypto_plane import (
    LAUNCH_ATTEMPTS,
    AsyncKernelHashPlane,
    DevicePlaneError,
)
from mirbft_tpu_torch.testengine.signing import (
    SignaturePlane,
    batch_verifier,
    host_verifier,
    make_signer,
)

#: Rows of the 1-block bucket's chunk in these planes (the padded launch).
CHUNK_ROWS = 256


def _state(breaker) -> tuple:
    return (breaker.state, breaker.consecutive_failures, breaker.failures,
            breaker.successes, breaker.trips, breaker.probes)


def _both(script):
    """Run ``script(module)`` on both packages' resilience modules and
    require the same trace."""
    ref = script(ref_resilience)
    port = script(resilience)
    assert port == ref
    return port


# ---------------------------------------------------------------------------
# CircuitBreaker and Backoff: the JAX logic, unchanged
# ---------------------------------------------------------------------------


def test_breaker_trips_after_consecutive_failures():
    def script(mod):
        b = mod.CircuitBreaker(failure_threshold=3, probe_interval=4)
        trace = [_state(b)]
        for op in ("failure", "success", "failure", "failure", "failure"):
            getattr(b, f"record_{op}")()
            trace.append(_state(b))
        return trace

    trace = _both(script)
    assert trace[4][0] == CLOSED
    assert trace[-1][0] == OPEN and trace[-1][4] == 1


def test_breaker_probes_and_recloses():
    def script(mod):
        b = mod.CircuitBreaker(failure_threshold=1, probe_interval=3)
        b.record_failure()
        allowed = [b.allow() for _ in range(3)]
        half = _state(b)
        in_flight = b.allow()
        b.record_success()
        return allowed, half, in_flight, _state(b), b.allow()

    allowed, half, in_flight, closed, after = _both(script)
    assert allowed == [False, False, True]
    assert half[0] == HALF_OPEN and not in_flight
    assert closed[0] == CLOSED and after


def test_breaker_failed_probe_reopens():
    def script(mod):
        b = mod.CircuitBreaker(failure_threshold=1, probe_interval=1)
        b.record_failure()
        probe = b.allow()
        b.record_failure()
        return probe, _state(b)

    probe, state = _both(script)
    assert probe and state[0] == OPEN and state[4] == 1 and state[5] == 1
    assert (CLOSED, OPEN, HALF_OPEN) == (
        ref_resilience.CLOSED, ref_resilience.OPEN, ref_resilience.HALF_OPEN)


def test_backoff_grows_to_cap_with_jitter():
    def script(mod):
        b = mod.Backoff(base=0.1, factor=2.0, cap=1.0, rng=random.Random(7))
        delays = [b.next() for _ in range(8)]
        b.reset()
        return delays, b.next()

    delays, after_reset = _both(script)
    ceilings = [0.1, 0.2, 0.4, 0.8, 1.0, 1.0, 1.0, 1.0]
    for delay, ceiling in zip(delays, ceilings):
        assert 0.5 * ceiling <= delay <= ceiling
    assert after_reset <= 0.1


def test_backoff_stays_bounded_over_thousands_of_failures():
    def script(mod):
        b = mod.Backoff(base=0.05, factor=2.0, cap=2.0, rng=random.Random(3))
        delays = [b.next() for _ in range(5000)]
        b.reset()
        return delays, b.next()

    delays, after_reset = _both(script)
    assert all(0.0 <= d <= 2.0 for d in delays)
    assert all(1.0 <= d <= 2.0 for d in delays[-100:])
    assert after_reset <= 0.05
    assert Backoff is resilience.Backoff


# ---------------------------------------------------------------------------
# The digest plane: a failed launch is re-launched on the kernel
# ---------------------------------------------------------------------------


def _expected(msgs):
    return [hashlib.sha256(m).digest() for m in msgs]


def _drain(plane, preimages):
    """Submit preimages and pull every digest through the resolve path
    (what resolve_event does for a delivered EventActionResults)."""
    handles = plane.submit([[p] for p in preimages])
    return [plane._resolve(h.index) for h in handles]


def _kernel_plane(launch, **kwargs):
    plane = AsyncKernelHashPlane(chunk_rows=CHUNK_ROWS, device="cpu", **kwargs)
    plane.launch = launch
    return plane


def test_kernel_plane_relaunches_dead_device_batches():
    """JAX ``:104``: two dying calls on a hair-trigger breaker.  The JAX
    plane rescues each batch on the host (one error a wave, open after the
    first); the port re-launches inside the one launch: call 0 trips the
    breaker, call 1 is a probe that fails, call 2 a probe that succeeds."""
    msgs = [b"m%d" % i for i in range(4)]
    ref = RefCoalescingPlane(
        digest_many=RefFlakyDigest(fail_from=0, fail_until=2, mode="die"),
        breaker=ref_resilience.CircuitBreaker(1, 1),
    )
    assert _drain(ref, msgs) == _expected(msgs)
    assert ref.device_errors == 1 and ref.fallback_digests == 4

    flaky = FlakyDigestBackend(fail_from=0, fail_until=2, mode="die",
                               backend=sha256_digest_words)
    plane = _kernel_plane(flaky, breaker=CircuitBreaker(1, 1))
    assert _drain(plane, msgs) == _expected(msgs)
    assert flaky.calls == 3 and plane.launches == 1
    assert plane.device_errors == 2
    assert plane.device_retries == 2 * CHUNK_ROWS
    assert plane.fallback_digests == 0 and plane.host_digests == 0
    assert plane.breaker.state == CLOSED
    assert (plane.breaker.trips, plane.breaker.probes) == (1, 2)
    more = [b"n%d" % i for i in range(3)]
    assert _drain(plane, more) == _expected(more)
    assert plane.device_errors == 2 and plane.launches == 2


def test_kernel_plane_short_read_detected():
    """JAX ``:126``: a readback one row short is a failure.  The port
    counts it and re-launches the batch; the values come off the second
    launch."""
    msgs = [b"a", b"b", b"c"]
    ref = RefCoalescingPlane(
        digest_many=lambda batch: [hashlib.sha256(m).digest()
                                   for m in batch][:-1])
    assert _drain(ref, msgs) == _expected(msgs)
    assert ref.device_errors == 1

    flaky = FlakyDigestBackend(fail_from=0, fail_until=1, mode="short",
                               backend=sha256_digest_words)
    plane = _kernel_plane(flaky, breaker=CircuitBreaker())
    assert _drain(plane, msgs) == _expected(msgs)
    assert plane.device_errors == 1 and flaky.calls == 2
    assert plane.device_retries == CHUNK_ROWS
    assert plane.breaker.state == CLOSED


def test_kernel_plane_timeout_counts_against_breaker():
    """JAX ``:135``: a call over its deadline keeps its values and counts
    one failure, with no retry."""
    msgs = [b"x", b"y"]
    ref = RefCoalescingPlane(timeout_s=0.0)
    assert _drain(ref, msgs) == _expected(msgs)
    assert ref.device_timeouts == 1

    plane = AsyncKernelHashPlane(chunk_rows=CHUNK_ROWS, device="cpu",
                                 breaker=CircuitBreaker(), timeout_s=0.0)
    assert _drain(plane, msgs) == _expected(msgs)
    assert plane.device_timeouts == 1 and plane.device_errors == 0
    assert plane.device_retries == 0
    assert plane.breaker.consecutive_failures == 1


def test_kernel_plane_persistent_fault_raises():
    """The port's counterpart of JAX ``:143`` (host rescue of a failed
    launch): with no host route, a launch that keeps failing raises
    ``DevicePlaneError`` naming the launch, after ``LAUNCH_ATTEMPTS``
    attempts while the breaker grants them, or at once when an open
    breaker denies the next."""
    assert LAUNCH_ATTEMPTS == 3

    def exploding(_blocks, _n_blocks):
        raise RuntimeError("injected launch failure")

    # Threshold 3: every attempt allowed.
    plane = _kernel_plane(exploding, breaker=CircuitBreaker())
    handles = plane.submit([[b"wave%d" % i] for i in range(8)])
    with pytest.raises(DevicePlaneError,
                       match="digest launch 0: 3 attempts failed"):
        plane.on_time(1)
    assert plane.device_errors == LAUNCH_ATTEMPTS and handles

    plane = _kernel_plane(exploding, breaker=CircuitBreaker(1, 8))
    plane.submit([[b"w"]])
    with pytest.raises(DevicePlaneError,
                       match="breaker open denied attempt 2"):
        plane.on_time(1)
    assert plane.device_errors == 1


def test_kernel_plane_seam_takes_device_faults_only():
    """The seam counts and retries device faults (``LAUNCH_FAULTS``) only:
    a programming error raises at once, uncounted.  A plane without a
    breaker (the default) has no seam: a device fault raises as it
    comes, once."""
    calls = []

    def broken(_blocks, _n_blocks):
        calls.append(1)
        raise TypeError("a bug, not a device fault")

    plane = _kernel_plane(broken, breaker=CircuitBreaker())
    plane.submit([[b"w"]])
    with pytest.raises(TypeError):
        plane.on_time(1)
    assert len(calls) == 1 and plane.device_errors == 0
    assert plane.breaker.failures == 0

    def exploding(_blocks, _n_blocks):
        calls.append(1)
        raise RuntimeError("injected launch failure")

    calls.clear()
    plane = _kernel_plane(exploding)
    assert plane.breaker is None
    plane.submit([[b"w"]])
    with pytest.raises(RuntimeError, match="injected"):
        plane.on_time(1)
    assert len(calls) == 1 and plane.device_errors == 0
    assert crypto_plane_status(plane).breaker is None


def test_kernel_plane_rides_out_two_failures_not_three():
    """``LAUNCH_ATTEMPTS`` in use: a window of two dying calls is ridden
    out inside one launch, a window of three is not."""
    for window, raises in ((2, False), (3, True)):
        flaky = FlakyDigestBackend(fail_from=0, fail_until=window,
                                   backend=sha256_digest_words)
        plane = _kernel_plane(flaky, breaker=CircuitBreaker(1, 1))
        msgs = [b"r%d" % i for i in range(5)]
        if raises:
            with pytest.raises(DevicePlaneError, match="call 2"):
                _drain(plane, msgs)
        else:
            assert _drain(plane, msgs) == _expected(msgs)


# ---------------------------------------------------------------------------
# The signature plane: a failed batch is verified again on the kernels
# ---------------------------------------------------------------------------


def _signed_items(n):
    signer = make_signer()
    return [
        (7, req_no, signer(7, req_no, b"payload%d" % req_no))
        for req_no in range(n)
    ]


def test_signature_plane_verifier_failure_is_reverified():
    """JAX ``:171``: the verifier dies once.  The JAX plane verifies the
    batch on the host oracle and stays open; the port's verifies it again
    on the Ed25519 kernels' plain versions through a probe, and closes."""
    items = _signed_items(3)
    calls = []

    def dying(batch):
        calls.append(len(batch))
        raise RuntimeError("injected verify failure")

    ref = RefSignaturePlane(verifier=dying,
                            breaker=ref_resilience.CircuitBreaker(1, 1))
    for item in items:
        ref.submit(*item)
    assert all(ref.valid(*item) for item in items)
    assert ref.device_errors == 1 and ref.fallback_verifies == 3

    flaky = FlakyVerifierBackend(fail_from=0, fail_until=1,
                                 backend=batch_verifier("cpu"))
    plane = SignaturePlane(flaky, breaker=CircuitBreaker(1, 1))
    for item in items:
        plane.submit(*item)
    assert all(plane.valid(*item) for item in items)
    assert flaky.calls == 2
    assert plane.device_errors == 1 and plane.fallback_verifies == 0
    assert plane.device_retries == 3
    assert plane.breaker.state == CLOSED and plane.breaker.trips == 1
    client_id, req_no, data = _signed_items(1)[0]
    tampered = data[:-1] + b"\x00"
    assert not plane.valid(client_id, req_no, tampered)
    assert not ref.valid(client_id, req_no, tampered)


def test_signature_plane_short_verdicts_detected():
    """JAX ``:195``: a verdict list one short is a failure; the port
    verifies the batch again."""
    items = _signed_items(2)
    ref = RefSignaturePlane(
        verifier=lambda batch: ref_host_verifier(batch)[:-1])
    for item in items:
        ref.submit(*item)
    assert all(ref.valid(*item) for item in items)
    assert ref.device_errors == 1

    flaky = FlakyVerifierBackend(fail_from=0, fail_until=1, mode="short",
                                 backend=host_verifier)
    plane = SignaturePlane(flaky, breaker=CircuitBreaker())
    for item in items:
        plane.submit(*item)
    assert all(plane.valid(*item) for item in items)
    assert plane.device_errors == 1 and flaky.calls == 2


def test_signature_plane_persistent_fault_raises():
    def dying(_batch):
        raise RuntimeError("injected verify failure")

    plane = SignaturePlane(dying, breaker=CircuitBreaker())
    item = _signed_items(1)[0]
    with pytest.raises(DevicePlaneError, match="verify flush 0"):
        plane.valid(*item)
    assert plane.device_errors == LAUNCH_ATTEMPTS


# ---------------------------------------------------------------------------
# status.py snapshots
# ---------------------------------------------------------------------------


def test_crypto_plane_status_snapshot():
    """JAX ``:278``: one dying call on a hair-trigger breaker.  The JAX
    snapshot shows the host fallback and an open breaker; the port's shows
    the error, no fallback, and the breaker re-closed by its probe."""
    ref = RefCoalescingPlane(
        digest_many=RefFlakyDigest(fail_from=0, fail_until=1, mode="die"),
        breaker=ref_resilience.CircuitBreaker(1, 1),
    )
    _drain(ref, [b"p", b"q"])
    ref_snap = ref_status(ref)
    assert ref_snap.device_errors == 1 and ref_snap.fallback_work == 2
    assert ref_snap.breaker.state == ref_resilience.OPEN

    flaky = FlakyDigestBackend(fail_from=0, fail_until=1, mode="die",
                               backend=sha256_digest_words)
    plane = _kernel_plane(flaky, breaker=CircuitBreaker(1, 1))
    _drain(plane, [b"p", b"q"])
    snap = crypto_plane_status(plane)
    assert snap.plane == "AsyncKernelHashPlane"
    assert snap.device_errors == 1 and snap.fallback_work == 0
    assert snap.breaker.state == CLOSED
    assert (snap.breaker.trips, snap.breaker.probes) == (1, 1)
    assert "breaker: closed" in snap.pretty()
    assert '"device_errors": 1' in snap.to_json()
    assert set(vars(snap)) == set(vars(ref_snap))
