"""The coalescing crypto plane: cross-node digest batching for the engine.

The reference executes hashes inline in each node's processor (reference:
processor.go:133-143, testengine/recorder.go:445-455).  On an accelerator
that wastes the device: each node's action batch alone is a handful of
digests, far below the batch sizes that amortize a kernel launch.

The engine gives us slack the reference never used: a hash result does not
re-enter its state machine until ``ready_latency`` simulated milliseconds
after the actions were executed.  Digests are pure functions of data known
at schedule time, so the *computation* can be deferred until the first
result event is actually delivered, and at that point every hash request
accumulated across ALL nodes flushes as one batch.

Determinism is untouched: the values are identical to inline execution, so
event counts, recorded logs, and app hash chains come out bit-identical.

Two planes:

- ``CoalescingHashPlane`` hashes each flush with hashlib: the host oracle
  the kernel plane is held against.
- ``AsyncKernelHashPlane`` computes every digest with the SHA-256 kernel
  (ops.sha256).  It has no host route: a digest comes off the kernel, or
  the plane raises.

The kernel plane keeps the JAX planes' fault seam when it is given a
``CircuitBreaker``: a launch that raises a device fault
(``LAUNCH_FAULTS``), reads back fewer digest rows than it launched, or
(with ``timeout_s``) overruns its deadline counts against the breaker.
Where the JAX plane recomputes such a batch on the host, this one
re-launches the same packed batch on the kernel when the breaker grants a
probe, and raises ``DevicePlaneError`` when it denies one or after
``LAUNCH_ATTEMPTS`` attempts.  Values are identical either way, so events
and chains do not move.  On the card the guard waits for each launch's
readback, so an asynchronous device fault raises inside it; a sticky CUDA
error fails every attempt, and the plane raises.  Without a breaker (the
default) there is no seam: launches stay asynchronous and a fault raises
where it surfaces, at the launch or at the readback.
"""

from __future__ import annotations

import hashlib
import time

import torch

from .. import pb
from ..obsv import hooks
from ..ops.batching import (
    next_pow2,
    pack_preimages,
    padded_blocks,
    resolve_device,
    to_tensors,
)
from ..ops.sha256 import sha256_digest_words, words_to_digests

#: Padded bytes a launch carries: 8192 rows of the 1-block bucket, 256 rows
#: of the 128-block bucket (``AsyncKernelHashPlane.rows_for``).
_CHUNK_BYTES = 1 << 21

#: Attempts a kernel launch gets: the first call and two probes, so the
#: chaos scenarios' failure window of calls [1, 3) on a hair-trigger
#: breaker is ridden out inside one launch.
LAUNCH_ATTEMPTS = 3


class DevicePlaneError(Exception):
    """A kernel launch failed, read back short, or was denied by an open
    circuit breaker."""


#: What the seam counts as a device fault: the kernels' CUDA errors (torch
#: raises them as RuntimeError) and a short read.  Anything else is a
#: fault of the program and raises at once.
LAUNCH_FAULTS = (RuntimeError, DevicePlaneError)


def guarded_launch(plane, launch, rows: int, what: str):
    """Run ``launch()`` under ``plane.breaker``; returns its output and
    the instant the returning attempt began.  A ``LAUNCH_FAULTS`` raise
    or an output of fewer than ``rows`` rows is a failure
    (``plane.device_errors``), re-launched while the breaker grants a
    probe, at most ``LAUNCH_ATTEMPTS`` times in all
    (``plane.device_retries`` counts the rows re-launched).  An open
    breaker that denies the attempt raises ``DevicePlaneError``; so does
    the last failed attempt.  Success or timeout is the caller's to
    record (``record_outcome``).  A plane without a breaker just calls
    ``launch()``."""
    breaker = plane.breaker
    if breaker is None:
        return launch(), time.perf_counter()
    error = None
    for attempt in range(LAUNCH_ATTEMPTS):
        if not breaker.allow():
            raise DevicePlaneError(
                f"{what}: breaker {breaker.state} denied attempt "
                f"{attempt + 1}"
                + (f" after {error}" if error is not None else "")
            ) from error
        if attempt:
            plane.device_retries += rows
        start = time.perf_counter()
        try:
            out = launch()
            if len(out) < rows:
                raise DevicePlaneError(
                    f"short read: {len(out)} of {rows} rows"
                )
        except LAUNCH_FAULTS as err:
            breaker.record_failure()
            plane.device_errors += 1
            error = err
            continue
        return out, start
    raise DevicePlaneError(
        f"{what}: {LAUNCH_ATTEMPTS} attempts failed, last: {error}"
    ) from error


def record_outcome(plane, start: float) -> None:
    """Judge a launch that returned in full: a wall since ``start`` over
    ``plane.timeout_s`` keeps its values but counts against the breaker
    (``plane.device_timeouts``); anything else is a success."""
    if plane.breaker is None:
        return
    timeout_s = plane.timeout_s
    if timeout_s is not None and time.perf_counter() - start > timeout_s:
        plane.breaker.record_failure()
        plane.device_timeouts += 1
    else:
        plane.breaker.record_success()


class _Lazy:
    """Placeholder for a digest that has been submitted but not computed."""

    __slots__ = ("plane", "index")

    def __init__(self, plane: "CoalescingHashPlane", index: int):
        self.plane = plane
        self.index = index


class CoalescingHashPlane:
    """Deferred host digest executor; install via
    ``Recorder(hash_plane=...)``.  Everything pending flushes through
    hashlib the first time a result is delivered."""

    def __init__(self):
        self._pending: list[bytes] = []  # concatenated preimages
        self._base = 0  # global index of _pending[0]
        self._results: dict[int, bytes] = {}
        # Telemetry for the bench: one entry per flush, and the host
        # seconds spent queueing work at submit.
        self.flush_sizes: list[int] = []
        self.flush_wall_s: list[float] = []
        self.submit_s = 0.0
        self.host_digests = 0

    # -- executor side (called from Recorder._execute) -----------------------

    def submit(self, chunk_lists: list) -> list:
        """Queue preimages; returns one placeholder per preimage."""
        start = time.perf_counter()
        handles = []
        for chunks in chunk_lists:
            index = self._base + len(self._pending)
            self._pending.append(b"".join(chunks))
            handles.append(_Lazy(self, index))
        self.submit_s += time.perf_counter() - start
        return handles

    def on_time(self, _now: int) -> None:
        """Engine hook at simulated-time advancement; the base plane stays
        fully lazy (the kernel plane launches completed waves here)."""

    # -- delivery side (called from Recorder.step) ---------------------------

    def resolve_event(self, event: pb.StateEvent) -> None:
        """Materialize any lazy digests in a results event, in place."""
        if not isinstance(event.type, pb.EventActionResults):
            return
        for hr in event.type.digests:
            if isinstance(hr.digest, _Lazy):
                hr.digest = self._resolve(hr.digest.index)

    def _resolve(self, index: int) -> bytes:
        digest = self._results.get(index)
        if digest is None:
            self._flush()
            digest = self._results[index]
        return digest

    def _flush(self) -> None:
        if not self._pending:
            return
        start = time.perf_counter()
        digests = [hashlib.sha256(m).digest() for m in self._pending]
        wall = time.perf_counter() - start
        self.flush_wall_s.append(wall)
        self.flush_sizes.append(len(self._pending))
        self.host_digests += len(self._pending)
        if hooks.enabled:
            hooks.record_flush("hash", "batch", len(self._pending), wall)
        for offset, digest in enumerate(digests):
            self._results[self._base + offset] = digest
        self._base += len(self._pending)
        self._pending = []


class AsyncKernelHashPlane(CoalescingHashPlane):
    """The kernel-backed plane: every digest comes from the SHA-256 kernel.

    - **Bucket grouping.**  Work is grouped by power-of-two block bucket
      at submit time, and a full chunk launches immediately.
    - **Fixed launch shapes.**  Each bucket has one chunk row count (sized
      so a launch carries about ``_CHUNK_BYTES`` of padded blocks); tails
      pad up to it.
    - **Wave launches.**  When simulated time advances past the instant
      work was submitted at (``on_time``), every partly filled bucket
      launches, so the card works while the engine processes the events
      between submission and the results delivery.
    - **Lazy forcing.**  Each launch is followed by a ``non_blocking``
      copy of the digests into pinned host memory and a CUDA event; a
      digest's first demand waits on its chunk's event.  A demand for a
      digest not yet launched flushes every bucket to the kernel and
      waits.

    ``device="cpu"`` runs the same plane on the kernel's plain version
    (the tests); the default is the card, and without one the plane
    raises.

    ``launch`` is the digest call, ``fn(blocks, n_blocks) -> words``
    (``ops.sha256.sha256_digest_words``, or a chaos fault wrapped around
    it); ``breaker`` and ``timeout_s`` judge each call (module
    docstring).  With a breaker a launch waits for its readback, so a
    device fault and the deadline are judged before the next launch
    consults the breaker.
    """

    def __init__(self, chunk_rows: int = 8192, device="cuda", launch=None,
                 breaker=None, timeout_s=None):
        super().__init__()
        self.device = resolve_device(device)
        self.launch = launch if launch is not None else sha256_digest_words
        self.breaker = breaker
        self.timeout_s = timeout_s
        # Fault accounting (status.crypto_plane_status): failed attempts,
        # deadline overruns, rows re-launched, and rows computed off the
        # kernel (always 0: the plane has no host route).
        self.device_errors = 0
        self.device_timeouts = 0
        self.device_retries = 0
        self.fallback_digests = 0
        self.max_chunk_rows = chunk_rows
        # block bucket -> [(global index, preimage)], and its chunk rows
        self._buckets: dict[int, list] = {}
        self._rows: dict[int, int] = {}
        # chunk id -> (host words, CUDA events or None, [global indices],
        # launch wall s)
        self._inflight: dict[int, tuple] = {}
        self._chunk_of: dict[int, int] = {}  # global index -> chunk id
        self._next_chunk = 0
        # Set by submit, cleared when on_time launches the wave.
        self._dirty = False
        self.launches = 0
        self.demand_flushes = 0
        self.device_digests = 0
        # Digests by block bucket; launches by packed (rows, blocks) shape;
        # the host seconds spent packing, copying and launching chunks
        # (submit_s leaves them out); and the kernel's own time on the card
        # (CUDA events around each launch), summed as chunks resolve.
        self.bucket_digests: dict[int, int] = {}
        self.shape_launches: dict[tuple, int] = {}
        self.launch_s = 0.0
        self.kernel_ms = 0.0

    def rows_for(self, bucket: int) -> int:
        """Chunk row count for a block bucket: ~_CHUNK_BYTES per launch,
        clamped to [256, max_chunk_rows], power of two."""
        rows = _CHUNK_BYTES // (bucket * 64)
        rows = 1 << max(8, rows.bit_length() - 1)  # floor pow2, min 256
        return min(self.max_chunk_rows, rows)

    def submit(self, chunk_lists: list) -> list:
        start = time.perf_counter()
        launched = self.launch_s
        handles = []
        buckets, rows = self._buckets, self._rows
        for chunks in chunk_lists:
            msg = b"".join(chunks)
            index = self._base
            self._base += 1
            bucket = next_pow2(padded_blocks(len(msg)))
            group = buckets.get(bucket)
            if group is None:
                group = buckets[bucket] = []
                rows[bucket] = self.rows_for(bucket)
            group.append((index, msg))
            if len(group) >= rows[bucket]:
                self._launch(bucket, group)
                buckets[bucket] = []
            handles.append(_Lazy(self, index))
        self._dirty = True
        self.submit_s += (
            time.perf_counter() - start - (self.launch_s - launched)
        )
        return handles

    def on_time(self, _now: int) -> None:
        """Engine hook, called when simulated time advances: everything
        submitted at earlier instants is a complete wave; launch it now."""
        if self._dirty:
            self._dirty = False
            self._flush()

    def _launch(self, bucket: int, group: list) -> None:
        rows = self._rows[bucket]
        start = time.perf_counter()
        packed = pack_preimages(
            [msg for _i, msg in group], block_floor=bucket, batch_floor=rows
        )
        blocks, n_blocks = to_tensors(packed, self.device)
        launched = blocks.shape[0]
        cid = self._next_chunk
        if self.device.type == "cuda":
            began = torch.cuda.Event(enable_timing=True)
            ended = torch.cuda.Event(enable_timing=True)
            copied = torch.cuda.Event()

            def launch():
                began.record()
                words = self.launch(blocks, n_blocks)
                ended.record()
                host = torch.empty(
                    words.shape, dtype=words.dtype, pin_memory=True
                )
                host.copy_(words, non_blocking=True)
                copied.record()
                if self.breaker is not None:
                    copied.synchronize()  # the readback under the guard
                return host

            host, attempt_start = guarded_launch(
                self, launch, launched, f"digest launch {cid}"
            )
            events = (began, ended, copied)
        else:
            host, attempt_start = guarded_launch(
                self, lambda: self.launch(blocks, n_blocks), launched,
                f"digest launch {cid}",
            )
            events = None
        record_outcome(self, attempt_start)
        launch_s = time.perf_counter() - start
        self.launch_s += launch_s
        indices = [i for i, _msg in group]
        self._next_chunk += 1
        self._inflight[cid] = (host, events, indices, launch_s)
        for i in indices:
            self._chunk_of[i] = cid
        self.flush_sizes.append(len(indices))
        self.launches += 1
        self.device_digests += len(indices)
        self.bucket_digests[bucket] = (
            self.bucket_digests.get(bucket, 0) + len(indices)
        )
        shape = tuple(packed.blocks.shape[:2])
        self.shape_launches[shape] = self.shape_launches.get(shape, 0) + 1
        if hooks.enabled:
            hooks.record_flush("hash", "device", len(indices), launch_s)

    def _flush(self) -> None:
        """Launch every partly filled bucket."""
        for bucket, group in self._buckets.items():
            if group:
                self._launch(bucket, group)
                self._buckets[bucket] = []

    def _resolve(self, index: int) -> bytes:
        digest = self._results.get(index)
        if digest is not None:
            return digest
        if index not in self._chunk_of:
            # Demanded before its wave launched: launch now and wait below.
            self.demand_flushes += 1
            self._flush()
        cid = self._chunk_of[index]
        host, events, indices, launch_s = self._inflight.pop(cid)
        start = time.perf_counter()
        if events is not None:
            began, ended, copied = events
            copied.synchronize()
            self.kernel_ms += began.elapsed_time(ended)
        raw = words_to_digests(host)
        wall = launch_s + time.perf_counter() - start
        self.flush_wall_s.append(wall)
        if hooks.enabled:
            hooks.record_flush("hash", "readback", len(indices), wall)
        results = self._results
        for row, i in enumerate(indices):
            results[i] = raw[32 * row : 32 * row + 32]
            del self._chunk_of[i]
        return results[index]
