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
    """

    def __init__(self, chunk_rows: int = 8192, device="cuda"):
        super().__init__()
        self.device = resolve_device(device)
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
        if self.device.type == "cuda":
            began = torch.cuda.Event(enable_timing=True)
            ended = torch.cuda.Event(enable_timing=True)
            began.record()
            words = sha256_digest_words(blocks, n_blocks)
            ended.record()
            host = torch.empty(words.shape, dtype=words.dtype, pin_memory=True)
            host.copy_(words, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record()
            events = (began, ended, copied)
        else:
            host = sha256_digest_words(blocks, n_blocks)
            events = None
        launch_s = time.perf_counter() - start
        self.launch_s += launch_s
        indices = [i for i, _msg in group]
        cid = self._next_chunk
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
