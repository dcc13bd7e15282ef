"""Device-resident client/quorum plane: dense bitmask ack tracking with
popcount quorums on the card.

Mir's multi-leader design makes ack/quorum bookkeeping the per-request hot
path: every RequestAck from every node touches it, O(n^2) applications a
request, and PBFT's quorum rules are popcount-over-bitmask logic.  This
module keeps that plane on one card: per-slot agreement and non-null
masks, canonical digests, committed flags and tick classes live as dense
``(clients x window)`` torch tensors, and one step
(``ops.ack_plane.ack_step``: the hand-written kernels of
``csrc/ack_plane.cu`` on a card, their plain version on the CPU) absorbs a
whole columnar ack batch: canonical adoption, the one-non-null-vote spam
guard, the mask OR, the popcount quorum crossings and the tick
reclassification.  The client axis is split over a mesh of devices
(``parallel.sharding``, as the JAX package splits it with ``shard_map``):
each device owns a contiguous block of clients, every shard's step sees
the whole batch and applies the rows of its own block, and the per-row
outputs and the sweep's totals are summed across the shards by the
``shard_sum`` kernel (``ops.tally``; each row has exactly one owner, and
every other shard's word for it is 0).

``DeviceClientPlane`` is the host facade.  The authority contract (that of
the JAX package's plane, docs/DEVICE_TRACKER.md, mirroring ``_FastAcks``,
which stays the host-side reference):

- While the plane is live, per-slot vote masks (``agree``/``nonnull``) and
  canonical digests are authoritative ON THE DEVICE.  The owning
  ``ClientRequest``/``ClientReqNo`` objects hold stale lower bounds.
- Only *boundary outputs* come back to the host ``ClientTracker`` after
  each step: canonical adoptions (the slot's first vote), weak/strong
  quorum crossings, ready-mark hits, and rows the dense representation
  cannot express (fallback rows replay through the scalar ``step_ack``).
- The tracker keeps canonical ownership of windows and allocation.  Any
  host path that reads or mutates a slot's ack state calls ``sync_slot``:
  the device row is pulled into the objects and the slot becomes
  host-authoritative (``staged``) until the next flush re-derives it
  object->device, the analogue of ``_FastAcks.refresh``.
- Window-structure changes (checkpoint allocation, GC, reinitialize)
  ``drop()`` the plane; it rebuilds lazily, like the host mirror.

Where the port differs from the JAX package's plane:

- no fall-back: a plane that cannot be built (no card for
  ``device="cuda"``, a kernel that does not build) raises, and the tracker
  never carries on with the host plane in its place;
- an explicit device: the caller names it (``ack_device``, default
  ``"cuda"``; the CPU tests pass ``"cpu"``, which runs the kernels' plain
  versions);
- the mesh is one process's list of devices (``parallel.sharding.Mesh``),
  which may name one card several times; by default every visible card
  for ``"cuda"`` (one on a one-card machine: a mesh of one device, whose
  flush launches the step once and sums nothing) and one device for
  ``"cpu"``.  A mesh whose size is not a power of two pads the client
  axis up to a multiple of it;
- launch shapes in place of retraces: ``obsv.device`` counts each new
  padded batch shape against the JAX package's retrace budget.

Shapes are fixed per plane: the window axis is padded to a power of two
and ack batches to power-of-two row buckets (``MIN_BATCH_ROWS`` up to
``MAX_BATCH_ROWS``), so a run sees a handful of launch shapes.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..obsv import device as _device
from ..obsv import hooks
from ..obsv.bqueue import QueueTelemetry
from ..ops import ack_plane as _ops
from ..ops.ack_plane import (
    COMMITTED,
    SLOW,
    TICK_INERT,
    TICK_PYTHON,
    TICK_STEADY,
)
from ..parallel.sharding import Mesh, make_mesh, psum, replicate

#: Batch rows are padded to the next power of two, floored here, so the
#: whole run launches at most log2(max/min)+1 batch shapes.
MIN_BATCH_ROWS = 1024
MAX_BATCH_ROWS = 65536


def resolve_ack_plane(explicit: str | None = None) -> str:
    """Resolve the ack-plane selection: explicit config wins, then the
    ``MIRBFT_ACK_PLANE`` environment knob, then the host default."""
    plane = explicit if explicit is not None else os.environ.get(
        "MIRBFT_ACK_PLANE", "host"
    )
    if plane not in ("host", "device"):
        raise ValueError(f"ack_plane must be host|device, got {plane!r}")
    return plane


def resolve_flush_rows(explicit: int | None = None) -> int:
    """Resolve the frame-coalescing threshold: the plane defers its step
    until at least this many ack rows are queued (1 keeps the synchronous
    flush-per-frame default).  Explicit config wins, then the
    ``MIRBFT_ACK_FLUSH_ROWS`` environment knob."""
    if explicit is None:
        raw = os.environ.get("MIRBFT_ACK_FLUSH_ROWS", "1")
        try:
            explicit = int(raw)
        except ValueError:
            raise ValueError(
                f"ack_flush_rows must be an integer, got {raw!r}"
            ) from None
    if explicit < 1:
        raise ValueError(f"ack_flush_rows must be >= 1, got {explicit}")
    return explicit


def require_device(device):
    """The plane's device, or a raise: ``"cuda"`` needs a card, ``"cpu"``
    runs the plain versions, anything else is refused.  Where the JAX
    package probed for a backend and fell back to the host plane, the port
    raises.  A ``parallel.sharding.Mesh`` is returned as it is once each
    of its devices passes."""
    if isinstance(device, Mesh):
        for each in device.devices:
            require_device(each)
        return device
    try:
        device = torch.device(device)
    except RuntimeError:
        raise ValueError(
            f"ack_device must be cuda or cpu, got {device!r}"
        ) from None
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ack_plane='device' on ack_device='cuda', but no CUDA card "
                "is present; pass ack_device='cpu' for the kernels' plain "
                "versions"
            )
    elif device.type != "cpu":
        raise ValueError(f"ack_device must be cuda or cpu, got {device}")
    return device


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def default_mesh(device) -> Mesh:
    """The plane's mesh when none is given, as the JAX package's is every
    device JAX sees: every visible card for ``"cuda"``, the one device for
    ``"cpu"``."""
    device = require_device(device)
    if device.type == "cuda":
        return make_mesh()
    return Mesh((device,))


def classify_tick_device(
    committed: bool, slow: bool, count: int, held: bool,
    my_or_weak: bool, weak_q: int,
) -> int:
    """The device plane's tick-class contract (the reference the oracle
    audits the ``tick_class`` array against).  Committed slots are inert;
    slots the dense representation cannot express (``slow``) take the
    python path whenever any request state exists; otherwise the class is
    pure popcount: a held canonical rebroadcasts on the steady cadence, a
    weak-quorum canonical we do not hold needs fetch ticks (python), and
    anything below the weak quorum with nothing held is inert."""
    if committed:
        return TICK_INERT
    if slow:
        return TICK_PYTHON if my_or_weak else TICK_INERT
    if held:
        return TICK_STEADY
    if count >= weak_q:
        return TICK_PYTHON
    return TICK_INERT


def digest_words(dig_mat: np.ndarray) -> np.ndarray:
    """(rows, 32) uint8 digest matrix -> (rows, 8) little-endian uint32
    words (the device-side digest representation)."""
    return np.ascontiguousarray(dig_mat).view("<u4")


def words_to_digest(words: np.ndarray) -> bytes:
    return np.ascontiguousarray(words, dtype="<u4").tobytes()


def _combine_limbs(row: np.ndarray) -> int:
    value = 0
    for limb in range(row.shape[0] - 1, -1, -1):
        value = (value << 32) | int(row[limb])
    return value


def _split_limbs(value: int, limbs: int) -> list:
    mask = (1 << 32) - 1
    return [(value >> (32 * i)) & mask for i in range(limbs)]


def batch_rows(n: int) -> int:
    """The padded row count of a step over ``n`` queued rows: the next
    power of two, at least ``MIN_BATCH_ROWS``; past ``MAX_BATCH_ROWS`` the
    next power of two that holds them."""
    rows = min(max(_pow2(n), MIN_BATCH_ROWS), MAX_BATCH_ROWS)
    while rows < n:
        rows <<= 1
    return rows


def _plane_step(batch, mesh, shards, firsts, *, block, weak_q, strong_q):
    """X1 on every shard of a plane of several: the packed batch (on
    ``mesh.devices[0]``) on each shard's device, each shard's step with its
    block's first client row, and the per-row outputs summed by
    ``shard_sum``."""
    outs = [
        _ops.ack_step(*state, rows, weak_q=weak_q, strong_q=strong_q,
                      first=first, base=i * block)
        for i, (state, first, rows) in enumerate(
            zip(shards, firsts, replicate(mesh, batch)))
    ]
    return psum(mesh, outs)


def _plane_sweep(agree, mesh, shards, *, weak_q, strong_q):
    """X2 on every shard of a plane of several (``agree`` is the first
    shard's, the device the telemetry times on), the (3,) totals summed by
    ``shard_sum``."""
    totals = [
        _ops.quorum_sweep(s[0], s[3], s[4], s[5], s[6], weak_q=weak_q,
                          strong_q=strong_q)
        for s in shards
    ]
    return psum(mesh, totals)


# The device programs, instrumented under the JAX package's names: a plane
# of one shard calls X1 and X2 themselves, one of several the two above.
_step = _device.instrument(
    "device_ack_step", fn_name="device_ack_step"
)(_ops.ack_step)
_sweep = _device.instrument(
    "device_quorum_sweep", fn_name="device_quorum_sweep"
)(_ops.quorum_sweep)
_mesh_step = _device.instrument(
    "device_ack_step", fn_name="device_ack_step"
)(_plane_step)
_mesh_sweep = _device.instrument(
    "device_quorum_sweep", fn_name="device_quorum_sweep"
)(_plane_sweep)


# ---------------------------------------------------------------------------
# Host facade
# ---------------------------------------------------------------------------


class DeviceClientPlane:
    """Batches incoming acks, runs the step on the device, and materializes
    only the boundary outputs back into the host ``ClientTracker``.

    Built from a live tracker (same construction contract as
    ``_FastAcks``); dropped on any window-structure change.  ``device``
    is ``"cuda"`` (the kernels; raises without a card), ``"cpu"`` (their
    plain versions) or a ``parallel.sharding.Mesh``; a name gives the plane
    ``default_mesh(device)``.  A split across several cards (the default on
    a machine with more than one) has never been measured against the
    one-card plane: only one card's figures exist, where a split only adds
    launches."""

    def __init__(self, tracker, device="cuda"):
        from ..ops import tally as _tally
        from .quorum import intersection_quorum, some_correct_quorum

        mesh = require_device(
            device if isinstance(device, Mesh) else default_mesh(device))
        self.mesh = mesh
        self.device = mesh.devices[0]
        if any(d.type == "cuda" for d in mesh.devices):
            # Build (or load) the kernels now: a plane whose kernels do not
            # build must fail here, not at its first ack.
            _ops._kernel_library()
            if mesh.size > 1:
                _tally._kernel_library()
        n_shards = mesh.size
        nc = tracker.network_config
        self.weak_q = some_correct_quorum(nc)
        self.strong_q = intersection_quorum(nc)
        self.limbs = ((max(nc.nodes) >> 5) + 1) if nc.nodes else 1

        clients = tracker.clients
        cids = sorted(clients)
        self.cid0 = cids[0]
        self.n_clients = cids[-1] - cids[0] + 1
        self.c_pad = max(_pow2(self.n_clients), n_shards)
        self.c_pad += -self.c_pad % n_shards
        # Shard i owns client rows i * block .. (i + 1) * block - 1.
        self.block = self.c_pad // n_shards
        w_max = 1
        for cid in cids:
            c = clients[cid]
            w_max = max(w_max, c.high_watermark - c.low_watermark + 1)
        self.w_pad = _pow2(w_max)
        self.total = self.c_pad * self.w_pad
        self.shard_slots = self.block * self.w_pad

        # Host-owned window metadata (windows never move during the
        # plane's lifetime: structure changes drop it).
        self.base_arr = np.zeros(self.n_clients + 1, dtype=np.int64)
        self.low_arr = np.zeros(self.n_clients + 1, dtype=np.int64)
        self.high_arr = np.full(self.n_clients + 1, -1, dtype=np.int64)
        self.nrm_arr = np.full(self.n_clients + 1, -1, dtype=np.int64)
        self.clients: list = [None] * (self.n_clients + 1)
        self.canon_req: list = [None] * self.total
        self.canon_crn: list = [None] * self.total

        agree = np.zeros((self.total, self.limbs), dtype=np.uint32)
        nonnull = np.zeros((self.total, self.limbs), dtype=np.uint32)
        canon = np.zeros((self.total, 8), dtype=np.uint32)
        canon_ok = np.zeros(self.total, dtype=bool)
        flags = np.zeros(self.total, dtype=np.uint8)
        held = np.zeros(self.total, dtype=bool)
        tick = np.zeros(self.total, dtype=np.uint8)

        # Phantom rows (window padding and the dense-id gaps) are SLOW so
        # no row can ever apply against them.
        flags[:] = SLOW
        for cid in cids:
            ci = cid - self.cid0
            client = clients[cid]
            self.clients[ci] = client
            self.base_arr[ci] = client.low_watermark
            self.low_arr[ci] = client.low_watermark
            self.high_arr[ci] = client.high_watermark
            self.nrm_arr[ci] = client.next_ready_mark
            size = client.high_watermark - client.low_watermark + 1
            offset = ci * self.w_pad
            for i in range(size):
                slot = offset + i
                crn = client.req_no_map.get(client.low_watermark + i)
                self.canon_crn[slot] = crn
                (
                    agree[slot], nonnull[slot], canon[slot],
                    canon_ok[slot], flags[slot], held[slot], tick[slot],
                    self.canon_req[slot],
                ) = self._derive_row(crn)

        shape = (self.block, self.w_pad)
        arrays = (
            (agree.view(np.int32), (self.limbs,)),
            (nonnull.view(np.int32), (self.limbs,)),
            (canon.view(np.int32), (8,)),
            (canon_ok, ()), (flags, ()), (held, ()), (tick, ()),
        )
        per = self.shard_slots
        # One list of the seven state tensors a shard, on its device.
        self._shards = [
            [self._put(a[i * per:(i + 1) * per].reshape(shape + tail), d)
             for a, tail in arrays]
            for i, d in enumerate(mesh.devices)
        ]
        # Each shard's adoption scratch for the kernel (the plain version
        # needs none): empty between steps.
        self._firsts = [
            _ops.new_first(per, d) if d.type == "cuda" else None
            for d in mesh.devices
        ]

        # The owning tracker: the drain target for flushes forced by sync
        # points (sync_slot, quorum_sweep) that have no tracker in their
        # signature.  Same lifetime as the plane itself.
        self._tracker = tracker
        # Frame coalescing: apply_frame defers the step until this many
        # rows are queued (1 = flush every frame).
        self.flush_rows = getattr(tracker, "_ack_flush_rows", 1)
        self._staged: dict = {}  # slot -> True (host-authoritative)
        self._snapshot: dict | None = None
        self._pending: list = []  # [(src, ci, w, rno, dig_words, msgs?)]
        self._pending_rows = 0
        # Staged-frame backpressure telemetry: depth = queued ack rows,
        # wait = first-staged-row age at flush, saturated = flushes forced
        # by the coalescing threshold (vs sync-point flushes).
        self.telemetry = QueueTelemetry("device.ack_stage")
        self._stage_started = 0.0
        self._events: list = []  # flush boundary outputs awaiting drain
        # Cumulative plane counters (bench/report surface).
        self.acks_applied = 0
        self.acks_dropped = 0
        self.acks_fallback = 0
        self.batches = 0

    def _put(self, array: np.ndarray, device=None) -> torch.Tensor:
        device = self.device if device is None else device
        array = np.ascontiguousarray(array)
        _device.transfer("h2d", array.nbytes, device)
        return torch.from_numpy(array).to(device)

    def _get(self, tensor: torch.Tensor) -> np.ndarray:
        """A host copy of ``tensor`` (also on the CPU: the state changes in
        place)."""
        _device.transfer("d2h", tensor.nbytes, tensor.device)
        return tensor.to("cpu", copy=True).numpy()

    def _by_shard(self, slots: np.ndarray):
        """Flat slots grouped by the shard that owns them: (shard, its
        positions in ``slots``, local client rows, window columns)."""
        if len(self._shards) == 1:
            yield 0, slice(None), slots // self.w_pad, slots % self.w_pad
            return
        shard = slots // self.shard_slots
        local = slots % self.shard_slots
        for i in np.unique(shard).tolist():
            at = np.flatnonzero(shard == i)
            yield i, at, local[at] // self.w_pad, local[at] % self.w_pad

    # -- slot math -----------------------------------------------------------

    def slot_of(self, client_id: int, req_no: int) -> int | None:
        ci = client_id - self.cid0
        if not (0 <= ci < self.n_clients):
            return None
        if not (self.low_arr[ci] <= req_no <= self.high_arr[ci]):
            return None
        return ci * self.w_pad + int(req_no - self.base_arr[ci])

    def _ident(self, slot: int) -> tuple:
        ci = slot // self.w_pad
        return ci + self.cid0, int(self.base_arr[ci]) + slot % self.w_pad

    # -- object -> device (staged refresh) -----------------------------------

    def _derive_row(self, crn):
        """Re-derive one slot's dense row from the authoritative objects
        (the device analogue of ``_FastAcks._refresh_slot``)."""
        from .client_tracker import _NULL

        za = np.zeros(self.limbs, dtype=np.uint32)
        zc = np.zeros(8, dtype=np.uint32)
        if crn is None:
            return za, za, zc, False, SLOW, False, TICK_INERT, None
        if crn.committed is not None:
            return za, za, zc, False, COMMITTED, False, TICK_INERT, None
        requests = crn.requests
        if not requests:
            # Virgin slot: the step may adopt its first digest.
            return za, za, zc, False, 0, False, TICK_INERT, None
        canonical = len(requests) == 1 and _NULL not in requests
        if canonical:
            (digest,) = requests
            req = requests[digest]
            fetchy = any(
                (not cr.stored) or cr.fetching
                for cr in crn.weak_requests.values()
            )
            if not fetchy:
                agree = np.asarray(
                    _split_limbs(req.agreements, self.limbs), dtype=np.uint32
                )
                nonnull = np.asarray(
                    _split_limbs(crn.non_null_voters, self.limbs),
                    dtype=np.uint32,
                )
                canon = digest_words(
                    np.frombuffer(digest, dtype=np.uint8)
                ).reshape(8)
                held = digest in crn.my_requests and crn.acks_sent > 0
                count = req.agreements.bit_count()
                tick = classify_tick_device(
                    False, False, count, held, True, self.weak_q
                )
                return agree, nonnull, canon, True, 0, held, tick, req
        # Conflicting digests, a null request in play, or fetch machinery
        # in motion: the slot is host-authoritative (rows fall back).
        my_or_weak = bool(crn.my_requests or crn.weak_requests)
        tick = classify_tick_device(
            False, True, 0, False, my_or_weak, self.weak_q
        )
        return za, za, zc, False, SLOW, False, tick, None

    def sync_slot(self, client_id: int, req_no: int) -> None:
        """Hand one slot back to the objects: pull the device masks into
        the owning request/req-no, then mark the slot staged so the next
        flush re-derives it object->device.  Idempotent until that flush.

        Queued batches AND buffered boundary events are drained into the
        owning tracker first: staging a slot whose adoption/crossing
        events are still buffered would leave ``canon_req`` unset, so the
        masks pulled below would land nowhere and the next
        ``_flush_staged`` would re-derive the row from vote-less objects,
        silently losing applied acks."""
        slot = self.slot_of(client_id, req_no)
        if slot is None:
            return
        if slot in self._staged:
            return
        if self._pending_rows or self._events:
            self.flush(drain=self._tracker)
        self._staged[slot] = True
        snap = self.host_snapshot()
        if snap["canon_ok"][slot] and not snap["flags"][slot]:
            req = self.canon_req[slot]
            crn = self.canon_crn[slot]
            if req is not None:
                req._agreements = _combine_limbs(snap["agree"][slot])
            if crn is not None:
                crn._non_null_voters = _combine_limbs(snap["nonnull"][slot])

    def mark_committed(self, client_id: int, req_no: int) -> None:
        slot = self.slot_of(client_id, req_no)
        if slot is not None:
            self._staged[slot] = True

    def _flush_staged(self) -> None:
        if not self._staged:
            return
        slots = np.fromiter(
            self._staged, dtype=np.int64, count=len(self._staged)
        )
        self._staged = {}
        k = len(slots)
        agree = np.zeros((k, self.limbs), dtype=np.uint32)
        nonnull = np.zeros((k, self.limbs), dtype=np.uint32)
        canon = np.zeros((k, 8), dtype=np.uint32)
        canon_ok = np.zeros(k, dtype=bool)
        flags = np.zeros(k, dtype=np.uint8)
        held = np.zeros(k, dtype=bool)
        tick = np.zeros(k, dtype=np.uint8)
        for i, slot in enumerate(slots.tolist()):
            _cid, rno = self._ident(slot)
            client = self.clients[slot // self.w_pad]
            crn = client.req_no_map.get(rno) if client is not None else None
            self.canon_crn[slot] = crn
            (
                agree[i], nonnull[i], canon[i], canon_ok[i], flags[i],
                held[i], tick[i], self.canon_req[slot],
            ) = self._derive_row(crn)
        rows = (
            agree.view(np.int32), nonnull.view(np.int32), canon.view(np.int32),
            canon_ok, flags, held, tick,
        )
        for i, at, ci, w in self._by_shard(slots):
            device = self.mesh.devices[i]
            ci, w = self._put(ci, device), self._put(w, device)
            for dev, row in zip(self._shards[i], rows):
                dev[ci, w] = self._put(row[at], device)
        self._snapshot = None

    # -- device -> host ------------------------------------------------------

    def host_snapshot(self) -> dict:
        """Host numpy view of the dense state (masks and digest words as
        uint32), cached until the next flush or staged write invalidates
        it."""
        snap = self._snapshot
        if snap is None:
            names = (
                "agree", "nonnull", "canon", "canon_ok", "flags", "held",
                "tick_class",
            )
            snap = {}
            for j, name in enumerate(names):
                parts = [self._get(shard[j]) for shard in self._shards]
                array = parts[0] if len(parts) == 1 else np.concatenate(parts)
                if array.dtype == np.int32:
                    array = array.view(np.uint32)
                snap[name] = array.reshape((self.total,) + array.shape[2:])
            self._snapshot = snap
        return snap

    # -- batch ingest --------------------------------------------------------

    def submit_columns(self, source, ids, rnos, dig_mat, msgs=None):
        """Queue one columnar ack batch (the plane's native ingest: the
        boundary between transport framing and the dense state is these
        four columns).  ``msgs`` carries the originating pb messages when
        available so fallback rows can replay through the scalar path;
        column-only callers must not produce fallback rows (asserted by
        the bench rung's zero-fallback gate).

        Rows outside the dense window (unknown clients, out-of-window
        req_nos) are returned as an index array for the caller to route
        through the tracker's buffering rules."""
        ci = np.asarray(ids, dtype=np.int64) - self.cid0
        rnos = np.asarray(rnos, dtype=np.int64)
        known = (ci >= 0) & (ci < self.n_clients)
        cis = np.where(known, ci, self.n_clients)
        in_win = (rnos >= self.low_arr[cis]) & (rnos <= self.high_arr[cis])
        out_rows = np.flatnonzero(~in_win)
        keep = in_win if len(out_rows) else slice(None)
        w = (rnos - self.base_arr[cis])[keep]
        self._pending.append(
            (
                int(source),
                cis[keep].astype(np.int32),
                w.astype(np.int32),
                rnos[keep],
                digest_words(dig_mat[keep]),
                [msgs[i] for i in np.flatnonzero(in_win)]
                if (msgs is not None and len(out_rows))
                else msgs,
            )
        )
        was_empty = not self._pending_rows
        self._pending_rows += int(in_win.sum()) if len(out_rows) else len(
            rnos
        )
        if hooks.enabled:
            if was_empty and self._pending_rows:
                self._stage_started = time.perf_counter()
            self.telemetry.depth(self._pending_rows)
        return out_rows

    def flush(self, drain) -> None:
        """Run the step over everything queued; buffer the boundary
        outputs (drained into the tracker by ``drain_events``, or
        immediately when ``drain`` is the owning tracker)."""
        if not self._pending_rows:
            if drain is not None:
                self.drain_events(drain)
            return
        if hooks.enabled:
            if self._stage_started:
                self.telemetry.wait(
                    max(0.0, time.perf_counter() - self._stage_started)
                )
            self._stage_started = 0.0
            self.telemetry.depth(0)
        self._flush_staged()
        pending, self._pending = self._pending, []
        n = self._pending_rows
        self._pending_rows = 0

        ci = np.concatenate([p[1] for p in pending])
        w = np.concatenate([p[2] for p in pending])
        rnos = np.concatenate([p[3] for p in pending])
        dig = np.concatenate([p[4] for p in pending])
        src = np.concatenate(
            [np.full(len(p[1]), p[0], dtype=np.int32) for p in pending]
        )
        # One packed (rows, 12) batch: one copy to the device; padding
        # rows are zero (valid 0).
        batch = np.zeros((batch_rows(n), _ops.BATCH_COLS), dtype=np.int32)
        batch[:n, 0] = ci
        batch[:n, 1] = w
        batch[:n, 2] = src
        batch[:n, 3] = 1
        batch[:n, 4:] = dig.view(np.int32)
        if len(self._shards) == 1:
            out = _step(
                *self._shards[0], self._put(batch), weak_q=self.weak_q,
                strong_q=self.strong_q, first=self._firsts[0],
            )
        else:
            out = _mesh_step(
                self._put(batch), self.mesh, self._shards, self._firsts,
                block=self.block, weak_q=self.weak_q, strong_q=self.strong_q,
            )
        self._snapshot = None
        # The seven row outputs come back in one copy.
        packed = self._get(out[:n])
        applied = (packed & _ops.OUT_APPLIED) != 0
        fb = (packed & _ops.OUT_FALLBACK) != 0
        dropped = (packed & _ops.OUT_DROPPED) != 0
        adopt = (packed & _ops.OUT_ADOPT) != 0
        weak_x = (packed & _ops.OUT_WEAK) != 0
        strong_x = (packed & _ops.OUT_STRONG) != 0
        newcount = packed >> _ops.NEWCOUNT_SHIFT
        self.batches += 1
        self.acks_applied += int(applied.sum())
        self.acks_dropped += int(dropped.sum())
        self.acks_fallback += int(fb.sum())
        if hooks.enabled:
            hooks.record_ack_batch("device", n)

        # Ready-mark hits are detected host-side (next_ready_mark is
        # host-owned and moves during drains).
        nrm_hit = applied & (rnos == self.nrm_arr[ci]) & (
            newcount >= self.strong_q
        )
        slots = ci.astype(np.int64) * self.w_pad + w
        msgs_rows = None
        if any(p[5] is not None for p in pending):
            msgs_rows = []
            for p in pending:
                if p[5] is None:
                    msgs_rows.extend([None] * len(p[1]))
                else:
                    msgs_rows.extend(
                        (p[0], m) for m in p[5]
                    )
        self._events.append(
            {
                "slots": slots,
                "rnos": rnos,
                "dig": dig,
                "applied": applied,
                "adopt": adopt,
                "weak": weak_x,
                "strong": strong_x,
                "nrm_hit": nrm_hit,
                "msgs": msgs_rows,
                "fallback": fb,
            }
        )
        if drain is not None:
            self.drain_events(drain)

    def drain_events(self, tracker) -> None:
        """Materialize buffered boundary outputs into the host objects:
        adopted canonicals become ``ClientRequest`` entries, weak
        crossings feed the available list, strong crossings complete
        certificates and may advance the ready mark, and fallback rows
        replay through the scalar reference path."""
        if not self._events:
            return
        from . import client_tracker as _ct
        from .. import pb

        events, self._events = self._events, []
        w_pad = self.w_pad
        canon_req = self.canon_req
        canon_crn = self.canon_crn
        for ev in events:
            slots = ev["slots"]
            adopt_rows = np.flatnonzero(ev["adopt"])
            for r in adopt_rows.tolist():
                slot = int(slots[r])
                crn = canon_crn[slot]
                if crn is None:
                    continue
                digest = words_to_digest(ev["dig"][r])
                req = crn.requests.get(digest)
                if req is None:
                    req = _ct.ClientRequest(
                        ack=pb.RequestAck(
                            client_id=crn.client_id,
                            req_no=crn.req_no,
                            digest=digest,
                        )
                    )
                    crn.requests[digest] = req
                canon_req[slot] = req

            snap = None
            for name, member in (("weak", "weak_requests"),
                                 ("strong", "strong_requests")):
                cross = np.flatnonzero(ev[name])
                if not len(cross):
                    continue
                if snap is None:
                    snap = self.host_snapshot()
                seen = set()
                for r in cross.tolist():
                    slot = int(slots[r])
                    if slot in seen:
                        continue
                    seen.add(slot)
                    req = canon_req[slot]
                    crn = canon_crn[slot]
                    if req is None or crn is None:
                        continue
                    digest = req.ack.digest
                    bucket = getattr(crn, member)
                    if digest in bucket:
                        continue
                    bucket[digest] = req
                    # Crossings carry the mask back to the object so fetch
                    # targeting sees the voters the device saw.
                    req._agreements = _combine_limbs(snap["agree"][slot])
                    if name == "weak" and not req.garbage:
                        tracker.available_list.push_back(req)

            applied_slots = np.unique(slots[ev["applied"]])
            for slot in applied_slots.tolist():
                client = self.clients[slot // w_pad]
                if client is not None:
                    client._tick_pending.add(
                        int(self.base_arr[slot // w_pad]) + slot % w_pad
                    )

            for r in np.flatnonzero(ev["nrm_hit"]).tolist():
                slot = int(slots[r])
                crn = canon_crn[slot]
                client = self.clients[slot // w_pad]
                if crn is not None and client is not None:
                    if crn.strong_requests:
                        tracker.check_ready(client, crn)

            fb_rows = np.flatnonzero(ev["fallback"])
            if len(fb_rows):
                msgs_rows = ev["msgs"]
                if msgs_rows is None:
                    raise AssertionError(
                        "column-only ingest produced fallback rows; "
                        "replay needs the originating messages"
                    )
                for r in fb_rows.tolist():
                    entry = msgs_rows[r]
                    if entry is None:
                        continue
                    source, msg = entry
                    # step_ack syncs the slot itself via the tracker's
                    # device branch.
                    tracker.step_ack(source, msg)

    # -- tracker entry points ------------------------------------------------

    def apply_frame(self, tracker, source: int, msgs: list) -> None:
        """One inbound ack frame: columnize and queue; the step runs once
        ``flush_rows`` ack rows are queued (1 = every frame, the
        default).  Sync points (``sync_slot`` before any scalar mutation,
        the tracker's tick boundary, the oracle audits, ``drop``) force an
        earlier flush and drain, so coalescing only ever delays
        materialization, never loses it.  Out-of-window rows take the
        tracker's buffering rules at once (the same verdicts the scalar
        path reaches); they never need the step."""
        from .client_tracker import _frame_columns

        ids, rnos, dig_mat, irregular = _frame_columns(msgs)
        if irregular is not None:
            # Null/odd-length digests cannot be dense rows; replay them
            # through the scalar path after the vector rows (the same
            # ordering relaxation _step_ack_vector documents).
            keep = np.ones(len(msgs), dtype=bool)
            keep[irregular] = False
            kept_msgs = [m for i, m in enumerate(msgs) if keep[i]]
            out_rows = self.submit_columns(
                source, ids[keep], rnos[keep], dig_mat[keep],
                msgs=kept_msgs,
            )
            tail = [msgs[i] for i in irregular]
        else:
            kept_msgs = msgs
            out_rows = self.submit_columns(
                source, ids, rnos, dig_mat, msgs=msgs
            )
            tail = []
        if self._pending_rows >= self.flush_rows:
            # Coalescing threshold hit: the staging buffer is "full" in the
            # backpressure sense (vs a sync-point-forced flush).
            self.telemetry.saturated()
            self.flush(drain=tracker)
        # out_rows index the SUBMITTED subset, not the original frame:
        # replay through kept_msgs so a filtered null-digest row can never
        # misroute a later out-of-window ack onto the wrong message (node
        # state must not depend on transport framing).
        for r in np.asarray(out_rows).tolist():
            tracker.step_ack(source, kept_msgs[r])  # buffers / drops
        for msg in tail:
            tracker.step_ack(source, msg)

    def quorum_sweep(self) -> dict:
        """Tally quorum certificates across every (client, window) bucket
        in one device pass; refreshes the tick_class plane from the same
        popcounts.  Coalesced frames still in the queue are flushed (and
        their boundary events drained) first so the tally never lags the
        ingested acks."""
        if self._pending_rows or self._events:
            self.flush(drain=self._tracker)
        self._flush_staged()
        if len(self._shards) == 1:
            dev = self._shards[0]
            totals = _sweep(
                dev[0], dev[3], dev[4], dev[5], dev[6], weak_q=self.weak_q,
                strong_q=self.strong_q,
            )
        else:
            totals = _mesh_sweep(
                self._shards[0][0], self.mesh, self._shards,
                weak_q=self.weak_q, strong_q=self.strong_q,
            )
        self._snapshot = None
        weak, strong, committed = self._get(totals).tolist()
        return {
            "weak_certs": weak,
            "strong_certs": strong,
            "committed": committed,
        }

    def mark_committed_bulk(self, slots: np.ndarray) -> None:
        """Flag many slots committed in one scatter (bench/commit-drain
        path; the per-request path stages through ``mark_committed``)."""
        slots = np.asarray(slots, dtype=np.int64)
        for i, _at, ci, w in self._by_shard(slots):
            device = self.mesh.devices[i]
            ci, w = self._put(ci, device), self._put(w, device)
            dev = self._shards[i]
            dev[4][ci, w] = COMMITTED
            dev[6][ci, w] = TICK_INERT
            dev[3][ci, w] = False
        self._snapshot = None

    def drop(self, tracker) -> None:
        """Materialize everything back into the objects before the plane
        is discarded (window moves, GC, reinitialize): the device analogue
        of ``ClientTracker._drop_fast``."""
        self.flush(drain=tracker)
        snap = self.host_snapshot()
        canon_ok = snap["canon_ok"]
        flags = snap["flags"]
        agree = snap["agree"]
        nonnull = snap["nonnull"]
        for slot in np.flatnonzero(canon_ok & (flags == 0)).tolist():
            if slot in self._staged:
                continue  # objects already authoritative
            req = self.canon_req[slot]
            crn = self.canon_crn[slot]
            if req is not None:
                req._agreements = _combine_limbs(agree[slot])
            if crn is not None:
                crn._non_null_voters = _combine_limbs(nonnull[slot])
