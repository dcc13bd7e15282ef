"""Client request tracking: windows, ACK certificates, replication.

Rebuild of the reference's largest and subtlest component (reference:
client_tracker.go:19-1267; the design essay at :19-115 is the spec).  In
brief:

- Requests enter either locally (Propose → verified → digest → ACK
  broadcast) or via a weak quorum (f+1) of RequestAcks proving some correct
  replica validated them.  A strong quorum (2f+1) makes a request safe to
  propose.
- Each client has a sliding window of request numbers [low_watermark,
  low_watermark + width]; windows advance only at checkpoint boundaries,
  with the *previous* checkpoint's width consumption throttling how much of
  the new window is usable before the next checkpoint
  (``valid_after_seq_no`` — see commits_completed_for_checkpoint_window).
- A client observed submitting two distinct correct requests for one req_no
  is (accidentally or deliberately) byzantine: replicas then advocate a
  *null request* for that req_no, consuming it without committing data.
- Correct-but-missing requests are fetched from their ackers after a few
  ticks, refetched on timeout, and ACKs are rebroadcast with linear backoff
  so a stalled client's request eventually reaches everyone.

Deliberate deviations from the reference:
- digests are replayed in true byte order on reinitialize (the reference's
  comparator at client_tracker.go:759-761 compares indices, not values,
  yielding map-order nondeterminism);
- the committed-mask bit during window rebuild is read at
  ``req_no - high_state.low_watermark`` — correct for any low/high state
  pair, where the reference's ``i + high_offset`` (client_tracker.go:1109)
  is only right because it always passes the same state for both;
- a fully consumed client window is re-extended at the checkpoint boundary
  instead of stalling (see Client.allocate).
"""

from __future__ import annotations

from dataclasses import dataclass

from .. import pb
from ..obsv import hooks
from .actions import Actions
from .msgbuffers import Applyable, MsgBuffer, NodeBuffers
from .persisted import Persisted
from .preimage import request_hash_data
from .quorum import bit_is_set, intersection_quorum, make_bitmask, mask_ids, set_bit, some_correct_quorum

_NULL = b""  # digest key of the null request

# Shared no-op result for hot paths; MUST never be mutated (callers only
# ever concat it into their own Actions).
from .actions import EMPTY_ACTIONS as _EMPTY_ACTIONS  # noqa: E402  (shared hot-path empty)

_CORRECT_FETCH_TICKS = 4
_FETCH_TIMEOUT_TICKS = 4
_ACK_RESEND_TICKS = 20


# ---------------------------------------------------------------------------
# Stable lists: append-only linked lists whose iterators survive removal of
# elements by other iterators (reference: client_tracker.go:117-284).  The
# proposer holds a long-lived iterator over the ready list across GC.
# ---------------------------------------------------------------------------


class _StableNode:
    __slots__ = ("value", "next")

    def __init__(self, value=None):
        self.value = value
        self.next = None


_TOMBSTONE = object()


class StableList:
    """Singly linked append-only list.  Removal tombstones the node; the
    next traversal splices tombstone runs out of the chain so they can be
    collected.  Live iterators already holding a spliced node keep walking
    its ``next`` chain; fresh iterators never see it."""

    def __init__(self):
        self._head = _StableNode()  # sentinel
        self._tail = self._head

    def push_back(self, value) -> None:
        node = _StableNode(value)
        self._tail.next = node
        self._tail = node

    def iterator(self) -> "StableIterator":
        return StableIterator(self, self._head)


class StableIterator:
    def __init__(self, lst: StableList, start: _StableNode):
        self._list = lst
        self._prev = start  # last node we returned (or sentinel)

    def _peek(self):
        node = self._prev.next
        while node is not None and node.value is _TOMBSTONE:
            node = node.next
        if node is not self._prev.next and self._prev.value is not _TOMBSTONE:
            # Splice the tombstone run out of the chain so the nodes can be
            # collected (tombstoning alone leaks one node per removed
            # request, forever).  Safe for concurrent iterators: a spliced
            # node keeps its own ``next`` pointer, so anyone parked on it
            # rejoins the live chain here.  Only a live anchor may splice —
            # a tombstoned ``_prev`` may itself already be off-chain, and
            # writing through it (or pointing ``_tail`` at it) would orphan
            # the suffix.
            if node is None:
                self._list._tail = self._prev
            self._prev.next = node
        return node

    def has_next(self) -> bool:
        return self._peek() is not None

    def next(self):
        node = self._peek()
        if node is None:
            raise StopIteration
        self._prev = node
        return node.value

    def remove_last(self) -> None:
        """Tombstone the element most recently returned by next()."""
        self._prev.value = _TOMBSTONE


class ReadyList:
    """Requests with a strong cert that we hold locally, in discovery order
    — the proposer's input queue."""

    def __init__(self):
        self._list = StableList()

    def push_back(self, crn: "ClientReqNo") -> None:
        self._list.push_back(crn)

    def iterator(self) -> StableIterator:
        return self._list.iterator()

    def garbage_collect(self, seq_no: int) -> None:
        it = self._list.iterator()
        while it.has_next():
            crn = it.next()
            if crn.committed is not None and crn.committed <= seq_no:
                it.remove_last()


class AvailableList:
    """Requests with f+1 ACKs whose data we hold (correct + persisted)."""

    def __init__(self):
        self._list = StableList()

    def push_back(self, cr: "ClientRequest") -> None:
        self._list.push_back(cr)

    def iterator(self) -> StableIterator:
        return self._list.iterator()

    def garbage_collect(self, _seq_no: int) -> None:
        it = self._list.iterator()
        while it.has_next():
            if it.next().garbage:
                it.remove_last()


# ---------------------------------------------------------------------------
# Per-request state
# ---------------------------------------------------------------------------


class ClientRequest:
    """One candidate request (digest) for a (client, req_no).

    ``agreements`` is the node-id bitmask of ackers (bit i = node i
    acked).  While the request is the canonical entry of a _FastAcks
    mirror slot, the mask lives in the mirror's uint64 limb arrays and
    the property reads/writes through — one storage, no sync loops; when
    detached (mirror dropped, conflict, GC) the value materializes back
    into ``_agreements``."""

    __slots__ = (
        "ack",
        "_agreements",
        "_owner",
        "_slot",
        "garbage",
        "stored",
        "fetching",
        "ticks_fetching",
        "ticks_correct",
    )

    def __init__(self, ack: pb.RequestAck, agreements: int = 0):
        self.ack = ack
        self._agreements = agreements
        self._owner = None  # the owning _FastAcks while mirrored
        self._slot = 0
        self.garbage = False  # some request for this (client, req_no) committed
        self.stored = False  # persisted locally
        self.fetching = False
        self.ticks_fetching = 0
        self.ticks_correct = 0

    @property
    def agreements(self) -> int:
        owner = self._owner
        if owner is None:
            return self._agreements
        return owner.combine_agree(self._slot)

    @agreements.setter
    def agreements(self, value: int) -> None:
        owner = self._owner
        if owner is None:
            self._agreements = value
        else:
            owner.set_agree(self._slot, value)

    def fetch(self) -> Actions:
        if self.fetching:
            return Actions()
        self.fetching = True
        self.ticks_fetching = 0
        return Actions().send(
            mask_ids(self.agreements),
            pb.Msg(
                type=pb.FetchRequest(
                    client_id=self.ack.client_id,
                    req_no=self.ack.req_no,
                    digest=self.ack.digest,
                )
            ),
        )


class ClientReqNo:
    """ACK accumulation and correctness determination for one (client,
    req_no) (reference: client_tracker.go:711-1016; the doc comment there
    explains the null-request byzantine fallback)."""

    __slots__ = (
        "client_id",
        "req_no",
        "valid_after_seq_no",
        "network_config",
        "committed",
        "_non_null_voters",
        "_nn_owner",
        "_nn_slot",
        "requests",
        "weak_requests",
        "strong_requests",
        "my_requests",
        "acks_sent",
        "ticks_since_ack",
        "_weak_quorum",
        "_strong_quorum",
    )

    def __init__(
        self,
        client_id: int,
        req_no: int,
        valid_after_seq_no: int,
        network_config: pb.NetworkConfig | None = None,
        committed: int | None = None,
    ):
        self.client_id = client_id
        self.req_no = req_no
        self.valid_after_seq_no = valid_after_seq_no
        self.network_config = network_config
        self.committed = committed
        # Non-null-voter bitmask; like ClientRequest.agreements it lives in
        # the _FastAcks limb arrays while this req_no is a canonical
        # mirror slot and reads/writes through the property.
        self._nn_owner = None
        self._nn_slot = 0
        self.non_null_voters = 0  # bitmask over node id
        self.requests: dict[bytes, ClientRequest] = {}  # all observed
        self.weak_requests: dict[bytes, ClientRequest] = {}  # f+1 correct
        self.strong_requests: dict[bytes, ClientRequest] = {}  # 2f+1
        self.my_requests: dict[bytes, ClientRequest] = {}  # persisted locally
        self.acks_sent = 0
        self.ticks_since_ack = 0
        # Cached quorum thresholds: recomputing them per ack dominated the
        # ladder profile (the ack fan-in is the hottest path in the core).
        if network_config is not None:
            self._weak_quorum = some_correct_quorum(network_config)
            self._strong_quorum = intersection_quorum(network_config)
        else:
            # Set by reinitialize() before any ack can be applied.
            self._weak_quorum = self._strong_quorum = None

    @property
    def non_null_voters(self) -> int:
        owner = self._nn_owner
        if owner is None:
            return self._non_null_voters
        return owner.combine_nonnull(self._nn_slot)

    @non_null_voters.setter
    def non_null_voters(self, value: int) -> None:
        owner = self._nn_owner
        if owner is None:
            self._non_null_voters = value
        else:
            owner.set_nonnull(self._nn_slot, value)

    def reinitialize(self, network_config: pb.NetworkConfig) -> None:
        self.network_config = network_config
        self._weak_quorum = some_correct_quorum(network_config)
        self._strong_quorum = intersection_quorum(network_config)
        old_requests = self.requests
        self.non_null_voters = 0
        self.requests = {}
        self.weak_requests = {}
        self.strong_requests = {}
        self.my_requests = {}

        for digest in sorted(old_requests):
            old_req = old_requests[digest]
            for node_id in network_config.nodes:
                if old_req.agreements & (1 << node_id):
                    self.apply_request_ack(node_id, old_req.ack, force=True)
            if old_req.stored:
                new_req = self.client_req(old_req.ack)
                new_req.stored = True
                self.my_requests[digest] = new_req

    def client_req(self, ack: pb.RequestAck) -> ClientRequest:
        key = ack.digest or _NULL
        req = self.requests.get(key)
        if req is None:
            req = ClientRequest(ack=ack)
            self.requests[key] = req
        return req

    def apply_request_digest(
        self, ack: pb.RequestAck, data: bytes, out: Actions | None = None
    ) -> Actions:
        """Our own verified copy of the request (via Propose hash or a
        verified forward): persist it and ACK it to the network.  ``out``
        lets the hot result-processing loop accumulate into one Actions
        instead of allocating + concatenating one per request."""
        actions = out if out is not None else Actions()
        if ack.digest in self.my_requests:
            # Race between a forward and a local proposal; already persisted.
            return actions

        req = self.client_req(ack)
        req.stored = True
        self.my_requests[ack.digest] = req

        actions.store_request(
            pb.ForwardRequest(request_ack=ack, request_data=data)
        )

        if len(self.my_requests) == 1:
            self.acks_sent = 1
            self.ticks_since_ack = 0
            return actions.send(
                self.network_config.nodes, pb.Msg(type=ack)
            )

        # Multiple distinct requests persisted → advocate the null request.
        if _NULL in self.my_requests:
            return actions  # already advocating

        null_ack = pb.RequestAck(client_id=self.client_id, req_no=self.req_no)
        null_req = self.client_req(null_ack)
        null_req.stored = True
        self.my_requests[_NULL] = null_req
        self.acks_sent = 1
        self.ticks_since_ack = 0
        return actions.send(
            self.network_config.nodes, pb.Msg(type=null_ack)
        ).store_request(pb.ForwardRequest(request_ack=null_ack))

    def apply_request_ack(
        self, source: int, ack: pb.RequestAck, force: bool = False
    ) -> None:
        """Count one node's ACK.  A node gets one non-null vote ever (the
        spam guard from the design essay — the reference documents this but
        leaves its live path unguarded, client_tracker.go:379), except when
        ``force`` marks the digest known-correct (weak quorum during
        three-phase commit, or epoch change)."""
        requests = self.requests
        bit = 1 << source
        if ack.digest:
            key = ack.digest
            if not force and self.non_null_voters & bit:
                existing = requests.get(key)
                if existing is None or not existing.agreements & bit:
                    return  # second distinct non-null vote: ignored
            self.non_null_voters |= bit
        else:
            key = _NULL

        req = requests.get(key)
        if req is None:
            req = ClientRequest(ack=ack)
            requests[key] = req
        agreements = req.agreements | bit
        req.agreements = agreements

        count = agreements.bit_count()
        if count < self._weak_quorum:
            return
        self.weak_requests[key] = req
        if count < self._strong_quorum:
            return
        self.strong_requests[key] = req

    def tick(self) -> Actions:
        if self.committed is not None:
            # Hot path: every live reqNo of every client ticks every tick;
            # the shared empty saves ~1M allocations on ladder-scale runs.
            # Callers only concat tick results (never mutate them).
            return _EMPTY_ACTIONS
        if not self.my_requests and not self.weak_requests:
            # Acks below the weak quorum and nothing held locally: no
            # section of the tick logic can fire (rebroadcast requires
            # acks_sent > 0, which implies a held request).
            return _EMPTY_ACTIONS

        my = self.my_requests
        weak = self.weak_requests
        actions = None
        n_weak = len(weak)

        # 1. Conflicting correct requests and no commit → promote null.
        if n_weak > 1 and _NULL not in my:
            null_ack = pb.RequestAck(
                client_id=self.client_id, req_no=self.req_no
            )
            null_req = self.client_req(null_ack)
            null_req.stored = True
            my[_NULL] = null_req
            self.acks_sent = 1
            self.ticks_since_ack = 0
            actions = Actions().send(
                self.network_config.nodes, pb.Msg(type=null_ack)
            ).store_request(pb.ForwardRequest(request_ack=null_ack))

        # 2+3. Fetch machinery — only when some correct request is not
        # held locally or has a fetch in flight (in the steady state every
        # weak request is stored and this whole block is one scan).
        needs_fetch_scan = False
        for cr in weak.values():
            if (not cr.stored) or cr.fetching:
                needs_fetch_scan = True
                break
        if needs_fetch_scan:
            if actions is None:
                actions = Actions()
            # 2. Exactly one correct request we don't hold: fetch it after
            # a few ticks of patience.
            if n_weak == 1:
                (cr,) = weak.values()
                if not cr.stored and not cr.fetching:
                    if cr.ticks_correct <= _CORRECT_FETCH_TICKS:
                        cr.ticks_correct += 1
                    else:
                        actions.concat(cr.fetch())
            # 3. Refetch correct requests whose fetch timed out.
            to_fetch = []
            for cr in weak.values():
                if not cr.fetching:
                    continue
                if cr.ticks_fetching <= _FETCH_TIMEOUT_TICKS:
                    cr.ticks_fetching += 1
                    continue
                cr.fetching = False
                to_fetch.append(cr)
            to_fetch.sort(key=lambda cr: cr.ack.digest, reverse=True)
            for cr in to_fetch:
                actions.concat(cr.fetch())

        # 4. Rebroadcast our ACK with linear backoff.
        acks_sent = self.acks_sent
        if acks_sent == 0:
            return actions if actions is not None else _EMPTY_ACTIONS
        if self.ticks_since_ack != acks_sent * _ACK_RESEND_TICKS:
            self.ticks_since_ack += 1
            return actions if actions is not None else _EMPTY_ACTIONS

        n_my = len(my)
        if n_my > 1:
            ack = my[_NULL].ack
        elif n_my == 1:
            (only,) = my.values()
            ack = only.ack
        else:
            raise AssertionError("acks sent but no request held")

        self.acks_sent = acks_sent + 1
        self.ticks_since_ack = 0
        if actions is None:
            actions = Actions()
        actions.send(self.network_config.nodes, pb.Msg(type=ack))
        return actions


# ---------------------------------------------------------------------------
# Columnar ack fast path
# ---------------------------------------------------------------------------

# One-deep cache of the last frame's column decomposition, keyed by the
# msgs list object.  The engine delivers one coalesced frame to many
# receivers back to back; holding a strong reference to the list keeps the
# identity check sound.
_FRAME_COLS: list = [None, None]


def _frame_columns(msgs: list):
    """msgs -> (client_ids int64[n], req_nos int64[n], digest matrix
    uint8[n, 32], irregular row indices or None).  Rows whose digest is
    not 32 bytes (null acks) zero-fill the matrix and appear in
    ``irregular`` so the vector path routes them to the fallback."""
    cached = _FRAME_COLS
    if cached[0] is msgs:
        return cached[1]
    import numpy as np

    n = len(msgs)
    ids = np.empty(n, dtype=np.int64)
    rnos = np.empty(n, dtype=np.int64)
    digs = [None] * n
    irregular = None
    for i, msg in enumerate(msgs):
        ack = msg.type
        ids[i] = ack.client_id
        rnos[i] = ack.req_no
        d = ack.digest
        if len(d) != 32:
            d = b"\x00" * 32
            if irregular is None:
                irregular = []
            irregular.append(i)
        digs[i] = d
    dig_mat = np.frombuffer(b"".join(digs), dtype=np.uint8).reshape(n, 32)
    cols = (ids, rnos, dig_mat, irregular)
    cached[0] = msgs
    cached[1] = cols
    return cols


class _FastAcks:
    """Vectorized mirror of every client window's ack-certificate state.

    The ack fan-in is the hottest loop in the framework: every request
    draws one RequestAck from every node at every node — O(n^2)
    applications per request, arriving in coalesced frames of thousands.
    This mirror lets ``step_ack_many`` apply a whole frame as a handful
    of numpy ops (bitwise OR + popcount over uint64 masks, digest
    equality over a (slots, 32) byte matrix) instead of ~12 dict/attr
    operations per ack.

    Authority contract: the arrays are authoritative only INSIDE one
    ``step_ack_many`` call — every row it changes is written back to the
    owning ``ClientRequest``/``ClientReqNo`` objects before returning, so
    all other code keeps reading and mutating objects exactly as before.
    Paths that mutate ack state elsewhere refresh the touched slot
    (``refresh``) or drop the whole mirror (``ClientTracker._fast =
    None``; it lazily rebuilds).  Window-structure changes (checkpoint
    allocation, GC, reinitialize) drop it.

    Only configs whose node ids fit a uint64 mask (< 64) build a mirror;
    larger networks keep the plain loop.

    Per-slot flags: COMMITTED (drop acks early), SLOW (anything the
    vector path cannot express: missing slot, conflicting digests, a
    null request, or no canonical digest yet — those rows take the
    original per-ack path and the slot refreshes afterwards).
    """

    COMMITTED = 1
    SLOW = 2

    __slots__ = (
        "limbs",
        "cid0",
        "n_clients",
        "offset_arr",
        "base_arr",
        "low_arr",
        "high_arr",
        "nrm_arr",
        "clients",
        "client_of",
        "agree",
        "nonnull",
        "flags",
        "canon_mat",
        "canon_ok",
        "canon_req",
        "canon_crn",
        "tick_dirty",
        "tick_class",
        "tsa",
        "tgt",
        "canon_mat_dirty",
        "weak_q",
        "strong_q",
    )

    def __init__(self, tracker: "ClientTracker"):
        import numpy as np

        # uint64 limbs per node-id mask (limb i covers ids [64i, 64i+64)).
        self.limbs = tracker._mask_limbs
        clients = tracker.clients
        cids = sorted(clients)
        self.cid0 = cids[0]
        self.n_clients = cids[-1] - cids[0] + 1
        # Dense index over [cid0, cid_last]; ids outside or in gaps resolve
        # to a sentinel client slot with an empty window (rows fall back).
        self.offset_arr = np.zeros(self.n_clients + 1, dtype=np.int64)
        self.base_arr = np.zeros(self.n_clients + 1, dtype=np.int64)
        self.low_arr = np.zeros(self.n_clients + 1, dtype=np.int64)
        self.high_arr = np.full(self.n_clients + 1, -1, dtype=np.int64)
        self.nrm_arr = np.full(self.n_clients + 1, -1, dtype=np.int64)
        self.clients: list = [None] * (self.n_clients + 1)

        total = 0
        metas = []
        for cid in cids:
            client = clients[cid]
            ci = cid - self.cid0
            size = client.high_watermark - client.low_watermark + 1
            self.offset_arr[ci] = total
            self.base_arr[ci] = client.low_watermark
            self.low_arr[ci] = client.low_watermark
            self.high_arr[ci] = client.high_watermark
            self.nrm_arr[ci] = client.next_ready_mark
            self.clients[ci] = client
            metas.append((client, ci, total, size))
            total += size

        self.agree = np.zeros((total, self.limbs), dtype=np.uint64)
        self.nonnull = np.zeros((total, self.limbs), dtype=np.uint64)
        self.flags = np.zeros(total, dtype=np.uint8)
        self.canon_mat = np.zeros((total, 32), dtype=np.uint8)
        self.canon_ok = np.zeros(total, dtype=bool)
        self.canon_req: list = [None] * total
        self.canon_crn: list = [None] * total
        self.client_of = np.zeros(total, dtype=np.int64)
        # Slots whose ack activity has not yet been pushed into the owning
        # client's _tick_pending set (drained lazily at tick time — the
        # per-ack set.add was a measurable fraction of the old loop).
        self.tick_dirty = np.zeros(total, dtype=bool)
        # Vectorized tick state: INERT slots cannot fire, STEADY slots only
        # advance the rebroadcast backoff counter (held authoritatively in
        # ``tsa`` between syncs; ``crn.tick`` is its only reader and gets a
        # sync immediately before any call), PYTHON slots (fetch machinery
        # in motion, pending null promotion) take the per-slot path.
        self.tick_class = np.zeros(total, dtype=np.uint8)
        self.tsa = np.zeros(total, dtype=np.int64)
        self.tgt = np.zeros(total, dtype=np.int64)
        # Deferred canonical-digest rows: writing one 32-byte canon_mat row
        # per refresh costs ~1.2us in frombuffer+scatter; batching them into
        # one fancy-indexed write at the next vector read halves the
        # per-refresh cost on the hot store-request path.
        self.canon_mat_dirty: list = []

        nc = tracker.network_config
        self.weak_q = some_correct_quorum(nc)
        self.strong_q = intersection_quorum(nc)

        # Bulk build: gather per-slot values into Python lists and assign
        # each column once (per-element numpy scalar writes made the
        # per-slot _refresh_slot ~6x slower at build scale).
        agree_l = [0] * total
        nonnull_l = [0] * total
        flags_l = [0] * total
        dig_l = [b"\x00" * 32] * total
        ok_l = [False] * total
        tick_l = [0] * total
        tsa_l = [0] * total
        tgt_l = [0] * total
        attach_list = []
        canon_req = self.canon_req
        canon_crn = self.canon_crn
        for client, ci, offset, size in metas:
            base = client.low_watermark
            req_no_map = client.req_no_map
            self.client_of[offset : offset + size] = ci
            for i in range(size):
                slot = offset + i
                crn = req_no_map.get(base + i)
                if crn is None:
                    flags_l[slot] = self.SLOW
                    continue
                canon_crn[slot] = crn
                if crn.committed is not None:
                    flags_l[slot] = self.COMMITTED
                    continue
                requests = crn.requests
                if len(requests) == 1 and _NULL not in requests:
                    (digest,) = requests
                    req = requests[digest]
                    dig_l[slot] = digest
                    ok_l[slot] = True
                    canon_req[slot] = req
                    agree_l[slot] = req.agreements
                    nonnull_l[slot] = crn.non_null_voters
                    attach_list.append((slot, req, crn))
                else:
                    flags_l[slot] = self.SLOW
                tick_cls = self._classify_tick(crn)
                tick_l[slot] = tick_cls
                if tick_cls == self.TICK_STEADY:
                    tsa_l[slot] = crn.ticks_since_ack
                    tgt_l[slot] = crn.acks_sent * _ACK_RESEND_TICKS
        mask64 = (1 << 64) - 1
        for limb in range(self.limbs):
            shift = 64 * limb
            self.agree[:, limb] = [(v >> shift) & mask64 for v in agree_l]
            self.nonnull[:, limb] = [
                (v >> shift) & mask64 for v in nonnull_l
            ]
        self.flags[:] = flags_l
        self.canon_ok[:] = ok_l
        self.tick_class[:] = tick_l
        self.tsa[:] = tsa_l
        self.tgt[:] = tgt_l
        self.canon_mat[:] = np.frombuffer(
            b"".join(dig_l), dtype=np.uint8
        ).reshape(total, 32)
        # Attach canonical objects to their slots (arrays already seeded
        # by the column writes above): their mask properties now read and
        # write through this mirror.
        for slot, req, crn in attach_list:
            req._owner = self
            req._slot = slot
            crn._nn_owner = self
            crn._nn_slot = slot

    def combine_agree(self, slot: int) -> int:
        if self.limbs == 1:
            return int(self.agree[slot, 0])
        value = 0
        for limb in range(self.limbs - 1, -1, -1):
            value = (value << 64) | int(self.agree[slot, limb])
        return value

    def set_agree(self, slot: int, value: int) -> None:
        if self.limbs == 1:
            self.agree[slot, 0] = value
            return
        mask64 = (1 << 64) - 1
        for limb in range(self.limbs):
            self.agree[slot, limb] = (value >> (64 * limb)) & mask64

    def combine_nonnull(self, slot: int) -> int:
        if self.limbs == 1:
            return int(self.nonnull[slot, 0])
        value = 0
        for limb in range(self.limbs - 1, -1, -1):
            value = (value << 64) | int(self.nonnull[slot, limb])
        return value

    def set_nonnull(self, slot: int, value: int) -> None:
        if self.limbs == 1:
            self.nonnull[slot, 0] = value
            return
        mask64 = (1 << 64) - 1
        for limb in range(self.limbs):
            self.nonnull[slot, limb] = (value >> (64 * limb)) & mask64

    def _attach(self, slot: int, req, crn) -> None:
        """Make this mirror slot the storage for the canonical request's
        agreements and the crn's non-null-voter mask (the properties on
        those objects read/write through while attached)."""
        if req._owner is not self or req._slot != slot:
            value = req._agreements if req._owner is None else req.agreements
            req._owner = self
            req._slot = slot
            self.set_agree(slot, value)
        if crn._nn_owner is not self or crn._nn_slot != slot:
            value = (
                crn._non_null_voters
                if crn._nn_owner is None
                else crn.non_null_voters
            )
            crn._nn_owner = self
            crn._nn_slot = slot
            self.set_nonnull(slot, value)

    def _detach(self, slot: int) -> None:
        req = self.canon_req[slot]
        if req is not None and req._owner is self and req._slot == slot:
            req._agreements = self.combine_agree(slot)
            req._owner = None
        crn = self.canon_crn[slot]
        if (
            crn is not None
            and crn._nn_owner is self
            and crn._nn_slot == slot
        ):
            crn._non_null_voters = self.combine_nonnull(slot)
            crn._nn_owner = None

    def detach_all(self) -> None:
        """Materialize every attached mask back into its object (before
        the mirror is dropped or rebuilt)."""
        for slot in range(len(self.canon_req)):
            self._detach(slot)

    def drain_tick_dirty(self) -> None:
        """Push deferred ack activity into the clients' _tick_pending sets
        (must run before any tick iteration and before the mirror drops)."""
        import numpy as np

        idx = np.flatnonzero(self.tick_dirty)
        if not len(idx):
            return
        self.tick_dirty[idx] = False
        clients = self.clients
        offset_arr = self.offset_arr
        base_arr = self.base_arr
        client_of = self.client_of
        for slot in idx.tolist():
            ci = client_of[slot]
            clients[ci]._tick_pending.add(
                int(base_arr[ci]) + slot - int(offset_arr[ci])
            )

    def slot_of(self, client_id: int, req_no: int) -> int | None:
        ci = client_id - self.cid0
        if not (0 <= ci < self.n_clients):
            return None
        if not (self.low_arr[ci] <= req_no <= self.high_arr[ci]):
            return None
        return int(self.offset_arr[ci]) + req_no - int(self.base_arr[ci])

    # Tick classes (see the tick_class array comment above).
    TICK_INERT = 0
    TICK_STEADY = 1
    TICK_PYTHON = 2

    def refresh(
        self, client_id: int, req_no: int, tick_obj_authoritative: bool = False
    ) -> None:
        """Re-derive one slot's mirror from the authoritative objects.

        ``tick_obj_authoritative``: the caller just mutated the crn's tick
        counters (ticks_since_ack/acks_sent), so skip the array→object
        writeback that normally preserves a STEADY slot's advanced backoff
        counter."""
        slot = self.slot_of(client_id, req_no)
        if slot is None:
            return
        ci = client_id - self.cid0
        client = self.clients[ci]
        self._refresh_slot(
            slot,
            client.req_no_map.get(req_no),
            tick_obj_authoritative=tick_obj_authoritative,
        )

    def _refresh_slot(
        self,
        slot: int,
        crn: "ClientReqNo | None",
        tick_obj_authoritative: bool = False,
    ) -> None:
        # For STEADY slots the backoff counter lives in the array between
        # syncs; push it back before re-deriving from the object (unless
        # the caller just wrote a newer value there).
        if (
            not tick_obj_authoritative
            and self.tick_class[slot] == self.TICK_STEADY
        ):
            old_crn = self.canon_crn[slot]
            if old_crn is not None:
                old_crn.ticks_since_ack = int(self.tsa[slot])

        if crn is None:
            self._detach(slot)
            self.flags[slot] = self.SLOW
            self.canon_crn[slot] = None
            self.canon_req[slot] = None
            self.canon_ok[slot] = False
            self.tick_class[slot] = self.TICK_INERT
            return
        requests = crn.requests
        canonical = (
            crn.committed is None
            and len(requests) == 1
            and _NULL not in requests
        )
        if canonical:
            (digest,) = requests
            req = requests[digest]
            old_req = self.canon_req[slot]
            if old_req is not None and old_req is not req:
                self._detach(slot)
            self.canon_crn[slot] = crn
            self.canon_mat_dirty.append((slot, digest))
            self.canon_ok[slot] = True
            self.canon_req[slot] = req
            # The slot becomes (or stays) the live storage for the masks;
            # the objects' properties read/write through it.
            self._attach(slot, req, crn)
            self.flags[slot] = 0
        else:
            # Committed, no votes yet (first ack adopts its digest via the
            # per-row fallback, which then refreshes this slot), or
            # conflicting digests / a null request in play: masks move
            # back to the objects.
            self._detach(slot)
            self.canon_crn[slot] = crn
            self.canon_ok[slot] = False
            self.canon_req[slot] = None
            if crn.committed is not None:
                self.flags[slot] = self.COMMITTED
                self.tick_class[slot] = self.TICK_INERT
                return
            self.flags[slot] = self.SLOW
        self.tick_class[slot] = self._classify_tick(crn)
        if self.tick_class[slot] == self.TICK_STEADY:
            self.tsa[slot] = crn.ticks_since_ack
            self.tgt[slot] = crn.acks_sent * _ACK_RESEND_TICKS

    def flush_canon_rows(self) -> None:
        """Apply deferred canonical-digest rows (one batched write)."""
        dirty = self.canon_mat_dirty
        if not dirty:
            return
        import numpy as np

        self.canon_mat_dirty = []
        slots = np.fromiter(
            (s for s, _d in dirty), dtype=np.int64, count=len(dirty)
        )
        rows = np.frombuffer(
            b"".join(d for _s, d in dirty), dtype=np.uint8
        ).reshape(len(dirty), 32)
        # Later entries for the same slot win (list order == apply order).
        self.canon_mat[slots] = rows

    def _classify_tick(self, crn: "ClientReqNo") -> int:
        """Mirror of ClientReqNo.tick's control flow (that method stays the
        semantic reference): which slots can the vectorized tick skip or
        batch-advance?"""
        my = crn.my_requests
        weak = crn.weak_requests
        if not my and not weak:
            return self.TICK_INERT
        if len(weak) > 1 and _NULL not in my:
            return self.TICK_PYTHON  # null promotion pending
        for cr in weak.values():
            if (not cr.stored) or cr.fetching:
                return self.TICK_PYTHON  # fetch machinery in motion
        if crn.acks_sent == 0:
            return self.TICK_INERT  # nothing held: rebroadcast gate closed
        return self.TICK_STEADY

    def writeback_tick(self) -> None:
        """Sync every STEADY slot's array-held backoff counter back to its
        crn (before the mirror drops or the python tick path runs)."""
        import numpy as np

        idx = np.flatnonzero(self.tick_class == self.TICK_STEADY)
        canon_crn = self.canon_crn
        tsa = self.tsa
        for s in idx.tolist():
            crn = canon_crn[s]
            if crn is not None:
                crn.ticks_since_ack = int(tsa[s])

    def mark_committed(self, client_id: int, req_no: int) -> None:
        slot = self.slot_of(client_id, req_no)
        if slot is not None:
            self.flags[slot] = self.COMMITTED
            self.tick_class[slot] = self.TICK_INERT


# ---------------------------------------------------------------------------
# Per-client window
# ---------------------------------------------------------------------------


@dataclass
class ClientWaiter:
    """Watermark snapshot the runtime uses to backpressure proposers; a new
    waiter is issued whenever the window moves and the old one is marked
    expired (the runtime layer maps this onto real synchronization)."""

    low_watermark: int
    high_watermark: int
    expired: bool = False


class Client:
    __slots__ = (
        "logger",
        "client_state",
        "network_config",
        "low_watermark",
        "high_watermark",
        "next_ready_mark",
        "req_no_map",
        "client_waiter",
        "_tick_pending",
    )

    def __init__(self, logger=None):
        self.logger = logger
        self.client_state: pb.NetworkClient | None = None
        self.network_config: pb.NetworkConfig | None = None
        self.low_watermark = 0
        self.high_watermark = 0
        self.next_ready_mark = 0
        self.req_no_map: dict[int, ClientReqNo] = {}
        self.client_waiter: ClientWaiter | None = None
        # req_nos with tick-relevant activity (acks observed or a local
        # copy held).  Untouched window slots — the vast majority at any
        # instant — are skipped by tick() entirely; entries are discarded
        # lazily once committed or garbage collected.
        self._tick_pending: set = set()

    def req_nos(self):
        """All live ClientReqNos in req_no order."""
        return [
            self.req_no_map[r]
            for r in range(self.low_watermark, self.high_watermark + 1)
            if r in self.req_no_map
        ]

    def reinitialize(
        self,
        network_config: pb.NetworkConfig,
        low_seq_no: int,
        high_seq_no: int,
        low_state: pb.NetworkClient,
        high_state: pb.NetworkClient,
    ) -> None:
        """Rebuild the window from the low/high CEntry pair: [low_state's
        watermark, +width], marking req_nos the high state knows committed
        (below its watermark or set in its committed mask), and gating the
        tail of the window (width consumed last checkpoint) on the next
        checkpoint (reference: client_tracker.go:1081-1144)."""
        low_watermark = low_state.low_watermark
        width = low_state.width

        old_map = self.req_no_map
        self.client_state = high_state
        self.network_config = network_config
        self.low_watermark = low_watermark
        self.high_watermark = low_watermark + width
        self.next_ready_mark = low_watermark
        self.req_no_map = {}
        if self.client_waiter is not None:
            self.client_waiter.expired = True
        self.client_waiter = ClientWaiter(
            low_watermark=self.low_watermark,
            high_watermark=self.high_watermark,
        )

        for i in range(width + 1):
            req_no = low_watermark + i

            committed = None
            # Fix vs reference (see module docstring): the high state's mask
            # is indexed relative to the high state's own low watermark.
            mask_idx = req_no - high_state.low_watermark
            if req_no < high_state.low_watermark or (
                mask_idx >= 0
                and bit_is_set(high_state.committed_mask, mask_idx)
            ):
                committed = high_seq_no  # conservatively GC-able later

            if i <= width - low_state.width_consumed_last_checkpoint:
                valid_after = low_seq_no
            else:
                valid_after = low_seq_no + network_config.checkpoint_interval

            crn = old_map.get(req_no)
            if crn is not None:
                crn.committed = committed
            else:
                crn = ClientReqNo(
                    client_id=low_state.id,
                    req_no=req_no,
                    valid_after_seq_no=valid_after,
                    committed=committed,
                )
            crn.reinitialize(network_config)
            self.req_no_map[req_no] = crn

        self._tick_pending = {
            req_no
            for req_no, crn in self.req_no_map.items()
            if crn.committed is None
            and (crn.my_requests or crn.weak_requests or crn.requests)
        }

    def allocate(self, starting_at_seq_no: int, state: pb.NetworkClient) -> None:
        """Extend the window at a checkpoint boundary; the newly usable tail
        only becomes proposable after the *next* checkpoint (reference:
        client_tracker.go:1146-1175).  Allocation starts from our current
        high watermark rather than the reference's intermediate-watermark
        arithmetic: equivalent in the partial-commit case, and it also
        re-extends a *fully* consumed window (where the reference stalls —
        its all-committed branch at client_tracker.go:507-517 never
        allocates, and its own assert would reject the state if it did)."""
        new_high = state.low_watermark + state.width
        if new_high < self.high_watermark:
            raise AssertionError(
                f"window must not shrink: new high {new_high} < current "
                f"high {self.high_watermark}"
            )

        for req_no in range(self.high_watermark + 1, new_high + 1):
            crn = ClientReqNo(
                client_id=state.id,
                req_no=req_no,
                valid_after_seq_no=starting_at_seq_no
                + self.network_config.checkpoint_interval,
                network_config=self.network_config,
            )
            self.req_no_map[req_no] = crn

        self.high_watermark = new_high
        self.client_waiter.expired = True
        self.client_waiter = ClientWaiter(
            low_watermark=self.low_watermark,
            high_watermark=self.high_watermark,
        )

    def move_low_watermark(self, max_seq_no: int) -> None:
        for req_no in range(self.low_watermark, self.high_watermark + 1):
            crn = self.req_no_map.get(req_no)
            if crn is None:
                continue
            if crn.committed is None or crn.committed > max_seq_no:
                break
            if crn.req_no >= self.next_ready_mark:
                # A request can commit without us ever marking it ready
                # (it was correct elsewhere); move the mark *past* it — it is
                # being garbage collected and can never become ready.  (The
                # reference sets the mark to req_no itself,
                # client_tracker.go:1187-1191, which strands the ready path
                # one slot behind and trips advanceReady's missing-req
                # assert after this entry is deleted.)
                self.next_ready_mark = crn.req_no + 1
            for cr in crn.requests.values():
                cr.garbage = True
            del self.req_no_map[req_no]
        self.low_watermark = min(self.req_no_map) if self.req_no_map else (
            self.high_watermark + 1
        )

    def ack(self, source: int, ack: pb.RequestAck, force: bool = False):
        """``force`` marks the digest known-correct (epoch-change batch
        selection), bypassing the one-non-null-vote spam guard."""
        crn = self.req_no_map.get(ack.req_no)
        if crn is None:
            raise AssertionError(
                f"client {ack.client_id}: ack for req_no {ack.req_no} outside "
                f"window [{self.low_watermark}, {self.high_watermark}]"
            )
        key = ack.digest or _NULL
        was_weak = key in crn.weak_requests
        crn.apply_request_ack(source, ack, force=force)
        newly_correct = not was_weak and key in crn.weak_requests
        self._tick_pending.add(ack.req_no)
        return crn.requests.get(key), crn, newly_correct

    def in_watermarks(self, req_no: int) -> bool:
        return self.low_watermark <= req_no <= self.high_watermark

    def req_no(self, req_no: int) -> ClientReqNo:
        crn = self.req_no_map.get(req_no)
        if crn is None:
            raise AssertionError(f"req_no {req_no} not tracked")
        return crn

    def tick(self) -> Actions:
        if not self._tick_pending:
            return _EMPTY_ACTIONS
        actions = None
        done = None
        for req_no in sorted(self._tick_pending):
            crn = self.req_no_map.get(req_no)
            if crn is None or crn.committed is not None:
                if done is None:
                    done = []
                done.append(req_no)
                continue
            crn_actions = crn.tick()
            if crn_actions is not _EMPTY_ACTIONS:
                if actions is None:
                    actions = crn_actions
                else:
                    actions.concat(crn_actions)
        if done is not None:
            self._tick_pending.difference_update(done)
        return actions if actions is not None else _EMPTY_ACTIONS


# ---------------------------------------------------------------------------
# The tracker
# ---------------------------------------------------------------------------


class ClientTracker:
    def __init__(
        self,
        persisted: Persisted,
        node_buffers: NodeBuffers,
        my_config: pb.InitialParameters,
        logger=None,
        ack_plane: str | None = None,
        ack_flush_rows: int | None = None,
        ack_device="cuda",
    ):
        self.persisted = persisted
        self.node_buffers = node_buffers
        self.my_config = my_config
        self.logger = logger

        self.clients: dict[int, Client] = {}
        self.client_states: list = []
        self.network_config: pb.NetworkConfig | None = None
        self.msg_buffers: dict[int, MsgBuffer] = {}
        self.ready_list = ReadyList()
        self.available_list = AvailableList()
        # Columnar ack mirror (see _FastAcks), built lazily by
        # step_ack_many when the config supports it.
        self._fast: _FastAcks | None = None
        self._fast_ok = False
        self._mask_limbs = 1
        # Device-resident ack plane (core.device_tracker): selected via
        # Config.ack_plane / the MIRBFT_ACK_PLANE env knob, on the card
        # ack_device names, built lazily by step_ack_many like the host
        # mirror, dropped on any window-structure change.  It never falls
        # back to the host plane: a plane that cannot be built raises, and
        # a plane on a card that is not there raises here, at once.
        from .device_tracker import (
            require_device,
            resolve_ack_plane,
            resolve_flush_rows,
        )

        self._ack_plane = resolve_ack_plane(ack_plane)
        self._ack_device = ack_device
        if self._ack_plane == "device":
            require_device(ack_device)
        # Device-plane frame coalescing (Config.ack_flush_rows /
        # MIRBFT_ACK_FLUSH_ROWS): steps defer until this many ack rows are
        # queued; 1 keeps the flush-per-frame default.
        self._ack_flush_rows = resolve_flush_rows(ack_flush_rows)
        self._device = None
        self._device_ok = False

    def _drop_device(self) -> None:
        """Materialize the device ack plane back into the objects and
        discard it (window-structure changes invalidate its dense shapes,
        exactly like the host mirror)."""
        if self._device is not None:
            dev, self._device = self._device, None
            dev.drop(self)

    def _build_device(self):
        """Build the device plane.  A failure (no card for
        ``ack_device="cuda"``, a kernel that does not build) raises: the
        tracker does not carry on with the host plane in its place."""
        from .device_tracker import DeviceClientPlane

        self._device = DeviceClientPlane(self, device=self._ack_device)
        return self._device

    def _drop_fast(self) -> None:
        """Invalidate the columnar mirror (draining deferred tick activity
        and syncing array-held backoff counters first so no rebroadcast/
        fetch bookkeeping is lost)."""
        if self._fast is not None:
            self._fast.drain_tick_dirty()
            self._fast.writeback_tick()
            self._fast.detach_all()
            self._fast = None

    # -- lifecycle -----------------------------------------------------------

    def reinitialize(self) -> None:
        self._drop_device()
        self._drop_fast()
        low_c = high_c = None

        def on_c(c_entry):
            nonlocal low_c, high_c
            if low_c is None:
                low_c = c_entry
            high_c = c_entry

        self.persisted.iterate({pb.CEntry: on_c})
        if low_c is None:
            raise AssertionError("log must contain a checkpoint")

        latest_states = {cs.id: cs for cs in high_c.network_state.clients}

        self.network_config = low_c.network_state.config
        self.available_list = AvailableList()
        self.ready_list = ReadyList()

        old_clients = self.clients
        self.clients = {}
        self.client_states = high_c.network_state.clients
        for client_state in self.client_states:
            client = old_clients.get(client_state.id) or Client(self.logger)
            self.clients[client_state.id] = client
            client.reinitialize(
                low_c.network_state.config,
                low_c.seq_no,
                high_c.seq_no,
                client_state,
                latest_states[client_state.id],
            )
            # Re-seed the fresh available list: correct (weak-quorum)
            # requests whose data we hold survived the reinitialize inside
            # the window but their list membership did not — without this,
            # sequences referencing requests disseminated *before* a
            # reconfiguration or state transfer can never match their
            # outstanding requests, and every post-reinitialize epoch
            # starves into suspicion.
            for req_no in range(
                client.low_watermark, client.high_watermark + 1
            ):
                crn = client.req_no_map.get(req_no)
                if crn is None or crn.committed is not None:
                    continue
                for digest in sorted(crn.weak_requests):
                    cr = crn.weak_requests[digest]
                    if cr.stored and not cr.garbage:
                        self.available_list.push_back(cr)
            self.advance_ready(client)

        old_buffers = self.msg_buffers
        self.msg_buffers = {}
        for node_id in low_c.network_state.config.nodes:
            buffer = old_buffers.get(node_id)
            if buffer is None:
                buffer = MsgBuffer(
                    "clients", self.node_buffers.node_buffer(node_id)
                )
            self.msg_buffers[node_id] = buffer

        # The vector ack path splits node-id masks into uint64 limbs
        # (one frame only ever touches its source's limb) and needs a
        # dense-ish client id range (the mirror indexes [cid0, cid_last]).
        nodes = self.network_config.nodes
        cids = [cs.id for cs in self.client_states]
        self._mask_limbs = ((max(nodes) >> 6) + 1) if nodes else 1
        self._fast_ok = bool(
            nodes
            and self._mask_limbs <= 8  # up to 512-node ids
            and cids
            and (max(cids) - min(cids) + 1) <= 4 * len(cids) + 1024
        )
        # The device plane shares the mirror's preconditions (dense-ish
        # ids, bounded node masks).  Its device was checked at
        # construction: where the JAX package probed here and stayed on
        # the host path, the port has already raised.
        self._device_ok = self._ack_plane == "device" and self._fast_ok

    def tick(self) -> Actions:
        dev = self._device
        if dev is not None:
            # Tick boundary: run the step over any coalesced frames and
            # drain the buffered boundary events: the scalar tick logic
            # below reads _tick_pending and object-side ack state, both of
            # which deferred flushing leaves behind.
            dev.flush(drain=self)
            # The scalar tick logic reads and mutates object-side ack
            # state (fetch targeting over agreements, rebroadcast
            # counters): hand every pending slot back to the objects
            # before it runs.
            for client_state in self.client_states:
                client = self.clients[client_state.id]
                for req_no in client._tick_pending:
                    dev.sync_slot(client_state.id, req_no)
        fast = self._fast
        if fast is not None:
            fast.drain_tick_dirty()
            return self._tick_vector(fast)
        actions = Actions()
        for client_state in self.client_states:
            actions.concat(self.clients[client_state.id].tick())
        return actions

    def _tick_vector(self, fast: "_FastAcks") -> Actions:
        """Vectorized tick sweep over the mirror: INERT slots skip, quiet
        STEADY slots advance their backoff counter in one array op, and
        only firing/PYTHON slots run ClientReqNo.tick (the semantic
        reference for all of this)."""
        import numpy as np

        steady = fast.tick_class == _FastAcks.TICK_STEADY
        fire = steady & (fast.tsa == fast.tgt)
        quiet = steady & ~fire
        fast.tsa[quiet] += 1

        todo = np.flatnonzero(
            fire | (fast.tick_class == _FastAcks.TICK_PYTHON)
        )
        if not len(todo):
            return _EMPTY_ACTIONS
        actions = None
        canon_crn = fast.canon_crn
        for s in todo.tolist():
            crn = canon_crn[s]
            if crn is None:
                continue
            if fire[s]:
                # The array held the authoritative backoff counter; sync it
                # so crn.tick sees the fire condition.
                crn.ticks_since_ack = int(fast.tsa[s])
            crn_actions = crn.tick()
            # crn.tick mutated its own counters (fire reset, fetch
            # progress, possibly a null promotion): re-derive the slot.
            fast._refresh_slot(s, crn, tick_obj_authoritative=True)
            if crn_actions is not _EMPTY_ACTIONS:
                if actions is None:
                    actions = crn_actions
                else:
                    actions.concat(crn_actions)
        return actions if actions is not None else _EMPTY_ACTIONS

    # -- message handling ----------------------------------------------------

    def filter(self, _source: int, msg: pb.Msg) -> Applyable:
        inner = msg.type
        cls = inner.__class__  # exact types only: pb classes have no subclasses
        if cls is pb.RequestAck:
            ack = inner
        elif cls is pb.ForwardRequest:
            ack = inner.request_ack
        elif cls is pb.FetchRequest:
            return Applyable.CURRENT
        else:
            raise AssertionError(
                f"unexpected client message {type(inner).__name__}"
            )
        client = self.clients.get(ack.client_id)
        if client is None:
            return Applyable.FUTURE  # client may appear via reconfiguration
        if client.low_watermark > ack.req_no:
            return Applyable.PAST
        if client.high_watermark < ack.req_no:
            return Applyable.FUTURE
        return Applyable.CURRENT

    def step_ack(self, source: int, msg: pb.Msg) -> Actions:
        """Fast path for RequestAck — the dominant message at ladder scale
        (n^2 per request).  Equivalent to step() with the filter/apply_msg/
        ack/Client.ack chain flattened into one frame; ``ack()`` below stays
        the semantic reference for this logic."""
        ack = msg.type
        client = self.clients.get(ack.client_id)
        if client is None:
            # Client may appear via reconfiguration: buffer as FUTURE.
            self.msg_buffers[source].store(msg)
            return _EMPTY_ACTIONS
        req_no = ack.req_no
        if req_no < client.low_watermark:
            return _EMPTY_ACTIONS
        if req_no > client.high_watermark:
            self.msg_buffers[source].store(msg)
            return _EMPTY_ACTIONS
        crn = client.req_no_map.get(req_no)
        if crn is None:
            raise AssertionError(
                f"client {ack.client_id}: req_no {req_no} missing inside "
                f"window [{client.low_watermark}, {client.high_watermark}]"
            )
        if crn.committed is not None:
            # Same late-ack drop as step_ack_many: the two delivery paths
            # must agree so node state never depends on transport framing.
            return _EMPTY_ACTIONS
        if self._device is not None:
            # Scalar mutation ahead: pull the device-authoritative masks
            # into the objects first (the slot stays host-authoritative
            # until the next device flush re-derives it).
            self._device.sync_slot(ack.client_id, req_no)
        key = ack.digest or _NULL
        weak = crn.weak_requests
        was_weak = key in weak
        crn.apply_request_ack(source, ack)
        client._tick_pending.add(req_no)
        if not was_weak and key in weak:
            self.available_list.push_back(crn.requests.get(key))
        if req_no == client.next_ready_mark and crn.strong_requests:
            self.check_ready(client, crn)
        if self._fast is not None:
            self._fast.refresh(ack.client_id, req_no)
        return _EMPTY_ACTIONS

    def step_ack_many(self, source: int, msgs: list) -> None:
        """Bulk form of step_ack for one inbound frame: identical semantics,
        per-frame rather than per-msg frame setup.  ``msgs`` must all carry
        RequestAck payloads.

        Large frames on vector-capable configs take the columnar path:
        the whole frame becomes numpy column arrays (cached on the frame,
        so the other receivers of the same coalesced delivery reuse them)
        and applies as bitwise OR + popcount over the _FastAcks mirror.
        Rows the mirror cannot express — unknown clients, out-of-window,
        null acks, conflicting digests, first vote for a slot — fall back
        to step_ack per row (note the fallback rows apply AFTER the
        vectorized rows rather than in strict frame-interleaved order;
        both orders are deterministic, and inter-row order within one
        frame was never a protocol guarantee)."""
        dev = self._device
        if dev is None and self._device_ok:
            dev = self._build_device()
        if dev is not None:
            # Device-resident plane: every frame (any size) goes through
            # the step; the scalar loop would mutate objects whose masks
            # are device-authoritative.  The plane emits its own
            # {plane="device"} ack metrics at flush.
            dev.apply_frame(self, source, msgs)
        elif len(msgs) >= 32 and self._fast_ok:
            fast = self._fast
            if fast is None:
                fast = self._fast = _FastAcks(self)
            self._step_ack_vector(source, msgs, fast)
        else:
            self._step_ack_loop(source, msgs)
        if dev is None and hooks.enabled:
            hooks.record_ack_batch("host", len(msgs))
        # Divergence oracle (obsv.shadow): every Nth frame replays the
        # scalar rules against the mirror for the slots this frame touched.
        sh = hooks.shadow
        if sh is not None:
            sh.on_frame(self, msgs)

    def _step_ack_vector(
        self, source: int, msgs: list, fast: "_FastAcks"
    ) -> None:
        import numpy as np

        fast.flush_canon_rows()
        ids, rnos, dig_mat, irregular = _frame_columns(msgs)
        n = len(msgs)

        ci = ids - fast.cid0
        known = (ci >= 0) & (ci < fast.n_clients)
        cis = np.where(known, ci, fast.n_clients)  # sentinel: empty window
        in_win = (rnos >= fast.low_arr[cis]) & (rnos <= fast.high_arr[cis])
        slot = np.where(
            in_win, fast.offset_arr[cis] + rnos - fast.base_arr[cis], 0
        )
        fl = fast.flags[slot]
        live = in_win & (fl == 0)
        canon_match = fast.canon_ok[slot] & (
            fast.canon_mat[slot] == dig_mat
        ).all(axis=1)
        vec = live & canon_match
        if irregular is not None:
            vec[irregular] = False

        # Late acks for committed slots drop outright (same early-out as
        # the loop); everything else the mirror cannot express — buffering,
        # conflicts, canonical adoption — takes the original per-ack path
        # after the vectorized rows, with a slot refresh each.
        fb_rows = np.flatnonzero(
            ~vec & ~(in_win & (fl == _FastAcks.COMMITTED))
        )

        vrows = np.flatnonzero(vec)
        if len(vrows):
            # One frame carries one source, so only that source's mask
            # limb is touched — the hot path stays single-limb at any
            # network size.
            limb = source >> 6
            bit = np.uint64(1 << (source & 63))
            vslot = slot[vrows]
            old = fast.agree[vslot, limb]
            nn = fast.nonnull[vslot, limb]
            dup = (old & bit) != np.uint64(0)
            # A voter whose non-null vote went to a different digest gets
            # no second vote (the spam guard).
            foreign = ((nn & bit) != np.uint64(0)) & ~dup
            apply_m = ~foreign
            new = old | bit
            nn_new = nn | bit
            ap = np.flatnonzero(apply_m)
            ap_slots = vslot[ap]
            # Duplicate slots within one frame all OR the same source bit,
            # so last-write-wins scatter is exact.
            fast.agree[ap_slots, limb] = new[ap]
            fast.nonnull[ap_slots, limb] = nn_new[ap]
            fast.tick_dirty[ap_slots] = True

            if fast.limbs == 1:
                counts = np.bitwise_count(new)
            else:
                # Full-row popcount (post-scatter: duplicate slots carry
                # identical final values).
                counts = np.bitwise_count(fast.agree[vslot]).sum(
                    axis=1, dtype=np.int64
                )
            # No object writeback: the canonical request/crn masks READ
            # AND WRITE through the mirror arrays while attached (see
            # ClientRequest.agreements / ClientReqNo.non_null_voters).
            changed = apply_m & ~dup
            canon_req = fast.canon_req
            canon_crn = fast.canon_crn

            # Quorum crossings (one bit per frame per slot: equality is
            # exact).  Rare relative to acks — plain Python per crossing.
            weak_cross = np.flatnonzero(changed & (counts == fast.weak_q))
            if len(weak_cross):
                available_push = self.available_list.push_back
                for j in weak_cross.tolist():
                    s = int(vslot[j])
                    req = canon_req[s]
                    crn = canon_crn[s]
                    # A duplicate ack in the same frame reads the same
                    # pre-scatter state and lands here twice; the dict
                    # membership check keeps the available push single
                    # (the loop path's was_weak guard).
                    if req.ack.digest in crn.weak_requests:
                        continue
                    crn.weak_requests[req.ack.digest] = req
                    available_push(req)
                    # Weak membership feeds the tick classification (an
                    # unstored newly-weak request needs fetch ticks); the
                    # canonical mirror state is untouched by the crossing,
                    # so only the tick class is re-derived.
                    old_cls = fast.tick_class[s]
                    new_cls = fast._classify_tick(crn)
                    if new_cls != old_cls:
                        if old_cls == _FastAcks.TICK_STEADY:
                            crn.ticks_since_ack = int(fast.tsa[s])
                        fast.tick_class[s] = new_cls
                        if new_cls == _FastAcks.TICK_STEADY:
                            fast.tsa[s] = crn.ticks_since_ack
                            fast.tgt[s] = (
                                crn.acks_sent * _ACK_RESEND_TICKS
                            )
            strong_cross = np.flatnonzero(changed & (counts == fast.strong_q))
            if len(strong_cross):
                for j in strong_cross.tolist():
                    s = int(vslot[j])
                    req = canon_req[s]
                    crn = canon_crn[s]
                    crn.strong_requests[req.ack.digest] = req

            # Ready-mark checks: applied rows sitting exactly at their
            # client's next_ready_mark (advance_ready self-advances, so one
            # call per hit is enough; nrm_arr is synced by advance_ready).
            cand = np.flatnonzero(
                apply_m & (rnos[vrows] == fast.nrm_arr[cis[vrows]])
            )
            for j in cand.tolist():
                s = int(vslot[j])
                crn = canon_crn[s]
                if crn.strong_requests:
                    self.check_ready(fast.clients[int(cis[vrows[j]])], crn)

        if len(fb_rows):
            step_ack = self.step_ack
            for r in fb_rows.tolist():
                step_ack(source, msgs[r])  # refreshes the mirror itself

    def _step_ack_loop(self, source: int, msgs: list) -> None:
        """The reference per-ack path (also the semantic spec for the
        vectorized form above)."""
        clients_get = self.clients.get
        available_push = self.available_list.push_back
        bit = 1 << source
        fast = self._fast
        for msg in msgs:
            ack = msg.type
            client = clients_get(ack.client_id)
            if client is None:
                self.msg_buffers[source].store(msg)
                continue
            req_no = ack.req_no
            if req_no < client.low_watermark:
                continue
            if req_no > client.high_watermark:
                self.msg_buffers[source].store(msg)
                continue
            crn = client.req_no_map.get(req_no)
            if crn is None:
                raise AssertionError(
                    f"client {ack.client_id}: req_no {req_no} missing inside "
                    f"window [{client.low_watermark}, "
                    f"{client.high_watermark}]"
                )
            if crn.committed is not None:
                # Late ack for an already-committed req_no: its vote can no
                # longer influence anything (the request ordered; fetches
                # and null promotion are moot).  Dropping it here skips the
                # accounting the slow path would still perform.
                continue
            # Inlined ClientReqNo.apply_request_ack (force=False) — that
            # method stays the semantic reference for this logic.
            digest = ack.digest
            requests = crn.requests
            if digest:
                key = digest
                if crn.non_null_voters & bit:
                    existing = requests.get(key)
                    if existing is None or not existing.agreements & bit:
                        continue  # second distinct non-null vote: ignored
                else:
                    crn.non_null_voters |= bit
            else:
                key = _NULL
            weak = crn.weak_requests
            was_weak = key in weak
            req = requests.get(key)
            if req is None:
                req = ClientRequest(ack=ack)
                requests[key] = req
            agreements = req.agreements | bit
            req.agreements = agreements
            count = agreements.bit_count()
            if count >= crn._weak_quorum:
                weak[key] = req
                if count >= crn._strong_quorum:
                    crn.strong_requests[key] = req
                if not was_weak:
                    available_push(req)
            client._tick_pending.add(req_no)
            if req_no == client.next_ready_mark and crn.strong_requests:
                self.check_ready(client, crn)
            if fast is not None:
                # A live mirror (left over from large-frame deliveries) must
                # see every small-frame mutation too, or its tick_class goes
                # stale vs the python tick path (step_ack keeps the same
                # invariant one ack at a time).
                fast.refresh(ack.client_id, req_no)

    def step(self, source: int, msg: pb.Msg) -> Actions:
        verdict = self.filter(source, msg)
        if verdict is Applyable.PAST:
            return _EMPTY_ACTIONS
        if verdict is Applyable.FUTURE:
            self.msg_buffers[source].store(msg)
            return _EMPTY_ACTIONS
        return self.apply_msg(source, msg)

    def apply_msg(self, source: int, msg: pb.Msg) -> Actions:
        inner = msg.type
        if inner.__class__ is pb.RequestAck:
            self.ack(source, inner)
            return _EMPTY_ACTIONS
        if isinstance(inner, pb.FetchRequest):
            return self.reply_fetch_request(
                source, inner.client_id, inner.req_no, inner.digest
            )
        if isinstance(inner, pb.ForwardRequest):
            if source == self.my_config.id:
                return Actions()  # our own forward, already processed
            return self.apply_forward_request(source, inner)
        raise AssertionError(f"unexpected client message {type(inner).__name__}")

    # -- request arrival paths ----------------------------------------------

    def apply_request_digest(
        self, ack: pb.RequestAck, data: bytes, out: Actions | None = None
    ) -> Actions:
        client = self.clients.get(ack.client_id)
        if client is None:
            # Client removed since the request was hashed.
            return out if out is not None else Actions()
        if not client.in_watermarks(ack.req_no):
            # Already committed / out of window.
            if hooks.enabled and ack.req_no < client.low_watermark:
                # Retry-storm dedup: the window already retired this
                # req_no, so the resubmission is absorbed without effect.
                hooks.metrics.counter(
                    "mirbft_request_duplicates_total", reason="retired"
                ).inc()
            return out if out is not None else Actions()
        client._tick_pending.add(ack.req_no)
        crn = client.req_no(ack.req_no)
        if hooks.enabled:
            if crn.committed is not None:
                hooks.metrics.counter(
                    "mirbft_request_duplicates_total", reason="committed"
                ).inc()
            elif ack.digest in crn.my_requests:
                hooks.metrics.counter(
                    "mirbft_request_duplicates_total", reason="stored"
                ).inc()
        if self._device is not None:
            self._device.sync_slot(ack.client_id, ack.req_no)
        had_my = len(crn.my_requests)
        actions = crn.apply_request_digest(ack, data, out)
        if self._fast is not None:
            # May have created the slot's first (or a conflicting) request
            # entry and reset the rebroadcast counters: re-derive the
            # mirror's canonical + tick view.  The tick counters were only
            # touched if something was actually stored (the already-
            # persisted early return leaves them alone, and the mirror's
            # advanced copy must then survive the refresh).
            self._fast.refresh(
                ack.client_id,
                ack.req_no,
                tick_obj_authoritative=len(crn.my_requests) != had_my,
            )
        return actions

    def reply_fetch_request(
        self, source: int, client_id: int, req_no: int, digest: bytes
    ) -> Actions:
        client = self.clients.get(client_id)
        if client is None or not client.in_watermarks(req_no):
            return Actions()
        crn = client.req_no(req_no)
        if self._device is not None:
            self._device.sync_slot(client_id, req_no)
        req = crn.requests.get(digest or _NULL)
        if req is None or not req.agreements & (1 << self.my_config.id):
            return Actions()
        return Actions().forward_request(
            [source],
            pb.RequestAck(client_id=client_id, req_no=req_no, digest=digest),
        )

    def apply_forward_request(
        self, source: int, msg: pb.ForwardRequest
    ) -> Actions:
        client = self.clients.get(msg.request_ack.client_id)
        if client is None:
            return Actions()
        crn = client.req_no(msg.request_ack.req_no)
        if self._device is not None:
            self._device.sync_slot(
                msg.request_ack.client_id, msg.request_ack.req_no
            )
        req = crn.requests.get(msg.request_ack.digest or _NULL)
        if req is None:
            # We don't know this digest to be correct yet; drop (the weak
            # quorum will trigger a fetch if it becomes correct).
            return Actions()
        if req.agreements & (1 << self.my_config.id):
            return Actions()  # we already hold + acked it
        req.agreements |= 1 << source
        # Same quorum bookkeeping as apply_request_ack: this out-of-band
        # agreement bump can cross the weak/strong thresholds, and the
        # vector path only promotes on *exact* crossings it applies itself —
        # a skipped crossing here would never be retried (refresh re-derives
        # the canonical/tick view, not quorum membership).
        key = msg.request_ack.digest or _NULL
        count = req.agreements.bit_count()
        if count >= crn._weak_quorum:
            was_weak = key in crn.weak_requests
            crn.weak_requests[key] = req
            if count >= crn._strong_quorum:
                crn.strong_requests[key] = req
            if not was_weak:
                self.available_list.push_back(req)
            client._tick_pending.add(msg.request_ack.req_no)
            self.check_ready(client, crn)
        if self._fast is not None:
            self._fast.refresh(
                msg.request_ack.client_id, msg.request_ack.req_no
            )
        return Actions().hash(
            request_hash_data(
                pb.Request(
                    client_id=msg.request_ack.client_id,
                    req_no=msg.request_ack.req_no,
                    data=msg.request_data,
                )
            ),
            pb.HashResult(
                digest=b"",
                type=pb.HashOriginVerifyRequest(
                    source=source,
                    request_ack=msg.request_ack,
                    request_data=msg.request_data,
                ),
            ),
        )

    # -- ack accounting ------------------------------------------------------

    def ack(self, source: int, ack: pb.RequestAck, force: bool = False) -> ClientRequest:
        client = self.clients.get(ack.client_id)
        if client is None:
            raise AssertionError("step filter must delay unknown clients")
        if self._device is not None:
            self._device.sync_slot(ack.client_id, ack.req_no)
        cr, crn, newly_correct = client.ack(source, ack, force=force)
        if newly_correct:
            self.available_list.push_back(cr)
        self.check_ready(client, crn)
        if self._fast is not None:
            self._fast.refresh(ack.client_id, ack.req_no)
        return cr

    def check_ready(self, client: Client, crn: ClientReqNo) -> None:
        if crn.req_no != client.next_ready_mark:
            return
        if not crn.strong_requests:
            return
        for digest in crn.strong_requests:
            if digest in crn.my_requests:
                self.advance_ready(client)
                return

    def advance_ready(self, client: Client) -> None:
        for req_no in range(client.next_ready_mark, client.high_watermark + 1):
            if req_no != client.next_ready_mark:
                return  # previous iteration failed to advance
            crn = client.req_no_map.get(req_no)
            if crn is None:
                raise AssertionError(
                    f"client {client.client_state.id} missing req_no {req_no}"
                )
            for digest in crn.strong_requests:
                if digest in crn.my_requests:
                    self.ready_list.push_back(crn)
                    client.next_ready_mark = req_no + 1
                    if self._fast is not None:
                        ci = client.client_state.id - self._fast.cid0
                        if 0 <= ci < self._fast.n_clients:
                            self._fast.nrm_arr[ci] = req_no + 1
                    if self._device is not None:
                        ci = client.client_state.id - self._device.cid0
                        if 0 <= ci < self._device.n_clients:
                            self._device.nrm_arr[ci] = req_no + 1
                    break

    # -- checkpoint interplay ------------------------------------------------

    def commits_completed_for_checkpoint_window(self, seq_no: int) -> list:
        """Compute each client's next window state at a checkpoint boundary
        and allocate the newly usable request numbers (reference:
        client_tracker.go:482-550; the doc comment there works the
        width-consumed example)."""
        new_states = []
        for old_state in self.client_states:
            client = self.clients[old_state.id]

            first_uncommitted = last_committed = None
            for crn in client.req_nos():
                if crn.committed is not None:
                    if crn.committed > seq_no:
                        raise AssertionError(
                            "commit sequence after current checkpoint"
                        )
                    last_committed = crn.req_no
                elif first_uncommitted is None:
                    first_uncommitted = crn.req_no

            if last_committed is None:
                new_states.append(old_state)
                continue

            if first_uncommitted is None:
                if last_committed != client.high_watermark:
                    raise AssertionError(
                        "all committed implies committed through high mark"
                    )
                # Entire window consumed: the whole next window is gated on
                # the next checkpoint (width_consumed = full width).
                state = pb.NetworkClient(
                    id=old_state.id,
                    width=old_state.width,
                    width_consumed_last_checkpoint=old_state.width,
                    low_watermark=last_committed + 1,
                )
                new_states.append(state)
                client.allocate(seq_no, state)
                continue

            mask = make_bitmask(last_committed - first_uncommitted + 1)
            for i in range(last_committed - first_uncommitted + 1):
                req_no = first_uncommitted + i
                if client.req_no(req_no).committed is None:
                    continue
                if i == 0:
                    raise AssertionError(
                        "first uncommitted cannot be committed"
                    )
                set_bit(mask, i)

            state = pb.NetworkClient(
                id=old_state.id,
                width=old_state.width,
                width_consumed_last_checkpoint=first_uncommitted
                - old_state.low_watermark,
                low_watermark=first_uncommitted,
                committed_mask=bytes(mask),
            )
            new_states.append(state)
            client.allocate(seq_no, state)

        self.client_states = new_states
        self._drop_device()  # windows advanced: dense shapes are stale
        self._drop_fast()  # windows advanced: mirror shape is stale
        return new_states

    def drain(self) -> Actions:
        """Re-apply buffered messages after watermark movement."""
        actions = Actions()
        for node_id in self.network_config.nodes:
            self.msg_buffers[node_id].iterate(
                self.filter,
                lambda source, msg: actions.concat(self.apply_msg(source, msg)),
            )
        return actions

    def fetch_request(self, cr: ClientRequest) -> Actions:
        """Fetch a known-correct request (epoch-change path); mediated
        here so the fetching-state flip reclassifies the mirror slot."""
        if self._device is not None:
            # fetch() targets mask_ids(agreements): the device-held votes
            # must be in the object before the send list is computed.
            self._device.sync_slot(cr.ack.client_id, cr.ack.req_no)
        actions = cr.fetch()
        if self._fast is not None:
            self._fast.refresh(cr.ack.client_id, cr.ack.req_no)
        return actions

    def mark_committed(self, client_id: int, req_no: int, seq_no: int) -> None:
        """Called by commit state as batches are applied."""
        self.clients[client_id].req_no(req_no).committed = seq_no
        if self._fast is not None:
            self._fast.mark_committed(client_id, req_no)
        if self._device is not None:
            self._device.mark_committed(client_id, req_no)

    def garbage_collect(self, seq_no: int) -> None:
        self._drop_device()  # windows slide: dense slots remap
        self._drop_fast()  # windows slide: mirror slots remap
        for client_state in self.client_states:
            self.clients[client_state.id].move_low_watermark(seq_no)
        self.available_list.garbage_collect(seq_no)
        self.ready_list.garbage_collect(seq_no)

    def client(self, client_id: int) -> Client | None:
        return self.clients.get(client_id)
