"""The deterministic protocol state machine: the framework's L1 entry point.

Rebuild of the reference's dispatcher (reference: state_machine.go:95-476).
The contract (docs/StateMachine.md discipline): a single-threaded, I/O-free,
clock-free function from StateEvents to Actions.  Every input — inbound
message, local proposal, tick, hash/checkpoint result, WAL replay — is a
serializable event, which is what makes every run recordable and replayable.

Lifecycle: Initialize → LoadEntry* → LoadRequest* → CompleteInitialization
(the runtime's bootstrap WAL synthesizes the initial CEntry+FEntry for fresh
starts, reference: mirbft.go:162-190).  After every event the dispatcher
garbage-collects if a checkpoint became stable, then runs the commit-drain +
epoch-advance fixed point until quiescent.
"""

from __future__ import annotations

import enum
import time

from .. import pb
from ..obsv import hooks
from .actions import Actions
from .batch_tracker import BatchTracker
from .checkpoints import CheckpointTracker
from .client_tracker import ClientTracker
from .commitstate import CommitState
from .epoch_target import TargetState
from .epoch_tracker import EpochTracker
from .msgbuffers import NodeBuffers
from .persisted import Persisted
from .preimage import request_hash_data

from .actions import EMPTY_ACTIONS as _EMPTY_ACTIONS  # shared hot-path empty


class _SMState(enum.Enum):
    UNINITIALIZED = 0
    LOADING = 1
    INITIALIZED = 2


class StateMachine:
    def __init__(self, logger=None, ack_plane=None, ack_flush_rows=None,
                 ack_device="cuda"):
        self.logger = logger
        # Ack-plane selection is operational (not consensus state), so it
        # rides here rather than in pb.InitialParameters — the serialized
        # parameter record stays wire-compatible across deployments that
        # mix host- and device-plane nodes.
        self.ack_plane = ack_plane
        self.ack_flush_rows = ack_flush_rows
        # The device ack plane's card: "cuda" (the kernels) or "cpu" (their
        # plain versions).  Read only when the device plane is selected.
        self.ack_device = ack_device
        self._state = _SMState.UNINITIALIZED

        self.my_config: pb.InitialParameters | None = None
        self.persisted: Persisted | None = None
        self.node_buffers: NodeBuffers | None = None
        self.checkpoint_tracker: CheckpointTracker | None = None
        self.client_tracker: ClientTracker | None = None
        self.commit_state: CommitState | None = None
        self.batch_tracker: BatchTracker | None = None
        self.epoch_tracker: EpochTracker | None = None
        self._loaded_reqs: list = []
        # Active member set; messages from non-members (e.g. a node removed
        # by reconfiguration that has not yet stopped sending) are dropped
        # at ingress — per-source buffers and quorum maps are keyed by the
        # active config and must never see foreign ids.
        self._members: frozenset = frozenset()
        # Set when an adopted configuration no longer includes this node:
        # the embedder should drain and shut the process down cleanly (the
        # survivors already drop our messages at ingress).
        self.retired = False
        self.reconfigs_adopted = 0

    # -- lifecycle -----------------------------------------------------------

    def _initialize(self, parameters: pb.InitialParameters) -> None:
        if self._state is not _SMState.UNINITIALIZED:
            raise AssertionError("state machine already initialized")
        self.my_config = parameters
        self._state = _SMState.LOADING

        self.persisted = Persisted(self.logger)
        self.node_buffers = NodeBuffers(parameters, self.logger)
        self.checkpoint_tracker = CheckpointTracker(
            self.persisted, self.node_buffers, parameters, self.logger
        )
        self.client_tracker = ClientTracker(
            self.persisted, self.node_buffers, parameters, self.logger,
            ack_plane=self.ack_plane,
            ack_flush_rows=self.ack_flush_rows,
            ack_device=self.ack_device,
        )
        self.commit_state = CommitState(
            self.persisted, self.client_tracker, self.logger
        )
        self.batch_tracker = BatchTracker(self.persisted, self.logger)
        self.epoch_tracker = EpochTracker(
            self.persisted,
            self.node_buffers,
            self.commit_state,
            parameters,
            self.batch_tracker,
            self.client_tracker,
            self.logger,
        )

    def _complete_initialization(self) -> Actions:
        if self._state is not _SMState.LOADING:
            raise AssertionError("not loading")
        self._state = _SMState.INITIALIZED
        return self._reinitialize()

    def _reinitialize(self) -> Actions:
        """Rebuild every tracker from the persisted log (start, state
        transfer, or reconfiguration)."""
        actions = self._recover_log()
        self.client_tracker.reinitialize()

        for ack in self._loaded_reqs:
            # Requests found uncommitted in the request store at startup.
            self.client_tracker.apply_request_digest(ack, b"")
        self._loaded_reqs = []

        actions.concat(self.commit_state.reinitialize())
        self._members = frozenset(
            self.commit_state.active_state.config.nodes
        )
        if self.my_config is not None and self.my_config.id not in self._members:
            self.retired = True
        self.checkpoint_tracker.reinitialize()
        self.batch_tracker.reinitialize()
        return actions.concat(self.epoch_tracker.reinitialize())

    def _recover_log(self) -> Actions:
        """Resume an interrupted FEntry truncation (reference:
        state_machine.go:292-310)."""
        last_c_entry = None
        actions = Actions()

        def on_c(entry):
            nonlocal last_c_entry
            last_c_entry = entry

        def on_f(_entry):
            if last_c_entry is None:
                raise AssertionError("FEntry without CEntry: corrupt log")
            actions.concat(self.persisted.truncate(last_c_entry.seq_no))

        self.persisted.iterate({pb.CEntry: on_c, pb.FEntry: on_f})
        if last_c_entry is None:
            raise AssertionError("no checkpoints in the log")
        return actions

    # -- the event loop ------------------------------------------------------

    def apply_event(self, event: pb.StateEvent) -> Actions:
        # The contract stays clock-free: the observed wrapper reads
        # perf_counter for telemetry only; nothing feeds back into the
        # protocol.  When obsv is off this is one branch.
        if not hooks.enabled:
            return self._apply_event(event)
        t0 = time.perf_counter()
        actions = self._apply_event(event)
        m = hooks.metrics
        m.histogram("mirbft_sm_apply_seconds").observe(
            time.perf_counter() - t0
        )
        m.counter(
            "mirbft_sm_events_total", type=type(event.type).__name__
        ).inc()
        if not actions.is_empty():
            for kind, emitted in (
                ("send", actions.sends),
                ("hash", actions.hashes),
                ("commit", actions.commits),
                ("persist", actions.write_ahead),
                ("store_request", actions.store_requests),
                ("forward_request", actions.forward_requests),
            ):
                if emitted:
                    m.counter("mirbft_sm_actions_total", kind=kind).inc(
                        len(emitted)
                    )
        return actions

    def _apply_event(self, event: pb.StateEvent) -> Actions:
        inner = event.type
        # Exact-type dispatch ordered by frequency (pb event classes have
        # no subclasses; this chain runs once per event of every node).
        inner_type = type(inner)

        if inner_type is pb.EventPropose:
            # Fast path: a propose only emits its hash action — it cannot
            # make a checkpoint collectable or advance the epoch, so the
            # GC/fixed-point epilogue below is statically a no-op for it.
            if self._state is not _SMState.INITIALIZED:
                raise AssertionError(
                    "cannot apply EventPropose before initialization"
                )
            return self._propose(inner.request)

        if inner_type is pb.EventProposeBatch:
            # Same fast path, batched: one delivery carrying many local
            # proposals emits one hash action per request and nothing else
            # (exactly as if each arrived as its own EventPropose in list
            # order).
            if self._state is not _SMState.INITIALIZED:
                raise AssertionError(
                    "cannot apply EventProposeBatch before initialization"
                )
            batch_actions = Actions()
            my_id = self.my_config.id
            for request in inner.requests:
                batch_actions.hash(
                    request_hash_data(request),
                    pb.HashResult(
                        digest=b"",
                        type=pb.HashOriginRequest(
                            source=my_id, request=request
                        ),
                    ),
                )
            return batch_actions

        actions = Actions()

        if inner_type is pb.EventInitialize:
            self._initialize(inner.initial_parms)
            return Actions()
        if inner_type is pb.EventLoadEntry:
            if self._state is not _SMState.LOADING:
                raise AssertionError("not loading")
            self.persisted.append_initial_load(inner.index, inner.data)
            return Actions()
        if inner_type is pb.EventLoadRequest:
            self._loaded_reqs.append(inner.request_ack)
            return Actions()
        if inner_type is pb.EventCompleteInitialization:
            actions = self._complete_initialization()
        elif inner_type is pb.EventActionsReceived:
            # No-op marker tying action results to the actions that caused
            # them in recorded logs.
            return Actions()
        else:
            if self._state is not _SMState.INITIALIZED:
                raise AssertionError(
                    f"cannot apply {type(inner).__name__} before initialization"
                )
            if inner_type is pb.EventStep:
                if inner.source not in self._members:
                    return _EMPTY_ACTIONS  # non-member (e.g. removed node)
                stepped = self._step(inner.source, inner.msg)
                if stepped is not _EMPTY_ACTIONS:
                    actions.concat(stepped)
            elif inner_type is pb.EventStepBatch:
                # One transport frame, several messages: apply in list order,
                # exactly as if each arrived as its own EventStep.  RequestAck
                # dispatch is inlined: acks dominate batch contents at scale
                # and their handler never emits actions.
                source = inner.source
                if source not in self._members:
                    return _EMPTY_ACTIONS  # non-member (e.g. removed node)
                msgs = inner.msgs
                ack_cls = pb.RequestAck
                step = self._step
                step_ack_many = self.client_tracker.step_ack_many
                i = 0
                n = len(msgs)
                while i < n:
                    if msgs[i].type.__class__ is ack_cls:
                        # Bulk-apply the run of consecutive acks (frames
                        # are overwhelmingly pure ack runs at scale).
                        j = i + 1
                        while j < n and msgs[j].type.__class__ is ack_cls:
                            j += 1
                        step_ack_many(
                            source, msgs if j - i == n else msgs[i:j]
                        )
                        i = j
                        continue
                    stepped = step(source, msgs[i])
                    if stepped is not _EMPTY_ACTIONS:
                        actions.concat(stepped)
                    i += 1
            elif inner_type is pb.EventTick:
                actions.concat(self.client_tracker.tick())
                actions.concat(self.epoch_tracker.tick())
            elif inner_type is pb.EventPropose:
                actions.concat(self._propose(inner.request))
            elif inner_type is pb.EventActionResults:
                actions.concat(self._process_results(inner))
            elif inner_type is pb.EventTransfer:
                if not self.commit_state.transferring:
                    raise AssertionError(
                        "transfer event without a requested transfer"
                    )
                if inner.c_entry.network_state is None:
                    # Transfer failed — usually because every donor GC'd
                    # the target while the network moved on.  If an
                    # intersection quorum has since certified a newer
                    # checkpoint, chase that instead: retrying the dead
                    # target forever wedges the node, since the ordinary
                    # lag trigger (_maybe_request_transfer) stands down
                    # while a transfer is in flight.  (The reference would
                    # trip addCEntry's network-state assertion here,
                    # state_machine.go:211-217 with mirbft.go:446-459.)
                    certified = (
                        self.checkpoint_tracker.certified_above_window()
                    )
                    target = self.commit_state.transfer_target
                    if (
                        certified is not None
                        and target is not None
                        and certified[0] > target.seq_no
                    ):
                        actions.concat(
                            self.commit_state.retarget_transfer(*certified)
                        )
                    else:
                        actions.concat(self.commit_state.retry_transfer())
                else:
                    actions.concat(self.persisted.add_c_entry(inner.c_entry))
                    actions.concat(self._reinitialize())
            else:
                raise AssertionError(
                    f"unknown state event {type(inner).__name__}"
                )

        # At most one watermark movement is possible per event (a new
        # checkpoint of our own can only follow the previous checkpoint
        # result).  Truncation requires an ACTIVE epoch: between an ECEntry
        # (or a reconfiguration reinitialize) and the next epoch becoming
        # active, the log must stay intact so an identical epoch change can
        # be recomputed after a crash — and so the log never degenerates to
        # a bare CEntry with no epoch marker (the reference states this
        # discipline in docs/WALMovement.md:34-36 but does not enforce it).
        epoch_active = (
            self.epoch_tracker.current_epoch is not None
            and self.epoch_tracker.current_epoch.state
            == TargetState.IN_PROGRESS
        )
        if self.checkpoint_tracker.garbage_collectable and epoch_active:
            new_low = self.checkpoint_tracker.garbage_collect()
            actions.concat(self.persisted.truncate(new_low))
            self.client_tracker.garbage_collect(new_low)
            ci = self.checkpoint_tracker.network_config.checkpoint_interval
            if new_low > ci:
                # Keep one extra checkpoint interval of batches for epoch
                # change.
                self.batch_tracker.truncate(new_low - ci)
            actions.concat(self.epoch_tracker.move_low_watermark(new_low))

        # Fixed point: drain commits and advance the epoch until quiescent.
        while True:
            actions.commits.extend(self.commit_state.drain())
            loop_actions = self.epoch_tracker.advance_state()
            if loop_actions.is_empty():
                break
            actions.concat(loop_actions)

        return actions

    # -- event handlers ------------------------------------------------------

    def _propose(self, request: pb.Request) -> Actions:
        return Actions().hash(
            request_hash_data(request),
            pb.HashResult(
                digest=b"",
                type=pb.HashOriginRequest(
                    source=self.my_config.id, request=request
                ),
            ),
        )

    def _step(self, source: int, msg: pb.Msg) -> Actions:
        # Exact-type checks ordered by frequency (RequestAcks dominate all
        # traffic at ladder scale; pb classes have no subclasses).
        cls = msg.type.__class__
        if cls is pb.RequestAck:
            return self.client_tracker.step_ack(source, msg)
        if cls is pb.FetchRequest or cls is pb.ForwardRequest:
            return self.client_tracker.step(source, msg)
        if cls is pb.Checkpoint:
            self.checkpoint_tracker.step(source, msg)
            return self._maybe_request_transfer()
        if cls is pb.FetchBatch or cls is pb.ForwardBatch:
            return self.batch_tracker.step(source, msg)
        # Everything else is epoch-scoped.
        return self.epoch_tracker.step(source, msg)

    def _maybe_request_transfer(self) -> Actions:
        """Lag check after every Checkpoint message: when an intersection
        quorum certifies a checkpoint far enough above our window that the
        network has GC'd past anything ordinary replay can fetch, request
        state transfer to the certified target.  Also exports the lag
        gauge, so dashboards see a node falling behind before the
        transfer fires."""
        tracker = self.checkpoint_tracker
        certified = tracker.certified_above_window()
        if hooks.enabled:
            lag = (
                certified[0] - tracker.high_watermark() if certified else 0
            )
            hooks.metrics.gauge("mirbft_checkpoint_lag_seqnos").set(lag)
        if certified is None or self.commit_state.transferring:
            return _EMPTY_ACTIONS
        seq_no, value = certified
        # Hysteresis: within two checkpoint windows of the frontier,
        # peers still retain the batches (they GC to their own low
        # watermark) and retransmission catches us up while we keep
        # ordering.  Transferring eagerly here preempts normal
        # participation — seen as a perpetual adopt-loop in the node-set
        # growth scenario, where the freshly provisioned member chased
        # every new certificate instead of executing batches.  Beyond
        # the horizon, replay is impossible and transfer is the only way
        # forward; a node stuck inside the horizon self-corrects, since
        # the frontier keeps moving while it does not.
        horizon = 2 * tracker.network_config.checkpoint_interval
        if seq_no <= tracker.high_watermark() + horizon:
            return _EMPTY_ACTIONS
        if seq_no <= self.commit_state.highest_commit:
            return _EMPTY_ACTIONS
        return self.commit_state.transfer_to(seq_no, value)

    def _process_results(self, results: pb.EventActionResults) -> Actions:
        actions = Actions()

        for checkpoint_result in results.checkpoints:
            epoch_config = None
            current = self.epoch_tracker.current_epoch
            if current is not None and current.active_epoch is not None:
                epoch_config = current.active_epoch.epoch_config
            actions.concat(
                self.commit_state.apply_checkpoint_result(
                    epoch_config, checkpoint_result
                )
            )
            if self.commit_state.reconfigured:
                # A pending reconfiguration just activated: the CEntry with
                # the new network state is in the log; rebuild every tracker
                # from it.  (The resumed epoch sends a precautionary
                # Suspect, so the network rolls into a fresh epoch under
                # the new configuration.)
                self.commit_state.reconfigured = False
                self.reconfigs_adopted += 1
                if hooks.enabled:
                    hooks.metrics.counter(
                        "mirbft_reconfig_adopted_total"
                    ).inc()
                actions.concat(self._reinitialize())

        for hash_result in results.digests:
            origin = hash_result.type
            digest = hash_result.digest
            if isinstance(origin, pb.HashOriginBatch):
                self.batch_tracker.add_batch(
                    origin.seq_no, digest, origin.request_acks
                )
                actions.concat(
                    self.epoch_tracker.apply_batch_hash_result(
                        origin.epoch, origin.seq_no, digest
                    )
                )
            elif isinstance(origin, pb.HashOriginRequest):
                req = origin.request
                self.client_tracker.apply_request_digest(
                    pb.RequestAck(
                        client_id=req.client_id,
                        req_no=req.req_no,
                        digest=digest,
                    ),
                    req.data,
                    out=actions,
                )
            elif isinstance(origin, pb.HashOriginVerifyRequest):
                if origin.request_ack.digest != digest:
                    # A byzantine peer forwarded request data that does not
                    # hash to the ack's digest.  Drop it — the fetch/refetch
                    # tick machinery retries against other ackers.  (The
                    # reference panics here, marked "XXX this should not
                    # panic"; a remote peer must never crash the node.)
                    if self.logger is not None:
                        self.logger.warn(
                            "dropping forwarded request: data does not "
                            "match its ack digest",
                            source=origin.source,
                            client_id=origin.request_ack.client_id,
                            req_no=origin.request_ack.req_no,
                        )
                else:
                    self.client_tracker.apply_request_digest(
                        origin.request_ack, origin.request_data, out=actions
                    )
            elif isinstance(origin, pb.HashOriginEpochChange):
                actions.concat(
                    self.epoch_tracker.apply_epoch_change_digest(origin, digest)
                )
            elif isinstance(origin, pb.HashOriginVerifyBatch):
                self.batch_tracker.apply_verify_batch_hash_result(digest, origin)
                if (
                    not self.batch_tracker.has_fetch_in_flight()
                    and self.epoch_tracker.current_epoch.state
                    == TargetState.FETCHING
                ):
                    actions.concat(
                        self.epoch_tracker.current_epoch.fetch_new_epoch_state()
                    )
            else:
                raise AssertionError("hash result with no origin type")

        return actions
