"""Normal-case multi-leader ordering within one epoch.

Rebuild of the reference's active epoch (reference: epoch_active.go:21-526).
The sequence-number space is partitioned into buckets, each owned by a
leader; disjoint leaders drive disjoint partitions concurrently — Mir's
throughput idea.  Responsibilities:

- bucket→leader assignment, rotating non-leader buckets onto the leader set
  (overflow assignment);
- sequence allocation one checkpoint interval at a time (each row preceded
  by an NEntry persist), bounded by the epoch's planned expiration and the
  commit state's stop-at throttle;
- strict in-order admission of each bucket's preprepares (a per-bucket
  next-seq cursor; later preprepares buffer until their predecessor
  applies);
- fan-in of prepares/commits to the sequence FSMs and in-order drain of
  committed sequences into the commit state;
- proposer invocation for owned buckets; heartbeat (null-batch) fill and
  suspect-on-stall ticks.
"""

from __future__ import annotations

from .. import pb
from .actions import Actions
from .client_tracker import ClientTracker
from .commitstate import CommitState
from .msgbuffers import Applyable, MsgBuffer, NodeBuffers
from .outstanding import InvalidPreprepare, OutstandingReqs
from .persisted import Persisted
from .proposer import Proposer
from .quorum import seq_to_bucket
from .sequence import Sequence, SeqState


def assign_buckets(
    epoch_number: int, leaders: list, network_config: pb.NetworkConfig
) -> dict:
    """bucket_id -> leader node, rotating by epoch number; buckets whose
    rotation lands on a non-leader overflow onto the leader set round-robin
    (reference: epoch_active.go:52-69)."""
    leader_set = set(leaders)
    nodes = network_config.nodes
    buckets = {}
    overflow = 0
    for i in range(network_config.number_of_buckets):
        candidate = nodes[(i + epoch_number) % len(nodes)]
        if candidate in leader_set:
            buckets[i] = candidate
        else:
            buckets[i] = leaders[overflow % len(leaders)]
            overflow += 1
    return buckets


class _PreprepareBuffer:
    __slots__ = ("next_seq_no", "buffer")

    def __init__(self, next_seq_no: int, buffer: MsgBuffer):
        self.next_seq_no = next_seq_no
        self.buffer = buffer


class ActiveEpoch:
    def __init__(
        self,
        epoch_config: pb.EpochConfig,
        persisted: Persisted,
        node_buffers: NodeBuffers,
        commit_state: CommitState,
        client_tracker: ClientTracker,
        my_config: pb.InitialParameters,
        logger=None,
    ):
        self.epoch_config = epoch_config
        self.network_config = commit_state.active_state.config
        self.my_config = my_config
        self.logger = logger
        self.persisted = persisted
        self.commit_state = commit_state

        starting_seq_no = commit_state.highest_commit

        self.outstanding_reqs = OutstandingReqs(
            client_tracker, commit_state.active_state, logger
        )
        self.buckets = assign_buckets(
            epoch_config.number, epoch_config.leaders, self.network_config
        )

        n_buckets = len(self.buckets)
        self.lowest_unallocated = [0] * n_buckets
        for i in range(n_buckets):
            first_seq_no = starting_seq_no + i + 1
            self.lowest_unallocated[
                seq_to_bucket(first_seq_no, self.network_config)
            ] = first_seq_no

        self.lowest_uncommitted = starting_seq_no + 1

        self.proposer = Proposer(
            starting_seq_no,
            self.network_config.checkpoint_interval,
            my_config,
            client_tracker,
            self.buckets,
        )

        self.preprepare_buffers = [
            _PreprepareBuffer(
                next_seq_no=self.lowest_unallocated[i],
                buffer=MsgBuffer(
                    f"epoch-{epoch_config.number}-preprepare",
                    node_buffers.node_buffer(self.buckets[i]),
                ),
            )
            for i in range(n_buckets)
        ]
        self.other_buffers = {
            node: MsgBuffer(
                f"epoch-{epoch_config.number}-other",
                node_buffers.node_buffer(node),
            )
            for node in self.network_config.nodes
        }

        # Rows of checkpoint_interval sequences; row 0 starts at low
        # watermark.
        self.sequences: list[list[Sequence]] = []

        self.last_committed_at_tick = 0
        self.ticks_since_progress = 0
        # Set when a preprepare fails the in-order client contract — grounds
        # for suspicion (the reference panics with a TODO here,
        # epoch_active.go:281-284).
        self.suspect_bucket_violation = False

    # -- watermarks / lookup -------------------------------------------------

    def low_watermark(self) -> int:
        return self.sequences[0][0].seq_no

    def high_watermark(self) -> int:
        if not self.sequences:
            return self.commit_state.low_watermark
        return self.sequences[-1][-1].seq_no

    def in_watermarks(self, seq_no: int) -> bool:
        return self.low_watermark() <= seq_no <= self.high_watermark()

    def seq_bucket(self, seq_no: int) -> int:
        return seq_to_bucket(seq_no, self.network_config)

    def sequence(self, seq_no: int) -> Sequence:
        ci = self.network_config.checkpoint_interval
        index = (seq_no - self.low_watermark()) // ci
        offset = (seq_no - self.low_watermark()) % ci
        seq = self.sequences[index][offset]
        if seq.seq_no != seq_no:
            raise AssertionError(f"sequence table corrupt at {seq_no}")
        return seq

    # -- message handling ----------------------------------------------------

    def filter(self, source: int, msg: pb.Msg) -> Applyable:
        inner = msg.type
        if isinstance(inner, pb.Preprepare):
            seq_no = inner.seq_no
            bucket = self.seq_bucket(seq_no)
            if self.buckets[bucket] != source:
                return Applyable.INVALID
            if seq_no > self.epoch_config.planned_expiration:
                return Applyable.INVALID
            if seq_no > self.high_watermark():
                return Applyable.FUTURE
            if seq_no < self.low_watermark():
                return Applyable.PAST
            next_preprepare = self.preprepare_buffers[bucket].next_seq_no
            if seq_no < next_preprepare:
                return Applyable.PAST
            if seq_no > next_preprepare:
                return Applyable.FUTURE
            return Applyable.CURRENT
        if isinstance(inner, pb.Prepare):
            seq_no = inner.seq_no
            if self.buckets[self.seq_bucket(seq_no)] == source:
                return Applyable.INVALID  # owners never send Prepare
            if seq_no > self.epoch_config.planned_expiration:
                return Applyable.INVALID
        elif isinstance(inner, pb.Commit):
            seq_no = inner.seq_no
            if seq_no > self.epoch_config.planned_expiration:
                return Applyable.INVALID
        else:
            raise AssertionError(f"unexpected msg {type(inner).__name__}")
        if seq_no < self.low_watermark():
            return Applyable.PAST
        if seq_no > self.high_watermark():
            return Applyable.FUTURE
        return Applyable.CURRENT

    def step(self, source: int, msg: pb.Msg) -> Actions:
        verdict = self.filter(source, msg)
        if verdict is Applyable.CURRENT:
            return self.apply(source, msg)
        if verdict is Applyable.FUTURE:
            if isinstance(msg.type, pb.Preprepare):
                bucket = self.seq_bucket(msg.type.seq_no)
                self.preprepare_buffers[bucket].buffer.store(msg)
            else:
                self.other_buffers[source].store(msg)
        return Actions()

    def apply(self, source: int, msg: pb.Msg) -> Actions:
        actions = Actions()
        inner = msg.type
        if isinstance(inner, pb.Preprepare):
            bucket = self.seq_bucket(inner.seq_no)
            pp_buffer = self.preprepare_buffers[bucket]
            next_msg = msg
            while next_msg is not None:
                pp = next_msg.type
                actions.concat(
                    self.apply_preprepare_msg(source, pp.seq_no, pp.batch)
                )
                pp_buffer.next_seq_no += len(self.buckets)
                next_msg = pp_buffer.buffer.next(self.filter)
        elif isinstance(inner, pb.Prepare):
            actions.concat(
                self.sequence(inner.seq_no).apply_prepare_msg(
                    source, inner.digest
                )
            )
        elif isinstance(inner, pb.Commit):
            actions.concat(
                self.apply_commit_msg(source, inner.seq_no, inner.digest)
            )
        else:
            raise AssertionError(f"unexpected msg {type(inner).__name__}")
        return actions

    def apply_preprepare_msg(
        self, source: int, seq_no: int, batch: list
    ) -> Actions:
        seq = self.sequence(seq_no)

        if seq.owner == self.my_config.id:
            # Our own self-delivered Preprepare: the allocation path already
            # advanced the cursors and counted our vote; the sequence's
            # duplicate guard makes this a no-op.
            return seq.apply_prepare_msg(source, seq.digest)

        bucket = self.seq_bucket(seq_no)
        if seq_no != self.lowest_unallocated[bucket]:
            raise AssertionError(
                "step must defer all but the next expected preprepare"
            )
        self.lowest_unallocated[bucket] += len(self.buckets)

        try:
            return self.outstanding_reqs.apply_acks(bucket, seq, batch)
        except InvalidPreprepare:
            # The leader equivocated or broke client order: grounds for
            # suspicion.  The epoch target turns this flag into a Suspect.
            self.suspect_bucket_violation = True
            return Actions()

    def apply_commit_msg(self, source: int, seq_no: int, digest: bytes) -> Actions:
        seq = self.sequence(seq_no)
        # The commit can be the very event that advances a lagging sequence
        # through its prepare transitions (real transports deliver peers'
        # commits while we are still preparing), and those transitions emit
        # persists and sends — dropping them skips WAL indices.
        actions = seq.apply_commit_msg(source, digest)
        if seq.state != SeqState.COMMITTED or seq_no != self.lowest_uncommitted:
            return actions
        if self.commit_state.transferring:
            # A lagging node asked for a transfer to a certified checkpoint
            # past this window (StateMachine._maybe_request_transfer) while
            # its epoch still runs; the transfer supersedes these
            # sequences.  The JAX package commits here and its serializer
            # dies on CommitState.commit's guard (ROADMAP queue 3).
            return actions

        while self.lowest_uncommitted <= self.high_watermark():
            seq = self.sequence(self.lowest_uncommitted)
            if seq.state != SeqState.COMMITTED:
                break
            self.commit_state.commit(seq.q_entry)
            self.lowest_uncommitted += 1
        return actions

    def apply_batch_hash_result(self, seq_no: int, digest: bytes) -> Actions:
        if not self.in_watermarks(seq_no):
            return Actions()  # benign after state transfer
        return self.sequence(seq_no).apply_batch_hash_result(digest)

    # -- watermark movement / allocation -------------------------------------

    def move_low_watermark(self, seq_no: int):
        """Returns (actions, epoch_done)."""
        if seq_no == self.epoch_config.planned_expiration:
            return Actions(), True
        if seq_no == self.commit_state.stop_at_seq_no:
            return Actions(), True

        actions = self.advance()
        # The epoch may legitimately hold no rows (e.g. freshly activated
        # after a reconfiguration with its allocation already at the stop);
        # there is then nothing to slide past.
        while self.sequences and seq_no > self.low_watermark():
            self.sequences.pop(0)
        return actions, False

    def drain_buffers(self) -> Actions:
        actions = Actions()
        # Hot path: this runs once per event per bucket/node, and the
        # buffers are nearly always empty — test MsgBuffer's public backing
        # list to skip without a method call.
        for bucket in range(len(self.buckets)):
            pp_buffer = self.preprepare_buffers[bucket]
            if not pp_buffer.buffer.msgs:
                continue
            source = self.buckets[bucket]
            next_msg = pp_buffer.buffer.next(self.filter)
            if next_msg is not None:
                # apply() loops consecutive preprepares internally.
                actions.concat(self.apply(source, next_msg))
        for node in self.network_config.nodes:
            buffer = self.other_buffers[node]
            if not buffer.msgs:
                continue
            buffer.iterate(
                self.filter,
                lambda src, msg: actions.concat(self.apply(src, msg)),
            )
        return actions

    def advance(self) -> Actions:
        """Allocate sequence rows up to the epoch/stop bounds, drain
        buffers, and cut batches for owned buckets."""
        actions = Actions()

        ci = self.network_config.checkpoint_interval
        while (
            self.high_watermark() < self.epoch_config.planned_expiration
            and self.high_watermark() < self.commit_state.stop_at_seq_no
        ):
            base = self.high_watermark()
            actions.concat(
                self.persisted.add_n_entry(
                    pb.NEntry(seq_no=base + 1, epoch_config=self.epoch_config)
                )
            )
            row = []
            for i in range(ci):
                seq_no = base + 1 + i
                row.append(
                    Sequence(
                        owner=self.buckets[self.seq_bucket(seq_no)],
                        epoch=self.epoch_config.number,
                        seq_no=seq_no,
                        persisted=self.persisted,
                        network_config=self.network_config,
                        my_config=self.my_config,
                        logger=self.logger,
                    )
                )
            self.sequences.append(row)

        actions.concat(self.drain_buffers())

        self.proposer.advance(self.lowest_uncommitted)

        for bucket, owner in self.buckets.items():
            if owner != self.my_config.id:
                continue
            prb = self.proposer.proposal_bucket(bucket)
            while True:
                seq_no = self.lowest_unallocated[bucket]
                if seq_no > self.high_watermark():
                    break
                if not prb.has_pending(seq_no):
                    break
                seq = self.sequence(seq_no)
                actions.concat(seq.allocate_as_owner(prb.next_batch()))
                self.lowest_unallocated[bucket] += len(self.buckets)
        return actions

    # -- ticks ---------------------------------------------------------------

    def _export_bucket_backlog(self) -> None:
        """Per-bucket backlog gauges, sampled on tick: sequences past
        UNINITIALIZED but not yet COMMITTED inside the active window.
        A persistently lopsided backlog is the skewed-traffic signal —
        one leader's bucket absorbing the hot clients while the others
        idle (status.py surfaces the max/median ratio)."""
        from ..obsv import hooks

        if not hooks.enabled:
            return
        backlog = self.bucket_backlog()
        m = hooks.metrics
        for bucket, depth in enumerate(backlog):
            m.gauge("mirbft_bucket_backlog", bucket=str(bucket)).set(depth)

    def bucket_backlog(self) -> list:
        """In-flight (allocated-but-uncommitted) sequence count per
        bucket over the active window.  An empty window (every sequence of
        an epoch at its end garbage-collected) has none; the JAX package
        reads its low watermark regardless and its serializer dies on the
        IndexError (ROADMAP queue 3)."""
        backlog = [0] * len(self.buckets)
        if not self.sequences:
            return backlog
        for seq_no in range(self.low_watermark(), self.high_watermark() + 1):
            state = self.sequence(seq_no).state
            if state not in (SeqState.UNINITIALIZED, SeqState.COMMITTED):
                backlog[self.seq_bucket(seq_no)] += 1
        return backlog

    def tick(self) -> Actions:
        self._export_bucket_backlog()
        if self.last_committed_at_tick < self.commit_state.highest_commit:
            self.last_committed_at_tick = self.commit_state.highest_commit
            self.ticks_since_progress = 0
            return Actions()

        self.ticks_since_progress += 1
        actions = Actions()

        if self.ticks_since_progress > self.my_config.suspect_ticks:
            suspect = pb.Suspect(epoch=self.epoch_config.number)
            actions.send(self.network_config.nodes, pb.Msg(type=suspect))
            actions.concat(self.persisted.add_suspect(suspect))

        if (
            self.my_config.heartbeat_ticks == 0
            or self.ticks_since_progress % self.my_config.heartbeat_ticks != 0
        ):
            return actions

        # Heartbeat: fill our unallocated owned sequences with (possibly
        # empty) batches so followers see progress.
        for bucket, unallocated in enumerate(self.lowest_unallocated):
            if unallocated > self.high_watermark():
                continue
            if self.buckets[bucket] != self.my_config.id:
                continue
            seq = self.sequence(unallocated)
            prb = self.proposer.proposal_bucket(bucket)
            client_reqs = []
            if prb.has_outstanding(unallocated):
                client_reqs = prb.next_batch()
            actions.concat(seq.allocate_as_owner(client_reqs))
            self.lowest_unallocated[bucket] += len(self.buckets)
        return actions
