"""The per-(seq_no, epoch) three-phase commit cell.

Rebuild of the reference's sequence FSM (reference: sequence.go:15-359).
State flow:

    UNINITIALIZED --allocate--> ALLOCATED
      (empty batch: straight to READY with a nil digest)
    ALLOCATED -> PENDING_REQUESTS  (batch digest requested via Actions.hash)
    PENDING_REQUESTS --all outstanding requests present--> READY
    READY --digest known--> PREPREPARED
      (persist QEntry; owner broadcasts Preprepare + forwards request data
       to nodes that haven't ACKed; followers broadcast Prepare)
    PREPREPARED --2f+1 prepares incl. own--> PREPARED
      (persist PEntry; broadcast Commit)
    PREPARED --2f+1 commits incl. own--> COMMITTED

Quorums are intersection quorums (2f+1 out of 3f+1): the owner's Preprepare
counts as its Prepare, and our own vote is required before advancing past
PREPREPARED/PREPARED so that the QEntry/PEntry is durable before we
participate (the persist→send safety contract, docs/Processor.md).
"""

from __future__ import annotations

import enum

from .. import pb
from ..obsv import hooks
from .actions import Actions
from .persisted import Persisted
from .quorum import intersection_quorum, seq_to_bucket


class SeqState(enum.IntEnum):
    UNINITIALIZED = 0
    ALLOCATED = 1
    PENDING_REQUESTS = 2
    READY = 3
    PREPREPARED = 4
    PREPARED = 5
    COMMITTED = 6


class _NodeState(enum.IntEnum):
    UNINITIALIZED = 0
    PREPREPARED = 1
    PREPARED = 2


class _NodeChoice:
    """What one node has already claimed about this sequence — the
    equivocation guard (reference: sequence.go:27-38)."""

    __slots__ = ("state", "digest")

    def __init__(self):
        self.state = _NodeState.UNINITIALIZED
        self.digest = None


class Sequence:
    def __init__(
        self,
        owner: int,
        epoch: int,
        seq_no: int,
        persisted: Persisted,
        network_config: pb.NetworkConfig,
        my_config: pb.InitialParameters,
        logger=None,
    ):
        self.owner = owner
        self.epoch = epoch
        self.seq_no = seq_no
        self.persisted = persisted
        self.network_config = network_config
        self.my_config = my_config
        self.logger = logger

        self.state = SeqState.UNINITIALIZED
        self.q_entry: pb.QEntry | None = None
        # Set only when we own this sequence and proposed the batch ourselves;
        # items expose .ack (pb.RequestAck) and .agreements (node-id bitmask).
        self.client_requests: list | None = None
        self.batch: list | None = None  # [pb.RequestAck]
        self.outstanding_reqs: set | None = None  # digests not yet available
        self.digest: bytes | None = None
        self._node_choices: dict[int, _NodeChoice] = {}
        self._prepares: dict[bytes, int] = {}
        self._commits: dict[bytes, int] = {}

    def _node_choice(self, source: int) -> _NodeChoice:
        choice = self._node_choices.get(source)
        if choice is None:
            choice = _NodeChoice()
            self._node_choices[source] = choice
        return choice

    # -- state advancement ---------------------------------------------------

    def advance_state(self) -> Actions:
        actions = Actions()
        while True:
            old_state = self.state
            if self.state == SeqState.PENDING_REQUESTS:
                self._check_requests()
            elif self.state == SeqState.READY:
                if self.digest is not None or not self.batch:
                    actions.concat(self._prepare())
            elif self.state == SeqState.PREPREPARED:
                actions.concat(self._check_prepare_quorum())
            elif self.state == SeqState.PREPARED:
                self._check_commit_quorum()
            if self.state == old_state:
                return actions

    # -- allocation ----------------------------------------------------------

    def allocate_as_owner(self, client_requests: list) -> Actions:
        self.client_requests = client_requests
        return self.allocate([cr.ack for cr in client_requests], None)

    def allocate(self, request_acks: list, outstanding_reqs: set | None) -> Actions:
        if self.state != SeqState.UNINITIALIZED:
            raise AssertionError(
                f"seq_no={self.seq_no} must be uninitialized to allocate"
            )

        self.state = SeqState.ALLOCATED
        self.batch = request_acks
        self.outstanding_reqs = outstanding_reqs
        if hooks.enabled:
            hooks.milestone(
                "seq.allocated",
                self.my_config.id,
                self.seq_no,
                epoch=self.epoch,
                bucket=seq_to_bucket(self.seq_no, self.network_config),
            )

        if not request_acks:
            # Null batch: nothing to digest.
            self.state = SeqState.READY
            return self.apply_batch_hash_result(None)

        actions = Actions().hash(
            [ack.digest for ack in request_acks],
            pb.HashResult(
                digest=b"",
                type=pb.HashOriginBatch(
                    source=self.owner,
                    epoch=self.epoch,
                    seq_no=self.seq_no,
                    request_acks=request_acks,
                ),
            ),
        )

        self.state = SeqState.PENDING_REQUESTS
        return actions.concat(self.advance_state())

    def satisfy_outstanding(self, ack: pb.RequestAck) -> Actions:
        if ack.digest not in self.outstanding_reqs:
            raise AssertionError(
                f"request {ack.digest!r} satisfied but never awaited"
            )
        self.outstanding_reqs.discard(ack.digest)
        return self.advance_state()

    def _check_requests(self) -> None:
        if self.outstanding_reqs:
            return
        self.state = SeqState.READY

    # -- preprepare / prepare ------------------------------------------------

    def apply_batch_hash_result(self, digest: bytes | None) -> Actions:
        self.digest = digest
        # The digest alone can complete READY -> PREPREPARED.  The JAX
        # package relies on apply_prepare_msg to advance, but its duplicate
        # guard returns before advancing when the owner's vote is already
        # in (the owner's Commit can arrive before a slow node's digest), so
        # such a node sits in READY for good on a live cluster.  Advancing
        # here is a no-op whenever the guarded call already advanced.
        actions = self.apply_prepare_msg(self.owner, digest)
        return actions.concat(self.advance_state())

    def _prepare(self) -> Actions:
        self.q_entry = pb.QEntry(
            seq_no=self.seq_no,
            digest=self.digest or b"",
            requests=self.batch,
        )
        self.state = SeqState.PREPREPARED
        if hooks.enabled:
            hooks.milestone(
                "seq.preprepared",
                self.my_config.id,
                self.seq_no,
                epoch=self.epoch,
                bucket=seq_to_bucket(self.seq_no, self.network_config),
            )

        actions = Actions()
        if self.owner == self.my_config.id:
            # Forward request data to nodes that haven't ACKed having it.
            for cr in self.client_requests or ():
                agreements = cr.agreements
                missing = [
                    node_id
                    for node_id in self.network_config.nodes
                    if not agreements & (1 << node_id)
                ]
                actions.forward_request(missing, cr.ack)
            actions.send(
                self.network_config.nodes,
                pb.Msg(
                    type=pb.Preprepare(
                        seq_no=self.seq_no, epoch=self.epoch, batch=self.batch
                    )
                ),
            )
        else:
            actions.send(
                self.network_config.nodes,
                pb.Msg(
                    type=pb.Prepare(
                        seq_no=self.seq_no,
                        epoch=self.epoch,
                        digest=self.digest or b"",
                    )
                ),
            )
        return actions.concat(self.persisted.add_q_entry(self.q_entry))

    def apply_prepare_msg(self, source: int, digest: bytes | None) -> Actions:
        choice = self._node_choice(source)
        # Duplicate-prepare guard for every source.  (The reference exempts
        # the owner, sequence.go:263-269, which lets the owner's vote be
        # counted twice at its own node — once from the batch hash result
        # and once from the self-delivered Preprepare — shaving a node off
        # the effective prepare quorum there.)
        if choice.state > _NodeState.UNINITIALIZED:
            return Actions()
        choice.state = _NodeState.PREPREPARED
        choice.digest = digest
        key = digest or b""
        self._prepares[key] = self._prepares.get(key, 0) + 1
        return self.advance_state()

    def _check_prepare_quorum(self) -> Actions:
        key = self.digest or b""
        agreements = self._prepares.get(key, 0)

        # Our own prepare must be in (ensures our QEntry persist was issued).
        my_choice = self._node_choice(self.my_config.id)
        if my_choice.state < _NodeState.PREPREPARED:
            return Actions()
        if (my_choice.digest or b"") != key:
            # The network agreed on a different digest than ours; we cannot
            # participate further in this sequence.
            return Actions()

        if agreements < intersection_quorum(self.network_config):
            return Actions()

        self.state = SeqState.PREPARED
        if hooks.enabled:
            hooks.milestone(
                "seq.prepared",
                self.my_config.id,
                self.seq_no,
                epoch=self.epoch,
                bucket=seq_to_bucket(self.seq_no, self.network_config),
            )

        actions = Actions().send(
            self.network_config.nodes,
            pb.Msg(
                type=pb.Commit(
                    seq_no=self.seq_no, epoch=self.epoch, digest=key
                )
            ),
        )
        return actions.concat(
            self.persisted.add_p_entry(
                pb.PEntry(seq_no=self.seq_no, digest=key)
            )
        )

    # -- commit --------------------------------------------------------------

    def apply_commit_msg(self, source: int, digest: bytes | None) -> Actions:
        choice = self._node_choice(source)
        if choice.state > _NodeState.PREPREPARED:
            return Actions()
        choice.state = _NodeState.PREPARED
        key = digest or b""
        self._commits[key] = self._commits.get(key, 0) + 1
        return self.advance_state()

    def _check_commit_quorum(self) -> None:
        key = self.digest or b""
        agreements = self._commits.get(key, 0)

        # Do not commit until we've sent our own commit (PEntry persisted).
        my_choice = self._node_choice(self.my_config.id)
        if my_choice.state < _NodeState.PREPARED:
            return

        if agreements < intersection_quorum(self.network_config):
            return

        self.state = SeqState.COMMITTED
        if hooks.enabled:
            hooks.milestone(
                "seq.commit_quorum",
                self.my_config.id,
                self.seq_no,
                epoch=self.epoch,
                bucket=seq_to_bucket(self.seq_no, self.network_config),
            )
