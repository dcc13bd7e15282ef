"""Checkpoint quorum certificates: BLS multi-signatures over stability.

BASELINE ladder rung 4's protocol integration: every Checkpoint message a
replica broadcasts doubles as a BLS vote over the statement
(seq_no, checkpoint value).  When 2f+1 replicas have announced the same
statement, the certificate plane aggregates their G1 signatures — on the
card, in batch (ops/bls_g1.py) — into one constant-size quorum
certificate that any external verifier checks with a single pairing
equation (crypto/bls_host.py), no transcript of 2f+1 messages needed.

This is consumer-side machinery riding the engine's executor (the
reference leaves proofs-of-stability to the application layer entirely);
determinism is untouched because certificates are derived from, and feed
nothing back into, the event stream.
"""

from __future__ import annotations

from .. import pb
from ..crypto import qc


def node_seed(node_id: int) -> bytes:
    return b"mirbft-tpu-bls-node" + node_id.to_bytes(13, "big")


def statement(seq_no: int, value: bytes) -> bytes:
    return b"checkpoint %d " % seq_no + value


class CheckpointCertPlane:
    """Collects checkpoint votes from the engine's send stream and turns
    quorums into aggregated certificates.

    Install via ``Recorder(checkpoint_certs=plane)``; the engine calls
    ``observe`` for every Checkpoint broadcast.  Aggregation is deferred:
    pending quorums accumulate and aggregate as one launch when
    ``certificates()`` is called (or a cert is first read), the same
    coalescing pattern as the digest plane.

    ``use_device`` (the default) aggregates with ``ops/bls_g1`` on
    ``device``: the kernel on ``cuda``, which raises without a card, or
    its plain version on ``cpu``.  ``use_device=False`` folds on the host
    (``bls_host``), and only then.  ``device_batches`` counts the
    aggregations sent to ``ops/bls_g1`` and ``host_folds`` the
    certificates folded on the host."""

    def __init__(self, quorum: int, use_device: bool = True, device="cuda"):
        self.quorum = quorum
        self.use_device = use_device
        self.device = device
        self.device_batches = 0
        self.host_folds = 0
        # (seq_no, value) -> {node_id: G1 signature point}
        self._votes: dict = {}
        self._pending: list = []  # quorum-reached keys awaiting aggregation
        self._certs: dict = {}  # (seq_no, value) -> (sorted signers, asig)

    def observe(self, node_id: int, msg: pb.Msg) -> None:
        inner = msg.type
        if not isinstance(inner, pb.Checkpoint):
            return
        key = (inner.seq_no, inner.value)
        votes = self._votes.setdefault(key, {})
        if node_id in votes:
            return  # retransmission
        if key in self._certs or len(votes) >= self.quorum:
            # The certificate is already settled (or pending): don't pay a
            # scalar multiplication for a vote that can never be used.
            return
        votes[node_id] = qc.sign_vote(
            node_seed(node_id), statement(inner.seq_no, inner.value)
        )
        if len(votes) == self.quorum:
            self._pending.append(key)

    def _aggregate_pending(self) -> None:
        if not self._pending:
            return
        keys = self._pending
        self._pending = []
        certs = [
            [sig for _node, sig in sorted(self._votes[key].items())][
                : self.quorum
            ]
            for key in keys
        ]
        if self.use_device:
            from ..ops.bls_g1 import aggregate_signatures

            aggregated = aggregate_signatures(certs, device=self.device)
            self.device_batches += 1
        else:
            aggregated = [qc.aggregate(c, use_device=False) for c in certs]
            self.host_folds += len(certs)
        for key, asig in zip(keys, aggregated):
            signers = sorted(self._votes[key])[: self.quorum]
            self._certs[key] = (signers, asig)

    def certificates(self) -> dict:
        """(seq_no, value) -> (signer ids, aggregate G1 signature)."""
        self._aggregate_pending()
        return dict(self._certs)

    @staticmethod
    def verify(seq_no: int, value: bytes, signers, asig) -> bool:
        """External check: one pairing equation against the signer set's
        aggregate public key (crypto/qc.py counts the outcome)."""
        pks = [qc.public_key(node_seed(n)) for n in signers]
        return qc.verify_cert(pks, statement(seq_no, value), asig)
