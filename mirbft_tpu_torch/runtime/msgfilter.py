"""Structural preflight validation of inbound wire messages.

Rebuild of the reference's preProcess (reference: msgfilter.go:18-105),
run in the *caller's* thread by Node.step before the message enters the
serializer.  The codec already rejects unset oneofs on decode; this guards
required nested fields for messages constructed in-process or decoded from
peers, and bounds the variable-size fields so a flooding peer cannot ship
arbitrarily large Preprepares, payloads, or digests past ingress.
"""

from __future__ import annotations

from .. import pb

# Fallback bounds when the caller passes no Config (testengine paths).
# Generous relative to honest traffic: batches are batch_size acks (cut
# smaller on heartbeats), payloads are application requests, digests are
# sha256 (32 bytes) — honest messages sit far below all three.
_DEFAULT_MAX_BATCH_ACKS = 256
_DEFAULT_MAX_REQUEST_BYTES = 1024 * 1024
_DEFAULT_MAX_DIGEST_BYTES = 64
_DEFAULT_MAX_SNAPSHOT_CHUNK_BYTES = 256 * 1024
_DEFAULT_MAX_SNAPSHOT_BYTES = 64 * 1024 * 1024


class MalformedMessage(ValueError):
    """Preflight rejection.  ``kind`` labels the failure for the
    ``mirbft_byzantine_rejections_total`` taxonomy: ``malformed``
    (structural), ``oversized_batch``, ``oversized_payload``,
    ``oversized_digest``, ``oversized_snapshot_chunk`` (state-transfer
    ingress, see check_snapshot_chunk), or ``bad_mac`` (a replica-plane
    frame whose link MAC failed, see check_frame_mac)."""

    def __init__(self, message: str, kind: str = "malformed"):
        super().__init__(message)
        self.kind = kind


def check_frame_mac(link_auth, peer: int, payload: bytes):
    """MAC ingress check for a replica-plane transport frame.

    ``link_auth`` is the node's crypto/mac.LinkAuthenticator, ``peer``
    the claimed sender (which selects the link key — a forged claim
    fails the tag like any other tamper).  Returns ``(verified_payload,
    None)`` with the tag stripped, or ``(None, kind)`` naming the
    rejection: ``short_frame`` (too short to even carry a tag) or
    ``bad_mac`` (tag present but wrong).  The transport counts the kind
    into ``mirbft_mac_rejections_total``; callers that prefer the
    exception taxonomy can raise ``MalformedMessage(..., kind=kind)``.
    """
    from ..crypto.mac import TAG_LEN

    if len(payload) <= TAG_LEN:
        return None, "short_frame"
    body = link_auth.open(peer, payload)
    if body is None:
        return None, "bad_mac"
    return body, None


def _check_digest(digest: bytes, limit: int, what: str) -> None:
    if len(digest) > limit:
        raise MalformedMessage(
            f"{what} digest is {len(digest)} bytes (max {limit})",
            kind="oversized_digest",
        )


def _check_acks(acks, max_acks: int, max_digest: int, what: str) -> None:
    if len(acks) > max_acks:
        raise MalformedMessage(
            f"{what} carries {len(acks)} acks (max {max_acks})",
            kind="oversized_batch",
        )
    for ack in acks:
        _check_digest(ack.digest, max_digest, f"{what} ack")


def check_snapshot_chunk(
    payload_len: int, total_chunks: int, limits=None
) -> None:
    """Ingress bound for state-transfer chunk frames (which are not
    pb.Msg and so bypass pre_process): reject any chunk whose payload
    exceeds the per-chunk cap, and any chunk count that would let the
    full reassembly exceed the snapshot cap — a byzantine donor must not
    be able to OOM a fetcher with one huge chunk or a chunk flood."""
    max_chunk = getattr(
        limits, "max_snapshot_chunk_bytes", _DEFAULT_MAX_SNAPSHOT_CHUNK_BYTES
    )
    max_total = getattr(
        limits, "max_snapshot_bytes", _DEFAULT_MAX_SNAPSHOT_BYTES
    )
    if payload_len > max_chunk:
        raise MalformedMessage(
            f"snapshot chunk is {payload_len} bytes (max {max_chunk})",
            kind="oversized_snapshot_chunk",
        )
    if total_chunks < 1 or total_chunks * max_chunk > max_total:
        raise MalformedMessage(
            f"snapshot of {total_chunks} chunks may exceed "
            f"{max_total} bytes",
            kind="oversized_snapshot_chunk",
        )


def pre_process(msg: pb.Msg, limits=None) -> None:
    """Validate structure and size bounds.  ``limits`` is a runtime
    ``Config`` (or any object with ``max_batch_acks`` /
    ``max_request_bytes`` / ``max_digest_bytes``); omitted attributes
    fall back to the module defaults."""
    max_acks = getattr(limits, "max_batch_acks", _DEFAULT_MAX_BATCH_ACKS)
    max_payload = getattr(
        limits, "max_request_bytes", _DEFAULT_MAX_REQUEST_BYTES
    )
    max_digest = getattr(
        limits, "max_digest_bytes", _DEFAULT_MAX_DIGEST_BYTES
    )
    inner = msg.type
    if inner is None:
        raise MalformedMessage("message has no type set")
    if isinstance(inner, pb.ForwardRequest):
        if inner.request_ack is None:
            raise MalformedMessage("ForwardRequest without request_ack")
        _check_digest(
            inner.request_ack.digest, max_digest, "ForwardRequest"
        )
        if len(inner.request_data) > max_payload:
            raise MalformedMessage(
                f"ForwardRequest payload is {len(inner.request_data)} "
                f"bytes (max {max_payload})",
                kind="oversized_payload",
            )
    elif isinstance(inner, pb.Preprepare):
        _check_acks(inner.batch, max_acks, max_digest, "Preprepare")
    elif isinstance(inner, pb.ForwardBatch):
        _check_acks(
            inner.request_acks, max_acks, max_digest, "ForwardBatch"
        )
        _check_digest(inner.digest, max_digest, "ForwardBatch")
    elif isinstance(
        inner, (pb.Prepare, pb.Commit, pb.FetchBatch, pb.RequestAck, pb.FetchRequest)
    ):
        _check_digest(inner.digest, max_digest, type(inner).__name__)
    elif isinstance(inner, pb.NewEpoch):
        cfg = inner.new_config
        if cfg is None:
            raise MalformedMessage("NewEpoch without new_config")
        if cfg.config is None:
            raise MalformedMessage("NewEpoch without new_config.config")
        if cfg.starting_checkpoint is None:
            raise MalformedMessage("NewEpoch without starting_checkpoint")
    elif isinstance(inner, (pb.NewEpochEcho, pb.NewEpochReady)):
        cfg = inner.new_epoch_config
        if cfg is None:
            raise MalformedMessage(
                f"{type(inner).__name__} without new_epoch_config"
            )
        if cfg.config is None or cfg.starting_checkpoint is None:
            raise MalformedMessage(
                f"{type(inner).__name__} config incomplete"
            )
    elif isinstance(inner, pb.EpochChangeAck):
        if inner.epoch_change is None:
            raise MalformedMessage("EpochChangeAck without epoch_change")
    elif not isinstance(
        inner, (pb.Suspect, pb.Checkpoint, pb.EpochChange)
    ):
        raise MalformedMessage(f"unknown message type {type(inner).__name__}")
