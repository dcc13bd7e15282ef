"""Reconfiguration requests on the wire, and the one shared
checkpoint-state helper.

Mir-BFT orders configuration changes like any other request
(arXiv:1906.05552 §IV): a client submits an opaque payload, the batch
commits through the normal broadcast path, and the *application* layer
recognises it as a reconfiguration and hands it back to the protocol via
``CheckpointResult.reconfigurations`` — to be applied atomically at the
next stable checkpoint (``core.commitstate.next_network_config``).

This module owns the payload format (a magic prefix so the commit path
can recognise reconfiguration requests with one ``startswith`` and zero
extra I/O) and ``checkpoint_network_state`` — the single place a runtime
embedder turns a ``CheckpointResult`` into the ``pb.NetworkState`` it
stamps on snapshots and checkpoint records.  Every embedder (cluster
worker, loadgen in-process replica, live chaos replica) must build that
state here so none can drop ``pending_reconfigurations`` and fork the
adoption path.
"""

from __future__ import annotations

import struct

from .. import pb

# One magic byte sequence in front of the encoded payload.  A leading
# NUL keeps it out of the printable keyspace the KV app and the load
# generators use, so ordinary application payloads can never collide.
RECONFIG_MAGIC = b"\x00mirbft-reconfig/1\x00"

_LEN = struct.Struct(">I")


def reconfig_kind(reconfig: pb.Reconfiguration) -> str:
    """The metrics/label name for a reconfiguration arm."""
    change = reconfig.type
    if isinstance(change, pb.ReconfigNewClient):
        return "new_client"
    if isinstance(change, pb.ReconfigRemoveClient):
        return "remove_client"
    if isinstance(change, pb.NetworkConfig):
        return "network_config"
    return "unknown"


def encode_reconfig_request(reconfigs) -> bytes:
    """Serialize an ordered list of ``pb.Reconfiguration`` into a request
    payload: magic prefix, then length-prefixed encoded entries."""
    parts = [RECONFIG_MAGIC]
    for reconfig in reconfigs:
        body = pb.encode(reconfig)
        parts.append(_LEN.pack(len(body)))
        parts.append(body)
    return b"".join(parts)


def is_reconfig_request(data: bytes) -> bool:
    return data.startswith(RECONFIG_MAGIC)


def decode_reconfig_request(data: bytes):
    """The reconfigurations carried by a request payload, or ``None`` if
    the payload is not a reconfiguration request.  A payload that carries
    the magic but is malformed decodes to an empty list — the request
    still committed everywhere in the same order, so every correct node
    must draw the same (empty) conclusion from it rather than crash."""
    if not data.startswith(RECONFIG_MAGIC):
        return None
    out = []
    offset = len(RECONFIG_MAGIC)
    try:
        while offset < len(data):
            (length,) = _LEN.unpack_from(data, offset)
            offset += _LEN.size
            body = data[offset : offset + length]
            if len(body) != length:
                return []
            offset += length
            out.append(pb.decode(pb.Reconfiguration, body))
    except Exception:  # noqa: BLE001 — malformed is a same-everywhere no-op
        return []
    return out


def checkpoint_network_state(cr) -> pb.NetworkState:
    """The ``pb.NetworkState`` for a runtime ``CheckpointResult`` —
    config and client set from the checkpoint request, plus the
    reconfigurations that committed inside the window (the part the
    embedders used to hand-copy, and one of them would eventually have
    dropped)."""
    return pb.NetworkState(
        config=cr.checkpoint.network_config,
        clients=cr.checkpoint.clients_state,
        pending_reconfigurations=list(cr.reconfigurations),
    )
