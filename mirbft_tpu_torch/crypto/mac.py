"""Per-link MAC authenticators for the replica-to-replica plane.

PBFT's scaling argument (Castro & Liskov, OSDI '99 §2) is that
public-key signatures belong only on client requests and certificates;
everything replicas say to each other rides symmetric MAC
authenticators, three orders of magnitude cheaper.  This module is the
sanctioned seam for that machinery: pairwise session keys derived from
a cluster secret, fixed-width HMAC-SHA256 tags appended to transport
frames, and constant-time verification at ingress.

Key schedule: ``link_key(secret, a, b)`` is symmetric in (a, b) — one
session key per undirected link, matching TCP's one-socket-per-peer
model in `runtime/transport.py`.  A real deployment would run a key
exchange; the harness derives keys from a shared ``auth_secret`` so
every node computes the same schedule without a handshake, which is
exactly the MAC trust model (authenticity between the two honest
endpoints, no third-party verifiability — why certificates still need
signatures).

Everything here is host-side ``hmac``/``hashlib``; lint rule W21 confines
those primitives to this package, `ops/`, and
`testengine/signing.py`.
"""

from __future__ import annotations

import hashlib
import hmac

# Tag width in bytes.  16 (128-bit) matches the forgery bound of the
# RLC batch verifier and halves frame overhead vs a full SHA-256 tag.
TAG_LEN = 16

_KEY_CONTEXT = b"mirbft-link-mac-v1"


def link_key(secret: bytes, a: int, b: int) -> bytes:
    """Derive the symmetric session key for the undirected link {a, b}."""
    lo, hi = (a, b) if a <= b else (b, a)
    ctx = _KEY_CONTEXT + lo.to_bytes(8, "little") + hi.to_bytes(8, "little")
    return hmac.new(secret, ctx, hashlib.sha256).digest()


def tag(key: bytes, payload: bytes) -> bytes:
    """MAC tag over a frame payload (truncated HMAC-SHA256)."""
    return hmac.new(key, payload, hashlib.sha256).digest()[:TAG_LEN]


def verify(key: bytes, payload: bytes, tag_bytes: bytes) -> bool:
    """Constant-time tag check."""
    if len(tag_bytes) != TAG_LEN:
        return False
    expected = hmac.new(key, payload, hashlib.sha256).digest()[:TAG_LEN]
    return hmac.compare_digest(expected, tag_bytes)


class LinkAuthenticator:
    """One node's view of the pairwise key schedule.

    ``seal`` appends a tag for the link to ``peer``; ``open`` checks and
    strips the tag of an inbound frame claiming to come from ``peer``.
    Keys are derived lazily and cached — the schedule is O(peers), not
    O(n^2), per node.
    """

    def __init__(self, node_id: int, secret: bytes):
        self.node_id = node_id
        self._secret = secret
        self._keys: dict[int, bytes] = {}

    def _key(self, peer: int) -> bytes:
        key = self._keys.get(peer)
        if key is None:
            key = link_key(self._secret, self.node_id, peer)
            self._keys[peer] = key
        return key

    def seal(self, peer: int, payload: bytes) -> bytes:
        return payload + tag(self._key(peer), payload)

    def open(self, peer: int, payload: bytes):
        """Verified payload without its tag, or None on a bad/short tag."""
        if len(payload) <= TAG_LEN:
            return None
        body, tag_bytes = payload[:-TAG_LEN], payload[-TAG_LEN:]
        if not verify(self._key(peer), body, tag_bytes):
            return None
        return body
