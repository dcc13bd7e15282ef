"""The replicated KV state machine.

Writes are Mir batches: a client encodes an op with ``encode_put`` /
``encode_delete`` / ``encode_cas``, submits it as an ordinary
``pb.Request`` payload, and the commit stream delivers it to
``KvStore.apply`` in the consensus order with a monotone apply index.
Apply is a pure function of (op bytes, apply_index): every replica that
applies the same ordered prefix holds byte-identical state, which is
what lets the checkpoint value bind the store's digest.

Versions ARE apply indexes: a key's version is the apply index of the
op that last wrote it.  That gives reads a total-order coordinate for
free (the linearizability checker compares versions, never wall
clocks), and gives ``cas`` a precise expected-version predicate.

Malformed op bytes apply as a deterministic no-op — a garbage payload
must not fork replicas that all agree it is garbage.
"""

from __future__ import annotations

import hashlib
import struct
import threading

_OP_PUT = 1
_OP_DELETE = 2
_OP_CAS = 3
_OP_NOOP = 4

_SNAP_MAGIC = b"MKV1"


def encode_put(key: str, value: bytes) -> bytes:
    kb = key.encode()
    return struct.pack(">BH", _OP_PUT, len(kb)) + kb + struct.pack(
        ">I", len(value)
    ) + value


def encode_delete(key: str) -> bytes:
    kb = key.encode()
    return struct.pack(">BH", _OP_DELETE, len(kb)) + kb


def encode_cas(key: str, expect_version: int, value: bytes) -> bytes:
    """Compare-and-swap on a key's *version* (0 == absent)."""
    kb = key.encode()
    return (
        struct.pack(">BH", _OP_CAS, len(kb))
        + kb
        + struct.pack(">QI", expect_version, len(value))
        + value
    )


def encode_noop() -> bytes:
    return struct.pack(">BH", _OP_NOOP, 0)


def decode_op(data: bytes) -> dict | None:
    """Decode an op payload; None for anything malformed (the apply path
    treats that as a deterministic no-op)."""
    try:
        kind, klen = struct.unpack_from(">BH", data, 0)
        off = 3
        key = data[off : off + klen].decode()
        if len(data) < off + klen:
            return None
        off += klen
        if kind == _OP_PUT:
            (vlen,) = struct.unpack_from(">I", data, off)
            off += 4
            value = data[off : off + vlen]
            if len(value) != vlen:
                return None
            return {"kind": "put", "key": key, "value": value}
        if kind == _OP_DELETE:
            return {"kind": "delete", "key": key}
        if kind == _OP_CAS:
            expect, vlen = struct.unpack_from(">QI", data, off)
            off += 12
            value = data[off : off + vlen]
            if len(value) != vlen:
                return None
            return {
                "kind": "cas",
                "key": key,
                "expect_version": expect,
                "value": value,
            }
        if kind == _OP_NOOP:
            return {"kind": "noop"}
        return None
    except (struct.error, UnicodeDecodeError):
        return None


class KvStore:
    """put/get/delete/cas over ``key -> (value, version)``.

    ``apply`` runs on the commit stream's app thread; reads come from
    service threads — the internal lock keeps the two coherent without
    the stream needing to know what the state machine stores.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._data: dict = {}  # key -> (value bytes, version int)
        self.applies = 0  # ops absorbed (replay-visible; tests assert on it)

    # -- commit stream contract ------------------------------------------

    def apply(self, client_id, req_no, seq_no, apply_index, data) -> dict:
        op = decode_op(data)
        with self._lock:
            self.applies += 1
            if op is None:
                return {"outcome": "malformed", "version": 0}
            kind = op["kind"]
            if kind == "put":
                self._data[op["key"]] = (op["value"], apply_index)
                return {"outcome": "ok", "version": apply_index}
            if kind == "delete":
                had = self._data.pop(op["key"], None)
                return {
                    "outcome": "ok" if had is not None else "not_found",
                    "version": apply_index,
                }
            if kind == "cas":
                current = self._data.get(op["key"], (b"", 0))[1]
                if current == op["expect_version"]:
                    self._data[op["key"]] = (op["value"], apply_index)
                    return {"outcome": "ok", "version": apply_index}
                return {"outcome": "cas_conflict", "version": current}
            return {"outcome": "ok", "version": 0}  # noop

    def snapshot(self) -> bytes:
        """Deterministic encoding (sorted keys) of the full store."""
        with self._lock:
            items = sorted(self._data.items())
        parts = [_SNAP_MAGIC, struct.pack(">I", len(items))]
        for key, (value, version) in items:
            kb = key.encode()
            parts.append(struct.pack(">H", len(kb)))
            parts.append(kb)
            parts.append(struct.pack(">QI", version, len(value)))
            parts.append(value)
        return b"".join(parts)

    def restore(self, blob: bytes) -> None:
        if blob[:4] != _SNAP_MAGIC:
            raise ValueError("bad kv snapshot magic")
        (count,) = struct.unpack_from(">I", blob, 4)
        off = 8
        data = {}
        for _ in range(count):
            (klen,) = struct.unpack_from(">H", blob, off)
            off += 2
            key = blob[off : off + klen].decode()
            off += klen
            version, vlen = struct.unpack_from(">QI", blob, off)
            off += 12
            data[key] = (blob[off : off + vlen], version)
            off += vlen
        with self._lock:
            self._data = data

    def digest(self) -> bytes:
        """State digest binding the checkpoint value to the full store."""
        return hashlib.sha256(self.snapshot()).digest()

    # -- read path --------------------------------------------------------

    def get(self, key: str):
        """-> (value bytes | None, version int); (None, 0) when absent."""
        with self._lock:
            entry = self._data.get(key)
        return entry if entry is not None else (None, 0)

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)
