"""The durable apply journal.

``DurableChainLog`` started life in chaos/live.py as the live chaos
driver's application stand-in; now that a real application layer exists
it lives here, and the chaos driver (and the cluster worker) import it
from the app package.  Semantics are unchanged: every apply is fsynced
to an append-only JSONL file, WAL replay below the last durable seq_no
is skipped, and state-transfer adoption is its own record kind.

New here: **payload mode**.  With a ``data_source`` (the request store's
``get``), each apply record also captures the request payloads, making
the journal a self-contained local replay source: after a restart the
commit stream rebuilds the state machine from its last persisted
snapshot plus the journal records above it, without depending on the
request store still holding pruned payloads.
"""

from __future__ import annotations

import hashlib
import json
import os
import time

from .. import pb
from ..runtime.processor import Log


class DurableChainLog(Log):
    """The runtime application under chaos: a hash-chain Log whose every
    apply is fsynced to an append-only JSONL file — the live analogue of
    the testengine's per-node NodeState evidence, and the ground truth
    for the no-fork / durable-prefix audits.

    WAL replay after a restart re-delivers committed entries; applies at
    or below the last durable seq_no are skipped, so the on-disk log (and
    the exactly-once audit reading it) never records a replay twice.
    State-transfer adoption is its own record kind: the chain jumps, and
    the skipped range stays absent (adopted, not individually committed).
    """

    def __init__(
        self,
        path: str,
        node_id: int,
        on_commit=None,
        timestamps=False,
        data_source=None,
    ):
        self.path = path
        self.node_id = node_id
        self.on_commit = on_commit
        # Stamp apply records with monotonic ns (CLOCK_MONOTONIC is
        # system-wide on one host, so a loadgen process on the same
        # machine computes submit→commit latency by subtraction).
        self.timestamps = timestamps
        # Payload mode: callable(RequestAck) -> bytes | None, consulted
        # at apply time (before the request store prunes the entry).
        self.data_source = data_source
        self.chain = b""
        self.commits: list = []  # [(client_id, req_no, seq_no)]
        self.last_seq = 0
        # Records with payloads read back at load, for the commit stream
        # to replay above its snapshot floor; drained once via
        # ``drain_replay`` so the payload bytes don't live forever.
        self._pending_replay: list = []  # [(seq, [(cid, rno, digest, data)])]
        if os.path.exists(path):
            self._load()
        self._file = open(path, "ab")

    def _load(self) -> None:
        with open(self.path, "rb") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    break  # torn tail write from a crash: ignore it
                self.chain = bytes.fromhex(rec["chain"])
                self.last_seq = rec["seq"]
                if rec["t"] == "apply":
                    for client_id, req_no, _digest in rec["reqs"]:
                        self.commits.append((client_id, req_no, rec["seq"]))
                    if "data" in rec:
                        ops = [
                            (cid, rno, bytes.fromhex(dig), bytes.fromhex(dat))
                            for (cid, rno, dig), dat in zip(
                                rec["reqs"], rec["data"]
                            )
                        ]
                        self._pending_replay.append((rec["seq"], ops))
                elif rec["t"] == "adopt":
                    # Everything below an adoption came in as one snapshot;
                    # per-entry replay records before it are superseded.
                    self._pending_replay.clear()

    def drain_replay(self, from_seq: int) -> list:
        """Return (and forget) the payload-bearing apply records above
        ``from_seq``, oldest first: the commit stream's restart replay
        source between its last persisted snapshot and the crash point."""
        out = [(seq, ops) for seq, ops in self._pending_replay if seq > from_seq]
        self._pending_replay = []
        return out

    def _record(self, rec: dict) -> None:
        self._file.write(json.dumps(rec).encode() + b"\n")
        self._file.flush()
        os.fsync(self._file.fileno())

    def apply(self, q_entry: pb.QEntry) -> None:
        if q_entry.seq_no <= self.last_seq:
            return  # WAL replay of an already-durable entry
        reqs = []
        data = []
        for ack in q_entry.requests:
            h = hashlib.sha256()
            h.update(self.chain)
            h.update(ack.digest)
            self.chain = h.digest()
            self.commits.append((ack.client_id, ack.req_no, q_entry.seq_no))
            reqs.append((ack.client_id, ack.req_no, ack.digest.hex()))
            if self.data_source is not None:
                payload = self.data_source(ack)
                data.append((payload or b"").hex())
        self.last_seq = q_entry.seq_no
        rec = {
            "t": "apply",
            "seq": q_entry.seq_no,
            "reqs": reqs,
            "chain": self.chain.hex(),
        }
        if self.data_source is not None:
            rec["data"] = data
        if self.timestamps:
            rec["ts_ns"] = time.monotonic_ns()
        self._record(rec)
        if reqs and self.on_commit is not None:
            self.on_commit(self.node_id, len(reqs))

    def adopt(self, value: bytes, seq_no: int) -> None:
        """State transfer: adopt a peer's checkpointed app state."""
        self.chain = value
        if seq_no > self.last_seq:
            self.last_seq = seq_no
        self._record({"t": "adopt", "seq": seq_no, "chain": value.hex()})

    def snap(self, network_config, clients_state) -> bytes:
        return self.chain

    def close(self) -> None:
        self._file.close()

    def crash(self) -> None:
        # Every apply already fsynced, so a crash loses nothing here; the
        # distinction matters for the WAL/reqstore, whose sync cadence is
        # the runtime's.
        self._file.close()
