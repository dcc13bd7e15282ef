"""The port's replicated application layer (mirbft_tpu_torch/app/) held
against the JAX package's.

The cases of tests/test_app.py:57-750 on the port: the KV state machine
(op codec, deterministic apply, versions as apply indexes, snapshot
round trip), the commit stream (ordered exactly-once delivery, waiters,
restart resume, snapshot-install fast-forward, bounded-queue backpressure,
the read-index barrier, and the SIGKILL atomicity of the applied index and
the snapshot blob, with a port subprocess), the service seam (framing, the
KvService/KvClient socket loopback, a 4-node InProcessCluster KV smoke on
the digest kernel's plain version), the linearizable-reads audit through
the port's chaos/invariants.py, and the KV loadgen plumbing.  Then parity:
one seeded op stream through the port's and the JAX package's KvStore
(every apply result, every snapshot and digest byte for byte), the
state-blob codec and the app-state files, and the slice as a whole: one
seeded session through the port's cluster answered as the JAX KvStore
answers, ending at its snapshot bytes on every replica.  Every comparison
is exact (the KV rung with its restarted replica runs on worker processes:
tests/test_torch_app_mp.py).

Not mirrored: the KV chaos scenarios on a multi-process cluster
(tests/test_app.py:751, 768), which need the unported cluster/.
"""

import os
import signal
import socket
import struct
import subprocess
import sys
import textwrap
import threading
import time

import pytest

from mirbft_tpu_torch import pb
from mirbft_tpu_torch.app import kvstore
from mirbft_tpu_torch.app.kvstore import KvStore
from mirbft_tpu_torch.app.service import (
    KvClient,
    KvFrontend,
    KvService,
    recv_frame,
    send_frame,
)
from mirbft_tpu_torch.app.stream import (
    CommitStream,
    decode_state,
    encode_state,
    state_binding,
)
from mirbft_tpu_torch.chaos.invariants import (
    InvariantViolation,
    check_linearizable_reads,
)


# ---------------------------------------------------------------------------
# KV state machine
# ---------------------------------------------------------------------------


def test_kv_op_codec_roundtrip():
    put = kvstore.decode_op(kvstore.encode_put("alpha", b"\x00\xffv"))
    assert put == {"kind": "put", "key": "alpha", "value": b"\x00\xffv"}
    delete = kvstore.decode_op(kvstore.encode_delete("beta"))
    assert delete == {"kind": "delete", "key": "beta"}
    cas = kvstore.decode_op(kvstore.encode_cas("gamma", 7, b"new"))
    assert cas == {
        "kind": "cas",
        "key": "gamma",
        "expect_version": 7,
        "value": b"new",
    }
    assert kvstore.decode_op(kvstore.encode_noop()) == {"kind": "noop"}


def test_kv_malformed_ops_decode_to_none():
    assert kvstore.decode_op(b"") is None
    assert kvstore.decode_op(b"\x09\x00\x01x") is None  # unknown kind
    # Truncated put value: declared length runs past the payload.
    good = kvstore.encode_put("k", b"0123456789")
    assert kvstore.decode_op(good[:-4]) is None


def test_kv_apply_versions_are_apply_indexes():
    store = KvStore()
    r1 = store.apply(1, 0, 1, 10, kvstore.encode_put("k", b"a"))
    assert r1 == {"outcome": "ok", "version": 10}
    assert store.get("k") == (b"a", 10)
    # cas against the stale version loses and reports the current one.
    r2 = store.apply(1, 1, 2, 11, kvstore.encode_cas("k", 3, b"x"))
    assert r2 == {"outcome": "cas_conflict", "version": 10}
    assert store.get("k") == (b"a", 10)
    r3 = store.apply(1, 2, 3, 12, kvstore.encode_cas("k", 10, b"b"))
    assert r3 == {"outcome": "ok", "version": 12}
    assert store.get("k") == (b"b", 12)
    r4 = store.apply(2, 0, 4, 13, kvstore.encode_delete("k"))
    assert r4["outcome"] == "ok"
    assert store.get("k") == (None, 0)
    r5 = store.apply(2, 1, 5, 14, kvstore.encode_delete("k"))
    assert r5["outcome"] == "not_found"
    # Malformed bytes apply as a deterministic no-op, not a fork.
    r6 = store.apply(2, 2, 6, 15, b"\xff\xff\xff")
    assert r6 == {"outcome": "malformed", "version": 0}


def test_kv_apply_is_deterministic_across_replicas():
    ops = [
        kvstore.encode_put("a", b"1"),
        kvstore.encode_put("b", b"2"),
        kvstore.encode_cas("a", 1, b"3"),
        kvstore.encode_delete("b"),
        b"garbage-op",
        kvstore.encode_put("c", b"\x00" * 64),
    ]
    stores = [KvStore(), KvStore()]
    for store in stores:
        for index, data in enumerate(ops, start=1):
            store.apply(1, index, index, index, data)
    assert stores[0].snapshot() == stores[1].snapshot()
    assert stores[0].digest() == stores[1].digest()


def test_kv_snapshot_restore_roundtrip():
    store = KvStore()
    store.apply(1, 0, 1, 1, kvstore.encode_put("x", b"one"))
    store.apply(1, 1, 2, 2, kvstore.encode_put("y", b""))
    clone = KvStore()
    clone.restore(store.snapshot())
    assert clone.get("x") == (b"one", 1)
    assert clone.get("y") == (b"", 2)
    assert len(clone) == 2
    assert clone.snapshot() == store.snapshot()
    with pytest.raises(ValueError):
        clone.restore(b"not-a-snapshot")


# ---------------------------------------------------------------------------
# Commit stream
# ---------------------------------------------------------------------------


class RecordingApp:
    """A state machine that records every delivery (order + index)."""

    def __init__(self, gate=None):
        self.applied = []
        self.gate = gate  # optional Event: apply blocks until set

    def apply(self, client_id, req_no, seq_no, apply_index, data):
        if self.gate is not None:
            self.gate.wait()
        self.applied.append((client_id, req_no, seq_no, apply_index, data))
        return {"outcome": "ok", "version": apply_index}

    def snapshot(self):
        return struct.pack(">I", len(self.applied))

    def restore(self, blob):
        self.applied = [None] * struct.unpack(">I", blob)[0]


def _entry(seq, *reqs):
    return pb.QEntry(
        seq_no=seq,
        digest=b"d%d" % seq,
        requests=[
            pb.RequestAck(client_id=cid, req_no=rno) for cid, rno in reqs
        ],
    )


def _data_source(table):
    return lambda ack: table.get((ack.client_id, ack.req_no), b"")


def _write_across_an_install(package: str):
    """A home node's KvFrontend takes client 1's put of k (req_no 0) and,
    while it waits, the node installs a donor's snapshot at seq 1 whose
    checkpoint holds that request committed (ROADMAP queue 3, item 16).
    On the port the worker then calls ``answer_installed`` with the
    checkpoint's network state; the JAX package has no such step.
    Returns the frontend's answer (a 1 s op timeout)."""
    if package == "jax":
        from mirbft_tpu import pb as mod_pb
        from mirbft_tpu.app import kvstore as mod_kv
        from mirbft_tpu.app import service as mod_service
        from mirbft_tpu.app import stream as mod_stream
    else:
        from mirbft_tpu_torch import pb as mod_pb
        from mirbft_tpu_torch.app import kvstore as mod_kv
        from mirbft_tpu_torch.app import service as mod_service
        from mirbft_tpu_torch.app import stream as mod_stream
    table = {(1, 0): mod_kv.encode_put("k", b"v")}
    donor = mod_stream.CommitStream(mod_kv.KvStore(),
                                    data_source=_data_source(table))
    try:
        donor.apply(mod_pb.QEntry(seq_no=1, digest=b"d1", requests=[
            mod_pb.RequestAck(client_id=1, req_no=0)]))
        value = donor.snap(None, None)
        blob = donor.snapshot_blob(value)
    finally:
        donor.close()
    state = mod_pb.NetworkState(clients=[
        mod_pb.NetworkClient(id=1, width=2, low_watermark=1)])
    store = mod_kv.KvStore()
    home = mod_stream.CommitStream(store, data_source=_data_source(table))
    installed = []

    def install():
        installed.append(home.install(blob, value, 1))
        if package == "port":
            home.answer_installed(state, 1)

    def propose(_request):
        threading.Thread(target=install, daemon=True).start()

    try:
        return mod_service.KvFrontend(home, store, propose).execute({
            "op": "put", "key": "k", "value": b"v".hex(), "client_id": 1,
            "req_no": 0, "want_reply": True, "timeout": 1.0,
        }), installed, store.get("k")
    finally:
        home.close()


def test_a_write_inside_an_installed_snapshot_is_answered_on_the_port():
    """The JAX package's waiter is orphaned: the write committed, yet its
    client hears a timeout.  The port answers it from the op it holds:
    a put is ``ok``, at version 0 (not known here; the linearizability
    audit reads 0 as no version) and the installed frontier."""
    ref, ref_installed, ref_value = _write_across_an_install("jax")
    assert ref_installed == [True] and ref_value == (b"v", 1)
    assert ref["status"] == "timeout"
    port, installed, value = _write_across_an_install("port")
    assert installed == [True] and value == (b"v", 1)
    assert port == {"status": "ok", "version": 0, "index": 0,
                    "frontier": 1, "installed_seq": 1}


def test_answer_installed_reads_the_checkpoints_client_states():
    """Only waiters whose request the checkpoint holds committed (below
    the low watermark, or in the committed mask above it) are answered;
    the rest wait for their commit."""
    stream = CommitStream(RecordingApp())
    try:
        waiters = {key: stream.register_waiter(*key)
                   for key in [(1, 0), (1, 1), (1, 2), (1, 3), (2, 0)]}
        # Client 1: req 0 below the low watermark 1, req 2 in the mask
        # (bit 1 above it), reqs 1 and 3 not committed; client 2 absent.
        state = pb.NetworkState(clients=[pb.NetworkClient(
            id=1, width=4, low_watermark=1, committed_mask=b"\x40")])
        assert stream.answer_installed(state, 40) == 2
        assert waiters[(1, 0)].wait(0) == (0, {"installed_seq": 40})
        assert waiters[(1, 2)].wait(0) == (0, {"installed_seq": 40})
        assert all(waiters[key].wait(0) is None
                   for key in [(1, 1), (1, 3), (2, 0)])
        assert stream.status()["waiters"] == 3
    finally:
        stream.close()


def test_commit_stream_delivers_ordered_exactly_once():
    app = RecordingApp()
    table = {(1, 0): b"a", (1, 1): b"b", (2, 0): b"c"}
    stream = CommitStream(app, data_source=_data_source(table))
    try:
        stream.apply(_entry(1, (1, 0), (1, 1)))
        stream.apply(_entry(2))  # empty batch advances the seq frontier
        stream.apply(_entry(3, (2, 0)))
        # WAL replay re-delivers committed entries; at-or-below the
        # frontier they must be skipped, not re-applied.
        stream.apply(_entry(1, (1, 0), (1, 1)))
        stream.apply(_entry(3, (2, 0)))
        assert stream.drain()
    finally:
        stream.close()
    assert app.applied == [
        (1, 0, 1, 1, b"a"),
        (1, 1, 1, 2, b"b"),
        (2, 0, 3, 3, b"c"),
    ]
    assert stream.applied_seq == 3
    assert stream.applied_index == 3


def test_commit_stream_waiter_resolves_with_apply_result():
    store = KvStore()
    table = {(5, 0): kvstore.encode_put("k", b"v")}
    stream = CommitStream(store, data_source=_data_source(table))
    try:
        waiter = stream.register_waiter(5, 0)
        stream.apply(_entry(1, (5, 0)))
        got = waiter.wait(5.0)
        assert got is not None
        index, result = got
        assert index == 1
        assert result == {"outcome": "ok", "version": 1}
        # A waiter for an op that never commits times out and is
        # cancellable without leaking.
        stale = stream.register_waiter(5, 99)
        assert stale.wait(0.05) is None
        stream.cancel_waiter(5, 99)
        assert stream.status()["waiters"] == 0
    finally:
        stream.close()


def test_commit_stream_read_barrier_covers_frontier():
    gate = threading.Event()
    app = RecordingApp(gate=gate)
    table = {(1, 0): b"a"}
    stream = CommitStream(app, data_source=_data_source(table))
    try:
        stream.apply(_entry(1, (1, 0)))
        # The op is enqueued but not applied: a committed read must wait.
        ok, _waited, applied = stream.read_barrier(timeout=0.05)
        assert not ok
        gate.set()
        ok, _waited, applied = stream.read_barrier(timeout=5.0)
        assert ok
        assert applied >= 1
        # min_index above the frontier forces a wait past it.
        ok, _waited, _ = stream.read_barrier(min_index=99, timeout=0.05)
        assert not ok
    finally:
        stream.close()


def test_commit_stream_restart_resumes_applied_index(tmp_path):
    path = str(tmp_path / "app.state")
    table = {
        (1, 0): kvstore.encode_put("k0", b"a"),
        (1, 1): kvstore.encode_put("k1", b"b"),
        (1, 2): kvstore.encode_put("k2", b"c"),
    }
    store = KvStore()
    stream = CommitStream(store, state_path=path, data_source=_data_source(table))
    try:
        stream.apply(_entry(1, (1, 0), (1, 1)))
        value = stream.snap(None, None)
        assert state_binding(stream.last_snapshot_blob) == value
    finally:
        stream.close()

    # Restart: a fresh store + stream over the same state path resumes
    # the frontier; WAL replay of the snapshotted prefix is skipped and
    # new entries continue the apply-index sequence.
    store2 = KvStore()
    stream2 = CommitStream(
        store2, state_path=path, data_source=_data_source(table)
    )
    try:
        assert stream2.applied_seq == 1
        assert stream2.applied_index == 2
        assert store2.get("k0") == (b"a", 1)
        assert store2.get("k1") == (b"b", 2)
        assert store2.applies == 0  # restored, not re-applied
        stream2.apply(_entry(1, (1, 0), (1, 1)))  # replayed entry: skipped
        stream2.apply(_entry(2, (1, 2)))
        assert stream2.drain()
        assert store2.applies == 1
        assert store2.get("k2") == (b"c", 3)
    finally:
        stream2.close()


def test_commit_stream_snapshot_install_fast_forwards(tmp_path):
    table = {
        (1, n): kvstore.encode_put("k%d" % n, b"v%d" % n) for n in range(6)
    }
    donor_store = KvStore()
    donor = CommitStream(donor_store, data_source=_data_source(table))
    try:
        for seq in range(1, 7):
            donor.apply(_entry(seq, (1, seq - 1)))
        value = donor.snap(None, None)
        blob = donor.snapshot_blob(value)
        assert blob is not None
        assert blob == donor.last_snapshot_blob
    finally:
        donor.close()

    lagger_store = KvStore()
    lagger_path = str(tmp_path / "lagger.state")
    lagger = CommitStream(
        lagger_store, state_path=lagger_path, data_source=_data_source(table)
    )
    try:
        # A blob that doesn't bind to the certified value is refused.
        assert not lagger.install(blob, b"\x00" * 32, 6)
        assert not lagger.install(b"torn", state_binding(b"torn"), 6)
        assert lagger.install(blob, value, 6)
        assert lagger.applied_seq == 6
        assert lagger.applied_index == 6
        assert lagger.installs == 1
        assert lagger_store.get("k5") == (b"v5", 6)
        assert lagger_store.applies == 0  # adopted, never applied
        # The skipped range replayed from the WAL stays skipped; new
        # commits continue above the installed frontier.
        lagger.apply(_entry(3, (1, 2)))
        lagger.apply(_entry(7, (1, 0)))
        assert lagger.drain()
        assert lagger.applied_index == 7
        # The install also persisted: a restart resumes at the snapshot.
        status = lagger.status()
        assert status["applied_seq"] == 7
    finally:
        lagger.close()
    rebooted_store = KvStore()
    rebooted = CommitStream(
        rebooted_store, state_path=lagger_path, data_source=_data_source(table)
    )
    try:
        assert rebooted.applied_seq == 6
        assert rebooted_store.get("k0") == (b"v0", 1)
    finally:
        rebooted.close()


def test_commit_stream_backpressure_bounds_the_queue():
    gate = threading.Event()
    app = RecordingApp(gate=gate)
    table = {(1, n): b"x%d" % n for n in range(8)}
    stream = CommitStream(
        app, queue_depth=2, data_source=_data_source(table)
    )
    try:
        done = threading.Event()

        def producer():
            for seq in range(1, 9):
                stream.apply(_entry(seq, (1, seq - 1)))
            done.set()

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        # With the app blocked, the producer must stall on the bounded
        # queue instead of buffering all 8 ops.
        assert not done.wait(0.3)
        assert stream.status()["queue_len"] <= 2
        gate.set()
        assert done.wait(5.0)
        thread.join(timeout=5.0)
        assert stream.drain()
    finally:
        stream.close()
    assert [item[3] for item in app.applied] == list(range(1, 9))


def test_app_state_blob_codec_rejects_garbage():
    blob = encode_state(7, 42, b"chain", b"app-bytes")
    assert decode_state(blob) == (7, 42, b"chain", b"app-bytes")
    assert decode_state(b"XXXX" + blob) is None
    assert decode_state(blob[:10]) is None
    assert state_binding(blob) != state_binding(blob + b"x")


def test_sigkill_between_apply_and_snapshot_cannot_double_apply(tmp_path):
    """The applied index is persisted inside the app snapshot as one
    atomic write: SIGKILL at any point leaves a blob whose index
    describes exactly the state it travels with, so the restored store
    always equals the reference prefix of that length — never one op
    more or less (the double-apply / lost-apply regression)."""
    state_path = str(tmp_path / "app.state")
    child_src = textwrap.dedent(
        """
        import sys
        from mirbft_tpu_torch import pb
        from mirbft_tpu_torch.app import kvstore
        from mirbft_tpu_torch.app.kvstore import KvStore
        from mirbft_tpu_torch.app.stream import CommitStream

        state_path = sys.argv[1]
        table = {}
        stream = CommitStream(
            KvStore(),
            state_path=state_path,
            data_source=lambda ack: table[(ack.client_id, ack.req_no)],
        )
        seq = 0
        while True:
            seq += 1
            table[(1, seq)] = kvstore.encode_put(
                "k%d" % (seq % 4), bytes([seq % 256]) * 8
            )
            stream.apply(
                pb.QEntry(
                    seq_no=seq,
                    digest=b"d",
                    requests=[pb.RequestAck(client_id=1, req_no=seq)],
                )
            )
            stream.snap(None, None)
            print(seq, flush=True)
        """
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", child_src, state_path],
        stdout=subprocess.PIPE,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env,
    )
    try:
        last = 0
        deadline = time.monotonic() + 60.0
        while last < 5 and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            last = int(line)
        assert last >= 5, "child never reached 5 snapshots"
        proc.send_signal(signal.SIGKILL)
    finally:
        proc.kill()
        proc.wait(timeout=30)

    from mirbft_tpu_torch.runtime.storage import read_app_state

    blob = read_app_state(state_path)
    assert blob is not None, "no app state survived the kill"
    decoded = decode_state(blob)
    assert decoded is not None, "torn app-state blob (non-atomic write)"
    applied_seq, applied_index, _chain, app_blob = decoded
    assert applied_seq == applied_index  # one op per entry in the child
    assert applied_index >= 5
    restored = KvStore()
    restored.restore(app_blob)
    reference = KvStore()
    for seq in range(1, applied_index + 1):
        reference.apply(
            1, seq, seq, seq,
            kvstore.encode_put("k%d" % (seq % 4), bytes([seq % 256]) * 8),
        )
    assert restored.snapshot() == reference.snapshot()


# ---------------------------------------------------------------------------
# Service seam
# ---------------------------------------------------------------------------


def test_service_framing_roundtrip_and_bounds():
    a, b = socket.socketpair()
    try:
        rfile = b.makefile("rb")
        send_frame(a, {"id": 1, "op": "get", "key": "k"})
        assert recv_frame(rfile) == {"id": 1, "op": "get", "key": "k"}
        # An oversized length prefix is refused, not allocated.
        a.sendall(struct.pack(">I", 1 << 30))
        assert recv_frame(rfile) is None
    finally:
        a.close()
        b.close()


class _LoopbackConsensus:
    """propose() that commits immediately through the commit stream —
    consensus reduced to its post-condition, for service-seam tests."""

    def __init__(self):
        self.table = {}
        self.seq = 0
        self.store = KvStore()
        self.stream = CommitStream(
            self.store, data_source=_data_source(self.table)
        )

    def propose(self, request):
        self.table[(request.client_id, request.req_no)] = request.data
        self.seq += 1
        self.stream.apply(_entry(self.seq, (request.client_id, request.req_no)))

    def close(self):
        self.stream.close()


def test_kv_service_socket_loopback_full_surface():
    consensus = _LoopbackConsensus()
    frontend = KvFrontend(consensus.stream, consensus.store, consensus.propose)
    service = KvService(frontend)
    client = KvClient({0: service.address}, client_id=9, home=0)
    try:
        put = client.put("alpha", b"v1", timeout=5.0)
        assert put["status"] == "ok"
        assert put["version"] == 1
        assert client.req_no == 1  # use-then-increment from 0

        got = client.get("alpha", timeout=5.0)
        assert got["status"] == "ok"
        assert bytes.fromhex(got["value"]) == b"v1"
        assert got["version"] == put["version"]

        stale = client.get("alpha", mode="stale", timeout=5.0)
        assert stale["status"] == "ok"

        conflict = client.cas("alpha", 999, b"nope", timeout=5.0)
        assert conflict["status"] == "cas_conflict"
        winner = client.cas("alpha", put["version"], b"v2", timeout=5.0)
        assert winner["status"] == "ok"
        assert winner["version"] > put["version"]

        gone = client.delete("alpha", timeout=5.0)
        assert gone["status"] == "ok"
        missing = client.get("alpha", timeout=5.0)
        assert missing["status"] == "not_found"

        # The session's high-water index tracked every response.
        assert client.session_index >= winner["version"]
    finally:
        client.close()
        service.close()
        consensus.close()


def test_kv_frontend_rejects_malformed_requests():
    consensus = _LoopbackConsensus()
    frontend = KvFrontend(consensus.stream, consensus.store, consensus.propose)
    try:
        assert frontend.execute({"op": "bogus"}) == {"status": "bad_request"}
        assert frontend.execute(
            {"op": "put", "key": "k", "value": "zz-not-hex", "client_id": 1,
             "req_no": 0}
        )["status"] == "bad_request"
        status = frontend.execute({"op": "status"})
        assert status["status"] == "ok"
        assert "applied_index" in status["app"]
    finally:
        consensus.close()


def test_inprocess_cluster_kv_smoke():
    """Tier-1: a 4-node in-process cluster serving the replicated KV —
    read-your-writes through the committed read barrier, cas, and a
    cross-node stale read."""
    from mirbft_tpu_torch.loadgen import InProcessCluster

    with InProcessCluster(node_count=4, client_ids=[1, 2], app="kv",
                          device="cpu") as cluster:
        s1 = cluster.kv_session(1, home=0)
        put = s1.put("alpha", b"v1", timeout=30.0)
        assert put["status"] == "ok", put
        got = s1.get("alpha", timeout=30.0)
        assert got["status"] == "ok", got
        assert bytes.fromhex(got["value"]) == b"v1"
        assert got["version"] == put["version"]

        cas = s1.cas("alpha", put["version"], b"v2", timeout=30.0)
        assert cas["status"] == "ok", cas

        # A second session homed on another node: its committed read
        # barriers on that node's own frontier.
        s2 = cluster.kv_session(2, home=1)
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            other = s2.get("alpha", timeout=30.0)
            if other.get("status") == "ok" and other.get("version") == cas["version"]:
                break
            time.sleep(0.05)
        assert other["status"] == "ok", other
        assert bytes.fromhex(other["value"]) == b"v2"
        cluster.check()


# ---------------------------------------------------------------------------
# The linearizable-reads audit
# ---------------------------------------------------------------------------


def _op(client, op, key, t0, t1, outcome="ok", version=0, value=None):
    entry = {
        "client_id": client,
        "op": op,
        "key": key,
        "invoke_ns": t0,
        "return_ns": t1,
        "outcome": outcome,
        "version": version,
    }
    if value is not None:
        entry["value"] = value
    return entry


def test_linearizable_reads_passes_on_clean_overlapping_history():
    history = [
        _op(1, "put", "k", 0, 10, version=5, value="aa"),
        _op(2, "get", "k", 5, 15, version=5, value="aa"),
        _op(1, "put", "k", 20, 30, version=9, value="bb"),
        _op(2, "get", "k", 25, 40, version=9, value="bb"),
    ]
    tally = check_linearizable_reads(history)
    assert tally == {"reads": 2, "writes": 2, "overlaps": 2}


def test_linearizable_reads_detects_fork():
    history = [
        _op(1, "put", "k", 0, 10, version=5, value="aa"),
        _op(2, "get", "k", 5, 15, version=5, value="bb"),  # same version!
    ]
    with pytest.raises(InvariantViolation, match="fork"):
        check_linearizable_reads(history)


def test_linearizable_reads_detects_duplicate_write_versions():
    history = [
        _op(1, "put", "k", 0, 10, version=5, value="aa"),
        _op(2, "put", "k", 5, 15, version=5, value="aa"),
        _op(1, "get", "k", 6, 20, version=5, value="aa"),
    ]
    with pytest.raises(InvariantViolation, match="share"):
        check_linearizable_reads(history)


def test_linearizable_reads_detects_backwards_read():
    history = [
        _op(1, "put", "k", 0, 100, version=7, value="aa"),
        _op(2, "get", "k", 10, 20, version=7, value="aa"),
        _op(2, "get", "k", 30, 40, version=3, value="zz"),  # went back
        _op(3, "put", "k", 25, 35, version=3, value="zz"),
    ]
    with pytest.raises(InvariantViolation, match="backwards"):
        check_linearizable_reads(history)


def test_linearizable_reads_enforces_read_your_writes():
    history = [
        _op(1, "put", "k", 0, 10, version=8, value="bb"),
        _op(1, "get", "k", 20, 30, version=2, value="aa"),  # below own write
        _op(2, "get", "k", 5, 12, version=8, value="bb"),
    ]
    with pytest.raises(InvariantViolation, match="backwards"):
        check_linearizable_reads(history)


def test_linearizable_reads_vacuity_guard():
    with pytest.raises(InvariantViolation, match="vacuous"):
        check_linearizable_reads(
            [_op(1, "put", "k", 0, 10, version=1, value="aa")]
        )
    # Reads and writes that never overlap in time prove nothing.
    with pytest.raises(InvariantViolation, match="vacuous"):
        check_linearizable_reads(
            [
                _op(1, "put", "k", 0, 10, version=1, value="aa"),
                _op(2, "get", "k", 50, 60, version=1, value="aa"),
            ]
        )


# ---------------------------------------------------------------------------
# KV loadgen plumbing
# ---------------------------------------------------------------------------


def test_client_model_kv_knob_validation():
    from mirbft_tpu_torch.loadgen import ClientModel

    with pytest.raises(ValueError):
        ClientModel(read_ratio=1.5)
    with pytest.raises(ValueError):
        ClientModel(key_space=0)
    with pytest.raises(ValueError):
        ClientModel(key_dist="pareto")
    with pytest.raises(ValueError):
        ClientModel(key_dist="zipf", zipf_s=0.0)


def test_client_model_zipf_draw_is_skewed_and_seeded():
    import random

    from mirbft_tpu_torch.loadgen import ClientModel

    model = ClientModel(read_ratio=0.5, key_space=8, key_dist="zipf")
    counts: dict = {}
    rng = random.Random(7)
    for _ in range(2000):
        key = model.key(rng)
        counts[key] = counts.get(key, 0) + 1
    assert set(counts) <= {"k%d" % n for n in range(8)}
    assert max(counts, key=counts.get) == "k0"  # rank-1 hottest
    # Same seed, same draw sequence.
    again = [model.key(random.Random(7)) for _ in range(3)]
    assert again == [model.key(random.Random(7)) for _ in range(3)]


def test_kv_client_models_mixes_uniform_and_zipf():
    from mirbft_tpu_torch.loadgen import kv_client_models

    models = kv_client_models([1, 2, 3, 4], read_ratio=0.7)
    assert sorted(models) == [1, 2, 3, 4]
    assert all(m.read_ratio == 0.7 for m in models.values())
    dists = {models[n].key_dist for n in (1, 2)}
    assert dists == {"uniform", "zipf"}


def test_kv_workload_step_feeds_slo_artifact_and_diff(tmp_path):
    from mirbft_tpu_torch.loadgen import (
        InProcessCluster,
        KvWorkload,
        kv_client_models,
        slo,
    )
    from mirbft_tpu.loadgen import slo as ref_slo

    with InProcessCluster(node_count=4, client_ids=[1, 2], app="kv",
                          device="cpu") as cluster:
        sessions = {
            1: cluster.kv_session(1, home=0),
            2: cluster.kv_session(2, home=1),
        }
        workload = KvWorkload(sessions, kv_client_models([1, 2]), seed=3)
        step = workload.run_step("kv-smoke", ops_per_session=12,
                                 op_timeout_s=30.0)
        cluster.check()

    assert step.submitted == 24
    assert step.reads + step.writes == 24
    assert step.committed > 0
    assert step.timed_out == 0, "writes timed out in-process"
    assert workload.history and len(workload.history) == 24

    doc = slo.artifact([step], cluster="inproc", nodes=4, sessions=2)
    (entry,) = doc["steps"]
    for key in ("reads", "writes", "read_p50_ms", "write_p99_ms",
                "read_goodput_per_sec", "write_goodput_per_sec"):
        assert key in entry, key
    assert doc["meta"]["cluster"] == "inproc"

    # The JAX package's slo.artifact makes the same document of the step.
    ref_doc = ref_slo.artifact([step], cluster="inproc", nodes=4, sessions=2)
    assert doc == ref_doc

    # The bench payload embeds the doc under loadgen_app; obsv --diff
    # must flatten the read/write splits into gated series, as the JAX
    # package's does (exactly).
    from mirbft_tpu.obsv.diff import extract_series as ref_extract_series
    from mirbft_tpu_torch.obsv.diff import extract_series

    series = extract_series({"unit": 1.0, "loadgen_app": doc})
    assert series == ref_extract_series({"unit": 1.0, "loadgen_app": doc})
    assert "loadgen_app.step.kv-smoke.read_p50_ms" in series
    assert "loadgen_app.step.kv-smoke.write_p99_ms" in series
    assert "loadgen_app.step.kv-smoke.write_goodput_per_sec" in series


# ---------------------------------------------------------------------------
# Parity with the JAX package
# ---------------------------------------------------------------------------


def _seeded_ops(seed, n=400):
    """A seeded op stream: puts, deletes, cas (some against the current
    version, some stale), no-ops and malformed bytes, over a small key
    space so keys are overwritten and deleted again."""
    import random

    rng = random.Random(seed)
    ops = []
    for _ in range(n):
        key = "k%d" % rng.randrange(12)
        pick = rng.random()
        if pick < 0.5:
            ops.append(("put", key, rng.randbytes(rng.randrange(0, 300))))
        elif pick < 0.65:
            ops.append(("delete", key, None))
        elif pick < 0.85:
            ops.append(("cas", key, rng.randbytes(rng.randrange(0, 50))))
        elif pick < 0.9:
            ops.append(("noop", key, None))
        else:
            ops.append(("garbage", key, rng.randbytes(rng.randrange(0, 20))))
    return ops


def _encode(module, op, store, rng_version):
    kind, key, value = op
    if kind == "put":
        return module.encode_put(key, value)
    if kind == "delete":
        return module.encode_delete(key)
    if kind == "cas":
        version = store.get(key)[1]
        return module.encode_cas(key, version if rng_version else 3, value)
    if kind == "noop":
        return module.encode_noop()
    return value


@pytest.mark.parametrize("seed", [7, 8])
def test_kvstore_equals_the_jax_kvstore_on_a_seeded_stream(seed):
    from mirbft_tpu.app import kvstore as ref_kvstore

    ours, theirs = KvStore(), ref_kvstore.KvStore()
    for index, op in enumerate(_seeded_ops(seed), start=1):
        data = _encode(kvstore, op, ours, index % 3)
        assert data == _encode(ref_kvstore, op, theirs, index % 3)
        assert kvstore.decode_op(data) == ref_kvstore.decode_op(data)
        client, req_no = 1 + index % 4, index // 4
        got = ours.apply(client, req_no, index, index + 5, data)
        assert got == theirs.apply(client, req_no, index, index + 5, data)
        if index % 50 == 0:
            assert ours.snapshot() == theirs.snapshot()
            assert ours.digest() == theirs.digest()
    snap = ours.snapshot()
    assert snap == theirs.snapshot()
    restored = ref_kvstore.KvStore()
    restored.restore(snap)
    assert restored.snapshot() == snap


def test_state_blobs_and_app_state_files_equal_the_jax_packages(tmp_path):
    from mirbft_tpu.app import stream as ref_stream
    from mirbft_tpu.runtime import storage as ref_storage
    from mirbft_tpu_torch.runtime import storage

    for args in ((0, 0, b"", b""), (7, 42, b"chain" * 7, b"app-bytes"),
                 (1 << 40, 3, bytes(32), bytes(range(256)) * 9)):
        blob = encode_state(*args)
        assert blob == ref_stream.encode_state(*args)
        assert decode_state(blob) == ref_stream.decode_state(blob) == args
        assert state_binding(blob) == ref_stream.state_binding(blob)
    storage.write_app_state(str(tmp_path / "port"), blob)
    ref_storage.write_app_state(str(tmp_path / "ref"), blob)
    assert (tmp_path / "port").read_bytes() == (tmp_path / "ref").read_bytes()
    assert ref_storage.read_app_state(str(tmp_path / "port")) == blob
    storage.remove_app_state(str(tmp_path / "port"))
    assert storage.read_app_state(str(tmp_path / "port")) is None


def test_commit_stream_snapshots_equal_the_jax_streams():
    """The same committed entries through the port's and the JAX
    package's CommitStream over a KvStore: the same apply results and the
    same snapshot blobs."""
    from mirbft_tpu import pb as ref_pb
    from mirbft_tpu.app import kvstore as ref_kvstore
    from mirbft_tpu.app.stream import CommitStream as RefStream

    table = {}
    ours = CommitStream(KvStore(), data_source=_data_source(table))
    theirs = RefStream(ref_kvstore.KvStore(), data_source=_data_source(table))
    try:
        for seq, op in enumerate(_seeded_ops(5, n=60), start=1):
            table[(1, seq)] = _encode(kvstore, op, ours.app, seq % 2)
            ours.apply(_entry(seq, (1, seq)))
            theirs.apply(ref_pb.QEntry(
                seq_no=seq, digest=b"d",
                requests=[ref_pb.RequestAck(client_id=1, req_no=seq)],
            ))
        assert ours.drain(timeout=10) and theirs.drain(timeout=10)
        assert ours.app.snapshot() == theirs.app.snapshot()
        assert ours.snap(None, None) == theirs.snap(None, None)
    finally:
        ours.close()
        theirs.close()


def _session_script(seed, n=24):
    """A seeded closed-loop script for one session: puts, cas against the
    version last read, deletes and committed reads over a few keys."""
    import random

    rng = random.Random(seed)
    return [
        (rng.choice(("put", "put", "get", "cas", "delete")),
         "k%d" % rng.randrange(4), rng.randbytes(rng.randrange(1, 40)))
        for _ in range(n)
    ]


def _drive(session, script):
    out, versions = [], {}
    for op, key, value in script:
        if op == "put":
            resp = session.put(key, value, timeout=30.0)
        elif op == "cas":
            resp = session.cas(key, versions.get(key, 0), value, timeout=30.0)
        elif op == "delete":
            resp = session.delete(key, timeout=30.0)
        else:
            resp = session.get(key, timeout=30.0)
            versions[key] = resp.get("version", 0)
        out.append({k: v for k, v in resp.items() if k != "frontier"})
    return out


def _reference_responses(script):
    """What the replicated store must answer to a single session's
    script, from the JAX package's KvStore: each write is the next apply
    index, each committed read sees every earlier write."""
    from mirbft_tpu.app import kvstore as ref_kvstore

    store, index, out, versions = ref_kvstore.KvStore(), 0, [], {}
    for op, key, value in script:
        if op == "get":
            got, version = store.get(key)
            versions[key] = version
            resp = {"status": "ok" if got is not None else "not_found",
                    "version": version}
            if got is not None:
                resp["value"] = got.hex()
        else:
            index += 1
            data = {
                "put": lambda: ref_kvstore.encode_put(key, value),
                "cas": lambda: ref_kvstore.encode_cas(
                    key, versions.get(key, 0), value),
                "delete": lambda: ref_kvstore.encode_delete(key),
            }[op]()
            result = store.apply(1, index - 1, index, index, data)
            resp = {"status": result["outcome"],
                    "version": result.get("version", index), "index": index}
        out.append(resp)
    return out, store.snapshot()


def test_kv_cluster_answers_as_the_jax_kvstore_on_one_session():
    """The slice as a whole: one seeded session script through the port's
    4-node InProcessCluster (cuda-pipelined on the digest kernel's plain
    version) answers every op, versions included, as the JAX package's
    KvStore does applied in order, and every replica ends at the JAX
    store's snapshot bytes."""
    from mirbft_tpu_torch.loadgen import InProcessCluster

    script = _session_script(11)
    want, want_snapshot = _reference_responses(script)
    with InProcessCluster(node_count=4, client_ids=[1, 2], app="kv",
                          device="cpu") as cluster:
        got = _drive(cluster.kv_session(1, home=0), script)
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and {
            r.store.snapshot() for r in cluster.replicas
        } != {want_snapshot}:
            time.sleep(0.05)
        snapshots = {r.store.snapshot() for r in cluster.replicas}
        cluster.check()
    assert got == want
    assert {r["status"] for r in want} >= {"ok", "not_found"}
    assert snapshots == {want_snapshot}
