"""The KV rung and the signed-ingress rung on worker processes, small, on
the CPU (``device="cpu"``: every worker's kernels run their plain
versions).

``bench.app_run`` as the JAX bench runs its app rung: KV workers, one
``KvClient`` a session over the workers' service sockets, then the last
node stopped, the others driven two checkpoint intervals past it, and
the node restarted from its own disk to catch up by a snapshot.
``bench.live_mp_run(signed=True)``: the signed Poisson step on workers,
each worker's ingress batches journaled with their verdicts and read
back, forged twins judged invalid, evicted and absent from every STORE
record of every request log.  Then the app rung's seeded op history
through both packages' load generators and KvStores, and the two pieces
the forged-twin audit reads: the raw request-log scan and the batch
journal.

On the CPU no wrapper counts a launch (every row goes to the plain
version), so the launches by rows that the card must show (chip_smoke
phase 16) are held here through what they are counted against: the
journal holds exactly the batches each worker's ingress stage verified,
and the rows they give.
"""

import collections
import os
import threading

import pytest

from mirbft_tpu_torch import bench, pb

# Generous: four workers boot in 3-4 s each on this CPU, and a loaded
# machine has stretched that several times over.
RUN_DEADLINE_S = 300.0


def _bounded(seconds: float, fn):
    """Run ``fn`` with a wall-clock deadline of its own: its result, or a
    failure naming the deadline (the worker rungs carry their own
    timeouts; this bounds the test if one of them hangs)."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            box["err"] = exc

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    thread.join(seconds)
    assert not thread.is_alive(), f"no result within {seconds} s"
    if "err" in box:
        raise box["err"]
    return box["out"]


def test_app_run_on_workers_catches_up_a_restarted_replica():
    # 32 ops a session: at 6 or 16 the reads' audit can find no read that
    # overlaps a write to its key, and its vacuity guard fails it.
    out = _bounded(RUN_DEADLINE_S, lambda: bench.app_run(
        device="cpu", nodes=4, ops_per_session=32, tick_s=0.05))
    step = out["step"]
    assert step.timed_out == 0 and step.submitted == 32 * bench.APP_SESSIONS, (
        step.timed_out, out["step_installs"], out["homes"])
    assert "violation" not in out["linearizable"], out["linearizable"]
    assert out["converged"], (out["stall"], out["store_digests"])
    assert len(set(out["store_digests"].values())) == 1, (
        out["store_digests"], out["applied"], out["step_installs"])
    assert sorted(out["store_digests"]) == [0, 1, 2, 3]
    assert out["host_digests"] == 0 and out["device_digests"] > 0
    # Every worker exited 0, the stopped one twice, and logged no fault.
    assert out["exit_codes"] == {0: [0], 1: [0], 2: [0], 3: [0, 0]}
    assert all(not faults for faults in out["log_faults"].values())
    assert len(out["boot_seconds"][3]) == 2
    lag = out["lag"]
    # At 4 nodes session 4 is homed on node 3 for the step; it writes
    # through another node while node 3 is down.
    assert out["homes"] == {1: 0, 2: 1, 3: 2, 4: 3}
    assert lag["node"] == 3 and 3 not in lag["homes"].values()
    assert min(lag["others_low_watermarks"]) >= lag["target_low_watermark"]
    assert lag["seqs_missed"] > 0
    assert lag["caught_up"] and lag["snapshot_equal"]
    assert lag["engine"]["snapshots_installed"] >= 1
    assert lag["engine"]["chunks_rejected_corrupt"] == 0
    assert lag["engine"]["chunks_rejected_oversized"] == 0
    assert lag["transfer_chunks"] >= 1 and lag["transfer_bytes"] > 0
    assert lag["transfer_s"] is not None and lag["transfer_s"] > 0
    assert lag["reads_ok"] and len(lag["reads"]) == lag["writes"] > 0


def test_signed_live_mp_run_journals_every_ingress_batch():
    out = _bounded(RUN_DEADLINE_S, lambda: bench.live_mp_run(
        "cuda-pipelined", device="cpu", rates=(10.0,), signed=True))
    assert not out["missing"] and not out["duplicates"]
    assert len(set(out["chains"])) == 1 and "" not in out["chains"]
    assert all(codes == [0] for codes in out["exit_codes"].values()), (
        out["exit_codes"], out["log_faults"])
    assert all(not faults for faults in out["log_faults"].values())
    assert out["host_digests"] == 0 and out["device_digests"] > 0
    # Every honest request committed once on every node, or, on a node
    # that fell behind and installed a snapshot, at or below its
    # checkpoint (phase 16's gate).
    for node, commits in out["per_node_commits"].items():
        missing = out["honest"] - set(commits)
        installed, cp_seq = out["transfers"][node]
        assert not missing or (installed and all(
            out["seq_of"][key] <= cp_seq for key in missing)), (
            node, out["transfers"][node],
            {key: out["seq_of"].get(key) for key in missing})
        assert max(commits.values()) == 1
    assert out["forged"] > 0 and out["forged_stored"] == 0
    assert out["forged_admitted"] == 0
    batches_by_node = collections.Counter(out["batch_nodes"])
    invalid = collections.Counter()
    for node, items, verdicts in zip(out["batch_nodes"], out["batches"],
                                     out["verdicts"]):
        assert len(verdicts) == len(items)
        invalid[node] += verdicts.count(False)
    for node, stage in out["ingress"].items():
        assert stage["verify_errors"] == 0 and stage["dropped_overflow"] == 0
        assert stage["evicted"] == out["forged_to"][node] == invalid[node] > 0
        # The raw log scan saw the whole run: every committed request has
        # its STORE record.
        assert set(out["per_node_commits"][node]) <= out["stored"][node]
        # The journal holds exactly the batches the stage verified ...
        assert batches_by_node[node] == stage["batches"] > 0
        mine = [b for b, n in zip(out["batches"], out["batch_nodes"])
                if n == node]
        assert sum(len(b) for b in mine) == stage["admitted"]
        assert stage["delivered"] + stage["evicted"] == stage["admitted"]
    # ... and the rows each hands the kernels: every honest item passes
    # the host's checks (a forged twin fails them only where its flipped
    # bit puts S out of range).  Each batch with rows is one launch of
    # each kernel at that many rows, which the wrappers count on a card
    # only.
    rows = [len(bench.ingress_rows(batch)) for batch in out["batches"]]
    assert all(0 < n <= len(b) for n, b in zip(rows, out["batches"]))
    delivered = sum(s["delivered"] for s in out["ingress"].values())
    assert delivered <= sum(rows) <= delivered + sum(out["forged_to"].values())
    assert all(not c for c in out["launches_by_rows"].values())


class _RecordingSession:
    """A KV session that answers every op at once and records it."""

    def __init__(self):
        self.ops = []

    def put(self, key, value, timeout=None):
        self.ops.append(("put", key, value))
        return {"status": "ok", "version": len(self.ops)}

    def get(self, key, mode="committed", timeout=None):
        self.ops.append(("get", key, None))
        return {"status": "not_found"}


def _history(loadgen):
    """The app rung's sessions through one package's KvWorkload: each
    client's ops in order."""
    clients = list(range(1, bench.APP_SESSIONS + 1))
    sessions = {cid: _RecordingSession() for cid in clients}
    workload = loadgen.KvWorkload(
        sessions,
        loadgen.kv_client_models(clients, read_ratio=bench.APP_READ_RATIO),
        seed=bench.APP_SEED,
    )
    workload.run_step("app-kv-mixed",
                      ops_per_session=bench.APP_OPS_PER_SESSION)
    return {cid: s.ops for cid, s in sessions.items()}


def test_app_history_gives_equal_kvstore_bytes_on_both_packages():
    from mirbft_tpu import loadgen as ref_loadgen
    from mirbft_tpu.app import kvstore as ref_kvstore
    from mirbft_tpu_torch import loadgen
    from mirbft_tpu_torch.app import kvstore

    ours, theirs = _history(loadgen), _history(ref_loadgen)
    assert ours == theirs
    writes = sum(op == "put" for ops in ours.values() for op, _k, _v in ops)
    assert 0 < writes < bench.APP_SESSIONS * bench.APP_OPS_PER_SESSION
    mine, ref = kvstore.KvStore(), ref_kvstore.KvStore()
    index = 0
    # One order of commit: the clients' ops in turn, as BatchSize 1 and
    # one op in flight a session allow.
    for op_no in range(bench.APP_OPS_PER_SESSION):
        for cid in sorted(ours):
            op, key, value = ours[cid][op_no]
            if op != "put":
                assert mine.get(key) == ref.get(key)
                continue
            index += 1
            data = kvstore.encode_put(key, value)
            assert data == ref_kvstore.encode_put(key, value)
            got = mine.apply(cid, op_no, index, index, data)
            assert got == ref.apply(cid, op_no, index, index, data)
    assert index == writes
    assert mine.snapshot() == ref.snapshot() and len(mine.snapshot()) > 0
    assert mine.digest() == ref.digest()


def test_logged_stores_keeps_committed_records_that_reopening_drops(tmp_path):
    from mirbft_tpu_torch.runtime.storage import FileRequestStore, logged_stores

    path = str(tmp_path / "reqs")
    store = FileRequestStore(path)
    acks = [pb.RequestAck(client_id=1, req_no=n, digest=bytes([n]) * 32)
            for n in range(3)]
    for n, ack in enumerate(acks):
        store.store(ack, b"payload-%d" % n)
    store.commit(acks[0])
    store.commit(acks[2])
    store.sync()
    store.close()
    records = logged_stores(path)
    assert [(a.req_no, d) for a, d in records] == [
        (n, b"payload-%d" % n) for n in range(3)]
    # Opening the store replays and compacts: only the uncommitted one
    # is left, in memory and in the log.
    reopened = FileRequestStore(path)
    left = []
    reopened.uncommitted(left.append)
    reopened.close()
    assert [a.req_no for a in left] == [1]
    assert [(a.req_no, d) for a, d in logged_stores(path)] == [
        (1, b"payload-1")]
    assert logged_stores(str(tmp_path / "absent")) == []


def test_batch_journal_keeps_each_batch_with_its_verdicts(tmp_path):
    from mirbft_tpu_torch.cluster.worker import _BatchJournal

    calls = []

    def verify(items):
        calls.append(items)
        if len(calls) == 3:
            raise RuntimeError("launch failed")
        return [data != b"bad" for _c, _q, data in items]

    journal = _BatchJournal(str(tmp_path / "ingress-batches-1.jsonl"), verify)
    assert journal([(1, 0, b"ok"), (2, 0, b"bad")]) == [True, False]
    # Buffered: nothing reaches the file before a flush.
    assert os.path.getsize(tmp_path / "ingress-batches-1.jsonl") == 0
    journal.flush()
    assert journal([(1, 1, b"ok")]) == [True]
    with pytest.raises(RuntimeError):
        journal([(3, 0, b"ok")])
    journal.close()
    journal([(4, 0, b"ok")])  # after close: kept in memory, never written
    journal.flush()
    batches, verdicts = bench._read_batch_journals(str(tmp_path))
    assert batches == [[(1, 0, b"ok"), (2, 0, b"bad")], [(1, 1, b"ok")],
                       [(3, 0, b"ok")]]
    assert verdicts == [[True, False], [True], None]
