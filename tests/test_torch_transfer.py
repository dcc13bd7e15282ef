"""The port's snapshot state transfer (mirbft_tpu_torch/runtime/transfer.py)
held against the JAX package's.

The deterministic cases of tests/test_transfer_engine.py:145-595, on the
port: a fake clock, in-memory queued ducts, no sockets — blob and frame
codecs, the digest chain, donor serve and NACK, the fetch state machine
(timeout, retry, donor failover), certificate verification as the
adoption authority, crash-resume from the staged blob, the ingress bounds,
the certified-above-window trigger, and the two transfer invariants of
the port's chaos/invariants.py.  Then parity: snapshot blobs, chunk
chains, frames and staged snapshot files byte for byte equal to the JAX
module's on seeded inputs, and one fetch of the port's engine from the JAX
package's donor.  Every comparison is exact.

The live corrupt-stream run on real sockets
(tests/test_transfer_engine.py:646) is mirrored in
tests/test_torch_chaos_mirrors.py; the multi-process join and remove
under partition (:609, :629) in tests/test_torch_cluster.py (slow).

Last, a lagging node's commit while its transfer is in flight: the JAX
package's active epoch commits and its serializer dies on
``CommitState.commit``'s guard; the port's leaves the sequences to the
transfer."""

import types

import pytest

from mirbft_tpu_torch import pb
from mirbft_tpu_torch.chaos.invariants import (
    InvariantViolation,
    check_bounded_catchup,
    check_transfer_corruption_rejected,
)
from mirbft_tpu_torch.core.actions import StateTarget
from mirbft_tpu_torch.core.checkpoints import CheckpointTracker
from mirbft_tpu_torch.core.msgbuffers import NodeBuffers
from mirbft_tpu_torch.core.persisted import Persisted
from mirbft_tpu_torch.runtime.config import Config
from mirbft_tpu_torch.runtime.msgfilter import MalformedMessage, check_snapshot_chunk
from mirbft_tpu_torch.runtime.storage import read_snapshot_file, write_snapshot_file
from mirbft_tpu_torch.runtime.transfer import (
    Snapshot,
    TransferEngine,
    chain_next,
    chain_seed,
    decode_frame,
    decode_snapshot,
    encode_chunk,
    encode_nack as transfer_nack,
    encode_request,
    encode_snapshot,
    split_chunks,
)


# -- harness -----------------------------------------------------------------


class _Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += dt


class _Mesh:
    """Queued loopback ducts: sends enqueue, ``deliver`` flushes — the
    queue models the transport's cross-thread hop, so an engine never
    re-enters its own lock the way a synchronous callback would."""

    def __init__(self):
        self.engines = {}
        self.pending = []  # [(src, dest, body)]
        self.log = []  # every send ever, for traffic assertions
        self.cut = set()  # (src, dest) pairs to drop

    def duct(self, src):
        mesh = self

        class _Duct:
            def send(self, dest, body):
                mesh.log.append((src, dest, body))
                mesh.pending.append((src, dest, body))

        return _Duct()

    def add(self, engine):
        self.engines[engine.node_id] = engine

    def deliver(self, mangle=None):
        while self.pending:
            src, dest, body = self.pending.pop(0)
            if (src, dest) in self.cut:
                continue
            engine = self.engines.get(dest)
            if engine is None:
                continue
            engine.on_frame(src, mangle(body) if mangle else body)


def _network_state():
    return pb.NetworkState(
        config=pb.NetworkConfig(
            nodes=[0, 1, 2, 3],
            f=1,
            number_of_buckets=4,
            checkpoint_interval=5,
            max_epoch_length=50,
        )
    )


def _snapshot(seq_no=10, value=b"cp10", app=b"app-state"):
    requests = [
        (pb.RequestAck(client_id=1, req_no=3, digest=b"d" * 8), b"payload"),
        (pb.RequestAck(client_id=2, req_no=0, digest=b"e" * 8), b""),
    ]
    return Snapshot(seq_no, value, _network_state(), app, requests)


def _engine(mesh, clock, tmp_path, node_id, peers=(), **kw):
    staging = tmp_path / f"n{node_id}"
    staging.mkdir(exist_ok=True)
    sink = types.SimpleNamespace(completed=[], failed=[])
    engine = TransferEngine(
        node_id,
        mesh.duct(node_id),
        staging_dir=str(staging),
        peers=peers,
        complete=lambda target, ns: sink.completed.append((target, ns)),
        failed=lambda target: sink.failed.append(target),
        chunk_timeout_s=1.0,
        clock=clock,
        **kw,
    )
    mesh.add(engine)
    return engine, sink


def _pump(mesh, fetcher, clock, rounds=40, dt=1.1):
    """Advance time past any timeout/backoff and poll until the fetch
    leaves the state machine (installed or failed)."""
    for _ in range(rounds):
        fetcher.poll()
        mesh.deliver()
        fetcher.poll()
        if not fetcher.transferring():
            return
        clock.advance(dt)
    raise AssertionError(f"fetch never settled: {fetcher.status()}")


# -- codecs ------------------------------------------------------------------


def test_snapshot_blob_round_trips():
    snap = _snapshot()
    blob = encode_snapshot(snap)
    out = decode_snapshot(blob)
    assert out.seq_no == snap.seq_no
    assert out.value == snap.value
    assert out.app_bytes == snap.app_bytes
    assert out.network_state.config.nodes == [0, 1, 2, 3]
    assert [(a.client_id, a.req_no, a.digest) for a, _d in out.requests] == [
        (1, 3, b"d" * 8),
        (2, 0, b"e" * 8),
    ]
    assert [d for _a, d in out.requests] == [b"payload", b""]


def test_snapshot_blob_rejects_malformation():
    blob = encode_snapshot(_snapshot())
    with pytest.raises(ValueError):
        decode_snapshot(blob + b"\x00")  # trailing bytes
    with pytest.raises(ValueError):
        decode_snapshot(blob[:-1])  # truncation
    with pytest.raises(ValueError):
        decode_snapshot(b"")


def test_transfer_frames_round_trip():
    req = encode_request(40, b"cert-value", 3)
    assert decode_frame(req) == ("request", 40, b"cert-value", 3)
    digest = chain_seed(40, b"cert-value")
    chunk = encode_chunk(40, 2, 7, digest, b"chunk-payload")
    assert decode_frame(chunk) == (
        "chunk",
        40,
        2,
        7,
        digest,
        b"chunk-payload",
    )
    with pytest.raises(ValueError):
        decode_frame(b"\x7f")  # unknown kind
    with pytest.raises(ValueError):
        decode_frame(chunk[:10])  # truncated mid-frame


def test_chunk_split_and_digest_chain():
    blob = bytes(range(256)) * 10
    payloads = split_chunks(blob, 1000)
    assert b"".join(payloads) == blob
    assert max(len(p) for p in payloads) <= 1000
    assert split_chunks(b"", 64) == [b""]  # empty blob still round-trips
    with pytest.raises(ValueError):
        split_chunks(blob, 0)
    # The chain is anchored to the certified target: any other
    # (seq_no, value) produces a different seed, so chunk 0 already
    # fails verification when served for the wrong certificate.
    assert chain_seed(10, b"a") != chain_seed(11, b"a")
    assert chain_seed(10, b"a") != chain_seed(10, b"b")
    d = chain_seed(10, b"a")
    assert chain_next(d, b"x") != chain_next(d, b"y")


# -- donor side --------------------------------------------------------------


def test_donor_serves_matching_request_and_nacks_unknown(tmp_path):
    mesh, clock = _Mesh(), _Clock()
    donor, _ = _engine(mesh, clock, tmp_path, 1)
    snap = _snapshot()
    donor.note_checkpoint(
        snap.seq_no, snap.value, snap.network_state, snap.app_bytes,
        snap.requests,
    )

    donor.on_frame(0, encode_request(snap.seq_no, snap.value, 0))
    frames = [decode_frame(b) for _s, _d, b in mesh.log]
    chunks = [f for f in frames if f[0] == "chunk"]
    assert chunks and b"".join(f[5] for f in chunks) == encode_snapshot(snap)
    assert donor.counters["snapshots_served"] == 1

    # Unknown seq_no and certificate-value mismatch both NACK so the
    # fetcher fails over immediately instead of burning a timeout.
    mesh.log.clear()
    donor.on_frame(0, encode_request(999, snap.value, 0))
    donor.on_frame(0, encode_request(snap.seq_no, b"other-cert", 0))
    assert [decode_frame(b)[0] for _s, _d, b in mesh.log] == ["nack", "nack"]
    assert donor.counters["snapshots_nacked"] == 2


def test_donor_retains_only_newest_snapshots(tmp_path):
    mesh, clock = _Mesh(), _Clock()
    donor, _ = _engine(mesh, clock, tmp_path, 1)
    for seq in (10, 20, 30, 40, 50, 60):
        snap = _snapshot(seq_no=seq, value=b"cp%d" % seq)
        donor.note_checkpoint(
            seq, snap.value, snap.network_state, snap.app_bytes, snap.requests
        )
    assert donor.status()["cached_snapshots"] == [30, 40, 50, 60]


# -- fetcher: the happy path -------------------------------------------------


def test_fetch_installs_verified_snapshot(tmp_path):
    mesh, clock = _Mesh(), _Clock()
    donor, _ = _engine(mesh, clock, tmp_path, 1)
    fetcher, sink = _engine(mesh, clock, tmp_path, 0, peers=(1,))
    snap = _snapshot()
    donor.note_checkpoint(
        snap.seq_no, snap.value, snap.network_state, snap.app_bytes,
        snap.requests,
    )

    fetcher.begin(StateTarget(seq_no=snap.seq_no, value=snap.value))
    _pump(mesh, fetcher, clock)

    assert fetcher.counters["snapshots_installed"] == 1
    assert fetcher.counters["chunks_rejected_corrupt"] == 0
    (target, network_state), = sink.completed
    assert (target.seq_no, target.value) == (snap.seq_no, snap.value)
    assert network_state.config.nodes == [0, 1, 2, 3]
    assert not sink.failed
    # The staged blob is consumed on install — a later restart must not
    # resurrect an already-adopted snapshot.
    assert read_snapshot_file(fetcher.staging_path) is None


def test_begin_is_idempotent_for_inflight_target(tmp_path):
    mesh, clock = _Mesh(), _Clock()
    fetcher, _ = _engine(mesh, clock, tmp_path, 0, peers=(1, 2))
    target = StateTarget(seq_no=10, value=b"cp10")
    fetcher.begin(target)
    fetcher.poll()  # sends the first request
    sent = len(mesh.log)
    fetcher.begin(StateTarget(seq_no=10, value=b"cp10"))
    fetcher.poll()
    assert len(mesh.log) == sent  # no duplicate stream started


# -- fetcher: corruption, certificates, bounds -------------------------------


def test_corrupted_chunk_rejected_with_evidence(tmp_path):
    """Every mangled frame breaks the digest chain and is refused —
    nothing corrupt is ever staged or installed."""
    mesh, clock = _Mesh(), _Clock()
    donor, _ = _engine(mesh, clock, tmp_path, 1)
    fetcher, sink = _engine(
        mesh, clock, tmp_path, 0, peers=(1,), donor_rounds=1
    )
    snap = _snapshot()
    donor.note_checkpoint(
        snap.seq_no, snap.value, snap.network_state, snap.app_bytes,
        snap.requests,
    )

    def flip_payload_tail(body):
        if decode_frame(body)[0] != "chunk":
            return body
        return body[:-1] + bytes([body[-1] ^ 0xFF])

    fetcher.begin(StateTarget(seq_no=snap.seq_no, value=snap.value))
    fetcher.poll()
    mesh.deliver(mangle=flip_payload_tail)
    for _ in range(10):
        fetcher.poll()
        clock.advance(1.1)

    assert fetcher.counters["chunks_rejected_corrupt"] >= 1
    assert fetcher.counters["snapshots_installed"] == 0
    assert read_snapshot_file(fetcher.staging_path) is None
    assert sink.failed and not sink.completed


def test_chain_valid_but_wrong_blob_rejected_at_certificate(tmp_path):
    """A byzantine donor can chain arbitrary bytes to the right anchor;
    the decoded blob must still carry the certified (seq_no, value) —
    the 2f+1 certificate, not the chain, is the adoption authority."""
    mesh, clock = _Mesh(), _Clock()
    fetcher, sink = _engine(
        mesh, clock, tmp_path, 0, peers=(1,), donor_rounds=1
    )
    target = StateTarget(seq_no=10, value=b"cp10")
    fetcher.begin(target)
    fetcher.poll()  # now fetching from donor 1

    wrong = encode_snapshot(_snapshot(seq_no=11, value=b"cp11"))
    digest = chain_seed(target.seq_no, target.value)
    payloads = split_chunks(wrong, 64)
    for index, payload in enumerate(payloads):
        digest = chain_next(digest, payload)
        fetcher.on_frame(
            1, encode_chunk(target.seq_no, index, len(payloads), digest, payload)
        )
    assert fetcher.counters["chunks_received"] == len(payloads)

    for _ in range(10):
        fetcher.poll()
        clock.advance(1.1)
    assert fetcher.counters["chunks_rejected_corrupt"] >= 1
    assert fetcher.counters["snapshots_installed"] == 0
    assert sink.failed and not sink.completed


def test_oversized_chunk_rejected_at_ingress(tmp_path):
    mesh, clock = _Mesh(), _Clock()
    limits = types.SimpleNamespace(
        max_snapshot_chunk_bytes=8, max_snapshot_bytes=64
    )
    fetcher, _ = _engine(
        mesh, clock, tmp_path, 0, peers=(1,), donor_rounds=1, limits=limits
    )
    target = StateTarget(seq_no=10, value=b"cp10")
    fetcher.begin(target)
    fetcher.poll()
    digest = chain_next(chain_seed(10, b"cp10"), b"x" * 100)
    fetcher.on_frame(1, encode_chunk(10, 0, 1, digest, b"x" * 100))
    assert fetcher.counters["chunks_rejected_oversized"] == 1
    assert fetcher.counters["chunks_received"] == 0


def test_stale_and_unsolicited_chunks_dropped(tmp_path):
    mesh, clock = _Mesh(), _Clock()
    fetcher, _ = _engine(mesh, clock, tmp_path, 0, peers=(1, 2))
    digest = chain_next(chain_seed(10, b"cp10"), b"p")
    # No fetch in flight at all: unsolicited chunk.
    fetcher.on_frame(1, encode_chunk(10, 0, 1, digest, b"p"))
    assert fetcher.counters["chunks_stale"] == 1
    # In flight, but from a node that is not the current donor.
    fetcher.begin(StateTarget(seq_no=10, value=b"cp10"))
    fetcher.poll()
    donor = fetcher.status()["donor"]
    other = 2 if donor == 1 else 1
    fetcher.on_frame(other, encode_chunk(10, 0, 1, digest, b"p"))
    assert fetcher.counters["chunks_stale"] == 2
    assert fetcher.counters["chunks_received"] == 0


# -- fetcher: timeout, retry, failover, failure ------------------------------


def test_donor_failover_after_timeouts(tmp_path):
    """The first donor is unreachable: per-chunk timeouts burn its
    attempts, the fetch fails over, and the second donor completes it."""
    mesh, clock = _Mesh(), _Clock()
    donor1, _ = _engine(mesh, clock, tmp_path, 1)
    donor2, _ = _engine(mesh, clock, tmp_path, 2)
    fetcher, sink = _engine(mesh, clock, tmp_path, 0, peers=(1, 2))
    snap = _snapshot()
    for donor in (donor1, donor2):
        donor.note_checkpoint(
            snap.seq_no, snap.value, snap.network_state, snap.app_bytes,
            snap.requests,
        )

    fetcher.begin(StateTarget(seq_no=snap.seq_no, value=snap.value))
    fetcher.poll()
    first = fetcher.status()["donor"]
    mesh.cut.add((0, first))  # requests to the first donor vanish

    _pump(mesh, fetcher, clock)
    assert fetcher.counters["snapshots_installed"] == 1
    assert fetcher.counters["request_timeouts"] >= 2
    assert fetcher.counters["retries"] >= 1  # same-donor retry first
    assert fetcher.counters["donor_failovers"] >= 1
    assert sink.completed and not sink.failed


def test_nack_fails_over_without_waiting_for_timeout(tmp_path):
    """Only the donor the shuffle did NOT pick first holds the snapshot:
    the first donor NACKs, and the rotation happens on the NACK itself —
    the clock never advances, so no timeout can be responsible."""
    mesh, clock = _Mesh(), _Clock()
    donor1, _ = _engine(mesh, clock, tmp_path, 1)
    donor2, _ = _engine(mesh, clock, tmp_path, 2)
    fetcher, sink = _engine(mesh, clock, tmp_path, 0, peers=(1, 2))
    snap = _snapshot()
    fetcher.begin(StateTarget(seq_no=snap.seq_no, value=snap.value))
    fetcher.poll()
    first = fetcher.status()["donor"]
    nacker = donor1 if first == 1 else donor2
    holder = donor2 if first == 1 else donor1
    holder.note_checkpoint(
        snap.seq_no, snap.value, snap.network_state, snap.app_bytes,
        snap.requests,
    )
    # One flush settles the whole exchange: request -> NACK -> rotated
    # request -> chunks; then one poll installs.
    mesh.deliver()
    fetcher.poll()
    assert fetcher.counters["snapshots_installed"] == 1
    assert fetcher.counters["request_timeouts"] == 0
    assert fetcher.counters["donor_failovers"] == 1
    assert nacker.counters["snapshots_nacked"] == 1
    assert sink.completed and not sink.failed


def test_all_donors_exhausted_reports_failure_and_recovers(tmp_path):
    mesh, clock = _Mesh(), _Clock()
    fetcher, sink = _engine(
        mesh, clock, tmp_path, 0, peers=(1, 2), donor_rounds=2
    )
    target = StateTarget(seq_no=10, value=b"cp10")
    fetcher.begin(target)
    _pump(mesh, fetcher, clock)  # nobody answers: every round times out
    assert fetcher.counters["snapshots_failed"] == 1
    assert sink.failed == [target] and not sink.completed
    assert fetcher.status()["phase"] == "idle"

    # failed() is a retry contract, not a dead end: the core re-emits
    # state_transfer and begin() must start a fresh fetch.
    donor, _ = _engine(mesh, clock, tmp_path, 1)
    snap = _snapshot()
    donor.note_checkpoint(
        snap.seq_no, snap.value, snap.network_state, snap.app_bytes,
        snap.requests,
    )
    fetcher.begin(target)
    _pump(mesh, fetcher, clock)
    assert fetcher.counters["snapshots_installed"] == 1


# -- crash-resume from the staged blob ---------------------------------------


def test_restart_resumes_from_staged_blob_without_network(tmp_path):
    """Crash between staging and install: the restarted engine finds the
    staged blob for the re-emitted target and completes with zero
    network traffic."""
    mesh, clock = _Mesh(), _Clock()
    snap = _snapshot()
    blob = encode_snapshot(snap)
    staging = tmp_path / "n0"
    staging.mkdir()
    write_snapshot_file(str(staging / "snapshot.staged"), blob)

    fetcher, sink = _engine(mesh, clock, tmp_path, 0, peers=(1, 2))
    fetcher.begin(StateTarget(seq_no=snap.seq_no, value=snap.value))
    fetcher.poll()
    assert fetcher.counters["snapshots_resumed_staged"] == 1
    assert fetcher.counters["snapshots_installed"] == 1
    assert sink.completed and not sink.failed
    assert mesh.log == []  # completed locally: no request ever sent
    assert read_snapshot_file(fetcher.staging_path) is None


def test_stale_staged_blob_discarded_and_fetched_fresh(tmp_path):
    """A staged blob for a different target (an older, superseded fetch)
    must not be adopted: it is discarded and the network fetch begins."""
    mesh, clock = _Mesh(), _Clock()
    stale = encode_snapshot(_snapshot(seq_no=5, value=b"cp5"))
    staging = tmp_path / "n0"
    staging.mkdir()
    write_snapshot_file(str(staging / "snapshot.staged"), stale)

    donor, _ = _engine(mesh, clock, tmp_path, 1)
    snap = _snapshot()
    donor.note_checkpoint(
        snap.seq_no, snap.value, snap.network_state, snap.app_bytes,
        snap.requests,
    )
    fetcher, sink = _engine(mesh, clock, tmp_path, 0, peers=(1,))
    fetcher.begin(StateTarget(seq_no=snap.seq_no, value=snap.value))
    _pump(mesh, fetcher, clock)
    assert fetcher.counters["snapshots_resumed_staged"] == 0
    assert fetcher.counters["snapshots_installed"] == 1
    (target, _ns), = sink.completed
    assert target.seq_no == snap.seq_no  # the new target, not the stale one


# -- ingress bounds and config validation ------------------------------------


def test_check_snapshot_chunk_bounds():
    limits = types.SimpleNamespace(
        max_snapshot_chunk_bytes=1024, max_snapshot_bytes=16 * 1024
    )
    check_snapshot_chunk(1024, 16, limits)  # exactly at both caps
    with pytest.raises(MalformedMessage) as err:
        check_snapshot_chunk(1025, 1, limits)
    assert err.value.kind == "oversized_snapshot_chunk"
    with pytest.raises(MalformedMessage):
        check_snapshot_chunk(0, 0, limits)  # zero chunks is malformed
    with pytest.raises(MalformedMessage):
        check_snapshot_chunk(10, 17, limits)  # reassembly could exceed cap


def test_config_validates_snapshot_bounds():
    Config(id=0)  # defaults are self-consistent
    with pytest.raises(ValueError):
        Config(id=0, max_snapshot_chunk_bytes=0)
    with pytest.raises(ValueError):
        Config(id=0, max_snapshot_bytes=1, max_snapshot_chunk_bytes=2)


# -- the certified-above-window trigger and the lag gauge --------------------


def _tracker():
    persisted = Persisted()
    persisted.add_c_entry(
        pb.CEntry(
            seq_no=0,
            checkpoint_value=b"genesis",
            network_state=_network_state(),
        )
    )
    my = pb.InitialParameters(id=0, buffer_size=1 << 20)
    tracker = CheckpointTracker(persisted, NodeBuffers(my), my)
    tracker.reinitialize()
    return tracker


def test_certified_above_window_needs_intersection_quorum():
    t = _tracker()
    high = t.high_watermark()
    seq = high + 25
    t.step(1, pb.Msg(type=pb.Checkpoint(seq_no=seq, value=b"cert")))
    t.step(2, pb.Msg(type=pb.Checkpoint(seq_no=seq, value=b"cert")))
    # 2 < 2f+1 = 3: not yet a transfer trigger, lag gauge stays flat.
    assert t.certified_above_window() is None
    assert t.lag_seqnos() == 0
    # A duplicate vote from the same node must not fake a quorum.
    t.step(2, pb.Msg(type=pb.Checkpoint(seq_no=seq, value=b"cert")))
    assert t.certified_above_window() is None
    t.step(3, pb.Msg(type=pb.Checkpoint(seq_no=seq, value=b"cert")))
    assert t.certified_above_window() == (seq, b"cert")
    assert t.lag_seqnos() == seq - high


def test_split_votes_never_certify():
    t = _tracker()
    seq = t.high_watermark() + 25
    t.step(1, pb.Msg(type=pb.Checkpoint(seq_no=seq, value=b"a")))
    t.step(2, pb.Msg(type=pb.Checkpoint(seq_no=seq, value=b"b")))
    t.step(3, pb.Msg(type=pb.Checkpoint(seq_no=seq, value=b"c")))
    assert t.certified_above_window() is None
    assert t.lag_seqnos() == 0


# -- the new chaos invariants ------------------------------------------------


def test_bounded_catchup_invariant():
    check_bounded_catchup(1000, 5000, 10_000)
    with pytest.raises(InvariantViolation):
        check_bounded_catchup(1000, None, 10_000)  # never caught up
    with pytest.raises(InvariantViolation):
        check_bounded_catchup(1000, 12_001, 10_000)  # blew the bound


def test_transfer_corruption_invariant():
    check_transfer_corruption_rejected(rejections=3, corrupted=5)
    with pytest.raises(InvariantViolation):
        check_transfer_corruption_rejected(rejections=0, corrupted=5)
    with pytest.raises(InvariantViolation):
        # Zero frames touched means the scenario proved nothing.
        check_transfer_corruption_rejected(rejections=0, corrupted=0)


# -- reconfiguration under fire (slow: real processes / real sockets) --------


# -- parity with the JAX package ---------------------------------------------


def _ref():
    from mirbft_tpu import pb as ref_pb
    from mirbft_tpu.runtime import transfer as ref_transfer

    return ref_pb, ref_transfer


def _seeded_snapshots(seed):
    """Seeded snapshots for both packages: the same fields, each package's
    own pb classes."""
    import random

    ref_pb, ref_transfer = _ref()
    rng = random.Random(seed)
    out = []
    for i in range(4):
        seq = rng.randrange(1, 1 << 20)
        value = rng.randbytes(rng.randrange(0, 40))
        app = rng.randbytes(rng.randrange(0, 3000))
        reqs = [
            (rng.randrange(1, 9), rng.randrange(0, 500), rng.randbytes(32),
             rng.randbytes(rng.randrange(0, 200)))
            for _ in range(rng.randrange(0, 6))
        ]
        built = []
        for codec, module in ((pb, None), (ref_pb, ref_transfer)):
            state = codec.NetworkState(
                config=codec.NetworkConfig(
                    nodes=list(range(4 + i)), f=1 + i // 3,
                    number_of_buckets=4 + i, checkpoint_interval=5 * (4 + i),
                    max_epoch_length=50,
                ),
                clients=[codec.NetworkClient(id=c, width=100,
                                             low_watermark=c * 3)
                         for c in range(1, 4)],
            )
            requests = [
                (codec.RequestAck(client_id=c, req_no=r, digest=d), data)
                for c, r, d, data in reqs
            ]
            cls = Snapshot if module is None else module.Snapshot
            built.append(cls(seq, value, state, app, requests))
        out.append(tuple(built))
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_snapshot_blobs_equal_the_jax_modules(seed):
    _ref_pb, ref_transfer = _ref()
    for port_snap, ref_snap in _seeded_snapshots(seed):
        blob = encode_snapshot(port_snap)
        assert blob == ref_transfer.encode_snapshot(ref_snap)
        ours = decode_snapshot(blob)
        theirs = ref_transfer.decode_snapshot(blob)
        assert (ours.seq_no, ours.value, ours.app_bytes) == (
            theirs.seq_no, theirs.value, theirs.app_bytes
        )
        assert pb.encode(ours.network_state) == _ref_pb.encode(
            theirs.network_state
        )
        assert [(pb.encode(a), d) for a, d in ours.requests] == [
            (_ref_pb.encode(a), d) for a, d in theirs.requests
        ]


@pytest.mark.parametrize("chunk_bytes", [1, 7, 256, 4096])
def test_chunk_chains_and_frames_equal_the_jax_modules(chunk_bytes):
    _ref_pb, ref_transfer = _ref()
    for port_snap, _ref_snap in _seeded_snapshots(chunk_bytes):
        blob = encode_snapshot(port_snap)
        payloads = split_chunks(blob, chunk_bytes)
        assert payloads == ref_transfer.split_chunks(blob, chunk_bytes)
        seq, value = port_snap.seq_no, port_snap.value
        digest = chain_seed(seq, value)
        ref_digest = ref_transfer.chain_seed(seq, value)
        assert digest == ref_digest
        for index, payload in enumerate(payloads):
            digest = chain_next(digest, payload)
            ref_digest = ref_transfer.chain_next(ref_digest, payload)
            assert digest == ref_digest
            frame = encode_chunk(seq, index, len(payloads), digest, payload)
            assert frame == ref_transfer.encode_chunk(
                seq, index, len(payloads), digest, payload
            )
            assert decode_frame(frame) == ref_transfer.decode_frame(frame)
        request = encode_request(seq, value, len(payloads) // 2)
        assert request == ref_transfer.encode_request(
            seq, value, len(payloads) // 2
        )
        assert decode_frame(request) == ref_transfer.decode_frame(request)
        nack = transfer_nack(seq)
        assert nack == ref_transfer.encode_nack(seq)
        assert decode_frame(nack) == ref_transfer.decode_frame(nack)


def test_staged_snapshot_files_equal_the_jax_packages(tmp_path):
    from mirbft_tpu.runtime import storage as ref_storage

    blob = encode_snapshot(_snapshot())
    write_snapshot_file(str(tmp_path / "port"), blob)
    ref_storage.write_snapshot_file(str(tmp_path / "ref"), blob)
    assert (tmp_path / "port").read_bytes() == (tmp_path / "ref").read_bytes()
    assert read_snapshot_file(str(tmp_path / "ref")) == blob
    assert ref_storage.read_snapshot_file(str(tmp_path / "port")) == blob


def test_port_fetcher_installs_from_a_jax_donor(tmp_path):
    """The port's fetcher pulls a snapshot from the JAX package's donor
    across one mesh (frames are bytes): the same blob, installed."""
    _ref_pb, ref_transfer = _ref()
    mesh, clock = _Mesh(), _Clock()
    (port_snap, ref_snap), = _seeded_snapshots(9)[:1]
    donor = ref_transfer.TransferEngine(
        1, mesh.duct(1), staging_dir=str(tmp_path), peers=(),
        limits=types.SimpleNamespace(max_snapshot_chunk_bytes=97,
                                     max_snapshot_bytes=1 << 20),
        chunk_timeout_s=1.0, clock=clock,
    )
    mesh.add(donor)
    donor.note_checkpoint(ref_snap.seq_no, ref_snap.value,
                          ref_snap.network_state, ref_snap.app_bytes,
                          ref_snap.requests)
    installed = []
    fetcher, sink = _engine(
        mesh, clock, tmp_path, 0, peers=(1,),
        install=lambda snap: installed.append(snap) or snap.network_state,
        limits=types.SimpleNamespace(max_snapshot_chunk_bytes=97,
                                     max_snapshot_bytes=1 << 20),
    )
    fetcher.begin(StateTarget(seq_no=port_snap.seq_no, value=port_snap.value))
    _pump(mesh, fetcher, clock)
    (snap,) = installed
    assert encode_snapshot(snap) == encode_snapshot(port_snap)
    assert fetcher.counters["chunks_received"] > 1
    assert len(sink.completed) == 1


# -- a commit quorum while a transfer is in flight ---------------------------


def _epoch_at_commit(active_epoch, commitstate, sequence, seq_no):
    """An active epoch of either package whose lowest uncommitted sequence
    has just gathered its commit quorum, and whose commit state has a
    transfer in flight (``_maybe_request_transfer`` fired on a certified
    checkpoint past the window while the epoch still runs)."""
    epoch = active_epoch.ActiveEpoch.__new__(active_epoch.ActiveEpoch)
    commit_state = commitstate.CommitState.__new__(commitstate.CommitState)
    commit_state.transferring = True
    seq = types.SimpleNamespace(
        seq_no=seq_no,
        state=sequence.SeqState.COMMITTED,
        q_entry=types.SimpleNamespace(seq_no=seq_no, digest=b"",
                                      requests=[]),
        apply_commit_msg=lambda source, digest: active_epoch.Actions(),
    )
    epoch.sequence = lambda n: seq
    epoch.lowest_uncommitted = seq_no
    epoch.high_watermark = lambda: seq_no + 1
    epoch.commit_state = commit_state
    return epoch


def test_commit_quorum_during_a_transfer_leaves_the_sequence_to_it():
    """The driver's run on the CPU saw a port replica's serializer die
    with "must never commit during state transfer" (seq 339, a null
    batch) in tests/test_torch_app.py's KV session: a lagging replica of
    the in-process cluster had asked for a transfer while its epoch ran,
    and a commit quorum arrived.  The JAX package's active epoch does the
    same; the port's returns without committing."""
    from mirbft_tpu.core import active_epoch as jax_active_epoch
    from mirbft_tpu.core import commitstate as jax_commitstate
    from mirbft_tpu.core import sequence as jax_sequence
    from mirbft_tpu_torch.core import active_epoch, commitstate, sequence

    ref = _epoch_at_commit(jax_active_epoch, jax_commitstate, jax_sequence,
                           339)
    with pytest.raises(AssertionError, match="never commit during state"):
        ref.apply_commit_msg(1, 339, b"")

    port = _epoch_at_commit(active_epoch, commitstate, sequence, 339)
    port.apply_commit_msg(1, 339, b"")
    assert port.lowest_uncommitted == 339
    assert port.commit_state.transferring
