"""The port's device ack plane (core/device_tracker.py) held to the JAX
package's gates (tests/test_device_tracker.py, one test here for each
there): plane selection, scalar-reference equivalence of the plane's step,
the divergence oracle catching an injected bit flip within one sampler
stride, a 10k-client parity sweep under a seeded ack storm, and the ack
metrics.  The JAX package's two fall-back tests become raise tests: the
port's plane never carries on with the host plane.  The plane runs on the
CPU here (``ack_device="cpu"``: the kernels' plain versions); the
10k-client storm also goes through the JAX package's host and device
planes, and the engine runs on the device plane against the JAX package's
host and device runs.  Exact everywhere: sets, masks and counts are equal
or the test fails."""

import numpy as np
import pytest
import torch

from mirbft_tpu import pb as ref_pb
from mirbft_tpu.core.client_tracker import ClientTracker as RefTracker
from mirbft_tpu.core.msgbuffers import NodeBuffers as RefBuffers
from mirbft_tpu.core.persisted import Persisted as RefPersisted
from mirbft_tpu.testengine import BasicRecorder as RefRecorder
import bench as ref_bench
from mirbft_tpu_torch import bench as port_bench
from mirbft_tpu_torch import pb
from mirbft_tpu_torch.core import device_tracker
from mirbft_tpu_torch.core.client_tracker import _NULL, ClientTracker
from mirbft_tpu_torch.core.msgbuffers import NodeBuffers
from mirbft_tpu_torch.core.persisted import Persisted
from mirbft_tpu_torch.core.preimage import host_digest, request_hash_data
from mirbft_tpu_torch.obsv import hooks, shadow
from mirbft_tpu_torch.obsv.metrics import ACK_BATCH_BUCKETS, CATALOG, Registry
from mirbft_tpu_torch.obsv.recorder import FlightRecorder
from mirbft_tpu_torch.runtime.config import Config
from mirbft_tpu_torch.testengine import BasicRecorder
from mirbft_tpu_torch.testengine.crypto_plane import AsyncKernelHashPlane

# -- tracker scaffolding (the JAX package's idiom) ----------------------------


def network_state(clients=((7, 100),), n=4, f=1, ci=5, package=pb):
    return package.NetworkState(
        config=package.NetworkConfig(
            nodes=list(range(n)),
            f=f,
            number_of_buckets=n,
            checkpoint_interval=ci,
            max_epoch_length=50,
        ),
        clients=[
            package.NetworkClient(id=cid, width=width, low_watermark=0)
            for cid, width in clients
        ],
    )


def make_tracker(state=None, ack_plane=None, ack_flush_rows=None,
                 ack_device="cpu"):
    persisted = Persisted()
    persisted.add_c_entry(
        pb.CEntry(
            seq_no=0,
            checkpoint_value=b"genesis",
            network_state=state if state is not None else network_state(),
        )
    )
    my = pb.InitialParameters(id=0, buffer_size=1 << 20)
    ct = ClientTracker(
        persisted, NodeBuffers(my), my, ack_plane=ack_plane,
        ack_flush_rows=ack_flush_rows, ack_device=ack_device,
    )
    ct.reinitialize()
    return ct


def make_ref_tracker(state, ack_plane):
    persisted = RefPersisted()
    persisted.add_c_entry(
        ref_pb.CEntry(seq_no=0, checkpoint_value=b"genesis",
                      network_state=state)
    )
    my = ref_pb.InitialParameters(id=0, buffer_size=1 << 20)
    ct = RefTracker(persisted, RefBuffers(my), my, ack_plane=ack_plane)
    ct.reinitialize()
    return ct


def req(client_id=7, req_no=0, data=b"tx"):
    r = pb.Request(client_id=client_id, req_no=req_no, data=data)
    digest = host_digest(request_hash_data(r))
    return r, pb.RequestAck(client_id=client_id, req_no=req_no, digest=digest)


def ack_msg(ack):
    return pb.Msg(type=ack)


def build_device_tracker(n_reqs=40):
    """Device-plane tracker after a three-source ack storm over reqs
    0..n_reqs-1 (every slot ends with a strong certificate)."""
    ct = make_tracker(ack_plane="device")
    assert ct._device_ok
    acks = [req(req_no=i)[1] for i in range(n_reqs)]
    for source in (1, 2, 3):
        ct.step_ack_many(source, [ack_msg(a) for a in acks])
    assert ct._device is not None, "device plane never built"
    assert ct._fast is None, "host mirror must not coexist with the plane"
    return ct, acks


# -- plane selection ----------------------------------------------------------


def test_config_validates_ack_plane_and_shadow_stride():
    Config(id=0, ack_plane="device", shadow_stride=4, ack_flush_rows=4096,
           ack_device="cpu")
    with pytest.raises(ValueError, match="ack_plane"):
        Config(id=0, ack_plane="gpu")
    with pytest.raises(ValueError, match="shadow_stride"):
        Config(id=0, shadow_stride=0)
    with pytest.raises(ValueError, match="ack_flush_rows"):
        Config(id=0, ack_flush_rows=0)
    with pytest.raises(ValueError, match="ack_device"):
        Config(id=0, ack_device="tpu")


def test_resolve_ack_plane_explicit_env_default(monkeypatch):
    monkeypatch.delenv("MIRBFT_ACK_PLANE", raising=False)
    assert device_tracker.resolve_ack_plane() == "host"
    monkeypatch.setenv("MIRBFT_ACK_PLANE", "device")
    assert device_tracker.resolve_ack_plane() == "device"
    # Explicit config beats the env knob.
    assert device_tracker.resolve_ack_plane("host") == "host"
    with pytest.raises(ValueError, match="ack_plane"):
        device_tracker.resolve_ack_plane("tpu")
    monkeypatch.setenv("MIRBFT_ACK_PLANE", "bogus")
    with pytest.raises(ValueError, match="ack_plane"):
        device_tracker.resolve_ack_plane()


def test_resolve_stride_explicit_env_default(monkeypatch):
    monkeypatch.delenv("MIRBFT_SHADOW_STRIDE", raising=False)
    assert shadow.resolve_stride() == shadow.DEFAULT_STRIDE
    monkeypatch.setenv("MIRBFT_SHADOW_STRIDE", "3")
    assert shadow.resolve_stride() == 3
    assert shadow.resolve_stride(7) == 7  # explicit wins
    assert shadow.ShadowSampler(stride=5).stride == 5


def test_resolve_flush_rows_explicit_env_default(monkeypatch):
    monkeypatch.delenv("MIRBFT_ACK_FLUSH_ROWS", raising=False)
    assert device_tracker.resolve_flush_rows() == 1
    monkeypatch.setenv("MIRBFT_ACK_FLUSH_ROWS", "4096")
    assert device_tracker.resolve_flush_rows() == 4096
    assert device_tracker.resolve_flush_rows(8) == 8  # explicit wins
    with pytest.raises(ValueError, match="ack_flush_rows"):
        device_tracker.resolve_flush_rows(0)
    monkeypatch.setenv("MIRBFT_ACK_FLUSH_ROWS", "zap")
    with pytest.raises(ValueError, match="ack_flush_rows"):
        device_tracker.resolve_flush_rows()


def test_device_plane_raises_without_a_card(monkeypatch):
    """Where the JAX package fell back to the host path without a usable
    backend, the port raises: ``ack_device="cuda"`` and no card stops the
    tracker at construction, and the plane's own build raises too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_tracker(ack_plane="device", ack_device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        device_tracker.DeviceClientPlane(make_tracker(), device="cuda")
    with pytest.raises(ValueError, match="ack_device"):
        make_tracker(ack_plane="device", ack_device="tpu")


def test_device_plane_raises_when_construction_raises(monkeypatch):
    """A plane whose construction dies raises out of the frame that built
    it, and out of the next frame too: the host mirror never takes over."""
    monkeypatch.setattr(
        device_tracker,
        "DeviceClientPlane",
        type("Boom", (), {"__init__": lambda self, *a, **k: 1 / 0}),
    )
    ct = make_tracker(ack_plane="device")
    assert ct._device_ok
    acks = [req(req_no=i)[1] for i in range(40)]
    for _ in range(2):
        with pytest.raises(ZeroDivisionError):
            ct.step_ack_many(1, [ack_msg(a) for a in acks])
        assert ct._device is None and ct._fast is None
    assert not ct.client(7).req_no(0).requests


# -- scalar-reference equivalence --------------------------------------------


def test_device_plane_matches_scalar_reference():
    ct, acks = build_device_tracker()
    dev = ct._device
    assert dev.acks_fallback == 0, "clean storm must not fall back"
    crn = ct.client(7).req_no(0)
    assert acks[0].digest in crn.weak_requests
    assert acks[0].digest in crn.strong_requests
    assert shadow.audit_tracker(ct) == []
    certs = dev.quorum_sweep()
    assert certs == {"weak_certs": 40, "strong_certs": 40, "committed": 0}


def test_conflicting_digest_falls_back_to_scalar_path():
    """A second distinct digest for an adopted slot cannot be a dense row:
    the step flags it, the scalar reference path absorbs it, and the slot
    goes host-authoritative with no divergence."""
    ct, acks = build_device_tracker(n_reqs=4)
    evil = req(req_no=0, data=b"conflicting")[1]
    ct.step_ack_many(0, [ack_msg(evil)])
    assert ct._device.acks_fallback >= 1
    crn = ct.client(7).req_no(0)
    assert evil.digest in crn.requests  # scalar path recorded the vote
    assert acks[0].digest in crn.strong_requests  # canonical unharmed
    assert shadow.audit_tracker(ct) == []


def test_committed_slots_drop_acks_on_device():
    ct, acks = build_device_tracker(n_reqs=4)
    ct.mark_committed(7, 0, seq_no=1)
    dropped = ct._device.acks_dropped
    ct.step_ack_many(1, [ack_msg(acks[0])])
    assert ct._device.acks_dropped > dropped
    assert shadow.audit_tracker(ct) == []


def test_mixed_null_digest_and_out_of_window_frame():
    """One frame carrying a null-digest row (filtered out of the dense
    submit) AND a later out-of-window row: the out-row indices returned by
    submit_columns refer to the FILTERED subset, so the replay must map
    them back through it."""
    ct, acks = build_device_tracker(n_reqs=4)
    null_ack = pb.RequestAck(client_id=7, req_no=1, digest=b"")
    oow = pb.RequestAck(client_id=7, req_no=150, digest=b"\x07" * 32)
    frame = [ack_msg(null_ack), ack_msg(acks[2]), ack_msg(oow)]
    buf = ct.msg_buffers[0]
    assert len(buf) == 0
    ct.step_ack_many(0, frame)
    # The out-of-window ack is FUTURE: buffered, never dropped.
    assert [m.type.req_no for m, _ in buf.msgs] == [150]
    # The null-digest ack took the scalar path into slot (7, 1).
    crn1 = ct.client(7).req_no(1)
    assert _NULL in crn1.requests
    assert crn1.requests[_NULL].agreements & 1  # node 0's vote
    # The dense row went through the step exactly once.
    dev = ct._device
    dev.sync_slot(7, 2)
    crn2 = ct.client(7).req_no(2)
    assert crn2.requests[acks[2].digest].agreements == 0b1111
    assert shadow.audit_tracker(ct) == []


def test_sync_slot_drains_buffered_events_from_column_ingest():
    """sync_slot must drain queued batches AND buffered boundary events
    into the owning tracker before staging the slot, or the next staged
    re-derivation rebuilds the row from vote-less objects and the applied
    acks vanish."""
    ct = make_tracker(ack_plane="device")
    assert ct._device_ok
    dev = ct._build_device()
    assert dev is not None
    acks = [req(req_no=i)[1] for i in range(4)]
    ids = np.array([a.client_id for a in acks], dtype=np.int64)
    rnos = np.array([a.req_no for a in acks], dtype=np.int64)
    dig_mat = np.frombuffer(
        b"".join(a.digest for a in acks), dtype=np.uint8
    ).reshape(len(acks), 32)
    for s in (1, 2):
        assert len(dev.submit_columns(s, ids, rnos, dig_mat)) == 0
        dev.flush(drain=None)
    assert len(dev.submit_columns(3, ids, rnos, dig_mat)) == 0
    assert dev._events and dev._pending_rows == 4
    dev.sync_slot(7, 0)
    assert not dev._events and dev._pending_rows == 0
    crn = ct.client(7).req_no(0)
    assert acks[0].digest in crn.requests
    assert crn.requests[acks[0].digest].agreements == 0b1110
    assert acks[0].digest in crn.weak_requests
    assert acks[0].digest in crn.strong_requests
    assert crn.non_null_voters == 0b1110
    assert shadow.audit_tracker(ct) == []


def test_small_frame_coalescing_defers_flush_until_sync_points():
    """ack_flush_rows > 1 coalesces small frames in the pending queue: no
    step until the row threshold, with scalar-mutation sync (sync_slot)
    and the tick boundary forcing an earlier flush and drain."""
    ct = make_tracker(ack_plane="device", ack_flush_rows=16)
    acks = [req(req_no=i)[1] for i in range(8)]
    frame = [ack_msg(a) for a in acks]
    ct.step_ack_many(1, frame)
    dev = ct._device
    assert dev is not None
    assert dev.flush_rows == 16
    assert dev.batches == 0 and dev._pending_rows == 8  # deferred
    crn = ct.client(7).req_no(0)
    assert acks[0].digest not in crn.requests  # not yet materialized
    ct.step_ack_many(2, frame)  # 16 rows reach the threshold
    assert dev.batches == 1 and dev._pending_rows == 0
    assert acks[0].digest in crn.weak_requests  # events drained at flush
    ct.step_ack_many(3, frame)  # deferred again (8 < 16)
    assert dev.batches == 1 and dev._pending_rows == 8
    assert acks[0].digest not in crn.strong_requests
    ct.step_ack(3, ack_msg(acks[0]))
    assert dev.batches == 2 and dev._pending_rows == 0
    assert acks[0].digest in crn.strong_requests
    assert shadow.audit_tracker(ct) == []
    acks2 = [req(req_no=8 + i)[1] for i in range(4)]
    ct.step_ack_many(1, [ack_msg(a) for a in acks2])
    assert dev.batches == 2 and dev._pending_rows == 4
    ct.tick()
    assert dev.batches == 3 and dev._pending_rows == 0
    crn8 = ct.client(7).req_no(8)
    assert crn8.requests[acks2[0].digest].agreements == 0b0010
    assert shadow.audit_tracker(ct) == []


# -- injected divergence ------------------------------------------------------


def test_injected_device_bitflip_caught_within_stride(tmp_path):
    """Flip one agreement bit in the device bitmask (a vote the scalar
    state never saw): the sampling shadow must catch it within one stride
    of touched frames and dump the port's flight recorder."""
    ct, acks = build_device_tracker(n_reqs=8)
    dev = ct._device
    slot = dev.slot_of(7, 0)
    ci, w = slot // dev.w_pad, slot % dev.w_pad
    dev._dev[0][ci, w, 0] &= ~(1 << 3)
    dev._snapshot = None

    reg = Registry()
    rec = FlightRecorder("device-shadow-test", dump_dir=str(tmp_path))
    sampler = shadow.ShadowSampler(stride=2, registry=reg, recorder=rec)
    hooks.shadow = sampler
    try:
        frames = 0
        while not sampler.divergences and frames < 8:
            ct.step_ack_many(1, [ack_msg(acks[0])])
            frames += 1
        assert sampler.divergences, "sampler never saw the bit flip"
        assert frames <= sampler.stride, "not caught within one stride"
        comps = {d["component"] for d in sampler.divergences}
        assert "strong" in comps
        snap = reg.snapshot()
        total = sum(
            s["value"] for s in snap["mirbft_divergence_total"]["series"]
        )
        assert total >= 1
        assert sampler._dumped
        assert any(tmp_path.iterdir()), "no flight-recorder dump written"
    finally:
        hooks.shadow = None


# -- 10k-client parity sweep --------------------------------------------------


def test_parity_sweep_10k_clients_under_seeded_ack_storm():
    """The port's host and device planes and the JAX package's host and
    device planes absorb the identical seeded ack storm (shuffled frames,
    duplicates, conflicting digests, out-of-window rows) at 10k clients;
    sampled slots must agree object for object across all four, the two
    device planes' sweeps must agree, and the oracle must find nothing."""
    n_clients = 10_000
    frame = 2048
    rng = np.random.default_rng(0xD1CE)
    clients = tuple((cid, 1) for cid in range(n_clients))
    host = make_tracker(network_state(clients=clients), ack_plane="host")
    devt = make_tracker(network_state(clients=clients), ack_plane="device")
    ref_host = make_ref_tracker(
        network_state(clients=clients, package=ref_pb), "host"
    )
    ref_dev = make_ref_tracker(
        network_state(clients=clients, package=ref_pb), "device"
    )
    assert devt._device_ok and ref_dev._device_ok

    digests = {}

    def storm_ack(cid, data=b"tx"):
        d = digests.get((int(cid), data))
        if d is None:
            r = pb.Request(client_id=int(cid), req_no=0, data=data)
            d = digests[(int(cid), data)] = host_digest(request_hash_data(r))
        return (int(cid), 0, d)

    conflicted = set(rng.choice(n_clients, size=100, replace=False).tolist())
    for source in (1, 2, 3):
        order = rng.permutation(n_clients)
        rows = []
        for cid in order.tolist():
            data = b"fork" if source == 3 and cid in conflicted else b"tx"
            rows.append(storm_ack(cid, data))
        for cid in rng.choice(n_clients, size=64, replace=False).tolist():
            rows.append(storm_ack(cid))
            rows.append((int(cid), 50, b"\x07" * 32))
        for lo in range(0, len(rows), frame):
            chunk = rows[lo:lo + frame]
            for tracker, package in ((host, pb), (devt, pb),
                                     (ref_host, ref_pb), (ref_dev, ref_pb)):
                tracker.step_ack_many(source, [
                    package.Msg(type=package.RequestAck(
                        client_id=c, req_no=n, digest=d))
                    for c, n, d in chunk
                ])

    dev, ref_plane = devt._device, ref_dev._device
    assert dev is not None and ref_plane is not None
    certs = dev.quorum_sweep()
    assert certs == ref_plane.quorum_sweep()
    assert certs["strong_certs"] == n_clients - len(conflicted)
    assert certs["committed"] == 0
    snap, ref_snap = dev.host_snapshot(), ref_plane.host_snapshot()
    for name in ("agree", "nonnull", "canon", "canon_ok", "flags", "held",
                 "tick_class"):
        np.testing.assert_array_equal(
            snap[name], ref_snap[name].reshape(snap[name].shape),
            err_msg=name,
        )

    sample = rng.choice(n_clients, size=1500, replace=False)
    for cid in sample.tolist():
        dev.sync_slot(cid, 0)
        ref_plane.sync_slot(cid, 0)
        slots = [t.clients[cid].req_no_map[0]
                 for t in (host, devt, ref_host, ref_dev)]
        first = slots[0]
        for other in slots[1:]:
            assert set(first.requests) == set(other.requests), cid
            assert set(first.weak_requests) == set(other.weak_requests), cid
            assert set(first.strong_requests) == set(
                other.strong_requests
            ), cid
            assert first.non_null_voters == other.non_null_voters, cid
            for digest, hreq in first.requests.items():
                assert hreq.agreements == other.requests[digest].agreements

    audit = rng.choice(n_clients, size=1500, replace=False)
    slots = [int(c) * dev.w_pad for c in audit.tolist()]
    assert shadow.audit_tracker(devt, slots=slots) == []


# -- metrics ------------------------------------------------------------------


def test_ack_metrics_emitted_from_both_planes():
    assert "mirbft_ack_events_total" in CATALOG
    assert "mirbft_ack_batch_size" in CATALOG
    reg = Registry()
    hooks.enable(registry=reg)
    try:
        acks = [req(req_no=i)[1] for i in range(40)]
        host = make_tracker(ack_plane="host")
        host.step_ack_many(1, [ack_msg(a) for a in acks])
        devt = make_tracker(ack_plane="device")
        devt.step_ack_many(1, [ack_msg(a) for a in acks])
        assert devt._device is not None
    finally:
        hooks.disable()
    snap = reg.snapshot()
    events = {
        s["labels"]["plane"]: s["value"]
        for s in snap["mirbft_ack_events_total"]["series"]
    }
    assert events == {"host": 40, "device": 40}
    batches = {
        s["labels"]["plane"]: s["count"]
        for s in snap["mirbft_ack_batch_size"]["series"]
    }
    assert batches == {"host": 1, "device": 1}
    assert ACK_BATCH_BUCKETS[0] == 1  # single-ack frames stay observable


# -- the engine on the device plane -------------------------------------------


def _decided(recorder):
    return (
        recorder.event_count,
        {n: s.app_chain.hex() for n, s in recorder.node_states.items()},
        {n: list(s.committed_reqs) for n, s in recorder.node_states.items()},
    )


@pytest.mark.parametrize("shape,events", [((1, 1, 3), 19), ((4, 4, 20), 332)],
                         ids=["1x1x3", "4x4x20"])
def test_engine_on_the_device_plane_matches_both_jax_runs(
    monkeypatch, shape, events
):
    """The port's engine with every node on the device plane (its plain
    version on the CPU) gives the anchors' event counts, and the same app
    chains and committed sequences as the JAX package's host-plane and
    device-plane runs; every ack frame went through the plane."""
    reg = Registry()
    hooks.enable(registry=reg)
    try:
        port = BasicRecorder(
            *shape, hash_plane=AsyncKernelHashPlane(device="cpu"),
            ack_plane="device", ack_device="cpu",
        )
        assert port.drain_clients(max_steps=200_000) == events
    finally:
        hooks.disable()
    series = reg.snapshot()["mirbft_ack_events_total"]["series"]
    planes = {s["labels"]["plane"]: s["value"] for s in series}
    assert set(planes) == {"device"} and planes["device"] > 0

    monkeypatch.setenv("MIRBFT_ACK_PLANE", "host")
    ref_host = RefRecorder(*shape)
    assert ref_host.drain_clients(max_steps=200_000) == events
    monkeypatch.setenv("MIRBFT_ACK_PLANE", "device")
    ref_dev = RefRecorder(*shape)
    assert ref_dev.drain_clients(max_steps=200_000) == events
    assert _decided(port) == _decided(ref_host) == _decided(ref_dev)


def test_ackplane_rung_on_the_cpu_matches_the_jax_rung(monkeypatch):
    """The port's ack-plane rung, cut to 4000 clients (frames of 500) with
    its device plane on the CPU, against the JAX package's rung at the same
    size: the same keys, and the same certificates, fallback, dropped,
    divergence and parity verdicts."""
    port = port_bench.ackplane_run(device="cpu", clients=4000)
    monkeypatch.setattr(ref_bench, "ACKPLANE_CLIENTS", 4000)
    monkeypatch.setattr(ref_bench, "ACKPLANE_FRAME", 500)
    ref = ref_bench.ackplane_run()
    assert set(ref) <= set(port)
    for key in ("clients", "events_total", "strong_certs", "weak_certs",
                "fallback_rows", "dropped_rows", "divergences",
                "parity_mismatches"):
        assert port[key] == ref[key], key
    assert port["strong_certs"] == port["weak_certs"] == 4000
    assert port["divergences"] == port["parity_mismatches"] == 0
    assert port["step_launches"] == port["sweep_launches"] == 0  # the CPU


def test_device_plane_anchor_16x64x25_matches_the_host_plane():
    """The determinism anchor chip_smoke phase 12 runs on the card, here on
    the plain versions: 16 nodes x 64 clients x 25 requests, BatchSize
    200, every node's ack plane on the device plane, gives 2320 events and
    the host plane run's app chains and committed sequences."""
    runs = []
    for plane in ("host", "device"):
        rec = BasicRecorder(
            16, 64, 25, batch_size=200, record=False, ack_plane=plane,
            ack_device="cpu", hash_plane=AsyncKernelHashPlane(device="cpu"),
        )
        assert rec.drain_clients(max_steps=20_000_000) == 2320
        runs.append(_decided(rec))
    assert runs[0] == runs[1]
    assert len(set(runs[1][1].values())) == 1
