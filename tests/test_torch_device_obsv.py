"""The port's device-plane telemetry (obsv/device.py), divergence oracle
(obsv/shadow.py) and flight recorder (obsv/recorder.py), held to the JAX
package's gates (the shadow and recorder parts of tests/test_device_obsv.py):
the kernel histogram through the strict catalog, launch shapes counted
against the retrace budget, the oracle clean on a converged tracker and
catching a missed promotion, a stale tick class and an injected divergence
within one stride, with a flight-recorder dump.  The dumps the port writes
read back in the JAX package's loader."""

import json
import sys

import numpy as np
import pytest
import torch

from mirbft_tpu.obsv import recorder as ref_recorder
from mirbft_tpu_torch import pb
from mirbft_tpu_torch.core.client_tracker import ClientTracker
from mirbft_tpu_torch.core.msgbuffers import NodeBuffers
from mirbft_tpu_torch.core.persisted import Persisted
from mirbft_tpu_torch.core.preimage import host_digest, request_hash_data
from mirbft_tpu_torch.obsv import device, hooks, shadow
from mirbft_tpu_torch.obsv.metrics import CATALOG, CATALOG_LABELS, Registry
from mirbft_tpu_torch.obsv.recorder import (
    FlightRecorder,
    dump_to_trace,
    load_dumps,
    postmortem,
)

# -- tracker scaffolding ------------------------------------------------------


def network_state(clients=((7, 100),), n=4, f=1, ci=5):
    return pb.NetworkState(
        config=pb.NetworkConfig(
            nodes=list(range(n)),
            f=f,
            number_of_buckets=n,
            checkpoint_interval=ci,
            max_epoch_length=50,
        ),
        clients=[
            pb.NetworkClient(id=cid, width=width, low_watermark=0)
            for cid, width in clients
        ],
    )


def make_tracker(state=None):
    persisted = Persisted()
    persisted.add_c_entry(
        pb.CEntry(
            seq_no=0,
            checkpoint_value=b"genesis",
            network_state=state if state is not None else network_state(),
        )
    )
    my = pb.InitialParameters(id=0, buffer_size=1 << 20)
    ct = ClientTracker(persisted, NodeBuffers(my), my)
    ct.reinitialize()
    return ct


def req(client_id=7, req_no=0, data=b"tx"):
    r = pb.Request(client_id=client_id, req_no=req_no, data=data)
    digest = host_digest(request_hash_data(r))
    return r, pb.RequestAck(client_id=client_id, req_no=req_no, digest=digest)


def ack_msg(ack):
    return pb.Msg(type=ack)


def build_mirror():
    """Tracker with a live _FastAcks mirror: one large frame from node 1."""
    ct = make_tracker()
    assert ct._fast_ok
    acks = [req(req_no=i)[1] for i in range(40)]
    ct.step_ack_many(1, [ack_msg(a) for a in acks])
    assert ct._fast is not None
    return ct, acks


# -- device instrumentation --------------------------------------------------


def test_instrument_is_passthrough_when_capture_off(monkeypatch):
    device.reset()
    monkeypatch.setattr(hooks, "enabled", False)

    @device.instrument("toy")
    def f(x):
        return x * 2

    assert f(3) == 6
    assert device.report(Registry())["retraces"] == {}


@pytest.mark.parametrize("make", [
    lambda: np.zeros(16, dtype=np.uint32),
    lambda: torch.zeros(16, dtype=torch.int32),
], ids=["numpy", "torch"])
def test_kernel_histogram_roundtrips_through_strict_catalog(make):
    device.reset()
    reg = Registry()  # strict: undeclared names/labels raise KeyError
    hooks.enable(registry=reg)
    try:

        @device.instrument("toy_kernel")
        def f(x):
            return x + 1

        a = make()
        f(a)
        f(a)
        rep = device.report(reg)
        kern = rep["kernel_seconds"]["toy_kernel"]
        assert kern["count"] == 2
        assert kern["total_s"] >= 0.0
        assert kern["mean_ms"] >= 0.0
        assert rep["transfer_bytes"] == {}  # the plane counts its copies
        assert rep["retraces"] == {"f": 1}
        assert rep["retrace_breaches"] == []
        series = reg.snapshot()["mirbft_device_kernel_seconds"]["series"]
        assert series[0]["labels"] == {"kernel": "toy_kernel"}
    finally:
        hooks.disable()
        device.reset()


def test_device_metrics_are_cataloged_with_declared_labels():
    expected = {
        "mirbft_device_kernel_seconds": ("kernel",),
        "mirbft_device_retraces_total": ("fn",),
        "mirbft_device_transfer_bytes_total": ("direction",),
        "mirbft_device_live_buffers": (),
        "mirbft_device_live_buffer_bytes": (),
        "mirbft_device_hbm_bytes": (),
        "mirbft_divergence_total": ("component",),
    }
    for name, labels in expected.items():
        assert name in CATALOG, name
        assert CATALOG_LABELS[name] == labels, name


def test_new_launch_shapes_trip_the_retrace_budget():
    device.reset()
    reg = Registry()
    hooks.enable(registry=reg)
    try:

        @device.instrument("poly", fn_name="poly")
        def g(x):
            return x

        for n in range(1, device.RETRACE_BUDGET + 1):
            g(torch.zeros(n, dtype=torch.uint8))
        rep = device.report(reg)
        assert rep["retraces"]["poly"] == device.RETRACE_BUDGET
        assert rep["retrace_budget"] == 8
        assert rep["retrace_breaches"] == []
        g(torch.zeros(99, dtype=torch.uint8))  # one shape past the budget
        rep = device.report(reg)
        assert rep["retraces"]["poly"] == 9
        assert "poly" in rep["retrace_breaches"]
    finally:
        hooks.disable()
        device.reset()


def test_sequence_lengths_bucket_to_pow2_signatures():
    device.reset()
    reg = Registry()
    hooks.enable(registry=reg)
    try:

        @device.instrument("seqy", fn_name="seqy")
        def g(items):
            return items

        for n in (5, 6, 7, 8):  # all bucket to 8: one shape
            g(list(range(n)))
        assert device.report(reg)["retraces"]["seqy"] == 1
        g(list(range(9)))  # bucket 16: a new shape
        assert device.report(reg)["retraces"]["seqy"] == 2
    finally:
        hooks.disable()
        device.reset()


def test_the_ack_plane_runs_in_few_launch_shapes():
    """The plane pads its batches to power-of-two buckets: a storm of
    frames of many sizes is a handful of launch shapes, well inside the
    budget, counted under the JAX package's program names."""
    from mirbft_tpu_torch.core import device_tracker

    device.reset()
    reg = Registry()
    hooks.enable(registry=reg)
    try:
        persisted = Persisted()
        persisted.add_c_entry(pb.CEntry(
            seq_no=0, checkpoint_value=b"genesis",
            network_state=network_state(clients=((7, 100), (8, 100))),
        ))
        my = pb.InitialParameters(id=0, buffer_size=1 << 20)
        ct = ClientTracker(persisted, NodeBuffers(my), my,
                           ack_plane="device", ack_device="cpu")
        ct.reinitialize()
        for size in (1, 3, 17, 40, 90):
            acks = [req(client_id=7 + i % 2, req_no=i // 2)[1]
                    for i in range(size)]
            ct.step_ack_many(1, [ack_msg(a) for a in acks])
        ct._device.quorum_sweep()
        rep = device.report(reg)
        assert rep["retraces"] == {"device_ack_step": 1,
                                   "device_quorum_sweep": 1}
        assert rep["kernel_seconds"]["device_ack_step"]["count"] == 5
        assert device_tracker.batch_rows(90) == device_tracker.MIN_BATCH_ROWS
        assert rep["retrace_breaches"] == []
        assert rep["transfer_bytes"] == {}  # a CPU plane copies nothing
    finally:
        hooks.disable()
        device.reset()


def test_transfers_count_only_copies_to_and_from_a_card(monkeypatch):
    device.reset()
    monkeypatch.setattr(hooks, "enabled", False)
    device.transfer("h2d", 64, torch.device("cuda"))  # hooks off: nothing
    reg = Registry()
    hooks.enable(registry=reg)
    try:
        device.transfer("h2d", 64, torch.device("cpu"))
        assert device.report(reg)["transfer_bytes"] == {}
        device.transfer("h2d", 64, torch.device("cuda"))
        device.transfer("h2d", 32, torch.device("cuda", 0))
        device.transfer("d2h", 16, torch.device("cuda"))
        assert device.report(reg)["transfer_bytes"] == {"h2d": 96, "d2h": 16}
    finally:
        hooks.disable()
        device.reset()


def test_memory_sample_without_a_card_is_none(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert device.memory_sample() is None
    monkeypatch.delitem(sys.modules, "torch")
    assert device.memory_sample() is None


# -- divergence oracle -------------------------------------------------------


def test_oracle_clean_on_converged_tracker():
    ct, acks = build_mirror()
    ct.step_ack_many(2, [ack_msg(a) for a in acks[:3]])  # loop path
    ct.step_ack_many(3, [ack_msg(a) for a in acks])  # vector path
    assert shadow.audit_tracker(ct) == []


def test_forward_request_promotion_leaves_no_divergence():
    ct, acks = build_mirror()
    r, ack = req(req_no=0)
    fwd = pb.Msg(type=pb.ForwardRequest(request_ack=ack, request_data=r.data))
    ct.step(2, fwd)
    ct.step(3, fwd)
    crn = ct.client(7).req_no(0)
    assert ack.digest in crn.weak_requests
    assert ack.digest in crn.strong_requests
    assert shadow.audit_tracker(ct) == []


def test_oracle_catches_missed_weak_promotion():
    ct, acks = build_mirror()
    crn = ct.client(7).req_no(0)
    reqobj = crn.requests[acks[0].digest]
    reqobj.agreements |= (1 << 2) | (1 << 3)
    divs = shadow.audit_tracker(ct)
    comps = {d["component"] for d in divs}
    assert "weak" in comps and "strong" in comps
    [weak] = [d for d in divs if d["component"] == "weak"]
    assert weak["client_id"] == 7 and weak["req_no"] == 0


def test_oracle_catches_stale_tick_class():
    ct, acks = build_mirror()
    ct.step_ack_many(2, [ack_msg(acks[0])])  # weak crossing -> TICK_PYTHON
    fast = ct._fast
    slot = fast.slot_of(7, 0)
    assert fast.tick_class[slot] == fast.TICK_PYTHON
    assert shadow.audit_tracker(ct, [slot]) == []
    fast.tick_class[slot] = fast.TICK_INERT  # simulate the missed refresh
    divs = shadow.audit_tracker(ct, [slot])
    assert [d["component"] for d in divs] == ["tick_class"]


def test_shadow_sampler_catches_injected_divergence_within_stride(tmp_path):
    ct, acks = build_mirror()
    reg = Registry()
    rec = FlightRecorder("shadow-test", dump_dir=str(tmp_path))
    sampler = shadow.ShadowSampler(stride=2, registry=reg, recorder=rec)
    hooks.shadow = sampler
    try:
        crn = ct.client(7).req_no(0)
        reqobj = crn.requests[acks[0].digest]
        reqobj.agreements |= (1 << 2) | (1 << 3)
        touch = req(req_no=0, data=b"conflicting")[1]
        frames = 0
        while not sampler.divergences and frames < 8:
            ct.step_ack_many(1, [ack_msg(touch)])
            frames += 1
        assert sampler.divergences, "sampler never saw the divergence"
        assert frames <= sampler.stride, "divergence not caught in one stride"
        snap = reg.snapshot()
        total = sum(
            s["value"] for s in snap["mirbft_divergence_total"]["series"]
        )
        assert total >= 1
        assert sampler._dumped
        assert any(tmp_path.iterdir()), "no flight-recorder dump written"
    finally:
        hooks.shadow = None


def test_oracle_audits_the_device_plane_slot_by_slot():
    """A device-plane tracker (plain version on the CPU) audits clean; a
    tick class flipped on the device is a divergence of that slot only."""
    ct = ClientTracker(*_fixture_args(), ack_plane="device", ack_device="cpu")
    ct.reinitialize()
    acks = [req(req_no=i)[1] for i in range(6)]
    for source in (1, 2):
        ct.step_ack_many(source, [ack_msg(a) for a in acks])
    dev = ct._device
    assert shadow.audit_tracker(ct) == []
    slot = dev.slot_of(7, 3)
    dev._dev[6].view(-1)[slot] = 1 - int(dev._dev[6].view(-1)[slot])
    dev._snapshot = None
    divs = shadow.audit_tracker(ct)
    assert [(d["component"], d["req_no"]) for d in divs] == [
        ("tick_class", 3)
    ]


def _fixture_args():
    persisted = Persisted()
    persisted.add_c_entry(pb.CEntry(
        seq_no=0, checkpoint_value=b"genesis", network_state=network_state()
    ))
    my = pb.InitialParameters(id=0, buffer_size=1 << 20)
    return persisted, NodeBuffers(my), my


# -- flight recorder ---------------------------------------------------------


def test_recorder_ring_keeps_the_newest_and_counts_at_flush(tmp_path):
    reg = Registry()
    rec = FlightRecorder(3, dump_dir=str(tmp_path), capacity=4,
                         autoflush_every=0, registry=reg)
    for i in range(6):
        rec.record_event(f"e{i}")
    rec.record_note("shadow.divergence", args={"count": 1})
    path = rec.flush("test")
    dump = json.loads(open(path).read())
    assert [e["name"] for e in dump["entries"]] == [
        "e3", "e4", "e5", "shadow.divergence"
    ]
    assert dump["recorded"] == 7 and dump["overwritten"] == 3
    snap = reg.snapshot()
    kinds = {s["labels"]["kind"]: s["value"]
             for s in snap["mirbft_recorder_records_total"]["series"]}
    assert kinds == {"event": 6, "note": 1}
    # The JAX package's loader reads the port's dumps: one schema.
    [(loaded_path, loaded)] = ref_recorder.load_dumps(str(tmp_path)).values()
    assert loaded == dump and loaded_path == path
    assert dump_to_trace(dump) == ref_recorder.dump_to_trace(dump)


def test_postmortem_merges_four_nodes_dumps(tmp_path):
    """``postmortem`` loads every node's newest dump, converts each with
    its clock offsets and merges them onto one lane a node, as the JAX
    package's does on the same dumps (exactly)."""
    for node in range(4):
        rec = FlightRecorder(node, dump_dir=str(tmp_path), autoflush_every=0)
        rec.set_clock_offsets({peer: 250 * node for peer in range(4)
                               if peer != node})
        rec.record_milestone("commit", args={"seq": node})
        rec.record_event("apply", args={"seq": node})
        rec.flush()
    assert set(load_dumps(str(tmp_path))) == {0, 1, 2, 3}
    out = tmp_path / "merged.json"
    result = postmortem(str(tmp_path), out_path=str(out))
    ref = ref_recorder.postmortem(str(tmp_path))
    assert result["nodes"] == ref["nodes"] == [0, 1, 2, 3]
    assert result["merged"] == ref["merged"] == json.loads(out.read_text())
    assert result["timeline"] == ref["timeline"]
    lanes = {e["pid"] for e in result["merged"]["traceEvents"]
             if e.get("ph") == "i"}
    assert lanes == {0, 1, 2, 3}
    with pytest.raises(FileNotFoundError):
        postmortem(str(tmp_path / "empty"))
