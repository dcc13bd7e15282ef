"""The port's signed mode (mirbft_tpu_torch.testengine.signing) against the
JAX package's: the same signed engine runs, with a forged request injected
at every node, give the same event counts, app chains, committed sequences
and recorded events on the wire, through the host oracle plane and through
both device planes on the CPU (the Ed25519 kernels' plain versions).

The CUDA kernels themselves are held against the plain versions in
tests/test_torch_chip.py and chip_smoke.py."""

import pytest

from mirbft_tpu import pb as ref_pb
from mirbft_tpu.testengine import BasicRecorder as RefRecorder
from mirbft_tpu.testengine import signing as ref_signing
from mirbft_tpu_torch import pb
from mirbft_tpu_torch.crypto import ed25519_host as host
from mirbft_tpu_torch.ops import ed25519 as port_ed25519
from mirbft_tpu_torch.testengine import BasicRecorder
from mirbft_tpu_torch.testengine import signing
from mirbft_tpu_torch.testengine.crypto_plane import AsyncKernelHashPlane

SHAPE = (4, 2, 5)  # nodes, clients, requests per client
FORGED_REQ_NO = 99


def outcome(recorder):
    """What a run decides: event count, per-node app chains and committed
    (client, req_no, seq) sequences, and every recorded event on the
    wire."""
    ours = type(recorder).__module__.startswith("mirbft_tpu_torch.")
    codec = pb if ours else ref_pb
    return (
        recorder.event_count,
        {n: s.app_chain.hex() for n, s in recorder.node_states.items()},
        {n: list(s.committed_reqs) for n, s in recorder.node_states.items()},
        [
            (when, node, codec.encode(event))
            for when, node, event in recorder.recorded_events
        ],
    )


def forge(recorder, codec) -> None:
    """Schedule a forged request (right shape, garbage signature and key)
    at every node, as tests/test_ed25519.py does."""
    forged = codec.Request(
        client_id=SHAPE[0], req_no=FORGED_REQ_NO, data=b"evil" + b"\x01" * 96
    )
    for node in range(SHAPE[0]):
        recorder._schedule(
            0, node, codec.StateEvent(type=codec.EventPropose(request=forged))
        )


def assert_forgery_dropped(recorder) -> None:
    for state in recorder.node_states.values():
        assert all(rn != FORGED_REQ_NO for (_c, rn, _s) in state.committed_reqs)


@pytest.fixture(scope="module")
def reference():
    ref = RefRecorder(
        *SHAPE,
        signer=ref_signing.make_signer(),
        signature_plane=ref_signing.SignaturePlane(
            verifier=ref_signing.host_verifier
        ),
    )
    forge(ref, ref_pb)
    ref.drain_clients(max_steps=200000)
    assert_forgery_dropped(ref)
    return outcome(ref)


def port_run(plane):
    port = BasicRecorder(
        *SHAPE,
        hash_plane=AsyncKernelHashPlane(device="cpu"),
        signer=signing.make_signer(),
        signature_plane=plane,
    )
    forge(port, pb)
    port.drain_clients(max_steps=200000)
    assert_forgery_dropped(port)
    return port


@pytest.mark.parametrize(
    "make_plane",
    [
        lambda: signing.SignaturePlane(signing.host_verifier),
        lambda: signing.AsyncSignaturePlane(device="cpu"),
        lambda: signing.SpeculativeSignaturePlane(device="cpu"),
        lambda: signing.SignaturePlane(
            lambda items: signing.kernel_verifier(items, device="cpu")
        ),
    ],
    ids=["host", "async", "speculative", "kernel_verifier"],
)
def test_signed_run_matches_reference(reference, make_plane):
    plane = make_plane()
    port = port_run(plane)
    assert outcome(port) == reference
    assert len({s.app_chain for s in port.node_states.values()}) == 1
    assert port.byzantine_rejections >= SHAPE[0]
    requests = SHAPE[1] * SHAPE[2]
    if isinstance(plane, signing.AsyncSignaturePlane):
        # Every honest request reached the kernels; the forgery (one
        # request, proposed at every node) was rejected on the host.
        assert plane.host_verifies == 0
        assert (plane.device_verifies, plane.host_rejects) == (requests, 1)
        assert sum(plane.flush_sizes) == requests
        assert plane.launches >= 1
        assert not plane._chunks and not plane._chunk_of
    elif isinstance(plane, signing.SpeculativeSignaturePlane):
        assert plane.host_verifies == 0
        assert (plane.device_verifies, plane.host_rejects) == (requests, 1)
        assert plane.speculative_evictions >= SHAPE[0]  # the forgery


def signed(client_id: int, req_no: int, payload: bytes = b"payload") -> bytes:
    return signing.make_signer()(client_id, req_no, payload)


def test_async_plane_demand_before_the_wave_launched():
    plane = signing.AsyncSignaturePlane(device="cpu")
    good = signed(7, 0)
    bad = bytes([good[0] ^ 1]) + good[1:]  # payload changed: bad signature
    plane.submit(7, 0, good)
    plane.submit(7, 1, bad)
    assert plane.launches == 0
    # No on_time yet: the demand launches the wave and reads it back.
    assert plane.valid(7, 0, good) is True
    assert plane.demand_flushes == 1 and plane.launches == 1
    assert plane.valid(7, 1, bad) is False
    assert plane.launches == 1 and plane.device_verifies == 2
    assert plane.host_verifies == 0


def test_async_plane_rejects_at_submit_without_a_launch(monkeypatch):
    def no_launch(*_args, **_kwargs):
        raise AssertionError("a rejected row reached a launch")

    monkeypatch.setattr(signing, "launch_rows", no_launch)
    plane = signing.AsyncSignaturePlane(device="cpu")
    assert plane.valid(7, 0, b"tiny") is False  # too short for the trailer
    wrong_key = host.public_key(b"\x09" * 32)
    sig = host.sign(b"\x09" * 32, signing.signing_message(7, 1, b"payload"))
    assert plane.valid(7, 1, b"payload" + sig + wrong_key) is False
    good = signed(7, 2)
    high_s = good[:-96] + good[-96:-64] + b"\xff" * 32 + good[-32:]  # S >= L
    assert plane.valid(7, 2, high_s) is False
    plane.on_time(1)
    assert plane.launches == 0 and plane.device_verifies == 0
    assert plane.host_rejects == 3


def test_async_plane_retires_stale_chunks():
    plane = signing.AsyncSignaturePlane(device="cpu", stale_boundaries=2)
    good = signed(7, 0)
    plane.submit(7, 0, good)
    plane.on_time(1)  # the wave launches
    assert plane.launches == 1 and len(plane._chunks) == 1
    plane.on_time(2)
    assert len(plane._chunks) == 1  # one boundary old: kept
    plane.on_time(3)  # two boundaries old and never demanded: read back
    assert plane.forced_retirements == 1
    assert not plane._chunks and not plane._chunk_of
    assert plane.valid(7, 0, good) is True
    assert plane.launches == 1


def test_async_plane_caps_outstanding_chunks():
    plane = signing.AsyncSignaturePlane(device="cpu", max_outstanding=1)
    plane.submit(7, 0, signed(7, 0))
    plane.on_time(1)
    plane.submit(7, 1, signed(7, 1))
    plane.on_time(2)  # a second live chunk: the first is read back
    assert plane.launches == 2 and plane.forced_retirements == 1
    assert len(plane._chunks) == 1
    assert plane._verdicts[(7, 0, signed(7, 0))] is True


def test_speculative_plane_verifies_in_bursts():
    plane = signing.SpeculativeSignaturePlane(kernel_chunk=3, device="cpu")
    items = [(7, rn, signed(7, rn)) for rn in range(7)]
    for item in items:
        plane.submit(*item)
    assert plane.speculative_depth == 7
    plane.on_time(1)
    assert plane.flush_sizes == [3, 3, 1]
    assert all(plane.valid(*item) for item in items)
    assert plane.device_verifies == 7 and plane.forced_joins == 0


def test_speculative_plane_counts_the_rows_it_launches(monkeypatch):
    """A request admitted at submit but refused by ``marshal_light`` (S >=
    L) in its burst is a host reject: it never reaches a kernel and is not
    counted as a verify on the device."""
    launched = []

    def counting(rows, device, events=None):
        launched.append(len(rows))
        return port_ed25519.launch_rows(rows, device, events)

    monkeypatch.setattr(signing, "launch_rows", counting)
    plane = signing.SpeculativeSignaturePlane(kernel_chunk=4, device="cpu")
    good = [(7, rn, signed(7, rn)) for rn in range(3)]
    data = signed(7, 3)
    high_s = (7, 3, data[:-96] + data[-96:-64] + b"\xff" * 32 + data[-32:])
    for item in [*good, high_s]:
        plane.submit(*item)
    assert plane.host_rejects == 0  # admitted: the parse and the key are fine
    plane.on_time(1)
    assert launched == [3] and plane.flush_sizes == [4]
    assert (plane.device_verifies, plane.host_rejects) == (3, 1)
    assert all(plane.valid(*item) for item in good)
    assert plane.valid(*high_s) is False
    assert plane.speculative_evictions == 1


@pytest.mark.parametrize(
    "verifier", [signing.kernel_verifier, signing.pallas_verifier],
    ids=["kernel", "pallas"],
)
def test_batch_verifiers_match_the_host_oracle(verifier):
    good = signed(7, 0)
    items = [
        (7, 0, good),
        (7, 1, good),  # replayed under another req_no
        (7, 2, b"short"),
        (8, 0, good),  # another client's claimed key
    ]
    expect = signing.host_verifier(items)
    assert verifier(items, device="cpu") == expect == [True, False, False, False]


def test_signed_requests_are_the_reference_bytes():
    """Presigned requests are plain bytes both packages accept."""
    port_data = signed(7, 3, b"7:3")
    assert port_data == ref_signing.make_signer()(7, 3, b"7:3")
    assert ref_signing.host_verifier([(7, 3, port_data)]) == [True]
    assert signing.host_verifier([(7, 3, port_data)]) == [True]


# The JAX package's own rung-3 run (bench.py:671-760) on the CPU: the event
# count and app chain head chip_smoke.py holds the port's rung 3 to.
RUNG3_EVENTS = 43280
RUNG3_CHAIN = "12951e5407835b23b58650b2b28549b9404f5ecd6bafca472ff60a59b1f0e2cc"


@pytest.mark.slow
def test_reference_rung3_anchor():
    """Pins chip_smoke.py's rung-3 anchors: the JAX package's engine at
    64 nodes, 1024 signed clients x 8 requests, BatchSize 200, with its
    host batch authority (``SpeculativeSignaturePlane(use_kernel=False)``).
    About a minute on a CPU:

        python -m pytest tests/test_torch_signing.py -m slow -s
    """
    from mirbft_tpu_torch.testengine import rung3

    presigned = rung3.presign(processes=4)
    state = ref_pb.NetworkState(
        config=ref_pb.NetworkConfig(
            nodes=list(range(rung3.NODES)),
            f=(rung3.NODES - 1) // 3,
            number_of_buckets=rung3.BUCKETS,
            checkpoint_interval=rung3.CHECKPOINT_INTERVAL,
            max_epoch_length=rung3.MAX_EPOCH_LENGTH,
        ),
        clients=[
            ref_pb.NetworkClient(id=c, width=rung3.CLIENT_WIDTH, low_watermark=0)
            for c in rung3.client_ids()
        ],
    )
    for cid in rung3.client_ids():
        ref_signing.register_pk(cid, presigned[(cid, 0)][-32:])
    plane = ref_signing.SpeculativeSignaturePlane(use_kernel=False)
    ref = RefRecorder(
        rung3.NODES, rung3.CLIENTS, rung3.REQS,
        batch_size=rung3.BATCH_SIZE, network_state=state,
        signer=lambda cid, rn, _payload: presigned[(cid, rn)],
        signature_plane=plane, record=False,
    )
    events = ref.drain_clients(max_steps=50_000_000)
    chains = {ref.node_states[n].app_chain.hex() for n in range(rung3.NODES)}
    print(f"rung 3 reference: {events} events, chain {chains}")
    assert len(chains) == 1
    total = rung3.CLIENTS * rung3.REQS
    assert all(ref.committed_at(n) == total for n in range(rung3.NODES))
    assert plane.speculative_evictions == 0
    assert (events, chains.pop()) == (RUNG3_EVENTS, RUNG3_CHAIN)


@pytest.mark.parametrize("module", [signing, ref_signing], ids=["port", "jax"])
def test_mac_seal_plane_admits_what_was_sealed(module):
    plane = module.MacSealPlane()
    msg = object()
    plane.seal(msg)
    plane.seal(msg)
    verdicts = [plane.admit(msg), plane.admit(msg), plane.admit(object())]
    assert verdicts == [True, True, False]
    assert (plane.sealed, plane.rejections) == (1, 1)


def test_mac_sealed_run_matches_reference():
    """Sealed replica channels change nothing on a run without manglers:
    every replica message was sealed by its sender and is admitted."""

    def run(recorder_type, module, codec, **planes):
        recorder = recorder_type(
            *SHAPE, signer=module.make_signer(),
            signature_plane=module.SignaturePlane(module.host_verifier),
            mac_plane=module.MacSealPlane(), **planes,
        )
        forge(recorder, codec)
        recorder.drain_clients(max_steps=200000)
        assert recorder.mac_plane.sealed > 0
        assert recorder.mac_plane.rejections == 0
        return outcome(recorder)

    reference = run(RefRecorder, ref_signing, ref_pb)
    port = run(
        BasicRecorder, signing, pb, hash_plane=AsyncKernelHashPlane(device="cpu")
    )
    assert port == reference


def test_kernel_counts_unchanged_on_the_cpu():
    """CPU tensors take the plain versions, which launch nothing."""
    before = (port_ed25519.decompress.launches, port_ed25519.ladder.launches)
    signing.kernel_verifier([(7, 0, signed(7, 0))], device="cpu")
    after = (port_ed25519.decompress.launches, port_ed25519.ladder.launches)
    assert before == after
