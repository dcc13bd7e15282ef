"""The port's test engine held against the JAX package's on the same seeds:
equal event counts, app hash chains, committed sequences and recorded
events, with the port's host plane and its kernel plane (on the CPU,
through the kernel's plain version) at the default and at small chunk
shapes; and the wire format byte-identical across the two packages."""

import hashlib

import pytest

from mirbft_tpu import pb as ref_pb
from mirbft_tpu.testengine import BasicRecorder as RefRecorder
from mirbft_tpu_torch import pb
from mirbft_tpu_torch.testengine import BasicRecorder
from mirbft_tpu_torch.testengine.crypto_plane import (
    AsyncKernelHashPlane,
    CoalescingHashPlane,
)


def outcome(recorder):
    """What a run decides: event count, per-node app chains and committed
    (client, req_no, seq) sequences, and every recorded event on the
    wire."""
    return (
        recorder.event_count,
        {n: s.app_chain.hex() for n, s in recorder.node_states.items()},
        {n: list(s.committed_reqs) for n, s in recorder.node_states.items()},
        [
            (when, node, wire_bytes(event))
            for when, node, event in recorder.recorded_events
        ],
    )


def wire_bytes(event) -> bytes:
    ours = type(event).__module__.startswith("mirbft_tpu_torch.")
    return (pb if ours else ref_pb).encode(event)


def test_single_node_network_anchor():
    ref = RefRecorder(node_count=1, client_count=1, reqs_per_client=3)
    port = BasicRecorder(
        node_count=1, client_count=1, reqs_per_client=3,
        hash_plane=AsyncKernelHashPlane(device="cpu"),
    )
    assert port.drain_clients(max_steps=20000) == 19
    assert ref.drain_clients(max_steps=20000) == 19
    assert len(port.node_states[0].committed_reqs) == 3
    assert outcome(port) == outcome(ref)


@pytest.mark.parametrize("shape", [(4, 4, 5), (4, 2, 10)], ids=str)
@pytest.mark.parametrize("plane", ["inline", "coalescing", "kernel"])
def test_port_engine_matches_reference(shape, plane):
    ref = RefRecorder(*shape, batch_size=2)
    ref_count = ref.drain_clients(max_steps=100000)

    hash_plane = {
        # The engine's default plane, the kernel plane at its default chunk
        # shapes, on the CPU.
        "inline": AsyncKernelHashPlane(device="cpu"),
        "coalescing": CoalescingHashPlane(),
        "kernel": AsyncKernelHashPlane(device="cpu", chunk_rows=16),
    }[plane]
    port = BasicRecorder(*shape, batch_size=2, hash_plane=hash_plane)
    assert port.drain_clients(max_steps=100000) == ref_count
    assert outcome(port) == outcome(ref)
    assert len({s.app_chain for s in port.node_states.values()}) == 1

    if plane == "coalescing":
        # Flushes coalesce across nodes: fewer flushes than digests.
        assert sum(hash_plane.flush_sizes) > len(hash_plane.flush_sizes)
        assert hash_plane.host_digests == sum(hash_plane.flush_sizes)
    else:
        # Every digest went through the kernel path, in chunks of at most
        # the plane's rows.
        assert hash_plane.launches > 0
        assert hash_plane.host_digests == 0
        assert all(
            size <= hash_plane.max_chunk_rows
            for size in hash_plane.flush_sizes
        )
        assert hash_plane.device_digests == sum(hash_plane.flush_sizes)
        assert sum(hash_plane.bucket_digests.values()) == (
            hash_plane.device_digests
        )
        assert sum(hash_plane.shape_launches.values()) == hash_plane.launches
        assert all(
            rows == hash_plane.rows_for(bucket)
            for rows, bucket in hash_plane.shape_launches
        )


def test_kernel_plane_fixed_chunk_shapes():
    plane = AsyncKernelHashPlane(device="cpu")
    assert plane.rows_for(1) == 8192  # request digests
    assert plane.rows_for(128) == 256  # full BatchSize-200 batch digests
    small = AsyncKernelHashPlane(device="cpu", chunk_rows=16)
    assert small.rows_for(1) == 16


def test_kernel_plane_bucket_shapes():
    """The eight packed shapes the engine's buckets launch at (chip_smoke
    times and compares every one)."""
    plane = AsyncKernelHashPlane(device="cpu")
    assert [(plane.rows_for(b), b) for b in (1, 2, 4, 8, 16, 32, 64, 128)] == [
        (8192, 1), (8192, 2), (8192, 4), (4096, 8), (2048, 16), (1024, 32),
        (512, 64), (256, 128),
    ]


def test_kernel_plane_demand_before_wave_launch():
    """A digest demanded before its wave launched is launched then and
    resolved from the kernel path, not hashed on the host."""
    plane = AsyncKernelHashPlane(device="cpu", chunk_rows=16)
    handles = plane.submit([[b"abc"], [b"x" * 6400]])
    assert plane.launches == 0
    assert plane._resolve(handles[1].index) == hashlib.sha256(
        b"x" * 6400
    ).digest()
    assert plane._resolve(handles[0].index) == hashlib.sha256(b"abc").digest()
    assert plane.demand_flushes == 1
    assert plane.launches == 2  # one per block bucket
    assert plane.host_digests == 0
    # Launch time is counted once, apart from submit's own time.
    assert plane.launch_s > 0
    assert sum(plane.flush_wall_s) >= plane.launch_s


def _reference_network_state():
    return ref_pb.NetworkState(
        config=ref_pb.NetworkConfig(
            nodes=[0, 1, 2, 3], f=1, number_of_buckets=4,
            checkpoint_interval=20, max_epoch_length=200,
        ),
        clients=[
            ref_pb.NetworkClient(id=c, width=100, low_watermark=c % 3)
            for c in (4, 5)
        ],
    )


def test_wire_round_trip_across_packages():
    """Reference messages, encoded, decode in the port and re-encode to
    the same bytes (and back)."""
    ref = RefRecorder(node_count=4, client_count=2, reqs_per_client=3)
    ref.drain_clients(max_steps=100000)
    samples = [(pb.NetworkState, _reference_network_state())] + [
        (pb.StateEvent, event) for _when, _node, event in ref.recorded_events
    ]
    kinds = set()
    for cls, message in samples:
        raw = ref_pb.encode(message)
        decoded = pb.decode(cls, raw)
        assert pb.encode(decoded) == raw
        ref_cls = getattr(ref_pb, cls.__name__)
        assert ref_pb.encode(ref_pb.decode(ref_cls, raw)) == raw
        kinds.add(type(getattr(message, "type", message)).__name__)
    # The sample covers the commit path's event kinds.
    assert {"EventStep", "EventActionResults", "EventTick"} <= kinds
