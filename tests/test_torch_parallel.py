"""The port's sharded plane (``mirbft_tpu_torch/parallel/``, ``entry.py``
and the device ack plane's client axis) held against the JAX package's
on the conftest's 8-device CPU mesh.

The JAX functions run on ``mirbft_tpu.parallel.sharding.make_mesh(8)``
(eight virtual CPU devices); the port's on ``make_mesh(devices=[cpu] * 8)``,
a mesh that names the CPU eight times and runs the real eight-way split
with the kernels' plain versions.  Every case sends one seeded input
through both and wants the outputs equal, exactly: digest words, quorum
masks, verdicts, every per-row output of the ack step, the sweep's
totals and tick classes.  The cases of ``tests/test_multichip.py:26,
:37, :50, :78, :85`` are mirrored (the Ed25519 one is slow there and
here); the card runs the kernels in ``tests/test_torch_chip.py``."""

import hashlib
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ack_plane_cases import OUTPUTS, STATE, make_case, torch_batch
from mirbft_tpu import pb as ref_pb
from mirbft_tpu.core import device_tracker as ref_tracker
from mirbft_tpu.core.client_tracker import ClientTracker as RefTracker
from mirbft_tpu.core.msgbuffers import NodeBuffers as RefBuffers
from mirbft_tpu.core.persisted import Persisted as RefPersisted
from mirbft_tpu.ops.batching import pack_preimages as ref_pack_preimages
from mirbft_tpu.parallel import sharding as ref_sharding
from mirbft_tpu_torch import entry as port_entry
from mirbft_tpu_torch import pb
from mirbft_tpu_torch.core import device_tracker
from mirbft_tpu_torch.core.client_tracker import ClientTracker
from mirbft_tpu_torch.core.msgbuffers import NodeBuffers
from mirbft_tpu_torch.core.persisted import Persisted
from mirbft_tpu_torch.ops import ack_plane, tally
from mirbft_tpu_torch.ops.batching import pack_preimages
from mirbft_tpu_torch.parallel import sharding
from mirbft_tpu_torch.testengine import BasicRecorder
from mirbft_tpu_torch.testengine.crypto_plane import AsyncKernelHashPlane

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")

needs_8 = pytest.mark.skipif(
    len(jax.devices("cpu")) < 8, reason="needs 8 virtual cpu devices"
)


@pytest.fixture(scope="module")
def ref_mesh():
    return ref_sharding.make_mesh(8)


@pytest.fixture(scope="module")
def mesh():
    return sharding.make_mesh(devices=[CPU] * 8)


def _messages(seed: int, count: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=int(n), dtype=np.uint8).tobytes()
            for n in rng.integers(0, 300, size=count)]


# -- tests/test_multichip.py, mirrored ------------------------------------------


@needs_8
def test_sharded_sha256_equals_the_jax_mesh(ref_mesh, mesh):
    """test_multichip.py:26 on both packages: one seeded ragged batch, the
    digest words equal, and equal to hashlib."""
    messages = _messages(26, 40)
    packed = pack_preimages(messages, batch_floor=8)
    ref_packed = ref_pack_preimages(messages, batch_floor=8)
    want = np.asarray(ref_sharding.sharded_sha256(ref_mesh)(
        ref_packed.blocks, ref_packed.n_blocks)).view(np.uint32)
    got = sharding.sharded_sha256(mesh)(packed.blocks, packed.n_blocks)
    assert got.device == CPU and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    raw = got.numpy().view(np.uint32).astype(">u4").tobytes()
    for i, msg in enumerate(messages):
        assert raw[32 * i:32 * i + 32] == hashlib.sha256(msg).digest()


def _tally_cases():
    rng = np.random.default_rng(37)
    exact = np.zeros((8, 4), dtype=np.int8)
    exact[:6, 0] = 1
    exact[:5, 1] = 1
    exact[:, 2] = 1
    return [
        ("multichip-37", exact, 6),
        ("binary-64x300", rng.integers(0, 2, (64, 300)).astype(np.int8), 43),
        ("bool-16x33", rng.random((16, 33)) < 0.6, 11),
        ("signed-24x129", rng.integers(-128, 128, (24, 129)).astype(np.int8),
         -7),
    ]


@needs_8
@pytest.mark.parametrize("label,votes,threshold", _tally_cases(),
                         ids=[c[0] for c in _tally_cases()])
def test_sharded_quorum_tally_equals_the_jax_mesh(ref_mesh, mesh, label,
                                                  votes, threshold):
    """test_multichip.py:37 (its case first), then seeded vote matrices:
    0/1, bool and signed int8 votes; the masks equal."""
    want = np.asarray(ref_sharding.sharded_quorum_tally(ref_mesh)(
        votes, threshold=threshold))
    got = sharding.sharded_quorum_tally(mesh)(votes, threshold)
    assert got.dtype == torch.bool
    assert got.tolist() == want.tolist()
    if label == "multichip-37":
        assert got.tolist() == [True, False, True, False]


def _verify_triples(count: int, tag: bytes) -> list:
    """``count`` signed (pk, msg, sig) rows, the odd ones over a corrupted
    message."""
    from mirbft_tpu_torch.crypto import ed25519_host as host

    triples = []
    for i in range(count):
        seed = bytes([i]) * 32
        msg = tag + b"-%d" % i
        pk, sig = host.public_key(seed), host.sign(seed, msg)
        if i % 2:
            msg = msg + b"!"
        triples.append((pk, msg, sig))
    return triples


@needs_8
@pytest.mark.slow
def test_sharded_ed25519_verify_equals_the_jax_mesh(ref_mesh, mesh):
    """test_multichip.py:50 on both packages: 8 signatures, the odd ones
    over a corrupted message, marshalled and packed once by the JAX
    package (``marshal_signature``, ``pack_rows(rows, batch_floor=8)``);
    the same arrays through the JAX ladder on its mesh and, converted by
    ``from_jax_rows``, through the port's extended ladder (plain version)
    on its mesh.  The verdicts equal, valid accepted and corrupted
    rejected, and equal to the unsharded call on the port's own
    marshalling."""
    from mirbft_tpu.ops import ed25519 as ref_ed25519
    from mirbft_tpu_torch.ops import ed25519

    triples = _verify_triples(8, b"multichip")
    packed = ref_ed25519.pack_rows(
        [ref_ed25519.marshal_signature(*t) for t in triples], batch_floor=8)
    want = np.asarray(ref_sharding.sharded_ed25519_verify(ref_mesh)(*packed))
    got = sharding.sharded_ed25519_verify(mesh)(
        *ed25519.from_jax_rows(*packed))
    single = ed25519.launch_signature_rows(
        [ed25519.marshal_signature(*t) for t in triples], device="cpu")
    assert (got != 0).tolist() == want.tolist() == [
        i % 2 == 0 for i in range(8)]
    assert torch.equal(got, single)


def test_sharded_ed25519_verify_on_four_shards_equals_the_unsharded_call():
    """A mesh naming the CPU four times against one unsharded call of the
    extended ladder's plain version, on 8 rows packed to the mesh size:
    the same verdicts, split and gathered in order."""
    from mirbft_tpu_torch.ops import ed25519

    rows = [ed25519.marshal_signature(*t)
            for t in _verify_triples(6, b"four-shards")]
    packed = ed25519.pack_signature_rows(rows, batch_floor=4)
    assert len(packed[0]) == 8
    four = sharding.make_mesh(devices=[CPU] * 4)
    got = sharding.sharded_ed25519_verify(four)(*packed)
    single = ed25519.launch_signature_rows(rows, device="cpu", batch_floor=4)
    assert got.device == CPU and torch.equal(got, single)
    assert (got != 0).tolist() == [i % 2 == 0 for i in range(6)] + [True] * 2


@needs_8
def test_dryrun_multichip_on_both_packages(capsys):
    """test_multichip.py:78: the JAX dryrun on its 8-device mesh and the
    port's on a mesh naming the CPU eight times, each passing its asserts."""
    sys.path.insert(0, str(REPO))
    import __graft_entry__ as graft

    graft.dryrun_multichip(8)
    got = port_entry.dryrun_multichip(8, devices=[CPU] * 8)
    assert got["devices"] == ["cpu"] * 8
    assert got["digest_shape"] == [32, 8]
    assert got["mask"] == [False] * 8 + [True] * 8
    out = capsys.readouterr().out
    assert "dryrun_multichip ok: 8-device mesh" in out


def test_entry_equals_the_jax_entry():
    """test_multichip.py:85: the JAX entry's forward jitted and the port's
    forward (the SHA-256 kernel's wrapper, its plain version here) on the
    same 32 preimages give the same digest words."""
    sys.path.insert(0, str(REPO))
    import __graft_entry__ as graft

    ref_fn, ref_args = graft.entry()
    want = np.asarray(jax.jit(ref_fn)(*ref_args)).view(np.uint32)
    fn, args = port_entry.entry("cpu")
    assert tuple(args[0].shape) == tuple(ref_args[0].shape) == (32, 4, 16)
    got = fn(*args)
    assert got.shape == (args[0].shape[0], 8)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


# -- the two reductions' plain versions ----------------------------------------


@pytest.mark.parametrize("rows,cols", [(1, 1), (3, 7), (8, 16), (37, 300),
                                       (5, 129), (0, 4), (256, 513)])
def test_tally_columns_plain_equals_numpy(rows, cols):
    votes = np.random.default_rng(rows * 997 + cols).integers(
        -128, 128, size=(rows, cols), dtype=np.int8)
    got = tally.tally_columns(torch.from_numpy(votes))
    assert got.dtype == torch.int32 and tuple(got.shape) == (cols,)
    np.testing.assert_array_equal(
        got.numpy(), votes.astype(np.int32).sum(axis=0, dtype=np.int32))
    assert tally.tally_columns.launches == 0  # the CPU: no kernel


@pytest.mark.parametrize("k,n", [(1, 1), (2, 5), (3, 333), (8, 1024),
                                 (4, 0)])
def test_shard_sum_plain_equals_numpy(k, n):
    """Sums wrap as int32 (partials near the limits); with a threshold the
    bool mask of the wrapped sums."""
    rng = np.random.default_rng(k * 131 + n)
    parts = rng.integers(-(1 << 31), 1 << 31, size=(k, n)).astype(np.int32)
    total = parts.sum(axis=0, dtype=np.int32)
    got = tally.shard_sum(torch.from_numpy(parts))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), total)
    threshold = int(rng.integers(-(1 << 30), 1 << 30))
    mask = tally.shard_sum(torch.from_numpy(parts), threshold)
    assert mask.dtype == torch.bool
    np.testing.assert_array_equal(mask.numpy(), total >= threshold)


def test_reductions_check_their_inputs():
    with pytest.raises(TypeError):
        tally.tally_columns(torch.zeros((2, 3), dtype=torch.int32))
    with pytest.raises(ValueError):
        tally.shard_sum(torch.zeros((3,), dtype=torch.int32))
    with pytest.raises(ValueError):
        tally.tally_columns(torch.zeros((2, 3), dtype=torch.int8,
                                        device="meta"))


# -- the mesh ---------------------------------------------------------------------


def test_make_mesh_raises_without_enough_cards(monkeypatch):
    """No card: ``make_mesh(2)`` and a mesh naming ``cuda`` raise; fewer
    devices than asked: a ValueError, as in the JAX package (which then
    moves to CPU devices on its own; the port does not)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        sharding.make_mesh(2)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        sharding.make_mesh(devices=["cuda"])
    with pytest.raises(ValueError, match="requested 9 devices, have 8"):
        sharding.make_mesh(9, devices=[CPU] * 8)
    mesh = sharding.make_mesh(2, devices=[CPU] * 8)
    assert mesh.size == 2 and mesh.axis_names == ("crypto",)


def test_split_and_gather_keep_the_order(mesh):
    x = torch.arange(32).reshape(16, 2)
    blocks = sharding.split_blocks(mesh, x)
    assert [tuple(b.shape) for b in blocks] == [(2, 2)] * 8
    assert torch.equal(sharding.gather(mesh, blocks), x)
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        sharding.split_blocks(mesh, torch.zeros(12))
    assert all(r is x for r in sharding.replicate(mesh, x))


def test_sharded_functions_refuse_ragged_batches(mesh):
    with pytest.raises(ValueError, match="multiple"):
        sharding.sharded_quorum_tally(mesh)(np.ones((12, 4), np.int8), 1)
    from mirbft_tpu_torch.crypto import ed25519_host as host
    from mirbft_tpu_torch.ops import ed25519

    seed = b"\x05" * 32
    rows = [ed25519.marshal_signature(host.public_key(seed), b"m",
                                      host.sign(seed, b"m"))] * 3
    with pytest.raises(ValueError, match="not a multiple of the mesh"):
        sharding.sharded_ed25519_verify(mesh)(
            *ed25519.pack_signature_rows(rows))


# -- the ack plane's client axis: the step and the sweep -------------------------


def _port_shards(mesh, case):
    block = case["c_pad"] // mesh.size
    out = []
    for i in range(mesh.size):
        state = []
        for name in STATE:
            a = case[name][i * block:(i + 1) * block]
            if a.dtype == np.uint32:
                a = a.view(np.int32)
            state.append(torch.from_numpy(np.ascontiguousarray(a)))
        out.append(state)
    return out, block


@needs_8
@pytest.mark.parametrize("rows,limbs", [(1024, 1), (2048, 3)],
                         ids=["rows1024-limbs1", "rows2048-limbs3"])
def test_eight_shard_step_and_sweep_equal_the_jax_mesh(ref_mesh, mesh, rows,
                                                       limbs):
    """X1 and X2 on 8 client blocks against the JAX package's two programs
    on its 8-device mesh (state P(AXIS), batch replicated, psum-merged),
    on a seeded case holding every row class: every per-row output, every
    state array, the sweep's totals and its tick classes, exactly."""
    case = make_case(rows * 17 + limbs, rows, limbs, c_pad=64)
    kw = dict(c_pad=64, w_pad=case["w_pad"], limbs=limbs,
              weak_q=case["weak_q"], strong_q=case["strong_q"])
    step = ref_tracker._build_step_kernel(ref_mesh, **kw)
    sweep = ref_tracker._build_sweep_kernel(ref_mesh, **kw)
    res = step(*[case[name] for name in STATE], case["ci"], case["w"],
               case["src"], case["dig"], case["valid"])
    want_state = {n: np.asarray(a) for n, a in zip(STATE, res[:7])}
    want_out = {n: np.asarray(a) for n, a in zip(OUTPUTS, res[7:])}

    shards, block = _port_shards(mesh, case)
    q = dict(weak_q=case["weak_q"], strong_q=case["strong_q"])
    packed = device_tracker._plane_step(
        torch_batch(case), mesh, shards, [None] * 8, block=block, **q)
    got = ack_plane.unpack_step(packed)
    for name in OUTPUTS:
        assert int(np.count_nonzero(want_out[name])) > 0, name
        np.testing.assert_array_equal(
            got[name].numpy().astype(np.int64),
            want_out[name].astype(np.int64), err_msg=name)
    for j, name in enumerate(STATE):
        joined = np.concatenate([s[j].numpy() for s in shards])
        if joined.dtype == np.int32:
            joined = joined.view(np.uint32)
        np.testing.assert_array_equal(joined, want_state[name], err_msg=name)

    weak, strong, committed, tick = sweep(
        *[want_state[n] for n in ("agree", "canon_ok", "flags", "held",
                                  "tick")])
    totals = device_tracker._plane_sweep(shards[0][0], mesh, shards, **q)
    assert totals.tolist() == [int(weak), int(strong), int(committed)]
    np.testing.assert_array_equal(
        np.concatenate([s[6].numpy() for s in shards]), np.asarray(tick))


def test_a_one_device_plane_sums_nothing(monkeypatch, mesh):
    """On a mesh of one device a flush runs its step and a sweep its sweep
    and nothing else (no shard_sum); on 8 shards each merges once."""
    calls = []
    real = device_tracker.psum
    monkeypatch.setattr(device_tracker, "psum",
                        lambda m, parts: calls.append(len(parts)) or real(
                            m, parts))
    for plane_mesh, want in ((None, []), (mesh, [8, 8])):
        ct = _tracker(((7, 100),),
                      ack_device="cpu" if plane_mesh is None else plane_mesh)
        digest = b"\x11" * 32
        ct.step_ack_many(1, [pb.Msg(type=pb.RequestAck(
            client_id=7, req_no=0, digest=digest))])
        ct._device.quorum_sweep()
        assert calls == want
        calls.clear()


# -- the ack plane's client axis: trackers ---------------------------------------


def _state(package, clients):
    return package.NetworkState(
        config=package.NetworkConfig(
            nodes=list(range(4)), f=1, number_of_buckets=4,
            checkpoint_interval=5, max_epoch_length=50,
        ),
        clients=[package.NetworkClient(id=cid, width=width, low_watermark=0)
                 for cid, width in clients],
    )


def _tracker(clients, ack_device="cpu"):
    persisted = Persisted()
    persisted.add_c_entry(pb.CEntry(
        seq_no=0, checkpoint_value=b"genesis",
        network_state=_state(pb, clients)))
    my = pb.InitialParameters(id=0, buffer_size=1 << 20)
    ct = ClientTracker(persisted, NodeBuffers(my), my, ack_plane="device",
                       ack_device=ack_device)
    ct.reinitialize()
    return ct


def _ref_tracker(clients):
    persisted = RefPersisted()
    persisted.add_c_entry(ref_pb.CEntry(
        seq_no=0, checkpoint_value=b"genesis",
        network_state=_state(ref_pb, clients)))
    my = ref_pb.InitialParameters(id=0, buffer_size=1 << 20)
    ct = RefTracker(persisted, RefBuffers(my), my, ack_plane="device")
    ct.reinitialize()
    return ct


#: 300 clients (ids 5..304, so the plane pads to 512 client rows, 64 a
#: shard) with windows of 4.
STORM_CLIENTS = tuple((cid, 4) for cid in range(5, 305))

EVENT_FIELDS = ("slots", "rnos", "applied", "adopt", "weak", "strong",
                "nrm_hit", "fallback")


def _storm_frames(seed: int) -> list:
    """Seeded ack frames (source, rows of (client, req_no, digest)): three
    sources over every slot in shuffled order, a fourth voting a forked
    digest on some slots, repeats, and rows past the windows and the
    clients."""
    rng = np.random.default_rng(seed)
    cids = np.array([c for c, _ in STORM_CLIENTS])
    good = {}

    def digest(cid, rno, fork=False):
        key = (int(cid), int(rno), fork)
        if key not in good:
            good[key] = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
        return good[key]

    frames = []
    for source in (1, 2, 3, 0):
        rows = [(int(c), int(r), digest(c, r, fork=source == 0 and
                                         rng.random() < 0.3))
                for c in cids for r in range(4)]
        order = rng.permutation(len(rows))
        rows = [rows[i] for i in order]
        rows += [rows[int(i)] for i in rng.integers(0, len(rows), 40)]
        rows += [(int(rng.choice(cids)), 9, b"\x07" * 32) for _ in range(5)]
        rows += [(900, 0, b"\x09" * 32)]
        for lo in range(0, len(rows), 256):
            frames.append((source, rows[lo:lo + 256]))
    return frames


def _feed(ct, package, frames) -> list:
    """Every frame through the tracker's plane as columns with its
    messages, one flush a frame; returns each flush's row outputs, then
    drains them into the tracker."""
    plane = ct._device or ct._build_device()
    outs = []
    for source, rows in frames:
        msgs = [package.Msg(type=package.RequestAck(
            client_id=c, req_no=r, digest=d)) for c, r, d in rows]
        ids = np.array([c for c, _, _ in rows])
        rnos = np.array([r for _, r, _ in rows])
        dig = np.frombuffer(b"".join(d for _, _, d in rows),
                            dtype=np.uint8).reshape(-1, 32)
        out_rows = plane.submit_columns(source, ids, rnos, dig, msgs=msgs)
        plane.flush(drain=None)
        ev = plane._events[-1]
        outs.append({name: np.asarray(ev[name]) for name in EVENT_FIELDS}
                    | {"out_rows": np.asarray(out_rows)})
        plane.drain_events(ct)
        for r in np.asarray(out_rows).tolist():
            ct.step_ack(source, msgs[r])
    return outs


def _compare(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for name in g:
            np.testing.assert_array_equal(
                g[name].astype(np.int64), w[name].astype(np.int64),
                err_msg=f"flush {i}: {name}")


@needs_8
def test_eight_shard_plane_equals_the_jax_plane_on_a_seeded_storm(mesh):
    """The port's plane on 8 client blocks (a ClientTracker given the mesh
    as its ack device) and the JAX package's plane (8-shard under the
    conftest) absorb one seeded ack storm flush by flush: every flush's
    per-row outputs (applied, adoption, weak and strong crossings, ready
    marks, fallback), the counters, the sweep's totals, and every state
    array of the plane, tick classes included, equal."""
    port = _tracker(STORM_CLIENTS, ack_device=mesh)
    ref = _ref_tracker(STORM_CLIENTS)
    frames = _storm_frames(0x5A4D)
    got = _feed(port, pb, frames)
    want = _feed(ref, ref_pb, frames)
    plane, ref_plane = port._device, ref._device
    assert plane.mesh.size == 8 and ref_plane.mesh.devices.size == 8
    assert (plane.c_pad, plane.block) == (ref_plane.c_pad, 64)
    _compare(got, want)
    assert sum(int(g["fallback"].sum()) for g in got) > 0
    assert sum(int(g["adopt"].sum()) for g in got) > 0
    assert (plane.acks_applied, plane.acks_dropped, plane.acks_fallback) == (
        ref_plane.acks_applied, ref_plane.acks_dropped,
        ref_plane.acks_fallback)
    certs = plane.quorum_sweep()
    assert certs == ref_plane.quorum_sweep()
    assert certs["strong_certs"] > 0
    snap, ref_snap = plane.host_snapshot(), ref_plane.host_snapshot()
    for name, array in snap.items():
        np.testing.assert_array_equal(
            array, ref_snap[name].reshape(array.shape), err_msg=name)


def test_one_and_eight_shard_planes_agree(mesh):
    """The same storm through the port's plane on one device and on 8
    client blocks: the same flushes' outputs, sweep and state."""
    frames = _storm_frames(0x1F8)
    one, eight = _tracker(STORM_CLIENTS), _tracker(STORM_CLIENTS,
                                                    ack_device=mesh)
    _compare(_feed(eight, pb, frames), _feed(one, pb, frames))
    assert one._device.mesh.size == 1 and eight._device.mesh.size == 8
    assert one._device.quorum_sweep() == eight._device.quorum_sweep()
    snaps = one._device.host_snapshot(), eight._device.host_snapshot()
    for name in snaps[0]:
        np.testing.assert_array_equal(snaps[0][name], snaps[1][name],
                                      err_msg=name)


def test_anchor_16x64x25_on_an_eight_shard_plane(mesh):
    """The determinism anchor with every node's ack plane on 8 client
    blocks (the CPU named 8 times): 2320 events, and the one-device
    plane's app chains and committed sequences."""
    runs = []
    for ack_device in ("cpu", mesh):
        rec = BasicRecorder(
            16, 64, 25, batch_size=200, record=False, ack_plane="device",
            ack_device=ack_device,
            hash_plane=AsyncKernelHashPlane(device="cpu"),
        )
        assert rec.drain_clients(max_steps=20_000_000) == 2320
        runs.append((
            {n: s.app_chain.hex() for n, s in rec.node_states.items()},
            {n: list(s.committed_reqs) for n, s in rec.node_states.items()},
        ))
    assert runs[0] == runs[1]
    assert len(set(runs[1][0].values())) == 1
