"""The device ack plane's step and sweep held against the JAX package's two
XLA programs (``mirbft_tpu/core/device_tracker.py``: ``_build_step_kernel``
and ``_build_sweep_kernel``, run on a one-device CPU mesh) on the same
seeded cases (tests/ack_plane_cases.py): every state array and every row
output equal, exactly, at limbs 1, 2 and 3 and batches of 1024 and 4096
rows holding every row class.  The port runs its plain versions here
(CPU tensors); tests/test_torch_chip.py holds the kernels against them on
a card, and tests/test_torch_rehearse.py rehearses the CUDA source on the
host."""

import jax
import numpy as np
import pytest
import torch

from ack_plane_cases import (
    CERTIFIED_SLOTS,
    OUTPUTS,
    STATE,
    SWEEP_CASES,
    SWEEP_STATE,
    crossing_rows,
    make_case,
    make_crossing_case,
    make_sweep_case,
    row_classes,
    state_numpy,
    sweep_classes,
    sweep_tensors,
    torch_batch,
    torch_state,
)
from mirbft_tpu.core import device_tracker as ref_tracker
from mirbft_tpu.parallel.sharding import make_mesh
from mirbft_tpu_torch.ops import ack_plane

CASES = [(1024, 1), (1024, 3), (4096, 1), (4096, 3), (1024, 2)]


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(devices=jax.devices("cpu")[:1])


def _programs(mesh, case):
    kw = dict(
        c_pad=case["c_pad"], w_pad=case["w_pad"], limbs=case["limbs"],
        weak_q=case["weak_q"], strong_q=case["strong_q"],
    )
    return (ref_tracker._build_step_kernel(mesh, **kw),
            ref_tracker._build_sweep_kernel(mesh, **kw))


def _reference_step(step, case):
    res = step(*[case[name] for name in STATE], case["ci"], case["w"],
               case["src"], case["dig"], case["valid"])
    state = {name: np.asarray(a) for name, a in zip(STATE, res[:7])}
    outs = {name: np.asarray(a) for name, a in zip(OUTPUTS, res[7:])}
    return state, outs


@pytest.mark.parametrize("rows,limbs", CASES,
                         ids=[f"rows{r}-limbs{l}" for r, l in CASES])
def test_step_plain_equals_the_jax_program(mesh, rows, limbs):
    case = make_case(rows * 10 + limbs, rows, limbs)
    step, _sweep = _programs(mesh, case)
    want_state, want_out = _reference_step(step, case)
    classes = row_classes(want_out)
    assert all(classes[name] > 0 for name in OUTPUTS), classes

    state = torch_state(case)
    out = ack_plane.ack_step(
        *state, torch_batch(case), weak_q=case["weak_q"],
        strong_q=case["strong_q"],
    )
    got_state = state_numpy(state)
    got_out = {k: v.numpy() for k, v in ack_plane.unpack_step(out).items()}
    for name in STATE:
        np.testing.assert_array_equal(got_state[name], want_state[name],
                                      err_msg=name)
    for name in OUTPUTS:
        np.testing.assert_array_equal(
            got_out[name].astype(np.int64), want_out[name].astype(np.int64),
            err_msg=name,
        )


@pytest.mark.parametrize("rows,limbs", CASES,
                         ids=[f"rows{r}-limbs{l}" for r, l in CASES])
def test_sweep_plain_equals_the_jax_program(mesh, rows, limbs):
    """The sweep over the state a step left: the three totals and the
    rewritten tick class."""
    case = make_case(rows * 10 + limbs, rows, limbs)
    step, sweep = _programs(mesh, case)
    ref_state, _ = _reference_step(step, case)
    weak, strong, committed, tick = sweep(
        ref_state["agree"], ref_state["canon_ok"], ref_state["flags"],
        ref_state["held"], ref_state["tick"],
    )

    state = torch_state(case)
    ack_plane.ack_step(*state, torch_batch(case), weak_q=case["weak_q"],
                       strong_q=case["strong_q"])
    totals = ack_plane.quorum_sweep(
        state[0], state[3], state[4], state[5], state[6],
        weak_q=case["weak_q"], strong_q=case["strong_q"],
    )
    assert totals.tolist() == [int(weak), int(strong), int(committed)]
    assert int(weak) > 0 and int(strong) > 0 and int(committed) > 0
    np.testing.assert_array_equal(state[6].numpy(), np.asarray(tick))


SWEEP_PLANES = [(slots, limbs, False) for slots, limbs in SWEEP_CASES] + [
    (CERTIFIED_SLOTS["rehearsal"], 1, True), (CERTIFIED_SLOTS["card"], 1, True)]


@pytest.mark.parametrize(
    "slots,limbs,certified", SWEEP_PLANES,
    ids=[f"slots{s}-limbs{l}" + ("-certified" if c else "")
         for s, l, c in SWEEP_PLANES],
)
def test_sweep_plain_equals_the_jax_program_on_the_sweep_planes(
        mesh, slots, limbs, certified):
    """The sweep alone on tests/ack_plane_cases.py's sweep planes (slot
    counts past a multiple of 16, limbs 1 to 4, every slot class; the
    all-certified planes that give each block of the CUDA grid 4096
    slots in the rehearsal and on the card), twice in a row: the totals
    and the rewritten tick equal to the JAX program's each time."""
    case = make_sweep_case(slots * 3 + limbs, slots, limbs,
                           certified=certified)
    kw = dict(c_pad=slots, w_pad=1, limbs=limbs, weak_q=case["weak_q"],
              strong_q=case["strong_q"])
    sweep = ref_tracker._build_sweep_kernel(mesh, **kw)
    if not certified:
        assert all(sweep_classes(case).values()), sweep_classes(case)
    arrays = [case[name] for name in SWEEP_STATE]
    tensors = sweep_tensors(case)
    for _ in range(2):
        weak, strong, committed, tick = sweep(*arrays)
        totals = ack_plane.quorum_sweep(
            *tensors, weak_q=case["weak_q"], strong_q=case["strong_q"])
        assert totals.tolist() == [int(weak), int(strong), int(committed)]
        np.testing.assert_array_equal(tensors[4].numpy(), np.asarray(tick))
        arrays[4] = np.asarray(tick)
    if certified:
        assert totals.tolist() == [slots, slots, 0]


@pytest.mark.parametrize("limbs", [1, 3])
def test_adoption_across_the_cluster_equals_the_jax_program(mesh, limbs):
    """The crossing case (tests/ack_plane_cases.py) at 4096 rows: one
    virgin slot hit by a row of the CUDA step's first block, a row in the
    middle with another digest, and a row of the last block with the first
    digest.  Every state array and row output equal to the JAX program's;
    the first row adopts, the middle one falls back, the last applies
    against the adopted digest.  tests/test_torch_chip.py holds the kernel
    to the same pattern at 16384 and 65536 rows."""
    rows = 4096
    case = make_crossing_case(rows * 10 + limbs + 7, rows, limbs)
    step, _sweep = _programs(mesh, case)
    want_state, want_out = _reference_step(step, case)
    state = torch_state(case)
    out = ack_plane.ack_step(
        *state, torch_batch(case), weak_q=case["weak_q"],
        strong_q=case["strong_q"],
    )
    got_state = state_numpy(state)
    got_out = {k: v.numpy() for k, v in ack_plane.unpack_step(out).items()}
    for name in STATE:
        np.testing.assert_array_equal(got_state[name], want_state[name],
                                      err_msg=name)
    for name in OUTPUTS:
        np.testing.assert_array_equal(
            got_out[name].astype(np.int64), want_out[name].astype(np.int64),
            err_msg=name,
        )
    first, middle, last = crossing_rows(rows)
    assert [bool(want_out["adopt"][r]) for r in (first, middle, last)] == [
        True, False, False]
    assert [bool(want_out["applied"][r]) for r in (first, middle, last)] == [
        True, False, True]
    assert bool(want_out["fallback"][middle])
    slot = case["crossing"]["slot"]
    np.testing.assert_array_equal(
        got_state["canon"].reshape(-1, 8)[slot], case["crossing"]["digest"])


def test_adoption_follows_batch_order():
    """Four live rows on one virgin slot: the lowest row adopts its
    digest, the two with other digests fall back, and the last, which
    repeats the adopted digest, applies."""
    case = make_case(1, 1024, 1)
    state = torch_state(case)
    for t in (state[0], state[1], state[4]):
        t.zero_()  # no votes, every slot live ...
    state[3][:] = False  # ... and virgin
    dig = torch.arange(32, dtype=torch.int32).reshape(4, 8)
    batch = torch.zeros((1024, ack_plane.BATCH_COLS), dtype=torch.int32)
    for row, (src, d) in enumerate([(1, 2), (2, 1), (3, 3), (4, 2)]):
        batch[row, :4] = torch.tensor([0, 0, src, 1])
        batch[row, 4:] = dig[d]
    out = ack_plane.unpack_step(ack_plane.ack_step(
        *state, batch, weak_q=case["weak_q"], strong_q=case["strong_q"],
    ))
    assert out["adopt"][:4].tolist() == [True, False, False, False]
    assert out["applied"][:4].tolist() == [True, False, False, True]
    assert out["fallback"][:4].tolist() == [False, True, True, False]
    assert out["newcount"][:4].tolist() == [2, 0, 0, 2]
    assert torch.equal(state[2][0, 0], dig[2])
    assert bool(state[3][0, 0])
    assert int(state[0][0, 0, 0]) == int(state[1][0, 0, 0]) == 1 << 1 | 1 << 4


def test_pack_and_unpack_round_trip():
    case = make_case(3, 1024, 2)
    batch = torch_batch(case)
    assert batch.shape == (1024, ack_plane.BATCH_COLS)
    assert batch.dtype == torch.int32
    np.testing.assert_array_equal(batch[:, 0].numpy(), case["ci"])
    np.testing.assert_array_equal(batch[:, 3].numpy(), case["valid"])
    np.testing.assert_array_equal(
        batch[:, 4:].numpy().view(np.uint32), case["dig"]
    )
    packed = torch.tensor([0, 1 | 8 | 16 | (5 << 8), 2, 4 | 32 | (70 << 8)],
                          dtype=torch.int32)
    out = ack_plane.unpack_step(packed)
    assert out["applied"].tolist() == [False, True, False, False]
    assert out["adopt"].tolist() == [False, True, False, False]
    assert out["fallback"].tolist() == [False, False, True, False]
    assert out["strong"].tolist() == [False, False, False, True]
    assert out["newcount"].tolist() == [0, 5, 0, 70]


def test_popcount_counts_every_bit_of_a_word():
    words = torch.tensor([0, 1, 0xFFFFFFFF, 0x80000001, 0x12345678],
                         dtype=torch.int64)
    assert ack_plane.popcount32(words).tolist() == [0, 1, 32, 2, 13]


def test_cpu_tensors_take_the_plain_version_uncounted():
    case = make_case(4, 1024, 1)
    state = torch_state(case)
    before = (ack_plane.ack_step.launches, ack_plane.quorum_sweep.launches)
    ack_plane.ack_step(*state, torch_batch(case), weak_q=case["weak_q"],
                       strong_q=case["strong_q"])
    ack_plane.quorum_sweep(state[0], state[3], state[4], state[5], state[6],
                           weak_q=case["weak_q"], strong_q=case["strong_q"])
    assert (ack_plane.ack_step.launches,
            ack_plane.quorum_sweep.launches) == before


def test_wrappers_check_their_inputs():
    case = make_case(5, 1024, 1)
    state = torch_state(case)
    batch = torch_batch(case)
    kw = dict(weak_q=case["weak_q"], strong_q=case["strong_q"])
    with pytest.raises(ValueError, match="batch"):
        ack_plane.ack_step(*state, batch[:, :8].contiguous(), **kw)
    with pytest.raises(TypeError, match="flags"):
        bad = list(state)
        bad[4] = bad[4].to(torch.int32)
        ack_plane.ack_step(*bad, batch, **kw)
    with pytest.raises(ValueError, match="tick"):
        ack_plane.quorum_sweep(state[0], state[3], state[4], state[5],
                               state[6][:1], **kw)
    meta = [t.to("meta") for t in state]
    with pytest.raises(ValueError, match="no ack plane path"):
        ack_plane.ack_step(*meta, batch.to("meta"), **kw)


def test_byte_bounds_count_batch_slots_and_adoptions():
    """The bounds count what this batch and state need: a virgin slot's
    digest is not read, a committed slot costs its flags byte, a
    mismatching row writes nothing, and the sweep reads the masks of live
    slots only."""
    c_pad, w_pad, limbs = 4, 2, 2
    state = [
        torch.zeros((c_pad, w_pad, limbs), dtype=torch.int32),
        torch.zeros((c_pad, w_pad, limbs), dtype=torch.int32),
        torch.zeros((c_pad, w_pad, 8), dtype=torch.int32),
        torch.zeros((c_pad, w_pad), dtype=torch.bool),
        torch.zeros((c_pad, w_pad), dtype=torch.uint8),
        torch.zeros((c_pad, w_pad), dtype=torch.bool),
        torch.zeros((c_pad, w_pad), dtype=torch.uint8),
    ]
    dig = list(range(1, 9))
    state[2][0, 1] = torch.tensor(dig)  # slot 1: canonical digest set
    state[3][0, 1] = True
    state[2][1, 1] = torch.tensor(dig)  # slot 3: set, a row mismatches
    state[3][1, 1] = True
    state[4][1, 0] = ack_plane.COMMITTED  # slot 2
    rows = [  # (ci, w, src, digest)
        (0, 0, 0, dig), (0, 0, 33, dig),  # virgin slot 0, both limbs
        (0, 1, 2, dig),  # slot 1, one limb
        (1, 0, 1, dig),  # committed slot 2
        (1, 1, 3, [9] * 8),  # slot 3, mismatch
    ]
    batch = torch.zeros((8, ack_plane.BATCH_COLS), dtype=torch.int32)
    for r, (ci, w, src, words) in enumerate(rows):
        batch[r] = torch.tensor([ci, w, src, 1] + words)
    before = [t.clone() for t in state]
    ack_plane.ack_step(*state, batch, weak_q=2, strong_q=3)
    assert ack_plane.step_bytes(batch, before, state) == (
        8 * 52  # every row in and out
        + 4  # four slots' flags
        + 3 * (1 + 4 * limbs + 4)  # live: canon_ok, agree, one nonnull limb
        + 2 * 32  # the canonical digest of slots 1 and 3
        + 33  # slot 0 adopts
        + 3 * 8  # three changed limbs in both masks
        + 2 * 2  # held read and tick written at slots 0 and 1
    )
    assert ack_plane.step_bytes(batch, state, state) == (
        8 * 52 + 4 + 3 * (1 + 4 * limbs + 4) + 3 * 32
    )
    # 8 slots' flags, 7 unflagged canon_ok, 3 live, 1 committed, totals.
    assert ack_plane.sweep_bytes(state[0], state[3], state[4]) == (
        8 + 7 + 3 * (4 * limbs + 2) + 1 + 12
    )
