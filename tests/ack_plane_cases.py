"""Seeded cases for the device ack plane's step and sweep: a dense slot
state and one padded ack batch holding every row class.

The state mixes committed, slow, virgin and canonical slots; canonical
slots carry vote masks near the quorums and extra non-null voters (the
spam guard's "foreign" votes).  The batch's live rows crowd a few slots
so that each sees many rows: duplicates of one (slot, source), several
candidate digests for one virgin slot (the lowest row adopts), digests
that conflict with the canonical one, rows on committed and slow slots,
rows whose client lies past the plane, and padding rows (``valid`` 0,
with junk in the other columns).

``make_case`` returns numpy arrays only, so the JAX package's program,
the port's plain version (tests/test_torch_ack_plane.py), the host
rehearsal of the CUDA source (tests/rehearse_cuda.py) and the card
(chip_smoke.py) all take the same inputs.
"""

from __future__ import annotations

import numpy as np

COMMITTED = 1
SLOW = 2


def quorums(limbs: int) -> tuple:
    """(nodes, weak_q, strong_q) for a network that fills ``limbs`` limbs:
    n = 32 * limbs nodes, f = (n - 1) // 3, weak f + 1, strong 2f + 1."""
    n = 32 * limbs
    f = (n - 1) // 3
    return n, f + 1, 2 * f + 1


def _bits(rng, count: int, nodes: int, limbs: int) -> np.ndarray:
    """A (limbs,) uint32 mask with ``count`` random voters below ``nodes``."""
    out = np.zeros(limbs, dtype=np.uint32)
    for v in rng.choice(nodes, size=min(count, nodes), replace=False):
        out[v >> 5] |= np.uint32(1) << np.uint32(v & 31)
    return out


def make_case(seed: int, rows: int, limbs: int, *, c_pad: int | None = None,
              w_pad: int = 4) -> dict:
    """One state and one batch of ``rows`` rows (a power of two).  The live
    rows are about 7/8 of the batch; the rest is padding."""
    rng = np.random.default_rng(seed)
    nodes, weak_q, strong_q = quorums(limbs)
    if c_pad is None:
        c_pad = max(4, rows // (4 * w_pad))
    total = c_pad * w_pad

    flags = rng.choice(
        np.array([0, 0, 0, 0, 0, COMMITTED, SLOW], dtype=np.uint8), total
    )
    canon_ok = (flags == 0) & (rng.random(total) < 0.6)
    cand = rng.integers(0, 1 << 32, size=(total, 3, 8), dtype=np.uint32)
    canon = np.where(canon_ok[:, None], cand[:, 0], 0).astype(np.uint32)
    agree = np.zeros((total, limbs), dtype=np.uint32)
    nonnull = np.zeros((total, limbs), dtype=np.uint32)
    for s in np.flatnonzero(canon_ok):
        count = int(rng.integers(max(0, weak_q - 4), strong_q + 2))
        agree[s] = _bits(rng, count, nodes, limbs)
        nonnull[s] = agree[s] | _bits(rng, 3, nodes, limbs)
    held = rng.random(total) < 0.3
    tick = rng.integers(0, 3, size=total).astype(np.uint8)

    live = rows - rows // 8
    # Crowd the rows into a quarter of the slots so slots see many rows.
    hot = rng.choice(total, size=max(1, total // 4), replace=False)
    slot = rng.choice(hot, size=live)
    src = rng.integers(0, nodes, size=live).astype(np.int32)
    # Mostly the canonical candidate; the others conflict with it (or, on
    # a virgin slot, compete to be adopted).
    which = rng.choice(np.array([0, 0, 0, 0, 1, 2]), size=live)
    dig = cand[slot, which]
    # Exact duplicates of earlier rows.
    dup_rows = rng.choice(live, size=live // 16, replace=False)
    for r in dup_rows:
        other = int(rng.integers(0, live))
        slot[r], src[r], dig[r] = slot[other], src[other], dig[other]
    ci = (slot // w_pad).astype(np.int32)
    w = (slot % w_pad).astype(np.int32)
    # A few rows whose client lies past the plane.
    far = rng.choice(live, size=max(1, live // 64), replace=False)
    ci[far] = c_pad + rng.integers(0, 4, size=len(far))
    valid = np.ones(live, dtype=bool)

    pad = rows - live
    ci = np.concatenate([ci, rng.integers(0, c_pad, pad).astype(np.int32)])
    w = np.concatenate([w, rng.integers(0, w_pad, pad).astype(np.int32)])
    src = np.concatenate([src, rng.integers(0, nodes, pad).astype(np.int32)])
    dig = np.concatenate(
        [dig, rng.integers(0, 1 << 32, size=(pad, 8), dtype=np.uint32)]
    )
    valid = np.concatenate([valid, np.zeros(pad, dtype=bool)])
    return {
        "c_pad": c_pad, "w_pad": w_pad, "limbs": limbs,
        "weak_q": weak_q, "strong_q": strong_q,
        "agree": agree.reshape(c_pad, w_pad, limbs),
        "nonnull": nonnull.reshape(c_pad, w_pad, limbs),
        "canon": canon.reshape(c_pad, w_pad, 8),
        "canon_ok": canon_ok.reshape(c_pad, w_pad),
        "flags": flags.reshape(c_pad, w_pad),
        "held": held.reshape(c_pad, w_pad),
        "tick": tick.reshape(c_pad, w_pad),
        "ci": ci, "w": w, "src": src, "dig": dig, "valid": valid,
    }


def crossing_rows(rows: int) -> tuple:
    """The rows ``make_crossing_case`` sends to its virgin slot: one in the
    first block of the CUDA step's grid, one in the middle, and one in the
    last block (on a card that holds fewer blocks than the batch needs, a
    thread's second row or later; the host rehearsal runs it so)."""
    return 3, rows // 2 + 1, rows - 2


def make_crossing_case(seed: int, rows: int, limbs: int) -> dict:
    """``make_case`` with one virgin live slot that no other row touches,
    hit by the three ``crossing_rows``: the first and the last carry one
    digest, the middle one another.  The first row adopts its digest and
    applies, the middle row falls back, the last row applies against the
    adopted digest: adoption and the crossings held across the grid's
    blocks."""
    case = make_case(seed, rows, limbs)
    rng = np.random.default_rng(seed + 1)
    w_pad = case["w_pad"]
    touched = set((case["ci"][case["valid"]].astype(np.int64) * w_pad
                   + case["w"][case["valid"]]).tolist())
    virgin = (case["flags"].reshape(-1) == 0) & ~case["canon_ok"].reshape(-1)
    free = [s for s in np.flatnonzero(virgin) if s not in touched]
    slot = int(free[0])
    first_dig, other_dig = rng.integers(0, 1 << 32, size=(2, 8),
                                        dtype=np.uint32)
    nodes = quorums(limbs)[0]
    srcs = rng.choice(nodes, size=3, replace=False)
    for r, src, dig in zip(crossing_rows(rows), srcs,
                           (first_dig, other_dig, first_dig)):
        case["ci"][r], case["w"][r] = slot // w_pad, slot % w_pad
        case["src"][r], case["dig"][r], case["valid"][r] = src, dig, True
    case["crossing"] = {"slot": slot, "digest": first_dig,
                        "srcs": [int(x) for x in srcs]}
    return case


#: The sweep's seeded planes, (slots, limbs): slot counts that are not a
#: multiple of the CUDA sweep's group of 8 slots, limbs 1, 2 and 4 (the
#: kernel's vector loads of the masks) and 3 (its scalar limbs).
SWEEP_CASES = ((8193, 1), (8193, 2), (8193, 4), (8195, 3), (262145, 1))

#: Slots of the all-certified plane that gives each block of the CUDA
#: sweep's grid at least 4096 slots: on the card (1024 blocks of 256
#: threads, at most) and in the host rehearsal (tests/rehearse_cuda.py: 8
#: blocks of 64 threads).
CERTIFIED_SLOTS = {"card": 4096 * 1024, "rehearsal": 4096 * 8}


def _low_bits(count: np.ndarray, limbs: int) -> np.ndarray:
    """(slots, limbs) uint32 masks with the lowest ``count`` voters set."""
    out = np.zeros((len(count), limbs), dtype=np.uint32)
    for limb in range(limbs):
        n = np.clip(count - 32 * limb, 0, 32).astype(np.uint64)
        out[:, limb] = ((np.uint64(1) << n) - np.uint64(1)).astype(np.uint32)
    return out


def make_sweep_case(seed: int, slots: int, limbs: int, *,
                    certified: bool = False) -> dict:
    """A plane of ``slots`` slots (c_pad = slots, w_pad = 1) for the sweep
    alone.  It holds every class: committed (with and without the slow
    flag), slow, live and held, live and not held, and canon_ok false with
    no flag; canon_ok is set at random on flagged slots too, which the
    sweep must ignore.  The live slots' vote counts spread from none to
    every voter, with some exactly at each quorum and one below it.
    ``certified``: every slot live, canonical and holding every voter, so
    every slot counts weak and strong."""
    rng = np.random.default_rng(seed)
    nodes, weak_q, strong_q = quorums(limbs)
    if certified:
        flags = np.zeros(slots, dtype=np.uint8)
        canon_ok = np.ones(slots, dtype=bool)
        agree = _low_bits(np.full(slots, nodes), limbs)
    else:
        flags = rng.choice(np.array(
            [0, 0, 0, 0, 0, COMMITTED, SLOW, COMMITTED | SLOW],
            dtype=np.uint8), slots)
        canon_ok = rng.random(slots) < 0.7
        words = [rng.integers(0, 1 << 32, size=(slots, limbs),
                              dtype=np.uint32) for _ in range(2)]
        # Densities 0, 1/4, 1/2, 3/4 and 1 of the voters, then exact
        # counts at the quorums.
        kind = rng.integers(0, 6, size=slots)[:, None]
        agree = np.select(
            [kind == 0, kind == 1, kind == 2, kind == 3, kind == 4],
            [np.zeros_like(words[0]), words[0] & words[1], words[0],
             words[0] | words[1], _low_bits(np.full(slots, nodes), limbs)],
            _low_bits(rng.choice(np.array(
                [weak_q - 1, weak_q, strong_q - 1, strong_q]), slots), limbs),
        )
        if nodes % 32:
            agree[:, -1] &= np.uint32((1 << (nodes % 32)) - 1)
    held = rng.random(slots) < 0.4
    tick = rng.integers(0, 3, size=slots).astype(np.uint8)
    return {
        "c_pad": slots, "w_pad": 1, "limbs": limbs,
        "weak_q": weak_q, "strong_q": strong_q,
        "agree": agree.reshape(slots, 1, limbs),
        "canon_ok": canon_ok.reshape(slots, 1),
        "flags": flags.reshape(slots, 1),
        "held": held.reshape(slots, 1),
        "tick": tick.reshape(slots, 1),
    }


SWEEP_STATE = ("agree", "canon_ok", "flags", "held", "tick")

#: The sweep's planes on a card, (slots, limbs, kind): the seeded planes
#: ("mixed"), the all-certified plane that gives each of the grid's 1024
#: blocks 4096 slots, and two planes whose arrays start off 16 bytes
#: ("bytes": the byte arrays one byte in, so every slot takes byte loads;
#: "masks": the masks four bytes in, so the groups read scalar limbs).
SWEEP_ON_CARD = tuple(
    (slots, limbs, "mixed") for slots, limbs in SWEEP_CASES
) + ((CERTIFIED_SLOTS["card"], 1, "certified"), (8193, 1, "bytes"),
     (8193, 2, "masks"))


def sweep_tensors(case: dict, device="cpu") -> list:
    """The sweep's five arrays of a case (``make_sweep_case``, or
    ``make_case``'s state) as the port's tensors, in ``quorum_sweep``'s
    order."""
    import torch

    out = []
    for name in SWEEP_STATE:
        a = case[name]
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out.append(torch.from_numpy(np.ascontiguousarray(a)).to(device))
    return out


def offset_copy(t, elements: int):
    """A contiguous copy of tensor ``t`` that starts ``elements`` elements
    into a fresh allocation (the caching allocator's blocks start on 512
    bytes), so its data pointer is off 16 bytes."""
    import torch

    store = torch.empty(t.numel() + elements, dtype=t.dtype, device=t.device)
    view = store[elements:].view(t.shape)
    view.copy_(t)
    return view


def sweep_on_card(seed: int, slots: int, limbs: int, kind: str,
                  device) -> tuple:
    """One of ``SWEEP_ON_CARD``'s planes: (case, the kernel's tensors, the
    plain version's tensors), equal, the kernel's placed as ``kind`` says."""
    case = make_sweep_case(seed, slots, limbs, certified=kind == "certified")
    kernel = sweep_tensors(case, device)
    plain = sweep_tensors(case, device)
    if kind == "bytes":
        kernel[1:] = [offset_copy(t, 1) for t in kernel[1:]]
    elif kind == "masks":
        kernel[0] = offset_copy(kernel[0], 1)
    return case, kernel, plain


def sweep_classes(case: dict) -> dict:
    """How many slots of each class a sweep case holds (a case must
    exercise every one)."""
    fl = case["flags"].reshape(-1)
    ok = case["canon_ok"].reshape(-1)
    held = case["held"].reshape(-1)
    live = (fl == 0) & ok
    return {
        "committed": int(((fl & COMMITTED) != 0).sum()),
        "slow": int((fl == SLOW).sum()),
        "live_held": int((live & held).sum()),
        "live_unheld": int((live & ~held).sum()),
        "not_canonical": int(((fl == 0) & ~ok).sum()),
    }


STATE = ("agree", "nonnull", "canon", "canon_ok", "flags", "held", "tick")
OUTPUTS = ("applied", "fallback", "dropped", "adopt", "weak", "strong",
           "newcount")


def torch_state(case: dict, device="cpu") -> list:
    """The case's state as the port's tensors (masks and words as int32
    bit patterns)."""
    import torch

    out = []
    for name in STATE:
        a = case[name]
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out.append(torch.from_numpy(np.ascontiguousarray(a)).to(device))
    return out


def torch_batch(case: dict, device="cpu"):
    """The case's batch as one packed (rows, 12) int32 tensor."""
    import torch

    from mirbft_tpu_torch.ops.ack_plane import pack_batch

    return pack_batch(
        torch.from_numpy(case["ci"]), torch.from_numpy(case["w"]),
        torch.from_numpy(case["src"]),
        torch.from_numpy(case["dig"].view(np.int32)),
        torch.from_numpy(case["valid"]),
    ).to(device)


def state_numpy(state) -> dict:
    """The port's state tensors back to numpy, masks and words as uint32."""
    out = {}
    for name, t in zip(STATE, state):
        a = t.cpu().numpy()
        if a.dtype == np.int32:
            a = a.view(np.uint32)
        out[name] = a
    return out


def row_classes(outputs: dict) -> dict:
    """How many rows of each class a step's outputs hold (a case must
    exercise every one)."""
    return {name: int(np.asarray(outputs[name]).astype(bool).sum())
            for name in OUTPUTS}
