"""The device ack plane's two programs: the hand-written CUDA kernels and
their plain versions.

The JAX package runs the plane as two jitted XLA programs
(``core/device_tracker.py``: ``device_ack_step`` and
``device_quorum_sweep``).  Here both are kernels of ``csrc/ack_plane.cu``:

- ``ack_step`` absorbs one padded ack batch against the dense slot state:
  canonical adoption in batch order, the one-non-null-vote spam guard, the
  OR of the vote bits, the weak (f+1) and strong (2f+1) popcount crossings
  and the tick reclassification;
- ``quorum_sweep`` tallies the weak, strong and committed slots of the
  whole plane and rewrites the tick class of live and committed slots.

State (one plane, ``total = c_pad * w_pad`` slots), mutated in place:
``agree`` and ``nonnull`` (c_pad, w_pad, limbs) int32 vote masks, bit
``src`` of limb ``src >> 5``; ``canon`` (c_pad, w_pad, 8) int32 digest
words; ``canon_ok`` and ``held`` (c_pad, w_pad) bool; ``flags`` and
``tick`` (c_pad, w_pad) uint8.  Masks and words are uint32 bit patterns
held in int32: torch's uint32 has no ``<<`` and no ``scatter_reduce``.

A batch is one (rows, 12) int32 tensor, a row ``ci, w, src, valid,
dig[8]`` (``pack_batch``), so it crosses to the card in one copy.  Rows
are padded to a power of two; a row with ``valid`` 0 touches nothing.
``src`` must be below ``32 * limbs``.  ``ack_step`` returns one (rows,)
int32 a row, the seven row outputs packed (``unpack_step``), so they come
back in one copy: bits for applied, fallback, dropped, adopt, weak and
strong crossings, and the slot's count after the batch from bit 8.

The rules the kernel keeps, and the plain version by construction
(``ack_step_plain`` is the JAX program's algorithm, argsorts, segment ids
and scatters, on torch tensors):

- among the live rows that hit a virgin slot the lowest row index adopts
  its digest, and every live row of the slot is compared against it;
- the spam guard and the count before the batch read the masks as they
  were before it; the count after, the crossings and the tick read them
  after the whole batch;
- every row of a slot that crosses a quorum reports the crossing (the
  host dedupes by slot).

A shard's view (the JAX program's ``shard_map`` over the client axis):
with ``base`` the state is the block of a mesh's plane that holds clients
``base .. base + c_pad - 1``, the batch is the whole batch (rows name
clients of the whole plane), and a row of another block touches nothing
and gets the output word 0, so the shards' words summed
(``ops.tally.shard_sum``) are each row's owner's word.  ``base`` 0 with
the whole plane is the one-device step.

``ack_step`` and ``quorum_sweep`` dispatch on the tensors' device: a CUDA
tensor launches the kernel, one launch each (counted in ``.launches`` and by padded rows,
or by slots for the sweep, in ``.launches_by_rows``, under one lock), a
CPU tensor takes the plain version, any other device raises.  A launch
that fails raises; there is no other route.
"""

from __future__ import annotations

import collections
import ctypes
import threading

import torch

COMMITTED = 1
SLOW = 2
TICK_INERT = 0
TICK_STEADY = 1
TICK_PYTHON = 2

#: The packed row output of ``ack_step``.
OUT_APPLIED = 1
OUT_FALLBACK = 2
OUT_DROPPED = 4
OUT_ADOPT = 8
OUT_WEAK = 16
OUT_STRONG = 32
NEWCOUNT_SHIFT = 8

#: Columns of a packed batch row.
BATCH_COLS = 12

#: An empty entry of the kernel's per-slot adoption scratch.
FIRST_NONE = 0x7FFFFFFF

_MASK = 0xFFFFFFFF

_LAUNCH_LOCK = threading.Lock()


def _count_launch(wrapper, rows: int) -> None:
    """Add one to ``wrapper.launches`` and to its count at ``rows``, under
    one lock (a read, an add and a write another thread could interleave)."""
    with _LAUNCH_LOCK:
        wrapper.launches += 1
        wrapper.launches_by_rows[rows] += 1


def pack_batch(ci, w, src, dig, valid) -> torch.Tensor:
    """Columns -> one (rows, 12) int32 batch: ``ci, w, src, valid`` and the
    8 digest words (int32 bit patterns) of each row."""
    cols = [
        torch.as_tensor(c).to(torch.int32).reshape(-1, 1)
        for c in (ci, w, src, valid)
    ]
    words = torch.as_tensor(dig).to(torch.int32).reshape(-1, 8)
    return torch.cat(cols + [words], dim=1).contiguous()


def unpack_step(out: torch.Tensor) -> dict:
    """The packed row outputs -> applied, fallback, dropped, adopt, weak,
    strong (bool) and newcount (int32)."""
    out = out.to(torch.int32)
    names = ("applied", "fallback", "dropped", "adopt", "weak", "strong")
    bits = (OUT_APPLIED, OUT_FALLBACK, OUT_DROPPED, OUT_ADOPT, OUT_WEAK,
            OUT_STRONG)
    res = {name: (out & bit) != 0 for name, bit in zip(names, bits)}
    res["newcount"] = out >> NEWCOUNT_SHIFT
    return res


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 holding the uint32 values."""
    return x.to(torch.int64) & _MASK


def _to_int32(values: torch.Tensor) -> torch.Tensor:
    """int64 tensor of uint32 values -> int32 tensor of the same bits."""
    return torch.where(values >= 1 << 31, values - (1 << 32), values).to(
        torch.int32
    )


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each uint32 value of an int64 tensor (SWAR: torch has no
    popcount)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _MASK) >> 24


def _slot_counts(masks: torch.Tensor) -> torch.Tensor:
    """(..., limbs) int32 masks -> (...) int64 popcount over the limbs."""
    return popcount32(_u32(masks)).sum(dim=-1)


# -- the plain versions ---------------------------------------------------------


def ack_step_plain(agree, nonnull, canon, canon_ok, flags, held, tick, batch,
                   *, weak_q: int, strong_q: int,
                   base: int = 0) -> torch.Tensor:
    """The step in plain PyTorch, on whatever device the tensors are on:
    the JAX program's algorithm (``mirbft_tpu/core/device_tracker.py``
    ``_build_step_kernel``, the shard whose block starts at client row
    ``base``).  Mutates the state in place and returns the packed (rows,)
    int32 row outputs, 0 for a row of another block."""
    c_pad, w_pad, limbs = agree.shape
    total = c_pad * w_pad
    agree_f = agree.view(total, limbs)
    nonnull_f = nonnull.view(total, limbs)
    canon_f = canon.view(total, 8)
    cok_f = canon_ok.view(total)
    tick_f = tick.view(total)
    device = batch.device

    n_rows = batch.shape[0]
    ci = batch[:, 0].to(torch.int64) - base
    w = batch[:, 1].to(torch.int64)
    src = batch[:, 2].to(torch.int64)
    valid = batch[:, 3] != 0
    dig = batch[:, 4:]

    mine = valid & (ci >= 0) & (ci < c_pad)
    zero = torch.zeros_like(ci)
    flat = torch.where(mine, ci * w_pad + torch.where(mine, w, zero), zero)
    fl = flags.view(total)[flat].to(torch.int64)
    committed = mine & ((fl & COMMITTED) != 0)
    slow = mine & ((fl & SLOW) != 0)
    live = mine & ~committed & ~slow
    idx = torch.arange(n_rows, dtype=torch.int64, device=device)

    # Canonical adoption: the first live row (batch order) on a virgin
    # slot adopts its digest, as a scatter-min race.
    virgin = live & ~cok_f[flat]
    first = torch.full((total,), n_rows, dtype=torch.int64, device=device)
    first = first.scatter_reduce(
        0, flat, torch.where(virgin, idx, torch.full_like(idx, n_rows)),
        "amin",
    )
    adopt = virgin & (first[flat] == idx)
    tgt = flat[adopt]
    canon_f[tgt] = dig[adopt]
    cok_f[tgt] = True

    match = live & (canon_f[flat] == dig).all(dim=1)

    # Spam guard against the masks before the batch.
    limb = torch.clamp(src >> 5, max=limbs - 1)
    bit = torch.ones_like(src) << (src & 31)
    old_a_limb = _u32(agree_f[flat, limb])
    old_n_limb = _u32(nonnull_f[flat, limb])
    dup = (old_a_limb & bit) != 0
    foreign = ((old_n_limb & bit) != 0) & ~dup
    apply_r = match & ~foreign
    fallback = mine & ~committed & ~apply_r

    # Segment-OR: sort rows by (slot-limb key, source), drop repeated
    # (key, bit) pairs, sum the distinct bits of each segment (== OR).
    keys_total = total * limbs
    key = torch.where(apply_r, flat * limbs + limb,
                      torch.full_like(flat, keys_total))
    o1 = torch.argsort(src, stable=True)
    o2 = torch.argsort(key[o1], stable=True)
    order = o1[o2]
    k_s = key[order]
    b_s = bit[order]
    a_s = apply_r[order]
    prev_k = torch.cat([k_s.new_full((1,), -1), k_s[:-1]])
    prev_b = torch.cat([b_s.new_zeros((1,)), b_s[:-1]])
    dup_in_batch = (k_s == prev_k) & (b_s == prev_b)
    contrib = torch.where(a_s & ~dup_in_batch, b_s, torch.zeros_like(b_s))
    seg_start = k_s != prev_k
    seg_id = torch.cumsum(seg_start.to(torch.int64), dim=0) - 1
    delta = torch.zeros(n_rows, dtype=torch.int64, device=device)
    delta.index_add_(0, seg_id, contrib)

    oldcount = torch.where(apply_r, _slot_counts(agree_f[flat]), zero)

    row_delta = delta[seg_id]
    heads = seg_start & a_s
    keys = k_s[heads]
    add = row_delta[heads]
    agree_lin = agree_f.view(keys_total)
    nonnull_lin = nonnull_f.view(keys_total)
    agree_lin[keys] = _to_int32(_u32(agree_lin[keys]) | add)
    nonnull_lin[keys] = _to_int32(_u32(nonnull_lin[keys]) | add)

    # Popcount crossings against the masks after the whole batch.
    newcount = torch.where(apply_r, _slot_counts(agree_f[flat]), zero)
    weak_x = apply_r & (oldcount < weak_q) & (newcount >= weak_q)
    strong_x = apply_r & (oldcount < strong_q) & (newcount >= strong_q)

    h = held.view(total)[flat]
    new_tick = torch.where(
        h, TICK_STEADY,
        torch.where(newcount >= weak_q, TICK_PYTHON, TICK_INERT),
    ).to(torch.uint8)
    tick_f[flat[apply_r]] = new_tick[apply_r]

    out = (
        apply_r.to(torch.int64) * OUT_APPLIED
        + fallback.to(torch.int64) * OUT_FALLBACK
        + committed.to(torch.int64) * OUT_DROPPED
        + adopt.to(torch.int64) * OUT_ADOPT
        + weak_x.to(torch.int64) * OUT_WEAK
        + strong_x.to(torch.int64) * OUT_STRONG
        + (newcount << NEWCOUNT_SHIFT)
    )
    return out.to(torch.int32)


def quorum_sweep_plain(agree, canon_ok, flags, held, tick, *, weak_q: int,
                       strong_q: int) -> torch.Tensor:
    """The sweep in plain PyTorch: rewrites ``tick`` in place (live slots by
    popcount, committed slots inert, the rest kept) and returns a (3,)
    int32 tensor of the weak, strong and committed totals."""
    counts = _slot_counts(agree)
    live = canon_ok & (flags == 0)
    weak = live & (counts >= weak_q)
    strong = live & (counts >= strong_q)
    committed = (flags & COMMITTED) != 0
    new_tick = torch.where(
        live,
        torch.where(
            held, TICK_STEADY, torch.where(weak, TICK_PYTHON, TICK_INERT)
        ),
        torch.where(committed, TICK_INERT, tick.to(torch.int64)),
    ).to(torch.uint8)
    tick.copy_(new_tick)
    return torch.stack(
        [weak.sum(), strong.sum(), committed.sum()]
    ).to(torch.int32)


# -- the kernels ---------------------------------------------------------------


def _kernel_library():
    from .._build import load

    lib = load("ack_plane")
    if lib.mirbft_ack_step.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.mirbft_ack_step.argtypes = [ptr] * 10 + [i32] * 7 + [ptr]
        lib.mirbft_ack_step.restype = i32
        lib.mirbft_ack_empty.argtypes = [i32, ptr]
        lib.mirbft_ack_empty.restype = i32
        lib.mirbft_ack_sweep_empty.argtypes = [i32, ptr]
        lib.mirbft_ack_sweep_empty.restype = i32
        lib.mirbft_ack_step_grid.argtypes = [i32, ctypes.POINTER(i32),
                                             ctypes.POINTER(i32)]
        lib.mirbft_ack_step_grid.restype = i32
        lib.mirbft_ack_sweep_grid.argtypes = [i32] + [ctypes.POINTER(i32)] * 3
        lib.mirbft_ack_sweep_grid.restype = i32
        lib.mirbft_ack_sweep.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]
        lib.mirbft_ack_sweep.restype = i32
        lib.mirbft_ack_error_string.argtypes = [i32]
        lib.mirbft_ack_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, kernel: str) -> None:
    if err:
        msg = lib.mirbft_ack_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} ({err})")


def _check(name, tensor, shape, dtype, device) -> None:
    if tuple(tensor.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(tensor.shape)}")
    if tensor.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {tensor.dtype}")
    if tensor.device != device:
        raise ValueError(f"{name} on {tensor.device}, expected {device}")
    if not tensor.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_state(agree, nonnull, canon, canon_ok, flags, held, tick):
    if agree.dim() != 3:
        raise ValueError(f"agree must be (c_pad, w_pad, limbs), got "
                         f"{tuple(agree.shape)}")
    c_pad, w_pad, limbs = agree.shape
    device = agree.device
    plane = (c_pad, w_pad)
    _check("agree", agree, (c_pad, w_pad, limbs), torch.int32, device)
    _check("nonnull", nonnull, (c_pad, w_pad, limbs), torch.int32, device)
    _check("canon", canon, (c_pad, w_pad, 8), torch.int32, device)
    _check("canon_ok", canon_ok, plane, torch.bool, device)
    _check("flags", flags, plane, torch.uint8, device)
    _check("held", held, plane, torch.bool, device)
    _check("tick", tick, plane, torch.uint8, device)
    return c_pad, w_pad, limbs, device


def new_first(total: int, device) -> torch.Tensor:
    """The kernel's per-slot adoption scratch: every entry empty.  The
    kernel leaves it empty again after each step."""
    return torch.full((total,), FIRST_NONE, dtype=torch.int32, device=device)


def ack_step(agree, nonnull, canon, canon_ok, flags, held, tick, batch, *,
             weak_q: int, strong_q: int, first=None,
             base: int = 0) -> torch.Tensor:
    """Absorb one packed batch (rows, 12) int32 into the state, in place;
    returns the packed (rows,) int32 row outputs.  CUDA tensors take the
    kernel, one cooperative launch on the current stream: the step's
    three phases (classify, apply, finish) with a grid barrier between
    them, each thread holding its rows' slot and class in registers, so
    nothing is allocated a step but the outputs.  Its bytes are a few
    hundred kB: its time is the launch's fixed cost and a few round trips
    to memory; rows past a thread's registers (``step_grid``) carry their
    class in their own word of the output.  ``first`` is the plane's
    (total,) int32 adoption scratch (``new_first``), which the CUDA route
    requires.  ``base``: the first client row of the state's block (a
    shard's view, above).  CPU tensors take ``ack_step_plain``."""
    c_pad, w_pad, limbs, device = _check_state(
        agree, nonnull, canon, canon_ok, flags, held, tick
    )
    if batch.dim() != 2:
        raise ValueError(f"batch must be (rows, {BATCH_COLS}), got "
                         f"{tuple(batch.shape)}")
    rows = batch.shape[0]
    _check("batch", batch, (rows, BATCH_COLS), torch.int32, device)
    if device.type == "cpu":
        return ack_step_plain(
            agree, nonnull, canon, canon_ok, flags, held, tick, batch,
            weak_q=weak_q, strong_q=strong_q, base=base,
        )
    if device.type != "cuda":
        raise ValueError(f"no ack plane path for device {device}")
    if first is None:
        raise ValueError("the CUDA route of ack_step needs the plane's "
                         "adoption scratch `first` (new_first)")
    _check("first", first, (c_pad * w_pad,), torch.int32, device)
    out = torch.empty((rows,), dtype=torch.int32, device=device)
    if rows == 0:
        return out
    lib = _kernel_library()
    with torch.cuda.device(device):
        err = lib.mirbft_ack_step(
            batch.data_ptr(), agree.data_ptr(), nonnull.data_ptr(),
            canon.data_ptr(), canon_ok.data_ptr(), flags.data_ptr(),
            held.data_ptr(), tick.data_ptr(), first.data_ptr(),
            out.data_ptr(), rows, base, c_pad, w_pad, limbs, weak_q,
            strong_q, torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(lib, err, "ack step")
    _count_launch(ack_step, rows)
    return out


ack_step.launches = 0
ack_step.launches_by_rows = collections.Counter()


def _cuda_device(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"a launch floor needs a CUDA device, got {device}")
    return device


def empty_step(rows: int, device="cuda") -> None:
    """Launch an empty kernel exactly as ``ack_step`` would launch the
    step at ``rows`` rows (the same cooperative grid), on the current
    stream: the step's launch floor, for timing beside it.  Not
    counted."""
    device = _cuda_device(device)
    if rows < 1:
        raise ValueError(f"rows must be at least 1, got {rows}")
    lib = _kernel_library()
    with torch.cuda.device(device):
        err = lib.mirbft_ack_empty(
            rows, torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "empty step")


def empty_sweep(total: int, device="cuda") -> None:
    """Launch an empty kernel exactly as ``quorum_sweep`` launches the
    sweep over ``total`` slots (an ordinary launch of its grid and block,
    ``sweep_grid``), on the current stream: the sweep's launch floor.  Not
    counted."""
    device = _cuda_device(device)
    if total < 1:
        raise ValueError(f"total must be at least 1, got {total}")
    lib = _kernel_library()
    with torch.cuda.device(device):
        err = lib.mirbft_ack_sweep_empty(
            total, torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "empty sweep")


def step_grid(rows: int, device="cuda") -> tuple:
    """(threads, register_rows) of the step's grid at ``rows`` rows on
    ``device``: row r goes to thread r % threads, and a thread's rows past
    its first ``register_rows`` carry their class through the output."""
    device = _cuda_device(device)
    lib = _kernel_library()
    threads, register_rows = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        err = lib.mirbft_ack_step_grid(rows, ctypes.byref(threads),
                                       ctypes.byref(register_rows))
    _raise_on(lib, err, "step grid")
    return threads.value, register_rows.value


def sweep_grid(total: int, device="cuda") -> tuple:
    """(blocks, threads a block, slots a thread) of the sweep's grid over
    ``total`` slots: a thread takes groups of consecutive slots, and a
    plane past the grid's largest takes several groups a thread."""
    device = _cuda_device(device)
    lib = _kernel_library()
    blocks, threads, slots = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = lib.mirbft_ack_sweep_grid(total, ctypes.byref(blocks),
                                    ctypes.byref(threads), ctypes.byref(slots))
    _raise_on(lib, err, "sweep grid")
    return blocks.value, threads.value, slots.value


_SWEEP_SCRATCH: dict = {}
_SWEEP_SCRATCH_LOCK = threading.Lock()


def _sweep_scratch(device: torch.device, stream) -> torch.Tensor:
    """The sweep's scratch for ``device`` and ``stream``: one int32 ticket
    counter, then three partials a block for the largest grid
    (``sweep_grid`` of the largest plane).  Made once, when first asked
    for, with the counter zeroed; each sweep leaves the counter at 0
    again (its last block resets it) and overwrites the partials it
    reads, so nothing is zeroed or allocated a call.  One a stream: sweeps
    on one stream run in turn, and sweeps on two never share one."""
    key = (device.index, stream.cuda_stream)
    with _SWEEP_SCRATCH_LOCK:
        scratch = _SWEEP_SCRATCH.get(key)
        if scratch is None:
            blocks, _threads, _slots = sweep_grid(0x7FFFFFFF, device)
            scratch = _SWEEP_SCRATCH[key] = torch.zeros(
                (1 + 3 * blocks,), dtype=torch.int32, device=device)
    return scratch


def quorum_sweep(agree, canon_ok, flags, held, tick, *, weak_q: int,
                 strong_q: int) -> torch.Tensor:
    """Tally the plane and rewrite ``tick`` in place; returns a (3,) int32
    tensor of the weak, strong and committed totals.  CUDA tensors take the
    sweep kernel on the current stream: one launch and nothing else
    queued (the totals come from ``torch.empty``; the ticket counter and
    the blocks' partials are the stream's scratch, ``_sweep_scratch``).
    CPU tensors take ``quorum_sweep_plain``."""
    if agree.dim() != 3:
        raise ValueError(f"agree must be (c_pad, w_pad, limbs), got "
                         f"{tuple(agree.shape)}")
    c_pad, w_pad, limbs = agree.shape
    device = agree.device
    _check("agree", agree, (c_pad, w_pad, limbs), torch.int32, device)
    _check("canon_ok", canon_ok, (c_pad, w_pad), torch.bool, device)
    _check("flags", flags, (c_pad, w_pad), torch.uint8, device)
    _check("held", held, (c_pad, w_pad), torch.bool, device)
    _check("tick", tick, (c_pad, w_pad), torch.uint8, device)
    if device.type == "cpu":
        return quorum_sweep_plain(
            agree, canon_ok, flags, held, tick, weak_q=weak_q,
            strong_q=strong_q,
        )
    if device.type != "cuda":
        raise ValueError(f"no ack plane path for device {device}")
    total = c_pad * w_pad
    totals = torch.empty((3,), dtype=torch.int32, device=device)
    lib = _kernel_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream()
        scratch = _sweep_scratch(device, stream)
        err = lib.mirbft_ack_sweep(
            agree.data_ptr(), canon_ok.data_ptr(), flags.data_ptr(),
            held.data_ptr(), tick.data_ptr(), totals.data_ptr(),
            scratch.data_ptr() + 4, scratch.data_ptr(), total, limbs,
            weak_q, strong_q, stream.cuda_stream,
        )
    _raise_on(lib, err, "quorum sweep")
    _count_launch(quorum_sweep, total)
    return totals


quorum_sweep.launches = 0
quorum_sweep.launches_by_rows = collections.Counter()


# -- bounds --------------------------------------------------------------------


def step_bytes(batch: torch.Tensor, before, after) -> int:
    """Bytes the step must move on this batch: ``before`` and ``after`` are
    the seven state arrays around it (any route's; only agree, canon_ok
    and flags are read).  The packed batch is read and the row outputs
    written for every row, padding too.  Of each distinct slot the valid
    rows touch: its flags byte; if neither committed nor slow (live),
    its canon_ok byte, its agreement limbs (for the count) and one
    non-null limb (the spam guard), and its canonical digest unless it is
    virgin (a virgin slot's rows compare against the adopter's batch
    row); if virgin, the adopted digest and canon_ok written; and where
    the batch set a vote, the changed limbs of both masks written, the
    held byte read and the tick written."""
    agree0, canon_ok0, flags = before[0], before[3], before[4]
    c_pad, w_pad, limbs = agree0.shape
    total = c_pad * w_pad
    ci = batch[:, 0].to(torch.int64)
    mine = (batch[:, 3] != 0) & (ci >= 0) & (ci < c_pad)
    slots = torch.unique(ci[mine] * w_pad + batch[mine, 1].to(torch.int64))
    fl = flags.reshape(total)[slots]
    live = (fl & (COMMITTED | SLOW)) == 0
    virgin = live & ~canon_ok0.reshape(total)[slots]
    changed = (after[0].reshape(total, limbs)[slots]
               != agree0.reshape(total, limbs)[slots])
    n_live = int(live.sum())
    n_virgin = int(virgin.sum())
    return (
        batch.shape[0] * (4 * BATCH_COLS + 4)
        + slots.numel()
        + n_live * (1 + 4 * limbs + 4)
        + (n_live - n_virgin) * 32
        + n_virgin * 33
        + int(changed.sum()) * 2 * 4
        + int(changed.any(dim=1).sum()) * 2
    )


def sweep_bytes(agree: torch.Tensor, canon_ok: torch.Tensor,
                flags: torch.Tensor) -> int:
    """Bytes the sweep must move on this state: every slot's flags byte,
    the canon_ok byte of each slot with no flag set, a live slot's
    agreement limbs and held byte read and its tick written, a committed
    slot's tick written, and the three totals."""
    limbs = agree.shape[-1]
    fl = flags.reshape(-1)
    unflagged = fl == 0
    live = unflagged & canon_ok.reshape(-1)
    committed = (fl & COMMITTED) != 0
    return (
        fl.numel()
        + int(unflagged.sum())
        + int(live.sum()) * (4 * limbs + 2)
        + int(committed.sum())
        + 12
    )
