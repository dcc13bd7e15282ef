"""Batched SHA-256: the hand-written CUDA kernel and its plain version.

Bit-exact with hashlib.sha256 (FIPS 180-4) over the preimage layouts in
core.preimage: that equality is what makes a run whose digests come off
the card and a host-hashed run record identical event logs.

Layout (the JAX package's): messages are padded on the host and packed
into (batch, max_blocks, 16) big-endian words plus (batch,) int32 block
counts (ops.batching).  Words cross to torch as an int32 view of the
uint32 values; digests come back as (batch, 8) int32 holding the uint32
digest words.

``sha256_digest_words`` dispatches on the tensors' device: a CUDA tensor
goes to the kernel in ``csrc/sha256.cu`` (one kernel for every block
bucket), a CPU tensor to ``sha256_digest_words_plain``.  There is no other
route: a launch that fails raises.

``sha256_chain_checksum`` is the kernel microbenchmark's function (the
JAX package's ``sha256_chain_checksum`` and its Pallas twin): ``iters``
chained compressions of each row's one block, summed into one uint32.  It
dispatches the same way, to the chain kernel in the same source or to
``sha256_chain_checksum_plain``.

Each wrapper counts its kernel launches in ``<wrapper>.launches``, under
one lock: the live node launches from several threads at once.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from .batching import next_pow2, pack_preimages, padded_blocks, to_tensors

_MASK = 0xFFFFFFFF

# fmt: off
_K = (
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
)

_IV = (
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19,
)
# fmt: on

#: 32-bit integer instructions on Hopper, counting each rotate as one SHF
#: and folding three-input logic and sums into one LOP3 or IADD3: a round
#: takes 14, a schedule word 10, the feed-forward 8.  ``chip_smoke.py``
#: divides the counts by the INT32 issue rate for the kernels' bounds.
INT_OPS_PER_ROUND = 14
INT_OPS_PER_SCHEDULE_WORD = 10
INT_OPS_FEED_FORWARD = 8
#: One compression of a fresh block: 64 rounds, 48 schedule words, the
#: feed-forward (the digest kernel's unit of work).
INT_OPS_PER_COMPRESSION = (
    64 * INT_OPS_PER_ROUND + 48 * INT_OPS_PER_SCHEDULE_WORD
    + INT_OPS_FEED_FORWARD
)


def chain_int_ops(batch: int, iters: int) -> int:
    """Integer instructions the chain checksum needs: every iteration of a
    row compresses the same block, so its message schedule is expanded
    once a row and each iteration costs only the rounds and the
    feed-forward."""
    per_iteration = 64 * INT_OPS_PER_ROUND + INT_OPS_FEED_FORWARD
    return batch * (48 * INT_OPS_PER_SCHEDULE_WORD + iters * per_iteration)


_LAUNCH_LOCK = threading.Lock()


def _count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``.  Under a lock: four nodes' consumer
    threads, the pool's lanes and the pipeline's hash workers launch at
    once, and ``+= 1`` on a function attribute is a read, an add and a
    write that another thread can interleave, losing a count."""
    with _LAUNCH_LOCK:
        wrapper.launches += 1


# -- the plain version --------------------------------------------------------
#
# int64 throughout, holding uint32 values: torch's ``>>`` on int32 is
# arithmetic, and uint32 right shift has no CPU kernel.  The message
# schedule of every block is expanded at once (it does not depend on the
# state); a rotation shifts one 64-bit copy ``x << 32 | x`` (bits s..s+31
# of it are rotr(x, s), and no shift reaches the sign) and masks once.
#
# The schedule and the rounds are TorchScript functions, scripted on first
# use.  Run eagerly, each of a block's ~2,000 small torch calls gives up
# and retakes the interpreter lock, and with other Python threads busy (the
# live node's serializers, four nodes' consumers in one process) every
# retake waits for a thread switch: a block that takes 6 ms alone took
# seconds.  A scripted function runs its ops without returning to Python.


def _schedule_source(words: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(..., 16) int64 words -> (..., 64) int64: the message schedule plus
    the round constants, W[t] + K[t] (below 2^33), for every block."""
    w = list(words.unbind(-1))
    for t in range(16, 64):
        w15 = w[t - 15]
        w2 = w[t - 2]
        x = (w15 << 32) | w15
        s0 = (((x >> 7) ^ (x >> 18)) & 0xFFFFFFFF) ^ (w15 >> 3)
        x = (w2 << 32) | w2
        s1 = (((x >> 17) ^ (x >> 19)) & 0xFFFFFFFF) ^ (w2 >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & 0xFFFFFFFF)
    return torch.stack(w, dim=-1) + k


def _rounds_source(state: torch.Tensor, kw: torch.Tensor) -> torch.Tensor:
    """The 64 rounds and the feed-forward add: state (8, batch), one
    block's W[t] + K[t] as (64, batch) -> the new state (8, batch)."""
    a, b, c, d, e, f, g, h = state.unbind(0)
    for t in range(64):
        x = (e << 32) | e
        big_s1 = ((x >> 6) ^ (x >> 11) ^ (x >> 25)) & 0xFFFFFFFF
        t1 = h + big_s1 + (g ^ (e & (f ^ g))) + kw[t]
        x = (a << 32) | a
        big_s0 = ((x >> 2) ^ (x >> 13) ^ (x >> 22)) & 0xFFFFFFFF
        t2 = big_s0 + ((a & b) | (c & (a | b)))
        h = g
        g = f
        f = e
        e = (d + t1) & 0xFFFFFFFF
        d = c
        c = b
        b = a
        a = (t1 + t2) & 0xFFFFFFFF
    return (state + torch.stack([a, b, c, d, e, f, g, h])) & 0xFFFFFFFF


_scripted: dict = {}


def _script(fn):
    """The TorchScript of ``fn``, compiled once (the first caller under the
    lock; compiling takes tens of ms)."""
    with _LAUNCH_LOCK:
        compiled = _scripted.get(fn)
        if compiled is None:
            compiled = _scripted[fn] = torch.jit.script(fn)
    return compiled


def _schedule_plain(words: torch.Tensor) -> torch.Tensor:
    k = torch.tensor(_K, dtype=torch.int64, device=words.device)
    return _script(_schedule_source)(words, k)


def _rounds_plain(state: torch.Tensor, kw: torch.Tensor) -> torch.Tensor:
    return _script(_rounds_source)(state, kw)


def sha256_digest_words_plain(blocks: torch.Tensor, n_blocks: torch.Tensor):
    """The kernel's function in plain PyTorch, on whatever device the
    tensors are on: (batch, max_blocks, 16) int32 words and (batch,) int32
    block counts -> (batch, 8) int32 digest words.  A row's state stops
    changing once its own block count is used; rows with a count of 0
    return the IV."""
    batch, max_blocks, _ = blocks.shape
    counts = n_blocks.to(torch.int64)
    state = torch.tensor(
        _IV, dtype=torch.int64, device=blocks.device
    ).unsqueeze(1).expand(8, batch)
    live_blocks = min(max_blocks, int(counts.max())) if batch else 0
    if live_blocks > 0:
        words = blocks[:, :live_blocks].to(torch.int64) & _MASK
        kw = _schedule_plain(words)  # (batch, live_blocks, 64)
        for j in range(live_blocks):
            new = _rounds_plain(state, kw[:, j].t())
            state = torch.where(counts > j, new, state)
    return _to_int32(state.t())


def _to_int32(values: torch.Tensor) -> torch.Tensor:
    """int64 tensor of uint32 values -> int32 tensor of the same bits."""
    return torch.where(
        values >= 1 << 31, values - (1 << 32), values
    ).to(torch.int32)


def sha256_chain_checksum_plain(block: torch.Tensor, *, iters: int):
    """The chain kernel's function in plain PyTorch: (batch, 16) int32
    words -> a 0-d int32 tensor holding the uint32 sum of every row's 8
    state words after ``iters`` chained compressions of its block from the
    IV."""
    batch = block.shape[0]
    kw = _schedule_plain(block.to(torch.int64) & _MASK).t()  # (64, batch)
    state = torch.tensor(
        _IV, dtype=torch.int64, device=block.device
    ).unsqueeze(1).expand(8, batch)
    for _ in range(iters):
        state = _rounds_plain(state, kw)
    return _to_int32(state.sum() & _MASK)


# -- the kernel ---------------------------------------------------------------


def _kernel_library():
    from .._build import load

    lib = load("sha256")
    fn = lib.mirbft_sha256_digest
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        lib.mirbft_sha256_chain.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.mirbft_sha256_chain.restype = ctypes.c_int
        lib.mirbft_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mirbft_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(blocks: torch.Tensor, n_blocks: torch.Tensor) -> None:
    if blocks.dim() != 3 or blocks.shape[2] != 16:
        raise ValueError(
            f"blocks must be (batch, max_blocks, 16), got {tuple(blocks.shape)}"
        )
    if n_blocks.shape != (blocks.shape[0],):
        raise ValueError(
            f"n_blocks must be ({blocks.shape[0]},), got {tuple(n_blocks.shape)}"
        )
    if blocks.dtype != torch.int32 or n_blocks.dtype != torch.int32:
        raise TypeError(
            f"blocks and n_blocks must be int32, got {blocks.dtype} and "
            f"{n_blocks.dtype}"
        )
    if blocks.device != n_blocks.device:
        raise ValueError(
            f"blocks on {blocks.device} but n_blocks on {n_blocks.device}"
        )


def _launch_kernel(blocks: torch.Tensor, n_blocks: torch.Tensor):
    if not (blocks.is_contiguous() and n_blocks.is_contiguous()):
        raise ValueError("blocks and n_blocks must be contiguous")
    if blocks.data_ptr() % 16:
        raise ValueError("blocks must be 16-byte aligned")
    batch, max_blocks, _ = blocks.shape
    out = torch.empty((batch, 8), dtype=torch.int32, device=blocks.device)
    if batch == 0:
        return out
    lib = _kernel_library()
    with torch.cuda.device(blocks.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mirbft_sha256_digest(
            blocks.data_ptr(), n_blocks.data_ptr(), out.data_ptr(),
            batch, max_blocks, stream,
        )
    _raise_on(lib, err, "sha256 kernel")
    _count_launch(sha256_digest_words)
    return out


def _raise_on(lib, err: int, what: str) -> None:
    if err:
        msg = lib.mirbft_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def sha256_digest_words(blocks: torch.Tensor, n_blocks: torch.Tensor):
    """Digest pre-packed blocks (see ops.batching): (batch, max_blocks, 16)
    int32 words and (batch,) int32 counts -> (batch, 8) int32 digest
    words.  CUDA tensors launch the kernel on the current stream (counted
    in ``sha256_digest_words.launches``); CPU tensors take the plain
    version."""
    _check_inputs(blocks, n_blocks)
    if blocks.device.type == "cuda":
        return _launch_kernel(blocks, n_blocks)
    if blocks.device.type == "cpu":
        return sha256_digest_words_plain(blocks, n_blocks)
    raise ValueError(f"no sha256 path for device {blocks.device}")


sha256_digest_words.launches = 0


def _launch_chain(block: torch.Tensor, iters: int):
    if not block.is_contiguous():
        raise ValueError("block must be contiguous")
    if block.data_ptr() % 16:
        raise ValueError("block must be 16-byte aligned")
    out = torch.empty((), dtype=torch.int32, device=block.device)
    lib = _kernel_library()
    with torch.cuda.device(block.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mirbft_sha256_chain(
            block.data_ptr(), out.data_ptr(), block.shape[0], iters, stream
        )
    _raise_on(lib, err, "sha256 chain kernel")
    _count_launch(sha256_chain_checksum)
    return out


def sha256_chain_checksum(block: torch.Tensor, *, iters: int):
    """``iters`` chained compressions of each row's (batch, 16) int32
    block from the IV, the 8 state words of every row summed mod 2^32 ->
    a 0-d int32 tensor holding the uint32 checksum.  A CUDA tensor takes
    the chain kernel, one launch holding all the work, on the current
    stream (counted in ``sha256_chain_checksum.launches``); a CPU tensor
    takes the plain version.  Any batch: unlike the Pallas kernel, no
    multiple of 1024 is needed."""
    if block.dim() != 2 or block.shape[1] != 16:
        raise ValueError(f"block must be (batch, 16), got {tuple(block.shape)}")
    if block.dtype != torch.int32:
        raise TypeError(f"block must be int32, got {block.dtype}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if block.device.type == "cuda":
        return _launch_chain(block, int(iters))
    if block.device.type == "cpu":
        return sha256_chain_checksum_plain(block, iters=int(iters))
    raise ValueError(f"no sha256 chain path for device {block.device}")


sha256_chain_checksum.launches = 0

#: The JAX package's name for its Pallas route (``ops/sha256_pallas.py``):
#: here the same function, which reaches the same kernel.
sha256_chain_checksum_pallas = sha256_chain_checksum


def words_to_digests(words: torch.Tensor) -> bytes:
    """(batch, 8) int32 digest words -> the concatenated 32-byte digests."""
    return words.cpu().numpy().view(np.uint32).astype(">u4").tobytes()


def sha256_chunked(chunk_lists: list, device="cuda") -> list:
    """Digest a batch of chunked preimages (the Actions.hashes shape: each
    item is a list of byte chunks, digested over their concatenation)."""
    return sha256_many([b"".join(chunks) for chunks in chunk_lists], device)


def sha256_many(messages: list, device="cuda") -> list:
    """Digest a list of byte strings on ``device``, preserving order.

    Messages are grouped by power-of-two padded block count, one launch
    per group, so a single long message doesn't force every short row
    through its block count."""
    if not messages:
        return []

    groups: dict[int, list] = {}  # block bucket -> original indices
    for i, msg in enumerate(messages):
        bucket = next_pow2(padded_blocks(len(msg)))
        groups.setdefault(bucket, []).append(i)

    out: list = [None] * len(messages)
    for bucket in sorted(groups):
        indices = groups[bucket]
        packed = pack_preimages([messages[i] for i in indices])
        raw = words_to_digests(sha256_digest_words(*to_tensors(packed, device)))
        for row, i in enumerate(indices):
            out[i] = raw[32 * row : 32 * row + 32]
    return out
