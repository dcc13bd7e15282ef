"""The sharded plane's two reductions: the hand-written CUDA kernels of
``csrc/parallel.cu`` and their plain versions.

- ``tally_columns``: a shard's (n_voters, n_seqs) int8 vote block ->
  (n_seqs,) int32 column sums (the JAX package's
  ``jnp.sum(votes.astype(int32), axis=0)`` in
  ``mirbft_tpu/parallel/sharding.py`` ``sharded_quorum_tally``);
- ``shard_sum``: (k, n) int32 partials already on one device -> (n,)
  int32, or, given a threshold, (n,) bool ``total >= threshold``: the
  port's ``lax.psum``.  It merges the tally's partials, the ack step's
  per-row outputs and the ack sweep's three totals across a mesh's shards
  (``parallel.sharding``, ``core.device_tracker``).

Sums are int32 and wrap as two's complement, as XLA's do.

Both dispatch on the tensor's device: a CUDA tensor launches the kernel
on the current stream (counted in ``.launches``, under one lock), a CPU
tensor takes the plain version, any other device raises.  A launch that
fails raises; there is no other route.  ``votes.sum(0, dtype=torch.int32)``
computes ``tally_columns`` too: it is the library call ``chip_smoke.py``
times beside the kernel, and nothing here calls it.
"""

from __future__ import annotations

import ctypes
import threading

import torch

_MASK = 0xFFFFFFFF

_LAUNCH_LOCK = threading.Lock()


def _count_launch(wrapper) -> None:
    with _LAUNCH_LOCK:
        wrapper.launches += 1


def _wrap_int32(values: torch.Tensor) -> torch.Tensor:
    """int64 sums -> int32 with two's complement wrap-around."""
    values = values & _MASK
    return torch.where(values >= 1 << 31, values - (1 << 32), values).to(
        torch.int32
    )


# -- the plain versions ---------------------------------------------------------


def tally_columns_plain(votes: torch.Tensor) -> torch.Tensor:
    """Column sums of an int8 vote block in plain PyTorch: each vote
    sign-extended, summed down its column, wrapped to int32."""
    return _wrap_int32(votes.to(torch.int64).sum(dim=0))


def shard_sum_plain(parts: torch.Tensor, threshold=None) -> torch.Tensor:
    """The rows of (k, n) int32 partials summed (wrapped to int32), or
    ``total >= threshold`` as bool."""
    total = _wrap_int32(parts.to(torch.int64).sum(dim=0))
    if threshold is None:
        return total
    return total >= int(threshold)


# -- the kernels ---------------------------------------------------------------


def _kernel_library():
    from .._build import load

    lib = load("parallel")
    if lib.mirbft_tally_columns.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.mirbft_tally_columns.argtypes = [ptr, ptr, i32, i32, ptr]
        lib.mirbft_tally_columns.restype = i32
        lib.mirbft_shard_sum.argtypes = [ptr, ptr, i32, i32, i32, i32, ptr]
        lib.mirbft_shard_sum.restype = i32
        lib.mirbft_tally_empty.argtypes = [i32, ptr]
        lib.mirbft_tally_empty.restype = i32
        lib.mirbft_shard_sum_empty.argtypes = [i32, ptr]
        lib.mirbft_shard_sum_empty.restype = i32
        lib.mirbft_parallel_error_string.argtypes = [i32]
        lib.mirbft_parallel_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, kernel: str) -> None:
    if err:
        msg = lib.mirbft_parallel_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} ({err})")


def _check(name, tensor, dims, dtype) -> None:
    if tensor.dim() != dims:
        raise ValueError(f"{name} must have {dims} dimensions, got "
                         f"{tuple(tensor.shape)}")
    if tensor.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {tensor.dtype}")
    if not tensor.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tensor.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no tally path for device {tensor.device}")


def tally_columns(votes: torch.Tensor) -> torch.Tensor:
    """(n_voters, n_seqs) int8 -> (n_seqs,) int32 column sums.  A CUDA
    tensor launches the kernel on the current stream (counted in
    ``tally_columns.launches``); a CPU tensor takes
    ``tally_columns_plain``."""
    _check("votes", votes, 2, torch.int8)
    if votes.device.type == "cpu":
        return tally_columns_plain(votes)
    rows, cols = votes.shape
    out = torch.empty((cols,), dtype=torch.int32, device=votes.device)
    if cols == 0:
        return out
    lib = _kernel_library()
    with torch.cuda.device(votes.device):
        err = lib.mirbft_tally_columns(
            votes.data_ptr(), out.data_ptr(), rows, cols,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(lib, err, "tally_columns")
    _count_launch(tally_columns)
    return out


tally_columns.launches = 0


def shard_sum(parts: torch.Tensor, threshold=None) -> torch.Tensor:
    """(k, n) int32 -> (n,) int32 sums of the rows, or (n,) bool ``total
    >= threshold`` when a threshold is given.  A CUDA tensor launches the
    kernel on the current stream (counted in ``shard_sum.launches``); a
    CPU tensor takes ``shard_sum_plain``."""
    _check("parts", parts, 2, torch.int32)
    if parts.device.type == "cpu":
        return shard_sum_plain(parts, threshold)
    k, n = parts.shape
    has = threshold is not None
    out = torch.empty((n,), dtype=torch.bool if has else torch.int32,
                      device=parts.device)
    if n == 0:
        return out
    lib = _kernel_library()
    with torch.cuda.device(parts.device):
        err = lib.mirbft_shard_sum(
            parts.data_ptr(), out.data_ptr(), k, n,
            int(threshold) if has else 0, int(has),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(lib, err, "shard_sum")
    _count_launch(shard_sum)
    return out


shard_sum.launches = 0


def _cuda_device(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"a launch floor needs a CUDA device, got {device}")
    return device


def empty_tally(cols: int, device="cuda") -> None:
    """Launch an empty kernel as ``tally_columns`` launches its grid over
    ``cols`` columns, on the current stream: its launch floor.  Not
    counted."""
    device = _cuda_device(device)
    lib = _kernel_library()
    with torch.cuda.device(device):
        err = lib.mirbft_tally_empty(
            cols, torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "empty tally")


def empty_shard_sum(n: int, device="cuda") -> None:
    """Launch an empty kernel as ``shard_sum`` launches its grid over ``n``
    columns, on the current stream: its launch floor.  Not counted."""
    device = _cuda_device(device)
    lib = _kernel_library()
    with torch.cuda.device(device):
        err = lib.mirbft_shard_sum_empty(
            n, torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "empty shard_sum")


def tally_bytes(votes: torch.Tensor) -> int:
    """Bytes ``tally_columns`` must move: the block read once, the sums
    written once."""
    rows, cols = votes.shape
    return rows * cols + 4 * cols


def shard_sum_bytes(parts: torch.Tensor, threshold=None) -> int:
    """Bytes ``shard_sum`` must move: the partials read once, the sums (4
    bytes) or the mask (1 byte) written once."""
    k, n = parts.shape
    return 4 * k * n + (1 if threshold is not None else 4) * n
