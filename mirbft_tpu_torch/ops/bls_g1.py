"""Batched BLS12-381 G1 aggregation: the hand-written CUDA kernel and its
plain version.

BASELINE ladder rung 4 sums the 2f+1 G1 signature points of each quorum
certificate on the card.  The JAX package runs that as one XLA program
(``mirbft_tpu/ops/bls_g1.py::_aggregate``: a ``lax.scan`` of complete
projective additions over the voter axis, vmapped over certificates).
Here it is the kernel of ``csrc/bls_g1.cu``; pairing verification stays
on the host (``crypto/bls_host.py``).

Inputs, for ``batch`` certificates of ``width`` voter slots: ``xs``,
``ys``, ``zs`` (batch, width, 12) int32 and ``mask`` (batch, width) int32.
A coordinate is a field element in Montgomery form with R = 2^384, fully
reduced into [0, p), as 12 little-endian 32-bit limbs held as int32 bit
patterns; a voter with mask 0 adds the identity (0 : 1 : 0).  The output
is (batch, 3, 12) int32: each certificate's (X, Y, Z), the same form.
The host packs affine points (Z = 1) in ``pack_certificates`` and
unpacks in ``canonical`` and ``aggregate_signatures``.

What both routes compute is the JAX program's scan exactly: the identity,
then voter 0, 1, ..., width - 1 added in order, every step one addition of
Renes, Costello and Batina (2016, Algorithm 7, a = 0, b3 = 12).  The same
field operations in the same order give the same (X : Y : Z), whatever the
limbs, so kernel, plain version and the JAX program agree bit for bit on
the reduced coordinates (``tests/test_torch_bls.py`` holds plain against
the JAX program through ``from_jax_limbs``; ``chip_smoke.py`` holds the
kernel against plain on the card).

``aggregate_plain`` is the JAX program in torch: 30 limbs of 13 bits in
int64 tensors, Montgomery REDC with R = 2^390, elements kept in [0, 2p),
the same carries.  It converts the 2^384 form in and out with one
Montgomery product each way.  A point addition's six first products, and
its six last, run as one batched product each, so a step is a few
thousand small torch calls instead of six times as many.

``aggregate_points`` dispatches on the tensors' device: a CUDA tensor
launches the kernel (counted in ``.launches``, and by (batch, width) in
``.launches_by_shape``, under one lock), a CPU tensor takes the plain
version, any other device raises.  A launch that fails raises; there is
no host fold.
"""

from __future__ import annotations

import collections
import ctypes
import threading

import numpy as np
import torch

from ..crypto import bls_host as host
from ..obsv import device as _device
from .batching import next_pow2, resolve_device

P = host.P

#: The kernel's form: 12 limbs of 32 bits, Montgomery R = 2^384.
NLIMB = 12
R_BITS = 384
R = 1 << R_BITS
R_INV = pow(R, -1, P)

#: The plain version's form (the JAX program's): 30 limbs of 13 bits,
#: Montgomery R = 2^390.
JAX_NLIMB = 30
JAX_RADIX = 13
JAX_MASK = (1 << JAX_RADIX) - 1
JAX_R = 1 << (JAX_NLIMB * JAX_RADIX)

_WORD = 0xFFFFFFFF
_LAUNCH_LOCK = threading.Lock()


# -- host packing ----------------------------------------------------------------


def to_limbs(x: int) -> np.ndarray:
    """An integer below 2^384 -> (12,) int32 bit patterns of its 32-bit
    limbs, least significant first."""
    if not 0 <= x < R:
        raise ValueError("value out of range for 12 limbs of 32 bits")
    words = np.array([(x >> (32 * i)) & _WORD for i in range(NLIMB)],
                     dtype=np.uint32)
    return words.view(np.int32)


def from_limbs(limbs) -> int:
    words = np.asarray(limbs, dtype=np.int32).view(np.uint32)
    return sum(int(w) << (32 * i) for i, w in enumerate(words.tolist()))


def to_mont(x: int) -> np.ndarray:
    """A field element in [0, p) -> its Montgomery limbs (R = 2^384)."""
    return to_limbs(x * R % P)


def from_mont(limbs) -> int:
    return from_limbs(limbs) * R_INV % P


def _check_point(point) -> None:
    if (not isinstance(point, tuple) or len(point) != 2
            or not all(isinstance(c, int) and 0 <= c < P for c in point)):
        raise ValueError(
            f"a G1 signature must be None or an affine (x, y) of integers "
            f"in [0, p), got {point!r:.80}"
        )


def pack_certificates(cert_sigs: list, voters: int | None = None) -> tuple:
    """Certificates (each a list of affine G1 points, None for an absent
    voter) -> numpy (xs, ys, zs, mask), both axes padded to powers of two
    with a floor of 4, as the JAX package pads them.  Raises ValueError on
    a malformed point or a certificate wider than ``voters``."""
    longest = max(len(c) for c in cert_sigs)
    if voters is not None and longest > voters:
        raise ValueError(f"a certificate has {longest} votes, more than "
                         f"voters={voters}")
    width = next_pow2(voters or longest, floor=4)
    batch = next_pow2(len(cert_sigs), floor=4)
    xs = np.zeros((batch, width, NLIMB), dtype=np.int32)
    ys = np.zeros((batch, width, NLIMB), dtype=np.int32)
    zs = np.zeros((batch, width, NLIMB), dtype=np.int32)
    mask = np.zeros((batch, width), dtype=np.int32)
    one = to_mont(1)
    for b, cert in enumerate(cert_sigs):
        for v, point in enumerate(cert):
            if point is None:
                continue
            _check_point(point)
            xs[b, v] = to_mont(point[0])
            ys[b, v] = to_mont(point[1])
            zs[b, v] = one
            mask[b, v] = 1
    return xs, ys, zs, mask


def canonical(out) -> list:
    """(batch, 3, 12) output -> [(X, Y, Z)] canonical integers."""
    out = np.asarray(out.cpu() if isinstance(out, torch.Tensor) else out)
    return [tuple(from_mont(out[b, k]) for k in range(3))
            for b in range(out.shape[0])]


def to_affine(xyz):
    """Canonical (X, Y, Z) -> affine (x, y), or None for Z = 0."""
    x, y, z = xyz
    if z == 0:
        return None
    zi = pow(z, P - 2, P)
    return (x * zi % P, y * zi % P)


def from_jax_limbs(xs, ys, zs, mask) -> tuple:
    """The JAX program's inputs -> this module's: (batch, voters, 30) int32
    Montgomery limbs (13 bits, R = 2^390, values in [0, 2p)) and the
    (batch, voters) mask, as numpy, -> CPU tensors (batch, voters, 12)
    int32 (R = 2^384, in [0, p)) and the int32 mask."""
    jax_r_inv = pow(JAX_R, -1, P)

    def convert(arr):
        arr = np.asarray(arr)
        batch, width, _ = arr.shape
        out = np.zeros((batch, width, NLIMB), dtype=np.int32)
        for b in range(batch):
            for v in range(width):
                value = sum(int(limb) << (JAX_RADIX * i)
                            for i, limb in enumerate(arr[b, v].tolist()))
                out[b, v] = to_mont(value * jax_r_inv % P)
        return torch.from_numpy(out)

    return (convert(xs), convert(ys), convert(zs),
            torch.from_numpy(np.asarray(mask, dtype=np.int32).copy()))


# -- the plain version -------------------------------------------------------------


def _jax_limbs(x: int) -> list:
    return [(x >> (JAX_RADIX * i)) & JAX_MASK for i in range(JAX_NLIMB)]


_P_13 = _jax_limbs(P)
_P2_13 = _jax_limbs(2 * P)
_NPRIME_13 = _jax_limbs((-pow(P, -1, JAX_R)) % JAX_R)
_MONT_ONE_13 = _jax_limbs(JAX_R % P)
# Montgomery products that move between the two forms: x 2^384 times
# 2^396 over 2^390 is x 2^390, and x 2^390 times 2^384 over 2^390 is
# x 2^384.
_TO_390_13 = _jax_limbs(pow(2, 2 * 390 - R_BITS, P))
_TO_384_13 = _jax_limbs(pow(2, R_BITS, P))

# Outer-product entry (i, j) of a 30 x 30 limb product -> column i + j.
_CONV_COLUMN = [i + j for i in range(JAX_NLIMB) for j in range(JAX_NLIMB)]
# Bit offset of each 13-bit limb within the 32-bit words.
_LIMB_WORD = [JAX_RADIX * k // 32 for k in range(JAX_NLIMB)]
_LIMB_SHIFT = [JAX_RADIX * k % 32 for k in range(JAX_NLIMB)]


def _const(limbs, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(limbs, dtype=torch.int64, device=like.device)


def _conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n, 30) x (n, 30) -> (n, 59) limb convolution, exact in int64."""
    n = a.shape[0]
    outer = (a[:, :, None] * b[:, None, :]).reshape(n, JAX_NLIMB * JAX_NLIMB)
    cols = torch.tensor(_CONV_COLUMN, dtype=torch.int64, device=a.device)
    out = torch.zeros((n, 2 * JAX_NLIMB - 1), dtype=torch.int64,
                      device=a.device)
    return out.index_add_(1, cols, outer)


def _carry(x: torch.Tensor) -> tuple:
    """One signed carry pass: limbs -> [0, 2^13), and the carry out.
    Arithmetic shifts make it exact for negative values too."""
    limbs = []
    carry = torch.zeros_like(x[:, 0])
    for v in x.unbind(1):
        v = v + carry
        limbs.append(v & JAX_MASK)
        carry = v >> JAX_RADIX
    return torch.stack(limbs, dim=1), carry


def _mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a b R^-1 mod p (R = 2^390); inputs and output in [0, 2p), carried
    13-bit limbs (mirbft_tpu/ops/bls_g1.py:_mont_mul)."""
    n = a.shape[0]
    t, t_top = _carry(_conv(a, b))
    t_lo = t[:, :JAX_NLIMB]
    m = _conv(t_lo, _const(_NPRIME_13, a).expand(n, JAX_NLIMB))
    m, _ = _carry(m[:, :JAX_NLIMB])  # T_lo N' mod R: the low 30 limbs
    mp = _conv(m, _const(_P_13, a).expand(n, JAX_NLIMB))
    total = torch.zeros((n, 2 * JAX_NLIMB + 1), dtype=torch.int64,
                        device=a.device)
    total[:, : 2 * JAX_NLIMB - 1] = t + mp
    total[:, 2 * JAX_NLIMB - 1] = t_top
    total, top = _carry(total)
    out = total[:, JAX_NLIMB : 2 * JAX_NLIMB].clone()
    out[:, JAX_NLIMB - 1] += (
        (total[:, 2 * JAX_NLIMB] + (top << JAX_RADIX)) << JAX_RADIX
    )
    out, _ = _carry(out)
    return out


def _cond_sub(x: torch.Tensor, limbs) -> torch.Tensor:
    """x - m if x >= m else x, for the constant m given by ``limbs``."""
    t, borrow = _carry(x - _const(limbs, x))
    return torch.where((borrow < 0)[:, None], x, t)


def _add(a, b):
    s, _ = _carry(a + b)
    return _cond_sub(s, _P2_13)


def _sub(a, b):
    s, _ = _carry(a - b + _const(_P2_13, a))
    return _cond_sub(s, _P2_13)


def _mul_small(x, n: int):
    """n x for small n by the JAX program's add chain."""
    out = None
    acc = x
    while n:
        if n & 1:
            out = acc if out is None else _add(out, acc)
        n >>= 1
        if n:
            acc = _add(acc, acc)
    return out


def _point_add(p1, p2):
    """RCB16 Alg. 7 (a = 0, b3 = 12) on (n, 30) limb tensors, as
    mirbft_tpu/ops/bls_g1.py:_point_add, with the independent products
    and sums of each stage stacked into one call."""
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    n = x1.shape[0]
    sums = _add(torch.cat([x1, x2, y1, y2, x1, x2]),
                torch.cat([y1, y2, z1, z2, z1, z2])).split(n)
    prods = _mont_mul(torch.cat([x1, y1, z1, sums[0], sums[2], sums[4]]),
                      torch.cat([x2, y2, z2, sums[1], sums[3], sums[5]]))
    t0, t1, t2, m3, m4, m5 = prods.split(n)
    t3, t4, x3 = _sub(
        torch.cat([m3, m4, m5]),
        _add(torch.cat([t0, t1, t0]), torch.cat([t1, t2, t2])),
    ).split(n)
    t0 = _mul_small(t0, 3)
    t2, y3 = _mul_small(torch.cat([t2, x3]), 12).split(n)  # b3 Z1Z2, b3 x3
    z3 = _add(t1, t2)
    t1 = _sub(t1, t2)
    out = _mont_mul(torch.cat([t3, t4, y3, t1, z3, t0]),
                    torch.cat([t1, y3, t0, z3, t4, t3])).split(n)
    return (_sub(out[0], out[1]), _add(out[2], out[3]), _add(out[4], out[5]))


def _words_to_13(words: torch.Tensor) -> torch.Tensor:
    """(n, 12) int32 bit patterns -> (n, 30) int64 13-bit limbs of the same
    value (below 2^390)."""
    w = words.to(torch.int64) & _WORD
    w = torch.cat([w, torch.zeros_like(w[:, :1])], dim=1)
    lo_index = torch.tensor(_LIMB_WORD, device=w.device)
    shift = torch.tensor(_LIMB_SHIFT, device=w.device)
    lo = w[:, lo_index] >> shift
    hi = w[:, lo_index + 1] << (32 - shift)
    return (lo | hi) & JAX_MASK


def _13_to_words(limbs: torch.Tensor) -> torch.Tensor:
    """(n, 30) carried 13-bit limbs of a value below 2^384 -> (n, 12) int32
    bit patterns."""
    words = []
    for i in range(NLIMB):
        word = torch.zeros_like(limbs[:, 0])
        for k in range(JAX_NLIMB):
            offset = JAX_RADIX * k - 32 * i
            if -JAX_RADIX < offset < 32:
                part = (limbs[:, k] << offset if offset >= 0
                        else limbs[:, k] >> -offset)
                word = word | part
        words.append(word & _WORD)
    out = torch.stack(words, dim=1)
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


def aggregate_plain(xs, ys, zs, mask) -> torch.Tensor:
    """The masked sum over voters in plain PyTorch, on whatever device the
    tensors are on: the JAX program's scan and steps, in its own limbs.
    Same inputs and output as the kernel."""
    batch, width = mask.shape
    coords = torch.cat([xs, ys, zs]).reshape(-1, NLIMB)
    limbs = _words_to_13(coords)
    to_390 = _const(_TO_390_13, limbs).expand_as(limbs)
    # x 2^390 in [0, 2p), then into [0, p) as the JAX package's _to_mont
    # gives it.
    limbs = _cond_sub(_mont_mul(limbs, to_390), _P_13)
    x, y, z = limbs.reshape(3, batch, width, JAX_NLIMB).unbind(0)
    zero = torch.zeros((batch, JAX_NLIMB), dtype=torch.int64,
                       device=xs.device)
    one = _const(_MONT_ONE_13, zero).expand(batch, JAX_NLIMB)
    acc = (zero, one, zero)
    for v in range(width):
        keep = (mask[:, v] != 0)[:, None]
        point = (torch.where(keep, x[:, v], zero),
                 torch.where(keep, y[:, v], one),
                 torch.where(keep, z[:, v], zero))
        acc = _point_add(acc, point)
    out = torch.cat(acc)  # (3 batch, 30): X rows, Y rows, Z rows
    out = _mont_mul(out, _const(_TO_384_13, out).expand_as(out))
    out = _13_to_words(_cond_sub(out, _P_13))
    return out.reshape(3, batch, NLIMB).transpose(0, 1).contiguous()


# -- the kernel ------------------------------------------------------------------


def _kernel_library():
    from .._build import load

    lib = load("bls_g1")
    if lib.mirbft_bls_g1_aggregate.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.mirbft_bls_g1_aggregate.argtypes = [ptr] * 5 + [i32] * 2 + [ptr]
        lib.mirbft_bls_g1_aggregate.restype = i32
        lib.mirbft_bls_error_string.argtypes = [i32]
        lib.mirbft_bls_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, tensor, shape, device) -> None:
    if tuple(tensor.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(tensor.shape)}")
    if tensor.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {tensor.dtype}")
    if tensor.device != device:
        raise ValueError(f"{name} on {tensor.device}, expected {device}")
    if not tensor.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def aggregate_points(xs, ys, zs, mask) -> torch.Tensor:
    """Masked sums over the voter axis: (batch, width, 12) x3 and (batch,
    width) int32 -> (batch, 3, 12) int32.  CUDA tensors launch the kernel
    on the current stream; CPU tensors take ``aggregate_plain``."""
    if mask.dim() != 2:
        raise ValueError(f"mask must be (batch, width), got "
                         f"{tuple(mask.shape)}")
    batch, width = mask.shape
    device = mask.device
    _check("mask", mask, (batch, width), device)
    for name, coord in (("xs", xs), ("ys", ys), ("zs", zs)):
        _check(name, coord, (batch, width, NLIMB), device)
    if device.type == "cpu":
        return aggregate_plain(xs, ys, zs, mask)
    if device.type != "cuda":
        raise ValueError(f"no BLS aggregation path for device {device}")
    out = torch.empty((batch, 3, NLIMB), dtype=torch.int32, device=device)
    if batch == 0:
        return out
    lib = _kernel_library()
    with torch.cuda.device(device):
        err = lib.mirbft_bls_g1_aggregate(
            xs.data_ptr(), ys.data_ptr(), zs.data_ptr(), mask.data_ptr(),
            out.data_ptr(), batch, width,
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        msg = lib.mirbft_bls_error_string(err).decode()
        raise RuntimeError(f"BLS G1 aggregate kernel launch failed: {msg} "
                           f"({err})")
    with _LAUNCH_LOCK:
        aggregate_points.launches += 1
        aggregate_points.launches_by_shape[(batch, width)] += 1
    return out


aggregate_points.launches = 0
aggregate_points.launches_by_shape = collections.Counter()


@_device.instrument("bls_aggregate")
def aggregate_signatures(cert_sigs: list, voters: int | None = None,
                         device="cuda") -> list:
    """Aggregate a batch of quorum certificates in one launch.

    cert_sigs: certificates, each a list of affine G1 points (None for an
    absent voter).  Returns one affine aggregate point (or None, the
    identity) a certificate, equal to ``bls_host.aggregate_g1``.  Runs the
    kernel on ``cuda`` (raises without a card) or the plain version on
    ``device="cpu"``."""
    if not cert_sigs:
        return []
    device = resolve_device(device)
    arrays = pack_certificates(cert_sigs, voters)
    xs, ys, zs, mask = (torch.from_numpy(a).to(device) for a in arrays)
    out = canonical(aggregate_points(xs, ys, zs, mask))
    return [to_affine(out[b]) for b in range(len(cert_sigs))]


# -- bounds --------------------------------------------------------------------

#: 32-bit integer instructions of each field operation, at their least in
#: this form: a product 2 x 144 wide multiply-adds (a b_i and m p), 12 for
#: m = t_0 n0', 24 for the conditional subtraction (12 subtracts with
#: borrow, 12 selects); a sum 12 adds with carry and the same 24; a
#: difference 12 subtracts with borrow and 12 adds of p or 0.
INT_OPS = {"mul": 288 + 12 + 24, "add": 12 + 24, "sub": 24}
#: Field operations of one addition (csrc/bls_g1.cu:point_add): 12
#: products; 22 sums (9 operand sums, 2 for 3 t0, 4 each for the two b3
#: products, z3 and the last two); 5 differences.
ADDITION_OPS = {"mul": 12, "add": 22, "sub": 5}
#: The chain floor: one certificate's additions follow one another (each
#: reads the sum so far), and an addition's longest path is 2 products and
#: 7 sums or differences (x1 + z1, the product, minus t0 + t2, b3 by 4
#: doublings, the product with t4, the last difference).  A product's
#: chain, at its least: columns summed as a tree (4), the reduction's 12
#: words one after another (m, m p_0's carry, the next word: 3 each), the
#: last carry (12) and the conditional subtraction (12 and a select).  A
#: sum's or difference's: 12 carries, 12 borrows, a select.
DEPENDENT_LATENCY_CYCLES = 4
MUL_CHAIN = 4 + 3 * 12 + 12 + 13
ADD_CHAIN = 12 + 12 + 1
ADDITION_CHAIN = 2 * MUL_CHAIN + 7 * ADD_CHAIN


def int_ops_per_addition() -> int:
    return sum(INT_OPS[name] * n for name, n in ADDITION_OPS.items())


def needed_additions(mask) -> list:
    """Additions each certificate's result depends on: from its first live
    voter to the end of the row (the identity added to the identity is the
    identity, so the leading masked slots leave it as it is; every later
    slot scales (X : Y : Z)).  0 for a certificate with no live voter."""
    mask = np.asarray(mask.cpu() if isinstance(mask, torch.Tensor) else mask)
    width = mask.shape[1]
    out = []
    for row in mask:
        live = np.flatnonzero(row)
        out.append(width - int(live[0]) if live.size else 0)
    return out


def aggregate_ops(mask) -> int:
    """Integer instructions the launch's data needs."""
    return sum(needed_additions(mask)) * int_ops_per_addition()


def aggregate_bytes(mask) -> int:
    """Bytes the launch's data needs moved: the mask, the three coordinates
    of each live voter, and the (batch, 3, 12) output."""
    mask = np.asarray(mask.cpu() if isinstance(mask, torch.Tensor) else mask)
    live = int(np.count_nonzero(mask))
    return mask.size * 4 + live * 3 * NLIMB * 4 + mask.shape[0] * 3 * NLIMB * 4


def chain_floor_cycles(mask) -> int:
    """Cycles on the longest certificate's chain of additions."""
    return (max(needed_additions(mask)) * ADDITION_CHAIN
            * DEPENDENT_LATENCY_CYCLES)
