"""Batched Ed25519 verification: the hand-written CUDA kernels and their
plain versions.

One module for what the JAX package splits in two: ``ops/ed25519.py``
(the XLA scan ladder over host-decompressed points) and
``ops/ed25519_pallas.py`` (device decompression and the windowed Shamir
ladder).  Three kernels in ``csrc/ed25519.cu`` serve two routes:

- the device route: ``decompress``, RFC 8032 §5.1.3 decompression of A
  and R, one row per point (2n rows: A, then R), giving canonical affine
  (x, y) and an ok flag; then ``ladder``, [S]B + [k](−A) over 4-bit
  windows, most significant first, compared projectively with R and ANDed
  with both ok flags.  The host keeps what the JAX Pallas pipeline kept
  there (``marshal_light``): byte parsing, the range checks y < p and
  S < L, and the SHA-512 challenge k;
- the host route, the JAX ``ops/ed25519.py``'s: ``marshal_signature``
  decompresses A and R on the host and negates A, ``pack_signature_rows``
  packs the rows, and ``ladder_extended`` runs the same windowed ladder
  over −A in extended coordinates and R affine (the Pallas
  ``_ladder_kernel``'s inputs, and ``ladder_impl``'s).

Field elements are 10 signed limbs of radix 2^25.5 (widths 26, 25, 26, ...,
ref10's layout) in int32, with products in int64.  The 20×13-bit int32
limbs of the JAX package exist only because a TPU has no 64-bit multiply;
Hopper has one.  The plain versions here carry every value (every value a
"reduced" element, |limb i| <= 2^w_i):
- a product's column is at most 10 terms of 38·2^26·2^26, under 2^61, so
  int64 holds it exactly; three rounding carry passes bring every limb
  back to |limb| <= 2^(w-1) + 19;
- a sum or difference of two reduced elements is under 2^(w+1) a limb; one
  rounding pass brings it back under 2^(w-1) + 38;
- ``_fe_canonical`` turns a reduced element into the unique limbs of its
  value in [0, p).
The kernels carry less: the ladder's products with ref10's 12-step chain
and its sums not at all, decompression's products and sums with a carry
of its own that fits its split over a group of lanes (``csrc/ed25519.cu``
states the bounds that allow each); the ladder runs four lanes a signature
in the four-processor formulas, decompression a group a point.  So kernel
and plain agree on what they return, exactly: canonical points and ok
flags from ``decompress``, one verdict a row from ``ladder``.  That is the
contract, not the limbs on the way.

``decompress``, ``ladder`` and ``ladder_extended`` dispatch on the
tensors' device: a CUDA tensor launches the kernel (counted in
``.launches``, and by its rows in ``.launches_by_rows``), a CPU tensor
takes the plain version (``decompress_plain``, ``ladder_plain``,
``ladder_extended_plain``: the kernels' formulas on int64 tensors, batched
over rows), any other device raises.  A launch that fails raises; there is
no other route.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import threading

import numpy as np
import torch

from ..crypto import ed25519_host as host
from .batching import resolve_device

NLIMB = 10
WIDTHS = (26, 25) * 5
OFFSETS = tuple(sum(WIDTHS[:i]) for i in range(NLIMB))
P, L = host.P, host.L
SQRT_M1 = pow(2, (P - 1) // 4, P)

#: Row indices of the constants table the kernels read (``constants()``).
CONST_D, CONST_D2, CONST_SQRT_M1, CONST_NIELS = 0, 1, 2, 3
CONST_ROWS = CONST_NIELS + 16 * 3

# Field operations each kernel's function needs per row (the ladder per
# verdict, the decompression per point), counted on the plain versions
# below, which follow the kernels' formulas (tests/test_torch_ed25519.py
# counts them again); chip_smoke.py turns them into the kernels' bounds.
# The ladder's: a doubling 4 sqr + 4 mul, an addition of a cached [j](-A)
# 8 mul, of a Niels [j]B 7 mul (2Z is a sum), a conversion to cached form 1
# mul, each doubling or addition one mul fewer where only a doubling or the
# comparison reads its output (neither reads T); 14 table additions and 15
# conversions, then 64 windows of 4 doublings (3 of them without T) and 2
# additions (the second without T): 27 mul a window.  The kernel's quad
# makes four products a stage, so it issues the T products all the same,
# one more a Niels addition (lane 2 multiplies Z by the table's 2Z = 2
# while the other lanes multiply) and 3 more a conversion; those are left
# out of the bound.
LADDER_OPS = {"mul": 1858, "sqr": 1024, "addsub": 3013, "canonical": 3}
# The extended ladder's: the ladder's without -A's negation (one sub) and
# its T = -x y (one mul), which the host has made.
LADDER_EXTENDED_OPS = {**LADDER_OPS, "mul": LADDER_OPS["mul"] - 1,
                       "addsub": LADDER_OPS["addsub"] - 1}
DECOMPRESS_OPS = {"mul": 19, "sqr": 255, "addsub": 6, "canonical": 5}

#: 32-bit integer instructions a carry step of an int64 limb needs: add the
#: rounding constant and shift (two each on 32-bit halves), add the carry
#: into the next limb (two), clear it from this one (one).
CARRY_STEP = 7
#: The least 32-bit integer instructions per field operation in this
#: representation, as ref10 does it: mul, 100 IMAD.WIDE (32x32->64
#: multiply-adds) and one 12-step carry chain; sqr, 55 and the same chain;
#: add or sub, 10 adds and no carry; canonical (ref10's fe_tobytes), a
#: 10-step quotient x 2, the fold of 19q and a 10-step masking chain x 3.
#: Premultiplications by 2 and 19, loads, shuffles, selects and the table
#: lookups are left out, so a bound from these counts is a floor on the
#: function, not on a kernel.
INT_OPS = {
    "mul": 100 + 12 * CARRY_STEP,
    "sqr": 55 + 12 * CARRY_STEP,
    "addsub": 10,
    "canonical": 10 * 2 + 2 + 10 * 3,
}

#: The chain floor: one row's longest chain of dependent instructions times
#: an assumed latency of DEPENDENT_ISSUE_CYCLES a dependent integer
#: instruction.  A product's chain, at its least: the longest column's
#: terms split over three int64 accumulators (10 terms of a product: at
#: most 4 dependent multiply-adds; 6 of a squaring: 2), joined by one
#: three-input int64 add (2 dependent instructions, low and high halves),
#: then a parallel carry of two rounds, every limb at once: the first adds
#: its rounding constant (an int64 add, 2), shifts (1) and adds its carry
#: into the next limb (2; limb 9's times 19 into limb 0 is one wide
#: multiply-add and the high half's, 2 as well); the second, whose carries
#: fit 32 bits, adds (2), shifts (1) and adds 32 bits (1).  Two rounds
#: bring columns under 2^61.2, the widest either kernel makes, back within
#: the carried bound (tests/test_torch_ed25519.py::
#: test_split_carry_bounds_hold).  The kernels' own carries are longer:
#: ref10's 12-step chain (the ladder) is 35 on its longest path (limbs 4,
#: 5, ..., 9, 0), decompression's split carry 16 and a hop of shuffles
#: (csrc/ed25519.cu), so the floor is the function's, not a kernel's.
DEPENDENT_ISSUE_CYCLES = 4
CARRY_CHAIN = (2 + 1 + 2) + (2 + 1 + 1)
MUL_CHAIN = 4 + 2 + CARRY_CHAIN
SQR_CHAIN = 2 + 2 + CARRY_CHAIN
#: A ladder stage: a shuffle, a select and an add, then one product or
#: squaring a lane.  Stages on a quad's path: -A (1) and its cached form
#: (1); 14 table entries, each an addition (2) and a conversion (1); 64
#: windows of 4 doublings (a squaring stage, then a product stage) and 2
#: additions (2 product stages); the last product against R (1).
LADDER_STAGE_OVERHEAD = 3
LADDER_SQR_STAGES = 64 * 4
LADDER_STAGES = 2 + 14 * 3 + 64 * 12 + 1
#: The extended ladder loads -A: its cached form is the first stage.
LADDER_EXTENDED_STAGES = LADDER_STAGES - 1
#: Decompression's longest chain, every squaring and product but u v^3
#: and x sqrt(-1): y^2, d y^2, v^2, v^3, v^6, v^7, u v^7 (3 squarings, 4
#: products), pow22523's 251 squarings and 11 products, then x, x^2, v x^2
#: (1 squaring, 2 products).
DECOMPRESS_CHAIN_SQR = 3 + 251 + 1
DECOMPRESS_CHAIN_MUL = 4 + 11 + 2


def chain_floor_cycles(kernel: str) -> int:
    """Cycles on one row's longest dependent chain (see MUL_CHAIN)."""
    if kernel in ("ladder", "ladder_extended"):
        stages = LADDER_STAGES if kernel == "ladder" else LADDER_EXTENDED_STAGES
        mul_stages = stages - LADDER_SQR_STAGES
        instructions = (
            mul_stages * (MUL_CHAIN + LADDER_STAGE_OVERHEAD)
            + LADDER_SQR_STAGES * (SQR_CHAIN + LADDER_STAGE_OVERHEAD)
        )
    elif kernel == "decompress":
        instructions = (DECOMPRESS_CHAIN_MUL * MUL_CHAIN
                        + DECOMPRESS_CHAIN_SQR * SQR_CHAIN)
    else:
        raise ValueError(f"no chain floor for {kernel!r}")
    return instructions * DEPENDENT_ISSUE_CYCLES


def int_ops_per_row(ops: dict) -> int:
    """32-bit integer instructions a kernel row needs (see INT_OPS)."""
    return sum(INT_OPS[name] * count for name, count in ops.items())


def int_to_limbs(x: int) -> np.ndarray:
    """0 <= x < 2^255 -> (10,) int32 limbs, limb i holding bits
    [OFFSETS[i], OFFSETS[i] + WIDTHS[i])."""
    if not 0 <= x < 1 << 255:
        raise ValueError("value out of range for 10 limbs of radix 2^25.5")
    return np.array(
        [(x >> off) & ((1 << w) - 1) for off, w in zip(OFFSETS, WIDTHS)],
        dtype=np.int32,
    )


def limbs_to_int(limbs) -> int:
    """Limbs (signed, any reduced form) -> the integer they stand for
    (not reduced mod p)."""
    return sum(
        int(v) << off for v, off in zip(np.asarray(limbs).tolist(), OFFSETS)
    )


def _niels_table() -> list:
    """[j]B for j = 0..15 as affine Niels points (y - x, y + x, 2d x y)
    mod p; j = 0 is the identity, (1, 1, 0)."""
    table = []
    for j in range(16):
        pt = host.scalar_mult(j, host.to_extended(host.BASE))
        z_inv = pow(pt[2], P - 2, P)
        x, y = pt[0] * z_inv % P, pt[1] * z_inv % P
        table.append(((y - x) % P, (y + x) % P, 2 * host.D * x * y % P))
    return table


def constants() -> np.ndarray:
    """(CONST_ROWS, 10) int32: d, 2d, sqrt(-1), then [j]B for j = 0..15 as
    affine Niels points, three rows (y - x, y + x, 2d x y) each.  The
    kernels read it from device memory; the plain versions use the same
    values."""
    rows = [host.D, 2 * host.D % P, SQRT_M1]
    for point in _niels_table():
        rows.extend(point)
    return np.stack([int_to_limbs(v) for v in rows])


_CONSTANTS = constants()
_CONSTANTS_ON: dict = {}  # device -> int32 tensor of _CONSTANTS


def _constants_on(device: torch.device) -> torch.Tensor:
    table = _CONSTANTS_ON.get(device)
    if table is None:
        table = _CONSTANTS_ON[device] = torch.from_numpy(_CONSTANTS).to(device)
    return table


# -- the plain version: field arithmetic on int64 (..., 10) tensors ---------

_W = torch.tensor(WIDTHS, dtype=torch.int64)
_HALF = torch.tensor([1 << (w - 1) for w in WIDTHS], dtype=torch.int64)
_SCALE = torch.tensor([1 << w for w in WIDTHS], dtype=torch.int64)
# Column k of a product sums f[(k - j) % 10] * g[j] * coefficient: 2 when
# both limbs are odd (two half-bit offsets), 19 when the column wraps past
# 2^255.
_IDX = torch.tensor([[(k - j) % NLIMB for j in range(NLIMB)] for k in range(NLIMB)])
_COEF = torch.tensor(
    [
        [
            (2 if (k - j) % NLIMB % 2 and j % 2 else 1)
            * (19 if (k - j) % NLIMB + j >= NLIMB else 1)
            for j in range(NLIMB)
        ]
        for k in range(NLIMB)
    ],
    dtype=torch.int64,
)
_TABLES_ON: dict = {}  # device -> (_W, _HALF, _SCALE, _IDX, _COEF) there


def _tables(device):
    tables = _TABLES_ON.get(device)
    if tables is None:
        tables = _TABLES_ON[device] = tuple(
            t.to(device) for t in (_W, _HALF, _SCALE, _IDX, _COEF)
        )
    return tables


def _carry_pass(h):
    """One rounding carry pass over every limb at once; the carry out of
    limb 9 re-enters limb 0 times 19 (2^255 = 19 mod p)."""
    w, half, scale, _idx, _coef = _tables(h.device)
    c = (h + half) >> w
    h = h - c * scale
    return h + torch.cat([19 * c[..., 9:], c[..., :9]], dim=-1)


def _fe_add(f, g):
    return _carry_pass(f + g)


def _fe_sub(f, g):
    return _carry_pass(f - g)


def _fe_mul(f, g):
    _w, _half, _scale, idx, coef = _tables(f.device)
    h = (f[..., idx] * g[..., None, :] * coef).sum(dim=-1)
    return _carry_pass(_carry_pass(_carry_pass(h)))


def _fe_sq(f):
    # The kernel's symmetric square sums the same columns: equal limbs.
    return _fe_mul(f, f)


def _chain(h, wrap: bool):
    """Sequential floor carries from limb 0 to limb 9; with ``wrap`` the
    carry out of limb 9 re-enters limb 0 times 19, without it bit 255 is
    dropped."""
    cols = list(h.unbind(-1))
    for i in range(NLIMB - 1):
        c = cols[i] >> WIDTHS[i]
        cols[i] = cols[i] - c * (1 << WIDTHS[i])
        cols[i + 1] = cols[i + 1] + c
    c = cols[9] >> 25
    cols[9] = cols[9] - c * (1 << 25)
    if wrap:
        cols[0] = cols[0] + 19 * c
    return cols


def _fe_canonical(h):
    """Reduced limbs -> the limbs of the value's representative in [0, p),
    each in [0, 2^w).  Two wrapping chains put the value in [0, 2^255);
    q = 1 exactly when it is >= p, and then 19 is added and bit 255
    dropped."""
    cols = _chain(torch.stack(_chain(h, True), dim=-1), True)
    q = (cols[0] + 19) >> 26
    for i in range(1, NLIMB):
        q = (cols[i] + q) >> WIDTHS[i]
    cols[0] = cols[0] + 19 * q
    return torch.stack(_chain(torch.stack(cols, dim=-1), False), dim=-1)


def _fe_is_zero(h):
    return (_fe_canonical(h) == 0).all(dim=-1)


def _fe_eq(f, g):
    return _fe_is_zero(_fe_sub(f, g))


def _const(device, row: int, shape):
    table = _constants_on(device).to(torch.int64)
    return table[row].expand(*shape, NLIMB)


def _pow22523(z):
    """z^((p-5)/8) = z^(2^252 - 3): ref10's chain, 251 squarings and 11
    products."""

    def sqn(x, n):
        for _ in range(n):
            x = _fe_sq(x)
        return x

    t0 = _fe_sq(z)
    t1 = _fe_mul(z, sqn(t0, 2))
    t0 = _fe_mul(t0, t1)
    t0 = _fe_mul(t1, _fe_sq(t0))  # 2^5 - 1
    t0 = _fe_mul(sqn(t0, 5), t0)  # 2^10 - 1
    t1 = _fe_mul(sqn(t0, 10), t0)  # 2^20 - 1
    t1 = _fe_mul(sqn(t1, 20), t1)  # 2^40 - 1
    t0 = _fe_mul(sqn(t1, 10), t0)  # 2^50 - 1
    t1 = _fe_mul(sqn(t0, 50), t0)  # 2^100 - 1
    t1 = _fe_mul(sqn(t1, 100), t1)  # 2^200 - 1
    t0 = _fe_mul(sqn(t1, 50), t0)  # 2^250 - 1
    return _fe_mul(sqn(t0, 2), z)  # 2^252 - 3


def _frombytes(words):
    """(m, 8) int32 little-endian words of 32-byte encodings -> (m, 10)
    int64 limbs of y (bit 255 cleared) and the (m,) sign bit."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    cols = []
    for off, width in zip(OFFSETS, WIDTHS):
        a, s = divmod(off, 32)
        v = w[:, a] >> s
        if a < 7:
            v = v | (w[:, a + 1] << (32 - s))
        cols.append(v & ((1 << width) - 1))
    return torch.stack(cols, dim=-1), (w[:, 7] >> 31) & 1


def decompress_plain(enc: torch.Tensor):
    """The decompress kernel's function in plain PyTorch, on the tensor's
    device: (m, 8) int32 words of 32-byte encodings -> ((m, 2, 10) int32
    canonical affine (x, y), (m,) int32 ok).  ok is 1 exactly when the
    encoding is a curve point (given y < p, which the host checks); x and y
    are meaningless where ok is 0."""
    y, sign = _frombytes(enc)
    shape = y.shape[:-1]
    one = torch.zeros_like(y)
    one[..., 0] = 1
    yy = _fe_sq(y)
    u = _fe_sub(yy, one)  # y^2 - 1
    v = _fe_add(_fe_mul(_const(y.device, CONST_D, shape), yy), one)  # d y^2 + 1
    v3 = _fe_mul(_fe_sq(v), v)
    v7 = _fe_mul(_fe_sq(v3), v)
    x = _fe_mul(_fe_mul(u, v3), _pow22523(_fe_mul(u, v7)))  # root of u/v?
    vxx = _fe_mul(v, _fe_sq(x))
    is_root = _fe_eq(vxx, u)
    is_neg_root = _fe_eq(vxx, _fe_sub(torch.zeros_like(u), u))
    x_fixed = _fe_mul(x, _const(y.device, CONST_SQRT_M1, shape))
    x = _fe_canonical(torch.where(is_neg_root[..., None], x_fixed, x))
    x_is_zero = (x == 0).all(dim=-1)
    ok = (is_root | is_neg_root) & ~(x_is_zero & (sign == 1))
    flip = (x[..., 0] & 1) != sign
    x_neg = _fe_canonical(_fe_sub(torch.zeros_like(x), x))
    x = torch.where(flip[..., None], x_neg, x)
    xy = torch.stack([x, _fe_canonical(y)], dim=-2)
    return xy.to(torch.int32), ok.to(torch.int32)


def _point_add(p, q, want_t=True):
    """P + Q (add-2008-hwcd-3, complete for a = -1) with P extended (X, Y,
    Z, T) and Q cached (Y - X, Y + X, 2Z, 2d T): 8 products.  A Niels
    point (y - x, y + x, 2d x y), Z = 1, comes with ``None`` for 2Z, and
    2 Z1 is a sum: 7 products.  Without ``want_t`` (the sum feeds only a
    doubling or the comparison, which never read T) T3 is not made and
    comes back ``None``: one product fewer."""
    x1, y1, z1, t1 = p
    ymx, ypx, z2, t2d = q
    a = _fe_mul(_fe_sub(y1, x1), ymx)
    b = _fe_mul(_fe_add(y1, x1), ypx)
    c = _fe_mul(t1, t2d)
    d = _fe_add(z1, z1) if z2 is None else _fe_mul(z1, z2)
    e = _fe_sub(b, a)
    f = _fe_sub(d, c)
    g = _fe_add(d, c)
    h = _fe_add(b, a)
    return _from_efgh(e, f, g, h, want_t)


def _cached(p, d2):
    """Extended (X, Y, Z, T) -> cached (Y - X, Y + X, 2Z, 2d T)."""
    x, y, z, t = p
    return (_fe_sub(y, x), _fe_add(y, x), _fe_add(z, z), _fe_mul(t, d2))


def _from_efgh(e, f, g, h, want_t):
    """(X3, Y3, Z3, T3) = (E F, G H, F G, E H), T3 only if wanted."""
    t3 = _fe_mul(e, h) if want_t else None
    return (_fe_mul(e, f), _fe_mul(g, h), _fe_mul(f, g), t3)


def _point_double(p, want_t=True):
    """Dedicated doubling (dbl-2008-hwcd, a = -1): 4 squarings and 4
    products, 3 without ``want_t`` (see ``_point_add``).  T1 is not
    read."""
    x1, y1, z1, _t1 = p
    a = _fe_sq(x1)
    b = _fe_sq(y1)
    zz = _fe_sq(z1)
    c = _fe_add(zz, zz)
    e = _fe_sub(_fe_sub(_fe_sq(_fe_add(x1, y1)), a), b)
    g = _fe_sub(b, a)
    f = _fe_sub(g, c)
    h = _fe_sub(torch.zeros_like(a), _fe_add(a, b))
    return _from_efgh(e, f, g, h, want_t)


def _window(words, t: int):
    """4-bit window t (0 = bits 255..252) of (n, 8) int64 scalar words."""
    nib = 63 - t
    return (words[:, nib // 8] >> (4 * (nib % 8))) & 15


def _shamir(neg_a, rx, ry, s_words, k_words):
    """The two ladders' shared body, batched over rows: [S]B + [k](-A)
    from -A extended (a tuple of (n, 10) int64 limbs, any Z), compared
    projectively with the affine R; (n,) bool, Z != 0 included.

    The kernels' formulas (the [j](-A) table in cached form, [j]B as Niels
    points from the constants), serially, with every sum and product
    carried: the kernels' lane schedule and their lazy sums are not
    copied, and the verdicts are what the two share."""
    x0 = neg_a[0]
    n = x0.shape[0]
    device = x0.device
    zero = torch.zeros_like(x0)
    one = zero.clone()
    one[:, 0] = 1
    d2 = _const(device, CONST_D2, (n,))
    neg_a_cached = _cached(neg_a, d2)
    table = [(one, one, _fe_add(one, one), zero), neg_a_cached]
    point = neg_a
    for _ in range(14):
        point = _point_add(point, neg_a_cached)
        table.append(_cached(point, d2))
    a_table = torch.stack([torch.stack(pt, dim=1) for pt in table], dim=1)
    niels = (
        _constants_on(device)[CONST_NIELS:].to(torch.int64).view(16, 3, NLIMB)
    )
    rows = torch.arange(n, device=device)
    s = s_words.to(torch.int64) & 0xFFFFFFFF
    k = k_words.to(torch.int64) & 0xFFFFFFFF
    acc = (zero, one, one, zero)
    for t in range(64):
        # T is made only where an addition reads it: after the fourth
        # doubling and the [j]B addition.
        for i in range(4):
            acc = _point_double(acc, want_t=i == 3)
        ymx, ypx, t2d = niels[_window(s, t)].unbind(1)
        acc = _point_add(acc, (ymx, ypx, None, t2d))
        acc = _point_add(acc, a_table[rows, _window(k, t)].unbind(1),
                         want_t=False)
    x, y, z, _t = acc
    return (
        _fe_eq(x, _fe_mul(rx, z))
        & _fe_eq(y, _fe_mul(ry, z))
        & ~_fe_is_zero(z)
    )


def ladder_plain(xy, ok, s_words, k_words):
    """The ladder kernel's function in plain PyTorch, on the tensors'
    device.  xy: (2n, 2, 10) int32 affine points from ``decompress`` (A
    rows, then R rows); ok: (2n,) int32; s_words, k_words: (n, 8) int32
    little-endian words of the scalars S and k.  Returns (n,) int32: 1 where
    [S]B + [k](-A) == R, Z != 0 and both points decompressed.  -A is
    (-x, y, 1, -x y), then ``_shamir``."""
    n = s_words.shape[0]
    pts = xy.to(torch.int64)
    ax, ay = pts[:n, 0], pts[:n, 1]
    rx, ry = pts[n:, 0], pts[n:, 1]
    valid = (ok[:n] != 0) & (ok[n:] != 0)
    one = torch.zeros_like(ax)
    one[:, 0] = 1
    nx = _fe_sub(torch.zeros_like(ax), ax)
    neg_a = (nx, ay, one, _fe_mul(nx, ay))
    good = _shamir(neg_a, rx, ry, s_words, k_words) & valid
    return good.to(torch.int32)


def ladder_extended_plain(neg_a, r_xy, s_words, k_words):
    """The extended ladder kernel's function in plain PyTorch, on the
    tensors' device.  neg_a: (n, 4, 10) int32 -A in extended coordinates
    (X, Y, Z, T, any Z != 0), limbs of values in [0, p); r_xy: (n, 2, 10)
    int32 affine R; s_words, k_words: (n, 8) int32.  Returns (n,) int32: 1
    where [S]B + [k](-A) == R and Z != 0 (the host route rejects a point
    that does not decompress before it packs a row)."""
    pts = neg_a.to(torch.int64)
    r = r_xy.to(torch.int64)
    good = _shamir(tuple(pts.unbind(1)), r[:, 0], r[:, 1], s_words, k_words)
    return good.to(torch.int32)


# -- the kernels --------------------------------------------------------------


def _kernel_library():
    from .._build import load

    lib = load("ed25519")
    if lib.mirbft_ed25519_decompress.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.mirbft_ed25519_decompress.argtypes = [ptr, ptr, ptr, i32, ptr, ptr]
        lib.mirbft_ed25519_decompress.restype = i32
        lib.mirbft_ed25519_ladder.argtypes = [
            ptr, ptr, ptr, ptr, ptr, i32, ptr, ptr,
        ]
        lib.mirbft_ed25519_ladder.restype = i32
        lib.mirbft_ed25519_ladder_extended.argtypes = [
            ptr, ptr, ptr, ptr, ptr, i32, ptr, ptr,
        ]
        lib.mirbft_ed25519_ladder_extended.restype = i32
        lib.mirbft_ed25519_ladder_smem_bytes.argtypes = []
        lib.mirbft_ed25519_ladder_smem_bytes.restype = i32
        lib.mirbft_ed25519_error_string.argtypes = [i32]
        lib.mirbft_ed25519_error_string.restype = ctypes.c_char_p
    return lib


def ladder_smem_bytes() -> int:
    """Either ladder kernel's dynamic shared memory a block (its [j](-A)
    columns and [j]B table), from the built library."""
    return int(_kernel_library().mirbft_ed25519_ladder_smem_bytes())


def _check(name: str, tensor: torch.Tensor, shape: tuple, device) -> None:
    if tuple(tensor.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(tensor.shape)}")
    if tensor.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {tensor.dtype}")
    if tensor.device != device:
        raise ValueError(f"{name} on {tensor.device}, expected {device}")
    if not tensor.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(lib, err: int, kernel: str) -> None:
    if err:
        msg = lib.mirbft_ed25519_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} ({err})")


_LAUNCH_LOCK = threading.Lock()


def _count_launch(wrapper, rows: int) -> None:
    """Add one to ``wrapper.launches`` and to its rows' count.  Under a
    lock: each live node's ingress stage launches from a thread of its
    own, and ``+= 1`` on a function attribute can lose a count to another
    thread."""
    with _LAUNCH_LOCK:
        wrapper.launches += 1
        wrapper.launches_by_rows[rows] += 1


def decompress(enc: torch.Tensor):
    """(m, 8) int32 words of 32-byte point encodings -> ((m, 2, 10) int32
    canonical affine (x, y), (m,) int32 ok).  CUDA tensors launch the kernel
    on the current stream (counted in ``decompress.launches``); CPU tensors
    take ``decompress_plain``."""
    if enc.dim() != 2:
        raise ValueError(f"enc must be (m, 8), got {tuple(enc.shape)}")
    rows = enc.shape[0]
    _check("enc", enc, (rows, 8), enc.device)
    if enc.device.type == "cpu":
        return decompress_plain(enc)
    if enc.device.type != "cuda":
        raise ValueError(f"no ed25519 path for device {enc.device}")
    xy = torch.empty((rows, 2, NLIMB), dtype=torch.int32, device=enc.device)
    ok = torch.empty((rows,), dtype=torch.int32, device=enc.device)
    if rows == 0:
        return xy, ok
    lib = _kernel_library()
    with torch.cuda.device(enc.device):
        err = lib.mirbft_ed25519_decompress(
            enc.data_ptr(), xy.data_ptr(), ok.data_ptr(), rows,
            _constants_on(enc.device).data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(lib, err, "decompress")
    _count_launch(decompress, rows)
    return xy, ok


decompress.launches = 0
decompress.launches_by_rows = collections.Counter()


def ladder(xy, ok, s_words, k_words):
    """Verdicts of n signatures from their decompressed points and scalar
    words (see ``ladder_plain``) -> (n,) int32.  CUDA tensors launch the
    kernel on the current stream (counted in ``ladder.launches``); CPU
    tensors take ``ladder_plain``."""
    if s_words.dim() != 2:
        raise ValueError(f"s_words must be (n, 8), got {tuple(s_words.shape)}")
    n = s_words.shape[0]
    device = s_words.device
    _check("xy", xy, (2 * n, 2, NLIMB), device)
    _check("ok", ok, (2 * n,), device)
    _check("s_words", s_words, (n, 8), device)
    _check("k_words", k_words, (n, 8), device)
    if device.type == "cpu":
        return ladder_plain(xy, ok, s_words, k_words)
    if device.type != "cuda":
        raise ValueError(f"no ed25519 path for device {device}")
    out = torch.empty((n,), dtype=torch.int32, device=device)
    if n == 0:
        return out
    lib = _kernel_library()
    with torch.cuda.device(device):
        err = lib.mirbft_ed25519_ladder(
            xy.data_ptr(), ok.data_ptr(), s_words.data_ptr(),
            k_words.data_ptr(), out.data_ptr(), n,
            _constants_on(device).data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(lib, err, "ladder")
    _count_launch(ladder, n)
    return out


ladder.launches = 0
ladder.launches_by_rows = collections.Counter()


def ladder_extended(neg_a, r_xy, s_words, k_words):
    """Verdicts of n signatures from -A extended and R affine, decompressed
    on the host, and their scalar words (see ``ladder_extended_plain``) ->
    (n,) int32.  CUDA tensors launch the kernel on the current stream
    (counted in ``ladder_extended.launches``); CPU tensors take
    ``ladder_extended_plain``."""
    if s_words.dim() != 2:
        raise ValueError(f"s_words must be (n, 8), got {tuple(s_words.shape)}")
    n = s_words.shape[0]
    device = s_words.device
    _check("neg_a", neg_a, (n, 4, NLIMB), device)
    _check("r_xy", r_xy, (n, 2, NLIMB), device)
    _check("s_words", s_words, (n, 8), device)
    _check("k_words", k_words, (n, 8), device)
    if device.type == "cpu":
        return ladder_extended_plain(neg_a, r_xy, s_words, k_words)
    if device.type != "cuda":
        raise ValueError(f"no ed25519 path for device {device}")
    out = torch.empty((n,), dtype=torch.int32, device=device)
    if n == 0:
        return out
    lib = _kernel_library()
    with torch.cuda.device(device):
        err = lib.mirbft_ed25519_ladder_extended(
            neg_a.data_ptr(), r_xy.data_ptr(), s_words.data_ptr(),
            k_words.data_ptr(), out.data_ptr(), n,
            _constants_on(device).data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(lib, err, "ladder_extended")
    _count_launch(ladder_extended, n)
    return out


ladder_extended.launches = 0
ladder_extended.launches_by_rows = collections.Counter()


# -- host marshalling and the verify pipeline ---------------------------------


def marshal_light(pk: bytes, message: bytes, signature: bytes):
    """Host-side preparation for the device pipeline: byte parsing, the
    range checks y < p (both points) and S < L, and the SHA-512 challenge.
    Returns (pk32, r32, s_int, k_int), or None when structurally invalid
    (the row never reaches a kernel)."""
    if len(pk) != 32 or len(signature) != 64:
        return None
    y_a = int.from_bytes(pk, "little") & ((1 << 255) - 1)
    y_r = int.from_bytes(signature[:32], "little") & ((1 << 255) - 1)
    if y_a >= P or y_r >= P:
        return None
    s = int.from_bytes(signature[32:], "little")
    if s >= L:
        return None
    k = (
        int.from_bytes(
            hashlib.sha512(signature[:32] + pk + message).digest(), "little"
        )
        % L
    )
    return (pk, signature[:32], s, k)


def _words(blobs: list) -> np.ndarray:
    """32-byte strings -> (len, 8) int32 little-endian words."""
    raw = np.frombuffer(b"".join(blobs), dtype="<u4")
    return raw.view(np.int32).reshape(-1, 8).copy()


def pack_rows(rows: list) -> tuple:
    """Marshalled rows -> the kernels' host inputs: (2n, 8) encodings (A,
    then R), and the (n, 8) words of S and of k.  Exactly n rows: a CUDA
    kernel has no per-shape compile to amortise, so nothing is padded."""
    enc = _words([r[0] for r in rows] + [r[1] for r in rows])
    s_words = _words([r[2].to_bytes(32, "little") for r in rows])
    k_words = _words([r[3].to_bytes(32, "little") for r in rows])
    return enc, s_words, k_words


def launch_rows(rows: list, device="cuda", events=None) -> torch.Tensor:
    """Send marshalled rows (from ``marshal_light``) through both kernels
    and return the (n,) int32 verdicts on ``device`` without waiting for
    them.  On CUDA, when ``events`` is a list, the (began, ended) CUDA
    events around the two launches are appended to it."""
    if not rows:
        raise ValueError("launch_rows requires at least one marshalled row")
    device = resolve_device(device)
    enc, s_words, k_words = (
        torch.from_numpy(a).to(device) for a in pack_rows(rows)
    )
    timed = events is not None and device.type == "cuda"
    if timed:
        began = torch.cuda.Event(enable_timing=True)
        ended = torch.cuda.Event(enable_timing=True)
        began.record()
    xy, ok = decompress(enc)
    verdicts = ladder(xy, ok, s_words, k_words)
    if timed:
        ended.record()
        events.append((began, ended))
    return verdicts


def verify_batch(
    pks: list, messages: list, signatures: list, chunk: int = 512,
    device="cuda",
) -> np.ndarray:
    """Verify a batch of Ed25519 signatures; returns (n,) bool.

    Structural failures reject on the host (``marshal_light``); the rest go
    through both kernels in chunks of ``chunk`` rows, each launched as soon
    as it is marshalled, so host hashing overlaps device work."""
    device = resolve_device(device)
    n = len(pks)
    if len(messages) != n or len(signatures) != n:
        raise ValueError("pks, messages and signatures differ in length")
    ok = np.zeros(n, dtype=bool)
    pending = []
    rows: list = []
    indices: list = []
    for i, (pk, msg, sig) in enumerate(zip(pks, messages, signatures)):
        row = marshal_light(pk, msg, sig)
        if row is None:
            continue
        rows.append(row)
        indices.append(i)
        if len(rows) == chunk:
            pending.append((indices, launch_rows(rows, device)))
            rows, indices = [], []
    if rows:
        pending.append((indices, launch_rows(rows, device)))
    for idx, verdicts in pending:
        ok[idx] = verdicts.cpu().numpy() != 0
    return ok


def verify_batch_pallas(
    pks: list, messages: list, signatures: list, chunk: int = 4096,
    device="cuda",
) -> np.ndarray:
    """``verify_batch`` at the JAX Pallas pipeline's chunk of 4096 rows:
    the same two kernels."""
    return verify_batch(pks, messages, signatures, chunk=chunk, device=device)


# -- the host route: host decompression, the extended ladder ------------------


def marshal_signature(pk: bytes, message: bytes, signature: bytes):
    """The JAX ``ops/ed25519.py::marshal_signature`` on the port's host
    code: structural checks, both points decompressed on the host, S < L,
    the SHA-512 challenge.  Returns (s, k, -A extended (X, Y, Z, T), R
    affine (x, y)), every one ints, or None where the signature is rejected
    on the host (the JAX function returns None on the same rows)."""
    if len(pk) != 32 or len(signature) != 64:
        return None
    a = host.decompress(pk)
    r = host.decompress(signature[:32])
    if a is None or r is None:
        return None
    s = int.from_bytes(signature[32:], "little")
    if s >= L:
        return None
    k = (
        int.from_bytes(
            hashlib.sha512(signature[:32] + pk + message).digest(), "little"
        )
        % L
    )
    return (s, k, host.point_negate(a), (r[0], r[1]))


def _scalar_words(values) -> np.ndarray:
    """Scalars below 2^256 -> (len, 8) int32 little-endian words."""
    return _words([v.to_bytes(32, "little") for v in values])


def _limb_rows(values) -> np.ndarray:
    """Field values in [0, p) -> (len, 10) int32 limbs."""
    return np.stack([int_to_limbs(v) for v in values])


def pack_signature_rows(rows: list, batch_floor: int = 1) -> tuple:
    """The JAX ``ops/ed25519.py::pack_rows`` for ``marshal_signature``'s
    rows: (s_words (n, 8), k_words (n, 8), neg_a (n, 4, 10), r_affine (n,
    2, 10)), int32, in the JAX function's order.  n is padded only to a
    multiple of ``batch_floor`` (the mesh size of a sharded call), by
    repeating row 0, whose verdicts the caller discards: a CUDA kernel has
    no per-shape compile, so nothing is padded to a power of two."""
    if not rows:
        raise ValueError(
            "pack_signature_rows needs at least one row; a batch the host "
            "rejected whole has nothing to launch"
        )
    padded = rows + [rows[0]] * (-len(rows) % batch_floor)
    n = len(padded)
    s_words = _scalar_words([row[0] for row in padded])
    k_words = _scalar_words([row[1] for row in padded])
    neg_a = _limb_rows([c for row in padded for c in row[2]]).reshape(
        n, 4, NLIMB)
    r_affine = _limb_rows([c for row in padded for c in row[3]]).reshape(
        n, 2, NLIMB)
    return s_words, k_words, neg_a, r_affine


#: The JAX package's limbs: 20 of 13 bits.
JAX_LIMBS, JAX_RADIX = 20, 13


def _jax_limbs_to_int(limbs) -> list:
    """(n, 20) 13-bit limbs (the JAX layout) -> their values mod p."""
    weights = [1 << (JAX_RADIX * i) for i in range(JAX_LIMBS)]
    return [
        sum(int(v) * w for v, w in zip(row, weights)) % P
        for row in np.asarray(limbs).tolist()
    ]


def _bits_to_words(bits) -> np.ndarray:
    """(n, 256) MSB-first bits (the JAX layout) -> (n, 8) int32
    little-endian words."""
    lsb = np.asarray(bits, dtype=np.uint64)[:, ::-1].reshape(-1, 8, 32)
    words = (lsb << np.arange(32, dtype=np.uint64)).sum(axis=2)
    return words.astype(np.uint32).view(np.int32)


def from_jax_rows(s_bits, k_bits, neg_a, r_affine) -> tuple:
    """The JAX ``pack_rows`` arrays -> ``pack_signature_rows``'s, padding
    rows included: scalar bits to words, each coordinate's 13-bit limbs to
    the port's 10 limbs of its value mod p.  ``neg_a`` and ``r_affine`` are
    the JAX tuples of 4 and 2 (n, 20) limb arrays."""
    n = len(np.asarray(s_bits))
    neg = np.stack(
        [_limb_rows(_jax_limbs_to_int(c)) for c in neg_a], axis=1)
    r = np.stack(
        [_limb_rows(_jax_limbs_to_int(c)) for c in r_affine], axis=1)
    return (_bits_to_words(s_bits), _bits_to_words(k_bits),
            neg.reshape(n, 4, NLIMB), r.reshape(n, 2, NLIMB))


def launch_signature_rows(rows: list, device="cuda",
                          batch_floor: int = 1) -> torch.Tensor:
    """Send ``marshal_signature``'s rows through the extended ladder and
    return the (n,) int32 verdicts on ``device`` without waiting for them,
    n the rows padded to a multiple of ``batch_floor``."""
    device = resolve_device(device)
    s_words, k_words, neg_a, r_affine = (
        torch.from_numpy(a).to(device)
        for a in pack_signature_rows(rows, batch_floor)
    )
    return ladder_extended(neg_a, r_affine, s_words, k_words)
