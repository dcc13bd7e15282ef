// Batched Ed25519 verification for Hopper (sm_90a): point decompression,
// a group of kDecGroup lanes per point, and the 4-bit windowed Shamir
// ladder, four lanes (a quad) per signature.
//
// Replaces the Pallas TPU kernels of mirbft_tpu/ops/ed25519_pallas.py:
//   - mirbft_ed25519_decompress: _decompress_kernel (:410, launched by
//     _verify_device at :528);
//   - mirbft_ed25519_ladder: _ladder_affine_kernel + _ladder_tail (:356,
//     :308, launched at :559), over the decompressed points;
//   - mirbft_ed25519_ladder_extended: _ladder_kernel + _ladder_tail (:341),
//     over -A in extended coordinates decompressed on the host, the form of
//     its XLA twin mirbft_tpu/ops/ed25519.py::ladder_impl (the host route,
//     marshal_signature, and the sharded verify of parallel/sharding.py).
// The two ladders share one body (ladder_quad).  The plain PyTorch versions
// in mirbft_tpu_torch/ops/ed25519.py compute the same functions serially
// with their own carries: decompression's output is canonical and a
// ladder's is one verdict a row, so kernel and plain agree exactly on what
// they return, not limb for limb on the way.
//
// Field representation.  GF(2^255 - 19) as 10 signed int32 limbs of radix
// 2^25.5 (ref10's layout: widths w = 26, 25, 26, ..., limb i at bit
// 0, 26, 51, 77, 102, 128, 153, 179, 204, 230), products as int64.  The
// TPU's 20 x 13-bit limbs existed only because the TPU has no 64-bit
// multiply; Hopper has IMAD.WIDE.  Write U_w = 2^(w-1) (1 + 2^-9); an
// element is "carried" when |limb i| <= U_w(i) and "k-term" when it is a
// sum or difference of k carried elements (|limb| <= k U_w), taken without
// a carry.  The bounds:
//   - mul(f, g): the factor 2 (both limbs odd) goes on f, the factor 19
//     (columns past 2^255) on g, and both must fit int32.  f may be up to
//     4-term (2 * 4 U_25 = 4 U_26 = 2^27 (1 + 2^-9)) and g up to 3-term
//     (19 * 3 U_26 = 28.5 * 2^26 (1 + 2^-9) < 2^30.84 < 2^31).  A column is
//     at most 10 terms of |f'| |g'| < 2^27.01 * 2^30.84, under 2^61.2, so
//     int64 holds it.  sq(f): f up to 2-term (4 * 2 U_25 and 19 * 2 U_26
//     fit int32; at most 6 terms a column, under 2^60).
//   - the product's carry is ref10's chain of 12 rounding steps, in the
//     order 0 4 1 5 2 6 3 7 4 8 9 0 (limb 9's carry re-enters limb 0 times
//     19): each step leaves its limb in [-2^(w-1), 2^(w-1)).  From columns
//     under 2^61.2 the carries are under 2^36.2, so the last two steps add
//     at most 2^14.5 to limb 1 and 2^10.3 to limb 5: the result is carried.
//   - decompression splits each element over its lanes and carries every
//     product and sum with a carry of its own (its section below states
//     the bounds); the comparisons' differences carry with one int32
//     rounding pass (|limb| <= 2^(w-1) + 76, carried); the ladder's adds
//     and subs take no carry at all, and each product's operands are at
//     most the k-term sums allowed above (the ladder functions below name
//     k for each).
//   - canonical: two wrapping floor chains put the value in [0, 2^255); a
//     quotient chain finds whether it is >= p; a last chain subtracts p.
//
// What bounds it.  The bytes are well under 200 a row, so at 3.35 TB/s
// they take a small fraction of the time the INT32 pipes need; but a burst
// of 512 signatures cannot fill 132 SMs, so the ladder is bound by one
// signature: its ~800 product stages are serial, and each is a product
// (100 or 55 IMAD.WIDE and the carry chain) plus its shuffles and selects,
// issued by one warp alone on its SM partition.  The design spreads a
// signature's products over four lanes so that a stage is one product:
//   - a quad of adjacent lanes per signature (8 signatures a warp), in the
//     four-processor formulas for a = -1 extended coordinates (Hisil, Wong,
//     Carter, Dawson, "Twisted Edwards Curves Revisited", ASIACRYPT 2008):
//     lane c holds coordinate c of the accumulator (X, Y, Z, T), each stage
//     runs four independent products one a lane, and operands move inside
//     the quad by __shfl_sync.  A doubling is two product stages (four
//     squarings, then four products), an addition two (four products, then
//     four), against 8 and 9 dependent products in one thread.  A 512-row
//     burst is 2048 threads: 16 blocks of 128, one warp a partition of 16
//     SMs;
//   - the [j](-A) table in cached form (Y - X, Y + X, 2Z, 2d T), each lane
//     holding its own coordinate of the 16 entries in shared memory
//     (16 x 10 limbs x 128 lanes = 80 KB a block, above the 48 KB of static
//     shared memory: dynamic, after cudaFuncSetAttribute), laid out limb by
//     limb with the lanes innermost, so a warp's reads hit 32 banks
//     whatever entries its quads pick;
//   - the [j]B table as affine Niels points (y - x, y + x, 2d x y) from the
//     constants, with the 2Z coordinate (Z = 1) set to 2, in shared memory:
//     an addition with [j]B or [j](-A) makes no d product and no Z x Z
//     product at all (the lane of D = 2Z multiplies by the table's 2Z);
//   - the windows are cut from the 32-byte scalars in the kernel;
//   - the quad of a row past n repeats row n - 1 (every lane of the warp
//     takes part in every shuffle) and writes nothing.
// The verdict is over public data, so the tables are indexed directly:
// nothing here has to be constant-time.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLadderThreads = 128;  // 32 quads: 32 signatures a block
// Rows of the constants table (ops/ed25519.py::constants()).
constexpr int kConstD = 0;
constexpr int kConstD2 = 1;
constexpr int kConstSqrtM1 = 2;
constexpr int kConstNiels = 3;  // [j]B: (y - x, y + x, 2d x y), j = 0..15
constexpr int kATableInts = 16 * 10 * kLadderThreads;
constexpr int kBTableInts = 16 * 4 * 10;
constexpr int kLadderSmemBytes = (kATableInts + kBTableInts) * 4;

struct Fe {
  int32_t v[10];
};

__host__ __device__ constexpr int width(int i) { return (i & 1) ? 25 : 26; }

__device__ __forceinline__ Fe fe_small(int32_t x) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 10; ++i) r.v[i] = 0;
  r.v[0] = x;
  return r;
}

__device__ __forceinline__ Fe fe_zero() { return fe_small(0); }
__device__ __forceinline__ Fe fe_one() { return fe_small(1); }

__device__ __forceinline__ Fe fe_load(const int32_t* p) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 10; ++i) r.v[i] = p[i];
  return r;
}

// One rounding carry pass over every limb at once, int32, for sums and
// differences (under 2^28 a limb).
__device__ __forceinline__ void carry_pass32(int32_t h[10]) {
  int32_t c[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    c[i] = (h[i] + (1 << (width(i) - 1))) >> width(i);
    h[i] -= c[i] * (1 << width(i));
  }
  h[0] += 19 * c[9];
#pragma unroll
  for (int i = 1; i < 10; ++i) h[i] += c[i - 1];
}

// A carried difference (the comparisons).
__device__ __forceinline__ Fe fe_sub(const Fe& f, const Fe& g) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 10; ++i) r.v[i] = f.v[i] - g.v[i];
  carry_pass32(r.v);
  return r;
}

// Sums and differences without a carry (the ladder's k-term operands).
__device__ __forceinline__ Fe fe_add_nc(const Fe& f, const Fe& g) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 10; ++i) r.v[i] = f.v[i] + g.v[i];
  return r;
}

__device__ __forceinline__ Fe fe_sub_nc(const Fe& f, const Fe& g) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 10; ++i) r.v[i] = f.v[i] - g.v[i];
  return r;
}

// One rounding step of ref10's chain: limb i into [-2^(w-1), 2^(w-1)),
// its carry into limb i + 1 (limb 9's into limb 0, times 19).
__device__ __forceinline__ void carry_step(int64_t h[10], int i) {
  const int w = width(i);
  const int64_t c = (h[i] + (int64_t{1} << (w - 1))) >> w;
  h[i] -= c * (int64_t{1} << w);
  if (i == 9) {
    h[0] += 19 * c;
  } else {
    h[i + 1] += c;
  }
}

__device__ __forceinline__ Fe finish_product(int64_t h[10]) {
  carry_step(h, 0);
  carry_step(h, 4);
  carry_step(h, 1);
  carry_step(h, 5);
  carry_step(h, 2);
  carry_step(h, 6);
  carry_step(h, 3);
  carry_step(h, 7);
  carry_step(h, 4);
  carry_step(h, 8);
  carry_step(h, 9);
  carry_step(h, 0);
  Fe r;
#pragma unroll
  for (int i = 0; i < 10; ++i) r.v[i] = static_cast<int32_t>(h[i]);
  return r;
}

// Schoolbook product: column (i + j) % 10 gains f_i g_j, times 2 when both
// limbs are odd and times 19 when i + j >= 10.
__device__ Fe fe_mul(const Fe& f, const Fe& g) {
  int32_t f2[10], g19[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    f2[i] = (i & 1) ? 2 * f.v[i] : f.v[i];
    g19[i] = 19 * g.v[i];
  }
  int64_t h[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) h[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
#pragma unroll
    for (int j = 0; j < 10; ++j) {
      const int32_t a = ((i & 1) && (j & 1)) ? f2[i] : f.v[i];
      const int32_t b = (i + j >= 10) ? g19[j] : g.v[j];
      h[(i + j) % 10] += static_cast<int64_t>(a) * b;
    }
  }
  return finish_product(h);
}

// Symmetric square: the same columns as fe_mul(f, f), each off-diagonal
// pair taken once and doubled (55 products instead of 100).
__device__ Fe fe_sq(const Fe& f) {
  int64_t h[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) h[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
#pragma unroll
    for (int j = i; j < 10; ++j) {
      const int32_t a =
          f.v[i] * ((i == j) ? 1 : 2) * (((i & 1) && (j & 1)) ? 2 : 1);
      const int32_t b = (i + j >= 10) ? 19 * f.v[j] : f.v[j];
      h[(i + j) % 10] += static_cast<int64_t>(a) * b;
    }
  }
  return finish_product(h);
}

// Sequential floor carries from limb 0 to limb 9; with wrap the carry out
// of limb 9 re-enters limb 0 times 19, without it bit 255 is dropped.
__device__ __forceinline__ void chain(int32_t h[10], bool wrap) {
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const int32_t c = h[i] >> width(i);
    h[i] -= c * (1 << width(i));
    h[i + 1] += c;
  }
  const int32_t c = h[9] >> 25;
  h[9] -= c * (1 << 25);
  if (wrap) h[0] += 19 * c;
}

// Carried limbs -> the limbs of the representative in [0, p).
__device__ Fe fe_canonical(const Fe& f) {
  Fe r = f;
  chain(r.v, true);
  chain(r.v, true);
  int32_t q = (r.v[0] + 19) >> 26;
#pragma unroll
  for (int i = 1; i < 10; ++i) q = (r.v[i] + q) >> width(i);
  r.v[0] += 19 * q;
  chain(r.v, false);
  return r;
}

__device__ __forceinline__ bool fe_is_zero(const Fe& f) {
  const Fe c = fe_canonical(f);
  int32_t any = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) any |= c.v[i];
  return any == 0;
}

__device__ __forceinline__ bool fe_eq(const Fe& f, const Fe& g) {
  return fe_is_zero(fe_sub(f, g));
}

__device__ __forceinline__ Fe fe_select(bool cond, const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 10; ++i) r.v[i] = cond ? a.v[i] : b.v[i];
  return r;
}

// 32 little-endian bytes as 8 words -> limbs of y (bit 255 cleared).
__device__ __forceinline__ Fe fe_frombytes(const uint32_t w[8]) {
  Fe r;
  int off = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const int a = off >> 5, s = off & 31;
    uint64_t v = w[a];
    if (a < 7) v |= static_cast<uint64_t>(w[a + 1]) << 32;
    r.v[i] = static_cast<int32_t>((v >> s) & ((uint64_t{1} << width(i)) - 1));
    off += width(i);
  }
  return r;
}

// -- decompression: a group of kDecGroup lanes a point -----------------------
//
// What bounds it.  2n points are far from filling the card's INT32 pipes
// (about 39,000 instructions a point), and each point is one serial chain
// of 272 products and squarings: pow22523 cannot be split, and
// Montgomery's trick does not apply to a square root.  One thread a point
// took about 930 cycles a link (a product's 100 or 55 IMAD.WIDE and
// ref10's carry, issued by a warp alone on its partition).  The design
// shortens every link by spreading each product over a group of lanes; a
// 512-signature burst's 1024 points are 171 warps, 43 blocks of 128, still
// one warp a partition, so a link's latency, not issue, sets the time up
// to about 4,000 points.
//
// A field element of one point is split over its group by pairs of limbs:
// pair P is limbs (2P, 2P + 1), of widths 26 and 25.  Lane l of a group
// owns pair l mod 5 ("pair" below): a group of 5 lanes owns one pair a
// lane, and a warp holds 6 groups, its last two lanes repeating lanes 0-1
// of the sixth (lanes that repeat another's work are never read by a
// shuffle).  A product computes this lane's two columns:
//   column 2P' = sum over f's pairs P of f_2P g_2R + 2 f_2P+1 g_2R'+1 and
//   column 2P'+1 = sum of f_2P g_2R+1 + f_2P+1 g_2R, with R = P' - P and
//   R' = P' - P - 1 (mod 5),
// so every column of a lane takes the same terms in the same order, and the
// factor 2 (two odd limbs) falls on f's odd limbs in the even column alone.
// f comes to every lane whole (a broadcast shuffle a limb); g's pair
// (P' - q) mod 5 comes from its owner (a shuffle from a lane that depends on
// the lane, of a register that does not), times 19 when q > P' (its terms
// pass 2^255).  The owner knows which of its readers that is (pair + q >=
// 5) and sends 19 g there: the factors come from a per-lane table
// (DecLane), so no lane branches.  The carry fits the split: each lane
// rounds its low column, adds the carry into its high column and rounds
// that; the high column's carry goes to the owner of the next pair (pair
// 4's, times 19, to pair 0) by one hop of two shuffles, and the low column
// rounds once more into the high one.  The bounds
// (tests/test_torch_ed25519.py::test_split_carry_bounds_hold checks them by
// interval arithmetic):
//   - operands with |limb i| < 2^w (a carried element or y's raw limbs): f's
//     doubled odd limbs are under 2^26 and 19 g under 2^30.3, so both fit
//     int32; a column is 10 terms of at most 2^26 * 19 * 2^26, under 2^59.6,
//     so int64 holds it;
//   - the first round leaves the low limb in [-2^25, 2^25) and hands on a
//     carry under 2^34.6; 19 times it, added to the next low limb, rounds
//     to a carry under 2^13 into the high limb: the result has |lo| <= 2^25
//     and |hi| <= 2^24 + 2^13, carried (U_w above);
//   - sums and differences take the same carry (from int64 columns of two
//     carried elements), and are carried.
// pow22523 keeps ref10's chain (11 products, 251 squarings).  The tail
// (the comparisons, sqrt(-1), canonical form, parity) runs in every lane on
// the gathered ten limbs, with the helpers above; the group's first lane
// stores.

// Lanes a point: one a pair of limbs.  On an H100 a group of 8 (three
// lanes idle) was no faster at 512 and 1024 signatures and a quarter
// slower at 4096, where 30 of a warp's 32 lanes at work, not 20, leave
// fewer warps to a partition; a group of 4 was slower at every n (PERF.md).
constexpr int kDecGroup = 5;
constexpr int kDecThreads = 128;
constexpr int kDecGroupsPerWarp = 32 / kDecGroup;

// The grid of a launch over rows points.
int decompress_grid(int rows) {
  const long long warps = (rows + kDecGroupsPerWarp - 1) / kDecGroupsPerWarp;
  return static_cast<int>((32 * warps + kDecThreads - 1) / kDecThreads);
}

// This lane's pair of limbs of an element.
struct Sp {
  int32_t lo, hi;
};

// This lane's place: its group in the warp, the group's first lane (base)
// and the pair it owns.  For q = 0..4, src[q] is the lane that owns g's
// pair (pair - q) mod 5, and send19[q] whether this lane's pair, read at
// step q, passes 2^255 for its reader (pair + q >= 5).  carry19 is 19 for
// pair 0, whose carry comes from limb 9, else 1.
struct DecLane {
  int group, base, pair;
  int src[5];
  bool send19[5];
  int32_t carry19;
};

__device__ __forceinline__ DecLane dec_lane(int warp_lane) {
  DecLane d;
  d.group = min(warp_lane / kDecGroup, kDecGroupsPerWarp - 1);
  d.base = d.group * kDecGroup;
  d.pair = (warp_lane - d.base) % 5;
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    d.src[q] = d.base + (d.pair - q + 5) % 5;
    d.send19[q] = d.pair + q >= 5;
  }
  d.carry19 = d.pair == 0 ? 19 : 1;
  return d;
}

__device__ __forceinline__ int32_t grp_shfl(int32_t v, int src) {
  return __shfl_sync(0xffffffffu, v, src);
}

__device__ __forceinline__ int64_t grp_shfl64(int64_t v, int src) {
  const int32_t lo = grp_shfl(static_cast<int32_t>(v), src);
  const int32_t hi = grp_shfl(static_cast<int32_t>(v >> 32), src);
  return static_cast<int64_t>(static_cast<uint64_t>(static_cast<uint32_t>(hi)) << 32 |
                              static_cast<uint32_t>(lo));
}

// All ten limbs of f, in every lane of the group.
__device__ __forceinline__ Fe sp_gather(const Sp& f, const DecLane& d) {
  Fe r;
#pragma unroll
  for (int p = 0; p < 5; ++p) {
    r.v[2 * p] = grp_shfl(f.lo, d.base + p);
    r.v[2 * p + 1] = grp_shfl(f.hi, d.base + p);
  }
  return r;
}

// This lane's share of a whole element (selects, not an indexed register).
__device__ __forceinline__ Sp sp_split(const Fe& f, int pair) {
  Sp r{f.v[0], f.v[1]};
#pragma unroll
  for (int p = 1; p < 5; ++p) {
    r.lo = pair == p ? f.v[2 * p] : r.lo;
    r.hi = pair == p ? f.v[2 * p + 1] : r.hi;
  }
  return r;
}

__device__ __forceinline__ Sp sp_load(const int32_t* __restrict__ p,
                                      const DecLane& d) {
  return Sp{__ldg(p + 2 * d.pair), __ldg(p + 2 * d.pair + 1)};
}

// Columns (lo, hi) of this lane's pair -> carried: the low one into
// [-2^25, 2^25), its carry into the high one, that into [-2^24, 2^24) with
// its carry to the next pair's owner; the carry from the pair below (times
// 19 into pair 0) into the low one, rounded once more into the high one.
__device__ __forceinline__ Sp sp_carry(int64_t lo, int64_t hi,
                                       const DecLane& d) {
  const int64_t c0 = (lo + (int64_t{1} << 25)) >> 26;
  lo -= c0 * (int64_t{1} << 26);
  hi += c0;
  const int64_t c1 = (hi + (int64_t{1} << 24)) >> 25;
  hi -= c1 * (int64_t{1} << 25);
  lo += grp_shfl64(c1, d.src[1]) * d.carry19;  // from pair (pair - 1) mod 5
  const int64_t c = (lo + (int64_t{1} << 25)) >> 26;
  return Sp{static_cast<int32_t>(lo - c * (int64_t{1} << 26)),
            static_cast<int32_t>(hi + c)};
}

__device__ __forceinline__ Sp sp_add(const Sp& f, const Sp& g,
                                     const DecLane& d) {
  return sp_carry(int64_t{f.lo} + g.lo, int64_t{f.hi} + g.hi, d);
}

__device__ __forceinline__ Sp sp_sub(const Sp& f, const Sp& g,
                                     const DecLane& d) {
  return sp_carry(int64_t{f.lo} - g.lo, int64_t{f.hi} - g.hi, d);
}

// f g, with f's ten limbs fl in every lane.
__device__ __forceinline__ Sp sp_product(const Fe& fl, const Sp& g,
                                         const DecLane& d) {
  const int32_t g19lo = 19 * g.lo, g19hi = 19 * g.hi;
  int32_t rl[5], rh[5];  // g's pair (pair - q) mod 5, times its factor
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    rl[q] = grp_shfl(d.send19[q] ? g19lo : g.lo, d.src[q]);
    rh[q] = grp_shfl(d.send19[q] ? g19hi : g.hi, d.src[q]);
  }
  const int32_t rh5 = g19hi;  // pair (pair - 5) mod 5 = pair: it wraps
  // Two accumulators a column: even limbs of f, odd limbs of f.
  int64_t e0 = 0, o0 = 0, e1 = 0, o1 = 0;
#pragma unroll
  for (int p = 0; p < 5; ++p) {
    const int32_t fe = fl.v[2 * p], fo = fl.v[2 * p + 1];
    e0 += static_cast<int64_t>(fe) * rl[p];
    o0 += static_cast<int64_t>(2 * fo) * (p < 4 ? rh[p + 1] : rh5);
    e1 += static_cast<int64_t>(fe) * rh[p];
    o1 += static_cast<int64_t>(fo) * rl[p];
  }
  return sp_carry(e0 + o0, e1 + o1, d);
}

__device__ __forceinline__ Sp sp_mul(const Sp& f, const Sp& g,
                                     const DecLane& d) {
  return sp_product(sp_gather(f, d), g, d);
}

__device__ __forceinline__ Sp sp_sq(const Sp& f, const DecLane& d) {
  return sp_product(sp_gather(f, d), f, d);
}

__device__ Sp sp_sqn(Sp x, int n, const DecLane& d) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) x = sp_sq(x, d);
  return x;
}

// z^((p-5)/8) = z^(2^252 - 3): ref10's chain of squarings and 11 products.
__device__ Sp sp_pow22523(const Sp& z, const DecLane& d) {
  Sp t0 = sp_sq(z, d);
  Sp t1 = sp_mul(z, sp_sqn(t0, 2, d), d);
  t0 = sp_mul(t0, t1, d);
  t0 = sp_mul(t1, sp_sq(t0, d), d);        // 2^5 - 1
  t0 = sp_mul(sp_sqn(t0, 5, d), t0, d);    // 2^10 - 1
  t1 = sp_mul(sp_sqn(t0, 10, d), t0, d);   // 2^20 - 1
  t1 = sp_mul(sp_sqn(t1, 20, d), t1, d);   // 2^40 - 1
  t0 = sp_mul(sp_sqn(t1, 10, d), t0, d);   // 2^50 - 1
  t1 = sp_mul(sp_sqn(t0, 50, d), t0, d);   // 2^100 - 1
  t1 = sp_mul(sp_sqn(t1, 100, d), t1, d);  // 2^200 - 1
  t0 = sp_mul(sp_sqn(t1, 50, d), t0, d);   // 2^250 - 1
  return sp_mul(sp_sqn(t0, 2, d), z, d);   // 2^252 - 3
}

__device__ __forceinline__ void store_fe(int32_t* p, const Fe& f) {
#pragma unroll
  for (int i = 0; i < 10; ++i) p[i] = f.v[i];
}

// enc: (rows, 8) little-endian words of 32-byte encodings.  xy: (rows, 2,
// 10) canonical affine (x, y).  ok: (rows,) 1 where the encoding is a point.
// kDecGroup lanes a row, kDecGroupsPerWarp rows a warp; the group of a row
// past rows repeats row rows - 1 (every lane of the warp takes part in
// every shuffle) and writes nothing.
__global__ void __launch_bounds__(kDecThreads)
mirbft_ed25519_decompress_kernel(const uint4* __restrict__ enc,
                                 int32_t* __restrict__ xy,
                                 int32_t* __restrict__ ok, int rows,
                                 const int32_t* __restrict__ consts) {
  const int warp_lane = threadIdx.x & 31;
  const DecLane d = dec_lane(warp_lane);
  const int group =
      (blockIdx.x * kDecThreads + threadIdx.x) / 32 * kDecGroupsPerWarp + d.group;
  const int row = group < rows ? group : rows - 1;
  const uint4 lo = enc[2 * static_cast<size_t>(row)];
  const uint4 hi = enc[2 * static_cast<size_t>(row) + 1];
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const Fe y_all = fe_frombytes(w);
  const int32_t sign = static_cast<int32_t>(w[7] >> 31);

  const Sp y = sp_split(y_all, d.pair);
  const Sp one{d.pair == 0 ? 1 : 0, 0};
  const Sp yy = sp_sq(y, d);
  const Sp u = sp_sub(yy, one, d);  // y^2 - 1
  const Sp v = sp_add(sp_mul(sp_load(consts + 10 * kConstD, d), yy, d), one, d);
  const Sp v3 = sp_mul(sp_sq(v, d), v, d);
  const Sp v7 = sp_mul(sp_sq(v3, d), v, d);
  const Sp xs = sp_mul(sp_mul(u, v3, d), sp_pow22523(sp_mul(u, v7, d), d), d);
  const Sp vxx = sp_mul(v, sp_sq(xs, d), d);
  const Sp xf = sp_mul(xs, sp_load(consts + 10 * kConstSqrtM1, d), d);

  // The tail, the same in every lane of the group.
  const Fe u_all = sp_gather(u, d);
  const Fe vxx_all = sp_gather(vxx, d);
  const bool is_root = fe_eq(vxx_all, u_all);
  const bool is_neg_root = fe_eq(vxx_all, fe_sub(fe_zero(), u_all));
  const Fe x_fixed = sp_gather(xf, d);
  Fe x = fe_canonical(fe_select(is_neg_root, x_fixed, sp_gather(xs, d)));
  int32_t any = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) any |= x.v[i];
  const bool good = (is_root || is_neg_root) && !(any == 0 && sign == 1);
  // Parity fix-up: -x when the canonical parity differs from the sign bit.
  const Fe x_neg = fe_canonical(fe_sub(fe_zero(), x));
  x = fe_select((x.v[0] & 1) != sign, x_neg, x);

  if (warp_lane == d.base && group < rows) {
    int32_t* out = xy + 20 * static_cast<size_t>(row);
    store_fe(out, x);
    store_fe(out + 10, fe_canonical(y_all));
    ok[row] = good ? 1 : 0;
  }
}

// -- the quad ladder ----------------------------------------------------------
//
// In each function below, lane is the thread's place in its quad (0-3) and
// v its coordinate of an extended point: X, Y, Z, T for lanes 0-3.  Every
// lane of the warp calls every function (the shuffles need the whole warp).

// Coordinate src of this quad's f.
__device__ __forceinline__ Fe fe_shfl(const Fe& f, int src) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 10; ++i) r.v[i] = __shfl_sync(0xffffffffu, f.v[i], src, 4);
  return r;
}

// Lane 0-3's choice of four elements, limb by limb (selects: a choice
// between whole structs can put them in local memory).
__device__ __forceinline__ Fe fe_pick(int lane, const Fe& a, const Fe& b,
                                      const Fe& c, const Fe& d) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const int32_t lo = (lane & 1) ? b.v[i] : a.v[i];
    const int32_t hi = (lane & 1) ? d.v[i] : c.v[i];
    r.v[i] = (lane & 2) ? hi : lo;
  }
  return r;
}

// The first product stage of an addition, and the conversion of a point to
// cached form: lane 0 (Y - X) q, lane 1 (Y + X) q, lane 2 Z q, lane 3 T q,
// where q is this lane's coordinate of the other operand.  f is 2-term,
// q at most 2-term (a cached coordinate).
__device__ __forceinline__ Fe stage_a(const Fe& v, const Fe& q, int lane) {
  const Fe other = fe_shfl(v, lane ^ 1);
  return fe_mul(fe_pick(lane, fe_sub_nc(other, v), fe_add_nc(other, v), v, v),
                q);
}

// P + Q (add-2008-hwcd-3, a = -1, complete): v is this lane's coordinate of
// P (extended, carried), q of Q in cached form (Y - X, Y + X, 2Z, 2d T).
// Stage 1: A = (Y1 - X1)(Y2 - X2), B = (Y1 + X1)(Y2 + X2), D = Z1 2Z2,
// C = T1 2dT2 in lanes 0-3.  Stage 2: E = B - A, F = D - C, G = D + C,
// H = B + A (2-term), and X3 = E F, Y3 = G H, Z3 = F G, T3 = E H.
__device__ Fe point_add(const Fe& v, const Fe& q, int lane) {
  const Fe p = stage_a(v, q, lane);  // A, B, D, C
  const Fe partner = fe_shfl(p, lane ^ 1);
  const bool even = (lane & 1) == 0;
  const Fe lo = fe_select(even, p, partner);  // A in lanes 0, 1; D in 2, 3
  const Fe hi = fe_select(even, partner, p);  // B in lanes 0, 1; C in 2, 3
  const bool ab = lane < 2;
  const Fe u = fe_select(ab, fe_sub_nc(hi, lo), fe_sub_nc(lo, hi));  // E, F
  const Fe w = fe_add_nc(lo, hi);                                     // H, G
  const Fe u2 = fe_shfl(u, lane ^ 2);
  const Fe w2 = fe_shfl(w, lane ^ 2);
  const Fe e = fe_select(ab, u, u2), f = fe_select(ab, u2, u);
  const Fe h = fe_select(ab, w, w2), g = fe_select(ab, w2, w);
  return fe_mul(fe_pick(lane, e, g, f, e), fe_pick(lane, f, h, g, h));
}

// 2P (dbl-2008-hwcd, a = -1): T1 is not read.  Stage 1: A = X^2, B = Y^2,
// Z^2, S = (X + Y)^2 (X + Y 2-term).  Stage 2: E = S - A - B (3-term),
// G = B - A, H = -A - B (2-term), F = G - 2 Z^2 (4-term), and X3 = F E,
// Y3 = G H, Z3 = F G, T3 = E H, the many-term operand first (on f).
__device__ Fe point_double(const Fe& v, int lane) {
  const Fe x = fe_shfl(v, 0);
  const Fe y = fe_shfl(v, 1);
  const Fe s = fe_sq(fe_select(lane == 3, fe_add_nc(x, y), v));
  const Fe a = fe_shfl(s, 0), b = fe_shfl(s, 1);
  const Fe zz = fe_shfl(s, 2), ss = fe_shfl(s, 3);
  const Fe e = fe_sub_nc(fe_sub_nc(ss, a), b);
  const Fe g = fe_sub_nc(b, a);
  const Fe f = fe_sub_nc(fe_sub_nc(g, zz), zz);
  const Fe h = fe_sub_nc(fe_sub_nc(fe_zero(), a), b);
  return fe_mul(fe_pick(lane, f, g, f, e), fe_pick(lane, e, h, g, h));
}

// 4-bit window t (0 = bits 255..252) of a scalar's 8 little-endian words.
__device__ __forceinline__ int window(const uint32_t* __restrict__ words,
                                      int t) {
  const int nib = 63 - t;
  return static_cast<int>((__ldg(words + (nib >> 3)) >> (4 * (nib & 7))) & 15);
}

// The [j]B table in cached form, (y - x, y + x, 2, 2d x y), filled by the
// whole block, first thing in either ladder kernel.
__device__ __forceinline__ void fill_b_table(
    int32_t* __restrict__ smem, const int32_t* __restrict__ consts) {
  int32_t* b_table = smem + kATableInts;  // [16][4][10]
  for (int i = threadIdx.x; i < kBTableInts; i += kLadderThreads) {
    const int j = i / 40, c = (i / 10) % 4, l = i % 10;
    b_table[i] = c == 2 ? (l == 0 ? 2 : 0)
                        : consts[10 * (kConstNiels + 3 * j + (c == 3 ? 2 : c)) + l];
  }
  __syncthreads();
}

// One signature's ladder, every thread of the block calling it after
// fill_b_table: builds this quad's [j](-A) column, runs the 64 windows and
// compares against R.  neg_a: this lane's coordinate c of -A (X, Y, Z, T
// for lanes 0-3), any extended representation, each limb either carried or
// canonical (in [0, 2^w)); r_xy: the row's affine R (x, then y), canonical;
// s, k: the row's 8 little-endian words of S and of k.  Writes out[quad],
// 1 where [S]B + [k](-A) == R projectively, Z != 0 and valid, when
// quad < n.
//
// Canonical limbs are under 2^w = 2^(w-1) * 2 < 2 U_w: 2-term.  -A reaches
// a product only through stage_a, both in its conversion to cached form and
// in the first table addition (p = -A): f there is Y - X or Y + X (4-term)
// or Z, T (2-term), within the 4-term f of fe_mul, and g a carried cached
// coordinate or a constant.  Everything after is a product's output,
// carried, as in the decompressed route; R is canonical on f against a
// carried Z, as there.
__device__ __forceinline__ void ladder_quad(
    int32_t* __restrict__ smem, const Fe& neg_a,
    const int32_t* __restrict__ r_xy, const uint32_t* __restrict__ s,
    const uint32_t* __restrict__ k, bool valid, int quad, int n,
    int32_t* __restrict__ out, const int32_t* __restrict__ consts) {
  int32_t* a_table = smem;  // [16][10][kLadderThreads]
  const int32_t* b_table = smem + kATableInts;  // [16][4][10]
  const int lane = threadIdx.x & 3;
  const Fe one = fe_one();
  const Fe two = fe_small(2);
  // Lane c's multiplier taking an extended point to cached form: 1, 1, 2, 2d.
  const Fe to_cached =
      fe_pick(lane, one, one, two, fe_load(consts + 10 * kConstD2));

  int32_t* column = a_table + threadIdx.x;
  auto store = [&](int j, const Fe& c) {
#pragma unroll
    for (int l = 0; l < 10; ++l) column[(10 * j + l) * kLadderThreads] = c.v[l];
  };
  store(0, fe_pick(lane, one, one, two, fe_zero()));  // the identity
  const Fe neg_a_cached = stage_a(neg_a, to_cached, lane);
  store(1, neg_a_cached);
  Fe p = neg_a;
#pragma unroll 1
  for (int j = 2; j < 16; ++j) {
    p = point_add(p, neg_a_cached, lane);
    store(j, stage_a(p, to_cached, lane));
  }

  Fe acc = fe_pick(lane, fe_zero(), one, one, fe_zero());  // (0, 1, 1, 0)
#pragma unroll 1
  for (int t = 0; t < 64; ++t) {
#pragma unroll 1
    for (int i = 0; i < 4; ++i) acc = point_double(acc, lane);
    acc = point_add(acc, fe_load(b_table + 40 * window(s, t) + 10 * lane), lane);
    const int32_t* entry = column + 10 * window(k, t) * kLadderThreads;
    Fe q;
#pragma unroll
    for (int l = 0; l < 10; ++l) q.v[l] = entry[l * kLadderThreads];
    acc = point_add(acc, q, lane);
  }

  // X == x_R Z (lane 0) and Y == y_R Z (lanes 1-3), and Z != 0.
  const Fe x = fe_shfl(acc, 0);
  const Fe y = fe_shfl(acc, 1);
  const Fe z = fe_shfl(acc, 2);
  const bool eq = fe_eq(fe_select(lane == 0, x, y),
                        fe_mul(fe_load(r_xy + (lane == 0 ? 0 : 10)), z));
  const int eq_x = __shfl_sync(0xffffffffu, eq ? 1 : 0, 0, 4);
  const int eq_y = __shfl_sync(0xffffffffu, eq ? 1 : 0, 1, 4);
  const bool good = eq_x && eq_y && !fe_is_zero(z) && valid;
  if (lane == 0 && quad < n) out[quad] = good ? 1 : 0;
}

// xy: (2n, 2, 10) affine points from the decompress kernel (A rows, then R
// rows); ok: (2n,).  s_words, k_words: (n, 8) little-endian words of S and
// k.  out: (n,) 1 where [S]B + [k](-A) == R projectively, Z != 0 and both
// points decompressed.  Four lanes a row; dynamic shared memory holds the
// [j](-A) table (a column per lane) and the [j]B table.
__global__ void __launch_bounds__(kLadderThreads)
mirbft_ed25519_ladder_kernel(const int32_t* __restrict__ xy,
                             const int32_t* __restrict__ okf,
                             const uint32_t* __restrict__ s_words,
                             const uint32_t* __restrict__ k_words,
                             int32_t* __restrict__ out, int n,
                             const int32_t* __restrict__ consts) {
  extern __shared__ __align__(16) int32_t ladder_smem[];
  fill_b_table(ladder_smem, consts);
  const int lane = threadIdx.x & 3;
  const int quad = (blockIdx.x * kLadderThreads + threadIdx.x) >> 2;
  const int row = quad < n ? quad : n - 1;  // a quad past n repeats row n - 1
  const int32_t* a_xy = xy + 20 * static_cast<size_t>(row);
  const bool valid = okf[row] != 0 && okf[n + row] != 0;

  // -A = (-x, y, 1, -x y), one product stage (lane 3's; the others times 1).
  const Fe one = fe_one();
  const Fe ax = fe_load(a_xy);
  const Fe ay = fe_load(a_xy + 10);
  const Fe nx = fe_sub_nc(fe_zero(), ax);
  const Fe neg_a =
      fe_mul(fe_pick(lane, nx, ay, one, nx), fe_pick(lane, one, one, one, ay));
  ladder_quad(ladder_smem, neg_a, xy + 20 * (static_cast<size_t>(n) + row),
              s_words + 8 * static_cast<size_t>(row),
              k_words + 8 * static_cast<size_t>(row), valid, quad, n, out,
              consts);
}

// neg_a: (n, 4, 10) -A in extended coordinates (X, Y, Z, T; any Z != 0),
// canonical limbs, from the host's decompression.  r_xy: (n, 2, 10) affine
// R, canonical.  s_words, k_words: (n, 8).  out: (n,) 1 where [S]B +
// [k](-A) == R projectively and Z != 0: the host has rejected every row
// whose points do not decompress, so every row in range is valid.  Lane c
// loads coordinate c of -A itself: no negation product stage.
__global__ void __launch_bounds__(kLadderThreads)
mirbft_ed25519_ladder_extended_kernel(const int32_t* __restrict__ neg_a,
                                      const int32_t* __restrict__ r_xy,
                                      const uint32_t* __restrict__ s_words,
                                      const uint32_t* __restrict__ k_words,
                                      int32_t* __restrict__ out, int n,
                                      const int32_t* __restrict__ consts) {
  extern __shared__ __align__(16) int32_t ladder_smem[];
  fill_b_table(ladder_smem, consts);
  const int lane = threadIdx.x & 3;
  const int quad = (blockIdx.x * kLadderThreads + threadIdx.x) >> 2;
  const int row = quad < n ? quad : n - 1;  // a quad past n repeats row n - 1
  const int32_t* coordinate = neg_a + 40 * static_cast<size_t>(row) + 10 * lane;
  ladder_quad(ladder_smem, fe_load(coordinate),
              r_xy + 20 * static_cast<size_t>(row),
              s_words + 8 * static_cast<size_t>(row),
              k_words + 8 * static_cast<size_t>(row), true, quad, n, out,
              consts);
}

int grid_for(long long threads, int block) {
  return static_cast<int>((threads + block - 1) / block);
}

}  // namespace

// Plain C interface, bound with ctypes.  Pointers are device pointers,
// contiguous, enc 16-byte aligned (the Python wrapper checks).  Each
// launches on the given stream, does not synchronise, and returns the
// first CUDA error (0 on success).
extern "C" int mirbft_ed25519_decompress(const void* enc, void* xy, void* ok,
                                         int rows, const void* consts,
                                         void* stream) {
  if (rows <= 0) return 0;
  mirbft_ed25519_decompress_kernel<<<decompress_grid(rows), kDecThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(enc), static_cast<int32_t*>(xy),
      static_cast<int32_t*>(ok), rows, static_cast<const int32_t*>(consts));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mirbft_ed25519_ladder(const void* xy, const void* ok,
                                     const void* s_words, const void* k_words,
                                     void* out, int n, const void* consts,
                                     void* stream) {
  if (n <= 0) return 0;
  // Above 48 KB a block takes dynamic shared memory only when allowed to;
  // set once (a function-local static is initialised once, thread-safely).
  static const cudaError_t allowed = cudaFuncSetAttribute(
      mirbft_ed25519_ladder_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kLadderSmemBytes);
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  mirbft_ed25519_ladder_kernel<<<grid_for(4LL * n, kLadderThreads),
                                 kLadderThreads, kLadderSmemBytes,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(xy), static_cast<const int32_t*>(ok),
      static_cast<const uint32_t*>(s_words),
      static_cast<const uint32_t*>(k_words), static_cast<int32_t*>(out), n,
      static_cast<const int32_t*>(consts));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mirbft_ed25519_ladder_extended(const void* neg_a,
                                              const void* r_xy,
                                              const void* s_words,
                                              const void* k_words, void* out,
                                              int n, const void* consts,
                                              void* stream) {
  if (n <= 0) return 0;
  static const cudaError_t allowed = cudaFuncSetAttribute(
      mirbft_ed25519_ladder_extended_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kLadderSmemBytes);
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  mirbft_ed25519_ladder_extended_kernel<<<grid_for(4LL * n, kLadderThreads),
                                          kLadderThreads, kLadderSmemBytes,
                                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(neg_a), static_cast<const int32_t*>(r_xy),
      static_cast<const uint32_t*>(s_words),
      static_cast<const uint32_t*>(k_words), static_cast<int32_t*>(out), n,
      static_cast<const int32_t*>(consts));
  return static_cast<int>(cudaGetLastError());
}

// Either ladder's dynamic shared memory a block, in bytes.
extern "C" int mirbft_ed25519_ladder_smem_bytes() { return kLadderSmemBytes; }

extern "C" const char* mirbft_ed25519_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
