// Batched BLS12-381 G1 aggregation for sm_90a: the masked sum of each
// quorum certificate's signature points over its voters.
//
// It computes what the JAX package's XLA program computes
// (mirbft_tpu/ops/bls_g1.py: _aggregate, a lax.scan of complete projective
// additions over the voter axis, vmapped across certificates): for each
// certificate b, acc = identity, then for voter v = 0, 1, ..., width - 1 in
// order, acc = acc + (mask[b][v] ? (X, Y, Z)[b][v] : identity), every step
// one complete addition of Renes, Costello and Batina (2016, Algorithm 7,
// a = 0, b3 = 3 * 4 = 12).  Every field element is kept fully reduced in
// [0, p), so any exact sequence of field operations that gives the same
// element gives the same limbs: the same formula, step for step in voter
// order, gives the same (X : Y : Z) as the JAX program and the plain
// version, bit for bit once both are reduced.  A masked voter still adds
// the identity through the complete formula (it scales (X : Y : Z)), and
// the voters are never regrouped as a tree: either would keep the affine
// point and change (X : Y : Z).  A certificate whose voters are all masked
// comes out as the identity (0 : 1 : 0), Z = 0.
//
// Field: GF(p), p the 381-bit BLS12-381 prime, as 12 little-endian 32-bit
// limbs in Montgomery form with R = 2^384 (the JAX package's 30 limbs of
// 13 bits, R = 2^390, exist because the TPU has no wide multiply).  The
// tensors hold the limbs as int32 bit patterns: inputs (batch, width, 12)
// for X, Y and Z and (batch, width) for the mask, output (batch, 3, 12).
//
// What bounds it on this card: a certificate is a chain of width additions
// (each reads the sum so far), and rung 4 launches 4 certificates, so the
// card is nearly empty and the time is the chain's latency.  One thread a
// certificate (the first port) ran an addition's 12 products one after
// another, each 288 multiply-adds waiting on one 64-bit carry: 6.3 ms at
// (4, 128).  The design here, a warp a certificate:
// - An addition's 12 products fall into two layers of six independent
//   ones (t0, t1, t2 and the three products of sums; then the six
//   products of the output).  Lanes 4k .. 4k + 3 compute product k of each
//   layer, so the six run at once.  Every lane keeps the whole sum so far
//   and the voter's point (the next voter's is read during the current
//   addition); after a layer each product is broadcast to the warp with
//   __shfl_sync.
// - A product is split over its four lanes, three limbs a lane, in
//   Montgomery CIOS form: the running sum's words are 96-bit columns, so
//   a word of the multiplier or of the reduction is three independent PTX
//   carry chains of three (mad.lo.cc / madc.hi.cc / addc) on each lane,
//   the reduction's 12 multipliers m come one after another from lane 0
//   and are broadcast with __shfl_sync, the shift moves one column a lane
//   down with a shuffle, and the carries are settled once at the end.
// - Between the layers the sums are shared too: the lanes of product k
//   compute one of t3, t4, b3 x3, b3 t2 and 3 t0 (the longest, b3 x3, is
//   a difference and four doublings), broadcast it, and every lane forms
//   z3 and t1.
// - A select by lane is a bitwise select on a mask, not a branch or a
//   predicate: the carry chains keep their carries in predicates, and
//   selects that hold them too make them spill (measured slower with its
//   selects as conditional expressions: PERF.md §6).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLimbs = 12;
constexpr int kBlsThreads = 32;  // a block is a warp, a certificate
constexpr int kProductLanes = 4;  // lanes a product, 3 limbs each

// p, little-endian 32-bit limbs.
__host__ __device__ constexpr uint32_t kp(int i) {
  return i == 0 ? 0xffffaaabu : i == 1 ? 0xb9feffffu : i == 2 ? 0xb153ffffu
       : i == 3 ? 0x1eabfffeu : i == 4 ? 0xf6b0f624u : i == 5 ? 0x6730d2a0u
       : i == 6 ? 0xf38512bfu : i == 7 ? 0x64774b84u : i == 8 ? 0x434bacd7u
       : i == 9 ? 0x4b1ba7b6u : i == 10 ? 0x397fe69au : 0x1a0111eau;
}

// R mod p = 2^384 mod p: one in Montgomery form.
__host__ __device__ constexpr uint32_t kone(int i) {
  return i == 0 ? 0x0002fffdu : i == 1 ? 0x76090000u : i == 2 ? 0xc40c0002u
       : i == 3 ? 0xebf4000bu : i == 4 ? 0x53c758bau : i == 5 ? 0x5f489857u
       : i == 6 ? 0x70525745u : i == 7 ? 0x77ce5853u : i == 8 ? 0xa256ec6du
       : i == 9 ? 0x5c071a97u : i == 10 ? 0xfa80e493u : 0x15f65ec3u;
}

// -p^-1 mod 2^32.
constexpr uint32_t kN0 = 0xfffcfffdu;

struct Fp {
  uint32_t v[kLimbs];
};

// -- PTX carry chains: one asm statement each -------------------------------

// c += x y, c a 96-bit column (c[0] + 2^32 c[1] + 2^64 c[2]).
__device__ __forceinline__ void col_mac(uint32_t* c, uint32_t x, uint32_t y) {
  asm("mad.lo.cc.u32 %0, %3, %4, %0;\n\t"
      "madc.hi.cc.u32 %1, %3, %4, %1;\n\t"
      "addc.u32 %2, %2, 0;"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2])
      : "r"(x), "r"(y));
}

// c += lo + 2^32 hi, c a 96-bit column.
__device__ __forceinline__ void col_add(uint32_t* c, uint32_t lo,
                                        uint32_t hi) {
  asm("add.cc.u32 %0, %0, %3;\n\t"
      "addc.cc.u32 %1, %1, %4;\n\t"
      "addc.u32 %2, %2, 0;"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2])
      : "r"(lo), "r"(hi));
}

// w[0..2] += lo + 2^32 hi; returns the carry out of w[2] (0 or 1).
__device__ __forceinline__ uint32_t add3(uint32_t* w, uint32_t lo,
                                         uint32_t hi) {
  uint32_t carry = 0;
  asm("add.cc.u32 %0, %0, %4;\n\t"
      "addc.cc.u32 %1, %1, %5;\n\t"
      "addc.cc.u32 %2, %2, 0;\n\t"
      "addc.u32 %3, %3, 0;"
      : "+r"(w[0]), "+r"(w[1]), "+r"(w[2]), "+r"(carry)
      : "r"(lo), "r"(hi));
  return carry;
}

// w[0..2] -= b[0..2]; returns the borrow out of w[2] (0 or 1).
__device__ __forceinline__ uint32_t sub3(uint32_t* w, const uint32_t* b) {
  uint32_t borrow = 0;
  asm("sub.cc.u32 %0, %0, %4;\n\t"
      "subc.cc.u32 %1, %1, %5;\n\t"
      "subc.cc.u32 %2, %2, %6;\n\t"
      "subc.u32 %3, %3, %3;"
      : "+r"(w[0]), "+r"(w[1]), "+r"(w[2]), "+r"(borrow)
      : "r"(b[0]), "r"(b[1]), "r"(b[2]));
  return borrow & 1;
}

// r += b over 12 words, the carry out of the top word dropped (mod 2^384).
__device__ __forceinline__ void add12(uint32_t* r, const uint32_t* b) {
  asm("add.cc.u32 %0, %0, %12;\n\t"
      "addc.cc.u32 %1, %1, %13;\n\t"
      "addc.cc.u32 %2, %2, %14;\n\t"
      "addc.cc.u32 %3, %3, %15;\n\t"
      "addc.cc.u32 %4, %4, %16;\n\t"
      "addc.cc.u32 %5, %5, %17;\n\t"
      "addc.cc.u32 %6, %6, %18;\n\t"
      "addc.cc.u32 %7, %7, %19;\n\t"
      "addc.cc.u32 %8, %8, %20;\n\t"
      "addc.cc.u32 %9, %9, %21;\n\t"
      "addc.cc.u32 %10, %10, %22;\n\t"
      "addc.u32 %11, %11, %23;"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]),
        "+r"(r[5]), "+r"(r[6]), "+r"(r[7]), "+r"(r[8]), "+r"(r[9]),
        "+r"(r[10]), "+r"(r[11])
      : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
        "r"(b[6]), "r"(b[7]), "r"(b[8]), "r"(b[9]), "r"(b[10]),
        "r"(b[11]));
}

// r -= b over 12 words, mod 2^384; returns 0xffffffff on a borrow out of
// the top word, else 0.
__device__ __forceinline__ uint32_t sub12(uint32_t* r, const uint32_t* b) {
  uint32_t borrow = 0;
  asm("sub.cc.u32 %0, %0, %13;\n\t"
      "subc.cc.u32 %1, %1, %14;\n\t"
      "subc.cc.u32 %2, %2, %15;\n\t"
      "subc.cc.u32 %3, %3, %16;\n\t"
      "subc.cc.u32 %4, %4, %17;\n\t"
      "subc.cc.u32 %5, %5, %18;\n\t"
      "subc.cc.u32 %6, %6, %19;\n\t"
      "subc.cc.u32 %7, %7, %20;\n\t"
      "subc.cc.u32 %8, %8, %21;\n\t"
      "subc.cc.u32 %9, %9, %22;\n\t"
      "subc.cc.u32 %10, %10, %23;\n\t"
      "subc.cc.u32 %11, %11, %24;\n\t"
      "subc.u32 %12, %12, %12;"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]),
        "+r"(r[5]), "+r"(r[6]), "+r"(r[7]), "+r"(r[8]), "+r"(r[9]),
        "+r"(r[10]), "+r"(r[11]), "+r"(borrow)
      : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
        "r"(b[6]), "r"(b[7]), "r"(b[8]), "r"(b[9]), "r"(b[10]),
        "r"(b[11]));
  return borrow;
}

// All ones for true, 0 for false, in a register the compiler cannot see
// through: selects on it stay bitwise (LOP3) and take no predicate
// register, which the carry chains need (a chain's carries live in
// predicates, and a select that holds one makes them spill).
__device__ __forceinline__ uint32_t lane_mask(bool c) {
  uint32_t m;
  asm("mov.b32 %0, %1;" : "=r"(m) : "r"(c ? 0xffffffffu : 0u));
  return m;
}

// -- field operations, every element in [0, p) ------------------------------

// a where mask is all ones, b where it is 0.
__device__ __forceinline__ uint32_t select(uint32_t mask, uint32_t a,
                                           uint32_t b) {
  return (a & mask) | (b & ~mask);
}

// r = t - p if t (below 2p) >= p, else t.
__device__ __forceinline__ void reduce_once(uint32_t* t) {
  uint32_t p[kLimbs], d[kLimbs];
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) {
    p[j] = kp(j);
    d[j] = t[j];
  }
  const uint32_t borrow = sub12(d, p);
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) t[j] = select(borrow, t[j], d[j]);
}

// A product's share on one lane: lane q (0 <= q < kProductLanes) of the
// product's lanes owns words 3q, 3q + 1, 3q + 2.
struct Fp3 {
  uint32_t w[3];
};

// a b R^-1 mod p (CIOS) over the product's four lanes; a, b in [0, p), in
// every lane; returns this lane's three words of the result in [0, p).
// The running sum's 12 words are 96-bit columns, three a lane, so a word
// of the multiplier or of the reduction is three independent chains of
// three a lane, and no carry crosses a lane inside the loop: the column a
// round retires (lane 0's lowest) hands its high 64 bits to the next
// column, and the shift moves each lane's lowest column to the lane below
// with one shuffle a word.  The reduction's multiplier m comes from lane
// 0's lowest column and is broadcast.  The carries are settled once at the
// end: each lane rounds its three columns, takes the 64-bit carry of the
// lane below, and the one-bit carries that remain ripple through the four
// lanes at once by the adder trick on a ballot (generate g, propagate p:
// the carry into each lane is ((g | p) + g) ^ p); the comparison with p
// resolves its borrows the same way.
__device__ __forceinline__ Fp3 fp_mul_split(const Fp& a, const Fp& b, int q) {
  constexpr unsigned kAll = 0xffffffffu;
  const uint32_t q0 = lane_mask(q == 0), q1 = lane_mask(q == 1),
                 q2 = lane_mask(q == 2), q3 = lane_mask(q == 3);
  uint32_t am[3], pm[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    am[j] = select(q0, a.v[j], select(q1, a.v[3 + j],
                                      select(q2, a.v[6 + j], a.v[9 + j])));
    pm[j] = select(q0, kp(j), select(q1, kp(3 + j),
                                     select(q2, kp(6 + j), kp(9 + j))));
  }
  uint32_t col[3][3];
#pragma unroll
  for (int j = 0; j < 3; ++j) col[j][0] = col[j][1] = col[j][2] = 0;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) col_mac(col[j], am[j], b.v[i]);
    const uint32_t m =
        __shfl_sync(kAll, col[0][0] * kN0, 0, kProductLanes);
#pragma unroll
    for (int j = 0; j < 3; ++j) col_mac(col[j], pm[j], m);
    // Lane 0's lowest column is now 0 mod 2^32: it retires, and its high
    // 64 bits join the next column.
    const uint32_t lo = col[0][1] & q0, hi = col[0][2] & q0;
    uint32_t in[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      in[c] = __shfl_down_sync(kAll, col[0][c], 1, kProductLanes) & ~q3;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      col[0][c] = col[1][c];
      col[1][c] = col[2][c];
      col[2][c] = in[c];
    }
    col_add(col[0], lo, hi);
  }
  // Round this lane's columns into three words and a 64-bit carry out.
  uint32_t w[3];
  col_add(col[1], col[0][1], col[0][2]);
  col_add(col[2], col[1][1], col[1][2]);
  w[0] = col[0][0];
  w[1] = col[1][0];
  w[2] = col[2][0];
  // The lane below's carry; the top lane's carry and overflow lie past
  // 2^384 and are 0 in all (the result is below 2p < 2^384).
  const uint32_t in_lo =
      __shfl_up_sync(kAll, col[2][1], 1, kProductLanes) & ~q0;
  const uint32_t in_hi =
      __shfl_up_sync(kAll, col[2][2], 1, kProductLanes) & ~q0;
  const uint32_t g = add3(w, in_lo, in_hi);
  // This product's four bits of a ballot.
  const int base = threadIdx.x & 31 & ~(kProductLanes - 1);
  constexpr uint32_t kMine = (1u << kProductLanes) - 1;
  const uint32_t gen = (__ballot_sync(kAll, g != 0) >> base) & kMine;
  const uint32_t prop =
      (__ballot_sync(kAll, (w[0] & w[1] & w[2]) == 0xffffffffu) >> base) &
      kMine;
  add3(w, ((((gen | prop) + gen) ^ prop) >> q) & 1, 0);
  // Subtract p unless the result is below it: the borrows resolve as the
  // carries did (a lane's difference of 0 propagates a borrow).
  uint32_t d[3] = {w[0], w[1], w[2]};
  const uint32_t bo = sub3(d, pm);
  const uint32_t bgen = (__ballot_sync(kAll, bo != 0) >> base) & kMine;
  const uint32_t bprop =
      (__ballot_sync(kAll, (d[0] | d[1] | d[2]) == 0) >> base) & kMine;
  const uint32_t borrows = (bgen | bprop) + bgen;
  const uint32_t one[3] = {((borrows ^ bprop) >> q) & 1, 0, 0};
  sub3(d, one);
  const uint32_t below = lane_mask((borrows >> kProductLanes) & 1);
  Fp3 r;
#pragma unroll
  for (int j = 0; j < 3; ++j) r.w[j] = select(below, w[j], d[j]);
  return r;
}

__device__ __forceinline__ Fp fp_add(const Fp& a, const Fp& b) {
  Fp r = a;
  add12(r.v, b.v);  // a + b < 2p < 2^384
  reduce_once(r.v);
  return r;
}

__device__ __forceinline__ Fp fp_sub(const Fp& a, const Fp& b) {
  Fp r = a;
  // On a borrow, a - b wrapped to a - b + 2^384: adding p back (mod
  // 2^384) lands on a - b + p in [0, p).
  const uint32_t keep = sub12(r.v, b.v);
  uint32_t p[kLimbs];
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) p[j] = kp(j) & keep;
  add12(r.v, p);
  return r;
}

// -- the group ----------------------------------------------------------------

// a where mask (lane_mask) is all ones, b where it is 0.
__device__ __forceinline__ Fp pick(uint32_t mask, const Fp& a, const Fp& b) {
  Fp r;
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) r.v[j] = select(mask, a.v[j], b.v[j]);
  return r;
}

// Lane `src`'s element, to every lane of the warp.
__device__ __forceinline__ Fp from_lane(const Fp& a, int src) {
  Fp r;
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) {
    r.v[j] = static_cast<uint32_t>(
        __shfl_sync(0xffffffffu, static_cast<int>(a.v[j]), src));
  }
  return r;
}

// Product k's result (word j on lane 4k + j / 3), to every lane.
__device__ __forceinline__ Fp from_product(const Fp3& a, int k) {
  Fp r;
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) {
    r.v[j] = static_cast<uint32_t>(
        __shfl_sync(0xffffffffu, static_cast<int>(a.w[j % 3]),
                    kProductLanes * k + j / 3));
  }
  return r;
}

struct Point {
  Fp x, y, z;
};

// Complete projective addition on y^2 = x^3 + 4 (RCB16 Alg. 7, a = 0,
// b3 = 12), the field operations of mirbft_tpu/ops/bls_g1.py:_point_add,
// over the warp: lanes 4k .. 4k + 3 run product k of each layer (k < 6;
// lanes 24-31 repeat product 5).  Every lane holds p and q, and returns
// the sum.
__device__ __forceinline__ Point point_add(const Point& p, const Point& q,
                                           int lane) {
  const int k = lane / kProductLanes;
  const int part = lane % kProductLanes;
  Fp zero;
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) zero.v[j] = 0;

  const uint32_t is0 = lane_mask(k == 0), is1 = lane_mask(k == 1),
                 is2 = lane_mask(k == 2), is3 = lane_mask(k == 3),
                 is4 = lane_mask(k == 4), below3 = lane_mask(k < 3);

  // Layer 1, lane k: 0 X1 X2, 1 Y1 Y2, 2 Z1 Z2, 3 (X1 + Y1)(X2 + Y2),
  // 4 (Y1 + Z1)(Y2 + Z2), 5 (X1 + Z1)(X2 + Z2).  Adding 0 leaves an
  // element as it is.
  const uint32_t first_y = is1 | is4, first_z = is2;
  const uint32_t single = below3, second_y = is3;
  const Fp a = fp_add(pick(first_y, p.y, pick(first_z, p.z, p.x)),
                      pick(single, zero, pick(second_y, p.y, p.z)));
  const Fp b = fp_add(pick(first_y, q.y, pick(first_z, q.z, q.x)),
                      pick(single, zero, pick(second_y, q.y, q.z)));
  const Fp3 prod = fp_mul_split(a, b, part);
  const Fp t0 = from_product(prod, 0), t1 = from_product(prod, 1),
           t2 = from_product(prod, 2), m3 = from_product(prod, 3),
           m4 = from_product(prod, 4), m5 = from_product(prod, 5);

  // Between the layers, lane k computes c (M - (U + V)):
  //   0: t3 = m3 - (t0 + t1)         c = 1
  //   1: t4 = m4 - (t1 + t2)         c = 1
  //   2: y3 = b3 (m5 - (t0 + t2))    c = 12  (b3 x3, x3 = X1 Z2 + X2 Z1)
  //   3: b3 t2                       c = 12
  //   4: 3 t0                        c = 3
  const Fp big_m = pick(is0, m3, pick(is1, m4, pick(is2, m5,
                        pick(is3, t2, t0))));
  const Fp u = pick(is1, t1, pick(below3, t0, zero));
  const Fp v = pick(is0, t1, pick(below3, t2, zero));
  const Fp r1 = fp_sub(big_m, fp_add(u, v));
  const Fp r2 = fp_add(r1, r1);
  const Fp r3 = fp_add(r2, r1);
  const Fp r6 = fp_add(r3, r3);
  const Fp r12 = fp_add(r6, r6);
  const Fp mid = pick(is2 | is3, r12, pick(is4, r3, r1));
  const Fp t3 = from_lane(mid, 0), t4 = from_lane(mid, kProductLanes),
           y3 = from_lane(mid, 2 * kProductLanes),
           t2b = from_lane(mid, 3 * kProductLanes),
           t0c = from_lane(mid, 4 * kProductLanes);
  const Fp z3 = fp_add(t1, t2b);
  const Fp t1d = fp_sub(t1, t2b);

  // Layer 2, lane k: 0 t3 t1, 1 t4 y3, 2 y3 t0, 3 t1 z3, 4 z3 t4, 5 t0 t3
  // (t0 = 3 t0, t1 = t1 - b3 t2 here).
  const Fp c = pick(is0, t3, pick(is1, t4, pick(is2, y3,
                    pick(is3, t1d, pick(is4, z3, t0c)))));
  const Fp d = pick(is0, t1d, pick(is1, y3, pick(is2, t0c,
                    pick(is3, z3, pick(is4, t4, t3)))));
  const Fp3 out = fp_mul_split(c, d, part);
  Point r;
  r.x = fp_sub(from_product(out, 0), from_product(out, 1));
  r.y = fp_add(from_product(out, 2), from_product(out, 3));
  r.z = fp_add(from_product(out, 4), from_product(out, 5));
  return r;
}

__device__ __forceinline__ void load_fp(Fp& r, const uint32_t* src) {
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) r.v[j] = src[j];
}

// Voter `row`'s point: its coordinates are read whatever its mask (a
// masked voter's are there too), so the reads need not wait for the mask,
// and the identity stands in where the mask is 0.
__device__ __forceinline__ Point load_voter(const uint32_t* xs,
                                            const uint32_t* ys,
                                            const uint32_t* zs,
                                            const int32_t* mask, int64_t row,
                                            const Point& identity) {
  Point q;
  load_fp(q.x, xs + row * kLimbs);
  load_fp(q.y, ys + row * kLimbs);
  load_fp(q.z, zs + row * kLimbs);
  const uint32_t live = lane_mask(mask[row] != 0);
  q.x = pick(live, q.x, identity.x);
  q.y = pick(live, q.y, identity.y);
  q.z = pick(live, q.z, identity.z);
  return q;
}

__device__ __forceinline__ void store_fp(uint32_t* dst, const Fp& a) {
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) dst[j] = a.v[j];
}

__global__ void __launch_bounds__(kBlsThreads)
mirbft_bls_g1_aggregate_kernel(const uint32_t* __restrict__ xs,
                               const uint32_t* __restrict__ ys,
                               const uint32_t* __restrict__ zs,
                               const int32_t* __restrict__ mask,
                               uint32_t* __restrict__ out, int width) {
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  Point identity;
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) {
    identity.x.v[j] = 0;
    identity.y.v[j] = kone(j);
    identity.z.v[j] = 0;
  }
  Point acc = identity;
  const int64_t base = static_cast<int64_t>(b) * width;
  // The next voter's point is read while this one is added: the reads'
  // latency overlaps an addition instead of standing on the chain.
  Point next = identity;
  if (width > 0) next = load_voter(xs, ys, zs, mask, base, identity);
  for (int v = 0; v < width; ++v) {
    const Point q = next;
    if (v + 1 < width) {
      next = load_voter(xs, ys, zs, mask, base + v + 1, identity);
    }
    acc = point_add(acc, q, lane);
  }
  if (lane == 0) {
    uint32_t* dst = out + static_cast<int64_t>(b) * 3 * kLimbs;
    store_fp(dst, acc.x);
    store_fp(dst + kLimbs, acc.y);
    store_fp(dst + 2 * kLimbs, acc.z);
  }
}

}  // namespace

// Launch on `stream`, a block (one warp) a certificate: xs, ys, zs (batch,
// width, 12) and mask (batch, width) int32 in, out (batch, 3, 12) int32.  Returns the launch's
// cudaError_t (0 on success); nothing is synchronised.
extern "C" int mirbft_bls_g1_aggregate(const void* xs, const void* ys,
                                       const void* zs, const void* mask,
                                       void* out, int batch, int width,
                                       void* stream) {
  if (batch <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mirbft_bls_g1_aggregate_kernel<<<batch, kBlsThreads, 0, s>>>(
      static_cast<const uint32_t*>(xs), static_cast<const uint32_t*>(ys),
      static_cast<const uint32_t*>(zs), static_cast<const int32_t*>(mask),
      static_cast<uint32_t*>(out), width);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mirbft_bls_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
