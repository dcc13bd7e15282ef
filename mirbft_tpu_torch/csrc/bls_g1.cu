// Batched BLS12-381 G1 aggregation for sm_90a: the masked sum of each
// quorum certificate's signature points over its voters.
//
// It computes what the JAX package's XLA program computes
// (mirbft_tpu/ops/bls_g1.py: _aggregate, a lax.scan of complete projective
// additions over the voter axis, vmapped across certificates): for each
// certificate b, acc = identity, then for voter v = 0, 1, ..., width - 1 in
// order, acc = acc + (mask[b][v] ? (X, Y, Z)[b][v] : identity), every step
// one complete addition of Renes, Costello and Batina (2016, Algorithm 7,
// a = 0, b3 = 3 * 4 = 12).  The same field operations in the same order
// give the same (X : Y : Z), not only the same affine point, so the result
// equals the JAX program's and the plain version's bit for bit once both
// are reduced.  A certificate whose voters are all masked comes out as the
// identity (0 : 1 : 0), Z = 0.
//
// Field: GF(p), p the 381-bit BLS12-381 prime, as 12 little-endian 32-bit
// limbs in Montgomery form with R = 2^384 (the JAX package's 30 limbs of
// 13 bits, R = 2^390, exist because the TPU has no wide multiply).  A
// product is Montgomery CIOS with 64-bit products and carries: a word of
// the multiplier, then a word of the reduction, twelve times.  Every
// element stays fully reduced in [0, p): a product of two such is below
// 2p (4p < R), and one conditional subtraction brings it back; a sum
// subtracts p once, a difference adds p on a borrow.  The tensors hold the
// limbs as int32 bit patterns: inputs (batch, width, 12) for X, Y and Z and
// (batch, width) for the mask, output (batch, 3, 12).
//
// What bounds it: one certificate is a chain of width additions (each
// reads the sum so far), each of 12 products, 22 sums and 5 differences,
// so a certificate's time is its chain's latency; the card is almost
// empty at rung 4's 4 certificates.  Design: one thread a certificate,
// the scan in voter order, everything in registers.  Splitting a
// certificate over lanes, or a tree over voters (which keeps the affine
// point but changes (X : Y : Z)), is left to a later performance change.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLimbs = 12;
constexpr int kBlsThreads = 32;  // one thread a certificate

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

// r = t - p if t (13 limbs, below 2p) >= p, else t.
__device__ __forceinline__ void reduce_once(Fp& r, const uint32_t* t) {
  uint32_t d[kLimbs];
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) {
    const uint64_t x = static_cast<uint64_t>(t[j]) - kp(j) - borrow;
    d[j] = static_cast<uint32_t>(x);
    borrow = (x >> 32) & 1;
  }
  const bool ge = t[kLimbs] != 0 || borrow == 0;
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) r.v[j] = ge ? d[j] : t[j];
}

// r = a b R^-1 mod p (CIOS); a, b in [0, p), r in [0, p).
__device__ __forceinline__ Fp fp_mul(const Fp& a, const Fp& b) {
  uint32_t t[kLimbs + 2];
#pragma unroll
  for (int j = 0; j < kLimbs + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) {
      // t[j] + a[j] b[i] + c < 2^64: (2^32 - 1)^2 + 2 (2^32 - 1).
      c += static_cast<uint64_t>(a.v[j]) * b.v[i] + t[j];
      t[j] = static_cast<uint32_t>(c);
      c >>= 32;
    }
    c += t[kLimbs];
    t[kLimbs] = static_cast<uint32_t>(c);
    t[kLimbs + 1] = static_cast<uint32_t>(c >> 32);
    const uint32_t m = t[0] * kN0;
    c = (static_cast<uint64_t>(m) * kp(0) + t[0]) >> 32;  // low word is 0
#pragma unroll
    for (int j = 1; j < kLimbs; ++j) {
      c += static_cast<uint64_t>(m) * kp(j) + t[j];
      t[j - 1] = static_cast<uint32_t>(c);
      c >>= 32;
    }
    c += t[kLimbs];
    t[kLimbs - 1] = static_cast<uint32_t>(c);
    t[kLimbs] = t[kLimbs + 1] + static_cast<uint32_t>(c >> 32);
  }
  Fp r;
  reduce_once(r, t);
  return r;
}

__device__ __forceinline__ Fp fp_add(const Fp& a, const Fp& b) {
  uint32_t t[kLimbs + 1];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) {
    c += static_cast<uint64_t>(a.v[j]) + b.v[j];
    t[j] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  t[kLimbs] = static_cast<uint32_t>(c);  // 0: a + b < 2p < 2^382
  Fp r;
  reduce_once(r, t);
  return r;
}

__device__ __forceinline__ Fp fp_sub(const Fp& a, const Fp& b) {
  Fp d;
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) {
    const uint64_t x = static_cast<uint64_t>(a.v[j]) - b.v[j] - borrow;
    d.v[j] = static_cast<uint32_t>(x);
    borrow = (x >> 32) & 1;
  }
  // On a borrow, a - b + 2^384 wrapped: adding p back (mod 2^384) lands
  // on a - b + p in [0, p).
  const uint32_t keep = borrow ? 0xffffffffu : 0u;
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) {
    c += static_cast<uint64_t>(d.v[j]) + (kp(j) & keep);
    d.v[j] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  return d;
}

// 3x and 12x as sums (the JAX program's add chains; any chain gives the
// same element).
__device__ __forceinline__ Fp fp_mul3(const Fp& x) {
  return fp_add(fp_add(x, x), x);
}

__device__ __forceinline__ Fp fp_mul12(const Fp& x) {
  const Fp x4 = fp_add(fp_add(x, x), fp_add(x, x));
  return fp_add(fp_add(x4, x4), x4);
}

struct Point {
  Fp x, y, z;
};

// Complete projective addition on y^2 = x^3 + 4 (RCB16 Alg. 7, a = 0,
// b3 = 12), step for step as mirbft_tpu/ops/bls_g1.py:_point_add.
__device__ __forceinline__ Point point_add(const Point& p, const Point& q) {
  Fp t0 = fp_mul(p.x, q.x);
  Fp t1 = fp_mul(p.y, q.y);
  Fp t2 = fp_mul(p.z, q.z);
  Fp t3 = fp_mul(fp_add(p.x, p.y), fp_add(q.x, q.y));
  t3 = fp_sub(t3, fp_add(t0, t1));
  Fp t4 = fp_mul(fp_add(p.y, p.z), fp_add(q.y, q.z));
  t4 = fp_sub(t4, fp_add(t1, t2));
  Fp x3 = fp_mul(fp_add(p.x, p.z), fp_add(q.x, q.z));
  x3 = fp_sub(x3, fp_add(t0, t2));
  t0 = fp_mul3(t0);
  t2 = fp_mul12(t2);
  Fp z3 = fp_add(t1, t2);
  t1 = fp_sub(t1, t2);
  Fp y3 = fp_mul12(x3);
  Point r;
  r.x = fp_sub(fp_mul(t3, t1), fp_mul(t4, y3));
  r.y = fp_add(fp_mul(y3, t0), fp_mul(t1, z3));
  r.z = fp_add(fp_mul(z3, t4), fp_mul(t0, t3));
  return r;
}

__device__ __forceinline__ void load_fp(Fp& r, const uint32_t* src) {
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) r.v[j] = src[j];
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
                               uint32_t* __restrict__ out, int batch,
                               int width) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  Point identity;
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) {
    identity.x.v[j] = 0;
    identity.y.v[j] = kone(j);
    identity.z.v[j] = 0;
  }
  Point acc = identity;
  for (int v = 0; v < width; ++v) {
    const int64_t row = static_cast<int64_t>(b) * width + v;
    Point q = identity;
    if (mask[row] != 0) {
      load_fp(q.x, xs + row * kLimbs);
      load_fp(q.y, ys + row * kLimbs);
      load_fp(q.z, zs + row * kLimbs);
    }
    acc = point_add(acc, q);
  }
  uint32_t* dst = out + static_cast<int64_t>(b) * 3 * kLimbs;
  store_fp(dst, acc.x);
  store_fp(dst + kLimbs, acc.y);
  store_fp(dst + 2 * kLimbs, acc.z);
}

}  // namespace

// Launch on `stream`: xs, ys, zs (batch, width, 12) and mask (batch,
// width) int32 in, out (batch, 3, 12) int32.  Returns the launch's
// cudaError_t (0 on success); nothing is synchronised.
extern "C" int mirbft_bls_g1_aggregate(const void* xs, const void* ys,
                                       const void* zs, const void* mask,
                                       void* out, int batch, int width,
                                       void* stream) {
  if (batch <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (batch + kBlsThreads - 1) / kBlsThreads;
  mirbft_bls_g1_aggregate_kernel<<<grid, kBlsThreads, 0, s>>>(
      static_cast<const uint32_t*>(xs), static_cast<const uint32_t*>(ys),
      static_cast<const uint32_t*>(zs), static_cast<const int32_t*>(mask),
      static_cast<uint32_t*>(out), batch, width);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mirbft_bls_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
