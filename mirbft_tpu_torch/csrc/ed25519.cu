// Batched Ed25519 verification for Hopper (sm_90a): point decompression and
// the 4-bit windowed Shamir ladder, one thread per row.
//
// Replaces the Pallas TPU kernels launched by
// mirbft_tpu/ops/ed25519_pallas.py::_verify_device:
//   - mirbft_ed25519_decompress: _decompress_kernel (launched at :528);
//   - mirbft_ed25519_ladder: _ladder_affine_kernel + _ladder_tail (at :559);
// and their XLA twin mirbft_tpu/ops/ed25519.py::ladder_impl, which the port
// routes into the same two kernels.  The plain PyTorch versions in
// mirbft_tpu_torch/ops/ed25519.py repeat this file's arithmetic step for
// step, so kernel and plain agree limb for limb, not only mod p.
//
// Field representation.  GF(2^255 - 19) as 10 signed int32 limbs of radix
// 2^25.5 (ref10's layout: widths 26, 25, 26, ..., limb i at bit
// 0, 26, 51, 77, 102, 128, 153, 179, 204, 230), products as int64.  The
// TPU's 20 x 13-bit limbs existed only because the TPU has no 64-bit
// multiply; Hopper has IMAD.WIDE.  Carry bounds, for "reduced" elements
// (|limb i| <= 2^w_i):
//   - mul/sq: the factor 2 (both limbs odd) goes on f, at most 2^26; the
//     factor 19 (columns past 2^255) on g, at most 19 * 2^26 < 2^30.25; so
//     both fit int32, and a column of at most 10 terms stays under 2^61 in
//     int64.  Three rounding carry passes (all limbs at once; the carry out
//     of limb 9 re-enters limb 0 times 19) give |limb| <= 2^(w-1) + 19.
//   - add/sub: two reduced limbs sum to under 2^27; one int32 rounding
//     pass gives |limb| <= 2^(w-1) + 38.
//   - canonical: two wrapping floor chains put the value in [0, 2^255); a
//     quotient chain finds whether it is >= p; a last chain subtracts p.
// Every product and every sum is carried: no lazy-reduction argument.
//
// What bounds it: integer instructions.  A verdict costs about 3,300 field
// products and a decompressed point about 270 (ops/ed25519.py counts
// them), against well under 200 bytes of input and output a row, so at
// 3.35 TB/s the bytes take a small fraction of the time the INT32 pipes
// need.  The design keeps the work off memory:
//   - one thread per row (a signature, or a point for decompression); no
//     row reads another, so there is no reduction across blocks, and the
//     launch covers exactly the live rows (no padding to a tile);
//   - the accumulator and all temporaries stay in registers;
//   - the [j](-A) table, 16 points x 40 limbs = 2,560 bytes a thread, is
//     indexed by the data and goes to local memory (ptxas reports it as
//     stack), read once a window;
//   - the constant [j]B table is copied into shared memory once a block:
//     threads of a warp index different entries, which __constant__ memory
//     would serialise, and in shared memory the local-memory traffic of the
//     [j](-A) table cannot evict it from L1;
//   - the windows are cut from the 32-byte scalars in the kernel (64 bytes
//     a row cross to the card instead of 512 bytes of windows).
// The verdict is over public data, so the tables are indexed directly:
// nothing here has to be constant-time.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
// Rows of the constants table (ops/ed25519.py::constants()).
constexpr int kConstD = 0;
constexpr int kConstD2 = 1;
constexpr int kConstSqrtM1 = 2;
constexpr int kConstBTable = 3;
constexpr int kBTableInts = 16 * 4 * 10;

struct Fe {
  int32_t v[10];
};

struct Point {
  Fe x, y, z, t;
};

__host__ __device__ constexpr int width(int i) { return (i & 1) ? 25 : 26; }

__device__ __forceinline__ Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int i = 0; i < 10; ++i) r.v[i] = 0;
  return r;
}

__device__ __forceinline__ Fe fe_one() {
  Fe r = fe_zero();
  r.v[0] = 1;
  return r;
}

__device__ __forceinline__ Fe fe_load(const int32_t* p) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 10; ++i) r.v[i] = p[i];
  return r;
}

// One rounding carry pass over every limb at once, int64.
__device__ __forceinline__ void carry_pass64(int64_t h[10]) {
  int64_t c[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    c[i] = (h[i] + (int64_t{1} << (width(i) - 1))) >> width(i);
    h[i] -= c[i] * (int64_t{1} << width(i));
  }
  h[0] += 19 * c[9];
#pragma unroll
  for (int i = 1; i < 10; ++i) h[i] += c[i - 1];
}

// The same pass in int32, for sums and differences (under 2^27 a limb).
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

__device__ __forceinline__ Fe fe_add(const Fe& f, const Fe& g) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 10; ++i) r.v[i] = f.v[i] + g.v[i];
  carry_pass32(r.v);
  return r;
}

__device__ __forceinline__ Fe fe_sub(const Fe& f, const Fe& g) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 10; ++i) r.v[i] = f.v[i] - g.v[i];
  carry_pass32(r.v);
  return r;
}

__device__ __forceinline__ Fe finish_product(int64_t h[10]) {
  carry_pass64(h);
  carry_pass64(h);
  carry_pass64(h);
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

// Reduced limbs -> the limbs of the representative in [0, p).
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

// z^((p-5)/8) = z^(2^252 - 3): ref10's chain of squarings and 11 products.
__device__ Fe sqn(Fe x, int n) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) x = fe_sq(x);
  return x;
}

__device__ Fe pow22523(const Fe& z) {
  Fe t0 = fe_sq(z);
  Fe t1 = fe_mul(z, sqn(t0, 2));
  t0 = fe_mul(t0, t1);
  t0 = fe_mul(t1, fe_sq(t0));   // 2^5 - 1
  t0 = fe_mul(sqn(t0, 5), t0);  // 2^10 - 1
  t1 = fe_mul(sqn(t0, 10), t0);  // 2^20 - 1
  t1 = fe_mul(sqn(t1, 20), t1);  // 2^40 - 1
  t0 = fe_mul(sqn(t1, 10), t0);  // 2^50 - 1
  t1 = fe_mul(sqn(t0, 50), t0);  // 2^100 - 1
  t1 = fe_mul(sqn(t1, 100), t1);  // 2^200 - 1
  t0 = fe_mul(sqn(t1, 50), t0);  // 2^250 - 1
  return fe_mul(sqn(t0, 2), z);  // 2^252 - 3
}

// Unified extended twisted-Edwards addition (add-2008-hwcd-3), complete for
// a = -1.
__device__ Point point_add(const Point& p, const Point& q, const Fe& d2) {
  const Fe a = fe_mul(fe_sub(p.y, p.x), fe_sub(q.y, q.x));
  const Fe b = fe_mul(fe_add(p.y, p.x), fe_add(q.y, q.x));
  const Fe c = fe_mul(fe_mul(p.t, q.t), d2);
  Fe d = fe_mul(p.z, q.z);
  d = fe_add(d, d);
  const Fe e = fe_sub(b, a);
  const Fe f = fe_sub(d, c);
  const Fe g = fe_add(d, c);
  const Fe h = fe_add(b, a);
  Point r;
  r.x = fe_mul(e, f);
  r.y = fe_mul(g, h);
  r.z = fe_mul(f, g);
  r.t = fe_mul(e, h);
  return r;
}

// Dedicated doubling (dbl-2008-hwcd, a = -1).
__device__ Point point_double(const Point& p) {
  const Fe a = fe_sq(p.x);
  const Fe b = fe_sq(p.y);
  const Fe zz = fe_sq(p.z);
  const Fe c = fe_add(zz, zz);
  const Fe e = fe_sub(fe_sub(fe_sq(fe_add(p.x, p.y)), a), b);
  const Fe g = fe_sub(b, a);
  const Fe f = fe_sub(g, c);
  const Fe h = fe_sub(fe_zero(), fe_add(a, b));
  Point r;
  r.x = fe_mul(e, f);
  r.y = fe_mul(g, h);
  r.z = fe_mul(f, g);
  r.t = fe_mul(e, h);
  return r;
}

__device__ __forceinline__ void store_fe(int32_t* p, const Fe& f) {
#pragma unroll
  for (int i = 0; i < 10; ++i) p[i] = f.v[i];
}

// enc: (rows, 8) little-endian words of 32-byte encodings.  xy: (rows, 2,
// 10) canonical affine (x, y).  ok: (rows,) 1 where the encoding is a point.
__global__ void __launch_bounds__(kThreads)
mirbft_ed25519_decompress_kernel(const uint4* __restrict__ enc,
                                 int32_t* __restrict__ xy,
                                 int32_t* __restrict__ ok, int rows,
                                 const int32_t* __restrict__ consts) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= rows) return;  // the ragged edge of the grid
  const uint4 lo = enc[2 * static_cast<size_t>(row)];
  const uint4 hi = enc[2 * static_cast<size_t>(row) + 1];
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const Fe y = fe_frombytes(w);
  const int32_t sign = static_cast<int32_t>(w[7] >> 31);

  const Fe one = fe_one();
  const Fe yy = fe_sq(y);
  const Fe u = fe_sub(yy, one);  // y^2 - 1
  const Fe v = fe_add(fe_mul(fe_load(consts + 10 * kConstD), yy), one);
  const Fe v3 = fe_mul(fe_sq(v), v);
  const Fe v7 = fe_mul(fe_sq(v3), v);
  Fe x = fe_mul(fe_mul(u, v3), pow22523(fe_mul(u, v7)));  // root of u/v?
  const Fe vxx = fe_mul(v, fe_sq(x));
  const bool is_root = fe_eq(vxx, u);
  const bool is_neg_root = fe_eq(vxx, fe_sub(fe_zero(), u));
  const Fe x_fixed = fe_mul(x, fe_load(consts + 10 * kConstSqrtM1));
  x = fe_canonical(fe_select(is_neg_root, x_fixed, x));
  int32_t any = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) any |= x.v[i];
  const bool good = (is_root || is_neg_root) && !(any == 0 && sign == 1);
  // Parity fix-up: -x when the canonical parity differs from the sign bit.
  const Fe x_neg = fe_canonical(fe_sub(fe_zero(), x));
  x = fe_select((x.v[0] & 1) != sign, x_neg, x);

  int32_t* out = xy + 20 * static_cast<size_t>(row);
  store_fe(out, x);
  store_fe(out + 10, fe_canonical(y));
  ok[row] = good ? 1 : 0;
}

// 4-bit window t (0 = bits 255..252) of a scalar's 8 little-endian words.
__device__ __forceinline__ int window(const uint32_t* __restrict__ words,
                                      int t) {
  const int nib = 63 - t;
  return static_cast<int>((__ldg(words + (nib >> 3)) >> (4 * (nib & 7))) & 15);
}

// xy: (2n, 2, 10) affine points from the decompress kernel (A rows, then R
// rows); ok: (2n,).  s_words, k_words: (n, 8) little-endian words of S and
// k.  out: (n,) 1 where [S]B + [k](-A) == R projectively, Z != 0 and both
// points decompressed.
__global__ void __launch_bounds__(kThreads)
mirbft_ed25519_ladder_kernel(const int32_t* __restrict__ xy,
                             const int32_t* __restrict__ okf,
                             const uint32_t* __restrict__ s_words,
                             const uint32_t* __restrict__ k_words,
                             int32_t* __restrict__ out, int n,
                             const int32_t* __restrict__ consts) {
  __shared__ int32_t b_table[kBTableInts];  // [j]B: (x, y, z, t) each
  for (int i = threadIdx.x; i < kBTableInts; i += kThreads) {
    b_table[i] = consts[10 * kConstBTable + i];
  }
  __syncthreads();
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= n) return;  // the ragged edge of the grid

  const int32_t* a_xy = xy + 20 * static_cast<size_t>(row);
  const int32_t* r_xy = xy + 20 * (static_cast<size_t>(n) + row);
  const bool valid = okf[row] != 0 && okf[n + row] != 0;
  const Fe d2 = fe_load(consts + 10 * kConstD2);

  const Fe ay = fe_load(a_xy + 10);
  const Fe nx = fe_sub(fe_zero(), fe_load(a_xy));
  Point neg_a;
  neg_a.x = nx;
  neg_a.y = ay;
  neg_a.z = fe_one();
  neg_a.t = fe_mul(nx, ay);

  Point table[16];  // [j](-A), indexed by the data: local memory
  table[0].x = fe_zero();
  table[0].y = fe_one();
  table[0].z = fe_one();
  table[0].t = fe_zero();
  table[1] = neg_a;
#pragma unroll 1
  for (int j = 2; j < 16; ++j) table[j] = point_add(table[j - 1], neg_a, d2);

  const uint32_t* s = s_words + 8 * static_cast<size_t>(row);
  const uint32_t* k = k_words + 8 * static_cast<size_t>(row);
  Point acc = table[0];
#pragma unroll 1
  for (int t = 0; t < 64; ++t) {
#pragma unroll 1
    for (int i = 0; i < 4; ++i) acc = point_double(acc);
    const int32_t* b = b_table + 40 * window(s, t);
    Point bp;
    bp.x = fe_load(b);
    bp.y = fe_load(b + 10);
    bp.z = fe_load(b + 20);
    bp.t = fe_load(b + 30);
    acc = point_add(acc, bp, d2);
    acc = point_add(acc, table[window(k, t)], d2);
  }

  const bool good = fe_eq(acc.x, fe_mul(fe_load(r_xy), acc.z)) &&
                    fe_eq(acc.y, fe_mul(fe_load(r_xy + 10), acc.z)) &&
                    !fe_is_zero(acc.z) && valid;
  out[row] = good ? 1 : 0;
}

int grid_for(int rows) { return (rows + kThreads - 1) / kThreads; }

}  // namespace

// Plain C interface, bound with ctypes.  Pointers are device pointers,
// contiguous, enc 16-byte aligned (the Python wrapper checks).  Each
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int mirbft_ed25519_decompress(const void* enc, void* xy, void* ok,
                                         int rows, const void* consts,
                                         void* stream) {
  if (rows <= 0) return 0;
  mirbft_ed25519_decompress_kernel<<<grid_for(rows), kThreads, 0,
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
  mirbft_ed25519_ladder_kernel<<<grid_for(n), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(xy), static_cast<const int32_t*>(ok),
      static_cast<const uint32_t*>(s_words),
      static_cast<const uint32_t*>(k_words), static_cast<int32_t*>(out), n,
      static_cast<const int32_t*>(consts));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mirbft_ed25519_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
