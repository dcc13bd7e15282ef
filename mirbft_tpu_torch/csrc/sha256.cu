// Batched multi-block SHA-256 (FIPS 180-4) for Hopper (sm_90a), and the
// chained-compression checksum of the kernel microbenchmark.
//
// The digest kernel replaces the Pallas TPU kernel
// mirbft_tpu/ops/sha256_pallas.py::_kernel (launched by _digest_device at
// :147) and its XLA twin mirbft_tpu/ops/sha256.py::_sha256_blocks: one
// kernel serves every block bucket, the 128-block bucket included.  The
// chain kernel replaces sha256_pallas.py::_chain_kernel (:121, launched by
// sha256_chain_checksum_pallas at :174) and its XLA twin
// sha256.py::sha256_chain_checksum; both kernels call the same compress(),
// so they cannot drift apart.
//
// Layout (the JAX layout, unchanged): blocks is (batch, max_blocks, 16)
// big-endian message words already padded on the host, carried as int32
// and read here as uint32; n_blocks is (batch,) int32; out is (batch, 8)
// digest words, written as uint32 bit patterns.
//
// What bounds it: integer ALU issue, not bytes.  One compression reads 64
// bytes and does about 1,384 32-bit integer instructions (SHF rotates,
// three-input LOP3 and IADD3), so at the card's 3.35 TB/s the bytes would
// take a small fraction of the time the INT32 pipes need.  The design keeps
// everything off memory but the one read of each live block:
//   - one thread per message, so rows are independent and a row loops over
//     its own n_blocks with no masking across rows (the TPU kernel ran every
//     row through max_blocks and froze finished rows);
//   - the 8-word state and the 16-word rolling schedule window stay in
//     registers (the 64 rounds are unrolled, so every window index is a
//     constant);
//   - K lives in __constant__ memory: every thread of a warp reads the same
//     K[t] in the same round, which the constant cache broadcasts;
//   - a row's 16 words are 64 contiguous bytes, read in place as four
//     16-byte loads.  No (8, 128) transposition and no 1024-row tiles.
// Rows with n_blocks == 0 (the packer's padding rows) return the IV, as the
// XLA twin does.  n_blocks is clamped to [0, max_blocks] so a bad count can
// never read past its row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__constant__ uint32_t kK[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu,
    0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u,
    0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u,
    0xc19bf174u, 0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu,
    0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau, 0x983e5152u,
    0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu,
    0x53380d13u, 0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,
    0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u, 0xd192e819u,
    0xd6990624u, 0xf40e3585u, 0x106aa070u, 0x19a4c116u, 0x1e376c08u,
    0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu,
    0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u,
};

constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

// One compression of the 64-byte block w into state s.  w is overwritten
// by the rolling schedule window.
__device__ __forceinline__ void compress(uint32_t s[8], uint32_t w[16]) {
  uint32_t a = s[0], b = s[1], c = s[2], d = s[3];
  uint32_t e = s[4], f = s[5], g = s[6], h = s[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    uint32_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      const uint32_t w15 = w[(t - 15) & 15];
      const uint32_t w2 = w[(t - 2) & 15];
      const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
      w[t & 15] = wt;
    }
    const uint32_t big_s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = h + big_s1 + ch + kK[t] + wt;
    const uint32_t big_s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + big_s0 + maj;
  }
  s[0] += a; s[1] += b; s[2] += c; s[3] += d;
  s[4] += e; s[5] += f; s[6] += g; s[7] += h;
}

__global__ void __launch_bounds__(kThreads)
mirbft_sha256_digest_kernel(const uint4* __restrict__ blocks,
                            const int32_t* __restrict__ n_blocks,
                            uint4* __restrict__ out, int batch,
                            int max_blocks) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= batch) return;  // the ragged edge of the grid

  int n = n_blocks[row];
  n = n < 0 ? 0 : (n > max_blocks ? max_blocks : n);

  uint32_t s[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
                   0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};

  // Four 16-byte loads per 64-byte block.
  const uint4* p = blocks + static_cast<size_t>(row) * max_blocks * 4;
  for (int j = 0; j < n; ++j) {
    uint32_t w[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 v = p[4 * j + q];
      w[4 * q + 0] = v.x;
      w[4 * q + 1] = v.y;
      w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
    compress(s, w);
  }

  uint4* o = out + static_cast<size_t>(row) * 2;
  o[0] = make_uint4(s[0], s[1], s[2], s[3]);
  o[1] = make_uint4(s[4], s[5], s[6], s[7]);
}

// Benchmark kernel: each row starts from the IV and makes `iters` chained
// compressions of its own 16-word block (each with the feed-forward add),
// then the 8 state words of every row are summed into *out, wrapping mod
// 2^32.  The sum is reduced in the kernel: each thread sums its 8 words, a
// warp sums by shuffles, the block's warps through shared memory, and one
// thread a block adds the block's sum with one atomicAdd.  Unsigned
// wrap-around addition is associative and commutative, so the result does
// not depend on the order the blocks land in: it is exact and
// deterministic.  *out must be 0 on entry (the launcher clears it on the
// stream).  Any batch works: threads past the ragged edge add 0.
__global__ void __launch_bounds__(kThreads)
mirbft_sha256_chain_kernel(const uint4* __restrict__ block,
                           uint32_t* __restrict__ out, int batch, int iters) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  uint32_t sum = 0;
  if (row < batch) {
    uint32_t w0[16];
    const uint4* p = block + static_cast<size_t>(row) * 4;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 v = p[q];
      w0[4 * q + 0] = v.x;
      w0[4 * q + 1] = v.y;
      w0[4 * q + 2] = v.z;
      w0[4 * q + 3] = v.w;
    }
    uint32_t s[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
                     0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};
    for (int i = 0; i < iters; ++i) {
      uint32_t w[16];  // compress() overwrites its window: a fresh copy
#pragma unroll
      for (int k = 0; k < 16; ++k) w[k] = w0[k];
      compress(s, w);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) sum += s[k];
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    sum += __shfl_down_sync(0xffffffffu, sum, offset);
  }
  __shared__ uint32_t warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t total = 0;
#pragma unroll
    for (int k = 0; k < kThreads / 32; ++k) total += warp_sums[k];
    atomicAdd(out, total);
  }
}

}  // namespace

// Plain C interface, bound with ctypes.  Pointers are device pointers, 16-byte
// aligned and contiguous (the Python wrapper checks).  Launches on the given
// stream, does not synchronise, and returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int mirbft_sha256_digest(const void* blocks, const void* n_blocks,
                                    void* out, int batch, int max_blocks,
                                    void* stream) {
  if (batch <= 0) return 0;
  const int grid = (batch + kThreads - 1) / kThreads;
  mirbft_sha256_digest_kernel<<<grid, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(blocks),
      static_cast<const int32_t*>(n_blocks), static_cast<uint4*>(out), batch,
      max_blocks);
  return static_cast<int>(cudaGetLastError());
}

// The chain checksum: block is (batch, 16) words, 16-byte aligned and
// contiguous; out is one uint32 on the card.  Clears *out and launches on
// the given stream, does not synchronise, and returns the first CUDA error
// (0 on success).
extern "C" int mirbft_sha256_chain(const void* block, void* out, int batch,
                                   int iters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(uint32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0) return 0;
  const int grid = (batch + kThreads - 1) / kThreads;
  mirbft_sha256_chain_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const uint4*>(block), static_cast<uint32_t*>(out), batch,
      iters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mirbft_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
