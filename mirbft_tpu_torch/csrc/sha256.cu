// Batched multi-block SHA-256 (FIPS 180-4) for Hopper (sm_90a), and the
// chained-compression checksum of the kernel microbenchmark.
//
// The digest kernel replaces the Pallas TPU kernel
// mirbft_tpu/ops/sha256_pallas.py::_kernel (launched by _digest_device at
// :147) and its XLA twin mirbft_tpu/ops/sha256.py::_sha256_blocks: one
// entry point serves every block bucket, the 128-block bucket included,
// with two bodies.  The chain kernel replaces
// sha256_pallas.py::_chain_kernel (:121, launched by
// sha256_chain_checksum_pallas at :174) and its XLA twin
// sha256.py::sha256_chain_checksum; it and the one-thread body call the
// same compress().
//
// Layout (the JAX layout, unchanged): blocks is (batch, max_blocks, 16)
// big-endian message words already padded on the host, carried as int32
// and read here as uint32; n_blocks is (batch,) int32; out is (batch, 8)
// digest words, written as uint32 bit patterns.
//
// What bounds it: integer instructions, not bytes.  One compression reads
// 64 bytes and does about 1,384 32-bit integer instructions (SHF rotates,
// three-input LOP3 and IADD3), so at the card's 3.35 TB/s the bytes would
// take a small fraction of the time the INT32 pipes need.  But a message's
// blocks are serial (Merkle-Damgard), and the engine's long bucket is 256
// rows of 128 blocks: 8 warps, far from filling 132 SMs.  There a launch
// is bound by one row: its rounds are serial, and each is about 14 integer
// instructions (6 SHF, 4 LOP3, 4 adds) that its warp issues alone on its
// SM partition, whose 16-lane integer pipes take two cycles a warp
// instruction; the dependent chain (about three instructions a round) is
// shorter than that.
// So there are two bodies behind one entry point, chosen by the bucket:
//   - the one-thread body (buckets under kWsMinBlocks blocks): one thread
//     per message, the 8-word state and the 16-word rolling schedule
//     window in registers (the 64 rounds unrolled), K in __constant__
//     memory (a warp reads the same K[t] in the same round, which the
//     constant cache broadcasts), a row's 64-byte blocks read in place as
//     four 16-byte loads;
//   - the warp-specialised body (kWsMinBlocks blocks and more): a block is
//     a consumer warp of 32 messages and a producer warp.  The producer
//     copies each message's upcoming blocks into shared memory with
//     cp.async, kWsRaw - 1 blocks ahead, expands the schedule and adds K,
//     and hands W[t] + K[t] of all 64 rounds to the consumer through a
//     ring of kWsStages stages with full and empty mbarriers.  The
//     consumer issues only the rounds, with the state in registers and no
//     load latency between blocks; on another SM partition the producer's
//     schedule work does not take the consumer's issue slots.  A 256-row
//     launch is 8 blocks on 8 SMs.
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

constexpr int kThreads = 128;  // one-thread body and chain kernel
// The warp-specialised body: a consumer warp of kWsLanes messages and a
// producer warp; kWsStages blocks of W + K in flight per message, and
// kWsRaw raw blocks copied ahead.  Buckets of kWsMinBlocks blocks and
// more take it.
constexpr int kWsLanes = 32;
constexpr int kWsStages = 4;
constexpr int kWsRaw = 4;
constexpr int kWsMinBlocks = 2;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; complete at cp_async_wait.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive (release: this thread's earlier writes to shared memory are seen
// by a thread whose wait on the phase returns).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait (acquire) until the phase of the given parity has completed.  A
// wait that never ends is a fault of this file: trap after 2^32 SM cycles
// (about two seconds) rather than hold the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 32)) __trap();
  }
}

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

// One round on the working variables; kw = K[t] + W[t].
__device__ __forceinline__ void sha_round(uint32_t& a, uint32_t& b,
                                          uint32_t& c, uint32_t& d,
                                          uint32_t& e, uint32_t& f,
                                          uint32_t& g, uint32_t& h,
                                          uint32_t kw) {
  const uint32_t big_s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
  const uint32_t ch = (e & f) ^ (~e & g);
  const uint32_t t1 = h + kw + ch + big_s1;
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
    sha_round(a, b, c, d, e, f, g, h, kK[t] + wt);
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

// The warp-specialised body for long messages.  A block is two warps: warp
// 0 consumes, one message a lane, and runs only the 64 rounds of each
// block; warp 1 produces, one message a lane: it copies the message's
// blocks kWsRaw - 1 ahead into shared memory with cp.async, expands each
// block's schedule and adds K, and writes W[t] + K[t] for the 64 rounds
// into a ring of kWsStages stages (16 uint4 a lane, lanes innermost, so
// both warps' 16-byte accesses are conflict-free).  Each stage has a full
// and an empty mbarrier, each taking one arrival a lane.  Both warps loop
// over the block count of the warp's longest message; a lane whose message
// is done (or past the batch) arrives without working.
__global__ void __launch_bounds__(2 * kWsLanes)
mirbft_sha256_digest_ws_kernel(const uint4* __restrict__ blocks,
                               const int32_t* __restrict__ n_blocks,
                               uint4* __restrict__ out, int batch,
                               int max_blocks) {
  __shared__ __align__(16) uint4 wk_ring[kWsStages][16][kWsLanes];
  __shared__ __align__(16) uint4 raw_ring[kWsRaw][4][kWsLanes];
  __shared__ __align__(8) uint64_t full[kWsStages], empty[kWsStages];
  const bool producer = threadIdx.x >= kWsLanes;
  const int lane = threadIdx.x - (producer ? kWsLanes : 0);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kWsStages; ++i) {
      mbar_init(&full[i], kWsLanes);
      mbar_init(&empty[i], kWsLanes);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int row = blockIdx.x * kWsLanes + lane;
  int n = row < batch ? n_blocks[row] : 0;
  n = n < 0 ? 0 : (n > max_blocks ? max_blocks : n);
  const int warp_blocks = static_cast<int>(__reduce_max_sync(0xffffffffu, n));

  if (producer) {
    const uint4* src = blocks + static_cast<size_t>(row) * max_blocks * 4;
    // One copy group a block, committed even when empty, so the group
    // count tells which block has landed.
#pragma unroll
    for (int j = 0; j < kWsRaw - 1; ++j) {
      if (j < n) {
#pragma unroll
        for (int q = 0; q < 4; ++q) cp_async16(&raw_ring[j][q][lane], src + 4 * j + q);
      }
      cp_async_commit();
    }
    for (int j = 0; j < warp_blocks; ++j) {
      const int ahead = j + kWsRaw - 1;  // its slot held block j - 1
      if (ahead < n) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          cp_async16(&raw_ring[ahead % kWsRaw][q][lane], src + 4 * ahead + q);
        }
      }
      cp_async_commit();
      cp_async_wait<kWsRaw - 1>();  // block j's group has landed
      const int stage = j % kWsStages;
      const int use = j / kWsStages;
      if (use > 0) mbar_wait(&empty[stage], (use - 1) & 1);
      if (j < n) {
        uint32_t w[16];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint4 v = raw_ring[j % kWsRaw][q][lane];
          w[4 * q + 0] = v.x;
          w[4 * q + 1] = v.y;
          w[4 * q + 2] = v.z;
          w[4 * q + 3] = v.w;
        }
        uint32_t kw[4];
#pragma unroll
        for (int t = 0; t < 64; ++t) {
          if (t >= 16) {
            const uint32_t w15 = w[(t - 15) & 15];
            const uint32_t w2 = w[(t - 2) & 15];
            const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
            const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
            w[t & 15] += s0 + w[(t - 7) & 15] + s1;
          }
          kw[t & 3] = w[t & 15] + kK[t];
          if ((t & 3) == 3) {
            wk_ring[stage][t >> 2][lane] = make_uint4(kw[0], kw[1], kw[2], kw[3]);
          }
        }
      }
      mbar_arrive(&full[stage]);
    }
    return;
  }

  uint32_t s[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
                   0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};
  for (int j = 0; j < warp_blocks; ++j) {
    const int stage = j % kWsStages;
    mbar_wait(&full[stage], (j / kWsStages) & 1);
    if (j < n) {
      uint32_t a = s[0], b = s[1], c = s[2], d = s[3];
      uint32_t e = s[4], f = s[5], g = s[6], h = s[7];
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const uint4 v = wk_ring[stage][q][lane];
        const uint32_t kw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) sha_round(a, b, c, d, e, f, g, h, kw[i]);
      }
      s[0] += a; s[1] += b; s[2] += c; s[3] += d;
      s[4] += e; s[5] += f; s[6] += g; s[7] += h;
    }
    mbar_arrive(&empty[stage]);
  }
  if (row < batch) {
    uint4* o = out + static_cast<size_t>(row) * 2;
    o[0] = make_uint4(s[0], s[1], s[2], s[3]);
    o[1] = make_uint4(s[4], s[5], s[6], s[7]);
  }
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
// Every bucket: buckets of kWsMinBlocks blocks and more take the
// warp-specialised body, shorter ones the one-thread body.
extern "C" int mirbft_sha256_digest(const void* blocks, const void* n_blocks,
                                    void* out, int batch, int max_blocks,
                                    void* stream) {
  if (batch <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* in = static_cast<const uint4*>(blocks);
  const int32_t* counts = static_cast<const int32_t*>(n_blocks);
  uint4* digests = static_cast<uint4*>(out);
  if (max_blocks >= kWsMinBlocks) {
    const int grid = (batch + kWsLanes - 1) / kWsLanes;
    mirbft_sha256_digest_ws_kernel<<<grid, 2 * kWsLanes, 0, s>>>(
        in, counts, digests, batch, max_blocks);
  } else {
    const int grid = (batch + kThreads - 1) / kThreads;
    mirbft_sha256_digest_kernel<<<grid, kThreads, 0, s>>>(
        in, counts, digests, batch, max_blocks);
  }
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
