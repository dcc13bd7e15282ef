// The sharded crypto plane's two reductions for sm_90a: the column sums of
// a shard's vote block, and the sum of the shards' partials (the port's
// psum).
//
// They compute what the JAX package's sharded programs compute
// (mirbft_tpu/parallel/sharding.py: sharded_quorum_tally's
// jnp.sum(votes.astype(int32), axis=0) on each shard, then lax.psum over the
// mesh axis and the threshold; the ack plane's psum of its per-row outputs
// and of the sweep's totals, mirbft_tpu/core/device_tracker.py), bit for
// bit: int32 sums, wrapping as two's complement where they overflow.
//
// tally_columns: a shard's (rows, cols) int8 vote block, row-major, ->
// (cols,) int32 column sums, each vote sign-extended.  What bounds it: its
// bytes (rows * cols read once, 4 * cols written); it does one add a
// byte.  A block takes 128 consecutive columns, four a lane: each warp
// reads 128 contiguous bytes of a row at a time (one 4-byte load a lane
// where the row stride and the base allow it, else four byte loads of the
// same 128 bytes), and its 8 warps take every 8th row, so a block's loads
// of 8 rows are in flight at once and a grid of cols / 128 blocks covers
// the card at the tally's sizes.  The warps' sums meet in shared memory,
// and a column's total is written by one thread.  A thread a column (the
// simplest kernel) reads one byte a load: a warp moves 32 bytes a load
// instead of 128.
//
// shard_sum: k partials of n int32, already on one device as a (k, n)
// tensor, -> (n,) int32, or (n,) bytes 0/1 of total >= threshold.  A thread
// a column, coalesced along each row; k is the mesh size, a handful.
//
// Neither needs atomics, a memset or scratch: each output word has one
// writer, and the order of the adds is fixed (the shards' in mesh order),
// though integer adds do not depend on it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTallyWarps = 8;  // warps a block; warp w takes rows w, w + 8, ...
constexpr int kTallyLaneCols = 4;  // columns a lane
constexpr int kTallyBlockCols = 32 * kTallyLaneCols;  // columns a block
static_assert(kTallyWarps * 32 >= kTallyBlockCols,
              "a thread a column sums the warps' partials");
constexpr int kSumThreads = 256;  // a block of shard_sum's grid

// Byte j of a little-endian word, sign-extended (a vote is int8).
__device__ __forceinline__ int32_t signed_byte(uint32_t word, int j) {
  return static_cast<int32_t>(word << (24 - 8 * j)) >> 24;
}

__global__ void __launch_bounds__(kTallyWarps * 32)
mirbft_tally_columns_kernel(const int8_t* __restrict__ votes,
                            int32_t* __restrict__ out, int rows, int cols,
                            bool words) {
  __shared__ uint32_t partial[kTallyWarps][kTallyBlockCols];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kTallyBlockCols +
                     lane * kTallyLaneCols;
  uint32_t sum[kTallyLaneCols] = {};
  if (words && c0 + kTallyLaneCols <= cols) {
    // cols % 4 == 0 and the base on 4 bytes: the lane's 4 columns of a row
    // are one aligned word.
#pragma unroll 4
    for (int r = warp; r < rows; r += kTallyWarps) {
      const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(
          votes + static_cast<int64_t>(r) * cols + c0));
#pragma unroll
      for (int j = 0; j < kTallyLaneCols; ++j) sum[j] += signed_byte(w, j);
    }
  } else {
    for (int r = warp; r < rows; r += kTallyWarps) {
      const int8_t* row = votes + static_cast<int64_t>(r) * cols;
#pragma unroll
      for (int j = 0; j < kTallyLaneCols; ++j) {
        if (c0 + j < cols) sum[j] += static_cast<int32_t>(__ldg(row + c0 + j));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kTallyLaneCols; ++j) {
    partial[warp][lane * kTallyLaneCols + j] = sum[j];
  }
  __syncthreads();
  if (threadIdx.x < kTallyBlockCols) {
    const int64_t c =
        static_cast<int64_t>(blockIdx.x) * kTallyBlockCols + threadIdx.x;
    uint32_t total = 0;
#pragma unroll
    for (int w = 0; w < kTallyWarps; ++w) total += partial[w][threadIdx.x];
    if (c < cols) out[c] = static_cast<int32_t>(total);
  }
}

// Column c of k rows of n partials: the sum, or (mask) the sum against the
// threshold.  Exactly one of sums and mask is not null.
__global__ void __launch_bounds__(kSumThreads)
mirbft_shard_sum_kernel(const int32_t* __restrict__ parts, int k, int n,
                        int threshold, int32_t* __restrict__ sums,
                        uint8_t* __restrict__ mask) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (c >= n) return;
  uint32_t total = 0;
  for (int s = 0; s < k; ++s) {
    total += static_cast<uint32_t>(__ldg(parts + static_cast<int64_t>(s) * n +
                                         c));
  }
  if (mask != nullptr) {
    mask[c] = static_cast<int32_t>(total) >= threshold;
  } else {
    sums[c] = static_cast<int32_t>(total);
  }
}

// Nothing: the two kernels' launches with no work, timed beside them as
// their floor.
__global__ void mirbft_parallel_empty_kernel() {}

inline int tally_blocks(int cols) {
  return (cols + kTallyBlockCols - 1) / kTallyBlockCols;
}

inline int sum_blocks(int n) { return (n + kSumThreads - 1) / kSumThreads; }

}  // namespace

// Launch the column sums of a (rows, cols) int8 block on `stream`; `out`
// holds cols int32.  Returns the launch's cudaError_t (0 on success);
// nothing is synchronised.
extern "C" int mirbft_tally_columns(const void* votes, void* out, int rows,
                                    int cols, void* stream) {
  if (cols <= 0) return 0;
  const bool words = cols % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(votes) & 3) == 0;
  mirbft_tally_columns_kernel<<<tally_blocks(cols), kTallyWarps * 32, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(votes), static_cast<int32_t*>(out),
      rows < 0 ? 0 : rows, cols, words);
  return static_cast<int>(cudaGetLastError());
}

// Launch the sum of a (k, n) int32 tensor's rows on `stream`: into `out` as
// n int32, or, when `has_threshold`, as n bytes of sum >= threshold.
extern "C" int mirbft_shard_sum(const void* parts, void* out, int k, int n,
                                int threshold, int has_threshold,
                                void* stream) {
  if (n <= 0) return 0;
  mirbft_shard_sum_kernel<<<sum_blocks(n), kSumThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(parts), k < 0 ? 0 : k, n, threshold,
      has_threshold ? nullptr : static_cast<int32_t*>(out),
      has_threshold ? static_cast<uint8_t*>(out) : nullptr);
  return static_cast<int>(cudaGetLastError());
}

// The empty kernel launched as tally_columns is over `cols` columns.
extern "C" int mirbft_tally_empty(int cols, void* stream) {
  mirbft_parallel_empty_kernel<<<tally_blocks(cols < 1 ? 1 : cols),
                                 kTallyWarps * 32, 0,
                                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// The empty kernel launched as shard_sum is over `n` columns.
extern "C" int mirbft_shard_sum_empty(int n, void* stream) {
  mirbft_parallel_empty_kernel<<<sum_blocks(n < 1 ? 1 : n), kSumThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mirbft_parallel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
