// The device ack plane's two programs for sm_90a: the step that absorbs
// one ack batch into the dense slot state, and the quorum sweep.
//
// They compute what the JAX package's two XLA programs compute
// (mirbft_tpu/core/device_tracker.py: device_ack_step, device_quorum_sweep),
// row for row and bit for bit, without their sort-based structure.
//
// State, one plane of total = c_pad * w_pad slots, row-major:
//   agree, nonnull  total x limbs uint32 vote masks (voter v: bit v & 31
//                   of limb v >> 5);
//   canon           total x 8 uint32 canonical digest words;
//   canon_ok, held  total bytes, 0 or 1;
//   flags, tick     total bytes (flags: COMMITTED 1, SLOW 2).
// A batch is rows x 12 int32: ci, w, src, valid, dig[8].  The step's row
// output is one int32 a row: bits for applied, fallback, dropped, adopt,
// the weak and the strong crossing, and the slot's count after the batch
// from bit 8.
//
// What bounds the step on this card: its bytes are a few hundred kB at
// most (the byte bound is 0.04-0.5 us at 2048-16384 rows), so its time is
// the fixed cost of its launches and the round trips to memory of a batch
// whose rows hit random slots.  It has three phases with two grid-wide
// orderings between them:
//   1. classify: each valid row finds its slot and its class, reads the
//      masks as they were before the batch (the spam guard's dup and
//      foreign bits, the count before), and a live row on a virgin slot
//      offers its index to the slot's adoption word `first` with atomicMin;
//   2. apply: once every offer has landed, the lowest index offered to a
//      virgin slot adopts its digest, every live row of that slot is held
//      against the adopter's digest (read from the batch, so no row waits
//      for the write), live rows of other slots against the slot's
//      canonical digest; a matching row with no foreign vote ORs its bit
//      into both masks with atomicOr;
//   3. finish: once every OR has landed, each applied row counts its
//      slot's votes, reports the crossings and rewrites the slot's tick
//      (every applied row of a slot writes the same class); the adopter
//      empties the slot's adoption word for the next batch.
// The first port ran the phases as three launches, one for each ordering.
// The design here: one cooperative launch, a grid barrier
// (cooperative_groups' grid_group::sync) where a launch boundary stood.
// A thread takes rows t, t + T, ... (T the grid's threads).  On this card
// every row bucket up to 65536 rows is one row a thread; a larger flush
// gives a thread several.  A thread keeps its first kStepRows rows' slot
// and class in registers across the barriers, and any row past them its
// class in its own word of `out` (its slot read from the batch again), so
// every row count runs and no scratch is allocated.  A row's reads of its
// slot are issued together before its class picks the ones that matter.
// The grid holds one block of kStepThreads a 256 rows, up to the blocks
// of the step the card keeps resident at once (a cooperative launch needs
// them all resident; the launcher asks the occupancy calculator once).
// Ordering: grid_group::sync fences at device scope (__threadfence) on
// both sides of its barrier (cooperative_groups/details/sync.h on the
// card), so every atomic of phase 1 is visible to every thread in phase 2,
// and every OR of phase 2 in phase 3.  The reads of words other blocks
// change (first in phase 2, agree in phase 3) also bypass L1
// (ld.global.cg), so no stale line of an SM can stand in for them.
// A thread-block cluster of up to 8 blocks with cluster barriers is one
// launch as well, but the step then runs on at most 8 SMs, whose memory
// parallelism the rung's 16384 random-slot rows outrun: measured slower
// at the rung's batches and at the anchor's (PERF.md §6).
// OR and min do not depend on the order the rows land in, and nothing is
// a float, so the result is the same whatever the schedule.
//
// The sweep is one thread a slot with a warp and then a block reduction.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kAckThreads = 256;  // the sweep's block
constexpr int kStepThreads = 256;  // a block of the step's grid
constexpr int kStepRows = 8;  // rows a thread at most

constexpr int kBatchCols = 12;

constexpr uint8_t kCommitted = 1;
constexpr uint8_t kSlow = 2;
constexpr uint8_t kTickInert = 0;
constexpr uint8_t kTickSteady = 1;
constexpr uint8_t kTickPython = 2;

constexpr int32_t kFirstNone = 0x7fffffff;

// Row outputs (the host's OUT_* and NEWCOUNT_SHIFT).
constexpr int32_t kApplied = 1;
constexpr int32_t kFallback = 2;
constexpr int32_t kDropped = 4;
constexpr int32_t kAdopt = 8;
constexpr int32_t kWeak = 16;
constexpr int32_t kStrong = 32;
constexpr int kCountShift = 8;

// A row's class between the phases, in the low byte of its register (the
// count before the batch from bit 8); phase 2 replaces it with the row's
// output bits.
constexpr int32_t kRowCommitted = 1;
constexpr int32_t kRowSlow = 2;
constexpr int32_t kRowVirgin = 4;
constexpr int32_t kRowForeign = 8;

// Every thread of the grid arrives, then waits for all the others
// (cooperative_groups' grid_group::sync: a fence at device scope, then an
// atomic barrier in global memory, then a fence again; see the note
// above).
__device__ __forceinline__ void grid_sync() {
  cooperative_groups::this_grid().sync();
}

__device__ __forceinline__ int slot_count(const uint32_t* masks, int limbs) {
  int count = 0;
  for (int l = 0; l < limbs; ++l) count += __popc(masks[l]);
  return count;
}

__global__ void __launch_bounds__(kStepThreads)
mirbft_ack_step_kernel(const int32_t* __restrict__ batch, uint32_t* agree,
                       uint32_t* nonnull, uint32_t* canon, uint8_t* canon_ok,
                       const uint8_t* __restrict__ flags,
                       const uint8_t* __restrict__ held, uint8_t* tick,
                       int32_t* first, int32_t* __restrict__ out, int rows,
                       int c_pad, int w_pad, int limbs, int weak_q,
                       int strong_q) {
  // Row r's slot, or -1 for a row that is not valid or names no client.
  auto row_slot = [&](int r) -> int {
    const int32_t* row = batch + static_cast<int64_t>(r) * kBatchCols;
    const int ci = row[0], w = row[1], valid = row[3];
    return (!valid || ci < 0 || ci >= c_pad) ? -1 : ci * w_pad + w;
  };

  // Phase 1 for row r of slot s (s >= 0): its class and the slot's count
  // before the batch; a live row on a virgin slot offers r to `first`.
  auto classify = [&](int r, int s) -> int32_t {
    const int src = batch[static_cast<int64_t>(r) * kBatchCols + 2];
    // Every read of the slot at once, before the class decides which
    // matter: one round trip to memory, not three.
    const int limb = min(src >> 5, limbs - 1);
    const uint32_t bit = 1u << (src & 31);
    const uint32_t* a = agree + static_cast<int64_t>(s) * limbs;
    const uint8_t fl = flags[s];
    const bool virgin = !canon_ok[s];
    const bool dup = (a[limb] & bit) != 0;
    const bool voted = (nonnull[static_cast<int64_t>(s) * limbs + limb] &
                        bit) != 0;
    const int count = slot_count(a, limbs);
    if (fl & kCommitted) return kRowCommitted;
    if (fl & kSlow) return kRowSlow;
    if (virgin) atomicMin(first + s, r);
    return (virgin ? kRowVirgin : 0) | (!dup && voted ? kRowForeign : 0) |
           count << kCountShift;
  };

  // Phase 2 for row r of slot s: adoption, the digest check and the OR;
  // returns `bits` with its class byte replaced by the row's output bits.
  auto apply = [&](int r, int s, int32_t bits) -> int32_t {
    const int32_t cls = bits & 0xff;
    int32_t result = 0;
    if (s < 0) {
      result = 0;
    } else if (cls & kRowCommitted) {
      result = kDropped;
    } else if (cls & kRowSlow) {
      result = kFallback;
    } else {
      const int32_t* row = batch + static_cast<int64_t>(r) * kBatchCols;
      const uint32_t* dig = reinterpret_cast<const uint32_t*>(row + 4);
      bool match = true;
      uint32_t* slot_canon = canon + static_cast<int64_t>(s) * 8;
      if (cls & kRowVirgin) {
        const int winner = __ldcg(first + s);
        const uint32_t* won = reinterpret_cast<const uint32_t*>(
            batch + static_cast<int64_t>(winner) * kBatchCols + 4);
        for (int j = 0; j < 8; ++j) match &= dig[j] == won[j];
        if (winner == r) {
          for (int j = 0; j < 8; ++j) slot_canon[j] = dig[j];
          canon_ok[s] = 1;
          result |= kAdopt;
        }
      } else {
        for (int j = 0; j < 8; ++j) match &= dig[j] == slot_canon[j];
      }
      if (match && !(cls & kRowForeign)) {
        const int src = row[2];
        const int64_t at = static_cast<int64_t>(s) * limbs +
                           min(src >> 5, limbs - 1);
        const uint32_t bit = 1u << (src & 31);
        atomicOr(agree + at, bit);
        atomicOr(nonnull + at, bit);
        result |= kApplied;
      } else {
        result |= kFallback;
      }
    }
    return (bits & ~0xff) | result;
  };

  // Phase 3 for row r of slot s: the count after, the crossings, the
  // tick, and the row's output.
  auto finish = [&](int r, int s, int32_t bits) {
    int32_t result = bits & 0xff;
    if (result & kAdopt) first[s] = kFirstNone;
    if (result & kApplied) {
      const int before = bits >> kCountShift;
      const uint32_t* a = agree + static_cast<int64_t>(s) * limbs;
      int after = 0;
      for (int l = 0; l < limbs; ++l) after += __popc(__ldcg(a + l));
      if (before < weak_q && after >= weak_q) result |= kWeak;
      if (before < strong_q && after >= strong_q) result |= kStrong;
      tick[s] = held[s] ? kTickSteady
                        : (after >= weak_q ? kTickPython : kTickInert);
      result |= after << kCountShift;
    }
    out[r] = result;
  };

  const int threads = gridDim.x * blockDim.x;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  // A thread's first kStepRows rows keep their slot and class in
  // registers; its rows past them (a batch of more than kStepRows rows
  // for every thread of the grid) keep their class in their own word of
  // `out` between the phases and read their slot from the batch again.
  const int64_t past = t + static_cast<int64_t>(kStepRows) * threads;
  int slot[kStepRows];
  int32_t bits[kStepRows];

  // -- 1. classify ----------------------------------------------------------
#pragma unroll
  for (int k = 0; k < kStepRows; ++k) {
    const int r = t + k * threads;
    slot[k] = r < rows ? row_slot(r) : -1;
    bits[k] = slot[k] >= 0 ? classify(r, slot[k]) : 0;
  }
  for (int64_t r = past; r < rows; r += threads) {
    const int s = row_slot(r);
    out[r] = s >= 0 ? classify(r, s) : 0;
  }
  grid_sync();

  // -- 2. apply -------------------------------------------------------------
#pragma unroll
  for (int k = 0; k < kStepRows; ++k) {
    const int r = t + k * threads;
    if (r < rows) bits[k] = apply(r, slot[k], bits[k]);
  }
  for (int64_t r = past; r < rows; r += threads) {
    out[r] = apply(r, row_slot(r), out[r]);
  }
  grid_sync();

  // -- 3. finish ------------------------------------------------------------
#pragma unroll
  for (int k = 0; k < kStepRows; ++k) {
    const int r = t + k * threads;
    if (r < rows) finish(r, slot[k], bits[k]);
  }
  for (int64_t r = past; r < rows; r += threads) {
    finish(r, row_slot(r), out[r]);
  }
}

// Nothing: the step's and the sweep's launch with no work, timed beside
// them as their floor.
__global__ void __launch_bounds__(kStepThreads) mirbft_ack_empty_kernel() {}

// The three totals of a slot, packed 10 bits each: a block of 256 slots
// sums to at most 256 in each field.
__device__ __forceinline__ uint32_t pack_totals(bool weak, bool strong,
                                                bool committed) {
  return static_cast<uint32_t>(weak) | static_cast<uint32_t>(strong) << 10 |
         static_cast<uint32_t>(committed) << 20;
}

__global__ void __launch_bounds__(kAckThreads)
mirbft_ack_sweep_kernel(const uint32_t* __restrict__ agree,
                        const uint8_t* __restrict__ canon_ok,
                        const uint8_t* __restrict__ flags,
                        const uint8_t* __restrict__ held,
                        uint8_t* __restrict__ tick,
                        uint32_t* __restrict__ totals, int total, int limbs,
                        int weak_q, int strong_q) {
  __shared__ uint32_t warp_sums[kAckThreads / 32];
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t packed = 0;
  if (s < total) {
    // Only a live slot's masks and held byte are read, and canon_ok only
    // where no flag is set.
    const uint8_t fl = flags[s];
    const bool committed = (fl & kCommitted) != 0;
    bool weak = false, strong = false;
    if (fl == 0 && canon_ok[s]) {
      const int count =
          slot_count(agree + static_cast<int64_t>(s) * limbs, limbs);
      weak = count >= weak_q;
      strong = count >= strong_q;
      tick[s] = held[s] ? kTickSteady : (weak ? kTickPython : kTickInert);
    } else if (committed) {
      tick[s] = kTickInert;
    }
    packed = pack_totals(weak, strong, committed);
  }
  for (int delta = 16; delta > 0; delta >>= 1) {
    packed += __shfl_down_sync(0xffffffffu, packed, delta);
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_sums[warp] = packed;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t sum = 0;
    for (int i = 0; i < kAckThreads / 32; ++i) sum += warp_sums[i];
    if (sum & 0x3ffu) atomicAdd(totals, sum & 0x3ffu);
    if ((sum >> 10) & 0x3ffu) atomicAdd(totals + 1, (sum >> 10) & 0x3ffu);
    if (sum >> 20) atomicAdd(totals + 2, sum >> 20);
  }
}

}  // namespace

// The step's grid for `rows` rows: blocks of kStepThreads, one a row up
// to the most blocks of the step the card holds at once (a cooperative
// launch needs every block resident), then more rows a thread.  Returns
// the block count, or a negative cudaError_t.
static int step_blocks(int rows) {
  static int resident = 0;  // blocks of the step the card holds at once
  if (resident == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, reinterpret_cast<const void*>(mirbft_ack_step_kernel),
          kStepThreads, 0);
    }
    if (err != cudaSuccess) return -static_cast<int>(err);
    if (sms * per_sm == 0) return -static_cast<int>(cudaErrorInvalidValue);
    resident = sms * per_sm;
  }
  const int blocks = (rows + kStepThreads - 1) / kStepThreads;
  return blocks < resident ? blocks : resident;
}

template <typename Kernel>
static int launch_step_grid(Kernel kernel, int rows, cudaStream_t s,
                            void** args) {
  const int blocks = step_blocks(rows);
  if (blocks < 0) return -blocks;
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(blocks), dim3(kStepThreads),
      args, 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Launch the step on `stream`: one cooperative kernel launch.  Returns the
// launch's cudaError_t (0 on success); nothing is synchronised.
extern "C" int mirbft_ack_step(const void* batch, void* agree, void* nonnull,
                               void* canon, void* canon_ok, const void* flags,
                               const void* held, void* tick, void* first,
                               void* out, int rows, int c_pad, int w_pad,
                               int limbs, int weak_q, int strong_q,
                               void* stream) {
  if (rows <= 0) return 0;
  void* args[] = {&batch, &agree, &nonnull, &canon, &canon_ok, &flags,
                  &held, &tick, &first, &out, &rows, &c_pad, &w_pad,
                  &limbs, &weak_q, &strong_q};
  return launch_step_grid(mirbft_ack_step_kernel, rows,
                          static_cast<cudaStream_t>(stream), args);
}

// The step's grid at `rows` rows: its threads, and the rows a thread
// keeps in registers (rows past threads * register_rows take `out`).
extern "C" int mirbft_ack_step_grid(int rows, int* threads,
                                    int* register_rows) {
  const int blocks = step_blocks(rows < 1 ? 1 : rows);
  if (blocks < 0) return -blocks;
  *threads = blocks * kStepThreads;
  *register_rows = kStepRows;
  return 0;
}

// The empty kernel launched as the step would be at `rows` rows: the
// step's cooperative grid.
extern "C" int mirbft_ack_empty(int rows, void* stream) {
  void* none[] = {nullptr};
  return launch_step_grid(mirbft_ack_empty_kernel, rows < 1 ? 1 : rows,
                          static_cast<cudaStream_t>(stream), none);
}

// The empty kernel launched as the sweep is over `total` slots: an
// ordinary launch of the sweep's grid and block.  (The sweep's launcher
// also queues a 12-byte memset of its totals first; that is its work.)
extern "C" int mirbft_ack_sweep_empty(int total, void* stream) {
  const int grid = total < 1 ? 1 : (total + kAckThreads - 1) / kAckThreads;
  mirbft_ack_empty_kernel<<<grid, kAckThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mirbft_ack_sweep(const void* agree, const void* canon_ok,
                                const void* flags, const void* held,
                                void* tick, void* totals, int total,
                                int limbs, int weak_q, int strong_q,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(totals, 0, 3 * sizeof(uint32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (total <= 0) return 0;
  const int grid = (total + kAckThreads - 1) / kAckThreads;
  mirbft_ack_sweep_kernel<<<grid, kAckThreads, 0, s>>>(
      static_cast<const uint32_t*>(agree),
      static_cast<const uint8_t*>(canon_ok),
      static_cast<const uint8_t*>(flags), static_cast<const uint8_t*>(held),
      static_cast<uint8_t*>(tick), static_cast<uint32_t*>(totals), total,
      limbs, weak_q, strong_q);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mirbft_ack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
