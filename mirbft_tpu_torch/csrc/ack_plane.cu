// The device ack plane's two programs for sm_90a: the step that absorbs
// one ack batch into the dense slot state, and the quorum sweep.
//
// They compute what the JAX package's two XLA programs compute
// (mirbft_tpu/core/device_tracker.py: device_ack_step, device_quorum_sweep),
// row for row and bit for bit, without their sort-based structure: the
// step is one thread a row in three launches on one stream, the sweep one
// thread a slot with a warp and then a block reduction.
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
// The step's order is what its launches are for:
//   1. classify: each valid row finds its slot and its class, reads the
//      masks as they were before the batch (the spam guard's dup and
//      foreign bits, the count before) into per-row scratch, and a live
//      row on a virgin slot offers its index to the slot's adoption
//      scratch with atomicMin;
//   2. apply: the lowest index offered to a virgin slot adopts its digest,
//      every live row of that slot is held against the adopter's digest
//      (read from the batch, so no row waits for the write), live rows of
//      other slots against the slot's canonical digest; a matching row
//      with no foreign vote ORs its bit into both masks with atomicOr;
//   3. finish: once every row's OR has landed, each applied row counts its
//      slot's votes, reports the crossings and rewrites the slot's tick
//      (every applied row of a slot writes the same class); the adopter
//      empties the slot's adoption scratch for the next batch.
// OR and min do not depend on the order the rows land in, and nothing is
// a float, so the result is the same whatever the schedule.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kAckThreads = 256;
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

// Per-row scratch between the launches: the slot (-1 for a row that is
// not the plane's), and class bits with the count before the batch.
constexpr int32_t kRowCommitted = 1;
constexpr int32_t kRowSlow = 2;
constexpr int32_t kRowVirgin = 4;
constexpr int32_t kRowForeign = 8;

__device__ __forceinline__ int slot_count(const uint32_t* masks, int limbs) {
  int count = 0;
  for (int l = 0; l < limbs; ++l) count += __popc(masks[l]);
  return count;
}

__global__ void __launch_bounds__(kAckThreads)
mirbft_ack_classify_kernel(const int32_t* __restrict__ batch,
                           const uint32_t* __restrict__ agree,
                           const uint32_t* __restrict__ nonnull,
                           const uint8_t* __restrict__ canon_ok,
                           const uint8_t* __restrict__ flags,
                           int32_t* first, int32_t* __restrict__ scratch,
                           int rows, int c_pad, int w_pad, int limbs) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const int32_t* row = batch + static_cast<int64_t>(r) * kBatchCols;
  const int ci = row[0], w = row[1], src = row[2], valid = row[3];
  if (!valid || ci < 0 || ci >= c_pad) {
    scratch[2 * r] = -1;
    scratch[2 * r + 1] = 0;
    return;
  }
  const int slot = ci * w_pad + w;
  const uint8_t fl = flags[slot];
  int32_t bits = 0;
  if (fl & kCommitted) {
    bits = kRowCommitted;
  } else if (fl & kSlow) {
    bits = kRowSlow;
  } else {
    if (!canon_ok[slot]) {
      bits |= kRowVirgin;
      atomicMin(first + slot, r);
    }
    const int limb = min(src >> 5, limbs - 1);
    const uint32_t bit = 1u << (src & 31);
    const uint32_t* a = agree + static_cast<int64_t>(slot) * limbs;
    const uint32_t* n = nonnull + static_cast<int64_t>(slot) * limbs;
    const bool dup = (a[limb] & bit) != 0;
    if (!dup && (n[limb] & bit)) bits |= kRowForeign;
    bits |= slot_count(a, limbs) << kCountShift;
  }
  scratch[2 * r] = slot;
  scratch[2 * r + 1] = bits;
}

__global__ void __launch_bounds__(kAckThreads)
mirbft_ack_apply_kernel(const int32_t* __restrict__ batch, uint32_t* agree,
                        uint32_t* nonnull, uint32_t* canon, uint8_t* canon_ok,
                        const int32_t* first,
                        const int32_t* __restrict__ scratch,
                        int32_t* __restrict__ out, int rows, int limbs) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const int slot = scratch[2 * r];
  const int32_t bits = scratch[2 * r + 1];
  if (slot < 0) {
    out[r] = 0;
    return;
  }
  if (bits & kRowCommitted) {
    out[r] = kDropped;
    return;
  }
  if (bits & kRowSlow) {
    out[r] = kFallback;
    return;
  }
  const int32_t* row = batch + static_cast<int64_t>(r) * kBatchCols;
  const uint32_t* dig = reinterpret_cast<const uint32_t*>(row + 4);
  bool match = true;
  int32_t result = 0;
  uint32_t* slot_canon = canon + static_cast<int64_t>(slot) * 8;
  if (bits & kRowVirgin) {
    const int winner = first[slot];
    const uint32_t* won = reinterpret_cast<const uint32_t*>(
        batch + static_cast<int64_t>(winner) * kBatchCols + 4);
    for (int k = 0; k < 8; ++k) match &= dig[k] == won[k];
    if (winner == r) {
      for (int k = 0; k < 8; ++k) slot_canon[k] = dig[k];
      canon_ok[slot] = 1;
      result |= kAdopt;
    }
  } else {
    for (int k = 0; k < 8; ++k) match &= dig[k] == slot_canon[k];
  }
  if (match && !(bits & kRowForeign)) {
    const int src = row[2];
    const int64_t at = static_cast<int64_t>(slot) * limbs +
                       min(src >> 5, limbs - 1);
    const uint32_t bit = 1u << (src & 31);
    atomicOr(agree + at, bit);
    atomicOr(nonnull + at, bit);
    result |= kApplied;
  } else {
    result |= kFallback;
  }
  out[r] = result;
}

__global__ void __launch_bounds__(kAckThreads)
mirbft_ack_finish_kernel(const uint32_t* __restrict__ agree,
                         const uint8_t* __restrict__ held,
                         uint8_t* __restrict__ tick, int32_t* first,
                         const int32_t* __restrict__ scratch,
                         int32_t* __restrict__ out, int rows, int limbs,
                         int weak_q, int strong_q) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  int32_t result = out[r];
  const int slot = scratch[2 * r];
  if (result & kAdopt) first[slot] = kFirstNone;
  if (!(result & kApplied)) return;
  const int before = scratch[2 * r + 1] >> kCountShift;
  const int after =
      slot_count(agree + static_cast<int64_t>(slot) * limbs, limbs);
  if (before < weak_q && after >= weak_q) result |= kWeak;
  if (before < strong_q && after >= strong_q) result |= kStrong;
  tick[slot] = held[slot] ? kTickSteady
                          : (after >= weak_q ? kTickPython : kTickInert);
  out[r] = result | (after << kCountShift);
}

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

extern "C" int mirbft_ack_step(const void* batch, void* agree, void* nonnull,
                               void* canon, void* canon_ok, const void* flags,
                               const void* held, void* tick, void* first,
                               void* scratch, void* out, int rows, int c_pad,
                               int w_pad, int limbs, int weak_q, int strong_q,
                               void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (rows + kAckThreads - 1) / kAckThreads;
  const int32_t* b = static_cast<const int32_t*>(batch);
  uint32_t* a = static_cast<uint32_t*>(agree);
  uint32_t* n = static_cast<uint32_t*>(nonnull);
  int32_t* f = static_cast<int32_t*>(first);
  int32_t* sc = static_cast<int32_t*>(scratch);
  int32_t* o = static_cast<int32_t*>(out);
  mirbft_ack_classify_kernel<<<grid, kAckThreads, 0, s>>>(
      b, a, n, static_cast<const uint8_t*>(canon_ok),
      static_cast<const uint8_t*>(flags), f, sc, rows, c_pad, w_pad, limbs);
  mirbft_ack_apply_kernel<<<grid, kAckThreads, 0, s>>>(
      b, a, n, static_cast<uint32_t*>(canon), static_cast<uint8_t*>(canon_ok),
      f, sc, o, rows, limbs);
  mirbft_ack_finish_kernel<<<grid, kAckThreads, 0, s>>>(
      a, static_cast<const uint8_t*>(held), static_cast<uint8_t*>(tick), f,
      sc, o, rows, limbs, weak_q, strong_q);
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
