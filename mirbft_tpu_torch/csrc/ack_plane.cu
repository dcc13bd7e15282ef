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
// A shard's view (the JAX program's shard_map over the client axis): the
// state is one block of a mesh's plane, clients ci0 .. ci0 + c_pad - 1 of
// it, and the batch is the whole batch.  A row whose client falls outside
// the block touches nothing and its output word is exactly 0 (each of its
// bits is the JAX program's `mine & ...`), so the shards' outputs summed
// (the port's psum, csrc/parallel.cu shard_sum) give each row its owner's
// word.  With ci0 = 0 and the whole plane as the block, the step is the
// one-device step.
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
// The sweep (device_quorum_sweep) reads the whole plane once: per slot
// its flags, canon_ok, held and tick bytes and, for a live slot, its vote
// masks; it rewrites the tick and sums three totals.  At the ack-plane
// rung's plane (262,144 slots, one limb) that is about 1 MB, in L2 after
// the step, and its byte bound is 0.3 us: what a launch costs on its own
// (about 5 us, timed as `empty_sweep`) is most of its time, and the design
// queues nothing but the one launch.
//   - A thread takes a group of kSweepSlots = 8 consecutive slots: one
//     8-byte load of each byte array, the group's masks as 16-byte loads
//     where a slot has 1, 2 or 4 limbs (scalar limbs otherwise), and one
//     8-byte store of the group's ticks.  The first port's thread a slot
//     issued a one-byte load a slot and an array.  Blocks of
//     kSweepThreads = 256 then give the rung's plane 128 blocks, about one
//     for each of the card's 132 SMs: the grid covers the card in one
//     wave, each thread's loads all in flight at once.  Why 8 and not 16:
//     at one block an SM the arithmetic of a thread's slots is a chain the
//     SM cannot hide, and 16 slots a thread in blocks of 128 (the same
//     grid, half the threads) took 0.0080 ms against 0.0074-0.0075 for 8
//     in blocks of 256 and for 4 in blocks of 512 (PERF.md §6,
//     tests/compare_sweep.py; 16 and 4 still build, for that script).  A
//     plane past kSweepMaxBlocks blocks takes a grid-stride loop.  A plane
//     that ends inside a group finishes it slot by slot, and a plane whose
//     byte arrays do not start on a group's bytes runs slot by slot
//     throughout: the same kernel, byte loads.
//   - Per-block counts are full 32-bit words (a block's counts reach
//     thousands; the first port packed them 10 bits each for 256 slots a
//     block): a warp shuffle, then a word a warp in shared memory.
//   - The totals need no memset and no atomic: each block writes its three
//     partials to its own words of a scratch (so the scratch needs no
//     zeroing) and draws a ticket with one atomic add on a
//     counter, acquire-release at device scope (`draw_ticket`).  The block
//     that draws the last ticket (every other block's partials are then
//     visible: each was released by its add) sums the partials, stores the
//     totals and puts the counter back to 0.  So the counter is 0 before
//     every sweep and is zeroed once, when the wrapper first makes it (with
//     the partials, one scratch for a device and a stream), never per
//     call.  Two sweeps cannot race on it: sweeps on one stream run one
//     after another, and the wrapper keeps one scratch a stream.  The first port
//     queued a memset of the totals and then up to three atomics a block
//     on the same three words (3072 at the rung, serialised at one L2
//     slice).  A cooperative launch with a grid barrier would do as well
//     without the ticket, but the step's grid barriers cost it 2.2-2.8x an
//     empty launch (PERF.md §6); the ticket is one atomic a block.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kStepThreads = 256;  // a block of the step's grid
constexpr int kStepRows = 8;  // rows a thread at most

constexpr int kSweepThreads = 256;  // a block of the sweep's grid
constexpr int kSweepSlots = 8;  // slots a thread (16 and 4 build too)
constexpr int kSweepMaxBlocks = 1024;  // past it, a grid-stride loop

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

// The sweep's ticket: one atomic add at device scope with acquire-release
// order (PTX atom.acq_rel.gpu).  Release: the calling thread's stores
// before it (its block's partials) are visible to any thread that
// acquires a later ticket.  Acquire: the caller sees the partials of
// every block that drew an earlier one.  Returns the ticket drawn.
__device__ __forceinline__ uint32_t draw_ticket(uint32_t* ticket) {
  uint32_t drawn;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
               : "=r"(drawn)
               : "l"(ticket)
               : "memory");
  return drawn;
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
                       int ci0, int c_pad, int w_pad, int limbs, int weak_q,
                       int strong_q) {
  // Row r's slot in the block, or -1 for a row that is not valid or names
  // no client of the block (no state, class 0, output word 0).
  auto row_slot = [&](int r) -> int {
    const int32_t* row = batch + static_cast<int64_t>(r) * kBatchCols;
    const int ci = row[0] - ci0, w = row[1], valid = row[3];
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
__global__ void mirbft_ack_empty_kernel() {}

// -- the sweep ------------------------------------------------------------

struct SweepCounts {
  uint32_t weak = 0, strong = 0, committed = 0;
};

// Byte j and word k of a vector of 4, 8 or 16 bytes; with j and k known
// at compile time (unrolled loops) both fold to a shift of a register.
__device__ __forceinline__ uint32_t word_at(const uint4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}
__device__ __forceinline__ uint32_t word_at(const uint2& v, int k) {
  return k == 0 ? v.x : v.y;
}
__device__ __forceinline__ uint32_t word_at(uint32_t v, int) { return v; }
template <class Vec>
__device__ __forceinline__ uint32_t byte_at(const Vec& v, int j) {
  return (word_at(v, j >> 2) >> (8 * (j & 3))) & 0xffu;
}
__device__ __forceinline__ uint4 from_words(const uint32_t* w, uint4*) {
  return make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ uint2 from_words(const uint32_t* w, uint2*) {
  return make_uint2(w[0], w[1]);
}
__device__ __forceinline__ uint32_t from_words(const uint32_t* w, uint32_t*) {
  return w[0];
}

// A group's bytes of one byte array: one vector load.
using SweepBytes = std::conditional_t<
    kSweepSlots == 16, uint4,
    std::conditional_t<kSweepSlots == 8, uint2, uint32_t>>;
static_assert(sizeof(SweepBytes) == kSweepSlots,
              "a group is 4, 8 or 16 slots");

__device__ __forceinline__ bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// A slot's new tick from its flags, canon_ok, held and tick bytes and its
// vote count (read only for a live slot), counted into `c`.
__device__ __forceinline__ uint32_t sweep_slot(uint32_t fl, uint32_t ok,
                                               uint32_t hd, uint32_t tk,
                                               int count, int weak_q,
                                               int strong_q, SweepCounts& c) {
  if (fl == 0 && ok) {
    const bool weak = count >= weak_q;
    c.weak += weak;
    c.strong += count >= strong_q;
    return hd ? kTickSteady : (weak ? kTickPython : kTickInert);
  }
  if (fl & kCommitted) {
    c.committed += 1;
    return kTickInert;
  }
  return tk;
}

struct SweepPlane {
  const uint32_t* agree;
  const uint8_t* canon_ok;
  const uint8_t* flags;
  const uint8_t* held;
  uint8_t* tick;
  int64_t total;
  int limbs, weak_q, strong_q;
};

// Slot s by byte loads: the tail of a plane that is not a whole group, and
// every slot of a plane whose byte arrays are not aligned to a group.  Reads
// a live slot's masks and held byte only, and writes the tick only where
// it changes class (live or committed).
__device__ __forceinline__ void sweep_one(const SweepPlane& p, int64_t s,
                                          SweepCounts& c) {
  const uint32_t fl = p.flags[s];
  const bool live = fl == 0 && p.canon_ok[s];
  if (!live && !(fl & kCommitted)) return;
  const int count = live ? slot_count(p.agree + s * p.limbs, p.limbs) : 0;
  p.tick[s] = static_cast<uint8_t>(
      sweep_slot(fl, live, live && p.held[s], 0, count, p.weak_q,
                 p.strong_q, c));
}

// The kSweepSlots slots from `base` (aligned to the group in every byte
// array) by vector loads: one load of kSweepSlots bytes from each byte
// array, the group's masks as 16-byte loads where kLimbs is 1, 2 or 4 (the
// group's kSweepSlots * kLimbs words start on a 32-byte boundary at
// least) and as a live slot's scalar limbs where kLimbs is 0 (any other
// count, p.limbs), and one store of the new ticks (a slot that keeps its
// class gets back the byte it had).
template <int kLimbs>
__device__ __forceinline__ void sweep_group(const SweepPlane& p, int64_t base,
                                            SweepCounts& c) {
  const SweepBytes fl =
      __ldg(reinterpret_cast<const SweepBytes*>(p.flags + base));
  const SweepBytes ok =
      __ldg(reinterpret_cast<const SweepBytes*>(p.canon_ok + base));
  const SweepBytes hd =
      __ldg(reinterpret_cast<const SweepBytes*>(p.held + base));
  const SweepBytes tk = *reinterpret_cast<const SweepBytes*>(p.tick + base);
  uint32_t out[kSweepSlots / 4] = {};
  auto put = [&](int j, int count) {
    out[j >> 2] |= sweep_slot(byte_at(fl, j), byte_at(ok, j), byte_at(hd, j),
                              byte_at(tk, j), count, p.weak_q, p.strong_q, c)
                   << (8 * (j & 3));
  };
  if constexpr (kLimbs == 0) {
    // A slot at a time: its limbs are read only if it is live, and one
    // count is held at once (all of a group's held across the reads
    // spilled).
#pragma unroll
    for (int j = 0; j < kSweepSlots; ++j) {
      const bool live = byte_at(fl, j) == 0 && byte_at(ok, j);
      put(j, live ? slot_count(p.agree + (base + j) * p.limbs, p.limbs) : 0);
    }
  } else {
    int count[kSweepSlots];
#pragma unroll
    for (int j = 0; j < kSweepSlots; ++j) count[j] = 0;
    const uint4* masks =
        reinterpret_cast<const uint4*>(p.agree + base * kLimbs);
#pragma unroll
    for (int q = 0; q < kSweepSlots * kLimbs / 4; ++q) {
      const uint4 w = __ldg(masks + q);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        count[(4 * q + k) / kLimbs] += __popc(word_at(w, k));
      }
    }
#pragma unroll
    for (int j = 0; j < kSweepSlots; ++j) put(j, count[j]);
  }
  SweepBytes* ticks = reinterpret_cast<SweepBytes*>(p.tick + base);
  *ticks = from_words(out, ticks);
}

// This thread's groups, grid-stride: whole groups by `sweep_group<kLimbs>`,
// the last group, if the plane ends inside it, slot by slot.
template <int kLimbs>
__device__ __forceinline__ void sweep_groups(const SweepPlane& p,
                                             SweepCounts& c) {
  const int64_t groups = (p.total + kSweepSlots - 1) / kSweepSlots;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t g = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       g < groups; g += stride) {
    const int64_t base = g * kSweepSlots;
    if (base + kSweepSlots <= p.total) {
      sweep_group<kLimbs>(p, base, c);
    } else {
      for (int64_t s = base; s < p.total; ++s) sweep_one(p, s, c);
    }
  }
}

// The block's three counts, summed into thread 0's (a warp shuffle, then
// one word a warp in shared memory).  Every thread of the block calls it.
__device__ __forceinline__ SweepCounts block_sum(SweepCounts c) {
  __shared__ uint32_t warp_sums[kSweepThreads / 32][3];
  for (int delta = 16; delta > 0; delta >>= 1) {
    c.weak += __shfl_down_sync(0xffffffffu, c.weak, delta);
    c.strong += __shfl_down_sync(0xffffffffu, c.strong, delta);
    c.committed += __shfl_down_sync(0xffffffffu, c.committed, delta);
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) {
    warp_sums[warp][0] = c.weak;
    warp_sums[warp][1] = c.strong;
    warp_sums[warp][2] = c.committed;
  }
  __syncthreads();
  SweepCounts sum;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kSweepThreads / 32; ++i) {
      sum.weak += warp_sums[i][0];
      sum.strong += warp_sums[i][1];
      sum.committed += warp_sums[i][2];
    }
  }
  __syncthreads();  // warp_sums is free again for a later call
  return sum;
}

__global__ void __launch_bounds__(kSweepThreads)
mirbft_ack_sweep_kernel(SweepPlane p, uint32_t* __restrict__ partials,
                        uint32_t* ticket, uint32_t* __restrict__ totals) {
  __shared__ bool last;
  SweepCounts c;
  const bool vec = aligned(p.canon_ok, kSweepSlots) &&
                   aligned(p.flags, kSweepSlots) &&
                   aligned(p.held, kSweepSlots) && aligned(p.tick, kSweepSlots);
  const bool vec_masks = vec && aligned(p.agree, 16);
  if (!vec) {
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t s = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                     threadIdx.x;
         s < p.total; s += stride) {
      sweep_one(p, s, c);
    }
  } else if (vec_masks && p.limbs == 1) {
    sweep_groups<1>(p, c);
  } else if (vec_masks && p.limbs == 2) {
    sweep_groups<2>(p, c);
  } else if (vec_masks && p.limbs == 4) {
    sweep_groups<4>(p, c);
  } else {
    sweep_groups<0>(p, c);
  }
  const SweepCounts block = block_sum(c);
  // The block's partials, then its ticket (release: the partials are
  // stored before it lands).  The block that draws the last ticket has
  // acquired every other block's partials; the barrier passes that on to
  // its other threads, which read them past L1.
  if (threadIdx.x == 0) {
    partials[3 * blockIdx.x] = block.weak;
    partials[3 * blockIdx.x + 1] = block.strong;
    partials[3 * blockIdx.x + 2] = block.committed;
    last = draw_ticket(ticket) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  SweepCounts sum;
  for (unsigned b = threadIdx.x; b < gridDim.x; b += blockDim.x) {
    sum.weak += __ldcg(partials + 3 * b);
    sum.strong += __ldcg(partials + 3 * b + 1);
    sum.committed += __ldcg(partials + 3 * b + 2);
  }
  const SweepCounts all = block_sum(sum);
  if (threadIdx.x == 0) {
    totals[0] = all.weak;
    totals[1] = all.strong;
    totals[2] = all.committed;
    *ticket = 0;  // every block has drawn: the next sweep starts from 0
  }
}

// The sweep's grid over `total` slots: a thread a group of kSweepSlots,
// blocks of kSweepThreads, at most kSweepMaxBlocks (a grid-stride loop
// takes larger planes), at least one (it writes the totals).
inline int sweep_blocks(int64_t total) {
  const int64_t groups = (total + kSweepSlots - 1) / kSweepSlots;
  const int64_t blocks = (groups + kSweepThreads - 1) / kSweepThreads;
  return static_cast<int>(blocks < 1 ? 1
                          : blocks > kSweepMaxBlocks ? kSweepMaxBlocks
                                                     : blocks);
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

// Launch the step on `stream`: one cooperative kernel launch, on the block
// of clients ci0 .. ci0 + c_pad - 1.  Returns the launch's cudaError_t (0
// on success); nothing is synchronised.
extern "C" int mirbft_ack_step(const void* batch, void* agree, void* nonnull,
                               void* canon, void* canon_ok, const void* flags,
                               const void* held, void* tick, void* first,
                               void* out, int rows, int ci0, int c_pad,
                               int w_pad, int limbs, int weak_q, int strong_q,
                               void* stream) {
  if (rows <= 0) return 0;
  void* args[] = {&batch, &agree, &nonnull, &canon, &canon_ok, &flags,
                  &held, &tick, &first, &out, &rows, &ci0, &c_pad, &w_pad,
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

// The sweep's grid over `total` slots: its blocks (the wrapper's scratch
// holds three partials a block), threads a block and slots a thread.
extern "C" int mirbft_ack_sweep_grid(int total, int* blocks, int* threads,
                                     int* slots) {
  *blocks = sweep_blocks(total);
  *threads = kSweepThreads;
  *slots = kSweepSlots;
  return 0;
}

// The empty kernel launched as the sweep is over `total` slots: an
// ordinary launch of the sweep's grid and block.
extern "C" int mirbft_ack_sweep_empty(int total, void* stream) {
  mirbft_ack_empty_kernel<<<sweep_blocks(total), kSweepThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// Launch the sweep on `stream`: one kernel launch, nothing else queued.
// `partials` holds 3 * mirbft_ack_sweep_grid's blocks uint32 (any
// contents); `ticket` one uint32, 0 before the launch and 0 again after
// it.  Returns the launch's cudaError_t (0 on success).
extern "C" int mirbft_ack_sweep(const void* agree, const void* canon_ok,
                                const void* flags, const void* held,
                                void* tick, void* totals, void* partials,
                                void* ticket, int total, int limbs,
                                int weak_q, int strong_q, void* stream) {
  const SweepPlane plane{
      static_cast<const uint32_t*>(agree),
      static_cast<const uint8_t*>(canon_ok),
      static_cast<const uint8_t*>(flags), static_cast<const uint8_t*>(held),
      static_cast<uint8_t*>(tick), total < 0 ? 0 : total, limbs, weak_q,
      strong_q};
  mirbft_ack_sweep_kernel<<<sweep_blocks(total), kSweepThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      plane, static_cast<uint32_t*>(partials),
      static_cast<uint32_t*>(ticket), static_cast<uint32_t*>(totals));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mirbft_ack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
