"""Rehearse the port's CUDA kernels on the host, with g++, before a card
runs them.

Where the port is written there may be no ``nvcc``, so a kernel's first
chance to fail would be the card's.  This script compiles a source of
``mirbft_tpu_torch/csrc/`` as host C++17: a stub header defines
``__device__``, ``__global__`` and the other qualifiers away, and models a
block as host threads, one a CUDA thread.  ``__shfl_sync``,
``__reduce_max_sync`` and ``__syncwarp`` meet at a barrier of the threads
of one warp, ``__syncthreads`` at one of the block.  The source's PTX
helpers (``cp.async``, ``mbarrier``: the functions from ``smem_addr`` up to
``rotr`` in ``sha256.cu``) are cut out, and the stub's host versions stand
in for them.  Dynamic shared memory is a buffer a block.  The
``extern "C"`` launchers are cut off and a host main launches the kernels
itself.

    python3 tests/rehearse_cuda.py [ladder|sha256|decompress|ack|bls] [--rows N]

``ladder`` runs the quad ladder on rows it builds with the host oracle
(valid signatures, corrupted ones, the identity and a point of order 8 as
keys) and checks every verdict against the oracle; ``sha256`` runs both
digest bodies on ragged batches at several buckets against hashlib;
``decompress`` runs point decompression, a group of lanes a point, on the
decompression corpus (tests/ed25519_corpus.py) and on ragged row counts,
and checks (x, y, ok) against the oracle and, bit for bit, against the
plain version, and that no group past the rows writes; ``ack`` runs the
ack plane's step (one cooperative grid of blocks, every block's threads
at once, each thread a few rows, meeting at the grid barrier, on the
stub's host atomics) and sweep on seeded cases (tests/ack_plane_cases.py) and
checks the state, the row outputs and the sweep bit for bit against the
plain versions, and that the adoption scratch is empty after the step;
``bls`` runs the G1 aggregation, a group of host threads a certificate
(lane k runs product k of each layer, the products meet at the stub's
shuffles, the PTX carry chains are host functions), on the
seeded certificates of tests/bls_cases.py (edge cases, (4, 4), rung 4's
(4, 128), (64, 128) and (4, 256), and the widths 1, 85 and 200) and
checks its output bit for bit
against the plain version and its affine points against the host fold.
The thread counts of the kernels are cut to keep the host threads few (the
ladder's block to 2 quads, the decompress block to one warp, the
one-thread body's block to 16 rows, the specialised body's warps to 8
lanes, the ack plane's blocks to two warps; the BLS block stays one
warp, a certificate), so the rehearsal runs the
card's code at a smaller block than the card does.  Exit status 0 when every check passes.
``tests/test_torch_rehearse.py`` runs it under pytest.
"""

from __future__ import annotations

import argparse
import hashlib
import random
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

from ack_plane_cases import CERTIFIED_SLOTS, SWEEP_CASES

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CSRC = ROOT / "mirbft_tpu_torch" / "csrc"
IV_BYTES = bytes.fromhex(
    "6a09e667bb67ae853c6ef372a54ff53a510e527f9b05688c1f83d9ab5be0cd19"
)

STUB = r"""
#include <algorithm>
#include <atomic>
#include <memory>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
#define __shared__ static  // blocks run one after another
#define __constant__
struct uint4 { uint32_t x, y, z, w; };
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return uint4{a, b, c, d};
}
struct uint2 { uint32_t x, y; };
inline uint2 make_uint2(uint32_t a, uint32_t b) { return uint2{a, b}; }
struct Dim3 { unsigned x = 0, y = 0, z = 0; };
using std::min;
typedef int cudaError_t;

// A spinning barrier of a fixed number of threads.
struct SpinBarrier {
  explicit SpinBarrier(int n) : count(n), waiting(0), phase(0) {}
  void wait() {
    const int my = phase.load();
    if (waiting.fetch_add(1) + 1 == count) {
      waiting.store(0);
      phase.fetch_add(1);
    } else {
      while (phase.load() == my) std::this_thread::yield();
    }
  }
  int count;
  std::atomic<int> waiting, phase;
};

struct Block {
  Block(int threads, int warp, size_t smem_bytes)
      : bar(threads), slots(threads), smem(smem_bytes + 16) {
    for (int w = 0; w < threads; w += warp) {
      warps.emplace_back(new SpinBarrier(std::min(warp, threads - w)));
    }
  }
  SpinBarrier bar;
  std::vector<std::unique_ptr<SpinBarrier>> warps;
  std::vector<int64_t> slots;
  std::vector<unsigned char> smem;
};

inline Dim3 blockDim;
inline Dim3 gridDim;
inline int g_warp = 32;  // lanes a warp in this rehearsal
inline thread_local Dim3 threadIdx;
inline thread_local Dim3 blockIdx;
inline thread_local Block* g_block;

inline void __syncthreads() { g_block->bar.wait(); }
inline SpinBarrier& warp_bar() { return *g_block->warps[threadIdx.x / g_warp]; }
inline void __syncwarp(unsigned = 0xffffffffu) { warp_bar().wait(); }
template <class T> inline T __ldg(const T* p) { return *p; }
template <class T> inline T __ldcg(const T* p) {
  return __atomic_load_n(p, __ATOMIC_SEQ_CST);
}
inline int32_t __shfl_sync(unsigned, int32_t v, int src, int width = 32) {
  const int t = threadIdx.x, base = t - t % g_warp;
  g_block->slots[t] = v;
  warp_bar().wait();
  const int lane = t - base;
  const int got = static_cast<int32_t>(
      g_block->slots[base + (lane & ~(width - 1)) + (src & (width - 1))]);
  warp_bar().wait();
  return got;
}
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  const int t = threadIdx.x, base = t - t % g_warp;
  g_block->slots[t] = v;
  warp_bar().wait();
  unsigned m = 0;
  for (int i = base; i < base + g_warp && i < (int)blockDim.x; ++i) {
    m = std::max(m, static_cast<unsigned>(g_block->slots[i]));
  }
  warp_bar().wait();
  return m;
}
inline uint32_t __shfl_down_sync(unsigned, uint32_t v, int delta,
                                  int width = 32) {
  const int t = threadIdx.x, base = t - t % std::min(width, g_warp);
  g_block->slots[t] = v;
  warp_bar().wait();
  const int src = t + delta < base + std::min(width, g_warp) ? t + delta : t;
  const uint32_t got = static_cast<uint32_t>(g_block->slots[src]);
  warp_bar().wait();
  return got;
}
inline uint32_t __shfl_up_sync(unsigned, uint32_t v, int delta,
                                int width = 32) {
  const int t = threadIdx.x, base = t - t % std::min(width, g_warp);
  g_block->slots[t] = v;
  warp_bar().wait();
  const int src = t - delta >= base ? t - delta : t;
  const uint32_t got = static_cast<uint32_t>(g_block->slots[src]);
  warp_bar().wait();
  return got;
}
inline unsigned __ballot_sync(unsigned, bool pred) {
  const int t = threadIdx.x, base = t - t % g_warp;
  g_block->slots[t] = pred;
  warp_bar().wait();
  unsigned bits = 0;
  for (int i = base; i < base + g_warp && i < (int)blockDim.x; ++i) {
    if (g_block->slots[i]) bits |= 1u << (i - base);
  }
  warp_bar().wait();
  return bits;
}
inline uint32_t atomicAdd(uint32_t* p, uint32_t v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline int32_t atomicMin(int32_t* p, int32_t v) {
  int32_t old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (v < old && !__atomic_compare_exchange_n(p, &old, v, false,
                                                 __ATOMIC_SEQ_CST,
                                                 __ATOMIC_SEQ_CST)) {
  }
  return old;
}
inline uint32_t atomicOr(uint32_t* p, uint32_t v) {
  return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST);
}
inline int __popc(uint32_t v) { return __builtin_popcount(v); }

// The PTX carry chains of bls_g1.cu on the host.
inline void col_mac(uint32_t* c, uint32_t x, uint32_t y) {
  const uint64_t prod = static_cast<uint64_t>(x) * y;
  const uint64_t lo = static_cast<uint64_t>(c[0]) + static_cast<uint32_t>(prod);
  c[0] = static_cast<uint32_t>(lo);
  const uint64_t hi = static_cast<uint64_t>(c[1]) + (prod >> 32) + (lo >> 32);
  c[1] = static_cast<uint32_t>(hi);
  c[2] += static_cast<uint32_t>(hi >> 32);
}
inline void col_add(uint32_t* c, uint32_t lo, uint32_t hi) {
  const uint64_t s0 = static_cast<uint64_t>(c[0]) + lo;
  c[0] = static_cast<uint32_t>(s0);
  const uint64_t s1 = static_cast<uint64_t>(c[1]) + hi + (s0 >> 32);
  c[1] = static_cast<uint32_t>(s1);
  c[2] += static_cast<uint32_t>(s1 >> 32);
}
inline uint32_t add3(uint32_t* w, uint32_t lo, uint32_t hi) {
  const uint64_t s0 = static_cast<uint64_t>(w[0]) + lo;
  w[0] = static_cast<uint32_t>(s0);
  const uint64_t s1 = static_cast<uint64_t>(w[1]) + hi + (s0 >> 32);
  w[1] = static_cast<uint32_t>(s1);
  const uint64_t s2 = static_cast<uint64_t>(w[2]) + (s1 >> 32);
  w[2] = static_cast<uint32_t>(s2);
  return static_cast<uint32_t>(s2 >> 32);
}
inline uint32_t sub3(uint32_t* w, const uint32_t* b) {
  uint64_t borrow = 0;
  for (int j = 0; j < 3; ++j) {
    const uint64_t x = static_cast<uint64_t>(w[j]) - b[j] - borrow;
    w[j] = static_cast<uint32_t>(x);
    borrow = (x >> 32) & 1;
  }
  return static_cast<uint32_t>(borrow);
}
inline void add12(uint32_t* r, const uint32_t* b) {
  uint64_t c = 0;
  for (int j = 0; j < 12; ++j) {
    c += static_cast<uint64_t>(r[j]) + b[j];
    r[j] = static_cast<uint32_t>(c);
    c >>= 32;
  }
}
inline uint32_t sub12(uint32_t* r, const uint32_t* b) {
  uint64_t borrow = 0;
  for (int j = 0; j < 12; ++j) {
    const uint64_t x = static_cast<uint64_t>(r[j]) - b[j] - borrow;
    r[j] = static_cast<uint32_t>(x);
    borrow = (x >> 32) & 1;
  }
  return borrow ? 0xffffffffu : 0u;
}
inline uint32_t lane_mask(bool c) { return c ? 0xffffffffu : 0u; }
inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, int n) {
  n &= 31;
  return n ? (lo >> n) | (hi << (32 - n)) : lo;
}

// The PTX helpers of sha256.cu on the host: a copy lands at once, and a
// barrier word holds (phase << 32 | pending << 16 | count).
inline void cp_async16(void* dst, const void* src) { std::memcpy(dst, src, 16); }
inline void cp_async_commit() {}
template <int N>
inline void cp_async_wait() {}
inline void mbar_init(uint64_t* bar, int count) {
  __atomic_store_n(bar, static_cast<uint64_t>(count), __ATOMIC_SEQ_CST);
}
inline void mbar_init_fence() {}
inline void mbar_arrive(uint64_t* bar) {
  uint64_t old = __atomic_load_n(bar, __ATOMIC_SEQ_CST), next;
  do {
    const uint64_t count = old & 0xffff, pending = ((old >> 16) & 0xffff) + 1;
    next = pending == count ? ((old >> 32) + 1) << 32 | count
                            : (old & ~0xffff0000ull) | pending << 16;
  } while (!__atomic_compare_exchange_n(bar, &old, next, false,
                                        __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST));
}
inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (((__atomic_load_n(bar, __ATOMIC_SEQ_CST) >> 32) & 1) == parity) {
    std::this_thread::yield();
  }
}

// The grid barrier of ack_plane.cu (cooperative_groups' grid sync): every
// thread of the grid's blocks meets at one barrier.
inline SpinBarrier* g_grid;
inline void grid_sync() { g_grid->wait(); }

// The sweep's acquire-release ticket (ack_plane.cu's draw_ticket).
inline uint32_t draw_ticket(uint32_t* ticket) {
  return __atomic_fetch_add(ticket, 1u, __ATOMIC_ACQ_REL);
}

// Run body() once a thread of a cooperative launch of `grid` blocks: every
// block's threads at once, as the card keeps every block of such a launch
// resident.
template <class F>
void launch_cooperative(int grid, int threads, F body) {
  blockDim.x = threads;
  gridDim.x = grid;
  SpinBarrier everyone(grid * threads);
  g_grid = &everyone;
  std::vector<std::unique_ptr<Block>> blocks;
  for (int b = 0; b < grid; ++b) blocks.emplace_back(new Block(threads, g_warp, 0));
  std::vector<std::thread> pool;
  for (int b = 0; b < grid; ++b) {
    for (int t = 0; t < threads; ++t) {
      pool.emplace_back([&, t, b] {
        threadIdx.x = t;
        blockIdx.x = b;
        g_block = blocks[b].get();
        body();
      });
    }
  }
  for (auto& th : pool) th.join();
}

// Run body() once a thread, blocks one after another.
template <class F>
void launch(int grid, int threads, size_t smem, F body) {
  blockDim.x = threads;
  gridDim.x = grid;
  for (int b = 0; b < grid; ++b) {
    Block block(threads, g_warp, smem);
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t) {
      pool.emplace_back([&, t, b] {
        threadIdx.x = t;
        blockIdx.x = b;
        g_block = &block;
        body();
      });
    }
    for (auto& th : pool) th.join();
  }
}

inline std::vector<char> read_all(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) { std::perror(path); std::exit(2); }
  std::vector<char> out;
  char buf[65536];
  size_t n;
  while ((n = std::fread(buf, 1, sizeof buf, f)) > 0) out.insert(out.end(), buf, buf + n);
  std::fclose(f);
  return out;
}

inline void write_all(const char* path, const void* p, size_t n) {
  FILE* f = std::fopen(path, "wb");
  std::fwrite(p, 1, n, f);
  std::fclose(f);
}
"""

LADDER_MAIN = r"""
// argv: input file (n, then xy, ok, s_words, k_words, consts), output file.
int main(int argc, char** argv) {
  g_warp = 8;
  std::vector<char> in = read_all(argv[1]);
  const int32_t* p = reinterpret_cast<const int32_t*>(in.data());
  const int n = p[0];
  const int32_t* xy = p + 1;
  const int32_t* ok = xy + 2 * n * 20;
  const uint32_t* s = reinterpret_cast<const uint32_t*>(ok + 2 * n);
  const uint32_t* k = s + 8 * n;
  const int32_t* consts = reinterpret_cast<const int32_t*>(k + 8 * n);
  std::vector<int32_t> out(n, -1);
  const int grid = (4 * n + kLadderThreads - 1) / kLadderThreads;
  launch(grid, kLadderThreads, kLadderSmemBytes, [&] {
    mirbft_ed25519_ladder_kernel(xy, ok, s, k, out.data(), n, consts);
  });
  write_all(argv[2], out.data(), out.size() * 4);
  return 0;
}
"""

DECOMPRESS_MAIN = r"""
// argv: input file (rows, 3 ints of padding, the (rows, 8) encoding words,
// consts), output file: xy and ok for rows + 1 rows, each set to -1 first,
// so a write past the rows shows.
int main(int argc, char** argv) {
  g_warp = kDecThreads;
  std::vector<char> in = read_all(argv[1]);
  const int32_t* p = reinterpret_cast<const int32_t*>(in.data());
  const int rows = p[0];
  std::vector<uint4> enc(2 * rows);
  std::memcpy(enc.data(), p + 4, 32 * static_cast<size_t>(rows));
  const int32_t* consts = p + 4 + 8 * rows;
  std::vector<int32_t> xy(20 * (rows + 1), -1), ok(rows + 1, -1);
  launch(decompress_grid(rows), kDecThreads, 0, [&] {
    mirbft_ed25519_decompress_kernel(enc.data(), xy.data(), ok.data(), rows,
                                     consts);
  });
  xy.insert(xy.end(), ok.begin(), ok.end());
  write_all(argv[2], xy.data(), xy.size() * 4);
  return 0;
}
"""

SHA256_MAIN = r"""
// argv: input file (batch, max_blocks, blocks, n_blocks), output files of
// the one-thread body and the warp-specialised body.
int main(int argc, char** argv) {
  std::vector<char> in = read_all(argv[1]);
  const int32_t* p = reinterpret_cast<const int32_t*>(in.data());
  const int batch = p[0], max_blocks = p[1];
  const uint4* blocks = reinterpret_cast<const uint4*>(p + 4);
  const int32_t* n_blocks = p + 4 + batch * max_blocks * 16;
  std::vector<uint4> out(2 * batch);
  launch((batch + kThreads - 1) / kThreads, kThreads, 0, [&] {
    mirbft_sha256_digest_kernel(blocks, n_blocks, out.data(), batch, max_blocks);
  });
  write_all(argv[2], out.data(), out.size() * 16);
  std::fill(out.begin(), out.end(), uint4{0, 0, 0, 0});
  g_warp = kWsLanes;
  launch((batch + kWsLanes - 1) / kWsLanes, 2 * kWsLanes, 0, [&] {
    mirbft_sha256_digest_ws_kernel(blocks, n_blocks, out.data(), batch, max_blocks);
  });
  write_all(argv[3], out.data(), out.size() * 16);
  return 0;
}
"""

ACK_MAIN = r"""
// argv: input file (8 ints: rows, c_pad, w_pad, limbs, weak_q, strong_q,
// 0, 0; the (rows, 12) batch; agree, nonnull, canon as uint32; canon_ok,
// flags, held, tick as bytes), output file: the state after the step
// (agree, nonnull, canon, canon_ok, tick), the row outputs, the adoption
// scratch after the step, then the tick after the sweep and its totals.
int main(int argc, char** argv) {
  std::vector<char> in = read_all(argv[1]);
  const int32_t* p = reinterpret_cast<const int32_t*>(in.data());
  const int rows = p[0], c_pad = p[1], w_pad = p[2], limbs = p[3];
  const int weak_q = p[4], strong_q = p[5];
  const int total = c_pad * w_pad;
  const int32_t* batch = p + 8;
  const uint32_t* u = reinterpret_cast<const uint32_t*>(batch + 12 * rows);
  std::vector<uint32_t> agree(u, u + total * limbs);
  u += total * limbs;
  std::vector<uint32_t> nonnull(u, u + total * limbs);
  u += total * limbs;
  std::vector<uint32_t> canon(u, u + total * 8);
  u += total * 8;
  const uint8_t* b = reinterpret_cast<const uint8_t*>(u);
  std::vector<uint8_t> canon_ok(b, b + total), flags(b + total, b + 2 * total),
      held(b + 2 * total, b + 3 * total), tick(b + 3 * total, b + 4 * total);
  std::vector<int32_t> first(total, kFirstNone), out(rows, -7);
  // The launcher's grid (step_blocks in ack_plane.cu), with a card that
  // holds 8 blocks at once, so a thread takes several rows, and past
  // kStepRows of them, rows whose class waits in `out`.
  const int blocks = std::min(8, (rows + kStepThreads - 1) / kStepThreads);
  launch_cooperative(blocks, kStepThreads, [&] {
    mirbft_ack_step_kernel(batch, agree.data(), nonnull.data(), canon.data(),
                           canon_ok.data(), flags.data(), held.data(),
                           tick.data(), first.data(), out.data(), rows, c_pad,
                           w_pad, limbs, weak_q, strong_q);
  });
  std::vector<uint8_t> tick_after_step(tick);
  std::vector<uint32_t> totals(3, 0xdeadbeefu), ticket(1, 0);
  std::vector<uint32_t> partials(3 * sweep_blocks(total), 0xdeadbeefu);
  const SweepPlane plane{agree.data(), canon_ok.data(), flags.data(),
                         held.data(), tick.data(), total, limbs, weak_q,
                         strong_q};
  launch(sweep_blocks(total), kSweepThreads, 0, [&] {
    mirbft_ack_sweep_kernel(plane, partials.data(), ticket.data(),
                            totals.data());
  });
  FILE* f = std::fopen(argv[2], "wb");
  std::fwrite(agree.data(), 4, agree.size(), f);
  std::fwrite(nonnull.data(), 4, nonnull.size(), f);
  std::fwrite(canon.data(), 4, canon.size(), f);
  std::fwrite(canon_ok.data(), 1, total, f);
  std::fwrite(tick_after_step.data(), 1, total, f);
  std::fwrite(out.data(), 4, rows, f);
  std::fwrite(first.data(), 4, total, f);
  std::fwrite(tick.data(), 1, total, f);
  std::fwrite(totals.data(), 4, 3, f);
  std::fclose(f);
  return 0;
}
"""

SWEEP_MAIN = r"""
// argv: input file (8 ints: total, limbs, weak_q, strong_q, misalign, 0,
// 0, 0; agree as uint32; canon_ok, flags, held, tick as bytes), output
// file: for each of two sweeps in a row on one ticket counter, the ticks
// after it and its totals; then the counter.  Every array starts on 16
// bytes, except that misalign 1 starts the byte arrays one byte later (the
// slot-by-slot path) and misalign 2 the masks four bytes later (the
// groups' scalar limbs).
int main(int argc, char** argv) {
  std::vector<char> in = read_all(argv[1]);
  const int32_t* p = reinterpret_cast<const int32_t*>(in.data());
  const int total = p[0], limbs = p[1], weak_q = p[2], strong_q = p[3];
  const int misalign = p[4];
  const uint32_t* u = reinterpret_cast<const uint32_t*>(p + 8);
  const size_t words = static_cast<size_t>(total) * limbs;
  std::vector<uint4> mask_store(words / 4 + 2);
  uint32_t* agree = reinterpret_cast<uint32_t*>(mask_store.data()) +
                    (misalign == 2 ? 1 : 0);
  std::memcpy(agree, u, 4 * words);
  const uint8_t* b = reinterpret_cast<const uint8_t*>(u + words);
  std::vector<std::vector<uint4>> byte_store;
  auto bytes = [&](int k) {
    byte_store.emplace_back(total / 16 + 2);
    uint8_t* at = reinterpret_cast<uint8_t*>(byte_store.back().data()) +
                  (misalign == 1 ? 1 : 0);
    std::memcpy(at, b + static_cast<size_t>(k) * total, total);
    return at;
  };
  uint8_t* canon_ok = bytes(0);
  uint8_t* flags = bytes(1);
  uint8_t* held = bytes(2);
  uint8_t* tick = bytes(3);
  const SweepPlane plane{agree, canon_ok, flags, held, tick, total, limbs,
                         weak_q, strong_q};
  const int blocks = sweep_blocks(total);
  std::vector<uint32_t> partials(3 * blocks, 0xdeadbeefu), ticket(1, 0);
  FILE* f = std::fopen(argv[2], "wb");
  for (int rep = 0; rep < 2; ++rep) {
    std::vector<uint32_t> totals(3, 0xdeadbeefu);
    launch(blocks, kSweepThreads, 0, [&] {
      mirbft_ack_sweep_kernel(plane, partials.data(), ticket.data(),
                              totals.data());
    });
    std::fwrite(tick, 1, total, f);
    std::fwrite(totals.data(), 4, 3, f);
  }
  std::fwrite(ticket.data(), 4, 1, f);
  std::fclose(f);
  return 0;
}
"""

BLS_MAIN = r"""
// argv: input file (2 ints: batch, width; xs, ys, zs as (batch, width, 12)
// uint32; the (batch, width) int32 mask), output file: (batch, 3, 12)
// uint32.
int main(int argc, char** argv) {
  std::vector<char> in = read_all(argv[1]);
  const int32_t* p = reinterpret_cast<const int32_t*>(in.data());
  const int batch = p[0], width = p[1];
  const size_t coords = static_cast<size_t>(batch) * width * kLimbs;
  const uint32_t* xs = reinterpret_cast<const uint32_t*>(p + 2);
  const uint32_t* ys = xs + coords;
  const uint32_t* zs = ys + coords;
  const int32_t* mask = reinterpret_cast<const int32_t*>(zs + coords);
  std::vector<uint32_t> out(static_cast<size_t>(batch) * 3 * kLimbs, 0xdeadbeefu);
  launch(batch, kBlsThreads, 0, [&] {
    mirbft_bls_g1_aggregate_kernel(xs, ys, zs, mask, out.data(), width);
  });
  write_all(argv[2], out.data(), out.size() * 4);
  return 0;
}
"""

ACK_THREADS = 64  # the ack plane's blocks in the rehearsal: two warps
SWEEP_MAX_BLOCKS = 8  # the sweep's largest grid in the rehearsal
DEC_THREADS = 32  # decompression's block in the rehearsal: one warp
BLS_THREADS = 32  # the BLS block in the rehearsal: one warp, a certificate
# Host thread counts: the ladder's block cut to 2 quads, decompression's
# to one warp, the digest kernel's one-thread body to 16 rows a block and
# its warps to 8 lanes.
CUTS = {
    "ed25519": {
        r"constexpr int kLadderThreads = \d+;": "constexpr int kLadderThreads = 8;",
        r"constexpr int kDecThreads = \d+;":
            f"constexpr int kDecThreads = {DEC_THREADS};",
    },
    "ack_plane": {
        r"constexpr int kSweepThreads = \d+;":
            f"constexpr int kSweepThreads = {ACK_THREADS};",
        r"constexpr int kSweepMaxBlocks = \d+;":
            f"constexpr int kSweepMaxBlocks = {SWEEP_MAX_BLOCKS};",
        r"constexpr int kStepThreads = \d+;":
            f"constexpr int kStepThreads = {ACK_THREADS};",
    },
    "bls_g1": {
        r"constexpr int kBlsThreads = \d+;":
            f"constexpr int kBlsThreads = {BLS_THREADS};",
    },
    "sha256": {
        r"constexpr int kThreads = \d+;": "constexpr int kThreads = 16;",
        r"constexpr int kWsLanes = \d+;": "constexpr int kWsLanes = 8;",
    },
}


# Ragged decompression launches: a rehearsal block is one warp of six
# groups of five lanes, so 1 and 3 rows leave groups empty, 7 is one past a
# block and 13 one past two.
DEC_RAGGED_ROWS = (1, 3, 7, 13)


# The span of PTX helpers a source defines, cut for the stub's host
# versions: from its first line up to (not including) its end marker.
PTX_HELPERS = {
    "sha256": ("__device__ __forceinline__ uint32_t smem_addr(",
               "__device__ __forceinline__ uint32_t rotr("),
    "ack_plane": ("__device__ __forceinline__ void grid_sync(",
                  "__device__ __forceinline__ int slot_count("),
    "bls_g1": ("__device__ __forceinline__ void col_mac(",
               "// -- field operations"),
}


def host_source(name: str) -> str:
    """csrc/<name>.cu as host C++: the stub first, the PTX helpers and the
    launchers cut, the block sizes cut, dynamic shared memory taken from
    the block."""
    src = (CSRC / f"{name}.cu").read_text()
    src = src.replace("#include <cuda_runtime.h>", "")
    src = src.replace("#include <cooperative_groups.h>", "")
    src = src[: src.index("}  // namespace")] + "}  // namespace\n"
    if name in PTX_HELPERS:
        first, end = PTX_HELPERS[name]
        if src.count(first) != 1 or src.count(end) != 1:
            raise RuntimeError(f"{name}.cu: the PTX helpers are not where "
                               "the rehearsal cuts them")
        src = src[: src.index(first)] + src[src.index(end):]
    for pattern, repl in CUTS[name].items():
        src, count = re.subn(pattern, repl, src)
        if count != 1:
            raise RuntimeError(f"{name}.cu: no single match for {pattern}")
    src = re.sub(
        r"extern __shared__ (?:__align__\(\d+\) )?(\w+) (\w+)\[\];",
        r"\1* \2 = reinterpret_cast<\1*>(g_block->smem.data());",
        src,
    )
    return STUB + src


def compile_host_main(name: str, main: str, workdir: Path) -> Path:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the rehearsal compiles host C++")
    source = workdir / f"{name}_host.cpp"
    source.write_text(host_source(name) + main)
    binary = workdir / f"{name}_host"
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O2", "-pthread", "-Wall", "-Wno-unused-function",
         "-o", str(binary), str(source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {name}.cu:\n{proc.stdout}")
    return binary


def ladder_rows(n: int, seed: int) -> tuple:
    """n (pk, msg, sig) rows: valid, corrupted R, corrupted S and wrong
    message in turn, then the identity and a point of order 8 as keys with
    a signature the identity satisfies."""
    from ed25519_corpus import order8_encoding
    from mirbft_tpu_torch.crypto import ed25519_host as host

    rng = random.Random(seed)
    rows = []
    r = 77
    r_sig = host.compress(
        host.scalar_mult(r, host.to_extended(host.BASE))
    ) + r.to_bytes(32, "little")
    edge = [(int.to_bytes(1, 32, "little"), b"m", r_sig),
            (order8_encoding(), b"m", r_sig)]
    for i in range(max(0, n - len(edge))):
        seed_bytes = rng.randbytes(32)
        msg = rng.randbytes(20)
        pk, sig = host.public_key(seed_bytes), host.sign(seed_bytes, msg)
        if i % 4 == 1:
            sig = bytes([sig[0] ^ 2]) + sig[1:]
        elif i % 4 == 2:
            sig = sig[:40] + bytes([sig[40] ^ 8]) + sig[41:]
        elif i % 4 == 3:
            msg += b"?"
        rows.append((pk, msg, sig))
    return (rows + edge)[:n]


def rehearse_ladder(n: int, workdir: Path) -> int:
    import torch

    from mirbft_tpu_torch.crypto import ed25519_host as host
    from mirbft_tpu_torch.ops import ed25519

    binary = compile_host_main("ed25519", LADDER_MAIN, workdir)
    rows = ladder_rows(n, seed=n)
    marshalled = [ed25519.marshal_light(*row) for row in rows]
    enc, s_words, k_words = ed25519.pack_rows(marshalled)
    xy, ok = ed25519.decompress_plain(torch.from_numpy(enc))
    blob = b"".join([
        np.int32(n).tobytes(), xy.numpy().tobytes(), ok.numpy().tobytes(),
        s_words.tobytes(), k_words.tobytes(), ed25519.constants().tobytes(),
    ])
    (workdir / "ladder.in").write_bytes(blob)
    subprocess.run([str(binary), str(workdir / "ladder.in"),
                    str(workdir / "ladder.out")], check=True)
    got = np.frombuffer((workdir / "ladder.out").read_bytes(), dtype=np.int32)
    want = [int(host.verify(*row)) for row in rows]
    bad = [i for i in range(n) if got[i] != want[i]]
    print(f"ladder, {n} rows on the host: verdicts {got.tolist()}, oracle "
          f"{want}: {'equal' if not bad else f'rows {bad} differ'}")
    return 1 if bad else 0


def rehearse_decompress(encodings: list, workdir: Path) -> int:
    """The decompress kernel on the host on ``encodings`` (32-byte strings,
    y < p): (x, y, ok) against the oracle and, bit for bit, against
    ``decompress_plain``; nothing written past the rows."""
    import torch

    from mirbft_tpu_torch.crypto import ed25519_host as host
    from mirbft_tpu_torch.ops import ed25519

    binary = compile_host_main("ed25519", DECOMPRESS_MAIN, workdir)
    rows = len(encodings)
    words = ed25519._words(encodings)
    blob = (np.array([rows, 0, 0, 0], dtype=np.int32).tobytes()
            + words.tobytes() + ed25519.constants().tobytes())
    (workdir / "dec.in").write_bytes(blob)
    subprocess.run([str(binary), str(workdir / "dec.in"),
                    str(workdir / "dec.out")], check=True)
    out = np.frombuffer((workdir / "dec.out").read_bytes(), dtype=np.int32)
    xy = out[: 20 * (rows + 1)].reshape(rows + 1, 2, 10)
    ok = out[20 * (rows + 1):]
    plain_xy, plain_ok = ed25519.decompress_plain(torch.from_numpy(words))
    bad = []
    for i, encoded in enumerate(encodings):
        point = host.decompress(encoded)
        want = None if point is None else (point[0], point[1])
        got = (None if ok[i] != 1 else
               tuple(ed25519.limbs_to_int(xy[i, c]) for c in (0, 1)))
        if (ok[i] not in (0, 1) or got != want
                or not np.array_equal(xy[i], plain_xy[i].numpy())
                or ok[i] != int(plain_ok[i])):
            bad.append(i)
    untouched = bool((xy[rows] == -1).all() and ok[rows] == -1)
    print(f"decompress, {rows} rows on the host: "
          f"{int((ok[:rows] == 1).sum())} points decode; "
          + ("(x, y, ok) == oracle == plain" if not bad else f"rows {bad} differ")
          + ("" if untouched else "; a group past the rows wrote"))
    return 1 if bad or not untouched else 0


def decompress_rows(rows: int, seed: int) -> list:
    """rows encodings: the corpus's first ones, then points of random keys
    (either sign) when it runs out."""
    from ed25519_corpus import decompression_corpus
    from mirbft_tpu_torch.crypto import ed25519_host as host

    rng = random.Random(seed)
    encs = decompression_corpus()[:rows]
    while len(encs) < rows:
        encs.append(host.public_key(rng.randbytes(32)))
    return encs


def rehearse_sha256(workdir: Path) -> int:
    from mirbft_tpu_torch.ops.batching import pack_preimages

    binary = compile_host_main("sha256", SHA256_MAIN, workdir)
    rng = random.Random(5)
    failures = 0
    for bucket, rows in ((1, 24), (2, 20), (8, 19), (32, 9), (128, 9)):
        # Ragged: lengths from 0 up to the bucket's last block, and a
        # padding row or more (count 0).
        top = bucket * 64 - 9
        lengths = [rng.randrange(0, top + 1) for _ in range(rows - 2)] + [top, 0]
        messages = [rng.randbytes(n) for n in lengths]
        packed = pack_preimages(messages, block_floor=bucket, batch_floor=rows + 3)
        batch, max_blocks, _ = packed.blocks.shape
        blob = (np.array([batch, max_blocks, 0, 0], dtype=np.int32).tobytes()
                + packed.blocks.astype(np.uint32).tobytes()
                + packed.n_blocks.astype(np.int32).tobytes())
        (workdir / "sha.in").write_bytes(blob)
        subprocess.run([str(binary), str(workdir / "sha.in"),
                        str(workdir / "one.out"), str(workdir / "ws.out")],
                       check=True)
        want = b"".join(hashlib.sha256(m).digest() for m in messages)
        want += IV_BYTES * (batch - len(messages))  # padding rows: the IV
        for body in ("one", "ws"):
            raw = np.frombuffer((workdir / f"{body}.out").read_bytes(),
                                dtype=np.uint32).astype(">u4").tobytes()
            ok = raw == want
            failures += not ok
            print(f"sha256 {body} body, shape ({batch}, {max_blocks}, 16), "
                  f"{len(messages)} live rows and the padding rows: "
                  f"{'== hashlib' if ok else 'DIFFERS from hashlib'}")
    return 1 if failures else 0


#: (rows, limbs) of the ack plane's rehearsal: the smallest padded batch
#: at one and two limbs, the next at three.
ACK_CASES = ((1024, 1), (1024, 2), (2048, 3))

#: Rows of the crossing case's rehearsals on the grid of 8 blocks of 64
#: threads: the last crossing row is a thread's eighth row (the last in
#: registers) at 4096, its sixteenth (its class carried in `out`) at 8192.
ACK_CROSSING_ROWS = (4096, 8192)


def rehearse_ack(rows: int, limbs: int, workdir: Path,
                 crossing: bool = False) -> int:
    """The step's cooperative grid and the sweep on the host, on a seeded case
    (tests/ack_plane_cases.py) holding every row class, against the plain
    versions bit for bit: the state, the row outputs, the sweep's tick and
    totals; the adoption scratch must be empty again after the step."""
    import torch
    from ack_plane_cases import (
        crossing_rows,
        make_case,
        make_crossing_case,
        torch_batch,
        torch_state,
    )

    from mirbft_tpu_torch.ops import ack_plane

    binary = compile_host_main("ack_plane", ACK_MAIN, workdir)
    # ``crossing``: the crossing case (``ACK_CROSSING_ROWS``).
    case = (make_crossing_case if crossing else make_case)(
        rows * 7 + limbs, rows, limbs)
    total = case["c_pad"] * case["w_pad"]
    header = np.array(
        [rows, case["c_pad"], case["w_pad"], limbs, case["weak_q"],
         case["strong_q"], 0, 0], dtype=np.int32,
    )
    batch = torch_batch(case).numpy()
    blob = b"".join([
        header.tobytes(), batch.tobytes(),
        case["agree"].tobytes(), case["nonnull"].tobytes(),
        case["canon"].tobytes(),
        case["canon_ok"].astype(np.uint8).tobytes(),
        case["flags"].tobytes(), case["held"].astype(np.uint8).tobytes(),
        case["tick"].tobytes(),
    ])
    (workdir / "ack.in").write_bytes(blob)
    subprocess.run([str(binary), str(workdir / "ack.in"),
                    str(workdir / "ack.out")], check=True)
    raw = (workdir / "ack.out").read_bytes()
    got = {}
    at = 0
    for name, dtype, count in (
        ("agree", np.uint32, total * limbs), ("nonnull", np.uint32, total * limbs),
        ("canon", np.uint32, total * 8), ("canon_ok", np.uint8, total),
        ("tick", np.uint8, total), ("out", np.int32, rows),
        ("first", np.int32, total), ("swept_tick", np.uint8, total),
        ("totals", np.uint32, 3),
    ):
        size = np.dtype(dtype).itemsize * count
        got[name] = np.frombuffer(raw[at:at + size], dtype=dtype)
        at += size

    state = torch_state(case)
    out = ack_plane.ack_step_plain(
        *state, torch.from_numpy(batch), weak_q=case["weak_q"],
        strong_q=case["strong_q"],
    )
    want = {
        "agree": state[0].numpy().view(np.uint32).ravel(),
        "nonnull": state[1].numpy().view(np.uint32).ravel(),
        "canon": state[2].numpy().view(np.uint32).ravel(),
        "canon_ok": state[3].numpy().astype(np.uint8).ravel(),
        "tick": state[6].numpy().ravel().copy(),
        "out": out.numpy(),
        "first": np.full(total, ack_plane.FIRST_NONE, dtype=np.int32),
    }
    totals = ack_plane.quorum_sweep_plain(
        state[0], state[3], state[4], state[5], state[6],
        weak_q=case["weak_q"], strong_q=case["strong_q"],
    )
    want["swept_tick"] = state[6].numpy().ravel()
    want["totals"] = totals.numpy().astype(np.uint32)
    bad = [name for name in want if not np.array_equal(got[name], want[name])]
    classes = ack_plane.unpack_step(out)
    if crossing:
        pattern = [[bool(classes[k][r]) for k in ("adopt", "applied",
                                                  "fallback")]
                   for r in crossing_rows(rows)]
        if pattern != [[True, True, False], [False, False, True],
                       [False, True, False]]:
            bad.append(f"crossing rows {pattern}")
    print(f"ack plane, {rows} rows x {limbs} limbs on the host: "
          + ", ".join(f"{k} {int(v.to(torch.bool).sum())}"
                      for k, v in classes.items())
          + f"; sweep {got['totals'].tolist()}: "
          + ("state, row outputs, sweep == plain" if not bad
             else f"{bad} differ"))
    return 1 if bad else 0


#: The sweep's rehearsals: tests/ack_plane_cases.py's planes, each with
#: every array on 16 bytes, then two of them with the byte arrays one byte
#: off (slot by slot) and with the masks four bytes off (scalar limbs).
SWEEP_REHEARSALS = tuple(
    [(slots, limbs, False, 0) for slots, limbs in SWEEP_CASES]
    + [(CERTIFIED_SLOTS["rehearsal"], 1, True, 0), (8193, 1, False, 1),
       (8193, 2, False, 2)]
)


def rehearse_sweep(slots: int, limbs: int, workdir: Path,
                   certified: bool = False, misalign: int = 0) -> int:
    """The sweep kernel alone on the host (blocks of two warps, at most 8
    of them, a thread a group of 8 slots, grid-stride past them), twice in
    a row on one ticket counter, on a seeded plane of
    tests/ack_plane_cases.py: the ticks and totals of each sweep bit for
    bit against ``quorum_sweep_plain`` run twice, and the counter back at
    0 after each."""
    from ack_plane_cases import (
        make_sweep_case,
        sweep_classes,
        sweep_tensors,
    )

    from mirbft_tpu_torch.ops import ack_plane

    binary = compile_host_main("ack_plane", SWEEP_MAIN, workdir)
    case = make_sweep_case(slots * 3 + limbs, slots, limbs,
                           certified=certified)
    header = np.array([slots, limbs, case["weak_q"], case["strong_q"],
                       misalign, 0, 0, 0], dtype=np.int32)
    blob = b"".join([header.tobytes(), case["agree"].tobytes()] + [
        case[name].astype(np.uint8).tobytes()
        for name in ("canon_ok", "flags", "held", "tick")])
    (workdir / "sweep.in").write_bytes(blob)
    subprocess.run([str(binary), str(workdir / "sweep.in"),
                    str(workdir / "sweep.out")], check=True)
    raw = (workdir / "sweep.out").read_bytes()
    tensors = sweep_tensors(case)
    bad = []
    for rep in range(2):
        at = rep * (slots + 12)
        tick = np.frombuffer(raw[at:at + slots], dtype=np.uint8)
        totals = np.frombuffer(raw[at + slots:at + slots + 12],
                               dtype=np.uint32)
        want = ack_plane.quorum_sweep_plain(
            *tensors, weak_q=case["weak_q"], strong_q=case["strong_q"])
        if not np.array_equal(tick, tensors[4].numpy().ravel()):
            bad.append(f"sweep {rep + 1}: tick")
        if totals.tolist() != want.tolist():
            bad.append(f"sweep {rep + 1}: totals {totals.tolist()} != "
                       f"{want.tolist()}")
    ticket = int(np.frombuffer(raw[-4:], dtype=np.uint32)[0])
    if ticket:
        bad.append(f"ticket counter {ticket} after the sweeps")
    label = ("certified" if certified else "mixed") + (
        ["", ", byte arrays 1 byte off", ", masks 4 bytes off"][misalign])
    print(f"ack sweep, {slots} slots x {limbs} limbs ({label}) on the host,"
          f" twice: classes {sweep_classes(case)}; totals "
          f"{totals.tolist()}: "
          + ("tick, totals == plain, counter 0" if not bad else f"{bad}"))
    return 1 if bad else 0


def rehearse_bls(cases: list, workdir: Path, exact: bool = False) -> int:
    """The aggregation kernel on the host, a group of host threads a
    certificate,
    on seeded certificates (tests/bls_cases.py), against the plain version
    bit for bit and, as affine points, against the host oracle."""
    import torch
    from bls_cases import host_sums, pack

    from mirbft_tpu_torch.ops import bls_g1

    binary = compile_host_main("bls_g1", BLS_MAIN, workdir)
    status = 0
    for label, certs, voters in cases:
        # ``exact``: the cases are tests/bls_cases.py's width cases, whose
        # third item is the launch's width itself.
        xs, ys, zs, mask = (pack(certs, width=voters) if exact
                            else pack(certs, voters))
        batch, width = mask.shape
        blob = b"".join([np.array([batch, width], dtype=np.int32).tobytes(),
                         xs.tobytes(), ys.tobytes(), zs.tobytes(),
                         mask.tobytes()])
        (workdir / "bls.in").write_bytes(blob)
        subprocess.run([str(binary), str(workdir / "bls.in"),
                        str(workdir / "bls.out")], check=True)
        got = np.frombuffer((workdir / "bls.out").read_bytes(),
                            dtype=np.int32).reshape(batch, 3, bls_g1.NLIMB)
        want = bls_g1.aggregate_plain(
            *(torch.from_numpy(a) for a in (xs, ys, zs, mask))
        ).numpy()
        points = [bls_g1.to_affine(xyz) for xyz in bls_g1.canonical(got)]
        same = np.array_equal(got, want)
        oracle = points[: len(certs)] == host_sums(certs)
        print(f"bls, {label} -> ({batch}, {width}) on the host: "
              + ("kernel == plain" if same else "kernel != plain")
              + (", == the oracle" if oracle else ", != the oracle"))
        status |= 0 if same and oracle else 1
    return status


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("what", nargs="*", default=["ladder", "sha256"],
                        choices=["ladder", "sha256", "decompress", "ack",
                                 "bls"])
    parser.add_argument("--rows", type=int, default=6,
                        help="ladder rows (default 6: two ragged blocks)")
    args = parser.parse_args(argv)
    status = 0
    with tempfile.TemporaryDirectory() as tmp:
        workdir = Path(tmp)
        if "ladder" in args.what:
            status |= rehearse_ladder(args.rows, workdir)
        if "sha256" in args.what:
            status |= rehearse_sha256(workdir)
        if "ack" in args.what:
            for rows, limbs in ACK_CASES:
                status |= rehearse_ack(rows, limbs, workdir)
            for rows in ACK_CROSSING_ROWS:
                status |= rehearse_ack(rows, 1, workdir, crossing=True)
            for slots, limbs, certified, misalign in SWEEP_REHEARSALS:
                status |= rehearse_sweep(slots, limbs, workdir, certified,
                                         misalign)
        if "bls" in args.what:
            from bls_cases import cases, width_cases

            status |= rehearse_bls(cases(), workdir)
            status |= rehearse_bls(width_cases(), workdir, exact=True)
        if "decompress" in args.what:
            from ed25519_corpus import decompression_corpus

            status |= rehearse_decompress(decompression_corpus(), workdir)
            for rows in DEC_RAGGED_ROWS:
                status |= rehearse_decompress(decompress_rows(rows, rows),
                                              workdir)
    return status


if __name__ == "__main__":
    sys.exit(main())
