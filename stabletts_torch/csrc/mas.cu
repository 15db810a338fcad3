// Monotonic alignment search (MAS) on Hopper (sm_90a): forward DP + backtrace.
//
// Replaces: the JAX package's ops/mas_pallas.py::maximum_path_pallas (one Pallas
// invocation streaming neg_cent rows HBM -> VMEM, keeping only the previous
// accumulated row and an int8 decision-bit table [Ty, B, Tx] in VMEM, which
// limits it to ~13 MiB of bits).
//
// Semantics (the JAX package's ops/mas.py:10-24, kept exactly): for y < t_y and x
// in the band [max(0, t_x + y - t_y), min(t_x, y + 1)),
//   value[y, x] = neg[y, x] + max(x == 0 ? (y == 0 ? 0 : -1e9) : value[y-1, x-1],
//                                 x == y ? -1e9 : value[y-1, x]);
// cells outside the band keep their raw value. The backtrace starts at
// index t_x - 1 on row t_y - 1, marks path[y, index] and moves left when
// index != 0 and (index == y or value[y-1, index] < value[y-1, index-1])
// (strict <). The y == 0 move reads a wrapped-around row in the numpy oracle;
// it comes after the last mark and cannot change the path, so it is skipped.
//
// What bounds it on the H100: latency, not bytes or operations. The DP is a
// serial chain of t_y row steps; each row is Tx independent cells. Bytes:
// neg_cent read once (B*Ty*Tx*4) and the path written once; at [32, 1000,
// 512] that is 131 MB, 0.04 ms at 3.35 TB/s, while the chain is 1000
// dependent row steps on one SM per item.
//
// What is observed. Where t_x > t_y the band is empty in every row, so every
// value stays raw. Where t_x <= t_y, an in-band cell reads only in-band cells
// of the row above (or the edge, or -1e9 on the diagonal), and the backtrace
// compares only in-band cells, so no cell outside the band is ever read: the
// kernel runs the recurrence in every cell and leaves the band test out (for
// t_x > t_y it keeps every raw value). The path is the oracle's bit for bit.
//
// Design: two launches. The first runs one CTA per batch item, with no CTA
// barrier inside its chain; the second writes the path on every SM.
// - Lengths. Each CTA sums its item's t_y and t_x from the mask itself (its
//   first column and first row), so the wrapper launches no reduction.
// - The chain. A row is spread over nw chain warps, one a scheduler: nw =
//   min(4, ceil(Tx / 128)) up to Tx = 4096, ceil(Tx / 1024) past it. Lane l
//   of warp w holds CPL contiguous cells in registers, x0 = (32 w + l) * CPL
//   .. x0 + CPL - 1 (CPL = ceil(Tx / 32 nw) rounded up to a multiple of 4;
//   32 past Tx = 4096). A row step needs one value from another lane, the
//   previous row's cell x0 - 1: one __shfl_up_sync, or across warps a value
//   each warp leaves in shared memory (double-buffered) before a named
//   barrier of the nw warps, once a row. A cell is then a max, an add and its
//   decision bit, with no per-cell select: the band is not tested (see
//   above), the diagonal's -1e9 is written once a row into the previous
//   row's value of cell y, and t_x > t_y takes a copy of the chain that keeps
//   the raw values.
// - Raw rows. Each chain warp copies its own cells of the rows ahead by
//   16-byte cp.async (4-byte where Tx % 4 != 0), coalesced, into a ring of
//   AHEAD slots laid out [chunk][lane], so that a lane reads its chunks free of
//   bank conflicts; AHEAD - 1 rows are in flight while a row is computed, and a
//   __syncwarp a row makes the lanes' copies visible to each other.
// - Decision bits. value[y-1, x] < value[y-1, x-1] for a lane's CPL cells is
//   one word a lane a row (8, 16 or 32 bits), kept in shared memory (128 KB
//   at [1000, 512]). Where the words and the ring exceed the CTA's shared
//   memory, a second instantiation keeps the words in a device-memory
//   workspace, and the backtrace stages them back into shared memory a block
//   of rows at a time.
// - Backtrace. After the chain one lane walks the words back, K rows a step
//   from a window of bits loaded at once (mas_walk), and writes each row's
//   index to device memory.
// - Path. The second kernel writes every row of the path from the indices
//   with 16-byte stores, zeros and the one, over all SMs: the path's bytes are
//   written once, and no launch or allocation of the wrapper zero-fills it.
// Any B and Ty; Tx <= MAS_MAX_WARPS * 1024 = 8192.
#include <type_traits>

#include "common.cuh"

using namespace stts;

namespace {

constexpr float kMaxNeg = -1e9f;
constexpr int MAS_WARP_CELLS = 1024;   // cells a chain warp holds at most (32 a lane)
constexpr int MAS_MAX_WARPS = 8;       // chain warps at most: Tx <= 8192
constexpr int MAS_ROW_WARPS = 4;       // chain warps a row is spread over (one a scheduler) up to Tx = 4096
constexpr int MAS_SMEM_MAX = 231424;   // dynamic shared bytes: 226 KB of the 227 a CTA may use on the H100
constexpr int MAS_STAGE_MIN = 65536;   // shared bytes the workspace branch stages its words through, at least
// ring slots (AHEAD - 1 raw rows in flight): 16 at up to 8 cells a lane, 8 at up to 32, 4 past Tx = 4096
constexpr int MAS_AHEAD_SMALL = 16, MAS_AHEAD = 8, MAS_AHEAD_WIDE = 4;
constexpr int PATH_THREADS = 256, PATH_ROWS = 8;  // the path kernel: rows a CTA

template <int CPL>
using MasBits = typename std::conditional<(CPL <= 8), uint8_t,
                                          typename std::conditional<(CPL <= 16), uint16_t, uint32_t>::type>::type;

struct MasArgs {
  const float* neg;   // [B, Ty, Tx]
  const float* mask;  // [B, Ty, Tx]: t_y = sum of mask[b, :, 0], t_x = sum of mask[b, 0, :]
  int* lens;          // [2, B]: t_y and t_x, for the path kernel
  uint16_t* idx;      // [B, Ty]: the path's index on each row
  uint8_t* ws_bits;   // workspace branch: [B, Ty, 32 nw] words
  int Ty, Tx, nw, vec, stage_rows;
};

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// 0xffffffff where a < b, else 0 (false for NaN, and -0 == +0, as `<`): a mask, not a predicate
__device__ __forceinline__ uint32_t lt_mask(float a, float b) {
  uint32_t d;
  asm("set.lt.u32.f32 %0, %1, %2;" : "=r"(d) : "f"(a), "f"(b));
  return d;
}

// One chain warp's rows 0 .. t_y - 1 of an item. Lane `lane` of warp `warp` holds cells x0 .. x0 + CPL - 1. The
// warp copies its own cells of the rows ahead into `wring` (its part of each of AHEAD slots, slot stride
// `slot_floats`), [chunk][lane] float4s, by 16-byte copies (VEC: Tx % 4 == 0) or 4-byte ones. ALL_RAW (t_x > t_y,
// an empty band): every value stays raw, and only the decision bits are computed. Otherwise the diagonal's -1e9
// enters as the previous row's value of cell y, which no in-band cell or backtrace reads for anything else.
template <int CPL, int AHEAD, bool VEC, bool ALL_RAW, typename Bits>
__device__ __forceinline__ void mas_chain(const float* nb, float* wring, int slot_floats, float* boundary,
                                          Bits* bits, int row_words, int Tx, int t_y, int warp, int lane, int nw) {
  constexpr int NC = CPL / 4;  // 16-byte chunks a lane
  const int wcell = warp * 32 * CPL, x0 = wcell + lane * CPL;
  const uint32_t ring0 = smem_addr(wring), slot_bytes = slot_floats * 4;
  // VEC: this lane copies chunk q = 32 c + lane of the warp's cells, which lane q / NC reads as its chunk q % NC
  int src_off[VEC ? NC : 1], src_bytes[VEC ? NC : 1];
  uint32_t dst_off[VEC ? NC : 1];
  if constexpr (VEC) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int q = c * 32 + lane;
      const bool in = wcell + 4 * q < Tx;
      src_off[c] = in ? 4 * q : 0;
      src_bytes[c] = in ? 16 : 0;
      dst_off[c] = ((q % NC) * 32 + q / NC) * 16;
    }
  }
  const float* next = nb + wcell;  // this warp's cells of the next row to copy
  // the copies of raw row y into its slot (one commit group a row, empty past t_y)
  auto issue = [&](int y) {
    if (y < t_y) {
      const uint32_t slot = ring0 + (uint32_t)(y & (AHEAD - 1)) * slot_bytes;
      if constexpr (VEC) {
#pragma unroll
        for (int c = 0; c < NC; ++c) cp_async16(slot + dst_off[c], next + src_off[c], src_bytes[c]);
      } else {
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int e = j * 32 + lane;  // cell e of the warp: lane e / CPL's cell e % CPL
          const int l = e / CPL, jj = e % CPL;
          const bool in = wcell + e < Tx;
          cp_async4(slot + ((jj / 4 * 32 + l) * 4 + jj % 4) * 4, in ? next + e : nb, in ? 4 : 0);
        }
      }
    }
    cp_async_commit();
    next += Tx;
  };

  float p[CPL], r[CPL];  // the previous row's values, the raw row
#pragma unroll
  for (int j = 0; j < CPL; ++j) p[j] = 0.f;
#pragma unroll 1
  for (int s = 0; s < AHEAD - 1; ++s) issue(s);
  for (int y = 0; y < t_y; ++y) {
    // row y has landed for this lane, and every lane of the warp has read row y - 1 from the slot refilled here
    cp_async_wait<AHEAD - 2>();
    __syncwarp();
    issue(y + AHEAD - 1);
    const float* slot = wring + (y & (AHEAD - 1)) * slot_floats;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float4 v = *reinterpret_cast<const float4*>(slot + (c * 32 + lane) * 4);
      r[4 * c] = v.x; r[4 * c + 1] = v.y; r[4 * c + 2] = v.z; r[4 * c + 3] = v.w;
    }
    // value[y-1, x0-1]: from the lane to the left, from the warp to the left, or the edge
    const float from_lane = __shfl_up_sync(0xffffffffu, p[CPL - 1], 1);
    const float from_warp = boundary[((y + 1) & 1) * MAS_MAX_WARPS + max(warp - 1, 0)];
    const float left = lane > 0 ? from_lane : warp > 0 ? from_warp : y == 0 ? 0.f : kMaxNeg;
    if constexpr (!ALL_RAW) {
      const int dy = y - x0;
      if ((unsigned)dy < (unsigned)CPL) {
#pragma unroll
        for (int j = 0; j < CPL; ++j)
          if (j == dy) p[j] = kMaxNeg;  // value[y-1, y] is read as -1e9 by the cell x == y
      }
    }
    uint32_t word = 0;
    float pl = left;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const float pc = p[j];
      word |= lt_mask(pc, pl) & (1u << j);
      p[j] = ALL_RAW ? r[j] : r[j] + fmaxf(pl, pc);
      pl = pc;
    }
    bits[(long long)y * row_words + warp * 32 + lane] = (Bits)word;
    if (nw > 1) {
      if (lane == 31) boundary[(y & 1) * MAS_MAX_WARPS + warp] = p[CPL - 1];
      named_barrier(1, 32 * nw);
    }
  }
  cp_async_wait<0>();
}

// The backtrace over rows y_hi - 1 .. y_lo, from `index` on row y_hi - 1; row y's words at words + (y - y_lo) *
// row_words. Records each row's index in idx[y]; returns the index on row y_lo - 1. It runs in blocks of K rows:
// the index falls by at most one a row, so a block's cells lie within two neighbouring words of each row, loaded
// together at the block's start into a window of bits relative to the block's first word. The window also folds in
// the rule's other terms (set on the diagonal, clear at cell 0 and on row 0), so a step is a shift, an and and a
// subtraction: move = (index != 0) and (index == y or bit), y > 0.
template <int CPL, typename Bits>
__device__ __forceinline__ int mas_walk(const Bits* words, int row_words, int y_hi, int y_lo, int index,
                                        uint16_t* idx) {
  constexpr int K = CPL >= 8 ? 8 : 4;  // <= CPL
  using Win = typename std::conditional<(CPL <= 16), uint32_t, uint64_t>::type;  // 2 CPL bits
  for (int y = y_hi - 1; y >= y_lo; y -= K) {
    const int g = max(index - (K - 1), 0) / CPL;  // the window's first word
    const int base = g * CPL;
    Win win[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int yy = y - k;
      const Bits* row = words + (yy - y_lo) * row_words + g;
      const Win lo = yy >= y_lo ? (Win)row[0] : 0;
      const Win hi = yy >= y_lo && g + 1 < row_words ? (Win)row[1] : 0;
      Win w = lo | (hi << CPL);
      if ((unsigned)(yy - base) < 2u * CPL) w |= (Win)1 << (yy - base);  // index == y moves
      if (base == 0) w &= ~(Win)1;                                     // index 0 stays
      win[k] = yy > 0 && yy >= y_lo ? w : 0;                            // row 0 is the last
    }
    int rel = index - base;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (y - k >= y_lo) idx[y - k] = (uint16_t)(base + rel);
      rel -= (int)((win[k] >> rel) & 1u);
    }
    index = base + rel;
  }
  return index;
}

// The chain and the backtrace of item blockIdx.x: 32 nw threads, the chain warps; the path's indices to a.idx
template <int CPL, int AHEAD, bool SHARED_BITS>
__global__ void __launch_bounds__(32 * MAS_MAX_WARPS, 1) mas_kernel(MasArgs a) {
  using Bits = MasBits<CPL>;
  extern __shared__ float4 mas_smem[];
  __shared__ float len_sum[2];
  const int nw = a.nw, lanes = 32 * nw, Ty = a.Ty, Tx = a.Tx;
  float* ring = reinterpret_cast<float*>(mas_smem);  // [AHEAD][nw][32 CPL]
  float* boundary = ring + AHEAD * lanes * CPL;      // [2][MAS_MAX_WARPS]: each warp's last cell, rows y & 1
  const int b = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row_words = lanes;
  Bits* bits = SHARED_BITS ? reinterpret_cast<Bits*>(boundary + 2 * MAS_MAX_WARPS)
                           : reinterpret_cast<Bits*>(a.ws_bits) + (long long)b * Ty * row_words;
  uint16_t* idx = a.idx + (long long)b * Ty;

  // the lengths: warp 0 sums mask[b, :, 0], the last warp mask[b, 0, :] (the same warp where nw is 1)
  const float* mb = a.mask + (long long)b * Ty * Tx;
  if (threadIdx.x < 2 * MAS_MAX_WARPS) boundary[threadIdx.x] = 0.f;  // row -1 is zeros
  if (warp == 0) {
    float sum = 0.f;
    for (int y = lane; y < Ty; y += 32) sum += mb[(long long)y * Tx];
    sum = warp_sum(sum);
    if (lane == 0) len_sum[0] = sum;
  }
  if (warp == nw - 1) {
    float sum = 0.f;
    for (int x = lane; x < Tx; x += 32) sum += mb[x];
    sum = warp_sum(sum);
    if (lane == 0) len_sum[1] = sum;
  }
  __syncthreads();
  const int t_y = min((int)len_sum[0], Ty), t_x = min((int)len_sum[1], Tx);
  if (threadIdx.x == 0) {
    a.lens[b] = t_y;
    a.lens[gridDim.x + b] = t_x;
  }
  float* wring = ring + warp * 32 * CPL;
  const float* nb = a.neg + (long long)b * Ty * Tx;
  if (t_x > t_y) {
    if (a.vec)
      mas_chain<CPL, AHEAD, true, true>(nb, wring, lanes * CPL, boundary, bits, row_words, Tx, t_y, warp, lane, nw);
    else
      mas_chain<CPL, AHEAD, false, true>(nb, wring, lanes * CPL, boundary, bits, row_words, Tx, t_y, warp, lane, nw);
  } else {
    if (a.vec)
      mas_chain<CPL, AHEAD, true, false>(nb, wring, lanes * CPL, boundary, bits, row_words, Tx, t_y, warp, lane, nw);
    else
      mas_chain<CPL, AHEAD, false, false>(nb, wring, lanes * CPL, boundary, bits, row_words, Tx, t_y, warp, lane,
                                          nw);
  }
  __syncthreads();  // the words are written
  if (warp != 0 || t_x <= 0 || t_y <= 0) return;
  if constexpr (SHARED_BITS) {
    if (lane == 0) mas_walk<CPL>(bits, row_words, t_y, 0, t_x - 1, idx);
  } else {
    // the ring is free: stage the words back a block of rows at a time
    Bits* stage = reinterpret_cast<Bits*>(ring);
    int index = t_x - 1;
    for (int y_hi = t_y; y_hi > 0; y_hi -= a.stage_rows) {
      const int y_lo = max(0, y_hi - a.stage_rows);
      const uint4* src = reinterpret_cast<const uint4*>(bits + (long long)y_lo * row_words);
      const int n16 = (y_hi - y_lo) * row_words * (int)sizeof(Bits) / 16;
      for (int e = lane; e < n16; e += 32) reinterpret_cast<uint4*>(stage)[e] = src[e];
      __syncwarp();
      if (lane == 0) index = mas_walk<CPL>(stage, row_words, y_hi, y_lo, index, idx);
      __syncwarp();
    }
  }
}

// The path from the indices: PATH_ROWS rows [Tx] a CTA, each zeros and a one at idx (none on rows past t_y, or
// where t_x is 0), by 16-byte stores where Tx % 4 == 0
__global__ void __launch_bounds__(PATH_THREADS) mas_path_kernel(const uint16_t* idx, const int* lens, float* path,
                                                               int B, int Ty, int Tx, int vec) {
  __shared__ int ones[PATH_ROWS];
  const long long row0 = (long long)blockIdx.x * PATH_ROWS, rows = (long long)B * Ty;
  const int n = (int)min((long long)PATH_ROWS, rows - row0);
  if (threadIdx.x < n) {
    const long long row = row0 + threadIdx.x;
    const int b = (int)(row / Ty), y = (int)(row - (long long)b * Ty);
    ones[threadIdx.x] = y < lens[b] && lens[B + b] > 0 ? idx[row] : -1;
  }
  __syncthreads();
  float* out = path + row0 * Tx;
  if (vec) {
    const int tx4 = Tx / 4;
    for (int e = threadIdx.x; e < n * tx4; e += PATH_THREADS) {
      const int k = e / tx4, q = e - k * tx4, one = ones[k] - 4 * q;
      const float4 v = make_float4(one == 0 ? 1.f : 0.f, one == 1 ? 1.f : 0.f, one == 2 ? 1.f : 0.f,
                                   one == 3 ? 1.f : 0.f);
      reinterpret_cast<float4*>(out)[e] = v;
    }
  } else {
    for (int e = threadIdx.x; e < n * Tx; e += PATH_THREADS) {
      const int k = e / Tx;
      out[e] = e - k * Tx == ones[k] ? 1.f : 0.f;
    }
  }
}

// How an item of [Ty, Tx] runs: the chain warps, cells a lane, whether the words fit in shared memory, the
// dynamic shared bytes, and the workspace bytes of the whole batch (0 where the words are in shared memory)
struct MasPlan {
  int nw, cpl, ahead, shared, smem, stage_rows;
  long long ws_bits, ws_bytes;  // where the words start in the workspace (after the indices and the lengths), its bytes
};

MasPlan mas_plan_of(int B, int Ty, int Tx) {
  MasPlan p;
  // a row over up to MAS_ROW_WARPS warps of at least 4 cells a lane, and over more warps of 32 past that
  p.nw = Tx > MAS_ROW_WARPS * MAS_WARP_CELLS ? (Tx + MAS_WARP_CELLS - 1) / MAS_WARP_CELLS
                                             : min(MAS_ROW_WARPS, (Tx + 127) / 128);
  p.cpl = p.nw > MAS_ROW_WARPS ? 32 : ((Tx + 32 * p.nw - 1) / (32 * p.nw) + 3) / 4 * 4;
  p.ahead = p.nw > MAS_ROW_WARPS ? MAS_AHEAD_WIDE : p.cpl <= 8 ? MAS_AHEAD_SMALL : MAS_AHEAD;
  const long long row_bytes = 32LL * p.nw * (p.cpl <= 8 ? 1 : p.cpl <= 16 ? 2 : 4);
  const long long fixed = (long long)p.ahead * 32 * p.nw * p.cpl * 4 + 2 * MAS_MAX_WARPS * 4;  // ring, boundary
  p.shared = fixed + (long long)Ty * row_bytes <= MAS_SMEM_MAX;
  p.ws_bits = (2LL * B * Ty + 15) / 16 * 16 + (8LL * B + 15) / 16 * 16;  // [B, Ty] u16, [2, B] int32
  if (p.shared) {
    p.smem = (int)(fixed + (long long)Ty * row_bytes);
    p.stage_rows = 0;
    p.ws_bytes = p.ws_bits;
  } else {
    p.smem = (int)(fixed > MAS_STAGE_MIN ? fixed : MAS_STAGE_MIN);
    p.stage_rows = (int)(p.smem / row_bytes);
    p.ws_bytes = p.ws_bits + (long long)B * Ty * row_bytes;
  }
  return p;
}

template <int CPL, int AHEAD>
cudaError_t launch_mas(const MasArgs& a, const MasPlan& p, int B, cudaStream_t s) {
  void (*k)(MasArgs) = mas_kernel<CPL, AHEAD, false>;
  if (p.shared) k = mas_kernel<CPL, AHEAD, true>;
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  k<<<B, 32 * p.nw, p.smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mas_max_tx() { return MAS_MAX_WARPS * MAS_WARP_CELLS; }

// out[0..4] = workspace bytes, words in shared memory (1) or in the workspace (0), chain warps, cells a lane
extern "C" int mas_plan(void* out, int B, int Ty, int Tx) {
  const MasPlan p = mas_plan_of(B, Ty, Tx);
  long long* o = static_cast<long long*>(out);
  o[0] = p.ws_bytes;
  o[1] = p.shared;
  o[2] = p.nw;
  o[3] = p.cpl;
  return 0;
}

// neg and mask [B, Ty, Tx] f32; ws: mas_plan's workspace bytes; path [B, Ty, Tx] f32
extern "C" int mas_forward(const void* neg, const void* mask, void* ws, void* path, int B, int Ty, int Tx,
                           void* stream) {
  if (Tx > MAS_MAX_WARPS * MAS_WARP_CELLS || Tx < 1 || Ty < 1 || B < 1 || ws == nullptr)
    return (int)cudaErrorInvalidValue;
  const MasPlan p = mas_plan_of(B, Ty, Tx);
  uint8_t* w = static_cast<uint8_t*>(ws);
  MasArgs a;
  a.neg = static_cast<const float*>(neg);
  a.mask = static_cast<const float*>(mask);
  a.idx = reinterpret_cast<uint16_t*>(w);
  a.lens = reinterpret_cast<int*>(w + (2LL * B * Ty + 15) / 16 * 16);
  a.ws_bits = w + p.ws_bits;
  a.Ty = Ty;
  a.Tx = Tx;
  a.nw = p.nw;
  a.vec = Tx % 4 == 0 && (reinterpret_cast<uintptr_t>(neg) & 15) == 0;
  a.stage_rows = p.stage_rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (p.nw > MAS_ROW_WARPS ? 0 : p.cpl) {
    case 4: err = launch_mas<4, MAS_AHEAD_SMALL>(a, p, B, s); break;
    case 8: err = launch_mas<8, MAS_AHEAD_SMALL>(a, p, B, s); break;
    case 12: err = launch_mas<12, MAS_AHEAD>(a, p, B, s); break;
    case 16: err = launch_mas<16, MAS_AHEAD>(a, p, B, s); break;
    case 20: err = launch_mas<20, MAS_AHEAD>(a, p, B, s); break;
    case 24: err = launch_mas<24, MAS_AHEAD>(a, p, B, s); break;
    case 28: err = launch_mas<28, MAS_AHEAD>(a, p, B, s); break;
    case 32: err = launch_mas<32, MAS_AHEAD>(a, p, B, s); break;
    default: err = launch_mas<32, MAS_AHEAD_WIDE>(a, p, B, s); break;
  }
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)B * Ty;
  mas_path_kernel<<<(unsigned)((rows + PATH_ROWS - 1) / PATH_ROWS), PATH_THREADS, 0, s>>>(
      a.idx, a.lens, static_cast<float*>(path), B, Ty, Tx,
      Tx % 4 == 0 && (reinterpret_cast<uintptr_t>(path) & 15) == 0);
  return (int)cudaGetLastError();
}
