// Shared device code of the port's kernels: float/bf16 conversion; a tiled
// "tap GEMM" whose A operand is a row-shifted view of activations, so k-tap
// convolutions along time run as one product without materialising shifted
// copies; its transposed product for weight gradients; LayerNorm + adaLN
// modulate forward and backward; deterministic column sums; the epilogues of
// the inference DiT block (QKV with partial RoPE, out-projection and the two
// FFN convs), shared by the whole-block kernel and its two halves;
// Philox4x32-10 dropout.
//
// The tap GEMM has two kernels behind one launch. f32 goes to the fp32-FMA
// `tap_gemm_f32_kernel` (true-f32 products on the FP32 pipes; a register-
// blocked 128 x 128 or 64 x 64 tile chosen by the shape; see its note below).
// bf16 goes to `tap_gemm_wgmma_kernel` (tensor cores, f32 sums). Both stage
// the finished tile in shared memory, so an epilogue can read neighbouring
// columns (RoPE). The weight-gradient GEMM likewise: f32 goes to the FMA
// `wgrad_f32_kernel`, bf16 to `wgrad_wgmma_kernel`.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma.cuh"

namespace stts {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// v rounded through T (identity for float)
template <typename T> __device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

constexpr int GEMM_BM = 64;
constexpr int GEMM_BN = 64;
constexpr int GEMM_BK = 16;
constexpr int GEMM_THREADS = 256;
constexpr int NUM_SMS = 132;  // H100 SXM

// C[m, n] = sum_tap sum_k A(m, tap, k) * B(tap, k, n)
//   output row m = b * t_out + i; A(m, tap, k) reads activation row
//   t = row_stride * i + shift0 + tap * shift_step of batch item b (zero
//   outside [0, min(t_in, row_len[b])) ), column k (k < k_split from a0, else
//   from a1 at k - k_split; zero for k >= k_in);
//   B(tap, k, n) = w[tap * w_tap_stride + k * ldw + n], or with w_trans
//   w[tap * w_tap_stride + n * ldw + k] (the product with W^T).
struct TapGemm {
  const void* a0;
  const void* a1;
  int k_split;
  int lda;
  int t_in;
  int t_out;
  int k_in;
  int taps;
  int shift0;
  int shift_step;
  const int* row_len;  // nullptr: every row of t_in is valid
  const void* w;
  long long w_tap_stride;
  int ldw;
  int M;
  int N;
  int w_trans;
  int row_stride = 1;  // a strided conv's output row i reads from input row row_stride * i
};

// Epi must provide
//   float prep(int m, int n, float acc)                 -> value staged in the tile
//   void store(int m, int n, const float* tile, int r, int c)  (tile row stride GEMM_BN + 1)

// A "same"-padded k-tap conv along time (taps = 1: a dense layer) of a [M =
// B*Tn, k_in] activation with w [taps, k_in, n_out]: tap j reads row
// t - (taps-1)/2 + j. `transposed` gives the input gradient's product of a
// conv whose w is [taps, n_out, k_in]: tap j reads row t + (taps-1)/2 - j
// against W[j]^T.
inline TapGemm conv_gemm(const void* a, int k_in, const void* w, int n_out, int M, int Tn, int taps,
                         bool transposed) {
  TapGemm g{};
  g.a0 = a; g.a1 = a; g.k_split = k_in; g.lda = k_in; g.t_in = Tn; g.t_out = Tn; g.k_in = k_in;
  g.taps = taps; g.row_len = nullptr; g.w = w; g.w_tap_stride = (long long)k_in * n_out; g.M = M; g.N = n_out;
  const int half = (taps - 1) / 2;
  g.shift0 = transposed ? half : -half;
  g.shift_step = transposed ? -1 : 1;
  g.w_trans = transposed ? 1 : 0;
  g.ldw = transposed ? k_in : n_out;
  return g;
}

// ---- the bf16 tap GEMM on wgmma ------------------------------------------
// Replaces, for bf16, the FMA kernel above under the same contract (TapGemm,
// Epi). What bounds it on the H100: its products, 2*M*N*K*taps FLOPs against
// activations and weights read about once and the output written once (the
// DiT block's convs ~600 FLOPs a byte, above the card's ~295 for bf16; its
// projections 130-190, below it).
//
// Design: a 128 x 128 CTA tile, two consumer warpgroups of 64 rows each
// issuing wgmma m64n128k16 (A and B from shared memory), and a 64-deep k
// step; tap `tap` is just more k steps whose A rows are shifted by shift0 +
// tap * shift_step. Each stage of a 3-deep ring holds A as two swizzled
// 64 x 64 tiles (K-major) and B as two (MN-major for W[k, n], K-major for
// w_trans); every thread of the CTA fills it by cp.async one k step ahead,
// and each warpgroup keeps one product group in flight (wgmma.wait_group 1),
// so a stage is refilled only after both warpgroups' products on it are done.
// 97 KB of shared memory and at most 128 registers a thread let two CTAs
// share an SM, so one's copies and epilogue overlap the other's products
// (measured against a 4-deep ring at one CTA an SM and against no product in
// flight: PERF.md). A row outside [0, min(t_in, row_len[b])) and a column
// past k_in or N read nothing: cp.async zero-fills them. Where lda or ldw is
// not a multiple of 8, a pointer is not 16-byte aligned, or a 16-byte chunk
// would straddle k_split, the copies are element by element (an odd lda or
// k_split such as 1025; no kernel of the port's paths takes them): right,
// not fast. The epilogue stages each warpgroup's 64 x 128 sums as two 64 x 64
// sub-tiles of row stride GEMM_BN + 1 in the ring's memory and calls the
// unchanged prep and store, so a store reads neighbours within its 64 columns
// as on FMA.
constexpr int TG_BM = 128, TG_BN = 128, TG_BK = 64, TG_STAGES = 3, TG_THREADS = 256;
constexpr int TG_INFLIGHT = 1;  // product groups a warpgroup keeps in flight across a k step
constexpr int TG_CTAS_PER_SM = 2;
constexpr int TG_STAGE_BYTES = 4 * WG_TILE_BYTES;        // A: 2 tiles of 64 rows; B: 2 tiles of 64 columns
constexpr int TG_SMEM = TG_STAGES * TG_STAGE_BYTES + 1024;  // + alignment slack
constexpr int TG_SUB = GEMM_BM * (GEMM_BN + 1);           // floats of one staged 64 x 64 sub-tile
static_assert(4 * TG_SUB * 4 <= TG_STAGES * TG_STAGE_BYTES, "the epilogue's sub-tiles fit in the ring");

// 16 bytes (8 values) into chunk c8 of row r of a swizzled tile
__device__ __forceinline__ void st_chunk(uint8_t* tile, int r, int c8, uint4 v) {
  *reinterpret_cast<uint4*>(tile + r * 128 + (((c8 ^ r) & 7) << 4)) = v;
}

__device__ __forceinline__ uint4 pack8(const bf16 (&v)[8]) {
  uint4 u;
  u.x = (uint32_t)__bfloat16_as_ushort(v[0]) | ((uint32_t)__bfloat16_as_ushort(v[1]) << 16);
  u.y = (uint32_t)__bfloat16_as_ushort(v[2]) | ((uint32_t)__bfloat16_as_ushort(v[3]) << 16);
  u.z = (uint32_t)__bfloat16_as_ushort(v[4]) | ((uint32_t)__bfloat16_as_ushort(v[5]) << 16);
  u.w = (uint32_t)__bfloat16_as_ushort(v[6]) | ((uint32_t)__bfloat16_as_ushort(v[7]) << 16);
  return u;
}

// The A rows a thread copies, fixed across the k loop: output row m = b *
// t_out + i reads item b's row row_stride * i + shift where 0 <= row_stride *
// i + shift < lim (lim = -1 past M). The vector copies take four rows,
// (tid / 8) + 32 j; the element copies one, tid / 2.
struct TapRows {
  long long base[4];  // b * t_in
  int i[4];           // row_stride * i
  int lim[4];
  __device__ __forceinline__ void set(const TapGemm& g, int j, int m) {
    const int b = m < g.M ? m / g.t_out : 0;
    base[j] = (long long)b * g.t_in;
    i[j] = (m - b * g.t_out) * g.row_stride;
    lim[j] = m >= g.M ? -1 : (g.row_len ? min(g.row_len[b], g.t_in) : g.t_in);
  }
  // the source row of row j at this shift, or -1 where it reads zeros
  __device__ __forceinline__ long long row(int j, int shift) const {
    const int t = i[j] + shift;
    return (t >= 0 && t < lim[j]) ? base[j] + t : -1;
  }
};

// Stage `stage` of the ring <- the operands of k step `step`
__device__ __forceinline__ void tap_gemm_load(const TapGemm& g, const TapRows& rows, uint8_t* ring, int stage,
                                              int step, int ktiles, int n0, bool vec_a, bool vec_b) {
  const bf16* A0 = static_cast<const bf16*>(g.a0);
  const bf16* A1 = static_cast<const bf16*>(g.a1);
  const int tid = threadIdx.x;
  const int tap = step / ktiles, k0 = (step - tap * ktiles) * TG_BK;
  const int shift = g.shift0 + tap * g.shift_step;
  const bf16* W = static_cast<const bf16*>(g.w) + tap * g.w_tap_stride;
  uint8_t* sa = ring + stage * TG_STAGE_BYTES;
  uint8_t* sb = sa + 2 * WG_TILE_BYTES;
  const int ka = min(g.k_split, g.k_in);  // columns read from a0
  if (vec_a) {
    // 128 rows x 8 chunks: row (tid / 8) + 32 i, chunk tid % 8
    const int c = tid & 7, k = k0 + c * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (tid >> 3) + 32 * i, rr = r & 63;
      const long long row = k < g.k_in ? rows.row(i, shift) : -1;
      const bf16* src = A0;
      int n = 0;
      if (row >= 0) {
        if (k < ka) {
          src = A0 + row * g.lda + k;
          n = min(ka - k, 8);
        } else {
          src = A1 + row * g.lda + (k - g.k_split);
          n = min(g.k_in - k, 8);
        }
      }
      cp_async16(smem_addr(sa + (r >> 6) * WG_TILE_BYTES) + rr * 128 + (((c ^ rr) & 7) << 4), src, n * 2);
    }
  } else {
    // row tid / 2, 32 columns from (tid % 2) * 32
    const int r = tid >> 1, rr = r & 63, c0 = (tid & 1) * 32;
    const long long row = rows.row(0, shift);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      bf16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int k = k0 + c0 + q * 8 + e;
        v[e] = __ushort_as_bfloat16(0);
        if (row >= 0 && k < g.k_in) v[e] = k < ka ? A0[row * g.lda + k] : A1[row * g.lda + (k - g.k_split)];
      }
      st_chunk(sa + (r >> 6) * WG_TILE_BYTES, rr, (c0 >> 3) + q, pack8(v));
    }
  }
  if (!g.w_trans) {
    // W[k, n]: 64 k rows x 16 chunks of n; tile h holds columns 64 h .. 64 h + 63
    if (vec_b) {
      const int cb = tid & 15, n = n0 + cb * 8;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kr = (tid >> 4) + 16 * i, k = k0 + kr;
        const int nb = (k < g.k_in && n < g.N) ? min(g.N - n, 8) : 0;
        const bf16* src = nb ? W + (long long)k * g.ldw + n : W;
        cp_async16(smem_addr(sb + (cb >> 3) * WG_TILE_BYTES) + kr * 128 + ((((cb & 7) ^ kr) & 7) << 4), src,
                   nb * 2);
      }
    } else {
      const int kr = tid >> 2, k = k0 + kr, c0 = (tid & 3) * 32;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        bf16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int n = n0 + c0 + q * 8 + e;
          v[e] = (k < g.k_in && n < g.N) ? W[(long long)k * g.ldw + n] : __ushort_as_bfloat16(0);
        }
        const int c = c0 + q * 8;
        st_chunk(sb + (c >> 6) * WG_TILE_BYTES, kr, (c & 63) >> 3, pack8(v));
      }
    }
  } else {
    // W[n, k]: 128 n rows x 8 chunks of k; tile h holds rows 64 h .. 64 h + 63
    if (vec_b) {
      const int c = tid & 7, k = k0 + c * 8;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int nr = (tid >> 3) + 32 * i, rr = nr & 63, n = n0 + nr;
        const int nb = (n < g.N && k < g.k_in) ? min(g.k_in - k, 8) : 0;
        const bf16* src = nb ? W + (long long)n * g.ldw + k : W;
        cp_async16(smem_addr(sb + (nr >> 6) * WG_TILE_BYTES) + rr * 128 + (((c ^ rr) & 7) << 4), src, nb * 2);
      }
    } else {
      const int nr = tid >> 1, rr = nr & 63, n = n0 + nr, c0 = (tid & 1) * 32;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        bf16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int k = k0 + c0 + q * 8 + e;
          v[e] = (n < g.N && k < g.k_in) ? W[(long long)n * g.ldw + k] : __ushort_as_bfloat16(0);
        }
        st_chunk(sb + (nr >> 6) * WG_TILE_BYTES, rr, (c0 >> 3) + q, pack8(v));
      }
    }
  }
}

// fence_regs for the 64 accumulators of an m64n128 product
__device__ __forceinline__ void tg_fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <typename Epi>
__global__ void __launch_bounds__(TG_THREADS, TG_CTAS_PER_SM)
    tap_gemm_wgmma_kernel(TapGemm g, Epi epi, int vec_a, int vec_b) {
  extern __shared__ uint8_t tg_smem[];
  uint8_t* ring = align_1024(tg_smem);
  const int tid = threadIdx.x, wg = tid / WG_THREADS, lt = tid % WG_THREADS;
  const int m0 = blockIdx.y * TG_BM, n0 = blockIdx.x * TG_BN;
  const int ktiles = (g.k_in + TG_BK - 1) / TG_BK, steps = g.taps * ktiles;
  constexpr int AHEAD = TG_STAGES - 1 - TG_INFLIGHT;  // k steps loaded ahead of the one multiplied

  TapRows rows;
  if (vec_a) {
#pragma unroll
    for (int j = 0; j < 4; ++j) rows.set(g, j, m0 + (tid >> 3) + 32 * j);
  } else {
    rows.set(g, 0, m0 + (tid >> 1));
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < steps) tap_gemm_load(g, rows, ring, s, s, ktiles, n0, vec_a, vec_b);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    // this step's copies have landed for every thread, and every warpgroup's
    // products of step - 1 - TG_INFLIGHT (whose stage the load below
    // refills) are done
    cp_async_wait<AHEAD - 1>();
    fence_proxy_async();
    __syncthreads();
    const int next = step + AHEAD;
    if (next < steps) tap_gemm_load(g, rows, ring, next % TG_STAGES, next, ktiles, n0, vec_a, vec_b);
    cp_async_commit();

    uint8_t* sa = ring + (step % TG_STAGES) * TG_STAGE_BYTES;
    const uint32_t a_tile = smem_addr(sa + wg * WG_TILE_BYTES), b_tile = smem_addr(sa + 2 * WG_TILE_BYTES);
    const uint64_t da = make_desc<false>(a_tile);
    wgmma_fence();
    if (g.w_trans) {
      const uint64_t db = make_desc<false>(b_tile);
#pragma unroll
      for (int kk = 0; kk < TG_BK / 16; ++kk)
        WgmmaSS<128, 0, 0>::run(acc, desc_k<false>(da, kk), desc_k<false>(db, kk), 1);
    } else {
      const uint64_t db = make_desc_mn(b_tile, WG_TILE_BYTES);
#pragma unroll
      for (int kk = 0; kk < TG_BK / 16; ++kk)
        WgmmaSS<128, 0, 1>::run(acc, desc_k<false>(da, kk), desc_k<true>(db, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<TG_INFLIGHT>();
    tg_fence_acc(acc);
  }
  wgmma_wait<0>();
  tg_fence_acc(acc);
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: this warpgroup's rows m0 + 64 wg .. + 63 as two 64 x 64 sub-tiles
  float* stage = reinterpret_cast<float*>(ring) + wg * 2 * TG_SUB;
  const int ld = GEMM_BN + 1, r0 = 16 * (lt / 32) + (lt % 32) / 4, mw = m0 + wg * 64;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = r0 + 8 * h, c = 8 * j + 2 * (lt % 4) + e;
        const int m = mw + r, n = n0 + c;
        stage[(c >> 6) * TG_SUB + r * ld + (c & 63)] =
            (m < g.M && n < g.N) ? epi.prep(m, n, acc[4 * j + 2 * h + e]) : 0.f;
      }
  __syncthreads();
#pragma unroll
  for (int sub = 0; sub < 2; ++sub)
    for (int e = lt; e < 64 * 64; e += WG_THREADS) {
      const int r = e >> 6, c = e & 63, m = mw + r, n = n0 + sub * 64 + c;
      if (m < g.M && n < g.N) epi.store(m, n, stage + sub * TG_SUB, r, c);
    }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// ---- the f32 tap GEMM on the FP32 pipes -----------------------------------
// The f32 form of the product inside #1, #3-#5 and #11-#13 under the same
// contract (TapGemm, Epi). It stays true f32: TF32 keeps about three digits,
// and the f32 bars are 1e-4. What bounds it on the H100: its products on the
// FMA units, 2*M*N*K*taps FLOPs at 67 TFLOP/s (the DiT block's conv1 at
// 16 x 1024 rows: 25.8 GFLOP, 0.385 ms), and the scheduler's one instruction
// a clock, so every load, address or barrier instruction takes an FFMA's slot.
//
// Design: a register-blocked SIMT tile of 256 threads. A thread holds TM x TN
// outputs as (TM/4) x (TN/4) groups of 4 x 4 at a stride of 64 rows and 64
// columns, and reads them per k by float4 from [k][m] and [k][n] tiles in
// shared memory: 128 x 128 (8 x 8 a thread, 4 LDS.128 per 64 FFMA) where the
// grid holds 128 x 128 tiles for at least three quarters of the SMs, else
// 64 x 64 (4 x 4), so that a request's M = 2048 at N = 256 still launches 128
// CTAs. A warp covers 4 x 8 threads, so a fragment load reads 64 (A) or 128
// (B) contiguous bytes. The k step is 16 deep. Every operand comes in by
// 16-byte cp.async through a 4-deep ring, three steps ahead of the products,
// one barrier a step and no registers held across the products: W[k, n] as
// the [k][n] tile the products read; A's rows (and W^T's rows under w_trans),
// whose k is contiguous, as they lie in 64-byte rows (XOR-swizzled so that a
// quarter-warp's float4s hit distinct banks), then one step ahead each thread
// moves its float4s into the [k][m] tile (row stride BM + 4: free of bank
// conflicts). Rows outside [0, min(t_in, row_len[b])) and columns at or past
// k_in read zeros (cp.async zero-fills); where lda or ldw is not a multiple of
// 4, a pointer is not 16-byte aligned or k_split is not a multiple of 4, the
// copies are element by element (an odd lda such as 1025). Each output is one
// fmaf chain from 0 over the taps in order, then k ascending, padded with
// zeros to a multiple of 16: the f32 callers' bits are this order's, whatever
// the tile. The epilogue stages the tile as 64 x 64 sub-tiles of row stride
// GEMM_BN + 1 in the ring's memory and calls prep and store.
constexpr int FG_BK = 16, FG_THREADS = 256, FG_STAGES = 4;
constexpr int FG_CTAS_PER_SM = 2;  // at most 128 registers a thread

template <int BM, int BN, bool WT>
struct FgTile {
  static constexpr int TM = BM / 16, TN = BN / 16;        // outputs a thread holds
  static constexpr int LDA = BM + 4, LDB = BN + 4;        // row strides of the [k][m] and [k][n] tiles
  static constexpr int AV = BM * FG_BK / 4 / FG_THREADS;  // float4s of A a thread copies a step
  static constexpr int BV = BN * FG_BK / 4 / FG_THREADS;  // and of W
  static constexpr int RAW_A = BM * FG_BK;                // A's rows as they lie
  static constexpr int W_SLOT = WT ? BN * FG_BK : FG_BK * LDB;  // W^T's rows as they lie, or the [k][n] tile
  static constexpr int SLOT = RAW_A + W_SLOT;             // floats of one ring stage
  static constexpr int T_BUF = FG_BK * LDA + (WT ? FG_BK * LDB : 0);  // the transposed tiles, two buffers
  static constexpr int RING = FG_STAGES * SLOT + 2 * T_BUF;
  static constexpr int SUBS = (BM / 64) * (BN / 64);      // staged 64 x 64 sub-tiles
  static constexpr int SMEM = 4 * (RING > SUBS * TG_SUB ? RING : SUBS * TG_SUB);
};

// chunk (16 bytes) kq of row r of a [rows][16] tile as it lies: chunks 0-3
// XORed with 2 on rows 2 and 3 of every 4, so that the float4s a quarter-warp
// reads in fg_transpose (4 rows x 2 chunks) fall in distinct banks
__device__ __forceinline__ int fg_chunk(int r, int kq) { return r * FG_BK + 4 * (kq ^ (r & 2)); }

// float4 e of a [R rows][16 k] tile in fg_transpose: row (e / 2) % R, chunk
// (e & 1) + 2 ((e / 2) / R); 16 rows a warp, so its stores into the [k][R + 4]
// tile hit 32 distinct banks
template <int R> __device__ __forceinline__ int fg_row(int e) { return (e >> 1) % R; }
template <int R> __device__ __forceinline__ int fg_kq(int e) { return (e & 1) | (((e >> 1) / R) << 1); }

// A's rows of the step at (shift, k0) -> raw [BM][16]: float4 e = tid + 256 l
// is chunk e % 4 of row e / 4 (four threads a 64-byte row), the rows of
// `rows` slot l
template <int BM, int AV>
__device__ __forceinline__ void fg_copy_a(const TapGemm& g, const TapRows& rows, int shift, int k0, bool vec,
                                          float* raw) {
  const float* A0 = static_cast<const float*>(g.a0);
  const float* A1 = static_cast<const float*>(g.a1);
  const int ka = min(g.k_split, g.k_in);  // columns read from a0
#pragma unroll
  for (int l = 0; l < AV; ++l) {
    const int e = threadIdx.x + FG_THREADS * l, r = e >> 2, kq = e & 3, k = k0 + 4 * kq;
    const long long row = k < g.k_in ? rows.row(l, shift) : -1;
    float* dst = raw + fg_chunk(r, kq);
    if (vec) {
      const float* src = A0;
      int n = 0;
      if (row >= 0) {
        if (k < ka) {
          src = A0 + row * g.lda + k;
          n = min(ka - k, 4);
        } else {
          src = A1 + row * g.lda + (k - g.k_split);
          n = min(g.k_in - k, 4);
        }
      }
      cp_async16(smem_addr(dst), src, n * 4);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k + j;
        dst[j] = (row < 0 || kj >= g.k_in) ? 0.f
                 : (kj < ka ? A0[row * g.lda + kj] : A1[row * g.lda + (kj - g.k_split)]);
      }
    }
  }
}

// W^T's rows n0 .. n0 + BN - 1 (k contiguous) at k0 -> raw [BN][16]; W is the tap's
template <int BN, int BV>
__device__ __forceinline__ void fg_copy_wt(const TapGemm& g, const float* W, int n0, int k0, bool vec, float* raw) {
#pragma unroll
  for (int l = 0; l < BV; ++l) {
    const int e = threadIdx.x + FG_THREADS * l, r = e >> 2, kq = e & 3, n = n0 + r, k = k0 + 4 * kq;
    float* dst = raw + fg_chunk(r, kq);
    const bool in = n < g.N && k < g.k_in;
    if (vec) {
      cp_async16(smem_addr(dst), in ? W + (long long)n * g.ldw + k : W, in ? 4 * min(g.k_in - k, 4) : 0);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[j] = (in && k + j < g.k_in) ? W[(long long)n * g.ldw + k + j] : 0.f;
    }
  }
}

// W[k, n] rows k0 .. k0 + 15 -> the [16][BN + 4] tile s: by cp.async (zero-
// filled past k_in and N), or element by element
template <int BN, int BV>
__device__ __forceinline__ void fg_copy_w(const TapGemm& g, const float* W, int n0, int k0, bool vec, float* s) {
#pragma unroll
  for (int l = 0; l < BV; ++l) {
    const int e = threadIdx.x + FG_THREADS * l, kk = e / (BN / 4), c = 4 * (e % (BN / 4));
    const int k = k0 + kk, n = n0 + c;
    float* dst = s + kk * (BN + 4) + c;
    if (vec) {
      const int nb = (k < g.k_in && n < g.N) ? min(g.N - n, 4) : 0;
      cp_async16(smem_addr(dst), nb ? W + (long long)k * g.ldw + n : W, nb * 4);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[j] = (k < g.k_in && n + j < g.N) ? W[(long long)k * g.ldw + n + j] : 0.f;
    }
  }
}

// raw [R][16] (as fg_copy_a / fg_copy_wt lay it) -> t [16][R + 4]
template <int R>
__device__ __forceinline__ void fg_transpose(const float* raw, float* t) {
#pragma unroll
  for (int l = 0; l < R * FG_BK / 4 / FG_THREADS; ++l) {
    const int e = threadIdx.x + FG_THREADS * l, r = fg_row<R>(e), kq = fg_kq<R>(e);
    const float4 v = *reinterpret_cast<const float4*>(raw + fg_chunk(r, kq));
    t[(4 * kq + 0) * (R + 4) + r] = v.x;
    t[(4 * kq + 1) * (R + 4) + r] = v.y;
    t[(4 * kq + 2) * (R + 4) + r] = v.z;
    t[(4 * kq + 3) * (R + 4) + r] = v.w;
  }
}

// acc += the products of one stage: sa [16][LDA], sb [16][LDB]
template <int BM, int BN, int LDA = BM + 4, int LDB = BN + 4>
__device__ __forceinline__ void fg_mma(const float* sa, const float* sb, int tr, int tc,
                                       float (&acc)[BM / 16][BN / 16]) {
  constexpr int TM = BM / 16, TN = BN / 16;
#pragma unroll
  for (int kk = 0; kk < FG_BK; ++kk) {
    float a[TM], b[TN];
#pragma unroll
    for (int p = 0; p < TM / 4; ++p) {
      const float4 x = *reinterpret_cast<const float4*>(sa + kk * LDA + 64 * p + 4 * tr);
      a[4 * p] = x.x; a[4 * p + 1] = x.y; a[4 * p + 2] = x.z; a[4 * p + 3] = x.w;
    }
#pragma unroll
    for (int q = 0; q < TN / 4; ++q) {
      const float4 x = *reinterpret_cast<const float4*>(sb + kk * LDB + 64 * q + 4 * tc);
      b[4 * q] = x.x; b[4 * q + 1] = x.y; b[4 * q + 2] = x.z; b[4 * q + 3] = x.w;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <int BM, int BN, bool WT, typename Epi>
__global__ void __launch_bounds__(FG_THREADS, FG_CTAS_PER_SM)
    tap_gemm_f32_kernel(TapGemm g, Epi epi, int vec_a, int vec_b) {
  using L = FgTile<BM, BN, WT>;
  extern __shared__ float4 fg_smem[];
  float* ring = reinterpret_cast<float*>(fg_smem);  // FG_STAGES slots: raw A, then W (or raw W^T)
  float* tbuf = ring + FG_STAGES * L::SLOT;         // two buffers: A [16][LDA] (then W^T [16][LDB])
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // this thread's rows 64 p + 4 tr + i and columns 64 q + 4 tc + j
  const int tr = (warp >> 1) * 4 + (lane >> 3), tc = (warp & 1) * 8 + (lane & 7);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ktiles = (g.k_in + FG_BK - 1) / FG_BK, steps = g.taps * ktiles;

  TapRows rows;
#pragma unroll
  for (int l = 0; l < L::AV; ++l) rows.set(g, l, m0 + ((tid + FG_THREADS * l) >> 2));

  float acc[L::TM][L::TN];
#pragma unroll
  for (int i = 0; i < L::TM; ++i)
#pragma unroll
    for (int j = 0; j < L::TN; ++j) acc[i][j] = 0.f;

  // the copies of k step `step` into its ring slot
  auto issue = [&](int step) {
    float* slot = ring + (step % FG_STAGES) * L::SLOT;
    const int tap = step / ktiles, k0 = (step - tap * ktiles) * FG_BK;
    const float* W = static_cast<const float*>(g.w) + tap * g.w_tap_stride;
    fg_copy_a<BM, L::AV>(g, rows, g.shift0 + tap * g.shift_step, k0, vec_a, slot);
    if constexpr (WT)
      fg_copy_wt<BN, L::BV>(g, W, n0, k0, vec_b, slot + L::RAW_A);
    else
      fg_copy_w<BN, L::BV>(g, W, n0, k0, vec_b, slot + L::RAW_A);
  };
  // k step `step`'s rows as they lie -> its transposed buffer
  auto transpose = [&](int step) {
    const float* slot = ring + (step % FG_STAGES) * L::SLOT;
    float* t = tbuf + (step & 1) * L::T_BUF;
    fg_transpose<BM>(slot, t);
    if constexpr (WT) fg_transpose<BN>(slot + L::RAW_A, t + FG_BK * L::LDA);
  };

#pragma unroll
  for (int s = 0; s < FG_STAGES - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }
  cp_async_wait<FG_STAGES - 2>();
  __syncthreads();
  transpose(0);
  for (int step = 0; step < steps; ++step) {
    // step + 1's copies have landed for every thread, step's transposed tiles
    // are written, and every thread's products of step - 1 (whose slot and
    // transposed buffer are refilled below) are done
    cp_async_wait<FG_STAGES - 3>();
    __syncthreads();
    if (step + FG_STAGES - 1 < steps) issue(step + FG_STAGES - 1);
    cp_async_commit();
    if (step + 1 < steps) transpose(step + 1);
    const float* t = tbuf + (step & 1) * L::T_BUF;
    const float* sb = WT ? t + FG_BK * L::LDA : ring + (step % FG_STAGES) * L::SLOT + L::RAW_A;
    fg_mma<BM, BN>(t, sb, tr, tc, acc);
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: sub-tile (p, q) holds rows m0 + 64 p .., columns n0 + 64 q ..
  float* stage = ring;
  constexpr int QN = BN / 64, ld = GEMM_BN + 1;
#pragma unroll
  for (int i = 0; i < L::TM; ++i)
#pragma unroll
    for (int j = 0; j < L::TN; ++j) {
      const int p = i >> 2, q = j >> 2, r = 4 * tr + (i & 3), c = 4 * tc + (j & 3);
      const int m = m0 + 64 * p + r, n = n0 + 64 * q + c;
      stage[(p * QN + q) * TG_SUB + r * ld + c] = (m < g.M && n < g.N) ? epi.prep(m, n, acc[i][j]) : 0.f;
    }
  __syncthreads();
#pragma unroll
  for (int sub = 0; sub < L::SUBS; ++sub)
    for (int e = tid; e < 64 * 64; e += FG_THREADS) {
      const int r = e >> 6, c = e & 63, m = m0 + 64 * (sub / QN) + r, n = n0 + 64 * (sub % QN) + c;
      if (m < g.M && n < g.N) epi.store(m, n, stage + sub * TG_SUB, r, c);
    }
}

// The f32 tap GEMM's CTA tile (BM = BN) for an M x N output: 128 where the
// grid holds 128 x 128 tiles for at least three quarters of the SMs (the
// request's conv1 at M = 2048, N = 1024: 128 tiles), else 64.
inline int tap_gemm_f32_tile(int M, int N) {
  const long long tiles = (long long)((M + 127) / 128) * ((N + 127) / 128);
  return 4 * tiles >= 3 * NUM_SMS ? 128 : 64;
}

template <int BM, int BN, bool WT, typename Epi>
void launch_tap_gemm_f32(const TapGemm& g, const Epi& epi, int vec_a, int vec_b, cudaStream_t stream) {
  constexpr int smem = FgTile<BM, BN, WT>::SMEM;
  const dim3 grid((g.N + BN - 1) / BN, (g.M + BM - 1) / BM);
  cudaFuncSetAttribute(tap_gemm_f32_kernel<BM, BN, WT, Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  tap_gemm_f32_kernel<BM, BN, WT, Epi><<<grid, FG_THREADS, smem, stream>>>(g, epi, vec_a, vec_b);
}

// f32: the FMA kernel; bf16: the wgmma kernel. Errors surface through the
// caller's cudaGetLastError.
template <typename T, typename Epi>
void launch_tap_gemm(const TapGemm& g, const Epi& epi, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    const int vec_a = g.lda % 8 == 0 && aligned16(g.a0) &&
                      (g.k_split >= g.k_in || (g.k_split % 8 == 0 && aligned16(g.a1)));
    const int vec_b = g.ldw % 8 == 0 && g.w_tap_stride % 8 == 0 && aligned16(g.w);
    cudaFuncSetAttribute(tap_gemm_wgmma_kernel<Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize, TG_SMEM);
    dim3 grid((g.N + TG_BN - 1) / TG_BN, (g.M + TG_BM - 1) / TG_BM);
    tap_gemm_wgmma_kernel<Epi><<<grid, TG_THREADS, TG_SMEM, stream>>>(g, epi, vec_a, vec_b);
  } else {
    const int vec_a = g.lda % 4 == 0 && aligned16(g.a0) &&
                      (g.k_split >= g.k_in || (g.k_split % 4 == 0 && aligned16(g.a1)));
    const int vec_b = g.ldw % 4 == 0 && g.w_tap_stride % 4 == 0 && aligned16(g.w);
    const bool big = tap_gemm_f32_tile(g.M, g.N) == 128;
    if (big && g.w_trans)
      launch_tap_gemm_f32<128, 128, true>(g, epi, vec_a, vec_b, stream);
    else if (big)
      launch_tap_gemm_f32<128, 128, false>(g, epi, vec_a, vec_b, stream);
    else if (g.w_trans)
      launch_tap_gemm_f32<64, 64, true>(g, epi, vec_a, vec_b, stream);
    else
      launch_tap_gemm_f32<64, 64, false>(g, epi, vec_a, vec_b, stream);
  }
}

// warp-wide sum
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---- LayerNorm (no affine, f32 stats) + adaLN modulate (+ mask) -----------
// One warp per row of x [M = B*T, C]; mods [B, n_mods, C] holds the shift
// and scale rows at shift_idx / scale_idx; mask [M] or nullptr.
template <typename Tin, typename Tout>
__global__ void ln_mod_kernel(const Tin* x, const Tout* mods, int n_mods, int shift_idx, int scale_idx,
                              const float* mask, Tout* out, int M, int T, int C, float eps) {
  int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  int lane = threadIdx.x % 32;
  if (row >= M) return;
  const Tin* xr = x + (long long)row * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += to_f(xr[c]);
  float mu = warp_sum(s) / C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    float d = to_f(xr[c]) - mu;
    v += d * d;
  }
  float rstd = rsqrtf(warp_sum(v) / C + eps);
  int b = row / T;
  const Tout* shift = mods + ((long long)b * n_mods + shift_idx) * C;
  const Tout* scale = mods + ((long long)b * n_mods + scale_idx) * C;
  float m = mask ? mask[row] : 1.f;
  for (int c = lane; c < C; c += 32) {
    float h = (to_f(xr[c]) - mu) * rstd;
    h = h * (1.f + to_f(scale[c])) + to_f(shift[c]);
    if (mask) h *= m;
    out[(long long)row * C + c] = from_f<Tout>(h);
  }
}

constexpr int LN_ROWS = 8;  // warps (rows) per LayerNorm block

template <typename Tin, typename Tout>
void launch_ln_mod(const Tin* x, const Tout* mods, int n_mods, int shift_idx, int scale_idx, const float* mask,
                   Tout* out, int M, int T, int C, float eps, cudaStream_t stream) {
  ln_mod_kernel<Tin, Tout><<<(M + LN_ROWS - 1) / LN_ROWS, 32 * LN_ROWS, 0, stream>>>(
      x, mods, n_mods, shift_idx, scale_idx, mask, out, M, T, C, eps);
}

// ---- QKV projection epilogue: bias, q scale, rounding, RoPE ----------------
// The product is [M, 3C] (q | k | v); q and k rotate their first 2*half
// features of each head as x*cos + neg_half(x)*sin, neg_half(x) =
// [-x[half:2half], x[:half]], on the values already rounded to T. half is
// D/4 for StableTTS's partial RoPE and D/2 for a rotation of the whole head
// (F5-TTS, whose interleaved pairs are this form after a fixed permutation
// of each head's q and k columns); 2*half <= D <= 64, so a partner column
// lies in the same 64-column sub-tile.
template <typename T>
struct QkvEpi {
  const T* bias;
  T* q;
  T* k;
  T* v;
  const float* cos_t;  // [T, half]
  const float* sin_t;
  int C, D, half, T_;
  float q_scale;
  __device__ float prep(int m, int n, float acc) const {
    float val = acc + to_f(bias[n]);
    if (n < C) val *= q_scale;
    return round_to<T>(val);
  }
  __device__ void store(int m, int n, const float* tile, int r, int c) const {
    const int ld = GEMM_BN + 1;
    int which = n / C, nn = n % C, jj = nn % D;
    float x = tile[r * ld + c];
    T* dst = which == 0 ? q : (which == 1 ? k : v);
    if (which < 2 && jj < 2 * half) {
      int t = m % T_;
      int i = jj % half;
      float cs = cos_t[t * half + i], sn = sin_t[t * half + i];
      float partner = jj < half ? -tile[r * ld + c + half] : tile[r * ld + c - half];
      x = x * cs + partner * sn;
    }
    dst[(long long)m * C + nn] = from_f<T>(x);
  }
};

// ---- out-projection epilogue: out = x + ((acc + bo) * gate) * m -----------
// mods [B, n_mods, C] holds the gate row at gate_idx. Tout is float where the
// caller keeps the residual stream in f32 (the whole block's x1), T where the
// result is rounded to the activation type (the attention half alone).
template <typename T, typename Tout>
struct OutProjEpi {
  const T* bias;
  const T* x;
  const T* mods;
  int n_mods, gate_idx;
  const float* mask;
  Tout* out;
  int C, T_;
  __device__ float prep(int m, int n, float acc) const { return acc + to_f(bias[n]); }
  __device__ void store(int m, int n, const float* tile, int r, int c) const {
    int b = m / T_;
    float gate = to_f(mods[((long long)b * n_mods + gate_idx) * C + n]);
    float o = tile[r * (GEMM_BN + 1) + c];
    out[(long long)m * C + n] = from_f<Tout>(to_f(x[(long long)m * C + n]) + o * gate * mask[m]);
  }
};

// ---- FFN conv1 epilogue: y = silu(acc + b1) * m ----------------------------
template <typename T>
struct Conv1Epi {
  const T* bias;
  const float* mask;
  T* y;
  int N;
  __device__ float prep(int m, int n, float acc) const { return acc + to_f(bias[n]); }
  __device__ void store(int m, int n, const float* tile, int r, int c) const {
    float v = tile[r * (GEMM_BN + 1) + c];
    float s = v / (1.f + expf(-v));
    y[(long long)m * N + n] = from_f<T>(s * mask[m]);
  }
};

// ---- FFN conv1 epilogue, GELU form: y = gelu_tanh(acc + b1) * m ------------
// GELU in its tanh approximation, 0.5 v (1 + tanh(sqrt(2/pi) (v + 0.044715 v^3))),
// in f32 (F5-TTS's FFN: one tap, so the mask only zeroes padded rows).
template <typename T>
struct Conv1GeluEpi {
  const T* bias;
  const float* mask;
  T* y;
  int N;
  __device__ float prep(int m, int n, float acc) const { return acc + to_f(bias[n]); }
  __device__ void store(int m, int n, const float* tile, int r, int c) const {
    float v = tile[r * (GEMM_BN + 1) + c];
    float g = 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
    y[(long long)m * N + n] = from_f<T>(g * mask[m]);
  }
};

// ---- FFN conv2 epilogue: out = res + gate * ((acc + b2) * m) ---------------
// res is the residual stream: f32 x1 inside the whole block, the activation
// type where the FFN half runs alone.
template <typename T, typename Tres>
struct Conv2Epi {
  const T* bias;
  const T* mods;
  int n_mods, gate_idx;
  const float* mask;
  const Tres* res;
  T* out;
  int C, T_;
  __device__ float prep(int m, int n, float acc) const { return acc + to_f(bias[n]); }
  __device__ void store(int m, int n, const float* tile, int r, int c) const {
    int b = m / T_;
    float gate = to_f(mods[((long long)b * n_mods + gate_idx) * C + n]);
    float z = tile[r * (GEMM_BN + 1) + c] * mask[m];
    out[(long long)m * C + n] = from_f<T>(to_f(res[(long long)m * C + n]) + gate * z);
  }
};

// ---- Philox4x32-10 --------------------------------------------------------
// Counter-based random bits: the same (counter, key) gives the same four
// words on any thread and in the plain PyTorch version (ops/philox.py), so
// a backward pass regenerates its forward's dropout mask instead of
// storing it.
__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    uint32_t hi0 = __umulhi(0xD2511F53u, ctr.x), lo0 = 0xD2511F53u * ctr.x;
    uint32_t hi1 = __umulhi(0xCD9E8D57u, ctr.z), lo1 = 0xCD9E8D57u * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ k0, lo1, hi0 ^ ctr.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return ctr;
}

__device__ __forceinline__ uint32_t word_of(uint4 w, int i) {
  return i == 0 ? w.x : (i == 1 ? w.y : (i == 2 ? w.z : w.w));
}

// Dropout of one call: the key comes from a device int64 [2] tensor (drawn
// from the trainer's generator), an element is kept when its word is at
// least `thresh`, and kept values are scaled by `scale` = 1 / (1 - rate).
// `row0` is the first row of this call's batch in the global batch of a
// data-parallel step: a counter holds the global row b + row0, so each rank
// draws its own rows of the one-process mask (0 on one process).
struct Dropout {
  const long long* seed;  // nullptr: no dropout
  unsigned int thresh;
  float scale;
  int row0;
  // the counter word of batch row b, head h (of H)
  __device__ __forceinline__ uint32_t row_head(int b, int H, int h) const {
    return (uint32_t)(b + row0) * (uint32_t)H + (uint32_t)h;
  }
  // multiplier of the element whose counter is (c0, c1, c2, c3), word i
  __device__ __forceinline__ float factor(uint4 words, int i) const {
    return word_of(words, i) >= thresh ? scale : 0.f;
  }
  __device__ __forceinline__ uint4 bits(uint32_t c0, uint32_t c1, uint32_t c2, uint32_t c3) const {
    return philox4x32_10(make_uint4(c0, c1, c2, c3), (uint32_t)seed[0], (uint32_t)seed[1]);
  }
};

// from a C entry point's arguments (thresh is the unsigned threshold passed as int)
inline Dropout make_dropout(const void* seed, int thresh, float scale, int row0) {
  return Dropout{static_cast<const long long*>(seed), (unsigned int)thresh, scale, row0};
}

// ---- LayerNorm + modulate backward ----------------------------------------
// Per row: n = LN(x), dn = dh0 * (1 + scale),
// dx = do + (dn - mean(dn) - n * mean(dn * n)) * rstd; also writes dh0 * n
// (summed over rows into dscale by colsum_kernel).
template <typename T>
__global__ void ln_bwd_kernel(const T* x, const float* dh0, const T* mods, int n_mods, int scale_idx,
                              const T* dout, T* dx, float* dh0n, int M, int T_, int C, float eps) {
  int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  int lane = threadIdx.x % 32;
  if (row >= M) return;
  const long long base = (long long)row * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += to_f(x[base + c]);
  float mu = warp_sum(s) / C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    float d = to_f(x[base + c]) - mu;
    v += d * d;
  }
  float rstd = rsqrtf(warp_sum(v) / C + eps);
  const T* scale = mods + ((long long)(row / T_) * n_mods + scale_idx) * C;
  float sdn = 0.f, sdnn = 0.f;
  for (int c = lane; c < C; c += 32) {
    float n = (to_f(x[base + c]) - mu) * rstd;
    float dn = dh0[base + c] * (1.f + to_f(scale[c]));
    sdn += dn;
    sdnn += dn * n;
  }
  float dn_mean = warp_sum(sdn) * (1.f / C), dnn_mean = warp_sum(sdnn) * (1.f / C);
  for (int c = lane; c < C; c += 32) {
    float n = (to_f(x[base + c]) - mu) * rstd;
    float g = dh0[base + c];
    float dn = g * (1.f + to_f(scale[c]));
    dx[base + c] = from_f<T>(to_f(dout[base + c]) + (dn - dn_mean - n * dnn_mean) * rstd);
    dh0n[base + c] = g * n;
  }
}

template <typename T>
void launch_ln_bwd(const T* x, const float* dh0, const T* mods, int n_mods, int scale_idx, const T* dout, T* dx,
                   float* dh0n, int M, int T_, int C, float eps, cudaStream_t stream) {
  ln_bwd_kernel<T><<<(M + LN_ROWS - 1) / LN_ROWS, 32 * LN_ROWS, 0, stream>>>(
      x, dh0, mods, n_mods, scale_idx, dout, dx, dh0n, M, T_, C, eps);
}

// ---- column sums over groups of rows, in a fixed order (no atomics) -------
// out[g * out_stride + n] = sum_{r < rows} X[(g * rows + r) * N + n], f32.
// The bias gradients and dmod of the training backwards. A memory-bound
// reduction with no product in it, so one kernel serves f32 and bf16; what
// bounds it is reading X once (an [M = 32000, 1024] f32 X takes ~39 us at
// 3.35 TB/s). One CTA per 32 columns and group, walking all of a group's rows,
// gave 8 CTAs on 132 SMs for a bias of N = 256; so each group's rows are cut
// into `chunks` consecutive chunks, about COLSUM_TARGET_CTAS CTAs in all.
//
// Pass 1, colsum_chunk_kernel: a CTA is 32 column lanes x 8 row lanes; a lane
// takes V adjacent columns (V = 4, one 16-byte f32 or 8-byte bf16 load, where
// N is a multiple of 4 and X is aligned; else V = 1), row lane ry adds rows
// ry, ry + 8, ... of the chunk, and the 8 row lanes are added in order. With
// one chunk it writes out; else it writes the chunk's partial to
// ws[(g * chunks + c) * N + n], and pass 2, colsum_kernel with the chunks as
// the rows, adds the partials in chunk order. The same sums on every run.
template <typename Tin>
__global__ void colsum_kernel(const Tin* X, float* out, int rows, int N, long long out_stride) {
  __shared__ float part[8][33];
  const int cx = threadIdx.x % 32, ry = threadIdx.x / 32;
  const int n = blockIdx.x * 32 + cx;
  const long long base = (long long)blockIdx.y * rows;
  float s = 0.f;
  if (n < N)
    for (int r = ry; r < rows; r += 8) s += to_f(X[(base + r) * N + n]);
  part[ry][cx] = s;
  __syncthreads();
  if (ry == 0 && n < N) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) t += part[i][cx];
    out[blockIdx.y * out_stride + n] = t;
  }
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}
__device__ __forceinline__ void load4(const bf16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(u.x << 16); v[1] = __uint_as_float(u.x & 0xFFFF0000u);
  v[2] = __uint_as_float(u.y << 16); v[3] = __uint_as_float(u.y & 0xFFFF0000u);
}

// dst[g * g_stride + c * c_stride + n] = the sum of chunk c (grid z) of group
// g (grid y) over columns n of this CTA (grid x)
template <typename Tin, int V>
__global__ void __launch_bounds__(256) colsum_chunk_kernel(const Tin* X, float* dst, int rows, int N, int row_chunk,
                                                           long long g_stride, long long c_stride) {
  __shared__ float part[8][32 * V + 1];
  const int cx = threadIdx.x % 32, ry = threadIdx.x / 32;
  const int n = (blockIdx.x * 32 + cx) * V;
  const int r_begin = blockIdx.z * row_chunk, r_end = min(rows, r_begin + row_chunk);
  const Tin* xg = X + (long long)blockIdx.y * rows * N;
  float s[V];
#pragma unroll
  for (int e = 0; e < V; ++e) s[e] = 0.f;
  if (n < N) {
#pragma unroll 4
    for (int r = r_begin + ry; r < r_end; r += 8) {
      float v[V];
      if constexpr (V == 4) {
        load4(xg + (long long)r * N + n, v);
      } else {
        v[0] = to_f(xg[(long long)r * N + n]);
      }
#pragma unroll
      for (int e = 0; e < V; ++e) s[e] += v[e];
    }
  }
#pragma unroll
  for (int e = 0; e < V; ++e) part[ry][cx * V + e] = s[e];
  __syncthreads();
  if (ry == 0 && n < N) {
    float* d = dst + blockIdx.y * g_stride + blockIdx.z * c_stride + n;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float t = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) t += part[i][cx * V + e];
      d[e] = t;
    }
  }
}

constexpr int COLSUM_TARGET_CTAS = 2 * NUM_SMS;
constexpr int COLSUM_MIN_ROWS = 64;  // rows per chunk, at least

// `ws` (ws_floats floats) holds the partials. The chunks depend only on the
// shapes, X's alignment and ws_floats.
template <typename Tin>
void launch_colsum(const Tin* X, float* out, int groups, int rows, int N, long long out_stride, float* ws,
                   long long ws_floats, cudaStream_t stream) {
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(X) % (4 * sizeof(Tin)) == 0;
  const int cols = vec ? 128 : 32, blocks = (N + cols - 1) / cols;
  long long chunks = max(1LL, (long long)COLSUM_TARGET_CTAS / ((long long)blocks * groups));
  chunks = min(chunks, max(1LL, (long long)rows / COLSUM_MIN_ROWS));
  chunks = max(1LL, min(chunks, ws_floats / ((long long)groups * N)));
  const int row_chunk = max(1, (int)((rows + chunks - 1) / chunks));
  chunks = max(1, (rows + row_chunk - 1) / row_chunk);
  float* dst = chunks > 1 ? ws : out;
  const long long g_stride = chunks > 1 ? chunks * N : out_stride, c_stride = chunks > 1 ? N : 0;
  const dim3 grid(blocks, groups, (unsigned)chunks);
  if (vec)
    colsum_chunk_kernel<Tin, 4><<<grid, 256, 0, stream>>>(X, dst, rows, N, row_chunk, g_stride, c_stride);
  else
    colsum_chunk_kernel<Tin, 1><<<grid, 256, 0, stream>>>(X, dst, rows, N, row_chunk, g_stride, c_stride);
  if (chunks > 1)
    colsum_kernel<float><<<dim3((N + 31) / 32, groups), 256, 0, stream>>>(ws, out, (int)chunks, N, out_stride);
}

// ---- weight gradient of a tap GEMM: the transposed product ---------------
// out[tap, m, n] = sum_{r < rows} A(r, tap)[m] * G[r, n], f32, where row
// r = b * t_len + t and A(r, tap) is activation row t + shift0 + tap *
// shift_step of item b (zero outside [0, t_len)). The rows are cut into
// `splits` consecutive chunks; one CTA per (output tile, tap, chunk) writes
// its partial sum to a workspace, and a second kernel adds the partials in
// chunk order. No atomics: the same sums on every run. Below, the f32 kernel
// (fp32 FMA, 128 x 128 tiles); after it the bf16 one on wgmma.
struct WGrad {
  const void* a;
  int lda;
  int ka;  // columns of A = rows of each output tap
  const void* g;
  int ldg;
  int n;   // columns of G = columns of the output
  int rows;
  int t_len;
  int shift0;
  int shift_step;
  float* out;
  int row_chunk;  // rows per chunk, a multiple of the kernel's k step (set by launch_wgrad)
};

// ---- the f32 weight gradient on the FP32 pipes ----------------------------
// The backward product of #11, #12 and #13 in f32, under the contract above.
// What bounds it on the H100: its products on the FMA units, 2 * rows * ka *
// n * taps FLOPs at 67 TFLOP/s (dW1 of the FFN at B*T = 32000: 50.3 GFLOP,
// 0.751 ms).
//
// Design: the f32 tap GEMM's register-blocked 128 (m, over ka) x 128 (n) tile
// (8 x 8 outputs a thread, 4 LDS.128 per 64 FFMA), the reduction running over
// rows 16 at a time. Both operands are read as they lie: a k step's 16 rows of
// A (m contiguous) and of G (n contiguous) are the [k][m] and [k][n] tiles
// the inner loop reads, so a 3-deep ring fills them by 16-byte cp.async, with
// no transpose and no registers, one barrier a step. The tap's shift lands on
// the k axis: row r = b * t_len + t copies activation row r + shift where t +
// shift lies in [0, t_len), else the chunk is zero-filled; so are chunks past
// ka or n and rows past the chunk's end. Where lda or ldg is not a multiple of
// 4 or a pointer is not 16-byte aligned the copies are element by element.
// Each partial is one fmaf chain over its chunk's rows in ascending order and
// sum_splits_kernel adds the partials in chunk order, so the chunks (counted
// at 64 x 64 tiles, see launch_wgrad) fix the f32 weight gradients' bits; at
// 128 x 128 tiles they make about 256 CTAs, one wave at two an SM.
constexpr int FW_BM = 128, FW_BN = 128, FW_STAGES = 3;
constexpr int FW_STAGE = FG_BK * (FW_BM + FW_BN);  // floats of one stage: A [16][128], then G [16][128]
constexpr int FW_SMEM = FW_STAGES * FW_STAGE * 4;
static_assert(FG_BK == GEMM_BK, "launch_wgrad cuts f32 row chunks in multiples of the kernel's k step");

// Stage s <- rows r0 .. r0 + 15 of the chunk (below r_end): 16 rows x 32
// chunks of 4 floats of each operand, chunk e = tid + 256 l at row e / 32
__device__ __forceinline__ void fw_load(const WGrad& p, float* s, int r0, int r_end, int shift, int m0, int n0,
                                        bool vec_a, bool vec_g) {
  const float* A = static_cast<const float*>(p.a);
  const float* G = static_cast<const float*>(p.g);
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    const int e = threadIdx.x + FG_THREADS * l, kr = e >> 5, c = 4 * (e & 31), r = r0 + kr;
    long long row = -1;  // the activation row that row r reads at this shift
    if (r < r_end) {
      const int t = r % p.t_len + shift;
      if (t >= 0 && t < p.t_len) row = (long long)r + shift;
    }
    float* da = s + kr * FW_BM + c;
    const int m = m0 + c;
    if (vec_a) {
      const int na = (row >= 0 && m < p.ka) ? min(p.ka - m, 4) : 0;
      cp_async16(smem_addr(da), na ? A + row * p.lda + m : A, na * 4);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) da[j] = (row >= 0 && m + j < p.ka) ? A[row * p.lda + m + j] : 0.f;
    }
    float* dg = s + FG_BK * FW_BM + kr * FW_BN + c;
    const int n = n0 + c;
    if (vec_g) {
      const int ng = (r < r_end && n < p.n) ? min(p.n - n, 4) : 0;
      cp_async16(smem_addr(dg), ng ? G + (long long)r * p.ldg + n : G, ng * 4);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) dg[j] = (r < r_end && n + j < p.n) ? G[(long long)r * p.ldg + n + j] : 0.f;
    }
  }
}

// (a template only so that it is compiled where an f32 launch_wgrad is)
template <typename T>
__global__ void __launch_bounds__(FG_THREADS, FG_CTAS_PER_SM)
    wgrad_f32_kernel(WGrad p, int taps, int vec_a, int vec_g) {
  static_assert(std::is_same<T, float>::value, "the FMA weight gradient takes f32");
  extern __shared__ float4 fw_smem[];
  float* ring = reinterpret_cast<float*>(fw_smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // this thread's m 64 p + 4 tr + i and n 64 q + 4 tc + j, as in the tap GEMM
  const int tr = (warp >> 1) * 4 + (lane >> 3), tc = (warp & 1) * 8 + (lane & 7);
  const int n0 = blockIdx.x * FW_BN, m0 = blockIdx.y * FW_BM;
  const int tap = blockIdx.z % taps, chunk = blockIdx.z / taps;
  const int shift = p.shift0 + tap * p.shift_step;
  const int r_begin = chunk * p.row_chunk, r_end = min(p.rows, r_begin + p.row_chunk);
  const int steps = max(0, (r_end - r_begin + FG_BK - 1) / FG_BK);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < FW_STAGES - 1; ++s) {
    if (s < steps) fw_load(p, ring + s * FW_STAGE, r_begin + s * FG_BK, r_end, shift, m0, n0, vec_a, vec_g);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    // this step's copies have landed for every thread, and every thread's
    // products of step - 1, whose stage the load below refills, are done
    cp_async_wait<FW_STAGES - 2>();
    __syncthreads();
    const int next = step + FW_STAGES - 1;
    if (next < steps)
      fw_load(p, ring + (next % FW_STAGES) * FW_STAGE, r_begin + next * FG_BK, r_end, shift, m0, n0, vec_a, vec_g);
    cp_async_commit();
    const float* cur = ring + (step % FW_STAGES) * FW_STAGE;
    fg_mma<FW_BM, FW_BN, FW_BM, FW_BN>(cur, cur + FG_BK * FW_BM, tr, tc, acc);
  }
  cp_async_wait<0>();

  float* out = p.out + ((long long)chunk * taps + tap) * p.ka * p.n;
  const bool vec_out = (p.n & 3) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + 64 * (i >> 2) + 4 * tr + (i & 3);
    if (m >= p.ka) continue;
    float* o = out + (long long)m * p.n;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int n = n0 + 64 * q + 4 * tc;
      if (vec_out && n < p.n) {
        *reinterpret_cast<float4*>(o + n) = make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2],
                                                        acc[i][4 * q + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < p.n) o[n + j] = acc[i][4 * q + j];
      }
    }
  }
}

// ---- the bf16 weight gradient on wgmma ------------------------------------
// Replaces, for bf16, the FMA kernel above under the same contract (WGrad, the
// row chunks, the workspace and the fixed-order sum of the partials). It is
// the backward product of #11, #12 and #13, which the TPU kernels run on the
// MXU (ffn_pallas_train.py: dot_general of bf16 operands with f32 sums). What
// bounds it on the H100: its products, 2 * rows * ka * n * taps FLOPs (dW1 of
// the FFN at B*T = 32000: 50.3 GFLOP, 0.051 ms at 989 TFLOP/s) against A and
// G read about once per tap.
//
// Design: the wgmma tap GEMM above turned on its side, the reduction running
// over rows. A 128 (m, over ka) x 128 (n) output tile, a 64-row k step, two
// consumer warpgroups of 64 m each issuing m64n128k16 with both operands
// MN-major: A's m and G's n are the contiguous axes of a row, so a k step's
// 64 rows are copied as they lie (A as two 64 x 64 tiles under make_desc<true>,
// G as two 64-wide atoms under make_desc_mn) and the transpose bits do the
// rest. The same 3-deep cp.async ring (97 KB, two CTAs an SM). The tap's shift
// lands on the k axis: row r = b * t_len + t copies activation row r + shift
// where t + shift lies in [0, t_len), else the 16-byte chunk is zero-filled;
// so are chunks past ka, n and the chunk's last row. One tap per CTA (grid z
// = tap x chunk), so the three taps of a conv read each G slab three times
// (from L2). Where lda or ldg is not a multiple of 8 or a pointer is not
// 16-byte aligned the copies are element by element: right, not fast. Each
// CTA writes its 128 x 128 f32 partial straight from the accumulators.

// Stage `stage` of the ring <- rows r0 .. r0 + 63 of the chunk (below r_end)
__device__ __forceinline__ void wgrad_load(const WGrad& p, uint8_t* ring, int stage, int r0, int r_end, int shift,
                                           int m0, int n0, bool vec_a, bool vec_g) {
  const bf16* A = static_cast<const bf16*>(p.a);
  const bf16* G = static_cast<const bf16*>(p.g);
  const int tid = threadIdx.x;
  uint8_t* sa = ring + stage * TG_STAGE_BYTES;
  uint8_t* sg = sa + 2 * WG_TILE_BYTES;
  // the activation row that row r reads at this shift, or -1 for zeros
  auto src_row = [&](int r) -> long long {
    if (r >= r_end) return -1;
    const int t = r % p.t_len + shift;
    return (t >= 0 && t < p.t_len) ? (long long)r + shift : -1;
  };
  if (vec_a || vec_g) {
    // 64 rows x 16 chunks: rows (tid / 16) + 16 i, chunk tid % 16 (tile chunk / 8)
    const int cb = tid & 15;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = (tid >> 4) + 16 * i, r = r0 + kr;
      const uint32_t off = kr * 128 + ((((cb & 7) ^ kr) & 7) << 4);
      if (vec_a) {
        const long long row = src_row(r);
        const int m = m0 + cb * 8, na = (row >= 0 && m < p.ka) ? min(p.ka - m, 8) : 0;
        cp_async16(smem_addr(sa + (cb >> 3) * WG_TILE_BYTES) + off, na ? A + row * p.lda + m : A, na * 2);
      }
      if (vec_g) {
        const int n = n0 + cb * 8, ng = (r < r_end && n < p.n) ? min(p.n - n, 8) : 0;
        cp_async16(smem_addr(sg + (cb >> 3) * WG_TILE_BYTES) + off, ng ? G + (long long)r * p.ldg + n : G, ng * 2);
      }
    }
  }
  if (!vec_a || !vec_g) {
    // row tid / 4, 32 columns from (tid % 4) * 32
    const int kr = tid >> 2, r = r0 + kr, c0 = (tid & 3) * 32;
    const long long row = src_row(r);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + q * 8;
      bf16 v[8];
      if (!vec_a) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int m = m0 + c + e;
          v[e] = (row >= 0 && m < p.ka) ? A[row * p.lda + m] : __ushort_as_bfloat16(0);
        }
        st_chunk(sa + (c >> 6) * WG_TILE_BYTES, kr, (c & 63) >> 3, pack8(v));
      }
      if (!vec_g) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int n = n0 + c + e;
          v[e] = (r < r_end && n < p.n) ? G[(long long)r * p.ldg + n] : __ushort_as_bfloat16(0);
        }
        st_chunk(sg + (c >> 6) * WG_TILE_BYTES, kr, (c & 63) >> 3, pack8(v));
      }
    }
  }
}

// (a template only so that it is compiled where a bf16 launch_wgrad is)
template <typename T>
__global__ void __launch_bounds__(TG_THREADS, TG_CTAS_PER_SM)
    wgrad_wgmma_kernel(WGrad p, int taps, int vec_a, int vec_g) {
  static_assert(std::is_same<T, bf16>::value, "the wgmma weight gradient takes bf16");
  extern __shared__ uint8_t wgr_smem[];
  uint8_t* ring = align_1024(wgr_smem);
  const int tid = threadIdx.x, wg = tid / WG_THREADS, lt = tid % WG_THREADS;
  const int n0 = blockIdx.x * TG_BN, m0 = blockIdx.y * TG_BM;
  const int tap = blockIdx.z % taps, chunk = blockIdx.z / taps;
  const int shift = p.shift0 + tap * p.shift_step;
  const int r_begin = chunk * p.row_chunk, r_end = min(p.rows, r_begin + p.row_chunk);
  const int steps = max(0, (r_end - r_begin + TG_BK - 1) / TG_BK);
  constexpr int AHEAD = TG_STAGES - 1 - TG_INFLIGHT;  // k steps loaded ahead of the one multiplied

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < steps) wgrad_load(p, ring, s, r_begin + s * TG_BK, r_end, shift, m0, n0, vec_a, vec_g);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    // as in tap_gemm_wgmma_kernel: this step's copies have landed, and both
    // warpgroups' products on the stage refilled below are done
    cp_async_wait<AHEAD - 1>();
    fence_proxy_async();
    __syncthreads();
    const int next = step + AHEAD;
    if (next < steps)
      wgrad_load(p, ring, next % TG_STAGES, r_begin + next * TG_BK, r_end, shift, m0, n0, vec_a, vec_g);
    cp_async_commit();

    uint8_t* sa = ring + (step % TG_STAGES) * TG_STAGE_BYTES;
    const uint64_t da = make_desc<true>(smem_addr(sa + wg * WG_TILE_BYTES));
    const uint64_t dg = make_desc_mn(smem_addr(sa + 2 * WG_TILE_BYTES), WG_TILE_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TG_BK / 16; ++kk) WgmmaSS<128, 1, 1>::run(acc, desc_k<true>(da, kk), desc_k<true>(dg, kk), 1);
    wgmma_commit();
    wgmma_wait<TG_INFLIGHT>();
    tg_fence_acc(acc);
  }
  wgmma_wait<0>();
  tg_fence_acc(acc);
  cp_async_wait<0>();

  // this warpgroup's m rows m0 + 64 wg .. + 63, straight from the accumulators
  float* out = p.out + ((long long)chunk * taps + tap) * p.ka * p.n;
  const int r0 = 16 * (lt / 32) + (lt % 32) / 4, mw = m0 + wg * 64;
  const bool pairs = (p.n & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = mw + r0 + 8 * h;
    if (m >= p.ka) continue;
    float* o = out + (long long)m * p.n;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + 8 * j + 2 * (lt % 4);
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (pairs && n < p.n) {
        *reinterpret_cast<float2*>(o + n) = make_float2(v0, v1);
      } else {
        if (n < p.n) o[n] = v0;
        if (n + 1 < p.n) o[n + 1] = v1;
      }
    }
  }
}

// out[i] = sum_{s < splits} part[s * size + i], in order of s
__global__ void sum_splits_kernel(const float* part, float* out, int splits, long long size) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[k * size + i];
  out[i] = s;
}

// f32 (FMA): chunks cut for about WGRAD_TARGET_CTAS tiles of 64 x 64 with
// 16-row steps, chunks of at least WGRAD_MIN_CHUNK rows (the chunks fix the
// f32 sums' bits, so the count stays at 64 x 64 tiles); wgrad_f32_kernel's
// 128 x 128 tiles make that about 256 CTAs, one wave. bf16 (wgmma, 128 x 128
// tiles, two CTAs an SM): at most WGRAD_WGMMA_CTAS, one wave, so that no
// second wave runs a few CTAs alone; chunks of at least WGRAD_WGMMA_MIN_CHUNK
// rows. At B*T = 32000 that is 240 CTAs for dW1 / dW2 of the FFN (5 chunks),
// 252 for dWqkv (21) and for dWo (63).
constexpr int WGRAD_TARGET_CTAS = 1024;
constexpr int WGRAD_MIN_CHUNK = 128;
constexpr int WGRAD_WGMMA_CTAS = TG_CTAS_PER_SM * NUM_SMS;
constexpr int WGRAD_WGMMA_MIN_CHUNK = 256;

// Splits the row reduction as above, as far as `ws` (ws_floats floats; may be
// nullptr) holds the partials. The split depends only on the shapes, the type
// and ws_floats. f32: the FMA kernel; bf16: the wgmma kernel.
template <typename T>
void launch_wgrad(WGrad p, int taps, float* ws, long long ws_floats, cudaStream_t stream) {
  constexpr bool tc = std::is_same<T, bf16>::value;
  constexpr int bm = tc ? TG_BM : GEMM_BM, bn = tc ? TG_BN : GEMM_BN, bk = tc ? TG_BK : GEMM_BK;
  const long long size = (long long)taps * p.ka * p.n;
  const int tiles = ((p.n + bn - 1) / bn) * ((p.ka + bm - 1) / bm) * taps;
  long long splits;
  if constexpr (tc) {
    splits = WGRAD_WGMMA_CTAS / tiles;
    splits = min(splits, (long long)p.rows / WGRAD_WGMMA_MIN_CHUNK);
  } else {
    splits = (WGRAD_TARGET_CTAS + tiles - 1) / tiles;
    splits = min(splits, (long long)(p.rows + WGRAD_MIN_CHUNK - 1) / WGRAD_MIN_CHUNK);
  }
  splits = ws ? min(splits, ws_floats / size) : 1;
  splits = max(splits, 1LL);
  p.row_chunk = (int)(((p.rows + splits - 1) / splits + bk - 1) / bk * bk);
  if (p.row_chunk == 0) p.row_chunk = bk;
  splits = (p.rows + p.row_chunk - 1) / p.row_chunk;
  splits = max(splits, 1LL);
  float* final_out = p.out;
  if (splits > 1) p.out = ws;
  if constexpr (tc) {
    dim3 grid((p.n + bn - 1) / bn, (p.ka + bm - 1) / bm, taps * (int)splits);
    const int vec_a = p.lda % 8 == 0 && aligned16(p.a);
    const int vec_g = p.ldg % 8 == 0 && aligned16(p.g);
    cudaFuncSetAttribute(wgrad_wgmma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, TG_SMEM);
    wgrad_wgmma_kernel<T><<<grid, TG_THREADS, TG_SMEM, stream>>>(p, taps, vec_a, vec_g);
  } else {
    dim3 grid((p.n + FW_BN - 1) / FW_BN, (p.ka + FW_BM - 1) / FW_BM, taps * (int)splits);
    const int vec_a = p.lda % 4 == 0 && aligned16(p.a);
    const int vec_g = p.ldg % 4 == 0 && aligned16(p.g);
    cudaFuncSetAttribute(wgrad_f32_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, FW_SMEM);
    wgrad_f32_kernel<T><<<grid, FG_THREADS, FW_SMEM, stream>>>(p, taps, vec_a, vec_g);
  }
  if (splits > 1)
    sum_splits_kernel<<<(int)((size + 255) / 256), 256, 0, stream>>>(ws, final_out, (int)splits, size);
}

}  // namespace stts
