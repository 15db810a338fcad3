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
// bf16 goes to `tap_gemm_wgmma_kernel` (tensor cores, f32 sums; persistent
// and warp-specialised, fed by TMA and an mbarrier ring). Both stage the
// finished tile in shared memory, so an epilogue can read neighbouring
// columns (RoPE). The weight-gradient GEMM likewise: f32 goes to the FMA
// `wgrad_f32_kernel`, bf16 to `wgrad_wgmma_kernel`.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>
#include <utility>

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
// and, for the bf16 kernel, may provide
//   void store8(int m, int n, const float* tile, int r, int c): store for the
//   8 columns n .. n + 7 (staged at c .. c + 7; n and c multiples of 8, n + 7
//   < N), each value by store's own arithmetic, so the bits are store's (the
//   kernel then gives each thread 8 columns)
//   void prep_row(int m, int n, const float (&acc)[16], float (&val)[16]):
//   the staged values of a thread's 16 sums in row m of a 64-column sub-tile,
//   columns n + 8 j + e in [2 j + e] (n - 2 (lane % 4) is the sub-tile's
//   first column, below N; values of columns at or past N are dropped, so
//   nothing may be read for them): prep's, or values of the epilogue's own
//   that its store then reads (the RoPE of QkvEpi, whose partners are in the
//   same thread)
template <typename E, typename = void>
struct HasStore8 : std::false_type {};
template <typename E>
struct HasStore8<E, decltype(std::declval<const E&>().store8(0, 0, static_cast<const float*>(nullptr), 0, 0))>
    : std::true_type {};
template <typename E, typename = void>
struct HasPrepRow : std::false_type {};
template <typename E>
struct HasPrepRow<E, decltype(std::declval<const E&>().prep_row(0, 0, std::declval<const float (&)[16]>(),
                                                                  std::declval<float (&)[16]>()))>
    : std::true_type {};

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
// Replaces, for bf16, the FMA kernel below under the same contract (TapGemm,
// Epi). What bounds it on the H100: its products, 2*M*N*K*taps FLOPs at 989
// TFLOP/s, against activations and weights read about once and the output
// written once. F5-TTS's block products (M = 33k rows, K = 1,024-2,048) and
// StableTTS's convs (K = 256 x 3 taps) sit at 550-1,100 FLOPs a byte, above
// the card's ~295; StableTTS's projections (K = 256, one tap) at 130-190
// below it. So the limit is how much of the time the tensor cores are fed: a
// kernel whose every thread copied, met a block barrier each k step and then
// stored its tile while nothing multiplied (two 128 x 128 CTAs an SM, a 3-deep
// cp.async ring) ran these products at 13-21% of the peak (PERF.md).
//
// Design: one persistent CTA an SM walks the output tiles in order, n
// fastest, so the CTAs in flight share A's row panels while W (6 MB at most
// in the port) stays in L2. Three warpgroups: warpgroup 0 produces and gives
// up its registers (setmaxnreg); warpgroups 1 and 2 consume, 64 rows each of
// a 128 x BN tile, by wgmma m64nBNk16 (BN = 256 where N > 128 and the grid
// is not left short of tiles, else 128: tap_gemm_bn). A ring of stages (4 at BN = 256, 6 at 128; 192 KB) is handed
// over by mbarriers: a stage's full barrier completes when its bytes have
// landed, its empty barrier when every consumer warp has arrived after its
// products on it are done (one product group stays in flight), so no block
// barrier runs in the main loop, and the producer runs a ring ahead across
// tiles: the next tile's first stages load while the consumers run this
// tile's epilogue. A stage holds A (128 rows x 64 k, K-major, two swizzled
// 64 x 64 tiles) and W (BN x 64: 64-column MN-major atoms for W[k, n],
// K-major rows for w_trans), all in the 128-byte swizzle. How they get there,
// the path (tap_gemm_path):
//   TMA            A is a plain [M, lda] matrix (one tap, no shift, stride or
//                  row_len, k_split >= k_in): one thread loads A and W by TMA
//                  (tensor maps made at each launch; reads out of bounds give
//                  zeros)
//   producer_copy  shifted, strided, ragged or split A: the producer
//                  warpgroup copies A's rows by 16-byte cp.async (zero-filled
//                  outside [0, min(t_in, row_len[b])) and past k_in), which
//                  arrive on the full barrier as they land; W by TMA
//   fallback       lda, ldw, w_tap_stride or k_split not a multiple of 8, or a
//                  pointer not 16-byte aligned (the ISTFT's k_split = 1025):
//                  the producer copies both operands element by element.
//                  Right, not fast.
// Each output's f32 sum runs through the wgmma k slices in a fixed order
// (taps outer, 64-deep k steps, 16-deep slices), whatever the path or BN. The
// epilogue stages each consumer's 64 x BN sums as 64 x 64 sub-tiles of row
// stride GEMM_BN + 1 in a buffer of its own, by prep (or prep_row: a row's 16
// sums of a thread at once), then calls store (or store8: 8 columns a thread,
// neighbouring threads on neighbouring 16-byte chunks), so a store reads
// neighbours within its 64 columns (RoPE). The epilogue does not overlap the
// tensor cores' work, and with an epilogue that reads and computes per
// element it is the larger part of a tile's time (PERF.md).
constexpr int TP_BM = 128, TP_BK = 64, TP_THREADS = 3 * WG_THREADS;
constexpr int TP_RING_BYTES = 4 * (TP_BM + 256) * TP_BK * 2;  // 192 KB
constexpr int TG_SUB = GEMM_BM * (GEMM_BN + 1);                // floats of one staged 64 x 64 sub-tile
// the ring, 1024-byte aligned, then each consumer's staged sub-tile, then the barriers
constexpr int TP_SMEM = 1024 + TP_RING_BYTES + 2 * TG_SUB * 4 + 128;
constexpr int TP_PRODUCER_REGS = 56, TP_CONSUMER_REGS = 224;  // 128 x 56 + 256 x 224 = 384 x 168
enum TapPath { TAP_TMA = 0, TAP_PRODUCER_COPY = 1, TAP_FALLBACK = 2 };

template <int BN>
struct TpStage {
  static constexpr int A_BYTES = TP_BM * TP_BK * 2, B_BYTES = BN * TP_BK * 2, BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGES = TP_RING_BYTES / BYTES;
};
static_assert(TpStage<256>::STAGES == 4 && TpStage<128>::STAGES == 6, "the ring holds 4 or 6 stages");
static_assert(2 * 8 * TpStage<128>::STAGES <= 128, "the barriers fit");

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
// i + shift < lim (lim = -1 past M). The f32 kernel's copies take one or two
// rows a thread; the bf16 producer's eight, (lt / 8) + 16 j, in two of these.
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

// A's 128 rows x 64 k of one k step into `sa` (two swizzled 64 x 64 tiles):
// chunk lt % 8 of rows lt / 8 + 16 j, j < 8, so eight threads copy a 128-byte
// row; by 16-byte cp.async (zero-filled where a row or a chunk reads
// nothing), or element by element
__device__ __forceinline__ void tp_copy_a(const TapGemm& g, const TapRows (&rows)[2], uint8_t* sa, int shift,
                                          int k0, int lt, bool vec) {
  const bf16* A0 = static_cast<const bf16*>(g.a0);
  const bf16* A1 = static_cast<const bf16*>(g.a1);
  const int ka = min(g.k_split, g.k_in);  // columns read from a0
  const int c = lt & 7, k = k0 + c * 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int r = (lt >> 3) + 16 * j;
    const long long row = k < g.k_in ? rows[j >> 2].row(j & 3, shift) : -1;
    uint8_t* tile = sa + (r >> 6) * WG_TILE_BYTES;
    if (vec) {
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
      cp_async16(smem_addr(tile) + (r & 63) * 128 + (((c ^ r) & 7) << 4), src, n * 2);
    } else {
      bf16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int kk = k + e;
        v[e] = __ushort_as_bfloat16(0);
        if (row >= 0 && kk < g.k_in) v[e] = kk < ka ? A0[row * g.lda + kk] : A1[row * g.lda + (kk - g.k_split)];
      }
      st_chunk(tile, r & 63, c, pack8(v));
    }
  }
}

// W's BN x 64 of one k step into `sb`, element by element (the fallback)
template <int BN>
__device__ __forceinline__ void tp_copy_w(const TapGemm& g, const bf16* W, uint8_t* sb, int n0, int k0, int lt) {
  const bf16 zero = __ushort_as_bfloat16(0);
  if (!g.w_trans) {
    // W[k, n]: 64 k rows x BN / 8 chunks; atom h holds columns 64 h .. 64 h + 63
    for (int e = lt; e < 64 * (BN / 8); e += WG_THREADS) {
      const int kr = e / (BN / 8), cb = e % (BN / 8), k = k0 + kr, n = n0 + 8 * cb;
      bf16 v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = (k < g.k_in && n + q < g.N) ? W[(long long)k * g.ldw + n + q] : zero;
      st_chunk(sb + (cb >> 3) * WG_TILE_BYTES, kr, cb & 7, pack8(v));
    }
  } else {
    // W[n, k]: BN n rows x 8 chunks of k
    for (int e = lt; e < BN * 8; e += WG_THREADS) {
      const int nr = e >> 3, c = e & 7, n = n0 + nr, k = k0 + 8 * c;
      bf16 v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = (n < g.N && k + q < g.k_in) ? W[(long long)n * g.ldw + k + q] : zero;
      st_chunk(sb + (nr >> 6) * WG_TILE_BYTES, nr & 63, c, pack8(v));
    }
  }
}

// fence_regs for the N accumulators of a wgmma product
template <int N>
__device__ __forceinline__ void tg_fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// One stage's TMA loads (A where tma_a, and W), completing on `full`
template <int BN>
__device__ __forceinline__ void tp_tma_loads(const CUtensorMap& tma_a, const CUtensorMap& tma_w, const TapGemm& g,
                                             bool load_a, uint8_t* sa, int m0, int n0, int k0, int tap,
                                             uint32_t full) {
  uint8_t* sb = sa + TpStage<BN>::A_BYTES;
  if (load_a) tma_load_2d(smem_addr(sa), &tma_a, k0, m0, full);
  if (g.w_trans) {
    tma_load_3d(smem_addr(sb), &tma_w, k0, n0, tap, full);
  } else {
#pragma unroll
    for (int h = 0; h < BN / 64; ++h) tma_load_3d(smem_addr(sb + h * WG_TILE_BYTES), &tma_w, n0 + 64 * h, k0, tap, full);
  }
}

// The producer warpgroup: fills each stage of the ring once its empty
// barrier has completed, tile after tile, in the consumers' order. On the
// TMA path one thread does it all and the other warps leave.
template <int BN>
__device__ __forceinline__ void tp_produce(const CUtensorMap& tma_a, const CUtensorMap& tma_w, const TapGemm& g,
                                           int path, uint8_t* ring, uint32_t full0, uint32_t empty0, int lt) {
  using S = TpStage<BN>;
  if (path == TAP_TMA && lt != 0) return;
  const int n_tiles = (g.N + BN - 1) / BN, tiles = ((g.M + TP_BM - 1) / TP_BM) * n_tiles;
  const int ktiles = (g.k_in + TP_BK - 1) / TP_BK, steps = g.taps * ktiles;
  const uint32_t tx = (path == TAP_TMA ? S::A_BYTES : 0) + S::B_BYTES;
  int stage = 0, phase = 0;
  TapRows rows[2];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / n_tiles) * TP_BM, n0 = (tile % n_tiles) * BN;
    if (path != TAP_TMA) {
#pragma unroll
      for (int j = 0; j < 8; ++j) rows[j >> 2].set(g, j & 3, m0 + (lt >> 3) + 16 * j);
    }
    for (int step = 0; step < steps; ++step) {
      const int tap = step / ktiles, k0 = (step - tap * ktiles) * TP_BK;
      uint8_t* sa = ring + stage * S::BYTES;
      uint8_t* sb = sa + S::A_BYTES;
      const uint32_t full = full0 + 8 * stage;
      mbar_wait(empty0 + 8 * stage, phase ^ 1);
      if (path == TAP_FALLBACK) {
        tp_copy_a(g, rows, sa, g.shift0 + tap * g.shift_step, k0, lt, false);
        tp_copy_w<BN>(g, static_cast<const bf16*>(g.w) + tap * g.w_tap_stride, sb, n0, k0, lt);
        fence_proxy_async();
        mbar_arrive(full);
        if (lt == 0) mbar_arrive(full);  // in place of the TMA arrival
      } else {
        if (lt == 0) {
          mbar_arrive_expect_tx(full, tx);
          tp_tma_loads<BN>(tma_a, tma_w, g, path == TAP_TMA, sa, m0, n0, k0, tap, full);
        }
        if (path == TAP_PRODUCER_COPY) {
          tp_copy_a(g, rows, sa, g.shift0 + tap * g.shift_step, k0, lt, true);
          mbar_arrive_cp_async(full);
        }
      }
      if (++stage == S::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// A consumer warpgroup (cw = 0, 1): rows 64 cw .. 64 cw + 63 of each tile;
// its products on each stage as it lands, then the epilogue through its own
// staged sub-tile
template <int BN, typename Epi>
__device__ __forceinline__ void tp_consume(const TapGemm& g, const Epi& epi, int path, uint8_t* ring, float* sub,
                                           uint32_t full0, uint32_t empty0, int cw, int lt) {
  using S = TpStage<BN>;
  const int n_tiles = (g.N + BN - 1) / BN, tiles = ((g.M + TP_BM - 1) / TP_BM) * n_tiles;
  const int ktiles = (g.k_in + TP_BK - 1) / TP_BK, steps = g.taps * ktiles;
  const int ld = GEMM_BN + 1, r0 = 16 * (lt / 32) + (lt % 32) / 4;
  const bool release = (lt & 31) == 0;  // one arrival a warp on the empty barriers
  int stage = 0, phase = 0;
  float acc[BN / 2];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / n_tiles) * TP_BM, n0 = (tile % n_tiles) * BN, mw = m0 + 64 * cw;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int prev = -1;  // the stage whose products are still in flight
    for (int step = 0; step < steps; ++step) {
      mbar_wait(full0 + 8 * stage, phase);
      if (path != TAP_TMA) fence_proxy_async();  // the producer's cp.async and element writes
      uint8_t* sa = ring + stage * S::BYTES;
      const uint64_t da = make_desc<false>(smem_addr(sa + cw * WG_TILE_BYTES));
      wgmma_fence();
      if (g.w_trans) {
        const uint64_t db = make_desc<false>(smem_addr(sa + S::A_BYTES));
#pragma unroll
        for (int kk = 0; kk < TP_BK / 16; ++kk) WgmmaSS<BN, 0, 0>::run(acc, desc_k<false>(da, kk), desc_k<false>(db, kk), 1);
      } else {
        const uint64_t db = make_desc_mn(smem_addr(sa + S::A_BYTES), WG_TILE_BYTES);
#pragma unroll
        for (int kk = 0; kk < TP_BK / 16; ++kk) WgmmaSS<BN, 0, 1>::run(acc, desc_k<false>(da, kk), desc_k<true>(db, kk), 1);
      }
      wgmma_commit();
      wgmma_wait<1>();
      tg_fence_acc(acc);
      if (prev >= 0 && release) mbar_arrive(empty0 + 8 * prev);
      prev = stage;
      if (++stage == S::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    tg_fence_acc(acc);
    if (prev >= 0 && release) mbar_arrive(empty0 + 8 * prev);

    // epilogue: 64 x 64 sub-tile q holds columns n0 + 64 q ..
#pragma unroll
    for (int q = 0; q < BN / 64; ++q) {
      named_barrier(1 + cw, WG_THREADS);  // the stores of the sub-tile before have read it
      if constexpr (HasPrepRow<Epi>::value) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h, m = mw + r, nb = n0 + 64 * q + 2 * (lt % 4);
          float a[16], v[16];
#pragma unroll
          for (int i = 0; i < 16; ++i) a[i] = acc[4 * (8 * q + (i >> 1)) + 2 * h + (i & 1)];
          if (m < g.M) epi.prep_row(m, nb, a, v);
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int c = 8 * (i >> 1) + 2 * (lt % 4) + (i & 1), n = nb + 8 * (i >> 1) + (i & 1);
            sub[r * ld + c] = (m < g.M && n < g.N) ? v[i] : 0.f;
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int r = r0 + 8 * h, c = 8 * j + 2 * (lt % 4) + e, m = mw + r, n = n0 + 64 * q + c;
              sub[r * ld + c] = (m < g.M && n < g.N) ? epi.prep(m, n, acc[4 * (8 * q + j) + 2 * h + e]) : 0.f;
            }
      }
      named_barrier(1 + cw, WG_THREADS);
      if constexpr (HasStore8<Epi>::value) {
        // 8 columns a thread: neighbouring threads store neighbouring chunks
#pragma unroll
        for (int e = lt; e < 64 * 8; e += WG_THREADS) {
          const int r = e >> 3, c = (e & 7) * 8, m = mw + r, n = n0 + 64 * q + c;
          if (m < g.M && n + 8 <= g.N) {
            epi.store8(m, n, sub, r, c);
          } else if (m < g.M) {
            for (int i = 0; n + i < g.N; ++i) epi.store(m, n + i, sub, r, c + i);
          }
        }
      } else {
        for (int e = lt; e < 64 * 64; e += WG_THREADS) {
          const int r = e >> 6, c = e & 63, m = mw + r, n = n0 + 64 * q + c;
          if (m < g.M && n < g.N) epi.store(m, n, sub, r, c);
        }
      }
    }
  }
}

template <int BN, typename Epi>
__global__ void __launch_bounds__(TP_THREADS, 1)
    tap_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a, const __grid_constant__ CUtensorMap tma_w,
                          TapGemm g, Epi epi, int path) {
  using S = TpStage<BN>;
  extern __shared__ uint8_t tp_smem[];
  uint8_t* ring = align_1024(tp_smem);
  float* staged = reinterpret_cast<float*>(ring + TP_RING_BYTES);
  const uint32_t full0 = smem_addr(staged + 2 * TG_SUB), empty0 = full0 + 8 * S::STAGES;
  const int wg = threadIdx.x / WG_THREADS, lt = threadIdx.x % WG_THREADS;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(full0 + 8 * s, path == TAP_TMA ? 1 : 1 + WG_THREADS);  // the TMA thread, and each copying thread
      mbar_init(empty0 + 8 * s, 2 * WG_THREADS / 32);                   // each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (wg == 0) {
    setmaxnreg_dec<TP_PRODUCER_REGS>();
    tp_produce<BN>(tma_a, tma_w, g, path, ring, full0, empty0, lt);
  } else {
    setmaxnreg_inc<TP_CONSUMER_REGS>();
    tp_consume<BN>(g, epi, path, ring, staged + (wg - 1) * TG_SUB, full0, empty0, wg - 1, lt);
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

// ---- the bf16 tap GEMM's launch --------------------------------------------
// The path (tap_gemm_wgmma_kernel's note) from the TapGemm alone.
inline int tap_gemm_path(const TapGemm& g) {
  const bool vec_a = g.lda % 8 == 0 && aligned16(g.a0) &&
                     (g.k_split >= g.k_in || (g.k_split % 8 == 0 && aligned16(g.a1)));
  const bool vec_b = g.ldw % 8 == 0 && g.w_tap_stride % 8 == 0 && aligned16(g.w);
  if (!vec_a || !vec_b) return TAP_FALLBACK;
  const bool plain_a = g.taps == 1 && g.shift0 == 0 && g.row_stride == 1 && g.t_out == g.t_in &&
                       g.row_len == nullptr && g.k_split >= g.k_in;
  return plain_a ? TAP_TMA : TAP_PRODUCER_COPY;
}

// The tile's width BN for an M x N output: 256 where N > 128 and the waves
// of NUM_SMS tiles of 128 x 256 take at most 2/3 as many as those of 128 x
// 128 (a 128 x 256 tile took 1.2-1.9 times as long as a 128 x 128 one at the
// port's products, PERF.md), else 128: F5-TTS's and StableTTS's block
// products at serving batches take 256, a request's M = 2048 at N = 1024 (64
// tiles against 128) and N <= 128 take 128.
inline int tap_gemm_bn(int M, int N) {
  if (N <= 128) return 128;
  const long long m_tiles = (M + TP_BM - 1) / TP_BM;
  const long long w256 = (m_tiles * ((N + 255) / 256) + NUM_SMS - 1) / NUM_SMS;
  const long long w128 = (m_tiles * ((N + 127) / 128) + NUM_SMS - 1) / NUM_SMS;
  return 3 * w256 <= 2 * w128 ? 256 : 128;
}

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (no link to libcuda)
typedef CUresult (*TensorMapEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                         const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                         CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                         CUtensorMapFloatOOBfill);

inline TensorMapEncodeTiled tensor_map_encoder() {
  static TensorMapEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<TensorMapEncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor of `rank` dims (innermost first; strides in elements of the
// dims above the first) read in boxes in the 128-byte swizzle, zeros out of bounds
inline bool encode_tensor_map(CUtensorMap* map, const void* base, int rank, const long long* dims,
                              const long long* strides, const int* box) {
  const TensorMapEncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return false;
  cuuint64_t d[3], s[2];
  cuuint32_t b[3], e[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    d[i] = (cuuint64_t)dims[i];
    b[i] = (cuuint32_t)box[i];
    if (i + 1 < rank) s[i] = (cuuint64_t)strides[i] * 2;
  }
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), d, s, b, e,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The path a launch takes at tile width bn, with the tensor maps it loads
// by: W as [taps][rows][columns] in boxes of one tap, 64 k and 64 n (W[k, n])
// or bn n (w_trans); A as [M][k_in] in boxes of 128 rows and 64 k. The
// fallback where encoding a map fails (it has not on the H100).
inline int tap_gemm_plan(const TapGemm& g, int bn, CUtensorMap* ta, CUtensorMap* tw) {
  memset(ta, 0, sizeof(*ta));
  memset(tw, 0, sizeof(*tw));
  const int path = tap_gemm_path(g);
  if (path == TAP_FALLBACK) return path;
  const long long rows = g.w_trans ? g.N : g.k_in, cols = g.w_trans ? g.k_in : g.N;
  const long long w_dims[3] = {cols, rows, g.taps};
  const long long w_strides[2] = {g.ldw, g.taps > 1 ? g.w_tap_stride : rows * g.ldw};
  const int w_box[3] = {64, g.w_trans ? bn : 64, 1};
  bool ok = encode_tensor_map(tw, g.w, 3, w_dims, w_strides, w_box);
  if (ok && path == TAP_TMA) {
    const long long a_dims[2] = {g.k_in, g.M}, a_strides[1] = {g.lda};
    const int a_box[2] = {TP_BK, TP_BM};
    ok = encode_tensor_map(ta, g.a0, 2, a_dims, a_strides, a_box);
  }
  return ok ? path : TAP_FALLBACK;
}

template <int BN, typename Epi>
void launch_tap_gemm_wgmma(const TapGemm& g, const Epi& epi, cudaStream_t stream) {
  CUtensorMap ta, tw;
  const int path = tap_gemm_plan(g, BN, &ta, &tw);
  const int tiles = ((g.M + TP_BM - 1) / TP_BM) * ((g.N + BN - 1) / BN);
  cudaFuncSetAttribute(tap_gemm_wgmma_kernel<BN, Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize, TP_SMEM);
  tap_gemm_wgmma_kernel<BN, Epi><<<min(tiles, NUM_SMS), TP_THREADS, TP_SMEM, stream>>>(ta, tw, g, epi, path);
}

// f32: the FMA kernel; bf16: the wgmma kernel at the width tap_gemm_bn
// names. Errors surface through the caller's cudaGetLastError.
template <typename T, typename Epi>
void launch_tap_gemm(const TapGemm& g, const Epi& epi, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (tap_gemm_bn(g.M, g.N) == 256)
      launch_tap_gemm_wgmma<256>(g, epi, stream);
    else
      launch_tap_gemm_wgmma<128>(g, epi, stream);
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

// 8 consecutive values as f32 (16 bytes of bf16 or 32 of f32, aligned; read
// through the read-only path, so only data no thread of the kernel writes),
// and back
__device__ __forceinline__ void ld8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p)), b = __ldg(reinterpret_cast<const float4*>(p + 4));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w; v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void ld8(const bf16* p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}
__device__ __forceinline__ void st8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void st8(bf16* p, const float (&v)[8]) {
  bf16 b[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) b[i] = from_f<bf16>(v[i]);
  *reinterpret_cast<uint4*>(p) = pack8(b);
}
// whether 8 values at p[i .. i + 7] of rows `ld` long may move as one chunk
__device__ __forceinline__ bool chunk8(const void* p, long long ld) {
  return (ld & 7) == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}


// ---- QKV projection epilogue: bias, q scale, rounding, RoPE ----------------
// The product is [M, 3C] (q | k | v); q and k rotate their first 2*half
// features of each head as x*cos + neg_half(x)*sin, neg_half(x) =
// [-x[half:2half], x[:half]], on the values already rounded to T. half is
// D/4 for StableTTS's partial RoPE and D/2 for a rotation of the whole head
// (F5-TTS, whose interleaved pairs are this form after a fixed permutation
// of each head's q and k columns); 2*half <= D <= 64, so a partner column
// lies in the same 64-column sub-tile, and D is a multiple of 8.
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
  __device__ __forceinline__ float prep_b(int n, float acc, float b) const {
    float val = acc + b;
    if (n < C) val *= q_scale;
    return round_to<T>(val);
  }
  __device__ float prep(int m, int n, float acc) const { return prep_b(n, acc, to_f(bias[n])); }
  __device__ __forceinline__ float rope(float x, float partner, float cs, float sn) const {
    return x * cs + partner * sn;
  }
  // In bf16 (the wgmma kernel, which calls prep_row) with D = 64 and half a
  // multiple of 8, a feature and its partner lie in one thread's sums of a
  // 64-column sub-tile: prep_row rotates them and store only rounds. Else
  // store rotates the staged values.
  __device__ __forceinline__ bool rotated_in_prep() const {
    return std::is_same<T, bf16>::value && D == 64 && half % 8 == 0;
  }
  // val[i] is feature jj0 + 8 (i / 2) + i % 2 of a head (jj0 even, below 8),
  // half = 8 H8: whether it rotates and with which partner is known from i
  // alone, and val[i] and its partner val[i + 2 H8] share a cos and a sin
  template <int H8>
  __device__ __forceinline__ void rotate(int m, int jj0, float (&val)[16]) const {
    const float* cr = cos_t + (m % T_) * half + jj0;
    const float* sr = sin_t + (m % T_) * half + jj0;
    float out[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) out[i] = val[i];
#pragma unroll
    for (int j = 0; j < H8; ++j) {
      const float2 cs = __ldg(reinterpret_cast<const float2*>(cr + 8 * j));
      const float2 sn = __ldg(reinterpret_cast<const float2*>(sr + 8 * j));
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 2 * j + e, p = i + 2 * H8;
        const float c = e ? cs.y : cs.x, s = e ? sn.y : sn.x;
        out[i] = rope(val[i], -val[p], c, s);
        out[p] = rope(val[p], val[i], c, s);
      }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) val[i] = out[i];
  }
  __device__ void prep_row(int m, int n, const float (&acc)[16], float (&val)[16]) const {
    if (n >= 3 * C) return;  // a sub-tile past the product: nothing is staged from it
    if (std::is_same<T, bf16>::value && (reinterpret_cast<uintptr_t>(bias + n) & 3) == 0) {
      // the bias of columns n + 8 j and n + 8 j + 1 in one load
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t b2 = __ldg(reinterpret_cast<const unsigned int*>(bias + n + 8 * j));
        val[2 * j] = prep_b(n + 8 * j, acc[2 * j], __uint_as_float(b2 << 16));
        val[2 * j + 1] = prep_b(n + 8 * j + 1, acc[2 * j + 1], __uint_as_float(b2 & 0xFFFF0000u));
      }
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) val[i] = prep(m, n + 8 * (i >> 1) + (i & 1), acc[i]);
    }
    if (!rotated_in_prep() || n / C == 2) return;
    const int jj0 = n % C % D;  // the feature of val[0] in its head: 2 (lane % 4)
    switch (half) {
      case 8: rotate<1>(m, jj0, val); break;
      case 16: rotate<2>(m, jj0, val); break;
      case 24: rotate<3>(m, jj0, val); break;
      case 32: rotate<4>(m, jj0, val); break;
    }
  }
  __device__ __forceinline__ float partner(const float* tile, int r, int c, int jj) const {
    const int ld = GEMM_BN + 1;
    return jj < half ? -tile[r * ld + c + half] : tile[r * ld + c - half];
  }
  // staged (r, c) of q | k | v `which`, feature jj of its head, at time t
  __device__ __forceinline__ float value(const float* tile, int r, int c, int which, int jj, int t) const {
    float x = tile[r * (GEMM_BN + 1) + c];
    if (which < 2 && jj < 2 * half && !rotated_in_prep()) {
      int i = jj % half;
      x = rope(x, partner(tile, r, c, jj), cos_t[t * half + i], sin_t[t * half + i]);
    }
    return x;
  }
  __device__ void store(int m, int n, const float* tile, int r, int c) const {
    int which = n / C, nn = n % C;
    T* dst = which == 0 ? q : (which == 1 ? k : v);
    dst[(long long)m * C + nn] = from_f<T>(value(tile, r, c, which, nn % D, m % T_));
  }
  __device__ void store8(int m, int n, const float* tile, int r, int c) const {
    const int which = n / C, nn = n % C;
    T* dst = (which == 0 ? q : (which == 1 ? k : v)) + (long long)m * C + nn;
    float x[8];
    if (rotated_in_prep()) {
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = tile[r * (GEMM_BN + 1) + c + i];
    } else {
      const int jj = nn % D, t = m % T_;
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = value(tile, r, c + i, which, jj + i, t);
    }
    if (chunk8(dst, C)) {
      st8(dst, x);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[i] = from_f<T>(x[i]);
    }
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
  __device__ __forceinline__ float value(float xv, float o, float gate, float mk) const { return xv + o * gate * mk; }
  __device__ void store(int m, int n, const float* tile, int r, int c) const {
    int b = m / T_;
    float gate = to_f(mods[((long long)b * n_mods + gate_idx) * C + n]);
    float o = tile[r * (GEMM_BN + 1) + c];
    out[(long long)m * C + n] = from_f<Tout>(value(to_f(x[(long long)m * C + n]), o, gate, mask[m]));
  }
  __device__ void store8(int m, int n, const float* tile, int r, int c) const {
    const T* xr = x + (long long)m * C + n;
    const T* gr = mods + ((long long)(m / T_) * n_mods + gate_idx) * C + n;
    Tout* dst = out + (long long)m * C + n;
    if (!(chunk8(xr, C) && chunk8(gr, C) && chunk8(dst, C))) {
#pragma unroll
      for (int i = 0; i < 8; ++i) store(m, n + i, tile, r, c + i);
      return;
    }
    float xv[8], gate[8], o[8];
    ld8(xr, xv);
    ld8(gr, gate);
    const float mk = mask[m];
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = value(xv[i], tile[r * (GEMM_BN + 1) + c + i], gate[i], mk);
    st8(dst, o);
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
  __device__ __forceinline__ float value(float v, float mk) const {
    float s = v / (1.f + expf(-v));
    return s * mk;
  }
  __device__ void store(int m, int n, const float* tile, int r, int c) const {
    y[(long long)m * N + n] = from_f<T>(value(tile[r * (GEMM_BN + 1) + c], mask[m]));
  }
  __device__ void store8(int m, int n, const float* tile, int r, int c) const {
    T* dst = y + (long long)m * N + n;
    const float mk = mask[m];
    float o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = value(tile[r * (GEMM_BN + 1) + c + i], mk);
    if (chunk8(dst, N)) {
      st8(dst, o);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[i] = from_f<T>(o[i]);
    }
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
  __device__ __forceinline__ float value(float v, float mk) const {
    float g = 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
    return g * mk;
  }
  __device__ void store(int m, int n, const float* tile, int r, int c) const {
    y[(long long)m * N + n] = from_f<T>(value(tile[r * (GEMM_BN + 1) + c], mask[m]));
  }
  __device__ void store8(int m, int n, const float* tile, int r, int c) const {
    T* dst = y + (long long)m * N + n;
    const float mk = mask[m];
    float o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = value(tile[r * (GEMM_BN + 1) + c + i], mk);
    if (chunk8(dst, N)) {
      st8(dst, o);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[i] = from_f<T>(o[i]);
    }
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
  __device__ __forceinline__ float value(float rv, float gate, float v, float mk) const {
    float z = v * mk;
    return rv + gate * z;
  }
  __device__ void store(int m, int n, const float* tile, int r, int c) const {
    int b = m / T_;
    float gate = to_f(mods[((long long)b * n_mods + gate_idx) * C + n]);
    out[(long long)m * C + n] =
        from_f<T>(value(to_f(res[(long long)m * C + n]), gate, tile[r * (GEMM_BN + 1) + c], mask[m]));
  }
  __device__ void store8(int m, int n, const float* tile, int r, int c) const {
    const Tres* rr = res + (long long)m * C + n;
    const T* gr = mods + ((long long)(m / T_) * n_mods + gate_idx) * C + n;
    T* dst = out + (long long)m * C + n;
    if (!(chunk8(rr, C) && chunk8(gr, C) && chunk8(dst, C))) {
#pragma unroll
      for (int i = 0; i < 8; ++i) store(m, n + i, tile, r, c + i);
      return;
    }
    float rv[8], gate[8], o[8];
    ld8(rr, rv);
    ld8(gr, gate);
    const float mk = mask[m];
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = value(rv[i], gate[i], tile[r * (GEMM_BN + 1) + c + i], mk);
    st8(dst, o);
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
// Design: a wgmma tap GEMM turned on its side, the reduction running
// over rows. A 128 (m, over ka) x 128 (n) output tile, a 64-row k step, two
// consumer warpgroups of 64 m each issuing m64n128k16 with both operands
// MN-major: A's m and G's n are the contiguous axes of a row, so a k step's
// 64 rows are copied as they lie (A as two 64 x 64 tiles under make_desc<true>,
// G as two 64-wide atoms under make_desc_mn) and the transpose bits do the
// rest. A 3-deep cp.async ring (97 KB, two CTAs an SM). The tap's shift
// lands on the k axis: row r = b * t_len + t copies activation row r + shift
// where t + shift lies in [0, t_len), else the 16-byte chunk is zero-filled;
// so are chunks past ka, n and the chunk's last row. One tap per CTA (grid z
// = tap x chunk), so the three taps of a conv read each G slab three times
// (from L2). Where lda or ldg is not a multiple of 8 or a pointer is not
// 16-byte aligned the copies are element by element: right, not fast. Each
// CTA writes its 128 x 128 f32 partial straight from the accumulators.
constexpr int WGR_BM = 128, WGR_BN = 128, WGR_BK = 64, WGR_STAGES = 3, WGR_THREADS = 256;
constexpr int WGR_INFLIGHT = 1;  // product groups a warpgroup keeps in flight across a k step
constexpr int WGR_CTAS_PER_SM = 2;
constexpr int WGR_STAGE_BYTES = 4 * WG_TILE_BYTES;             // A: 2 tiles of 64 columns; G: 2 tiles of 64 columns
constexpr int WGR_SMEM = WGR_STAGES * WGR_STAGE_BYTES + 1024;  // + alignment slack

// Stage `stage` of the ring <- rows r0 .. r0 + 63 of the chunk (below r_end)
__device__ __forceinline__ void wgrad_load(const WGrad& p, uint8_t* ring, int stage, int r0, int r_end, int shift,
                                           int m0, int n0, bool vec_a, bool vec_g) {
  const bf16* A = static_cast<const bf16*>(p.a);
  const bf16* G = static_cast<const bf16*>(p.g);
  const int tid = threadIdx.x;
  uint8_t* sa = ring + stage * WGR_STAGE_BYTES;
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
__global__ void __launch_bounds__(WGR_THREADS, WGR_CTAS_PER_SM)
    wgrad_wgmma_kernel(WGrad p, int taps, int vec_a, int vec_g) {
  static_assert(std::is_same<T, bf16>::value, "the wgmma weight gradient takes bf16");
  extern __shared__ uint8_t wgr_smem[];
  uint8_t* ring = align_1024(wgr_smem);
  const int tid = threadIdx.x, wg = tid / WG_THREADS, lt = tid % WG_THREADS;
  const int n0 = blockIdx.x * WGR_BN, m0 = blockIdx.y * WGR_BM;
  const int tap = blockIdx.z % taps, chunk = blockIdx.z / taps;
  const int shift = p.shift0 + tap * p.shift_step;
  const int r_begin = chunk * p.row_chunk, r_end = min(p.rows, r_begin + p.row_chunk);
  const int steps = max(0, (r_end - r_begin + WGR_BK - 1) / WGR_BK);
  constexpr int AHEAD = WGR_STAGES - 1 - WGR_INFLIGHT;  // k steps loaded ahead of the one multiplied

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < steps) wgrad_load(p, ring, s, r_begin + s * WGR_BK, r_end, shift, m0, n0, vec_a, vec_g);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    // this step's copies have landed for every thread, and both warpgroups'
    // products on the stage refilled below are done
    cp_async_wait<AHEAD - 1>();
    fence_proxy_async();
    __syncthreads();
    const int next = step + AHEAD;
    if (next < steps)
      wgrad_load(p, ring, next % WGR_STAGES, r_begin + next * WGR_BK, r_end, shift, m0, n0, vec_a, vec_g);
    cp_async_commit();

    uint8_t* sa = ring + (step % WGR_STAGES) * WGR_STAGE_BYTES;
    const uint64_t da = make_desc<true>(smem_addr(sa + wg * WG_TILE_BYTES));
    const uint64_t dg = make_desc_mn(smem_addr(sa + 2 * WG_TILE_BYTES), WG_TILE_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WGR_BK / 16; ++kk) WgmmaSS<128, 1, 1>::run(acc, desc_k<true>(da, kk), desc_k<true>(dg, kk), 1);
    wgmma_commit();
    wgmma_wait<WGR_INFLIGHT>();
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
constexpr int WGRAD_WGMMA_CTAS = WGR_CTAS_PER_SM * NUM_SMS;
constexpr int WGRAD_WGMMA_MIN_CHUNK = 256;

// Splits the row reduction as above, as far as `ws` (ws_floats floats; may be
// nullptr) holds the partials. The split depends only on the shapes, the type
// and ws_floats. f32: the FMA kernel; bf16: the wgmma kernel.
template <typename T>
void launch_wgrad(WGrad p, int taps, float* ws, long long ws_floats, cudaStream_t stream) {
  constexpr bool tc = std::is_same<T, bf16>::value;
  constexpr int bm = tc ? WGR_BM : GEMM_BM, bn = tc ? WGR_BN : GEMM_BN, bk = tc ? WGR_BK : GEMM_BK;
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
    cudaFuncSetAttribute(wgrad_wgmma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, WGR_SMEM);
    wgrad_wgmma_kernel<T><<<grid, WGR_THREADS, WGR_SMEM, stream>>>(p, taps, vec_a, vec_g);
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
