// Packed-head attention for training, head width 64: the forward with
// dropout on the normalised weights and a log-sum-exp residual, and the
// FlashAttention-2 backward (dK/dV per key tile, dQ per query tile, no
// atomics). Shared by the DiT block's attention half (dit_attention_train.cu,
// which feeds it RoPE-rotated q and k) and by plain packed attention
// (attention_train.cu, raw q and k).
//
// q, k, v, att, datt are [B, T, C] with head h in columns h*64..h*64+63. The
// f32 scores are scaled by sm_scale after the product and get the key bias 0
// (valid key) or kNeg (padded key, finite: a row whose keys are all padded
// still has a finite softmax); keys past T are excluded. Padded query rows
// are garbage the caller masks. Natural-exp softmax in f32; the dropped
// weights are rounded to T before the PV product, ds and the outputs after
// theirs. Dropout: weight (b, h, q, key) keeps when Philox word key%4 of
// counter (key/4, q, (b + row0)*H + h, 0) under the call's key is >= thresh
// (row0: the batch's first row in a data-parallel step's global batch), so
// the backward regenerates the forward's mask.
//
// Two sets of kernels compute this. f32 runs the fp32-FMA *_f32 kernels (the
// f32 bars hold no TF32 form; their forward is one online pass, see below).
// bf16 runs the *_wgmma kernels below them: every operand of the ten tile
// products is a bf16 value at the rounding points above, so wgmma (tensor
// cores, f32 accumulate) changes only the order of the f32 sums.
//
// The backward's D = rowsum(datt * att) stands for the TPU kernel's f32
// sum(dp * p). It is subtracted from every dp of its row, so an error in it is
// the same for all keys of the row and does not average out in sums over keys
// or rows (a projection's bias or weight gradient): taken from the bf16 att it
// made those gradients up to 16 times noisier than the plain version's. In
// bf16 the forward therefore also writes att_lo = att_f32 - att, rounded to
// bf16, and D is rowsum(datt * (att + att_lo)); in f32 att_lo is null.
#pragma once

#include "common.cuh"
#include "fma_tiles.cuh"
#include "wgmma.cuh"

#include <math.h>
#include <type_traits>

namespace stts {
namespace atr {

constexpr float kNeg = -0.7f * 3.402823466e38f;  // key bias of padded keys
constexpr int TQ = 64;

// ================================================================ f32: FMA ==
//
// Replaces, in f32, the TPU kernels stabletts_tpu/ops/attention_pallas_train.py:167
// (forward) and :191 (backward), and ops/dit_attention_pallas_train.py:273 and :302
// (their attention core). True f32 on the FP32 pipes: the f32 bars hold no TF32
// form. What bounds it on the H100: the products on the FMA units and the
// scheduler's one instruction a clock, so every load, exp, Philox step or
// barrier takes an FFMA's slot. At (B=32, T=1000, 4 heads of 64) the forward is
// 32.8 GFLOP (two products), 0.489 ms at 67 TFLOP/s; the backward 2.5x that
// (five products), 1.223 ms; Philox's 32 M calls a pass are not counted.
//
// Design. Three kernels of 128 threads (four warps) and five products, the
// bound's count:
//   forward  one CTA per (128 queries, head, item), two an SM (96 KB of
//            shared memory); S = Q K^T and o += P V, 8 x 8 outputs a thread
//            (8 queries x 8 keys, then x 8 features)
//   dK, dV   one CTA per (128 keys, head, item), two an SM (112.3 KB), over
//            32-query steps; dP^T = V dO^T and S^T = K Q^T at 8 x 4 a thread
//            (dP^T parked in dS^T's buffer, so one score tile is live), dV +=
//            P^T dO and dK += dS^T Q at 8 x 8 (four 8 x 8 tiles would need 256
//            registers); it also writes dS^T to a workspace [B*H][T'][T']
//            (T' = T rounded up to 128; 537 MB at B=32, T=1000, 4 heads)
//   dQ       one CTA per (128 queries, head, item), four an SM; dQ = dS K
//            over that workspace, 8 x 8 a thread: a plain product, so the
//            backward makes the scores, their exps and the Philox bits once,
//            not twice as with a dQ kernel that recomputes them
// Every operand is a [rows][64] tile of a head copied as it lies (rows are
// positions, the 64 features run along a row) by 16-byte cp.async, rows past
// T zero-filled; no tile is held in a second orientation. A product either
// contracts over the features of two such tiles (S, dP: fa_mma_nt) or over the
// rows of the second (o, dK, dV: fa_mma_nn), and either way reads both with
// float4 loads along their rows: no transposes. A thread's rows are 8
// consecutive rows of the first operand, read by all the lanes of a
// quarter-warp at once (one address, a broadcast); its columns are 4 (or 2 x
// 4) rows or features of the second, read at eight distinct 16-byte chunks by
// the eight lanes of a quarter-warp. Tiles read as a second operand are
// therefore swizzled: the 16-byte chunk c of row r lies at chunk
// c ^ ((r >> 2) & 7), so those eight chunks fall in eight distinct bank groups
// (fa_at). Stores into shared memory are by quarter-warps of eight lanes each
// writing one 16-byte chunk of the same row, eight consecutive (or, swizzled,
// XOR-permuted within an aligned group of eight) chunks: free of bank
// conflicts by construction. The copies are single-buffered and staggered one
// product ahead: each tile is refilled as soon as its last product is done and
// lands while the next products run (K_{j+1} behind the forward's softmax and
// PV, V_{j+1} behind its QK^T; dO_{j+1} behind dK's product and Q_{j+1} behind
// dP^T in dK/dV); dQ streams 16-key steps through a 4-deep ring.
// A 16-byte shared-memory load costs four wavefronts whether its quarter-warps
// read eight distinct chunks or all the same eight (measured on an H100), so a
// thread holding a x b outputs pays about (a + b) wavefronts per 4 a b FMAs:
// 8 x 8 keeps pace with the FMA pipes, 8 x 4 asks shared memory for 1.5x the
// time its FMAs take. On the H100 dK/dV with all four tiles at 8 x 4 (64 keys
// a CTA) ran 8% slower than this one, and a layout whose warps share 16 key
// rows (16 x 2 a thread, one address per first-operand load) slower still:
// it issues more loads.
// What the design does about the 4 x 4 FMA kernels it replaces: those paid
// twice 8 x 8's shared-memory loads per FMA, loaded every tile synchronously
// one float at a time with 4-way conflicting transposed stores, kept Q and dO
// in both orientations in dK/dV (140 KB: one CTA an SM), computed the scores
// four times (twice in the forward, once in each backward kernel), and hit
// 8-way conflicts in their transposed stores of P and dS.
//
// One-pass forward. In f32 no weight is rounded, so the forward is one online
// pass: a running row max m, o rescaled by exp(m_old - m_new) at each key tile,
// the row sum l of the undropped weights, and at the end o / l and
// lse = m + log l. The weights are exp(s - m) * f / l, not exp(s - lse) * f:
// only the order of the f32 operations differs (the bf16 kernels below keep
// two passes because they round the normalised weights to bf16). The backward
// reads lse as before.
//
// Dropout: weight (b, h, q, key) keeps when Philox word key % 4 of counter
// (key / 4, q, (b + row0)*H + h, 0) is >= thresh. A thread's keys are aligned groups of
// four, so one Philox call serves four weights in every kernel.

constexpr int FA_FWD_BQ = 128;    // the forward's query rows a CTA
constexpr int FA_TILE = TK * HD;  // floats of one [64][64] tile
constexpr int FA_FWD_SMEM = 6 * FA_TILE * (int)sizeof(float);             // Q, P (128 rows each), K, V
constexpr int FA_DKV_BK = 128, FA_DKV_BQ = 32;  // dK/dV: keys a CTA, queries a step
// K, V [128][64]; Q, dO [32][64]; P^T, dS^T [128][32]; lse, D [32] each: 112.3 KB, two CTAs an SM
constexpr int FA_DKV_SMEM = (2 * FA_DKV_BK * HD + 2 * FA_DKV_BQ * HD + 2 * FA_DKV_BK * FA_DKV_BQ + 2 * FA_DKV_BQ) *
                            (int)sizeof(float);

// Rows t0 .. t0 + R - 1 of one head (row stride ld) into an [R][64] tile laid
// out as fa_at<SWZ>: 16-byte cp.async (zero-filled at or past Tn), or element
// by element where !vec. Chunk e = tid + 128 l is chunk e % 16 of row e / 16:
// a quarter-warp stores chunks 8a .. 8a + 7 of one row, which the swizzle only
// permutes, so its stores hit distinct banks.
template <int R, bool SWZ>
__device__ __forceinline__ void fa_copy(float* tile, const float* src, long long ld, int t0, int Tn, bool vec) {
#pragma unroll
  for (int l = 0; l < R * 16 / FA_THREADS; ++l) {
    const int e = threadIdx.x + FA_THREADS * l, r = e >> 4, c = e & 15;
    float* dst = tile + fa_at<SWZ>(r, c);
    const bool in = t0 + r < Tn;
    const float* p = in ? src + (long long)(t0 + r) * ld + 4 * c : src;
    if (vec) {
      cp_async16(smem_addr(dst), p, in ? 16 : 0);
    } else {
#pragma unroll
      for (int x = 0; x < 4; ++x) dst[x] = in ? p[x] : 0.f;
    }
  }
}

__device__ __forceinline__ float key_bias(const float* mask_b, int t, int Tn) {
  return t < Tn ? (mask_b[t] > 0.f ? 0.f : kNeg) : -INFINITY;
}

// ---- forward: one CTA per (128-query tile, head, item) --------------------
// thread (tr, tx) = (tid / 8, tid % 8): queries 8 tr .. 8 tr + 7; keys (and,
// for o, features) 4 tx .. 4 tx + 3 and 32 + 4 tx .. 32 + 4 tx + 3
__global__ void __launch_bounds__(FA_THREADS, 2) attn_fwd_kernel_f32(const float* q, const float* k, const float* v,
                                                                    const float* mask, float* att, float* lse,
                                                                    int Tn, int C, int H, float sm_scale,
                                                                    Dropout drop, int vec) {
  extern __shared__ __align__(16) float fa_sm[];
  float* Qs = fa_sm;               // [128][64] as it lies
  float* Ps = Qs + 2 * FA_TILE;    // [128 queries][64 keys] the dropped weights, as written
  float* Ks = Ps + 2 * FA_TILE;    // [64][64] swizzled
  float* Vs = Ks + FA_TILE;        // [64][64] swizzled
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * FA_FWD_BQ;
  const int tid = threadIdx.x, tx = tid & 7, tr = tid >> 3;
  const long long base = (long long)b * Tn * C + h * HD;
  const float* mask_b = mask + (long long)b * Tn;
  const uint32_t bh = b * H + h;
  const bool dropping = drop.seed != nullptr;
  const uint32_t key0 = dropping ? (uint32_t)drop.seed[0] : 0u, key1 = dropping ? (uint32_t)drop.seed[1] : 0u;
  const uint32_t cbh = drop.row_head(b, H, h);  // the counter's (global row, head) word
  const int nt = (Tn + TK - 1) / TK;

  fa_copy<FA_FWD_BQ, false>(Qs, q + base, C, q0, Tn, vec);
  fa_copy<TK, true>(Ks, k + base, C, 0, Tn, vec);
  cp_async_commit();
  fa_copy<TK, true>(Vs, v + base, C, 0, Tn, vec);
  cp_async_commit();

  float o[8][8], m[8], l[8];
  fa_zero(o);
#pragma unroll
  for (int i = 0; i < 8; ++i) m[i] = -INFINITY, l[i] = 0.f;
  for (int j = 0; j < nt; ++j) {
    const int k0 = j * TK;
    cp_async_wait<1>();  // Q and K_j have landed (V_j may be in flight)
    __syncthreads();
    float s[8][8];
    fa_zero(s);
    fa_mma_nt(s, Qs, 8 * tr, Ks, 4 * tx);
    __syncthreads();  // every thread is done with K_j
    if (j + 1 < nt) fa_copy<TK, true>(Ks, k + base, C, k0 + TK, Tn, vec);
    cp_async_commit();

    float kb[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) kb[c] = key_bias(mask_b, k0 + 4 * tx + (c & 3) + 32 * (c >> 2), Tn);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        s[i][c] = s[i][c] * sm_scale + kb[c];
        mx = fmaxf(mx, s[i][c]);
      }
      // the row's eight threads are the eight lanes tr * 8 .. tr * 8 + 7
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx), alpha = expf(m[i] - m_new);  // 0 on the first tile
      m[i] = m_new;
      uint4 w0 = make_uint4(0u, 0u, 0u, 0u), w1 = w0;
      if (dropping) {
        const uint32_t row = q0 + 8 * tr + i;
        w0 = philox4x32_10(make_uint4((k0 >> 2) + tx, row, cbh, 0u), key0, key1);
        w1 = philox4x32_10(make_uint4((k0 >> 2) + 8 + tx, row, cbh, 0u), key0, key1);
      }
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float p = expf(s[i][c] - m_new);
        rs += p;
        s[i][c] = dropping ? (word_of(c < 4 ? w0 : w1, c & 3) >= drop.thresh ? p * drop.scale : 0.f) : p;
      }
      l[i] = l[i] * alpha + rs;  // this thread's part of the row sum
#pragma unroll
      for (int c = 0; c < 8; ++c) o[i][c] *= alpha;
      float* pr = Ps + (8 * tr + i) * HD + 4 * tx;
      st4(pr, s[i][0], s[i][1], s[i][2], s[i][3]);
      st4(pr + 32, s[i][4], s[i][5], s[i][6], s[i][7]);
    }
    cp_async_wait<1>();  // V_j has landed (K_{j+1} may be in flight)
    __syncthreads();
    fa_mma_nn(o, Ps, 8 * tr, Vs, tx);
    __syncthreads();  // every thread is done with V_j and P
    if (j + 1 < nt) fa_copy<TK, true>(Vs, v + base, C, k0 + TK, Tn, vec);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float lt = l[i] + __shfl_xor_sync(0xffffffffu, l[i], 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    lt += __shfl_xor_sync(0xffffffffu, lt, 4);
    const int t = q0 + 8 * tr + i;
    if (t >= Tn) continue;
    if (tx == 0) lse[(long long)bh * Tn + t] = m[i] + logf(lt);
    float* dst = att + base + (long long)t * C + 4 * tx;
    fa_store4(dst, o[i][0] / lt, o[i][1] / lt, o[i][2] / lt, o[i][3] / lt, vec);
    fa_store4(dst + 32, o[i][4] / lt, o[i][5] / lt, o[i][6] / lt, o[i][7] / lt, vec);
  }
}

// ---- D = rowsum(datt * (att + att_lo)) per (item, head, row); one warp each
template <typename T>
__global__ void rowdot_kernel(const T* datt, const T* att, const T* att_lo, float* Dv, int Tn, int C, int H,
                              int n_rows) {
  int w = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;  // (b * H + h) * Tn + t
  int lane = threadIdx.x % 32;
  if (w >= n_rows) return;
  int t = w % Tn, bh = w / Tn, h = bh % H, b = bh / H;
  long long off = ((long long)b * Tn + t) * C + h * HD;
  float s = 0.f;
  for (int d = lane; d < HD; d += 32) {
    float a = to_f(att[off + d]);
    if (att_lo) a += to_f(att_lo[off + d]);
    s += to_f(datt[off + d]) * a;
  }
  s = warp_sum(s);
  if (lane == 0) Dv[w] = s;
}

// ---- backward dK, dV: one CTA per (128-key tile, head, item) --------------
// thread (tr, tx) = (tid / 8, tid % 8): keys 8 tr .. 8 tr + 7; queries 4 tx ..
// 4 tx + 3 of a 32-query step (for the scores), features 4 tx .. + 3 and
// 32 + 4 tx .. + 3 (for dK, dV: 8 x 8 each). dP^T goes through dS^T's buffer
// so that only one 8 x 4 score tile is live beside dK and dV.
__global__ void __launch_bounds__(FA_THREADS, 2) attn_bwd_dkv_kernel_f32(const float* q, const float* k,
                                                                        const float* v, const float* datt,
                                                                        const float* lse, const float* Dv,
                                                                        const float* mask, float* dk, float* dv,
                                                                        float* ds_t, int ld_ws, int ld_dv, int Tn,
                                                                        int C, int H, float sm_scale, Dropout drop,
                                                                        int vec) {
  constexpr int BK = FA_DKV_BK, BQ = FA_DKV_BQ;
  extern __shared__ __align__(16) float fa_sm[];
  float* Ks = fa_sm;           // [128 keys][64] as it lies
  float* Vs = Ks + BK * HD;    // [128 keys][64] as it lies
  float* Qs = Vs + BK * HD;    // [32 queries][64] swizzled
  float* Os = Qs + BQ * HD;    // dO [32 queries][64] swizzled
  float* Ps = Os + BQ * HD;    // [128 keys][32 queries] dropped weights P^T, as written
  float* Ss = Ps + BK * BQ;    // [128 keys][32 queries] dP^T, then dS^T, as written
  float* Rs = Ss + BK * BQ;    // the query step's lse at [0, 32), D at [32, 64)
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BK;
  const int tid = threadIdx.x, tx = tid & 7, tr = tid >> 3;
  const long long base = (long long)b * Tn * C + h * HD;
  const uint32_t bh = b * H + h;
  const bool dropping = drop.seed != nullptr;
  const uint32_t key0 = dropping ? (uint32_t)drop.seed[0] : 0u, key1 = dropping ? (uint32_t)drop.seed[1] : 0u;
  const uint32_t cbh = drop.row_head(b, H, h);  // the counter's (global row, head) word
  const float* row_src = (tid < BQ ? lse : Dv) + (long long)bh * Tn;
  const int nt = (Tn + BQ - 1) / BQ;

  // dO of query step j and its rows' lse (threads 0-31) and D (32-63), zero past T
  auto issue_o = [&](int j) {
    fa_copy<BQ, true>(Os, datt + base, C, j * BQ, Tn, vec);
    if (tid < 2 * BQ) {
      const int t = j * BQ + tid % BQ;
      cp_async4(smem_addr(Rs + tid), t < Tn ? row_src + t : row_src, t < Tn ? 4 : 0);
    }
  };
  fa_copy<BK, false>(Ks, k + base, C, k0, Tn, vec);
  fa_copy<BK, false>(Vs, v + base, C, k0, Tn, vec);
  issue_o(0);
  cp_async_commit();
  fa_copy<BQ, true>(Qs, q + base, C, 0, Tn, vec);
  cp_async_commit();
  float kb[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) kb[i] = key_bias(mask + (long long)b * Tn, k0 + 8 * tr + i, Tn);

  float dk_acc[8][8], dv_acc[8][8];
  fa_zero(dk_acc);
  fa_zero(dv_acc);
  for (int j = 0; j < nt; ++j) {
    const int q0 = j * BQ;
    cp_async_wait<1>();  // K, V, dO_j and its rows have landed (Q_j may be in flight)
    __syncthreads();
    float s[8][4];
    fa_zero(s);
    fa_mma_nt(s, Vs, 8 * tr, Os, 4 * tx);  // dP^T = V dO_j^T, parked in dS^T's buffer
#pragma unroll
    for (int i = 0; i < 8; ++i) st4(Ss + (8 * tr + i) * BQ + 4 * tx, s[i][0], s[i][1], s[i][2], s[i][3]);
    cp_async_wait<0>();  // Q_j
    __syncthreads();
    fa_zero(s);
    fa_mma_nt(s, Ks, 8 * tr, Qs, 4 * tx);  // S^T = K Q_j^T

    const float4 l4 = ld4(Rs + 4 * tx), d4 = ld4(Rs + BQ + 4 * tx);
    const float lse_c[4] = {l4.x, l4.y, l4.z, l4.w}, d_c[4] = {d4.x, d4.y, d4.z, d4.w};
    // dS^T also to the workspace for the dQ kernel: keys k0 .. k0 + 127, zeros past T
    float* ws_rows = ds_t + ((long long)bh * ld_ws + k0 + 8 * tr) * ld_ws + q0 + 4 * tx;
#pragma unroll
    for (int g = 0; g < 2; ++g) {  // keys 8 tr + 4 g .. + 3: one Philox call per query
      uint4 w[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        w[c] = dropping ? philox4x32_10(make_uint4((k0 >> 2) + 2 * tr + g, q0 + 4 * tx + c, cbh, 0u), key0, key1)
                        : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * g + r;
        float* srow = Ss + (8 * tr + i) * BQ + 4 * tx;
        const float4 dp4 = ld4(srow);  // this thread's own dP^T, written above
        const float dp[4] = {dp4.x, dp4.y, dp4.z, dp4.w};
        float ds[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float l_c = q0 + 4 * tx + c < Tn ? lse_c[c] : INFINITY;  // p = 0 past T
          const float p = expf(s[i][c] * sm_scale + kb[i] - l_c);
          const float f = dropping ? (word_of(w[c], r) >= drop.thresh ? drop.scale : 0.f) : 1.f;
          s[i][c] = p * f;                      // P^T
          ds[c] = p * (dp[c] * f - d_c[c]);     // dS^T
        }
        st4(Ps + (8 * tr + i) * BQ + 4 * tx, s[i][0], s[i][1], s[i][2], s[i][3]);
        st4(srow, ds[0], ds[1], ds[2], ds[3]);
        st4(ws_rows + (long long)i * ld_ws, ds[0], ds[1], ds[2], ds[3]);
      }
    }
    __syncthreads();
    fa_mma_nn<8, BQ, BQ>(dv_acc, Ps, 8 * tr, Os, tx);  // dV += P^T dO_j
    __syncthreads();                                   // every thread is done with dO_j and its rows
    if (j + 1 < nt) issue_o(j + 1);
    cp_async_commit();
    fa_mma_nn<8, BQ, BQ>(dk_acc, Ss, 8 * tr, Qs, tx);  // dK += dS^T Q_j
    __syncthreads();                                   // every thread is done with Q_j and dS^T
    if (j + 1 < nt) fa_copy<BQ, true>(Qs, q + base, C, q0 + BQ, Tn, vec);
    cp_async_commit();
  }
  cp_async_wait<0>();

  float* dv_b = dv + (long long)b * Tn * ld_dv + h * HD;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = k0 + 8 * tr + i;
    if (t >= Tn) continue;
    float* dkp = dk + base + (long long)t * C + 4 * tx;
    float* dvp = dv_b + (long long)t * ld_dv + 4 * tx;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      fa_store4(dkp + 32 * hh, dk_acc[i][4 * hh] * sm_scale, dk_acc[i][4 * hh + 1] * sm_scale,
                dk_acc[i][4 * hh + 2] * sm_scale, dk_acc[i][4 * hh + 3] * sm_scale, vec);
      fa_store4(dvp + 32 * hh, dv_acc[i][4 * hh], dv_acc[i][4 * hh + 1], dv_acc[i][4 * hh + 2], dv_acc[i][4 * hh + 3],
                vec);
    }
  }
}

// ---- backward dQ: one CTA per (128-query tile, head, item) ----------------
// dQ = sm_scale dS K over the keys, from the dS^T that the dK/dV kernel wrote
// ([B*H][T'][T'], T' = T rounded up to 64). Thread (tq, td) = (tid / 8,
// tid % 8): queries 8 tq .. 8 tq + 7, features 4 td .. 4 td + 3 and 32 + 4 td
// .. 32 + 4 td + 3. 16-key steps through a 4-deep cp.async ring, three steps
// ahead; per key, two float4 of dS^T's row (one address per quarter-warp) and
// two of K's (eight consecutive chunks) feed 64 FFMA.
constexpr int FQ_BQ = 128, FQ_BK = 16, FQ_STAGES = 4;
constexpr int FQ_SLOT = FQ_BK * (FQ_BQ + HD);                     // dS^T rows [16][128], then K rows [16][64]
constexpr int FQ_SMEM = FQ_STAGES * FQ_SLOT * (int)sizeof(float);  // 48 KB: four CTAs an SM

__global__ void __launch_bounds__(FA_THREADS, 4) attn_bwd_dq_kernel_f32(const float* ds_t, int ld_ws, const float* k,
                                                                       float* dq_r, int Tn, int C, int H,
                                                                       float sm_scale, int vec) {
  extern __shared__ __align__(16) float fa_sm[];
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * FQ_BQ;
  const int tid = threadIdx.x, td = tid & 7, tq = tid >> 3;
  const long long base = (long long)b * Tn * C + h * HD;
  const float* ws = ds_t + (long long)(b * H + h) * ld_ws * ld_ws;
  const int steps = (Tn + FQ_BK - 1) / FQ_BK;

  // keys step * 16 ..: dS^T's rows (32 chunks each) and K's (16), zero at or
  // past T and past the workspace's width; a quarter-warp stores eight
  // consecutive chunks of one row
  auto issue = [&](int step) {
    float* slot = fa_sm + (step % FQ_STAGES) * FQ_SLOT;
    const int k0 = step * FQ_BK;
#pragma unroll
    for (int l = 0; l < FQ_BK * FQ_BQ / 4 / FA_THREADS; ++l) {
      const int e = tid + FA_THREADS * l, r = e >> 5, c = e & 31;
      const bool in = k0 + r < Tn && q0 + 4 * c < ld_ws;
      cp_async16(smem_addr(slot + r * FQ_BQ + 4 * c), in ? ws + (long long)(k0 + r) * ld_ws + q0 + 4 * c : ws,
                 in ? 16 : 0);
    }
    float* kt = slot + FQ_BK * FQ_BQ;
#pragma unroll
    for (int l = 0; l < FQ_BK * HD / 4 / FA_THREADS; ++l) {
      const int e = tid + FA_THREADS * l, r = e >> 4, c = e & 15;
      const bool in = k0 + r < Tn;
      const float* p = in ? k + base + (long long)(k0 + r) * C + 4 * c : k;
      if (vec) {
        cp_async16(smem_addr(kt + r * HD + 4 * c), p, in ? 16 : 0);
      } else {
#pragma unroll
        for (int x = 0; x < 4; ++x) kt[r * HD + 4 * c + x] = in ? p[x] : 0.f;
      }
    }
  };

  float acc[8][8];
  fa_zero(acc);
#pragma unroll
  for (int st = 0; st < FQ_STAGES - 1; ++st) {
    if (st < steps) issue(st);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    // step's copies have landed for every thread, and every thread's products
    // of step - 1 (whose slot is refilled below) are done
    cp_async_wait<FQ_STAGES - 2>();
    __syncthreads();
    if (step + FQ_STAGES - 1 < steps) issue(step + FQ_STAGES - 1);
    cp_async_commit();
    const float* a = fa_sm + (step % FQ_STAGES) * FQ_SLOT + 8 * tq;
    const float* bk = fa_sm + (step % FQ_STAGES) * FQ_SLOT + FQ_BK * FQ_BQ + 4 * td;
#pragma unroll
    for (int kk = 0; kk < FQ_BK; ++kk) {
      const float4 a0 = ld4(a + kk * FQ_BQ), a1 = ld4(a + kk * FQ_BQ + 4);
      const float4 b0 = ld4(bk + kk * HD), b1 = ld4(bk + kk * HD + 32);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = q0 + 8 * tq + i;
    if (t >= Tn) continue;
    float* dst = dq_r + base + (long long)t * C + 4 * td;
    fa_store4(dst, acc[i][0] * sm_scale, acc[i][1] * sm_scale, acc[i][2] * sm_scale, acc[i][3] * sm_scale, vec);
    fa_store4(dst + 32, acc[i][4] * sm_scale, acc[i][5] * sm_scale, acc[i][6] * sm_scale, acc[i][7] * sm_scale,
              vec);
  }
}

// ============================================================= bf16: wgmma ==
//
// The same three kernels with every product on the tensor cores (wgmma.cuh),
// one warpgroup (128 threads) per CTA over 64-row query or key tiles. Shared
// memory holds 64 x 64 bf16 tiles in the 128-byte swizzle, each copied once
// by cp.async as 128-byte rows of its [B, T, C] operand (rows are positions,
// the 64 features of the head run along a row) and read by wgmma through a
// K-major descriptor (the features are the product's depth) or an MN-major
// one (the positions are):
//   forward  S = Q K^T        A = Q  K-major, B = K  K-major
//            att += P V        A = P  registers, B = V  MN-major
//   dK, dV   S^T = K Q^T       A = K  K-major, B = Q  K-major
//            dP^T = V dO^T     A = V  K-major, B = dO K-major
//            dV += P^T dO      A = P^T registers, B = dO MN-major
//            dK += dS^T Q      A = dS^T registers, B = Q MN-major
//   dQ       S = Q K^T, dP = dO V^T   all K-major
//            dQ += dS K        A = dS registers, B = K MN-major
// The elementwise work runs on the accumulator fragments: thread t of the
// warpgroup holds rows r0 = 16 (t / 32) + (t % 32) / 4 and r0 + 8, and the
// column pairs 8j + 2 (t % 4) + {0, 1}; element 4j + 2h + e of a fragment is
// (row r0 + 8h, column 8j + 2 (t % 4) + e). That is also the layout of an A
// operand in registers, so P and dS are rounded to bf16 and packed where they
// are computed and never touch shared memory. The forward makes two passes
// (the log-sum-exp first, then the normalised weights), so the dropped
// weights are rounded normalised, as the TPU kernel rounds them.
//
// Dropout bits: a Philox call gives the words of four consecutive keys of one
// query. Where rows are queries (forward, dQ) lanes t and t ^ 1 hold the same
// four keys of rows r0 and r0 + 8: one draws row r0's words, the other row
// r0 + 8's, and they swap the two each needs (keep_rows_q). Where rows are
// keys (dK/dV) the four keys of a group lie in the four lanes that differ in
// bits 2-3: each of them draws a quarter of the groups and hands every other
// lane its word by three shuffles (keep_rows_k). Either way 1024 calls per
// 64 x 64 tile, one per four weights, as in the FMA kernels.
//
// Ragged tiles: rows past T are zero-filled by the copy; keys past T get the
// bias -inf; padded query rows get lse = +inf (p = 0) and D = 0 in the
// backward. Outputs are staged as bf16 tiles in shared memory and stored as
// 16-byte rows (element by element where a pointer or stride is not aligned).

constexpr int WG_FWD_SMEM = 1024 + 5 * WG_TILE_BYTES;                      // Q, K x 2, V x 2
constexpr int WG_DKV_SMEM = 1024 + 6 * WG_TILE_BYTES + 4 * TQ * (int)sizeof(float);  // K, V, Q x 2, dO x 2, lse / D x 2
constexpr int WG_DQ_SMEM = 1024 + 6 * WG_TILE_BYTES;                       // Q, dO, K x 2, V x 2

// the 64 x 64 tile of rows t0.. of one head at `base` ([B, T, C]; rows past T zero)
__device__ __forceinline__ void load_rows(uint8_t* tile, const bf16* base, int t0, int Tn, int C, bool vec) {
  stts::load_tile(tile, base + (long long)t0 * C, C, min(64, Tn - t0), HD, vec);
}
__device__ __forceinline__ void store_rows(const uint8_t* tile, bf16* base, long long ld, int t0, int Tn, bool vec) {
  stts::store_tile(tile, base + (long long)t0 * ld, ld, min(64, Tn - t0), HD, vec);
}
// 16-byte rows need a 16-byte aligned pointer and a row stride of whole chunks
__device__ __forceinline__ bool rows_aligned(const void* p, long long ld) {
  return ((uintptr_t)p & 15) == 0 && ld % 8 == 0;
}

// Stage a 64 x 64 f32 fragment as bf16 (x * mul, or its rounding remainder
// x * mul - bf16(x * mul) with LO) into a swizzled tile.
template <bool LO = false>
__device__ __forceinline__ void stage_tile(uint8_t* tile, const float (&x)[32], float mul) {
  const int lane = threadIdx.x % 32, cq = 2 * (lane % 4);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * (threadIdx.x / 32) + lane / 4 + 8 * hh;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float x0 = x[4 * j + 2 * hh] * mul, x1 = x[4 * j + 2 * hh + 1] * mul;
      if (LO) x0 -= round_to<bf16>(x0), x1 -= round_to<bf16>(x1);
      *reinterpret_cast<uint32_t*>(tile + swz(r, 8 * j + cq)) = pack_bf16(x0, x1);
    }
  }
}

// d = A B over the 64-deep contraction, A and B from K-major descriptors:
// four m64n64k16 steps, neither committed nor waited for
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da, uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_ss<0, 0>(d, desc_k<false>(da, kk), desc_k<false>(db, kk), kk > 0);
}
// d += A B with A packed in registers (a[kk]: the 16-deep slice kk) and B
// MN-major, neither committed nor waited for
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4][4], uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_rs<1>(d, a[kk], desc_k<true>(db, kk));
}
// the A fragments of a product from a fragment x (rows as x's, the depth its columns)
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

// Keep bits of a fragment whose rows are queries q0 + r0 + 8h and whose columns
// are keys k0 + 8j + 2 (lane % 4) + e: bit 4j + 2h + e. Lanes t and t ^ 1 share
// the key group 2j + (lane % 4) / 2 of the tile: the even lane draws row r0,
// the odd row r0 + 8, and each passes the other the two words it needs.
__device__ __forceinline__ uint32_t keep_rows_q(uint32_t key0, uint32_t key1, uint32_t thresh, int k0, int q_r0,
                                                uint32_t bh) {
  const int lane = threadIdx.x % 32, odd = lane & 1;
  uint32_t keep = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint4 w = philox4x32_10(make_uint4((k0 >> 2) + 2 * j + ((lane & 3) >> 1), q_r0 + 8 * odd, bh, 0u), key0, key1);
    // even lane: words 0, 1 of row r0 (its own) and of row r0 + 8; odd lane: words 2, 3 of both
    const uint32_t in0 = __shfl_xor_sync(0xffffffffu, odd ? w.x : w.z, 1);
    const uint32_t in1 = __shfl_xor_sync(0xffffffffu, odd ? w.y : w.w, 1);
    const uint32_t r00 = odd ? in0 : w.x, r01 = odd ? in1 : w.y;  // row r0
    const uint32_t r80 = odd ? w.z : in0, r81 = odd ? w.w : in1;  // row r0 + 8
    keep |= ((uint32_t)(r00 >= thresh) | (uint32_t)(r01 >= thresh) << 1 | (uint32_t)(r80 >= thresh) << 2 |
             (uint32_t)(r81 >= thresh) << 3) << (4 * j);
  }
  return keep;
}

// Keep bits of a fragment whose rows are keys k0 + r0 + 8h and whose columns
// are queries q0 + 8j + 2 (lane % 4) + e: bit 4j + 2h + e. Row r0's key group
// is shared by the four lanes a = (lane >> 2) & 3 (bits 2-3), and key r0 is
// word a of it. Lane a draws, for each j, the group of element 4j + a (h =
// a / 2, e = a % 2), keeps its own word and sends word a ^ r to lane a ^ r.
__device__ __forceinline__ uint32_t keep_rows_k(uint32_t key0, uint32_t key1, uint32_t thresh, int k0, int q0,
                                                uint32_t bh) {
  const int lane = threadIdx.x % 32, a = (lane >> 2) & 3;
  const uint32_t grp = (k0 >> 2) + 4 * (threadIdx.x / 32) + 2 * (a >> 1) + (lane >> 4);
  const int q = q0 + 2 * (lane % 4) + (a & 1);
  uint32_t keep = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint4 w = philox4x32_10(make_uint4(grp, q + 8 * j, bh, 0u), key0, key1);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      uint32_t x = word_of(w, a ^ r);
      if (r) x = __shfl_xor_sync(0xffffffffu, x, r << 2);
      keep |= (uint32_t)(x >= thresh) << (4 * j + (a ^ r));
    }
  }
  return keep;
}

// key bias of this thread's 16 columns of the key tile at k0
__device__ __forceinline__ void key_bias16(float (&kb)[16], const float* mask_b, int k0, int Tn) {
  const int cq = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const int t = k0 + 8 * (c / 2) + cq + c % 2;
    kb[c] = t < Tn ? (mask_b[t] > 0.f ? 0.f : kNeg) : -INFINITY;
  }
}

// ---- forward: one warpgroup per (64-query tile, head, item) ---------------
__global__ void __launch_bounds__(WG_THREADS) attn_fwd_kernel_wgmma(const bf16* q, const bf16* k, const bf16* v,
                                                                    const float* mask, bf16* att, bf16* att_lo,
                                                                    float* lse, int Tn, int C, int H, float sm_scale,
                                                                    Dropout drop) {
  extern __shared__ uint8_t sm_raw[];
  uint8_t* sm = align_1024(sm_raw);
  uint8_t* Qs = sm;
  const auto Ks = [&](int j) { return sm + (1 + (j & 1)) * WG_TILE_BYTES; };
  const auto Vs = [&](int j) { return sm + (3 + (j & 1)) * WG_TILE_BYTES; };
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * TQ;
  const int tid = threadIdx.x, lane = tid % 32;
  const int r0 = 16 * (tid / 32) + lane / 4;
  const long long base = (long long)b * Tn * C + h * HD;
  const float* mask_b = mask + (long long)b * Tn;
  const uint32_t bh = b * H + h;
  const bool vq = rows_aligned(q, C), vk = rows_aligned(k, C), vv = rows_aligned(v, C);
  const bool dropping = drop.seed != nullptr;
  const uint32_t key0 = dropping ? (uint32_t)drop.seed[0] : 0u, key1 = dropping ? (uint32_t)drop.seed[1] : 0u;
  const uint32_t cbh = drop.row_head(b, H, h);  // the counter's (global row, head) word

  const int nt = (Tn + TK - 1) / TK;
  auto issue = [&](int j, bool with_v) {
    load_rows(Ks(j), k + base, j * TK, Tn, C, vk);
    if (with_v) load_rows(Vs(j), v + base, j * TK, Tn, C, vv);
  };
  // tile j's copies have landed (the next tile's stay in flight) and are
  // visible to wgmma's async proxy
  auto arrive = [&]() {
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
  };
  load_rows(Qs, q + base, q0, Tn, C, vq);
  cp_async_commit();
  issue(0, false);
  cp_async_commit();
  const uint64_t dq = make_desc<false>(smem_addr(Qs));

  float s[32], kb[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  auto qk = [&](int j) {
    fence_regs(s);
    wgmma_fence();
    mma_ss(s, dq, make_desc<false>(smem_addr(Ks(j))));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
  };

  // pass 1: each row's max and sum -> log-sum-exp. m is common to the quad
  // that holds a row; l sums this thread's columns, the quad's sum at the end
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int j = 0; j < nt; ++j) {
    if (j + 1 < nt) issue(j + 1, false);
    cp_async_commit();
    arrive();
    key_bias16(kb, mask_b, j * TK, Tn);
    qk(j);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        float& x = s[4 * (c / 2) + 2 * hh + c % 2];
        x = x * sm_scale + kb[c];
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hh], mx);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) rs += expf(s[4 * (c / 2) + 2 * hh + c % 2] - m_new);
      l[hh] = l[hh] * expf(m[hh] - m_new) + rs;
      m[hh] = m_new;
    }
    __syncthreads();  // K_j's buffer is free for tile j + 2
  }
  issue(0, true);
  cp_async_commit();
  float lse_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lt = l[hh] + __shfl_xor_sync(0xffffffffu, l[hh], 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    lse_r[hh] = m[hh] + logf(lt);
    const int t = q0 + r0 + 8 * hh;
    if (lane % 4 == 0 && t < Tn) lse[(long long)bh * Tn + t] = lse_r[hh];
  }

  // pass 2: the normalised, dropped weights, rounded to bf16 as the A
  // fragment of att += P V_j
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  for (int j = 0; j < nt; ++j) {
    if (j + 1 < nt) issue(j + 1, true);
    cp_async_commit();
    arrive();
    key_bias16(kb, mask_b, j * TK, Tn);
    qk(j);
    const uint32_t keep = dropping ? keep_rows_q(key0, key1, drop.thresh, j * TK, q0 + r0, cbh) : 0u;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 2 * (i / 4) + i % 2, hh = (i / 2) % 2;
      s[i] = expf(s[i] * sm_scale + kb[c] - lse_r[hh]);
      if (dropping) s[i] *= (keep >> i) & 1u ? drop.scale : 0.f;
    }
    uint32_t pa[4][4];
    pack_a(pa, s);
    fence_regs(o);
    wgmma_fence();
    mma_rs(o, pa, make_desc<true>(smem_addr(Vs(j))));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    __syncthreads();  // K_j and V_j's buffers are free for tile j + 2
  }

  // att and its rounding remainder (bf16 always has att_lo), staged in Q's and K_0's buffers
  stage_tile(Qs, o, 1.f);
  stage_tile<true>(Ks(0), o, 1.f);
  __syncthreads();
  store_rows(Qs, att + base, C, q0, Tn, rows_aligned(att, C));
  store_rows(Ks(0), att_lo + base, C, q0, Tn, rows_aligned(att_lo, C));
}

// ---- backward dK, dV: one warpgroup per (64-key tile, head, item) ----------
// rows of every fragment are keys; Q, dO and the rows' lse and D double-buffered
__global__ void __launch_bounds__(WG_THREADS) attn_bwd_dkv_kernel_wgmma(const bf16* q, const bf16* k, const bf16* v,
                                                                        const bf16* datt, const float* lse,
                                                                        const float* Dv, const float* mask, bf16* dk,
                                                                        bf16* dv, int ld_dv, int Tn, int C, int H,
                                                                        float sm_scale, Dropout drop) {
  extern __shared__ uint8_t sm_raw[];
  uint8_t* sm = align_1024(sm_raw);
  uint8_t* Ks = sm;
  uint8_t* Vs = sm + WG_TILE_BYTES;
  const auto Qs = [&](int j) { return sm + (2 + (j & 1)) * WG_TILE_BYTES; };
  const auto Os = [&](int j) { return sm + (4 + (j & 1)) * WG_TILE_BYTES; };
  // lse of query tile j at [0, 64), its D at [64, 128)
  const auto Rs = [&](int j) { return reinterpret_cast<float*>(sm + 6 * WG_TILE_BYTES) + (j & 1) * 2 * TQ; };
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * TK;
  const int tid = threadIdx.x, lane = tid % 32;
  const int r0 = 16 * (tid / 32) + lane / 4, cq = 2 * (lane % 4);
  const long long base = (long long)b * Tn * C + h * HD;
  const uint32_t bh = b * H + h;
  const bool vq = rows_aligned(q, C), vo = rows_aligned(datt, C);
  const bool dropping = drop.seed != nullptr;
  const uint32_t key0 = dropping ? (uint32_t)drop.seed[0] : 0u, key1 = dropping ? (uint32_t)drop.seed[1] : 0u;
  const uint32_t cbh = drop.row_head(b, H, h);  // the counter's (global row, head) word
  const float* row_src = (tid < TQ ? lse : Dv) + (long long)bh * Tn;

  const int nt = (Tn + TQ - 1) / TQ;
  auto issue = [&](int j) {
    load_rows(Qs(j), q + base, j * TQ, Tn, C, vq);
    load_rows(Os(j), datt + base, j * TQ, Tn, C, vo);
    const int t = j * TQ + tid % TQ;  // threads 0-63 copy lse, 64-127 D; zero past T
    cp_async4(smem_addr(Rs(j) + tid), t < Tn ? row_src + t : row_src, t < Tn ? 4 : 0);
  };
  load_rows(Ks, k + base, k0, Tn, C, rows_aligned(k, C));
  load_rows(Vs, v + base, k0, Tn, C, rows_aligned(v, C));
  cp_async_commit();
  issue(0);
  cp_async_commit();
  float kb[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = k0 + r0 + 8 * hh;
    kb[hh] = t < Tn ? (mask[(long long)b * Tn + t] > 0.f ? 0.f : kNeg) : -INFINITY;
  }
  const uint64_t dK = make_desc<false>(smem_addr(Ks)), dV = make_desc<false>(smem_addr(Vs));

  float s[32], dp[32], dk_acc[32], dv_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = dk_acc[i] = dv_acc[i] = 0.f;
  for (int j = 0; j < nt; ++j) {
    if (j + 1 < nt) issue(j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    const uint32_t qa = smem_addr(Qs(j)), oa = smem_addr(Os(j));
    // S^T = K Q_j^T and dP^T = V dO_j^T
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    mma_ss(s, dK, make_desc<false>(qa));
    mma_ss(dp, dV, make_desc<false>(oa));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    const float* rs = Rs(j);
    const uint32_t keep = dropping ? keep_rows_k(key0, key1, drop.thresh, k0, j * TQ, cbh) : 0u;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int col = 8 * (c / 2) + cq + c % 2;
      const float l_c = j * TQ + col < Tn ? rs[col] : INFINITY, d_c = rs[TQ + col];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = 4 * (c / 2) + 2 * hh + c % 2;
        const float p = expf(s[i] * sm_scale + kb[hh] - l_c);
        const float f = dropping ? ((keep >> i) & 1u ? drop.scale : 0.f) : 1.f;
        s[i] = p * f;                     // P^T, the dropped weight
        dp[i] = p * (dp[i] * f - d_c);    // dS^T
      }
    }
    uint32_t pa[4][4], sa[4][4];
    pack_a(pa, s);
    pack_a(sa, dp);
    // dV += P^T dO_j and dK += dS^T Q_j, the same tiles through MN-major descriptors
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
    mma_rs(dv_acc, pa, make_desc<true>(oa));
    mma_rs(dk_acc, sa, make_desc<true>(qa));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    __syncthreads();  // Q_j, dO_j and their rows' buffers are free for tile j + 2
  }

  stage_tile(Ks, dk_acc, sm_scale);
  stage_tile(Vs, dv_acc, 1.f);
  __syncthreads();
  store_rows(Ks, dk + base, C, k0, Tn, rows_aligned(dk, C));
  bf16* dv_b = dv + (long long)b * Tn * ld_dv + h * HD;
  store_rows(Vs, dv_b, ld_dv, k0, Tn, rows_aligned(dv, ld_dv));
}

// ---- backward dQ: one warpgroup per (64-query tile, head, item) -----------
__global__ void __launch_bounds__(WG_THREADS) attn_bwd_dq_kernel_wgmma(const bf16* q, const bf16* k, const bf16* v,
                                                                       const bf16* datt, const float* lse,
                                                                       const float* Dv, const float* mask, bf16* dq_r,
                                                                       int Tn, int C, int H, float sm_scale,
                                                                       Dropout drop) {
  extern __shared__ uint8_t sm_raw[];
  uint8_t* sm = align_1024(sm_raw);
  uint8_t* Qs = sm;
  uint8_t* Os = sm + WG_TILE_BYTES;
  const auto Ks = [&](int j) { return sm + (2 + (j & 1)) * WG_TILE_BYTES; };
  const auto Vs = [&](int j) { return sm + (4 + (j & 1)) * WG_TILE_BYTES; };
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * TQ;
  const int tid = threadIdx.x, lane = tid % 32;
  const int r0 = 16 * (tid / 32) + lane / 4;
  const long long base = (long long)b * Tn * C + h * HD;
  const float* mask_b = mask + (long long)b * Tn;
  const uint32_t bh = b * H + h;
  const bool vk = rows_aligned(k, C), vv = rows_aligned(v, C);
  const bool dropping = drop.seed != nullptr;
  const uint32_t key0 = dropping ? (uint32_t)drop.seed[0] : 0u, key1 = dropping ? (uint32_t)drop.seed[1] : 0u;
  const uint32_t cbh = drop.row_head(b, H, h);  // the counter's (global row, head) word

  const int nt = (Tn + TK - 1) / TK;
  auto issue = [&](int j) {
    load_rows(Ks(j), k + base, j * TK, Tn, C, vk);
    load_rows(Vs(j), v + base, j * TK, Tn, C, vv);
  };
  load_rows(Qs, q + base, q0, Tn, C, rows_aligned(q, C));
  load_rows(Os, datt + base, q0, Tn, C, rows_aligned(datt, C));
  cp_async_commit();
  issue(0);
  cp_async_commit();
  float lse_r[2], d_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = q0 + r0 + 8 * hh;
    lse_r[hh] = t < Tn ? lse[(long long)bh * Tn + t] : INFINITY;
    d_r[hh] = t < Tn ? Dv[(long long)bh * Tn + t] : 0.f;
  }
  const uint64_t dQ = make_desc<false>(smem_addr(Qs)), dO = make_desc<false>(smem_addr(Os));

  float s[32], dp[32], dq_acc[32], kb[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = dq_acc[i] = 0.f;
  for (int j = 0; j < nt; ++j) {
    if (j + 1 < nt) issue(j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    key_bias16(kb, mask_b, j * TK, Tn);
    const uint32_t ka = smem_addr(Ks(j));
    // S = Q K_j^T and dP = dO V_j^T
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    mma_ss(s, dQ, make_desc<false>(ka));
    mma_ss(dp, dO, make_desc<false>(smem_addr(Vs(j))));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    const uint32_t keep = dropping ? keep_rows_q(key0, key1, drop.thresh, j * TK, q0 + r0, cbh) : 0u;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 2 * (i / 4) + i % 2, hh = (i / 2) % 2;
      const float p = expf(s[i] * sm_scale + kb[c] - lse_r[hh]);
      const float f = dropping ? ((keep >> i) & 1u ? drop.scale : 0.f) : 1.f;
      dp[i] = p * (dp[i] * f - d_r[hh]);  // dS
    }
    uint32_t sa[4][4];
    pack_a(sa, dp);
    // dQ += dS K_j, K_j through its MN-major descriptor
    fence_regs(dq_acc);
    wgmma_fence();
    mma_rs(dq_acc, sa, make_desc<true>(ka));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq_acc);
    __syncthreads();  // K_j and V_j's buffers are free for tile j + 2
  }

  stage_tile(Qs, dq_acc, sm_scale);
  __syncthreads();
  store_rows(Qs, dq_r + base, C, q0, Tn, rows_aligned(dq_r, C));
}

// ================================================================ launchers ==

// bf16 runs the wgmma kernels, f32 the FMA ones
template <typename T>
void launch_attn_fwd(const T* q, const T* k, const T* v, const float* mask, T* att, T* att_lo, float* lse, int B,
                     int Tn, int C, int H, float sm_scale, Dropout drop, cudaStream_t s) {
  if constexpr (std::is_same<T, bf16>::value) {
    const dim3 grid((Tn + TQ - 1) / TQ, H, B);
    cudaFuncSetAttribute(attn_fwd_kernel_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_FWD_SMEM);
    attn_fwd_kernel_wgmma<<<grid, WG_THREADS, WG_FWD_SMEM, s>>>(q, k, v, mask, att, att_lo, lse, Tn, C, H, sm_scale,
                                                                drop);
  } else {
    const dim3 grid((Tn + FA_FWD_BQ - 1) / FA_FWD_BQ, H, B);
    const int vec = C % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(att);
    cudaFuncSetAttribute(attn_fwd_kernel_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, FA_FWD_SMEM);
    cudaFuncSetAttribute(attn_fwd_kernel_f32, cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    attn_fwd_kernel_f32<<<grid, FA_THREADS, FA_FWD_SMEM, s>>>(q, k, v, mask, att, lse, Tn, C, H, sm_scale, drop, vec);
  }
}

// D = rowsum(datt * (att + att_lo)) (att_lo may be null), then dK (scaled) ->
// dk [M, C], dV -> dv (row stride ld_dv), dQ (scaled) -> dq [M, C]
// ds_ws: f32 only, B*H*attn_ws_width(Tn)^2 floats for dS^T (null in bf16)
inline int attn_ws_width(int Tn) { return (Tn + FA_DKV_BK - 1) / FA_DKV_BK * FA_DKV_BK; }

template <typename T>
void launch_attn_bwd(const T* q, const T* k, const T* v, const T* att, const T* att_lo, const T* datt,
                     const float* lse, const float* mask, float* Dv, T* dq, T* dk, T* dv, int ld_dv, float* ds_ws,
                     int B, int Tn, int C, int H, float sm_scale, Dropout drop, cudaStream_t s) {
  const int n_rows = B * H * Tn;
  rowdot_kernel<T><<<(n_rows + 7) / 8, 256, 0, s>>>(datt, att, att_lo, Dv, Tn, C, H, n_rows);
  const dim3 grid((Tn + TK - 1) / TK, H, B);
  if constexpr (std::is_same<T, bf16>::value) {
    cudaFuncSetAttribute(attn_bwd_dkv_kernel_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_DKV_SMEM);
    attn_bwd_dkv_kernel_wgmma<<<grid, WG_THREADS, WG_DKV_SMEM, s>>>(q, k, v, datt, lse, Dv, mask, dk, dv, ld_dv, Tn,
                                                                    C, H, sm_scale, drop);
    cudaFuncSetAttribute(attn_bwd_dq_kernel_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_DQ_SMEM);
    attn_bwd_dq_kernel_wgmma<<<grid, WG_THREADS, WG_DQ_SMEM, s>>>(q, k, v, datt, lse, Dv, mask, dq, Tn, C, H,
                                                                  sm_scale, drop);
  } else {
    const int vec = C % 4 == 0 && ld_dv % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                    aligned16(datt) && aligned16(dq) && aligned16(dk) && aligned16(dv);
    cudaFuncSetAttribute(attn_bwd_dkv_kernel_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, FA_DKV_SMEM);
    cudaFuncSetAttribute(attn_bwd_dkv_kernel_f32, cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    const int ld_ws = attn_ws_width(Tn);
    const dim3 grid_k((Tn + FA_DKV_BK - 1) / FA_DKV_BK, H, B);
    attn_bwd_dkv_kernel_f32<<<grid_k, FA_THREADS, FA_DKV_SMEM, s>>>(q, k, v, datt, lse, Dv, mask, dk, dv, ds_ws,
                                                                  ld_ws, ld_dv, Tn, C, H, sm_scale, drop, vec);
    cudaFuncSetAttribute(attn_bwd_dq_kernel_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, FQ_SMEM);
    cudaFuncSetAttribute(attn_bwd_dq_kernel_f32, cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    const dim3 grid_q((Tn + FQ_BQ - 1) / FQ_BQ, H, B);
    attn_bwd_dq_kernel_f32<<<grid_q, FA_THREADS, FQ_SMEM, s>>>(ds_ws, ld_ws, k, dq, Tn, C, H, sm_scale, vec);
  }
}

}  // namespace atr
}  // namespace stts
