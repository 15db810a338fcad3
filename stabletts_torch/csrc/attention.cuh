// Packed-head attention for head width 64, shared by the whole DiT block, its
// attention half and the packed-attention kernels (both layouts).
//
// Replaces the attention of the JAX package's TPU kernels
// ops/dit_block_pallas.py:98 fused_dit_block (and dit_attention_pallas.py),
// ops/attention_pallas.py:67 fused_attention_packed and :186
// fused_attention_packed_rope, ops/attention_pallas_t.py:64
// fused_attention_packed_t, ops/attention_pallas_v2.py:47, and the
// experiments tools/attn_exp*.py.
//
// What bounds it on the H100: its two products, 4*B*H*T^2*64 operations
// (6.6e10 at B=64, T=1000, H=4: 0.066 ms at the 989 TFLOP/s of bf16 tensor
// cores, ~1 ms at the 67 TFLOP/s of fp32 FMA) against 4*B*T*H*64 elements
// moved. So the products must run on the tensor cores: the bf16 kernel
// (attention_kernel_wgmma, below) issues both as wgmma from shared-memory
// tiles; f32 stays on fp32 FMA (attention_kernel_f32), since no TF32 form
// has been shown to hold the f32 bars. Each type has one kernel for every
// caller and option.
//
// One CTA per (64-query tile, head, batch item). Online softmax in exp2 over
// 64-key tiles, so no score tile larger than 64 x 64 exists and any T works
// (ragged tiles are masked). scores = (q . k) * score_scale + key bias, in
// log2 units: a caller whose q already carries log2(e)/sqrt(D) passes 1, a
// caller with unscaled q passes log2(e)/sqrt(D). The key bias is 0 for a valid
// key and kNeg (finite) for a padded one, so a row whose keys are all padded
// still gets a finite softmax; keys past T are excluded. Only keys are masked:
// padded query rows come out as finite values the caller masks (in f32 with
// PAD_ZERO, zeros where a whole query tile is padded). The weights are
// rounded to T before the PV product; the normaliser sums the unrounded f32
// weights.
//
// TMINOR = false: q/k/v/out are [B, T, C] row-major (element (t, c) of an item
// at t*C + c). TMINOR = true: they are [B, C, T] row-major (element (t, c) at
// c*T + t); tiles are then loaded and the result written with t as the
// fastest index, which is the contiguous one.
//
// Compile-time options (the defaults give the kernel described above; the
// attention microbenchmark variants of attention_variants.cu set them):
//   QPRE     q becomes round_T(q * log2(e)/sqrt(D)) on load (callers pass
//            score_scale 1), the numerics of a q pre-scaled in its dtype.
//   KTMINOR  the layout of K alone (q, v and out keep TMINOR's).
//   MODE     the softmax: SM_ONLINE as above; SM_NOMAX w = exp2(s + bias)
//            with no max and no rescale (it overflows where exp2 does);
//            SM_SCORE_LOWP scores and bias rounded to bf16 whatever T is, the
//            row max m taken in a first pass over the key tiles, then
//            w = round_bf16(exp2(s - m)) (s - m in f32, as XLA computes the
//            TPU body's bf16 difference) and the normaliser the f32 sum of
//            those rounded weights; SM_NONE the product alone,
//            out = round_T(s) v with no bias and no normaliser.
//   PAD_ZERO (f32 only) a 64-row tile of padded queries is written as zeros
//            without being computed; the serving callers mask those rows.
//            The variants compute every row, as the JAX variants do.
#pragma once

#include "common.cuh"
#include "fma_tiles.cuh"
#include "wgmma.cuh"

#include <math.h>
#include <type_traits>

namespace stts {

constexpr float kNeg = -0.7f * 3.402823466e38f;  // key bias of padded keys
constexpr float kLog2e = 1.4426950408889634f;

enum { SM_ONLINE = 0, SM_NOMAX = 1, SM_SCORE_LOWP = 2, SM_NONE = 3 };

constexpr int ATT_D = 64, ATT_BQ = 64, ATT_BK = 64;

// ---------------------------------------------------------------- f32: FMA --
//
// The f32 kernel of every caller and option: the serving callers (the DiT
// block, its attention half, packed attention in both layouts) under the
// default options with PAD_ZERO, and the variants of attention_variants.cu
// (QPRE, KTMINOR, MODE, or none of them for #7's core on its rotated q and k)
// without it. The variants take q, v and out as [B, T, C].
//
// What bounds it on the H100: its products on the FP32 pipes, at a request's
// 2B = 2, T = 1024 (4 heads) 2.1 GFLOP with every key valid, 0.032 ms at 67
// TFLOP/s; but a request pads its mel to the 1024-frame cap and fills a
// quarter to a third of it, and most of that work multiplies by zero. The
// variants at the microbenchmark's B = 64, T = 1000: 65.5 GFLOP, 0.978 ms.
//
// Design:
//   1. Each CTA reads its item's mask once and lists the 64-key tiles that hold
//      a valid key; it runs only those. A tile of padded keys alone would add
//      weights of exactly 0 (exp2 of kNeg less a finite max, or, without a
//      max, exp2 of kNeg) with a rescale of exactly 1, or, before the first
//      valid tile, be wiped by a rescale of 0: skipping it changes no bit.
//      Decided from the mask, so holes work. An item with no valid key runs
//      every tile (uniform weights over all keys). SM_NONE has no key bias, so
//      it reads no mask and runs every tile.
//   2. With PAD_ZERO, a query tile whose rows are all padded, in an item with a
//      valid key, is written as zeros without being computed: every serving
//      caller masks those rows (an out-projection epilogue's `* mask`, the
//      composed blocks' `* m`).
//   3. The tiles that remain run the training core's FMA products
//      (fma_tiles.cuh): BQ queries a CTA of 128 threads, a thread NI = BQ / 16
//      queries x 8 keys for S and x 8 features for o; K and V copied as they
//      lie by 16-byte cp.async into a double buffer, tile i + 1's copies in
//      flight behind tile i's products; 16-byte shared-memory reads. BQ is
//      64 (NI = 4: 4 x 8 a thread, 99 KB, two CTAs an SM): on the H100 it beat
//      BQ = 128 (8 x 8, which ptxas gives 255 registers and a 16-byte spill)
//      at every shape measured, a request's 2 x 1024 (half the CTAs) and the
//      bench batch's 16 x 1024 alike (tools/attn_f32_probe.py, PERF.md).
//      QPRE scales each thread's own chunks of the Q tile once they land.
//      SM_SCORE_LOWP runs the listed tiles twice: K alone for the row max,
//      then K and V.
// [B, T, C]: S = Q K^T reads Q [BQ][64] and K [64][64] (swizzled) along their
// features (fa_mma_nt), o += P V reads V [64 keys][64] (swizzled) along its
// features (fa_mma_nn). [B, C, T]: Q [64][BQ] and K [64][64] lie feature by
// feature, so S is an outer product over the features (fa_mma_tn), and
// o += P V reads V [64 features][64 keys] (swizzled) along its keys
// (fa_mma_nt). K alone [B, C, T] (KTMINOR): K [64 features][64 keys]
// (swizzled) is S's second operand read along its keys (fa_mma_nn). Every
// way each output is one fmaf chain (the scores over d ascending, o over the
// keys ascending), and each tile's row sum is added in one fixed order (a
// thread's keys 4 tx.. then 32 + 4 tx.., then across lanes 4, 2, 1 apart: the
// order of a butterfly over 16 lanes of four keys each), in every MODE; so
// each row's bits are those of a 4 x 4-a-thread FMA layout of the same
// function.
constexpr int ATF_MAX_TILES = 1024;  // key tiles a CTA lists (T <= 65536); past that it runs every tile
constexpr int ATF_BQ = 64;            // query rows a CTA

template <int BQ>
struct AttF32 {
  static constexpr int NI = BQ / 16;                          // queries a thread
  static constexpr int Q = BQ * HD;                           // floats of the Q tile, and of P
  static constexpr int SMEM = (2 * Q + 4 * TK * HD) * (int)sizeof(float);  // Q, P, K x 2, V x 2
};

// R x W floats of src (row stride ld) -> the [R][W] tile (chunk c of row r at
// r * W + 4 c, or with SWZ, W = 64, at fa_at<true>); row r is read where
// r < rows and column x where x < cols, the rest zero-filled. 16-byte cp.async
// where vec, else element by element.
template <int R, int W, bool SWZ>
__device__ __forceinline__ void att_copy(float* tile, const float* src, long long ld, int rows, int cols, bool vec) {
  constexpr int CH = W / 4;
#pragma unroll
  for (int l = 0; l < R * CH / FA_THREADS; ++l) {
    const int e = threadIdx.x + FA_THREADS * l, r = e / CH, c = e % CH;
    float* dst = tile + r * W + 4 * (SWZ ? c ^ ((r >> 2) & 7) : c);
    const int n = r < rows ? min(max(cols - 4 * c, 0), 4) : 0;
    const float* p = n > 0 ? src + r * ld + 4 * c : src;
    if (vec) {
      cp_async16(smem_addr(dst), p, 4 * n);
    } else {
#pragma unroll
      for (int x = 0; x < 4; ++x) dst[x] = x < n ? p[x] : 0.f;
    }
  }
}

// x -> x * f (rounded once) over the chunks of an unswizzled [R][W] tile that
// this thread copied with att_copy: its own copies, visible to it once its
// cp.async groups have completed
template <int R, int W>
__device__ __forceinline__ void att_scale(float* tile, float f) {
  constexpr int CH = W / 4;
#pragma unroll
  for (int l = 0; l < R * CH / FA_THREADS; ++l) {
    const int e = threadIdx.x + FA_THREADS * l;
    float* p = tile + (e / CH) * W + 4 * (e % CH);
    const float4 x = ld4(p);
    st4(p, __fmul_rn(x.x, f), __fmul_rn(x.y, f), __fmul_rn(x.z, f), __fmul_rn(x.w, f));
  }
}

template <bool TMINOR, int BQ, bool QPRE, bool KTMINOR, int MODE, bool PAD_ZERO>
__global__ void __launch_bounds__(FA_THREADS, 2) attention_kernel_f32(const float* q, const float* k,
                                                                     const float* v, const float* mask,
                                                                     float* out, int Tn, int C, float score_scale,
                                                                     int vec) {
  static_assert(!TMINOR || (!QPRE && KTMINOR && MODE == SM_ONLINE), "the variants take [B, T, C] q, v and out");
  using L = AttF32<BQ>;
  constexpr int NI = L::NI;
  extern __shared__ __align__(16) float af_sm[];
  float* Qs = af_sm;           // [BQ][64] as it lies; [B, C, T]: [64][BQ]
  float* Ps = Qs + L::Q;       // [BQ][64 keys] the weights, as written
  float* KV = Ps + L::Q;       // K of tile i at (i & 1), V at 2 + (i & 1): [64][64] each
  __shared__ unsigned char tile_ok[ATF_MAX_TILES];
  __shared__ short tiles[ATF_MAX_TILES];
  __shared__ int n_listed;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, tx = tid & 7, tr = tid >> 3, warp = tid >> 5, lane = tid & 31;
  const long long head = (long long)b * Tn * C + (long long)h * HD * (TMINOR ? Tn : 1);
  const long long khead = (long long)b * Tn * C + (long long)h * HD * (KTMINOR ? Tn : 1);
  const float* mask_b = mask == nullptr || MODE == SM_NONE ? nullptr : mask + (long long)b * Tn;
  const int nt = (Tn + TK - 1) / TK;

  // 1. the key tiles that hold a valid key, listed in order by warp 0
  const bool skip = mask_b != nullptr && nt <= ATF_MAX_TILES;
  if (skip) {
    for (int j = warp; j < nt; j += FA_THREADS / 32) {
      const int t = j * TK + lane;
      const bool ok = (t < Tn && mask_b[t] > 0.f) || (t + 32 < Tn && mask_b[t + 32] > 0.f);
      const bool any = __any_sync(0xffffffffu, ok);
      if (lane == 0) tile_ok[j] = any;
    }
    __syncthreads();
    if (warp == 0) {
      int n = 0;
      for (int j0 = 0; j0 < nt; j0 += 32) {
        const bool f = j0 + lane < nt && tile_ok[j0 + lane];
        const unsigned bal = __ballot_sync(0xffffffffu, f);
        if (f) tiles[n + __popc(bal & ((1u << lane) - 1u))] = (short)(j0 + lane);
        n += __popc(bal);
      }
      if (lane == 0) n_listed = n;
    }
    __syncthreads();
  }
  const bool listed = skip && n_listed > 0;
  const int nrun = listed ? n_listed : nt;

  // 2. a query tile of padded rows only: zeros
  if (PAD_ZERO && listed) {
    bool padded = true;
    for (int j = q0 / TK; j < min(nt, (q0 + BQ) / TK); ++j) padded = padded && !tile_ok[j];
    if (padded) {
      for (int e = tid; e < BQ * HD; e += FA_THREADS) {
        const int r = TMINOR ? e % BQ : e / HD, d = TMINOR ? e / BQ : e % HD, t = q0 + r;
        if (t < Tn) out[head + (TMINOR ? (long long)d * Tn + t : (long long)t * C + d)] = 0.f;
      }
      return;
    }
  }

  // 3. the listed key tiles
  auto issue = [&](int i, bool with_v) {
    const int k0 = (listed ? tiles[i] : i) * TK;
    float* Ks = KV + (i & 1) * TK * HD;
    float* Vs = KV + (2 + (i & 1)) * TK * HD;
    if constexpr (KTMINOR)
      att_copy<HD, TK, !TMINOR>(Ks, k + khead + k0, Tn, HD, Tn - k0, vec);
    else
      att_copy<TK, HD, true>(Ks, k + khead + (long long)k0 * C, C, Tn - k0, HD, vec);
    if (!with_v) return;
    if constexpr (TMINOR)
      att_copy<HD, TK, true>(Vs, v + head + k0, Tn, HD, Tn - k0, vec);
    else
      att_copy<TK, HD, true>(Vs, v + head + (long long)k0 * C, C, Tn - k0, HD, vec);
  };
  // s = Q K_i^T
  auto qk = [&](float (&s)[NI][8], int i) {
    const float* Ks = KV + (i & 1) * TK * HD;
    fa_zero(s);
    if constexpr (TMINOR)
      fa_mma_tn<BQ>(s, Qs, NI * tr, Ks, tx);
    else if constexpr (KTMINOR)
      fa_mma_nn(s, Qs, NI * tr, Ks, tx);
    else
      fa_mma_nt(s, Qs, NI * tr, Ks, 4 * tx);
  };
  // key bias of this thread's keys 4 tx + (c & 3) + 32 (c >> 2) of tile i
  auto key_bias = [&](float (&kb)[8], int i) {
    const int k0 = (listed ? tiles[i] : i) * TK;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int t = k0 + 4 * tx + (c & 3) + 32 * (c >> 2);
      kb[c] = t < Tn ? ((mask_b == nullptr || mask_b[t] > 0.f) ? 0.f : kNeg) : -INFINITY;
    }
  };
  if constexpr (TMINOR)
    att_copy<HD, BQ, false>(Qs, q + head + q0, Tn, HD, Tn - q0, vec);
  else
    att_copy<BQ, HD, false>(Qs, q + head + (long long)q0 * C, C, Tn - q0, HD, vec);
  issue(0, MODE != SM_SCORE_LOWP);
  cp_async_commit();
  if constexpr (QPRE) {
    cp_async_wait<0>();
    att_scale<BQ, HD>(Qs, kLog2e / sqrtf((float)HD));
  }

  float o[NI][8], m[NI], l[NI];
  fa_zero(o);
#pragma unroll
  for (int i = 0; i < NI; ++i) m[i] = -INFINITY, l[i] = 0.f;
  if constexpr (MODE == SM_SCORE_LOWP) {
    // each row's max of the bf16 scores over every listed key tile first
    for (int i = 0; i < nrun; ++i) {
      cp_async_wait<0>();
      __syncthreads();
      if (i + 1 < nrun) issue(i + 1, false);
      cp_async_commit();
      float s[NI][8], kb[8];
      qk(s, i);
      key_bias(kb, i);
#pragma unroll
      for (int i2 = 0; i2 < NI; ++i2) {
        float mx = -INFINITY;
#pragma unroll
        for (int c = 0; c < 8; ++c)
          mx = fmaxf(mx, round_to<bf16>(round_to<bf16>(s[i2][c] * score_scale) + round_to<bf16>(kb[c])));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        m[i2] = fmaxf(m[i2], mx);
      }
    }
    __syncthreads();  // every thread is done with the last K tile
    issue(0, true);
    cp_async_commit();
  }

  for (int i = 0; i < nrun; ++i) {
    const float* Vs = KV + (2 + (i & 1)) * TK * HD;
    cp_async_wait<0>();  // tile i (and Q) have landed
    __syncthreads();     // ... for every thread, and every thread is done with tile i - 1 and P
    if (i + 1 < nrun) issue(i + 1, true);
    cp_async_commit();

    float s[NI][8], kb[8];
    qk(s, i);
    if constexpr (MODE != SM_NONE) key_bias(kb, i);
#pragma unroll
    for (int i2 = 0; i2 < NI; ++i2) {
      // the row's eight threads are the eight lanes 8 (tr % 4) .. 8 (tr % 4) + 7
      float corr = 1.f;
      if constexpr (MODE == SM_ONLINE) {
        float mx = -INFINITY;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          s[i2][c] = s[i2][c] * score_scale + kb[c];
          mx = fmaxf(mx, s[i2][c]);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        const float m_new = fmaxf(m[i2], mx);
        corr = exp2f(m[i2] - m_new);  // 0 on the first tile (m = -inf)
#pragma unroll
        for (int c = 0; c < 8; ++c) s[i2][c] = exp2f(s[i2][c] - m_new);
        m[i2] = m_new;
#pragma unroll
        for (int c = 0; c < 8; ++c) o[i2][c] *= corr;
      } else {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          float& x = s[i2][c];
          if constexpr (MODE == SM_NOMAX) {
            x = exp2f(x * score_scale + kb[c]);
          } else if constexpr (MODE == SM_SCORE_LOWP) {
            const float sv = round_to<bf16>(round_to<bf16>(x * score_scale) + round_to<bf16>(kb[c]));
            x = round_to<bf16>(exp2f(sv - m[i2]));
          } else {
            x = x * score_scale;  // SM_NONE: the product alone
          }
        }
      }
      if constexpr (MODE != SM_NONE) {
        float ra = 0.f, rb = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) ra += s[i2][c];
#pragma unroll
        for (int c = 4; c < 8; ++c) rb += s[i2][c];
        float rs = ra + rb;
        rs += __shfl_xor_sync(0xffffffffu, rs, 4);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        l[i2] = l[i2] * corr + rs;
      }
      float* pr = Ps + (NI * tr + i2) * TK + 4 * tx;
      st4(pr, s[i2][0], s[i2][1], s[i2][2], s[i2][3]);
      st4(pr + 32, s[i2][4], s[i2][5], s[i2][6], s[i2][7]);
    }
    __syncthreads();  // P is complete
    if constexpr (TMINOR)
      fa_mma_nt(o, Ps, NI * tr, Vs, 4 * tx);
    else
      fa_mma_nn(o, Ps, NI * tr, Vs, tx);
  }
  cp_async_wait<0>();
  if constexpr (MODE == SM_NONE) {
#pragma unroll
    for (int i = 0; i < NI; ++i) l[i] = 1.f;
  }

  // o / l: features 4 tx + j and 32 + 4 tx + j of rows q0 + NI tr + i
  const int r0 = q0 + NI * tr;
  if constexpr (TMINOR) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float* dst = out + head + (long long)(4 * tx + (c & 3) + 32 * (c >> 2)) * Tn + r0;
#pragma unroll
      for (int p = 0; p < NI / 4; ++p) {
        if (vec && r0 + 4 * p + 3 < Tn) {
          st4(dst + 4 * p, o[4 * p][c] / l[4 * p], o[4 * p + 1][c] / l[4 * p + 1], o[4 * p + 2][c] / l[4 * p + 2],
              o[4 * p + 3][c] / l[4 * p + 3]);
        } else {
#pragma unroll
          for (int x = 0; x < 4; ++x)
            if (r0 + 4 * p + x < Tn) dst[4 * p + x] = o[4 * p + x][c] / l[4 * p + x];
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      if (r0 + i >= Tn) continue;
      float* dst = out + head + (long long)(r0 + i) * C + 4 * tx;
      fa_store4(dst, o[i][0] / l[i], o[i][1] / l[i], o[i][2] / l[i], o[i][3] / l[i], vec);
      fa_store4(dst + 32, o[i][4] / l[i], o[i][5] / l[i], o[i][6] / l[i], o[i][7] / l[i], vec);
    }
  }
}

template <bool TMINOR, bool QPRE, bool KTMINOR, int MODE, bool PAD_ZERO, int BQ = ATF_BQ>
void launch_attention_f32(const float* q, const float* k, const float* v, const float* mask, float* out, int B,
                          int Tn, int H, float score_scale, cudaStream_t stream) {
  const auto aligned = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  const int vec = aligned(q) && aligned(k) && aligned(v) && aligned(out) && (!(TMINOR || KTMINOR) || Tn % 4 == 0);
  auto kernel = attention_kernel_f32<TMINOR, BQ, QPRE, KTMINOR, MODE, PAD_ZERO>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, AttF32<BQ>::SMEM);
  dim3 grid((Tn + BQ - 1) / BQ, H, B);
  kernel<<<grid, FA_THREADS, AttF32<BQ>::SMEM, stream>>>(q, k, v, mask, out, Tn, H * HD, score_scale, vec);
}

// ------------------------------------------------------------ bf16: wgmma --
//
// The bf16 kernel: the same function, grid and options as the f32 kernel
// (every row computed: PAD_ZERO is f32's alone), with both products on the
// tensor cores (wgmma.cuh). One warpgroup (128
// threads) per CTA. Shared memory holds bf16 tiles of 64 rows x 64 values in
// the 128-byte swizzle (wgmma.cuh): Q once, K and V double-buffered. A tile's
// rows run along the operand's contiguous axis in device memory (t for
// [B, T, C], the feature for [B, C, T]), so every tile is copied as 128-byte
// rows by cp.async and the layouts are met by wgmma's transpose bits:
//   S = Q K^T   A = Q: K-major for [B, T, C], MN-major for [B, C, T] (TMINOR)
//               B = K: K-major for [B, T, C], MN-major for [B, C, T] (KTMINOR)
//   O += P V    A = P: registers (S's accumulator layout is wgmma's A layout)
//               B = V: MN-major for [B, T, C], K-major for [B, C, T]
// Each product is four m64n64k16 steps over the 64-deep contraction, f32
// accumulate. The softmax runs on S's accumulator fragment: each row lies on
// the 4 threads of a quad, so its max and sum take two shuffles. P is rounded
// to bf16 on its way into the A fragment, and the normaliser sums the
// unrounded f32 weights, the rounding points of the FMA kernel. QPRE scales
// the Q tile in shared memory in f32 and rounds it to bf16 in place.
// Ragged tiles: rows and keys past T are zero-filled by the copy (cp.async's
// src-size, or the scalar loader) and their key bias is -inf. The epilogue
// stages O / l as bf16 in Q's buffer so that the store runs along the
// contiguous axis. Where a 128-byte row is not 16-byte aligned ([B, C, T] with
// T % 8 != 0, or an unaligned pointer) the tiles are copied element by
// element instead.

constexpr int ATT_WG_SMEM = 1024 + 5 * WG_TILE_BYTES;  // 1024-byte alignment slack, Q, K x 2, V x 2

// One operand tile: 64 positions from t0 of (item, head) at `base`; MINOR =
// [B, C, T] (rows are features, t runs along a row), else rows are positions.
template <bool MINOR>
__device__ __forceinline__ void load_operand(uint8_t* tile, const bf16* base, int t0, int Tn, int C, bool vec) {
  if (MINOR) load_tile(tile, base + t0, Tn, ATT_D, min(ATT_BK, Tn - t0), vec);
  else load_tile(tile, base + (long long)t0 * C, C, min(ATT_BK, Tn - t0), ATT_D, vec);
}

template <bool TMINOR, bool QPRE, bool KTMINOR, int MODE>
__global__ void __launch_bounds__(WG_THREADS) attention_kernel_wgmma(const bf16* q, const bf16* k, const bf16* v,
                                                                    const float* mask, bf16* out, int Tn, int C,
                                                                    float score_scale) {
  extern __shared__ uint8_t sm_raw[];
  // every tile 1024-byte aligned: the swizzle XORs absolute address bits
  uint8_t* sm = align_1024(sm_raw);
  uint8_t* Qs = sm;
  // the K and V buffers of key tile j
  const auto Ks = [&](int j) { return sm + (1 + (j & 1)) * WG_TILE_BYTES; };
  const auto Vs = [&](int j) { return sm + (3 + (j & 1)) * WG_TILE_BYTES; };

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ATT_BQ;
  const int tid = threadIdx.x, lane = tid % 32;
  const int cq = 2 * (lane % 4);  // this thread's columns of each 8-wide block of S and O: cq, cq + 1
  const long long item = (long long)b * Tn * C;
  const bf16* qb = q + item + (long long)h * ATT_D * (TMINOR ? Tn : 1);
  const bf16* kb = k + item + (long long)h * ATT_D * (KTMINOR ? Tn : 1);
  const bf16* vb = v + item + (long long)h * ATT_D * (TMINOR ? Tn : 1);
  bf16* ob = out + item + (long long)h * ATT_D * (TMINOR ? Tn : 1);
  // 16-byte chunks need aligned rows: [B, C, T] rows start at multiples of T
  const auto aligned = [&](const void* p, bool minor) { return ((uintptr_t)p & 15) == 0 && (!minor || Tn % 8 == 0); };
  const bool vq = aligned(q, TMINOR), vk = aligned(k, KTMINOR), vv = aligned(v, TMINOR), vo = aligned(out, TMINOR);

  const int nt = (Tn + ATT_BK - 1) / ATT_BK;
  auto issue = [&](int j, bool with_v) {
    load_operand<KTMINOR>(Ks(j), kb, j * ATT_BK, Tn, C, vk);
    if (with_v) load_operand<TMINOR>(Vs(j), vb, j * ATT_BK, Tn, C, vv);
  };
  // tile j's copies have landed (the next tile's stay in flight) and every
  // thread's shared-memory writes (the element copies, QPRE's scaling) are
  // visible to wgmma's async proxy: a missing fence.proxy.async here would let
  // wgmma read stale shared memory
  auto arrive = [&]() {
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
  };

  load_operand<TMINOR>(Qs, qb, q0, Tn, C, vq);
  cp_async_commit();
  issue(0, MODE != SM_SCORE_LOWP);
  cp_async_commit();
  cp_async_wait<1>();  // Q
  if constexpr (QPRE) {
    __syncthreads();
    for (int e = tid; e < ATT_BQ * ATT_D; e += WG_THREADS)
      st_tile(Qs, e >> 6, e & 63, __fmul_rn(ld_tile(Qs, e >> 6, e & 63), kLog2e / sqrtf((float)ATT_D)));
  }
  const uint64_t dq = make_desc<TMINOR>(smem_addr(Qs));

  // S = Q K_j^T, four 16-deep steps over the features; wgmma.fence first,
  // since the softmax wrote S's registers after the last product
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  auto qk = [&](int j) {
    const uint64_t dk = make_desc<KTMINOR>(smem_addr(Ks(j)));
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16_ss<TMINOR, KTMINOR>(s, desc_k<TMINOR>(dq, kk), desc_k<KTMINOR>(dk, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
  };
  // key bias of this thread's 16 columns of tile j: 0, kNeg (padded) or -inf (past T)
  float kbias[16];
  auto key_bias = [&](int j) {
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int t = j * ATT_BK + 8 * (c / 2) + cq + c % 2;
      kbias[c] = t < Tn ? ((mask == nullptr || mask[(long long)b * Tn + t] > 0.f) ? 0.f : kNeg) : -INFINITY;
    }
  };

  // m, l: this thread's rows r0 and r0 + 8; l sums this thread's columns
  // (the quad's sum is taken at the end: every rescale is common to the quad)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  if constexpr (MODE == SM_SCORE_LOWP) {
    // each row's max of the bf16 scores over every key tile first
    for (int j = 0; j < nt; ++j) {
      if (j + 1 < nt) issue(j + 1, false);
      cp_async_commit();
      arrive();
      key_bias(j);
      qk(j);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = -INFINITY;
#pragma unroll
        for (int c = 0; c < 16; ++c)
          mx = fmaxf(mx, round_to<bf16>(round_to<bf16>(s[4 * (c / 2) + 2 * hh + c % 2] * score_scale) +
                                        round_to<bf16>(kbias[c])));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        m[hh] = fmaxf(m[hh], mx);
      }
      __syncthreads();  // K_j's buffer is free for tile j + 2
    }
    issue(0, true);
    cp_async_commit();
  }

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  for (int j = 0; j < nt; ++j) {
    if (j + 1 < nt) issue(j + 1, true);
    cp_async_commit();
    arrive();
    if constexpr (MODE != SM_NONE) key_bias(j);
    qk(j);

    // s[4 * (c / 2) + 2 * hh + c % 2]: row r0 + 8 hh, column 8 (c / 2) + cq + c % 2
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float rs = 0.f;
      if constexpr (MODE == SM_ONLINE) {
        float mx = -INFINITY;
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          float& x = s[4 * (c / 2) + 2 * hh + c % 2];
          x = x * score_scale + kbias[c];
          mx = fmaxf(mx, x);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hh], mx);
        const float corr = exp2f(m[hh] - m_new);  // 0 on the first tile (m = -inf)
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          float& x = s[4 * (c / 2) + 2 * hh + c % 2];
          x = exp2f(x - m_new);
          rs += x;
          o[4 * (c / 2) + 2 * hh + c % 2] *= corr;
        }
        l[hh] = l[hh] * corr + rs;
        m[hh] = m_new;
      } else {
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          float& x = s[4 * (c / 2) + 2 * hh + c % 2];
          if constexpr (MODE == SM_NOMAX) {
            x = exp2f(x * score_scale + kbias[c]);
          } else if constexpr (MODE == SM_SCORE_LOWP) {
            const float sv = round_to<bf16>(round_to<bf16>(x * score_scale) + round_to<bf16>(kbias[c]));
            x = round_to<bf16>(exp2f(sv - m[hh]));
          } else {
            x = x * score_scale;  // SM_NONE: the product alone
          }
          rs += x;
        }
        l[hh] += rs;
      }
    }

    // O += P V_j: P rounded to bf16 as the A fragment of each 16-key step;
    // wgmma.fence first, since the rescale and the packing wrote O's and P's
    // registers
    const uint64_t dv = make_desc<!TMINOR>(smem_addr(Vs(j)));
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_rs<!TMINOR>(o, pa[kk], desc_k<!TMINOR>(dv, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    __syncthreads();  // K_j and V_j's buffers are free for tile j + 2
  }

  // O / l, rounded to bf16, staged in Q's buffer (no wgmma reads it any
  // more) in the output's layout, then stored along the contiguous axis
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float inv = 1.f;
    if constexpr (MODE != SM_NONE) {
      float lt = l[hh] + __shfl_xor_sync(0xffffffffu, l[hh], 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      inv = 1.f / lt;
    }
    const int r = 16 * (tid / 32) + lane / 4 + 8 * hh;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int c = 8 * jj + cq;
      const float x0 = o[4 * jj + 2 * hh] * inv, x1 = o[4 * jj + 2 * hh + 1] * inv;
      if (TMINOR) {
        st_tile(Qs, c, r, x0);
        st_tile(Qs, c + 1, r, x1);
      } else {
        *reinterpret_cast<uint32_t*>(Qs + swz(r, c)) = pack_bf16(x0, x1);
      }
    }
  }
  __syncthreads();
  if (TMINOR) store_tile(Qs, ob + q0, Tn, ATT_D, min(ATT_BQ, Tn - q0), vo);
  else store_tile(Qs, ob + (long long)q0 * C, C, min(ATT_BQ, Tn - q0), ATT_D, vo);
}

// q/k/v/out [B, T, H*64] (or [B, H*64, T] with TMINOR; K alone per KTMINOR);
// mask [B, T] f32 or nullptr (every key valid). bf16 runs
// attention_kernel_wgmma, f32 attention_kernel_f32 (fp32 FMA: the f32 bars
// hold no TF32 form), under every option.
template <typename T, bool TMINOR, bool QPRE = false, bool KTMINOR = TMINOR, int MODE = SM_ONLINE, bool PAD_ZERO = true>
void launch_attention(const T* q, const T* k, const T* v, const float* mask, T* out, int B, int Tn, int H,
                      float score_scale, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    auto kernel = attention_kernel_wgmma<TMINOR, QPRE, KTMINOR, MODE>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ATT_WG_SMEM);
    dim3 grid((Tn + ATT_BQ - 1) / ATT_BQ, H, B);
    kernel<<<grid, WG_THREADS, ATT_WG_SMEM, stream>>>(q, k, v, mask, out, Tn, H * ATT_D, score_scale);
  } else {
    launch_attention_f32<TMINOR, QPRE, KTMINOR, MODE, PAD_ZERO>(q, k, v, mask, out, B, Tn, H, score_scale, stream);
  }
}

}  // namespace stts
