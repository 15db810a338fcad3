// Packed-head attention for head width 64, shared by the whole DiT block, its
// attention half and the packed-attention kernels (both layouts).
//
// One CTA per (64-query tile, head, batch item). Online softmax in exp2 over
// 64-key tiles, so no score tile larger than 64 x 64 exists and any T works
// (ragged tiles are masked). scores = (q . k) * score_scale + key bias, in
// log2 units: a caller whose q already carries log2(e)/sqrt(D) passes 1, a
// caller with unscaled q passes log2(e)/sqrt(D). The key bias is 0 for a valid
// key and kNeg (finite) for a padded one, so a row whose keys are all padded
// still gets a finite softmax; keys past T are excluded. Only keys are masked:
// padded query rows come out as finite values the caller masks. The weights
// are rounded to T before the PV product; the normaliser sums the unrounded
// f32 weights.
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
//   ROPE     the q tile (after QPRE) and every K tile are rotated on load by
//            partial RoPE from [T, C] cos/sin tables in T, rounded op by op as
//            round(round(x*cos) + round(neg_half(x)*sin)) ([B, T, C] only).
//   KTMINOR  the layout of K alone (q, v and out keep TMINOR's).
//   MODE     the softmax: SM_ONLINE as above; SM_NOMAX w = exp2(s + bias)
//            with no max and no rescale (it overflows where exp2 does);
//            SM_SCORE_LOWP scores and bias rounded to bf16 whatever T is, the
//            row max m taken in a first pass over the key tiles, then
//            w = round_bf16(exp2(s - m)) (s - m in f32, as XLA computes the
//            TPU body's bf16 difference) and the normaliser the f32 sum of
//            those rounded weights; SM_NONE the product alone,
//            out = round_T(s) v with no bias and no normaliser.
#pragma once

#include "common.cuh"

#include <math.h>

namespace stts {

constexpr float kNeg = -0.7f * 3.402823466e38f;  // key bias of padded keys
constexpr float kLog2e = 1.4426950408889634f;

enum { SM_ONLINE = 0, SM_NOMAX = 1, SM_SCORE_LOWP = 2, SM_NONE = 3 };

constexpr int ATT_D = 64, ATT_BQ = 64, ATT_BK = 64, ATT_LD = 68;
constexpr int ATT_SMEM = (4 * ATT_D * ATT_LD + ATT_BK) * (int)sizeof(float);

// element e of a 64 x 64 (row r, feature d) tile load: the index that varies
// fastest across threads is the one contiguous in memory
template <bool TMINOR>
__device__ __forceinline__ void tile_index(int e, int& r, int& d) {
  if (TMINOR) {
    r = e % ATT_BQ;
    d = e / ATT_BQ;
  } else {
    r = e / ATT_D;
    d = e % ATT_D;
  }
}

// rotate the [B, T, C] tile X[d][row] (rows t0 + row, head h) in place:
// x*cos + neg_half(x)*sin with neg_half(x)[d] = -x[d + rot/2] for d < rot/2,
// x[d - rot/2] for d < rot, else 0; every product and the sum rounded through
// T and never contracted into an FMA. `scratch` is a free [D][LD] tile. The
// tile must be complete (caller syncs before); the rotated tile is complete
// after the caller's next sync.
template <typename T>
__device__ __forceinline__ void rope_tile(float* X, float* scratch, int t0, int Tn, int C, int h, const T* cosv,
                                          const T* sinv, int rot) {
  const int half = rot / 2;
#pragma unroll 1
  for (int e = threadIdx.x; e < ATT_BQ * ATT_D; e += 256) {
    const int r = e / ATT_D, d = e % ATT_D, t = t0 + r;
    const float x = X[d * ATT_LD + r];
    float xp = 0.f;
    if (d < half) xp = -X[(d + half) * ATT_LD + r];
    else if (d < rot) xp = X[(d - half) * ATT_LD + r];
    float y = x;
    if (t < Tn) {
      const long long o = (long long)t * C + h * ATT_D + d;
      const float a = round_to<T>(__fmul_rn(x, to_f(cosv[o])));
      const float b = round_to<T>(__fmul_rn(xp, to_f(sinv[o])));
      y = round_to<T>(__fadd_rn(a, b));
    }
    scratch[d * ATT_LD + r] = y;
  }
  __syncthreads();
#pragma unroll 1
  for (int e = threadIdx.x; e < ATT_BQ * ATT_D; e += 256) {
    const int i = (e % ATT_D) * ATT_LD + e / ATT_D;
    X[i] = scratch[i];
  }
}

template <typename T, bool TMINOR, bool QPRE = false, bool ROPE = false, bool KTMINOR = TMINOR, int MODE = SM_ONLINE>
__global__ void __launch_bounds__(256) attention_kernel(const T* q, const T* k, const T* v,
                                                        const float* mask, T* out, int Tn, int C,
                                                        float score_scale, const T* rope_cos,
                                                        const T* rope_sin, int rot) {
  static_assert(!(ROPE && (TMINOR || KTMINOR)), "RoPE on load takes [B, T, C] operands");
  extern __shared__ __align__(16) float sm[];
  float* Qt = sm;                   // [D][LD]   Qt[d][query]
  float* Kt = Qt + ATT_D * ATT_LD;  // [D][LD]   Kt[d][key]
  float* Vs = Kt + ATT_D * ATT_LD;  // [BK][LD]  Vs[key][d]
  float* Pt = Vs + ATT_BK * ATT_LD; // [BK][LD]  Pt[key][query]
  float* kb = Pt + ATT_BK * ATT_LD; // [BK]      key bias

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ATT_BQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long st = TMINOR ? 1 : C, sd = TMINOR ? Tn : 1;  // strides of t and of the feature
  const long long base = (long long)b * Tn * C + (long long)h * ATT_D * sd;
  const long long kst = KTMINOR ? 1 : C, ksd = KTMINOR ? Tn : 1;  // K's strides
  const long long kbase = (long long)b * Tn * C + (long long)h * ATT_D * ksd;

  for (int e = tid; e < ATT_BQ * ATT_D; e += 256) {
    int r, d;
    tile_index<TMINOR>(e, r, d);
    int t = q0 + r;
    if constexpr (QPRE) {
      const float x = t < Tn ? to_f(q[base + t * st + d * sd]) : 0.f;
      Qt[d * ATT_LD + r] = round_to<T>(__fmul_rn(x, kLog2e / sqrtf((float)ATT_D)));
    } else {
      Qt[d * ATT_LD + r] = t < Tn ? to_f(q[base + t * st + d * sd]) : 0.f;
    }
  }
  if constexpr (ROPE) {
    __syncthreads();
    rope_tile<T>(Qt, Pt, q0, Tn, C, h, rope_cos, rope_sin, rot);  // Pt is free until the first softmax
  }

  float m_i[4], l_i[4], o[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
  }

  // K (and V) tile k0 into Kt (and Vs), key bias into kb; RoPE on K
  auto load_kv = [&](int k0, bool with_v) {
    if constexpr (KTMINOR == TMINOR) {
      for (int e = tid; e < ATT_BK * ATT_D; e += 256) {
        int r, d;
        tile_index<TMINOR>(e, r, d);
        int t = k0 + r;
        bool ok = t < Tn;
        Kt[d * ATT_LD + r] = ok ? to_f(k[base + t * st + d * sd]) : 0.f;
        if (with_v) Vs[r * ATT_LD + d] = ok ? to_f(v[base + t * st + d * sd]) : 0.f;
      }
    } else {
      for (int e = tid; e < ATT_BK * ATT_D; e += 256) {
        int r, d;
        tile_index<KTMINOR>(e, r, d);
        int t = k0 + r;
        Kt[d * ATT_LD + r] = t < Tn ? to_f(k[kbase + t * kst + d * ksd]) : 0.f;
      }
      for (int e = tid; with_v && e < ATT_BK * ATT_D; e += 256) {
        int r, d;
        tile_index<TMINOR>(e, r, d);
        int t = k0 + r;
        Vs[r * ATT_LD + d] = t < Tn ? to_f(v[base + t * st + d * sd]) : 0.f;
      }
    }
    if (tid < ATT_BK) {
      int t = k0 + tid;
      float bias = -INFINITY;
      if (t < Tn) bias = (mask == nullptr || mask[(long long)b * Tn + t] > 0.f) ? 0.f : kNeg;
      kb[tid] = bias;
    }
    if constexpr (ROPE) {
      __syncthreads();
      rope_tile<T>(Kt, Pt, k0, Tn, C, h, rope_cos, rope_sin, rot);  // the last PV product is done
    }
  };

  // s = Q K^T of the current tiles
  auto scores = [&](float (&s)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < ATT_D; ++d) {
      float4 a4 = *reinterpret_cast<const float4*>(&Qt[d * ATT_LD + ty * 4]);
      float4 b4 = *reinterpret_cast<const float4*>(&Kt[d * ATT_LD + tx * 4]);
      float a[4] = {a4.x, a4.y, a4.z, a4.w};
      float bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
    }
  };

  // SM_SCORE_LOWP: each row's max of the bf16 scores, over every key tile
  if constexpr (MODE == SM_SCORE_LOWP) {
    for (int k0 = 0; k0 < Tn; k0 += ATT_BK) {
      __syncthreads();
      load_kv(k0, false);
      __syncthreads();
      float s[4][4];
      scores(s);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mx = fmaxf(mx, round_to<bf16>(round_to<bf16>(s[i][j] * score_scale) + round_to<bf16>(kb[tx * 4 + j])));
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        m_i[i] = fmaxf(m_i[i], mx);
      }
    }
  }

  for (int k0 = 0; k0 < Tn; k0 += ATT_BK) {
    __syncthreads();  // the previous tile's Kt/Vs/Pt are consumed
    load_kv(k0, true);
    __syncthreads();

    float s[4][4];
    scores(s);

    if constexpr (MODE == SM_NOMAX) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float p = exp2f(s[i][j] * score_scale + kb[tx * 4 + j]);
          rs += p;
          Pt[(tx * 4 + j) * ATT_LD + ty * 4 + i] = round_to<T>(p);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
        l_i[i] += rs;
      }
    } else if constexpr (MODE == SM_SCORE_LOWP) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float sv = round_to<bf16>(round_to<bf16>(s[i][j] * score_scale) + round_to<bf16>(kb[tx * 4 + j]));
          float p = round_to<bf16>(exp2f(sv - m_i[i]));
          rs += p;
          Pt[(tx * 4 + j) * ATT_LD + ty * 4 + i] = round_to<T>(p);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
        l_i[i] += rs;
      }
    } else if constexpr (MODE == SM_NONE) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) Pt[(tx * 4 + j) * ATT_LD + ty * 4 + i] = round_to<T>(s[i][j] * score_scale);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = s[i][j] * score_scale + kb[tx * 4 + j];
          mx = fmaxf(mx, s[i][j]);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        float m_new = fmaxf(m_i[i], mx);
        float corr = exp2f(m_i[i] - m_new);  // 0 on the first tile (m_i = -inf)
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float p = exp2f(s[i][j] - m_new);
          rs += p;
          Pt[(tx * 4 + j) * ATT_LD + ty * 4 + i] = round_to<T>(p);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
        l_i[i] = l_i[i] * corr + rs;
        m_i[i] = m_new;
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][j] *= corr;
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < ATT_BK; ++kk) {
      float4 a4 = *reinterpret_cast<const float4*>(&Pt[kk * ATT_LD + ty * 4]);
      float4 b4 = *reinterpret_cast<const float4*>(&Vs[kk * ATT_LD + tx * 4]);
      float a[4] = {a4.x, a4.y, a4.z, a4.w};
      float bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][j] = fmaf(a[i], bb[j], o[i][j]);
    }
  }

  if constexpr (MODE == SM_NONE) {
#pragma unroll
    for (int i = 0; i < 4; ++i) l_i[i] = 1.f;
  }
  if (TMINOR) {
    // stage the tile as Pt[d][query] so that the store runs along t
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Pt[(tx * 4 + j) * ATT_LD + ty * 4 + i] = o[i][j] / l_i[i];
    __syncthreads();
    for (int e = tid; e < ATT_BQ * ATT_D; e += 256) {
      int r = e % ATT_BQ, d = e / ATT_BQ;
      int t = q0 + r;
      if (t < Tn) out[base + t * st + d * sd] = from_f<T>(Pt[d * ATT_LD + r]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int t = q0 + ty * 4 + i;
      if (t >= Tn) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[base + (long long)t * C + tx * 4 + j] = from_f<T>(o[i][j] / l_i[i]);
    }
  }
}

// q/k/v/out [B, T, H*64] (or [B, H*64, T] with TMINOR; K alone per KTMINOR);
// mask [B, T] f32 or nullptr (every key valid); rope_cos/rope_sin [T, H*64]
// in T with ROPE, else unread.
template <typename T, bool TMINOR, bool QPRE = false, bool ROPE = false, bool KTMINOR = TMINOR, int MODE = SM_ONLINE>
void launch_attention(const T* q, const T* k, const T* v, const float* mask, T* out, int B, int Tn, int H,
                      float score_scale, cudaStream_t stream, const T* rope_cos = nullptr,
                      const T* rope_sin = nullptr, int rot = 0) {
  auto kernel = attention_kernel<T, TMINOR, QPRE, ROPE, KTMINOR, MODE>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ATT_SMEM);
  dim3 grid((Tn + ATT_BQ - 1) / ATT_BQ, H, B);
  kernel<<<grid, 256, ATT_SMEM, stream>>>(q, k, v, mask, out, Tn, H * ATT_D, score_scale, rope_cos, rope_sin, rot);
}

}  // namespace stts
