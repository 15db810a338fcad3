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
#pragma once

#include "common.cuh"

#include <math.h>

namespace stts {

constexpr float kNeg = -0.7f * 3.402823466e38f;  // key bias of padded keys
constexpr float kLog2e = 1.4426950408889634f;

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

template <typename T, bool TMINOR>
__global__ void __launch_bounds__(256) attention_kernel(const T* q, const T* k, const T* v,
                                                        const float* mask, T* out, int Tn, int C,
                                                        float score_scale) {
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

  for (int e = tid; e < ATT_BQ * ATT_D; e += 256) {
    int r, d;
    tile_index<TMINOR>(e, r, d);
    int t = q0 + r;
    Qt[d * ATT_LD + r] = t < Tn ? to_f(q[base + t * st + d * sd]) : 0.f;
  }

  float m_i[4], l_i[4], o[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < Tn; k0 += ATT_BK) {
    __syncthreads();  // the previous tile's Kt/Vs/Pt are consumed
    for (int e = tid; e < ATT_BK * ATT_D; e += 256) {
      int r, d;
      tile_index<TMINOR>(e, r, d);
      int t = k0 + r;
      bool ok = t < Tn;
      Kt[d * ATT_LD + r] = ok ? to_f(k[base + t * st + d * sd]) : 0.f;
      Vs[r * ATT_LD + d] = ok ? to_f(v[base + t * st + d * sd]) : 0.f;
    }
    if (tid < ATT_BK) {
      int t = k0 + tid;
      float bias = -INFINITY;
      if (t < Tn) bias = (mask == nullptr || mask[(long long)b * Tn + t] > 0.f) ? 0.f : kNeg;
      kb[tid] = bias;
    }
    __syncthreads();

    float s[4][4];
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

// q/k/v/out [B, T, H*64] (or [B, H*64, T] with TMINOR); mask [B, T] f32 or
// nullptr (every key valid).
template <typename T, bool TMINOR>
void launch_attention(const T* q, const T* k, const T* v, const float* mask, T* out, int B, int Tn, int H,
                      float score_scale, cudaStream_t stream) {
  cudaFuncSetAttribute(attention_kernel<T, TMINOR>, cudaFuncAttributeMaxDynamicSharedMemorySize, ATT_SMEM);
  dim3 grid((Tn + ATT_BQ - 1) / ATT_BQ, H, B);
  attention_kernel<T, TMINOR><<<grid, 256, ATT_SMEM, stream>>>(q, k, v, mask, out, Tn, H * ATT_D, score_scale);
}

}  // namespace stts
