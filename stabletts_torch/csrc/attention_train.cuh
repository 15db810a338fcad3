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
// counter (key/4, q, b*H + h, 0) under the call's key is >= thresh, so the
// backward regenerates the forward's mask. All products are fp32 FMA.
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

#include <math.h>

namespace stts {
namespace atr {

constexpr float kNeg = -0.7f * 3.402823466e38f;  // key bias of padded keys
constexpr int HD = 64, TQ = 64, TK = 64, LD = 68, NT = 256;
constexpr int TILE = HD * LD;  // floats of one [64][LD] shared tile
constexpr int FWD_SMEM = (4 * TILE + TK) * (int)sizeof(float);
constexpr int DKV_SMEM = (8 * TILE + 3 * TQ) * (int)sizeof(float);
constexpr int DQ_SMEM = (6 * TILE + TK) * (int)sizeof(float);

// [64 rows][64 dims] of a head from a [B*T, ld] tensor: into s[r * LD + d]
// (row-major) and/or st[d * LD + r] (transposed); rows past Tn are zero.
template <typename T>
__device__ void load_tile(const T* src, long long ld, int row0, int Tn, float* s, float* st) {
  for (int e = threadIdx.x; e < 64 * HD; e += NT) {
    int r = e / HD, d = e % HD;
    float v = row0 + r < Tn ? to_f(src[(long long)(row0 + r) * ld + d]) : 0.f;
    if (s) s[r * LD + d] = v;
    if (st) st[d * LD + r] = v;
  }
}

__device__ __forceinline__ void load_kbias(const float* mask_b, int k0, int Tn, float* kb) {
  if (threadIdx.x < TK) {
    int t = k0 + threadIdx.x;
    kb[threadIdx.x] = t < Tn ? (mask_b[t] > 0.f ? 0.f : kNeg) : -INFINITY;
  }
}

// acc[i][j] += sum_d a[d * LD + row_a + i] * b[d * LD + row_b + j]
__device__ __forceinline__ void mma_tile(float (&acc)[4][4], const float* a, const float* b, int ra, int rb) {
#pragma unroll 8
  for (int d = 0; d < 64; ++d) {
    float4 a4 = *reinterpret_cast<const float4*>(&a[d * LD + ra]);
    float4 b4 = *reinterpret_cast<const float4*>(&b[d * LD + rb]);
    float av[4] = {a4.x, a4.y, a4.z, a4.w};
    float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
}

// ---- forward attention: one CTA per (64-query tile, head, item) -----------
// thread (ty, tx) owns queries ty*4..+3 and keys (pass 2: dims) tx*4..+3
template <typename T>
__global__ void __launch_bounds__(NT) attn_fwd_kernel(const T* q, const T* k, const T* v, const float* mask,
                                                      T* att, T* att_lo, float* lse, int Tn, int C, int H,
                                                      float sm_scale, Dropout drop) {
  extern __shared__ __align__(16) float sm[];
  float* Qt = sm;           // [d][q]
  float* Kt = Qt + TILE;    // [d][key]
  float* Vs = Kt + TILE;    // [key][d]
  float* Pt = Vs + TILE;    // [key][q]
  float* kb = Pt + TILE;    // [key]
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * TQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long base = (long long)b * Tn * C + h * HD;
  const float* mask_b = mask + (long long)b * Tn;
  const uint32_t bh = b * H + h;

  load_tile(q + base, C, q0, Tn, nullptr, Qt);

  // pass 1: row max and sum -> log-sum-exp
  float m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m_i[i] = -INFINITY, l_i[i] = 0.f;
  for (int k0 = 0; k0 < Tn; k0 += TK) {
    __syncthreads();
    load_tile(k + base, C, k0, Tn, nullptr, Kt);
    load_kbias(mask_b, k0, Tn, kb);
    __syncthreads();
    float s[4][4];
    zero(s);
    mma_tile(s, Qt, Kt, ty * 4, tx * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = s[i][j] * sm_scale + kb[tx * 4 + j];
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float m_new = fmaxf(m_i[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) rs += expf(s[i][j] - m_new);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[i] = l_i[i] * expf(m_i[i] - m_new) + rs;
      m_i[i] = m_new;
    }
  }
  float lse_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse_i[i] = m_i[i] + logf(l_i[i]);
    int t = q0 + ty * 4 + i;
    if (tx == 0 && t < Tn) lse[(long long)bh * Tn + t] = lse_i[i];
  }

  // pass 2: normalised, dropped, rounded weights times v
  float o[4][4];
  zero(o);
  for (int k0 = 0; k0 < Tn; k0 += TK) {
    __syncthreads();
    load_tile(k + base, C, k0, Tn, nullptr, Kt);
    load_tile(v + base, C, k0, Tn, Vs, nullptr);
    load_kbias(mask_b, k0, Tn, kb);
    __syncthreads();
    float s[4][4];
    zero(s);
    mma_tile(s, Qt, Kt, ty * 4, tx * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint4 w;
      if (drop.seed) w = drop.bits((k0 + tx * 4) >> 2, q0 + ty * 4 + i, bh, 0u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = expf(s[i][j] * sm_scale + kb[tx * 4 + j] - lse_i[i]);
        if (drop.seed) p *= drop.factor(w, j);
        Pt[(tx * 4 + j) * LD + ty * 4 + i] = round_to<T>(p);
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < TK; ++kk) {
      float4 a4 = *reinterpret_cast<const float4*>(&Pt[kk * LD + ty * 4]);
      float4 b4 = *reinterpret_cast<const float4*>(&Vs[kk * LD + tx * 4]);
      float a[4] = {a4.x, a4.y, a4.z, a4.w};
      float bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][j] = fmaf(a[i], bb[j], o[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int t = q0 + ty * 4 + i;
    if (t >= Tn) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      long long e = base + (long long)t * C + tx * 4 + j;
      att[e] = from_f<T>(o[i][j]);
      if (att_lo) att_lo[e] = from_f<T>(o[i][j] - round_to<T>(o[i][j]));
    }
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

// ---- backward dK, dV: one CTA per (64-key tile, head, item) ---------------
// S-phase thread (ty, tx): keys ty*4..+3, queries tx*4..+3;
// accumulation: keys ty*4..+3, dims tx*4..+3.
template <typename T>
__global__ void __launch_bounds__(NT) attn_bwd_dkv_kernel(const T* q, const T* k, const T* v, const T* datt,
                                                          const float* lse, const float* Dv, const float* mask,
                                                          T* dk, T* dv, int ld_dv, int Tn, int C, int H,
                                                          float sm_scale, Dropout drop) {
  extern __shared__ __align__(16) float sm[];
  float* Kt = sm;            // [d][key]
  float* Vt = Kt + TILE;     // [d][key]
  float* Qt = Vt + TILE;     // [d][q]
  float* Qs = Qt + TILE;     // [q][d]
  float* dOt = Qs + TILE;    // [d][q]
  float* dOs = dOt + TILE;   // [q][d]
  float* Pq = dOs + TILE;    // [q][key] dropped weights
  float* Sq = Pq + TILE;     // [q][key] ds
  float* kb = Sq + TILE;     // [key]
  float* lse_s = kb + TK;    // [q]
  float* D_s = lse_s + TQ;   // [q]
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * TK;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long base = (long long)b * Tn * C + h * HD;
  const uint32_t bh = b * H + h;

  load_tile(k + base, C, k0, Tn, nullptr, Kt);
  load_tile(v + base, C, k0, Tn, nullptr, Vt);
  load_kbias(mask + (long long)b * Tn, k0, Tn, kb);

  float dK[4][4], dV[4][4];
  zero(dK);
  zero(dV);
  for (int q0 = 0; q0 < Tn; q0 += TQ) {
    __syncthreads();
    load_tile(q + base, C, q0, Tn, Qs, Qt);
    load_tile(datt + base, C, q0, Tn, dOs, dOt);
    if (tid < TQ) {
      int t = q0 + tid;
      lse_s[tid] = t < Tn ? lse[(long long)bh * Tn + t] : INFINITY;  // p = 0 past Tn
      D_s[tid] = t < Tn ? Dv[(long long)bh * Tn + t] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    mma_tile(s, Kt, Qt, ty * 4, tx * 4);
    mma_tile(dp, Vt, dOt, ty * 4, tx * 4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int qj = tx * 4 + j;
      uint4 w;
      if (drop.seed) w = drop.bits((k0 + ty * 4) >> 2, q0 + qj, bh, 0u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = expf(s[i][j] * sm_scale + kb[ty * 4 + i] - lse_s[qj]);
        float f = drop.seed ? drop.factor(w, i) : 1.f;
        Pq[qj * LD + ty * 4 + i] = round_to<T>(p * f);
        Sq[qj * LD + ty * 4 + i] = round_to<T>(p * (dp[i][j] * f - D_s[qj]));
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int qq = 0; qq < TQ; ++qq) {
      float4 p4 = *reinterpret_cast<const float4*>(&Pq[qq * LD + ty * 4]);
      float4 s4 = *reinterpret_cast<const float4*>(&Sq[qq * LD + ty * 4]);
      float4 o4 = *reinterpret_cast<const float4*>(&dOs[qq * LD + tx * 4]);
      float4 q4 = *reinterpret_cast<const float4*>(&Qs[qq * LD + tx * 4]);
      float pv[4] = {p4.x, p4.y, p4.z, p4.w}, sv[4] = {s4.x, s4.y, s4.z, s4.w};
      float ov[4] = {o4.x, o4.y, o4.z, o4.w}, qv[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dV[i][j] = fmaf(pv[i], ov[j], dV[i][j]);
          dK[i][j] = fmaf(sv[i], qv[j], dK[i][j]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int t = k0 + ty * 4 + i;
    if (t >= Tn) continue;
    long long row = (long long)b * Tn + t;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int c = h * HD + tx * 4 + j;
      dk[row * C + c] = from_f<T>(dK[i][j] * sm_scale);
      dv[row * ld_dv + c] = from_f<T>(dV[i][j]);
    }
  }
}

// ---- backward dQ: one CTA per (64-query tile, head, item) -----------------
// S-phase thread (ty, tx): queries ty*4..+3, keys tx*4..+3;
// accumulation: queries ty*4..+3, dims tx*4..+3.
template <typename T>
__global__ void __launch_bounds__(NT) attn_bwd_dq_kernel(const T* q, const T* k, const T* v, const T* datt,
                                                         const float* lse, const float* Dv, const float* mask,
                                                         T* dq_r, int Tn, int C, int H, float sm_scale,
                                                         Dropout drop) {
  extern __shared__ __align__(16) float sm[];
  float* Qt = sm;            // [d][q]
  float* dOt = Qt + TILE;    // [d][q]
  float* Kt = dOt + TILE;    // [d][key]
  float* Ks = Kt + TILE;     // [key][d]
  float* Vt = Ks + TILE;     // [d][key]
  float* St = Vt + TILE;     // [key][q] ds
  float* kb = St + TILE;     // [key]
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * TQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long base = (long long)b * Tn * C + h * HD;
  const uint32_t bh = b * H + h;
  const float* mask_b = mask + (long long)b * Tn;

  load_tile(q + base, C, q0, Tn, nullptr, Qt);
  load_tile(datt + base, C, q0, Tn, nullptr, dOt);
  float lse_i[4], d_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int t = q0 + ty * 4 + i;
    lse_i[i] = t < Tn ? lse[(long long)bh * Tn + t] : INFINITY;
    d_i[i] = t < Tn ? Dv[(long long)bh * Tn + t] : 0.f;
  }

  float dQ[4][4];
  zero(dQ);
  for (int k0 = 0; k0 < Tn; k0 += TK) {
    __syncthreads();
    load_tile(k + base, C, k0, Tn, Ks, Kt);
    load_tile(v + base, C, k0, Tn, nullptr, Vt);
    load_kbias(mask_b, k0, Tn, kb);
    __syncthreads();
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    mma_tile(s, Qt, Kt, ty * 4, tx * 4);
    mma_tile(dp, dOt, Vt, ty * 4, tx * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint4 w;
      if (drop.seed) w = drop.bits((k0 + tx * 4) >> 2, q0 + ty * 4 + i, bh, 0u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = expf(s[i][j] * sm_scale + kb[tx * 4 + j] - lse_i[i]);
        float f = drop.seed ? drop.factor(w, j) : 1.f;
        St[(tx * 4 + j) * LD + ty * 4 + i] = round_to<T>(p * (dp[i][j] * f - d_i[i]));
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < TK; ++kk) {
      float4 a4 = *reinterpret_cast<const float4*>(&St[kk * LD + ty * 4]);
      float4 b4 = *reinterpret_cast<const float4*>(&Ks[kk * LD + tx * 4]);
      float a[4] = {a4.x, a4.y, a4.z, a4.w};
      float bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dQ[i][j] = fmaf(a[i], bb[j], dQ[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int t = q0 + ty * 4 + i;
    if (t >= Tn) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dq_r[((long long)b * Tn + t) * C + h * HD + tx * 4 + j] = from_f<T>(dQ[i][j] * sm_scale);
  }
}

template <typename T>
void launch_attn_fwd(const T* q, const T* k, const T* v, const float* mask, T* att, T* att_lo, float* lse, int B,
                     int Tn, int C, int H, float sm_scale, Dropout drop, cudaStream_t s) {
  cudaFuncSetAttribute(attn_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM);
  attn_fwd_kernel<T><<<dim3((Tn + TQ - 1) / TQ, H, B), NT, FWD_SMEM, s>>>(q, k, v, mask, att, att_lo, lse, Tn, C,
                                                                         H, sm_scale, drop);
}

// D = rowsum(datt * (att + att_lo)) (att_lo may be null), then dK (scaled) ->
// dk [M, C], dV -> dv (row stride ld_dv), dQ (scaled) -> dq [M, C]
template <typename T>
void launch_attn_bwd(const T* q, const T* k, const T* v, const T* att, const T* att_lo, const T* datt,
                     const float* lse, const float* mask, float* Dv, T* dq, T* dk, T* dv, int ld_dv, int B, int Tn,
                     int C, int H, float sm_scale, Dropout drop, cudaStream_t s) {
  const int n_rows = B * H * Tn;
  rowdot_kernel<T><<<(n_rows + 7) / 8, 256, 0, s>>>(datt, att, att_lo, Dv, Tn, C, H, n_rows);
  cudaFuncSetAttribute(attn_bwd_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, DKV_SMEM);
  attn_bwd_dkv_kernel<T><<<dim3((Tn + TK - 1) / TK, H, B), NT, DKV_SMEM, s>>>(
      q, k, v, datt, lse, Dv, mask, dk, dv, ld_dv, Tn, C, H, sm_scale, drop);
  cudaFuncSetAttribute(attn_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM);
  attn_bwd_dq_kernel<T><<<dim3((Tn + TQ - 1) / TQ, H, B), NT, DQ_SMEM, s>>>(
      q, k, v, datt, lse, Dv, mask, dq, Tn, C, H, sm_scale, drop);
}

}  // namespace atr
}  // namespace stts
