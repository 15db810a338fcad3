// The DiT block's attention half for training on Hopper (sm_90a), forward and
// backward:
//
//   h       = LN(x) * (1 + scale) + shift                      (LN: no affine)
//   q, k, v = h Wq + bq, h Wk + bk, h Wv + bv;  qr, kr = rope(q), rope(k)
//   att     = drop(softmax(qr kr^T / sqrt(D) + kbias)) v        per head
//   out     = x + gate * (att Wo + bo) * m
//
// Replaces: the JAX package's ops/dit_attention_pallas_train.py::
// fused_dit_attention_train (a custom-VJP pair of Pallas kernels, one grid
// cell per batch element holding its [T, C] tiles and one head's [T, T]
// softmax in VMEM; the backward recomputes everything from x and
// accumulates the projection gradients across grid cells).
//
// What bounds it on the H100: arithmetic. Forward 2*B*T*C*4C + 4*B*H*T^2*D
// FLOPs, backward about 3x (the TPU kernel's cost estimates); at B=32,
// T=1024, C=256, 4 heads that is 51.5 GFLOP forward.
//
// Design. One head's f32 [T, T] softmax is 4 MB at T=1024 and a CTA has
// 227 KB, so attention is tiled flash-style and no [B, H, T, T] tensor ever
// reaches device memory, forward or backward:
//   forward:  LN + modulate -> QKV tap GEMM with partial RoPE and bf16
//             rounding in its epilogue -> attention per (64 queries, head,
//             item) in two passes over 64-key tiles: the first finds each
//             row's log-sum-exp (saved, [B, H, T] f32), the second forms the
//             normalised weights p = exp(s - lse), drops them (Philox), rounds
//             them as the TPU kernel does before the PV product and
//             accumulates att -> out-projection with the gated residual.
//   backward: recompute h, q, k, v and the out-projection (for dgate);
//             datt = dz Wo^T; D = rowsum(datt * att) per head (the TPU's
//             sum(dp * p)); FlashAttention-2: one kernel per 64-key tile loops
//             over query tiles for dK, dV, a second per 64-query tile loops
//             over key tiles for dQ (no atomics); the RoPE adjoint
//             dq = dqr*cos - P(dqr*sin), zero outside the rotary lanes; dh =
//             [dq|dk|dv] [Wq|Wk|Wv]^T; projection gradients by the transposed
//             tap GEMM over the B*T rows in chunks (common.cuh); the
//             LayerNorm + modulate backward.
// Numerics kept from the TPU kernel: scores scaled by 1/sqrt(D) after the
// product, key bias -0.7*f32max on padded keys, natural-exp softmax; padded
// query rows are garbage that `* m` removes. In bf16 q/k/v are rounded
// before RoPE, p before PV, ds and dq/dk/dv after their products. Dropout:
// weight (b, h, q, key) keeps when Philox word key%4 of counter
// (key/4, q, b*H + h, 0) under the call's key is >= thresh. All products are
// fp32 FMA. Head dim 64.
#include "common.cuh"

#include <math.h>

using namespace stts;

namespace {

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
                                                      T* att, float* lse, int Tn, int C, int H, float sm_scale,
                                                      Dropout drop) {
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
    for (int j = 0; j < 4; ++j) att[base + (long long)t * C + tx * 4 + j] = from_f<T>(o[i][j]);
  }
}

// ---- D = rowsum(datt * att) per (item, head, row); one warp each ---------
template <typename T>
__global__ void rowdot_kernel(const T* datt, const T* att, float* Dv, int Tn, int C, int H, int n_rows) {
  int w = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;  // (b * H + h) * Tn + t
  int lane = threadIdx.x % 32;
  if (w >= n_rows) return;
  int t = w % Tn, bh = w / Tn, h = bh % H, b = bh / H;
  long long off = ((long long)b * Tn + t) * C + h * HD;
  float s = 0.f;
  for (int d = lane; d < HD; d += 32) s += to_f(datt[off + d]) * to_f(att[off + d]);
  s = warp_sum(s);
  if (lane == 0) Dv[w] = s;
}

// ---- backward dK, dV: one CTA per (64-key tile, head, item) ---------------
// S-phase thread (ty, tx): keys ty*4..+3, queries tx*4..+3;
// accumulation: keys ty*4..+3, dims tx*4..+3.
template <typename T>
__global__ void __launch_bounds__(NT) attn_bwd_dkv_kernel(const T* q, const T* k, const T* v, const T* datt,
                                                          const float* lse, const float* Dv, const float* mask,
                                                          T* dk_r, T* dqkv, int Tn, int C, int H,
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
      dk_r[row * C + c] = from_f<T>(dK[i][j] * sm_scale);
      dqkv[row * 3 * C + 2 * C + c] = from_f<T>(dV[i][j]);
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

// ---- RoPE adjoint: dq = dqr*cos - P(dqr*sin), zero outside the rotary lanes
// (lane l of a head: l < half takes +dqr[l+half]*sin, half <= l < 2*half
// takes -dqr[l-half]*sin); writes into dqkv [M, 3C] at column offset
// which*C. One thread per element of the [M, C] input.
template <typename T>
__global__ void rope_bwd_kernel(const T* dr, const float* cos_t, const float* sin_t, T* dqkv, int which, int M,
                                int Tn, int C, int half) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)M * C) return;
  int c = e % C;
  long long row = e / C;
  int t = row % Tn, l = c % HD;
  float y = to_f(dr[e]);
  float r;
  if (l < half) {
    r = y * cos_t[t * half + l] + to_f(dr[e + half]) * sin_t[t * half + l];
  } else if (l < 2 * half) {
    r = y * cos_t[t * half + l - half] - to_f(dr[e - half]) * sin_t[t * half + l - half];
  } else {
    r = y;
  }
  dqkv[row * 3 * C + which * C + c] = from_f<T>(r);
}

// out-projection epilogue, forward: out = x + gate * (acc + bo) * m
template <typename T>
struct OutFwdEpi {
  const T* bias;
  const T* x;
  const T* mod;
  const float* mask;
  T* out;
  int C, T_;
  __device__ float prep(int m, int n, float acc) const { return acc + to_f(bias[n]); }
  __device__ void store(int m, int n, const float* tile, int r, int c) const {
    const long long i = (long long)m * C + n;
    float gate = to_f(mod[((long long)(m / T_) * 3 + 2) * C + n]);
    out[i] = from_f<T>(to_f(x[i]) + gate * tile[r * (GEMM_BN + 1) + c] * mask[m]);
  }
};

// out-projection recompute, backward: pz = do * z * m, dz = round(do * gate * m)
template <typename T>
struct OutBwdEpi {
  const T* bias;
  const T* dout;
  const T* mod;
  const float* mask;
  float* pz;
  T* dzc;
  int C, T_;
  __device__ float prep(int m, int n, float acc) const { return acc + to_f(bias[n]); }
  __device__ void store(int m, int n, const float* tile, int r, int c) const {
    const long long i = (long long)m * C + n;
    float gate = to_f(mod[((long long)(m / T_) * 3 + 2) * C + n]);
    float d = to_f(dout[i]);
    pz[i] = d * tile[r * (GEMM_BN + 1) + c] * mask[m];
    dzc[i] = from_f<T>(d * gate * mask[m]);
  }
};

// plain store of the product, rounded to T (datt) or kept in f32 (dh0)
template <typename Tout>
struct StoreEpi {
  Tout* out;
  int N;
  __device__ float prep(int m, int n, float acc) const { return acc; }
  __device__ void store(int m, int n, const float* tile, int r, int c) const {
    out[(long long)m * N + n] = from_f<Tout>(tile[r * (GEMM_BN + 1) + c]);
  }
};

template <typename T>
void qkv_recompute(const T* x, const T* mod, const float* cos_t, const float* sin_t, const T* wqkv,
                   const T* bqkv, T* h, T* q, T* k, T* v, int M, int Tn, int C, float eps, cudaStream_t s) {
  launch_ln_mod<T, T>(x, mod, 3, 0, 1, nullptr, h, M, Tn, C, eps, s);
  launch_tap_gemm<T>(conv_gemm(h, C, wqkv, 3 * C, M, Tn, 1, false),
                     QkvEpi<T>{bqkv, q, k, v, cos_t, sin_t, C, HD, HD / 4, Tn, 1.f}, s);
}

template <typename T>
cudaError_t forward(const T* x, const T* mod, const float* mask, const float* cos_t, const float* sin_t,
                    const T* wqkv, const T* bqkv, const T* wo, const T* bo, Dropout drop, T* h, T* q, T* k, T* v,
                    T* att, float* lse, T* out, int B, int Tn, int C, int H, float eps, cudaStream_t s) {
  const int M = B * Tn;
  qkv_recompute<T>(x, mod, cos_t, sin_t, wqkv, bqkv, h, q, k, v, M, Tn, C, eps, s);
  cudaFuncSetAttribute(attn_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM);
  attn_fwd_kernel<T><<<dim3((Tn + TQ - 1) / TQ, H, B), NT, FWD_SMEM, s>>>(
      q, k, v, mask, att, lse, Tn, C, H, 1.f / sqrtf((float)HD), drop);
  launch_tap_gemm<T>(conv_gemm(att, C, wo, C, M, Tn, 1, false), OutFwdEpi<T>{bo, x, mod, mask, out, C, Tn}, s);
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward(const T* x, const T* mod, const float* mask, const float* cos_t, const float* sin_t,
                     const T* wqkv, const T* bqkv, const T* wo, const T* bo, Dropout drop, const T* att,
                     const float* lse, const T* dout, T* h, T* q, T* k, T* v, float* pz, T* dzc, T* datt,
                     float* Dv, T* dq_r, T* dk_r, T* dqkv, float* dh0, float* dh0n, T* dx, float* dmod,
                     float* dwqkv, float* dbqkv, float* dwo, float* dbo, float* ws, long long ws_floats, int B,
                     int Tn, int C, int H, float eps, cudaStream_t s) {
  const int M = B * Tn;
  const float sm_scale = 1.f / sqrtf((float)HD);
  qkv_recompute<T>(x, mod, cos_t, sin_t, wqkv, bqkv, h, q, k, v, M, Tn, C, eps, s);
  // out-projection: recompute for dgate, dz; datt = dz Wo^T; dWo, dbo
  launch_tap_gemm<T>(conv_gemm(att, C, wo, C, M, Tn, 1, false), OutBwdEpi<T>{bo, dout, mod, mask, pz, dzc, C, Tn}, s);
  launch_tap_gemm<T>(conv_gemm(dzc, C, wo, C, M, Tn, 1, true), StoreEpi<T>{datt, C}, s);
  launch_wgrad<T>(WGrad{att, C, C, dzc, C, C, M, Tn, 0, 0, dwo}, 1, ws, ws_floats, s);
  launch_colsum<T>(dzc, dbo, 1, M, C, 0, s);
  // attention backward
  const int n_rows = B * H * Tn;
  rowdot_kernel<T><<<(n_rows + 7) / 8, 256, 0, s>>>(datt, att, Dv, Tn, C, H, n_rows);
  cudaFuncSetAttribute(attn_bwd_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, DKV_SMEM);
  attn_bwd_dkv_kernel<T><<<dim3((Tn + TK - 1) / TK, H, B), NT, DKV_SMEM, s>>>(
      q, k, v, datt, lse, Dv, mask, dk_r, dqkv, Tn, C, H, sm_scale, drop);
  cudaFuncSetAttribute(attn_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM);
  attn_bwd_dq_kernel<T><<<dim3((Tn + TQ - 1) / TQ, H, B), NT, DQ_SMEM, s>>>(
      q, k, v, datt, lse, Dv, mask, dq_r, Tn, C, H, sm_scale, drop);
  const long long n_el = (long long)M * C;
  const int rb = (int)((n_el + 255) / 256);
  rope_bwd_kernel<T><<<rb, 256, 0, s>>>(dq_r, cos_t, sin_t, dqkv, 0, M, Tn, C, HD / 4);
  rope_bwd_kernel<T><<<rb, 256, 0, s>>>(dk_r, cos_t, sin_t, dqkv, 1, M, Tn, C, HD / 4);
  // projections: dh = dqkv Wqkv^T; dWqkv, dbqkv
  launch_tap_gemm<T>(conv_gemm(dqkv, 3 * C, wqkv, C, M, Tn, 1, true), StoreEpi<float>{dh0, C}, s);
  launch_wgrad<T>(WGrad{h, C, C, dqkv, 3 * C, 3 * C, M, Tn, 0, 0, dwqkv}, 1, ws, ws_floats, s);
  launch_colsum<T>(dqkv, dbqkv, 1, M, 3 * C, 0, s);
  // modulate + LayerNorm backward; per-item d{shift, scale, gate} -> dmod [B, 3, C]
  launch_ln_bwd<T>(x, dh0, mod, 3, 1, dout, dx, dh0n, M, Tn, C, eps, s);
  launch_colsum<float>(dh0, dmod, B, Tn, C, 3LL * C, s);
  launch_colsum<float>(dh0n, dmod + C, B, Tn, C, 3LL * C, s);
  launch_colsum<float>(pz, dmod + 2 * C, B, Tn, C, 3LL * C, s);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dit_attention_train_forward(const void* x, const void* mod, const void* mask, const void* cos_t,
                                           const void* sin_t, const void* wqkv, const void* bqkv, const void* wo,
                                           const void* bo, const void* seed, void* h, void* q, void* k, void* v,
                                           void* att, void* lse, void* out, int B, int T, int C, int H,
                                           int is_bf16, int thresh, float keep_scale, float eps, void* stream) {
  if (C / H != HD || C % 64) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Dropout drop = make_dropout(seed, thresh, keep_scale);
  const float* mk = static_cast<const float*>(mask);
  const float* cs = static_cast<const float*>(cos_t);
  const float* sn = static_cast<const float*>(sin_t);
#define STTS_ARGS(TY)                                                                                      \
  (const TY*)x, (const TY*)mod, mk, cs, sn, (const TY*)wqkv, (const TY*)bqkv, (const TY*)wo, (const TY*)bo, \
      drop, (TY*)h, (TY*)q, (TY*)k, (TY*)v, (TY*)att, static_cast<float*>(lse), (TY*)out, B, T, C, H, eps, s
  cudaError_t err = is_bf16 ? forward<bf16>(STTS_ARGS(bf16)) : forward<float>(STTS_ARGS(float));
#undef STTS_ARGS
  return (int)err;
}

extern "C" int dit_attention_train_backward(
    const void* x, const void* mod, const void* mask, const void* cos_t, const void* sin_t, const void* wqkv,
    const void* bqkv, const void* wo, const void* bo, const void* seed, const void* att, const void* lse,
    const void* dout, void* h, void* q, void* k, void* v, void* pz, void* dzc, void* datt, void* Dv, void* dq_r,
    void* dk_r, void* dqkv, void* dh0, void* dh0n, void* dx, void* dmod, void* dwqkv, void* dbqkv, void* dwo,
    void* dbo, void* ws, int B, int T, int C, int H, int is_bf16, int thresh, int ws_floats, float keep_scale,
    float eps, void* stream) {
  if (C / H != HD || C % 64) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Dropout drop = make_dropout(seed, thresh, keep_scale);
  const float* mk = static_cast<const float*>(mask);
  const float* cs = static_cast<const float*>(cos_t);
  const float* sn = static_cast<const float*>(sin_t);
  auto f = [](void* p) { return static_cast<float*>(p); };
#define STTS_ARGS(TY)                                                                                       \
  (const TY*)x, (const TY*)mod, mk, cs, sn, (const TY*)wqkv, (const TY*)bqkv, (const TY*)wo, (const TY*)bo,  \
      drop, (const TY*)att, static_cast<const float*>(lse), (const TY*)dout, (TY*)h, (TY*)q, (TY*)k, (TY*)v, \
      f(pz), (TY*)dzc, (TY*)datt, f(Dv), (TY*)dq_r, (TY*)dk_r, (TY*)dqkv, f(dh0), f(dh0n), (TY*)dx, f(dmod), \
      f(dwqkv), f(dbqkv), f(dwo), f(dbo), f(ws), ws_floats, B, T, C, H, eps, s
  cudaError_t err = is_bf16 ? backward<bf16>(STTS_ARGS(bf16)) : backward<float>(STTS_ARGS(float));
#undef STTS_ARGS
  return (int)err;
}
