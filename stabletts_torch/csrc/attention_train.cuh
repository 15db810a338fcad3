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
// backward regenerates the forward's mask.
//
// Two sets of kernels compute this. f32 runs the fp32-FMA kernels (the f32
// bars hold no TF32 form). bf16 runs the *_wgmma kernels below them: every
// operand of the ten tile products is a bf16 value at the rounding points
// above, so wgmma (tensor cores, f32 accumulate) changes only the order of
// the f32 sums.
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
#include "wgmma.cuh"

#include <math.h>
#include <type_traits>

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

// ================================================================ f32: FMA ==

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

// ============================================================= bf16: wgmma ==
//
// The same three kernels with every product on the tensor cores (wgmma.cuh),
// one warpgroup (128 threads) per CTA over the FMA kernels' grids. Shared
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
// are computed and never touch shared memory. The forward keeps the two
// passes of the FMA kernel (the log-sum-exp first, then the normalised
// weights), so the dropped weights are rounded normalised, as the TPU kernel
// rounds them.
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
    const uint32_t keep = dropping ? keep_rows_q(key0, key1, drop.thresh, j * TK, q0 + r0, bh) : 0u;
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
    const uint32_t keep = dropping ? keep_rows_k(key0, key1, drop.thresh, k0, j * TQ, bh) : 0u;
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

    const uint32_t keep = dropping ? keep_rows_q(key0, key1, drop.thresh, j * TK, q0 + r0, bh) : 0u;
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
  const dim3 grid((Tn + TQ - 1) / TQ, H, B);
  if constexpr (std::is_same<T, bf16>::value) {
    cudaFuncSetAttribute(attn_fwd_kernel_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_FWD_SMEM);
    attn_fwd_kernel_wgmma<<<grid, WG_THREADS, WG_FWD_SMEM, s>>>(q, k, v, mask, att, att_lo, lse, Tn, C, H, sm_scale,
                                                                drop);
  } else {
    cudaFuncSetAttribute(attn_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM);
    attn_fwd_kernel<T><<<grid, NT, FWD_SMEM, s>>>(q, k, v, mask, att, att_lo, lse, Tn, C, H, sm_scale, drop);
  }
}

// D = rowsum(datt * (att + att_lo)) (att_lo may be null), then dK (scaled) ->
// dk [M, C], dV -> dv (row stride ld_dv), dQ (scaled) -> dq [M, C]
template <typename T>
void launch_attn_bwd(const T* q, const T* k, const T* v, const T* att, const T* att_lo, const T* datt,
                     const float* lse, const float* mask, float* Dv, T* dq, T* dk, T* dv, int ld_dv, int B, int Tn,
                     int C, int H, float sm_scale, Dropout drop, cudaStream_t s) {
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
    cudaFuncSetAttribute(attn_bwd_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, DKV_SMEM);
    attn_bwd_dkv_kernel<T><<<grid, NT, DKV_SMEM, s>>>(q, k, v, datt, lse, Dv, mask, dk, dv, ld_dv, Tn, C, H,
                                                      sm_scale, drop);
    cudaFuncSetAttribute(attn_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM);
    attn_bwd_dq_kernel<T><<<grid, NT, DQ_SMEM, s>>>(q, k, v, datt, lse, Dv, mask, dq, Tn, C, H, sm_scale, drop);
  }
}

}  // namespace atr
}  // namespace stts
