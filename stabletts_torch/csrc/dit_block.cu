// The whole inference DiT block on Hopper (sm_90a).
//
// Replaces: the JAX package's ops/dit_block_pallas.py::fused_dit_block (one Pallas
// kernel per batch element holding the whole [T, C] tile and a [T, T] score
// tile per head in VMEM).
//
// What bounds it on the H100: arithmetic. Per block 2*b*t*c*4c (projections)
// + 4*b*H*t^2*D (attention) + 4*b*t*3*c*f (convs) FLOPs, 9.66 GFLOP at b=2,
// T=1024, against ~2*b*t*c*dtype bytes of activations in and out. A CTA has
// 227 KB of shared memory, so the TPU design (whole sequence and a [T, T]
// score tile resident) does not fit: at T=1024 one head's f32 score tile is
// 4 MB and T reaches 8192.
//
// Design: tile T. The block is a short sequence of launches on one stream:
//   1. LN1 + modulate            (one warp per row)
//   2. QKV projection + q scale + partial RoPE epilogue      (tap GEMM, 1 tap)
//   3. attention per (batch, head, 64-query tile), online softmax in exp2
//      over 64-key tiles, so no score tile larger than 64x64 exists
//   4. out-projection + gated residual x1 = x + gate*out*m, kept in f32
//   5. LN2 + modulate + mask     (one warp per row)
//   6. conv k=3 C->F + SiLU + mask (tap GEMM, 3 taps, rows shifted -1..+1,
//      zero outside [0, T))
//   7. conv k=3 F->C + mask + gated residual                 (tap GEMM, 3 taps)
// Every product is computed here with fp32 FMAs; bf16 values are rounded at
// the TPU kernel's points. Any T works (ragged tiles are masked).
#include "common.cuh"

#include <math.h>

using namespace stts;

namespace {

constexpr float kNeg = -0.7f * 3.402823466e38f;  // key bias of padded keys
constexpr float kLog2e = 1.4426950408889634f;

// Steps 1 and 5 are common.cuh's ln_mod_kernel, step 2's epilogue its QkvEpi.

// ---- 4: out-projection epilogue: x1 = x + (out * gate) * m, f32 ------------
template <typename T>
struct OutProjEpi {
  const T* bias;
  const T* x;
  const T* mods;
  const float* mask;
  float* x1;
  int C, T_;
  __device__ float prep(int m, int n, float acc) const { return acc + to_f(bias[n]); }
  __device__ void store(int m, int n, const float* tile, int r, int c) const {
    int b = m / T_;
    float gate = to_f(mods[((long long)b * 6 + 2) * C + n]);
    float out = tile[r * (GEMM_BN + 1) + c];
    x1[(long long)m * C + n] = to_f(x[(long long)m * C + n]) + out * gate * mask[m];
  }
};

// ---- 6: conv1 epilogue: silu(acc + b1) * m --------------------------------
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

// ---- 7: conv2 epilogue: out = x1 + gate * ((acc + b2) * m) -----------------
template <typename T>
struct Conv2Epi {
  const T* bias;
  const T* mods;
  const float* mask;
  const float* x1;
  T* out;
  int C, T_;
  __device__ float prep(int m, int n, float acc) const { return acc + to_f(bias[n]); }
  __device__ void store(int m, int n, const float* tile, int r, int c) const {
    int b = m / T_;
    float gate = to_f(mods[((long long)b * 6 + 5) * C + n]);
    float z = tile[r * (GEMM_BN + 1) + c] * mask[m];
    out[(long long)m * C + n] = from_f<T>(x1[(long long)m * C + n] + gate * z);
  }
};

// ---- 3: attention, one CTA per (64-query tile, head, batch) ----------------
// q is pre-scaled by log2(e)/sqrt(D); scores get the key bias (0 or kNeg) and
// keys past T are excluded. Online softmax in exp2; the weights are rounded
// to T before the PV product, the normaliser sums the unrounded f32 weights.
constexpr int ATT_D = 64, ATT_BQ = 64, ATT_BK = 64, ATT_LD = 68;
constexpr int ATT_SMEM = (4 * ATT_D * ATT_LD + ATT_BK) * (int)sizeof(float);

template <typename T>
__global__ void __launch_bounds__(256) attention_kernel(const T* q, const T* k, const T* v,
                                                        const float* mask, T* out, int Tn, int C) {
  extern __shared__ __align__(16) float sm[];
  float* Qt = sm;                   // [D][LD]   Qt[d][query]
  float* Kt = Qt + ATT_D * ATT_LD;  // [D][LD]   Kt[d][key]
  float* Vs = Kt + ATT_D * ATT_LD;  // [BK][LD]  Vs[key][d]
  float* Pt = Vs + ATT_BK * ATT_LD; // [BK][LD]  Pt[key][query]
  float* kb = Pt + ATT_BK * ATT_LD; // [BK]      key bias

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ATT_BQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long base = (long long)b * Tn * C + h * ATT_D;

  for (int e = tid; e < ATT_BQ * ATT_D; e += 256) {
    int r = e / ATT_D, d = e % ATT_D;
    int t = q0 + r;
    Qt[d * ATT_LD + r] = t < Tn ? to_f(q[base + (long long)t * C + d]) : 0.f;
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
      int r = e / ATT_D, d = e % ATT_D;
      int t = k0 + r;
      bool ok = t < Tn;
      Kt[d * ATT_LD + r] = ok ? to_f(k[base + (long long)t * C + d]) : 0.f;
      Vs[r * ATT_LD + d] = ok ? to_f(v[base + (long long)t * C + d]) : 0.f;
    }
    if (tid < ATT_BK) {
      int t = k0 + tid;
      kb[tid] = t < Tn ? (mask[(long long)b * Tn + t] > 0.f ? 0.f : kNeg) : -INFINITY;
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
        s[i][j] += kb[tx * 4 + j];
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int t = q0 + ty * 4 + i;
    if (t >= Tn) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[base + (long long)t * C + tx * 4 + j] = from_f<T>(o[i][j] / l_i[i]);
  }
}

template <typename T>
cudaError_t run_block(const T* x, const T* mods, const float* mask, const float* cos_t,
                      const float* sin_t, const T* wqkv, const T* bqkv, const T* wo, const T* bo,
                      const T* w1, const T* b1, const T* w2, const T* b2, T* h, T* q, T* k, T* v,
                      T* att, float* x1, T* h2, T* y, T* out, int B, int Tn, int C, int F, int H,
                      float eps, cudaStream_t stream) {
  const int M = B * Tn, D = C / H;

  launch_ln_mod<T, T>(x, mods, 6, 0, 1, nullptr, h, M, Tn, C, eps, stream);

  TapGemm g{};
  g.a0 = h; g.a1 = h; g.k_split = C; g.lda = C; g.t_in = Tn; g.t_out = Tn; g.k_in = C;
  g.taps = 1; g.shift0 = 0; g.shift_step = 0; g.row_len = nullptr;
  g.w = wqkv; g.w_tap_stride = 0; g.ldw = 3 * C; g.M = M; g.N = 3 * C;
  QkvEpi<T> qe{bqkv, q, k, v, cos_t, sin_t, C, D, D / 4, Tn, kLog2e / sqrtf((float)D)};
  launch_tap_gemm<T>(g, qe, stream);

  cudaFuncSetAttribute(attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, ATT_SMEM);
  dim3 att_grid((Tn + ATT_BQ - 1) / ATT_BQ, H, B);
  attention_kernel<T><<<att_grid, 256, ATT_SMEM, stream>>>(q, k, v, mask, att, Tn, C);

  g.a0 = att; g.a1 = att; g.w = wo; g.ldw = C; g.N = C;
  OutProjEpi<T> oe{bo, x, mods, mask, x1, C, Tn};
  launch_tap_gemm<T>(g, oe, stream);

  launch_ln_mod<float, T>(x1, mods, 6, 3, 4, mask, h2, M, Tn, C, eps, stream);

  g.a0 = h2; g.a1 = h2; g.taps = 3; g.shift0 = -1; g.shift_step = 1;
  g.w = w1; g.w_tap_stride = (long long)C * F; g.ldw = F; g.N = F;
  Conv1Epi<T> c1{b1, mask, y, F};
  launch_tap_gemm<T>(g, c1, stream);

  g.a0 = y; g.a1 = y; g.k_split = F; g.lda = F; g.k_in = F;
  g.w = w2; g.w_tap_stride = (long long)F * C; g.ldw = C; g.N = C;
  Conv2Epi<T> c2{b2, mods, mask, x1, out, C, Tn};
  launch_tap_gemm<T>(g, c2, stream);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dit_block_forward(const void* x, const void* mods, const void* mask, const void* cos_t,
                                 const void* sin_t, const void* wqkv, const void* bqkv, const void* wo,
                                 const void* bo, const void* w1, const void* b1, const void* w2,
                                 const void* b2, void* h, void* q, void* k, void* v, void* att, void* x1,
                                 void* h2, void* y, void* out, int B, int T, int C, int F, int H,
                                 int is_bf16, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mk = static_cast<const float*>(mask);
  const float* cs = static_cast<const float*>(cos_t);
  const float* sn = static_cast<const float*>(sin_t);
  float* x1f = static_cast<float*>(x1);
  if (C / H != ATT_D) return (int)cudaErrorInvalidValue;
#define STTS_ARGS(TY)                                                                              \
  (const TY*)x, (const TY*)mods, mk, cs, sn, (const TY*)wqkv, (const TY*)bqkv, (const TY*)wo,       \
      (const TY*)bo, (const TY*)w1, (const TY*)b1, (const TY*)w2, (const TY*)b2, (TY*)h, (TY*)q,    \
      (TY*)k, (TY*)v, (TY*)att, x1f, (TY*)h2, (TY*)y, (TY*)out, B, T, C, F, H, eps, s
  cudaError_t err = is_bf16 ? run_block<bf16>(STTS_ARGS(bf16)) : run_block<float>(STTS_ARGS(float));
#undef STTS_ARGS
  return (int)err;
}
