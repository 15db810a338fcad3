// The Vocos ConvNeXt block on Hopper (sm_90a).
//
// Replaces: the JAX package's ops/convnext_pallas.py::fused_convnext_block, which
// keeps one batch element's [T, C] tile and the [T, F] GELU activations in
// VMEM and runs dwconv k=7 -> LN -> Dense C->F -> GELU -> Dense F->C -> x +
// gamma*z.
//
// What bounds it on the H100: arithmetic. 4*b*t*C*F FLOPs (3.22 GFLOP at b=1,
// T=1024, C=512, F=1536) against 2*b*t*C*dtype bytes of activations.
//
// bf16 (tensor cores), three launches on one stream:
//   1. `dwconv_ln_kernel`: depthwise k=7 conv (rows outside [0, T) are zero)
//      and LayerNorm (f32 stats, affine), one warp per row, h rounded to bf16;
//   2. y = round(gelu_tanh(h @ W1 + b1))   (common.cuh's tap GEMM, 1 tap, on
//      wgmma; GeluEpi)
//   3. out = x + gamma * (y @ W2 + b2)     (the same; ResidualEpi)
// The [B*T, F] bf16 intermediate goes through device memory (~25 MB each way
// at B=8, T=1000, ~15 us at 3.35 TB/s), which one fused kernel would save at
// the cost of splitting z across warpgroups.
//
// f32 (fp32 FMA), one kernel, `convnext_kernel`: a CTA owns 32 rows of one
// batch item and all C output columns.
//   1. depthwise k=7 conv with a +-3-row halo read from global memory (rows
//      outside [0, T) are zero), into a [32, C] f32 tile in shared memory;
//   2. LayerNorm (f32 stats, affine) per row, one warp per row, in place;
//   3. F in chunks of 64: y = gelu(h @ W1[:, f0:f0+64] + b1) in shared memory,
//      then z += y @ W2[f0:f0+64, :] in registers (each thread owns C/256
//      columns for all 32 rows). The [rows, F] activations never reach
//      device memory.
//   4. out = x + gamma * (z + b2).
// GELU is the erf form at f32 and the tanh form at bf16; both routes round h
// and y at the same points. Any T works; the caller keeps padded rows zero
// between blocks.
#include "common.cuh"

#include <math.h>

using namespace stts;

namespace {

constexpr int CN_BM = 32, CN_BF = 64, CN_THREADS = 256;

template <bool kTanh>
__device__ __forceinline__ float gelu(float y) {
  if (kTanh) {
    const float k0 = 0.7978845608028654f, k1 = 0.044715f;  // sqrt(2/pi)
    return 0.5f * y * (1.f + tanhf(k0 * (y + k1 * y * y * y)));
  }
  return 0.5f * y * (1.f + erff(y * 0.7071067811865476f));
}

template <typename T, int CPT>
__global__ void __launch_bounds__(CN_THREADS)
convnext_kernel(const T* x, const T* dw_w, const T* dw_b, const T* ln_w, const T* ln_b, const T* w1,
                const T* b1, const T* w2, const T* b2, const T* gamma, T* out, int Tn, int F, float eps) {
  constexpr int C = CPT * CN_THREADS;
  constexpr bool kTanh = sizeof(T) == 2;
  extern __shared__ __align__(16) float sm[];
  float* hs = sm;               // [BM][C]
  float* ys = hs + CN_BM * C;   // [BM][BF]

  const int b = blockIdx.y, t0 = blockIdx.x * CN_BM, tid = threadIdx.x;
  const T* xb = x + (long long)b * Tn * C;

  // 1. depthwise conv, JAX operation order: x*w3 + (x[t-d]*w[3-d] + x[t+d]*w[3+d]), d = 1..3
  for (int cc = 0; cc < CPT; ++cc) {
    int c = tid + cc * CN_THREADS;
    float wv[7];
#pragma unroll
    for (int q = 0; q < 7; ++q) wv[q] = to_f(dw_w[q * C + c]);
    float bias = to_f(dw_b[c]);
    for (int r = 0; r < CN_BM; ++r) {
      int t = t0 + r;
      auto xa = [&](int tt) { return (tt >= 0 && tt < Tn) ? to_f(xb[(long long)tt * C + c]) : 0.f; };
      float acc = xa(t) * wv[3];
#pragma unroll
      for (int d = 1; d < 4; ++d) acc = acc + xa(t - d) * wv[3 - d] + xa(t + d) * wv[3 + d];
      hs[r * C + c] = acc + bias;
    }
  }
  __syncthreads();

  // 2. LayerNorm per row
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < CN_BM; r += CN_THREADS / 32) {
    float* row = hs + r * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += row[c];
    float mu = warp_sum(s) / C;
    float v = 0.f;
    for (int c = lane; c < C; c += 32) {
      float d = row[c] - mu;
      v += d * d;
    }
    float rstd = rsqrtf(warp_sum(v) / C + eps);
    for (int c = lane; c < C; c += 32)
      row[c] = round_to<T>((row[c] - mu) * rstd * to_f(ln_w[c]) + to_f(ln_b[c]));
  }
  __syncthreads();

  // 3. chunked MLP
  float z[CN_BM][CPT];
#pragma unroll
  for (int r = 0; r < CN_BM; ++r)
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) z[r][cc] = 0.f;

  const int fl = tid % CN_BF, rg = tid / CN_BF;  // 4 row groups of 8 rows
  for (int f0 = 0; f0 < F; f0 += CN_BF) {
    float ya[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) ya[i] = 0.f;
    const T* w1c = w1 + f0 + fl;
    for (int k = 0; k < C; ++k) {
      float wk = to_f(w1c[(long long)k * F]);
#pragma unroll
      for (int i = 0; i < 8; ++i) ya[i] = fmaf(hs[(rg * 8 + i) * C + k], wk, ya[i]);
    }
    float bias = to_f(b1[f0 + fl]);
#pragma unroll
    for (int i = 0; i < 8; ++i) ys[(rg * 8 + i) * CN_BF + fl] = round_to<T>(gelu<kTanh>(ya[i] + bias));
    __syncthreads();
    for (int k = 0; k < CN_BF; ++k) {
      float wv[CPT];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) wv[cc] = to_f(w2[(long long)(f0 + k) * C + tid + cc * CN_THREADS]);
#pragma unroll
      for (int r = 0; r < CN_BM; ++r) {
        float yv = ys[r * CN_BF + k];
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) z[r][cc] = fmaf(yv, wv[cc], z[r][cc]);
      }
    }
    __syncthreads();
  }

  // 4. residual
#pragma unroll
  for (int cc = 0; cc < CPT; ++cc) {
    int c = tid + cc * CN_THREADS;
    float bias = to_f(b2[c]), g = to_f(gamma[c]);
#pragma unroll
    for (int r = 0; r < CN_BM; ++r) {
      int t = t0 + r;
      if (t < Tn) {
        long long idx = ((long long)b * Tn + t) * C + c;
        out[idx] = from_f<T>(to_f(x[idx]) + (z[r][cc] + bias) * g);
      }
    }
  }
}

template <typename T, int CPT>
cudaError_t launch(const void* const* p, void* out, int B, int Tn, int F, float eps, cudaStream_t s) {
  constexpr int C = CPT * CN_THREADS;
  const int smem = (CN_BM * C + CN_BM * CN_BF) * (int)sizeof(float);
  cudaFuncSetAttribute(convnext_kernel<T, CPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid((Tn + CN_BM - 1) / CN_BM, B);
  convnext_kernel<T, CPT><<<grid, CN_THREADS, smem, s>>>(
      (const T*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3], (const T*)p[4], (const T*)p[5],
      (const T*)p[6], (const T*)p[7], (const T*)p[8], (const T*)p[9], (T*)out, Tn, F, eps);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const void* const* p, void* out, int B, int Tn, int C, int F, float eps, cudaStream_t s) {
  switch (C) {
    case 256: return launch<float, 1>(p, out, B, Tn, F, eps, s);
    case 512: return launch<float, 2>(p, out, B, Tn, F, eps, s);
    case 768: return launch<float, 3>(p, out, B, Tn, F, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---- bf16: depthwise conv + LayerNorm, then two tap GEMMs on wgmma --------

// h[row] = round(LN(dwconv(x)[row]) * ln_w + ln_b), one warp per row of [B*T, C];
// lane l owns columns l + 32 j
template <int CW>  // C / 32
__global__ void dwconv_ln_kernel(const bf16* x, const bf16* dw_w, const bf16* dw_b, const bf16* ln_w,
                                 const bf16* ln_b, bf16* h, int M, int Tn, float eps) {
  constexpr int C = CW * 32;
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  const int t = row % Tn;
  const bf16* xr = x + (long long)row * C;
  auto xa = [&](int d, int c) { return (t + d >= 0 && t + d < Tn) ? to_f(xr[(long long)d * C + c]) : 0.f; };
  float v[CW];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < CW; ++j) {
    const int c = lane + 32 * j;
    // JAX operation order: x*w3 + (x[t-d]*w[3-d] + x[t+d]*w[3+d]), d = 1..3
    float acc = xa(0, c) * to_f(dw_w[3 * C + c]);
#pragma unroll
    for (int d = 1; d < 4; ++d)
      acc = acc + xa(-d, c) * to_f(dw_w[(3 - d) * C + c]) + xa(d, c) * to_f(dw_w[(3 + d) * C + c]);
    v[j] = acc + to_f(dw_b[c]);
    s += v[j];
  }
  const float mu = warp_sum(s) / C;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < CW; ++j) {
    const float d = v[j] - mu;
    q += d * d;
  }
  const float rstd = rsqrtf(warp_sum(q) / C + eps);
#pragma unroll
  for (int j = 0; j < CW; ++j) {
    const int c = lane + 32 * j;
    h[(long long)row * C + c] = from_f<bf16>((v[j] - mu) * rstd * to_f(ln_w[c]) + to_f(ln_b[c]));
  }
}

// y = round(gelu_tanh(acc + b1))
struct GeluEpi {
  const bf16* bias;
  bf16* y;
  int F;
  __device__ float prep(int m, int n, float acc) const { return acc + to_f(bias[n]); }
  __device__ void store(int m, int n, const float* tile, int r, int c) const {
    y[(long long)m * F + n] = from_f<bf16>(gelu<true>(tile[r * (GEMM_BN + 1) + c]));
  }
};

// out = x + gamma * (acc + b2)
struct ResidualEpi {
  const bf16* bias;
  const bf16* gamma;
  const bf16* x;
  bf16* out;
  int C;
  __device__ float prep(int m, int n, float acc) const { return acc + to_f(bias[n]); }
  __device__ void store(int m, int n, const float* tile, int r, int c) const {
    const long long i = (long long)m * C + n;
    out[i] = from_f<bf16>(to_f(x[i]) + tile[r * (GEMM_BN + 1) + c] * to_f(gamma[n]));
  }
};

cudaError_t run_bf16(const void* const* pv, void* outv, void* hv, void* yv, int B, int Tn, int C, int F, float eps,
                     cudaStream_t s) {
  const bf16* const* p = reinterpret_cast<const bf16* const*>(pv);
  bf16* h = static_cast<bf16*>(hv);
  bf16* y = static_cast<bf16*>(yv);
  const int M = B * Tn, grid = (M + LN_ROWS - 1) / LN_ROWS;
  switch (C) {
    case 256: dwconv_ln_kernel<8><<<grid, 32 * LN_ROWS, 0, s>>>(p[0], p[1], p[2], p[3], p[4], h, M, Tn, eps); break;
    case 512: dwconv_ln_kernel<16><<<grid, 32 * LN_ROWS, 0, s>>>(p[0], p[1], p[2], p[3], p[4], h, M, Tn, eps); break;
    case 768: dwconv_ln_kernel<24><<<grid, 32 * LN_ROWS, 0, s>>>(p[0], p[1], p[2], p[3], p[4], h, M, Tn, eps); break;
    default: return cudaErrorInvalidValue;
  }
  launch_tap_gemm<bf16>(conv_gemm(h, C, p[5], F, M, Tn, 1, false), GeluEpi{p[6], y, F}, s);
  launch_tap_gemm<bf16>(conv_gemm(y, F, p[7], C, M, Tn, 1, false),
                        ResidualEpi{p[8], p[9], p[0], static_cast<bf16*>(outv), C}, s);
  return cudaGetLastError();
}

}  // namespace

// h [B*T, C] and y [B*T, F] are bf16 scratch for the bf16 route (unused in f32)
extern "C" int convnext_forward(const void* x, const void* dw_w, const void* dw_b, const void* ln_w,
                                const void* ln_b, const void* w1, const void* b1, const void* w2,
                                const void* b2, const void* gamma, void* out, void* h, void* y, int B, int T,
                                int C, int F, int is_bf16, float eps, void* stream) {
  if (F % CN_BF) return (int)cudaErrorInvalidValue;
  const void* p[10] = {x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_bf16 ? run_bf16(p, out, h, y, B, T, C, F, eps, s) : dispatch_f32(p, out, B, T, C, F, eps, s);
  return (int)err;
}
