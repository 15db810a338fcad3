// The Vocos ConvNeXt block on Hopper (sm_90a), one kernel per block.
//
// Replaces: the JAX package's ops/convnext_pallas.py::fused_convnext_block, which
// keeps one batch element's [T, C] tile and the [T, F] GELU activations in
// VMEM and runs dwconv k=7 -> LN -> Dense C->F -> GELU -> Dense F->C -> x +
// gamma*z.
//
// What bounds it on the H100: arithmetic. 4*b*t*C*F FLOPs (3.22 GFLOP at b=1,
// T=1024, C=512, F=1536) against 2*b*t*C*dtype bytes of activations; the
// [t, F] intermediate is three times the size of x and would dominate the
// traffic if it went through device memory.
//
// Design: a CTA owns 32 rows of one batch item and all C output columns.
//   1. depthwise k=7 conv with a +-3-row halo read from global memory (rows
//      outside [0, T) are zero), into a [32, C] f32 tile in shared memory;
//   2. LayerNorm (f32 stats, affine) per row, one warp per row, in place;
//   3. F in chunks of 64: y = gelu(h @ W1[:, f0:f0+64] + b1) in shared memory,
//      then z += y @ W2[f0:f0+64, :] in registers (each thread owns C/256
//      columns for all 32 rows). The [rows, F] activations never reach
//      device memory.
//   4. out = x + gamma * (z + b2).
// fp32 FMA throughout; GELU is the erf form at f32 and the tanh form at bf16.
// The kernel takes any T; the caller keeps padded rows zero between blocks.
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

template <typename T>
cudaError_t dispatch(const void* const* p, void* out, int B, int Tn, int C, int F, float eps, cudaStream_t s) {
  switch (C) {
    case 256: return launch<T, 1>(p, out, B, Tn, F, eps, s);
    case 512: return launch<T, 2>(p, out, B, Tn, F, eps, s);
    case 768: return launch<T, 3>(p, out, B, Tn, F, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int convnext_forward(const void* x, const void* dw_w, const void* dw_b, const void* ln_w,
                                const void* ln_b, const void* w1, const void* b1, const void* w2,
                                const void* b2, const void* gamma, void* out, int B, int T, int C, int F,
                                int is_bf16, float eps, void* stream) {
  if (F % CN_BF) return (int)cudaErrorInvalidValue;
  const void* p[10] = {x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_bf16 ? dispatch<bf16>(p, out, B, T, C, F, eps, s)
                            : dispatch<float>(p, out, B, T, C, F, eps, s);
  return (int)err;
}
