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
// Three launches on one stream, in both types:
//   1. `dwconv_ln_kernel`: depthwise k=7 conv (rows outside [0, T) are zero)
//      and LayerNorm (f32 stats, affine), one warp per row, h rounded to T;
//   2. y = round(gelu(h @ W1 + b1))        (common.cuh's tap GEMM, 1 tap; GeluEpi)
//   3. out = x + gamma * (y @ W2 + b2)     (the same; ResidualEpi)
// The tap GEMM runs on wgmma in bf16 and on the FP32 pipes in f32 (its
// register-blocked FMA kernel, true f32). GELU is the erf form at f32 and the
// tanh form at bf16; both types round h and y at the same points. The [B*T, F]
// intermediate goes through device memory (~25 MB each way at B=8, T=1000 in
// bf16, ~15 us at 3.35 TB/s; 6 MB in f32 at a request's B=1, T=1024), which
// one fused kernel would save at the cost of splitting z across CTAs. Any T
// works; the caller keeps padded rows zero between blocks.
#include "common.cuh"

#include <math.h>

using namespace stts;

namespace {

template <bool kTanh>
__device__ __forceinline__ float gelu(float y) {
  if (kTanh) {
    const float k0 = 0.7978845608028654f, k1 = 0.044715f;  // sqrt(2/pi)
    return 0.5f * y * (1.f + tanhf(k0 * (y + k1 * y * y * y)));
  }
  return 0.5f * y * (1.f + erff(y * 0.7071067811865476f));
}

// h[row] = round_T(LN(dwconv(x)[row]) * ln_w + ln_b), one warp per row of [B*T, C];
// lane l owns columns l + 32 j
template <typename T, int CW>  // C / 32
__global__ void dwconv_ln_kernel(const T* x, const T* dw_w, const T* dw_b, const T* ln_w, const T* ln_b, T* h,
                                 int M, int Tn, float eps) {
  constexpr int C = CW * 32;
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  const int t = row % Tn;
  const T* xr = x + (long long)row * C;
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
    h[(long long)row * C + c] = from_f<T>((v[j] - mu) * rstd * to_f(ln_w[c]) + to_f(ln_b[c]));
  }
}

// y = round_T(gelu(acc + b1)): erf in f32, tanh in bf16
template <typename T>
struct GeluEpi {
  const T* bias;
  T* y;
  int F;
  __device__ float prep(int m, int n, float acc) const { return acc + to_f(bias[n]); }
  __device__ void store(int m, int n, const float* tile, int r, int c) const {
    y[(long long)m * F + n] = from_f<T>(gelu<sizeof(T) == 2>(tile[r * (GEMM_BN + 1) + c]));
  }
  __device__ void store8(int m, int n, const float* tile, int r, int c) const {
    T* dst = y + (long long)m * F + n;
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = gelu<sizeof(T) == 2>(tile[r * (GEMM_BN + 1) + c + i]);
    if (chunk8(dst, F)) {
      st8(dst, v);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[i] = from_f<T>(v[i]);
    }
  }
};

// out = x + gamma * (acc + b2)
template <typename T>
struct ResidualEpi {
  const T* bias;
  const T* gamma;
  const T* x;
  T* out;
  int C;
  __device__ float prep(int m, int n, float acc) const { return acc + to_f(bias[n]); }
  __device__ void store(int m, int n, const float* tile, int r, int c) const {
    const long long i = (long long)m * C + n;
    out[i] = from_f<T>(to_f(x[i]) + tile[r * (GEMM_BN + 1) + c] * to_f(gamma[n]));
  }
  __device__ void store8(int m, int n, const float* tile, int r, int c) const {
    const long long i0 = (long long)m * C + n;
    if (!(chunk8(x + i0, C) && chunk8(gamma + n, C) && chunk8(out + i0, C))) {
#pragma unroll
      for (int i = 0; i < 8; ++i) store(m, n + i, tile, r, c + i);
      return;
    }
    float xv[8], gv[8], o[8];
    ld8(x + i0, xv);
    ld8(gamma + n, gv);
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = xv[i] + tile[r * (GEMM_BN + 1) + c + i] * gv[i];
    st8(out + i0, o);
  }
};

template <typename T>
cudaError_t run(const void* const* pv, void* outv, void* hv, void* yv, int B, int Tn, int C, int F, float eps,
                cudaStream_t s) {
  const T* const* p = reinterpret_cast<const T* const*>(pv);
  T* h = static_cast<T*>(hv);
  T* y = static_cast<T*>(yv);
  const int M = B * Tn, grid = (M + LN_ROWS - 1) / LN_ROWS;
  switch (C) {
    case 256: dwconv_ln_kernel<T, 8><<<grid, 32 * LN_ROWS, 0, s>>>(p[0], p[1], p[2], p[3], p[4], h, M, Tn, eps); break;
    case 512: dwconv_ln_kernel<T, 16><<<grid, 32 * LN_ROWS, 0, s>>>(p[0], p[1], p[2], p[3], p[4], h, M, Tn, eps); break;
    case 768: dwconv_ln_kernel<T, 24><<<grid, 32 * LN_ROWS, 0, s>>>(p[0], p[1], p[2], p[3], p[4], h, M, Tn, eps); break;
    default: return cudaErrorInvalidValue;
  }
  launch_tap_gemm<T>(conv_gemm(h, C, p[5], F, M, Tn, 1, false), GeluEpi<T>{p[6], y, F}, s);
  launch_tap_gemm<T>(conv_gemm(y, F, p[7], C, M, Tn, 1, false),
                     ResidualEpi<T>{p[8], p[9], p[0], static_cast<T*>(outv), C}, s);
  return cudaGetLastError();
}

}  // namespace

// h [B*T, C] and y [B*T, F] are scratch in x's type
extern "C" int convnext_forward(const void* x, const void* dw_w, const void* dw_b, const void* ln_w,
                                const void* ln_b, const void* w1, const void* b1, const void* w2,
                                const void* b2, const void* gamma, void* out, void* h, void* y, int B, int T,
                                int C, int F, int is_bf16, float eps, void* stream) {
  const void* p[10] = {x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_bf16 ? run<bf16>(p, out, h, y, B, T, C, F, eps, s) : run<float>(p, out, h, y, B, T, C, F, eps, s);
  return (int)err;
}
