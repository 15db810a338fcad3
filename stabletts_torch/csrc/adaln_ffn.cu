// The inference DiT block's FFN half on Hopper (sm_90a).
//
//   out = x + gate * conv2(silu(conv1(modulate(LN(x)) * m)) * m) * m,  k = 3
//
// Replaces: the JAX package's ops/ffn_pallas.py::fused_adaln_ffn (one Pallas
// kernel per batch element with the [T, C] tile, the [T, F] intermediate and
// both weight sets resident in VMEM).
//
// What bounds it on the H100: arithmetic, 4*b*t*3*c*f FLOPs (5.15e10 at b=16,
// T=1024, C=256, F=1024) against 2*b*t*c activation elements plus 6*c*f
// weights. A CTA has 227 KB of shared memory, so the [T, F] intermediate does
// not stay on chip across the whole sequence as on the TPU; it goes through
// device memory once (L2-resident at serving sizes).
//
// Design: steps 5-7 of the whole block (dit_block.cu) as three launches on one
// stream, sharing its device code:
//   1. LN + modulate + mask       (one warp per row; x in the activation type)
//   2. conv k=3 C->F + SiLU + mask  (tap GEMM, rows shifted -1..+1, zero
//      outside [0, T))
//   3. conv k=3 F->C + mask + gated residual on x, rounded to x's type
// mods is [B, 3, C]: shift, scale, gate. The tap GEMMs run on wgmma in bf16
// and on fp32 FMA in f32 (common.cuh); bf16 values are rounded at the TPU
// kernel's points (h, y, out). Any T works.
#include "common.cuh"

using namespace stts;

namespace {

template <typename T>
cudaError_t run(const T* x, const T* mods, const float* mask, const T* w1, const T* b1, const T* w2, const T* b2,
                T* h, T* y, T* out, int B, int Tn, int C, int F, float eps, cudaStream_t s) {
  const int M = B * Tn;
  launch_ln_mod<T, T>(x, mods, 3, 0, 1, mask, h, M, Tn, C, eps, s);
  launch_tap_gemm<T>(conv_gemm(h, C, w1, F, M, Tn, 3, false), Conv1Epi<T>{b1, mask, y, F}, s);
  launch_tap_gemm<T>(conv_gemm(y, F, w2, C, M, Tn, 3, false), Conv2Epi<T, T>{b2, mods, 3, 2, mask, x, out, C, Tn}, s);
  return cudaGetLastError();
}

}  // namespace

extern "C" int adaln_ffn_forward(const void* x, const void* mods, const void* mask, const void* w1, const void* b1,
                                 const void* w2, const void* b2, void* h, void* y, void* out, int B, int T, int C,
                                 int F, int is_bf16, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mk = static_cast<const float*>(mask);
#define STTS_ARGS(TY)                                                                                  \
  (const TY*)x, (const TY*)mods, mk, (const TY*)w1, (const TY*)b1, (const TY*)w2, (const TY*)b2, (TY*)h, \
      (TY*)y, (TY*)out, B, T, C, F, eps, s
  cudaError_t err = is_bf16 ? run<bf16>(STTS_ARGS(bf16)) : run<float>(STTS_ARGS(float));
#undef STTS_ARGS
  return (int)err;
}
