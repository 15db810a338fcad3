// The inference DiT block's attention half on Hopper (sm_90a).
//
//   out = x + gate * (softmax(rope(q) rope(k)^T / sqrt(D) + key_bias) v @ Wo + bo) * m,
//   q, k, v = modulate(LN(x)) @ W{q,k,v} + b{q,k,v}
//
// Replaces: the JAX package's ops/dit_attention_pallas.py::fused_dit_attention
// (one Pallas kernel per batch element holding the [T, C] tile and a [T, T]
// score tile per head in VMEM).
//
// What bounds it on the H100: arithmetic, 2*b*t*c*4c (projections) +
// 4*b*H*t^2*D (attention) FLOPs, 2.58e10 at b=16, T=1024, against 2*b*t*c
// activation elements. A [T, T] f32 score tile is 4 MB at T=1024 and a CTA has
// 227 KB, so T is tiled with an online softmax.
//
// Design: steps 1-4 of the whole block (dit_block.cu) as four launches on one
// stream, sharing its device code:
//   1. LN + modulate            (one warp per row)
//   2. QKV projection; log2(e)/sqrt(D) folded into q, rounding to T and
//      partial RoPE (rotary dim D/2, concatenated halves) in the epilogue
//   3. attention per (batch, head, 64-query tile), exp2 online softmax over
//      64-key tiles (attention.cuh)
//   4. out-projection + gated residual, rounded to x's type (the whole block
//      keeps this value in f32 instead: one rounding apart in bf16)
// mods is [B, 3, C]: shift, scale, gate. In bf16 every product runs on wgmma
// (the tap GEMMs of common.cuh, the attention of attention.cuh), in f32 on
// fp32 FMA. Any T works.
#include "attention.cuh"

using namespace stts;

namespace {

template <typename T>
cudaError_t run(const T* x, const T* mods, const float* mask, const float* cos_t, const float* sin_t, const T* wqkv,
                const T* bqkv, const T* wo, const T* bo, T* h, T* q, T* k, T* v, T* att, T* out, int B, int Tn,
                int C, int H, float eps, cudaStream_t s) {
  const int M = B * Tn, D = C / H;
  launch_ln_mod<T, T>(x, mods, 3, 0, 1, nullptr, h, M, Tn, C, eps, s);
  TapGemm g = conv_gemm(h, C, wqkv, 3 * C, M, Tn, 1, false);
  launch_tap_gemm<T>(g, QkvEpi<T>{bqkv, q, k, v, cos_t, sin_t, C, D, D / 4, Tn, kLog2e / sqrtf((float)D)}, s);
  launch_attention<T, false>(q, k, v, mask, att, B, Tn, H, 1.f, s);
  launch_tap_gemm<T>(conv_gemm(att, C, wo, C, M, Tn, 1, false),
                     OutProjEpi<T, T>{bo, x, mods, 3, 2, mask, out, C, Tn}, s);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dit_attention_forward(const void* x, const void* mods, const void* mask, const void* cos_t,
                                     const void* sin_t, const void* wqkv, const void* bqkv, const void* wo,
                                     const void* bo, void* h, void* q, void* k, void* v, void* att, void* out,
                                     int B, int T, int C, int H, int is_bf16, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mk = static_cast<const float*>(mask);
  const float* cs = static_cast<const float*>(cos_t);
  const float* sn = static_cast<const float*>(sin_t);
  if (H <= 0 || C != H * ATT_D) return (int)cudaErrorInvalidValue;
#define STTS_ARGS(TY)                                                                                   \
  (const TY*)x, (const TY*)mods, mk, cs, sn, (const TY*)wqkv, (const TY*)bqkv, (const TY*)wo, (const TY*)bo, \
      (TY*)h, (TY*)q, (TY*)k, (TY*)v, (TY*)att, (TY*)out, B, T, C, H, eps, s
  cudaError_t err = is_bf16 ? run<bf16>(STTS_ARGS(bf16)) : run<float>(STTS_ARGS(float));
#undef STTS_ARGS
  return (int)err;
}
