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
//   2. QKV projection + q scale + RoPE epilogue (the first 2*rot_half
//      features of each head; D/2 in StableTTS, D in F5-TTS) (tap GEMM, 1 tap)
//   3. attention per (batch, head, query tile), online softmax in exp2
//      over 64-key tiles, so no score tile larger than 64x64 exists (f32:
//      only the key tiles that hold a valid key, and zeros for a query tile
//      of padded rows, which step 4's `* m` removes)
//   4. out-projection + gated residual x1 = x + gate*out*m, kept in f32
//   5. LN2 + modulate + mask     (one warp per row)
//   6. conv k=taps C->F + activation + mask (tap GEMM; taps = 3: rows
//      shifted -1..+1, zero outside [0, T), SiLU (StableTTS); taps = 1: a
//      dense layer, GELU tanh (F5-TTS))
//   7. conv k=taps F->C + mask + gated residual           (tap GEMM, taps taps)
// In bf16 every product runs on wgmma (the tap GEMMs of common.cuh, the
// attention of attention.cuh), in f32 on fp32 FMA; bf16 values are rounded at
// the TPU kernel's points. Any T works (ragged tiles are masked).
#include "attention.cuh"

using namespace stts;

namespace {

// Steps 1 and 5 are common.cuh's ln_mod_kernel; the epilogues of steps 2, 4, 6
// and 7 are its QkvEpi, OutProjEpi, Conv1Epi (act 0, SiLU) or Conv1GeluEpi
// (act 1, GELU tanh) and Conv2Epi; step 3 is attention.cuh's core on the
// pre-scaled q (score scale 1). Any head count H with C = 64 H.

template <typename T>
cudaError_t run_block(const T* x, const T* mods, const float* mask, const float* cos_t,
                      const float* sin_t, const T* wqkv, const T* bqkv, const T* wo, const T* bo,
                      const T* w1, const T* b1, const T* w2, const T* b2, T* h, T* q, T* k, T* v,
                      T* att, float* x1, T* h2, T* y, T* out, int B, int Tn, int C, int F, int H,
                      int taps, int act, int rot_half, float eps, cudaStream_t stream) {
  const int M = B * Tn, D = C / H;

  launch_ln_mod<T, T>(x, mods, 6, 0, 1, nullptr, h, M, Tn, C, eps, stream);

  TapGemm g{};
  g.a0 = h; g.a1 = h; g.k_split = C; g.lda = C; g.t_in = Tn; g.t_out = Tn; g.k_in = C;
  g.taps = 1; g.shift0 = 0; g.shift_step = 0; g.row_len = nullptr;
  g.w = wqkv; g.w_tap_stride = 0; g.ldw = 3 * C; g.M = M; g.N = 3 * C;
  QkvEpi<T> qe{bqkv, q, k, v, cos_t, sin_t, C, D, rot_half, Tn, kLog2e / sqrtf((float)D)};
  launch_tap_gemm<T>(g, qe, stream);

  launch_attention<T, false>(q, k, v, mask, att, B, Tn, H, 1.f, stream);

  g.a0 = att; g.a1 = att; g.w = wo; g.ldw = C; g.N = C;
  OutProjEpi<T, float> oe{bo, x, mods, 6, 2, mask, x1, C, Tn};
  launch_tap_gemm<T>(g, oe, stream);

  launch_ln_mod<float, T>(x1, mods, 6, 3, 4, mask, h2, M, Tn, C, eps, stream);

  g.a0 = h2; g.a1 = h2; g.taps = taps; g.shift0 = -(taps / 2); g.shift_step = 1;
  g.w = w1; g.w_tap_stride = (long long)C * F; g.ldw = F; g.N = F;
  if (act == 1) {
    Conv1GeluEpi<T> c1{b1, mask, y, F};
    launch_tap_gemm<T>(g, c1, stream);
  } else {
    Conv1Epi<T> c1{b1, mask, y, F};
    launch_tap_gemm<T>(g, c1, stream);
  }

  g.a0 = y; g.a1 = y; g.k_split = F; g.lda = F; g.k_in = F;
  g.w = w2; g.w_tap_stride = (long long)F * C; g.ldw = C; g.N = C;
  Conv2Epi<T, float> c2{b2, mods, 6, 5, mask, x1, out, C, Tn};
  launch_tap_gemm<T>(g, c2, stream);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dit_block_forward(const void* x, const void* mods, const void* mask, const void* cos_t,
                                 const void* sin_t, const void* wqkv, const void* bqkv, const void* wo,
                                 const void* bo, const void* w1, const void* b1, const void* w2,
                                 const void* b2, void* h, void* q, void* k, void* v, void* att, void* x1,
                                 void* h2, void* y, void* out, int B, int T, int C, int F, int H,
                                 int taps, int act, int rot_half, int is_bf16, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mk = static_cast<const float*>(mask);
  const float* cs = static_cast<const float*>(cos_t);
  const float* sn = static_cast<const float*>(sin_t);
  float* x1f = static_cast<float*>(x1);
  if (C / H != ATT_D || (taps != 1 && taps != 3) || (act != 0 && act != 1) || rot_half < 1 ||
      2 * rot_half > ATT_D)
    return (int)cudaErrorInvalidValue;
#define STTS_ARGS(TY)                                                                              \
  (const TY*)x, (const TY*)mods, mk, cs, sn, (const TY*)wqkv, (const TY*)bqkv, (const TY*)wo,       \
      (const TY*)bo, (const TY*)w1, (const TY*)b1, (const TY*)w2, (const TY*)b2, (TY*)h, (TY*)q,    \
      (TY*)k, (TY*)v, (TY*)att, x1f, (TY*)h2, (TY*)y, (TY*)out, B, T, C, F, H, taps, act, rot_half, eps, s
  cudaError_t err = is_bf16 ? run_block<bf16>(STTS_ARGS(bf16)) : run_block<float>(STTS_ARGS(float));
#undef STTS_ARGS
  return (int)err;
}
