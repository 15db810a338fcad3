// The packed-head attention variants of the attention microbenchmark, on
// Hopper (sm_90a): one instantiation of attention.cuh's core each.
//
//   attention_packed_v2_forward    out_h = softmax2(q'_h k_h^T + key_bias) v_h, q' = round(q * log2(e)/sqrt(D))
//   attention_packed_rope_forward  the same on RoPE(q'), RoPE(k): partial RoPE on load
//   attention_packed_kt_forward    the v2 function with K given channel-major, [B, C, T]
//   attention_decompose_forward    the v2 product with another softmax: which = 0 none
//                                  (out = round(q' k^T) v), 1 no max (exp2(s + bias)),
//                                  2 bf16 scores (scores, max and weights in bf16)
//
// Replaces: the JAX package's ops/attention_pallas_v2.py::fused_attention_packed,
// ops/attention_pallas.py::fused_attention_packed_rope,
// tools/attn_exp4.py::run_kt and tools/attn_exp2.py::run (its four bodies;
// "nomax_bf16" computes what "nomax" does). The TPU kernels keep a [blk_q, T]
// score tile and the whole K/V of an item in VMEM and pad T to their block.
//
// What bounds them on the H100: arithmetic, 4*B*H*T^2*D FLOPs (6.6e10 at the
// tools' B=64, T=1000, H=4) against 4*B*T*H*D elements moved; RoPE adds
// 3 operations per element of q and k, the bf16-score mode a second QK^T.
//
// Design: attention.cuh's kernel, one CTA per (64-query tile, head, batch
// item), 64-key tiles, wgmma in bf16 and fp32 FMA in f32; q is pre-scaled and rounded on load (QPRE),
// so scores are in log2 units and the key bias is added unscaled. RoPE
// rotates the q tile once and every K tile once per q tile, from [T, C]
// cos/sin tables in q's dtype, rounding each product and the sum through the
// dtype as the TPU kernel does (its permutation matmul is exact, so a signed
// copy of feature d -/+ rot/2 stands in for it). The channel-major K is read
// with t contiguous; nothing is transposed in device memory. The bf16-score
// mode takes each row's max in a first pass over the key tiles, so every
// weight rounds against the final max as in the TPU kernel. mask is [B, T]
// f32 or null (every key valid); only keys are masked.
#include "attention.cuh"

using namespace stts;

namespace {

bool bad_shape(int B, int T, int C, int H) { return H <= 0 || C != H * ATT_D || B <= 0 || T <= 0; }

template <bool ROPE, bool KTMINOR, int MODE>
int run(const void* q, const void* k, const void* v, const void* mask, const void* cosv, const void* sinv,
        void* out, int B, int T, int H, int rot, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mk = static_cast<const float*>(mask);
  if (is_bf16)
    launch_attention<bf16, false, true, ROPE, KTMINOR, MODE>((const bf16*)q, (const bf16*)k, (const bf16*)v, mk,
                                                             (bf16*)out, B, T, H, 1.f, s, (const bf16*)cosv,
                                                             (const bf16*)sinv, rot);
  else
    launch_attention<float, false, true, ROPE, KTMINOR, MODE>((const float*)q, (const float*)k, (const float*)v,
                                                              mk, (float*)out, B, T, H, 1.f, s,
                                                              (const float*)cosv, (const float*)sinv, rot);
  return (int)cudaGetLastError();
}

}  // namespace

// q/k/v/out [B, T, C]
extern "C" int attention_packed_v2_forward(const void* q, const void* k, const void* v, const void* mask, void* out,
                                           int B, int T, int C, int H, int is_bf16, void* stream) {
  if (bad_shape(B, T, C, H)) return (int)cudaErrorInvalidValue;
  return run<false, false, SM_ONLINE>(q, k, v, mask, nullptr, nullptr, out, B, T, H, 0, is_bf16, stream);
}

// q/k/v/out [B, T, C] unrotated; cos/sin [T, C] in q's dtype; rot even, <= 64
extern "C" int attention_packed_rope_forward(const void* q, const void* k, const void* v, const void* mask,
                                             const void* cosv, const void* sinv, void* out, int B, int T, int C,
                                             int H, int rot, int is_bf16, void* stream) {
  if (bad_shape(B, T, C, H) || rot < 0 || rot > ATT_D || rot % 2) return (int)cudaErrorInvalidValue;
  return run<true, false, SM_ONLINE>(q, k, v, mask, cosv, sinv, out, B, T, H, rot, is_bf16, stream);
}

// q/v/out [B, T, C]; kt [B, C, T]
extern "C" int attention_packed_kt_forward(const void* q, const void* kt, const void* v, const void* mask, void* out,
                                           int B, int T, int C, int H, int is_bf16, void* stream) {
  if (bad_shape(B, T, C, H)) return (int)cudaErrorInvalidValue;
  return run<false, true, SM_ONLINE>(q, kt, v, mask, nullptr, nullptr, out, B, T, H, 0, is_bf16, stream);
}

// q/k/v/out [B, T, C], every key valid; which: 0 product only, 1 no max, 2 bf16 scores
extern "C" int attention_decompose_forward(const void* q, const void* k, const void* v, void* out, int B, int T,
                                           int C, int H, int which, int is_bf16, void* stream) {
  if (bad_shape(B, T, C, H)) return (int)cudaErrorInvalidValue;
  switch (which) {
    case 0: return run<false, false, SM_NONE>(q, k, v, nullptr, nullptr, nullptr, out, B, T, H, 0, is_bf16, stream);
    case 1: return run<false, false, SM_NOMAX>(q, k, v, nullptr, nullptr, nullptr, out, B, T, H, 0, is_bf16, stream);
    case 2:
      return run<false, false, SM_SCORE_LOWP>(q, k, v, nullptr, nullptr, nullptr, out, B, T, H, 0, is_bf16, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
