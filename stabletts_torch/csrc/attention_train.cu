// Packed-head attention for training on Hopper (sm_90a), forward and backward:
//
//   o = drop(softmax(q k^T / sqrt(D) + kbias)) v        per head, q/k/v [B, T, H*D]
//
// Replaces: the JAX package's ops/attention_pallas_train.py::
// fused_attention_train (a custom-VJP pair of Pallas kernels: one grid cell per
// (item, query block) holds all of K and V and one head's [blk_q, T] scores in
// VMEM; the backward recomputes the softmax from the inputs and accumulates
// dK and dV across query blocks in a revisited f32 block).
//
// What bounds it on the H100: arithmetic. Forward 4*B*H*T^2*D FLOPs (two
// products), backward 2.5x that (five products; the bf16 kernels recompute
// the scores in both backward kernels, seven products; f32 makes the five);
// q, k, v and o are 4 * B*T*C values, 131 MB in f32 at B=32, T=1000, C=256
// against 32.8 GFLOP forward. bf16 runs every product on the tensor cores
// (attention_train.cuh's wgmma kernels), and there the dropout's Philox work,
// which this bound does not count (B*H*T^2/4 calls a pass: one pass forward,
// two backward in bf16, one in f32), is a large share of the time; f32 runs
// on the FMA units.
//
// Design (attention_train.cuh, shared with the DiT block's attention half). A
// CTA has 227 KB, so all of K and V do not stay on chip as they do in VMEM:
// attention is tiled flash-style over 64-key tiles and no [B, H, T, T] tensor
// reaches device memory in the forward or is saved for the backward. The forward saves, besides its
// output, the per-row log-sum-exp [B, H, T] (the TPU kernel keeps only its
// inputs and recomputes max and sum; the log-sum-exp is 0.4% of the inputs'
// size and saves the backward a pass over the keys) and, in bf16, the
// output's rounding remainder o_lo (attention_train.cuh says why). The backward is
// FlashAttention-2: D = rowsum(do * o) (equal to the TPU kernel's
// sum(dp * p)), one kernel per key tile for dK and dV, one per query tile for
// dQ (in f32 a product over the dS^T that the dK/dV kernel writes to a
// workspace, attention_train.cuh); nothing is accumulated across CTAs, so
// there are no atomics and every run gives the same sums.
// Numerics kept from the TPU kernel: raw q and k, the f32 scores scaled by
// 1/sqrt(D) after the product; key bias -0.7*f32max on padded keys; padded
// query rows are garbage by contract; in bf16 the dropped weights are rounded
// before the PV product and ds before its products; dK and dV accumulate in
// f32 and are rounded once. Dropout bits are Philox (common.cuh) under the
// call's key, not the TPU's PRNG: keep ~ Bernoulli(1 - rate) per (b, h, q, k),
// kept weights scaled by 1/(1 - rate), the same mask in both directions.
#include "attention_train.cuh"

using namespace stts;
using namespace stts::atr;

extern "C" int attention_train_forward(const void* q, const void* k, const void* v, const void* mask,
                                       const void* seed, void* o, void* o_lo, void* lse, int B, int T, int C,
                                       int H, int is_bf16, int thresh, int row0, float keep_scale, void* stream) {
  if (H <= 0 || C != H * HD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Dropout drop = make_dropout(seed, thresh, keep_scale, row0);
  const float* mk = static_cast<const float*>(mask);
  float* ls = static_cast<float*>(lse);
  const float sm_scale = 1.f / sqrtf((float)HD);
  if (is_bf16)
    launch_attn_fwd<bf16>((const bf16*)q, (const bf16*)k, (const bf16*)v, mk, (bf16*)o, (bf16*)o_lo, ls, B, T, C,
                          H, sm_scale, drop, s);
  else
    launch_attn_fwd<float>((const float*)q, (const float*)k, (const float*)v, mk, (float*)o, nullptr, ls, B, T, C,
                           H, sm_scale, drop, s);
  return (int)cudaGetLastError();
}

extern "C" int attention_train_backward(const void* q, const void* k, const void* v, const void* mask,
                                        const void* seed, const void* o, const void* o_lo, const void* lse,
                                        const void* d_o, void* Dv, void* dq, void* dk, void* dv, void* ds_ws, int B,
                                        int T, int C, int H,
                                        int is_bf16, int thresh, int row0, float keep_scale, void* stream) {
  if (H <= 0 || C != H * HD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Dropout drop = make_dropout(seed, thresh, keep_scale, row0);
  const float* mk = static_cast<const float*>(mask);
  const float* ls = static_cast<const float*>(lse);
  float* dvr = static_cast<float*>(Dv);
  const float sm_scale = 1.f / sqrtf((float)HD);
  if (is_bf16)
    launch_attn_bwd<bf16>((const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o, (const bf16*)o_lo,
                          (const bf16*)d_o, ls, mk, dvr, (bf16*)dq, (bf16*)dk, (bf16*)dv, C, nullptr, B, T, C, H,
                          sm_scale, drop, s);
  else
    launch_attn_bwd<float>((const float*)q, (const float*)k, (const float*)v, (const float*)o, nullptr,
                           (const float*)d_o, ls, mk, dvr, (float*)dq, (float*)dk, (float*)dv, C,
                           static_cast<float*>(ds_ws), B, T, C, H, sm_scale, drop, s);
  return (int)cudaGetLastError();
}
