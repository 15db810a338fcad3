// Packed-head attention on Hopper (sm_90a), in both operand layouts.
//
//   out_h = softmax(q_h k_h^T / sqrt(D) + key_bias) v_h   per head h, D = 64
//
// Replaces: the JAX package's ops/attention_pallas.py::fused_attention_packed
// (operands [B, T, H*D]) and ops/attention_pallas_t.py::fused_attention_packed_t
// (operands [B, H*D, T], softmax over the key axis). The TPU kernels keep a
// [blk_q, T] score tile and the whole K/V of an item in VMEM and pad T to 128.
//
// What bounds it on the H100: arithmetic, 4*b*H*t^2*D FLOPs (1.72e10 at b=16,
// T=1024, H=4) against 4*b*t*H*D elements moved.
//
// Design: attention.cuh's kernels, one CTA per (query tile, head, batch item)
// with an online softmax over 64-key tiles; ragged tiles are masked, so any T
// works without padding. In f32 the tiles of padded keys are skipped and a
// tile of padded queries is written as zeros (its callers mask those rows). q and k arrive rotated and unscaled: the f32 scores
// are multiplied by log2(e)/sqrt(D) and the softmax runs in exp2 (the TPU
// kernel scales by 1/sqrt(D) and uses exp: the same weights up to f32
// rounding). mask is [B, T] f32 or null (every key valid); only keys are
// masked. The channel-major entry point loads its tiles and writes its result
// with those strides (t contiguous); nothing is transposed in device memory.
#include "attention.cuh"

using namespace stts;

namespace {

template <bool TMINOR>
int run(const void* q, const void* k, const void* v, const void* mask, void* out, int B, int T, int C, int H,
        int is_bf16, void* stream) {
  if (H <= 0 || C != H * ATT_D || B <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mk = static_cast<const float*>(mask);
  const float scale = kLog2e / sqrtf((float)ATT_D);
  if (is_bf16)
    launch_attention<bf16, TMINOR>((const bf16*)q, (const bf16*)k, (const bf16*)v, mk, (bf16*)out, B, T, H, scale, s);
  else
    launch_attention<float, TMINOR>((const float*)q, (const float*)k, (const float*)v, mk, (float*)out, B, T, H,
                                    scale, s);
  return (int)cudaGetLastError();
}

}  // namespace

// q/k/v/out [B, T, C]
extern "C" int attention_packed_forward(const void* q, const void* k, const void* v, const void* mask, void* out,
                                        int B, int T, int C, int H, int is_bf16, void* stream) {
  return run<false>(q, k, v, mask, out, B, T, C, H, is_bf16, stream);
}

// q/k/v/out [B, C, T]
extern "C" int attention_packed_t_forward(const void* q, const void* k, const void* v, const void* mask, void* out,
                                          int B, int T, int C, int H, int is_bf16, void* stream) {
  return run<true>(q, k, v, mask, out, B, T, C, H, is_bf16, stream);
}
