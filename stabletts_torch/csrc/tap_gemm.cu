// The tap GEMM of common.cuh on its own, with a plain store epilogue:
// out[m, n] = round_T(sum_tap sum_k A(m, tap, k) B(tap, k, n)) under the
// TapGemm contract (row-shifted and row-strided A, row_len, k_split, w_trans).
//
// Replaces no TPU kernel by itself: it is the product inside #1, #3, #4, #5,
// #11, #12, #13, #15 (strided) and ConvNeXt (where the TPU kernels' products ran
// on the MXU), exposed so that the card can time it and test its edges
// against `ops/tap_gemm_cuda.py::tap_gemm_plain`. bf16 runs on wgmma, f32 on
// fp32 FMA (see common.cuh); `tap_gemm_tile` names the CTA tile either runs
// and `tap_gemm_route` the bf16 kernel's path.
#include "common.cuh"

using namespace stts;

namespace {

template <typename T>
struct PlainStoreEpi {
  T* out;
  int N;
  __device__ float prep(int m, int n, float acc) const { return acc; }
  __device__ void store(int m, int n, const float* tile, int r, int c) const {
    out[(long long)m * N + n] = from_f<T>(tile[r * (GEMM_BN + 1) + c]);
  }
  __device__ void store8(int m, int n, const float* tile, int r, int c) const {
    T* dst = out + (long long)m * N + n;
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = tile[r * (GEMM_BN + 1) + c + i];
    if (chunk8(dst, N)) {
      st8(dst, v);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[i] = from_f<T>(v[i]);
    }
  }
};

}  // namespace

extern "C" int tap_gemm_forward(const void* a0, const void* a1, const void* row_len, const void* w, void* out,
                                int k_split, int lda, int t_in, int t_out, int k_in, int taps, int shift0,
                                int shift_step, int ldw, int M, int N, int w_trans, int w_tap_stride, int row_stride,
                                int is_bf16, void* stream) {
  TapGemm g{};
  g.a0 = a0; g.a1 = a1; g.k_split = k_split; g.lda = lda; g.t_in = t_in; g.t_out = t_out; g.k_in = k_in;
  g.taps = taps; g.shift0 = shift0; g.shift_step = shift_step; g.row_len = static_cast<const int*>(row_len);
  g.w = w; g.w_tap_stride = w_tap_stride; g.ldw = ldw; g.M = M; g.N = N; g.w_trans = w_trans;
  g.row_stride = row_stride;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch_tap_gemm<bf16>(g, PlainStoreEpi<bf16>{static_cast<bf16*>(out), N}, s);
  else
    launch_tap_gemm<float>(g, PlainStoreEpi<float>{static_cast<float*>(out), N}, s);
  return (int)cudaGetLastError();
}

// BN of the CTA tile that launch_tap_gemm runs for an M x N output (BM is
// 128 in bf16, BN in f32)
extern "C" int tap_gemm_tile(int M, int N, int is_bf16) {
  return is_bf16 ? tap_gemm_bn(M, N) : tap_gemm_f32_tile(M, N);
}

// The bf16 kernel's plan for tap_gemm_forward's arguments (no launch): 10 *
// BN + the path (0 TMA, 1 producer copy, 2 fallback), the tensor maps made
// as the launch makes them
extern "C" int tap_gemm_route(const void* a0, const void* a1, const void* row_len, const void* w, int k_split,
                              int lda, int t_in, int t_out, int k_in, int taps, int shift0, int shift_step, int ldw,
                              int M, int N, int w_trans, int w_tap_stride, int row_stride) {
  TapGemm g{};
  g.a0 = a0; g.a1 = a1; g.k_split = k_split; g.lda = lda; g.t_in = t_in; g.t_out = t_out; g.k_in = k_in;
  g.taps = taps; g.shift0 = shift0; g.shift_step = shift_step; g.row_len = static_cast<const int*>(row_len);
  g.w = w; g.w_tap_stride = w_tap_stride; g.ldw = ldw; g.M = M; g.N = N; g.w_trans = w_trans;
  g.row_stride = row_stride;
  const int bn = tap_gemm_bn(M, N);
  CUtensorMap ta, tw;
  return 10 * bn + tap_gemm_plan(g, bn, &ta, &tw);
}
