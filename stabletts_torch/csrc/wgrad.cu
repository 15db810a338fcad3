// The weight-gradient GEMM and the column sums of common.cuh on their own:
//
//   wgrad_forward:  out[tap, m, n] = sum_r A(r, tap)[m] * G[r, n] in f32 under
//                   the WGrad contract (row r = b * t_len + t reads activation
//                   row t + shift0 + tap * shift_step of item b, zero outside
//                   [0, t_len)), the rows cut into chunks whose partials are
//                   added in chunk order (launch_wgrad);
//   colsum_forward: out[g, n] = sum_{r < rows} X[(g * rows + r) * N + n] in f32
//                   (launch_colsum).
//
// Replace no TPU kernel by themselves: they are the backward products and the
// bias / modulation gradient sums inside #11, #12 and #13 (where the TPU
// kernels' products ran on the MXU), exposed so that the card can time them
// and test their edges against `ops/tap_gemm_cuda.py::wgrad_plain` and
// `colsum_plain`. bf16 weight gradients run on wgmma, f32 on fp32 FMA; the
// column sums are one kernel for both types. Each entry takes its workspace
// from the caller; `wgrad_tile` names the weight gradient's CTA tile.
#include "common.cuh"

using namespace stts;

extern "C" int wgrad_forward(const void* a, const void* g, void* out, void* ws, int lda, int ka, int ldg, int n,
                             int rows, int t_len, int shift0, int shift_step, int taps, int ws_floats, int is_bf16,
                             void* stream) {
  WGrad p{a, lda, ka, g, ldg, n, rows, t_len, shift0, shift_step, static_cast<float*>(out), 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch_wgrad<bf16>(p, taps, static_cast<float*>(ws), ws_floats, s);
  else
    launch_wgrad<float>(p, taps, static_cast<float*>(ws), ws_floats, s);
  return (int)cudaGetLastError();
}

// BM (= BN) of the CTA tile (over ka x n) that launch_wgrad runs
extern "C" int wgrad_tile(int is_bf16) { return is_bf16 ? WGR_BM : FW_BM; }

extern "C" int colsum_forward(const void* x, void* out, void* ws, int groups, int rows, int N, int ws_floats,
                              int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* w = static_cast<float*>(ws);
  if (is_bf16)
    launch_colsum<bf16>(static_cast<const bf16*>(x), o, groups, rows, N, N, w, ws_floats, s);
  else
    launch_colsum<float>(static_cast<const float*>(x), o, groups, rows, N, N, w, ws_floats, s);
  return (int)cudaGetLastError();
}
