// The Vocos ISTFT head on Hopper (sm_90a): windowed iDFT product +
// overlap-add + envelope + trim in one kernel.
//
// Replaces: the JAX package's ops/istft_pallas.py::istft_same_fused (reached via
// istft_same_fused_diff), which keeps a batch element's [T, n_fft] frames in
// VMEM and overlap-adds them there.
//
// What bounds it on the H100: arithmetic. 2*b*T*(n_fft+2)*n_fft FLOPs (8.6
// GFLOP at b=1, T=1024) against b*T*(n_fft+2) spectrum values in and b*T*hop
// samples out; an f32 spectrum needs true-f32 products (no TF32).
//
// Design: output row i (hop samples) of the untrimmed signal is
//   sum_{j < r} spec[i - j] @ W[:, j*hop:(j+1)*hop],   r = n_fft / hop,
// which is a tap GEMM with r taps reading rows shifted by -j and weight
// columns offset by j*hop. A CTA computes a 64-row x 64-sample tile of that
// directly, so the [B, T, n_fft] frames never reach device memory. The
// epilogue multiplies by the reciprocal envelope (static: precomputed on the
// host in float64; lengths mode: summed in-kernel over each item's valid
// frames) and writes only samples inside the trimmed window. In bf16 the tap
// GEMM runs on wgmma, its spectrum rows copied element by element (lda =
// n_fft/2 + 1 is odd); in f32 on fp32 FMA (common.cuh).
#include "common.cuh"

using namespace stts;

namespace {

struct IstftEpi {
  float* out;          // [B, T * hop]
  const float* envinv; // [(T + r - 1) * hop]  (static envelope)
  const float* wsq;    // [n_fft] window^2    (lengths mode)
  const int* lens;     // [B] or nullptr
  int T_, t_out, hop, r, pad;
  __device__ float prep(int m, int n, float acc) const { return acc; }
  __device__ void store(int m, int n, const float* tile, int rr, int c) const {
    int b = m / t_out, i = m % t_out;
    long long s = (long long)i * hop + n - pad;
    if (s < 0 || s >= (long long)T_ * hop) return;
    float y = tile[rr * (GEMM_BN + 1) + c];
    if (lens) {
      int len = min(lens[b], T_);
      float env = 0.f;
      for (int j = 0; j < r; ++j) {
        int f = i - j;
        if (f >= 0 && f < len) env += wsq[j * hop + n];
      }
      y = y / fmaxf(env, 1e-11f);
    } else {
      y = y * envinv[(long long)i * hop + n];
    }
    out[(long long)b * T_ * hop + s] = y;
  }
};

template <typename T>
cudaError_t run(const T* re, const T* im, const T* w, const float* envinv, const float* wsq,
                const int* lens, float* out, int B, int Tn, int n_fft, int hop, cudaStream_t stream) {
  const int nf = n_fft / 2 + 1, r = n_fft / hop;
  TapGemm g{};
  g.a0 = re; g.a1 = im; g.k_split = nf; g.lda = nf;
  g.t_in = Tn; g.t_out = Tn + r - 1; g.k_in = 2 * nf;
  g.taps = r; g.shift0 = 0; g.shift_step = -1; g.row_len = lens;
  g.w = w; g.w_tap_stride = hop; g.ldw = n_fft;
  g.M = B * (Tn + r - 1); g.N = hop;
  IstftEpi e{out, envinv, wsq, lens, Tn, Tn + r - 1, hop, r, (n_fft - hop) / 2};
  launch_tap_gemm<T>(g, e, stream);
  return cudaGetLastError();
}

}  // namespace

extern "C" int istft_forward(const void* re, const void* im, const void* w, const void* envinv,
                             const void* wsq, const void* lens, void* out, int B, int T, int n_fft,
                             int hop, int use_lengths, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ln = use_lengths ? static_cast<const int*>(lens) : nullptr;
  const float* ei = static_cast<const float*>(envinv);
  const float* ws = static_cast<const float*>(wsq);
  float* o = static_cast<float*>(out);
  cudaError_t err = is_bf16
      ? run<bf16>((const bf16*)re, (const bf16*)im, (const bf16*)w, ei, ws, ln, o, B, T, n_fft, hop, s)
      : run<float>((const float*)re, (const float*)im, (const float*)w, ei, ws, ln, o, B, T, n_fft, hop, s);
  return (int)err;
}
