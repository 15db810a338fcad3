// The estimator's mu prenet for training on Hopper (sm_90a), forward and
// backward:
//
//   out = conv_c(silu(conv_b(silu(conv_a(mu)))))     k=3, zero outside [0, T),
//                                                    Cin -> F -> F -> Cout
//
// unmasked, no dropout, no LayerNorm. Replaces: the JAX package's
// ops/prenet_pallas_train.py::fused_prenet_train (a custom-VJP pair of Pallas
// kernels, one grid cell per batch item holding its [T, F] activations in
// VMEM; the backward recomputes y1 and y2 and accumulates the six parameter
// gradients across grid cells in revisited f32 blocks).
//
// What bounds it on the H100: arithmetic. Forward 6*B*T*(Cin*F + F*F + F*Cout)
// FLOPs; backward twice that (an input gradient and a weight gradient for
// each conv) plus conv_a and conv_b again for the recompute, 6*B*T*(Cin*F +
// F*F); at B=32, T=1000, Cin=128, F=1024, Cout=256 that is 277 GFLOP forward
// and 780 GFLOP backward against 49 MB of mu in and out written (f32). The middle conv's [3, 1024, 1024] weight gradient alone is 201
// GFLOP, the largest weight-gradient GEMM of the training step.
//
// Design. A CTA has 227 KB and one item's [T, F] f32 activations are 4 MB, so
// the TPU's whole-item tile does not carry over; every product is a 64 x
// 64-tile "tap GEMM" (common.cuh) over all B*T rows with the pointwise work in
// its epilogue. The row shift of a tap is taken inside each item (row t of
// item b), so the zero padding sits at rows -1 and T of every item and no tap
// reads across items.
//   forward:  conv_a (+ba, SiLU) -> h1; conv_b (+bb, SiLU) -> h2; conv_c (+bc).
//   backward: recompute y1, h1, y2, h2 as the TPU kernel does (nothing of size
//             [B, T, F] is kept between the passes; the price is the two
//             large forward convs again), then layer by layer from the
//             output: dW by the transposed tap GEMM over the B*T rows in
//             chunks (launch_wgrad: fixed order, no atomics), db by
//             fixed-order column sums, the input gradient by the tap GEMM
//             against W^T with the SiLU derivative in its epilogue.
// Tap convention (ffn_pallas.py::_conv3): y[t] = h[t-1] w0 + h[t] w1 + h[t+1]
// w2, so dh[t] = dy[t+1] w0^T + dy[t] w1^T + dy[t-1] w2^T and dW[j] = sum_t
// h[t-1+j]^T dy[t]. The tap GEMMs run on wgmma in bf16 and on fp32 FMA in
// f32, and so do the weight gradients; in bf16 the values are
// rounded where the TPU kernel rounds them (h1, h2, dy2, dy1, dmu); y1 and y2
// stay f32; parameter gradients are f32.
#include "common.cuh"

#include <math.h>

using namespace stts;

namespace {

// conv epilogue: y = acc + bias (kept in f32 when y_out is given); h = round(silu(y))
template <typename T>
struct SiluEpi {
  const T* bias;
  float* y_out;  // nullptr in the forward
  T* h;
  int N;
  __device__ float prep(int m, int n, float acc) const { return acc + to_f(bias[n]); }
  __device__ void store(int m, int n, const float* tile, int r, int c) const {
    float y = tile[r * (GEMM_BN + 1) + c];
    const long long i = (long long)m * N + n;
    if (y_out) y_out[i] = y;
    h[i] = from_f<T>(y / (1.f + expf(-y)));
  }
};

// last conv: out = round(acc + bias)
template <typename T>
struct BiasEpi {
  const T* bias;
  T* out;
  int N;
  __device__ float prep(int m, int n, float acc) const { return acc + to_f(bias[n]); }
  __device__ void store(int m, int n, const float* tile, int r, int c) const {
    out[(long long)m * N + n] = from_f<T>(tile[r * (GEMM_BN + 1) + c]);
  }
};

// input-gradient epilogue: dy = round(dh * silu'(y)); with y == nullptr the
// product is stored as it is (dmu)
template <typename T>
struct SiluBwdEpi {
  const float* y;
  T* dy;
  int N;
  __device__ float prep(int m, int n, float acc) const { return acc; }
  __device__ void store(int m, int n, const float* tile, int r, int c) const {
    const long long i = (long long)m * N + n;
    float d = tile[r * (GEMM_BN + 1) + c];
    if (y) {
      float yy = y[i];
      float sig = 1.f / (1.f + expf(-yy));
      d *= sig * (1.f + yy * (1.f - sig));
    }
    dy[i] = from_f<T>(d);
  }
};

template <typename T>
cudaError_t forward(const T* mu, const T* wa, const T* ba, const T* wb, const T* bb, const T* wc, const T* bc,
                    T* h1, T* h2, T* out, int B, int Tn, int Cin, int F, int Cout, cudaStream_t s) {
  const int M = B * Tn;
  launch_tap_gemm<T>(conv_gemm(mu, Cin, wa, F, M, Tn, 3, false), SiluEpi<T>{ba, nullptr, h1, F}, s);
  launch_tap_gemm<T>(conv_gemm(h1, F, wb, F, M, Tn, 3, false), SiluEpi<T>{bb, nullptr, h2, F}, s);
  launch_tap_gemm<T>(conv_gemm(h2, F, wc, Cout, M, Tn, 3, false), BiasEpi<T>{bc, out, Cout}, s);
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward(const T* mu, const T* wa, const T* ba, const T* wb, const T* bb, const T* wc, const T* d_o,
                     float* y1, T* h1, float* y2, T* h2, T* dy2, T* dy1, T* dmu, float* dwa, float* dba,
                     float* dwb, float* dbb, float* dwc, float* dbc, float* ws, long long ws_floats, int B, int Tn,
                     int Cin, int F, int Cout, cudaStream_t s) {
  const int M = B * Tn;
  // recompute y1, h1, y2, h2
  launch_tap_gemm<T>(conv_gemm(mu, Cin, wa, F, M, Tn, 3, false), SiluEpi<T>{ba, y1, h1, F}, s);
  launch_tap_gemm<T>(conv_gemm(h1, F, wb, F, M, Tn, 3, false), SiluEpi<T>{bb, y2, h2, F}, s);
  // conv_c: dWc, dbc; dh2 = conv_c^T(do) -> dy2
  launch_wgrad<T>(WGrad{h2, F, F, d_o, Cout, Cout, M, Tn, -1, 1, dwc}, 3, ws, ws_floats, s);
  // the column sums reuse ws for their row-chunk partials: every launch here runs in order on one
  // stream, so a launch_wgrad's partials are summed before the next colsum writes its own
  launch_colsum<T>(d_o, dbc, 1, M, Cout, 0, ws, ws_floats, s);
  launch_tap_gemm<T>(conv_gemm(d_o, Cout, wc, F, M, Tn, 3, true), SiluBwdEpi<T>{y2, dy2, F}, s);
  // conv_b: dWb, dbb; dh1 = conv_b^T(dy2) -> dy1
  launch_wgrad<T>(WGrad{h1, F, F, dy2, F, F, M, Tn, -1, 1, dwb}, 3, ws, ws_floats, s);
  launch_colsum<T>(dy2, dbb, 1, M, F, 0, ws, ws_floats, s);
  launch_tap_gemm<T>(conv_gemm(dy2, F, wb, F, M, Tn, 3, true), SiluBwdEpi<T>{y1, dy1, F}, s);
  // conv_a: dWa, dba; dmu = conv_a^T(dy1)
  launch_wgrad<T>(WGrad{mu, Cin, Cin, dy1, F, F, M, Tn, -1, 1, dwa}, 3, ws, ws_floats, s);
  launch_colsum<T>(dy1, dba, 1, M, F, 0, ws, ws_floats, s);
  launch_tap_gemm<T>(conv_gemm(dy1, F, wa, Cin, M, Tn, 3, true), SiluBwdEpi<T>{nullptr, dmu, Cin}, s);
  return cudaGetLastError();
}

}  // namespace

extern "C" int prenet_train_forward(const void* mu, const void* wa, const void* ba, const void* wb, const void* bb,
                                    const void* wc, const void* bc, void* h1, void* h2, void* out, int B, int T,
                                    int Cin, int F, int Cout, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define STTS_ARGS(TY)                                                                                       \
  (const TY*)mu, (const TY*)wa, (const TY*)ba, (const TY*)wb, (const TY*)bb, (const TY*)wc, (const TY*)bc,  \
      (TY*)h1, (TY*)h2, (TY*)out, B, T, Cin, F, Cout, s
  cudaError_t err = is_bf16 ? forward<bf16>(STTS_ARGS(bf16)) : forward<float>(STTS_ARGS(float));
#undef STTS_ARGS
  return (int)err;
}

extern "C" int prenet_train_backward(const void* mu, const void* wa, const void* ba, const void* wb,
                                     const void* bb, const void* wc, const void* d_o, void* y1, void* h1,
                                     void* y2, void* h2, void* dy2, void* dy1, void* dmu, void* dwa, void* dba,
                                     void* dwb, void* dbb, void* dwc, void* dbc, void* ws, int B, int T, int Cin,
                                     int F, int Cout, int is_bf16, int ws_floats, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](void* p) { return static_cast<float*>(p); };
#define STTS_ARGS(TY)                                                                                          \
  (const TY*)mu, (const TY*)wa, (const TY*)ba, (const TY*)wb, (const TY*)bb, (const TY*)wc, (const TY*)d_o,    \
      f(y1), (TY*)h1, f(y2), (TY*)h2, (TY*)dy2, (TY*)dy1, (TY*)dmu, f(dwa), f(dba), f(dwb), f(dbb), f(dwc),    \
      f(dbc), f(ws), ws_floats, B, T, Cin, F, Cout, s
  cudaError_t err = is_bf16 ? backward<bf16>(STTS_ARGS(bf16)) : backward<float>(STTS_ARGS(float));
#undef STTS_ARGS
  return (int)err;
}
