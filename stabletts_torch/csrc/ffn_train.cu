// The DiT block's FFN half for training on Hopper (sm_90a), forward and
// backward:
//
//   h   = (LN(x) * (1 + scale) + shift) * m                    (LN: no affine)
//   y   = conv1(h) + b1, k=3 (zero outside [0, T)),  C -> F
//   sd  = drop(silu(y)) * m                                    (Philox dropout)
//   out = x + gate * (conv2(sd) + b2) * m,            F -> C
//
// Replaces: the JAX package's ops/ffn_pallas_train.py::fused_adaln_ffn_train (a
// custom-VJP pair of Pallas kernels, one grid cell per batch element holding
// its [T, F] activations in VMEM; dW/db accumulate across grid cells in
// revisited f32 blocks; the backward regenerates the dropout mask from the
// seed and recomputes y).
//
// What bounds it on the H100: arithmetic. Forward 12*B*T*C*F FLOPs (two k=3
// convs), backward about 3x that (the conv1/conv2 recompute, two input
// gradients and two weight gradients); at B=32, T=1024, C=256, F=1024 that is
// 103 GFLOP forward against 34 MB of x in and out (f32).
//
// Design. A CTA has 227 KB and registers are scarce, so the TPU's whole-item
// tile does not carry over; every product is a 64 x 64-tile "tap GEMM"
// (common.cuh) over all B*T rows with its pointwise work in the epilogue:
//   forward:  LN+modulate+mask -> conv1 (+b1, SiLU, dropout, mask) -> conv2
//             (+b2, mask, gated residual)
//   backward: recompute h and y (the TPU kernel's recompute: nothing of size
//             [B, T, F] is saved between the passes), recompute conv2 for
//             dgate; dsd = conv2^T(dz) with the dropout and SiLU derivatives
//             in its epilogue; dh = conv1^T(dy); dW1, dW2 by the transposed
//             tap GEMM (the B*T rows cut into chunks, one CTA per output
//             tile and chunk, the partials added in chunk order: no atomics,
//             the same sums every run); db and the per-item
//             d{shift, scale, gate} by fixed-order column sums; then the
//             LayerNorm + modulate backward.
// Tap convention (ffn_pallas_train.py:26-28): y[t] = h[t-1] w0 + h[t] w1 +
// h[t+1] w2, so dh[t] = dy[t+1] w0^T + dy[t] w1^T + dy[t-1] w2^T and
// dW[j] = sum_t h[t-1+j]^T dy[t]. The tap GEMMs run on wgmma in bf16 and on
// fp32 FMA in f32, and so do the weight gradients; in bf16 the
// values are rounded where the TPU kernel rounds them (h, sd, dz, dy, dx).
// Dropout: element (b, t, f) keeps when Philox word f%4 of counter
// (f/4, t, b + row0, 1) under the call's key is >= thresh (row0: the batch's
// first row in a data-parallel step's global batch).
#include "common.cuh"

#include <math.h>

using namespace stts;

namespace {

// conv1 epilogue (forward and its recompute): y = acc + b1 kept in f32 when
// y_out is given; sd = round(silu(y) * keep * m)
template <typename T>
struct Conv1DropEpi {
  const T* bias;
  const float* mask;
  Dropout drop;
  float* y_out;  // nullptr in the forward
  T* sd;
  int F, T_;
  __device__ float prep(int m, int n, float acc) const { return acc + to_f(bias[n]); }
  __device__ void store(int m, int n, const float* tile, int r, int c) const {
    float y = tile[r * (GEMM_BN + 1) + c];
    float s = y / (1.f + expf(-y));
    if (drop.seed) s *= drop.factor(drop.bits(n >> 2, m % T_, m / T_ + drop.row0, 1u), n & 3);
    const long long i = (long long)m * F + n;
    if (y_out) y_out[i] = y;
    sd[i] = from_f<T>(s * mask[m]);
  }
};

// The forward conv2 epilogue is common.cuh's Conv2Epi: out = x + gate * (acc + b2) * m.

// conv2 recompute, backward: pz = do * z (summed into dgate), dz = do * gate * m
template <typename T>
struct Conv2BwdEpi {
  const T* bias;
  const T* dout;
  const T* mod;
  const float* mask;
  float* pz;
  float* dzf;
  T* dzc;
  int C, T_;
  __device__ float prep(int m, int n, float acc) const { return acc + to_f(bias[n]); }
  __device__ void store(int m, int n, const float* tile, int r, int c) const {
    const long long i = (long long)m * C + n;
    float gate = to_f(mod[((long long)(m / T_) * 3 + 2) * C + n]);
    float z = tile[r * (GEMM_BN + 1) + c] * mask[m];
    float d = to_f(dout[i]);
    pz[i] = d * z;
    float dz = d * gate * mask[m];
    dzf[i] = dz;
    dzc[i] = from_f<T>(dz);
  }
};

// dsd = conv2^T(dz) epilogue: through mask, dropout and SiLU -> dy
template <typename T>
struct DsdEpi {
  const float* mask;
  const float* y;
  Dropout drop;
  float* dyf;
  T* dyc;
  int F, T_;
  __device__ float prep(int m, int n, float acc) const { return acc; }
  __device__ void store(int m, int n, const float* tile, int r, int c) const {
    const long long i = (long long)m * F + n;
    float ds = tile[r * (GEMM_BN + 1) + c] * mask[m];
    if (drop.seed) ds *= drop.factor(drop.bits(n >> 2, m % T_, m / T_ + drop.row0, 1u), n & 3);
    float yy = y[i];
    float sig = 1.f / (1.f + expf(-yy));
    float dy = ds * (sig * (1.f + yy * (1.f - sig)));
    dyf[i] = dy;
    dyc[i] = from_f<T>(dy);
  }
};

// dh = conv1^T(dy) epilogue: dh0 = dh * m (f32)
struct DhEpi {
  const float* mask;
  float* dh0;
  int C;
  __device__ float prep(int m, int n, float acc) const { return acc; }
  __device__ void store(int m, int n, const float* tile, int r, int c) const {
    dh0[(long long)m * C + n] = tile[r * (GEMM_BN + 1) + c] * mask[m];
  }
};

template <typename T>
cudaError_t forward(const T* x, const T* mod, const float* mask, const T* w1, const T* b1, const T* w2,
                    const T* b2, Dropout drop, T* h, T* sd, T* out, int B, int Tn, int C, int F, float eps,
                    cudaStream_t s) {
  const int M = B * Tn;
  launch_ln_mod<T, T>(x, mod, 3, 0, 1, mask, h, M, Tn, C, eps, s);
  launch_tap_gemm<T>(conv_gemm(h, C, w1, F, M, Tn, 3, false), Conv1DropEpi<T>{b1, mask, drop, nullptr, sd, F, Tn}, s);
  launch_tap_gemm<T>(conv_gemm(sd, F, w2, C, M, Tn, 3, false), Conv2Epi<T, T>{b2, mod, 3, 2, mask, x, out, C, Tn}, s);
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward(const T* x, const T* mod, const float* mask, const T* w1, const T* b1, const T* w2,
                     const T* b2, Dropout drop, const T* dout, T* h, float* y, T* sd, float* pz, float* dzf,
                     T* dzc, float* dyf, T* dyc, float* dh0, float* dh0n, T* dx, float* dmod, float* dw1,
                     float* db1, float* dw2, float* db2, float* ws, long long ws_floats, int B, int Tn, int C,
                     int F, float eps, cudaStream_t s) {
  const int M = B * Tn;
  // recompute h, y and sd; recompute conv2 for dgate and form dz
  launch_ln_mod<T, T>(x, mod, 3, 0, 1, mask, h, M, Tn, C, eps, s);
  launch_tap_gemm<T>(conv_gemm(h, C, w1, F, M, Tn, 3, false), Conv1DropEpi<T>{b1, mask, drop, y, sd, F, Tn}, s);
  launch_tap_gemm<T>(conv_gemm(sd, F, w2, C, M, Tn, 3, false),
                     Conv2BwdEpi<T>{b2, dout, mod, mask, pz, dzf, dzc, C, Tn}, s);
  // conv2 backward: dsd -> dy (dropout + SiLU derivative); dW2, db2
  launch_tap_gemm<T>(conv_gemm(dzc, C, w2, F, M, Tn, 3, true), DsdEpi<T>{mask, y, drop, dyf, dyc, F, Tn}, s);
  launch_wgrad<T>(WGrad{sd, F, F, dzc, C, C, M, Tn, -1, 1, dw2}, 3, ws, ws_floats, s);
  // the column sums reuse ws for their row-chunk partials: every launch here runs in order on one
  // stream, so a launch_wgrad's partials are summed before the next colsum writes its own
  launch_colsum<float>(dzf, db2, 1, M, C, 0, ws, ws_floats, s);
  // conv1 backward: dh0 = conv1^T(dy) * m; dW1, db1
  launch_tap_gemm<T>(conv_gemm(dyc, F, w1, C, M, Tn, 3, true), DhEpi{mask, dh0, C}, s);
  launch_wgrad<T>(WGrad{h, C, C, dyc, F, F, M, Tn, -1, 1, dw1}, 3, ws, ws_floats, s);
  launch_colsum<float>(dyf, db1, 1, M, F, 0, ws, ws_floats, s);
  // modulate + LayerNorm backward; per-item d{shift, scale, gate} -> dmod [B, 3, C]
  launch_ln_bwd<T>(x, dh0, mod, 3, 1, dout, dx, dh0n, M, Tn, C, eps, s);
  launch_colsum<float>(dh0, dmod, B, Tn, C, 3LL * C, ws, ws_floats, s);
  launch_colsum<float>(dh0n, dmod + C, B, Tn, C, 3LL * C, ws, ws_floats, s);
  launch_colsum<float>(pz, dmod + 2 * C, B, Tn, C, 3LL * C, ws, ws_floats, s);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ffn_train_forward(const void* x, const void* mod, const void* mask, const void* w1, const void* b1,
                                 const void* w2, const void* b2, const void* seed, void* h, void* sd, void* out,
                                 int B, int T, int C, int F, int is_bf16, int thresh, int row0, float keep_scale, float eps,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mk = static_cast<const float*>(mask);
  Dropout drop = make_dropout(seed, thresh, keep_scale, row0);
#define STTS_ARGS(TY)                                                                                     \
  (const TY*)x, (const TY*)mod, mk, (const TY*)w1, (const TY*)b1, (const TY*)w2, (const TY*)b2, drop,     \
      (TY*)h, (TY*)sd, (TY*)out, B, T, C, F, eps, s
  cudaError_t err = is_bf16 ? forward<bf16>(STTS_ARGS(bf16)) : forward<float>(STTS_ARGS(float));
#undef STTS_ARGS
  return (int)err;
}

extern "C" int ffn_train_backward(const void* x, const void* mod, const void* mask, const void* w1,
                                  const void* b1, const void* w2, const void* b2, const void* seed,
                                  const void* dout, void* h, void* y, void* sd, void* pz, void* dzf, void* dzc,
                                  void* dyf, void* dyc, void* dh0, void* dh0n, void* dx, void* dmod, void* dw1,
                                  void* db1, void* dw2, void* db2, void* ws, int B, int T, int C, int F,
                                  int is_bf16, int thresh, int row0, int ws_floats, float keep_scale, float eps,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mk = static_cast<const float*>(mask);
  Dropout drop = make_dropout(seed, thresh, keep_scale, row0);
  float* f32[] = {static_cast<float*>(y), static_cast<float*>(pz), static_cast<float*>(dzf),
                  static_cast<float*>(dyf), static_cast<float*>(dh0), static_cast<float*>(dh0n),
                  static_cast<float*>(dmod), static_cast<float*>(dw1), static_cast<float*>(db1),
                  static_cast<float*>(dw2), static_cast<float*>(db2), static_cast<float*>(ws)};
#define STTS_ARGS(TY)                                                                                     \
  (const TY*)x, (const TY*)mod, mk, (const TY*)w1, (const TY*)b1, (const TY*)w2, (const TY*)b2, drop,     \
      (const TY*)dout, (TY*)h, f32[0], (TY*)sd, f32[1], f32[2], (TY*)dzc, f32[3], (TY*)dyc, f32[4], f32[5], \
      (TY*)dx, f32[6], f32[7], f32[8], f32[9], f32[10], f32[11], ws_floats, B, T, C, F, eps, s
  cudaError_t err = is_bf16 ? backward<bf16>(STTS_ARGS(bf16)) : backward<float>(STTS_ARGS(float));
#undef STTS_ARGS
  return (int)err;
}
