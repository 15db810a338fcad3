// The DiT block's attention half for training on Hopper (sm_90a), forward and
// backward:
//
//   h       = LN(x) * (1 + scale) + shift                      (LN: no affine)
//   q, k, v = h Wq + bq, h Wk + bk, h Wv + bv;  qr, kr = rope(q), rope(k)
//   att     = drop(softmax(qr kr^T / sqrt(D) + kbias)) v        per head
//   out     = x + gate * (att Wo + bo) * m
//
// Replaces: the JAX package's ops/dit_attention_pallas_train.py::
// fused_dit_attention_train (a custom-VJP pair of Pallas kernels, one grid
// cell per batch element holding its [T, C] tiles and one head's [T, T]
// softmax in VMEM; the backward recomputes everything from x and
// accumulates the projection gradients across grid cells).
//
// What bounds it on the H100: arithmetic. Forward 2*B*T*C*4C + 4*B*H*T^2*D
// FLOPs, backward about 3x (the TPU kernel's cost estimates); at B=32,
// T=1024, C=256, 4 heads that is 51.5 GFLOP forward.
//
// Design. One head's f32 [T, T] softmax is 4 MB at T=1024 and a CTA has
// 227 KB, so attention is tiled flash-style and no [B, H, T, T] tensor
// reaches device memory in the forward or is saved for the backward (the f32
// backward writes dS^T for its dQ kernel, attention_train.cuh):
//   forward:  LN + modulate -> QKV tap GEMM with partial RoPE and bf16
//             rounding in its epilogue -> attention per (query tile, head,
//             item) over 64-key tiles, saving each row's log-sum-exp ([B, H,
//             T] f32): in bf16 two passes, the first finding the log-sum-exp,
//             the second forming the normalised weights p = exp(s - lse),
//             dropping them (Philox) and rounding them as the TPU kernel does
//             before the PV product (64 queries a CTA); in f32 one online
//             pass (128 queries a CTA), att = sum exp(s - m) f v / l
//             (attention_train.cuh) -> out-projection with the gated
//             residual.
//   backward: recompute h, q, k, v and the out-projection (for dgate);
//             datt = dz Wo^T; D = rowsum(datt * att) per head (the TPU's
//             sum(dp * p); in bf16 att with its rounding remainder att_lo,
//             which the forward writes: attention_train.cuh says why); FlashAttention-2: one kernel per 64-key tile loops
//             over query tiles for dK, dV, a second per 64-query tile loops
//             over key tiles for dQ (no atomics); the RoPE adjoint
//             dq = dqr*cos - P(dqr*sin), zero outside the rotary lanes; dh =
//             [dq|dk|dv] [Wq|Wk|Wv]^T; projection gradients by the transposed
//             tap GEMM over the B*T rows in chunks (common.cuh); the
//             LayerNorm + modulate backward.
// Numerics kept from the TPU kernel: scores scaled by 1/sqrt(D) after the
// product, key bias -0.7*f32max on padded keys, natural-exp softmax; padded
// query rows are garbage that `* m` removes. In bf16 q/k/v are rounded
// before RoPE, p before PV, ds and dq/dk/dv after their products. Dropout:
// weight (b, h, q, key) keeps when Philox word key%4 of counter
// (key/4, q, (b + row0)*H + h, 0) under the call's key is >= thresh. The projections
// (tap GEMMs, common.cuh) and attention's products (attention_train.cuh) run
// on wgmma (tensor cores) in bf16 and on fp32 FMA in f32, and so do the
// weight gradients. Head dim 64.
#include "attention_train.cuh"

using namespace stts;
using namespace stts::atr;

namespace {

// ---- RoPE adjoint: dq = dqr*cos - P(dqr*sin), zero outside the rotary lanes
// (lane l of a head: l < half takes +dqr[l+half]*sin, half <= l < 2*half
// takes -dqr[l-half]*sin); writes into dqkv [M, 3C] at column offset
// which*C. One thread per element of the [M, C] input.
template <typename T>
__global__ void rope_bwd_kernel(const T* dr, const float* cos_t, const float* sin_t, T* dqkv, int which, int M,
                                int Tn, int C, int half) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)M * C) return;
  int c = e % C;
  long long row = e / C;
  int t = row % Tn, l = c % HD;
  float y = to_f(dr[e]);
  float r;
  if (l < half) {
    r = y * cos_t[t * half + l] + to_f(dr[e + half]) * sin_t[t * half + l];
  } else if (l < 2 * half) {
    r = y * cos_t[t * half + l - half] - to_f(dr[e - half]) * sin_t[t * half + l - half];
  } else {
    r = y;
  }
  dqkv[row * 3 * C + which * C + c] = from_f<T>(r);
}

// out-projection epilogue, forward: out = x + gate * (acc + bo) * m
template <typename T>
struct OutFwdEpi {
  const T* bias;
  const T* x;
  const T* mod;
  const float* mask;
  T* out;
  int C, T_;
  __device__ float prep(int m, int n, float acc) const { return acc + to_f(bias[n]); }
  __device__ void store(int m, int n, const float* tile, int r, int c) const {
    const long long i = (long long)m * C + n;
    float gate = to_f(mod[((long long)(m / T_) * 3 + 2) * C + n]);
    out[i] = from_f<T>(to_f(x[i]) + gate * tile[r * (GEMM_BN + 1) + c] * mask[m]);
  }
};

// out-projection recompute, backward: pz = do * z * m, dz = round(do * gate * m)
template <typename T>
struct OutBwdEpi {
  const T* bias;
  const T* dout;
  const T* mod;
  const float* mask;
  float* pz;
  T* dzc;
  int C, T_;
  __device__ float prep(int m, int n, float acc) const { return acc + to_f(bias[n]); }
  __device__ void store(int m, int n, const float* tile, int r, int c) const {
    const long long i = (long long)m * C + n;
    float gate = to_f(mod[((long long)(m / T_) * 3 + 2) * C + n]);
    float d = to_f(dout[i]);
    pz[i] = d * tile[r * (GEMM_BN + 1) + c] * mask[m];
    dzc[i] = from_f<T>(d * gate * mask[m]);
  }
};

// plain store of the product, rounded to T (datt) or kept in f32 (dh0)
template <typename Tout>
struct StoreEpi {
  Tout* out;
  int N;
  __device__ float prep(int m, int n, float acc) const { return acc; }
  __device__ void store(int m, int n, const float* tile, int r, int c) const {
    out[(long long)m * N + n] = from_f<Tout>(tile[r * (GEMM_BN + 1) + c]);
  }
};

template <typename T>
void qkv_recompute(const T* x, const T* mod, const float* cos_t, const float* sin_t, const T* wqkv,
                   const T* bqkv, T* h, T* q, T* k, T* v, int M, int Tn, int C, float eps, cudaStream_t s) {
  launch_ln_mod<T, T>(x, mod, 3, 0, 1, nullptr, h, M, Tn, C, eps, s);
  launch_tap_gemm<T>(conv_gemm(h, C, wqkv, 3 * C, M, Tn, 1, false),
                     QkvEpi<T>{bqkv, q, k, v, cos_t, sin_t, C, HD, HD / 4, Tn, 1.f}, s);
}

template <typename T>
cudaError_t forward(const T* x, const T* mod, const float* mask, const float* cos_t, const float* sin_t,
                    const T* wqkv, const T* bqkv, const T* wo, const T* bo, Dropout drop, T* h, T* q, T* k, T* v,
                    T* att, T* att_lo, float* lse, T* out, int B, int Tn, int C, int H, float eps, cudaStream_t s) {
  const int M = B * Tn;
  qkv_recompute<T>(x, mod, cos_t, sin_t, wqkv, bqkv, h, q, k, v, M, Tn, C, eps, s);
  launch_attn_fwd<T>(q, k, v, mask, att, att_lo, lse, B, Tn, C, H, 1.f / sqrtf((float)HD), drop, s);
  launch_tap_gemm<T>(conv_gemm(att, C, wo, C, M, Tn, 1, false), OutFwdEpi<T>{bo, x, mod, mask, out, C, Tn}, s);
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward(const T* x, const T* mod, const float* mask, const float* cos_t, const float* sin_t,
                     const T* wqkv, const T* bqkv, const T* wo, const T* bo, Dropout drop, const T* att,
                     const T* att_lo, const float* lse, const T* dout, T* h, T* q, T* k, T* v, float* pz, T* dzc, T* datt,
                     float* Dv, T* dq_r, T* dk_r, T* dqkv, float* dh0, float* dh0n, T* dx, float* dmod,
                     float* dwqkv, float* dbqkv, float* dwo, float* dbo, float* ws, long long ws_floats,
                     float* ds_ws, int B, int Tn, int C, int H, float eps, cudaStream_t s) {
  const int M = B * Tn;
  const float sm_scale = 1.f / sqrtf((float)HD);
  qkv_recompute<T>(x, mod, cos_t, sin_t, wqkv, bqkv, h, q, k, v, M, Tn, C, eps, s);
  // out-projection: recompute for dgate, dz; datt = dz Wo^T; dWo, dbo
  launch_tap_gemm<T>(conv_gemm(att, C, wo, C, M, Tn, 1, false), OutBwdEpi<T>{bo, dout, mod, mask, pz, dzc, C, Tn}, s);
  launch_tap_gemm<T>(conv_gemm(dzc, C, wo, C, M, Tn, 1, true), StoreEpi<T>{datt, C}, s);
  launch_wgrad<T>(WGrad{att, C, C, dzc, C, C, M, Tn, 0, 0, dwo}, 1, ws, ws_floats, s);
  // the column sums reuse ws for their row-chunk partials: every launch here runs in order on one
  // stream, so a launch_wgrad's partials are summed before the next colsum writes its own
  launch_colsum<T>(dzc, dbo, 1, M, C, 0, ws, ws_floats, s);
  // attention backward
  launch_attn_bwd<T>(q, k, v, att, att_lo, datt, lse, mask, Dv, dq_r, dk_r, dqkv + 2 * C, 3 * C, ds_ws, B, Tn, C, H,
                     sm_scale, drop, s);
  const long long n_el = (long long)M * C;
  const int rb = (int)((n_el + 255) / 256);
  rope_bwd_kernel<T><<<rb, 256, 0, s>>>(dq_r, cos_t, sin_t, dqkv, 0, M, Tn, C, HD / 4);
  rope_bwd_kernel<T><<<rb, 256, 0, s>>>(dk_r, cos_t, sin_t, dqkv, 1, M, Tn, C, HD / 4);
  // projections: dh = dqkv Wqkv^T; dWqkv, dbqkv
  launch_tap_gemm<T>(conv_gemm(dqkv, 3 * C, wqkv, C, M, Tn, 1, true), StoreEpi<float>{dh0, C}, s);
  launch_wgrad<T>(WGrad{h, C, C, dqkv, 3 * C, 3 * C, M, Tn, 0, 0, dwqkv}, 1, ws, ws_floats, s);
  launch_colsum<T>(dqkv, dbqkv, 1, M, 3 * C, 0, ws, ws_floats, s);
  // modulate + LayerNorm backward; per-item d{shift, scale, gate} -> dmod [B, 3, C]
  launch_ln_bwd<T>(x, dh0, mod, 3, 1, dout, dx, dh0n, M, Tn, C, eps, s);
  launch_colsum<float>(dh0, dmod, B, Tn, C, 3LL * C, ws, ws_floats, s);
  launch_colsum<float>(dh0n, dmod + C, B, Tn, C, 3LL * C, ws, ws_floats, s);
  launch_colsum<float>(pz, dmod + 2 * C, B, Tn, C, 3LL * C, ws, ws_floats, s);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dit_attention_train_forward(const void* x, const void* mod, const void* mask, const void* cos_t,
                                           const void* sin_t, const void* wqkv, const void* bqkv, const void* wo,
                                           const void* bo, const void* seed, void* h, void* q, void* k, void* v,
                                           void* att, void* att_lo, void* lse, void* out, int B, int T, int C,
                                           int H, int is_bf16, int thresh, int row0, float keep_scale, float eps, void* stream) {
  if (C / H != HD || C % 64) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Dropout drop = make_dropout(seed, thresh, keep_scale, row0);
  const float* mk = static_cast<const float*>(mask);
  const float* cs = static_cast<const float*>(cos_t);
  const float* sn = static_cast<const float*>(sin_t);
#define STTS_ARGS(TY)                                                                                      \
  (const TY*)x, (const TY*)mod, mk, cs, sn, (const TY*)wqkv, (const TY*)bqkv, (const TY*)wo, (const TY*)bo, \
      drop, (TY*)h, (TY*)q, (TY*)k, (TY*)v, (TY*)att, (TY*)att_lo, static_cast<float*>(lse), (TY*)out, B, T, \
      C, H, eps, s
  cudaError_t err = is_bf16 ? forward<bf16>(STTS_ARGS(bf16)) : forward<float>(STTS_ARGS(float));
#undef STTS_ARGS
  return (int)err;
}

extern "C" int dit_attention_train_backward(
    const void* x, const void* mod, const void* mask, const void* cos_t, const void* sin_t, const void* wqkv,
    const void* bqkv, const void* wo, const void* bo, const void* seed, const void* att, const void* att_lo,
    const void* lse, const void* dout, void* h, void* q, void* k, void* v, void* pz, void* dzc, void* datt, void* Dv, void* dq_r,
    void* dk_r, void* dqkv, void* dh0, void* dh0n, void* dx, void* dmod, void* dwqkv, void* dbqkv, void* dwo,
    void* dbo, void* ws, void* ds_ws, int B, int T, int C, int H, int is_bf16, int thresh, int row0, int ws_floats,
    float keep_scale, float eps, void* stream) {
  if (C / H != HD || C % 64) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Dropout drop = make_dropout(seed, thresh, keep_scale, row0);
  const float* mk = static_cast<const float*>(mask);
  const float* cs = static_cast<const float*>(cos_t);
  const float* sn = static_cast<const float*>(sin_t);
  auto f = [](void* p) { return static_cast<float*>(p); };
#define STTS_ARGS(TY)                                                                                       \
  (const TY*)x, (const TY*)mod, mk, cs, sn, (const TY*)wqkv, (const TY*)bqkv, (const TY*)wo, (const TY*)bo,  \
      drop, (const TY*)att, (const TY*)att_lo, static_cast<const float*>(lse), (const TY*)dout, (TY*)h,      \
      (TY*)q, (TY*)k, (TY*)v, f(pz), (TY*)dzc, (TY*)datt, f(Dv), (TY*)dq_r, (TY*)dk_r, (TY*)dqkv, f(dh0),    \
      f(dh0n), (TY*)dx, f(dmod), f(dwqkv), f(dbqkv), f(dwo), f(dbo), f(ws), ws_floats, f(ds_ws), B, T, C, H, eps, s
  cudaError_t err = is_bf16 ? backward<bf16>(STTS_ARGS(bf16)) : backward<float>(STTS_ARGS(float));
#undef STTS_ARGS
  return (int)err;
}
