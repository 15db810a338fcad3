// Shared device code of the port's kernels: float/bf16 conversion; a tiled
// "tap GEMM" whose A operand is a row-shifted view of activations, so k-tap
// convolutions along time (and the ISTFT overlap-add) run as one product
// without materialising shifted copies; its transposed product for weight
// gradients; LayerNorm + adaLN modulate forward and backward; deterministic
// column sums; the epilogues of the inference DiT block (QKV with partial RoPE,
// out-projection and the two FFN convs), shared by the whole-block kernel and
// its two halves; Philox4x32-10 dropout.
//
// Arithmetic is fp32 FMA throughout (no tensor cores): f32 inputs get true-f32
// products, bf16 inputs are widened exactly to f32. The tile is 64x64 with a
// 16-deep k step, 256 threads, 4x4 outputs per thread. The epilogue stages
// the tile in shared memory so it can read neighbouring columns (RoPE).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace stts {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// v rounded through T (identity for float)
template <typename T> __device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

constexpr int GEMM_BM = 64;
constexpr int GEMM_BN = 64;
constexpr int GEMM_BK = 16;
constexpr int GEMM_THREADS = 256;

// C[m, n] = sum_tap sum_k A(m, tap, k) * B(tap, k, n)
//   output row m = b * t_out + i; A(m, tap, k) reads activation row
//   t = i + shift0 + tap * shift_step of batch item b (zero outside
//   [0, min(t_in, row_len[b])) ), column k (k < k_split from a0, else from
//   a1 at k - k_split; zero for k >= k_in);
//   B(tap, k, n) = w[tap * w_tap_stride + k * ldw + n], or with w_trans
//   w[tap * w_tap_stride + n * ldw + k] (the product with W^T).
struct TapGemm {
  const void* a0;
  const void* a1;
  int k_split;
  int lda;
  int t_in;
  int t_out;
  int k_in;
  int taps;
  int shift0;
  int shift_step;
  const int* row_len;  // nullptr: every row of t_in is valid
  const void* w;
  long long w_tap_stride;
  int ldw;
  int M;
  int N;
  int w_trans;
};

// Epi must provide
//   float prep(int m, int n, float acc)                 -> value staged in the tile
//   void store(int m, int n, const float* tile, int r, int c)  (tile row stride GEMM_BN + 1)
template <typename T, typename Epi>
__global__ void __launch_bounds__(GEMM_THREADS) tap_gemm_kernel(TapGemm g, Epi epi) {
  __shared__ __align__(16) float As[GEMM_BK][GEMM_BM + 4];
  __shared__ __align__(16) float Bs[GEMM_BK][GEMM_BN + 4];
  __shared__ float Cs[GEMM_BM][GEMM_BN + 1];

  const T* A0 = static_cast<const T*>(g.a0);
  const T* A1 = static_cast<const T*>(g.a1);
  const T* W = static_cast<const T*>(g.w);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * GEMM_BM, n0 = blockIdx.x * GEMM_BN;
  const int k_pad = (g.k_in + GEMM_BK - 1) / GEMM_BK * GEMM_BK;

  // the A rows this thread loads: fixed across the k loop
  int a_b[4], a_i[4];
  bool a_ok[4];
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    int r = (tid + l * GEMM_THREADS) / GEMM_BK;
    int m = m0 + r;
    a_ok[l] = m < g.M;
    a_b[l] = a_ok[l] ? m / g.t_out : 0;
    a_i[l] = a_ok[l] ? m % g.t_out : 0;
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < g.taps; ++tap) {
    const int shift = g.shift0 + tap * g.shift_step;
    const T* Wt = W + tap * g.w_tap_stride;
    for (int k0 = 0; k0 < k_pad; k0 += GEMM_BK) {
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        int e = tid + l * GEMM_THREADS;
        int r = e / GEMM_BK, kk = e % GEMM_BK;
        int k = k0 + kk;
        float v = 0.f;
        if (a_ok[l] && k < g.k_in) {
          int t = a_i[l] + shift;
          int lim = g.row_len ? min(g.row_len[a_b[l]], g.t_in) : g.t_in;
          if (t >= 0 && t < lim) {
            long long row = (long long)a_b[l] * g.t_in + t;
            v = k < g.k_split ? to_f(A0[row * g.lda + k]) : to_f(A1[row * g.lda + (k - g.k_split)]);
          }
        }
        As[kk][r] = v;
      }
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        int e = tid + l * GEMM_THREADS;
        // W^T: neighbouring threads take neighbouring k, which is contiguous
        int kk = g.w_trans ? e % GEMM_BK : e / GEMM_BN;
        int c = g.w_trans ? e / GEMM_BK : e % GEMM_BN;
        int k = k0 + kk, n = n0 + c;
        float v = 0.f;
        if (k < g.k_in && n < g.N)
          v = to_f(g.w_trans ? Wt[(long long)n * g.ldw + k] : Wt[(long long)k * g.ldw + n]);
        Bs[kk][c] = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < GEMM_BK; ++kk) {
        float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        float a[4] = {a4.x, a4.y, a4.z, a4.w};
        float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int r = ty * 4 + i, c = tx * 4 + j;
      int m = m0 + r, n = n0 + c;
      Cs[r][c] = (m < g.M && n < g.N) ? epi.prep(m, n, acc[i][j]) : 0.f;
    }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int r = ty * 4 + i, c = tx * 4 + j;
      int m = m0 + r, n = n0 + c;
      if (m < g.M && n < g.N) epi.store(m, n, &Cs[0][0], r, c);
    }
}

// A "same"-padded k-tap conv along time (taps = 1: a dense layer) of a [M =
// B*Tn, k_in] activation with w [taps, k_in, n_out]: tap j reads row
// t - (taps-1)/2 + j. `transposed` gives the input gradient's product of a
// conv whose w is [taps, n_out, k_in]: tap j reads row t + (taps-1)/2 - j
// against W[j]^T.
inline TapGemm conv_gemm(const void* a, int k_in, const void* w, int n_out, int M, int Tn, int taps,
                         bool transposed) {
  TapGemm g{};
  g.a0 = a; g.a1 = a; g.k_split = k_in; g.lda = k_in; g.t_in = Tn; g.t_out = Tn; g.k_in = k_in;
  g.taps = taps; g.row_len = nullptr; g.w = w; g.w_tap_stride = (long long)k_in * n_out; g.M = M; g.N = n_out;
  const int half = (taps - 1) / 2;
  g.shift0 = transposed ? half : -half;
  g.shift_step = transposed ? -1 : 1;
  g.w_trans = transposed ? 1 : 0;
  g.ldw = transposed ? k_in : n_out;
  return g;
}

template <typename T, typename Epi>
void launch_tap_gemm(const TapGemm& g, const Epi& epi, cudaStream_t stream) {
  dim3 grid((g.N + GEMM_BN - 1) / GEMM_BN, (g.M + GEMM_BM - 1) / GEMM_BM);
  tap_gemm_kernel<T, Epi><<<grid, GEMM_THREADS, 0, stream>>>(g, epi);
}

// warp-wide sum
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---- LayerNorm (no affine, f32 stats) + adaLN modulate (+ mask) -----------
// One warp per row of x [M = B*T, C]; mods [B, n_mods, C] holds the shift
// and scale rows at shift_idx / scale_idx; mask [M] or nullptr.
template <typename Tin, typename Tout>
__global__ void ln_mod_kernel(const Tin* x, const Tout* mods, int n_mods, int shift_idx, int scale_idx,
                              const float* mask, Tout* out, int M, int T, int C, float eps) {
  int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  int lane = threadIdx.x % 32;
  if (row >= M) return;
  const Tin* xr = x + (long long)row * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += to_f(xr[c]);
  float mu = warp_sum(s) / C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    float d = to_f(xr[c]) - mu;
    v += d * d;
  }
  float rstd = rsqrtf(warp_sum(v) / C + eps);
  int b = row / T;
  const Tout* shift = mods + ((long long)b * n_mods + shift_idx) * C;
  const Tout* scale = mods + ((long long)b * n_mods + scale_idx) * C;
  float m = mask ? mask[row] : 1.f;
  for (int c = lane; c < C; c += 32) {
    float h = (to_f(xr[c]) - mu) * rstd;
    h = h * (1.f + to_f(scale[c])) + to_f(shift[c]);
    if (mask) h *= m;
    out[(long long)row * C + c] = from_f<Tout>(h);
  }
}

constexpr int LN_ROWS = 8;  // warps (rows) per LayerNorm block

template <typename Tin, typename Tout>
void launch_ln_mod(const Tin* x, const Tout* mods, int n_mods, int shift_idx, int scale_idx, const float* mask,
                   Tout* out, int M, int T, int C, float eps, cudaStream_t stream) {
  ln_mod_kernel<Tin, Tout><<<(M + LN_ROWS - 1) / LN_ROWS, 32 * LN_ROWS, 0, stream>>>(
      x, mods, n_mods, shift_idx, scale_idx, mask, out, M, T, C, eps);
}

// ---- QKV projection epilogue: bias, q scale, rounding, partial RoPE -------
// The product is [M, 3C] (q | k | v); q and k rotate their first 2*half
// features of each head as x*cos + neg_half(x)*sin, neg_half(x) =
// [-x[half:2half], x[:half]], on the values already rounded to T.
template <typename T>
struct QkvEpi {
  const T* bias;
  T* q;
  T* k;
  T* v;
  const float* cos_t;  // [T, half]
  const float* sin_t;
  int C, D, half, T_;
  float q_scale;
  __device__ float prep(int m, int n, float acc) const {
    float val = acc + to_f(bias[n]);
    if (n < C) val *= q_scale;
    return round_to<T>(val);
  }
  __device__ void store(int m, int n, const float* tile, int r, int c) const {
    const int ld = GEMM_BN + 1;
    int which = n / C, nn = n % C, jj = nn % D;
    float x = tile[r * ld + c];
    T* dst = which == 0 ? q : (which == 1 ? k : v);
    if (which < 2 && jj < 2 * half) {
      int t = m % T_;
      int i = jj % half;
      float cs = cos_t[t * half + i], sn = sin_t[t * half + i];
      float partner = jj < half ? -tile[r * ld + c + half] : tile[r * ld + c - half];
      x = x * cs + partner * sn;
    }
    dst[(long long)m * C + nn] = from_f<T>(x);
  }
};

// ---- out-projection epilogue: out = x + ((acc + bo) * gate) * m -----------
// mods [B, n_mods, C] holds the gate row at gate_idx. Tout is float where the
// caller keeps the residual stream in f32 (the whole block's x1), T where the
// result is rounded to the activation type (the attention half alone).
template <typename T, typename Tout>
struct OutProjEpi {
  const T* bias;
  const T* x;
  const T* mods;
  int n_mods, gate_idx;
  const float* mask;
  Tout* out;
  int C, T_;
  __device__ float prep(int m, int n, float acc) const { return acc + to_f(bias[n]); }
  __device__ void store(int m, int n, const float* tile, int r, int c) const {
    int b = m / T_;
    float gate = to_f(mods[((long long)b * n_mods + gate_idx) * C + n]);
    float o = tile[r * (GEMM_BN + 1) + c];
    out[(long long)m * C + n] = from_f<Tout>(to_f(x[(long long)m * C + n]) + o * gate * mask[m]);
  }
};

// ---- FFN conv1 epilogue: y = silu(acc + b1) * m ----------------------------
template <typename T>
struct Conv1Epi {
  const T* bias;
  const float* mask;
  T* y;
  int N;
  __device__ float prep(int m, int n, float acc) const { return acc + to_f(bias[n]); }
  __device__ void store(int m, int n, const float* tile, int r, int c) const {
    float v = tile[r * (GEMM_BN + 1) + c];
    float s = v / (1.f + expf(-v));
    y[(long long)m * N + n] = from_f<T>(s * mask[m]);
  }
};

// ---- FFN conv2 epilogue: out = res + gate * ((acc + b2) * m) ---------------
// res is the residual stream: f32 x1 inside the whole block, the activation
// type where the FFN half runs alone.
template <typename T, typename Tres>
struct Conv2Epi {
  const T* bias;
  const T* mods;
  int n_mods, gate_idx;
  const float* mask;
  const Tres* res;
  T* out;
  int C, T_;
  __device__ float prep(int m, int n, float acc) const { return acc + to_f(bias[n]); }
  __device__ void store(int m, int n, const float* tile, int r, int c) const {
    int b = m / T_;
    float gate = to_f(mods[((long long)b * n_mods + gate_idx) * C + n]);
    float z = tile[r * (GEMM_BN + 1) + c] * mask[m];
    out[(long long)m * C + n] = from_f<T>(to_f(res[(long long)m * C + n]) + gate * z);
  }
};

// ---- Philox4x32-10 --------------------------------------------------------
// Counter-based random bits: the same (counter, key) gives the same four
// words on any thread and in the plain PyTorch version (ops/philox.py), so
// a backward pass regenerates its forward's dropout mask instead of
// storing it.
__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    uint32_t hi0 = __umulhi(0xD2511F53u, ctr.x), lo0 = 0xD2511F53u * ctr.x;
    uint32_t hi1 = __umulhi(0xCD9E8D57u, ctr.z), lo1 = 0xCD9E8D57u * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ k0, lo1, hi0 ^ ctr.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return ctr;
}

__device__ __forceinline__ uint32_t word_of(uint4 w, int i) {
  return i == 0 ? w.x : (i == 1 ? w.y : (i == 2 ? w.z : w.w));
}

// Dropout of one call: the key comes from a device int64 [2] tensor (drawn
// from the trainer's generator), an element is kept when its word is at
// least `thresh`, and kept values are scaled by `scale` = 1 / (1 - rate).
struct Dropout {
  const long long* seed;  // nullptr: no dropout
  unsigned int thresh;
  float scale;
  // multiplier of the element whose counter is (c0, c1, c2, c3), word i
  __device__ __forceinline__ float factor(uint4 words, int i) const {
    return word_of(words, i) >= thresh ? scale : 0.f;
  }
  __device__ __forceinline__ uint4 bits(uint32_t c0, uint32_t c1, uint32_t c2, uint32_t c3) const {
    return philox4x32_10(make_uint4(c0, c1, c2, c3), (uint32_t)seed[0], (uint32_t)seed[1]);
  }
};

// from a C entry point's arguments (thresh is the unsigned threshold passed as int)
inline Dropout make_dropout(const void* seed, int thresh, float scale) {
  return Dropout{static_cast<const long long*>(seed), (unsigned int)thresh, scale};
}

// ---- LayerNorm + modulate backward ----------------------------------------
// Per row: n = LN(x), dn = dh0 * (1 + scale),
// dx = do + (dn - mean(dn) - n * mean(dn * n)) * rstd; also writes dh0 * n
// (summed over rows into dscale by colsum_kernel).
template <typename T>
__global__ void ln_bwd_kernel(const T* x, const float* dh0, const T* mods, int n_mods, int scale_idx,
                              const T* dout, T* dx, float* dh0n, int M, int T_, int C, float eps) {
  int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  int lane = threadIdx.x % 32;
  if (row >= M) return;
  const long long base = (long long)row * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += to_f(x[base + c]);
  float mu = warp_sum(s) / C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    float d = to_f(x[base + c]) - mu;
    v += d * d;
  }
  float rstd = rsqrtf(warp_sum(v) / C + eps);
  const T* scale = mods + ((long long)(row / T_) * n_mods + scale_idx) * C;
  float sdn = 0.f, sdnn = 0.f;
  for (int c = lane; c < C; c += 32) {
    float n = (to_f(x[base + c]) - mu) * rstd;
    float dn = dh0[base + c] * (1.f + to_f(scale[c]));
    sdn += dn;
    sdnn += dn * n;
  }
  float dn_mean = warp_sum(sdn) * (1.f / C), dnn_mean = warp_sum(sdnn) * (1.f / C);
  for (int c = lane; c < C; c += 32) {
    float n = (to_f(x[base + c]) - mu) * rstd;
    float g = dh0[base + c];
    float dn = g * (1.f + to_f(scale[c]));
    dx[base + c] = from_f<T>(to_f(dout[base + c]) + (dn - dn_mean - n * dnn_mean) * rstd);
    dh0n[base + c] = g * n;
  }
}

template <typename T>
void launch_ln_bwd(const T* x, const float* dh0, const T* mods, int n_mods, int scale_idx, const T* dout, T* dx,
                   float* dh0n, int M, int T_, int C, float eps, cudaStream_t stream) {
  ln_bwd_kernel<T><<<(M + LN_ROWS - 1) / LN_ROWS, 32 * LN_ROWS, 0, stream>>>(
      x, dh0, mods, n_mods, scale_idx, dout, dx, dh0n, M, T_, C, eps);
}

// ---- column sums over groups of rows, in a fixed order (no atomics) -------
// out[g * out_stride + n] = sum_{r < rows} X[(g * rows + r) * N + n], f32.
// Block: 32 columns x 8 row lanes; grid (ceil(N / 32), groups).
template <typename Tin>
__global__ void colsum_kernel(const Tin* X, float* out, int rows, int N, long long out_stride) {
  __shared__ float part[8][33];
  const int cx = threadIdx.x % 32, ry = threadIdx.x / 32;
  const int n = blockIdx.x * 32 + cx;
  const long long base = (long long)blockIdx.y * rows;
  float s = 0.f;
  if (n < N)
    for (int r = ry; r < rows; r += 8) s += to_f(X[(base + r) * N + n]);
  part[ry][cx] = s;
  __syncthreads();
  if (ry == 0 && n < N) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) t += part[i][cx];
    out[blockIdx.y * out_stride + n] = t;
  }
}

template <typename Tin>
void launch_colsum(const Tin* X, float* out, int groups, int rows, int N, long long out_stride, cudaStream_t stream) {
  colsum_kernel<Tin><<<dim3((N + 31) / 32, groups), 256, 0, stream>>>(X, out, rows, N, out_stride);
}

// ---- weight gradient of a tap GEMM: the transposed product ---------------
// out[tap, m, n] = sum_{r < rows} A(r, tap)[m] * G[r, n], f32, where row
// r = b * t_len + t and A(r, tap) is activation row t + shift0 + tap *
// shift_step of item b (zero outside [0, t_len)). The rows are cut into
// `splits` consecutive chunks; one CTA per (64 x 64 output tile, tap, chunk)
// writes its partial sum to a workspace, and a second kernel adds the
// partials in chunk order. No atomics: the same sums on every run.
struct WGrad {
  const void* a;
  int lda;
  int ka;  // columns of A = rows of each output tap
  const void* g;
  int ldg;
  int n;   // columns of G = columns of the output
  int rows;
  int t_len;
  int shift0;
  int shift_step;
  float* out;
  int row_chunk;  // rows per chunk, a multiple of GEMM_BK (set by launch_wgrad)
};

template <typename T>
__global__ void __launch_bounds__(GEMM_THREADS) wgrad_kernel(WGrad p, int taps) {
  __shared__ __align__(16) float As[GEMM_BK][GEMM_BM + 4];
  __shared__ __align__(16) float Bs[GEMM_BK][GEMM_BN + 4];
  const T* A = static_cast<const T*>(p.a);
  const T* G = static_cast<const T*>(p.g);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * GEMM_BN, m0 = blockIdx.y * GEMM_BM;
  const int tap = blockIdx.z % taps, chunk = blockIdx.z / taps;
  const int shift = p.shift0 + tap * p.shift_step;
  const int r_begin = chunk * p.row_chunk, r_end = min(p.rows, r_begin + p.row_chunk);
  float* out = p.out + (long long)chunk * taps * p.ka * p.n;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += GEMM_BK) {
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      int e = tid + l * GEMM_THREADS;
      int kk = e / GEMM_BM, c = e % GEMM_BM;
      int r = r0 + kk;
      float va = 0.f, vg = 0.f;
      if (r < r_end) {
        int m = m0 + c, n = n0 + c;
        int b = r / p.t_len, t = r % p.t_len + shift;
        if (m < p.ka && t >= 0 && t < p.t_len) va = to_f(A[((long long)b * p.t_len + t) * p.lda + m]);
        if (n < p.n) vg = to_f(G[(long long)r * p.ldg + n]);
      }
      As[kk][c] = va;
      Bs[kk][c] = vg;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GEMM_BK; ++kk) {
      float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      float a[4] = {a4.x, a4.y, a4.z, a4.w};
      float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int m = m0 + ty * 4 + i, n = n0 + tx * 4 + j;
      if (m < p.ka && n < p.n) out[((long long)tap * p.ka + m) * p.n + n] = acc[i][j];
    }
}

// out[i] = sum_{s < splits} part[s * size + i], in order of s
__global__ void sum_splits_kernel(const float* part, float* out, int splits, long long size) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[k * size + i];
  out[i] = s;
}

constexpr int WGRAD_TARGET_CTAS = 1024;  // ~4 waves of 2 CTAs on 132 SMs
constexpr int WGRAD_MIN_CHUNK = 128;     // rows

// Splits the row reduction so that the grid has about WGRAD_TARGET_CTAS
// CTAs, as far as `ws` (ws_floats floats; may be nullptr) holds the
// partials. The split depends only on the shapes and ws_floats.
template <typename T>
void launch_wgrad(WGrad p, int taps, float* ws, long long ws_floats, cudaStream_t stream) {
  const long long size = (long long)taps * p.ka * p.n;
  const int tiles = ((p.n + GEMM_BN - 1) / GEMM_BN) * ((p.ka + GEMM_BM - 1) / GEMM_BM) * taps;
  long long splits = (WGRAD_TARGET_CTAS + tiles - 1) / tiles;
  splits = min(splits, (long long)(p.rows + WGRAD_MIN_CHUNK - 1) / WGRAD_MIN_CHUNK);
  splits = ws ? min(splits, ws_floats / size) : 1;
  splits = max(splits, 1LL);
  p.row_chunk = (int)(((p.rows + splits - 1) / splits + GEMM_BK - 1) / GEMM_BK * GEMM_BK);
  splits = (p.rows + p.row_chunk - 1) / p.row_chunk;
  float* final_out = p.out;
  if (splits > 1) p.out = ws;
  dim3 grid((p.n + GEMM_BN - 1) / GEMM_BN, (p.ka + GEMM_BM - 1) / GEMM_BM, taps * (int)splits);
  wgrad_kernel<T><<<grid, GEMM_THREADS, 0, stream>>>(p, taps);
  if (splits > 1)
    sum_splits_kernel<<<(int)((size + 255) / 256), 256, 0, stream>>>(ws, final_out, (int)splits, size);
}

}  // namespace stts
