// Shared device code of the port's kernels: float/bf16 conversion and a
// tiled "tap GEMM" whose A operand is a row-shifted view of activations, so
// k-tap convolutions along time (and the ISTFT overlap-add) run as one
// product without materialising shifted copies.
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
//   B(tap, k, n) = w[tap * w_tap_stride + k * ldw + n].
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
        int kk = e / GEMM_BN, c = e % GEMM_BN;
        int k = k0 + kk, n = n0 + c;
        Bs[kk][c] = (k < g.k_in && n < g.N) ? to_f(Wt[(long long)k * g.ldw + n]) : 0.f;
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

}  // namespace stts
