// One period discriminator's conv stack on Hopper (sm_90a), forward, f32:
// from layer 0's output, layers 1-4 (kernel (5,1); stride (3,1) for layers
// 1-3, 1 for layer 4; zero padding 2; leaky ReLU 0.1) and conv_post (kernel
// (3,1), padding 1, one output channel), with weight norm already folded.
//
// Replaces: the JAX package's ops/mpd_pallas.py::mpd_stack_fused (one Pallas
// grid cell per (batch item, width stream) that keeps every activation of the
// stream in VMEM and reads the stride-3 im2col columns with strided loads).
//
// The (5,1) kernels never mix the width dim, so period-folded audio is B*p
// independent 1-D streams; activations here are [B*p, L, C] row-major.
//
// What bounds it on the H100: arithmetic, 2 * rows_out * 5*Cin * Cout per
// layer: 73 GFLOP per call at B=16, T=20480, p=2 (layer 4 alone 43 GFLOP)
// against 77 MB of feature maps written and 33 MB of weights read.
//
// Design. The TPU kernel holds all activations of one stream in up to 100 MB
// of VMEM; an SM has 227 KB and layer 1's output of one stream alone is 1138 x
// 128 f32 = 583 KB at p=2, so that design does not carry over. But every
// layer's output is a feature map the caller needs in device memory anyway,
// so running layer by layer loses only the re-read of each map by the next
// layer: each layer is one launch of a strided tap GEMM over all streams (row
// l of a stream's output gathers rows stride*l + k - 2 of its input, zero
// outside [0, L_in) of that stream, never across streams or items; bias and
// leaky ReLU in the epilogue), 64 x 64 tiles, fp32 FMA, no im2col buffer in
// device memory. Layer 4's 21 MB of weights are read by every row tile and
// stay in the 50 MB L2. conv_post has one output channel: a reduction, one
// warp per output row over its 3 * 1024 products. Five launches per call.
#include "common.cuh"

using namespace stts;

namespace {

constexpr float kLeak = 0.1f;

// out[s, l, n] = leaky(bias[n] + sum_{k < taps} sum_c in[s, stride*l + k - pad, c] * w[k, c, n])
// in [S, l_in, c_in], w [taps, c_in, c_out], out [S, l_out, c_out]; M = S * l_out rows.
__global__ void __launch_bounds__(GEMM_THREADS) strided_tap_gemm_kernel(
    const float* in, const float* w, const float* bias, float* out, int M, int l_in, int l_out, int c_in,
    int c_out, int taps, int stride, int pad) {
  __shared__ __align__(16) float As[GEMM_BK][GEMM_BM + 4];
  __shared__ __align__(16) float Bs[GEMM_BK][GEMM_BN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * GEMM_BM, n0 = blockIdx.x * GEMM_BN;

  // the A rows this thread loads: fixed across the k loop
  long long a_base[4];  // first element of the stream, or -1 for a row past M
  int a_t0[4];          // input row of tap 0
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    int m = m0 + (tid + l * GEMM_THREADS) / GEMM_BK;
    if (m < M) {
      a_base[l] = (long long)(m / l_out) * l_in * c_in;
      a_t0[l] = (m % l_out) * stride - pad;
    } else {
      a_base[l] = -1;
      a_t0[l] = 0;
    }
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < taps; ++tap) {
    const float* wt = w + (long long)tap * c_in * c_out;
    for (int k0 = 0; k0 < c_in; k0 += GEMM_BK) {
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        int e = tid + l * GEMM_THREADS;
        int r = e / GEMM_BK, kk = e % GEMM_BK;
        int k = k0 + kk, t = a_t0[l] + tap;
        float v = 0.f;
        if (a_base[l] >= 0 && k < c_in && t >= 0 && t < l_in) v = in[a_base[l] + (long long)t * c_in + k];
        As[kk][r] = v;
      }
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        int e = tid + l * GEMM_THREADS;
        int kk = e / GEMM_BN, c = e % GEMM_BN;
        int k = k0 + kk, n = n0 + c;
        Bs[kk][c] = (k < c_in && n < c_out) ? wt[(long long)k * c_out + n] : 0.f;
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
  for (int i = 0; i < 4; ++i) {
    int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int n = n0 + tx * 4 + j;
      if (n >= c_out) continue;
      float y = acc[i][j] + bias[n];
      out[(long long)m * c_out + n] = y >= 0.f ? y : kLeak * y;
    }
  }
}

// conv_post: out[s, l] = bias + sum_{k < 3} sum_c in[s, l + k - 1, c] * w[k, c]; one warp per (s, l)
__global__ void conv_post_kernel(const float* in, const float* w, const float* bias, float* out, int M, int len,
                                 int c_in) {
  int m = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  int lane = threadIdx.x % 32;
  if (m >= M) return;
  int l = m % len;
  float s = 0.f;
  for (int k = 0; k < 3; ++k) {
    int t = l + k - 1;
    if (t < 0 || t >= len) continue;
    const float* row = in + (long long)(m - l + t) * c_in;
    const float* wk = w + (long long)k * c_in;
    for (int c = lane; c < c_in; c += 32) s = fmaf(row[c], wk[c], s);
  }
  s = warp_sum(s);
  if (lane == 0) out[m] = s + bias[0];
}

void launch_layer(const float* in, const float* w, const float* bias, float* out, int S, int l_in, int l_out,
                  int c_in, int c_out, int stride, cudaStream_t s) {
  const int M = S * l_out;
  dim3 grid((c_out + GEMM_BN - 1) / GEMM_BN, (M + GEMM_BM - 1) / GEMM_BM);
  strided_tap_gemm_kernel<<<grid, GEMM_THREADS, 0, s>>>(in, w, bias, out, M, l_in, l_out, c_in, c_out, 5, stride, 2);
}

}  // namespace

// a0 [S, l1, 32] is layer 0's output (S = B * period streams); w1..w4 are
// [5, Cin, Cout], wp is [3, 1024]; f1..f4 are [S, l2..l5, Cout], f5 is [S, l5].
extern "C" int mpd_stack_forward(const void* a0, const void* w1, const void* b1, const void* w2, const void* b2,
                                 const void* w3, const void* b3, const void* w4, const void* b4, const void* wp,
                                 const void* bp, void* f1, void* f2, void* f3, void* f4, void* f5, int S, int l1,
                                 int l2, int l3, int l4, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto c = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  launch_layer(c(a0), c(w1), c(b1), m(f1), S, l1, l2, 32, 128, 3, s);
  launch_layer(c(f1), c(w2), c(b2), m(f2), S, l2, l3, 128, 512, 3, s);
  launch_layer(c(f2), c(w3), c(b3), m(f3), S, l3, l4, 512, 1024, 3, s);
  launch_layer(c(f3), c(w4), c(b4), m(f4), S, l4, l4, 1024, 1024, 1, s);
  const int M = S * l4;
  conv_post_kernel<<<(M + 7) / 8, 256, 0, s>>>(c(f4), c(wp), c(bp), m(f5), M, l4, 1024);
  return (int)cudaGetLastError();
}
