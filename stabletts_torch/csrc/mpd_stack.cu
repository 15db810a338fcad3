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
// layer: each of layers 1-4 is one launch of common.cuh's f32 tap GEMM
// (`tap_gemm_f32_kernel`: 128 x 128 tiles at 8 x 8 outputs a thread, 64 x 64
// on a small grid, operands by 16-byte cp.async through a 4-deep ring) over
// all streams, with its row stride set to the conv's: output row l of a
// stream gathers input rows stride*l + k - 2 of that stream for tap k, zero
// outside [0, L_in) of that stream, never across streams or items, and the
// epilogue adds the bias and applies the leaky ReLU. No im2col buffer goes to
// device memory. Each output is one fmaf chain from 0 over the taps in order,
// then k ascending, then the bias added, whatever the tile. Layer 4's 21 MB of
// weights are read by every row tile and stay in the 50 MB L2. conv_post has
// one output channel: a reduction, one warp per output row over its 3 * 1024
// products. Five launches per call.
#include "common.cuh"

using namespace stts;

namespace {

constexpr float kLeak = 0.1f;

// out[m, n] = leaky(acc + bias[n]), stored f32
struct LeakyBiasEpi {
  const float* bias;
  float* out;
  int N;
  __device__ float prep(int m, int n, float acc) const {
    const float y = acc + bias[n];
    return y >= 0.f ? y : kLeak * y;
  }
  __device__ void store(int m, int n, const float* tile, int r, int c) const {
    out[(long long)m * N + n] = tile[r * (GEMM_BN + 1) + c];
  }
};

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

// out[s, l, n] = leaky(bias[n] + sum_{k < 5} sum_c in[s, stride*l + k - 2, c] * w[k, c, n]):
// in [S, l_in, c_in], w [5, c_in, c_out] as it lies, out [S, l_out, c_out]
void launch_layer(const float* in, const float* w, const float* bias, float* out, int S, int l_in, int l_out,
                  int c_in, int c_out, int stride, cudaStream_t s) {
  TapGemm g{};
  g.a0 = in; g.a1 = in; g.k_split = c_in; g.lda = c_in; g.t_in = l_in; g.t_out = l_out; g.k_in = c_in;
  g.taps = 5; g.shift0 = -2; g.shift_step = 1; g.row_len = nullptr; g.row_stride = stride;
  g.w = w; g.w_tap_stride = (long long)c_in * c_out; g.ldw = c_out; g.M = S * l_out; g.N = c_out; g.w_trans = 0;
  launch_tap_gemm<float>(g, LeakyBiasEpi{bias, out, c_out}, s);
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
