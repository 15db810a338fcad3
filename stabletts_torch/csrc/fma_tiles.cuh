// The FMA tile products of the f32 attention cores: attention_train.cuh's
// training core and attention.cuh's f32 serving core. True f32 on the FP32
// pipes, each output one fmaf chain over the contraction in ascending order.
//
// Tiles are [rows][64] floats of one head (HD = 64 features, or TK = 64 keys a
// row), read by 16-byte loads along their rows. A thread of FA_THREADS holds NI
// consecutive rows of the first operand, read by the eight lanes of a
// quarter-warp at one address (a broadcast), and NJ columns of the second,
// 4 tx .. 4 tx + 3 (and 32 + 4 tx .. 32 + 4 tx + 3 for NJ = 8), read at eight
// distinct 16-byte chunks by those eight lanes. A tile read as a second
// operand along its rows is therefore swizzled: chunk c of row r lies at chunk
// c ^ ((r >> 2) & 7) (fa_at), so those chunks fall in distinct bank groups.
#pragma once

#include "common.cuh"

namespace stts {

constexpr int HD = 64, TK = 64;  // head width; keys a tile
constexpr int FA_THREADS = 128;

// float offset of chunk c (16 bytes) of row r of an [rows][64] tile: as it
// lies, or swizzled (SWZ) at chunk c ^ ((r >> 2) & 7)
template <bool SWZ>
__device__ __forceinline__ int fa_at(int r, int c) { return r * HD + 4 * (SWZ ? c ^ ((r >> 2) & 7) : c); }
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float x, float y, float z, float w) {
  *reinterpret_cast<float4*>(p) = make_float4(x, y, z, w);
}
// four consecutive floats to device memory: one 16-byte store, or four where !vec
__device__ __forceinline__ void fa_store4(float* p, float x, float y, float z, float w, bool vec) {
  if (vec) {
    st4(p, x, y, z, w);
  } else {
    p[0] = x, p[1] = y, p[2] = z, p[3] = w;
  }
}

// acc[i][j] += sum_d A[ra + i][d] B[rb(j)][d] (a product with B^T): A as it
// lies, B swizzled; rb(j) = cb + (j & 3) + 32 (j >> 2) with cb % 4 == 0, so all
// of this thread's B rows share the swizzle (cb >> 2) & 7, and the lanes of a
// quarter-warp (cb / 4 = 0..7 mod 8) read eight distinct chunks. Each output is
// one fmaf chain over d ascending.
template <int NI, int NJ>
__device__ __forceinline__ void fa_mma_nt(float (&acc)[NI][NJ], const float* A, int ra, const float* B, int cb) {
  const int s = (cb >> 2) & 7;
  const float* a0 = A + ra * HD;
  const float* b0 = B + cb * HD;
#pragma unroll 2
  for (int c = 0; c < 16; ++c) {
    const int pc = 4 * (c ^ s);
    float4 b[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) b[j] = ld4(b0 + ((j & 3) + 32 * (j >> 2)) * HD + pc);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const float4 a = ld4(a0 + i * HD + 4 * c);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
      }
    }
  }
}

// acc[i][j] += sum_k A[ra + i][k] B[k][cb(j)] over B's DEPTH rows: A as it lies (row stride LDA),
// B swizzled; column cb(j) = 4 tx + (j & 3) + 32 (j >> 2) (tx < 16 for NJ = 4,
// < 8 for NJ = 8). Rows 4 kc .. 4 kc + 3 of B share the swizzle kc & 7, and the
// lanes of a quarter-warp (tx = 0..7 mod 8) read eight distinct chunks. Each
// output is one fmaf chain over k ascending.
template <int NJ, int DEPTH = TK, int LDA = HD, int NI>
__device__ __forceinline__ void fa_mma_nn(float (&acc)[NI][NJ], const float* A, int ra, const float* B, int tx) {
  const float* a0 = A + ra * LDA;
#pragma unroll 2
  for (int kc = 0; kc < DEPTH / 4; ++kc) {
    const float* bk = B + 4 * kc * HD + 4 * (tx ^ (kc & 7));
    float4 b[4][NJ / 4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < NJ / 4; ++h) b[kk][h] = ld4(bk + kk * HD + 32 * h);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const float4 a4 = ld4(a0 + i * LDA + 4 * kc);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < NJ / 4; ++h) {
          acc[i][4 * h + 0] = fmaf(a[kk], b[kk][h].x, acc[i][4 * h + 0]);
          acc[i][4 * h + 1] = fmaf(a[kk], b[kk][h].y, acc[i][4 * h + 1]);
          acc[i][4 * h + 2] = fmaf(a[kk], b[kk][h].z, acc[i][4 * h + 2]);
          acc[i][4 * h + 3] = fmaf(a[kk], b[kk][h].w, acc[i][4 * h + 3]);
        }
    }
  }
}

template <int NI, int NJ>
__device__ __forceinline__ void fa_zero(float (&a)[NI][NJ]) {
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) a[i][j] = 0.f;
}

// acc[i][j] += sum_d A[d][ra + i] B[d][cb(j)] (a product with A^T, both
// operands [64 features][rows] as they lie, unswizzled; A's row stride LDA):
// cb(j) = 4 tx + (j & 3) + 32 (j >> 2), so the lanes of a quarter-warp read
// B at eight distinct chunks. Each output is one fmaf chain over d ascending.
template <int LDA, int NI>
__device__ __forceinline__ void fa_mma_tn(float (&acc)[NI][8], const float* A, int ra, const float* B, int tx) {
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float a[NI];
#pragma unroll
    for (int p = 0; p < NI / 4; ++p) {
      const float4 x = ld4(A + d * LDA + ra + 4 * p);
      a[4 * p] = x.x, a[4 * p + 1] = x.y, a[4 * p + 2] = x.z, a[4 * p + 3] = x.w;
    }
    const float4 b0 = ld4(B + d * TK + 4 * tx), b1 = ld4(B + d * TK + 32 + 4 * tx);
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

}  // namespace stts
