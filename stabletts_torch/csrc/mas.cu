// Monotonic alignment search (MAS) on Hopper (sm_90a): forward DP + backtrace.
//
// Replaces: the JAX package's ops/mas_pallas.py::maximum_path_pallas (one Pallas
// invocation streaming neg_cent rows HBM -> VMEM, keeping only the previous
// accumulated row and an int8 decision-bit table [Ty, B, Tx] in VMEM, which
// limits it to ~13 MiB of bits).
//
// Semantics (the JAX package's ops/mas.py:10-24, kept exactly): for y < t_y and x
// in the band [max(0, t_x + y - t_y), min(t_x, y + 1)),
//   value[y, x] = neg[y, x] + max(x == 0 ? (y == 0 ? 0 : -1e9) : value[y-1, x-1],
//                                 x == y ? -1e9 : value[y-1, x]);
// cells outside the band keep their raw value. The backtrace starts at
// index t_x - 1 on row t_y - 1, marks path[y, index] and moves left when
// index != 0 and (index == y or value[y-1, index] < value[y-1, index-1])
// (strict <). The y == 0 move reads a wrapped-around row in the numpy oracle;
// it comes after the last mark and cannot change the path, so it is skipped.
//
// What bounds it on the H100: latency, not bytes or operations. The DP is a
// serial chain of t_y row steps; each row is Tx independent cells. Bytes:
// neg_cent read once (B*Ty*Tx*4) and the path written once; at [32, 1000,
// 512] that is 131 MB, 0.04 ms at 3.35 TB/s, while 1000 dependent row steps
// of a few hundred cycles each take ~0.5-1 ms.
//
// Design: one CTA per batch item (the items are independent chains). The
// previous accumulated row and the current one live in shared memory (two
// rows of Tx floats); each thread owns up to MAS_PER cells of a row and
// loads its next raw row before the row barrier, so the global-memory
// latency overlaps the barrier. Each row step writes only the decision bits
// value[y-1, x] < value[y-1, x-1] to global memory as bytes (the TPU
// kernel's idea; at [32, 1000, 512] the 16 MB table cannot sit in 227 KB of
// shared memory, but stays in the 50 MB L2). Then thread 0 of the CTA
// backtraces over the bits and writes the path, which the wrapper has
// zero-filled. Any B and Ty; Tx <= MAS_THREADS * MAS_PER = 8192.
#include "common.cuh"

using namespace stts;

namespace {

constexpr int MAS_THREADS = 1024;
constexpr int MAS_PER = 8;
constexpr float kMaxNeg = -1e9f;

__global__ void __launch_bounds__(MAS_THREADS) mas_kernel(const float* neg, const int* t_ys, const int* t_xs,
                                                          unsigned char* bits, float* path, int Ty, int Tx) {
  extern __shared__ float rows[];  // [2][Tx]
  const int b = blockIdx.x, tid = threadIdx.x;
  const int t_y = min(t_ys[b], Ty), t_x = min(t_xs[b], Tx);
  const float* nb = neg + (long long)b * Ty * Tx;
  unsigned char* db = bits + (long long)b * Ty * Tx;
  float* prev = rows;
  float* curr = rows + Tx;

  float raw[MAS_PER];
#pragma unroll
  for (int i = 0; i < MAS_PER; ++i) {
    int x = tid + i * MAS_THREADS;
    if (x < Tx) {
      prev[x] = 0.f;
      raw[i] = t_y > 0 ? nb[x] : 0.f;
    }
  }
  __syncthreads();

  for (int y = 0; y < t_y; ++y) {
    const int lo = max(0, t_x + y - t_y), hi = min(t_x, y + 1);
#pragma unroll
    for (int i = 0; i < MAS_PER; ++i) {
      int x = tid + i * MAS_THREADS;
      if (x < Tx) {
        float p = prev[x];
        float pl = x > 0 ? prev[x - 1] : 0.f;
        float v_cur = x == y ? kMaxNeg : p;
        float v_prev = x == 0 ? (y == 0 ? 0.f : kMaxNeg) : pl;
        curr[x] = (x >= lo && x < hi) ? raw[i] + fmaxf(v_prev, v_cur) : raw[i];
        db[(long long)y * Tx + x] = (x > 0 && p < pl) ? 1 : 0;
        if (y + 1 < t_y) raw[i] = nb[(long long)(y + 1) * Tx + x];
      }
    }
    __syncthreads();
    float* tmp = prev;
    prev = curr;
    curr = tmp;
  }

  // the bits written above are visible to the whole CTA after the barrier
  if (tid == 0 && t_x > 0) {
    int index = t_x - 1;
    for (int y = t_y - 1; y >= 0; --y) {
      path[((long long)b * Ty + y) * Tx + index] = 1.f;
      if (y > 0 && index != 0 && (index == y || db[(long long)y * Tx + index])) index -= 1;
    }
  }
}

}  // namespace

extern "C" int mas_max_tx() { return MAS_THREADS * MAS_PER; }

extern "C" int mas_forward(const void* neg, const void* t_ys, const void* t_xs, void* bits, void* path, int B,
                           int Ty, int Tx, void* stream) {
  if (Tx > MAS_THREADS * MAS_PER || Tx < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = 2 * Tx * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(mas_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  mas_kernel<<<B, MAS_THREADS, smem, s>>>(static_cast<const float*>(neg), static_cast<const int*>(t_ys),
                                          static_cast<const int*>(t_xs), static_cast<unsigned char*>(bits),
                                          static_cast<float*>(path), Ty, Tx);
  return (int)cudaGetLastError();
}
