// Shared-memory throughput of 16-byte loads (LDS.128) by address pattern, on
// one GPU: four warps' patterns of the FMA kernels' operand reads. Prints one
// JSON line per pattern with the ns one SM spends per warp-wide load.
//   0: every lane of the warp reads one address
//   1: the eight lanes of each quarter-warp read eight distinct 16-byte
//      chunks, the same eight in every quarter-warp (a product's second
//      operand read by a 4 x 8 thread layout)
//   2: 32 distinct consecutive chunks
//   3: one address per quarter-warp, four rows 1 KB apart
// Build and run on a machine with the CUDA toolkit:
//   nvcc -O3 -gencode arch=compute_90a,code=sm_90a -o build/smem_probe stabletts_torch/tools/smem_probe.cu
//   build/smem_probe
#include <cstdio>

#include <cuda_runtime.h>

__global__ void lds_loop(float* out, int mode, int iters) {
  __shared__ __align__(16) float sm[4096];
  for (int i = threadIdx.x; i < 4096; i += blockDim.x) sm[i] = i * 0.001f;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int off = mode == 0 ? 0 : mode == 1 ? 4 * (lane & 7) : mode == 2 ? 4 * lane : 4 * (lane >> 3) * 64;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(sm + ((off + 256 * r + it * 4) & 4095));
      acc.x += v.x, acc.y += v.y, acc.z += v.z, acc.w += v.w;
    }
  }
  if (acc.x == 12345.f) out[threadIdx.x] = acc.y + acc.z + acc.w;  // keeps the loads
}

int main() {
  float* out;
  cudaMalloc(&out, 4096);
  cudaEvent_t start, stop;
  cudaEventCreate(&start);
  cudaEventCreate(&stop);
  int sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int blocks = sms * 4, threads = 256, iters = 4096;
  for (int mode = 0; mode < 4; ++mode) {
    lds_loop<<<blocks, threads>>>(out, mode, 16);
    cudaEventRecord(start);
    lds_loop<<<blocks, threads>>>(out, mode, iters);
    cudaEventRecord(stop);
    cudaEventSynchronize(stop);
    float ms;
    cudaEventElapsedTime(&ms, start, stop);
    const double loads_per_sm = (double)blocks / sms * threads / 32 * iters * 16;
    printf("{\"pattern\": %d, \"ms\": %.3f, \"ns_per_lds128_per_sm\": %.4f}\n", mode, ms, ms * 1e6 / loads_per_sm);
  }
  cudaFree(out);
  return 0;
}
