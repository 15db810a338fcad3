// Hopper warpgroup matrix-multiply primitives (sm_90a only: `wgmma` does not
// exist on plain sm_90, and _build.py compiles for arch=compute_90a).
//
// One warpgroup (4 consecutive warps, 128 threads) issues each product
// together: D[64 x N] (+)= A[64 x 16] * B[16 x N] in f32, bf16 operands, N =
// 64 (the attention cores), 128 or 256 (the tap GEMM of common.cuh; 256 also
// the ISTFT head). B always comes from shared memory through a 64-bit matrix
// descriptor; A from a descriptor or from registers.
//
// Shared-memory tiles here are always 64 rows of 64 bf16 (128 bytes a row) in
// the 128-byte swizzle: the 16-byte chunk c of row r is stored at chunk
// c ^ (r % 8) of that row, and a tile starts on a 1024-byte boundary because
// the hardware applies the XOR to address bits [4:6] from bits [7:9] of the
// absolute shared-memory address. The contiguous dimension of a tile's rows is
// either the product's depth K ("K-major", no transpose) or its M / N
// ("MN-major", transposed; allowed for 16-bit types only).
//
// Below the products: the tile helpers the wgmma attention cores share (the
// serving core of attention.cuh and the training core of attention_train.cuh):
// element access, cp.async copies of a 64 x 64 tile from device memory and
// its store back, bf16 packing of A fragments, and register fences; then the
// mbarrier, TMA and register-sharing primitives of the tap GEMM's pipeline.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace stts {

constexpr int WG_THREADS = 128;            // one warpgroup
constexpr int WG_TILE_BYTES = 64 * 64 * 2;  // one swizzled 64 x 64 bf16 tile

// byte offset of element (row r, column c) of a swizzled 64 x 64 bf16 tile
__device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The matrix descriptor of a swizzled 64 x 64 bf16 tile at `tile` (1024-byte
// aligned):
//   bits [0, 14)  start address >> 4
//   bits [16, 30) leading byte offset >> 4 (LBO)
//   bits [32, 46) stride byte offset >> 4 (SBO)
//   bits [49, 52) base offset: 0, since every tile starts 1024-byte aligned
//   bits [62, 64) layout: 1 = 128-byte swizzle
// K-major: SBO is the step between groups of 8 rows along M/N (8 rows of 128
// bytes = 1024); the 16-deep K slice (32 bytes) lies inside one swizzled row,
// so LBO is unused and set to 1 as the ISA asks. MN-major: the 64 M/N values
// of a row are one swizzle atom, so the step to a next atom along M/N is never
// taken; the step between groups of 8 rows along K is 1024 bytes. The ISA
// names that step SBO; LBO is given the same value, so the descriptor reads
// the same whichever of the two the hardware takes for the unused one.
template <bool MN_MAJOR>
__device__ __forceinline__ uint64_t make_desc(uint32_t tile) {
  const uint64_t lbo = MN_MAJOR ? (1024 >> 4) : 1, sbo = 1024 >> 4;
  return (uint64_t)((tile & 0x3FFFF) >> 4) | (lbo << 16) | (sbo << 32) | (1ull << 62);
}

// The descriptor of the k-th 16-deep slice. K-major: +32 bytes inside each
// 128-byte row; the hardware swizzles the computed address, so the start
// address simply advances and the XOR with the row still finds each chunk.
// MN-major: 16 rows down, +2048 bytes, a whole number of swizzle atoms.
template <bool MN_MAJOR>
__device__ __forceinline__ uint64_t desc_k(uint64_t desc, int k) {
  return desc + (uint64_t)(MN_MAJOR ? (k * 2048) >> 4 : (k * 32) >> 4);
}

// wgmma.fence: orders this warpgroup's register accesses (the accumulators,
// and A fragments in registers) before the asynchronous products that follow.
// Needed before the first wgmma and again whenever the accumulators or A
// fragments were written by ordinary instructions since the last one.
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's ordinary (generic-proxy) shared-memory writes visible to
// the async proxy that wgmma reads through. Every writing thread runs it after
// its writes and before the barrier that precedes the wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The accumulator of one m64n64 product: thread t of the warpgroup holds rows
// r0 = 16 * (t / 32) + (t % 32) / 4 and r0 + 8; d[4j + 2h + e] is
// (row r0 + 8h, column 8j + 2 (t % 4) + e).
#define STTS_ACC32(d)                                                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),    \
      "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),     \
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (+)= A B, A and B from shared-memory descriptors; accumulate = 0 ignores d.
// TA / TB: the transpose bits (1 = MN-major tile).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : STTS_ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// d += A B, A from registers: a[0..3] hold the thread's bf16 pairs of the
// 64 x 16 A tile in the accumulator's row layout (a[0] row r0, columns
// 2 (t % 4) + {0, 1}; a[1] row r0 + 8, same columns; a[2] and a[3] the same at
// columns + 8), the lower column in the low half. B from a descriptor.
template <int TB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : STTS_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

// The accumulator of one m64n128 product: as STTS_ACC32, for j < 16.
#define STTS_ACC64(d)                                                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),    \
      "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),     \
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]),    \
      "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),    \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),    \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),    \
      "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// The products of width N (64, 128 or 256) with A and B from shared-memory
// descriptors: d (+)= A[64 x 16] B[16 x N]; d holds N / 2 values a thread in
// the accumulator layout above (column 8j + 2 (t % 4) + e for j < N / 8).
template <int N, int TA, int TB>
struct WgmmaSS;

template <int TA, int TB>
struct WgmmaSS<64, TA, TB> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
    wgmma_m64n64k16_ss<TA, TB>(d, da, db, accumulate);
  }
};

template <int TA, int TB>
struct WgmmaSS<128, TA, TB> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, %67, %68;\n}\n"
        : STTS_ACC64(d)
        : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
  }
};

// The accumulator of one m64n256 product: as STTS_ACC32, for j < 32.
#define STTS_ACC128(d)                                                                                           \
  STTS_ACC64(d), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),      \
      "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),     \
      "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]),     \
      "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),     \
      "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),  \
      "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),          \
      "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]),          \
      "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),          \
      "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

template <int TA, int TB>
struct WgmmaSS<256, TA, TB> {
  static __device__ __forceinline__ void run(float (&d)[128], uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p, 1, 1, %131, %132;\n}\n"
        : STTS_ACC128(d)
        : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
  }
};

#undef STTS_ACC32
#undef STTS_ACC64
#undef STTS_ACC128

// The descriptor of an MN-major operand N = 128 wide, held as two swizzled
// 64 x 64 tiles (64 rows along K, 64 values along M/N each) `atom_bytes`
// apart: LBO is the step between the two 64-wide swizzle atoms along M/N, SBO
// the step between groups of 8 rows along K (1024 bytes). A K-major operand
// 128 rows wide needs no such form: its two tiles lie back to back, and 16
// groups of 8 rows 1024 bytes apart are make_desc<false>'s SBO.
__device__ __forceinline__ uint64_t make_desc_mn(uint32_t tile, uint32_t atom_bytes) {
  const uint64_t lbo = atom_bytes >> 4, sbo = 1024 >> 4;
  return (uint64_t)((tile & 0x3FFFF) >> 4) | (lbo << 16) | (sbo << 32) | (1ull << 62);
}

// cp.async of 16 bytes into shared memory; the bytes past `src_bytes` (0-16)
// are zero-filled, so a chunk past the end of the data reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
// cp.async of 4 bytes (zero-filled when src_bytes is 0)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the first 1024-byte boundary at or after p (dynamic shared memory is only
// 16-byte aligned; the swizzle XORs absolute address bits)
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) { return p + ((1024 - (smem_addr(p) & 1023)) & 1023); }

__device__ __forceinline__ float ld_tile(const uint8_t* tile, int r, int c) {
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(tile + swz(r, c)));
}
__device__ __forceinline__ void st_tile(uint8_t* tile, int r, int c, float x) {
  *reinterpret_cast<__nv_bfloat16*>(tile + swz(r, c)) = __float2bfloat16(x);
}

// Tile element (row i, column c) = src[i * rs + c] for i < rows and c < cols,
// else 0. vec: 16-byte cp.async per chunk (src and rs multiples of 8 values,
// 16-byte aligned), committed by the caller; else plain loads and stores.
__device__ __forceinline__ void load_tile(uint8_t* tile, const __nv_bfloat16* src, long long rs, int rows, int cols,
                                          bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    const uint32_t base = smem_addr(tile);
#pragma unroll
    for (int kk = 0; kk < 64 * 8 / WG_THREADS; ++kk) {
      const int e = tid + kk * WG_THREADS, i = e >> 3, c = e & 7;
      const int n = i < rows ? min(max(cols - c * 8, 0), 8) : 0;
      cp_async16(base + i * 128 + (((c ^ i) & 7) << 4), n > 0 ? src + i * rs + c * 8 : src, n * 2);
    }
  } else {
    for (int e = tid; e < 64 * 64; e += WG_THREADS) {
      const int i = e >> 6, c = e & 63;
      *reinterpret_cast<__nv_bfloat16*>(tile + swz(i, c)) =
          (i < rows && c < cols) ? src[i * rs + c] : __ushort_as_bfloat16(0);
    }
  }
}

// dst[i * rs + c] = tile element (i, c) for i < rows and c < cols (vec as in
// load_tile, where cols is then a multiple of 8)
__device__ __forceinline__ void store_tile(const uint8_t* tile, __nv_bfloat16* dst, long long rs, int rows, int cols,
                                           bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
#pragma unroll
    for (int kk = 0; kk < 64 * 8 / WG_THREADS; ++kk) {
      const int e = tid + kk * WG_THREADS, i = e >> 3, c = e & 7;
      if (i < rows && c * 8 < cols)
        *reinterpret_cast<uint4*>(dst + i * rs + c * 8) =
            *reinterpret_cast<const uint4*>(tile + i * 128 + (((c ^ i) & 7) << 4));
    }
  } else {
    for (int e = tid; e < 64 * 64; e += WG_THREADS) {
      const int i = e >> 6, c = e & 63;
      if (i < rows && c < cols) dst[i * rs + c] = *reinterpret_cast<const __nv_bfloat16*>(tile + swz(i, c));
    }
  }
}

// keeps the compiler from moving accesses of a wgmma's registers across the
// asynchronous product (accumulators are read only after wgmma_wait)
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// two f32 values rounded to bf16 and packed, the lower column in the low half
// (one register of an A fragment)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- mbarriers, TMA and warp specialisation (the tap GEMM of common.cuh) --
// An mbarrier is 8 bytes of shared memory; `bar` below is its shared-memory
// address. A phase completes when `count` arrivals (set at init) and every
// byte announced by expect_tx have come; waiters name the parity of the phase
// they wait for.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// makes the inits visible to the async proxy (TMA) and the other threads; then a block barrier
__device__ __forceinline__ void mbar_fence_init() { asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory"); }
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// one arrival that also announces `bytes` to come by TMA
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
// one arrival, made when every cp.async this thread started so far has landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
// (the spin stays inside the asm, so the warp leaves it converged for the
// .aligned wgmma instructions that follow)
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// TMA: the box at coordinates (c0 innermost, c1, c2) of the tensor map at
// `map` (a __grid_constant__ kernel parameter) into shared memory at `dst`,
// completing `bytes` (the whole box, zeros out of bounds included) on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map, int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map, int c0, int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// a warpgroup gives up registers down to N a thread, or takes them up to N
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// a barrier of `threads` threads (whole warps) under id 1-15; id 0 is __syncthreads
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

}  // namespace stts
