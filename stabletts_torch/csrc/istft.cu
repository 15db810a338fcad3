// The Vocos ISTFT head on Hopper (sm_90a): a spectrum pass from the head's
// logits into an aligned operand, then the windowed iDFT product with the
// overlap-add, envelope and trim in its epilogue.
//
// Replaces: the JAX package's ops/istft_pallas.py::istft_same_fused (reached via
// istft_same_fused_diff), which keeps a batch element's [T, n_fft] frames in
// VMEM and overlap-adds them there, and the XLA lines in front of it
// (models/vocos.py ISTFTHead: exp, clip, cos, sin; istft_pallas.py's
// concatenate and astype), which XLA fuses into the kernel's input pass.
//
// 1. `istft_spectrum_kernel`: one pass over the Dense output [B, T, n_fft + 2]
//    (log-magnitude | phase, the model's dtype), or over a spectrum re / im
//    [B, T, nf], nf = n_fft / 2 + 1. In f32: mag = min(expf(m), 100), re =
//    mag * cosf(p), im = mag * sinf(p) (the plain chain's operations: no fast
//    math), rounded once to the product's type. It writes the operand A
//    [B * (T + R - 1), KP]: item b's frame f at row b * (T + R - 1) + R - 1 +
//    f, its first R - 1 rows zero (as are frames at or past a length), columns
//    re[0 .. nf - 1] | im[1 .. nf - 1] | zeros to KP = the next multiple of 8
//    (im[0] meets an all-zero row of the iDFT matrix; im[nf - 1] is kept: its
//    row is f32 rounding residue, but not zero). A row is a whole number of
//    16-byte chunks, so the product loads it by cp.async, 16 bytes at a time.
//    Bound by bytes: the logits read once, the operand written once.
// 2. The product. With those zero rows, output row O of the flattened [B *
//    (T + R - 1), hop] signal is sum_{j < R} A[O + R - 1 - j] @ W[:, j hop +
//    n], W the packed [KP, n_fft] windowed iDFT matrix. A CTA loads BM rows
//    of A at a time, from O0 = tile * (BM - R + 1), with a BN / R-column block
//    of each of the R taps' W columns, so every row of A reaches shared memory
//    once per k step for all R taps; its BM x BN frames tile is the R partial
//    tiles P_j, and it owns the BM - R + 1 output rows O0 .. whose R
//    contributions all lie in its rows: out[u] = ((P_0[u + R - 1] +
//    P_1[u + R - 2]) + ...) + P_{R-1}[u], the plain overlap-add's order. The
//    next tile reads R - 1 of the same rows again (2.4% more products at BM =
//    128) instead of a halo summed across CTAs: one launch, no atomics, the
//    same bits every run. The epilogue multiplies by the reciprocal envelope
//    (static) or divides by each item's envelope over its valid frames
//    (lengths), and writes the samples inside the trimmed window. A tile
//    whose BM rows of A are all zero (padding, or frames at or past an item's
//    length) writes its zeros and stops before the product.
//    - bf16 (`istft_wgmma_kernel`): BM = 128, BN = 256 (64 columns a tap),
//      two consumer warpgroups of one m64n256k16 wgmma each (the four taps'
//      blocks) a 16-deep slice, a 4-deep cp.async ring of 48 KB stages (A as two
//      swizzled 64 x 64 K-major tiles, W as four MN-major ones), one CTA an
//      SM. What bounds it: its products, 2 * rows * KP * n_fft FLOPs (1.63
//      TFLOP at B = 192, T = 1000); the fills from L2 are A's rows once per
//      hop / 64 column blocks and W once per 128-row tile.
//    - f32 (`istft_f32_kernel<BM>`): the f32 tap GEMM's register-blocked
//      FMA tile (common.cuh: a 4-deep cp.async ring of 16-deep k steps, A
//      transposed into [k][m] one step ahead, each output one fmaf chain over
//      k ascending), BM = BN = 128 (8 x 8 a thread) where such tiles fill
//      every SM twice, else 64 (4 x 4; a request's 316 rows then run 192
//      CTAs).
//      What bounds it: its products on the FMA pipes, true f32 (no TF32).
#include "common.cuh"

#include <math.h>

using namespace stts;

namespace {

constexpr int R = 4;  // taps, n_fft / hop: the shipped Vocos head (2048 / 512)

struct IstftArgs {
  const void* a;        // [rows, kp] the packed spectrum
  const void* w;        // [kp, n_fft] the packed windowed iDFT matrix
  const float* envinv;  // [(T + R - 1) * hop] 1 / envelope (static), or nullptr
  const float* wsq;     // [n_fft] window^2 (lengths mode)
  const int* lens;      // [B] or nullptr
  float* out;           // [B, T * hop]
  int T, hop, n_fft, kp, pad;
  int rows;             // B * (T + R - 1): output rows, and A's rows
};

// frames of item b that hold a spectrum
__device__ __forceinline__ int valid_frames(const int* lens, int b, int T) {
  return lens ? min(max(lens[b], 0), T) : T;
}

// whether any of A's rows [row0, row0 + n) holds a frame (every thread)
__device__ __forceinline__ bool tile_live(const IstftArgs& p, int row0, int n) {
  bool live = false;
  const int tr = p.T + R - 1;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int row = row0 + i;
    if (row >= p.rows) break;
    const int b = row / tr, f = row - b * tr - (R - 1);
    live |= f >= 0 && f < valid_frames(p.lens, b, p.T);
  }
  return __syncthreads_or(live);
}

// The owned output rows O0 .. O0 + OWN - 1, columns n0 .. n0 + BNT - 1: the
// overlap-add of P (BM x R * BNT frames tile, row stride LDP; nullptr: zeros),
// the envelope and the trim
template <int OWN, int BNT, int LDP>
__device__ __forceinline__ void istft_store(const IstftArgs& p, const float* P, int row0, int n0) {
  const int tr = p.T + R - 1;
  const long long samples = (long long)p.T * p.hop;
  for (int e = threadIdx.x; e < OWN * BNT; e += blockDim.x) {
    const int u = e / BNT, c = e - u * BNT, O = row0 + u;
    if (O >= p.rows) break;
    const int b = O / tr, o = O - b * tr, n = n0 + c;
    const long long s = (long long)o * p.hop + n - p.pad;
    if (s < 0 || s >= samples) continue;
    float y = 0.f;
    if (P) {
      y = P[(u + R - 1) * LDP + c];
#pragma unroll
      for (int j = 1; j < R; ++j) y += P[(u + R - 1 - j) * LDP + j * BNT + c];
      if (p.lens) {
        const int len = valid_frames(p.lens, b, p.T);
        float env = 0.f;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int f = o - j;
          if (f >= 0 && f < len) env += p.wsq[j * p.hop + n];
        }
        y = y / fmaxf(env, 1e-11f);
      } else {
        y = y * p.envinv[(long long)o * p.hop + n];
      }
    }
    p.out[(long long)b * samples + s] = y;
  }
}

// ---- 1. the spectrum pass --------------------------------------------------
// One CTA a row of A. LOGITS: x0 is the Dense output [B * T, 2 nf]; else x0 /
// x1 are re / im [B * T, nf] in f32.
template <typename Tin, typename Tout, bool LOGITS>
__global__ void istft_spectrum_kernel(const Tin* x0, const Tin* x1, const int* lens, Tout* a, int T, int nf,
                                      int kp) {
  const int row = blockIdx.x, tr = T + R - 1, b = row / tr, f = row - b * tr - (R - 1);
  const bool valid = f >= 0 && f < valid_frames(lens, b, T);
  const long long src = ((long long)b * T + f) * (LOGITS ? 2 * nf : nf);
  Tout* dst = a + (long long)row * kp;
  for (int k = threadIdx.x; k < nf; k += blockDim.x) {
    float re = 0.f, im = 0.f;
    if (valid) {
      if (LOGITS) {
        float mag = expf(to_f(x0[src + k]));
        mag = mag > 100.f ? 100.f : mag;  // torch.clamp(max=1e2): NaN stays NaN
        const float ph = to_f(x0[src + nf + k]);
        re = mag * cosf(ph);
        im = mag * sinf(ph);
      } else {
        re = to_f(x0[src + k]);
        im = to_f(x1[src + k]);
      }
    }
    dst[k] = from_f<Tout>(re);
    if (k > 0) dst[nf - 1 + k] = from_f<Tout>(im);
  }
  for (int k = 2 * nf - 1 + threadIdx.x; k < kp; k += blockDim.x) dst[k] = from_f<Tout>(0.f);
}

// ---- 2a. the bf16 product on wgmma ----------------------------------------
constexpr int IB_BM = 128, IB_BN = 256, IB_BNT = IB_BN / R, IB_OWN = IB_BM - (R - 1);
constexpr int IB_BK = 64, IB_STAGES = 4, IB_THREADS = 256;
constexpr int IB_INFLIGHT = 1;                     // product groups a warpgroup keeps in flight
constexpr int IB_A_BYTES = 2 * WG_TILE_BYTES;      // 128 rows x 64 k
constexpr int IB_STAGE = IB_A_BYTES + 4 * WG_TILE_BYTES;  // + 64 k x 256 columns
constexpr int IB_LDP = IB_BN + 8;                  // the staged tile's row stride: float2 stores free of conflicts
constexpr int IB_SMEM = IB_STAGES * IB_STAGE + 1024;
static_assert(IB_BM * IB_LDP * 4 <= IB_STAGES * IB_STAGE, "the staged frames tile fits in the ring");
static_assert(IB_BNT % 8 == 0, "a tap's column block is whole 16-byte chunks");

// stage <- A's rows row0 .. row0 + 127 and W's four column blocks at k step `step`
__device__ __forceinline__ void ib_load(const IstftArgs& p, uint8_t* sa, int row0, int n0, int step) {
  const bf16* A = static_cast<const bf16*>(p.a);
  const bf16* W = static_cast<const bf16*>(p.w);
  const int tid = threadIdx.x, k0 = step * IB_BK;
  uint8_t* sb = sa + IB_A_BYTES;
  // A: 128 rows x 8 chunks; tile r / 64, K-major, 128-byte swizzle
#pragma unroll
  for (int i = 0; i < IB_BM * 8 / IB_THREADS; ++i) {
    const int e = tid + IB_THREADS * i, r = e >> 3, c = e & 7, k = k0 + 8 * c, row = row0 + r;
    const bool in = row < p.rows && k < p.kp;
    cp_async16(smem_addr(sa + (r >> 6) * WG_TILE_BYTES) + (r & 63) * 128 + (((c ^ r) & 7) << 4),
               in ? A + (long long)row * p.kp + k : A, in ? 16 : 0);
  }
  // W: 64 k rows x 32 chunks; chunk cb is column 8 (cb % 8) of tap cb / 8's block, tile cb / 8, MN-major
#pragma unroll
  for (int i = 0; i < 64 * (IB_BN / 8) / IB_THREADS; ++i) {
    const int e = tid + IB_THREADS * i, kr = e >> 5, cb = e & 31, k = k0 + kr;
    const int nn = 8 * cb, col = (nn / IB_BNT) * p.hop + n0 + nn % IB_BNT;
    const bool in = k < p.kp;
    cp_async16(smem_addr(sb + (cb >> 3) * WG_TILE_BYTES) + kr * 128 + ((((cb & 7) ^ kr) & 7) << 4),
               in ? W + (long long)k * p.n_fft + col : W, in ? 16 : 0);
  }
}

// fence_regs for the 128 accumulators of an m64n256 product
__device__ __forceinline__ void ib_fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__global__ void __launch_bounds__(IB_THREADS, 1) istft_wgmma_kernel(IstftArgs p) {
  extern __shared__ uint8_t ib_smem[];
  uint8_t* ring = align_1024(ib_smem);
  const int tid = threadIdx.x, wg = tid / WG_THREADS, lt = tid % WG_THREADS;
  const int row0 = blockIdx.y * IB_OWN, n0 = blockIdx.x * IB_BNT;
  if (!tile_live(p, row0, IB_BM)) {
    istft_store<IB_OWN, IB_BNT, IB_LDP>(p, nullptr, row0, n0);
    return;
  }
  const int steps = (p.kp + IB_BK - 1) / IB_BK;
  constexpr int AHEAD = IB_STAGES - 1 - IB_INFLIGHT;  // k steps loaded ahead of the one multiplied

  float acc[128];  // this warpgroup's 64 rows x 256 columns (the four taps' blocks)
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < steps) ib_load(p, ring + s * IB_STAGE, row0, n0, s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    // this step's copies have landed for every thread, and every warpgroup's
    // products of step - 1 - IB_INFLIGHT (whose stage the load below refills)
    // are done
    cp_async_wait<AHEAD - 1>();
    fence_proxy_async();
    __syncthreads();
    const int next = step + AHEAD;
    if (next < steps) ib_load(p, ring + (next % IB_STAGES) * IB_STAGE, row0, n0, next);
    cp_async_commit();

    uint8_t* sa = ring + (step % IB_STAGES) * IB_STAGE;
    const uint64_t da = make_desc<false>(smem_addr(sa + wg * WG_TILE_BYTES));
    const uint64_t db = make_desc_mn(smem_addr(sa + IB_A_BYTES), WG_TILE_BYTES);
    // the last step holds KP - 64 (steps - 1) columns: only its slices with data run
    const int slices = min(IB_BK, p.kp - step * IB_BK + 15) / 16;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < IB_BK / 16; ++kk)
      if (kk < slices) WgmmaSS<256, 0, 1>::run(acc, desc_k<false>(da, kk), desc_k<true>(db, kk), 1);
    wgmma_commit();
    wgmma_wait<IB_INFLIGHT>();
    ib_fence_acc(acc);
  }
  wgmma_wait<0>();
  ib_fence_acc(acc);
  cp_async_wait<0>();
  __syncthreads();

  // the frames tile P [128][IB_LDP] in the ring's memory: thread lt holds rows
  // 64 wg + r0 and + 8, columns 8 j + 2 (lt % 4) + {0, 1}
  float* P = reinterpret_cast<float*>(ring);
  const int r0 = 64 * wg + 16 * (lt / 32) + (lt % 32) / 4;
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(P + (r0 + 8 * h) * IB_LDP + 8 * j + 2 * (lt % 4)) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  __syncthreads();
  istft_store<IB_OWN, IB_BNT, IB_LDP>(p, P, row0, n0);
}

// ---- 2b. the f32 product on the FMA pipes ----------------------------------
template <int BM>
__global__ void __launch_bounds__(FG_THREADS, FG_CTAS_PER_SM) istft_f32_kernel(IstftArgs p) {
  constexpr int BN = BM, BNT = BN / R, OWN = BM - (R - 1), LDP = BN + 4;
  using L = FgTile<BM, BN, false>;
  static_assert(BM * LDP <= L::RING, "the staged frames tile fits in the ring");
  static_assert(BNT % 4 == 0, "a tap's column block is whole 16-byte chunks");
  extern __shared__ float4 if_smem[];
  float* ring = reinterpret_cast<float*>(if_smem);  // FG_STAGES slots: A's rows as they lie, then the W tile
  float* tbuf = ring + FG_STAGES * L::SLOT;         // two buffers: A as [16][LDA]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // this thread's rows 64 p + 4 tr + i and columns 64 q + 4 tc + j
  const int tr = (warp >> 1) * 4 + (lane >> 3), tc = (warp & 1) * 8 + (lane & 7);
  const int row0 = blockIdx.y * OWN, n0 = blockIdx.x * BNT;
  if (!tile_live(p, row0, BM)) {
    istft_store<OWN, BNT, LDP>(p, nullptr, row0, n0);
    return;
  }
  const float* A = static_cast<const float*>(p.a);
  const float* W = static_cast<const float*>(p.w);
  const int steps = (p.kp + FG_BK - 1) / FG_BK;

  float acc[L::TM][L::TN];
#pragma unroll
  for (int i = 0; i < L::TM; ++i)
#pragma unroll
    for (int j = 0; j < L::TN; ++j) acc[i][j] = 0.f;

  // the copies of k step `step` into its ring slot, 16 bytes each
  auto issue = [&](int step) {
    float* slot = ring + (step % FG_STAGES) * L::SLOT;
    const int k0 = step * FG_BK;
#pragma unroll
    for (int l = 0; l < L::AV; ++l) {
      const int e = tid + FG_THREADS * l, r = e >> 2, kq = e & 3, k = k0 + 4 * kq, row = row0 + r;
      const bool in = row < p.rows && k < p.kp;
      cp_async16(smem_addr(slot + fg_chunk(r, kq)), in ? A + (long long)row * p.kp + k : A, in ? 16 : 0);
    }
#pragma unroll
    for (int l = 0; l < L::BV; ++l) {
      const int e = tid + FG_THREADS * l, kk = e / (BN / 4), c = 4 * (e % (BN / 4)), k = k0 + kk;
      const int col = (c / BNT) * p.hop + n0 + c % BNT;
      const bool in = k < p.kp;
      cp_async16(smem_addr(slot + L::RAW_A + kk * (BN + 4) + c), in ? W + (long long)k * p.n_fft + col : W,
                 in ? 16 : 0);
    }
  };
  auto transpose = [&](int step) {
    fg_transpose<BM>(ring + (step % FG_STAGES) * L::SLOT, tbuf + (step & 1) * L::T_BUF);
  };

#pragma unroll
  for (int s = 0; s < FG_STAGES - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }
  cp_async_wait<FG_STAGES - 2>();
  __syncthreads();
  transpose(0);
  for (int step = 0; step < steps; ++step) {
    // step + 1's copies have landed for every thread, step's transposed tile
    // is written, and every thread's products of step - 1 (whose slot and
    // transposed buffer are refilled below) are done
    cp_async_wait<FG_STAGES - 3>();
    __syncthreads();
    if (step + FG_STAGES - 1 < steps) issue(step + FG_STAGES - 1);
    cp_async_commit();
    if (step + 1 < steps) transpose(step + 1);
    fg_mma<BM, BN>(tbuf + (step & 1) * L::T_BUF, ring + (step % FG_STAGES) * L::SLOT + L::RAW_A, tr, tc, acc);
  }
  cp_async_wait<0>();
  __syncthreads();

  float* P = ring;  // the frames tile [BM][LDP]
#pragma unroll
  for (int i = 0; i < L::TM; ++i)
#pragma unroll
    for (int q = 0; q < L::TN / 4; ++q)
      *reinterpret_cast<float4*>(P + (64 * (i >> 2) + 4 * tr + (i & 3)) * LDP + 64 * q + 4 * tc) =
          make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2], acc[i][4 * q + 3]);
  __syncthreads();
  istft_store<OWN, BNT, LDP>(p, P, row0, n0);
}

// The f32 product's tile for `rows` output rows: 128 where its grid fills
// every SM with FG_CTAS_PER_SM CTAs, else 64. Measured on the H100
// (tools/ab_istft.py, PERF.md): 64 is faster at (1, 1000) (144 tiles of 128)
// and at (1, 1024) with lengths [313]; 128 at (8, 1000) (1040 tiles).
inline int f32_tile(int rows, int hop) {
  const long long tiles = (long long)((rows + 124) / 125) * (hop / (128 / R));
  return tiles >= FG_CTAS_PER_SM * NUM_SMS ? 128 : 64;
}

template <int BM>
void launch_f32(const IstftArgs& p, cudaStream_t stream) {
  constexpr int smem = FgTile<BM, BM, false>::SMEM, own = BM - (R - 1);
  const dim3 grid(p.hop / (BM / R), (p.rows + own - 1) / own);
  cudaFuncSetAttribute(istft_f32_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  istft_f32_kernel<BM><<<grid, FG_THREADS, smem, stream>>>(p);
}

}  // namespace

// The operand A [B * (T + R - 1), kp] from the Dense output x [B, T, 2 nf]
// (x_bf16: bf16, else f32) or, with im non-null, from re = x, im [B, T, nf]
// in f32; a_bf16: A in bf16, else f32.
extern "C" int istft_spectrum(const void* x, const void* im, const void* lens, void* a, int B, int T, int nf,
                              int kp, int use_lengths, int x_bf16, int a_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ln = use_lengths ? static_cast<const int*>(lens) : nullptr;
  const dim3 grid(B * (T + R - 1)), block(256);
  if (im) {
    const float* re = static_cast<const float*>(x);
    const float* i1 = static_cast<const float*>(im);
    if (a_bf16)
      istft_spectrum_kernel<float, bf16, false><<<grid, block, 0, s>>>(re, i1, ln, (bf16*)a, T, nf, kp);
    else
      istft_spectrum_kernel<float, float, false><<<grid, block, 0, s>>>(re, i1, ln, (float*)a, T, nf, kp);
  } else if (x_bf16) {
    const bf16* xb = static_cast<const bf16*>(x);
    if (a_bf16)
      istft_spectrum_kernel<bf16, bf16, true><<<grid, block, 0, s>>>(xb, xb, ln, (bf16*)a, T, nf, kp);
    else
      istft_spectrum_kernel<bf16, float, true><<<grid, block, 0, s>>>(xb, xb, ln, (float*)a, T, nf, kp);
  } else {
    const float* xf = static_cast<const float*>(x);
    if (a_bf16)
      istft_spectrum_kernel<float, bf16, true><<<grid, block, 0, s>>>(xf, xf, ln, (bf16*)a, T, nf, kp);
    else
      istft_spectrum_kernel<float, float, true><<<grid, block, 0, s>>>(xf, xf, ln, (float*)a, T, nf, kp);
  }
  return (int)cudaGetLastError();
}

// The waveform out [B, T * hop] from A and the packed W (is_bf16: both bf16,
// else f32); tile: the f32 product's BM (0: by the grid, else 64 or 128).
extern "C" int istft_forward(const void* a, const void* w, const void* envinv, const void* wsq, const void* lens,
                             void* out, int B, int T, int n_fft, int hop, int kp, int use_lengths, int is_bf16,
                             int tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_fft != R * hop || hop % IB_BNT != 0 || kp % 8 != 0) return (int)cudaErrorInvalidValue;
  IstftArgs p{a, w, use_lengths ? nullptr : static_cast<const float*>(envinv), static_cast<const float*>(wsq),
              use_lengths ? static_cast<const int*>(lens) : nullptr, static_cast<float*>(out),
              T, hop, n_fft, kp, (n_fft - hop) / 2, B * (T + R - 1)};
  if (is_bf16) {
    const dim3 grid(hop / IB_BNT, (p.rows + IB_OWN - 1) / IB_OWN);
    cudaFuncSetAttribute(istft_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, IB_SMEM);
    istft_wgmma_kernel<<<grid, IB_THREADS, IB_SMEM, s>>>(p);
  } else {
    if (tile == 0) tile = f32_tile(p.rows, hop);
    if (tile == 128)
      launch_f32<128>(p, s);
    else if (tile == 64)
      launch_f32<64>(p, s);
    else
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
