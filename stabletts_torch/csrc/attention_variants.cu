// The packed-head attention variants of the attention microbenchmark, on
// Hopper (sm_90a): instantiations of attention.cuh's core, and the rotation
// that #7 runs before its core.
//
//   attention_packed_v2_forward    out_h = softmax2(q'_h k_h^T + key_bias) v_h, q' = round(q * log2(e)/sqrt(D))
//   rope_packed_forward            q_r = RoPE(q'), k_r = RoPE(k): partial RoPE, one pass over q and k
//   attention_packed_rope_forward  #7's core: the v2 function on q_r, k_r (no pre-scaling, score scale 1)
//   attention_packed_kt_forward    the v2 function with K given channel-major, [B, C, T]
//   attention_decompose_forward    the v2 product with another softmax: which = 0 none
//                                  (out = round(q' k^T) v), 1 no max (exp2(s + bias)),
//                                  2 bf16 scores (scores, max and weights in bf16)
//
// Replaces: the JAX package's ops/attention_pallas_v2.py::fused_attention_packed,
// ops/attention_pallas.py::fused_attention_packed_rope (rope_packed_forward,
// then attention_packed_rope_forward), tools/attn_exp4.py::run_kt and
// tools/attn_exp2.py::run (its four bodies; "nomax_bf16" computes what "nomax"
// does). The TPU kernels keep a [blk_q, T] score tile and the whole K/V of an
// item in VMEM and pad T to their block.
//
// What bounds them on the H100: arithmetic, 4*B*H*T^2*D FLOPs (6.6e10 at the
// tools' B=64, T=1000, H=4) against 4*B*T*H*D elements moved; the bf16-score
// mode adds a second QK^T. The rotation is bound by its bytes: q and k read,
// q_r and k_r written, the [T, C] cos/sin tables read (131 MB in bf16 at the
// tools' shape, 0.039 ms at 3.35 TB/s).
//
// Design: attention.cuh's kernel, one CTA per (64-query tile, head, batch
// item), 64-key tiles, wgmma in bf16 and fp32 FMA in f32, every query row
// computed; q is pre-scaled and rounded on load (QPRE), so scores are in log2
// units and the key bias is added unscaled. The channel-major K is read with
// t contiguous; nothing is transposed in device memory. The bf16-score mode
// takes each row's max in a first pass over the key tiles, so every weight
// rounds against the final max as in the TPU kernel. mask is [B, T] f32 or
// null (every key valid); only keys are masked.
//
// #7 rotates q and k once, not once per grid cell as the TPU kernel does (a
// [T, C] x [C, C] MXU product per cell is cheaper there than an HBM round
// trip; on the H100 the round trip is ~0.04 ms and rotating each K tile in
// shared memory once per q tile cost more than both products). The rotation
// kernel: a block holds `rows` positions t of every head and walks a share of
// the batch items, so each element of cos/sin is read once per block, and
// every element of q, k, q_r and k_r moves by 16-byte loads and stores (element
// by element where a pointer is not 16-byte aligned). The rows of q' and k are
// staged in shared memory for the partner features. Each product and
// the sum round through the dtype and are never contracted into an FMA
// (__fmul_rn, __fadd_rn), as the TPU kernel computes x*cos + (x @ P)*sin in
// its dtype: P's signed permutation is exact, so a signed copy of feature
// d -/+ rot/2 stands in for it. q_r and k_r are the values the core used to
// rotate in shared memory, so #7's output keeps its bits.
#include "attention.cuh"

using namespace stts;

namespace {

bool bad_shape(int B, int T, int C, int H) { return H <= 0 || C != H * ATT_D || B <= 0 || T <= 0; }

constexpr int RP_BLOCKS = 8 * 132;  // blocks a rotation aims for: eight an SM

// one 16-byte chunk of V = 16 / sizeof(T) elements <-> f32
template <typename T, int V>
__device__ __forceinline__ void unpack(const uint4& u, float (&x)[V]) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < V; ++i) x[i] = to_f(e[i]);
}
template <typename T, int V>
__device__ __forceinline__ uint4 pack(const float (&x)[V]) {
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int i = 0; i < V; ++i) e[i] = from_f<T>(x[i]);
  return u;
}
// the chunk at p: one 16-byte access where vec, else element by element
template <typename T>
__device__ __forceinline__ uint4 load16(const T* p, bool vec) {
  if (vec) return *reinterpret_cast<const uint4*>(p);
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int i = 0; i < (int)(16 / sizeof(T)); ++i) e[i] = p[i];
  return u;
}
template <typename T>
__device__ __forceinline__ void store16(T* p, const uint4& u, bool vec) {
  if (vec) {
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < (int)(16 / sizeof(T)); ++i) p[i] = e[i];
  }
}

// q_r = RoPE(round(q * log2(e)/sqrt(D))), k_r = RoPE(k), all [B, T, C] in T;
// cos/sin [T, C]. Thread (r, j) of a block of rows * C / V threads owns chunk
// j of position t0 + r in every item b = blockIdx.y, blockIdx.y + gridDim.y, ..
// The rows of q' and k are staged in shared memory in T (q' is exact in T);
// where rot/2 is a multiple of V a chunk's partner features are one chunk,
// read by one 16-byte access, else element by element.
template <typename T>
__global__ void __launch_bounds__(1024) rope_packed_kernel(const T* q, const T* k, const T* cosv, const T* sinv,
                                                           T* qr, T* kr, int B, int Tn, int C, int rot, int rows,
                                                           int vec) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) uint4 rp_sm[];  // [rows][C] of q', then [rows][C] of k, in T
  const int per_row = C / V, r = threadIdx.x / per_row, j = threadIdx.x % per_row, c0 = j * V;
  const int t = blockIdx.x * rows + r, half = rot / 2, d0 = c0 % ATT_D;
  const bool live = t < Tn;
  uint4* sq = rp_sm + r * per_row;
  uint4* sk = rp_sm + (rows + r) * per_row;
  float cs[V], sn[V];
  if (live) {
    unpack<T, V>(load16(cosv + (long long)t * C + c0, vec), cs);
    unpack<T, V>(load16(sinv + (long long)t * C + c0, vec), sn);
  }
  // y = round(round(x cos) + round(xp sin)), xp the signed partner features of x in its staged row
  auto rotate = [&](const uint4* row, const float (&x)[V], float (&y)[V]) {
    float xp[V];
    if (half % V == 0) {  // the chunk lies in one of [0, half), [half, rot), [rot, 64)
      const float sign = d0 < half ? -1.f : 1.f;
      if (d0 < rot) {
        unpack<T, V>(row[j + (d0 < half ? half : -half) / V], xp);
#pragma unroll
        for (int i = 0; i < V; ++i) xp[i] *= sign;
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) xp[i] = 0.f;
      }
    } else {
      const T* e = reinterpret_cast<const T*>(row);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int c = c0 + i, d = d0 + i;
        xp[i] = d < half ? -to_f(e[c + half]) : (d < rot ? to_f(e[c - half]) : 0.f);
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float a = round_to<T>(__fmul_rn(x[i], cs[i])), b = round_to<T>(__fmul_rn(xp[i], sn[i]));
      y[i] = round_to<T>(__fadd_rn(a, b));
    }
  };
  const float qscale = kLog2e / sqrtf((float)ATT_D);
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const long long o = ((long long)b * Tn + t) * C + c0;
    float xq[V], xk[V], y[V];
    if (live) {
      unpack<T, V>(load16(q + o, vec), xq);
#pragma unroll
      for (int i = 0; i < V; ++i) xq[i] = round_to<T>(__fmul_rn(xq[i], qscale));
      sq[j] = pack<T, V>(xq);
      const uint4 uk = load16(k + o, vec);
      sk[j] = uk;
      unpack<T, V>(uk, xk);
    }
    __syncthreads();
    if (live) {
      rotate(sq, xq, y);
      store16(qr + o, pack<T, V>(y), vec);
      rotate(sk, xk, y);
      store16(kr + o, pack<T, V>(y), vec);
    }
    __syncthreads();  // the rows are free for the next item
  }
}

template <typename T>
int launch_rope(const void* q, const void* k, const void* cosv, const void* sinv, void* qr, void* kr, int B, int T_,
                int C, int rot, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const int per_row = C / V, rows = max(1, 256 / per_row);
  if (per_row * rows > 1024) return (int)cudaErrorInvalidValue;
  const auto aligned = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  const int vec = aligned(q) && aligned(k) && aligned(cosv) && aligned(sinv) && aligned(qr) && aligned(kr);
  const int gx = (T_ + rows - 1) / rows, gy = min(B, max(1, (RP_BLOCKS + gx - 1) / gx));
  const int smem = 2 * rows * C * (int)sizeof(T);
  auto kernel = rope_packed_kernel<T>;
  if (smem > 48 * 1024) cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kernel<<<dim3(gx, gy), per_row * rows, smem, s>>>((const T*)q, (const T*)k, (const T*)cosv, (const T*)sinv, (T*)qr,
                                                     (T*)kr, B, T_, C, rot, rows, vec);
  return (int)cudaGetLastError();
}

template <bool QPRE, bool KTMINOR, int MODE>
int run(const void* q, const void* k, const void* v, const void* mask, void* out, int B, int T, int H, int is_bf16,
        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mk = static_cast<const float*>(mask);
  if (is_bf16)
    launch_attention<bf16, false, QPRE, KTMINOR, MODE, false>((const bf16*)q, (const bf16*)k, (const bf16*)v, mk,
                                                              (bf16*)out, B, T, H, 1.f, s);
  else
    launch_attention<float, false, QPRE, KTMINOR, MODE, false>((const float*)q, (const float*)k, (const float*)v,
                                                               mk, (float*)out, B, T, H, 1.f, s);
  return (int)cudaGetLastError();
}

}  // namespace

// q/k/v/out [B, T, C]
extern "C" int attention_packed_v2_forward(const void* q, const void* k, const void* v, const void* mask, void* out,
                                           int B, int T, int C, int H, int is_bf16, void* stream) {
  if (bad_shape(B, T, C, H)) return (int)cudaErrorInvalidValue;
  return run<true, false, SM_ONLINE>(q, k, v, mask, out, B, T, H, is_bf16, stream);
}

// q/k unrotated, q_r/k_r (the outputs) [B, T, C]; cos/sin [T, C] in q's dtype; rot even, <= 64
extern "C" int rope_packed_forward(const void* q, const void* k, const void* cosv, const void* sinv, void* qr,
                                   void* kr, int B, int T, int C, int H, int rot, int is_bf16, void* stream) {
  if (bad_shape(B, T, C, H) || rot < 0 || rot > ATT_D || rot % 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_rope<bf16>(q, k, cosv, sinv, qr, kr, B, T, C, rot, s)
                 : launch_rope<float>(q, k, cosv, sinv, qr, kr, B, T, C, rot, s);
}

// q_r/k_r from rope_packed_forward, v/out [B, T, C]
extern "C" int attention_packed_rope_forward(const void* qr, const void* kr, const void* v, const void* mask,
                                             void* out, int B, int T, int C, int H, int is_bf16, void* stream) {
  if (bad_shape(B, T, C, H)) return (int)cudaErrorInvalidValue;
  return run<false, false, SM_ONLINE>(qr, kr, v, mask, out, B, T, H, is_bf16, stream);
}

// q/v/out [B, T, C]; kt [B, C, T]
extern "C" int attention_packed_kt_forward(const void* q, const void* kt, const void* v, const void* mask, void* out,
                                           int B, int T, int C, int H, int is_bf16, void* stream) {
  if (bad_shape(B, T, C, H)) return (int)cudaErrorInvalidValue;
  return run<true, true, SM_ONLINE>(q, kt, v, mask, out, B, T, H, is_bf16, stream);
}

// q/k/v/out [B, T, C], every key valid; which: 0 product only, 1 no max, 2 bf16 scores
extern "C" int attention_decompose_forward(const void* q, const void* k, const void* v, void* out, int B, int T,
                                           int C, int H, int which, int is_bf16, void* stream) {
  if (bad_shape(B, T, C, H)) return (int)cudaErrorInvalidValue;
  switch (which) {
    case 0: return run<true, false, SM_NONE>(q, k, v, nullptr, out, B, T, H, is_bf16, stream);
    case 1: return run<true, false, SM_NOMAX>(q, k, v, nullptr, out, B, T, H, is_bf16, stream);
    case 2: return run<true, false, SM_SCORE_LOWP>(q, k, v, nullptr, out, B, T, H, is_bf16, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
