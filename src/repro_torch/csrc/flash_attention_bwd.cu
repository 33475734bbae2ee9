// flash_attention_bwd: the gradient of causal (or full) grouped-query
// attention, o = softmax(q k^T * scale) v with q head h reading kv head
// h / group: dq, dk and dv for q (B, Hq, S, D) and k, v (B, Hkv, S, D), with
// f32 accumulation, at any S. Two routes, chosen by the wrapper
// (kernels/flash_attention.py) as the forward's are:
//
//   wgmma   bf16, D in {64, 128}: Hopper's tensor cores, from what the
//           forward (flash_wgmma_kernel) wrote under grad: o, o_lo and LSE.
//   fma     f32 (any D of 32, 64, 128, 256) and bf16 with D in {32, 256}:
//           f32 FMAs on the CUDA cores, exact to f32 rounding (the f32
//           model trains through it).
//
// Replaces no TPU kernel: the JAX package trains through its plain path
// (`use_pallas` is off by default and the Pallas kernel has no custom_vjp),
// so this gradient is new, the backward of csrc/flash_attention.cu's
// forward.
//
// Bound on this card: operations. The gradient needs 2.5 times the
// forward's causal flops (five products of q-by-key tiles against the
// forward's two), at 989 TFLOP/s for bf16 on the H100's tensor cores.
//
// The wgmma route: three launches, no atomics, so dq, dk and dv are the
// same bits run to run.
//
//   flash_bwd_dd_kernel     Dd_i = rowsum(dO o (o + o_lo)) in f32 for every
//                           query row, where o + o_lo is the forward's f32
//                           output to 16 significant bits (the bf16 o alone
//                           errs by 2^-9 of each element, more than
//                           dS = P (dP - Dd) can take where the two nearly
//                           cancel); with the LSE in base 2, into rows of
//                           S padded to 128 with (+inf, 0), so that every
//                           padded query gets P = 0 and dS = 0.
//   flash_bwd_dkdv_kernel   FA3's shape: a block of three warpgroups per
//                           (128-key tile, b, kv head). The producer TMA-loads
//                           the K and V tile once, then streams 64-row Q and
//                           dO tiles with their LSE and Dd rows through a
//                           ring of mbarrier-guarded stages, over the group's
//                           q heads and the q tiles that see the keys, in a
//                           fixed order (the GQA sum stays in the block). Each
//                           consumer warpgroup owns 64 keys: S^T = K Q^T and
//                           dP^T = V dO^T (wgmma, both operands in shared
//                           memory), P^T = 2^(S^T scale log2 e - LSE) and
//                           dS^T = P^T o (dP^T - Dd) in the accumulators'
//                           registers, then dV += P^T dO and dK += dS^T Q
//                           with P^T and dS^T as register A operands, two
//                           bf16 parts each (the accumulator is the A
//                           fragment: no shared-memory round trip), dO and
//                           Q read MN-major.
//   flash_bwd_dq_kernel     a block per (128-query tile, b, q head), two
//                           consumers of 64 rows: S, dP and dS the same way
//                           against 64-key K and V tiles streamed through the
//                           ring, dQ += dS K with K read MN-major.
//
// P and dS go into their products in two bf16 parts, hi = bf16(x) and lo =
// bf16(x - hi), as the forward's P does: one bf16 rounding errs by 2^-9 of
// each term, which reached 1.84 times the gradients' limit (2^-6 of each
// value plus 2^-10 of the largest) on standard-normal inputs
// (tests/test_torch_bwd_algorithms.py). So the route runs ten products of
// q-by-key tiles a (query tile, key tile) pair: S and dP twice (once a
// kernel), dV, dK and dQ twice each; the FMA route runs nine. q, k, v
// and dO are read at the layer's strides through 4-D TMA maps (rows past S
// arrive as zeros); dq, dk and dv are written at the strides given, which
// the wrapper makes the layer's [B, S, H, D].
//
// The fma route, with no LSE from its forward, takes three launches too:
//
//   flash_bwd_prep_kernel   a block per (query tile, b * hq): LSE_i, the
//                           log-sum-exp of row i's scaled scores over its
//                           keys, and Dd_i = rowsum(dO o O), in one online
//                           pass over the key tiles: a running max m, sum
//                           l = sum exp(s - m) and a = sum exp(s - m) dP
//                           with dP = dO V^T, rescaled as m grows, so
//                           Dd = a / l = sum_j P_ij dP_ij (O in f32).
//   flash_bwd_dkdv_fma      a block per (key tile, b * hkv): walks the
//                           group's q heads and, for each, the query tiles
//                           that see the key tile, in a fixed order,
//                           recomputing P = exp(s - LSE) and accumulating
//                           dV += P^T dO and dK += scale * dS^T Q in
//                           registers, dS = P o (dO V^T - Dd).
//   flash_bwd_dq_fma        a block per (query tile, b * hq): walks the key
//                           tiles the queries see, dQ += scale * dS K.
//
// Every score s_ij = scale * sum_d q_id k_jd is summed by the same code in
// the same order in all three, so P is the same where it is recomputed.
// Tiles are staged in shared memory in f32: q and dO both transposed
// ([D][rows], the A operand of a product over D) and as they lie ([rows][D],
// the B operand of a product over rows), k and v transposed. A block is 256
// threads, a 16 x 16 grid; thread (ty, tx) owns a (rows / 16) x (cols / 16)
// patch of each product. Tiles are 64 x 64 (32 x 32 at D = 256, to fit the
// staged tiles in shared memory). q, k, v and dO are read at their own
// (b, h, s) strides (rows of D contiguous elements on 16-byte boundaries);
// dq, dk, dv are written contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <int D>
struct BwdTile {
  static constexpr int kBM = D == 256 ? 32 : 64;  // query rows a tile
  static constexpr int kBN = kBM;                 // keys a tile
  static constexpr int kSR = kBM / 16;            // score rows a thread
  static constexpr int kSC = kBN / 16;            // score columns a thread
  static constexpr int kRD = D / 16;              // head dims a thread
};

// A (b, h, s) strided operand: row s of head (b, h) starts at
// base + b * sb + h * sh + s * ss.
struct Strides {
  int64_t b, h, s;
};

// The N consecutive floats at p (16-byte aligned where N % 4 == 0, 8-byte
// where N == 2) into registers.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      out[i] = t.x;
      out[i + 1] = t.y;
      out[i + 2] = t.z;
      out[i + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x;
    out[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  }
}

// acc[r][c] += sum over kk < K of At[kk][m0 + r] * Bm[kk][n0 + c], kk in
// ascending order: At is the A operand stored [K][lda], Bm the B operand
// stored [K][ldb].
template <int TM, int TN, int K>
__device__ __forceinline__ void mm_acc(const float* __restrict__ At, int lda,
                                       int m0, const float* __restrict__ Bm,
                                       int ldb, int n0, float (&acc)[TM][TN]) {
#pragma unroll 4
  for (int kk = 0; kk < K; ++kk) {
    float a[TM], b[TN];
    load_vec<TM>(At + kk * lda + m0, a);
    load_vec<TN>(Bm + kk * ldb + n0, b);
#pragma unroll
    for (int r = 0; r < TM; ++r) {
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
  }
}

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int r = 0; r < TM; ++r) {
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;
  }
}

// Rows [r0, r0 + n) of a head (rows from `limit` on read as zero) into
// shared memory as f32: transposed, dst[d * n + r], when `transposed`, else
// as they lie, dst[r * D + d].
template <typename T, int D, bool transposed>
__device__ __forceinline__ void stage(const T* __restrict__ head, int64_t ss,
                                      int r0, int n, int limit,
                                      float* __restrict__ dst) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecsPerRow = D / kVec;
  const int total = n * kVecsPerRow;
  for (int idx = threadIdx.x; idx < total; idx += kThreads) {
    // transposed: neighbouring threads take neighbouring rows, so the
    // stores of one column land on consecutive addresses
    const int r = transposed ? idx % n : idx / kVecsPerRow;
    const int c = (transposed ? idx / n : idx % kVecsPerRow) * kVec;
    float vals[kVec];
    if (r0 + r < limit) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(head + (r0 + r) * ss + c);
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < kVec; ++e) vals[e] = to_f32(v[e]);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) vals[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      if (transposed) {
        dst[(c + e) * n + r] = vals[e];
      } else {
        dst[r * D + c + e] = vals[e];
      }
    }
  }
}

// Whether score (i, j) counts: both inside the sequence, and j <= i when
// causal.
__device__ __forceinline__ bool live(int i, int j, int s_len, int causal) {
  return i < s_len && j < s_len && (!causal || j <= i);
}

// Reduces v over the 16 threads of a score row (tx = lane % 16).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_prep_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          float* __restrict__ lse, float* __restrict__ dd,
                          int hq, int group, int s_len, Strides sq, Strides sk,
                          Strides sv, Strides sdo, float scale, int causal) {
  using TL = BwdTile<D>;
  constexpr int BM = TL::kBM, BN = TL::kBN, SR = TL::kSR, SC = TL::kSC;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [D][BM]
  float* got = qt + D * BM;                     // [D][BM]
  float* kt = got + D * BM;                     // [D][BN]
  float* vt = kt + D * BN;                      // [D][BN]

  const int bh = blockIdx.y;
  const int b = bh / hq, h = bh % hq;
  const int i0 = blockIdx.x * BM;
  const T* kh = k + b * sk.b + (h / group) * sk.h;
  const T* vh = v + b * sv.b + (h / group) * sv.h;
  stage<T, D, true>(q + b * sq.b + h * sq.h, sq.s, i0, BM, s_len, qt);
  stage<T, D, true>(dout + b * sdo.b + h * sdo.h, sdo.s, i0, BM, s_len, got);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  // per row over this thread's columns: running max, sum of exp(s - m),
  // and sum of exp(s - m) * dP
  float m[SR], l[SR], a[SR];
#pragma unroll
  for (int r = 0; r < SR; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
    a[r] = 0.f;
  }
  const int kv_end = causal ? min(s_len, i0 + BM) : s_len;
  for (int j0 = 0; j0 < kv_end; j0 += BN) {
    __syncthreads();  // the previous tile's kt, vt are no longer read
    stage<T, D, true>(kh, sk.s, j0, BN, s_len, kt);
    stage<T, D, true>(vh, sv.s, j0, BN, s_len, vt);
    __syncthreads();
    float s[SR][SC], dp[SR][SC];
    zero(s);
    zero(dp);
    mm_acc<SR, SC, D>(qt, BM, ty * SR, kt, BN, tx * SC, s);
    mm_acc<SR, SC, D>(got, BM, ty * SR, vt, BN, tx * SC, dp);
#pragma unroll
    for (int r = 0; r < SR; ++r) {
      const int i = i0 + ty * SR + r;
#pragma unroll
      for (int c = 0; c < SC; ++c) {
        const int j = j0 + tx * SC + c;
        if (live(i, j, s_len, causal)) {
          const float x = s[r][c] * scale;
          if (x > m[r]) {
            const float f = expf(m[r] - x);
            l[r] = l[r] * f + 1.f;
            a[r] = a[r] * f + dp[r][c];
            m[r] = x;
          } else {
            const float e = expf(x - m[r]);
            l[r] += e;
            a[r] += e * dp[r][c];
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < SR; ++r) {
    const float mx = row_max(m[r]);
    const float w = m[r] == -INFINITY ? 0.f : expf(m[r] - mx);
    const float tot = row_sum(l[r] * w);
    const float dot = row_sum(a[r] * w);
    const int i = i0 + ty * SR + r;
    if (tx == 0 && i < s_len) {
      lse[static_cast<int64_t>(bh) * s_len + i] = mx + logf(tot);
      dd[static_cast<int64_t>(bh) * s_len + i] = dot / tot;
    }
  }
}

// P and dS of a (query tile i0, key tile j0) pair from the staged tiles:
// s = Q K^T, p = exp(scale * s - LSE) where live, dp = dO V^T,
// ds = p * (dp - Dd). lse_s, dd_s: the query tile's LSE and Dd.
template <int D>
__device__ __forceinline__ void p_and_ds(
    const float* qt, const float* got, const float* kt, const float* vt,
    const float* lse_s, const float* dd_s, int i0, int j0, int s_len,
    float scale, int causal, float (&p)[BwdTile<D>::kSR][BwdTile<D>::kSC],
    float (&ds)[BwdTile<D>::kSR][BwdTile<D>::kSC]) {
  using TL = BwdTile<D>;
  constexpr int BM = TL::kBM, BN = TL::kBN, SR = TL::kSR, SC = TL::kSC;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float dp[SR][SC];
  zero(p);
  zero(dp);
  mm_acc<SR, SC, D>(qt, BM, ty * SR, kt, BN, tx * SC, p);
  mm_acc<SR, SC, D>(got, BM, ty * SR, vt, BN, tx * SC, dp);
#pragma unroll
  for (int r = 0; r < SR; ++r) {
    const int ri = ty * SR + r;
#pragma unroll
    for (int c = 0; c < SC; ++c) {
      const int j = j0 + tx * SC + c;
      const float pr = live(i0 + ri, j, s_len, causal)
                           ? expf(p[r][c] * scale - lse_s[ri])
                           : 0.f;
      p[r][c] = pr;
      ds[r][c] = pr * (dp[r][c] - dd_s[ri]);
    }
  }
}

template <typename T, int D>
__device__ __forceinline__ void stage_stats(const float* lse, const float* dd,
                                            int64_t bh, int i0, int s_len,
                                            float* lse_s, float* dd_s) {
  constexpr int BM = BwdTile<D>::kBM;
  for (int r = threadIdx.x; r < BM; r += kThreads) {
    const int i = i0 + r;
    lse_s[r] = i < s_len ? lse[bh * s_len + i] : 0.f;
    dd_s[r] = i < s_len ? dd[bh * s_len + i] : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_fma(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ dd, T* __restrict__ dk,
                          T* __restrict__ dv, int hq, int hkv, int s_len,
                          Strides sq, Strides sk, Strides sv, Strides sdo,
                          float scale, int causal) {
  using TL = BwdTile<D>;
  constexpr int BM = TL::kBM, BN = TL::kBN, SR = TL::kSR, SC = TL::kSC;
  constexpr int RK = BN / 16, RD = TL::kRD;
  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);  // [D][BN]
  float* vt = kt + D * BN;                      // [D][BN]
  float* qt = vt + D * BN;                      // [D][BM]
  float* qn = qt + D * BM;                      // [BM][D]
  float* got = qn + BM * D;                     // [D][BM]
  float* gon = got + D * BM;                    // [BM][D]
  float* ps = gon + BM * D;                     // [BM][BN]: P, then dS
  float* lse_s = ps + BM * BN;                  // [BM]
  float* dd_s = lse_s + BM;                     // [BM]

  const int bh = blockIdx.y;
  const int b = bh / hkv, hk = bh % hkv;
  const int group = hq / hkv;
  const int j0 = blockIdx.x * BN;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  stage<T, D, true>(k + b * sk.b + hk * sk.h, sk.s, j0, BN, s_len, kt);
  stage<T, D, true>(v + b * sv.b + hk * sv.h, sv.s, j0, BN, s_len, vt);

  float dk_acc[RK][RD], dv_acc[RK][RD];
  zero(dk_acc);
  zero(dv_acc);
  const int n_qt = (s_len + BM - 1) / BM;
  const int qt_first = causal ? j0 / BM : 0;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const T* qh = q + b * sq.b + h * sq.h;
    const T* gh = dout + b * sdo.b + h * sdo.h;
    const int64_t qbh = static_cast<int64_t>(b) * hq + h;
    for (int qtile = qt_first; qtile < n_qt; ++qtile) {
      const int i0 = qtile * BM;
      __syncthreads();  // the previous tile's operands are no longer read
      stage<T, D, true>(qh, sq.s, i0, BM, s_len, qt);
      stage<T, D, false>(qh, sq.s, i0, BM, s_len, qn);
      stage<T, D, true>(gh, sdo.s, i0, BM, s_len, got);
      stage<T, D, false>(gh, sdo.s, i0, BM, s_len, gon);
      stage_stats<T, D>(lse, dd, qbh, i0, s_len, lse_s, dd_s);
      __syncthreads();
      float p[SR][SC], ds[SR][SC];
      p_and_ds<D>(qt, got, kt, vt, lse_s, dd_s, i0, j0, s_len, scale, causal, p,
                  ds);
#pragma unroll
      for (int r = 0; r < SR; ++r) {
#pragma unroll
        for (int c = 0; c < SC; ++c) {
          ps[(ty * SR + r) * BN + tx * SC + c] = p[r][c];
        }
      }
      __syncthreads();
      // dV[j][d] += sum_i P[i][j] dO[i][d]
      mm_acc<RK, RD, BM>(ps, BN, ty * RK, gon, D, tx * RD, dv_acc);
      __syncthreads();
#pragma unroll
      for (int r = 0; r < SR; ++r) {
#pragma unroll
        for (int c = 0; c < SC; ++c) {
          ps[(ty * SR + r) * BN + tx * SC + c] = ds[r][c];
        }
      }
      __syncthreads();
      // dK[j][d] += sum_i dS[i][j] Q[i][d] (times scale at the end)
      mm_acc<RK, RD, BM>(ps, BN, ty * RK, qn, D, tx * RD, dk_acc);
    }
  }
  const int64_t out = static_cast<int64_t>(bh) * s_len;
#pragma unroll
  for (int r = 0; r < RK; ++r) {
    const int j = j0 + ty * RK + r;
    if (j >= s_len) continue;
#pragma unroll
    for (int c = 0; c < RD; ++c) {
      const int64_t at = (out + j) * D + tx * RD + c;
      dk[at] = from_f32<T>(dk_acc[r][c] * scale);
      dv[at] = from_f32<T>(dv_acc[r][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_fma(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dd, T* __restrict__ dq,
                        int hq, int group, int s_len, Strides sq, Strides sk,
                        Strides sv, Strides sdo, float scale, int causal) {
  using TL = BwdTile<D>;
  constexpr int BM = TL::kBM, BN = TL::kBN, SR = TL::kSR, SC = TL::kSC;
  constexpr int RD = TL::kRD;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [D][BM]
  float* got = qt + D * BM;                     // [D][BM]
  float* kt = got + D * BM;                     // [D][BN]
  float* vt = kt + D * BN;                      // [D][BN]
  float* kn = vt + D * BN;                      // [BN][D]
  float* pt = kn + BN * D;                      // [BN][BM]: dS transposed
  float* lse_s = pt + BN * BM;                  // [BM]
  float* dd_s = lse_s + BM;                     // [BM]

  const int bh = blockIdx.y;
  const int b = bh / hq, h = bh % hq;
  const int i0 = blockIdx.x * BM;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  stage<T, D, true>(q + b * sq.b + h * sq.h, sq.s, i0, BM, s_len, qt);
  stage<T, D, true>(dout + b * sdo.b + h * sdo.h, sdo.s, i0, BM, s_len, got);
  stage_stats<T, D>(lse, dd, bh, i0, s_len, lse_s, dd_s);
  const T* kh = k + b * sk.b + (h / group) * sk.h;
  const T* vh = v + b * sv.b + (h / group) * sv.h;

  float dq_acc[SR][RD];
  zero(dq_acc);
  const int kv_end = causal ? min(s_len, i0 + BM) : s_len;
  for (int j0 = 0; j0 < kv_end; j0 += BN) {
    __syncthreads();  // the previous tile's operands are no longer read
    stage<T, D, true>(kh, sk.s, j0, BN, s_len, kt);
    stage<T, D, false>(kh, sk.s, j0, BN, s_len, kn);
    stage<T, D, true>(vh, sv.s, j0, BN, s_len, vt);
    __syncthreads();
    float p[SR][SC], ds[SR][SC];
    p_and_ds<D>(qt, got, kt, vt, lse_s, dd_s, i0, j0, s_len, scale, causal, p,
                ds);
#pragma unroll
    for (int r = 0; r < SR; ++r) {
#pragma unroll
      for (int c = 0; c < SC; ++c) {
        pt[(tx * SC + c) * BM + ty * SR + r] = ds[r][c];
      }
    }
    __syncthreads();
    // dQ[i][d] += sum_j dS[i][j] K[j][d] (times scale at the end)
    mm_acc<SR, RD, BN>(pt, BM, ty * SR, kn, D, tx * RD, dq_acc);
  }
  const int64_t out = static_cast<int64_t>(bh) * s_len;
#pragma unroll
  for (int r = 0; r < SR; ++r) {
    const int i = i0 + ty * SR + r;
    if (i >= s_len) continue;
#pragma unroll
    for (int c = 0; c < RD; ++c) {
      dq[(out + i) * D + tx * RD + c] = from_f32<T>(dq_acc[r][c] * scale);
    }
  }
}

template <int D>
constexpr size_t prep_smem() {
  return sizeof(float) * (2 * static_cast<size_t>(D) * BwdTile<D>::kBM +
                          2 * static_cast<size_t>(D) * BwdTile<D>::kBN);
}
template <int D>
constexpr size_t dkdv_smem() {
  using TL = BwdTile<D>;
  return sizeof(float) *
         (2 * static_cast<size_t>(D) * TL::kBN + 4 * static_cast<size_t>(D) * TL::kBM +
          static_cast<size_t>(TL::kBM) * TL::kBN + 2 * TL::kBM);
}
template <int D>
constexpr size_t dq_smem() {
  using TL = BwdTile<D>;
  return sizeof(float) *
         (2 * static_cast<size_t>(D) * TL::kBM + 3 * static_cast<size_t>(D) * TL::kBN +
          static_cast<size_t>(TL::kBM) * TL::kBN + 2 * TL::kBM);
}

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <typename T, int D>
int launch(const void* qv, const void* kv, const void* vv, const void* gv,
           void* dqv, void* dkv, void* dvv, float* lse, float* dd, int B,
           int Hq, int Hkv, int S, Strides sq, Strides sk, Strides sv,
           Strides sdo, float scale, int causal, cudaStream_t stream) {
  using TL = BwdTile<D>;
  const T* q = static_cast<const T*>(qv);
  const T* k = static_cast<const T*>(kv);
  const T* v = static_cast<const T*>(vv);
  const T* g = static_cast<const T*>(gv);
  const int group = Hq / Hkv;
  const unsigned n_qt = (S + TL::kBM - 1) / TL::kBM;
  const unsigned n_kt = (S + TL::kBN - 1) / TL::kBN;
  int err = allow_smem(flash_bwd_prep_kernel<T, D>, prep_smem<D>());
  if (err) return err;
  flash_bwd_prep_kernel<T, D><<<dim3(n_qt, B * Hq), kThreads, prep_smem<D>(),
                                stream>>>(q, k, v, g, lse, dd, Hq, group, S, sq,
                                          sk, sv, sdo, scale, causal);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  if ((err = allow_smem(flash_bwd_dkdv_fma<T, D>, dkdv_smem<D>()))) return err;
  flash_bwd_dkdv_fma<T, D><<<dim3(n_kt, B * Hkv), kThreads, dkdv_smem<D>(),
                                stream>>>(q, k, v, g, lse, dd,
                                          static_cast<T*>(dkv),
                                          static_cast<T*>(dvv), Hq, Hkv, S, sq,
                                          sk, sv, sdo, scale, causal);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  if ((err = allow_smem(flash_bwd_dq_fma<T, D>, dq_smem<D>()))) return err;
  flash_bwd_dq_fma<T, D><<<dim3(n_qt, B * Hq), kThreads, dq_smem<D>(),
                              stream>>>(q, k, v, g, lse, dd,
                                        static_cast<T*>(dqv), Hq, group, S, sq,
                                        sk, sv, sdo, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, const void* g,
             void* dq, void* dk, void* dv, float* lse, float* dd, int B, int Hq,
             int Hkv, int S, Strides sq, Strides sk, Strides sv, Strides sdo,
             float scale, int causal, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, g, dq, dk, dv, lse, dd, B, Hq, Hkv, S, sq, sk,
                           sv, sdo, scale, causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, g, dq, dk, dv, lse, dd, B, Hq, Hkv, S, sq, sk,
                           sv, sdo, scale, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, g, dq, dk, dv, lse, dd, B, Hq, Hkv, S, sq, sk,
                            sv, sdo, scale, causal, stream);
    case 256:
      return launch<T, 256>(q, k, v, g, dq, dk, dv, lse, dd, B, Hq, Hkv, S, sq, sk,
                            sv, sdo, scale, causal, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

Strides strides(const int64_t* st) { return Strides{st[0], st[1], st[2]}; }

}  // namespace

// The CUDA-core route. q, dout: (B, Hq, S, D) and k, v: (B, Hkv, S, D) at
// the (b, h, s) element strides given (unit stride along D, rows on 16-byte
// boundaries); dq (B, Hq, S, D) and dk, dv (B, Hkv, S, D) contiguous
// outputs; lse, dd: f32 [B * Hq, S] scratch. dtype 0 f32, 1 bf16. Launches
// three kernels on `stream`; returns the first error, or cudaGetLastError().
extern "C" int flash_attention_bwd_fma_launch(
    const void* q, const void* k, const void* v, const void* dout, void* dq,
    void* dk, void* dv, float* lse, float* dd, int B, int Hq, int Hkv, int S,
    int D, const int64_t* sq, const int64_t* sk, const int64_t* sv,
    const int64_t* sdo, float scale, int causal, int dtype, cudaStream_t stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || S < 1 || Hq % Hkv || B * Hq > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 1) {
    return launch_d<__nv_bfloat16>(D, q, k, v, dout, dq, dk, dv, lse, dd, B, Hq,
                                   Hkv, S, strides(sq), strides(sk), strides(sv),
                                   strides(sdo), scale, causal, stream);
  }
  if (dtype == 0) {
    return launch_d<float>(D, q, k, v, dout, dq, dk, dv, lse, dd, B, Hq, Hkv, S,
                           strides(sq), strides(sk), strides(sv), strides(sdo),
                           scale, causal, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// The tensor-core route: bf16, D in {64, 128}
// ---------------------------------------------------------------------------

namespace {

constexpr int kWgThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kKvRows = 128;     // keys a dK/dV block; queries a dQ block
constexpr int kRows = 64;        // rows a consumer warpgroup owns; rows a
                                 // streamed tile (Q and dO of dK/dV, K and V
                                 // of dQ)
constexpr int kStages = 3;       // ring depth
constexpr int kPad = 128;        // the LSE and Dd rows are padded to this
constexpr float kLog2e = 1.4426950408889634f;
using wg::kRowBytes;

using tma::mbar_arrive;
using tma::mbar_expect_tx;
using tma::mbar_init;
using tma::mbar_wait;
using tma::smem_u32;

// Dd = rowsum(dO o (o + o_lo)) in f32 and lse2 = LSE log2(e) for each row
// (b * heads + h) * s_pad + s, (0, +inf) for s >= s_len: D / 8 threads a row,
// 16 bytes of each operand a thread, the row's sum by shuffles.
template <int D>
__global__ void __launch_bounds__(256)
    flash_bwd_dd_kernel(const __nv_bfloat16* __restrict__ o,
                        const __nv_bfloat16* __restrict__ o_lo,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse, float* __restrict__ lse2,
                        float* __restrict__ dd, int heads, int s_len, int s_pad,
                        int64_t rows, Strides so, Strides sdo) {
  constexpr int kT = D / 8;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t row = idx / kT;
  const int t = static_cast<int>(idx % kT);
  const int64_t bh = row / s_pad;
  const int s = static_cast<int>(row % s_pad);
  const bool live = row < rows && s < s_len;
  float acc = 0.f;
  if (live) {
    const int64_t b = bh / heads, h = bh % heads;
    const int64_t at = b * so.b + h * so.h + s * so.s + t * 8;
    const uint4 ov = *reinterpret_cast<const uint4*>(o + at);
    const uint4 lv = *reinterpret_cast<const uint4*>(o_lo + at);
    const uint4 gv = *reinterpret_cast<const uint4*>(
        dout + b * sdo.b + h * sdo.h + s * sdo.s + t * 8);
    const __nv_bfloat16* oe = reinterpret_cast<const __nv_bfloat16*>(&ov);
    const __nv_bfloat16* le = reinterpret_cast<const __nv_bfloat16*>(&lv);
    const __nv_bfloat16* ge = reinterpret_cast<const __nv_bfloat16*>(&gv);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      // o + o_lo is exact in f32: two bf16 parts, 16 significant bits
      acc = fmaf(__bfloat162float(ge[e]),
                 __bfloat162float(oe[e]) + __bfloat162float(le[e]), acc);
    }
  }
#pragma unroll
  for (int off = kT / 2; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (t == 0 && row < rows) {
    dd[row] = acc;
    lse2[row] = live ? lse[bh * s_len + s] * kLog2e : INFINITY;
  }
}

// dK/dV shared memory: the K and V tiles (128 rows as 64-column boxes), then
// per stage the Q and dO tiles (64 rows) and the tile's lse2 and Dd rows
// (256 bytes each, the stage padded to 1024), then the mbarriers.
template <int D>
struct DkvSmem {
  static constexpr int kKvBox = kKvRows * kRowBytes;
  static constexpr int kKvBytes = kKvRows * D * 2;
  static constexpr int kQBox = kRows * kRowBytes;
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kStats = 2 * kQBytes;  // lse2 at +0, Dd at +256
  static constexpr int kStage = 2 * kQBytes + 1024;
  static constexpr int kBars = 2 * kKvBytes + kStages * kStage;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

// dQ shared memory: the Q and dO tiles (128 rows), then per stage the K and
// V tiles (64 rows), then the mbarriers.
template <int D>
struct DqSmem {
  static constexpr int kQBox = kKvRows * kRowBytes;
  static constexpr int kQBytes = kKvRows * D * 2;
  static constexpr int kKBox = kRows * kRowBytes;
  static constexpr int kKBytes = kRows * D * 2;
  static constexpr int kStage = 2 * kKBytes;
  static constexpr int kBars = 2 * kQBytes + kStages * kStage;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

// Writes a warpgroup's 64 x D accumulator, times `mul`, as bf16 rows
// row0 + 16 warp + lane / 4 (+ 8) below s_len at dst + row * ss.
template <int D>
__device__ __forceinline__ void store_rows(const float* acc, float mul,
                                           __nv_bfloat16* dst, int64_t ss,
                                           int row0, int s_len) {
  const int lane = threadIdx.x % 32;
  const int r = row0 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
  const int c2 = 2 * (lane % 4);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r + 8 * hh;
    if (row >= s_len) continue;
    __nv_bfloat16* out = dst + row * ss + c2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * hh] * mul, acc[4 * j + 2 * hh + 1] * mul);
    }
  }
}

// q, dout: (D, S, Hq, B) maps with 64-row boxes; k, v: (D, S, Hkv, B) maps
// with 128-row boxes; lse2, dd: [B * Hq][s_pad]. Block x: (key tile,
// b * hkv), key tile 0 (under causality the heaviest) first.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const float* __restrict__ lse2,
                          const float* __restrict__ dd, __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, Strides sdk, Strides sdv,
                          int hq, int hkv, int s_len, int s_pad, float scale,
                          float scale_log2, int causal) {
  using SM = DkvSmem<D>;
  constexpr int kBoxes = D / wg::kBoxCols;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t k_s = base;
  const uint32_t v_s = base + SM::kKvBytes;
  auto stage = [&](int st) { return base + 2 * SM::kKvBytes + st * SM::kStage; };
  const uint32_t bars = base + SM::kBars;
  const uint32_t kv_full = bars;
  auto full = [&](int st) { return bars + 8 * (1 + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + kStages + st); };

  const int bhkv = gridDim.x / ((s_len + kKvRows - 1) / kKvRows);
  const int kt = blockIdx.x / bhkv;
  const int b = (blockIdx.x % bhkv) / hkv;
  const int hk = (blockIdx.x % bhkv) % hkv;
  const int group = hq / hkv;
  const int j0 = kt * kKvRows;
  const int n_qt = (s_len + kRows - 1) / kRows;
  const int first = causal ? j0 / kRows : 0;  // q tiles before it see no key here
  const int per = n_qt - first;
  const int n_it = group * per;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * SM::kKvBytes);
      for (int c = 0; c < kBoxes; ++c) {
        tma::load_4d(k_s + c * SM::kKvBox, &tk, kv_full, c * wg::kBoxCols, j0, hk, b);
        tma::load_4d(v_s + c * SM::kKvBox, &tv, kv_full, c * wg::kBoxCols, j0, hk, b);
      }
      for (int it = 0; it < n_it; ++it) {
        const int st = it % kStages;
        const int h = hk * group + it / per;
        const int i0 = (first + it % per) * kRows;
        const int64_t stat = (static_cast<int64_t>(b) * hq + h) * s_pad + i0;
        mbar_wait(empty(st), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full(st), 2 * SM::kQBytes + 2 * kRows * 4);
        for (int c = 0; c < kBoxes; ++c) {
          tma::load_4d(stage(st) + c * SM::kQBox, &tq, full(st), c * wg::kBoxCols, i0,
                       h, b);
          tma::load_4d(stage(st) + SM::kQBytes + c * SM::kQBox, &tdo, full(st),
                       c * wg::kBoxCols, i0, h, b);
        }
        tma::load_1d(stage(st) + SM::kStats, lse2 + stat, kRows * 4, full(st));
        tma::load_1d(stage(st) + SM::kStats + kRows * 4, dd + stat, kRows * 4, full(st));
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wgi - 1;  // which 64 keys of the tile
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int kw0 = j0 + cw * kRows;
    const int key = kw0 + (t / 32) * 16 + lane / 4;  // and key + 8
    const int c2 = 2 * (lane % 4);
    const uint32_t k_rows = k_s + cw * kRows * kRowBytes;
    const uint32_t v_rows = v_s + cw * kRows * kRowBytes;

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_it; ++it) {
      const int st = it % kStages;
      const int i0 = (first + it % per) * kRows;
      const uint32_t q_t = stage(st);
      const uint32_t do_t = q_t + SM::kQBytes;
      const float* lse_t =
          reinterpret_cast<const float*>(smem_raw + (q_t + SM::kStats - raw));
      const float* dd_t = lse_t + kRows;
      // every key of this warpgroup after every query of the tile: P = 0
      const bool skip = causal && i0 + kRows - 1 < kw0;
      const bool mask = causal && i0 < kw0 + kRows - 1;
      mbar_wait(full(st), (it / kStages) & 1);
      if (!skip) {
        float s[kRows / 2], dp[kRows / 2];
        wg::fence_regs<kRows / 2>(s);
        wg::fence_regs<kRows / 2>(dp);
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wg::ss_n64(s, wg::kmajor(k_rows, kk, SM::kKvBox),
                     wg::kmajor(q_t, kk, SM::kQBox), kk > 0);
        }
        wg::commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wg::ss_n64(dp, wg::kmajor(v_rows, kk, SM::kKvBox),
                     wg::kmajor(do_t, kk, SM::kQBox), kk > 0);
        }
        wg::commit();
        wg::wait<1>();
        wg::fence_regs<kRows / 2>(s);
        // P^T: row key (+ 8), column (query) i0 + 8 (i / 4) + c2 + i % 2
#pragma unroll
        for (int i = 0; i < kRows / 2; ++i) {
          const int ci = (i / 4) * 8 + c2 + (i % 2);
          float p = exp2f(fmaf(s[i], scale_log2, -lse_t[ci]));
          if (mask && key + 8 * ((i % 4) / 2) > i0 + ci) p = 0.f;
          s[i] = p;
        }
        wg::wait<0>();
        wg::fence_regs<kRows / 2>(dp);
#pragma unroll
        for (int i = 0; i < kRows / 2; ++i) {
          dp[i] = s[i] * (dp[i] - dd_t[(i / 4) * 8 + c2 + (i % 2)]);
        }
        uint32_t p_hi[kRows / 16][4], p_lo[kRows / 16][4];
        uint32_t ds_hi[kRows / 16][4], ds_lo[kRows / 16][4];
        wg::split_frags<kRows>(s, p_hi, p_lo);
        wg::split_frags<kRows>(dp, ds_hi, ds_lo);
        wg::fence_regs<D / 2>(dv_acc);
        wg::fence_regs<D / 2>(dk_acc);
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk) {
          const uint64_t dod = wg::mnmajor(do_t, kk, SM::kQBox);
          wg::rs<D>(dv_acc, p_hi[kk], dod);
          wg::rs<D>(dv_acc, p_lo[kk], dod);
        }
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk) {
          const uint64_t qd = wg::mnmajor(q_t, kk, SM::kQBox);
          wg::rs<D>(dk_acc, ds_hi[kk], qd);
          wg::rs<D>(dk_acc, ds_lo[kk], qd);
        }
        wg::commit();
        wg::wait<0>();
        wg::fence_regs<D / 2>(dv_acc);
        wg::fence_regs<D / 2>(dk_acc);
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk) {
          wg::fence_regs<4>(p_hi[kk]);
          wg::fence_regs<4>(p_lo[kk]);
          wg::fence_regs<4>(ds_hi[kk]);
          wg::fence_regs<4>(ds_lo[kk]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }
    store_rows<D>(dk_acc, scale, dk + b * sdk.b + hk * sdk.h, sdk.s, kw0, s_len);
    store_rows<D>(dv_acc, 1.f, dv + b * sdv.b + hk * sdv.h, sdv.s, kw0, s_len);
  }
}

// q, dout: (D, S, Hq, B) maps with 128-row boxes; k, v: (D, S, Hkv, B) maps
// with 64-row boxes; lse2, dd: [B * Hq][s_pad]. Block x: (q tile, b * hq),
// heaviest q tiles first; each block visits its key tiles last first, so the
// ones needing a mask come first.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const float* __restrict__ lse2,
                        const float* __restrict__ dd, __nv_bfloat16* __restrict__ dq,
                        Strides sdq, int hq, int group, int s_len, int s_pad,
                        float scale, float scale_log2, int causal) {
  using SM = DqSmem<D>;
  constexpr int kBoxes = D / wg::kBoxCols;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t do_s = base + SM::kQBytes;
  auto k_tile = [&](int st) { return base + 2 * SM::kQBytes + st * SM::kStage; };
  const uint32_t bars = base + SM::kBars;
  const uint32_t q_full = bars;
  auto full = [&](int st) { return bars + 8 * (1 + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + kStages + st); };

  const int n_qt = (s_len + kKvRows - 1) / kKvRows;
  const int bhq = gridDim.x / n_qt;
  const int bh = blockIdx.x % bhq;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / bhq);
  const int b = bh / hq;
  const int h = bh % hq;
  const int q0 = qt * kKvRows;
  const int n_kt = (s_len + kRows - 1) / kRows;
  const int n_kv = causal ? min(n_kt, (q0 + kKvRows) / kRows) : n_kt;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      const int kvh = h / group;
      mbar_expect_tx(q_full, 2 * SM::kQBytes);
      for (int c = 0; c < kBoxes; ++c) {
        tma::load_4d(q_s + c * SM::kQBox, &tq, q_full, c * wg::kBoxCols, q0, h, b);
        tma::load_4d(do_s + c * SM::kQBox, &tdo, q_full, c * wg::kBoxCols, q0, h, b);
      }
      for (int it = 0; it < n_kv; ++it) {
        const int st = it % kStages;
        const int k0 = (n_kv - 1 - it) * kRows;
        mbar_wait(empty(st), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full(st), SM::kStage);
        for (int c = 0; c < kBoxes; ++c) {
          tma::load_4d(k_tile(st) + c * SM::kKBox, &tk, full(st), c * wg::kBoxCols, k0,
                       kvh, b);
          tma::load_4d(k_tile(st) + SM::kKBytes + c * SM::kKBox, &tv, full(st),
                       c * wg::kBoxCols, k0, kvh, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wgi - 1;  // which 64 rows of the q tile
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int rows_lo = q0 + cw * kRows;
    const int r = rows_lo + (t / 32) * 16 + lane / 4;  // and r + 8
    const int c2 = 2 * (lane % 4);
    const uint32_t q_rows = q_s + cw * kRows * kRowBytes;
    const uint32_t do_rows = do_s + cw * kRows * kRowBytes;
    // rows below s_pad (a multiple of the 128-row tile); past s_len (+inf, 0)
    const int64_t stat = static_cast<int64_t>(bh) * s_pad + r;
    const float lse_r[2] = {lse2[stat], lse2[stat + 8]};
    const float dd_r[2] = {dd[stat], dd[stat + 8]};

    float dq_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;

    mbar_wait(q_full, 0);
    for (int it = 0; it < n_kv; ++it) {
      const int st = it % kStages;
      const int k0 = (n_kv - 1 - it) * kRows;
      const uint32_t k_t = k_tile(st);
      const uint32_t v_t = k_t + SM::kKBytes;
      const bool skip = causal && k0 > rows_lo + kRows - 1;
      const bool mask = (causal && k0 + kRows - 1 > rows_lo) || k0 + kRows > s_len;
      mbar_wait(full(st), (it / kStages) & 1);
      if (!skip) {
        float s[kRows / 2], dp[kRows / 2];
        wg::fence_regs<kRows / 2>(s);
        wg::fence_regs<kRows / 2>(dp);
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wg::ss_n64(s, wg::kmajor(q_rows, kk, SM::kQBox), wg::kmajor(k_t, kk, SM::kKBox),
                     kk > 0);
        }
        wg::commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wg::ss_n64(dp, wg::kmajor(do_rows, kk, SM::kQBox),
                     wg::kmajor(v_t, kk, SM::kKBox), kk > 0);
        }
        wg::commit();
        wg::wait<1>();
        wg::fence_regs<kRows / 2>(s);
#pragma unroll
        for (int i = 0; i < kRows / 2; ++i) {
          const int hh = (i % 4) / 2;
          float p = exp2f(fmaf(s[i], scale_log2, -lse_r[hh]));
          const int kj = k0 + (i / 4) * 8 + c2 + (i % 2);
          if (mask && (kj >= s_len || (causal && kj > r + 8 * hh))) p = 0.f;
          s[i] = p;
        }
        wg::wait<0>();
        wg::fence_regs<kRows / 2>(dp);
#pragma unroll
        for (int i = 0; i < kRows / 2; ++i) dp[i] = s[i] * (dp[i] - dd_r[(i % 4) / 2]);
        uint32_t ds_hi[kRows / 16][4], ds_lo[kRows / 16][4];
        wg::split_frags<kRows>(dp, ds_hi, ds_lo);
        wg::fence_regs<D / 2>(dq_acc);
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk) {
          const uint64_t kd = wg::mnmajor(k_t, kk, SM::kKBox);
          wg::rs<D>(dq_acc, ds_hi[kk], kd);
          wg::rs<D>(dq_acc, ds_lo[kk], kd);
        }
        wg::commit();
        wg::wait<0>();
        wg::fence_regs<D / 2>(dq_acc);
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk) {
          wg::fence_regs<4>(ds_hi[kk]);
          wg::fence_regs<4>(ds_lo[kk]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }
    store_rows<D>(dq_acc, scale, dq + b * sdq.b + h * sdq.h, sdq.s, rows_lo, s_len);
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, const void* dout,
                 const void* o, const void* o_lo, const float* lse, void* dq, void* dk,
                 void* dv, float* lse2, float* dd, int B, int Hq, int Hkv, int S,
                 const int64_t* const* st, float scale, int causal,
                 cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const int s_pad = (S + kPad - 1) / kPad * kPad;
  const int64_t rows = static_cast<int64_t>(B) * Hq * s_pad;
  const int64_t dd_blocks = (rows * (D / 8) + 255) / 256;
  if (dd_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_dd_kernel<D><<<static_cast<unsigned>(dd_blocks), 256, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(o_lo),
      static_cast<const bf16*>(dout), lse, lse2, dd, Hq, S, s_pad, rows,
      strides(st[4]), strides(st[3]));
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  // st: q, k, v, dout, o, dq, dk, dv
  CUtensorMap tq64, tdo64, tk128, tv128, tq128, tdo128, tk64, tv64;
  if (!wg::encode_bshd(&tq64, q, B, Hq, S, D, st[0], kRows) ||
      !wg::encode_bshd(&tdo64, dout, B, Hq, S, D, st[3], kRows) ||
      !wg::encode_bshd(&tk128, k, B, Hkv, S, D, st[1], kKvRows) ||
      !wg::encode_bshd(&tv128, v, B, Hkv, S, D, st[2], kKvRows) ||
      !wg::encode_bshd(&tq128, q, B, Hq, S, D, st[0], kKvRows) ||
      !wg::encode_bshd(&tdo128, dout, B, Hq, S, D, st[3], kKvRows) ||
      !wg::encode_bshd(&tk64, k, B, Hkv, S, D, st[1], kRows) ||
      !wg::encode_bshd(&tv64, v, B, Hkv, S, D, st[2], kRows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_t = (S + kKvRows - 1) / kKvRows;
  const float scale_log2 = scale * kLog2e;
  if ((err = allow_smem(flash_bwd_dkdv_kernel<D>, DkvSmem<D>::kBytes))) return err;
  flash_bwd_dkdv_kernel<D><<<static_cast<unsigned>(n_t * B * Hkv), kWgThreads,
                             DkvSmem<D>::kBytes, stream>>>(
      tq64, tdo64, tk128, tv128, lse2, dd, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), strides(st[6]), strides(st[7]), Hq, Hkv, S, s_pad,
      scale, scale_log2, causal);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  if ((err = allow_smem(flash_bwd_dq_kernel<D>, DqSmem<D>::kBytes))) return err;
  flash_bwd_dq_kernel<D><<<static_cast<unsigned>(n_t * B * Hq), kWgThreads,
                           DqSmem<D>::kBytes, stream>>>(
      tq128, tdo128, tk64, tv64, lse2, dd, static_cast<bf16*>(dq), strides(st[5]), Hq,
      Hq / Hkv, S, s_pad, scale, scale_log2, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The tensor-core route, bf16, d in {64, 128}. q, dout, o, o_lo, dq:
// [B, Hq, S, d]; k, v, dk, dv: [B, Hkv, S, d]; each at the element strides
// (b, h, s) of strides[i] for i = q, k, v, dout, o (o_lo shares them), dq,
// dk, dv, with unit stride along d; q, k, v, dout read by TMA (16-byte-
// aligned bases and strides of a multiple of 16 bytes), o, o_lo, dout with
// 16-byte loads. lse: f32 [B * Hq, S], the forward's; lse2, dd: f32
// [B * Hq, s_pad] scratch, s_pad = S rounded up to 128. Launches three
// kernels on `stream`; returns the first error, or cudaGetLastError().
extern "C" int flash_attention_bwd_wgmma_launch(
    const void* q, const void* k, const void* v, const void* dout, const void* o,
    const void* o_lo, const float* lse, void* dq, void* dk, void* dv, float* lse2,
    float* dd, int B, int Hq, int Hkv, int S, int D, const int64_t* sq,
    const int64_t* sk, const int64_t* sv, const int64_t* sdo, const int64_t* so,
    const int64_t* sdq, const int64_t* sdk, const int64_t* sdv, float scale,
    int causal, cudaStream_t stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || S < 1 || Hq % Hkv) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t* st[8] = {sq, sk, sv, sdo, so, sdq, sdk, sdv};
  const int64_t n_t = (S + kKvRows - 1) / kKvRows;
  if (n_t * B * Hq > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64) {
    return launch_wgmma<64>(q, k, v, dout, o, o_lo, lse, dq, dk, dv, lse2, dd, B, Hq,
                            Hkv, S, st, scale, causal, stream);
  }
  if (D == 128) {
    return launch_wgmma<128>(q, k, v, dout, o, o_lo, lse, dq, dk, dv, lse2, dd, B, Hq,
                             Hkv, S, st, scale, causal, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
