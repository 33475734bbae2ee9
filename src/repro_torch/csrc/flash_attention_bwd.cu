// flash_attention_bwd: the gradient of causal (or full) grouped-query
// attention, o = softmax(q k^T * scale) v with q head h reading kv head
// h / group: dq, dk and dv for q (B, Hq, S, D) and k, v (B, Hkv, S, D), with
// f32 accumulation, in bf16 or f32, at any S and D in {32, 64, 128, 256}.
//
// Replaces no TPU kernel: the JAX package trains through its plain path
// (`use_pallas` is off by default and the Pallas kernel has no custom_vjp),
// so this gradient is new, the backward of csrc/flash_attention.cu's
// forward.
//
// Bound on this card: operations. The gradient needs 2.5 times the
// forward's causal flops (five products of q-by-key tiles against the
// forward's two), at 989 TFLOP/s for bf16 on the H100's tensor cores. These
// kernels run f32 FMAs on the CUDA cores (67 TFLOP/s), so they sit far
// above that bound; wgmma and TMA are later work.
//
// The forward kernels write no log-sum-exp, so the gradient takes three
// launches, none with atomics, so dq, dk and dv are the same run to run:
//
//   flash_bwd_prep_kernel   a block per (query tile, b * hq): LSE_i, the
//                           log-sum-exp of row i's scaled scores over its
//                           keys, and Dd_i = rowsum(dO o O), in one online
//                           pass over the key tiles: a running max m, sum
//                           l = sum exp(s - m) and a = sum exp(s - m) dP
//                           with dP = dO V^T, rescaled as m grows, so
//                           Dd = a / l = sum_j P_ij dP_ij. That equals
//                           rowsum(dO o O) with O in f32; the forward's o,
//                           rounded to bf16, errs by 2^-9 of each element,
//                           more than dS = P (dP - Dd) can take where the
//                           two nearly cancel.
//   flash_bwd_dkdv_kernel   a block per (key tile, b * hkv): walks the
//                           group's q heads and, for each, the query tiles
//                           that see the key tile, in a fixed order,
//                           recomputing P = exp(s - LSE) and accumulating
//                           dV += P^T dO and dK += scale * dS^T Q in
//                           registers, dS = P o (dO V^T - Dd).
//   flash_bwd_dq_kernel     a block per (query tile, b * hq): walks the key
//                           tiles the queries see, dQ += scale * dS K.
//
// Every score s_ij = scale * sum_d q_id k_jd is summed by the same code in
// the same order in all three kernels, so P is the same where it is
// recomputed. Tiles are staged in shared memory in f32: q and dO both
// transposed ([D][rows], the A operand of a product over D) and as they lie
// ([rows][D], the B operand of a product over rows), k and v transposed.
// A block is 256 threads, a 16 x 16 grid; thread (ty, tx) owns a
// (rows / 16) x (cols / 16) patch of each product. Tiles are 64 x 64
// (32 x 32 at D = 256, to fit the staged tiles in shared memory). q, k, v
// and dO are read at their own (b, h, s) strides (rows of D contiguous
// elements on 16-byte boundaries); dq, dk, dv are written contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

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
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
  if ((err = allow_smem(flash_bwd_dkdv_kernel<T, D>, dkdv_smem<D>()))) return err;
  flash_bwd_dkdv_kernel<T, D><<<dim3(n_kt, B * Hkv), kThreads, dkdv_smem<D>(),
                                stream>>>(q, k, v, g, lse, dd,
                                          static_cast<T*>(dkv),
                                          static_cast<T*>(dvv), Hq, Hkv, S, sq,
                                          sk, sv, sdo, scale, causal);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  if ((err = allow_smem(flash_bwd_dq_kernel<T, D>, dq_smem<D>()))) return err;
  flash_bwd_dq_kernel<T, D><<<dim3(n_qt, B * Hq), kThreads, dq_smem<D>(),
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

// q, dout: (B, Hq, S, D) and k, v: (B, Hkv, S, D) at the (b, h, s) element
// strides given (unit stride along D, rows on 16-byte boundaries); dq
// (B, Hq, S, D) and dk, dv (B, Hkv, S, D) contiguous outputs; lse, dd: f32
// [B * Hq, S] scratch. dtype 0 f32, 1 bf16. Launches three kernels on
// `stream`; returns the first error, or cudaGetLastError().
extern "C" int flash_attention_bwd_launch(
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
