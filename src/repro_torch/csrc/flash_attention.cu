// flash_attention: causal (or full) grouped-query attention forward,
// softmax(q k^T * scale) v, with an online softmax and f32 accumulation;
// q head h reads kv head h / group. Two routes, chosen by the wrapper
// (kernels/flash_attention.py) from the dtype and head dim:
//
//   flash_wgmma_kernel  bf16, D in {64, 128}: Hopper's tensor cores.
//   flash_fma_kernel    f32 (any D of 32, 64, 128, 256) and bf16 with D in
//                       {32, 256}: f32 FMAs on the CUDA cores, exact to f32
//                       rounding (the f32 model runs it).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_kernel,
// the Pallas TPU kernel with grid (B*Hq, S/128, S/128) whose k axis runs
// in order, carrying the running max, denominator and accumulator in VMEM
// scratch; it computes the k tiles above the diagonal and masks them, and
// needs S % 128 == 0. Both routes take any S >= 1, skip the k tiles above
// the diagonal, start with the heaviest q tiles, and mask with -1e30, as
// the TPU kernel and attention_ref do.
//
// Bound on this card: operations. A causal launch needs
// 4 * B*Hq * D * S(S+1)/2 flops, at 989 TFLOP/s for bf16 on the H100's
// tensor cores, against reading q, k, v and writing o once (at qwen3's
// prefill shape 0.139 ms of operations against 0.040 ms of bytes).
//
// flash_wgmma_kernel (FA3's shape). One block of three warpgroups per
// (128-row q tile, b, h). Warpgroup 0 is the producer: it gives up its
// registers (setmaxnreg) and one thread issues TMA loads, Q once and K, V
// tiles of 128 keys into a ring of two stages guarded by mbarriers (full:
// bytes arrived; empty: both consumers done). Warpgroups 1 and 2 each own
// 64 q rows and take 240 registers:
//   S = Q K^T   wgmma m64n128k16, Q and K read from shared memory (K-major,
//               128-byte swizzle as TMA wrote it);
//   softmax     in the accumulator's own register layout: each row lives in
//               the four threads of a quad, so row max and sum are two
//               shuffles; exponents are exp2f with scale * log2(e) folded
//               into the f32 scores (q is not pre-scaled in bf16);
//   O += P V    wgmma m64nDk16 with P as the A operand straight from
//               registers (the S accumulator converted in place: the m16n8
//               C fragment is the m16n8k16 A fragment), V read MN-major
//               (transposed descriptor): no shared-memory round trip for
//               P. P goes in two bf16 parts, P_hi = bf16(P) and P_lo =
//               bf16(P - P_hi), two products into one accumulator: a single
//               bf16 P errs by 2^-9 of each weight, more than the repo's
//               per-element limit allows on outputs near zero; the split
//               keeps 16 bits for half the S product's work again.
// The two consumers interleave, so one's softmax overlaps the other's
// products. Only the first k tile a block visits (the diagonal one, or the
// ragged tail when not causal) is masked; the others are full. The TMA
// descriptors are 4-D (D, S, H, B) over the caller's strides, so q, k, v
// are read in the layer's [B, S, H, D] layout and o is written straight
// into it; rows past S are zero-filled by TMA and not stored. Under grad
// the epilogue also writes what the backward (flash_attention_bwd.cu) would
// otherwise recompute: each row's log-sum-exp, from the running max and
// sum, and o_lo = bf16(o_f32 - bf16(o_f32)), so that rowsum(dO o O) can be
// formed from o + o_lo at 16 significant bits; an ordinary call passes null
// pointers and writes neither. The products are in csrc/wgmma.cuh.
//
// flash_fma_kernel. One block of 128 threads per (q tile, b*hq). A q tile
// is 64 rows (32 for D = 256, to keep the accumulator at 64 registers a
// thread); the loop over k tiles of 64 keys inside the block takes the
// place of the TPU's sequential grid axis. Q (scaled), K and P are staged
// in shared memory transposed ([D][rows], [D][keys], [keys][rows]) and V as
// [keys][D], all in f32, so every inner-loop read is a 16-byte load with
// no bank conflict. Thread (ty, tx) of the 16 x 8 grid owns 4 (or 2) q
// rows: it computes their scores against 8 keys of the tile, reduces the
// row max and sum with shuffles over the 8 threads of the row, and
// accumulates D/8 output columns of each row in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBN = 64;  // keys per tile
constexpr float kMasked = -1e30f;

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

// The R consecutive floats at p (16- or 8-byte aligned) into registers.
template <int R>
__device__ __forceinline__ void load_rows(const float* p, float* out) {
  if constexpr (R == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x;
    out[1] = t.y;
    out[2] = t.z;
    out[3] = t.w;
  } else {
    static_assert(R == 2, "2 or 4 rows a thread");
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x;
    out[1] = t.y;
  }
}

template <int D>
struct Tile {
  static constexpr int kRows = D == 256 ? 2 : 4;  // q rows per thread
  static constexpr int kBM = 16 * kRows;           // q rows per block
  static constexpr int kCols = D / 8;              // output columns per thread
  static constexpr size_t kSmemFloats =
      static_cast<size_t>(D) * kBM + 2 * static_cast<size_t>(D) * kBN +
      static_cast<size_t>(kBN) * kBM;
};

// Copies rows [r0, r0 + n) x D of src (rows past `limit` read as zero)
// into shared memory, transposed to dst[d * n + r] (ld = n) when
// `transpose`, else dst[r * D + d]; values are multiplied by `mul`.
template <typename T, int D, bool transpose>
__device__ __forceinline__ void stage(const T* __restrict__ src, int64_t r0,
                                      int n, int64_t limit, float mul,
                                      float* __restrict__ dst) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecsPerRow = D / kVec;
  const int total = n * kVecsPerRow;
  for (int idx = threadIdx.x; idx < total; idx += kThreads) {
    // transposed: neighbouring threads take neighbouring rows, so the
    // shared-memory stores of one column land on consecutive addresses
    const int r = transpose ? idx % n : idx / kVecsPerRow;
    const int c = (transpose ? idx / n : idx % kVecsPerRow) * kVec;
    float vals[kVec];
    if (r0 + r < limit) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + (r0 + r) * D + c);
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < kVec; ++e) vals[e] = to_f32(v[e]) * mul;
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) vals[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      if (transpose) {
        dst[(c + e) * n + r] = vals[e];
      } else {
        dst[r * D + c + e] = vals[e];
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int bhq,
                 int s_len, int group, int n_qt, float scale, int causal) {
  using TL = Tile<D>;
  constexpr int R = TL::kRows;
  constexpr int BM = TL::kBM;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [D][BM]
  float* ks = qs + D * BM;                      // [D][kBN]
  float* vs = ks + D * kBN;                     // [kBN][D]
  float* ps = vs + kBN * D;                     // [kBN][BM]

  const int bh = blockIdx.x % bhq;
  const int qt = n_qt - 1 - blockIdx.x / bhq;  // heaviest tiles first
  const int q0 = qt * BM;
  const int64_t kvh = bh / group;
  const T* qb = q + static_cast<int64_t>(bh) * s_len * D;
  const T* kb = k + kvh * s_len * D;
  const T* vb = v + kvh * s_len * D;
  const int tx = threadIdx.x & 7;
  const int ty = threadIdx.x >> 3;
  const int row0 = ty * R;  // first of this thread's rows within the tile

  stage<T, D, true>(qb, q0, BM, s_len, scale, qs);

  float m[R], l[R], acc[R][TL::kCols];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < TL::kCols; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = causal ? min(s_len, q0 + BM) : s_len;
  for (int k0 = 0; k0 < kv_end; k0 += kBN) {
    __syncthreads();  // the previous tile's ks/vs/ps are no longer read
    stage<T, D, true>(kb, k0, kBN, s_len, 1.f, ks);
    stage<T, D, false>(vb, k0, kBN, s_len, 1.f, vs);
    __syncthreads();

    // scores of rows row0..row0+R-1 against keys g*32 + tx*4 + e
    float s[R][8];
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[R];
      load_rows<R>(qs + d * BM + row0, qv);
      const float4 ka = *reinterpret_cast<const float4*>(ks + d * kBN + tx * 4);
      const float4 kc = *reinterpret_cast<const float4*>(ks + d * kBN + 32 + tx * 4);
      const float kv[8] = {ka.x, ka.y, ka.z, ka.w, kc.x, kc.y, kc.z, kc.w};
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }

    // mask, online softmax, P to shared memory
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qpos = q0 + row0 + i;
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k0 + (j >> 2) * 32 + tx * 4 + (j & 3);
        const bool ok = key < s_len && (!causal || key <= qpos);
        s[i][j] = ok ? s[i][j] : kMasked;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < TL::kCols; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int kl = (j >> 2) * 32 + tx * 4 + (j & 3);
#pragma unroll
      for (int i = 0; i < R; ++i) ps[kl * BM + row0 + i] = s[i][j];
    }
    __syncthreads();

    // acc += P V over the keys that some row of the tile may see
    int n_keys = min(kBN, s_len - k0);
    if (causal) n_keys = min(n_keys, q0 + BM - k0);
    for (int kk = 0; kk < n_keys; ++kk) {
      float pv[R];
      load_rows<R>(ps + kk * BM + row0, pv);
#pragma unroll
      for (int g = 0; g < D / 32; ++g) {
        const float4 vv =
            *reinterpret_cast<const float4*>(vs + kk * D + (g * 8 + tx) * 4);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          acc[i][g * 4 + 0] = fmaf(pv[i], vv.x, acc[i][g * 4 + 0]);
          acc[i][g * 4 + 1] = fmaf(pv[i], vv.y, acc[i][g * 4 + 1]);
          acc[i][g * 4 + 2] = fmaf(pv[i], vv.z, acc[i][g * 4 + 2]);
          acc[i][g * 4 + 3] = fmaf(pv[i], vv.w, acc[i][g * 4 + 3]);
        }
      }
    }
  }

  T* ob = out + static_cast<int64_t>(bh) * s_len * D;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qpos = q0 + row0 + i;
    if (qpos >= s_len) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < D / 32; ++g) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ob[static_cast<int64_t>(qpos) * D + (g * 8 + tx) * 4 + e] =
            from_f32<T>(acc[i][g * 4 + e] * inv);
      }
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int bhq,
           int s_len, int group, float scale, int causal,
           cudaStream_t stream) {
  using TL = Tile<D>;
  const size_t smem = TL::kSmemFloats * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fma_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_qt = (s_len + TL::kBM - 1) / TL::kBM;
  const int64_t blocks = static_cast<int64_t>(n_qt) * bhq;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_fma_kernel<T, D><<<static_cast<unsigned>(blocks), kThreads, smem,
                       stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), bhq, s_len, group,
      n_qt, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* out,
               int bhq, int s_len, int d, int group, float scale, int causal,
               cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, out, bhq, s_len, group, scale, causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, bhq, s_len, group, scale, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, bhq, s_len, group, scale, causal, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, bhq, s_len, group, scale, causal, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The CUDA-core route. q, out: [bhq, s_len, d]; k, v: [bhq / group, s_len,
// d]; all contiguous, 16-byte aligned, bf16 (dtype 1) or f32 (dtype 0), on
// the current device. d in {32, 64, 128, 256}. Launches on `stream`;
// returns cudaGetLastError() (or the attribute call's error).
extern "C" int flash_attention_fma_launch(const void* q, const void* k,
                                      const void* v, void* out, int bhq,
                                      int s_len, int d, int group,
                                      float scale, int causal, int dtype,
                                      cudaStream_t stream) {
  if (bhq < 0 || s_len < 0 || group < 1 || bhq % group) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bhq == 0 || s_len == 0) return 0;
  if (dtype == 1) {
    return dispatch_d<__nv_bfloat16>(q, k, v, out, bhq, s_len, d, group, scale,
                                     causal, stream);
  }
  if (dtype == 0) {
    return dispatch_d<float>(q, k, v, out, bhq, s_len, d, group, scale, causal,
                             stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// flash_wgmma_kernel: bf16, D in {64, 128}, on the tensor cores
// ---------------------------------------------------------------------------

namespace {

constexpr int kWgBM = 128;  // q rows per block: two consumer warpgroups of 64
constexpr int kWgBN = 128;  // keys per K/V tile (== kWgBM: one diagonal tile)
constexpr int kStages = 2;  // K/V ring depth
constexpr int kWgThreads = 384;  // producer warpgroup + two consumer warpgroups
using wg::kBoxCols;
constexpr int kBoxRowBytes = wg::kRowBytes;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory: Q [D/64 boxes][128 rows][64], then per stage K and V tiles
// of the same shape, then the mbarriers. Every box is 1024-byte aligned, as
// the 128-byte swizzle (8 rows of 128 bytes) needs.
template <int D>
struct WgSmem {
  static constexpr int kQBytes = kWgBM * D * 2;
  static constexpr int kTileBytes = kWgBN * D * 2;  // one K or V tile
  static constexpr int kBoxBytes = kWgBN * kBoxRowBytes;
  static constexpr int kBars = kQBytes + kStages * 2 * kTileBytes;
  static constexpr int kBytes = kBars + 8 * (1 + 3 * kStages) + 1024;  // + align
};

using tma::mbar_arrive;
using tma::mbar_expect_tx;
using tma::mbar_init;
using tma::mbar_wait;
using tma::smem_u32;

// q, k, v: 4-D (D, S, H, B) bf16 maps with 64 x 128 x 1 x 1 boxes; out:
// bf16 at out + b*o_sb + s*o_ss + h*o_sh + d. Block x: (q tile, b*heads),
// heaviest q tiles first. Under grad the caller also passes o_lo (o's
// layout: bf16(o_f32 - bf16(o_f32)), the part of the f32 output that the
// bf16 o drops) and lse (f32 [b*heads][s_len], each row's natural
// log-sum-exp of its scaled scores); both are null otherwise and nothing
// more is written.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ out,
                       __nv_bfloat16* __restrict__ o_lo, float* __restrict__ lse,
                       int64_t o_sb, int64_t o_ss, int64_t o_sh, int heads, int bhq,
                       int s_len, int group, int n_qt, float scale_log2, int causal) {
  using SM = WgSmem<D>;
  constexpr int kBoxes = D / kBoxCols;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t bars = base + SM::kBars;
  const uint32_t q_full = bars;
  auto k_tile = [&](int st) { return base + SM::kQBytes + st * 2 * SM::kTileBytes; };
  auto v_tile = [&](int st) { return k_tile(st) + SM::kTileBytes; };
  auto k_full = [&](int st) { return bars + 8 * (1 + st); };
  auto v_full = [&](int st) { return bars + 8 * (1 + kStages + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + 2 * kStages + st); };

  const int bh = blockIdx.x % bhq;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / bhq);
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = qt * kWgBM;
  // k tiles visited, last first: with kWgBN == kWgBM the first one is the
  // diagonal tile (causal) or the ragged tail, the only one needing a mask
  const int n_kv = causal ? qt + 1 : (s_len + kWgBN - 1) / kWgBN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      const int kvh = h / group;
      mbar_expect_tx(q_full, SM::kQBytes);
      for (int c = 0; c < kBoxes; ++c) {
        tma::load_4d(q_s + c * SM::kBoxBytes, &tq, q_full, c * kBoxCols, q0, h, b);
      }
      for (int it = 0; it < n_kv; ++it) {
        const int st = it % kStages;
        const uint32_t ph = (it / kStages) & 1;
        const int k0 = (n_kv - 1 - it) * kWgBN;
        mbar_wait(empty(st), ph ^ 1);
        mbar_expect_tx(k_full(st), SM::kTileBytes);
        for (int c = 0; c < kBoxes; ++c) {
          tma::load_4d(k_tile(st) + c * SM::kBoxBytes, &tk, k_full(st), c * kBoxCols,
                   k0, kvh, b);
        }
        mbar_expect_tx(v_full(st), SM::kTileBytes);
        for (int c = 0; c < kBoxes; ++c) {
          tma::load_4d(v_tile(st) + c * SM::kBoxBytes, &tv, v_full(st), c * kBoxCols,
                   k0, kvh, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;  // which 64 rows of the q tile
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int lane = t % 32;
    // this thread's rows (accumulator layout): r and r + 8
    const int r = q0 + cw * 64 + warp * 16 + lane / 4;
    const int col = 2 * (lane % 4);  // its first column in each 8-column block

    float s[kWgBN / 2];  // S = Q K^T, 64 x 128 per warpgroup
    float o[D / 2];      // O, 64 x D per warpgroup
    // P = P_hi + P_lo in bf16 pairs, one A fragment per 16 keys each
    uint32_t p_hi[kWgBN / 16][4];
    uint32_t p_lo[kWgBN / 16][4];
    float m[2] = {kMasked, kMasked};
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

    const uint32_t q_rows = q_s + cw * 64 * kBoxRowBytes;
    mbar_wait(q_full, 0);
    for (int it = 0; it < n_kv; ++it) {
      const int st = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      const int k0 = (n_kv - 1 - it) * kWgBN;

      mbar_wait(k_full(st), ph);
      wg::fence_regs<kWgBN / 2>(s);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // 16 head-dim columns: box kk / 4, 32 bytes further per step
        wg::ss_n128(s, wg::kmajor(q_rows, kk, SM::kBoxBytes),
                    wg::kmajor(k_tile(st), kk, SM::kBoxBytes), kk > 0);
      }
      wg::commit();
      wg::wait<0>();
      wg::fence_regs<kWgBN / 2>(s);

      if (it == 0) {
#pragma unroll
        for (int i = 0; i < kWgBN / 2; ++i) {
          const int key = k0 + (i / 4) * 8 + col + (i % 2);
          const int qpos = r + 8 * ((i % 4) / 2);
          if (key >= s_len || (causal && key > qpos)) s[i] = kMasked;
        }
      }

      // online softmax, row hh = 0 (r) and 1 (r + 8)
      float alpha[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = kMasked;
#pragma unroll
        for (int j = 0; j < kWgBN / 8; ++j) {
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hh], mx);
        alpha[hh] = exp2f((m[hh] - m_new) * scale_log2);
        m[hh] = m_new;
        const float mc = m_new * scale_log2;
#pragma unroll
        for (int j = 0; j < kWgBN / 8; ++j) {
          s[4 * j + 2 * hh] = exp2f(fmaf(s[4 * j + 2 * hh], scale_log2, -mc));
          s[4 * j + 2 * hh + 1] = exp2f(fmaf(s[4 * j + 2 * hh + 1], scale_log2, -mc));
        }
      }
      // P to bf16 A fragments: for keys 16kk.., a0/a1 are rows r/r+8 of the
      // 8-column block 2kk, a2/a3 those of block 2kk + 1. P_hi is P rounded
      // to bf16, P_lo the rest rounded, so P keeps 16 significant bits: one
      // bf16 P errs by 2^-9 of each weight, which on outputs near zero
      // exceeds the per-element limit the kernel is held to.
      float rowsum[2] = {0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < kWgBN / 16; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 2 * kk + e / 2;
          const int hh = e % 2;
          const float a = s[4 * j + 2 * hh];
          const float c = s[4 * j + 2 * hh + 1];
          rowsum[hh] += a + c;
          const __nv_bfloat162 hi = __floats2bfloat162_rn(a, c);
          const float2 back = __bfloat1622float2(hi);
          const __nv_bfloat162 lo = __floats2bfloat162_rn(a - back.x, c - back.y);
          p_hi[kk][e] = *reinterpret_cast<const uint32_t*>(&hi);
          p_lo[kk][e] = *reinterpret_cast<const uint32_t*>(&lo);
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + rowsum[hh];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i % 4) / 2];

      mbar_wait(v_full(st), ph);
      wg::fence_regs<D / 2>(o);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < kWgBN / 16; ++kk) {
        // 16 keys: rows 16kk.. of every 64-column box of V
        const uint64_t vd = wg::mnmajor(v_tile(st), kk, SM::kBoxBytes);
        wg::rs<D>(o, p_hi[kk], vd);
        wg::rs<D>(o, p_lo[kk], vd);
      }
      wg::commit();
      wg::wait<0>();
      wg::fence_regs<D / 2>(o);
#pragma unroll
      for (int kk = 0; kk < kWgBN / 16; ++kk) {
        wg::fence_regs<4>(p_hi[kk]);
        wg::fence_regs<4>(p_lo[kk]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float sum = l[hh];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float inv = 1.f / fmaxf(sum, 1e-30f);
      const int row = r + 8 * hh;
      if (row < s_len) {
        const int64_t at = b * o_sb + row * o_ss + h * o_sh + col;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const float a = o[4 * j + 2 * hh] * inv;
          const float c = o[4 * j + 2 * hh + 1] * inv;
          const __nv_bfloat162 hi = __floats2bfloat162_rn(a, c);
          *reinterpret_cast<__nv_bfloat162*>(out + at + 8 * j) = hi;
          if (o_lo != nullptr) {
            const float2 back = __bfloat1622float2(hi);
            *reinterpret_cast<__nv_bfloat162*>(o_lo + at + 8 * j) =
                __floats2bfloat162_rn(a - back.x, c - back.y);
          }
        }
        // m is the row's largest raw score: P = 2^((s - m) scale log2 e)
        if (lse != nullptr && lane % 4 == 0) {
          lse[static_cast<int64_t>(bh) * s_len + row] =
              (m[hh] * scale_log2 + log2f(sum)) * kLn2;
        }
      }
    }
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, void* o_lo,
                 float* lse, int batch, int heads, int kv_heads, int s_len,
                 const int64_t* qs, const int64_t* ks, const int64_t* vs,
                 const int64_t* os, float scale, int causal, cudaStream_t stream) {
  using SM = WgSmem<D>;
  CUtensorMap tq, tk, tv;
  if (!wg::encode_bshd(&tq, q, batch, heads, s_len, D, qs, kWgBM) ||
      !wg::encode_bshd(&tk, k, batch, kv_heads, s_len, D, ks, kWgBN) ||
      !wg::encode_bshd(&tv, v, batch, kv_heads, s_len, D, vs, kWgBN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t e = cudaFuncSetAttribute(
      flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SM::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_qt = (s_len + kWgBM - 1) / kWgBM;
  const int64_t bhq = static_cast<int64_t>(batch) * heads;
  const int64_t blocks = static_cast<int64_t>(n_qt) * bhq;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_wgmma_kernel<D><<<static_cast<unsigned>(blocks), kWgThreads, SM::kBytes,
                          stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), static_cast<__nv_bfloat16*>(o_lo),
      lse, os[0], os[2], os[1], heads, static_cast<int>(bhq), s_len, heads / kv_heads,
      n_qt, scale * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The tensor-core route. q: [batch, heads, s_len, d] bf16, k, v: [batch,
// kv_heads, s_len, d] bf16, out: [batch, heads, s_len, d] bf16, each at any
// element strides (b, h, s) given in *_strides, with unit stride along d,
// 16-byte-aligned bases and strides of a multiple of 16 bytes (TMA's rule);
// d in {64, 128}; heads a multiple of kv_heads. o_lo (out's strides) and
// lse (f32 [batch * heads, s_len]) are null, or, under grad, where the
// kernel also writes the residual of o and each row's log-sum-exp for the
// backward. Launches on `stream`; returns cudaGetLastError() (or the
// attribute call's error, or cudaErrorInvalidValue when a tensor map cannot
// be encoded).
extern "C" int flash_attention_wgmma_launch(
    const void* q, const void* k, const void* v, void* out, void* o_lo, float* lse,
    int batch, int heads, int kv_heads, int s_len, int d, const int64_t* q_strides,
    const int64_t* k_strides, const int64_t* v_strides, const int64_t* o_strides,
    float scale, int causal, cudaStream_t stream) {
  if (batch < 0 || s_len < 0 || kv_heads < 1 || heads < kv_heads ||
      heads % kv_heads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || s_len == 0) return 0;
  if (d == 64) {
    return launch_wgmma<64>(q, k, v, out, o_lo, lse, batch, heads, kv_heads, s_len,
                            q_strides,
                            k_strides, v_strides, o_strides, scale, causal, stream);
  }
  if (d == 128) {
    return launch_wgmma<128>(q, k, v, out, o_lo, lse, batch, heads, kv_heads, s_len,
                             q_strides,
                             k_strides, v_strides, o_strides, scale, causal, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
