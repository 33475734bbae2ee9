// flash_attention: causal (or full) grouped-query attention forward,
// softmax(q k^T * scale) v, with an online softmax and f32 accumulation.
// q: [B*Hq, S, D]; k, v: [B*Hkv, S, D]; q row bh reads kv row bh / group;
// out: [B*Hq, S, D] in q's dtype (bf16 or f32). D in {32, 64, 128, 256}.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_kernel,
// the Pallas TPU kernel with grid (B*Hq, S/128, S/128) whose k axis runs
// in order, carrying the running max, denominator and accumulator in VMEM
// scratch; it computes the k tiles above the diagonal and masks them, and
// needs S % 128 == 0.
//
// Design: one block of 128 threads per (q tile, b*hq). A q tile is 64 rows
// (32 for D = 256, to keep the accumulator at 64 registers a thread); the
// loop over k tiles of 64 keys inside the block takes the place of the
// TPU's sequential grid axis. Q (scaled), K and P are staged in shared
// memory transposed ([D][rows], [D][keys], [keys][rows]) and V as
// [keys][D], all in f32, so every inner-loop read is a 16-byte load with
// no bank conflict. Thread (ty, tx) of the 16 x 8 grid owns 4 (or 2) q
// rows: it computes their scores against 8 keys of the tile, reduces the
// row max and sum with shuffles over the 8 threads of the row, and
// accumulates D/8 output columns of each row in registers. The running
// max, denominator and accumulator stay in registers across the k loop.
// K tiles wholly above the diagonal are never loaded (the TPU kernel
// computes and masks them), and blocks start with the heaviest q tiles.
// Masked scores are -1e30, as in the TPU kernel and attention_ref; keys
// and q rows past S are masked or not stored, so any S works.
// The products run on the CUDA cores in f32 (FMA), for bf16 and f32 inputs
// alike: simple and exact to f32 rounding. Tensor-core wgmma with TMA
// staging is later work.
//
// Bound on this card: operations. A causal launch needs
// 4 * B*Hq * D * S(S+1)/2 flops, at 989 TFLOP/s for bf16 on the H100's
// tensor cores, against reading q, k, v and writing o once. This kernel
// uses the f32 CUDA cores (67 TFLOP/s peak), so it sits well above the
// bound; skipping the upper triangle halves the work of a dense sweep.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_qt = (s_len + TL::kBM - 1) / TL::kBM;
  const int64_t blocks = static_cast<int64_t>(n_qt) * bhq;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_kernel<T, D><<<static_cast<unsigned>(blocks), kThreads, smem,
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

// q, out: [bhq, s_len, d]; k, v: [bhq / group, s_len, d]; all contiguous,
// 16-byte aligned, bf16 (dtype 1) or f32 (dtype 0), on the current device.
// d in {32, 64, 128, 256}. Launches on `stream`; returns cudaGetLastError()
// (or the attribute call's error).
extern "C" int flash_attention_launch(const void* q, const void* k,
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
