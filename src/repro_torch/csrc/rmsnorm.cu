// rmsnorm: y = x * rsqrt(mean(x^2) + eps) * (w [+ 1]) over the last axis,
// for rows of bf16 or f32 with f32 weights; the result is rounded once, to
// x's dtype.
//
// Replaces: src/repro/kernels/rmsnorm.py::rmsnorm_kernel, the Pallas TPU
// kernel that normalizes blocks of 8 rows with the feature axis resident
// in VMEM (its wrapper pads the row count to a multiple of 8; this kernel
// takes any row count).
//
// Bound on this card: memory. The function must read R*D elements and w
// and write R*D elements, at 3.35 TB/s on an H100 SXM; it does 4 flops
// per element, far below the compute rate. A prefill's norms find their
// rows cold (the activations of 8 x 2,048 tokens exceed the 50 MB L2).
//
// Design: one device-memory pass. For the widths of the serving path,
// 2048 (qwen3 hidden), 128 (its q/k norm over B*S*H rows), 768 and 1536
// (mamba2 hidden and gate norm), and any width of kV * kLanes 16-byte
// vectors, rmsnorm_kernel<T, kV, kLanes> gives a row kLanes lanes and each
// lane kV vectors, all loaded before the first reduction (kV 16-byte loads
// in flight a lane) and kept in registers: the sum of squares is reduced
// with shuffles within the row's lanes, and the row is normalized from
// registers, with the weight read as float4s. Rows of 128 bf16 (16
// vectors) go two to a warp, 16 lanes each, where one warp a row left half
// of it idle. Other widths, and rows whose base is not 16-byte aligned,
// take rmsnorm_any_kernel: a warp per row and a second pass over the row,
// from cache. 8 warps a block either way.
//
// Backward (rmsnorm_bwd_kernel, rmsnorm_dw_kernel). Replaces no TPU kernel:
// the JAX package trains through its plain path (no custom_vjp on the
// Pallas kernel), so this gradient is new. For y = x * r * (w + plus),
// r = rsqrt(mean(x^2) + eps):
//   dx = r * (dy * (w + plus)) - x * r^3 * mean(dy * (w + plus) * x)
//   dw = sum over rows of dy * x * r
// with f32 statistics; dx is rounded once to x's dtype, dw stays f32.
// Bound on this card: memory (read x, w, dy; write dx). One warp per row,
// two passes over the row (the second from cache): the first reduces the
// sum of squares and the dot, the second writes dx and adds dy * x * r
// into the warp's own f32 row of dw partials in shared memory (each lane
// owns fixed columns, so no atomics). A fixed number of blocks walks the
// rows in a fixed order; each block then sums its warps' partials in warp
// order into one row of a [blocks, D] buffer, which rmsnorm_dw_kernel sums
// over the blocks in block order. The result is the same run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

template <typename T>
struct Vec {
  static constexpr int kN = 16 / sizeof(T);  // elements in 16 bytes
};

// Reduces v over the `lanes` (a power of two) lanes of a sub-group that
// starts at a multiple of `lanes`.
template <int kLanes>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// Rows of exactly kV * kLanes * Vec<T>::kN elements with 16-byte-aligned
// bases: kLanes lanes a row (32 / kLanes rows a warp), kV 16-byte vectors a
// lane, all loaded before the first reduction and kept in registers, so
// the row is read from device memory once. Lane l of a row holds vectors
// l, l + kLanes, ... (neighbouring lanes on neighbouring addresses).
template <typename T, int kV, int kLanes>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   T* __restrict__ out, int64_t rows, float eps, float plus) {
  constexpr int kN = Vec<T>::kN;
  constexpr int kD = kV * kLanes * kN;
  constexpr int kRowsPerWarp = 32 / kLanes;
  const int lane = threadIdx.x & 31;
  const int sub = lane % kLanes;
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5)) *
          kRowsPerWarp +
      lane / kLanes;
  // every lane of the warp takes part in the shuffles; a row past the end
  // loads nothing and stores nothing
  const bool live = row < rows;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (live ? row : 0) * kD);
  uint4 raw[kV];
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    raw[i] = live ? __ldg(xr + sub + i * kLanes) : make_uint4(0, 0, 0, 0);
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const T* v = reinterpret_cast<const T*>(&raw[i]);
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const float f = to_f32(v[e]);
      ss += f * f;
    }
  }
  ss = group_sum<kLanes>(ss);
  if (!live) return;
  const float mult = rsqrtf(ss / static_cast<float>(kD) + eps);
  const float4* w4 = reinterpret_cast<const float4*>(w);
  uint4* yr = reinterpret_cast<uint4*>(out + row * kD);
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const int vec = sub + i * kLanes;
    float wv[kN];
#pragma unroll
    for (int f = 0; f < kN / 4; ++f) {
      const float4 t = __ldg(w4 + vec * (kN / 4) + f);
      wv[4 * f] = t.x;
      wv[4 * f + 1] = t.y;
      wv[4 * f + 2] = t.z;
      wv[4 * f + 3] = t.w;
    }
    const T* v = reinterpret_cast<const T*>(&raw[i]);
    uint4 res;
    T* o = reinterpret_cast<T*>(&res);
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      o[e] = from_f32<T>(to_f32(v[e]) * mult * (wv[e] + plus));
    }
    yr[vec] = res;
  }
}

// Any width and alignment: a warp per row, two passes over the row (the
// second from cache), 16-byte loads where the row allows them.
template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    rmsnorm_any_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       T* __restrict__ out, int64_t rows, int d, float eps,
                       float plus) {
  constexpr int kVec = Vec<T>::kN;
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * d;
  T* yr = out + row * d;
  const bool vec = (d % kVec == 0) &&
                   (reinterpret_cast<uintptr_t>(xr) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(yr) % 16 == 0);

  float ss = 0.f;
  if (vec) {
    for (int i = lane * kVec; i < d; i += 32 * kVec) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float f = to_f32(v[e]);
        ss += f * f;
      }
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      const float f = to_f32(xr[i]);
      ss += f * f;
    }
  }
  ss = warp_sum(ss);
  const float mult = rsqrtf(ss / static_cast<float>(d) + eps);

  if (vec) {
    for (int i = lane * kVec; i < d; i += 32 * kVec) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      const T* v = reinterpret_cast<const T*>(&raw);
      uint4 res;
      T* o = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        o[e] = from_f32<T>(to_f32(v[e]) * mult * (__ldg(w + i + e) + plus));
      }
      *reinterpret_cast<uint4*>(yr + i) = res;
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      yr[i] = from_f32<T>(to_f32(xr[i]) * mult * (__ldg(w + i) + plus));
    }
  }
}

template <typename T, int kV, int kLanes>
int launch_rows(const T* x, const float* w, T* out, int64_t rows, float eps,
                float plus, cudaStream_t stream) {
  constexpr int64_t kRowsPerBlock = kWarpsPerBlock * (32 / kLanes);
  const int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  rmsnorm_kernel<T, kV, kLanes><<<static_cast<unsigned>(blocks),
                                  32 * kWarpsPerBlock, 0, stream>>>(
      x, w, out, rows, eps, plus);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* xv, const float* w, void* outv, int64_t rows, int d,
           float eps, float plus, cudaStream_t stream) {
  constexpr int kN = Vec<T>::kN;
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(outv);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0 && d % kN == 0;
  const int vecs = d / kN;
  if (aligned && vecs == 16) {
    return launch_rows<T, 1, 16>(x, w, out, rows, eps, plus, stream);
  }
  if (aligned && vecs % 32 == 0) {
    switch (vecs / 32) {
      case 1: return launch_rows<T, 1, 32>(x, w, out, rows, eps, plus, stream);
      case 2: return launch_rows<T, 2, 32>(x, w, out, rows, eps, plus, stream);
      case 3: return launch_rows<T, 3, 32>(x, w, out, rows, eps, plus, stream);
      case 4: return launch_rows<T, 4, 32>(x, w, out, rows, eps, plus, stream);
      case 6: return launch_rows<T, 6, 32>(x, w, out, rows, eps, plus, stream);
      case 8: return launch_rows<T, 8, 32>(x, w, out, rows, eps, plus, stream);
      case 12: return launch_rows<T, 12, 32>(x, w, out, rows, eps, plus, stream);
      case 16: return launch_rows<T, 16, 32>(x, w, out, rows, eps, plus, stream);
      default: break;
    }
  }
  const int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  rmsnorm_any_kernel<T><<<static_cast<unsigned>(blocks), 32 * kWarpsPerBlock, 0,
                          stream>>>(x, w, out, rows, d, eps, plus);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// blocks of the backward: a constant, so the order of dw's sums depends
// on the shape alone and not on the card
constexpr int kBwdMaxBlocks = 528;
constexpr int kBwdSmemBytes = 200 * 1024;  // the warps' dw partials

// Rows of x, dy and dx are [rows, d] contiguous. kVecPath: d is a multiple
// of the 16-byte vector and the bases are 16-byte aligned.
template <typename T, bool kVecPath>
__global__ void rmsnorm_bwd_kernel(const T* __restrict__ x,
                                   const float* __restrict__ w,
                                   const T* __restrict__ dy, T* __restrict__ dx,
                                   float* __restrict__ partial, int64_t rows,
                                   int d, float eps, float plus) {
  extern __shared__ float4 smem4[];
  float* acc_all = reinterpret_cast<float*>(smem4);  // [warps][d]
  constexpr int kN = Vec<T>::kN;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < warps * d; i += blockDim.x) acc_all[i] = 0.f;
  __syncthreads();
  float* acc = acc_all + static_cast<int64_t>(warp) * d;
  const float inv_d = 1.f / static_cast<float>(d);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * warps;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * warps + warp; row < rows;
       row += stride) {
    const T* xr = x + row * d;
    const T* gr = dy + row * d;
    T* dr = dx + row * d;
    float ss = 0.f, dot = 0.f;
    if constexpr (kVecPath) {
      for (int i = lane * kN; i < d; i += 32 * kN) {
        const uint4 xa = *reinterpret_cast<const uint4*>(xr + i);
        const uint4 ga = *reinterpret_cast<const uint4*>(gr + i);
        const T* xv = reinterpret_cast<const T*>(&xa);
        const T* gv = reinterpret_cast<const T*>(&ga);
#pragma unroll
        for (int e = 0; e < kN; ++e) {
          const float xf = to_f32(xv[e]);
          ss += xf * xf;
          dot += to_f32(gv[e]) * (__ldg(w + i + e) + plus) * xf;
        }
      }
    } else {
      for (int i = lane; i < d; i += 32) {
        const float xf = to_f32(xr[i]);
        ss += xf * xf;
        dot += to_f32(gr[i]) * (__ldg(w + i) + plus) * xf;
      }
    }
    ss = warp_sum(ss);
    dot = warp_sum(dot);
    const float r = rsqrtf(ss * inv_d + eps);
    const float c = r * r * r * dot * inv_d;
    if constexpr (kVecPath) {
      for (int i = lane * kN; i < d; i += 32 * kN) {
        const uint4 xa = *reinterpret_cast<const uint4*>(xr + i);
        const uint4 ga = *reinterpret_cast<const uint4*>(gr + i);
        const T* xv = reinterpret_cast<const T*>(&xa);
        const T* gv = reinterpret_cast<const T*>(&ga);
        uint4 res;
        T* o = reinterpret_cast<T*>(&res);
#pragma unroll
        for (int e = 0; e < kN; ++e) {
          const float xf = to_f32(xv[e]);
          const float gf = to_f32(gv[e]);
          o[e] = from_f32<T>(r * (gf * (__ldg(w + i + e) + plus)) - c * xf);
          acc[i + e] += gf * xf * r;
        }
        *reinterpret_cast<uint4*>(dr + i) = res;
      }
    } else {
      for (int i = lane; i < d; i += 32) {
        const float xf = to_f32(xr[i]);
        const float gf = to_f32(gr[i]);
        dr[i] = from_f32<T>(r * (gf * (__ldg(w + i) + plus)) - c * xf);
        acc[i] += gf * xf * r;
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < warps; ++k) s += acc_all[static_cast<int64_t>(k) * d + j];
    partial[static_cast<int64_t>(blockIdx.x) * d + j] = s;
  }
}

// dw[j] = sum over the blocks, in block order, of partial[b][j].
__global__ void rmsnorm_dw_kernel(const float* __restrict__ partial,
                                  float* __restrict__ dw, int blocks, int d) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= d) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partial[static_cast<int64_t>(b) * d + j];
  dw[j] = s;
}

template <typename T, bool kVecPath>
int launch_bwd_rows(const T* x, const float* w, const T* dy, T* dx,
                    float* partial, int64_t rows, int d, int warps, int blocks,
                    float eps, float plus, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(warps) * d * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rmsnorm_bwd_kernel<T, kVecPath>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  rmsnorm_bwd_kernel<T, kVecPath><<<blocks, 32 * warps, smem, stream>>>(
      x, w, dy, dx, partial, rows, d, eps, plus);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* xv, const float* w, const void* dyv, void* dxv,
               float* partial, float* dw, int64_t rows, int d, int warps,
               int blocks, float eps, float plus, cudaStream_t stream) {
  constexpr int kN = Vec<T>::kN;
  const T* x = static_cast<const T*>(xv);
  const T* dy = static_cast<const T*>(dyv);
  T* dx = static_cast<T*>(dxv);
  const bool vec = d % kN == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  const int err = vec ? launch_bwd_rows<T, true>(x, w, dy, dx, partial, rows, d,
                                                 warps, blocks, eps, plus, stream)
                      : launch_bwd_rows<T, false>(x, w, dy, dx, partial, rows, d,
                                                  warps, blocks, eps, plus, stream);
  if (err != 0) return err;
  rmsnorm_dw_kernel<<<(d + 255) / 256, 256, 0, stream>>>(partial, dw, blocks, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The backward's launch shape for rows of width d: the blocks (the rows of
// the [blocks, d] f32 partial buffer the caller allocates) and the warps a
// block. Returns 0, or cudaErrorInvalidValue for a width whose partials do
// not fit in shared memory.
extern "C" int rmsnorm_bwd_shape(int64_t rows, int d, int* blocks, int* warps) {
  if (rows < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t fit = kBwdSmemBytes / (static_cast<int64_t>(d) * 4);
  if (fit < 1) return static_cast<int>(cudaErrorInvalidValue);
  *warps = static_cast<int>(fit < kWarpsPerBlock ? fit : kWarpsPerBlock);
  const int64_t need = (rows + *warps - 1) / *warps;
  *blocks = static_cast<int>(need < kBwdMaxBlocks ? need : kBwdMaxBlocks);
  return 0;
}

// x, dy, dx: [rows, d] contiguous, bf16 (dtype 1) or f32 (dtype 0); w:
// f32[d]; partial: f32[blocks, d] scratch; dw: f32[d]. blocks and warps
// as rmsnorm_bwd_shape gives them. Launches two kernels on `stream`;
// returns cudaGetLastError().
extern "C" int rmsnorm_bwd_launch(const void* x, const float* w, const void* dy,
                                  void* dx, float* partial, float* dw,
                                  int64_t rows, int d, int blocks, int warps,
                                  float eps, int plus_one, int dtype,
                                  cudaStream_t stream) {
  if (rows < 1 || d < 1 || blocks < 1 || warps < 1 || warps > kWarpsPerBlock ||
      static_cast<int64_t>(warps) * d * 4 > kBwdSmemBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float plus = plus_one ? 1.f : 0.f;
  if (dtype == 1) {
    return launch_bwd<__nv_bfloat16>(x, w, dy, dx, partial, dw, rows, d, warps,
                                     blocks, eps, plus, stream);
  }
  if (dtype == 0) {
    return launch_bwd<float>(x, w, dy, dx, partial, dw, rows, d, warps, blocks,
                             eps, plus, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// x, out: [rows, d] contiguous, bf16 (dtype 1) or f32 (dtype 0); w: f32[d];
// plus_one adds 1 to every weight. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int rmsnorm_launch(const void* x, const float* w, void* out,
                              int64_t rows, int d, float eps, int plus_one,
                              int dtype, cudaStream_t stream) {
  if (rows < 0 || d < 1 || rows > 8LL * 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  const float plus = plus_one ? 1.f : 0.f;
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, w, out, rows, d, eps, plus, stream);
  }
  if (dtype == 0) return launch<float>(x, w, out, rows, d, eps, plus, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
