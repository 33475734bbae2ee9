// rmsnorm: y = x * rsqrt(mean(x^2) + eps) * (w [+ 1]) over the last axis,
// for rows of bf16 or f32 with f32 weights; the result is rounded once, to
// x's dtype.
//
// Replaces: src/repro/kernels/rmsnorm.py::rmsnorm_kernel, the Pallas TPU
// kernel that normalizes blocks of 8 rows with the feature axis resident
// in VMEM (its wrapper pads the row count to a multiple of 8; this kernel
// takes any row count).
//
// Design: one warp per row, 8 rows per 256-thread block. Each lane loads
// 16 bytes at a time (8 bf16 or 4 f32 values; neighbouring lanes on
// neighbouring addresses), sums the squares in f32, and the warp reduces
// with shuffles. A second pass over the row (now in L1/L2) scales each
// value by rsqrt(ms + eps) * (w + plus_one) in f32 and stores it with one
// rounding. Rows whose width is not a multiple of the vector, or whose
// base is not 16-byte aligned, take a scalar loop.
// Row widths on the serving path: 2048 (qwen3 hidden), 128 (q/k norm over
// B*S*H rows), 768 and 1536 (mamba2 hidden and gate norm).
//
// Bound on this card: memory. The function must read R*D elements and w
// and write R*D elements, at 3.35 TB/s on an H100 SXM; it does 3 flops
// per element, far below the compute rate. The design reads each element
// from device memory once (the second pass hits cache) and writes it once.

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
__global__ void rmsnorm_kernel(const T* __restrict__ x,
                               const float* __restrict__ w,
                               T* __restrict__ out, int64_t rows, int d,
                               float eps, float plus) {
  constexpr int kVec = 16 / sizeof(T);
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

template <typename T>
int launch(const void* x, const float* w, void* out, int64_t rows, int d,
           float eps, float plus, cudaStream_t stream) {
  const int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  rmsnorm_kernel<T><<<static_cast<unsigned>(blocks), 32 * kWarpsPerBlock, 0,
                      stream>>>(static_cast<const T*>(x), w,
                                static_cast<T*>(out), rows, d, eps, plus);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

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
