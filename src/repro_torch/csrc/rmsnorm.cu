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
