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
// Backward (rmsnorm_bwd_rows_kernel or rmsnorm_bwd_any_kernel, then
// rmsnorm_dw_kernel). Replaces no TPU kernel: the JAX package trains
// through its plain path (no custom_vjp on the Pallas kernel), so this
// gradient is new. For y = x * r * (w + plus), r = rsqrt(mean(x^2) + eps):
//   dx = r * (dy * (w + plus)) - x * r^3 * mean(dy * (w + plus) * x)
//   dw = sum over rows of dy * x * r
// with f32 statistics; dx is rounded once to x's dtype, dw stays f32.
// Bound on this card: memory (read x, w, dy; write dx). At the widths of
// the training path, one pass from registers (rmsnorm_bwd_rows_kernel): a
// lane keeps its share of each row's x and dy as the forward does (rows of
// 128 two to a warp), several rows' worth in flight, and adds its fixed
// columns of dy * x * r into registers over every row its warp takes; the
// block's warps meet once, at the end, in shared memory laid out so that
// no access conflicts. Other widths and unaligned rows take a warp per row
// and two passes (rmsnorm_bwd_any_kernel), with conflict-free per-warp
// partial rows in shared memory. Either way a number of blocks fixed by the
// shape (bwd_plan below: at most kBwdBlocks = 528, whatever the card)
// writes one row each of a [blocks, d] buffer, and rmsnorm_dw_kernel sums
// it in a fixed order over d / 32 blocks of 512 threads. No atomics: the
// same dx and dw run to run.

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

constexpr int kBwdWarps = 4;  // warps a block of rmsnorm_bwd_rows_kernel
constexpr int kBwdAnySmemBytes = 200 * 1024;  // rmsnorm_bwd_any_kernel's partials
// The backward's blocks at most, each one row of dw partials: a constant, so
// the order of dw's sums depends on the shape alone, not on the card (four
// blocks of kBwdWarps warps for each of an H100's 132 SMs).
constexpr int kBwdBlocks = 528;
constexpr int kDwCols = 32;   // columns a block of rmsnorm_dw_kernel
constexpr int kDwSplit = 16;  // interleaved runs of partial rows it sums apart

// Four weights through the read-only cache, reloaded at every use: the
// compiler may not hoist this load out of the row loop, where the weights of
// a 2,048-wide row (64 a lane) would hold registers beside the lane's dw
// sums and spill.
__device__ __forceinline__ float4 ldg_weights(const float4* p) {
  float4 v;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

// Rows of exactly kV * kLanes * Vec<T>::kN elements with 16-byte-aligned
// bases, as the forward's rmsnorm_kernel: kLanes lanes a row (kG = 32 /
// kLanes rows a warp at once), kV 16-byte vectors of x and of dy a lane,
// and kU such row groups loaded before the first reduction (kU * kV vectors
// of each in flight a lane), so each row is read from device memory once.
// A warp takes rows base + u * kG + g (u < kU, g its lane group) of each
// block of kG * kU rows, blocks grid-strided over the warps in a fixed
// order. Each lane owns the same columns in every row it takes, so it adds
// dy * x * r into registers; at the end the lane groups fold, then the
// block's warps are summed in warp order into one row of `partial`, in
// element-major order (element e of vector v at e * nvec + v: consecutive
// lanes store and read consecutive floats, no bank conflict).
template <typename T, int kV, int kLanes, int kU>
__global__ void __launch_bounds__(32 * kBwdWarps)
    rmsnorm_bwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ w,
                            const T* __restrict__ dy, T* __restrict__ dx,
                            float* __restrict__ partial, int64_t rows, float eps,
                            float plus) {
  constexpr int kN = Vec<T>::kN;
  constexpr int kNvec = kV * kLanes;  // vectors a row
  constexpr int kD = kNvec * kN;
  constexpr int kG = 32 / kLanes;
  constexpr int kR = kG * kU;
  __shared__ float red[kBwdWarps * kD];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane / kLanes;
  const int sub = lane % kLanes;
  const float inv_d = 1.f / static_cast<float>(kD);
  const float4* w4 = reinterpret_cast<const float4*>(w);
  float acc[kV][kN];
#pragma unroll
  for (int i = 0; i < kV; ++i) {
#pragma unroll
    for (int e = 0; e < kN; ++e) acc[i][e] = 0.f;
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kBwdWarps * kR;
  for (int64_t base = (static_cast<int64_t>(blockIdx.x) * kBwdWarps + warp) * kR;
       base < rows; base += stride) {
    uint4 xr[kU][kV], gr[kU][kV];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int64_t row = base + u * kG + g;
      const bool live = row < rows;
      const uint4* xp = reinterpret_cast<const uint4*>(x + (live ? row : 0) * kD);
      const uint4* gp = reinterpret_cast<const uint4*>(dy + (live ? row : 0) * kD);
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        xr[u][i] = live ? __ldg(xp + sub + i * kLanes) : make_uint4(0, 0, 0, 0);
        gr[u][i] = live ? __ldg(gp + sub + i * kLanes) : make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int64_t row = base + u * kG + g;
      float ss = 0.f, dot = 0.f;
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        const T* xv = reinterpret_cast<const T*>(&xr[u][i]);
        const T* gv = reinterpret_cast<const T*>(&gr[u][i]);
        const int vec = sub + i * kLanes;
#pragma unroll
        for (int f = 0; f < kN / 4; ++f) {
          const float4 t = ldg_weights(w4 + vec * (kN / 4) + f);
          const float wv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float xf = to_f32(xv[4 * f + e]);
            ss += xf * xf;
            dot += to_f32(gv[4 * f + e]) * (wv[e] + plus) * xf;
          }
        }
      }
      ss = group_sum<kLanes>(ss);
      dot = group_sum<kLanes>(dot);
      const float r = rsqrtf(ss * inv_d + eps);
      const float c = r * r * r * dot * inv_d;
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        const T* xv = reinterpret_cast<const T*>(&xr[u][i]);
        const T* gv = reinterpret_cast<const T*>(&gr[u][i]);
        const int vec = sub + i * kLanes;
        uint4 res;
        T* o = reinterpret_cast<T*>(&res);
#pragma unroll
        for (int f = 0; f < kN / 4; ++f) {
          const float4 t = ldg_weights(w4 + vec * (kN / 4) + f);
          const float wv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float xf = to_f32(xv[4 * f + e]);
            const float gf = to_f32(gv[4 * f + e]);
            o[4 * f + e] = from_f32<T>(r * (gf * (wv[e] + plus)) - c * xf);
            // a row past the end holds zeros: it adds 0
            acc[i][4 * f + e] += gf * xf * r;
          }
        }
        if (row < rows) reinterpret_cast<uint4*>(dx + row * kD)[vec] = res;
      }
    }
  }
  // the lane groups of a warp hold the same columns: fold them into group 0
#pragma unroll
  for (int off = kLanes; off < 32; off <<= 1) {
#pragma unroll
    for (int i = 0; i < kV; ++i) {
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        acc[i][e] += __shfl_down_sync(0xffffffffu, acc[i][e], off);
      }
    }
  }
  if (g == 0) {
#pragma unroll
    for (int i = 0; i < kV; ++i) {
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        red[warp * kD + e * kNvec + sub + i * kLanes] = acc[i][e];
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < kD; j += blockDim.x) {
    float s = red[j];
#pragma unroll
    for (int k = 1; k < kBwdWarps; ++k) s += red[k * kD + j];
    partial[static_cast<int64_t>(blockIdx.x) * kD + j] = s;
  }
}

// Any width and alignment: a warp per row, two passes over the row (the
// second from cache); each warp adds dy * x * r into its own f32 row of
// partials in shared memory (each lane owns fixed columns, so no atomics),
// element-major where the row is read in 16-byte vectors (nvec = d / kN,
// no bank conflict), as it lies otherwise (nvec = d); the block then sums
// its warps' rows in warp order into one row of `partial`.
template <typename T, bool kVecPath>
__global__ void rmsnorm_bwd_any_kernel(const T* __restrict__ x,
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
  const int nvec = d / kN;
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
          acc[e * nvec + i / kN] += gf * xf * r;
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

// dw from the [blocks, d] partials: a block per kDwCols columns, kDwSplit
// warps; warp k sums partial rows k, k + kDwSplit, ... in order (coalesced
// rows of 32 floats), then one thread a column sums the kDwSplit runs in
// order. Column j of the partials is element (j % nvec) * (d / nvec) +
// j / nvec of the row.
__global__ void __launch_bounds__(kDwCols * kDwSplit)
    rmsnorm_dw_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                      int blocks, int d, int nvec) {
  __shared__ float runs[kDwSplit][kDwCols];
  const int tx = threadIdx.x % kDwCols;
  const int ty = threadIdx.x / kDwCols;
  const int j = blockIdx.x * kDwCols + tx;
  float s = 0.f;
  if (j < d) {
    for (int b = ty; b < blocks; b += kDwSplit) s += partial[static_cast<int64_t>(b) * d + j];
  }
  runs[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && j < d) {
    float t = runs[0][tx];
#pragma unroll
    for (int k = 1; k < kDwSplit; ++k) t += runs[k][tx];
    dw[(j % nvec) * (d / nvec) + j / nvec] = t;
  }
}

template <typename T, int kV, int kLanes, int kU>
int launch_bwd_rows(const T* x, const float* w, const T* dy, T* dx, float* partial,
                    int64_t rows, int blocks, float eps, float plus,
                    cudaStream_t stream) {
  rmsnorm_bwd_rows_kernel<T, kV, kLanes, kU><<<blocks, 32 * kBwdWarps, 0, stream>>>(
      x, w, dy, dx, partial, rows, eps, plus);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kVecPath>
int launch_bwd_any(const T* x, const float* w, const T* dy, T* dx, float* partial,
                   int64_t rows, int d, int warps, int blocks, float eps, float plus,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(warps) * d * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rmsnorm_bwd_any_kernel<T, kVecPath>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  rmsnorm_bwd_any_kernel<T, kVecPath><<<blocks, 32 * warps, smem, stream>>>(
      x, w, dy, dx, partial, rows, d, eps, plus);
  return static_cast<int>(cudaGetLastError());
}

// The register route's instantiations, X(vectors a lane, lanes a row, row
// groups a warp loads at once): the forward's register widths with at most
// 8 vectors a lane, about 8 vectors of x and 8 of dy in flight a lane.
#define RMSNORM_BWD_ROUTES(X) \
  X(1, 16, 8) X(1, 32, 8) X(2, 32, 4) X(3, 32, 2) X(4, 32, 2) X(6, 32, 1) X(8, 32, 1)

// The backward's launch plan: the register route (lanes > 0, `vecs`
// vectors a lane, `unroll` row groups a warp iteration) for 16-byte-aligned
// rows of nvec = d / (16 / element size) vectors that a route above takes,
// else the any-width route with `warps` warps a block; `blocks` partial
// rows of nvec interleaved vectors (nvec = d where the rows are read element
// by element).
struct BwdPlan {
  int lanes, vecs, unroll, warps, blocks, nvec;
};

int bwd_plan(int64_t rows, int d, int element_size, bool aligned, BwdPlan* p) {
  if (rows < 1 || d < 1 || (element_size != 2 && element_size != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n = 16 / element_size;
  *p = BwdPlan{0, 0, 0, 0, 0, aligned && d % n == 0 ? d / n : d};
  if (p->nvec != d) {
#define RMSNORM_BWD_PICK(V, L, U) \
  if (p->lanes == 0 && p->nvec == V * L) *p = BwdPlan{L, V, U, kBwdWarps, 0, p->nvec};
    RMSNORM_BWD_ROUTES(RMSNORM_BWD_PICK)
#undef RMSNORM_BWD_PICK
  }
  int64_t per_block = 0;
  if (p->lanes > 0) {
    per_block = static_cast<int64_t>(kBwdWarps) * (32 / p->lanes) * p->unroll;
  } else {
    const int64_t fit = kBwdAnySmemBytes / (4 * static_cast<int64_t>(d));
    if (fit < 1) return static_cast<int>(cudaErrorInvalidValue);
    p->warps = static_cast<int>(fit < kWarpsPerBlock ? fit : kWarpsPerBlock);
    per_block = p->warps;
  }
  const int64_t need = (rows + per_block - 1) / per_block;
  p->blocks = static_cast<int>(need < kBwdBlocks ? need : kBwdBlocks);
  return 0;
}

template <typename T>
int launch_bwd(const void* xv, const float* w, const void* dyv, void* dxv,
               float* partial, int partial_rows, float* dw, int64_t rows, int d,
               float eps, float plus, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* dy = static_cast<const T*>(dyv);
  T* dx = static_cast<T*>(dxv);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(dx) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0;
  BwdPlan p;
  int err = bwd_plan(rows, d, sizeof(T), aligned, &p);
  if (err != 0) return err;
  if (p.blocks > partial_rows) return static_cast<int>(cudaErrorInvalidValue);
  err = static_cast<int>(cudaErrorInvalidValue);
  if (p.lanes > 0) {
#define RMSNORM_BWD_LAUNCH(V, L, U)                                               \
  if (p.vecs == V && p.lanes == L) {                                             \
    err = launch_bwd_rows<T, V, L, U>(x, w, dy, dx, partial, rows, p.blocks, eps, \
                                      plus, stream);                             \
  }
    RMSNORM_BWD_ROUTES(RMSNORM_BWD_LAUNCH)
#undef RMSNORM_BWD_LAUNCH
  } else if (p.nvec != d) {
    err = launch_bwd_any<T, true>(x, w, dy, dx, partial, rows, d, p.warps, p.blocks,
                                  eps, plus, stream);
  } else {
    err = launch_bwd_any<T, false>(x, w, dy, dx, partial, rows, d, p.warps, p.blocks,
                                   eps, plus, stream);
  }
  if (err != 0) return err;
  rmsnorm_dw_kernel<<<(d + kDwCols - 1) / kDwCols, kDwCols * kDwSplit, 0, stream>>>(
      partial, dw, p.blocks, d, p.nvec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The plan rmsnorm_bwd_launch runs for `rows` rows of width d, bf16 (dtype
// 1) or f32 (dtype 0), with 16-byte-aligned operands or not: out = {lanes,
// vecs, unroll, warps, blocks, nvec, dw's interleaved runs}, what the
// kernels' order of dw sums needs (kernels/ref.py::rmsnorm_bwd_blocked).
// Returns cudaErrorInvalidValue for a width no route takes.
extern "C" int rmsnorm_bwd_plan(int64_t rows, int d, int dtype, int aligned, int* out) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  BwdPlan p;
  const int err = bwd_plan(rows, d, dtype == 1 ? 2 : 4, aligned != 0, &p);
  if (err != 0) return err;
  const int plan[7] = {p.lanes, p.vecs, p.unroll, p.warps, p.blocks, p.nvec, kDwSplit};
  for (int i = 0; i < 7; ++i) out[i] = plan[i];
  return 0;
}

// The most partial rows any plan takes.
extern "C" int rmsnorm_bwd_max_blocks() { return kBwdBlocks; }

// x, dy, dx: [rows, d] contiguous, bf16 (dtype 1) or f32 (dtype 0); w:
// f32[d]; partial: f32[partial_rows, d] scratch, at least the plan's blocks
// (min(rows, rmsnorm_bwd_max_blocks()) always is); dw: f32[d], every entry
// written. The route is bwd_plan's for the operands' alignment. Launches two
// kernels on `stream`; returns cudaGetLastError(), or cudaErrorInvalidValue
// for a shape no route takes.
extern "C" int rmsnorm_bwd_launch(const void* x, const float* w, const void* dy,
                                  void* dx, float* partial, int partial_rows,
                                  float* dw, int64_t rows, int d, float eps,
                                  int plus_one, int dtype, cudaStream_t stream) {
  const float plus = plus_one ? 1.f : 0.f;
  if (dtype == 1) {
    return launch_bwd<__nv_bfloat16>(x, w, dy, dx, partial, partial_rows, dw, rows, d,
                                     eps, plus, stream);
  }
  if (dtype == 0) {
    return launch_bwd<float>(x, w, dy, dx, partial, partial_rows, dw, rows, d, eps,
                             plus, stream);
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
