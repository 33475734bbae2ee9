// row_sort.cuh: the in-block pieces shared by the row kernels
// (segmented_union.cu, frontier.cu). One block owns one int32 row: the row
// is loaded into dynamic shared memory, padded with SENTINEL to a power of
// two, sorted there by a bitonic network, and compacted by a block-wide
// exclusive scan of per-slot keep flags.
//
// Capacity: a padded row of at most kMaxPadded = 32768 int32 (128 KiB of
// the 227 KiB a block may opt into on an H100), plus 32 ints of scan
// scratch.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace row_sort {

constexpr int32_t kSentinel = 0x7fffffff;
constexpr int kMaxPadded = 32768;

// Exclusive scan of one int per thread across the block; blockDim.x is a
// multiple of 32 and at most 1024. `warp_sums` is 32 ints of shared memory.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums,
                                                    int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nwarps ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < nwarps) warp_sums[lane] = s;
  }
  __syncthreads();
  const int prefix = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[nwarps - 1];
  __syncthreads();  // warp_sums is rewritten by the next call
  return prefix + x - v;
}

// Copies src[0:k] into s[0:padded], SENTINEL past k, then sorts s
// ascending with a bitonic network. Thread t of each pass handles the pair
// (i, i + stride), where i is t with a zero bit inserted at the stride's
// position. Ends with a barrier, so s is ready for every thread.
__device__ __forceinline__ void load_and_sort(const int32_t* __restrict__ src,
                                              int k, int32_t* s, int padded) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int i = tid; i < padded; i += nt) s[i] = i < k ? src[i] : kSentinel;
  __syncthreads();
  const int half = padded >> 1;
  for (int size = 2; size <= padded; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < half; t += nt) {
        const int i = ((t & ~(stride - 1)) << 1) | (t & (stride - 1));
        const int j = i + stride;
        const bool ascending = (i & size) == 0;
        const int32_t x = s[i];
        const int32_t y = s[j];
        if ((x > y) == ascending) {
          s[i] = y;
          s[j] = x;
        }
      }
      __syncthreads();
    }
  }
}

// Launch shape for a row of k entries: the padded width (a power of two,
// at least 32), threads per block (a multiple of 32, at most 1024, and a
// divisor of the padded width) and dynamic shared memory in bytes.
struct RowLaunch {
  int padded;
  int threads;
  size_t smem;
};

inline RowLaunch row_launch(int k) {
  RowLaunch l;
  l.padded = 32;
  while (l.padded < k) l.padded <<= 1;
  l.threads = l.padded / 2;
  if (l.threads < 32) l.threads = 32;
  if (l.threads > 1024) l.threads = 1024;
  l.smem = (static_cast<size_t>(l.padded) + 32) * sizeof(int32_t);
  return l;
}

// Opts `kernel` into more than the default 48 KiB of dynamic shared memory
// when the row needs it.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace row_sort
