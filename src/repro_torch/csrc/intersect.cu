// intersect_count: per-row count of the values shared by two sorted,
// SENTINEL-padded int32 rows (the pseudo-projection GetEdgeValue /
// CheckEdge inner loop: shared hyperedges of u and v).
//
// Replaces: src/repro/kernels/intersect.py::intersect_count_kernel, the
// Pallas TPU kernel, which compares every pair of entries on the VPU over
// rows padded to 128 lanes and sums across a k grid.
//
// Design: one warp owns one row pair. Each lane takes a-entries (lanes on
// consecutive addresses), skips SENTINEL pads, and binary-searches the b
// row; a warp shuffle sums the hits and lane 0 writes the count. The b row
// is sorted with SENTINEL last and its real entries are unique (the CSR
// builder dedups), so the binary-search hit count equals the all-pairs
// count bit for bit. Rows of any width are taken as they are: there is no
// 128-lane padding floor, so the narrow 8- and 32-wide buckets run here too.
//
// Bound on this card: memory. The function must read 4*B*(Ka+Kb) bytes and
// write 4*B bytes, at 3.35 TB/s on an H100 SXM; its O(Ka log Kb) integer
// compares per row are far below the card's integer rate. Each a-entry is
// read once, and the b row's probes hit L1/L2 after its first touch, so
// device-memory traffic stays near that one-pass minimum.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kSentinel = 0x7fffffff;
constexpr int kThreads = 256;  // 8 warps, 8 row pairs per block

__global__ void intersect_count_kernel(const int32_t* __restrict__ a,
                                       const int32_t* __restrict__ b,
                                       int32_t* __restrict__ out,
                                       int64_t rows, int ka, int kb) {
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warp leaves together
  const int32_t* arow = a + row * ka;
  const int32_t* brow = b + row * kb;
  int hits = 0;
  for (int i = lane; i < ka; i += 32) {
    const int32_t x = arow[i];
    if (x == kSentinel) continue;
    int lo = 0;
    int hi = kb;
    while (lo < hi) {
      const int mid = lo + ((hi - lo) >> 1);
      if (__ldg(brow + mid) < x) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    hits += (lo < kb && __ldg(brow + lo) == x) ? 1 : 0;
  }
  for (int off = 16; off > 0; off >>= 1) {
    hits += __shfl_down_sync(0xffffffffu, hits, off);
  }
  if (lane == 0) out[row] = hits;
}

}  // namespace

// a: int32[rows, ka], b: int32[rows, kb], out: int32[rows], all contiguous
// on the current device. Launches on `stream`; returns cudaGetLastError().
extern "C" int intersect_count_launch(const int32_t* a, const int32_t* b,
                                      int32_t* out, int64_t rows, int ka,
                                      int kb, cudaStream_t stream) {
  const int64_t blocks = (rows * 32 + kThreads - 1) / kThreads;
  intersect_count_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           stream>>>(a, b, out, rows, ka, kb);
  return static_cast<int>(cudaGetLastError());
}
