// frontier_compact: per row, the sorted unique candidates that are not
// SENTINEL and not in that row's visited set, capped at max_out and padded
// with SENTINEL (the next frontier of the batched k-hop BFS: candidates are
// the gathered alters of the current frontier, visited is everything the
// source has reached in earlier hops).
//
// Replaces: src/repro/kernels/frontier.py::frontier_kernel, the Pallas TPU
// kernel that computes a kept mask (first occurrence, not visited) and a
// rank among the kept by all-pairs passes over the candidate row and the
// visited row at 128-lane tiles (O(Kc^2 + Kc*Kv) compares), AND its
// wrapper's scatter that places each kept value at its rank
// (src/repro/kernels/ops.py:159-164). This kernel writes the compacted row
// itself.
//
// Design: one block per row. The candidate row is loaded into dynamic
// shared memory, padded with SENTINEL to the next power of two P (at least
// 32), and sorted there by the bitonic network of row_sort.cuh. A slot is
// kept when it is not SENTINEL, differs from its predecessor, and is not
// found by binary search in the row's visited set. The visited row arrives
// sorted ascending with its SENTINEL pads last (the caller sorts it once
// per hop); it stays in device memory and is read through the read-only
// cache (__ldg). A candidate is never SENTINEL, so visited pads never
// match, and duplicates in the visited row do not disturb the search. A
// block-wide exclusive scan of the keep flags, in rounds of blockDim.x
// slots, gives each kept candidate its rank; out[row, rank] is written for
// rank < max_out, and once max_out candidates are placed the remaining
// rounds (and their searches) are skipped. The tail of the row is filled
// with SENTINEL.
// Capacity: P <= 32768 candidates per row, as segmented_union; wider rows
// are refused here and routed to the plain path by the caller. The visited
// row may have any width.
//
// Bound on this card: memory. The function must read 4*B*(Kc+Kv) bytes and
// write 4*B*max_out bytes, at 3.35 TB/s on an H100 SXM. Each candidate is
// read from device memory once and each output written once; a visited
// row is probed O(log Kv) times per distinct candidate, and those probes
// hit L1/L2 after the first touch. As in segmented_union, the bitonic
// passes in shared memory are what a block spends its time on at wide rows.

#include "row_sort.cuh"

namespace {

using row_sort::kMaxPadded;
using row_sort::kSentinel;

// Is x in the ascending row v[0:n]? (x is never SENTINEL.)
__device__ __forceinline__ bool sorted_contains(const int32_t* __restrict__ v,
                                                int n, int32_t x) {
  int lo = 0;
  int hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(v + mid) < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < n && __ldg(v + lo) == x;
}

__global__ void frontier_kernel(const int32_t* __restrict__ cand,
                                const int32_t* __restrict__ visited,
                                int32_t* __restrict__ out, int kc, int kv,
                                int max_out, int padded) {
  extern __shared__ int32_t smem[];
  int32_t* s = smem;                // padded candidate row
  int* warp_sums = smem + padded;   // scan scratch, 32 ints
  const int64_t row = blockIdx.x;
  const int32_t* vrow = visited + row * kv;
  int32_t* dst = out + row * static_cast<int64_t>(max_out);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  row_sort::load_and_sort(cand + row * kc, kc, s, padded);

  int base = 0;
  for (int r0 = 0; r0 < padded && base < max_out; r0 += nt) {
    const int i = r0 + tid;  // padded is a multiple of nt
    const int32_t x = s[i];
    bool keep = x != kSentinel && (i == 0 || s[i - 1] != x);
    if (keep) keep = !sorted_contains(vrow, kv, x);
    int total;
    const int rank = base + row_sort::block_exclusive_scan(keep ? 1 : 0,
                                                           warp_sums, &total);
    if (keep && rank < max_out) dst[rank] = x;
    base += total;  // the same in every thread, so the loop exits together
  }
  for (int r = base + tid; r < max_out; r += nt) dst[r] = kSentinel;
}

}  // namespace

extern "C" int frontier_max_cand() { return kMaxPadded; }

// cand: int32[rows, kc], visited: int32[rows, kv] (each row sorted
// ascending, SENTINEL last), out: int32[rows, max_out], all contiguous on
// the current device; kc <= frontier_max_cand(), kv >= 0, max_out >= 1.
// Launches on `stream`; returns cudaGetLastError() (or the attribute
// call's error).
extern "C" int frontier_launch(const int32_t* cand, const int32_t* visited,
                               int32_t* out, int64_t rows, int kc, int kv,
                               int max_out, cudaStream_t stream) {
  if (kc > kMaxPadded || kc < 0 || kv < 0 || max_out < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const row_sort::RowLaunch l = row_sort::row_launch(kc);
  const cudaError_t e = row_sort::allow_smem(frontier_kernel, l.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  frontier_kernel<<<static_cast<unsigned>(rows), l.threads, l.smem, stream>>>(
      cand, visited, out, kc, kv, max_out, l.padded);
  return static_cast<int>(cudaGetLastError());
}
