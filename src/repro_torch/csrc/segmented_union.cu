// segmented_union: per row, the sorted unique non-SENTINEL values of an
// unsorted, SENTINEL-padded int32 row, capped at max_out and padded with
// SENTINEL (the pseudo-projection GetNodeAlters dedup of gathered
// co-members, and the cross-layer alters merge).
//
// Replaces: src/repro/kernels/segmented_union.py::segmented_union_kernel,
// the Pallas TPU kernel that computes a first-occurrence mask and a rank
// among uniques by all-pairs compares (O(K^2)), AND its wrapper's scatter
// that places each kept value at its rank (src/repro/kernels/ops.py:105-111).
// This kernel writes the compacted row itself.
//
// Design: one block per row. The row is loaded into dynamic shared memory,
// padded with SENTINEL to the next power of two P (at least 32), and sorted
// there with a bitonic network (O(P log^2 P) compares instead of O(K^2));
// the load, the sort and the block scan live in row_sort.cuh, shared with
// frontier.cu. A value is kept when it is not SENTINEL and differs from its
// predecessor; a block-wide exclusive scan of the keep flags, taken in
// rounds of blockDim.x consecutive slots, gives each kept value its rank,
// and out[row, rank] is written for rank < max_out (consecutive ranks, so
// the stores coalesce). The tail of the row is filled with SENTINEL.
// Capacity is what one block's shared memory holds: P <= 32768 int32
// (128 KiB of the 227 KiB a block may opt into); wider rows are refused
// here and routed to the sort path by the caller's dispatch rule.
//
// Bound on this card: memory. The function must read 4*B*K bytes and write
// 4*B*max_out bytes, at 3.35 TB/s on an H100 SXM. Each input value is read
// from device memory once and each output written once; all sorting and
// ranking stays in shared memory. At wide rows the bitonic passes
// (log2(P)*(log2(P)+1)/2 barrier-separated sweeps) are what the block
// spends its time on; that is the first thing a faster version would cut.

#include "row_sort.cuh"

namespace {

using row_sort::kMaxPadded;
using row_sort::kSentinel;

__global__ void segmented_union_kernel(const int32_t* __restrict__ flat,
                                       int32_t* __restrict__ out, int k,
                                       int max_out, int padded) {
  extern __shared__ int32_t smem[];
  int32_t* s = smem;                // padded row
  int* warp_sums = smem + padded;   // scan scratch, 32 ints
  const int64_t row = blockIdx.x;
  int32_t* dst = out + row * static_cast<int64_t>(max_out);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  row_sort::load_and_sort(flat + row * k, k, s, padded);

  // Keep first occurrences, rank them, write the compacted row.
  int base = 0;
  for (int r0 = 0; r0 < padded; r0 += nt) {
    const int i = r0 + tid;  // padded is a multiple of nt
    const int32_t x = s[i];
    const int keep = (x != kSentinel && (i == 0 || s[i - 1] != x)) ? 1 : 0;
    int total;
    const int rank =
        base + row_sort::block_exclusive_scan(keep, warp_sums, &total);
    if (keep && rank < max_out) dst[rank] = x;
    base += total;
  }
  for (int r = base + tid; r < max_out; r += nt) dst[r] = kSentinel;
}

}  // namespace

extern "C" int segmented_union_max_flat() { return kMaxPadded; }

// flat: int32[rows, k], out: int32[rows, max_out], both contiguous on the
// current device; k <= segmented_union_max_flat(), max_out >= 1. Launches
// on `stream`; returns cudaGetLastError() (or the attribute call's error).
extern "C" int segmented_union_launch(const int32_t* flat, int32_t* out,
                                      int64_t rows, int k, int max_out,
                                      cudaStream_t stream) {
  if (k > kMaxPadded || k < 0 || max_out < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const row_sort::RowLaunch l = row_sort::row_launch(k);
  const cudaError_t e = row_sort::allow_smem(segmented_union_kernel, l.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  segmented_union_kernel<<<static_cast<unsigned>(rows), l.threads, l.smem,
                           stream>>>(flat, out, k, max_out, l.padded);
  return static_cast<int>(cudaGetLastError());
}
