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
// Design: one group of threads per row (a warp for candidate rows of up to
// 992 entries, four rows to a block; a block of 128-1024 threads above
// that). The group sorts its candidate row with the block merge sort of
// row_sort.cuh and keeps it in registers, each thread ITEMS ascending
// candidates, with a mask of those that are first occurrences and not
// SENTINEL. The visited row arrives sorted ascending with its SENTINEL
// pads last (the caller sorts it once per hop). It is staged in the
// group's shared memory, the buffer the sort used, in tiles of up to
// 16,384 entries a block (a visited row of 8,193 is one tile), read once
// from device memory in coalesced loads. Against each tile every thread
// walks its run and the tile forward together: one galloping search from
// where the previous candidate
// stopped (the first one is a binary search of the tile), so a thread
// reads O(ITEMS + log Kv) visited entries, not ITEMS * log Kv. A candidate
// found is dropped. A candidate is never SENTINEL, so visited pads never
// match, and duplicates in the visited row do not disturb the walk.
// Between tiles the group stops early once every candidate lies at or
// below the tile's last value, or once max_out candidates at or below it
// are kept (the rest would rank past max_out). One group-wide scan ranks
// the kept candidates; they go to shared memory at their ranks and from
// there to out[row, 0:max_out] in coalesced stores, SENTINEL past the
// last.
// Capacity: row_sort::kMaxItems = 32768 candidates per row, as
// segmented_union; wider rows are refused here and routed to the plain
// path by the caller. The visited row may have any width.
//
// Bound on this card: memory. The function must read 4*B*(Kc+Kv) bytes and
// write 4*B*max_out bytes, at 3.35 TB/s on an H100 SXM. Each candidate and
// each visited entry is read from device memory once, and each output
// written once; the sort, the visited walk and the ranking stay in
// registers and shared memory.

#include "row_sort.cuh"

namespace {

using row_sort::kMaxItems;
using row_sort::kScratchInts;
using row_sort::kSentinel;

// Visited entries a block stages at once, at most (or the sort's buffer,
// where that is larger): the 8,193-wide visited rows of a 4,096-cap hop fit
// one tile.
constexpr int kVisitedTile = 16384;

// First q in [0, n) with v[q] >= x (v ascending), or n.
__device__ __forceinline__ int lower_bound(const int32_t* v, int n, int32_t x) {
  int lo = 0;
  int hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (v[mid] < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// First q in [p, n) with v[q] >= x (v ascending), or n: doubling steps
// from p, then a binary search in the last step.
__device__ __forceinline__ int gallop(const int32_t* v, int n, int p,
                                      int32_t x) {
  int lo = p;
  int hi = p;
  int step = 1;
  while (hi < n && v[hi] < x) {
    lo = hi + 1;
    hi += step;
    step <<= 1;
  }
  if (hi > n) hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (v[mid] < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <int G, int ITEMS>
__global__ void __launch_bounds__(row_sort::Shape<G, ITEMS>::kThreads)
frontier_kernel(const int32_t* __restrict__ cand,
                const int32_t* __restrict__ visited,
                int32_t* __restrict__ out, int64_t rows, int kc, int kv,
                int max_out, int vt) {
  using S = row_sort::Shape<G, ITEMS>;
  extern __shared__ int32_t smem[];
  const int grp = threadIdx.x / G;
  const int gt = threadIdx.x % G;
  int32_t* s = smem + grp * (vt + kScratchInts);  // vt >= S::kSlots
  int* scratch = s + vt;
  int* tail = scratch + 32;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * S::kRows + grp;
  if (row >= rows) return;  // a whole warp group: blocks of G > 32 hold one

  int32_t keys[ITEMS];
  row_sort::load_row<G, ITEMS>(cand + row * kc, kc, keys, gt);
  row_sort::sort_row<G, ITEMS>(keys, s, gt);
  const int32_t prev = row_sort::prev_key<G, ITEMS>(keys, tail, gt);
  uint32_t live = row_sort::distinct_mask(keys, prev, gt == 0);

  const int32_t* vrow = visited + row * kv;
  for (int v0 = 0; v0 < kv; v0 += vt) {
    const int n = kv - v0 < vt ? kv - v0 : vt;
    for (int i = gt; i < n; i += G) s[i] = __ldg(vrow + v0 + i);
    row_sort::group_sync<G>();
    int p = -1;  // no search yet: the first is a binary search of the tile
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      if ((live >> j) & 1u) {
        p = p < 0 ? lower_bound(s, n, keys[j]) : gallop(s, n, p, keys[j]);
        if (p < n && s[p] == keys[j]) live &= ~(1u << j);
      }
    }
    if (v0 + n >= kv) break;  // the last tile: s stays as it is
    const int32_t last = s[n - 1];
    uint32_t below = 0;  // live candidates no later tile can drop
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      if (keys[j] <= last) below |= 1u << j;
    }
    below &= live;
    int kept;
    row_sort::group_exclusive_scan<G>(__popc(below), scratch, &kept);
    // both exits are the same in every thread of the group; group_all
    // also keeps the next tile's loads behind this tile's reads
    if (row_sort::group_all<G>(below == live) || kept >= max_out) break;
  }
  row_sort::emit_row<G, ITEMS>(keys, live, s, scratch, gt,
                               out + row * max_out, max_out);
}

}  // namespace

extern "C" int frontier_max_cand() { return kMaxItems; }

// cand: int32[rows, kc], visited: int32[rows, kv] (each row sorted
// ascending, SENTINEL last), out: int32[rows, max_out], all contiguous on
// the current device; kc <= frontier_max_cand(), kv >= 0, max_out >= 1.
// Launches on `stream`; returns cudaGetLastError() (or the attribute
// call's error).
extern "C" int frontier_launch(const int32_t* cand, const int32_t* visited,
                               int32_t* out, int64_t rows, int kc, int kv,
                               int max_out, cudaStream_t stream) {
  if (kc > kMaxItems || kc < 0 || kv < 0 || max_out < 1 || rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(row_sort::width_ladder(
      kc, [&](auto shape) -> cudaError_t {
        using S = decltype(shape);
        // visited tile: the sort's buffer, widened up to kVisitedTile
        // entries a block where the visited row is wider
        int vt = kVisitedTile / S::kRows;
        if (kv < vt) vt = kv;
        if (vt < S::kSlots) vt = S::kSlots;
        auto kernel = frontier_kernel<S::kGroup, S::kItems>;
        const size_t smem = S::kRows * (vt + kScratchInts) * sizeof(int32_t);
        cudaError_t e = row_sort::allow_smem(kernel, smem);
        if (e != cudaSuccess) return e;
        const int64_t blocks = (rows + S::kRows - 1) / S::kRows;
        kernel<<<static_cast<unsigned>(blocks), S::kThreads, smem, stream>>>(
            cand, visited, out, rows, kc, kv, max_out, vt);
        return cudaGetLastError();
      }));
}
