// segmented_union: per row, the sorted unique non-SENTINEL values of an
// unsorted, SENTINEL-padded int32 row, capped at max_out and padded with
// SENTINEL (the pseudo-projection GetNodeAlters dedup of gathered
// co-members, and the cross-layer alters merge); or only their number (the
// filtered degree).
//
// Replaces: src/repro/kernels/segmented_union.py::segmented_union_kernel,
// the Pallas TPU kernel that computes a first-occurrence mask and a rank
// among uniques by all-pairs compares (O(K^2)), AND its wrapper's scatter
// that places each kept value at its rank (src/repro/kernels/ops.py:105-111).
// These kernels write the compacted row (or its count) themselves.
//
// Design, rows of at most row_sort::kMaxItems = 32768 entries
// (segmented_union_kernel): one group of threads per row (a warp for rows
// of up to 992 entries, four rows to a block; a block of 128-1024 threads
// above that), which sorts the row with the block merge sort of
// row_sort.cuh and keeps it in registers. A value is kept when it is not
// SENTINEL and differs from its predecessor; one group-wide exclusive scan
// of the per-thread keep counts gives each kept value its rank; the kept
// values go to shared memory at their ranks (ranks past max_out dropped)
// and from there to out[row, 0:max_out] in coalesced stores, SENTINEL past
// the last. With `count` the number of kept values is written instead of
// (or besides) the row.
//
// Wider rows take three kernels (the wrapper's route in kernels/ops.py):
//   1. segmented_union_kernel on tiles of at most kMaxItems entries of each
//      row, each tile's sorted uniques capped at min(max_out, tile) (the
//      smallest max_out uniques of a row are among the smallest max_out of
//      each of its tiles), written side by side as sorted runs;
//   2. union_merge_kernel, once a level, merges runs 2q and 2q + 1 of each
//      row in device memory: every block takes 2048 outputs of one pair,
//      finds where they start in both runs by a merge-path search in device
//      memory, stages its two input slices in shared memory and merges
//      there, 8 outputs a thread;
//   3. union_compact_kernel streams each row's final sorted run once (one
//      block a row, 8192 entries a round): keep != predecessor, rank by a
//      block scan, write capped at max_out (or count), stopping at the first
//      SENTINEL or once max_out are placed.
// Offsets are 64-bit wherever rows x width can pass 2^31.
//
// Bound on this card: memory. The function must read 4*B*K bytes and
// write 4*B*max_out bytes (4*B with `count` alone), at 3.35 TB/s on an
// H100 SXM. In-block rows are read from device memory once and written
// once; the sort and the ranking stay in registers and shared memory
// (log2(G) merge rounds of two shared-memory passes each). The wide route
// also writes and reads its runs once a merge level.

#include "row_sort.cuh"

namespace {

using row_sort::kMaxItems;
using row_sort::kScratchInts;
using row_sort::kSentinel;
using row_sort::min64;
using row_sort::pad;

template <int G, int ITEMS>
__global__ void __launch_bounds__(row_sort::Shape<G, ITEMS>::kThreads)
segmented_union_kernel(const int32_t* __restrict__ flat,
                       int32_t* __restrict__ out, int32_t* __restrict__ count,
                       int64_t n_tiles, int k, int tile, int tiles,
                       int max_out) {
  using S = row_sort::Shape<G, ITEMS>;
  extern __shared__ int32_t smem[];
  const int grp = threadIdx.x / G;
  const int gt = threadIdx.x % G;
  int32_t* s = smem + grp * (S::kSlots + kScratchInts);
  int* scratch = s + S::kSlots;
  int* tail = scratch + 32;
  const int64_t id = static_cast<int64_t>(blockIdx.x) * S::kRows + grp;
  if (id >= n_tiles) return;  // a whole warp group: blocks of G > 32 hold one
  const int64_t row = id / tiles;
  const int t = static_cast<int>(id - row * tiles);
  const int64_t start = static_cast<int64_t>(t) * tile;
  const int n = static_cast<int>(min64(tile, k - start));

  int32_t keys[ITEMS];
  row_sort::load_row<G, ITEMS>(flat + row * k + start, n, keys, gt);
  row_sort::sort_row<G, ITEMS>(keys, s, gt);
  const int32_t prev = row_sort::prev_key<G, ITEMS>(keys, tail, gt);
  const uint32_t keep = row_sort::distinct_mask(keys, prev, gt == 0);
  int32_t* dst = out == nullptr ? nullptr : out + id * max_out;
  const int total =
      row_sort::emit_row<G, ITEMS>(keys, keep, s, scratch, gt, dst, max_out);
  if (count != nullptr && gt == 0) count[id] = total;
}

constexpr int kMergeThreads = 256;
constexpr int kMergeItems = 8;
constexpr int kMergeTile = kMergeThreads * kMergeItems;

// Number of A entries among the first d outputs of merge(A, B), ties to A.
__device__ __forceinline__ int64_t merge_path(const int32_t* __restrict__ a,
                                              int64_t la,
                                              const int32_t* __restrict__ b,
                                              int64_t lb, int64_t d) {
  int64_t lo = d > lb ? d - lb : 0;
  int64_t hi = d < la ? d : la;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (__ldg(a + mid) <= __ldg(b + d - 1 - mid)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// x, y: int32[rows, n]; each row of x is a sequence of sorted runs of
// `run` entries (the last possibly shorter). y gets runs of 2 * run: run q
// of y is the merge of runs 2q and 2q + 1 of x (2q alone where 2q + 1 is
// past the row). Block b: outputs [c * kMergeTile, ...) of pair q of row r,
// b = (r * pairs + q) * tiles_per_pair + c.
__global__ void __launch_bounds__(kMergeThreads)
union_merge_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ y,
                   int64_t n, int64_t run, int64_t pairs,
                   int64_t tiles_per_pair) {
  __shared__ int32_t s[kMergeTile + kMergeTile / 32];
  __shared__ int64_t split[2];
  const int64_t b = blockIdx.x;
  const int64_t c = b % tiles_per_pair;
  const int64_t pr = b / tiles_per_pair;
  const int64_t row = pr / pairs;
  const int64_t start = (pr - row * pairs) * 2 * run;
  const int64_t la = min64(run, n - start);
  const int64_t lb = n - start > run ? min64(run, n - start - run) : 0;
  const int64_t o0 = c * kMergeTile;
  if (o0 >= la + lb) return;  // the whole block
  const int total = static_cast<int>(min64(kMergeTile, la + lb - o0));
  const int32_t* A = x + row * n + start;
  const int32_t* B = A + la;
  const int tid = threadIdx.x;
  if (tid < 2) split[tid] = merge_path(A, la, B, lb, o0 + (tid ? total : 0));
  __syncthreads();
  const int64_t a0 = split[0];
  const int na = static_cast<int>(split[1] - a0);
  const int64_t b0 = o0 - a0;
  const int nb = total - na;
  for (int i = tid; i < na; i += kMergeThreads) s[pad(i)] = __ldg(A + a0 + i);
  for (int i = tid; i < nb; i += kMergeThreads) s[pad(na + i)] = __ldg(B + b0 + i);
  __syncthreads();

  const int d = tid * kMergeItems;
  int32_t v[kMergeItems];
  if (d < total) {
    int lo = d > nb ? d - nb : 0;
    int hi = d < na ? d : na;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s[pad(mid)] <= s[pad(na + d - 1 - mid)]) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    int ia = lo;
    int ib = d - lo;
    int32_t ak = ia < na ? s[pad(ia)] : kSentinel;
    int32_t bk = ib < nb ? s[pad(na + ib)] : kSentinel;
#pragma unroll
    for (int j = 0; j < kMergeItems; ++j) {
      const bool take_a = ib >= nb || (ia < na && ak <= bk);
      v[j] = take_a ? ak : bk;
      if (take_a) {
        ++ia;
        ak = ia < na ? s[pad(ia)] : kSentinel;
      } else {
        ++ib;
        bk = ib < nb ? s[pad(na + ib)] : kSentinel;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kMergeItems; ++j) {
    if (d + j < total) s[pad(d + j)] = v[j];
  }
  __syncthreads();
  int32_t* dst = y + row * n + start + o0;
  for (int i = tid; i < total; i += kMergeThreads) dst[i] = s[pad(i)];
}

constexpr int kCompactThreads = 1024;
constexpr int kCompactItems = 8;
constexpr int kCompactRound = kCompactThreads * kCompactItems;

// x: int32[rows, n], each row sorted ascending with its SENTINELs last.
// Per row: the distinct non-SENTINEL values to out[row, 0:max_out]
// (SENTINEL past the last; none when out is null) and their number to
// count[row] (when count is not null). One block a row, kCompactRound
// entries a round.
__global__ void __launch_bounds__(kCompactThreads)
union_compact_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                     int32_t* __restrict__ count, int64_t n, int max_out) {
  __shared__ int32_t s[kCompactRound + kCompactRound / 32];
  __shared__ int scratch[32];
  const int64_t row = blockIdx.x;
  const int32_t* src = x + row * n;
  int32_t* dst = out == nullptr ? nullptr : out + row * max_out;
  const int tid = threadIdx.x;
  int base = 0;
  int32_t before = 0;  // the previous round's last entry
  for (int64_t r0 = 0; r0 < n; r0 += kCompactRound) {
    const int len = static_cast<int>(min64(kCompactRound, n - r0));
    for (int i = tid; i < kCompactRound; i += kCompactThreads) {
      s[pad(i)] = i < len ? __ldg(src + r0 + i) : kSentinel;
    }
    __syncthreads();
    int32_t keys[kCompactItems];
#pragma unroll
    for (int j = 0; j < kCompactItems; ++j) {
      keys[j] = s[pad(tid * kCompactItems + j)];
    }
    const int first = tid * kCompactItems;
    const int32_t prev = first > 0 ? s[pad(first - 1)] : before;
    const uint32_t keep =
        row_sort::distinct_mask(keys, prev, first == 0 && r0 == 0);
    const int32_t last = s[pad(len - 1)];
    int total;
    const int rank0 = row_sort::group_exclusive_scan<kCompactThreads>(
        __popc(keep), scratch, &total);  // ends synchronised: s is free
    if (dst != nullptr) {
      int r = rank0;
#pragma unroll
      for (int j = 0; j < kCompactItems; ++j) {
        if ((keep >> j) & 1u) s[r++] = keys[j];
      }
      __syncthreads();
      const int room = max_out - base;
      const int placed = total < room ? total : room;
      for (int i = tid; i < placed; i += kCompactThreads) dst[base + i] = s[i];
      __syncthreads();  // s is reloaded next round
    }
    base += total;
    before = last;
    if (last == kSentinel) break;  // the rest of the row is SENTINEL
    if (count == nullptr && base >= max_out) break;
  }
  if (dst != nullptr) {
    for (int i = min(base, max_out) + tid; i < max_out; i += kCompactThreads) {
      dst[i] = kSentinel;
    }
  }
  if (count != nullptr && tid == 0) count[row] = base;
}

}  // namespace

extern "C" int segmented_union_max_flat() { return kMaxItems; }

// flat: int32[rows, k], cut into tiles = max(1, ceil(k / tile)) tiles of
// `tile` entries (the last may be shorter); out: int32[rows * tiles,
// max_out] or null; count: int32[rows * tiles] or null (at least one of
// them); all contiguous on the current device; 1 <= tile <= kMaxItems,
// max_out >= 1 where out is given. Tile t of row r goes to out row
// r * tiles + t. Launches on `stream`; returns cudaGetLastError() (or the
// attribute call's error).
extern "C" int segmented_union_launch(const int32_t* flat, int32_t* out,
                                      int32_t* count, int64_t rows, int k,
                                      int tile, int max_out,
                                      cudaStream_t stream) {
  if (k < 0 || tile < 1 || tile > kMaxItems || rows < 0 ||
      (out == nullptr && count == nullptr) ||
      (out != nullptr && max_out < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = k > tile ? (k + tile - 1) / tile : 1;
  const int64_t n_tiles = rows * tiles;
  if (n_tiles == 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(row_sort::width_ladder(
      k < tile ? k : tile, [&](auto shape) -> cudaError_t {
        using S = decltype(shape);
        auto kernel = segmented_union_kernel<S::kGroup, S::kItems>;
        const size_t smem =
            S::kRows * (S::kSlots + kScratchInts) * sizeof(int32_t);
        cudaError_t e = row_sort::allow_smem(kernel, smem);
        if (e != cudaSuccess) return e;
        const int64_t blocks = (n_tiles + S::kRows - 1) / S::kRows;
        kernel<<<static_cast<unsigned>(blocks), S::kThreads, smem, stream>>>(
            flat, out, count, n_tiles, k, tile, tiles, max_out);
        return cudaGetLastError();
      }));
}

// x, y: int32[rows, n] contiguous on the current device, x's rows sorted
// runs of `run` entries; y gets sorted runs of 2 * run (union_merge_kernel).
extern "C" int union_merge_launch(const int32_t* x, int32_t* y, int64_t rows,
                                  int64_t n, int64_t run, cudaStream_t stream) {
  if (rows < 0 || n < 0 || run < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t pairs = (n + 2 * run - 1) / (2 * run);
  const int64_t tiles_per_pair = (2 * run + kMergeTile - 1) / kMergeTile;
  const int64_t blocks = rows * pairs * tiles_per_pair;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  union_merge_kernel<<<static_cast<unsigned>(blocks), kMergeThreads, 0,
                       stream>>>(x, y, n, run, pairs, tiles_per_pair);
  return static_cast<int>(cudaGetLastError());
}

// x: int32[rows, n], each row sorted ascending (SENTINEL last); out:
// int32[rows, max_out] or null; count: int32[rows] or null (at least one);
// all contiguous on the current device (union_compact_kernel).
extern "C" int union_compact_launch(const int32_t* x, int32_t* out,
                                    int32_t* count, int64_t rows, int64_t n,
                                    int max_out, cudaStream_t stream) {
  if (rows < 0 || n < 0 || (out == nullptr && count == nullptr) ||
      (out != nullptr && max_out < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return static_cast<int>(cudaSuccess);
  union_compact_kernel<<<static_cast<unsigned>(rows), kCompactThreads, 0,
                         stream>>>(x, out, count, n, max_out);
  return static_cast<int>(cudaGetLastError());
}
