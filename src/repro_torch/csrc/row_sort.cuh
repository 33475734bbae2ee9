// row_sort.cuh: the in-block row sort shared by the row kernels
// (segmented_union.cu, frontier.cu), and the pieces around it: the group
// scan, first-occurrence flags and the compacted write of a sorted row.
//
// A "group" of G threads sorts one int32 row of at most G * ITEMS entries:
// a warp (G = 32, four rows to a block of 128 threads) for rows of up to
// 992 entries, a whole block (G = 128 ... 1024, one row) above that.
// The sort is a block merge sort:
//   1. each thread loads ITEMS entries of the row (coalesced: entry
//      j * G + thread; SENTINEL past the row's end) into registers and
//      sorts them there with Batcher's odd-even merge network, with no
//      barrier;
//   2. log2(G) merge rounds in shared memory: the threads write their
//      sorted runs to one buffer of G * ITEMS ints, and after one barrier
//      each thread finds, by a merge-path binary search, where its ITEMS
//      outputs of the merged pair of runs begin, merges them into its
//      registers and, after a second barrier, writes them back. The first
//      five rounds merge within a warp and need only a warp barrier.
// At 512 threads x 31 keys that is 9 rounds, each one read and one write
// of the row in shared memory plus the searches. ITEMS is odd on every rung but the two that close the ladder to
// powers of two, so a warp's writes (thread t at t * ITEMS + j) fall in
// distinct banks as they are; with an even ITEMS the buffer keeps one
// spare word every 32 (index i at i + i / 32) for the same end.
// After the last round the sorted row stays in registers: thread t holds
// positions [t * ITEMS, (t + 1) * ITEMS), and the buffer is free for the
// caller (frontier.cu stages the visited row in it).
//
// Capacity: kMaxItems = 32768 entries a row (1024 threads x 32 keys; the
// keys live in registers, and 64 registers a thread is what 1024 threads
// may hold; shared memory holds 135 KiB of it). Rows are padded with
// SENTINEL to G * ITEMS of the smallest rung that holds them
// (width_ladder), not to a power of two.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace row_sort {

constexpr int32_t kSentinel = 0x7fffffff;
constexpr int kMaxItems = 32768;
constexpr int kBlockThreads = 128;  // a block of warp groups: 4 rows
constexpr int kScratchInts = 64;    // per group: scan scratch + warp tails

template <int G, int ITEMS>
struct Shape {
  static_assert(G == 32 || (G >= kBlockThreads && G <= 1024 && G % 32 == 0),
                "a group is one warp or one whole block");
  static_assert(ITEMS >= 1 && ITEMS <= 32, "keep flags are one 32-bit mask");
  static constexpr int kGroup = G;
  static constexpr int kItems = ITEMS;
  static constexpr int kWidth = G * ITEMS;                // row capacity
  static constexpr int kSlots = ITEMS % 2 ? kWidth : kWidth + kWidth / 32;
  static constexpr int kRows = G == 32 ? kBlockThreads / 32 : 1;
  static constexpr int kThreads = G * kRows;
};

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// Where the sort keeps entry i: with an even ITEMS a warp's writes (thread
// t at t * ITEMS + j) would share banks, so one word is left free every 32;
// an odd ITEMS spreads them over all banks as it is.
template <int ITEMS>
__device__ __forceinline__ int slot(int i) {
  return ITEMS % 2 ? i : pad(i);
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

template <int G>
__device__ __forceinline__ void group_sync() {
  if constexpr (G == 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// True in every thread of the group when `p` is true in all of them.
template <int G>
__device__ __forceinline__ bool group_all(bool p) {
  if constexpr (G == 32) {
    return __all_sync(0xffffffffu, p);
  } else {
    return __syncthreads_and(p) != 0;
  }
}

// Exclusive scan of one int per thread across the group; `total` gets the
// group's sum. scratch: 32 ints of the group's shared memory (unused by a
// warp group). Ends with the group synchronised.
template <int G>
__device__ __forceinline__ int group_exclusive_scan(int v, int* scratch,
                                                    int* total) {
  const int lane = threadIdx.x & 31;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if constexpr (G == 32) {
    *total = __shfl_sync(0xffffffffu, x, 31);
    __syncwarp();
    return x - v;
  } else {
    constexpr int kWarps = G / 32;
    const int warp = threadIdx.x >> 5;
    if (lane == 31) scratch[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int s = lane < kWarps ? scratch[lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += y;
      }
      if (lane < kWarps) scratch[lane] = s;
    }
    __syncthreads();
    const int prefix = warp > 0 ? scratch[warp - 1] : 0;
    *total = scratch[kWarps - 1];
    __syncthreads();  // scratch is rewritten by the next call
    return prefix + x - v;
  }
}

// Loads src[0:n] into the group's registers, entry j * G + gt into
// keys[j] (coalesced), SENTINEL past n.
template <int G, int ITEMS>
__device__ __forceinline__ void load_row(const int32_t* __restrict__ src,
                                         int n, int32_t (&keys)[ITEMS],
                                         int gt) {
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int i = j * G + gt;
    keys[j] = i < n ? __ldg(src + i) : kSentinel;
  }
}

// Batcher's odd-even merge sort of one thread's keys, in registers: the
// network for the next power of two with every comparator that touches
// an index past N left out (as if those keys were +inf); 186 comparators
// for 31 keys where an odd-even transposition network takes 465. The
// network is spelled out by template recursion, so every index is a
// constant and the keys stay in registers. Merges of runs of P, in passes
// of comparator distance Q: comparator (X, X + Q) is in the pass where
// X - Q % P lies in the lower half of a block of 2Q and both ends lie in
// one block of 2P.
template <int N, int P, int Q, int X>
__device__ __forceinline__ void batcher_pass(int32_t (&k)[N]) {
  if constexpr (X + Q < N) {
    constexpr int R = Q % P;
    if constexpr (X >= R && (X - R) % (2 * Q) < Q &&
                  X / (2 * P) == (X + Q) / (2 * P)) {
      const int32_t lo = min(k[X], k[X + Q]);
      const int32_t hi = max(k[X], k[X + Q]);
      k[X] = lo;
      k[X + Q] = hi;
    }
    batcher_pass<N, P, Q, X + 1>(k);
  }
}

template <int N, int P, int Q>
__device__ __forceinline__ void batcher_merge(int32_t (&k)[N]) {
  batcher_pass<N, P, Q, 0>(k);
  if constexpr (Q > 1) batcher_merge<N, P, Q / 2>(k);
}

template <int N, int P = 1>
__device__ __forceinline__ void thread_sort(int32_t (&k)[N]) {
  if constexpr (P < N) {
    batcher_merge<N, P, P>(k);
    thread_sort<N, 2 * P>(k);
  }
}

// Sorts the group's row: on entry each thread holds any ITEMS of its keys,
// on return thread gt holds sorted positions [gt * ITEMS, (gt + 1) * ITEMS)
// of the row, ascending. s: Shape<G, ITEMS>::kSlots ints of the group's
// shared memory, free again on return (the group is synchronised).
template <int G, int ITEMS>
__device__ __forceinline__ void sort_row(int32_t (&keys)[ITEMS], int32_t* s,
                                         int gt) {
  thread_sort(keys);
  const int base = gt * ITEMS;
#pragma unroll 1
  for (int span = 2; span <= G; span <<= 1) {
    // `span` threads merge two runs of w entries each. While they lie within
    // one warp, the warp reads and writes only its own: a warp barrier is
    // enough
    const int w = (span >> 1) * ITEMS;
    const bool warp_local = span <= 32;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) s[slot<ITEMS>(base + j)] = keys[j];
    if (warp_local) {
      __syncwarp();
    } else {
      group_sync<G>();
    }
    // merge runs A = [a0, a0 + w) and B = [a0 + w, a0 + 2w); this thread
    // owns outputs [d, d + ITEMS) of the merged pair. Ties go to A, in the
    // search and in the merge alike.
    const int first = gt & ~(span - 1);
    const int a0 = first * ITEMS;
    const int b0 = a0 + w;
    const int d = (gt - first) * ITEMS;
    int lo = d > w ? d - w : 0;
    int hi = d < w ? d : w;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s[slot<ITEMS>(a0 + mid)] <= s[slot<ITEMS>(b0 + d - 1 - mid)]) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    int a = lo;
    int b = d - lo;
    int32_t ak = a < w ? s[slot<ITEMS>(a0 + a)] : kSentinel;
    int32_t bk = b < w ? s[slot<ITEMS>(b0 + b)] : kSentinel;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const bool take_a = b >= w || (a < w && ak <= bk);
      keys[j] = take_a ? ak : bk;
      if (take_a) {
        ++a;
        ak = a < w ? s[slot<ITEMS>(a0 + a)] : kSentinel;
      } else {
        ++b;
        bk = b < w ? s[slot<ITEMS>(b0 + b)] : kSentinel;
      }
    }
    if (warp_local) {
      __syncwarp();
    } else {
      group_sync<G>();
    }
  }
}

// The key just before this thread's first one in the group's sorted row
// (meaningless in thread 0). tail: 32 ints of the group's shared memory.
template <int G, int ITEMS>
__device__ __forceinline__ int32_t prev_key(const int32_t (&keys)[ITEMS],
                                            int* tail, int gt) {
  const int lane = gt & 31;
  const int32_t last = keys[ITEMS - 1];
  int32_t p = __shfl_up_sync(0xffffffffu, last, 1);
  if constexpr (G > 32) {
    if (lane == 31) tail[gt >> 5] = last;
    __syncthreads();
    if (lane == 0 && gt > 0) p = tail[(gt >> 5) - 1];
  }
  return p;
}

// Bit j set where keys[j] is not SENTINEL and is the first occurrence of
// its value in the sorted row (`first`: keys[0] opens the row).
template <int ITEMS>
__device__ __forceinline__ uint32_t distinct_mask(const int32_t (&keys)[ITEMS],
                                                  int32_t prev, bool first) {
  uint32_t m = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int32_t p = j == 0 ? prev : keys[j - 1];
    const bool open = j == 0 && first;
    if (keys[j] != kSentinel && (open || keys[j] != p)) m |= 1u << j;
  }
  return m;
}

// Writes the keys flagged in `keep`, in row order, to dst[0:max_out]
// (SENTINEL past the last one placed; nothing when dst is null) and
// returns how many are flagged in the whole group (uncapped). s: at least
// G * ITEMS ints of the group's shared memory, no longer read by any
// thread; scratch: 32 ints.
template <int G, int ITEMS>
__device__ __forceinline__ int emit_row(const int32_t (&keys)[ITEMS],
                                        uint32_t keep, int32_t* s,
                                        int* scratch, int gt,
                                        int32_t* __restrict__ dst,
                                        int max_out) {
  int total;
  const int rank0 = group_exclusive_scan<G>(__popc(keep), scratch, &total);
  if (dst == nullptr) return total;
  int r = rank0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if ((keep >> j) & 1u) {
      if (r < max_out) s[r] = keys[j];
      ++r;
    }
  }
  group_sync<G>();
  const int placed = total < max_out ? total : max_out;
  for (int i = gt; i < max_out; i += G) dst[i] = i < placed ? s[i] : kSentinel;
  return total;
}

// Calls f(Shape<G, ITEMS>{}) for the smallest rung that holds a row of
// `width` entries (width <= kMaxItems). Odd key counts keep the sort's
// buffer unpadded and its writes free of bank conflicts, and were faster
// than even ones with the padded buffer on an H100; the two 32-key rungs
// only close the ladder to powers of two.
template <typename F>
inline cudaError_t width_ladder(int width, F&& f) {
  if (width <= 224) return f(Shape<32, 7>{});
  if (width <= 480) return f(Shape<32, 15>{});
  if (width <= 992) return f(Shape<32, 31>{});
  if (width <= 1920) return f(Shape<128, 15>{});
  if (width <= 3968) return f(Shape<128, 31>{});
  if (width <= 7936) return f(Shape<256, 31>{});
  if (width <= 15872) return f(Shape<512, 31>{});
  if (width <= 16384) return f(Shape<512, 32>{});
  if (width <= 31744) return f(Shape<1024, 31>{});
  return f(Shape<1024, 32>{});
}

// Opts `kernel` into more than the default 48 KiB of dynamic shared memory
// when the launch needs it.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace row_sort
