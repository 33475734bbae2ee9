// The pseudo-projection GetEdgeValue / CheckEdge inner loop (paper Listing
// 1): the number of hyperedges two nodes share. Two entries:
//
// intersect_rows (the query path): for each pair (u[i], v[i]), the count of
// ids shared by the two nodes' effective membership rows, read where they
// lie in the membership CSR and its delta overlay; 0 where v[i] fails the
// node filter.
//
// intersect_count (padded rows): per-row count of the values shared by two
// sorted, SENTINEL-padded int32 rows, the Pallas kernel's own interface.
//
// Replaces: src/repro/kernels/intersect.py::intersect_count_kernel, the
// Pallas TPU kernel, which compares every pair of entries on the VPU over
// rows padded to 128 lanes and sums across a k grid. Pallas needs static,
// 128-lane shapes, so the reference's dispatcher
// (src/repro/core/dispatch.py::bucketed_edge_value) reads degrees on the
// host, buckets the pairs by width, pads each bucket's row count to a power
// of two and gathers every padded row before the kernel runs. A CUDA kernel
// needs none of that: intersect_rows finds each pair's rows in the CSR
// itself, one launch a batch.
//
// intersect_rows, design. One warp takes 32 consecutive pairs, a lane
// each. A lane reads its pair's ids and filter bit and resolves both rows'
// bounds, with the plain path's clip rules (kernels/ref.py,
// core/overlay.py): row r's bounds are indptr[clip(r, 0, n_rows)] and
// indptr[clip(r + 1, 0, n_rows)], so an id outside [0, n_rows) has an
// empty row; with an overlay, dirty[clip(r, 0, n_dirty - 1)] picks the
// delta's row (the delta may have more rows than the base); the filter bit
// is filter[clip(v, 0, n_filter - 1)]. Then:
//  - Pairs whose rows hold at most kBudget (128) entries together are
//    staged: packed in lane order into the warp's 1,280 words of shared
//    memory (an exclusive scan of their lengths gives each its offset; a
//    warp whose staged rows pass 1,280 entries stages them in rounds).
//    The warp copies each pair's a row and b row in chunks of 64 entries,
//    lanes on consecutive addresses, with the loads of 8 chunks issued
//    before their stores, so a lane has up to 16 independent loads in
//    flight. uint16 ids widen to int32 as they land. Each lane then walks
//    its own two rows in one linear merge out of shared memory.
//  - The other pairs (the hub tail, ~1 % of random pairs at 20 memberships
//    a node) are collected by ballot and taken one at a time by the whole
//    warp: the longer row is staged in the warp's shared memory, and the
//    lanes split the shorter row and binary-search each entry in it; a
//    longer row still (past 1,280 entries) is searched where it lies in
//    device memory.
// Random rows are latency-bound reads, so the block is small (4 warps,
// 20 KB of shared memory) and held to 64 registers a thread, so that 8
// blocks, 32 warps, share an SM.
// There is no host planning, padding, gather or second launch.
// Rows are sorted and their real entries unique (the CSR builder dedups),
// so the merge count and the search count both equal the all-pairs count
// bit for bit. The base CSR's indptr is int32 or int64 and its ids uint16
// or int32, and so are the delta's; the kernel is templated on the two
// indptr types and reads the ids at their stored width, so no layer is
// widened or copied.
//
// Bound on this card: memory. For the pairs given the function must read
// each id (4 B each of u and v), the filter byte where there is a filter,
// the dirty bytes where there is an overlay, four indptr entries a kept
// pair (4 or 8 B), each real entry of both rows once (2 or 4 B), and write
// 4 B a pair; at 3.35 TB/s on an H100 SXM. It does no padded slot and no
// all-pairs compare. The rows lie at random in a layer far larger than the
// 50 MB L2, so every indptr read and every row costs whole 32-byte sectors
// from device memory (a 20-entry int32 row spans 3-4 of them), which the
// byte count above does not see; the staging keeps a lane's loads
// independent so that many of these random reads are in flight at once.
//
// intersect_count, design. It must read 4*B*(Ka+Kb) bytes and write 4*B,
// so it is bound by memory, but at the sharded path's widths (1, 4 and 6
// entries a row, 8,192 rows) that is ~0.13 us against a launch of ~0.8 us:
// what a launch costs beyond an empty kernel's is how many dependent trips
// to device memory it makes and how many warps it spreads them over. Two
// routes, chosen by the launcher from the widths:
//  - Narrow rows (Ka, Kb <= kNarrowMax, 32): a group of G lanes a row
//    pair, G = next_pow2(max(Ka, Kb)) (8 at the Schools rows' 6). Lane g
//    of a group loads entry g of its a row and entry g of its b row into
//    registers (SENTINEL past the row's width), so a warp's loads cover
//    32 / G consecutive rows of each operand, coalesced, and all of them
//    are in flight at once. The group's b entries, one a lane, form a
//    sorted array of G: each lane finds its a entry's lower bound in it
//    with a branchless binary search of log2(G) shuffles, one more
//    shuffle reads the entry there, and log2(G) xor-shuffles sum the
//    group's hits. One trip to device memory and at most 11 dependent
//    shuffles; no shared memory and no dependent global load. A block of
//    kLaneThreads lanes takes kLaneThreads / G pairs, so 8,192 pairs at
//    G = 8 are 128 blocks, one wave. (A thread a pair merging both rows
//    out of shared memory was measured first: its merge is a chain of
//    dependent shared-memory loads, 64 steps at 32 entries a row, and it
//    took 1.7x the warp route there.)
//  - Wider rows (the Panel recipe's rows reach 512): one warp owns one row
//    pair. Each lane takes a-entries (lanes on consecutive addresses),
//    skips SENTINEL pads, and binary-searches the b row; a warp shuffle
//    sums the hits and lane 0 writes the count.
// Both count each real entry of a found in b once: the rows are sorted and
// their real entries unique, so the counts equal the all-pairs count bit
// for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// intersect_count: SENTINEL-padded rows
// ---------------------------------------------------------------------------

constexpr int32_t kSentinel = 0x7fffffff;
constexpr int kThreads = 256;  // wide route: 8 warps, 8 row pairs per block
constexpr int kNarrowMax = 32;  // widest row the narrow route takes
constexpr int kLaneThreads = 512;  // narrow route: lanes a block
static_assert(kLaneThreads % 32 == 0, "the narrow route's blocks are whole warps");

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
    hits += __shfl_down_sync(kFull, hits, off);
  }
  if (lane == 0) out[row] = hits;
}

// A group of 1 << lg lanes a row pair (see the design note above).
__global__ void __launch_bounds__(kLaneThreads)
    intersect_count_kernel_lanes(const int32_t* __restrict__ a,
                                 const int32_t* __restrict__ b,
                                 int32_t* __restrict__ out, int64_t rows,
                                 int ka, int kb, int lg) {
  const int width = 1 << lg;
  const int g = threadIdx.x & (width - 1);
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * kLaneThreads + threadIdx.x) >> lg;
  const bool live = row < rows;  // every lane stays for the shuffles
  const int32_t x = live && g < ka ? __ldg(a + row * ka + g) : kSentinel;
  const int32_t y = live && g < kb ? __ldg(b + row * kb + g) : kSentinel;
  int pos = 0;  // lower bound of x among the group's y, clamped to width-1
  for (int step = width >> 1; step > 0; step >>= 1) {
    const int32_t v = __shfl_sync(kFull, y, pos + step - 1, width);
    pos += v < x ? step : 0;
  }
  const int32_t at = __shfl_sync(kFull, y, pos, width);
  int hits = x != kSentinel && at == x ? 1 : 0;
  for (int off = width >> 1; off > 0; off >>= 1) {
    hits += __shfl_xor_sync(kFull, hits, off, width);
  }
  if (live && g == 0) out[row] = hits;
}

// ---------------------------------------------------------------------------
// intersect_rows: effective membership rows read in place
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;        // warps a block, 32 pairs each
constexpr int kBlocksPerSm = 8;  // 32 warps an SM: at most 64 registers
constexpr int kBudget = 128;     // entries of both rows a lane merges, at most
constexpr int kWarpBuf = 1280;   // a warp's shared words
constexpr int kChunk = 64;       // entries of a pair a group step loads
constexpr int kGroup = 8;        // group steps whose loads go out together
constexpr int kUnroll = 8;       // loads a lane issues per row pass

// One CSR's buffers: indptr (P = int32_t or int64_t) and ids at their
// stored width (wide: int32, else uint16).
template <typename P>
struct Csr {
  const P* indptr;
  const char* ids;
  int wide;
  int64_t n_rows;
};

template <typename B, typename D>
struct RowsArgs {
  Csr<B> base;
  Csr<D> delta;
  const uint8_t* dirty;  // null: no overlay
  int64_t n_dirty;
  const int32_t* u;
  const int32_t* v;
  const uint8_t* filter;  // null: no filter
  int64_t n_filter;
  int32_t* out;
  int64_t pairs;
};

// A row: its first id's address, its id width and its length.
struct Row {
  const char* p;
  int wide;
  int len;
};

__device__ __forceinline__ int64_t clip(int64_t x, int64_t hi) {
  return x < 0 ? 0 : (x > hi ? hi : x);
}

__device__ __forceinline__ int32_t id_at(const char* p, int wide, int k) {
  return wide ? __ldg(reinterpret_cast<const int32_t*>(p) + k)
              : static_cast<int32_t>(
                    __ldg(reinterpret_cast<const uint16_t*>(p) + k));
}

__device__ __forceinline__ int64_t offset_at(const int32_t* p, int64_t i) {
  return __ldg(p + i);
}

__device__ __forceinline__ int64_t offset_at(const int64_t* p, int64_t i) {
  return __ldg(reinterpret_cast<const long long*>(p) + i);
}

template <typename P>
__device__ __forceinline__ Row csr_row(const Csr<P>& c, int64_t r) {
  const int64_t lo = offset_at(c.indptr, clip(r, c.n_rows));
  const int64_t hi = offset_at(c.indptr, clip(r + 1, c.n_rows));
  Row row;
  row.wide = c.wide;
  row.p = c.ids + lo * (c.wide ? 4 : 2);
  row.len = hi > lo ? static_cast<int>(hi - lo) : 0;
  return row;
}

template <typename B, typename D>
__device__ __forceinline__ Row eff_row(const RowsArgs<B, D>& g, int32_t id) {
  const int64_t r = id;
  if (g.dirty != nullptr && __ldg(g.dirty + clip(r, g.n_dirty - 1)) != 0) {
    return csr_row(g.delta, r);
  }
  return csr_row(g.base, r);
}

__device__ __forceinline__ Row shfl_row(const Row& row, int src) {
  Row out;
  out.p = reinterpret_cast<const char*>(__shfl_sync(
      kFull, reinterpret_cast<unsigned long long>(row.p), src));
  out.wide = __shfl_sync(kFull, row.wide, src);
  out.len = __shfl_sync(kFull, row.len, src);
  return out;
}

// The warp copies row into dst[0, row.len), lanes on consecutive
// addresses, kUnroll loads a lane in flight.
__device__ __forceinline__ void stage_row(int32_t* dst, const Row& row,
                                          int lane) {
  for (int base = 0; base < row.len; base += 32 * kUnroll) {
    int32_t x[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int i = base + 32 * k + lane;
      x[k] = i < row.len ? id_at(row.p, row.wide, i) : 0;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int i = base + 32 * k + lane;
      if (i < row.len) dst[i] = x[k];
    }
  }
}

// Is x in the ascending row s[0, n)?
__device__ __forceinline__ bool found_in(const int32_t* s, int n, int32_t x) {
  int lo = 0;
  int hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < n && s[lo] == x;
}

__device__ __forceinline__ bool found_in(const Row& row, int32_t x) {
  int lo = 0;
  int hi = row.len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (id_at(row.p, row.wide, mid) < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < row.len && id_at(row.p, row.wide, lo) == x;
}

template <typename B, typename D>
__global__ void __launch_bounds__(kWarps * 32, kBlocksPerSm)
    intersect_rows_kernel(const RowsArgs<B, D> g) {
  __shared__ int32_t stage[kWarps][kWarpBuf];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int32_t* buf = stage[warp];
  const int64_t pair =
      (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * 32 + lane;
  const bool live = pair < g.pairs;

  Row a = {nullptr, 1, 0};
  Row b = {nullptr, 1, 0};
  if (live) {
    const int32_t v = __ldg(g.v + pair);
    const bool keep =
        g.filter == nullptr ||
        __ldg(g.filter + clip(static_cast<int64_t>(v), g.n_filter - 1)) != 0;
    if (keep) {
      a = eff_row(g, __ldg(g.u + pair));
      b = eff_row(g, v);
    }
  }
  const bool work = a.len > 0 && b.len > 0;
  const bool staged = work && a.len + b.len <= kBudget;
  int hits = 0;

  // Staged pairs pack into the warp's buffer in lane order: a pair's a row
  // then its b row at off (an exclusive scan of the staged lengths).
  const int n = staged ? a.len + b.len : 0;
  int off = n;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, off, d);
    if (lane >= d) off += y;
  }
  off -= n;

  // Rounds: each takes the pending pairs that fit the buffer from the
  // first pending one on (one round, unless the staged rows of the 32 pairs
  // pass kWarpBuf entries).
  unsigned pending = __ballot_sync(kFull, staged);
  while (pending != 0) {
    const int first = __shfl_sync(kFull, off, __ffs(pending) - 1);
    const bool take = ((pending >> lane) & 1) && off - first + n <= kWarpBuf;
    const unsigned round = __ballot_sync(kFull, take);
    pending &= ~round;

    // 1. Stage: the round's pairs in chunks of kChunk entries, the loads of
    // kGroup chunks issued before their stores.
    unsigned todo = round;
    int chunk = 0;  // next chunk of the lowest pair in todo
    while (todo != 0) {
      int32_t x[kGroup][kChunk / 32];
      int at[kGroup];   // where the chunk's first entry goes in buf
      int left[kGroup];  // entries of the pair from the chunk's first on
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        const int j = todo != 0 ? __ffs(todo) - 1 : 0;
        const Row ra = shfl_row(a, j);
        const Row rb = shfl_row(b, j);
        const int start = chunk * kChunk;
        at[q] = __shfl_sync(kFull, off, j) - first + start;
        left[q] = todo != 0 ? ra.len + rb.len - start : 0;
        if (left[q] > kChunk) {
          ++chunk;
        } else {
          chunk = 0;
          todo &= todo - 1;  // 0 stays 0
        }
#pragma unroll
        for (int h = 0; h < kChunk / 32; ++h) {
          const int i = start + lane + 32 * h;
          x[q][h] = lane + 32 * h >= left[q] ? 0
                    : i < ra.len ? id_at(ra.p, ra.wide, i)
                                 : id_at(rb.p, rb.wide, i - ra.len);
        }
      }
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
#pragma unroll
        for (int h = 0; h < kChunk / 32; ++h) {
          if (lane + 32 * h < left[q]) buf[at[q] + lane + 32 * h] = x[q][h];
        }
      }
    }
    __syncwarp();

    // 2. Each lane of the round merges its two rows.
    if (take) {
      const int32_t* ra = buf + off - first;
      const int32_t* rb = ra + a.len;
      int i = 0;
      int k = 0;
      while (i < a.len && k < b.len) {
        const int32_t x = ra[i];
        const int32_t y = rb[k];
        hits += x == y ? 1 : 0;
        i += x <= y ? 1 : 0;
        k += y <= x ? 1 : 0;
      }
    }
    __syncwarp();
  }

  // 3. The hub tail, one pair at a time by the whole warp.
  unsigned hubs = __ballot_sync(kFull, work && !staged);
  while (hubs != 0) {
    const int j = __ffs(hubs) - 1;
    hubs &= hubs - 1;
    Row s = shfl_row(a, j);
    Row l = shfl_row(b, j);
    if (s.len > l.len) {
      const Row t = s;
      s = l;
      l = t;
    }
    int c = 0;
    __syncwarp();  // the merges, or the last hub pair, are done with buf
    if (l.len <= kWarpBuf) {
      stage_row(buf, l, lane);
      __syncwarp();
      for (int i = lane; i < s.len; i += 32) {
        c += found_in(buf, l.len, id_at(s.p, s.wide, i)) ? 1 : 0;
      }
    } else {
      for (int i = lane; i < s.len; i += 32) {
        c += found_in(l, id_at(s.p, s.wide, i)) ? 1 : 0;
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      c += __shfl_xor_sync(kFull, c, d);
    }
    if (lane == j) hits = c;
  }
  if (live) g.out[pair] = hits;
}

template <typename P>
Csr<P> make_csr(const void* indptr, const void* ids, int wide,
                int64_t n_rows) {
  return Csr<P>{static_cast<const P*>(indptr), static_cast<const char*>(ids),
                wide, n_rows};
}

template <typename B, typename D>
int launch_rows(const void* indptr, const void* ids, int wide, int64_t n_rows,
                const uint8_t* dirty, int64_t n_dirty, const void* d_indptr,
                const void* d_ids, int d_wide, int64_t d_rows,
                const int32_t* u, const int32_t* v, const uint8_t* filter,
                int64_t n_filter, int32_t* out, int64_t pairs,
                cudaStream_t stream) {
  const RowsArgs<B, D> g{make_csr<B>(indptr, ids, wide, n_rows),
                         make_csr<D>(d_indptr, d_ids, d_wide, d_rows),
                         dirty, n_dirty, u, v, filter, n_filter, out, pairs};
  const int64_t per_block = 32 * kWarps;
  const int64_t blocks = (pairs + per_block - 1) / per_block;
  intersect_rows_kernel<B, D>
      <<<static_cast<unsigned>(blocks), kWarps * 32, 0, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a: int32[rows, ka], b: int32[rows, kb], out: int32[rows], all contiguous
// on the current device. Launches on `stream`; returns cudaGetLastError().
// Rows of at most kNarrowMax entries (both operands) take the narrow
// route, wider ones the warp-a-pair route.
extern "C" int intersect_count_launch(const int32_t* a, const int32_t* b,
                                      int32_t* out, int64_t rows, int ka,
                                      int kb, cudaStream_t stream) {
  if (rows < 0 || ka < 0 || kb < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return static_cast<int>(cudaSuccess);
  if (ka <= kNarrowMax && kb <= kNarrowMax) {
    int lg = 0;
    while ((1 << lg) < ka || (1 << lg) < kb) ++lg;
    const int64_t per_block = kLaneThreads >> lg;
    const int64_t blocks = (rows + per_block - 1) / per_block;
    intersect_count_kernel_lanes<<<static_cast<unsigned>(blocks),
                                   kLaneThreads, 0, stream>>>(a, b, out, rows,
                                                              ka, kb, lg);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t blocks = (rows * 32 + kThreads - 1) / kThreads;
  intersect_count_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           stream>>>(a, b, out, rows, ka, kb);
  return static_cast<int>(cudaGetLastError());
}

// The base membership CSR: indptr (int64 if indptr64, else int32) of
// n_rows + 1 entries and ids (int32 if wide, else uint16). dirty: bool of
// n_dirty >= 1 entries, or null for no overlay; then the delta CSR
// (d_indptr of d_rows + 1 entries, d_ids) as the base. u, v: int32[pairs];
// filter: bool of n_filter >= 1 entries, or null; out: int32[pairs]. All on
// the current device. Launches on `stream`; returns cudaGetLastError().
extern "C" int intersect_rows_launch(
    const void* indptr, int indptr64, const void* ids, int wide,
    int64_t n_rows, const uint8_t* dirty, int64_t n_dirty,
    const void* d_indptr, int d_indptr64, const void* d_ids, int d_wide,
    int64_t d_rows, const int32_t* u, const int32_t* v, const uint8_t* filter,
    int64_t n_filter, int32_t* out, int64_t pairs, cudaStream_t stream) {
  if (n_rows < 0 || pairs < 0 ||
      (dirty != nullptr && (n_dirty < 1 || d_rows < 0)) ||
      (filter != nullptr && n_filter < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (pairs == 0) return static_cast<int>(cudaSuccess);
  if (indptr64) {
    if (d_indptr64) {
      return launch_rows<int64_t, int64_t>(
          indptr, ids, wide, n_rows, dirty, n_dirty, d_indptr, d_ids, d_wide,
          d_rows, u, v, filter, n_filter, out, pairs, stream);
    }
    return launch_rows<int64_t, int32_t>(
        indptr, ids, wide, n_rows, dirty, n_dirty, d_indptr, d_ids, d_wide,
        d_rows, u, v, filter, n_filter, out, pairs, stream);
  }
  if (d_indptr64) {
    return launch_rows<int32_t, int64_t>(
        indptr, ids, wide, n_rows, dirty, n_dirty, d_indptr, d_ids, d_wide,
        d_rows, u, v, filter, n_filter, out, pairs, stream);
  }
  return launch_rows<int32_t, int32_t>(
      indptr, ids, wide, n_rows, dirty, n_dirty, d_indptr, d_ids, d_wide,
      d_rows, u, v, filter, n_filter, out, pairs, stream);
}
