// Threefry-2x32 random draws that equal jax.random's bit for bit (JAX's
// partitionable scheme), for the port's sampling path. Three entries:
//
// threefry_bits: element i of jax.random.bits(key, (n,)): the two output
// words of the hash of counter (i >> 32, i & 0xFFFFFFFF) under the key,
// xored.
//
// randint: element i of jax.random.randint over int32: the bits of
// element i under both subkeys of split(key) (the host derives them), and
// _randint's reduction: span = uint32(hi - lo), 1 where hi <= lo;
// multiplier = (2^16 mod span)^2 mod span; offset = ((hb mod span) *
// multiplier + lb mod span) mod span; lo + offset. Every product and sum
// wraps mod 2^32 as JAX's uint32 arithmetic does (so the square 2^16 * 2^16
// is 0 and the multiplier is 0 for any span above 2^16). lo and hi are scalars
// or per-element int32 arrays.
//
// csr_row_sample: the whole of core/csr.py::csr_row_sample, and with a
// delta overlay core/overlay.py::eff_row_sample, in one launch: row r's
// bounds are indptr[clip(r, 0, n_rows)] and indptr[clip(r + 1, 0,
// n_rows)] (dirty[clip(r, 0, n_dirty - 1)] takes them from the delta CSR
// instead; both branches of the reference draw with the same key, so
// drawing only for the branch taken gives the same result), the draw is
// randint with span max(length, 1), the sampled column is read at its
// stored width (uint16 or int32) and widened, and an empty row gives r
// itself with valid = false. indptr is int32 or int64, read as stored, as
// intersect_rows reads it.
//
// Not a port of a TPU kernel: on the TPU, XLA fuses jax.random's
// threefry2x32 primitive by itself. In eager torch the hash is about 160
// element-wise ops and a row sample about 330, so the port draws in these
// kernels instead of composing torch ops.
//
// Bound on this card. threefry_bits: the output (4 B an element) and the
// hash's integer instructions, whichever takes longer. A hash compiles to
// no fewer than 68 of them where the counter's high word is 0 (every
// element below 2^32): 20 rounds of an add, a funnel-shift rotate and an
// xor (60), the key add to the low word before the rounds (x0 starts at
// the key word itself), five injections that each add one word to x1
// and, but for the last, fold their x0 word into the next round's add (a
// three-input IADD3), the last x0 add, and the xor of the output words;
// above 2^32 the high word's key add makes 69. The card issues 4 warp
// instructions a clock on each SM, 128 lanes; that is the bound. No one
// pipe takes them all, though: the integer ALU pipe (IADD3, LOP3, SHF,
// compares) and the FMA pipe (IMAD in every form) take 64 lanes a clock
// each, and the 20 rotates, 20 round xors and the output xor (41) have
// only the ALU pipe. Left to itself ptxas puts 19 of the adds on the FMA
// pipe (IMAD.IADD) and the rest beside the rotates: 58 ALU-pipe
// instructions an element with one element a thread. So a launch that
// gives every SM a whole block of four-element threads takes four
// elements a thread, their four hash chains interleaved, and adds through
// FmaAdd, a multiply-add by a launch argument that holds 1: every add an
// IMAD, ~43 ALU-pipe instructions an element left (the 41 and the loop);
// with 32-bit indices the counter's high word is 0 and its key add folds
// away; the four leave in one 16-byte store; a block for every group of
// threads (one resident wave that strides measured 5 % slower). Rotating
// on the FMA pipe instead (the halves of x * 2^r by IMAD.WIDE.U32 or'ed
// in the xor's LOP3) measured slower for every share of the rotates
// tried, so each rotate stays one SHF (PERF.md §6). A smaller launch
// takes one element a thread. randint: the hashes a draw needs plus the
// reduction, the output and any per-element bounds. With scalar bounds
// the host computes span, multiplier and reciprocal once, so the card
// divides nothing; where the multiplier is 0 (a span above 2^16 or one
// that divides 2^16, such as the mean-degree estimator's 10M, and a span
// of 1) the high word's bits drop out of the offset and a draw takes one
// hash; two hashes of a draw run in one thread, interleaved.
// Per-element bounds: one division a draw, for the reciprocal that its
// five remainders share.
// csr_row_sample: memory, and random reads: it must read each row id
// (4 B), two indptr entries a row (4 or 8 B each), the dirty byte with an
// overlay, one stored id of each non-empty row (2 or 4 B), and write the
// sample (4 B) and the valid byte. The indptr entries and the sampled id
// lie at random in a layer far larger than the L2, so each costs a whole
// 32-byte sector; a thread issues its two indptr loads together, then
// the hashes (which do not depend on them) overlap the loads' latency.
// What holds it is the card's rate of random reads, not a thread's
// latency: on an H100 a launch at 409,600 rows takes 1.4 times a plain
// random gather of as many int32 (torch.take) and less than two
// dependent ones, and a redesign with 1, 4 or 8 rows a thread (every
// load of a link of the chain issued before any is consumed), one
// resident wave, the widths as template arguments and one reciprocal for
// the five remainders, with or without streaming loads, measured within
// 7 % of this kernel either way (benchmarks/torch_draw_bwd_ab.py,
// PERF.md), so it stays one row a thread on the draw kernels' hash,
// reduction and grid.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr uint32_t kParity = 0x1BD11BDAu;
// the draw kernels: elements a thread of a launch that gives every SM a
// whole block of such threads (one 16-byte store; smaller launches take
// one element a thread), the largest block, the blocks of it each SM
// holds at once (__launch_bounds__), and the most blocks a launch has for
// each SM before its threads stride
constexpr int kPerThread = 4;
constexpr int kDrawThreads = 256;
constexpr int kBitsBlocksPerSm = 8;
constexpr int kRandintBlocksPerSm = 4;
constexpr int kMaxBlocksPerSm = 64;
// element counts up to this take 32-bit indices and a counter whose high
// word is 0
constexpr int64_t kNarrow = int64_t{1} << 31;

// The rotation of round r (0-3) of the four-round block i.
__host__ __device__ constexpr int rotation(int i, int r) {
  return (i & 1) ? (r == 0 ? 17 : r == 1 ? 29 : r == 2 ? 16 : 24)
                 : (r == 0 ? 13 : r == 1 ? 15 : r == 2 ? 26 : 6);
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// a + b as a * one + b, with `one` a launch argument that holds 1: ptxas
// cannot fold it, so the add is an IMAD, on the FMA pipe.
struct FmaAdd {
  uint32_t one;
  __device__ __forceinline__ uint32_t operator()(uint32_t a, uint32_t b) const {
    return a * one + b;
  }
};

// threefry-2x32's 20 rounds and 5 key injections on N counters (x0[j],
// x1[j]) that already hold the first key add, interleaved round by round;
// chains j < M take key schedule ka, the others kb.
template <int N, int M, class Add>
__device__ __forceinline__ void rounds(const uint32_t (&ka)[3], const uint32_t (&kb)[3],
                                       uint32_t (&x0)[N], uint32_t (&x1)[N], Add add) {
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        x0[j] = add(x0[j], x1[j]);
        x1[j] = rotl(x1[j], rotation(i, r)) ^ x0[j];
      }
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const uint32_t* ks = j < M ? ka : kb;
      x0[j] = add(x0[j], ks[(i + 1) % 3]);
      x1[j] = add(x1[j], ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1));
    }
  }
}

__device__ __forceinline__ void schedule(uint32_t k0, uint32_t k1, uint32_t (&ks)[3]) {
  ks[0] = k0;
  ks[1] = k1;
  ks[2] = k0 ^ k1 ^ kParity;
}

// The high counter word of elements i .. i + P - 1 (i a multiple of P, so
// they share it): 0 with 32-bit indices.
template <typename Idx>
__device__ __forceinline__ uint32_t high_word(Idx i) {
  return sizeof(Idx) > 4 ? static_cast<uint32_t>(static_cast<uint64_t>(i) >> 32) : 0u;
}

// The bits of the P elements from i under key schedule ka into a[], and
// with two keys (K == 2) under kb into b[] as well, every chain
// interleaved with the others.
template <int P, int K, typename Idx>
__device__ __forceinline__ void bits_group(const uint32_t (&ka)[3], const uint32_t (&kb)[3],
                                           Idx i, FmaAdd add, uint32_t (&a)[P],
                                           uint32_t (&b)[P]) {
  constexpr int N = K * P;
  const uint32_t hi = high_word(i), lo = static_cast<uint32_t>(i);
  uint32_t x0[N], x1[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const uint32_t* ks = j < P ? ka : kb;
    x0[j] = add(hi, ks[0]);
    x1[j] = add(lo, ks[1] + static_cast<uint32_t>(j % P));
  }
  rounds<N, P>(ka, kb, x0, x1, add);
#pragma unroll
  for (int j = 0; j < P; ++j) {
    a[j] = x0[j] ^ x1[j];
    if constexpr (K == 2) b[j] = x0[j + P] ^ x1[j + P];
  }
}

// Elements i .. i + P - 1 of out: with P = 4 one 16-byte store where all
// lie below n, else those that do one by one (the tail).
template <int P, typename Idx>
__device__ __forceinline__ void store_group(uint32_t* out, Idx i, Idx n,
                                            const uint32_t (&v)[P]) {
  if constexpr (P == 4) {
    if (i + P <= n) {
      *reinterpret_cast<uint4*>(out + i) = make_uint4(v[0], v[1], v[2], v[3]);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < P; ++j) {
    if (i + j < n) out[i + j] = v[j];
  }
}

// A bound of the P elements from i: the scalar s where p is null, else
// p's entries (with P = 4 one 16-byte load where p is aligned and all lie
// below n; elements past n read nothing).
template <int P, typename Idx>
__device__ __forceinline__ void load_group(const int32_t* p, int32_t s, Idx i, Idx n,
                                           int32_t (&v)[P]) {
  if (p == nullptr) {
#pragma unroll
    for (int j = 0; j < P; ++j) v[j] = s;
    return;
  }
  if constexpr (P == 4) {
    if (i + P <= n && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(p + i));
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < P; ++j) v[j] = i + j < n ? __ldg(p + i + j) : 0;
}

// x mod d, given recip = floor((2^32 - 1) / d), d >= 1: the quotient
// estimate umulhi(x, recip) is q or q - 1, so x - estimate * d lies in
// [0, 2d) and below 2^32, and one conditional subtraction of d ends it
// (r - d wraps above r where r < d).
__device__ __forceinline__ uint32_t mod_by(uint32_t x, uint32_t d, uint32_t recip) {
  const uint32_t r = x - __umulhi(x, recip) * d;
  return min(r, r - d);
}

struct Subkeys {
  uint32_t a0, a1, b0, b1;  // split(key): the high bits' and low bits' keys
};

__host__ __device__ __forceinline__ uint32_t span_of(int32_t lo, int32_t hi) {
  return hi <= lo ? 1u
                  : static_cast<uint32_t>(hi) - static_cast<uint32_t>(lo);
}

// _randint's offset in [0, span) from the high and low bits' words hb,
// lb, given the multiplier and recip = floor((2^32 - 1) / span).
__device__ __forceinline__ uint32_t reduce(uint32_t hb, uint32_t lb, uint32_t span,
                                           uint32_t mult, uint32_t recip, FmaAdd add) {
  return mod_by(add(mod_by(hb, span, recip) * mult, mod_by(lb, span, recip)), span, recip);
}

// The same where the span differs draw by draw: one division, for the
// reciprocal that the multiplier's and the offset's remainders share.
__device__ __forceinline__ uint32_t offset(uint32_t hb, uint32_t lb, uint32_t span,
                                           FmaAdd add) {
  const uint32_t recip = 0xFFFFFFFFu / span;
  const uint32_t m = mod_by(65536u, span, recip);
  return reduce(hb, lb, span, mod_by(m * m, span, recip), recip, add);
}

// The first element of this thread's first group of P, and the grid's
// stride between its groups.
template <int P, typename Idx>
__device__ __forceinline__ Idx first_group() {
  return (static_cast<Idx>(blockIdx.x) * blockDim.x + threadIdx.x) * P;
}
template <int P, typename Idx>
__device__ __forceinline__ Idx group_stride() {
  return static_cast<Idx>(gridDim.x) * blockDim.x * P;
}

template <int P, typename Idx>
__global__ void __launch_bounds__(kDrawThreads, kBitsBlocksPerSm)
threefry_bits_kernel(uint32_t k0, uint32_t k1, uint32_t one, uint32_t* out, Idx n) {
  const FmaAdd add{one};
  uint32_t ks[3];
  schedule(k0, k1, ks);
  for (Idx i = first_group<P, Idx>(); i < n; i += group_stride<P, Idx>()) {
    uint32_t v[P], unused[P];
    bits_group<P, 1>(ks, ks, i, add, v, unused);
    store_group<P>(out, i, n, v);
  }
}

// The scalar bounds' plan, computed once on the host: the draws' lo, span,
// multiplier and reciprocal floor((2^32 - 1) / span).
struct SpanPlan {
  int32_t lo;
  uint32_t span, mult, recip;
};

// randint with scalar bounds. kHashes: 2, both words (the multiplier is
// not 0); 1, the multiplier is 0, so the offset is lb mod span and the
// high word is not drawn (at span 1 that is 0).
template <int P, typename Idx, int kHashes>
__global__ void __launch_bounds__(kDrawThreads, kRandintBlocksPerSm)
randint_kernel(Subkeys k, SpanPlan p, uint32_t one, uint32_t* out, Idx n) {
  const FmaAdd add{one};
  uint32_t ka[3], kb[3];
  schedule(k.a0, k.a1, ka);
  schedule(k.b0, k.b1, kb);
  for (Idx i = first_group<P, Idx>(); i < n; i += group_stride<P, Idx>()) {
    uint32_t hb[P], lb[P], v[P];
    if constexpr (kHashes == 2) {
      bits_group<P, 2>(ka, kb, i, add, hb, lb);
    } else {
      bits_group<P, 1>(kb, kb, i, add, lb, hb);
    }
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const uint32_t off = kHashes == 2 ? reduce(hb[j], lb[j], p.span, p.mult, p.recip, add)
                                        : mod_by(lb[j], p.span, p.recip);
      v[j] = add(static_cast<uint32_t>(p.lo), off);
    }
    store_group<P>(out, i, n, v);
  }
}

// randint with per-element bounds (lo_v / hi_v, or the scalar where null).
template <int P, typename Idx>
__global__ void __launch_bounds__(kDrawThreads, kRandintBlocksPerSm)
randint_kernel(Subkeys k, const int32_t* lo_v, int32_t lo_s, const int32_t* hi_v,
               int32_t hi_s, uint32_t one, uint32_t* out, Idx n) {
  const FmaAdd add{one};
  uint32_t ka[3], kb[3];
  schedule(k.a0, k.a1, ka);
  schedule(k.b0, k.b1, kb);
  for (Idx i = first_group<P, Idx>(); i < n; i += group_stride<P, Idx>()) {
    int32_t lo[P], hi[P];
    load_group<P>(lo_v, lo_s, i, n, lo);
    load_group<P>(hi_v, hi_s, i, n, hi);
    uint32_t hb[P], lb[P], v[P];
    bits_group<P, 2>(ka, kb, i, add, hb, lb);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const uint32_t off = offset(hb[j], lb[j], span_of(lo[j], hi[j]), add);
      v[j] = add(static_cast<uint32_t>(lo[j]), off);
    }
    store_group<P>(out, i, n, v);
  }
}

struct Csr {
  const void* indptr;
  int indptr64;
  const void* ids;
  int wide;
  int64_t n_rows;
};

__device__ __forceinline__ int64_t clamp64(int64_t x, int64_t lo, int64_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__global__ void csr_row_sample_kernel(Subkeys k, Csr base,
                                      const uint8_t* dirty, int64_t n_dirty,
                                      Csr delta, const int32_t* rows,
                                      int32_t* out, uint8_t* valid, int64_t n,
                                      uint32_t one) {
  const FmaAdd add{one};
  uint32_t ka[3], kb[3];
  schedule(k.a0, k.a1, ka);
  schedule(k.b0, k.b1, kb);
  for (int64_t i = first_group<1, int64_t>(); i < n; i += group_stride<1, int64_t>()) {
    const int32_t row = rows[i];
    const int64_t r = row;
    const bool d = dirty != nullptr && dirty[clamp64(r, 0, n_dirty - 1)] != 0;
    // the fields of the CSR this row is read from, picked one by one so the
    // two parameter structs stay in constant memory
    const void* indptr = d ? delta.indptr : base.indptr;
    const int indptr64 = d ? delta.indptr64 : base.indptr64;
    const void* ids = d ? delta.ids : base.ids;
    const int wide = d ? delta.wide : base.wide;
    const int64_t n_rows = d ? delta.n_rows : base.n_rows;
    const int64_t a = clamp64(r, 0, n_rows), b = clamp64(r + 1, 0, n_rows);
    const int64_t start =
        indptr64 ? static_cast<const int64_t*>(indptr)[a]
                 : static_cast<int64_t>(static_cast<const int32_t*>(indptr)[a]);
    const int64_t end =
        indptr64 ? static_cast<const int64_t*>(indptr)[b]
                 : static_cast<int64_t>(static_cast<const int32_t*>(indptr)[b]);
    const int64_t length = end - start;
    uint32_t hb[1], lb[1];
    bits_group<1, 2>(ka, kb, static_cast<uint64_t>(i), add, hb, lb);
    const uint32_t off =
        offset(hb[0], lb[0], length > 0 ? static_cast<uint32_t>(length) : 1u, add);
    const bool ok = length > 0;
    int32_t v = row;
    if (ok) {
      const int64_t p = start + off;
      v = wide ? static_cast<const int32_t*>(ids)[p]
               : static_cast<int32_t>(static_cast<const uint16_t*>(ids)[p]);
    }
    out[i] = v;
    valid[i] = ok ? 1 : 0;
  }
}

struct Grid {
  unsigned blocks, threads;
  int per_thread;
};

// The current device's SMs, asked of CUDA once a device. Where CUDA cannot
// say, 1: its error stays CUDA's last, for the launcher to return.
int sm_count() {
  constexpr int kDevices = 64;
  static std::atomic<int> known[kDevices];
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  if (dev < kDevices && (sms = known[dev].load(std::memory_order_relaxed)) > 0) return sms;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      sms < 1) {
    return 1;
  }
  if (dev < kDevices) known[dev].store(sms, std::memory_order_relaxed);
  return sms;
}

// A draw launch over n elements: where `vector`, kPerThread elements a
// thread if that still gives every SM a whole block of kDrawThreads, else
// one; blocks of kDrawThreads, halved (to 64 at least) while the grid
// would leave an SM without a block; a block for every group of threads
// up to kMaxBlocksPerSm on each SM, past which the threads stride.
Grid draw_grid(int64_t n, bool vector) {
  const int sms = sm_count();
  const int per =
      vector && n >= int64_t{kPerThread} * kDrawThreads * sms ? kPerThread : 1;
  const int64_t groups = (n + per - 1) / per;
  int threads = kDrawThreads;
  while (threads > 64 && (groups + threads - 1) / threads < sms) threads /= 2;
  const int64_t blocks = (groups + threads - 1) / threads;
  const int64_t most = static_cast<int64_t>(sms) * kMaxBlocksPerSm;
  return {static_cast<unsigned>(blocks < most ? blocks : most),
          static_cast<unsigned>(threads), per};
}

// Calls launch(P, Idx{}) with the elements a thread and the index type of
// a draw over n elements on grid g (more than kNarrow elements: 64-bit
// indices, always kPerThread a thread).
template <class F>
void by_plan(const Grid& g, int64_t n, F&& launch) {
  if (n > kNarrow) {
    launch(std::integral_constant<int, kPerThread>{}, uint64_t{});
  } else if (g.per_thread == kPerThread) {
    launch(std::integral_constant<int, kPerThread>{}, uint32_t{});
  } else {
    launch(std::integral_constant<int, 1>{}, uint32_t{});
  }
}

bool misaligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; }

}  // namespace

// out: uint32[n] (an int32 tensor's storage), 16-byte aligned. Launches on
// `stream`; returns cudaGetLastError().
extern "C" int threefry_bits_launch(uint32_t k0, uint32_t k1, void* out,
                                    int64_t n, cudaStream_t stream) {
  if (n < 0 || misaligned(out)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const Grid g = draw_grid(n, true);
  by_plan(g, n, [&](auto per, auto idx) {
    using Idx = decltype(idx);
    threefry_bits_kernel<decltype(per)::value, Idx><<<g.blocks, g.threads, 0, stream>>>(
        k0, k1, 1u, static_cast<uint32_t*>(out), static_cast<Idx>(n));
  });
  return static_cast<int>(cudaGetLastError());
}

// (a0, a1), (b0, b1): the two keys of split(key). lo_v / hi_v: int32[n], or
// null for the scalars lo_s / hi_s; with both scalar the host computes the
// span, multiplier and reciprocal once, and the kernel draws the hashes
// the offset needs (one where the multiplier is 0, span 1 included). out:
// int32[n], 16-byte aligned.
extern "C" int randint_launch(uint32_t a0, uint32_t a1, uint32_t b0,
                              uint32_t b1, const int32_t* lo_v, int32_t lo_s,
                              const int32_t* hi_v, int32_t hi_s, int32_t* out,
                              int64_t n, cudaStream_t stream) {
  if (n < 0 || misaligned(out)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const Subkeys k{a0, a1, b0, b1};
  const Grid g = draw_grid(n, true);
  uint32_t* o = reinterpret_cast<uint32_t*>(out);
  const bool scalar = lo_v == nullptr && hi_v == nullptr;
  const uint32_t span = span_of(lo_s, hi_s);
  uint32_t mult = 65536u % span;
  mult = (mult * mult) % span;
  const SpanPlan plan{lo_s, span, mult, 0xFFFFFFFFu / span};
  by_plan(g, n, [&](auto per, auto idx) {
    using Idx = decltype(idx);
    constexpr int P = decltype(per)::value;
    const Idx m = static_cast<Idx>(n);
    if (!scalar) {
      randint_kernel<P, Idx><<<g.blocks, g.threads, 0, stream>>>(
          k, lo_v, lo_s, hi_v, hi_s, 1u, o, m);
    } else if (mult == 0) {
      randint_kernel<P, Idx, 1><<<g.blocks, g.threads, 0, stream>>>(k, plan, 1u, o, m);
    } else {
      randint_kernel<P, Idx, 2><<<g.blocks, g.threads, 0, stream>>>(k, plan, 1u, o, m);
    }
  });
  return static_cast<int>(cudaGetLastError());
}

// The CSR: indptr (int64 if indptr64, else int32) of n_rows + 1 entries and
// ids (int32 if wide, else uint16). dirty: bool of n_dirty >= 1 entries, or
// null for no overlay; then the delta CSR as the base. rows: int32[n];
// out: int32[n]; valid: bool[n]. All on the current device.
extern "C" int csr_row_sample_launch(
    uint32_t a0, uint32_t a1, uint32_t b0, uint32_t b1, const void* indptr,
    int indptr64, const void* ids, int wide, int64_t n_rows,
    const uint8_t* dirty, int64_t n_dirty, const void* d_indptr,
    int d_indptr64, const void* d_ids, int d_wide, int64_t d_rows,
    const int32_t* rows, int32_t* out, uint8_t* valid, int64_t n,
    cudaStream_t stream) {
  if (n_rows < 0 || n < 0 ||
      (dirty != nullptr && (n_dirty < 1 || d_rows < 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  const Grid g = draw_grid(n, false);
  csr_row_sample_kernel<<<g.blocks, g.threads, 0, stream>>>(
      Subkeys{a0, a1, b0, b1}, Csr{indptr, indptr64, ids, wide, n_rows}, dirty,
      n_dirty, Csr{d_indptr, d_indptr64, d_ids, d_wide, d_rows}, rows, out,
      valid, n, 1u);
  return static_cast<int>(cudaGetLastError());
}
