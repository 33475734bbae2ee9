// Threefry-2x32 random draws that equal jax.random's bit for bit (JAX's
// partitionable scheme), for the port's sampling path. Three entries, one
// thread an element:
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
// no fewer than 69 of them: 20 rounds of an add, a funnel-shift rotate
// and an xor (60), the two key adds before the rounds, five injections
// that each add one word to x1 and, but for the last, fold their x0 word
// into the next round's add (a three-input IADD3), the last x0 add, and
// the xor of the output words. The card issues 4 warp instructions a
// clock on each SM, so at 4 B written an element the two bounds are of
// the same order; the kernel keeps the key in registers, reads nothing
// else and writes each element once, coalesced. randint: twice the hash
// plus the reduction, the output and any per-element bounds.
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
// PERF.md), so it stays this simple.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// threefry-2x32, 20 rounds, on counter words (x0, x1) in place.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kParity};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int r0 = (i & 1) ? 17 : 13, r1 = (i & 1) ? 29 : 15;
    const int r2 = (i & 1) ? 16 : 26, r3 = (i & 1) ? 24 : 6;
    x0 += x1; x1 = rotl(x1, r0) ^ x0;
    x0 += x1; x1 = rotl(x1, r1) ^ x0;
    x0 += x1; x1 = rotl(x1, r2) ^ x0;
    x0 += x1; x1 = rotl(x1, r3) ^ x0;
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// Element i's 32 bits under key (k0, k1).
__device__ __forceinline__ uint32_t bits_at(uint32_t k0, uint32_t k1,
                                            uint64_t i) {
  uint32_t x0 = static_cast<uint32_t>(i >> 32);
  uint32_t x1 = static_cast<uint32_t>(i);
  threefry(k0, k1, x0, x1);
  return x0 ^ x1;
}

struct Subkeys {
  uint32_t a0, a1, b0, b1;  // split(key): the high bits' and low bits' keys
};

// _randint's offset in [0, span) for element i.
__device__ __forceinline__ uint32_t draw(const Subkeys& k, uint64_t i,
                                         uint32_t span) {
  const uint32_t hb = bits_at(k.a0, k.a1, i);
  const uint32_t lb = bits_at(k.b0, k.b1, i);
  uint32_t mult = 65536u % span;
  mult = (mult * mult) % span;
  return ((hb % span) * mult + lb % span) % span;
}

__device__ __forceinline__ uint32_t span_of(int32_t lo, int32_t hi) {
  return hi <= lo ? 1u
                  : static_cast<uint32_t>(hi) - static_cast<uint32_t>(lo);
}

__global__ void threefry_bits_kernel(uint32_t k0, uint32_t k1, uint32_t* out,
                                     int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    out[i] = bits_at(k0, k1, static_cast<uint64_t>(i));
  }
}

__global__ void randint_kernel(Subkeys k, const int32_t* lo_v, int32_t lo_s,
                               const int32_t* hi_v, int32_t hi_s, int32_t* out,
                               int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int32_t lo = lo_v ? lo_v[i] : lo_s;
    const int32_t hi = hi_v ? hi_v[i] : hi_s;
    const uint32_t off = draw(k, static_cast<uint64_t>(i), span_of(lo, hi));
    out[i] = static_cast<int32_t>(static_cast<uint32_t>(lo) + off);
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
                                      int32_t* out, uint8_t* valid, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
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
    const uint32_t span = length > 0 ? static_cast<uint32_t>(length) : 1u;
    const uint32_t off = draw(k, static_cast<uint64_t>(i), span);
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

unsigned grid_for(int64_t n) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < 132 * 64 ? blocks : 132 * 64);
}

}  // namespace

// out: uint32[n] (an int32 tensor's storage). Launches on `stream`;
// returns cudaGetLastError().
extern "C" int threefry_bits_launch(uint32_t k0, uint32_t k1, void* out,
                                    int64_t n, cudaStream_t stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  threefry_bits_kernel<<<grid_for(n), kThreads, 0, stream>>>(
      k0, k1, static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// (a0, a1), (b0, b1): the two keys of split(key). lo_v / hi_v: int32[n], or
// null for the scalars lo_s / hi_s. out: int32[n].
extern "C" int randint_launch(uint32_t a0, uint32_t a1, uint32_t b0,
                              uint32_t b1, const int32_t* lo_v, int32_t lo_s,
                              const int32_t* hi_v, int32_t hi_s, int32_t* out,
                              int64_t n, cudaStream_t stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  randint_kernel<<<grid_for(n), kThreads, 0, stream>>>(
      Subkeys{a0, a1, b0, b1}, lo_v, lo_s, hi_v, hi_s, out, n);
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
  csr_row_sample_kernel<<<grid_for(n), kThreads, 0, stream>>>(
      Subkeys{a0, a1, b0, b1}, Csr{indptr, indptr64, ids, wide, n_rows}, dirty,
      n_dirty, Csr{d_indptr, d_indptr64, d_ids, d_wide, d_rows}, rows, out,
      valid, n);
  return static_cast<int>(cudaGetLastError());
}
