// ssd_scan: the Mamba2 SSD recurrence S_t = exp(a_t) S_{t-1} + (dt_t B_t) x_t^T,
// y_t = C_t S_t, evaluated chunk by chunk (Dao & Gu 2024): per chunk of Q
// steps, the intra-chunk term (L o C Bt^T) X with L_ij = exp(l_i - l_j) for
// i >= j (l the cumulative log-decay), the inter-chunk term C exp(l) S_prev,
// and the state pass S = exp(l_Q) S_prev + sum_t exp(l_Q - l_t) Bt_t x_t^T.
// x: [B, H, S, P] (bf16 or f32); dt, a_log: f32 [B, H, S]; B, C: [B, S, N]
// in x's dtype, one group shared by the H heads of a batch row; out: x's
// dtype. Steps at or past S read as x = dt = a_log = B = C = 0 and are not
// stored: the recurrence is causal, so the real positions are exact for
// any S.
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan_kernel, the Pallas TPU
// kernel with grid (B*H, S/Q) whose chunk axis runs in order, carrying the
// (N, P) state in VMEM scratch; its wrapper repeats B and C over the heads
// (src/repro/kernels/ops.py:262-263) and it needs S % Q == 0. Both routes
// here keep its sequential walk over the chunks inside a block, so the
// carried state never goes to device memory, and read B and C by batch row
// instead of a per-head copy (which would move H = 24 times their bytes at
// mamba2's width).
//
// Bound on an H100: bytes. Reading x, dt, a_log, B, C once and writing y
// once is 0.0335 ms at 3.35 TB/s at mamba2's prefill shape (x [192, 2048,
// 64] bf16, B/C [8, 2048, 128], chunk 128), against 0.023 ms for its 22.6
// GFLOP at the bf16 tensor-core peak of 989 TFLOP/s.
//
// Two routes, chosen by the wrapper (kernels/ssd_scan.py, uses_tensor_cores):
//
//   ssd_tc_kernel   bf16 with P % 32 == 0, N one of 16, 32, 64, 128 (mamba2:
//                   P 64, N 128, chunk 128): all four products on the
//                   tensor cores with mma.sync m16n8k16, f32 accumulation.
//   ssd_fma_kernel  f32, and the shapes the first cannot take: f32 FMAs on
//                   the CUDA cores, exact to f32 rounding (the f32 model
//                   runs it).
//
// ssd_tc_kernel. One block of 8 warps per (b, h, 32-column slice of P):
// 8 * 24 heads * 2 slices = 384 blocks at mamba2's prefill. Each block
// walks the chunks in order. Shared memory holds two stages of the
// chunk's inputs, filled one chunk ahead: x [Q][32], B and C [Q][N] in
// bf16 by TMA (a cp.async per thread and 16 bytes kept the load/store
// pipe that ldmatrix needs busy for the whole chunk), read at the
// operands' own strides (the layer hands over views of its [B, S, *]
// activations, so no copy precedes the launch) and swizzled so the eight
// rows of an ldmatrix hit distinct banks; dt and a_log by 4-byte cp.async.
// Beside them two buffers of the carried state as bf16 hi/lo and each
// warp's copy of the chunk's decays: 207,888 bytes, so one block (8 warps)
// per SM, and 384 blocks on 132 SMs run in 2.91 waves, the last 91 % full.
// A P slice of 32 doubles the C Bt^T work (each slice recomputes it, 30 %
// of the block's MMAs) against whole-P blocks, whose 192 blocks would fill
// 1.45 waves. Per chunk, after one barrier (the chunk landed):
//   every warp  the inclusive cumsum l of a_log, exp(l) and the state
//               weights dt_t exp(l_Q - l_t), into its own copy (no second
//               barrier);
//   row block   warp w owns rows [16 r, 16 r + 16), r = w for w < 4 and
//               11 - w above, so the two warps of a scheduler (w, w + 4)
//               own rows r and 7 - r and share 9 column blocks of the lower
//               triangle: y = exp(l_i) C S_prev, then per pair of column
//               blocks G = C Bt^T (bf16 x bf16, exact products), G_ij dt_j
//               exp(l_i - l_j) for j <= i (selected, not masked in the
//               exponent, which overflows above the diagonal), y += G X;
//               y stored. G never leaves registers: the m16n8 accumulator
//               fragment is the m16n8k16 A fragment;
//   state rows  16 rows of S per warp in registers for the whole sequence,
//               S = exp(l_Q) S + (w o B)^T X, written as bf16 hi/lo into
//               the buffer the next chunk reads; the warps of row blocks
//               7, 6, 5 hand theirs to those of 0, 1, 2, so both warps of a
//               scheduler carry 440-480 products a chunk.
// Every product is ordered so that four accumulators alternate, so that
// one warp alone can keep a scheduler's mma.sync pipe near its issue rate
// (a product's latency is several issue slots). G is streamed two column
// blocks at a time rather than held whole (64 more registers a thread).
//
// Precision: x, B and C are bf16 inputs and enter the products exactly. Three
// operands are f32 intermediates: the masked score tile, the state and
// B * dt * exp(l_Q - l_t). Each goes as two bf16 parts, hi = bf16(v) and
// lo = bf16(v - hi), two products into one f32 accumulator, which keeps 16
// bits of v (relative error 2^-17). That costs the same issue slots as TF32
// (m16n8k8 does half the work of m16n8k16 at the same rate), which keeps 11
// bits: TF32's 2^-12 relative rounding of a term, summed over 128-256 terms
// of either sign, is of the order of the smoke's per-element floor of
// 2^-12 of the largest output, so the split keeps the only error of note at
// the output's own bf16 rounding (2^-9 of |y|, within the 2^-7 |y| limit).
// The decays use exp2f on log2(e)-scaled sums (relative error ~2^-22).
//
// ssd_fma_kernel. One block of 256 threads per b*h,
// looping over the chunks in order, the (N, P) f32 state in shared memory
// (32 KB at N = 128, P = 64). Shared memory per block holds x and the y
// accumulator of the chunk (Q x P each), the state, the Q x Q score tile
// C Bt^T, and a 16-wide slice of C and of Bt^T: staging x, B, C and the
// score tile whole in f32 at Q = 128, N = 128 would need 240 KB, over the
// 227 KB a block may use, so the N axis is walked in slices of 16. Per
// slice the block adds the slice's share of C Bt^T (lower triangle only),
// of the inter-chunk term, and updates the slice's state rows (after the
// inter-chunk term has read them). Then the score tile is multiplied by L,
// masking the exponent (not the exp, which overflows above the diagonal),
// and the intra-chunk product finishes y. It reads contiguous [B*H, S, P]
// copies of x, dt and a_log.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kNS = 16;  // state rows (N) per slice

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ void fma4(float a, const float4& b, float4& acc) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

size_t smem_floats(int q, int n, int p) {
  return 2 * static_cast<size_t>(q) * p + static_cast<size_t>(n) * p +
         static_cast<size_t>(q) * q + 2 * static_cast<size_t>(q) * kNS +
         4 * static_cast<size_t>(q);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_fma_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a_log, const T* __restrict__ bmat,
               const T* __restrict__ cmat, T* __restrict__ out, int heads,
               int s_len, int q_len, int n_st, int p_dim) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [Q][P] chunk inputs
  float* ys = xs + q_len * p_dim;               // [Q][P] y accumulator
  float* st = ys + q_len * p_dim;               // [N][P] carried state
  float* g = st + n_st * p_dim;                 // [Q][Q] C Bt^T, then * L
  float* cs = g + q_len * q_len;                // [Q][kNS] C slice
  float* bts = cs + q_len * kNS;                // [kNS][Q] (B * dt)^T slice
  float* lc = bts + kNS * q_len;                // [Q] cumulative log-decay
  float* el = lc + q_len;                       // [Q] exp(l_t)
  float* dec = el + q_len;                      // [Q] exp(l_Q - l_t)
  float* dtv = dec + q_len;                     // [Q] dt

  const int64_t bh = blockIdx.x;
  const int64_t b = bh / heads;
  const int tid = threadIdx.x;
  const int p4 = p_dim / 4;
  const T* xb = x + bh * s_len * p_dim;
  T* ob = out + bh * s_len * p_dim;
  const float* dtb = dt + bh * s_len;
  const float* ab = a_log + bh * s_len;
  const T* bb = bmat + b * s_len * n_st;
  const T* cb = cmat + b * s_len * n_st;

  for (int i = tid; i < n_st * p_dim; i += kThreads) st[i] = 0.f;

  for (int t0 = 0; t0 < s_len; t0 += q_len) {
    // chunk inputs; steps past S read as zero
    for (int i = tid; i < q_len; i += kThreads) {
      const bool ok = t0 + i < s_len;
      dtv[i] = ok ? dtb[t0 + i] : 0.f;
      lc[i] = ok ? ab[t0 + i] : 0.f;
    }
    for (int i = tid; i < q_len * p_dim; i += kThreads) {
      const int t = i / p_dim;
      xs[i] = t0 + t < s_len
                  ? to_f32(xb[static_cast<int64_t>(t0) * p_dim + i])
                  : 0.f;
      ys[i] = 0.f;
    }
    for (int i = tid; i < q_len * q_len; i += kThreads) g[i] = 0.f;
    __syncthreads();

    // inclusive cumsum of the log-decays in warp 0
    if (tid < 32) {
      const int per = (q_len + 31) / 32;
      const int lo = tid * per;
      float run = 0.f;
      for (int i = lo; i < min(lo + per, q_len); ++i) {
        run += lc[i];
        lc[i] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float other = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += other;
      }
      const float offset = incl - run;
      for (int i = lo; i < min(lo + per, q_len); ++i) lc[i] += offset;
    }
    __syncthreads();
    const float l_end = lc[q_len - 1];
    for (int i = tid; i < q_len; i += kThreads) {
      el[i] = expf(lc[i]);
      dec[i] = expf(l_end - lc[i]);
    }
    const float decay_all = expf(l_end);

    for (int n0 = 0; n0 < n_st; n0 += kNS) {
      const int ns = min(kNS, n_st - n0);
      __syncthreads();  // el/dec written; the previous slice is consumed
      for (int i = tid; i < q_len * ns; i += kThreads) {
        const int t = i / ns;
        const int n = i % ns;
        cs[t * kNS + n] =
            t0 + t < s_len
                ? to_f32(cb[static_cast<int64_t>(t0 + t) * n_st + n0 + n])
                : 0.f;
      }
      for (int i = tid; i < q_len * ns; i += kThreads) {
        const int n = i / q_len;
        const int t = i % q_len;
        bts[n * q_len + t] =
            t0 + t < s_len
                ? to_f32(bb[static_cast<int64_t>(t0 + t) * n_st + n0 + n]) *
                      dtv[t]
                : 0.f;
      }
      __syncthreads();

      // g[i][j] += sum_n C[i][n] Bt[j][n] over the lower triangle
      const int q4 = q_len / 4;
      for (int item = tid; item < q_len * q4; item += kThreads) {
        const int i = item / q4;
        const int j = (item % q4) * 4;
        if (j > i) continue;
        float4 acc = *reinterpret_cast<float4*>(g + i * q_len + j);
        for (int n = 0; n < ns; ++n) {
          fma4(cs[i * kNS + n],
               *reinterpret_cast<const float4*>(bts + n * q_len + j), acc);
        }
        *reinterpret_cast<float4*>(g + i * q_len + j) = acc;
      }
      // y[i] += exp(l_i) sum_n C[i][n] S_prev[n]
      for (int item = tid; item < q_len * p4; item += kThreads) {
        const int i = item / p4;
        const int p = (item % p4) * 4;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int n = 0; n < ns; ++n) {
          fma4(cs[i * kNS + n],
               *reinterpret_cast<const float4*>(st + (n0 + n) * p_dim + p), acc);
        }
        float4* y4 = reinterpret_cast<float4*>(ys + i * p_dim + p);
        const float e = el[i];
        y4->x = fmaf(e, acc.x, y4->x);
        y4->y = fmaf(e, acc.y, y4->y);
        y4->z = fmaf(e, acc.z, y4->z);
        y4->w = fmaf(e, acc.w, y4->w);
      }
      __syncthreads();  // the slice's state rows have been read

      // S[n] = exp(l_Q) S[n] + sum_t exp(l_Q - l_t) Bt[t][n] x[t]
      for (int item = tid; item < ns * p4; item += kThreads) {
        const int n = item / p4;
        const int p = (item % p4) * 4;
        float4* s4 = reinterpret_cast<float4*>(st + (n0 + n) * p_dim + p);
        float4 acc = make_float4(decay_all * s4->x, decay_all * s4->y,
                                 decay_all * s4->z, decay_all * s4->w);
        for (int t = 0; t < q_len; ++t) {
          fma4(bts[n * q_len + t] * dec[t],
               *reinterpret_cast<const float4*>(xs + t * p_dim + p), acc);
        }
        *s4 = acc;
      }
    }
    __syncthreads();

    // g *= L on the lower triangle, masking the exponent
    for (int item = tid; item < q_len * q_len; item += kThreads) {
      const int i = item / q_len;
      const int j = item % q_len;
      if (j <= i) g[item] *= expf(lc[i] - lc[j]);
    }
    __syncthreads();

    // y[i] += sum_{j <= i} g[i][j] x[j]; store the real steps
    for (int item = tid; item < q_len * p4; item += kThreads) {
      const int i = item / p4;
      const int p = (item % p4) * 4;
      if (t0 + i >= s_len) continue;
      float4 acc = *reinterpret_cast<const float4*>(ys + i * p_dim + p);
      for (int j = 0; j <= i; ++j) {
        fma4(g[i * q_len + j],
             *reinterpret_cast<const float4*>(xs + j * p_dim + p), acc);
      }
      T* o = ob + static_cast<int64_t>(t0 + i) * p_dim + p;
      o[0] = from_f32<T>(acc.x);
      o[1] = from_f32<T>(acc.y);
      o[2] = from_f32<T>(acc.z);
      o[3] = from_f32<T>(acc.w);
    }
    __syncthreads();  // xs, ys, g are refilled by the next chunk
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* a_log, const void* bm,
           const void* cm, void* out, int64_t bh, int heads, int s_len,
           int q_len, int n_st, int p_dim, cudaStream_t stream) {
  const size_t smem = smem_floats(q_len, n_st, p_dim) * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_fma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_fma_kernel<T><<<static_cast<unsigned>(bh), kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, a_log, static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<T*>(out), heads, s_len, q_len,
      n_st, p_dim);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// ssd_tc_kernel
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPB = 32;          // head-dim columns per block
constexpr int kQMax = 128;       // chunk
constexpr int kNMax = 128;       // state
constexpr int kBoxN = 64;        // state columns per TMA box of B or C
constexpr int kSLd = kPB + 8;    // bf16 pitch of the state's rows: 80 B, so
                                 // the 8 rows of an ldmatrix hit distinct banks

// Shared memory, every TMA box 1024-byte aligned (the swizzle's period):
// per stage x [Q][32] (64-byte rows), B and C as [N / 64 boxes][Q][64]
// (128-byte rows; one box of N columns when N < 64), dt and a_log [Q];
// then the carried state twice as bf16 hi/lo [N][kSLd]; per warp its own
// copy of the chunk's (log2-scaled l, dt) pairs, exp(l) and the state
// weights; and the two stages' mbarriers.
constexpr int kXBytes = kQMax * kPB * 2;
constexpr int kBCBytes = kQMax * kNMax * 2;
constexpr int kStageBytes = kXBytes + 2 * kBCBytes + 1024;
constexpr int kStateBytes = 2 * kNMax * kSLd * 2;
constexpr int kScan = 2 * kStageBytes + 2 * kStateBytes;
constexpr int kScanBytes = 4 * kQMax * 4;  // one warp's l/dt, exp(l), weights
constexpr int kBars = kScan + kWarps * kScanBytes;
constexpr int kSmemBytes = kBars + 16 + 1024;  // + base alignment

static_assert(kStageBytes % 1024 == 0 && kXBytes % 1024 == 0, "box alignment");

// dt and a_log at their element strides; out is contiguous [B*H, S, P].
struct Args {
  const float* dt;
  int64_t dt_sb, dt_sh, dt_ss;
  const float* al;
  int64_t al_sb, al_sh, al_ss;
  __nv_bfloat16* out;
  int heads, s_len, q_len, p_dim;
};

using tma::mbar_expect_tx;
using tma::mbar_init;
using tma::mbar_wait;
using tma::smem_u32;

// 4 bytes from src (src_bytes 4), or zero (src_bytes 0, src not read)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Byte offset o inside a box of `row` -byte rows, as TMA's 32/64/128-byte
// swizzle places it: the 16-byte chunk index is XORed with bits 7.. of o.
__device__ __forceinline__ uint32_t swz(uint32_t o, uint32_t row) {
  return o ^ (((o >> 7) & ((row >> 4) - 1)) << 4);
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a b: m16n8k16, bf16 operands, f32 accumulator
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack(uint32_t r) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&r));
}
// (v0, v1) as bf16 pairs hi = bf16(v) and lo = bf16(v - hi); v0 in the low half
__device__ __forceinline__ void split(float v0, float v1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(v0 - hf.x, v1 - hf.y));
}

// Shared-memory addresses of one stage, and of the 16-byte chunk holding
// (row, col) of x, B or C as TMA swizzled them.
template <int NK>
struct Stage {
  static constexpr int kN = 16 * NK;
  static constexpr int kBox = kN < kBoxN ? kN : kBoxN;  // columns per box
  static constexpr uint32_t kRow = kBox * 2;           // bytes per box row
  uint32_t x, b, c;
  const float* dt;
  const float* al;
  __device__ __forceinline__ uint32_t xa(int row, int col) const {
    return x + swz(row * (kPB * 2) + col * 2, kPB * 2);
  }
  __device__ __forceinline__ uint32_t bc(uint32_t base, int row, int col) const {
    return base + (col / kBox) * (kQMax * kRow) +
           swz(row * kRow + (col % kBox) * 2, kRow);
  }
};

template <int NK>
__device__ __forceinline__ Stage<NK> stage_at(uint8_t* smem, int st) {
  uint8_t* base = smem + st * kStageBytes;
  Stage<NK> s;
  s.x = smem_u32(base);
  s.b = s.x + kXBytes;
  s.c = s.b + kBCBytes;
  s.dt = reinterpret_cast<const float*>(base + kXBytes + 2 * kBCBytes);
  s.al = s.dt + kQMax;
  return s;
}

// Issues the loads of the chunk at t0 into stage `st`: x, B and C by TMA
// (thread 0, counted on `bar`), dt and a_log by cp.async (one group).
template <int NK>
__device__ __forceinline__ void load_chunk(const Args& a, uint8_t* smem, int st,
                                           uint32_t bar, const CUtensorMap* tx,
                                           const CUtensorMap* tb,
                                           const CUtensorMap* tcm, int p0,
                                           int64_t b, int64_t h,
                                           const float* dtb, const float* alb,
                                           int t0) {
  using S = Stage<NK>;
  const Stage<NK> s = stage_at<NK>(smem, st);
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, a.q_len * (kPB + 2 * S::kN) * 2);
    tma::load_4d(s.x, tx, bar, p0, t0, static_cast<int>(h), static_cast<int>(b));
#pragma unroll
    for (int k = 0; k < S::kN / S::kBox; ++k) {
      const uint32_t box = k * kQMax * S::kRow;
      tma::load_3d(s.b + box, tb, bar, k * S::kBox, t0, static_cast<int>(b));
      tma::load_3d(s.c + box, tcm, bar, k * S::kBox, t0, static_cast<int>(b));
    }
  }
  const int i = threadIdx.x & (kQMax - 1);
  if (i < a.q_len) {
    const bool ok = t0 + i < a.s_len;
    const int64_t row = static_cast<int64_t>(t0 + i);
    if (threadIdx.x < kQMax) {
      cp_async4(smem_u32(s.dt + i), ok ? dtb + row * a.dt_ss : dtb, ok ? 4 : 0);
    } else {
      cp_async4(smem_u32(s.al + i), ok ? alb + row * a.al_ss : alb, ok ? 4 : 0);
    }
  }
  cp_async_commit();
}

// A fragments of rows [i0, i0 + 16) of C over the state's NK 16-blocks
template <int NK>
__device__ __forceinline__ void c_frags(uint32_t (&ca)[NK][4], const Stage<NK>& s,
                                        int i0, int lane) {
#pragma unroll
  for (int ks = 0; ks < NK; ++ks) {
    ldsm_x4(ca[ks], s.bc(s.c, i0 + (lane & 15), ks * 16 + (lane >> 4) * 8));
  }
}

// y (4 n8 tiles) += a_hi X + a_lo X over one 16-step block, the eight
// products ordered so that no two in a row share an accumulator
__device__ __forceinline__ void mma_split(float (&y)[kPB / 8][4], const uint32_t* ah,
                                          const uint32_t* al, const uint32_t (&xf)[8]) {
  mma(y[0], ah, xf[0], xf[1]);
  mma(y[1], ah, xf[2], xf[3]);
  mma(y[2], ah, xf[4], xf[5]);
  mma(y[3], ah, xf[6], xf[7]);
  mma(y[0], al, xf[0], xf[1]);
  mma(y[1], al, xf[2], xf[3]);
  mma(y[2], al, xf[4], xf[5]);
  mma(y[3], al, xf[6], xf[7]);
}

// G_ij * dt_j * exp(l_i - l_j) on a 16 x 16 tile g (two n8 tiles) of
// columns [16 jb, 16 jb + 16) for rows r0 and r0 + 8, zero for j > i: the
// exponent is not masked but the product is selected away, since the exp
// overflows above the diagonal. ld: (l log2(e), dt) pairs.
__device__ __forceinline__ void mask_tile(float (&g)[2][4], const float2* ld,
                                          int jb, int r0, float l0, float l1,
                                          int t4) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float* t = g[hf];
    const int j = jb * 16 + hf * 8 + 2 * t4;
    const float4 v = *reinterpret_cast<const float4*>(ld + j);  // j, j + 1
    t[0] = j <= r0 ? t[0] * v.y * exp2f(l0 - v.x) : 0.f;
    t[1] = j + 1 <= r0 ? t[1] * v.w * exp2f(l0 - v.z) : 0.f;
    t[2] = j <= r0 + 8 ? t[2] * v.y * exp2f(l1 - v.x) : 0.f;
    t[3] = j + 1 <= r0 + 8 ? t[3] * v.w * exp2f(l1 - v.z) : 0.f;
  }
}

// The masked score tiles of column blocks jb .. jb + T - 1 of row block rb
// (g = C Bt^T over the state, T * 2 independent chains), times X, into y.
template <int NK, int T>
__device__ __forceinline__ void intra(float (&y)[kPB / 8][4],
                                      const uint32_t (&ca)[NK][4],
                                      const Stage<NK>& s, const float2* ld,
                                      int jb, int rb, float l0, float l1,
                                      int lane) {
  float g[T][2][4];
#pragma unroll
  for (int u = 0; u < T; ++u) {
#pragma unroll
    for (int e = 0; e < 4; ++e) g[u][0][e] = g[u][1][e] = 0.f;
  }
#pragma unroll
  for (int ks = 0; ks < NK; ++ks) {
    uint32_t bf[T][4];
#pragma unroll
    for (int u = 0; u < T; ++u) {
      ldsm_x4(bf[u], s.bc(s.b, (jb + u) * 16 + (lane & 7) + (lane >> 4) * 8,
                          ks * 16 + ((lane >> 3) & 1) * 8));
    }
#pragma unroll
    for (int u = 0; u < T; ++u) {
      mma(g[u][0], ca[ks], bf[u][0], bf[u][1]);
      mma(g[u][1], ca[ks], bf[u][2], bf[u][3]);
    }
  }
  const int r0 = rb * 16 + (lane >> 2);
#pragma unroll
  for (int u = 0; u < T; ++u) {
    mask_tile(g[u], ld, jb + u, r0, l0, l1, lane & 3);
    // the accumulator fragments are the A fragments
    uint32_t ah[4], al[4];
    split(g[u][0][0], g[u][0][1], ah[0], al[0]);
    split(g[u][0][2], g[u][0][3], ah[1], al[1]);
    split(g[u][1][0], g[u][1][1], ah[2], al[2]);
    split(g[u][1][2], g[u][1][3], ah[3], al[3]);
    uint32_t xf[8];
    const int row = (jb + u) * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
    ldsm_x4_t(xf, s.xa(row, (lane >> 4) * 8));
    ldsm_x4_t(xf + 4, s.xa(row, 16 + (lane >> 4) * 8));
    mma_split(y, ah, al, xf);
  }
}

// S = exp(l_Q) S + (w o B)^T X over the chunk's n_rb blocks of 16 steps,
// for state rows [16 nb, 16 nb + 16); wt: the weights dt_t exp(l_Q - l_t)
template <int NK>
__device__ __forceinline__ void state_pass(float (&st)[kPB / 8][4],
                                           const Stage<NK>& s, const float* wt,
                                           float decay, int nb, int n_rb,
                                           int lane) {
  const int t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < kPB / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) st[j][e] *= decay;
  }
#pragma unroll 2
  for (int kb = 0; kb < n_rb; ++kb) {
    uint32_t bt[4];  // A = B^T: rows n, columns t
    ldsm_x4_t(bt, s.bc(s.b, kb * 16 + (lane >> 4) * 8 + (lane & 7),
                       nb * 16 + ((lane >> 3) & 1) * 8));
    const int row = kb * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
    uint32_t xf[8];
    ldsm_x4_t(xf, s.xa(row, (lane >> 4) * 8));
    ldsm_x4_t(xf + 4, s.xa(row, 16 + (lane >> 4) * 8));
    const int k0 = kb * 16 + 2 * t4;
    const float2 w01 = *reinterpret_cast<const float2*>(wt + k0);
    const float2 w89 = *reinterpret_cast<const float2*>(wt + k0 + 8);
    uint32_t ah[4], al[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 v = unpack(bt[e]);
      const float2 w = e >= 2 ? w89 : w01;  // a2, a3: columns k0 + 8, k0 + 9
      split(v.x * w.x, v.y * w.y, ah[e], al[e]);
    }
    mma_split(st, ah, al, xf);
  }
}

// State rows [16 nb, 16 nb + 16) as bf16 hi + lo into the buffer at `sh`
// (hi [N][kSLd], then lo) that the next chunk reads
__device__ __forceinline__ void store_state(const float (&st)[kPB / 8][4],
                                            __nv_bfloat16* sh, int nb, int lane) {
  __nv_bfloat16* sl = sh + kNMax * kSLd;
  const int n0 = nb * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < kPB / 8; ++j) {
    const int col = j * 8 + 2 * (lane & 3);
    uint32_t hi, lo;
    split(st[j][0], st[j][1], hi, lo);
    *reinterpret_cast<uint32_t*>(sh + n0 * kSLd + col) = hi;
    *reinterpret_cast<uint32_t*>(sl + n0 * kSLd + col) = lo;
    split(st[j][2], st[j][3], hi, lo);
    *reinterpret_cast<uint32_t*>(sh + (n0 + 8) * kSLd + col) = hi;
    *reinterpret_cast<uint32_t*>(sl + (n0 + 8) * kSLd + col) = lo;
  }
}

constexpr float kLog2e = 1.4426950408889634f;

// NK: the state's 16-row blocks (N / 16). tx: x as a 4-D (P, S, H, B) map
// with 32 x Q boxes; tb, tcm: B and C as 3-D (N, S, B) maps with
// min(N, 64) x Q boxes; all swizzled to their box rows.
template <int NK>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_tc_kernel(const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap tb,
                  const __grid_constant__ CUtensorMap tcm,
                  const __grid_constant__ Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t state_base = smem_u32(smem + 2 * kStageBytes);  // hi/lo twice
  const uint32_t bars = smem_u32(smem + kBars);

  const int splits = a.p_dim / kPB;
  const int64_t bh = blockIdx.x / splits;
  const int p0 = (blockIdx.x % splits) * kPB;
  const int64_t b = bh / a.heads;
  const int64_t h = bh % a.heads;
  const float* dtb = a.dt + b * a.dt_sb + h * a.dt_sh;
  const float* alb = a.al + b * a.al_sb + h * a.al_sh;
  __nv_bfloat16* ob = a.out + bh * a.s_len * a.p_dim + p0;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g8 = lane >> 2;
  const int t4 = lane & 3;
  const int q_len = a.q_len;
  const int n_rb = q_len / 16;
  const int rb = warp < 4 ? warp : 11 - warp;  // my row block
  const int r0 = rb * 16 + g8;                 // my fragment rows r0, r0 + 8
  // my state rows [16 nb, 16 nb + 16): warp w's own block, except that the
  // warps of row blocks 7, 6, 5 hand theirs to the warps of 0, 1, 2, which
  // share their schedulers, so both warps of a scheduler carry about as
  // many products (256, 240 + 232, 264 + 208, 224 + 248 at Q = N = 128)
  const int nb0 = warp >= 4 && warp <= 6 ? -1 : warp;
  const int nb1 = warp <= 2 ? warp + 4 : -1;
  const int n_chunks = (a.s_len + q_len - 1) / q_len;
  // this warp's copy of the chunk's (l log2(e), dt), exp(l) and weights
  float2* ld = reinterpret_cast<float2*>(smem + kScan + warp * kScanBytes);
  float* el = reinterpret_cast<float*>(ld + kQMax);
  float* wt = el + kQMax;

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // S[16 nb + (g8, g8 + 8)][8 j + 2 t4 + (0, 1)] for nb0 and nb1
  float state[2][kPB / 8][4];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
#pragma unroll
    for (int j = 0; j < kPB / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) state[u][j][e] = 0.f;
    }
  }

  load_chunk<NK>(a, smem, 0, bars, &tx, &tb, &tcm, p0, b, h, dtb, alb, 0);
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * q_len;
    cp_async_wait_all();
    mbar_wait(bars + 8 * (ch & 1), (ch >> 1) & 1);
    __syncthreads();  // chunk ch landed; every warp is done with ch - 1
    const Stage<NK> s = stage_at<NK>(smem, ch & 1);
    if (ch + 1 < n_chunks) {
      load_chunk<NK>(a, smem, (ch + 1) & 1, bars + 8 * ((ch + 1) & 1), &tx, &tb,
                     &tcm, p0, b, h, dtb, alb, t0 + q_len);
    }
    const bool rows = rb < n_rb;
    uint32_t ca[NK][4];  // C fragments of my rows
    float y[kPB / 8][4];
#pragma unroll
    for (int j = 0; j < kPB / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) y[j][e] = 0.f;
    }
    if (rows) {
      c_frags<NK>(ca, s, rb * 16, lane);
      if (ch > 0) {  // C S_prev, S_prev as hi + lo (scaled by exp(l_i) below)
        const uint32_t sh = state_base + (ch & 1) * kStateBytes;
        const uint32_t sl = sh + kNMax * kSLd * 2;
#pragma unroll
        for (int ks = 0; ks < NK; ++ks) {
          const uint32_t off =
              ((ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * kSLd +
               (lane >> 4) * 8) * 2;
          uint32_t fh[8], fl[8];
          ldsm_x4_t(fh, sh + off);
          ldsm_x4_t(fh + 4, sh + off + 32);
          ldsm_x4_t(fl, sl + off);
          ldsm_x4_t(fl + 4, sl + off + 32);
          mma(y[0], ca[ks], fh[0], fh[1]);
          mma(y[1], ca[ks], fh[2], fh[3]);
          mma(y[2], ca[ks], fh[4], fh[5]);
          mma(y[3], ca[ks], fh[6], fh[7]);
          mma(y[0], ca[ks], fl[0], fl[1]);
          mma(y[1], ca[ks], fl[2], fl[3]);
          mma(y[2], ca[ks], fl[4], fl[5]);
          mma(y[3], ca[ks], fl[6], fl[7]);
        }
      }
    }
    {  // inclusive cumsum of the log-decays, 4 steps a lane, in every warp
       // (while the products above are in flight)
      float loc[4];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = lane * 4 + k;
        if (i < q_len) run += s.al[i];
        loc[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float other = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += other;
      }
      const float total = __shfl_sync(0xffffffffu, incl, 31);
      const float offset = incl - run;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = lane * 4 + k;
        if (i < q_len) {
          const float l = loc[k] + offset;
          const float dt = s.dt[i];
          ld[i] = make_float2(l * kLog2e, dt);
          el[i] = exp2f(l * kLog2e);
          wt[i] = dt * exp2f((total - l) * kLog2e);
        }
      }
      __syncwarp();
    }

    if (rows) {
      if (ch > 0) {
        const float e0 = el[r0];
        const float e1 = el[r0 + 8];
#pragma unroll
        for (int j = 0; j < kPB / 8; ++j) {
          y[j][0] *= e0;
          y[j][1] *= e0;
          y[j][2] *= e1;
          y[j][3] *= e1;
        }
      }
      // + (L o G) X over column blocks 0..rb, two at a time
      const float l0 = ld[r0].x;
      const float l1 = ld[r0 + 8].x;
      int jb = 0;
      for (; jb + 1 <= rb; jb += 2) intra<NK, 2>(y, ca, s, ld, jb, rb, l0, l1, lane);
      if (jb == rb) intra<NK, 1>(y, ca, s, ld, jb, rb, l0, l1, lane);
#pragma unroll
      for (int j = 0; j < kPB / 8; ++j) {
        const int col = j * 8 + 2 * t4;
        if (t0 + r0 < a.s_len) {
          *reinterpret_cast<__nv_bfloat162*>(
              ob + static_cast<int64_t>(t0 + r0) * a.p_dim + col) =
              __floats2bfloat162_rn(y[j][0], y[j][1]);
        }
        if (t0 + r0 + 8 < a.s_len) {
          *reinterpret_cast<__nv_bfloat162*>(
              ob + static_cast<int64_t>(t0 + r0 + 8) * a.p_dim + col) =
              __floats2bfloat162_rn(y[j][2], y[j][3]);
        }
      }
    }

    const float decay = el[q_len - 1];
    __nv_bfloat16* next = reinterpret_cast<__nv_bfloat16*>(
        smem + 2 * kStageBytes + ((ch + 1) & 1) * kStateBytes);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int nb = u == 0 ? nb0 : nb1;
      if (nb >= 0 && nb < NK) {
        state_pass(state[u], s, wt, decay, nb, n_rb, lane);
        if (ch + 1 < n_chunks) store_state(state[u], next, nb, lane);
      }
    }
  }
}

// A bf16 map of `rank` dims (innermost first, unit stride along dims[0])
// at element strides `strides` (dims 1..rank-1), with boxes of box0 x rows
// swizzled to their box0 * 2 -byte rows (32, 64 or 128).
bool encode(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
            const int64_t* strides, int box0, int rows) {
  const tma::EncodeTiled fn = tma::encoder();
  if (fn == nullptr) return false;
  cuuint64_t bytes[3];
  for (int i = 0; i < rank - 1; ++i) bytes[i] = static_cast<cuuint64_t>(strides[i]) * 2;
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box0),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = box0 == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                : box0 == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                             : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr),
            dims, bytes, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NK>
int launch_tc(const void* x, const int64_t* xs, const void* bm,
              const int64_t* bms, const void* cm, const int64_t* cms,
              const Args& a, int batch, unsigned blocks, cudaStream_t stream) {
  constexpr int kN = 16 * NK;
  constexpr int kBox = kN < kBoxN ? kN : kBoxN;
  const cuuint64_t xdims[4] = {static_cast<cuuint64_t>(a.p_dim),
                               static_cast<cuuint64_t>(a.s_len),
                               static_cast<cuuint64_t>(a.heads),
                               static_cast<cuuint64_t>(batch)};
  const int64_t xstr[3] = {xs[2], xs[1], xs[0]};
  const cuuint64_t bdims[3] = {static_cast<cuuint64_t>(kN),
                               static_cast<cuuint64_t>(a.s_len),
                               static_cast<cuuint64_t>(batch)};
  const int64_t bstr[2] = {bms[1], bms[0]};
  const int64_t cstr[2] = {cms[1], cms[0]};
  CUtensorMap tx, tb, tcm;
  if (!encode(&tx, x, 4, xdims, xstr, kPB, a.q_len) ||
      !encode(&tb, bm, 3, bdims, bstr, kBox, a.q_len) ||
      !encode(&tcm, cm, 3, bdims, cstr, kBox, a.q_len)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_tc_kernel<NK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_tc_kernel<NK><<<blocks, kThreads, kSmemBytes, stream>>>(tx, tb, tcm, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// x, out: [bh, s_len, p_dim]; bm, cm: [bh / heads, s_len, n_st], all in
// `dtype` (0 f32, 1 bf16); dt, a_log: f32 [bh, s_len]; all contiguous on the
// current device. q_len (the chunk) and p_dim are multiples of 4. Launches
// ssd_fma_kernel on `stream`; returns cudaGetLastError() (or the attribute
// call's error).
extern "C" int ssd_scan_fma_launch(const void* x, const float* dt,
                                   const float* a_log, const void* bm,
                                   const void* cm, void* out, int64_t bh,
                                   int heads, int s_len, int q_len, int n_st,
                                   int p_dim, int dtype, cudaStream_t stream) {
  if (bh < 0 || heads < 1 || bh % heads || s_len < 0 || q_len < 4 ||
      q_len % 4 || n_st < 1 || p_dim < 4 || p_dim % 4 || bh > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bh == 0 || s_len == 0) return 0;
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, dt, a_log, bm, cm, out, bh, heads, s_len,
                                 q_len, n_st, p_dim, stream);
  }
  if (dtype == 0) {
    return launch<float>(x, dt, a_log, bm, cm, out, bh, heads, s_len, q_len,
                         n_st, p_dim, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// bf16 x [batch, heads, s_len, p_dim] at element strides xs (b, h, s);
// dt, a_log f32 [batch, heads, s_len] at strides dts, als (b, h, s); bf16
// bm, cm [batch, s_len, n_st] at strides bms, cms (b, s); unit stride along
// p and n, and x, bm, cm 16-byte aligned with strides of 8-element
// multiples (cp.async moves 16 bytes). out: contiguous bf16 [batch * heads,
// s_len, p_dim]. p_dim % 32 == 0, n_st one of 16, 32, 64, 128, q_len % 16
// == 0 and <= 128. Launches ssd_tc_kernel on `stream`; returns
// cudaGetLastError() (or the attribute call's error).
extern "C" int ssd_scan_tc_launch(const void* x, const int64_t* xs,
                                  const float* dt, const int64_t* dts,
                                  const float* a_log, const int64_t* als,
                                  const void* bm, const int64_t* bms,
                                  const void* cm, const int64_t* cms,
                                  void* out, int batch, int heads, int s_len,
                                  int q_len, int n_st, int p_dim,
                                  cudaStream_t stream) {
  if (batch < 0 || heads < 1 || s_len < 0 || q_len < 16 || q_len % 16 ||
      q_len > tc::kQMax ||
      (n_st != 16 && n_st != 32 && n_st != 64 && n_st != 128) ||
      p_dim < tc::kPB || p_dim % tc::kPB ||
      static_cast<int64_t>(batch) * heads * (p_dim / tc::kPB) > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || s_len == 0) return 0;
  tc::Args a;
  a.dt = dt;
  a.dt_sb = dts[0];
  a.dt_sh = dts[1];
  a.dt_ss = dts[2];
  a.al = a_log;
  a.al_sb = als[0];
  a.al_sh = als[1];
  a.al_ss = als[2];
  a.out = static_cast<__nv_bfloat16*>(out);
  a.heads = heads;
  a.s_len = s_len;
  a.q_len = q_len;
  a.p_dim = p_dim;
  const unsigned blocks = static_cast<unsigned>(
      static_cast<int64_t>(batch) * heads * (p_dim / tc::kPB));
  switch (n_st) {
    case 16: return tc::launch_tc<1>(x, xs, bm, bms, cm, cms, a, batch, blocks, stream);
    case 32: return tc::launch_tc<2>(x, xs, bm, bms, cm, cms, a, batch, blocks, stream);
    case 64: return tc::launch_tc<4>(x, xs, bm, bms, cm, cms, a, batch, blocks, stream);
    case 128: return tc::launch_tc<8>(x, xs, bm, bms, cm, cms, a, batch, blocks, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
