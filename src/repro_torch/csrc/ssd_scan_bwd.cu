// ssd_scan_bwd: the gradient of the Mamba2 SSD scan (csrc/ssd_scan.cu) for
// an output gradient dy [B, H, S, P]: dx [B, H, S, P] in x's dtype, ddt and
// da_log f32 [B, H, S], and dB, dC [B, S, N] in B's dtype, summed over the H
// heads that share B and C. Steps at or past S read as zero and take no
// gradient.
//
// Replaces: no TPU kernel. The JAX package trains through its chunked plain
// SSD (src/repro/kernels/ref.py:149, called from src/repro/models/
// layers.py:560-567) and lets autodiff differentiate it; the forward is
// src/repro/kernels/ssd_scan.py::ssd_scan_kernel. The algorithm, written out
// in plain torch, is kernels/ref.py::ssd_scan_chunked_bwd; with l the
// inclusive cumsum of a_log in a chunk of Q steps, l_Q its last, Bt = B dt,
// S_c the state entering the chunk, D the gradient of the state leaving it
// and L_ij = exp(l_i - l_j) for j <= i:
//   dx  = M^T dy + exp(l_Q - l) o (Bt D),      M = (C Bt^T) o L
//   dBt = E^T C + exp(l_Q - l) o (x D^T),      E = (dy x^T) o L
//   dC  = E Bt + exp(l) o (dy S_c^T);  dB = dBt dt,  ddt = rowsum(dBt o B)
//   dl_i = sum_j R_ij - sum_k R_ki + exp(l_i) C_i . (S_c dy_i) - w_i, with
//   R = E o C Bt^T strictly below the diagonal and w_j = exp(l_Q - l_j)
//   Bt_j . (D x_j); dl_Q also takes sum_j w_j + exp(l_Q) <D, S_c>; da_log is
//   dl summed from the chunk's end back.
//
// Bound on an H100: bytes, 87 MB of inputs and gradients at mamba2's
// training shape (x [4, 24, 2,048, 64], N 128: 0.026 ms at 3.35 TB/s),
// against about 2.5 times the forward's chunked products (22 GFLOP at the
// chunk of 64: 0.0225 ms at the bf16 tensor-core peak).
//
// Two routes, chosen by the wrapper (kernels/ssd_scan.py,
// bwd_uses_tensor_cores), each two kernels and no atomics (a second call
// gives the same bits):
//
//   tensor cores  bf16 with P 32 or 64 and N one of 16, 32, 64, 128
//                 (mamba2: P 64, N 128): ssd_bwd_tc_states_kernel, then
//                 ssd_bwd_tc_grads_kernel, every product by mma.sync
//                 m16n8k16 with f32 accumulators, chunk 64.
//   FMA           f32, and the shapes the first cannot take:
//                 ssd_bwd_states_kernel, then ssd_bwd_chunk_kernel, f32 FMAs
//                 on the CUDA cores, exact to f32 rounding.
//
// Precision of the tensor-core route: x, dy, B and C are bf16 and enter the
// products exactly. Every f32 operand of a product goes in as two bf16
// parts, hi = bf16(v) and lo = bf16(v - hi) (16 significant bits): the
// states passes' w o B and exp(l) o C, the stored states S_c and D, and the
// score tiles M, E and E o dt. Rounded once instead, the score tiles took
// the gradients past the train limit (2^-6 of each element plus 2^-10 of
// the largest) on the CPU, 1.01-1.19 times it, and the states and weights
// to 0.89 of it (tests/test_torch_ssd_bwd_algorithm.py);
// kernels/ref.py::ssd_scan_bwd_blocked is this route's algorithm with
// these roundings.
//
// ssd_bwd_tc_states_kernel. One block of 8 warps per (b, h, pass, 32
// head-dim columns): 4 * 24 * 2 * 2 = 384 blocks at mamba2's training
// shape, against the FMA kernel's 96 (b, h) blocks that walked both passes
// in turn. Pass 0 walks the chunks forward, pass 1 backward, each carrying
// its 16 state rows a warp x 32 columns in f32 registers (the forward's
// ssd_tc_kernel state pass): per chunk it writes the carried state (S_c,
// or D_c) as bf16 hi/lo to scratch [B*H, nc, 2, N, P] (the same bytes as
// f32, read as MMA operands with no conversion), then S = exp(l_Q) S + (w o
// B)^T x with w = dt exp(l_Q - l), or D = exp(l_Q) D + (exp(l) o C)^T dy.
// The store is what costs: the quads of lanes that hold a fragment row
// trade pairs (quad_transpose) so that each lane writes 16 bytes, whole
// 32-byte sectors a row (with 4-byte stores of the fragment pairs the
// stores took more than half the kernel's time). Two stages of x or dy
// [Q][32], B or C [Q][N], dt and a_log, filled one chunk ahead by cp.async
// at the operands' own strides (the layer hands over views of its [B, S, *]
// activations and dy arrives as a transposed view: no copy precedes the
// launch), rows padded by 16 bytes so the eight rows of an ldmatrix hit
// distinct banks: 48,128 bytes at N 128, all 384 blocks resident (a third
// stage, two chunks ahead, measured no faster).
//
// ssd_bwd_tc_grads_kernel. One block of 8 warps per (b, chunk), walking
// the H heads in order (128 blocks at mamba2's training shape: under one
// wave of 132 SMs, 24 heads each, 3 % over the ideal split of 3,072
// (head, chunk) units). Shared memory: B and C of the chunk once, then two
// heads' x, dy, S_c and D as hi/lo, dt and a_log, the next head's loaded by
// cp.async while this head's products run (223,776 bytes at N 128, P 64).
// Warp w owns row block r = w % 4 and half w / 4 of each output's columns
// (dx's P, dB's and dC's N), so the head sums of dB and dC stay in its
// registers for the whole walk and are rounded to bf16 once at the end.
// Per head, for its rows j: dx starts at exp(l_Q - l_j) dt_j (B_j D), dB~
// at exp(l_Q - l_j) x_j D^T (whose row dot with B_j is w_j's part); then
// over the column blocks i >= j it forms G^T = B C^T and E'^T = x dy^T
// tiles, makes M^T = G^T dt_j L and E^T = E'^T L in registers (the exponent
// is selected, not masked: exp(l_i - l_j) overflows for i < j), and since
// the m16n8 accumulator is the m16n8k16 A fragment, feeds them as hi/lo
// pairs to dx += M^T dy and dB~ += E^T C with no shared-memory round trip.
// R^T = E^T o G^T dt_j gives dl's two sums: row sums (one warp of the pair)
// and column sums (the other). For its rows i: dC += exp(l_i) dy_i S_c^T
// (whose row dot with C_i is dl's state term) + (E o dt) B over the blocks
// j <= i. The per-row parts meet in shared memory and are added in a fixed
// order; warp 0 then forms ddt, dl and da_log (a suffix scan by
// shuffles), two rows a lane. The chunk is 64: at 128 each warp would carry twice the head sums (128
// registers of them) or the block 16 warps of at most 128 registers, and
// the smaller chunk halves the Q x Q products (the state scratch doubles:
// 100.7 MB a pass written once and read once at mamba2's training shape).
//
// FMA route, two kernels:
//
//   ssd_bwd_states_kernel  one block of 256 threads per (b, h). It walks the
//       chunks forward, writing each chunk's entering state S_c (N x P f32)
//       to scratch, then backward from D = 0, writing each chunk's D and
//       exp(l_Q) <D, S_c>. The state lives in shared memory; each thread
//       owns the same (n, 4 p) items in every pass, so it reads back only
//       what it wrote.
//   ssd_bwd_chunk_kernel   one block of 512 threads per (b, chunk), walking
//       the H heads in order: C Bt^T's head-free part C B^T is computed once
//       a block, and dB, dC are summed over the heads in f32 scratch rows
//       that only this block, and in it only one thread an element, touch;
//       the last head's sums are rounded to B's dtype. Per head it stages
//       x, dy, S_c and D (rows padded by 4 floats, so the float4 reads of
//       neighbouring rows fall in distinct banks) beside B and C (rows
//       padded by 1) and the Q x Q tiles C B^T, M and E (padded by 1): at
//       Q = 64, N = 128, P = 64 that is 225,024 bytes of the 232,448 a block
//       may use, so the backward takes its own chunk (ssd_scan_bwd_chunk:
//       64 at mamba2's width, halved until it fits): the chunk changes only the
//       order of the f32 sums. Row sums over n (the dl terms, ddt) are warp
//       shuffles over the N lanes of a row (N a power of two) and, past 32
//       lanes, per-warp partials added in order.
//
// Masking: the exponent, not the exp, is selected below the diagonal
// (exp(l_i - l_j) overflows for i < j, and inf * 0 is NaN in a backward).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStateThreads = 256;
constexpr int kChunkThreads = 512;
constexpr size_t kMaxSmemBytes = 232448;  // dynamic shared memory a block may use

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

__device__ __forceinline__ float dot4(const float* a, const float* b, int p4) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = 0; k < p4; ++k) {
    const float4 u = reinterpret_cast<const float4*>(a)[k];
    const float4 v = reinterpret_cast<const float4*>(b)[k];
    acc.x = fmaf(u.x, v.x, acc.x);
    acc.y = fmaf(u.y, v.y, acc.y);
    acc.z = fmaf(u.z, v.z, acc.z);
    acc.w = fmaf(u.w, v.w, acc.w);
  }
  return (acc.x + acc.y) + (acc.z + acc.w);
}

// inclusive cumsum of lc[0, q) in place, by warp 0 (the others pass)
__device__ void chunk_cumsum(float* lc, int q, int tid) {
  if (tid >= 32) return;
  const int per = (q + 31) / 32;
  const int lo = tid * per;
  float run = 0.f;
  for (int i = lo; i < min(lo + per, q); ++i) {
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
  for (int i = lo; i < min(lo + per, q); ++i) lc[i] += offset;
}

// sum over the aligned segment of `seg` lanes (a power of two <= 32)
__device__ __forceinline__ float segment_sum(float v, int seg) {
  for (int off = seg >> 1; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

size_t states_smem_floats(int q, int n, int p) {
  return static_cast<size_t>(n) * p + static_cast<size_t>(q) * p +
         static_cast<size_t>(q) * n + 3 * static_cast<size_t>(q) + kStateThreads;
}

size_t chunk_smem_floats(int q, int n, int p) {
  const size_t pp = p + 4, np = n + 1, qp = q + 1, nw = n >= 32 ? n / 32 : 1;
  return 2 * q * pp + 2 * n * pp + 2 * q * np + 3 * q * qp + 6 * q + 3 * q * nw;
}

template <typename T>
__global__ void __launch_bounds__(kStateThreads)
    ssd_bwd_states_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                          const float* __restrict__ dt,
                          const float* __restrict__ a_log,
                          const T* __restrict__ bmat, const T* __restrict__ cmat,
                          float* __restrict__ sbuf, float* __restrict__ dbuf,
                          float* __restrict__ sdot, int heads, int s_len,
                          int q_len, int n_st, int p_dim) {
  extern __shared__ float4 smem4[];
  float* st = reinterpret_cast<float*>(smem4);  // [N][P] state, then D
  float* vs = st + n_st * p_dim;                // [Q][P] x, then dy
  float* ws = vs + q_len * p_dim;               // [Q][N] weighted B, then C
  float* lc = ws + q_len * n_st;                // [Q] cumulative log-decay
  float* ex = lc + q_len;                       // [Q] exp(l_Q - l), then exp(l)
  float* dtv = ex + q_len;                      // [Q] dt
  float* red = dtv + q_len;                     // [kStateThreads] <D, S_c>

  const int64_t bh = blockIdx.x;
  const int64_t b = bh / heads;
  const int tid = threadIdx.x;
  const int nc = (s_len + q_len - 1) / q_len;
  const int p4 = p_dim / 4;
  const int items = n_st * p4;
  const int64_t per_chunk = static_cast<int64_t>(n_st) * p_dim;
  const T* xb = x + bh * s_len * p_dim;
  const T* dyb = dy + bh * s_len * p_dim;
  const float* dtb = dt + bh * s_len;
  const float* ab = a_log + bh * s_len;
  const T* bb = bmat + b * s_len * n_st;
  const T* cb = cmat + b * s_len * n_st;

  for (int pass = 0; pass < 2; ++pass) {
    const bool fwd = pass == 0;
    const T* vsrc = fwd ? xb : dyb;
    const T* wsrc = fwd ? bb : cb;
    for (int i = tid; i < n_st * p_dim; i += kStateThreads) st[i] = 0.f;
    for (int k = 0; k < nc; ++k) {
      const int c = fwd ? k : nc - 1 - k;
      const int t0 = c * q_len;
      __syncthreads();  // the previous chunk's vs, ws and the zeroed st
      for (int i = tid; i < q_len; i += kStateThreads) {
        const bool ok = t0 + i < s_len;
        dtv[i] = ok ? dtb[t0 + i] : 0.f;
        lc[i] = ok ? ab[t0 + i] : 0.f;
      }
      for (int i = tid; i < q_len * p_dim; i += kStateThreads) {
        const int t = i / p_dim;
        vs[i] = t0 + t < s_len
                    ? to_f32(vsrc[static_cast<int64_t>(t0) * p_dim + i])
                    : 0.f;
      }
      __syncthreads();
      chunk_cumsum(lc, q_len, tid);
      __syncthreads();
      const float l_end = lc[q_len - 1];
      for (int i = tid; i < q_len; i += kStateThreads) {
        ex[i] = fwd ? expf(l_end - lc[i]) : expf(lc[i]);
      }
      const float decay_all = expf(l_end);
      __syncthreads();
      for (int i = tid; i < q_len * n_st; i += kStateThreads) {
        const int t = i / n_st;
        const float w = t0 + t < s_len
                            ? to_f32(wsrc[static_cast<int64_t>(t0) * n_st + i])
                            : 0.f;
        ws[i] = fwd ? w * dtv[t] * ex[t] : w * ex[t];
      }
      __syncthreads();
      float* out = (fwd ? sbuf : dbuf) + (bh * nc + c) * per_chunk;
      const float* s_c = sbuf + (bh * nc + c) * per_chunk;
      float part = 0.f;
      for (int item = tid; item < items; item += kStateThreads) {
        const int n = item / p4;
        const int p = (item % p4) * 4;
        float4* s4 = reinterpret_cast<float4*>(st + n * p_dim + p);
        const float4 cur = *s4;
        *reinterpret_cast<float4*>(out + n * p_dim + p) = cur;
        if (!fwd) {  // S_c was written by this thread in the forward walk
          const float4 s = *reinterpret_cast<const float4*>(s_c + n * p_dim + p);
          part += (cur.x * s.x + cur.y * s.y) + (cur.z * s.z + cur.w * s.w);
        }
        float4 acc = make_float4(decay_all * cur.x, decay_all * cur.y,
                                 decay_all * cur.z, decay_all * cur.w);
        for (int t = 0; t < q_len; ++t) {
          fma4(ws[t * n_st + n],
               *reinterpret_cast<const float4*>(vs + t * p_dim + p), acc);
        }
        *s4 = acc;
      }
      if (!fwd) {
        red[tid] = part;
        __syncthreads();
        for (int w = kStateThreads / 2; w > 0; w >>= 1) {
          if (tid < w) red[tid] += red[tid + w];
          __syncthreads();
        }
        if (tid == 0) sdot[bh * nc + c] = decay_all * red[0];
      }
    }
    __syncthreads();  // the walk's last update before st is zeroed
  }
}

template <typename T>
__global__ void __launch_bounds__(kChunkThreads, 1)
    ssd_bwd_chunk_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                         const float* __restrict__ dt,
                         const float* __restrict__ a_log,
                         const T* __restrict__ bmat, const T* __restrict__ cmat,
                         const float* __restrict__ sbuf,
                         const float* __restrict__ dbuf,
                         const float* __restrict__ sdot, T* __restrict__ dx,
                         float* __restrict__ ddt, float* __restrict__ da,
                         float* __restrict__ db32, float* __restrict__ dc32,
                         T* __restrict__ dbo, T* __restrict__ dco, int heads,
                         int s_len, int q_len, int n_st, int p_dim) {
  const int pp = p_dim + 4, np = n_st + 1, qp = q_len + 1;
  const int nw = n_st >= 32 ? n_st / 32 : 1;
  const int seg = n_st >= 32 ? 32 : n_st;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [Q][pp]
  float* dys = xs + q_len * pp;                 // [Q][pp]
  float* ss = dys + q_len * pp;                 // [N][pp] S_c
  float* ds = ss + n_st * pp;                   // [N][pp] D
  float* bs = ds + n_st * pp;                   // [Q][np] B
  float* cs = bs + q_len * np;                  // [Q][np] C
  float* g = cs + q_len * np;                   // [Q][qp] C B^T, lower
  float* mt = g + q_len * qp;                   // [Q][qp] M
  float* et = mt + q_len * qp;                  // [Q][qp] E
  float* lc = et + q_len * qp;                  // [Q]
  float* el = lc + q_len;                       // [Q] exp(l)
  float* dec = el + q_len;                      // [Q] exp(l_Q - l)
  float* dtv = dec + q_len;                     // [Q]
  float* dl = dtv + q_len;                      // [Q]
  float* wj = dl + q_len;                       // [Q]
  float* part1 = wj + q_len;                    // [Q][nw] C . V
  float* part2 = part1 + q_len * nw;            // [Q][nw] dBt . B
  float* part3 = part2 + q_len * nw;            // [Q][nw] B . W

  const int nc = (s_len + q_len - 1) / q_len;
  const int64_t b = blockIdx.x / nc;
  const int c = blockIdx.x % nc;
  const int t0 = c * q_len;
  const int tid = threadIdx.x;
  const int p4 = p_dim / 4;
  const int qn = q_len * n_st;
  const int qn_iters = (qn + kChunkThreads - 1) / kChunkThreads;
  const int64_t per_chunk = static_cast<int64_t>(n_st) * p_dim;
  const int64_t row0 = b * s_len + t0;  // first [B, S, N] row of the chunk

  for (int i = tid; i < qn; i += kChunkThreads) {
    const int t = i / n_st;
    const int n = i % n_st;
    const bool ok = t0 + t < s_len;
    bs[t * np + n] = ok ? to_f32(bmat[row0 * n_st + i]) : 0.f;
    cs[t * np + n] = ok ? to_f32(cmat[row0 * n_st + i]) : 0.f;
  }
  __syncthreads();
  for (int item = tid; item < q_len * q_len; item += kChunkThreads) {
    const int i = item / q_len;
    const int j = item % q_len;
    float acc = 0.f;
    if (j <= i) {
      for (int n = 0; n < n_st; ++n) acc = fmaf(cs[i * np + n], bs[j * np + n], acc);
    }
    g[i * qp + j] = acc;
  }

  for (int hh = 0; hh < heads; ++hh) {
    const int64_t bh = b * heads + hh;
    const int64_t seq0 = bh * s_len + t0;  // first [B*H, S] step of the chunk
    __syncthreads();  // the previous head's tiles and stages are consumed
    for (int i = tid; i < q_len * p_dim; i += kChunkThreads) {
      const int t = i / p_dim;
      const int p = i % p_dim;
      const bool ok = t0 + t < s_len;
      xs[t * pp + p] = ok ? to_f32(x[seq0 * p_dim + i]) : 0.f;
      dys[t * pp + p] = ok ? to_f32(dy[seq0 * p_dim + i]) : 0.f;
    }
    for (int i = tid; i < q_len; i += kChunkThreads) {
      const bool ok = t0 + i < s_len;
      dtv[i] = ok ? dt[seq0 + i] : 0.f;
      lc[i] = ok ? a_log[seq0 + i] : 0.f;
    }
    const float* s_c = sbuf + (bh * nc + c) * per_chunk;
    const float* d_c = dbuf + (bh * nc + c) * per_chunk;
    for (int i = tid; i < n_st * p_dim; i += kChunkThreads) {
      const int n = i / p_dim;
      const int p = i % p_dim;
      ss[n * pp + p] = s_c[i];
      ds[n * pp + p] = d_c[i];
    }
    __syncthreads();
    chunk_cumsum(lc, q_len, tid);
    __syncthreads();
    const float l_end = lc[q_len - 1];
    for (int i = tid; i < q_len; i += kChunkThreads) {
      el[i] = expf(lc[i]);
      dec[i] = expf(l_end - lc[i]);
    }
    // M_ij = (C_i . B_j) dt_j L_ij, E_ij = (dy_i . x_j) L_ij for j <= i
    for (int item = tid; item < q_len * q_len; item += kChunkThreads) {
      const int i = item / q_len;
      const int j = item % q_len;
      float m = 0.f, e = 0.f;
      if (j <= i) {
        const float decay = expf(lc[i] - lc[j]);
        m = g[i * qp + j] * dtv[j] * decay;
        e = dot4(dys + i * pp, xs + j * pp, p4) * decay;
      }
      mt[i * qp + j] = m;
      et[i * qp + j] = e;
    }
    __syncthreads();
    if (tid < q_len) {  // dl_i = sum_j R_ij - sum_k R_ki, R = E o C Bt^T
      const int i = tid;
      float rs = 0.f, cs_sum = 0.f;
      for (int j = 0; j < i; ++j) rs += et[i * qp + j] * g[i * qp + j] * dtv[j];
      for (int k = i + 1; k < q_len; ++k) {
        cs_sum += et[k * qp + i] * g[k * qp + i] * dtv[i];
      }
      dl[i] = rs - cs_sum;
    }
    // dC_i = sum_j E_ij dt_j B_j + exp(l_i) S_c dy_i; C_i . S_c dy_i for dl
    for (int k = 0; k < qn_iters; ++k) {
      const int item = tid + k * kChunkThreads;
      const bool on = item < qn;
      const int i = on ? item / n_st : 0;
      const int n = item % n_st;
      float r = 0.f;
      if (on) {
        const float v = dot4(ss + n * pp, dys + i * pp, p4);
        float intra = 0.f;
        for (int j = 0; j <= i; ++j) {
          intra = fmaf(et[i * qp + j] * dtv[j], bs[j * np + n], intra);
        }
        const float dcv = intra + el[i] * v;
        if (t0 + i < s_len) {
          float* acc = dc32 + (row0 + i) * n_st + n;
          *acc = hh ? *acc + dcv : dcv;
        }
        r = cs[i * np + n] * v;
      }
      r = segment_sum(r, seg);
      if (on && n % seg == 0) part1[i * nw + n / seg] = r;
    }
    // dBt_j = sum_i E_ij C_i + exp(l_Q - l_j) D x_j; dB_j += dt_j dBt_j
    for (int k = 0; k < qn_iters; ++k) {
      const int item = tid + k * kChunkThreads;
      const bool on = item < qn;
      const int j = on ? item / n_st : 0;
      const int n = item % n_st;
      float r2 = 0.f, r3 = 0.f;
      if (on) {
        float intra = 0.f;
        for (int i = j; i < q_len; ++i) {
          intra = fmaf(et[i * qp + j], cs[i * np + n], intra);
        }
        const float wv = dot4(ds + n * pp, xs + j * pp, p4);
        const float dbt = intra + dec[j] * wv;
        if (t0 + j < s_len) {
          float* acc = db32 + (row0 + j) * n_st + n;
          *acc = hh ? *acc + dtv[j] * dbt : dtv[j] * dbt;
        }
        r2 = dbt * bs[j * np + n];
        r3 = wv * bs[j * np + n];
      }
      r2 = segment_sum(r2, seg);
      r3 = segment_sum(r3, seg);
      if (on && n % seg == 0) {
        part2[j * nw + n / seg] = r2;
        part3[j * nw + n / seg] = r3;
      }
    }
    __syncthreads();
    if (tid < q_len) {
      const int i = tid;
      float s1 = 0.f, s2 = 0.f, s3 = 0.f;
      for (int w = 0; w < nw; ++w) {
        s1 += part1[i * nw + w];
        s2 += part2[i * nw + w];
        s3 += part3[i * nw + w];
      }
      const float w_i = dec[i] * dtv[i] * s3;
      wj[i] = w_i;
      dl[i] = dl[i] + el[i] * s1 - w_i;
      if (t0 + i < s_len) ddt[seq0 + i] = s2;
    }
    __syncthreads();
    if (tid == 0) {  // dl_Q's state terms, then da_log from the chunk's end
      float wsum = 0.f;
      for (int j = 0; j < q_len; ++j) wsum += wj[j];
      dl[q_len - 1] += wsum + sdot[bh * nc + c];
      float run = 0.f;
      for (int k = q_len - 1; k >= 0; --k) {
        run += dl[k];
        if (t0 + k < s_len) da[seq0 + k] = run;
      }
    }
    // dx_j = sum_i M_ij dy_i + exp(l_Q - l_j) dt_j D^T B_j
    for (int item = tid; item < q_len * p4; item += kChunkThreads) {
      const int j = item / p4;
      const int p = (item % p4) * 4;
      if (t0 + j >= s_len) continue;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int i = j; i < q_len; ++i) {
        fma4(mt[i * qp + j], *reinterpret_cast<const float4*>(dys + i * pp + p), acc);
      }
      float4 st = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int n = 0; n < n_st; ++n) {
        fma4(bs[j * np + n], *reinterpret_cast<const float4*>(ds + n * pp + p), st);
      }
      const float f = dec[j] * dtv[j];
      T* o = dx + (seq0 + j) * p_dim + p;
      o[0] = from_f32<T>(fmaf(f, st.x, acc.x));
      o[1] = from_f32<T>(fmaf(f, st.y, acc.y));
      o[2] = from_f32<T>(fmaf(f, st.z, acc.z));
      o[3] = from_f32<T>(fmaf(f, st.w, acc.w));
    }
  }
  // the head sums, each element by the thread that added it up
  for (int item = tid; item < qn; item += kChunkThreads) {
    const int t = item / n_st;
    if (t0 + t >= s_len) continue;
    const int64_t at = row0 * n_st + item;
    dbo[at] = from_f32<T>(db32[at]);
    dco[at] = from_f32<T>(dc32[at]);
  }
}

template <typename T>
int launch_states(const void* x, const void* dy, const float* dt,
                  const float* a_log, const void* bm, const void* cm, float* sbuf,
                  float* dbuf, float* sdot, int64_t bh, int heads, int s_len,
                  int q_len, int n_st, int p_dim, cudaStream_t stream) {
  const size_t smem = states_smem_floats(q_len, n_st, p_dim) * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_bwd_states_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_states_kernel<T><<<static_cast<unsigned>(bh), kStateThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), dt, a_log,
      static_cast<const T*>(bm), static_cast<const T*>(cm), sbuf, dbuf, sdot,
      heads, s_len, q_len, n_st, p_dim);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_chunks(const void* x, const void* dy, const float* dt,
                  const float* a_log, const void* bm, const void* cm,
                  const float* sbuf, const float* dbuf, const float* sdot,
                  void* dx, float* ddt, float* da, float* db32, float* dc32,
                  void* dbo, void* dco, int64_t blocks, int heads, int s_len,
                  int q_len, int n_st, int p_dim, cudaStream_t stream) {
  const size_t smem = chunk_smem_floats(q_len, n_st, p_dim) * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_bwd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_chunk_kernel<T><<<static_cast<unsigned>(blocks), kChunkThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), dt, a_log,
      static_cast<const T*>(bm), static_cast<const T*>(cm), sbuf, dbuf, sdot,
      static_cast<T*>(dx), ddt, da, db32, dc32, static_cast<T*>(dbo),
      static_cast<T*>(dco), heads, s_len, q_len, n_st, p_dim);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int64_t batch, int heads, int s_len, int q_len, int n_st,
               int p_dim) {
  const int64_t nc = q_len > 0 ? (s_len + q_len - 1) / q_len : 0;
  return batch < 0 || heads < 1 || s_len < 0 || q_len < 1 || n_st < 1 ||
         n_st > kChunkThreads || (n_st & (n_st - 1)) != 0 || p_dim < 4 ||
         p_dim % 4 != 0 || batch * heads > 0x7fffffffLL ||
         batch * nc > 0x7fffffffLL;
}


// ---------------------------------------------------------------------------
// The tensor-core route: ssd_bwd_tc_states_kernel, ssd_bwd_tc_grads_kernel
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kQMax = 64;               // the route's chunk: four row blocks of 16
constexpr int kPS = 32;                 // head-dim columns per states block
constexpr int kVPitch = (kPS + 8) * 2;  // bytes a row of a states block's x / dy
constexpr int kStages = 2;              // a states block's chunks in flight
constexpr float kLog2e = 1.4426950408889634f;

// The operands at their element strides (b, h, s for x, dy, dt, a_log; b, s
// for B and C; unit stride along P and N), the state scratch and the
// gradients (contiguous).
struct Args {
  const bf16* x;
  const bf16* dy;
  const bf16* bm;
  const bf16* cm;
  const float* dt;
  const float* al;
  int64_t x_sb, x_sh, x_ss;
  int64_t dy_sb, dy_sh, dy_ss;
  int64_t dt_sb, dt_sh, dt_ss;
  int64_t al_sb, al_sh, al_ss;
  int64_t b_sb, b_ss, c_sb, c_ss;
  bf16* sbuf;  // [B*H][nc][2][N][P]: S_c entering chunk c, as hi then lo
  bf16* dbuf;  // [B*H][nc][2][N][P]: D_c, the gradient of the state leaving c
  bf16* dx;    // [B*H][S][P]
  float* ddt;  // [B*H][S]
  float* da;   // [B*H][S]
  bf16* db;    // [B][S][N]
  bf16* dc;    // [B][S][N]
  int heads, s_len, q_len, p_dim;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from src, or zeros where !ok (src is then not read)
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
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
__device__ __forceinline__ void ldsm_x2(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
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
// a 16 x 16 accumulator tile (two n8 tiles) as the hi and lo A fragments
__device__ __forceinline__ void split_tile(const float (&t)[2][4], uint32_t (&ah)[4],
                                           uint32_t (&al)[4]) {
  split(t[0][0], t[0][1], ah[0], al[0]);
  split(t[0][2], t[0][3], ah[1], al[1]);
  split(t[1][0], t[1][1], ah[2], al[2]);
  split(t[1][2], t[1][3], ah[3], al[3]);
}

// Rows [0, rows) of a bf16 tile of `cols` columns (a multiple of 8), row t
// at src + t * stride, into shared memory at dst, `pitch` bytes a row; rows
// at or past `valid` read as zeros.
__device__ __forceinline__ void load_rows(uint32_t dst, int pitch, const bf16* src,
                                          int64_t stride, int rows, int valid,
                                          int cols) {
  const int per = cols / 8;
  for (int i = threadIdx.x; i < rows * per; i += kThreads) {
    const int t = i / per;
    const int k = i - t * per;
    const bool ok = t < valid;
    cp16(dst + t * pitch + k * 16, ok ? src + t * stride + k * 8 : src, ok);
  }
}
// `rows` f32 steps at src + t * stride into dst; past `valid` zeros
__device__ __forceinline__ void load_steps(float* dst, const float* src,
                                           int64_t stride, int rows, int valid) {
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    const bool ok = i < valid;
    cp4(smem_u32(dst + i), ok ? src + i * stride : src, ok);
  }
}

// The chunk's inclusive cumsum of a_log in log2 units at steps 2 lane and
// 2 lane + 1 (zero past q <= 64), and its total l_Q log2(e), in one warp.
__device__ __forceinline__ float2 cumsum2(const float* al, int q, int lane,
                                          float& total) {
  const int i = 2 * lane;
  const float a0 = i < q ? al[i] : 0.f;
  const float a1 = i + 1 < q ? al[i + 1] : 0.f;
  const float run = a0 + a1;
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float other = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += other;
  }
  total = __shfl_sync(0xffffffffu, incl, 31) * kLog2e;
  return make_float2((incl - run + a0) * kLog2e, incl * kLog2e);
}

// A fragment of rows [r0, r0 + 16), columns [k0, k0 + 16) of an [M][K] tile
// (K contiguous, `pitch` bytes a row)
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], uint32_t base, int pitch,
                                       int r0, int k0, int lane) {
  ldsm_x4(a, base + (r0 + (lane & 15)) * pitch + (k0 + (lane >> 4) * 8) * 2);
}
// B fragments (b[2u], b[2u + 1]) of T n8 tiles, columns col0 + 8u.., over
// rows [k0, k0 + 16) of a [K][N] tile (N contiguous)
template <int T>
__device__ __forceinline__ void frag_b_kn(uint32_t* b, uint32_t base, int pitch,
                                          int k0, int col0, int lane) {
#pragma unroll
  for (int u = 0; u + 1 < T; u += 2) {
    ldsm_x4_t(b + 2 * u, base + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * pitch +
                             (col0 + u * 8 + (lane >> 4) * 8) * 2);
  }
  if (T & 1) {
    ldsm_x2_t(b + 2 * (T - 1), base + (k0 + (lane & 15)) * pitch + (col0 + (T - 1) * 8) * 2);
  }
}
// B fragments of T n8 tiles, rows row0 + 8u.. of an [N][K] tile (K
// contiguous), over columns [k0, k0 + 16)
template <int T>
__device__ __forceinline__ void frag_b_nk(uint32_t* b, uint32_t base, int pitch,
                                          int k0, int row0, int lane) {
#pragma unroll
  for (int u = 0; u + 1 < T; u += 2) {
    ldsm_x4(b + 2 * u, base + (row0 + u * 8 + (lane & 7) + (lane >> 4) * 8) * pitch +
                           (k0 + ((lane >> 3) & 1) * 8) * 2);
  }
  if (T & 1) {
    ldsm_x2(b + 2 * (T - 1), base + (row0 + (T - 1) * 8 + (lane & 7)) * pitch +
                                 (k0 + ((lane >> 3) & 1) * 8) * 2);
  }
}

// acc (T n8 tiles) += a b for one k step
template <int T>
__device__ __forceinline__ void mma_row(float (&acc)[T][4], const uint32_t* a,
                                        const uint32_t* b) {
#pragma unroll
  for (int u = 0; u < T; ++u) mma(acc[u], a, b[2 * u], b[2 * u + 1]);
}

template <int T>
__device__ __forceinline__ void zero(float (&acc)[T][4]) {
#pragma unroll
  for (int u = 0; u < T; ++u) acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
// sums over the four lanes of a fragment row, and over the eight lanes of a column
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float col_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// Per lane, sum over its columns of acc o M for its rows g and g + 8 of
// the 16-row block at r0; M bf16 in shared memory ([rows][N], `pitch`
// bytes a row), the tiles at columns col0 + 8u
template <int T>
__device__ __forceinline__ float2 dot_rows(const float (&acc)[T][4], const uint8_t* m,
                                           int pitch, int r0, int col0, int lane) {
  const int g = lane >> 2;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int u = 0; u < T; ++u) {
    const int col = col0 + u * 8 + 2 * (lane & 3);
    const float2 v0 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(m + (r0 + g) * pitch + col * 2));
    const float2 v1 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(m + (r0 + g + 8) * pitch + col * 2));
    s0 += acc[u][0] * v0.x + acc[u][1] * v0.y;
    s1 += acc[u][2] * v1.x + acc[u][3] * v1.y;
  }
  return make_float2(row_sum(s0), row_sum(s1));
}

// S = decay S + (w o W)^T V over the chunk's n_rb blocks of 16 steps, for
// state rows [16 nb, 16 nb + 16) and the block's 32 head-dim columns: W
// (B or C, [Q][N] at wpitch bytes a row), V (x or dy, [Q][32]), w the
// per-step weights; w o W goes in as bf16 hi + lo.
__device__ __forceinline__ void state_pass(float (&st)[kPS / 8][4], uint32_t vb,
                                           uint32_t wb, int wpitch, const float* wt,
                                           float decay, int nb, int n_rb, int lane) {
  const int t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < kPS / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) st[j][e] *= decay;
  }
  for (int kb = 0; kb < n_rb; ++kb) {
    uint32_t bt[4];  // A = W^T: rows n, columns t
    ldsm_x4_t(bt, wb + (kb * 16 + (lane >> 4) * 8 + (lane & 7)) * wpitch +
                      (nb * 16 + ((lane >> 3) & 1) * 8) * 2);
    uint32_t vf[8];
    frag_b_kn<4>(vf, vb, kVPitch, kb * 16, 0, lane);
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
    mma_row<kPS / 8>(st, ah, vf);
    mma_row<kPS / 8>(st, al, vf);
  }
}

// Within each quad of lanes (one fragment row), lane t4 holds in x[j] a
// pair of columns of n8 tile j; returns on lane t4 the four pairs of tile t4
// (columns 8 t4 .. 8 t4 + 7 in order), so that one 16-byte store writes them.
__device__ __forceinline__ uint4 quad_transpose(const uint32_t (&x)[4], int lane) {
  const int t4 = lane & 3;
  uint32_t y[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int send = (t4 + s) & 3;  // to lane (t4 + s) & 3, the pair of its tile
    const uint32_t v = send == 0 ? x[0] : send == 1 ? x[1] : send == 2 ? x[2] : x[3];
    const int from = (t4 - s) & 3;  // from lane `from`, its pair of my tile
    const uint32_t got = __shfl_sync(0xffffffffu, v, (lane & ~3) + from);
    if (from == 0) y[0] = got;
    if (from == 1) y[1] = got;
    if (from == 2) y[2] = got;
    if (from == 3) y[3] = got;
  }
  return make_uint4(y[0], y[1], y[2], y[3]);
}

// State rows [16 nb, 16 nb + 16), columns [p0, p0 + 32) as bf16 hi at `hi`
// and lo at hi + np ([N][P] each), 16 bytes a store
__device__ __forceinline__ void store_state(const float (&st)[kPS / 8][4], bf16* hi,
                                            int64_t np, int p_dim, int nb, int p0,
                                            int lane) {
  uint32_t h0[4], l0[4], h1[4], l1[4];  // rows n0 and n0 + 8
#pragma unroll
  for (int j = 0; j < kPS / 8; ++j) {
    split(st[j][0], st[j][1], h0[j], l0[j]);
    split(st[j][2], st[j][3], h1[j], l1[j]);
  }
  const int64_t at = static_cast<int64_t>(nb * 16 + (lane >> 2)) * p_dim + p0 + 8 * (lane & 3);
  const int64_t down = 8 * static_cast<int64_t>(p_dim);  // row n0 + 8
  *reinterpret_cast<uint4*>(hi + at) = quad_transpose(h0, lane);
  *reinterpret_cast<uint4*>(hi + np + at) = quad_transpose(l0, lane);
  *reinterpret_cast<uint4*>(hi + at + down) = quad_transpose(h1, lane);
  *reinterpret_cast<uint4*>(hi + np + at + down) = quad_transpose(l1, lane);
}

template <int NK>
__host__ __device__ constexpr int states_stage_bytes() {
  return kQMax * kVPitch + kQMax * (16 * NK + 8) * 2 + 2 * kQMax * 4;
}
template <int NK>
__host__ __device__ constexpr int states_smem_bytes() {
  return kStages * states_stage_bytes<NK>() + kWarps * kQMax * 4;
}

// NK: the state's 16-row blocks (N / 16). One block per (b, h, pass, 32
// head-dim columns); pass 0 walks the chunks forward writing S_c, pass 1
// backward writing D_c. Warp w carries state rows [16 w, 16 w + 16).
template <int NK>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_tc_states_kernel(const Args a) {
  constexpr int kN = 16 * NK;
  constexpr int kWPitch = (kN + 8) * 2;
  constexpr int kStage = states_stage_bytes<NK>();
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* wts = reinterpret_cast<float*>(smem + kStages * kStage) + warp * kQMax;

  const int q = a.q_len;
  const int nc = (a.s_len + q - 1) / q;
  const int splits = a.p_dim / kPS;
  int idx = blockIdx.x;
  const int p0 = (idx % splits) * kPS;
  idx /= splits;
  const bool rev = idx & 1;
  const int64_t bh = idx >> 1;
  const int64_t b = bh / a.heads;
  const int64_t h = bh % a.heads;
  const bf16* vsrc = rev ? a.dy + b * a.dy_sb + h * a.dy_sh + p0
                         : a.x + b * a.x_sb + h * a.x_sh + p0;
  const int64_t vss = rev ? a.dy_ss : a.x_ss;
  const bf16* wsrc = rev ? a.cm + b * a.c_sb : a.bm + b * a.b_sb;
  const int64_t wss = rev ? a.c_ss : a.b_ss;
  const float* dtb = a.dt + b * a.dt_sb + h * a.dt_sh;
  const float* alb = a.al + b * a.al_sb + h * a.al_sh;
  const int64_t np = static_cast<int64_t>(kN) * a.p_dim;
  bf16* out = (rev ? a.dbuf : a.sbuf) + bh * nc * 2 * np;

  auto load = [&](int st, int c) {
    uint8_t* base = smem + st * kStage;
    const int64_t t0 = static_cast<int64_t>(c) * q;
    const int valid = a.s_len - c * q;
    load_rows(smem_u32(base), kVPitch, vsrc + t0 * vss, vss, q, valid, kPS);
    load_rows(smem_u32(base + kQMax * kVPitch), kWPitch, wsrc + t0 * wss, wss, q,
              valid, kN);
    float* f = reinterpret_cast<float*>(base + kQMax * kVPitch + kQMax * kWPitch);
    load_steps(f, dtb + t0 * a.dt_ss, a.dt_ss, q, valid);
    load_steps(f + kQMax, alb + t0 * a.al_ss, a.al_ss, q, valid);
    cp_commit();
  };

  float st[kPS / 8][4];
  zero<kPS / 8>(st);
  const int n_rb = q / 16;
  auto chunk = [&](int k) { return rev ? nc - 1 - k : k; };  // the k-th chunk walked
  load(0, chunk(0));
  for (int k = 0; k < nc; ++k) {
    const int c = chunk(k);
    if (k + 1 < nc) {
      load((k + 1) % kStages, chunk(k + 1));
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // chunk c landed in stage k % kStages
    uint8_t* base = smem + (k % kStages) * kStage;
    const float* f = reinterpret_cast<const float*>(base + kQMax * kVPitch + kQMax * kWPitch);
    float total;
    const float2 l = cumsum2(f + kQMax, q, lane, total);
    const int i = 2 * lane;
    if (i < q) {  // pass 0: dt exp(l_Q - l); pass 1: exp(l)
      wts[i] = rev ? exp2f(l.x) : f[i] * exp2f(total - l.x);
      wts[i + 1] = rev ? exp2f(l.y) : f[i + 1] * exp2f(total - l.y);
    }
    __syncwarp();
    if (warp < NK) {
      store_state(st, out + static_cast<int64_t>(c) * 2 * np, np, a.p_dim, warp, p0,
                  lane);
      if (k + 1 < nc) {
        state_pass(st, smem_u32(base), smem_u32(base + kQMax * kVPitch), kWPitch, wts,
                   exp2f(total), warp, n_rb, lane);
      }
    }
    __syncthreads();  // stage k % kStages consumed before it is refilled
  }
}

// one head's x, dy [Q][P], S_c and D as hi, lo [N][P], dt and a_log [Q]
template <int NK, int PK>
__host__ __device__ constexpr int grads_head_bytes() {
  return 2 * kQMax * (32 * PK + 8) * 2 + 4 * (16 * NK) * (32 * PK + 8) * 2 + 2 * kQMax * 4;
}
template <int NK, int PK>
__host__ __device__ constexpr int grads_smem_bytes() {
  return 2 * kQMax * (16 * NK + 8) * 2 + 2 * grads_head_bytes<NK, PK>() +
         (14 * kQMax + kWarps) * 4;
}

// NK: N / 16; PK: P / 32. One block per (b, chunk), walking the heads in
// order. Warp w owns row block r = w % 4 of the chunk and half hf = w / 4 of
// the columns of each output: dx's P, dB's and dC's N.
template <int NK, int PK>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_tc_grads_kernel(const Args a) {
  constexpr int kN = 16 * NK;
  constexpr int kP = 32 * PK;
  constexpr int kNP = (kN + 8) * 2;  // bytes a row of B, C
  constexpr int kPP = (kP + 8) * 2;  // bytes a row of x, dy, S, D
  constexpr int NT = NK;             // n8 tiles in half of N
  constexpr int PT = 2 * PK;         // n8 tiles in half of P
  constexpr int kHead = grads_head_bytes<NK, PK>();
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* bs = smem;                        // [Q][N] B
  uint8_t* cs = bs + kQMax * kNP;            // [Q][N] C
  uint8_t* heads = cs + kQMax * kNP;         // two heads' operands, in turn
  float* l2 = reinterpret_cast<float*>(heads + 2 * kHead);  // [Q] l log2(e)
  float* el = l2 + kQMax;                    // [Q] exp(l)
  float* dec = el + kQMax;                   // [Q] exp(l_Q - l)
  float* rsum = dec + kQMax;                 // [Q] sum_i R_ij (row j)
  float* csum = rsum + kQMax;                // [4][Q] sum_j R_ij by j block
  float* wsum = csum + 4 * kQMax;            // [2][Q] B_j . (D x_j) by half
  float* dds = wsum + 2 * kQMax;             // [2][Q] dB~_j . B_j by half
  float* cvs = dds + 2 * kQMax;              // [2][Q] C_i . (S_c dy_i) by half
  float* red = cvs + 2 * kQMax;              // [kWarps] <D, S_c> partials
  const uint32_t b_u = smem_u32(bs), c_u = smem_u32(cs);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int q = a.q_len;
  const int n_rb = q / 16;
  const int nc = (a.s_len + q - 1) / q;
  const int64_t b = blockIdx.x / nc;
  const int c = blockIdx.x % nc;
  const int t0 = c * q;
  const int valid = a.s_len - t0;
  const int64_t np = static_cast<int64_t>(kN) * kP;
  const int r = warp & 3;    // my row block
  const int hf = warp >> 2;  // my half of the columns
  const bool active = r < n_rb;
  const int j0 = r * 16 + g;  // my fragment rows j0, j0 + 8
  const int j1 = j0 + 8;

  // Issues the loads of head hh's operands into head buffer `buf`: x, dy
  // [Q][P], S_c and D as hi, lo [N][P] each, dt and a_log [Q]; one group
  // (with B and C for the first head).
  auto load_head = [&](int hh, int buf) {
    uint8_t* hb = heads + buf * kHead;
    const uint32_t at = smem_u32(hb);
    const int64_t bh = b * a.heads + hh;
    const int64_t st = (bh * nc + c) * 2 * np;
    load_rows(at, kPP, a.x + b * a.x_sb + hh * a.x_sh + t0 * a.x_ss, a.x_ss, q, valid, kP);
    load_rows(at + kQMax * kPP, kPP, a.dy + b * a.dy_sb + hh * a.dy_sh + t0 * a.dy_ss,
              a.dy_ss, q, valid, kP);
    load_rows(at + 2 * kQMax * kPP, kPP, a.sbuf + st, kP, 2 * kN, 2 * kN, kP);
    load_rows(at + 2 * kQMax * kPP + 2 * kN * kPP, kPP, a.dbuf + st, kP, 2 * kN, 2 * kN,
              kP);
    float* f = reinterpret_cast<float*>(hb + 2 * kQMax * kPP + 4 * kN * kPP);
    load_steps(f, a.dt + b * a.dt_sb + hh * a.dt_sh + t0 * a.dt_ss, a.dt_ss, q, valid);
    load_steps(f + kQMax, a.al + b * a.al_sb + hh * a.al_sh + t0 * a.al_ss, a.al_ss, q,
               valid);
    cp_commit();
  };

  load_rows(b_u, kNP, a.bm + b * a.b_sb + t0 * a.b_ss, a.b_ss, q, valid, kN);
  load_rows(c_u, kNP, a.cm + b * a.c_sb + t0 * a.c_ss, a.c_ss, q, valid, kN);
  load_head(0, 0);

  // head sums of dB and dC over my rows and half of N
  float dbh[NT][4], dch[NT][4];
  zero<NT>(dbh);
  zero<NT>(dch);

  for (int hh = 0; hh < a.heads; ++hh) {
    const int64_t bh = b * a.heads + hh;
    const int64_t row0 = bh * a.s_len + t0;  // first [B*H, S] step of the chunk
    if (hh + 1 < a.heads) {  // the next head's loads overlap this head's work
      load_head(hh + 1, (hh + 1) & 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // the head's operands landed
    uint8_t* xs = heads + (hh & 1) * kHead;  // [Q][P] x
    uint8_t* sh = xs + 2 * kQMax * kPP;      // [N][P] S_c hi, then lo, D hi, D lo
    const float* dtv = reinterpret_cast<const float*>(sh + 4 * kN * kPP);  // [Q] dt
    const float* alv = dtv + kQMax;          // [Q] a_log
    const uint32_t x_u = smem_u32(xs), y_u = x_u + kQMax * kPP;
    const uint32_t sh_u = smem_u32(sh), sl_u = sh_u + kN * kPP,
                   dh_u = sh_u + 2 * kN * kPP, dl_u = sh_u + 3 * kN * kPP;
    if (warp == 0) {
      float total;
      const float2 l = cumsum2(alv, q, lane, total);
      const int i = 2 * lane;
      if (i < q) {
        l2[i] = l.x;
        l2[i + 1] = l.y;
        el[i] = exp2f(l.x);
        el[i + 1] = exp2f(l.y);
        dec[i] = exp2f(total - l.x);
        dec[i + 1] = exp2f(total - l.y);
      }
    }
    {  // <D, S_c>, each thread a fixed set of 8-element runs
      float part = 0.f;
      for (int e = tid; e < kN * kP / 8; e += kThreads) {
        const int n = e / (kP / 8);
        const int off = n * kPP + (e - n * (kP / 8)) * 16;
        const uint4 sv[4] = {*reinterpret_cast<const uint4*>(sh + off),
                             *reinterpret_cast<const uint4*>(sh + kN * kPP + off),
                             *reinterpret_cast<const uint4*>(sh + 2 * kN * kPP + off),
                             *reinterpret_cast<const uint4*>(sh + 3 * kN * kPP + off)};
        const uint32_t* w = reinterpret_cast<const uint32_t*>(sv);
#pragma unroll
        for (int k = 0; k < 4; ++k) {  // S = hi + lo, D = hi + lo
          const float2 s0 = unpack(w[k]), s1 = unpack(w[4 + k]);
          const float2 d0 = unpack(w[8 + k]), d1 = unpack(w[12 + k]);
          part = fmaf(s0.x + s1.x, d0.x + d1.x, part);
          part = fmaf(s0.y + s1.y, d0.y + d1.y, part);
        }
      }
      part = warp_sum(part);
      if (lane == 0) red[warp] = part;
    }
    __syncthreads();  // l2, el, dec and the partials written

    if (active) {
      const float dt0 = dtv[j0], dt1 = dtv[j1];
      const float lj0 = l2[j0], lj1 = l2[j1];
      // ---- rows j: dx and dB~ ----
      // dx = exp(l_Q - l_j) dt_j (B_j D) + sum_i M_ij dy_i over my half of P
      float dxa[PT][4];
      zero<PT>(dxa);
#pragma unroll
      for (int ks = 0; ks < NK; ++ks) {
        uint32_t af[4], fh[2 * PT], fl[2 * PT];
        frag_a(af, b_u, kNP, r * 16, ks * 16, lane);
        frag_b_kn<PT>(fh, dh_u, kPP, ks * 16, hf * (kP / 2), lane);
        frag_b_kn<PT>(fl, dl_u, kPP, ks * 16, hf * (kP / 2), lane);
        mma_row<PT>(dxa, af, fh);
        mma_row<PT>(dxa, af, fl);
      }
      {
        const float f0 = dec[j0] * dt0, f1 = dec[j1] * dt1;
#pragma unroll
        for (int u = 0; u < PT; ++u) {
          dxa[u][0] *= f0;
          dxa[u][1] *= f0;
          dxa[u][2] *= f1;
          dxa[u][3] *= f1;
        }
      }
      // W = x_j D^T over my half of N; w_j's part B_j . W_j; dB~ starts at
      // exp(l_Q - l_j) W
      float dbt[NT][4];
      zero<NT>(dbt);
#pragma unroll
      for (int ks = 0; ks < 2 * PK; ++ks) {
        uint32_t af[4], fh[2 * NT], fl[2 * NT];
        frag_a(af, x_u, kPP, r * 16, ks * 16, lane);
        frag_b_nk<NT>(fh, dh_u, kPP, ks * 16, hf * (kN / 2), lane);
        frag_b_nk<NT>(fl, dl_u, kPP, ks * 16, hf * (kN / 2), lane);
        mma_row<NT>(dbt, af, fh);
        mma_row<NT>(dbt, af, fl);
      }
      {
        const float2 w = dot_rows<NT>(dbt, bs, kNP, r * 16, hf * (kN / 2), lane);
        if (t4 == 0) {
          wsum[hf * kQMax + j0] = w.x;
          wsum[hf * kQMax + j1] = w.y;
        }
        const float f0 = dec[j0], f1 = dec[j1];
#pragma unroll
        for (int u = 0; u < NT; ++u) {
          dbt[u][0] *= f0;
          dbt[u][1] *= f0;
          dbt[u][2] *= f1;
          dbt[u][3] *= f1;
        }
      }
      // the intra-chunk terms, over the column blocks i >= j of the tiles
      // G^T = B C^T and E'^T = x dy^T (rows j, columns i)
      float rs0 = 0.f, rs1 = 0.f;
      for (int ib = r; ib < n_rb; ++ib) {
        float gt[2][4], et[2][4];
        zero<2>(gt);
        zero<2>(et);
#pragma unroll
        for (int ks = 0; ks < NK; ++ks) {
          uint32_t af[4], bf[4];
          frag_a(af, b_u, kNP, r * 16, ks * 16, lane);
          frag_b_nk<2>(bf, c_u, kNP, ks * 16, ib * 16, lane);
          mma_row<2>(gt, af, bf);
        }
#pragma unroll
        for (int ks = 0; ks < 2 * PK; ++ks) {
          uint32_t af[4], bf[4];
          frag_a(af, x_u, kPP, r * 16, ks * 16, lane);
          frag_b_nk<2>(bf, y_u, kPP, ks * 16, ib * 16, lane);
          mma_row<2>(et, af, bf);
        }
        // M^T = G^T dt_j L, E^T = E'^T L, R^T = E^T G^T dt_j below the
        // diagonal; the exponent is selected, not masked (the exp
        // overflows where i < j)
        float cs2[2][2];
#pragma unroll
        for (int v = 0; v < 2; ++v) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = e < 2 ? j0 : j1;
            const int i = ib * 16 + v * 8 + 2 * t4 + (e & 1);
            const float dtj = e < 2 ? dt0 : dt1;
            const float lj = e < 2 ? lj0 : lj1;
            const float L = i >= j ? exp2f(l2[i] - lj) : 0.f;
            const float gv = gt[v][e] * dtj;
            const float ev = et[v][e] * L;
            const float rr = i > j ? ev * gv : 0.f;
            if (e < 2) {
              rs0 += rr;
            } else {
              rs1 += rr;
            }
            if (e < 2) {
              cs2[v][e] = rr;
            } else {
              cs2[v][e - 2] += rr;
            }
            gt[v][e] = gv * L;
            et[v][e] = ev;
          }
        }
        if (hf == 1) {  // the column sums (sum_j R_ij) of this warp's rows
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const float s0 = col_sum(cs2[v][0]);
            const float s1 = col_sum(cs2[v][1]);
            if (g == 0) {
              csum[r * kQMax + ib * 16 + v * 8 + 2 * t4] = s0;
              csum[r * kQMax + ib * 16 + v * 8 + 2 * t4 + 1] = s1;
            }
          }
        }
        uint32_t ah[4], al[4];
        {  // dx += M^T dy over the block's 16 steps i
          split_tile(gt, ah, al);
          uint32_t fy[2 * PT];
          frag_b_kn<PT>(fy, y_u, kPP, ib * 16, hf * (kP / 2), lane);
          mma_row<PT>(dxa, ah, fy);
          mma_row<PT>(dxa, al, fy);
        }
        {  // dB~ += E^T C
          split_tile(et, ah, al);
          uint32_t fc[2 * NT];
          frag_b_kn<NT>(fc, c_u, kNP, ib * 16, hf * (kN / 2), lane);
          mma_row<NT>(dbt, ah, fc);
          mma_row<NT>(dbt, al, fc);
        }
      }
      if (hf == 0) {
        rs0 = row_sum(rs0);
        rs1 = row_sum(rs1);
        if (t4 == 0) {
          rsum[j0] = rs0;
          rsum[j1] = rs1;
        }
      }
#pragma unroll
      for (int u = 0; u < PT; ++u) {
        const int col = hf * (kP / 2) + u * 8 + 2 * t4;
        if (j0 < valid) {
          *reinterpret_cast<__nv_bfloat162*>(a.dx + (row0 + j0) * kP + col) =
              __floats2bfloat162_rn(dxa[u][0], dxa[u][1]);
        }
        if (j1 < valid) {
          *reinterpret_cast<__nv_bfloat162*>(a.dx + (row0 + j1) * kP + col) =
              __floats2bfloat162_rn(dxa[u][2], dxa[u][3]);
        }
      }
      {  // ddt's part dB~_j . B_j; dB += dt_j dB~
        const float2 d = dot_rows<NT>(dbt, bs, kNP, r * 16, hf * (kN / 2), lane);
        if (t4 == 0) {
          dds[hf * kQMax + j0] = d.x;
          dds[hf * kQMax + j1] = d.y;
        }
#pragma unroll
        for (int u = 0; u < NT; ++u) {
          dbh[u][0] = fmaf(dt0, dbt[u][0], dbh[u][0]);
          dbh[u][1] = fmaf(dt0, dbt[u][1], dbh[u][1]);
          dbh[u][2] = fmaf(dt1, dbt[u][2], dbh[u][2]);
          dbh[u][3] = fmaf(dt1, dbt[u][3], dbh[u][3]);
        }
      }

      // ---- rows i (= j0, j1 here): dC ----
      // V = dy_i S_c^T over my half of N; C_i . V_i for dl; dC += exp(l_i) V
      {
        float vt[NT][4];
        zero<NT>(vt);
#pragma unroll
        for (int ks = 0; ks < 2 * PK; ++ks) {
          uint32_t af[4], fh[2 * NT], fl[2 * NT];
          frag_a(af, y_u, kPP, r * 16, ks * 16, lane);
          frag_b_nk<NT>(fh, sh_u, kPP, ks * 16, hf * (kN / 2), lane);
          frag_b_nk<NT>(fl, sl_u, kPP, ks * 16, hf * (kN / 2), lane);
          mma_row<NT>(vt, af, fh);
          mma_row<NT>(vt, af, fl);
        }
        const float2 cv = dot_rows<NT>(vt, cs, kNP, r * 16, hf * (kN / 2), lane);
        if (t4 == 0) {
          cvs[hf * kQMax + j0] = cv.x;
          cvs[hf * kQMax + j1] = cv.y;
        }
        const float e0 = el[j0], e1 = el[j1];
#pragma unroll
        for (int u = 0; u < NT; ++u) {
          dch[u][0] = fmaf(e0, vt[u][0], dch[u][0]);
          dch[u][1] = fmaf(e0, vt[u][1], dch[u][1]);
          dch[u][2] = fmaf(e1, vt[u][2], dch[u][2]);
          dch[u][3] = fmaf(e1, vt[u][3], dch[u][3]);
        }
      }
      // dC += (E o dt_j) B over the column blocks j <= i of E = E' L
      for (int jb = 0; jb <= r; ++jb) {
        float et[2][4];
        zero<2>(et);
#pragma unroll
        for (int ks = 0; ks < 2 * PK; ++ks) {
          uint32_t af[4], bf[4];
          frag_a(af, y_u, kPP, r * 16, ks * 16, lane);
          frag_b_nk<2>(bf, x_u, kPP, ks * 16, jb * 16, lane);
          mma_row<2>(et, af, bf);
        }
#pragma unroll
        for (int v = 0; v < 2; ++v) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e < 2 ? j0 : j1;
            const int j = jb * 16 + v * 8 + 2 * t4 + (e & 1);
            const float li = e < 2 ? lj0 : lj1;
            et[v][e] = j <= i ? et[v][e] * exp2f(li - l2[j]) * dtv[j] : 0.f;
          }
        }
        uint32_t ah[4], al[4];
        split_tile(et, ah, al);
        uint32_t fb[2 * NT];
        frag_b_kn<NT>(fb, b_u, kNP, jb * 16, hf * (kN / 2), lane);
        mma_row<NT>(dch, ah, fb);
        mma_row<NT>(dch, al, fb);
      }
    }
    __syncthreads();  // every row's parts written
    if (warp == 0) {  // per row t = 2 lane, 2 lane + 1: ddt, dl, then da_log
      const float dsum = warp_sum(lane < kWarps ? red[lane] : 0.f);  // <D, S_c>
      float dlv[2], wt2[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int t = 2 * lane + k;
        dlv[k] = wt2[k] = 0.f;
        if (t < q) {
          float cs_t = 0.f;
          for (int rb = 0; rb <= t / 16; ++rb) cs_t += csum[rb * kQMax + t];
          wt2[k] = dec[t] * dtv[t] * (wsum[t] + wsum[kQMax + t]);
          dlv[k] = cs_t - rsum[t] + el[t] * (cvs[t] + cvs[kQMax + t]) - wt2[k];
          if (t < valid) a.ddt[row0 + t] = dds[t] + dds[kQMax + t];
        }
      }
      // dl_Q's state terms: sum_j w_j + exp(l_Q) <D, S_c>
      const float wtot = warp_sum(wt2[0] + wt2[1]);
      if (2 * lane + 1 == q - 1) dlv[1] += wtot + exp2f(l2[q - 1]) * dsum;
      // da_log_t = sum of dl from t to the chunk's end
      const float pair = dlv[0] + dlv[1];
      float incl = pair;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float other = __shfl_down_sync(0xffffffffu, incl, off);
        if (lane + off < 32) incl += other;
      }
      if (2 * lane < valid && 2 * lane < q) a.da[row0 + 2 * lane] = incl;
      if (2 * lane + 1 < valid && 2 * lane + 1 < q) {
        a.da[row0 + 2 * lane + 1] = incl - pair + dlv[1];
      }
    }
    __syncthreads();  // the head's tiles and parts are consumed
  }
  if (active) {
    const int64_t brow = b * a.s_len + t0;  // first [B, S] row of the chunk
#pragma unroll
    for (int u = 0; u < NT; ++u) {
      const int col = hf * (kN / 2) + u * 8 + 2 * t4;
      if (j0 < valid) {
        *reinterpret_cast<__nv_bfloat162*>(a.db + (brow + j0) * kN + col) =
            __floats2bfloat162_rn(dbh[u][0], dbh[u][1]);
        *reinterpret_cast<__nv_bfloat162*>(a.dc + (brow + j0) * kN + col) =
            __floats2bfloat162_rn(dch[u][0], dch[u][1]);
      }
      if (j1 < valid) {
        *reinterpret_cast<__nv_bfloat162*>(a.db + (brow + j1) * kN + col) =
            __floats2bfloat162_rn(dbh[u][2], dbh[u][3]);
        *reinterpret_cast<__nv_bfloat162*>(a.dc + (brow + j1) * kN + col) =
            __floats2bfloat162_rn(dch[u][2], dch[u][3]);
      }
    }
  }
}

template <int NK>
int launch_states(const Args& a, int64_t bh, cudaStream_t stream) {
  constexpr int smem = states_smem_bytes<NK>();
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_bwd_tc_states_kernel<NK>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned blocks = static_cast<unsigned>(bh * 2 * (a.p_dim / kPS));
  ssd_bwd_tc_states_kernel<NK><<<blocks, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int NK, int PK>
int launch_grads(const Args& a, int64_t blocks, cudaStream_t stream) {
  constexpr int smem = grads_smem_bytes<NK, PK>();
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_bwd_tc_grads_kernel<NK, PK>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_tc_grads_kernel<NK, PK>
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

static_assert(grads_smem_bytes<8, 2>() <= static_cast<int>(kMaxSmemBytes), "smem");

}  // namespace tc

}  // namespace

// The backward's chunk for a state of n_st and a head dim of p_dim: max_q,
// halved until both kernels' blocks fit in kMaxSmemBytes; 0 where none fits.
extern "C" int ssd_scan_bwd_chunk(int max_q, int n_st, int p_dim) {
  for (int q = max_q; q >= 1; q /= 2) {
    const size_t states = states_smem_floats(q, n_st, p_dim);
    const size_t chunk = chunk_smem_floats(q, n_st, p_dim);
    if ((states > chunk ? states : chunk) * sizeof(float) <= kMaxSmemBytes) return q;
  }
  return 0;
}

// x, dy: [batch * heads, s_len, p_dim] in `dtype` (0 f32, 1 bf16); dt, a_log:
// f32 [batch * heads, s_len]; bm, cm: [batch, s_len, n_st] in `dtype`; sbuf,
// dbuf: f32 scratch [batch * heads, nc, n_st, p_dim] and sdot f32 [batch *
// heads, nc] with nc = ceil(s_len / q_len); all contiguous on the current
// device. n_st a power of two, p_dim a multiple of 4. Launches
// ssd_bwd_states_kernel on `stream`; returns cudaGetLastError() (or the
// attribute call's error).
extern "C" int ssd_scan_bwd_states_launch(
    const void* x, const void* dy, const float* dt, const float* a_log,
    const void* bm, const void* cm, float* sbuf, float* dbuf, float* sdot,
    int batch, int heads, int s_len, int q_len, int n_st, int p_dim, int dtype,
    cudaStream_t stream) {
  if (bad_shape(batch, heads, s_len, q_len, n_st, p_dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t bh = static_cast<int64_t>(batch) * heads;
  if (bh == 0 || s_len == 0) return 0;
  if (dtype == 1) {
    return launch_states<__nv_bfloat16>(x, dy, dt, a_log, bm, cm, sbuf, dbuf,
                                        sdot, bh, heads, s_len, q_len, n_st,
                                        p_dim, stream);
  }
  if (dtype == 0) {
    return launch_states<float>(x, dy, dt, a_log, bm, cm, sbuf, dbuf, sdot, bh,
                                heads, s_len, q_len, n_st, p_dim, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The operands of ssd_scan_bwd_states_launch, after it on the same stream,
// and: dx [batch * heads, s_len, p_dim] and dbo, dco [batch, s_len, n_st] in
// `dtype`; ddt, da f32 [batch * heads, s_len]; db32, dc32 f32 scratch
// [batch, s_len, n_st]. Launches ssd_bwd_chunk_kernel, one block per (batch
// row, chunk); returns cudaGetLastError() (or the attribute call's error).
extern "C" int ssd_scan_bwd_chunks_launch(
    const void* x, const void* dy, const float* dt, const float* a_log,
    const void* bm, const void* cm, const float* sbuf, const float* dbuf,
    const float* sdot, void* dx, float* ddt, float* da, float* db32,
    float* dc32, void* dbo, void* dco, int batch, int heads, int s_len,
    int q_len, int n_st, int p_dim, int dtype, cudaStream_t stream) {
  if (bad_shape(batch, heads, s_len, q_len, n_st, p_dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks =
      static_cast<int64_t>(batch) * ((s_len + q_len - 1) / q_len);
  if (blocks == 0) return 0;
  if (dtype == 1) {
    return launch_chunks<__nv_bfloat16>(x, dy, dt, a_log, bm, cm, sbuf, dbuf,
                                        sdot, dx, ddt, da, db32, dc32, dbo, dco,
                                        blocks, heads, s_len, q_len, n_st,
                                        p_dim, stream);
  }
  if (dtype == 0) {
    return launch_chunks<float>(x, dy, dt, a_log, bm, cm, sbuf, dbuf, sdot, dx,
                                ddt, da, db32, dc32, dbo, dco, blocks, heads,
                                s_len, q_len, n_st, p_dim, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

namespace {

bool bad_tc_shape(int batch, int heads, int s_len, int q_len, int n_st, int p_dim) {
  if (batch < 0 || heads < 1 || s_len < 0 || q_len < 16 || q_len > tc::kQMax ||
      q_len % 16 || (n_st != 16 && n_st != 32 && n_st != 64 && n_st != 128) ||
      (p_dim != 32 && p_dim != 64)) {
    return true;
  }
  const int64_t nc = (s_len + q_len - 1) / q_len;
  return static_cast<int64_t>(batch) * heads * 2 * (p_dim / tc::kPS) > 0x7fffffffLL ||
         static_cast<int64_t>(batch) * nc > 0x7fffffffLL;
}

tc::Args tc_args(const void* x, const int64_t* xs, const void* dy, const int64_t* dys,
                 const float* dt, const int64_t* dts, const float* a_log,
                 const int64_t* als, const void* bm, const int64_t* bms,
                 const void* cm, const int64_t* cms, const void* sbuf,
                 const void* dbuf, int heads, int s_len, int q_len, int p_dim) {
  tc::Args a{};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.dy = static_cast<const __nv_bfloat16*>(dy);
  a.bm = static_cast<const __nv_bfloat16*>(bm);
  a.cm = static_cast<const __nv_bfloat16*>(cm);
  a.dt = dt;
  a.al = a_log;
  a.x_sb = xs[0];
  a.x_sh = xs[1];
  a.x_ss = xs[2];
  a.dy_sb = dys[0];
  a.dy_sh = dys[1];
  a.dy_ss = dys[2];
  a.dt_sb = dts[0];
  a.dt_sh = dts[1];
  a.dt_ss = dts[2];
  a.al_sb = als[0];
  a.al_sh = als[1];
  a.al_ss = als[2];
  a.b_sb = bms[0];
  a.b_ss = bms[1];
  a.c_sb = cms[0];
  a.c_ss = cms[1];
  a.sbuf = static_cast<__nv_bfloat16*>(const_cast<void*>(sbuf));
  a.dbuf = static_cast<__nv_bfloat16*>(const_cast<void*>(dbuf));
  a.heads = heads;
  a.s_len = s_len;
  a.q_len = q_len;
  a.p_dim = p_dim;
  return a;
}

}  // namespace

// The tensor-core route's operands: bf16 x, dy [batch, heads, s_len, p_dim]
// at element strides xs, dys (b, h, s); f32 dt, a_log [batch, heads, s_len]
// at strides dts, als (b, h, s); bf16 bm, cm [batch, s_len, n_st] at
// strides bms, cms (b, s); unit stride along p and n, and x, dy, bm, cm
// 16-byte aligned with strides of 8-element multiples (cp.async moves 16
// bytes). sbuf, dbuf: bf16 scratch [batch * heads, nc, 2, n_st, p_dim], nc =
// ceil(s_len / q_len). p_dim 32 or 64, n_st one of 16, 32, 64, 128, q_len a
// multiple of 16 up to 64. Launches ssd_bwd_tc_states_kernel on `stream`,
// which writes every chunk's S_c and D into the scratch; returns
// cudaGetLastError() (or the attribute call's error).
extern "C" int ssd_scan_bwd_tc_states_launch(
    const void* x, const int64_t* xs, const void* dy, const int64_t* dys,
    const float* dt, const int64_t* dts, const float* a_log, const int64_t* als,
    const void* bm, const int64_t* bms, const void* cm, const int64_t* cms,
    void* sbuf, void* dbuf, int batch, int heads, int s_len, int q_len, int n_st,
    int p_dim, cudaStream_t stream) {
  if (bad_tc_shape(batch, heads, s_len, q_len, n_st, p_dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || s_len == 0) return 0;
  const tc::Args a = tc_args(x, xs, dy, dys, dt, dts, a_log, als, bm, bms, cm, cms,
                             sbuf, dbuf, heads, s_len, q_len, p_dim);
  const int64_t bh = static_cast<int64_t>(batch) * heads;
  switch (n_st) {
    case 16: return tc::launch_states<1>(a, bh, stream);
    case 32: return tc::launch_states<2>(a, bh, stream);
    case 64: return tc::launch_states<4>(a, bh, stream);
    case 128: return tc::launch_states<8>(a, bh, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The operands of ssd_scan_bwd_tc_states_launch, after it on the same
// stream, and the gradients, contiguous: bf16 dx [batch * heads, s_len,
// p_dim], f32 ddt, da [batch * heads, s_len], bf16 db, dc [batch, s_len,
// n_st]. Launches ssd_bwd_tc_grads_kernel, one block per (batch row,
// chunk); returns cudaGetLastError() (or the attribute call's error).
extern "C" int ssd_scan_bwd_tc_grads_launch(
    const void* x, const int64_t* xs, const void* dy, const int64_t* dys,
    const float* dt, const int64_t* dts, const float* a_log, const int64_t* als,
    const void* bm, const int64_t* bms, const void* cm, const int64_t* cms,
    const void* sbuf, const void* dbuf, void* dx, float* ddt, float* da, void* db,
    void* dc, int batch, int heads, int s_len, int q_len, int n_st, int p_dim,
    cudaStream_t stream) {
  if (bad_tc_shape(batch, heads, s_len, q_len, n_st, p_dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || s_len == 0) return 0;
  tc::Args a = tc_args(x, xs, dy, dys, dt, dts, a_log, als, bm, bms, cm, cms, sbuf,
                       dbuf, heads, s_len, q_len, p_dim);
  a.dx = static_cast<__nv_bfloat16*>(dx);
  a.ddt = ddt;
  a.da = da;
  a.db = static_cast<__nv_bfloat16*>(db);
  a.dc = static_cast<__nv_bfloat16*>(dc);
  const int64_t blocks = static_cast<int64_t>(batch) * ((s_len + q_len - 1) / q_len);
  const bool wide = p_dim == 64;
  switch (n_st) {
    case 16: return wide ? tc::launch_grads<1, 2>(a, blocks, stream)
                         : tc::launch_grads<1, 1>(a, blocks, stream);
    case 32: return wide ? tc::launch_grads<2, 2>(a, blocks, stream)
                         : tc::launch_grads<2, 1>(a, blocks, stream);
    case 64: return wide ? tc::launch_grads<4, 2>(a, blocks, stream)
                         : tc::launch_grads<4, 1>(a, blocks, stream);
    case 128: return wide ? tc::launch_grads<8, 2>(a, blocks, stream)
                          : tc::launch_grads<8, 1>(a, blocks, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
