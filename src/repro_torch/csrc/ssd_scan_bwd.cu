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
// Bound on an H100: operations, about 2.5 times the forward's chunked
// products (40 GFLOP at mamba2's training shape, x [4, 24, 2,048, 64], N
// 128: 0.04 ms at the bf16 tensor-core peak) against 87 MB of inputs and
// gradients (0.026 ms at 3.35 TB/s). This first version runs f32 FMAs on
// the CUDA cores (the tensor cores are later work), so it is far from that.
//
// Design, two kernels, no atomics (a second call gives the same bits):
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
