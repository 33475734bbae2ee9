// ssd_scan: the Mamba2 SSD recurrence S_t = exp(a_t) S_{t-1} + (dt_t B_t) x_t^T,
// y_t = C_t S_t, evaluated chunk by chunk (Dao & Gu 2024): per chunk of Q
// steps, the intra-chunk term (L o C Bt^T) X with L_ij = exp(l_i - l_j) for
// i >= j (l the cumulative log-decay), the inter-chunk term C exp(l) S_prev,
// and the state pass S = exp(l_Q) S_prev + sum_t exp(l_Q - l_t) Bt_t x_t^T.
// x: [B*H, S, P] (bf16 or f32); dt, a_log: f32 [B*H, S]; B, C: [B, S, N] in
// x's dtype, one group shared by the H heads of a batch row; out: x's dtype.
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan_kernel, the Pallas TPU
// kernel with grid (B*H, S/Q) whose chunk axis runs in order, carrying the
// (N, P) state in VMEM scratch; its wrapper repeats B and C over the heads
// (src/repro/kernels/ops.py:262-263) and it needs S % Q == 0.
//
// Design: one block of 256 threads per b*h, looping over the chunks in
// order; the loop takes the place of the TPU's sequential grid axis, and
// the (N, P) f32 state (32 KB at N = 128, P = 64) stays in shared memory
// for the whole sequence. B and C are read by index (row bh / H) instead of
// the wrapper's per-head copy, which would move H = 24 times their bytes
// at mamba2's width. Shared memory per block holds x and the y accumulator
// of the chunk (Q x P each), the state, the Q x Q score tile C Bt^T, and a
// 16-wide slice of C and of Bt^T: staging x, B, C and the score tile whole
// in f32 at Q = 128, N = 128 would need 240 KB, over the 227 KB a block
// may use, so the N axis is walked in slices of 16. Per slice the block
// adds the slice's share of C Bt^T (lower triangle only), of the inter-chunk
// term, and updates the slice's state rows (after the inter-chunk term has
// read them). Then the score tile is multiplied by L, masking the exponent
// (not the exp, which overflows above the diagonal), and the intra-chunk
// product finishes y. All arithmetic is f32 FMA on the CUDA cores.
// Steps at or past S read as x = dt = a_log = B = C = 0 and are not stored:
// the recurrence is causal, so the real positions are exact for any S.
//
// Bound on this card: both terms are close at mamba2's width. Per chunk and
// b*h the function needs about 2 (Q^2 N / 2 + Q^2 P / 2 + 2 Q N P) flops,
// at 989 TFLOP/s for bf16 on the tensor cores, against reading x, dt, a_log,
// B, C once and writing y once at 3.35 TB/s. This kernel runs on the f32
// CUDA cores (67 TFLOP/s peak) with one block per b*h.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
    ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
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
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_kernel<T><<<static_cast<unsigned>(bh), kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, a_log, static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<T*>(out), heads, s_len, q_len,
      n_st, p_dim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: [bh, s_len, p_dim]; bm, cm: [bh / heads, s_len, n_st], all in
// `dtype` (0 f32, 1 bf16); dt, a_log: f32 [bh, s_len]; all contiguous on the
// current device. q_len (the chunk) and p_dim are multiples of 4. Launches on
// `stream`; returns cudaGetLastError() (or the attribute call's error).
extern "C" int ssd_scan_launch(const void* x, const float* dt,
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
