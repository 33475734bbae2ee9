// rglru_scan: the RG-LRU linear recurrence h_t = a_t * h_(t-1) + b_t over
// the sequence axis of f32 a, b [B, S, dr], from h_(-1) = h0 [B, dr] (or 0),
// writing every h_t into h [B, S, dr].
//
// Replaces: no TPU kernel. The reference runs the recurrence as
// jax.lax.associative_scan, which XLA lowers on the TPU
// (src/repro/models/layers.py:689, apply_rglru). Torch has no scan op, and a
// loop of torch ops on the card would launch ~3 kernels a step: 2,048 steps
// x 26 RG-LRU layers a recurrentgemma prefill.
//
// Bound on this card: memory. The function must read a and b and write h,
// 12 bytes an element (3 x 8 x 2,048 x 4,096 x 4 = 805 MB at
// recurrentgemma's prefill, 0.240 ms at 3.35 TB/s); it does 2 flops an
// element.
//
// Design (simple first): one thread per (batch row, channel), walking t in
// order with its state in a register. Neighbouring threads take
// neighbouring channels, so each step's loads and stores are coalesced
// along dr. Loads of kUnroll steps are issued before the dependent chain
// that consumes them, so each thread keeps 2 x kUnroll loads in flight.
// The step is a rounded multiply, then a rounded add (no fused
// multiply-add), as the plain torch version rounds, so the two agree bit
// for bit. B * dr threads (32,768 at recurrentgemma's 8 x 4,096) fill the
// card's 132 SMs only thinly: latency, not bandwidth, bounds it.
//
// rglru_scan_bwd: the gradient of the recurrence for an output gradient dh
// [B, S, dr], from a and the forward's h (saved, not recomputed). Walking t
// from S - 1 down to 0, g = dh_t + a_(t+1) g (g = dh_(S-1) at the end), then
// db_t = g and da_t = g h_(t-1) with h_(-1) = h0 or 0, and dh0 = a_0 g.
// Replaces no TPU kernel either: the reference differentiates its
// associative scan with autodiff. Bound: bytes, a, h and dh read and da and
// db written, 20 bytes an element (671 MB at recurrentgemma's training
// shape [4, 2,048, 4,096], 0.200 ms at 3.35 TB/s). Same layout as the
// forward: one thread per (batch row, channel) walking t backward,
// kBwdUnroll steps of loads in flight; a rounded multiply, then a rounded
// add, as
// kernels/ref.py::rglru_scan_bwd_loop rounds, so the two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 8;
// the backward's batch: three loads a step, and at training's batch of 4
// half the forward's threads, so twice the steps in flight
constexpr int kBwdUnroll = 16;

__global__ void __launch_bounds__(kThreads)
    rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      const float* __restrict__ h0, float* __restrict__ h,
                      int64_t batch, int64_t seq, int64_t dr) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= batch * dr) return;
  const int64_t row = idx / dr;
  const int64_t c = idx - row * dr;
  const int64_t base = row * seq * dr + c;
  const float* ap = a + base;
  const float* bp = b + base;
  float* hp = h + base;
  float state = h0 != nullptr ? h0[idx] : 0.f;
  int64_t t = 0;
  for (; t + kUnroll <= seq; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = __ldg(ap + (t + u) * dr);
      bv[u] = __ldg(bp + (t + u) * dr);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      state = __fadd_rn(__fmul_rn(av[u], state), bv[u]);
      hp[(t + u) * dr] = state;
    }
  }
  for (; t < seq; ++t) {
    state = __fadd_rn(__fmul_rn(__ldg(ap + t * dr), state), __ldg(bp + t * dr));
    hp[t * dr] = state;
  }
}

__global__ void __launch_bounds__(kThreads)
    rglru_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                          const float* __restrict__ h0, const float* __restrict__ dh,
                          float* __restrict__ da, float* __restrict__ db,
                          float* __restrict__ dh0, int64_t batch, int64_t seq,
                          int64_t dr) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= batch * dr) return;
  const int64_t row = idx / dr;
  const int64_t c = idx - row * dr;
  const int64_t base = row * seq * dr + c;
  const float* ap = a + base;
  const float* hp = h + base;
  const float* gp = dh + base;
  float* dap = da + base;
  float* dbp = db + base;
  const float start = h0 != nullptr ? h0[idx] : 0.f;
  float g = 0.f;
  float a_next = 0.f;
  int64_t t = seq - 1;
  // whole batches of steps t .. t - kBwdUnroll + 1, all past step 0, so
  // every h_(s-1) is a load; the rest, step 0 with h0, in the tail loop
  for (; t - kBwdUnroll >= 0; t -= kBwdUnroll) {
    float av[kBwdUnroll], hv[kBwdUnroll], gv[kBwdUnroll];
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      const int64_t s = t - u;
      av[u] = __ldg(ap + s * dr);
      gv[u] = __ldg(gp + s * dr);
      hv[u] = __ldg(hp + (s - 1) * dr);
    }
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      const int64_t s = t - u;
      g = __fadd_rn(gv[u], __fmul_rn(a_next, g));
      dbp[s * dr] = g;
      dap[s * dr] = __fmul_rn(g, hv[u]);
      a_next = av[u];
    }
  }
  for (; t >= 0; --t) {
    g = __fadd_rn(__ldg(gp + t * dr), __fmul_rn(a_next, g));
    dbp[t * dr] = g;
    dap[t * dr] = __fmul_rn(g, t > 0 ? __ldg(hp + (t - 1) * dr) : start);
    a_next = __ldg(ap + t * dr);
  }
  if (dh0 != nullptr) dh0[idx] = __fmul_rn(a_next, g);
}

}  // namespace

// a, b, h: f32 [batch, seq, dr] contiguous; h0: f32 [batch, dr] contiguous,
// or null for a zero state. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int rglru_scan_launch(const float* a, const float* b, const float* h0,
                                 float* h, int64_t batch, int64_t seq,
                                 int64_t dr, cudaStream_t stream) {
  if (batch < 0 || seq < 0 || dr < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t lanes = batch * dr;
  if (lanes == 0 || seq == 0) return 0;
  const int64_t blocks = (lanes + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  rglru_scan_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      a, b, h0, h, batch, seq, dr);
  return static_cast<int>(cudaGetLastError());
}

// a, h, dh, da, db: f32 [batch, seq, dr] contiguous; h0, dh0: f32 [batch, dr]
// contiguous, or null (no initial state: h_(-1) = 0 and no dh0). Launches
// rglru_scan_bwd_kernel on `stream`; returns cudaGetLastError().
extern "C" int rglru_scan_bwd_launch(const float* a, const float* h,
                                     const float* h0, const float* dh, float* da,
                                     float* db, float* dh0, int64_t batch,
                                     int64_t seq, int64_t dr, cudaStream_t stream) {
  if (batch < 0 || seq < 0 || dr < 0 || (h0 == nullptr) != (dh0 == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t lanes = batch * dr;
  if (lanes == 0) return 0;
  const int64_t blocks = (lanes + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  rglru_scan_bwd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      a, h, h0, dh, da, db, dh0, batch, seq, dr);
  return static_cast<int>(cudaGetLastError());
}
