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
// shape [4, 2,048, 4,096], 0.200 ms at 3.35 TB/s).
//
// Design of the backward: a shared-memory ring feeds the chains. Training's
// batch of 4 gives only B x dr = 16,384 chains, so a thread a chain that
// loads its own steps cannot keep enough bytes in flight (a batch of loads,
// then the chain that consumes them, then the next batch). Here one block
// takes a batch row and kBwdChannels channels (128 blocks at the training
// shape, one an SM) and one thread a channel. The block walks the sequence
// downward in stages of kBwdSteps steps: stage k holds a and dh at steps
// [S - (k + 1) kBwdSteps, S - k kBwdSteps) and h one step earlier, as
// [tensor][step][channel] tiles, so every warp's copies and reads are
// consecutive words. kBwdStages stages form a ring: while the threads run
// the chains through one stage, the cp.async copies of the next
// kBwdStages - 1 are in flight (16 bytes a copy where dr is a multiple of 4
// and the three inputs are 16-byte aligned, else 4), one barrier a stage.
// Each chain keeps its order and rounding exactly: a rounded multiply, then
// a rounded add, as kernels/ref.py::rglru_scan_bwd_loop rounds, so the two
// agree bit for bit; da and db are stored straight from the chain, each
// step's 128 channels one coalesced row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 8;
// the backward: channels (threads) a block, steps a stage, stages a ring
constexpr int kBwdChannels = 128;
constexpr int kBwdSteps = 32;
constexpr int kBwdStages = 4;
constexpr int kBwdStageFloats = 3 * kBwdSteps * kBwdChannels;  // a, dh, h tiles
constexpr int kBwdSmemBytes = kBwdStages * kBwdStageFloats * 4;  // 196,608

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

// One copy of V floats into shared memory: 16 bytes through the L2 only
// (cg), or 4.
template <int V>
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (V == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
                 : "memory");
  }
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage k's copies into its ring slot: rows a[t], dh[t] and h[t - 1] for
// the stage's steps t >= 0 (h[-1] is h0 or 0, taken from a register), the
// block's channels below dr. Always commits a group, empty past the last
// stage, so the count of groups in flight stays fixed.
template <int V>
__device__ __forceinline__ void bwd_stage_copy(float* ring, int64_t k, int64_t stages,
                                               const float* a, const float* dh,
                                               const float* h, int64_t base,
                                               int64_t seq, int64_t dr, int64_t c0) {
  if (k < stages) {
    float* slot = ring + (k % kBwdStages) * kBwdStageFloats;
    const int64_t t0 = seq - (k + 1) * kBwdSteps;
    constexpr int kRowCopies = kBwdChannels / V;
    constexpr int kCopies = 3 * kBwdSteps * kRowCopies;
#pragma unroll 4
    for (int q = threadIdx.x; q < kCopies; q += kBwdChannels) {
      const int r = q / kRowCopies;  // tensor * kBwdSteps + step
      const int cc = (q - r * kRowCopies) * V;
      const int tensor = r / kBwdSteps;
      const int64_t t = t0 + (r - tensor * kBwdSteps) - (tensor == 2 ? 1 : 0);
      if (t >= 0 && c0 + cc < dr) {
        const float* src = tensor == 0 ? a : (tensor == 1 ? dh : h);
        copy_async<V>(slot + r * kBwdChannels + cc, src + base + t * dr + c0 + cc);
      }
    }
  }
  copy_commit();
}

template <int V>
__global__ void __launch_bounds__(kBwdChannels, 1)
    rglru_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                          const float* __restrict__ h0, const float* __restrict__ dh,
                          float* __restrict__ da, float* __restrict__ db,
                          float* __restrict__ dh0, int64_t seq, int64_t dr,
                          int64_t channel_blocks) {
  extern __shared__ __align__(16) float ring[];
  const int64_t row = blockIdx.x / channel_blocks;
  const int64_t c0 = (blockIdx.x - row * channel_blocks) * kBwdChannels;
  const int64_t base = row * seq * dr;
  const int64_t stages = (seq + kBwdSteps - 1) / kBwdSteps;
  const int64_t c = c0 + threadIdx.x;
  const bool live = c < dr;
  const float start = live && h0 != nullptr ? h0[row * dr + c] : 0.f;
  float g = 0.f;
  float a_next = 0.f;
  for (int k = 0; k < kBwdStages - 1; ++k) {
    bwd_stage_copy<V>(ring, k, stages, a, dh, h, base, seq, dr, c0);
  }
  for (int64_t k = 0; k < stages; ++k) {
    copy_wait<kBwdStages - 2>();  // stage k has landed
    __syncthreads();              // for every thread; stage k - 1's slot is free
    bwd_stage_copy<V>(ring, k + kBwdStages - 1, stages, a, dh, h, base, seq, dr, c0);
    if (!live) continue;
    const float* slot = ring + (k % kBwdStages) * kBwdStageFloats + threadIdx.x;
    const float* av = slot;
    const float* gv = slot + kBwdSteps * kBwdChannels;
    const float* hv = slot + 2 * kBwdSteps * kBwdChannels;
    const int64_t t0 = seq - (k + 1) * kBwdSteps;
    float* dbp = db + base + (t0 + kBwdSteps - 1) * dr + c;
    float* dap = da + base + (t0 + kBwdSteps - 1) * dr + c;
    if (t0 >= 1) {  // a whole stage, every h_(t-1) in the ring
#pragma unroll
      for (int j = kBwdSteps - 1; j >= 0; --j) {
        g = __fadd_rn(gv[j * kBwdChannels], __fmul_rn(a_next, g));
        *dbp = g;
        *dap = __fmul_rn(g, hv[j * kBwdChannels]);
        a_next = av[j * kBwdChannels];
        dbp -= dr;
        dap -= dr;
      }
    } else {  // the stage holding step 0, whole or cut short
      for (int j = kBwdSteps - 1; t0 + j >= 0; --j) {
        g = __fadd_rn(gv[j * kBwdChannels], __fmul_rn(a_next, g));
        *dbp = g;
        *dap = __fmul_rn(g, t0 + j > 0 ? hv[j * kBwdChannels] : start);
        a_next = av[j * kBwdChannels];
        dbp -= dr;
        dap -= dr;
      }
    }
  }
  if (live && dh0 != nullptr) dh0[row * dr + c] = __fmul_rn(a_next, g);
}

template <int V>
int launch_bwd(const float* a, const float* h, const float* h0, const float* dh,
               float* da, float* db, float* dh0, int64_t batch, int64_t seq,
               int64_t dr, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      rglru_scan_bwd_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBwdSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t channel_blocks = (dr + kBwdChannels - 1) / kBwdChannels;
  const int64_t blocks = batch * channel_blocks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  rglru_scan_bwd_kernel<V><<<static_cast<unsigned>(blocks), kBwdChannels,
                             kBwdSmemBytes, stream>>>(a, h, h0, dh, da, db, dh0, seq,
                                                      dr, channel_blocks);
  return static_cast<int>(cudaGetLastError());
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
// rglru_scan_bwd_kernel on `stream` (16-byte copies where dr is a multiple
// of 4 and a, h, dh are 16-byte aligned); returns cudaGetLastError().
extern "C" int rglru_scan_bwd_launch(const float* a, const float* h,
                                     const float* h0, const float* dh, float* da,
                                     float* db, float* dh0, int64_t batch,
                                     int64_t seq, int64_t dr, cudaStream_t stream) {
  if (batch < 0 || seq < 0 || dr < 0 || (h0 == nullptr) != (dh0 == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch * dr == 0) return 0;
  const auto at16 = [](const float* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (dr % 4 == 0 && at16(a) && at16(h) && at16(dh)) {
    return launch_bwd<4>(a, h, h0, dh, da, db, dh0, batch, seq, dr, stream);
  }
  return launch_bwd<1>(a, h, h0, dh, da, db, dh0, batch, seq, dr, stream);
}
