// rglru_scan: the RG-LRU's affine recurrence h_t = a_t h_{t-1} + b_t, for
// sm_90a.
//
// No TPU kernel: it replaces the recurrence that the reference leaves to
// XLA in repro/models/recurrent.py (rglru_block): the lax.associative_scan
// over T, and the single step at T = 1.
//
// Semantics (repro_torch.kernels.rglru_scan.rglru_scan_plain): for every
// batch row b and channel r, h = h0[b, r], then for t in order
// h = a[b, t, r] * h + b[b, t, r], written to h_seq[b, t, r]; the last h to
// h_last[b, r].  Built with -fmad=false, so the multiply and the add round
// apart as PyTorch's two elementwise ops round them: the result is the plain
// version's bit for bit.  (The reference's tree of combines rounds
// differently from both, by float32 rounding.)
//
// A thread a channel, walking t in order; a warp covers 32 neighbouring
// channels, so every load of a step and every store is one 128-byte
// segment.  The chain of dependent multiply-adds is short (two adds a step,
// ~8 us for 4,096 steps); what bounds the kernel on this card is bytes (a
// and b read once, h_seq written once) and, with one thread a channel, how
// many of those bytes can be in flight: the next kAhead steps' a and b are
// loaded into registers while the current ones are folded in.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;  // a warp a block: B * R / 32 blocks spread over the SMs
constexpr int kAhead = 32;    // steps loaded ahead of the fold

__global__ void __launch_bounds__(kThreads) rglru_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                                         const float* __restrict__ h0, int T, int R,
                                                         float* __restrict__ h_seq, float* __restrict__ h_last) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  const size_t row = blockIdx.y;
  const size_t base = row * (size_t)T * R + r;
  const float* ap = a + base;
  const float* bp = b + base;
  float* hp = h_seq + base;
  float h = h0[row * R + r];
  float na[kAhead], nb[kAhead];
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    if (j < T) {
      na[j] = __ldg(ap + (size_t)j * R);
      nb[j] = __ldg(bp + (size_t)j * R);
    }
  }
  for (int t0 = 0; t0 < T; t0 += kAhead) {
    float ca[kAhead], cb[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      ca[j] = na[j];
      cb[j] = nb[j];
    }
    const int t1 = t0 + kAhead;
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (t1 + j < T) {
        na[j] = __ldg(ap + (size_t)(t1 + j) * R);
        nb[j] = __ldg(bp + (size_t)(t1 + j) * R);
      }
    }
    const int n = min(kAhead, T - t0);
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (j < n) {
        h = ca[j] * h + cb[j];
        hp[(size_t)(t0 + j) * R] = h;
      }
    }
  }
  h_last[row * R + r] = h;
}

}  // namespace

// a, b (B, T, R) f32, h0 (B, R) f32 -> h_seq (B, T, R), h_last (B, R).
extern "C" int rglru_scan_launch(const float* a, const float* b, const float* h0, int B, int T, int R, float* h_seq,
                                 float* h_last, cudaStream_t stream) {
  if (B <= 0 || R <= 0) return 0;
  if (T <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((R + kThreads - 1) / kThreads, B);
  rglru_kernel<<<grid, kThreads, 0, stream>>>(a, b, h0, T, R, h_seq, h_last);
  return (int)cudaGetLastError();
}
