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
// A thread a channel, walking t in order; a one-warp block covers 32
// neighbouring channels of a batch row, so every load of a step and every
// store is one 128-byte segment.  The chain of dependent multiplies and
// adds is short (~8 cycles a step, ~20 us for 4,096 steps); what bounds
// the kernel on this card is bytes (a and b read once, h_seq written
// once), and with a warp a block, how many of those bytes each warp keeps
// in flight.  So a and b come through a ring of kStages stages in shared
// memory, kStageTokens tokens each, filled by cp.async: while one stage is
// folded in, the next kStages - 1 (128 tokens, 32 KB) are on their way,
// ~5 MB over the card at recurrentgemma's widths.  A stage is read into
// registers before its steps: a step that reads shared memory itself
// waits that read's latency (~30 cycles) in the chain.  Rows that start on
// 16 bytes (the pointers, and R a multiple of 4) copy 16-byte pieces; any
// other row copies 4 bytes a lane, in the same ring.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 32;      // a warp a block: a channel a thread
constexpr int kStageTokens = 16;  // tokens a stage
constexpr int kStages = 9;        // stages in the ring: kStages - 1 in flight while one is folded

__device__ __forceinline__ void cp_async(void* smem, const float* gmem, bool in, int bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(gmem), "r"(in ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(gmem), "r"(in ? 4 : 0) : "memory");
}

__global__ void __launch_bounds__(kThreads) rglru_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                                         const float* __restrict__ h0, int T, int R, bool wide,
                                                         float* __restrict__ h_seq, float* __restrict__ h_last) {
  __shared__ __align__(16) float ring[kStages][2][kStageTokens][kThreads];  // [stage][a or b][token][channel]
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * kThreads;
  const int r = c0 + lane;
  const size_t row = blockIdx.y;
  const size_t base = row * (size_t)T * R;
  const int n_stages = (T + kStageTokens - 1) / kStageTokens;

  // one commit group a stage (an empty one past the end, so the count of
  // groups stays in step with the stages)
  auto issue = [&](int s) {
    if (s < n_stages) {
      float(*slot)[kStageTokens][kThreads] = ring[s % kStages];
      const int t0 = s * kStageTokens;
      if (wide) {  // 8 lanes a row of a tensor, 16 bytes each
#pragma unroll
        for (int i = 0; i < 2 * kStageTokens * 8 / kThreads; ++i) {
          const int p = lane + i * kThreads, which = p / (kStageTokens * 8), tr = (p / 8) % kStageTokens;
          const int col = (p % 8) * 4;
          const bool in = t0 + tr < T && c0 + col < R;
          const float* src = (which ? b : a) + base + (in ? (size_t)(t0 + tr) * R + c0 + col : 0);
          cp_async(&slot[which][tr][col], src, in, 16);
        }
      } else {  // a lane a channel, 4 bytes
#pragma unroll
        for (int tr = 0; tr < kStageTokens; ++tr) {
          const bool in = t0 + tr < T && r < R;
          const size_t off = base + (in ? (size_t)(t0 + tr) * R + r : 0);
          cp_async(&slot[0][tr][lane], a + off, in, 4);
          cp_async(&slot[1][tr][lane], b + off, in, 4);
        }
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  float h = r < R ? h0[row * R + r] : 0.f;
  float* hp = h_seq + base + r;
  for (int s = 0; s < n_stages; ++s) {
    asm volatile("cp.async.wait_group %0;" ::"n"(kStages - 2) : "memory");  // this lane's copies of stage s have landed
    __syncwarp();  // ... and every lane's; and stage s - 1's slot is read by all
    issue(s + kStages - 1);  // into that slot
    // the stage into registers first, so that no step waits on its load
    const float(*slot)[kStageTokens][kThreads] = ring[s % kStages];
    float sa[kStageTokens], sb[kStageTokens];
#pragma unroll
    for (int j = 0; j < kStageTokens; ++j) sa[j] = slot[0][j][lane], sb[j] = slot[1][j][lane];
    const int t0 = s * kStageTokens, n = min(kStageTokens, T - t0);
    float* out = hp + (size_t)t0 * R;
    if (r < R && n == kStageTokens) {
#pragma unroll
      for (int j = 0; j < kStageTokens; ++j) {
        h = sa[j] * h + sb[j];
        out[(size_t)j * R] = h;
      }
    } else if (r < R) {
#pragma unroll
      for (int j = 0; j < kStageTokens; ++j) {
        if (j < n) {
          h = sa[j] * h + sb[j];
          out[(size_t)j * R] = h;
        }
      }
    }
  }
  if (r < R) h_last[row * R + r] = h;
}

}  // namespace

// a, b (B, T, R) f32, h0 (B, R) f32 -> h_seq (B, T, R), h_last (B, R).
extern "C" int rglru_scan_launch(const float* a, const float* b, const float* h0, int B, int T, int R, float* h_seq,
                                 float* h_last, cudaStream_t stream) {
  if (B <= 0 || R <= 0) return 0;
  if (T <= 0) return (int)cudaErrorInvalidValue;
  const bool wide = R % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const dim3 grid((R + kThreads - 1) / kThreads, B);
  rglru_kernel<<<grid, kThreads, 0, stream>>>(a, b, h0, T, R, wide, h_seq, h_last);
  return (int)cudaGetLastError();
}
