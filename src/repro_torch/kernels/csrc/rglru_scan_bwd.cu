// rglru_scan_bwd: the gradient of the RG-LRU's affine recurrence
// h_t = a_t h_{t-1} + b_t, for sm_90a.
//
// No TPU kernel: it replaces the gradient that JAX's autodiff takes of the
// recurrence the reference leaves to XLA in repro/models/recurrent.py
// (rglru_block's lax.associative_scan over T).
//
// Semantics (repro_torch.kernels.rglru_scan_bwd.rglru_scan_bwd_plain): for
// every batch row b and channel r, c = dh_last[b, r], then for t from T - 1
// down to 0
//   g = dh_seq[b, t, r] + c
//   da[b, t, r] = g * h_{t-1}     (h_{-1} = h0[b, r], else h_seq[b, t - 1, r])
//   db[b, t, r] = g
//   c = a[b, t, r] * g
// and dh0[b, r] = c.  Built with -fmad=false, so each multiply and add
// rounds on its own, in that order, as the plain version's elementwise ops
// round them: the result is the plain version's bit for bit.  A null da,
// db or dh0 is not written.
//
// Design: the forward's (csrc/rglru_scan.cu) walked backwards.  A thread a
// channel, a one-warp block over 32 neighbouring channels of a batch row,
// so that every load and store of a step is one 128-byte segment.  a,
// h_{t-1} (h_seq shifted by a token, h0 at t = 0) and dh_seq come through
// a ring of kStages stages of kStageTokens tokens in shared memory, filled
// by cp.async from the end of the row towards its start: while one stage is
// folded in, the next kStages - 1 (96 tokens, 36 KB) are on their way.  A
// stage is read into registers before its steps.  Rows that start on 16
// bytes (every pointer, and R a multiple of 4) copy 16-byte pieces; any
// other row copies 4 bytes a lane, in the same ring.
//
// Bound on this card: bytes (a, h_seq and dh_seq read once, da and db
// written once); the chain of a step is an add and a multiply.  What holds
// it (H100, recurrentgemma's training shape: 0.39 ms, 32% of the bound):
// not the bytes in flight (a 16-stage ring in 96 KB took 0.48 ms,
// tools/recurrent_clocks.py --trees), but, as far as measured, each warp's
// own instruction stream, with one or two warps an SM (160 warps at B 2,
// R 2,560): the copies' address work, the stage's loads into registers and
// two stores a step.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 32;      // a warp a block: a channel a thread
constexpr int kStageTokens = 16;  // tokens a stage
constexpr int kStages = 7;        // stages in the ring: kStages - 1 in flight while one is folded
constexpr int kTensors = 3;       // a, h_{t-1}, dh_seq

__device__ __forceinline__ void cp_async(void* smem, const float* gmem, bool in, int bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(gmem), "r"(in ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(gmem), "r"(in ? 4 : 0) : "memory");
}

__global__ void __launch_bounds__(kThreads)
    rglru_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h0, const float* __restrict__ h_seq,
                     const float* __restrict__ dh_seq, const float* __restrict__ dh_last, int T, int R, bool wide,
                     float* __restrict__ da, float* __restrict__ db, float* __restrict__ dh0) {
  __shared__ __align__(16) float ring[kStages][kTensors][kStageTokens][kThreads];  // [stage][tensor][token][channel]
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * kThreads;
  const int r = c0 + lane;
  const size_t row = blockIdx.y;
  const size_t base = row * (size_t)T * R;
  const int n_stages = (T + kStageTokens - 1) / kStageTokens;

  // the source of tensor `which` at token t and column col: a, h_{t-1}, dh_seq
  auto src = [&](int which, int t, int col) -> const float* {
    if (which == 1) return t > 0 ? h_seq + base + (size_t)(t - 1) * R + col : h0 + row * R + col;
    return (which ? dh_seq : a) + base + (size_t)t * R + col;
  };
  // the k-th stage walked holds tokens from (n_stages - 1 - k) * kStageTokens;
  // one commit group a stage (an empty one past the start of the row, so the
  // count of groups stays in step with the stages)
  auto issue = [&](int k) {
    if (k < n_stages) {
      float(*slot)[kStageTokens][kThreads] = ring[k % kStages];
      const int t0 = (n_stages - 1 - k) * kStageTokens;
      if (wide) {  // 8 lanes a row of a tensor, 16 bytes each
#pragma unroll
        for (int i = 0; i < kTensors * kStageTokens * 8 / kThreads; ++i) {
          const int p = lane + i * kThreads, which = p / (kStageTokens * 8), tr = (p / 8) % kStageTokens;
          const int col = (p % 8) * 4;
          const bool in = t0 + tr < T && c0 + col < R;
          cp_async(&slot[which][tr][col], in ? src(which, t0 + tr, c0 + col) : a, in, 16);
        }
      } else {  // a lane a channel, 4 bytes
#pragma unroll
        for (int tr = 0; tr < kStageTokens; ++tr) {
          const bool in = t0 + tr < T && r < R;
#pragma unroll
          for (int which = 0; which < kTensors; ++which)
            cp_async(&slot[which][tr][lane], in ? src(which, t0 + tr, r) : a, in, 4);
        }
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) issue(k);
  float c = r < R ? dh_last[row * R + r] : 0.f;
  for (int k = 0; k < n_stages; ++k) {
    asm volatile("cp.async.wait_group %0;" ::"n"(kStages - 2) : "memory");  // this lane's copies of stage k have landed
    __syncwarp();  // ... and every lane's; and stage k - 1's slot is read by all
    issue(k + kStages - 1);  // into that slot
    const float(*slot)[kStageTokens][kThreads] = ring[k % kStages];
    float sa[kStageTokens], sh[kStageTokens], sd[kStageTokens];
#pragma unroll
    for (int j = 0; j < kStageTokens; ++j) sa[j] = slot[0][j][lane], sh[j] = slot[1][j][lane], sd[j] = slot[2][j][lane];
    const int t0 = (n_stages - 1 - k) * kStageTokens, n = min(kStageTokens, T - t0);
    const size_t off = base + (size_t)t0 * R + r;
    if (r < R) {
#pragma unroll
      for (int j = kStageTokens - 1; j >= 0; --j) {
        if (j < n) {
          const float g = sd[j] + c;
          if (da) da[off + (size_t)j * R] = g * sh[j];
          if (db) db[off + (size_t)j * R] = g;
          c = sa[j] * g;
        }
      }
    }
  }
  if (dh0 && r < R) dh0[row * R + r] = c;
}

}  // namespace

// a, h_seq, dh_seq (B, T, R) f32, h0, dh_last (B, R) f32 -> da, db (B, T, R),
// dh0 (B, R); a null output is not written.
extern "C" int rglru_scan_bwd_launch(const float* a, const float* h0, const float* h_seq, const float* dh_seq,
                                     const float* dh_last, int B, int T, int R, float* da, float* db, float* dh0,
                                     cudaStream_t stream) {
  if (B <= 0 || R <= 0) return 0;
  if (T <= 0) return (int)cudaErrorInvalidValue;
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool wide = R % 4 == 0 && aligned(a) && aligned(h0) && aligned(h_seq) && aligned(dh_seq);
  const dim3 grid((R + kThreads - 1) / kThreads, B);
  rglru_bwd_kernel<<<grid, kThreads, 0, stream>>>(a, h0, h_seq, dh_seq, dh_last, T, R, wide, da, db, dh0);
  return (int)cudaGetLastError();
}
