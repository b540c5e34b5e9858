// segmax: per-segment peaks of padded memory series, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/segmax.py (_segmax_kernel /
// segmax_pallas), whose output block was revisited across a sequential grid
// axis over T.  Here one block owns one row and loops over T itself, so no
// block depends on another and nothing is revisited.
//
// Row r reads series[r] of y (S, T): rows of one series (the k_eff batch of
// the Fig. 8 sweep) share it through L2 instead of copying it.  k_eff is
// per row, so one launch serves a whole bucket or a whole sweep.
//
// Semantics (repro_torch.core.segmentation.segment_peaks_dynamic):
//   i = max(len / max(k_eff, 1), 1); segment s < k_eff covers
//   [min(s*i, len), min((s+1)*i, len)), the last real one ends at len;
//   segments s >= k_eff are empty.  A segment whose max is not finite
//   (empty) takes the last finite peak to its left, or 0.  Series are
//   finite: fmaxf drops a NaN where the plain version keeps it.
//
// Bound: memory.  Each valid sample is read once (one compare per sample),
// so the floor is the series bytes over the card's 3.35 TB/s.  A thread
// keeps its running max of the current segment in a register; the block
// reduces it with warp shuffles, one reduction per segment.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

// Max over the block; every thread gets the result.  red holds 33 floats.
__device__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : -INFINITY;
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  v = red[32];
  __syncthreads();  // red is reused by the next call
  return v;
}

__global__ void __launch_bounds__(kThreads) segmax_kernel(const float* __restrict__ y, int T,
                                                          const int* __restrict__ lengths,
                                                          const int* __restrict__ series,
                                                          const int* __restrict__ k_eff, int k_max,
                                                          float* __restrict__ out) {
  __shared__ float red[33];
  const int r = blockIdx.x;
  const int sid = series[r];
  const float* row = y + (size_t)sid * T;
  const int len = lengths[sid];
  const int ke = k_eff[r];
  const int seg_len = max(len / max(ke, 1), 1);
  float last = 0.0f;  // last finite peak to the left (0 before the first)
  for (int s = 0; s < k_max; ++s) {
    float peak = -INFINITY;
    if (s < ke) {  // uniform across the block
      const int start = min(s * seg_len, len);
      const int end = max(s == ke - 1 ? len : min((s + 1) * seg_len, len), start);
      const int stop = min(end, T);
      float v = -INFINITY;
      for (int p = start + threadIdx.x; p < stop; p += blockDim.x) v = fmaxf(v, row[p]);
      peak = block_max(v, red);
    }
    if (isfinite(peak)) last = peak;
    if (threadIdx.x == 0) out[(size_t)r * k_max + s] = last;
  }
}

}  // namespace

// y (S, T) f32, lengths (S,) i32, series/k_eff (rows,) i32 -> out (rows, k_max) f32.
extern "C" int segmax_launch(const float* y, int T, const int* lengths, const int* series, const int* k_eff,
                             int k_max, int rows, float* out, cudaStream_t stream) {
  if (rows > 0) segmax_kernel<<<rows, kThreads, 0, stream>>>(y, T, lengths, series, k_eff, k_max, out);
  return (int)cudaGetLastError();
}
