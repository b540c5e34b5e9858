// segmax: per-segment peaks of padded memory series, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/segmax.py (_segmax_kernel /
// segmax_pallas), whose output block was revisited across a sequential grid
// axis over T.  Here one warp owns one row (8 rows to a 256-thread block)
// and walks its segments itself, so no warp depends on another and nothing
// is revisited.
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
// Bound: memory, each valid sample read once (one compare per sample), the
// series bytes over the card's 3.35 TB/s.  The series are short (~70
// samples a segment at the grid's largest bucket), so a block per row left
// most of its threads idle and paid three barriers a segment.  Here the
// lanes stride over a segment, with 16-byte loads on its aligned middle
// where the row's base is 16-byte aligned (T % 4 == 0), and a 5-step
// __shfl_xor_sync max ends it: no shared memory and no barrier.  The
// forward fill is a register; lane s % 32 keeps segment s's peak, and the
// row's peaks are written 32 at a time, coalesced.

#include <cuda_runtime.h>
#include <math.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// This lane's max of row[start, stop) (-inf where it holds no sample).
// vec: the row starts 16-byte aligned, so [start, stop) splits into a head
// of at most 3 samples, float4 loads, and a tail of at most 3.
__device__ __forceinline__ float lane_max(const float* __restrict__ row, int start, int stop, int lane, bool vec) {
  float v = -INFINITY;
  if (!vec) {
    for (int p = start + lane; p < stop; p += 32) v = fmaxf(v, __ldg(row + p));
    return v;
  }
  const int a = min((start + 3) & ~3, stop);
  const int b = max(stop & ~3, a);
  if (start + lane < a) v = __ldg(row + start + lane);
  const float4* row4 = reinterpret_cast<const float4*>(row);
  for (int q = (a >> 2) + lane; q < (b >> 2); q += 32) {
    const float4 x = __ldg(row4 + q);
    v = fmaxf(v, fmaxf(fmaxf(x.x, x.y), fmaxf(x.z, x.w)));
  }
  if (b + lane < stop) v = fmaxf(v, __ldg(row + b + lane));
  return v;
}

__global__ void __launch_bounds__(kThreads) segmax_kernel(const float* __restrict__ y, int T,
                                                          const int* __restrict__ lengths,
                                                          const int* __restrict__ series,
                                                          const int* __restrict__ k_eff, int k_max, int rows,
                                                          bool vec, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (r >= rows) return;  // the whole warp
  const int sid = series[r];
  const float* row = y + (size_t)sid * T;
  const int len = lengths[sid];
  const int ke = k_eff[r];
  const int seg_len = max(len / max(ke, 1), 1);
  const int real = min(max(ke, 0), k_max);  // segments with samples to read
  float* o = out + (size_t)r * k_max;
  float last = 0.0f;  // last finite peak to the left (0 before the first)
  for (int c = 0; c < k_max; c += 32) {
    float mine = 0.0f;  // segment c + lane's peak
    for (int s = c; s < min(c + 32, real); ++s) {
      const int start = min(s * seg_len, len);
      const int end = s == ke - 1 ? len : min((s + 1) * seg_len, len);
      float v = lane_max(row, start, max(min(end, T), start), lane, vec);
      for (int m = 16; m > 0; m >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, m));
      if (isfinite(v)) last = v;
      if (lane == s - c) mine = last;
    }
    if (c + lane >= real) mine = last;  // empty segments past k_eff
    if (c + lane < k_max) o[c + lane] = mine;
  }
}

}  // namespace

// y (S, T) f32, lengths (S,) i32, series/k_eff (rows,) i32 -> out (rows, k_max) f32.
extern "C" int segmax_launch(const float* y, int T, const int* lengths, const int* series, const int* k_eff,
                             int k_max, int rows, float* out, cudaStream_t stream) {
  const bool vec = reinterpret_cast<uintptr_t>(y) % 16 == 0 && T % 4 == 0;
  if (rows > 0)
    segmax_kernel<<<(rows + kRowsPerBlock - 1) / kRowsPerBlock, kThreads, 0, stream>>>(y, T, lengths, series, k_eff,
                                                                                        k_max, rows, vec, out);
  return (int)cudaGetLastError();
}
