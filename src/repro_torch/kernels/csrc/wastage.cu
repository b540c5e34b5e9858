// wastage: first OOM sample and GiB*s wastage of allocation attempts, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/wastage.py (_wastage_kernel /
// wastage_pallas), which carried a failed / fail-position state machine in
// an output block revisited across a sequential grid axis over T.  Blocks on
// this card run in no order, so one block owns one attempt row and makes
// two passes over T itself:
//   1. a(t) at every valid sample, the success integral sum(a - y), and the
//      first failing position (a block min-reduce);
//   2. if the attempt failed, the failure integral sum(a) up to and
//      including that position.
// Sums accumulate in f32 in a fixed order, with no atomics, so every run
// gives the same bits.
//
// The step function is a(t) = values[min(#{bounds < t}, k - 1)] at
// t = (pos + 0.5) * interval, as the reference engine's _attempt evaluates
// it (repro/sim/jax_sim.py).  The TPU kernel's sum of step increments is not
// used: v1 + (v2 - v1) is not always v2 in f32, which can move a fail index.
//
// Row r reads series[r] of y (S, T): the method rows of one execution share
// its series through L2.  Bound: memory, the series bytes of one retry
// round over the card's 3.35 TB/s (k compares per sample are far below the
// f32 rate).

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 128;

__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  v = red[32];
  __syncthreads();
  return v;
}

__device__ int block_min(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : INT_MAX;
    for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  v = red[32];
  __syncthreads();
  return v;
}

__device__ __forceinline__ float alloc_at(int p, float interval, const float* sb, const float* sv, int k) {
  const float t = ((float)p + 0.5f) * interval;
  int idx = 0;
  for (int s = 0; s < k; ++s) idx += t > sb[s];
  return sv[min(idx, k - 1)];
}

__global__ void __launch_bounds__(kThreads) wastage_kernel(const float* __restrict__ y, int T,
                                                           const int* __restrict__ lengths,
                                                           const int* __restrict__ series,
                                                           const float* __restrict__ bounds,
                                                           const float* __restrict__ values, int k,
                                                           float interval, float* __restrict__ waste,
                                                           int* __restrict__ fail_idx) {
  __shared__ float sb[kMaxK], sv[kMaxK];
  __shared__ float redf[33];
  __shared__ int redi[33];
  const int r = blockIdx.x;
  for (int s = threadIdx.x; s < k; s += blockDim.x) {
    sb[s] = bounds[(size_t)r * k + s];
    sv[s] = values[(size_t)r * k + s];
  }
  __syncthreads();
  const int sid = series[r];
  const float* row = y + (size_t)sid * T;
  const int len = min(lengths[sid], T);

  float succ = 0.0f;
  int first = INT_MAX;
  for (int p = threadIdx.x; p < len; p += blockDim.x) {
    const float a = alloc_at(p, interval, sb, sv, k);
    const float yv = row[p];
    succ += a - yv;
    if (yv > a && first == INT_MAX) first = p;  // p rises within a thread
  }
  const int fail = block_min(first, redi);
  float w = block_sum(succ, redf);
  if (fail != INT_MAX) {  // uniform across the block
    float part = 0.0f;
    for (int p = threadIdx.x; p <= fail; p += blockDim.x) part += alloc_at(p, interval, sb, sv, k);
    w = block_sum(part, redf);
  }
  if (threadIdx.x == 0) {
    waste[r] = w * interval / 1024.0f;
    fail_idx[r] = fail == INT_MAX ? -1 : fail;
  }
}

}  // namespace

// y (S, T) f32, lengths (S,) i32, series (rows,) i32, bounds/values (rows, k) f32
// -> waste (rows,) f32 GiB*s, fail_idx (rows,) i32 (-1 on success).
extern "C" int wastage_launch(const float* y, int T, const int* lengths, const int* series, const float* bounds,
                              const float* values, int k, int rows, float interval, float* waste, int* fail_idx,
                              cudaStream_t stream) {
  if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  if (rows > 0)
    wastage_kernel<<<rows, kThreads, 0, stream>>>(y, T, lengths, series, bounds, values, k, interval, waste,
                                                  fail_idx);
  return (int)cudaGetLastError();
}
