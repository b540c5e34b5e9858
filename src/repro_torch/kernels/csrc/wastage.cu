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
// Sums accumulate in a fixed order, with no atomics, so every run gives the
// same bits.
//
// The step function is a(t) = values[min(#{bounds < t}, k - 1)] at
// t = (pos + 0.5) * interval, as the reference engine's _attempt evaluates
// it (repro/sim/jax_sim.py).  The TPU kernel's sum of step increments is not
// used: v1 + (v2 - v1) is not always v2 in f32, which can move a fail index.
//
// Three precisions, one template <V, A>: V is the schedule's type (t, a(t)
// and the y > a decision), A the accumulator's.  The series stay float32
// (every value of them is exact in float64):
//   0: V = A = float   -- the Fig. 7 grid;
//   1: V = float, A = double -- float32 retry ladders summed in float64, as
//      the reference sums them under its x64 context (jax_sim._acc_dtype);
//   2: V = A = double  -- the float64 (x64) retry ladders.
//
// Row r reads series[r] of y (S, T): the method rows of one execution share
// its series through L2.  Bound: memory, the series bytes of one retry
// round over the card's 3.35 TB/s (k compares per sample are far below the
// f32 and f64 rates).

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 128;

template <typename A>
__device__ A block_sum(A v, A* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : A(0);
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

template <typename V>
__device__ __forceinline__ V alloc_at(int p, V interval, const V* sb, const V* sv, int k) {
  const V t = ((V)p + V(0.5)) * interval;
  int idx = 0;
  for (int s = 0; s < k; ++s) idx += t > sb[s];
  return sv[min(idx, k - 1)];
}

template <typename V, typename A>
__global__ void __launch_bounds__(kThreads) wastage_kernel(const float* __restrict__ y, int T,
                                                           const int* __restrict__ lengths,
                                                           const int* __restrict__ series,
                                                           const V* __restrict__ bounds,
                                                           const V* __restrict__ values, int k,
                                                           V interval, A scale, A* __restrict__ waste,
                                                           int* __restrict__ fail_idx) {
  __shared__ V sb[kMaxK], sv[kMaxK];
  __shared__ A reda[33];
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

  A succ = A(0);
  int first = INT_MAX;
  for (int p = threadIdx.x; p < len; p += blockDim.x) {
    const V a = alloc_at(p, interval, sb, sv, k);
    const V yv = (V)row[p];
    succ += (A)a - (A)yv;
    if (yv > a && first == INT_MAX) first = p;  // p rises within a thread
  }
  const int fail = block_min(first, redi);
  A w = block_sum(succ, reda);
  if (fail != INT_MAX) {  // uniform across the block
    A part = A(0);
    for (int p = threadIdx.x; p <= fail; p += blockDim.x) part += (A)alloc_at(p, interval, sb, sv, k);
    w = block_sum(part, reda);
  }
  if (threadIdx.x == 0) {
    waste[r] = w * scale / A(1024);
    fail_idx[r] = fail == INT_MAX ? -1 : fail;
  }
}

template <typename V, typename A>
int launch(const float* y, int T, const int* lengths, const int* series, const void* bounds, const void* values,
           int k, int rows, double interval, void* waste, int* fail_idx, cudaStream_t stream) {
  if (rows > 0)
    wastage_kernel<V, A><<<rows, kThreads, 0, stream>>>(y, T, lengths, series, (const V*)bounds,
                                                        (const V*)values, k, (V)interval, (A)interval,
                                                        (A*)waste, fail_idx);
  return (int)cudaGetLastError();
}

}  // namespace

// y (S, T) f32, lengths (S,) i32, series (rows,) i32, bounds/values (rows, k)
// of the schedule's type -> waste (rows,) of the accumulator's type in GiB*s,
// fail_idx (rows,) i32 (-1 on success).  precision: 0 f32/f32, 1 f32/f64,
// 2 f64/f64 (schedule/accumulator).
extern "C" int wastage_launch(const float* y, int T, const int* lengths, const int* series, const void* bounds,
                              const void* values, int k, int rows, double interval, int precision, void* waste,
                              int* fail_idx, cudaStream_t stream) {
  if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  switch (precision) {
    case 0:
      return launch<float, float>(y, T, lengths, series, bounds, values, k, rows, interval, waste, fail_idx, stream);
    case 1:
      return launch<float, double>(y, T, lengths, series, bounds, values, k, rows, interval, waste, fail_idx,
                                   stream);
    case 2:
      return launch<double, double>(y, T, lengths, series, bounds, values, k, rows, interval, waste, fail_idx,
                                    stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
