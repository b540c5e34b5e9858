// fitstats: the weighted OLS statistic bank of k segment regressions, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/fitstats.py (_fitstats_kernel /
// fitstats_pallas), which accumulated the bank in one (8, 128) output block
// revisited across a sequential grid axis over 512-row tiles of the batch.
// Blocks on this card run in no order and carry nothing between them, so
// the sum over the batch takes two passes:
//   1. each block folds a fixed contiguous range of rows into one partial
//      row: the scalars n, sum(w u), sum(w u u) once for the block, and the
//      2k column sums sum(w p_c), sum(w u p_c);
//   2. one block sums the partial rows, a warp per statistic: each lane adds
//      a fixed stride of blocks in order, then the warp's shuffle tree.
// Every sum runs in an order fixed by (B, k) alone and there are no atomics,
// so the bank is the same bits on every run.
//
// Semantics (repro_torch.kernels.fitstats.fit_stats_plain, the reference's
// ref.fit_stats): out[c] = (sum w, sum (w u), sum (w u) u, sum w p_c,
// sum (w u) p_c) over all rows, in float32.  Rows are weighted, never
// skipped: a row of weight 0 holding NaN or inf poisons the bank, as it does
// in the reference.  -fmad=false keeps each product and sum rounded on its
// own, as PyTorch's elementwise ops round them.
//
// Layout of pass 1: thread t < (256 / k) * k owns column c = t % k and rows
// r0 + t / k, stepping by 256 / k, so each step of the block reads one
// contiguous stretch of the row-major peaks.  Bound: memory, the peaks'
// B * k * 4 bytes over the card's 3.35 TB/s (four operations a value).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 128;

// Sum over the block, in a fixed order; every thread gets the result.  red
// holds 33 floats.
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? red[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  v = red[32];
  __syncthreads();  // red is reused by the next call
  return v;
}

// partial is (3 + 2k, blocks), statistic-major: row s holds statistic s of
// every block (0..2 the scalars, 3..3+k-1 sum w p_c, 3+k.. sum w u p_c).
__global__ void __launch_bounds__(kThreads) fitstats_partial_kernel(const float* __restrict__ x,
                                                                    const float* __restrict__ peaks,
                                                                    const float* __restrict__ w, int B, int k,
                                                                    int rows_per_block, int blocks,
                                                                    float* __restrict__ partial) {
  __shared__ float red[33];
  __shared__ float col_y[kThreads], col_xy[kThreads];
  const int g = blockIdx.x;
  const long long r0 = (long long)g * rows_per_block;
  const long long r1 = min(r0 + rows_per_block, (long long)B);

  float n = 0.0f, sx = 0.0f, sxx = 0.0f;
  for (long long r = r0 + threadIdx.x; r < r1; r += kThreads) {
    const float wu = w[r] * x[r];
    n += w[r];
    sx += wu;
    sxx += wu * x[r];
  }
  n = block_sum(n, red);
  sx = block_sum(sx, red);
  sxx = block_sum(sxx, red);

  const int step = kThreads / k;  // rows a step of the block covers
  const int c = threadIdx.x % k, m = threadIdx.x / k;
  float sy = 0.0f, sxy = 0.0f;
  if (m < step) {
#pragma unroll 4
    for (long long r = r0 + m; r < r1; r += step) {
      const float p = peaks[r * k + c];
      sy += w[r] * p;
      sxy += (w[r] * x[r]) * p;
    }
  }
  col_y[threadIdx.x] = sy;
  col_xy[threadIdx.x] = sxy;
  __syncthreads();
  if (threadIdx.x < k) {
    float a = 0.0f, b = 0.0f;
    for (int j = 0; j < step; ++j) {
      a += col_y[threadIdx.x + j * k];
      b += col_xy[threadIdx.x + j * k];
    }
    partial[(size_t)(3 + threadIdx.x) * blocks + g] = a;
    partial[(size_t)(3 + k + threadIdx.x) * blocks + g] = b;
  }
  if (threadIdx.x == 0) {
    partial[g] = n;
    partial[(size_t)blocks + g] = sx;
    partial[(size_t)2 * blocks + g] = sxx;
  }
}

// One block: warp i sums statistics i, i + 8, ... over the blocks of pass 1
// and writes them into the (k, 5) bank.
__global__ void __launch_bounds__(kThreads) fitstats_final_kernel(const float* __restrict__ partial, int blocks,
                                                                  int k, float* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int s = warp; s < 3 + 2 * k; s += kWarps) {
    float v = 0.0f;
    for (int g = lane; g < blocks; g += 32) v += partial[(size_t)s * blocks + g];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane != 0) continue;
    if (s < 3) {
      for (int c = 0; c < k; ++c) out[c * 5 + s] = v;
    } else if (s < 3 + k) {
      out[(s - 3) * 5 + 3] = v;
    } else {
      out[(s - 3 - k) * 5 + 4] = v;
    }
  }
}

}  // namespace

// x, w (B,) f32, peaks (B, k) f32 row-major, 1 <= k <= 128; partial holds
// (3 + 2k) * blocks floats of scratch, blocks = ceil(B / rows_per_block)
// (at least 1) -> out (k, 5) f32.
extern "C" int fitstats_launch(const float* x, const float* peaks, const float* w, int B, int k, int rows_per_block,
                               int blocks, float* partial, float* out, cudaStream_t stream) {
  if (k < 1 || k > kMaxK || rows_per_block < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  fitstats_partial_kernel<<<blocks, kThreads, 0, stream>>>(x, peaks, w, B, k, rows_per_block, blocks, partial);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fitstats_final_kernel<<<1, kThreads, 0, stream>>>(partial, blocks, k, out);
  return (int)cudaGetLastError();
}
