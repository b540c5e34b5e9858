// moe_combine_bwd: the backward of the MoE combine, for sm_90a.
//
// No TPU kernel: it replaces the gradient that JAX's autodiff takes of the
// reference's weighted gather and scatter-add in repro/models/layers.py
// (moe :565-566, _moe_dispatch_compute :450-451), which XLA computes.
//
// Semantics (repro_torch.kernels.moe_combine_bwd.moe_combine_bwd_plain),
// from dout (N, D), the forward's out_buf (E, C, D), ids / pos (N, k) and
// weights (N, k) f32, an assignment (n, j) kept when 0 <= e < E and
// 0 <= pos < C:
//   d_out_buf (E, C, D) in the activation dtype: a kept slot's row is
//     dout[n] * w, w rounded to the dtype first, the product rounded once;
//     every other slot is zero.
//   dw (N, k) f32: for a kept assignment, the dtype's rounding of the f32
//     sum over d of out_buf[e, pos, d] * dout[n, d], each product rounded
//     to the dtype; 0 for a dropped one or an id outside [0, E).
// Built with -fmad=false, so the f32 product and the add after it round
// apart; d_out_buf is then the plain version's bit for bit.  dw sums in
// another order than the plain version (each thread's columns, then a
// fixed tree over the block), the same from run to run: no float atomics.
//
// Bound: bytes.  d_out_buf written once (672 MB at qwen3-moe's training
// shape N 8,192, k 8, E 128, C 641, D 4,096 bf16), dout read once, and
// the kept rows of out_buf read once for dw.  Two device kernels:
//   combine_bwd_fill_kernel (one block) counts each expert's kept
//   assignments into a scratch fill[E].  The kept slots of expert e are
//   [0, fill[e]), as moe_dispatch places them, so its empty span is
//   [fill[e], C).
//   combine_bwd_kernel: blocks [0, N) are tokens.  A token's block walks
//   its k assignments; threads own 16-byte column groups (one element
//   where a row or a base is not 16-byte aligned), read dout's group (L1
//   keeps the row for the k passes), write the weighted row to the slot,
//   and for dw add the products with out_buf's row, then reduce over the
//   block (warp shuffles, then the warps in order).  Blocks past N each
//   zero kZeroRows rows of one expert's empty span, so every byte of
//   d_out_buf is written once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kZeroRows = 16;  // rows of an expert's empty span a zero block writes
constexpr int kFillThreads = 1024;
constexpr int kMaxExperts = 1024;
constexpr int kMaxK = 64;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

__device__ __forceinline__ bool kept(int e, int p, int E, int C) { return e >= 0 && e < E && p >= 0 && p < C; }

// fill[e] = the kept assignments of expert e.
__global__ void __launch_bounds__(kFillThreads)
    combine_bwd_fill_kernel(const int* __restrict__ ids, const int* __restrict__ pos, int total, int E, int C,
                            int* __restrict__ fill) {
  __shared__ int s_count[kMaxExperts];
  for (int e = threadIdx.x; e < E; e += kFillThreads) s_count[e] = 0;
  __syncthreads();
  for (int f = threadIdx.x; f < total; f += kFillThreads) {
    const int e = ids[f], p = pos[f];
    if (kept(e, p, E, C)) atomicAdd(&s_count[e], 1);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += kFillThreads) fill[e] = s_count[e];
}

template <typename T, int VEC>
__device__ __forceinline__ void load_group(const T* __restrict__ src, size_t g, T (&x)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(x) = __ldg(reinterpret_cast<const uint4*>(src) + g);
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v) x[v] = src[g * VEC + v];
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_group(T* __restrict__ dst, size_t g, const T (&x)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    reinterpret_cast<uint4*>(dst)[g] = *reinterpret_cast<const uint4*>(x);
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v) dst[g * VEC + v] = x[v];
  }
}

// VEC elements of T a column group (16 bytes, or one element).  d_out_buf
// or dw may be null: that output is not wanted.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    combine_bwd_kernel(const T* __restrict__ dout, const T* __restrict__ out_buf, int E, int C, int D,
                       const int* __restrict__ ids, const int* __restrict__ pos, const float* __restrict__ w, int N,
                       int k, const int* __restrict__ fill, T* __restrict__ d_out_buf, float* __restrict__ dw) {
  const int groups = D / VEC;
  if ((int)blockIdx.x >= N) {  // a zero block: rows [r0, r1) of expert e's empty span
    const int z = blockIdx.x - N, spans = (C + kZeroRows - 1) / kZeroRows;
    const int e = z / spans;
    const int r0 = max((z % spans) * kZeroRows, fill[e]), r1 = min((z % spans + 1) * kZeroRows, C);
    if (r0 >= r1) return;
    T zero[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) zero[v] = from_float<T>(0.0f);
    T* dst = d_out_buf + ((size_t)e * C + r0) * D;
    const size_t n_groups = (size_t)(r1 - r0) * groups;
    for (size_t g = threadIdx.x; g < n_groups; g += kThreads) store_group<T, VEC>(dst, g, zero);
    return;
  }
  __shared__ float s_part[kWarps];
  const int n = blockIdx.x, lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const T* dy = dout + (size_t)n * D;
  for (int j = 0; j < k; ++j) {
    const int e = ids[(size_t)n * k + j], p = pos[(size_t)n * k + j];
    if (!kept(e, p, E, C)) {
      if (dw != nullptr && threadIdx.x == 0) dw[(size_t)n * k + j] = 0.0f;
      continue;
    }
    const size_t row = (size_t)e * C + p;
    const float wt = to_float(from_float<T>(w[(size_t)n * k + j]));
    float part = 0.0f;
    for (int g = threadIdx.x; g < groups; g += kThreads) {
      T y[VEC];
      load_group<T, VEC>(dy, g, y);
      if (d_out_buf != nullptr) {
        T o[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v) o[v] = from_float<T>(to_float(y[v]) * wt);
        store_group<T, VEC>(d_out_buf + row * D, g, o);
      }
      if (dw != nullptr) {
        T x[VEC];
        load_group<T, VEC>(out_buf + row * D, g, x);
#pragma unroll
        for (int v = 0; v < VEC; ++v) part += to_float(from_float<T>(to_float(x[v]) * to_float(y[v])));
      }
    }
    if (dw != nullptr) {  // block-uniform
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) s_part[warp] = part;
      __syncthreads();
      if (threadIdx.x == 0) {
        float s = 0.0f;
#pragma unroll
        for (int i = 0; i < kWarps; ++i) s += s_part[i];
        dw[(size_t)n * k + j] = to_float(from_float<T>(s));
      }
      __syncthreads();
    }
  }
}

template <typename T>
int combine_bwd(const void* dout, const void* out_buf, int E, int C, int D, const int* ids, const int* pos,
                const float* w, int N, int k, void* d_out_buf, float* dw, int* fill, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = D % kVec == 0 && aligned(dout) && (dw == nullptr || aligned(out_buf)) &&
                   (d_out_buf == nullptr || aligned(d_out_buf));
  long long blocks = N;
  if (d_out_buf != nullptr) {
    combine_bwd_fill_kernel<<<1, kFillThreads, 0, stream>>>(ids, pos, N * k, E, C, fill);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    blocks += (long long)E * ((C + kZeroRows - 1) / kZeroRows);
  }
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const T* dy = static_cast<const T*>(dout);
  const T* ob = static_cast<const T*>(out_buf);
  T* db = static_cast<T*>(d_out_buf);
  if (vec)
    combine_bwd_kernel<T, kVec><<<(unsigned)blocks, kThreads, 0, stream>>>(dy, ob, E, C, D, ids, pos, w, N, k, fill,
                                                                           db, dw);
  else
    combine_bwd_kernel<T, 1><<<(unsigned)blocks, kThreads, 0, stream>>>(dy, ob, E, C, D, ids, pos, w, N, k, fill,
                                                                        db, dw);
  return (int)cudaGetLastError();
}

}  // namespace

// dout (N, D), out_buf (E, C, D) in the dtype (0 float32, 1 bfloat16),
// ids / pos (N, k) int32, w (N, k) f32 -> d_out_buf (E, C, D) in the dtype
// and dw (N, k) f32, either null when not wanted; fill is a scratch of E
// int32 (used with d_out_buf).  E <= 1024, k <= 64.
extern "C" int moe_combine_bwd_launch(const void* dout, const void* out_buf, int E, int C, int D, const int* ids,
                                      const int* pos, const float* w, int N, int k, int dtype, void* d_out_buf,
                                      float* dw, int* fill, cudaStream_t stream) {
  if (E < 1 || E > kMaxExperts || C < 1 || k < 0 || k > kMaxK) return (int)cudaErrorInvalidValue;
  if (d_out_buf == nullptr && (N <= 0 || dw == nullptr)) return 0;
  if (dtype == 0)
    return combine_bwd<float>(dout, out_buf, E, C, D, ids, pos, w, N, k, d_out_buf, dw, fill, stream);
  return combine_bwd<__nv_bfloat16>(dout, out_buf, E, C, D, ids, pos, w, N, k, d_out_buf, dw, fill, stream);
}
