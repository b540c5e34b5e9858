// moe_combine: the weighted combine of a routed MoE layer, for sm_90a.
//
// No TPU kernel: it replaces the combine that the reference leaves to XLA
// in repro/models/layers.py (_moe_dispatch_compute and moe): the weighted
// gather of each assignment's expert output and the scatter-add of it into
// its token's row.
//
// Semantics (repro_torch.kernels.moe_combine.moe_combine_plain): token n
// starts from zero and adds out_buf[e, pos] * w over its kept assignments
// (0 <= e < E and 0 <= pos < C) in ascending expert id (ties, which top-k
// never gives, in order of j), rounding to the activation dtype after each
// multiply and after each add, with w rounded to that dtype first.  That
// is the reference's order and rounding: its scatter-add visits the updates
// in the expert-sorted order, in the activation dtype.  Built with
// -fmad=false, so an f32 multiply and the add after it round apart, as
// PyTorch's elementwise ops round them; in bf16 both round through float
// as PyTorch's bf16 ops do.  The result is the plain version's bit for
// bit, and the same from run to run (index_add_ on the card adds with
// atomics in an order that changes between runs).
//
// A block per token: threads j < k rank the token's assignments by expert
// into shared memory, then each thread owns 16-byte column groups of the
// row (one element where the row or a base is not 16-byte aligned) and
// runs the k terms through registers.  Bound: bytes, each kept row of
// out_buf read once and out written once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxK = 64;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

// VEC elements of T a column group (16 bytes, or one element).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) combine_kernel(const T* __restrict__ out_buf, int E, int C, int D,
                                                           const int* __restrict__ ids, const int* __restrict__ pos,
                                                           const float* __restrict__ w, int k, T* __restrict__ out) {
  __shared__ long long s_row[kMaxK];  // out_buf row of the r-th assignment by expert, -1 if not kept
  __shared__ float s_w[kMaxK];
  const int n = blockIdx.x;
  if (threadIdx.x < k) {
    const int j = threadIdx.x;
    const int e = ids[(size_t)n * k + j], p = pos[(size_t)n * k + j];
    int rank = 0;
    for (int i = 0; i < k; ++i) {
      const int ei = ids[(size_t)n * k + i];
      rank += ei < e || (ei == e && i < j);
    }
    const bool kept = e >= 0 && e < E && p >= 0 && p < C;
    s_row[rank] = kept ? (long long)e * C + p : -1;
    s_w[rank] = w[(size_t)n * k + j];
  }
  __syncthreads();
  const int groups = D / VEC;
  T* dst = out + (size_t)n * D;
  for (int g = threadIdx.x; g < groups; g += kThreads) {
    alignas(16) T acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = from_float<T>(0.0f);
    for (int r = 0; r < k; ++r) {
      const long long row = s_row[r];
      if (row < 0) continue;
      const float wt = to_float(from_float<T>(s_w[r]));
      alignas(16) T x[VEC];
      if constexpr (VEC * sizeof(T) == 16) {
        *reinterpret_cast<uint4*>(x) = __ldg(reinterpret_cast<const uint4*>(out_buf + row * D) + g);
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) x[v] = out_buf[row * D + (size_t)g * VEC + v];
      }
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const T prod = from_float<T>(to_float(x[v]) * wt);
        acc[v] = from_float<T>(to_float(acc[v]) + to_float(prod));
      }
    }
    if constexpr (VEC * sizeof(T) == 16) {
      reinterpret_cast<uint4*>(dst)[g] = *reinterpret_cast<const uint4*>(acc);
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) dst[(size_t)g * VEC + v] = acc[v];
    }
  }
}

template <typename T>
int combine(const void* out_buf, int E, int C, int D, const int* ids, const int* pos, const float* w, int N, int k,
            void* out, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = D % kVec == 0 && reinterpret_cast<uintptr_t>(out_buf) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const T* src = static_cast<const T*>(out_buf);
  T* dst = static_cast<T*>(out);
  if (vec)
    combine_kernel<T, kVec><<<N, kThreads, 0, stream>>>(src, E, C, D, ids, pos, w, k, dst);
  else
    combine_kernel<T, 1><<<N, kThreads, 0, stream>>>(src, E, C, D, ids, pos, w, k, dst);
  return (int)cudaGetLastError();
}

}  // namespace

// out_buf (E, C, D), ids / pos (N, k) int32, w (N, k) f32 -> out (N, D);
// dtype 0 float32, 1 bfloat16 (out_buf's and out's); k <= 64.
extern "C" int moe_combine_launch(const void* out_buf, int E, int C, int D, const int* ids, const int* pos,
                                  const float* w, int N, int k, int dtype, void* out, cudaStream_t stream) {
  if (N <= 0) return 0;
  if (k < 0 || k > kMaxK) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return combine<float>(out_buf, E, C, D, ids, pos, w, N, k, out, stream);
  return combine<__nv_bfloat16>(out_buf, E, C, D, ids, pos, w, N, k, out, stream);
}
