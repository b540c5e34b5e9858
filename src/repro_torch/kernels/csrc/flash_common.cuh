// flash_common: the device pieces that flash.cu (the attention forward) and
// flash_bwd.cu (its backward) share, for sm_90a.
//
//   * Op<T>: loads, rounding and stores of the operand types (f32, bf16);
//   * the PTX wrappers: cp.async copies, ldmatrix, and the tensor cores'
//     mma.sync.m16n8k16 with bf16 operands and f32 accumulators, whose C
//     fragment (m16n8) is the A fragment (m16n8k16) in pairs, so scores go
//     from accumulators to A operands in registers (pack_bf16; flash_bwd.cu's
//     wgmma accumulators likewise);
//   * a row's log-sum-exp for the backward (row_lse);
//   * the tile-skipping rule (kernels/flash.py:flash_tile_live): a tile's
//     state from its summary (min, max and count of its valid k_pos) and the
//     rows' q_pos bounds, and the list of live tiles.

#pragma once

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNeg = -1.0e30f;

// A row's log-sum-exp from its running max and sum; +inf for a row with no
// valid key (m = -1e30), so that the backward's exp(s - lse) is 0 at every
// slot of it (kernels/flash.py:LSE_EMPTY).
__device__ __forceinline__ float row_lse(float m, float l) { return m == kNeg ? INFINITY : m + logf(l); }

// ---- operand types -------------------------------------------------------

// Shared rows of Q and K in flash_kernel_cores are padded so that the
// threads of a warp reading one column of 16 or 32 key rows hit distinct
// banks: an odd stride in 4-byte words (f32: hd + 1; bf16: (hd + 2) / 2).
template <typename T>
struct Op;

template <>
struct Op<float> {
  static constexpr int kPad = 1;
  __device__ static float2 load2(const float* p) { return make_float2(p[0], p[1]); }
  __device__ static float load(const float* p) { return *p; }
  __device__ static float round(float x) { return x; }
  __device__ static float store(float x) { return x; }
};

template <>
struct Op<bf16> {
  static constexpr int kPad = 2;
  __device__ static float2 load2(const bf16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  __device__ static float load(const bf16* p) { return __bfloat162float(*p); }
  __device__ static float round(float x) { return __bfloat162float(__float2bfloat16(x)); }
  __device__ static bf16 store(float x) { return __float2bfloat16(x); }
};

// ---- PTX wrappers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, asynchronously; zeros where !pred.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- tile summaries and liveness ------------------------------------------

// 0: no (row, key) pair of the block can be valid; 2: every pair is valid;
// 1: otherwise.  The rule of kernels/flash.py:flash_tile_live.
__device__ __forceinline__ int tile_state(int4 ts, int bn, int qmin, int qmax, int causal, int window) {
  if (ts.z == 0) return 0;
  if (causal && ts.x > qmax) return 0;
  if (window > 0 && (long long)ts.y <= (long long)qmin - window) return 0;
  const bool full = ts.z == bn && (!causal || ts.y <= qmin) && (window <= 0 || (long long)ts.x > (long long)qmax - window);
  return full ? 2 : 1;
}

// min and max q_pos of rows [r0, r1) (row r is query r / G), in every lane.
__device__ __forceinline__ void row_bounds(const int* __restrict__ qp, int G, int r0, int r1, int& qmin, int& qmax) {
  const int lane = threadIdx.x % 32;
  qmin = INT_MAX, qmax = INT_MIN;
  for (int t = r0 / G + lane; t <= (r1 - 1) / G; t += 32) qmin = min(qmin, qp[t]), qmax = max(qmax, qp[t]);
  for (int off = 16; off > 0; off >>= 1) {
    qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, off));
    qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, off));
  }
}

// Shared `list` holds the states of tiles t0 .. t0 + n - 1; compacts the
// live ones, in order, to its front as (tile << 2) | state and returns their
// number.  Every thread takes part.
__device__ int compact_live(int* list, int n, int t0, int* count) {
  __syncthreads();
  if (threadIdx.x < 32) {  // compact in place: a lane writes at or below the slot it read
    const int lane = threadIdx.x;
    int cnt = 0;
    for (int base = 0; base < n; base += 32) {
      const int st = base + lane < n ? list[base + lane] : 0;
      const unsigned live = __ballot_sync(0xffffffffu, st != 0);
      if (st) list[cnt + __popc(live & ((1u << lane) - 1u))] = ((t0 + base + lane) << 2) | st;
      cnt += __popc(live);
    }
    if (lane == 0) *count = cnt;
  }
  __syncthreads();
  return *count;
}

// The live tiles of [t0, t1), in order, into shared `list` as
// (tile << 2) | state; returns their number.  Every thread takes part.
template <int NT>
__device__ int live_list(const int4* __restrict__ tiles, int t0, int t1, int bn, int qmin, int qmax, int causal,
                         int window, int* list, int* count) {
  const int n = t1 - t0;
  for (int i = threadIdx.x; i < n; i += NT) list[i] = tile_state(tiles[t0 + i], bn, qmin, qmax, causal, window);
  return compact_live(list, n, t0, count);
}

}  // namespace
