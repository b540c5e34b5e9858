// xla_scan: block-collective running sums in the order of XLA's CPU cumsum,
// for sm_90a -- the card's one copy of kernels/scan.py's order.
//
// The cluster's placements are held bit-identical to the reference's, whose
// running sums are jnp.cumsum on XLA's CPU backend: sequential within blocks
// of 16, then the block totals the same way, recursively.  Two kernels hold
// such sums: rangemax.cu (the epoch's fit tables) and compaction.cu (the
// sweep's chunk-boundary fold).  Each thread folds one block of 16 in order
// from +0.0 (so a leading -0.0 becomes +0.0); the block totals are folded
// the same way, level by level, until at most 16 are left (three levels past
// L = 256); then each block adds its exclusive prefix (+0.0 for block 0),
// top level first.  The sum at element i depends on elements 0..i only,
// never on the row's length: a shorter scan of a row's prefix gives the same
// bits there.  Scan buffers pad one slot per 16 so that the folds' strided
// reads spread over the banks.  Only additions: the including sources build
// with -fmad=false.

#pragma once

#include <cuda_runtime.h>

namespace xla_scan {

constexpr int kBlock = 16;  // scan.XLA_SCAN_BLOCK
constexpr int kMaxScanLevels = 8;

// Slot of element i in a scan buffer: one pad slot after every 16.
__host__ __device__ __forceinline__ int padded(int i) { return i + i / kBlock; }

template <typename T>
__device__ __forceinline__ T neg_inf();
template <>
__device__ __forceinline__ float neg_inf<float>() {
  return __int_as_float(0xff800000);
}
template <>
__device__ __forceinline__ double neg_inf<double>() {
  return __longlong_as_double(0xfff0000000000000ULL);
}

// The levels of the running sum: n[0] = L, n[l + 1] = ceil(n[l] / 16) while
// n[l] > 16; level l >= 1 lives at off[l] of the totals scratch.
struct ScanShape {
  int depth;
  int n[kMaxScanLevels];
  int off[kMaxScanLevels];
  int slots;  // of the totals scratch
};

__host__ __device__ inline ScanShape scan_shape(int L) {
  ScanShape s{};
  s.depth = 1;
  s.n[0] = L;
  int off = 0;
  while (s.n[s.depth - 1] > kBlock && s.depth < kMaxScanLevels) {
    const int m = (s.n[s.depth - 1] + kBlock - 1) / kBlock;
    s.n[s.depth] = m;
    s.off[s.depth] = off;
    off += padded(m) + 1;
    ++s.depth;
  }
  s.slots = off;
  return s;
}

// True when a row of L elements has too many levels for ScanShape.
__host__ __device__ inline bool too_long(int L) {
  const ScanShape s = scan_shape(L);
  return s.n[s.depth - 1] > kBlock;
}

// Block-collective, after scan[padded(i)] holds d[i] for i < L and a
// barrier: the running sum in scan.cumsum(d, 16)'s order.  Leaves level 0's
// block-local sums in scan and every upper level's finished prefix in tot;
// element i's sum is then prefix(i, scan, tot + sh.off[1], sh.depth > 1).
// Ends with a barrier.
template <typename T>
__device__ void fold_levels(T* scan, T* tot, const ScanShape& sh) {
  for (int l = 0; l < sh.depth; ++l) {  // fold every block of 16, bottom up
    T* buf = l == 0 ? scan : tot + sh.off[l];
    T* up = l + 1 < sh.depth ? tot + sh.off[l + 1] : nullptr;
    const int n = sh.n[l];
    for (int j = threadIdx.x; j * kBlock < n; j += blockDim.x) {
      T acc = T(0);
      const int end = min(n, (j + 1) * kBlock);
      for (int i = j * kBlock; i < end; ++i) {
        acc = acc + buf[padded(i)];
        buf[padded(i)] = acc;
      }
      if (up) up[padded(j)] = acc;
    }
    __syncthreads();
  }
  for (int l = sh.depth - 2; l >= 1; --l) {  // add each block's exclusive prefix, top down
    T* buf = tot + sh.off[l];
    const T* up = tot + sh.off[l + 1];
    for (int i = threadIdx.x; i < sh.n[l]; i += blockDim.x) {
      const int b = i / kBlock;
      buf[padded(i)] = buf[padded(i)] + (b ? up[padded(b - 1)] : T(0));
    }
    __syncthreads();
  }
}

// Block-collective: load d[0..L) into the scan buffer and fold it.
template <typename T>
__device__ void running_sum(const T* __restrict__ d, int L, T* scan, T* tot, const ScanShape& sh) {
  for (int i = threadIdx.x; i < L; i += blockDim.x) scan[padded(i)] = d[i];
  __syncthreads();
  fold_levels(scan, tot, sh);
}

// Element i's running sum after fold_levels; tot1 = tot + sh.off[1], deep =
// sh.depth > 1.
template <typename T>
__device__ __forceinline__ T prefix(int i, const T* scan, const T* tot1, bool deep) {
  T cs = scan[padded(i)];
  if (deep) cs = cs + (i >= kBlock ? tot1[padded(i / kBlock - 1)] : T(0));
  return cs;
}

// Element i of the masked running demand of the event row t (L slots):
// base + the sum, -inf unless i is the last event of its instant.
template <typename T>
__device__ __forceinline__ T masked_demand(int i, int L, const T* scan, const T* tot1, bool deep,
                                           const T* __restrict__ t, T base) {
  const bool last = i + 1 < L ? t[i] != t[i + 1] : isfinite(t[i]);
  return last ? base + prefix(i, scan, tot1, deep) : neg_inf<T>();
}

// The card's opt-in shared memory a block may take (227 KB on H100).
inline int optin_limit() {
  static int limit = -1;
  if (limit < 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
      limit = 48 * 1024;
  }
  return limit;
}

// Lift a kernel's dynamic shared memory cap (48 KB) to the opt-in limit,
// once.  The kernel has no static shared memory.
template <typename K>
int allow_shared(K kernel, bool& done) {
  if (done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin_limit());
  done = err == cudaSuccess;
  return (int)err;
}

}  // namespace xla_scan
