// xla_scan: running sums in the order of XLA's CPU cumsum, for sm_90a --
// the card's one copy of kernels/scan.py's order.
//
// The cluster's placements are held bit-identical to the reference's, whose
// running sums are jnp.cumsum on XLA's CPU backend: sequential within blocks
// of 16, then the block totals the same way, recursively.  Each block of 16
// is folded in order from +0.0 (so a leading -0.0 becomes +0.0); the block
// totals are folded the same way, level by level, until at most 16 are left
// (three levels past L = 256); then each block adds its exclusive prefix
// (+0.0 for block 0), top level first.  The sum at element i depends on
// elements 0..i only, never on the row's length: a shorter scan of a row's
// prefix gives the same bits there.  Only additions: the including sources
// build with -fmad=false.
//
// Two forms of it live here:
//
//   * fold_levels / running_sum (block-collective, through a scan buffer in
//     shared or global memory, a barrier a level): rangemax.cu (the epoch's
//     fit tables), compaction.cu (the sweep's chunk-boundary fold) and
//     scan.cu's long lines.  Scan buffers pad one slot per 16 so that the
//     folds' strided reads spread over the banks.
//   * warp_running_sum (warp-collective, no block barrier): scan.cu's lines
//     of up to 2,048 elements along the last axis, or along another when
//     they are few.  The line comes into a warp's slice of shared memory and
//     goes back out with coalesced copies; lane l sums the blocks of 16 l,
//     l + 32, ... in registers, and the upper levels' groups of 16 are
//     folded lane after lane with shuffles, in order (never as a tree,
//     which would change the bits).

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

// ---- A line a warp: coalesced through shared memory, summed in registers ---

// A clock that records nothing: warp_running_sum's default phase hook.
struct NoClock {
  __device__ void at(int) {}
};

// Elements a block of 16 takes in a warp's staging buffer: padded by one
// 16-byte piece, so that a quarter-warp's 16-byte reads of its lanes'
// blocks fall on distinct banks and every block starts 16-byte aligned.
template <typename T>
__host__ __device__ constexpr int staged_pitch() {
  return kBlock + 16 / (int)sizeof(T);
}

// Elements of a warp's staging buffer for lines of up to 512 R elements.
template <typename T, int R>
__host__ __device__ constexpr int staged_elems() {
  return R * 32 * staged_pitch<T>();
}

template <int Bytes>
__device__ __forceinline__ void cp_async_bytes(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src),
               "n"(Bytes)
               : "memory");
}

// The 16 elements of a block at s into v (+0.0 past the cnt left in the
// line, which may be <= 0): 16-byte reads when the block is whole.
__device__ __forceinline__ void read16(const float* s, int cnt, float (&v)[kBlock]) {
  if (cnt >= kBlock) {
#pragma unroll
    for (int j = 0; j < kBlock; j += 4) {
      const float4 x = *reinterpret_cast<const float4*>(s + j);
      v[j] = x.x;
      v[j + 1] = x.y;
      v[j + 2] = x.z;
      v[j + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < kBlock; ++q) v[q] = q < cnt ? s[q] : 0.0f;
  }
}
__device__ __forceinline__ void read16(const double* s, int cnt, double (&v)[kBlock]) {
  if (cnt >= kBlock) {
#pragma unroll
    for (int j = 0; j < kBlock; j += 2) {
      const double2 x = *reinterpret_cast<const double2*>(s + j);
      v[j] = x.x;
      v[j + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < kBlock; ++q) v[q] = q < cnt ? s[q] : 0.0;
  }
}

// v to the cnt (at most 16) elements left of the block at s.
__device__ __forceinline__ void write16(float* s, int cnt, const float (&v)[kBlock]) {
  if (cnt >= kBlock) {
#pragma unroll
    for (int j = 0; j < kBlock; j += 4) *reinterpret_cast<float4*>(s + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  } else {
#pragma unroll
    for (int q = 0; q < kBlock; ++q)
      if (q < cnt) s[q] = v[q];
  }
}
__device__ __forceinline__ void write16(double* s, int cnt, const double (&v)[kBlock]) {
  if (cnt >= kBlock) {
#pragma unroll
    for (int j = 0; j < kBlock; j += 2) *reinterpret_cast<double2*>(s + j) = make_double2(v[j], v[j + 1]);
  } else {
#pragma unroll
    for (int q = 0; q < kBlock; ++q)
      if (q < cnt) s[q] = v[q];
  }
}

// Warp-collective copy of a line between global memory (element i at
// g[i * stride]) and a warp's staging buffer (element i at slot (i / 16) *
// pitch + i % 16): into the buffer with cp.async, out of it with plain
// stores.  vec (stride 1, g 16-byte aligned): 16-byte pieces, lane l the
// pieces l, l + 32, ..., so each instruction moves 512 contiguous bytes;
// else (and for a tail shorter than a piece) element by element.
template <typename T>
__device__ __forceinline__ void stage_in(const T* __restrict__ g, int L, int stride, bool vec, T* buf) {
  constexpr int E = 16 / (int)sizeof(T), P = staged_pitch<T>();
  const int lane = threadIdx.x & 31;
  const int whole = vec ? L / E * E : 0;
  for (int i = lane * E; i < whole; i += 32 * E) cp_async_bytes<16>(buf + i / kBlock * P + i % kBlock, g + i);
  for (int i = whole + lane; i < L; i += 32)
    cp_async_bytes<sizeof(T)>(buf + i / kBlock * P + i % kBlock, g + (size_t)i * stride);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();
}

template <typename T>
__device__ __forceinline__ void stage_out(T* __restrict__ g, int L, int stride, bool vec, const T* buf) {
  constexpr int E = 16 / (int)sizeof(T), P = staged_pitch<T>();
  const int lane = threadIdx.x & 31;
  const int whole = vec ? L / E * E : 0;
  for (int i = lane * E; i < whole; i += 32 * E)
    *reinterpret_cast<uint4*>(g + i) = *reinterpret_cast<const uint4*>(buf + i / kBlock * P + i % kBlock);
  for (int i = whole + lane; i < L; i += 32) g[(size_t)i * stride] = buf[i / kBlock * P + i % kBlock];
}

// Warp-collective: o[0..L) = the running sum of d[0..L) in scan.cumsum(d,
// 16)'s order, element i of each at [i * stride], for L <= 512 R (at most
// 128 blocks, so at most three levels and the top one sequential), with no
// block barrier; vec: stride 1 and d and o 16-byte aligned; buf: the warp's
// staging_elems<T, R>() elements of shared memory.  The line comes in and
// goes out coalesced through buf (stage_in, stage_out).  Lane l owns the
// blocks b = l + 32 r (r < R): it reads each into registers and folds it
// from +0.0 in order, its R chains independent.  Level 1 groups blocks
// 16 g .. 16 g + 15, which are half a warp's lanes in one r: each lane
// folds its half's totals from +0.0 in lane order up to its own, from
// shuffles.  Level 2 (the groups' totals, at most 8) is folded the same way
// by every lane.  Each block then adds the level-1 sum of the block before
// it, the top level's prefix already in that sum.  clk.at(0..3) marks the
// phases (the copy in and level 0, level 1, level 2 and the prefixes, the
// copy out).
template <int R, typename T, typename Clock = NoClock>
__device__ __forceinline__ void warp_running_sum(const T* __restrict__ d, T* __restrict__ o, int L, int stride,
                                                 bool vec, T* buf, Clock clk = Clock()) {
  constexpr unsigned kAll = 0xffffffffu;
  constexpr int P = staged_pitch<T>();
  const int lane = threadIdx.x & 31, half = lane & 16, pos = lane & 15;
  stage_in(d, L, stride, vec, buf);
  T v[R][kBlock];
  T t[R];  // each block's total, then its level-1 sum
#pragma unroll
  for (int r = 0; r < R; ++r) read16(buf + (lane + 32 * r) * P, L - (lane + 32 * r) * kBlock, v[r]);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    T acc = T(0);
#pragma unroll
    for (int q = 0; q < kBlock; ++q) {
      acc = acc + v[r][q];
      v[r][q] = acc;
    }
    t[r] = acc;  // +0.0 for a block past the line, as the plain version's padding
  }
  clk.at(0);
#pragma unroll
  for (int r = 0; r < R; ++r) {  // level 1: a half-warp's 16 totals, lane after lane
    T acc = T(0);
#pragma unroll
    for (int j = 0; j < kBlock; ++j) {
      const T x = __shfl_sync(kAll, t[r], half | j);
      if (j <= pos) acc = acc + x;
    }
    t[r] = acc;
  }
  clk.at(1);
  T ex[2 * R];  // level 2: group g = 2 r + (half != 0); its exclusive prefix
  {
    T acc = T(0);
#pragma unroll
    for (int g = 0; g < 2 * R; ++g) {
      ex[g] = acc;
      acc = acc + __shfl_sync(kAll, t[g / 2], (g % 2) * 16 + 15);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) t[r] = t[r] + (half ? ex[2 * r + 1] : ex[2 * r]);
  T e[R];  // the level-1 sum of the block before each (+0.0 for block 0)
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const T up = __shfl_up_sync(kAll, t[r], 1);
    const T wrap = __shfl_sync(kAll, t[r > 0 ? r - 1 : 0], 31);
    e[r] = lane ? up : (r > 0 ? wrap : T(0));
  }
  clk.at(2);
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int q = 0; q < kBlock; ++q) v[r][q] = v[r][q] + e[r];
    write16(buf + (lane + 32 * r) * P, L - (lane + 32 * r) * kBlock, v[r]);
  }
  __syncwarp();
  stage_out(o, L, stride, vec, buf);
  clk.at(3);
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
