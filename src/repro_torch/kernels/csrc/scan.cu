// scan: inclusive running sums in a fixed order of additions, for sm_90a.
//
// No TPU kernel corresponds to it.  It replaces the running sums of the
// reference engine's predict phase: the lax.scan carry of the regression
// banks (repro/sim/jax_sim.py:621, regression.update_stats at each step)
// and the jnp.cumsum of its prefix programs (jax_sim.py:241, 277, 278, 295,
// 319, 347), which XLA's CPU backend adds in blocks of 16.  The port's plain
// version is kernels/scan.py:cumsum; this kernel gives its bits in both of
// its orders, float32 and float64.  The array is viewed as (outer, n, inner)
// and summed along n, so a scan along any axis of a contiguous tensor needs
// no copy before it.
//
//   * seq_kernel (block >= n, the scan's order): one thread per column
//     (o, c) walks its n elements in order from +0.0 (so a leading -0.0
//     becomes +0.0, as the plain fold's first add does).  Neighbouring
//     threads hold neighbouring columns, so each step's loads and stores
//     are coalesced across the inner axis: the predict phase's fold is
//     (lanes, executions, 5 (1 + k)) with the scan along the executions.
//     Bound: latency, n dependent adds per column; bytes are a read and a
//     write of the array.
//
//   * xla_kernel (block = 16, XLA's CPU order): one block per line (o, c)
//     loads the line into a scan buffer and folds it with xla_scan.cuh, the
//     card's one copy of that order (shared with rangemax.cu and
//     compaction.cu): each thread folds one block of 16 from +0.0, the block
//     totals the same way, level by level, then each block adds its
//     exclusive prefix, top down.  The buffer is dynamic shared memory up
//     to the card's opt-in limit and, for longer lines, the line's slice of
//     a global scratch the wrapper allocates (scan_scratch says how much).
//     A line along a middle axis (inner > 1) is read and written with the
//     inner stride.  Bound: latency of the levels behind barriers at the
//     predict phase's lengths (<= 1,536); bytes are a read and a write.
//
// Only additions: built with -fmad=false, like every includer of
// xla_scan.cuh.

#include <cuda_runtime.h>

#include <algorithm>

#include "xla_scan.cuh"

namespace {

using xla_scan::padded;
using xla_scan::prefix;
using xla_scan::scan_shape;
using xla_scan::ScanShape;

constexpr int kSeqThreads = 128;
constexpr int kMaxLineThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kSeqThreads) seq_kernel(const T* __restrict__ a, long long cols, int n, int inner,
                                                          T* __restrict__ out) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  const size_t base = (size_t)(col / inner) * n * inner + (size_t)(col % inner);
  const T* src = a + base;
  T* dst = out + base;
  T acc = T(0);
#pragma unroll 8
  for (int i = 0; i < n; ++i) {
    acc = acc + src[(size_t)i * inner];
    dst[(size_t)i * inner] = acc;
  }
}

// Bytes of a line's scan buffer and level totals.
template <typename T>
size_t line_bytes(int n) {
  return ((size_t)padded(n) + 1 + (size_t)scan_shape(n).slots) * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(kMaxLineThreads) xla_kernel(const T* __restrict__ a, int n, int inner,
                                                              T* __restrict__ out, unsigned char* scratch,
                                                              size_t scratch_row) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t line = blockIdx.x;
  const size_t base = line / inner * n * inner + line % inner;
  T* scan = reinterpret_cast<T*>(scratch ? scratch + line * scratch_row : smem_raw);
  T* tot = scan + padded(n) + 1;
  const ScanShape sh = scan_shape(n);
  for (int i = threadIdx.x; i < n; i += blockDim.x) scan[padded(i)] = a[base + (size_t)i * inner];
  __syncthreads();
  xla_scan::fold_levels(scan, tot, sh);
  const T* tot1 = tot + sh.off[1];
  const bool deep = sh.depth > 1;
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[base + (size_t)i * inner] = prefix(i, scan, tot1, deep);
}

// Bytes of global scratch a line of the XLA-order scan needs: 0 when its
// buffers fit in shared memory.
template <typename T>
long long scratch_bytes(int n) {
  const size_t bytes = line_bytes<T>(n);
  return bytes <= (size_t)xla_scan::optin_limit() ? 0 : (long long)((bytes + 15) / 16 * 16);
}

template <typename T>
int launch(const void* a, int outer, int n, int inner, bool sequential, void* out, unsigned char* scratch,
           cudaStream_t stream) {
  static bool lifted = false;
  const long long lines = (long long)outer * inner;
  if (lines <= 0 || n <= 0) return (int)cudaGetLastError();
  if (sequential) {
    const unsigned blocks = (unsigned)((lines + kSeqThreads - 1) / kSeqThreads);
    seq_kernel<T><<<blocks, kSeqThreads, 0, stream>>>((const T*)a, lines, n, inner, (T*)out);
    return (int)cudaGetLastError();
  }
  if (xla_scan::too_long(n) || lines > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t row = (size_t)scratch_bytes<T>(n);
  if (row && !scratch) return (int)cudaErrorInvalidValue;
  const size_t bytes = row ? 0 : line_bytes<T>(n);
  if (bytes > 48 * 1024)
    if (int err = xla_scan::allow_shared(xla_kernel<T>, lifted)) return err;
  // one thread per block of 16 at the lowest level, in whole warps
  const int threads = std::min(kMaxLineThreads, std::max(32, ((n + 15) / 16 + 31) / 32 * 32));
  xla_kernel<T><<<(unsigned)lines, threads, bytes, stream>>>((const T*)a, n, inner, (T*)out,
                                                              row ? scratch : nullptr, row);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of global scratch per line that scan_launch needs in XLA's order at
// length n (0: none), or -1 for an unknown dtype.
extern "C" long long scan_scratch(int n, int dtype) {
  switch (dtype) {
    case 0:
      return scratch_bytes<float>(n);
    case 1:
      return scratch_bytes<double>(n);
    default:
      return -1;
  }
}

// a (outer, n, inner) contiguous -> out, its inclusive running sums along n:
// sequential != 0 in order from +0.0, else in XLA's CPU order; scratch:
// outer x inner x scan_scratch(n) bytes, or null when that is 0 or the sum
// is sequential.  dtype 0 f32, 1 f64.
extern "C" int scan_launch(const void* a, int outer, int n, int inner, int sequential, int dtype, void* out,
                           unsigned char* scratch, cudaStream_t stream) {
  switch (dtype) {
    case 0:
      return launch<float>(a, outer, n, inner, sequential != 0, out, scratch, stream);
    case 1:
      return launch<double>(a, outer, n, inner, sequential != 0, out, scratch, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
