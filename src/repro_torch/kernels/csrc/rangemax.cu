// rangemax: the cluster's fit tables -- running demand and its doubling
// range-max levels -- for sm_90a, one launch per scheduling-epoch row.
//
// Replaces the TPU kernel repro/kernels/rangemax.py (_rangemax_kernel /
// rangemax_pallas): out[r, p, i] = max(x[r, i : min(i + 2^p, L)]) for
// p < P = floor(log2 L) + 1, level p the max of two level p-1 spans,
// max(prev[i], prev[i + 2^(p-1)]), with the -inf identity past the row end.
// The TPU kernel rolled a whole (8, L) tile through VMEM lanes (pltpu.roll);
// here one block owns one row and reads the shifted level from shared
// memory.  Two entry points share the table levels (build_levels):
//   * rangemax_launch(x): rows given (the TPU kernel's function);
//   * fit_tables_launch(t, d, base0): what the epoch program needs before
//     every row (repro/sim/device_timeline.py:_fit_tables) -- the running
//     sum of the event deltas d in the order of XLA's CPU cumsum, plus the
//     node's base demand, -inf off the tie-group-final events (t[i] !=
//     t[i + 1], isfinite(t[L - 1]) for the last), then the table.  On the
//     card that chain was ~46 small launches before the table's one.
//
// The running sum reproduces scan.cumsum(d, 16) bit for bit, since
// placements are held bit-identical to the reference's; its device code
// (xla_scan.cuh) is shared with the sweep's fold in compaction.cu.
//
// Shared path: the row stays in shared memory from the sum through every
// level (the 48 KB cap lifted to the card's opt-in limit, 227 KB on H100:
// fit tables up to ~13,500 float64 slots); levels ping-pong between two
// buffers with one barrier per level and are written out with 16-byte
// stores where the row allows.  Longer rows take the global path: level p
// reads level p-1 from the output itself, and the sum uses the output's
// upper levels as scratch before they are built.  max is exact, so the
// table is bit-identical to the plain version in any dtype.  Rows are the
// cluster's nodes (16 on the main path), so a launch is latency-bound; its
// byte bound is one read of the inputs and one write of the table at
// 3.35 TB/s.

#include <cuda_runtime.h>
#include <cstdint>

#include "xla_scan.cuh"

namespace {

using xla_scan::allow_shared;
using xla_scan::masked_demand;
using xla_scan::optin_limit;
using xla_scan::padded;
using xla_scan::running_sum;
using xla_scan::scan_shape;
using xla_scan::ScanShape;

constexpr int kThreads = 512;

// One 16-byte store of W = 16 / sizeof(T) slots.
__device__ __forceinline__ void store16(float* p, const float* o) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void store16(double* p, const double* o) {
  *reinterpret_cast<double2*>(p) = make_double2(o[0], o[1]);
}

template <typename T>
__device__ __forceinline__ T vmax(T a, T b) {
  return a < b ? b : a;
}

// Write one level's slots [v * W, v * W + W) held in o to out and, unless
// null, to the shared buffer dst.  vec: 16-byte stores (L % W == 0 and out
// 16-byte aligned).
template <typename T>
__device__ __forceinline__ void put(T* out, T* dst, int i0, const T* o, int W, int L, bool vec) {
  if (vec) {
    store16(out + i0, o);
    if (dst)
      for (int e = 0; e < W; ++e) dst[i0 + e] = o[e];
  } else {
    for (int e = 0; e < W && i0 + e < L; ++e) {
      out[i0 + e] = o[e];
      if (dst) dst[i0 + e] = o[e];
    }
  }
}

// Levels 1..P-1 from level 0.  Shared path (a, b shared buffers of L
// slots, level 0 in a): level p reads one buffer and writes the other and
// out's row p.  Global path (a == nullptr): level p reads out's row p - 1.
// One barrier per level.
template <typename T>
__device__ void build_levels(T* a, T* b, T* out, int L, int P, bool vec) {
  constexpr int W = 16 / sizeof(T);
  const int nv = (L + W - 1) / W;
  int span = 1;
  for (int p = 1; p < P; ++p, span <<= 1) {
    T* op = out + (size_t)p * L;
    const T* src = a ? a : out + (size_t)(p - 1) * L;
    for (int v = threadIdx.x; v < nv; v += blockDim.x) {
      T o[W];
#pragma unroll
      for (int e = 0; e < W; ++e) {
        const int i = v * W + e;
        o[e] = T(0);
        if (i < L) o[e] = i + span < L ? vmax(src[i], src[i + span]) : src[i];
      }
      put(op, a ? b : nullptr, v * W, o, W, L, vec);
    }
    __syncthreads();
    if (a) {
      T* tmp = a;
      a = b;
      b = tmp;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) rangemax_kernel(const T* __restrict__ x, int L, int P, T* out, bool shared,
                                                            bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int W = 16 / sizeof(T);
  T* a = shared ? reinterpret_cast<T*>(smem_raw) : nullptr;
  const T* xr = x + (size_t)blockIdx.x * L;
  T* o = out + (size_t)blockIdx.x * P * L;
  for (int v = threadIdx.x; v * W < L; v += blockDim.x) {
    T buf[W];
    for (int e = 0; e < W; ++e) buf[e] = v * W + e < L ? xr[v * W + e] : T(0);
    put(o, a, v * W, buf, W, L, vec);
  }
  __syncthreads();
  build_levels(a, a ? a + L : nullptr, o, L, P, vec);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) fit_tables_kernel(const T* __restrict__ t, const T* __restrict__ d,
                                                              const T* __restrict__ base0, int L, int P, T* out,
                                                              bool shared, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int W = 16 / sizeof(T);
  const ScanShape sh = scan_shape(L);
  const T* tr = t + (size_t)blockIdx.x * L;
  const T* dr = d + (size_t)blockIdx.x * L;
  T* o = out + (size_t)blockIdx.x * P * L;
  T *a, *scan, *tot;
  if (shared) {  // a (L) | scan, later level buffer b (padded(L) + 1) | totals
    a = reinterpret_cast<T*>(smem_raw);
    scan = a + L;
    tot = scan + padded(L) + 1;
  } else {  // scratch in the output's rows 1-2 (scan) and 3 (totals), built after
    a = nullptr;
    scan = o + L;
    tot = o + (size_t)3 * L;
  }
  running_sum(dr, L, scan, tot, sh);
  const T base = base0[blockIdx.x];
  const bool deep = sh.depth > 1;
  const T* tot1 = tot + sh.off[1];
  for (int v = threadIdx.x; v * W < L; v += blockDim.x) {
    T buf[W];
    for (int e = 0; e < W; ++e) {
      const int i = v * W + e;
      buf[e] = i < L ? masked_demand(i, L, scan, tot1, deep, tr, base) : T(0);
    }
    put(o, a, v * W, buf, W, L, vec);
  }
  __syncthreads();
  build_levels(a, scan, o, L, P, vec);
}

template <typename T>
bool vec_ok(const void* out, int L) {
  return reinterpret_cast<uintptr_t>(out) % 16 == 0 && (size_t)L * sizeof(T) % 16 == 0;
}

template <typename T>
int launch_rangemax(const void* x, int rows, int L, int P, void* out, cudaStream_t stream) {
  static bool lifted = false;
  if (rows <= 0) return (int)cudaGetLastError();
  const size_t bytes = 2 * (size_t)L * sizeof(T);
  const bool shared = bytes <= (size_t)optin_limit();
  if (shared && bytes > 48 * 1024)
    if (int err = allow_shared(rangemax_kernel<T>, lifted)) return err;
  rangemax_kernel<T><<<rows, kThreads, shared ? bytes : 0, stream>>>((const T*)x, L, P, (T*)out, shared,
                                                                      vec_ok<T>(out, L));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fit_tables(const void* t, const void* d, const void* base0, int rows, int L, int P, void* out,
                      cudaStream_t stream) {
  static bool lifted = false;
  if (rows <= 0) return (int)cudaGetLastError();
  const ScanShape sh = scan_shape(L);
  if (xla_scan::too_long(L)) return (int)cudaErrorInvalidValue;  // past 16^8 slots
  const size_t bytes = ((size_t)L + padded(L) + 1 + sh.slots) * sizeof(T);
  const bool shared = bytes <= (size_t)optin_limit();
  // the global path's scratch: padded(L) + 1 slots over rows 1-2, the totals in row 3
  if (!shared && (P < 4 || sh.slots > L)) return (int)cudaErrorInvalidValue;
  if (shared && bytes > 48 * 1024)
    if (int err = allow_shared(fit_tables_kernel<T>, lifted)) return err;
  fit_tables_kernel<T><<<rows, kThreads, shared ? bytes : 0, stream>>>(
      (const T*)t, (const T*)d, (const T*)base0, L, P, (T*)out, shared, vec_ok<T>(out, L));
  return (int)cudaGetLastError();
}

bool levels_ok(int L, int P) { return L >= 1 && P >= 1 && (1 << (P - 1)) <= L && (2 << (P - 1)) > L; }

}  // namespace

// x (rows, L) -> out (rows, P, L), P = floor(log2 L) + 1; dtype 0 f32, 1 f64.
extern "C" int rangemax_launch(const void* x, int rows, int L, int P, int dtype, void* out, cudaStream_t stream) {
  if (!levels_ok(L, P)) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch_rangemax<float>(x, rows, L, P, out, stream);
    case 1:
      return launch_rangemax<double>(x, rows, L, P, out, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// t, d (rows, L) sorted event times and deltas, base0 (rows,) -> out (rows,
// P, L): row 0 the masked running demand, rows 1.. its range-max levels.
extern "C" int fit_tables_launch(const void* t, const void* d, const void* base0, int rows, int L, int P, int dtype,
                                 void* out, cudaStream_t stream) {
  if (!levels_ok(L, P)) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch_fit_tables<float>(t, d, base0, rows, L, P, out, stream);
    case 1:
      return launch_fit_tables<double>(t, d, base0, rows, L, P, out, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
