// rangemax: the doubling (sparse-table) range-max levels of demand rows, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/rangemax.py (_rangemax_kernel /
// rangemax_pallas).  out[r, p, i] = max(x[r, i : min(i + 2^p, L)]) for
// p < P = floor(log2 L) + 1: level p is the max of two level p-1 spans,
// max(prev[i], prev[i + 2^(p-1)]), with the -inf identity past the row end.
// The TPU kernel rolled a whole (8, L) tile through VMEM lanes
// (pltpu.roll); here one block owns one row and reads the shifted level
// from shared memory instead:
//   * shared path (L * sizeof(T) <= 48 KB): the row is loaded into shared
//     memory once and updated in place level by level.  Each level walks
//     the row in chunks of the block width in increasing order: a chunk
//     reads only its own slots and later ones (i + span > i), which earlier
//     chunks never wrote, so one barrier between the reads and the writes
//     of a chunk keeps the update race-free.  Every level is written out
//     from the same registers.
//   * global path (longer rows, e.g. float64 at L = 8192): level p reads
//     level p-1 from the output itself, one barrier between levels.
// max is exact, so the table is bit-identical to the plain version and to
// the reference's table_levels_jnp in any dtype.  Rows are the cluster's
// nodes (16 on the main path), so the launch is latency-bound; its byte
// bound is one read of x and one write of the table at 3.35 TB/s.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSharedBytes = 48 * 1024;

template <typename T>
__device__ __forceinline__ T vmax(T a, T b) {
  return a < b ? b : a;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) rangemax_shared(const T* __restrict__ x, int L, int P,
                                                            T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const T* xr = x + (size_t)blockIdx.x * L;
  T* o = out + (size_t)blockIdx.x * P * L;
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    const T v = xr[i];
    s[i] = v;
    o[i] = v;
  }
  __syncthreads();
  int span = 1;
  for (int p = 1; p < P; ++p, span <<= 1) {
    T* op = o + (size_t)p * L;
    for (int base = 0; base < L; base += blockDim.x) {  // uniform trip count
      const int i = base + threadIdx.x;
      T v = T(0);
      if (i < L) {
        v = s[i];
        if (i + span < L) v = vmax(v, s[i + span]);
      }
      __syncthreads();
      if (i < L) {
        s[i] = v;
        op[i] = v;
      }
      __syncthreads();
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) rangemax_global(const T* __restrict__ x, int L, int P, T* out) {
  const T* xr = x + (size_t)blockIdx.x * L;
  T* o = out + (size_t)blockIdx.x * P * L;
  for (int i = threadIdx.x; i < L; i += blockDim.x) o[i] = xr[i];
  __syncthreads();
  int span = 1;
  for (int p = 1; p < P; ++p, span <<= 1) {
    const T* prev = o + (size_t)(p - 1) * L;
    T* op = o + (size_t)p * L;
    for (int i = threadIdx.x; i < L; i += blockDim.x) {
      T v = prev[i];
      if (i + span < L) v = vmax(v, prev[i + span]);
      op[i] = v;
    }
    __syncthreads();  // level p is complete before level p + 1 reads it
  }
}

template <typename T>
int launch(const void* x, int rows, int L, int P, void* out, cudaStream_t stream) {
  if (rows <= 0) return (int)cudaGetLastError();
  const size_t bytes = (size_t)L * sizeof(T);
  if (bytes <= (size_t)kSharedBytes)
    rangemax_shared<T><<<rows, kThreads, bytes, stream>>>((const T*)x, L, P, (T*)out);
  else
    rangemax_global<T><<<rows, kThreads, 0, stream>>>((const T*)x, L, P, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// x (rows, L) -> out (rows, P, L), P = floor(log2 L) + 1; dtype 0 f32, 1 f64.
extern "C" int rangemax_launch(const void* x, int rows, int L, int P, int dtype, void* out, cudaStream_t stream) {
  if (L < 1 || P < 1 || (1 << (P - 1)) > L || (2 << (P - 1)) <= L) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch<float>(x, rows, L, P, out, stream);
    case 1:
      return launch<double>(x, rows, L, P, out, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
