// compaction: stable front-compaction of carried (time, delta) event rows, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/compaction.py (_compact_kernel /
// compact_pallas).  Given a keep mask, the kept entries of each row move to
// the front in their order, and the tail becomes (+inf, 0).  The TPU kernel
// phrased the scatter as a gather: a triangular loop of one-hot
// (rank == destination) reductions over 128-lane tiles, because its vector
// unit cannot scatter.  This card can, so one block owns one row and walks
// it in chunks of the block width:
//   * each warp ranks its kept entries with __ballot_sync / __popc;
//   * the warp totals go to shared memory and every thread sums those of
//     the warps before its own (a scan of 8 values), plus the kept count of
//     the chunks before;
//   * each kept entry is written straight to its rank.
// Then the tail [kept, L) is filled.  No atomics and no arithmetic on a
// moved value: a pure permutation, bit-identical to the plain version and
// to the reference's compact_events_jnp in any dtype.  Bound: memory, the
// row's times, deltas and mask read once and both outputs written once.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads) compact_kernel(const T* __restrict__ t, const T* __restrict__ d,
                                                           const unsigned char* __restrict__ keep, int L,
                                                           T* __restrict__ t_out, T* __restrict__ d_out) {
  __shared__ int warp_total[kWarps];
  const size_t off = (size_t)blockIdx.x * L;
  const T* tr = t + off;
  const T* dr = d + off;
  const unsigned char* kr = keep + off;
  T* to = t_out + off;
  T* dout = d_out + off;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int base = 0;  // kept entries in earlier chunks (uniform across the block)
  for (int c = 0; c < L; c += kThreads) {
    const int i = c + threadIdx.x;
    const bool k = i < L && kr[i] != 0;
    const unsigned m = __ballot_sync(0xffffffffu, k);
    if (lane == 0) warp_total[warp] = __popc(m);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int n = warp_total[w];
      before += w < warp ? n : 0;
      total += n;
    }
    if (k) {
      const int dst = base + before + __popc(m & ((1u << lane) - 1u));
      to[dst] = tr[i];
      dout[dst] = dr[i];
    }
    base += total;
    __syncthreads();  // warp_total is rewritten by the next chunk
  }
  const T inf = (T)__longlong_as_double(0x7ff0000000000000LL);
  for (int i = base + threadIdx.x; i < L; i += kThreads) {
    to[i] = inf;
    dout[i] = T(0);
  }
}

template <typename T>
int launch(const void* t, const void* d, const unsigned char* keep, int rows, int L, void* t_out, void* d_out,
           cudaStream_t stream) {
  if (rows > 0 && L > 0)
    compact_kernel<T><<<rows, kThreads, 0, stream>>>((const T*)t, (const T*)d, keep, L, (T*)t_out, (T*)d_out);
  return (int)cudaGetLastError();
}

}  // namespace

// t, d (rows, L) and keep (rows, L) bytes (a torch.bool tensor) -> t_out,
// d_out (rows, L); dtype 0 f32, 1 f64.
extern "C" int compaction_launch(const void* t, const void* d, const unsigned char* keep, int rows, int L, int dtype,
                                 void* t_out, void* d_out, cudaStream_t stream) {
  switch (dtype) {
    case 0:
      return launch<float>(t, d, keep, rows, L, t_out, d_out, stream);
    case 1:
      return launch<double>(t, d, keep, rows, L, t_out, d_out, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
