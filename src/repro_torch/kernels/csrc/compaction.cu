// compaction: stable front-compaction of carried (time, delta) event rows,
// and the sweep's whole chunk-boundary fold around it, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/compaction.py (_compact_kernel /
// compact_pallas).  Given a keep mask, the kept entries of each row move to
// the front in their order, and the tail becomes (+inf, 0).  The TPU kernel
// phrased the scatter as a gather: a triangular loop of one-hot
// (rank == destination) reductions over 128-lane tiles, because its vector
// unit cannot scatter.  This card can.  Two entry points:
//
//   * compaction_launch(t, d, keep): the TPU kernel's function.  One
//     256-thread block owns one row; each of its 8 warps owns one span of
//     whole 128-entry steps.  Pass 1: each warp counts its span's kept
//     entries from 32-bit words of the mask (4 bytes a lane), then one
//     barrier gives every warp its span's rank base.  Pass 2: each warp
//     walks its span a step at a time, entry 32 e + lane for e < 4, so that
//     every load and store of a time or delta is coalesced; four
//     __ballot_sync of the step's mask words (one per byte) give each
//     entry's keep bit and, by __popc, its rank.  One barrier a row, where
//     the block per row it replaces paid two per 256 entries.  A warp per
//     row was tried and was slower than that block per row at every length
//     tried on an H100 (64 rows, L = 77 to 8,192): a warp walking a
//     1,024-entry row alone is bound by its own instruction latency, and 64
//     rows fill 64 warps.  A pure permutation, with no arithmetic on a
//     moved value: bit-identical to the plain version and to the
//     reference's compact_events_jnp in any dtype.  Bound: memory, the
//     row's times, deltas and mask read once and both outputs written once.
//
//   * fold_compact_launch(t, d, base, now, n_nodes): the sweep program's
//     chunk-boundary step (repro/sim/device_timeline.py, chunk_step), where
//     the compaction was one launch inside a chain of ~280 small ones.  One
//     block owns one row, node n of lane s = row / n_nodes at clock now[s]:
//       1. cnt, the length of the row's prefix with t <= now (what the
//          reference's binary lifting _count_sorted gives on a sorted,
//          +inf-padded row, ties at now included), by a shared atomicMin;
//       2. base' = base + (cnt > 0 ? sum(d)[cnt - 1] : +0.0), always added
//          (a -0.0 base with cnt 0 comes out +0.0, as in the plain version);
//       3. the row shifted left by cnt, (+inf, +0.0) behind;
//       4. cs = base' + sum(shifted d);
//       5. keep = isfinite(t) & (cs != [base', cs[:-1]]): an event is kept
//          when its delta changes the running sum's bits;
//       6. the shifted row compacted by keep (ranks from ballot words and
//          one warp's prefix over them);
//       7. csm, base' + the compacted row's running sum, -inf off
//          tie-group-final events (rangemax's masked demand);
//       8. the row's kept count.
//     Every sum above is XLA's CPU cumsum order (xla_scan.cuh), the bits the
//     reference's placements depend on.  The scans and the compacted times
//     stay in shared memory up to the card's opt-in limit (~13,000 float64
//     slots, past the sweep's axis cap of 8,192); longer rows keep them in a
//     global scratch the wrapper allocates.  The fold is latency-bound (64
//     rows on the main path, three scans behind barriers); its byte bound
//     is one read of the inputs and one write of the outputs at 3.35 TB/s.

#include <cuda_runtime.h>
#include <cstdint>

#include "xla_scan.cuh"

namespace {

using xla_scan::padded;
using xla_scan::prefix;
using xla_scan::scan_shape;
using xla_scan::ScanShape;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStep = 128;  // entries a warp takes per step: 4 a lane
constexpr int kFoldThreads = 512;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T pos_inf() {
  return (T)__longlong_as_double(0x7ff0000000000000LL);
}

// Kept entries among the 4 mask bytes of w.
__device__ __forceinline__ int kept4(unsigned w) {
  return ((w & 0xffu) != 0) + ((w & 0xff00u) != 0) + ((w & 0xff0000u) != 0) + ((w & 0xff000000u) != 0);
}

// The lane's 4 mask bytes at i4 .. i4 + 3 of the row (0 past L) as a word.
__device__ __forceinline__ unsigned mask_word(const unsigned char* __restrict__ kr, int i4, int L, bool words) {
  if (words && i4 + 3 < L) return __ldg(reinterpret_cast<const unsigned*>(kr + i4));
  unsigned w = 0;
  for (int k = 0; k < 4; ++k) w |= (i4 + k < L ? (unsigned)kr[i4 + k] : 0u) << (8 * k);
  return w;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) compact_kernel(const T* __restrict__ t, const T* __restrict__ d,
                                                           const unsigned char* __restrict__ keep, int L,
                                                           T* __restrict__ t_out, T* __restrict__ d_out) {
  __shared__ int span_kept[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t off = (size_t)blockIdx.x * L;
  const T* tr = t + off;
  const T* dr = d + off;
  const unsigned char* kr = keep + off;
  T* to = t_out + off;
  T* dout = d_out + off;
  const bool words = reinterpret_cast<uintptr_t>(kr) % 4 == 0;
  const int span = (L + kWarps * kStep - 1) / (kWarps * kStep) * kStep;  // whole steps a warp
  const int s0 = min(warp * span, L), s1 = min(s0 + span, L);
  // pass 1: the span's kept count, from its mask words
  int n = 0;
  for (int i4 = s0 + 4 * lane; i4 < s1; i4 += kStep) n += kept4(mask_word(kr, i4, s1, words));
  for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(kFull, n, o);
  if (lane == 0) span_kept[warp] = n;
  __syncthreads();
  int base = 0, total = 0;  // kept entries before the span, and in the row
  for (int w = 0; w < kWarps; ++w) {
    base += w < warp ? span_kept[w] : 0;
    total += span_kept[w];
  }
  // pass 2: each step of the span, entry c + 32 e + lane for e < 4; the
  // four ballots of the step's mask bytes give each entry's rank
  const int kb = lane & 3;  // the byte of the word that holds entry 32 e + lane
  int below[4];             // mask words' lanes l with 4 l + k < lane, per byte k (+ 8 e)
  for (int k = 0; k < 4; ++k) below[k] = (lane - k + 3) >> 2;
  for (int c = s0; c < s1; c += kStep) {
    T tv[4], dv[4];
    for (int e = 0; e < 4; ++e) {
      const int i = c + 32 * e + lane;
      if (i < s1) tv[e] = __ldg(tr + i), dv[e] = __ldg(dr + i);
    }
    const unsigned w = mask_word(kr, c + 4 * lane, s1, words);
    unsigned b[4];  // bit l: entry c + 4 l + k is kept
    for (int k = 0; k < 4; ++k) b[k] = __ballot_sync(kFull, (w >> (8 * k)) & 0xffu);
    const unsigned mine = kb == 0 ? b[0] : kb == 1 ? b[1] : kb == 2 ? b[2] : b[3];
    for (int e = 0; e < 4; ++e) {
      if ((mine >> (8 * e + (lane >> 2))) & 1u) {
        int dst = base;
        for (int k = 0; k < 4; ++k) dst += __popc(b[k] & (unsigned)((1ull << (8 * e + below[k])) - 1ull));
        to[dst] = tv[e];
        dout[dst] = dv[e];
      }
    }
    base += __popc(b[0]) + __popc(b[1]) + __popc(b[2]) + __popc(b[3]);
  }
  for (int i = total + threadIdx.x; i < L; i += blockDim.x) {
    to[i] = pos_inf<T>();
    dout[i] = T(0);
  }
}

// Byte offsets of the fold's buffers in one region: dynamic shared memory
// on the shared path, the row's slice of the scratch on the global path,
// where t_out holds the compacted times (no tc).  The region's first 16
// bytes hold cnt and the kept count.
template <typename T>
struct FoldLayout {
  size_t tc, scan, tot, words, wpre, bytes;
  __host__ __device__ FoldLayout(int L, bool with_tc) {
    const size_t W = (L + 31) / 32;
    tc = 16;
    scan = tc + (with_tc ? (size_t)L * sizeof(T) : 0);
    tot = scan + ((size_t)padded(L) + 1) * sizeof(T);
    words = tot + (size_t)scan_shape(L).slots * sizeof(T);
    wpre = words + W * 4;
    bytes = (wpre + W * 4 + 15) / 16 * 16;
  }
};

template <typename T>
__global__ void __launch_bounds__(kFoldThreads) fold_kernel(const T* __restrict__ t, const T* __restrict__ d,
                                                            const T* __restrict__ base, const T* __restrict__ now,
                                                            int n_nodes, int L, T* __restrict__ base_out, T* t_out,
                                                            T* __restrict__ d_out, T* __restrict__ csm,
                                                            long long* __restrict__ kept_out, unsigned char* scratch,
                                                            size_t scratch_row) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const bool shared = scratch == nullptr;
  const int r = blockIdx.x;
  const size_t off = (size_t)r * L;
  const T* tr = t + off;
  const T* dr = d + off;
  T* to = t_out + off;
  T* dout = d_out + off;
  T* co = csm + off;
  unsigned char* region = shared ? smem_raw : scratch + (size_t)r * scratch_row;
  const FoldLayout<T> lay(L, shared);
  int* counts = reinterpret_cast<int*>(smem_raw);  // cnt, kept
  T* tc = shared ? reinterpret_cast<T*>(region + lay.tc) : to;
  T* scan = reinterpret_cast<T*>(region + lay.scan);
  T* tot = reinterpret_cast<T*>(region + lay.tot);
  unsigned* words = reinterpret_cast<unsigned*>(region + lay.words);
  int* wpre = reinterpret_cast<int*>(region + lay.wpre);
  const T clock = now[r / n_nodes];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 1. cnt: the first index whose time is not at or before the clock
  if (tid == 0) counts[0] = L;
  __syncthreads();
  for (int i = tid; i < L; i += blockDim.x)
    if (!(tr[i] <= clock)) {
      atomicMin(counts, i);
      break;
    }
  __syncthreads();
  const int cnt = counts[0];

  // 2. fold the prefix into the base
  const ScanShape sh1 = scan_shape(cnt);
  xla_scan::running_sum(dr, cnt, scan, tot, sh1);
  const T b = base[r] + (cnt > 0 ? prefix(cnt - 1, scan, tot + sh1.off[1], sh1.depth > 1) : T(0));
  __syncthreads();  // the scan buffer is reused

  // 3-5. the shifted row's running demand, and its keep mask as a word of
  // ballot bits per 32 entries
  const int n = L - cnt;
  const ScanShape sh2 = scan_shape(n);
  xla_scan::running_sum(dr + cnt, n, scan, tot, sh2);
  const T* tot2 = tot + sh2.off[1];
  const bool deep2 = sh2.depth > 1;
  const int W = (n + 31) / 32;
  for (int c = 0; c < n; c += blockDim.x) {
    const int i = c + tid;
    bool k = false;
    if (i < n) {
      const T cs = b + prefix(i, scan, tot2, deep2);
      const T prev = i ? b + prefix(i - 1, scan, tot2, deep2) : b;
      k = isfinite(tr[cnt + i]) && cs != prev;
    }
    const unsigned m = __ballot_sync(kFull, k);
    if (lane == 0 && i / 32 < W) words[i / 32] = m;
  }
  __syncthreads();

  // 6. each word's rank base (one warp), then the kept entries to their
  // ranks: times to tc, deltas to d_out and to the scan buffer
  if (warp == 0) {
    const int per = (W + 31) / 32;
    const int w0 = min(lane * per, W), w1 = min(w0 + per, W);
    int own = 0;
    for (int w = w0; w < w1; ++w) own += __popc(words[w]);
    int incl = own;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    int acc = incl - own;
    for (int w = w0; w < w1; ++w) {
      wpre[w] = acc;
      acc += __popc(words[w]);
    }
    if (lane == 31) counts[1] = incl;
  }
  __syncthreads();
  const int kept = counts[1];
  for (int i = tid; i < n; i += blockDim.x) {
    const unsigned m = words[i / 32];
    if ((m >> (i % 32)) & 1u) {
      const int dst = wpre[i / 32] + __popc(m & ((1u << (i % 32)) - 1u));
      const T dv = dr[cnt + i];
      tc[dst] = tr[cnt + i];
      scan[padded(dst)] = dv;
      dout[dst] = dv;
    }
  }
  __syncthreads();

  // 7. the compacted row's running demand, -inf off tie-group-final events
  const ScanShape sh3 = scan_shape(kept);
  xla_scan::fold_levels(scan, tot, sh3);
  const T* tot3 = tot + sh3.off[1];
  const bool deep3 = sh3.depth > 1;
  for (int i = tid; i < L; i += blockDim.x) {
    if (i < kept) {  // kept times are finite
      const T ti = tc[i];
      const bool last = i + 1 == kept || ti != tc[i + 1];
      co[i] = last ? b + prefix(i, scan, tot3, deep3) : xla_scan::neg_inf<T>();
      if (shared) to[i] = ti;
    } else {
      to[i] = pos_inf<T>();
      dout[i] = T(0);
      co[i] = xla_scan::neg_inf<T>();
    }
  }
  if (tid == 0) {
    base_out[r] = b;
    kept_out[r] = kept;
  }
}

template <typename T>
int launch(const void* t, const void* d, const unsigned char* keep, int rows, int L, void* t_out, void* d_out,
           cudaStream_t stream) {
  if (rows > 0 && L > 0)
    compact_kernel<T><<<rows, kThreads, 0, stream>>>((const T*)t, (const T*)d, keep, L, (T*)t_out, (T*)d_out);
  return (int)cudaGetLastError();
}

// Bytes of global scratch a row of the fold needs: 0 when its buffers fit
// in shared memory.
template <typename T>
long long fold_scratch(int L) {
  return FoldLayout<T>(L, true).bytes <= (size_t)xla_scan::optin_limit() ? 0 : (long long)FoldLayout<T>(L, false).bytes;
}

template <typename T>
int launch_fold(const void* t, const void* d, const void* base, const void* now, int rows, int n_nodes, int L,
                void* base_out, void* t_out, void* d_out, void* csm, long long* kept, unsigned char* scratch,
                cudaStream_t stream) {
  static bool lifted = false;
  if (rows <= 0 || L <= 0) return (int)cudaGetLastError();
  if (n_nodes <= 0 || xla_scan::too_long(L)) return (int)cudaErrorInvalidValue;
  const size_t row = (size_t)fold_scratch<T>(L);
  if (row && !scratch) return (int)cudaErrorInvalidValue;
  const size_t bytes = row ? 16 : FoldLayout<T>(L, true).bytes;
  if (bytes > 48 * 1024)
    if (int err = xla_scan::allow_shared(fold_kernel<T>, lifted)) return err;
  // 256 threads were faster on an H100 up to L = 1,024 (the sweep's
  // common axes), 512 from 2,048 on (64 rows, f64)
  const int threads = L <= 1024 ? kFoldThreads / 2 : kFoldThreads;
  fold_kernel<T><<<rows, threads, bytes, stream>>>((const T*)t, (const T*)d, (const T*)base, (const T*)now,
                                                        n_nodes, L, (T*)base_out, (T*)t_out, (T*)d_out, (T*)csm,
                                                        kept, row ? scratch : nullptr, row);
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

// Bytes of global scratch per row that fold_compact_launch needs at L (0:
// none), or -1 for an unknown dtype.
extern "C" long long fold_compact_scratch(int L, int dtype) {
  switch (dtype) {
    case 0:
      return fold_scratch<float>(L);
    case 1:
      return fold_scratch<double>(L);
    default:
      return -1;
  }
}

// t, d (rows, L) sorted event times (+inf padded) and deltas, base (rows,),
// now (rows / n_nodes,) -> base_out (rows,), t_out, d_out, csm (rows, L),
// kept (rows,) int64; scratch: rows x fold_compact_scratch(L) bytes, or null
// when that is 0.  dtype 0 f32, 1 f64.
extern "C" int fold_compact_launch(const void* t, const void* d, const void* base, const void* now, int rows,
                                   int n_nodes, int L, int dtype, void* base_out, void* t_out, void* d_out, void* csm,
                                   long long* kept, unsigned char* scratch, cudaStream_t stream) {
  switch (dtype) {
    case 0:
      return launch_fold<float>(t, d, base, now, rows, n_nodes, L, base_out, t_out, d_out, csm, kept, scratch,
                                stream);
    case 1:
      return launch_fold<double>(t, d, base, now, rows, n_nodes, L, base_out, t_out, d_out, csm, kept, scratch,
                                 stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
