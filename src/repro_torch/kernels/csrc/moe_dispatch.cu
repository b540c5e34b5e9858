// moe_dispatch: the sort-based dispatch of a routed MoE layer, for sm_90a.
//
// No TPU kernel: it replaces the dispatch that the reference leaves to XLA
// in repro/models/layers.py (_moe_dispatch_compute and moe): argsort over
// the flat expert ids, bincount, cumsum, and the scatter of each kept
// token's row into the expert buffer.
//
// Semantics (repro_torch.kernels.moe_dispatch.moe_dispatch_plain): the
// N * k assignments, flat index f = n * k + j of ids (N, k), take their
// position in their expert in the order of f (a stable sort by expert, as
// jnp.argsort is).  pos[f] is that position, or -1 where the id lies
// outside [0, E) (an assignment of another expert slice).  An assignment is
// kept when 0 <= pos < C; a kept one copies row x[n] to buf[e, pos], and
// every other slot of buf (E, C, D) is zero.  Which assignments the
// capacity drops is decided by that order alone.
//
// Two launches:
//   rank_kernel   a block per expert walks the ids in order, chunk by
//                 chunk (8 consecutive ids a thread), and ranks its own
//                 with a block-wide exclusive scan of the per-thread counts;
//                 it writes pos and the slot table (slot -> token, -1 for
//                 an empty slot).  Each block reads all N * k ids, from L2
//                 after the first.
//   gather_kernel a warp per slot row copies the token's row (the bytes as
//                 they are, 16 at a time where the rows allow it) or writes
//                 zeros.  The copy is of bits, so buf equals the plain
//                 version's in any dtype.
//
// Bound: bytes.  buf is written once (E * C * D elements, 672 MB at
// qwen3-moe's prefill shape N 8,192, E 128, C 641, D 4,096 bf16) and the
// rows of x read once; the ids and pos are small beside them.  The gather
// is the byte-bound part; the rank pass is a latency of a few scans.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRankThreads = 1024;
constexpr int kRankWarps = kRankThreads / 32;
constexpr int kItems = 8;  // consecutive ids a thread, a chunk of 8,192 ids a block
constexpr int kGatherThreads = 256;
constexpr int kRowsPerBlock = kGatherThreads / 32;

// Exclusive prefix of v over the block, in thread order; *total is the
// block's sum.  Ends with a barrier, so warp_sums may be reused at once.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kRankWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kRankWarps) warp_sums[lane] = w;  // inclusive
  }
  __syncthreads();
  const int before = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[kRankWarps - 1];
  __syncthreads();
  return before + x - v;
}

__global__ void __launch_bounds__(kRankThreads) rank_kernel(const int* __restrict__ ids, int n_assign, int k, int E,
                                                            int C, int* __restrict__ pos, int* __restrict__ slot) {
  __shared__ int warp_sums[kRankWarps];
  const int e = blockIdx.x;
  int* my_slots = slot + (size_t)e * C;
  int running = 0;  // assignments of expert e before this chunk
  for (int base = 0; base < n_assign; base += kRankThreads * kItems) {
    const int start = base + threadIdx.x * kItems;
    int id[kItems];
    int mine = 0;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      id[i] = start + i < n_assign ? __ldg(ids + start + i) : -1;
      mine += id[i] == e;
    }
    int total;
    int p = running + block_exclusive_scan(mine, warp_sums, &total);
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int f = start + i;
      if (f >= n_assign) break;
      if (id[i] == e) {
        pos[f] = p;
        if (p < C) my_slots[p] = f / k;
        ++p;
      } else if (e == 0 && (id[i] < 0 || id[i] >= E)) {
        pos[f] = -1;  // another slice's assignment: written once, by block 0
      }
    }
    running += total;
  }
  for (int p = min(running, C) + threadIdx.x; p < C; p += kRankThreads) my_slots[p] = -1;
}

// buf row r = x row slot[r] (or zeros where slot[r] < 0); a row is
// row_vecs elements of V (the row's bytes over sizeof(V)).
template <typename V>
__global__ void __launch_bounds__(kGatherThreads) gather_kernel(const V* __restrict__ x, int row_vecs,
                                                                const int* __restrict__ slot, int rows,
                                                                V* __restrict__ buf) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (r >= rows) return;  // the whole warp
  const int src = slot[r];
  V* dst = buf + (size_t)r * row_vecs;
  if (src < 0) {
    const V zero{};
    for (int q = lane; q < row_vecs; q += 32) dst[q] = zero;
    return;
  }
  const V* row = x + (size_t)src * row_vecs;
  for (int q = lane; q < row_vecs; q += 32) dst[q] = __ldg(row + q);
}

template <typename V>
int gather(const void* x, int row_bytes, const int* slot, int rows, void* buf, cudaStream_t stream) {
  gather_kernel<V><<<(rows + kRowsPerBlock - 1) / kRowsPerBlock, kGatherThreads, 0, stream>>>(
      static_cast<const V*>(x), row_bytes / (int)sizeof(V), slot, rows, static_cast<V*>(buf));
  return (int)cudaGetLastError();
}

bool aligned(const void* p, int row_bytes, int width) {
  return reinterpret_cast<uintptr_t>(p) % width == 0 && row_bytes % width == 0;
}

}  // namespace

// x (N, row_bytes) rows of any dtype, ids (N, k) int32 -> pos (N, k) int32,
// slot (E, C) int32 scratch, buf (E, C, row_bytes).  row_bytes is even (a
// row of bf16 or f32).
extern "C" int moe_dispatch_launch(const void* x, int N, int row_bytes, const int* ids, int k, int E, int C, int* pos,
                                   int* slot, void* buf, cudaStream_t stream) {
  if (E <= 0 || C <= 0) return 0;
  rank_kernel<<<E, kRankThreads, 0, stream>>>(ids, N * k, k, E, C, pos, slot);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int rows = E * C;
  if (aligned(x, row_bytes, 16) && aligned(buf, row_bytes, 16)) return gather<uint4>(x, row_bytes, slot, rows, buf, stream);
  if (aligned(x, row_bytes, 4) && aligned(buf, row_bytes, 4)) return gather<uint32_t>(x, row_bytes, slot, rows, buf, stream);
  return gather<uint16_t>(x, row_bytes, slot, rows, buf, stream);
}
