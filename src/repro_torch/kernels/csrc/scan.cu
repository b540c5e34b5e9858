// scan: inclusive running sums in a fixed order of additions, for sm_90a.
//
// No TPU kernel corresponds to it.  It replaces the running sums of the
// reference engine's predict phase: the lax.scan carry of the regression
// banks (repro/sim/jax_sim.py:621, regression.update_stats at each step)
// and the jnp.cumsum of its prefix programs (jax_sim.py:241, 277, 278, 295,
// 319, 347), which XLA's CPU backend adds in blocks of 16.  The port's plain
// version is kernels/scan.py:cumsum; these kernels give its bits in both of
// its orders, float32 and float64.  The array is viewed as (outer, n, inner)
// and summed along n, so a scan along any axis of a contiguous tensor needs
// no copy before it.  A column is one (o, c) of the view.  One launch a
// call, of one of four kernels:
//
//   * chain_kernel (block >= n, the scan's order): a block per outer and
//     tile of up to 32 of its columns (few outers split further, up to a
//     block per SM).  The order of additions is the
//     contract (the reference's lax.scan carry), so each column's n adds
//     stay one dependent chain, a lane of the chain warp, from +0.0 (a
//     leading -0.0 becomes +0.0, as the plain fold's first add does).  Four
//     copy warps stream chunks of 32 rows into a 7-stage ring in shared
//     memory with cp.async, 16-byte pieces where the chunk allows, five
//     chunks ahead; the chain reads the next chunk into registers, adds the
//     current one's 32 rows (all of them before any is written, so that no
//     add waits on a store's read of its register) and writes its column of
//     sums to shared memory in 16-byte pieces; four store warps take the
//     sums out coalesced.  Named barriers pace them: a stage full, a chunk
//     done.  Bound: latency, n dependent adds (the predict phase's fold,
//     (lanes, executions, 5 (1 + k)) along the executions, is 100 columns
//     of 1,536); measured, each chunk's copies in and out keep the chain
//     waiting about twice as long as it adds (PERF.md).
//
//   * line_kernel (block = 16, n <= 2,048, inner = 1, or a middle axis with
//     fewer columns than 32 a SM): a warp per column,
//     xla_scan::warp_running_sum: the line comes into the warp's slice of
//     shared memory and goes out with coalesced 16-byte copies where it is
//     aligned, element by element where it is not; each lane sums its
//     blocks of 16 in registers, the levels by shuffles; no block barrier,
//     4 warps a block.  Bound: bytes, a read and a write.
//
//   * tile_kernel (block = 16, inner > 1, any n, with enough columns): a
//     block per tile of 32 neighbouring columns (flattened over o and c, so
//     lanes read and write neighbouring addresses), 16 warps, each one block
//     of 16 rows of a chunk of 256 (one level-1 group), folding it in
//     registers while it loads the next chunk's.  The block totals go to
//     shared memory; warp 0 folds each column's 16 in order, adds the upper
//     levels' carried prefix and carries the group's total up the levels
//     (any depth); every warp then adds its block's prefix as it stores.
//     Two barriers a chunk.  Bound: bytes.
//
//   * xla_kernel (block = 16, inner = 1, n > 2,048): a block per line on
//     xla_scan::fold_levels, the line in dynamic shared memory up to the
//     card's opt-in limit and, for longer lines, in its slice of a global
//     scratch the wrapper allocates (scan_scratch says how much).
//
// Only additions: built with -fmad=false, like every includer of
// xla_scan.cuh.  Built with -DSCAN_CLOCKS (tools/scan_clocks.py), each
// kernel also adds clock64 intervals of its phases, in one thread of its
// middle block (two for chain_kernel's loaders), into scan_clock_slots
// (scan_clocks reads them), and scan_launch_path can force xla_kernel at
// any shape.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "xla_scan.cuh"

namespace {

using xla_scan::kBlock;
using xla_scan::kMaxScanLevels;
using xla_scan::padded;
using xla_scan::prefix;
using xla_scan::scan_shape;
using xla_scan::ScanShape;

constexpr int kTileCols = 32;  // columns of a tile
// chain_kernel: a chain warp and its loader warps
constexpr int kChainRows = 32;  // rows of a chunk
constexpr int kStages = 7;      // chunks in the ring (f64: 118 KB of shared memory): 14 named barriers
constexpr int kLag = 2;         // a chunk's stage is refilled once the chain is kLag chunks past it
constexpr int kLoaderWarps = 8;
constexpr int kChainThreads = 32 * (1 + kLoaderWarps);
constexpr int kFullThreads = 32 * (1 + kLoaderWarps / 2);  // the chain and the copy warps
// line_kernel
constexpr int kLineWarps = 4;
constexpr int kMaxLineBlocks = 4;  // blocks of 16 a lane holds: lines up to 2,048
constexpr int kMaxLine = 32 * kMaxLineBlocks * kBlock;
// tile_kernel
constexpr int kTileWarps = kBlock;  // a chunk is one level-1 group: 16 blocks of 16 rows
constexpr int kChunkRows = kTileWarps * kBlock;
// xla_kernel
constexpr int kMaxLineThreads = 256;

#ifdef SCAN_CLOCKS
constexpr int kClockSlots = 8;
__device__ unsigned long long scan_clock_slots[kClockSlots];

// Adds the clock64 time since the last mark into a slot, in registers; the
// chosen thread adds its slots to scan_clock_slots when the clock goes out
// of scope (a global read-modify-write at each mark would stall the
// thread it times).
struct PhaseClock {
  bool on;
  long long t, acc[kClockSlots];
  __device__ explicit PhaseClock(bool who) : on(who) {
    for (int i = 0; i < kClockSlots; ++i) acc[i] = 0;
    t = clock64();
  }
  __device__ __forceinline__ void at(int slot) {
    const long long now = clock64();
    acc[slot] += now - t;
    t = now;
  }
  __device__ ~PhaseClock() {
    if (on)
      for (int i = 0; i < kClockSlots; ++i) atomicAdd(&scan_clock_slots[i], (unsigned long long)acc[i]);
  }
};
#else
struct PhaseClock {
  __device__ explicit PhaseClock(bool) {}
  __device__ void at(int) {}
};
#endif

__device__ __forceinline__ bool probe(int thread) {
  return blockIdx.x == gridDim.x / 2 && threadIdx.x == thread;
}

// Offset of column col of an (outer, n, inner) array: its element i lies at
// that offset + i * inner.
__device__ __forceinline__ size_t column_base(long long col, int n, int inner) {
  return (size_t)(col / inner) * n * inner + (size_t)(col % inner);
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Named barriers of chain_kernel's ring: a chunk's stage is full (landed)
// and done (its sums written).
__device__ __forceinline__ int full_bar(int chunk) { return 1 + chunk % kStages; }
__device__ __forceinline__ int done_bar(int chunk) { return 1 + kStages + chunk % kStages; }

// 16 bytes of consecutive elements from x to p.
__device__ __forceinline__ void put16(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void put16(double* p, const double* x) {
  *reinterpret_cast<double2*>(p) = make_double2(x[0], x[1]);
}

// chain_kernel's sums of a chunk: a column's 32 rows contiguous, padded by
// one 16-byte piece, so that the chain writes them as 16-byte pieces and a
// quarter-warp's pieces fall on distinct banks.
template <typename T>
__host__ __device__ constexpr int sums_pitch() {
  return kChainRows + 16 / (int)sizeof(T);
}

template <typename T>
__host__ __device__ constexpr size_t chain_smem_bytes() {
  return (size_t)kStages * (kChainRows * kTileCols + kTileCols * sums_pitch<T>()) * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(kChainThreads) chain_kernel(const T* __restrict__ a, int n, int inner, int tiles,
                                                              int width, T* __restrict__ out) {
  // a block per (outer, tile of up to 32 columns of it); a chunk is 32 rows
  // of the tile, landed w columns a row in its stage, summed into its sums
  // column by column
  extern __shared__ __align__(16) unsigned char chain_smem[];
  constexpr int kChunk = kChainRows * kTileCols, P = sums_pitch<T>(), E = 16 / (int)sizeof(T);
  T* ring = reinterpret_cast<T*>(chain_smem);
  T* sums = ring + kStages * kChunk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int o = blockIdx.x / tiles, c0 = blockIdx.x % tiles * width, w = min(width, inner - c0);
  const size_t corner = (size_t)o * n * inner + c0;  // row 0, column c0
  const size_t chunk_step = (size_t)kChainRows * inner;
  const int chunks = (n + kChainRows - 1) / kChainRows;
  auto stage = [&](int c) { return ring + c % kStages * kChunk; };
  auto sums_of = [&](int c) { return sums + c % kStages * kTileCols * P; };
  auto rows_of = [&](int c) { return min(kChainRows, n - c * kChainRows); };
  if (warp == 0) {
    // the chain, lane = column: it reads chunk c + 1 into registers, then
    // adds chunk c's rows in order, all 32 before any is stored (so that no
    // add waits on a store's read of its register), and writes its column
    // of sums as 16-byte pieces.  Slots 0: waiting for the next chunk and
    // reading it, 1: the adds and the writes.
    PhaseClock clk(probe(0));
    auto take = [&](int c, T(&v)[kChainRows]) {
      bar_sync(full_bar(c), kFullThreads);
      const T* from = stage(c);
#pragma unroll
      for (int i = 0; i < kChainRows; ++i) v[i] = from[i * w + lane];
    };
    T v[kChainRows];
    take(0, v);
    T acc = T(0);
    for (int c = 0; c < chunks; ++c) {
      T nxt[kChainRows];
      if (c + 1 < chunks) take(c + 1, nxt);
      clk.at(0);
      const int rows = rows_of(c);
      T* sum = sums_of(c) + lane * P;
      if (rows == kChainRows) {
        v[0] = acc + v[0];
#pragma unroll
        for (int i = 1; i < kChainRows; ++i) v[i] = v[i - 1] + v[i];
        acc = v[kChainRows - 1];
#pragma unroll
        for (int i = 0; i < kChainRows; i += E) put16(sum + i, v + i);
      } else {
#pragma unroll
        for (int i = 0; i < kChainRows; ++i)
          if (i < rows) {
            acc = acc + v[i];
            sum[i] = acc;
          }
      }
      bar_arrive(done_bar(c), kChainThreads);
      clk.at(1);
#pragma unroll
      for (int i = 0; i < kChainRows; ++i) v[i] = nxt[i];
    }
  } else {
    // copy warps 1-4 bring each chunk in, kStages - kLag chunks ahead of
    // the chain; store warps 5-8 take its sums out.  A thread moves the same
    // pieces of every whole chunk: 16 bytes when the chunk is one aligned
    // span (the tile is all of its rows) or its rows are aligned and whole
    // pieces long, else elements; a short last chunk goes element by
    // element.
    constexpr int nt = kLoaderWarps / 2 * 32, kMoves = kChunk / nt;
    const int t = (threadIdx.x - 32) % nt;
    const bool span = w == inner;
    const bool vec = ((reinterpret_cast<uintptr_t>(a + corner) | reinterpret_cast<uintptr_t>(out + corner)) & 15) == 0 &&
                     (span || (w % E == 0 && inner % E == 0));
    const int unit = vec ? E : 1, per = span ? kChainRows * w : w;
    // move k of a whole chunk: its offsets in global memory and in the stage
    size_t g_off[kMoves];
    int s_off[kMoves];
    bool on[kMoves];
#pragma unroll
    for (int k = 0; k < kMoves; ++k) {
      const int e = (t + k * nt) * unit, r = e / per, col = e % per;  // a span: r = 0
      on[k] = r < (span ? 1 : kChainRows);
      g_off[k] = (size_t)r * inner + col;
      s_off[k] = r * w + col;
    }
    if (warp <= kLoaderWarps / 2) {
      // a chunk is its stage's and its rows' offsets from chunk 0's moves.
      // Slots 2: waiting for a chunk to land, 3: waiting for the chain to
      // finish the chunk kLag back, 4: issuing the next chunk's copies.
      PhaseClock clk(probe(32));
      unsigned s0[kMoves];
      const char* g0[kMoves];
#pragma unroll
      for (int k = 0; k < kMoves; ++k) {
        s0[k] = (unsigned)__cvta_generic_to_shared(ring + s_off[k]);
        g0[k] = reinterpret_cast<const char*>(a + corner + g_off[k]);
      }
      auto issue = [&](int c) {
        const int rows = rows_of(c);
        if (c < chunks && rows < kChainRows) {
          const T* src = a + corner + (size_t)c * chunk_step;
          for (int q = t; q < rows * w; q += nt)
            xla_scan::cp_async_bytes<sizeof(T)>(stage(c) + q, src + (size_t)(q / w) * inner + q % w);
        } else if (c < chunks) {
          const unsigned so = (unsigned)(c % kStages * kChunk * sizeof(T));
          const size_t go = (size_t)c * chunk_step * sizeof(T);
#pragma unroll
          for (int k = 0; k < kMoves; ++k)
            if (on[k]) {
              if (vec)
                asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s0[k] + so), "l"(g0[k] + go)
                             : "memory");
              else
                asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s0[k] + so), "l"(g0[k] + go),
                             "n"(sizeof(T))
                             : "memory");
            }
        }
        cp_async_commit();
      };
      for (int c = 0; c < kStages - kLag; ++c) issue(c);
      for (int c = 0; c < chunks; ++c) {
        cp_async_wait<kStages - kLag - 1>();  // chunk c has landed (one group a chunk)
        bar_arrive(full_bar(c), kFullThreads);
        clk.at(2);
        if (c >= kLag) bar_sync(done_bar(c - kLag), kChainThreads);
        clk.at(3);
        issue(c + kStages - kLag);  // into chunk c - kLag's stage, read by the chain
        clk.at(4);
      }
      for (int c = max(0, chunks - kLag); c < chunks; ++c) bar_sync(done_bar(c), kChainThreads);
    } else {
      // each element's place in the sums: column * P + row.  Slots 5:
      // waiting for a chunk's sums (done completes once the copy warps
      // reach the chunk kLag on), 6: storing them.
      PhaseClock clk(probe(32 + nt));
      int t_off[kMoves][E];
#pragma unroll
      for (int k = 0; k < kMoves; ++k)
#pragma unroll
        for (int q = 0; q < E; ++q) t_off[k][q] = (s_off[k] + q) % w * P + (s_off[k] + q) / w;
      for (int c = 0; c < chunks; ++c) {
        bar_sync(done_bar(c), kChainThreads);
        clk.at(5);
        const int rows = rows_of(c);
        T* dst = out + corner + (size_t)c * chunk_step;
        const T* sm = sums_of(c);
        if (rows < kChainRows) {
          for (int q = t; q < rows * w; q += nt) dst[(size_t)(q / w) * inner + q % w] = sm[q % w * P + q / w];
        } else if (vec) {
#pragma unroll
          for (int k = 0; k < kMoves; ++k)
            if (on[k]) {
              T x[E];
#pragma unroll
              for (int q = 0; q < E; ++q) x[q] = sm[t_off[k][q]];
              put16(dst + g_off[k], x);
            }
        } else {
#pragma unroll
          for (int k = 0; k < kMoves; ++k)
            if (on[k]) dst[g_off[k]] = sm[t_off[k][0]];
        }
        clk.at(6);
      }
    }
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(kLineWarps * 32) line_kernel(const T* __restrict__ a, long long cols, int n, int inner,
                                                               T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char line_smem[];
  const int w = threadIdx.x >> 5;
  const long long col = (long long)blockIdx.x * kLineWarps + w;
  if (col >= cols) return;  // a whole warp
  const size_t base = column_base(col, n, inner);
  const T* d = a + base;
  T* o = out + base;
  const bool vec = inner == 1 && ((reinterpret_cast<uintptr_t>(d) | reinterpret_cast<uintptr_t>(o)) & 15) == 0;
  T* buf = reinterpret_cast<T*>(line_smem) + w * xla_scan::staged_elems<T, R>();
  // slots 0: the copy in and level 0, 1: level 1, 2: level 2 and the prefixes, 3: the copy out
  xla_scan::warp_running_sum<R>(d, o, n, inner, vec, buf, PhaseClock(probe(0)));
}

template <typename T, int R>
int launch_lines(const T* a, long long cols, int n, int inner, T* out, cudaStream_t stream) {
  static bool lifted = false;
  const long long blocks = (cols + kLineWarps - 1) / kLineWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)kLineWarps * xla_scan::staged_elems<T, R>() * sizeof(T);
  if (bytes > 48 * 1024)
    if (int err = xla_scan::allow_shared(line_kernel<T, R>, lifted)) return err;
  line_kernel<T, R><<<(unsigned)blocks, kLineWarps * 32, bytes, stream>>>(a, cols, n, inner, out);
  return (int)cudaGetLastError();
}

// Rows row0 .. row0 + 15 of a column (+0.0 past n or off the array).
template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, int inner, int row0, int n, bool live,
                                          T (&v)[kBlock]) {
#pragma unroll
  for (int q = 0; q < kBlock; ++q) {
    const int row = row0 + q;
    v[q] = live && row < n ? src[(size_t)row * inner] : T(0);
  }
}

template <typename T>
__global__ void __launch_bounds__(kTileWarps * 32) tile_kernel(const T* __restrict__ a, long long cols, int n, int inner,
                                                               T* __restrict__ out, ScanShape sh) {
  // per chunk (two, alternating): [0] the level-1 sum before the chunk, [1 + w] block w's total, then its level-1 sum
  __shared__ T part[2][kTileWarps + 1][kTileCols];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long col = (long long)blockIdx.x * kTileCols + lane;
  const bool live = col < cols;
  const size_t base = live ? column_base(col, n, inner) : 0;
  const T* src = a + base;
  T* dst = out + base;
  const int chunks = (n + kChunkRows - 1) / kChunkRows;
  // slots 0: loads and level 0, 1: barrier, 2: the levels (warp 0), 3: barrier, 4: prefixes and stores
  PhaseClock clk(probe(0));
  T nxt[kBlock];
  load_rows(src, inner, w * kBlock, n, live, nxt);
  // warp 0, per column: the last level-1 sum so far, and each level l >= 2's
  // running sum in its current group and its exclusive prefix
  T prev = T(0), loc[kMaxScanLevels], ex[kMaxScanLevels + 1];
#pragma unroll
  for (int l = 0; l <= kMaxScanLevels; ++l) {
    if (l < kMaxScanLevels) loc[l] = T(0);
    ex[l] = T(0);
  }
  for (int k = 0; k < chunks; ++k) {
    T v[kBlock];
#pragma unroll
    for (int q = 0; q < kBlock; ++q) v[q] = nxt[q];
    if (k + 1 < chunks) load_rows(src, inner, (k + 1) * kChunkRows + w * kBlock, n, live, nxt);
    T acc = T(0);
#pragma unroll
    for (int q = 0; q < kBlock; ++q) {
      acc = acc + v[q];
      v[q] = acc;
    }
    T(*p)[kTileCols] = part[k & 1];
    p[w + 1][lane] = acc;
    clk.at(0);
    __syncthreads();
    clk.at(1);
    if (w == 0) {
      T t[kBlock];
#pragma unroll
      for (int j = 0; j < kBlock; ++j) t[j] = p[j + 1][lane];
      T l1 = T(0);  // level 1 in order from +0.0, plus the levels above's prefix unless it is the top
#pragma unroll
      for (int j = 0; j < kBlock; ++j) {
        l1 = l1 + t[j];
        t[j] = sh.depth > 2 ? l1 + ex[2] : l1;
      }
#pragma unroll
      for (int j = 0; j < kBlock; ++j) p[j + 1][lane] = t[j];
      p[0][lane] = prev;
      prev = t[kBlock - 1];
      // the group's total is item k of level 2; a level's group, once
      // whole, is the next item of the level above
      T val = l1;
      int idx = k;
#pragma unroll
      for (int l = 2; l < kMaxScanLevels; ++l) {
        if (l >= sh.depth) break;
        const int at = idx % kBlock;
        loc[l] = (at ? loc[l] : T(0)) + val;
        ex[l] = l + 1 < sh.depth ? loc[l] + ex[l + 1] : loc[l];
        if (at != kBlock - 1) break;
        val = loc[l];
        idx /= kBlock;
      }
    }
    clk.at(2);
    __syncthreads();
    clk.at(3);
    const T e = p[w][lane];
#pragma unroll
    for (int q = 0; q < kBlock; ++q) {
      const int row = k * kChunkRows + w * kBlock + q;
      if (live && row < n) dst[(size_t)row * inner] = v[q] + e;
    }
    clk.at(4);
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
  // slots 0: loads, 1: the levels, 2: prefixes and stores
  PhaseClock clk(probe(0));
  const size_t line = blockIdx.x;
  const size_t base = line / inner * n * inner + line % inner;
  T* scan = reinterpret_cast<T*>(scratch ? scratch + line * scratch_row : smem_raw);
  T* tot = scan + padded(n) + 1;
  const ScanShape sh = scan_shape(n);
  for (int i = threadIdx.x; i < n; i += blockDim.x) scan[padded(i)] = a[base + (size_t)i * inner];
  __syncthreads();
  clk.at(0);
  xla_scan::fold_levels(scan, tot, sh);
  clk.at(1);
  const T* tot1 = tot + sh.off[1];
  const bool deep = sh.depth > 1;
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[base + (size_t)i * inner] = prefix(i, scan, tot1, deep);
  clk.at(2);
}

// Bytes of global scratch a line of xla_kernel needs: 0 when its buffers
// fit in shared memory.
template <typename T>
long long scratch_bytes(int n) {
  const size_t bytes = line_bytes<T>(n);
  return bytes <= (size_t)xla_scan::optin_limit() ? 0 : (long long)((bytes + 15) / 16 * 16);
}

// The card's streaming multiprocessors.
int sm_count() {
  static int count = -1;
  if (count < 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      count = 132;
  }
  return count;
}

// True when XLA's order at (n, inner) takes xla_kernel.
bool takes_xla_kernel(int n, int inner) { return inner == 1 && n > kMaxLine; }

// True when XLA's order at (n, inner) over cols columns takes line_kernel:
// lines along the last axis, or along another when they fill fewer tiles
// than the card has SMs (tile_kernel would walk each tile's chunks one
// after another on a few SMs; a warp a column loads all of them at once).
bool takes_line_kernel(long long cols, int n, int inner) {
  return n <= kMaxLine && (inner == 1 || cols < (long long)kTileCols * sm_count());
}

enum Path { kAuto = -1 };  // scan_launch_path: -1 as scan_launch chooses, 0 xla_kernel

template <typename T>
int launch(const void* a, int outer, int n, int inner, bool sequential, void* out, unsigned char* scratch,
           cudaStream_t stream, int path) {
  static bool lifted = false, chain_lifted = false;
  const long long cols = (long long)outer * inner;
  if (cols <= 0 || n <= 0) return (int)cudaGetLastError();
  const long long tiles = (cols + kTileCols - 1) / kTileCols;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (sequential) {
    // tiles of up to 32 columns; few outers split their columns further, up
    // to a block per SM (a block's copies of a chunk take about as long at 1
    // column as at 32: the fold measured 15% faster at 1-5 columns a block)
    const int groups = std::max(1, std::min(inner, (sm_count() + outer - 1) / outer));
    const int width = std::min(kTileCols, (inner + groups - 1) / groups);
    const int per_outer = (inner + width - 1) / width;
    if ((long long)outer * per_outer > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const size_t bytes = chain_smem_bytes<T>();
    if (bytes > 48 * 1024)
      if (int err = xla_scan::allow_shared(chain_kernel<T>, chain_lifted)) return err;
    chain_kernel<T><<<(unsigned)(outer * per_outer), kChainThreads, bytes, stream>>>((const T*)a, n, inner, per_outer,
                                                                                     width, (T*)out);
    return (int)cudaGetLastError();
  }
  if (xla_scan::too_long(n)) return (int)cudaErrorInvalidValue;
  if (path == kAuto && takes_line_kernel(cols, n, inner)) {
    switch (((n + kBlock - 1) / kBlock + 31) / 32) {  // blocks of 16 a lane
      case 1:
        return launch_lines<T, 1>((const T*)a, cols, n, inner, (T*)out, stream);
      case 2:
        return launch_lines<T, 2>((const T*)a, cols, n, inner, (T*)out, stream);
      case 3:
        return launch_lines<T, 3>((const T*)a, cols, n, inner, (T*)out, stream);
      default:
        return launch_lines<T, kMaxLineBlocks>((const T*)a, cols, n, inner, (T*)out, stream);
    }
  }
  if (path == kAuto && inner > 1) {
    tile_kernel<T><<<(unsigned)tiles, kTileWarps * 32, 0, stream>>>((const T*)a, cols, n, inner, (T*)out,
                                                                      scan_shape(n));
    return (int)cudaGetLastError();
  }
  if (cols > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t row = (size_t)scratch_bytes<T>(n);
  if (row && !scratch) return (int)cudaErrorInvalidValue;
  const size_t bytes = row ? 0 : line_bytes<T>(n);
  if (bytes > 48 * 1024)
    if (int err = xla_scan::allow_shared(xla_kernel<T>, lifted)) return err;
  // one thread per block of 16 at the lowest level, in whole warps
  const int threads = std::min(kMaxLineThreads, std::max(32, ((n + 15) / 16 + 31) / 32 * 32));
  xla_kernel<T><<<(unsigned)cols, threads, bytes, stream>>>((const T*)a, n, inner, (T*)out,
                                                             row ? scratch : nullptr, row);
  return (int)cudaGetLastError();
}

template <typename... A>
int by_dtype(int dtype, A... args) {
  switch (dtype) {
    case 0:
      return launch<float>(args...);
    case 1:
      return launch<double>(args...);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Bytes of global scratch per line that scan_launch needs in XLA's order
// at (n, inner) (0: none; only xla_kernel's longest lines take it), or -1
// for an unknown dtype.
extern "C" long long scan_scratch(int n, int inner, int dtype) {
  switch (dtype) {
    case 0:
      return takes_xla_kernel(n, inner) ? scratch_bytes<float>(n) : 0;
    case 1:
      return takes_xla_kernel(n, inner) ? scratch_bytes<double>(n) : 0;
    default:
      return -1;
  }
}

// a (outer, n, inner) contiguous -> out, its inclusive running sums along n:
// sequential != 0 in order from +0.0, else in XLA's CPU order; scratch:
// outer x inner x scan_scratch(n, inner) bytes, or null when that is 0 or
// the sum is sequential.  dtype 0 f32, 1 f64.
extern "C" int scan_launch(const void* a, int outer, int n, int inner, int sequential, int dtype, void* out,
                           unsigned char* scratch, cudaStream_t stream) {
  return by_dtype(dtype, a, outer, n, inner, sequential != 0, out, scratch, stream, (int)kAuto);
}

#ifdef SCAN_CLOCKS
// scan_launch with XLA's order forced onto xla_kernel (path 0) or chosen as
// scan_launch chooses it (-1); scratch as scan_scratch(n, 1) gives it.
extern "C" int scan_launch_path(const void* a, int outer, int n, int inner, int sequential, int dtype, void* out,
                                unsigned char* scratch, cudaStream_t stream, int path) {
  return by_dtype(dtype, a, outer, n, inner, sequential != 0, out, scratch, stream, path);
}

// The phase clocks into host[0 .. 8), then zeroed.
extern "C" int scan_clocks(long long* host) {
  static const unsigned long long zero[kClockSlots] = {};
  if (cudaError_t err = cudaMemcpyFromSymbol(host, scan_clock_slots, sizeof zero)) return (int)err;
  return (int)cudaMemcpyToSymbol(scan_clock_slots, zero, sizeof zero);
}
#endif
