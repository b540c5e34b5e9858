// moe_dispatch: the sort-based dispatch of a routed MoE layer, for sm_90a.
//
// No TPU kernel: it replaces the dispatch that the reference leaves to XLA
// in repro/models/layers.py:544-556 (moe; the shard body
// _moe_dispatch_compute :431-447): argsort over the flat expert ids,
// bincount, cumsum, and the scatter of each kept token's row into the
// expert buffer.
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
// Bound: bytes.  Each byte of buf is written once (E * C rows, 672 MB at
// qwen3-moe's prefill shape N 8,192, k 8, E 128, C 641, D 4,096 bf16) and
// each row of a token with a kept assignment read once; the ids and pos are
// small beside them.  The design moves just those bytes, in one launch,
// dispatch_kernel; block b owns the tokens [t0, t1), so the flat ids
// [t0 k, t1 k), at most kEntries of them.
//   Counts and ranks.  The block tallies the ids before and after its range
//   itself, in shared memory (the ids sit in L2), and its range per warp,
//   each warp a contiguous piece of it.  A warp's offset in expert e is the
//   count before the range plus the earlier warps' counts; each warp then
//   ranks its piece 32 ids at a time in flat order (__match_any_sync: a
//   lane's rank is the number of lower lanes with its id).  The ranks are
//   exact integers, so no order of work changes pos.  No grid barrier and
//   no second launch: every block counts all N k ids.
//   Zero rows.  From the totals, the empty slots [min(total_e, C), C) of
//   every expert (one contiguous span each) are known to every block.
//   Three quarters of them are split over the blocks so that each block's
//   rows written from x, rows read and zero rows come to about the same;
//   the last quarter (where the zero bytes are many) is a pool that blocks
//   claim 64 KB at a time once their own work is issued, since the SMs do
//   not all get the same share of the memory's rate.  The claim counters
//   are the stream's own; the last block out leaves them zero.
//   Token-major copy (rows and bases 16-byte aligned, and more tokens a
//   block than warps, as at prefill).  One thread of the block drives the
//   TMA: a ring of row chunks (kChunk bytes) in shared memory, each chunk
//   of a token with a kept assignment read once by a bulk copy
//   (cp.async.bulk, completing on the stage's mbarrier) and written to
//   each of the token's kept slots by bulk stores; a stage is refilled
//   once its stores have read it (cp.async.bulk.wait_group.read).
//   A token whose assignments were all dropped is not read.  The block's
//   zero rows go out as bulk stores from a zeroed chunk, paced with the
//   tokens (each token's share before its own stores), so that the reads
//   the ring waits for are never queued behind the whole zero fill and
//   every block's stream of copies ends at about the same time.
//   Few tokens a block (decode: a token or none; the grid then has a block
//   for every kBlockBytes of buf), or unaligned rows (a base or a row size
//   off 16 bytes), take the same launch through registers: a warp per token
//   reads each element once (16, 4 or 2 bytes, kBatch a lane in flight) and
//   writes it to every kept slot; then every thread writes its share of
//   the zero rows.  A block with a token's row or two to copy would spend
//   more on the TMA's round trips (a load, then the stores' reads of shared
//   memory) than on the copy.  The copy is of bits, so buf equals the
//   plain version's in any dtype.
//
// Built with -DMOE_CLOCKS (tools/moe_dispatch_clocks.py), the kernel also
// adds clock64 intervals of its phases, in the middle block's thread 0,
// into moe_dispatch_clock_slots, and writes each block's global-timer
// marks and counts into moe_dispatch_block_stats.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8192;                // bytes of a ring stage: a bf16 row of 4,096
constexpr int kPending = 8;                 // store groups that may still be reading the ring
constexpr int kMaxStages = 32;
constexpr int kEntries = 4096;              // flat ids a block at most
constexpr int kBatch = 16;                  // elements a lane in flight, copying through registers
constexpr int kMaxExperts = 1024;           // moe_dispatch.MAX_EXPERTS
constexpr long long kBlockBytes = 1 << 13;  // bytes of buf a block at least, where the card has room
constexpr long long kWaitCycles = 1LL << 34;
constexpr long long kPoolMin = 16LL << 20;  // zero bytes from which a quarter of the zero rows are claimed
constexpr int kPoolChunk = 1 << 16;         // bytes of zero rows a claim (at least a row)

#ifdef MOE_CLOCKS
constexpr int kClockSlots = 5;
__device__ unsigned long long moe_dispatch_clock_slots[kClockSlots];

// Adds the clock64 time since the last mark into a slot, in registers; the
// chosen thread adds its slots to moe_dispatch_clock_slots at the end.
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
      for (int i = 0; i < kClockSlots; ++i) atomicAdd(&moe_dispatch_clock_slots[i], (unsigned long long)acc[i]);
  }
};

// Per block (the first kStatBlocks): the global timer (ns) at its start,
// once ranked and at the end of its copies; its bulk stores of rows and
// its zero rows.
constexpr int kStatBlocks = 1024, kStats = 5;
__device__ long long moe_dispatch_block_stats[kStatBlocks * kStats];

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define BLOCK_STAT(i, v) \
  if (blockIdx.x < kStatBlocks) moe_dispatch_block_stats[blockIdx.x * kStats + (i)] = (v)
#else
struct PhaseClock {
  __device__ explicit PhaseClock(bool) {}
  __device__ void at(int) {}
};
#define BLOCK_STAT(i, v)
#endif

// Byte offsets of the dynamic shared memory: the ring (stages chunks, then
// the zeroed chunk; first, so 128-byte aligned), its mbarriers, the
// range's ids (then its destination rows), the per-warp counts (kWarps,
// E), two arrays of E and three scalars.
struct Layout {
  int zero, bars, ent, cnt, lo, hi, scalars, total;
};

__host__ __device__ inline Layout layout(int stages, int E) {
  Layout l;
  l.zero = stages * kChunk;
  l.bars = stages > 0 ? l.zero + kChunk : 0;
  l.ent = l.bars + stages * 8;
  l.cnt = l.ent + kEntries * 4;
  l.lo = l.cnt + kWarps * E * 4;
  l.hi = l.lo + E * 4;
  l.scalars = l.hi + E * 4;
  l.total = l.scalars + 3 * 4;
  return l;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

// Waits for the phase of bar with this parity to complete; a copy that
// never lands (some 8 s) fails the launch rather than hanging the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  const long long t = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t > kWaitCycles) __trap();
  } while (!done);
}

// A TMA bulk copy of bytes (a multiple of 16, both ends 16-byte aligned)
// from global memory into shared memory, completing on bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
}

// ent holds each entry's destination row e * C + pos, or -1: does the
// range's token t have a kept assignment?
__device__ __forceinline__ bool has_kept(const int* ent, int t, int k) {
  for (int j = 0; j < k; ++j)
    if (ent[t * k + j] >= 0) return true;
  return false;
}

__device__ __forceinline__ int next_kept(const int* ent, int t, int n_tok, int k) {
  while (t < n_tok && !has_kept(ent, t, k)) ++t;
  return t;
}

// The zero rows in expert order: expert e's are its rows [kept[e], C), the
// zero rows [zoff[e], zoff[e] + C - kept[e]).  The expert holding zero row
// z < Z: the last e with zoff[e] <= z (zoff is non-decreasing).
__device__ __forceinline__ int expert_of_zero(const int* zoff, int E, long long z) {
  int lo = 0, hi = E - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (zoff[mid] <= z) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// Bulk stores of zeros from the zeroed chunk, over zero rows [z, end).
struct ZeroRows {
  const int *kept, *zoff;
  int E, C, row_bytes, e;
  long long z, end;
  unsigned char* buf;
  uint32_t tile;

  __device__ void upto(long long target) {
    target = min(target, end);
    while (z < target) {
      while (z >= (long long)zoff[e] + C - kept[e]) ++e;
      const long long stop = min(target, (long long)zoff[e] + C - kept[e]);
      unsigned char* dst = buf + ((size_t)e * C + kept[e] + (z - zoff[e])) * row_bytes;
      const size_t n = (size_t)(stop - z) * row_bytes;
      for (size_t o = 0; o < n; o += kChunk) bulk_store(dst + o, tile, (uint32_t)min((size_t)kChunk, n - o));
      z = stop;
    }
  }
};

// The block's copies, by one thread: every chunk of every token of the
// range with a kept assignment through the ring (stages >= kPending + 2),
// and the zero rows, each token's share of them just before its stores.
// Returns the bulk stores of rows it issued.
__device__ long long copy_rows(const unsigned char* __restrict__ x, int row_bytes, const int* ent, int t0, int n_tok,
                               int k, int stages, unsigned char* ring, const uint64_t* bars, ZeroRows& zeros) {
  const int n_chunks = (row_bytes + kChunk - 1) / kChunk;
  const int ahead = stages - kPending;  // loads in flight at most
  const uint32_t ring0 = smem_addr(ring), bar0 = smem_addr(bars);
  const long long z0 = zeros.z, n_zero = zeros.end - zeros.z;
  int ld_tok = next_kept(ent, 0, n_tok, k), ld_ch = 0, st_tok = ld_tok, st_ch = 0;
  long long issued = 0, done = 0, stores = 0;
  for (;;) {
    while (ld_tok < n_tok && issued < done + ahead) {
      const int stage = (int)(issued % stages);
      // the stage's last stores (item issued - stages) are at least
      // kPending groups back: wait until they have read it
      if (issued >= stages) asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kPending) : "memory");
      const int off = ld_ch * kChunk;
      bulk_load(ring0 + stage * kChunk, x + (size_t)(t0 + ld_tok) * row_bytes + off, min(kChunk, row_bytes - off),
                bar0 + stage * 8);
      ++issued;
      if (++ld_ch == n_chunks) {
        ld_ch = 0;
        ld_tok = next_kept(ent, ld_tok + 1, n_tok, k);
      }
    }
    if (done == issued) break;
    if (st_ch == 0) zeros.upto(z0 + n_zero * (st_tok + 1) / n_tok);
    const int stage = (int)(done % stages);
    bar_wait(bar0 + stage * 8, (uint32_t)((done / stages) & 1));
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const int off = st_ch * kChunk;
    const uint32_t bytes = min(kChunk, row_bytes - off);
    for (int j = 0; j < k; ++j) {
      const int d = ent[st_tok * k + j];
      if (d >= 0) {
        bulk_store(zeros.buf + (size_t)d * row_bytes + off, ring0 + stage * kChunk, bytes);
        ++stores;
      }
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    ++done;
    if (++st_ch == n_chunks) {
      st_ch = 0;
      st_tok = next_kept(ent, st_tok + 1, n_tok, k);
    }
  }
  zeros.upto(zeros.end);
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  // the shared memory must outlive the stores' reads of it; their writes
  // are the launch's, visible when it completes
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  return stores;
}

// A warp per token, elements of V: each read once into a register (kBatch
// a lane in flight) and written to each kept slot, a row after another
// (one warp's contiguous stores drain faster than pieces of each row from
// several warps).
template <typename V>
__device__ void copy_rows_warp(const V* __restrict__ x, int row_vecs, const int* ent, int t0, int n_tok, int k,
                               V* __restrict__ buf) {
  const int lane = threadIdx.x & 31;
  for (int t = threadIdx.x >> 5; t < n_tok; t += kWarps) {
    if (!has_kept(ent, t, k)) continue;
    const V* src = x + (size_t)(t0 + t) * row_vecs;
    for (int q0 = lane; q0 < row_vecs; q0 += 32 * kBatch) {
      V v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (q0 + 32 * u < row_vecs) v[u] = __ldg(src + q0 + 32 * u);
      for (int j = 0; j < k; ++j) {
        const int d = ent[t * k + j];
        if (d < 0) continue;
        V* dst = buf + (size_t)d * row_vecs + q0;
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (q0 + 32 * u < row_vecs) dst[32 * u] = v[u];
      }
    }
  }
}

// Zero rows [zlo, zhi), by every thread of the block, elements of V.
template <typename V>
__device__ void zero_rows_threads(V* __restrict__ buf, int row_vecs, int E, int C, const int* kept, const int* zoff,
                                  long long zlo, long long zhi) {
  const V zero{};
  for (int e = zlo < zhi ? expert_of_zero(zoff, E, zlo) : E; e < E && zoff[e] < zhi; ++e) {
    const long long a = max(zlo, (long long)zoff[e]), b = min(zhi, (long long)zoff[e] + C - kept[e]);
    if (a >= b) continue;
    V* dst = buf + ((size_t)e * C + kept[e] + (a - zoff[e])) * row_vecs;
    const size_t n = (size_t)(b - a) * row_vecs;
    for (size_t q = threadIdx.x; q < n; q += kThreads) dst[q] = zero;
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads, 1)
    dispatch_kernel(const unsigned char* __restrict__ x, int N, int row_bytes, const int* __restrict__ ids, int k,
                    int E, int C, int stages, int* __restrict__ pos, unsigned char* __restrict__ buf,
                    int* __restrict__ pool) {
  constexpr bool kBulk = sizeof(V) == 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay = layout(stages, E);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bars);
  int* ent = reinterpret_cast<int*>(smem + lay.ent);
  int* cnt = reinterpret_cast<int*>(smem + lay.cnt);
  int* lo = reinterpret_cast<int*>(smem + lay.lo);  // before the range, then kept[e]
  int* hi = reinterpret_cast<int*>(smem + lay.hi);  // after the range, then zoff[e]
  int& kept_before = reinterpret_cast<int*>(smem + lay.scalars)[0];
  int& kept_through = reinterpret_cast<int*>(smem + lay.scalars)[1];
  int& zeros = reinterpret_cast<int*>(smem + lay.scalars)[2];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = gridDim.x, b = blockIdx.x;
  const int t0 = (int)((long long)b * N / G), t1 = (int)((long long)(b + 1) * N / G);
  const int n_assign = N * k, start = t0 * k, end = t1 * k, n_ent = end - start;
  // rows through the TMA ring where they are aligned and every block has
  // more tokens than warps; else a warp a token through registers (fewer
  // round trips where a block has little to copy)
  const bool ring = kBulk && N / G > kWarps;
  PhaseClock clk(b == G / 2 && tid == 0);
  if (tid == 0) BLOCK_STAT(0, global_ns());

  for (int i = tid; i < kWarps * E; i += kThreads) cnt[i] = 0;
  for (int e = tid; e < E; e += kThreads) lo[e] = hi[e] = 0;
  if (ring) {  // the zeroed chunks, seen by the bulk stores; the ring's mbarriers
    for (int q = tid; q < kChunk / 16; q += kThreads) reinterpret_cast<uint4*>(smem + lay.zero)[q] = uint4{};
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (tid < stages) {
      bar_init(smem_addr(bars + tid));
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  if (tid == 0) kept_before = kept_through = 0;
  __syncthreads();

  // the ids before and after the range, tallied in shared memory
  auto tally = [&](int f, int id) {
    if ((f < start || f >= end) && id >= 0 && id < E) atomicAdd(f < start ? lo + id : hi + id, 1);
  };
  const int n_vec = reinterpret_cast<uintptr_t>(ids) % 16 == 0 ? n_assign / 4 : 0;
#pragma unroll 4
  for (int v = tid; v < n_vec; v += kThreads) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(ids) + v);
    tally(4 * v, q.x);
    tally(4 * v + 1, q.y);
    tally(4 * v + 2, q.z);
    tally(4 * v + 3, q.w);
  }
  for (int f = 4 * n_vec + tid; f < n_assign; f += kThreads) tally(f, __ldg(ids + f));
  clk.at(0);

  // the range: a contiguous piece a warp, its ids into ent, counted a warp
  const int per_warp = (n_ent + kWarps - 1) / kWarps;
  const int w_lo = min(n_ent, warp * per_warp), w_hi = min(n_ent, w_lo + per_warp);
  for (int f = w_lo + lane; f < w_hi; f += 32) {
    const int id = __ldg(ids + start + f);
    ent[f] = id;
    if (id >= 0 && id < E) atomicAdd(cnt + warp * E + id, 1);
  }
  __syncthreads();
  clk.at(1);

  // each warp's offset in each expert; the totals, the kept rows before the
  // range and through it, and the zero rows of each expert
  int before_sum = 0, through_sum = 0;
  for (int e = tid; e < E; e += kThreads) {
    int c[kWarps];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) c[w] = cnt[w * E + e];
    int run = lo[e];
    before_sum += min(run, C);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      cnt[w * E + e] = run;
      run += c[w];
    }
    through_sum += min(run, C);
    const int kept = min(run + hi[e], C);
    lo[e] = kept;
    hi[e] = C - kept;
  }
  for (int o = 16; o > 0; o >>= 1) {
    before_sum += __shfl_xor_sync(kFull, before_sum, o);
    through_sum += __shfl_xor_sync(kFull, through_sum, o);
  }
  if (lane == 0 && through_sum > 0) {
    atomicAdd(&kept_before, before_sum);
    atomicAdd(&kept_through, through_sum);
  }
  __syncthreads();
  if (warp == 0) {  // zoff: the exclusive prefix of the zero rows over the experts, a run of them a lane
    const int per = (E + 31) / 32, e0 = min(E, lane * per), e1 = min(E, e0 + per);
    int sum = 0;
    for (int e = e0; e < e1; ++e) sum += hi[e];
    int s = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    int run = s - sum;
    for (int e = e0; e < e1; ++e) {
      const int z = hi[e];
      hi[e] = run;
      run += z;
    }
    if (lane == 31) zeros = s;
  }
  clk.at(2);

  // rank each warp's piece in flat order, 32 ids at a time; pos, and each
  // entry's destination row (or -1) into ent
  for (int base = w_lo; base < w_hi; base += 32) {
    const int f = base + lane;
    const bool live = f < w_hi;
    const int id = live ? ent[f] : INT_MIN;
    const unsigned same = __match_any_sync(kFull, id);
    const bool in = id >= 0 && id < E;
    const int p = in ? cnt[warp * E + id] + __popc(same & ((1u << lane) - 1)) : -1;
    __syncwarp();
    if (in && lane == 31 - __clz(same)) cnt[warp * E + id] += __popc(same);
    __syncwarp();
    if (live) {
      pos[start + f] = p;
      ent[f] = in && p < C ? id * C + p : -1;
    }
  }
  __syncthreads();
  clk.at(3);

  // The zero rows: a quarter of them (the last) in a pool that blocks
  // claim as they run out of work, where they are many; the others split so
  // that each block's rows written and rows read, plus its zero rows, come
  // to about the same (rows written before block b: sum_e min(count before,
  // C); rows read: its first token t0).
  const long long Z = zeros, Zs = Z - (pool != nullptr && ring && Z * row_bytes >= kPoolMin ? Z / 4 : 0);
  const long long pooled = Z - Zs;
  const long long work = (long long)E * C - Z + N + Zs;  // rows written from x, rows read, zero rows
  const long long zlo = min(Zs, max(0LL, (long long)b * work / G - kept_before - t0));
  const long long zhi = max(zlo, min(Zs, max(0LL, (long long)(b + 1) * work / G - kept_through - t1)));
  if (tid == 0) BLOCK_STAT(1, global_ns());
  if (ring) {
    if (tid != 0) return;
    ZeroRows zr{lo, hi, E, C, row_bytes, zlo < zhi ? expert_of_zero(hi, E, zlo) : 0, zlo, zhi, buf,
                smem_addr(smem + lay.zero)};
    [[maybe_unused]] const long long stores = copy_rows(x, row_bytes, ent, t0, t1 - t0, k, stages, smem, bars, zr);
    [[maybe_unused]] long long claimed = 0;
    if (pooled > 0) {
      const int per_claim = max(1, kPoolChunk / row_bytes);
      for (;;) {
        asm volatile("cp.async.bulk.wait_group.read 2;\n" ::: "memory");  // at most three claims in flight
        const long long got = atomicAdd(pool, per_claim);
        if (got >= pooled) break;
        zr.z = Zs + got;
        zr.end = min(Z, zr.z + per_claim);
        zr.e = expert_of_zero(hi, E, zr.z);
        claimed += zr.end - zr.z;
        zr.upto(zr.end);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      __threadfence();
      if (atomicAdd(pool + 1, 1) == G - 1) {  // the last block out leaves the pool empty for the next launch
        atomicExch(pool, 0);
        atomicExch(pool + 1, 0);
      }
    }
    clk.at(4);
    BLOCK_STAT(2, global_ns());
    BLOCK_STAT(3, stores);
    BLOCK_STAT(4, zhi - zlo + claimed);
  } else {
    const int row_vecs = row_bytes / (int)sizeof(V);
    copy_rows_warp(reinterpret_cast<const V*>(x), row_vecs, ent, t0, t1 - t0, k, reinterpret_cast<V*>(buf));
    zero_rows_threads(reinterpret_cast<V*>(buf), row_vecs, E, C, lo, hi, zlo, zhi);
    clk.at(4);
    if (tid == 0) {
      BLOCK_STAT(2, global_ns());
      BLOCK_STAT(4, zhi - zlo);
    }
  }
}

bool aligned(const void* p, int row_bytes, int width) {
  return reinterpret_cast<uintptr_t>(p) % width == 0 && row_bytes % width == 0;
}

template <typename V>
int launch(const void* x, int N, int row_bytes, const int* ids, int k, int E, int C, int* pos, void* buf, int* pool,
           cudaStream_t stream) {
  constexpr bool kBulk = sizeof(V) == 16;
  int dev, sms, optin;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return (int)cudaGetLastError();
  const int fixed = layout(0, E).total;
  const int stages = kBulk ? std::min(kMaxStages, (optin - fixed - kChunk) / (kChunk + 8)) : 0;
  if ((kBulk && stages < kPending + 2) || fixed > optin) return (int)cudaErrorInvalidValue;
  const int smem = layout(stages, E).total;
  static int allowed = 0;  // the dynamic shared memory this instantiation may take
  if (smem > allowed) {
    const int err = (int)cudaFuncSetAttribute(dispatch_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != 0) return err;
    allowed = smem;
  }
  // enough blocks for each to hold at most kEntries ids, and one an SM
  // where buf has kBlockBytes a block for them
  const long long per_block = k > 0 ? kEntries / k : kEntries, bytes = (long long)E * C * row_bytes;
  const long long by_ids = (N + per_block - 1) / per_block;
  const long long by_bytes = std::min((long long)sms, std::max(1LL, (bytes + kBlockBytes - 1) / kBlockBytes));
  const int grid = (int)std::max(by_ids, by_bytes);
  dispatch_kernel<V><<<grid, kThreads, smem, stream>>>(static_cast<const unsigned char*>(x), N, row_bytes, ids, k, E, C,
                                                       stages, pos, static_cast<unsigned char*>(buf),
                                                       kBulk ? pool : nullptr);
  return (int)cudaGetLastError();
}

}  // namespace

// x (N, row_bytes) rows of any dtype, ids (N, k) int32 -> pos (N, k) int32,
// buf (E, C, row_bytes).  row_bytes is even (a row of bf16 or f32); 1 <= E
// <= kMaxExperts, k <= kEntries, E * C < 2^31.  pool: two int32 of the
// stream's own, zero before the first launch; each launch leaves them zero.
extern "C" int moe_dispatch_launch(const void* x, int N, int row_bytes, const int* ids, int k, int E, int C, int* pos,
                                   void* buf, int* pool, cudaStream_t stream) {
  if (E <= 0 || C <= 0) return 0;
  if (N < 0 || E > kMaxExperts || k < 0 || k > kEntries || (long long)E * C >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (aligned(x, row_bytes, 16) && aligned(buf, row_bytes, 16))
    return launch<uint4>(x, N, row_bytes, ids, k, E, C, pos, buf, pool, stream);
  if (aligned(x, row_bytes, 4) && aligned(buf, row_bytes, 4))
    return launch<uint32_t>(x, N, row_bytes, ids, k, E, C, pos, buf, pool, stream);
  return launch<uint16_t>(x, N, row_bytes, ids, k, E, C, pos, buf, pool, stream);
}

#ifdef MOE_CLOCKS
// The clock slots' cycles into out (kClockSlots), then zeroed, and the
// block stats zeroed.
extern "C" int moe_dispatch_clocks(long long* out) {
  unsigned long long host[kClockSlots] = {};
  int err = (int)cudaMemcpyFromSymbol(host, moe_dispatch_clock_slots, sizeof(host));
  for (int i = 0; i < kClockSlots; ++i) out[i] = (long long)host[i];
  const unsigned long long zero[kClockSlots] = {};
  if (err == 0) err = (int)cudaMemcpyToSymbol(moe_dispatch_clock_slots, zero, sizeof(zero));
  void* stats = nullptr;
  if (err == 0) err = (int)cudaGetSymbolAddress(&stats, moe_dispatch_block_stats);
  if (err == 0) err = (int)cudaMemset(stats, 0, sizeof(long long) * kStatBlocks * kStats);
  return err;
}

// The block stats of the last launch (kStatBlocks * kStats) into out.
extern "C" int moe_dispatch_block_stats_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, moe_dispatch_block_stats, sizeof(long long) * kStatBlocks * kStats);
}
#endif
