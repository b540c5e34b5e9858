// admission_epoch: the sharded admission controller's carried epoch, for
// sm_90a.
//
// No TPU kernel corresponds to it.  It replaces the reference's carried
// program, _admission_shard vmapped over shards by admission_epoch
// (repro/sim/device_timeline.py:1080, :1292), whose port is
// sim/device_timeline.py:admission_epoch_plain.  Each shard keeps its demand
// timeline across decision batches: sorted future event times and deltas
// with an owner code per event, the demand already folded in at the clock
// (base0), and each owner's folded sum (slot_fold).  One launch runs one
// batch for every shard, a block per shard (the reference's vmap axis is
// the grid), float64 throughout, every step in the reference's order:
//
// Precondition: each carried row tl_t is sorted ascending with a +inf tail
// (the state's invariant, which every splice keeps).
//
//   1. releases: the released codes go into a bit table; base0 loses the sum
//      of their slot_fold entries (in the order of XLA's compiled jnp.sum,
//      released_sum below, a warp a window of 32 through shuffles), their
//      slots are zeroed, and the row's surviving events are compacted left,
//      stably (ranks by ballots);
//   2. the clock fold: the events at or before t0 are the row's first
//      `folded`; base0 gains the last element of their running sum (in
//      XLA's cumsum order over the axis L, xla_scan.cuh; +0.0 when nothing
//      folds), and one warp adds them to their owners' slots in update
//      order (a ballot a 32 events, its lane 0 walking the set bits); the
//      row is then read shifted left by the folded count;
//   3. the candidates' fresh slots are zeroed;
//   4. the decisions: cs = base0 + the running sum of the decision prefix
//      (its first Lp events; XLA's order over Lp).  The reference probes two
//      families: the carried events in (start, end] at tie-group-final
//      positions, read at cs, and every candidate's start and live switch
//      instants (Q) in [start, end], read at cs0[#(pt <= Q)].  Here both are
//      one ascending probe list: the tie-group-final carried events
//      (compacted by ballots) merged with Q (each candidate's row sorted,
//      the rows merged in rounds).  A probe's read and `extra` (the
//      admitted candidates' event sums there) depend only on its instant
//      and family, and a carried event that is not tie-group-final is never
//      probed, so it is left out.  Every per-probe predicate is monotone
//      along the list (x >= start, x > start, x <= end, b < x - start,
//      tn <= x), so a pre-pass of binary searches gives each candidate its
//      window ends, k segment splits and k + 2 event splits as ints, and a
//      descriptor of every candidate as each warp's probes see it (none in
//      range, all alike, or mixed with the splits inside them).  Thread t
//      owns the list's B consecutive probes [tB, tB + B) for the batch
//      (probe j at j T + t), so `extra` is only ever touched by its owner.
//      A valid candidate is admitted unless one probe of its window has
//      (read + extra) + own > budget, summed in that order: a warp whose
//      probes are all alike tests each thread's largest windowed (read +
//      extra) once (fact 1: fl(x + v) never decreases as x grows); in a
//      mixed warp a thread with at most one cut does the same for each of
//      its one or two runs, any other probe by probe; one __syncthreads_or
//      decides, and only then is each probe's `extra` plus the candidate's
//      event sum cpre[#(tn <= x)] stored.  The commit covers the probes at
//      or after the
//      candidate's first event (before it the sum is +0.0, a no-op on
//      `extra`, which never becomes -0.0) and, when its deltas sum to +0.0,
//      before its last;
//   5. the splice, a merge by rank: the new events (a non-admitted
//      candidate's are +inf) come in ascending rows of k + 2, merged in
//      rounds in (time, index) order; an old event of the prefix goes to its
//      index plus the count of new events strictly before it, a new event
//      to the count of old events at or before it plus its rank; the events
//      past the prefix follow.  Positions past L are dropped; overflow flags
//      a finite event at L or a live one past Lp.
//
// The state is written into a second set of buffers (the caller swaps the
// two), and admits, overflow and the live count into one small int32 row a
// shard.  The working row, scans, probes and candidate tables stay in
// shared memory up to the card's opt-in limit; larger shards use a global
// scratch the wrapper allocates.  Only additions, subtractions and
// comparisons touch the values: the source builds with -fmad=false, and the
// results are bit-identical to the plain version.
//
// Bound (chip_smoke.py's _epoch_bound): at the whole card's rates, the
// larger of the bytes (the state read once and written once, the batch read
// once) and the float64 operations the batch needs: the two running sums
// and the fold, a binary search per Q probe and per spliced event, five
// operations a probe of a valid candidate's windows and two a probe of an
// admitted candidate's contribution.  The kernel runs a block per shard on
// as many SMs and is sequential in the candidates, a barrier each.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "xla_scan.cuh"

namespace {

using xla_scan::padded;
using xla_scan::prefix;
using xla_scan::ScanShape;
using xla_scan::scan_shape;

constexpr int kThreads = 512;
constexpr int kSpec = 4;  // probes a thread owns at most for the unrolled paths; past it, probe by probe
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kHeader = 256;  // counters, warp sums and the base: always in shared memory

__host__ __device__ inline size_t al16(size_t n) { return (n + 15) & ~(size_t)15; }

__host__ __device__ inline size_t take(size_t& o, size_t n) {
  const size_t at = o;
  o = al16(o + n);
  return at;
}

// Split indices a candidate keeps on the probe list: its window's ends
// (x >= start, x > start, x <= end), k segment splits and k + 2 event
// splits.
constexpr int kWin = 3;
__host__ __device__ inline int n_splits(int k) { return kWin + k + (k + 2); }

// Byte offsets of one shard's working region.
struct Layout {
  size_t bits, wt, wd, wc, scan, tot, cs, at, ar, q, pt2, rdl, exl, typl, st, en, rl, bnd, val, tn, dn, cpre, code, ok,
      adm, split, desc, mkey, mid, mid2, rank, snew, bytes;
  __host__ __device__ Layout(int L, int Lp, int Smax, int Cb, int k) {
    const size_t NQ = (size_t)Cb * (k + 1), NE = (size_t)Cb * (k + 2), NP = (size_t)Lp + NQ, D = sizeof(double);
    size_t o = 0;
    bits = take(o, ((size_t)Smax + 1 + 31) / 32 * 4);
    wt = take(o, (size_t)L * D);
    wd = take(o, (size_t)L * D);
    wc = take(o, (size_t)L * 4);
    scan = take(o, ((size_t)padded(L) + 1) * D);
    tot = take(o, (size_t)scan_shape(L).slots * D + D);
    cs = take(o, (size_t)Lp * D);
    at = take(o, (size_t)Lp * D);
    ar = take(o, (size_t)Lp * D);
    q = take(o, NQ * D);
    pt2 = take(o, NP * D);
    const size_t slots = NP + kThreads > (size_t)kSpec * kThreads ? NP + kThreads : (size_t)kSpec * kThreads;
    rdl = take(o, slots * D);
    exl = take(o, slots * D);
    typl = take(o, slots);
    st = take(o, (size_t)Cb * D);
    en = take(o, (size_t)Cb * D);
    rl = take(o, (size_t)Cb * D);
    bnd = take(o, (size_t)Cb * k * D);
    val = take(o, (size_t)Cb * k * D);
    tn = take(o, NE * D);
    dn = take(o, NE * D);
    cpre = take(o, (size_t)Cb * (k + 3) * D);
    code = take(o, (size_t)Cb * 4);
    ok = take(o, (size_t)Cb);
    adm = take(o, (size_t)Cb);
    split = take(o, (size_t)Cb * n_splits(k) * 4);
    desc = take(o, (size_t)Cb * (kThreads / 32) * 3 * 4);
    mkey = take(o, NE * D);
    mid = take(o, NE * 4);
    mid2 = take(o, NE * 4);
    rank = take(o, NE * 4);
    snew = take(o, NE * D);
    bytes = o;
  }
};

struct Args {
  const double* base0;
  const double* tl_t;
  const double* tl_d;
  const int* tl_c;
  const double* slot_fold;
  const int* rel_codes;
  const double* starts;
  const double* ends;
  const double* rels;
  const double* bnd;
  const double* val;
  const int* codes;
  const unsigned char* valid;
  int L, Lp, Smax, Rb, Cb, k;
  double t0, budget;
  double* base0_o;
  double* tl_t_o;
  double* tl_d_o;
  int* tl_c_o;
  double* slot_fold_o;
  int* res;  // (S, Cb + 2): admits, overflow, n_live
  unsigned char* scratch;
  size_t scratch_row;
};

__device__ __forceinline__ double pos_inf() { return __longlong_as_double(0x7ff0000000000000LL); }

// The sum of the released codes' folded sums in the order of the
// reference's compiled jnp.sum over Rb (sim/device_timeline.py:_row_sum):
// in index order from 0.0 up to 16 terms; at 32, four vectors of four
// lanes (term i in lane i % 4 of vector (i / 4) % 4, lane 0 of vector 0
// starting from 0.0), the vectors summed ((V1 + V0) + V2) + V3 and the lanes
// (R0 + R2) + (R1 + R3); past 32, windows of 32 each summed in order, then
// the window totals in order.  Block-collective: a warp a window, its terms
// loaded at once and folded through shuffles; `wins` holds a double a
// window (cap of them; past that warp 0 folds the windows one after
// another); the result is thread 0's.  Barriers inside.
__device__ double released_sum(const int* rel, const double* sf, int n, double* wins, int cap) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  auto x = [&](int j) { return j < n && rel[j] >= 0 ? sf[rel[j]] : 0.0; };
  double total = 0.0;
  if (n > 32 && (n + 31) / 32 > cap) {
    if (warp == 0)
      for (int w = 0; w * 32 < n; ++w) {
        const double xj = x(w * 32 + lane);
        double win = 0.0;
        for (int j = 0; j < min(32, n - w * 32); ++j) win = win + __shfl_sync(kFull, xj, j);
        total = total + win;
      }
    return total;
  }
  if (n > 32) {
    for (int w = warp; w * 32 < n; w += nw) {
      const double xj = x(w * 32 + lane);
      double win = 0.0;
      for (int j = 0; j < min(32, n - w * 32); ++j) win = win + __shfl_sync(kFull, xj, j);
      if (lane == 0) wins[w] = win;
    }
    __syncthreads();
    if (threadIdx.x == 0)
      for (int w = 0; w * 32 < n; ++w) total = total + wins[w];
    return total;
  }
  if (warp == 0) {
    const double xi = x(lane);
    if (n == 32) {
      const double v = (lane == 0 ? 0.0 + xi : xi) + __shfl_down_sync(kFull, xi, 16);  // V[i / 4][i % 4], i < 16
      const double v4 = __shfl_down_sync(kFull, v, 4), v8 = __shfl_down_sync(kFull, v, 8),
                   v12 = __shfl_down_sync(kFull, v, 12);
      const double r = ((v4 + v) + v8) + v12;  // R[l], l < 4
      const double r1 = __shfl_down_sync(kFull, r, 1), r2 = __shfl_down_sync(kFull, r, 2),
                   r3 = __shfl_down_sync(kFull, r, 3);
      total = (r + r2) + (r1 + r3);
    } else {
      for (int j = 0; j < n; ++j) total = total + __shfl_sync(kFull, xi, j);
    }
  }
  return total;
}

// Block-collective exclusive ranks of the true flags of [0, n): calls
// fn(i, rank) for each true flag(i), and returns the count.  Barriers
// inside; every thread must call it.
template <typename Flag, typename Fn>
__device__ int block_ranks(int n, int* wsum, Flag flag, Fn fn) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  int carry = 0;
  for (int c = 0; c < n; c += blockDim.x) {
    const int i = c + tid;
    const bool f = i < n && flag(i);
    const unsigned m = __ballot_sync(kFull, f);
    if (lane == 0) wsum[warp] = __popc(m);
    __syncthreads();
    int before = carry, total = carry;
    for (int w = 0; w < nw; ++w) {
      if (w < warp) before += wsum[w];
      total += wsum[w];
    }
    if (f) fn(i, before + __popc(m & ((1u << lane) - 1u)));
    __syncthreads();
    carry = total;
  }
  return carry;
}

// #(x[0..n) <= v) on an ascending x (strict: #(x < v)).
template <bool kStrict>
__device__ __forceinline__ int count_sorted(const double* x, int n, double v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (kStrict ? x[mid] < v : x[mid] <= v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The length of the leading run of [0, n) on which pred(x(i)) holds; pred
// holds on a prefix of the ascending sequence x.
template <typename X, typename Pred>
__device__ __forceinline__ int lead(int n, X x, Pred pred) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (pred(x(mid)))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Block-collective stable merge sort of key[0..n) made of ascending runs of
// `run` (the last may be shorter), carrying ids when given: rounds of
// pairwise merges, each element placed by one binary search in its partner
// run (ties: the left run first, so (key, index) order).  (ka, ia) hold the
// input, (kb, ib) are the spare buffers; returns 1 when the sorted result
// ends in (kb, ib), 0 when in (ka, ia).  Expects a barrier before; ends
// with one.
__device__ int merge_runs(double* ka, int* ia, double* kb, int* ib, int n, int run) {
  int parity = 0;
  for (int w = run; w < n; w *= 2) {
    const double* src = parity ? kb : ka;
    double* dst = parity ? ka : kb;
    const int* isrc = parity ? ib : ia;
    int* idst = parity ? ia : ib;
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      const int base = p / (2 * w) * (2 * w), mid = min(base + w, n), end = min(base + 2 * w, n);
      const double x = src[p];
      const int pos = p < mid ? p + count_sorted<true>(src + mid, end - mid, x)
                              : base + (p - mid) + count_sorted<false>(src + base, mid - base, x);
      dst[pos] = x;
      if (ia) idst[pos] = isrc[p];
    }
    __syncthreads();
    parity ^= 1;
  }
  return parity;
}

// A thread's view of one sorted list of splits x[0..n): `at` splits at or
// before its first probe b0, and, one byte a probe for its B <= 8 probes
// b0 + j, the count of splits in (b0, b0 + j] (summed up the bytes by a
// multiply).  One pass, every load issued at once.
struct Lanes {
  int at;
  unsigned long long w;
  __device__ __forceinline__ int operator()(int j) const { return (int)((w >> (8 * j)) & 0xff); }
};

__device__ __forceinline__ void add_lane(int d, int B, int& at, unsigned long long& w) {
  at += d <= 0;
  w += (unsigned)(d - 1) < (unsigned)(B - 1) ? 1ull << (8 * (d & 7)) : 0ull;
}

// A thread's Lanes over every split of x[0..n).
__device__ __forceinline__ Lanes lanes(const int* x, int n, int b0, int B) {
  int at = 0;
  unsigned long long w = 0;
#pragma unroll 4
  for (int q = 0; q < n; ++q) add_lane(x[q] - b0, B, at, w);
  return Lanes{at, w * 0x0101010101010101ull};
}

// A warp's view of a sorted list of splits x[0..n) over its probes [w0,
// w1): the count at or before w0, and the splits inside (w0, w1), packed as
// up to two 15-bit offsets from w0 and their count in bits 30-31 (3: more
// than two).
__device__ __forceinline__ unsigned warp_list(const int* x, int n, int w0, int w1, int* at) {
  int c = 0, m = 0;
  unsigned list = 0;
  for (int q = 0; q < n; ++q) {
    const int xq = x[q];
    c += xq <= w0;
    if (xq > w0 && xq < w1) {
      if (m < 2) list |= (unsigned)(xq - w0) << (15 * m);
      ++m;
    }
  }
  *at = c;
  return list | (unsigned)(m < 3 ? m : 3) << 30;
}

// A thread's Lanes from its warp's count and list (every split when the
// list overflowed).
__device__ __forceinline__ Lanes lanes(unsigned list, int at_w, int w0, const int* x, int n, int b0, int B) {
  if ((list >> 30) == 3) return lanes(x, n, b0, B);
  int at = at_w;
  unsigned long long w = 0;
#pragma unroll
  for (int e = 0; e < 2; ++e)
    if (e < (int)(list >> 30)) add_lane(w0 + (int)((list >> (15 * e)) & 0x7fffu) - b0, B, at, w);
  return Lanes{at, w * 0x0101010101010101ull};
}

// One shard's epoch.  `region` is the working region: shared memory past
// the header, or the shard's slice of the global scratch; each kernel below
// inlines this with its own, so shared accesses compile to shared-memory
// instructions.
__device__ __forceinline__ void epoch_block(const Args& a, unsigned char* smem_raw, unsigned char* region) {
  const int s = blockIdx.x, tid = threadIdx.x, T = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int L = a.L, Lp = a.Lp, Smax = a.Smax, Cb = a.Cb, k = a.k;
  const int NQ = Cb * (k + 1), NE = Cb * (k + 2), K2 = k + 2;
  int* cnt = reinterpret_cast<int*>(smem_raw);  // [0] folded, [1] nfin_head, [2] n_live
  int* wsum = cnt + 16;
  double* hbase = reinterpret_cast<double*>(smem_raw + 192);
  const Layout lay(L, Lp, Smax, Cb, k);
  unsigned* bits = reinterpret_cast<unsigned*>(region + lay.bits);
  double* wt = reinterpret_cast<double*>(region + lay.wt);
  double* wd = reinterpret_cast<double*>(region + lay.wd);
  int* wc = reinterpret_cast<int*>(region + lay.wc);
  double* scan = reinterpret_cast<double*>(region + lay.scan);
  double* tot = reinterpret_cast<double*>(region + lay.tot);
  double* cs = reinterpret_cast<double*>(region + lay.cs);
  double* at = reinterpret_cast<double*>(region + lay.at);
  double* ar = reinterpret_cast<double*>(region + lay.ar);
  double* Q = reinterpret_cast<double*>(region + lay.q);
  double* pt2 = reinterpret_cast<double*>(region + lay.pt2);
  double* rdl = reinterpret_cast<double*>(region + lay.rdl);
  double* exl = reinterpret_cast<double*>(region + lay.exl);
  unsigned char* typl = region + lay.typl;
  double* cst = reinterpret_cast<double*>(region + lay.st);
  double* cen = reinterpret_cast<double*>(region + lay.en);
  double* crl = reinterpret_cast<double*>(region + lay.rl);
  double* cb = reinterpret_cast<double*>(region + lay.bnd);
  double* cv = reinterpret_cast<double*>(region + lay.val);
  double* tn = reinterpret_cast<double*>(region + lay.tn);
  double* dn = reinterpret_cast<double*>(region + lay.dn);
  double* cpre = reinterpret_cast<double*>(region + lay.cpre);
  int* ccode = reinterpret_cast<int*>(region + lay.code);
  unsigned char* cok = region + lay.ok;
  unsigned char* adm = region + lay.adm;
  int* split = reinterpret_cast<int*>(region + lay.split);
  int* cdesc = reinterpret_cast<int*>(region + lay.desc);
  double* mkey = reinterpret_cast<double*>(region + lay.mkey);
  int* mid = reinterpret_cast<int*>(region + lay.mid);
  int* mid2 = reinterpret_cast<int*>(region + lay.mid2);
  int* rank = reinterpret_cast<int*>(region + lay.rank);
  double* snew = reinterpret_cast<double*>(region + lay.snew);

  const double* tin = a.tl_t + (size_t)s * L;
  const double* din = a.tl_d + (size_t)s * L;
  const int* cin = a.tl_c + (size_t)s * L;
  const double* sfin = a.slot_fold + (size_t)s * Smax;
  const int* rel = a.rel_codes + (size_t)s * a.Rb;
  double* sfo = a.slot_fold_o + (size_t)s * Smax;
  double* to = a.tl_t_o + (size_t)s * L;
  double* dout = a.tl_d_o + (size_t)s * L;
  int* co = a.tl_c_o + (size_t)s * L;
  int* res = a.res + (size_t)s * (Cb + 2);
  const double inf = pos_inf();

  // 1. releases: the code table (index Smax stands for an empty slot's -1
  // and is set when a released row is padded, as in the reference)
  const int nwords = (Smax + 1 + 31) / 32;
  for (int i = tid; i < nwords; i += T) bits[i] = 0u;
  if (tid < 16) cnt[tid] = 0;
  __syncthreads();
  for (int j = tid; j < a.Rb; j += T) {
    const int c = rel[j] >= 0 ? rel[j] : Smax;
    if (c <= Smax) atomicOr(&bits[c >> 5], 1u << (c & 31));
  }
  const double rsum = released_sum(rel, sfin, a.Rb, scan, padded(L) + 1);  // the scan buffer is free until step 2
  if (tid == 0) hbase[0] = a.base0[s] - rsum;
  __syncthreads();
  auto released = [&](int c) { return (bits[c >> 5] >> (c & 31)) & 1u; };
  for (int c = tid; c < Smax; c += T) sfo[c] = released(c) ? 0.0 : sfin[c];
  const int nkeep = block_ranks(
      L, wsum, [&](int i) { return !released(cin[i] >= 0 ? cin[i] : Smax); },
      [&](int i, int r) {
        wt[r] = tin[i];
        wd[r] = din[i];
        wc[r] = cin[i];
      });
  for (int i = nkeep + tid; i < L; i += T) {
    wt[i] = inf;
    wd[i] = 0.0;
    wc[i] = -1;
  }
  __syncthreads();

  // 2. the clock fold
  int folded = 0;
  for (int c = 0; c < L; c += T) {
    const int i = c + tid;
    const bool f = i < L && wt[i] <= a.t0;
    folded += __syncthreads_count(f);
    if (i < L) scan[padded(i)] = f ? wd[i] : 0.0;
  }
  __syncthreads();
  // the row is sorted, so the folded events are its first `folded`; with
  // none, the running sum of +0.0 deltas is +0.0 in any order
  if (folded > 0) {
    const ScanShape shL = scan_shape(L);
    xla_scan::fold_levels(scan, tot, shL);
    if (tid == 0) hbase[0] = hbase[0] + prefix(L - 1, scan, tot + shL.off[1], shL.depth > 1);
  } else if (tid == 0) {
    hbase[0] = hbase[0] + 0.0;
  }
  if (warp == 0) {  // the owners' folded sums, in update order
    for (int c = 0; c < folded; c += 32) {
      const int i = c + lane;
      const bool f = i < folded && wc[i] >= 0;
      unsigned m = __ballot_sync(kFull, f);
      if (lane == 0)
        while (m) {
          const int j = c + __ffs(m) - 1;
          m &= m - 1u;
          sfo[wc[j]] = sfo[wc[j]] + wd[j];
        }
      __syncwarp();
    }
  }
  __syncthreads();
  const double base = hbase[0];
  // the shifted row
  auto sh_t = [&](int i) { return i + folded < L ? wt[i + folded] : inf; };
  auto sh_d = [&](int i) { return i + folded < L ? wd[i + folded] : 0.0; };
  auto sh_c = [&](int i) { return i + folded < L ? wc[i + folded] : -1; };

  // 3. the candidates' fresh slots
  for (int c = tid; c < Cb; c += T)
    if (a.valid[(size_t)s * Cb + c] && a.codes[(size_t)s * Cb + c] >= 0 && a.codes[(size_t)s * Cb + c] < Smax)
      sfo[a.codes[(size_t)s * Cb + c]] = 0.0;

  // 4. the decision prefix's running demand, and the candidate tables
  for (int i = tid; i < Lp; i += T) scan[padded(i)] = sh_d(i);
  __syncthreads();
  const ScanShape shP = scan_shape(Lp);
  xla_scan::fold_levels(scan, tot, shP);
  const double* pt = wt + folded;  // the prefix's times, i < Lp (sh_t where i + folded >= L)
  for (int i = tid; i < Lp; i += T) cs[i] = base + prefix(i, scan, tot + shP.off[1], shP.depth > 1);
  for (int c = tid; c < Cb; c += T) {
    const size_t g = (size_t)s * Cb + c;
    const double st = a.starts[g], rl = a.rels[g];
    cst[c] = st;
    cen[c] = a.ends[g];
    crl[c] = rl;
    ccode[c] = a.codes[g];
    cok[c] = a.valid[g];
    const double* b = a.bnd + g * k;
    const double* v = a.val + g * k;
    double* bb = cb + (size_t)c * k;
    double* vv = cv + (size_t)c * k;
    double* t = tn + (size_t)c * K2;
    double* d = dn + (size_t)c * K2;
    double* q = Q + (size_t)c * (k + 1);
    int nlive = 0;
    t[0] = st;
    d[0] = v[0];
    q[0] = st;
    for (int j = 0; j < k; ++j) {
      bb[j] = b[j];
      vv[j] = v[j];
      const bool lv = isfinite(b[j]) && st + b[j] < rl;
      const double sw = nextafter(st + b[j], inf);
      nlive += lv;
      t[1 + j] = lv ? sw : inf;
      d[1 + j] = lv ? (j + 1 < k ? v[j + 1] - v[j] : 0.0) : 0.0;
      q[1 + j] = lv ? sw : inf;
    }
    t[k + 1] = rl;
    d[k + 1] = -(nlive < k ? v[nlive] : v[k - 1]);
    for (int i = 1; i < K2; ++i) {  // stable insertion sort by time
      const double ti = t[i], di = d[i];
      int j = i - 1;
      while (j >= 0 && t[j] > ti) {
        t[j + 1] = t[j];
        d[j + 1] = d[j];
        --j;
      }
      t[j + 1] = ti;
      d[j + 1] = di;
    }
    for (int i = 1; i <= k; ++i) {  // the candidate's probe instants, ascending: a run of the merge below
      const double qi = q[i];
      int j = i - 1;
      while (j >= 0 && q[j] > qi) {
        q[j + 1] = q[j];
        --j;
      }
      q[j + 1] = qi;
    }
    double* cp = cpre + (size_t)c * (k + 3);
    double acc = 0.0;
    cp[0] = acc;
    for (int j = 0; j < K2; ++j) {
      acc = acc + d[j];
      cp[j + 1] = acc;
    }
  }
  const int live_p = min(Lp, L - folded);  // prefix slots that hold the row's own entries
  auto ptime = [&](int i) { return i < live_p ? pt[i] : inf; };
  __syncthreads();
  // The probe list, one ascending sequence of two kinds: the carried events
  // at tie-group-final positions of the prefix, read at cs (probed on
  // (start, end]), and every candidate's start and switch instants (Q, each
  // candidate's row already ascending, merged), read at cs0[#(pt <= Q)]
  // (probed on [start, end]).  A probe's read and `extra` depend only on its
  // instant and kind, so equal instants may sit in any order; a carried
  // event that is not tie-group-final is never probed and is left out.
  const int NA = block_ranks(
      Lp, wsum, [&](int i) { return i + 1 < Lp ? ptime(i) != ptime(i + 1) : isfinite(ptime(i)); },
      [&](int i, int r) {
        at[r] = ptime(i);
        ar[r] = cs[i];
      });
  const double* qs = merge_runs(Q, nullptr, snew, nullptr, NQ, k + 1) ? snew : Q;  // snew is free until the splice
  const int NP = NA + NQ, B = (NP + T - 1) / T;  // thread t owns probes [tB, tB + B), probe j at j T + t
  auto place = [&](int pos, double x, double rd, unsigned char kind) {
    pt2[pos] = x;
    const int o = pos % B * T + pos / B;
    rdl[o] = rd;
    exl[o] = 0.0;
    typl[o] = kind;
  };
  for (int i = tid; i < NA; i += T) place(i + count_sorted<true>(qs, NQ, at[i]), at[i], ar[i], 0);
  for (int i = tid; i < NQ; i += T) {
    // #(pt <= Q): the finite part by binary search, every +inf slot when Q is +inf
    const double qv = qs[i];
    const int n = qv == inf ? Lp : count_sorted<false>(pt, live_p, qv);
    place(i + count_sorted<false>(at, NA, qv), qv, n == 0 ? base : cs[n - 1], 1);
  }
  __syncthreads();
  // the pre-pass: each valid candidate's window ends, segment splits and
  // event splits on the probe list, each one binary search of the exact
  // per-probe predicate (all monotone along it)
  const int NS = n_splits(k);
  auto px = [&](int i) { return pt2[i]; };
  for (int it = tid; it < Cb * NS; it += T) {
    const int c = it / NS, j = it - c * NS;
    if (!cok[c]) continue;
    const double st = cst[c];
    int r;
    if (j == 0) {  // the window of Q probes starts at x >= start
      r = lead(NP, px, [&](double x) { return !(x >= st); });
    } else if (j == 1) {  // that of carried events at x > start
      r = lead(NP, px, [&](double x) { return !(x > st); });
    } else if (j == 2) {  // both end after x <= end
      const double en = cen[c];
      r = lead(NP, px, [&](double x) { return x <= en; });
    } else if (j < kWin + k) {  // segment split: b < x - start from here on
      const double b = cb[(size_t)c * k + j - kWin];
      r = lead(NP, px, [&](double x) { return !(b < x - st); });
    } else {  // event split: tn <= x from here on (ascending with the events)
      const double e = tn[(size_t)c * K2 + j - kWin - k];
      r = lead(NP, px, [&](double x) { return !(e <= x); });
    }
    split[it] = r;
  }
  __syncthreads();
  for (int c = tid; c < Cb; c += T) {  // each candidate's segment splits ascending
    int* x = split + (size_t)c * NS + kWin;
    for (int q = 1; q < k; ++q) {
      const int y = x[q];
      int r = q - 1;
      while (r >= 0 && x[r] > y) {
        x[r + 1] = x[r];
        --r;
      }
      x[r + 1] = y;
    }
  }
  __syncthreads();
  // each candidate as each warp sees it, so that a warp none of whose
  // probes holds a split, a range end or the start's instant (most of them)
  // skips every count: d[0] 0 when no probe of the warp is in range; 1 when
  // all of them are, with none of those past the first, and (d[0] >> 2) the
  // window and commit bits and segment and event counts they share; 2
  // mixed, with the counts at its first probe, and d[1], d[2] the segment
  // and event splits inside its probes (warp_list)
  const int nw = T >> 5;
  for (int it = tid; it < Cb * nw; it += T) {
    const int c = it / nw, w0 = (it - c * nw) * 32 * B, w1 = w0 + 32 * B;
    const int* sp = split + (size_t)c * NS;
    int* d = cdesc + (size_t)it * 3;
    d[0] = 0;
    if (cok[c]) {
      const int wge = sp[0], wgt = sp[1], wh = sp[2], cl = sp[kWin + k];
      const int ch = cpre[(size_t)c * (k + 3) + K2] != 0.0 ? NP : sp[kWin + k + K2 - 1];
      if (w1 > min(wge, cl) && w0 < max(wh, ch)) {
        auto in = [&](int x) { return x > w0 && x < w1; };
        int idx, m;
        const unsigned ls = warp_list(sp + kWin, k, w0, w1, &idx), le = warp_list(sp + kWin + k, K2, w0, w1, &m);
        const bool ends = in(wge) || in(wgt) || in(wh) || in(cl) || in(ch) || (w0 >= wge && w0 < wgt);
        d[0] = B <= kSpec && !ends && (ls | le) >> 30 == 0 && w0 >= min(wge, cl) && w1 <= max(wh, ch)
                   ? 1 | (w0 >= wgt && w0 < wh) << 2 | (w0 >= cl && w0 < ch) << 3 | (idx < k - 1 ? idx : k - 1) << 4 |
                         m << 10
                   : 2 | idx << 4 | m << 10;
        d[1] = ls;
        d[2] = le;
      }
    }
  }
  __syncthreads();

  // the decision loop (see 4. above): `extra` is only ever touched by its
  // owner, so one barrier a candidate decides it
  const int b0 = tid * B;
  for (int c = 0; c < Cb; ++c) {
    if (!cok[c]) {  // the same answer in every thread: no barrier
      if (tid == 0) {
        adm[c] = 0;
        res[c] = 0;
      }
      continue;
    }
    const int* sp = split + (size_t)c * NS;
    const int* seg = sp + kWin;
    const int* evs = seg + k;
    const double* v = cv + (size_t)c * k;
    const double* cp = cpre + (size_t)c * (k + 3);
    // an admitted candidate adds cpre[#(tn <= x)] at every probe: +0.0
    // before its first event and, when its deltas sum to +0.0, after its
    // last, both no-ops on `extra`
    const int wge = sp[0], wgt = sp[1], wh = sp[2];
    const int cl = evs[0], ch = cp[K2] != 0.0 ? NP : evs[K2 - 1];
    const int lo = min(wge, cl), end = max(wh, ch);
    if (end <= lo) {  // no probe in any range: admitted, nothing to add
      if (tid == 0) {
        adm[c] = 1;
        res[c] = 1;
      }
      continue;
    }
    const int i0 = max(b0, lo), i1 = min(b0 + B, end), j0 = i0 - b0, nj = i1 - i0;
    bool over = false;
    double spec[kSpec];
    const int* dw = cdesc + ((size_t)c * nw + (tid >> 5)) * 3;
    const int desc = dw[0];
    int mode = 0, d = 0;  // 1 the warp's probes all alike; 2 this thread's in two runs; 3, 4 each on its own
    bool ca = false, cb = false;
    double ccp = 0.0, ccp2 = 0.0;
    if (desc & 1) {  // the warp's probes all alike
      mode = 1;
      ccp = cp[desc >> 10];
      if (desc & 4) {
        double sum[kSpec];
#pragma unroll
        for (int j = 0; j < kSpec; ++j) sum[j] = j < B ? rdl[j * T + tid] + exl[j * T + tid] : -INFINITY;
#pragma unroll
        for (int w = 1; w < kSpec; w *= 2)
#pragma unroll
          for (int j = 0; j + w < kSpec; j += 2 * w) sum[j] = fmax(sum[j], sum[j + w]);
        over = sum[0] + v[(desc >> 4) & 63] > a.budget;
      }
    } else if (desc && nj > 0) {
      const int w0 = (tid >> 5) * 32 * B, e = b0 + B;
      const unsigned ls = (unsigned)dw[1], le = (unsigned)dw[2];
      // a warp holding a split or a range end: most of its threads hold
      // none, or one cut (all their splits and commit-range ends at one
      // probe), and test the largest windowed sum of each of their one or
      // two runs
      int idx = (desc >> 4) & 63, m = desc >> 10, cut = e;
      bool many = B > kSpec || (ls >> 30) == 3 || (le >> 30) == 3;
      auto see = [&](int x) {
        if (x > b0 && x < e) {
          many |= cut != e && x != cut;
          cut = x;
        }
      };
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int xs = w0 + (int)((ls >> (15 * q)) & 0x7fffu), xe = w0 + (int)((le >> (15 * q)) & 0x7fffu);
        if (q < (int)(ls >> 30) && !many) {
          idx += xs <= b0;
          see(xs);
        }
        if (q < (int)(le >> 30) && !many) {
          m += xe <= b0;
          see(xe);
        }
      }
      see(cl);
      see(ch);
      see(lo);
      see(end);
      if (!many) {
        int idx2 = idx, m2 = m;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          idx2 += q < (int)(ls >> 30) && w0 + (int)((ls >> (15 * q)) & 0x7fffu) == cut;
          m2 += q < (int)(le >> 30) && w0 + (int)((le >> (15 * q)) & 0x7fffu) == cut;
        }
        mode = 2;
        d = cut - b0;
        ca = b0 >= cl && b0 < ch;
        cb = cut >= cl && cut < ch;
        ccp = cp[m];
        ccp2 = cp[m2];
        double ma = -INFINITY, mb = -INFINITY;
#pragma unroll
        for (int j = 0; j < kSpec; ++j) {
          const int i = b0 + j, o = j * T + tid;
          const bool inw = j < B && i >= (typl[o] ? wge : wgt) && i < wh;
          const double sum = inw ? rdl[o] + exl[o] : -INFINITY;
          ma = fmax(ma, j < d ? sum : -INFINITY);
          mb = fmax(mb, j < d ? -INFINITY : sum);
        }
        over = ma + v[idx < k - 1 ? idx : k - 1] > a.budget || mb + v[idx2 < k - 1 ? idx2 : k - 1] > a.budget;
      } else if (B <= kSpec) {  // past one cut: each probe on its own, its split counts from the lanes
        mode = 3;
        const Lanes sl = lanes(ls, (desc >> 4) & 63, w0, seg, k, b0, B), el = lanes(le, desc >> 10, w0, evs, K2, b0, B);
#pragma unroll
        for (int j = 0; j < kSpec; ++j) {
          const int i = b0 + j, o = j * T + tid, si = sl.at + sl(j);
          const double ex = exl[o];
          const bool test = (rdl[o] + ex) + v[si < k - 1 ? si : k - 1] > a.budget;
          over |= test && (unsigned)(j - j0) < (unsigned)nj && i >= (typl[o] ? wge : wgt) && i < wh;
          spec[j] = ex + cp[el.at + el(j)];
        }
      } else {  // past the registers: each probe's counts one by one, the commit a second pass
        mode = 4;
        for (int j = j0; j < j0 + nj; ++j) {
          const int i = b0 + j, o = j * T + tid;
          int si = 0;
          for (int q = 0; q < k; ++q) si += seg[q] <= i;
          if (i >= (typl[o] ? wge : wgt) && i < wh) over |= (rdl[o] + exl[o]) + v[si < k - 1 ? si : k - 1] > a.budget;
        }
      }
    }
    const bool admit = !__syncthreads_or(over);
    if (tid == 0) {
      adm[c] = admit;
      res[c] = admit;
    }
    if (!admit) continue;
    const int c0 = max(i0, cl) - b0, nc = max(min(i1, ch) - b0 - c0, 0);  // this thread's probes of the commit range
    if (mode == 1) {
      if (desc & 8)
#pragma unroll
        for (int j = 0; j < kSpec; ++j)
          if (j < B) exl[j * T + tid] = exl[j * T + tid] + ccp;
    } else if (mode == 2) {
#pragma unroll
      for (int j = 0; j < kSpec; ++j)
        if (j < B && (j < d ? ca : cb)) exl[j * T + tid] = exl[j * T + tid] + (j < d ? ccp : ccp2);
    } else if (mode == 3) {
#pragma unroll
      for (int j = 0; j < kSpec; ++j)
        if ((unsigned)(j - c0) < (unsigned)nc) exl[j * T + tid] = spec[j];
    } else if (mode == 4) {
      for (int j = c0; j < c0 + nc; ++j) {
        int sm = 0;
        for (int q = 0; q < K2; ++q) sm += evs[q] <= b0 + j;
        exl[j * T + tid] = exl[j * T + tid] + cp[sm];
      }
    }
  }
  __syncthreads();

  // 5. the splice: the new events (a non-admitted candidate's at +inf), each
  // candidate's row already ascending, merged in (time, index) order
  for (int f = tid; f < NE; f += T) {
    mkey[f] = adm[f / K2] ? tn[f] : inf;
    mid[f] = f;
  }
  __syncthreads();
  const int in_b = merge_runs(mkey, mid, snew, mid2, NE, K2);
  for (int p = tid; p < NE; p += T) {
    rank[(in_b ? mid2 : mid)[p]] = p;
    if (!in_b) snew[p] = mkey[p];
  }
  auto ntime = [&](int f) { return adm[f / K2] ? tn[f] : inf; };
  __syncthreads();
  int fin_head = 0, live = 0;
  for (int i = tid; i < Lp; i += T) {  // the old prefix
    const double x = ptime(i);
    const int place = i + count_sorted<true>(snew, NE, x);
    fin_head += isfinite(x);
    if (place < L) {
      to[place] = x;
      dout[place] = sh_d(i);
      co[place] = sh_c(i);
      live += isfinite(x);
    }
  }
  for (int f = tid; f < NE; f += T) {  // the new events
    const double x = ntime(f);
    const int c = f / K2;
    const int place = (x == inf ? Lp : count_sorted<false>(pt, live_p, x)) + rank[f];
    fin_head += isfinite(x);
    if (place < L) {
      to[place] = x;
      dout[place] = adm[c] ? dn[f] : 0.0;
      co[place] = adm[c] ? ccode[c] : -1;
      live += isfinite(x);
    }
  }
  for (int j = Lp + tid; j < L; j += T) {  // the row past the prefix
    const int place = NE + j;
    if (place < L) {
      to[place] = sh_t(j);
      dout[place] = sh_d(j);
      co[place] = sh_c(j);
      live += isfinite(sh_t(j));
    }
  }
  atomicAdd(&cnt[1], fin_head);
  atomicAdd(&cnt[2], live);
  __syncthreads();
  if (tid == 0) {
    const bool prefix_over = Lp < L && isfinite(sh_t(Lp));
    const bool past = L < Lp + NE ? cnt[1] > L : isfinite(sh_t(L - NE));
    res[Cb] = prefix_over || past;
    res[Cb + 1] = cnt[2];
    a.base0_o[s] = base;
  }
}

__global__ void __launch_bounds__(kThreads) epoch_kernel_shared(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  epoch_block(a, smem_raw, smem_raw + kHeader);
}

__global__ void __launch_bounds__(kThreads) epoch_kernel_global(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  epoch_block(a, smem_raw, a.scratch + (size_t)blockIdx.x * a.scratch_row);
}

struct Plan {
  size_t smem, scratch, bytes;
};

int make_plan(int L, int Lp, int Smax, int Cb, int k, Plan* pl) {
  if (L < 1 || Lp < 1 || Lp > L || Smax < 1 || Cb < 1 || k < 1 || k > 61 || xla_scan::too_long(L))
    return cudaErrorInvalidValue;  // k > 61: the counts pack in 6 bits
  pl->bytes = Layout(L, Lp, Smax, Cb, k).bytes;
  const size_t optin = (size_t)xla_scan::optin_limit();
  if (kHeader + pl->bytes <= optin) {
    pl->smem = kHeader + pl->bytes;
    pl->scratch = 0;
  } else {
    pl->smem = kHeader;
    pl->scratch = pl->bytes;
  }
  return cudaSuccess;
}

bool g_shared_set[2] = {false, false};  // the opt-in limit set, per tier

}  // namespace

// The launch plan of one epoch: out[0] threads a block, out[1] dynamic
// shared memory bytes, out[2] global scratch bytes a shard (0: none).
// Returns a CUDA error code.
extern "C" int admission_epoch_plan(int L, int Lp, int Smax, int Cb, int k, long long* out) {
  Plan pl;
  const int e = make_plan(L, Lp, Smax, Cb, k, &pl);
  if (e != cudaSuccess) return e;
  out[0] = kThreads;
  out[1] = (long long)pl.smem;
  out[2] = (long long)pl.scratch;
  return cudaSuccess;
}

// One launch runs the epoch of S shards: state (base0 (S,), tl_t, tl_d (S,
// L) f64, tl_c (S, L) int32, slot_fold (S, Smax) f64), batch (rel_codes (S,
// Rb) int32, starts, ends, rels (S, Cb) f64, bnd, val (S, Cb, k) f64, codes
// (S, Cb) int32, valid (S, Cb) bytes), the new state into the *_o buffers
// and res (S, Cb + 2) int32; scratch: S x the plan's out[2] bytes, or null.
// Returns a CUDA error code.
extern "C" int admission_epoch_launch(const double* base0, const double* tl_t, const double* tl_d, const int* tl_c,
                                      const double* slot_fold, const int* rel_codes, const double* starts,
                                      const double* ends, const double* rels, const double* bnd, const double* val,
                                      const int* codes, const unsigned char* valid, int S, int L, int Lp, int Smax,
                                      int Rb, int Cb, int k, double t0, double budget, double* base0_o,
                                      double* tl_t_o, double* tl_d_o, int* tl_c_o, double* slot_fold_o, int* res,
                                      unsigned char* scratch, void* stream) {
  if (S <= 0) return cudaSuccess;
  if (Rb < 1) return cudaErrorInvalidValue;
  Plan pl;
  const int e = make_plan(L, Lp, Smax, Cb, k, &pl);
  if (e != cudaSuccess) return e;
  if (pl.scratch > 0 && scratch == nullptr) return cudaErrorInvalidValue;
  const int err = pl.scratch ? xla_scan::allow_shared(epoch_kernel_global, g_shared_set[0])
                             : xla_scan::allow_shared(epoch_kernel_shared, g_shared_set[1]);
  if (err != 0) return err;
  const Args a{base0, tl_t, tl_d, tl_c, slot_fold, rel_codes, starts, ends, rels, bnd, val, codes, valid, L, Lp,
               Smax, Rb, Cb, k, t0, budget, base0_o, tl_t_o, tl_d_o, tl_c_o, slot_fold_o, res, scratch, pl.scratch};
  if (pl.scratch)
    epoch_kernel_global<<<S, kThreads, pl.smem, static_cast<cudaStream_t>(stream)>>>(a);
  else
    epoch_kernel_shared<<<S, kThreads, pl.smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
