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
//   1. releases: the released codes go into a bit table; base0 loses the sum
//      of their slot_fold entries (in the order of XLA's compiled jnp.sum,
//      row_sum below), their slots are zeroed, and the row's surviving
//      events are compacted left, stably (ranks by ballots);
//   2. the clock fold: base0 gains the last element of the running sum (in
//      XLA's cumsum order over the whole axis L, xla_scan.cuh) of the deltas
//      at or before t0; one warp adds those deltas to their owners' slots in
//      update order (a ballot a 32 events, its lane 0 walking the set bits);
//      the row is then read shifted left by the folded count;
//   3. the candidates' fresh slots are zeroed;
//   4. the decisions: cs = base0 + the running sum of the decision prefix
//      (its first Lp events; XLA's order over Lp).  Two probe families, as
//      in the reference: the carried events in (start, end] at
//      tie-group-final positions, read at cs; and every candidate's start
//      and live switch instants (Q) in [start, end], read at cs0[#(pt <= Q)].
//      Threads own the probes of both families; each probe carries `extra`,
//      the admitted candidates' event sums there.  A valid candidate is
//      admitted unless one probe of its windows has (read + extra) + own >
//      budget; one __syncthreads_or decides it.  An admitted candidate adds
//      to every probe the sum (from 0.0, in its sorted event order) of its
//      event deltas at or before the probe, release delta included: a
//      prefix sum of its k + 2 events, built once per candidate;
//   5. the splice, a merge by rank: an old event of the prefix goes to its
//      index plus the count of new events strictly before it; a new event
//      (a non-admitted candidate's are +inf) to the count of old events at
//      or before it plus its stable rank among the new ones (time, then
//      index); the events past the prefix follow.  Positions past L are
//      dropped; overflow flags a finite event at L or a live one past Lp.
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
#include <math.h>

#include "xla_scan.cuh"

namespace {

using xla_scan::padded;
using xla_scan::prefix;
using xla_scan::ScanShape;
using xla_scan::scan_shape;

constexpr int kThreads = 512;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kHeader = 256;  // counters, warp sums and the base: always in shared memory

__host__ __device__ inline size_t al16(size_t n) { return (n + 15) & ~(size_t)15; }

__host__ __device__ inline size_t take(size_t& o, size_t n) {
  const size_t at = o;
  o = al16(o + n);
  return at;
}

// Byte offsets of one shard's working region.
struct Layout {
  size_t bits, wt, wd, wc, scan, tot, cs, ex1, q, qprof, ex2, st, en, rl, bnd, val, tn, dn, cpre, code, ok, adm, rank,
      snew, bytes;
  __host__ __device__ Layout(int L, int Lp, int Smax, int Cb, int k) {
    const size_t NQ = (size_t)Cb * (k + 1), NE = (size_t)Cb * (k + 2), D = sizeof(double);
    size_t o = 0;
    bits = take(o, ((size_t)Smax + 1 + 31) / 32 * 4);
    wt = take(o, (size_t)L * D);
    wd = take(o, (size_t)L * D);
    wc = take(o, (size_t)L * 4);
    scan = take(o, ((size_t)padded(L) + 1) * D);
    tot = take(o, (size_t)scan_shape(L).slots * D + D);
    cs = take(o, (size_t)Lp * D);
    ex1 = take(o, (size_t)Lp * D);
    q = take(o, NQ * D);
    qprof = take(o, NQ * D);
    ex2 = take(o, NQ * D);
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
// the window totals in order.
__device__ double released_sum(const int* rel, const double* sf, int n) {
  auto x = [&](int j) { return rel[j] >= 0 ? sf[rel[j]] : 0.0; };
  if (n == 32) {
    double v[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = (i == 0 ? 0.0 + x(0) : x(i)) + x(16 + i);
    double r[4];
#pragma unroll
    for (int l = 0; l < 4; ++l) r[l] = ((v[4 + l] + v[l]) + v[8 + l]) + v[12 + l];
    return (r[0] + r[2]) + (r[1] + r[3]);
  }
  if (n > 32) {
    double acc = 0.0;
    for (int w = 0; w < n; w += 32) {
      double win = 0.0;
      for (int j = w; j < min(n, w + 32); ++j) win = win + x(j);
      acc = acc + win;
    }
    return acc;
  }
  double acc = 0.0;
  for (int j = 0; j < n; ++j) acc = acc + x(j);
  return acc;
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

// The candidate's own allocation at p: val[min(#(b < p - start), k - 1)].
__device__ __forceinline__ double own(double p, double st, const double* b, const double* v, int k) {
  const double offs = p - st;
  int idx = 0;
  for (int j = 0; j < k; ++j) idx += b[j] < offs;
  return v[idx < k - 1 ? idx : k - 1];
}

// An admitted candidate's event sum at p: the prefix of its sorted events
// at or before p.
__device__ __forceinline__ double contrib(double p, const double* tn, const double* cpre, int ne) {
  int m = 0;
  for (int j = 0; j < ne; ++j) m += tn[j] <= p;
  return cpre[m];
}

__global__ void __launch_bounds__(kThreads) epoch_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int s = blockIdx.x, tid = threadIdx.x, T = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int L = a.L, Lp = a.Lp, Smax = a.Smax, Cb = a.Cb, k = a.k;
  const int NQ = Cb * (k + 1), NE = Cb * (k + 2), K2 = k + 2;
  int* cnt = reinterpret_cast<int*>(smem_raw);  // [0] folded, [1] nfin_head, [2] n_live
  int* wsum = cnt + 16;
  double* hbase = reinterpret_cast<double*>(smem_raw + 192);
  unsigned char* region = a.scratch ? a.scratch + (size_t)s * a.scratch_row : smem_raw + kHeader;
  const Layout lay(L, Lp, Smax, Cb, k);
  unsigned* bits = reinterpret_cast<unsigned*>(region + lay.bits);
  double* wt = reinterpret_cast<double*>(region + lay.wt);
  double* wd = reinterpret_cast<double*>(region + lay.wd);
  int* wc = reinterpret_cast<int*>(region + lay.wc);
  double* scan = reinterpret_cast<double*>(region + lay.scan);
  double* tot = reinterpret_cast<double*>(region + lay.tot);
  double* cs = reinterpret_cast<double*>(region + lay.cs);
  double* ex1 = reinterpret_cast<double*>(region + lay.ex1);
  double* Q = reinterpret_cast<double*>(region + lay.q);
  double* qprof = reinterpret_cast<double*>(region + lay.qprof);
  double* ex2 = reinterpret_cast<double*>(region + lay.ex2);
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
  if (tid == 0) hbase[0] = a.base0[s] - released_sum(rel, sfin, a.Rb);
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
  const ScanShape shL = scan_shape(L);
  xla_scan::fold_levels(scan, tot, shL);
  if (tid == 0) hbase[0] = hbase[0] + prefix(L - 1, scan, tot + shL.off[1], shL.depth > 1);
  if (warp == 0) {  // the owners' folded sums, in update order
    for (int c = 0; c < L; c += 32) {
      const int i = c + lane;
      const bool f = i < L && wt[i] <= a.t0 && wc[i] >= 0;
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
  for (int i = tid; i < Lp; i += T) {
    cs[i] = base + prefix(i, scan, tot + shP.off[1], shP.depth > 1);
    ex1[i] = 0.0;
  }
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
    double* cp = cpre + (size_t)c * (k + 3);
    double acc = 0.0;
    cp[0] = acc;
    for (int j = 0; j < K2; ++j) {
      acc = acc + d[j];
      cp[j + 1] = acc;
    }
  }
  __syncthreads();
  const int live_p = min(Lp, L - folded);  // prefix slots that hold the row's own entries
  auto ptime = [&](int i) { return i < live_p ? pt[i] : inf; };
  for (int i = tid; i < NQ; i += T) {
    // #(pt <= Q): the finite part by binary search, every +inf slot when Q is +inf
    const double qv = Q[i];
    const int n = qv == inf ? Lp : count_sorted<false>(pt, live_p, qv);
    qprof[i] = n == 0 ? base : cs[n - 1];
    ex2[i] = 0.0;
  }
  __syncthreads();

  const int NP = Lp + NQ;
  for (int c = 0; c < Cb; ++c) {
    if (!cok[c]) {  // the same answer in every thread: no barrier
      if (tid == 0) {
        adm[c] = 0;
        res[c] = 0;
      }
      continue;
    }
    const double st = cst[c], en = cen[c];
    const double* b = cb + (size_t)c * k;
    const double* v = cv + (size_t)c * k;
    bool over = false;
    for (int p = tid; p < NP; p += T) {
      if (p < Lp) {
        const double x = ptime(p);
        const bool tie = p + 1 < Lp ? x != ptime(p + 1) : isfinite(x);
        if (tie && x > st && x <= en) over |= (cs[p] + ex1[p]) + own(x, st, b, v, k) > a.budget;
      } else {
        const double x = Q[p - Lp];
        if (x >= st && x <= en) over |= (qprof[p - Lp] + ex2[p - Lp]) + own(x, st, b, v, k) > a.budget;
      }
    }
    const bool admit = !__syncthreads_or(over);
    if (tid == 0) {
      adm[c] = admit;
      res[c] = admit;
    }
    if (!admit) continue;
    const double* t = tn + (size_t)c * K2;
    const double* cp = cpre + (size_t)c * (k + 3);
    for (int p = tid; p < NP; p += T) {
      if (p < Lp)
        ex1[p] = ex1[p] + contrib(ptime(p), t, cp, K2);
      else
        ex2[p - Lp] = ex2[p - Lp] + contrib(Q[p - Lp], t, cp, K2);
    }
  }
  __syncthreads();

  // 5. the splice: ranks of the new events among themselves (time, index)
  auto ntime = [&](int f) { return adm[f / K2] ? tn[f] : inf; };
  for (int f = tid; f < NE; f += T) {
    const double x = ntime(f);
    int r = 0;
    for (int g = 0; g < NE; ++g) {
      const double y = ntime(g);
      r += y < x || (y == x && g < f);
    }
    rank[f] = r;
    snew[r] = x;
  }
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

struct Plan {
  size_t smem, scratch, bytes;
};

int make_plan(int L, int Lp, int Smax, int Cb, int k, Plan* pl) {
  if (L < 1 || Lp < 1 || Lp > L || Smax < 1 || Cb < 1 || k < 1 || xla_scan::too_long(L)) return cudaErrorInvalidValue;
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

bool g_shared_set = false;

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
  const int err = xla_scan::allow_shared(epoch_kernel, g_shared_set);
  if (err != 0) return err;
  const Args a{base0, tl_t, tl_d, tl_c, slot_fold, rel_codes, starts, ends, rels, bnd, val, codes, valid, L, Lp,
               Smax, Rb, Cb, k, t0, budget, base0_o, tl_t_o, tl_d_o, tl_c_o, slot_fold_o, res, scratch, pl.scratch};
  epoch_kernel<<<S, kThreads, pl.smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
