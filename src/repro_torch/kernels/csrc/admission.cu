// admission: the batched admission controller's decision scan, for sm_90a.
//
// No TPU kernel corresponds to it.  It replaces the lax.scan of the
// reference's admission_program (repro/sim/device_timeline.py:342, the scan
// at :374), whose port is sim/device_timeline.py:admission_scan_plain: C
// candidates are decided in order, each against the active profile plus
// the demand of the candidates admitted before it in the same batch.  The
// reference materialises three (C, Pp) float64 pieces per batch (own
// allocation A, window membership M, committed demand D,
// candidate_probe_parts) and scans their rows; this kernel computes each
// candidate's pieces at the moment it is decided and keeps none of them.
//
// Precondition: the probes P are sorted ascending (nondecreasing, no NaN;
// core/timeline.shared_probe_set returns np.unique, +inf last).  The kernel
// does not check it: on unsorted probes its decisions are undefined.
//
// Two facts make each candidate's work its window's and not the probe set's:
//
// 1. Every per-probe predicate of the reference is monotone along sorted
//    probes: p >= start, p <= end, isfinite(p), p < release, and for each
//    q, bnd[q] < fl(p - start) (fl(x - start) never decreases as x grows,
//    and its NaN cases, x and start the same infinity, sit at an end where
//    the predicate is false anyway) and live[q] & sw[q] <= p.  So one binary
//    search a predicate, evaluating it exactly as the reference does, finds
//    the index where it turns, and integer compares against those split
//    indices reproduce the per-probe window bits, segment index (#(bnd <
//    p - start), clamped to k - 1) and switch count (#(live & sw <= p)) bit
//    for bit.
// 2. `extra` starts at +0.0 and only ever gains sums, so it never becomes
//    -0.0, and the reference's +0.0 outside [start, release) leaves it
//    unchanged: those probes are skipped.
//
// Design: one block owns the batch (the scan is sequential in the
// candidates).  Thread t owns the B consecutive probes [tB, tB + B) for the
// whole launch, so no thread ever reads another's `extra` and one barrier a
// candidate suffices.  Where a thread's probes keep their profile reads and
// `extra` is the plan's tier: registers (B <= 8, up to 8,192 probes), else
// prof in global memory and `extra` in a global scratch the wrapper
// allocates.  Per chunk of candidates staged in shared memory, a parallel
// pre-pass spreads the 4 + 2k binary searches of every candidate over the
// block (on the probes staged in shared memory, first chunk): the window
// [lo, hi), the commit range [lo_c, hr), the k segment splits and the k
// switch splits, each list then sorted; then, for every candidate and warp,
// a descriptor of the candidate as the warp's probes see it: none in range;
// all alike (no split or range end past the warp's first probe), with the
// window and commit bits and segment and switch counts they share; or
// mixed, with the counts at its first probe and the splits inside its
// probes.  Candidate by candidate, a warp whose probes are all alike tests
// the largest (prof + extra) of each thread once against val[seg] (fact 1)
// and commits extra + valext[n]; in a mixed warp a thread with at most one
// cut (all its splits and range ends at one probe) does the same for each
// of its one or two runs, and any other thread probe by probe, its counts
// one byte a probe (Lanes).  `(prof + extra) + val` is summed in the
// reference's order; one __syncthreads_or decides; the commit, computed in
// registers, is stored only if the candidate is admitted.  An invalid
// candidate, or one whose ranges hold no probe, costs no barrier.
// Decisions are bit-identical to the plain version.
//
// Bound (chip_smoke.py's _admission_bound): at the whole card's rates, the
// larger of the bytes (each input read once, the decisions written once)
// and the operations the batch needs, counted on the sorted probes: three
// binary searches a valid candidate for its windows, five operations a
// probe in its [start, end] window and two a probe of an admitted
// candidate's [start, release).  The kernel runs on one SM: a barrier and
// one pass of loop latency a candidate.
//
#include <cuda_runtime.h>

#include <limits.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kRegsPerThread = 8;       // the register tier: up to 8 probes a thread, up to 1,024 threads

// Where each thread's probes keep their profile reads and `extra`: kRegs in
// registers (R <= 8 probes a thread, up to 8,192 probes); kGlobal: prof in
// global memory, `extra` in a global scratch, a probe at a time.
enum Tier { kGlobal = 0, kRegs = 1 };
constexpr int kStageBytes = 128 * 1024;  // shared memory for staged candidates
constexpr int kFixed = 4;               // lo_c, lo, hi, hr

struct Args {
  const double* P;
  const double* prof;
  int Pp;
  const double* starts;
  const double* ends;
  const double* rels;
  const double* bnd;
  const double* val;
  const double* valext;
  const double* sw;
  const unsigned char* live;
  const unsigned char* valid;
  int C;
  int k;
  double budget;
  unsigned char* admits;
  double* scratch;  // `extra` in global memory, or null
};

struct Plan {
  int tier;         // a Tier
  int threads;
  int per;          // probes a thread owns
  int chunk;        // candidates staged at a time
  size_t stage;     // bytes of the stage
  size_t smem;      // dynamic shared memory of the launch
  size_t scratch;   // bytes of global scratch the launch needs
};

constexpr int kDesc = 3;  // ints a candidate keeps for each warp: see the pre-pass

// Bytes of one staged candidate: k values, k + 1 hold-last values, start,
// end, release, k boundaries and k switch instants (doubles), 4 + 2k split
// indices and kDesc a warp of `warps` (ints), k live bits and the valid bit.
size_t cand_bytes(int k, int warps) {
  return sizeof(double) * (4 * (size_t)k + 4) + sizeof(int) * (kFixed + 2 * (size_t)k + (size_t)kDesc * warps) +
         (size_t)k + 1;
}

size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

int make_plan(int Pp, int C, int k, Plan* pl) {
  if (Pp < 0 || C < 0 || k < 1 || k > 63) return cudaErrorInvalidValue;  // counts pack in 6 bits
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  // threads (a multiple of 32, at least 32) for `per` probes a thread, the
  // probes a thread then owns, and the stage for that many warps
  auto cover = [&](int per, int cap) {
    const int want = (Pp + per - 1) / per, need = want < 32 ? 32 : (want + 31) / 32 * 32;
    pl->threads = need < cap ? need : cap;
    pl->per = Pp > 0 ? (Pp + pl->threads - 1) / pl->threads : 1;
    const size_t bytes = cand_bytes(k, pl->threads / 32);
    long long chunk = (long long)(kStageBytes / bytes);
    if (chunk > C) chunk = C;
    if (chunk < 1) chunk = 1;
    pl->chunk = (int)chunk;
    pl->stage = align16((size_t)chunk * bytes);
  };
  const size_t staged = sizeof(double) * (size_t)Pp;  // the probes, staged for the first chunk's searches
  cover(kRegsPerThread, kMaxThreads);
  if (pl->stage > (size_t)optin) return cudaErrorInvalidValue;  // one candidate's k is too large
  pl->tier = kGlobal;
  pl->smem = pl->stage;
  if (pl->per <= kRegsPerThread && pl->stage + staged <= (size_t)optin) {
    pl->tier = kRegs;
    pl->smem = pl->stage + staged;
  }
  pl->scratch = pl->tier == kGlobal ? sizeof(double) * (size_t)pl->per * pl->threads : 0;
  return cudaSuccess;
}

// The length of the leading run of [0, n) on which pred(P[i]) holds; pred
// holds on a prefix of the sorted probes.
template <typename Pred>
__device__ __forceinline__ int lead(const double* P, int n, Pred pred) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (pred(P[mid]))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// A thread's view of one sorted list of splits x[0..n): `at` splits at or
// before its first probe b0, and, one byte a probe for its B <= 16 probes
// b0 + j, the count of splits in (b0, b0 + j] (two words, summed up the
// bytes by a multiply).  One pass, every load issued at once.
struct Lanes {
  int at;
  unsigned long long lo, hi;
  __device__ __forceinline__ int operator()(int j) const {
    return j < 8 ? (int)((lo >> (8 * j)) & 0xff) : (int)((hi >> (8 * (j - 8))) & 0xff);
  }
  __device__ __forceinline__ bool none() const { return (lo | hi) == 0; }
};

__device__ __forceinline__ void add_lane(int d, int B, int& at, unsigned long long& w0, unsigned long long& w1) {
  at += d <= 0;
  const unsigned long long bit = (unsigned)(d - 1) < (unsigned)(B - 1) ? 1ull << (8 * (d & 7)) : 0ull;
  w0 += d < 8 ? bit : 0ull;
  w1 += d < 8 ? 0ull : bit;
}

__device__ __forceinline__ Lanes summed(int at, unsigned long long w0, unsigned long long w1) {
  constexpr unsigned long long kBytes = 0x0101010101010101ull;
  const unsigned long long lo = w0 * kBytes;
  return Lanes{at, lo, w1 * kBytes + (lo >> 56) * kBytes};
}

// A thread's Lanes over every split of x[0..n).
__device__ __forceinline__ Lanes lanes(const int* x, int n, int b0, int B) {
  int at = 0;
  unsigned long long w0 = 0, w1 = 0;
#pragma unroll 4
  for (int q = 0; q < n; ++q) add_lane(x[q] - b0, B, at, w0, w1);
  return summed(at, w0, w1);
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
  unsigned long long v0 = 0, v1 = 0;
#pragma unroll
  for (int e = 0; e < 2; ++e)
    if (e < (int)(list >> 30)) add_lane(w0 + (int)((list >> (15 * e)) & 0x7fffu) - b0, B, at, v0, v1);
  return summed(at, v0, v1);
}

template <int R, int kTier>
__global__ void __launch_bounds__(kMaxThreads) decide_kernel(Args a, int chunk, int B) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int RR = R > 0 ? R : 1;
  const int k = a.k, T = blockDim.x, t = threadIdx.x, Pp = a.Pp, nsplit = kFixed + 2 * k;
  const int Bk = kTier != kGlobal ? R : B;  // this thread's probes, exactly R but on the global tier
  double* s_val = reinterpret_cast<double*>(smem_raw);
  double* s_vx = s_val + (size_t)chunk * k;
  double* s_st = s_vx + (size_t)chunk * (k + 1);
  double* s_en = s_st + chunk;
  double* s_rl = s_en + chunk;
  double* s_bnd = s_rl + chunk;
  double* s_sw = s_bnd + (size_t)chunk * k;
  int* s_split = reinterpret_cast<int*>(s_sw + (size_t)chunk * k);
  const int nw = T >> 5;
  int* s_desc = s_split + (size_t)chunk * nsplit;  // a candidate's view from each warp, below
  unsigned char* s_live = reinterpret_cast<unsigned char*>(s_desc + (size_t)chunk * kDesc * nw);
  unsigned char* s_valid = s_live + (size_t)chunk * k;
  const size_t stage = (size_t)(s_valid + chunk - smem_raw + 15) & ~(size_t)15;
  // past the stage (kRegs): the probes while the first chunk searches them
  double* s_probe = reinterpret_cast<double*>(smem_raw + stage);
  double* ext = a.scratch;  // kGlobal: probe j of thread t at j T + t
  const int b0 = t * Bk;
  double pv[RR], ev[RR];  // kRegs: this thread's profile reads and `extra`
#pragma unroll
  for (int j = 0; j < RR; ++j) {
    pv[j] = kTier == kRegs && b0 + j < Pp ? a.prof[b0 + j] : 0.0;
    ev[j] = 0.0;
  }
  if constexpr (kTier == kGlobal)
    for (int j = 0; j < B; ++j) ext[j * T + t] = 0.0;

  for (int c0 = 0; c0 < a.C; c0 += chunk) {
    const int n = min(chunk, a.C - c0);
    __syncthreads();  // the previous chunk's last candidate is read by all
    for (int i = t; i < n; i += T) {  // the chunk's candidates, every load issued at once
      s_valid[i] = a.valid[c0 + i];
      s_st[i] = a.starts[c0 + i];
      s_en[i] = a.ends[c0 + i];
      s_rl[i] = a.rels[c0 + i];
    }
    for (int i = t; i < n * k; i += T) {
      const size_t g = (size_t)c0 * k + i;
      s_val[i] = a.val[g];
      s_bnd[i] = a.bnd[g];
      s_sw[i] = a.sw[g];
      s_live[i] = a.live[g];
    }
    for (int i = t; i < n * (k + 1); i += T) s_vx[i] = a.valext[(size_t)c0 * (k + 1) + i];
    // the first chunk searches the probes staged in shared memory
    const bool staged = kTier != kGlobal && c0 == 0;
    if (staged)
      for (int i = t; i < Pp; i += T) s_probe[i] = a.P[i];
    __syncthreads();
    const double* P = staged ? s_probe : a.P;
    // the pre-pass: every split of every valid candidate of the chunk
    for (int it = t; it < n * nsplit; it += T) {
      const int c = it / nsplit, j = it - c * nsplit;
      if (!s_valid[c]) continue;
      const double st = s_st[c];
      int r;
      if (j == 0) {  // lo_c: the commit range starts at p >= start
        r = lead(P, Pp, [&](double p) { return !(p >= st); });
      } else if (j == 1) {  // lo: the window starts at p >= start and finite
        r = lead(P, Pp, [&](double p) { return !(p >= st && p > -INFINITY); });
      } else if (j == 2) {  // hi: the window ends after p <= end and finite
        const double en = s_en[c];
        r = lead(P, Pp, [&](double p) { return p <= en && p < INFINITY; });
      } else if (j == 3) {  // hr: the commit range ends at p >= release
        const double rl = s_rl[c];
        r = lead(P, Pp, [&](double p) { return p < rl; });
      } else if (j < kFixed + k) {  // segment split q: bnd[q] < p - start from here on
        const double b = s_bnd[(size_t)c * k + (j - kFixed)];
        r = lead(P, Pp, [&](double p) { return !(b < p - st); });
      } else {  // switch split q: live and sw[q] <= p from here on (never: Pp)
        const size_t q = (size_t)c * k + (j - kFixed - k);
        const double sv = s_sw[q];
        r = s_live[q] ? lead(P, Pp, [&](double p) { return !(sv <= p); }) : Pp;
      }
      s_split[it] = r;
    }
    __syncthreads();
    for (int i = t; i < 2 * n; i += T) {  // each list of splits ascending
      int* x = s_split + (size_t)(i >> 1) * nsplit + kFixed + (i & 1) * k;
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
    // probes holds a split or a range end (most of them) skips every count:
    // d[0] 0 when no probe of the warp is in [lo_c, max(hi, hr)); 1 when all
    // of them are, with no split or range end past the first, and (d[0] >>
    // 2) the window and commit bits and segment and switch counts they
    // share; 2 mixed, with the counts at its first probe, and d[1], d[2] the
    // segment and switch splits inside its probes (warp_list)
    const int W = 32 * Bk;
    for (int it = t; kTier != kGlobal && it < n * nw; it += T) {
      const int c = it / nw, w0 = (it - c * nw) * W, w1 = w0 + W;
      const int* sp = s_split + (size_t)c * nsplit;
      const int lo_c = sp[0], lo = sp[1], hi = sp[2], hr = sp[3], end = max(hi, hr);
      int* d = s_desc + (size_t)it * kDesc;
      d[0] = 0;
      if (w1 > lo_c && w0 < end) {
        int idx, m;
        const unsigned ls = warp_list(sp + kFixed, k, w0, w1, &idx), lw = warp_list(sp + kFixed + k, k, w0, w1, &m);
        const bool ends = (lo > w0 && lo < w1) || (hi > w0 && hi < w1) || (hr > w0 && hr < w1);
        d[0] = !ends && (ls | lw) >> 30 == 0 && w0 >= lo_c && w1 <= end
                   ? 1 | (w0 >= lo && w0 < hi) << 2 | (w0 < hr) << 3 | (idx < k - 1 ? idx : k - 1) << 4 | m << 10
                   : 2 | idx << 4 | m << 10;
        d[1] = ls;
        d[2] = lw;
      }
    }
    __syncthreads();

    for (int c = 0; c < n; ++c) {
      if (!s_valid[c]) {  // the same answer in every thread: no barrier
        if (t == 0) a.admits[c0 + c] = 0;
        continue;
      }
      const int* sp = s_split + (size_t)c * nsplit;
      const int lo_c = sp[0], lo = sp[1], hi = sp[2], hr = sp[3];
      const int end = max(hi, hr);
      if (end <= lo_c) {  // no probe in either range: admitted, nothing to add
        if (t == 0) a.admits[c0 + c] = 1;
        continue;
      }
      const int* seg = sp + kFixed;
      const int* swi = seg + k;
      const double* v = s_val + (size_t)c * k;
      const double* vx = s_vx + (size_t)c * (k + 1);
      const int i0 = max(b0, lo_c), i1 = min(b0 + Bk, end), j0 = i0 - b0, nj = i1 - i0;
      bool over = false, ca = false, cb = false;
      int mode = 0, d = 0;  // 1 the warp's probes all alike; 2 this thread's in two runs; 3 each on its own
      Lanes wl{};
      double cvx = 0.0, cvx2 = 0.0;
      const int* dw = s_desc + ((size_t)c * nw + (t >> 5)) * kDesc;
      const int desc = kTier != kGlobal ? dw[0] : 2;
      if (desc & 1) {  // the warp's probes all alike
        mode = 1;
        cvx = vx[desc >> 10];
        if (desc & 4) {
          double sum[RR];
#pragma unroll
          for (int j = 0; j < RR; ++j) sum[j] = pv[j] + ev[j];
#pragma unroll
          for (int w = 1; w < RR; w *= 2)
#pragma unroll
            for (int j = 0; j + w < RR; j += 2 * w) sum[j] = fmax(sum[j], sum[j + w]);
          over = sum[0] + v[(desc >> 4) & 63] > a.budget;
        }
      } else if (desc && nj > 0) {
        if constexpr (kTier != kGlobal) {
          // a warp holding a split or a range end: most of its threads hold
          // none, or one cut (all its splits and range ends at one probe),
          // and test the largest sum of each of their one or two runs
          const int w0 = (t >> 5) * 32 * Bk, e = b0 + Bk;
          const unsigned ls = (unsigned)dw[1], lw = (unsigned)dw[2];
          int idx = (desc >> 4) & 63, m = desc >> 10, cut = e;
          bool many = (ls >> 30) == 3 || (lw >> 30) == 3;
          auto see = [&](int x) {
            if (x > b0 && x < e) {
              many |= cut != e && x != cut;
              cut = x;
            }
          };
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int xs = w0 + (int)((ls >> (15 * q)) & 0x7fffu), xw = w0 + (int)((lw >> (15 * q)) & 0x7fffu);
            if (q < (int)(ls >> 30) && !many) {
              idx += xs <= b0;
              see(xs);
            }
            if (q < (int)(lw >> 30) && !many) {
              m += xw <= b0;
              see(xw);
            }
          }
          see(lo_c);
          see(lo);
          see(hi);
          see(hr);
          see(end);
          if (!many) {
            int idx2 = idx, m2 = m;
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              idx2 += q < (int)(ls >> 30) && w0 + (int)((ls >> (15 * q)) & 0x7fffu) == cut;
              m2 += q < (int)(lw >> 30) && w0 + (int)((lw >> (15 * q)) & 0x7fffu) == cut;
            }
            mode = 2;
            d = cut - b0;
            const bool ra = b0 >= lo_c && b0 < end, rb = cut >= lo_c && cut < end;
            ca = ra && b0 < hr;
            cb = rb && cut < hr;
            cvx = vx[m];
            cvx2 = vx[m2];
            double ma = -INFINITY, mb = -INFINITY;
#pragma unroll
            for (int j = 0; j < RR; ++j) {
              const double sum = pv[j] + ev[j];
              ma = fmax(ma, j < d ? sum : -INFINITY);
              mb = fmax(mb, j < d ? -INFINITY : sum);
            }
            over = (ra && b0 >= lo && b0 < hi && ma + v[idx < k - 1 ? idx : k - 1] > a.budget) ||
                   (rb && cut >= lo && cut < hi && mb + v[idx2 < k - 1 ? idx2 : k - 1] > a.budget);
          } else {  // past one cut: each probe on its own, its split counts from the lanes
            mode = 3;
            const Lanes sl = lanes(ls, (desc >> 4) & 63, w0, seg, k, b0, Bk);
            wl = lanes(lw, desc >> 10, w0, swi, k, b0, Bk);
#pragma unroll
            for (int j = 0; j < RR; ++j) {
              const int i = b0 + j, si = sl.at + sl(j);
              const bool test = (pv[j] + ev[j]) + v[si < k - 1 ? si : k - 1] > a.budget;
              over |= test && (unsigned)(j - j0) < (unsigned)nj && i >= lo && i < hi;
            }
          }
        } else {  // the global tier: each probe on its own, its split counts one by one
          for (int j = j0; j < j0 + nj; ++j) {
            const int i = b0 + j;
            int si = 0;
            for (int q = 0; q < k; ++q) si += seg[q] <= i;
            if (i >= lo && i < hi)
              over |= (__ldg(a.prof + i) + ext[j * T + t]) + v[si < k - 1 ? si : k - 1] > a.budget;
          }
        }
      }
      const bool admit = !__syncthreads_or(over);
      if (t == 0) a.admits[c0 + c] = admit;
      if (!admit) continue;
      // the commit: extra + valext[#(live & sw <= p)] at each probe of [lo_c, hr)
      const int nc = max(min(i1, hr) - i0, 0);
      if constexpr (kTier != kGlobal) {
        if (mode == 1 && (desc & 8)) {
#pragma unroll
          for (int j = 0; j < RR; ++j) ev[j] = ev[j] + cvx;
        } else if (mode == 2) {
#pragma unroll
          for (int j = 0; j < RR; ++j)
            if (j < d ? ca : cb) ev[j] = ev[j] + (j < d ? cvx : cvx2);
        } else if (mode == 3) {
#pragma unroll
          for (int j = 0; j < RR; ++j)
            if ((unsigned)(j - j0) < (unsigned)nc) ev[j] = ev[j] + vx[wl.at + wl(j)];
        }
      } else {
        for (int j = j0; j < j0 + nc; ++j) {
          int sm = 0;
          for (int q = 0; q < k; ++q) sm += swi[q] <= b0 + j;
          ext[j * T + t] = ext[j * T + t] + vx[sm];
        }
      }
    }
  }
}

template <int R, int kTier>
int launch(const Args& a, const Plan& pl, cudaStream_t stream) {
  if (pl.smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(decide_kernel<R, kTier>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
    if (e != cudaSuccess) return e;
  }
  decide_kernel<R, kTier><<<1, pl.threads, pl.smem, stream>>>(a, pl.chunk, pl.per);
  return cudaGetLastError();
}

}  // namespace

// The launch plan of a batch: out[0] where prof and `extra` live (1
// registers, 0 global memory and the scratch), out[1] threads, out[2] candidates staged at a time, out[3] dynamic shared memory
// bytes, out[4] global scratch bytes.  Returns a CUDA error code.
extern "C" int admission_plan(int Pp, int C, int k, long long* out) {
  Plan pl;
  const int e = make_plan(Pp, C, k, &pl);
  if (e != cudaSuccess) return e;
  out[0] = pl.tier;
  out[1] = pl.threads;
  out[2] = pl.chunk;
  out[3] = (long long)pl.smem;
  out[4] = (long long)pl.scratch;
  return cudaSuccess;
}

// One launch decides the C candidates into admits (C,) bytes; P (Pp,) must
// be sorted ascending; scratch holds admission_plan's out[4] bytes (null
// when 0).  Returns a CUDA error code.
extern "C" int admission_launch(const double* P, const double* prof, int Pp, const double* starts,
                                const double* ends, const double* rels, const double* bnd, const double* val,
                                const double* valext, const double* sw, const unsigned char* live,
                                const unsigned char* valid, int C, int k, double budget, unsigned char* admits,
                                double* scratch, void* stream) {
  if (C <= 0) return cudaSuccess;
  Plan pl;
  const int e = make_plan(Pp, C, k, &pl);
  if (e != cudaSuccess) return e;
  if (pl.scratch > 0 && scratch == nullptr) return cudaErrorInvalidValue;
  const Args a{P, prof, Pp, starts, ends, rels, bnd, val, valext, sw, live, valid, C, k, budget, admits, scratch};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ADMISSION_CASE(r, tier) \
  case r:                       \
    return launch<r, tier>(a, pl, s);
  if (pl.tier == kRegs) switch (pl.per) {  // each thread's probes unrolled, exactly
      ADMISSION_CASE(1, kRegs) ADMISSION_CASE(2, kRegs) ADMISSION_CASE(3, kRegs) ADMISSION_CASE(4, kRegs)
      ADMISSION_CASE(5, kRegs) ADMISSION_CASE(6, kRegs) ADMISSION_CASE(7, kRegs) ADMISSION_CASE(8, kRegs)
      default:
        return cudaErrorInvalidValue;
    }
#undef ADMISSION_CASE
  return launch<0, kGlobal>(a, pl, s);
}
