// wastage: attempt scoring and whole retry ladders of step allocations, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/wastage.py (_wastage_kernel /
// wastage_pallas): the first OOM sample and the GiB*s wastage of an
// allocation attempt, which the TPU kernel carried as a failed /
// fail-position state machine across a sequential grid axis over T.  Here
// one warp owns one attempt row (8 rows to a 256-thread block) and walks
// its series in chunks of 32 samples, lane q of a chunk at sample
// base + q:
//   * a(t) = values[min(#{bounds < t}, k - 1)] at t = (pos + 0.5) * interval,
//     as the reference engine's _attempt evaluates it (repro/sim/jax_sim.py),
//     with the schedule in shared memory;
//   * each lane sums a - y (the success integral) and a (the failure
//     integral) over its samples; a ballot finds the chunk of the first
//     y > a and the walk stops there, the failure integral then taken up
//     to and including that sample;
//   * a butterfly of __shfl_xor_sync sums the lanes.  Every lane ends with
//     the same bits, and the order is fixed: no atomics, the same result on
//     every run.
// The TPU kernel's sum of step increments is not used: v1 + (v2 - v1) is not
// always v2 in f32, which can move a fail index.
//
// Ladder mode runs the reference's whole retry loop (jax_sim._replay_multi)
// inside the warp: after a failure, lane 0 applies the bump the reference
// applies -- seg = min(#{t_fail > bounds}, k_eff - 1); selective: segment
// seg times the factor, partial: seg and every later one, cap jump: the node
// cap; then the running max over segments and the clamp to the cap, all in
// the schedule's type -- adds the attempt's waste to the row's total in
// attempt order, and scores again.  A row stops on success, past
// kMaxRetries retries, or, when recording, once its attempt slots are full.
// Recording writes each attempt's values, failure index and waste, and the
// attempt count, straight into the output buffers.  So a whole replay is
// one launch, where the host loop of rounds took one launch a round plus a
// host sync and ~35 small ops between rounds.
//
// Three precisions, one template <V, A>: V is the schedule's type (t, a(t),
// the y > a decision and the bump), A the accumulator's.  The series stay
// float32 (every value of them is exact in float64):
//   0: V = A = float   -- the Fig. 7 grid;
//   1: V = float, A = double -- float32 retry ladders summed in float64, as
//      the reference sums them under its x64 context (jax_sim._acc_dtype);
//   2: V = A = double  -- the float64 (x64) retry ladders.
//
// Row r reads series[r / series_div] of y (S, T): the method rows of one
// execution share its series through L2.  Bound: memory, every attempt's
// read of its series plus the schedules and the outputs, over the card's
// 3.35 TB/s (k compares per sample are far below the f32 and f64 rates).
// Built with -fmad=false: t, a(t), the bump and the sums round each
// operation as PyTorch's elementwise ops do.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // attempt rows per block
constexpr int kMaxK = 128;
constexpr int kMaxRetries = 64;  // jax_sim.MAX_RETRIES
constexpr unsigned kFull = 0xffffffffu;

template <typename V, typename A>
struct Params {
  const float* y;
  int T;
  const int* lengths;
  const int* series;
  int series_div;  // row r reads series[r / series_div]
  const V* bounds;
  const V* values;
  int k;
  int rows;
  V interval;
  A scale;  // the interval in the accumulator's type
  // ladder mode when k_eff is set: row r = (n * B + b) * M + m
  const int* k_eff;  // (N,), row r reads k_eff[r / keff_div]
  int keff_div;
  int M;
  unsigned selective, cap_jump;  // bit m: method m's retry mode
  V factor, cap;
  int max_attempts;  // > 0: record every attempt
  A* waste;          // (rows,) the row's total (one attempt: its waste)
  int* out;          // (rows,) retries (one attempt: the fail index, -1 on success)
  V* vbuf;           // (rows, max_attempts, k)
  int* fbuf;         // (rows, max_attempts)
  A* wbuf;           // (rows, max_attempts)
  long long* natt;   // (rows,)
};

template <typename A>
__device__ __forceinline__ A warp_sum(A v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <typename V>
__device__ __forceinline__ V alloc_at(int p, V interval, const V* sb, const V* sv, int k) {
  const V t = ((V)p + V(0.5)) * interval;
  int idx = 0;
  for (int s = 0; s < k; ++s) idx += t > sb[s];
  return sv[min(idx, k - 1)];
}

// torch.clamp(x, max=cap): NaN stays NaN
template <typename V>
__device__ __forceinline__ V clamp_max(V x, V cap) {
  return x > cap ? cap : x;
}

// One attempt of the warp's row: the first failing sample (-1 on success)
// and the waste in GiB*s.  Every lane returns the same values.
template <typename V, typename A>
__device__ void score(const float* row, int len, const V* sb, const V* sv, int k, V interval, A scale, int lane,
                      int& fail, A& w) {
  A succ = A(0), part = A(0);
  fail = -1;
  for (int base = 0; base < len; base += 32) {  // uniform across the warp
    const int p = base + lane;
    const bool in = p < len;
    V a = V(0), yv = V(0);
    if (in) {
      a = alloc_at(p, interval, sb, sv, k);
      yv = (V)row[p];
    }
    const unsigned over = __ballot_sync(kFull, in && yv > a);
    if (over) {
      fail = base + __ffs(over) - 1;
      if (p <= fail) part += (A)a;
      break;
    }
    if (in) {
      succ += (A)a - (A)yv;
      part += (A)a;
    }
  }
  w = warp_sum(fail >= 0 ? part : succ) * scale / A(1024);
}

// The reference's bump after a failure at sample ``fail`` (lane 0 only):
// the failed segment (selective), it and every later one (partial), or the
// node cap (cap jump); then the running max over segments and the cap.
template <typename V>
__device__ void bump(V* sv, const V* sb, int k, int k_eff, int fail, V interval, bool selective, bool cap_jump,
                     V factor, V cap) {
  const V t_fail = ((V)fail + V(0.5)) * interval;
  int seg = 0;
  for (int s = 0; s < k; ++s) seg += t_fail > sb[s];
  seg = min(seg, k_eff - 1);
  V run = V(0);
  for (int s = 0; s < k; ++s) {
    const V v = sv[s];
    V nv = v;
    if (cap_jump)
      nv = cap;
    else if (selective ? s == seg : s >= seg)
      nv = v * factor;
    if (s == 0 || nv >= run || nv != nv) run = nv;  // torch.cummax: NaN sticks
    sv[s] = clamp_max(run, cap);
  }
}

template <typename V, typename A>
__global__ void __launch_bounds__(kThreads) wastage_kernel(const Params<V, A> p) {
  __shared__ V s_bounds[kWarps][kMaxK], s_values[kWarps][kMaxK];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= p.rows) return;  // the whole warp; the kernel has no block barrier
  V* sb = s_bounds[warp];
  V* sv = s_values[warp];
  const int k = p.k;
  const bool ladder = p.k_eff != nullptr;
  for (int s = lane; s < k; s += 32) {
    sb[s] = p.bounds[(size_t)r * k + s];
    const V v = p.values[(size_t)r * k + s];
    sv[s] = ladder ? clamp_max(v, p.cap) : v;
  }
  __syncwarp();
  const int sid = p.series[r / p.series_div];
  const float* row = p.y + (size_t)sid * p.T;
  const int len = min(p.lengths[sid], p.T);

  int fail;
  A w;
  if (!ladder) {
    score(row, len, sb, sv, k, p.interval, p.scale, lane, fail, w);
    if (lane == 0) {
      p.waste[r] = w;
      p.out[r] = fail;
    }
    return;
  }
  const int m = r % p.M;
  const bool selective = (p.selective >> m) & 1u, cap_jump = (p.cap_jump >> m) & 1u;
  const int k_eff = p.k_eff[r / p.keff_div];
  const int slots = p.max_attempts;
  A total = A(0);
  int retries = 0, n = 0;
  for (;;) {
    score(row, len, sb, sv, k, p.interval, p.scale, lane, fail, w);
    total += w;
    if (slots > 0) {
      V* vb = p.vbuf + ((size_t)r * slots + n) * k;
      for (int s = lane; s < k; s += 32) vb[s] = sv[s];
      if (lane == 0) {
        p.fbuf[(size_t)r * slots + n] = fail;
        p.wbuf[(size_t)r * slots + n] = w;
      }
    }
    ++n;
    if (fail < 0) break;
    __syncwarp();  // every lane has read sv before lane 0 rewrites it
    if (lane == 0) bump(sv, sb, k, k_eff, fail, p.interval, selective, cap_jump, p.factor, p.cap);
    __syncwarp();
    ++retries;
    if (retries > kMaxRetries || (slots > 0 && n >= slots)) break;
  }
  if (lane == 0) {
    p.waste[r] = total;
    p.out[r] = retries;
  }
  if (slots > 0) {  // slots past the ladder: zero values and waste, failure index -1
    for (int j = n; j < slots; ++j) {
      V* vb = p.vbuf + ((size_t)r * slots + j) * k;
      for (int s = lane; s < k; s += 32) vb[s] = V(0);
      if (lane == 0) {
        p.fbuf[(size_t)r * slots + j] = -1;
        p.wbuf[(size_t)r * slots + j] = A(0);
      }
    }
    if (lane == 0) p.natt[r] = n;
  }
}

template <typename V, typename A>
int launch(Params<V, A> p, cudaStream_t stream) {
  if (p.rows > 0) wastage_kernel<V, A><<<(p.rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename V, typename A>
int dispatch(const float* y, int T, const int* lengths, const int* series, int series_div, const void* bounds,
             const void* values, int k, int rows, double interval, const int* k_eff, int keff_div, int M,
             unsigned selective, unsigned cap_jump, double factor, double cap, int max_attempts, void* waste,
             int* out, void* vbuf, int* fbuf, void* wbuf, long long* natt, cudaStream_t stream) {
  Params<V, A> p{y, T, lengths, series, series_div, (const V*)bounds, (const V*)values, k, rows, (V)interval,
                 (A)interval, k_eff, keff_div, M, selective, cap_jump, (V)factor, (V)cap, max_attempts, (A*)waste,
                 out, (V*)vbuf, fbuf, (A*)wbuf, natt};
  return launch(p, stream);
}

int run(int precision, const float* y, int T, const int* lengths, const int* series, int series_div,
        const void* bounds, const void* values, int k, int rows, double interval, const int* k_eff, int keff_div,
        int M, unsigned selective, unsigned cap_jump, double factor, double cap, int max_attempts, void* waste,
        int* out, void* vbuf, int* fbuf, void* wbuf, long long* natt, cudaStream_t stream) {
  if (k < 1 || k > kMaxK || series_div < 1) return (int)cudaErrorInvalidValue;
  switch (precision) {
    case 0:
      return dispatch<float, float>(y, T, lengths, series, series_div, bounds, values, k, rows, interval, k_eff,
                                    keff_div, M, selective, cap_jump, factor, cap, max_attempts, waste, out, vbuf,
                                    fbuf, wbuf, natt, stream);
    case 1:
      return dispatch<float, double>(y, T, lengths, series, series_div, bounds, values, k, rows, interval, k_eff,
                                     keff_div, M, selective, cap_jump, factor, cap, max_attempts, waste, out, vbuf,
                                     fbuf, wbuf, natt, stream);
    case 2:
      return dispatch<double, double>(y, T, lengths, series, series_div, bounds, values, k, rows, interval, k_eff,
                                      keff_div, M, selective, cap_jump, factor, cap, max_attempts, waste, out, vbuf,
                                      fbuf, wbuf, natt, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// One attempt per row.  y (S, T) f32, lengths (S,) i32, series (rows,) i32,
// bounds/values (rows, k) of the schedule's type -> waste (rows,) of the
// accumulator's type in GiB*s, fail_idx (rows,) i32 (-1 on success).
// precision: 0 f32/f32, 1 f32/f64, 2 f64/f64 (schedule/accumulator).
extern "C" int wastage_launch(const float* y, int T, const int* lengths, const int* series, const void* bounds,
                              const void* values, int k, int rows, double interval, int precision, void* waste,
                              int* fail_idx, cudaStream_t stream) {
  return run(precision, y, T, lengths, series, 1, bounds, values, k, rows, interval, nullptr, 1, 1, 0u, 0u, 0.0,
             0.0, 0, waste, fail_idx, nullptr, nullptr, nullptr, nullptr, stream);
}

// A whole retry ladder per row, rows r = (n * B + b) * M + m of N lanes x B
// executions x M methods.  series (N * B,) i32, bounds/values (rows, k),
// k_eff (N,) i32; selective / cap_jump bit m is method m's retry mode;
// values are clamped to cap first.  -> waste (rows,) the sum over the
// row's attempts, retries (rows,) i32; with max_attempts > 0 also vbuf
// (rows, max_attempts, k), fbuf (rows, max_attempts) i32 (-1: success or
// no attempt), wbuf (rows, max_attempts), natt (rows,) i64.
extern "C" int ladder_launch(const float* y, int T, const int* lengths, const int* series, const void* bounds,
                             const void* values, int k, int N, int B, int M, const int* k_eff, unsigned selective,
                             unsigned cap_jump, double interval, double factor, double cap, int max_attempts,
                             int precision, void* waste, int* retries, void* vbuf, int* fbuf, void* wbuf,
                             long long* natt, cudaStream_t stream) {
  if (N < 0 || B < 0 || M < 1 || M > 32 || max_attempts < 0) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)N * B * M;
  if (rows > INT_MAX) return (int)cudaErrorInvalidValue;
  return run(precision, y, T, lengths, series, M, bounds, values, k, (int)rows, interval, k_eff, B * M, M,
             selective, cap_jump, factor, cap, max_attempts, waste, retries, vbuf, fbuf, wbuf, natt, stream);
}
