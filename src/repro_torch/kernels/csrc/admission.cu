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
// Design: one block owns the batch.  Its threads own the probes (thread t
// the probes t, t + T, t + 2T, ...; neighbouring threads hold neighbouring
// probes, so a warp's probes fall inside or outside a window together) and
// keep, per probe, the instant, the profile read and `extra`, the demand of
// the candidates admitted so far.  Up to kMaxRegs probes a thread they live
// in registers; past that `extra` lives in a global scratch the wrapper
// allocates (admission_plan says which), with the instants and profile
// reads loaded from global memory.  Candidates are staged in shared memory
// a chunk at a time (start, end, release, valid, and the k boundaries,
// values, switch instants, live bits and k + 1 hold-last values).  For
// each valid candidate every thread tests its probes of the window
// [start, end] with candidate_probe_parts' own float64 expressions (offs =
// P - start, the count of boundaries below offs, clamped to k - 1, picks
// the value) and the block decides with one __syncthreads_or over `(prof +
// extra) + a > budget`, summed in that order; an admitted candidate then
// adds, at each probe of [start, release), the value after its switches
// that fired by the probe.  Outside [start, release) the reference adds
// 0.0, which leaves `extra` unchanged (it starts at +0.0 and so never
// becomes -0.0): those probes are skipped.  Decisions are bit-identical to
// the plain version.
//
// Bound (chip_smoke.py's _admission_bound): at the whole card's rates, the
// larger of the bytes (each input read once, the decisions written once)
// and the operations the batch needs, counted on the sorted probes: two
// binary searches a valid candidate for its windows, five operations a
// probe in its [start, end] window (offset, segment index, two additions,
// the test) and two a probe of an admitted candidate's [start, release)
// (switch index, addition).  The kernel instead tests every probe against
// every candidate and counts boundaries one by one, on one SM: the scan is
// sequential in the candidates, one barrier each.
//
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxRegs = 8;             // probes a thread keeps in registers
constexpr int kStageBytes = 16 * 1024;  // shared memory for staged candidates

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
  int regs;         // probes a thread keeps in registers; 0: `extra` in the scratch
  int threads;
  int chunk;        // candidates staged at a time
  size_t smem;      // dynamic shared memory of the launch: the stage
  size_t scratch;   // bytes of global scratch the launch needs
};

// Bytes of one staged candidate: start, end, release, k boundaries, values
// and switch instants, k + 1 hold-last values (doubles), then k live bits
// and the valid bit (bytes).
size_t cand_bytes(int k) { return sizeof(double) * (4 + 4 * (size_t)k) + (size_t)k + 1; }

size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

int make_plan(int Pp, int C, int k, Plan* pl) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  const size_t per = cand_bytes(k);
  long long chunk = (long long)(kStageBytes / per);
  if (chunk > C) chunk = C;
  if (chunk < 1) chunk = 1;
  pl->chunk = (int)chunk;
  pl->smem = align16((size_t)chunk * per);
  if (pl->smem > (size_t)optin) return cudaErrorInvalidValue;  // one candidate's k is too large
  pl->scratch = 0;
  if (Pp <= kMaxThreads * kMaxRegs) {
    int r = 1;
    while (Pp > kMaxThreads * r) r *= 2;
    const int need = (Pp + r - 1) / r;
    pl->regs = r;
    pl->threads = need < 32 ? 32 : (need + 31) / 32 * 32;
    return cudaSuccess;
  }
  pl->regs = 0;
  pl->threads = kMaxThreads;
  pl->scratch = sizeof(double) * (size_t)Pp;
  return cudaSuccess;
}

// Does candidate (st, en, b, v) exceed the budget at probe p?  M, then A.
__device__ __forceinline__ bool exceeds(double p, double pr, double ex, double st, double en, const double* b,
                                        const double* v, int k, double budget) {
  if (!(p >= st && p <= en && isfinite(p))) return false;
  const double offs = p - st;
  int idx = 0;
  for (int q = 0; q < k; ++q) idx += b[q] < offs;
  if (idx > k - 1) idx = k - 1;
  return pr + ex + v[idx] > budget;
}

// `extra` at probe p after an admitted candidate adds its demand D.
__device__ __forceinline__ double commit(double p, double ex, double st, double rl, const double* s,
                                         const unsigned char* lv, const double* vx, int k) {
  if (!(p >= st && p < rl)) return ex;
  int n = 0;
  for (int q = 0; q < k; ++q) n += lv[q] && s[q] <= p;
  return ex + vx[n];
}

template <int R>
__global__ void __launch_bounds__(kMaxThreads) decide_kernel(Args a, int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k = a.k, T = blockDim.x, t = threadIdx.x;
  double* s_start = reinterpret_cast<double*>(smem_raw);
  double* s_end = s_start + chunk;
  double* s_rel = s_end + chunk;
  double* s_bnd = s_rel + chunk;
  double* s_val = s_bnd + (size_t)chunk * k;
  double* s_sw = s_val + (size_t)chunk * k;
  double* s_vx = s_sw + (size_t)chunk * k;
  unsigned char* s_live = reinterpret_cast<unsigned char*>(s_vx + (size_t)chunk * (k + 1));
  unsigned char* s_valid = s_live + (size_t)chunk * k;
  double* ext = a.scratch;

  constexpr int RR = R > 0 ? R : 1;
  double pv[RR], pr[RR], ex[RR];
  if constexpr (R > 0) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int p = t + j * T;
      pv[j] = p < a.Pp ? a.P[p] : (double)INFINITY;  // +inf lies in no window
      pr[j] = p < a.Pp ? a.prof[p] : 0.0;
      ex[j] = 0.0;
    }
  } else {
    for (int p = t; p < a.Pp; p += T) ext[p] = 0.0;  // each probe stays with its thread
  }

  for (int c0 = 0; c0 < a.C; c0 += chunk) {
    const int n = min(chunk, a.C - c0);
    __syncthreads();  // the previous chunk's last candidate is read by all
    for (int i = t; i < n; i += T) {
      s_start[i] = a.starts[c0 + i];
      s_end[i] = a.ends[c0 + i];
      s_rel[i] = a.rels[c0 + i];
      s_valid[i] = a.valid[c0 + i];
    }
    const size_t base = (size_t)c0 * k;
    for (int i = t; i < n * k; i += T) {
      s_bnd[i] = a.bnd[base + i];
      s_val[i] = a.val[base + i];
      s_sw[i] = a.sw[base + i];
      s_live[i] = a.live[base + i];
    }
    for (int i = t; i < n * (k + 1); i += T) s_vx[i] = a.valext[(size_t)c0 * (k + 1) + i];
    __syncthreads();

    for (int c = 0; c < n; ++c) {
      if (!s_valid[c]) {  // the same answer in every thread: no barrier
        if (t == 0) a.admits[c0 + c] = 0;
        continue;
      }
      const double st = s_start[c], en = s_end[c], rl = s_rel[c];
      const double* b = s_bnd + (size_t)c * k;
      const double* v = s_val + (size_t)c * k;
      bool over = false;
      if constexpr (R > 0) {
#pragma unroll
        for (int j = 0; j < R; ++j) over |= exceeds(pv[j], pr[j], ex[j], st, en, b, v, k, a.budget);
      } else {
        for (int p = t; p < a.Pp; p += T) over |= exceeds(a.P[p], a.prof[p], ext[p], st, en, b, v, k, a.budget);
      }
      const bool admit = !__syncthreads_or(over);
      if (t == 0) a.admits[c0 + c] = admit;
      if (!admit) continue;
      const double* s = s_sw + (size_t)c * k;
      const unsigned char* lv = s_live + (size_t)c * k;
      const double* vx = s_vx + (size_t)c * (k + 1);
      if constexpr (R > 0) {
#pragma unroll
        for (int j = 0; j < R; ++j) ex[j] = commit(pv[j], ex[j], st, rl, s, lv, vx, k);
      } else {
        for (int p = t; p < a.Pp; p += T) ext[p] = commit(a.P[p], ext[p], st, rl, s, lv, vx, k);
      }
    }
  }
}

template <int R>
int launch(const Args& a, const Plan& pl, cudaStream_t stream) {
  if (pl.smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(decide_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
    if (e != cudaSuccess) return e;
  }
  decide_kernel<R><<<1, pl.threads, pl.smem, stream>>>(a, pl.chunk);
  return cudaGetLastError();
}

}  // namespace

// The launch plan of a batch: out[0] probes a thread keeps in registers (0:
// `extra` in the global scratch), out[1] threads, out[2] candidates staged at a time,
// out[3] dynamic shared memory bytes, out[4] global scratch bytes.  Returns
// a CUDA error code.
extern "C" int admission_plan(int Pp, int C, int k, long long* out) {
  Plan pl;
  const int e = make_plan(Pp, C, k, &pl);
  if (e != cudaSuccess) return e;
  out[0] = pl.regs;
  out[1] = pl.threads;
  out[2] = pl.chunk;
  out[3] = (long long)pl.smem;
  out[4] = (long long)pl.scratch;
  return cudaSuccess;
}

// One launch decides the C candidates into admits (C,) bytes; scratch holds
// admission_plan's out[4] bytes (null when 0).  Returns a CUDA error code.
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
  switch (pl.regs) {
    case 1:
      return launch<1>(a, pl, s);
    case 2:
      return launch<2>(a, pl, s);
    case 4:
      return launch<4>(a, pl, s);
    case 8:
      return launch<8>(a, pl, s);
    default:
      return launch<0>(a, pl, s);
  }
}
