// rwkv_wkv_bwd: the gradient of the RWKV-6 WKV recurrence of a head, for
// sm_90a.
//
// No TPU kernel: it replaces the gradient that JAX's autodiff takes of the
// recurrence the reference leaves to XLA in repro/models/recurrent.py
// (rwkv_time_mix: the lax.scan of chunk_step, and the single step at T = 1).
//
// Semantics (repro_torch.kernels.rwkv_wkv_bwd.wkv_bwd_plain).  Per batch
// row b and head h, the forward carries the state S (hd_k, hd_v) from S0:
//   o_t[v] = sum_k r_t[k] (u[k] k_t[k] v_t[v] + S_{t-1}[k, v])
//   S_t    = w_t ⊙_k S_{t-1} + k_t v_t^T,         w_t = exp(logw_t)
// Given do (the gradient of o) and dS (of the last state), in reverse time
// from dS_T = dS, with dS_t the gradient of S_t:
//   dr_t[k]    = sum_v do_t[v] S_{t-1}[k, v] + u[k] k_t[k] (do_t . v_t)
//   dk_t[k]    = sum_v dS_t[k, v] v_t[v] + r_t[k] u[k] (do_t . v_t)
//   dv_t[v]    = sum_k dS_t[k, v] k_t[k] + (sum_k r_t u k_t) do_t[v]
//   dlogw_t[k] = w_t[k] sum_v dS_t[k, v] S_{t-1}[k, v]
//   dS_{t-1}   = w_t ⊙_k dS_t + r_t do_t^T
//   du[h, k]   = sum_{b, t} r_t[k] k_t[k] (do_t . v_t),   dS0 = dS_{-1}.
// Every element of S and dS evolves on its own along t; only the sums
// couple them.  The sums run in other orders than the plain version's, and
// the state updates are fused multiply-adds: the kernel is held to the
// plain version within 1e-4 of each output's max |plain|.
//
// The trap is S_{t-1} in reverse time: undoing an update, (S_t - k v^T) /
// w_t, multiplies the rounding by up to e^1.2 a token.  So the states are
// checkpointed, and the work is cut into chunks of kChunk tokens that run
// in parallel:
//
// 1. wkv_bwd_ckpt_kernel (two sweeps in one grid, a thread 4 elements of a
//    head's state): the forward sweep writes S before every chunk (ckS), the
//    backward sweep dS after every chunk's last token (ckdS).  Element by
//    element, with no sums between threads; each block stages a chunk's
//    decays, its own k (or r) rows and v (or do) in shared memory, the next
//    chunk's loaded into registers while the current one is walked.
// 2. wkv_bwd_chunk_kernel, a block per (chunk, b, h), 4 warps: the chunk's
//    r, k, v, w and do staged in shared memory (49 KB).  Two warps own the
//    key rows, a pair of rows (j, j + 32) and a half of the value columns a
//    thread: from ckS they recompute S forward over the chunk, with dr's
//    state sum (summed in the thread, then with the partner lane holding
//    the other half); then from ckdS they walk back with dS's rows, giving
//    dk's state sum and dlogw.  Two warps own the value columns likewise
//    and walk back with dS's columns, giving dv's sum.  dlogw needs S_{t-1}
//    and dS_t together; the key warps hold one at a time, so it is taken
//    from the identity
//      dlogw_t = dlogw_{t+1} + r_{t+1} ⊙ drS_{t+1} - k_t ⊙ dkS_t,
//      dlogw_e = sum_v dS_e ⊙ S_e - k_e ⊙ dkS_e        (e the chunk's last)
//    (drS, dkS the state sums of dr and dk), which follows from S_t = w_t
//    S_{t-1} + k_t v_t^T and dS_{t-1} = w_t dS_t + r_t do_t^T, and runs
//    over at most kChunk tokens.  du's partial sum of the block goes to
//    a scratch row.
// 3. wkv_bwd_du_kernel: du summed over (b, chunk) in a fixed order, with no
//    atomics, so that the result is the same from run to run.
//
// Bound on this card: operations (the token form's 14 flop a state element
// and token, f32 on the CUDA cores; the bytes take ~0.8 of that time).
// What holds the kernel: the chunk kernel issues its FMAs and shared loads
// from few warps (registers and shared memory allow 4 blocks an SM), and
// the sweeps walk every token twice more.  Measured on the H100 at rwkv6's
// training shape (tools/recurrent_clocks.py --trees): a row a thread in
// chunks of 64 took 2.05 ms (chunks 1.38), a pair of rows a thread in
// chunks of 64 1.97 (chunks 1.39), in chunks of 32 1.57 (chunks 1.00: 4
// blocks an SM, not 2).  The chunk form on the tensor cores, as the
// forward's, is the next design.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kHead = 64;   // RWKV-6's head size
constexpr int kChunk = 32;  // tokens a chunk
constexpr int kAcc = 4;     // partial sums of a 64-term dot product (shorter chains)

// ---------------------------------------------------------------------------
// 1. checkpoints
// ---------------------------------------------------------------------------

constexpr int kCkRows = 16;                       // key channels a checkpoint block
constexpr int kCkThreads = kCkRows * kHead / 4;   // 4 state elements a thread
constexpr int kCkLoads = kChunk * kHead / 4 / kCkThreads;  // float4s of v (or do) a thread stages a chunk
static_assert(kCkThreads == 256 && kCkLoads == 2, "ckpt: 16 rows of 16 float4s, 2 tokens a thread");

// grid (kHead / kCkRows, B * H, 2): z 0 the forward sweep (ckS), z 1 the
// backward sweep (ckdS).  ck*: (B * H, nck, 64, 64).  The next chunk's
// inputs are loaded into registers while the current one is walked.
__global__ void __launch_bounds__(kCkThreads)
    wkv_bwd_ckpt_kernel(const float* __restrict__ r, const float* __restrict__ k, const float* __restrict__ v,
                        const float* __restrict__ logw, const float* __restrict__ dout,
                        const float* __restrict__ S0, const float* __restrict__ dS, int T, int H, int nck,
                        float* __restrict__ ckS, float* __restrict__ ckdS) {
  __shared__ __align__(16) float cols[kChunk][kHead];  // v (forward) or do (backward), [token][column]
  __shared__ float wr[kChunk][kCkRows];                // decays of the block's rows
  __shared__ float xr[kChunk][kCkRows];                // k (forward) or r (backward) of the block's rows
  const int tid = threadIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int row0 = blockIdx.x * kCkRows;
  const int kl = tid / (kHead / 4), kr = row0 + kl, vq = (tid % (kHead / 4)) * 4;
  const bool fwd = blockIdx.z == 0;
  const float* X = fwd ? k : r;
  const float* Y = fwd ? v : dout;
  float* ck = (fwd ? ckS : ckdS) + (size_t)bh * nck * kHead * kHead + kr * kHead + vq;
  const size_t state = ((size_t)bh * kHead + kr) * kHead + vq;
  // staging: this thread's float4s are token tid / 16 + 16 j, columns vq;
  // the 64 threads with vq < 16 also stage the rows' decays and k (or r)
  const int t_l = tid / (kHead / 4);
  const bool rows = vq < kCkRows;
  float4 ys[kCkLoads], lws[kCkLoads], xs[kCkLoads];
  auto fetch = [&](int c) {
    const int t0 = c * kChunk, n = min(kChunk, T - t0);
#pragma unroll
    for (int j = 0; j < kCkLoads; ++j) {
      const int t = t_l + 16 * j;
      if (t < n) {
        const size_t g = ((size_t)(b * T + t0 + t) * H + h) * kHead;
        ys[j] = *reinterpret_cast<const float4*>(Y + g + vq);
        if (rows) {
          lws[j] = *reinterpret_cast<const float4*>(logw + g + row0 + vq);
          xs[j] = *reinterpret_cast<const float4*>(X + g + row0 + vq);
        }
      }
    }
  };
  float4 s = *reinterpret_cast<const float4*>((fwd ? S0 : dS) + state);
  if (nck > 1) fetch(fwd ? 0 : nck - 1);
  for (int i = 0; i < nck; ++i) {
    const int c = fwd ? i : nck - 1 - i;
    *reinterpret_cast<float4*>(ck + (size_t)c * kHead * kHead) = s;
    if (i == nck - 1) break;  // the sweep's last chunk is the chunk kernel's
    const int n = min(kChunk, T - c * kChunk);
    __syncthreads();  // the chunk before is read by all
#pragma unroll
    for (int j = 0; j < kCkLoads; ++j) {
      const int t = t_l + 16 * j;
      if (t < n) {
        *reinterpret_cast<float4*>(&cols[t][vq]) = ys[j];
        if (rows) {
          wr[t][vq] = expf(lws[j].x), wr[t][vq + 1] = expf(lws[j].y);
          wr[t][vq + 2] = expf(lws[j].z), wr[t][vq + 3] = expf(lws[j].w);
          xr[t][vq] = xs[j].x, xr[t][vq + 1] = xs[j].y, xr[t][vq + 2] = xs[j].z, xr[t][vq + 3] = xs[j].w;
        }
      }
    }
    __syncthreads();
    if (i + 1 < nck - 1) fetch(fwd ? c + 1 : c - 1);  // the next chunk's, in flight during this one
    if (fwd) {  // S_t = w_t S_{t-1} + k_t v_t^T
      for (int t = 0; t < n; ++t) {
        const float w = wr[t][kl], x = xr[t][kl];
        const float4 y = *reinterpret_cast<const float4*>(&cols[t][vq]);
        s.x = fmaf(w, s.x, x * y.x), s.y = fmaf(w, s.y, x * y.y);
        s.z = fmaf(w, s.z, x * y.z), s.w = fmaf(w, s.w, x * y.w);
      }
    } else {  // dS_{t-1} = w_t dS_t + r_t do_t^T
      for (int t = n - 1; t >= 0; --t) {
        const float w = wr[t][kl], x = xr[t][kl];
        const float4 y = *reinterpret_cast<const float4*>(&cols[t][vq]);
        s.x = fmaf(w, s.x, x * y.x), s.y = fmaf(w, s.y, x * y.y);
        s.z = fmaf(w, s.z, x * y.z), s.w = fmaf(w, s.w, x * y.w);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 2. the chunks
// ---------------------------------------------------------------------------

constexpr int kHalf = kHead / 2;
constexpr int kPair = 2;  // key rows (or value columns) a thread: each row read from shared memory feeds both
// a pair of key rows (j, j + 32) two threads, a half of the value columns
// each; then a pair of value columns two threads, a half of the key rows
// each.  Lane bit 3 picks the half, so the partners are lanes 8 apart and
// each quarter of a warp (the 8 lanes of one phase of a 16-byte shared
// load) reads one half's address: a broadcast, free of bank conflicts
constexpr int kPartner = 8;
constexpr int kRoleThreads = kHead / kPair * 2;  // threads of the key role, and of the value role
constexpr int kChunkThreads = 2 * kRoleThreads;
constexpr int kTile = kChunk * kHead;
// shared memory: r, k, v, w, do [token][channel], drS [token][key], u, do.v, sum r u k
constexpr int kChunkSmem = (6 * kTile + 3 * kHead) * (int)sizeof(float);

// sum_j row[j] x[i][j] over a thread's half (row already offset to it) for
// each of its pair, then with its partner's half: both partners get the
// same sums (a + b = b + a)
__device__ __forceinline__ void dot_halves(const float* __restrict__ row, const float (&x)[kPair][kHalf],
                                           float (&out)[kPair]) {
  float acc[kPair][kAcc] = {};
#pragma unroll
  for (int q = 0; q < kHalf / 4; ++q) {
    const float4 y = *reinterpret_cast<const float4*>(row + 4 * q);
#pragma unroll
    for (int i = 0; i < kPair; ++i) {
      acc[i][q % kAcc] = fmaf(y.x, x[i][4 * q], acc[i][q % kAcc]);
      acc[i][q % kAcc] = fmaf(y.y, x[i][4 * q + 1], acc[i][q % kAcc]);
      acc[i][q % kAcc] = fmaf(y.z, x[i][4 * q + 2], acc[i][q % kAcc]);
      acc[i][q % kAcc] = fmaf(y.w, x[i][4 * q + 3], acc[i][q % kAcc]);
    }
  }
#pragma unroll
  for (int i = 0; i < kPair; ++i) {
    const float mine = (acc[i][0] + acc[i][1]) + (acc[i][2] + acc[i][3]);
    out[i] = mine + __shfl_xor_sync(0xffffffffu, mine, kPartner);
  }
}

// x[i][j] = w_i x[i][j] + a_i y[j] over a thread's half, y read from
// shared memory (already offset to the half) once for the pair
__device__ __forceinline__ void update_rows(float (&x)[kPair][kHalf], const float (&w)[kPair],
                                            const float (&a)[kPair], const float* __restrict__ y_s) {
#pragma unroll
  for (int q = 0; q < kHalf / 4; ++q) {
    const float4 y = *reinterpret_cast<const float4*>(y_s + 4 * q);
#pragma unroll
    for (int i = 0; i < kPair; ++i) {
      x[i][4 * q] = fmaf(w[i], x[i][4 * q], a[i] * y.x), x[i][4 * q + 1] = fmaf(w[i], x[i][4 * q + 1], a[i] * y.y);
      x[i][4 * q + 2] = fmaf(w[i], x[i][4 * q + 2], a[i] * y.z);
      x[i][4 * q + 3] = fmaf(w[i], x[i][4 * q + 3], a[i] * y.w);
    }
  }
}

// grid (nck, B * H), kChunkThreads threads.  Outputs (B, T, H, 64); dS0
// (B * H, 64, 64) from chunk 0; du_part (B * H, nck, 64).  A null output
// is not written.
__global__ void __launch_bounds__(kChunkThreads)
    wkv_bwd_chunk_kernel(const float* __restrict__ r, const float* __restrict__ k, const float* __restrict__ v,
                         const float* __restrict__ logw, const float* __restrict__ u,
                         const float* __restrict__ dout, const float* __restrict__ ckS,
                         const float* __restrict__ ckdS, int T, int H, int nck, float* __restrict__ dr,
                         float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dlogw,
                         float* __restrict__ dS0, float* __restrict__ du_part) {
  extern __shared__ __align__(16) float sm[];
  float* r_s = sm;
  float* k_s = r_s + kTile;
  float* v_s = k_s + kTile;
  float* w_s = v_s + kTile;
  float* do_s = w_s + kTile;
  float* drs_s = do_s + kTile;
  float* u_s = drs_s + kTile;
  float* dov_s = u_s + kHead;
  float* ruk_s = dov_s + kHead;
  const int tid = threadIdx.x;
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int t0 = c * kChunk, n = min(kChunk, T - t0);
  auto at = [&](int t) { return ((size_t)(b * T + t0 + t) * H + h) * kHead; };  // token t's row of a (B, T, H, 64)

  for (int p = tid; p < 5 * n * kHead / 4; p += kChunkThreads) {
    const int which = p / (n * kHead / 4), rem = p % (n * kHead / 4);
    const int t = rem / (kHead / 4), q = (rem % (kHead / 4)) * 4;
    const float* src = which == 0 ? r : which == 1 ? k : which == 2 ? v : which == 3 ? logw : dout;
    float4 x = *reinterpret_cast<const float4*>(src + at(t) + q);
    if (which == 3) x = make_float4(expf(x.x), expf(x.y), expf(x.z), expf(x.w));
    *reinterpret_cast<float4*>(sm + which * kTile + t * kHead + q) = x;
  }
  if (tid < kHead) u_s[tid] = u[h * kHead + tid];
  __syncthreads();
  for (int t = tid; t < 2 * n; t += kChunkThreads) {  // do_t . v_t, then sum_k r_t u k_t
    const int tt = t % n;
    float acc[kAcc] = {};
    if (t < n) {
      for (int j = 0; j < kHead; ++j) acc[j % kAcc] = fmaf(do_s[tt * kHead + j], v_s[tt * kHead + j], acc[j % kAcc]);
      dov_s[tt] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    } else {
      for (int j = 0; j < kHead; ++j)
        acc[j % kAcc] = fmaf(r_s[tt * kHead + j] * u_s[j], k_s[tt * kHead + j], acc[j % kAcc]);
      ruk_s[tt] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
  }
  __syncthreads();

  const size_t ck = ((size_t)bh * nck + c) * kHead * kHead;
  const int half = (tid / kPartner) & 1, j0 = half * kHalf;  // this thread's half of the columns (or rows)
  const int lo = (tid % kRoleThreads) / (2 * kPartner) * kPartner + tid % kPartner;  // its pair: lo, lo + 32
  const bool lead = half == 0;  // writes the pair's outputs
  float x[kPair][kHalf];
  if (tid < kRoleThreads) {  // a pair of key rows' half: forward with S, then back with dS
    const int kr[kPair] = {lo, lo + kHalf};
    float uk[kPair], du[kPair] = {};
#pragma unroll
    for (int i = 0; i < kPair; ++i) {
      uk[i] = u_s[kr[i]];
#pragma unroll
      for (int q = 0; q < kHalf / 4; ++q) {
        const float4 y = *reinterpret_cast<const float4*>(ckS + ck + kr[i] * kHead + j0 + 4 * q);
        x[i][4 * q] = y.x, x[i][4 * q + 1] = y.y, x[i][4 * q + 2] = y.z, x[i][4 * q + 3] = y.w;
      }
    }
    for (int t = 0; t < n; ++t) {
      float drs[kPair], kk[kPair], w[kPair];
      dot_halves(do_s + t * kHead + j0, x, drs);  // sum_v do_t S_{t-1}
      const float dov = dov_s[t];
#pragma unroll
      for (int i = 0; i < kPair; ++i) {
        kk[i] = k_s[t * kHead + kr[i]], w[i] = w_s[t * kHead + kr[i]];
        if (lead) {
          drs_s[t * kHead + kr[i]] = drs[i];
          if (dr) dr[at(t) + kr[i]] = drs[i] + uk[i] * kk[i] * dov;
        }
        du[i] = fmaf(r_s[t * kHead + kr[i]] * kk[i], dov, du[i]);
      }
      update_rows(x, w, kk, v_s + t * kHead + j0);  // S_t = w_t S_{t-1} + k_t v_t^T
    }
    // x is S_e: take sum_v dS_e S_e, then dS_e into x
    float acc[kPair];  // dlogw_{t+1} + r_{t+1} drS_{t+1}, at t = e
#pragma unroll
    for (int i = 0; i < kPair; ++i) {
      if (du_part && lead) du_part[((size_t)bh * nck + c) * kHead + kr[i]] = du[i];
      float dl[kAcc] = {};
#pragma unroll
      for (int q = 0; q < kHalf / 4; ++q) {
        const float4 y = *reinterpret_cast<const float4*>(ckdS + ck + kr[i] * kHead + j0 + 4 * q);
        dl[q % kAcc] = fmaf(y.x, x[i][4 * q], dl[q % kAcc]);
        dl[q % kAcc] = fmaf(y.y, x[i][4 * q + 1], dl[q % kAcc]);
        dl[q % kAcc] = fmaf(y.z, x[i][4 * q + 2], dl[q % kAcc]);
        dl[q % kAcc] = fmaf(y.w, x[i][4 * q + 3], dl[q % kAcc]);
        x[i][4 * q] = y.x, x[i][4 * q + 1] = y.y, x[i][4 * q + 2] = y.z, x[i][4 * q + 3] = y.w;
      }
      const float mine = (dl[0] + dl[1]) + (dl[2] + dl[3]);
      acc[i] = mine + __shfl_xor_sync(0xffffffffu, mine, kPartner);
    }
    __syncwarp();  // drs_s of this warp's rows written by their lead lanes
    for (int t = n - 1; t >= 0; --t) {
      float dks[kPair], w[kPair], rr[kPair];
      dot_halves(v_s + t * kHead + j0, x, dks);  // sum_v dS_t v_t
#pragma unroll
      for (int i = 0; i < kPair; ++i) {
        const float kk = k_s[t * kHead + kr[i]];
        w[i] = w_s[t * kHead + kr[i]], rr[i] = r_s[t * kHead + kr[i]];
        const float dlw = acc[i] - kk * dks[i];
        if (lead) {
          if (dk) dk[at(t) + kr[i]] = dks[i] + rr[i] * uk[i] * dov_s[t];
          if (dlogw) dlogw[at(t) + kr[i]] = dlw;
        }
        acc[i] = dlw + rr[i] * drs_s[t * kHead + kr[i]];
      }
      update_rows(x, w, rr, do_s + t * kHead + j0);  // dS_{t-1} = w_t dS_t + r_t do_t^T
    }
    if (dS0 && c == 0) {
#pragma unroll
      for (int i = 0; i < kPair; ++i)
#pragma unroll
        for (int q = 0; q < kHalf / 4; ++q)
          *reinterpret_cast<float4*>(dS0 + ((size_t)bh * kHead + kr[i]) * kHead + j0 + 4 * q) =
              make_float4(x[i][4 * q], x[i][4 * q + 1], x[i][4 * q + 2], x[i][4 * q + 3]);
    }
  } else {  // a pair of value columns' half of the key rows: back with dS's columns
    const int vc[kPair] = {lo, lo + kHalf};
#pragma unroll
    for (int i = 0; i < kPair; ++i)
#pragma unroll
      for (int j = 0; j < kHalf; ++j) x[i][j] = ckdS[ck + (j0 + j) * kHead + vc[i]];
    for (int t = n - 1; t >= 0; --t) {
      float dvs[kPair], d[kPair];
      dot_halves(k_s + t * kHead + j0, x, dvs);  // sum_k dS_t k_t
#pragma unroll
      for (int i = 0; i < kPair; ++i) {
        d[i] = do_s[t * kHead + vc[i]];
        if (dv && lead) dv[at(t) + vc[i]] = dvs[i] + ruk_s[t] * d[i];
      }
      // dS_{t-1}[k, v] = w_t[k] dS_t[k, v] + r_t[k] do_t[v]: the decays and r by key row
#pragma unroll
      for (int q = 0; q < kHalf / 4; ++q) {
        const float4 wq = *reinterpret_cast<const float4*>(w_s + t * kHead + j0 + 4 * q);
        const float4 rq = *reinterpret_cast<const float4*>(r_s + t * kHead + j0 + 4 * q);
#pragma unroll
        for (int i = 0; i < kPair; ++i) {
          x[i][4 * q] = fmaf(wq.x, x[i][4 * q], rq.x * d[i]);
          x[i][4 * q + 1] = fmaf(wq.y, x[i][4 * q + 1], rq.y * d[i]);
          x[i][4 * q + 2] = fmaf(wq.z, x[i][4 * q + 2], rq.z * d[i]);
          x[i][4 * q + 3] = fmaf(wq.w, x[i][4 * q + 3], rq.w * d[i]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. du
// ---------------------------------------------------------------------------

// grid H, kHead threads: du[h, k] = sum over b, then chunks, in order.
__global__ void __launch_bounds__(kHead)
    wkv_bwd_du_kernel(const float* __restrict__ du_part, int B, int H, int nck, float* __restrict__ du) {
  const int h = blockIdx.x, kr = threadIdx.x;
  float s = 0.f;
  for (int b = 0; b < B; ++b)
    for (int c = 0; c < nck; ++c) s += du_part[(((size_t)b * H + h) * nck + c) * kHead + kr];
  du[h * kHead + kr] = s;
}

}  // namespace

// r, k, v, logw, do (B, T, H, 64) f32, u (H, 64), S0, dS (B, H, 64, 64) ->
// dr, dk, dv, dlogw (B, T, H, 64), du (H, 64), dS0 (B, H, 64, 64).  Scratch
// from the caller: ckS, ckdS (B * H * nck * 64 * 64 floats), du_part (B * H
// * nck * 64), nck = ceil(T / 64).  A null output is not written (du_part
// may be null only with du).
extern "C" int rwkv_wkv_bwd_launch(const float* r, const float* k, const float* v, const float* logw, const float* u,
                                   const float* S0, const float* dout, const float* dS, int B, int T, int H,
                                   float* dr, float* dk, float* dv, float* dlogw, float* du, float* dS0, float* ckS,
                                   float* ckdS, float* du_part, cudaStream_t stream) {
  if (B <= 0 || H <= 0) return 0;
  if (T <= 0) return (int)cudaErrorInvalidValue;
  const int nck = (T + kChunk - 1) / kChunk;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(wkv_bwd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kChunkSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  wkv_bwd_ckpt_kernel<<<dim3(kHead / kCkRows, B * H, 2), kCkThreads, 0, stream>>>(r, k, v, logw, dout, S0, dS, T,
                                                                                  H, nck, ckS, ckdS);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  wkv_bwd_chunk_kernel<<<dim3(nck, B * H), kChunkThreads, kChunkSmem, stream>>>(r, k, v, logw, u, dout, ckS, ckdS,
                                                                                T, H, nck, dr, dk, dv, dlogw, dS0,
                                                                                du_part);
  e = cudaGetLastError();
  if (e != cudaSuccess || du == nullptr) return (int)e;
  wkv_bwd_du_kernel<<<H, kHead, 0, stream>>>(du_part, B, H, nck, du);
  return (int)cudaGetLastError();
}
