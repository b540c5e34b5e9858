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
//
// The chunk form (wkv_bwd_chunk_plain), over chunks of 64 tokens as the
// forward's, fed by the forward's checkpoints ck (the state after each
// chunk, csrc/rwkv_wkv.cu).  Per chunk, with c = cumsum(logw) (inclusive),
// e its last token, q_f = r exp(c - logw), k_f = k exp(-c), dS_out the
// gradient of the state after the chunk, D = exp(c_e) ⊙_k dS_out,
// A = tril_-1(q_f k_f^T) + diag(sum r u k) and M = tril_-1(do v^T):
//   dS_in = exp(c_e) ⊙_k dS_out + q_f^T do
//   dr    = exp(c - logw) ⊙ (do S_in^T + M k_f) + u k (do . v)
//   dk    = exp(-c) ⊙ (v D^T + M^T q_f)         + r u (do . v)
//   dv    = k_f D + A^T do
//   dlogw_t = P + sum_{s>t} x_s - y_t,  y = k_f ⊙ (v D^T + M^T q_f),
//             x = q_f ⊙ (do S_in^T + M k_f) - y,  P = sum_v dS_out ⊙ S_out
// (x, y are r drS - k dkS and k dkS, drS and dkS the state parts of dr and
// dk: the token identity dlogw_t = dlogw_{t+1} + r_{t+1} drS_{t+1} - k_t
// dkS_t summed from the chunk's end, where P = dlogw_e + k_e dkS_e).  Each
// factor is kept apart from the products, as in the forward: the decay
// clamp logw >= -1.2 bounds exp(-c) by exp(76.8) over a chunk, q_f by |r|,
// k_f D by |k| |dS_out|, and the accumulators of do S_in^T + M k_f stay
// below ~1e35 before their scaling (3.4e38 is float32's limit).  Tokens
// past T load as zeros (logw = 0), which change nothing.
//
// Three launches:
// 1. wkv_bwd_state_kernel: the reverse state pass, a block per (b, h, half
//    of the value columns) walking the chunks from the last, as the
//    forward walks them from the first: 4 prep warps copy a chunk ahead
//    (cp.async) and form q_f^T and do^T into one of two buffer sets, 8
//    state warps hold dS (16 x 16 a warp, in registers), write it to dS_ck
//    (the gradient of each checkpoint), then fold in q_f^T do (mma.sync
//    TF32 in three passes) and exp(c_e) ⊙_k dS.  Named barriers hand the
//    sets over.  dS0 is the last dS.
// 2. wkv_bwd_chunk_kernel: a block per (chunk, b, h), 16 math warps (a 16 x
//    16 block of each output a warp) and 4 prep warps.  The prep warps copy
//    the chunk (do and v first, then r, k, logw, then S_in, dS_out and
//    S_out), hand do and v over, and form c, q_f, k_f, do . v, sum r u k,
//    the chunk's du sum, P and D while the math warps form M; then the
//    math warps form A, dr and dk (writing x and y) and, once A is whole,
//    dv; the prep warps sum dlogw in reverse from x and y.  Every product
//    is on mma.sync m16n8k8 TF32 in three passes (hi hi + lo hi + hi lo:
//    one pass misses the 1e-4 tolerance), the causal blocks skipped;
//    transposed operands (M^T, A^T, k_f, q_f, D and do along their rows)
//    are read with 4-byte loads, the rest with ldmatrix.  227 KB of shared
//    memory, one block an SM.
// 3. wkv_bwd_du_kernel: du summed over (b, chunk) in a fixed order.
// No atomics: the results are the same from run to run.  The sums run in
// other orders than the plain version's: the kernel is held to it within
// 1e-4 of each output's max |plain|.
//
// Bound on this card: bytes (r, k, v, logw, do read and dr, dk, dv, dlogw
// written once; S0, dS, dS0, u, du: 607 MB at rwkv6's training shape,
// 0.181 ms); the chunk form's products (~52 GFLOP in three TF32 passes)
// take ~0.1 ms at TF32's rate.  What holds it (H100 80GB HBM3 at 700 W,
// rwkv6's training shape, tools/recurrent_clocks.py): 0.60 ms, the state
// pass 0.12 and the chunks 0.47; the chunk kernel takes 0.30 ms without
// its products, 0.25 without its copies and 0.09 without both (--parts):
// with one block an SM, a block's copies and products run one after the
// other.  A second block an SM (under 113 KB of shared memory) or a
// persistent block copying the next chunk during the products would
// overlap them.

#include <cuda_runtime.h>
#include <cstdint>

#include "wkv_mma.cuh"

namespace {

constexpr int kChunk = 64;           // tokens a chunk: the forward's checkpoints are every 64
constexpr int kTile = kChunk * kLd;  // floats of a 64 x 64 tile kept with rows kLd apart
constexpr int kState4 = kHead * kHead;
constexpr int kGroups = 8;  // prep: token groups of 8 tokens; 16 lanes a group, 4 channels a lane
constexpr int kPrepWarps = 4;
constexpr int kPrep = 32 * kPrepWarps;
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kPrep == kGroups * kHead / 4, "prep: a thread 4 key channels of a token group");

// tools/recurrent_clocks.py --parts builds the chunk kernel without its
// products (-DWKV_WITHOUT_PRODUCTS), or without its copies and stores
// (-DWKV_WITHOUT_COPIES), to time the rest: the results are then wrong
#ifdef WKV_WITHOUT_PRODUCTS
constexpr bool kProducts = false;
#else
constexpr bool kProducts = true;
#endif
#ifdef WKV_WITHOUT_COPIES
constexpr bool kCopies = false;
#else
constexpr bool kCopies = true;
#endif

// the log2-decays of the prep thread's 4 key channels 4 cg .. of tokens
// 8 tg .. 8 tg + 7 (logw at w[t * ld + key], in place of the log2-decays
// here: w4[j]), each token group's sum through gsum; returns the running
// sum before the thread's first token
__device__ __forceinline__ float4 decays(const float* w, int ld, float* gsum, int cg, int tg, float4 (&w4)[8],
                                        int bar) {
  float4 c4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 x = *reinterpret_cast<const float4*>(w + (8 * tg + j) * ld + 4 * cg);
    w4[j] = make_float4(x.x * kLog2e, x.y * kLog2e, x.z * kLog2e, x.w * kLog2e);
    c4.x += w4[j].x, c4.y += w4[j].y, c4.z += w4[j].z, c4.w += w4[j].w;
  }
  *reinterpret_cast<float4*>(gsum + tg * kHead + 4 * cg) = c4;
  bar_sync(bar, kPrep);
  c4 = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int q = 0; q < tg; ++q) {
    const float4 x = *reinterpret_cast<const float4*>(gsum + q * kHead + 4 * cg);
    c4.x += x.x, c4.y += x.y, c4.z += x.z, c4.w += x.w;
  }
  return c4;
}

__device__ __forceinline__ float4 exp2_4(float4 x, float sign) {
  return make_float4(exp2_approx(sign * x.x), exp2_approx(sign * x.y), exp2_approx(sign * x.z),
                     exp2_approx(sign * x.w));
}

// sum x over the 16 lanes of a token group (lanes 2 j and 2 j + 1 of the
// half-warp end with token 8 tg + j's sum) into out[8 tg + j]
__device__ __forceinline__ void group_sums(float (&x)[8], int lane, int tg, float* out) {
  fold<8, 4>(x, lane);
  fold<4, 2>(x, lane);
  fold<2, 1>(x, lane);
  x[0] += __shfl_xor_sync(0xffffffffu, x[0], 1);
  if (lane % 2 == 0) out[8 * tg + lane % 16 / 2] = x[0];
}

// ---------------------------------------------------------------------------
// 1. the reverse state pass
// ---------------------------------------------------------------------------

constexpr int kHalves = 2;              // value-column halves, a block each
constexpr int kCols = kHead / kHalves;  // value columns a block
constexpr int kStateWarps = 8;          // a 16 x 16 block of dS's (64 x kCols) each
constexpr int kState = 32 * kStateWarps;
constexpr int kStateThreads = kState + kPrep;
// shared memory (floats): two staging sets of r, logw [token][key] and do
// [token][column] as copied; two sets of q_f^T [key][token] and do^T
// [column][token] (rows kLd apart); the token groups' decays; per set,
// exp(c_e) [key]
constexpr int kStageFloats = 2 * kChunk * kHead + kChunk * kCols;
constexpr int kStateSmem = 4 * (2 * kStageFloats + 2 * kTile + 2 * kCols * kLd + kGroups * kHead + 2 * kHead);
// named barriers (0 is __syncthreads'): a set full (one a set), a set
// empty (one a set), the prep warps'
constexpr int kSFull = 1, kSEmpty = 3, kSPrepBar = 5;

static_assert(kPrep == 4 * kCols, "prep: do^T a thread a column and 16 tokens");

// grid (H * kHalves, B).  dS_ck (B, H, nck, 64, 64): the gradient of the
// state after each chunk (the last: dS itself); dS0 may be null.
__global__ void __launch_bounds__(kStateThreads, 1)
    wkv_bwd_state_kernel(const float* __restrict__ r, const float* __restrict__ logw, const float* __restrict__ dout,
                         const float* __restrict__ dS, int T, int H, float* __restrict__ dS_ck,
                         float* __restrict__ dS0) {
  extern __shared__ __align__(16) float smem[];
  float* raws = smem;                   // two staging sets
  float* Qts = raws + 2 * kStageFloats;  // two sets of q_f^T
  float* Dts = Qts + 2 * kTile;          // two sets of do^T
  float* gsum = Dts + 2 * kCols * kLd;   // [group][key]
  float* eces = gsum + kGroups * kHead;  // per set: [key] exp(c_e)

  const int half = blockIdx.x % kHalves;
  const int h = blockIdx.x / kHalves;
  const size_t b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const size_t tok_stride = (size_t)H * kHead;
  const size_t head_base = (b * T * H + h) * kHead;  // r[b, 0, h, 0]
  const size_t state_base = (b * H + h) * kState4;   // dS[b, h, 0, 0]
  const int n_chunks = (T + kChunk - 1) / kChunk;

  if (warp >= kStateWarps) {  // the prep warps
    const int pt = tid - kState;
    auto load = [&](int ci, float* raw) {  // chunk ci's rows, zeros past T
      const int t0 = ci * kChunk;
#pragma unroll
      for (int i = 0; i < kChunk * kHead / 4 / kPrep; ++i) {
        const int p = pt + i * kPrep, row = p / 16, c4 = (p % 16) * 4;
        const bool in = t0 + row < T;
        const size_t off = head_base + (size_t)(in ? t0 + row : 0) * tok_stride + c4;
        cp16(raw + row * kHead + c4, r + off, in);
        cp16(raw + kChunk * kHead + row * kHead + c4, logw + off, in);
      }
#pragma unroll
      for (int i = 0; i < kChunk * kCols / 4 / kPrep; ++i) {
        const int p = pt + i * kPrep, row = p / 8, c4 = (p % 8) * 4;
        const bool in = t0 + row < T;
        cp16(raw + 2 * kChunk * kHead + row * kCols + c4,
             dout + head_base + (size_t)(in ? t0 + row : 0) * tok_stride + half * kCols + c4, in);
      }
      asm volatile("cp.async.commit_group;" ::: "memory");
    };
    load(n_chunks - 1, raws);
    const int cg = pt % 16, tg = pt / 16;
    for (int w = 0; w < n_chunks; ++w) {  // the w-th chunk walked: chunk n_chunks - 1 - w
      const int ci = n_chunks - 1 - w, set = w % 2;
      const float* raw_r = raws + set * kStageFloats;
      const float* raw_w = raw_r + kChunk * kHead;
      const float* raw_d = raw_w + kChunk * kHead;
      float* Qt = Qts + set * kTile;
      float* Dt = Dts + set * kCols * kLd;
      float* ece = eces + set * kHead;
      asm volatile("cp.async.wait_group 0;" ::: "memory");
      bar_sync(kSPrepBar, kPrep);  // the chunk has landed; every read of the other staging set is done
      if (w + 1 < n_chunks) load(ci - 1, raws + (1 - set) * kStageFloats);
      if (w >= 2) bar_sync(kSEmpty + set, kStateThreads);  // the state warps are done with this set
      float4 w4[8];
      float4 c4 = decays(raw_w, kHead, gsum, cg, tg, w4, kSPrepBar);
      float q[4][8];  // q_f of the thread's 4 keys and 8 tokens, stored transposed
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 e = exp2_4(c4, 1.f);  // exp(c_{t-1})
        c4.x += w4[j].x, c4.y += w4[j].y, c4.z += w4[j].z, c4.w += w4[j].w;
        const float4 rr = *reinterpret_cast<const float4*>(raw_r + (8 * tg + j) * kHead + 4 * cg);
        q[0][j] = rr.x * e.x, q[1][j] = rr.y * e.y, q[2][j] = rr.z * e.z, q[3][j] = rr.w * e.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* row = Qt + (4 * cg + i) * kLd + 8 * tg;
        *reinterpret_cast<float4*>(row) = make_float4(q[i][0], q[i][1], q[i][2], q[i][3]);
        *reinterpret_cast<float4*>(row + 4) = make_float4(q[i][4], q[i][5], q[i][6], q[i][7]);
      }
      if (tg == kGroups - 1) *reinterpret_cast<float4*>(ece + 4 * cg) = exp2_4(c4, 1.f);  // exp(c_e)
      {  // do^T: a thread a column and 16 tokens, 4 at a time
        const int c = pt % kCols, s0 = (pt / kCols) * 16;
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4) {
          const int s = s0 + 4 * q4;
          *reinterpret_cast<float4*>(Dt + c * kLd + s) =
              make_float4(raw_d[s * kCols + c], raw_d[(s + 1) * kCols + c], raw_d[(s + 2) * kCols + c],
                          raw_d[(s + 3) * kCols + c]);
        }
      }
      bar_arrive(kSFull + set, kStateThreads);
    }
  } else {  // the state warps: keys 16 mo .., the half's columns n0 .. n0 + 15
    const int mo = warp / 2, n0 = (warp % 2) * 16;
    auto at = [&](int nt, int e) { return (size_t)(16 * mo + g + 8 * e) * kHead + half * kCols + n0 + 8 * nt + 2 * t4; };
    float st[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float2 s = *reinterpret_cast<const float2*>(dS + state_base + at(nt, e));
        st[nt][2 * e] = s.x, st[nt][2 * e + 1] = s.y;
      }
    for (int w = 0; w < n_chunks; ++w) {
      const int ci = n_chunks - 1 - w, set = w % 2;
      float* out = dS_ck + state_base * n_chunks + (size_t)ci * kState4;  // the gradient of the state after chunk ci
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          *reinterpret_cast<float2*>(out + at(nt, e)) = make_float2(st[nt][2 * e], st[nt][2 * e + 1]);
      const float* Qt = Qts + set * kTile;
      const float* Dt = Dts + set * kCols * kLd;
      const float* ece = eces + set * kHead;
      bar_sync(kSFull + set, kStateThreads);
      Acc<2> pr;  // q_f^T do
      pr.product([&](uint32_t(&x)[4], int ks) { ldsm4(x, Qt, 16 * mo, 8 * ks, lane); },
                 [&](uint32_t(&bb)[2][2], int ks) { ldsm_b<2>(bb, Dt, n0, 8 * ks, lane); });
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float dd = ece[16 * mo + g + 8 * (x / 2)];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) st[nt][x] = fmaf(dd, st[nt][x], pr.at(nt, x));
      }
      if (w + 2 < n_chunks) bar_arrive(kSEmpty + set, kStateThreads);  // the set is free for the chunk after next
    }
    if (dS0) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          *reinterpret_cast<float2*>(dS0 + state_base + at(nt, e)) = make_float2(st[nt][2 * e], st[nt][2 * e + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// 2. the chunks
// ---------------------------------------------------------------------------

constexpr int kMathWarps = 16;  // a 16 x 16 block of each 64 x 64 output a warp
constexpr int kMath = 32 * kMathWarps;
constexpr int kChunkThreads = kMath + kPrep;
// 64 x 64 tiles (rows kLd apart): r, k as copied; logw, then c (log2,
// inclusive) in place; q_f, k_f; do, v; S_in, D (dS_out, then scaled in
// place); A, M; S_out, then x; y
enum { kR, kK, kC, kQF, kKF, kDO, kV, kSIN, kDT, kA, kM, kX, kY, kTiles };
// then u, do . v, sum r u k, P, exp(c_e) (64 each) and the token groups'
// sums (kGroups x 64)
constexpr int kChunkSmem = 4 * (kTiles * kTile + 5 * kHead + kGroups * kHead);
// named barriers: do and v landed; the prep done; x and y written; the
// math warps'; the prep warps'
constexpr int kLoaded = 1, kPrepped = 2, kXReady = 3, kMathBar = 4, kPrepBar = 5;

static_assert(kChunkSmem <= 232448, "one block an SM");

// the B fragments of N 8-column tiles of a tile kept as [k][n] (rows kLd
// apart): element (k = c0 + t4 (+ 4), n = n0 + 8 n + g)
template <int N>
__device__ __forceinline__ void col_b(uint32_t (&b)[N][2], const float* m, int n0, int c0, int g, int t4) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const float* p = m + (c0 + t4) * kLd + n0 + 8 * n + g;
    b[n][0] = __float_as_uint(p[0]), b[n][1] = __float_as_uint(p[4 * kLd]);
  }
}

// the A fragment of rows r0 .., columns c0 .. of the transpose of a tile
// kept row by row: element (r0 + g (+ 8), c0 + t4 (+ 4)) at m[c][r]
__device__ __forceinline__ void col_a(uint32_t (&x)[4], const float* m, int r0, int c0, int g, int t4) {
  const float* p = m + (c0 + t4) * kLd + r0 + g;
  x[0] = __float_as_uint(p[0]), x[1] = __float_as_uint(p[8]), x[2] = __float_as_uint(p[4 * kLd]),
  x[3] = __float_as_uint(p[4 * kLd + 8]);
}

// grid (nck, B * H).  ck, dS_ck (B, H, nck, 64, 64); outputs (B, T, H, 64);
// du_part (B * H, nck, 64).  A null output is not written.
__global__ void __launch_bounds__(kChunkThreads, 1)
    wkv_bwd_chunk_kernel(const float* __restrict__ r, const float* __restrict__ k, const float* __restrict__ v,
                         const float* __restrict__ logw, const float* __restrict__ u, const float* __restrict__ dout,
                         const float* __restrict__ S0, const float* __restrict__ ck,
                         const float* __restrict__ dS_ck, int T, int H, float* __restrict__ dr,
                         float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dlogw,
                         float* __restrict__ du_part) {
  extern __shared__ __align__(16) float smem[];
  float* R = smem + kR * kTile;
  float* K = smem + kK * kTile;
  float* C = smem + kC * kTile;
  float* QF = smem + kQF * kTile;
  float* KF = smem + kKF * kTile;
  float* DO = smem + kDO * kTile;
  float* V = smem + kV * kTile;
  float* SIN = smem + kSIN * kTile;
  float* DT = smem + kDT * kTile;
  float* A = smem + kA * kTile;
  float* M = smem + kM * kTile;
  float* X = smem + kX * kTile;
  float* Y = smem + kY * kTile;
  float* U = smem + kTiles * kTile;
  float* dov = U + kHead;
  float* ruk = dov + kHead;
  float* pe = ruk + kHead;
  float* ece = pe + kHead;
  float* gsum = ece + kHead;

  const int ci = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int n_chunks = gridDim.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int t0 = ci * kChunk;
  const size_t tok_stride = (size_t)H * kHead;
  const size_t head_base = ((size_t)b * T * H + h) * kHead;  // r[b, 0, h, 0]
  const size_t ck_base = ((size_t)bh * n_chunks + ci) * kState4;  // ck[b, h, ci]

  if (warp >= kMathWarps) {  // the prep warps
    const int pt = tid - kMath;
    auto tokens = [&](float* dst, const float* src) {  // the chunk's 64 tokens of a (B, T, H, 64), zeros past T
#pragma unroll
      for (int i = 0; i < kChunk * kHead / 4 / kPrep; ++i) {
        const int p = pt + i * kPrep, row = p / 16, c4 = (p % 16) * 4;
        const bool in = t0 + row < T;
        cp16(dst + row * kLd + c4, src + head_base + (size_t)(in ? t0 + row : 0) * tok_stride + c4, in);
      }
    };
    auto state = [&](float* dst, const float* src) {  // a (64, 64) state
#pragma unroll
      for (int i = 0; i < kState4 / 4 / kPrep; ++i) {
        const int p = pt + i * kPrep, row = p / 16, c4 = (p % 16) * 4;
        cp16(dst + row * kLd + c4, src + row * kHead + c4, true);
      }
    };
    if (kCopies) {
      tokens(DO, dout), tokens(V, v);
      asm volatile("cp.async.commit_group;" ::: "memory");
      tokens(R, r), tokens(K, k), tokens(C, logw);
      asm volatile("cp.async.commit_group;" ::: "memory");
      state(SIN, ci == 0 ? S0 + (size_t)bh * kState4 : ck + ck_base - kState4);
      state(DT, dS_ck + ck_base);
      state(X, ck + ck_base);  // S_out, for P
      asm volatile("cp.async.commit_group;" ::: "memory");
      asm volatile("cp.async.wait_group 2;" ::: "memory");
    }
    bar_sync(kPrepBar, kPrep);
    bar_arrive(kLoaded, kChunkThreads);  // do and v, to the math warps
    const int cg = pt % 16, tg = pt / 16;
    {  // do . v
      float x[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int t = 8 * tg + j;
        const float4 d = *reinterpret_cast<const float4*>(DO + t * kLd + 4 * cg);
        const float4 y = *reinterpret_cast<const float4*>(V + t * kLd + 4 * cg);
        x[j] = d.x * y.x + d.y * y.y + d.z * y.z + d.w * y.w;
      }
      group_sums(x, lane, tg, dov);
    }
    if (pt < kHead) U[pt] = u[(size_t)h * kHead + pt];
    if (kCopies) asm volatile("cp.async.wait_group 1;" ::: "memory");
    bar_sync(kPrepBar, kPrep);  // r, k, logw landed; do . v written
    float4 w4[8];
    float4 c4 = decays(C, kLd, gsum, cg, tg, w4, kPrepBar);
    const float4 u4 = *reinterpret_cast<const float4*>(U + 4 * cg);
    float x[8];
    float4 du4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int t = 8 * tg + j;
      const float4 e = exp2_4(c4, 1.f);  // exp(c_{t-1})
      c4.x += w4[j].x, c4.y += w4[j].y, c4.z += w4[j].z, c4.w += w4[j].w;
      const float4 f = exp2_4(c4, -1.f);  // exp(-c_t)
      const float4 rr = *reinterpret_cast<const float4*>(R + t * kLd + 4 * cg);
      const float4 kk = *reinterpret_cast<const float4*>(K + t * kLd + 4 * cg);
      *reinterpret_cast<float4*>(C + t * kLd + 4 * cg) = c4;
      *reinterpret_cast<float4*>(QF + t * kLd + 4 * cg) = make_float4(rr.x * e.x, rr.y * e.y, rr.z * e.z, rr.w * e.w);
      *reinterpret_cast<float4*>(KF + t * kLd + 4 * cg) = make_float4(kk.x * f.x, kk.y * f.y, kk.z * f.z, kk.w * f.w);
      x[j] = rr.x * u4.x * kk.x + rr.y * u4.y * kk.y + rr.z * u4.z * kk.z + rr.w * u4.w * kk.w;
      const float d = dov[t];
      du4.x = fmaf(rr.x * kk.x, d, du4.x), du4.y = fmaf(rr.y * kk.y, d, du4.y);
      du4.z = fmaf(rr.z * kk.z, d, du4.z), du4.w = fmaf(rr.w * kk.w, d, du4.w);
    }
    if (tg == kGroups - 1) *reinterpret_cast<float4*>(ece + 4 * cg) = exp2_4(c4, 1.f);  // exp(c_e)
    group_sums(x, lane, tg, ruk);
    bar_sync(kPrepBar, kPrep);  // every read of the group decays is done
    *reinterpret_cast<float4*>(gsum + tg * kHead + 4 * cg) = du4;
    if (kCopies) asm volatile("cp.async.wait_group 0;" ::: "memory");
    bar_sync(kPrepBar, kPrep);  // S_in, dS_out and S_out landed; the du sums and exp(c_e) written
    if (du_part && pt < kHead) {  // the chunk's du: the token groups in order
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kGroups; ++q) s += gsum[q * kHead + pt];
      du_part[((size_t)bh * n_chunks + ci) * kHead + pt] = s;
    }
    {  // P = sum_v dS_out S_out, and D = exp(c_e) dS_out in place: a thread half a row
      const int row = pt / 2, v0 = (pt % 2) * (kHead / 2);
      const float e = ece[row];
      float p = 0.f;
#pragma unroll
      for (int q = 0; q < kHead / 8; ++q) {
        float4* d = reinterpret_cast<float4*>(DT + row * kLd + v0 + 4 * q);
        const float4 s = *reinterpret_cast<const float4*>(X + row * kLd + v0 + 4 * q);
        const float4 y = *d;
        p = fmaf(y.x, s.x, p), p = fmaf(y.y, s.y, p), p = fmaf(y.z, s.z, p), p = fmaf(y.w, s.w, p);
        *d = make_float4(e * y.x, e * y.y, e * y.z, e * y.w);
      }
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      if (pt % 2 == 0) pe[row] = p;
    }
    bar_arrive(kPrepped, kChunkThreads);
    // dlogw_t = P + sum_{s>t} x_s - y_t: a thread a column and half the
    // tokens, the upper half's sum of x handed to the lower half
    bar_sync(kXReady, kChunkThreads);
    const int kc = pt % kHead, hf = pt / kHead, tb = hf * (kChunk / 2);
    float sx = 0.f;
    for (int t = tb; t < tb + kChunk / 2; ++t) sx += X[t * kLd + kc];
    if (hf == 1) gsum[kc] = sx;
    bar_sync(kPrepBar, kPrep);
    float acc = pe[kc] + (hf == 0 ? gsum[kc] : 0.f);
    for (int t = tb + kChunk / 2 - 1; t >= tb; --t) {
      const float dl = acc - Y[t * kLd + kc];
      if (kCopies && dlogw && t0 + t < T) dlogw[head_base + (size_t)(t0 + t) * tok_stride + kc] = dl;
      acc += X[t * kLd + kc];
    }
    return;
  }

  // the math warps: rows (tokens) r0 .. r0 + 15, columns n0 .. n0 + 15
  const int i = warp / 4, r0 = 16 * i, n0 = 16 * (warp % 4);
  const bool lower = warp % 4 <= i;  // the block is on or below the diagonal
  auto ld_a = [&](const float* m) { return [=](uint32_t(&x)[4], int ks) { ldsm4(x, m, r0, 8 * ks, lane); }; };
  auto ld_b = [&](const float* m) { return [=](uint32_t(&bb)[2][2], int ks) { ldsm_b<2>(bb, m, n0, 8 * ks, lane); }; };
  auto col_at = [&](const float* m) { return [=](uint32_t(&x)[4], int ks) { col_a(x, m, r0, 8 * ks, g, t4); }; };
  auto col_bt = [&](const float* m) { return [=](uint32_t(&bb)[2][2], int ks) { col_b<2>(bb, m, n0, 8 * ks, g, t4); }; };
  // element e of tile nt of a warp's accumulators: row r0 + g + 8 (e / 2),
  // column n0 + 8 nt + 2 t4 + e % 2
  auto row_of = [&](int e) { return r0 + g + 8 * (e / 2); };
  auto col_of = [&](int nt, int e) { return n0 + 8 * nt + 2 * t4 + e % 2; };
  // a lower block's product, masked below the diagonal, diag on it
  auto store_lower = [&](float* dst, const Acc<2>& p, const float* diag) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int t = row_of(e), s = col_of(nt, e);
        const float d = diag ? diag[t] : 0.f;
        const float y0 = s < t ? p.at(nt, e) : s == t ? d : 0.f;
        const float y1 = s + 1 < t ? p.at(nt, e + 1) : s + 1 == t ? d : 0.f;
        *reinterpret_cast<float2*>(dst + t * kLd + s) = make_float2(y0, y1);
      }
  };
  // an output pair (e, e + 1) of tile nt into a (B, T, H, 64) tensor
  auto store_out = [&](float* dst, int nt, int e, float y0, float y1) {
    const int t = row_of(e);
    if (kCopies && dst && t0 + t < T)
      *reinterpret_cast<float2*>(dst + head_base + (size_t)(t0 + t) * tok_stride + col_of(nt, e)) =
          make_float2(y0, y1);
  };

  bar_sync(kLoaded, kChunkThreads);
  if (lower) {  // M = do v^T
    Acc<2> pm;
    if (kProducts) pm.product(ld_a(DO), ld_b(V));
    store_lower(M, pm, nullptr);
  }
  bar_sync(kMathBar, kMath);              // M whole
  bar_sync(kPrepped, kChunkThreads);      // c, q_f, k_f, D, do . v, sum r u k, u
  if (lower) {  // A = q_f k_f^T, sum r u k on the diagonal
    Acc<2> pa;
    if (kProducts) pa.product(ld_a(QF), ld_b(KF));
    store_lower(A, pa, ruk);
  }
  float xr[2][4];  // q_f ⊙ (do S_in^T + M k_f)
  {  // dr = exp(c_{t-1}) ⊙ (do S_in^T + M k_f) + u k (do . v)
    Acc<2> pr;
    if (kProducts) {
      pr.product(ld_a(DO), ld_b(SIN));
      pr.product(ld_a(M), col_bt(KF), 2 * (i + 1));
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        float y[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int t = row_of(e), kc = col_of(nt, e + q);
          const float a = pr.at(nt, e + q);
          const float before = t > 0 ? exp2_approx(C[(t - 1) * kLd + kc]) : 1.f;
          y[q] = fmaf(before, a, U[kc] * K[t * kLd + kc] * dov[t]);
          xr[nt][e + q] = QF[t * kLd + kc] * a;
        }
        store_out(dr, nt, e, y[0], y[1]);
      }
  }
  {  // dk = exp(-c) ⊙ (v D^T + M^T q_f) + r u (do . v); x and y
    Acc<2> pk;
    if (kProducts) {
      pk.product(ld_a(V), ld_b(DT));
      pk.product(col_at(M), col_bt(QF), kChunk / 8, 2 * i);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        float y[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int t = row_of(e), kc = col_of(nt, e + q);
          const float a = pk.at(nt, e + q);
          y[q] = fmaf(exp2_approx(-C[t * kLd + kc]), a, R[t * kLd + kc] * U[kc] * dov[t]);
          const float yy = KF[t * kLd + kc] * a;
          X[t * kLd + kc] = xr[nt][e + q] - yy;
          Y[t * kLd + kc] = yy;
        }
        store_out(dk, nt, e, y[0], y[1]);
      }
  }
  bar_arrive(kXReady, kChunkThreads);
  bar_sync(kMathBar, kMath);  // A whole
  if (dv) {  // dv = k_f D + A^T do
    Acc<2> pv;
    if (kProducts) {
      pv.product(ld_a(KF), col_bt(DT));
      pv.product(col_at(A), col_bt(DO), kChunk / 8, 2 * i);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; e += 2) store_out(dv, nt, e, pv.at(nt, e), pv.at(nt, e + 1));
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

// r, k, v, logw, do (B, T, H, 64) f32, u (H, 64), S0, dS (B, H, 64, 64) and
// the forward's checkpoints ck (B, H, nck, 64, 64), nck = ceil(T / 64): the
// state after each chunk of 64 tokens, the last the final state ->
// dr, dk, dv, dlogw (B, T, H, 64), du (H, 64), dS0 (B, H, 64, 64).  Scratch
// from the caller: dS_ck (as ck), du_part (B * H * nck * 64 floats; may be
// null only with du).  A null output is not written.  Every pointer
// 16-byte aligned.
extern "C" int rwkv_wkv_bwd_launch(const float* r, const float* k, const float* v, const float* logw, const float* u,
                                   const float* S0, const float* dout, const float* dS, const float* ck, int B, int T,
                                   int H, float* dr, float* dk, float* dv, float* dlogw, float* du, float* dS0,
                                   float* dS_ck, float* du_part, cudaStream_t stream) {
  if (B <= 0 || H <= 0) return 0;
  if (T <= 0) return (int)cudaErrorInvalidValue;
  const auto off16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  const void* ptrs[] = {r, k, v, logw, u, S0, dout, dS, ck, dr, dk, dv, dlogw, dS0, dS_ck};
  for (const void* p : ptrs)
    if (off16(p)) return (int)cudaErrorMisalignedAddress;
  const int nck = (T + kChunk - 1) / kChunk;
  static bool configured = false;
  if (!configured) {
    cudaError_t e =
        cudaFuncSetAttribute(wkv_bwd_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kStateSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(wkv_bwd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kChunkSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  wkv_bwd_state_kernel<<<dim3(H * kHalves, B), kStateThreads, kStateSmem, stream>>>(r, logw, dout, dS, T, H, dS_ck,
                                                                                     dS0);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  wkv_bwd_chunk_kernel<<<dim3(nck, B * H), kChunkThreads, kChunkSmem, stream>>>(r, k, v, logw, u, dout, S0, ck, dS_ck,
                                                                                 T, H, dr, dk, dv, dlogw, du_part);
  e = cudaGetLastError();
  if (e != cudaSuccess || du == nullptr) return (int)e;
  wkv_bwd_du_kernel<<<H, kHead, 0, stream>>>(du_part, B, H, nck, du);
  return (int)cudaGetLastError();
}
