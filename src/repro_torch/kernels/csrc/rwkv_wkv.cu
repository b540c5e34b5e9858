// rwkv_wkv: the RWKV-6 WKV recurrence of a head, for sm_90a.
//
// No TPU kernel: it replaces the recurrence that the reference leaves to
// XLA in repro/models/recurrent.py (rwkv_time_mix): the lax.scan of
// chunk_step over chunks of 64 tokens, and the single step at T = 1.
//
// Semantics (repro_torch.kernels.rwkv_wkv.wkv_plain): for each batch row b
// and head h, the state S (hd_k, hd_v) starts at S0[b, h] and, for t in
// order,
//   o[b, t, h, v] = sum_k r_k (u[h, k] k_k v_v + S[k, v])
//   S[k, v]       = exp(logw_k) S[k, v] + k_k v_v
// with r, k, v, logw those of token t (logw clamped by the caller to
// [-1.2, 0)); S after the last token goes to S[b, h].
//
// Prefill (T > 1) computes the reference's factored chunk form, as the
// plain version does: per chunk of 64 tokens and key channel d,
// c = cumsum(logw), q_f = r exp(c - logw), k_f = k exp(-c), and
//   o = (strictly lower (q_f k_f^T) + diag(sum_d r u k)) v + q_f S
//   S = exp(c_last) S + exp(c_last) (k_f^T v)
// (the two terms scaled apart: k_f^T v reaches ~1e33 where S is ~1).  The
// clamp keeps exp(-c) <= exp(76.8) over a chunk, so the form is
// float32-safe.  Tokens past T load as zeros (k = r = v = logw = 0), which
// leave S as it is.  The four 64-wide products run on the tensor cores
// (mma.sync m16n8k8 TF32) in three passes, each float32 operand split into
// its leading 10 mantissa bits and the rest (hi lo + lo hi + hi hi): one
// pass keeps 10 bits and misses the 1e-4 tolerance (3-8e-4 of max |o| in
// a float64 rehearsal of the form), three keep ~21 (1e-6).  The causal
// mask skips the upper triangle of q_f k_f^T and of the product with v.
// The sums run in other orders than the plain version's: the kernel is
// held to it within 1e-4 of max |o| (and of max |S|).
//
// Design.  A block per (b, h, half of the 64 value columns), walking its
// chunks in order (a chunk's outputs need the state the chunk before
// left).  The block's warps are split by role, so that the elementwise
// work of one chunk runs beside the products of the one before:
//   - 4 prep warps: the next chunk's r, k, v and logw copied by cp.async
//     (16 bytes a piece, zero-filled past T) into the other of two staging
//     sets; then, a thread owning 4 key channels of 8 tokens (16-byte
//     loads and stores), the cumulative log2-decays (the 8 token groups'
//     sums through shared memory), q_f, k_f, sum_d r u k (shuffles over
//     the 16 lanes of a token group) and exp(c_last), and v transposed,
//     into one of two buffer sets;
//   - 16 math warps, 8 owning two 16 x 8 tiles of o each and 8 two tiles
//     of S (kept in registers for the whole walk).  Before a barrier of
//     the math warps: q_f k_f^T on its 20 lower 16 x 8 tiles, masked, with
//     sum_d r u k on the diagonal, into A (two tiles of a row block a
//     state warp, one tile each the first four output warps), and q_f S
//     into the output tiles.  After it: A v into the output tiles over
//     the tokens up to each tile's last row, and o stored; k_f^T v folded
//     into the state tiles, S = exp(c_last) S + exp(c_last) (k_f^T v), and
//     S^T stored for the next chunk.  The products are so split that the
//     longest warp of each side of the barrier does at most three 64-deep
//     16 x 8 products.
// Named barriers hand each buffer set from the prep warps to the math
// warps (full) and back (empty).  Fragments are loaded by ldmatrix, four
// 8 x 4 float32 blocks an instruction (tiles kept row by row with rows 68
// floats apart, free of bank conflicts; v and S kept transposed for
// that), but k_f read column-wise for k_f^T v (four 4-byte loads, two-way
// conflicts).  Tiles stay in float32 and are split into TF32 parts in
// registers.  The three passes go pass by pass over a warp's tiles, each
// into its own accumulators, so that no mma waits on the one before it
// (~24 cycles), and a k-step's fragments are loaded while the one before
// is folded in.  226 KB of dynamic shared memory, one block an SM.
//
// What holds it on this card: the copies and the products, each taking
// most of the kernel's time on its own, overlap only in part
// (tools/recurrent_clocks.py --parts times the kernel without each).  More warps in flight helped (8
// to 16 math warps); fewer and wider warp tiles did not, nor did bfloat16
// parts (hi + mid, three products at half the mma count: more conversions
// and loads), nor clusters of the two halves sharing q_f, k_f and A
// through distributed shared memory (their release fences cost more than
// the shared work saved).
//
// Decode (T = 1) takes the token form in the same kernel, launched with
// 128 threads: a thread a 4 x 4 tile of S, the partial outputs summed
// through shared memory.
//
// Checkpoints: given ck (the training step's forward, RWKVWKV), the state
// warps also store the state after each chunk, which they hold anyway,
// into ck; csrc/rwkv_wkv_bwd.cu starts each chunk's gradient from them.
// Without ck (serving) nothing else changes: o and S are the same bit for
// bit either way.
//
// Bound on this card: bytes (r, k, v and logw read once, o written once,
// S read and written once).  The chunk form's products are ~4x the token
// form's operations, three times over on the tensor cores.

#include <cuda_runtime.h>
#include <cstdint>

#include "wkv_mma.cuh"

namespace {

constexpr int kHalves = 2;              // value-column halves, a block each
constexpr int kCols = kHead / kHalves;  // value columns a block
constexpr int kChunk = 64;              // tokens a chunk (the reference's)
constexpr int kMathWarps = 16;
constexpr int kPrepWarps = 4;
constexpr int kMath = kMathWarps * 32;
constexpr int kPrep = kPrepWarps * 32;
constexpr int kThreads = kMath + kPrep;
constexpr int kGroups = 8;  // prep: token groups of 8 tokens; 16 lanes a group, 4 channels a lane
constexpr float kLog2e = 1.4426950408889634f;

// named barriers (0 is __syncthreads'): a buffer set full (one a set), a
// buffer set empty (one a set), the math warps', the prep warps'
constexpr int kFull = 1, kEmpty = 3, kMathBar = 5, kPrepBar = 6;

// tools/recurrent_clocks.py --parts builds the kernel without its four
// products (-DWKV_WITHOUT_PRODUCTS), or without its copies and the stores
// of o (-DWKV_WITHOUT_COPIES), to time the rest: the results are then
// wrong, and the launch's time is what the part left out costs
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

static_assert(kPrep == kGroups * kHead / 4, "prep: a thread 4 key channels of a token group");
static_assert(kPrep == 4 * kCols, "prep: v^T a thread a column and 16 tokens");

// dynamic shared memory (floats): two staging sets of r, k, logw, v as
// copied; two sets of q_f and of k_f, and A (64 x kLd each); two sets of
// v^T, and S^T (32 x kLd each); the token groups' decays; per set,
// sum_d r u k and exp(c_last)
constexpr int kRawFloats = 3 * kChunk * kHead + kChunk * kCols;
constexpr int kWideFloats = kChunk * kLd;
constexpr int kNarrowFloats = kCols * kLd;
constexpr int kSetSmall = 2 * kChunk;
constexpr int kSmemBytes =
    4 * (2 * kRawFloats + 5 * kWideFloats + 3 * kNarrowFloats + kGroups * kHead + 2 * kSetSmall);

// the token form of one step (T = 1), on kTokenThreads threads: a thread a
// 4 x 4 tile of S (4 key rows, 4 of the half's value columns, 16-byte
// loads and stores), the partial outputs and sum_d r u k summed through
// part (kTokenPart floats of shared memory)
constexpr int kTokenThreads = (kHead / 4) * (kCols / 4);
constexpr int kTokenPart = (kHead / 4) * kCols + kHead / 4;

__device__ void token_step(const float* __restrict__ r, const float* __restrict__ k, const float* __restrict__ v,
                           const float* __restrict__ logw, const float* __restrict__ u,
                           const float* __restrict__ S0, int H, float* __restrict__ o, float* __restrict__ S,
                           float* __restrict__ ck, float* part) {
  constexpr int kKeyGroups = kHead / 4;
  const int half = blockIdx.x % kHalves;
  const int h = blockIdx.x / kHalves;
  const size_t b = blockIdx.y;
  const int cg = threadIdx.x % (kCols / 4), kg = threadIdx.x / (kCols / 4);
  const size_t head = (b * H + h) * kHead;  // r[b, 0, h, 0]
  const size_t state = head * kHead;        // S0[b, h, 0, 0]
  const int c0 = half * kCols + 4 * cg, d0 = 4 * kg;
  const float4 r4 = *reinterpret_cast<const float4*>(r + head + d0);
  const float4 k4 = *reinterpret_cast<const float4*>(k + head + d0);
  const float4 w4 = *reinterpret_cast<const float4*>(logw + head + d0);
  const float4 v4 = *reinterpret_cast<const float4*>(v + head + c0);
  const float rs[4] = {r4.x, r4.y, r4.z, r4.w}, ks[4] = {k4.x, k4.y, k4.z, k4.w};
  const float ws[4] = {expf(w4.x), expf(w4.y), expf(w4.z), expf(w4.w)};
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const size_t at = state + (size_t)(d0 + j) * kHead + c0;
    const float4 s = *reinterpret_cast<const float4*>(S0 + at);
    acc = make_float4(fmaf(rs[j], s.x, acc.x), fmaf(rs[j], s.y, acc.y), fmaf(rs[j], s.z, acc.z),
                      fmaf(rs[j], s.w, acc.w));
    const float4 next = make_float4(fmaf(ws[j], s.x, ks[j] * v4.x), fmaf(ws[j], s.y, ks[j] * v4.y),
                                    fmaf(ws[j], s.z, ks[j] * v4.z), fmaf(ws[j], s.w, ks[j] * v4.w));
    *reinterpret_cast<float4*>(S + at) = next;
    if (ck) *reinterpret_cast<float4*>(ck + at) = next;  // one chunk: its checkpoint is the final state
  }
  *reinterpret_cast<float4*>(part + kg * kCols + 4 * cg) = acc;
  if (cg == 0) {
    const float4 u4 = *reinterpret_cast<const float4*>(u + (size_t)h * kHead + d0);
    part[kKeyGroups * kCols + kg] = r4.x * u4.x * k4.x + r4.y * u4.y * k4.y + r4.z * u4.z * k4.z + r4.w * u4.w * k4.w;
  }
  __syncthreads();
  if (threadIdx.x < kCols) {  // value column c of the half
    const int c = threadIdx.x;
    float ruk = 0.f;
#pragma unroll
    for (int q = 0; q < kKeyGroups; ++q) ruk += part[kKeyGroups * kCols + q];
    float sum = ruk * v[head + half * kCols + c];
#pragma unroll
    for (int q = 0; q < kKeyGroups; ++q) sum += part[q * kCols + c];
    o[head + half * kCols + c] = sum;
  }
}

__global__ void __launch_bounds__(kThreads, 1) wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
                                                          const float* __restrict__ v, const float* __restrict__ logw,
                                                          const float* __restrict__ u,
                                                          const float* __restrict__ S0, int T, int H,
                                                          float* __restrict__ o, float* __restrict__ S,
                                                          float* __restrict__ ck) {
  extern __shared__ __align__(16) float smem[];
  if (T == 1) {
    token_step(r, k, v, logw, u, S0, H, o, S, ck, smem);
    return;
  }
  float* raws = smem;                     // two staging sets: r, k, logw [token][key], v [token][column]
  float* Qs = raws + 2 * kRawFloats;      // two sets of q_f [token][key]
  float* Ks = Qs + 2 * kWideFloats;       // two sets of k_f [token][key]
  float* A = Ks + 2 * kWideFloats;        // [token][token], lower part
  float* Vts = A + kWideFloats;           // two sets of v^T [column][token]
  float* St = Vts + 2 * kNarrowFloats;    // S^T [column][key] at the chunk's start
  float* gsum = St + kNarrowFloats;       // [group][key] log2-decays of each token group
  float* small = gsum + kGroups * kHead;  // per set: [token] sum_d r u k, [key] exp(c_last)

  const int half = blockIdx.x % kHalves;
  const int h = blockIdx.x / kHalves;
  const size_t b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const size_t tok_stride = (size_t)H * kHead;            // floats from one token to the next
  const size_t head_base = (b * T * H + h) * kHead;       // r[b, 0, h, 0]
  const size_t state_base = (b * H + h) * kHead * kHead;  // S0[b, h, 0, 0]
  const int n_chunks = (T + kChunk - 1) / kChunk;

  if (warp >= kMathWarps) {  // the prep warps
    const int pt = tid - kMath;
    auto load = [&](int t0, float* raw) {  // a chunk's rows, zeros past T
#pragma unroll
      for (int i = 0; i < kChunk * kHead / 4 / kPrep; ++i) {
        const int p = pt + i * kPrep, row = p / 16, c4 = (p % 16) * 4;
        const bool in = t0 + row < T;
        const size_t off = head_base + (size_t)(in ? t0 + row : 0) * tok_stride + c4;
        cp16(raw + row * kHead + c4, r + off, in);
        cp16(raw + kChunk * kHead + row * kHead + c4, k + off, in);
        cp16(raw + 2 * kChunk * kHead + row * kHead + c4, logw + off, in);
      }
#pragma unroll
      for (int i = 0; i < kChunk * kCols / 4 / kPrep; ++i) {
        const int p = pt + i * kPrep, row = p / 8, c4 = (p % 8) * 4;
        const bool in = t0 + row < T;
        cp16(raw + 3 * kChunk * kHead + row * kCols + c4,
             v + head_base + (size_t)(in ? t0 + row : 0) * tok_stride + half * kCols + c4, in);
      }
      asm volatile("cp.async.commit_group;" ::: "memory");
    };
    if (kCopies) load(0, raws);
    // this thread: key channels 4 cg .. 4 cg + 3 of tokens 8 tg .. 8 tg + 7;
    // the 16 lanes of a half-warp share a token group
    const int cg = pt % 16, tg = pt / 16;
    const float4 u4 = *reinterpret_cast<const float4*>(u + (size_t)h * kHead + 4 * cg);
    for (int ci = 0; ci < n_chunks; ++ci) {
      const int set = ci % 2;
      const float* raw_r = raws + set * kRawFloats;
      const float* raw_k = raw_r + kChunk * kHead;
      const float* raw_w = raw_k + kChunk * kHead;
      const float* raw_v = raw_w + kChunk * kHead;
      float* Q = Qs + set * kWideFloats;
      float* K = Ks + set * kWideFloats;
      float* Vt = Vts + set * kNarrowFloats;
      float* ruk = small + set * kSetSmall;
      float* dec = ruk + kChunk;
      asm volatile("cp.async.wait_group 0;" ::: "memory");
      bar_sync(kPrepBar, kPrep);  // the chunk has landed; every read of the other staging set is done
      if (kCopies && ci + 1 < n_chunks) load((ci + 1) * kChunk, raws + (1 - set) * kRawFloats);
      if (ci >= 2) bar_sync(kEmpty + set, kThreads);  // the math warps are done with this set
      // the log2-decays: each group's sums, then each token's running sum
      // c (inclusive) and the sum before it (exclusive)
      float4 w4[8];
      float4 c4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 x = *reinterpret_cast<const float4*>(raw_w + (8 * tg + j) * kHead + 4 * cg);
        w4[j] = make_float4(x.x * kLog2e, x.y * kLog2e, x.z * kLog2e, x.w * kLog2e);
        c4.x += w4[j].x, c4.y += w4[j].y, c4.z += w4[j].z, c4.w += w4[j].w;
      }
      *reinterpret_cast<float4*>(gsum + tg * kHead + 4 * cg) = c4;
      bar_sync(kPrepBar, kPrep);
      c4 = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int q = 0; q < tg; ++q) {
        const float4 x = *reinterpret_cast<const float4*>(gsum + q * kHead + 4 * cg);
        c4.x += x.x, c4.y += x.y, c4.z += x.z, c4.w += x.w;
      }
      float x[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int t = 8 * tg + j;
        const float4 before = c4;
        c4.x += w4[j].x, c4.y += w4[j].y, c4.z += w4[j].z, c4.w += w4[j].w;
        const float4 rr = *reinterpret_cast<const float4*>(raw_r + t * kHead + 4 * cg);
        const float4 kk = *reinterpret_cast<const float4*>(raw_k + t * kHead + 4 * cg);
        *reinterpret_cast<float4*>(Q + t * kLd + 4 * cg) =
            make_float4(rr.x * exp2_approx(before.x), rr.y * exp2_approx(before.y), rr.z * exp2_approx(before.z),
                        rr.w * exp2_approx(before.w));
        *reinterpret_cast<float4*>(K + t * kLd + 4 * cg) =
            make_float4(kk.x * exp2_approx(-c4.x), kk.y * exp2_approx(-c4.y), kk.z * exp2_approx(-c4.z),
                        kk.w * exp2_approx(-c4.w));
        x[j] = rr.x * u4.x * kk.x + rr.y * u4.y * kk.y + rr.z * u4.z * kk.z + rr.w * u4.w * kk.w;
      }
      if (tg == kGroups - 1)  // c at the chunk's last token
        *reinterpret_cast<float4*>(dec + 4 * cg) =
            make_float4(exp2_approx(c4.x), exp2_approx(c4.y), exp2_approx(c4.z), exp2_approx(c4.w));
      // sum x over the 16 lanes of the token group: lanes 2 j and 2 j + 1
      // of the half-warp end with token 8 tg + j's sum
      fold<8, 4>(x, lane);
      fold<4, 2>(x, lane);
      fold<2, 1>(x, lane);
      x[0] += __shfl_xor_sync(0xffffffffu, x[0], 1);
      if (lane % 2 == 0) ruk[8 * tg + lane % 16 / 2] = x[0];
      // v^T: a thread a column and 16 tokens, 4 at a time
      {
        const int c = pt % kCols, s0 = (pt / kCols) * 16;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int s = s0 + 4 * q;
          *reinterpret_cast<float4*>(Vt + c * kLd + s) =
              make_float4(raw_v[s * kCols + c], raw_v[(s + 1) * kCols + c], raw_v[(s + 2) * kCols + c],
                          raw_v[(s + 3) * kCols + c]);
        }
      }
      bar_arrive(kFull + set, kThreads);
    }
  } else {  // the math warps: 8 own output tiles, 8 own state tiles
    // a warp's tiles: rows 16 mo .. (tokens of the output, keys of the
    // state), the half's columns n0 .. n0 + 15
    const bool out_warp = warp < kMathWarps / 2;
    const int w8 = warp % (kMathWarps / 2), mo = w8 / 2, n0 = (w8 % 2) * 16;
    float st[2][4] = {};  // a state warp's tiles, in registers for the whole walk
    auto store_state = [&]() {  // S^T, for the next chunk's q_f S
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int x = 0; x < 4; ++x) St[(n0 + 8 * nt + 2 * t4 + x % 2) * kLd + 16 * mo + g + 8 * (x / 2)] = st[nt][x];
    };
    if (!out_warp) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float2 s = *reinterpret_cast<const float2*>(S0 + state_base + (size_t)(16 * mo + g + 8 * e) * kHead +
                                                            half * kCols + n0 + 8 * nt + 2 * t4);
          st[nt][2 * e] = s.x, st[nt][2 * e + 1] = s.y;
        }
      store_state();
    }
    for (int ci = 0; ci < n_chunks; ++ci) {
      const int t0 = ci * kChunk, set = ci % 2;
      const float* Q = Qs + set * kWideFloats;
      const float* K = Ks + set * kWideFloats;
      const float* Vt = Vts + set * kNarrowFloats;
      const float* ruk = small + set * kSetSmall;
      const float* dec = ruk + kChunk;
      bar_sync(kFull + set, kThreads);  // the set is ready; every math warp is past the last chunk

      // A = q_f k_f^T on its lower 16 x 8 tiles (i, j), j < 2 (i + 1),
      // masked: a state warp two tiles of a row block (tiles 2 w8, 2 w8 + 1
      // in the order (3, 0) .. (3, 7), (2, 0) .. (2, 5), (1, 0) .. (1, 3),
      // (0, 0), (0, 1)), the first four output warps the last four tiles,
      // one each
      auto a_tiles = [&](int i, int j, const auto& acc) {
#pragma unroll
        for (int nt = 0; nt < acc.kTiles; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int t = 16 * i + g + 8 * e, s = 8 * (j + nt) + 2 * t4;
            float y0 = acc.at(nt, 2 * e), y1 = acc.at(nt, 2 * e + 1);
            if (j + nt >= 2 * i) {  // on the diagonal block: strictly lower, then sum_d r u k on the diagonal
              y0 = s < t ? y0 : s == t ? ruk[t] : 0.f;
              y1 = s + 1 < t ? y1 : s + 1 == t ? ruk[t] : 0.f;
            }
            *reinterpret_cast<float2*>(A + t * kLd + s) = make_float2(y0, y1);
          }
        }
      };
      if (kProducts && !out_warp) {
        const int n = 2 * w8, i = n < 8 ? 3 : n < 14 ? 2 : 1, j = n < 8 ? n : n < 14 ? n - 8 : n - 14;
        Acc<2> qk;
        qk.product([&](uint32_t(&x)[4], int ks) { ldsm4(x, Q, 16 * i, 8 * ks, lane); },
                   [&](uint32_t(&b)[2][2], int ks) { ldsm_b<2>(b, K, 8 * j, 8 * ks, lane); });
        a_tiles(i, j, qk);
      } else if (kProducts && w8 < 4) {
        const int i = w8 < 2 ? 1 : 0, j = w8 < 2 ? 2 + w8 : w8 - 2;
        Acc<1> qk;
        qk.product([&](uint32_t(&x)[4], int ks) { ldsm4(x, Q, 16 * i, 8 * ks, lane); },
                   [&](uint32_t(&b)[1][2], int ks) { ldsm_b<1>(b, K, 8 * j, 8 * ks, lane); });
        a_tiles(i, j, qk);
      }

      // output warps: o = q_f S to start
      Acc<2> pr;
      auto vt_b = [&](uint32_t(&b)[2][2], int ks) { ldsm_b<2>(b, Vt, n0, 8 * ks, lane); };
      if (out_warp && kProducts)
        pr.product([&](uint32_t(&x)[4], int ks) { ldsm4(x, Q, 16 * mo, 8 * ks, lane); },
                   [&](uint32_t(&b)[2][2], int ks) { ldsm_b<2>(b, St, n0, 8 * ks, lane); });
      bar_sync(kMathBar, kMath);  // A is whole; every read of S^T is done

      if (out_warp) {  // o += A v over the tokens up to the tile's last row; o stored
        if (kProducts)
          pr.product([&](uint32_t(&x)[4], int ks) { ldsm4(x, A, 16 * mo, 8 * ks, lane); }, vt_b, 2 * (mo + 1));
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = t0 + 16 * mo + g + 8 * e;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            if (kCopies && t < T)
              *reinterpret_cast<float2*>(o + head_base + (size_t)t * tok_stride + half * kCols + n0 + 8 * nt + 2 * t4) =
                  make_float2(pr.at(nt, 2 * e), pr.at(nt, 2 * e + 1));
        }
      } else {  // S = exp(c_last) S + exp(c_last) (k_f^T v), stored for the next chunk
        if (kProducts)
          pr.product(
              [&](uint32_t(&x)[4], int ks) {  // k_f^T's fragment: element (d, s) at K[s][d]
                const float* p = K + (8 * ks + t4) * kLd + 16 * mo + g;
                x[0] = __float_as_uint(p[0]), x[1] = __float_as_uint(p[8]), x[2] = __float_as_uint(p[4 * kLd]),
                x[3] = __float_as_uint(p[4 * kLd + 8]);
              },
              vt_b);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float dd = dec[16 * mo + g + 8 * (x / 2)];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) st[nt][x] = fmaf(dd, st[nt][x], dd * pr.at(nt, x));
        }
        store_state();
        if (ck) {  // the checkpoint after chunk ci: ck[b, h, ci], as S
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              *reinterpret_cast<float2*>(ck + (state_base * n_chunks + (size_t)ci * kHead * kHead) +
                                         (16 * mo + g + 8 * e) * kHead + half * kCols + n0 + 8 * nt + 2 * t4) =
                  make_float2(st[nt][2 * e], st[nt][2 * e + 1]);
        }
      }
      if (ci + 2 < n_chunks) bar_arrive(kEmpty + set, kThreads);  // the set is free for chunk ci + 2
    }
    if (!out_warp) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          *reinterpret_cast<float2*>(S + state_base + (size_t)(16 * mo + g + 8 * e) * kHead + half * kCols + n0 +
                                     8 * nt + 2 * t4) = make_float2(st[nt][2 * e], st[nt][2 * e + 1]);
    }
  }
}

}  // namespace

// r, k, v, logw (B, T, H, 64) f32, u (H, 64) f32, S0 (B, H, 64, 64) f32 ->
// o (B, T, H, 64), S (B, H, 64, 64), and where ck is not null the state
// after each chunk of 64 tokens, ck (B, H, ceil(T / 64), 64, 64) (the last
// the final state: the backward's checkpoints).  Every pointer 16-byte
// aligned.
extern "C" int rwkv_wkv_launch(const float* r, const float* k, const float* v, const float* logw, const float* u,
                               const float* S0, int B, int T, int H, float* o, float* S, float* ck,
                               cudaStream_t stream) {
  if (B <= 0 || H <= 0) return 0;
  if (T <= 0) return (int)cudaErrorInvalidValue;
  const auto off16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (off16(r) || off16(k) || off16(v) || off16(logw) || off16(u) || off16(S0) || off16(o) || off16(S) || off16(ck))
    return (int)cudaErrorMisalignedAddress;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(wkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const dim3 grid(H * kHalves, B);
  if (T == 1)
    wkv_kernel<<<grid, kTokenThreads, 4 * kTokenPart, stream>>>(r, k, v, logw, u, S0, T, H, o, S, ck);
  else
    wkv_kernel<<<grid, kThreads, kSmemBytes, stream>>>(r, k, v, logw, u, S0, T, H, o, S, ck);
  return (int)cudaGetLastError();
}
