// flash_bwd: the backward of flash attention (flash.cu), for sm_90a.
//
// No TPU kernel: the reference trains through the XLA path of
// repro/models/layers.py:flash_attention (USE_FLASH_KERNEL is False,
// models/flags.py:38): JAX's autodiff differentiates its KV-chunk lax.scan
// (layers.py:213-253).  Here the gradient is a kernel, fed by the forward's
// output and the log-sum-exp of each row that the forward writes beside it
// (flash.cu's lse).  Semantics (repro_torch.kernels.flash_bwd.
// flash_attention_bwd_plain):
//   x  = (q . k) * hd^-0.5, s = softcap * tanh(x / softcap) when softcap > 0;
//   s  = -1e30 where the pair is masked (flash.cu's mask);
//   P  = exp(s - lse), D = rowsum(dO o O);
//   dV = P^T dO, dS = P o (dO V^T - D) [o (1 - tanh^2(x / softcap))];
//   dQ = hd^-0.5 dS K, dK = hd^-0.5 dS^T Q;
// dK and dV sum over the G query heads of their kv head.  Specified on rows
// with at least one valid key, as every training row has (a position sees
// its own key, causal or not, within any window of at least 1); a masked
// pair has P = 0 and adds nothing, so the tiles flash_tile_live rules out are
// skipped exactly, and causal training does about half the work.
//
// Layout as flash.cu: q, out, dout and dq (B, T, H, hd); k, v, dk and dv
// (B, S, KV, hd); lse and D (B, T, H) f32.  Row r of a (batch, kv head) is
// query r / G of head kvh * G + r % G (the forward's packing), so a tile of
// rows holds all G heads of its queries and the loops over row tiles sum dK
// and dV over the group.
//
// Launches, all named flash_bwd_kernel_*:
//   * flash_bwd_kernel_tiles (twice): summaries (min, max, count of the
//     positions >= 0) of the key tiles of the dQ kernel and of the row tiles
//     of the dK/dV kernel;
//   * flash_bwd_kernel_dot: D, a warp a row;
//   * flash_bwd_kernel_dkv: a block per (batch, kv head, tile of keys) that
//     loops over the live row tiles, dK and dV of its keys in registers;
//   * flash_bwd_kernel_dq: a block per (batch, kv head, tile of rows) that
//     loops over the live key tiles, dQ of its rows in registers.
// Every output element is written once, by one thread, with no atomics: the
// result is the same from run to run.
//
// bf16 (..._dkv, ..._dq) runs its five products on the tensor cores with the
// forward's fragments (flash_common.cuh: mma.sync m16n8k16, f32
// accumulators; P and dS rounded to bf16 as operands, from the
// accumulators in registers); operand tiles come through two-stage cp.async
// rings with rows padded by 16 bytes.  At hd 256 two warps share 16 keys of
// dK/dV, each holding half of the columns (the scores computed by both), to
// keep the accumulators in registers.  f32 (..._cores) runs on the CUDA
// cores in f32, tiles of 32 rows by 32 keys.  Bound: operations, five
// products of 2 hd flops a valid (query, key) pair, 2.5 times the forward's.

#include "flash_common.cuh"

namespace {

constexpr int kCoreTile = 32;  // rows and keys a tile of the f32 kernels
constexpr int kCoreThreads = 256;

// ---- summaries and D --------------------------------------------------------

// One warp a tile: (min, max, count) of the positions >= 0 in tile t.  For
// key tiles (G = 1, len = S): slots [t * tile, min(S, (t + 1) * tile)).  For
// row tiles (len = T): the queries of rows [t * tile, min(T * G, (t + 1) *
// tile)), row r being query r / G.
__global__ void __launch_bounds__(256)
    flash_bwd_kernel_tiles(const int* __restrict__ pos, int4* __restrict__ tiles, int len, int G, int tile, int nT) {
  const int lane = threadIdx.x % 32;
  const int t = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32, b = blockIdx.y;
  if (t >= nT) return;
  const int lo = t * tile / G, hi = (min(len * G, (t + 1) * tile) - 1) / G + 1;
  int pmin = INT_MAX, pmax = INT_MIN, cnt = 0;
  for (int n = lo + lane; n < hi; n += 32) {
    const int p = pos[(size_t)b * len + n];
    if (p >= 0) pmin = min(pmin, p), pmax = max(pmax, p), ++cnt;
  }
  for (int off = 16; off > 0; off >>= 1) {
    pmin = min(pmin, __shfl_xor_sync(0xffffffffu, pmin, off));
    pmax = max(pmax, __shfl_xor_sync(0xffffffffu, pmax, off));
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  }
  if (lane == 0) tiles[(size_t)b * nT + t] = make_int4(pmin, pmax, cnt, 0);
}

// D = rowsum(dO o O) in f32 over each of the n rows of hd values, a warp a row.
template <typename T>
__global__ void __launch_bounds__(256)
    flash_bwd_kernel_dot(const T* __restrict__ out, const T* __restrict__ dout, float* __restrict__ dsum, size_t n,
                         int hd) {
  const int lane = threadIdx.x % 32;
  const size_t row = (size_t)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= n) return;
  float acc = 0.0f;
  for (int c = lane; c < hd; c += 32) acc = fmaf(Op<T>::load(out + row * hd + c), Op<T>::load(dout + row * hd + c), acc);
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dsum[row] = acc;
}

// The summary of keys [n0, min(S, n0 + bn)) of one batch row, in every lane
// of the calling warp.
__device__ __forceinline__ int4 key_summary(const int* __restrict__ kpb, int n0, int bn, int S) {
  const int lane = threadIdx.x % 32;
  int kmin = INT_MAX, kmax = INT_MIN, cnt = 0;
  for (int n = n0 + lane; n < min(S, n0 + bn); n += 32) {
    const int kp = kpb[n];
    if (kp >= 0) kmin = min(kmin, kp), kmax = max(kmax, kp), ++cnt;
  }
  for (int off = 16; off > 0; off >>= 1) {
    kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, off));
    kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, off));
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  }
  return make_int4(kmin, kmax, cnt, 0);
}

// The live row tiles of a key tile (summary kt), in order, into shared
// `list`; returns their number.  Every thread takes part.
template <int NT>
__device__ int live_row_tiles(const int4* __restrict__ rtiles, int n, int4 kt, int bn, int causal, int window,
                              int* list, int* count) {
  for (int i = threadIdx.x; i < n; i += NT) {
    const int4 rt = rtiles[i];
    list[i] = tile_state(kt, bn, rt.x, rt.y, causal, window);
  }
  return compact_live(list, n, 0, count);
}

// The pair's score from its raw product: x = raw * scale, softcapped, -1e30
// where masked; dtanh is the softcap's derivative factor 1 - tanh^2.
__device__ __forceinline__ float score(float raw, float scale, float softcap, bool ok, float& dtanh) {
  float x = raw * scale;
  dtanh = 1.0f;
  if (softcap > 0.0f) {
    const float t = tanhf(x / softcap);
    x = softcap * t;
    dtanh = 1.0f - t * t;
  }
  return ok ? x : kNeg;
}

__device__ __forceinline__ bool pair_ok(int kp, int qp, int causal, int window) {
  bool ok = kp >= 0;
  if (causal) ok = ok && kp <= qp;
  if (window > 0) ok = ok && kp > qp - window;
  return ok;
}

// ---- bf16 on the tensor cores: dK and dV ------------------------------------

// BN keys a block in warps of 16 keys, NC warps of HD / NC columns each per
// 16 keys; BM rows a row tile.
template <int HD, int BN, int BM, int NC>
struct DkvCfg {
  static constexpr int HC = HD / NC;  // dK / dV columns a warp holds
  static constexpr int NWK = BN / 16;
  static constexpr int NT = NWK * NC * 32;
  static constexpr int LD = HD + 8;  // shared row stride: 16 bytes of padding
  static constexpr int STAGES = 2;
  // K and V tiles, the rings of Q and dO tiles and of the rows' lse, D and
  // q_pos, the live count (16 bytes); the live list follows (4 bytes a tile)
  static constexpr size_t kFixed = sizeof(bf16) * (2 * (size_t)BN * LD + 2 * STAGES * (size_t)BM * LD) +
                                   (2 * sizeof(float) + sizeof(int)) * STAGES * BM + 16;
};

template <int HD, int BN, int BM, int NC>
__global__ void __launch_bounds__(DkvCfg<HD, BN, BM, NC>::NT)
    flash_bwd_kernel_dkv(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                         const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dsum,
                         const int* __restrict__ q_pos, const int* __restrict__ k_pos, const int4* __restrict__ rtiles,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int T_len, int S, int H, int KV, float scale,
                         int causal, int window, float softcap) {
  using C = DkvCfg<HD, BN, BM, NC>;
  constexpr int NT = C::NT, LD = C::LD, STAGES = C::STAGES, HC = C::HC;
  constexpr int KS = HD / 16;  // k-steps of S^T = K Q^T and dP^T = V dO^T
  constexpr int NS = BM / 8;   // row n-tiles of S^T
  constexpr int NO = HC / 8;   // column n-tiles of dK and dV
  constexpr int P = HD / 8;    // 16-byte pieces of a row
  static_assert(HD % 16 == 0 && HC % 16 == 0 && BN % 16 == 0 && BM % 16 == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BN * LD;
  bf16* Qs = Vs + BN * LD;
  bf16* Os = Qs + STAGES * BM * LD;
  float* lse_s = reinterpret_cast<float*>(Os + STAGES * BM * LD);
  float* d_s = lse_s + STAGES * BM;
  int* qp_s = reinterpret_cast<int*>(d_s + STAGES * BM);
  int* count = qp_s + STAGES * BM;
  int* list = count + 4;

  const int G = H / KV, rows = T_len * G, nRT = (rows + BM - 1) / BM;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kw = warp % C::NWK, cg = warp / C::NWK;  // key slice, column group
  const size_t kstride = (size_t)KV * HD;
  const int* kpb = k_pos + (size_t)b * S;

  // K and V tile (keys past S zero): the first copy group
  for (int idx = tid; idx < BN * P; idx += NT) {
    const int r = idx / P, c = idx % P;
    const bool ok = n0 + r < S;
    const size_t off = ok ? (size_t)(b * S + n0 + r) * kstride + (size_t)kvh * HD + c * 8 : 0;
    cp_async16(Ks + r * LD + c * 8, k + off, ok);
    cp_async16(Vs + r * LD + c * 8, v + off, ok);
  }
  cp_async_commit();

  const int4 kt = key_summary(kpb, n0, BN, S);
  const int n_live = live_row_tiles<NT>(rtiles + (size_t)b * nRT, nRT, kt, BN, causal, window, list, count);

  // Q, dO, lse, D and q_pos of one row tile into a ring stage (rows past
  // `rows` zero: they add nothing, dO and D being 0)
  auto load_rows = [&](int entry, int stage) {
    const int r0 = (entry >> 2) * BM;
    bf16* qd = Qs + stage * BM * LD;
    bf16* od = Os + stage * BM * LD;
    for (int idx = tid; idx < BM * P; idx += NT) {
      const int r = idx / P, c = idx % P, gr = r0 + r;
      const bool ok = gr < rows;
      const size_t off = ok ? ((size_t)(b * T_len + gr / G) * H + kvh * G + gr % G) * HD + c * 8 : 0;
      cp_async16(qd + r * LD + c * 8, q + off, ok);
      cp_async16(od + r * LD + c * 8, dout + off, ok);
    }
    for (int r = tid; r < BM; r += NT) {
      const int gr = r0 + r;
      const bool ok = gr < rows;
      const size_t off = ok ? (size_t)(b * T_len + gr / G) * H + kvh * G + gr % G : 0;
      cp_async4(lse_s + stage * BM + r, lse + off, ok);
      cp_async4(d_s + stage * BM + r, dsum + off, ok);
      cp_async4(qp_s + stage * BM + r, q_pos + (ok ? (size_t)b * T_len + gr / G : 0), ok);
    }
  };
  if (n_live > 0) load_rows(list[0], 0);
  cp_async_commit();

  // this thread's keys: kw * 16 + lane / 4 and 8 more (k_pos -1 past S)
  const int key0 = n0 + kw * 16 + lane / 4;
  int kp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) kp[i] = key0 + 8 * i < S ? kpb[key0 + 8 * i] : -1;

  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.0f;

  for (int it = 0; it < n_live; ++it) {
    const int entry = list[it], stage = it % STAGES;
    if (it + 1 < n_live) load_rows(list[it + 1], (it + 1) % STAGES);
    cp_async_commit();
    cp_async_wait<1>();  // K, V and this row tile have landed
    __syncthreads();
    const bf16* Qt = Qs + stage * BM * LD;
    const bf16* Ot = Os + stage * BM * LD;
    const float* lt = lse_s + stage * BM;
    const float* dt = d_s + stage * BM;
    const int* qpt = qp_s + stage * BM;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys against BM rows
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ka[4], va[4];
      ldsm_x4(ka, Ks + (kw * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8);
      ldsm_x4(va, Vs + (kw * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        const int off = (jp * 16 + (lane / 16) * 8 + lane % 8) * LD + kk * 16 + ((lane / 8) & 1) * 8;
        uint32_t qb[4], ob[4];
        ldsm_x4(qb, Qt + off);
        mma_bf16(s[2 * jp], ka, qb[0], qb[1]);
        mma_bf16(s[2 * jp + 1], ka, qb[2], qb[3]);
        ldsm_x4(ob, Ot + off);
        mma_bf16(dp[2 * jp], va, ob[0], ob[1]);
        mma_bf16(dp[2 * jp + 1], va, ob[2], ob[3]);
      }
    }

    // P^T and dS^T in place: element e of n-tile j is key lane / 4 + 8 (e / 2)
    // of the warp's 16, row j * 8 + (lane % 4) * 2 + e % 2 of the tile
    const bool full = (entry & 3) == 2;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = j * 8 + (lane % 4) * 2 + (e & 1);
        float dtanh;
        const float x = score(s[j][e], scale, softcap, full || pair_ok(kp[e >> 1], qpt[row], causal, window), dtanh);
        const float p = __expf(x - lt[row]);
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dt[row]) * dtanh;
      }

    // dV += P^T dO and dK += dS^T Q over the tile's rows, this warp's columns
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const uint32_t sa[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]), pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < HC / 16; ++np) {
        const int off = (kk * 16 + lane % 16) * LD + cg * HC + np * 16 + (lane / 16) * 8;
        uint32_t ob[4], qb[4];
        ldsm_x4_trans(ob, Ot + off);
        mma_bf16(dva[2 * np], pa, ob[0], ob[1]);
        mma_bf16(dva[2 * np + 1], pa, ob[2], ob[3]);
        ldsm_x4_trans(qb, Qt + off);
        mma_bf16(dka[2 * np], sa, qb[0], qb[1]);
        mma_bf16(dka[2 * np + 1], sa, qb[2], qb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key >= S) continue;
    const size_t base = ((size_t)(b * S + key) * KV + kvh) * HD + cg * HC;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = n * 8 + (lane % 4) * 2;
      *reinterpret_cast<__nv_bfloat162*>(dk + base + col) =
          __floats2bfloat162_rn(dka[n][2 * i] * scale, dka[n][2 * i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + base + col) = __floats2bfloat162_rn(dva[n][2 * i], dva[n][2 * i + 1]);
    }
  }
}

// ---- bf16 on the tensor cores: dQ ---------------------------------------------

// BM rows a block in warps of 16 rows; BN keys a key tile.
template <int HD, int BM, int BN>
struct DqCfg {
  static constexpr int NT = BM / 16 * 32;
  static constexpr int LD = HD + 8;
  static constexpr int STAGES = 2;
  // Q and dO tiles, the rings of K and V tiles and of their k_pos, the live
  // count (16 bytes); the live list follows (4 bytes a tile)
  static constexpr size_t kFixed = sizeof(bf16) * (2 * (size_t)BM * LD + 2 * STAGES * (size_t)BN * LD) +
                                   sizeof(int) * STAGES * BN + 16;
};

template <int HD, int BM, int BN>
__global__ void __launch_bounds__(DqCfg<HD, BM, BN>::NT)
    flash_bwd_kernel_dq(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                        const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dsum,
                        const int* __restrict__ q_pos, const int* __restrict__ k_pos, const int4* __restrict__ ktiles,
                        bf16* __restrict__ dq, int T_len, int S, int H, int KV, float scale, int causal, int window,
                        float softcap) {
  using C = DqCfg<HD, BM, BN>;
  constexpr int NT = C::NT, LD = C::LD, STAGES = C::STAGES;
  constexpr int KS = HD / 16;  // k-steps of S = Q K^T and dP = dO V^T
  constexpr int NS = BN / 8;   // key n-tiles of S
  constexpr int NO = HD / 8;   // column n-tiles of dQ
  constexpr int P = HD / 8;
  static_assert(HD % 16 == 0 && BN % 16 == 0 && BM % 16 == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Os = Qs + BM * LD;
  bf16* Ks = Os + BM * LD;
  bf16* Vs = Ks + STAGES * BN * LD;
  int* kps = reinterpret_cast<int*>(Vs + STAGES * BN * LD);
  int* count = kps + STAGES * BN;
  int* list = count + 4;

  const int G = H / KV, rows = T_len * G, nT = (S + BN - 1) / BN;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BM;  // the last rows, which see the most keys, start first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t kstride = (size_t)KV * HD;
  const bf16* kb = k + (size_t)b * S * kstride + (size_t)kvh * HD;
  const bf16* vb = v + (size_t)b * S * kstride + (size_t)kvh * HD;
  const int* kpb = k_pos + (size_t)b * S;
  const int* qpb = q_pos + (size_t)b * T_len;

  // Q and dO tiles (rows past `rows` zero): the first copy group
  for (int idx = tid; idx < BM * P; idx += NT) {
    const int r = idx / P, c = idx % P, gr = r0 + r;
    const bool ok = gr < rows;
    const size_t off = ok ? ((size_t)(b * T_len + gr / G) * H + kvh * G + gr % G) * HD + c * 8 : 0;
    cp_async16(Qs + r * LD + c * 8, q + off, ok);
    cp_async16(Os + r * LD + c * 8, dout + off, ok);
  }
  cp_async_commit();

  int qmin, qmax;
  row_bounds(qpb, G, r0, min(rows, r0 + BM), qmin, qmax);
  const int n_live = live_list<NT>(ktiles + (size_t)b * nT, 0, nT, BN, qmin, qmax, causal, window, list, count);

  auto load_tile = [&](int entry, int stage) {
    const int n0 = (entry >> 2) * BN;
    bf16* kd = Ks + stage * BN * LD;
    bf16* vd = Vs + stage * BN * LD;
    for (int idx = tid; idx < BN * P; idx += NT) {
      const int r = idx / P, c = idx % P;
      const bool ok = n0 + r < S;
      const size_t off = ok ? (size_t)(n0 + r) * kstride + c * 8 : 0;
      cp_async16(kd + r * LD + c * 8, kb + off, ok);
      cp_async16(vd + r * LD + c * 8, vb + off, ok);
    }
    for (int r = tid; r < BN; r += NT) cp_async4(kps + stage * BN + r, kpb + (n0 + r < S ? n0 + r : 0), n0 + r < S);
  };
  if (n_live > 0) load_tile(list[0], 0);
  cp_async_commit();

  // this thread's rows: lane / 4 and lane / 4 + 8 of the warp's 16
  const int gr0 = r0 + warp * 16 + lane / 4;
  int qp[2];
  float lr[2], dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gr = gr0 + 8 * i;
    const size_t idx = (size_t)(b * T_len + gr / G) * H + kvh * G + gr % G;
    qp[i] = gr < rows ? qpb[gr / G] : 0;
    lr[i] = gr < rows ? lse[idx] : 0.0f;
    dr[i] = gr < rows ? dsum[idx] : 0.0f;
  }

  float dqa[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.0f;

  for (int it = 0; it < n_live; ++it) {
    const int entry = list[it], stage = it % STAGES;
    if (it + 1 < n_live) load_tile(list[it + 1], (it + 1) % STAGES);
    cp_async_commit();
    cp_async_wait<1>();  // Q, dO and this tile have landed
    __syncthreads();
    const bf16* Kt = Ks + stage * BN * LD;
    const bf16* Vt = Vs + stage * BN * LD;
    const int* kpt = kps + stage * BN;
    const int n0 = (entry >> 2) * BN;

    // S = Q K^T and dP = dO V^T: this warp's 16 rows against BN keys
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4], oa[4];
      ldsm_x4(qa, Qs + (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8);
      ldsm_x4(oa, Os + (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        const int off = (jp * 16 + (lane / 16) * 8 + lane % 8) * LD + kk * 16 + ((lane / 8) & 1) * 8;
        uint32_t kf[4], vf[4];
        ldsm_x4(kf, Kt + off);
        mma_bf16(s[2 * jp], qa, kf[0], kf[1]);
        mma_bf16(s[2 * jp + 1], qa, kf[2], kf[3]);
        ldsm_x4(vf, Vt + off);
        mma_bf16(dp[2 * jp], oa, vf[0], vf[1]);
        mma_bf16(dp[2 * jp + 1], oa, vf[2], vf[3]);
      }
    }

    // dS in place: element e of n-tile j is row lane / 4 + 8 (e / 2), key
    // j * 8 + (lane % 4) * 2 + e % 2 of the tile
    const bool full = (entry & 3) == 2;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + (lane % 4) * 2 + (e & 1);
        const bool ok = full || (n0 + col < S && pair_ok(kpt[col], qp[e >> 1], causal, window));
        float dtanh;
        const float x = score(s[j][e], scale, softcap, ok, dtanh);
        const float p = __expf(x - lr[e >> 1]);
        dp[j][e] = p * (dp[j][e] - dr[e >> 1]) * dtanh;
      }

    // dQ += dS K over the tile's keys
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t sa[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]), pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t kf[4];
        ldsm_x4_trans(kf, Kt + (kk * 16 + lane % 16) * LD + np * 16 + (lane / 16) * 8);
        mma_bf16(dqa[2 * np], sa, kf[0], kf[1]);
        mma_bf16(dqa[2 * np + 1], sa, kf[2], kf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gr = gr0 + 8 * i;
    if (gr >= rows) continue;
    bf16* dst = dq + ((size_t)(b * T_len + gr / G) * H + kvh * G + gr % G) * HD;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = n * 8 + (lane % 4) * 2;
      *reinterpret_cast<__nv_bfloat162*>(dst + col) =
          __floats2bfloat162_rn(dqa[n][2 * i] * scale, dqa[n][2 * i + 1] * scale);
    }
  }
}

// ---- f32 on the CUDA cores ------------------------------------------------------

// Rows [r0, r0 + 32) of q and dout (zeros past `rows`) into shared rows of
// stride HD + 1, and their lse, D and q_pos (zeros past `rows`).
template <int HD>
__device__ __forceinline__ void load_core_rows(const float* __restrict__ q, const float* __restrict__ dout,
                                               const float* __restrict__ lse, const float* __restrict__ dsum,
                                               const int* __restrict__ q_pos, float* Qs, float* Os, float* lse_s,
                                               float* d_s, int* qp_s, int b, int kvh, int r0, int rows, int T_len,
                                               int H, int G) {
  constexpr int LD = HD + 1;
  for (int idx = threadIdx.x; idx < kCoreTile * HD; idx += kCoreThreads) {
    const int r = idx / HD, c = idx % HD, gr = r0 + r;
    const size_t off = ((size_t)(b * T_len + gr / G) * H + kvh * G + gr % G) * HD + c;
    Qs[r * LD + c] = gr < rows ? q[off] : 0.0f;
    Os[r * LD + c] = gr < rows ? dout[off] : 0.0f;
  }
  for (int r = threadIdx.x; r < kCoreTile; r += kCoreThreads) {
    const int gr = r0 + r;
    const size_t off = (size_t)(b * T_len + gr / G) * H + kvh * G + gr % G;
    lse_s[r] = gr < rows ? lse[off] : 0.0f;
    d_s[r] = gr < rows ? dsum[off] : 0.0f;
    qp_s[r] = gr < rows ? q_pos[(size_t)b * T_len + gr / G] : 0;
  }
}

// Keys [n0, n0 + 32) of k and v (zeros past S) into shared rows of stride
// HD + 1, and their k_pos (-1 past S).
template <int HD>
__device__ __forceinline__ void load_core_keys(const float* __restrict__ k, const float* __restrict__ v,
                                               const int* __restrict__ k_pos, float* Ks, float* Vs, int* kp_s, int b,
                                               int kvh, int n0, int S, int KV) {
  constexpr int LD = HD + 1;
  for (int idx = threadIdx.x; idx < kCoreTile * HD; idx += kCoreThreads) {
    const int r = idx / HD, c = idx % HD;
    const size_t off = ((size_t)(b * S + n0 + r) * KV + kvh) * HD + c;
    Ks[r * LD + c] = n0 + r < S ? k[off] : 0.0f;
    Vs[r * LD + c] = n0 + r < S ? v[off] : 0.0f;
  }
  for (int r = threadIdx.x; r < kCoreTile; r += kCoreThreads)
    kp_s[r] = n0 + r < S ? k_pos[(size_t)b * S + n0 + r] : -1;
}

// P and dS of the 32 x 32 pairs of a row tile and a key tile into Ps and Ss
// (stride 33); thread t takes key t % 32 of rows t / 32 + 8 i.
template <int HD>
__device__ __forceinline__ void core_pairs(const float* Qs, const float* Os, const float* Ks, const float* Vs,
                                           const float* lse_s, const float* d_s, const int* qp_s, const int* kp_s,
                                           float* Ps, float* Ss, bool full, float scale, int causal, int window,
                                           float softcap) {
  constexpr int LD = HD + 1, LP = kCoreTile + 1;
  const int j = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < kCoreTile / 8; ++r) {
    const int i = threadIdx.x / 32 + 8 * r;
    float raw = 0.0f, dp = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      raw = fmaf(Qs[i * LD + d], Ks[j * LD + d], raw);
      dp = fmaf(Os[i * LD + d], Vs[j * LD + d], dp);
    }
    float dtanh;
    const float x = score(raw, scale, softcap, full || pair_ok(kp_s[j], qp_s[i], causal, window), dtanh);
    const float p = expf(x - lse_s[i]);
    if (Ps != nullptr) Ps[i * LP + j] = p;
    Ss[i * LP + j] = p * (dp - d_s[i]) * dtanh;
  }
}

template <int HD>
constexpr size_t core_smem(int tiles) {
  return sizeof(float) * (4 * (size_t)kCoreTile * (HD + 1) + 2 * (size_t)kCoreTile * (kCoreTile + 1) + 2 * kCoreTile) +
         sizeof(int) * (2 * kCoreTile + 4 + (size_t)tiles);
}

// dK and dV of 32 keys a block; thread t holds key t % 32, columns
// t / 32 + 8 u.
template <int HD>
__global__ void __launch_bounds__(kCoreThreads)
    flash_bwd_kernel_dkv_cores(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                               const float* __restrict__ dout, const float* __restrict__ lse,
                               const float* __restrict__ dsum, const int* __restrict__ q_pos,
                               const int* __restrict__ k_pos, const int4* __restrict__ rtiles, float* __restrict__ dk,
                               float* __restrict__ dv, int T_len, int S, int H, int KV, float scale, int causal,
                               int window, float softcap) {
  constexpr int LD = HD + 1, LP = kCoreTile + 1, CPT = HD / 8;
  static_assert(HD % 8 == 0 && kCoreThreads == 8 * kCoreTile, "tile shape");
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + kCoreTile * LD;
  float* Qs = Vs + kCoreTile * LD;
  float* Os = Qs + kCoreTile * LD;
  float* Ps = Os + kCoreTile * LD;
  float* Ss = Ps + kCoreTile * LP;
  float* lse_s = Ss + kCoreTile * LP;
  float* d_s = lse_s + kCoreTile;
  int* qp_s = reinterpret_cast<int*>(d_s + kCoreTile);
  int* kp_s = qp_s + kCoreTile;
  int* count = kp_s + kCoreTile;
  int* list = count + 4;

  const int G = H / KV, rows = T_len * G, nRT = (rows + kCoreTile - 1) / kCoreTile;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV, n0 = blockIdx.x * kCoreTile;
  const int j = threadIdx.x % 32, c0 = threadIdx.x / 32;

  load_core_keys<HD>(k, v, k_pos, Ks, Vs, kp_s, b, kvh, n0, S, KV);
  const int4 kt = key_summary(k_pos + (size_t)b * S, n0, kCoreTile, S);
  const int n_live = live_row_tiles<kCoreThreads>(rtiles + (size_t)b * nRT, nRT, kt, kCoreTile, causal, window,
                                                   list, count);
  float dka[CPT], dva[CPT];
#pragma unroll
  for (int u = 0; u < CPT; ++u) dka[u] = dva[u] = 0.0f;
  for (int it = 0; it < n_live; ++it) {
    __syncthreads();  // the previous tile's rows, P and dS are read
    load_core_rows<HD>(q, dout, lse, dsum, q_pos, Qs, Os, lse_s, d_s, qp_s, b, kvh, (list[it] >> 2) * kCoreTile,
                       rows, T_len, H, G);
    __syncthreads();
    core_pairs<HD>(Qs, Os, Ks, Vs, lse_s, d_s, qp_s, kp_s, Ps, Ss, (list[it] & 3) == 2, scale, causal, window,
                   softcap);
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < kCoreTile; ++i) {
      const float p = Ps[i * LP + j], ds = Ss[i * LP + j];
#pragma unroll
      for (int u = 0; u < CPT; ++u) {
        dva[u] = fmaf(p, Os[i * LD + c0 + 8 * u], dva[u]);
        dka[u] = fmaf(ds, Qs[i * LD + c0 + 8 * u], dka[u]);
      }
    }
  }
  if (n0 + j >= S) return;
  const size_t base = ((size_t)(b * S + n0 + j) * KV + kvh) * HD;
#pragma unroll
  for (int u = 0; u < CPT; ++u) {
    dk[base + c0 + 8 * u] = dka[u] * scale;
    dv[base + c0 + 8 * u] = dva[u];
  }
}

// dQ of 32 rows a block; thread t holds row t % 32, columns t / 32 + 8 u.
template <int HD>
__global__ void __launch_bounds__(kCoreThreads)
    flash_bwd_kernel_dq_cores(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                              const float* __restrict__ dout, const float* __restrict__ lse,
                              const float* __restrict__ dsum, const int* __restrict__ q_pos,
                              const int* __restrict__ k_pos, const int4* __restrict__ ktiles, float* __restrict__ dq,
                              int T_len, int S, int H, int KV, float scale, int causal, int window, float softcap) {
  constexpr int LD = HD + 1, LP = kCoreTile + 1, CPT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + kCoreTile * LD;
  float* Qs = Vs + kCoreTile * LD;
  float* Os = Qs + kCoreTile * LD;
  float* Ss = Os + kCoreTile * LD + kCoreTile * LP;  // the P tile's room stays unused
  float* lse_s = Ss + kCoreTile * LP;
  float* d_s = lse_s + kCoreTile;
  int* qp_s = reinterpret_cast<int*>(d_s + kCoreTile);
  int* kp_s = qp_s + kCoreTile;
  int* count = kp_s + kCoreTile;
  int* list = count + 4;

  const int G = H / KV, rows = T_len * G, nT = (S + kCoreTile - 1) / kCoreTile;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kCoreTile;
  const int i = threadIdx.x % 32, c0 = threadIdx.x / 32;

  load_core_rows<HD>(q, dout, lse, dsum, q_pos, Qs, Os, lse_s, d_s, qp_s, b, kvh, r0, rows, T_len, H, G);
  int qmin, qmax;
  row_bounds(q_pos + (size_t)b * T_len, G, r0, min(rows, r0 + kCoreTile), qmin, qmax);
  const int n_live = live_list<kCoreThreads>(ktiles + (size_t)b * nT, 0, nT, kCoreTile, qmin, qmax, causal, window,
                                             list, count);
  float dqa[CPT];
#pragma unroll
  for (int u = 0; u < CPT; ++u) dqa[u] = 0.0f;
  for (int it = 0; it < n_live; ++it) {
    __syncthreads();  // the previous tile's keys and dS are read
    load_core_keys<HD>(k, v, k_pos, Ks, Vs, kp_s, b, kvh, (list[it] >> 2) * kCoreTile, S, KV);
    __syncthreads();
    core_pairs<HD>(Qs, Os, Ks, Vs, lse_s, d_s, qp_s, kp_s, nullptr, Ss, (list[it] & 3) == 2, scale, causal, window,
                   softcap);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kCoreTile; ++j) {
      const float ds = Ss[i * LP + j];
#pragma unroll
      for (int u = 0; u < CPT; ++u) dqa[u] = fmaf(ds, Ks[j * LD + c0 + 8 * u], dqa[u]);
    }
  }
  if (r0 + i >= rows) return;
  const int gr = r0 + i;
  float* dst = dq + ((size_t)(b * T_len + gr / G) * H + kvh * G + gr % G) * HD;
#pragma unroll
  for (int u = 0; u < CPT; ++u) dst[c0 + 8 * u] = dqa[u] * scale;
}

// ---- launches ---------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *out, *dout;
  const float* lse;
  const int *q_pos, *k_pos;
  void *dq, *dk, *dv;
  int B, T, S, H, KV;
  float scale;
  int causal, window;
  float softcap;
  unsigned char* scratch;
  size_t scratch_bytes;
  cudaStream_t stream;
};

size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The key tiles' summaries in tiles of kt (the dQ kernel's), the row tiles'
// in tiles of rt (the dK/dV kernel's) and D, in the scratch in that order
// (kernels/flash_bwd.py:scratch_layout).
template <typename T>
cudaError_t launch_prep(const Args& a, int hd, int kt, int rt, int4** ktiles, int4** rtiles, float** dsum) {
  const int G = a.H / a.KV, rows = a.T * G;
  const int nKT = (a.S + kt - 1) / kt, nRT = (rows + rt - 1) / rt;
  const size_t off_r = align16((size_t)a.B * nKT * sizeof(int4));
  const size_t off_d = off_r + align16((size_t)a.B * nRT * sizeof(int4));
  const size_t n = (size_t)a.B * a.T * a.H;
  if (a.scratch_bytes < off_d + sizeof(float) * n) return cudaErrorInvalidValue;
  *ktiles = reinterpret_cast<int4*>(a.scratch);
  *rtiles = reinterpret_cast<int4*>(a.scratch + off_r);
  *dsum = reinterpret_cast<float*>(a.scratch + off_d);
  flash_bwd_kernel_tiles<<<dim3((nKT + 7) / 8, a.B), 256, 0, a.stream>>>(a.k_pos, *ktiles, a.S, 1, kt, nKT);
  flash_bwd_kernel_tiles<<<dim3((nRT + 7) / 8, a.B), 256, 0, a.stream>>>(a.q_pos, *rtiles, a.T, G, rt, nRT);
  flash_bwd_kernel_dot<T><<<(unsigned)((n + 7) / 8), 256, 0, a.stream>>>(
      static_cast<const T*>(a.out), static_cast<const T*>(a.dout), *dsum, n, hd);
  return cudaGetLastError();
}

// bf16: dK/dV in blocks of 64 keys against row tiles of 32; dQ in blocks of
// 64 rows against key tiles of 64 (32 at hd 256, where the dQ accumulators
// take 128 registers a thread).  hd 256 splits dK/dV's columns over two
// warps a 16 keys.
template <int HD>
cudaError_t launch_mma(const Args& a) {
  constexpr int KBN = 64, KBM = 32, QBM = 64, QBN = HD == 256 ? 32 : 64, NC = HD == 256 ? 2 : 1;
  int4 *ktiles, *rtiles;
  float* dsum;
  cudaError_t err = launch_prep<bf16>(a, HD, QBN, KBM, &ktiles, &rtiles, &dsum);
  if (err != cudaSuccess) return err;
  const int rows = a.T * (a.H / a.KV);
  using DC = DkvCfg<HD, KBN, KBM, NC>;
  auto dkv = flash_bwd_kernel_dkv<HD, KBN, KBM, NC>;
  size_t smem = DC::kFixed + sizeof(int) * (size_t)((rows + KBM - 1) / KBM);
  if ((err = allow_smem(dkv, smem)) != cudaSuccess) return err;
  dkv<<<dim3((a.S + KBN - 1) / KBN, a.B * a.KV), DC::NT, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.dout), a.lse, dsum, a.q_pos, a.k_pos, rtiles, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.T, a.S, a.H, a.KV, a.scale, a.causal, a.window, a.softcap);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  using QC = DqCfg<HD, QBM, QBN>;
  auto dq = flash_bwd_kernel_dq<HD, QBM, QBN>;
  smem = QC::kFixed + sizeof(int) * (size_t)((a.S + QBN - 1) / QBN);
  if ((err = allow_smem(dq, smem)) != cudaSuccess) return err;
  dq<<<dim3((rows + QBM - 1) / QBM, a.B * a.KV), QC::NT, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.dout), a.lse, dsum, a.q_pos, a.k_pos, ktiles, static_cast<bf16*>(a.dq), a.T, a.S,
      a.H, a.KV, a.scale, a.causal, a.window, a.softcap);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_cores(const Args& a) {
  int4 *ktiles, *rtiles;
  float* dsum;
  cudaError_t err = launch_prep<float>(a, HD, kCoreTile, kCoreTile, &ktiles, &rtiles, &dsum);
  if (err != cudaSuccess) return err;
  const int rows = a.T * (a.H / a.KV);
  const int nKT = (a.S + kCoreTile - 1) / kCoreTile, nRT = (rows + kCoreTile - 1) / kCoreTile;
  auto dkv = flash_bwd_kernel_dkv_cores<HD>;
  size_t smem = core_smem<HD>(nRT);
  if ((err = allow_smem(dkv, smem)) != cudaSuccess) return err;
  dkv<<<dim3(nKT, a.B * a.KV), kCoreThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
      static_cast<const float*>(a.dout), a.lse, dsum, a.q_pos, a.k_pos, rtiles, static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.T, a.S, a.H, a.KV, a.scale, a.causal, a.window, a.softcap);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  auto dq = flash_bwd_kernel_dq_cores<HD>;
  smem = core_smem<HD>(nKT);
  if ((err = allow_smem(dq, smem)) != cudaSuccess) return err;
  dq<<<dim3(nRT, a.B * a.KV), kCoreThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
      static_cast<const float*>(a.dout), a.lse, dsum, a.q_pos, a.k_pos, ktiles, static_cast<float*>(a.dq), a.T, a.S,
      a.H, a.KV, a.scale, a.causal, a.window, a.softcap);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(const Args& a, int dtype) {
  return dtype == 0 ? launch_cores<HD>(a) : launch_mma<HD>(a);
}

}  // namespace

// q, out, dout (B, T, H, hd) and k, v (B, S, KV, hd) in f32 (dtype 0) or
// bf16 (dtype 1); lse (B, T, H) f32 from flash_launch; q_pos (B, T), k_pos
// (B, S) int32 -> dq (B, T, H, hd), dk and dv (B, S, KV, hd) in the same
// type.  scale is hd^-0.5; window <= 0 means none, softcap <= 0 none.
// `scratch` (16-byte aligned, scratch_bytes long) takes the tile summaries
// and D; kernels/flash_bwd.py:scratch_layout gives the size.  Returns
// cudaGetLastError() of the last launch, or the first failure.
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
                                const float* lse, const int* q_pos, const int* k_pos, void* dq, void* dk, void* dv,
                                int B, int T, int S, int H, int KV, int hd, int dtype, float scale, int causal,
                                int window, float softcap, void* scratch, size_t scratch_bytes, cudaStream_t stream) {
  if (B <= 0 || T <= 0 || S <= 0) return (int)cudaGetLastError();
  if (KV <= 0 || H % KV != 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, out, dout, lse, q_pos, k_pos, dq, dk, dv, B, T, S, H, KV, scale, causal, window, softcap,
               static_cast<unsigned char*>(scratch), scratch_bytes, stream};
  switch (hd) {
    case 16:
      return (int)launch_hd<16>(a, dtype);
    case 64:
      return (int)launch_hd<64>(a, dtype);
    case 80:
      return (int)launch_hd<80>(a, dtype);
    case 128:
      return (int)launch_hd<128>(a, dtype);
    case 256:
      return (int)launch_hd<256>(a, dtype);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
