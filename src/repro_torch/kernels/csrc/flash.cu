// flash: flash-attention forward for sm_90a.
//
// Replaces the TPU kernel repro/kernels/flash.py (_flash_kernel /
// flash_attention_pallas), whose grid carried the running max, sum and
// output block of one (batch*head, q block) across a sequential third grid
// axis over KV blocks.  Blocks on Hopper run in no order, so here a block
// owns one (batch, kv head, tile of query rows) and loops over the KV tiles
// itself, or (decode) one (batch, kv head, range of KV slots) whose partial
// result a second launch combines.
//
// Semantics (repro_torch.kernels.flash.flash_attention_plain, the
// reference's XLA path models/layers.py:flash_attention):
//   s = (q . k) * hd^-0.5 in f32 from the operand type's values;
//   s = softcap * tanh(s / softcap) when softcap > 0;
//   a key slot is valid iff k_pos >= 0, and (causal) k_pos <= q_pos, and
//   (window > 0) k_pos > q_pos - window; masked scores become -1e30, not
//   -inf, as in the reference;
//   online softmax in f32; p is rounded to the operand type before the PV
//   product (the running sum l takes it unrounded), accumulation in f32;
//   out = acc / max(l, 1e-30), cast to the operand type.
//   A row with no valid key has every score at -1e30, so every p is 1: it
//   gives the mean of V over the S slots (never over padding past S).
//
// Layout (B, T, H, hd) for q and out, (B, S, KV, hd) for k and v, as the
// reference keeps them.  GQA is in the kernel: the G = H / KV query heads
// of one kv head are packed into a block's rows (row r is query t = r / G,
// head kvh * G + r % G), so a K/V tile read into shared memory serves all G
// heads, and expanded K/V never exist in device memory.
//
// Three paths, chosen by flash_launch (kernels/flash.py:kernel_plan mirrors
// the choice):
//   * bf16 with T * G > 4 (prefill): flash_kernel_mma, the FA2 shape.  Four
//     or eight warps of 16 rows; Q in registers as mma A fragments (hd 256
//     reloads them from shared memory each k-step, to stay clear of
//     spills); K/V tiles through a two-stage cp.async ring with rows padded
//     by 16 bytes, so ldmatrix is free of bank conflicts (hd 80 included);
//     S = Q K^T and O += P V on the tensor cores
//     (mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32); the row max and sum
//     over the quad's four lanes with shuffles; P goes from the S
//     accumulators straight into bf16 A fragments (the m16n8 C layout is
//     the m16n8k16 A layout in pairs) and never touches shared memory.
//     Bound: operations (4 * hd flops per valid (query, key) pair).
//   * f32 with T * G > 4: flash_kernel_cores, products on the CUDA cores in
//     f32 (TF32 keeps ~3 digits and cannot hold the f32 gate), register
//     tiles of 4 x 4 scores a thread, 16-byte tile loads several in flight.
//   * T * G <= 4 (decode), both types: flash_kernel_cores over a range of
//     KV tiles per block, grid (splits, B * KV), writing the partial
//     (m, l, acc) of its rows; flash_kernel_combine merges them:
//     m = max m_i, l = sum l_i exp(m_i - m), acc = sum acc_i exp(m_i - m).
//     p is rounded to the operand type relative to each split's own running
//     max, the same kind of difference as the 64-key tiles' running max
//     against the plain version's 1024-key chunks.  Bound: bytes (the cache
//     read once); the splits fill the card several times over, where one
//     block per (batch, kv head) left 116 of 132 SMs idle at llama's shape.
//
// Tile skipping.  flash_kernel_tiles first writes a summary of each KV
// tile: min and max of its valid k_pos, and its count of valid slots.  A
// block works out its rows' q_pos minimum and maximum and skips a tile in
// which no (row, key) pair can be valid: no valid slot, or (causal) min
// k_pos > max q_pos, or (window) max k_pos <= min q_pos - window.  Min and
// max also cover rolling caches, whose k_pos are not monotone.  Skipping is
// exact for every row with a valid key: once a row has one, a masked key
// adds exp(-1e30 - m) = 0, and whatever a masked tile added before it is
// multiplied by exp(-1e30 - m) = 0.  A row with no valid key would lose the
// skipped slots' p = 1, so such a row is written as mean V over the S slots
// by a walk over V, in the block (prefill) or in the combine (decode: a
// split with no valid key writes (-1e30, 0, 0) and drops out).  A tile in
// which every pair is valid skips the mask.
//
// All launches are named flash_kernel_*, so one profiler match takes them in.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNeg = -1.0e30f;
constexpr int kBN = 64;         // keys per KV tile of flash_kernel_cores
constexpr int kSplitRows = 4;   // T * G at most this takes the split path
constexpr int kCombineThreads = 32 * kSplitRows;

// ---- operand types -------------------------------------------------------

// Shared rows of Q and K in flash_kernel_cores are padded so that the
// threads of a warp reading one column of 16 or 32 key rows hit distinct
// banks: an odd stride in 4-byte words (f32: hd + 1; bf16: (hd + 2) / 2).
template <typename T>
struct Op;

template <>
struct Op<float> {
  static constexpr int kPad = 1;
  __device__ static float2 load2(const float* p) { return make_float2(p[0], p[1]); }
  __device__ static float load(const float* p) { return *p; }
  __device__ static float round(float x) { return x; }
  __device__ static float store(float x) { return x; }
};

template <>
struct Op<bf16> {
  static constexpr int kPad = 2;
  __device__ static float2 load2(const bf16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  __device__ static float load(const bf16* p) { return __bfloat162float(*p); }
  __device__ static float round(float x) { return __bfloat162float(__float2bfloat16(x)); }
  __device__ static bf16 store(float x) { return __float2bfloat16(x); }
};

// ---- PTX wrappers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, asynchronously; zeros where !pred.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- tile summaries and liveness ------------------------------------------

// One warp a KV tile of bn slots: (min valid k_pos, max valid k_pos, number
// of valid slots, 0); slots past S are not counted.
__global__ void __launch_bounds__(256)
    flash_kernel_tiles(const int* __restrict__ k_pos, int4* __restrict__ tiles, int S, int bn, int nT) {
  const int lane = threadIdx.x % 32;
  const int t = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32, b = blockIdx.y;
  if (t >= nT) return;
  int kmin = INT_MAX, kmax = INT_MIN, cnt = 0;
  const int n1 = min(S, (t + 1) * bn);
  for (int n = t * bn + lane; n < n1; n += 32) {
    const int kp = k_pos[(size_t)b * S + n];
    if (kp >= 0) kmin = min(kmin, kp), kmax = max(kmax, kp), ++cnt;
  }
  for (int off = 16; off > 0; off >>= 1) {
    kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, off));
    kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, off));
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  }
  if (lane == 0) tiles[(size_t)b * nT + t] = make_int4(kmin, kmax, cnt, 0);
}

// 0: no (row, key) pair of the block can be valid; 2: every pair is valid;
// 1: otherwise.  The rule of kernels/flash.py:flash_tile_live.
__device__ __forceinline__ int tile_state(int4 ts, int bn, int qmin, int qmax, int causal, int window) {
  if (ts.z == 0) return 0;
  if (causal && ts.x > qmax) return 0;
  if (window > 0 && (long long)ts.y <= (long long)qmin - window) return 0;
  const bool full = ts.z == bn && (!causal || ts.y <= qmin) && (window <= 0 || (long long)ts.x > (long long)qmax - window);
  return full ? 2 : 1;
}

// min and max q_pos of rows [r0, r1) (row r is query r / G), in every lane.
__device__ __forceinline__ void row_bounds(const int* __restrict__ qp, int G, int r0, int r1, int& qmin, int& qmax) {
  const int lane = threadIdx.x % 32;
  qmin = INT_MAX, qmax = INT_MIN;
  for (int t = r0 / G + lane; t <= (r1 - 1) / G; t += 32) qmin = min(qmin, qp[t]), qmax = max(qmax, qp[t]);
  for (int off = 16; off > 0; off >>= 1) {
    qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, off));
    qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, off));
  }
}

// The live tiles of [t0, t1), in order, into shared `list` as
// (tile << 2) | state; returns their number.  Every thread takes part.
template <int NT>
__device__ int live_list(const int4* __restrict__ tiles, int t0, int t1, int bn, int qmin, int qmax, int causal,
                         int window, int* list, int* count) {
  const int n = t1 - t0;
  for (int i = threadIdx.x; i < n; i += NT) list[i] = tile_state(tiles[t0 + i], bn, qmin, qmax, causal, window);
  __syncthreads();
  if (threadIdx.x < 32) {  // compact in place: a lane writes at or below the slot it read
    const int lane = threadIdx.x;
    int cnt = 0;
    for (int base = 0; base < n; base += 32) {
      const int st = base + lane < n ? list[base + lane] : 0;
      const unsigned live = __ballot_sync(0xffffffffu, st != 0);
      if (st) list[cnt + __popc(live & ((1u << lane) - 1u))] = ((t0 + base + lane) << 2) | st;
      cnt += __popc(live);
    }
    if (lane == 0) *count = cnt;
  }
  __syncthreads();
  return *count;
}

// Column sums of V over the S slots of one (batch, kv head) into red[0, HD),
// for rows with no valid key.  `red` holds NT * 16 / sizeof(T) floats of
// shared memory; every thread takes part.
template <typename T, int HD, int NT>
__device__ void v_colsum(const T* __restrict__ vb, size_t stride, int S, float* red) {
  constexpr int E = 16 / (int)sizeof(T);  // values of a 16-byte piece
  constexpr int P = HD / E;               // pieces of a row
  constexpr int NG = NT / P;              // row groups
  static_assert(NG >= 1 && HD % E == 0, "colsum shape");
  const int tid = threadIdx.x;
  __syncthreads();  // red may alias tiles still being read
  if (tid < NG * P) {
    const int c = tid % P, g = tid / P;
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.0f;
#pragma unroll 4
    for (int n = g; n < S; n += NG) {
      const uint4 w = *reinterpret_cast<const uint4*>(vb + (size_t)n * stride + c * E);
      const T* x = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] += Op<T>::load(x + e);
    }
#pragma unroll
    for (int e = 0; e < E; ++e) red[g * HD + c * E + e] = acc[e];
  }
  __syncthreads();
  for (int col = tid; col < HD; col += NT) {  // each thread owns its column across the groups
    float a = 0.0f;
    for (int g = 0; g < NG; ++g) a += red[g * HD + col];
    red[col] = a;
  }
  __syncthreads();
}

// ---- bf16 prefill on the tensor cores -------------------------------------

template <int HD, int BM, int BN>
struct MmaCfg {
  static constexpr int NW = BM / 16;  // warps, 16 rows each
  static constexpr int NT = NW * 32;
  static constexpr int LD = HD + 8;  // shared row stride: 16 bytes of padding
  static constexpr int STAGES = 2;
  static constexpr bool QREG = HD <= 128;  // Q fragments held in registers
  // Q tile, K and V rings, the ring's k_pos, the live count (16 bytes); the
  // live list follows (4 bytes a tile)
  static constexpr size_t kFixed = sizeof(bf16) * ((size_t)BM * LD + 2 * STAGES * (size_t)BN * LD) +
                                   sizeof(int) * STAGES * BN + 16;
  static_assert(2 * STAGES * BN * LD * sizeof(bf16) >= NT * 32, "v_colsum's scratch fits in the rings");
};

template <int HD, int BM, int BN>
__global__ void __launch_bounds__(MmaCfg<HD, BM, BN>::NT)
    flash_kernel_mma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                     const int* __restrict__ q_pos, const int* __restrict__ k_pos, const int4* __restrict__ tiles,
                     bf16* __restrict__ out, int T_len, int S, int H, int KV, float scale, int causal, int window,
                     float softcap) {
  using C = MmaCfg<HD, BM, BN>;
  constexpr int NT = C::NT, LD = C::LD, STAGES = C::STAGES;
  constexpr int KS = HD / 16;  // k-steps of Q K^T
  constexpr int NS = BN / 8;   // score n-tiles
  constexpr int NO = HD / 8;   // output n-tiles
  constexpr int P = HD / 8;    // 16-byte pieces of a row
  static_assert(HD % 16 == 0 && BN % 16 == 0 && BM % 16 == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BM * LD;
  bf16* Vs = Ks + STAGES * BN * LD;
  int* kps = reinterpret_cast<int*>(Vs + STAGES * BN * LD);
  int* count = kps + STAGES * BN;
  int* list = count + 4;

  const int G = H / KV, rows = T_len * G;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BM;  // the last rows, which see the most keys, start first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nT = (S + BN - 1) / BN;
  const size_t kstride = (size_t)KV * HD;  // between keys
  const bf16* kb = k + (size_t)b * S * kstride + (size_t)kvh * HD;
  const bf16* vb = v + (size_t)b * S * kstride + (size_t)kvh * HD;
  const int* kpb = k_pos + (size_t)b * S;
  const int* qpb = q_pos + (size_t)b * T_len;

  // Q tile into shared memory (rows past `rows` zero): the first copy group
  for (int idx = tid; idx < BM * P; idx += NT) {
    const int r = idx / P, c = idx % P, gr = r0 + r;
    const bf16* src = gr < rows ? q + ((size_t)(b * T_len + gr / G) * H + kvh * G + gr % G) * HD + c * 8 : q;
    cp_async16(Qs + r * LD + c * 8, src, gr < rows);
  }
  cp_async_commit();

  int qmin, qmax;
  row_bounds(qpb, G, r0, min(rows, r0 + BM), qmin, qmax);
  const int n_live = live_list<NT>(tiles + (size_t)b * nT, 0, nT, BN, qmin, qmax, causal, window, list, count);

  // K, V and k_pos of one tile into a ring stage (slots past S zero)
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
  cp_async_wait<1>();  // Q has landed
  __syncthreads();

  uint32_t qf[C::QREG ? KS : 1][4];
  if constexpr (C::QREG) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) ldsm_x4(qf[kk], Qs + (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8);
  }

  // this thread's rows: lane / 4 and lane / 4 + 8 of the warp's 16
  const int gr0 = r0 + warp * 16 + lane / 4;
  int qp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) qp[i] = gr0 + 8 * i < rows ? qpb[(gr0 + 8 * i) / G] : 0;

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};

  for (int it = 0; it < n_live; ++it) {
    const int entry = list[it], stage = it % STAGES;
    if (it + 1 < n_live) load_tile(list[it + 1], (it + 1) % STAGES);
    cp_async_commit();
    cp_async_wait<1>();  // this tile has landed
    __syncthreads();
    const bf16* Kt = Ks + stage * BN * LD;
    const bf16* Vt = Vs + stage * BN * LD;
    const int* kpt = kps + stage * BN;
    const int n0 = (entry >> 2) * BN;

    // S = Q K^T
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      if constexpr (C::QREG) {
        a[0] = qf[kk][0], a[1] = qf[kk][1], a[2] = qf[kk][2], a[3] = qf[kk][3];
      } else {
        ldsm_x4(a, Qs + (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8);
      }
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        uint32_t kf[4];
        ldsm_x4(kf, Kt + (jp * 16 + (lane / 16) * 8 + lane % 8) * LD + kk * 16 + ((lane / 8) & 1) * 8);
        mma_bf16(s[2 * jp], a, kf[0], kf[1]);
        mma_bf16(s[2 * jp + 1], a, kf[2], kf[3]);
      }
    }

    // scale, softcap, mask; the rows' max over the quad
    const bool full = (entry & 3) == 2;
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        if (!full) {
          const int col = j * 8 + (lane % 4) * 2 + (e & 1);
          const int kp = kpt[col], qv = qp[e >> 1];
          bool ok = n0 + col < S && kp >= 0;
          if (causal) ok = ok && kp <= qv;
          if (window > 0) ok = ok && kp > qv - window;
          if (!ok) x = kNeg;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      const float corr = __expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr;
#pragma unroll
      for (int n = 0; n < NO; ++n) o[n][2 * i] *= corr, o[n][2 * i + 1] *= corr;
    }

    // p in registers: l takes it unrounded, the bf16 A fragments rounded;
    // O += P V with V's B fragments from ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      float p[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[jj][e] = __expf(s[2 * kk + jj][e] - m[e >> 1]);
          l[e >> 1] += p[jj][e];
        }
      const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]), pack_bf16(p[1][0], p[1][1]),
                              pack_bf16(p[1][2], p[1][3])};
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, Vt + (kk * 16 + lane % 16) * LD + np * 16 + (lane / 16) * 8);
        mma_bf16(o[2 * np], pa, vf[0], vf[1]);
        mma_bf16(o[2 * np + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const bool none[2] = {gr0 < rows && m[0] == kNeg, gr0 + 8 < rows && m[1] == kNeg};
  float* red = reinterpret_cast<float*>(Ks);
  if (__syncthreads_or(none[0] || none[1])) v_colsum<bf16, HD, NT>(vb, kstride, S, red);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gr = gr0 + 8 * i;
    if (gr >= rows) continue;
    bf16* dst = out + ((size_t)(b * T_len + gr / G) * H + kvh * G + gr % G) * HD;
    const float den = none[i] ? (float)S : fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = n * 8 + (lane % 4) * 2;
      const float x0 = none[i] ? red[col] : o[n][2 * i], x1 = none[i] ? red[col + 1] : o[n][2 * i + 1];
      *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(x0 / den, x1 / den);
    }
  }
}

// ---- the CUDA-core kernel: f32 prefill, and decode's splits ---------------

// One KV tile into shared memory: kBN key rows of K (row stride LD) and of
// V (row stride HD), row n at k + n * stride; rows past `valid` are zeros.
// 16-byte global loads, up to four of K and four of V in flight a thread
// before its stores.  Shared rows are only 4-byte aligned (the padding), so
// each piece is stored as four words.
template <typename T, int HD, int NT>
__device__ __forceinline__ void load_kv_tile(T* Ks, T* Vs, const T* __restrict__ k, const T* __restrict__ v,
                                             size_t stride, int valid) {
  constexpr int LD = HD + Op<T>::kPad;
  constexpr int P = HD * (int)sizeof(T) / 16;  // 16-byte pieces of a row
  constexpr int TOTAL = kBN * P;
  constexpr int N = (TOTAL + NT - 1) / NT;  // pieces a thread, of each of K and V
  constexpr int STEP = N < 4 ? N : 4;
#pragma unroll
  for (int i0 = 0; i0 < N; i0 += STEP) {
    uint4 kp[STEP], vp[STEP];
#pragma unroll
    for (int i = 0; i < STEP; ++i) {
      const int idx = threadIdx.x + (i0 + i) * NT, r = idx / P, c = idx % P;
      kp[i] = vp[i] = make_uint4(0u, 0u, 0u, 0u);
      if (i0 + i < N && idx < TOTAL && r < valid) {
        kp[i] = reinterpret_cast<const uint4*>(k + r * stride)[c];
        vp[i] = reinterpret_cast<const uint4*>(v + r * stride)[c];
      }
    }
#pragma unroll
    for (int i = 0; i < STEP; ++i) {
      const int idx = threadIdx.x + (i0 + i) * NT, r = idx / P, c = idx % P;
      if (i0 + i < N && idx < TOTAL) {
        uint32_t* kd = reinterpret_cast<uint32_t*>(Ks + r * LD) + 4 * c;
        uint32_t* vd = reinterpret_cast<uint32_t*>(Vs + r * HD) + 4 * c;
        kd[0] = kp[i].x, kd[1] = kp[i].y, kd[2] = kp[i].z, kd[3] = kp[i].w;
        vd[0] = vp[i].x, vd[1] = vp[i].y, vd[2] = vp[i].z, vd[3] = vp[i].w;
      }
    }
  }
}

// Shared memory of flash_kernel_cores: Q tile (BM x LD), K tile (kBN x LD),
// V tile (kBN x HD), P tile (BM x kBN + 1, f32), the rows' q_pos and the
// keys' k_pos, the live count (16 bytes); the live list follows (4 bytes a
// tile).  At least v_colsum's scratch.
template <typename T, int HD, int BM, int NT>
__host__ __device__ constexpr size_t cores_smem_fixed() {
  const size_t tiles = sizeof(T) * ((size_t)(BM + kBN) * (HD + Op<T>::kPad) + (size_t)kBN * HD) +
                       sizeof(float) * (size_t)BM * (kBN + 1) + sizeof(int) * (size_t)(BM + kBN) + 16;
  const size_t colsum = sizeof(T) * (size_t)BM * (HD + Op<T>::kPad) + (size_t)NT * 64 + 16;
  return tiles > colsum ? tiles : colsum;
}

// BM query rows a block, RM rows a thread, TX threads across the keys (and
// the output columns) of a row group; TX divides 32, so a row group's
// reductions are warp shuffles.  Block z takes the z-th of `splits` equal
// runs of KV tiles; with `part` it writes its rows' partial (acc[HD], m, l)
// there, (0, -1e30, 0) for a row without a valid key in its run; without,
// the finished output.
template <typename T, int HD, int BM, int RM, int TX>
__global__ void __launch_bounds__((BM / RM) * TX)
    flash_kernel_cores(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const int* __restrict__ q_pos, const int* __restrict__ k_pos, const int4* __restrict__ tiles,
                       T* __restrict__ out, float* __restrict__ part, int T_len, int S, int H, int KV, float scale,
                       int causal, int window, float softcap, int splits) {
  constexpr int TY = BM / RM;
  constexpr int NT = TY * TX;
  constexpr int SC = kBN / TX;            // score columns a thread
  constexpr int OC = (HD + TX - 1) / TX;  // output columns a thread
  constexpr int LD = HD + Op<T>::kPad;    // shared row stride of Q and K
  constexpr int LP = kBN + 1;             // shared row stride of P
  constexpr int W = HD * (int)sizeof(T) / 4;  // 4-byte words of one row
  static_assert(TX <= 32 && 32 % TX == 0 && kBN % TX == 0 && BM % RM == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + BM * LD;
  T* Vs = Ks + kBN * LD;
  float* Ps = reinterpret_cast<float*>(Vs + kBN * HD);
  int* qp_s = reinterpret_cast<int*>(Ps + BM * LP);
  int* kp_s = qp_s + BM;
  int* list = reinterpret_cast<int*>(smem + cores_smem_fixed<T, HD, BM, NT>());
  int* count = list - 4;

  const int G = H / KV;
  const int rows = T_len * G;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int r0 = blockIdx.x * BM;
  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  const int nT = (S + kBN - 1) / kBN, per = (nT + splits - 1) / splits;
  const int t0 = min(nT, (int)blockIdx.z * per), t1 = min(nT, t0 + per);

  for (int idx = tid; idx < BM * W; idx += NT) {
    const int r = idx / W, w = idx % W, gr = r0 + r;
    uint32_t val = 0;
    if (gr < rows) {
      const int t = gr / G, h = kvh * G + gr % G;
      val = reinterpret_cast<const uint32_t*>(q + ((size_t)(b * T_len + t) * H + h) * HD)[w];
    }
    reinterpret_cast<uint32_t*>(Qs + r * LD)[w] = val;
  }
  for (int r = tid; r < BM; r += NT) {
    const int gr = r0 + r;
    qp_s[r] = gr < rows ? q_pos[(size_t)b * T_len + gr / G] : 0;
  }
  int qmin, qmax;
  row_bounds(q_pos + (size_t)b * T_len, G, r0, min(rows, r0 + BM), qmin, qmax);
  const int n_live = live_list<NT>(tiles + (size_t)b * nT, t0, t1, kBN, qmin, qmax, causal, window, list, count);

  float m[RM], l[RM], o[RM][OC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < OC; ++c) o[i][c] = 0.0f;
  }

  const size_t row_stride = (size_t)KV * HD;  // between keys
  const T* kb = k + (size_t)b * S * row_stride + (size_t)kvh * HD;
  const T* vb = v + (size_t)b * S * row_stride + (size_t)kvh * HD;
  for (int it = 0; it < n_live; ++it) {
    const int n0 = (list[it] >> 2) * kBN;
    __syncthreads();  // the previous tile's K, V and P are read
    load_kv_tile<T, HD, NT>(Ks, Vs, kb + (size_t)n0 * row_stride, vb + (size_t)n0 * row_stride, row_stride,
                            S - n0);
    for (int n = tid; n < kBN; n += NT) kp_s[n] = n0 + n < S ? k_pos[(size_t)b * S + n0 + n] : -1;
    __syncthreads();

    // scores of rows ty*RM + i against keys tx + j*TX
    float s[RM][SC];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 2) {
      float2 a[RM], c[SC];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = Op<T>::load2(Qs + (ty * RM + i) * LD + d);
#pragma unroll
      for (int j = 0; j < SC; ++j) c[j] = Op<T>::load2(Ks + (tx + j * TX) * LD + d);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < SC; ++j) s[i][j] = fmaf(a[i].y, c[j].y, fmaf(a[i].x, c[j].x, s[i][j]));
    }

    // mask, online softmax, P into shared memory
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qp = qp_s[ty * RM + i];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        float x = s[i][j] * scale;
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        const int kp = kp_s[tx + j * TX];
        bool ok = kp >= 0;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        s[i][j] = ok ? x : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty * RM + i) * LP + tx + j * TX] = Op<T>::round(p);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < OC; ++c) o[i][c] *= corr;
    }
    __syncthreads();

    // o += P V over the tile's keys
#pragma unroll 4
    for (int n = 0; n < kBN; ++n) {
      float p[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) p[i] = Ps[(ty * RM + i) * LP + n];
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const int col = tx + c * TX;
        if (OC * TX == HD || col < HD) {
          const float x = Op<T>::load(Vs + n * HD + col);
#pragma unroll
          for (int i = 0; i < RM; ++i) o[i][c] = fmaf(p[i], x, o[i][c]);
        }
      }
    }
  }

  if (part != nullptr) {  // a split: the partial of each row
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int gr = r0 + ty * RM + i;
      if (gr >= rows) continue;
      float* dst = part + (((size_t)blockIdx.y * splits + blockIdx.z) * rows + gr) * (HD + 2);
      const bool none = m[i] == kNeg;
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const int col = tx + c * TX;
        if (OC * TX == HD || col < HD) dst[col] = none ? 0.0f : o[i][c];
      }
      if (tx == 0) dst[HD] = m[i], dst[HD + 1] = none ? 0.0f : l[i];
    }
    return;
  }

  bool any = false;
#pragma unroll
  for (int i = 0; i < RM; ++i) any = any || (r0 + ty * RM + i < rows && m[i] == kNeg);
  float* red = reinterpret_cast<float*>(Ks);
  if (__syncthreads_or(any)) v_colsum<T, HD, NT>(vb, row_stride, S, red);
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int gr = r0 + ty * RM + i;
    if (gr >= rows) continue;
    const int t = gr / G, h = kvh * G + gr % G;
    T* dst = out + ((size_t)(b * T_len + t) * H + h) * HD;
    const bool none = m[i] == kNeg;
    const float den = none ? (float)S : fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int col = tx + c * TX;
      if (OC * TX == HD || col < HD) dst[col] = Op<T>::store((none ? red[col] : o[i][c]) / den);
    }
  }
}

// ---- decode's combine -------------------------------------------------------

// One block a (batch, kv head): m = max m_i over the splits, a warp a row;
// the weights exp(m_i - m) into shared memory (dynamic: rows x splits),
// l = sum l_i exp(m_i - m); then a thread a (row, column):
// acc = sum acc_i exp(m_i - m) over the splits in order, every split's
// load independent of the sum, out = acc / max(l, 1e-30).  A row with no
// valid key in any split (m = -1e30) gets mean V over the S slots.
template <typename T, int HD>
__global__ void __launch_bounds__(kCombineThreads)
    flash_kernel_combine(const float* __restrict__ part, const T* __restrict__ v, T* __restrict__ out, int T_len,
                         int S, int H, int KV, int splits) {
  __shared__ __align__(16) float red[kCombineThreads * 16 / sizeof(T)];
  __shared__ float m_s[kSplitRows], l_s[kSplitRows];
  extern __shared__ float w_s[];
  const int G = H / KV, rows = T_len * G;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row_len = HD + 2, split_stride = (size_t)rows * row_len;
  const float* pb = part + (size_t)blockIdx.x * splits * split_stride;
  if (w < rows) {
    float m = kNeg, l = 0.0f;
    for (int i = lane; i < splits; i += 32) m = fmaxf(m, pb[i * split_stride + w * row_len + HD]);
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    for (int i = lane; i < splits; i += 32) {
      const float* pi = pb + i * split_stride + w * row_len;
      const float wt = expf(pi[HD] - m);
      w_s[w * splits + i] = wt;
      l += pi[HD + 1] * wt;
    }
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) m_s[w] = m, l_s[w] = l;
  }
  __syncthreads();
  bool none = false;
  for (int r = 0; r < rows; ++r) none = none || m_s[r] == kNeg;
  const size_t row_stride = (size_t)KV * HD;
  if (none) v_colsum<T, HD, kCombineThreads>(v + (size_t)b * S * row_stride + (size_t)kvh * HD, row_stride, S, red);
  for (int idx = threadIdx.x; idx < rows * HD; idx += kCombineThreads) {
    const int r = idx / HD, c = idx % HD;
    T* dst = out + ((size_t)(b * T_len + r / G) * H + kvh * G + r % G) * HD + c;
    if (m_s[r] == kNeg) {
      *dst = Op<T>::store(red[c] / (float)S);
      continue;
    }
    const float* pc = pb + r * row_len + c;
    const float* wr = w_s + r * splits;
    float acc = 0.0f;
#pragma unroll 8
    for (int i = 0; i < splits; ++i) acc += pc[i * split_stride] * wr[i];
    *dst = Op<T>::store(acc / fmaxf(l_s[r], 1e-30f));
  }
}

// ---- launches ---------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  const int *q_pos, *k_pos;
  void* out;
  int B, T, S, H, KV;
  float scale;
  int causal, window;
  float softcap;
  int splits;
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

// The tile summaries of k_pos, in tiles of bn, at the scratch's start.
cudaError_t launch_tiles(const Args& a, int bn, size_t need) {
  if (a.scratch_bytes < need) return cudaErrorInvalidValue;
  const int nT = (a.S + bn - 1) / bn;
  flash_kernel_tiles<<<dim3((nT + 7) / 8, a.B), 256, 0, a.stream>>>(a.k_pos, reinterpret_cast<int4*>(a.scratch),
                                                                     a.S, bn, nT);
  return cudaGetLastError();
}

template <int HD, int BM, int BN>
cudaError_t launch_mma(const Args& a) {
  using C = MmaCfg<HD, BM, BN>;
  const int nT = (a.S + BN - 1) / BN;
  cudaError_t err = launch_tiles(a, BN, (size_t)a.B * nT * sizeof(int4));
  if (err != cudaSuccess) return err;
  auto kern = flash_kernel_mma<HD, BM, BN>;
  const size_t smem = C::kFixed + sizeof(int) * (size_t)nT;
  if ((err = allow_smem(kern, smem)) != cudaSuccess) return err;
  const int rows = a.T * (a.H / a.KV);
  kern<<<dim3((rows + BM - 1) / BM, a.B * a.KV), C::NT, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v), a.q_pos, a.k_pos,
      reinterpret_cast<const int4*>(a.scratch), static_cast<bf16*>(a.out), a.T, a.S, a.H, a.KV, a.scale, a.causal,
      a.window, a.softcap);
  return cudaGetLastError();
}

template <typename T, int HD, int BM, int RM, int TX>
cudaError_t launch_cores(const Args& a, float* part, int splits) {
  constexpr int NT = (BM / RM) * TX;
  const int nT = (a.S + kBN - 1) / kBN, per = (nT + splits - 1) / splits;
  auto kern = flash_kernel_cores<T, HD, BM, RM, TX>;
  const size_t smem = cores_smem_fixed<T, HD, BM, NT>() + sizeof(int) * (size_t)per;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const int rows = a.T * (a.H / a.KV);
  kern<<<dim3((rows + BM - 1) / BM, a.B * a.KV, splits), NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.q_pos, a.k_pos,
      reinterpret_cast<const int4*>(a.scratch), static_cast<T*>(a.out), part, a.T, a.S, a.H, a.KV, a.scale,
      a.causal, a.window, a.softcap, splits);
  return cudaGetLastError();
}

// Decode: T * G <= 4 rows of a (batch, kv head) in one 4-row tile, one
// warp a row, over `splits` runs of KV tiles; then the combine.
template <typename T, int HD>
cudaError_t launch_split(const Args& a) {
  if (a.splits < 1) return cudaErrorInvalidValue;
  const int nT = (a.S + kBN - 1) / kBN, rows = a.T * (a.H / a.KV);
  const size_t tiles = align16((size_t)a.B * nT * sizeof(int4));
  const size_t need = tiles + sizeof(float) * (size_t)a.B * a.KV * a.splits * rows * (HD + 2);
  cudaError_t err = launch_tiles(a, kBN, need);
  if (err != cudaSuccess) return err;
  float* part = reinterpret_cast<float*>(a.scratch + tiles);
  if ((err = launch_cores<T, HD, kSplitRows, 1, 32>(a, part, a.splits)) != cudaSuccess) return err;
  auto combine = flash_kernel_combine<T, HD>;
  const size_t smem = sizeof(float) * (size_t)rows * a.splits;  // the weights
  if ((err = allow_smem(combine, smem)) != cudaSuccess) return err;
  combine<<<a.B * a.KV, kCombineThreads, smem, a.stream>>>(part, static_cast<const T*>(a.v), static_cast<T*>(a.out),
                                                             a.T, a.S, a.H, a.KV, a.splits);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(const Args& a, int dtype) {
  const bool split = a.T * (a.H / a.KV) <= kSplitRows;
  if (dtype == 0) {
    if (split) return launch_split<float, HD>(a);
    const int nT = (a.S + kBN - 1) / kBN;
    cudaError_t err = launch_tiles(a, kBN, (size_t)a.B * nT * sizeof(int4));
    if (err != cudaSuccess) return err;
    return launch_cores<float, HD, 64, 4, 16>(a, nullptr, 1);
  }
  if (split) return launch_split<bf16, HD>(a);
  if constexpr (HD <= 64) return launch_mma<HD, 128, 64>(a);
  else if constexpr (HD <= 128) return launch_mma<HD, 64, 64>(a);
  else return launch_mma<HD, 64, 32>(a);
}

}  // namespace

// q (B, T, H, hd), k/v (B, S, KV, hd) in f32 (dtype 0) or bf16 (dtype 1);
// q_pos (B, T), k_pos (B, S) int32 -> out (B, T, H, hd) in the same type.
// scale is hd^-0.5; window <= 0 means none, softcap <= 0 none.  `splits`
// runs of KV tiles when T * H / KV <= 4 (decode).  `scratch` (16-byte
// aligned, scratch_bytes long) takes the tile summaries and decode's
// partials; kernels/flash.py:scratch_bytes gives the size.  Returns
// cudaGetLastError() of the last launch, or the first failure.
extern "C" int flash_launch(const void* q, const void* k, const void* v, const int* q_pos, const int* k_pos,
                            void* out, int B, int T, int S, int H, int KV, int hd, int dtype, float scale, int causal,
                            int window, float softcap, int splits, void* scratch, size_t scratch_bytes,
                            cudaStream_t stream) {
  if (B <= 0 || T <= 0) return (int)cudaGetLastError();
  if (KV <= 0 || H % KV != 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  if (S <= 0)  // no key slot: the plain version's 0 / max(0, 1e-30)
    return (int)cudaMemsetAsync(out, 0, (size_t)B * T * H * hd * (dtype == 0 ? 4 : 2), stream);
  const Args a{q, k, v, q_pos, k_pos, out, B, T, S, H, KV, scale, causal, window, softcap, splits,
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
