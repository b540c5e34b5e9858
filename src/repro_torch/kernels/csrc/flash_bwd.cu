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
// dK and dV sum over the G query heads of their kv head.  A row with no
// valid key has lse = +inf (flash.cu's row_lse), so P = 0 at every slot of
// it; the forward gave it the mean of V over the S slots, so each slot's dV
// also takes E / S, E the sum of dO over the group's empty rows, and dQ and
// dK take nothing from it.  A masked pair has P = 0 and adds nothing, so the
// tiles flash_tile_live rules out are skipped exactly, and causal training
// does about half the work.
//
// Layout as flash.cu: q, out, dout and dq (B, T, H, hd); k, v, dk and dv
// (B, S, KV, hd); lse (B, T, H) f32.
//
// Launches, all named flash_bwd_kernel_*:
//   * flash_bwd_kernel_tiles (twice): summaries (min, max, count of the
//     positions >= 0) of the key tiles of the dQ kernel and of the row tiles
//     of the dK/dV kernel; the first also copies k_pos (bf16), padded with -1;
//   * flash_bwd_kernel_dot: D, four lanes a row, into (B, H, Tp) f32 beside a
//     copy of lse (+inf past T) and of q_pos, Tp = T rounded up to 128, so
//     that a tile's 64 values are one 256-byte bulk copy;
//   * flash_bwd_kernel_empty: E of each (batch, kv head), in a fixed order;
//   * flash_bwd_kernel_dkv_*: a block per (batch, kv head, tile of keys)
//     that loops over the live row tiles, dK and dV of its keys in
//     registers;
//   * flash_bwd_kernel_dq_*: a block per (batch, query head, tile of rows)
//     that loops over the live key tiles, dQ of its rows in registers.
// Every output element is written once, by one thread, with no atomics: the
// result is the same from run to run.  dQ stays a kernel of its own, which
// computes S and dP again (seven products a pair where the bound counts
// five), so that nothing is summed across blocks.
//
// bf16 (..._dkv_wgmma, ..._dq_wgmma) runs its products on wgmma with f32
// accumulators, in blocks of two warpgroups (256 threads), each 64 keys or
// 64 rows.  Every tile comes by TMA (cp.async.bulk.tensor into 128-byte
// swizzled panels of 64 columns, hd 80 in two; 32-byte swizzled panels of
// 16 columns at hd 16), the rows' lse, D and positions by bulk copies
// (cp.async.bulk), through a ring of stages with a full and an empty
// mbarrier each; thread 0 drives the copies between its own steps (Ring).
// No warp is set aside to copy: with 8 warps a block keeps 2 on each of the
// SM's four register files, so a thread may hold 255 registers, where a
// ninth warp caps them at 168 and the dK/dV accumulators spill (a producer
// warpgroup with setmaxnreg, tried first, did not raise ptxas' allocation
// of the other warpgroups past the launch bound's 168).
//   dK/dV: a block holds 128 keys (64 a warpgroup) and loops over G query
//   heads x the live tiles of 64 queries, whose Q and dO tiles are 2-D
//   boxes of the (B T, H hd) view at column (kvh G + g) hd.  Per tile: S^T =
//   K Q^T and dP^T = V dO^T from shared memory (both K-major, m64n64k16),
//   then, 16 queries at a time, P^T and dS^T in registers (mask, softcap,
//   exp2 of the scores against lse, D; the softcap's tanh only where there
//   is one) and dV += P^T dO, dK += dS^T Q with P^T and dS^T as bf16 A
//   fragments from the accumulators and dO and Q read MN-major, started
//   while the next 16 queries are worked out.  At hd 256
//   dK and dV of 64 keys do not fit one warpgroup's registers: both
//   warpgroups take the same 64 keys and compute S^T and dP^T each, and
//   each holds half of dK's and dV's columns (the two score products are
//   done twice; nothing passes through shared memory).
//   dQ: a block of 128 rows (64 a warpgroup) of one query head holds Q and
//   dO, and K and V tiles of 128 keys (32 at hd 256, where dQ takes 128
//   registers a thread and two stages must fit beside Q and dO) come
//   through the ring: S = Q K^T, dP = dO V^T, dS in registers, dQ += dS K
//   with K read MN-major, 16 keys at a time; dQ written once in bf16.
// Causal work: the dK/dV blocks of the first keys and the dQ blocks of the
// last rows, which see the most tiles, start first.  f32 (..._cores) runs
// on the CUDA cores in f32, tiles of 32 rows by 32 keys.  Bound:
// operations, five products of 2 hd flops a valid (query, key) pair, 2.5
// times the forward's.

#include <cuda.h>
#include <cudaTypedefs.h>

#include <type_traits>

#include "flash_common.cuh"

namespace {

constexpr int kCoreTile = 32;  // rows and keys a tile of the f32 kernels
constexpr int kCoreThreads = 256;
constexpr int kTile = 64;          // rows and keys a tile of the bf16 kernels
constexpr int kPadRows = 128;      // Tp: T rounded up to this
constexpr long long kWaitCycles = 1LL << 34;  // an mbarrier wait that takes this long traps

// ---- summaries, D, E -----------------------------------------------------

// One warp a tile: (min, max, count) of the positions >= 0 in tile t.  For
// key tiles (G = 1, len = S): slots [t * tile, min(S, (t + 1) * tile)).  For
// row tiles (len = T): the queries of rows [t * tile, min(T * G, (t + 1) *
// tile)), row r being query r / G.  With `pad` (G = 1), the tile's positions
// also go to pad (B, nT * tile), -1 past len.
__global__ void __launch_bounds__(256)
    flash_bwd_kernel_tiles(const int* __restrict__ pos, int4* __restrict__ tiles, int* __restrict__ pad, int len,
                           int G, int tile, int nT) {
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
  if (pad != nullptr)
    for (int n = t * tile + lane; n < (t + 1) * tile; n += 32)
      pad[(size_t)b * nT * tile + n] = n < len ? pos[(size_t)b * len + n] : -1;
}

// 16 bytes of operands, as floats.
__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
__device__ __forceinline__ void load16(const bf16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x, x[2 * i + 1] = f.y;
  }
}

// Four lanes a row (b, t, h) of the B Tp H rows, 16-byte loads: D =
// rowsum(dO o O) in f32 and lse into (B, H, Tp) (0 and +inf past T), and
// q_pos into qpad (B, Tp).
template <typename T>
__global__ void __launch_bounds__(256)
    flash_bwd_kernel_dot(const T* __restrict__ out, const T* __restrict__ dout, const float* __restrict__ lse,
                         const int* __restrict__ q_pos, float* __restrict__ dsum, float* __restrict__ lsec,
                         int* __restrict__ qpad, int B, int T_len, int Tp, int H, int hd) {
  constexpr int V = 16 / sizeof(T);
  const int lane = threadIdx.x % 32;
  const size_t row = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) / 4;
  const bool live = row < (size_t)B * Tp * H;
  const int h = (int)(row % H), t = (int)(row / H % Tp), b = (int)(row / H / Tp);
  float acc = 0.0f;
  if (live && t < T_len) {
    const size_t src = ((size_t)(b * T_len + t) * H + h) * hd;
    for (int c = V * (lane % 4); c < hd; c += 4 * V) {
      float o[V], g[V];
      load16(out + src + c, o);
      load16(dout + src + c, g);
#pragma unroll
      for (int v = 0; v < V; ++v) acc = fmaf(o[v], g[v], acc);
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  if (live && lane % 4 == 0) {
    const size_t dst = (size_t)(b * H + h) * Tp + t;
    dsum[dst] = acc;
    lsec[dst] = t < T_len ? lse[(size_t)(b * T_len + t) * H + h] : INFINITY;
    if (h == 0) qpad[(size_t)b * Tp + t] = t < T_len ? q_pos[(size_t)b * T_len + t] : -1;
  }
}

// E of one (batch, kv head) a block: the sum of dO over the rows of its G
// heads whose lse is +inf (no valid key), f32, into esum (B, KV, hd).  Each
// warp takes runs of 32 rows (head-major, then query) in turn and adds its
// empty rows in order; the warps' sums add in warp order.
constexpr int kEmptyWarps = 32;

template <typename T>
__global__ void __launch_bounds__(32 * kEmptyWarps)
    flash_bwd_kernel_empty(const float* __restrict__ lsec, const T* __restrict__ dout, float* __restrict__ esum,
                           int T_len, int Tp, int H, int KV, int hd) {
  __shared__ float red[kEmptyWarps][256];
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV, G = H / KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, n = G * Tp;
  const float* lb = lsec + (size_t)(b * H + kvh * G) * Tp;
  float acc[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) acc[u] = 0.0f;
  for (int base = warp * 32; base < n; base += 32 * kEmptyWarps) {
    const int i = base + lane;
    unsigned empty = __ballot_sync(0xffffffffu, i < n && i % Tp < T_len && lb[i] == INFINITY);
    while (empty) {
      const int r = base + __ffs(empty) - 1;
      empty &= empty - 1;
      const T* row = dout + ((size_t)(b * T_len + r % Tp) * H + kvh * G + r / Tp) * hd;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (lane + 32 * u < hd) acc[u] += Op<T>::load(row + lane + 32 * u);
    }
  }
#pragma unroll
  for (int u = 0; u < 8; ++u)
    if (lane + 32 * u < hd) red[warp][lane + 32 * u] = acc[u];
  __syncthreads();
  for (int c = threadIdx.x; c < hd; c += 32 * kEmptyWarps) {
    float s = 0.0f;
    for (int w = 0; w < kEmptyWarps; ++w) s += red[w][c];
    esum[(size_t)blockIdx.x * hd + c] = s;
  }
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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// P and dS of one pair on the tensor-core path, from its raw products: p =
// exp(s - lse) with s the scaled (CAP: softcapped) score, as exp2 of s
// log2(e) - lse2 (lse2 = lse log2(e), scale2 = scale log2(e)), 0 where
// masked; dp becomes dS = p (dp - D) [(1 - tanh^2)].
template <bool CAP>
__device__ __forceinline__ void pair_grad(float raw, float& dp, bool ok, float lse2, float d, float scale, float scale2,
                                          float softcap, float& pr) {
  if constexpr (CAP) {
    const float t = tanhf(raw * scale / softcap);
    pr = ok ? ex2(softcap * kLog2e * t - lse2) : 0.0f;
    dp = pr * (dp - d) * (1.0f - t * t);
  } else {
    pr = ok ? ex2(fmaf(raw, scale2, -lse2)) : 0.0f;
    dp = pr * (dp - d);
  }
}

__device__ __forceinline__ bool pair_ok(int kp, int qp, int causal, int window) {
  bool ok = kp >= 0;
  if (causal) ok = ok && kp <= qp;
  if (window > 0) ok = ok && kp > qp - window;
  return ok;
}

// ---- Hopper: mbarriers, TMA, wgmma ------------------------------------------

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Waits for the phase of bar with this parity to complete; a copy that
// never lands (some 8 s) fails the launch rather than hanging the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  const long long t = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t > kWaitCycles) __trap();
  } while (!done);
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// The copying thread's arrival, with the bytes its copies of this phase bring.
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// A box of a 2-D tensor map at (column c0, row c1) into shared memory,
// completing on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// bytes (a multiple of 16, both ends 16-byte aligned) from global memory
// into shared memory, completing on bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Ties the registers to this point: the compiler neither reads an
// accumulator before the wgmma that writes it has been waited for, nor
// moves its writes past the next wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets, swizzle (1: 128 bytes, 3: 32 bytes).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint32_t swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         ((uint64_t)swizzle << 62);
}

// d (64 x 32) += A (64 x 16) B (16 x 32), both from shared memory, K-major;
// d's old value counts where acc != 0.
__device__ __forceinline__ void wgmma_ss32(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 64) += A (64 x 16) B (16 x 64), both from shared memory, K-major;
// d's old value counts where acc != 0.
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 128) += A (64 x 16) B (16 x 128), both from shared memory, K-major;
// d's old value counts where acc != 0.
__device__ __forceinline__ void wgmma_ss128(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 16) += A (64 x 16, bf16 fragments in registers) B (16 x 16, shared
// memory, MN-major); d's old value counts where acc != 0.
__device__ __forceinline__ void wgmma_rs16(float (&d)[8], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, "
      "%12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// d (64 x 64) += A (64 x 16, bf16 fragments in registers) B (16 x 64, shared
// memory, MN-major); d's old value counts where acc != 0.
__device__ __forceinline__ void wgmma_rs64(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, "
      "%36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// d (64 x 80) += A (64 x 16, bf16 fragments in registers) B (16 x 80, shared
// memory, MN-major); d's old value counts where acc != 0.
__device__ __forceinline__ void wgmma_rs80(float (&d)[40], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, "
      "%44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// d (64 x 128) += A (64 x 16, bf16 fragments in registers) B (16 x 128, shared
// memory, MN-major); d's old value counts where acc != 0.
__device__ __forceinline__ void wgmma_rs128(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, "
      "%68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// d (64 x 256) += A (64 x 16, bf16 fragments in registers) B (16 x 256, shared
// memory, MN-major); d's old value counts where acc != 0.
__device__ __forceinline__ void wgmma_rs256(float (&d)[128], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, "
      "%132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (N == 32) wgmma_ss32(d, da, db, acc);
  else if constexpr (N == 64) wgmma_ss64(d, da, db, acc);
  else wgmma_ss128(d, da, db, acc);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db, int acc) {
  if constexpr (N == 16) wgmma_rs16(d, a, db, acc);
  else if constexpr (N == 64) wgmma_rs64(d, a, db, acc);
  else if constexpr (N == 80) wgmma_rs80(d, a, db, acc);
  else if constexpr (N == 128) wgmma_rs128(d, a, db, acc);
  else wgmma_rs256(d, a, db, acc);
}

// The bf16 A fragments (m64k16) of k-step kk from a 64 x N accumulator:
// its n8 tiles 2 kk and 2 kk + 1, as the wgmma D layout is the A layout in
// pairs.
template <int R>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&d)[R], int kk) {
  a[0] = pack_bf16(d[8 * kk], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// ---- bf16 on wgmma ------------------------------------------------------------

// How a tile of R rows x HD bf16 columns lies in shared memory, as the TMA
// writes it: NP panels of PW columns (64 from hd 64 up, 16 at hd 16), each
// R rows of PW * 2 bytes swizzled in groups of 8 rows (128-byte swizzle for
// PW 64, 32-byte for PW 16); a panel starts on a multiple of 1024 bytes.
// hd 80's second panel holds 64 columns of which the products read 16 (the
// next head's, or zeros past the row's end, fill the rest).
template <int HD>
struct Panels {
  static constexpr int PW = HD >= 64 ? 64 : 16;
  static constexpr int NP = (HD + PW - 1) / PW;
  static constexpr int WIDTH = NP * PW;              // columns held: hd 80's second panel is 64 wide
  static constexpr uint32_t ROWB = PW * 2;           // bytes of a panel row
  static constexpr uint32_t SWZ = PW == 64 ? 1 : 3;  // the descriptor's swizzle mode
  static constexpr uint32_t SBO = 8 * ROWB;          // 8-row groups apart
  static_assert(HD % 16 == 0 && HD <= 256, "head dim");

  // K-major operand (rows r0.. as M or N, columns 16 kk.. as K) of the tile
  // of R rows at `tile`: the K step advances within a panel's swizzle atom.
  __device__ static uint64_t kmajor(uint32_t tile, int R, int r0, int kk) {
    return make_desc(tile + (kk * 16 / PW) * R * ROWB + r0 * ROWB + (kk * 16 % PW) * 2, 16, SBO, SWZ);
  }
  // MN-major operand (rows 16 kk.. as K, columns c0.. as N): the panels
  // are the atoms along N, R rows of a panel apart.
  __device__ static uint64_t mnmajor(uint32_t tile, int R, int c0, int kk) {
    return make_desc(tile + (c0 / PW) * R * ROWB + kk * 16 * ROWB, R * ROWB, SBO, SWZ);
  }
};

struct BwdMaps {  // 2-D TMA maps of the (B T, H hd) and (B S, KV hd) views
  CUtensorMap q, o, k, v;
};

struct BwdArgs {
  const int *q_pos, *k_pos;
  const int4* tiles;  // the dK/dV kernel's row tiles, the dQ kernel's key tiles
  const float *dsum, *lsec, *esum;
  const int *qpad, *kpad;
  bf16 *dq, *dk, *dv;
  int T, Tp, S, Sp, H, KV;
  float scale;
  int causal, window;
  float softcap;
};

constexpr uint32_t kSmemMax = 232448;  // a block's dynamic shared memory on sm_90

// dK/dV: BN keys a block, two warpgroups of 64 keys (NC 1) or the same 64
// keys split by columns (NC 2, hd 256); a ring of STAGES row tiles (Q, dO,
// then each tile's lse, D and q_pos).
template <int HD>
struct DkvCfg {
  static constexpr int NC = HD == 256 ? 2 : 1;  // warpgroups a key's columns are split over
  static constexpr int BN = 2 * kTile / NC;
  static constexpr int HC = HD / NC;  // dK and dV columns a warpgroup holds
  static constexpr int NT = 256;
  static constexpr uint32_t KV_BYTES = BN * Panels<HD>::WIDTH * 2;
  static constexpr uint32_t ROW_BYTES = kTile * Panels<HD>::WIDTH * 2;
  static constexpr uint32_t SMALL = 3 * kTile * 4;
  static constexpr int STAGES = 2 * KV_BYTES + 3 * (2 * ROW_BYTES + SMALL) + 4096 <= kSmemMax ? 3 : 2;
  static constexpr uint32_t Q0 = 2 * KV_BYTES, O0 = Q0 + STAGES * ROW_BYTES, SM0 = O0 + STAGES * ROW_BYTES;
  static constexpr uint32_t BARS = SM0 + STAGES * SMALL;  // full[STAGES], empty[STAGES], K and V
  static constexpr uint32_t LIST = BARS + 8 * (2 * STAGES + 2);
  static size_t smem(int tiles) { return 1024 + LIST + 16 + 4 * (size_t)tiles; }
};

// dQ: 64 rows a warpgroup (two), one query head; Q and dO once, then a ring
// of STAGES tiles of BN keys (K, V, then k_pos).
template <int HD>
struct DqCfg {
  static constexpr int BM = 2 * kTile;
  // keys a tile: S and dP take BN / 2 registers each, dQ HD / 2; at hd 256
  // 32, so that two stages of K and V fit beside Q and dO
  static constexpr int BN = HD == 256 ? kTile / 2 : 2 * kTile;
  static constexpr int NT = 256;
  static constexpr uint32_t ROW_BYTES = BM * Panels<HD>::WIDTH * 2;
  static constexpr uint32_t KV_BYTES = BN * Panels<HD>::WIDTH * 2;
  static constexpr uint32_t SMALL = BN * 4;
  static constexpr int STAGES = 2 * ROW_BYTES + 3 * (2 * KV_BYTES + SMALL) + 4096 <= kSmemMax ? 3 : 2;
  static constexpr uint32_t K0 = 2 * ROW_BYTES, V0 = K0 + STAGES * KV_BYTES, SM0 = V0 + STAGES * KV_BYTES;
  static constexpr uint32_t BARS = SM0 + STAGES * SMALL;  // full[STAGES], empty[STAGES], Q and dO
  static constexpr uint32_t LIST = BARS + 8 * (2 * STAGES + 2);
  static size_t smem(int tiles) { return 1024 + LIST + 16 + 4 * (size_t)tiles; }
};

// The ring's refills.  Thread 0 fills the first STAGES stages before the
// loop; after its own step `it` it refills the stage of step it - LAG (LAG
// 1 with three stages, 0 with two) with step it - LAG + STAGES, once both
// warpgroups have released it.
template <int STAGES>
struct Ring {
  static constexpr int LAG = STAGES >= 3 ? 1 : 0;
  // the step whose stage thread 0 refills after step it, or -1
  __device__ static int refill(int it, int steps) {
    const int r = it - LAG;
    return r >= 0 && r + STAGES < steps ? r : -1;
  }
};

template <int HD>
__global__ void __launch_bounds__(DkvCfg<HD>::NT, 1)
    flash_bwd_kernel_dkv_wgmma(__grid_constant__ const BwdMaps maps, const BwdArgs p) {
  using C = DkvCfg<HD>;
  using P = Panels<HD>;
  constexpr int BN = C::BN, HC = C::HC, STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (base - smem_u32(smem_raw));
  int* count = reinterpret_cast<int*>(sm + C::LIST);
  int* list = count + 4;
  const uint32_t bars = base + C::BARS, kvbar = bars + 16 * STAGES;  // full s: bars + 8 s; empty s: + 8 STAGES

  const int G = p.H / p.KV, nQT = (p.T + kTile - 1) / kTile;
  const int b = blockIdx.x / p.KV, kvh = blockIdx.x % p.KV, n0 = blockIdx.y * BN;
  const int* kpb = p.k_pos + (size_t)b * p.S;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * STAGES; ++i) bar_init(bars + 8 * i, i < STAGES ? 1 : C::NT);
    bar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the live tiles of 64 queries; every (head, tile) pair is one step.
  // compact_live's barriers also publish the mbarriers.
  const int4 kt = key_summary(kpb, n0, BN, p.S);
  const int steps =
      G * live_row_tiles<C::NT>(p.tiles + (size_t)b * nQT, nQT, kt, BN, p.causal, p.window, list, count);

  // step it's Q and dO tiles (query head kvh G + it % G) and their rows'
  // lse, D and q_pos into stage it % STAGES
  auto load_step = [&](int it) {
    const int s = it % STAGES;
    const uint32_t full = bars + 8 * s;
    const int h = kvh * G + it % G, t0 = (list[it / G] >> 2) * kTile;
    bar_expect(full, 2 * C::ROW_BYTES + C::SMALL);
#pragma unroll
    for (int pn = 0; pn < P::NP; ++pn) {
      const uint32_t off = s * C::ROW_BYTES + pn * kTile * P::ROWB;
      tma_load(base + C::Q0 + off, &maps.q, h * HD + pn * P::PW, b * p.T + t0, full);
      tma_load(base + C::O0 + off, &maps.o, h * HD + pn * P::PW, b * p.T + t0, full);
    }
    const size_t row = (size_t)(b * p.H + h) * p.Tp + t0;
    const uint32_t small = base + C::SM0 + s * C::SMALL;
    bulk_load(small, p.lsec + row, kTile * 4, full);
    bulk_load(small + kTile * 4, p.dsum + row, kTile * 4, full);
    bulk_load(small + 2 * kTile * 4, p.qpad + (size_t)b * p.Tp + t0, kTile * 4, full);
  };
  if (threadIdx.x == 0 && steps > 0) {
    bar_expect(kvbar, 2 * C::KV_BYTES);
#pragma unroll
    for (int pn = 0; pn < P::NP; ++pn) {
      tma_load(base + pn * BN * P::ROWB, &maps.k, kvh * HD + pn * P::PW, b * p.S + n0, kvbar);
      tma_load(base + C::KV_BYTES + pn * BN * P::ROWB, &maps.v, kvh * HD + pn * P::PW, b * p.S + n0, kvbar);
    }
    for (int it = 0; it < min(steps, STAGES); ++it) load_step(it);
  }

  {  // warpgroup c: 64 keys (rows kr0.. of the K and V tiles), columns cc.. of dK and dV
    const int c = threadIdx.x / 128, w = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
    const int kr0 = C::NC == 1 ? kTile * c : 0, cc = C::NC == 1 ? 0 : HC * c;
    const int key0 = n0 + kr0 + 16 * w + lane / 4;  // this thread's keys: key0 and key0 + 8
    int kp[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) kp[i] = key0 + 8 * i < p.S ? kpb[key0 + 8 * i] : -1;
    float dv[HC / 2], dk[HC / 2];
#pragma unroll
    for (int i = 0; i < HC / 2; ++i) dv[i] = dk[i] = 0.0f;
    if (steps > 0) bar_wait(kvbar, 0);

    for (int it = 0; it < steps; ++it) {
      const int s = it % STAGES;
      bar_wait(bars + 8 * s, (it / STAGES) & 1);
      const bool full = (list[it / G] & 3) == 2;
      const uint32_t qs = base + C::Q0 + s * C::ROW_BYTES, os = base + C::O0 + s * C::ROW_BYTES;
      const float* lse_s = reinterpret_cast<const float*>(sm + C::SM0 + s * C::SMALL);
      const float* d_s = lse_s + kTile;
      const int* qp_s = reinterpret_cast<const int*>(d_s + kTile);

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x the tile's 64 queries
      float st[32], dpt[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<64>(st, P::kmajor(base, BN, kr0, kk), P::kmajor(qs, kTile, 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<64>(dpt, P::kmajor(base + C::KV_BYTES, BN, kr0, kk), P::kmajor(os, kTile, 0, kk), kk);
      wgmma_commit();
      wgmma_wait();
      fence_regs(st);
      fence_regs(dpt);

      // 16 queries at a time: P^T and dS^T in place (element 4 j + e is key
      // key0 + 8 (e / 2), query 8 j + 2 (lane % 4) + e % 2 of the tile),
      // then dV += P^T dO and dK += dS^T Q over them for this warpgroup's
      // columns, started while the next 16 queries are worked out
      fence_regs(dv);
      fence_regs(dk);
      auto grads = [&](auto cap, int kk) {
#pragma unroll
        for (int j = 2 * kk; j < 2 * kk + 2; ++j) {
          const int col = 8 * j + 2 * (lane % 4);
          const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
          const float2 d2 = *reinterpret_cast<const float2*>(d_s + col);
          const int2 q2 = *reinterpret_cast<const int2*>(qp_s + col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool odd = e & 1;
            const bool ok = full || pair_ok(kp[e >> 1], odd ? q2.y : q2.x, p.causal, p.window);
            pair_grad<decltype(cap)::value>(st[4 * j + e], dpt[4 * j + e], ok, (odd ? l2.y : l2.x) * kLog2e,
                                            odd ? d2.y : d2.x, p.scale, p.scale * kLog2e, p.softcap, st[4 * j + e]);
          }
        }
      };
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (p.softcap > 0.0f)
          grads(std::true_type{}, kk);
        else
          grads(std::false_type{}, kk);
        uint32_t pa[4], sa[4];
        acc_to_a(pa, st, kk);
        acc_to_a(sa, dpt, kk);
        wgmma_fence();
        wgmma_rs<HC>(dv, pa, P::mnmajor(os, kTile, cc, kk), 1);
        wgmma_rs<HC>(dk, sa, P::mnmajor(qs, kTile, cc, kk), 1);
        wgmma_commit();
      }
      wgmma_wait();
      fence_regs(dv);
      fence_regs(dk);
      bar_arrive(bars + 8 * (STAGES + s));  // this stage is read
      const int r = Ring<STAGES>::refill(it, steps);
      if (threadIdx.x == 0 && r >= 0) {
        bar_wait(bars + 8 * (STAGES + r % STAGES), (r / STAGES) & 1);
        load_step(r + STAGES);
      }
      __syncwarp();  // the warp reconverges before its next wgmma
    }

    // dK scaled; dV with E / S, the empty rows' share; element 4 j + 2 i + e
    // is key key0 + 8 i, column cc + 8 j + 2 (lane % 4) + e
    const float* eb = p.esum + (size_t)(b * p.KV + kvh) * HD + cc;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = key0 + 8 * i;
      if (key >= p.S) continue;
      const size_t o = ((size_t)(b * p.S + key) * p.KV + kvh) * HD + cc;
#pragma unroll
      for (int j = 0; j < HC / 8; ++j) {
        const int col = 8 * j + 2 * (lane % 4);
        const float2 e = *reinterpret_cast<const float2*>(eb + col);
        *reinterpret_cast<__nv_bfloat162*>(p.dk + o + col) =
            __floats2bfloat162_rn(dk[4 * j + 2 * i] * p.scale, dk[4 * j + 2 * i + 1] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(p.dv + o + col) =
            __floats2bfloat162_rn(dv[4 * j + 2 * i] + e.x / p.S, dv[4 * j + 2 * i + 1] + e.y / p.S);
      }
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(DqCfg<HD>::NT, 1)
    flash_bwd_kernel_dq_wgmma(__grid_constant__ const BwdMaps maps, const BwdArgs p) {
  using C = DqCfg<HD>;
  using P = Panels<HD>;
  constexpr int BM = C::BM, BN = C::BN, STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (base - smem_u32(smem_raw));
  int* count = reinterpret_cast<int*>(sm + C::LIST);
  int* list = count + 4;
  const uint32_t bars = base + C::BARS, qobar = bars + 16 * STAGES;

  const int G = p.H / p.KV, nKT = p.Sp / BN;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H, kvh = h / G;
  const int t0 = (gridDim.y - 1 - blockIdx.y) * BM;  // the last rows, which see the most keys, start first
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * STAGES; ++i) bar_init(bars + 8 * i, i < STAGES ? 1 : C::NT);
    bar_init(qobar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  int qmin, qmax;
  row_bounds(p.q_pos + (size_t)b * p.T, 1, t0, min(p.T, t0 + BM), qmin, qmax);
  const int n_live =
      live_list<C::NT>(p.tiles + (size_t)b * nKT, 0, nKT, BN, qmin, qmax, p.causal, p.window, list, count);

  // step it's K and V tiles (the it-th live key tile) and their k_pos into
  // stage it % STAGES
  auto load_step = [&](int it) {
    const int s = it % STAGES;
    const uint32_t full = bars + 8 * s;
    const int n0 = (list[it] >> 2) * BN;
    bar_expect(full, 2 * C::KV_BYTES + C::SMALL);
#pragma unroll
    for (int pn = 0; pn < P::NP; ++pn) {
      const uint32_t off = s * C::KV_BYTES + pn * BN * P::ROWB;
      tma_load(base + C::K0 + off, &maps.k, kvh * HD + pn * P::PW, b * p.S + n0, full);
      tma_load(base + C::V0 + off, &maps.v, kvh * HD + pn * P::PW, b * p.S + n0, full);
    }
    bulk_load(base + C::SM0 + s * C::SMALL, p.kpad + (size_t)b * p.Sp + n0, BN * 4, full);
  };
  if (threadIdx.x == 0 && n_live > 0) {
    bar_expect(qobar, 2 * C::ROW_BYTES);
#pragma unroll
    for (int pn = 0; pn < P::NP; ++pn) {
      tma_load(base + pn * BM * P::ROWB, &maps.q, h * HD + pn * P::PW, b * p.T + t0, qobar);
      tma_load(base + C::ROW_BYTES + pn * BM * P::ROWB, &maps.o, h * HD + pn * P::PW, b * p.T + t0, qobar);
    }
    for (int it = 0; it < min(n_live, STAGES); ++it) load_step(it);
  }

  {  // warpgroup c: rows t0 + 64 c..
    const int c = threadIdx.x / 128, w = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
    const int r0 = t0 + kTile * c + 16 * w + lane / 4;  // this thread's rows: r0 and r0 + 8 (< Tp)
    int qp[2];
    float lr[2], dr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const size_t idx = (size_t)(b * p.H + h) * p.Tp + r0 + 8 * i;
      qp[i] = p.qpad[(size_t)b * p.Tp + r0 + 8 * i];
      lr[i] = p.lsec[idx] * kLog2e;
      dr[i] = p.dsum[idx];
    }
    float dq[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq[i] = 0.0f;
    if (n_live > 0) bar_wait(qobar, 0);

    for (int it = 0; it < n_live; ++it) {
      const int s = it % STAGES;
      bar_wait(bars + 8 * s, (it / STAGES) & 1);
      const bool full = (list[it] & 3) == 2;
      const uint32_t ks = base + C::K0 + s * C::KV_BYTES, vs = base + C::V0 + s * C::KV_BYTES;
      const int* kp_s = reinterpret_cast<const int*>(sm + C::SM0 + s * C::SMALL);

      // S = Q K^T and dP = dO V^T: this warpgroup's 64 rows x the tile's BN keys
      float st[BN / 2], dp[BN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<BN>(st, P::kmajor(base, BM, kTile * c, kk), P::kmajor(ks, BN, 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<BN>(dp, P::kmajor(base + C::ROW_BYTES, BM, kTile * c, kk), P::kmajor(vs, BN, 0, kk), kk);
      wgmma_commit();
      wgmma_wait();
      fence_regs(st);
      fence_regs(dp);

      // 16 keys at a time: dS in place (element 4 j + e is row r0 + 8 (e /
      // 2), key 8 j + 2 (lane % 4) + e % 2 of the tile; k_pos -1 past S;
      // lr holds lse log2(e)), then dQ += dS K over them, started while the
      // next 16 keys' dS is worked out
      fence_regs(dq);
      auto grads = [&](auto cap, int kk) {
#pragma unroll
        for (int j = 2 * kk; j < 2 * kk + 2; ++j) {
          const int2 k2 = *reinterpret_cast<const int2*>(kp_s + 8 * j + 2 * (lane % 4));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const bool ok = full || pair_ok(e & 1 ? k2.y : k2.x, qp[i], p.causal, p.window);
            float pr;
            pair_grad<decltype(cap)::value>(st[4 * j + e], dp[4 * j + e], ok, lr[i], dr[i], p.scale,
                                            p.scale * kLog2e, p.softcap, pr);
          }
        }
      };
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        if (p.softcap > 0.0f)
          grads(std::true_type{}, kk);
        else
          grads(std::false_type{}, kk);
        uint32_t sa[4];
        acc_to_a(sa, dp, kk);
        wgmma_fence();
        wgmma_rs<HD>(dq, sa, P::mnmajor(ks, BN, 0, kk), 1);
        wgmma_commit();
      }
      wgmma_wait();
      fence_regs(dq);
      bar_arrive(bars + 8 * (STAGES + s));
      const int r = Ring<STAGES>::refill(it, n_live);
      if (threadIdx.x == 0 && r >= 0) {
        bar_wait(bars + 8 * (STAGES + r % STAGES), (r / STAGES) & 1);
        load_step(r + STAGES);
      }
      __syncwarp();  // the warp reconverges before its next wgmma
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      if (r >= p.T) continue;
      bf16* dst = p.dq + ((size_t)(b * p.T + r) * p.H + h) * HD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int col = 8 * j + 2 * (lane % 4);
        *reinterpret_cast<__nv_bfloat162*>(dst + col) =
            __floats2bfloat162_rn(dq[4 * j + 2 * i] * p.scale, dq[4 * j + 2 * i + 1] * p.scale);
      }
    }
  }
}
// ---- f32 on the CUDA cores ------------------------------------------------------

// Rows [r0, r0 + 32) of q and dout (zeros past `rows`) into shared rows of
// stride HD + 1, and their lse, D (from (B, H, Tp)) and q_pos (zeros past
// `rows`).
template <int HD>
__device__ __forceinline__ void load_core_rows(const float* __restrict__ q, const float* __restrict__ dout,
                                               const float* __restrict__ lse, const float* __restrict__ dsum,
                                               const int* __restrict__ q_pos, float* Qs, float* Os, float* lse_s,
                                               float* d_s, int* qp_s, int b, int kvh, int r0, int rows, int T_len,
                                               int Tp, int H, int G) {
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
    d_s[r] = gr < rows ? dsum[(size_t)(b * H + kvh * G + gr % G) * Tp + gr / G] : 0.0f;
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
                               const float* __restrict__ dsum, const float* __restrict__ esum,
                               const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                               const int4* __restrict__ rtiles, float* __restrict__ dk, float* __restrict__ dv,
                               int T_len, int Tp, int S, int H, int KV, float scale, int causal, int window,
                               float softcap) {
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
                       rows, T_len, Tp, H, G);
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
  const float* eb = esum + (size_t)(b * KV + kvh) * HD;  // dV takes E / S, the empty rows' share
#pragma unroll
  for (int u = 0; u < CPT; ++u) {
    dk[base + c0 + 8 * u] = dka[u] * scale;
    dv[base + c0 + 8 * u] = dva[u] + eb[c0 + 8 * u] / S;
  }
}

// dQ of 32 rows a block; thread t holds row t % 32, columns t / 32 + 8 u.
template <int HD>
__global__ void __launch_bounds__(kCoreThreads)
    flash_bwd_kernel_dq_cores(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                              const float* __restrict__ dout, const float* __restrict__ lse,
                              const float* __restrict__ dsum, const int* __restrict__ q_pos,
                              const int* __restrict__ k_pos, const int4* __restrict__ ktiles, float* __restrict__ dq,
                              int T_len, int Tp, int S, int H, int KV, float scale, int causal, int window,
                              float softcap) {
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

  load_core_rows<HD>(q, dout, lse, dsum, q_pos, Qs, Os, lse_s, d_s, qp_s, b, kvh, r0, rows, T_len, Tp, H, G);
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
  int B, T, S, H, KV, hd;
  float scale;
  int causal, window;
  float softcap;
  unsigned char* scratch;
  size_t scratch_bytes;
  cudaStream_t stream;
};

// The scratch's pieces (kernels/flash_bwd.py:scratch_layout), each from a
// 256-byte boundary: the key tiles' summaries (tiles of kt keys), the row
// tiles' (nRT a batch row), D and the lse copy (B, H, Tp) f32, the q_pos
// copy (B, Tp), the k_pos copy (B, Sp), Sp the key tiles' span, and E (B,
// KV, hd) f32.
struct Scratch {
  int4 *ktiles, *rtiles;
  float *dsum, *lsec, *esum;
  int *qpad, *kpad;
  int Tp, Sp;
};

bool carve(const Args& a, int kt, int nRT, Scratch* s) {
  s->Tp = (a.T + kPadRows - 1) / kPadRows * kPadRows;
  s->Sp = (a.S + kt - 1) / kt * kt;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    unsigned char* p = a.scratch + off;
    off += (bytes + 255) & ~(size_t)255;
    return p;
  };
  s->ktiles = reinterpret_cast<int4*>(take(sizeof(int4) * a.B * (s->Sp / kt)));
  s->rtiles = reinterpret_cast<int4*>(take(sizeof(int4) * a.B * nRT));
  s->dsum = reinterpret_cast<float*>(take(sizeof(float) * a.B * a.H * s->Tp));
  s->lsec = reinterpret_cast<float*>(take(sizeof(float) * a.B * a.H * s->Tp));
  s->qpad = reinterpret_cast<int*>(take(sizeof(int) * a.B * s->Tp));
  s->kpad = reinterpret_cast<int*>(take(sizeof(int) * a.B * s->Sp));
  s->esum = reinterpret_cast<float*>(take(sizeof(float) * a.B * a.KV * a.hd));
  return off <= a.scratch_bytes;
}

template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The summaries of key tiles of kt (with the k_pos copy where `kpad`) and of
// row tiles of rt rows (row r is query r / rowG), D with the lse and q_pos
// copies, and E.
template <typename T>
cudaError_t launch_prep(const Args& a, int kt, int rt, int rowG, bool kpad, Scratch* s) {
  const int nKT = (a.S + kt - 1) / kt, nRT = (a.T * rowG + rt - 1) / rt;
  if (!carve(a, kt, nRT, s)) return cudaErrorInvalidValue;
  flash_bwd_kernel_tiles<<<dim3((nKT + 7) / 8, a.B), 256, 0, a.stream>>>(a.k_pos, s->ktiles,
                                                                          kpad ? s->kpad : nullptr, a.S, 1, kt, nKT);
  flash_bwd_kernel_tiles<<<dim3((nRT + 7) / 8, a.B), 256, 0, a.stream>>>(a.q_pos, s->rtiles, nullptr, a.T, rowG, rt,
                                                                          nRT);
  const size_t n = (size_t)a.B * s->Tp * a.H;
  flash_bwd_kernel_dot<T><<<(unsigned)((n + 63) / 64), 256, 0, a.stream>>>(
      static_cast<const T*>(a.out), static_cast<const T*>(a.dout), a.lse, a.q_pos, s->dsum, s->lsec, s->qpad, a.B,
      a.T, s->Tp, a.H, a.hd);
  flash_bwd_kernel_empty<T><<<a.B * a.KV, 32 * kEmptyWarps, 0, a.stream>>>(
      s->lsec, static_cast<const T*>(a.dout), s->esum, a.T, s->Tp, a.H, a.KV, a.hd);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda).
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(f);
  }
  return fn;
}

// A 2-D map of a (rows, cols) bf16 matrix in boxes of box_rows x pw, with
// the panels' swizzle; rows past the end read as zeros.
bool make_map(CUtensorMap* m, const void* ptr, int cols, long long rows, int box_rows, int pw) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)pw, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, pw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// bf16: the prep (key tiles of 64 keys, row tiles of 64 queries), then the
// dK/dV kernel a block per (batch, kv head, BN keys) and the dQ kernel a
// block per (batch, query head, BM rows).  A tensor map that cannot be
// made returns cudaErrorNotSupported.
template <int HD>
cudaError_t launch_wgmma(const Args& a) {
  using P = Panels<HD>;
  using KC = DkvCfg<HD>;
  using QC = DqCfg<HD>;
  Scratch s;
  cudaError_t err = launch_prep<bf16>(a, QC::BN, kTile, 1, true, &s);
  if (err != cudaSuccess) return err;
  BwdArgs p{a.q_pos, a.k_pos, s.rtiles, s.dsum, s.lsec, s.esum, s.qpad, s.kpad,
            static_cast<bf16*>(a.dq), static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
            a.T, s.Tp, a.S, s.Sp, a.H, a.KV, a.scale, a.causal, a.window, a.softcap};
  BwdMaps m;
  const long long qrows = (long long)a.B * a.T, krows = (long long)a.B * a.S;
  if (!make_map(&m.q, a.q, a.H * HD, qrows, kTile, P::PW) || !make_map(&m.o, a.dout, a.H * HD, qrows, kTile, P::PW) ||
      !make_map(&m.k, a.k, a.KV * HD, krows, KC::BN, P::PW) || !make_map(&m.v, a.v, a.KV * HD, krows, KC::BN, P::PW))
    return cudaErrorNotSupported;
  auto dkv = flash_bwd_kernel_dkv_wgmma<HD>;
  size_t smem = KC::smem((a.T + kTile - 1) / kTile);
  if ((err = allow_smem(dkv, smem)) != cudaSuccess) return err;
  dkv<<<dim3(a.B * a.KV, (a.S + KC::BN - 1) / KC::BN), KC::NT, smem, a.stream>>>(m, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  p.tiles = s.ktiles;
  if (!make_map(&m.q, a.q, a.H * HD, qrows, QC::BM, P::PW) || !make_map(&m.o, a.dout, a.H * HD, qrows, QC::BM, P::PW) ||
      !make_map(&m.k, a.k, a.KV * HD, krows, QC::BN, P::PW) || !make_map(&m.v, a.v, a.KV * HD, krows, QC::BN, P::PW))
    return cudaErrorNotSupported;
  auto dq = flash_bwd_kernel_dq_wgmma<HD>;
  smem = QC::smem(s.Sp / QC::BN);
  if ((err = allow_smem(dq, smem)) != cudaSuccess) return err;
  dq<<<dim3(a.B * a.H, (a.T + QC::BM - 1) / QC::BM), QC::NT, smem, a.stream>>>(m, p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_cores(const Args& a) {
  Scratch s;
  cudaError_t err = launch_prep<float>(a, kCoreTile, kCoreTile, a.H / a.KV, false, &s);
  if (err != cudaSuccess) return err;
  const int rows = a.T * (a.H / a.KV);
  const int nKT = (a.S + kCoreTile - 1) / kCoreTile, nRT = (rows + kCoreTile - 1) / kCoreTile;
  auto dkv = flash_bwd_kernel_dkv_cores<HD>;
  size_t smem = core_smem<HD>(nRT);
  if ((err = allow_smem(dkv, smem)) != cudaSuccess) return err;
  dkv<<<dim3(nKT, a.B * a.KV), kCoreThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
      static_cast<const float*>(a.dout), a.lse, s.dsum, s.esum, a.q_pos, a.k_pos, s.rtiles, static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.T, s.Tp, a.S, a.H, a.KV, a.scale, a.causal, a.window, a.softcap);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  auto dq = flash_bwd_kernel_dq_cores<HD>;
  smem = core_smem<HD>(nKT);
  if ((err = allow_smem(dq, smem)) != cudaSuccess) return err;
  dq<<<dim3(nRT, a.B * a.KV), kCoreThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
      static_cast<const float*>(a.dout), a.lse, s.dsum, a.q_pos, a.k_pos, s.ktiles, static_cast<float*>(a.dq), a.T,
      s.Tp, a.S, a.H, a.KV, a.scale, a.causal, a.window, a.softcap);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(const Args& a, int dtype) {
  return dtype == 0 ? launch_cores<HD>(a) : launch_wgmma<HD>(a);
}

}  // namespace

// q, out, dout (B, T, H, hd) and k, v (B, S, KV, hd) in f32 (dtype 0) or
// bf16 (dtype 1); lse (B, T, H) f32 from flash_launch (+inf on a row with no
// valid key); q_pos (B, T), k_pos (B, S) int32 -> dq (B, T, H, hd), dk and
// dv (B, S, KV, hd) in the same type.  scale is hd^-0.5; window <= 0 means
// none, softcap <= 0 none.  `scratch` (256-byte aligned, scratch_bytes
// long) takes the tile summaries, D, the copies and E;
// kernels/flash_bwd.py:scratch_layout gives the size.  Returns
// cudaGetLastError() of the last launch, or the first failure.
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
                                const float* lse, const int* q_pos, const int* k_pos, void* dq, void* dk, void* dv,
                                int B, int T, int S, int H, int KV, int hd, int dtype, float scale, int causal,
                                int window, float softcap, void* scratch, size_t scratch_bytes, cudaStream_t stream) {
  if (B <= 0 || T <= 0 || S <= 0) return (int)cudaGetLastError();
  if (KV <= 0 || H % KV != 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, out, dout, lse, q_pos, k_pos, dq, dk, dv, B, T, S, H, KV, hd, scale, causal, window,
               softcap, static_cast<unsigned char*>(scratch), scratch_bytes, stream};
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
