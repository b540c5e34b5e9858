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
// with r, k, v, logw those of token t (logw clamped by the caller); S
// after the last token goes to S[b, h].  This is the token form that the
// RWKV-6 authors' CUDA kernel takes.  The reference computes the same
// function in a factored chunk form (two products a chunk, decays as
// exp(+-cumsum)), whose padded steps (k = 0, logw = 0) leave S as it is, so
// no padding is needed here.  The two sum in other orders: the kernel is
// held to the plain version within 1e-4 of max |o| (and of max |S|).
//
// Design.  A block per (b, h, half of the 64 value columns), 128 threads;
// each thread keeps a 4 x 4 tile of S (4 key rows, 4 value columns) in
// registers for the whole sequence.  Tokens are staged 16 at a time in
// shared memory (r, k, exp(logw), the block's v columns, and
// sum_k r_k u_k k_k, which every column of a token shares), the next 16
// loaded into registers while the current ones are folded in.  A token
// costs a thread four 16-byte shared-memory reads (its rows' r, k and
// exp(logw), its columns' v), issued a token ahead, 16 multiply-adds into
// its columns' partial outputs and 16 into its tile, and one 16-byte store
// of the partials, which are summed over the 16 key groups once a chunk.
// The tile is what the shared memory's rate to the registers asks for
// (128 bytes a cycle an SM, a broadcast read costing as much as any
// other): with a thread per value column and 4 key rows, each thread read
// its rows' r, k and exp(logw) for one column, ~27 KB a token a block, and
// the kernel took 0.45-0.52 ms at B 2, T 4,096, H 32 on an H100; the 4 x 4
// tile reads ~8 KB a token a block and takes 0.35 ms there, its four warps
// an SM now waiting on each token's steps.
//
// Bound on this card: bytes (r, k, v and logw read once, o written once,
// S read and written once), with the operations of the token form close
// behind.  Each block still walks its T tokens in order.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kHead = 64;                        // RWKV-6's head size
constexpr int kHalves = 2;                       // value-column halves, a block each
constexpr int kCols = kHead / kHalves;           // value columns a block
constexpr int kTile = 4;                         // a thread's key rows, and its value columns
constexpr int kKeyGroups = kHead / kTile;        // 16
constexpr int kColGroups = kCols / kTile;        // 8
constexpr int kThreads = kKeyGroups * kColGroups;  // 128
constexpr int kChunk = 16;                       // tokens staged at once
constexpr int kLoaders = kHead / 4;              // threads a token's r / k / logw row (a float4 each)
constexpr int kPassTokens = kThreads / kLoaders;   // tokens staged in one pass: 8
constexpr int kPasses = kChunk / kPassTokens;      // 2

static_assert(kChunk * kColGroups == kThreads, "one float4 of v, and one of o, a thread a chunk");
static_assert(kChunk % kPassTokens == 0, "whole passes a chunk");

__device__ __forceinline__ float at(const float4& a, int i) { return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w; }

__global__ void __launch_bounds__(kThreads) wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
                                                       const float* __restrict__ v, const float* __restrict__ logw,
                                                       const float* __restrict__ u, const float* __restrict__ S0,
                                                       int T, int H, float* __restrict__ o, float* __restrict__ S) {
  __shared__ __align__(16) float s_r[kChunk][kHead];
  __shared__ __align__(16) float s_k[kChunk][kHead];
  __shared__ __align__(16) float s_w[kChunk][kHead];  // exp(logw)
  __shared__ __align__(16) float s_v[kChunk][kCols];
  __shared__ float s_ruk[kChunk];                      // sum_k r_k u_k k_k
  __shared__ __align__(16) float s_part[kKeyGroups][kChunk][kCols];

  const int half = blockIdx.x % kHalves;
  const int h = blockIdx.x / kHalves;
  const size_t b = blockIdx.y;
  const int cg = threadIdx.x % kColGroups;  // value columns 4 cg .. 4 cg + 3 of the half
  const int kg = threadIdx.x / kColGroups;  // key rows 4 kg .. 4 kg + 3
  const size_t tok_stride = (size_t)H * kHead;            // floats from one token to the next
  const size_t head_base = (b * T * H + h) * kHead;       // r[b, 0, h, 0]
  const size_t state_base = (b * H + h) * kHead * kHead;  // S0[b, h, 0, 0]
  const size_t col0 = (size_t)half * kCols + cg * kTile;

  float st[kTile][kTile];  // S[4 kg + j, col0 + c]
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    const float4 row = *reinterpret_cast<const float4*>(S0 + state_base + (size_t)(kg * kTile + j) * kHead + col0);
    st[j][0] = row.x, st[j][1] = row.y, st[j][2] = row.z, st[j][3] = row.w;
  }

  // staging: in pass m, thread i loads token 8 m + i / 16's r, k, logw at
  // key 4 (i % 16); and token i / 8's v at the block's columns 4 (i % 8) ..
  const int ld_t = threadIdx.x / kLoaders;
  const int ld_k = (threadIdx.x % kLoaders) * 4;
  const int lv_t = threadIdx.x / kColGroups;
  const int lv_c = (threadIdx.x % kColGroups) * kTile;
  const float4 u4 = *reinterpret_cast<const float4*>(u + (size_t)h * kHead + ld_k);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 nr[kPasses], nk[kPasses], nw[kPasses], nv;
  auto load = [&](int t0) {
#pragma unroll
    for (int m = 0; m < kPasses; ++m) {
      const int t = t0 + m * kPassTokens + ld_t;
      const size_t off = head_base + (size_t)t * tok_stride + ld_k;
      const bool in = t < T;  // past the end: no input, no decay
      nr[m] = in ? __ldg(reinterpret_cast<const float4*>(r + off)) : zero;
      nk[m] = in ? __ldg(reinterpret_cast<const float4*>(k + off)) : zero;
      nw[m] = in ? __ldg(reinterpret_cast<const float4*>(logw + off)) : zero;
    }
    const int t = t0 + lv_t;
    nv = t < T ? __ldg(reinterpret_cast<const float4*>(v + head_base + (size_t)t * tok_stride + half * kCols + lv_c))
               : zero;
  };

  load(0);
  for (int t0 = 0; t0 < T; t0 += kChunk) {
#pragma unroll
    for (int m = 0; m < kPasses; ++m) {
      const int tt = m * kPassTokens + ld_t;
      const float4 r4 = nr[m], k4 = nk[m], lw = nw[m];
      *reinterpret_cast<float4*>(&s_r[tt][ld_k]) = r4;
      *reinterpret_cast<float4*>(&s_k[tt][ld_k]) = k4;
      *reinterpret_cast<float4*>(&s_w[tt][ld_k]) = make_float4(expf(lw.x), expf(lw.y), expf(lw.z), expf(lw.w));
      float ruk = r4.x * u4.x * k4.x + r4.y * u4.y * k4.y + r4.z * u4.z * k4.z + r4.w * u4.w * k4.w;
#pragma unroll
      for (int off = kLoaders / 2; off > 0; off /= 2) ruk += __shfl_xor_sync(0xffffffffu, ruk, off);
      if (threadIdx.x % kLoaders == 0) s_ruk[tt] = ruk;
    }
    *reinterpret_cast<float4*>(&s_v[lv_t][lv_c]) = nv;
    __syncthreads();
    if (t0 + kChunk < T) load(t0 + kChunk);  // in flight while this chunk is folded in

    // the token loop, its shared-memory reads a token ahead of its arithmetic
    const int n = min(kChunk, T - t0);
    float4 rc = *reinterpret_cast<const float4*>(&s_r[0][kg * kTile]);
    float4 kc = *reinterpret_cast<const float4*>(&s_k[0][kg * kTile]);
    float4 wc = *reinterpret_cast<const float4*>(&s_w[0][kg * kTile]);
    float4 vc = *reinterpret_cast<const float4*>(&s_v[0][cg * kTile]);
    for (int t = 0; t < n; ++t) {
      const int tn = t + 1 < n ? t + 1 : t;
      const float4 rn = *reinterpret_cast<const float4*>(&s_r[tn][kg * kTile]);
      const float4 kn = *reinterpret_cast<const float4*>(&s_k[tn][kg * kTile]);
      const float4 wn = *reinterpret_cast<const float4*>(&s_w[tn][kg * kTile]);
      const float4 vn = *reinterpret_cast<const float4*>(&s_v[tn][cg * kTile]);
      float acc[kTile];
#pragma unroll
      for (int c = 0; c < kTile; ++c) {
        acc[c] = at(rc, 0) * st[0][c];
#pragma unroll
        for (int j = 1; j < kTile; ++j) acc[c] = fmaf(at(rc, j), st[j][c], acc[c]);
      }
#pragma unroll
      for (int j = 0; j < kTile; ++j)
#pragma unroll
        for (int c = 0; c < kTile; ++c) st[j][c] = fmaf(at(wc, j), st[j][c], at(kc, j) * at(vc, c));
      *reinterpret_cast<float4*>(&s_part[kg][t][cg * kTile]) = make_float4(acc[0], acc[1], acc[2], acc[3]);
      rc = rn;
      kc = kn;
      wc = wn;
      vc = vn;
    }
    __syncthreads();

    if (lv_t < n) {  // token lv_t's columns lv_c .. lv_c + 3
      const float ruk = s_ruk[lv_t];
      const float4 vv = *reinterpret_cast<const float4*>(&s_v[lv_t][lv_c]);
      float4 sum = make_float4(ruk * vv.x, ruk * vv.y, ruk * vv.z, ruk * vv.w);
#pragma unroll
      for (int q = 0; q < kKeyGroups; ++q) {
        const float4 p = *reinterpret_cast<const float4*>(&s_part[q][lv_t][lv_c]);
        sum.x += p.x, sum.y += p.y, sum.z += p.z, sum.w += p.w;
      }
      *reinterpret_cast<float4*>(o + head_base + (size_t)(t0 + lv_t) * tok_stride + half * kCols + lv_c) = sum;
    }
    __syncthreads();  // s_v, s_ruk and s_part are read above before the next chunk overwrites them
  }

#pragma unroll
  for (int j = 0; j < kTile; ++j)
    *reinterpret_cast<float4*>(S + state_base + (size_t)(kg * kTile + j) * kHead + col0) =
        make_float4(st[j][0], st[j][1], st[j][2], st[j][3]);
}

}  // namespace

// r, k, v, logw (B, T, H, 64) f32, u (H, 64) f32, S0 (B, H, 64, 64) f32 ->
// o (B, T, H, 64), S (B, H, 64, 64).  Every pointer 16-byte aligned.
extern "C" int rwkv_wkv_launch(const float* r, const float* k, const float* v, const float* logw, const float* u,
                               const float* S0, int B, int T, int H, float* o, float* S, cudaStream_t stream) {
  if (B <= 0 || H <= 0) return 0;
  if (T <= 0) return (int)cudaErrorInvalidValue;
  const auto off16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (off16(r) || off16(k) || off16(v) || off16(logw) || off16(u) || off16(S0) || off16(o) || off16(S))
    return (int)cudaErrorMisalignedAddress;
  const dim3 grid(H * kHalves, B);
  wkv_kernel<<<grid, kThreads, 0, stream>>>(r, k, v, logw, u, S0, T, H, o, S);
  return (int)cudaGetLastError();
}
