// flash: flash-attention forward for sm_90a.
//
// Replaces the TPU kernel repro/kernels/flash.py (_flash_kernel /
// flash_attention_pallas), whose grid carried the running max, sum and
// output block of one (batch*head, q block) across a sequential third grid
// axis over KV blocks.  Blocks on Hopper run in no order, so here one block
// owns one (batch, kv head, tile of query rows) and loops over the KV tiles
// itself; nothing carries between blocks.
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
//
// Layout (B, T, H, hd) for q and out, (B, S, KV, hd) for k and v, as the
// reference keeps them.  GQA is in the kernel: the G = H / KV query heads
// of one kv head are packed into the block's rows (row r is query t = r / G,
// head kvh * G + r % G), so a K/V tile read into shared memory serves all G
// heads, and expanded K/V never exist in device memory.  Prefill (T = S)
// and decode (T = 1 against a ragged rolling cache with k_pos = -1 in empty
// slots) run through the same kernel; decode's T * G rows take a short
// 4-row tile instead of a 64-row one, so the block's threads are not idle.
//
// Bound: operations at prefill (4 * hd flops per (query, key) pair, ~0.2 ms
// a layer for llama3.2-3b at 2 x 4096 tokens on the tensor cores' bf16
// rate); bytes at decode (the cache read once).  This first kernel does the
// products on the CUDA cores in f32 (two FMAs per pair of bf16 values,
// register tiles of 4 x 4 scores and 4 x hd/16 outputs a thread) and loads
// each KV tile with 16-byte pieces, several in flight a thread, so that a
// tile costs a memory round trip or two (decode is latency-bound on them:
// B x KV blocks stream the whole cache).  It does not skip fully masked
// tiles and does not split the KV loop across blocks: tensor cores
// (wgmma), TMA, causal tile skipping and split-KV decode are later work
// (ROADMAP perf queue).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1.0e30f;
constexpr int kBN = 64;  // keys per KV tile

// Operand-type helpers.  Shared rows of Q and K are padded so that the
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
struct Op<__nv_bfloat16> {
  static constexpr int kPad = 2;
  __device__ static float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  __device__ static float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  __device__ static float round(float x) { return __bfloat162float(__float2bfloat16(x)); }
  __device__ static __nv_bfloat16 store(float x) { return __float2bfloat16(x); }
};

// Shared memory of one block: Q tile (BM x LD), K tile (kBN x LD), V tile
// (kBN x HD), P tile (BM x kBN + 1, f32), the rows' q_pos and the keys' k_pos.
template <typename T, int HD, int BM>
constexpr size_t smem_bytes() {
  return sizeof(T) * ((size_t)(BM + kBN) * (HD + Op<T>::kPad) + (size_t)kBN * HD) +
         sizeof(float) * (size_t)BM * (kBN + 1) + sizeof(int) * (size_t)(BM + kBN);
}

// One KV tile into shared memory: kBN key rows of K (row stride LD) and of
// V (row stride HD), row n at k + n * stride; rows past `valid` are zeros.
// 16-byte global loads, up to four of K and four of V in flight a thread
// before its stores: the tile's latency is a round trip or two, not one a
// word.  Shared rows are only 4-byte aligned (the padding), so each piece
// is stored as four words.
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

// BM query rows a block, RM rows a thread, TX threads across the keys (and
// the output columns) of a row group; TX divides 32, so a row group's
// reductions are warp shuffles.
template <typename T, int HD, int BM, int RM, int TX>
__global__ void __launch_bounds__((BM / RM) * TX)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ q_pos, const int* __restrict__ k_pos, T* __restrict__ out, int T_len,
                 int S, int H, int KV, float scale, int causal, int window, float softcap) {
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

  const int G = H / KV;
  const int rows = T_len * G;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int r0 = blockIdx.x * BM;
  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;

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
  for (int n0 = 0; n0 < S; n0 += kBN) {
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

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int gr = r0 + ty * RM + i;
    if (gr >= rows) continue;
    const int t = gr / G, h = kvh * G + gr % G;
    T* dst = out + ((size_t)(b * T_len + t) * H + h) * HD;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int col = tx + c * TX;
      if (OC * TX == HD || col < HD) dst[col] = Op<T>::store(o[i][c] / den);
    }
  }
}

template <typename T, int HD, int BM, int RM, int TX>
cudaError_t launch(const void* q, const void* k, const void* v, const int* q_pos, const int* k_pos, void* out, int B,
                   int T_len, int S, int H, int KV, float scale, int causal, int window, float softcap,
                   cudaStream_t stream) {
  auto kern = flash_kernel<T, HD, BM, RM, TX>;
  constexpr size_t smem = smem_bytes<T, HD, BM>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int rows = T_len * (H / KV);
  const dim3 grid((rows + BM - 1) / BM, B * KV);
  kern<<<grid, (BM / RM) * TX, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                              static_cast<const T*>(v), q_pos, k_pos, static_cast<T*>(out), T_len,
                                              S, H, KV, scale, causal, window, softcap);
  return cudaGetLastError();
}

// Decode's few rows (T * G <= 4) take 4-row tiles, one warp a row;
// everything else 64-row tiles of 16 x 16 threads, 4 x 4 scores a thread.
template <typename T, int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, const int* q_pos, const int* k_pos, void* out,
                      int B, int T_len, int S, int H, int KV, float scale, int causal, int window,
                      float softcap, cudaStream_t stream) {
  if (T_len * (H / KV) <= 4)
    return launch<T, HD, 4, 1, 32>(q, k, v, q_pos, k_pos, out, B, T_len, S, H, KV, scale, causal, window, softcap,
                                   stream);
  return launch<T, HD, 64, 4, 16>(q, k, v, q_pos, k_pos, out, B, T_len, S, H, KV, scale, causal, window, softcap,
                                  stream);
}

template <typename T>
cudaError_t launch_t(int hd, const void* q, const void* k, const void* v, const int* q_pos, const int* k_pos,
                     void* out, int B, int T_len, int S, int H, int KV, float scale, int causal, int window,
                     float softcap, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch_hd<T, 16>(q, k, v, q_pos, k_pos, out, B, T_len, S, H, KV, scale, causal, window, softcap, stream);
    case 64:
      return launch_hd<T, 64>(q, k, v, q_pos, k_pos, out, B, T_len, S, H, KV, scale, causal, window, softcap, stream);
    case 80:
      return launch_hd<T, 80>(q, k, v, q_pos, k_pos, out, B, T_len, S, H, KV, scale, causal, window, softcap, stream);
    case 128:
      return launch_hd<T, 128>(q, k, v, q_pos, k_pos, out, B, T_len, S, H, KV, scale, causal, window, softcap, stream);
    case 256:
      return launch_hd<T, 256>(q, k, v, q_pos, k_pos, out, B, T_len, S, H, KV, scale, causal, window, softcap, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, T, H, hd), k/v (B, S, KV, hd) in f32 (dtype 0) or bf16 (dtype 1);
// q_pos (B, T), k_pos (B, S) int32 -> out (B, T, H, hd) in the same type.
// scale is hd^-0.5; window <= 0 means none, softcap <= 0 none.  Returns cudaGetLastError().
extern "C" int flash_launch(const void* q, const void* k, const void* v, const int* q_pos, const int* k_pos,
                            void* out, int B, int T, int S, int H, int KV, int hd, int dtype, float scale, int causal,
                            int window, float softcap, cudaStream_t stream) {
  if (B <= 0 || T <= 0) return (int)cudaGetLastError();
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch_t<float>(hd, q, k, v, q_pos, k_pos, out, B, T, S, H, KV, scale, causal, window, softcap, stream);
  if (dtype == 1)
    return (int)launch_t<__nv_bfloat16>(hd, q, k, v, q_pos, k_pos, out, B, T, S, H, KV, scale, causal, window,
                                        softcap, stream);
  return (int)cudaErrorInvalidValue;
}
