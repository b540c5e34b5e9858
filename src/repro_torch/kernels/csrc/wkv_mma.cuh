// wkv_mma.cuh: the device helpers the WKV kernels share (csrc/rwkv_wkv.cu,
// csrc/rwkv_wkv_bwd.cu): named barriers, 16-byte cp.async, the TF32 split,
// ldmatrix fragments of float32 tiles kept row by row kLd floats apart, and
// a warp's product of 16 rows in three TF32 passes on mma.sync m16n8k8.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kHead = 64;  // RWKV-6's head size
constexpr int kLd = 68;    // floats from one row to the next of a tile read by ldmatrix

__device__ __forceinline__ void bar_sync(int id, int n) { asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory"); }
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void cp16(void* smem, const float* gmem, bool in) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(gmem), "r"(in ? 16 : 0) : "memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x as its leading TF32 bits and the rest (whose own low bits the tensor
// cores drop): hi + lo keeps ~21 bits
__device__ __forceinline__ void split(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = x & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));
}

// four 8 x 4 float32 blocks of a tile kept row by row (kLd floats a row):
// the block of rows r0 + 8 (i % 2) .., columns c0 + 4 (i / 2) .. into
// x[i], thread (g, t) getting each block's element (g, t).  That is an A
// fragment of rows r0 .., columns c0 ..; of a tile kept as [n][k], the B
// fragments of two 8-column tiles (x[0], x[2] the first's, x[1], x[3] the
// second's)
__device__ __forceinline__ void ldsm4(uint32_t (&x)[4], const float* m, int r0, int c0, int lane) {
  const float* p = m + (r0 + (lane / 8 % 2) * 8 + lane % 8) * kLd + c0 + (lane / 16) * 4;
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
               : "r"(a));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four fragment registers, split
struct Frag {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ explicit Frag(const uint32_t (&x)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split(x[i], hi[i], lo[i]);
  }
};

// two 8 x 4 float32 blocks: rows r0 .., columns c0 + 4 i .. into x[i];
// of a tile kept as [n][k], the B fragment of one 8-column tile
__device__ __forceinline__ void ldsm2(uint32_t (&x)[2], const float* m, int r0, int c0, int lane) {
  const float* p = m + (r0 + lane % 8) * kLd + c0 + (lane / 8 % 2) * 4;
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];" : "=r"(x[0]), "=r"(x[1]) : "r"(a));
}

// the B fragments (b[n][0], b[n][1]) of N 8-column tiles of a tile kept as
// [n][k]: rows n0 + 8 n .., columns c0 ..
template <int N>
__device__ __forceinline__ void ldsm_b(uint32_t (&b)[N][2], const float* m, int n0, int c0, int lane) {
  if constexpr (N == 1) {
    ldsm2(b[0], m, n0, c0, lane);
  } else {
    uint32_t x[4];
    ldsm4(x, m, n0, c0, lane);
    b[0][0] = x[0], b[0][1] = x[2], b[1][0] = x[1], b[1][1] = x[3];
  }
}

// A warp's product of 16 rows by N 8-column tiles in three TF32 passes,
// each pass into its own accumulators so that no mma waits on the one
// before it (~24 cycles): acc (hi hi), cl (lo hi), ch (hi lo)
template <int N>
struct Acc {
  static_assert(N == 1 || N == 2, "one or two tiles");
  static constexpr int kTiles = N;
  float acc[N][4] = {}, cl[N][4] = {}, ch[N][4] = {};
  // a b for an A fragment and the tiles' B fragments
  __device__ __forceinline__ void mma3(const Frag& a, const uint32_t (&b)[N][2]) {
    uint32_t bh[N][2], bl[N][2];
#pragma unroll
    for (int n = 0; n < N; ++n) split(b[n][0], bh[n][0], bl[n][0]), split(b[n][1], bh[n][1], bl[n][1]);
#pragma unroll
    for (int n = 0; n < N; ++n) mma(cl[n], a.lo, bh[n][0], bh[n][1]);
#pragma unroll
    for (int n = 0; n < N; ++n) mma(ch[n], a.hi, bl[n][0], bl[n][1]);
#pragma unroll
    for (int n = 0; n < N; ++n) mma(acc[n], a.hi, bh[n][0], bh[n][1]);
  }
  // over k-steps k0 .. k1 - 1 (8-deep each; 8 make a 64-deep product;
  // k0 < k1), each step's fragments (la: A registers, lb: the tiles' B
  // registers, k-step) loaded while the step before is folded in
  template <typename LA, typename LB>
  __device__ __forceinline__ void product(LA la, LB lb, int k1 = kHead / 8, int k0 = 0) {
    uint32_t xa[2][4], xb[2][N][2];
    la(xa[0], k0);
    lb(xb[0], k0);
#pragma unroll
    for (int i = 0; i < kHead / 8; ++i) {
      const int ks = k0 + i;
      if (ks >= k1) break;
      if (ks + 1 < k1) {
        la(xa[(i + 1) % 2], ks + 1);
        lb(xb[(i + 1) % 2], ks + 1);
      }
      mma3(Frag(xa[i % 2]), xb[i % 2]);
    }
  }
  __device__ __forceinline__ float at(int n, int i) const { return acc[n][i] + (cl[n][i] + ch[n][i]); }
};

// one step of a butterfly sum of 2 N values over the lanes: lanes with bit
// M keep the upper N, the others the lower N, each adding its partner's
template <int M, int N, int L>
__device__ __forceinline__ void fold(float (&x)[L], int lane) {
  const bool upper = lane & M;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float send = upper ? x[i] : x[i + N];
    x[i] = (upper ? x[i + N] : x[i]) + __shfl_xor_sync(0xffffffffu, send, M);
  }
}

}  // namespace
