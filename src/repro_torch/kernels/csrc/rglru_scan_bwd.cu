// rglru_scan_bwd: the gradient of the RG-LRU's affine recurrence
// h_t = a_t h_{t-1} + b_t, for sm_90a.
//
// No TPU kernel: it replaces the gradient that JAX's autodiff takes of the
// recurrence the reference leaves to XLA in repro/models/recurrent.py
// (rglru_block's lax.associative_scan over T).
//
// Semantics (repro_torch.kernels.rglru_scan_bwd.rglru_scan_bwd_plain): for
// every batch row b and channel r, c = dh_last[b, r], then for t from T - 1
// down to 0
//   g = dh_seq[b, t, r] + c
//   da[b, t, r] = g * h_{t-1}     (h_{-1} = h0[b, r], else h_seq[b, t - 1, r])
//   db[b, t, r] = g
//   c = a[b, t, r] * g
// and dh0[b, r] = c.  Built with -fmad=false, so each multiply and add
// rounds on its own, in that order, as the plain version's elementwise ops
// round them: the result is the plain version's bit for bit.  A null da,
// db or dh0 is not written.
//
// Design: a block per (b, 32 neighbouring channels), three warps with a
// role each, walking the row from its end in stages of 16 tokens through
// a ring of kStages slots in shared memory, each slot holding a, h_{t-1}
// and dh_seq tiles (16 tokens x 32 channels) and the slot's da and db
// tiles, handed over by mbarriers:
//   - the producer warp: one lane issues the TMA copies (2-D boxes of a 3-D
//     tensor map (R, T, B): 16 tokens x 32 channels; h_seq's box a token
//     behind, zeros before the row's start, where h0 takes its place) into
//     a free slot, kStages - 1 stages ahead of the chain;
//   - the chain warp, a lane a channel: a and dh_seq of the stage into
//     registers, then the dependent add and multiply a token, g into the
//     slot's db tile;
//   - the store warp: da = g h_{t-1} into the slot's da tile, then one lane
//     stores the da and db tiles by TMA (out of range rows and columns are
//     not written), and frees the slot's output tiles once the stores have
//     read them (kLag stages later).
// So the chain warp's stream holds two shared loads, an add, a multiply
// and a shared store a token.  Rows that TMA cannot take (R not a multiple
// of 4, or a, h_seq, dh_seq off 16 bytes) are copied by the producer
// warp's lanes, 4 bytes each by cp.async into the same ring (their
// arrival on the slot's barrier tracking the copies), and with R off 4
// the store warp writes da and db itself.
//
// Bound on this card: bytes (a, h_seq and dh_seq read once, da and db
// written once); the chain of a token is an add and a multiply.  What
// holds it (H100 80GB HBM3 at 700 W, recurrentgemma's training shape B 2,
// T 4,096, R 2,560, tools/recurrent_clocks.py): 0.176 ms, 71% of the
// 0.125 ms bound; the chain warp spends ~26 cycles a token on its own
// stream and ~38 waiting for the ring (-DRGLRU_CLOCKS): the copies, not
// the chain, hold it.  16 channels a block (320 blocks, 12 stages) took
// 0.22 ms, so 32 (160 blocks, 8 stages) are kept.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kStageTokens = 16;  // tokens a stage
constexpr int kTensors = 3;       // a, h_{t-1}, dh_seq
constexpr int kWarps = 3;         // producer, chain, store
constexpr long long kWaitCycles = 1LL << 34;  // an mbarrier wait that takes this long traps

// W channels a block, a lane each; kStages slots in the ring; the store
// warp frees a slot's output tiles kLag stages after storing them
constexpr int W = 32;
constexpr int kStages = 8;
constexpr int kLag = kStages / 2;
constexpr int kTile = kStageTokens * W;  // floats of a tile
constexpr int kSlot = 5 * kTile;         // a, h_{t-1}, dh_seq, da, db
constexpr int kBars = 4 * kStages;       // full, g ready, input free, output free
constexpr int kSmem = 128 + 4 * kStages * kSlot + 8 * kBars;

#ifdef RGLRU_CLOCKS
// tools/recurrent_clocks.py --parts builds the kernel with -DRGLRU_CLOCKS:
// the chain warps' cycles in all, their cycles waiting on the ring, and
// the tokens they walked, summed over the blocks of the launches since the
// last read (rglru_scan_bwd_clocks)
__device__ unsigned long long g_clocks[3];
#endif

struct Maps {  // 3-D TMA maps (R, T, B) of the five tensors
  CUtensorMap a, h, dh, da, db;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// a box of a 3-D tensor map at (channel c0, token t, row b), completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int t, int b, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(t), "r"(b)
      : "memory");
}

// a box from shared memory into a 3-D tensor map at (c0, t, b); elements
// out of the tensor's range are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, int c0, int t, int b, uint32_t src) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(t), "r"(b)
               : "memory");
}

__device__ __forceinline__ void cp4(uint32_t dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(in ? 4 : 0) : "memory");
}

__global__ void __launch_bounds__(32 * kWarps)
    rglru_bwd_kernel(__grid_constant__ const Maps maps, const float* __restrict__ a, const float* __restrict__ h0,
                     const float* __restrict__ h_seq, const float* __restrict__ dh_seq,
                     const float* __restrict__ dh_last, int T, int R, bool tma_in, bool tma_out,
                     float* __restrict__ da, float* __restrict__ db, float* __restrict__ dh0) {
  constexpr int S = kStages;
  extern __shared__ unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw + ((128 - smem_u32(smem_raw) % 128) % 128));  // 128-byte aligned
  const uint32_t bars = smem_u32(ring + S * kSlot);
  auto full = [&](int s) { return bars + 8 * s; };
  auto ready = [&](int s) { return bars + 8 * (S + s); };
  auto in_free = [&](int s) { return bars + 8 * (2 * S + s); };
  auto out_free = [&](int s) { return bars + 8 * (3 * S + s); };
  auto tile = [&](int s, int which) { return ring + s * kSlot + which * kTile; };  // a, h, dh, da, db

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = blockIdx.x * W, b = blockIdx.y, r = c0 + lane;
  const bool mine = r < R;  // the chain and store warps' channel
  const int n_stages = (T + kStageTokens - 1) / kStageTokens;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      bar_init(full(s), tma_in ? 1 : 32);
      bar_init(ready(s), 32);
      bar_init(in_free(s), 64);
      bar_init(out_free(s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the k-th stage walked holds tokens t0(k) .. t0(k) + 15
  auto t0_of = [&](int k) { return (n_stages - 1 - k) * kStageTokens; };

  if (warp == 0) {  // the producer
    const size_t base = (size_t)b * T * R;
    for (int k = 0; k < n_stages; ++k) {
      const int s = k % S, t0 = t0_of(k);
      if (k >= S) bar_wait(in_free(s), (k / S - 1) & 1);
      if (tma_in) {
        if (lane == 0) {
          bar_expect(full(s), kTensors * kTile * 4);
          tma_load(smem_u32(tile(s, 0)), &maps.a, c0, t0, b, full(s));
          tma_load(smem_u32(tile(s, 1)), &maps.h, c0, t0 - 1, b, full(s));
          tma_load(smem_u32(tile(s, 2)), &maps.dh, c0, t0, b, full(s));
        }
      } else {  // 4 bytes a lane and element, zeros out of range
#pragma unroll 4
        for (int p = lane; p < kStageTokens * W; p += 32) {
          const int j = p / W, col = p % W, t = t0 + j, rr = c0 + col;
          const bool in = t < T && rr < R;
          const size_t at = base + (size_t)(in ? t : 0) * R + (in ? rr : 0);
          cp4(smem_u32(tile(s, 0) + p), a + at, in);
          cp4(smem_u32(tile(s, 2) + p), dh_seq + at, in);
          const bool hin = in && t > 0;
          cp4(smem_u32(tile(s, 1) + p), h_seq + (hin ? at - R : 0), hin);
        }
        asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(full(s)) : "memory");
      }
    }
  } else if (warp == 1) {  // the chain
    float c = mine ? dh_last[(size_t)b * R + r] : 0.f;
#ifdef RGLRU_CLOCKS
    const long long t_start = clock64();
    long long t_wait = 0;
#endif
    for (int k = 0; k < n_stages; ++k) {
      const int s = k % S, t0 = t0_of(k), n = min(kStageTokens, T - t0);
#ifdef RGLRU_CLOCKS
      const long long w0 = clock64();
#endif
      bar_wait(full(s), (k / S) & 1);
      if (k >= S) bar_wait(out_free(s), (k / S - 1) & 1);
#ifdef RGLRU_CLOCKS
      t_wait += clock64() - w0;
#endif
      float sa[kStageTokens], sd[kStageTokens];
      const float* ta = tile(s, 0);
      const float* td = tile(s, 2);
#pragma unroll
      for (int j = 0; j < kStageTokens; ++j) sa[j] = ta[j * W + lane], sd[j] = td[j * W + lane];
      bar_arrive(in_free(s));
      float* tg = tile(s, 4);
#pragma unroll
      for (int j = kStageTokens - 1; j >= 0; --j) {
        if (j < n) {
          const float g = sd[j] + c;
          c = sa[j] * g;
          tg[j * W + lane] = g;
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // g, to the TMA store
      bar_arrive(ready(s));
    }
    if (dh0 && mine) dh0[(size_t)b * R + r] = c;
#ifdef RGLRU_CLOCKS
    if (lane == 0) {
      atomicAdd(&g_clocks[0], (unsigned long long)(clock64() - t_start));
      atomicAdd(&g_clocks[1], (unsigned long long)t_wait);
      atomicAdd(&g_clocks[2], (unsigned long long)T);
    }
#endif
  } else {  // the stores
    const float hstart = mine ? h0[(size_t)b * R + r] : 0.f;
    const size_t base = (size_t)b * T * R;
    for (int k = 0; k < n_stages; ++k) {
      const int s = k % S, t0 = t0_of(k), n = min(kStageTokens, T - t0);
      bar_wait(full(s), (k / S) & 1);
      bar_wait(ready(s), (k / S) & 1);
      const float* th = tile(s, 1);
      const float* tg = tile(s, 4);
      float* tda = tile(s, 3);
#pragma unroll
      for (int j = 0; j < kStageTokens; ++j) {
        const float g = tg[j * W + lane];
        const float hp = t0 + j == 0 ? hstart : th[j * W + lane];
        if (tma_out) {
          if (da) tda[j * W + lane] = g * hp;
        } else if (mine && j < n) {
          const size_t at = base + (size_t)(t0 + j) * R + r;
          if (da) da[at] = g * hp;
          if (db) db[at] = g;
        }
      }
      bar_arrive(in_free(s));
      if (tma_out) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // da, to the TMA store
        __syncwarp();
        if (lane == 0) {
          if (da) tma_store(&maps.da, c0, t0, b, smem_u32(tda));
          if (db) tma_store(&maps.db, c0, t0, b, smem_u32(tg));
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
          asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kLag) : "memory");
          if (k >= kLag) bar_arrive(out_free((k - kLag) % S));  // that stage's stores have read its tiles
        }
      } else {
        __syncwarp();
        if (lane == 0) bar_arrive(out_free(s));
      }
    }
    if (tma_out && lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
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

// a 3-D map of a (B, T, R) float32 tensor in boxes of 16 tokens x W
// channels; out of range reads as zeros
bool make_map(CUtensorMap* m, const void* ptr, int B, int T, int R) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)R, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)R * 4, (cuuint64_t)T * R * 4};
  const cuuint32_t box[3] = {(cuuint32_t)W, (cuuint32_t)kStageTokens, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// a, h_seq, dh_seq (B, T, R) f32, h0, dh_last (B, R) f32 -> da, db (B, T, R),
// dh0 (B, R); a null output is not written.
extern "C" int rglru_scan_bwd_launch(const float* a, const float* h0, const float* h_seq, const float* dh_seq,
                                     const float* dh_last, int B, int T, int R, float* da, float* db, float* dh0,
                                     cudaStream_t stream) {
  if (B <= 0 || R <= 0) return 0;
  if (T <= 0) return (int)cudaErrorInvalidValue;
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool tma_in = R % 4 == 0 && aligned(a) && aligned(h_seq) && aligned(dh_seq);
  const bool tma_out = R % 4 == 0 && (da == nullptr || aligned(da)) && (db == nullptr || aligned(db));
  Maps maps{};
  if (tma_in && !(make_map(&maps.a, a, B, T, R) && make_map(&maps.h, h_seq, B, T, R) &&
                  make_map(&maps.dh, dh_seq, B, T, R)))
    return (int)cudaErrorNotSupported;
  if (tma_out && !((da == nullptr || make_map(&maps.da, da, B, T, R)) &&
                   (db == nullptr || make_map(&maps.db, db, B, T, R))))
    return (int)cudaErrorNotSupported;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(rglru_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const dim3 grid((R + W - 1) / W, B);
  rglru_bwd_kernel<<<grid, 32 * kWarps, kSmem, stream>>>(maps, a, h0, h_seq, dh_seq, dh_last, T, R, tma_in, tma_out, da,
                                                          db, dh0);
  return (int)cudaGetLastError();
}

#ifdef RGLRU_CLOCKS
// out[3] <- the chain warps' (cycles, cycles waiting, tokens) since the last
// read, which this read sets to zero
extern "C" int rglru_scan_bwd_clocks(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_clocks, sizeof(g_clocks));
  const unsigned long long zero[3] = {0, 0, 0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_clocks, zero, sizeof(zero));
  return (int)e;
}
#endif
