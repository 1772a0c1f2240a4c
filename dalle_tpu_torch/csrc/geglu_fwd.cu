// Fused GEGLU feed-forward, forward only, as two tensor-core GEMMs:
//
//   (a) geglu_gate_fwd:  hg = bf16( (x.Wi + bi) * gelu_tanh(x.Wg + bg) )
//       a dual GEMM sharing the x tile, with the bias + gelu + product in
//       the epilogue; hg is rounded to bf16 at the point where the TPU kernel
//       rounds it before its third product (geglu_kernels.py:86);
//   (b) geglu_out_fwd:   out = bf16( bo + hg.Wo ), the f32 accumulator
//       seeded with bo as in the TPU kernel.
//
// Replaces the TPU kernel dalle_tpu/ops/pallas/geglu_kernels.py _ff_fwd
// (_ff_fwd_kernel). That kernel keeps a (256, 1024) f32 accumulator of the
// third product in VMEM across the inner dimension, 1 MB, which no SM can
// hold (227 KB of shared memory, 256 KB of registers); splitting at hg costs
// one (M, 4096) bf16 round trip through device memory (84 MB at the
// flagship's M = 5120, about 25 us at 3.35 TB/s) against ~130 us of
// tensor-core work.
//
// What bounds it on the card: 6.M.d.K = 129 GFLOP at the flagship against
// ~46 MB of operands, far above the ~295 FLOP/byte ridge, so the floor is
// the bf16 tensor-core rate, which only wgmma reaches. The design
// (gemm_sm90.cuh): a persistent kernel, one block an SM walking 128 x 128
// output tiles; in each block one producer thread keeps a ring of
// shared-memory stages full with TMA loads of depth 64 (x | Wi | Wg for the
// gate, 48 KB a stage, 4 stages; hg | Wo for the output, 32 KB, 6 stages),
// and two consumer warpgroups (64 rows each) run wgmma m64n128k16 on them
// with the accumulators in registers (h and g: 128 a thread), releasing
// each stage as soon as its products are done. The epilogue works straight
// from the accumulator registers: bias, gelu and product in f32, rounded
// once to bf16 into a swizzled shared-memory tile that one TMA store
// writes out while the next tile's products already run (the producer has
// filled the ring for it meanwhile). setmaxnreg moves registers from the
// producer warpgroup (40) to the consumers (232). Sharing the B tiles
// between two blocks of a cluster (TMA multicast), as the backward does
// with its A tiles, made neither GEMM faster on an H100.
// Operands: row-major contiguous, x (M, d), Wi/Wg (d, K) in flax's (in, out)
// layout (read MN-major), Wo (K, d) (MN-major too), biases bf16; d and K
// multiples of 64, M free: the TMA reads zeros past the last row and past
// K where a 128-column tile overhangs it, and drops stores past the edges.

#include "gemm_sm90.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int THREADS = 384;            // consumer warpgroups 0-1, producer 2
constexpr int TILE_A = BM * BK * 2;     // x or hg: 128 rows x 64 deep, 16 KB
constexpr int BOX = 64 * 64 * 2;        // one 64 x 64 box, 8 KB
constexpr int TILE_B = 2 * BOX;         // B: 64 deep x 128 columns
constexpr int TILE_C = 2 * BOX;         // a warpgroup's output rows, staged
constexpr int BIAS = 2 * BN * 2;        // a warpgroup's bi | bg, bf16
constexpr int CONSUMER_WARPS = 8;

template <int GATE>
struct Shape {
  static constexpr int STAGE = TILE_A + (GATE ? 2 : 1) * TILE_B;
  static constexpr int STAGES = GATE ? 4 : 6;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int BIASES = GATE ? 2 * BIAS : 0;
  // the ring, the two warpgroups' output tiles and gate biases (bi | bg
  // of the tile's 128 columns), 1 KB for aligning them, the full and empty
  // barriers
  static constexpr int SMEM =
      RING + 2 * TILE_C + BIASES + 1024 + 2 * STAGES * 8;
};

constexpr float GELU_C = 0.044715f;
constexpr float SQRT_2_OVER_PI = 0.7978845608028654f;

__device__ __forceinline__ float gelu_tanh(float g) {
  // the formula of geglu_kernels._gelu, same operation order
  const float u = SQRT_2_OVER_PI * (g + GELU_C * g * g * g);
  return 0.5f * g * (1.0f + tanhf(u));
}

}  // namespace

// GATE = 1: C (M, N) = bf16((A.B1 + bias1) * gelu(A.B2 + bias2));
// GATE = 0: C = bf16(bias1 + A.B1). A (M, Kd) K-major, B1/B2 (Kd, N)
// MN-major, C written through map_c. Tiles run m-fast when m_fast is set
// (the gate: the x rows stay in L2 while the weight columns stream), else
// n-fast (the output: Wo stays in L2 while the hg rows stream).
template <int GATE>
__global__ void __launch_bounds__(THREADS, 1)
geglu_fwd_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b1,
                 const __grid_constant__ CUtensorMap map_b2,
                 const __grid_constant__ CUtensorMap map_c,
                 const bf16* __restrict__ bias1,
                 const bf16* __restrict__ bias2, int M, int N, int Kd,
                 int m_fast) {
  typedef Shape<GATE> S;
  extern __shared__ unsigned char smem[];
  const uint32_t base = (sm90::smem_addr(smem) + 1023) & ~1023u;
  const uint32_t out = base + S::RING;
  const uint32_t bias = out + 2 * TILE_C;
  const uint32_t full = bias + S::BIASES;
  const uint32_t empty = full + S::STAGES * 8;
  const int mt = (M + BM - 1) / BM, nt = (N + BN - 1) / BN;
  const int tiles = mt * nt, nk = Kd / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      sm90::bar_init(full + 8 * s, 1);
      sm90::bar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    sm90::bar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread starts every TMA load -------------------
    sm90::regs_dec<40>();
    if (threadIdx.x == 256) {
      sm90::prefetch_map(&map_a);
      sm90::prefetch_map(&map_b1);
      if (GATE) sm90::prefetch_map(&map_b2);
      int s = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (m_fast ? t % mt : t / nt) * BM;
        const int n0 = (m_fast ? t / mt : t % nt) * BN;
        for (int kb = 0; kb < nk; ++kb) {
          sm90::bar_wait(empty + 8 * s, phase ^ 1);
          const uint32_t bar = full + 8 * s, st = base + s * S::STAGE;
          sm90::bar_expect_tx(bar, S::STAGE);
          sm90::tma_load(st, &map_a, bar, kb * BK, m0);
          sm90::tma_load(st + TILE_A, &map_b1, bar, n0, kb * BK);
          sm90::tma_load(st + TILE_A + BOX, &map_b1, bar, n0 + 64, kb * BK);
          if (GATE) {
            sm90::tma_load(st + TILE_A + TILE_B, &map_b2, bar, n0, kb * BK);
            sm90::tma_load(st + TILE_A + TILE_B + BOX, &map_b2, bar, n0 + 64,
                           kb * BK);
          }
          if (++s == S::STAGES) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg computes rows 64 wg .. 64 wg + 63 -----
    sm90::regs_inc<232>();
    const int tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32;
    const int row = warp * 16 + lane / 4;   // and row + 8, in the warpgroup
    const uint32_t my_out = out + wg * TILE_C, my_bias = bias + wg * BIAS;
    float acc1[64], acc2[GATE ? 64 : 1];
    int s = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (m_fast ? t % mt : t / nt) * BM;
      const int n0 = (m_fast ? t / mt : t % nt) * BN;
      // biases are read before the main loop, which hides their latency;
      // columns past N are clamped (their outputs are not stored)
      uint32_t gate_bias = 0;  // GATE: this thread's pair of bi | bg
      if constexpr (GATE) {
        const int col = min(n0 + 2 * (tw % 64), N - 2);
        gate_bias = *reinterpret_cast<const uint32_t*>(
            (tw < 64 ? bias1 : bias2) + col);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc1[i] = acc2[i] = 0.f;
      } else {
        // seed the accumulator with the output bias, as the TPU kernel
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int col = min(n0 + 8 * i + 2 * (lane % 4), N - 2);
          const float2 b = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(bias1 + col));
          acc1[4 * i + 0] = acc1[4 * i + 2] = b.x;
          acc1[4 * i + 1] = acc1[4 * i + 3] = b.y;
        }
      }
      sm90::fence_regs(acc1);
      if constexpr (GATE) sm90::fence_regs(acc2);
      for (int kb = 0; kb < nk; ++kb) {
        sm90::bar_wait(full + 8 * s, phase);
        const uint32_t st = base + s * S::STAGE;
        const uint32_t a = st + wg * (64 * 128);
        sm90::wgmma_fence();
#pragma unroll
        for (int k = 0; k < BK / 16; ++k) {
          const uint64_t da = sm90::desc_k(a, k);
          sm90::wgmma<1>(acc1, da, sm90::desc_mn(st + TILE_A, k));
          if constexpr (GATE)
            sm90::wgmma<1>(acc2, da, sm90::desc_mn(st + TILE_A + TILE_B, k));
        }
        sm90::wgmma_commit();
        // the stage is read: release it to the producer
        sm90::wgmma_wait<0>();
        if (lane == 0) sm90::bar_arrive(empty + 8 * s);
        if (++s == S::STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
      sm90::fence_regs(acc1);
      if constexpr (GATE) sm90::fence_regs(acc2);

      // epilogue from the registers into the warpgroup's staged output
      // tile (once its previous store has read it), then one TMA store of
      // its 64 rows that runs on while the next tile's products start
      if constexpr (GATE)
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(my_bias + 4 * tw),
                     "r"(gate_bias)
                     : "memory");
      if (tw == 0) sm90::store_wait<1>();
      sm90::wg_sync(1 + wg);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const uint32_t box = my_out + (i / 8) * BOX;
        const int col = (i % 8) * 8 + 2 * (lane % 4);
        float2 bb1 = make_float2(0.f, 0.f), bb2 = bb1;
        if constexpr (GATE) {
          uint32_t w1, w2;
          const uint32_t at = my_bias + 4 * (4 * i + lane % 4);
          asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(w1) : "r"(at));
          asm volatile("ld.shared.b32 %0, [%1];\n"
                       : "=r"(w2)
                       : "r"(at + 2 * BN));
          bb1 = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w1));
          bb2 = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w2));
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = 4 * i + 2 * h;
          if constexpr (GATE) {
            const float h0 = acc1[j] + bb1.x, h1 = acc1[j + 1] + bb1.y;
            const float g0 = acc2[j] + bb2.x, g1 = acc2[j + 1] + bb2.y;
            sm90::stage_pair(box, row + 8 * h, col, h0 * gelu_tanh(g0),
                             h1 * gelu_tanh(g1));
          } else {
            sm90::stage_pair(box, row + 8 * h, col, acc1[j], acc1[j + 1]);
          }
        }
      }
      sm90::fence_async_smem();
      sm90::wg_sync(1 + wg);
      if (tw == 0 && m0 + 64 * wg < M) {
        sm90::tma_store(&map_c, my_out, n0, m0 + 64 * wg);
        if (n0 + 64 < N)
          sm90::tma_store(&map_c, my_out + BOX, n0 + 64, m0 + 64 * wg);
        sm90::store_commit();
      }
    }
    if (tw == 0) sm90::store_wait<0>();
  }
}

namespace {

template <int GATE>
int launch(const void* a, const void* b1, const void* b2, const void* bias1,
           const void* bias2, void* c, int M, int N, int Kd, int m_fast,
           cudaStream_t stream) {
  if (N % 64 || Kd % BK) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  CUtensorMap ma, mb1, mb2, mc;
  int err = sm90::make_map(&ma, a, M, Kd, BM);
  if (!err) err = sm90::make_map(&mb1, b1, Kd, N, BK);
  if (!err) err = sm90::make_map(&mb2, GATE ? b2 : b1, Kd, N, BK);
  if (!err) err = sm90::make_map(&mc, c, M, N, 64);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      geglu_fwd_kernel<GATE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Shape<GATE>::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int sms = sm90::sm_count();
  const int grid = sms > 0 && sms < tiles ? sms : tiles;
  geglu_fwd_kernel<GATE><<<grid, THREADS, Shape<GATE>::SMEM, stream>>>(
      ma, mb1, mb2, mc, static_cast<const bf16*>(bias1),
      static_cast<const bf16*>(bias2), M, N, Kd, m_fast);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int geglu_gate_fwd(const void* x, const void* wi, const void* wg,
                              const void* bi, const void* bg, void* hg, int M,
                              int D, int K, void* stream) {
  return launch<1>(x, wi, wg, bi, bg, hg, M, K, D, 1,
                   static_cast<cudaStream_t>(stream));
}

extern "C" int geglu_out_fwd(const void* hg, const void* wo, const void* bo,
                             void* out, int M, int K, int D, void* stream) {
  return launch<0>(hg, wo, nullptr, bo, nullptr, out, M, D, K, 0,
                   static_cast<cudaStream_t>(stream));
}

// out[4]: registers, static and dynamic shared memory (bytes a block),
// local bytes a thread of the gate (gate = 1) or output (0) kernel.
extern "C" int geglu_fwd_resources(int gate, int* out) {
  return gate ? sm90::resources((const void*)geglu_fwd_kernel<1>,
                                Shape<1>::SMEM, out)
              : sm90::resources((const void*)geglu_fwd_kernel<0>,
                                Shape<0>::SMEM, out);
}

extern "C" const char* geglu_fwd_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
