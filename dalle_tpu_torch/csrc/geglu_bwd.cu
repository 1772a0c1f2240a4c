// Fused GEGLU feed-forward, backward tensors, as one triple-GEMM kernel:
//
//   h   = x . Wi + bi          (depth d)
//   g   = x . Wg + bg          (depth d)
//   dhg = dO . Wo^T            (depth d)
//   dh  = bf16(dhg * gelu(g)),  dg = bf16(dhg * h * gelu'(g)),
//   hg  = bf16(h * gelu(g))
//
// Replaces the TPU kernel dalle_tpu/ops/pallas/geglu_kernels.py
// _ff_bwd_tensors (_ff_bwd_kernel): the same three products with f32
// accumulation of bf16 operands, the same gelu and gelu' formulas, and the
// same rounding points (the three outputs in bf16). The other contractions
// of the backward (dx, dWi, dWg, dWo, the bias sums) stay plain GEMMs
// outside the kernel, as the JAX package leaves them to XLA.
//
// Output layout: dh and dg side by side in one (M, 2K) buffer (dh in
// columns [0, K), dg in [K, 2K)), so the caller forms dx = [dh|dg].[Wi|Wg]^T
// and [dWi|dWg] = x^T.[dh|dg] as one GEMM each; hg (M, K).
//
// What bounds it on the card: 3 products of 2.M.d.K = 129 GFLOP at the
// flagship (M = 5120, d = 1024, K = 4096) against 126 MB of bf16 outputs and
// ~40 MB of operands, above the ~295 FLOP/byte ridge, so the floor is the
// bf16 tensor-core rate. The design is the forward's (geglu_fwd.cu,
// gemm_sm90.cuh): a persistent kernel walking 128 x 64 output tiles
// m-fast (x and dO, 20 MB, stay in L2 while the weight columns stream);
// one producer thread fills a ring of 3 TMA stages of depth 64 (the x and
// dO rows, Wi and Wg MN-major, Wo's rows n0.. as Wo^T K-major, so no
// transpose is materialised); two consumer warpgroups of 64 rows each run
// the three wgmma m64n64k16 products per k16 step into three register
// accumulators (96 registers a thread) and form the gelu' epilogue straight
// from them into swizzled shared-memory tiles of dh, dg and hg, written by
// TMA stores while the next tile's products run. A 56 KB stage over a
// 128 x 64 tile reads much from L2: the blocks run in clusters of two
// along N, each loading half of the x and dO rows and multicasting it to
// both, so a block reads 40 KB a stage. Single blocks, clusters of four
// and a 128 x 128 tile (192 accumulator registers, 2 stages) were slower
// at the flagship shape on an H100.

#include "gemm_sm90.cuh"

namespace {

constexpr int BM = 128, BN = 64, BK = 64;
constexpr int THREADS = 384;          // consumer warpgroups 0-1, producer 2
constexpr int TILE_X = BM * BK * 2;   // x or dO: 128 rows x 64 deep, 16 KB
constexpr int BOX = 64 * 64 * 2;      // Wi, Wg, Wo^T; one output box, 8 KB
constexpr int STAGE = 2 * TILE_X + 3 * BOX;
constexpr int STAGES = 3;
constexpr int RING = STAGES * STAGE;
constexpr int TILE_C = 3 * BOX;       // a warpgroup's dh, dg, hg, staged
// the ring, the two warpgroups' output tiles, 1 KB for aligning them, the
// full and empty barriers
constexpr int SMEM = RING + 2 * TILE_C + 1024 + 2 * STAGES * 8;
constexpr int CONSUMER_WARPS = 8;
constexpr int CLUSTER = 2;              // blocks sharing x and dO, along N
constexpr int PART_X = TILE_X / CLUSTER;  // the rows of them a block loads

constexpr float GELU_C = 0.044715f;
constexpr float GELU_3C = (float)(3.0 * 0.044715);  // 3.0 * _GELU_C
constexpr float SQRT_2_OVER_PI = 0.7978845608028654f;

}  // namespace

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
geglu_bwd_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_do,
                 const __grid_constant__ CUtensorMap map_wi,
                 const __grid_constant__ CUtensorMap map_wg,
                 const __grid_constant__ CUtensorMap map_wo,
                 const __grid_constant__ CUtensorMap map_dh,
                 const __grid_constant__ CUtensorMap map_dg,
                 const __grid_constant__ CUtensorMap map_hg,
                 const bf16* __restrict__ bi, const bf16* __restrict__ bg,
                 int M, int D, int K) {
  extern __shared__ unsigned char smem[];
  const uint32_t base = (sm90::smem_addr(smem) + 1023) & ~1023u;
  const uint32_t out = base + RING;
  const uint32_t full = out + 2 * TILE_C;
  const uint32_t empty = full + STAGES * 8;
  // The blocks of a cluster walk the same (m0, column group) tiles, the
  // block of rank r taking column tile CLUSTER g + r; each loads its part
  // of the x and dO rows and multicasts it to all of them. A stage is
  // refilled once the consumers of every block have released it. Where the
  // column tiles do not fill the last group, a block past K still loads
  // its part for the others and stores nothing.
  const uint32_t rank = sm90::cluster_rank();
  const int mt = (M + BM - 1) / BM;
  const int tiles = mt * ((K / BN + CLUSTER - 1) / CLUSTER), nk = D / BK;
  const int first = blockIdx.x / CLUSTER, step = gridDim.x / CLUSTER;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::bar_init(full + 8 * s, 1);
      sm90::bar_init(empty + 8 * s, CLUSTER * CONSUMER_WARPS);
    }
    sm90::bar_init_fence();
  }
  sm90::cluster_sync();

  if (wg == 2) {
    // ---- producer: one thread starts every TMA load -------------------
    sm90::regs_dec<40>();
    if (threadIdx.x == 256) {
      sm90::prefetch_map(&map_x);
      sm90::prefetch_map(&map_do);
      sm90::prefetch_map(&map_wi);
      sm90::prefetch_map(&map_wg);
      sm90::prefetch_map(&map_wo);
      int s = 0;
      uint32_t phase = 0;
      for (int t = first; t < tiles; t += step) {
        const int m0 = (t % mt) * BM, n0 = ((t / mt) * CLUSTER + rank) * BN;
        const int part = m0 + BM / CLUSTER * rank;
        const uint16_t all = (1 << CLUSTER) - 1;
        for (int kb = 0; kb < nk; ++kb) {
          sm90::bar_wait(empty + 8 * s, phase ^ 1);
          const uint32_t bar = full + 8 * s, st = base + s * STAGE;
          const uint32_t w = st + 2 * TILE_X;
          sm90::bar_expect_tx(bar, STAGE);
          sm90::tma_load_multicast(st + rank * PART_X, &map_x, bar, kb * BK,
                                   part, all);
          sm90::tma_load_multicast(st + TILE_X + rank * PART_X, &map_do, bar,
                                   kb * BK, part, all);
          sm90::tma_load(w, &map_wi, bar, n0, kb * BK);
          sm90::tma_load(w + BOX, &map_wg, bar, n0, kb * BK);
          // Wo rows n0 .. n0 + 63, depth kb * 64 ..: Wo^T, K-major
          sm90::tma_load(w + 2 * BOX, &map_wo, bar, kb * BK, n0);
          if (++s == STAGES) {
            s = 0;
            phase ^= 1;
          }
        }
      }
      // stay until every block's consumers have released every stage: their
      // last arrivals land on this block's barriers
      for (int i = 0; i < STAGES; ++i) {
        sm90::bar_wait(empty + 8 * s, phase ^ 1);
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg computes rows 64 wg .. 64 wg + 63 -----
    sm90::regs_inc<232>();
    const int tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32;
    const int row = warp * 16 + lane / 4;   // and row + 8, in the warpgroup
    const uint32_t my_out = out + wg * TILE_C;
    float accH[32], accG[32], accD[32];
    __nv_bfloat162 b_i[8], b_g[8];
    int s = 0;
    uint32_t phase = 0;
    for (int t = first; t < tiles; t += step) {
      const int m0 = (t % mt) * BM, n0 = ((t / mt) * CLUSTER + rank) * BN;
      // this thread's bias pairs, read before the main loop hides their
      // latency (clamped in a tile past K, which stores nothing)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = min(n0, K - BN) + 8 * i + 2 * (lane % 4);
        b_i[i] = *reinterpret_cast<const __nv_bfloat162*>(bi + col);
        b_g[i] = *reinterpret_cast<const __nv_bfloat162*>(bg + col);
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) accH[i] = accG[i] = accD[i] = 0.f;
      sm90::fence_regs(accH);
      sm90::fence_regs(accG);
      sm90::fence_regs(accD);
      for (int kb = 0; kb < nk; ++kb) {
        sm90::bar_wait(full + 8 * s, phase);
        const uint32_t st = base + s * STAGE;
        const uint32_t w = st + 2 * TILE_X;
        sm90::wgmma_fence();
#pragma unroll
        for (int k = 0; k < BK / 16; ++k) {
          const uint64_t dx = sm90::desc_k(st + wg * (64 * 128), k);
          const uint64_t dd = sm90::desc_k(st + TILE_X + wg * (64 * 128), k);
          sm90::wgmma<1>(accH, dx, sm90::desc_mn(w, k));
          sm90::wgmma<1>(accG, dx, sm90::desc_mn(w + BOX, k));
          sm90::wgmma<0>(accD, dd, sm90::desc_k(w + 2 * BOX, k));
        }
        sm90::wgmma_commit();
        // the stage is read: release it to both blocks' producers
        sm90::wgmma_wait<0>();
        if (lane == 0)
          for (int r = 0; r < CLUSTER; ++r)
            sm90::bar_arrive_at(empty + 8 * s, r);
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
      sm90::fence_regs(accH);
      sm90::fence_regs(accG);
      sm90::fence_regs(accD);

      // epilogue from the registers into the warpgroup's staged dh, dg
      // and hg boxes (once their previous stores have read them), then
      // three TMA stores that run on while the next tile's products start
      if (tw == 0) sm90::store_wait<1>();
      sm90::wg_sync(1 + wg);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = 8 * i + 2 * (lane % 4);
        const float2 fi = __bfloat1622float2(b_i[i]);
        const float2 fg = __bfloat1622float2(b_g[i]);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float dh[2], dg[2], hg[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            // the formulas of geglu_kernels._gelu / _gelu_grad, same order
            const int j = 4 * i + 2 * half + e;
            const float h = accH[j] + (e ? fi.y : fi.x);
            const float g = accG[j] + (e ? fg.y : fg.x);
            const float dhg = accD[j];
            const float u = SQRT_2_OVER_PI * (g + GELU_C * g * g * g);
            const float t = tanhf(u);
            const float a = 0.5f * g * (1.0f + t);
            const float du = SQRT_2_OVER_PI * (1.0f + GELU_3C * g * g);
            const float da = 0.5f * (1.0f + t) + 0.5f * g * (1.0f - t * t) * du;
            dh[e] = dhg * a;
            dg[e] = dhg * h * da;
            hg[e] = h * a;
          }
          const int r = row + 8 * half;
          sm90::stage_pair(my_out, r, col, dh[0], dh[1]);
          sm90::stage_pair(my_out + BOX, r, col, dg[0], dg[1]);
          sm90::stage_pair(my_out + 2 * BOX, r, col, hg[0], hg[1]);
        }
      }
      sm90::fence_async_smem();
      sm90::wg_sync(1 + wg);
      if (tw == 0 && m0 + 64 * wg < M && n0 < K) {
        sm90::tma_store(&map_dh, my_out, n0, m0 + 64 * wg);
        sm90::tma_store(&map_dg, my_out + BOX, n0, m0 + 64 * wg);
        sm90::tma_store(&map_hg, my_out + 2 * BOX, n0, m0 + 64 * wg);
        sm90::store_commit();
      }
    }
    if (tw == 0) sm90::store_wait<0>();
  }
}

extern "C" int geglu_bwd_tensors(const void* x, const void* wi,
                                 const void* wg, const void* wo,
                                 const void* bi, const void* bg,
                                 const void* dout, void* dhdg, void* hg,
                                 int M, int D, int K, void* stream) {
  if (K % BN || D % BK) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  // dh and dg: the two (M, K) halves of the (M, 2K) buffer
  bf16* dh = static_cast<bf16*>(dhdg);
  CUtensorMap mx, mdo, mwi, mwg, mwo, mdh, mdg, mhg;
  int err = sm90::make_map(&mx, x, M, D, BM / CLUSTER);
  if (!err) err = sm90::make_map(&mdo, dout, M, D, BM / CLUSTER);
  if (!err) err = sm90::make_map(&mwi, wi, D, K, BK);
  if (!err) err = sm90::make_map(&mwg, wg, D, K, BK);
  if (!err) err = sm90::make_map(&mwo, wo, K, D, BN);
  if (!err) err = sm90::make_map(&mdh, dh, M, K, 64, 2 * K);
  if (!err) err = sm90::make_map(&mdg, dh + K, M, K, 64, 2 * K);
  if (!err) err = sm90::make_map(&mhg, hg, M, K, 64);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      geglu_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  // one cluster for each group of tiles, at most as many as fit at once
  static int clusters = 0;
  if (clusters == 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CLUSTER * 1024);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = SMEM;
    e = cudaOccupancyMaxActiveClusters(&clusters, (void*)geglu_bwd_kernel,
                                       &cfg);
    if (e != cudaSuccess) return (int)e;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  }
  const int tiles =
      ((M + BM - 1) / BM) * ((K / BN + CLUSTER - 1) / CLUSTER);
  const int grid = CLUSTER * (clusters < tiles ? clusters : tiles);
  geglu_bwd_kernel<<<grid, THREADS, SMEM,
                     static_cast<cudaStream_t>(stream)>>>(
      mx, mdo, mwi, mwg, mwo, mdh, mdg, mhg, static_cast<const bf16*>(bi),
      static_cast<const bf16*>(bg), M, D, K);
  return (int)cudaGetLastError();
}

// out[4]: registers, static and dynamic shared memory (bytes a block),
// local bytes a thread of the kernel.
extern "C" int geglu_bwd_resources(int* out) {
  return sm90::resources((const void*)geglu_bwd_kernel, SMEM, out);
}

extern "C" const char* geglu_bwd_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
