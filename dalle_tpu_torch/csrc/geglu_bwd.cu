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
// bf16 tensor-core rate. The design is the forward's (geglu_fwd.cu): WMMA
// bf16 16x16x16 with f32 accumulators, 64 x 64 output tiles per block of
// 4 warps (each warp a 32 x 32 tile of all three products), a two-stage
// cp.async pipeline of depth-32 shared-memory stages holding the x and dO
// rows and the Wi, Wg and Wo tiles, and the elementwise epilogue through
// shared memory. Wo^T is read as a column-major operand from Wo's rows, so
// no transpose is materialised.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64, BN = 64, BKD = 32;
constexpr int LDA = BKD + 8;   // bf16 pitch of the x / dO / Wo^T tiles
constexpr int LDBT = BN + 8;   // bf16 pitch of the Wi / Wg tiles
constexpr int LDC = BN + 4;    // f32 pitch of the epilogue tiles
constexpr int THREADS = 128;
constexpr int A_ELEMS = BM * LDA;     // one (64 rows x 32 depth) tile
constexpr int B_ELEMS = BKD * LDBT;   // one (32 depth x 64 cols) tile
constexpr int WT_ELEMS = BN * LDA;    // Wo rows n0..n0+63, depth 32
constexpr int STAGE = 2 * A_ELEMS + 2 * B_ELEMS + WT_ELEMS;
constexpr int MAIN_BYTES = 2 * STAGE * (int)sizeof(bf16);
constexpr int EPI_BYTES = 3 * BM * LDC * (int)sizeof(float);
constexpr int SMEM_BYTES = MAIN_BYTES > EPI_BYTES ? MAIN_BYTES : EPI_BYTES;

constexpr float GELU_C = 0.044715f;
constexpr float GELU_3C = (float)(3.0 * 0.044715);  // 3.0 * _GELU_C
constexpr float SQRT_2_OVER_PI = 0.7978845608028654f;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  int bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

}  // namespace

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

__global__ void __launch_bounds__(THREADS)
geglu_bwd_kernel(const bf16* __restrict__ X, const bf16* __restrict__ Wi,
                 const bf16* __restrict__ Wg, const bf16* __restrict__ Wo,
                 const bf16* __restrict__ bi, const bf16* __restrict__ bg,
                 const bf16* __restrict__ dO, bf16* __restrict__ dHdG,
                 bf16* __restrict__ HG, int M, int D, int K) {
  extern __shared__ __align__(128) unsigned char pool[];
  bf16* stages = reinterpret_cast<bf16*>(pool);

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32;
  const int wm = warp / 2, wn = warp % 2;  // 2 x 2 warps of 32 x 32

  auto load_stage = [&](int kt, int st) {
    bf16* sX = stages + st * STAGE;
    bf16* sD = sX + A_ELEMS;
    bf16* sWi = sD + A_ELEMS;
    bf16* sWg = sWi + B_ELEMS;
    bf16* sWt = sWg + B_ELEMS;
    const int k0 = kt * BKD;
    for (int c = threadIdx.x; c < BM * (BKD / 8); c += THREADS) {
      const int r = c / (BKD / 8), col = (c % (BKD / 8)) * 8;
      const bool ok = m0 + r < M;
      const long long off = (long long)(m0 + r) * D + k0 + col;
      cp_async16(sX + r * LDA + col, ok ? X + off : X, ok);
      cp_async16(sD + r * LDA + col, ok ? dO + off : dO, ok);
      // Wo^T tile: row n0 + r of Wo, depth columns k0..k0+31
      cp_async16(sWt + r * LDA + col,
                 Wo + (long long)(n0 + r) * D + k0 + col, true);
    }
    for (int c = threadIdx.x; c < BKD * (BN / 8); c += THREADS) {
      const int r = c / (BN / 8), col = (c % (BN / 8)) * 8;
      const long long off = (long long)(k0 + r) * K + n0 + col;
      cp_async16(sWi + r * LDBT + col, Wi + off, true);
      cp_async16(sWg + r * LDBT + col, Wg + off, true);
    }
  };

  Acc accH[2][2], accG[2][2], accD[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(accH[i][j], 0.f);
      wmma::fill_fragment(accG[i][j], 0.f);
      wmma::fill_fragment(accD[i][j], 0.f);
    }

  const int nk = D / BKD;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_stage(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const bf16* sX = stages + (kt & 1) * STAGE;
    const bf16* sD = sX + A_ELEMS;
    const bf16* sWi = sD + A_ELEMS;
    const bf16* sWg = sWi + B_ELEMS;
    const bf16* sWt = sWg + B_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BKD / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
          fx[2], fd[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(fx[i], sX + (wm * 32 + i * 16) * LDA + kk * 16,
                               LDA);
        wmma::load_matrix_sync(fd[i], sD + (wm * 32 + i * 16) * LDA + kk * 16,
                               LDA);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = wn * 32 + j * 16;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, sWi + kk * 16 * LDBT + col, LDBT);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::mma_sync(accH[i][j], fx[i], fb, accH[i][j]);
        wmma::load_matrix_sync(fb, sWg + kk * 16 * LDBT + col, LDBT);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::mma_sync(accG[i][j], fx[i], fb, accG[i][j]);
        // Wo^T as a column-major (depth x cols) operand: element (k, n)
        // sits at sWt[n * LDA + k]
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> ft;
        wmma::load_matrix_sync(ft, sWt + col * LDA + kk * 16, LDA);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::mma_sync(accD[i][j], fd[i], ft, accD[i][j]);
      }
    }
    __syncthreads();
  }

  // epilogue through shared memory (the stage buffers are free now)
  float* sH = reinterpret_cast<float*>(pool);
  float* sG = sH + BM * LDC;
  float* sDH = sG + BM * LDC;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int off = (wm * 32 + i * 16) * LDC + wn * 32 + j * 16;
      wmma::store_matrix_sync(sH + off, accH[i][j], LDC, wmma::mem_row_major);
      wmma::store_matrix_sync(sG + off, accG[i][j], LDC, wmma::mem_row_major);
      wmma::store_matrix_sync(sDH + off, accD[i][j], LDC,
                              wmma::mem_row_major);
    }
  __syncthreads();
  for (int p = threadIdx.x; p < BM * BN / 2; p += THREADS) {
    const int r = p / (BN / 2), c = (p % (BN / 2)) * 2;
    if (m0 + r >= M) continue;
    float dh[2], dg[2], hg[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      // the formulas of geglu_kernels._gelu / _gelu_grad, same order
      const float h = sH[r * LDC + c + e] + __bfloat162float(bi[n0 + c + e]);
      const float g = sG[r * LDC + c + e] + __bfloat162float(bg[n0 + c + e]);
      const float dhg = sDH[r * LDC + c + e];
      const float u = SQRT_2_OVER_PI * (g + GELU_C * g * g * g);
      const float t = tanhf(u);
      const float a = 0.5f * g * (1.0f + t);
      const float du = SQRT_2_OVER_PI * (1.0f + GELU_3C * g * g);
      const float da = 0.5f * (1.0f + t) + 0.5f * g * (1.0f - t * t) * du;
      dh[e] = dhg * a;
      dg[e] = dhg * h * da;
      hg[e] = h * a;
    }
    const long long row = (long long)(m0 + r);
    *reinterpret_cast<__nv_bfloat162*>(dHdG + row * 2 * K + n0 + c) =
        __float22bfloat162_rn(make_float2(dh[0], dh[1]));
    *reinterpret_cast<__nv_bfloat162*>(dHdG + row * 2 * K + K + n0 + c) =
        __float22bfloat162_rn(make_float2(dg[0], dg[1]));
    *reinterpret_cast<__nv_bfloat162*>(HG + row * K + n0 + c) =
        __float22bfloat162_rn(make_float2(hg[0], hg[1]));
  }
}

extern "C" int geglu_bwd_tensors(const void* x, const void* wi,
                                 const void* wg, const void* wo,
                                 const void* bi, const void* bg,
                                 const void* dout, void* dhdg, void* hg,
                                 int M, int D, int K, void* stream) {
  if (K % BN || D % BKD) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      geglu_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(K / BN, (M + BM - 1) / BM);
  geglu_bwd_kernel<<<grid, THREADS, SMEM_BYTES,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wi),
      static_cast<const bf16*>(wg), static_cast<const bf16*>(wo),
      static_cast<const bf16*>(bi), static_cast<const bf16*>(bg),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dhdg),
      static_cast<bf16*>(hg), M, D, K);
  return (int)cudaGetLastError();
}

extern "C" const char* geglu_bwd_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
