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
// the bf16 tensor-core rate. The design feeds tensor cores (WMMA bf16
// 16x16x16, f32 accumulate) from a two-stage cp.async pipeline of shared
// memory tiles (64 x 64 outputs per block of 4 warps, depth 32 per stage).
// Operands: row-major contiguous, x (M, d), Wi/Wg (d, K) in flax's (in, out)
// layout, Wo (K, d), biases bf16; N and the depth must be multiples of 64
// and 32; M is free.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64, BN = 64, BKD = 32;
constexpr int LDA = BKD + 8;   // bf16 pitch of the A tile
constexpr int LDBT = BN + 8;   // bf16 pitch of the B tile
constexpr int LDC = BN + 4;    // f32 pitch of the epilogue tile
constexpr int THREADS = 128;
constexpr int A_ELEMS = BM * LDA;
constexpr int B_ELEMS = BKD * LDBT;

constexpr float GELU_C = 0.044715f;
constexpr float SQRT_2_OVER_PI = 0.7978845608028654f;

__device__ __forceinline__ float gelu_tanh(float g) {
  // the formula of geglu_kernels._gelu, same operation order
  const float u = SQRT_2_OVER_PI * (g + GELU_C * g * g * g);
  return 0.5f * g * (1.0f + tanhf(u));
}

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

// C (M, N) = A (M, Kd) . B (Kd, N) [and A . B2], then the DUAL or the
// output epilogue. bias1/bias2: (N,) bf16.
template <bool DUAL>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
            const bf16* __restrict__ B2, const bf16* __restrict__ bias1,
            const bf16* __restrict__ bias2, bf16* __restrict__ C, int M,
            int N, int Kd) {
  constexpr int STAGE = A_ELEMS + (DUAL ? 2 : 1) * B_ELEMS;
  constexpr int MAIN_BYTES = 2 * STAGE * sizeof(bf16);
  constexpr int EPI_BYTES = (DUAL ? 2 : 1) * BM * LDC * sizeof(float);
  constexpr int POOL = MAIN_BYTES > EPI_BYTES ? MAIN_BYTES : EPI_BYTES;
  __shared__ __align__(128) unsigned char pool[POOL];
  __shared__ __align__(128) float sBias[16 * LDC];

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32;
  const int wm = warp / 2, wn = warp % 2;  // 2 x 2 warps of 32 x 32
  bf16* stages = reinterpret_cast<bf16*>(pool);

  auto load_stage = [&](int kt, int st) {
    bf16* sA = stages + st * STAGE;
    bf16* sB = sA + A_ELEMS;
    const int k0 = kt * BKD;
    for (int c = threadIdx.x; c < BM * (BKD / 8); c += THREADS) {
      const int r = c / (BKD / 8), col = (c % (BKD / 8)) * 8;
      const bool ok = m0 + r < M;
      cp_async16(sA + r * LDA + col,
                 ok ? A + (long long)(m0 + r) * Kd + k0 + col : A, ok);
    }
    for (int c = threadIdx.x; c < BKD * (BN / 8); c += THREADS) {
      const int r = c / (BN / 8), col = (c % (BN / 8)) * 8;
      cp_async16(sB + r * LDBT + col, B + (long long)(k0 + r) * N + n0 + col,
                 true);
      if (DUAL)
        cp_async16(sB + B_ELEMS + r * LDBT + col,
                   B2 + (long long)(k0 + r) * N + n0 + col, true);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc2[2][2];
  if (DUAL) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fill_fragment(acc[i][j], 0.f);
        wmma::fill_fragment(acc2[i][j], 0.f);
      }
  } else {
    // seed the accumulator with the output bias, broadcast over rows
    for (int i = threadIdx.x; i < 16 * BN; i += THREADS)
      sBias[(i / BN) * LDC + i % BN] = __bfloat162float(bias1[n0 + i % BN]);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(acc[i][j], sBias + wn * 32 + j * 16, LDC,
                               wmma::mem_row_major);
  }

  const int nk = Kd / BKD;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_stage(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const bf16* sA = stages + (kt & 1) * STAGE;
    const bf16* sB = sA + A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BKD / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], sA + (wm * 32 + i * 16) * LDA + kk * 16,
                               LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, sB + kk * 16 * LDBT + wn * 32 + j * 16,
                               LDBT);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
        if (DUAL) {
          wmma::load_matrix_sync(
              fb, sB + B_ELEMS + kk * 16 * LDBT + wn * 32 + j * 16, LDBT);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::mma_sync(acc2[i][j], fa[i], fb, acc2[i][j]);
        }
      }
    }
    __syncthreads();
  }

  // epilogue through shared memory (the stage buffers are free now)
  float* sC = reinterpret_cast<float*>(pool);
  float* sC2 = sC + BM * LDC;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float* dst = sC + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16;
      wmma::store_matrix_sync(dst, acc[i][j], LDC, wmma::mem_row_major);
      if (DUAL)
        wmma::store_matrix_sync(sC2 + (dst - sC), acc2[i][j], LDC,
                                wmma::mem_row_major);
    }
  __syncthreads();
  for (int p = threadIdx.x; p < BM * BN / 2; p += THREADS) {
    const int r = p / (BN / 2), c = (p % (BN / 2)) * 2;
    if (m0 + r >= M) continue;
    float2 o;
    if (DUAL) {
      const float h0 = sC[r * LDC + c] + __bfloat162float(bias1[n0 + c]);
      const float h1 = sC[r * LDC + c + 1] + __bfloat162float(bias1[n0 + c + 1]);
      const float g0 = sC2[r * LDC + c] + __bfloat162float(bias2[n0 + c]);
      const float g1 = sC2[r * LDC + c + 1] + __bfloat162float(bias2[n0 + c + 1]);
      o = make_float2(h0 * gelu_tanh(g0), h1 * gelu_tanh(g1));
    } else {
      o = make_float2(sC[r * LDC + c], sC[r * LDC + c + 1]);
    }
    *reinterpret_cast<__nv_bfloat162*>(C + (long long)(m0 + r) * N + n0 + c) =
        __float22bfloat162_rn(o);
  }
}

extern "C" int geglu_gate_fwd(const void* x, const void* wi, const void* wg,
                              const void* bi, const void* bg, void* hg, int M,
                              int D, int K, void* stream) {
  if (K % BN || D % BKD) return (int)cudaErrorInvalidValue;
  dim3 grid(K / BN, (M + BM - 1) / BM);
  gemm_kernel<true><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wi),
      static_cast<const bf16*>(wg), static_cast<const bf16*>(bi),
      static_cast<const bf16*>(bg), static_cast<bf16*>(hg), M, K, D);
  return (int)cudaGetLastError();
}

extern "C" int geglu_out_fwd(const void* hg, const void* wo, const void* bo,
                             void* out, int M, int K, int D, void* stream) {
  if (D % BN || K % BKD) return (int)cudaErrorInvalidValue;
  dim3 grid(D / BN, (M + BM - 1) / BM);
  gemm_kernel<false><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(hg), static_cast<const bf16*>(wo), nullptr,
      static_cast<const bf16*>(bo), nullptr, static_cast<bf16*>(out), M, D, K);
  return (int)cudaGetLastError();
}

extern "C" const char* geglu_fwd_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
