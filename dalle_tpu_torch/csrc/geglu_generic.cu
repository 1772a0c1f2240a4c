// Generic GEGLU feed-forward, forward and backward tensors, for the operands
// the fast kernels (geglu_fwd.cu, geglu_bwd.cu: bf16 with d and K multiples
// of 64) do not take: bf16 or f32, d and K multiples of 8, any M.
// ops/geglu.py's geglu_route picks the fast or the generic route before any
// launch.
//
// Replaces, for those operands, the TPU kernels of
// dalle_tpu/ops/pallas/geglu_kernels.py: _ff_fwd (_ff_fwd_kernel) and
// _ff_bwd_tensors (_ff_bwd_kernel), whose Pallas bodies take f32 too.
//
// Math, with the cast points of geglu_ff_plain and geglu_ff_bwd_plain
// (ops/geglu.py): every product in f32 from the operands (FFMA, no tensor
// cores, so an f32 product is full f32, never TF32); h = x.Wi + bi and g =
// x.Wg + bg; forward hg = (h * gelu(g)) rounded to the operand dtype, then
// out = bo + hg.Wo rounded once; backward dhg = dO.Wo^T and, each rounded
// once to the operand dtype, dh = dhg * gelu(g), dg = dhg * h * gelu'(g),
// hg = h * gelu(g). The tanh-gelu and its derivative are the plain
// versions' formulas in the same operation order.
//
// Design: one SIMT tiled-GEMM template (gemm_generic). A block computes a
// 64 x 64 output tile with 256 threads, a 4 x 4 register micro-tile each,
// over depth-16 slices of A and B staged in shared memory as f32. NACC
// products over the same output tile (two for the gate, three for the
// backward) run one after another into their own accumulators, and an
// epilogue functor writes the tile from them: GateEpi (bias, gelu,
// product), OutEpi (the output bias) and BwdEpi (the three backward
// tensors). B is read as (Kd, N) row-major, or as (N, Kd) row-major for
// dO.Wo^T. Fixed order, no atomics: two runs give identical bits.
//
// What bounds it: 6.M.d.K operations against a few operand bytes, far above
// the card's ridge, so the floor is the f32 rate outside the tensor cores
// (67 TFLOP/s on an H100). This tiling is meant to be right for every
// operand the fast kernels refuse, not fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64, BN = 64, BK = 16;
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr float GELU_C = 0.044715f;
constexpr float SQRT_2_OVER_PI = 0.7978845608028654f;
// 3.0 * GELU_C as the plain version forms it (in double, then used in f32)
constexpr float GELU_3C = (float)(3.0 * 0.044715);

enum { DTYPE_F32 = 0, DTYPE_BF16 = 1 };  // mirrored by ops/geglu.py

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float gelu_tanh(float g) {
  const float u = SQRT_2_OVER_PI * (g + GELU_C * g * g * g);
  return 0.5f * g * (1.0f + tanhf(u));
}

__device__ __forceinline__ float gelu_tanh_grad(float g) {
  const float u = SQRT_2_OVER_PI * (g + GELU_C * g * g * g);
  const float t = tanhf(u);
  const float du = SQRT_2_OVER_PI * (1.0f + GELU_3C * g * g);
  return 0.5f * (1.0f + t) + 0.5f * g * (1.0f - t * t) * du;
}

// One product's operands: A (M, Kd) row-major with row stride lda; B (Kd, N)
// row-major with row stride ldb, or with b_nk its transpose stored (N, Kd)
// row-major.
template <typename T>
struct Operand {
  const T* a;
  int lda;
  const T* b;
  int ldb;
  bool b_nk;
};

// acc += A[m0:m0+64, :] . B[:, n0:n0+64] for this thread's 4 x 4 outputs
// (rows m0 + ty + 16 i, columns n0 + tx + 16 j); zeros past M, N and Kd.
template <typename T>
__device__ __forceinline__ void mainloop(const Operand<T>& op,
                                         float (&acc)[4][4], int m0, int n0,
                                         int M, int N, int Kd,
                                         float (&sA)[BK][BM + 4],
                                         float (&sB)[BK][BN]) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  for (int k0 = 0; k0 < Kd; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, k = i % BK;
      const int gm = m0 + r, gk = k0 + k;
      sA[k][r] = gm < M && gk < Kd
                     ? to_f(op.a[(long long)gm * op.lda + gk]) : 0.f;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int k = op.b_nk ? i % BK : i / BN;
      const int c = op.b_nk ? i / BK : i % BN;
      const int gk = k0 + k, gn = n0 + c;
      float v = 0.f;
      if (gk < Kd && gn < N)
        v = to_f(op.b_nk ? op.b[(long long)gn * op.ldb + gk]
                         : op.b[(long long)gk * op.ldb + gn]);
      sB[k][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sA[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sB[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }
}

template <typename T, class Epi>
__global__ void __launch_bounds__(THREADS) gemm_generic(const Epi e) {
  __shared__ float sA[BK][BM + 4];  // [k][m]; the pad spreads the stores
  __shared__ float sB[BK][BN];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[Epi::NACC][4][4];
#pragma unroll
  for (int p = 0; p < Epi::NACC; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[p][i][j] = 0.f;
#pragma unroll
  for (int p = 0; p < Epi::NACC; ++p)
    mainloop<T>(e.operand(p), acc[p], m0, n0, e.M, e.N, e.Kd, sA, sB);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + ty + 16 * i, c = n0 + tx + 16 * j;
      if (r < e.M && c < e.N) {
        float v[Epi::NACC];
#pragma unroll
        for (int p = 0; p < Epi::NACC; ++p) v[p] = acc[p][i][j];
        e.store(r, c, v);
      }
    }
  }
}

// hg (M, K) = (x.Wi + bi) * gelu(x.Wg + bg), in T.
template <typename T>
struct GateEpi {
  static constexpr int NACC = 2;
  const T *x, *wi, *wg, *bi, *bg;
  T* hg;
  int M, N, Kd;  // N = K, Kd = d
  __device__ Operand<T> operand(int p) const {
    return {x, Kd, p ? wg : wi, N, false};
  }
  __device__ void store(int r, int c, const float (&v)[NACC]) const {
    const float h = v[0] + to_f(bi[c]), g = v[1] + to_f(bg[c]);
    hg[(long long)r * N + c] = from_f<T>(h * gelu_tanh(g));
  }
};

// out (M, d) = bo + hg.Wo, in T.
template <typename T>
struct OutEpi {
  static constexpr int NACC = 1;
  const T *hg, *wo, *bo;
  T* out;
  int M, N, Kd;  // N = d, Kd = K
  __device__ Operand<T> operand(int) const { return {hg, Kd, wo, N, false}; }
  __device__ void store(int r, int c, const float (&v)[NACC]) const {
    out[(long long)r * N + c] = from_f<T>(to_f(bo[c]) + v[0]);
  }
};

// dhdg (M, 2K) = [dhg * gelu(g) | dhg * h * gelu'(g)] and hg (M, K) =
// h * gelu(g), in T, with dhg = dO.Wo^T.
template <typename T>
struct BwdEpi {
  static constexpr int NACC = 3;
  const T *x, *wi, *wg, *wo, *bi, *bg, *dout;
  T *dhdg, *hg;
  int M, N, Kd;  // N = K, Kd = d
  __device__ Operand<T> operand(int p) const {
    if (p == 2) return {dout, Kd, wo, Kd, true};  // Wo (K, d): B^T, (N, Kd)
    return {x, Kd, p ? wg : wi, N, false};
  }
  __device__ void store(int r, int c, const float (&v)[NACC]) const {
    const float h = v[0] + to_f(bi[c]), g = v[1] + to_f(bg[c]);
    const float a = gelu_tanh(g), dhg = v[2];
    T* row = dhdg + (long long)r * 2 * N;
    row[c] = from_f<T>(dhg * a);
    row[N + c] = from_f<T>(dhg * h * gelu_tanh_grad(g));
    hg[(long long)r * N + c] = from_f<T>(h * a);
  }
};

template <typename T, class Epi>
int launch(const Epi& e, cudaStream_t s) {
  const dim3 grid((e.N + BN - 1) / BN, (e.M + BM - 1) / BM);
  gemm_generic<T, Epi><<<grid, THREADS, 0, s>>>(e);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd(const void* x, const void* wi, const void* wg, const void* wo,
        const void* bi, const void* bg, const void* bo, void* hg, void* out,
        int m, int d, int k, cudaStream_t s) {
  const GateEpi<T> gate{static_cast<const T*>(x),  static_cast<const T*>(wi),
                        static_cast<const T*>(wg), static_cast<const T*>(bi),
                        static_cast<const T*>(bg), static_cast<T*>(hg),
                        m, k, d};
  const int err = launch<T>(gate, s);
  if (err != 0) return err;
  const OutEpi<T> outp{static_cast<const T*>(hg), static_cast<const T*>(wo),
                       static_cast<const T*>(bo), static_cast<T*>(out),
                       m, d, k};
  return launch<T>(outp, s);
}

template <typename T>
int bwd(const void* x, const void* wi, const void* wg, const void* wo,
        const void* bi, const void* bg, const void* dout, void* dhdg,
        void* hg, int m, int d, int k, cudaStream_t s) {
  const BwdEpi<T> e{static_cast<const T*>(x),  static_cast<const T*>(wi),
                    static_cast<const T*>(wg), static_cast<const T*>(wo),
                    static_cast<const T*>(bi), static_cast<const T*>(bg),
                    static_cast<const T*>(dout), static_cast<T*>(dhdg),
                    static_cast<T*>(hg), m, k, d};
  return launch<T>(e, s);
}

}  // namespace

// x (M, d); Wi/Wg (d, K); Wo (K, d); bi/bg (K,); bo (d,); hg (M, K) scratch;
// out (M, d); all contiguous, of one dtype (DTYPE_F32 or DTYPE_BF16).
extern "C" int geglu_generic_fwd(const void* x, const void* wi,
                                 const void* wg, const void* wo,
                                 const void* bi, const void* bg,
                                 const void* bo, void* hg, void* out, int m,
                                 int d, int k, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 0) return 0;
  if (dtype == DTYPE_F32)
    return fwd<float>(x, wi, wg, wo, bi, bg, bo, hg, out, m, d, k, s);
  if (dtype == DTYPE_BF16)
    return fwd<bf16>(x, wi, wg, wo, bi, bg, bo, hg, out, m, d, k, s);
  return (int)cudaErrorInvalidValue;
}

// dout (M, d); dhdg (M, 2K) = [dh | dg]; hg (M, K).
extern "C" int geglu_generic_bwd(const void* x, const void* wi,
                                 const void* wg, const void* wo,
                                 const void* bi, const void* bg,
                                 const void* dout, void* dhdg, void* hg,
                                 int m, int d, int k, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 0) return 0;
  if (dtype == DTYPE_F32)
    return bwd<float>(x, wi, wg, wo, bi, bg, dout, dhdg, hg, m, d, k, s);
  if (dtype == DTYPE_BF16)
    return bwd<bf16>(x, wi, wg, wo, bi, bg, dout, dhdg, hg, m, d, k, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* geglu_generic_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
