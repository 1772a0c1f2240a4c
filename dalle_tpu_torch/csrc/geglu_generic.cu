// Generic GEGLU feed-forward, forward and backward tensors, for the operands
// the fast kernels (geglu_fwd.cu, geglu_bwd.cu: bf16 with d and K multiples
// of 64) do not take: bf16 or f32, d and K multiples of 8, any M.
// ops/geglu.py's geglu_route picks the fast or the generic route before any
// launch.
//
// Replaces, for those operands, the TPU kernels of
// dalle_tpu/ops/pallas/geglu_kernels.py: _ff_fwd (_ff_fwd_kernel, :126) and
// _ff_bwd_tensors (_ff_bwd_kernel, :153), whose Pallas bodies take f32 too.
//
// Math, with the cast points of geglu_ff_plain and geglu_ff_bwd_plain
// (ops/geglu.py): h = x.Wi + bi and g = x.Wg + bg in f32; forward hg =
// (h * gelu(g)) rounded once to the operand dtype and stored, then out =
// bo + hg.Wo rounded once; backward dhg = dO.Wo^T and, each rounded once to
// the operand dtype, dh = dhg * gelu(g), dg = dhg * h * gelu'(g), hg =
// h * gelu(g). The tanh-gelu and its derivative are the plain versions'
// formulas in the same operation order. Fixed order, no atomics, no split
// of the depth: two runs give identical bits.
//
// Precision: bf16 products are exact in the tensor cores' f32 accumulator.
// f32 products run as 3xTF32, within the f32 tolerances of the f32
// product: each operand is split in registers into hi = a rounded to TF32
// (nearest, ties away from zero, as cvt.rna.tf32.f32 rounds) and lo =
// a - hi truncated to TF32 (as CUTLASS's 3xTF32 cuts it; a raw f32 handed
// to a TF32 mma would be truncated too), and the sum takes lo.hi + hi.lo,
// then hi.hi (lo.lo is dropped). The tensor cores round each mma's f32
// sum toward zero, so a sum carried through d / 8 of them drifts (3.5e-5
// at M = 320, d = 256, K = 1024 on an H100, against the 1e-5 limit): each
// stage's products go into a fresh partial, added to the accumulator by
// an f32 add that rounds to nearest. On the CPU
// (tests/test_torch_geglu_tf32.py, with ops/geglu.py's split_tf32) the
// forward at M = 256, d = 1024, K = 4096 built from 3xTF32 products stays
// within 1e-5 of the f32 one, where one TF32 pass misses 1e-4.
//
// What bounds it: 6.M.d.K operations against a few operand bytes, far above
// the card's ridge: the tensor cores, at 989 TFLOP/s for bf16 and 495 / 3
// TFLOP/s for f32 in three TF32 passes (an H100 SXM). On an H100 80GB HBM3
// at 700 W, M = 5120, d = 1024, K = 4096 (chip_smoke.py phase 10, PERF.md):
// f32 2.23 / 2.39 ms forward / backward against 0.78 ms bounds and cuBLAS's
// f32 products' 2.58 / 2.56; bf16 0.56 / 0.72 ms against 0.13. The split's
// integer rounding keeps the f32 loop within its issue slots (ptxas expands
// cvt.rna.tf32.f32 into about five instructions).
//
// Design: one tensor-core GEMM template (gemm_body) on mma.sync: bf16 as
// m16n8k16 fed by ldmatrix, f32 as m16n8k8 TF32 in three passes. wgmma is
// not used: its TF32 form reads A and B only K-major from shared memory,
// while Wi, Wg and (in the forward) Wo are stored MN-major (its transpose
// flag exists for 16-bit types alone). A block of 8 warps computes a
// BM x BN output tile for NACC products at once, each into its own
// accumulators: the gate's two share the x tile (GateEpi), the backward's
// three take x for h and g and dO for dhg (BwdEpi). Shared memory is fed
// by a ring of STAGES cp.async stages (16-byte copies); the ragged edge (M
// any; d and K multiples of 8) is a copy of source size 0, which
// zero-fills, so the main loop does not branch on it. Rows are padded
// (k-contiguous tiles by 16 bytes, n-contiguous tiles by 8 elements) so
// that every ldmatrix and every 32-bit fragment load hits 32 different
// banks. Tiles (FwdTiles, BwdTiles): 128 x 128 (bf16) or 128 x 64 (f32)
// for the gate and the output, 128 x 64 for the backward, with warps of
// 32 x 32 wherever three accumulators or the f32 partials must fit
// without spills. The epilogue functors write each element from the
// accumulator registers, masked at every edge: bi and bg are read only for
// columns below K, and the padded columns of hg are never stored (the
// output GEMM zero-fills its reads past K).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <math.h>
#include <type_traits>

#include "mma_sync.cuh"

using namespace tc;  // conversions, cp.async, ldmatrix, mma.sync, split

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr float GELU_C = 0.044715f;
constexpr float SQRT_2_OVER_PI = 0.7978845608028654f;
// 3.0 * GELU_C as the plain version forms it (in double, then used in f32)
constexpr float GELU_3C = (float)(3.0 * 0.044715);

enum { DTYPE_F32 = 0, DTYPE_BF16 = 1 };  // mirrored by ops/geglu.py

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

// ---------------------------------------------------------------------------
// the GEMM template
// ---------------------------------------------------------------------------

// A BM x BN block tile of 8 warps, each WM x WN, depth BK a stage, STAGES
// stages in the ring. k-contiguous tiles (A rows, B^T rows) are padded by 16
// bytes a row, n-contiguous tiles (B rows) by 8 elements.
template <typename T, int BM_, int BN_, int WM_, int WN_, int STAGES_,
          int BK_>
struct Tiles {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int BK = BK_, STAGES = STAGES_;
  static constexpr int WARPS_N = BN / WN;
  static constexpr int MT = WM / 16, NT = WN / 8;  // mma tiles a warp
  static constexpr int E = 16 / (int)sizeof(T);    // elements a 16-byte copy
  static constexpr int LDK = BK + E;               // k-contiguous row stride
  static constexpr int LDN = BN + 8;               // n-contiguous row stride
  static constexpr int A_TILE = BM * LDK;          // elements
  static constexpr int BT_TILE = BN * LDK;
  static constexpr int B_TILE = BK * LDN;
  static_assert((BM / WM) * (BN / WN) * 32 == THREADS, "8 warps a block");
  static_assert(NT % 2 == 0, "n tiles go in pairs");
  static_assert(BM * BK / E % THREADS == 0 && BN * BK / E % THREADS == 0,
                "every thread copies the same number of chunks");
};

// Copies rows r0.. of a k-contiguous (rows, Kd) row-major operand, depth
// k0..k0+BK, into a tile of `rows` rows of stride LDK; rows at or past
// `rows_end` and depth at or past Kd are zeros.
template <typename T, class C, int ROWS>
__device__ __forceinline__ void copy_k_tile(T* dst, const T* src, int r0,
                                            int rows_end, int k0, int Kd) {
  constexpr int CPR = C::BK / C::E;  // 16-byte chunks a row
#pragma unroll
  for (int i = 0; i < ROWS * CPR / THREADS; ++i) {
    const int chunk = threadIdx.x + i * THREADS;
    const int r = chunk / CPR, c = chunk % CPR;
    const int gr = r0 + r, gk = k0 + c * C::E;
    const bool ok = gr < rows_end && gk < Kd;
    cp_async16(dst + r * C::LDK + c * C::E,
               ok ? src + (long long)gr * Kd + gk : src, ok);
  }
}

// Copies depth rows k0..k0+BK, columns n0..n0+BN of an n-contiguous (Kd, N)
// row-major operand into a tile of stride LDN; zeros past Kd and N.
template <typename T, class C>
__device__ __forceinline__ void copy_n_tile(T* dst, const T* src, int k0,
                                            int Kd, int n0, int N) {
  constexpr int CPR = C::BN / C::E;
#pragma unroll
  for (int i = 0; i < C::BK * CPR / THREADS; ++i) {
    const int chunk = threadIdx.x + i * THREADS;
    const int r = chunk / CPR, c = chunk % CPR;
    const int gk = k0 + r, gn = n0 + c * C::E;
    const bool ok = gk < Kd && gn < N;
    cp_async16(dst + r * C::LDN + c * C::E,
               ok ? src + (long long)gk * N + gn : src, ok);
  }
}

// Elements of one ring stage: the NA A tiles, then the NB B tiles.
template <class Epi, class C>
__host__ __device__ constexpr int stage_elems() {
  int n = Epi::NA * C::A_TILE;
  for (int b = 0; b < Epi::NB; ++b)
    n += Epi::b_nk(b) ? C::BT_TILE : C::B_TILE;
  return n;
}

template <class Epi, class C>
__host__ __device__ constexpr int b_offset(int b) {
  int n = Epi::NA * C::A_TILE;
  for (int i = 0; i < b; ++i) n += Epi::b_nk(i) ? C::BT_TILE : C::B_TILE;
  return n;
}

template <typename T, class Epi, class C>
__device__ __forceinline__ void load_stage(T* st, const Epi& e, int m0,
                                           int n0, int k0) {
#pragma unroll
  for (int a = 0; a < Epi::NA; ++a)
    copy_k_tile<T, C, C::BM>(st + a * C::A_TILE, e.a_ptr(a), m0, e.M, k0,
                             e.Kd);
#pragma unroll
  for (int b = 0; b < Epi::NB; ++b) {
    T* dst = st + b_offset<Epi, C>(b);
    if (Epi::b_nk(b))
      copy_k_tile<T, C, C::BN>(dst, e.b_ptr(b), n0, e.N, k0, e.Kd);
    else
      copy_n_tile<T, C>(dst, e.b_ptr(b), k0, e.Kd, n0, e.N);
  }
}

// acc[p] += A_a . B_b over one stage (depth BK), bf16: m16n8k16 from
// ldmatrix fragments. wm0, wn0: the warp's tile in the block tile.
template <class Epi, class C>
__device__ __forceinline__ void stage_math(
    const bf16* st, float (&acc)[Epi::NACC][C::MT][C::NT][4], int wm0,
    int wn0, int lane) {
  const int q = lane >> 3;  // which 8x8 matrix this lane addresses
#pragma unroll
  for (int kk = 0; kk < C::BK; kk += 16) {
#pragma unroll
    for (int a = 0; a < Epi::NA; ++a) {
      const bf16* ta = st + a * C::A_TILE;
      uint32_t af[C::MT][4];
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt)
        ldsm_x4(af[mt], ta + (wm0 + 16 * mt + (lane & 15)) * C::LDK + kk +
                            (lane >> 4) * 8);
#pragma unroll
      for (int p = 0; p < Epi::NACC; ++p) {
        if (Epi::a_of(p) != a) continue;
        const int b = Epi::b_of(p);
        const bf16* tb = st + b_offset<Epi, C>(b);
#pragma unroll
        for (int j = 0; j < C::NT / 2; ++j) {
          uint32_t bf[4];  // b0, b1 of n tile 2j, then of 2j + 1
          if (Epi::b_nk(b))
            ldsm_x4(bf, tb + (wn0 + 16 * j + (lane & 7) + ((q >> 1) << 3)) *
                                 C::LDK + kk + (q & 1) * 8);
          else
            ldsm_x4_t(bf, tb + (kk + (lane & 7) + ((q & 1) << 3)) * C::LDN +
                                  wn0 + 16 * j + (q >> 1) * 8);
#pragma unroll
          for (int mt = 0; mt < C::MT; ++mt) {
            mma_bf16(acc[p][mt][2 * j], af[mt], bf[0], bf[1]);
            mma_bf16(acc[p][mt][2 * j + 1], af[mt], bf[2], bf[3]);
          }
        }
      }
    }
  }
}

// The same for f32: m16n8k8 TF32 in three passes on the hi/lo split of
// every fragment. A and B^T fragments come from ldmatrix (an 8x8 b16
// matrix is an 8x4 f32 one); n-contiguous B fragments from 32-bit loads.
// The tensor cores add into their f32 accumulator rounding toward zero, so
// a sum carried through all d / 8 products drifts (3.5e-5 at d = 256 on an
// H100); each product of the stage sums into a fresh partial, added to its
// accumulator by an f32 add that rounds to nearest. The A fragments are
// loaded again for each product that shares them.
template <class Epi, class C>
__device__ __forceinline__ void stage_math(
    const float* st, float (&acc)[Epi::NACC][C::MT][C::NT][4], int wm0,
    int wn0, int lane) {
  const int q = lane >> 3, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int p = 0; p < Epi::NACC; ++p) {
    const float* ta = st + Epi::a_of(p) * C::A_TILE;
    const int b = Epi::b_of(p);
    const float* tb = st + b_offset<Epi, C>(b);
    float part[C::MT][C::NT][4];
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C::BK; kk += 8) {
      uint32_t ahi[C::MT][4], alo[C::MT][4];
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt) {
        uint32_t raw[4];
        ldsm_x4(raw, ta + (wm0 + 16 * mt + (lane & 15)) * C::LDK + kk +
                         (lane >> 4) * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(raw[i], ahi[mt][i], alo[mt][i]);
      }
#pragma unroll
      for (int j = 0; j < C::NT / 2; ++j) {
        uint32_t raw[4];  // b0, b1 of n tile 2j, then of 2j + 1
        if (Epi::b_nk(b)) {
          ldsm_x4(raw, tb + (wn0 + 16 * j + (lane & 7) + ((q >> 1) << 3)) *
                                C::LDK + kk + (q & 1) * 4);
        } else {
          const float* col = tb + (kk + t) * C::LDN + wn0 + 16 * j + g;
          raw[0] = __float_as_uint(col[0]);
          raw[1] = __float_as_uint(col[4 * C::LDN]);
          raw[2] = __float_as_uint(col[8]);
          raw[3] = __float_as_uint(col[4 * C::LDN + 8]);
        }
        uint32_t bhi[4], blo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(raw[i], bhi[i], blo[i]);
#pragma unroll
        for (int mt = 0; mt < C::MT; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float(&c)[4] = part[mt][2 * j + h];
            mma_tf32(c, alo[mt], bhi[2 * h], bhi[2 * h + 1]);
            mma_tf32(c, ahi[mt], blo[2 * h], blo[2 * h + 1]);
            mma_tf32(c, ahi[mt], bhi[2 * h], bhi[2 * h + 1]);
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[p][mt][nt][i] += part[mt][nt][i];
  }
}

// One block: the BM x BN output tile at (blockIdx.y, blockIdx.x) of every
// product of Epi, then Epi::store on each element inside (M, N).
template <typename T, class Epi, class C>
__device__ __forceinline__ void gemm_body(const Epi& e) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  constexpr int STAGE = stage_elems<Epi, C>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm0 = (warp / C::WARPS_N) * C::WM;
  const int wn0 = (warp % C::WARPS_N) * C::WN;
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  const int ktiles = (e.Kd + C::BK - 1) / C::BK;

  float acc[Epi::NACC][C::MT][C::NT][4];
#pragma unroll
  for (int p = 0; p < Epi::NACC; ++p)
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[p][mt][nt][i] = 0.f;

  // the ring: tile kt lives in stage kt % STAGES; one group committed a
  // tile, empty past the last, so that wait<STAGES - 2> always means
  // "tile kt has landed"
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < ktiles) load_stage<T, Epi, C>(smem + s * STAGE, e, m0, n0, s * C::BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<C::STAGES - 2>();
    // tile kt is visible to every thread, and every thread is done with
    // tile kt - 1, whose stage the next copy overwrites
    __syncthreads();
    const int next = kt + C::STAGES - 1;
    if (next < ktiles)
      load_stage<T, Epi, C>(smem + (next % C::STAGES) * STAGE, e, m0, n0,
                            next * C::BK);
    cp_async_commit();
    stage_math<Epi, C>(smem + (kt % C::STAGES) * STAGE, acc, wm0, wn0, lane);
  }

  // accumulator (mt, nt) holds rows g and g + 8, columns 2t and 2t + 1 of
  // its 16 x 8 tile
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = m0 + wm0 + 16 * mt + g + 8 * (i >> 1);
        const int c = n0 + wn0 + 8 * nt + 2 * t + (i & 1);
        if (r < e.M && c < e.N) {
          float v[Epi::NACC];
#pragma unroll
          for (int p = 0; p < Epi::NACC; ++p) v[p] = acc[p][mt][nt][i];
          e.store(r, c, v);
        }
      }
}

// ---------------------------------------------------------------------------
// the three epilogues
// ---------------------------------------------------------------------------

// Each names its products: NA A operands (M, Kd) row-major, NB B operands,
// (Kd, N) row-major or, where b_nk, stored transposed as (N, Kd) row-major;
// product p is A_{a_of(p)} . B_{b_of(p)}.

// hg (M, K) = (x.Wi + bi) * gelu(x.Wg + bg), in T.
template <typename T>
struct GateEpi {
  static constexpr int NACC = 2, NA = 1, NB = 2;
  __host__ __device__ static constexpr int a_of(int) { return 0; }
  __host__ __device__ static constexpr int b_of(int p) { return p; }
  __host__ __device__ static constexpr bool b_nk(int) { return false; }
  const T *x, *wi, *wg, *bi, *bg;
  T* hg;
  int M, N, Kd;  // N = K, Kd = d
  __device__ const T* a_ptr(int) const { return x; }
  __device__ const T* b_ptr(int b) const { return b ? wg : wi; }
  __device__ void store(int r, int c, const float (&v)[NACC]) const {
    const float h = v[0] + to_f(bi[c]), g = v[1] + to_f(bg[c]);
    hg[(long long)r * N + c] = from_f<T>(h * gelu_tanh(g));
  }
};

// out (M, d) = bo + hg.Wo, in T.
template <typename T>
struct OutEpi {
  static constexpr int NACC = 1, NA = 1, NB = 1;
  __host__ __device__ static constexpr int a_of(int) { return 0; }
  __host__ __device__ static constexpr int b_of(int) { return 0; }
  __host__ __device__ static constexpr bool b_nk(int) { return false; }
  const T *hg, *wo, *bo;
  T* out;
  int M, N, Kd;  // N = d, Kd = K
  __device__ const T* a_ptr(int) const { return hg; }
  __device__ const T* b_ptr(int) const { return wo; }
  __device__ void store(int r, int c, const float (&v)[NACC]) const {
    out[(long long)r * N + c] = from_f<T>(to_f(bo[c]) + v[0]);
  }
};

// dhdg (M, 2K) = [dhg * gelu(g) | dhg * h * gelu'(g)] and hg (M, K) =
// h * gelu(g), in T, with dhg = dO.Wo^T: products h = x.Wi, g = x.Wg and
// dhg = dO.Wo^T (Wo (K, d) is B^T, (N, Kd)).
template <typename T>
struct BwdEpi {
  static constexpr int NACC = 3, NA = 2, NB = 3;
  __host__ __device__ static constexpr int a_of(int p) { return p == 2; }
  __host__ __device__ static constexpr int b_of(int p) { return p; }
  __host__ __device__ static constexpr bool b_nk(int b) { return b == 2; }
  const T *x, *wi, *wg, *wo, *bi, *bg, *dout;
  T *dhdg, *hg;
  int M, N, Kd;  // N = K, Kd = d
  __device__ const T* a_ptr(int a) const { return a ? dout : x; }
  __device__ const T* b_ptr(int b) const {
    return b == 2 ? wo : (b ? wg : wi);
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

// The tiles of each instance (chosen on an H100 among 128 x 64 and 64 x 128
// backward tiles, depth 32 or 64, 2-4 stages, one or two blocks an SM). f32
// keeps a partial beside each accumulator tile, so its forward takes 32 x 32
// warps too; bf16 stages are 64 deep.
template <typename T>
using FwdTiles = typename std::conditional<
    sizeof(T) == 4, Tiles<T, 128, 64, 32, 32, 4, 32>,
    Tiles<T, 128, 128, 64, 32, 3, 64>>::type;
template <typename T>
using BwdTiles = typename std::conditional<
    sizeof(T) == 4, Tiles<T, 128, 64, 32, 32, 3, 32>,
    Tiles<T, 128, 64, 32, 32, 3, 64>>::type;

}  // namespace

// The six instances, one kernel each, under names a profiler and ptxas show.
#define GENERIC_KERNEL(NAME, T, EPI, TILES)                             \
  __global__ void __launch_bounds__(THREADS, 1) NAME(const EPI<T> e) { \
    gemm_body<T, EPI<T>, TILES<T>>(e);                                 \
  }
GENERIC_KERNEL(geglu_generic_gate_f32, float, GateEpi, FwdTiles)
GENERIC_KERNEL(geglu_generic_out_f32, float, OutEpi, FwdTiles)
GENERIC_KERNEL(geglu_generic_bwd_f32, float, BwdEpi, BwdTiles)
GENERIC_KERNEL(geglu_generic_gate_bf16, bf16, GateEpi, FwdTiles)
GENERIC_KERNEL(geglu_generic_out_bf16, bf16, OutEpi, FwdTiles)
GENERIC_KERNEL(geglu_generic_bwd_bf16, bf16, BwdEpi, BwdTiles)
#undef GENERIC_KERNEL

namespace {

// The kernel of each epilogue and dtype.
auto kernel_for(const GateEpi<float>&) { return geglu_generic_gate_f32; }
auto kernel_for(const OutEpi<float>&) { return geglu_generic_out_f32; }
auto kernel_for(const BwdEpi<float>&) { return geglu_generic_bwd_f32; }
auto kernel_for(const GateEpi<bf16>&) { return geglu_generic_gate_bf16; }
auto kernel_for(const OutEpi<bf16>&) { return geglu_generic_out_bf16; }
auto kernel_for(const BwdEpi<bf16>&) { return geglu_generic_bwd_bf16; }

template <typename T, class C, class Epi>
int launch(const Epi& e, cudaStream_t s) {
  constexpr int smem = C::STAGES * stage_elems<Epi, C>() * (int)sizeof(T);
  const auto kernel = kernel_for(e);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((e.N + C::BN - 1) / C::BN, (e.M + C::BM - 1) / C::BM);
  kernel<<<grid, THREADS, smem, s>>>(e);
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
  const int err = launch<T, FwdTiles<T>>(gate, s);
  if (err != 0) return err;
  const OutEpi<T> outp{static_cast<const T*>(hg), static_cast<const T*>(wo),
                       static_cast<const T*>(bo), static_cast<T*>(out),
                       m, d, k};
  return launch<T, FwdTiles<T>>(outp, s);
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
  return launch<T, BwdTiles<T>>(e, s);
}

}  // namespace

// x (M, d); Wi/Wg (d, K); Wo (K, d); bi/bg (K,); bo (d,); hg (M, K) scratch;
// out (M, d); all contiguous, 16-byte aligned, of one dtype (DTYPE_F32 or
// DTYPE_BF16); d and K multiples of 8.
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
