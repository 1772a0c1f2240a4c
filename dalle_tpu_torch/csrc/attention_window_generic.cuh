// Generic forward and backward attention on the tensor cores, for the
// operands the fast kernels (attention_fwd.cu, attention_bwd.cu: bf16 with
// head_dim 64) do not take: f32 at head_dim 16, 32, 64 or 128, and bf16 at
// 16, 32 or 128. ops/attention.py's attention_route picks the route; every
// generic call, line or window, launches these kernels.
//
// Replaces, for those operands, the TPU kernels of
// dalle_tpu/ops/pallas/attention_kernels.py: _line_attention_fwd (:227) and
// _line_attention_bwd (:259), POLICY_LINE ([prefix || causal line]: the
// text-causal call, axial_row, and axial_col with `transpose`), and
// _window_attention_fwd (:518) and _window_attention_bwd (:548),
// POLICY_CONV (conv_like, hw = conv_kernel / 2) and POLICY_FULL (hw =
// None). The kernels are templated on the policy, which sets the key
// ranges, the tile skips and the masks (the section "key and query ranges"
// below and attention_common.cuh's Pos arithmetic).
//
// Math, with the cast points of the plain versions (ops/attention.py):
// scores s = (q . k) * d^-1/2 in f32, masked scores -1e9; forward: the
// softmax online over key tiles in f32, P cast to the operand dtype before
// P.V (a no-op in f32), the division by the f32 denominator at the end, lse
// = m + log(denominator) in raster order; backward: P = exp(s - lse) in
// f32, dd = rowsum(dO . O), dS = P (dP - dd) cast to the operand dtype
// before its products, dq = (dS . k) * scale over the prefix and the main
// keys, dk = (dS^T . q) * scale, dv = P^T . dO with P in f32 (bf16: P = hi
// + lo, both bf16, as attention_bwd.cu takes it).
//
// Lines. Main tokens are walked in packed order, lines contiguous: a
// packed row j sits at raster row raster_of(j), so an axial_col line (a
// raster column) is gathered row by row and out, dq, dk, dv, lse and dd
// are written back in raster order. A text call is one line of T tokens
// (grid 0, no prefix, T any length). Lines shorter than a warp's 16 rows
// (n need not divide 16) put several lines in one warp's rows: a tile is
// skipped only when no row of the warp reaches it, and is taken without a
// mask only when every row reaches every key, which a warp whose rows
// cross a line edge never does (the main keys start at the line of the
// block's first row, so a block reads at most its own lines).
//
// Design: FA2's layout on mma.sync, as in attention_fwd.cu and
// attention_bwd.cu. A block of 4 warps owns 64 rows (queries; keys in the
// dk/dv passes), 16 a warp, and streams tiles of the other side through a
// 2-stage cp.async ring. The forward keeps S, the online softmax's max and
// sum (reduced over the 4 lanes that hold a row) and the O accumulator in
// registers for the whole key walk, and turns S's accumulators in place
// into the A fragments of P.V. The backward takes attention_bwd.cu's three
// passes, with no atomics and a fixed order (two runs give the same bits):
// a query-major dq pass that also writes dd, a key-major dk/dv pass, and
// with a prefix the prefix's dk/dv as 4-block clusters that sum their
// partials in rank order through distributed shared memory. A warp skips
// any tile that none of its rows can reach (warp-uniform), and masks only
// tiles that cross an edge, with attention_common.cuh's stepped Pos
// arithmetic (one division a tile, not one a score).
//
// Precision. bf16: m16n8k16 from ldmatrix, exact products in an f32
// accumulator. f32: m16n8k8 TF32 in three passes on the 3xTF32 split of
// mma_sync.cuh (lo.hi + hi.lo, then hi.hi). The tensor cores round each
// mma's f32 sum toward zero, so a long chain drifts (geglu_generic.cu):
// every product of a tile goes into a fresh partial that an f32 add, which
// rounds to nearest, folds in (after the online rescale in the forward);
// no chain is deeper than 64 (S at D = 128 is two partials of 64; P.V, dS.K,
// P^T.dO and dS^T.Q are 64 or 16 deep). The accumulator A operands (P, dS)
// need no shuffle: an n8 accumulator tile holds columns 2t and 2t + 1 of
// lane t, and the TF32 A fragment takes depth t and t + 4, so the depth of
// those products is walked in the permuted order 0, 2, 4, 6, 1, 3, 5, 7
// (the f32 b_frag reads the B rows in the same order).
//
// The split is made per fragment, in registers, as each fragment is loaded
// (K, V, Q, dO from shared memory; P and dS from the accumulators), as
// geglu_generic.cu makes it. Staging hi and lo tiles in shared memory once
// a tile (shared by the 4 warps) would cut the split's instructions by 4
// but double every ldmatrix and the tiles' shared memory; with 16 rows a
// warp the fragment loads, not the split, would then bound the loop, and
// the f32 D = 64 backward would drop to one block an SM.
//
// Shared memory (row strides padded so that every ldmatrix and every
// 32-bit fragment load hits 32 banks: D + 4 floats, D + 8 bf16): the
// block's 64 rows, then 2 stages of streamed tiles of BN rows, BN = 64
// except f32 at D = 128 (32). Forward Q + 2 x (K, V); backward 2 own tiles
// + 2 x 2 streamed ones + lse and dd. f32 D = 64: 87,040 B forward,
// 105,472 B backward (two blocks an SM); f32 D = 128: 101,376 / 136,192;
// bf16 D = 128: 87,040 / 105,472.
//
// What bounds it: at the flagship's widths in f32 (B 4, 16 heads of 64, a
// 32 x 32 grid after a 256-token prefix, hw 5) the window forward does 5.2
// GFLOP of used pairs (31.2 us at 495 / 3 TFLOP/s for three TF32 passes)
// for a few MB: the tensor cores and the instructions around them (the
// split, the masks, exp), not memory. On an H100 80GB HBM3 at 700 W
// (chip_smoke.py phase 10, PERF.md) the window forward takes 256 us and
// its backward 845 us there, 0.33x / 0.49x SDPA's f32 calls and 12% / 9%
// of the 3xTF32 bound; one axial_row layer's line calls (the text call and
// the image call) take 163 / 690 us, 0.17x / 0.32x SDPA's and 19% / 11% of
// their bound. The SIMT kernels they replace took 1079 / 2960 us (window)
// and 819 / 2307 us (line).
//
// Why not wgmma: its TF32 form reads B only K-major from shared memory; V,
// contracted over keys in P.V, is MN-major, and the transpose flag exists
// for 16-bit types alone, so P.V would need a transposing copy of V.
//
// Operands: (B, H, T, d) with any element strides for b, h, t and unit
// stride along d. Rows that do not start on 16 bytes are copied 8, 4 or
// (bf16) 2 bytes at a time: the wrapper passes the widest copy that every
// operand row starts on (`vec`). Outputs are the wrapper's own, 16-byte
// aligned.
//
// Sources: this header holds the kernels. Each (dtype, head_dim) instance
// has two sources, each a library with the same C entry points:
// attention_window_generic_<dtype>_d<head_dim>.cu (WIN_INSTANCE: conv and
// full) and attention_line_generic_<dtype>_d<head_dim>.cu (LINE_INSTANCE),
// so that the build's parallel nvcc calls share the work. On the card's
// host (8 cores, every source at once) the instance sources took 31-48 s
// with the window policies alone and 35-63 s with all three in one source
// (the whole build 47.8 s then 62.9 s; all seven window instances in one
// source took 60-90 s in an earlier build).

#pragma once

#include <cooperative_groups.h>

#include "attention_common.cuh"
#include "mma_sync.cuh"

namespace cg = cooperative_groups;
using namespace tc;
using attn::Geo;
using attn::NEG_FILL;
using attn::POLICY_CONV;
using attn::POLICY_FULL;
using attn::POLICY_LINE;
using attn::Pos;
using attn::allowed;
using attn::pos_of;
using attn::raster_of;
using attn::step;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;  // rows a block owns
constexpr int CLUSTER = 4;      // blocks a prefix key tile
constexpr unsigned FULL_MASK = 0xffffffffu;

enum { DTYPE_F32 = 0, DTYPE_BF16 = 1 };  // mirrored by ops/attention.py

template <typename T, int D>
struct Cfg {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int LD = D + (F32 ? 4 : 8);            // tile row stride
  static constexpr int BN = (F32 && D == 128) ? 32 : 64;  // streamed rows
  static constexpr int NT = D / 8;                        // n8 tiles over d
  static constexpr int OWN = BQ * LD;                     // elements
  static constexpr int STREAM = BN * LD;
  static constexpr int FWD_SMEM = (OWN + 4 * STREAM) * (int)sizeof(T);
  static constexpr int BWD_SMEM =
      (2 * OWN + 4 * STREAM) * (int)sizeof(T) + 4 * 64 * (int)sizeof(float);
  static_assert(2 * BQ * D * sizeof(float) <= (size_t)BWD_SMEM,
                "the prefix partials fit in a block's shared memory");
};

// x rounded to T and back: the plain versions' casts to the operand dtype.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

template <typename T>
__device__ __forceinline__ T* at(const void* p, const long long* s, int b,
                                 int h) {
  return const_cast<T*>(static_cast<const T*>(p)) + b * s[0] + h * s[1];
}

// ---------------------------------------------------------------------------
// key and query ranges of the policies (packed main-token indices)
// ---------------------------------------------------------------------------

// The first main key that queries from q0 on can reach.
template <int POLICY>
__device__ __forceinline__ int keys_from(const Geo& g, int q0) {
  if (POLICY == POLICY_LINE) return q0 / g.n * g.n;
  if (POLICY == POLICY_CONV) return max(0, q0 / g.grid - g.hw) * g.grid;
  return 0;
}

// One past the last main query that keys before k1 can be reached by.
template <int POLICY>
__device__ __forceinline__ int queries_to(const Geo& g, int k1, int T) {
  if (POLICY == POLICY_LINE) return min(T, ((k1 - 1) / g.n + 1) * g.n);
  if (POLICY == POLICY_CONV)
    return min(T, ((k1 - 1) / g.grid + g.hw + 1) * g.grid);
  return T;
}

// Whether some query of [w0, wl] may attend to some main key of [k0, ke);
// `full`: whether every one may (no mask needed).
template <int POLICY>
__device__ __forceinline__ bool reaches(const Geo& g, int w0, int wl, int k0,
                                        int ke, bool& full) {
  bool reach = k0 <= wl;
  full = ke - 1 <= w0;
  if (POLICY == POLICY_LINE) {
    reach = reach && ke - 1 >= w0 - w0 % g.n;
    full = full && k0 >= wl - wl % g.n;
  }
  if (POLICY == POLICY_CONV) {
    reach = reach && (ke - 1) / g.grid >= w0 / g.grid - g.hw;
    full = false;
  }
  return reach;
}

// ---------------------------------------------------------------------------
// copies into shared memory
// ---------------------------------------------------------------------------

// ROWS rows j0.. of a (.., T, D) operand into a tile of row stride LD, V
// bytes a copy; rows at or past j_end are zeros. Packed rows (main tokens)
// sit at raster row raster_of(j), prefix rows at j.
template <typename T, int D, int ROWS, int V>
__device__ __forceinline__ void copy_rows(T* tile, const T* base, long long st,
                                          const Geo& g, int j0, int j_end,
                                          bool packed) {
  constexpr int LD = Cfg<T, D>::LD;
  constexpr int E = V / (int)sizeof(T);  // elements a copy
  constexpr int CPR = D / E;             // copies a row
  static_assert(ROWS * CPR % THREADS == 0, "every thread copies as many");
#pragma unroll 4
  for (int i = 0; i < ROWS * CPR / THREADS; ++i) {
    const int c = threadIdx.x + i * THREADS;
    const int r = c / CPR, ch = c - r * CPR;
    const int j = j0 + r;
    const bool ok = j < j_end;
    const long long t = ok ? (packed ? raster_of(g, j) : j) : 0;
    T* dst = tile + r * LD + ch * E;
    const T* src = base + t * st + ch * E;
    if constexpr (V == 16) {
      cp_async16(dst, src, ok);
    } else if constexpr (V >= 4) {
      cp_async_ca<V>(dst, src, ok);
    } else {
      *dst = ok ? *src : from_f<T>(0.f);
    }
  }
}

// The same, `vec` bytes a copy (16, 8, 4 or, for bf16, 2: the widest that
// every row of the operands starts on).
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(T* tile, const T* base, long long st,
                                          const Geo& g, int j0, int j_end,
                                          bool packed, int vec) {
  if (vec >= 16) {
    copy_rows<T, D, ROWS, 16>(tile, base, st, g, j0, j_end, packed);
  } else if (vec >= 8) {
    copy_rows<T, D, ROWS, 8>(tile, base, st, g, j0, j_end, packed);
  } else if constexpr (sizeof(T) == 4) {
    copy_rows<T, D, ROWS, 4>(tile, base, st, g, j0, j_end, packed);
  } else {
    if (vec >= 4)
      copy_rows<T, D, ROWS, 4>(tile, base, st, g, j0, j_end, packed);
    else
      copy_rows<T, D, ROWS, 2>(tile, base, st, g, j0, j_end, packed);
  }
}

// N f32 of a raster-order row vector (lse, dd) for packed rows j0..j0+N-1
// (zeros at or past j_end).
template <int N>
__device__ __forceinline__ void load_vec(float* dst, const float* base,
                                         const Geo& g, int j0, int j_end) {
  if (threadIdx.x < N) {
    const int j = j0 + threadIdx.x;
    const bool ok = j < j_end;
    cp_async_ca<4>(dst + threadIdx.x, base + (ok ? raster_of(g, j) : 0), ok);
  }
}

// ---------------------------------------------------------------------------
// fragments and products
// ---------------------------------------------------------------------------

__device__ __forceinline__ void split4(const uint32_t (&raw)[4],
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(raw[i], hi[i], lo[i]);
}

// f32: the split A fragment of rows r0..r0+15, depth k0..k0+7 of a
// row-major tile (an 8x8 b16 matrix of ldmatrix is an 8x4 f32 one).
template <int LD>
__device__ __forceinline__ void a_frag(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                       const float* tile, int r0, int k0,
                                       int lane) {
  uint32_t raw[4];
  ldsm_x4(raw, tile + (r0 + (lane & 15)) * LD + k0 + (lane >> 4) * 4);
  split4(raw, hi, lo);
}

// f32: the split B fragments of the n8 tiles rows n0..n0+7 and n0+8..n0+15
// of a tile stored [n][k] (B^T row-major), depth k0..k0+7: [0..1] serve the
// first, [2..3] the second.
template <int LD>
__device__ __forceinline__ void bt_frag(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                        const float* tile, int n0, int k0,
                                        int lane) {
  const int q = lane >> 3;
  uint32_t raw[4];
  ldsm_x4(raw, tile + (n0 + (lane & 7) + ((q >> 1) << 3)) * LD + k0 +
                   (q & 1) * 4);
  split4(raw, hi, lo);
}

// f32: the split B fragment of the n8 tile columns n0..n0+7 of a tile
// stored [k][n], depth rows k0..k0+7 in the permuted order of acc_frag
// (depth t is row 2t, depth t + 4 row 2t + 1).
template <int LD>
__device__ __forceinline__ void b_frag(uint32_t (&hi)[2], uint32_t (&lo)[2],
                                       const float* tile, int k0, int n0,
                                       int lane) {
  const float* p = tile + (k0 + 2 * (lane & 3)) * LD + n0 + (lane >> 2);
  split_tf32(__float_as_uint(p[0]), hi[0], lo[0]);
  split_tf32(__float_as_uint(p[LD]), hi[1], lo[1]);
}

// f32: the split A fragment over the 8 columns of one n8 accumulator tile
// (c: (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)), depth permuted.
__device__ __forceinline__ void acc_frag(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                         const float (&c)[4]) {
  const uint32_t raw[4] = {__float_as_uint(c[0]), __float_as_uint(c[2]),
                           __float_as_uint(c[1]), __float_as_uint(c[3])};
  split4(raw, hi, lo);
}

// c += A.B in three TF32 passes: lo.hi, hi.lo, then hi.hi.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma_tf32(c, alo, bh0, bh1);
  mma_tf32(c, ahi, bl0, bl1);
  mma_tf32(c, ahi, bh0, bh1);
}

// bf16: the A fragment of rows r0..r0+15, depth k0..k0+15.
template <int LD>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const bf16* tile,
                                       int r0, int k0, int lane) {
  ldsm_x4(a, tile + (r0 + (lane & 15)) * LD + k0 + (lane >> 4) * 8);
}

// bf16: B fragments of the n8 tiles rows n0..n0+15 of a [n][k] tile.
template <int LD>
__device__ __forceinline__ void bt_frag(uint32_t (&b)[4], const bf16* tile,
                                        int n0, int k0, int lane) {
  const int m = lane >> 3;
  ldsm_x4(b, tile + (n0 + (lane & 7) + ((m >> 1) << 3)) * LD + k0 +
                 (m & 1) * 8);
}

// bf16: B fragments of the n8 tiles columns n0..n0+15 of a [k][n] tile,
// depth rows k0..k0+15, transposed by ldmatrix.
template <int LD>
__device__ __forceinline__ void b_frag(uint32_t (&b)[4], const bf16* tile,
                                       int k0, int n0, int lane) {
  const int m = lane >> 3;
  ldsm_x4_t(b, tile + (k0 + (lane & 7) + ((m & 1) << 3)) * LD + n0 +
                   (m >> 1) * 8);
}

// s (NK / 8 n8 tiles) = A . B^T: rows r0..r0+15 of the row-major tile `at`
// against rows n0..n0+NK-1 of the row-major tile `bt`, over all D. f32:
// each 64 of depth in a fresh partial.
template <int D, int NK>
__device__ __forceinline__ void qk(float (&s)[NK / 8][4], const float* at,
                                   int r0, const float* bt, int n0,
                                   int lane) {
  constexpr int LD = Cfg<float, D>::LD;
  constexpr int DEPTH = D < 64 ? D : 64;
#pragma unroll
  for (int c0 = 0; c0 < D; c0 += DEPTH) {
    float part[NK / 8][4];
#pragma unroll
    for (int n = 0; n < NK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
    for (int kk = c0; kk < c0 + DEPTH; kk += 8) {
      uint32_t ahi[4], alo[4];
      a_frag<LD>(ahi, alo, at, r0, kk, lane);
#pragma unroll
      for (int j = 0; j < NK / 16; ++j) {
        uint32_t bhi[4], blo[4];
        bt_frag<LD>(bhi, blo, bt, n0 + 16 * j, kk, lane);
        mma3(part[2 * j], ahi, alo, bhi[0], bhi[1], blo[0], blo[1]);
        mma3(part[2 * j + 1], ahi, alo, bhi[2], bhi[3], blo[2], blo[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < NK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = c0 == 0 ? part[n][e] : s[n][e] + part[n][e];
  }
}

template <int D, int NK>
__device__ __forceinline__ void qk(float (&s)[NK / 8][4], const bf16* at,
                                   int r0, const bf16* bt, int n0, int lane) {
  constexpr int LD = Cfg<bf16, D>::LD;
#pragma unroll
  for (int n = 0; n < NK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    uint32_t a[4];
    a_frag<LD>(a, at, r0, kk, lane);
#pragma unroll
    for (int j = 0; j < NK / 16; ++j) {
      uint32_t b[4];
      bt_frag<LD>(b, bt, n0 + 16 * j, kk, lane);
      mma_bf16(s[2 * j], a, b[0], b[1]);
      mma_bf16(s[2 * j + 1], a, b[2], b[3]);
    }
  }
}

// o += P . V: P the accumulators of NK keys (f32 values), V rows 0..NK-1 of
// a row-major tile. f32: each n8 tile of O takes the tile's product in a
// fresh partial; bf16: P cast to bf16 (the plain version's cast).
template <int D, int NK>
__device__ __forceinline__ void pv(float (&o)[D / 8][4],
                                   const float (&p)[NK / 8][4],
                                   const float* vt, int lane) {
  constexpr int LD = Cfg<float, D>::LD;
  uint32_t phi[NK / 8][4], plo[NK / 8][4];
#pragma unroll
  for (int kc = 0; kc < NK / 8; ++kc) acc_frag(phi[kc], plo[kc], p[kc]);
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kc = 0; kc < NK / 8; ++kc) {
      uint32_t bhi[2], blo[2];
      b_frag<LD>(bhi, blo, vt, 8 * kc, 8 * nt, lane);
      mma3(part, phi[kc], plo[kc], bhi[0], bhi[1], blo[0], blo[1]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] += part[e];
  }
}

template <int D, int NK>
__device__ __forceinline__ void pv(float (&o)[D / 8][4],
                                   const float (&p)[NK / 8][4],
                                   const bf16* vt, int lane) {
  constexpr int LD = Cfg<bf16, D>::LD;
#pragma unroll
  for (int kc = 0; kc < NK / 16; ++kc) {
    uint32_t pa[4];
    attn::acc_to_a(pa, p[2 * kc], p[2 * kc + 1]);
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b[4];
      b_frag<LD>(b, vt, 16 * kc, 16 * np, lane);
      mma_bf16(o[2 * np], pa, b[0], b[1]);
      mma_bf16(o[2 * np + 1], pa, b[2], b[3]);
    }
  }
}

// acc += C . B: C the accumulators of 16 columns (two n8 tiles, f32 values)
// as the depth, B rows k0..k0+15 of a row-major tile. f32: a fresh partial
// each n8 tile of acc.
template <int D>
__device__ __forceinline__ void acc_b(float (&acc)[D / 8][4],
                                      const float (&c)[2][4], const float* bt,
                                      int k0, int lane) {
  constexpr int LD = Cfg<float, D>::LD;
  uint32_t ahi[2][4], alo[2][4];
  acc_frag(ahi[0], alo[0], c[0]);
  acc_frag(ahi[1], alo[1], c[1]);
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t bhi[2], blo[2];
      b_frag<LD>(bhi, blo, bt, k0 + 8 * ks, 8 * nt, lane);
      mma3(part, ahi[ks], alo[ks], bhi[0], bhi[1], blo[0], blo[1]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] += part[e];
  }
}

// bf16: C packed to bf16 (rounded).
template <int D>
__device__ __forceinline__ void acc_b(float (&acc)[D / 8][4],
                                      const float (&c)[2][4], const bf16* bt,
                                      int k0, int lane) {
  constexpr int LD = Cfg<bf16, D>::LD;
  uint32_t a[4];
  attn::acc_to_a(a, c[0], c[1]);
#pragma unroll
  for (int np = 0; np < D / 16; ++np) {
    uint32_t b[4];
    b_frag<LD>(b, bt, k0, 16 * np, lane);
    mma_bf16(acc[2 * np], a, b[0], b[1]);
    mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
  }
}

// Writes a warp's 16 x D accumulators times mul as T: the rows j = w0 + g
// and w0 + g + 8 below j_end, at raster row raster_of(j) when packed.
template <typename T, int D>
__device__ __forceinline__ void store_acc(T* base, long long st,
                                          const float (&acc)[D / 8][4],
                                          float mul, const Geo& geo, int w0,
                                          int j_end, bool packed, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = w0 + g + 8 * r;
    if (j >= j_end) continue;
    T* row = base + (long long)(packed ? raster_of(geo, j) : j) * st + 2 * t4;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      store2(row + 8 * nt, acc[nt][2 * r] * mul, acc[nt][2 * r + 1] * mul);
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, int D, int POLICY>
__device__ __forceinline__ void fwd_body(const AttnArgs& a, int vec) {
  using C = Cfg<T, D>;
  constexpr int BN = C::BN;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + C::OWN;           // 2 stages
  T* sV = sK + 2 * C::STREAM;    // 2 stages

  const Geo geo{a.n, a.grid, a.hw, a.transpose};
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int q1 = min(q0 + BQ, a.T);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3, row0 = 16 * warp;

  const T* kb = at<T>(a.k, a.k_s, b, h);
  const T* vb = at<T>(a.v, a.v_s, b, h);
  const T* kpb = a.kp ? at<T>(a.kp, a.kp_s, b, h) : nullptr;
  const T* vpb = a.vp ? at<T>(a.vp, a.vp_s, b, h) : nullptr;
  const int lo = keys_from<POLICY>(geo, q0), hi = q1;
  const int n_pfx = a.kp ? (a.S + BN - 1) / BN : 0;
  const int n_tiles = n_pfx + (hi - lo + BN - 1) / BN;

  auto issue = [&](int it) {
    T* kd = sK + (it & 1) * C::STREAM;
    T* vd = sV + (it & 1) * C::STREAM;
    if (it < n_pfx) {
      load_tile<T, D, BN>(kd, kpb, a.kp_s[2], geo, it * BN, a.S, false, vec);
      load_tile<T, D, BN>(vd, vpb, a.vp_s[2], geo, it * BN, a.S, false, vec);
    } else {
      const int k0 = lo + (it - n_pfx) * BN;
      load_tile<T, D, BN>(kd, kb, a.k_s[2], geo, k0, hi, true, vec);
      load_tile<T, D, BN>(vd, vb, a.v_s[2], geo, k0, hi, true, vec);
    }
  };
  load_tile<T, D, BQ>(sQ, at<T>(a.q, a.q_s, b, h), a.q_s[2], geo, q0, q1,
                      true, vec);
  issue(0);
  cp_async_commit();

  // this warp's rows [w0, wl] (wl the last real one) and this thread's two
  const int w0 = q0 + row0, wl = min(w0 + 15, q1 - 1);
  const bool live = w0 < q1;
  const Pos qp[2] = {pos_of<POLICY>(geo, w0 + g),
                     pos_of<POLICY>(geo, w0 + g + 8)};

  float o[C::NT][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile it landed; tile it-1's stage no longer read
    if (it + 1 < n_tiles) {
      issue(it + 1);
      cp_async_commit();
    }
    const bool pfx = it < n_pfx;
    const int k0 = pfx ? it * BN : lo + (it - n_pfx) * BN;
    const int ke = min(k0 + BN, pfx ? a.S : hi);
    bool reach = live, full = ke == k0 + BN;
    if (!pfx) {
      bool f;
      reach = reach && reaches<POLICY>(geo, w0, wl, k0, ke, f);
      full = full && f;
    }
    if (!reach) continue;
    const T* tK = sK + (it & 1) * C::STREAM;
    const T* tV = sV + (it & 1) * C::STREAM;

    float s[BN / 8][4];
    qk<D, BN>(s, sQ, row0, tK, 0, lane);

    // scale, mask (only on tiles that cross an edge), tile row max
    float mx[2] = {m[0], m[1]};
    Pos kpos = pos_of<POLICY>(geo, k0 + 2 * t4);
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      const Pos kpos1 = step<POLICY>(geo, kpos, 1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = s[nt][e] * a.scale;
        if (!full) {
          const Pos& kq = (e & 1) ? kpos1 : kpos;
          const bool ok =
              pfx ? kq.j < ke
                  : kq.j < ke && allowed<POLICY>(geo, qp[e >> 1], kq);
          v = ok ? v : NEG_FILL;
        }
        s[nt][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
      kpos = step<POLICY>(geo, kpos, 8);
    }

    // online softmax: the quad holding a row reduces its max (2 shuffles)
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL_MASK, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL_MASK, mx[r], 2));
      alpha[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] *= alpha[e >> 1];
    // the denominator is kept per lane (its columns), summed over the quad
    // at the end
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];

    pv<D, BN>(o, s, tV, lane);
  }
  if (!live) return;

  // out = O / denominator, lse = m + log(denominator)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL_MASK, l[r], 1);
    l[r] += __shfl_xor_sync(FULL_MASK, l[r], 2);
  }
#pragma unroll
  for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = o[nt][e] / l[e >> 1];
  store_acc<T, D>(at<T>(a.out, a.o_s, b, h), a.o_s[2], o, 1.f, geo, w0, q1,
                  true, lane);
  if (t4 == 0) {
    float* lse_b = a.lse + ((long long)b * a.H + h) * a.T;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qj = w0 + g + 8 * r;
      if (qj < q1) lse_b[raster_of(geo, qj)] = m[r] + logf(l[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// dq pass (query-major): a block of 64 query rows walks the key tiles its
// rows reach (the prefix, then the main keys), 16 keys at a time; writes dq
// and the rows' dd = rowsum(dO . O) for the dk/dv passes.
template <typename T, int D, int POLICY>
__device__ __forceinline__ void dq_body(const AttnBwdArgs& a, int vec) {
  using C = Cfg<T, D>;
  constexpr int BN = C::BN;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sdO = sQ + C::OWN;
  T* sK = sdO + C::OWN;          // 2 stages
  T* sV = sK + 2 * C::STREAM;    // 2 stages
  float* sL = reinterpret_cast<float*>(sV + 2 * C::STREAM);
  float* sDD = sL + BQ;

  const Geo geo{a.n, a.grid, a.hw, a.transpose};
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int q1 = min(q0 + BQ, a.T);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3, row0 = 16 * warp;

  const T* kb = at<T>(a.k, a.k_s, b, h);
  const T* vb = at<T>(a.v, a.v_s, b, h);
  const T* ob = at<T>(a.o, a.o_s, b, h);
  const T* kpb = a.kp ? at<T>(a.kp, a.kp_s, b, h) : nullptr;
  const T* vpb = a.vp ? at<T>(a.vp, a.vp_s, b, h) : nullptr;
  const long long vec0 = ((long long)b * a.H + h) * a.T;
  const int lo = keys_from<POLICY>(geo, q0), hi = q1;
  const int n_pfx = a.kp ? (a.S + BN - 1) / BN : 0;
  const int n_tiles = n_pfx + (hi - lo + BN - 1) / BN;

  auto issue = [&](int it) {
    T* kd = sK + (it & 1) * C::STREAM;
    T* vd = sV + (it & 1) * C::STREAM;
    if (it < n_pfx) {
      load_tile<T, D, BN>(kd, kpb, a.kp_s[2], geo, it * BN, a.S, false, vec);
      load_tile<T, D, BN>(vd, vpb, a.vp_s[2], geo, it * BN, a.S, false, vec);
    } else {
      const int k0 = lo + (it - n_pfx) * BN;
      load_tile<T, D, BN>(kd, kb, a.k_s[2], geo, k0, hi, true, vec);
      load_tile<T, D, BN>(vd, vb, a.v_s[2], geo, k0, hi, true, vec);
    }
  };
  load_tile<T, D, BQ>(sQ, at<T>(a.q, a.q_s, b, h), a.q_s[2], geo, q0, q1,
                      true, vec);
  load_tile<T, D, BQ>(sdO, at<T>(a.dout, a.do_s, b, h), a.do_s[2], geo, q0,
                      q1, true, vec);
  issue(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // dd and lse of the warp's 16 rows (lanes over the head dims)
  const int w0 = q0 + row0, wl = min(w0 + 15, q1 - 1);
  const bool live = w0 < q1;
#pragma unroll 1
  for (int r = 0; r < 16; ++r) {
    const int qj = w0 + r;
    const int t = qj < q1 ? raster_of(geo, qj) : 0;
    float part = 0.f;
    if (qj < q1) {
      const T* orow = ob + (long long)t * a.o_s[2];
      for (int d = lane; d < D; d += 32)
        part += to_f(sdO[(row0 + r) * C::LD + d]) * to_f(orow[d]);
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) part += __shfl_xor_sync(FULL_MASK, part, o);
    if (lane == 0) {
      sDD[row0 + r] = part;
      sL[row0 + r] = qj < q1 ? a.lse[vec0 + t] : 0.f;
      if (qj < q1) a.dd[vec0 + t] = part;
    }
  }
  __syncwarp();
  const float lr[2] = {sL[row0 + g], sL[row0 + g + 8]};
  const float ddr[2] = {sDD[row0 + g], sDD[row0 + g + 8]};
  const Pos qp[2] = {pos_of<POLICY>(geo, w0 + g),
                     pos_of<POLICY>(geo, w0 + g + 8)};

  float dq[C::NT][4];
#pragma unroll
  for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[nt][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile it landed; tile it-1's stage no longer read
    if (it + 1 < n_tiles) {
      issue(it + 1);
      cp_async_commit();
    }
    const bool pfx = it < n_pfx;
    const int k0 = pfx ? it * BN : lo + (it - n_pfx) * BN;
    const int ke = min(k0 + BN, pfx ? a.S : hi);
    bool reach = live, full = ke == k0 + BN;
    if (!pfx) {
      bool f;
      reach = reach && reaches<POLICY>(geo, w0, wl, k0, ke, f);
      full = full && f;
    }
    if (!reach) continue;
    const T* tK = sK + (it & 1) * C::STREAM;
    const T* tV = sV + (it & 1) * C::STREAM;

    Pos kpos = pos_of<POLICY>(geo, k0 + 2 * t4);
#pragma unroll 1
    for (int kc = 0; kc < BN / 16; ++kc) {  // keys 16kc..16kc+15
      float s[2][4], dp[2][4], ds[2][4];
      qk<D, 16>(s, sQ, row0, tK, 16 * kc, lane);
      qk<D, 16>(dp, sdO, row0, tV, 16 * kc, lane);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const Pos kpos1 = step<POLICY>(geo, kpos, 1);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const Pos& kq = (e & 1) ? kpos1 : kpos;
          const bool ok =
              full || (pfx ? kq.j < ke
                           : kq.j < ke && allowed<POLICY>(geo, qp[e >> 1], kq));
          const float p = ok ? expf(s[n][e] * a.scale - lr[e >> 1]) : 0.f;
          ds[n][e] = round_to<T>(p * (dp[n][e] - ddr[e >> 1]));
        }
        kpos = step<POLICY>(geo, kpos, 8);
      }
      acc_b<D>(dq, ds, tK, 16 * kc, lane);  // dq += dS . K
    }
  }
  if (!live) return;
  store_acc<T, D>(at<T>(a.dq, a.dq_s, b, h), a.dq_s[2], dq, a.scale, geo, w0,
                  q1, true, lane);
}

// The key-major walk of the two dk/dv kernels: keys k0..k1-1 (the prefix
// when PFX, else main tokens), query tiles from qlo on, below qhi, 16
// queries at a time; dk (unscaled) and dv of this warp's 16 keys.
template <typename T, int D, int POLICY, bool PFX>
__device__ __forceinline__ void dkdv_walk(const AttnBwdArgs& a,
                                          unsigned char* smem, int b, int h,
                                          int k0, int k1, int qlo, int qhi,
                                          int vec, float (&dk)[D / 8][4],
                                          float (&dv)[D / 8][4]) {
  using C = Cfg<T, D>;
  constexpr int BN = C::BN;
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + C::OWN;
  T* sQ = sV + C::OWN;            // 2 stages
  T* sdO = sQ + 2 * C::STREAM;    // 2 stages
  float* sL = reinterpret_cast<float*>(sdO + 2 * C::STREAM);  // 2 stages
  float* sDD = sL + 2 * BN;                                   // 2 stages

  const Geo geo{a.n, a.grid, a.hw, a.transpose};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3, row0 = 16 * warp;
  const T* qb = at<T>(a.q, a.q_s, b, h);
  const T* dob = at<T>(a.dout, a.do_s, b, h);
  const float* lse_b = a.lse + ((long long)b * a.H + h) * a.T;
  const float* dd_b = a.dd + ((long long)b * a.H + h) * a.T;

  if (PFX) {
    load_tile<T, D, BQ>(sK, at<T>(a.kp, a.kp_s, b, h), a.kp_s[2], geo, k0, k1,
                        false, vec);
    load_tile<T, D, BQ>(sV, at<T>(a.vp, a.vp_s, b, h), a.vp_s[2], geo, k0, k1,
                        false, vec);
  } else {
    load_tile<T, D, BQ>(sK, at<T>(a.k, a.k_s, b, h), a.k_s[2], geo, k0, k1,
                        true, vec);
    load_tile<T, D, BQ>(sV, at<T>(a.v, a.v_s, b, h), a.v_s[2], geo, k0, k1,
                        true, vec);
  }
  const int n_tiles = qhi > qlo ? (qhi - qlo + BN - 1) / BN : 0;
  auto issue = [&](int it) {
    const int qs = qlo + it * BN, qe = min(qs + BN, a.T);
    const int st = it & 1;
    load_tile<T, D, BN>(sQ + st * C::STREAM, qb, a.q_s[2], geo, qs, qe, true,
                        vec);
    load_tile<T, D, BN>(sdO + st * C::STREAM, dob, a.do_s[2], geo, qs, qe,
                        true, vec);
    load_vec<BN>(sL + st * BN, lse_b, geo, qs, qe);
    load_vec<BN>(sDD + st * BN, dd_b, geo, qs, qe);
  };
  if (n_tiles > 0) issue(0);
  cp_async_commit();

#pragma unroll
  for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.f;

  const int kw0 = k0 + row0, kwl = min(kw0 + 15, k1 - 1);
  const bool live = kw0 < k1;
  const Pos kp2[2] = {pos_of<POLICY>(geo, kw0 + g),
                      pos_of<POLICY>(geo, kw0 + g + 8)};

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile it landed; tile it-1's stage no longer read
    if (it + 1 < n_tiles) {
      issue(it + 1);
      cp_async_commit();
    }
    const int qs = qlo + it * BN, qe = min(qs + BN, a.T);
    bool reach = live, full = qe == qs + BN;
    if (!PFX) {
      // keys [kw0, kwl] against queries [qs, qe): does some query reach
      // some key (reach), and every query every key (f: no mask)?
      bool f = kwl <= qs;
      reach = reach && qe - 1 >= kw0;
      if (POLICY == POLICY_LINE) {
        reach = reach && qs - qs % geo.n <= kwl;
        f = f && (qe - 1) - (qe - 1) % geo.n <= kw0;
      }
      if (POLICY == POLICY_CONV) {
        reach = reach && kwl / geo.grid >= qs / geo.grid - geo.hw;
        f = false;
      }
      full = full && f;
    }
    if (!reach) continue;
    const int st = it & 1;
    const T* tQ = sQ + st * C::STREAM;
    const T* tdO = sdO + st * C::STREAM;
    const float* tL = sL + st * BN;
    const float* tDD = sDD + st * BN;

    Pos qpos = pos_of<POLICY>(geo, qs + 2 * t4);
#pragma unroll 1
    for (int kc = 0; kc < BN / 16; ++kc) {  // queries 16kc..16kc+15
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 16 queries
      float s[2][4], dp[2][4], p[2][4], ds[2][4];
      qk<D, 16>(s, sK, row0, tQ, 16 * kc, lane);
      qk<D, 16>(dp, sV, row0, tdO, 16 * kc, lane);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = 16 * kc + 8 * n + 2 * t4;
        const float2 lq = *reinterpret_cast<const float2*>(tL + col);
        const float2 dd2 = *reinterpret_cast<const float2*>(tDD + col);
        const Pos qpos1 = step<POLICY>(geo, qpos, 1);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const Pos& qq = (e & 1) ? qpos1 : qpos;
          const bool ok =
              full || (PFX ? qq.j < qe
                           : qq.j < qe && allowed<POLICY>(geo, qq, kp2[e >> 1]));
          const float pe =
              ok ? expf(s[n][e] * a.scale - ((e & 1) ? lq.y : lq.x)) : 0.f;
          p[n][e] = pe;
          ds[n][e] = round_to<T>(pe * (dp[n][e] - ((e & 1) ? dd2.y : dd2.x)));
        }
        qpos = step<POLICY>(geo, qpos, 8);
      }
      if constexpr (C::F32) {
        acc_b<D>(dv, p, tdO, 16 * kc, lane);  // dV += P^T dO
      } else {
        // P = hi + lo, both bf16 (the plain version's P is f32)
        float ph[2][4], pl[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ph[n][e] = round_to<bf16>(p[n][e]);
            pl[n][e] = p[n][e] - ph[n][e];
          }
        acc_b<D>(dv, ph, tdO, 16 * kc, lane);
        acc_b<D>(dv, pl, tdO, 16 * kc, lane);
      }
      acc_b<D>(dk, ds, tQ, 16 * kc, lane);  // dK += dS^T Q
    }
  }
  cp_async_wait<0>();  // a walk of no tiles still committed K/V
}

template <typename T, int D, int POLICY>
__device__ __forceinline__ void dkdv_body(const AttnBwdArgs& a, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Geo geo{a.n, a.grid, a.hw, a.transpose};
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BQ, k1 = min(k0 + BQ, a.T);
  float dk[D / 8][4], dv[D / 8][4];
  dkdv_walk<T, D, POLICY, false>(a, smem, b, h, k0, k1, k0,
                                 queries_to<POLICY>(geo, k1, a.T), vec, dk,
                                 dv);
  const int lane = threadIdx.x & 31, kw0 = k0 + 16 * (threadIdx.x >> 5);
  if (kw0 >= k1) return;
  store_acc<T, D>(at<T>(a.dk, a.dk_s, b, h), a.dk_s[2], dk, a.scale, geo, kw0,
                  k1, true, lane);
  store_acc<T, D>(at<T>(a.dv, a.dv_s, b, h), a.dv_s[2], dv, 1.f, geo, kw0, k1,
                  true, lane);
}

// The prefix's dk/dv: each 64-key prefix tile is a cluster of 4 blocks; each
// walks a quarter of the query tiles (every query reaches every prefix key)
// into partial dk/dv, and the cluster sums the partials in rank order
// through distributed shared memory, block `rank` reducing and writing 16
// of the keys.
template <typename T, int D, int POLICY>
__device__ __forceinline__ void dkdv_prefix_body(const AttnBwdArgs& a,
                                                 int vec) {
  constexpr int BN = Cfg<T, D>::BN;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = (blockIdx.x / CLUSTER) * BQ, k1 = min(k0 + BQ, a.S);
  const int q_tiles = (a.T + BN - 1) / BN;
  const int qlo = rank * q_tiles / CLUSTER * BN;
  const int qhi = min(a.T, (rank + 1) * q_tiles / CLUSTER * BN);

  float dk[D / 8][4], dv[D / 8][4];
  dkdv_walk<T, D, POLICY, true>(a, smem, b, h, k0, k1, qlo, qhi, vec, dk, dv);
  __syncthreads();  // every warp is done with the tiles

  // this block's partial dk | dv, f32 [2][64][D]
  float* part = reinterpret_cast<float*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = (16 * warp + g + 8 * hh) * D + 8 * nt + 2 * t4;
      *reinterpret_cast<float2*>(part + i) =
          make_float2(dk[nt][2 * hh], dk[nt][2 * hh + 1]);
      *reinterpret_cast<float2*>(part + BQ * D + i) =
          make_float2(dv[nt][2 * hh], dv[nt][2 * hh + 1]);
    }
  }
  cluster.sync();

  constexpr int ROWS = BQ / CLUSTER;         // keys a block reduces
  constexpr int ITEMS = 2 * ROWS * (D / 4);  // float4 of dk and dv
  static_assert(ITEMS % THREADS == 0, "the reduction splits evenly");
  const float* parts[CLUSTER];
#pragma unroll
  for (int r = 0; r < CLUSTER; ++r)
    parts[r] = cluster.map_shared_rank(part, r);
  T* dkb = at<T>(a.dkp, a.dkp_s, b, h);
  T* dvb = at<T>(a.dvp, a.dvp_s, b, h);
#pragma unroll
  for (int i = 0; i < ITEMS / THREADS; ++i) {
    const int idx = threadIdx.x + THREADS * i;
    const int which = idx / (ITEMS / 2), rem = idx % (ITEMS / 2);
    const int row = ROWS * rank + rem / (D / 4), c4 = rem % (D / 4);
    const int off = which * BQ * D + row * D + 4 * c4;
    float4 acc = *reinterpret_cast<const float4*>(parts[0] + off);
#pragma unroll
    for (int r = 1; r < CLUSTER; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(parts[r] + off);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    const int kj = k0 + row;
    if (kj < k1) {
      const float mul = which ? 1.f : a.scale;
      T* dst = (which ? dvb + (long long)kj * a.dvp_s[2]
                      : dkb + (long long)kj * a.dkp_s[2]) + 4 * c4;
      store2(dst, acc.x * mul, acc.y * mul);
      store2(dst + 2, acc.z * mul, acc.w * mul);
    }
  }
  cluster.sync();  // the other blocks' shared memory is read until here
}

typedef void (*FwdKernel)(AttnArgs, int);
typedef void (*BwdKernel)(AttnBwdArgs, int);

// The four kernels of one policy: the forward, the dq pass, the dk/dv pass
// and the prefix's dk/dv pass (null where a source does not define them).
struct Passes {
  FwdKernel fwd;
  BwdKernel dq, dkdv, prefix;
};

// The kernels of policy POLICY in the instance (T, D): none, unless the
// source defines them with WIN_POLICY_KERNELS, which specialises this.
template <typename T, int D, int POLICY>
struct Kern {
  static Passes get() { return Passes{}; }
};

}  // namespace

// WIN_POLICY_KERNELS(T, D, TAG, POLICY, PNAME): the kernels of one policy of
// one (dtype, head_dim) instance, under names a profiler and ptxas show,
// attn_win_{fwd,dq,dkdv,dkdv_prefix}_<tag>_<pname>, and Kern<T, D, POLICY>.
// The minimum of one block an SM lets ptxas use up to 255 registers:
// without it, it held the f32 D = 64 dk/dv pass to 128 and spilled.
#define WIN_POLICY_KERNELS(T, D, TAG, POLICY, PNAME)                       \
  __global__ void __launch_bounds__(THREADS, 1)                            \
      attn_win_fwd_##TAG##_##PNAME(AttnArgs a, int vec) {                  \
    fwd_body<T, D, POLICY>(a, vec);                                        \
  }                                                                        \
  __global__ void __launch_bounds__(THREADS, 1)                            \
      attn_win_dq_##TAG##_##PNAME(AttnBwdArgs a, int vec) {                \
    dq_body<T, D, POLICY>(a, vec);                                         \
  }                                                                        \
  __global__ void __launch_bounds__(THREADS, 1)                            \
      attn_win_dkdv_##TAG##_##PNAME(AttnBwdArgs a, int vec) {              \
    dkdv_body<T, D, POLICY>(a, vec);                                       \
  }                                                                        \
  __global__ void __launch_bounds__(THREADS, 1)                            \
      attn_win_dkdv_prefix_##TAG##_##PNAME(AttnBwdArgs a, int vec) {       \
    dkdv_prefix_body<T, D, POLICY>(a, vec);                                \
  }                                                                        \
  namespace {                                                              \
  template <>                                                              \
  struct Kern<T, D, POLICY> {                                              \
    static Passes get() {                                                  \
      return Passes{attn_win_fwd_##TAG##_##PNAME,                          \
                    attn_win_dq_##TAG##_##PNAME,                           \
                    attn_win_dkdv_##TAG##_##PNAME,                         \
                    attn_win_dkdv_prefix_##TAG##_##PNAME};                 \
    }                                                                      \
  };                                                                       \
  }

// WIN_INSTANCE(T, D, TAG): the window policies' kernels (conv_like, full);
// LINE_INSTANCE(T, D, TAG): the line policy's. Each instance has a source
// of each (see "Sources" above).
#define WIN_INSTANCE(T, D, TAG)                                            \
  WIN_POLICY_KERNELS(T, D, TAG, POLICY_CONV, conv)                         \
  WIN_POLICY_KERNELS(T, D, TAG, POLICY_FULL, full)

#define LINE_INSTANCE(T, D, TAG)                                           \
  WIN_POLICY_KERNELS(T, D, TAG, POLICY_LINE, line)

// The launches, for the instances a source defines with WIN_INSTANCE.
namespace {

// The kernels of `policy` in the instance (T, D).
template <typename T, int D>
Passes passes(int policy) {
  if (policy == POLICY_LINE) return Kern<T, D, POLICY_LINE>::get();
  if (policy == POLICY_CONV) return Kern<T, D, POLICY_CONV>::get();
  if (policy == POLICY_FULL) return Kern<T, D, POLICY_FULL>::get();
  return Passes{};
}

template <typename T, int D>
int launch_fwd(const AttnArgs& a, int vec, cudaStream_t s) {
  using C = Cfg<T, D>;
  const FwdKernel k = passes<T, D>(a.policy).fwd;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, C::FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  k<<<dim3((a.T + BQ - 1) / BQ, a.H, a.B), THREADS, C::FWD_SMEM, s>>>(a,
                                                                       vec);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_bwd(const AttnBwdArgs& a, int vec, cudaStream_t s) {
  using C = Cfg<T, D>;
  const Passes p = passes<T, D>(a.policy);
  const BwdKernel kernels[3] = {p.dq, p.dkdv, p.prefix};
  for (BwdKernel k : kernels) {
    const cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BWD_SMEM);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((a.T + BQ - 1) / BQ, a.H, a.B);
  kernels[0]<<<grid, THREADS, C::BWD_SMEM, s>>>(a, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kernels[1]<<<grid, THREADS, C::BWD_SMEM, s>>>(a, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.kp == nullptr) return (int)err;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.S + BQ - 1) / BQ * CLUSTER, a.H, a.B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = C::BWD_SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernels[2], a, vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// {registers, static shared bytes, dynamic shared bytes of a launch, local
// (spill) bytes a thread} of pass `pass` (0 forward, 1 dq, 2 dk/dv, 3 the
// prefix's dk/dv).
template <typename T, int D>
int resources(int policy, int pass, int* out) {
  using C = Cfg<T, D>;
  const Passes p = passes<T, D>(policy);
  const void* fn = pass == 0   ? (const void*)p.fwd
                   : pass == 1 ? (const void*)p.dq
                   : pass == 2 ? (const void*)p.dkdv
                               : (const void*)p.prefix;
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, fn);
  out[0] = fa.numRegs;
  out[1] = (int)fa.sharedSizeBytes;
  out[2] = pass == 0 ? C::FWD_SMEM : C::BWD_SMEM;
  out[3] = (int)fa.localSizeBytes;
  return (int)err;
}

// Whether the source defines `policy`'s kernels, and `vec` is a copy width.
template <typename T, int D>
bool valid(int policy, int vec) {
  return passes<T, D>(policy).fwd != nullptr &&
         (vec == 16 || vec == 8 || vec == 4 || vec == 2);
}

}  // namespace

// The C entry points of one source, for its instance (T, D) and the
// policies it defines; any other dtype, head_dim or policy is refused. vec: the widest copy (16, 8, 4 or, for
// bf16, 2 bytes) that every row of q, k, v, kp, vp (and o, dout) starts on.
#define WIN_ENTRY_POINTS(T, D)                                              \
  namespace {                                                               \
  bool ours(int dtype, int head_dim) {                                      \
    return head_dim == D &&                                                 \
           dtype == (sizeof(T) == 4 ? DTYPE_F32 : DTYPE_BF16);              \
  }                                                                         \
  }                                                                         \
  extern "C" int attention_window_generic_fwd(const AttnArgs* a, int dtype, \
                                              int head_dim, int vec,        \
                                              void* stream) {               \
    if (!ours(dtype, head_dim) || !valid<T, D>(a->policy, vec) ||           \
        vec < (int)sizeof(T))                                               \
      return (int)cudaErrorInvalidValue;                                    \
    return launch_fwd<T, D>(*a, vec, static_cast<cudaStream_t>(stream));   \
  }                                                                         \
  extern "C" int attention_window_generic_bwd(const AttnBwdArgs* a,         \
                                              int dtype, int head_dim,      \
                                              int vec, void* stream) {      \
    if (!ours(dtype, head_dim) || !valid<T, D>(a->policy, vec) ||           \
        vec < (int)sizeof(T) || (a->kp == nullptr) != (a->dkp == nullptr))  \
      return (int)cudaErrorInvalidValue;                                    \
    return launch_bwd<T, D>(*a, vec, static_cast<cudaStream_t>(stream));   \
  }                                                                         \
  extern "C" int attention_window_generic_resources(                        \
      int dtype, int head_dim, int policy, int pass, int* out) {            \
    if (!ours(dtype, head_dim) || !valid<T, D>(policy, 16) || pass < 0 ||   \
        pass > 3)                                                           \
      return (int)cudaErrorInvalidValue;                                    \
    return resources<T, D>(policy, pass, out);                              \
  }                                                                         \
  extern "C" const char* attention_window_generic_error(int err) {          \
    return cudaGetErrorString(static_cast<cudaError_t>(err));               \
  }
