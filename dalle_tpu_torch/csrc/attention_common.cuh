// Shared pieces of attention_fwd.cu, attention_bwd.cu and the generic
// kernels of attention_window_generic.cuh, in two sections.
//
// The first assumes no tile shape, dtype or head dim: the argument structs
// of the C entry points, the three key-range policies and their mask
// arithmetic (Geo, raster_of, pos_of, step, allowed). The generic kernels
// use this section, and of the second only acc_to_a (their copies and
// fragment loads are mma_sync.cuh's).
//
// The second serves the fast kernels: tile geometry, cp.async loads into
// XOR-swizzled shared-memory tiles, ldmatrix fragment loads and the bf16
// mma.sync. Tiles are 64 rows of d = 64 bf16 (128 bytes a row, eight
// 16-byte chunks). Chunk c of row r sits at chunk c ^ (r & 7), so the eight
// row addresses of an ldmatrix (eight rows, one chunk column) fall in eight
// different bank groups and a cp.async of a whole row still writes 128
// contiguous bytes.
//
// Fragments follow mma.sync.m16n8k16 (bf16 in, f32 accumulate). For a lane
// with g = lane / 4 and t = lane % 4, an accumulator c[4] of an n8 tile holds
// (row g, cols 2t, 2t+1) in c[0..1] and (row g+8, same cols) in c[2..3]; the
// accumulators of two neighbouring n8 tiles, packed to bf16, are exactly the
// A fragment of the next product over those 16 columns (FA2's register
// layout), so probabilities never leave registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

#include <cstdint>

typedef __nv_bfloat16 bf16;

// Arguments of the forward entry points (attention_fwd,
// attention_window_generic_fwd; mirrored by ops/attention.py). Every tensor is (B, H, T, d) with element
// strides for b, h, t and unit stride along d.
struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* kp;  // prefix keys (B, H, S, d) or null
  const void* vp;
  void* out;       // (B, H, T, d), q's dtype
  float* lse;      // (B, H, 1, T) f32, contiguous, raster token order
  long long q_s[3], k_s[3], v_s[3], kp_s[3], vp_s[3], o_s[3];  // b, h, t
  int B, H, T, S;
  int policy;
  int n;          // tokens per line (POLICY_LINE)
  int grid;       // raster side (axial_col lines, conv windows)
  int hw;         // conv half window (POLICY_CONV)
  int transpose;  // POLICY_LINE: lines are raster columns
  float scale;
};

// Arguments of the backward entry points (attention_bwd,
// attention_window_generic_bwd).
struct AttnBwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* kp;   // prefix keys (B, H, S, d) or null
  const void* vp;
  const void* o;    // forward output (B, H, T, d)
  const void* dout;
  const float* lse; // (B, H, 1, T) f32, contiguous, raster token order
  float* dd;        // (B, H, T) f32 scratch, raster order: rowsum(dO . O)
  void* dq;
  void* dk;
  void* dv;
  void* dkp;        // (B, H, S, d) or null
  void* dvp;
  long long q_s[3], k_s[3], v_s[3], kp_s[3], vp_s[3], o_s[3], do_s[3];
  long long dq_s[3], dk_s[3], dv_s[3], dkp_s[3], dvp_s[3];   // b, h, t
  int B, H, T, S;
  int policy;
  int n;          // tokens per line (POLICY_LINE)
  int grid;       // raster side (axial_col lines, conv windows)
  int hw;         // conv half window (POLICY_CONV)
  int transpose;  // POLICY_LINE: lines are raster columns
  float scale;
};

namespace attn {

// ---------------------------------------------------------------------------
// policies and masks (any tile, dtype and head dim)
// ---------------------------------------------------------------------------

constexpr float NEG_FILL = -1e9f;     // masked scores (the TPU kernels' fill)

enum { POLICY_LINE = 0, POLICY_CONV = 1, POLICY_FULL = 2 };

// The key-range geometry the masks need (from the argument structs).
struct Geo {
  int n;          // tokens per line (POLICY_LINE)
  int grid;       // raster side (axial_col lines, conv windows)
  int hw;         // conv half window (POLICY_CONV)
  int transpose;  // POLICY_LINE: lines are raster columns
};

// Raster token index of the packed index j (lines contiguous in j).
__device__ __forceinline__ int raster_of(const Geo& g, int j) {
  return g.transpose ? (j % g.n) * g.grid + j / g.n : j;
}

// A main token as the masks see it: packed index j, its line's first index
// ls (POLICY_LINE), its raster row r and column c (POLICY_CONV). The
// divisions happen once per tile in pos_of; step() moves along a row of
// fragment columns by addition.
struct Pos {
  int j, ls, r, c;
};

template <int POLICY>
__device__ __forceinline__ Pos pos_of(const Geo& g, int j) {
  Pos p{j, 0, 0, 0};
  if (POLICY == POLICY_LINE) p.ls = j - j % g.n;
  if (POLICY == POLICY_CONV) {
    p.r = j / g.grid;
    p.c = j - p.r * g.grid;
  }
  return p;
}

template <int POLICY>
__device__ __forceinline__ Pos step(const Geo& g, Pos p, int by) {
  p.j += by;
  if (POLICY == POLICY_LINE)
    while (p.j >= p.ls + g.n) p.ls += g.n;
  if (POLICY == POLICY_CONV) {
    p.c += by;
    while (p.c >= g.grid) {
      p.c -= g.grid;
      ++p.r;
    }
  }
  return p;
}

// Whether query q may attend to main key k (both main tokens).
template <int POLICY>
__device__ __forceinline__ bool allowed(const Geo& g, const Pos& q,
                                        const Pos& k) {
  if (k.j > q.j) return false;
  if (POLICY == POLICY_LINE) return k.j >= q.ls;
  if (POLICY == POLICY_CONV) {
    const int dr = k.r - q.r, dc = k.c - q.c;
    return dr <= g.hw && dr >= -g.hw && dc <= g.hw && dc >= -g.hw;
  }
  return true;
}

// ---------------------------------------------------------------------------
// 64 x 64 bf16 tiles (the fast kernels)
// ---------------------------------------------------------------------------

constexpr int D = 64;                 // head dim
constexpr int BT = 64;                // rows of a tile (queries or keys)
constexpr int THREADS = 128;          // 4 warps, 16 rows each
constexpr int TILE = BT * D;          // bf16 elements of a tile

// Element offset of (row, 16-byte chunk) in a swizzled [64][64] bf16 tile.
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * D + ((chunk ^ (row & 7)) << 3);
}

// ---------------------------------------------------------------------------
// asynchronous copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; zeros when !valid (src-size 0 reads
// nothing, so gmem only has to be a valid pointer).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until every group this thread committed has landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows j0..j0+63 of a (.., T, 64) bf16 operand into a swizzled tile, rows at
// or past j_end zero-filled. Packed rows (main tokens) sit at raster row
// raster_of(j); prefix rows at j.
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* base,
                                          long long stride_t, const Geo& g,
                                          int j0, int j_end, bool packed) {
#pragma unroll
  for (int i = 0; i < TILE / 8 / THREADS; ++i) {
    const int c = threadIdx.x + i * THREADS;
    const int r = c >> 3, ch = c & 7;
    const int j = j0 + r;
    const bool ok = j < j_end;
    const int t = ok ? (packed ? raster_of(g, j) : j) : 0;
    cp_async16(tile + swz(r, ch), base + (long long)t * stride_t + ch * 8, ok);
  }
}

// 64 f32 of a raster-order row vector (lse, dd) for packed rows j0..j0+63.
__device__ __forceinline__ void load_vec(float* dst, const float* base,
                                         const Geo& g, int j0, int j_end) {
  if (threadIdx.x < BT) {
    const int j = j0 + threadIdx.x;
    const bool ok = j < j_end;
    cp_async4(dst + threadIdx.x, base + (ok ? raster_of(g, j) : 0), ok);
  }
}

// ---------------------------------------------------------------------------
// fragments
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// A fragment of rows row0..row0+15, columns 16kc..16kc+15 of a row-major tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int row0, int kc, int lane) {
  ldsm_x4(a, tile + swz(row0 + (lane & 15), 2 * kc + (lane >> 4)));
}

// B fragments of the two n8 tiles rows 16np..16np+15 (as columns of B),
// depth 16kc..16kc+15, from a tile stored [n][k] (B^T row-major: K for
// Q K^T). b[0..1] serve n-tile 2np, b[2..3] n-tile 2np+1.
__device__ __forceinline__ void load_bt(uint32_t (&b)[4], const bf16* tile,
                                        int np, int kc, int lane) {
  const int m = lane >> 3;
  ldsm_x4(b, tile + swz(16 * np + (lane & 7) + ((m >> 1) << 3),
                        2 * kc + (m & 1)));
}

// B fragments of the two n8 tiles columns 16np..16np+15, depth rows
// 16kc..16kc+15, from a tile stored [k][n] (B row-major: V for P V),
// transposed by ldmatrix. b[0..1] serve n-tile 2np, b[2..3] n-tile 2np+1.
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* tile,
                                       int kc, int np, int lane) {
  const int m = lane >> 3;
  ldsm_x4_t(b, tile + swz(16 * kc + (lane & 7) + ((m & 1) << 3),
                          2 * np + (m >> 1)));
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment over 16 columns from the accumulators of its two n8 tiles.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Writes a warp's 16 x 64 f32 accumulators times `mul` as bf16 into rows
// row0..row0+15 of a swizzled tile (the warp's own rows: only __syncwarp).
__device__ __forceinline__ void stage_rows(bf16* tile, const float (&acc)[8][4],
                                           float mul, int row0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + g + 8 * h;
      *reinterpret_cast<uint32_t*>(tile + swz(r, nt) + 2 * t) =
          pack_bf16(acc[nt][2 * h] * mul, acc[nt][2 * h + 1] * mul);
    }
  }
}

// Copies a warp's 16 staged rows to global rows (16-byte stores): packed
// row j = j0 + i goes to raster_of(j) (or j when !packed) if j < j_end.
__device__ __forceinline__ void store_rows(bf16* base, long long stride_t,
                                           const bf16* tile, const Geo& g,
                                           int row0, int j0, int j_end,
                                           bool packed, int lane) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = lane + 32 * i;
    const int r = idx >> 3, ch = idx & 7;
    const int j = j0 + row0 + r;
    if (j < j_end) {
      const long long t = packed ? raster_of(g, j) : j;
      *reinterpret_cast<uint4*>(base + t * stride_t + ch * 8) =
          *reinterpret_cast<const uint4*>(tile + swz(row0 + r, ch));
    }
  }
}

}  // namespace attn
