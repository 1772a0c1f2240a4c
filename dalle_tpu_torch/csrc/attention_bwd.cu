// Backward [prefix || masked main-token] attention for the DALL-E attention
// zoo: two templated kernels, the same three key-range and mask policies as
// attention_fwd.cu.
//
// Replaces the TPU kernels of dalle_tpu/ops/pallas/attention_kernels.py:
//   POLICY_LINE  -> _line_attention_bwd (_bwd_kernel / _bwd_nopfx_kernel):
//                   text-causal, axial_row, axial_col (columns read with
//                   strides, no relayout copies);
//   POLICY_CONV  -> _window_attention_bwd (_win_bwd_kernel), hw = conv/2;
//   POLICY_FULL  -> _window_attention_bwd with hw = None.
//
// Math (kept from the TPU kernels): P = exp(s - lse) in f32 from the saved
// raster-order logsumexp, with s = (q . k) * d^-1/2 masked (masked entries
// give P = 0, as exp(-1e9 - lse) does); dd = rowsum(dO . O) in f32;
// dP = dO . v^T; dS = P * (dP - dd); dq = (dS . k + dS_p . k_p) * scale;
// dk = (dS^T . q) * scale; dv = P^T . dO; the same for the prefix (dkp,
// dvp). Operands of every product are bf16 with f32 accumulation, dS cast
// to bf16 before its products, as the TPU kernel casts it. The TPU kernel
// multiplies the f32 P (not a bf16 copy) by dO for dv; here P is split as
// P = hi + lo with hi = bf16(P) and lo = bf16(P - hi), and dv takes both
// products, which keeps P to ~16 significant bits against f32's 24 (a bf16
// P alone would keep 8).
//
// The TPU kernels hold a whole (b, h) in VMEM and accumulate dk/dv of
// overlapping query groups in (T, d) f32 scratch (512 KB at T = 1024 with
// two heads per step), which no Hopper SM can hold, and sum the prefix's
// dkp/dvp over all image queries in one whole-tile product. Here the work
// splits FA2-style into two passes with no atomics, so every output is
// written by exactly one thread and two runs give identical bits:
//
//   attn_bwd_dq_kernel   (query-major): one block per 64 query rows walks
//                        the key tiles its rows reach (the prefix, then
//                        its lines / conv window / causal past), writes dq
//                        and the rows' dd for the second pass;
//   attn_bwd_dkdv_kernel (key-major): one block per 64 keys (the prefix's
//                        key tiles first, since they are the long ones)
//                        walks the query tiles that reach its keys (every
//                        query for a prefix key; the keys' own lines; the
//                        conv rows below; the causal future) and keeps its
//                        dk/dv accumulators in registers.
//
// Scores and probabilities are recomputed in both passes and never written
// to device memory. What bounds it on the card: at the flagship (B=4,
// H=16, d=64) a layer's backward moves tens of MB (q, k, v, O, dO, lse
// in; dq, dk, dv, dkp, dvp out) for a few GFLOP, below the ~295 FLOP/byte
// ridge: memory bandwidth. Tensor-core work is bf16 WMMA 16x16x16 with f32
// accumulators; blocks of 4 warps, each warp 16 rows (queries in the first
// pass, keys in the second). Layout: every tensor (B, H, T, 64) bf16 with
// arbitrary b, h, t element strides and unit stride along d.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int D = 64;        // head dim
constexpr int BT = 64;       // rows per tile (queries or keys)
constexpr int LDB = D + 8;   // bf16 shared-memory row pitch (elements)
constexpr int LDF = BT + 4;  // f32 shared-memory row pitch (elements)
constexpr int THREADS = 128;

enum { POLICY_LINE = 0, POLICY_CONV = 1, POLICY_FULL = 2 };

constexpr size_t BF_TILE = BT * LDB * sizeof(bf16);
constexpr size_t F_TILE = BT * LDF * sizeof(float);
constexpr size_t DQ_SMEM = 5 * BF_TILE + 2 * F_TILE;
constexpr size_t DKDV_SMEM = 7 * BF_TILE + 2 * F_TILE + 2 * BT * sizeof(float);

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBR;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBC;

}  // namespace

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

// Raster token index of the packed index j (lines contiguous in j).
__device__ __forceinline__ int raster_of(const AttnBwdArgs& a, int j) {
  if (a.transpose) return (j % a.n) * a.grid + j / a.n;
  return j;
}

template <int POLICY>
__device__ __forceinline__ bool allowed(const AttnBwdArgs& a, int qj, int kj) {
  if (kj > qj) return false;
  if (POLICY == POLICY_LINE) return kj / a.n == qj / a.n;
  if (POLICY == POLICY_CONV) {
    int dr = kj / a.grid - qj / a.grid;
    int dc = kj % a.grid - qj % a.grid;
    return dr <= a.hw && dr >= -a.hw && dc <= a.hw && dc >= -a.hw;
  }
  return true;
}

__device__ __forceinline__ void load_rows(bf16* dst, const bf16* base,
                                          long long stride_t,
                                          const AttnBwdArgs& a, int j0,
                                          int j_end, bool packed) {
  // rows j0..j0+63 of a (.., T, 64) operand into a [64][LDB] tile, 16-byte
  // vectors, zeros past j_end
  for (int c = threadIdx.x; c < BT * (D / 8); c += THREADS) {
    int r = c / (D / 8), col = (c % (D / 8)) * 8;
    int j = j0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (j < j_end) {
      int t = packed ? raster_of(a, j) : j;
      val = *reinterpret_cast<const uint4*>(base + (long long)t * stride_t + col);
    }
    *reinterpret_cast<uint4*>(dst + r * LDB + col) = val;
  }
}

// out (16 x 64, f32, pitch LDF) = A rows (16 x 64, bf16) . B^T where B is a
// [64][LDB] tile read column-major (row n of the tile is column n of B^T)
__device__ __forceinline__ void rows_times_tile_t(float* out, const bf16* a_rows,
                                                  const bf16* b_tile) {
#pragma unroll
  for (int nc = 0; nc < BT / 16; ++nc) {
    Acc acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      FragA fa;
      FragBC fb;
      wmma::load_matrix_sync(fa, a_rows + kc * 16, LDB);
      wmma::load_matrix_sync(fb, b_tile + nc * 16 * LDB + kc * 16, LDB);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(out + nc * 16, acc, LDF, wmma::mem_row_major);
  }
}

// acc[dc] (16 x 64) += A rows (16 x 64, bf16, over the tile's rows) . tile
// (a [64][LDB] tile read row-major)
__device__ __forceinline__ void accumulate_rows_times_tile(Acc* acc,
                                                           const bf16* a_rows,
                                                           const bf16* tile) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    FragA fa;
    wmma::load_matrix_sync(fa, a_rows + kk * 16, LDB);
#pragma unroll
    for (int dc = 0; dc < D / 16; ++dc) {
      FragBR fb;
      wmma::load_matrix_sync(fb, tile + kk * 16 * LDB + dc * 16, LDB);
      wmma::mma_sync(acc[dc], fa, fb, acc[dc]);
    }
  }
}

// writes a warp's 16 rows of f32 (pitch LDF) times `mul` as bf16 rows
__device__ __forceinline__ void store_row(bf16* base, long long t,
                                          long long stride_t, const float* src,
                                          float mul, int lane) {
  const float2 o = make_float2(src[2 * lane] * mul, src[2 * lane + 1] * mul);
  *reinterpret_cast<__nv_bfloat162*>(base + t * stride_t + 2 * lane) =
      __float22bfloat162_rn(o);
}

template <int POLICY>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dq_kernel(AttnBwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + BT * LDB;
  bf16* sK = sdO + BT * LDB;
  bf16* sV = sK + BT * LDB;
  bf16* sdS = sV + BT * LDB;
  float* sS = reinterpret_cast<float*>(sdS + BT * LDB);
  float* sdP = sS + BT * LDF;

  const int q0 = blockIdx.x * BT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q1 = min(q0 + BT, a.T);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * 16;

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_s[0] + h * a.q_s[1];
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_s[0] + h * a.k_s[1];
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_s[0] + h * a.v_s[1];
  const bf16* ob = static_cast<const bf16*>(a.o) + b * a.o_s[0] + h * a.o_s[1];
  const bf16* dob =
      static_cast<const bf16*>(a.dout) + b * a.do_s[0] + h * a.do_s[1];
  const float* lse_b = a.lse + ((long long)b * a.H + h) * a.T;
  float* dd_b = a.dd + ((long long)b * a.H + h) * a.T;

  load_rows(sQ, qb, a.q_s[2], a, q0, q1, true);
  load_rows(sdO, dob, a.do_s[2], a, q0, q1, true);

  // this warp's rows: lse from the forward, dd = rowsum(dO . O) in f32
  float lse_r[16], dd_r[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int qj = q0 + row0 + r;
    lse_r[r] = 0.f;
    dd_r[r] = 0.f;
    if (qj < q1) {
      const long long t = raster_of(a, qj);
      const float2 o = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(ob + t * a.o_s[2] + 2 * lane));
      const float2 g = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(dob + t * a.do_s[2] + 2 * lane));
      float s = o.x * g.x + o.y * g.y;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      dd_r[r] = s;
      lse_r[r] = lse_b[t];
      if (lane == 0) dd_b[t] = s;
    }
  }

  Acc accQ[D / 16];
#pragma unroll
  for (int dc = 0; dc < D / 16; ++dc) wmma::fill_fragment(accQ[dc], 0.f);

  int lo = 0;
  if (POLICY == POLICY_LINE) lo = (q0 / a.n) * a.n;
  if (POLICY == POLICY_CONV) lo = max(0, q0 / a.grid - a.hw) * a.grid;
  const int hi = q1;
  const int n_pfx = a.kp ? (a.S + BT - 1) / BT : 0;
  const int n_main = (hi - lo + BT - 1) / BT;

  for (int it = 0; it < n_pfx + n_main; ++it) {
    const bool pfx = it < n_pfx;
    const int k0 = pfx ? it * BT : lo + (it - n_pfx) * BT;
    __syncthreads();  // previous tile's K/V no longer read
    if (pfx) {
      const bf16* kpb = static_cast<const bf16*>(a.kp) + b * a.kp_s[0] + h * a.kp_s[1];
      const bf16* vpb = static_cast<const bf16*>(a.vp) + b * a.vp_s[0] + h * a.vp_s[1];
      load_rows(sK, kpb, a.kp_s[2], a, k0, a.S, false);
      load_rows(sV, vpb, a.vp_s[2], a, k0, a.S, false);
    } else {
      load_rows(sK, kb, a.k_s[2], a, k0, hi, true);
      load_rows(sV, vb, a.v_s[2], a, k0, hi, true);
    }
    __syncthreads();

    rows_times_tile_t(sS + row0 * LDF, sQ + row0 * LDB, sK);    // S = Q K^T
    rows_times_tile_t(sdP + row0 * LDF, sdO + row0 * LDB, sV);  // dP = dO V^T
    __syncwarp();

#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int qj = q0 + row0 + r;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = lane + 32 * e;
        const int kj = k0 + c;
        bool ok = qj < q1;
        if (pfx) ok = ok && kj < a.S;
        else ok = ok && kj < hi && allowed<POLICY>(a, qj, kj);
        const int i = (row0 + r) * LDF + c;
        const float p = ok ? expf(sS[i] * a.scale - lse_r[r]) : 0.f;
        sdS[(row0 + r) * LDB + c] = __float2bfloat16(p * (sdP[i] - dd_r[r]));
      }
    }
    __syncwarp();

    accumulate_rows_times_tile(accQ, sdS + row0 * LDB, sK);     // dQ += dS K
  }

  // dq = acc * scale, into raster rows
#pragma unroll
  for (int dc = 0; dc < D / 16; ++dc)
    wmma::store_matrix_sync(sS + row0 * LDF + dc * 16, accQ[dc], LDF,
                            wmma::mem_row_major);
  __syncwarp();
  bf16* dqb = static_cast<bf16*>(a.dq) + b * a.dq_s[0] + h * a.dq_s[1];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int qj = q0 + row0 + r;
    if (qj < q1)
      store_row(dqb, raster_of(a, qj), a.dq_s[2], sS + (row0 + r) * LDF,
                a.scale, lane);
  }
}

template <int POLICY>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dkdv_kernel(AttnBwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BT * LDB;
  bf16* sQ = sV + BT * LDB;
  bf16* sdO = sQ + BT * LDB;
  bf16* sPh = sdO + BT * LDB;
  bf16* sPl = sPh + BT * LDB;
  bf16* sdS = sPl + BT * LDB;
  float* sS = reinterpret_cast<float*>(sdS + BT * LDB);   // S^T, then dK
  float* sdP = sS + BT * LDF;                              // dP^T, then dV
  float* sL = sdP + BT * LDF;                              // lse per query
  float* sD = sL + BT;                                     // dd per query

  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * 16;
  const int n_pfx = a.kp ? (a.S + BT - 1) / BT : 0;
  const bool pfx = (int)blockIdx.x < n_pfx;
  const int k0 = (pfx ? blockIdx.x : blockIdx.x - n_pfx) * BT;
  const int k1 = min(k0 + BT, pfx ? a.S : a.T);

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_s[0] + h * a.q_s[1];
  const bf16* dob =
      static_cast<const bf16*>(a.dout) + b * a.do_s[0] + h * a.do_s[1];
  const float* lse_b = a.lse + ((long long)b * a.H + h) * a.T;
  const float* dd_b = a.dd + ((long long)b * a.H + h) * a.T;

  if (pfx) {
    load_rows(sK, static_cast<const bf16*>(a.kp) + b * a.kp_s[0] + h * a.kp_s[1],
              a.kp_s[2], a, k0, k1, false);
    load_rows(sV, static_cast<const bf16*>(a.vp) + b * a.vp_s[0] + h * a.vp_s[1],
              a.vp_s[2], a, k0, k1, false);
  } else {
    load_rows(sK, static_cast<const bf16*>(a.k) + b * a.k_s[0] + h * a.k_s[1],
              a.k_s[2], a, k0, k1, true);
    load_rows(sV, static_cast<const bf16*>(a.v) + b * a.v_s[0] + h * a.v_s[1],
              a.v_s[2], a, k0, k1, true);
  }

  // the packed query range [qlo, qhi) whose rows can reach these keys
  int qlo = k0, qhi = a.T;
  if (pfx) qlo = 0;
  else if (POLICY == POLICY_LINE) qhi = min(a.T, ((k1 - 1) / a.n + 1) * a.n);
  else if (POLICY == POLICY_CONV)
    qhi = min(a.T, ((k1 - 1) / a.grid + a.hw + 1) * a.grid);

  Acc accK[D / 16], accV[D / 16];
#pragma unroll
  for (int dc = 0; dc < D / 16; ++dc) {
    wmma::fill_fragment(accK[dc], 0.f);
    wmma::fill_fragment(accV[dc], 0.f);
  }

  for (int qs = qlo; qs < qhi; qs += BT) {
    const int qe = min(qs + BT, a.T);
    __syncthreads();  // previous query tile no longer read
    load_rows(sQ, qb, a.q_s[2], a, qs, qe, true);
    load_rows(sdO, dob, a.do_s[2], a, qs, qe, true);
    for (int i = threadIdx.x; i < BT; i += THREADS) {
      const int qj = qs + i;
      const int t = qj < qe ? raster_of(a, qj) : 0;
      sL[i] = qj < qe ? lse_b[t] : 0.f;
      sD[i] = qj < qe ? dd_b[t] : 0.f;
    }
    __syncthreads();

    rows_times_tile_t(sS + row0 * LDF, sK + row0 * LDB, sQ);    // S^T = K Q^T
    rows_times_tile_t(sdP + row0 * LDF, sV + row0 * LDB, sdO);  // dP^T = V dO^T
    __syncwarp();

#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int kj = k0 + row0 + r;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = lane + 32 * e;
        const int qj = qs + c;
        const bool ok = kj < k1 && qj < qe &&
                        (pfx || allowed<POLICY>(a, qj, kj));
        const int i = (row0 + r) * LDF + c;
        const float p = ok ? expf(sS[i] * a.scale - sL[c]) : 0.f;
        const bf16 ph = __float2bfloat16(p);
        const int j = (row0 + r) * LDB + c;
        sPh[j] = ph;
        sPl[j] = __float2bfloat16(p - __bfloat162float(ph));
        sdS[j] = __float2bfloat16(p * (sdP[i] - sD[c]));
      }
    }
    __syncwarp();

    accumulate_rows_times_tile(accV, sPh + row0 * LDB, sdO);  // dV += P^T dO
    accumulate_rows_times_tile(accV, sPl + row0 * LDB, sdO);
    accumulate_rows_times_tile(accK, sdS + row0 * LDB, sQ);   // dK += dS^T Q
  }

#pragma unroll
  for (int dc = 0; dc < D / 16; ++dc) {
    wmma::store_matrix_sync(sS + row0 * LDF + dc * 16, accK[dc], LDF,
                            wmma::mem_row_major);
    wmma::store_matrix_sync(sdP + row0 * LDF + dc * 16, accV[dc], LDF,
                            wmma::mem_row_major);
  }
  __syncwarp();

  bf16 *dkb, *dvb;
  long long dk_st, dv_st;
  if (pfx) {
    dkb = static_cast<bf16*>(a.dkp) + b * a.dkp_s[0] + h * a.dkp_s[1];
    dvb = static_cast<bf16*>(a.dvp) + b * a.dvp_s[0] + h * a.dvp_s[1];
    dk_st = a.dkp_s[2];
    dv_st = a.dvp_s[2];
  } else {
    dkb = static_cast<bf16*>(a.dk) + b * a.dk_s[0] + h * a.dk_s[1];
    dvb = static_cast<bf16*>(a.dv) + b * a.dv_s[0] + h * a.dv_s[1];
    dk_st = a.dk_s[2];
    dv_st = a.dv_s[2];
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int kj = k0 + row0 + r;
    if (kj >= k1) continue;
    const long long t = pfx ? kj : raster_of(a, kj);
    store_row(dkb, t, dk_st, sS + (row0 + r) * LDF, a.scale, lane);
    store_row(dvb, t, dv_st, sdP + (row0 + r) * LDF, 1.f, lane);
  }
}

template <int POLICY>
static int launch(const AttnBwdArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dq_kernel<POLICY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<POLICY>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)DKDV_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (a.T + BT - 1) / BT;
  const int pfx_tiles = a.kp ? (a.S + BT - 1) / BT : 0;
  attn_bwd_dq_kernel<POLICY>
      <<<dim3(tiles, a.H, a.B), THREADS, DQ_SMEM, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkdv_kernel<POLICY>
      <<<dim3(pfx_tiles + tiles, a.H, a.B), THREADS, DKDV_SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int attention_bwd(const AttnBwdArgs* a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((a->kp == nullptr) != (a->dkp == nullptr)) return (int)cudaErrorInvalidValue;
  switch (a->policy) {
    case POLICY_LINE: return launch<POLICY_LINE>(*a, s);
    case POLICY_CONV: return launch<POLICY_CONV>(*a, s);
    case POLICY_FULL: return launch<POLICY_FULL>(*a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* attention_bwd_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
