// Forward [prefix || masked main-token] attention for the DALL-E attention
// zoo: one templated kernel, three key-range and mask policies.
//
// Replaces the TPU kernels of dalle_tpu/ops/pallas/attention_kernels.py:
//   POLICY_LINE  -> _line_attention_fwd (_fwd_kernel / _fwd_nopfx_kernel):
//                   text-causal (one line of T tokens, no prefix), axial_row
//                   (lines are raster rows) and axial_col (lines are raster
//                   columns, read with strides instead of the TPU path's two
//                   relayout copies in _bhtd);
//   POLICY_CONV  -> _window_attention_fwd with hw = conv_kernel / 2;
//   POLICY_FULL  -> _window_attention_fwd with hw = None (plain causal).
//
// Math (kept from the TPU kernel): scores s = (q . k) * d^-1/2 in f32, masked
// entries filled with -1e9 (not -inf), softmax statistics in f32, P cast to
// bf16 before P.V with an f32 accumulator, the output divided by the f32
// denominator at the end, and the row logsumexp m + log(denominator) written
// beside the output. The softmax is taken online over key tiles (running
// max, rescaled denominator and accumulator), the TPU kernel's single-tile
// max being replaced by the running one.
//
// What bounds it on the card: at the flagship (B=4, H=16, d=64) every call
// moves tens of MB (q, k, v, the 256-token text prefix, out, lse) for a few
// GFLOP, below the H100's ~295 FLOP/byte ridge, so the floor is memory
// bandwidth. The design reads each query tile once, streams only the keys
// its policy can reach (the prefix plus the tile's own lines, its conv
// window rows, or its causal past), keeps scores and probabilities in shared
// memory and never writes them to device memory. Tensor-core work is bf16
// WMMA (16x16x16, f32 accumulate).
//
// One block of 4 warps per (query tile of 64 rows, head, batch); each warp
// owns 16 query rows. Layout: every tensor is (B, H, T, 64) bf16 with
// arbitrary element strides for b, h, t and unit stride along d, so
// (B, T, H, d) activations are read in place through a transposed view.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int D = 64;     // head dim
constexpr int BQ = 64;    // query rows per block
constexpr int BK = 64;    // keys per tile
constexpr int LDB = D + 8;   // bf16 shared-memory row pitch (elements)
constexpr int LDF = BK + 4;  // f32 shared-memory row pitch (elements)
constexpr int THREADS = 128;
constexpr float NEG_FILL = -1e9f;

enum { POLICY_LINE = 0, POLICY_CONV = 1, POLICY_FULL = 2 };

constexpr size_t SMEM_BYTES =
    4 * BQ * LDB * sizeof(bf16) + 2 * BQ * LDF * sizeof(float);

}  // namespace

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* kp;  // prefix keys (B, H, S, d) or null
  const void* vp;
  void* out;       // (B, H, T, d) bf16
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

// Raster token index of the packed index j (lines contiguous in j).
__device__ __forceinline__ int raster_of(const AttnArgs& a, int j) {
  if (a.transpose) return (j % a.n) * a.grid + j / a.n;
  return j;
}

template <int POLICY>
__device__ __forceinline__ bool allowed(const AttnArgs& a, int qj, int kj) {
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
                                          long long stride_t, const AttnArgs& a,
                                          int j0, int j_end, bool packed) {
  // rows j0..j0+63 of a (.., T, 64) operand into a [64][LDB] tile, 16-byte
  // vectors, zeros past j_end
  for (int c = threadIdx.x; c < 64 * (D / 8); c += THREADS) {
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

template <int POLICY>
__global__ void __launch_bounds__(THREADS)
attn_fwd_kernel(AttnArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BQ * LDB;
  bf16* sV = sK + BK * LDB;
  bf16* sP = sV + BK * LDB;
  float* sS = reinterpret_cast<float*>(sP + BQ * LDB);
  float* sO = sS + BQ * LDF;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q1 = min(q0 + BQ, a.T);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * 16;

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_s[0] + h * a.q_s[1];
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_s[0] + h * a.k_s[1];
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_s[0] + h * a.v_s[1];
  bf16* ob = static_cast<bf16*>(a.out) + b * a.o_s[0] + h * a.o_s[1];

  load_rows(sQ, qb, a.q_s[2], a, q0, q1, true);
  for (int i = threadIdx.x; i < BQ * LDF; i += THREADS) sO[i] = 0.f;

  float m_run[16], l_run[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
  }

  // key range over packed main-token indices [lo, hi)
  int lo = 0;
  if (POLICY == POLICY_LINE) lo = (q0 / a.n) * a.n;
  if (POLICY == POLICY_CONV) lo = max(0, q0 / a.grid - a.hw) * a.grid;
  const int hi = q1;
  const int n_pfx = a.kp ? (a.S + BK - 1) / BK : 0;
  const int n_main = (hi - lo + BK - 1) / BK;

  for (int it = 0; it < n_pfx + n_main; ++it) {
    const bool pfx = it < n_pfx;
    const int k0 = pfx ? it * BK : lo + (it - n_pfx) * BK;
    __syncthreads();  // previous tile's K/V/P no longer read
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

    // S = Q K^T for this warp's 16 rows x 64 keys
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int dk = 0; dk < D / 16; ++dk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, sQ + row0 * LDB + dk * 16, LDB);
        wmma::load_matrix_sync(fb, sK + kc * 16 * LDB + dk * 16, LDB);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sS + row0 * LDF + kc * 16, acc, LDF,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over the tile, one row at a time across the warp
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int qj = q0 + row0 + r;
      float s[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = lane + 32 * e;
        const int kj = k0 + c;
        bool ok;
        if (pfx) ok = kj < a.S;
        else ok = kj < hi && allowed<POLICY>(a, qj, kj);
        s[e] = ok ? sS[(row0 + r) * LDF + c] * a.scale : NEG_FILL;
      }
      float mx = fmaxf(s[0], s[1]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[r], mx);
      const float alpha = expf(m_run[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = lane + 32 * e;
        const float p = expf(s[e] - m_new);
        sum += p;
        sP[(row0 + r) * LDB + c] = __float2bfloat16(p);
        sO[(row0 + r) * LDF + c] *= alpha;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run[r] = l_run[r] * alpha + sum;
      m_run[r] = m_new;
    }
    __syncwarp();

    // O += P V for this warp's 16 rows
#pragma unroll
    for (int dc = 0; dc < D / 16; ++dc) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, sO + row0 * LDF + dc * 16, LDF,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, sP + row0 * LDB + kk * 16, LDB);
        wmma::load_matrix_sync(fb, sV + kk * 16 * LDB + dc * 16, LDB);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sO + row0 * LDF + dc * 16, acc, LDF,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }

  // out = O / denominator (bf16), lse = m + log(denominator)
  float* lse_b = a.lse + ((long long)b * a.H + h) * a.T;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int qj = q0 + row0 + r;
    if (qj >= q1) continue;
    const int t = raster_of(a, qj);
    const float denom = l_run[r];
    const float2 o = make_float2(sO[(row0 + r) * LDF + 2 * lane] / denom,
                                 sO[(row0 + r) * LDF + 2 * lane + 1] / denom);
    *reinterpret_cast<__nv_bfloat162*>(ob + (long long)t * a.o_s[2] + 2 * lane) =
        __float22bfloat162_rn(o);
    if (lane == 0) lse_b[t] = m_run[r] + logf(denom);
  }
}

template <int POLICY>
static int launch(const AttnArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel<POLICY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.T + BQ - 1) / BQ, a.H, a.B);
  attn_fwd_kernel<POLICY><<<grid, THREADS, SMEM_BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int attention_fwd(const AttnArgs* a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a->policy) {
    case POLICY_LINE: return launch<POLICY_LINE>(*a, s);
    case POLICY_CONV: return launch<POLICY_CONV>(*a, s);
    case POLICY_FULL: return launch<POLICY_FULL>(*a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* attention_fwd_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
