// Generic forward and backward [prefix || masked main-token] attention for
// the operands the fast kernels (attention_fwd.cu, attention_bwd.cu: bf16,
// head_dim 64) do not take: bf16 or f32 q/k/v and head_dim 16, 32, 64 or
// 128, one template instance per (dtype, head_dim) pair. ops/attention.py's
// attention_route picks the fast or the generic route before any launch.
//
// Replaces, for those operands, the TPU kernels of
// dalle_tpu/ops/pallas/attention_kernels.py, whose Pallas bodies take any
// dtype and head_dim: _line_attention_fwd/_bwd (POLICY_LINE: text-causal,
// axial_row, axial_col) and _window_attention_fwd/_bwd (POLICY_CONV,
// POLICY_FULL). The argument structs and the mask arithmetic are the fast
// kernels' (attention_common.cuh, its first section).
//
// Math, with the cast points of the plain versions (ops/attention.py):
// scores s = (q . k) * d^-1/2 in f32 from the operands; forward: P cast to
// the operand dtype before P.V (a no-op in f32), f32 accumulation, the
// division by the f32 denominator at the end, lse = m + log(denominator) in
// raster token order; backward: P = exp(s - lse) in f32, dd = rowsum(dO .
// O), dS = P (dP - dd) cast to the operand dtype before its products, dq =
// (dS . k) * scale over the prefix and the main keys, dk = (dS^T . q) *
// scale, dv = P^T . dO with P in f32. A masked key contributes P = 0, as
// the plain versions' -1e9 fill does; its score takes no part in the max.
//
// Design: simple SIMT kernels, FFMA with f32 accumulation. A block holds 8
// rows, one a warp (queries; keys in the dk/dv passes), and streams tiles
// of 32 rows of the other side through shared memory as f32, one row a
// lane: each lane forms its row's score with the warp's row (a D-long dot
// product; a row stride of D + 1 floats keeps the 32 lanes in 32 banks),
// the warp takes the online softmax's max and the row sums with shuffles,
// and the products are summed with the lanes over the head dims (D / 32 a
// lane; for D = 16 the upper 16 lanes idle there). The backward follows the
// fast kernels' pass split: a dq pass per query row (it also writes dd), a
// dk/dv pass per main key, recomputing P from lse, and with a prefix a
// dk/dv pass per prefix key over every query. Fixed order, no atomics: two
// runs give identical bits. The policy is a runtime argument (the mask is
// evaluated per score), so each (dtype, head_dim) pair is one instance of
// each of the four kernels.
//
// What bounds it: the generic route serves the tiny test models and f32
// models, where each call is small; these kernels are latency-bound and are
// meant to be right for every instance, not fast.

#include "attention_common.cuh"

namespace {

using attn::Geo;
using attn::POLICY_CONV;
using attn::POLICY_FULL;
using attn::POLICY_LINE;
using attn::raster_of;

constexpr int WARPS = 8;             // rows of a block, one a warp
constexpr int THREADS = 32 * WARPS;
constexpr int KT = 32;               // streamed rows a tile, one a lane
constexpr unsigned FULL_MASK = 0xffffffffu;

enum { DTYPE_F32 = 0, DTYPE_BF16 = 1 };  // mirrored by ops/attention.py

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

// x rounded to T and back: the plain versions' casts to the operand dtype.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

template <int P>
__device__ __forceinline__ bool allowed_as(const Geo& g, int qj, int kj) {
  return attn::allowed<P>(g, attn::pos_of<P>(g, qj), attn::pos_of<P>(g, kj));
}

// Whether main query qj may attend to main key kj (packed indices).
__device__ __forceinline__ bool may_attend(const Geo& g, int policy, int qj,
                                           int kj) {
  if (policy == POLICY_LINE) return allowed_as<POLICY_LINE>(g, qj, kj);
  if (policy == POLICY_CONV) return allowed_as<POLICY_CONV>(g, qj, kj);
  return allowed_as<POLICY_FULL>(g, qj, kj);
}

// The first main key that queries from q0 on can reach (packed indices).
__device__ __forceinline__ int keys_from(const Geo& g, int policy, int q0) {
  if (policy == POLICY_LINE) return q0 / g.n * g.n;
  if (policy == POLICY_CONV) return max(0, q0 / g.grid - g.hw) * g.grid;
  return 0;
}

// One past the last main query that keys before k1 can be reached by.
__device__ __forceinline__ int queries_to(const Geo& g, int policy, int k1,
                                          int T) {
  if (policy == POLICY_LINE) return min(T, ((k1 - 1) / g.n + 1) * g.n);
  if (policy == POLICY_CONV)
    return min(T, ((k1 - 1) / g.grid + g.hw + 1) * g.grid);
  return T;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

template <typename T>
__device__ __forceinline__ const T* at(const void* p, const long long* s,
                                       int b, int h) {
  return static_cast<const T*>(p) + b * s[0] + h * s[1];
}

template <typename T>
__device__ __forceinline__ T* at_out(void* p, const long long* s, int b,
                                     int h) {
  return static_cast<T*>(p) + b * s[0] + h * s[1];
}

// ROWS rows j0.. of a (.., T, D) operand into a row-major f32 tile with row
// stride LD; rows at or past j_end are zero. Packed rows (main tokens) sit
// at raster row raster_of(j), prefix rows at j.
template <typename T, int D, int LD, int ROWS>
__device__ __forceinline__ void load_rows(float* tile, const T* base,
                                          long long stride_t, const Geo& g,
                                          int j0, int j_end, bool packed) {
  for (int i = threadIdx.x; i < ROWS * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    const int j = j0 + r;
    float v = 0.f;
    if (j < j_end)
      v = to_f(base[(long long)(packed ? raster_of(g, j) : j) * stride_t + d]);
    tile[r * LD + d] = v;
  }
}

// f32 values of a (B, H, T) raster-order row vector (lse, dd) for ROWS
// packed rows j0.. (zero at or past j_end).
template <int ROWS>
__device__ __forceinline__ void load_vec(float* dst, const float* base,
                                         const Geo& g, int j0, int j_end,
                                         bool packed) {
  if (threadIdx.x < ROWS) {
    const int j = j0 + threadIdx.x;
    dst[threadIdx.x] =
        j < j_end ? base[packed ? raster_of(g, j) : j] : 0.f;
  }
}

// Writes a warp's row (lanes over the head dims, DL values a lane) as T.
template <typename T, int D, int DL>
__device__ __forceinline__ void store_row(T* row, const float (&v)[DL],
                                          float mul, int lane) {
#pragma unroll
  for (int i = 0; i < DL; ++i) {
    const int d = lane + 32 * i;
    if (d < D) row[d] = from_f<T>(v[i] * mul);
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attn_fwd_generic(AttnArgs a) {
  constexpr int DL = (D + 31) / 32;
  __shared__ float sQ[WARPS * D];
  __shared__ float sK[KT * (D + 1)];
  __shared__ float sV[KT * D];

  const Geo geo{a.n, a.grid, a.hw, a.transpose};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * WARPS, h = blockIdx.y, b = blockIdx.z;
  const int q1 = min(q0 + WARPS, a.T);
  const int qj = q0 + warp;
  const bool live = qj < q1;

  const T* kb = at<T>(a.k, a.k_s, b, h);
  const T* vb = at<T>(a.v, a.v_s, b, h);
  const T* kpb = a.kp ? at<T>(a.kp, a.kp_s, b, h) : nullptr;
  const T* vpb = a.vp ? at<T>(a.vp, a.vp_s, b, h) : nullptr;
  load_rows<T, D, D, WARPS>(sQ, at<T>(a.q, a.q_s, b, h), a.q_s[2], geo, q0,
                            q1, true);

  const int lo = keys_from(geo, a.policy, q0), hi = q1;
  const int n_pfx = a.kp ? (a.S + KT - 1) / KT : 0;
  const int n_tiles = n_pfx + (hi - lo + KT - 1) / KT;
  const float* q = sQ + warp * D;
  float m = -INFINITY, l = 0.f, o[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) o[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const bool pfx = it < n_pfx;
    const int k0 = pfx ? it * KT : lo + (it - n_pfx) * KT;
    const int ke = min(k0 + KT, pfx ? a.S : hi);
    __syncthreads();  // the previous tile is consumed
    if (pfx) {
      load_rows<T, D, D + 1, KT>(sK, kpb, a.kp_s[2], geo, k0, ke, false);
      load_rows<T, D, D, KT>(sV, vpb, a.vp_s[2], geo, k0, ke, false);
    } else {
      load_rows<T, D, D + 1, KT>(sK, kb, a.k_s[2], geo, k0, ke, true);
      load_rows<T, D, D, KT>(sV, vb, a.v_s[2], geo, k0, ke, true);
    }
    __syncthreads();
    if (!live) continue;

    const int kj = k0 + lane;
    float s = -INFINITY;
    if (kj < ke && (pfx || may_attend(geo, a.policy, qj, kj))) {
      const float* kr = sK + lane * (D + 1);
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot += q[d] * kr[d];
      s = dot * a.scale;
    }
    const float mx = warp_max(s);
    if (mx == -INFINITY) continue;  // no key of the tile reaches the row
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);  // 0 while m is -inf
    const float p = expf(s - m_new);      // 0 for an absent key
    m = m_new;
    l = l * alpha + p;  // this lane's keys; summed over the warp at the end
    const float pv = round_to<T>(p);
#pragma unroll
    for (int i = 0; i < DL; ++i) o[i] *= alpha;
    for (int kk = 0; kk < ke - k0; ++kk) {
      const float pk = __shfl_sync(FULL_MASK, pv, kk);
#pragma unroll
      for (int i = 0; i < DL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) o[i] += pk * sV[kk * D + d];
      }
    }
  }
  if (!live) return;

  l = warp_sum(l);
  const int t = raster_of(geo, qj);
  store_row<T, D, DL>(at_out<T>(a.out, a.o_s, b, h) + t * a.o_s[2], o,
                      1.f / l, lane);
  if (lane == 0) a.lse[((long long)b * a.H + h) * a.T + t] = m + logf(l);
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// dq pass (query-major): one warp a query row walks the keys its row can
// reach (the prefix, then the main keys), accumulating dS . k; also writes
// the row's dd = rowsum(dO . O) for the dk/dv passes.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dq_generic(AttnBwdArgs a) {
  constexpr int DL = (D + 31) / 32;
  __shared__ float sQ[WARPS * D];
  __shared__ float sG[WARPS * D];
  __shared__ float sK[KT * (D + 1)];
  __shared__ float sV[KT * (D + 1)];

  const Geo geo{a.n, a.grid, a.hw, a.transpose};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * WARPS, h = blockIdx.y, b = blockIdx.z;
  const int q1 = min(q0 + WARPS, a.T);
  const int qj = q0 + warp;
  const bool live = qj < q1;
  const long long vec0 = ((long long)b * a.H + h) * a.T;

  const T* kb = at<T>(a.k, a.k_s, b, h);
  const T* vb = at<T>(a.v, a.v_s, b, h);
  const T* kpb = a.kp ? at<T>(a.kp, a.kp_s, b, h) : nullptr;
  const T* vpb = a.vp ? at<T>(a.vp, a.vp_s, b, h) : nullptr;
  load_rows<T, D, D, WARPS>(sQ, at<T>(a.q, a.q_s, b, h), a.q_s[2], geo, q0,
                            q1, true);
  load_rows<T, D, D, WARPS>(sG, at<T>(a.dout, a.do_s, b, h), a.do_s[2], geo,
                            q0, q1, true);
  __syncthreads();

  const int t = live ? raster_of(geo, qj) : 0;
  const float* q = sQ + warp * D;
  const float* g = sG + warp * D;
  float dd = 0.f, lse = 0.f;
  if (live) {
    const T* orow = at<T>(a.o, a.o_s, b, h) + t * a.o_s[2];
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) part += g[d] * to_f(orow[d]);
    }
    dd = warp_sum(part);
    lse = a.lse[vec0 + t];
    if (lane == 0) a.dd[vec0 + t] = dd;
  }

  const int lo = keys_from(geo, a.policy, q0), hi = q1;
  const int n_pfx = a.kp ? (a.S + KT - 1) / KT : 0;
  const int n_tiles = n_pfx + (hi - lo + KT - 1) / KT;
  float acc[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) acc[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const bool pfx = it < n_pfx;
    const int k0 = pfx ? it * KT : lo + (it - n_pfx) * KT;
    const int ke = min(k0 + KT, pfx ? a.S : hi);
    __syncthreads();
    if (pfx) {
      load_rows<T, D, D + 1, KT>(sK, kpb, a.kp_s[2], geo, k0, ke, false);
      load_rows<T, D, D + 1, KT>(sV, vpb, a.vp_s[2], geo, k0, ke, false);
    } else {
      load_rows<T, D, D + 1, KT>(sK, kb, a.k_s[2], geo, k0, ke, true);
      load_rows<T, D, D + 1, KT>(sV, vb, a.v_s[2], geo, k0, ke, true);
    }
    __syncthreads();
    if (!live) continue;

    const int kj = k0 + lane;
    float ds = 0.f;
    if (kj < ke && (pfx || may_attend(geo, a.policy, qj, kj))) {
      const float* kr = sK + lane * (D + 1);
      const float* vr = sV + lane * (D + 1);
      float sdot = 0.f, pdot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        sdot += q[d] * kr[d];
        pdot += g[d] * vr[d];
      }
      const float p = expf(sdot * a.scale - lse);
      ds = round_to<T>(p * (pdot - dd));
    }
    for (int kk = 0; kk < ke - k0; ++kk) {
      const float dk = __shfl_sync(FULL_MASK, ds, kk);
#pragma unroll
      for (int i = 0; i < DL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc[i] += dk * sK[kk * (D + 1) + d];
      }
    }
  }
  if (!live) return;
  store_row<T, D, DL>(at_out<T>(a.dq, a.dq_s, b, h) + t * a.dq_s[2], acc,
                      a.scale, lane);
}

// dk/dv pass (key-major): one warp a key walks the queries that reach it,
// recomputing P from lse. PREFIX: the prefix keys over every main query (no
// mask, raster order); else the main keys over their lines, conv rows or
// causal future (packed order).
template <typename T, int D, bool PREFIX>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dkdv_generic(AttnBwdArgs a) {
  constexpr int DL = (D + 31) / 32;
  __shared__ float sK[WARPS * D];
  __shared__ float sV[WARPS * D];
  __shared__ float sQ[KT * (D + 1)];
  __shared__ float sG[KT * (D + 1)];
  __shared__ float sL[KT];
  __shared__ float sDD[KT];

  const Geo geo{a.n, a.grid, a.hw, a.transpose};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * WARPS, h = blockIdx.y, b = blockIdx.z;
  const int k1 = min(k0 + WARPS, PREFIX ? a.S : a.T);
  const int kj = k0 + warp;
  const bool live = kj < k1;
  const long long vec0 = ((long long)b * a.H + h) * a.T;

  if (PREFIX) {
    load_rows<T, D, D, WARPS>(sK, at<T>(a.kp, a.kp_s, b, h), a.kp_s[2], geo,
                              k0, k1, false);
    load_rows<T, D, D, WARPS>(sV, at<T>(a.vp, a.vp_s, b, h), a.vp_s[2], geo,
                              k0, k1, false);
  } else {
    load_rows<T, D, D, WARPS>(sK, at<T>(a.k, a.k_s, b, h), a.k_s[2], geo, k0,
                              k1, true);
    load_rows<T, D, D, WARPS>(sV, at<T>(a.v, a.v_s, b, h), a.v_s[2], geo, k0,
                              k1, true);
  }
  const T* qb = at<T>(a.q, a.q_s, b, h);
  const T* dob = at<T>(a.dout, a.do_s, b, h);
  const int i_lo = PREFIX ? 0 : k0;
  const int i_hi = PREFIX ? a.T : queries_to(geo, a.policy, k1, a.T);
  const int n_tiles = (i_hi - i_lo + KT - 1) / KT;
  const float* k = sK + warp * D;
  const float* v = sV + warp * D;
  float dk[DL], dv[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) dk[i] = dv[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int i0 = i_lo + it * KT, ie = min(i0 + KT, i_hi);
    __syncthreads();
    load_rows<T, D, D + 1, KT>(sQ, qb, a.q_s[2], geo, i0, ie, !PREFIX);
    load_rows<T, D, D + 1, KT>(sG, dob, a.do_s[2], geo, i0, ie, !PREFIX);
    load_vec<KT>(sL, a.lse + vec0, geo, i0, ie, !PREFIX);
    load_vec<KT>(sDD, a.dd + vec0, geo, i0, ie, !PREFIX);
    __syncthreads();
    if (!live) continue;

    const int qi = i0 + lane;
    float p = 0.f, ds = 0.f;
    if (qi < ie && (PREFIX || may_attend(geo, a.policy, qi, kj))) {
      const float* qr = sQ + lane * (D + 1);
      const float* gr = sG + lane * (D + 1);
      float sdot = 0.f, pdot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        sdot += qr[d] * k[d];
        pdot += gr[d] * v[d];
      }
      p = expf(sdot * a.scale - sL[lane]);
      ds = round_to<T>(p * (pdot - sDD[lane]));
    }
    for (int qq = 0; qq < ie - i0; ++qq) {
      const float pq = __shfl_sync(FULL_MASK, p, qq);
      const float dsq = __shfl_sync(FULL_MASK, ds, qq);
#pragma unroll
      for (int i = 0; i < DL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) {
          dk[i] += dsq * sQ[qq * (D + 1) + d];
          dv[i] += pq * sG[qq * (D + 1) + d];
        }
      }
    }
  }
  if (!live) return;
  if (PREFIX) {
    store_row<T, D, DL>(at_out<T>(a.dkp, a.dkp_s, b, h) + kj * a.dkp_s[2],
                        dk, a.scale, lane);
    store_row<T, D, DL>(at_out<T>(a.dvp, a.dvp_s, b, h) + kj * a.dvp_s[2],
                        dv, 1.f, lane);
  } else {
    const int t = raster_of(geo, kj);
    store_row<T, D, DL>(at_out<T>(a.dk, a.dk_s, b, h) + t * a.dk_s[2], dk,
                        a.scale, lane);
    store_row<T, D, DL>(at_out<T>(a.dv, a.dv_s, b, h) + t * a.dv_s[2], dv,
                        1.f, lane);
  }
}

template <typename T, int D>
int launch_fwd(const AttnArgs& a, cudaStream_t s) {
  const dim3 grid((a.T + WARPS - 1) / WARPS, a.H, a.B);
  attn_fwd_generic<T, D><<<grid, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_bwd(const AttnBwdArgs& a, cudaStream_t s) {
  const dim3 grid((a.T + WARPS - 1) / WARPS, a.H, a.B);
  attn_bwd_dq_generic<T, D><<<grid, THREADS, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkdv_generic<T, D, false><<<grid, THREADS, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || !a.kp) return (int)err;
  const dim3 pgrid((a.S + WARPS - 1) / WARPS, a.H, a.B);
  attn_bwd_dkdv_generic<T, D, true><<<pgrid, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// The (dtype, head_dim) instances; anything else is refused.
#define ATTN_GENERIC_DISPATCH(LAUNCH, ARGS, STREAM)                      \
  switch (head_dim * 2 + (dtype == DTYPE_BF16)) {                        \
    case 32: return LAUNCH<float, 16>(ARGS, STREAM);                     \
    case 33: return LAUNCH<bf16, 16>(ARGS, STREAM);                      \
    case 64: return LAUNCH<float, 32>(ARGS, STREAM);                     \
    case 65: return LAUNCH<bf16, 32>(ARGS, STREAM);                      \
    case 128: return LAUNCH<float, 64>(ARGS, STREAM);                    \
    case 129: return LAUNCH<bf16, 64>(ARGS, STREAM);                     \
    case 256: return LAUNCH<float, 128>(ARGS, STREAM);                   \
    case 257: return LAUNCH<bf16, 128>(ARGS, STREAM);                    \
    default: return (int)cudaErrorInvalidValue;                          \
  }

extern "C" int attention_generic_fwd(const AttnArgs* a, int dtype,
                                     int head_dim, void* stream) {
  if (dtype != DTYPE_F32 && dtype != DTYPE_BF16)
    return (int)cudaErrorInvalidValue;
  ATTN_GENERIC_DISPATCH(launch_fwd, *a, static_cast<cudaStream_t>(stream))
}

extern "C" int attention_generic_bwd(const AttnBwdArgs* a, int dtype,
                                     int head_dim, void* stream) {
  if (dtype != DTYPE_F32 && dtype != DTYPE_BF16)
    return (int)cudaErrorInvalidValue;
  ATTN_GENERIC_DISPATCH(launch_bwd, *a, static_cast<cudaStream_t>(stream))
}

extern "C" const char* attention_generic_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
