// Backward [prefix || masked main-token] attention for the DALL-E attention
// zoo: three templated kernels, the same three key-range and mask policies
// as attention_fwd.cu.
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
// overlapping query groups in (T, d) f32 scratch, which no Hopper SM can
// hold. Here the work splits FA2-style into passes with no atomics, so every
// output is written by exactly one thread and two runs give identical bits
// (three launches per call):
//
//   attn_bwd_dq_kernel          (query-major): one block per 64 query rows
//                               walks the key tiles its rows reach (the
//                               prefix, then its lines / conv window /
//                               causal past), writes dq and the rows' dd;
//   attn_bwd_dkdv_kernel        (key-major): one block per 64 main keys
//                               walks the query tiles that reach them (the
//                               keys' own lines, the conv rows below, the
//                               causal future);
//   attn_bwd_dkdv_prefix_kernel (key-major, clusters): each 64-key tile of
//                               the prefix, which every query reaches, is a
//                               cluster of 4 blocks; each walks a quarter of
//                               the query tiles and keeps partial dk/dv, and
//                               the cluster sums the partials in rank order
//                               through distributed shared memory, each
//                               block reducing and writing 16 of the keys.
//
// What bounds it on the card: at the flagship (B=4, H=16, d=64) a layer's
// backward moves a few MB (q, k, v, O, dO, lse in; dq, dk, dv, dkp, dvp out)
// for about a GFLOP, below the ~295 FLOP/byte ridge: memory bandwidth; a
// block walks few tiles, so the latency of each tile's loads and of the
// elementwise work between its products is what has to be hidden. The
// design, shared with the forward (attention_common.cuh): mma.sync.m16n8k16
// with S, dP, P, dS and the dq (or dk, dv) accumulators in registers, the
// elementwise results converted in place to the A fragments of the next
// product (P^T, dS^T and the hi/lo split of P in the dk/dv passes); the
// streamed tiles (K/V in the dq pass; Q, dO, lse, dd in the dk/dv passes)
// through a 2-stage cp.async ring of XOR-swizzled tiles; warp-uniform skips
// of unreachable tiles and masks only on tiles that cross an edge. The
// prefix's dk/dv, whose 256 long walks over all 16 query tiles set the old
// pass's critical path, run as 4-block clusters: ~4 tile-steps a block.
// Layout: every tensor (B, H, T, 64) bf16 with arbitrary b, h, t element
// strides and unit stride along d.

#include <cooperative_groups.h>

#include "attention_common.cuh"

using namespace attn;
namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 4;  // blocks per prefix key tile
static_assert((2 * (BT / CLUSTER) * (D / 4)) % THREADS == 0,
              "the cluster reduction splits evenly over a block");
constexpr size_t VEC_BYTES = BT * sizeof(float);
// Q, dO, 2 x K, 2 x V; lse and dd of the block's rows
constexpr size_t DQ_SMEM = 6 * TILE * sizeof(bf16) + 2 * VEC_BYTES;
// K, V, 2 x Q, 2 x dO; 2 x lse, 2 x dd of the streamed query rows
constexpr size_t DKDV_SMEM = 6 * TILE * sizeof(bf16) + 4 * VEC_BYTES;
// blocks an SM keeps of the dk/dv passes: caps their registers at 168 (they
// take 168-175 uncapped, which fits only 2 blocks; 3 measured ~9% faster)
constexpr int DKDV_BLOCKS = 3;
// the prefix's partial dk and dv (f32) reuse the query ring
static_assert(2 * BT * D * sizeof(float) <= 4 * TILE * sizeof(bf16),
              "prefix partials must fit in the query ring");

}  // namespace

template <typename T>
__device__ __forceinline__ T* at(const void* p, const long long* s, int b,
                                 int h) {
  return const_cast<T*>(static_cast<const T*>(p)) + b * s[0] + h * s[1];
}

// dd = rowsum(dO . O) (f32) and lse of a warp's 16 query rows w0..w0+15
// into sDD / sL (rows at or past q1 get 0); dd also to device memory for
// the dk/dv passes. Lanes 8i..8i+7 take one row's eight 16-byte chunks.
__device__ __forceinline__ void row_stats(const AttnBwdArgs& a, const Geo& geo,
                                          const bf16* ob, const bf16* dob,
                                          const float* lse_b, float* dd_b,
                                          float* sL, float* sDD, int row0,
                                          int w0, int q1, int lane) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = (lane >> 3) + 4 * i, ch = lane & 7;
    const int qj = w0 + r;
    const int t = qj < q1 ? raster_of(geo, qj) : 0;
    float part = 0.f;
    if (qj < q1) {
      const uint4 ov = *reinterpret_cast<const uint4*>(
          ob + (long long)t * a.o_s[2] + ch * 8);
      const uint4 gv = *reinterpret_cast<const uint4*>(
          dob + (long long)t * a.do_s[2] + ch * 8);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 of = __bfloat1622float2(o2[e]);
        const float2 gf = __bfloat1622float2(g2[e]);
        part += of.x * gf.x;
        part += of.y * gf.y;
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    part += __shfl_xor_sync(0xffffffffu, part, 4);
    if (ch == 0) {
      sDD[row0 + r] = part;
      sL[row0 + r] = qj < q1 ? lse_b[t] : 0.f;
      if (qj < q1) dd_b[t] = part;
    }
  }
}

template <int POLICY>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dq_kernel(AttnBwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + TILE;
  bf16* sK = sdO + TILE;     // 2 stages
  bf16* sV = sK + 2 * TILE;  // 2 stages
  float* sL = reinterpret_cast<float*>(sV + 2 * TILE);
  float* sDD = sL + BT;

  const Geo geo{a.n, a.grid, a.hw, a.transpose};
  const int q0 = blockIdx.x * BT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q1 = min(q0 + BT, a.T);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = warp * 16;

  const bf16* qb = at<bf16>(a.q, a.q_s, b, h);
  const bf16* kb = at<bf16>(a.k, a.k_s, b, h);
  const bf16* vb = at<bf16>(a.v, a.v_s, b, h);
  const bf16* ob = at<bf16>(a.o, a.o_s, b, h);
  const bf16* dob = at<bf16>(a.dout, a.do_s, b, h);
  const bf16* kpb = a.kp ? at<bf16>(a.kp, a.kp_s, b, h) : nullptr;
  const bf16* vpb = a.vp ? at<bf16>(a.vp, a.vp_s, b, h) : nullptr;
  const float* lse_b = a.lse + ((long long)b * a.H + h) * a.T;
  float* dd_b = a.dd + ((long long)b * a.H + h) * a.T;

  int lo = 0;
  if (POLICY == POLICY_LINE) lo = (q0 / a.n) * a.n;
  if (POLICY == POLICY_CONV) lo = max(0, q0 / a.grid - a.hw) * a.grid;
  const int hi = q1;
  const int n_pfx = a.kp ? (a.S + BT - 1) / BT : 0;
  const int n_tiles = n_pfx + (hi - lo + BT - 1) / BT;

  auto issue = [&](int it) {
    bf16* k_dst = sK + (it & 1) * TILE;
    bf16* v_dst = sV + (it & 1) * TILE;
    if (it < n_pfx) {
      load_tile(k_dst, kpb, a.kp_s[2], geo, it * BT, a.S, false);
      load_tile(v_dst, vpb, a.vp_s[2], geo, it * BT, a.S, false);
    } else {
      const int k0 = lo + (it - n_pfx) * BT;
      load_tile(k_dst, kb, a.k_s[2], geo, k0, hi, true);
      load_tile(v_dst, vb, a.v_s[2], geo, k0, hi, true);
    }
  };
  load_tile(sQ, qb, a.q_s[2], geo, q0, q1, true);
  load_tile(sdO, dob, a.do_s[2], geo, q0, q1, true);
  issue(0);
  cp_async_commit();

  const int w0 = q0 + row0, wl = min(w0 + 15, q1 - 1);
  const bool live = w0 < q1;
  row_stats(a, geo, ob, dob, lse_b, dd_b, sL, sDD, row0, w0, q1, lane);
  __syncwarp();
  const float lr[2] = {sL[row0 + g], sL[row0 + g + 8]};
  const float ddr[2] = {sDD[row0 + g], sDD[row0 + g + 8]};
  const Pos qp[2] = {pos_of<POLICY>(geo, w0 + g), pos_of<POLICY>(geo, w0 + g + 8)};
  const int w0_row = POLICY == POLICY_CONV ? w0 / a.grid : 0;
  const int wl_ls = POLICY == POLICY_LINE ? wl - wl % a.n : 0;

  uint32_t qf[4][4], df[4][4];
  float dq[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[nt][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile it landed; tile it-1's stage no longer read
    if (it + 1 < n_tiles) {
      issue(it + 1);
      cp_async_commit();
    }
    if (it == 0 && live) {
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        load_a(qf[kc], sQ, row0, kc, lane);
        load_a(df[kc], sdO, row0, kc, lane);
      }
    }
    const bool pfx = it < n_pfx;
    const int k0 = pfx ? it * BT : lo + (it - n_pfx) * BT;
    const int ke = min(k0 + BT, pfx ? a.S : hi);

    bool reach = live, full = ke == k0 + BT;
    if (!pfx) {
      reach = reach && k0 <= wl;
      full = full && ke - 1 <= w0;
      if (POLICY == POLICY_LINE) {
        reach = reach && ke - 1 >= w0 - w0 % a.n;
        full = full && k0 >= wl_ls;
      }
      if (POLICY == POLICY_CONV) {
        reach = reach && (ke - 1) / a.grid >= w0_row - a.hw;
        full = false;
      }
    }
    if (!reach) continue;

    const bf16* tK = sK + (it & 1) * TILE;
    const bf16* tV = sV + (it & 1) * TILE;
    Pos kpos = pos_of<POLICY>(geo, k0 + 2 * t4);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {  // keys 16kc..16kc+15
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int dc = 0; dc < 4; ++dc) {
        uint32_t bk[4], bv[4];
        load_bt(bk, tK, kc, dc, lane);
        mma16816(s[0], qf[dc], bk[0], bk[1]);
        mma16816(s[1], qf[dc], bk[2], bk[3]);
        load_bt(bv, tV, kc, dc, lane);
        mma16816(dp[0], df[dc], bv[0], bv[1]);
        mma16816(dp[1], df[dc], bv[2], bv[3]);
      }
      float ds[2][4];
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
          ds[n][e] = p * (dp[n][e] - ddr[e >> 1]);
        }
        if (kc < 3 || n == 0) kpos = step<POLICY>(geo, kpos, 8);
      }
      // dQ += dS K: dS in registers as an A fragment, K read transposed
      uint32_t da[4];
      acc_to_a(da, ds[0], ds[1]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        load_b(bk, tK, kc, np, lane);
        mma16816(dq[2 * np], da, bk[0], bk[1]);
        mma16816(dq[2 * np + 1], da, bk[2], bk[3]);
      }
    }
  }
  if (!live) return;

  // dq = acc * scale, staged in the warp's own Q rows for 16-byte stores
  __syncwarp();
  stage_rows(sQ, dq, a.scale, row0, lane);
  __syncwarp();
  store_rows(at<bf16>(a.dq, a.dq_s, b, h), a.dq_s[2], sQ, geo, row0, q0, q1,
             true, lane);
}

// The key-major walk shared by the two dk/dv kernels: keys k0..k1-1 (the
// prefix when PFX, else main tokens), query tiles starting at qlo, qlo+64,
// ... below qhi; dk (unscaled) and dv of this warp's 16 keys in registers.
template <int POLICY, bool PFX>
__device__ __forceinline__ void dkdv_walk(const AttnBwdArgs& a,
                                          unsigned char* smem, int b, int h,
                                          int k0, int k1, int qlo, int qhi,
                                          float (&dk)[8][4],
                                          float (&dv)[8][4]) {
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + TILE;
  bf16* sQ = sV + TILE;       // 2 stages
  bf16* sdO = sQ + 2 * TILE;  // 2 stages
  float* sL = reinterpret_cast<float*>(sdO + 2 * TILE);  // 2 stages
  float* sDD = sL + 2 * BT;                               // 2 stages

  const Geo geo{a.n, a.grid, a.hw, a.transpose};
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = warp * 16;
  const bf16* qb = at<bf16>(a.q, a.q_s, b, h);
  const bf16* dob = at<bf16>(a.dout, a.do_s, b, h);
  const float* lse_b = a.lse + ((long long)b * a.H + h) * a.T;
  const float* dd_b = a.dd + ((long long)b * a.H + h) * a.T;

  if (PFX) {
    load_tile(sK, at<bf16>(a.kp, a.kp_s, b, h), a.kp_s[2], geo, k0, k1, false);
    load_tile(sV, at<bf16>(a.vp, a.vp_s, b, h), a.vp_s[2], geo, k0, k1, false);
  } else {
    load_tile(sK, at<bf16>(a.k, a.k_s, b, h), a.k_s[2], geo, k0, k1, true);
    load_tile(sV, at<bf16>(a.v, a.v_s, b, h), a.v_s[2], geo, k0, k1, true);
  }
  const int n_tiles = qhi > qlo ? (qhi - qlo + BT - 1) / BT : 0;
  auto issue = [&](int it) {
    const int qs = qlo + it * BT, qe = min(qs + BT, a.T);
    const int st = it & 1;
    load_tile(sQ + st * TILE, qb, a.q_s[2], geo, qs, qe, true);
    load_tile(sdO + st * TILE, dob, a.do_s[2], geo, qs, qe, true);
    load_vec(sL + st * BT, lse_b, geo, qs, qe);
    load_vec(sDD + st * BT, dd_b, geo, qs, qe);
  };
  if (n_tiles > 0) issue(0);
  cp_async_commit();

#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.f;

  const int kw0 = k0 + row0, kwl = min(kw0 + 15, k1 - 1);
  const bool live = kw0 < k1;
  const Pos kp2[2] = {pos_of<POLICY>(geo, kw0 + g), pos_of<POLICY>(geo, kw0 + g + 8)};
  const int kwl_row = POLICY == POLICY_CONV ? kwl / a.grid : 0;
  uint32_t kf[4][4], vf[4][4];

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile it landed; tile it-1's stage no longer read
    if (it + 1 < n_tiles) {
      issue(it + 1);
      cp_async_commit();
    }
    if (it == 0 && live) {
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        load_a(kf[kc], sK, row0, kc, lane);
        load_a(vf[kc], sV, row0, kc, lane);
      }
    }
    const int qs = qlo + it * BT, qe = min(qs + BT, a.T);

    bool reach = live, full = qe == qs + BT;
    if (!PFX) {
      reach = reach && qe - 1 >= kw0;
      full = full && kwl <= qs;
      if (POLICY == POLICY_LINE) {
        reach = reach && qs - qs % a.n <= kwl;
        full = full && (qe - 1) - (qe - 1) % a.n <= kw0;
      }
      if (POLICY == POLICY_CONV) {
        reach = reach && kwl_row >= qs / a.grid - a.hw;
        full = false;
      }
    }
    if (!reach) continue;

    const int st = it & 1;
    const bf16* tQ = sQ + st * TILE;
    const bf16* tdO = sdO + st * TILE;
    const float* tL = sL + st * BT;
    const float* tDD = sDD + st * BT;
    Pos qpos = pos_of<POLICY>(geo, qs + 2 * t4);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {  // queries 16kc..16kc+15
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 16 queries
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int dc = 0; dc < 4; ++dc) {
        uint32_t bq[4], bo[4];
        load_bt(bq, tQ, kc, dc, lane);
        mma16816(s[0], kf[dc], bq[0], bq[1]);
        mma16816(s[1], kf[dc], bq[2], bq[3]);
        load_bt(bo, tdO, kc, dc, lane);
        mma16816(dp[0], vf[dc], bo[0], bo[1]);
        mma16816(dp[1], vf[dc], bo[2], bo[3]);
      }
      float ph[2][4], pl[2][4], ds[2][4];
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
          const float p =
              ok ? expf(s[n][e] * a.scale - ((e & 1) ? lq.y : lq.x)) : 0.f;
          ph[n][e] = __bfloat162float(__float2bfloat16(p));
          pl[n][e] = p - ph[n][e];
          ds[n][e] = p * (dp[n][e] - ((e & 1) ? dd2.y : dd2.x));
        }
        if (kc < 3 || n == 0) qpos = step<POLICY>(geo, qpos, 8);
      }
      // dV += P^T dO (P = hi + lo), dK += dS^T Q: P^T and dS^T are the
      // accumulators above, converted in registers to A fragments
      uint32_t pha[4], pla[4], dsa[4];
      acc_to_a(pha, ph[0], ph[1]);
      acc_to_a(pla, pl[0], pl[1]);
      acc_to_a(dsa, ds[0], ds[1]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bo[4], bq[4];
        load_b(bo, tdO, kc, np, lane);
        mma16816(dv[2 * np], pha, bo[0], bo[1]);
        mma16816(dv[2 * np + 1], pha, bo[2], bo[3]);
        mma16816(dv[2 * np], pla, bo[0], bo[1]);
        mma16816(dv[2 * np + 1], pla, bo[2], bo[3]);
        load_b(bq, tQ, kc, np, lane);
        mma16816(dk[2 * np], dsa, bq[0], bq[1]);
        mma16816(dk[2 * np + 1], dsa, bq[2], bq[3]);
      }
    }
  }
  cp_async_wait_all();  // a walk of no tiles still committed K/V
}

template <int POLICY>
__global__ void __launch_bounds__(THREADS, DKDV_BLOCKS)
attn_bwd_dkdv_kernel(AttnBwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Geo geo{a.n, a.grid, a.hw, a.transpose};
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BT, k1 = min(k0 + BT, a.T);

  // the packed query range [qlo, qhi) whose rows can reach these keys
  int qhi = a.T;
  if (POLICY == POLICY_LINE) qhi = min(a.T, ((k1 - 1) / a.n + 1) * a.n);
  if (POLICY == POLICY_CONV)
    qhi = min(a.T, ((k1 - 1) / a.grid + a.hw + 1) * a.grid);

  float dk[8][4], dv[8][4];
  dkdv_walk<POLICY, false>(a, smem, b, h, k0, k1, k0, qhi, dk, dv);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * 16;
  if (k0 + row0 >= k1) return;
  // stage in the warp's own K and V rows (read only by this warp)
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + TILE;
  __syncwarp();
  stage_rows(sK, dk, a.scale, row0, lane);
  stage_rows(sV, dv, 1.f, row0, lane);
  __syncwarp();
  store_rows(at<bf16>(a.dk, a.dk_s, b, h), a.dk_s[2], sK, geo, row0, k0, k1,
             true, lane);
  store_rows(at<bf16>(a.dv, a.dv_s, b, h), a.dv_s[2], sV, geo, row0, k0, k1,
             true, lane);
}

template <int POLICY>
__global__ void __launch_bounds__(THREADS, DKDV_BLOCKS)
attn_bwd_dkdv_prefix_kernel(AttnBwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = (blockIdx.x / CLUSTER) * BT, k1 = min(k0 + BT, a.S);
  const int q_tiles = (a.T + BT - 1) / BT;
  const int qlo = rank * q_tiles / CLUSTER * BT;
  const int qhi = min(a.T, (rank + 1) * q_tiles / CLUSTER * BT);

  float dk[8][4], dv[8][4];
  dkdv_walk<POLICY, true>(a, smem, b, h, k0, k1, qlo, qhi, dk, dv);
  __syncthreads();  // every warp is done with the query ring

  // this block's partial dk | dv (f32 [2][64][64]) into the query ring
  float* part = reinterpret_cast<float*>(smem + 2 * TILE * sizeof(bf16));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = (warp * 16 + g + 8 * hh) * D + 8 * nt + 2 * t4;
      *reinterpret_cast<float2*>(part + i) =
          make_float2(dk[nt][2 * hh], dk[nt][2 * hh + 1]);
      *reinterpret_cast<float2*>(part + BT * D + i) =
          make_float2(dv[nt][2 * hh], dv[nt][2 * hh + 1]);
    }
  }
  cluster.sync();

  // block `rank` sums its BT / CLUSTER keys over the partials in rank
  // order and writes them: dk * scale, dv
  constexpr int ROWS = BT / CLUSTER;         // keys a block reduces
  constexpr int ITEMS = 2 * ROWS * (D / 4);  // float4 of dk and dv
  const float* parts[CLUSTER];
#pragma unroll
  for (int r = 0; r < CLUSTER; ++r)
    parts[r] = cluster.map_shared_rank(part, r);
  bf16* dkb = at<bf16>(a.dkp, a.dkp_s, b, h);
  bf16* dvb = at<bf16>(a.dvp, a.dvp_s, b, h);
#pragma unroll
  for (int i = 0; i < ITEMS / THREADS; ++i) {
    const int idx = threadIdx.x + THREADS * i;
    const int which = idx / (ITEMS / 2), rem = idx % (ITEMS / 2);
    const int row = ROWS * rank + rem / (D / 4), c4 = rem % (D / 4);
    const int off = which * BT * D + row * D + 4 * c4;
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
      bf16* dst = which ? dvb + (long long)kj * a.dvp_s[2]
                        : dkb + (long long)kj * a.dkp_s[2];
      *reinterpret_cast<uint2*>(dst + 4 * c4) =
          make_uint2(pack_bf16(acc.x * mul, acc.y * mul),
                     pack_bf16(acc.z * mul, acc.w * mul));
    }
  }
  cluster.sync();  // the other blocks' shared memory is read until here
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
  err = cudaFuncSetAttribute(attn_bwd_dkdv_prefix_kernel<POLICY>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)DKDV_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (a.T + BT - 1) / BT;
  attn_bwd_dq_kernel<POLICY>
      <<<dim3(tiles, a.H, a.B), THREADS, DQ_SMEM, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkdv_kernel<POLICY>
      <<<dim3(tiles, a.H, a.B), THREADS, DKDV_SMEM, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.kp == nullptr) return (int)err;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.S + BT - 1) / BT * CLUSTER, a.H, a.B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = DKDV_SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, attn_bwd_dkdv_prefix_kernel<POLICY>, a);
  if (err != cudaSuccess) return (int)err;
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

template <int POLICY>
static const void* pass_fn(int pass) {
  return pass == 0   ? (const void*)attn_bwd_dq_kernel<POLICY>
         : pass == 1 ? (const void*)attn_bwd_dkdv_kernel<POLICY>
                     : (const void*)attn_bwd_dkdv_prefix_kernel<POLICY>;
}

// Resources of pass `pass` (0 dq, 1 dk/dv, 2 prefix dk/dv) for `policy`:
// out = {registers, static shared bytes, dynamic shared bytes of a launch,
// local (spill) bytes a thread}.
extern "C" int attention_bwd_resources(int policy, int pass, int* out) {
  const void* fn = policy == POLICY_LINE   ? pass_fn<POLICY_LINE>(pass)
                   : policy == POLICY_CONV ? pass_fn<POLICY_CONV>(pass)
                                           : pass_fn<POLICY_FULL>(pass);
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, fn);
  out[0] = fa.numRegs;
  out[1] = (int)fa.sharedSizeBytes;
  out[2] = (int)(pass == 0 ? DQ_SMEM : DKDV_SMEM);
  out[3] = (int)fa.localSizeBytes;
  return (int)err;
}

extern "C" const char* attention_bwd_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
