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
// beside the output in raster token order. The softmax is taken online over
// key tiles (running max, rescaled denominator and accumulator).
//
// What bounds it on the card: at the flagship (B=4, H=16, d=64) a call moves
// a few MB (q, k, v, the 256-token text prefix, out, lse) for under a GFLOP,
// below the H100's ~295 FLOP/byte ridge, so the floor is memory bandwidth;
// a block walks only 5-8 key tiles, so what the kernel has to hide is the
// latency of each tile's loads and of the softmax between its two products.
// The design (FA2's register layout on mma.sync.m16n8k16):
//   - one block of 4 warps per (64 query rows, head, batch), each warp 16
//     rows; Q is loaded once into A fragments (ldmatrix), S = Q K^T, P and
//     the O accumulator stay in registers for the whole key walk, and P's
//     accumulators convert in place to the A fragments of P V (ldmatrix.trans
//     for V);
//   - each row's max and sum reduce over the 4 lanes that hold it (2
//     shuffles), all 16 rows of a warp at once;
//   - K/V tiles stream through a 2-stage cp.async ring (tile i+1 in flight
//     while tile i computes; src-size 0 zero-fills ragged edges; axial_col
//     rows are gathered at stride grid) into XOR-swizzled tiles: 40 KB of
//     shared memory a block;
//   - a warp skips a key tile none of its rows can reach (exact: the -1e9
//     terms would be scaled by exp(-1e9 - m) = 0) and applies the mask only
//     on tiles that cross a mask edge; the mask's divisions are done once a
//     tile and stepped by addition (attention_common.cuh).
// Layout: every tensor is (B, H, T, 64) bf16 with arbitrary element strides
// for b, h, t and unit stride along d, so (B, T, H, d) activations are read
// in place through a transposed view.

#include "attention_common.cuh"

using namespace attn;

namespace {

constexpr size_t SMEM_BYTES = 5 * TILE * sizeof(bf16);  // Q, 2 x K, 2 x V

}  // namespace

template <int POLICY>
__global__ void __launch_bounds__(THREADS)
attn_fwd_kernel(AttnArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + TILE;      // 2 stages
  bf16* sV = sK + 2 * TILE;  // 2 stages

  const Geo geo{a.n, a.grid, a.hw, a.transpose};
  const int q0 = blockIdx.x * BT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q1 = min(q0 + BT, a.T);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = warp * 16;

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_s[0] + h * a.q_s[1];
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_s[0] + h * a.k_s[1];
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_s[0] + h * a.v_s[1];
  const bf16* kpb = a.kp ? static_cast<const bf16*>(a.kp) + b * a.kp_s[0] +
                               h * a.kp_s[1]
                         : nullptr;
  const bf16* vpb = a.vp ? static_cast<const bf16*>(a.vp) + b * a.vp_s[0] +
                               h * a.vp_s[1]
                         : nullptr;

  // key range over packed main-token indices [lo, hi)
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
  issue(0);
  cp_async_commit();

  // this warp's rows [w0, wl] (wl the last real one) and this thread's two
  const int w0 = q0 + row0, wl = min(w0 + 15, q1 - 1);
  const bool live = w0 < q1;
  const Pos qp[2] = {pos_of<POLICY>(geo, w0 + g), pos_of<POLICY>(geo, w0 + g + 8)};
  const int w0_row = POLICY == POLICY_CONV ? w0 / a.grid : 0;
  const int wl_ls = POLICY == POLICY_LINE ? wl - wl % a.n : 0;

  uint32_t qf[4][4];
  float o[8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile it landed; tile it-1's stage no longer read
    if (it + 1 < n_tiles) {
      issue(it + 1);
      cp_async_commit();
    }
    if (it == 0 && live) {
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) load_a(qf[kc], sQ, row0, kc, lane);
    }
    const bool pfx = it < n_pfx;
    const int k0 = pfx ? it * BT : lo + (it - n_pfx) * BT;
    const int ke = min(k0 + BT, pfx ? a.S : hi);

    // can any row of this warp reach the tile, and does the mask cut it?
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

    // S = Q K^T: 16 rows x 64 keys in 8 n8 accumulators
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int np = 0; np < 4; ++np) {
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        uint32_t bk[4];
        load_bt(bk, tK, np, kc, lane);
        mma16816(s[2 * np], qf[kc], bk[0], bk[1]);
        mma16816(s[2 * np + 1], qf[kc], bk[2], bk[3]);
      }
    }

    // scale, mask (only on tiles that cross an edge), tile row max
    float mx[2] = {m[0], m[1]};
    Pos kpos = pos_of<POLICY>(geo, k0 + 2 * t4);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const Pos kpos1 = step<POLICY>(geo, kpos, 1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = s[nt][e] * a.scale;
        if (!full) {
          const Pos& kq = (e & 1) ? kpos1 : kpos;
          const bool ok = pfx ? kq.j < ke
                              : kq.j < ke && allowed<POLICY>(geo, qp[e >> 1], kq);
          v = ok ? v : NEG_FILL;
        }
        s[nt][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
      if (nt < 7) kpos = step<POLICY>(geo, kpos, 8);
    }

    // online softmax: the quad holding a row reduces its max (2 shuffles)
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        rs[e >> 1] += p;
        o[nt][e] *= alpha[e >> 1];
      }
    }
    // the denominator is kept per lane (this lane's 16 columns) and summed
    // over the quad once at the end
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];

    // O += P V, P converted in registers to A fragments (bf16)
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bv[4];
        load_b(bv, tV, kc, np, lane);
        mma16816(o[2 * np], pa, bv[0], bv[1]);
        mma16816(o[2 * np + 1], pa, bv[2], bv[3]);
      }
    }
  }
  if (!live) return;

  // out = O / denominator (bf16), lse = m + log(denominator)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = o[nt][e] / l[e >> 1];
  // the warp's own Q rows are free: stage the output there for 16-byte
  // stores
  __syncwarp();
  stage_rows(sQ, o, 1.f, row0, lane);
  __syncwarp();
  bf16* ob = static_cast<bf16*>(a.out) + b * a.o_s[0] + h * a.o_s[1];
  store_rows(ob, a.o_s[2], sQ, geo, row0, q0, q1, true, lane);
  if (t4 == 0) {
    float* lse_b = a.lse + ((long long)b * a.H + h) * a.T;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qj = w0 + g + 8 * r;
      if (qj < q1) lse_b[raster_of(geo, qj)] = m[r] + logf(l[r]);
    }
  }
}

template <int POLICY>
static int launch(const AttnArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel<POLICY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.T + BT - 1) / BT, a.H, a.B);
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

// Resources of attn_fwd_kernel<policy>: out = {registers, static shared
// bytes, dynamic shared bytes of a launch, local (spill) bytes a thread}.
extern "C" int attention_fwd_resources(int policy, int* out) {
  const void* fn = policy == POLICY_LINE   ? (const void*)attn_fwd_kernel<POLICY_LINE>
                   : policy == POLICY_CONV ? (const void*)attn_fwd_kernel<POLICY_CONV>
                                           : (const void*)attn_fwd_kernel<POLICY_FULL>;
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, fn);
  out[0] = fa.numRegs;
  out[1] = (int)fa.sharedSizeBytes;
  out[2] = (int)SMEM_BYTES;
  out[3] = (int)fa.localSizeBytes;
  return (int)err;
}

extern "C" const char* attention_fwd_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
