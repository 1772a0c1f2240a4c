// LayerNorm backward for Hopper: dx, and the dscale/dbias sums over rows.
//
// Replaces the TPU kernel dalle_tpu/ops/pallas/ln_kernels.py _bwd_call
// (_ln_bwd_kernel plus the XLA sum of its per-tile partials). Numerics are
// layer_norm_bwd_plain's (ops/layer_norm.py): statistics in f32 from x, the
// fast variance E[x^2] - E[x]^2 clipped at 0, eps inside the rsqrt (IEEE
// 1 / sqrtf), xhat = (x - mean) rstd, dyg = dy scale, c1 = mean(dyg xhat),
// c2 = mean(dyg), dx = rstd (dyg - xhat c1 - c2) in x's dtype (formed as
// rstd dyg - (rstd c1) xhat - rstd c2), dscale = sum(dy xhat) and dbias =
// sum(dy) over rows in f32.
//
// What bounds it on the card: bytes, then instructions. At the flagship (5120
// rows of d = 1024 bf16) a call reads x and dy and writes dx, 31.5 MB or
// 9.4 us at 3.35 TB/s; a row also costs each of its 32 lanes some 600
// instructions (three passes over 32 values, two shuffle reductions), so
// an SM's ~39 rows are ~5 us of instructions at the full rate, to hide under
// the bytes. The Triton kernels this source replaces walked 16 rows a
// program in series, each through four block-wide reductions (35 us).
// The design:
//   - one warp a row: (sum x, sum x^2) and then (c1, c2) reduce with
//     __shfl_xor_sync in pairs, with no barrier;
//   - a persistent grid: as many 8-warp blocks as the occupancy query puts
//     on every SM (fixed per device and shape; one at the flagship), each
//     warp walking rows in a fixed strided order. A row lives in registers
//     as packed 16-byte chunks (chunk c = lane + 32 i of x and dy), loaded
//     once with 16-byte loads; the next row's chunks load into a second
//     set while this one is computed (for up to 4 chunks a lane);
//   - bf16 -> f32 by a shift or a mask, no conversion instruction; the
//     scale in shared memory as f32 in planes of float4, so each lane's
//     16-byte reads of it fall in distinct banks; a compile-time FULL
//     instance for rows that fill every lane's chunks (no bounds checks);
//   - dx leaves in 16-byte stores;
//   - dscale/dbias without atomics: each lane keeps its columns' partials
//     in f32 registers, the block sums its warps' partials in warp order
//     into one row of a (blocks, d) f32 buffer, and ln_bwd_sum sums that
//     buffer over blocks in a fixed order, 32 columns a block with 16 warps
//     over the rows. Two runs give the same bits.
// Tried on the way and slower on an H100 at the flagship shape: rows
// staged in shared memory by cp.async (two or three slots) or by TMA bulk
// copies, 4- and 16-warp blocks, partials in shared memory. The rows'
// instruction count, not their latency, held those; registers, the cheaper
// unpacking and the FULL instances are what moved the time.
// Rows wider than a lane's 32 registers hold (d > 1024 in bf16 and f32)
// take ln_bwd_rows_wide: the same passes over chunks re-read from global
// memory (L1/L2), partials in the warp's shared memory.
// Domain: x/dy bf16 or f32 with 16-byte aligned rows, d a multiple of 8 up
// to MAX_D; ops/layer_norm.py raises outside it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

typedef __nv_bfloat16 bf16;

// Arguments of layer_norm_bwd (mirrored by ops/layer_norm.py).
struct LnBwdArgs {
  const void* x;      // (M, d), rows x_s elements apart
  const void* dy;     // (M, d), rows dy_s elements apart
  const void* scale;  // (d,) bf16 or f32
  void* dx;           // (M, d) contiguous, x's dtype
  float* parts;       // (2, blocks, d) f32 scratch
  float* sums;        // (2, d) f32: dscale, dbias
  long long x_s, dy_s;
  int M, d;
  int scale_bf16;
  float eps;
};

namespace {

constexpr int WARPS = 8;          // warps of a row-pass block
constexpr int MAX_D = 8192;
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use
constexpr int SUM_WARPS = 16;     // warps over the rows of the partial sum
constexpr unsigned FULL_MASK = 0xffffffffu;

enum { DTYPE_F32 = 0, DTYPE_BF16 = 1 };  // mirrored by ops/layer_norm.py

template <typename T>
struct Chunk;  // a 16-byte chunk of T
template <>
struct Chunk<bf16> {
  static constexpr int E = 8;
};
template <>
struct Chunk<float> {
  static constexpr int E = 4;
};

// bf16 -> f32 is the 16 bits shifted up: one integer op a value
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    f[2 * e] = __uint_as_float(w[e] << 16);
    f[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
  return u;
}

__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}

// Column (c, e) of a row (chunk c, element e) in an f32 row laid out in
// planes: plane e / 4 holds element group e / 4 of every chunk as one
// float4, so lane-consecutive chunks are bank-consecutive.
template <int E>
__device__ __forceinline__ int plane_idx(int C, int c, int e) {
  return (e / 4) * (4 * C) + c * 4 + (e % 4);
}

template <int E>
__device__ __forceinline__ void load_planes(const float* p, int C, int c,
                                            float (&v)[E]) {
#pragma unroll
  for (int q = 0; q < E / 4; ++q) {
    const float4 f = reinterpret_cast<const float4*>(p)[q * C + c];
    v[4 * q] = f.x;
    v[4 * q + 1] = f.y;
    v[4 * q + 2] = f.z;
    v[4 * q + 3] = f.w;
  }
}

template <int E>
__device__ __forceinline__ void add_planes(float* p, int C, int c,
                                           const float (&v)[E]) {
#pragma unroll
  for (int q = 0; q < E / 4; ++q) {
    float4* f = reinterpret_cast<float4*>(p) + q * C + c;
    float4 o = *f;
    o.x += v[4 * q];
    o.y += v[4 * q + 1];
    o.z += v[4 * q + 2];
    o.w += v[4 * q + 3];
    *f = o;
  }
}

__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    a += __shfl_xor_sync(FULL_MASK, a, o);
    b += __shfl_xor_sync(FULL_MASK, b, o);
  }
}

template <typename T>
__device__ __forceinline__ const uint4* chunk_at(const void* base,
                                                 long long stride, int row,
                                                 int c) {
  return reinterpret_cast<const uint4*>(static_cast<const T*>(base) +
                                        row * stride) + c;
}

// The block's prologue: the scale as planar f32 in sG.
template <typename T>
__device__ __forceinline__ void load_scale(const LnBwdArgs& a, float* sG) {
  constexpr int E = Chunk<T>::E;
  const int C = a.d / E;
  for (int i = threadIdx.x; i < a.d; i += blockDim.x)
    sG[plane_idx<E>(C, i / E, i % E)] =
        a.scale_bf16 ? __bfloat162float(static_cast<const bf16*>(a.scale)[i])
                     : static_cast<const float*>(a.scale)[i];
}

// The block's epilogue: its warps' planar partials (W x [2][d] at parts_s)
// summed in warp order into row blockIdx.x of the (2, blocks, d) buffer.
template <typename T>
__device__ __forceinline__ void block_partials(const LnBwdArgs& a,
                                               const float* parts_s) {
  constexpr int E = Chunk<T>::E;
  const int d = a.d, C = d / E, W = blockDim.x >> 5;
  for (int col = threadIdx.x; col < d; col += blockDim.x) {
    const int p = plane_idx<E>(C, col / E, col % E);
    float sg = 0.f, sb = 0.f;
    for (int w = 0; w < W; ++w) {
      sg += parts_s[(size_t)w * 2 * d + p];
      sb += parts_s[(size_t)w * 2 * d + d + p];
    }
    a.parts[(size_t)blockIdx.x * d + col] = sg;
    a.parts[((size_t)gridDim.x + blockIdx.x) * d + col] = sb;
  }
}

// Row pass for d <= 32 * NV * E: rows in registers. FULL: every lane holds
// NV whole chunks (d == 32 * NV * E).
template <typename T, int NV, bool FULL>
__global__ void __launch_bounds__(WARPS * 32) ln_bwd_rows(LnBwdArgs a) {
  constexpr int E = Chunk<T>::E;
  constexpr bool PREFETCH = NV <= 4;  // a second row set fits the registers
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = blockDim.x >> 5, warp = threadIdx.x >> 5,
            lane = threadIdx.x & 31;
  const int d = a.d, C = d / E;
  float* sG = reinterpret_cast<float*>(smem);
  float* parts_s = sG + d;
  load_scale<T>(a, sG);
  __syncthreads();

  float pg[NV * E], pb[NV * E];
#pragma unroll
  for (int i = 0; i < NV * E; ++i) pg[i] = pb[i] = 0.f;
  auto live = [&](int i) { return FULL || lane + 32 * i < C; };
  auto load = [&](int row, uint4 (&x)[NV], uint4 (&y)[NV]) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (live(i)) {
        x[i] = __ldg(chunk_at<T>(a.x, a.x_s, row, lane + 32 * i));
        y[i] = __ldg(chunk_at<T>(a.dy, a.dy_s, row, lane + 32 * i));
      }
    }
  };
  const int gw = blockIdx.x * W + warp, TW = gridDim.x * W;
  const float inv_d = 1.f / (float)d;
  uint4 cx[NV], cy[NV];
  if (PREFETCH && gw < a.M) load(gw, cx, cy);
  for (int row = gw; row < a.M; row += TW) {
    uint4 nx[NV], ny[NV];
    if (!PREFETCH) load(row, cx, cy);
    else if (row + TW < a.M) load(row + TW, nx, ny);

    // per-chunk partial sums, added in chunk order: short dependency chains
    float s1c[NV], s2c[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      s1c[i] = s2c[i] = 0.f;
      if (live(i)) {
        float x[E];
        unpack(cx[i], x);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          s1c[i] += x[e];
          s2c[i] += x[e] * x[e];
        }
      }
    }
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      s1 += s1c[i];
      s2 += s2c[i];
    }
    warp_sum2(s1, s2);
    const float mean = s1 * inv_d;
    const float var = fmaxf(s2 * inv_d - mean * mean, 0.f);
    const float rstd = 1.f / sqrtf(var + a.eps);

    float c1c[NV], c2c[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      c1c[i] = c2c[i] = 0.f;
      if (live(i)) {
        float x[E], dy[E], g[E];
        unpack(cx[i], x);
        unpack(cy[i], dy);
        load_planes<E>(sG, C, lane + 32 * i, g);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float xhat = (x[e] - mean) * rstd;
          const float dyg = dy[e] * g[e];
          c1c[i] += dyg * xhat;
          c2c[i] += dyg;
          pg[i * E + e] += dy[e] * xhat;
          pb[i * E + e] += dy[e];
        }
      }
    }
    float c1 = 0.f, c2 = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      c1 += c1c[i];
      c2 += c2c[i];
    }
    warp_sum2(c1, c2);
    const float k1 = -rstd * (c1 * inv_d), k2 = -rstd * (c2 * inv_d);

    T* dxr = static_cast<T*>(a.dx) + (long long)row * d;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (live(i)) {
        const int c = lane + 32 * i;
        float x[E], dy[E], g[E], dx[E];
        unpack(cx[i], x);
        unpack(cy[i], dy);
        load_planes<E>(sG, C, c, g);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float xhat = (x[e] - mean) * rstd;
          dx[e] = fmaf(k1, xhat, fmaf(rstd, dy[e] * g[e], k2));
        }
        *reinterpret_cast<uint4*>(dxr + c * E) = pack(dx);
      }
    }
    if (PREFETCH) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        cx[i] = nx[i];
        cy[i] = ny[i];
      }
    }
  }

  float* wpart = parts_s + (size_t)warp * 2 * d;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (live(i)) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        wpart[plane_idx<E>(C, lane + 32 * i, e)] = pg[i * E + e];
        wpart[d + plane_idx<E>(C, lane + 32 * i, e)] = pb[i * E + e];
      }
    }
  }
  __syncthreads();
  block_partials<T>(a, parts_s);
}

// Row pass for wider rows: the same passes over chunks read from global
// memory each time (the row stays in L1/L2 between them), the partials in
// the warp's planar shared memory.
template <typename T>
__global__ void __launch_bounds__(WARPS * 32) ln_bwd_rows_wide(LnBwdArgs a) {
  constexpr int E = Chunk<T>::E;
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = blockDim.x >> 5, warp = threadIdx.x >> 5,
            lane = threadIdx.x & 31;
  const int d = a.d, C = d / E;
  float* sG = reinterpret_cast<float*>(smem);
  float* parts_s = sG + d;
  float* wpart = parts_s + (size_t)warp * 2 * d;
  load_scale<T>(a, sG);
  for (int i = lane; i < 2 * d / 4; i += 32)
    reinterpret_cast<float4*>(wpart)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  const int gw = blockIdx.x * W + warp, TW = gridDim.x * W;
  const float inv_d = 1.f / (float)d;
  for (int row = gw; row < a.M; row += TW) {
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      float x[E];
      unpack(__ldg(chunk_at<T>(a.x, a.x_s, row, c)), x);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        s1 += x[e];
        s2 += x[e] * x[e];
      }
    }
    warp_sum2(s1, s2);
    const float mean = s1 * inv_d;
    const float var = fmaxf(s2 * inv_d - mean * mean, 0.f);
    const float rstd = 1.f / sqrtf(var + a.eps);
    float c1 = 0.f, c2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      float x[E], dy[E], g[E], pgv[E], pbv[E];
      unpack(__ldg(chunk_at<T>(a.x, a.x_s, row, c)), x);
      unpack(__ldg(chunk_at<T>(a.dy, a.dy_s, row, c)), dy);
      load_planes<E>(sG, C, c, g);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float xhat = (x[e] - mean) * rstd;
        const float dyg = dy[e] * g[e];
        c1 += dyg * xhat;
        c2 += dyg;
        pgv[e] = dy[e] * xhat;
        pbv[e] = dy[e];
      }
      add_planes<E>(wpart, C, c, pgv);
      add_planes<E>(wpart + d, C, c, pbv);
    }
    warp_sum2(c1, c2);
    const float k1 = -rstd * (c1 * inv_d), k2 = -rstd * (c2 * inv_d);
    T* dxr = static_cast<T*>(a.dx) + (long long)row * d;
    for (int c = lane; c < C; c += 32) {
      float x[E], dy[E], g[E], dx[E];
      unpack(__ldg(chunk_at<T>(a.x, a.x_s, row, c)), x);
      unpack(__ldg(chunk_at<T>(a.dy, a.dy_s, row, c)), dy);
      load_planes<E>(sG, C, c, g);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float xhat = (x[e] - mean) * rstd;
        dx[e] = fmaf(k1, xhat, fmaf(rstd, dy[e] * g[e], k2));
      }
      *reinterpret_cast<uint4*>(dxr + c * E) = pack(dx);
    }
  }
  __syncthreads();
  block_partials<T>(a, parts_s);
}

// dscale (y = 0) and dbias (y = 1): the (blocks, d) partials summed over
// blocks in a fixed order; 32 columns a block, SUM_WARPS warps over the
// rows, their sums added in warp order.
__global__ void __launch_bounds__(SUM_WARPS * 32)
ln_bwd_sum(const float* parts, float* sums, int G, int d) {
  __shared__ float red[SUM_WARPS][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = blockIdx.x * 32 + lane;
  const float* p = parts + (size_t)blockIdx.y * G * d;
  float acc = 0.f;
  if (col < d) {
#pragma unroll 8
    for (int r = warp; r < G; r += SUM_WARPS) acc += p[(size_t)r * d + col];
  }
  red[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && col < d) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < SUM_WARPS; ++w) s += red[w][lane];
    sums[(size_t)blockIdx.y * d + col] = s;
  }
}

struct Plan {
  const void* kernel;
  int warps;
  size_t smem;
};

template <typename T, int NV>
const void* rows_kernel(bool full) {
  return full ? (const void*)ln_bwd_rows<T, NV, true>
              : (const void*)ln_bwd_rows<T, NV, false>;
}

// The row pass for (T, d): a register instance when a lane's chunks fit in
// 32 values (NV = 1, 2, 4, or 8 for f32), else the wide one; as many warps
// (up to 8) as the scale and the warps' partials leave shared memory for.
template <typename T>
Plan plan(int d) {
  constexpr int E = Chunk<T>::E;
  const int C = d / E, need = (C + 31) / 32;
  const void* k = (const void*)ln_bwd_rows_wide<T>;
  if (need <= 1) k = rows_kernel<T, 1>(C == 32);
  else if (need <= 2) k = rows_kernel<T, 2>(C == 64);
  else if (need <= 4) k = rows_kernel<T, 4>(C == 128);
  else if constexpr (8 * E <= 32) {
    if (need <= 8) k = rows_kernel<T, 8>(C == 256);
  }
  auto bytes = [d](int w) { return (size_t)d * 4 * (1 + 2 * (size_t)w); };
  int W = WARPS;
  while (W > 1 && bytes(W) > (size_t)SMEM_MAX) --W;
  return {k, W, bytes(W)};
}

int plan_of(int dtype, int d, Plan* p) {
  if (d <= 0 || d % 8 || d > MAX_D) return (int)cudaErrorInvalidValue;
  if (dtype == DTYPE_BF16) *p = plan<bf16>(d);
  else if (dtype == DTYPE_F32) *p = plan<float>(d);
  else return (int)cudaErrorInvalidValue;
  if (p->smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(p->kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)p->smem);
}

}  // namespace

// The row pass's grid for (dtype, m, d): every SM's resident blocks (the
// occupancy query), no more than the rows need. The caller allocates the
// (2, grid, d) partial buffer and passes the grid back to layer_norm_bwd.
extern "C" int layer_norm_bwd_grid(int dtype, int m, int d, int* grid) {
  Plan p;
  int err = plan_of(dtype, d, &p);
  if (err != 0) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = (int)cudaGetDevice(&dev);
  if (err == 0)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == 0)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, p.kernel, p.warps * 32, p.smem);
  if (err != 0) return err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int need = (m + p.warps - 1) / p.warps;
  *grid = need < sms * per_sm ? (need > 0 ? need : 1) : sms * per_sm;
  return 0;
}

extern "C" int layer_norm_bwd(const LnBwdArgs* a, int dtype, int grid,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Plan p;
  int err = plan_of(dtype, a->d, &p);
  if (err != 0) return err;
  void* args[] = {const_cast<LnBwdArgs*>(a)};
  err = (int)cudaLaunchKernel(p.kernel, dim3(grid), dim3(p.warps * 32), args,
                              p.smem, s);
  if (err != 0) return err;
  ln_bwd_sum<<<dim3((a->d + 31) / 32, 2), SUM_WARPS * 32, 0, s>>>(
      a->parts, a->sums, grid, a->d);
  return (int)cudaGetLastError();
}

extern "C" const char* layer_norm_bwd_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
