// The quantizers of the 8-bit LAMB and of the swarm wire codec: three
// memory-bound elementwise passes with a per-block absmax.
//
// 1. quantize_blockwise_kernel replaces the TPU kernel
//    dalle_tpu/ops/pallas/quant_kernels.py quantize_blockwise_pallas
//    (_quant_kernel): per quant block of `block` f32 values (4096 in the
//    8-bit LAMB), absmax = max|x|, normed = x / (absmax > 0 ? absmax : 1),
//    code = the number of the 255 codebook midpoints strictly below normed
//    (the dynamic-tree codebook, signed or unsigned); outputs the (n_blocks,
//    block) u8 codes and the (n_blocks, 1) f32 absmax.
// 2. wire_quantize_kernel<256, 127, ...> replaces wire_quantize_u8_pallas
//    (_wire_quant_kernel via _wire_quantize_pallas): per 256-element block,
//    scale = absmax / 127, code = clip(rint(x / (scale > 0 ? scale : 1)),
//    -128, 127) + 128; outputs n u8 codes and ceil(n/256) f32 scales.
// 3. wire_quantize_kernel<1024, 7, ...> replaces wire_quantize_u4_pallas
//    (_wire_quant4_kernel): block 1024, scale = absmax / 7, clip to [-8, 7],
//    + 8. It writes the codes PACKED, two per byte, low nibble at the even
//    index and a zero high nibble after an odd n: the wire's layout
//    (dalle_tpu/swarm/compression.py compress_u4), so the separate pack pass
//    of the JAX device codec is gone.
//
// What bounds them on the card: bytes. Each reads 4 bytes an element and
// writes 1 (codes) or 1/2 (packed nibbles), plus one f32 per block; at 3.35
// TB/s that is 374 us for the 8-bit LAMB's 2 x 125.4 M moment elements of
// one flagship step, and 47 / 42 us for one 31.4 M-element wire part.
// Neither the 8 comparisons of the binary search nor the two divides come
// near the card's arithmetic rate. So the design reads every value once,
// coalesced as float4 (16 bytes a lane), keeps it in registers through the
// block's max, and writes the codes as one 4-byte (u8) or 2-byte (u4)
// store per float4. Blocks are independent (the TPU grid's only sum is the
// max inside a block), so there is no second pass and no atomics; max is
// exact in any order, so the bytes cannot depend on the thread layout.
//
// Byte identity with the JAX package and numpy (the wire is read by peers
// of both codecs, and the optimizer's codes are compared with JAX's):
// - divides are __fdiv_rn, the IEEE round-to-nearest divide that `/` is in
//   numpy and XLA (the JAX package passes 127 and 7 as runtime operands only
//   to stop XLA from turning the divide into a reciprocal multiply); the
//   library is built without fast math, and rintf rounds half to even, as
//   np.rint and jnp.rint do;
// - the max propagates NaN, as XLA's, numpy's and torch's max do (fmaxf
//   would drop it); a NaN absmax then takes the scale 1, as jnp.where does;
// - the tail block is masked (zeros past n), which gives the bytes of the
//   JAX package's zero-padded copy without making one.
//
// Codebook search: the 255 midpoints plus a +inf pad sit in SHARED memory
// (not __constant__: the lanes read different addresses, which constant
// memory serialises), and a branchless binary search of 8 steps returns
// #{k : mid[k] < v}. That equals the Pallas count sum_k [v > mid_k] for
// every input: a tie takes the lower code, -0.0 compares as 0.0, +inf
// counts all 255 midpoints, and NaN compares false everywhere and gives 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QB_VEC = 4;   // quantize_blockwise: float4s (16 values) a thread
constexpr int WIRE_THREADS = 256;   // 8 warps, one wire block each

// max that propagates NaN (fmaxf returns the other operand)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// masked float4 load of x[e .. e+3] (zeros past n); x + e is 16-byte
// aligned whenever e + 3 < n takes the vector path (e is a multiple of 4
// and the wrapper checks x's alignment)
__device__ __forceinline__ float4 load4(const float* __restrict__ x,
                                        long long e, long long n) {
  if (e + 3 < n) return __ldg(reinterpret_cast<const float4*>(x + e));
  float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
  if (e < n) q.x = x[e];
  if (e + 1 < n) q.y = x[e + 1];
  if (e + 2 < n) q.z = x[e + 2];
  return q;
}

__device__ __forceinline__ float abs_max4(float m, float4 q) {
  m = max_nan(m, fabsf(q.x));
  m = max_nan(m, fabsf(q.y));
  m = max_nan(m, fabsf(q.z));
  return max_nan(m, fabsf(q.w));
}

// #{k : thr[k] < v} over the 256 sorted thresholds (thr[255] = +inf)
__device__ __forceinline__ unsigned code_of(float v, const float* thr) {
  unsigned pos = 0;
#pragma unroll
  for (unsigned step = 128; step > 0; step >>= 1)
    pos += (thr[pos + step - 1] < v) ? step : 0u;
  return pos;
}

// One CTA per quant block; blockDim.x = block/16 rounded up to a warp.
// Thread t holds the float4s t, t + blockDim.x, t + 2 blockDim.x, ... of its
// block (coalesced across the warp), at most QB_VEC of them.
__global__ void __launch_bounds__(1024) quantize_blockwise_kernel(
    const float* __restrict__ x, long long n, int block,
    const float* __restrict__ thresholds, uint8_t* __restrict__ codes,
    float* __restrict__ absmax) {
  __shared__ float thr[256];
  __shared__ float warp_max_s[32];
  __shared__ float block_max;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) thr[i] = thresholds[i];
  const long long base = (long long)blockIdx.x * block;
  const int quads = block / 4;
  float4 v[QB_VEC];
  float m = 0.f;
#pragma unroll
  for (int k = 0; k < QB_VEC; ++k) {
    const int f = k * blockDim.x + threadIdx.x;
    v[k] = f < quads ? load4(x, base + 4LL * f, n)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    m = abs_max4(m, v[k]);
  }
  m = warp_max(m);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_max_s[warp] = m;
  __syncthreads();   // also publishes thr
  if (warp == 0) {
    float w = lane < (int)(blockDim.x >> 5) ? warp_max_s[lane] : 0.f;
    w = warp_max(w);
    if (lane == 0) block_max = w;
  }
  __syncthreads();
  const float am = block_max;
  const float scale = am > 0.f ? am : 1.f;
  if (threadIdx.x == 0) absmax[blockIdx.x] = am;
  uchar4* out = reinterpret_cast<uchar4*>(codes + base);
#pragma unroll
  for (int k = 0; k < QB_VEC; ++k) {
    const int f = k * blockDim.x + threadIdx.x;
    if (f < quads) {
      uchar4 c;
      c.x = (uint8_t)code_of(__fdiv_rn(v[k].x, scale), thr);
      c.y = (uint8_t)code_of(__fdiv_rn(v[k].y, scale), thr);
      c.z = (uint8_t)code_of(__fdiv_rn(v[k].z, scale), thr);
      c.w = (uint8_t)code_of(__fdiv_rn(v[k].w, scale), thr);
      out[f] = c;
    }
  }
}

template <int LO, int HI>
__device__ __forceinline__ unsigned wire_code(float x, float safe) {
  float q = rintf(__fdiv_rn(x, safe));
  q = fminf(fmaxf(q, (float)LO), (float)HI);
  return (unsigned)(int)q - (unsigned)LO;   // + (-LO): 128 or 8
}

// One warp per wire block of BLOCK values, BLOCK / 128 float4 a lane
// (lane l holds float4s l, l + 32, ...); WIRE_THREADS / 32 blocks a CTA.
// u8 (PACK false): codes[e] for e < n. u4 (PACK true): byte e/2 holds
// elements e (low nibble) and e + 1 (high nibble, 0 when e + 1 == n).
template <int BLOCK, int DIV, int LO, int HI, bool PACK>
__global__ void __launch_bounds__(WIRE_THREADS) wire_quantize_kernel(
    const float* __restrict__ x, long long n, long long n_blocks,
    uint8_t* __restrict__ codes, float* __restrict__ scales) {
  constexpr int VEC = BLOCK / 128;
  const int lane = threadIdx.x & 31;
  const long long blk =
      (long long)blockIdx.x * (WIRE_THREADS / 32) + (threadIdx.x >> 5);
  if (blk >= n_blocks) return;   // the whole warp leaves together
  const long long base = blk * BLOCK;
  float4 v[VEC];
  float m = 0.f;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    v[k] = load4(x, base + 4LL * (k * 32 + lane), n);
    m = abs_max4(m, v[k]);
  }
  m = warp_max(m);
  const float scale = __fdiv_rn(m, (float)DIV);
  const float safe = scale > 0.f ? scale : 1.f;
  if (lane == 0) scales[blk] = scale;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const long long e = base + 4LL * (k * 32 + lane);
    if (e >= n) continue;
    unsigned c0 = wire_code<LO, HI>(v[k].x, safe);
    unsigned c1 = e + 1 < n ? wire_code<LO, HI>(v[k].y, safe) : 0u;
    unsigned c2 = e + 2 < n ? wire_code<LO, HI>(v[k].z, safe) : 0u;
    unsigned c3 = e + 3 < n ? wire_code<LO, HI>(v[k].w, safe) : 0u;
    if (PACK) {
      const uint8_t b0 = (uint8_t)(c0 | (c1 << 4));
      const uint8_t b1 = (uint8_t)(c2 | (c3 << 4));
      if (e + 3 < n) {
        reinterpret_cast<uchar2*>(codes)[e / 4] = make_uchar2(b0, b1);
      } else {
        codes[e / 2] = b0;
        if (e + 2 < n) codes[e / 2 + 1] = b1;
      }
    } else if (e + 3 < n) {
      reinterpret_cast<uchar4*>(codes)[e / 4] =
          make_uchar4((uint8_t)c0, (uint8_t)c1, (uint8_t)c2, (uint8_t)c3);
    } else {
      codes[e] = (uint8_t)c0;
      if (e + 1 < n) codes[e + 1] = (uint8_t)c1;
      if (e + 2 < n) codes[e + 2] = (uint8_t)c2;
    }
  }
}

template <int BLOCK, int DIV, int LO, int HI, bool PACK>
int launch_wire(const void* x, long long n, void* codes, void* scales,
                void* stream) {
  const long long n_blocks = (n + BLOCK - 1) / BLOCK;
  constexpr int per_cta = WIRE_THREADS / 32;
  const long long ctas = (n_blocks + per_cta - 1) / per_cta;
  if (n <= 0 || ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  wire_quantize_kernel<BLOCK, DIV, LO, HI, PACK>
      <<<(unsigned)ctas, WIRE_THREADS, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(x), n, n_blocks,
          static_cast<uint8_t*>(codes), static_cast<float*>(scales));
  return (int)cudaGetLastError();
}

}  // namespace

// x: n f32 (16-byte aligned); thresholds: 256 f32 (the midpoints, +inf);
// codes: n_blocks x block u8; absmax: n_blocks f32. block % 128 == 0 and
// block <= 16384 (the wrapper checks both).
extern "C" int quantize_blockwise(const void* x, long long n, int block,
                                  const void* thresholds, void* codes,
                                  void* absmax, void* stream) {
  const long long n_blocks = (n + block - 1) / block;
  if (n <= 0 || block % 128 || block > 16 * 1024 || n_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int threads = ((block / 16 + 31) / 32) * 32;
  quantize_blockwise_kernel<<<(unsigned)n_blocks, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, block,
      static_cast<const float*>(thresholds), static_cast<uint8_t*>(codes),
      static_cast<float*>(absmax));
  return (int)cudaGetLastError();
}

// x: n f32 (16-byte aligned); codes: n u8; scales: ceil(n/256) f32.
extern "C" int wire_quantize_u8(const void* x, long long n, void* codes,
                                void* scales, void* stream) {
  return launch_wire<256, 127, -128, 127, false>(x, n, codes, scales, stream);
}

// x: n f32 (16-byte aligned); codes: ceil(n/2) u8 (packed nibble pairs);
// scales: ceil(n/1024) f32.
extern "C" int wire_quantize_u4(const void* x, long long n, void* codes,
                                void* scales, void* stream) {
  return launch_wire<1024, 7, -8, 7, true>(x, n, codes, scales, stream);
}

extern "C" const char* quant_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
