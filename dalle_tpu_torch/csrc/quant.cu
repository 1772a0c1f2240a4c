// The quantizers of the 8-bit LAMB and of the swarm wire codec: three
// memory-bound elementwise passes with a per-block absmax.
//
// 1. quantize_blockwise_kernel replaces the TPU kernel
//    dalle_tpu/ops/pallas/quant_kernels.py quantize_blockwise_pallas
//    (_quant_kernel): per quant block of `block` f32 values (4096 in the
//    8-bit LAMB; any block >= 1 here, as the JAX package's XLA path takes),
//    absmax = max|x|, normed = x / (absmax > 0 ? absmax : 1), code = the
//    number of the 255 codebook midpoints strictly below normed (the
//    dynamic-tree codebook, signed or unsigned); outputs the (n_blocks,
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
// one flagship step, and 47 / 42 us for one 31.4 M-element wire part. So
// every design here reads each value once, coalesced as float4 (16 bytes a
// lane) where the layout allows, keeps it in registers through the
// block's max, and writes the codes as one 4-byte (u8) or 2-byte (u4)
// store per float4. The max is exact in any order, so the bytes cannot
// depend on the thread layout, and no kernel here uses atomics.
//
// Byte identity with the JAX package and numpy (the wire is read by peers
// of both codecs, and the optimizer's codes are compared with JAX's):
// - divides are __fdiv_rn, the IEEE round-to-nearest divide that `/` is in
//   numpy and XLA (the JAX package passes 127 and 7 as runtime operands only
//   to stop XLA from turning the divide into a reciprocal multiply); the
//   library is built without fast math (no flush of subnormals), and rintf
//   rounds half to even, as np.rint and jnp.rint do;
// - the max propagates NaN, as XLA's, numpy's and torch's max do (fmaxf
//   would drop it); a NaN absmax then takes the scale 1, as jnp.where does;
// - the tail block is masked (zeros past n), which gives the bytes of the
//   JAX package's zero-padded copy without making one.
//
// quantize_blockwise's codebook lookup. A binary search over the 255
// midpoints is 8 dependent shared-memory probes a value, the later ones
// scattered over the table (bank conflicts); at 41 M values a launch that
// chain, not the bytes, set the first version's time (39% of the byte
// bound). Here a value takes ONE table entry and ONE compare: the table
// (built on the host by dalle_tpu_torch/ops/quant.py bucket_table from the
// same float32 midpoints; the wrapper passes its shift, lo and nb) has an
// entry per bucket of |v|'s float32 bits, (bits >> shift) - lo, shift 17:
// the exponent and the top 6 mantissa bits, from the bucket of the
// smallest nonzero |midpoint| to that of 1.0: 1342 buckets (signed codebook) or 1558 (unsigned), each
// holding at most one midpoint of a sign (the host asserts it). The sign
// bit picks the row (row 0 for +0.0 and up, row 1 for -0.0 and down); an
// entry packs {midpoint bits, base} for one 8-byte load, and
//   code = base + (midpoint < v)
// with base the count of midpoints below the bucket (row 0: below its low
// edge; row 1: at or below minus its high edge) and midpoint +inf where the
// bucket of that sign holds none. Comparing normed itself with the real
// float32 midpoint keeps the search's exact answer: a value on a midpoint
// takes the lower code. Buckets are clamped below, so zeros, subnormals
// and magnitudes below the smallest midpoint take one fixed code (-0.0 and
// tiny negatives land in row 1's first bucket, whose code equals row 0's:
// no midpoint lies between them; the host asserts it). Where the block's
// absmax is finite, |normed| <= 1 and that is all; where it is not (a NaN
// in the block leaves the scale at 1, an inf makes inf/inf), buckets are
// also clamped above, so +inf and values past 1 take 255 (or 0 when
// negative) through the compare, and a NaN takes code 0 explicitly (its
// bits would land in the top bucket). The table (2 x nb x 8 bytes, 21.5
// or 24.9 KB) sits in shared memory: the lanes read different entries,
// which constant memory serialises.
//
// quantize_blockwise's layout. A persistent grid (the occupancy query x
// SMs, capped by the tiles) copies the table once a CTA (cp.async, all
// copies in flight together with the first tile's loads), then walks
// tiles of quant blocks with a stride, a group of `group` threads (a power
// of two) a block: up to QB_R float4s (4 QB_R floats on the scalar path) a
// thread in registers, the next tile's loads issued before this tile's
// reduction and lookups, so they are in flight while it searches. A
// 4096-block takes 256 threads, two to a 512-thread CTA, so that the
// 1 M-element launches of the 8-bit LAMB (256 blocks) copy the table once
// an SM. The block max is max.NaN over the values, a shuffle reduction
// inside the group, plus one shared-memory exchange (double-buffered, one
// barrier) for groups wider than a warp. A block whose base is not
// 16-byte aligned (block % 4 != 0) takes the scalar-load instance. A block
// too large for one CTA's registers takes the two-pass kernel: one CTA a
// block reads it for the max, then reads it again (from L2) to write its
// codes.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int QB_R = 4;             // float4s a thread (x 4 floats, scalar)
constexpr int QB_THREADS = 512;     // threads a CTA, both paths
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

// -- quantize_blockwise -------------------------------------------------

// max(a, b), NaN if either is NaN: one max.NaN (the wire kernels' max_nan
// in one instruction; the operands here are never -0.0)
__device__ __forceinline__ float qb_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

struct QbArgs {
  const float* x;
  long long n;
  long long n_blocks;
  int block;
  int group;             // threads a quant block (register path)
  const uint2* table;    // 2 x nb entries {midpoint bits, base}
  int shift, lo, nb;     // bucket of v: (bits(|v|) >> shift) - lo
  uint8_t* codes;
  float* absmax;
};

// #{k : mid[k] < v} from the bucket table tab (see the note at the top).
// CHECKED: v may be NaN or beyond +-1 (the block's absmax is not finite);
// otherwise |v| <= 1 and only the low clamp is needed.
template <bool CHECKED>
__device__ __forceinline__ unsigned code_of(float v,
                                            const uint2* __restrict__ tab,
                                            const QbArgs& a) {
  const unsigned bits = __float_as_uint(v);
  int b = max((int)((bits & 0x7fffffffu) >> a.shift) - a.lo, 0);
  if (CHECKED) b = min(b, a.nb - 1);
  const uint2 e = tab[b + (int)(bits >> 31) * a.nb];
  unsigned below;   // all ones where the bucket's midpoint is below v
  asm("set.lt.u32.f32 %0, %1, %2;" : "=r"(below)
      : "f"(__uint_as_float(e.x)), "f"(v));
  const unsigned c = e.y - below;
  return (CHECKED && v != v) ? 0u : c;
}

// One load unit: a float4 (VEC) or a float, masked past n.
template <bool VEC> struct Unit;

template <> struct Unit<true> {
  static constexpr int SIZE = 4;
  using T = float4;
  static __device__ __forceinline__ T zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ T load(const float* __restrict__ x,
                                           long long e, long long n) {
    return load4(x, e, n);
  }
  static __device__ __forceinline__ float amax(float m, T q) {
    return qb_max(qb_max(qb_max(qb_max(m, fabsf(q.x)), fabsf(q.y)),
                         fabsf(q.z)), fabsf(q.w));
  }
  template <bool CHECKED>
  static __device__ __forceinline__ void store(const QbArgs& a, long long e,
                                               T q, float scale,
                                               const uint2* tab) {
    uchar4 c;
    c.x = (uint8_t)code_of<CHECKED>(__fdiv_rn(q.x, scale), tab, a);
    c.y = (uint8_t)code_of<CHECKED>(__fdiv_rn(q.y, scale), tab, a);
    c.z = (uint8_t)code_of<CHECKED>(__fdiv_rn(q.z, scale), tab, a);
    c.w = (uint8_t)code_of<CHECKED>(__fdiv_rn(q.w, scale), tab, a);
    reinterpret_cast<uchar4*>(a.codes)[e >> 2] = c;
  }
};

template <> struct Unit<false> {
  static constexpr int SIZE = 1;
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ T load(const float* __restrict__ x,
                                           long long e, long long n) {
    return e < n ? __ldg(x + e) : 0.f;
  }
  static __device__ __forceinline__ float amax(float m, T q) {
    return qb_max(m, fabsf(q));
  }
  template <bool CHECKED>
  static __device__ __forceinline__ void store(const QbArgs& a, long long e,
                                               T q, float scale,
                                               const uint2* tab) {
    a.codes[e] = (uint8_t)code_of<CHECKED>(__fdiv_rn(q, scale), tab, a);
  }
};

// The table into shared memory: 2 nb entries of 8 bytes, nb 16-byte
// cp.async copies all in flight at once; the caller's barrier publishes it.
__device__ __forceinline__ void load_table(uint2* tab, const QbArgs& a) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(tab);
  for (int i = threadIdx.x; i < a.nb; i += blockDim.x)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     dst + 16u * i),
                 "l"(a.table + 2 * i));
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The codes of one block's units held by this thread: the lookup without
// the NaN and range checks where the block's absmax is finite (then
// |x / scale| <= 1), with them otherwise.
template <bool VEC, int R>
__device__ __forceinline__ void store_units(
    const QbArgs& a, const uint2* tab, long long base, int l, int step,
    int units, const typename Unit<VEC>::T (&v)[R], float m) {
  using U = Unit<VEC>;
  const float scale = m > 0.f ? m : 1.f;
  if (m <= 3.402823466e38f) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int f = l + k * step;
      if (f < units)
        U::template store<false>(a, base + (long long)f * U::SIZE, v[k],
                                 scale, tab);
    }
  } else {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int f = l + k * step;
      if (f < units)
        U::template store<true>(a, base + (long long)f * U::SIZE, v[k],
                                scale, tab);
    }
  }
}

// Register path: tile t holds quant blocks t * groups .. + groups - 1;
// thread (group g, lane l) holds units l, l + group, ... (coalesced) of
// block t * groups + g, at most R of them.
template <bool VEC, int R>
__global__ void __launch_bounds__(QB_THREADS) quantize_blockwise_kernel(
    const QbArgs a) {
  using U = Unit<VEC>;
  extern __shared__ __align__(16) uint2 tab[];
  __shared__ float red[2][QB_THREADS / 32];
  const int group = a.group, groups = blockDim.x / group;
  const int g = threadIdx.x / group, l = threadIdx.x % group;
  const int units = a.block / U::SIZE;
  const long long tiles = (a.n_blocks + groups - 1) / groups;

  typename U::T cur[R], nxt[R];
  auto load_tile = [&](typename U::T (&v)[R], long long t) {
    const long long blk = t * groups + g;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int f = l + k * group;
      v[k] = (f < units && blk < a.n_blocks)
                 ? U::load(a.x, blk * a.block + (long long)f * U::SIZE, a.n)
                 : U::zero();
    }
  };
  long long t = blockIdx.x;
  load_tile(cur, t);
  load_table(tab, a);
  __syncthreads();

  int buf = 0;
  for (; t < tiles; t += gridDim.x) {
    float m = 0.f;
#pragma unroll
    for (int k = 0; k < R; ++k) m = U::amax(m, cur[k]);
    load_tile(nxt, t + gridDim.x);   // in flight through the lookups
    for (int off = min(group, 32) >> 1; off > 0; off >>= 1)
      m = qb_max(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (group > 32) {   // uniform across the CTA
      const int warp = threadIdx.x >> 5, per = group >> 5;
      if ((threadIdx.x & 31) == 0) red[buf][warp] = m;
      __syncthreads();
      m = 0.f;
      for (int w = g * per; w < (g + 1) * per; ++w)
        m = qb_max(m, red[buf][w]);
      buf ^= 1;
    }
    const long long blk = t * groups + g;
    if (blk < a.n_blocks) {
      if (l == 0) a.absmax[blk] = m;
      store_units<VEC, R>(a, tab, blk * a.block, l, group, units, cur, m);
    }
#pragma unroll
    for (int k = 0; k < R; ++k) cur[k] = nxt[k];
  }
}

// Two-pass path for blocks wider than QB_THREADS x QB_R units: one CTA a
// block at a time, the max from a first read, the codes from a second.
template <bool VEC>
__global__ void __launch_bounds__(QB_THREADS)
    quantize_blockwise_two_pass_kernel(const QbArgs a) {
  using U = Unit<VEC>;
  extern __shared__ __align__(16) uint2 tab[];
  __shared__ float red[2][QB_THREADS / 32];
  const int units = a.block / U::SIZE;
  load_table(tab, a);
  __syncthreads();
  int buf = 0;
  for (long long blk = blockIdx.x; blk < a.n_blocks; blk += gridDim.x) {
    const long long base = blk * a.block;
    float m = 0.f;
#pragma unroll 4
    for (int f = threadIdx.x; f < units; f += blockDim.x)
      m = U::amax(m, U::load(a.x, base + (long long)f * U::SIZE, a.n));
    for (int off = 16; off > 0; off >>= 1)
      m = qb_max(m, __shfl_xor_sync(0xffffffffu, m, off));
    if ((threadIdx.x & 31) == 0) red[buf][threadIdx.x >> 5] = m;
    __syncthreads();
    m = 0.f;
    for (int w = 0; w < QB_THREADS / 32; ++w) m = qb_max(m, red[buf][w]);
    buf ^= 1;
    if (threadIdx.x == 0) a.absmax[blk] = m;
    for (int f0 = 0; f0 < units; f0 += 4 * blockDim.x) {
      typename U::T v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int f = f0 + threadIdx.x + k * blockDim.x;
        v[k] = f < units ? U::load(a.x, base + (long long)f * U::SIZE, a.n)
                         : U::zero();
      }
      store_units<VEC, 4>(a, tab, base, f0 + threadIdx.x, blockDim.x, units,
                          v, m);
    }
  }
}

// How a block size is computed: the kernel instance, its threads, the
// threads a quant block and the tiles to walk.
struct QbPlan {
  const void* kernel;
  int threads, group;
  long long tiles;
  size_t smem;
};

QbPlan qb_plan(int block, long long n_blocks, int nb) {
  const bool vec = block % 4 == 0;
  const int units = vec ? block / 4 : block;
  const int per_thread = vec ? QB_R : 4 * QB_R;
  const long long need = ((long long)units + per_thread - 1) / per_thread;
  QbPlan p;
  p.smem = (size_t)nb * 2 * sizeof(uint2);
  if (need <= QB_THREADS) {
    p.group = 1;
    while (p.group < need) p.group <<= 1;
    p.threads = QB_THREADS;
    p.tiles = (n_blocks + QB_THREADS / p.group - 1) / (QB_THREADS / p.group);
    p.kernel = vec ? (const void*)quantize_blockwise_kernel<true, QB_R>
                   : (const void*)quantize_blockwise_kernel<false, 4 * QB_R>;
  } else {
    p.group = p.threads = QB_THREADS;
    p.tiles = n_blocks;
    p.kernel = vec ? (const void*)quantize_blockwise_two_pass_kernel<true>
                   : (const void*)quantize_blockwise_two_pass_kernel<false>;
  }
  return p;
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

// Resident CTAs an SM of one kernel instance with smem bytes of table
// (the occupancy query), cached: the instances are few and fixed.
int qb_per_sm(const void* kernel, int threads, size_t smem, int* per_sm) {
  struct Entry {
    const void* kernel;
    size_t smem;
    int per_sm;
  };
  static Entry cache[16];
  static int used = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> hold(mu);
  for (int i = 0; i < used; ++i)
    if (cache[i].kernel == kernel && cache[i].smem == smem) {
      *per_sm = cache[i].per_sm;
      return 0;
    }
  const int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, kernel, threads, smem);
  if (err != 0) return err;
  if (used < 16) cache[used++] = Entry{kernel, smem, *per_sm};
  return 0;
}

}  // namespace

// x: n f32 (16-byte aligned); table: 2 x nb x {midpoint bits, base} u32
// (ops/quant.py bucket_table), a value's bucket (bits(|v|) >> shift) - lo;
// codes: n_blocks x block u8; absmax: n_blocks f32. Any block >= 1. The
// grid is persistent: every SM's resident CTAs, no more than the tiles.
extern "C" int quantize_blockwise(const void* x, long long n, int block,
                                  const void* table, int shift, int lo,
                                  int nb, void* codes, void* absmax,
                                  void* stream) {
  if (n <= 0 || block < 1 || nb < 1 || shift < 0 || shift > 23)
    return (int)cudaErrorInvalidValue;
  const long long n_blocks = (n + block - 1) / block;
  const QbPlan p = qb_plan(block, n_blocks, nb);
  int dev = 0, sms = 0, per_sm = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err == 0)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (err == 0) err = qb_per_sm(p.kernel, p.threads, p.smem, &per_sm);
  if (err != 0) return err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long all = (long long)sms * per_sm;
  const int grid = (int)(p.tiles < all ? p.tiles : all);
  QbArgs a{static_cast<const float*>(x), n, n_blocks, block, p.group,
           static_cast<const uint2*>(table), shift, lo, nb,
           static_cast<uint8_t*>(codes), static_cast<float*>(absmax)};
  void* args[] = {&a};
  return (int)cudaLaunchKernel(p.kernel, dim3(grid), dim3(p.threads), args,
                               p.smem, static_cast<cudaStream_t>(stream));
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
