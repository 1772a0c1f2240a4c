// The mma.sync building blocks of the generic tensor-core kernels
// (geglu_generic.cu, attention_window_generic.cuh): the operand dtypes'
// conversions, cp.async copies, ldmatrix fragment loads, the bf16 and TF32
// mma.sync, and the 3xTF32 split of an f32 operand. Everything is in
// namespace tc, so that a source may include attention_common.cuh (whose
// second section has copies of a few of these for the fast kernels)
// beside it.
//
// The 3xTF32 split: an f32 a is taken as hi + lo, hi = a rounded to TF32
// (nearest, ties away from zero: what cvt.rna.tf32.f32 gives for finite
// a, in two integer operations; ptxas expands the cvt into about five) and
// lo = a - hi (exact) cut to TF32 by truncation (as CUTLASS's 3xTF32 cuts
// it; a raw f32 handed to a TF32 mma would be truncated too). A product is
// summed as lo.hi + hi.lo, then hi.hi (lo.lo is dropped).
// ops/geglu.py's split_tf32 is the same split on the CPU.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace tc {

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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; zeros when !valid (source size 0 reads
// nothing, so gmem only has to be a valid pointer).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

// BYTES (4 or 8) from global to shared, through L1; zeros when !valid.
template <int BYTES>
__device__ __forceinline__ void cp_async_ca(void* smem, const void* gmem,
                                            bool valid) {
  static_assert(BYTES == 4 || BYTES == 8, "cp.async.ca takes 4, 8 or 16");
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "n"(BYTES), "r"(valid ? BYTES : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 3xTF32 split of the f32 whose bits are `raw` (see the note above).
__device__ __forceinline__ void split_tf32(uint32_t raw, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (raw + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(__uint_as_float(raw) - __uint_as_float(hi)) &
       0xFFFFE000u;
}

}  // namespace tc
