// Tensor-core and asynchronous-copy pieces of the 16-bit flash kernels
// (flash_fwd.cu, flash_bwd.cu): cp.async, ldmatrix, mma.sync.m16n8k16 with
// fp32 accumulation, reductions over the four lanes that share a fragment
// row, and the split of an fp32 operand into 16-bit hi + lo terms. sm_80
// and later instructions; the kernels build for sm_90a.
//
// Fragment layouts of mma.sync.m16n8k16 (PTX ISA), for lane = 4 g + t:
//   A (16 x 16, row-major), 4 registers of two 16-bit values each:
//     a[0]: row g,   cols 2t, 2t+1     a[2]: row g,   cols 8+2t, 9+2t
//     a[1]: row g+8, cols 2t, 2t+1     a[3]: row g+8, cols 8+2t, 9+2t
//   B (16 x 8, k x n), 2 registers: b[0]: k = 2t, 2t+1, n = g;
//     b[1]: k = 8+2t, 9+2t, n = g
//   C (16 x 8, fp32): c[0], c[1]: row g, cols 2t, 2t+1; c[2], c[3]: row g+8.
// So the C tiles of columns 16j..16j+7 and 16j+8..16j+15 are, packed in
// pairs, the A fragment of k-step j: a product's fp32 result feeds the next
// product from registers (pack_a below).

#pragma once

#include "flash_common.cuh"

namespace flash {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory into shared memory, asynchronously, cached in
// L2 only. Both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until every committed group of this thread has landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 matrices of 16-bit values from shared memory; lane l gives the
// address of row l % 8 of matrix l / 8 (a pointer, or a shared-space
// address from smem_u32) and receives, in r[i], the two values of matrix i
// at (row l / 4, cols 2 (l % 4), +1): of its transpose with `trans`.
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) { ldsm_x4(r, smem_u32(p)); }
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  ldsm_x4_trans(r, smem_u32(p));
}

// c += a b on the tensor cores, m16n8k16, fp32 accumulation (products of
// 16-bit values are exact in fp32).
template <typename T>
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float c[4], const uint32_t a[4],
                                                        uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float c[4], const uint32_t a[4], uint32_t b0,
                                                 uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Max and sum over the four lanes 4g..4g+3 that hold one row of a C
// fragment (every lane gets the result).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Two fp32 values rounded to nearest into one register of two T (x low).
template <typename T> __device__ __forceinline__ uint32_t pack2(float x, float y);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float x, float y) {
  const __half2 h = __floats2half2_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}
template <typename T> __device__ __forceinline__ float2 unpack2(uint32_t r);
template <> __device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t r) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
}
template <> __device__ __forceinline__ float2 unpack2<__half>(uint32_t r) {
  return __half22float2(*reinterpret_cast<const __half2*>(&r));
}

// x = hi + lo + e: hi = rn(x), lo = rn(x - hi) in T (x - hi is exact in
// fp32), so |e| <= u^2 |x| with u the unit roundoff of T: 2^-16 for bf16,
// 2^-22 for fp16 (where lo stays a normal number). Two tensor-core
// products hi B + lo B then stand for the fp32-operand product x B.
template <typename T>
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  hi = pack2<T>(x, y);
  const float2 h = unpack2<T>(hi);
  lo = pack2<T>(x - h.x, y - h.y);
}

// The A fragments (hi and lo) of k-step j from the fp32 C tiles c[2j] and
// c[2j+1] of a 16-row product held in registers.
template <typename T>
__device__ __forceinline__ void pack_a(const float c0[4], const float c1[4], uint32_t hi[4],
                                       uint32_t lo[4]) {
  split2<T>(c0[0], c0[1], hi[0], lo[0]);
  split2<T>(c0[2], c0[3], hi[1], lo[1]);
  split2<T>(c1[0], c1[1], hi[2], lo[2]);
  split2<T>(c1[2], c1[3], hi[3], lo[3]);
}

}  // namespace flash
