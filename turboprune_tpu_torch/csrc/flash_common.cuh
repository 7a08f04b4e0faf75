// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the head dim, the masked-score constant, dtype conversions and the tile
// loads from device memory into shared memory. ops/build.py keys every
// kernel's build on this header too, so an edit here rebuilds them all.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int D = 64;                // head dim (every registered DeiT)
constexpr float NEG_BIG = -1e30f;    // score of an invalid key, as the TPU kernels

constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// Copy `rows` x D elements from device memory (row stride D) into shared
// memory (row stride LD), 16 bytes per thread per step. fp32 elements are
// multiplied by `mul` on the way (1 leaves them exact); 16-bit ones are
// copied as they are.
template <typename T, int LD, int NTHREADS>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src, int rows,
                                          float mul) {
  constexpr int VEC = 16 / sizeof(T);
  const int chunks = rows * (D / VEC);
  for (int c = threadIdx.x; c < chunks; c += NTHREADS) {
    const int r = c / (D / VEC);
    const int col = (c % (D / VEC)) * VEC;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)r * D + col);
    if constexpr (sizeof(T) == 2) {
      *reinterpret_cast<uint4*>(dst + r * LD + col) = raw;
    } else {
      const float* e = reinterpret_cast<const float*>(&raw);
#pragma unroll
      for (int i = 0; i < VEC; ++i) dst[r * LD + col + i] = e[i] * mul;
    }
  }
}

// Eight consecutive elements at a 16-byte aligned address, as fp32 (exact).
template <typename T> __device__ __forceinline__ void load8(const T* p, float out[8]);
template <> __device__ __forceinline__ void load8<float>(const float* p, float out[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
template <> __device__ __forceinline__ void load8<__nv_bfloat16>(const __nv_bfloat16* p,
                                                                 float out[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
template <> __device__ __forceinline__ void load8<__half>(const __half* p, float out[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Round eight fp32 values to T and store them at a 16-byte aligned address
// (one 16-byte store for 16-bit types, two for fp32).
template <typename T> __device__ __forceinline__ void store8(T* p, const float v[8]) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    uint4 raw;
    T* h = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] = from_f32<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

}  // namespace flash
