// Flash-attention backward (K2: dq, K3: dk and dv) for Hopper, sm_90a.
//
// Replace the TPU kernels turboprune_tpu/ops/flash.py::_dq_kernel (K2, the
// pl.pallas_call at :233) and ::_dkv_kernel (K3, at :251). Same functions:
// given q, k, v, dO [B*H, S, D], the key-validity row [S] shared by every
// (batch, head), the forward's row logsumexp lse [B*H, S] and
// drow = sum_d dO*O [B*H, S] (both fp32), each kernel recomputes, tile by
// tile, s = (q*scale) k^T in fp32 (invalid keys: p = 0), p = exp(s - lse),
// dp = dO v^T and ds = p * (dp - drow) * scale, and accumulates
//   K2: dq += ds k            (one block per (b*h, 64 query rows), loop over key tiles)
//   K3: dv += p^T dO, dk += ds^T q   (one block per (b*h, 64 keys), loop over query tiles)
// in fp32 registers, writing dq, dk, dv once in the input dtype. The TPU's
// two-kernel split is kept: no atomics, so the gradients are deterministic,
// and the TPU's sequential third grid axis becomes the loop inside a block.
//
// Numerics, as the TPU kernels: s and dp come from upcast 16-bit operands,
// whose products are exact in fp32, so bf16/fp16 wmma (16x16x16, fp32
// accumulate) computes them, with the scale applied to the fp32 scores;
// fp32 inputs take scalar FMAs with q scaled per element, as the plain
// version does. p and ds stay fp32: the three products with an fp32 operand
// (ds k, p^T dO, ds^T q) run as scalar fp32 FMAs on the CUDA cores with the
// 16-bit operand upcast exactly. Rounding p or ds to bf16 to feed the tensor
// cores would change the result; splitting them into bf16 hi + lo terms on
// the tensor cores is the way to speed that keeps them (later work).
//
// What bounds it on an H100: at the training shape (B*H = 1536, S = 256 with
// 197 valid keys, D = 64, bf16) K2 must move ~232 MB (0.069 ms at
// 3.35 TB/s) and K3 ~282 MB (0.084 ms), while the fp32-operand products are
// 9.9 GFLOP (K2) and 19.8 GFLOP (K3), 0.148 ms and 0.296 ms at the fp32
// CUDA cores' 67 TFLOP/s, next to 0.02 ms for the two tensor-core products.
// So both are bound by operations on the fp32 cores, by this design's
// choice of precision. The design keeps those products fed from shared
// memory: each lane owns a 4 x 8 block of its accumulator and reads, per
// step of the reduction, one 16-byte load of p or ds (stored so that the 4
// values are contiguous) and one 16-byte load of the 16-bit operand row, for
// 32 FMAs. Scores and probabilities never leave shared memory.
//
// Layout (simple first): 4 warps; all tiles are 64 rows; q/dO/k/v tiles are
// staged in shared memory (rows padded to keep 16-byte alignment), scores
// and dp in two fp32 [64][68] tiles that the elementwise pass overwrites
// with p and ds. Each warp owns 16 rows of the accumulator (K2: query rows;
// K3: keys), computes exactly the scores its product needs, and so syncs
// only with itself inside a tile. Synchronous loads; cp.async/TMA and
// wgmma are later work.

#include <mma.h>

#include "flash_common.cuh"

namespace {

using flash::D;
using flash::load8;
using flash::store8;

constexpr int T64 = 64;             // rows of every tile (queries or keys)
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int CLD = T64 + 4;        // fp32 row stride of the score tiles

template <typename T>
struct Ld {  // 16-bit: rows padded by 16 bytes, wmma-aligned
  static constexpr int V = D + 8;
};
template <>
struct Ld<float> {  // fp32: rows stay 16-byte aligned for the vector loads
  static constexpr int V = D + 4;
};

// Byte offsets of the shared-memory regions; each starts 128-byte aligned.
template <typename T>
struct Smem {
  static constexpr int TILE = flash::round_up(T64 * Ld<T>::V * (int)sizeof(T), 128);
  static constexpr int SCORES = flash::round_up(T64 * CLD * (int)sizeof(float), 128);
  static constexpr int A = 0;             // K2: q   K3: k
  static constexpr int B = A + TILE;      // K2: dO  K3: v
  static constexpr int C = B + TILE;      // K2: k   K3: q
  static constexpr int E = C + TILE;      // K2: v   K3: dO
  static constexpr int S = E + TILE;      // scores, then p
  static constexpr int P = S + SCORES;    // dp, then ds
  static constexpr int VEC = P + SCORES;  // lse[64], drow[64], valid[64]
  static constexpr int BYTES = VEC + 3 * T64 * (int)sizeof(float);
};

template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src) {
  flash::load_rows<T, Ld<T>::V, THREADS>(dst, src, T64, 1.0f);
}

// C[16][64] = (sa * A[16][D]) (sb * B[64][D])^T in fp32, stored so that
// element (i, j) lands at out[j * CLD + i]. A and B are row-major tiles in
// shared memory at stride Ld<T>::V.
template <typename T>
__device__ __forceinline__ void warp_nt(const T* A, const T* B, float* out, float sa,
                                        float sb, int lane) {
  using namespace nvcuda;
  constexpr int LD = Ld<T>::V;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> af[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wmma::load_matrix_sync(af[kk], A + kk * 16, LD);
  const float scale = sa * sb;
#pragma unroll
  for (int n = 0; n < T64 / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> cf;
    wmma::fill_fragment(cf, 0.0f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // B^T: element (d, j) sits at B[j * LD + d], i.e. column-major.
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> bf;
      wmma::load_matrix_sync(bf, B + n * 16 * LD + kk * 16, LD);
      wmma::mma_sync(cf, af[kk], bf, cf);
    }
#pragma unroll
    for (int i = 0; i < cf.num_elements; ++i) cf.x[i] *= scale;
    wmma::store_matrix_sync(out + n * 16 * CLD, cf, CLD, wmma::mem_col_major);
  }
}

// fp32: scalar FMAs, each operand scaled per element before the product (as
// the plain version scales q before its fp32 matmul). Lane (i, jh) computes
// row i against columns jh, jh + 2, ...
template <>
__device__ __forceinline__ void warp_nt<float>(const float* A, const float* B, float* out,
                                               float sa, float sb, int lane) {
  constexpr int LD = Ld<float>::V;
  const int i = lane & 15, jh = lane >> 4;
  const float* arow = A + i * LD;
  for (int t = 0; t < T64 / 2; ++t) {
    const int j = jh + 2 * t;
    const float* brow = B + j * LD;
    float s = 0.0f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) s = fmaf(arow[d] * sa, brow[d] * sb, s);
    out[j * CLD + i] = s;
  }
}

// K2: one block per (b*h, 64 query rows); warp w owns query rows 16w..16w+15
// and lane (ly, lx) the dq block rows 4ly..4ly+3, columns 8lx..8lx+7 of them.
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ valid, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ drow,
                    T* __restrict__ dq, int seq, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = Smem<T>;
  constexpr int LD = Ld<T>::V;
  T* Qs = reinterpret_cast<T*>(smem + L::A);
  T* dOs = reinterpret_cast<T*>(smem + L::B);
  T* Ks = reinterpret_cast<T*>(smem + L::C);
  T* Vs = reinterpret_cast<T*>(smem + L::E);
  float* Ss = reinterpret_cast<float*>(smem + L::S);  // (row i, key c) at c * CLD + i
  float* Ps = reinterpret_cast<float*>(smem + L::P);
  float* LSE = reinterpret_cast<float*>(smem + L::VEC);
  float* DROW = LSE + T64;
  float* VALID = DROW + T64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ly = lane >> 3, lx = lane & 7;
  const int w0 = warp * 16;

  const int q_tiles = seq / T64;
  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * T64;
  const size_t base = (size_t)bh * seq * D;

  load_tile<T>(Qs, q + base + (size_t)q0 * D);
  load_tile<T>(dOs, dout + base + (size_t)q0 * D);
  for (int i = threadIdx.x; i < T64; i += THREADS) {
    LSE[i] = lse[(size_t)bh * seq + q0 + i];
    DROW[i] = drow[(size_t)bh * seq + q0 + i];
  }

  float acc[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[a][j] = 0.0f;

  for (int k0 = 0; k0 < seq; k0 += T64) {
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile<T>(Ks, k + base + (size_t)k0 * D);
    load_tile<T>(Vs, v + base + (size_t)k0 * D);
    for (int i = threadIdx.x; i < T64; i += THREADS) VALID[i] = valid[k0 + i];
    __syncthreads();

    warp_nt<T>(Qs + w0 * LD, Ks, Ss + w0, scale, 1.0f, lane);  // s
    warp_nt<T>(dOs + w0 * LD, Vs, Ps + w0, 1.0f, 1.0f, lane);  // dp
    __syncwarp();
    for (int e = lane; e < 16 * T64; e += 32) {
      const int i = e & 15, c = e >> 4;
      const int at = c * CLD + w0 + i;
      const float p = VALID[c] > 0.0f ? expf(Ss[at] - LSE[w0 + i]) : 0.0f;
      Ps[at] = p * (Ps[at] - DROW[w0 + i]) * scale;  // ds
    }
    __syncwarp();
    for (int c = 0; c < T64; ++c) {
      const float4 ds = *reinterpret_cast<const float4*>(Ps + c * CLD + w0 + 4 * ly);
      float kr[8];
      load8<T>(Ks + c * LD + 8 * lx, kr);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[0][j] = fmaf(ds.x, kr[j], acc[0][j]);
        acc[1][j] = fmaf(ds.y, kr[j], acc[1][j]);
        acc[2][j] = fmaf(ds.z, kr[j], acc[2][j]);
        acc[3][j] = fmaf(ds.w, kr[j], acc[3][j]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a)
    store8<T>(dq + base + (size_t)(q0 + w0 + 4 * ly + a) * D + 8 * lx, acc[a]);
}

// K3: one block per (b*h, 64 keys); warp w owns keys 16w..16w+15 and lane
// (ly, lx) the dk and dv block rows 4ly..4ly+3, columns 8lx..8lx+7 of them.
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ valid, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ drow,
                     T* __restrict__ dk, T* __restrict__ dv, int seq, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = Smem<T>;
  constexpr int LD = Ld<T>::V;
  T* Ks = reinterpret_cast<T*>(smem + L::A);
  T* Vs = reinterpret_cast<T*>(smem + L::B);
  T* Qs = reinterpret_cast<T*>(smem + L::C);
  T* dOs = reinterpret_cast<T*>(smem + L::E);
  float* Ss = reinterpret_cast<float*>(smem + L::S);  // (row r, key c) at r * CLD + c
  float* Ps = reinterpret_cast<float*>(smem + L::P);
  float* LSE = reinterpret_cast<float*>(smem + L::VEC);
  float* DROW = LSE + T64;
  float* VALID = DROW + T64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ly = lane >> 3, lx = lane & 7;
  const int w0 = warp * 16;

  const int k_tiles = seq / T64;
  const int bh = blockIdx.x / k_tiles;
  const int k0 = (blockIdx.x % k_tiles) * T64;
  const size_t base = (size_t)bh * seq * D;

  load_tile<T>(Ks, k + base + (size_t)k0 * D);
  load_tile<T>(Vs, v + base + (size_t)k0 * D);
  for (int i = threadIdx.x; i < T64; i += THREADS) VALID[i] = valid[k0 + i];

  float acc_k[4][8], acc_v[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc_k[a][j] = acc_v[a][j] = 0.0f;

  for (int q0 = 0; q0 < seq; q0 += T64) {
    __syncthreads();  // every warp is done with the previous q/dO tile
    load_tile<T>(Qs, q + base + (size_t)q0 * D);
    load_tile<T>(dOs, dout + base + (size_t)q0 * D);
    for (int i = threadIdx.x; i < T64; i += THREADS) {
      LSE[i] = lse[(size_t)bh * seq + q0 + i];
      DROW[i] = drow[(size_t)bh * seq + q0 + i];
    }
    __syncthreads();

    // Transposed products, so that the warp's 16 keys are the columns
    // w0..w0+15 of row-major [query][key] tiles.
    warp_nt<T>(Ks + w0 * LD, Qs, Ss + w0, 1.0f, scale, lane);  // s
    warp_nt<T>(Vs + w0 * LD, dOs, Ps + w0, 1.0f, 1.0f, lane);  // dp
    __syncwarp();
    for (int e = lane; e < 16 * T64; e += 32) {
      const int i = e & 15, r = e >> 4;
      const int at = r * CLD + w0 + i;
      const float p = VALID[w0 + i] > 0.0f ? expf(Ss[at] - LSE[r]) : 0.0f;
      Ss[at] = p;
      Ps[at] = p * (Ps[at] - DROW[r]) * scale;  // ds
    }
    __syncwarp();
    for (int r = 0; r < T64; ++r) {
      const float4 p = *reinterpret_cast<const float4*>(Ss + r * CLD + w0 + 4 * ly);
      const float4 ds = *reinterpret_cast<const float4*>(Ps + r * CLD + w0 + 4 * ly);
      float dor[8], qr[8];
      load8<T>(dOs + r * LD + 8 * lx, dor);
      load8<T>(Qs + r * LD + 8 * lx, qr);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc_v[0][j] = fmaf(p.x, dor[j], acc_v[0][j]);
        acc_v[1][j] = fmaf(p.y, dor[j], acc_v[1][j]);
        acc_v[2][j] = fmaf(p.z, dor[j], acc_v[2][j]);
        acc_v[3][j] = fmaf(p.w, dor[j], acc_v[3][j]);
        acc_k[0][j] = fmaf(ds.x, qr[j], acc_k[0][j]);
        acc_k[1][j] = fmaf(ds.y, qr[j], acc_k[1][j]);
        acc_k[2][j] = fmaf(ds.z, qr[j], acc_k[2][j]);
        acc_k[3][j] = fmaf(ds.w, qr[j], acc_k[3][j]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const size_t row = base + (size_t)(k0 + w0 + 4 * ly + a) * D + 8 * lx;
    store8<T>(dk + row, acc_k[a]);
    store8<T>(dv + row, acc_v[a]);
  }
}

// Above 48 KB of shared memory a launch needs the opt-in attribute, which
// belongs to the current device.
template <typename T>
cudaError_t prepare() {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<T>::BYTES);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(flash_bwd_dkv_kernel<T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<T>::BYTES);
}

struct Args {
  const void *q, *k, *v, *valid, *dout, *lse, *drow;
  int bh, seq;
  float scale;
  cudaStream_t stream;
};

template <typename T>
int launch_dq(const Args& a, void* dq) {
  flash_bwd_dq_kernel<T><<<a.bh * (a.seq / T64), THREADS, Smem<T>::BYTES, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const float*>(a.valid), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.drow),
      static_cast<T*>(dq), a.seq, a.scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const Args& a, void* dk, void* dv) {
  flash_bwd_dkv_kernel<T><<<a.bh * (a.seq / T64), THREADS, Smem<T>::BYTES, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const float*>(a.valid), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.drow),
      static_cast<T*>(dk), static_cast<T*>(dv), a.seq, a.scale);
  return (int)cudaGetLastError();
}

bool bad_shape(int bh, int seq, int d) {
  return d != D || seq <= 0 || seq % 128 != 0 || bh <= 0;
}

}  // namespace

// Sets the shared-memory opt-in of every instantiation on the current device.
// Call once per device before the first launch on it. Returns the
// cudaError_t (0 = success).
extern "C" int flash_bwd_prepare() {
  cudaError_t err = prepare<float>();
  if (err == cudaSuccess) err = prepare<__nv_bfloat16>();
  if (err == cudaSuccess) err = prepare<__half>();
  return (int)err;
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. q, k, v, dout, dq:
// contiguous [bh, seq, 64]; valid: float32 [seq]; lse, drow: float32
// [bh, seq]. seq must be a multiple of 128. Returns the cudaError_t of the
// launch (0 = success).
extern "C" int flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                            const void* valid, const void* dout, const void* lse,
                            const void* drow, void* dq, int bh, int seq, int d, float scale,
                            void* stream) {
  if (bad_shape(bh, seq, d)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, valid, dout, lse, drow, bh, seq, scale,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return launch_dq<float>(a, dq);
    case 1: return launch_dq<__nv_bfloat16>(a, dq);
    case 2: return launch_dq<__half>(a, dq);
    default: return (int)cudaErrorInvalidValue;
  }
}

// As flash_bwd_dq; writes dk and dv (contiguous [bh, seq, 64], input dtype).
extern "C" int flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                             const void* valid, const void* dout, const void* lse,
                             const void* drow, void* dk, void* dv, int bh, int seq, int d,
                             float scale, void* stream) {
  if (bad_shape(bh, seq, d)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, valid, dout, lse, drow, bh, seq, scale,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return launch_dkv<float>(a, dk, dv);
    case 1: return launch_dkv<__nv_bfloat16>(a, dk, dv);
    case 2: return launch_dkv<__half>(a, dk, dv);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
