// Flash-attention forward (K1) for Hopper, sm_90a.
//
// Replaces the TPU kernel turboprune_tpu/ops/flash.py::_fwd_kernel (the
// pl.pallas_call in _flash_fwd). Same function: non-causal attention over
// [B*H, S, D] with one key-validity row [1, S] shared by every (batch, head),
// computed by the online-softmax recurrence over key tiles of 128, so the
// S x S score matrix never reaches device memory. Outputs o (input dtype) and
// the row logsumexp lse [B*H, S] in fp32.
//
// Numerics follow the TPU kernel step by step: scores in fp32 (bf16/fp16
// products are exact in fp32 and accumulate in fp32 on the tensor cores);
// invalid keys get -1e30; p = exp(s - m_new) * valid; the running sum l adds
// the fp32 p; p is rounded to the input dtype before the PV product, which
// accumulates in fp32; o = acc / max(l, 1e-30); lse = m + log(max(l, 1e-30)).
// The scale is applied to the fp32 score accumulator (16-bit inputs) or to q
// in fp32 before the product (fp32 inputs): the same value when the scale is
// a power of two, as 1/sqrt(64) is.
//
// What bounds it on an H100: at the served shapes (B*H = 768, S = 256 of
// which 197 keys are valid, D = 64, bf16) the function must read q and the
// valid rows of k and v and write o and lse, about 90 MB, or 27 us at
// 3.35 TB/s, while the valid keys' 9.9 GFLOP take 10 us at the tensor cores'
// 989 TFLOP/s. So it is bound by bytes. (The kernel loads whole 128-key
// tiles, padded keys included: 101 MB.) The design therefore reads each q
// row once and each k/v tile once per 64-row query tile (4 query tiles share
// a (b, h) slice, so k and v are read 4 times, mostly from L2), keeps scores
// and probabilities in shared memory only, and writes o once through a
// shared-memory staging tile so that the stores are coalesced.
//
// Design (simple first): one block of 4 warps per (b*h, 64-row query tile);
// each warp owns 16 query rows. A loop inside the block walks the 128-key
// tiles, staging K, V and the validity row in shared memory. bf16/fp16 use
// the tensor cores through wmma (16x16x16, fp32 accumulate); fp32 uses
// scalar FMAs so that it keeps full fp32 precision. The running max m, sum
// l and the output accumulator live in fp32 registers; lane pair (2r, 2r+1)
// owns query row r of its warp. TMA/wgmma pipelining is later work.

#include <mma.h>

#include "flash_common.cuh"

namespace {

using flash::D;
using flash::from_f32;
using flash::NEG_BIG;
using flash::round_up;

constexpr int KT = 128;       // keys per tile (block_k)
constexpr int QT = 64;        // query rows per block
constexpr int WARPS = QT / 16;
constexpr int THREADS = WARPS * 32;
constexpr int SLD = KT + 4;   // fp32 score row stride (also o staging)
constexpr int OLD = D + 4;    // fp32 o staging row stride, aliases the scores

template <typename T>
struct Traits {  // 16-bit types: rows padded by 16 bytes, wmma-aligned
  static constexpr int LD = D + 8;
  static constexpr int PLD = KT + 8;
};
template <>
struct Traits<float> {  // fp32: odd strides, conflict-free scalar reads
  static constexpr int LD = D + 1;
  static constexpr int PLD = KT + 1;
};

// Byte offsets of the shared-memory regions; each starts 128-byte aligned.
template <typename T>
struct Smem {
  static constexpr int Q = 0;
  static constexpr int K = round_up(Q + QT * Traits<T>::LD * (int)sizeof(T), 128);
  static constexpr int V = round_up(K + KT * Traits<T>::LD * (int)sizeof(T), 128);
  static constexpr int M = round_up(V + KT * Traits<T>::LD * (int)sizeof(T), 128);
  static constexpr int S = round_up(M + KT * (int)sizeof(float), 128);
  static constexpr int P = round_up(S + WARPS * 16 * SLD * (int)sizeof(float), 128);
  static constexpr int BYTES = round_up(P + WARPS * 16 * Traits<T>::PLD * (int)sizeof(T), 128);
};

// Copy `rows` x D elements into shared memory at this kernel's row stride;
// fp32 q is pre-scaled here.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, int rows,
                                          float mul) {
  flash::load_rows<T, Traits<T>::LD, THREADS>(dst, src, rows, mul);
}

// Scores of this warp's 16 query rows against the 128 keys of the tile,
// scaled, in fp32, into Sw[16][SLD].
template <typename T>
__device__ __forceinline__ void warp_scores(const T* Qw, const T* Ks, float* Sw, float scale,
                                            int lane) {
  using namespace nvcuda;
  constexpr int LD = Traits<T>::LD;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> qf[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wmma::load_matrix_sync(qf[kk], Qw + kk * 16, LD);
#pragma unroll
  for (int n = 0; n < KT / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
    wmma::fill_fragment(sf, 0.0f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // B = K^T: element (d, key) sits at Ks[key * LD + d], i.e. column-major.
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> kf;
      wmma::load_matrix_sync(kf, Ks + n * 16 * LD + kk * 16, LD);
      wmma::mma_sync(sf, qf[kk], kf, sf);
    }
#pragma unroll
    for (int i = 0; i < sf.num_elements; ++i) sf.x[i] *= scale;
    wmma::store_matrix_sync(Sw + n * 16, sf, SLD, wmma::mem_row_major);
  }
}

template <>
__device__ __forceinline__ void warp_scores<float>(const float* Qw, const float* Ks, float* Sw,
                                                   float /*scale: folded into q*/, int lane) {
  constexpr int LD = Traits<float>::LD;
  const int row = lane >> 1, half = lane & 1;
  const float* qrow = Qw + row * LD;
  for (int t = 0; t < KT / 2; ++t) {
    const int c = half + 2 * t;
    const float* krow = Ks + c * LD;
    float s = 0.0f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) s = fmaf(qrow[d], krow[d], s);
    Sw[row * SLD + c] = s;
  }
}

// O_tile[16][D] = P[16][KT] . V[KT][D] in fp32, into Ow[16][OLD].
template <typename T>
__device__ __forceinline__ void warp_pv(const T* Pw, const T* Vs, float* Ow, int lane) {
  using namespace nvcuda;
  constexpr int LD = Traits<T>::LD;
  constexpr int PLD = Traits<T>::PLD;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> of[D / 16];
#pragma unroll
  for (int nd = 0; nd < D / 16; ++nd) wmma::fill_fragment(of[nd], 0.0f);
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> pf;
    wmma::load_matrix_sync(pf, Pw + kk * 16, PLD);
#pragma unroll
    for (int nd = 0; nd < D / 16; ++nd) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> vf;
      wmma::load_matrix_sync(vf, Vs + kk * 16 * LD + nd * 16, LD);
      wmma::mma_sync(of[nd], pf, vf, of[nd]);
    }
  }
#pragma unroll
  for (int nd = 0; nd < D / 16; ++nd)
    wmma::store_matrix_sync(Ow + nd * 16, of[nd], OLD, wmma::mem_row_major);
}

template <>
__device__ __forceinline__ void warp_pv<float>(const float* Pw, const float* Vs, float* Ow,
                                               int lane) {
  constexpr int LD = Traits<float>::LD;
  constexpr int PLD = Traits<float>::PLD;
  const int row = lane >> 1, half = lane & 1;
  float out[D / 2];
#pragma unroll
  for (int t = 0; t < D / 2; ++t) out[t] = 0.0f;
  for (int j = 0; j < KT; ++j) {
    const float p = Pw[row * PLD + j];
    const float* vrow = Vs + j * LD;
#pragma unroll
    for (int t = 0; t < D / 2; ++t) out[t] = fmaf(p, vrow[half + 2 * t], out[t]);
  }
#pragma unroll
  for (int t = 0; t < D / 2; ++t) Ow[row * OLD + half + 2 * t] = out[t];
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ valid, T* __restrict__ o, float* __restrict__ lse,
                 int seq, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = Smem<T>;
  constexpr int LD = Traits<T>::LD;
  constexpr int PLD = Traits<T>::PLD;
  T* Qs = reinterpret_cast<T*>(smem + L::Q);
  T* Ks = reinterpret_cast<T*>(smem + L::K);
  T* Vs = reinterpret_cast<T*>(smem + L::V);
  float* Ms = reinterpret_cast<float*>(smem + L::M);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* Sw = reinterpret_cast<float*>(smem + L::S) + warp * 16 * SLD;
  float* Ow = Sw;  // the PV result and the o staging tile reuse the scores
  T* Pw = reinterpret_cast<T*>(smem + L::P) + warp * 16 * PLD;
  const T* Qw = Qs + warp * 16 * LD;

  const int q_tiles = seq / QT;
  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * QT;
  const size_t base = (size_t)bh * seq * D;
  const int row = lane >> 1, half = lane & 1;

  load_tile<T>(Qs, q + base + (size_t)q0 * D, QT, scale);

  float acc[D / 2];  // o row `row`, columns half + 2t
#pragma unroll
  for (int t = 0; t < D / 2; ++t) acc[t] = 0.0f;
  float m = -INFINITY, l = 0.0f;

  for (int k0 = 0; k0 < seq; k0 += KT) {
    __syncthreads();  // every warp is done with the previous tile
    load_tile<T>(Ks, k + base + (size_t)k0 * D, KT, 1.0f);
    load_tile<T>(Vs, v + base + (size_t)k0 * D, KT, 1.0f);
    for (int i = threadIdx.x; i < KT; i += THREADS) Ms[i] = valid[k0 + i];
    __syncthreads();

    warp_scores<T>(Qw, Ks, Sw, scale, lane);
    __syncwarp();

    // Online softmax over this tile; lane pair (2r, 2r+1) splits row r.
    float sv[KT / 2];
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < KT / 2; ++t) {
      const int c = half + 2 * t;
      const float s = Ms[c] > 0.0f ? Sw[row * SLD + c] : NEG_BIG;
      sv[t] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int t = 0; t < KT / 2; ++t) {
      const int c = half + 2 * t;
      const float p = Ms[c] > 0.0f ? expf(sv[t] - m_new) : 0.0f;
      psum += p;
      Pw[row * PLD + c] = from_f32<T>(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();

    warp_pv<T>(Pw, Vs, Ow, lane);
    __syncwarp();
#pragma unroll
    for (int t = 0; t < D / 2; ++t) acc[t] = acc[t] * corr + Ow[row * OLD + half + 2 * t];
    __syncwarp();
  }

  const float lsafe = fmaxf(l, 1e-30f);
#pragma unroll
  for (int t = 0; t < D / 2; ++t) Ow[row * OLD + half + 2 * t] = acc[t] / lsafe;
  if (half == 0) lse[(size_t)bh * seq + q0 + warp * 16 + row] = m + logf(lsafe);
  __syncwarp();
  T* og = o + base + (size_t)(q0 + warp * 16) * D;
  for (int i = lane; i < 16 * D; i += 32) og[i] = from_f32<T>(Ow[(i / D) * OLD + i % D]);
}

// Above 48 KB of shared memory a launch needs the opt-in attribute, which
// belongs to the current device.
template <typename T>
cudaError_t prepare() {
  return cudaFuncSetAttribute(flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Smem<T>::BYTES);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* valid, void* o, void* lse,
           int bh, int seq, float scale, cudaStream_t stream) {
  const int blocks = bh * (seq / QT);
  flash_fwd_kernel<T><<<blocks, THREADS, Smem<T>::BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(valid), static_cast<T*>(o), static_cast<float*>(lse), seq,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Sets the shared-memory opt-in of every instantiation on the current device.
// Call once per device before the first flash_fwd on it. Returns the
// cudaError_t (0 = success).
extern "C" int flash_fwd_prepare() {
  cudaError_t err = prepare<float>();
  if (err == cudaSuccess) err = prepare<__nv_bfloat16>();
  if (err == cudaSuccess) err = prepare<__half>();
  return (int)err;
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. q, k, v, o: contiguous
// [bh, seq, 64]; valid: float32 [seq]; lse: float32 [bh, seq]. seq must be a
// multiple of 128. Returns the cudaError_t of the launch (0 = success).
extern "C" int flash_fwd(int dtype, const void* q, const void* k, const void* v,
                         const void* valid, void* o, void* lse, int bh, int seq, int d,
                         float scale, void* stream) {
  if (d != D || seq <= 0 || seq % KT != 0 || bh <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(q, k, v, valid, o, lse, bh, seq, scale, s);
    case 1: return launch<__nv_bfloat16>(q, k, v, valid, o, lse, bh, seq, scale, s);
    case 2: return launch<__half>(q, k, v, valid, o, lse, bh, seq, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
