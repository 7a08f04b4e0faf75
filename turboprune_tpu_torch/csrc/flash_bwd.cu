// Flash-attention backward (K2: dq, K3: dk and dv) for Hopper, sm_90a.
//
// Replaces the TPU kernels turboprune_tpu/ops/flash.py::_dq_kernel (K2,
// :128, the pl.pallas_call at :233) and ::_dkv_kernel (K3, :152, at :251).
// Same functions: given q, k, v, dO [B*H, S, D], the key-validity row [S]
// shared by every (batch, head), the forward's row logsumexp lse [B*H, S]
// and drow = sum_d dO*O [B*H, S] (both fp32), each kernel recomputes, tile
// by tile, s = (q*scale) k^T in fp32 (invalid keys: p = 0 exactly),
// p = exp(s - lse), dp = dO v^T and ds = p * (dp - drow) * scale, and
// accumulates
//   K2: dq += ds k                   (one block per (b*h, 64 query rows))
//   K3: dv += p^T dO, dk += ds^T q   (one block per (b*h, 64 keys))
// in fp32 registers, writing dq, dk, dv once in the input dtype. The TPU's
// two-kernel split is kept: no atomics, so the gradients are deterministic;
// the TPU's sequential third grid axis is the loop inside a block.
//
// 16-bit inputs (bf16, the training path, and fp16): every product runs on
// the tensor cores as mma.sync.m16n8k16 with fp32 accumulation.
// - s and dp: products of two 16-bit operands, exact in fp32, as the TPU
//   kernels' fp32 dots of the upcast operands. The scale multiplies the
//   fp32 score; p = exp2(s * scale * log2(e) - lse * log2(e)).
// - ds k (K2), p^T dO and ds^T q (K3): p and ds stay fp32, as on the TPU
//   (:142-145, :168-172); rounding them to one 16-bit value would change the
//   result. Each is split in registers into hi = rn(x) and lo = rn(x - hi)
//   of the input type, and the product runs as hi B + lo B into one fp32
//   accumulator: the operand is kept to 2^-16 of its value in bf16 (2^-22
//   in fp16), 256x below one bf16 ulp of the output
//   (tests/test_torch_flash_split.py holds the emulated split within 2^-15
//   of the fp32 recurrence, relative to each gradient's norm).
// - p and ds never leave registers. K2 computes s and dp with its 16 query
//   rows per warp as the mma's M, so their C fragments are, packed, the A
//   fragments of ds k (flash_mma.cuh). K3 computes s^T = k q^T and
//   dp^T = v dO^T with its 16 keys per warp as M, so p^T and ds^T feed
//   p^T dO and ds^T q the same way.
// - The B operands come from shared memory by ldmatrix: k (K2's s), v, q
//   and dO (K3's s^T, dp^T) as stored, [row][d]; k in ds k and dO, q in K3's
//   products through ldmatrix.trans, which turns the [row][d] tile into the
//   k-major fragment the contraction over rows needs.
// - The streamed tiles (K2: k, v and the validity slice; K3: q, dO, lse and
//   drow) are double-buffered by cp.async: tile i+1 is in flight while
//   tile i computes, one __syncthreads per tile.
//
// Instruction route: mma.sync with ldmatrix, not wgmma. wgmma reaches the
// full tensor-core rate, mma.sync about two thirds of it; at these shapes
// both kernels are bound by bytes with the split (below) and mma.sync's
// share of the operations bound is below half of the bytes bound, so the
// register-fragment route, whose layouts are fixed and documented, comes
// first; wgmma's shared-memory descriptors are later work. What it costs:
// each warp reads the B fragments of the streamed tiles itself, so a block
// reads every streamed tile from shared memory 4 times per product, where a
// warpgroup's wgmma reads it once.
//
// What bounds it on an H100 (H100 SXM data sheet: 3.35 TB/s, 989 TFLOP/s
// 16-bit tensor cores): at the training shape (B*H = 1536, S = 256 with
// 197 valid keys, D = 64, bf16) K2 must move ~232 MB (0.069 ms) and K3
// ~282 MB (0.084 ms); with the split, K2 runs 4 and K3 6 products of
// 2 * 1536 * 256 * 197 * 64 flop each, 0.020 / 0.030 ms at the peak rate.
// Both are bound by bytes (chip_smoke.py::bwd_bound_ms(split=True)).
//
// Tiles: 4 warps, 128 threads; all tiles 64 rows; each warp owns 16 rows of
// the accumulator (K2: query rows; K3: keys), 16 x 64 fp32 = 32 registers a
// thread (K3: two). K3 takes each 64-query tile in two halves of 32, so its
// s^T and dp^T hold 16 registers each. 16-bit tiles are staged at a row
// stride of 72 elements (144 bytes, so that ldmatrix's eight rows hit
// distinct banks). Shared memory per block: two resident tiles (K2: q, dO;
// K3: k, v) and two stages of two streamed tiles plus two fp32 vectors of
// 64: 56,320 bytes, 4 blocks' worth per SM. Registers per thread (ptxas,
// printed by chip_smoke.py): K2 158 (bf16) / 160 (fp16), K3 168 (bf16) /
// 170 (fp16), no spills. At 168 or fewer, registers allow 3 blocks (12
// warps) per SM: both bf16 kernels; fp16's K3 gets 2.
//
// Work that adds exactly 0 is skipped (an invalid key's p and ds are 0):
// K2 takes each key tile only up to its last 16-key group with a valid key
// (the tile body is instantiated for 1..4 groups, so no branch sits inside
// its product loops), and a K3 warp whose 16 keys are all invalid computes
// nothing and writes dk = dv = 0. Padded query rows are never skipped: their
// dq, and their terms in dk and dv, are part of the function.
//
// fp32 inputs are not on the training path and keep the first design: s and
// dp and the three fp32-operand products as scalar fp32 FMAs on the CUDA
// cores (their products have no exact 16-bit form, and TF32 would round
// them), scores and probabilities in two fp32 [64][68] shared tiles, and
// synchronous tile loads. Each lane owns a 4 x 8 block of its warp's
// accumulator and reads, per step of the reduction, one 16-byte load of p
// or ds and one of the other operand's row for 32 FMAs.

#include "flash_mma.cuh"

namespace {

using flash::D;

constexpr int T64 = 64;             // rows of every tile (queries or keys)
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;

// ------------------------------------------------------------ 16-bit inputs
constexpr int LD16 = D + 8;                      // row stride of 16-bit tiles
constexpr int TILE16 = T64 * LD16 * 2;           // 9,216 bytes
constexpr int VEC = T64 * (int)sizeof(float);    // 256 bytes

// Byte offsets of the shared-memory regions of the 16-bit kernels.
struct Smem16 {
  static constexpr int RES0 = 0;                 // K2: q    K3: k
  static constexpr int RES1 = TILE16;            // K2: dO   K3: v
  static constexpr int STAGES = 2 * TILE16;      // two stages of:
  static constexpr int TILE_A = 0;               //   K2: k      K3: q
  static constexpr int TILE_B = TILE16;          //   K2: v      K3: dO
  static constexpr int VEC_A = 2 * TILE16;       //   K2: valid  K3: lse
  static constexpr int VEC_B = 2 * TILE16 + VEC; //   K3: drow
  static constexpr int STAGE = 2 * TILE16 + 2 * VEC;
  static constexpr int BYTES = STAGES + 2 * STAGE;
};

// 64 rows of 64 16-bit values (row stride D in device memory, LD16 in
// shared memory), 16 bytes per cp.async, 4 per thread.
template <typename T>
__device__ __forceinline__ void copy_tile_async(T* dst, const T* __restrict__ src) {
  constexpr int CHUNKS = D * 2 / 16;  // per row
#pragma unroll
  for (int it = 0; it < T64 * CHUNKS / THREADS; ++it) {
    const int c = threadIdx.x + it * THREADS;
    const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
    flash::cp_async16(dst + r * LD16 + col, src + (size_t)r * D + col);
  }
}

// 64 fp32 values, 16 bytes per cp.async, threads 0..15.
__device__ __forceinline__ void copy_vec_async(float* dst, const float* __restrict__ src) {
  if (threadIdx.x < VEC / 16) flash::cp_async16(dst + 4 * threadIdx.x, src + 4 * threadIdx.x);
}

// acc[8][4] (16 rows x 64 cols, C fragments) += A B^T over k-step kk (16 of
// the D columns), with a[4] A's fragment of that step and B a [64][D] tile
// in shared memory (rows = output columns). Called for kk = 0..3 it forms
// s, dp (K2) and s^T, dp^T (K3) over the first NG groups of 16 columns
// (the accumulators of the others stay 0).
template <typename T, int NG>
__device__ __forceinline__ void mma_nt(float acc[8][4], const uint32_t a[4],
                                       const T* B, int kk, int lane) {
  // Matrix m = lane / 8 of the x4 load: rows 16 nj + 8 (m / 2) + lane % 8,
  // cols 16 kk + 8 (m % 2): the B fragments of n-tiles 2 nj and 2 nj + 1.
  const T* base = B + (((lane >> 4) & 1) * 8 + (lane & 7)) * LD16 + kk * 16 + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int nj = 0; nj < NG; ++nj) {
    uint32_t b[4];
    flash::ldsm_x4(b, base + nj * 16 * LD16);
    flash::mma16816<T>(acc[2 * nj], a, b[0], b[1]);
    flash::mma16816<T>(acc[2 * nj + 1], a, b[2], b[3]);
  }
}

// The A fragment of k-step kk of the 16 rows at `rows` of a [..][D] tile in
// shared memory.
template <typename T>
__device__ __forceinline__ void load_a(uint32_t a[4], const T* rows, int kk, int lane) {
  flash::ldsm_x4(a, rows + (lane & 15) * LD16 + kk * 16 + (lane >> 4) * 8);
}

// acc[8][4] (16 rows x D) += X (16 x 64, fp32, C fragments in x[8][4]) times
// B, with B a [64][D] tile in shared memory (rows = the contraction). X is
// split into hi + lo, two tensor-core products each. Only the first NG
// groups of 16 rows of the contraction are taken (X is 0 past them).
template <typename T, int NG>
__device__ __forceinline__ void mma_split_nn(float acc[8][4], const float x[8][4],
                                             const T* B, int lane) {
  // Transposed x4 load, matrix m = lane / 8: rows 16 kj + 8 (m % 2) + lane % 8,
  // cols 16 dn + 8 (m / 2): the B fragments of d n-tiles 2 dn and 2 dn + 1.
  const T* base = B + (((lane >> 3) & 1) * 8 + (lane & 7)) * LD16 + (lane >> 4) * 8;
#pragma unroll
  for (int kj = 0; kj < NG; ++kj) {
    uint32_t hi[4], lo[4];
    flash::pack_a<T>(x[2 * kj], x[2 * kj + 1], hi, lo);
#pragma unroll
    for (int dn = 0; dn < 4; ++dn) {
      uint32_t b[4];
      flash::ldsm_x4_trans(b, base + kj * 16 * LD16 + dn * 16);
      flash::mma16816<T>(acc[2 * dn], hi, b[0], b[1]);
      flash::mma16816<T>(acc[2 * dn + 1], hi, b[2], b[3]);
      flash::mma16816<T>(acc[2 * dn], lo, b[0], b[1]);
      flash::mma16816<T>(acc[2 * dn + 1], lo, b[2], b[3]);
    }
  }
}

// The groups of 16 keys of a tile's validity slice up to the last one that
// holds a valid key (0..4): past it p = ds = 0 exactly. The same for every
// lane of the warp (a vote), so the warp's mma.sync and ldmatrix stay
// converged.
__device__ __forceinline__ int live_groups(const float* VALID, int t) {
  unsigned live = 0;
#pragma unroll
  for (int nj = 0; nj < 4; ++nj) {
    const float2 a = *reinterpret_cast<const float2*>(VALID + 16 * nj + 2 * t);
    const float2 b = *reinterpret_cast<const float2*>(VALID + 16 * nj + 8 + 2 * t);
    if (__any_sync(0xffffffffu, a.x > 0.0f || a.y > 0.0f || b.x > 0.0f || b.y > 0.0f))
      live |= 1u << nj;
  }
  return 32 - __clz(live);
}

__device__ __forceinline__ void zero(float acc[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
}

// Rows `row` and `row + 8` of a 16 x D accumulator to device memory in T.
template <typename T>
__device__ __forceinline__ void store_rows(T* out, const float acc[8][4], int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<uint32_t*>(out + j * 8 + 2 * t) = flash::pack2<T>(acc[j][0], acc[j][1]);
    *reinterpret_cast<uint32_t*>(out + 8 * D + j * 8 + 2 * t) =
        flash::pack2<T>(acc[j][2], acc[j][3]);
  }
}

// lse and drow of a K2 thread's query rows g and g + 8 (lse times log2(e)).
struct RowStats {
  float lse0, lse1, drow0, drow1;
};

// One key tile of K2 for a warp's 16 query rows (q and dO rows Qw, dOw),
// over the tile's first NG groups of 16 keys: acc += ds k. The q and dO
// fragments are read from shared memory for every tile, which keeps a
// thread under the 168 registers that let 3 blocks share an SM.
template <typename T, int NG>
__device__ __forceinline__ void dq_tile(float acc[8][4], const T* Qw, const T* dOw, const T* Ks,
                                        const T* Vs, const float* VALID, const RowStats& r,
                                        float scale, int lane) {
  const int t = lane & 3;
  const float sl2 = scale * LOG2E;
  float s[8][4], ds[8][4];
  zero(s);
  zero(ds);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    load_a(a, Qw, kk, lane);
    mma_nt<T, NG>(s, a, Ks, kk, lane);
    load_a(a, dOw, kk, lane);
    mma_nt<T, NG>(ds, a, Vs, kk, lane);  // dp, overwritten by ds below
  }
#pragma unroll
  for (int j = 0; j < 2 * NG; ++j) {
    const float2 ok = *reinterpret_cast<const float2*>(VALID + j * 8 + 2 * t);
    const float p0 = ok.x > 0.0f ? exp2f(fmaf(s[j][0], sl2, -r.lse0)) : 0.0f;
    const float p1 = ok.y > 0.0f ? exp2f(fmaf(s[j][1], sl2, -r.lse0)) : 0.0f;
    const float p2 = ok.x > 0.0f ? exp2f(fmaf(s[j][2], sl2, -r.lse1)) : 0.0f;
    const float p3 = ok.y > 0.0f ? exp2f(fmaf(s[j][3], sl2, -r.lse1)) : 0.0f;
    ds[j][0] = p0 * (ds[j][0] - r.drow0) * scale;
    ds[j][1] = p1 * (ds[j][1] - r.drow0) * scale;
    ds[j][2] = p2 * (ds[j][2] - r.drow1) * scale;
    ds[j][3] = p3 * (ds[j][3] - r.drow1) * scale;
  }
  mma_split_nn<T, NG>(acc, ds, Ks, lane);
}

// K2: one block per (b*h, 64 query rows); warp w owns query rows
// 16w..16w+15, lane 4g + t rows g and g + 8 of them. Loop over key tiles,
// each taken up to its last 16-key group with a valid key.
template <typename T>
__global__ void __launch_bounds__(THREADS, 3)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ valid, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ drow,
                    T* __restrict__ dq, int seq, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = Smem16;
  T* Qs = reinterpret_cast<T*>(smem + L::RES0);
  T* dOs = reinterpret_cast<T*>(smem + L::RES1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const int q_tiles = seq / T64;
  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * T64;
  const size_t base = (size_t)bh * seq * D;
  const int nk = seq / T64;

  auto issue = [&](int i) {  // key tile i into stage i % 2
    unsigned char* st = smem + L::STAGES + (i & 1) * L::STAGE;
    copy_tile_async<T>(reinterpret_cast<T*>(st + L::TILE_A), k + base + (size_t)i * T64 * D);
    copy_tile_async<T>(reinterpret_cast<T*>(st + L::TILE_B), v + base + (size_t)i * T64 * D);
    copy_vec_async(reinterpret_cast<float*>(st + L::VEC_A), valid + i * T64);
    flash::cp_async_commit();
  };

  copy_tile_async<T>(Qs, q + base + (size_t)q0 * D);
  copy_tile_async<T>(dOs, dout + base + (size_t)q0 * D);
  issue(0);

  const int row = q0 + warp * 16 + g;  // and row + 8
  const RowStats r{lse[(size_t)bh * seq + row] * LOG2E, lse[(size_t)bh * seq + row + 8] * LOG2E,
                   drow[(size_t)bh * seq + row], drow[(size_t)bh * seq + row + 8]};
  const T* Qw = Qs + warp * 16 * LD16;
  const T* dOw = dOs + warp * 16 * LD16;

  float acc[8][4];
  zero(acc);
  for (int i = 0; i < nk; ++i) {
    flash::cp_async_wait_all();
    __syncthreads();  // tile i visible to all; stage (i+1) % 2 is free
    if (i + 1 < nk) issue(i + 1);
    const unsigned char* st = smem + L::STAGES + (i & 1) * L::STAGE;
    const T* Ks = reinterpret_cast<const T*>(st + L::TILE_A);
    const T* Vs = reinterpret_cast<const T*>(st + L::TILE_B);
    const float* VALID = reinterpret_cast<const float*>(st + L::VEC_A);
    // Instantiated per group count, so every product loop stays unrolled
    // without a branch inside it.
    switch (live_groups(VALID, t)) {
      case 4: dq_tile<T, 4>(acc, Qw, dOw, Ks, Vs, VALID, r, scale, lane); break;
      case 3: dq_tile<T, 3>(acc, Qw, dOw, Ks, Vs, VALID, r, scale, lane); break;
      case 2: dq_tile<T, 2>(acc, Qw, dOw, Ks, Vs, VALID, r, scale, lane); break;
      case 1: dq_tile<T, 1>(acc, Qw, dOw, Ks, Vs, VALID, r, scale, lane); break;
      default: break;  // no valid key in the tile: it adds exactly 0
    }
  }
  store_rows<T>(dq + base + (size_t)row * D, acc, t);
}

// K3: one block per (b*h, 64 keys); warp w owns keys 16w..16w+15, lane
// 4g + t keys g and g + 8 of them. Loop over query tiles (none skipped:
// padded query rows are part of the function). A warp whose 16 keys are all
// invalid only helps load the tiles and writes dk = dv = 0.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ valid, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ drow,
                     T* __restrict__ dk, T* __restrict__ dv, int seq, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = Smem16;
  T* Ks = reinterpret_cast<T*>(smem + L::RES0);
  T* Vs = reinterpret_cast<T*>(smem + L::RES1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const int k_tiles = seq / T64;
  const int bh = blockIdx.x / k_tiles;
  const int k0 = (blockIdx.x % k_tiles) * T64;
  const size_t base = (size_t)bh * seq * D;
  const int nq = seq / T64;

  auto issue = [&](int i) {  // query tile i into stage i % 2
    unsigned char* st = smem + L::STAGES + (i & 1) * L::STAGE;
    copy_tile_async<T>(reinterpret_cast<T*>(st + L::TILE_A), q + base + (size_t)i * T64 * D);
    copy_tile_async<T>(reinterpret_cast<T*>(st + L::TILE_B), dout + base + (size_t)i * T64 * D);
    copy_vec_async(reinterpret_cast<float*>(st + L::VEC_A), lse + (size_t)bh * seq + i * T64);
    copy_vec_async(reinterpret_cast<float*>(st + L::VEC_B), drow + (size_t)bh * seq + i * T64);
    flash::cp_async_commit();
  };

  copy_tile_async<T>(Ks, k + base + (size_t)k0 * D);
  copy_tile_async<T>(Vs, v + base + (size_t)k0 * D);
  issue(0);

  const int key = k0 + warp * 16 + g;  // and key + 8
  const bool ok0 = valid[key] > 0.0f, ok1 = valid[key + 8] > 0.0f;
  const bool live = __any_sync(0xffffffffu, ok0 || ok1);
  const float sl2 = scale * LOG2E;
  const T* Kw = Ks + warp * 16 * LD16;
  const T* Vw = Vs + warp * 16 * LD16;

  float acc_k[8][4], acc_v[8][4];
  zero(acc_k);
  zero(acc_v);
  for (int i = 0; i < nq; ++i) {
    flash::cp_async_wait_all();
    __syncthreads();  // tile i visible to all; stage (i+1) % 2 is free
    if (i + 1 < nq) issue(i + 1);
    if (!live) continue;
    const unsigned char* st = smem + L::STAGES + (i & 1) * L::STAGE;
    const T* Qs = reinterpret_cast<const T*>(st + L::TILE_A);
    const T* dOs = reinterpret_cast<const T*>(st + L::TILE_B);
    const float* LSE = reinterpret_cast<const float*>(st + L::VEC_A);
    const float* DROW = reinterpret_cast<const float*>(st + L::VEC_B);

    // Two halves of 32 queries, so that s^T and dp^T take 16 registers each
    // and a thread stays under the 168 that let 3 blocks share an SM.
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      const T* Qh = Qs + h * 32 * LD16;
      const T* dOh = dOs + h * 32 * LD16;
      // s^T and dp^T: keys as rows, the half's queries as columns.
      float p[8][4], ds[8][4];
      zero(p);
      zero(ds);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a[4];
        load_a(a, Kw, kk, lane);
        mma_nt<T, 2>(p, a, Qh, kk, lane);  // s^T, overwritten by p^T below
        load_a(a, Vw, kk, lane);
        mma_nt<T, 2>(ds, a, dOh, kk, lane);  // dp^T, overwritten by ds^T below
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = h * 32 + j * 8 + 2 * t;
        const float2 l = *reinterpret_cast<const float2*>(LSE + c);
        const float2 d = *reinterpret_cast<const float2*>(DROW + c);
        p[j][0] = ok0 ? exp2f(fmaf(p[j][0], sl2, -l.x * LOG2E)) : 0.0f;
        p[j][1] = ok0 ? exp2f(fmaf(p[j][1], sl2, -l.y * LOG2E)) : 0.0f;
        p[j][2] = ok1 ? exp2f(fmaf(p[j][2], sl2, -l.x * LOG2E)) : 0.0f;
        p[j][3] = ok1 ? exp2f(fmaf(p[j][3], sl2, -l.y * LOG2E)) : 0.0f;
        ds[j][0] = p[j][0] * (ds[j][0] - d.x) * scale;
        ds[j][1] = p[j][1] * (ds[j][1] - d.y) * scale;
        ds[j][2] = p[j][2] * (ds[j][2] - d.x) * scale;
        ds[j][3] = p[j][3] * (ds[j][3] - d.y) * scale;
      }
      mma_split_nn<T, 2>(acc_v, p, dOh, lane);
      mma_split_nn<T, 2>(acc_k, ds, Qh, lane);
    }
  }
  store_rows<T>(dk + base + (size_t)key * D, acc_k, t);
  store_rows<T>(dv + base + (size_t)key * D, acc_v, t);
}

// -------------------------------------------------------------- fp32 inputs
constexpr int LD32 = D + 4;         // rows stay 16-byte aligned for vector loads
constexpr int CLD = T64 + 4;        // fp32 row stride of the score tiles

// Byte offsets of the fp32 kernels' shared-memory regions; each starts
// 128-byte aligned.
struct Smem32 {
  static constexpr int TILE = flash::round_up(T64 * LD32 * (int)sizeof(float), 128);
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

__device__ __forceinline__ void load_tile32(float* dst, const float* __restrict__ src) {
  flash::load_rows<float, LD32, THREADS>(dst, src, T64, 1.0f);
}

// C[16][64] = (sa * A[16][D]) (sb * B[64][D])^T by scalar FMAs, each operand
// scaled per element before the product (as the plain version scales q
// before its fp32 matmul), stored so that element (i, j) lands at
// out[j * CLD + i]. Lane (i, jh) computes row i against columns jh, jh + 2, ...
__device__ __forceinline__ void warp_nt32(const float* A, const float* B, float* out, float sa,
                                          float sb, int lane) {
  const int i = lane & 15, jh = lane >> 4;
  const float* arow = A + i * LD32;
  for (int t = 0; t < T64 / 2; ++t) {
    const int j = jh + 2 * t;
    const float* brow = B + j * LD32;
    float s = 0.0f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) s = fmaf(arow[d] * sa, brow[d] * sb, s);
    out[j * CLD + i] = s;
  }
}

// K2, fp32: one block per (b*h, 64 query rows); warp w owns query rows
// 16w..16w+15 and lane (ly, lx) the dq block rows 4ly..4ly+3, columns
// 8lx..8lx+7 of them.
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel_fp32(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ valid,
                         const float* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ drow, float* __restrict__ dq, int seq,
                         float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = Smem32;
  float* Qs = reinterpret_cast<float*>(smem + L::A);
  float* dOs = reinterpret_cast<float*>(smem + L::B);
  float* Ks = reinterpret_cast<float*>(smem + L::C);
  float* Vs = reinterpret_cast<float*>(smem + L::E);
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

  load_tile32(Qs, q + base + (size_t)q0 * D);
  load_tile32(dOs, dout + base + (size_t)q0 * D);
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
    load_tile32(Ks, k + base + (size_t)k0 * D);
    load_tile32(Vs, v + base + (size_t)k0 * D);
    for (int i = threadIdx.x; i < T64; i += THREADS) VALID[i] = valid[k0 + i];
    __syncthreads();

    warp_nt32(Qs + w0 * LD32, Ks, Ss + w0, scale, 1.0f, lane);  // s
    warp_nt32(dOs + w0 * LD32, Vs, Ps + w0, 1.0f, 1.0f, lane);  // dp
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
      flash::load8<float>(Ks + c * LD32 + 8 * lx, kr);
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
    flash::store8<float>(dq + base + (size_t)(q0 + w0 + 4 * ly + a) * D + 8 * lx, acc[a]);
}

// K3, fp32: one block per (b*h, 64 keys); warp w owns keys 16w..16w+15 and
// lane (ly, lx) the dk and dv block rows 4ly..4ly+3, columns 8lx..8lx+7.
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel_fp32(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ valid,
                          const float* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ drow, float* __restrict__ dk,
                          float* __restrict__ dv, int seq, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = Smem32;
  float* Ks = reinterpret_cast<float*>(smem + L::A);
  float* Vs = reinterpret_cast<float*>(smem + L::B);
  float* Qs = reinterpret_cast<float*>(smem + L::C);
  float* dOs = reinterpret_cast<float*>(smem + L::E);
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

  load_tile32(Ks, k + base + (size_t)k0 * D);
  load_tile32(Vs, v + base + (size_t)k0 * D);
  for (int i = threadIdx.x; i < T64; i += THREADS) VALID[i] = valid[k0 + i];

  float acc_k[4][8], acc_v[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc_k[a][j] = acc_v[a][j] = 0.0f;

  for (int q0 = 0; q0 < seq; q0 += T64) {
    __syncthreads();  // every warp is done with the previous q/dO tile
    load_tile32(Qs, q + base + (size_t)q0 * D);
    load_tile32(dOs, dout + base + (size_t)q0 * D);
    for (int i = threadIdx.x; i < T64; i += THREADS) {
      LSE[i] = lse[(size_t)bh * seq + q0 + i];
      DROW[i] = drow[(size_t)bh * seq + q0 + i];
    }
    __syncthreads();

    // Transposed products, so that the warp's 16 keys are the columns
    // w0..w0+15 of row-major [query][key] tiles.
    warp_nt32(Ks + w0 * LD32, Qs, Ss + w0, 1.0f, scale, lane);  // s
    warp_nt32(Vs + w0 * LD32, dOs, Ps + w0, 1.0f, 1.0f, lane);  // dp
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
      flash::load8<float>(dOs + r * LD32 + 8 * lx, dor);
      flash::load8<float>(Qs + r * LD32 + 8 * lx, qr);
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
    flash::store8<float>(dk + row, acc_k[a]);
    flash::store8<float>(dv + row, acc_v[a]);
  }
}

// ------------------------------------------------------------------ launch
// Above 48 KB of shared memory a launch needs the opt-in attribute, which
// belongs to the current device.
template <typename K>
cudaError_t opt_in(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

cudaError_t prepare() {
  const cudaError_t errs[] = {
      opt_in(flash_bwd_dq_kernel_fp32, Smem32::BYTES),
      opt_in(flash_bwd_dkv_kernel_fp32, Smem32::BYTES),
      opt_in(flash_bwd_dq_kernel<__nv_bfloat16>, Smem16::BYTES),
      opt_in(flash_bwd_dkv_kernel<__nv_bfloat16>, Smem16::BYTES),
      opt_in(flash_bwd_dq_kernel<__half>, Smem16::BYTES),
      opt_in(flash_bwd_dkv_kernel<__half>, Smem16::BYTES),
  };
  for (cudaError_t err : errs)
    if (err != cudaSuccess) return err;
  return cudaSuccess;
}

struct Args {
  const void *q, *k, *v, *valid, *dout, *lse, *drow;
  int bh, seq;
  float scale;
  cudaStream_t stream;
};

template <typename T>
int launch_dq(const Args& a, void* dq) {
  const int blocks = a.bh * (a.seq / T64);
  if constexpr (sizeof(T) == 4) {
    flash_bwd_dq_kernel_fp32<<<blocks, THREADS, Smem32::BYTES, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.valid),
        static_cast<const float*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.drow), static_cast<float*>(dq), a.seq, a.scale);
  } else {
    flash_bwd_dq_kernel<T><<<blocks, THREADS, Smem16::BYTES, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const float*>(a.valid), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.drow),
        static_cast<T*>(dq), a.seq, a.scale);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const Args& a, void* dk, void* dv) {
  const int blocks = a.bh * (a.seq / T64);
  if constexpr (sizeof(T) == 4) {
    flash_bwd_dkv_kernel_fp32<<<blocks, THREADS, Smem32::BYTES, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.valid),
        static_cast<const float*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.drow), static_cast<float*>(dk), static_cast<float*>(dv),
        a.seq, a.scale);
  } else {
    flash_bwd_dkv_kernel<T><<<blocks, THREADS, Smem16::BYTES, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const float*>(a.valid), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.drow),
        static_cast<T*>(dk), static_cast<T*>(dv), a.seq, a.scale);
  }
  return (int)cudaGetLastError();
}

bool bad_shape(int bh, int seq, int d) {
  return d != D || seq <= 0 || seq % 128 != 0 || bh <= 0;
}

}  // namespace

// Sets the shared-memory opt-in of every instantiation on the current device.
// Call once per device before the first launch on it. Returns the
// cudaError_t (0 = success).
extern "C" int flash_bwd_prepare() { return (int)prepare(); }

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. q, k, v, dout, dq:
// contiguous [bh, seq, 64]; valid: float32 [seq]; lse, drow: float32
// [bh, seq]; every pointer 16-byte aligned (the 16-bit kernels copy
// valid, lse and drow by 16-byte cp.async). seq must be a multiple of 128.
// Returns the cudaError_t of the launch (0 = success).
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
