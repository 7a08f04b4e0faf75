// Flash-attention forward (K1) for Hopper, sm_90a.
//
// Replaces the TPU kernel turboprune_tpu/ops/flash.py::_fwd_kernel (:65, the
// pl.pallas_call in _flash_fwd at :100). Same function: non-causal attention
// over [B*H, S, D] with one key-validity row [S] shared by every (batch,
// head), computed by the online-softmax recurrence over key blocks of 128,
// so the S x S score matrix never reaches device memory. Outputs o (input
// dtype) and the row logsumexp lse [B*H, S] in fp32.
//
// Numerics follow the TPU kernel step by step: scores in fp32 (bf16/fp16
// products are exact in fp32 and accumulate in fp32 on the tensor cores);
// invalid keys get -1e30; per 128-key block m_new = max(m, block max),
// p = exp(s - m_new) for valid keys and exactly 0 for invalid ones, the
// running sum l adds the fp32 p, p is rounded to the input dtype before the
// PV product, which accumulates in fp32, and acc = acc * exp(m - m_new) + PV;
// o = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)). The scale is
// applied to the fp32 score (16-bit inputs) or to q in fp32 before the
// product (fp32 inputs): the same value when the scale is a power of two, as
// 1/sqrt(64) is. The rescale unit stays the TPU's 128-key block: rounding p
// relative to the max of a smaller block would round every p at another
// scale and move o by more than the rounding flips the tests allow.
//
// What bounds it on an H100 (data sheet: 3.35 TB/s, 989 TFLOP/s 16-bit
// tensor cores): at the training shape (B*H = 1536, S = 256 of which 197
// keys are valid, D = 64, bf16) the function must read q and the valid rows
// of k and v and write o and lse, 180 MB, or 0.054 ms, while the valid keys'
// 19.8 GFLOP take 0.020 ms at the peak rate (the served shape, B*H = 768,
// half of each). So it is bound by bytes, and the design moves only what
// the function needs:
//
// 16-bit inputs (bf16, both main paths, and fp16): one block of 4 warps per
// (b*h, 64 query rows); warp w owns query rows 16w..16w+15, lane 4g + t rows
// g and g + 8 of them (the mma.sync fragment layout, flash_mma.cuh).
// - Scores and probabilities never leave registers. S = q k^T runs as
//   mma.sync.m16n8k16 over a whole 128-key block (16 x 128 fp32 scores: 64
//   registers a thread), q's A fragments and k's B fragments read by
//   ldmatrix. Scale and mask are one FMA, s * scale + bias with a bias of 0
//   or -1e30 built from the validity bits (-1e30 absorbs the score, so an
//   invalid key's score is the TPU's -1e30 exactly, and its
//   exp(-1e30 - m_new) is exactly 0 with no select). Row max and sum are
//   taken in registers and over the four lanes of a row by shuffles.
//   p = expf(s - m_new) (full precision), rounded by pack2 straight into the
//   A fragment of the PV product (the C fragment layout of two 8-key tiles
//   is the A layout of a 16-key step); v enters as B by ldmatrix.trans; o
//   accumulates in fp32 registers and is rescaled there.
// - K and V come in by 16-byte cp.async, in a ring of two stages of one
//   128-key block each (K and V in separate commit groups): the next block's
//   K and V are in flight while this block's scores and softmax run, and V
//   may still land while S is computed. Staged rows are 128 bytes with their
//   16-byte chunks XOR-swizzled by the row (chunk c of row r at c ^ (r % 8)),
//   so every ldmatrix and every cp.async touches 32 distinct banks without
//   padding, and a lane's ldmatrix address for the next 16 columns is one
//   XOR of its 32-bit shared address (lane_addrs). Shared memory: q 8 KB +
//   two stages of 32 KB = 72 KB a block, three blocks (12 warps) per SM; the
//   launch bounds hold a thread to the 168 registers that allow them, and
//   q's fragments are read again for every block rather than held (16
//   registers), so nothing spills. 64 query rows a block, not 128: a
//   128-row block of 8 such warps fits once per SM (8 warps), and fewer
//   warps per SM measured slower (ablate_flash_fwd.py, PERF.md).
// - Dead keys are neither loaded nor computed: each 128-key block is taken
//   up to its last 16-key group that holds a valid key (the block body is
//   instantiated for 1..8 groups, so no branch sits inside the product
//   loops), and a block with no valid key is skipped whole. A block's
//   validity comes as bits, from one 16-byte read of the row per lane and
//   four votes (block_mask): no shared memory, the same in every warp.
//   Padded keys inside a computed group are masked to -1e30 before the max,
//   as on the TPU. At the main paths' 197 of 256 valid keys that is 208 key
//   rows loaded and computed instead of 256. Padded query rows are
//   computed: the function defines them.
// - Skipping is exact. A block with no valid key leaves the TPU's l and acc
//   as they were (p = 0, and its max -1e30 is below any valid score, so
//   exp(m - m_new) = 1), except before the first valid block, where the TPU
//   moves m from -inf to -1e30 and the next valid block's exp(-1e30 - m_new)
//   = 0 = exp(-inf - m_new) clears the same zeros. Only a row with no valid
//   key at all ends differently: m = -inf here, -1e30 on the TPU. So m is
//   taken as max(m, -1e30) before lse, which gives the TPU's lse = -1e30 and
//   o = 0 (an lse of -inf would make the backward's exp(s - lse) * 0 a NaN).
// - o = acc / max(l, 1e-30), correctly rounded (a reciprocal and one FMA
//   correction, quotient below, instead of 32 IEEE divisions a thread), is
//   rounded once to T and written with coalesced 16-byte stores through a
//   staging tile in the warp's own rows of the q buffer; lse from registers,
//   one fp32 per row.
//
// Instruction route: mma.sync with ldmatrix, not wgmma, as K2/K3
// (flash_bwd.cu). What it costs: every warp reads the whole K and V block
// from shared memory for its own 16 rows (4 times per block), and mma.sync
// runs below wgmma's rate; with the full-precision expf these, and not the
// bytes, now set the kernel's time (ablate_flash_fwd.py, PERF.md). wgmma, whose
// warpgroup reads each B tile once, is the next step.
//
// fp32 inputs are on no main path and keep the first design: scalar fp32
// FMAs for both products (full fp32 precision; TF32 would round them),
// scores and probabilities in shared memory, synchronous loads of 128-key
// tiles, lane pair (2r, 2r+1) owning query row r of its warp.

#include "flash_mma.cuh"

namespace {

using flash::D;
using flash::NEG_BIG;
using flash::round_up;

constexpr int KT = 128;       // keys per block: the online-softmax unit (block_k)
constexpr int QT = 64;        // query rows per CUDA block
constexpr int WARPS = QT / 16;
constexpr int THREADS = WARPS * 32;

// ------------------------------------------------------------ 16-bit inputs
// Byte offsets of the shared-memory regions: the q tile (later the o staging
// tile), then two stages of one key block's K and V. Rows of D = 64 16-bit
// values, swizzled (swz below).
struct Smem16 {
  static constexpr int TILE = KT * D * 2;        // 16,384 bytes
  static constexpr int Q = 0;
  static constexpr int STAGES = QT * D * 2;      // 8,192
  static constexpr int K = 0;                    // within a stage
  static constexpr int V = TILE;
  static constexpr int STAGE = 2 * TILE;
  static constexpr int BYTES = STAGES + 2 * STAGE;  // 73,728
};

// Element offset of the 16-byte chunk `chunk` (0..7) of row `row` in a
// staged tile: chunk c of row r sits at c ^ (r % 8), so eight consecutive
// rows' chunks c fall on distinct banks.
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * D + ((chunk ^ (row & 7)) << 3);
}

// The first 16 * groups rows of a [.., D] tile from device memory into a
// staged tile, by 16-byte cp.async: eight consecutive threads per row.
template <typename T>
__device__ __forceinline__ void copy_rows_async(T* dst, const T* __restrict__ src, int groups) {
  const int r0 = threadIdx.x >> 3, ch = threadIdx.x & 7;
  for (int it = 0; it < groups; ++it) {
    const int r = r0 + 16 * it;
    flash::cp_async16(dst + swz(r, ch), src + (size_t)r * D + ch * 8);
  }
}

// The validity of a key block as bits (key 4 i + c is valid iff bit i of
// bits[c] is set, i = lane), and its count of 16-key groups up to the last
// one with a valid key (0..8). The same in every lane (votes).
struct BlockMask {
  uint32_t bits[4];
  int groups;
};

__device__ __forceinline__ BlockMask block_mask(const float* __restrict__ vt, int lane) {
  const float4 x = *reinterpret_cast<const float4*>(vt + 4 * lane);
  BlockMask b;
  b.bits[0] = __ballot_sync(0xffffffffu, x.x > 0.0f);
  b.bits[1] = __ballot_sync(0xffffffffu, x.y > 0.0f);
  b.bits[2] = __ballot_sync(0xffffffffu, x.z > 0.0f);
  b.bits[3] = __ballot_sync(0xffffffffu, x.w > 0.0f);
  const uint32_t live = b.bits[0] | b.bits[1] | b.bits[2] | b.bits[3];
  // Lane i holds group i / 4; the last live lane L gives L / 4 + 1 groups.
  b.groups = live ? (35 - __clz(live)) >> 2 : 0;
  return b;
}

// Shared-space byte addresses of this lane's ldmatrix rows, for the first
// step (16 columns) of a swizzled tile. Columns 16 kk.. of the same rows are
// at addr ^ (kk << 5) (row bases are multiples of 128 bytes, and step kk
// flips chunk bits 1-2 under the XOR swizzle); rows 16 n further at
// + n * GROUP_BYTES.
//   q: A fragment, rows lane % 16 of the warp's 16, chunk lane / 16.
//   k: x4 matrix i = lane / 8 is keys 8 (i / 2) + lane % 8, chunk i % 2: the
//      B fragments of key tiles 2 n and 2 n + 1.
//   v: transposed x4, matrix i is keys 8 (i % 2) + lane % 8, chunk i / 2: the
//      B fragments of d tiles 2 dn and 2 dn + 1.
constexpr int ROW_BYTES = D * 2;
constexpr int GROUP_BYTES = 16 * ROW_BYTES;

struct LaneAddrs {
  uint32_t q, k, v;  // q: absolute; k, v: within a K or V tile
};

__device__ __forceinline__ LaneAddrs lane_addrs(uint32_t q_tile, int warp, int lane) {
  const int x = lane & 7;  // == row % 8 of every row this lane addresses
  const int hi = lane >> 4, mid = (lane >> 3) & 1;
  return {q_tile + (warp * 16 + (lane & 15)) * ROW_BYTES + ((hi ^ x) << 4),
          (uint32_t)((hi * 8 + x) * ROW_BYTES + ((mid ^ x) << 4)),
          (uint32_t)((mid * 8 + x) * ROW_BYTES + ((hi ^ x) << 4))};
}

// The additive mask of key 8 j + 2 t + e, from this lane's validity bits
// ok_e (bit 2 j): 0 for a valid key, -1e30 for an invalid one.
__device__ __forceinline__ float key_bias(uint32_t ok, int j) {
  const int keep = (int)(ok << (31 - 2 * j)) >> 31;  // -1 valid, 0 invalid
  return __int_as_float(~keep & __float_as_int(NEG_BIG));
}

// One 128-key block for a warp's 16 query rows, over its first NG groups of
// 16 keys (the rest hold no valid key). q_addr, k_addr, v_addr: this
// lane's ldmatrix addresses (lane_addrs) in the q tile and the stage's K
// and V tiles; ok0, ok1: its validity bits, key 8 j + 2 t + e valid iff
// bit 2 j of ok_e is set. Updates the row max m, sum l (rows g, g + 8) and
// the o accumulator acc (16 x D, C fragments).
template <typename T, int NG>
__device__ __forceinline__ void block_step(float acc[8][4], float m[2], float l[2],
                                           uint32_t q_addr, uint32_t k_addr, uint32_t v_addr,
                                           uint32_t ok0, uint32_t ok1, float scale) {
  float s[2 * NG][4];
#pragma unroll
  for (int j = 0; j < 2 * NG; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;

  // S = q k^T, over the 4 steps kk of 16 d (see lane_addrs for the
  // fragments each address gives). q's A fragments are read again for every
  // block: holding them would cost 16 registers a thread.
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    flash::ldsm_x4(a, q_addr ^ (kk << 5));
#pragma unroll
    for (int nj = 0; nj < NG; ++nj) {
      uint32_t b[4];
      flash::ldsm_x4(b, (k_addr ^ (kk << 5)) + nj * GROUP_BYTES);
      flash::mma16816<T>(s[2 * nj], a, b[0], b[1]);
      flash::mma16816<T>(s[2 * nj + 1], a, b[2], b[3]);
    }
  }

  // Scale and mask in one FMA, s * scale + bias: an invalid key's bias of
  // -1e30 absorbs its score (|s * scale| is far below half an ulp of 1e30,
  // 2^75), which gives the TPU's -1e30 exactly; a valid key's bias is 0.
  // Then the block's row max (the TPU's s.max over 128 keys: the groups
  // past NG hold -1e30 there, below any valid score).
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 2 * NG; ++j) {
    const float b0 = key_bias(ok0, j), b1 = key_bias(ok1, j);
    s[j][0] = fmaf(s[j][0], scale, b0);
    s[j][1] = fmaf(s[j][1], scale, b1);
    s[j][2] = fmaf(s[j][2], scale, b0);
    s[j][3] = fmaf(s[j][3], scale, b1);
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
  const float mn0 = fmaxf(m[0], flash::quad_max(mx0));
  const float mn1 = fmaxf(m[1], flash::quad_max(mx1));
  const float c0 = expf(m[0] - mn0), c1 = expf(m[1] - mn1);

  // p = exp(s - m_new) in fp32 (kept in s): exactly 0 for an invalid key,
  // whose -1e30 - m_new is -1e30, and its row sums; then the rescaled
  // accumulator.
  float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
  for (int j = 0; j < 2 * NG; ++j) {
    s[j][0] = expf(s[j][0] - mn0);
    s[j][1] = expf(s[j][1] - mn0);
    s[j][2] = expf(s[j][2] - mn1);
    s[j][3] = expf(s[j][3] - mn1);
    ps0 += s[j][0] + s[j][1];
    ps1 += s[j][2] + s[j][3];
  }
  l[0] = l[0] * c0 + flash::quad_sum(ps0);
  l[1] = l[1] * c1 + flash::quad_sum(ps1);
  m[0] = mn0;
  m[1] = mn1;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc[j][0] *= c0;
    acc[j][1] *= c0;
    acc[j][2] *= c1;
    acc[j][3] *= c1;
  }

  flash::cp_async_wait<2>();  // this block's V has landed (see the caller)
  __syncthreads();

  // acc += p v, p rounded to T into A fragments, v's B fragments by the
  // transposed load (lane_addrs).
#pragma unroll
  for (int kj = 0; kj < NG; ++kj) {
    const uint32_t a[4] = {
        flash::pack2<T>(s[2 * kj][0], s[2 * kj][1]),
        flash::pack2<T>(s[2 * kj][2], s[2 * kj][3]),
        flash::pack2<T>(s[2 * kj + 1][0], s[2 * kj + 1][1]),
        flash::pack2<T>(s[2 * kj + 1][2], s[2 * kj + 1][3]),
    };
#pragma unroll
    for (int dn = 0; dn < 4; ++dn) {
      uint32_t b[4];
      flash::ldsm_x4_trans(b, (v_addr ^ (dn << 5)) + kj * GROUP_BYTES);
      flash::mma16816<T>(acc[2 * dn], a, b[0], b[1]);
      flash::mma16816<T>(acc[2 * dn + 1], a, b[2], b[3]);
    }
  }
}

// a / b, correctly rounded, from r = 1 / b (correctly rounded): q = a r
// is within an ulp, and one step q + (a - q b) r with the residual exact by
// FMA rounds to the quotient (Markstein's correction). 32 of them a thread
// cost far less than 32 IEEE divisions.
__device__ __forceinline__ float quotient(float a, float b, float r) {
  const float q = a * r;
  return fmaf(fmaf(-q, b, a), r, q);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 3)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ valid, T* __restrict__ o, float* __restrict__ lse,
                 int seq, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = Smem16;
  T* Qs = reinterpret_cast<T*>(smem + L::Q);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const int q_tiles = seq / QT;
  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * QT;
  const size_t base = (size_t)bh * seq * D;
  const int nk = seq / KT;

  // K and V of key block i into stage i % 2, its live groups only, as two
  // commit groups (empty past the last block or for a dead one), so that
  // block i's K is always the 4th-newest group when block i starts and its V
  // the 3rd-newest: cp.async.wait_group 3 and 2.
  auto issue = [&](int i) {
    const int ng = i < nk ? block_mask(valid + i * KT, lane).groups : 0;
    unsigned char* st = smem + L::STAGES + (i & 1) * L::STAGE;
    copy_rows_async<T>(reinterpret_cast<T*>(st + L::K), k + base + (size_t)i * KT * D, ng);
    flash::cp_async_commit();
    copy_rows_async<T>(reinterpret_cast<T*>(st + L::V), v + base + (size_t)i * KT * D, ng);
    flash::cp_async_commit();
  };

  copy_rows_async<T>(Qs, q + base + (size_t)q0 * D, QT / 16);  // in block 0's K group
  issue(0);
  issue(1);
  const uint32_t smem0 = flash::smem_u32(smem);
  const LaneAddrs la = lane_addrs(smem0 + L::Q, warp, lane);

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

#pragma unroll 1
  for (int i = 0; i < nk; ++i) {
    const BlockMask bm = block_mask(valid + i * KT, lane);
    // Key 8 j + 2 t + e is lane 2 j + t / 2's component 2 (t % 2) + e.
    const uint32_t ok0 = ((t & 1) ? bm.bits[2] : bm.bits[0]) >> (t >> 1);
    const uint32_t ok1 = ((t & 1) ? bm.bits[3] : bm.bits[1]) >> (t >> 1);
    flash::cp_async_wait<3>();
    __syncthreads();  // block i's K is visible to every warp
    const uint32_t st = smem0 + L::STAGES + (i & 1) * L::STAGE;
    const uint32_t ka = st + L::K + la.k, va = st + L::V + la.v;
    // Instantiated per group count, so every product loop stays unrolled
    // without a branch inside it; every warp takes the same case.
    switch (bm.groups) {
      case 8: block_step<T, 8>(acc, m, l, la.q, ka, va, ok0, ok1, scale); break;
      case 7: block_step<T, 7>(acc, m, l, la.q, ka, va, ok0, ok1, scale); break;
      case 6: block_step<T, 6>(acc, m, l, la.q, ka, va, ok0, ok1, scale); break;
      case 5: block_step<T, 5>(acc, m, l, la.q, ka, va, ok0, ok1, scale); break;
      case 4: block_step<T, 4>(acc, m, l, la.q, ka, va, ok0, ok1, scale); break;
      case 3: block_step<T, 3>(acc, m, l, la.q, ka, va, ok0, ok1, scale); break;
      case 2: block_step<T, 2>(acc, m, l, la.q, ka, va, ok0, ok1, scale); break;
      case 1: block_step<T, 1>(acc, m, l, la.q, ka, va, ok0, ok1, scale); break;
      default: break;  // no valid key in the block: exact to skip (see the top)
    }
    __syncthreads();  // every warp is done with stage i % 2
    issue(i + 2);
  }
  flash::cp_async_wait_all();

  // o through the warp's own 16 rows of the q tile (which only this warp
  // reads), then 16-byte stores: 8 lanes per row.
  const float ls0 = fmaxf(l[0], 1e-30f), ls1 = fmaxf(l[1], 1e-30f);
  const float r0 = 1.0f / ls0, r1 = 1.0f / ls1;
  T* Ow = Qs + warp * 16 * D;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<uint32_t*>(Ow + swz(g, j) + 2 * t) =
        flash::pack2<T>(quotient(acc[j][0], ls0, r0), quotient(acc[j][1], ls0, r0));
    *reinterpret_cast<uint32_t*>(Ow + swz(g + 8, j) + 2 * t) =
        flash::pack2<T>(quotient(acc[j][2], ls1, r1), quotient(acc[j][3], ls1, r1));
  }
  if (t == 0) {
    const size_t r = (size_t)bh * seq + q0 + warp * 16 + g;
    lse[r] = fmaxf(m[0], NEG_BIG) + logf(ls0);
    lse[r + 8] = fmaxf(m[1], NEG_BIG) + logf(ls1);
  }
  __syncwarp();
  T* og = o + base + (size_t)(q0 + warp * 16) * D;
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int r = 4 * it + (lane >> 3), ch = lane & 7;
    *reinterpret_cast<uint4*>(og + r * D + ch * 8) =
        *reinterpret_cast<const uint4*>(Ow + swz(r, ch));
  }
}

// -------------------------------------------------------------- fp32 inputs
constexpr int LD32 = D + 1;    // odd strides: conflict-free scalar reads
constexpr int PLD32 = KT + 1;
constexpr int SLD = KT + 4;    // fp32 score row stride (also the o staging)
constexpr int OLD = D + 4;     // fp32 o staging row stride, aliases the scores

// Byte offsets of the fp32 kernel's shared-memory regions; each starts
// 128-byte aligned.
struct Smem32 {
  static constexpr int Q = 0;
  static constexpr int K = round_up(Q + QT * LD32 * 4, 128);
  static constexpr int V = round_up(K + KT * LD32 * 4, 128);
  static constexpr int M = round_up(V + KT * LD32 * 4, 128);
  static constexpr int S = round_up(M + KT * 4, 128);
  static constexpr int P = round_up(S + WARPS * 16 * SLD * 4, 128);
  static constexpr int BYTES = round_up(P + WARPS * 16 * PLD32 * 4, 128);
};

// Copy `rows` x D elements into shared memory at this kernel's row stride,
// multiplied by `mul` (q is pre-scaled here).
__device__ __forceinline__ void load_tile32(float* dst, const float* __restrict__ src, int rows,
                                            float mul) {
  flash::load_rows<float, LD32, THREADS>(dst, src, rows, mul);
}

// Scores of this warp's 16 query rows against the 128 keys of the tile, in
// fp32, into Sw[16][SLD] (the scale is folded into q).
__device__ __forceinline__ void warp_scores32(const float* Qw, const float* Ks, float* Sw,
                                              int lane) {
  const int row = lane >> 1, half = lane & 1;
  const float* qrow = Qw + row * LD32;
  for (int t = 0; t < KT / 2; ++t) {
    const int c = half + 2 * t;
    const float* krow = Ks + c * LD32;
    float s = 0.0f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) s = fmaf(qrow[d], krow[d], s);
    Sw[row * SLD + c] = s;
  }
}

// O_tile[16][D] = P[16][KT] . V[KT][D] in fp32, into Ow[16][OLD].
__device__ __forceinline__ void warp_pv32(const float* Pw, const float* Vs, float* Ow,
                                          int lane) {
  const int row = lane >> 1, half = lane & 1;
  float out[D / 2];
#pragma unroll
  for (int t = 0; t < D / 2; ++t) out[t] = 0.0f;
  for (int j = 0; j < KT; ++j) {
    const float p = Pw[row * PLD32 + j];
    const float* vrow = Vs + j * LD32;
#pragma unroll
    for (int t = 0; t < D / 2; ++t) out[t] = fmaf(p, vrow[half + 2 * t], out[t]);
  }
#pragma unroll
  for (int t = 0; t < D / 2; ++t) Ow[row * OLD + half + 2 * t] = out[t];
}

// fp32: one block of 4 warps per (b*h, 64 query rows); a loop over the
// 128-key tiles, staged in shared memory; lane pair (2r, 2r+1) owns query
// row r of its warp.
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel_fp32(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ valid,
                      float* __restrict__ o, float* __restrict__ lse, int seq, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = Smem32;
  float* Qs = reinterpret_cast<float*>(smem + L::Q);
  float* Ks = reinterpret_cast<float*>(smem + L::K);
  float* Vs = reinterpret_cast<float*>(smem + L::V);
  float* Ms = reinterpret_cast<float*>(smem + L::M);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* Sw = reinterpret_cast<float*>(smem + L::S) + warp * 16 * SLD;
  float* Ow = Sw;  // the PV result and the o staging tile reuse the scores
  float* Pw = reinterpret_cast<float*>(smem + L::P) + warp * 16 * PLD32;
  const float* Qw = Qs + warp * 16 * LD32;

  const int q_tiles = seq / QT;
  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * QT;
  const size_t base = (size_t)bh * seq * D;
  const int row = lane >> 1, half = lane & 1;

  load_tile32(Qs, q + base + (size_t)q0 * D, QT, scale);

  float acc[D / 2];  // o row `row`, columns half + 2t
#pragma unroll
  for (int t = 0; t < D / 2; ++t) acc[t] = 0.0f;
  float m = -INFINITY, l = 0.0f;

  for (int k0 = 0; k0 < seq; k0 += KT) {
    __syncthreads();  // every warp is done with the previous tile
    load_tile32(Ks, k + base + (size_t)k0 * D, KT, 1.0f);
    load_tile32(Vs, v + base + (size_t)k0 * D, KT, 1.0f);
    for (int i = threadIdx.x; i < KT; i += THREADS) Ms[i] = valid[k0 + i];
    __syncthreads();

    warp_scores32(Qw, Ks, Sw, lane);
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
      Pw[row * PLD32 + c] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();

    warp_pv32(Pw, Vs, Ow, lane);
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
  float* og = o + base + (size_t)(q0 + warp * 16) * D;
  for (int i = lane; i < 16 * D; i += 32) og[i] = Ow[(i / D) * OLD + i % D];
}

// ------------------------------------------------------------------ launch
// Above 48 KB of shared memory a launch needs the opt-in attribute, which
// belongs to the current device; each kernel also asks for the SM's largest
// shared-memory carveout, which three 16-bit blocks need.
template <typename K>
cudaError_t opt_in(K kernel, int bytes) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  return err;
}

cudaError_t prepare() {
  const cudaError_t errs[] = {
      opt_in(flash_fwd_kernel_fp32, Smem32::BYTES),
      opt_in(flash_fwd_kernel<__nv_bfloat16>, Smem16::BYTES),
      opt_in(flash_fwd_kernel<__half>, Smem16::BYTES),
  };
  for (cudaError_t err : errs)
    if (err != cudaSuccess) return err;
  return cudaSuccess;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* valid, void* o, void* lse,
           int bh, int seq, float scale, cudaStream_t stream) {
  const int blocks = bh * (seq / QT);
  if constexpr (sizeof(T) == 4) {
    flash_fwd_kernel_fp32<<<blocks, THREADS, Smem32::BYTES, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(valid), static_cast<float*>(o),
        static_cast<float*>(lse), seq, scale);
  } else {
    flash_fwd_kernel<T><<<blocks, THREADS, Smem16::BYTES, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(valid), static_cast<T*>(o), static_cast<float*>(lse), seq,
        scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Sets the shared-memory opt-in of every instantiation on the current device.
// Call once per device before the first flash_fwd on it. Returns the
// cudaError_t (0 = success).
extern "C" int flash_fwd_prepare() { return (int)prepare(); }

// Blocks of the kernel for `dtype` (as flash_fwd) that one SM of the current
// device holds at once, from its registers and shared memory; -1 on an error.
extern "C" int flash_fwd_blocks_per_sm(int dtype) {
  int n = -1;
  cudaError_t err = cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, flash_fwd_kernel_fp32, THREADS,
                                                          Smem32::BYTES);
      break;
    case 1:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, flash_fwd_kernel<__nv_bfloat16>, THREADS, Smem16::BYTES);
      break;
    case 2:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, flash_fwd_kernel<__half>, THREADS,
                                                          Smem16::BYTES);
      break;
  }
  return err == cudaSuccess ? n : -1;
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. q, k, v, o: contiguous
// [bh, seq, 64], 16-byte aligned; valid: float32 [seq], 16-byte aligned (the
// 16-bit kernels read it 16 bytes at a time); lse: float32 [bh, seq]. seq
// must be a multiple of 128. Returns the cudaError_t of the launch
// (0 = success).
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
