// Flash attention forward on [b, h, n, d] bf16 operands, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel lightning_generative_models_tpu/ops/attention.py:_flash_kernel
// (launched through _flash_attention_impl, reached by scaled_dot_product_attention with
// use_pallas=True at n_kv >= 256). Same function: s = q k^T scaled by d^-1/2 in f32, keys at
// or past n_kv masked to -inf, the online softmax's running max and sum in f32, o
// accumulated as p v in f32 with p never rounded to bf16 alone (the Pallas kernel casts k
// and v to f32 first), o / l cast to bf16 once. Here the raw q k^T of the exact bf16 q and
// k is scaled in f32 afterwards, as attention_qkv.cu does (d^-1/2 is not a power of two at
// d = 48, so a scaled q would not be exact in bf16), with log2(e) folded into the scale so
// that the softmax takes exp2.
//
// f32 operands do not come here: flash_attention_cuda sends them to the forward of
// attention_qkv.cu (kernel #3's), which takes the same [b, h, n, d] strides and n_q != n_kv
// and was faster than this file's earlier 3xTF32 tile code at every measured f32 shape.
//
// Operands are read in place through their own (batch, head, token) strides, the last
// dimension contiguous: the DiT's q, k and v are [b, h, n, d] views of the packed
// [b, n, 3, h, d] or [b, n, h, 3, d] Dense output, the UNet's are views of [b, n, h, d]
// tensors, and o is written through its strides (a [b, h, n, d] view of a [b, n, h, d]
// buffer, so that the caller's transpose back is free). n_q and n_kv are independent.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): 4 b h n_q n_kv d flops
// against q, k, v read once and o written once. At DiT-S/2 (b 128, h 6, n 256, d 64) that
// is 12.9 GFLOP (13 us at the tensor-core peak) and 101 MB (30 us): bound by bytes.
//
// Design (TMA, wgmma, mbarriers, warp specialisation):
//  - TMA tensor maps, one an operand and one for o, encoded on the host (the encoder is
//    looked up at run time, so nothing is linked): dims (d, then the tensor's
//    token, head and batch dims in increasing stride), its own strides in bytes, a box of
//    64 columns by 64 tokens, 128-byte swizzle. TMA's out-of-bounds zero fill covers the
//    ragged last key tile, query rows past n_q and the columns past d (d up to 64 is one
//    64-column slab a tile, up to 128 two); the zero keys are masked to -inf.
//  - A block of five warps takes one (b*h row, 64-query tile) of a 1-D grid in which the
//    query tiles of a row are neighbours (they read the row's keys and values from L2);
//    three blocks share an SM (two at d > 64). Warp 4 is the producer: one lane loads q and
//    streams the K/V tiles of 64 keys through a ring of stages, each with a "full"
//    mbarrier (TMA's byte count) and an "empty" one (an arrival from each consumer warp),
//    so the copies of the next tiles are in flight while a tile's products run. Warps 0-3
//    are the consumer warpgroup.
//  - S = Q K^T as wgmma.m64n64k16, both operands read from shared memory by descriptors
//    (K-major, 128-byte swizzle, the k step 32 bytes along the row): q and k are exact
//    bf16, one product a step.
//  - The online softmax on S in the accumulator registers: a thread holds rows g and g + 8
//    of its warp's 16, a row's max and sum reduced over the four lanes of its quad; 2^x on
//    the special-function unit.
//  - O += P V as wgmma with A from registers: the accumulator layout of S is the A
//    fragment layout, so P goes from the registers that made it into the product. V is
//    the B operand read MN-major (the transpose bit). P is split into bf16 hi + lo (to
//    ~2^-17 relative) and both parts meet the exact bf16 V: two products, so P is never
//    rounded to bf16 alone.
//  - The warpgroup's pipeline: tile j's scores and tile j - 1's P V are started together,
//    the first half of tile j's softmax runs while that P V is in flight, and the stage of
//    tile j - 1 goes back to the producer when it is done.
//  - The epilogue writes o / l in bf16 to q's place in shared memory, swizzled as a TMA box,
//    and one TMA store a slab sends whole rows to o's strides; the store drops the rows
//    past n_q and the columns past d. No atomics: repeats are bit identical.
// The loads set the pace at the DiT's shape, not the products: each 64-query block reads
// its row's K and V from L2 (four times a row at n = 256). Sharing them between the blocks
// of a thread-block cluster (TMA multicast) or between two consumer warpgroups of a block
// measured slower on the H100 (PERF.md, Findings).

#include <cuda.h>  // CUtensorMap and the encoder's types; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

#include "attention_qkv_common.cuh"
#include "wgmma.cuh"

namespace {

using attn::quad_max;
using attn::quad_sum;
using attn::smem_addr;
using attn::split_bf16;
using attn::store_pair;
using wgmma::keep;
using wgmma::mma_bf16_rs;
using wgmma::mma_bf16_ss;
using wgmma::wgmma_commit;
using wgmma::wgmma_fence;
using wgmma::wgmma_wait;

constexpr int kRows = 64;           // queries a block: one consumer warpgroup
constexpr int kKeys = 64;           // keys a tile
constexpr int kThreads = 128 + 32;  // the consumer warpgroup and the producer warp
constexpr int kSlabCols = 64;                    // bf16 columns of a 128-byte swizzled row
constexpr int kRowBytes = 128;
constexpr int kTileBytes = kKeys * kRowBytes;    // one slab of a K or V tile

// Stages of the K/V ring and blocks an SM, by d rounded up (DMAX): three stages and three
// blocks up to d = 64 (58 KB of shared memory a block), two and two at d = 128 (83 KB).
template <int DMAX>
constexpr int kStages = DMAX <= 64 ? 3 : 2;
template <int DMAX>
constexpr int kMinBlocks = DMAX <= 64 ? 3 : 2;

template <int DMAX>
struct Layout {
  static constexpr int slabs = (DMAX + kSlabCols - 1) / kSlabCols;
  static constexpr int q_bytes = slabs * kRows * kRowBytes;
  static constexpr int stage_bytes = 2 * slabs * kTileBytes;  // K's slabs, then V's
  static constexpr int barriers = 1 + 2 * kStages<DMAX>;      // q; full[s]; empty[s]
  // 1024 bytes of slack to align the 128-byte swizzle's 1024-byte atoms.
  static constexpr size_t smem = 1024 + q_bytes + kStages<DMAX> * stage_bytes + 8 * barriers;
};

struct Maps {
  CUtensorMap q, k, v, o;
};

struct FlashArgs {
  int heads, n_q, n_kv, d;
  float scale_log2;  // d^-1/2 * log2(e)
  int sel[4][3];     // per map (q, k, v, o): which of (token, head, batch) is map dim 1, 2, 3
};

// -- mbarriers, TMA, wgmma ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Arrive and expect `bytes` of TMA traffic on the barrier's current phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t ns;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(ns));
  return ns;
}

// Wait until the phase of the given parity has completed. A wait of 10 s (a fault: the
// copies take microseconds) traps, so that the launch fails rather than hangs the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t since = 0;
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == 1024) since = global_ns();
    if (tries > 1024 && tries % 1024 == 0 && global_ns() - since > 10000000000ull) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
        "r"(c3)
      : "memory");
}

// The box at dst to the global tensor; what lies past the tensor's bounds is not written.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The coordinate of tensor-map dim `which` (encode's sel): 0 token, 1 head, 2 batch row.
__device__ __forceinline__ int coord(int which, int token, int h, int b) {
  return which == 0 ? token : which == 1 ? h : b;
}

// Rows [token, token + box) of column slab `slab` of head h of batch row b.
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map,
                                          const int (&sel)[3], uint32_t bar, int slab,
                                          int token, int h, int b) {
  tma_load_4d(dst, map, bar, slab * kSlabCols, coord(sel[0], token, h, b),
              coord(sel[1], token, h, b), coord(sel[2], token, h, b));
}

// Shared-memory matrix descriptors, 128-byte swizzle (layout type 1 in bits 62-63), the
// 8-row groups 1024 bytes apart (stride byte offset). K-major (q, k: a row of 64 bf16 along
// k): the leading byte offset is unused. MN-major (v: a row of 64 bf16 along n, one row a
// key): the leading byte offset is the step to the next 64 columns, unused at n = 64.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t{kTileBytes >> 4} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

// 2^x on the special-function unit; results below 2^-126 flush to 0 (a probability that
// small adds nothing to a row sum of at least 1).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// -- the kernel ------------------------------------------------------------------------------

// S = Q K^T for the block's 64 queries and a 64-key tile, over DMAX / 16 steps of k (the
// columns past d are zero in both).
template <int DMAX>
__device__ __forceinline__ void start_qk(float (&s)[32], uint32_t q_s, uint32_t k_s) {
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk)
    mma_bf16_ss(s, desc_k_major(q_s + (kk >> 2) * kRows * kRowBytes + (kk & 3) * 32),
             desc_k_major(k_s + (kk >> 2) * kTileBytes + (kk & 3) * 32), kk > 0);
}

// O += (P_hi + P_lo) V over the tile's 64 keys, the small terms first.
template <int SLABS>
__device__ __forceinline__ void start_pv(float (&o)[SLABS][32], const uint32_t (&p_hi)[4][4],
                                         const uint32_t (&p_lo)[4][4], uint32_t v_s) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int sl = 0; sl < SLABS; ++sl) {
      const uint64_t dv = desc_mn_major(v_s + sl * kTileBytes + kk * 16 * kRowBytes);
      mma_bf16_rs(o[sl], p_lo[kk], dv);
      mma_bf16_rs(o[sl], p_hi[kk], dv);
    }
}

// Pin the registers of the products in flight: no instruction but a product may define an
// accumulator between wgmma.fence and the wait (or ptxas serializes the products), and an
// operand's registers stay unchanged until the product that reads them is done.
template <int SLABS>
__device__ __forceinline__ void keep_all(float (&o)[SLABS][32], uint32_t (&p_hi)[4][4],
                                         uint32_t (&p_lo)[4][4]) {
#pragma unroll
  for (int sl = 0; sl < SLABS; ++sl)
#pragma unroll
    for (int r = 0; r < 32; ++r) keep(o[sl][r]);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      keep(p_hi[kk][r]);
      keep(p_lo[kk][r]);
    }
}

// The first half of the online softmax on a tile's scores: scale to log2 units in f32,
// mask the keys at or past n_kv to -inf, take each row's new running max, and turn s into
// p = 2^(s - m_new) with this lane's row sums.
__device__ __forceinline__ void scores_to_probs(float (&s)[32], const float (&m)[2],
                                                float (&m_new)[2], float (&sum)[2], int k0,
                                                int n_kv, float scale_log2, int t) {
  const bool ragged = k0 + kKeys > n_kv;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s[4 * jj + c] *= scale_log2;
      if (ragged && k0 + 8 * jj + 2 * t + (c & 1) >= n_kv) s[4 * jj + c] = -INFINITY;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) mx = fmaxf(mx, fmaxf(s[4 * jj + 2 * i], s[4 * jj + 2 * i + 1]));
    m_new[i] = fmaxf(m[i], quad_max(mx));  // finite: the tile has a valid key
    sum[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      s[4 * jj + 2 * i] = exp2_ftz(s[4 * jj + 2 * i] - m_new[i]);
      s[4 * jj + 2 * i + 1] = exp2_ftz(s[4 * jj + 2 * i + 1] - m_new[i]);
      sum[i] += s[4 * jj + 2 * i] + s[4 * jj + 2 * i + 1];
    }
  }
}

// The second half, once the previous P V is done: rescale the running sum and O by
// 2^(m - m_new), and split P into the A fragments (hi and lo) of the next P V, whose 16
// keys of step kk are the 8-column blocks 2 kk (registers 8 kk .. 8 kk + 3) and 2 kk + 1.
template <int SLABS>
__device__ __forceinline__ void rescale_and_split(const float (&s)[32], float (&m)[2],
                                                  const float (&m_new)[2], const float (&sum)[2],
                                                  float (&l)[2], float (&o)[SLABS][32],
                                                  uint32_t (&p_hi)[4][4],
                                                  uint32_t (&p_lo)[4][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float alpha = exp2_ftz(m[i] - m_new[i]);  // 0 on the first tile, where m is -inf
    l[i] = l[i] * alpha + sum[i];
#pragma unroll
    for (int sl = 0; sl < SLABS; ++sl)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        o[sl][4 * jj + 2 * i] *= alpha;
        o[sl][4 * jj + 2 * i + 1] *= alpha;
      }
    m[i] = m_new[i];
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], p_hi[kk][r], p_lo[kk][r]);
}

// DMAX: d rounded up to 32, 64 or 128.
template <int DMAX>
__global__ void __launch_bounds__(kThreads, kMinBlocks<DMAX>)
    flash_fwd_wgmma_kernel(const __grid_constant__ Maps maps, const FlashArgs a) {
  using L = Layout<DMAX>;
  constexpr int SLABS = L::slabs;
  constexpr int STAGES = kStages<DMAX>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t q_s = smem_addr(smem);    // [slab][kRows][128 bytes]
  const uint32_t kv_s = q_s + L::q_bytes;  // [stage][K slabs, V slabs][64][128 bytes]
  const uint32_t bars = kv_s + STAGES * L::stage_bytes;
  const uint32_t q_full = bars;
  const auto full = [&](int s) { return bars + 8 * (1 + s); };
  const auto empty = [&](int s) { return bars + 8 * (1 + STAGES + s); };

  const int q_tiles = (a.n_q + kRows - 1) / kRows;
  const int row = blockIdx.x / q_tiles;  // b * heads + h
  const int b = row / a.heads, h = row - b * a.heads;
  const int q0 = (blockIdx.x - row * q_tiles) * kRows;
  const int n_tiles = (a.n_kv + kKeys - 1) / kKeys;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {  // the producer
    if (lane == 0) {
      mbar_expect_tx(q_full, L::q_bytes);
      for (int s = 0; s < SLABS; ++s)
        load_rows(q_s + s * kRows * kRowBytes, &maps.q, a.sel[0], q_full, s, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % STAGES;
        if (j >= STAGES) mbar_wait(empty(st), ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(st), L::stage_bytes);
        const uint32_t k_dst = kv_s + st * L::stage_bytes;
        for (int s = 0; s < SLABS; ++s) {
          load_rows(k_dst + s * kTileBytes, &maps.k, a.sel[1], full(st), s, j * kKeys, h, b);
          load_rows(k_dst + (SLABS + s) * kTileBytes, &maps.v, a.sel[2], full(st), s,
                    j * kKeys, h, b);
        }
      }
    }
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  const auto k_tile = [&](int j) { return kv_s + (j % STAGES) * L::stage_bytes; };

  // Rows g (i = 0) and g + 8 (i = 1) of the warp's 16: the running max (in log2 units)
  // and this lane's share of the running sum. o[sl] holds columns 64 sl .. 64 sl + 63 in
  // the accumulator layout: o[sl][4 jj + c], jj the 8-column block, c as in the mma tile.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, m_new[2], sum[2];
  float o[SLABS][32], s[32];
  uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
  for (int sl = 0; sl < SLABS; ++sl)
#pragma unroll
    for (int r = 0; r < 32; ++r) o[sl][r] = 0.f;

  // Tile 0's scores alone; then each step starts tile j's scores and tile j - 1's P V
  // together, and the softmax of tile j's scores runs while that P V is in flight.
  mbar_wait(q_full, 0);
  mbar_wait(full(0), 0);
#pragma unroll
  for (int r = 0; r < 32; ++r) keep(s[r]);
  wgmma_fence();
  start_qk<DMAX>(s, q_s, k_tile(0));
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int r = 0; r < 32; ++r) keep(s[r]);
  scores_to_probs(s, m, m_new, sum, 0, a.n_kv, a.scale_log2, t);
  rescale_and_split(s, m, m_new, sum, l, o, p_hi, p_lo);

  for (int j = 1; j < n_tiles; ++j) {
    mbar_wait(full(j % STAGES), (j / STAGES) & 1);
#pragma unroll
    for (int r = 0; r < 32; ++r) keep(s[r]);
    keep_all(o, p_hi, p_lo);
    wgmma_fence();
    start_qk<DMAX>(s, q_s, k_tile(j));
    wgmma_commit();
    start_pv(o, p_hi, p_lo, k_tile(j - 1) + SLABS * kTileBytes);
    wgmma_commit();
    wgmma_wait<1>();  // the scores (committed first) are done
#pragma unroll
    for (int r = 0; r < 32; ++r) keep(s[r]);
    scores_to_probs(s, m, m_new, sum, j * kKeys, a.n_kv, a.scale_log2, t);
    wgmma_wait<0>();  // and tile j - 1's P V: its stage goes back to the producer
    keep_all(o, p_hi, p_lo);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty((j - 1) % STAGES));
    rescale_and_split(s, m, m_new, sum, l, o, p_hi, p_lo);
  }

  keep_all(o, p_hi, p_lo);
  wgmma_fence();
  start_pv(o, p_hi, p_lo, k_tile(n_tiles - 1) + SLABS * kTileBytes);
  wgmma_commit();
  wgmma_wait<0>();
  keep_all(o, p_hi, p_lo);

  // o / l goes out through shared memory, in q's place (the last scores are done), laid
  // out as TMA's 128-byte swizzle lays a box, and one TMA store a slab: whole rows, and
  // nothing past n_q or d reaches memory.
  const float inv[2] = {1.f / quad_sum(l[0]), 1.f / quad_sum(l[1])};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * warp + g + 8 * i;
#pragma unroll
    for (int sl = 0; sl < SLABS; ++sl)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        store_pair(reinterpret_cast<__nv_bfloat16*>(smem + sl * kRows * kRowBytes +
                                                    r * kRowBytes + ((jj ^ (r & 7)) << 4)) +
                       2 * t,
                   o[sl][4 * jj + 2 * i] * inv[i], o[sl][4 * jj + 2 * i + 1] * inv[i]);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to the store
  asm volatile("bar.sync 1, 128;\n" ::: "memory");                // the four warps' rows
  if (threadIdx.x == 0) {
    const int(&sel)[3] = a.sel[3];
    for (int sl = 0; sl < SLABS; ++sl)
      tma_store_4d(&maps.o, q_s + sl * kRows * kRowBytes, sl * kSlabCols,
                   coord(sel[0], q0, h, b), coord(sel[1], q0, h, b), coord(sel[2], q0, h, b));
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");  // before smem goes
  }
}

// -- host ----------------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a libcuda function, looked up at run time (the entry-point query) so
// that nothing beyond the CUDA runtime is linked.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                             12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of one [b, heads, n, d] bf16 operand with (batch, head, token) strides
// in elements: dim 0 is d, dims 1-3 the token, head and batch dims in increasing stride
// (a dim of size 1 is never stepped and sorts last); sel[i] names map dim i + 1 (0 token,
// 1 head, 2 batch). The box: 64 columns by `rows` tokens.
bool encode(CUtensorMap* map, int (&sel)[3], const void* base, const long long* strides,
            int b, int heads, int n, int d, int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  long long size[3] = {n, heads, b};
  long long stride[3] = {strides[2], strides[1], strides[0]};
  long long largest = d;
  for (int i = 0; i < 3; ++i) {
    if (size[i] > 1 && (stride[i] <= 0 || (2 * stride[i]) % 16 != 0)) return false;
    if (size[i] > 1 && stride[i] > largest) largest = stride[i];
  }
  int order[3] = {0, 1, 2};
  long long key[3];
  for (int i = 0; i < 3; ++i) key[i] = size[i] > 1 ? stride[i] : largest + 1;
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (key[order[j]] < key[order[i]]) {
        const int x = order[i];
        order[i] = order[j];
        order[j] = x;
      }
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), 0, 0, 0};
  cuuint64_t bytes[3];
  cuuint32_t box[4] = {kSlabCols, 1, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    const int w = order[i];
    sel[i] = w;
    dims[i + 1] = static_cast<cuuint64_t>(size[w]);
    bytes[i] = static_cast<cuuint64_t>(2 * (size[w] > 1 ? stride[w] : largest));
    if (w == 0) box[i + 1] = rows;
  }
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, bytes,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DMAX>
cudaError_t launch(const Maps& maps, const FlashArgs& a, int rows, cudaStream_t stream) {
  constexpr size_t smem = Layout<DMAX>::smem;
  const cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<DMAX>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = rows * ((a.n_q + kRows - 1) / kRows);
  flash_fwd_wgmma_kernel<DMAX><<<blocks, kThreads, smem, stream>>>(maps, a);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: element [0, 0, 0, 0] of each [b, heads, n, d] bf16 operand. strides: 12 int64,
// the (batch, head, token) strides of q, k, v and o in elements; the last dimension is
// contiguous; q, k, v and o 16-byte aligned, with strides of a multiple of 16 bytes (TMA's
// rule), none 0 where its dim is longer than 1. d a multiple of 8 up to 128; b * heads *
// ceil(n_q / 64) blocks at most 2^31 - 1. Returns a cudaError_t (0: launched;
// cudaErrorInvalidValue also when a tensor map cannot be encoded).
extern "C" int lgm_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                       const void* strides, int b, int heads, int n_q,
                                       int n_kv, int d, float scale, void* stream) {
  if (!attn::valid_shape(b, heads, n_q, n_kv, d) ||
      static_cast<long long>(b) * heads * ((n_q + kRows - 1) / kRows) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* s = static_cast<const long long*>(strides);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Maps maps;
  FlashArgs a{heads, n_q, n_kv, d, scale * 1.4426950408889634f, {}};
  if (!encode(&maps.q, a.sel[0], q, s, b, heads, n_q, d, kRows) ||
      !encode(&maps.k, a.sel[1], k, s + 3, b, heads, n_kv, d, kKeys) ||
      !encode(&maps.v, a.sel[2], v, s + 6, b, heads, n_kv, d, kKeys) ||
      !encode(&maps.o, a.sel[3], o, s + 9, b, heads, n_q, d, kRows))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(d <= 32   ? launch<32>(maps, a, b * heads, st)
                          : d <= 64 ? launch<64>(maps, a, b * heads, st)
                                    : launch<128>(maps, a, b * heads, st));
}

extern "C" const char* lgm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
