// Shapes, tensor-core fragments and the passes shared by the linear-attention block forward
// (linear_attention.cu) and backward (linear_attention_bwd.cu) kernels.
//
// Every product runs on the tensor cores as warp-level mma.sync (mma_sync.cuh): bf16
// m16n8k16 on operands already rounded to bf16, which the f32 accumulator sums exactly, so
// the rounding points of the reference stay where they are and only the order of the f32
// sums changes; in f32, 3xTF32 m16n8k8 on the same tiles.
//
// Work is cut into 16-token subtiles, the rows of one mma. A block of four warps takes a
// chunk of consecutive subtiles of one batch row (Plan), one subtile at a time
// (walk_subtiles: a cp.async ring, RMSNorm with eight threads a row): warp h does head h's
// work (q, k, v, the softmaxes, keᵀ v), and the full-width products (y = a Wo, dxn = dp
// Wqkvᵀ) are split by columns between the warps. A row-wide sum (the k max, z, the context
// keᵀ v, its gradient qsᵀ da) is one partial per block, merged per row by a later launch
// in a fixed order. No float atomics: two calls on the same inputs give the same bits.
// Launches use programmatic dependent launch (launch, pdl_enter), which overlaps a
// launch with the tail of the one before.
//
// Fragments. A 16 x 8 accumulator tile j holds, in lane (g, t) = (lane / 4, lane % 4), the
// elements (g, 8j + 2t), (g, 8j + 2t + 1), (g + 8, 8j + 2t), (g + 8, 8j + 2t + 1). In bf16
// that is also the A operand's layout, so a rounded accumulator is an A fragment in
// registers. In f32 (TF32 m16n8k8) the k index of every product is permuted, logical k = t
// reading column 2t and k = t + 4 column 2t + 1, so that A and B both read column pairs
// (2t, 2t + 1): the accumulator's layout again, and one float2 a fragment row.
//
// Operand sources: A from a row-major tile in shared memory (load_a_mk), from a [k][m]
// tile (load_a_km, the token contractions), from accumulator tiles (load_a_acc) or from a
// function (make_a, the memory tokens); B from memory in fragment order (load_b_frag:
// the weights, rounded and laid out once a call by prep_weights_kernel, and a row's
// context and its gradient, laid out by the merges), so that a warp's block is one
// coalesced load; from a tile in shared memory where element (k, n) sits at [n][k]
// (load_b_nk) or [k][n] (load_b_kn2); or from a function (make_b).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstddef>
#include <cstdint>
#include <map>
#include <mutex>
#include <utility>

#include "mma_sync.cuh"

namespace {

constexpr int kHeads = 4;
constexpr int kDimHead = 32;
constexpr int kHD = kHeads * kDimHead;  // 128
constexpr int kQKV = 3 * kHD;           // Wqkv columns: q | k | v, each head-major
constexpr int kTile = 32;               // n must be a multiple of this
constexpr int kSub = 16;                // tokens of a warp's subtile: the rows of an mma
constexpr int kWarps = 4;               // warps of a block: one a head
constexpr int kSMs = 132;
constexpr int kMaxSmem = 232448;        // dynamic shared memory of a block, bytes
constexpr int kLdh = kHD + 8;           // row stride of a [16][128] tile in shared memory
constexpr int kCtx = kHeads * kDimHead * kDimHead;  // a row's [4][32][32] context
constexpr float kEps = 1e-12f;
constexpr float kInvSqrtD = 0.17677669529663687f;  // 32 ** -0.5

// The direction a shared kernel was launched for: a template tag, so that a profile tells
// the forward's launches (LaFwd in the name) from the backward's (LaBwd).
struct LaFwd {
  static constexpr bool kForward = true;
};
struct LaBwd {
  static constexpr bool kForward = false;
};

__host__ __device__ constexpr size_t al16(size_t v) { return (v + 15) / 16 * 16; }

// First thing every kernel here does (see launch): wait until the previous kernel on the
// stream is done and its writes are visible, then let the next one be scheduled.
__device__ __forceinline__ void pdl_enter() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// How a call's b x n tokens are cut. A block of four warps takes a chunk of `chunk`
// consecutive 16-token subtiles of one batch row, one subtile at a time (S chunks a row,
// `blocks` = b S): about b n / 16 / 528 subtiles a block, so that the card gets ~4 blocks an
// SM, at least one subtile, so that the smallest call of the UNet, 4,096 tokens, still has
// 256 blocks; and at most kMaxChunks chunks a row. Row-wide sums are one partial per block.
constexpr int kMaxChunks = 8;
struct Plan {
  int chunk, S, blocks;
  Plan(int b, int n) {
    const int spr = n / kSub;
    long long per = static_cast<long long>(b) * spr / (4 * kSMs);
    if (per < 1) per = 1;
    if (per < (spr + kMaxChunks - 1) / kMaxChunks) per = (spr + kMaxChunks - 1) / kMaxChunks;
    chunk = per < spr ? static_cast<int>(per) : spr;
    S = (spr + chunk - 1) / chunk;
    blocks = b * S;
  }
};

// -- types ---------------------------------------------------------------------------------

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Rounds v to the compute type T and back: the reference's casts.
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

// (x, y) to dst[0], dst[1], rounded to T.
__device__ __forceinline__ void store_pair(float* dst, float x, float y) {
  *reinterpret_cast<float2*>(dst) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
}

// dst[0], dst[1] as floats.
__device__ __forceinline__ float2 load_pair(const float* src) {
  return *reinterpret_cast<const float2*>(src);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* src) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src));
}

// -- reductions ------------------------------------------------------------------------------

// Over the four lanes of a quad: one row of an accumulator tile.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// Over the eight lanes of one t: one column of an accumulator tile.
__device__ __forceinline__ float col_max(float v) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float col_sum(float v) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// -- fragments --------------------------------------------------------------------------------

template <typename T> struct Frag;
template <> struct Frag<__nv_bfloat16> {
  static constexpr int kK = 16;
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };
};
template <> struct Frag<float> {
  static constexpr int kK = 8;
  struct A { uint32_t hi[4], lo[4]; };
  struct B { uint32_t hi[2], lo[2]; };
};
using FA16 = Frag<__nv_bfloat16>::A;
using FB16 = Frag<__nv_bfloat16>::B;
using FA32 = Frag<float>::A;
using FB32 = Frag<float>::B;

__device__ __forceinline__ void mma(float (&c)[4], const FA16& a, const FB16& b) {
  tc::mma_bf16(c, a.r, b.r[0], b.r[1]);
}
// f32: the fresh-accumulator 3xTF32 product on round-to-nearest splits (mma_sync.cuh says
// why this block needs it).
__device__ __forceinline__ void mma(float (&c)[4], const FA32& a, const FB32& b) {
  tc::mma3_split_fresh(c, a.hi, a.lo, b.hi[0], b.lo[0], b.hi[1], b.lo[1]);
}

// f32 fragments from values: a0 (g, k 2t), a1 (g + 8, 2t), a2 (g, 2t + 1), a3 (g + 8,
// 2t + 1); b0 (k 2t, n g), b1 (2t + 1, g), in the permuted k order.
__device__ __forceinline__ void set_a(FA32& a, float a0, float a1, float a2, float a3) {
  tc::split_tf32_rn(a0, a.hi[0], a.lo[0]);
  tc::split_tf32_rn(a1, a.hi[1], a.lo[1]);
  tc::split_tf32_rn(a2, a.hi[2], a.lo[2]);
  tc::split_tf32_rn(a3, a.hi[3], a.lo[3]);
}
__device__ __forceinline__ void set_b(FB32& b, float b0, float b1) {
  tc::split_tf32_rn(b0, b.hi[0], b.lo[0]);
  tc::split_tf32_rn(b1, b.hi[1], b.lo[1]);
}

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// A (16 x kK) from a row-major [16][ld] tile in shared memory, columns k0 ...
__device__ __forceinline__ void load_a_mk(FA16& a, const __nv_bfloat16* s, int ld, int k0) {
  const int lane = threadIdx.x & 31;
  tc::ldmatrix_x4(a.r, s + (lane & 15) * ld + k0 + (lane >> 4) * 8);
}
__device__ __forceinline__ void load_a_mk(FA32& a, const float* s, int ld, int k0) {
  const int g = lane_g(), t = lane_t();
  const float2 u = load_pair(s + g * ld + k0 + 2 * t);
  const float2 w = load_pair(s + (g + 8) * ld + k0 + 2 * t);
  set_a(a, u.x, w.x, u.y, w.y);
}

// A (16 x kK) with A(m, k) = s[k * ld + m], rows m0 .. m0 + 15: a [k][m] tile in shared
// memory read transposed (the token contractions keᵀ v and qsᵀ da, the GEMMs xnᵀ dp).
__device__ __forceinline__ void load_a_km(FA16& a, const __nv_bfloat16* s, int ld, int m0,
                                          int k0) {
  const int lane = threadIdx.x & 31;
  tc::ldmatrix_x4_trans(a.r, s + (k0 + (lane & 7) + ((lane >> 4) << 3)) * ld + m0 +
                                 ((lane >> 3) & 1) * 8);
}
__device__ __forceinline__ void load_a_km(FA32& a, const float* s, int ld, int m0, int k0) {
  const float* p = s + (k0 + 2 * lane_t()) * ld + m0 + lane_g();
  set_a(a, p[0], p[8], p[ld], p[ld + 8]);
}

// A (16 x kK) from accumulator tiles whose values are already rounded to T: k block kb.
__device__ __forceinline__ void load_a_acc(FA16& a, const float (*tl)[4], int kb) {
  const float* x = tl[2 * kb];
  const float* y = tl[2 * kb + 1];
  a.r[0] = tc::pack_bf16(x[0], x[1]);
  a.r[1] = tc::pack_bf16(x[2], x[3]);
  a.r[2] = tc::pack_bf16(y[0], y[1]);
  a.r[3] = tc::pack_bf16(y[2], y[3]);
}
__device__ __forceinline__ void load_a_acc(FA32& a, const float (*tl)[4], int kb) {
  const float* x = tl[kb];
  set_a(a, x[0], x[2], x[1], x[3]);
}

// A (16 x kK) with A(r, k) = f(r, k), k local to the block.
template <typename F>
__device__ __forceinline__ void make_a(FA16& a, F f) {
  const int g = lane_g(), k = 2 * lane_t();
  a.r[0] = tc::pack_bf16(f(g, k), f(g, k + 1));
  a.r[1] = tc::pack_bf16(f(g + 8, k), f(g + 8, k + 1));
  a.r[2] = tc::pack_bf16(f(g, k + 8), f(g, k + 9));
  a.r[3] = tc::pack_bf16(f(g + 8, k + 8), f(g + 8, k + 9));
}
template <typename F>
__device__ __forceinline__ void make_a(FA32& a, F f) {
  const int g = lane_g(), k = 2 * lane_t();
  set_a(a, f(g, k), f(g + 8, k), f(g, k + 1), f(g + 8, k + 1));
}

// B (kK x 8), columns n0 .. n0 + 7, where B(k, n) = p[n * ld + k]; global or shared memory.
__device__ __forceinline__ void load_b_nk(FB16& b, const __nv_bfloat16* p, int ld, int n0,
                                          int k0) {
  const uint32_t* q =
      reinterpret_cast<const uint32_t*>(p + (n0 + lane_g()) * ld + k0 + 2 * lane_t());
  b.r[0] = q[0];
  b.r[1] = q[4];
}
__device__ __forceinline__ void load_b_nk(FB32& b, const float* p, int ld, int n0, int k0) {
  const float2 v = load_pair(p + (n0 + lane_g()) * ld + k0 + 2 * lane_t());
  set_b(b, v.x, v.y);
}

// Fragment order of a B operand (K x N): the kK x 8 block (k block kb, column tile j) as
// the 32 lanes' 8 bytes each, lane-major, so that a warp reads a block with one coalesced
// 256-byte load (load_b_frag). The offset of element (k, n), in elements of T:
template <typename T>
__device__ __forceinline__ int frag_off(int k, int n, int K) {
  constexpr int kK = Frag<T>::kK;
  const int kk = k % kK, lane = 4 * (n % 8) + (kk % 8) / 2;
  const int block = (n / 8) * (K / kK) + k / kK;
  return sizeof(T) == 2 ? (block * 32 + lane) * 4 + 2 * (kk / 8) + kk % 2
                        : (block * 32 + lane) * 2 + kk % 2;
}

// B (kK x 8) block (k0 / kK, j) of a K-deep operand stored in fragment order.
__device__ __forceinline__ void load_b_frag(FB16& b, const __nv_bfloat16* p, int K, int j,
                                            int k0) {
  const uint2 v = *reinterpret_cast<const uint2*>(
      p + ((j * (K / 16) + k0 / 16) * 32 + (threadIdx.x & 31)) * 4);
  b.r[0] = v.x;
  b.r[1] = v.y;
}
__device__ __forceinline__ void load_b_frag(FB32& b, const float* p, int K, int j, int k0) {
  const float2 v = *reinterpret_cast<const float2*>(
      p + ((j * (K / 8) + k0 / 8) * 32 + (threadIdx.x & 31)) * 2);
  set_b(b, v.x, v.y);
}

// B (kK x 16) as two 8-column blocks n0 and n0 + 8, where B(k, n) = s[k * ld + n]: a [k][n]
// tile in shared memory.
__device__ __forceinline__ void load_b_kn2(FB16& b0, FB16& b1, const __nv_bfloat16* s, int ld,
                                           int n0, int k0) {
  const int lane = threadIdx.x & 31;
  uint32_t r[4];
  tc::ldmatrix_x4_trans(r, s + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld + n0 +
                               (lane >> 4) * 8);
  b0.r[0] = r[0];
  b0.r[1] = r[1];
  b1.r[0] = r[2];
  b1.r[1] = r[3];
}
__device__ __forceinline__ void load_b_kn2(FB32& b0, FB32& b1, const float* s, int ld, int n0,
                                           int k0) {
  const float* p = s + (k0 + 2 * lane_t()) * ld + n0 + lane_g();
  set_b(b0, p[0], p[ld]);
  set_b(b1, p[8], p[ld + 8]);
}

// B (kK x 8) with B(k, n) = f(k, n), both local to the block.
template <typename F>
__device__ __forceinline__ void make_b(FB16& b, F f) {
  const int g = lane_g(), k = 2 * lane_t();
  b.r[0] = tc::pack_bf16(f(k, g), f(k + 1, g));
  b.r[1] = tc::pack_bf16(f(k + 8, g), f(k + 9, g));
}
template <typename F>
__device__ __forceinline__ void make_b(FB32& b, F f) {
  const int g = lane_g(), k = 2 * lane_t();
  set_b(b, f(k, g), f(k + 1, g));
}

// -- products ---------------------------------------------------------------------------------

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// acc[j] += A B over K, for the output columns 8 j .. 8 j + 7: la(a, k0) loads A's k block
// at k0, lb(b, j, k0) B's block for column tile j.
template <typename T, int NT, int K, typename LA, typename LB>
__device__ __forceinline__ void product(float (&acc)[NT][4], LA la, LB lb) {
#pragma unroll 4
  for (int k0 = 0; k0 < K; k0 += Frag<T>::kK) {
    typename Frag<T>::A a;
    la(a, k0);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      typename Frag<T>::B b;
      lb(b, j, k0);
      mma(acc[j], a, b);
    }
  }
}

// acc[j] += A B over one head's 32 features, A in accumulator tiles a[0 .. 3] (rounded).
template <typename T, int NT, typename LB>
__device__ __forceinline__ void product_regs(float (&acc)[NT][4], const float (&a)[4][4], LB lb) {
#pragma unroll
  for (int kb = 0; kb < kDimHead / Frag<T>::kK; ++kb) {
    typename Frag<T>::A fa;
    load_a_acc(fa, a, kb);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      typename Frag<T>::B b;
      lb(b, j, kb * Frag<T>::kK);
      mma(acc[j], fa, b);
    }
  }
}

// A lane-private [4][32][32] block (a partial of the context or of its gradient) in global
// memory: head h's element i of lane l at (h * 32 + i) * 32 + l, i the accumulator entry
// (tile (i / 16, (i / 4) % 4), entry i % 4) of the mma layout; its (row, column) is
// (frag_row(i), frag_col(i)).
__device__ __forceinline__ int frag_row(int i) { return 16 * (i >> 4) + lane_g() + 8 * ((i >> 1) & 1); }
__device__ __forceinline__ int frag_col(int i) { return 8 * ((i >> 2) & 3) + 2 * lane_t() + (i & 1); }

// -- moving subtiles ----------------------------------------------------------------------------

// The block's place in the plan: its batch row and its subtiles [s0, s1) of that row.
struct Chunk {
  int row, s0, s1;
  __device__ Chunk(int n, int S, int chunk) {
    row = blockIdx.x / S;
    s0 = (blockIdx.x % S) * chunk;
    const int spr = n / kSub;
    s1 = s0 + chunk < spr ? s0 + chunk : spr;
  }
};

// The merged per-feature max of k for feature col: the row's S block maxima and the m
// memory tokens (mem_kv [2][heads][d][m]: memory key j of feature col at col * m + j).
__device__ __forceinline__ float merged_kmax(const float* part_row, int S, const float* mem_kv,
                                             int m, int col) {
  float k = -INFINITY;
#pragma unroll
  for (int s = 0; s < kMaxChunks; ++s)
    if (s < S) k = fmaxf(k, part_row[s * kHD + col]);
  for (int j = 0; j < m; ++j) k = fmaxf(k, mem_kv[col * m + j]);
  return k;
}

// -- the passes both directions share ------------------------------------------------------------

// (1) Round the weights to T once a call, in fragment order (frag_off) for the products that
// read them as B: w_qkv (K = C: q, k, v = xn Wqkv) and w_y (K = 128: y = a Wo); for the
// backward also w_dxn (K = 384: dxn = dp Wqkvᵀ) and w_da (K = C: da = dy Woᵀ).
template <typename Dir, typename T>
__global__ void __launch_bounds__(256)
prep_weights_kernel(const float* __restrict__ wqkv, const float* __restrict__ wo, int C,
                    T* __restrict__ w_qkv, T* __restrict__ w_y, T* __restrict__ w_dxn,
                    T* __restrict__ w_da) {
  pdl_enter();
  const int total = C * kQKV + kHD * C;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    if (i < C * kQKV) {
      const int r = i / kQKV, j = i % kQKV;  // Wqkv[r][j]
      const T v = from_f<T>(wqkv[i]);
      w_qkv[frag_off<T>(r, j, C)] = v;
      if (!Dir::kForward) w_dxn[frag_off<T>(j, r, kQKV)] = v;
    } else {
      const int k = i - C * kQKV, r = k / C, c = k % C;  // Wo[r][c]
      const T v = from_f<T>(wo[k]);
      w_y[frag_off<T>(r, c, kHD)] = v;
      if (!Dir::kForward) w_da[frag_off<T>(c, r, C)] = v;
    }
  }
}

// Shared memory every pass starts with: a ring of two subtiles of its input rows (x, or xn
// for token pass A) and the subtile's xn, both [16][C + 8], and r0 of its 16 rows.
template <typename T, int NC>
struct SubtileSmem {
  static constexpr int C = NC * 32, kLdx = C + 8;
  static constexpr size_t ring = 0;
  static constexpr size_t xn = ring + al16(2 * kSub * kLdx * sizeof(T));
  static constexpr size_t r0 = xn + al16(kSub * kLdx * sizeof(T));
  static constexpr size_t bytes = r0 + al16(kSub * sizeof(float));
};

// A pass's walk over its block's chunk, one subtile at a time by all four warps: the
// subtile's rows (and whatever fetch_more(slot, s) adds) come in through a two-stage cp.async
// ring, the next subtile's copy issued once every warp is done with the slot it refills. With
// kNorm, x turns into xn (and r0; xn also to xn_out if given): eight threads a row, each
// taking C / 8 of its columns in pairs, the row's sum of squares in three shuffles; without,
// the ring holds xn itself. Then per(xn, rows, slot, s), rows the ring's subtile.
template <typename T, int NC, bool kNorm, typename Fetch, typename PerSubtile>
__device__ __forceinline__ void walk_subtiles(const T* src_row, const Chunk& ck, const float* g0,
                                              unsigned char* smem, T* xn_out, size_t tok0,
                                              Fetch fetch_more, PerSubtile per) {
  using L = SubtileSmem<T, NC>;
  constexpr int C = NC * 32, kVec = 16 / sizeof(T), kPerRow = C / kVec;
  constexpr int kPairs = C / 16;  // column pairs of a thread: 2 p + 16 q, q < kPairs
  const int nrow = threadIdx.x >> 3, part = threadIdx.x & 7;
  T* ring = reinterpret_cast<T*>(smem + L::ring);
  T* xn = kNorm ? reinterpret_cast<T*>(smem + L::xn) : nullptr;
  float* r0_s = reinterpret_cast<float*>(smem + L::r0);
  const float sqrt_c = sqrtf(static_cast<float>(C));
  float2 gs[kPairs];
#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    const float2 gv = kNorm ? load_pair(g0 + 2 * part + 16 * q) : make_float2(0.f, 0.f);
    gs[q] = make_float2(gv.x * sqrt_c, gv.y * sqrt_c);
  }
  auto fetch = [&](int slot, int s) {
    const T* src = src_row + static_cast<size_t>(s) * kSub * C;
    for (int i = threadIdx.x; i < kSub * kPerRow; i += blockDim.x) {
      const int r = i / kPerRow, c = i % kPerRow;
      tc::cp_async16(ring + (slot * kSub + r) * L::kLdx + c * kVec, src + r * C + c * kVec, true);
    }
    fetch_more(slot, s);
  };
  int buf = 0;
  fetch(0, ck.s0);
  tc::cp_async_commit();
  for (int s = ck.s0; s < ck.s1; ++s) {
    tc::cp_async_wait<0>();
    __syncthreads();  // this subtile is in; every warp is done with the other slot and xn
    if (s + 1 < ck.s1) fetch(buf ^ 1, s + 1);
    tc::cp_async_commit();
    const T* rows = ring + buf * kSub * L::kLdx;
    if (kNorm) {
      float2 xv[kPairs];
      float ss = 0.f;
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
        xv[q] = load_pair(rows + nrow * L::kLdx + 2 * part + 16 * q);
        ss += xv[q].x * xv[q].x + xv[q].y * xv[q].y;
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
      const float r0 = rsqrtf(ss + kEps);
      if (part == 0) r0_s[nrow] = r0;
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
        const int col = 2 * part + 16 * q;
        store_pair(xn + nrow * L::kLdx + col, xv[q].x * r0 * gs[q].x, xv[q].y * r0 * gs[q].y);
        if (xn_out != nullptr)
          store_pair(xn_out + (tok0 + static_cast<size_t>(s) * kSub + nrow) * C + col,
                     xv[q].x * r0 * gs[q].x, xv[q].y * r0 * gs[q].y);
      }
      __syncthreads();  // xn is complete
    }
    per(kNorm ? static_cast<const T*>(xn) : rows, rows, buf, s);
    buf ^= 1;
  }
  tc::cp_async_wait<0>();
}

// Nothing more to fetch with a subtile.
struct NoFetch {
  __device__ void operator()(int, int) const {}
};

// Sums over the block's four warps, for each of the subtile's rows, of K values: v[k][0] of
// row g and v[k][1] of row g + 8, first summed over the quad, then through red [K][4][16]
// in warp order; every warp gets the sums. Two block barriers.
template <int K>
__device__ __forceinline__ void rows_sum(float (&v)[K][2], float* red) {
  const int warp = threadIdx.x >> 5, g = lane_g(), t = lane_t();
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float q = quad_sum(v[k][half]);
      if (t == 0) red[(k * kWarps + warp) * kSub + g + 8 * half] = q;
    }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red[(k * kWarps + w) * kSub + g + 8 * half];
      v[k][half] = sum;
    }
  __syncthreads();  // red is free again
}

// Column sums of accumulator pairs over the eight lanes of one t, written by lanes t < 4
// (g = 0) to out[8 j + 2 t + c] (times mul): a block's partial of a per-column sum.
template <int NT>
__device__ __forceinline__ void store_col_sums(const float (&v)[NT][2], float* out, float mul) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float s0 = col_sum(v[j][0]), s1 = col_sum(v[j][1]);
    if (lane < 4) {
      out[8 * j + 2 * lane] = s0 * mul;
      out[8 * j + 2 * lane + 1] = s1 * mul;
    }
  }
}

// pq = the softmax over one head's 32 features (tiles q[0 .. 3]), in place, per row;
// stabilised by the head's own max (a row-wide max underflows a whole head to 0/0).
__device__ __forceinline__ void head_softmax4(float (&q)[4][4]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) mx = fmaxf(mx, fmaxf(q[nt][2 * half], q[nt][2 * half + 1]));
    mx = quad_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float e = expf(q[nt][2 * half + c] - mx);
        q[nt][2 * half + c] = e;
        sum += e;
      }
    sum = quad_sum(sum);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) q[nt][2 * half + c] /= sum;
  }
}

// Shared memory of the stats passes: the subtile walk's, then for the context pass each
// warp's ke and v (rounded, [16][32 + 8]).
template <typename T, int NC>
struct StatsSmem {
  static constexpr int kLdk = kDimHead + 8;
  static constexpr size_t kv = SubtileSmem<T, NC>::bytes;
  static constexpr size_t kv_warp = al16(2 * kSub * kLdk * sizeof(T));
  static constexpr size_t kmax_bytes = kv;
  static constexpr size_t kmax_s = kv + kHeads * kv_warp;  // the row's merged k max
  static constexpr size_t ctx_bytes = kmax_s + kHD * sizeof(float);
};

// acc[j] += xn W for head h's 32 columns of the projection part `part` (0 q, 1 k, 2 v).
template <typename T, int NC>
__device__ __forceinline__ void head_projection(float (&acc)[4][4], const T* xn,
                                                const T* w_qkv, int part, int h) {
  constexpr int C = NC * 32;
  product<T, 4, C>(
      acc, [&](auto& a, int k0) { load_a_mk(a, xn, C + 8, k0); },
      [&](auto& b, int j, int k0) { load_b_frag(b, w_qkv, C, 16 * part + 4 * h + j, k0); });
}

// (2) The k max of every block's chunk: RMSNorm, then warp h's k = xn Wk for head h on the
// tensor cores, the max of each of its 32 features over the chunk's tokens into
// part_kmax[block].
template <typename Dir, typename T, int NC>
__global__ void __launch_bounds__(kHeads * 32)
kmax_kernel(const T* __restrict__ x, const float* __restrict__ g0, const T* __restrict__ w_qkv,
            float* __restrict__ part_kmax, int n, int S, int chunk) {
  pdl_enter();
  constexpr int C = NC * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Chunk ck(n, S, chunk);
  const size_t tok0 = static_cast<size_t>(ck.row) * n;
  float mx[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) mx[j][0] = mx[j][1] = -INFINITY;
  walk_subtiles<T, NC, true>(x + tok0 * C, ck, g0, smem, static_cast<T*>(nullptr), tok0,
                             NoFetch(), [&](const T* xn, const T*, int, int) {
    float k[4][4];
    zero(k);
    head_projection<T, NC>(k, xn, w_qkv, 1, h);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mx[j][0] = fmaxf(mx[j][0], fmaxf(k[j][0], k[j][2]));
      mx[j][1] = fmaxf(mx[j][1], fmaxf(k[j][1], k[j][3]));
    }
  });
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float m0 = col_max(mx[j][0]), m1 = col_max(mx[j][1]);
    if (lane < 4) {
      float* out = part_kmax + static_cast<size_t>(blockIdx.x) * kHD + h * kDimHead + 8 * j;
      out[2 * lane] = m0;
      out[2 * lane + 1] = m1;
    }
  }
}

// u[i] = head h's element i of the sum over the row's S block partials of a lane-private
// [4][32][32] block, in block order (see frag_row), for this lane.
__device__ __forceinline__ void sum_partials(const float* part_row, int S, int h, float (&u)[32]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 32; ++i) u[i] = 0.f;
#pragma unroll
  for (int s = 0; s < kMaxChunks; ++s) {
    if (s >= S) break;
    const float* p = part_row + static_cast<size_t>(s) * kCtx + h * 32 * 32 + lane;
#pragma unroll
    for (int i = 0; i < 32; ++i) u[i] += p[i * 32];
  }
}

// Where a row's merged context goes: Cc rounded to T in fragment order per head, as the B
// of a = qs Cc (ctx_a) and of dqs = da Ccᵀ (ctx_dq); for the backward also C in f32, z and
// kmax.
template <typename T>
struct CtxOut {
  T *ctx_a, *ctx_dq;
  float *c32, *z, *kmax;
};

// (4) One head of a row's context, a warp a block, grid (b, 4): kmax and z merged (z = the
// blocks' sums, then the memory tokens'), U = the blocks' keᵀ v, then + meᵀ memv of the
// memory tokens on the tensor cores (me = exp(memk - kmax) and memv rounded to T, the memory
// axis zero-padded to the mma's k), C = U / z (the forward multiplies by 1 / z, as the
// reference does), into out.
template <typename Dir, typename T>
__global__ void __launch_bounds__(32)
context_merge_kernel(const float* __restrict__ mem_kv, const float* __restrict__ part_kmax,
                     const float* __restrict__ part_z, const float* __restrict__ part_ctx, int m,
                     int S, CtxOut<T> out) {
  pdl_enter();
  __shared__ float kmax_s[kDimHead], z_s[kDimHead];
  const int row = blockIdx.x, h = blockIdx.y, lane = threadIdx.x;
  {
    const int col = h * kDimHead + lane;
    const float k = merged_kmax(part_kmax + static_cast<size_t>(row) * S * kHD, S, mem_kv, m, col);
    float z = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxChunks; ++s)
      if (s < S) z += part_z[(static_cast<size_t>(row) * S + s) * kHD + col];
    float mz = 0.f;
    for (int j = 0; j < m; ++j) mz += expf(mem_kv[col * m + j] - k);
    kmax_s[lane] = k;
    z_s[lane] = z + mz;
    if (out.kmax != nullptr) {
      out.kmax[static_cast<size_t>(row) * kHD + col] = k;
      out.z[static_cast<size_t>(row) * kHD + col] = z + mz;
    }
  }
  float u[32];
  sum_partials(part_ctx + static_cast<size_t>(row) * S * kCtx, S, h, u);
  __syncwarp();

  const float* memk = mem_kv + static_cast<size_t>(h) * kDimHead * m;         // [d][j]
  const float* memv = mem_kv + static_cast<size_t>(kHD + h * kDimHead) * m;   // [e][j]
  const float* kmx = kmax_s;
  float mu[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) zero(mu[mt]);
  for (int j0 = 0; j0 < m; j0 += Frag<T>::kK) {
    typename Frag<T>::A a[2];
    typename Frag<T>::B b[4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      make_a(a[mt], [&](int r, int k) {
        const int d = 16 * mt + r, j = j0 + k;
        return j < m ? rnd<T>(expf(memk[d * m + j] - kmx[d])) : 0.f;
      });
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      make_b(b[nt], [&](int k, int c) {
        const int j = j0 + k;
        return j < m ? rnd<T>(memv[(8 * nt + c) * m + j]) : 0.f;
      });
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma(mu[mt][nt], a[mt], b[nt]);
  }

  const size_t base = static_cast<size_t>(row) * kCtx + h * kDimHead * kDimHead;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int d = frag_row(i), e = frag_col(i);
    const float U = u[i] + mu[i >> 4][(i >> 2) & 3][i & 3];
    const float zz = z_s[d];
    const float C = Dir::kForward ? U * (1.f / zz) : U / zz;
    const T cv = from_f<T>(C);
    out.ctx_a[base + frag_off<T>(d, e, kDimHead)] = cv;
    if (out.ctx_dq != nullptr) out.ctx_dq[base + frag_off<T>(e, d, kDimHead)] = cv;
    if (out.c32 != nullptr) out.c32[base + d * kDimHead + e] = C;
  }
}

// (3) The context partials of every block's chunk: the k max merged over the row (memory
// tokens included), RMSNorm, then per warp h: k and v = xn Wkv for head h on the tensor
// cores, ke = exp(k - kmax) (f32), its sum z, and U = keᵀ v with ke and v rounded to T, in
// registers; into part_z[block] and part_ctx[block] (lane-private order, see frag_row).
// Writes xn (T) to xn_out if given.
template <typename Dir, typename T, int NC>
__global__ void __launch_bounds__(kHeads * 32)
context_kernel(const T* __restrict__ x, const float* __restrict__ g0,
               const T* __restrict__ w_qkv, const float* __restrict__ mem_kv,
               const float* __restrict__ part_kmax, T* __restrict__ xn_out,
               float* __restrict__ part_z, float* __restrict__ part_ctx, int n, int m, int S,
               int chunk) {
  pdl_enter();
  using L = StatsSmem<T, NC>;
  constexpr int C = NC * 32, kLdk = L::kLdk;
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane_g(), t = lane_t();
  T* ke_s = reinterpret_cast<T*>(smem + L::kv + h * L::kv_warp);
  T* v_s = ke_s + kSub * kLdk;
  const Chunk ck(n, S, chunk);
  const size_t tok0 = static_cast<size_t>(ck.row) * n;
  float* kmax_s = reinterpret_cast<float*>(smem + L::kmax_s);
  kmax_s[threadIdx.x] =
      merged_kmax(part_kmax + static_cast<size_t>(ck.row) * S * kHD, S, mem_kv, m, threadIdx.x);
  __syncthreads();
  float km[4][2], z[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      km[j][c] = kmax_s[h * kDimHead + 8 * j + 2 * t + c];
      z[j][c] = 0.f;
    }
  float u[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) zero(u[mt]);

  walk_subtiles<T, NC, true>(x + tok0 * C, ck, g0, smem, xn_out, tok0, NoFetch(),
                             [&](const T* xn, const T*, int, int) {
    float acc[4][4];
    zero(acc);
    head_projection<T, NC>(acc, xn, w_qkv, 1, h);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float e0 = expf(acc[j][0] - km[j][0]), e1 = expf(acc[j][1] - km[j][1]);
      const float e2 = expf(acc[j][2] - km[j][0]), e3 = expf(acc[j][3] - km[j][1]);
      z[j][0] += e0 + e2;
      z[j][1] += e1 + e3;
      store_pair(ke_s + g * kLdk + 8 * j + 2 * t, e0, e1);
      store_pair(ke_s + (g + 8) * kLdk + 8 * j + 2 * t, e2, e3);
    }
    zero(acc);
    head_projection<T, NC>(acc, xn, w_qkv, 2, h);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      store_pair(v_s + g * kLdk + 8 * j + 2 * t, acc[j][0], acc[j][1]);
      store_pair(v_s + (g + 8) * kLdk + 8 * j + 2 * t, acc[j][2], acc[j][3]);
    }
    __syncwarp();
#pragma unroll
    for (int k0 = 0; k0 < kSub; k0 += Frag<T>::kK) {
      typename Frag<T>::A a0, a1;
      typename Frag<T>::B b[4];
      load_a_km(a0, ke_s, kLdk, 0, k0);
      load_a_km(a1, ke_s, kLdk, 16, k0);
      load_b_kn2(b[0], b[1], v_s, kLdk, 0, k0);
      load_b_kn2(b[2], b[3], v_s, kLdk, 16, k0);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        mma(u[0][nt], a0, b[nt]);
        mma(u[1][nt], a1, b[nt]);
      }
    }
    __syncwarp();  // ke_s and v_s are rewritten for the next subtile
  });
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float s0 = col_sum(z[j][0]), s1 = col_sum(z[j][1]);
    if (lane < 4) {
      float* out = part_z + static_cast<size_t>(blockIdx.x) * kHD + h * kDimHead + 8 * j;
      out[2 * lane] = s0;
      out[2 * lane + 1] = s1;
    }
  }
  float* out = part_ctx + static_cast<size_t>(blockIdx.x) * kCtx + h * 32 * 32 + lane;
#pragma unroll
  for (int i = 0; i < 32; ++i) out[i * 32] = u[i >> 4][(i >> 2) & 3][i & 3];
}

// Workspace arrays: one device buffer cut into 256-byte aligned pieces.
struct Carve {
  size_t at = 0;
  size_t take(size_t bytes) {
    const size_t here = at;
    at += (bytes + 255) / 256 * 256;
    return here;
  }
};

// Lets `kernel` take `smem` bytes of dynamic shared memory on the current device. The
// attribute is set once per kernel and device (and again only for more bytes), not at every
// launch: a DDIM-50 batch makes 1,500 launches of the forward's kernels.
template <typename... Params>
cudaError_t allow_smem(void (*kernel)(Params...), size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;  // the default limit
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, size_t> allowed;
  const std::lock_guard<std::mutex> lock(mu);
  size_t& bytes = allowed[{reinterpret_cast<const void*>(kernel), device}];
  if (smem <= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess) bytes = smem;
  return err;
}

// Launch on `stream` with Hopper's programmatic dependent launch: the kernel may be scheduled
// while its predecessor on the stream finishes, and waits in pdl_enter until that one is
// done and its writes are visible. Saves a launch's latency between the passes.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem,
                   cudaStream_t stream, Args... args) {
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

#define LGM_TRY(expr)                 \
  do {                                \
    const cudaError_t e_ = (expr);    \
    if (e_ != cudaSuccess) return e_; \
  } while (0)

// The shared launches of both directions: prep, the k max, the context partials (xn to
// xn_out when given) and their merge.
template <typename Dir, typename T, int NC>
cudaError_t launch_context(const Plan& P, const T* x, const float* g0, const float* wqkv,
                           const float* mem_kv, const float* wo, T* w_qkv, T* w_y, T* w_dxn,
                           T* w_da, float* part_kmax, float* part_z, float* part_ctx, T* xn_out,
                           const CtxOut<T>& merged, int b, int n, int m,
                           cudaStream_t stream) {
  constexpr int C = NC * 32;
  using L = StatsSmem<T, NC>;
  const int total = C * kQKV + kHD * C;
  LGM_TRY(launch(prep_weights_kernel<Dir, T>, (total + 255) / 256, 256, 0, stream, wqkv, wo, C,
                 w_qkv, w_y, w_dxn, w_da));
  LGM_TRY(launch(kmax_kernel<Dir, T, NC>, P.blocks, kHeads * 32, L::kmax_bytes, stream, x, g0,
                 w_qkv, part_kmax, n, P.S, P.chunk));
  LGM_TRY(launch(context_kernel<Dir, T, NC>, P.blocks, kHeads * 32, L::ctx_bytes, stream, x, g0,
                 w_qkv, mem_kv, part_kmax, xn_out, part_z, part_ctx, n, m, P.S, P.chunk));
  return launch(context_merge_kernel<Dir, T>, dim3(b, kHeads), 32, 0, stream, mem_kv, part_kmax,
                part_z, part_ctx, m, P.S, merged);
}

}  // namespace
