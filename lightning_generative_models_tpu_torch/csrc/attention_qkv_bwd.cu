// Multi-head softmax attention backward, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel lightning_generative_models_tpu/ops/attention.py:
// _vmem_attn_bwd_kernel (launched through _vmem_attention_bwd_impl). Same math, recomputed
// from q, k, v (cast to f32) and the output's cotangent g:
//
//   P  = softmax(q k^T * scale)           dV = P^T g
//   dP = g V^T                            dS = P * (dP - rowsum(P * dP))
//   dQ = dS K * scale                     dK = dS^T Q * scale
//
// every product and the softmax in f32, written in the operands' type at q's, k's and v's
// strides (the packed dqkv for the packed call; [b, h, n, d] views for the flash path's
// backward route, n_q and n_kv free). rowsum(P * dP) is summed from P and dP in f32, as
// JAX's jnp.sum(p * dp), not from a rounded output.
//
// What bounds it on an H100 SXM: the five [n, n] x d products, ~10 b h n^2 d flops
// (989 TFLOP/s bf16 on the tensor cores), against qkv and g read once and dqkv written
// once (3.35 TB/s). At DiT-S/2 (b 128, n 256, h 6, d 64, bf16) that is 32.2 GFLOP (33 us)
// and 176 MB (53 us): bound by bytes.
//
// Design. The TPU program holds a batch row's [n, n] scores in VMEM and writes each head's
// dq, dk and dv at once. Here blocks run in parallel and in no order, and no float atomics
// are used, so every output element has one writer and repeats are bit for bit. Two
// launches on a 1-D grid, each block four warps of 16 rows, a (b*h row)'s tiles adjacent:
//  (1) per 64-query tile: a statistics pass over the key tiles (S and dP) gives each
//      row's max m, 1 / sum l and delta = rowsum(P * dP), accumulated online as the
//      softmax's sum is, into a [3, b*h, n_q rounded up to 64] f32 scratch; then a dQ pass
//      forms dS = P * (dP - delta) and accumulates dQ = dS K.
//  (2) per 64-key tile: a loop over the query tiles recomputes S^T and dP^T (rows: this
//      block's keys), P^T and dS^T from the stored statistics, and accumulates
//      dV = P^T g and dK = dS^T Q.
// That is nine tile products per (query tile, key tile) pair: S and dP three times, dQ,
// dV and dK once. Seven would do in one launch with a block per (b*h row) that keeps dQ of
// all its queries in shared memory, and five with the forward's statistics; nine are
// kept because every product then has its A operand in the warp's own registers (S and
// dP come out of an mma in the accumulator layout, which is the A layout of the next
// product over the same columns: dS for dQ in (1), P^T and dS^T for dV and dK in (2)), so
// no P or dS tile passes through shared memory, no warp waits for another inside a tile,
// no cross-warp sum is needed, any n_q and n_kv is one design, and the grid has
// ceil(n / 64) b h blocks a launch at every shape. The forward writes no statistics (the
// flash route's forward, kernel #5, has none to give), so the entry works from
// (q, k, v, g) alone.
//
// The building blocks are the forward's (attention_qkv_common.cuh): tiles in the operands'
// type filled by cp.async into a ring of two stages, so that the next tile's copy overlaps
// this tile's products; S and dP from exact bf16 operands on mma.m16n8k16 (ldmatrix
// fragments), or 3xTF32 in f32; P, dS, P^T and dS^T split (bf16 hi + lo, or TF32 hi + lo)
// in the registers of the warp that made them.

#include "attention_qkv_common.cuh"

namespace {

using namespace attn;

constexpr int kTile = 64;     // rows of a block, rows of a streamed tile
constexpr int kStages = 2;    // the ring of streamed tiles
constexpr int kThreads = 128;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* g;
  void* dq;
  void* dk;
  void* dv;
  float* stats;  // [3][b * heads][n_pad]: m, 1 / l, delta
  Strides sq, sk, sv, sg;
  int heads, n_q, n_kv, d;
  float scale;
};

// Two [64][ld] tiles of the block's own rows, and kStages pairs of streamed ones.
template <typename T>
size_t tiles_smem(int d) {
  return sizeof(T) * tile_ld<T>(d) * (2 * kTile + kStages * 2 * kTile);
}

// (1) Row statistics and dQ for one query tile.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) attention_bwd_query_kernel(BwdArgs a) {
  constexpr int kNT = DMAX / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d = a.d, ld = tile_ld<T>(d);
  T* q_s = reinterpret_cast<T*>(smem_raw);  // [64][ld]
  T* g_s = q_s + kTile * ld;                // [64][ld]
  T* kv_s = g_s + kTile * ld;               // kStages x {k [64][ld], v [64][ld]}
  const int q_tiles = (a.n_q + kTile - 1) / kTile;
  const int row = blockIdx.x / q_tiles;  // b * heads + h
  const int b = row / a.heads, h = row - b * a.heads;
  const int q0 = (blockIdx.x - row * q_tiles) * kTile;
  const int r0 = 16 * (threadIdx.x >> 5), g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;

  const T* k = head_ptr<T>(a.k, a.sk, b, h);
  const T* v = head_ptr<T>(a.v, a.sv, b, h);
  const int n_tiles = (a.n_kv + kTile - 1) / kTile;
  const auto load_kv = [&](int tile, int stage) {
    T* k_dst = kv_s + stage * 2 * kTile * ld;
    load_tile_async<T, kTile, DMAX, kThreads>(k_dst, ld, k, a.sk.token, tile * kTile,
                                              a.n_kv, d);
    load_tile_async<T, kTile, DMAX, kThreads>(k_dst + kTile * ld, ld, v, a.sv.token,
                                              tile * kTile, a.n_kv, d);
  };
  zero_k_padding(q_s, 2 * kTile + kStages * 2 * kTile, ld, d);
  load_tile_async<T, kTile, DMAX, kThreads>(q_s, ld, head_ptr<T>(a.q, a.sq, b, h),
                                            a.sq.token, q0, a.n_q, d);
  load_tile_async<T, kTile, DMAX, kThreads>(g_s, ld, head_ptr<T>(a.g, a.sg, b, h),
                                            a.sg.token, q0, a.n_q, d);
  load_kv(0, 0);
  cp_async_commit();

  // Rows g (i = 0) and g + 8 (i = 1) of the warp's 16. Pass 0: the running max, and this
  // lane's shares of the running sum and of sum(p * dP); pass 1: m, 1 / l and delta.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, pdp[2] = {0.f, 0.f};
  float inv_l[2], delta[2];
  float dq[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  for (int it = 0; it < 2 * n_tiles; ++it) {
    const int pass = it >= n_tiles, tile = it - pass * n_tiles;
    if (it + 1 < 2 * n_tiles) load_kv((it + 1) % n_tiles, (it + 1) % kStages);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* k_s = kv_s + (it % kStages) * 2 * kTile * ld;
    const T* v_s = k_s + kTile * ld;
    const int k0 = tile * kTile;

    float s[8][4], dp[8][4];
    rows_dot_rows<DMAX>(s, q_s, k_s, ld, r0, d);
    rows_dot_rows<DMAX>(dp, g_s, v_s, ld, r0, d);
    const bool ragged = k0 + kTile > a.n_kv;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[j][c] *= a.scale;
        if (ragged && k0 + 8 * j + 2 * t + (c & 1) >= a.n_kv) s[j][c] = -INFINITY;
      }

    if (!pass) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
        const float m_new = fmaxf(m[i], quad_max(mx));
        const float alpha = expf(m[i] - m_new);
        float sum = 0.f, dot = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 2 * i; c < 2 * i + 2; ++c) {
            const float p = expf(s[j][c] - m_new);  // 0 for a masked key
            sum += p;
            dot = fmaf(p, dp[j][c], dot);
          }
        l[i] = l[i] * alpha + sum;
        pdp[i] = pdp[i] * alpha + dot;
        m[i] = m_new;
      }
      if (tile == n_tiles - 1) {
        const size_t plane = static_cast<size_t>(gridDim.x / q_tiles) * q_tiles * kTile;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float sum = quad_sum(l[i]), dot = quad_sum(pdp[i]);
          inv_l[i] = 1.f / sum;
          delta[i] = dot * inv_l[i];
          // Rows past n_q store m = 1 / l = delta = 0: the key launch's P and dS of those
          // (zero-filled) queries are then exactly 0.
          const int r = q0 + r0 + g + 8 * i;
          if (t == 0) {
            const bool valid = r < a.n_q;
            const size_t at = static_cast<size_t>(row) * q_tiles * kTile + r;
            a.stats[at] = valid ? m[i] : 0.f;
            a.stats[plane + at] = valid ? inv_l[i] : 0.f;
            a.stats[2 * plane + at] = valid ? delta[i] : 0.f;
          }
        }
      }
    } else {
      // dS = P * (dP - delta) in place of dp; dQ += dS K.
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = c >> 1;
          dp[j][c] = expf(s[j][c] - m[i]) * inv_l[i] * (dp[j][c] - delta[i]);
        }
      acc_times_tile(dq, dp, k_s, ld, d);
    }
    __syncthreads();  // this stage's readers are done before the copy of tile it + 2
  }
  store_acc_rows(head_ptr<T>(a.dq, a.sq, b, h), a.sq.token, q0 + r0, a.n_q, d, dq, a.scale,
                 a.scale);
}

// (2) dK and dV for one key tile.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) attention_bwd_key_kernel(BwdArgs a) {
  constexpr int kNT = DMAX / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d = a.d, ld = tile_ld<T>(d);
  T* k_s = reinterpret_cast<T*>(smem_raw);  // [64][ld]
  T* v_s = k_s + kTile * ld;                // [64][ld]
  T* qg_s = v_s + kTile * ld;               // kStages x {q [64][ld], g [64][ld]}
  float* st_s = reinterpret_cast<float*>(qg_s + kStages * 2 * kTile * ld);  // kStages x [3][64]
  const int q_tiles = (a.n_q + kTile - 1) / kTile;
  const int k_tiles = (a.n_kv + kTile - 1) / kTile;
  const int row = blockIdx.x / k_tiles;  // b * heads + h
  const int b = row / a.heads, h = row - b * a.heads;
  const int k0 = (blockIdx.x - row * k_tiles) * kTile;
  const int r0 = 16 * (threadIdx.x >> 5), t = threadIdx.x & 3;

  const T* q = head_ptr<T>(a.q, a.sq, b, h);
  const T* g = head_ptr<T>(a.g, a.sg, b, h);
  const size_t plane = static_cast<size_t>(gridDim.x / k_tiles) * q_tiles * kTile;
  const float* stats = a.stats + static_cast<size_t>(row) * q_tiles * kTile;
  const auto load_qg = [&](int tile, int stage) {
    T* q_dst = qg_s + stage * 2 * kTile * ld;
    load_tile_async<T, kTile, DMAX, kThreads>(q_dst, ld, q, a.sq.token, tile * kTile,
                                              a.n_q, d);
    load_tile_async<T, kTile, DMAX, kThreads>(q_dst + kTile * ld, ld, g, a.sg.token,
                                              tile * kTile, a.n_q, d);
    if (threadIdx.x < 3 * kTile / 4) {  // m, 1 / l, delta: 16 chunks of 4 floats each
      const int p = threadIdx.x / (kTile / 4), c = threadIdx.x % (kTile / 4);
      cp_async16(st_s + (stage * 3 + p) * kTile + 4 * c,
                 stats + p * plane + tile * kTile + 4 * c, true);
    }
  };
  zero_k_padding(k_s, 2 * kTile + kStages * 2 * kTile, ld, d);
  load_tile_async<T, kTile, DMAX, kThreads>(k_s, ld, head_ptr<T>(a.k, a.sk, b, h),
                                            a.sk.token, k0, a.n_kv, d);
  load_tile_async<T, kTile, DMAX, kThreads>(v_s, ld, head_ptr<T>(a.v, a.sv, b, h),
                                            a.sv.token, k0, a.n_kv, d);
  load_qg(0, 0);
  cp_async_commit();

  float dk[kNT][4], dv[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[j][c] = dv[j][c] = 0.f;

  for (int it = 0; it < q_tiles; ++it) {
    if (it + 1 < q_tiles) load_qg(it + 1, (it + 1) % kStages);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* q_s = qg_s + (it % kStages) * 2 * kTile * ld;
    const T* g_s = q_s + kTile * ld;
    const float* m_s = st_s + (it % kStages) * 3 * kTile;
    const float* il_s = m_s + kTile;
    const float* dl_s = il_s + kTile;

    // Transposed tiles: rows are this warp's keys, columns the tile's queries. Queries
    // past n_q were zero-filled and carry zero statistics, so their P and dS are 0.
    float st[8][4], dpt[8][4];
    rows_dot_rows<DMAX>(st, k_s, q_s, ld, r0, d);
    rows_dot_rows<DMAX>(dpt, v_s, g_s, ld, r0, d);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int qc = 8 * j + 2 * t;
      const float2 mq = *reinterpret_cast<const float2*>(m_s + qc);
      const float2 il = *reinterpret_cast<const float2*>(il_s + qc);
      const float2 dl = *reinterpret_cast<const float2*>(dl_s + qc);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool odd = c & 1;
        const float p = expf(st[j][c] * a.scale - (odd ? mq.y : mq.x)) * (odd ? il.y : il.x);
        st[j][c] = p;
        dpt[j][c] = p * (dpt[j][c] - (odd ? dl.y : dl.x));
      }
    }
    acc_times_tile(dv, st, g_s, ld, d);
    acc_times_tile(dk, dpt, q_s, ld, d);
    __syncthreads();  // this stage's readers are done before the copy of tile it + 2
  }
  store_acc_rows(head_ptr<T>(a.dk, a.sk, b, h), a.sk.token, k0 + r0, a.n_kv, d, dk, a.scale,
                 a.scale);
  store_acc_rows(head_ptr<T>(a.dv, a.sv, b, h), a.sv.token, k0 + r0, a.n_kv, d, dv, 1.f, 1.f);
}

template <typename T, int DMAX>
cudaError_t launch(const BwdArgs& a, int rows, cudaStream_t stream) {
  const size_t smem1 = tiles_smem<T>(a.d);
  const size_t smem2 = smem1 + sizeof(float) * kStages * 3 * kTile;
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_query_kernel<T, DMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem1));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attention_bwd_key_kernel<T, DMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem2));
  if (err != cudaSuccess) return err;
  const int blocks1 = rows * ((a.n_q + kTile - 1) / kTile);
  attention_bwd_query_kernel<T, DMAX><<<blocks1, kThreads, smem1, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int blocks2 = rows * ((a.n_kv + kTile - 1) / kTile);
  attention_bwd_key_kernel<T, DMAX><<<blocks2, kThreads, smem2, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for_width(const BwdArgs& a, int rows, cudaStream_t stream) {
  if (a.d <= 32) return launch<T, 32>(a, rows, stream);
  if (a.d <= 64) return launch<T, 64>(a, rows, stream);
  return launch<T, 128>(a, rows, stream);
}

}  // namespace

// q, k, v, g: head 0 of batch row 0 of each operand; dq, dk, dv are written at q's, k's and
// v's strides. stats: a [3, b, heads, ceil(n_q / 64) * 64] f32 scratch buffer, 16-byte
// aligned. strides: 12 int64, the (batch, token, head) strides of q, k, v and g in
// elements; q, k, v and g 16-byte aligned with token strides of a multiple of 16 bytes;
// dq, dk, dv aligned to two elements. Elements are bf16 when bf16 is non-zero, else f32;
// d a multiple of 8 up to 128; b * heads * ceil(n / 64) blocks at most 2^31 - 1. Returns
// a cudaError_t (0: launched).
extern "C" int lgm_attention_qkv_bwd(const void* q, const void* k, const void* v,
                                     const void* g, void* dq, void* dk, void* dv, void* stats,
                                     const void* strides, int b, int heads, int n_q, int n_kv,
                                     int d, int bf16, float scale, void* stream) {
  const long long tiles = (static_cast<long long>(n_q > n_kv ? n_q : n_kv) + kTile - 1) / kTile;
  if (!valid_shape(b, heads, n_q, n_kv, d) ||
      static_cast<long long>(b) * heads * tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* s = static_cast<const long long*>(strides);
  const BwdArgs a{q, k, v, g, dq, dk, dv, static_cast<float*>(stats),
                  {s[0], s[1], s[2]}, {s[3], s[4], s[5]}, {s[6], s[7], s[8]}, {s[9], s[10], s[11]},
                  heads, n_q, n_kv, d, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 != 0 ? launch_for_width<__nv_bfloat16>(a, b * heads, st)
                                    : launch_for_width<float>(a, b * heads, st));
}

extern "C" const char* lgm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
