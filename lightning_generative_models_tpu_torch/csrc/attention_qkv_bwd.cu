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
// written in the operands' type at q's, k's and v's strides (the packed dqkv for the
// packed call). rowsum(P * dP) is taken as g . o, the same sum regrouped.
//
// What bounds it on an H100 SXM: the five [n, n] x d products, ~10 b h n^2 d flops, against
// qkv and g read once and dqkv written once. At DiT-S/2 (b 128, n 256, h 6, d 64, bf16)
// that is 32.2 GFLOP (33 us at the tensor-core peak) and 176 MB (53 us): bound by bytes.
//
// Design. The TPU program holds a batch row's [n, n] scores in VMEM and writes each head's
// dq, dk and dv at once. Here blocks run in parallel and in no order, and no float atomics
// are used, so every output element has one writer and repeats are bit for bit. Two
// launches:
//  (1) per (64-query tile, head, batch row): the forward's online softmax over the key
//      tiles gives each row's max m, sum l and output o; delta = g . o; m, l and delta go
//      to a [3, b, h, n] f32 scratch buffer; a second pass over the key tiles forms
//      dS = P * (g V^T - delta) and accumulates dQ = dS K.
//  (2) per (64-key tile, head, batch row): a loop over the query tiles recomputes P^T and
//      dS^T from the stored m, l and delta and accumulates dV = P^T g and dK = dS^T Q.
// Products are f32 FMA loops on the CUDA cores, nine [64, 64] x d products per tile pair
// where five would do with the forward's statistics kept: right and simple first, far from
// the bound. Tensor cores, TMA and pipelining are later work.

#include "attention_qkv_common.cuh"

namespace {

using namespace attn;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* g;
  void* dq;
  void* dk;
  void* dv;
  float* stats;  // [3][b][heads][n_q]: m, l, delta
  Strides sq, sk, sv, sg;
  int heads, n_q, n_kv, d;
  float scale;
};

size_t query_smem(int d) { return sizeof(float) * (4 * kTile * (d + 1) + kTile * kLdP); }
size_t key_smem(int d) {
  return sizeof(float) * (4 * kTile * (d + 1) + 2 * kTile * kLdP + 3 * kTile);
}

// (1) Row statistics and dQ for one query tile.
template <typename T, int NCOL>
__global__ void __launch_bounds__(kThreads) attention_bwd_query_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  const int d = a.d, ld = d + 1;
  float* q_s = smem;              // [64][ld]: q * scale
  float* g_s = q_s + kTile * ld;  // [64][ld]
  float* k_s = g_s + kTile * ld;  // [64][ld]
  float* v_s = k_s + kTile * ld;  // [64][ld]
  float* p_s = v_s + kTile * ld;  // [64][kLdP]: exp(s - m), then dS
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const T* k = head_ptr<T>(a.k, a.sk, b, h);
  const T* v = head_ptr<T>(a.v, a.sv, b, h);
  load_tile(q_s, ld, head_ptr<T>(a.q, a.sq, b, h), a.sq.token, q0, a.n_q, d, a.scale);
  load_tile(g_s, ld, head_ptr<T>(a.g, a.sg, b, h), a.sg.token, q0, a.n_q, d, 1.f);

  // The forward again: the running max m and sum l of each row, and o * l.
  float m[4], l[4], acc[4][NCOL];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) acc[i][c] = 0.f;
  }
  for (int k0 = 0; k0 < a.n_kv; k0 += kTile) {
    __syncthreads();
    load_tile(k_s, ld, k, a.sk.token, k0, a.n_kv, d, 1.f);
    load_tile(v_s, ld, v, a.sv.token, k0, a.n_kv, d, 1.f);
    __syncthreads();
    float s[4][4];
    tile_dots(s, q_s, k_s, ld, d);
    mask_keys(s, k0, a.n_kv);
    online_softmax_tile(s, m, l, acc, p_s);
    __syncthreads();
    tile_matmul(acc, p_s, v_s, ld, d);
  }

  // delta = g . o for each row, stored with m and l.
  float delta[4];
  const size_t plane = static_cast<size_t>(gridDim.z) * a.heads * a.n_q;
  const size_t row_base = (static_cast<size_t>(b) * a.heads + h) * a.n_q;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    float part = 0.f;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) {
      const int col = tx + 16 * c;
      if (c < NCOL - 1 || col < d) part = fmaf(g_s[r * ld + col], acc[i][c] / l[i], part);
    }
    delta[i] = row_sum(part);
    const int row = q0 + r;
    if (tx == 0 && row < a.n_q) {
      a.stats[row_base + row] = m[i];
      a.stats[plane + row_base + row] = l[i];
      a.stats[2 * plane + row_base + row] = delta[i];
    }
  }

  // dQ = dS K, dS = P * (g V^T - delta).
  float dq[4][NCOL];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NCOL; ++c) dq[i][c] = 0.f;
  for (int k0 = 0; k0 < a.n_kv; k0 += kTile) {
    __syncthreads();
    load_tile(k_s, ld, k, a.sk.token, k0, a.n_kv, d, 1.f);
    load_tile(v_s, ld, v, a.sv.token, k0, a.n_kv, d, 1.f);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dots(s, q_s, k_s, ld, d);
    tile_dots(dp, g_s, v_s, ld, d);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool valid = k0 + tx + 16 * j < a.n_kv;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = valid ? expf(s[i][j] - m[i]) / l[i] : 0.f;
        p_s[(ty + 16 * i) * kLdP + tx + 16 * j] = p * (dp[i][j] - delta[i]);
      }
    }
    __syncthreads();
    tile_matmul(dq, p_s, k_s, ld, d);
  }
  const float scale[4] = {a.scale, a.scale, a.scale, a.scale};
  store_rows(head_ptr<T>(a.dq, a.sq, b, h), a.sq.token, q0, a.n_q, d, dq, scale, false);
}

// (2) dK and dV for one key tile.
template <typename T, int NCOL>
__global__ void __launch_bounds__(kThreads) attention_bwd_key_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  const int d = a.d, ld = d + 1;
  float* k_s = smem;                 // [64][ld]
  float* v_s = k_s + kTile * ld;     // [64][ld]
  float* q_s = v_s + kTile * ld;     // [64][ld]: q * scale
  float* g_s = q_s + kTile * ld;     // [64][ld]
  float* pt_s = g_s + kTile * ld;    // [64 keys][kLdP]: P^T
  float* dst_s = pt_s + kTile * kLdP;  // [64 keys][kLdP]: dS^T
  float* m_s = dst_s + kTile * kLdP;   // [64] per query of the tile
  float* l_s = m_s + kTile;
  float* delta_s = l_s + kTile;
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const T* q = head_ptr<T>(a.q, a.sq, b, h);
  const T* g = head_ptr<T>(a.g, a.sg, b, h);
  load_tile(k_s, ld, head_ptr<T>(a.k, a.sk, b, h), a.sk.token, k0, a.n_kv, d, 1.f);
  load_tile(v_s, ld, head_ptr<T>(a.v, a.sv, b, h), a.sv.token, k0, a.n_kv, d, 1.f);
  const size_t plane = static_cast<size_t>(gridDim.z) * a.heads * a.n_q;
  const size_t row_base = (static_cast<size_t>(b) * a.heads + h) * a.n_q;

  float dk[4][NCOL], dv[4][NCOL];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NCOL; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int q0 = 0; q0 < a.n_q; q0 += kTile) {
    __syncthreads();
    load_tile(q_s, ld, q, a.sq.token, q0, a.n_q, d, a.scale);
    load_tile(g_s, ld, g, a.sg.token, q0, a.n_q, d, 1.f);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      const bool valid = row < a.n_q;
      m_s[threadIdx.x] = valid ? a.stats[row_base + row] : 0.f;
      l_s[threadIdx.x] = valid ? a.stats[plane + row_base + row] : 1.f;
      delta_s[threadIdx.x] = valid ? a.stats[2 * plane + row_base + row] : 0.f;
    }
    __syncthreads();
    // Transposed tiles: rows are this block's keys, columns the tile's queries.
    float st[4][4], dpt[4][4];
    tile_dots(st, k_s, q_s, ld, d);
    tile_dots(dpt, v_s, g_s, ld, d);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qi = tx + 16 * j;
      const bool valid = q0 + qi < a.n_q;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = valid ? expf(st[i][j] - m_s[qi]) / l_s[qi] : 0.f;
        pt_s[(ty + 16 * i) * kLdP + qi] = p;
        dst_s[(ty + 16 * i) * kLdP + qi] = p * (dpt[i][j] - delta_s[qi]);
      }
    }
    __syncthreads();
    tile_matmul(dv, pt_s, g_s, ld, d);
    tile_matmul(dk, dst_s, q_s, ld, d);  // q_s holds q * scale: dK = dS^T Q * scale
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows(head_ptr<T>(a.dk, a.sk, b, h), a.sk.token, k0, a.n_kv, d, dk, one, false);
  store_rows(head_ptr<T>(a.dv, a.sv, b, h), a.sv.token, k0, a.n_kv, d, dv, one, false);
}

struct LaunchBwd {
  const BwdArgs& a;
  int b;
  cudaStream_t stream;

  template <typename T, int NCOL>
  cudaError_t operator()() const {
    const size_t smem1 = query_smem(a.d), smem2 = key_smem(a.d);
    cudaError_t err = cudaFuncSetAttribute(attention_bwd_query_kernel<T, NCOL>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem1));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(attention_bwd_key_kernel<T, NCOL>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem2));
    if (err != cudaSuccess) return err;
    const dim3 grid1((a.n_q + kTile - 1) / kTile, a.heads, b);
    attention_bwd_query_kernel<T, NCOL><<<grid1, kThreads, smem1, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const dim3 grid2((a.n_kv + kTile - 1) / kTile, a.heads, b);
    attention_bwd_key_kernel<T, NCOL><<<grid2, kThreads, smem2, stream>>>(a);
    return cudaGetLastError();
  }
};

}  // namespace

// q, k, v, g: head 0 of batch row 0 of each operand; dq, dk, dv are written at q's, k's and
// v's strides. stats: a [3, b, heads, n_q] f32 scratch buffer. strides: 12 int64, the
// (batch, token, head) strides of q, k, v and g in elements. Elements are bf16 when bf16 is
// non-zero, else f32; d a multiple of 8 up to 128. Returns a cudaError_t (0: launched).
extern "C" int lgm_attention_qkv_bwd(const void* q, const void* k, const void* v,
                                     const void* g, void* dq, void* dk, void* dv, void* stats,
                                     const void* strides, int b, int heads, int n_q, int n_kv,
                                     int d, int bf16, float scale, void* stream) {
  if (!valid_shape(b, heads, n_q, n_kv, d)) return static_cast<int>(cudaErrorInvalidValue);
  const long long* s = static_cast<const long long*>(strides);
  const BwdArgs a{q, k, v, g, dq, dk, dv, static_cast<float*>(stats),
                  {s[0], s[1], s[2]}, {s[3], s[4], s[5]}, {s[6], s[7], s[8]}, {s[9], s[10], s[11]},
                  heads, n_q, n_kv, d, scale};
  return static_cast<int>(
      dispatch(bf16 != 0, d, LaunchBwd{a, b, static_cast<cudaStream_t>(stream)}));
}

extern "C" const char* lgm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
