// Fused linear-attention block backward, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel lightning_generative_models_tpu/ops/linear_attention.py:_bwd_kernel
// (launched through _pallas_backward). It recomputes the forward (see linear_attention.cu)
// and returns dx and the f32 gradients of g0, Wqkv, mem_kv, Wo, bo and g1, rounding to the
// compute type T exactly where _bwd_kernel rounds: xn, v, ke, me, memv, context, qs, a,
// dy, da, du and dp. Everything else is f32.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): per token 3072 * c + 49152
// flops (the forward's products again, then dWo, da, dqs, dcontext, dke, dv, dxn and dW,
// per head) against 3 * c * sizeof(T) bytes of activations (x, dout, dx). In bf16 at
// [128, 1024, 64] that is 32.2 GFLOP (32.6 us) against 50 MB (15.0 us): operations bound.
//
// Design. The TPU kernel sums every weight gradient into output blocks that stay resident
// across its sequential grid. CUDA blocks run concurrently and in no order, so nothing is
// summed across blocks here: every cross-block sum is a per-block partial, reduced later in
// a fixed order, and no float atomics are used. Two calls on the same inputs give the same
// bits. The backward is nine launches on one stream:
//  (1) stats, grid (heads, b): per batch row and head, two passes over 32-token tiles. The
//      first recomputes RMSNorm and this head's k and v, keeps k in f32 and v in T in a
//      workspace and takes the per-feature max of k (memory tokens included). The second
//      turns k into ke = exp(k - kmax), sums z and the context U = ke^T v + me^T memv, and
//      writes kmax, z and C = U / z. The forward's context is recomputed rather than saved,
//      because the backward needs kmax and z too, and ke rounded against the final max.
//  (2) token pass A, grid (n / 32, b): q, the per-head softmax, a = qs . C, y = a @ Wo + bo,
//      then dy, da = dy @ Wo^T, dqs = da . C^T and dq. Writes qs, a, da, dy and dq in T for
//      the later passes, and per-tile partials of dbo and dg1.
//  (3) context gradient, grid (heads, b): dC = qs^T da over the row's tokens, du = dC / z,
//      dz = -sum(dC * C) / z; the memory tokens' grads (per-row partials of dmem_kv); then
//      dk = ke * (v . du^T + dz) and dv = ke . du for every token of the row.
//  (4) token pass B, grid (n / 32, b): dxn = dp @ Wqkv^T, the RMSNorm gradient, dx (+ dout
//      with the residual); per-tile partials of dg0.
//  (5, 6) dW = xn^T dp and dWo = a^T dy: a 32 x 32 output tile per block and the b * n
//      tokens split in a fixed number of chunks, one partial per chunk.
//  (7-9) fixed-order sums of the partials: dW, dWo, dbo, dg1, dg0, dmem_kv.
// Products are f32 FMA loops over operands rounded to T, as in the forward. Tensor cores,
// fewer launches and keeping the intermediates out of device memory are later work.

#include "linear_attention_common.cuh"

namespace {

constexpr int kPad = kDimHead + 1;  // row stride of [d][d] tiles in shared memory

__host__ __device__ constexpr size_t align_up(size_t v) { return (v + 255) / 256 * 256; }

// Chunks of the token axis for the weight-gradient products: enough blocks for two per
// SM, never a chunk below one 32-token tile.
int token_splits(int out_tiles, int tokens) {
  const int s = (2 * 132 + out_tiles - 1) / out_tiles;
  return s < tokens / kTile ? s : tokens / kTile;
}

int token_chunk(int splits, int tokens) {
  const int tiles = tokens / kTile;
  return (tiles + splits - 1) / splits * kTile;
}

// Workspace: one device buffer cut into these arrays (each 256-byte aligned).
struct Layout {
  size_t ke, v3, xn, qs, ac, da3, dyc, dpc, kmax, z, ctx, part_bg, part_g0, part_mem,
      part_w, part_wo, total;
  int splits_w, chunk_w, splits_wo, chunk_wo;

  Layout(int b, int n, int c, int m, size_t elt) {
    const size_t tok = static_cast<size_t>(b) * n, tiles = tok / kTile;
    splits_w = token_splits((c / 32) * (kQKV / 32), static_cast<int>(tok));
    chunk_w = token_chunk(splits_w, static_cast<int>(tok));
    splits_wo = token_splits((kHD / 32) * (c / 32), static_cast<int>(tok));
    chunk_wo = token_chunk(splits_wo, static_cast<int>(tok));
    size_t at = 0;
    auto take = [&at](size_t bytes) { const size_t here = at; at += align_up(bytes); return here; };
    ke = take(tok * kHD * 4);
    v3 = take(tok * kHD * elt);
    xn = take(tok * c * elt);
    qs = take(tok * kHD * elt);
    ac = take(tok * kHD * elt);
    da3 = take(tok * kHD * elt);
    dyc = take(tok * c * elt);
    dpc = take(tok * kQKV * elt);
    kmax = take(static_cast<size_t>(b) * kHD * 4);
    z = take(static_cast<size_t>(b) * kHD * 4);
    ctx = take(static_cast<size_t>(b) * kHeads * kDimHead * kDimHead * 4);
    part_bg = take(tiles * 2 * c * 4);
    part_g0 = take(tiles * c * 4);
    part_mem = take(static_cast<size_t>(b) * 2 * kHD * m * 4);
    part_w = take(static_cast<size_t>(splits_w) * c * kQKV * 4);
    part_wo = take(static_cast<size_t>(splits_wo) * kHD * c * 4);
    total = at;
  }
};

// (1) kmax, z and C = (ke^T v + me^T memv) / z for one batch row and one head; k (f32,
// then ke) and v (T) of every token into the workspace, and xn (T) from head 0's block.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
stats_kernel(const T* __restrict__ x, const float* __restrict__ g0,
             const float* __restrict__ wqkv, const float* __restrict__ mem_kv,
             T* __restrict__ xn_out, float* __restrict__ ke, T* __restrict__ v3,
             float* __restrict__ kmax_out, float* __restrict__ z_out,
             float* __restrict__ ctx, int n, int m) {
  constexpr int C = NC * 32;
  const int h = blockIdx.x, bb = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  extern __shared__ float smem[];
  float* w_s = smem;                   // [C][64]: this head's k columns, then its v columns
  float* xn_s = w_s + C * 64;          // [kTile][C]
  float* e_s = xn_s + kTile * C;       // [kTile][32] ke rounded to T
  float* eu_s = e_s + kTile * 32;      // [kTile][32] ke in f32
  float* v_s = eu_s + kTile * 32;      // [kTile][32] v
  float* red_s = v_s + kTile * 32;     // [kWarps][32] per-warp max of k
  float* kmax_s = red_s + kWarps * 32; // [32]
  float* z_s = kmax_s + 32;            // [32]

  for (int i = tid; i < C * 64; i += kThreads) {
    const int r = i >> 6, j = i & 63;
    const int col = (j < 32 ? kHD : 2 * kHD) + h * kDimHead + (j & 31);
    w_s[i] = rnd<T>(wqkv[static_cast<size_t>(r) * kQKV + col]);
  }
  __syncthreads();

  const float* memk = mem_kv + static_cast<size_t>(h) * kDimHead * m;
  const float* memv = mem_kv + static_cast<size_t>(kHeads + h) * kDimHead * m;

  // Pass 1: k and v of every token; each warp's max of k for feature `lane`. The rows of
  // xn_s that a warp writes are the only ones it reads, so a warp barrier suffices.
  float mx = -INFINITY;
  for (int t0 = 0; t0 < n; t0 += kTile) {
    const size_t row0 = static_cast<size_t>(bb) * n + t0;
    __syncwarp();
    rmsnorm_rows<T, NC>(x + row0 * C, g0, xn_s, warp, lane);
    __syncwarp();
    if (h == 0) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int tok = warp * kRows + i;
#pragma unroll
        for (int q = 0; q < NC; ++q)
          xn_out[(row0 + tok) * C + q * 32 + lane] = from_f<T>(xn_s[tok * C + q * 32 + lane]);
      }
    }
    float ka[kRows], va[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) ka[i] = va[i] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < C; ++kk) {
      const float wk = w_s[kk * 64 + lane], wv = w_s[kk * 64 + 32 + lane];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float xv = xn_s[(warp * kRows + i) * C + kk];
        ka[i] += xv * wk;
        va[i] += xv * wv;
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const size_t idx = (row0 + warp * kRows + i) * kHD + h * kDimHead + lane;
      ke[idx] = ka[i];
      v3[idx] = from_f<T>(va[i]);
      mx = fmaxf(mx, ka[i]);
    }
  }
  red_s[warp * 32 + lane] = mx;
  __syncthreads();  // also makes this block's global writes of k and v visible to it
  if (warp == 0) {
    float k = -INFINITY;
    for (int w = 0; w < kWarps; ++w) k = fmaxf(k, red_s[w * 32 + lane]);
    for (int j = 0; j < m; ++j) k = fmaxf(k, memk[lane * m + j]);
    kmax_s[lane] = k;
    kmax_out[static_cast<size_t>(bb) * kHD + h * kDimHead + lane] = k;
  }

  // Pass 2: ke = exp(k - kmax) in place of k; z and U. Thread (dk, e0..e0+3) of U.
  const int dk = tid >> 3, e0 = (tid & 7) * 4;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float zsum = 0.f;
  for (int t0 = 0; t0 < n; t0 += kTile) {
    __syncthreads();  // kmax_s is set; every thread is done with the previous tile
#pragma unroll
    for (int r = 0; r < (kTile * 32) / kThreads; ++r) {
      const int i = tid + r * kThreads, t = i >> 5, f = i & 31;
      const size_t idx = (static_cast<size_t>(bb) * n + t0 + t) * kHD + h * kDimHead + f;
      const float e = expf(ke[idx] - kmax_s[f]);
      ke[idx] = e;
      eu_s[i] = e;
      e_s[i] = rnd<T>(e);
      v_s[i] = to_f(v3[idx]);
    }
    __syncthreads();
    if (warp == 0)
      for (int t = 0; t < kTile; ++t) zsum += eu_s[t * 32 + lane];
#pragma unroll 8
    for (int t = 0; t < kTile; ++t) {
      const float e = e_s[t * 32 + dk];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] += e * v_s[t * 32 + e0 + q];
    }
  }

  // The memory tokens, summed apart and added, as the reference does.
  float macc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j = 0; j < m; ++j) {
    const float e = rnd<T>(expf(memk[dk * m + j] - kmax_s[dk]));
#pragma unroll
    for (int q = 0; q < 4; ++q) macc[q] += e * rnd<T>(memv[(e0 + q) * m + j]);
  }
  if (warp == 0) {
    float mz = 0.f;
    for (int j = 0; j < m; ++j) mz += expf(memk[lane * m + j] - kmax_s[lane]);
    z_s[lane] = zsum + mz;
    z_out[static_cast<size_t>(bb) * kHD + h * kDimHead + lane] = zsum + mz;
  }
  __syncthreads();
  float* out = ctx + ((static_cast<size_t>(bb) * kHeads + h) * kDimHead + dk) * kDimHead + e0;
#pragma unroll
  for (int q = 0; q < 4; ++q) out[q] = (acc[q] + macc[q]) / z_s[dk];
}

// (2) For one 32-token tile: qs, a, y, dy, da, dq; partials of dbo and dg1.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
token_a_kernel(const T* __restrict__ xn, const float* __restrict__ wqkv,
               const float* __restrict__ ctx, const float* __restrict__ wo,
               const float* __restrict__ bo, const float* __restrict__ g1,
               const T* __restrict__ dout, T* __restrict__ qs_out, T* __restrict__ ac_out,
               T* __restrict__ da3_out, T* __restrict__ dyc_out, T* __restrict__ dpc,
               float* __restrict__ part_bg, int n) {
  constexpr int C = NC * 32;
  constexpr int kWCols = C > kHD ? C : kHD;
  const int t0 = blockIdx.x * kTile, bb = blockIdx.y;
  const int tile = bb * gridDim.x + blockIdx.x;
  const size_t row0 = static_cast<size_t>(bb) * n + t0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  extern __shared__ float smem[];
  float* ctx_s = smem;                       // [heads][d][kPad], rounded to T
  float* xn_s = ctx_s + kHeads * kDimHead * kPad;  // [kTile][C]
  float* w_s = xn_s + kTile * C;             // [32][kWCols]: staged rows of a weight
  float* a_s = w_s + 32 * kWCols;            // [kTile][kHD]: qs, then a, then da
  float* dy_s = a_s + kTile * kHD;           // [kTile][C]: dy rounded to T
  float* red_b = dy_s + kTile * C;           // [kWarps][C]
  float* red_g = red_b + kWarps * C;         // [kWarps][C]

  for (int i = tid; i < kHeads * kDimHead * kDimHead; i += kThreads) {
    const int hh = i >> 10, d = (i >> 5) & 31, e = i & 31;
    ctx_s[(hh * kDimHead + d) * kPad + e] =
        rnd<T>(ctx[static_cast<size_t>(bb) * kHeads * kDimHead * kDimHead + i]);
  }
  for (int i = tid; i < kTile * C; i += kThreads) xn_s[i] = to_f(xn[row0 * C + i]);

  // q = xn @ Wq: lane holds feature `lane` of head hh for each of the warp's tokens.
  float qa[kRows][kHeads] = {};
  for (int k0 = 0; k0 < C; k0 += 32) {
    __syncthreads();
    for (int i = tid; i < 32 * kHD; i += kThreads)
      w_s[i] = rnd<T>(wqkv[static_cast<size_t>(k0 + (i >> 7)) * kQKV + (i & 127)]);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < 32; ++kk) {
      float wv[kHeads];
#pragma unroll
      for (int hh = 0; hh < kHeads; ++hh) wv[hh] = w_s[kk * kHD + hh * 32 + lane];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float xv = xn_s[(warp * kRows + i) * C + k0 + kk];
#pragma unroll
        for (int hh = 0; hh < kHeads; ++hh) qa[i][hh] += xv * wv[hh];
      }
    }
  }

  // pq = per-head softmax of q (kept in qa), qs = pq * d^-1/2 rounded.
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int tok = warp * kRows + i;
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) {
      const float mx = warp_max(qa[i][hh]);
      const float e = expf(qa[i][hh] - mx);
      qa[i][hh] = e / warp_sum(e);
      const float qs = rnd<T>(qa[i][hh] * kInvSqrtD);
      a_s[tok * kHD + hh * 32 + lane] = qs;
      qs_out[(row0 + tok) * kHD + hh * 32 + lane] = from_f<T>(qs);
    }
  }
  __syncwarp();

  // a = qs . C (per head), rounded.
  float aa[kRows][kHeads] = {};
#pragma unroll 4
  for (int d = 0; d < kDimHead; ++d) {
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) {
      const float cv = ctx_s[(hh * kDimHead + d) * kPad + lane];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        aa[i][hh] += a_s[(warp * kRows + i) * kHD + hh * 32 + d] * cv;
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int tok = warp * kRows + i;
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) {
      const float a = rnd<T>(aa[i][hh]);
      a_s[tok * kHD + hh * 32 + lane] = a;
      ac_out[(row0 + tok) * kHD + hh * 32 + lane] = from_f<T>(a);
    }
  }
  __syncwarp();

  // y = a @ Wo + bo: lane holds columns q * 32 + lane.
  float ya[kRows][NC] = {};
  for (int k0 = 0; k0 < kHD; k0 += 32) {
    __syncthreads();
    for (int i = tid; i < 32 * C; i += kThreads)
      w_s[i] = rnd<T>(wo[static_cast<size_t>(k0) * C + i]);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < 32; ++kk) {
      float av[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) av[i] = a_s[(warp * kRows + i) * kHD + k0 + kk];
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        const float wv = w_s[kk * C + q * 32 + lane];
#pragma unroll
        for (int i = 0; i < kRows; ++i) ya[i][q] += av[i] * wv;
      }
    }
  }

  // dy through out = y * r1 * g1 * sqrt(c); sums of dy and dout * y * r1 for dbo, dg1.
  const float sqrt_c = sqrtf(static_cast<float>(C));
  float bsum[NC] = {}, gsum[NC] = {};
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int tok = warp * kRows + i;
    float dv[NC], u1[NC];
    float ss = 0.f, su = 0.f;
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      const int col = q * 32 + lane;
      ya[i][q] += bo[col];
      ss += ya[i][q] * ya[i][q];
      dv[q] = to_f(dout[(row0 + tok) * C + col]);
      u1[q] = dv[q] * (g1[col] * sqrt_c);
      su += u1[q] * ya[i][q];
    }
    const float r1 = rsqrtf(warp_sum(ss) + kEps);
    const float s1 = warp_sum(su);
    const float r13 = r1 * r1 * r1;
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      const int col = q * 32 + lane;
      const float dy = u1[q] * r1 - ya[i][q] * r13 * s1;
      bsum[q] += dy;
      gsum[q] += dv[q] * ya[i][q] * r1;
      const float dyc = rnd<T>(dy);
      dy_s[tok * C + col] = dyc;
      dyc_out[(row0 + tok) * C + col] = from_f<T>(dyc);
    }
  }
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    red_b[warp * C + q * 32 + lane] = bsum[q];
    red_g[warp * C + q * 32 + lane] = gsum[q];
  }

  // da = dy @ Wo^T: lane holds feature `lane` of head hh.
  float daa[kRows][kHeads] = {};
  for (int k0 = 0; k0 < C; k0 += 32) {
    __syncthreads();
    for (int i = tid; i < 32 * kHD; i += kThreads) {
      const int kk = i >> 7, j = i & 127;
      w_s[kk * kHD + j] = rnd<T>(wo[static_cast<size_t>(j) * C + k0 + kk]);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < 32; ++kk) {
      float wv[kHeads];
#pragma unroll
      for (int hh = 0; hh < kHeads; ++hh) wv[hh] = w_s[kk * kHD + hh * 32 + lane];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float dv = dy_s[(warp * kRows + i) * C + k0 + kk];
#pragma unroll
        for (int hh = 0; hh < kHeads; ++hh) daa[i][hh] += dv * wv[hh];
      }
    }
  }
  // Every warp has written red_b and red_g (the barriers above): the tile's partials.
  for (int col = tid; col < C; col += kThreads) {
    float sb = 0.f, sg = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      sb += red_b[w * C + col];
      sg += red_g[w * C + col];
    }
    part_bg[static_cast<size_t>(tile) * 2 * C + col] = sb;
    part_bg[static_cast<size_t>(tile) * 2 * C + C + col] = sg * sqrt_c;
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int tok = warp * kRows + i;
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) {
      const float da = rnd<T>(daa[i][hh]);
      a_s[tok * kHD + hh * 32 + lane] = da;
      da3_out[(row0 + tok) * kHD + hh * 32 + lane] = from_f<T>(da);
    }
  }
  __syncwarp();

  // dqs = da . C^T (lane = feature d), then the per-head softmax gradient.
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int tok = warp * kRows + i;
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) {
      float s = 0.f;
#pragma unroll 8
      for (int e = 0; e < kDimHead; ++e)
        s += a_s[tok * kHD + hh * 32 + e] * ctx_s[(hh * kDimHead + lane) * kPad + e];
      const float pq = qa[i][hh];
      const float dpq = s * kInvSqrtD;
      const float dq = pq * dpq - pq * warp_sum(dpq * pq);
      dpc[(row0 + tok) * kQKV + hh * 32 + lane] = from_f<T>(dq);
    }
  }
}

// (3) For one batch row and one head: dC, du, dz, the memory tokens' grads, dk and dv.
template <typename T>
__global__ void __launch_bounds__(kThreads)
context_grad_kernel(const T* __restrict__ qs, const T* __restrict__ da3,
                    const float* __restrict__ ctx, const float* __restrict__ z,
                    const float* __restrict__ kmax, const float* __restrict__ mem_kv,
                    const float* __restrict__ ke, const T* __restrict__ v3,
                    T* __restrict__ dpc, float* __restrict__ part_mem, int n, int m) {
  const int h = blockIdx.x, bb = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int col0 = h * kDimHead;

  __shared__ float a_s[kTile * 32];       // qs, then ke
  __shared__ float b_s[kTile * 32];       // da, then v
  __shared__ float du_s[kDimHead * kPad]; // du rounded to T
  __shared__ float dz_s[kDimHead];
  __shared__ float kmax_s[kDimHead];

  if (tid < kDimHead) kmax_s[tid] = kmax[static_cast<size_t>(bb) * kHD + col0 + tid];

  // dC[dk, e0..e0+3] = sum over tokens of qs[., dk] da[., e].
  const int dk = tid >> 3, e0 = (tid & 7) * 4;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int t0 = 0; t0 < n; t0 += kTile) {
    __syncthreads();
#pragma unroll
    for (int r = 0; r < (kTile * 32) / kThreads; ++r) {
      const int i = tid + r * kThreads, t = i >> 5, f = i & 31;
      const size_t idx = (static_cast<size_t>(bb) * n + t0 + t) * kHD + col0 + f;
      a_s[i] = to_f(qs[idx]);
      b_s[i] = to_f(da3[idx]);
    }
    __syncthreads();
#pragma unroll 8
    for (int t = 0; t < kTile; ++t) {
      const float qv = a_s[t * 32 + dk];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] += qv * b_s[t * 32 + e0 + q];
    }
  }

  // du = dC / z[dk] (rounded); dz[dk] = -sum_e dC * C / z[dk], summed over the 8 threads
  // of row dk (consecutive lanes) in a fixed butterfly.
  const float* cb = ctx + (static_cast<size_t>(bb) * kHeads + h) * kDimHead * kDimHead;
  const float zd = z[static_cast<size_t>(bb) * kHD + col0 + dk];
  float dzp = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    dzp += acc[q] * cb[dk * kDimHead + e0 + q];
    du_s[dk * kPad + e0 + q] = rnd<T>(acc[q] / zd);
  }
  dzp += __shfl_xor_sync(0xffffffffu, dzp, 1);
  dzp += __shfl_xor_sync(0xffffffffu, dzp, 2);
  dzp += __shfl_xor_sync(0xffffffffu, dzp, 4);
  if ((tid & 7) == 0) dz_s[dk] = -dzp / zd;
  __syncthreads();

  // Memory tokens: thread (j, f) for j < m. dmemk[f, j] = me * (memv . du^T + dz);
  // dmemv[f, j] = me . du, this row's share.
  if (tid < m * kDimHead) {
    const int j = tid / kDimHead, f = tid % kDimHead;
    const float* memk = mem_kv + static_cast<size_t>(h) * kDimHead * m;
    const float* memv = mem_kv + static_cast<size_t>(kHeads + h) * kDimHead * m;
    float dme = 0.f, dmv = 0.f;
    for (int e = 0; e < kDimHead; ++e) {
      dme += rnd<T>(memv[e * m + j]) * du_s[f * kPad + e];
      dmv += rnd<T>(expf(memk[e * m + j] - kmax_s[e])) * du_s[e * kPad + f];
    }
    const float me = expf(memk[f * m + j] - kmax_s[f]);
    float* part = part_mem + static_cast<size_t>(bb) * 2 * kHD * m;
    part[(col0 + f) * m + j] = me * (dme + dz_s[f]);
    part[(kHD + col0 + f) * m + j] = dmv;
  }

  // dk = ke * (v . du^T + dz) for feature `lane`, dv = ke_T . du for feature `lane`.
  for (int t0 = 0; t0 < n; t0 += kTile) {
    __syncthreads();
#pragma unroll
    for (int r = 0; r < (kTile * 32) / kThreads; ++r) {
      const int i = tid + r * kThreads, t = i >> 5, f = i & 31;
      const size_t idx = (static_cast<size_t>(bb) * n + t0 + t) * kHD + col0 + f;
      a_s[i] = ke[idx];
      b_s[i] = to_f(v3[idx]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int t = warp * kRows + i;
      float dke = 0.f, dv = 0.f;
#pragma unroll 8
      for (int e = 0; e < kDimHead; ++e) {
        dke += b_s[t * 32 + e] * du_s[lane * kPad + e];
        dv += rnd<T>(a_s[t * 32 + e]) * du_s[e * kPad + lane];
      }
      const float dk_val = a_s[t * 32 + lane] * (dke + dz_s[lane]);
      T* out = dpc + (static_cast<size_t>(bb) * n + t0 + t) * kQKV;
      out[kHD + col0 + lane] = from_f<T>(dk_val);
      out[2 * kHD + col0 + lane] = from_f<T>(dv);
    }
  }
}

// (4) For one 32-token tile: dxn = dp @ Wqkv^T, dx through the first RMSNorm; dg0 partial.
template <typename T, int NC, bool kResidual>
__global__ void __launch_bounds__(kThreads)
token_b_kernel(const T* __restrict__ x, const float* __restrict__ g0,
               const float* __restrict__ wqkv, const T* __restrict__ dpc,
               const T* __restrict__ dout, T* __restrict__ dx,
               float* __restrict__ part_g0, int n) {
  constexpr int C = NC * 32;
  const int t0 = blockIdx.x * kTile, bb = blockIdx.y;
  const int tile = bb * gridDim.x + blockIdx.x;
  const size_t row0 = static_cast<size_t>(bb) * n + t0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  extern __shared__ float smem[];
  float* p_s = smem;               // [kTile][kQKV]: dp rounded to T
  float* w_s = p_s + kTile * kQKV; // [32][C]: Wqkv^T rows j0 .. j0 + 31
  float* red_s = w_s + 32 * C;     // [kWarps][C]

  for (int i = tid; i < kTile * kQKV; i += kThreads) p_s[i] = to_f(dpc[row0 * kQKV + i]);

  float dxa[kRows][NC] = {};
  for (int j0 = 0; j0 < kQKV; j0 += 32) {
    __syncthreads();
    for (int i = tid; i < 32 * C; i += kThreads) {
      const int jj = i / C, col = i % C;
      w_s[i] = rnd<T>(wqkv[static_cast<size_t>(col) * kQKV + j0 + jj]);
    }
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < 32; ++jj) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = p_s[(warp * kRows + i) * kQKV + j0 + jj];
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        const float wv = w_s[jj * C + q * 32 + lane];
#pragma unroll
        for (int i = 0; i < kRows; ++i) dxa[i][q] += pv[i] * wv;
      }
    }
  }

  const float sqrt_c = sqrtf(static_cast<float>(C));
  float gsum[NC] = {};
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const size_t base = (row0 + warp * kRows + i) * C;
    float xv[NC], u0[NC];
    float ss = 0.f;
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      xv[q] = to_f(x[base + q * 32 + lane]);
      ss += xv[q] * xv[q];
    }
    const float r0 = rsqrtf(warp_sum(ss) + kEps);
    float su = 0.f;
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      u0[q] = dxa[i][q] * (g0[q * 32 + lane] * sqrt_c);
      su += u0[q] * xv[q];
    }
    const float s0 = warp_sum(su);
    const float r03 = r0 * r0 * r0;
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      const int col = q * 32 + lane;
      float d = u0[q] * r0 - xv[q] * r03 * s0;
      if (kResidual) d += to_f(dout[base + col]);
      dx[base + col] = from_f<T>(d);
      gsum[q] += dxa[i][q] * xv[q] * r0;
    }
  }
#pragma unroll
  for (int q = 0; q < NC; ++q) red_s[warp * C + q * 32 + lane] = gsum[q];
  __syncthreads();
  for (int col = tid; col < C; col += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red_s[w * C + col];
    part_g0[static_cast<size_t>(tile) * C + col] = s * sqrt_c;
  }
}

// (5, 6) out[split] = A[rows of the split]^T B[rows of the split], A [K, M], B [K, N] in T;
// one 32 x 32 tile of the [M, N] output per block, thread (r, c4 .. c4 + 3).
template <typename T>
__global__ void __launch_bounds__(kThreads)
atb_partial_kernel(const T* __restrict__ A, const T* __restrict__ B, int K, int M, int N,
                   int chunk, float* __restrict__ out) {
  __shared__ float a_s[32][kPad];
  __shared__ float b_s[32][kPad];
  const int tm = blockIdx.x * 32, tn = blockIdx.y * 32, split = blockIdx.z;
  const int tid = threadIdx.x, r = tid >> 3, c4 = (tid & 7) * 4;
  const int k_begin = split * chunk;
  const int k_end = k_begin + chunk < K ? k_begin + chunk : K;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = k_begin; k0 < k_end; k0 += 32) {
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < (32 * 32) / kThreads; ++rr) {
      const int i = tid + rr * kThreads, kk = i >> 5, col = i & 31;
      a_s[kk][col] = to_f(A[static_cast<size_t>(k0 + kk) * M + tm + col]);
      b_s[kk][col] = to_f(B[static_cast<size_t>(k0 + kk) * N + tn + col]);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < 32; ++kk) {
      const float av = a_s[kk][r];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] += av * b_s[kk][c4 + q];
    }
  }
  float* o = out + (static_cast<size_t>(split) * M + tm + r) * N + tn + c4;
#pragma unroll
  for (int q = 0; q < 4; ++q) o[q] = acc[q];
}

// (7-9) out[j] = sum over r of in[r * ld + col0 + j], j < len, in a fixed order: eight
// strided groups of rows, then the eight group sums in order.
__global__ void __launch_bounds__(kThreads)
reduce_rows_kernel(const float* __restrict__ in, int rows, int ld, int col0, int len,
                   float* __restrict__ out) {
  __shared__ float s[kWarps][32];
  const int tid = threadIdx.x, g = tid >> 5, lane = tid & 31;
  const int j = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (j < len)
    for (int r = g; r < rows; r += kWarps) acc += in[static_cast<size_t>(r) * ld + col0 + j];
  s[g][lane] = acc;
  __syncthreads();
  if (g == 0 && j < len) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += s[w][lane];
    out[j] = t;
  }
}

cudaError_t reduce_rows(const float* in, int rows, int ld, int col0, int len, float* out,
                        cudaStream_t stream) {
  reduce_rows_kernel<<<(len + 31) / 32, kThreads, 0, stream>>>(in, rows, ld, col0, len, out);
  return cudaGetLastError();
}

template <typename Kernel>
cudaError_t set_smem(Kernel kern, int bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

#define LGM_TRY(expr)                      \
  do {                                     \
    const cudaError_t e_ = (expr);         \
    if (e_ != cudaSuccess) return e_;      \
  } while (0)

struct Grads {
  void* dx;
  float *dg0, *dw, *dmem, *dwo, *dbo, *dg1;
};

template <typename T, int NC>
cudaError_t run(const T* x, const float* g0, const float* wqkv, const float* mem_kv,
                const float* wo, const float* bo, const float* g1, const T* dout,
                const Grads& gr, char* ws, int b, int n, int m, bool residual,
                cudaStream_t stream) {
  constexpr int C = NC * 32;
  constexpr int kWCols = C > kHD ? C : kHD;
  const Layout L(b, n, C, m, sizeof(T));
  float* ke = reinterpret_cast<float*>(ws + L.ke);
  T* v3 = reinterpret_cast<T*>(ws + L.v3);
  T* xn = reinterpret_cast<T*>(ws + L.xn);
  T* qs = reinterpret_cast<T*>(ws + L.qs);
  T* ac = reinterpret_cast<T*>(ws + L.ac);
  T* da3 = reinterpret_cast<T*>(ws + L.da3);
  T* dyc = reinterpret_cast<T*>(ws + L.dyc);
  T* dpc = reinterpret_cast<T*>(ws + L.dpc);
  float* kmax = reinterpret_cast<float*>(ws + L.kmax);
  float* z = reinterpret_cast<float*>(ws + L.z);
  float* ctx = reinterpret_cast<float*>(ws + L.ctx);
  float* part_bg = reinterpret_cast<float*>(ws + L.part_bg);
  float* part_g0 = reinterpret_cast<float*>(ws + L.part_g0);
  float* part_mem = reinterpret_cast<float*>(ws + L.part_mem);
  float* part_w = reinterpret_cast<float*>(ws + L.part_w);
  float* part_wo = reinterpret_cast<float*>(ws + L.part_wo);
  const int tokens = b * n, tiles = tokens / kTile;
  const dim3 head_grid(kHeads, b), tile_grid(n / kTile, b);

  const int smem1 = sizeof(float) * (C * 64 + kTile * C + 3 * kTile * 32 + kWarps * 32 + 64);
  LGM_TRY(set_smem(stats_kernel<T, NC>, smem1));
  stats_kernel<T, NC><<<head_grid, kThreads, smem1, stream>>>(x, g0, wqkv, mem_kv, xn, ke, v3,
                                                              kmax, z, ctx, n, m);
  LGM_TRY(cudaGetLastError());

  const int smem2 = sizeof(float) * (kHeads * kDimHead * kPad + 2 * kTile * C + 32 * kWCols +
                                     kTile * kHD + 2 * kWarps * C);
  LGM_TRY(set_smem(token_a_kernel<T, NC>, smem2));
  token_a_kernel<T, NC><<<tile_grid, kThreads, smem2, stream>>>(
      xn, wqkv, ctx, wo, bo, g1, dout, qs, ac, da3, dyc, dpc, part_bg, n);
  LGM_TRY(cudaGetLastError());

  context_grad_kernel<T><<<head_grid, kThreads, 0, stream>>>(qs, da3, ctx, z, kmax, mem_kv, ke,
                                                             v3, dpc, part_mem, n, m);
  LGM_TRY(cudaGetLastError());

  const int smem4 = sizeof(float) * (kTile * kQKV + 32 * C + kWarps * C);
  auto kern4 = residual ? token_b_kernel<T, NC, true> : token_b_kernel<T, NC, false>;
  LGM_TRY(set_smem(kern4, smem4));
  kern4<<<tile_grid, kThreads, smem4, stream>>>(x, g0, wqkv, dpc, dout,
                                                static_cast<T*>(gr.dx), part_g0, n);
  LGM_TRY(cudaGetLastError());

  atb_partial_kernel<T><<<dim3(C / 32, kQKV / 32, L.splits_w), kThreads, 0, stream>>>(
      xn, dpc, tokens, C, kQKV, L.chunk_w, part_w);
  LGM_TRY(cudaGetLastError());
  atb_partial_kernel<T><<<dim3(kHD / 32, C / 32, L.splits_wo), kThreads, 0, stream>>>(
      ac, dyc, tokens, kHD, C, L.chunk_wo, part_wo);
  LGM_TRY(cudaGetLastError());

  LGM_TRY(reduce_rows(part_w, L.splits_w, C * kQKV, 0, C * kQKV, gr.dw, stream));
  LGM_TRY(reduce_rows(part_wo, L.splits_wo, kHD * C, 0, kHD * C, gr.dwo, stream));
  LGM_TRY(reduce_rows(part_bg, tiles, 2 * C, 0, C, gr.dbo, stream));
  LGM_TRY(reduce_rows(part_bg, tiles, 2 * C, C, C, gr.dg1, stream));
  LGM_TRY(reduce_rows(part_g0, tiles, C, 0, C, gr.dg0, stream));
  return reduce_rows(part_mem, b, 2 * kHD * m, 0, 2 * kHD * m, gr.dmem, stream);
}

template <typename T>
cudaError_t dispatch(int c, const void* x, const float* g0, const float* wqkv,
                     const float* mem_kv, const float* wo, const float* bo, const float* g1,
                     const void* dout, const Grads& gr, char* ws, int b, int n, int m,
                     bool residual, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* dt = static_cast<const T*>(dout);
  switch (c) {
    case 64:
      return run<T, 2>(xt, g0, wqkv, mem_kv, wo, bo, g1, dt, gr, ws, b, n, m, residual, s);
    case 128:
      return run<T, 4>(xt, g0, wqkv, mem_kv, wo, bo, g1, dt, gr, ws, b, n, m, residual, s);
    case 256:
      return run<T, 8>(xt, g0, wqkv, mem_kv, wo, bo, g1, dt, gr, ws, b, n, m, residual, s);
    default:
      return cudaErrorInvalidValue;
  }
}

bool shape_ok(int b, int n, int c, int m) {
  return b >= 1 && b <= 65535 && n >= kTile && n % kTile == 0 && m >= 1 && m <= 8 &&
         (c == 64 || c == 128 || c == 256);
}

}  // namespace

// Bytes of device workspace that lgm_linear_attention_bwd needs for these shapes (0 for
// shapes it does not take).
extern "C" size_t lgm_linear_attention_bwd_workspace(int b, int n, int c, int m, int bf16) {
  if (!shape_ok(b, n, c, m)) return 0;
  return Layout(b, n, c, m, bf16 ? 2 : 4).total;
}

// x, dout, dx: [b, n, c] in f32 (bf16 == 0) or bf16 (bf16 == 1), also the compute type.
// g0, bo, g1: [c]; wqkv: [c, 384]; mem_kv: [2, 4, 32, m]; wo: [128, c]; all f32, as are
// the gradients dg0, dw, dmem, dwo, dbo, dg1 of the same shapes. workspace: at least
// lgm_linear_attention_bwd_workspace bytes, 256-byte aligned. Heads 4, dim_head 32,
// c in {64, 128, 256}, n a multiple of 32, 1 <= m <= 8. Launches on `stream` and returns
// the first CUDA error.
extern "C" int lgm_linear_attention_bwd(const void* x, const void* g0, const void* wqkv,
                                        const void* mem_kv, const void* wo, const void* bo,
                                        const void* g1, const void* dout, void* dx, void* dg0,
                                        void* dw, void* dmem, void* dwo, void* dbo, void* dg1,
                                        void* workspace, int b, int n, int c, int m,
                                        int residual, int bf16, void* stream) {
  if (!shape_ok(b, n, c, m)) return cudaErrorInvalidValue;
  const Grads gr{dx, static_cast<float*>(dg0), static_cast<float*>(dw),
                 static_cast<float*>(dmem), static_cast<float*>(dwo),
                 static_cast<float*>(dbo), static_cast<float*>(dg1)};
  const float* f_g0 = static_cast<const float*>(g0);
  const float* f_wqkv = static_cast<const float*>(wqkv);
  const float* f_mem = static_cast<const float*>(mem_kv);
  const float* f_wo = static_cast<const float*>(wo);
  const float* f_bo = static_cast<const float*>(bo);
  const float* f_g1 = static_cast<const float*>(g1);
  char* ws = static_cast<char*>(workspace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(c, x, f_g0, f_wqkv, f_mem, f_wo, f_bo, f_g1, dout, gr, ws,
                                   b, n, m, residual != 0, s);
  return dispatch<float>(c, x, f_g0, f_wqkv, f_mem, f_wo, f_bo, f_g1, dout, gr, ws, b, n, m,
                         residual != 0, s);
}

extern "C" const char* lgm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
