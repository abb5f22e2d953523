// Fused linear-attention block forward, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel lightning_generative_models_tpu/ops/linear_attention.py:_kernel
// (launched through _pallas_forward). Same math, with the same casts to the compute type T:
//
//   xn  = RMSNorm(x) * g0 * sqrt(c)                           -> T
//   q, k, v = xn @ Wqkv                                       (f32 sums)
//   qs  = softmax over each head's d features of q, * d^-1/2  -> T
//         (stabilised by the true per-head max: a row-wide max underflows a whole head to 0/0)
//   ke  = exp(k - max over tokens of k), the m memory tokens merged through the shared max
//         and a summed normaliser z                           -> T
//   ctx = (ke^T v) / z per head                               -> T
//   a   = qs . ctx                                            -> T
//   y   = a @ Wo + bo;  out = RMSNorm(y) * g1 * sqrt(c)  (+ x when residual)
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): per token the block does
// 1024*c + 16384 flops and moves 2*c*sizeof(T) bytes of activations. In bf16 that is near
// the ridge at every UNet shape: [128,1024,64] is 10.7 GFLOP (10.9 us) and 34 MB (10.0 us);
// [128,256,64] 2.7 GFLOP (2.7 us), 8.4 MB (2.5 us); [128,256,128] 4.8 GFLOP (4.9 us),
// 16.8 MB (5.0 us); [128,64,128] 1.2 GFLOP (1.2 us), 4.2 MB (1.3 us); [128,64,256]
// 2.3 GFLOP (2.3 us), 8.4 MB (2.5 us).
//
// Design. The TPU program holds a whole [rows, n, c] slab in VMEM and relies on its grid
// running in order. Neither carries over: one [1024, 64] row is 256 KB in f32, more than a
// block's shared memory, and blocks run in no order. So the block is two launches:
//  (a) context pass, grid (heads, b): loops over 32-token tiles; recomputes the RMSNorm and
//      this head's k and v columns from a shared-memory copy of its Wqkv slice; keeps a
//      running per-feature max of k, rescaling the [d, d] context and z as flash attention
//      does, starting from the memory tokens. Writes ctx / z in f32 to a [b, heads, d, d]
//      scratch buffer.
//  (b) output pass, grid (n / 32, b): RMSNorm, q = xn @ Wq, per-head softmax, a = qs . ctx,
//      y = a @ Wo + bo, RMSNorm, residual.
// Each warp owns 4 tokens of a tile and lane l owns feature l of every head (q, a) or the
// columns l, l + 32, ... (x, y), so every per-token reduction is a warp shuffle. Products
// are FMA loops in f32 over operands rounded to T, which is what a tensor-core product with
// f32 accumulation computes. Tensor cores (wgmma), TMA and tuning are later work.

#include "linear_attention_common.cuh"

namespace {

// (a) ctx[b, h] = (softmax_tokens(k)^T v) / z for one batch row and one head.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
context_kernel(const T* __restrict__ x, const float* __restrict__ g0,
               const float* __restrict__ wqkv, const float* __restrict__ mem_kv,
               float* __restrict__ ctx, int n, int m) {
  constexpr int C = NC * 32;
  const int h = blockIdx.x, bb = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  extern __shared__ float smem[];
  float* w_s = smem;                 // [C][64]: this head's k columns, then its v columns
  float* xn_s = w_s + C * 64;        // [kTile][C]
  float* k_s = xn_s + kTile * C;     // [kTile][32] k logits
  float* e_s = k_s + kTile * 32;     // [kTile][32] exp(k - running max), rounded
  float* v_s = e_s + kTile * 32;     // [kTile][32] v, rounded
  float* stat_s = v_s + kTile * 32;  // [32] per-feature max, rescale factor, then z

  for (int i = tid; i < C * 64; i += kThreads) {
    const int r = i >> 6, j = i & 63;
    const int col = (j < 32 ? kHD : 2 * kHD) + h * kDimHead + (j & 31);
    w_s[i] = rnd<T>(wqkv[static_cast<size_t>(r) * kQKV + col]);
  }

  // mem_kv is [2, heads, d, m]: memk[f * m + j] is memory token j of this head's feature f.
  const float* memk = mem_kv + static_cast<size_t>(h) * kDimHead * m;
  const float* memv = mem_kv + static_cast<size_t>(kHeads + h) * kDimHead * m;

  // Warp 0 keeps the running max and z of feature `lane`, starting from the memory tokens.
  float run_max = -INFINITY, run_z = 0.f;
  if (warp == 0) {
    for (int j = 0; j < m; ++j) run_max = fmaxf(run_max, memk[lane * m + j]);
    for (int j = 0; j < m; ++j) run_z += expf(memk[lane * m + j] - run_max);
    stat_s[lane] = run_max;
  }
  __syncthreads();

  // This thread's part of the context: row dk (a k feature), columns e0 .. e0 + 3.
  const int dk = tid >> 3, e0 = (tid & 7) * 4;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  {
    const float mx = stat_s[dk];
    for (int j = 0; j < m; ++j) {
      const float e = rnd<T>(expf(memk[dk * m + j] - mx));
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] += e * rnd<T>(memv[(e0 + q) * m + j]);
    }
  }

  for (int t0 = 0; t0 < n; t0 += kTile) {
    __syncthreads();  // every thread is done with the previous tile's e_s, v_s, stat_s
    rmsnorm_rows<T, NC>(x + (static_cast<size_t>(bb) * n + t0) * C, g0, xn_s, warp, lane);
    __syncwarp();

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
      k_s[(warp * kRows + i) * 32 + lane] = ka[i];
      v_s[(warp * kRows + i) * 32 + lane] = rnd<T>(va[i]);
    }
    __syncthreads();

    if (warp == 0) {
      float tmax = run_max;
      for (int t = 0; t < kTile; ++t) tmax = fmaxf(tmax, k_s[t * 32 + lane]);
      const float scale = expf(run_max - tmax);
      float z = run_z * scale;
      for (int t = 0; t < kTile; ++t) {
        const float e = expf(k_s[t * 32 + lane] - tmax);
        z += e;
        e_s[t * 32 + lane] = rnd<T>(e);
      }
      run_max = tmax;
      run_z = z;
      stat_s[lane] = scale;
    }
    __syncthreads();

    const float scale = stat_s[dk];
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] *= scale;
#pragma unroll 8
    for (int t = 0; t < kTile; ++t) {
      const float e = e_s[t * 32 + dk];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] += e * v_s[t * 32 + e0 + q];
    }
  }

  __syncthreads();
  if (warp == 0) stat_s[lane] = run_z;
  __syncthreads();
  const float inv_z = 1.f / stat_s[dk];
  float* out = ctx + ((static_cast<size_t>(bb) * kHeads + h) * kDimHead + dk) * kDimHead + e0;
#pragma unroll
  for (int q = 0; q < 4; ++q) out[q] = acc[q] * inv_z;
}

// (b) out = RMSNorm(qs . ctx @ Wo + bo) * g1 * sqrt(c) (+ x) for one 32-token tile.
template <typename T, int NC, bool kResidual>
__global__ void __launch_bounds__(kThreads)
output_kernel(const T* __restrict__ x, const float* __restrict__ g0,
              const float* __restrict__ wqkv, const float* __restrict__ ctx,
              const float* __restrict__ wo, const float* __restrict__ bo,
              const float* __restrict__ g1, T* __restrict__ out, int n) {
  constexpr int C = NC * 32;
  constexpr int kWCols = C > kHD ? C : kHD;
  const int t0 = blockIdx.x * kTile, bb = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  extern __shared__ float smem[];
  float* xn_s = smem;                // [kTile][C]
  float* w_s = xn_s + kTile * C;     // [32][kWCols]: 32 rows of Wq, then of Wo
  float* a_s = w_s + 32 * kWCols;    // [kTile][kHD]: qs, then a = qs . ctx
  float* ctx_s = a_s + kTile * kHD;  // [heads][d][d]

  for (int i = tid; i < kHeads * kDimHead * kDimHead; i += kThreads)
    ctx_s[i] = rnd<T>(ctx[static_cast<size_t>(bb) * kHeads * kDimHead * kDimHead + i]);
  const T* x_tile = x + (static_cast<size_t>(bb) * n + t0) * C;
  rmsnorm_rows<T, NC>(x_tile, g0, xn_s, warp, lane);

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

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) {
      const float mx = warp_max(qa[i][hh]);
      const float e = expf(qa[i][hh] - mx);
      const float p = e / warp_sum(e);
      a_s[(warp * kRows + i) * kHD + hh * 32 + lane] = rnd<T>(p * kInvSqrtD);
    }
  }
  __syncwarp();

  float aa[kRows][kHeads] = {};
#pragma unroll 4
  for (int d = 0; d < kDimHead; ++d) {
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) {
      const float cv = ctx_s[(hh * kDimHead + d) * kDimHead + lane];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        aa[i][hh] += a_s[(warp * kRows + i) * kHD + hh * 32 + d] * cv;
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh)
      a_s[(warp * kRows + i) * kHD + hh * 32 + lane] = rnd<T>(aa[i][hh]);
  __syncwarp();

  // y = a @ Wo: lane holds columns q * 32 + lane.
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

  const float sqrt_c = sqrtf(static_cast<float>(C));
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int tok = warp * kRows + i;
    float ss = 0.f;
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      ya[i][q] += bo[q * 32 + lane];
      ss += ya[i][q] * ya[i][q];
    }
    const float r1 = rsqrtf(warp_sum(ss) + kEps);
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      const int col = q * 32 + lane;
      float o = ya[i][q] * r1 * (g1[col] * sqrt_c);
      if (kResidual) o += to_f(x_tile[static_cast<size_t>(tok) * C + col]);
      out[(static_cast<size_t>(bb) * n + t0 + tok) * C + col] = from_f<T>(o);
    }
  }
}

template <typename T, int NC>
cudaError_t run(const void* x, const float* g0, const float* wqkv, const float* mem_kv,
                const float* wo, const float* bo, const float* g1, void* out, float* ctx,
                int b, int n, int m, bool residual, cudaStream_t stream) {
  constexpr int C = NC * 32;
  constexpr int kWCols = C > kHD ? C : kHD;
  const int smem_ctx = sizeof(float) * (C * 64 + kTile * C + 3 * kTile * 32 + 32);
  const int smem_out =
      sizeof(float) * (kTile * C + 32 * kWCols + kTile * kHD + kHeads * kDimHead * kDimHead);
  const T* xt = static_cast<const T*>(x);

  cudaError_t err = cudaFuncSetAttribute(context_kernel<T, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_ctx);
  if (err != cudaSuccess) return err;
  context_kernel<T, NC><<<dim3(kHeads, b), kThreads, smem_ctx, stream>>>(xt, g0, wqkv, mem_kv,
                                                                         ctx, n, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  using OutputKernel = void (*)(const T*, const float*, const float*, const float*,
                                const float*, const float*, const float*, T*, int);
  OutputKernel kern = output_kernel<T, NC, false>;
  if (residual) kern = output_kernel<T, NC, true>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_out);
  if (err != cudaSuccess) return err;
  kern<<<dim3(n / kTile, b), kThreads, smem_out, stream>>>(xt, g0, wqkv, ctx, wo, bo, g1,
                                                           static_cast<T*>(out), n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int c, const void* x, const float* g0, const float* wqkv,
                     const float* mem_kv, const float* wo, const float* bo, const float* g1,
                     void* out, float* ctx, int b, int n, int m, bool residual,
                     cudaStream_t stream) {
  switch (c) {
    case 64:
      return run<T, 2>(x, g0, wqkv, mem_kv, wo, bo, g1, out, ctx, b, n, m, residual, stream);
    case 128:
      return run<T, 4>(x, g0, wqkv, mem_kv, wo, bo, g1, out, ctx, b, n, m, residual, stream);
    case 256:
      return run<T, 8>(x, g0, wqkv, mem_kv, wo, bo, g1, out, ctx, b, n, m, residual, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, out: [b, n, c] in f32 (bf16 == 0) or bf16 (bf16 == 1), which is also the compute type.
// g0, bo, g1: [c]; wqkv: [c, 384]; mem_kv: [2, 4, 32, m]; wo: [128, c]; all f32.
// ctx: f32 scratch of b * 4 * 32 * 32 values. Heads 4, dim_head 32, c in {64, 128, 256},
// n a multiple of 32. Launches on `stream` and returns cudaGetLastError().
extern "C" int lgm_linear_attention_fwd(const void* x, const void* g0, const void* wqkv,
                                        const void* mem_kv, const void* wo, const void* bo,
                                        const void* g1, void* out, void* ctx, int b, int n,
                                        int c, int m, int residual, int bf16, void* stream) {
  if (b < 1 || b > 65535 || n < kTile || n % kTile != 0 || m < 1) return cudaErrorInvalidValue;
  const float* f_g0 = static_cast<const float*>(g0);
  const float* f_wqkv = static_cast<const float*>(wqkv);
  const float* f_mem = static_cast<const float*>(mem_kv);
  const float* f_wo = static_cast<const float*>(wo);
  const float* f_bo = static_cast<const float*>(bo);
  const float* f_g1 = static_cast<const float*>(g1);
  float* f_ctx = static_cast<float*>(ctx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(c, x, f_g0, f_wqkv, f_mem, f_wo, f_bo, f_g1, out, f_ctx, b, n,
                                   m, residual != 0, s);
  return dispatch<float>(c, x, f_g0, f_wqkv, f_mem, f_wo, f_bo, f_g1, out, f_ctx, b, n, m,
                         residual != 0, s);
}

extern "C" const char* lgm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
