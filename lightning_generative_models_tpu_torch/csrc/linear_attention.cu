// Fused linear-attention block forward, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel lightning_generative_models_tpu/ops/linear_attention.py:_kernel
// (launched through _pallas_forward). Same math, with the same casts to the compute type T:
//
//   xn  = RMSNorm(x) * g0 * sqrt(c)                           -> T
//   q, k, v = xn @ Wqkv                                       (f32 sums)
//   qs  = softmax over each head's d features of q, * d^-1/2  -> T
//         (stabilised by the true per-head max: a row-wide max underflows a whole head to 0/0)
//   ke  = exp(k - kmax), kmax the max over the row's tokens and the m memory tokens of
//         each feature: ke is rounded to T against this final max, as _kernel does
//   z   = sum over tokens of ke (f32) + sum over memory tokens of exp(memk - kmax)
//   ctx = (keᵀ v + meᵀ memv) * (1 / z) per head               -> T
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
// Design (the shared pieces in linear_attention_common.cuh). The TPU program holds a whole
// [rows, n, c] slab in VMEM and relies on its grid running in order; here blocks run in no
// order, and ke must be rounded against the row's final max before the context sums it.
// So the row-wide quantities come first, as per-block partials merged in a fixed order,
// and the forward is five launches on one stream:
//  (1) prep: the weights rounded to T once a call, in the fragment order of the products'
//      B operands (one coalesced load a warp's block);
//  (2) kmax: per block (a chunk of consecutive 16-token subtiles of one row, Plan), RMSNorm
//      once a subtile into shared memory, then warp h's k = xn Wk for head h, the max of
//      each feature;
//  (3) context: the max merged (memory tokens included), k and v again (a product costs
//      less than storing k), ke = exp(k - kmax) rounded, its f32 sum z and keᵀ v per head in
//      registers, one partial a block;
//  (4) merge, a (row, head) a block: the partials added in block order and the memory
//      tokens' meᵀ memv, ctx = U / z rounded;
//  (5) output: one subtile a block: warp h q = xn Wq, the head softmax, qs and a = qs ctx
//      for head h, from registers; warp w y = a Wo + bo for a quarter of the columns, the
//      RMSNorm's row sums over the four warps, g1, the residual.
// Every product is mma.sync on the tensor cores: bf16 m16n8k16 on operands already rounded
// to bf16 (exact in the f32 accumulator, so only the order of the f32 sums differs from the
// reference), 3xTF32 m16n8k8 in f32. Subtiles come in through a two-stage cp.async ring.
// The launches use programmatic dependent launch, so each overlaps its predecessor's tail.
// At bs64 the smallest call of the UNet, (64, 256), has 256 blocks a pass. No float atomics:
// repeats are bit-identical. wgmma, which wants 64-row tiles, is later work.

#include "linear_attention_common.cuh"

namespace {

// (5) out = RMSNorm(qs ctx Wo + bo) * g1 * sqrt(c) (+ x) for the subtiles of a block's chunk.
// Warp h: q = xn Wq for head h, its softmax, qs rounded, a = qs ctx from registers, rounded
// into the shared a; then warp w: y = a Wo + bo for columns w C / 4 .. (w + 1) C / 4, the
// RMSNorm's row sums over the four warps, g1 and the residual.
template <typename T, int NC, bool kResidual>
__global__ void __launch_bounds__(kWarps * 32)
la_fwd_output_kernel(const T* __restrict__ x, const float* __restrict__ g0,
                     const T* __restrict__ w_qkv, const T* __restrict__ ctx_a,
                     const T* __restrict__ w_y, const float* __restrict__ bo,
                     const float* __restrict__ g1, T* __restrict__ out, int n, int S, int chunk) {
  pdl_enter();
  using L = SubtileSmem<T, NC>;
  constexpr int C = NC * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = threadIdx.x >> 5, g = lane_g(), t = lane_t();
  T* a_s = reinterpret_cast<T*>(smem + L::bytes);  // [16][kLdh]
  float* red = reinterpret_cast<float*>(smem + L::bytes + al16(kSub * kLdh * sizeof(T)));
  const Chunk ck(n, S, chunk);
  const size_t tok0 = static_cast<size_t>(ck.row) * n;
  const T* ctx = ctx_a + static_cast<size_t>(ck.row) * kCtx + h * kDimHead * kDimHead;
  const float sqrt_c = sqrtf(static_cast<float>(C));

  walk_subtiles<T, NC, true>(x + tok0 * C, ck, g0, smem, static_cast<T*>(nullptr), tok0,
                             NoFetch(), [&](const T* xn, const T* xr, int, int s) {
    float q[4][4];
    zero(q);
    head_projection<T, NC>(q, xn, w_qkv, 0, h);
    head_softmax4(q);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) q[nt][r] = rnd<T>(q[nt][r] * kInvSqrtD);
    float a[4][4];
    zero(a);
    product_regs<T, 4>(a, q, [&](auto& b, int j, int k0) { load_b_frag(b, ctx, kDimHead, j, k0); });
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        store_pair(a_s + (g + 8 * half) * kLdh + h * kDimHead + 8 * nt + 2 * t, a[nt][2 * half],
                   a[nt][2 * half + 1]);
    __syncthreads();  // a is complete

    float y[NC][4];
    zero(y);
    product<T, NC, kHD>(
        y, [&](auto& fa, int k0) { load_a_mk(fa, a_s, kLdh, k0); },
        [&](auto& b, int j, int k0) { load_b_frag(b, w_y, kHD, h * NC + j, k0); });
    float ss[1][2] = {{0.f, 0.f}};
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float2 bv = load_pair(bo + 8 * (h * NC + j) + 2 * t);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        y[j][2 * half] += bv.x;
        y[j][2 * half + 1] += bv.y;
        ss[0][half] += y[j][2 * half] * y[j][2 * half] + y[j][2 * half + 1] * y[j][2 * half + 1];
      }
    }
    rows_sum(ss, red);
    T* orow = out + (tok0 + static_cast<size_t>(s) * kSub) * C;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = 8 * (h * NC + j) + 2 * t;
      const float2 gv = load_pair(g1 + col);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = g + 8 * half;
        const float r1 = rsqrtf(ss[0][half] + kEps);
        float o0 = y[j][2 * half] * r1 * (gv.x * sqrt_c);
        float o1 = y[j][2 * half + 1] * r1 * (gv.y * sqrt_c);
        if (kResidual) {
          const float2 xv = load_pair(xr + row * (C + 8) + col);
          o0 += xv.x;
          o1 += xv.y;
        }
        store_pair(orow + row * C + col, o0, o1);
      }
    }
  });
}

template <typename T, int NC>
constexpr size_t output_smem() {
  return SubtileSmem<T, NC>::bytes + al16(kSub * kLdh * sizeof(T)) + kWarps * kSub * sizeof(float);
}

// Workspace of the forward: the rounded weights, the per-block partials, the rows' ctx.
struct FwdLayout {
  size_t w_qkv, w_y, part_kmax, part_z, part_ctx, ctx_a, total;
  FwdLayout(const Plan& P, int b, int c, size_t elt) {
    Carve cv;
    w_qkv = cv.take(static_cast<size_t>(kQKV) * c * elt);
    w_y = cv.take(static_cast<size_t>(c) * kHD * elt);
    part_kmax = cv.take(static_cast<size_t>(P.blocks) * kHD * 4);
    part_z = cv.take(static_cast<size_t>(P.blocks) * kHD * 4);
    part_ctx = cv.take(static_cast<size_t>(P.blocks) * kCtx * 4);
    ctx_a = cv.take(static_cast<size_t>(b) * kCtx * elt);
    total = cv.at;
  }
};

template <typename T, int NC>
cudaError_t run(const void* x, const float* g0, const float* wqkv, const float* mem_kv,
                const float* wo, const float* bo, const float* g1, void* out, char* ws, int b,
                int n, int m, bool residual, cudaStream_t stream) {
  constexpr int C = NC * 32;
  const Plan P(b, n);
  const FwdLayout L(P, b, C, sizeof(T));
  const T* xt = static_cast<const T*>(x);
  T* w_qkv = reinterpret_cast<T*>(ws + L.w_qkv);
  T* w_y = reinterpret_cast<T*>(ws + L.w_y);
  T* ctx_a = reinterpret_cast<T*>(ws + L.ctx_a);
  const CtxOut<T> merged{ctx_a, nullptr, nullptr, nullptr, nullptr};
  LGM_TRY((launch_context<LaFwd, T, NC>(
      P, xt, g0, wqkv, mem_kv, wo, w_qkv, w_y, nullptr, nullptr,
      reinterpret_cast<float*>(ws + L.part_kmax), reinterpret_cast<float*>(ws + L.part_z),
      reinterpret_cast<float*>(ws + L.part_ctx), nullptr, merged, b, n, m, stream)));

  // The output pass has no row-wide sums: one subtile a block, the finest grid.
  const int S = n / kSub;
  auto kern = residual ? la_fwd_output_kernel<T, NC, true> : la_fwd_output_kernel<T, NC, false>;
  return launch(kern, b * S, kWarps * 32, output_smem<T, NC>(), stream, xt, g0, w_qkv,
                static_cast<const T*>(ctx_a), static_cast<const T*>(w_y), bo, g1,
                static_cast<T*>(out), n, S, 1);
}

template <typename T>
cudaError_t dispatch(int c, const void* x, const float* g0, const float* wqkv,
                     const float* mem_kv, const float* wo, const float* bo, const float* g1,
                     void* out, char* ws, int b, int n, int m, bool residual,
                     cudaStream_t stream) {
  switch (c) {
    case 64:
      return run<T, 2>(x, g0, wqkv, mem_kv, wo, bo, g1, out, ws, b, n, m, residual, stream);
    case 128:
      return run<T, 4>(x, g0, wqkv, mem_kv, wo, bo, g1, out, ws, b, n, m, residual, stream);
    case 256:
      return run<T, 8>(x, g0, wqkv, mem_kv, wo, bo, g1, out, ws, b, n, m, residual, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

bool shape_ok(int b, int n, int c, int m) {
  return b >= 1 && b <= 65535 && n >= kSub && n % kSub == 0 && m >= 1 &&
         (c == 64 || c == 128 || c == 256);
}

}  // namespace

// Bytes of device workspace that lgm_linear_attention_fwd needs for these shapes (0 for
// shapes it does not take).
extern "C" size_t lgm_linear_attention_fwd_workspace(int b, int n, int c, int m, int bf16) {
  if (!shape_ok(b, n, c, m)) return 0;
  return FwdLayout(Plan(b, n), b, c, bf16 ? 2 : 4).total;
}

// x, out: [b, n, c] in f32 (bf16 == 0) or bf16 (bf16 == 1), which is also the compute type.
// g0, bo, g1: [c]; wqkv: [c, 384]; mem_kv: [2, 4, 32, m]; wo: [128, c]; all f32.
// workspace: at least lgm_linear_attention_fwd_workspace bytes, 256-byte aligned. Heads 4,
// dim_head 32, c in {64, 128, 256}, n a multiple of 16. Launches on `stream` and returns
// the first CUDA error.
extern "C" int lgm_linear_attention_fwd(const void* x, const void* g0, const void* wqkv,
                                        const void* mem_kv, const void* wo, const void* bo,
                                        const void* g1, void* out, void* workspace, int b, int n,
                                        int c, int m, int residual, int bf16, void* stream) {
  if (!shape_ok(b, n, c, m)) return cudaErrorInvalidValue;
  const float* f_g0 = static_cast<const float*>(g0);
  const float* f_wqkv = static_cast<const float*>(wqkv);
  const float* f_mem = static_cast<const float*>(mem_kv);
  const float* f_wo = static_cast<const float*>(wo);
  const float* f_bo = static_cast<const float*>(bo);
  const float* f_g1 = static_cast<const float*>(g1);
  char* ws = static_cast<char*>(workspace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(c, x, f_g0, f_wqkv, f_mem, f_wo, f_bo, f_g1, out, ws, b, n,
                                   m, residual != 0, s);
  return dispatch<float>(c, x, f_g0, f_wqkv, f_mem, f_wo, f_bo, f_g1, out, ws, b, n, m,
                         residual != 0, s);
}

extern "C" const char* lgm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
