// Shapes, casts and warp reductions shared by the linear-attention forward
// (linear_attention.cu) and backward (linear_attention_bwd.cu) kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kHeads = 4;
constexpr int kDimHead = 32;
constexpr int kHD = kHeads * kDimHead;  // 128
constexpr int kQKV = 3 * kHD;           // Wqkv columns: q | k | v, each head-major
constexpr int kTile = 32;               // tokens per tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kTile / kWarps;   // tokens per warp
constexpr float kEps = 1e-12f;
constexpr float kInvSqrtD = 0.17677669529663687f;  // 32 ** -0.5

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Rounds v to the compute type T and back: the reference's casts.
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// xn_s[tok] = RMSNorm(x[tok]) * g0 * sqrt(c), rounded to T, for the warp's kRows tokens.
template <typename T, int NC>
__device__ __forceinline__ void rmsnorm_rows(const T* __restrict__ x_tile,
                                             const float* __restrict__ g0, float* xn_s,
                                             int warp, int lane) {
  constexpr int C = NC * 32;
  const float sqrt_c = sqrtf(static_cast<float>(C));
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int tok = warp * kRows + i;
    const T* xr = x_tile + static_cast<size_t>(tok) * C;
    float xv[NC];
    float ss = 0.f;
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      xv[q] = to_f(xr[q * 32 + lane]);
      ss += xv[q] * xv[q];
    }
    const float r0 = rsqrtf(warp_sum(ss) + kEps);
#pragma unroll
    for (int q = 0; q < NC; ++q)
      xn_s[tok * C + q * 32 + lane] = rnd<T>(xv[q] * r0 * (g0[q * 32 + lane] * sqrt_c));
  }
}

}  // namespace
