// uint8 image batch -> float [0, 1] with a per-image horizontal flip, written by hand for
// Hopper (sm_90a).
//
// Replaces the TPU kernel lightning_generative_models_tpu/ops/preprocess.py:
// fused_normalize_flip_pallas (its inner kernel, reached by prepare_batch(backend="pallas")).
// Same function on NHWC [B, H, W, C]:
//
//   out[b, h, w, c] = f32(in[b, h, flip[b] ? W - 1 - w : w, c]) * f32(1 / 255),
//
// computed in f32 and rounded once to the output type (f32 or bf16), as the Pallas kernel
// scales in f32, applies the flip as an exact permutation product and casts at the end.
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes. One byte read and 4 (f32) or 2 (bf16)
// written per element, one flop: at 128 x 32 x 32 x 3 in f32 that is 1.97 MB, 0.59 us.
//
// Design. The TPU program turns the flip into a [W*C, W*C] permutation matmul on the MXU
// because Mosaic has no reverse; here the flip is an index. A block of 256 threads takes
// one image row (b, h) of W*C elements; thread t writes elements t, t + 256, ... of the
// output row in order (coalesced stores) and reads each from its mirrored place in the
// same input row (runs of C bytes in reverse pixel order). Every output element has one
// writer. Loads of one byte a thread are far from the card's best width: simple first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void store(float* out, long long i, float x) { out[i] = x; }
__device__ __forceinline__ void store(__nv_bfloat16* out, long long i, float x) {
  out[i] = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    normalize_flip_kernel(const uint8_t* __restrict__ in, const uint8_t* __restrict__ flip,
                          T* __restrict__ out, int h, int w, int c) {
  const int row = blockIdx.x;  // b * h + y
  const int b = row / h;
  const int wc = w * c;
  const long long base = static_cast<long long>(row) * wc;
  const bool mirrored = flip[b] != 0;
  const float inv255 = 1.0f / 255.0f;
  for (int i = threadIdx.x; i < wc; i += kThreads) {
    const int x = i / c, ch = i - x * c;
    const int src = mirrored ? (w - 1 - x) * c + ch : i;
    store(out, base + i, static_cast<float>(in[base + src]) * inv255);
  }
}

}  // namespace

// images: uint8 [b, h, w, c], contiguous; flip: b bytes, non-zero where the image is
// mirrored; out: [b, h, w, c] in bf16 when bf16 is non-zero, else f32. b * h at most
// 2^31 - 1 rows. Returns a cudaError_t (0: launched).
extern "C" int lgm_normalize_flip(const void* images, const void* flip, void* out, int b,
                                  int h, int w, int c, int bf16, void* stream) {
  if (b < 1 || h < 1 || w < 1 || c < 1 || static_cast<long long>(b) * h > 0x7fffffffLL ||
      static_cast<long long>(w) * c > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* in = static_cast<const uint8_t*>(images);
  const auto* f = static_cast<const uint8_t*>(flip);
  const auto s = static_cast<cudaStream_t>(stream);
  if (bf16)
    normalize_flip_kernel<<<b * h, kThreads, 0, s>>>(in, f, static_cast<__nv_bfloat16*>(out),
                                                     h, w, c);
  else
    normalize_flip_kernel<<<b * h, kThreads, 0, s>>>(in, f, static_cast<float*>(out), h, w, c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lgm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
