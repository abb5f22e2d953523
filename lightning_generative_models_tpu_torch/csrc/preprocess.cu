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
// written per element, one flop: at 128 x 32 x 32 x 3 in f32 that is 1.97 MB, 0.59 us; at
// 1024 x 64 x 64 x 3, 62.9 MB (beyond the 50 MB L2), 18.8 us.
//
// Design: bandwidth first. The TPU program turns the flip into a [W*C, W*C] permutation
// matmul on the MXU because Mosaic has no reverse; here the flip is an index.
// - A work item is a band of whole rows of one image: the image itself up to kBandBytes of
//   input (32 x 32 x 3: 3,072 bytes), else about kBandBytes of its rows. Blocks walk the
//   items with a grid stride, so one launch covers any batch.
// - The band's bytes are contiguous. The block copies them into shared memory with 16-byte
//   loads; the unaligned head and tail (under 16 bytes each) go byte by byte. The copy keeps
//   the global address's offset mod 16, so that the vector part lands aligned.
// - Each thread then writes V consecutive outputs with one 16-byte store (4 f32 or 8 bf16),
//   neighbouring threads on neighbouring addresses, reading each output's (mirrored) source
//   byte from shared memory.
// - C is a template parameter for C = 1 and 3 (the pixel index is a division by a
//   constant); C = 0 instantiates the same code with C read at run time.
// - The flip byte is read once a work item, by one thread, into shared memory.
// - A row wider than the tile (W*C > kTileBytes - 16) is read straight from global memory
//   (kStaged false), with the same stores: no shape is refused for its width.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBandBytes = 4096;   // input bytes a work item aims at
constexpr int kTileBytes = 16384;  // shared tile: the largest band, plus 16 for alignment
constexpr int kBlocksPerSm = 8;    // 8 x 256 threads: the SM's 2,048

__device__ __forceinline__ void store_vec(float* out, const float (&v)[4]) {
  *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* out, const float (&v)[8]) {
  uint4 packed;
  uint32_t* words = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 pair = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    words[k] = *reinterpret_cast<const uint32_t*>(&pair);
  }
  *reinterpret_cast<uint4*>(out) = packed;
}
__device__ __forceinline__ void store_one(float* out, float x) { *out = x; }
__device__ __forceinline__ void store_one(__nv_bfloat16* out, float x) {
  *out = __float2bfloat16_rn(x);
}

// Index in the band of the source byte of band element i (row-major, rows of wc bytes).
template <int C>
__device__ __forceinline__ int source(int i, bool mirrored, int w, int c, int wc) {
  if (!mirrored) return i;
  const int cc = C > 0 ? C : c;
  const int row = i / wc;
  const int j = i - row * wc;
  const int x = j / cc;
  return row * wc + (w - 1 - x) * cc + (j - x * cc);
}

template <int C, bool kStaged, typename T>
__global__ void __launch_bounds__(kThreads)
    normalize_flip_kernel(const uint8_t* __restrict__ in, const uint8_t* __restrict__ flip,
                          T* __restrict__ out, int h, int w, int c, int band_rows,
                          int bands_per_image, long long items) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));  // outputs per 16-byte store
  __shared__ __align__(16) uint8_t tile[kStaged ? kTileBytes : 16];
  __shared__ int mirrored_s;
  const int cc = C > 0 ? C : c;
  const int wc = w * cc;
  const int t = threadIdx.x;
  const float inv255 = 1.0f / 255.0f;

  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const long long b = item / bands_per_image;
    const int row0 = static_cast<int>(item - b * bands_per_image) * band_rows;
    const int n = min(band_rows, h - row0) * wc;  // the band's bytes and outputs
    const long long e0 = (b * h + row0) * wc;     // its first element
    const uint8_t* src = in + e0;
    if (t == 0) mirrored_s = flip[b] != 0;

    const uint8_t* band = src;
    if constexpr (kStaged) {
      // tile[shift + k] = src[k], with shift = src's address mod 16.
      const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
      const int head = min(n, (16 - shift) & 15);
      const int nvec = (n - head) >> 4;
      const int tail0 = head + (nvec << 4);
      const uint4* src_vec = reinterpret_cast<const uint4*>(src + head);
      uint4* tile_vec = reinterpret_cast<uint4*>(tile + shift + head);  // 16-aligned
      for (int k = t; k < nvec; k += kThreads) tile_vec[k] = __ldg(src_vec + k);
      if (t < head) tile[shift + t] = src[t];
      if (t >= 16 && t - 16 < n - tail0) tile[shift + tail0 + t - 16] = src[tail0 + t - 16];
      band = tile + shift;
    }
    __syncthreads();
    const bool mirrored = mirrored_s != 0;

    // Outputs e0 + i, i in [0, n): a scalar head up to the first V-aligned element, V at a
    // time, then a scalar tail (each under V elements).
    const int ohead = min(n, static_cast<int>((V - e0 % V) % V));
    const int onvec = (n - ohead) / V;
    const int otail0 = ohead + onvec * V;
    T* dst = out + e0;
    for (int k = t; k < onvec; k += kThreads) {
      const int i = ohead + k * V;
      float v[V];
      if (!mirrored) {
#pragma unroll
        for (int u = 0; u < V; ++u) v[u] = static_cast<float>(band[i + u]) * inv255;
      } else {
        const int row = i / wc;  // one division a store; the V outputs share a row unless
        const int j = i - row * wc;  // W*C is no multiple of V
        const uint8_t* row_in = band + row * wc + (w - 1) * cc;
        if (j + V <= wc) {
#pragma unroll
          for (int u = 0; u < V; ++u) {
            const int x = (j + u) / cc;  // a constant divisor for C = 1, 3
            v[u] = static_cast<float>(row_in[j + u - 2 * x * cc]) * inv255;
          }
        } else {
#pragma unroll
          for (int u = 0; u < V; ++u)
            v[u] = static_cast<float>(band[source<C>(i + u, true, w, cc, wc)]) * inv255;
        }
      }
      store_vec(dst + i, v);
    }
    if (t < ohead)
      store_one(dst + t, static_cast<float>(band[source<C>(t, mirrored, w, cc, wc)]) * inv255);
    if (t >= 32 && t - 32 < n - otail0) {
      const int i = otail0 + t - 32;
      store_one(dst + i, static_cast<float>(band[source<C>(i, mirrored, w, cc, wc)]) * inv255);
    }
    __syncthreads();  // the tile and the flag are refilled by the next item
  }
}

template <typename T>
cudaError_t launch(const uint8_t* in, const uint8_t* flip, T* out, int b, int h, int w, int c,
                   cudaStream_t s) {
  const long long wc = static_cast<long long>(w) * c;
  const bool staged = wc + 16 <= kTileBytes;
  int band_rows = 1;
  if (staged) {  // about kBandBytes a band, whole rows, at most a tile
    const long long bands = (static_cast<long long>(h) * wc + kBandBytes - 1) / kBandBytes;
    band_rows = static_cast<int>((h + bands - 1) / bands);
    band_rows = static_cast<int>(
        band_rows * wc + 16 <= kTileBytes ? band_rows : (kTileBytes - 16) / wc);
  }
  const int bands_per_image = (h + band_rows - 1) / band_rows;
  const long long items = static_cast<long long>(b) * bands_per_image;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int grid = static_cast<int>(items < static_cast<long long>(sms) * kBlocksPerSm
                                        ? items
                                        : static_cast<long long>(sms) * kBlocksPerSm);
#define LGM_LAUNCH(CC, STAGED)                                                             \
  normalize_flip_kernel<CC, STAGED, T>                                                     \
      <<<grid, kThreads, 0, s>>>(in, flip, out, h, w, c, band_rows, bands_per_image, items)
  if (staged) {
    if (c == 3) LGM_LAUNCH(3, true);
    else if (c == 1) LGM_LAUNCH(1, true);
    else LGM_LAUNCH(0, true);
  } else {
    if (c == 3) LGM_LAUNCH(3, false);
    else if (c == 1) LGM_LAUNCH(1, false);
    else LGM_LAUNCH(0, false);
  }
#undef LGM_LAUNCH
  return cudaGetLastError();
}

__global__ void empty_kernel() {}

}  // namespace

// images: uint8 [b, h, w, c], contiguous; flip: b bytes, non-zero where the image is
// mirrored; out: [b, h, w, c] in bf16 when bf16 is non-zero, else f32, 16-byte aligned.
// b * h at most 2^31 - 1 rows, w * c below 2^31. Returns a cudaError_t (0: launched).
extern "C" int lgm_normalize_flip(const void* images, const void* flip, void* out, int b,
                                  int h, int w, int c, int bf16, void* stream) {
  if (b < 1 || h < 1 || w < 1 || c < 1 || static_cast<long long>(b) * h > 0x7fffffffLL ||
      static_cast<long long>(w) * c > 0x7fffffffLL ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* in = static_cast<const uint8_t*>(images);
  const auto* f = static_cast<const uint8_t*>(flip);
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch(in, f, static_cast<__nv_bfloat16*>(out), b, h, w, c, s)
           : launch(in, f, static_cast<float*>(out), b, h, w, c, s);
  return static_cast<int>(err);
}

// An empty kernel of `blocks` blocks of 256 threads: the launch floor that chip_smoke.py
// times beside this kernel. Returns a cudaError_t (0: launched).
extern "C" int lgm_empty_launch(int blocks, void* stream) {
  empty_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lgm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
