// Shared pieces of the softmax-attention kernels (attention_qkv.cu, attention_qkv_bwd.cu).
//
// A block of 256 threads works on 64 x 64 tiles: thread (ty, tx) = (tid / 16, tid % 16)
// owns rows ty + 16 i (i < 4) and columns tx + 16 j (j < 4) of a score tile, and rows
// ty + 16 i, columns tx + 16 m (m < NCOL = ceil(d / 16)) of a [64, d] accumulator. The 16
// threads of a row are 16 consecutive lanes of one warp, so a row's max and sum are warp
// shuffles. Tiles sit in shared memory as f32 rows of d + 1 floats (d is a multiple of 8,
// so the stride is odd and the 16 rows read at once fall in 16 different banks). Products
// are FMA loops in f32 over the inputs cast to f32, which is the Pallas kernels' math
// (operands cast to f32, f32 dots).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstddef>

namespace attn {

constexpr int kTile = 64;          // queries a block, keys a tile
constexpr int kThreads = 256;      // 16 x 16
constexpr int kMaxD = 128;         // head width, a multiple of 8
constexpr int kLdP = kTile + 1;    // row stride of a [64, 64] score tile in shared memory

// (batch, token, head) strides of one operand, in elements.
struct Strides {
  long long batch, token, head;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__device__ __forceinline__ const T* head_ptr(const void* base, const Strides& s, int b, int h) {
  return static_cast<const T*>(base) + b * s.batch + h * s.head;
}

template <typename T>
__device__ __forceinline__ T* head_ptr(void* base, const Strides& s, int b, int h) {
  return static_cast<T*>(base) + b * s.batch + h * s.head;
}

// dst[r][c] = src[row0 + r][c] * scale in f32 for r < 64, c < d; rows at or past n are 0.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, long long token,
                                          int row0, int n, int d, float scale) {
  for (int i = threadIdx.x; i < kTile * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    const int row = row0 + r;
    dst[r * ld + c] = row < n ? to_f32(src[row * token + c]) * scale : 0.f;
  }
}

// s[i][j] = a[ty + 16 i] . b[tx + 16 j] over d features; a and b are [64][ld] tiles.
__device__ __forceinline__ void tile_dots(float (&s)[4][4], const float* a, const float* b,
                                          int ld, int d) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int e = 0; e < d; ++e) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * ld + e];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * ld + e];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// acc[i][m] += sum over j < 64 of p[ty + 16 i][j] * v[j][tx + 16 m]; p is a [64][kLdP]
// score tile, v a [64][ld] tile. Columns at or past d are left alone.
template <int NCOL>
__device__ __forceinline__ void tile_matmul(float (&acc)[4][NCOL], const float* p,
                                            const float* v, int ld, int d) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int j = 0; j < kTile; ++j) {
    float pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = p[(ty + 16 * i) * kLdP + j];
#pragma unroll
    for (int m = 0; m < NCOL; ++m) {
      const int col = tx + 16 * m;
      const float vv = (m < NCOL - 1 || col < d) ? v[j * ld + col] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][m] = fmaf(pv[i], vv, acc[i][m]);
    }
  }
}

// Max and sum over the 16 lanes of a row. Every lane ends with the same bits: a butterfly
// adds the same pairs in every lane, and a + b == b + a.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o, 16));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o, 16);
  return x;
}

// One key tile of the online softmax (flash attention's recurrence). s holds this thread's
// scores, -inf for keys past n_kv; the tile has at least one valid key. Updates each row's
// running max m and sum l, rescales acc to the new max, and writes exp(s - m) to p_s.
template <int NCOL>
__device__ __forceinline__ void online_softmax_tile(float (&s)[4][4], float (&m)[4],
                                                    float (&l)[4], float (&acc)[4][NCOL],
                                                    float* p_s) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float mx = row_max(fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])));
    const float m_new = fmaxf(m[i], mx);
    const float alpha = expf(m[i] - m_new);  // 0 on the first tile, where m is -inf
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = expf(s[i][j] - m_new);
      sum += p;
      p_s[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
    }
    l[i] = l[i] * alpha + row_sum(sum);
#pragma unroll
    for (int c = 0; c < NCOL; ++c) acc[i][c] *= alpha;
    m[i] = m_new;
  }
}

// Scores of keys at or past n_kv (this thread's columns of the tile at k0) to -inf.
__device__ __forceinline__ void mask_keys(float (&s)[4][4], int k0, int n_kv) {
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (k0 + tx + 16 * j >= n_kv) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][j] = -INFINITY;
    }
}

// Write acc[i][m] * mul[i] to rows row0 + ty + 16 i (< n) of a [n, d] slice, in T.
template <typename T, int NCOL>
__device__ __forceinline__ void store_rows(T* dst, long long token, int row0, int n, int d,
                                           const float (&acc)[4][NCOL], const float (&mul)[4],
                                           bool divide) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= n) continue;
#pragma unroll
    for (int m = 0; m < NCOL; ++m) {
      const int col = tx + 16 * m;
      if (col < d) {
        const float x = divide ? acc[i][m] / mul[i] : acc[i][m] * mul[i];
        dst[row * token + col] = from_f32<T>(x);
      }
    }
  }
}

// Calls f.template operator()<T, NCOL>() for the run-time element type and head width.
template <typename F>
cudaError_t dispatch(bool bf16, int d, F&& f) {
  const int ncol = (d + 15) / 16;
#define LGM_ATTN_CASE(N)                                                          \
  case N:                                                                         \
    return bf16 ? f.template operator()<__nv_bfloat16, N>()                       \
                : f.template operator()<float, N>();
  switch (ncol) {
    LGM_ATTN_CASE(1)
    LGM_ATTN_CASE(2)
    LGM_ATTN_CASE(3)
    LGM_ATTN_CASE(4)
    LGM_ATTN_CASE(5)
    LGM_ATTN_CASE(6)
    LGM_ATTN_CASE(7)
    LGM_ATTN_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef LGM_ATTN_CASE
}

inline bool valid_shape(int b, int heads, int n_q, int n_kv, int d) {
  return b >= 1 && b <= 65535 && heads >= 1 && heads <= 65535 && n_q >= 1 && n_kv >= 1 &&
         d >= 8 && d <= kMaxD && d % 8 == 0;
}

}  // namespace attn
