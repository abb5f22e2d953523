// Flash attention forward on [b, h, n, d] operands, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel lightning_generative_models_tpu/ops/attention.py:_flash_kernel
// (launched through _flash_attention_impl, reached by scaled_dot_product_attention with
// use_pallas=True at n_kv >= 256). Same math: q cast to f32 and scaled by d^-1/2, k and v
// cast to f32, s = q k^T in f32, keys at or past n_kv masked to -inf, the online softmax's
// running max and sum in f32, o accumulated as p v in f32 (the Pallas kernel's
// p.astype(v_blk.dtype) is a cast to f32, since v_blk is already f32 there), o / l cast to
// the output type once.
//
// Operands are separate tensors read and written through their own (batch, head, token)
// strides, the last dimension contiguous: the DiT's q, k and v are [b, h, n, d] views of
// the packed [b, n, 3, h, d] or [b, n, h, 3, d] Dense output (no transpose copy), the
// UNet's are views with the memory keys in front, and o may be a [b, h, n, d] view of a
// [b, n, h, d] buffer, so that the caller's transpose back is free. n_q and n_kv are
// independent (the UNet's attention has 4 memory keys more than queries).
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): 4 b h n_q n_kv d flops
// against q, k, v read once and o written once. At DiT-S/2 (b 128, h 6, n 256, d 64, bf16)
// that is 12.9 GFLOP (13 us at the tensor-core peak) and 101 MB (30 us): bound by bytes.
//
// Design. The TPU program runs one (batch*head row, 256-query block) per grid step and
// walks the keys in blocks of 512, padded to a block multiple and masked. Here a block of
// four warps takes one (b*h row, 64-query tile) of a 1-D grid in which the query tiles of
// one row are neighbours, so that they run together and read the row's keys and values
// from L2 rather than each from device memory. Each warp owns 16 query rows. The keys and
// values stream through shared memory in f32 tiles of 64 (the ragged last tile masked in
// place, no padded copies). Both products run on the tensor cores as warp-level
// mma.sync.m16n8k8 on TF32 operands in the 3xTF32 scheme: every f32 operand x is split
// into hi = tf32(x) and lo = tf32(x - hi), and a b is taken as a_hi b_hi + a_hi b_lo +
// a_lo b_hi with f32 accumulation, which keeps the f32 products' accuracy (the dropped
// a_lo b_lo term is ~2^-22 relative); bf16 k and v are TF32 already, so in bf16 the
// products take two terms. The scores of a warp's 16 x 64 tile stay in its
// registers in the mma accumulator layout for the online softmax (row max and sum over
// the four lanes of a row); P goes through the warp's own rows of shared memory to
// become the A operand of the P V product. The [n_q, n_kv] scores never reach device
// memory. wgmma, TMA and pipelining are later work.

#include <cstdint>

#include "attention_qkv_common.cuh"

namespace {

using attn::Strides;
using attn::from_f32;
using attn::head_ptr;
using attn::mma3;
using attn::quad_max;
using attn::quad_sum;
using attn::split;
using attn::to_f32;

constexpr int kRows = 64;     // queries a block: 16 a warp
constexpr int kKeys = 64;     // keys a tile
constexpr int kThreads = 128;

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides sq, sk, sv, so;  // (batch, token, head)
  int heads, n_q, n_kv, d;
  float scale;
};

// Row strides in floats of the shared tiles. q, k and p (d + 4, or 68 for p, = 4 mod 8):
// the fragment reads (row g, column t) of the 32 lanes (g < 8, t < 4) fall in 32 banks.
// v (d + 8): the reads (row t, column g) do, for d a multiple of 32. Both keep every row
// 16-byte aligned for the float4 stores of load_rows.
__host__ __device__ constexpr int ld_qk(int d) { return d + 4; }
__host__ __device__ constexpr int ld_v(int d) { return d + 8; }
constexpr int kLdP = kKeys + 4;

size_t flash_smem(int d) {
  return sizeof(float) * (kRows * ld_qk(d) + kKeys * ld_qk(d) + kKeys * ld_v(d) + kRows * kLdP);
}

// dst[r][c] = src[row0 + r][c] * scale in f32 for r < 64, c < d; rows at or past n are 0.
// A thread moves 16-byte chunks (8 bf16 or 4 f32 of a row; the wrapper passes 16-byte
// aligned rows), up to eight at once: all eight loads are issued before the first store,
// so a tile pays the memory latency about once, not once an element.
template <typename T, int DMAX>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src, long long token,
                                          int row0, int n, int d, float scale) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kBatch = 8;
  constexpr int kPerThread = (kRows * DMAX / kVec + kThreads - 1) / kThreads;
  const int per_row = d / kVec, total = kRows * per_row;
#pragma unroll
  for (int j0 = 0; j0 < kPerThread; j0 += kBatch) {
    uint4 buf[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = threadIdx.x + (j0 + j) * kThreads;
      const int r = i / per_row, c = i - r * per_row;
      buf[j] = make_uint4(0u, 0u, 0u, 0u);
      if (j0 + j < kPerThread && i < total && row0 + r < n)
        buf[j] = *reinterpret_cast<const uint4*>(src + (row0 + r) * token + c * kVec);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = threadIdx.x + (j0 + j) * kThreads;
      if (j0 + j >= kPerThread || i >= total) break;
      const int r = i / per_row, c = i - r * per_row;
      const T* e = reinterpret_cast<const T*>(&buf[j]);
      float4* out = reinterpret_cast<float4*>(dst + r * ld + c * kVec);
#pragma unroll
      for (int u = 0; u < kVec / 4; ++u)
        out[u] = make_float4(to_f32(e[4 * u]) * scale, to_f32(e[4 * u + 1]) * scale,
                             to_f32(e[4 * u + 2]) * scale, to_f32(e[4 * u + 3]) * scale);
    }
  }
}

// The A fragment of the 16 x 8 block at column c0 of a [16][ld] f32 tile (this warp's
// rows), split: lane (g, t) holds rows g and g + 8 of columns c0 + t and c0 + t + 4.
__device__ __forceinline__ void a_fragment(const float* tile, int ld, int c0, int g, int t,
                                           uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(tile[g * ld + c0 + t], hi[0], lo[0]);
  split(tile[(g + 8) * ld + c0 + t], hi[1], lo[1]);
  split(tile[g * ld + c0 + t + 4], hi[2], lo[2]);
  split(tile[(g + 8) * ld + c0 + t + 4], hi[3], lo[3]);
}

// DMAX: d rounded up to 32, 64 or 128; the loops over d's 8-wide steps stop at d.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(FlashArgs a) {
  constexpr int kSteps = DMAX / 8;
  constexpr bool kExactB = sizeof(T) == 2;  // bf16 k and v
  extern __shared__ float smem[];
  const int d = a.d, ldq = ld_qk(d), ldv = ld_v(d);
  float* q_s = smem;               // [64][ldq]: q * scale
  float* k_s = q_s + kRows * ldq;  // [64][ldq]
  float* v_s = k_s + kKeys * ldq;  // [64][ldv]
  float* p_s = v_s + kKeys * ldv;  // [64][kLdP]: exp(s - running max), a warp's own rows
  const int q_tiles = (a.n_q + kRows - 1) / kRows;
  const int row = blockIdx.x / q_tiles;  // b * heads + h
  const int b = row / a.heads, h = row - b * a.heads;
  const int q0 = (blockIdx.x - row * q_tiles) * kRows;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* q_w = q_s + 16 * warp * ldq;
  float* p_w = p_s + 16 * warp * kLdP;

  const T* k = head_ptr<T>(a.k, a.sk, b, h);
  const T* v = head_ptr<T>(a.v, a.sv, b, h);
  load_rows<T, DMAX>(q_s, ldq, head_ptr<T>(a.q, a.sq, b, h), a.sq.token, q0, a.n_q, d,
                     a.scale);

  // Rows g (i = 0) and g + 8 (i = 1) of the warp's 16: the running max and this lane's
  // share of the running sum; o[j] the accumulator fragment of columns 8 j .. 8 j + 7.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[kSteps][4];
#pragma unroll
  for (int j = 0; j < kSteps; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int k0 = 0; k0 < a.n_kv; k0 += kKeys) {
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, DMAX>(k_s, ldq, k, a.sk.token, k0, a.n_kv, d, 1.f);
    load_rows<T, DMAX>(v_s, ldv, v, a.sv.token, k0, a.n_kv, d, 1.f);
    __syncthreads();

    // s = q k^T: eight 16 x 8 fragments, keys 8 j + 2 t and 8 j + 2 t + 1 of rows g, g + 8.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int e = 0; e < kSteps; ++e) {
      if (8 * e >= d) break;
      uint32_t a_hi[4], a_lo[4];
      a_fragment(q_w, ldq, 8 * e, g, t, a_hi, a_lo);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float* kr = k_s + (8 * j + g) * ldq + 8 * e + t;
        mma3<kExactB>(s[j], a_hi, a_lo, kr[0], kr[4]);
      }
    }

    // kv_valid: the ragged tile's missing keys score -inf (the tile has a valid key).
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (k0 + 8 * j + 2 * t + c >= a.n_kv) s[j][c] = s[j][c + 2] = -INFINITY;

    // The online softmax: new max, rescale, p = exp(s - m) to this warp's rows of p_s.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      const float m_new = fmaxf(m[i], quad_max(mx));
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile, where m is -inf
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p0 = expf(s[j][2 * i] - m_new), p1 = expf(s[j][2 * i + 1] - m_new);
        sum += p0 + p1;
        *reinterpret_cast<float2*>(p_w + (g + 8 * i) * kLdP + 8 * j + 2 * t) =
            make_float2(p0, p1);
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        o[j][2 * i] *= alpha;
        o[j][2 * i + 1] *= alpha;
      }
      m[i] = m_new;
    }
    __syncwarp();

    // o += p v over the tile's keys, eight at a time.
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      uint32_t a_hi[4], a_lo[4];
      a_fragment(p_w, kLdP, 8 * e, g, t, a_hi, a_lo);
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        if (8 * j >= d) break;
        const float* vr = v_s + (8 * e + t) * ldv + 8 * j + g;
        mma3<kExactB>(o[j], a_hi, a_lo, vr[0], vr[4 * ldv]);
      }
    }
  }

  T* out = head_ptr<T>(a.o, a.so, b, h);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float total = quad_sum(l[i]);
    const int r = q0 + 16 * warp + g + 8 * i;
    if (r >= a.n_q) continue;
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      if (8 * j >= d) break;
      T* dst = out + r * a.so.token + 8 * j + 2 * t;
      dst[0] = from_f32<T>(o[j][2 * i] / total);
      dst[1] = from_f32<T>(o[j][2 * i + 1] / total);
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const FlashArgs& a, int rows, cudaStream_t stream) {
  const size_t smem = flash_smem(a.d);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, DMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = rows * ((a.n_q + kRows - 1) / kRows);
  flash_attention_kernel<T, DMAX><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for_width(const FlashArgs& a, int rows, cudaStream_t stream) {
  if (a.d <= 32) return launch<T, 32>(a, rows, stream);
  if (a.d <= 64) return launch<T, 64>(a, rows, stream);
  return launch<T, 128>(a, rows, stream);
}

}  // namespace

// q, k, v, o: element [0, 0, 0, 0] of each [b, heads, n, d] operand. strides: 12 int64, the
// (batch, head, token) strides of q, k, v and o in elements; the last dimension is
// contiguous; q, k and v 16-byte aligned, with strides of a multiple of 16 bytes. Elements are bf16 when bf16 is non-zero, else f32; d a multiple of 8 up to
// 128; b * heads * ceil(n_q / 64) blocks at most 2^31 - 1. Returns a cudaError_t
// (0: launched).
extern "C" int lgm_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                       const void* strides, int b, int heads, int n_q,
                                       int n_kv, int d, int bf16, float scale, void* stream) {
  if (!attn::valid_shape(b, heads, n_q, n_kv, d) ||
      static_cast<long long>(b) * heads * ((n_q + kRows - 1) / kRows) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* s = static_cast<const long long*>(strides);
  const FlashArgs a{q, k, v, o,
                    {s[0], s[2], s[1]}, {s[3], s[5], s[4]}, {s[6], s[8], s[7]},
                    {s[9], s[11], s[10]},
                    heads, n_q, n_kv, d, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 != 0 ? launch_for_width<__nv_bfloat16>(a, b * heads, st)
                                    : launch_for_width<float>(a, b * heads, st));
}

extern "C" const char* lgm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
