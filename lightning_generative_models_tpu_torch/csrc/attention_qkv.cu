// Multi-head softmax attention forward, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel lightning_generative_models_tpu/ops/attention.py:
// _vmem_attn_fwd_kernel (launched through _vmem_attention_fwd_impl). Same math: each head's
// q, k and v slices cast to f32, s = (q * d^-1/2) k^T, a softmax over the keys in f32,
// o = p v in f32, cast to the output type once. (Here the raw q k^T is multiplied by the
// scale in f32: d^-1/2 is not a power of two at d = 48, so q * scale would not be exact
// in bf16; the two differ by one f32 rounding.)
//
// Operands are read in place through (batch, token, head) strides: the packed
// [b, n, 3 h d] Dense output in either layout (s3hd: head stride d; h3d: head stride 3 d),
// with no head transpose, or any [b, h, n, d] tensor. Rows are read as 16-byte chunks, so
// each operand's first element and token stride are 16-byte aligned (the wrapper copies
// otherwise). The output is written through its own strides ([b, n, h d] for the packed
// call).
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): 4 b h n^2 d flops against
// the packed qkv read once and the output written once. At DiT-S/2 (b 128, n 256, h 6,
// d 64, bf16) that is 12.9 GFLOP (13 us at the tensor-core peak) and 101 MB (30 us): bound
// by bytes, by a little.
//
// Design. The TPU program keeps a whole batch row, all heads and the [n, n] scores in VMEM
// and relies on its grid running in order. Here a block takes one (b*h row, query tile)
// of a 1-D grid in which the query tiles of one row are neighbours (they run together and
// read the row's keys and values from L2). Each warp owns 16 query rows: a block of four
// warps takes 64 queries in bf16, one of eight 128 in f32 (kWarps).
//  - Keys and values stream in 64-row tiles through a ring of two shared-memory stages in
//    the operands' own type, filled by cp.async: the next tile's copy is in flight while
//    this tile's products run. The ragged last tile is zero-filled by the copy and its
//    missing keys masked to -inf.
//  - S = q k^T on the tensor cores. bf16: q and k are exact bf16 operands of
//    mma.m16n8k16 (fragments by ldmatrix), one product a step and nothing split. f32:
//    3xTF32 on mma.m16n8k8.
//  - The online softmax (running max and sum per row, the accumulator rescaled when the
//    max grows) on the scores in registers, in the accumulator layout; a row's max and
//    sum are reduced over the four lanes of its quad.
//  - P V with P taken from those registers as the A operand: no trip through shared
//    memory. In bf16 a warp splits only its own P (hi + lo against the exact bf16 v,
//    fragments by ldmatrix.trans), and q, k and v are never split. In f32 every operand
//    is split (TF32 hi + lo), the tiles' fragments by each warp as it reads them, and P V
//    takes P with the k index permuted so that the accumulator layout is the A layout.
// The [n_q, n_kv] scores never reach device memory, and any n is taken. flash_attention.cu
// (kernel #5) computes the same function with its own, older design (f32 tiles loaded
// before the products, K/V fragments split by every warp, P through shared memory).

#include "attention_qkv_common.cuh"

namespace {

using namespace attn;

constexpr int kKeys = 64;     // keys a tile
constexpr int kStages = 2;    // the K/V ring

// Warps a block, 16 query rows each: four in bf16; eight in f32, whose twice larger K/V
// tiles then serve twice the queries for the same shared memory, which kept more warps
// on an H100's SMs and the f32 call faster; in bf16 four were as fast or faster.
template <typename T>
constexpr int kWarps = sizeof(T) == 2 ? 4 : 8;
template <typename T>
constexpr int kRows = 16 * kWarps<T>;  // queries a block
template <typename T>
constexpr int kThreads = 32 * kWarps<T>;

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides sq, sk, sv, so;
  int heads, n_q, n_kv, d;
  float scale;
};

template <typename T>
size_t fwd_smem(int d) {
  return sizeof(T) * tile_ld<T>(d) * (kRows<T> + kStages * 2 * kKeys);
}

// DMAX: d rounded up to 32, 64 or 128; the loops over d stop at d.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads<T>) attention_fwd_kernel(FwdArgs a) {
  constexpr int kRowsT = kRows<T>, kThreadsT = kThreads<T>;
  constexpr int kNT = DMAX / 8;  // 8-column tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d = a.d, ld = tile_ld<T>(d);
  T* q_s = reinterpret_cast<T*>(smem_raw);  // [kRowsT][ld]
  T* kv_s = q_s + kRowsT * ld;              // kStages x {k [64][ld], v [64][ld]}
  const int q_tiles = (a.n_q + kRowsT - 1) / kRowsT;
  const int row = blockIdx.x / q_tiles;  // b * heads + h
  const int b = row / a.heads, h = row - b * a.heads;
  const int q0 = (blockIdx.x - row * q_tiles) * kRowsT;
  const int r0 = 16 * (threadIdx.x >> 5), t = threadIdx.x & 3;

  const T* k = head_ptr<T>(a.k, a.sk, b, h);
  const T* v = head_ptr<T>(a.v, a.sv, b, h);
  const auto load_kv = [&](int tile, int stage) {
    T* k_dst = kv_s + stage * 2 * kKeys * ld;
    load_tile_async<T, kKeys, DMAX, kThreadsT>(k_dst, ld, k, a.sk.token, tile * kKeys,
                                              a.n_kv, d);
    load_tile_async<T, kKeys, DMAX, kThreadsT>(k_dst + kKeys * ld, ld, v, a.sv.token,
                                              tile * kKeys, a.n_kv, d);
  };
  zero_k_padding(q_s, kRowsT + kStages * 2 * kKeys, ld, d);
  load_tile_async<T, kRowsT, DMAX, kThreadsT>(q_s, ld, head_ptr<T>(a.q, a.sq, b, h),
                                            a.sq.token, q0, a.n_q, d);
  load_kv(0, 0);
  cp_async_commit();

  // Rows g (i = 0) and g + 8 (i = 1) of the warp's 16: the running max and this lane's
  // share of the running sum; o[j] the accumulator tile of columns 8 j .. 8 j + 7.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  const int n_tiles = (a.n_kv + kKeys - 1) / kKeys;
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_kv(it + 1, (it + 1) % kStages);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and q) landed; the next one may be in flight
    __syncthreads();
    const T* k_s = kv_s + (it % kStages) * 2 * kKeys * ld;
    const T* v_s = k_s + kKeys * ld;
    const int k0 = it * kKeys;

    float s[8][4];
    rows_dot_rows<DMAX>(s, q_s, k_s, ld, r0, d);
    const bool ragged = k0 + kKeys > a.n_kv;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[j][c] *= a.scale;
        if (ragged && k0 + 8 * j + 2 * t + (c & 1) >= a.n_kv) s[j][c] = -INFINITY;
      }

    // The online softmax: new max, rescale, s becomes p = exp(s - m).
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      const float m_new = fmaxf(m[i], quad_max(mx));  // finite: the tile has a valid key
      const float alpha = expf(m[i] - m_new);         // 0 on the first tile
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][2 * i] = expf(s[j][2 * i] - m_new);
        s[j][2 * i + 1] = expf(s[j][2 * i + 1] - m_new);
        sum += s[j][2 * i] + s[j][2 * i + 1];
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        o[j][2 * i] *= alpha;
        o[j][2 * i + 1] *= alpha;
      }
      m[i] = m_new;
    }

    acc_times_tile(o, s, v_s, ld, d);
    __syncthreads();  // this stage's readers are done before the copy of tile it + 2
  }

  const float inv0 = 1.f / quad_sum(l[0]), inv1 = 1.f / quad_sum(l[1]);
  store_acc_rows(head_ptr<T>(a.o, a.so, b, h), a.so.token, q0 + r0, a.n_q, d, o, inv0, inv1);
}

template <typename T, int DMAX>
cudaError_t launch(const FwdArgs& a, int rows, cudaStream_t stream) {
  const size_t smem = fwd_smem<T>(a.d);
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel<T, DMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = rows * ((a.n_q + kRows<T> - 1) / kRows<T>);
  attention_fwd_kernel<T, DMAX><<<blocks, kThreads<T>, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for_width(const FwdArgs& a, int rows, cudaStream_t stream) {
  if (a.d <= 32) return launch<T, 32>(a, rows, stream);
  if (a.d <= 64) return launch<T, 64>(a, rows, stream);
  return launch<T, 128>(a, rows, stream);
}

}  // namespace

// q, k, v: head 0 of batch row 0 of each operand; o likewise. strides: 12 int64, the
// (batch, token, head) strides of q, k, v and o in elements; q, k and v 16-byte aligned
// with token strides of a multiple of 16 bytes. Elements are bf16 when bf16 is non-zero,
// else f32; d a multiple of 8 up to 128; b * heads * ceil(n_q / 64) at most 2^31 - 1.
// Returns a cudaError_t (0: launched).
extern "C" int lgm_attention_qkv_fwd(const void* q, const void* k, const void* v, void* o,
                                     const void* strides, int b, int heads, int n_q, int n_kv,
                                     int d, int bf16, float scale, void* stream) {
  if (!valid_shape(b, heads, n_q, n_kv, d) ||
      static_cast<long long>(b) * heads * ((n_q + 63) / 64) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* s = static_cast<const long long*>(strides);
  const FwdArgs a{q, k, v, o,
                  {s[0], s[1], s[2]}, {s[3], s[4], s[5]}, {s[6], s[7], s[8]}, {s[9], s[10], s[11]},
                  heads, n_q, n_kv, d, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 != 0 ? launch_for_width<__nv_bfloat16>(a, b * heads, st)
                                    : launch_for_width<float>(a, b * heads, st));
}

extern "C" const char* lgm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
