// Multi-head softmax attention forward, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel lightning_generative_models_tpu/ops/attention.py:
// _vmem_attn_fwd_kernel (launched through _vmem_attention_fwd_impl). Same math: each head's
// q, k and v slices cast to f32, q scaled by d^-1/2, s = q k^T, a softmax over the keys in
// f32, o = p v in f32, cast to the output type.
//
// Operands are read in place through (batch, token, head) strides: the packed
// [b, n, 3 h d] Dense output in either layout (s3hd: head stride d; h3d: head stride 3 d),
// with no head transpose, or any [b, h, n, d] tensor. The output is written through its own
// strides ([b, n, h d] for the packed call).
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): 4 b h n^2 d flops against
// the packed qkv read once and the output written once. At DiT-S/2 (b 128, n 256, h 6,
// d 64, bf16) that is 12.9 GFLOP (13 us at the tensor-core peak) and 101 MB (30 us): bound
// by bytes, by a little.
//
// Design. The TPU program keeps a whole batch row, all heads and the [n, n] scores in VMEM
// and relies on its grid running in order. Here a block takes one (64-query tile, head,
// batch row); the keys and values stream through shared memory in tiles of 64 with an
// online softmax (a running max and sum per query row, the accumulator rescaled when the
// max grows), so the [n, n] scores never reach device memory and any n is taken (the
// ragged last tile is masked). Products are f32 FMA loops on the CUDA cores: right and
// simple first, far from the bound. Tensor cores (mma/wgmma on bf16 tiles), TMA and
// pipelining are later work.

#include "attention_qkv_common.cuh"

namespace {

using namespace attn;

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides sq, sk, sv, so;
  int n_q, n_kv, d;
  float scale;
};

size_t fwd_smem(int d) {
  return sizeof(float) * (3 * kTile * (d + 1) + kTile * kLdP);
}

template <typename T, int NCOL>
__global__ void __launch_bounds__(kThreads) attention_fwd_kernel(FwdArgs a) {
  extern __shared__ float smem[];
  const int d = a.d, ld = d + 1;
  float* q_s = smem;              // [64][ld]: q * scale
  float* k_s = q_s + kTile * ld;  // [64][ld]
  float* v_s = k_s + kTile * ld;  // [64][ld]
  float* p_s = v_s + kTile * ld;  // [64][kLdP]: exp(s - running max)
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;

  const T* q = head_ptr<T>(a.q, a.sq, b, h);
  const T* k = head_ptr<T>(a.k, a.sk, b, h);
  const T* v = head_ptr<T>(a.v, a.sv, b, h);
  load_tile(q_s, ld, q, a.sq.token, q0, a.n_q, d, a.scale);

  float m[4], l[4], acc[4][NCOL];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < a.n_kv; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
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
  store_rows(head_ptr<T>(a.o, a.so, b, h), a.so.token, q0, a.n_q, d, acc, l, true);
}

struct LaunchFwd {
  const FwdArgs& a;
  int b, heads;
  cudaStream_t stream;

  template <typename T, int NCOL>
  cudaError_t operator()() const {
    const size_t smem = fwd_smem(a.d);
    cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel<T, NCOL>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid((a.n_q + kTile - 1) / kTile, heads, b);
    attention_fwd_kernel<T, NCOL><<<grid, kThreads, smem, stream>>>(a);
    return cudaGetLastError();
  }
};

}  // namespace

// q, k, v: head 0 of batch row 0 of each operand; o likewise. strides: 12 int64, the
// (batch, token, head) strides of q, k, v and o in elements. Elements are bf16 when bf16 is
// non-zero, else f32; d a multiple of 8 up to 128. Returns a cudaError_t (0: launched).
extern "C" int lgm_attention_qkv_fwd(const void* q, const void* k, const void* v, void* o,
                                     const void* strides, int b, int heads, int n_q, int n_kv,
                                     int d, int bf16, float scale, void* stream) {
  if (!valid_shape(b, heads, n_q, n_kv, d)) return static_cast<int>(cudaErrorInvalidValue);
  const long long* s = static_cast<const long long*>(strides);
  const FwdArgs a{q, k, v, o,
                  {s[0], s[1], s[2]}, {s[3], s[4], s[5]}, {s[6], s[7], s[8]}, {s[9], s[10], s[11]},
                  n_q, n_kv, d, scale};
  return static_cast<int>(
      dispatch(bf16 != 0, d, LaunchFwd{a, b, heads, static_cast<cudaStream_t>(stream)}));
}

extern "C" const char* lgm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
