// VQ codebook nearest-neighbour search, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel lightning_generative_models_tpu/ops/vq.py:_vq_kernel (launched
// through nearest_codes_pallas). Same function:
//
//   out[n] = argmin_k ( ||e_k||^2 - 2 z_n . e_k ),   z = flat [N, D], e = codebook [K, D],
//
// in f32, with the first index on ties (jnp.argmin's rule). The ||z_n||^2 term is constant
// over a row and dropped, as in the TPU kernel. ||e_k||^2 is summed here, in f32, from the
// codebook tile in shared memory, so the search is one launch.
//
// What bounds it on an H100 SXM (67 TFLOP/s f32 on the CUDA cores, 3.35 TB/s): it does
// 2*N*K*D flops and moves 4*(N*D + K*D + N) bytes. At the VQ-VAE's shapes (K = 512,
// D = 64) that is 64 K flops per byte of latents: operations bound, 4.0 us at N = 4,096
// (268 MFLOP) against 0.36 us of bytes.
//
// Design, simple first. The TPU program holds the whole codebook in VMEM and forms a
// [block_n, K] score tile with one MXU product. Here a block of 256 threads takes 32 latent
// rows; eight lanes share a row, and each holds the row's D values in registers. The block
// streams the codebook through shared memory in tiles of 64 codes, in increasing k (rows
// padded to D + 1 floats, so the eight lanes' codes fall in different banks). Lane l of a row
// scores the codes l, l + 8, l + 16, ... of each tile as an f32 FMA loop over d and keeps a
// running (best, index) pair, replaced only on a strict '<': within a lane the lowest index
// wins a tie. The eight lanes then merge by warp shuffles, taking the lower index on equal
// scores, so the result is the first index over all k. No float atomics: repeats are bit
// identical. Tensor-core tiles (a TF32 pass with an f32 re-check of near ties) and TMA are
// later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kLanes = 8;                       // threads that share a latent row
constexpr int kRowsPerBlock = 32;
constexpr int kThreads = kLanes * kRowsPerBlock;  // 256
constexpr int kCodeTile = 64;                   // codes per shared-memory tile

template <int D>
__global__ void __launch_bounds__(kThreads)
vq_nearest_kernel(const float* __restrict__ flat, const float* __restrict__ codebook,
                  int* __restrict__ out, int n, int k) {
  __shared__ float cb_s[kCodeTile][D + 1];
  __shared__ float cb_sq_s[kCodeTile];

  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int row = blockIdx.x * kRowsPerBlock + tid / kLanes;
  const bool live = row < n;

  float z[D];
  {
    const float4* zr = reinterpret_cast<const float4*>(flat + static_cast<size_t>(live ? row : 0) * D);
#pragma unroll
    for (int q = 0; q < D / 4; ++q) {
      const float4 v = zr[q];
      z[4 * q] = v.x;
      z[4 * q + 1] = v.y;
      z[4 * q + 2] = v.z;
      z[4 * q + 3] = v.w;
    }
  }

  float best = INFINITY;
  int best_idx = 0;
  bool found = false;

  for (int k0 = 0; k0 < k; k0 += kCodeTile) {
    const int tile = min(kCodeTile, k - k0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < tile * D; i += kThreads) {
      const int c = i / D, d = i % D;
      cb_s[c][d] = codebook[static_cast<size_t>(k0 + c) * D + d];
    }
    __syncthreads();
    if (tid < tile) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) s = fmaf(cb_s[tid][d], cb_s[tid][d], s);
      cb_sq_s[tid] = s;
    }
    __syncthreads();
    for (int c = lane; c < tile; c += kLanes) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(z[d], cb_s[c][d], dot);
      const float score = cb_sq_s[c] - 2.0f * dot;
      // Strict '<' in increasing k: the first of equal scores stays. The first score is
      // taken whatever it is, so a row of NaN scores still returns a code of the book.
      if (!found || score < best) {
        best = score;
        best_idx = k0 + c;
        found = true;
      }
    }
  }

  // Merge the eight lanes of the row (consecutive lanes of one warp): the lower score
  // wins, and the lower index on equal scores. A lane that scored no code (k < 8) loses.
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) {
    const float ob = __shfl_down_sync(0xffffffffu, best, o, kLanes);
    const int oi = __shfl_down_sync(0xffffffffu, best_idx, o, kLanes);
    const int of = __shfl_down_sync(0xffffffffu, static_cast<int>(found), o, kLanes);
    if (of && (!found || ob < best || (ob == best && oi < best_idx))) {
      best = ob;
      best_idx = oi;
      found = true;
    }
  }
  if (live && lane == 0) out[row] = best_idx;
}

template <int D>
cudaError_t launch(const float* flat, const float* codebook, int* out, int n, int k,
                   cudaStream_t stream) {
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  vq_nearest_kernel<D><<<blocks, kThreads, 0, stream>>>(flat, codebook, out, n, k);
  return cudaGetLastError();
}

}  // namespace

// flat [n, d] f32, codebook [k, d] f32, both contiguous; out [n] int32. d in {8, 16, 32,
// 64, 128}, n >= 1, k >= 1. Returns a cudaError_t (0: launched).
extern "C" int lgm_vq_nearest(const void* flat, const void* codebook, void* out, int n,
                              int k, int d, void* stream) {
  const float* z = static_cast<const float*>(flat);
  const float* e = static_cast<const float*>(codebook);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 8: return static_cast<int>(launch<8>(z, e, o, n, k, s));
    case 16: return static_cast<int>(launch<16>(z, e, o, n, k, s));
    case 32: return static_cast<int>(launch<32>(z, e, o, n, k, s));
    case 64: return static_cast<int>(launch<64>(z, e, o, n, k, s));
    case 128: return static_cast<int>(launch<128>(z, e, o, n, k, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* lgm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
