// Fused linear-attention block backward, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel lightning_generative_models_tpu/ops/linear_attention.py:_bwd_kernel
// (launched through _pallas_backward). It recomputes the forward (see linear_attention.cu)
// and returns dx and the f32 gradients of g0, Wqkv, mem_kv, Wo, bo and g1, rounding to the
// compute type T exactly where _bwd_kernel rounds: xn, v, ke, me, memv, context, qs, a,
// dy, da, du and dp. Everything else is f32; ke is rounded against the row's final max,
// and dk = ke dke takes ke in f32, as _bwd_kernel does.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): per token 3072 * c + 49152
// flops (the forward's products again, then dWo, da, dqs, dcontext, dke, dv, dxn and dW,
// per head) against 3 * c * sizeof(T) bytes of activations (x, dout, dx). In bf16 at
// [128, 1024, 64] that is 32.2 GFLOP (32.6 us) against 50 MB (15.0 us): operations bound.
//
// Design (the shared pieces in linear_attention_common.cuh). The TPU kernel sums every
// weight gradient into output blocks that stay resident across its sequential grid. CUDA
// blocks run concurrently and in no order, so every cross-block sum is a per-block
// partial, summed later in a fixed order, and no float atomics are used: two calls on the
// same inputs give the same bits. Every product is mma.sync on the tensor cores: bf16
// m16n8k16 on operands already rounded to bf16, 3xTF32 m16n8k8 in f32. A block of four
// warps takes a chunk of a row's 16-token subtiles (Plan), one subtile at a time: per-head
// work by warp h, the full-width products split by columns between the warps. Ten launches
// on one stream, with programmatic dependent launch:
//  (1-4) prep, kmax, context, merge: as the forward (one RMSNorm and one projection a
//      subtile), xn kept in T for (5) and (8); the merge also keeps C in f32, z and kmax;
//  (5) token pass A: q, pq, qs and a = qs Cc for head h; y = a Wo + bo and dy through the
//      second RMSNorm for a quarter of the columns; da = dy Woᵀ, dqs = da Ccᵀ and dq for
//      head h; a, dy and dq (into dp) in T for the later passes; per-block partials of dbo,
//      dg1 and dC = qsᵀ da (in registers);
//  (6) dC merge, a (row, head) a block: du = dC / z, dz = -sum(dC C) / z, and the memory
//      tokens' gradients (this row's share) as tensor-core products;
//  (7) token pass B: k and v again for head h, dk = ke (v duᵀ + dz) and dv = ke du from
//      registers, dp = [dq, dk, dv] in T; dxn = dp Wqkvᵀ for a quarter of the columns, dx
//      through the first RMSNorm (+ dout with the residual); a per-block partial of dg0;
//  (8, 9) dW = xnᵀ dp and dWo = aᵀ dy: a 64-row output tile a block, the tokens in a fixed
//      number of chunks streamed through a cp.async ring, one partial per chunk;
//  (10) one launch of fixed-order sums: dW, dWo, dbo, dg1, dg0 and dmem_kv.
// The token passes take their subtiles through two-stage cp.async rings. wgmma, which wants
// 64-row tiles, and keeping dp out of device memory are later work.

#include "linear_attention_common.cuh"

namespace {

constexpr int kLdp = kQKV + 8;  // row stride of a dp subtile in shared memory

// Where a row's merged context gradient goes (6), and what it reads besides the partials:
// du rounded to T in fragment order, as the B of dke = v duᵀ (du_k) and of dv = ke du
// (du_v); dz; this row's share of the memory tokens' gradients (part_mem).
template <typename T>
struct DctxOut {
  const float *mem_kv, *c32, *z, *kmax;
  int m;
  T *du_k, *du_v;
  float *dz, *part_mem;
};

// (6) One head of a row's context gradient, a warp a block, grid (b, 4): dC summed over the
// blocks in order, du = dC / z rounded, dz = -sum_e dC C / z, and this row's share of the
// memory tokens' gradients: dmemk[d, j] = me (memv duᵀ + dz), dmemv[e, j] = (me du)[j, e],
// on the tensor cores with the memory axis (m <= 8) as 16 zero-padded rows.
template <typename T>
__global__ void __launch_bounds__(32)
la_bwd_dcontext_merge_kernel(const float* __restrict__ part_dc, int S, DctxOut<T> o) {
  pdl_enter();
  constexpr int kLdd = kDimHead + 8;
  __shared__ __align__(16) T dus[kDimHead * kLdd];
  __shared__ float dz_s[kDimHead];
  const int row = blockIdx.x, h = blockIdx.y;
  const int g = lane_g(), t = lane_t();
  const int m = o.m;
  const size_t base = static_cast<size_t>(row) * kCtx + h * kDimHead * kDimHead;
  const float* zr = o.z + static_cast<size_t>(row) * kHD + h * kDimHead;
  const float* kr = o.kmax + static_cast<size_t>(row) * kHD + h * kDimHead;
  float dc[32];
  sum_partials(part_dc + static_cast<size_t>(row) * S * kCtx, S, h, dc);
  float dzp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int d = frag_row(i), e = frag_col(i);
    const T v = from_f<T>(dc[i] / zr[d]);
    o.du_k[base + frag_off<T>(e, d, kDimHead)] = v;
    o.du_v[base + frag_off<T>(d, e, kDimHead)] = v;
    dus[d * kLdd + e] = v;
    dzp[i >> 4][(i >> 1) & 1] += dc[i] * o.c32[base + d * kDimHead + e];
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float sum = quad_sum(dzp[mt][half]);
      const int d = 16 * mt + g + 8 * half;
      if (t == 0) {
        const float dz = -sum / zr[d];
        o.dz[static_cast<size_t>(row) * kHD + h * kDimHead + d] = dz;
        dz_s[d] = dz;
      }
    }
  __syncwarp();

  const float* memk = o.mem_kv + static_cast<size_t>(h) * kDimHead * m;        // [d][j]
  const float* memv = o.mem_kv + static_cast<size_t>(kHD + h * kDimHead) * m;  // [e][j]
  float* pm = o.part_mem + static_cast<size_t>(row) * 2 * kHD * m;
  // dme[j, d] = memv[j] . du[d] (B(e, d) = du[d][e]); dmemk[d, j] = me (dme + dz).
  float acc[4][4];
  zero(acc);
#pragma unroll
  for (int k0 = 0; k0 < kDimHead; k0 += Frag<T>::kK) {
    typename Frag<T>::A a;
    make_a(a, [&](int r, int k) { return r < m ? rnd<T>(memv[(k0 + k) * m + r]) : 0.f; });
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      typename Frag<T>::B b;
      load_b_nk(b, dus, kLdd, 8 * nt, k0);
      mma(acc[nt], a, b);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // rows g + 8 are past m <= 8
      const int j = g, d = 8 * nt + 2 * t + r;
      if (j < m) {
        const float me = expf(memk[d * m + j] - kr[d]);
        pm[(h * kDimHead + d) * m + j] = me * (acc[nt][r] + dz_s[d]);
      }
    }
  // dmv[j, e] = me_c[j] . du[:, e] (B(d, e) = du[d][e]).
  zero(acc);
#pragma unroll
  for (int k0 = 0; k0 < kDimHead; k0 += Frag<T>::kK) {
    typename Frag<T>::A a;
    make_a(a, [&](int r, int k) {
      const int d = k0 + k;
      return r < m ? rnd<T>(expf(memk[d * m + r] - kr[d])) : 0.f;
    });
    typename Frag<T>::B b[4];
    load_b_kn2(b[0], b[1], dus, kLdd, 0, k0);
    load_b_kn2(b[2], b[3], dus, kLdd, 16, k0);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) mma(acc[nt], a, b[nt]);
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = g, e = 8 * nt + 2 * t + r;
      if (j < m) pm[(kHD + h * kDimHead + e) * m + j] = acc[nt][r];
    }
}

// Shared memory of token pass A after the subtile walk's (whose ring holds xn): qs, a (then
// da) and dy, rounded, and the rows' sums.
template <typename T, int NC>
struct TokenASmem {
  static constexpr int C = NC * 32, kLdx = C + 8;
  static constexpr size_t qs = SubtileSmem<T, NC>::bytes;
  static constexpr size_t a = qs + al16(kSub * kLdh * sizeof(T));
  static constexpr size_t dy = a + al16(kSub * kLdh * sizeof(T));
  static constexpr size_t red = dy + al16(kSub * kLdx * sizeof(T));
  static constexpr size_t bytes = red + 2 * kWarps * kSub * sizeof(float);
};

// (5) For the subtiles of a block's chunk: qs, a, y, dy, da, dq; partials of dC, dbo, dg1.
// Warp h: q = xn Wq for head h, pq, qs, a = qs Cc; warp w: y = a Wo + bo and dy for columns
// w C / 4 .. (w + 1) C / 4 (the RMSNorm's row sums over the four warps); warp h again:
// da = dy Woᵀ for head h, dqs = da Ccᵀ and dq, and dC += qsᵀ da in registers.
template <typename T, int NC>
__global__ void __launch_bounds__(kWarps * 32)
la_bwd_token_a_kernel(const T* __restrict__ xn_ws, const T* __restrict__ w_qkv,
                      const T* __restrict__ ctx_a, const T* __restrict__ ctx_dq,
                      const T* __restrict__ w_y, const T* __restrict__ w_da,
                      const float* __restrict__ bo, const float* __restrict__ g1,
                      const T* __restrict__ dout, T* __restrict__ ac_ws, T* __restrict__ dyc_ws,
                      T* __restrict__ dpc_ws, float* __restrict__ part_dc,
                      float* __restrict__ part_bg, int n, int S, int chunk) {
  pdl_enter();
  using L = TokenASmem<T, NC>;
  constexpr int C = NC * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane_g(), t = lane_t();
  T* qs_s = reinterpret_cast<T*>(smem + L::qs);
  T* a_s = reinterpret_cast<T*>(smem + L::a);
  T* dy_s = reinterpret_cast<T*>(smem + L::dy);
  float* red = reinterpret_cast<float*>(smem + L::red);
  const Chunk ck(n, S, chunk);
  const size_t tok0 = static_cast<size_t>(ck.row) * n;
  const T* ca = ctx_a + static_cast<size_t>(ck.row) * kCtx + h * kDimHead * kDimHead;
  const T* cq = ctx_dq + static_cast<size_t>(ck.row) * kCtx + h * kDimHead * kDimHead;
  const float sqrt_c = sqrtf(static_cast<float>(C));
  float u[2][4][4];  // dC of head h
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) zero(u[mt]);
  float bsum[NC][2], gsum[NC][2];  // this warp's columns' sums of dy and of dout y r1
#pragma unroll
  for (int j = 0; j < NC; ++j) bsum[j][0] = bsum[j][1] = gsum[j][0] = gsum[j][1] = 0.f;

  walk_subtiles<T, NC, false>(xn_ws + tok0 * C, ck, nullptr, smem, static_cast<T*>(nullptr),
                              tok0, NoFetch(), [&](const T* xn, const T*, int, int s) {
    const size_t trow = tok0 + static_cast<size_t>(s) * kSub;  // token of the subtile's row 0
    // pq of head h (kept for dq), qs rounded, a = qs Cc rounded.
    float pq[4][4], qs[4][4], a[4][4];
    zero(pq);
    head_projection<T, NC>(pq, xn, w_qkv, 0, h);
    head_softmax4(pq);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) qs[nt][r] = rnd<T>(pq[nt][r] * kInvSqrtD);
    zero(a);
    product_regs<T, 4>(a, qs, [&](auto& b, int j, int k0) { load_b_frag(b, ca, kDimHead, j, k0); });
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = g + 8 * half, col = h * kDimHead + 8 * nt + 2 * t;
        store_pair(qs_s + row * kLdh + col, qs[nt][2 * half], qs[nt][2 * half + 1]);
        store_pair(a_s + row * kLdh + col, a[nt][2 * half], a[nt][2 * half + 1]);
        store_pair(ac_ws + (trow + row) * kHD + col, a[nt][2 * half], a[nt][2 * half + 1]);
      }
    __syncthreads();  // a is complete

    // y = a Wo + bo and dy for this warp's columns.
    float y[NC][4];
    zero(y);
    product<T, NC, kHD>(
        y, [&](auto& fa, int k0) { load_a_mk(fa, a_s, kLdh, k0); },
        [&](auto& b, int j, int k0) { load_b_frag(b, w_y, kHD, h * NC + j, k0); });
    float sums[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // per row: sum y^2, sum u1 y
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = 8 * (h * NC + j) + 2 * t;
      const float2 bv = load_pair(bo + col), gv = load_pair(g1 + col);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float2 dv = load_pair(dout + (trow + g + 8 * half) * C + col);
        y[j][2 * half] += bv.x;
        y[j][2 * half + 1] += bv.y;
        sums[0][half] += y[j][2 * half] * y[j][2 * half] + y[j][2 * half + 1] * y[j][2 * half + 1];
        sums[1][half] += dv.x * (gv.x * sqrt_c) * y[j][2 * half] +
                         dv.y * (gv.y * sqrt_c) * y[j][2 * half + 1];
      }
    }
    rows_sum(sums, red);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = 8 * (h * NC + j) + 2 * t;
      const float2 gv = load_pair(g1 + col);
      const float gvv[2] = {gv.x, gv.y};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = g + 8 * half;
        const float r1 = rsqrtf(sums[0][half] + kEps), s1 = sums[1][half];
        const float r13 = r1 * r1 * r1;
        const float2 dv = load_pair(dout + (trow + row) * C + col);
        const float dvv[2] = {dv.x, dv.y};
        float dy[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float yv = y[j][2 * half + c];
          dy[c] = dvv[c] * (gvv[c] * sqrt_c) * r1 - yv * r13 * s1;
          bsum[j][c] += dy[c];
          gsum[j][c] += dvv[c] * yv * r1;
        }
        store_pair(dy_s + row * L::kLdx + col, dy[0], dy[1]);
        store_pair(dyc_ws + (trow + row) * C + col, dy[0], dy[1]);
      }
    }
    __syncthreads();  // dy is complete; every warp is done with a

    // da = dy Woᵀ for head h, rounded (into a_s for dC); dqs = da Ccᵀ; dq.
    float da[4][4], dq[4][4];
    zero(da);
    product<T, 4, C>(
        da, [&](auto& fa, int k0) { load_a_mk(fa, dy_s, L::kLdx, k0); },
        [&](auto& b, int j, int k0) { load_b_frag(b, w_da, C, 4 * h + j, k0); });
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) da[nt][r] = rnd<T>(da[nt][r]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        store_pair(a_s + (g + 8 * half) * kLdh + h * kDimHead + 8 * nt + 2 * t, da[nt][2 * half],
                   da[nt][2 * half + 1]);
    zero(dq);
    product_regs<T, 4>(dq, da, [&](auto& b, int j, int k0) { load_b_frag(b, cq, kDimHead, j, k0); });
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float tsum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) tsum += dq[nt][2 * half + c] * kInvSqrtD * pq[nt][2 * half + c];
      tsum = quad_sum(tsum);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float v[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = pq[nt][2 * half + c];
          v[c] = p * (dq[nt][2 * half + c] * kInvSqrtD) - p * tsum;
        }
        store_pair(dpc_ws + (trow + g + 8 * half) * kQKV + h * kDimHead + 8 * nt + 2 * t, v[0],
                   v[1]);
      }
    }
    __syncwarp();  // this warp's da columns are in a_s
    // dC += qsᵀ da over the subtile's 16 tokens.
#pragma unroll
    for (int k0 = 0; k0 < kSub; k0 += Frag<T>::kK) {
      typename Frag<T>::A a0, a1;
      typename Frag<T>::B b[4];
      load_a_km(a0, qs_s, kLdh, h * kDimHead, k0);
      load_a_km(a1, qs_s, kLdh, h * kDimHead + 16, k0);
      load_b_kn2(b[0], b[1], a_s, kLdh, h * kDimHead, k0);
      load_b_kn2(b[2], b[3], a_s, kLdh, h * kDimHead + 16, k0);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        mma(u[0][nt], a0, b[nt]);
        mma(u[1][nt], a1, b[nt]);
      }
    }
  });
  float* out = part_dc + static_cast<size_t>(blockIdx.x) * kCtx + h * 32 * 32 + lane;
#pragma unroll
  for (int i = 0; i < 32; ++i) out[i * 32] = u[i >> 4][(i >> 2) & 3][i & 3];
  float* bg = part_bg + static_cast<size_t>(blockIdx.x) * 2 * C + h * (C / 4);
  store_col_sums(bsum, bg, 1.f);
  store_col_sums(gsum, bg + C, sqrt_c);
}

// Shared memory of token pass B after the subtile walk's (whose ring holds x): a ring of
// two dp subtiles (dq comes in with the subtile), the rows' sums, and the row's kmax and dz.
template <typename T, int NC>
struct TokenBSmem {
  static constexpr size_t dp = SubtileSmem<T, NC>::bytes;
  static constexpr size_t red = dp + al16(2 * kSub * kLdp * sizeof(T));
  static constexpr size_t kmax = red + kWarps * kSub * sizeof(float);
  static constexpr size_t dz = kmax + kHD * sizeof(float);
  static constexpr size_t bytes = dz + kHD * sizeof(float);
};

// (7) For the subtiles of a block's chunk: dk, dv, dp, dxn, dx; a partial of dg0. Warp h: k
// and v again for head h, ke (f32), dk = ke (v duᵀ + dz) and dv = ke du from registers, into
// dp; warp w: dxn = dp Wqkvᵀ and dx for columns w C / 4 .. (w + 1) C / 4 (the RMSNorm's row
// sum over the four warps).
template <typename T, int NC, bool kResidual>
__global__ void __launch_bounds__(kWarps * 32)
la_bwd_token_b_kernel(const T* __restrict__ x, const float* __restrict__ g0,
                      const T* __restrict__ w_qkv, const T* __restrict__ w_dxn,
                      const float* __restrict__ kmax, const float* __restrict__ dz,
                      const T* __restrict__ du_k, const T* __restrict__ du_v,
                      const T* __restrict__ dout, T* __restrict__ dpc_ws, T* __restrict__ dx,
                      float* __restrict__ part_g0, int n, int S, int chunk) {
  pdl_enter();
  using L = TokenBSmem<T, NC>;
  constexpr int C = NC * 32, kVec = 16 / sizeof(T), kPerRow = kHD / kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = threadIdx.x >> 5, g = lane_g(), t = lane_t();
  T* dp = reinterpret_cast<T*>(smem + L::dp);
  float* red = reinterpret_cast<float*>(smem + L::red);
  float* kmax_s = reinterpret_cast<float*>(smem + L::kmax);
  float* dz_s = reinterpret_cast<float*>(smem + L::dz);
  const float* r0_s = reinterpret_cast<const float*>(smem + SubtileSmem<T, NC>::r0);
  const Chunk ck(n, S, chunk);
  const size_t tok0 = static_cast<size_t>(ck.row) * n;
  const T* duk = du_k + static_cast<size_t>(ck.row) * kCtx + h * kDimHead * kDimHead;
  const T* duv = du_v + static_cast<size_t>(ck.row) * kCtx + h * kDimHead * kDimHead;
  const float sqrt_c = sqrtf(static_cast<float>(C));
  for (int col = threadIdx.x; col < kHD; col += blockDim.x) {
    kmax_s[col] = kmax[static_cast<size_t>(ck.row) * kHD + col];
    dz_s[col] = dz[static_cast<size_t>(ck.row) * kHD + col];
  }
  float gsum[NC][2];  // this warp's columns' sums of dxn x r0
#pragma unroll
  for (int j = 0; j < NC; ++j) gsum[j][0] = gsum[j][1] = 0.f;

  auto fetch_dq = [&](int slot, int s) {
    const T* src = dpc_ws + (tok0 + static_cast<size_t>(s) * kSub) * kQKV;
    for (int i = threadIdx.x; i < kSub * kPerRow; i += blockDim.x) {
      const int r = i / kPerRow, c = i % kPerRow;
      tc::cp_async16(dp + (slot * kSub + r) * kLdp + c * kVec, src + r * kQKV + c * kVec, true);
    }
  };
  walk_subtiles<T, NC, true>(x + tok0 * C, ck, g0, smem, static_cast<T*>(nullptr), tok0,
                             fetch_dq, [&](const T* xn, const T* xr, int slot, int s) {
    const size_t trow = tok0 + static_cast<size_t>(s) * kSub;
    T* dpb = dp + slot * kSub * kLdp;
    float kk[4][4], vv[4][4], kec[4][4], dke[4][4], dv[4][4];
    zero(kk);
    zero(vv);
    head_projection<T, NC>(kk, xn, w_qkv, 1, h);
    head_projection<T, NC>(vv, xn, w_qkv, 2, h);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        kk[nt][r] = expf(kk[nt][r] - kmax_s[h * kDimHead + 8 * nt + 2 * t + (r & 1)]);
        kec[nt][r] = rnd<T>(kk[nt][r]);
        vv[nt][r] = rnd<T>(vv[nt][r]);
      }
    zero(dke);
    zero(dv);
    product_regs<T, 4>(dke, vv, [&](auto& b, int j, int k0) { load_b_frag(b, duk, kDimHead, j, k0); });
    product_regs<T, 4>(dv, kec, [&](auto& b, int j, int k0) { load_b_frag(b, duv, kDimHead, j, k0); });
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = g + 8 * half, col = h * kDimHead + 8 * nt + 2 * t;
        const float dk0 = kk[nt][2 * half] * (dke[nt][2 * half] + dz_s[col]);
        const float dk1 = kk[nt][2 * half + 1] * (dke[nt][2 * half + 1] + dz_s[col + 1]);
        store_pair(dpb + row * kLdp + kHD + col, dk0, dk1);
        store_pair(dpb + row * kLdp + 2 * kHD + col, dv[nt][2 * half], dv[nt][2 * half + 1]);
        store_pair(dpc_ws + (trow + row) * kQKV + kHD + col, dk0, dk1);
        store_pair(dpc_ws + (trow + row) * kQKV + 2 * kHD + col, dv[nt][2 * half],
                   dv[nt][2 * half + 1]);
      }
    __syncthreads();  // dp is complete

    // dxn = dp Wqkvᵀ for this warp's columns; dx through the first RMSNorm.
    float dxn[NC][4];
    zero(dxn);
    product<T, NC, kQKV>(
        dxn, [&](auto& fa, int k0) { load_a_mk(fa, dpb, kLdp, k0); },
        [&](auto& b, int j, int k0) { load_b_frag(b, w_dxn, kQKV, h * NC + j, k0); });
    float su[1][2] = {{0.f, 0.f}};
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = 8 * (h * NC + j) + 2 * t;
      const float2 gv = load_pair(g0 + col);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float2 xv = load_pair(xr + (g + 8 * half) * (C + 8) + col);
        su[0][half] += dxn[j][2 * half] * (gv.x * sqrt_c) * xv.x +
                       dxn[j][2 * half + 1] * (gv.y * sqrt_c) * xv.y;
      }
    }
    rows_sum(su, red);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = 8 * (h * NC + j) + 2 * t;
      const float2 gv = load_pair(g0 + col);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = g + 8 * half;
        const float r0 = r0_s[row], r03 = r0 * r0 * r0, s0 = su[0][half];
        const float2 xv = load_pair(xr + row * (C + 8) + col);
        float d0 = dxn[j][2 * half] * (gv.x * sqrt_c) * r0 - xv.x * r03 * s0;
        float d1 = dxn[j][2 * half + 1] * (gv.y * sqrt_c) * r0 - xv.y * r03 * s0;
        if (kResidual) {
          const float2 dv2 = load_pair(dout + (trow + row) * C + col);
          d0 += dv2.x;
          d1 += dv2.y;
        }
        store_pair(dx + (trow + row) * C + col, d0, d1);
        gsum[j][0] += dxn[j][2 * half] * xv.x * r0;
        gsum[j][1] += dxn[j][2 * half + 1] * xv.y * r0;
      }
    }
  });
  store_col_sums(gsum, part_g0 + static_cast<size_t>(blockIdx.x) * C + h * (C / 4), sqrt_c);
}

// (8, 9) out[split] = A[tokens of the split]ᵀ B[tokens of the split]: A [K][M] (row stride
// lda), B [K][N] (ldb), both T; a 64 x NB tile of the [M, N] output a block, warp w its
// rows 16 w .. 16 w + 15; the split's tokens through a two-stage cp.async ring of 32.
constexpr int kGemmStage = 32;

template <typename T, int NB>
struct GemmSmem {
  static constexpr int kLa = 64 + 8, kLb = NB + 8;
  static constexpr size_t a = 0;
  static constexpr size_t b = a + al16(2 * kGemmStage * kLa * sizeof(T));
  static constexpr size_t bytes = b + al16(2 * kGemmStage * kLb * sizeof(T));
};

template <typename T, int NB>
__global__ void __launch_bounds__(128)
la_bwd_atb_kernel(const T* __restrict__ A, int lda, const T* __restrict__ B, int ldb, int K, int M,
           int N, int chunk, float* __restrict__ out) {
  pdl_enter();
  using L = GemmSmem<T, NB>;
  constexpr int kVec = 16 / sizeof(T), kPa = 64 / kVec, kPb = NB / kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  T* a_s = reinterpret_cast<T*>(smem + L::a);
  T* b_s = reinterpret_cast<T*>(smem + L::b);
  const int n0 = blockIdx.x * NB, m0 = blockIdx.y * 64, split = blockIdx.z;
  const int warp = threadIdx.x >> 5, g = lane_g(), t = lane_t();
  const int k_begin = split * chunk, k_end = k_begin + chunk < K ? k_begin + chunk : K;

  auto fetch = [&](int slot, int k0) {
    for (int i = threadIdx.x; i < kGemmStage * kPa; i += 128) {
      const int r = i / kPa, c = i % kPa;
      tc::cp_async16(a_s + (slot * kGemmStage + r) * L::kLa + c * kVec,
                     A + static_cast<size_t>(k0 + r) * lda + m0 + c * kVec, true);
    }
    for (int i = threadIdx.x; i < kGemmStage * kPb; i += 128) {
      const int r = i / kPb, c = i % kPb;
      tc::cp_async16(b_s + (slot * kGemmStage + r) * L::kLb + c * kVec,
                     B + static_cast<size_t>(k0 + r) * ldb + n0 + c * kVec, true);
    }
  };
  float acc[NB / 8][4];
  zero(acc);
  int buf = 0;
  fetch(0, k_begin);
  tc::cp_async_commit();
  for (int k0 = k_begin; k0 < k_end; k0 += kGemmStage) {
    if (k0 + kGemmStage < k_end) fetch(buf ^ 1, k0 + kGemmStage);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const T* as = a_s + buf * kGemmStage * L::kLa;
    const T* bs = b_s + buf * kGemmStage * L::kLb;
#pragma unroll
    for (int kk = 0; kk < kGemmStage; kk += Frag<T>::kK) {
      typename Frag<T>::A a;
      load_a_km(a, as, L::kLa, 16 * warp, kk);
#pragma unroll
      for (int p = 0; p < NB / 16; ++p) {
        typename Frag<T>::B b0, b1;
        load_b_kn2(b0, b1, bs, L::kLb, 16 * p, kk);
        mma(acc[2 * p], a, b0);
        mma(acc[2 * p + 1], a, b1);
      }
    }
    __syncthreads();  // the slot is refilled next
    buf ^= 1;
  }
  tc::cp_async_wait<0>();
#pragma unroll
  for (int j = 0; j < NB / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + 16 * warp + g + 8 * half, col = n0 + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(out + (static_cast<size_t>(split) * M + row) * N + col) =
          make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
    }
}

// Chunks of the token axis for a product with `tiles` output tiles: enough blocks for two
// an SM, never a chunk below one stage of the ring.
struct Splits {
  int splits, chunk;
  Splits(int tiles, int tokens) {
    const int stages = tokens / kGemmStage;
    int s = (2 * kSMs + tiles - 1) / tiles;
    if (s > stages) s = stages;
    chunk = (stages + s - 1) / s * kGemmStage;
    splits = (tokens + chunk - 1) / chunk;
  }
};

// (10) The fixed-order sums, one launch: output j of sum k is the sum over r < rows of
// src[r * ld + j]. A block takes 32 outputs, warp w the rows r = w (mod 8) of each; then
// the eight warps' sums in order.
struct RowSum {
  const float* src;
  float* dst;
  long long ld;
  int rows, len;
};
constexpr int kSums = 6;
struct RowSums {
  RowSum s[kSums];
  long long start[kSums + 1];
};

__global__ void __launch_bounds__(256) la_bwd_sum_kernel(RowSums sums) {
  pdl_enter();
  __shared__ float part[8][32];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long i = blockIdx.x * 32LL + lane;
  const bool live = i < sums.start[kSums];
  int k = 0;
  while (live && i >= sums.start[k + 1]) ++k;
  const RowSum s = sums.s[k];
  const long long j = i - sums.start[k];
  float acc = 0.f;
  if (live)
    for (int r = w; r < s.rows; r += 8) acc += s.src[r * s.ld + j];
  part[w][lane] = acc;
  __syncthreads();
  if (w == 0 && live) {
    float sum = 0.f;
    for (int ww = 0; ww < 8; ++ww) sum += part[ww][lane];
    s.dst[j] = sum;
  }
}

// Workspace of the backward: one device buffer cut into these arrays.
struct BwdLayout {
  size_t w_qkv, w_dxn, w_y, w_da, xn, ac, dyc, dpc, part_kmax, part_z, part_ctx, ctx_a, ctx_dq,
      du_k, du_v, c32, z, kmax, dz, part_bg, part_g0, part_mem, part_w, part_wo, total;
  Splits sw, swo;

  BwdLayout(const Plan& P, int b, int n, int c, int m, size_t elt)
      : sw((c / 64) * (kQKV / 128), b * n), swo((kHD / 64) * (c / 64), b * n) {
    const size_t tok = static_cast<size_t>(b) * n, blocks = P.blocks, rows = b;
    Carve cv;
    w_qkv = cv.take(kQKV * c * elt);
    w_dxn = cv.take(kQKV * c * elt);
    w_y = cv.take(kHD * c * elt);
    w_da = cv.take(kHD * c * elt);
    xn = cv.take(tok * c * elt);
    ac = cv.take(tok * kHD * elt);
    dyc = cv.take(tok * c * elt);
    dpc = cv.take(tok * kQKV * elt);
    part_kmax = cv.take(blocks * kHD * 4);
    part_z = cv.take(blocks * kHD * 4);
    part_ctx = cv.take(blocks * kCtx * 4);  // the context's partials, then dC's
    ctx_a = cv.take(rows * kCtx * elt);
    ctx_dq = cv.take(rows * kCtx * elt);
    du_k = cv.take(rows * kCtx * elt);
    du_v = cv.take(rows * kCtx * elt);
    c32 = cv.take(rows * kCtx * 4);
    z = cv.take(rows * kHD * 4);
    kmax = cv.take(rows * kHD * 4);
    dz = cv.take(rows * kHD * 4);
    part_bg = cv.take(blocks * 2 * c * 4);
    part_g0 = cv.take(blocks * c * 4);
    part_mem = cv.take(rows * 2 * kHD * m * 4);
    part_w = cv.take(static_cast<size_t>(sw.splits) * c * kQKV * 4);
    part_wo = cv.take(static_cast<size_t>(swo.splits) * kHD * c * 4);
    total = cv.at;
  }
};

struct Grads {
  void* dx;
  float *dg0, *dw, *dmem, *dwo, *dbo, *dg1;
};

template <typename T, int NC>
cudaError_t run(const T* x, const float* g0, const float* wqkv, const float* mem_kv,
                const float* wo, const float* bo, const float* g1, const T* dout,
                const Grads& gr, char* ws, int b, int n, int m, bool residual,
                cudaStream_t stream) {
  constexpr int C = NC * 32;
  const Plan P(b, n);
  const BwdLayout L(P, b, n, C, m, sizeof(T));
  auto at = [ws](size_t off) { return reinterpret_cast<T*>(ws + off); };
  auto atf = [ws](size_t off) { return reinterpret_cast<float*>(ws + off); };
  const int tokens = b * n;

  const CtxOut<T> merged{at(L.ctx_a), at(L.ctx_dq), atf(L.c32), atf(L.z), atf(L.kmax)};
  const DctxOut<T> dctx{mem_kv, atf(L.c32), atf(L.z), atf(L.kmax), m, at(L.du_k), at(L.du_v),
                        atf(L.dz), atf(L.part_mem)};
  LGM_TRY((launch_context<LaBwd, T, NC>(
      P, x, g0, wqkv, mem_kv, wo, at(L.w_qkv), at(L.w_y), at(L.w_dxn), at(L.w_da),
      atf(L.part_kmax), atf(L.part_z), atf(L.part_ctx), at(L.xn), merged, b, n, m, stream)));

  LGM_TRY(launch(la_bwd_token_a_kernel<T, NC>, P.blocks, kWarps * 32, TokenASmem<T, NC>::bytes,
                 stream, at(L.xn), at(L.w_qkv), at(L.ctx_a), at(L.ctx_dq), at(L.w_y), at(L.w_da),
                 bo, g1, dout, at(L.ac), at(L.dyc), at(L.dpc), atf(L.part_ctx), atf(L.part_bg), n,
                 P.S, P.chunk));
  LGM_TRY(launch(la_bwd_dcontext_merge_kernel<T>, dim3(b, kHeads), 32, 0, stream,
                 atf(L.part_ctx), P.S, dctx));
  auto kern_b = residual ? la_bwd_token_b_kernel<T, NC, true> : la_bwd_token_b_kernel<T, NC, false>;
  LGM_TRY(launch(kern_b, P.blocks, kWarps * 32, TokenBSmem<T, NC>::bytes, stream, x, g0,
                 at(L.w_qkv), at(L.w_dxn), atf(L.kmax), atf(L.dz), at(L.du_k), at(L.du_v), dout,
                 at(L.dpc), static_cast<T*>(gr.dx), atf(L.part_g0), n, P.S, P.chunk));
  LGM_TRY(launch(la_bwd_atb_kernel<T, 128>, dim3(kQKV / 128, C / 64, L.sw.splits), 128,
                 GemmSmem<T, 128>::bytes, stream, at(L.xn), C, at(L.dpc), kQKV, tokens, C, kQKV,
                 L.sw.chunk, atf(L.part_w)));
  LGM_TRY(launch(la_bwd_atb_kernel<T, 64>, dim3(C / 64, kHD / 64, L.swo.splits), 128,
                 GemmSmem<T, 64>::bytes, stream, at(L.ac), kHD, at(L.dyc), C, tokens, kHD, C,
                 L.swo.chunk, atf(L.part_wo)));

  RowSums sums;
  const RowSum list[kSums] = {
      {atf(L.part_w), gr.dw, static_cast<long long>(C) * kQKV, L.sw.splits, C * kQKV},
      {atf(L.part_wo), gr.dwo, static_cast<long long>(kHD) * C, L.swo.splits, kHD * C},
      {atf(L.part_bg), gr.dbo, 2LL * C, P.blocks, C},
      {atf(L.part_bg) + C, gr.dg1, 2LL * C, P.blocks, C},
      {atf(L.part_g0), gr.dg0, static_cast<long long>(C), P.blocks, C},
      {atf(L.part_mem), gr.dmem, 2LL * kHD * m, b, 2 * kHD * m},
  };
  sums.start[0] = 0;
  for (int k = 0; k < kSums; ++k) {
    sums.s[k] = list[k];
    sums.start[k + 1] = sums.start[k] + list[k].len;
  }
  return launch(la_bwd_sum_kernel, static_cast<int>((sums.start[kSums] + 31) / 32), 256, 0,
                stream, sums);
}

template <typename T>
cudaError_t dispatch(int c, const void* x, const float* g0, const float* wqkv,
                     const float* mem_kv, const float* wo, const float* bo, const float* g1,
                     const void* dout, const Grads& gr, char* ws, int b, int n, int m,
                     bool residual, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* dt = static_cast<const T*>(dout);
  switch (c) {
    case 64:
      return run<T, 2>(xt, g0, wqkv, mem_kv, wo, bo, g1, dt, gr, ws, b, n, m, residual, s);
    case 128:
      return run<T, 4>(xt, g0, wqkv, mem_kv, wo, bo, g1, dt, gr, ws, b, n, m, residual, s);
    case 256:
      return run<T, 8>(xt, g0, wqkv, mem_kv, wo, bo, g1, dt, gr, ws, b, n, m, residual, s);
    default:
      return cudaErrorInvalidValue;
  }
}

bool shape_ok(int b, int n, int c, int m) {
  return b >= 1 && b <= 65535 && n >= kTile && n % kTile == 0 && m >= 1 && m <= 8 &&
         (c == 64 || c == 128 || c == 256);
}

}  // namespace

// Bytes of device workspace that lgm_linear_attention_bwd needs for these shapes (0 for
// shapes it does not take).
extern "C" size_t lgm_linear_attention_bwd_workspace(int b, int n, int c, int m, int bf16) {
  if (!shape_ok(b, n, c, m)) return 0;
  return BwdLayout(Plan(b, n), b, n, c, m, bf16 ? 2 : 4).total;
}

// x, dout, dx: [b, n, c] in f32 (bf16 == 0) or bf16 (bf16 == 1), also the compute type.
// g0, bo, g1: [c]; wqkv: [c, 384]; mem_kv: [2, 4, 32, m]; wo: [128, c]; all f32, as are
// the gradients dg0, dw, dmem, dwo, dbo, dg1 of the same shapes. workspace: at least
// lgm_linear_attention_bwd_workspace bytes, 256-byte aligned. Heads 4, dim_head 32,
// c in {64, 128, 256}, n a multiple of 32, 1 <= m <= 8. Launches on `stream` and returns
// the first CUDA error.
extern "C" int lgm_linear_attention_bwd(const void* x, const void* g0, const void* wqkv,
                                        const void* mem_kv, const void* wo, const void* bo,
                                        const void* g1, const void* dout, void* dx, void* dg0,
                                        void* dw, void* dmem, void* dwo, void* dbo, void* dg1,
                                        void* workspace, int b, int n, int c, int m,
                                        int residual, int bf16, void* stream) {
  if (!shape_ok(b, n, c, m)) return cudaErrorInvalidValue;
  const Grads gr{dx, static_cast<float*>(dg0), static_cast<float*>(dw),
                 static_cast<float*>(dmem), static_cast<float*>(dwo),
                 static_cast<float*>(dbo), static_cast<float*>(dg1)};
  const float* f_g0 = static_cast<const float*>(g0);
  const float* f_wqkv = static_cast<const float*>(wqkv);
  const float* f_mem = static_cast<const float*>(mem_kv);
  const float* f_wo = static_cast<const float*>(wo);
  const float* f_bo = static_cast<const float*>(bo);
  const float* f_g1 = static_cast<const float*>(g1);
  char* ws = static_cast<char*>(workspace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(c, x, f_g0, f_wqkv, f_mem, f_wo, f_bo, f_g1, dout, gr, ws,
                                   b, n, m, residual != 0, s);
  return dispatch<float>(c, x, f_g0, f_wqkv, f_mem, f_wo, f_bo, f_g1, dout, gr, ws, b, n, m,
                         residual != 0, s);
}

extern "C" const char* lgm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
