// Hopper's warpgroup matrix products (wgmma, sm_90a) as the port's kernels use them: the
// flash attention forward (flash_attention.cu, bf16) and the VQ codebook search (vq.cu,
// TF32). A warpgroup (four consecutive warps) starts a 64 x 64 product asynchronously:
// wgmma_fence() before the first product that reads registers written since, products,
// wgmma_commit() to close a group, wgmma_wait<n>() until at most n groups are in flight.
//
// The accumulator layout (PTX ISA, "Register fragment of the accumulator, wgmma .m64nNk*"):
// warp w of the warpgroup holds rows 16 w .. 16 w + 15, and lane (g, t) = (lane / 4,
// lane % 4) holds d[4 j + c] at row g + 8 (c / 2) and column 8 j + 2 t + c % 2: the mma.sync
// accumulator layout, one 16 x 8 tile j after another.
//
// ptxas serializes the products of a group when any other instruction defines one of their
// accumulator registers between the fence and the wait, and a product that reads registers
// (A, or the accumulator) reads them while it runs. keep() pins a register's value at a
// point of the program: on the accumulators and operands before the fence and after the
// wait, it keeps the compiler from moving a definition into the group or reusing a register
// early.
#pragma once

#include <cstdint>

namespace wgmma {

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most n committed groups of products are in flight.
template <int n>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(n) : "memory");
}

__device__ __forceinline__ void keep(float& x) { asm volatile("" : "+f"(x)::"memory"); }
__device__ __forceinline__ void keep(uint32_t& x) { asm volatile("" : "+r"(x)::"memory"); }

#define LGM_ACC32                                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),     \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),          \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),       \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])
#define LGM_D32                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64, f32) = [d +] A B, bf16 A (64 x 16) and B (16 x 64) in shared memory, both
// K-major; scale_d 0 overwrites d.
__device__ __forceinline__ void mma_bf16_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " LGM_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : LGM_ACC32
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d += A B, bf16 A (64 x 16) in registers (each warp's 16 rows as the mma.m16n8k16 A
// fragment) and B (16 x 64) in shared memory, MN-major.
__device__ __forceinline__ void mma_bf16_rs(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " LGM_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : LGM_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d = [d +] A B, TF32 A (64 x 8) in registers (each warp's 16 rows as the mma.m16n8k8 A
// fragment) and B (8 x 64) in shared memory, K-major; scale_d 0 overwrites d.
__device__ __forceinline__ void mma_tf32_rs(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " LGM_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : LGM_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

#undef LGM_ACC32
#undef LGM_D32

}  // namespace wgmma
