// The bf16 operands of the bf16 options (K6 mlp_dtype, K3/K4 and K10
// matmul_dtype).
//
// operand<BF16>: a product operand rounded to the nearest bf16 value, ties
// to even (__float2bfloat16_rn, as torch's and XLA's casts round), and read
// back as f32 (K3/K4's scalar products).  The product of two bf16 values is
// exact in f32 (8 + 8 significand bits), so a kernel that rounds its
// operands and sums the f32 products in its twin's order stays bit-equal to
// the twin.
//
// pack_bf16 and mma_bf16: the tensor-core products of K3/K4, K10 and K6's
// block actor, mma.sync.m16n8k16 with bf16 operands and f32 accumulation.
// Their accumulation order is not the twins', so those paths state a
// tolerance against their twins.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace ngo {

template <bool BF16>
__device__ __forceinline__ float operand(float x) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

// Two f32 values rounded to bf16 in one 32-bit word, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += A B for one warp: A the 16 x 16 bf16 fragment (a0 rows g, k 2t..2t+1;
// a1 rows g + 8; a2 and a3 the same at k + 8), B the 16 x 8 one (b0 k 2t..2t+1
// of column g, b1 at k + 8), c the f32 16 x 8 fragment (rows g, g + 8;
// columns 2t, 2t + 1), for lane (g, t) = (lane / 4, lane % 4).
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

}  // namespace ngo
