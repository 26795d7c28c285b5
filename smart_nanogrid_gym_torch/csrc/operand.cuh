// The operand rounding of the bf16 options (K6 mlp_dtype, K3/K4 and K10
// matmul_dtype): a product operand rounded to the nearest bf16 value, ties
// to even (__float2bfloat16_rn, as torch's and XLA's casts round), and read
// back as f32.  The product of two bf16 values is exact in f32 (8 + 8
// significand bits), so a kernel that rounds its operands and sums the f32
// products in its twin's order stays bit-equal to the twin.  The tensor
// cores are not used: their accumulation order is not the twins'.
#pragma once

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

}  // namespace ngo
