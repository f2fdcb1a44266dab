// SPDX-License-Identifier: Apache-2.0
// Shared pieces of the W4 kernels (and of the W1/W2/W4 decode kernel): the
// w_layout=0 word format and the mode-4 dequantization, rounded exactly as
// the plain PyTorch version rounds it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// With BITS-bit codes a word holds 32 / BITS of them, LSB first: code k of
// column n sits in word k / (32 / BITS) of column n, at bits
// BITS * (k % (32 / BITS)).
// W_group_mode 4: w = q * s + z' with z' = -z * s stored in bf16. The plain
// version computes in bf16 and rounds after the multiply and after the add;
// q * s is exact in float32 (an integer of at most 4 bits times an 8-bit
// mantissa), so rounding each float32 result to bf16 gives the same bits.
template <int BITS>
__device__ __forceinline__ float dequant_mode4(uint32_t word, int j, float s, float z) {
    const float q = static_cast<float>((word >> (BITS * j)) & ((1u << BITS) - 1u));
    const float t = __bfloat162float(__float2bfloat16_rn(q * s));
    return __bfloat162float(__float2bfloat16_rn(t + z));
}

__device__ __forceinline__ float dequant_w4_mode4(uint32_t word, int j, float s, float z) {
    return dequant_mode4<4>(word, j, s, z);
}
