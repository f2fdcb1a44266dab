// SPDX-License-Identifier: Apache-2.0
// Shared pieces of the W4 kernels: the w_layout=0 word format and the mode-4
// dequantization, rounded exactly as the plain PyTorch version rounds it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Code k of column n sits in word k / 8 of column n, at bits 4 * (k % 8).
// W_group_mode 4: w = q * s + z' with z' = -z * s stored in bf16. The plain
// version computes in bf16 and rounds after the multiply and after the add;
// q * s is exact in float32 (a 4-bit integer times an 8-bit mantissa), so
// rounding each float32 result to bf16 gives the same bits.
__device__ __forceinline__ float dequant_w4_mode4(uint32_t word, int j, float s, float z) {
    const float q = static_cast<float>((word >> (4 * j)) & 0xFu);
    const float t = __bfloat162float(__float2bfloat16_rn(q * s));
    return __bfloat162float(__float2bfloat16_rn(t + z));
}
