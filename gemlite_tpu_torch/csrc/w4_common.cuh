// SPDX-License-Identifier: Apache-2.0
// Shared pieces of the mode-4 kernels (decode, prefill, dequantize): the
// w_layout=0 word format and the bf16x2 dequantization, rounded exactly as
// the plain PyTorch version rounds it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// With BITS-bit codes a word holds 32 / BITS of them, LSB first: code k of
// column n sits in word k / (32 / BITS) of column n, at bits
// BITS * (k % (32 / BITS)).
// W_group_mode 4: w = q * s + z' with z' = -z * s stored in bf16. The plain
// version computes in bf16 and rounds after the multiply and after the add.

// d = a * b + c, bf16x2, one rounding
__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t d;
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
    return d;
}

// -128 s in both halves of the bf16x2 s2, exact
__device__ __forceinline__ uint32_t minus128(uint32_t s2) {
    return fma_bf16x2(s2, 0xC300C300u, 0x80008000u);
}

// q * s + z for a pair of codes given as the bf16x2 v = 128 + q (the bits
// 0x4300 | q, exact): fma(128 + q, s, -128 s) rounds the exact q * s once,
// fma(t, 1, z) rounds the exact t + z once. The plain version rounds the
// same two results once each (float32 holds q * s exactly, and rounding t + z
// to float32 and then to bf16 is one correct rounding: 24 >= 2 * 8 + 2 bits).
// s2, z2: the scale and zero in both halves; m2 = minus128(s2).
__device__ __forceinline__ uint32_t dequant_pair(uint32_t v, uint32_t s2, uint32_t m2,
                                                 uint32_t z2) {
    return fma_bf16x2(fma_bf16x2(v, s2, m2), 0x3F803F80u, z2);
}
