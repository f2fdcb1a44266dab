// SPDX-License-Identifier: Apache-2.0
// Shared pieces of the W1/W2/W4 kernels (decode, prefill, dequantize): the
// w_layout=0 word format and the bf16x2 dequantization of W_group_mode 4
// and of modes 1-3, rounded exactly as the plain PyTorch version rounds it.
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

// W_group_mode 3, w = (q - z) * s in bf16, rounded after the subtraction and
// after the multiply as the plain version rounds (mode 1 is s = 1, mode 2
// z = 0; a scalar zero is z in every group). For a pair of codes given as
// v = 128 + q: fma(v, 1, -128) is q exactly, fma(q, 1, -z) rounds q - z
// once and fma(d, s, -0) rounds d * s once. (The plain version's float32
// q - z and d * s are exact for codes below 256 and bf16 z and s, so it
// rounds each once too.) s2: the scale in both halves; nz2: -z.
__device__ __forceinline__ uint32_t dequant_pair_shift(uint32_t v, uint32_t s2, uint32_t nz2) {
    const uint32_t q = fma_bf16x2(v, 0x3F803F80u, 0xC300C300u);
    return fma_bf16x2(fma_bf16x2(q, 0x3F803F80u, nz2), s2, 0x80008000u);
}

// What the mode 1-3 forms of the decode and prefill kernels read beside
// their Params (a kernel argument of its own, so that the mode-4 kernels
// keep theirs): zeros are z itself; a missing scale row reads 1, a missing
// zero row the scalar zero (or 0).
struct Modes {
    int has_s, has_z;                    // scale / zero rows in memory
    const int* zscalar;                  // the scalar int32 zero, or null
    const float* sx;                     // (M) float32 per-token scales (csm 2 / 3)
    const void* cs;                      // (N) channel scales (csm 1 / 3), float32 or bf16
    int csm, cs_code;                    // cs_code: gl::kF32 or gl::kBF16
};

// The bf16x2 -z of a scalar int32 zero (exact for |z| <= 256), or -0 for a
// layer without zeros.
__device__ __forceinline__ uint32_t neg_zero2(const int* zscalar) {
    if (zscalar == nullptr) return 0x80008000u;
    const uint32_t z = __bfloat16_as_ushort(__int2bfloat16_rn(-__ldg(zscalar)));
    return z * 0x00010001u;
}
