// SPDX-License-Identifier: Apache-2.0
// The MX weight decoder shared by csrc/mx_gemm.cu (decode, stacked decode,
// prefill) and csrc/dequantize.cu (gl_dequantize_mx): codes of a packed
// int32 word (fp4 e2m1: eight a word, k % 8 at bits 4 (k % 8); fp8 e4m3 /
// e5m2: four a word, k % 4 at bits 8 (k % 4)) to their exact values (fp4
// pairs straight to bf16 by byte permutes, fp8 through fp16), the group
// scale to float32 (e8m0 exponent bits: 2^(e - 127), e 0 -> 0.0; NVFP4: the
// e4m3 scale times 0.05 in float32), and their product rounded once to
// bf16. That is the plain version's arithmetic
// (ops/reference.mx_dequantize_weight_ref, then one cast), so a decoded
// weight equals dequantize_full's bit for bit. An e8m0 scale is a power of
// two with float32's exponent range, which bf16 shares: as a bf16x2 (e in
// the exponent bits of both halves) it multiplies an exactly decoded bf16x2
// pair in one instruction (mul_bf16x2, no flush of subnormals), whose one
// rounding of the exact product gives the float32 path's bits at every
// exponent 0-254 (the prefill kernel's decode_e8m0_pair). NVFP4's scale is no
// power of two and keeps the float32 multiply (decode_pair). The decode
// kernel takes the unscaled pairs (raw_pair) and scales each group's float32
// sum instead.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace mx {

enum WKind { kFp4 = 0, kE4m3 = 1, kE5m2 = 2 };   // the weight codes

// codes a word holds
__host__ __device__ constexpr int per_word(int wkind) { return wkind == kFp4 ? 8 : 4; }

// fp4 code (bits 0-3 of q): magnitude m = q & 7 is 0, 0.5 (m 1), or
// 2^((m >> 1) - 1) (1 + (m & 1) / 2); bit 3 the sign (code 8 is -0.0)
__device__ __forceinline__ float fp4_f32(uint32_t q) {
    const uint32_t m = q & 7u;
    uint32_t bits = m >= 2u ? 0x3F000000u + (m << 22) : (m ? 0x3F000000u : 0u);
    return __uint_as_float(bits | ((q & 8u) << 28));
}

// fp8 code (bits 0-7 of b), exact through fp16
__device__ __forceinline__ float fp8_f32(uint32_t b, bool e5m2) {
    const __half_raw h = __nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(b & 0xFFu),
                                                 e5m2 ? __NV_E5M2 : __NV_E4M3);
    return __half2float(__half(h));
}

// code e (0 .. per_word - 1) of a word
__device__ __forceinline__ float code_f32(uint32_t word, int e, int wkind) {
    return wkind == kFp4 ? fp4_f32(word >> (4 * e)) : fp8_f32(word >> (8 * e), wkind == kE5m2);
}

// a group scale byte to float32
__device__ __forceinline__ float scale_f32(uint32_t s, bool nvfp4) {
    return nvfp4 ? __fmul_rn(fp8_f32(s, false), 0.05f) : __uint_as_float((s & 0xFFu) << 23);
}

// two fp4 codes (bits 0-3 and 4-7 of b) -> bf16x2, exact: the magnitudes'
// bf16 bytes picked by byte permutes from a register table, the signs ORed in
__device__ __forceinline__ uint32_t fp4x2_bf16x2(uint32_t b) {
    const uint32_t sel = b & 0x77u;
    const uint32_t lo = __byte_perm(0xC0800000u, 0xC0804000u, sel);   // low bytes of 0 .. 6
    const uint32_t hi = __byte_perm(0x3F3F3F00u, 0x40404040u, sel);   // high bytes
    return __byte_perm(lo, hi, 0x5140u) | ((b & 0x08u) << 12) | ((b & 0x80u) << 24);
}

// two fp8 codes (bytes 0 and 1 of two) -> float32, exact through fp16
__device__ __forceinline__ float2 fp8x2_f32x2(uint32_t two, bool e5m2) {
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(two & 0xFFFFu), e5m2 ? __NV_E5M2 : __NV_E4M3);
    return __half22float2(__half2(h));
}

// (lo, hi) rounded once to bf16, lo in the low half
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&b);
}

// codes e and e + 1 (e even) of a word, as float32
__device__ __forceinline__ float2 pair_f32(uint32_t word, int e, int wkind) {
    if (wkind == kFp4) {
        const uint32_t v = fp4x2_bf16x2(word >> (4 * e));
        return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xFFFF0000u));
    }
    return fp8x2_f32x2(word >> (8 * e), wkind == kE5m2);
}

// codes e and e + 1 (e even) of a word, unscaled, as bf16x2 (exact)
__device__ __forceinline__ uint32_t raw_pair(uint32_t word, int e, int wkind) {
    if (wkind == kFp4) return fp4x2_bf16x2(word >> (4 * e));
    const float2 f = fp8x2_f32x2(word >> (8 * e), wkind == kE5m2);
    return bf16x2(f.x, f.y);
}

// codes e and e + 1 (e even) of a word times the scale, as bf16x2
__device__ __forceinline__ uint32_t decode_pair(uint32_t word, int e, int wkind, float s) {
    const float2 f = pair_f32(word, e, wkind);
    return bf16x2(__fmul_rn(f.x, s), __fmul_rn(f.y, s));
}

// an e8m0 scale byte as the bf16x2 2^(e - 127) in both halves (e 0 -> 0.0)
__device__ __forceinline__ uint32_t e8m0_bf16x2(uint32_t s) { return (s & 0xFFu) * 0x00800080u; }

// a * b per half, the exact product rounded once to bf16 (sm_90; bf16
// arithmetic keeps subnormals)
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
    return d;
}

// codes e and e + 1 (e even) of a word times the e8m0 scale byte s, as
// bf16x2: the bits of decode_pair(word, e, wkind, scale_f32(s, false))
__device__ __forceinline__ uint32_t decode_e8m0_pair(uint32_t word, int e, int wkind, uint32_t s) {
    return mul_bf16x2(raw_pair(word, e, wkind), e8m0_bf16x2(s));
}

}  // namespace mx
