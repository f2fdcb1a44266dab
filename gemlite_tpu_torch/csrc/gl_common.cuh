// SPDX-License-Identifier: Apache-2.0
// Helpers shared by the int8 decode and general fused kernels: dtype codes
// (the values of gemlite_tpu_torch.dtypes.DType), metadata loads and output
// stores by code, and the cp.async / ldmatrix / mma.sync s8 wrappers of
// their tensor-core paths.
#pragma once
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gl {

enum DTypeCode { kF32 = 0, kF16 = 1, kBF16 = 2, kI8 = 4, kI32 = 6 };

// element i of a float32 / fp16 / bf16 array, as float
__device__ __forceinline__ float load_meta(const void* p, size_t i, int code) {
    if (code == kBF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
    if (code == kF16) return __half2float(static_cast<const __half*>(p)[i]);
    return static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_out(void* p, size_t i, float v, int code) {
    if (code == kBF16) static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
    else if (code == kF16) static_cast<__half*>(p)[i] = __float2half_rn(v);
    else static_cast<float*>(p)[i] = v;
}

// csm epilogue in float32 (pallas_gemm.py:203-212): 1 * s[n], 2 * sx[m],
// 3 * sx[m] * s[n], rounded after each multiply
__device__ __forceinline__ float channel_scale(float v, int csm, const void* s, int s_code,
                                               const float* sx, int m, int n) {
    if (csm == 1) return __fmul_rn(v, load_meta(s, n, s_code));
    if (csm == 2) return __fmul_rn(v, sx[m]);
    if (csm == 3) return __fmul_rn(__fmul_rn(v, sx[m]), load_meta(s, n, s_code));
    return v;
}

// ---- cp.async ring, ldmatrix and int8 mma.sync ----

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 / 8 / 4 bytes to shared memory; src_bytes 0 fills zeros and reads nothing
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_bytes));
}
__device__ __forceinline__ void cp_async8(unsigned dst, const void* src, int src_bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src, int src_bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// wait until at most n (0..4) groups are pending
__device__ __forceinline__ void cp_async_wait_n(int n) {
    switch (n) {
        case 0: cp_async_wait<0>(); break;
        case 1: cp_async_wait<1>(); break;
        case 2: cp_async_wait<2>(); break;
        case 3: cp_async_wait<3>(); break;
        default: cp_async_wait<4>(); break;
    }
}

// byte offset of 16-byte chunk c (k = 16c .. 16c + 15) of row r in a tile of
// 128-byte rows, XOR-swizzled. x rows: c ^ (m & 7). Weight rows: c ^ ((n >>
// 2) & 7) ^ ((n & 3) << 1), distinct over any 8 consecutive n from a multiple
// of 8 (ldmatrix) and over n = 4q + j, q = 0..7 (the int8 transpose's stores).
__device__ __forceinline__ int x_off(int m, int c) { return m * 128 + ((c ^ (m & 7)) << 4); }
__device__ __forceinline__ int w_off(int n, int c) {
    return n * 128 + ((c ^ ((n >> 2) & 7) ^ ((n & 3) << 1)) << 4);
}

// [r0.bj, r1.bj, r2.bj, r3.bj] for j = 0..3: a 4 x 4 byte transpose
__device__ __forceinline__ void transpose4(uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3,
                                           uint32_t (&o)[4]) {
    const uint32_t a = __byte_perm(r0, r1, 0x5140), b = __byte_perm(r2, r3, 0x5140);
    const uint32_t c = __byte_perm(r0, r1, 0x7362), d = __byte_perm(r2, r3, 0x7362);
    o[0] = __byte_perm(a, b, 0x5410);
    o[1] = __byte_perm(a, b, 0x7632);
    o[2] = __byte_perm(c, d, 0x5410);
    o[3] = __byte_perm(c, d, 0x7632);
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
                 : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(unsigned addr, uint32_t& r0, uint32_t& r1) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r0), "=r"(r1)
                 : "r"(addr));
}

// d += a (16 x 32, row) . b (32 x 8, col), int8 in, int32 sums
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
        "{%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a (16 x 16, row) . b (16 x 8, col)
__device__ __forceinline__ void mma_s8_k16(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
        "{%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a0), "r"(a1), "r"(b0));
}

}  // namespace gl
