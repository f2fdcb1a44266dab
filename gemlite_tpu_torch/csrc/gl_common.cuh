// SPDX-License-Identifier: Apache-2.0
// Helpers shared by the int8 decode and general fused kernels: dtype codes
// (the values of gemlite_tpu_torch.dtypes.DType), metadata loads and output
// stores by code.
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

}  // namespace gl
