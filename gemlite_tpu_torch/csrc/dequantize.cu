// SPDX-License-Identifier: Apache-2.0
// Dequantize packed words to a dense (K, N) bf16 in one streaming pass:
// W4 codes of W_group_mode 4 (gl_dequantize_w4), fp8 bit codes
// (gl_dequantize_fp8: each value converted exactly, times its column's scale
// in float32 where the layer has one (mode 2 or csm 1 / 3, the fold of
// gemlite_tpu/ops/dispatch.py:_dense_fallback_matmul), one rounding to bf16),
// or MX codes (gl_dequantize_mx: fp4 or fp8 codes times their group's e8m0
// or NVFP4 scale in float32, one rounding to bf16; csrc/mx_common.cuh).
//
// Replaces the TPU kernel gemlite_tpu/ops/pallas_prefill.py:pallas_dequantize;
// the dense product after it stays torch.matmul, as the JAX package leaves it
// to XLA. Written in CUDA C++ rather than Triton so that all three kernels of
// the path share one build.
//
// What bounds it: bytes (K*N/2 read, 2*K*N written), so the bound is HBM
// bandwidth. One thread reads one word of column n and writes its 8 values
// down the column; a warp's loads and each of its 8 stores cover contiguous
// columns, so every access is coalesced.
#include <cuda_fp8.h>

#include "mx_common.cuh"
#include "w4_common.cuh"

namespace {

// The plain version (dequantize_full) computes q * s + z in float32 and rounds
// once to bf16. q * s is exact in float32, so a fused multiply-add rounds the
// same way as a multiply followed by an add.
__device__ __forceinline__ float dequant_w4_mode4_f32(uint32_t word, int j, float s, float z) {
    return static_cast<float>((word >> (4 * j)) & 0xFu) * s + z;
}

__global__ void dequantize_w4_kernel(const uint32_t* __restrict__ wq,           // (K / 8, N)
                                     const __nv_bfloat16* __restrict__ scales,  // (K / gs, N)
                                     const __nv_bfloat16* __restrict__ zeros,   // (K / gs, N)
                                     __nv_bfloat16* __restrict__ out,           // (K, N)
                                     int N, int gs) {
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    const int kw = blockIdx.y;
    if (n >= N) return;
    const uint32_t word = __ldg(wq + (size_t)kw * N + n);
    const size_t g = (size_t)(kw * 8 / gs) * N + n;
    const float s = __bfloat162float(scales[g]);
    const float z = __bfloat162float(zeros[g]);
#pragma unroll
    for (int j = 0; j < 8; ++j)
        out[(size_t)(kw * 8 + j) * N + n] = __float2bfloat16_rn(dequant_w4_mode4_f32(word, j, s, z));
}

// fp8 form: one thread reads four words (columns n .. n + 3 of word row kw,
// 16 bytes) and writes the four k rows they hold, 8 bytes a row, so a warp's
// loads and stores are contiguous.
template <int W>
__global__ void dequantize_fp8_kernel(const uint4* __restrict__ wq,   // (K / 4, N / 4) x 4 words
                                      const void* __restrict__ scales, int s_f32,
                                      __nv_bfloat16* __restrict__ out, int N) {
    const int q = blockIdx.x * blockDim.x + threadIdx.x;   // a quad of columns
    const int kw = blockIdx.y;
    if (4 * q >= N) return;
    const uint4 w = __ldg(wq + (size_t)kw * (N / 4) + q);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
    float s[4] = {1.f, 1.f, 1.f, 1.f};
    if (scales != nullptr) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
            s[c] = s_f32 ? static_cast<const float*>(scales)[4 * q + c]
                         : __bfloat162float(static_cast<const __nv_bfloat16*>(scales)[4 * q + c]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        float v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const __half_raw h =
                __nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>((words[c] >> (8 * j)) & 0xFFu),
                                        W ? __NV_E5M2 : __NV_E4M3);
            v[c] = __half2float(__half(h));
            if (scales != nullptr) v[c] = __fmul_rn(v[c], s[c]);
        }
        const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
        uint2 pk;
        pk.x = *reinterpret_cast<const uint32_t*>(&lo);
        pk.y = *reinterpret_cast<const uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(out + (size_t)(4 * kw + j) * N + 4 * q) = pk;
    }
}

// MX form: one thread reads one word of column n (8 fp4 or 4 fp8 codes, all
// in one group) and writes its values down the column.
__global__ void dequantize_mx_kernel(const uint32_t* __restrict__ wq,    // (K / per_word, N)
                                     const uint8_t* __restrict__ scales,  // (K / gs, N)
                                     __nv_bfloat16* __restrict__ out,     // (K, N)
                                     int N, int wkind, int gs) {
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    const int kw = blockIdx.y, epw = mx::per_word(wkind);
    if (n >= N) return;
    const uint32_t word = __ldg(wq + (size_t)kw * N + n);
    const float s = mx::scale_f32(__ldg(scales + (size_t)(kw * epw / gs) * N + n), gs == 16);
    for (int j = 0; j < epw; ++j)
        out[(size_t)(kw * epw + j) * N + n] =
            __float2bfloat16_rn(__fmul_rn(mx::code_f32(word, j, wkind), s));
}

}  // namespace

// Launch on `stream`: MX codes of w_kind (0 fp4, 1 e4m3, 2 e5m2) in (K /
// per_word, N) words; scales (K / gs, N) e8m0 bits (gs 32) or NVFP4 e4m3 (gs
// 16, fp4 only). Returns the cudaError_t of the launch.
extern "C" int gl_dequantize_mx(const void* wq, const void* scales, void* out, int N, int K,
                                int w_kind, int gs, void* stream_ptr) {
    if (N < 1 || K < 32 || K % 32 || w_kind < mx::kFp4 || w_kind > mx::kE5m2 ||
        (gs != 32 && !(gs == 16 && w_kind == mx::kFp4)) || wq == nullptr || scales == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((N + 255) / 256, K / mx::per_word(w_kind));
    dequantize_mx_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
        static_cast<const uint32_t*>(wq), static_cast<const uint8_t*>(scales),
        static_cast<__nv_bfloat16*>(out), N, w_kind, gs);
    return static_cast<int>(cudaGetLastError());
}

// Launch on `stream`: fp8 codes (w_code: DType 3 e4m3, 8 e5m2) in (K / 4, N)
// words, N a multiple of 4, 16-byte aligned; `scales` (N) float32 (s_code 0)
// or bf16 (2), or null for none. Returns the cudaError_t of the launch.
extern "C" int gl_dequantize_fp8(const void* wq, const void* scales, void* out, int N, int K,
                                 int w_code, int s_code, void* stream_ptr) {
    if (N < 4 || N % 4 || K < 4 || K % 4 || (w_code != 3 && w_code != 8) ||
        (scales != nullptr && s_code != 0 && s_code != 2) || reinterpret_cast<uintptr_t>(wq) % 16 ||
        reinterpret_cast<uintptr_t>(out) % 8)
        return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((N / 4 + 127) / 128, K / 4);
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const uint4* w = static_cast<const uint4*>(wq);
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
    if (w_code == 8)
        dequantize_fp8_kernel<1><<<grid, 128, 0, stream>>>(w, scales, s_code == 0, o, N);
    else
        dequantize_fp8_kernel<0><<<grid, 128, 0, stream>>>(w, scales, s_code == 0, o, N);
    return static_cast<int>(cudaGetLastError());
}

// Launch on `stream`. Returns the cudaError_t of the launch.
extern "C" int gl_dequantize_w4(const void* wq, const void* scales, const void* zeros,
                                void* out, int N, int K, int gs, void* stream_ptr) {
    const dim3 grid((N + 255) / 256, K / 8);
    dequantize_w4_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
        static_cast<const uint32_t*>(wq), static_cast<const __nv_bfloat16*>(scales),
        static_cast<const __nv_bfloat16*>(zeros), static_cast<__nv_bfloat16*>(out), N, gs);
    return static_cast<int>(cudaGetLastError());
}
