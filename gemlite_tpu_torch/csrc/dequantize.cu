// SPDX-License-Identifier: Apache-2.0
// W4 dequantize: packed (K / 8, N) int32 words -> dense (K, N) bf16 in one
// streaming pass, W_group_mode 4.
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

}  // namespace

// Launch on `stream`. Returns the cudaError_t of the launch.
extern "C" int gl_dequantize_w4(const void* wq, const void* scales, const void* zeros,
                                void* out, int N, int K, int gs, void* stream_ptr) {
    const dim3 grid((N + 255) / 256, K / 8);
    dequantize_w4_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
        static_cast<const uint32_t*>(wq), static_cast<const __nv_bfloat16*>(scales),
        static_cast<const __nv_bfloat16*>(zeros), static_cast<__nv_bfloat16*>(out), N, gs);
    return static_cast<int>(cudaGetLastError());
}
