// SPDX-License-Identifier: Apache-2.0
// W4 decode GEMV / split-K for M <= 64: out = x @ dequant(W_q), bf16 out,
// float32 accumulation.
//
// Replaces the TPU kernel gemlite_tpu/ops/pallas_decode.py:pallas_decode_matmul
// on the A16W4 W_group_mode 4 layers the serving path runs.
//
// What bounds it: at M <= 8 the packed weights (K*N/2 bytes) dominate the
// traffic, so the bound is bytes over HBM bandwidth. Design for that:
//   * one thread owns one output column n and walks down K; a warp's word loads
//     are 128 contiguous bytes because W_q rows are N-contiguous;
//   * each thread issues the loads of a whole K-chunk (8 words) before using
//     them, so many loads are in flight;
//   * x is staged in shared memory one K-chunk at a time, as float and
//     transposed (xs[k][m]), so the inner loop reads 4 rows with one 16-byte
//     broadcast load;
//   * K is split over gridDim.y so that 4096-wide layers fill the 132 SMs.
//     Partial sums go to a float32 workspace and a second kernel adds them in
//     split order: no float atomics, so a run repeats bit for bit, and row m's
//     result does not depend on M (the split count depends on N and K only).
// At M = 64 the float32 FMAs (64 per weight) bound it instead; the tensor-core
// prefill kernel is the better tool there, which a later change may route.
#include "w4_common.cuh"

namespace {

constexpr int kThreads = 128;   // output columns per block
constexpr int kChunk = 64;      // K rows of x staged per chunk (8 words)

template <int MT>
__global__ void __launch_bounds__(kThreads)
decode_w4_kernel(const __nv_bfloat16* __restrict__ x,       // (M, K)
                 const uint32_t* __restrict__ wq,            // (K / 8, N)
                 const __nv_bfloat16* __restrict__ scales,   // (K / gs, N)
                 const __nv_bfloat16* __restrict__ zeros,    // (K / gs, N)
                 float* __restrict__ partial,                // (splits, M, N)
                 __nv_bfloat16* __restrict__ out,            // (M, N)
                 int M, int N, int K, int gs, int k_per_split) {
    __shared__ __align__(16) float xs[kChunk][MT];
    const int n = blockIdx.x * kThreads + threadIdx.x;
    const int split = blockIdx.y;
    const int k_begin = split * k_per_split;
    const int k_end = min(K, k_begin + k_per_split);
    const bool live = n < N;

    float acc[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[m] = 0.f;

    for (int kc = k_begin; kc < k_end; kc += kChunk) {
        const int klen = min(kChunk, k_end - kc);   // a multiple of 8
        for (int i = threadIdx.x; i < kChunk * MT; i += kThreads) {
            const int m = i / kChunk, kk = i % kChunk;
            float v = 0.f;
            if (m < M && kk < klen) v = __bfloat162float(x[(size_t)m * K + kc + kk]);
            xs[kk][m] = v;
        }
        __syncthreads();
        if (live) {
            const int nw = klen / 8;
            uint32_t words[kChunk / 8];
            float s[kChunk / 8], z[kChunk / 8];
#pragma unroll
            for (int w = 0; w < kChunk / 8; ++w) {
                words[w] = 0u;
                s[w] = 0.f;
                z[w] = 0.f;
                if (w < nw) {
                    const int k0 = kc + w * 8;
                    const size_t g = (size_t)(k0 / gs) * N + n;
                    words[w] = __ldg(wq + (size_t)(k0 / 8) * N + n);
                    s[w] = __bfloat162float(scales[g]);
                    z[w] = __bfloat162float(zeros[g]);
                }
            }
#pragma unroll
            for (int w = 0; w < kChunk / 8; ++w) {
                if (w < nw) {
#pragma unroll
                    for (int j = 0; j < 8; ++j) {
                        const float wv = dequant_w4_mode4(words[w], j, s[w], z[w]);
                        const float* xr = xs[w * 8 + j];
                        if constexpr (MT % 4 == 0) {
#pragma unroll
                            for (int m = 0; m < MT; m += 4) {
                                const float4 xv = *reinterpret_cast<const float4*>(xr + m);
                                acc[m + 0] = fmaf(xv.x, wv, acc[m + 0]);
                                acc[m + 1] = fmaf(xv.y, wv, acc[m + 1]);
                                acc[m + 2] = fmaf(xv.z, wv, acc[m + 2]);
                                acc[m + 3] = fmaf(xv.w, wv, acc[m + 3]);
                            }
                        } else {
#pragma unroll
                            for (int m = 0; m < MT; ++m) acc[m] = fmaf(xr[m], wv, acc[m]);
                        }
                    }
                }
            }
        }
        __syncthreads();
    }

    if (!live) return;
    if (gridDim.y == 1) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
            if (m < M) out[(size_t)m * N + n] = __float2bfloat16_rn(acc[m]);
    } else {
#pragma unroll
        for (int m = 0; m < MT; ++m)
            if (m < M) partial[((size_t)split * M + m) * N + n] = acc[m];
    }
}

// out[i] = sum over splits of partial[s, i], added in split order.
__global__ void splitk_reduce_kernel(const float* __restrict__ partial,
                                     __nv_bfloat16* __restrict__ out,
                                     int count, int splits) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= count) return;
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += partial[(size_t)s * count + i];
    out[i] = __float2bfloat16_rn(acc);
}

template <int MT>
cudaError_t launch(const void* x, const void* wq, const void* scales, const void* zeros,
                   void* partial, void* out, int M, int N, int K, int gs,
                   int splits, int k_per_split, cudaStream_t stream) {
    const dim3 grid((N + kThreads - 1) / kThreads, splits);
    decode_w4_kernel<MT><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const uint32_t*>(wq),
        static_cast<const __nv_bfloat16*>(scales), static_cast<const __nv_bfloat16*>(zeros),
        static_cast<float*>(partial), static_cast<__nv_bfloat16*>(out),
        M, N, K, gs, k_per_split);
    return cudaGetLastError();
}

}  // namespace

// Launch on `stream`. With splits > 1, `partial` holds splits * M * N floats.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int gl_decode_w4(const void* x, const void* wq, const void* scales,
                            const void* zeros, void* partial, void* out,
                            int M, int N, int K, int gs, int splits, int k_per_split,
                            void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    cudaError_t err;
    if (M <= 1)       err = launch<1>(x, wq, scales, zeros, partial, out, M, N, K, gs, splits, k_per_split, stream);
    else if (M <= 2)  err = launch<2>(x, wq, scales, zeros, partial, out, M, N, K, gs, splits, k_per_split, stream);
    else if (M <= 4)  err = launch<4>(x, wq, scales, zeros, partial, out, M, N, K, gs, splits, k_per_split, stream);
    else if (M <= 8)  err = launch<8>(x, wq, scales, zeros, partial, out, M, N, K, gs, splits, k_per_split, stream);
    else if (M <= 16) err = launch<16>(x, wq, scales, zeros, partial, out, M, N, K, gs, splits, k_per_split, stream);
    else if (M <= 32) err = launch<32>(x, wq, scales, zeros, partial, out, M, N, K, gs, splits, k_per_split, stream);
    else if (M <= 64) err = launch<64>(x, wq, scales, zeros, partial, out, M, N, K, gs, splits, k_per_split, stream);
    else return static_cast<int>(cudaErrorInvalidValue);
    if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
    const int count = M * N;
    splitk_reduce_kernel<<<(count + 255) / 256, 256, 0, stream>>>(
        static_cast<const float*>(partial), static_cast<__nv_bfloat16*>(out), count, splits);
    return static_cast<int>(cudaGetLastError());
}
