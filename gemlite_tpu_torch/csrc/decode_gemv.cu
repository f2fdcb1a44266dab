// SPDX-License-Identifier: Apache-2.0
// W1/W2/W4 decode GEMV / split-K for M <= 64: out = x @ dequant(W_q), bf16
// out, float32 accumulation, W_group_mode 4 with bf16 group scales and zeros.
//
// Two entries share one body:
//   gl_decode          one layer: replaces the TPU kernel
//                      gemlite_tpu/ops/pallas_decode.py:pallas_decode_matmul
//                      on the mode-4 layers the serving path runs;
//   gl_decode_stacked  layer l of an L-layer stack (L, K / epw, N): replaces
//                      gemlite_tpu/ops/pallas_scan.py:pallas_decode_matmul_stacked.
//                      The TPU kernel reads l as a scalar-prefetch operand in
//                      its index maps; here each block reads l from a device
//                      pointer and offsets its weight, scale and zero
//                      pointers by it, so the host never reads the index and
//                      one launch entry serves every layer.
//
// What bounds it: at M <= 8 the packed weights (K * N * bits / 8 bytes)
// dominate the traffic, so the bound is bytes over HBM bandwidth. Design:
//   * one thread owns one output column n and walks down K; a warp's word loads
//     are 128 contiguous bytes because W_q rows are N-contiguous;
//   * each thread issues the loads of a whole K-chunk (64 rows: 8 W4 words,
//     4 W2 words or 2 W1 words) before using them, so many loads are in flight;
//   * x is staged in shared memory one K-chunk at a time, as float and
//     transposed (xs[k][m]), so the inner loop reads 4 rows with one 16-byte
//     broadcast load;
//   * K is split over gridDim.y so that 4096-wide layers fill the 132 SMs.
//     Partial sums go to a float32 workspace and a second kernel adds them in
//     split order: no float atomics, so a run repeats bit for bit, and row m's
//     result does not depend on M (the split count depends on N and K only).
//     The stacked entry keeps the same plan, so at layer l it equals the
//     per-layer entry on that layer bit for bit.
// At M = 64 the float32 FMAs (64 per weight) bound it instead; the tensor-core
// prefill kernel is the better tool there, which a later change may route.
#include "w4_common.cuh"

namespace {

constexpr int kThreads = 128;   // output columns per block
constexpr int kChunk = 64;      // K rows of x staged per chunk

// The body. Requires gs % (32 / BITS) == 0 and k_per_split % gs == 0, so that
// a word never straddles a group, a split or a chunk.
template <int MT, int BITS>
__device__ __forceinline__ void decode_body(
        const __nv_bfloat16* __restrict__ x,       // (M, K)
        const uint32_t* __restrict__ wq,            // (K / epw, N)
        const __nv_bfloat16* __restrict__ scales,   // (K / gs, N)
        const __nv_bfloat16* __restrict__ zeros,    // (K / gs, N)
        float* __restrict__ partial,                // (splits, M, N)
        __nv_bfloat16* __restrict__ out,            // (M, N)
        int M, int N, int K, int gs, int k_per_split) {
    constexpr int EPW = 32 / BITS;           // codes per word
    constexpr int WPC = kChunk / EPW;        // words per chunk
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
        const int klen = min(kChunk, k_end - kc);   // a multiple of EPW
        for (int i = threadIdx.x; i < kChunk * MT; i += kThreads) {
            const int m = i / kChunk, kk = i % kChunk;
            float v = 0.f;
            if (m < M && kk < klen) v = __bfloat162float(x[(size_t)m * K + kc + kk]);
            xs[kk][m] = v;
        }
        __syncthreads();
        if (live) {
            const int nw = klen / EPW;
            uint32_t words[WPC];
            float s[WPC], z[WPC];
#pragma unroll
            for (int w = 0; w < WPC; ++w) {
                words[w] = 0u;
                s[w] = 0.f;
                z[w] = 0.f;
                if (w < nw) {
                    const int k0 = kc + w * EPW;
                    const size_t g = (size_t)(k0 / gs) * N + n;
                    words[w] = __ldg(wq + (size_t)(k0 / EPW) * N + n);
                    s[w] = __bfloat162float(scales[g]);
                    z[w] = __bfloat162float(zeros[g]);
                }
            }
#pragma unroll
            for (int w = 0; w < WPC; ++w) {
                if (w < nw) {
#pragma unroll
                    for (int j = 0; j < EPW; ++j) {
                        const float wv = dequant_mode4<BITS>(words[w], j, s[w], z[w]);
                        const float* xr = xs[w * EPW + j];
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

template <int MT, int BITS>
__global__ void __launch_bounds__(kThreads)
gemv_decode_kernel(const __nv_bfloat16* __restrict__ x, const uint32_t* __restrict__ wq,
                   const __nv_bfloat16* __restrict__ scales,
                   const __nv_bfloat16* __restrict__ zeros, float* __restrict__ partial,
                   __nv_bfloat16* __restrict__ out, int M, int N, int K, int gs,
                   int k_per_split) {
    decode_body<MT, BITS>(x, wq, scales, zeros, partial, out, M, N, K, gs, k_per_split);
}

// wq (L, K / epw, N), scales and zeros (L, K / gs, N); *layer_idx in [0, L).
// Offsets are size_t: a 32-layer stack of 14336 x 4096 W4 weights is 940 MB.
template <int MT, int BITS>
__global__ void __launch_bounds__(kThreads)
gemv_stacked_kernel(const __nv_bfloat16* __restrict__ x, const uint32_t* __restrict__ wq,
                    const __nv_bfloat16* __restrict__ scales,
                    const __nv_bfloat16* __restrict__ zeros, const int* __restrict__ layer_idx,
                    int L, float* __restrict__ partial, __nv_bfloat16* __restrict__ out,
                    int M, int N, int K, int gs, int k_per_split) {
    const int l = __ldg(layer_idx);          // the same 4 bytes for every thread
    if (l < 0 || l >= L) __trap();           // the caller's index is out of the stack
    const size_t words = (size_t)(K / (32 / BITS)) * N, groups = (size_t)(K / gs) * N;
    decode_body<MT, BITS>(x, wq + (size_t)l * words, scales + (size_t)l * groups,
                          zeros + (size_t)l * groups, partial, out, M, N, K, gs, k_per_split);
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

struct Args {
    const __nv_bfloat16* x;
    const uint32_t* wq;
    const __nv_bfloat16* scales;
    const __nv_bfloat16* zeros;
    const int* layer_idx;       // null: one layer
    int L;
    float* partial;
    __nv_bfloat16* out;
    int M, N, K, gs, splits, k_per_split;
};

template <int MT, int BITS>
cudaError_t launch(const Args& a, cudaStream_t stream) {
    const dim3 grid((a.N + kThreads - 1) / kThreads, a.splits);
    if (a.layer_idx)
        gemv_stacked_kernel<MT, BITS><<<grid, kThreads, 0, stream>>>(
            a.x, a.wq, a.scales, a.zeros, a.layer_idx, a.L, a.partial, a.out,
            a.M, a.N, a.K, a.gs, a.k_per_split);
    else
        gemv_decode_kernel<MT, BITS><<<grid, kThreads, 0, stream>>>(
            a.x, a.wq, a.scales, a.zeros, a.partial, a.out, a.M, a.N, a.K, a.gs,
            a.k_per_split);
    return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_rows(const Args& a, cudaStream_t stream) {
    if (a.M <= 1) return launch<1, BITS>(a, stream);
    if (a.M <= 2) return launch<2, BITS>(a, stream);
    if (a.M <= 4) return launch<4, BITS>(a, stream);
    if (a.M <= 8) return launch<8, BITS>(a, stream);
    if (a.M <= 16) return launch<16, BITS>(a, stream);
    if (a.M <= 32) return launch<32, BITS>(a, stream);
    if (a.M <= 64) return launch<64, BITS>(a, stream);
    return cudaErrorInvalidValue;
}

int run(const Args& a, int bits, cudaStream_t stream) {
    cudaError_t err;
    if (bits == 4) err = launch_rows<4>(a, stream);
    else if (bits == 2) err = launch_rows<2>(a, stream);
    else if (bits == 1) err = launch_rows<1>(a, stream);
    else return static_cast<int>(cudaErrorInvalidValue);
    if (err != cudaSuccess || a.splits == 1) return static_cast<int>(err);
    const int count = a.M * a.N;
    splitk_reduce_kernel<<<(count + 255) / 256, 256, 0, stream>>>(a.partial, a.out, count,
                                                                 a.splits);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`. With splits > 1, `partial` holds splits * M * N floats.
// `bits` is 1, 2 or 4. Returns the cudaError_t of the launches (0 on success).
extern "C" int gl_decode(const void* x, const void* wq, const void* scales, const void* zeros,
                         void* partial, void* out, int M, int N, int K, int gs, int bits,
                         int splits, int k_per_split, void* stream_ptr) {
    const Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const uint32_t*>(wq),
                 static_cast<const __nv_bfloat16*>(scales),
                 static_cast<const __nv_bfloat16*>(zeros), nullptr, 1,
                 static_cast<float*>(partial), static_cast<__nv_bfloat16*>(out),
                 M, N, K, gs, splits, k_per_split};
    return run(a, bits, static_cast<cudaStream_t>(stream_ptr));
}

// The same for layer *layer_idx (a device pointer to one int32) of the
// L-layer stacks wq (L, K / epw, N), scales and zeros (L, K / gs, N).
extern "C" int gl_decode_stacked(const void* x, const void* wq, const void* scales,
                                 const void* zeros, const void* layer_idx, void* partial,
                                 void* out, int L, int M, int N, int K, int gs, int bits,
                                 int splits, int k_per_split, void* stream_ptr) {
    if (layer_idx == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const uint32_t*>(wq),
                 static_cast<const __nv_bfloat16*>(scales),
                 static_cast<const __nv_bfloat16*>(zeros), static_cast<const int*>(layer_idx),
                 L, static_cast<float*>(partial), static_cast<__nv_bfloat16*>(out),
                 M, N, K, gs, splits, k_per_split};
    return run(a, bits, static_cast<cudaStream_t>(stream_ptr));
}
