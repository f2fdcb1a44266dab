// SPDX-License-Identifier: Apache-2.0
// W4 prefill GEMM for 64 < M < 4096: fused dequantize + bf16 tensor-core
// product, float32 accumulation, bf16 out.
//
// Replaces the TPU kernel gemlite_tpu/ops/pallas_prefill.py:pallas_prefill_matmul
// on the A16W4 W_group_mode 4 layers the serving path runs.
//
// What bounds it: at M >= 128 a 4-bit weight byte feeds 4*M flops, above the
// card's ~295 flops per byte, so the bound is the bf16 tensor-core rate. Design:
//   * a 128 x 128 output tile per block, 8 warps of 64 x 32, K stepped by 64
//     (a step never straddles a quantization group since gs % 64 == 0);
//   * per K-step the block loads the packed words and that group's scales and
//     zeros, dequantizes them once into a bf16 shared-memory tile, loads the x
//     tile, and runs nvcuda::wmma 16x16x16 bf16 products;
//   * rows past M (bucket padding) load as zeros and are not stored.
// Left for later: wgmma, TMA, a multi-stage cp.async pipeline, and a smaller
// tile or split-K where M * N gives fewer blocks than SMs (M = 128).
#include <mma.h>

#include "w4_common.cuh"

namespace {

using namespace nvcuda;

constexpr int BM = 128, BN = 128, BK = 64, kThreads = 256;
constexpr int APAD = 8, BPAD = 8;   // keep rows 16-byte aligned, spread banks

__global__ void __launch_bounds__(kThreads)
prefill_w4_kernel(const __nv_bfloat16* __restrict__ x,       // (M, K)
                  const uint32_t* __restrict__ wq,            // (K / 8, N)
                  const __nv_bfloat16* __restrict__ scales,   // (K / gs, N)
                  const __nv_bfloat16* __restrict__ zeros,    // (K / gs, N)
                  __nv_bfloat16* __restrict__ out,            // (M, N)
                  int M, int N, int K, int gs) {
    __shared__ __align__(32) __nv_bfloat16 As[BM][BK + APAD];
    __shared__ __align__(32) __nv_bfloat16 Bs[BK][BN + BPAD];
    __shared__ __align__(32) float Cs[kThreads / 32][16][16];

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
    const int wm = warp / 4, wn = warp % 4;   // warp tile: rows wm*64, cols wn*32

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.f);

    for (int k0 = 0; k0 < K; k0 += BK) {
        // x tile: BM rows x BK bf16, 16 bytes per load
        for (int i = tid; i < BM * BK / 8; i += kThreads) {
            const int r = i / (BK / 8), c8 = i % (BK / 8);
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (m0 + r < M)
                v = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + k0 + c8 * 8);
            *reinterpret_cast<uint4*>(&As[r][c8 * 8]) = v;
        }
        // weight tile: BK / 8 word rows x BN columns, dequantized once
        const int g = k0 / gs;
        for (int i = tid; i < (BK / 8) * BN; i += kThreads) {
            const int wr = i / BN, cc = i % BN, n = n0 + cc;
            uint32_t word = 0u;
            float s = 0.f, z = 0.f;
            if (n < N) {
                word = __ldg(wq + (size_t)(k0 / 8 + wr) * N + n);
                s = __bfloat162float(scales[(size_t)g * N + n]);
                z = __bfloat162float(zeros[(size_t)g * N + n]);
            }
#pragma unroll
            for (int j = 0; j < 8; ++j)
                Bs[wr * 8 + j][cc] = __float2bfloat16_rn(dequant_w4_mode4(word, j, s, z));
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[4];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                wmma::load_matrix_sync(a[i], &As[wm * 64 + i * 16][kk], BK + APAD);
#pragma unroll
            for (int j = 0; j < 2; ++j)
                wmma::load_matrix_sync(b[j], &Bs[kk][wn * 32 + j * 16], BN + BPAD);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
        }
        __syncthreads();
    }

    // epilogue: one 16x16 fragment at a time through the warp's staging tile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            wmma::store_matrix_sync(&Cs[warp][0][0], c[i][j], 16, wmma::mem_row_major);
            __syncwarp();
            for (int e = lane; e < 256; e += 32) {
                const int r = e / 16, cc = e % 16;
                const int gm = m0 + wm * 64 + i * 16 + r;
                const int gn = n0 + wn * 32 + j * 16 + cc;
                if (gm < M && gn < N) out[(size_t)gm * N + gn] = __float2bfloat16_rn(Cs[warp][r][cc]);
            }
            __syncwarp();
        }
    }
}

}  // namespace

// Launch on `stream`; K % 64 == 0 and gs % 64 == 0. Returns the cudaError_t.
extern "C" int gl_prefill_w4(const void* x, const void* wq, const void* scales,
                             const void* zeros, void* out, int M, int N, int K, int gs,
                             void* stream_ptr) {
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    prefill_w4_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const uint32_t*>(wq),
        static_cast<const __nv_bfloat16*>(scales), static_cast<const __nv_bfloat16*>(zeros),
        static_cast<__nv_bfloat16*>(out), M, N, K, gs);
    return static_cast<int>(cudaGetLastError());
}
