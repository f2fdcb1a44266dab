// SPDX-License-Identifier: Apache-2.0
// General fused dequantize + GEMM: out = csm(x @ dequant(W)) for any M.
//
// Replaces the TPU kernel gemlite_tpu/ops/pallas_gemm.py:pallas_fused_matmul
// for every integer-code form its gate admits: x in fp16 / bf16 / fp32 /
// int8; W1/2/4/8 codes in LSB-first int32 words, or non-packed int8 / fp16 /
// bf16 weights (elements_per_sample 1); W_group_mode 0-4 with scalar or
// grouped zeros; channel_scale_mode 0-3.
//
// Arithmetic (pallas_gemm.py:145-212):
//   * int path (int8 x, W_group_mode 0 or a scalar-zero shift, codes that
//     fit int8): int8 x int8 -> int32 on the tensor cores (wmma s8), exact;
//   * else the weight tile is dequantized in the compute dtype (bf16 for int8
//     x), rounded after every op as the TPU kernel's meta_f32=False
//     arithmetic is, and multiplied on the tensor cores (wmma bf16 / fp16)
//     with float32 sums; float32 x takes CUDA-core FMAs in float32 (TF32
//     would drift from the reference);
//   * the epilogue scales the accumulator in float32: csm 1 * s[n],
//     2 * sx[m], 3 * sx[m] * s[n].
//
// What bounds it: at the prefill shapes it serves (A8W8, M = 65..4095) the
// int8 weights are read once per row tile of 128 rows, so at M <= 128 the
// bound is the weight bytes over HBM bandwidth (M=128, 14336x4096 int8:
// about 63 MB / 3.35 TB/s = 18.8 us; 15 G int ops / 1,979 TOPS = 7.6 us).
// This first version is simple on purpose. The int path (int_gemm_kernel):
// 128 x 128 output tiles, K steps of 64, 16-byte loads of x and of
// non-packed int8 weights, packed codes unpacked into the int8 tile, and K
// split over the grid when the tiles alone would leave SMs idle. The float
// path (fused_gemm_tc_kernel): one block owns a 64 x 128 output tile and
// loops over K in steps of 32; each step stages x and the dequantized weight
// tile in shared memory, then 8 warps run wmma 16x16x16. No wgmma, TMA or
// pipelining yet: loads and math do not overlap within a block, only across
// the blocks resident on an SM.
#include <mma.h>

#include "gl_common.cuh"

namespace {

using namespace nvcuda;

constexpr int BM = 64, BN = 128, BK = 32, kThreads = 256;

struct Params {
    const void* x;            // (M, K)
    const void* W;            // (K / elems, N) int32 words, or (K, N) int8 / fp16 / bf16
    const void* scales;       // (K / gs_s, N) group scales, or (1, N) channel scales
    const void* zeros;        // (K / gs_z, N), or nullptr
    const int* zero_scalar;   // one int32, or nullptr
    const float* sx;          // (M) per-token scales, or nullptr
    void* out;                // (M, N)
    int M, N, K, W_nbits, elems, w_code, mode, csm, gs_s, gs_z, s_code, z_code, out_code;
};

// round to the compute dtype, as a float
template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}
template <> __device__ __forceinline__ float rnd<__half>(float v) {
    return __half2float(__float2half_rn(v));
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_float<__half>(float v) {
    return __float2half_rn(v);
}

// W_group_mode dequantization of one weight (pallas_gemm.py:159-185), every
// op rounded to the compute dtype MD
template <typename MD>
__device__ __forceinline__ float dequant(float c, int k, int n, const Params& p) {
    if (p.mode == 0) return rnd<MD>(c);
    float s = 0.f, z = 0.f;
    if (p.mode >= 2) s = rnd<MD>(gl::load_meta(p.scales, (size_t)(k / p.gs_s) * p.N + n, p.s_code));
    if ((p.mode == 1 || p.mode >= 3) && p.zero_scalar == nullptr)
        z = rnd<MD>(gl::load_meta(p.zeros, (size_t)(k / p.gs_z) * p.N + n, p.z_code));
    const float b = rnd<MD>(c);
    switch (p.mode) {
        case 1:
            if (p.zero_scalar != nullptr) z = rnd<MD>((float)*p.zero_scalar);
            return rnd<MD>(__fsub_rn(b, z));
        case 2:
            return rnd<MD>(__fmul_rn(b, s));
        case 3:
            if (p.zero_scalar != nullptr)
                return rnd<MD>(__fmul_rn(rnd<MD>((float)((int)c - *p.zero_scalar)), s));
            return rnd<MD>(__fmul_rn(rnd<MD>(__fsub_rn(b, z)), s));
        default:
            return rnd<MD>(__fadd_rn(rnd<MD>(__fmul_rn(b, s)), z));
    }
}

// The (BK, TN) weight tile at (k0, n0), dequantized in CT: store(kk, nn, v)
// for every kk < BK, nn < TN. (Loading all of a thread's words first, then
// decoding them, measured slower on the H100 and made nvcc take a minute
// longer.)
template <typename CT, int TN, typename Store>
__device__ __forceinline__ void load_w_tile(const Params& p, int k0, int n0, Store store) {
    const int e = p.elems;
    const int items = (BK / e) * TN;
    for (int it = threadIdx.x; it < items; it += kThreads) {
        const int r = it / TN, nn = it % TN, n = n0 + nn;
        const int kb = r * e;
        if (n >= p.N) {
            for (int j = 0; j < e; ++j) store(kb + j, nn, 0.f);
            continue;
        }
        if (e == 1) {
            const size_t i = (size_t)(k0 + kb) * p.N + n;
            const float c = p.w_code == gl::kI8 ? (float)static_cast<const int8_t*>(p.W)[i]
                                                : gl::load_meta(p.W, i, p.w_code);
            store(kb, nn, dequant<CT>(c, k0 + kb, n, p));
            continue;
        }
        const uint32_t word = static_cast<const uint32_t*>(p.W)[(size_t)((k0 + kb) / e) * p.N + n];
        const uint32_t mask = (1u << p.W_nbits) - 1u;
        for (int j = 0; j < e; ++j)
            store(kb + j, nn, dequant<CT>((float)((word >> (j * p.W_nbits)) & mask), k0 + kb + j, n, p));
    }
}

// Tensor-core kernel of the float path. CT: the compute type (bf16, fp16);
// XT: x's type (CT, or int8 off the int path). Shared tiles keep k innermost
// in chunks of 16 (A row-major, B col-major), so every wmma pointer is
// 32-byte aligned.
template <typename CT, typename XT>
__global__ void __launch_bounds__(kThreads) fused_gemm_tc_kernel(Params p) {
    constexpr int LDK = 24;
    constexpr int kTileBytes = 2 * (BM + BN) * LDK * (int)sizeof(CT);
    constexpr int kCBytes = BM * BN * 4;
    __shared__ __align__(128) unsigned char smem[kTileBytes > kCBytes ? kTileBytes : kCBytes];
    CT* As = reinterpret_cast<CT*>(smem);                  // [BK/16][BM][LDK]
    CT* Bs = As + 2 * BM * LDK;                            // [BK/16][BN][LDK]

    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
    const int warp = threadIdx.x >> 5, wm = warp >> 2, wn = warp & 3;   // 2 x 4 warps

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    const XT* x = static_cast<const XT*>(p.x);
    for (int k0 = 0; k0 < p.K; k0 += BK) {
        // ---- x tile (BM, BK) ----
        if constexpr (sizeof(XT) == 2) {
            const int row = threadIdx.x >> 2, kq = (threadIdx.x & 3) * 8;
            uint4 v = make_uint4(0, 0, 0, 0);
            if (m0 + row < p.M)
                v = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + row) * p.K + k0 + kq);
            *reinterpret_cast<uint4*>(As + ((kq >> 4) * BM + row) * LDK + (kq & 15)) = v;
        } else if (threadIdx.x < BM * 2) {               // int8 x, 16 per thread
            const int row = threadIdx.x >> 1, kq = (threadIdx.x & 1) * 16;
            uint4 v = make_uint4(0, 0, 0, 0);
            if (m0 + row < p.M)
                v = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + row) * p.K + k0 + kq);
            CT* dst = As + ((kq >> 4) * BM + row) * LDK;
            const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
            for (int i = 0; i < 16; ++i) dst[i] = from_float<CT>((float)b[i]);
        }
        // ---- weight tile (BK, BN), dequantized ----
        load_w_tile<CT, BN>(p, k0, n0, [&](int kk, int nn, float v) {
            Bs[((kk >> 4) * BN + nn) * LDK + (kk & 15)] = from_float<CT>(v);
        });
        __syncthreads();
#pragma unroll
        for (int kc = 0; kc < BK / 16; ++kc) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, CT, wmma::row_major> a[2];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, CT, wmma::col_major> b[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                wmma::load_matrix_sync(a[i], As + (kc * BM + wm * 32 + i * 16) * LDK, LDK);
#pragma unroll
            for (int j = 0; j < 2; ++j)
                wmma::load_matrix_sync(b[j], Bs + (kc * BN + wn * 32 + j * 16) * LDK, LDK);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }

    float* Cs = reinterpret_cast<float*>(smem);             // [BM][BN], reuses the tiles
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
            wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * BN + wn * 32 + j * 16, acc[i][j], BN,
                                    wmma::mem_row_major);
    __syncthreads();
    for (int idx = threadIdx.x; idx < BM * BN; idx += kThreads) {
        const int m = m0 + idx / BN, n = n0 + idx % BN;
        if (m >= p.M || n >= p.N) continue;
        const float v = gl::channel_scale(Cs[idx], p.csm, p.scales, p.s_code, p.sx, m, n);
        gl::store_out(p.out, (size_t)m * p.N + n, v, p.out_code);
    }
}

// float32 x: CUDA-core FMAs in float32 over a 64 x 64 tile, 4 x 4 per thread.
constexpr int FBM = 64, FBN = 64;

__global__ void __launch_bounds__(kThreads) fused_gemm_f32_kernel(Params p) {
    __shared__ __align__(16) float As[BK][FBM + 4];
    __shared__ __align__(16) float Bs[BK][FBN];
    const int m0 = blockIdx.y * FBM, n0 = blockIdx.x * FBN;
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    float acc[4][4] = {};
    const float* x = static_cast<const float*>(p.x);
    for (int k0 = 0; k0 < p.K; k0 += BK) {
        for (int i = threadIdx.x; i < FBM * BK / 4; i += kThreads) {
            const int row = i / (BK / 4), kq = (i % (BK / 4)) * 4;
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (m0 + row < p.M) v = *reinterpret_cast<const float4*>(x + (size_t)(m0 + row) * p.K + k0 + kq);
            As[kq + 0][row] = v.x; As[kq + 1][row] = v.y; As[kq + 2][row] = v.z; As[kq + 3][row] = v.w;
        }
        load_w_tile<float, FBN>(p, k0, n0, [&](int kk, int nn, float v) { Bs[kk][nn] = v; });
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < BK; ++kk) {
            float a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int m = m0 + ty * 4 + i, n = n0 + tx * 4 + j;
            if (m >= p.M || n >= p.N) continue;
            const float v = gl::channel_scale(acc[i][j], p.csm, p.scales, p.s_code, p.sx, m, n);
            gl::store_out(p.out, (size_t)m * p.N + n, v, p.out_code);
        }
}

// Int path: int8 x against int8 weights, 128 x 128 output tiles, K steps of
// 64, wmma s8 with int32 sums. The weights are non-packed (int8, or fp16 /
// bf16 holding whole values), or W1/2/4 codes unpacked from their words; in
// W_group_mode 1 each is shifted by the scalar zero and wrapped to int8, as
// the plain version's cast does. Each 16 x 16 operand tile is 256
// contiguous bytes in shared memory (As[k/16][m][16], Bs[n/16][k][16]), so
// every wmma pointer is aligned and the rows are 16 bytes apart. x comes in
// 16-byte loads, and so do int8 weights on the kVec path; packed words and
// other non-packed weights are read one item per thread and unpacked byte by
// byte. Rows past M, columns past N and k past the split's end are zero. With splits > 1 the block sums one K range and adds
// its int32 tile into acc by atomicAdd (exact in any order); a second kernel
// applies the epilogue. With one split it applies the epilogue itself.
constexpr int IBM = 128, IBN = 128, IBK = 64;

// each byte minus the zero, wrapped to 8 bits (zrep: the zero in every byte)
__device__ __forceinline__ uint4 shift_bytes(uint4 v, unsigned zrep) {
    return make_uint4(__vsub4(v.x, zrep), __vsub4(v.y, zrep), __vsub4(v.z, zrep), __vsub4(v.w, zrep));
}

// kVec: int8 weights in 16-byte loads, with N % 16 == 0 and K % IBK == 0, so
// that no load of a step needs a bounds check in k (A8W8 at the model's
// widths); otherwise packed words or other non-packed values, item by item.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
int_gemm_kernel(Params p, int* __restrict__ acc, int k_per_split) {
    __shared__ __align__(128) int8_t As[IBK / 16][IBM][16];
    __shared__ __align__(128) int8_t Bs[IBN / 16][IBK][16];
    __shared__ __align__(128) int Cw[kThreads / 32][16 * 16];
    const int m0 = blockIdx.y * IBM, n0 = blockIdx.x * IBN;
    const int k_begin = blockIdx.z * k_per_split, k_end = min(p.K, k_begin + k_per_split);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = warp >> 2, wn = warp & 3;                   // 2 x 4 warps of 64 x 32
    const int8_t* x = static_cast<const int8_t*>(p.x);
    const int zero = p.mode == 1 ? *p.zero_scalar : 0;
    const unsigned zrep = (unsigned)(zero & 0xff) * 0x01010101u;
    const int e = p.elems;

    wmma::fragment<wmma::accumulator, 16, 16, 16, int> c[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0);

    for (int k0 = k_begin; k0 < k_end; k0 += IBK) {
        // all 16-byte loads of the step first, then the shared-memory stores
        uint4 av[2], bv[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {                          // x: 128 rows x 64 bytes
            const int idx = threadIdx.x + i * kThreads, row = idx >> 2, kq = (idx & 3) * 16;
            av[i] = make_uint4(0, 0, 0, 0);
            if (m0 + row < p.M && (kVec || k0 + kq < k_end))
                av[i] = __ldg(reinterpret_cast<const uint4*>(x + (size_t)(m0 + row) * p.K + k0 + kq));
        }
        if constexpr (kVec) {                                  // W: 64 rows x 128 bytes
            const int8_t* W = static_cast<const int8_t*>(p.W);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const int idx = threadIdx.x + i * kThreads, k = idx >> 3, j = idx & 7;
                bv[i] = make_uint4(0, 0, 0, 0);
                if (n0 + j * 16 < p.N)
                    bv[i] = __ldg(reinterpret_cast<const uint4*>(W + (size_t)(k0 + k) * p.N + n0 + j * 16));
            }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int idx = threadIdx.x + i * kThreads;
            *reinterpret_cast<uint4*>(&As[idx & 3][idx >> 2][0]) = av[i];
            if constexpr (kVec)
                *reinterpret_cast<uint4*>(&Bs[idx & 7][idx >> 3][0]) = zrep ? shift_bytes(bv[i], zrep) : bv[i];
        }
        if constexpr (!kVec) {                                 // one word (or value) per item
            const uint32_t mask = (1u << p.W_nbits) - 1u;
            for (int it = threadIdx.x; it < (IBK / e) * IBN; it += kThreads) {
                const int nn = it % IBN, n = n0 + nn, kb = (it / IBN) * e;
                int8_t* dst = &Bs[nn >> 4][kb][nn & 15];       // k steps 16 bytes apart
                if (n >= p.N || k0 + kb >= k_end) {
                    for (int j = 0; j < e; ++j) dst[j * 16] = 0;
                } else if (e == 1) {                           // int8, or whole-valued fp16 / bf16
                    const size_t i = (size_t)(k0 + kb) * p.N + n;
                    const int v = p.w_code == gl::kI8 ? (int)static_cast<const int8_t*>(p.W)[i]
                                                      : (int)gl::load_meta(p.W, i, p.w_code);
                    dst[0] = (int8_t)(v - zero);
                } else {
                    const uint32_t word =
                        static_cast<const uint32_t*>(p.W)[(size_t)((k0 + kb) / e) * p.N + n];
                    for (int j = 0; j < e; ++j)
                        dst[j * 16] = (int8_t)((int)((word >> (j * p.W_nbits)) & mask) - zero);
                }
            }
        }
        __syncthreads();
#pragma unroll
        for (int kc = 0; kc < IBK / 16; ++kc) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a[4];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> b[2];
#pragma unroll
            for (int i = 0; i < 4; ++i) wmma::load_matrix_sync(a[i], &As[kc][wm * 64 + i * 16][0], 16);
#pragma unroll
            for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], &Bs[wn * 2 + j][kc * 16][0], 16);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
        }
        __syncthreads();
    }

    const bool split = gridDim.z > 1;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            wmma::store_matrix_sync(Cw[warp], c[i][j], 16, wmma::mem_row_major);
            __syncwarp();
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                const int t = lane * 8 + e;
                const int m = m0 + wm * 64 + i * 16 + (t >> 4), n = n0 + wn * 32 + j * 16 + (t & 15);
                if (m < p.M && n < p.N) {
                    if (split) {
                        atomicAdd(acc + (size_t)m * p.N + n, Cw[warp][t]);
                    } else {
                        const float v = gl::channel_scale(__int2float_rn(Cw[warp][t]), p.csm,
                                                          p.scales, p.s_code, p.sx, m, n);
                        gl::store_out(p.out, (size_t)m * p.N + n, v, p.out_code);
                    }
                }
            }
            __syncwarp();
        }
}

// out = csm(float(acc)) for the split int path
__global__ void int_epilogue_kernel(Params p, const int* __restrict__ acc) {
    const size_t count = (size_t)p.M * p.N;
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= count) return;
    const int m = (int)(i / p.N), n = (int)(i % p.N);
    const float v = gl::channel_scale(__int2float_rn(acc[i]), p.csm, p.scales, p.s_code, p.sx, m, n);
    gl::store_out(p.out, i, v, p.out_code);
}

template <typename CT, typename XT>
cudaError_t launch_tc(const Params& p, cudaStream_t stream) {
    const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM);
    fused_gemm_tc_kernel<CT, XT><<<grid, kThreads, 0, stream>>>(p);
    return cudaGetLastError();
}

}  // namespace

// Launch on `stream`. x_code / w_code / s_code / z_code / out_code are DType
// values; int_path selects the int8 tensor-core path (int8 x, W_group_mode 0
// or 1 with a scalar zero, non-packed weights or W1/2/4 codes), and
// int8 x off it computes in bf16. On the int path K is cut into `splits`
// ranges of `k_per_split` (a multiple of 64; the last range may be shorter);
// with splits > 1 it needs `acc`, M * N int32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int gl_fused_gemm(const void* x, const void* W, const void* scales, const void* zeros,
                             const void* zero_scalar, const void* sx, void* out, void* acc,
                             int M, int N, int K, int x_code, int int_path, int W_nbits, int elems,
                             int w_code, int mode, int csm, int gs_s, int gs_z, int s_code,
                             int z_code, int out_code, int splits, int k_per_split,
                             void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if (K % BK || BK % elems || M < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    Params p{x, W, scales, zeros, static_cast<const int*>(zero_scalar),
             static_cast<const float*>(sx), out, M, N, K, W_nbits, elems, w_code, mode, csm,
             gs_s, gs_z, s_code, z_code, out_code};
    if (int_path) {
        const bool w_ok = elems == 1 || (W_nbits < 8 && elems * W_nbits == 32);
        if (x_code != gl::kI8 || !w_ok || mode > 1 || (mode == 1 && zero_scalar == nullptr) ||
            splits < 1 || k_per_split % IBK || (long long)splits * k_per_split < K ||
            (splits > 1 && acc == nullptr))
            return static_cast<int>(cudaErrorInvalidValue);
        const dim3 grid((N + IBN - 1) / IBN, (M + IBM - 1) / IBM, splits);
        if (splits > 1) {
            const cudaError_t err = cudaMemsetAsync(acc, 0, (size_t)M * N * sizeof(int), stream);
            if (err != cudaSuccess) return static_cast<int>(err);
        }
        if (elems == 1 && w_code == gl::kI8 && N % 16 == 0 && K % IBK == 0)
            int_gemm_kernel<true><<<grid, kThreads, 0, stream>>>(p, static_cast<int*>(acc), k_per_split);
        else
            int_gemm_kernel<false><<<grid, kThreads, 0, stream>>>(p, static_cast<int*>(acc), k_per_split);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
        const size_t count = (size_t)M * N;
        int_epilogue_kernel<<<(unsigned)((count + 255) / 256), 256, 0, stream>>>(
            p, static_cast<const int*>(acc));
        return static_cast<int>(cudaGetLastError());
    }
    if (x_code == gl::kF32) {
        const dim3 grid((N + FBN - 1) / FBN, (M + FBM - 1) / FBM);
        fused_gemm_f32_kernel<<<grid, kThreads, 0, stream>>>(p);
        return static_cast<int>(cudaGetLastError());
    }
    if (x_code == gl::kBF16) return static_cast<int>(launch_tc<__nv_bfloat16, __nv_bfloat16>(p, stream));
    if (x_code == gl::kF16) return static_cast<int>(launch_tc<__half, __half>(p, stream));
    if (x_code == gl::kI8) return static_cast<int>(launch_tc<__nv_bfloat16, int8_t>(p, stream));
    return static_cast<int>(cudaErrorInvalidValue);
}
