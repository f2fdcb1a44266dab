// SPDX-License-Identifier: Apache-2.0
// Exact int8 decode for M <= 64: out = csm(x_i8 @ dequant_int(W)), the sum
// over K in int32 by __dp4a on the CUDA cores.
//
// Replaces the TPU kernel gemlite_tpu/ops/pallas_int8.py:pallas_int8_decode
// for its three weight forms (_w_kind there):
//   kDense  non-packed int8 (K, N): A8W8, W_group_mode 0, csm 3;
//   kU8     W8 codes, 4 to an int32 word: code ^ 0x80 is (code - 128) as
//           int8, and (128 - z) * sum(x) restores x . (code - z);
//   kNib4 / kNib2  W4 / W2 codes, 8 / 16 to a word, unpacked to bytes in
//           natural k order with __byte_perm (codes 0..15 fit int8).
// Zeros are integers: none, one scalar, one per column, or one per group.
// The TPU kernel's byte-plane layout and its host-side permutation of x are
// not carried over: every form is unpacked to 4-k words in natural k order.
//
// What bounds it: at M <= 8 the weight bytes (K*N for int8) dwarf x and the
// output, so the bound is bytes over HBM bandwidth (M=8, 14336x4096: about
// 59 MB / 3.35 TB/s = 17.6 us). Design for that:
//   * a warp owns 128 output columns, a lane 4 adjacent ones; a lane reads 16
//     bytes of packed words per step (4 bytes per k row for dense int8, 128
//     contiguous bytes per warp), so every load is coalesced;
//   * x is read through the L1 cache: all lanes of a warp read the same word;
//   * K is split over gridDim.y so that the grid holds two to four blocks per
//     SM; rows are tiled by MT (up to 8) over gridDim.z, and the weights are
//     read again per row tile, which costs at M > 8;
//   * integer sums are exact in any order, so split sums meet by atomicAdd
//     on an int32 accumulator, and the result is bit-identical at every split
//     count and every M (rows never interact);
//   * a second kernel applies the epilogue: the channel-wise mode-3 scale,
//     then csm 1/2/3 in float32, and the cast to the output dtype.
// Grouped mode-3 scales are float: each group's exact int32 sum is scaled
// in float32 and the groups are added in float32 in k order within a split;
// the split sums go to a float32 workspace, and the epilogue adds them in
// split order. No float atomics, so a run repeats bit for bit.
#include "gl_common.cuh"

namespace {

constexpr int kThreads = 128;   // 4 warps, 512 columns per block
enum Kind { kDense = 0, kU8 = 1, kNib4 = 2, kNib2 = 3 };

__host__ __device__ constexpr int step_k(int kind) {
    return kind == kNib4 ? 8 : (kind == kNib2 ? 16 : 4);
}

// One load step for columns n..n+3 at k: w[c][j] holds 4 int8 weights of
// column n + c at k + 4j .. k + 4j + 3, lowest byte first.
template <int KIND>
__device__ __forceinline__ void load_weights(const void* W, int N, int k, int n,
                                             uint32_t (&w)[4][step_k(KIND) / 4]) {
    if constexpr (KIND == kDense) {
        const int8_t* Wd = static_cast<const int8_t*>(W);
        uint32_t r[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
            r[j] = __ldg(reinterpret_cast<const uint32_t*>(Wd + (size_t)(k + j) * N + n));
        // 4x4 byte transpose: rows k..k+3 x columns -> a 4-k word per column
        const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[0], r[1], 0x7362);
        const uint32_t u0 = __byte_perm(r[2], r[3], 0x5140), u1 = __byte_perm(r[2], r[3], 0x7362);
        w[0][0] = __byte_perm(t0, u0, 0x5410);
        w[1][0] = __byte_perm(t0, u0, 0x7632);
        w[2][0] = __byte_perm(t1, u1, 0x5410);
        w[3][0] = __byte_perm(t1, u1, 0x7632);
    } else {
        constexpr int E = KIND == kU8 ? 4 : (KIND == kNib4 ? 8 : 16);
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(
            static_cast<const uint32_t*>(W) + (size_t)(k / E) * N + n));
        const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            if constexpr (KIND == kU8) {
                w[c][0] = words[c] ^ 0x80808080u;
            } else if constexpr (KIND == kNib4) {
                // byte b of lo / hi holds the codes of k = 2b / 2b + 1
                const uint32_t lo = words[c] & 0x0F0F0F0Fu, hi = (words[c] >> 4) & 0x0F0F0F0Fu;
                w[c][0] = __byte_perm(lo, hi, 0x5140);
                w[c][1] = __byte_perm(lo, hi, 0x7362);
            } else {
                // byte b of plane p holds the code of k = 4b + p
                uint32_t p[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) p[i] = (words[c] >> (2 * i)) & 0x03030303u;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const uint32_t sel = j | ((4 + j) << 4);
                    w[c][j] = __byte_perm(__byte_perm(p[0], p[1], sel),
                                          __byte_perm(p[2], p[3], sel), 0x5410);
                }
            }
        }
    }
}

template <int S>
__device__ __forceinline__ void load_x(const int8_t* x, int k, uint32_t (&xw)[S / 4]) {
    const int8_t* p = x + k;
    if constexpr (S == 4) {
        xw[0] = __ldg(reinterpret_cast<const uint32_t*>(p));
    } else if constexpr (S == 8) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
        xw[0] = v.x; xw[1] = v.y;
    } else {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
        xw[0] = v.x; xw[1] = v.y; xw[2] = v.z; xw[3] = v.w;
    }
}

// r[m][c] += x[m0 + m, k] . w[k, n + c] and xs[m] += x[m0 + m, k] over k in
// [k_lo, k_hi), all in int32.
template <int KIND, int MT>
__device__ __forceinline__ void span_sum(const int8_t* __restrict__ x, const void* __restrict__ W,
                                         int M, int N, int K, int m0, int n, int k_lo, int k_hi,
                                         int (&r)[MT][4], int (&xs)[MT]) {
    constexpr int S = step_k(KIND), SW = S / 4;
#pragma unroll 2
    for (int k = k_lo; k < k_hi; k += S) {
        uint32_t w[4][SW];
        load_weights<KIND>(W, N, k, n, w);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
            uint32_t xw[SW];
            if (m0 + m < M) {
                load_x<S>(x + (size_t)(m0 + m) * K, k, xw);
            } else {
#pragma unroll
                for (int j = 0; j < SW; ++j) xw[j] = 0u;
            }
#pragma unroll
            for (int j = 0; j < SW; ++j) {
                xs[m] = __dp4a((int)xw[j], 0x01010101, xs[m]);
#pragma unroll
                for (int c = 0; c < 4; ++c) r[m][c] = __dp4a((int)xw[j], (int)w[c][j], r[m][c]);
            }
        }
    }
}

template <int KIND, int MT, bool FGROUP>
__global__ void __launch_bounds__(kThreads)
int8_decode_kernel(const int8_t* __restrict__ x,          // (M, K)
                   const void* __restrict__ W,            // (K, N) int8 or (K / E, N) words
                   const float* __restrict__ zeros,       // (1, N) or (G, N), integer values
                   const int* __restrict__ zero_scalar,   // one int32
                   const float* __restrict__ scales,      // (G, N), FGROUP only
                   int* __restrict__ acc_out,             // (M, N), zeroed
                   float* __restrict__ part_out,          // (splits, M, N), FGROUP only
                   int M, int N, int K, int gs_loop, int k_per_split, int zero_mode, int off8) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n = (blockIdx.x * (kThreads / 32) + warp) * 128 + lane * 4;
    if (n >= N) return;   // N % 4 == 0: a lane's 4 columns are all in range
    const int split = blockIdx.y, m0 = blockIdx.z * MT;
    const int k_begin = split * k_per_split, k_end = min(K, k_begin + k_per_split);
    const int span = gs_loop > 0 ? gs_loop : k_end - k_begin;

    int zc[4] = {0, 0, 0, 0};
    if (zero_mode == 1) {
        const int z = *zero_scalar;
#pragma unroll
        for (int c = 0; c < 4; ++c) zc[c] = z;
    } else if (zero_mode == 2) {
#pragma unroll
        for (int c = 0; c < 4; ++c) zc[c] = (int)zeros[n + c];
    }

    int acc[MT][4];
    float facc[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c) { acc[m][c] = 0; facc[m][c] = 0.f; }

    for (int g0 = k_begin; g0 < k_end; g0 += span) {
        int xs[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m) xs[m] = 0;
        const size_t grow = gs_loop > 0 ? (size_t)(g0 / gs_loop) * N + n : 0;
        if (zero_mode == 3) {
#pragma unroll
            for (int c = 0; c < 4; ++c) zc[c] = (int)zeros[grow + c];
        }
        if constexpr (FGROUP) {
            int raw[MT][4];
#pragma unroll
            for (int m = 0; m < MT; ++m)
#pragma unroll
                for (int c = 0; c < 4; ++c) raw[m][c] = 0;
            span_sum<KIND, MT>(x, W, M, N, K, m0, n, g0, g0 + span, raw, xs);
#pragma unroll
            for (int m = 0; m < MT; ++m)
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const int corr = raw[m][c] + (off8 - zc[c]) * xs[m];
                    facc[m][c] = __fadd_rn(facc[m][c],
                                           __fmul_rn(__int2float_rn(corr), scales[grow + c]));
                }
        } else {
            span_sum<KIND, MT>(x, W, M, N, K, m0, n, g0, g0 + span, acc, xs);
#pragma unroll
            for (int m = 0; m < MT; ++m)
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[m][c] += (off8 - zc[c]) * xs[m];
        }
    }

#pragma unroll
    for (int m = 0; m < MT; ++m) {
        if (m0 + m >= M) break;
        const size_t i = (size_t)(m0 + m) * N + n;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            if constexpr (FGROUP) part_out[(size_t)split * M * N + i + c] = facc[m][c];
            else atomicAdd(acc_out + i + c, acc[m][c]);
        }
    }
}

// out = csm(flat_scale ? v * s : v), v = the int32 sum or the float32 split
// sums added in split order.
__global__ void int8_epilogue_kernel(const int* __restrict__ acc, const float* __restrict__ part,
                                     int splits, const float* __restrict__ scales,
                                     const float* __restrict__ sx, void* __restrict__ out,
                                     int M, int N, int flat_scale, int csm, int out_code) {
    const size_t count = (size_t)M * N;
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= count) return;
    const int m = (int)(i / N), n = (int)(i % N);
    float v;
    if (part != nullptr) {
        v = part[i];
        for (int s = 1; s < splits; ++s) v = __fadd_rn(v, part[(size_t)s * count + i]);
    } else {
        v = __int2float_rn(acc[i]);
    }
    if (flat_scale) v = __fmul_rn(v, scales[n]);
    v = gl::channel_scale(v, csm, scales, gl::kF32, sx, m, n);
    gl::store_out(out, i, v, out_code);
}

template <int KIND, int MT, bool FGROUP>
cudaError_t launch(const void* x, const void* W, const void* zeros, const void* zero_scalar,
                   const void* scales, void* acc, void* part, int M, int N, int K, int gs_loop,
                   int splits, int k_per_split, int zero_mode, int off8, cudaStream_t stream) {
    const dim3 grid((N + 4 * 128 - 1) / (4 * 128), splits, (M + MT - 1) / MT);
    int8_decode_kernel<KIND, MT, FGROUP><<<grid, kThreads, 0, stream>>>(
        static_cast<const int8_t*>(x), W, static_cast<const float*>(zeros),
        static_cast<const int*>(zero_scalar), static_cast<const float*>(scales),
        static_cast<int*>(acc), static_cast<float*>(part), M, N, K, gs_loop, k_per_split,
        zero_mode, off8);
    return cudaGetLastError();
}

template <int KIND, bool FGROUP>
cudaError_t launch_mt(const void* x, const void* W, const void* zeros, const void* zero_scalar,
                      const void* scales, void* acc, void* part, int M, int N, int K, int gs_loop,
                      int splits, int k_per_split, int zero_mode, int off8, cudaStream_t stream) {
#define GL_LAUNCH(MT) launch<KIND, MT, FGROUP>(x, W, zeros, zero_scalar, scales, acc, part, M, N, \
                                               K, gs_loop, splits, k_per_split, zero_mode, off8, stream)
    if (M <= 1) return GL_LAUNCH(1);
    if (M <= 2) return GL_LAUNCH(2);
    if (M <= 4) return GL_LAUNCH(4);
    return GL_LAUNCH(8);
#undef GL_LAUNCH
}

template <bool FGROUP>
cudaError_t launch_kind(int kind, const void* x, const void* W, const void* zeros,
                        const void* zero_scalar, const void* scales, void* acc, void* part,
                        int M, int N, int K, int gs_loop, int splits, int k_per_split,
                        int zero_mode, int off8, cudaStream_t stream) {
#define GL_KIND(KD) launch_mt<KD, FGROUP>(x, W, zeros, zero_scalar, scales, acc, part, M, N, K, \
                                          gs_loop, splits, k_per_split, zero_mode, off8, stream)
    switch (kind) {
        case kDense: return GL_KIND(kDense);
        case kU8: return GL_KIND(kU8);
        case kNib4: return GL_KIND(kNib4);
        case kNib2: return GL_KIND(kNib2);
        default: return cudaErrorInvalidValue;
    }
#undef GL_KIND
}

}  // namespace

// Launch on `stream`: zero the int32 accumulator (or fill the float32 split
// workspace, fgroup), run the sum, then the epilogue into `out`. Returns the
// cudaError_t of the launches (0 on success).
extern "C" int gl_int8_decode(const void* x, const void* W, const void* zeros,
                              const void* zero_scalar, const void* scales, const void* sx,
                              void* acc, void* part, void* out, int M, int N, int K, int kind,
                              int gs_loop, int splits, int k_per_split, int zero_mode, int off8,
                              int fgroup, int flat_scale, int csm, int out_code,
                              void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if (M < 1 || M > 64 || N % 4 || (fgroup ? part == nullptr : acc == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err;
    if (fgroup) {
        err = launch_kind<true>(kind, x, W, zeros, zero_scalar, scales, acc, part, M, N, K,
                                gs_loop, splits, k_per_split, zero_mode, off8, stream);
    } else {
        err = cudaMemsetAsync(acc, 0, (size_t)M * N * sizeof(int), stream);
        if (err == cudaSuccess)
            err = launch_kind<false>(kind, x, W, zeros, zero_scalar, scales, acc, part, M, N, K,
                                     gs_loop, splits, k_per_split, zero_mode, off8, stream);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t count = (size_t)M * N;
    int8_epilogue_kernel<<<(unsigned)((count + 255) / 256), 256, 0, stream>>>(
        static_cast<const int*>(fgroup ? nullptr : acc), static_cast<const float*>(fgroup ? part : nullptr),
        splits, static_cast<const float*>(scales), static_cast<const float*>(sx), out, M, N,
        flat_scale, csm, out_code);
    return static_cast<int>(cudaGetLastError());
}
