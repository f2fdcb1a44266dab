// SPDX-License-Identifier: Apache-2.0
// General fused dequantize + GEMM: out = csm(x @ dequant(W)) for any M, the
// paths of int8 and float32 x.
//
// Replaces the TPU kernel gemlite_tpu/ops/pallas_gemm.py:pallas_fused_matmul
// for every integer-code form its gate admits with x in int8 on its int path
// or in float32: W1/2/4/8 codes in LSB-first int32 words, or non-packed int8
// / fp16 / bf16 weights (elements_per_sample 1); W_group_mode 0-4 with scalar
// or grouped zeros; channel_scale_mode 0-3. x in bf16 / fp16, and int8 x off
// the int path, take the float path of csrc/fused_float.cu.
//
// Arithmetic (pallas_gemm.py:145-212):
//   * int path (int8 x, W_group_mode 0 or a scalar-zero shift, codes that
//     fit int8): int8 x int8 -> int32 on the tensor cores (mma.sync s8),
//     exact;
//   * float32 x: the weight tile dequantized in float32 and CUDA-core FMAs
//     in float32 (TF32 would drift from the reference);
//   * the epilogue scales the accumulator in float32: csm 1 * s[n],
//     2 * sx[m], 3 * sx[m] * s[n].
//
// What bounds it: at the prefill shapes it serves (A8W8, M = 65..4095) the
// int8 weights are read once per row tile of 128 rows, so at M <= 128 the
// bound is the weight bytes over HBM bandwidth (M=128, 14336x4096 int8:
// about 63 MB / 3.35 TB/s = 18.8 us; 15 G int ops / 1,979 TOPS = 7.6 us).
// The int path (int_mma_kernel, below) is built for that bound: a ring of
// cp.async stages keeps each SM's next steps in flight while it multiplies,
// the N-major weights are turned K-major in registers for mma.sync, and a
// split K is reduced in the same launch.
#include <atomic>

#include "gl_common.cuh"

namespace {

constexpr int BK = 32, kThreads = 256;

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

// W_group_mode dequantization of one weight in float32 (pallas_gemm.py:159-185)
__device__ __forceinline__ float dequant(float c, int k, int n, const Params& p) {
    if (p.mode == 0) return c;
    float s = 0.f, z = 0.f;
    if (p.mode >= 2) s = gl::load_meta(p.scales, (size_t)(k / p.gs_s) * p.N + n, p.s_code);
    if ((p.mode == 1 || p.mode >= 3) && p.zero_scalar == nullptr)
        z = gl::load_meta(p.zeros, (size_t)(k / p.gs_z) * p.N + n, p.z_code);
    switch (p.mode) {
        case 1:
            if (p.zero_scalar != nullptr) z = (float)*p.zero_scalar;
            return __fsub_rn(c, z);
        case 2:
            return __fmul_rn(c, s);
        case 3:
            if (p.zero_scalar != nullptr) return __fmul_rn((float)((int)c - *p.zero_scalar), s);
            return __fmul_rn(__fsub_rn(c, z), s);
        default:
            return __fadd_rn(__fmul_rn(c, s), z);
    }
}

// The (BK, TN) weight tile at (k0, n0), dequantized: store(kk, nn, v) for
// every kk < BK, nn < TN. (Loading all of a thread's words first, then
// decoding them, measured slower on the H100 and made nvcc take a minute
// longer.)
template <int TN, typename Store>
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
            store(kb, nn, dequant(c, k0 + kb, n, p));
            continue;
        }
        const uint32_t word = static_cast<const uint32_t*>(p.W)[(size_t)((k0 + kb) / e) * p.N + n];
        const uint32_t mask = (1u << p.W_nbits) - 1u;
        for (int j = 0; j < e; ++j)
            store(kb + j, nn, dequant((float)((word >> (j * p.W_nbits)) & mask), k0 + kb + j, n, p));
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
        load_w_tile<FBN>(p, k0, n0, [&](int kk, int nn, float v) { Bs[kk][nn] = v; });
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

// ---------------------------------------------------------------------------
// Int path: int8 x (M, K) against int8 weights with int32 sums, exact. The
// weights come in one of five forms (WForm): non-packed int8, non-packed fp16
// / bf16 holding whole values, or W4 / W2 / W1 codes in LSB-first int32 words
// of (K / e, N); in W_group_mode 1 each weight is shifted by the scalar zero
// and wrapped to int8, as the plain version's cast does.
//
// One block owns a 128 x 128 output tile and walks its K range in steps of
// 128. Per step it needs the x tile (128 x 128 bytes) and the raw weight tile
// (the step's rows of W for its 128 columns). Both arrive through a ring of
// WForm::stages slots (5; 3 for the larger fp16 / bf16 raw tiles) in dynamic
// shared memory, filled by cp.async 16-byte copies
// (4-byte, or plain loads, when N leaves rows unaligned) whose src-size
// operand zero-fills rows past M, columns past N and k past the range. While
// step i is multiplied, step i + 1's weights are turned K-major and steps
// i + 2 .. i + stages - 1 are in flight.
//
// 8-bit tensor-core operands must be K-major for both A and B, and the
// weights are N-major. So each step's raw tile is turned K-major in
// registers: int8 rows by 4 x 4 byte transposes (__byte_perm), packed words
// by shifts, masks and __byte_perm (a W4 word gives 8 k of one n, W2 16, W1
// 32), the zero subtracted four bytes at a time (__vsub4). The result goes to
// a double-buffered operand tile Bt[n][k] whose 16-byte chunks are
// XOR-swizzled, so that both these stores and ldmatrix are free of bank
// conflicts; x is stored swizzled the same way straight from the copy. 8
// warps of 64 x 32 then run ldmatrix.x4 and mma.sync m16n8k32 s8.s8.s32,
// with the int32 sums in registers.
//
// The epilogue takes the sums straight from the accumulator registers (no
// staging tile): float, the csm scales, paired stores. Where the tiles alone
// leave SMs idle (int_plan in ops/fused.py)
// K is split over gridDim.z in the same launch: every split adds its int32
// sums into the tile's accumulator (red.global.add, exact in any order) and
// bumps the tile's arrival counter; the last to arrive reads the total,
// applies the epilogue and leaves accumulator and counter at 0.
namespace ip {

constexpr int BM = 128, BN = 128, BK = 128, kThreads = 256;
constexpr int kTileBytes = BM * BK;            // x tile and K-major weight tile, bytes

enum Form { kDense8 = 0, kDense16 = 1, kW4 = 2, kW2 = 3, kW1 = 4 };

// k per weight element (word), bytes per element, ring depth
template <int F> struct WForm;
template <> struct WForm<kDense8>  { static constexpr int e = 1,  eb = 1, stages = 5; };
template <> struct WForm<kDense16> { static constexpr int e = 1,  eb = 2, stages = 3; };
template <> struct WForm<kW4>      { static constexpr int e = 8,  eb = 4, stages = 5; };
template <> struct WForm<kW2>      { static constexpr int e = 16, eb = 4, stages = 5; };
template <> struct WForm<kW1>      { static constexpr int e = 32, eb = 4, stages = 5; };

// the raw weight tile of a step: rows and bytes; the block's shared memory
template <int F> struct Raw {
    static constexpr int rows = BK / WForm<F>::e, bytes = rows * BN * WForm<F>::eb;
    static constexpr int smem = WForm<F>::stages * (kTileBytes + bytes) + 2 * kTileBytes + 16;
};

using gl::cp_async16;
using gl::cp_async4;
using gl::cp_async_commit;
using gl::cp_async_wait;
using gl::ldsm_x4;
using gl::mma_s8;
using gl::smem_u32;
using gl::transpose4;
using gl::w_off;
using gl::x_off;

// one step's x tile and raw weight tile, rows k0 .. k0 + BK - 1 of the range
// ending at k_end, issued by thread t of nt; wvec: the weight copy size in
// bytes (16, 4, or 1 for plain loads and stores)
template <int F>
__device__ __forceinline__ void load_step(const Params& p, unsigned char* xs, unsigned char* raw,
                                          int m0, int n0, int k0, int k_end, int wvec, int t,
                                          int nt) {
    const int8_t* x = static_cast<const int8_t*>(p.x);
    for (int i = t; i < BM * (BK / 16); i += nt) {
        const int m = i >> 3, c = i & 7, k = k0 + c * 16;
        const bool ok = m0 + m < p.M && k < k_end;
        cp_async16(smem_u32(xs + x_off(m, c)), ok ? x + (size_t)(m0 + m) * p.K + k : p.x,
                   ok ? 16 : 0);
    }
    constexpr int e = WForm<F>::e, eb = WForm<F>::eb, rows = Raw<F>::rows, rb = BN * eb;
    const int rows_valid = min(rows, (k_end - k0) / e);
    const int cb_valid = (p.N - n0) * eb;                    // valid bytes of a row
    const size_t stride = (size_t)p.N * eb;
    const unsigned char* W = static_cast<const unsigned char*>(p.W) + (size_t)(k0 / e) * stride +
                             (size_t)n0 * eb;
    if (wvec == 16) {
        for (int i = t; i < rows * (rb / 16); i += nt) {
            const int r = i / (rb / 16), cb = (i % (rb / 16)) * 16;
            const bool ok = r < rows_valid && cb < cb_valid;
            cp_async16(smem_u32(raw + r * rb + cb), ok ? W + r * stride + cb : p.W, ok ? 16 : 0);
        }
    } else if (wvec == 4) {
        for (int i = t; i < rows * (rb / 4); i += nt) {
            const int r = i / (rb / 4), cb = (i % (rb / 4)) * 4;
            const bool ok = r < rows_valid && cb < cb_valid;
            cp_async4(smem_u32(raw + r * rb + cb), ok ? W + r * stride + cb : p.W, ok ? 4 : 0);
        }
    } else {
        for (int i = t; i < rows * rb; i += nt) {
            const int r = i / rb, cb = i % rb;
            raw[i] = (r < rows_valid && cb < cb_valid) ? W[r * stride + cb] : 0;
        }
    }
}

__device__ __forceinline__ void store_chunk(unsigned char* bt, int n, int c, uint4 v, unsigned zrep) {
    if (zrep)
        v = make_uint4(__vsub4(v.x, zrep), __vsub4(v.y, zrep), __vsub4(v.z, zrep), __vsub4(v.w, zrep));
    *reinterpret_cast<uint4*>(bt + w_off(n, c)) = v;
}

// the raw weight tile -> K-major int8 operand tile Bt[n][k]: the four
// 16-byte chunks of t, one of 256 parts
template <int F>
__device__ __forceinline__ void to_kmajor(const unsigned char* raw, unsigned char* bt, int zero,
                                          unsigned zrep, int w_code, int t) {
    if constexpr (F == kDense8 || F == kDense16) {
        // thread: columns n = 4q .. 4q + 3, k chunk c (rows 16c .. 16c + 15)
        const int q = t & 31, c = t >> 5;
        uint32_t o[4][4];                                    // [n][4 k]
        if constexpr (F == kDense8) {
#pragma unroll
            for (int g = 0; g < 4; ++g) {
                const unsigned char* row = raw + (16 * c + 4 * g) * BN + 4 * q;
                uint32_t tr[4];
                transpose4(*reinterpret_cast<const uint32_t*>(row),
                           *reinterpret_cast<const uint32_t*>(row + BN),
                           *reinterpret_cast<const uint32_t*>(row + 2 * BN),
                           *reinterpret_cast<const uint32_t*>(row + 3 * BN), tr);
#pragma unroll
                for (int j = 0; j < 4; ++j) o[j][g] = tr[j];
            }
        } else {                                             // whole-valued fp16 / bf16
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int g = 0; g < 4; ++g) o[j][g] = 0;
#pragma unroll
            for (int kk = 0; kk < 16; ++kk) {
                const unsigned char* row = raw + (16 * c + kk) * (2 * BN) + 8 * q;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const float v = gl::load_meta(row, j, w_code);
                    const unsigned b = (unsigned)((int)v - zero) & 0xffu;
                    o[j][kk >> 2] |= b << (8 * (kk & 3));
                }
            }
            zrep = 0;                                        // the zero is already applied
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
            store_chunk(bt, 4 * q + j, c, make_uint4(o[j][0], o[j][1], o[j][2], o[j][3]), zrep);
    } else {
        const uint32_t* w = reinterpret_cast<const uint32_t*>(raw);
        const int n = t & (BN - 1), h = t >> 7;
        if constexpr (F == kW4) {                            // 2 words (16 k) per chunk
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int c = h + 2 * i;
                uint32_t v[4];
#pragma unroll
                for (int s = 0; s < 2; ++s) {
                    const uint32_t word = w[(2 * c + s) * BN + n];
                    const uint32_t lo = word & 0x0f0f0f0fu, hi = (word >> 4) & 0x0f0f0f0fu;
                    v[2 * s] = __byte_perm(lo, hi, 0x5140);
                    v[2 * s + 1] = __byte_perm(lo, hi, 0x7362);
                }
                store_chunk(bt, n, c, make_uint4(v[0], v[1], v[2], v[3]), zrep);
            }
        } else if constexpr (F == kW2) {                     // 1 word (16 k) per chunk
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int c = h + 2 * i;
                const uint32_t word = w[c * BN + n];
                const uint32_t t0 = word & 0x03030303u, t1 = (word >> 2) & 0x03030303u;
                const uint32_t t2 = (word >> 4) & 0x03030303u, t3 = (word >> 6) & 0x03030303u;
                const uint32_t p01 = __byte_perm(t0, t1, 0x5140), p23 = __byte_perm(t2, t3, 0x5140);
                const uint32_t q01 = __byte_perm(t0, t1, 0x7362), q23 = __byte_perm(t2, t3, 0x7362);
                store_chunk(bt, n, c,
                            make_uint4(__byte_perm(p01, p23, 0x5410), __byte_perm(p01, p23, 0x7632),
                                       __byte_perm(q01, q23, 0x5410), __byte_perm(q01, q23, 0x7632)),
                            zrep);
            }
        } else {                                             // W1: 1 word (32 k) = 2 chunks
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const int r = h + 2 * i;
                const uint32_t word = w[r * BN + n];
                uint32_t v[8];
#pragma unroll
                for (int g = 0; g < 8; ++g)                  // 4 bits -> 4 bytes, no carries
                    v[g] = (((word >> (4 * g)) & 0xfu) * 0x00204081u) & 0x01010101u;
                store_chunk(bt, n, 2 * r, make_uint4(v[0], v[1], v[2], v[3]), zrep);
                store_chunk(bt, n, 2 * r + 1, make_uint4(v[4], v[5], v[6], v[7]), zrep);
            }
        }
    }
}

// one step: the warp's 64 x 32 sub-tile over BK = 4 x k32
__device__ __forceinline__ void mma_step(const unsigned char* xs, const unsigned char* bt,
                                         int (&acc)[4][4][4], int wm, int wn, int lane) {
    const unsigned xa = smem_u32(xs), ba = smem_u32(bt);
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
        uint32_t a[4][4], b[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int m = wm * 64 + i * 16 + (lane & 15);
            ldsm_x4(xa + x_off(m, 2 * kk + (lane >> 4)), a[i][0], a[i][1], a[i][2], a[i][3]);
        }
#pragma unroll
        for (int j2 = 0; j2 < 2; ++j2) {
            const int n = wn * 32 + j2 * 16 + (lane & 7) + ((lane >> 4) << 3);
            ldsm_x4(ba + w_off(n, 2 * kk + ((lane >> 3) & 1)), b[2 * j2][0], b[2 * j2][1],
                    b[2 * j2 + 1][0], b[2 * j2 + 1][1]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
    }
}

// out = csm(float(sum)) for one thread's 64 sums, in fragment order: sum
// (i * 4 + j) * 4 + r sits at row m0 + 16 i + 8 (r >> 1), column n0 + 8 j +
// (r & 1). A scale that the csm does not use is 1, and v * 1 is exact, so
// the products are those of gl::channel_scale. Two neighbouring outputs go
// out as one 4-byte store where they can. Not inlined: one copy serves every
// weight form, which keeps the build of this file short.
__device__ __noinline__ void epilogue(const Params p, const int* sum, int m0, int n0) {
    const bool by_row = p.csm == 2 || p.csm == 3, by_col = p.csm == 1 || p.csm == 3;
    const bool pairs = p.out_code != gl::kF32 && p.N % 2 == 0;
    float col_s[8];
    for (int c = 0; c < 8; ++c) {
        const int n = n0 + (c >> 1) * 8 + (c & 1);
        col_s[c] = by_col && n < p.N ? gl::load_meta(p.scales, n, p.s_code) : 1.f;
    }
    for (int i = 0; i < 4; ++i)
        for (int h = 0; h < 2; ++h) {
            const int m = m0 + i * 16 + h * 8;
            if (m >= p.M) continue;
            const float row_s = by_row ? p.sx[m] : 1.f;
            for (int j = 0; j < 4; ++j) {
                const int n = n0 + j * 8;
                const int* s = sum + (i * 4 + j) * 4 + 2 * h;
                const float v0 = __fmul_rn(__fmul_rn(__int2float_rn(s[0]), row_s), col_s[2 * j]);
                const float v1 = __fmul_rn(__fmul_rn(__int2float_rn(s[1]), row_s), col_s[2 * j + 1]);
                const size_t idx = (size_t)m * p.N + n;
                if (pairs && n < p.N) {                      // N even: n + 1 < N too
                    if (p.out_code == gl::kBF16)
                        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) + idx) =
                            __floats2bfloat162_rn(v0, v1);
                    else
                        *reinterpret_cast<__half2*>(static_cast<__half*>(p.out) + idx) =
                            __floats2half2_rn(v0, v1);
                } else {
                    if (n < p.N) gl::store_out(p.out, idx, v0, p.out_code);
                    if (n + 1 < p.N) gl::store_out(p.out, idx + 1, v1, p.out_code);
                }
            }
        }
}

// ws: per output tile, the 64 int32 sums of each thread, thread-minor, 0
// between calls; counters: one per output tile, 0 between calls
template <int F>
__global__ void __launch_bounds__(kThreads, 1)
int_mma_kernel(Params p, int k_per_split, int wvec, int* __restrict__ ws, int* __restrict__ counters) {
    constexpr int S = WForm<F>::stages, RB = Raw<F>::bytes;
    extern __shared__ __align__(128) unsigned char smem[];
    unsigned char* xs = smem;                                // [S][BM][BK], swizzled
    unsigned char* raw = xs + S * kTileBytes;                // [S][raw tile]
    unsigned char* bt = raw + S * RB;                        // [2][BN][BK], swizzled
    int* last_flag = reinterpret_cast<int*>(bt + 2 * kTileBytes);

    const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
    const int k_begin = blockIdx.z * k_per_split, k_end = min(p.K, k_begin + k_per_split);
    const int steps = (k_end - k_begin + BK - 1) / BK;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wm = warp >> 2, wn = warp & 3;
    const int zero = p.mode == 1 ? *p.zero_scalar : 0;
    const unsigned zrep = (unsigned)(zero & 0xff) * 0x01010101u;

    int acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
    for (int s = 0; s < S - 1; ++s) {
        if (s < steps)
            load_step<F>(p, xs + s * kTileBytes, raw + s * RB, m0, n0, k_begin + s * BK, k_end, wvec,
                         threadIdx.x, kThreads);
        cp_async_commit();
    }
    cp_async_wait<S - 2>();
    __syncthreads();
    to_kmajor<F>(raw, bt, zero, zrep, p.w_code, threadIdx.x);
    for (int i = 0; i < steps; ++i) {
        // step i + 1 has landed; every warp is done with step i - 1's slots
        cp_async_wait<S - 3>();
        __syncthreads();
        const int nxt = i + S - 1;
        if (nxt < steps)
            load_step<F>(p, xs + (nxt % S) * kTileBytes, raw + (nxt % S) * RB, m0, n0,
                         k_begin + nxt * BK, k_end, wvec, threadIdx.x, kThreads);
        cp_async_commit();
        if (i + 1 < steps)
            to_kmajor<F>(raw + ((i + 1) % S) * RB, bt + ((i + 1) & 1) * kTileBytes, zero, zrep,
                         p.w_code, threadIdx.x);
        mma_step(xs + (i % S) * kTileBytes, bt + (i & 1) * kTileBytes, acc, wm, wn, lane);
    }
    cp_async_wait<0>();

    if (gridDim.z > 1) {
        // every split adds its sums into the tile's int32 accumulator
        // (red.global.add); the last to arrive reads the total and leaves
        // the accumulator and the counter at 0 for the next call
        const int tile = blockIdx.y * gridDim.x + blockIdx.x;
        int* tacc = ws + (size_t)tile * 64 * kThreads + threadIdx.x;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int r = 0; r < 4; ++r)
                    atomicAdd(tacc + ((i * 4 + j) * 4 + r) * kThreads, acc[i][j][r]);
        __threadfence();
        __syncthreads();
        if (threadIdx.x == 0)
            *last_flag = atomicAdd(counters + tile, 1) == (int)gridDim.z - 1;
        __syncthreads();
        if (!*last_flag) return;
        __threadfence();
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    int* t = tacc + ((i * 4 + j) * 4 + r) * kThreads;
                    acc[i][j][r] = __ldcg(t);
                    __stcg(t, 0);
                }
        if (threadIdx.x == 0) counters[tile] = 0;
    }
    int sum[64];                                             // leaves the registers once
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) sum[(i * 4 + j) * 4 + r] = acc[i][j][r];
    epilogue(p, sum, m0 + wm * 64 + (lane >> 2), n0 + wn * 32 + (lane & 3) * 2);
}

template <int F>
cudaError_t launch(const Params& p, int splits, int k_per_split, int* ws, int* counters,
                   cudaStream_t stream) {
    constexpr int bytes = Raw<F>::smem;
    static std::atomic<unsigned> ready{0};                   // a bit per device: attribute set
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (!(ready.load() & (1u << dev))) {
        err = cudaFuncSetAttribute(int_mma_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   bytes);
        if (err != cudaSuccess) return err;
        ready.fetch_or(1u << dev);
    }
    const int row_bytes = p.N * WForm<F>::eb;
    const int wvec = row_bytes % 16 == 0 ? 16 : row_bytes % 4 == 0 ? 4 : 1;
    const dim3 grid((p.M + BM - 1) / BM, (p.N + BN - 1) / BN, splits);
    int_mma_kernel<F><<<grid, kThreads, bytes, stream>>>(p, k_per_split, wvec, ws, counters);
    return cudaGetLastError();
}

}  // namespace ip

}  // namespace

// Launch on `stream`. x_code / w_code / s_code / z_code / out_code are DType
// values; int_path selects the int8 tensor-core path (int8 x, W_group_mode 0
// or 1 with a scalar zero, non-packed weights or W1/2/4 codes); otherwise x
// must be float32 (the other float inputs take gl_fused_float). On the int
// path K is cut into `splits` ranges of `k_per_split` (one range of K, or
// ranges of a multiple of 128 of which none is empty), all in one launch; with
// splits > 1 it needs `ws`, (the output tiles) x 128 x 128 int32, and
// `counters`, one int32 per output tile, all 0 (the kernel leaves them 0).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int gl_fused_gemm(const void* x, const void* W, const void* scales, const void* zeros,
                             const void* zero_scalar, const void* sx, void* out, void* ws,
                             void* counters, int M, int N, int K, int x_code, int int_path,
                             int W_nbits, int elems, int w_code, int mode, int csm, int gs_s,
                             int gs_z, int s_code, int z_code, int out_code, int splits,
                             int k_per_split, void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if (K % BK || BK % elems || M < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    Params p{x, W, scales, zeros, static_cast<const int*>(zero_scalar),
             static_cast<const float*>(sx), out, M, N, K, W_nbits, elems, w_code, mode, csm,
             gs_s, gs_z, s_code, z_code, out_code};
    if (int_path) {
        const bool split_ok = splits == 1 ? k_per_split >= K
                                          : (splits > 1 && k_per_split % ip::BK == 0 &&
                                             (long long)(splits - 1) * k_per_split < K &&
                                             (long long)splits * k_per_split >= K &&
                                             ws != nullptr && counters != nullptr);
        if (x_code != gl::kI8 || mode > 1 || (mode == 1 && zero_scalar == nullptr) || !split_ok)
            return static_cast<int>(cudaErrorInvalidValue);
        int* w = static_cast<int*>(ws);
        int* c = static_cast<int*>(counters);
        cudaError_t err = cudaErrorInvalidValue;
        if (elems == 1 && w_code == gl::kI8)
            err = ip::launch<ip::kDense8>(p, splits, k_per_split, w, c, stream);
        else if (elems == 1 && (w_code == gl::kF16 || w_code == gl::kBF16))
            err = ip::launch<ip::kDense16>(p, splits, k_per_split, w, c, stream);
        else if (W_nbits == 4 && elems == 8)
            err = ip::launch<ip::kW4>(p, splits, k_per_split, w, c, stream);
        else if (W_nbits == 2 && elems == 16)
            err = ip::launch<ip::kW2>(p, splits, k_per_split, w, c, stream);
        else if (W_nbits == 1 && elems == 32)
            err = ip::launch<ip::kW1>(p, splits, k_per_split, w, c, stream);
        return static_cast<int>(err);
    }
    if (x_code == gl::kF32) {
        const dim3 grid((N + FBN - 1) / FBN, (M + FBM - 1) / FBM);
        fused_gemm_f32_kernel<<<grid, kThreads, 0, stream>>>(p);
        return static_cast<int>(cudaGetLastError());
    }
    return static_cast<int>(cudaErrorInvalidValue);
}
