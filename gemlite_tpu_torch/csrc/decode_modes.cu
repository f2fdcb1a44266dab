// SPDX-License-Identifier: Apache-2.0
// W1/W2/W4 decode for M <= 64 in W_group_mode 1, 2 or 3: out (M, N) bf16 =
// csm(x (M, K) . dequant(W_q)), x bf16 or per-token e4m3 codes, float32 sums
// on the bf16 tensor cores, one launch a call. The plain version is
// ops/reference.forward_f32_epilogue.
//
// Two entries share one kernel:
//   gl_decode_modes          one layer with bf16 group scales (or none), grouped
//                            bf16 or scalar int32 zeros (or none) and csm 0-3:
//                            replaces gemlite_tpu/ops/pallas_decode.py:
//                            pallas_decode_matmul on the A8Wn, channel-wise
//                            A16Wn and BitNet layers;
//   gl_decode_modes_stacked  layer l of an L-layer stack with csm 0 or 1
//                            (channel-wise A16Wn), l read on the device:
//                            replaces gemlite_tpu/ops/pallas_scan.py:
//                            pallas_decode_matmul_stacked on those layers, on
//                            the same kernel and plan, so the two agree bit
//                            for bit.
// Layers whose operands TMA cannot read (N off a multiple of 8, or of 32 for
// W1, a base off 16 bytes) keep the mode 1-3 instances of decode_gemv.cu
// (ops/decode.decode_modes_ragged); e4m3 x with K off 16 comes in as bf16.
//
// What bounds it: the packed weights and their metadata (K N bits / 8 + 2 K /
// gs N bytes a row of scales or zeros) dwarf x and the output at M <= 64, so
// the bound is bytes over HBM bandwidth (A8W4 gs 64, 14336 x 4096: 33 MB,
// 9.9 us at 3.35 TB/s). The kernel streams each weight byte once by TMA:
//   * one producer warp, whose first lane keeps a ring of 128-deep stages in
//     flight, each on its "full" mbarrier with the stage's bytes, and reuses
//     a stage once its "empty" mbarrier has one arrival from each consumer
//     warp. A stage holds the word box (W4 16, W2 8, W1 4 word rows by 128
//     columns, one 3-d box of four 32-column groups in the 128-byte swizzle;
//     four 2-d boxes, each 1024-byte aligned, where N is not a multiple of
//     32: W2 / W4 only), the stage's group rows of bf16 scales and zeros
//     where the layer has them (a channel-wise layer, gs = K, loads its one
//     row once a block), and x, the rows of M rounded up to 8 in 128-byte
//     swizzled boxes (two for bf16, one for e4m3); what lies past M, N or K
//     reads as zeros;
//   * four consumer warps of 32 columns, which issue no copy and meet no
//     __syncthreads in the main loop: each waits for a stage, takes its
//     products and releases it. The arithmetic is the cp.async kernel's
//     (decode_gemv.cu): out^T = W^T . x^T on mma.sync m16n8k16 bf16 with
//     float32 sums, A a 16-column x 16-k tile of W dequantized in registers;
//     lane (g, t) takes codes 8t .. 8t + 7 of each 32-deep block and pairs
//     code e with code e + 4; w = (q - z) s as three bf16x2 fmas a pair
//     (dequant_pair_shift), each weight rounded as the plain version rounds
//     it. A warp's A rows are the columns m_col gives, so that its word reads
//     hit distinct banks in the swizzle; e4m3 x converts exactly to bf16 as it
//     is read, so the e4m3 form equals the form fed its bf16 image bit for bit;
//   * the grid (ops/decode.modes_plan) fills whole waves of three blocks an SM
//     (the launch bounds'), K split over gridDim.y in whole stages, at least
//     two a split and a whole number of groups, by N, K and gs only: a row's
//     sum runs in one order at any batch and for either form of x, and the
//     stacked entry, whose maps span the whole (L, K / epw, N) and (L, K / gs,
//     N) stacks and whose producer reads the layer on the device as a row
//     offset, equals the per-layer entry. The last block of a column tile adds
//     the float32 partials in split order, then the per-token and channel
//     scales in float32 (gl::channel_scale), and leaves its counter at 0.
#include <cuda_fp8.h>

#include <atomic>

#include "gl_common.cuh"
#include "sm90_common.cuh"
#include "w4_common.cuh"

// One call's arguments as an entry checked them: what the parts of the build
// (GL_DM_BITS below) pass one another.
struct DMCall {
    const void *x, *wq, *scales, *zeros, *zscalar, *sx, *cs, *layer_idx;
    void *part, *counters, *out;
    int L, M, N, K, gs, x_code, splits, k_per_split, stages, mrows, csm, cs_code;
    cudaStream_t stream;
};

namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int BK = 128;                  // K per ring stage
constexpr int BN = 128;                  // output columns per block: 4 consumer warps of 32
constexpr int kBlocks = 3;               // blocks an SM (ops/decode.MODES_BLOCKS)
constexpr int kThreads = BN + 32;        // and one producer warp
constexpr int kMaxStages = 8;
constexpr int kMaxMetaRows = 32;
constexpr int kSmemMax = 112 * 1024;

enum XKind { kXbf16 = 0, kXe4m3 = 1 };   // the activations

// Timing variants (scripts and chip_smoke.py build them with -DGL_DM_VARIANT):
// 1 the copies alone (no products), 2 the consumers alone (no copies: the
// producer arrives on each stage's barrier), 3 no stage (launch, barriers and
// epilogue). Their outputs are meaningless.
#ifndef GL_DM_VARIANT
#define GL_DM_VARIANT 0
#endif
constexpr int kVariant = GL_DM_VARIANT;

struct Params {
    const void* x;                       // (M, K) bf16 / e4m3
    const int* layer_idx;                // stacked entry: the layer, on the device
    bf16* out;                           // (M, N)
    float* part;                         // (splits, M, N) float32 partials
    int* counters;                       // one per column tile, 0 between calls
    int L, M, N, K, gs, k_per_split, stages;
    int mrows;                           // group rows a stage holds
    int gshift;                          // log2(gs) for a power of two, else -1
    int once;                            // gs = K: one metadata row a block, loaded once
    int w3d;                             // N % 32 == 0: the word box is one 3-d copy
    Modes md;
};

struct Maps {
    CUtensorMap x, w, s, z;
};

// The shared memory from a 1024-byte aligned base: the x ring (a stage: the
// rows of x, M rounded up to 8, in boxes of 128-byte rows in the 128-byte
// swizzle, two boxes of 64 k for bf16), the word ring (a stage: four groups of
// 32 columns, WR rows of 128 bytes each, in the same swizzle), the metadata
// slots (mrows rows of 128 bf16 scales, then mrows of zeros; one slot a stage,
// or one slot for a layer that loads its row once); the float32 epilogue tile
// over them once they are free. The mbarriers are static. ops/decode.modes_smem
// mirrors `bytes`.
struct Layout {
    int xb, wb, mb, w, m, bytes;
    __host__ __device__ Layout(int bits, int xbytes, int rows, int stages, int mrows, int once) {
        xb = rows * BK * xbytes;
        wb = BK * bits / 32 * BN * 4;
        mb = 2 * mrows * BN * 2;
        w = stages * xb;
        m = w + stages * wb;
        const int ring = m + (once ? 1 : stages) * mb, tile = rows * BN * 4;
        bytes = (ring > tile ? ring : tile) + 1024;
    }
};

// Column c (0 .. 127) of the block for A row g + 8 h of m16 tile i of warp w:
// the warp's group of 32 columns, in it 16-byte piece 4 (g / 4) + 2 i + h and
// word g % 4 of the piece (mx_gemm.cu's d_col).
__host__ __device__ __forceinline__ int m_col(int w, int g, int i, int h) {
    return 32 * w + 16 * (g >> 2) + 8 * i + 4 * h + (g & 3);
}

// word (r, c) of a stage's word box as TMA lands it: group c / 32 of WR rows
// of 128 bytes, box row R = (c / 32) WR + r, its 16-byte pieces XORed with R % 8
__host__ __device__ __forceinline__ int m_word(int wr, int r, int c) {
    const int R = (c >> 5) * wr + r;
    return R * 32 + ((((c >> 2) & 7) ^ (R & 7)) << 2) + (c & 3);
}

// byte offset of x (m, k) (k < BK) in a stage of `rows` rows: boxes of 64
// (bf16) or 128 (e4m3) k, 128-byte rows, 16-byte piece p of row m at p ^ (m % 8)
template <int XB>
__device__ __forceinline__ int m_x(int rows, int m, int k) {
    constexpr int per = 128 / XB;        // k a box row
    const int kb = k % per * XB;
    return k / per * rows * 128 + m * 128 + (((kb >> 4) ^ (m & 7)) << 4) + (kb & 15);
}

// bytes 0 and 1 of `two` (e4m3 codes) -> bf16x2 (byte 0 low), exact
__device__ __forceinline__ uint32_t e4m3x2_bf16x2(uint32_t two) {
    const __half2_raw h =
        __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(two & 0xFFFFu), __NV_E4M3);
    const float2 f = __half22float2(__half2(h));
    const __nv_bfloat162 b = __floats2bfloat162_rn(f.x, f.y);
    return *reinterpret_cast<const uint32_t*>(&b);
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A consumer lane's fixed offsets, so that the main loop adds constants: the
// word of A row (i, h) in 32-deep block 0 (block kb is (w ^ X(kb)) + 32 RS kb,
// RS = 32 / epw word rows a block, X(kb) = (RS kb % 8) << 2: the rows of a
// block keep the pieces' swizzle up to that XOR), the bit shift of its 8 codes
// in the word, its column's first metadata column, and its x piece of each k
// block (row g; row 8 jj + g lies 1024 jj bytes on).
template <int BITS, int X>
struct Lane {
    int w[2][2];
    int c, shift, t;
    int x[4];
    __device__ __forceinline__ Lane(int warp, int lane, int rows) {
        constexpr int EPW = 32 / BITS, WR = BK / EPW, XB = X == kXbf16 ? 2 : 1;
        const int g = lane >> 2;
        t = lane & 3;
        c = m_col(warp, g, 0, 0);
        shift = BITS * ((8 * t) % EPW);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) w[i][h] = m_word(WR, 8 * t / EPW, m_col(warp, g, i, h));
#pragma unroll
        for (int kb = 0; kb < 4; ++kb) x[kb] = m_x<XB>(rows, g, 32 * kb + 8 * t);
    }
};

// One stage's products for one consumer warp: acc[i][jj][r] is column m_col(w,
// g, i, r / 2), token 8 jj + 2t + r % 2. Lane (g, t) takes codes 0..7 of k0 +
// 8t .. k0 + 8t + 7 of its columns and pairs code e with code e + 4 (one shift
// and one mask put both beside 0x4300): pair e feeds mma e / 2, its low-k
// registers for even e, its high-k ones for odd e; x is paired to match by
// byte permutes. s2 holds the scale (1 without a scale row), z2 -z (the
// scalar's -z without a zero row).
template <int NT, int BITS, int X>
__device__ __forceinline__ void compute_stage(const Params& p, const uint8_t* wst,
                                              const uint16_t* ss, const uint8_t* xst,
                                              const Lane<BITS, X>& o, int k0, int k_end, int nt,
                                              uint32_t nz2, float (&acc)[2][NT][4]) {
    constexpr int EPW = 32 / BITS, RS = 32 / EPW;
    constexpr uint32_t MASK2 = ((1u << BITS) - 1u) * 0x00010001u;
    const uint16_t* zs = ss + p.mrows * BN;
    uint32_t s2[2][2], z2[2][2];
#pragma unroll
    for (int kb = 0; kb < BK / 32; ++kb) {
        if (k0 + 32 * kb >= k_end) break;
        if (kb == 0 || p.mrows > 1) {                    // one group row a stage: read it once
            const int k = k0 + 32 * kb + 8 * o.t;
            const int gr = p.mrows == 1 ? 0
                           : p.gshift >= 0 ? (k >> p.gshift) - (k0 >> p.gshift)
                                           : k / p.gs - k0 / p.gs;
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int c = gr * BN + o.c + 8 * i + 4 * h;
                    s2[i][h] = p.md.has_s ? ss[c] * 0x00010001u : 0x3F803F80u;
                    z2[i][h] = p.md.has_z ? (zs[c] ^ 0x8000u) * 0x00010001u : nz2;
                }
        }
        uint32_t a[2][2][4];                             // [mma j][m16 tile i][register]
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int wi = (o.w[i][h] ^ (((RS * kb) & 7) << 2)) + 32 * RS * kb;
                uint32_t u = *reinterpret_cast<const uint32_t*>(wst + 4 * wi) >> o.shift;
                // code e at bit BITS e and code e + 4 at bit BITS e + 16
                if constexpr (BITS == 2) u = (u & 0xFFu) | ((u & 0xFF00u) << 8);
                if constexpr (BITS == 1) u = (u & 0xFu) | ((u & 0xF0u) << 12);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const uint32_t v = ((u >> (BITS * e)) & MASK2) | 0x43004300u;   // 128 + q
                    a[e >> 1][i][2 * (e & 1) + h] = dequant_pair_shift(v, s2[i][h], z2[i][h]);
                }
            }
#pragma unroll
        for (int jj = 0; jj < NT; ++jj) {
            if (jj >= nt) break;
            const uint8_t* xr = xst + 1024 * jj + o.x[kb];
            uint32_t b00, b01, b10, b11;
            if constexpr (X == kXbf16) {
                // (x[8t + 2j], x[8t + 2j + 4]) and (x[8t + 2j + 1], x[8t + 2j + 5])
                const uint4 xv = *reinterpret_cast<const uint4*>(xr);
                b00 = __byte_perm(xv.x, xv.z, 0x5410), b01 = __byte_perm(xv.x, xv.z, 0x7632);
                b10 = __byte_perm(xv.y, xv.w, 0x5410), b11 = __byte_perm(xv.y, xv.w, 0x7632);
            } else {                                     // e4m3 codes 8t .. 8t + 7, byte e with e + 4
                const uint2 xv = *reinterpret_cast<const uint2*>(xr);
                b00 = e4m3x2_bf16x2(__byte_perm(xv.x, xv.y, 0x40));
                b01 = e4m3x2_bf16x2(__byte_perm(xv.x, xv.y, 0x51));
                b10 = e4m3x2_bf16x2(__byte_perm(xv.x, xv.y, 0x62));
                b11 = e4m3x2_bf16x2(__byte_perm(xv.x, xv.y, 0x73));
            }
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                mma_bf16(acc[i][jj], a[0][i], b00, b01);
                mma_bf16(acc[i][jj], a[1][i], b10, b11);
            }
        }
    }
}

// The producer lane: for layer *layer_idx of a stack (row offsets into the
// maps, which span all L layers), per stage, once the consumers have released
// it, the stage's words, metadata rows and x by TMA on its full mbarrier. A
// second bf16 x box wholly past K is not issued (the consumers stop before it).
template <int BITS, int X>
__device__ __forceinline__ void produce(const Maps& maps, const Params& p, uint32_t base,
                                        const Layout& Ly, uint32_t bars, int rows, int n0,
                                        int k_begin, int steps) {
    constexpr int EPW = 32 / BITS, WR = BK / EPW;
    int wrow = 0, grow = 0;
    if (p.layer_idx != nullptr) {
        const int l = __ldg(p.layer_idx);
        if (l < 0 || l >= p.L) __trap();             // the caller's index is out of the stack
        wrow = l * (p.K / EPW);
        grow = l * (p.K / p.gs);
    }
    const int S = p.stages;
    const uint32_t meta = (p.md.has_s + p.md.has_z) * p.mrows * BN * 2;
    // four 2-d word boxes: those wholly past N are not issued (their columns
    // are never written; their scales and zeros read as zeros)
    const int groups = p.w3d ? BN / 32 : min(BN / 32, (p.N - n0 + 31) / 32);
    for (int it = 0; it < steps; ++it) {
        const int st = it % S, k0 = k_begin + it * BK;
        const uint32_t full = bar_addr(bars, st);
        if (it >= S) mbar_wait(bar_addr(bars, S + st), ((it / S) & 1) ^ 1);
        if constexpr (kVariant == 2) {
            mbar_arrive(full);
            continue;
        }
        const bool with_meta = !p.once || it == 0;
        const bool x_hi = X == kXbf16 && k0 + 64 < p.K;
        mbar_expect_tx(full, groups * WR * 128 +
                                 (x_hi ? Ly.xb : (X == kXbf16 ? Ly.xb / 2 : Ly.xb)) +
                                 (with_meta ? meta : 0));
        const uint32_t ws = base + Ly.w + st * Ly.wb;
        if (p.w3d) {
            tma_load_3d(ws, &maps.w, full, 0, wrow + k0 / EPW, n0 / 32);
        } else {
            for (int grp = 0; grp < groups; ++grp)
                tma_load_2d(ws + grp * WR * 128, &maps.w, full, n0 + 32 * grp, wrow + k0 / EPW);
        }
        if (with_meta) {
            const uint32_t ms = base + Ly.m + (p.once ? 0 : st) * Ly.mb;
            const int g0 = grow + k0 / p.gs;
            if (p.md.has_s) tma_load_2d(ms, &maps.s, full, n0, g0);
            if (p.md.has_z) tma_load_2d(ms + p.mrows * BN * 2, &maps.z, full, n0, g0);
        }
        const uint32_t xs = base + st * Ly.xb;
        tma_load_2d(xs, &maps.x, full, k0, 0);
        if (x_hi) tma_load_2d(xs + rows * 128, &maps.x, full, k0 + 64, 0);
    }
}

// The block's sums, staged as tile[m][BN]: into the output, or with K split
// the block's partial, and the last block of the column tile adds the
// partials in split order, applies the mode 1-3 form's per-token and channel
// scales in float32 (decode_gemv.cu's finish_body order) and leaves its
// counter at 0. The consumer warps only. Not inlined: one copy serves every
// instance.
__device__ __noinline__ void finish(const Params& p, const float* tile, int* flag, int layer) {
    const int n0 = blockIdx.x * BN, split = blockIdx.y, nsplit = gridDim.y;
    const size_t MN = (size_t)p.M * p.N;
    const int total = p.M * BN;
    if (nsplit > 1) {
        for (int e = threadIdx.x * 4; e < total; e += BN * 4) {
            const int m = e / BN, n = n0 + e % BN;
            if (n >= p.N) continue;
            *reinterpret_cast<float4*>(p.part + split * MN + (size_t)m * p.N + n) =
                *reinterpret_cast<const float4*>(tile + e);
        }
        __threadfence();
        named_sync<1, BN>();
        if (threadIdx.x == 0) *flag = atomicAdd(p.counters + blockIdx.x, 1) == nsplit - 1;
        named_sync<1, BN>();
        if (!*flag) return;
        __threadfence();
    }
    // the stacked entry's layer of the (L, N) channel scales
    const void* cs = p.md.cs == nullptr ? nullptr
                                        : static_cast<const char*>(p.md.cs) +
                                              (size_t)layer * p.N * (p.md.cs_code == gl::kF32 ? 4 : 2);
    for (int e = threadIdx.x * 4; e < total; e += BN * 4) {
        const int m = e / BN, n = n0 + e % BN;
        if (n >= p.N) continue;
        const size_t idx = (size_t)m * p.N + n;
        const float4 tv = *reinterpret_cast<const float4*>(tile + e);
        float v[4] = {tv.x, tv.y, tv.z, tv.w};
        if (nsplit > 1) {
            v[0] = v[1] = v[2] = v[3] = 0.f;
            for (int s0 = 0; s0 < nsplit; s0 += 8) {
                float4 r[8];
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    r[j] = s0 + j < nsplit
                               ? __ldcg(reinterpret_cast<const float4*>(p.part + (s0 + j) * MN + idx))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    if (s0 + j >= nsplit) break;
                    v[0] = __fadd_rn(v[0], r[j].x);
                    v[1] = __fadd_rn(v[1], r[j].y);
                    v[2] = __fadd_rn(v[2], r[j].z);
                    v[3] = __fadd_rn(v[3], r[j].w);
                }
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
            v[i] = gl::channel_scale(v[i], p.md.csm, cs, p.md.cs_code, p.md.sx, m, n + i);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
        uint2 pk;
        pk.x = *reinterpret_cast<const uint32_t*>(&lo);
        pk.y = *reinterpret_cast<const uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(p.out + idx) = pk;
    }
    if (nsplit > 1 && threadIdx.x == 0) p.counters[blockIdx.x] = 0;
}

// Per-layer and stacked alike: four consumer warps of 32 columns and one
// producer warp whose first lane keeps the ring of `stages` stages in flight
// by TMA. The consumers wait on a stage's full mbarrier, take its products,
// and release it on its empty mbarrier, one arrival a warp; nothing else
// synchronizes the main loop.
template <int NT, int BITS, int X>
__global__ void __launch_bounds__(kThreads, kBlocks)
decode_modes_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Params p) {
    constexpr int XB = X == kXbf16 ? 2 : 1;
    extern __shared__ uint8_t smem_raw[];
    __shared__ __align__(8) uint64_t bar_mem[2 * kMaxStages];
    __shared__ int last_flag;
    const int rows = (p.M + 7) / 8 * 8, S = p.stages;
    const Layout Ly(BITS, XB, rows, S, p.mrows, p.once);
    const uint32_t base = smem_base(smem_raw), bars = smem_addr(bar_mem);
    uint8_t* g = smem_raw + (base - smem_addr(smem_raw));
    const int n0 = blockIdx.x * BN, k_begin = blockIdx.y * p.k_per_split;
    const int k_end = min(p.K, k_begin + p.k_per_split);
    const int steps = kVariant == 3 ? 0 : (k_end - k_begin + BK - 1) / BK;
    if (threadIdx.x == 0) {
        for (int s = 0; s < S; ++s) {
            mbar_init(bar_addr(bars, s), 1);              // the producer lane
            mbar_init(bar_addr(bars, S + s), BN / 32);    // one arrival a consumer warp
        }
        mbar_init_fence();
    }
    __syncthreads();
    if (threadIdx.x >= BN) {                              // the producer warp
        if (threadIdx.x == BN) produce<BITS, X>(maps, p, base, Ly, bars, rows, n0, k_begin, steps);
        return;
    }
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
    const int nt = NT == 1 ? 1 : rows / 8;
    const Lane<BITS, X> o(w, lane, rows);
    const uint32_t nz2 = neg_zero2(p.md.zscalar);
    float acc[2][NT][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
    for (int it = 0, st = 0, phase = 0; it < steps; ++it) {
        mbar_wait(bar_addr(bars, st), phase);
        if constexpr (kVariant != 1)
            compute_stage<NT, BITS, X>(
                p, g + Ly.w + st * Ly.wb,
                reinterpret_cast<const uint16_t*>(g + Ly.m + (p.once ? 0 : st) * Ly.mb),
                g + st * Ly.xb, o, k_begin + it * BK, k_end, nt, nz2, acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_addr(bars, S + st));
        if (++st == S) st = 0, phase ^= 1;
    }
    named_sync<1, BN>();                                  // every consumer is done with the ring
    float* tile = reinterpret_cast<float*>(g);            // [M][BN]
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jj = 0; jj < NT; ++jj) {
            if (jj >= nt) break;
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int m = 8 * jj + 2 * t + (r & 1);
                if (m < p.M) tile[m * BN + m_col(w, lane >> 2, i, r >> 1)] = acc[i][jj][r];
            }
        }
    named_sync<1, BN>();
    finish(p, tile, &last_flag, p.layer_idx != nullptr ? __ldg(p.layer_idx) : 0);
}

// 2-d map over a contiguous (rows, cols) array, dims innermost first; a box
// is box_cols x box_rows; what lies past the array reads as zeros
bool make_map(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* ptr, int rows,
              int cols, int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return false;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
    const cuuint32_t unit[2] = {1, 1};
    return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The (rows, cols) int32 words as TMA reads a stage's word box: with cols a
// multiple of 32, a 3-d map (32 columns, rows, cols / 32 groups) whose box
// (32, box_rows, 4) lands a block's 128 columns as four groups one after
// another in one copy; else a 2-d map whose box of 32 columns the producer
// issues four times. Either way box_rows rows of 128 bytes a group in the
// 128-byte swizzle (m_word), what lies past the array zeros.
bool make_word_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
    if (cols % 32)
        return make_map(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, ptr, rows, cols, box_rows, 32,
                        CU_TENSOR_MAP_SWIZZLE_128B);
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return false;
    const cuuint64_t dims[3] = {32, static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(cols / 32)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 4, 128};
    const cuuint32_t box[3] = {32, static_cast<cuuint32_t>(box_rows), BN / 32};
    const cuuint32_t unit[3] = {1, 1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 3, const_cast<void*>(ptr), dims, strides, box,
                  unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NT, int BITS, int X>
cudaError_t launch(const DMCall& c, const Params& p) {
    static std::atomic<unsigned> ready{0};
    constexpr int XB = X == kXbf16 ? 2 : 1, EPW = 32 / BITS;
    const int rows = (p.M + 7) / 8 * 8;
    const Layout Ly(BITS, XB, rows, p.stages, p.mrows, p.once);
    if (Ly.bytes > kSmemMax) return cudaErrorInvalidValue;
    const cudaError_t err = allow_smem(decode_modes_kernel<NT, BITS, X>, kSmemMax, ready);
    if (err != cudaSuccess) return err;
    // the maps span the whole stack (L layers of rows); x's rows past M read as zeros
    Maps maps{};
    const int G = p.L * (p.K / p.gs);
    const bool ok =
        make_map(&maps.x, X == kXbf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                 XB, p.x, p.M, p.K, rows, 128 / XB, CU_TENSOR_MAP_SWIZZLE_128B) &&
        make_word_map(&maps.w, c.wq, p.L * (p.K / EPW), p.N, BK / EPW) &&
        (!p.md.has_s || make_map(&maps.s, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, c.scales, G, p.N,
                                 p.mrows, BN, CU_TENSOR_MAP_SWIZZLE_NONE)) &&
        (!p.md.has_z || make_map(&maps.z, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, c.zeros, G, p.N,
                                 p.mrows, BN, CU_TENSOR_MAP_SWIZZLE_NONE));
    if (!ok) return cudaErrorInvalidValue;
    const dim3 grid((p.N + BN - 1) / BN, c.splits);
    decode_modes_kernel<NT, BITS, X><<<grid, kThreads, Ly.bytes, c.stream>>>(maps, p);
    return cudaGetLastError();
}

template <int BITS, int X>
cudaError_t launch_rows(const DMCall& c, const Params& p) {
    if (p.M <= 8) return launch<1, BITS, X>(c, p);
    if (p.M <= 16) return launch<2, BITS, X>(c, p);
    if (p.M <= 32) return launch<4, BITS, X>(c, p);
    return launch<8, BITS, X>(c, p);
}

template <int BITS>
int run(const DMCall& c) {
    int gshift = -1;
    for (int s = 0; s < 31; ++s)
        if ((1 << s) == c.gs) gshift = s;
    const Params p{c.x, static_cast<const int*>(c.layer_idx), static_cast<bf16*>(c.out),
                   static_cast<float*>(c.part), static_cast<int*>(c.counters), c.L, c.M, c.N, c.K,
                   c.gs, c.k_per_split, c.stages, c.mrows, gshift, c.gs == c.K, c.N % 32 == 0,
                   Modes{c.scales != nullptr, c.zeros != nullptr, static_cast<const int*>(c.zscalar),
                         static_cast<const float*>(c.sx), c.cs, c.csm, c.cs_code}};
    const cudaError_t err = c.x_code == gl::kBF16 ? launch_rows<BITS, kXbf16>(c, p)
                                                  : launch_rows<BITS, kXe4m3>(c, p);
    return static_cast<int>(err);
}

}  // namespace

// The instances build in parts, one nvcc each, into one library
// (ops/build.KERNEL_PARTS): a part compiled with GL_DM_BITS, a mask of code
// widths (1, 2, 4), instantiates them behind gl_dm_bits<BITS>; the part
// compiled with GL_DM_ENTRY also holds the entries. Compiled alone, with
// neither, the source builds every width and the entries.
#ifndef GL_DM_BITS
#define GL_DM_BITS 0x7
#define GL_DM_ENTRY 1
#endif

template <int BITS>
int gl_dm_bits(const DMCall& c);

#define GL_DM_INSTANCE(BITS) \
    template <>              \
    int gl_dm_bits<BITS>(const DMCall& c) { return run<BITS>(c); }
#if GL_DM_BITS & 0x1
GL_DM_INSTANCE(1)
#endif
#if GL_DM_BITS & 0x2
GL_DM_INSTANCE(2)
#endif
#if GL_DM_BITS & 0x4
GL_DM_INSTANCE(4)
#endif
#undef GL_DM_INSTANCE

#ifdef GL_DM_ENTRY
namespace {

// group rows that one 128-deep stage can touch: the least mrows the ring may
// hold (ops/decode.modes_plan chooses it; this only checks it)
int groups_per_stage(int gs) {
    if (gs % BK == 0) return 1;
    return BK % gs == 0 ? BK / gs : BK / gs + 2;
}

int check_and_run(const DMCall& c, int bits) {
    const int epw = bits > 0 ? 32 / bits : 0;
    const bool once = c.gs == c.K;
    const uintptr_t bases = reinterpret_cast<uintptr_t>(c.x) | reinterpret_cast<uintptr_t>(c.wq) |
                            reinterpret_cast<uintptr_t>(c.scales) |
                            reinterpret_cast<uintptr_t>(c.zeros);
    const bool shape_ok = c.M >= 1 && c.M <= 64 && c.N >= 8 && c.N % (bits == 1 ? 32 : 8) == 0 &&
                          c.K > 0 &&
                          (bits == 1 || bits == 2 || bits == 4) && c.gs > 0 &&
                          c.gs % (epw > 8 ? epw : 8) == 0 && c.K % c.gs == 0 && c.L >= 1 &&
                          (c.x_code == gl::kBF16 || (c.x_code == 3 && c.K % 16 == 0)) &&
                          bases % 16 == 0;
    const bool split_ok = c.splits >= 1 && c.k_per_split > 0 && c.k_per_split % BK == 0 &&
                          (once || c.k_per_split % c.gs == 0) &&
                          (long long)(c.splits - 1) * c.k_per_split < c.K &&
                          (long long)c.splits * c.k_per_split >= c.K &&
                          (c.splits == 1 || (c.part != nullptr && c.counters != nullptr));
    const bool codes_ok = c.cs_code == gl::kF32 || c.cs_code == gl::kBF16;
    if (!shape_ok || !split_ok || !codes_ok || c.stages < 2 || c.stages > kMaxStages ||
        c.mrows < (once ? 1 : groups_per_stage(c.gs)) || c.mrows > kMaxMetaRows || c.csm < 0 ||
        c.csm > 3 || ((c.csm & 2) && c.sx == nullptr) || ((c.csm & 1) && c.cs == nullptr) ||
        (c.zeros != nullptr && c.zscalar != nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    if (bits == 4) return gl_dm_bits<4>(c);
    if (bits == 2) return gl_dm_bits<2>(c);
    return gl_dm_bits<1>(c);
}

}  // namespace

// Launch on `stream`. One layer in W_group_mode 1, 2 or 3 with csm 0-3: x (M,
// K), M <= 64, bf16 (x_code 2) or e4m3 codes (x_code 3, K a multiple of 16);
// `wq` (K / epw, N) words of `bits` (1, 2, 4) codes; `scales` (K / gs, N) bf16
// group scales or null (scale 1); `zeros` (K / gs, N) bf16 zeros z (not
// folded) or null; `zscalar` one int32 zero on the device or null (no zero
// row: z = the scalar, or 0); `sx` (M) float32 per-token scales for csm 2 / 3
// and `cs` (N) channel scales for csm 1 / 3, float32 (code 0) or bf16 (code
// 2). N a multiple of 8 (of 32 for W1), every base 16-byte aligned. K is cut
// into `splits` ranges of `k_per_split` (a multiple of 128 and of gs unless gs
// = K; none empty); with splits > 1 the call needs `part`, (splits, M, N)
// floats, and `counters`, one int32 per column tile, all 0, which the kernel
// leaves 0.
// `stages` and `mrows` (group rows a stage) come from ops/decode.modes_plan.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int gl_decode_modes(const void* x, const void* wq, const void* scales,
                               const void* zeros, const void* zscalar, const void* sx,
                               const void* cs, void* part, void* counters, void* out, int M, int N,
                               int K, int gs, int bits, int x_code, int splits, int k_per_split,
                               int stages, int mrows, int csm, int cs_code, void* stream_ptr) {
    const DMCall c{x, wq, scales, zeros, zscalar, sx, cs, nullptr, part, counters, out, 1, M, N,
                   K, gs, x_code, splits, k_per_split, stages, mrows, csm, cs_code,
                   static_cast<cudaStream_t>(stream_ptr)};
    return check_and_run(c, bits);
}

// Layer *layer_idx (a device pointer to one int32) of L layers with csm 0 or
// 1, as gl_decode_modes otherwise: wq (L, K / epw, N); `scales` and `zeros`
// (L, K / gs, N) bf16 or null; `cs` (L, N) channel scales for csm 1, float32
// (code 0) or bf16 (code 2). No scalar zero and no per-token scales: the
// stacked gate refuses both.
extern "C" int gl_decode_modes_stacked(const void* x, const void* wq, const void* scales,
                                       const void* zeros, const void* cs, const void* layer_idx,
                                       void* part, void* counters, void* out, int L, int M, int N,
                                       int K, int gs, int bits, int x_code, int splits,
                                       int k_per_split, int stages, int mrows, int csm,
                                       int cs_code, void* stream_ptr) {
    if (layer_idx == nullptr || L < 1 || (csm != 0 && csm != 1))
        return static_cast<int>(cudaErrorInvalidValue);
    const DMCall c{x, wq, scales, zeros, nullptr, nullptr, csm == 1 ? cs : nullptr, layer_idx,
                   part, counters, out, L, M, N, K, gs, x_code, splits, k_per_split, stages, mrows,
                   csm, cs_code, static_cast<cudaStream_t>(stream_ptr)};
    return check_and_run(c, bits);
}
#endif
