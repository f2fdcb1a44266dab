// SPDX-License-Identifier: Apache-2.0
// General fused dequantize + GEMM, float path: out = csm(x @ dequant(W)) for
// any M, the weights dequantized in the compute dtype.
//
// Replaces the TPU kernel gemlite_tpu/ops/pallas_gemm.py:pallas_fused_matmul
// off its int path (pallas_gemm.py:145-212) for every integer-code form its
// gate admits: x in bf16 / fp16, or int8 / fp8 (e4m3, e5m2) x computed in
// bf16 (pallas_gemm.py:337-339; both exact in bf16); non-packed int8 /
// fp16 / bf16 weights, or W1 / W2 / W4 / W8 codes in LSB-first int32 words
// of (K / e, N); W_group_mode 0-4 with scalar or grouped zeros; csm 0-3.
// Each weight is dequantized in the compute dtype with one rounding per op
// (the JAX kernel's meta_f32=False arithmetic), the products run in bf16 or
// fp16 with float32 sums, and the csm scales apply to the float32 sums.
//
// What bounds it: the weights. An A16W8 layer of 14336 x 4096 is 58.7 MB of
// int8, 17.5 us at 3.35 TB/s for any M up to about 128 (then the bf16
// products: 0.12 ms at M 1024). The design streams each weight byte once per
// token tile and keeps the dequantization off the critical path:
//   * the operands are swapped: out^T = W^T . x^T on mma.sync m16n8k16 (bf16
//     or fp16 in, float32 sums). A is a 16-column x 16-k tile of W
//     dequantized in registers, B a 16-k x 8-token tile of x, so a token tile
//     of 8 rows wastes no product at M <= 8. A block owns 128 columns and 8
//     (M <= 8) or up to 128 token rows; each of its 4 warps owns 32 columns,
//     and each A fragment it builds feeds every token tile;
//   * a lane owns 4 consecutive columns (4g .. 4g + 3 of its warp: A rows g
//     and g + 8 of the warp's two m16 tiles) and, in each block of 16 J k,
//     the 4 J consecutive k from 4 J t (lane g = lane / 4, t = lane % 4; J =
//     2, or e / 4 for W2 / W1 codes). Step j of the block takes k 4 j .. 4 j
//     + 3 of the lane's run as the fragment's k 2t, 2t + 1, 2t + 8, 2t + 9: a
//     sum over k does not depend on their order, and x is paired the same
//     way, so nothing crosses lanes. A lane reads one 32-bit word of 4 int8
//     columns (or 8 bytes of 16-bit weights) from each of its rows, or one
//     16-byte piece of 4 columns' packed words for the whole block;
//   * the dequantization of modes 0 and 2 is one fma a weight: a code q
//     placed in a float's mantissa as 2^15 + q (one byte permute, or a shift
//     and a mask), then fma(2^15 + q, s, -(2^15 + bias) s) = (q - bias) s
//     exactly (at most 8 + 11 bits), rounded once to the compute dtype by the
//     pair conversion, as the plain version rounds its one product. Modes 1,
//     3 and 4 round after every op, as the plain version does, in instances
//     of their own that switch on the mode once a step;
//   * a ring of 2-6 cp.async stages brings each 128-deep step: the raw weight
//     rows (words XOR-swizzled by the lane that reads them, so that a warp's
//     reads hit 32 banks), the x rows (16-byte pieces placed in the order the
//     lanes read them, swizzled by row) and the step's group rows of scales
//     and zeros, read once per lane and k block (once a step or a weight for
//     groups that do not hold a lane's run). Copies past M, N or the K range
//     fill zeros;
//   * K is split over gridDim.z where the tiles alone leave SMs idle
//     (ops/fused.float_plan, a function of M, N and K): each split writes its
//     float32 partial, the last block of the tile adds the partials in split
//     order, applies the csm epilogue and leaves its counter at 0. One launch,
//     no allocation; the output bits depend only on the plan.
#include <cuda_fp8.h>

#include <algorithm>
#include <atomic>
#include <type_traits>

#include "gl_common.cuh"

// gl_fused_float's arguments, as one value for the parts below
struct FFCall {
    const void *x, *W, *scales, *zeros, *zero_scalar, *sx;
    void *out, *part, *counters;
    int M, N, K, x_code, W_nbits, elems, w_code, mode, csm, gs_s, gs_z, s_code, z_code, out_code;
    int nt, splits, k_per_split;
    cudaStream_t stream;
};

namespace {

using gl::cp_async16;
using gl::cp_async4;
using gl::cp_async8;
using gl::cp_async_commit;
using gl::cp_async_wait_n;
using gl::smem_u32;
using bf16 = __nv_bfloat16;

constexpr int BK = 128;                  // K per ring stage
constexpr int BN = 128;                  // output columns per block: 4 warps of 32
constexpr int kThreads = 128;
constexpr int kMaxStages = 6;
constexpr int kSmemMax = 227 * 1024;     // an SM's shared memory for blocks
constexpr int kSmemBlock = kSmemMax - 1024;       // the most one block takes

enum Form { kI8 = 0, k16 = 1, kW8 = 2, kW4 = 3, kW2 = 4, kW1 = 5 };

// v rounded to the compute dtype CT, as a float
template <typename CT> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<bf16>(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}
template <> __device__ __forceinline__ float rnd<__half>(float v) { return __half2float(__float2half_rn(v)); }

// e: k per stored element; eb: bytes per element; bits: bits per code; J:
// 16-deep steps per lane block (a lane owns 4 J consecutive k of the block);
// bias: what the code placed in the mantissa carries beyond its value
template <int F> struct FF;
template <> struct FF<kI8> { static constexpr int e = 1,  eb = 1, bits = 8,  J = 2; };
template <> struct FF<k16> { static constexpr int e = 1,  eb = 2, bits = 16, J = 2; };
template <> struct FF<kW8> { static constexpr int e = 4,  eb = 4, bits = 8,  J = 2; };
template <> struct FF<kW4> { static constexpr int e = 8,  eb = 4, bits = 4,  J = 2; };
template <> struct FF<kW2> { static constexpr int e = 16, eb = 4, bits = 2,  J = 4; };
template <> struct FF<kW1> { static constexpr int e = 32, eb = 4, bits = 1,  J = 8; };

template <int F> __host__ __device__ constexpr int raw_bytes() { return BK / FF<F>::e * BN * FF<F>::eb; }
// stored rows a lane reads for one k block
template <int F> __host__ __device__ constexpr int rows_per_lane() { return 4 * FF<F>::J / FF<F>::e; }
template <int F> __host__ __device__ constexpr float code_bias() {
    return F == kI8 ? 32896.f : F == k16 ? 0.f : 32768.f;     // 2^15 (+ 128 for signed int8)
}

// word w of stored row r of a stage's raw tile: bits 3-4 of w flipped by the
// lane t that reads the row, so that the 4 lanes of a column group read 4
// bank groups (16-byte pieces stay whole)
template <int F> __device__ __forceinline__ int raw_word(int r, int w) {
    return r * (BN * FF<F>::eb / 4) + (w ^ (((r / rows_per_lane<F>()) & 3) << 3));
}

// 8-k unit u (k 8u .. 8u + 7 of the stage) of x row m: placed where the lanes
// read it (lane t's pair pp of its block at 4 pp + t), then swizzled by row:
// 16-byte units by bit 0 of m (the 8 lanes of a 16-byte read phase), 8-byte
// units by bits 0-1 (the 16 lanes of an 8-byte phase)
template <int J, int XB> __host__ __device__ __forceinline__ int x_unit(int m, int u) {
    const int kb = u / (2 * J), r = u % (2 * J), t = r / (J / 2), pp = r % (J / 2);
    const int P = kb * 2 * J + 4 * pp + t;
    return P ^ (XB == 2 ? (m & 1) << 2 : (m & 3) << 2);
}

// 1-byte fp8 activations, e4m3 or e5m2 by Params::x_fp8 (instances of their
// own, for the W4 and W2 codes of A8W4 / A8W2_HQQ_INT_dynamic only: the
// int8-x instances stay as they were)
struct fp8x {
    uint8_t bits;
};

struct Params {
    const void* x;              // (M, K) bf16 / fp16 / int8 / fp8
    const void* W;              // (K / e, N) int32 words, or (K, N) int8 / fp16 / bf16
    const void* scales;         // (K / gs_s, N), or (1, N) channel scales
    const void* zeros;          // (K / gs_z, N), or nullptr
    const int* zero_scalar;     // one int32, or nullptr
    const float* sx;            // (M) per-token scales, or nullptr
    void* out;                  // (M, N)
    float* part;                // (splits, M, N) float32 partials
    int* counters;              // one per output tile, 0 between calls
    int M, N, K, mode, csm, gs_s, gs_z, w_code, s_code, z_code, out_code;
    int k_per_split, stages;
    int xrows;                  // x rows a stage holds (8 nt)
    int srows, zrows;           // group rows of scales / zeros a stage holds (0: not staged)
    int wvec, svec, zvec;       // copy sizes: 16 / 4 bytes, or plain loads (1 / 2)
    int meta_q;                 // k that share one metadata lookup: 4 J, 4 or 1
    int x_fp8;                  // fp8x: the fp8 DType (3 e4m3, 8 e5m2)
};

__host__ __device__ inline int meta_bytes(int rows, int code) {
    return rows * BN * (code == gl::kF32 ? 4 : 2);
}
template <int F, typename XT> __host__ __device__ inline int stage_bytes(const Params& p) {
    return raw_bytes<F>() + p.xrows * BK * (int)sizeof(XT) + meta_bytes(p.srows, p.s_code) +
           meta_bytes(p.zrows, p.z_code);
}

// the stage's group rows of one metadata tensor, zeros past its valid rows
__device__ __forceinline__ void load_meta_rows(const Params& p, const void* src0, int gs, int rows,
                                               int code, int vec, unsigned char* dst, int n0, int k0,
                                               int k_end) {
    const int esz = code == gl::kF32 ? 4 : 2, rb = BN * esz;
    const int g0 = k0 / gs, gv = min(rows, (k_end - 1) / gs - g0 + 1);
    const int cbv = (p.N - n0) * esz;
    const size_t stride = (size_t)p.N * esz;
    const unsigned char* src = static_cast<const unsigned char*>(src0) + ((size_t)g0 * p.N + n0) * esz;
    if (vec == 16) {
        for (int i = threadIdx.x; i < rows * (rb / 16); i += kThreads) {
            const int r = i / (rb / 16), cb = (i % (rb / 16)) * 16;
            const bool ok = r < gv && cb < cbv;
            cp_async16(smem_u32(dst + r * rb + cb), ok ? src + r * stride + cb : src0, ok ? 16 : 0);
        }
    } else if (vec == 4) {
        for (int i = threadIdx.x; i < rows * (rb / 4); i += kThreads) {
            const int r = i / (rb / 4), cb = (i % (rb / 4)) * 4;
            const bool ok = r < gv && cb < cbv;
            cp_async4(smem_u32(dst + r * rb + cb), ok ? src + r * stride + cb : src0, ok ? 4 : 0);
        }
    } else {                                             // 2-byte metadata, odd N
        for (int i = threadIdx.x; i < rows * (rb / 2); i += kThreads) {
            const int r = i / (rb / 2), cb = (i % (rb / 2)) * 2;
            *reinterpret_cast<uint16_t*>(dst + r * rb + cb) =
                r < gv && cb < cbv ? *reinterpret_cast<const uint16_t*>(src + r * stride + cb) : 0;
        }
    }
}

// one ring stage: k0 .. k0 + BK - 1 of the range ending at k_end
template <int F, typename XT>
__device__ __forceinline__ void load_stage(const Params& p, unsigned char* st, int m0, int n0, int k0,
                                           int k_end) {
    constexpr int e = FF<F>::e, eb = FF<F>::eb, rows = BK / e, rb = BN * eb;
    const int t = threadIdx.x;
    uint32_t* ws = reinterpret_cast<uint32_t*>(st);
    const int rv = min(rows, (k_end - k0) / e);
    const int cbv = (p.N - n0) * eb;                     // valid bytes of a row
    const size_t stride = (size_t)p.N * eb;
    const unsigned char* W = static_cast<const unsigned char*>(p.W) + (size_t)(k0 / e) * stride +
                             (size_t)n0 * eb;
    if (p.wvec == 16) {
        for (int i = t; i < rows * (rb / 16); i += kThreads) {
            const int r = i / (rb / 16), c = (i % (rb / 16)) * 4;      // first word of the piece
            const bool ok = r < rv && 4 * c < cbv;
            cp_async16(smem_u32(ws + raw_word<F>(r, c)), ok ? W + r * stride + 4 * c : p.W, ok ? 16 : 0);
        }
    } else if (p.wvec == 4) {
        for (int i = t; i < rows * (rb / 4); i += kThreads) {
            const int r = i / (rb / 4), c = i % (rb / 4);
            const bool ok = r < rv && 4 * c < cbv;
            cp_async4(smem_u32(ws + raw_word<F>(r, c)), ok ? W + r * stride + 4 * c : p.W, ok ? 4 : 0);
        }
    } else {                                             // rows not 4-byte aligned: plain loads
        for (int i = t; i < rows * rb; i += kThreads) {
            const int r = i / rb, b = i % rb;
            reinterpret_cast<unsigned char*>(ws + raw_word<F>(r, b >> 2))[b & 3] =
                r < rv && b < cbv ? W[r * stride + b] : 0;
        }
    }
    constexpr int XB = sizeof(XT), UB = 8 * XB;
    unsigned char* xs = st + raw_bytes<F>();
    const XT* x = static_cast<const XT*>(p.x);
    for (int i = t; i < p.xrows * (BK / 8); i += kThreads) {
        const int m = i >> 4, u = i & 15, k = k0 + 8 * u;
        const bool ok = m0 + m < p.M && k < k_end;
        const unsigned dst = smem_u32(xs + m * (BK * XB) + x_unit<FF<F>::J, XB>(m, u) * UB);
        const void* src = ok ? (const void*)(x + (size_t)(m0 + m) * p.K + k) : p.x;
        if constexpr (XB == 2) cp_async16(dst, src, ok ? 16 : 0);
        else cp_async8(dst, src, ok ? 8 : 0);
    }
    unsigned char* ms = xs + p.xrows * BK * XB;
    if (p.srows) load_meta_rows(p, p.scales, p.gs_s, p.srows, p.s_code, p.svec, ms, n0, k0, k_end);
    if (p.zrows)
        load_meta_rows(p, p.zeros, p.gs_z, p.zrows, p.z_code, p.zvec, ms + meta_bytes(p.srows, p.s_code),
                       n0, k0, k_end);
}

// values c0 .. c0 + 3 of group row r of a staged metadata region, rounded to CT
template <typename CT>
__device__ __forceinline__ void meta4(const unsigned char* rgn, int code, int r, int c0, float (&v)[4]) {
    if (code == gl::kF32) {
        const float4 f = *reinterpret_cast<const float4*>(rgn + (r * BN + c0) * 4);
        v[0] = rnd<CT>(f.x), v[1] = rnd<CT>(f.y), v[2] = rnd<CT>(f.z), v[3] = rnd<CT>(f.w);
    } else {
        const uint2 h = *reinterpret_cast<const uint2*>(rgn + (r * BN + c0) * 2);
        const uint32_t w[4] = {h.x & 0xffffu, h.x >> 16, h.y & 0xffffu, h.y >> 16};
#pragma unroll
        for (int c = 0; c < 4; ++c)
            v[c] = rnd<CT>(code == gl::kBF16 ? __uint_as_float(w[c] << 16)
                                             : __half2float(__ushort_as_half((unsigned short)w[c])));
    }
}

template <typename CT> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<bf16>(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a (16 x 16, row) . b (16 x 8, col), float32 sums
template <typename CT>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    if constexpr (std::is_same<CT, bf16>::value)
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
            "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    else
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
            "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^15 + byte i of u, as a float
__device__ __forceinline__ float byte_magic(uint32_t u, int i) {
    return __uint_as_float(__byte_perm(u, 0x47u, 0x4505u | (i << 4)));
}

// W_group_mode dequantization of one weight, every op rounded to CT
// (pallas_gemm.py:159-185); raw is the stored value (a code, or a 16-bit
// weight), s and z are already in CT
template <typename CT>
__device__ __forceinline__ float dq_general(float raw, int mode, float s, float z, int zs, bool zscalar) {
    const float b = rnd<CT>(raw);
    switch (mode) {
        case 0: return b;
        case 1: return rnd<CT>(__fsub_rn(b, z));
        case 2: return rnd<CT>(__fmul_rn(b, s));
        case 3:
            if (zscalar) return rnd<CT>(__fmul_rn(rnd<CT>((float)((int)raw - zs)), s));
            return rnd<CT>(__fmul_rn(rnd<CT>(__fsub_rn(b, z)), s));
        default: return rnd<CT>(__fadd_rn(rnd<CT>(__fmul_rn(b, s)), z));
    }
}

// The lane's 4 columns x 4 k of step j of a k block, as floats: 2^15 + code
// (+ 128 for int8) for codes, the stored value for 16-bit weights.
// kl: the lane's first k in the stage; wv: the lane's packed words of the block
template <int F>
__device__ __forceinline__ void lane_values(const Params& p, const uint32_t* ws, int kl, int j, int col,
                                            const uint4& wv, float (&v)[4][4]) {
    if constexpr (F == kI8) {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
            const uint32_t u = ws[raw_word<F>(kl + 4 * j + f, col >> 2)] ^ 0x80808080u;
#pragma unroll
            for (int c = 0; c < 4; ++c) v[c][f] = byte_magic(u, c);
        }
    } else if constexpr (F == k16) {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
            const uint2 h = *reinterpret_cast<const uint2*>(ws + raw_word<F>(kl + 4 * j + f, col >> 1));
            const uint32_t w[4] = {h.x & 0xffffu, h.x >> 16, h.y & 0xffffu, h.y >> 16};
#pragma unroll
            for (int c = 0; c < 4; ++c)
                v[c][f] = p.w_code == gl::kBF16 ? __uint_as_float(w[c] << 16)
                                                : __half2float(__ushort_as_half((unsigned short)w[c]));
        }
    } else if constexpr (F == kW8) {                     // step j: the lane's word j
        const uint4 q = *reinterpret_cast<const uint4*>(ws + raw_word<F>(kl / 4 + j, col));
        const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int f = 0; f < 4; ++f) v[c][f] = byte_magic(w[c], f);
    } else {
        constexpr int B = FF<F>::bits;
        constexpr uint32_t mask = (1u << B) - 1u;
        const uint32_t w[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int f = 0; f < 4; ++f)
                v[c][f] = __uint_as_float(0x47000000u | (((w[c] >> (B * (4 * j + f))) & mask) << 8));
    }
}

// The A fragments of one step from the lane's values v (lane_values), in
// mode MODE's arithmetic rounded as dq_general rounds it: a code is exact in
// CT, so b = v - bias; modes 0 and 2 (s = 1 for 0) take one fma on the
// mantissa-placed code, exact before the pack's one rounding; mode 4 rounds
// that product, then the sum; modes 1 and 3 subtract in float32 and round.
// Of m16 tile i: column 4g + 2i (rows g) and 4g + 2i + 1 (rows g + 8);
// registers 0/1 take the lane's k 0-1 of the step, registers 2/3 its k 2-3.
template <int F, typename CT, int MODE>
__device__ __forceinline__ void build_a(const float (&v)[4][4], const float (&s)[4],
                                        const float (&z)[4], const float (&nbs)[4], bool zscalar,
                                        int zs, uint32_t (&a)[2][4]) {
    constexpr float bias = code_bias<F>();
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        float d[4];
#pragma unroll
        for (int f = 0; f < 4; ++f) {
            const float b = F == k16 ? rnd<CT>(v[c][f]) : v[c][f] - bias;
            const float m = F == k16 ? b : v[c][f];      // b s = fma(m, s, nbs), exact
            if constexpr (MODE == 2) {
                d[f] = fmaf(m, s[c], nbs[c]);
            } else if constexpr (MODE == 1) {
                d[f] = __fsub_rn(b, z[c]);
            } else if constexpr (MODE == 3) {
                const float t = zscalar ? rnd<CT>((float)((int)(F == k16 ? v[c][f] : b) - zs))
                                        : rnd<CT>(__fsub_rn(b, z[c]));
                d[f] = __fmul_rn(t, s[c]);
            } else {
                d[f] = __fadd_rn(rnd<CT>(fmaf(m, s[c], nbs[c])), z[c]);
            }
        }
        a[c >> 1][c & 1] = pack2<CT>(d[0], d[1]);
        a[c >> 1][2 + (c & 1)] = pack2<CT>(d[2], d[3]);
    }
}

// where a stage's lookups read: its staged group rows and their first index
struct StageMeta {
    const unsigned char* s;
    const unsigned char* z;
    int k0, gs0, gz0;
};

// the metadata of stage k kk for the lane's 4 columns (col .. col + 3), in CT
template <typename CT>
__device__ __forceinline__ void lookup(const Params& p, const StageMeta& m, int kk, int col, float bias,
                                       float (&s)[4], float (&z)[4], float (&nbs)[4]) {
    if (p.srows) {
        meta4<CT>(m.s, p.s_code, (m.k0 + kk) / p.gs_s - m.gs0, col, s);
#pragma unroll
        for (int c = 0; c < 4; ++c) nbs[c] = -bias * s[c];
    }
    if (p.zrows) meta4<CT>(m.z, p.z_code, (m.k0 + kk) / p.gs_z - m.gz0, col, z);
}

// GEN: the general modes (1, 3, 4, or groups that split a lane's 4 k);
// else modes 0 and 2 alone (a switch in the step cost them 3-10%)
template <int F, typename CT, typename XT, int NT, bool GEN>
__device__ __forceinline__ void compute_stage(const Params& p, const unsigned char* st, int k0, int k_end,
                                              int nt, int wn0, int lane, int zs, float (&acc)[2][NT][4]) {
    constexpr int e = FF<F>::e, J = FF<F>::J, KB = 16 * J, XB = sizeof(XT);
    constexpr float bias = code_bias<F>();
    const int g = lane >> 2, t = lane & 3, col = wn0 + 4 * g;
    const uint32_t* ws = reinterpret_cast<const uint32_t*>(st);
    const unsigned char* xs = st + raw_bytes<F>();
    const unsigned char* ss = xs + p.xrows * BK * XB;
    const StageMeta sm{ss, ss + meta_bytes(p.srows, p.s_code), k0, k0 / p.gs_s, k0 / p.gs_z};
    const bool zscalar = p.zero_scalar != nullptr;
    const bool once = p.srows <= 1 && p.zrows <= 1;      // one group row serves the stage
    float s[4] = {1.f, 1.f, 1.f, 1.f}, z[4] = {0.f, 0.f, 0.f, 0.f}, nbs[4];
    if (zscalar) {
        const float zf = rnd<CT>((float)zs);
#pragma unroll
        for (int c = 0; c < 4; ++c) z[c] = zf;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) nbs[c] = -bias;
    if (once && (p.srows | p.zrows)) lookup<CT>(p, sm, 0, col, bias, s, z, nbs);

    // modes 0 and 2 unroll the stage's k blocks (4-10% faster); the general
    // instances keep a loop, where unrolled code ran slower and built longer
    // (scripts/torch_float_variants.py, kb_loop / kb_unrolled)
    constexpr int kUnroll = GEN ? 1 : BK / KB;
#pragma unroll kUnroll
    for (int kb = 0; kb < BK / KB; ++kb) {
        if (k0 + kb * KB >= k_end) break;
        const int kl = kb * KB + 4 * J * t;              // the lane's first k in the stage
        uint4 wv = make_uint4(0, 0, 0, 0);
        if constexpr (F >= kW4) wv = *reinterpret_cast<const uint4*>(ws + raw_word<F>(kl / e, col));
        if (!once) lookup<CT>(p, sm, kl, col, bias, s, z, nbs);
#pragma unroll
        for (int pp = 0; pp < J / 2; ++pp) {
            uint32_t a[2][2][4];                         // A of steps 2pp, 2pp + 1: [h][tile][reg]
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int j = 2 * pp + h;
                if (j > 0 && p.meta_q == 4) lookup<CT>(p, sm, kl + 4 * j, col, bias, s, z, nbs);
                float v[4][4];
                lane_values<F>(p, ws, kl, j, col, wv, v);
                // the mode switches once a step (warp-uniform); groups that split a
                // lane's 4 k take a lookup and dq_general a weight
                if constexpr (!GEN) {
                    build_a<F, CT, 2>(v, s, z, nbs, zscalar, zs, a[h]);
                } else if (p.meta_q != 1) {
                    switch (p.mode) {
                        case 1: build_a<F, CT, 1>(v, s, z, nbs, zscalar, zs, a[h]); break;
                        case 3: build_a<F, CT, 3>(v, s, z, nbs, zscalar, zs, a[h]); break;
                        case 4: build_a<F, CT, 4>(v, s, z, nbs, zscalar, zs, a[h]); break;
                        default: build_a<F, CT, 2>(v, s, z, nbs, zscalar, zs, a[h]); break;
                    }
                } else {
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        float d[4];
#pragma unroll
                        for (int f = 0; f < 4; ++f) {
                            lookup<CT>(p, sm, kl + 4 * j + f, col, bias, s, z, nbs);
                            d[f] = dq_general<CT>(v[c][f] - bias, p.mode, s[c], z[c], zs, zscalar);
                        }
                        a[h][c >> 1][c & 1] = pack2<CT>(d[0], d[1]);
                        a[h][c >> 1][2 + (c & 1)] = pack2<CT>(d[2], d[3]);
                    }
                }
            }
            // x k 8pp .. 8pp + 7 of the lane's run, token row 8jj + g: k 0-3 feed
            // step 2pp, k 4-7 step 2pp + 1
#pragma unroll
            for (int jj = 0; jj < NT; ++jj) {
                if (jj >= nt) break;
                const int m = 8 * jj + g;
                const int P = (kb * 2 * J + 4 * pp + t) ^ (XB == 2 ? (m & 1) << 2 : (m & 3) << 2);
                uint32_t xb[4];
                if constexpr (XB == 2) {
                    const uint4 v = *reinterpret_cast<const uint4*>(xs + m * (BK * 2) + P * 16);
                    xb[0] = v.x, xb[1] = v.y, xb[2] = v.z, xb[3] = v.w;
                } else if constexpr (std::is_same<XT, fp8x>::value) {   // fp8 x, exact in bf16
                    const uint2 v = *reinterpret_cast<const uint2*>(xs + m * BK + P * 8);
                    const __nv_fp8_interpretation_t fmt = p.x_fp8 == 8 ? __NV_E5M2 : __NV_E4M3;
                    const uint32_t u[2] = {v.x, v.y};
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        const __half2_raw hr = __nv_cvt_fp8x2_to_halfraw2(
                            static_cast<__nv_fp8x2_storage_t>((u[q >> 1] >> (16 * (q & 1))) & 0xFFFFu), fmt);
                        const float2 f = __half22float2(__half2(hr));
                        xb[q] = pack2<CT>(f.x, f.y);
                    }
                } else {                                 // int8 x, exact in bf16
                    const uint2 v = *reinterpret_cast<const uint2*>(xs + m * BK + P * 8);
                    const uint32_t u0 = v.x ^ 0x80808080u, u1 = v.y ^ 0x80808080u;
                    xb[0] = pack2<CT>(byte_magic(u0, 0) - 32896.f, byte_magic(u0, 1) - 32896.f);
                    xb[1] = pack2<CT>(byte_magic(u0, 2) - 32896.f, byte_magic(u0, 3) - 32896.f);
                    xb[2] = pack2<CT>(byte_magic(u1, 0) - 32896.f, byte_magic(u1, 1) - 32896.f);
                    xb[3] = pack2<CT>(byte_magic(u1, 2) - 32896.f, byte_magic(u1, 3) - 32896.f);
                }
                mma16816<CT>(acc[0][jj], a[0][0], xb[0], xb[1]);
                mma16816<CT>(acc[1][jj], a[0][1], xb[0], xb[1]);
                mma16816<CT>(acc[0][jj], a[1][0], xb[2], xb[3]);
                mma16816<CT>(acc[1][jj], a[1][1], xb[2], xb[3]);
            }
        }
    }
}

// The block's sums, acc[(i * nt_max + jj) * 4 + r] in fragment order (tile
// i, token tile jj: r = 0 / 2 at column 4g + 2i / + 1, token 8jj + 2t; r = 1
// / 3 token 8jj + 2t + 1): into the output, or with K split the block's
// partial, and the last block of the tile adds the partials in split order
// and leaves its counter at 0. Not inlined: one copy serves every instance.
__device__ __noinline__ void epilogue(const Params p, const float* acc, int nt_max, int nt, int m0,
                                      int n, int lane, int* flag) {
    const int split = blockIdx.z, nsplit = gridDim.z;
    const int t = lane & 3;
    const size_t MN = (size_t)p.M * p.N;
    const bool vec = p.N % 4 == 0;
    const bool by_row = p.csm == 2 || p.csm == 3, by_col = p.csm == 1 || p.csm == 3;
    if (nsplit > 1) {
        for (int jj = 0; jj < nt; ++jj)
            for (int h = 0; h < 2; ++h) {
                const int m = m0 + 8 * jj + 2 * t + h;
                if (m >= p.M || n >= p.N) continue;
                float v[4];
                for (int c = 0; c < 4; ++c) v[c] = acc[((c >> 1) * nt_max + jj) * 4 + 2 * (c & 1) + h];
                float* dst = p.part + split * MN + (size_t)m * p.N + n;
                if (vec) *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
                else
                    for (int c = 0; c < 4 && n + c < p.N; ++c) dst[c] = v[c];
            }
        __threadfence();
        __syncthreads();
        const int tile = blockIdx.y * gridDim.x + blockIdx.x;
        if (threadIdx.x == 0) *flag = atomicAdd(p.counters + tile, 1) == nsplit - 1;
        __syncthreads();
        if (!*flag) return;
        __threadfence();
        if (threadIdx.x == 0) p.counters[tile] = 0;
    }
    float col_s[4] = {1.f, 1.f, 1.f, 1.f};
    for (int c = 0; c < 4; ++c)
        if (by_col && n + c < p.N) col_s[c] = gl::load_meta(p.scales, n + c, p.s_code);
    for (int jj = 0; jj < nt; ++jj)
        for (int h = 0; h < 2; ++h) {
            const int m = m0 + 8 * jj + 2 * t + h;
            if (m >= p.M || n >= p.N) continue;
            const size_t idx = (size_t)m * p.N + n;
            float v[4];
            if (nsplit > 1) {
                v[0] = v[1] = v[2] = v[3] = 0.f;
                for (int s = 0; s < nsplit; ++s) {
                    const float* src = p.part + s * MN + idx;
                    if (vec) {
                        const float4 r = __ldcg(reinterpret_cast<const float4*>(src));
                        v[0] = __fadd_rn(v[0], r.x), v[1] = __fadd_rn(v[1], r.y);
                        v[2] = __fadd_rn(v[2], r.z), v[3] = __fadd_rn(v[3], r.w);
                    } else {
                        for (int c = 0; c < 4 && n + c < p.N; ++c) v[c] = __fadd_rn(v[c], __ldcg(src + c));
                    }
                }
            } else {
                for (int c = 0; c < 4; ++c) v[c] = acc[((c >> 1) * nt_max + jj) * 4 + 2 * (c & 1) + h];
            }
            const float row_s = by_row ? p.sx[m] : 1.f;
            for (int c = 0; c < 4; ++c) v[c] = __fmul_rn(__fmul_rn(v[c], row_s), col_s[c]);
            if (vec && p.out_code == gl::kBF16) {
                const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]), hi = __floats2bfloat162_rn(v[2], v[3]);
                *reinterpret_cast<uint2*>(static_cast<bf16*>(p.out) + idx) =
                    make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
            } else if (vec && p.out_code == gl::kF16) {
                const __half2 lo = __floats2half2_rn(v[0], v[1]), hi = __floats2half2_rn(v[2], v[3]);
                *reinterpret_cast<uint2*>(static_cast<__half*>(p.out) + idx) =
                    make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
            } else if (vec) {
                *reinterpret_cast<float4*>(static_cast<float*>(p.out) + idx) = make_float4(v[0], v[1], v[2], v[3]);
            } else {
                for (int c = 0; c < 4 && n + c < p.N; ++c) gl::store_out(p.out, idx + c, v[c], p.out_code);
            }
        }
}

// blocks an SM the registers and the ring leave room for: four 8-row blocks
// (128 registers; six spilled and ran 15% slower, three ran 2% slower at M 8)
// and two of 128 rows (scripts/torch_float_variants.py)
template <int NT> constexpr int min_blocks() { return NT == 1 ? 4 : 2; }

template <int F, typename CT, typename XT, int NT, bool GEN>
__global__ void __launch_bounds__(kThreads, min_blocks<NT>()) fused_float_kernel(Params p) {
    extern __shared__ __align__(128) unsigned char smem[];
    __shared__ int last_flag;
    const int S = p.stages, SB = stage_bytes<F, XT>(p);
    const int lane = threadIdx.x & 31, wn0 = (threadIdx.x >> 5) * 32;
    const int m0 = blockIdx.x * (8 * NT), n0 = blockIdx.y * BN;
    const int k_begin = blockIdx.z * p.k_per_split, k_end = min(p.K, k_begin + p.k_per_split);
    const int steps = (k_end - k_begin + BK - 1) / BK;
    const int nt = min(NT, (p.M - m0 + 7) / 8);
    const int zs = p.zero_scalar != nullptr ? *p.zero_scalar : 0;

    float acc[2][NT][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

    for (int s = 0; s < S - 1; ++s) {
        if (s < steps) load_stage<F, XT>(p, smem + s * SB, m0, n0, k_begin + s * BK, k_end);
        cp_async_commit();
    }
    for (int it = 0; it < steps; ++it) {
        // stage it has landed; every warp is done with stage it - 1
        cp_async_wait_n(S - 2);
        __syncthreads();
        const int nxt = it + S - 1;
        if (nxt < steps) load_stage<F, XT>(p, smem + (nxt % S) * SB, m0, n0, k_begin + nxt * BK, k_end);
        cp_async_commit();
        compute_stage<F, CT, XT, NT, GEN>(p, smem + (it % S) * SB, k_begin + it * BK, k_end, nt, wn0,
                                          lane, zs, acc);
    }
    cp_async_wait_n(0);
    float flat[2 * NT * 4];                              // leaves the registers once
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) flat[(i * NT + j) * 4 + r] = acc[i][j][r];
    epilogue(p, flat, NT, nt, m0, n0 + wn0 + 4 * (lane >> 2), lane, &last_flag);
}

template <int F, typename CT, typename XT, int NT>
cudaError_t launch(Params p, int splits, cudaStream_t stream) {
    static std::atomic<unsigned> ready{0};               // a bit per device: attribute set
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (!(ready.load() & (1u << dev))) {
        err = cudaFuncSetAttribute(fused_float_kernel<F, CT, XT, NT, false>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBlock);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(fused_float_kernel<F, CT, XT, NT, true>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBlock);
        if (err != cudaSuccess) return err;
        ready.fetch_or(1u << dev);
    }
    // the deepest ring that leaves room for min_blocks blocks an SM, at least
    // two stages (16-bit weights at 128 rows: one block an SM)
    const int SB = stage_bytes<F, XT>(p);
    p.stages = std::max(2, std::min(kMaxStages, (kSmemMax / min_blocks<NT>() - 1024) / SB));
    if (p.stages * SB > kSmemBlock) return cudaErrorInvalidValue;
    p.meta_q = p.meta_q == 0 ? 4 * FF<F>::J : p.meta_q;
    if ((p.gs_s % p.meta_q) || (p.gs_z % p.meta_q)) p.meta_q = (p.gs_s % 4 || p.gs_z % 4) ? 1 : 4;
    const dim3 grid((p.M + 8 * NT - 1) / (8 * NT), (p.N + BN - 1) / BN, splits);
    if ((p.mode == 0 || p.mode == 2) && p.meta_q != 1)
        fused_float_kernel<F, CT, XT, NT, false><<<grid, kThreads, p.stages * SB, stream>>>(p);
    else
        fused_float_kernel<F, CT, XT, NT, true><<<grid, kThreads, p.stages * SB, stream>>>(p);
    return cudaGetLastError();
}

template <int F>
cudaError_t launch_types(const Params& p, int x_code, int nt, int splits, cudaStream_t stream) {
    if (x_code == gl::kBF16)
        return nt == 1 ? launch<F, bf16, bf16, 1>(p, splits, stream) : launch<F, bf16, bf16, 16>(p, splits, stream);
    if (x_code == gl::kF16)
        return nt == 1 ? launch<F, __half, __half, 1>(p, splits, stream)
                       : launch<F, __half, __half, 16>(p, splits, stream);
    if (x_code == gl::kI8)
        return nt == 1 ? launch<F, bf16, int8_t, 1>(p, splits, stream)
                       : launch<F, bf16, int8_t, 16>(p, splits, stream);
    if constexpr (F == kW4 || F == kW2) {                // fp8 x (e4m3 3, e5m2 8): A8W4 / A8W2
        if (x_code == 3 || x_code == 8)
            return nt == 1 ? launch<F, bf16, fp8x, 1>(p, splits, stream)
                           : launch<F, bf16, fp8x, 16>(p, splits, stream);
    }
    return cudaErrorInvalidValue;
}

// 16 / 4 byte copies where the rows and the base allow, else plain loads
int copy_size(const void* base, long long row_bytes, int plain) {
    const uintptr_t b = reinterpret_cast<uintptr_t>(base);
    if (row_bytes % 16 == 0 && b % 16 == 0) return 16;
    if (row_bytes % 4 == 0 && b % 4 == 0) return 4;
    return plain;
}

// group rows that a 128-deep stage starting at a multiple of 128 can touch
int stage_rows(int gs, int K) {
    const int rows = gs % BK == 0 ? 1 : BK % gs == 0 ? BK / gs : BK / gs + 2;
    return std::min(rows, K / gs);
}

// One call of weight form F: the checks, the kernel's Params, the launch.
template <int F>
int run_form(const FFCall& c) {
    const int M = c.M, N = c.N, K = c.K, mode = c.mode, csm = c.csm, splits = c.splits;
    const int k_per_split = c.k_per_split, nt = c.nt, gs_s = c.gs_s, gs_z = c.gs_z;
    const bool split_ok = splits == 1 ? k_per_split >= K
                                      : (splits > 1 && k_per_split % BK == 0 &&
                                         (long long)(splits - 1) * k_per_split < K &&
                                         (long long)splits * k_per_split >= K && c.part != nullptr &&
                                         c.counters != nullptr);
    const bool shape_ok = M >= 1 && N >= 1 && K % 32 == 0 && (nt == 16 || (nt == 1 && M <= 8)) &&
                          mode >= 0 && mode <= 4 && csm >= 0 && csm <= 3 && gs_s > 0 && gs_z > 0 &&
                          K % gs_s == 0 && K % gs_z == 0 && reinterpret_cast<uintptr_t>(c.x) % 16 == 0;
    const bool meta_ok = (mode < 2 || c.scales != nullptr) &&
                         ((mode != 1 && mode != 3) || c.zeros != nullptr || c.zero_scalar != nullptr) &&
                         (mode != 4 || c.zeros != nullptr) && (csm == 0 || csm == 2 || c.scales != nullptr) &&
                         (csm < 2 || c.sx != nullptr);
    if (!split_ok || !shape_ok || !meta_ok) return static_cast<int>(cudaErrorInvalidValue);
    Params p{c.x, c.W, c.scales, c.zeros, static_cast<const int*>(c.zero_scalar),
             static_cast<const float*>(c.sx), c.out, static_cast<float*>(c.part),
             static_cast<int*>(c.counters), M, N, K, mode, csm, gs_s, gs_z, c.w_code, c.s_code,
             c.z_code, c.out_code, k_per_split, 0, 8 * std::min(nt, (M + 7) / 8), 0, 0, 0, 0, 0, 0};
    p.x_fp8 = c.x_code == 3 || c.x_code == 8 ? c.x_code : 0;
    const bool staged_s = mode >= 2, staged_z = (mode == 1 || mode >= 3) && c.zero_scalar == nullptr;
    if (staged_s) {
        p.srows = stage_rows(gs_s, K);
        p.svec = copy_size(c.scales, (long long)N * (c.s_code == gl::kF32 ? 4 : 2), 2);
    } else {
        p.gs_s = K;
    }
    if (staged_z) {
        p.zrows = stage_rows(gs_z, K);
        p.zvec = copy_size(c.zeros, (long long)N * (c.z_code == gl::kF32 ? 4 : 2), 2);
    } else {
        p.gs_z = K;
    }
    p.wvec = copy_size(c.W, (long long)N * FF<F>::eb, 1);
    return static_cast<int>(launch_types<F>(p, c.x_code, nt, splits, c.stream));
}

}  // namespace

// The instances build in parts, one nvcc each, into one library
// (ops/build.KERNEL_PARTS): a part compiled with GL_FF_FORMS, a mask of
// weight forms (bit F of Form), instantiates those forms behind
// gl_ff_form<F>; the part compiled with GL_FF_ENTRY holds gl_fused_float,
// which calls the forms of GL_FF_LINKED. Compiled alone, with none of them,
// the source builds every form and the entry, as one part.
#ifndef GL_FF_FORMS
#define GL_FF_FORMS 0x3F
#define GL_FF_ENTRY 1
#endif
#ifndef GL_FF_LINKED
#define GL_FF_LINKED 0x3F
#endif

template <int F>
int gl_ff_form(const FFCall& c);

#define GL_FF_FORM(F)                                              \
    template <>                                                    \
    int gl_ff_form<F>(const FFCall& c) { return run_form<F>(c); }
#if GL_FF_FORMS & 0x01
GL_FF_FORM(kI8)
#endif
#if GL_FF_FORMS & 0x02
GL_FF_FORM(k16)
#endif
#if GL_FF_FORMS & 0x04
GL_FF_FORM(kW8)
#endif
#if GL_FF_FORMS & 0x08
GL_FF_FORM(kW4)
#endif
#if GL_FF_FORMS & 0x10
GL_FF_FORM(kW2)
#endif
#if GL_FF_FORMS & 0x20
GL_FF_FORM(kW1)
#endif
#undef GL_FF_FORM

#ifdef GL_FF_ENTRY
// Launch on `stream`. x_code / w_code / s_code / z_code / out_code are DType
// values; x is bf16 or fp16 (the compute dtype), or int8, or fp8 (e4m3 3, e5m2
// 8) over W4 / W2 codes (both computed in bf16).
// The weights are W_nbits codes, elems to an int32 word, or non-packed
// (elems 1) int8 / fp16 / bf16. nt (1 or 16) is the block's token tiles of 8
// rows; K is cut into `splits` ranges of `k_per_split` (one range, or ranges
// of a multiple of 128 of which none is empty), all in one launch; with
// splits > 1 the call needs `part`, (splits, M, N) floats, and `counters`,
// one int32 per output tile, all 0, which the kernel leaves 0. The plan comes
// from ops/fused.float_plan. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int gl_fused_float(const void* x, const void* W, const void* scales, const void* zeros,
                              const void* zero_scalar, const void* sx, void* out, void* part,
                              void* counters, int M, int N, int K, int x_code, int W_nbits, int elems,
                              int w_code, int mode, int csm, int gs_s, int gs_z, int s_code, int z_code,
                              int out_code, int nt, int splits, int k_per_split, void* stream_ptr) {
    const FFCall c{x, W, scales, zeros, zero_scalar, sx, out, part, counters, M, N, K, x_code,
                   W_nbits, elems, w_code, mode, csm, gs_s, gs_z, s_code, z_code, out_code, nt,
                   splits, k_per_split, static_cast<cudaStream_t>(stream_ptr)};
#if GL_FF_LINKED & 0x01
    if (elems == 1 && w_code == gl::kI8) return gl_ff_form<kI8>(c);
#endif
#if GL_FF_LINKED & 0x02
    if (elems == 1 && (w_code == gl::kF16 || w_code == gl::kBF16)) return gl_ff_form<k16>(c);
#endif
#if GL_FF_LINKED & 0x04
    if (W_nbits == 8 && elems == 4) return gl_ff_form<kW8>(c);
#endif
#if GL_FF_LINKED & 0x08
    if (W_nbits == 4 && elems == 8) return gl_ff_form<kW4>(c);
#endif
#if GL_FF_LINKED & 0x10
    if (W_nbits == 2 && elems == 16) return gl_ff_form<kW2>(c);
#endif
#if GL_FF_LINKED & 0x20
    if (W_nbits == 1 && elems == 32) return gl_ff_form<kW1>(c);
#endif
    return static_cast<int>(cudaErrorInvalidValue);
}
#endif
