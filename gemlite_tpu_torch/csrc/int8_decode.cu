// SPDX-License-Identifier: Apache-2.0
// Exact int8 decode for M <= 64: out = csm(x_i8 @ dequant_int(W)), the sum
// over K in int32 on the int8 tensor cores (mma.sync s8), one launch a call.
//
// Replaces the TPU kernel gemlite_tpu/ops/pallas_int8.py:pallas_int8_decode
// for its weight forms (_w_kind there):
//   kDense  non-packed int8 (K, N): A8W8, W_group_mode 0, csm 3;
//   kU8     W8 codes, 4 to an int32 word: code ^ 0x80 is (code - 128) as
//           int8, and (128 - z) * sum(x) restores x . (code - z);
//   kNib4 / kNib2  W4 / W2 codes, 8 / 16 to a word (codes 0..15 fit int8).
// Zeros are integers: none, one scalar, one per column, or one per group;
// each span's correction (off8 - z) * sum(x) is exact in int32.
//
// What bounds it: at M <= 64 the weight bytes (K * N for int8) dwarf x and
// the output, so the bound is bytes over HBM bandwidth (M 8, 14336 x 4096:
// about 59 MB / 3.35 TB/s = 17.6 us). The design reads each weight byte
// once at every M and keeps about 32-64 KB of weights in flight per SM:
//   * the operands are swapped: out^T = W^T . x^T, so the A operand of
//     mma.sync m16n8k32 is a 16-column x 32-k tile of W and B a 32-k x
//     8-row tile of x (K-major as stored). A block owns 128 output columns
//     and all M rows: each of its 4 warps owns 32 columns (two m16 tiles)
//     and every n8 tile of rows, so at M 64 a thread holds 2 x 8 x 4 int32
//     sums. Rows past M are zero in the x tile and never stored;
//   * a ring of 2-5 stages (as many as fit 74 KB, so three blocks share an
//     SM) of cp.async 16-byte copies brings each 128-deep K step: the raw
//     N-major weight tile and the x tile;
//   * each step's raw tile is turned K-major into an XOR-swizzled tile Bt[n][k]
//     (int8 rows by 4 x 4 byte transposes, packed words by shifts, masks and
//     __byte_perm; u8 codes ^ 0x80), in natural k order, so the k order of a
//     step needs no permutation: ldmatrix brings both operands as the mma
//     wants them, conflict-free (gl::w_off, gl::x_off);
//   * K is split over gridDim.y so that about three blocks run per SM, all
//     in one wave (ops/int8_decode.plan). Each split writes its partial
//     (int32 sums, or float32 for float groups) to a workspace and bumps the
//     column tile's arrival counter; the last block to arrive adds the
//     partials in split order, applies the epilogue and leaves the counter
//     at 0. With one split the block applies the epilogue directly: no
//     memset, no second launch. (Adding into a zeroed int32 accumulator with
//     red.global.add instead cost about 50 us at M 64: two million atomics,
//     scripts/torch_int8_variants.py on the H100);
//   * grouped mode-3 scales are float: each group's exact int32 sum is
//     scaled in float32 and the groups are added in float32 in k order
//     within a split, and the splits in split order, so a run repeats bit
//     for bit;
//   * the epilogue (one __noinline__ function for every instance): the
//     sums leave the registers through shared memory, then the channel-wise
//     mode-3 scale, csm 1/2/3 in float32, and the cast to the output dtype.
// Groups that are not whole mma steps: the sum step SK is a template
// parameter. Groups of a multiple of 32 (and no groups) take m16n8k32, of 16
// but not 32 m16n8k16, and any other size (a multiple of 4, e.g. 20 or 24)
// a per-lane __dp4a step over the same fragment layout.
// sum(x) over a span, for the zero correction, is summed once per step and
// sub-step into shared memory (xsub) and read by the lanes that own the rows.
//
// Left for later: the copies alone reach about 1.8 TB/s (128-byte pieces of
// 128 rows a step); wgmma from shared memory and a TMA producer warp.
#include <atomic>

#include "gl_common.cuh"

// gl_int8_decode's arguments, as one value for the parts below
struct I8Call {
    const void *x, *W, *zeros, *scales, *sx;
    void *part, *counters, *out;
    int M, N, K, kind, gs_loop, splits, k_per_split, zero_mode, off8, fgroup, flat_scale, csm;
    int s_code, z_code, out_code;
    cudaStream_t stream;
};

namespace {

using gl::cp_async16;
using gl::cp_async4;
using gl::cp_async_commit;
using gl::cp_async_wait_n;
using gl::ldsm_x2;
using gl::ldsm_x4;
using gl::mma_s8;
using gl::mma_s8_k16;
using gl::smem_u32;
using gl::w_off;
using gl::x_off;

constexpr int BN = 128;                 // output columns per block
constexpr int BK = 128;                 // K per pipeline step
constexpr int kThreads = 128;           // 4 warps of 32 columns
constexpr int kTile = BN * BK;          // bytes of the K-major weight tile
constexpr int kSmemBudget = 74 * 1024;  // three blocks per SM, two stages at M 64
constexpr int kMaxStages = 5;

enum Kind { kDense = 0, kU8 = 1, kNib4 = 2, kNib2 = 3 };

// k per stored element, bytes per element, bytes of a step's raw tile
__host__ __device__ constexpr int elems(int kind) {
    return kind == kDense ? 1 : (kind == kU8 ? 4 : (kind == kNib4 ? 8 : 16));
}
__host__ __device__ constexpr int elem_bytes(int kind) { return kind == kDense ? 1 : 4; }
__host__ __device__ constexpr int raw_bytes(int kind) {
    return BK / elems(kind) * BN * elem_bytes(kind);
}

struct Params {
    const int8_t* x;          // (M, K)
    const void* W;            // (K, N) int8, or (K / e, N) int32 words
    const void* zeros;        // zero_mode 1: one value; 2: (1, N); 3: (G, N)
    const void* scales;       // (G, N) group scales, or (1, N) channel scales
    const float* sx;          // (M) per-token scales, or nullptr
    void* out;                // (M, N)
    void* part;               // (splits, M, N) split partials: int32 sums or float32
    int* counters;            // one per column tile, 0 between calls
    int M, N, K, gs_loop, k_per_split, zero_mode, off8, flat_scale, csm;
    int s_code, z_code, out_code;
    int xrows;                // rows of the x tile: M rounded up to 16
    int stages;               // ring depth
    int wvec;                 // weight copy size, 16 or 4 bytes
    int needs_xs;             // a zero correction is taken
};

// one step's x tile and raw weight tile, k0 .. k0 + BK - 1 of the range
// ending at k_end; copies past M, N or k_end fill zeros
template <int KIND>
__device__ __forceinline__ void load_step(const Params& p, unsigned char* xs, unsigned char* raw,
                                          int n0, int k0, int k_end) {
    const int t = threadIdx.x;
    for (int i = t; i < p.xrows * (BK / 16); i += kThreads) {
        const int m = i >> 3, c = i & 7, k = k0 + c * 16;
        const bool ok = m < p.M && k < k_end;
        cp_async16(smem_u32(xs + x_off(m, c)), ok ? p.x + (size_t)m * p.K + k : (const void*)p.x,
                   ok ? 16 : 0);
    }
    constexpr int e = elems(KIND), eb = elem_bytes(KIND), rows = BK / e, rb = BN * eb;
    const int rows_valid = min(rows, (k_end - k0) / e);
    const int cb_valid = (p.N - n0) * eb;
    const size_t stride = (size_t)p.N * eb;
    const unsigned char* W = static_cast<const unsigned char*>(p.W) + (size_t)(k0 / e) * stride +
                             (size_t)n0 * eb;
    if (p.wvec == 16) {
        for (int i = t; i < rows * (rb / 16); i += kThreads) {
            const int r = i / (rb / 16), cb = (i % (rb / 16)) * 16;
            const bool ok = r < rows_valid && cb < cb_valid;
            cp_async16(smem_u32(raw + r * rb + cb), ok ? W + r * stride + cb : p.W, ok ? 16 : 0);
        }
    } else {
        for (int i = t; i < rows * (rb / 4); i += kThreads) {
            const int r = i / (rb / 4), cb = (i % (rb / 4)) * 4;
            const bool ok = r < rows_valid && cb < cb_valid;
            cp_async4(smem_u32(raw + r * rb + cb), ok ? W + r * stride + cb : p.W, ok ? 4 : 0);
        }
    }
}

__device__ __forceinline__ void store_chunk(unsigned char* bt, int n, int c, uint32_t v0, uint32_t v1,
                                            uint32_t v2, uint32_t v3) {
    *reinterpret_cast<uint4*>(bt + w_off(n, c)) = make_uint4(v0, v1, v2, v3);
}

// the raw tile -> K-major int8 tile Bt[n][k], natural k order
template <int KIND>
__device__ __forceinline__ void to_kmajor(const unsigned char* raw, unsigned char* bt) {
    const int t = threadIdx.x;
    if constexpr (KIND == kDense) {
        // thread: columns 4q .. 4q + 3, chunks c and c + 4 (16 k each)
        const int q = t & 31;
#pragma unroll
        for (int c = t >> 5; c < BK / 16; c += kThreads / 32) {
            uint32_t o[4][4];                                // [column][4 k]
#pragma unroll
            for (int g = 0; g < 4; ++g) {
                const unsigned char* row = raw + (16 * c + 4 * g) * BN + 4 * q;
                uint32_t tr[4];
                gl::transpose4(*reinterpret_cast<const uint32_t*>(row),
                               *reinterpret_cast<const uint32_t*>(row + BN),
                               *reinterpret_cast<const uint32_t*>(row + 2 * BN),
                               *reinterpret_cast<const uint32_t*>(row + 3 * BN), tr);
#pragma unroll
                for (int j = 0; j < 4; ++j) o[j][g] = tr[j];
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) store_chunk(bt, 4 * q + j, c, o[j][0], o[j][1], o[j][2], o[j][3]);
        }
    } else {
        const uint32_t* w = reinterpret_cast<const uint32_t*>(raw);
        const int n = t;                                     // one column a thread
#pragma unroll
        for (int c = 0; c < BK / 16; ++c) {
            if constexpr (KIND == kU8) {                     // 4 words (16 k) per chunk
                store_chunk(bt, n, c, w[(4 * c) * BN + n] ^ 0x80808080u,
                            w[(4 * c + 1) * BN + n] ^ 0x80808080u,
                            w[(4 * c + 2) * BN + n] ^ 0x80808080u,
                            w[(4 * c + 3) * BN + n] ^ 0x80808080u);
            } else if constexpr (KIND == kNib4) {            // 2 words per chunk
                uint32_t v[4];
#pragma unroll
                for (int s = 0; s < 2; ++s) {
                    // byte b of lo / hi holds the codes of k = 2b / 2b + 1
                    const uint32_t word = w[(2 * c + s) * BN + n];
                    const uint32_t lo = word & 0x0f0f0f0fu, hi = (word >> 4) & 0x0f0f0f0fu;
                    v[2 * s] = __byte_perm(lo, hi, 0x5140);
                    v[2 * s + 1] = __byte_perm(lo, hi, 0x7362);
                }
                store_chunk(bt, n, c, v[0], v[1], v[2], v[3]);
            } else {                                         // 1 word per chunk
                // byte b of plane p holds the code of k = 4b + p
                const uint32_t word = w[c * BN + n];
                const uint32_t t0 = word & 0x03030303u, t1 = (word >> 2) & 0x03030303u;
                const uint32_t t2 = (word >> 4) & 0x03030303u, t3 = (word >> 6) & 0x03030303u;
                const uint32_t p01 = __byte_perm(t0, t1, 0x5140), p23 = __byte_perm(t2, t3, 0x5140);
                const uint32_t q01 = __byte_perm(t0, t1, 0x7362), q23 = __byte_perm(t2, t3, 0x7362);
                store_chunk(bt, n, c, __byte_perm(p01, p23, 0x5410), __byte_perm(p01, p23, 0x7632),
                            __byte_perm(q01, q23, 0x5410), __byte_perm(q01, q23, 0x7632));
            }
        }
    }
}

// xsub[s][m] = sum of x[m, k] over sub-step s (k = s SK .. s SK + SK - 1) of
// the step's x tile
template <int SK>
__device__ __forceinline__ void x_sums(const unsigned char* xs, int* xsub, int xrows) {
    for (int i = threadIdx.x; i < (BK / SK) * xrows; i += kThreads) {
        const int s = i / xrows, m = i % xrows;
        int sum = 0;
        if constexpr (SK == 4) {
            const uint32_t w = *reinterpret_cast<const uint32_t*>(xs + x_off(m, s >> 2) + (s & 3) * 4);
            sum = __dp4a((int)w, 0x01010101, 0);
        } else {
#pragma unroll
            for (int c = 0; c < SK / 16; ++c) {
                const uint4 v = *reinterpret_cast<const uint4*>(xs + x_off(m, s * (SK / 16) + c));
                sum = __dp4a((int)v.x, 0x01010101, sum);
                sum = __dp4a((int)v.y, 0x01010101, sum);
                sum = __dp4a((int)v.z, 0x01010101, sum);
                sum = __dp4a((int)v.w, 0x01010101, sum);
            }
        }
        xsub[s * xrows + m] = sum;
    }
}

// Sub-step s (k = s SK .. s SK + SK - 1 of the step) for one warp: columns
// wn0 + 16 i + (0..15) of the block, row tiles j < nt. acc[i][j][r] is the
// m16n8 fragment: r = 0, 1 at column (lane >> 2), rows 8 j + 2 (lane & 3) +
// 0, 1; r = 2, 3 the same rows at column (lane >> 2) + 8.
template <int SK>
__device__ __forceinline__ void sub_step(const unsigned char* xs, const unsigned char* bt, int s,
                                         int nt, int wn0, int lane, int (&acc)[2][8][4]) {
    const unsigned xa = smem_u32(xs), ba = smem_u32(bt);
    if constexpr (SK == 32) {
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
            ldsm_x4(ba + w_off(wn0 + i * 16 + (lane & 15), 2 * s + (lane >> 4)), a[i][0], a[i][1],
                    a[i][2], a[i][3]);
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
            if (2 * jp >= nt) break;
            uint32_t b0, b1, b2, b3;
            ldsm_x4(xa + x_off(jp * 16 + (lane & 7) + ((lane >> 4) << 3), 2 * s + ((lane >> 3) & 1)),
                    b0, b1, b2, b3);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                mma_s8(acc[i][2 * jp], a[i], b0, b1);
                if (2 * jp + 1 < nt) mma_s8(acc[i][2 * jp + 1], a[i], b2, b3);
            }
        }
    } else if constexpr (SK == 16) {
        uint32_t a[2][2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
            ldsm_x2(ba + w_off(wn0 + i * 16 + (lane & 15), s), a[i][0], a[i][1]);
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
            if (2 * jp >= nt) break;
            uint32_t b0, b1;
            ldsm_x2(xa + x_off(jp * 16 + (lane & 15), s), b0, b1);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                mma_s8_k16(acc[i][2 * jp], a[i][0], a[i][1], b0);
                if (2 * jp + 1 < nt) mma_s8_k16(acc[i][2 * jp + 1], a[i][0], a[i][1], b1);
            }
        }
    } else {
        // __dp4a over the same fragment layout: 4 k a sub-step
        const int g = lane >> 2, q = lane & 3, c = s >> 2, o = (s & 3) * 4;
        uint32_t w[2][2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h)
                w[i][h] = *reinterpret_cast<const uint32_t*>(bt + w_off(wn0 + i * 16 + g + 8 * h, c) + o);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            if (j >= nt) break;
            const int x0 = (int)*reinterpret_cast<const uint32_t*>(xs + x_off(8 * j + 2 * q, c) + o);
            const int x1 = (int)*reinterpret_cast<const uint32_t*>(xs + x_off(8 * j + 2 * q + 1, c) + o);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                acc[i][j][0] = __dp4a((int)w[i][0], x0, acc[i][j][0]);
                acc[i][j][1] = __dp4a((int)w[i][0], x1, acc[i][j][1]);
                acc[i][j][2] = __dp4a((int)w[i][1], x0, acc[i][j][2]);
                acc[i][j][3] = __dp4a((int)w[i][1], x1, acc[i][j][3]);
            }
        }
    }
}

// the zero value of column n for group g, as an int (zeros hold whole
// values: an int32 scalar, or float32 / fp16 / bf16)
__device__ __forceinline__ int zero_of(const Params& p, int g, int n) {
    if (p.zero_mode == 0 || n >= p.N) return 0;
    const size_t i = p.zero_mode == 1 ? 0 : (p.zero_mode == 2 ? (size_t)n : (size_t)g * p.N + n);
    if (p.z_code == gl::kI32) return static_cast<const int*>(p.zeros)[i];
    return (int)gl::load_meta(p.zeros, i, p.z_code);
}

// out[m, n] = csm(flat_scale ? v * s[n] : v)
__device__ __forceinline__ void store_one(const Params& p, float v, int m, int n) {
    if (p.flat_scale) v = __fmul_rn(v, gl::load_meta(p.scales, n, p.s_code));
    v = gl::channel_scale(v, p.csm, p.scales, p.s_code, p.sx, m, n);
    gl::store_out(p.out, (size_t)m * p.N + n, v, p.out_code);
}

// The block's sums, staged in shared memory as 4-byte words tile[m][BN]
// (int32, or float32 for float groups): the epilogue into the output, or
// with K split the block's partial, and the last block of the column tile
// adds the partials in split order and leaves its counter at 0. Not
// inlined: one copy serves every instance of the kernel, which keeps ptxas
// short (inlined into each instance, the build ran for minutes).
__device__ __noinline__ void finish(const Params p, const uint32_t* tile, int* flag, int fgroup) {
    const int n0 = blockIdx.x * BN, split = blockIdx.y, nsplit = gridDim.y;
    const size_t MN = (size_t)p.M * p.N;
    if (nsplit > 1) {
        uint32_t* part = static_cast<uint32_t*>(p.part);
        for (int e = threadIdx.x; e < p.M * BN; e += kThreads) {
            const int m = e / BN, n = n0 + e % BN;
            if (n < p.N) part[split * MN + (size_t)m * p.N + n] = tile[e];
        }
        __threadfence();
        __syncthreads();
        if (threadIdx.x == 0) *flag = atomicAdd(p.counters + blockIdx.x, 1) == nsplit - 1;
        __syncthreads();
        if (!*flag) return;
        __threadfence();
    }
    for (int e = threadIdx.x; e < p.M * BN; e += kThreads) {
        const int m = e / BN, n = n0 + e % BN;
        if (n >= p.N) continue;
        const size_t idx = (size_t)m * p.N + n;
        float v;
        if (nsplit == 1) {
            v = fgroup ? __uint_as_float(tile[e]) : __int2float_rn((int)tile[e]);
        } else if (fgroup) {
            const float* fp = static_cast<const float*>(p.part);
            v = __ldcg(fp + idx);
            for (int sp = 1; sp < nsplit; ++sp) v = __fadd_rn(v, __ldcg(fp + sp * MN + idx));
        } else {
            const int* ip = static_cast<const int*>(p.part);
            int t = __ldcg(ip + idx);
            for (int sp = 1; sp < nsplit; ++sp) t += __ldcg(ip + sp * MN + idx);
            v = __int2float_rn(t);
        }
        store_one(p, v, m, n);
    }
    if (nsplit > 1 && threadIdx.x == 0) p.counters[blockIdx.x] = 0;
}

template <int KIND, int SK, bool FGROUP>
__global__ void __launch_bounds__(kThreads, 2) int8_decode_kernel(Params p) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int S = p.stages, RB = raw_bytes(KIND), XT = p.xrows * BK;
    unsigned char* xs = smem;                                // [S][xrows][BK], swizzled
    unsigned char* raw = xs + S * XT;                        // [S][raw tile]
    unsigned char* bt = raw + S * RB;                        // [BN][BK], swizzled
    int* xsub = reinterpret_cast<int*>(bt + kTile);          // [BK / SK][xrows]
    int* last_flag = xsub + (BK / SK) * p.xrows;

    const int lane = threadIdx.x & 31, wn0 = (threadIdx.x >> 5) * 32;
    const int g4 = lane >> 2, q = lane & 3;
    const int n0 = blockIdx.x * BN, split = blockIdx.y;
    const int k_begin = split * p.k_per_split, k_end = min(p.K, k_begin + p.k_per_split);
    const int steps = (k_end - k_begin + BK - 1) / BK;
    const int nt = (p.M + 7) / 8;                            // n8 tiles of rows

    int acc[2][8][4];
    float facc[2][8][4];
    int xsv[8][2];                                           // sum(x) of rows 8j + 2q, + 1
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) { acc[i][j][r] = 0; facc[i][j][r] = 0.f; }
#pragma unroll
    for (int j = 0; j < 8; ++j) xsv[j][0] = xsv[j][1] = 0;

    // the end of a span (a group, or the whole range): acc += (off8 - z) *
    // sum(x); float groups scale it, add it to facc and start again from 0
    auto span_end = [&](int grp) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int n = n0 + wn0 + i * 16 + g4 + 8 * h;
                const int d = p.off8 - zero_of(p, grp, n);
                float sc = 0.f;
                if constexpr (FGROUP)
                    sc = n < p.N ? gl::load_meta(p.scales, (size_t)grp * p.N + n, p.s_code) : 0.f;
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    if (j >= nt) break;
#pragma unroll
                    for (int r2 = 0; r2 < 2; ++r2) {
                        const int corr = acc[i][j][2 * h + r2] + d * xsv[j][r2];
                        if constexpr (FGROUP) {
                            facc[i][j][2 * h + r2] = __fadd_rn(facc[i][j][2 * h + r2],
                                                               __fmul_rn(__int2float_rn(corr), sc));
                            acc[i][j][2 * h + r2] = 0;
                        } else {
                            acc[i][j][2 * h + r2] = corr;
                        }
                    }
                }
            }
#pragma unroll
        for (int j = 0; j < 8; ++j) xsv[j][0] = xsv[j][1] = 0;
    };

    for (int s = 0; s < S - 1; ++s) {
        if (s < steps) load_step<KIND>(p, xs + s * XT, raw + s * RB, n0, k_begin + s * BK, k_end);
        cp_async_commit();
    }
    int grp = p.gs_loop ? k_begin / p.gs_loop : 0, left = p.gs_loop;
    for (int it = 0; it < steps; ++it) {
        // step it has landed; every warp is done with step it - 1
        cp_async_wait_n(S - 2);
        __syncthreads();
        const int nxt = it + S - 1;
        if (nxt < steps)
            load_step<KIND>(p, xs + (nxt % S) * XT, raw + (nxt % S) * RB, n0, k_begin + nxt * BK, k_end);
        cp_async_commit();
        const unsigned char* xt = xs + (it % S) * XT;
        to_kmajor<KIND>(raw + (it % S) * RB, bt);
        if (p.needs_xs) x_sums<SK>(xt, xsub, p.xrows);
        __syncthreads();
        const int nsub = min(BK, k_end - (k_begin + it * BK)) / SK;
        for (int s = 0; s < nsub; ++s) {
            sub_step<SK>(xt, bt, s, nt, wn0, lane, acc);
            if (p.needs_xs) {
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    if (j >= nt) break;
                    const int2 v = *reinterpret_cast<const int2*>(xsub + s * p.xrows + 8 * j + 2 * q);
                    xsv[j][0] += v.x;
                    xsv[j][1] += v.y;
                }
            }
            if (p.gs_loop && (left -= SK) == 0) {
                span_end(grp++);
                left = p.gs_loop;
            }
        }
    }
    cp_async_wait_n(0);
    if (!p.gs_loop) span_end(0);

    // the sums leave the registers through shared memory, once
    __syncthreads();                                         // the ring is free
    uint32_t* tile = reinterpret_cast<uint32_t*>(smem);      // [M][BN] 4-byte words
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            if (j >= nt) break;
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int m = 8 * j + 2 * q + (r & 1);
                if (m < p.M)
                    tile[m * BN + wn0 + i * 16 + g4 + 8 * (r >> 1)] =
                        FGROUP ? __float_as_uint(facc[i][j][r]) : (uint32_t)acc[i][j][r];
            }
        }
    __syncthreads();
    finish(p, tile, last_flag, FGROUP);
}

// shared memory of a block: the ring, the K-major tile, xsub and the flag
__host__ int smem_bytes(int kind, int sk, int xrows, int stages) {
    return stages * (raw_bytes(kind) + xrows * BK) + kTile + (BK / sk) * xrows * 4 + 16;
}

template <int KIND, int SK, bool FGROUP>
cudaError_t launch(Params p, int splits, cudaStream_t stream) {
    static std::atomic<unsigned> ready{0};                   // a bit per device: attribute set
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (!(ready.load() & (1u << dev))) {
        err = cudaFuncSetAttribute(int8_decode_kernel<KIND, SK, FGROUP>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
        if (err != cudaSuccess) return err;
        ready.fetch_or(1u << dev);
    }
    const int fixed = smem_bytes(KIND, SK, p.xrows, 0);
    p.stages = min(kMaxStages, (kSmemBudget - fixed) / (raw_bytes(KIND) + p.xrows * BK));
    if (p.stages < 2) return cudaErrorInvalidValue;
    const int bytes = smem_bytes(KIND, SK, p.xrows, p.stages);
    const dim3 grid((p.N + BN - 1) / BN, splits);
    int8_decode_kernel<KIND, SK, FGROUP><<<grid, kThreads, bytes, stream>>>(p);
    return cudaGetLastError();
}

template <int KIND, bool FGROUP>
cudaError_t launch_sk(const Params& p, int splits, cudaStream_t stream) {
    const int gs = p.gs_loop;
    if (gs == 0 || gs % 32 == 0) return launch<KIND, 32, FGROUP>(p, splits, stream);
    if constexpr (KIND == kDense) {
        return cudaErrorInvalidValue;                        // grouped dense int8 is refused
    } else {
        if (gs % 16 == 0) return launch<KIND, 16, FGROUP>(p, splits, stream);
        if constexpr (KIND == kNib2) {
            return cudaErrorInvalidValue;                    // W2 groups are whole 16s
        } else {
            if (gs % 4) return cudaErrorInvalidValue;
            return launch<KIND, 4, FGROUP>(p, splits, stream);
        }
    }
}

template <int KIND>
cudaError_t launch_kind(const Params& p, int fgroup, int splits, cudaStream_t stream) {
    if constexpr (KIND == kDense) {
        if (fgroup) return cudaErrorInvalidValue;
        return launch_sk<KIND, false>(p, splits, stream);
    } else {
        return fgroup ? launch_sk<KIND, true>(p, splits, stream)
                      : launch_sk<KIND, false>(p, splits, stream);
    }
}

// One call of weight kind KIND: the checks, the kernel's Params, the launch.
template <int KIND>
int run_kind(const I8Call& c) {
    const int M = c.M, N = c.N, K = c.K, splits = c.splits, k_per_split = c.k_per_split;
    const bool split_ok = splits >= 1 && k_per_split % 16 == 0 &&
                          (long long)(splits - 1) * k_per_split < K &&
                          (long long)splits * k_per_split >= K &&
                          (c.gs_loop == 0 || k_per_split % c.gs_loop == 0) &&
                          (splits == 1 || (c.counters != nullptr && c.part != nullptr));
    if (M < 1 || M > 64 || N % 4 || K % 16 || !split_ok || (c.gs_loop && K % c.gs_loop) ||
        reinterpret_cast<uintptr_t>(c.x) % 16 || reinterpret_cast<uintptr_t>(c.W) % 4)
        return static_cast<int>(cudaErrorInvalidValue);
    Params p{static_cast<const int8_t*>(c.x), c.W, c.zeros, c.scales,
             static_cast<const float*>(c.sx), c.out, c.part, static_cast<int*>(c.counters),
             M, N, K, c.gs_loop, k_per_split, c.zero_mode, c.off8, c.flat_scale, c.csm, c.s_code,
             c.z_code, c.out_code, (M + 15) / 16 * 16, 0, 0, c.zero_mode != 0 || c.off8 != 0};
    const int row_bytes = N * elem_bytes(KIND);
    p.wvec = row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(c.W) % 16 == 0 ? 16 : 4;
    return static_cast<int>(launch_kind<KIND>(p, c.fgroup, splits, c.stream));
}

// One 16-column x 8-row x 32-k product through the kernel's own staging
// (swizzled tiles, ldmatrix, sub_step<SK>, the fragment's (column, row)
// mapping): out (8, 16) int32 = x (8, 32) . w (32, 16), w stored N-major as
// the i8_dense weights are.
template <int SK>
__global__ void mma_tile_kernel(const int8_t* w, const int8_t* x, int* out) {
    __shared__ __align__(128) unsigned char bt[32 * BK];    // sub_step reads 32 columns
    __shared__ __align__(128) unsigned char xs[16 * BK];
    const int lane = threadIdx.x;
    for (int i = lane; i < 32 * BK; i += 32) bt[i] = 0;
    for (int i = lane; i < 16 * BK; i += 32) xs[i] = 0;
    __syncwarp();
    for (int i = lane; i < 32 * 16; i += 32) {
        const int k = i / 16, n = i % 16;                    // w[k][n] -> Bt[n][k]
        bt[w_off(n, k >> 4) + (k & 15)] = static_cast<unsigned char>(w[i]);
    }
    for (int i = lane; i < 8 * 32; i += 32) {
        const int m = i / 32, k = i % 32;
        xs[x_off(m, k >> 4) + (k & 15)] = static_cast<unsigned char>(x[i]);
    }
    __syncwarp();
    int acc[2][8][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;
    for (int s = 0; s < 32 / SK; ++s) sub_step<SK>(xs, bt, s, 1, 0, lane, acc);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int n = (lane >> 2) + 8 * (r >> 1), m = 2 * (lane & 3) + (r & 1);
        out[m * 16 + n] = acc[0][0][r];
    }
}

}  // namespace

// The instances build in parts, one nvcc each, into one library
// (ops/build.KERNEL_PARTS): a part compiled with GL_I8_KINDS, a mask of
// weight kinds (bit KIND of Kind), instantiates those kinds behind
// gl_i8_kind<KIND>; the part compiled with GL_I8_ENTRY holds the entries,
// which call every kind. Compiled alone, with neither, the source builds
// every kind and the entries, as one part.
#ifndef GL_I8_KINDS
#define GL_I8_KINDS 0x0F
#define GL_I8_ENTRY 1
#endif

template <int KIND>
int gl_i8_kind(const I8Call& c);

#define GL_I8_KIND(KIND)                                         \
    template <>                                                  \
    int gl_i8_kind<KIND>(const I8Call& c) { return run_kind<KIND>(c); }
#if GL_I8_KINDS & 0x01
GL_I8_KIND(kDense)
#endif
#if GL_I8_KINDS & 0x02
GL_I8_KIND(kU8)
#endif
#if GL_I8_KINDS & 0x04
GL_I8_KIND(kNib4)
#endif
#if GL_I8_KINDS & 0x08
GL_I8_KIND(kNib2)
#endif
#undef GL_I8_KIND

#ifdef GL_I8_ENTRY
// Launch on `stream`. kind: Kind; s_code / z_code / out_code: DType codes of
// scales, zeros and the output. K is cut into `splits` ranges of
// `k_per_split` (none empty); with splits > 1 the call needs `part`,
// (splits, M, N) 4-byte words for the partials, and `counters`, one int32
// per 128 columns, all 0, which the kernel leaves 0. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int gl_int8_decode(const void* x, const void* W, const void* zeros, const void* scales,
                              const void* sx, void* part, void* counters, void* out,
                              int M, int N, int K, int kind, int gs_loop, int splits,
                              int k_per_split, int zero_mode, int off8, int fgroup, int flat_scale,
                              int csm, int s_code, int z_code, int out_code, void* stream_ptr) {
    const I8Call c{x, W, zeros, scales, sx, part, counters, out, M, N, K, kind, gs_loop, splits,
                   k_per_split, zero_mode, off8, fgroup, flat_scale, csm, s_code, z_code, out_code,
                   static_cast<cudaStream_t>(stream_ptr)};
    switch (kind) {
        case kDense: return gl_i8_kind<kDense>(c);
        case kU8: return gl_i8_kind<kU8>(c);
        case kNib4: return gl_i8_kind<kNib4>(c);
        case kNib2: return gl_i8_kind<kNib2>(c);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// The sum step alone on one tile (sk 32, 16 or 4): out (8, 16) int32 = x (8,
// 32) . w (32, 16), through mma_tile_kernel. Returns the cudaError_t.
extern "C" int gl_int8_mma_tile(const void* w, const void* x, void* out, int sk, void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const int8_t* wp = static_cast<const int8_t*>(w);
    const int8_t* xp = static_cast<const int8_t*>(x);
    int* op = static_cast<int*>(out);
    if (sk == 32) mma_tile_kernel<32><<<1, 32, 0, stream>>>(wp, xp, op);
    else if (sk == 16) mma_tile_kernel<16><<<1, 32, 0, stream>>>(wp, xp, op);
    else if (sk == 4) mma_tile_kernel<4><<<1, 32, 0, stream>>>(wp, xp, op);
    else return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
}
#endif
