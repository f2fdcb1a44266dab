// SPDX-License-Identifier: Apache-2.0
// W1/W2/W4 decode for M <= 64: out = x @ dequant(W_q), bf16 out, float32
// sums on the bf16 tensor cores, W_group_mode 4 with bf16 group scales and
// pre-folded zeros, or modes 1-3 with a channel-scale epilogue, one launch a
// call.
//
// Four entries share one body:
//   gl_decode          one layer: replaces the TPU kernel
//                      gemlite_tpu/ops/pallas_decode.py:pallas_decode_matmul
//                      on the mode-4 layers the serving path runs;
//   gl_decode_modes    one layer in W_group_mode 1, 2 or 3 (bf16 group
//                      scales, grouped bf16 or scalar int32 zeros) with csm
//                      0-3: the same TPU kernel on the A8Wn, channel-wise
//                      A16Wn and BitNet layers (fp8 x comes in as its bf16
//                      image, exact). Its instances (template flag M3) build
//                      w = (q - z) * s in three bf16x2 fmas a code pair,
//                      rounded as the plain version rounds, and multiply the
//                      finished float32 sums by the per-token and channel
//                      scales; a channel-wise layer (gs = K) reads its one
//                      metadata row at every k, so its K split is planned in
//                      units of 256 like a grouped layer's;
//   gl_decode_stacked  layer l of an L-layer stack (L, K / epw, N): replaces
//                      gemlite_tpu/ops/pallas_scan.py:pallas_decode_matmul_stacked.
//                      The TPU kernel reads l as a scalar-prefetch operand in
//                      its index maps; here each block reads l from a device
//                      pointer and offsets its weight, scale and zero
//                      pointers by it, so the host never reads the index;
//   gl_decode_modes_stacked  layer l of a stack in W_group_mode 1-3 with csm 0
//                      or 1 (channel-wise A16Wn): the same TPU kernel on
//                      those layers, the M3 instances read as
//                      gl_decode_stacked reads its layer, with the channel
//                      scales (L, 1, N) offset by it too. It keeps
//                      gl_decode_modes's plan, so the two agree bit for bit.
//
// What bounds it: the packed weights and their metadata (K * N * bits / 8 +
// 4 * K / gs * N bytes) dwarf x and the output at M <= 64, so the bound is
// bytes over HBM bandwidth (M 8, 14336 x 4096 W4 gs 128: 31.2 MB, 9.4 us).
// The design streams each weight byte once at every M and keeps it off the
// float32 pipe:
//   * the operands are swapped: out^T = W^T . x^T on mma.sync m16n8k16 bf16
//     with float32 sums. A is a 16-column x 16-k tile of dequantized W built
//     in registers, B a 16-k x 8-row tile of x. A block owns 128 columns and
//     all M rows: each warp owns 32 columns (two m16 tiles) and every n8 tile
//     of rows, so the work that grows with M runs on the tensor cores and
//     each A fragment serves up to 8 of them;
//   * K is permuted inside each 32-deep block so that a lane dequantizes
//     whole words: lane (g = lane / 4, t = lane % 4) takes codes k0 + 8t ..
//     k0 + 8t + 7 of columns g and g + 8 (a whole W4 word, half a W2 word,
//     one byte of a W1 word), pairs code e with code e + 4 (compute_stage),
//     and reads x[m][k0 + 8t .. + 7] as one 16-byte piece, paired the same
//     way by byte permutes. A sum over k does not depend on the order of k,
//     so nothing crosses lanes;
//   * dequantization in bf16x2, rounded as the plain version rounds: a code
//     pair becomes 128 + q exactly (a shift, then a mask and | 0x4300 in one
//     lop3), fma(128 + q, s, -128 s) rounds the exact q * s once, and
//     fma(t, 1, z) rounds the exact t + z once. The plain version rounds
//     the same two results once each (float32 holds q * s exactly, and
//     rounding t + z to float32 and then to bf16 is one correct rounding:
//     24 >= 2 * 8 + 2 bits);
//   * a ring of 2-6 stages of 16-byte cp.async pieces brings each 128-deep
//     step: the step's words (column-swizzled so that the 4-byte reads of a
//     warp hit 32 banks), its scale and zero rows and its x chunk (rows
//     swizzled for conflict-free 16-byte reads), up to 54 KB a block;
//   * K is split over gridDim.y so that about four blocks run per SM, in
//     one wave: the warps of four blocks hide the latency of the
//     dequantization chains (scripts/torch_decode_variants.py). The
//     split depends on N, K and gs only, never on M, so a row's sum is the
//     same whatever the batch, and the stacked entry equals the per-layer
//     entry bit for bit. Each split writes its float32 partial and bumps
//     its column tile's arrival counter; the last block adds the partials in
//     split order, writes bf16 and leaves the counter at 0. With one split
//     the block writes its result directly. One launch, no allocation.
#include <atomic>

#include "gl_common.cuh"
#include "w4_common.cuh"

namespace {

using gl::cp_async16;
using gl::cp_async4;
using gl::cp_async_commit;
using gl::cp_async_wait_n;
using gl::smem_u32;
using bf16 = __nv_bfloat16;

constexpr int BK = 128;                  // K per ring stage
constexpr int BN = 128;                  // output columns per block: 4 warps of 32
constexpr int kMinBlocks = 4;            // blocks an SM that the registers leave room for
constexpr int kMaxStages = 6;
constexpr int kSmemMax = 112 * 1024;     // the most shared memory a launch may take

struct Params {
    const bf16* x;                       // (M, K)
    const uint32_t* wq;                  // ([L,] K / epw, N)
    const bf16* scales;                  // ([L,] K / gs, N)
    const bf16* zeros;                   // ([L,] K / gs, N), -z * s
    const int* layer_idx;                // stacked entry: the layer, on the device
    int L;
    bf16* out;                           // (M, N)
    float* part;                         // (splits, M, N) float32 partials
    int* counters;                       // one per column tile, 0 between calls
    int M, N, K, gs, k_per_split;
    int stages;                          // ring depth
    int mrows;                           // group rows a stage holds
    int wvec, mvec;                      // copy sizes of words (16 / 4) and metadata (16 / 4 / 2)
};


__host__ __device__ constexpr int word_rows(int bits) { return BK * bits / 32; }
__host__ __device__ constexpr int words_bytes(int bits) { return word_rows(bits) * BN * 4; }
__host__ __device__ constexpr int x_bytes(int nt) { return nt * 8 * BK * 2; }
__host__ __device__ constexpr int meta_bytes(int mrows) { return mrows * BN * 2; }
__host__ __device__ constexpr int stage_bytes(int bits, int nt, int mrows) {
    return words_bytes(bits) + x_bytes(nt) + 2 * meta_bytes(mrows);
}

// index of word (r, c) in a stage's word tile: bits 3-4 of c flipped by r,
// so the lanes of a warp (rows t, columns g and g + 8 of two m16 tiles) hit
// 32 banks and a 16-byte piece (4 columns) stays whole
__device__ __forceinline__ int w_idx(int r, int c) { return r * BN + (c ^ ((r & 3) << 3)); }
// 16-byte chunk c (8 k) of row m of the x tile: rows 2i and 2i + 1 of a
// quarter warp's 16-byte reads land on the two halves of the banks
__device__ __forceinline__ int x_chunk(int m, int c) { return c ^ ((m & 1) << 2); }

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// one ring stage: the words, x and metadata of k0 .. k0 + BK - 1 of the
// range ending at k_end; copies past M, N or k_end fill zeros (a zero code
// with a zero scale and zero is a zero weight, against a zero x)
template <int NT, int BITS, bool M3>
__device__ __forceinline__ void load_stage(const Params& p, const Modes& m, const uint32_t* wq,
                                           const bf16* sc, const bf16* ze, unsigned char* st,
                                           int n0, int k0, int k_end) {
    constexpr int EPW = 32 / BITS, WR = word_rows(BITS), XR = NT * 8;
    uint32_t* ws = reinterpret_cast<uint32_t*>(st);
    bf16* xs = reinterpret_cast<bf16*>(st + words_bytes(BITS));
    const int t = threadIdx.x;

    const int rv = min(WR, (k_end - k0) / EPW);
    const uint32_t* wg = wq + (size_t)(k0 / EPW) * p.N + n0;
    if (p.wvec == 16) {
        for (int i = t; i < WR * (BN / 4); i += BN) {
            const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
            const bool ok = r < rv && n0 + c < p.N;
            cp_async16(smem_u32(ws + w_idx(r, c)), ok ? wg + (size_t)r * p.N + c : (const void*)wq,
                       ok ? 16 : 0);
        }
    } else {
        for (int i = t; i < WR * BN; i += BN) {
            const int r = i / BN, c = i % BN;
            const bool ok = r < rv && n0 + c < p.N;
            cp_async4(smem_u32(ws + w_idx(r, c)), ok ? wg + (size_t)r * p.N + c : (const void*)wq,
                      ok ? 4 : 0);
        }
    }
    for (int i = t; i < XR * (BK / 8); i += BN) {
        const int m = i / (BK / 8), c = i % (BK / 8), k = k0 + 8 * c;
        const bool ok = m < p.M && k < k_end;
        cp_async16(smem_u32(xs + m * BK + 8 * x_chunk(m, c)),
                   ok ? p.x + (size_t)m * p.K + k : (const void*)p.x, ok ? 16 : 0);
    }
    const int g0 = k0 / p.gs, gv = min(p.mrows, (k_end - 1) / p.gs - g0 + 1);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
        if constexpr (M3)
            if (!(a ? m.has_z : m.has_s)) continue;  // a constant of the mode 1-3 form
        const bf16* src = (a ? ze : sc) + (size_t)g0 * p.N + n0;
        bf16* dst = reinterpret_cast<bf16*>(st + words_bytes(BITS) + x_bytes(NT) +
                                            a * meta_bytes(p.mrows));
        if (p.mvec == 2) {                   // odd N: plain 2-byte loads
            for (int i = t; i < p.mrows * BN; i += BN) {
                const int r = i / BN, c = i % BN;
                dst[i] = r < gv && n0 + c < p.N ? src[(size_t)r * p.N + c] : __ushort_as_bfloat16(0);
            }
        } else {
            const int e = p.mvec / 2;        // bf16 values a piece
            for (int i = t; i < p.mrows * (BN / e); i += BN) {
                const int r = i / (BN / e), c = (i % (BN / e)) * e;
                const bool ok = r < gv && n0 + c < p.N;
                const void* s = ok ? (const void*)(src + (size_t)r * p.N + c)
                                   : (const void*)(M3 ? (a ? ze : sc) : sc);
                if (e == 8) cp_async16(smem_u32(dst + r * BN + c), s, ok ? 16 : 0);
                else cp_async4(smem_u32(dst + r * BN + c), s, ok ? 4 : 0);
            }
        }
    }
}

// The products of one stage for one warp: columns wn0 + 16 i + (0..15) of the
// block, row tiles jj < nt. acc[i][jj][r] is the m16n8 fragment: r = 0, 1 at
// column g, rows 8 jj + 2 t + 0, 1; r = 2, 3 the same rows at column g + 8.
// Lane (g, t) takes codes 0..7 of k0 + 8t .. k0 + 8t + 7 and pairs code e
// with code e + 4 (one shift and one mask put both beside 0x4300): pair e
// feeds mma e / 2, its low-k registers for even e, its high-k ones for odd
// e, so element (j, f) of a lane's fragments (f = 0..3: logical k 2t, 2t + 1,
// 2t + 8, 2t + 9) is code 2j + f / 2 + 4 (f % 2); x is paired to match.
// M3: the mode 1-3 dequantization, z2 holding -z and nz2 the constant -z of
// a layer without a zero row.
template <int NT, int BITS, bool M3>
__device__ __forceinline__ void compute_stage(const Params& p, const Modes& m,
                                              const unsigned char* st, int k0, int k_end, int nt,
                                              int wn0, int lane, uint32_t nz2,
                                              float (&acc)[2][NT][4]) {
    constexpr int EPW = 32 / BITS;
    constexpr uint32_t MASK2 = ((1u << BITS) - 1u) * 0x00010001u;
    const uint32_t* ws = reinterpret_cast<const uint32_t*>(st);
    const bf16* xs = reinterpret_cast<const bf16*>(st + words_bytes(BITS));
    const uint16_t* ss = reinterpret_cast<const uint16_t*>(st + words_bytes(BITS) + x_bytes(NT));
    const uint16_t* zs = ss + p.mrows * BN;
    const int g = lane >> 2, t = lane & 3;
    uint32_t s2[2][2], z2[2][2], m2[2][2];               // [m16 tile i][column g, g + 8]
#pragma unroll
    for (int kb = 0; kb < BK / 32; ++kb) {
        const int kl = 32 * kb + 8 * t;                  // this lane's first k in the stage
        if (k0 + 32 * kb >= k_end) break;
        if (kb == 0 || p.mrows > 1) {                    // one group row a stage: read it once
            const int gr = p.mrows == 1 ? 0 : (k0 + kl) / p.gs - k0 / p.gs;
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int c = wn0 + 16 * i + 8 * h + g;
                    if constexpr (M3) {
                        s2[i][h] = m.has_s ? ss[gr * BN + c] * 0x00010001u : 0x3F803F80u;
                        z2[i][h] = m.has_z ? (zs[gr * BN + c] ^ 0x8000u) * 0x00010001u : nz2;
                    } else {
                        s2[i][h] = ss[gr * BN + c] * 0x00010001u;
                        z2[i][h] = zs[gr * BN + c] * 0x00010001u;
                        m2[i][h] = minus128(s2[i][h]);
                    }
                }
        }
        const int r = kl / EPW, shift = BITS * (kl % EPW);
        uint32_t a[2][2][4];                             // [mma j][m16 tile i][register]
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                uint32_t u = ws[w_idx(r, wn0 + 16 * i + 8 * h + g)] >> shift;
                // code e at bit BITS e and code e + 4 at bit BITS e + 16
                if constexpr (BITS == 2) u = (u & 0xFFu) | ((u & 0xFF00u) << 8);
                if constexpr (BITS == 1) u = (u & 0xFu) | ((u & 0xF0u) << 12);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const uint32_t v = ((u >> (BITS * e)) & MASK2) | 0x43004300u;   // 128 + q
                    if constexpr (M3)
                        a[e >> 1][i][2 * (e & 1) + h] = dequant_pair_shift(v, s2[i][h], z2[i][h]);
                    else
                        a[e >> 1][i][2 * (e & 1) + h] = dequant_pair(v, s2[i][h], m2[i][h], z2[i][h]);
                }
            }
#pragma unroll
        for (int jj = 0; jj < NT; ++jj) {
            if (jj >= nt) break;
            const int m = 8 * jj + g;
            const uint4 xv = *reinterpret_cast<const uint4*>(xs + m * BK + 8 * x_chunk(m, 4 * kb + t));
            // (x[8t + 2j], x[8t + 2j + 4]) and (x[8t + 2j + 1], x[8t + 2j + 5])
            const uint32_t b00 = __byte_perm(xv.x, xv.z, 0x5410), b01 = __byte_perm(xv.x, xv.z, 0x7632);
            const uint32_t b10 = __byte_perm(xv.y, xv.w, 0x5410), b11 = __byte_perm(xv.y, xv.w, 0x7632);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                mma_bf16(acc[i][jj], a[0][i], b00, b01);
                mma_bf16(acc[i][jj], a[1][i], b10, b11);
            }
        }
    }
}

// The block's sums, staged in shared memory as tile[m][BN]: into the output,
// or with K split the block's partial, and the last block of the column
// tile adds the partials in split order and leaves its counter at 0. Four
// columns a thread where rows allow, and eight splits' loads in flight
// before they are added. M3: the channel-scale epilogue of the mode 1-3
// form on the finished sums (md points at its kernel argument).
template <bool M3>
__device__ __forceinline__ void finish_body(const Params& p, const Modes* md, const float* tile,
                                            int* flag, int layer) {
    const int n0 = blockIdx.x * BN, split = blockIdx.y, nsplit = gridDim.y;
    const size_t MN = (size_t)p.M * p.N;
    const int V = p.N % 4 == 0 ? 4 : 1;
    if (nsplit > 1) {
        for (int e = threadIdx.x * V; e < p.M * BN; e += blockDim.x * V) {
            const int m = e / BN, n = n0 + e % BN;
            if (n >= p.N) continue;
            float* dst = p.part + split * MN + (size_t)m * p.N + n;
            if (V == 4) *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(tile + e);
            else *dst = tile[e];
        }
        __threadfence();
        __syncthreads();
        if (threadIdx.x == 0) *flag = atomicAdd(p.counters + blockIdx.x, 1) == nsplit - 1;
        __syncthreads();
        if (!*flag) return;
        __threadfence();
    }
    for (int e = threadIdx.x * V; e < p.M * BN; e += blockDim.x * V) {
        const int m = e / BN, n = n0 + e % BN;
        if (n >= p.N) continue;
        const size_t idx = (size_t)m * p.N + n;
        float v[4] = {tile[e], 0.f, 0.f, 0.f};
        if (V == 4) {
            const float4 tv = *reinterpret_cast<const float4*>(tile + e);
            v[0] = tv.x, v[1] = tv.y, v[2] = tv.z, v[3] = tv.w;
        }
        if (nsplit > 1) {
            v[0] = v[1] = v[2] = v[3] = 0.f;
            for (int s0 = 0; s0 < nsplit; s0 += 8) {
                float4 r[8];
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const float* src = p.part + (s0 + j) * MN + idx;
                    if (s0 + j >= nsplit) r[j] = make_float4(0.f, 0.f, 0.f, 0.f);
                    else if (V == 4) r[j] = __ldcg(reinterpret_cast<const float4*>(src));
                    else r[j] = make_float4(__ldcg(src), 0.f, 0.f, 0.f);
                }
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
        if constexpr (M3) {
            // the stacked entry's layer of the (L, N) channel scales
            const void* cs = md->cs == nullptr ? nullptr
                                               : static_cast<const char*>(md->cs) +
                                                     (size_t)layer * p.N * (md->cs_code == gl::kF32 ? 4 : 2);
#pragma unroll
            for (int i = 0; i < 4; ++i)
                if (i < V)
                    v[i] = gl::channel_scale(v[i], md->csm, cs, md->cs_code, md->sx, m, n + i);
        }
        if (V == 4) {
            const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
            const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
            uint2 pk;
            pk.x = *reinterpret_cast<const uint32_t*>(&lo);
            pk.y = *reinterpret_cast<const uint32_t*>(&hi);
            *reinterpret_cast<uint2*>(p.out + idx) = pk;
        } else {
            p.out[idx] = __float2bfloat16_rn(v[0]);
        }
    }
    if (nsplit > 1 && threadIdx.x == 0) p.counters[blockIdx.x] = 0;
}

// Not inlined: one copy serves every instance of a form.
__device__ __noinline__ void finish(const Params p, const float* tile, int* flag) {
    finish_body<false>(p, nullptr, tile, flag, 0);
}

__device__ __noinline__ void finish_modes(const Params p, const Modes* md, const float* tile,
                                          int* flag, int layer) {
    finish_body<true>(p, md, tile, flag, layer);
}

template <int NT, int BITS, bool M3>
__device__ __forceinline__ void decode_body(const Params& p, const Modes& md, const uint32_t* wq,
                                            const bf16* sc, const bf16* ze, int layer = 0) {
    extern __shared__ __align__(128) unsigned char smem[];
    __shared__ int last_flag;
    const int S = p.stages, SB = stage_bytes(BITS, NT, p.mrows);
    const int lane = threadIdx.x & 31, wn0 = (threadIdx.x >> 5) * 32;
    const int g = lane >> 2, t = lane & 3;
    const int n0 = blockIdx.x * BN, split = blockIdx.y;
    const int k_begin = split * p.k_per_split, k_end = min(p.K, k_begin + p.k_per_split);
    const int steps = (k_end - k_begin + BK - 1) / BK;
    const int nt = (p.M + 7) / 8;
    const uint32_t nz2 = M3 ? neg_zero2(md.zscalar) : 0u;

    float acc[2][NT][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

    for (int s = 0; s < S - 1; ++s) {
        if (s < steps)
            load_stage<NT, BITS, M3>(p, md, wq, sc, ze, smem + s * SB, n0, k_begin + s * BK, k_end);
        cp_async_commit();
    }
    for (int it = 0; it < steps; ++it) {
        // stage it has landed; every warp is done with stage it - 1
        cp_async_wait_n(S - 2);
        __syncthreads();
        const int nxt = it + S - 1;
        if (nxt < steps)
            load_stage<NT, BITS, M3>(p, md, wq, sc, ze, smem + (nxt % S) * SB, n0,
                                     k_begin + nxt * BK, k_end);
        cp_async_commit();
        compute_stage<NT, BITS, M3>(p, md, smem + (it % S) * SB, k_begin + it * BK, k_end, nt,
                                    wn0, lane, nz2, acc);
    }
    cp_async_wait_n(0);
    __syncthreads();                                     // the ring is free
    float* tile = reinterpret_cast<float*>(smem);        // [M][BN]
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jj = 0; jj < NT; ++jj) {
            if (jj >= nt) break;
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int m = 8 * jj + 2 * t + (r & 1);
                if (m < p.M) tile[m * BN + wn0 + 16 * i + g + 8 * (r >> 1)] = acc[i][jj][r];
            }
        }
    __syncthreads();
    if constexpr (M3) finish_modes(p, &md, tile, &last_flag, layer);
    else finish(p, tile, &last_flag);
}

template <int NT, int BITS>
__global__ void __launch_bounds__(BN, kMinBlocks) decode_mma_kernel(Params p) {
    decode_body<NT, BITS, false>(p, Modes{}, p.wq, p.scales, p.zeros);
}

// the mode 1-3 form: md a grid constant, so finish_modes reads it in place
template <int NT, int BITS>
__global__ void __launch_bounds__(BN, kMinBlocks)
decode_modes_kernel(Params p, const __grid_constant__ Modes md) {
    decode_body<NT, BITS, true>(p, md, p.wq, p.scales, p.zeros);
}

// wq (L, K / epw, N), scales and zeros (L, K / gs, N); *layer_idx in [0, L).
// Offsets are size_t: a 32-layer stack of 14336 x 4096 W4 weights is 940 MB.
template <int NT, int BITS>
__global__ void __launch_bounds__(BN, kMinBlocks) decode_mma_stacked_kernel(Params p) {
    const int l = __ldg(p.layer_idx);                    // the same 4 bytes for every thread
    if (l < 0 || l >= p.L) __trap();                     // the caller's index is out of the stack
    const size_t words = (size_t)(p.K / (32 / BITS)) * p.N, groups = (size_t)(p.K / p.gs) * p.N;
    decode_body<NT, BITS, false>(p, Modes{}, p.wq + l * words, p.scales + l * groups,
                                 p.zeros + l * groups);
}

// layer *layer_idx of the stacks in the mode 1-3 form: the words, and the
// group scales and zeros where the layer has them, as decode_mma_stacked_kernel
// offsets them; the channel scales (L, N) in finish_modes
template <int NT, int BITS>
__global__ void __launch_bounds__(BN, kMinBlocks)
decode_modes_stacked_kernel(Params p, const __grid_constant__ Modes md) {
    const int l = __ldg(p.layer_idx);
    if (l < 0 || l >= p.L) __trap();
    const size_t words = (size_t)(p.K / (32 / BITS)) * p.N, groups = (size_t)(p.K / p.gs) * p.N;
    decode_body<NT, BITS, true>(p, md, p.wq + l * words, md.has_s ? p.scales + l * groups : nullptr,
                                md.has_z ? p.zeros + l * groups : nullptr, l);
}

__host__ int smem_bytes(int bits, int nt, int mrows, int stages, int M) {
    const int ring = stages * stage_bytes(bits, nt, mrows), tile = M * BN * 4;
    return ring > tile ? ring : tile;
}

template <int NT, int BITS, bool M3>
cudaError_t launch(const Params& p, const Modes& md, int splits, cudaStream_t stream) {
    static std::atomic<unsigned> ready{0};               // a bit per device: attributes set
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (!(ready.load() & (1u << dev))) {
        if constexpr (M3) {
            err = cudaFuncSetAttribute(decode_modes_kernel<NT, BITS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
            if (err == cudaSuccess)
                err = cudaFuncSetAttribute(decode_modes_stacked_kernel<NT, BITS>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
        } else {
            err = cudaFuncSetAttribute(decode_mma_kernel<NT, BITS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
            if (err == cudaSuccess)
                err = cudaFuncSetAttribute(decode_mma_stacked_kernel<NT, BITS>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
        }
        if (err != cudaSuccess) return err;
        ready.fetch_or(1u << dev);
    }
    const int bytes = smem_bytes(BITS, NT, p.mrows, p.stages, p.M);
    if (bytes > kSmemMax) return cudaErrorInvalidValue;
    const dim3 grid((p.N + BN - 1) / BN, splits);
    if constexpr (M3) {
        if (p.layer_idx) decode_modes_stacked_kernel<NT, BITS><<<grid, BN, bytes, stream>>>(p, md);
        else decode_modes_kernel<NT, BITS><<<grid, BN, bytes, stream>>>(p, md);
    } else {
        if (p.layer_idx) decode_mma_stacked_kernel<NT, BITS><<<grid, BN, bytes, stream>>>(p);
        else decode_mma_kernel<NT, BITS><<<grid, BN, bytes, stream>>>(p);
    }
    return cudaGetLastError();
}

template <int BITS, bool M3>
cudaError_t launch_rows(const Params& p, const Modes& md, int splits, cudaStream_t stream) {
    if (p.M <= 8) return launch<1, BITS, M3>(p, md, splits, stream);
    if (p.M <= 16) return launch<2, BITS, M3>(p, md, splits, stream);
    if (p.M <= 32) return launch<4, BITS, M3>(p, md, splits, stream);
    return launch<8, BITS, M3>(p, md, splits, stream);
}

// group rows that one 128-deep stage can touch: the least mrows the ring may
// hold (ops/decode.plan chooses the ring; this only checks it)
int groups_per_stage(int gs) {
    if (gs % BK == 0) return 1;
    return BK % gs == 0 ? BK / gs : BK / gs + 2;
}

template <bool M3>
int run(Params p, const Modes& md, int bits, int splits, cudaStream_t stream) {
    const int epw = bits > 0 ? 32 / bits : 0;
    const bool shape_ok = p.M >= 1 && p.M <= 64 && p.N >= 1 && (bits == 1 || bits == 2 || bits == 4) &&
                          p.gs > 0 && p.gs % (epw > 8 ? epw : 8) == 0 && p.K % p.gs == 0;
    // a split starts on a group row; one group (gs = K) has the same row everywhere
    const bool one_group = p.gs == p.K;
    const bool split_ok = splits >= 1 && p.k_per_split > 0 &&
                          (p.k_per_split % p.gs == 0 || one_group) &&
                          (splits == 1 || p.k_per_split % BK == 0) &&
                          (long long)(splits - 1) * p.k_per_split < p.K &&
                          (long long)splits * p.k_per_split >= p.K &&
                          (splits == 1 || (p.part != nullptr && p.counters != nullptr));
    if (!shape_ok || !split_ok || p.stages < 2 || p.stages > kMaxStages ||
        p.mrows < (one_group ? 1 : groups_per_stage(p.gs)) || reinterpret_cast<uintptr_t>(p.x) % 16)
        return static_cast<int>(cudaErrorInvalidValue);
    // 16-byte pieces need 16-byte rows and bases (every layer of a stack too)
    p.wvec = p.N % 4 == 0 && reinterpret_cast<uintptr_t>(p.wq) % 16 == 0 ? 16 : 4;
    const uintptr_t meta_base = reinterpret_cast<uintptr_t>(p.scales) | reinterpret_cast<uintptr_t>(p.zeros);
    p.mvec = p.N % 8 == 0 && meta_base % 16 == 0 ? 16 : (p.N % 2 == 0 && meta_base % 4 == 0 ? 4 : 2);
    cudaError_t err;
    if (bits == 4) err = launch_rows<4, M3>(p, md, splits, stream);
    else if (bits == 2) err = launch_rows<2, M3>(p, md, splits, stream);
    else err = launch_rows<1, M3>(p, md, splits, stream);
    return static_cast<int>(err);
}

}  // namespace

// Launch on `stream`. `bits` is 1, 2 or 4. K is cut into `splits` ranges of
// `k_per_split` (none empty); with splits > 1 the call needs `part`, (splits,
// M, N) floats, and `counters`, one int32 per column tile, all 0, which the
// kernel leaves 0. `stages` and `mrows` come from ops/decode.plan. Returns
// the cudaError_t of the launch (0 on success).
extern "C" int gl_decode(const void* x, const void* wq, const void* scales, const void* zeros,
                         void* part, void* counters, void* out, int M, int N, int K, int gs,
                         int bits, int splits, int k_per_split, int stages, int mrows,
                         void* stream_ptr) {
    const Params p{static_cast<const bf16*>(x), static_cast<const uint32_t*>(wq),
                   static_cast<const bf16*>(scales), static_cast<const bf16*>(zeros), nullptr, 1,
                   static_cast<bf16*>(out), static_cast<float*>(part), static_cast<int*>(counters),
                   M, N, K, gs, k_per_split, stages, mrows, 0, 0};
    return run<false>(p, Modes{}, bits, splits, static_cast<cudaStream_t>(stream_ptr));
}

// The same for layer *layer_idx (a device pointer to one int32) of the
// L-layer stacks wq (L, K / epw, N), scales and zeros (L, K / gs, N).
extern "C" int gl_decode_stacked(const void* x, const void* wq, const void* scales,
                                 const void* zeros, const void* layer_idx, void* part,
                                 void* counters, void* out, int L, int M, int N, int K, int gs,
                                 int bits, int splits, int k_per_split, int stages, int mrows,
                                 void* stream_ptr) {
    if (layer_idx == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const Params p{static_cast<const bf16*>(x), static_cast<const uint32_t*>(wq),
                   static_cast<const bf16*>(scales), static_cast<const bf16*>(zeros),
                   static_cast<const int*>(layer_idx), L, static_cast<bf16*>(out),
                   static_cast<float*>(part), static_cast<int*>(counters),
                   M, N, K, gs, k_per_split, stages, mrows, 0, 0};
    return run<false>(p, Modes{}, bits, splits, static_cast<cudaStream_t>(stream_ptr));
}

// One layer in W_group_mode 1, 2 or 3 with csm 0-3, as gl_decode otherwise.
// `scales` (K / gs, N) bf16 group scales or null (scale 1); `zeros` (K / gs,
// N) bf16 zeros z (not folded) or null; `zscalar` one int32 zero on the
// device or null (no zero row: z = the scalar, or 0); `sx` (M) float32
// per-token scales for csm 2 / 3 and `cs` (N) channel scales for csm 1 / 3,
// float32 (code 0) or bf16 (code 2). gs = K (channel-wise) takes any split.
extern "C" int gl_decode_modes(const void* x, const void* wq, const void* scales,
                               const void* zeros, const void* zscalar, const void* sx,
                               const void* cs, void* part, void* counters, void* out, int M, int N,
                               int K, int gs, int bits, int splits, int k_per_split, int stages,
                               int mrows, int csm, int cs_code, void* stream_ptr) {
    const bool codes_ok = cs_code == gl::kF32 || cs_code == gl::kBF16;
    if (csm < 0 || csm > 3 || !codes_ok || ((csm & 2) && sx == nullptr) ||
        ((csm & 1) && cs == nullptr) || (zeros != nullptr && zscalar != nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const Params p{static_cast<const bf16*>(x), static_cast<const uint32_t*>(wq),
                   static_cast<const bf16*>(scales), static_cast<const bf16*>(zeros), nullptr, 1,
                   static_cast<bf16*>(out), static_cast<float*>(part), static_cast<int*>(counters),
                   M, N, K, gs, k_per_split, stages, mrows, 0, 0};
    const Modes md{scales != nullptr, zeros != nullptr, static_cast<const int*>(zscalar),
                   static_cast<const float*>(sx), cs, csm, cs_code};
    return run<true>(p, md, bits, splits, static_cast<cudaStream_t>(stream_ptr));
}

// Layer *layer_idx (a device pointer to one int32) of L layers in W_group_mode
// 1, 2 or 3 with csm 0 or 1, as gl_decode_modes otherwise: wq (L, K / epw,
// N); `scales` and `zeros` (L, K / gs, N) bf16 or null; `cs` (L, N) channel
// scales for csm 1, float32 (code 0) or bf16 (code 2). No scalar zero and no
// per-token scales: the stacked gate refuses both.
extern "C" int gl_decode_modes_stacked(const void* x, const void* wq, const void* scales,
                                       const void* zeros, const void* cs, const void* layer_idx,
                                       void* part, void* counters, void* out, int L, int M, int N,
                                       int K, int gs, int bits, int splits, int k_per_split,
                                       int stages, int mrows, int csm, int cs_code,
                                       void* stream_ptr) {
    const bool codes_ok = cs_code == gl::kF32 || cs_code == gl::kBF16;
    if (layer_idx == nullptr || L < 1 || (csm != 0 && csm != 1) || !codes_ok ||
        (csm == 1 && cs == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const Params p{static_cast<const bf16*>(x), static_cast<const uint32_t*>(wq),
                   static_cast<const bf16*>(scales), static_cast<const bf16*>(zeros),
                   static_cast<const int*>(layer_idx), L, static_cast<bf16*>(out),
                   static_cast<float*>(part), static_cast<int*>(counters),
                   M, N, K, gs, k_per_split, stages, mrows, 0, 0};
    const Modes md{scales != nullptr, zeros != nullptr, nullptr, nullptr, csm == 1 ? cs : nullptr,
                   csm, cs_code};
    return run<true>(p, md, bits, splits, static_cast<cudaStream_t>(stream_ptr));
}
