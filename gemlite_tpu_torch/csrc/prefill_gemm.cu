// SPDX-License-Identifier: Apache-2.0
// W1/W2/W4 prefill for 64 < M < 4096, for Hopper: out (M, N) bf16 =
// x (M, K) bf16 . dequant(W_q), float32 sums on the bf16 tensor cores,
// W_group_mode 4 with bf16 (K / gs, N) group scales and pre-folded zeros,
// one launch a call (gl_prefill); or W_group_mode 1, 2 or 3 with a
// channel-scale epilogue (gl_prefill_modes).
//
// Replaces the TPU kernel gemlite_tpu/ops/pallas_prefill.py:pallas_prefill_matmul
// on the bf16 layers of W1, W2 and W4 codes which the JAX router sends to
// it: mode 4, and in the mode 1-3 form the A8Wn layers (fp8 x comes in as
// its bf16 image, exact), channel-wise A16Wn and BitNet. The mode 1-3
// instances (template flag M3) build w = (q - z) * s in three bf16x2 fmas a
// code pair, rounded as the plain version rounds, from a scale row (or 1)
// and a zero row (or the scalar zero, or 0), and multiply the finished
// float32 sums by the per-token and channel scales (csm 1-3); a channel-wise
// layer (gs = K) reads its one metadata row in every stage.
//
// What bounds it: operations. From M = 128 on, a 4-bit weight byte feeds
// 4 M flops, above the card's ~295 flops per byte, so the bound is 2 M N K
// flops over the bf16 tensor-core rate (M 128, 14336 x 4096: 15.2 us). The
// design keeps the tensor cores fed and dequantizes beside them:
//   * the operands are swapped, out^T = W^T . x^T: A is a 64-column x 16-k
//     tile of dequantized W built in registers and fed to wgmma.mma_async in
//     its register form (m64n128k16 bf16, float32 sums); B is the x tile as
//     stored (K-major), brought by TMA in the 128-byte swizzle, rows past M
//     read as zeros. The dequantized weights never go to shared memory, and
//     each A fragment serves the block's 128 or 256 rows of x (one or two
//     n128 products);
//   * k stays in natural order inside each 16-deep step, so x is used as it
//     lands: lane (g, t) of warp w takes codes k0 + 2t, 2t + 1 and k0 + 8 +
//     2t, 9 + 2t of columns 16w + g and 16w + g + 8 (the mma.sync A fragment,
//     which wgmma's register A repeats in each warp): for W4 byte t of two
//     words, for W2 and W1 neighbouring bits of one. Each pair becomes the
//     bf16x2 128 + q by a byte permute (W4) or two shifts (W2, W1) and one
//     mask, then two bf16x2 fmas that round as the plain version rounds
//     (w4_common.cuh);
//   * 384 threads: two consumer warpgroups of 64 weight columns each (128 a
//     block) and a producer warpgroup, of which one warp works; setmaxnreg
//     moves registers to the consumers. The producer's one lane fills a ring
//     of 2-6 stages of 64 k by TMA: the x box, the word rows and the stage's
//     group row of scales and zeros, all completing one full mbarrier a
//     stage (where N is no multiple of 8 the words and metadata come by
//     cp.async from the warp's lanes: 16- or 4-byte pieces, 2-byte loads for
//     odd N). Words by cp.async from one warp were the slowest part of the
//     copies (scripts/torch_prefill_variants.py, PERF.md);
//   * a consumer queues stage j + 1's products behind stage j's before it
//     waits for stage j (wgmma.wait_group 1), releases stage j (one arrival
//     a warp on its empty mbarrier), and builds stage j + 2's A fragments
//     while stage j + 1's products run, into the buffer stage j freed: two
//     pinned register buffers;
//   * the grid is column tiles x row tiles (BM 128 or 256) x K splits, from
//     ops/prefill.plan. The splits meet in the same launch: each writes its
//     float32 partial, the last block of a tile adds them in split order and
//     leaves its counter at 0 (ops/build.split_state). One launch a call, no
//     allocation but the output;
//   * the epilogue turns the accumulators (out^T) through a padded float32
//     tile in shared memory and stores bf16 rows of out, 16 bytes a thread.
#include "gl_common.cuh"
#include "sm90_common.cuh"
#include "w4_common.cuh"

namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int BK = 64;                        // K per ring stage: one 128-byte swizzle row of x
constexpr int BN = 128;                       // weight columns per block
constexpr int kConsumers = 256;               // two warpgroups of 64 columns
constexpr int kThreads = kConsumers + 128;    // and one producer warpgroup
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
constexpr int kMaxStages = 6;
constexpr int kSmemMax = 227 * 1024;
constexpr int kTileStride = BN + 4;           // floats a row of the epilogue tile (conflict-free)
constexpr int kFullArrivals = 1 + 2 * 32;     // the TMA lane's, and each producer lane's two
constexpr int kMetaBytes = 2 * BN * 2;        // a stage's scale and zero rows

struct Params {
    const uint32_t* wq;                       // (K / epw, N)
    const bf16* scales;                       // (K / gs, N)
    const bf16* zeros;                        // (K / gs, N), -z * s
    bf16* out;                                // (M, N)
    float* part;                              // (splits, M, N) float32 partials
    int* counters;                            // one per output tile, 0 between calls
    int M, N, K, gs, k_per_split, stages;
    int tma_wm;                               // words and metadata by TMA (N % 8 == 0), else:
    int wvec, mvec;                           // cp.async piece sizes of words (16, 4) and metadata (4, 2)
};

// The TMA maps: x (M, K) bf16 in the 128-byte swizzle; with tma_wm the words
// (K / epw, N) int32 and the scales and zeros (K / gs, N) bf16, unswizzled.
struct Maps {
    CUtensorMap x, w, s, z;
};

__host__ __device__ constexpr int x_bytes(int nb) { return nb * 128 * BK * 2; }
__host__ __device__ constexpr int words_bytes(int bits) { return BK * bits / 32 * BN * 4; }

// Shared memory from a 1024-byte aligned base: the x ring, the word ring,
// the metadata ring; the epilogue tile over them once they are free; then
// the mbarriers (full, then empty, one a stage) and the last-block flag.
// ops/prefill.smem_bytes mirrors `bytes`.
struct Layout {
    int w, m, bars, flag, bytes;
    __host__ __device__ Layout(int bits, int nb, int stages) {
        w = stages * x_bytes(nb);
        m = w + stages * words_bytes(bits);
        const int ring = m + stages * kMetaBytes, tile = nb * 128 * kTileStride * 4;
        bars = ring > tile ? ring : tile;
        flag = bars + 16 * stages;
        bytes = flag + 16 + 1024;            // slack to align the base
    }
};

// The stage's word rows: (64 / epw, 128) int32 from row k0 / epw, column n0
// (16- or 4-byte pieces; zeros past N).
template <int BITS>
__device__ __forceinline__ void load_words(const Params& p, uint32_t dst, int n0, int k0,
                                           int lane) {
    constexpr int EPW = 32 / BITS, WR = BK / EPW;
    const uint32_t* src = p.wq + (size_t)(k0 / EPW) * p.N + n0;
    if (p.wvec == 16) {
        for (int i = lane; i < WR * (BN / 4); i += 32) {
            const int r = i / (BN / 4), c = i % (BN / 4) * 4;
            const bool ok = n0 + c < p.N;
            gl::cp_async16(dst + (r * BN + c) * 4, ok ? src + (size_t)r * p.N + c : (const void*)p.wq,
                           ok ? 16 : 0);
        }
    } else {
        for (int i = lane; i < WR * BN; i += 32) {
            const int r = i / BN, c = i % BN;
            const bool ok = n0 + c < p.N;
            gl::cp_async4(dst + (r * BN + c) * 4, ok ? src + (size_t)r * p.N + c : (const void*)p.wq,
                          ok ? 4 : 0);
        }
    }
}

// The stage's group row of scales, then of zeros (128 bf16 each): 4-byte
// pieces, or plain 2-byte loads for odd N; zeros past N.
template <bool M3>
__device__ __forceinline__ void load_meta(const Params& p, const Modes& md, uint8_t* g,
                                          uint32_t base, int moff, int n0, int k0, int lane) {
    const size_t g0 = (size_t)(k0 / p.gs) * p.N + n0;
    if (p.mvec == 2) {
        uint16_t* dst = reinterpret_cast<uint16_t*>(g + moff);
        for (int i = lane; i < 2 * BN; i += 32) {
            const int a = i / BN, c = i % BN;
            if constexpr (M3)
                if (!(a ? md.has_z : md.has_s)) continue;   // a constant of the mode 1-3 form
            const bf16* src = (a ? p.zeros : p.scales) + g0 + c;
            dst[i] = n0 + c < p.N ? __bfloat16_as_ushort(*src) : 0;
        }
    } else {
        for (int i = lane; i < BN; i += 32) {      // 2 rows of 64 pairs
            const int a = i / (BN / 2), c = i % (BN / 2) * 2;
            if constexpr (M3)
                if (!(a ? md.has_z : md.has_s)) continue;
            const bool ok = n0 + c < p.N;
            const void* src = ok ? (const void*)((a ? p.zeros : p.scales) + g0 + c)
                                 : (const void*)(M3 ? (a ? p.zeros : p.scales) : p.scales);
            gl::cp_async4(base + moff + (a * BN + c) * 2, src, ok ? 4 : 0);
        }
    }
}

// The producer warp: per stage, the x box, the word rows and the group row
// of scales and zeros, by TMA (or, where N is no multiple of 8, the words and
// metadata by cp.async), all on the stage's full mbarrier.
template <int BITS, bool M3, int NB>
__device__ __forceinline__ void produce(const Maps& maps, const Params& p, const Modes& md,
                                        uint8_t* g, uint32_t base, const Layout& L, int n0, int m0,
                                        int k_begin, int steps) {
    constexpr int EPW = 32 / BITS;
    const int lane = threadIdx.x % 32, S = p.stages;
    const uint32_t meta = M3 ? (md.has_s + md.has_z) * BN * 2 : kMetaBytes;
    const uint32_t bytes = x_bytes(NB) + (p.tma_wm ? words_bytes(BITS) + meta : 0);
    const uint32_t bars = base + L.bars;
    for (int it = 0; it < steps; ++it) {
        const int st = it % S, k0 = k_begin + it * BK;
        const uint32_t full = bar_addr(bars, st);
        if (it >= S) mbar_wait(bar_addr(bars, S + st), ((it / S) & 1) ^ 1);
        const uint32_t wdst = base + L.w + st * words_bytes(BITS), moff = L.m + st * kMetaBytes;
        if (lane == 0) {
            mbar_expect_tx(full, bytes);
            tma_load_2d(base + st * x_bytes(NB), &maps.x, full, k0, m0);
            if (p.tma_wm) {
                tma_load_2d(wdst, &maps.w, full, n0, k0 / EPW);
                if (!M3 || md.has_s) tma_load_2d(base + moff, &maps.s, full, n0, k0 / p.gs);
                if (!M3 || md.has_z) tma_load_2d(base + moff + BN * 2, &maps.z, full, n0, k0 / p.gs);
            }
        }
        if (!p.tma_wm) {
            load_words<BITS>(p, wdst, n0, k0, lane);
            load_meta<M3>(p, md, g, base, moff, n0, k0, lane);
        }
        mbar_arrive_cp_async(full);           // when this lane's copies have landed
        mbar_arrive(full);                    // its plain stores, released
    }
    gl::cp_async_wait<0>();
}

// The bf16x2 128 + q of the codes at k and k + 1 of a word: for W4 byte t
// (sel = t | (t + 4) << 8 takes it from w and from w >> 4), for W2 and W1
// the 2 BITS bits at `shift`.
template <int BITS>
__device__ __forceinline__ uint32_t code_pair(uint32_t w, int shift, uint32_t sel) {
    if constexpr (BITS == 4) {
        return (__byte_perm(w, w >> 4, sel) & 0x000F000Fu) | 0x43004300u;
    } else {
        constexpr uint32_t M = (1u << BITS) - 1u;
        const uint32_t y = w >> shift;
        return (y & M) | ((y << (16 - BITS)) & (M << 16)) | 0x43004300u;
    }
}

// The A fragments of one stage for this lane: a[kk][r] for the 16-deep step
// kk, register r = 2 half + h at k 16 kk + 8 half + 2t (and + 1) of column
// col + 8 h, dequantized. M3: the mode 1-3 form, `mc` its constants.
struct ModeConsts {
    int has_s, has_z;
    uint32_t nz2;                             // -z of a layer without a zero row
};

template <int BITS, bool M3>
__device__ __forceinline__ void build_stage(uint32_t (&a)[4][4], const uint8_t* g,
                                            const Layout& L, int st, int col, int t,
                                            uint32_t sel, const ModeConsts& mc) {
    constexpr int EPW = 32 / BITS;
    const uint32_t* ws =
        reinterpret_cast<const uint32_t*>(g + L.w + st * words_bytes(BITS)) + col;
    const uint16_t* ms = reinterpret_cast<const uint16_t*>(g + L.m + st * kMetaBytes) + col;
    uint32_t s2[2], z2[2], m2[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        if constexpr (M3) {
            s2[h] = mc.has_s ? ms[8 * h] * 0x00010001u : 0x3F803F80u;
            z2[h] = mc.has_z ? (ms[BN + 8 * h] ^ 0x8000u) * 0x00010001u : mc.nz2;
        } else {
            s2[h] = ms[8 * h] * 0x00010001u;
            z2[h] = ms[BN + 8 * h] * 0x00010001u;
            m2[h] = minus128(s2[h]);
        }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int kl = 16 * kk + 8 * half;            // the step's first k of this half
            const int shift = BITS * (kl % EPW) + 2 * BITS * t;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const uint32_t w = ws[kl / EPW * BN + 8 * h];
                if constexpr (M3)
                    a[kk][2 * half + h] = dequant_pair_shift(code_pair<BITS>(w, shift, sel), s2[h],
                                                             z2[h]);
                else
                    a[kk][2 * half + h] =
                        dequant_pair(code_pair<BITS>(w, shift, sel), s2[h], m2[h], z2[h]);
            }
        }
}

// One stage's products: for each 16-deep step, NB n128 wgmmas over the x
// rows (128 rows of 128 bytes apart), 32 bytes into each swizzle row a step.
// The accumulators are pinned only where no product is in flight (any
// instruction that touches them while one is makes ptxas serialize the
// wgmmas, note C7514); the fragments just built are pinned here.
template <int NB>
__device__ __forceinline__ void issue_stage(float (&acc)[NB][64], uint32_t (&a)[4][4],
                                            uint64_t dx) {
    pin(a);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
            wgmma_rs_n128<0>(acc[nb], a[kk], dx + ((nb * 128 * 128 + kk * 32) >> 4), 1);
    wgmma_commit();
}


// The block's sums, staged as tile[m][kTileStride] for rows m0 .. m0 + bm - 1:
// into the output, or with K split the block's partial, and the last block
// of the tile adds the partials in split order and leaves its counter at 0.
// Consumer threads only. M3: the channel-scale epilogue of the mode 1-3
// form on the finished sums (md points at its kernel argument).
template <bool M3>
__device__ __forceinline__ void finish_body(const Params& p, const Modes* md, const float* tile,
                                            int* flag, int m0, int bm) {
    const int tid = threadIdx.x, n0 = blockIdx.x * BN;
    const int split = blockIdx.z, nsplit = gridDim.z;
    const int ctr = blockIdx.x + gridDim.x * blockIdx.y;
    const int rows = min(bm, p.M - m0);
    const size_t MN = (size_t)p.M * p.N;
    if (nsplit > 1) {
        const int V = p.N % 4 == 0 ? 4 : 1;
        for (int e = tid * V; e < rows * BN; e += kConsumers * V) {
            const int m = e / BN, c = e % BN, n = n0 + c;
            if (n >= p.N) continue;
            float* dst = p.part + split * MN + (size_t)(m0 + m) * p.N + n;
            const float* src = tile + m * kTileStride + c;
            if (V == 4) *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
            else *dst = *src;
        }
        __threadfence();
        named_sync<1, kConsumers>();
        if (tid == 0) *flag = atomicAdd(p.counters + ctr, 1) == nsplit - 1;
        named_sync<1, kConsumers>();
        if (!*flag) return;
        __threadfence();
    }
    const int V = p.N % 8 == 0 ? 8 : 1;
    for (int e = tid * V; e < rows * BN; e += kConsumers * V) {
        const int m = e / BN, c = e % BN, n = n0 + c;
        if (n >= p.N) continue;
        const size_t idx = (size_t)(m0 + m) * p.N + n;
        float v[8];
        if (nsplit == 1) {
#pragma unroll
            for (int i = 0; i < 8; ++i) v[i] = i < V ? tile[m * kTileStride + c + i] : 0.f;
        } else {
#pragma unroll
            for (int i = 0; i < 8; ++i) v[i] = 0.f;
            for (int s0 = 0; s0 < nsplit; s0 += 4) {
                float4 r[4][2];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const float* src = p.part + (s0 + j) * MN + idx;
                    r[j][0] = r[j][1] = make_float4(0.f, 0.f, 0.f, 0.f);
                    if (s0 + j >= nsplit) continue;
                    if (V == 8) {
                        r[j][0] = __ldcg(reinterpret_cast<const float4*>(src));
                        r[j][1] = __ldcg(reinterpret_cast<const float4*>(src + 4));
                    } else {
                        r[j][0].x = __ldcg(src);
                    }
                }
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    if (s0 + j >= nsplit) break;
                    const float q[8] = {r[j][0].x, r[j][0].y, r[j][0].z, r[j][0].w,
                                        r[j][1].x, r[j][1].y, r[j][1].z, r[j][1].w};
#pragma unroll
                    for (int i = 0; i < 8; ++i) v[i] = __fadd_rn(v[i], q[i]);
                }
            }
        }
        if constexpr (M3) {
#pragma unroll
            for (int i = 0; i < 8; ++i)
                if (i < V)
                    v[i] = gl::channel_scale(v[i], md->csm, md->cs, md->cs_code, md->sx, m0 + m,
                                             n + i);
        }
        if (V == 8) {
            uint4 pk;
            uint32_t* w = reinterpret_cast<uint32_t*>(&pk);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
                w[i] = *reinterpret_cast<const uint32_t*>(&b);
            }
            *reinterpret_cast<uint4*>(p.out + idx) = pk;
        } else {
            p.out[idx] = __float2bfloat16_rn(v[0]);
        }
    }
    if (nsplit > 1 && tid == 0) p.counters[ctr] = 0;
}

// Not inlined: one copy serves every instance of a form.
__device__ __noinline__ void finish(const Params p, const float* tile, int* flag, int m0, int bm) {
    finish_body<false>(p, nullptr, tile, flag, m0, bm);
}

__device__ __noinline__ void finish_modes(const Params p, const Modes* md, const float* tile,
                                          int* flag, int m0, int bm) {
    finish_body<true>(p, md, tile, flag, m0, bm);
}

// What a consumer thread needs across the steps of its pipeline.
struct Consumer {
    uint8_t* g;
    uint32_t base, bars;
    const Layout* L;
    int S, col, t, lane;
    uint32_t sel;
    ModeConsts mc;

    __device__ __forceinline__ void full(int it) const {
        mbar_wait(bar_addr(bars, it % S), (it / S) & 1);
    }
    // the stage is free for the producer: one arrival a warp
    __device__ __forceinline__ void release(int it) const {
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_addr(bars, S + it % S));
    }
    template <int NB>
    __device__ __forceinline__ uint64_t x_desc(int it) const {
        return sw128_desc(base + it % S * x_bytes(NB), 16, 1024);
    }
};

// One step of the consumer pipeline: stage j's products are in flight;
// queue stage j + 1's behind them (buffer ISSUE), wait for stage j alone,
// release it, and build stage j + 2's A fragments into stage j's buffer
// while stage j + 1's run. Every call issues: a wgmma under a branch leaves
// ptxas copying in-flight accumulators where the paths meet (note C7514), so
// the tail is unrolled.
template <int BITS, bool M3, int NB, int ISSUE>
__device__ __forceinline__ void pipe_step(const Consumer& c, float (&acc)[NB][64],
                                          uint32_t (&a)[2][4][4], int j, int steps) {
    issue_stage<NB>(acc, a[ISSUE], c.x_desc<NB>(j + 1));
    wgmma_wait<1>();
    pin(a[1 - ISSUE]);
    c.release(j);
    if (j + 2 < steps) {
        c.full(j + 2);
        build_stage<BITS, M3>(a[1 - ISSUE], c.g, *c.L, (j + 2) % c.S, c.col, c.t, c.sel, c.mc);
    }
}

// The consumer warpgroups: 64 weight columns each, all the block's rows.
template <int BITS, bool M3, int NB>
__device__ __forceinline__ void consume(const Params& p, const Modes& md, uint8_t* g,
                                        uint32_t base, const Layout& L, int wg, int m0, int steps,
                                        int* flag) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int lane = threadIdx.x % 32, t = lane % 4;
    const int col = wg * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;   // and col + 8
    const Consumer c{g, base, base + L.bars, &L, p.stages, col, t, lane,
                     static_cast<uint32_t>(t | (t + 4) << 8),
                     {md.has_s, md.has_z, M3 ? neg_zero2(md.zscalar) : 0u}};

    float acc[NB][64];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[nb][i] = 0.f;
    uint32_t a[2][4][4];                      // stage s in buffer s % 2
    c.full(0);
    build_stage<BITS, M3>(a[0], g, L, 0, col, t, c.sel, c.mc);
    issue_stage<NB>(acc, a[0], c.x_desc<NB>(0));
    if (steps > 1) {
        c.full(1);
        build_stage<BITS, M3>(a[1], g, L, 1 % c.S, col, t, c.sel, c.mc);
    }
    int j = 0;
    for (; j + 2 < steps; j += 2) {
        pipe_step<BITS, M3, NB, 1>(c, acc, a, j, steps);
        pipe_step<BITS, M3, NB, 0>(c, acc, a, j + 1, steps);
    }
    if (j + 1 < steps) {                      // the last stage; both paths drain
        pipe_step<BITS, M3, NB, 1>(c, acc, a, j, steps);
        wgmma_wait<0>();
    } else {
        wgmma_wait<0>();
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) pin(acc[nb]);

    named_sync<1, kConsumers>();              // both warpgroups are done with the ring
    float* tile = reinterpret_cast<float*>(g);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int n8 = 0; n8 < 16; ++n8)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                tile[(nb * 128 + 8 * n8 + 2 * t + (e & 1)) * kTileStride + col + 8 * (e >> 1)] =
                    acc[nb][4 * n8 + e];
    named_sync<1, kConsumers>();
    if constexpr (M3) finish_modes(p, &md, tile, flag, m0, NB * 128);
    else finish(p, tile, flag, m0, NB * 128);
}

template <int BITS, bool M3, int NB>
__device__ __forceinline__ void prefill_body(const Maps& maps, const Params& p, const Modes& md) {
    extern __shared__ uint8_t smem_raw[];
    const Layout L(BITS, NB, p.stages);
    const uint32_t base = smem_base(smem_raw), bars = base + L.bars;
    uint8_t* g = smem_raw + (base - smem_addr(smem_raw));
    const int n0 = blockIdx.x * BN, m0 = blockIdx.y * NB * 128;
    const int k_begin = blockIdx.z * p.k_per_split;
    const int steps = (min(p.K, k_begin + p.k_per_split) - k_begin) / BK;
    if (threadIdx.x == 0) {
        for (int s = 0; s < p.stages; ++s) {
            mbar_init(bar_addr(bars, s), kFullArrivals);
            mbar_init(bar_addr(bars, p.stages + s), kConsumers / 32);
        }
        mbar_init_fence();
    }
    __syncthreads();
    const int wg = warpgroup();
    if (wg == 2) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
        if (threadIdx.x < kConsumers + 32)
            produce<BITS, M3, NB>(maps, p, md, g, base, L, n0, m0, k_begin, steps);
    } else {
        consume<BITS, M3, NB>(p, md, g, base, L, wg, m0, steps,
                              reinterpret_cast<int*>(g + L.flag));
    }
}

template <int BITS, int NB>
__global__ void __launch_bounds__(kThreads, 1)
prefill_wgmma_kernel(const __grid_constant__ Maps maps, const Params p) {
    prefill_body<BITS, false, NB>(maps, p, Modes{});
}

// the mode 1-3 form: md a grid constant, so finish_modes reads it in place
template <int BITS, int NB>
__global__ void __launch_bounds__(kThreads, 1)
prefill_modes_kernel(const __grid_constant__ Maps maps, const Params p,
                     const __grid_constant__ Modes md) {
    prefill_body<BITS, true, NB>(maps, p, md);
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

template <int BITS, bool M3, int NB>
cudaError_t launch(const void* x, const Params& p, const Modes& md, int splits,
                   cudaStream_t stream) {
    static std::atomic<unsigned> ready{0};
    const Layout L(BITS, NB, p.stages);
    if (L.bytes > kSmemMax) return cudaErrorInvalidValue;
    Maps maps;
    // x: boxes of 64 k (one 128-byte swizzle row) by the block's rows
    if (!make_map(&maps.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, p.M, p.K, NB * 128, BK,
                  CU_TENSOR_MAP_SWIZZLE_128B))
        return cudaErrorInvalidValue;
    if (p.tma_wm &&
        (!make_map(&maps.w, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, p.wq, p.K * BITS / 32, p.N,
                   BK * BITS / 32, BN, CU_TENSOR_MAP_SWIZZLE_NONE) ||
         ((!M3 || md.has_s) &&
          !make_map(&maps.s, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.scales, p.K / p.gs, p.N, 1, BN,
                    CU_TENSOR_MAP_SWIZZLE_NONE)) ||
         ((!M3 || md.has_z) &&
          !make_map(&maps.z, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.zeros, p.K / p.gs, p.N, 1, BN,
                    CU_TENSOR_MAP_SWIZZLE_NONE))))
        return cudaErrorInvalidValue;
    const dim3 grid((p.N + BN - 1) / BN, (p.M + NB * 128 - 1) / (NB * 128), splits);
    if constexpr (M3) {
        const cudaError_t err = allow_smem(prefill_modes_kernel<BITS, NB>, kSmemMax, ready);
        if (err != cudaSuccess) return err;
        prefill_modes_kernel<BITS, NB><<<grid, kThreads, L.bytes, stream>>>(maps, p, md);
    } else {
        const cudaError_t err = allow_smem(prefill_wgmma_kernel<BITS, NB>, kSmemMax, ready);
        if (err != cudaSuccess) return err;
        prefill_wgmma_kernel<BITS, NB><<<grid, kThreads, L.bytes, stream>>>(maps, p);
    }
    return cudaGetLastError();
}

template <int BITS, bool M3>
cudaError_t launch_rows(const void* x, const Params& p, const Modes& md, int bm, int splits,
                        cudaStream_t stream) {
    return bm == 128 ? launch<BITS, M3, 1>(x, p, md, splits, stream)
                     : launch<BITS, M3, 2>(x, p, md, splits, stream);
}

// The checks and launch both entries share; `p` holds the pointers, with
// tma_wm, wvec and mvec set here.
template <bool M3>
int run(const void* x, Params p, const Modes& md, int bits, int bm, int splits,
        cudaStream_t stream) {
    const int M = p.M, N = p.N, K = p.K, gs = p.gs, k_per_split = p.k_per_split;
    const bool shape_ok = M >= 1 && N >= 1 && K > 0 && K % BK == 0 && gs > 0 && gs % BK == 0 &&
                          K % gs == 0 && (bits == 1 || bits == 2 || bits == 4) &&
                          (bm == 128 || bm == 256);
    const bool split_ok = splits >= 1 && k_per_split > 0 && k_per_split % BK == 0 &&
                          (long long)(splits - 1) * k_per_split < K &&
                          (long long)splits * k_per_split >= K &&
                          (splits == 1 || (p.part != nullptr && p.counters != nullptr));
    if (!shape_ok || !split_ok || p.stages < 2 || p.stages > kMaxStages ||
        reinterpret_cast<uintptr_t>(x) % 16)
        return static_cast<int>(cudaErrorInvalidValue);
    // TMA and 16-byte pieces need 16-byte rows and bases
    const uintptr_t meta_base = reinterpret_cast<uintptr_t>(p.scales) |
                                reinterpret_cast<uintptr_t>(p.zeros);
    const uintptr_t bases = reinterpret_cast<uintptr_t>(p.wq) | meta_base;
    p.tma_wm = N % 8 == 0 && bases % 16 == 0;
    p.wvec = N % 4 == 0 && reinterpret_cast<uintptr_t>(p.wq) % 16 == 0 ? 16 : 4;
    p.mvec = N % 2 == 0 && meta_base % 4 == 0 ? 4 : 2;
    cudaError_t err;
    if (bits == 4) err = launch_rows<4, M3>(x, p, md, bm, splits, stream);
    else if (bits == 2) err = launch_rows<2, M3>(x, p, md, bm, splits, stream);
    else err = launch_rows<1, M3>(x, p, md, bm, splits, stream);
    return static_cast<int>(err);
}

}  // namespace

// Launch on `stream`. `bits` is 1, 2 or 4; gs a multiple of 64 that divides
// K; `bm` (128 or 256) rows of x a block; K cut into `splits` ranges of
// `k_per_split` (a multiple of 64, none empty); with splits > 1 the call
// needs `part`, (splits, M, N) floats, and `counters`, one int32 per output
// tile, all 0, which the kernel leaves 0. `stages` comes from
// ops/prefill.plan. Returns the cudaError_t of the launch (0 on success).
extern "C" int gl_prefill(const void* x, const void* wq, const void* scales, const void* zeros,
                          void* part, void* counters, void* out, int M, int N, int K, int gs,
                          int bits, int bm, int splits, int k_per_split, int stages,
                          void* stream_ptr) {
    const Params p{static_cast<const uint32_t*>(wq), static_cast<const bf16*>(scales),
                   static_cast<const bf16*>(zeros), static_cast<bf16*>(out), static_cast<float*>(part),
                   static_cast<int*>(counters), M, N, K, gs, k_per_split, stages, 0, 0, 0};
    return run<false>(x, p, Modes{}, bits, bm, splits, static_cast<cudaStream_t>(stream_ptr));
}

// One layer in W_group_mode 1, 2 or 3 with csm 0-3, as gl_prefill otherwise.
// `scales` (K / gs, N) bf16 group scales or null (scale 1); `zeros` (K / gs,
// N) bf16 zeros z (not folded) or null; `zscalar` one int32 zero on the
// device or null (no zero row: z = the scalar, or 0); `sx` (M) float32
// per-token scales for csm 2 / 3 and `cs` (N) channel scales for csm 1 / 3,
// float32 (code 0) or bf16 (code 2).
extern "C" int gl_prefill_modes(const void* x, const void* wq, const void* scales,
                                const void* zeros, const void* zscalar, const void* sx,
                                const void* cs, void* part, void* counters, void* out, int M,
                                int N, int K, int gs, int bits, int bm, int splits,
                                int k_per_split, int stages, int csm, int cs_code,
                                void* stream_ptr) {
    const bool codes_ok = cs_code == gl::kF32 || cs_code == gl::kBF16;
    if (csm < 0 || csm > 3 || !codes_ok || ((csm & 2) && sx == nullptr) ||
        ((csm & 1) && cs == nullptr) || (zeros != nullptr && zscalar != nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const Params p{static_cast<const uint32_t*>(wq), static_cast<const bf16*>(scales),
                   static_cast<const bf16*>(zeros), static_cast<bf16*>(out), static_cast<float*>(part),
                   static_cast<int*>(counters), M, N, K, gs, k_per_split, stages, 0, 0, 0};
    const Modes md{scales != nullptr, zeros != nullptr, static_cast<const int*>(zscalar),
                   static_cast<const float*>(sx), cs, csm, cs_code};
    return run<true>(x, p, md, bits, bm, splits, static_cast<cudaStream_t>(stream_ptr));
}
