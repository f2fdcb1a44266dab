// SPDX-License-Identifier: Apache-2.0
// W1/W2/W4 prefill in W_group_mode 1, 2 or 3 for 64 < M < 4096, for Hopper:
// out (M, N) bf16 = csm(x (M, K) bf16 . dequant(W_q)), float32 sums on the
// bf16 tensor cores, one launch a call (gl_prefill_modes_persistent).
//
// Replaces the TPU kernel gemlite_tpu/ops/pallas_prefill.py:pallas_prefill_matmul
// on the layers which the JAX router sends to it in modes 1-3: A8W4 / A8W2 /
// A8W1 (fp8 x comes in as its bf16 image, exact), channel-wise A16Wn and
// BitNet. It keeps the arithmetic of prefill_gemm.cu's mode 1-3 instances
// (w = (q - z) * s in three bf16x2 fmas a code pair, rounded as the plain
// version rounds; the channel scales on the finished float32 sums) and its
// consumer pipeline (the dequantized weights as wgmma's register operand,
// step j + 1's products queued before step j's are waited for), and
// reorganizes the rest around what held that kernel back:
//   * a persistent grid: at most one block an SM, each walking a fixed list
//     of work units, so the producer runs on into the next unit's stages
//     while the consumers store the last one's sums. A unit is an output
//     tile (128 weight columns by BM = 128 or 256 rows of x), tiles in
//     column-major order of their row tiles, so that blocks running at once
//     share x in L2. The tiles of the last, partial wave (all of them when
//     there are fewer tiles than SMs) are cut along K into as many pieces as
//     fill the SMs; the pieces of a tile write float32 partials and the last
//     to arrive adds them in split order, so a tile's sums depend only on
//     the shape (ops/prefill.modes_plan; counters left 0 for the next call,
//     ops/build.split_state);
//   * stages of 128 k: one full and one empty mbarrier a stage, its x (two
//     boxes of 64 k by BM rows in the 128-byte swizzle) and its word rows
//     (one box) by TMA; the consumers still build and issue 64 k at a time,
//     and follow the ring's slots and phases by counting (no division on a
//     step). 64-deep stages took 0.96-1.07x the time, more on 19 of 30
//     rows (scripts/torch_prefill_variants.py --modes, stages_64);
//   * at BM 256 one m64n256k16 product an A fragment, in place of two n128;
//   * the group rows of scales and zeros off the stage: chunks of kMetaRows
//     rows (one box each) on a ring of two, with barriers of their own, so a
//     stage waits only on x and words; a channel-wise layer fetches its one
//     row once a unit;
//   * the epilogue from registers: each thread scales and stores its own
//     sums (bf16 into the output, or float32 partials), so no shared tile
//     sits over the ring.
// Words and metadata come only by TMA: N a multiple of 8 and 16-byte aligned
// bases (ops/prefill.persistent; prefill_modes sends other layers to
// prefill_gemm.cu). A group is any multiple of 64 dividing K: a step's group
// row is one multiply-high (group_of).
//
// What bounds it: operations by count (2 M N K flops over the bf16 rate),
// but from M 1024 the L2 traffic of x, which every 128-column tile reads
// whole: there the copies alone take about as long as a dense bf16 matmul
// (scripts/torch_prefill_variants.py --modes, copies_only).
#include "gl_common.cuh"
#include "sm90_common.cuh"
#include "w4_common.cuh"

// One call's arguments, as gl_prefill_modes_persistent checked them: what
// the parts of the build (GL_PM_BITS below) pass one another.
struct PMCall {
    const void *x, *wq, *scales, *zeros, *zscalar, *sx, *cs;
    void *part, *counters, *out;
    int M, N, K, gs, bm, stages, grid, full, splits, k_per_split, csm, cs_code;
    uint32_t gmul;
    cudaStream_t stream;
};

namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int SK = 64;                        // k of a consumer step: one 128-byte swizzle row of x
constexpr int SUB = 2;                        // steps a stage
constexpr int BN = 128;                       // weight columns per tile
constexpr int kConsumers = 256;               // two warpgroups of 64 columns
constexpr int kThreads = kConsumers + 128;    // and one producer warpgroup
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
constexpr int kMaxStages = 8;
constexpr int kSmemMax = 227 * 1024;
constexpr int kMetaRows = 8;                  // group rows of a metadata chunk
constexpr int kMetaSlots = 2;

struct Params {
    const uint32_t* wq;                       // (K / epw, N)
    bf16* out;                                // (M, N)
    float* part;                              // (tiles - full, splits, BM, BN) float32 partials
    int* counters;                            // one per split tile, 0 between calls
    int M, N, K, gs;
    int tiles_m, tiles, full;                 // row tiles; tiles; the first `full` are whole
    int splits, k_per_split, stages;          // the rest: K ranges of k_per_split
    uint32_t gmul;                            // 2^31 / (64-deep steps a group) + 1 (group_of)
};

struct Maps {
    CUtensorMap x, w, s, z;
};

// Bytes of an x box (64 k by 128 nb rows), of a stage (SUB x boxes, then the
// words of SUB x 64 k) and of a metadata chunk (kMetaRows scale rows, then
// as many zero rows).
__host__ __device__ constexpr int x_box(int nb) { return nb * 128 * SK * 2; }
__host__ __device__ constexpr int stage_bytes(int bits, int nb) {
    return SUB * (x_box(nb) + SK * bits / 32 * BN * 4);
}
constexpr int kMetaBytes = 2 * kMetaRows * BN * 2;

// Shared memory from a 1024-byte aligned base: the stage ring, the metadata
// ring, the mbarriers (full and empty a stage, then full and empty a chunk
// slot) and the last-arriver flag. ops/prefill.modes_smem_bytes mirrors it.
struct Layout {
    int meta, bars, flag, bytes;
    __host__ __device__ Layout(int bits, int nb, int stages) {
        meta = stages * stage_bytes(bits, nb);
        bars = meta + kMetaSlots * kMetaBytes;
        flag = bars + 8 * (2 * stages + 2 * kMetaSlots);
        bytes = flag + 16 + 1024;            // slack to align the base
    }
};

// One unit of work: an output tile and the K range it sums.
struct Unit {
    int n0, m0, kb, ke, split, nsplit, slot;  // slot: its partials and counter (split tiles)
    __device__ Unit(const Params& p, int u, int bm) {
        int tile;
        if (u < p.full) {
            tile = u;
            split = 0, nsplit = 1, kb = 0, ke = p.K, slot = 0;
        } else {
            const int v = u - p.full;
            tile = p.full + v / p.splits;
            split = v % p.splits, nsplit = p.splits, slot = tile - p.full;
            kb = split * p.k_per_split;
            ke = min(p.K, kb + p.k_per_split);
        }
        m0 = tile % p.tiles_m * bm;
        n0 = tile / p.tiles_m * BN;
    }
};

__device__ __forceinline__ int units_of(const Params& p) {
    return p.full + (p.tiles - p.full) * p.splits;
}

// The group row of step i (from k = 0) of a layer with d 64-deep steps a
// group, given gmul = 2^31 / d + 1: floor(2 i gmul / 2^32) = floor(i / d + e)
// with 0 < e <= i / 2^31 < 1 / d while i d < 2^31, so it is exactly i / d
// (the entry checks (K / 64)^2 < 2^31).
__device__ __forceinline__ int group_row(int i, uint32_t gmul) {
    return static_cast<int>(__umulhi(2u * static_cast<uint32_t>(i), gmul));
}

// The group row of the unit's 64-deep step j, counted from the unit's first
// group row g0 (kb64: the unit's first step from k = 0); its metadata chunk
// is that over kMetaRows, its row in the chunk that modulo kMetaRows.
__device__ __forceinline__ int group_of(int kb64, int j, uint32_t gmul, int g0) {
    return group_row(kb64 + j, gmul) - g0;
}

// The producer lane: per unit, the metadata chunks as the unit's steps reach
// them, and per stage the x boxes and the word rows, by TMA.
template <int BITS, int NB>
__device__ __forceinline__ void produce(const Maps& maps, const Params& p, const Modes& md,
                                        uint32_t base, const Layout& L) {
    constexpr int EPW = 32 / BITS;
    constexpr int BK = SUB * SK;
    const int S = p.stages;
    const uint32_t bars = base + L.bars, mbars = bars + 8 * 2 * S;
    const uint32_t sbytes = stage_bytes(BITS, NB);
    const bool meta = md.has_s || md.has_z;
    const uint32_t mbytes = (md.has_s + md.has_z) * kMetaRows * BN * 2;
    int st = 0, mc = 0;                       // stages and chunks issued so far
    for (int u = blockIdx.x, n = units_of(p); u < n; u += gridDim.x) {
        const Unit w(p, u, NB * 128);
        const int kb64 = w.kb / SK, g0 = group_row(kb64, p.gmul);
        int chunk = -1;
        for (int k0 = w.kb; k0 < w.ke; k0 += BK, ++st) {
            if (meta) {
                for (int k = k0; k < min(k0 + BK, w.ke); k += SK) {
                    const int c = group_of(kb64, (k - w.kb) / SK, p.gmul, g0) / kMetaRows;
                    if (c == chunk) continue;
                    chunk = c;
                    const int slot = mc % kMetaSlots;
                    const uint32_t full = bar_addr(mbars, slot);
                    const uint32_t dst = base + L.meta + slot * kMetaBytes;
                    if (mc >= kMetaSlots)
                        mbar_wait(bar_addr(mbars, kMetaSlots + slot), ((mc / kMetaSlots) & 1) ^ 1);
                    mbar_expect_tx(full, mbytes);
                    const int row = g0 + c * kMetaRows;
                    if (md.has_s) tma_load_2d(dst, &maps.s, full, w.n0, row);
                    if (md.has_z) tma_load_2d(dst + kMetaRows * BN * 2, &maps.z, full, w.n0, row);
                    ++mc;
                }
            }
            const int slot = st % S;
            const uint32_t full = bar_addr(bars, slot), dst = base + slot * sbytes;
            if (st >= S) mbar_wait(bar_addr(bars, S + slot), ((st / S) & 1) ^ 1);
            mbar_expect_tx(full, sbytes);
#pragma unroll
            for (int b = 0; b < SUB; ++b)
                tma_load_2d(dst + b * x_box(NB), &maps.x, full, k0 + b * SK, w.m0);
            tma_load_2d(dst + SUB * x_box(NB), &maps.w, full, w.n0, k0 / EPW);
        }
    }
}

// The bf16x2 128 + q of the codes at k and k + 1 of a word: for W4 byte t
// (sel = t | (t + 4) << 8 takes it from w and from w >> 4), for W2 and W1
// the 2 BITS bits at `shift` (prefill_gemm.cu's code_pair).
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

// A position in the stage ring: its slot and the parity of its phase.
struct Ring {
    int slot, phase;
    __device__ __forceinline__ void next(int S) {
        if (++slot == S) slot = 0, phase ^= 1;
    }
};

// What a consumer thread needs across its steps. The three rings follow the
// stages of the steps built, issued and released: each moves on at the first
// step of a stage, so all start one stage before the first.
struct Consumer {
    const uint8_t* g;
    uint32_t base, bars, mbars;
    int S, meta_off, col, t, lane, has_s, has_z, meta;
    uint32_t gmul, sel, nz2;
    int kb64, g0;                             // the unit's first step from k = 0, its group row
    Ring built, issued, released;
    int mc, chunk;                            // metadata chunks taken; the one held
};

// The A fragments of step j of the unit (k = kb + 64 j) for this lane: a[kk][r]
// for the 16-deep k step kk, register r = 2 half + h at k 16 kk + 8 half + 2t
// (and + 1) of column col + 8 h, dequantized as (q - z) * s. Waits for the
// step's stage and, where the step starts a metadata chunk, for that chunk
// (releasing the one it held).
template <int BITS, int NB>
__device__ __forceinline__ void build_step(uint32_t (&a)[4][4], Consumer& c, int j) {
    constexpr int EPW = 32 / BITS;
    const int part = j % SUB;
    if (part == 0) {
        c.built.next(c.S);
        mbar_wait(bar_addr(c.bars, c.built.slot), c.built.phase);
    }
    const uint32_t* ws = reinterpret_cast<const uint32_t*>(
        c.g + c.built.slot * stage_bytes(BITS, NB) + SUB * x_box(NB) +
        part * (SK / EPW) * BN * 4) + c.col;
    uint32_t s2[2], z2[2];
    if (c.meta) {
        const int grp = group_of(c.kb64, j, c.gmul, c.g0), ch = grp / kMetaRows;
        if (ch != c.chunk) {
            if (c.chunk >= 0) {               // done with the chunk held: one arrival a warp
                __syncwarp();
                if (c.lane == 0)
                    mbar_arrive(bar_addr(c.mbars, kMetaSlots + (c.mc - 1) % kMetaSlots));
            }
            mbar_wait(bar_addr(c.mbars, c.mc % kMetaSlots), (c.mc / kMetaSlots) & 1);
            c.chunk = ch;
            ++c.mc;
        }
        const uint16_t* rows = reinterpret_cast<const uint16_t*>(
            c.g + c.meta_off + (c.mc - 1) % kMetaSlots * kMetaBytes) +
            grp % kMetaRows * BN + c.col;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            s2[h] = c.has_s ? rows[8 * h] * 0x00010001u : 0x3F803F80u;
            z2[h] = c.has_z ? (rows[kMetaRows * BN + 8 * h] ^ 0x8000u) * 0x00010001u : c.nz2;
        }
    } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) s2[h] = 0x3F803F80u, z2[h] = c.nz2;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int kl = 16 * kk + 8 * half;            // the step's first k of this half
            const int shift = BITS * (kl % EPW) + 2 * BITS * c.t;
#pragma unroll
            for (int h = 0; h < 2; ++h)
                a[kk][2 * half + h] = dequant_pair_shift(
                    code_pair<BITS>(ws[kl / EPW * BN + 8 * h], shift, c.sel), s2[h], z2[h]);
        }
}

// d (64 x 256) += A (64 x 16, registers) * B (16 x 256, shared, K-major in
// the 128-byte swizzle): the products of both 128-row halves of x for one A
// fragment in one instruction.
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
          "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
          "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
          "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
          "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
          "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
          "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]),
          "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]),
          "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]),
          "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Step j's products: for each 16-deep k step, one n128 wgmma over the x rows
// (BM 128) or one n256 (BM 256).
template <int BITS, int NB>
__device__ __forceinline__ void issue_step(Consumer& c, float (&acc)[NB][64], uint32_t (&a)[4][4],
                                           int j) {
    if (j % SUB == 0) c.issued.next(c.S);
    const uint64_t dx = sw128_desc(c.base + c.issued.slot * stage_bytes(BITS, NB) +
                                       j % SUB * x_box(NB),
                                   16, 1024);
    pin(a);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        if constexpr (NB == 2)
            wgmma_rs_n256(reinterpret_cast<float(&)[128]>(acc), a[kk], dx + ((kk * 32) >> 4));
        else
            wgmma_rs_n128<0>(acc[0], a[kk], dx + ((kk * 32) >> 4), 1);
    }
    wgmma_commit();
}

// After step j's products are done: the stage is free once its last step is.
__device__ __forceinline__ void release_step(Consumer& c, int j, int steps) {
    const int part = j % SUB;
    if (part == 0) c.released.next(c.S);
    if (part == SUB - 1 || j == steps - 1) {
        __syncwarp();
        if (c.lane == 0) mbar_arrive(bar_addr(c.bars, c.S + c.released.slot));
    }
}

// One step of the pipeline: step j's products are in flight; queue step j +
// 1's behind them (buffer ISSUE), wait for step j alone, release its stage if
// it was the stage's last, and build step j + 2 into step j's buffer. Every
// call issues: a wgmma under a branch leaves ptxas copying in-flight
// accumulators where the paths meet (note C7514).
template <int BITS, int NB, int ISSUE>
__device__ __forceinline__ void pipe_step(Consumer& c, float (&acc)[NB][64],
                                          uint32_t (&a)[2][4][4], int j, int steps) {
    issue_step<BITS, NB>(c, acc, a[ISSUE], j + 1);
    wgmma_wait<1>();
    pin(a[1 - ISSUE]);
    release_step(c, j, steps);
    if (j + 2 < steps) build_step<BITS, NB>(a[1 - ISSUE], c, j + 2);
}

// The last piece of a split tile to arrive: every partial of the tile added
// in split order, the channel scales, bf16 into the output; consumer threads
// only, four columns a thread a pass, four partials in flight. Not inlined:
// one copy serves every instance (md points at the kernel argument).
__device__ __noinline__ void merge_tile(const Params* p, const Modes* md, int slot, int m0,
                                        int n0, int bm) {
    const float* parts = p->part + (size_t)slot * p->splits * bm * BN;
    for (int e = threadIdx.x * 4; e < bm * BN; e += kConsumers * 4) {
        const int m = m0 + e / BN, n = n0 + e % BN;
        if (m >= p->M || n >= p->N) continue;
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        for (int s0 = 0; s0 < p->splits; s0 += 4) {
            float4 q[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                q[i] = s0 + i < p->splits
                           ? __ldcg(reinterpret_cast<const float4*>(parts + (size_t)(s0 + i) * bm * BN + e))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                if (s0 + i >= p->splits) break;
                v[0] = __fadd_rn(v[0], q[i].x), v[1] = __fadd_rn(v[1], q[i].y);
                v[2] = __fadd_rn(v[2], q[i].z), v[3] = __fadd_rn(v[3], q[i].w);
            }
        }
        __nv_bfloat162 o[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
            o[i] = __floats2bfloat162_rn(
                gl::channel_scale(v[2 * i], md->csm, md->cs, md->cs_code, md->sx, m, n + 2 * i),
                gl::channel_scale(v[2 * i + 1], md->csm, md->cs, md->cs_code, md->sx, m,
                                  n + 2 * i + 1));
        *reinterpret_cast<uint2*>(p->out + (size_t)m * p->N + n) = *reinterpret_cast<uint2*>(o);
    }
}

// The unit's sums from this thread's registers: row m0 + 128 nb + 8 n8 + 2t +
// (e & 1), column n0 + col + 8 (e >> 1) of acc[nb][4 n8 + e]. A whole tile is
// scaled (per-token, then channel, each rounded in float32) and stored as
// bf16; a piece of a split tile stores its float32 partial, and the last
// piece to arrive merges the tile (merge_tile) and leaves its counter 0.
template <int NB>
__device__ __forceinline__ void finish(const Params& p, const Modes& md, const Unit& w,
                                       const Consumer& c, float (&acc)[NB][64], int* flag) {
    constexpr int BM = NB * 128;
    if (w.nsplit > 1) {
        float* part = p.part + ((size_t)w.slot * w.nsplit + w.split) * BM * BN + c.col;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int i = 0; i < 64; ++i)
                part[(nb * 128 + 8 * (i / 4) + 2 * c.t + (i & 1)) * BN + 8 * ((i / 2) & 1)] =
                    acc[nb][i];
        __threadfence();
        named_sync<1, kConsumers>();
        if (threadIdx.x == 0) *flag = atomicAdd(p.counters + w.slot, 1) == w.nsplit - 1;
        named_sync<1, kConsumers>();
        const int last = *flag;
        named_sync<1, kConsumers>();          // every thread has read the flag
        if (last) {
            __threadfence();
            merge_tile(&p, &md, w.slot, w.m0, w.n0, BM);
            if (threadIdx.x == 0) p.counters[w.slot] = 0;
        }
        return;
    }
    const int n = w.n0 + c.col;
    float cs[2] = {1.f, 1.f};
    if (md.csm & 1)
#pragma unroll
        for (int h = 0; h < 2; ++h)
            if (n + 8 * h < p.N) cs[h] = gl::load_meta(md.cs, n + 8 * h, md.cs_code);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int r = 0; r < 32; ++r) {                // the thread's rows: 16 n8 x 2
            const int m = w.m0 + nb * 128 + 8 * (r / 2) + 2 * c.t + (r & 1);
            if (m >= p.M) continue;
            const float sx = (md.csm & 2) ? md.sx[m] : 1.f;
            bf16* out = p.out + (size_t)m * p.N + n;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                float v = acc[nb][4 * (r / 2) + 2 * h + (r & 1)];
                if (md.csm & 2) v = __fmul_rn(v, sx);
                if (md.csm & 1) v = __fmul_rn(v, cs[h]);
                if (n + 8 * h < p.N) out[8 * h] = __float2bfloat16_rn(v);
            }
        }
}

// The consumer warpgroups: 64 weight columns each, all of a tile's rows, one
// unit after another.
template <int BITS, int NB>
__device__ __forceinline__ void consume(const Params& p, const Modes& md, const uint8_t* g,
                                        uint32_t base, const Layout& L, int wg, int* flag) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int lane = threadIdx.x % 32, t = lane % 4;
    Consumer c{g, base, base + L.bars, base + L.bars + 8 * 2 * p.stages, p.stages, L.meta,
               wg * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4, t, lane, md.has_s, md.has_z,
               md.has_s || md.has_z, p.gmul, static_cast<uint32_t>(t | (t + 4) << 8),
               neg_zero2(md.zscalar), 0, 0, {p.stages - 1, 1}, {p.stages - 1, 1},
               {p.stages - 1, 1}, 0, -1};
    for (int u = blockIdx.x, n = units_of(p); u < n; u += gridDim.x) {
        const Unit w(p, u, NB * 128);
        c.kb64 = w.kb / SK;
        c.g0 = group_row(c.kb64, p.gmul);
        const int steps = (w.ke - w.kb) / SK;
        c.chunk = -1;
        float acc[NB][64];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int i = 0; i < 64; ++i) acc[nb][i] = 0.f;
        uint32_t a[2][4][4];                  // step s in buffer s % 2
        build_step<BITS, NB>(a[0], c, 0);
        issue_step<BITS, NB>(c, acc, a[0], 0);
        if (steps > 1) build_step<BITS, NB>(a[1], c, 1);
        int j = 0;
        for (; j + 2 < steps; j += 2) {
            pipe_step<BITS, NB, 1>(c, acc, a, j, steps);
            pipe_step<BITS, NB, 0>(c, acc, a, j + 1, steps);
        }
        if (j + 1 < steps) {                  // the last step; both paths drain
            pipe_step<BITS, NB, 1>(c, acc, a, j, steps);
            wgmma_wait<0>();
            release_step(c, j + 1, steps);
        } else {
            wgmma_wait<0>();
            release_step(c, j, steps);
        }
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) pin(acc[nb]);
        if (c.meta && c.chunk >= 0) {         // the unit's last chunk
            __syncwarp();
            if (lane == 0) mbar_arrive(bar_addr(c.mbars, kMetaSlots + (c.mc - 1) % kMetaSlots));
        }
        finish<NB>(p, md, w, c, acc, flag);
    }
}

template <int BITS, int NB>
__global__ void __launch_bounds__(kThreads, 1)
prefill_modes_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Params p,
                     const __grid_constant__ Modes md) {
    extern __shared__ uint8_t smem_raw[];
    const Layout L(BITS, NB, p.stages);
    const uint32_t base = smem_base(smem_raw), bars = base + L.bars;
    uint8_t* g = smem_raw + (base - smem_addr(smem_raw));
    if (threadIdx.x == 0) {
        for (int s = 0; s < p.stages; ++s) {
            mbar_init(bar_addr(bars, s), 1);
            mbar_init(bar_addr(bars, p.stages + s), kConsumers / 32);
        }
        for (int s = 0; s < kMetaSlots; ++s) {
            mbar_init(bar_addr(bars, 2 * p.stages + s), 1);
            mbar_init(bar_addr(bars, 2 * p.stages + kMetaSlots + s), kConsumers / 32);
        }
        mbar_init_fence();
    }
    __syncthreads();
    const int wg = warpgroup();
    if (wg == 2) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
        if (threadIdx.x == kConsumers) produce<BITS, NB>(maps, p, md, base, L);
    } else {
        consume<BITS, NB>(p, md, g, base, L, wg, reinterpret_cast<int*>(g + L.flag));
    }
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

template <int BITS, int NB>
cudaError_t launch(const void* x, const void* scales, const void* zeros, const Params& p,
                   const Modes& md, int grid, cudaStream_t stream) {
    static std::atomic<unsigned> ready{0};
    const Layout L(BITS, NB, p.stages);
    if (L.bytes > kSmemMax) return cudaErrorInvalidValue;
    Maps maps;
    if (!make_map(&maps.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, p.M, p.K, NB * 128, SK,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
        !make_map(&maps.w, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, p.wq, p.K * BITS / 32, p.N,
                  SUB * SK * BITS / 32, BN, CU_TENSOR_MAP_SWIZZLE_NONE) ||
        (md.has_s && !make_map(&maps.s, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, scales, p.K / p.gs,
                               p.N, kMetaRows, BN, CU_TENSOR_MAP_SWIZZLE_NONE)) ||
        (md.has_z && !make_map(&maps.z, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, zeros, p.K / p.gs,
                               p.N, kMetaRows, BN, CU_TENSOR_MAP_SWIZZLE_NONE)))
        return cudaErrorInvalidValue;
    const cudaError_t err = allow_smem(prefill_modes_kernel<BITS, NB>, kSmemMax, ready);
    if (err != cudaSuccess) return err;
    prefill_modes_kernel<BITS, NB><<<grid, kThreads, L.bytes, stream>>>(maps, p, md);
    return cudaGetLastError();
}

template <int BITS>
int run(const PMCall& c) {
    const int tiles_m = (c.M + c.bm - 1) / c.bm, tiles = tiles_m * ((c.N + BN - 1) / BN);
    const Params p{static_cast<const uint32_t*>(c.wq), static_cast<bf16*>(c.out),
                   static_cast<float*>(c.part), static_cast<int*>(c.counters), c.M, c.N, c.K,
                   c.gs, tiles_m, tiles, c.full, c.full == tiles ? 1 : c.splits, c.k_per_split,
                   c.stages, c.gmul};
    const Modes md{c.scales != nullptr, c.zeros != nullptr, static_cast<const int*>(c.zscalar),
                   static_cast<const float*>(c.sx), c.cs, c.csm, c.cs_code};
    return static_cast<int>(c.bm == 128 ? launch<BITS, 1>(c.x, c.scales, c.zeros, p, md, c.grid,
                                                          c.stream)
                                        : launch<BITS, 2>(c.x, c.scales, c.zeros, p, md, c.grid,
                                                          c.stream));
}

}  // namespace

// The instances build in parts, one nvcc each, into one library
// (ops/build.KERNEL_PARTS): a part compiled with GL_PM_BITS, a mask of code
// widths (1, 2, 4), instantiates them behind gl_pm_bits<BITS>; the part
// compiled with GL_PM_ENTRY also holds gl_prefill_modes_persistent. Compiled
// alone, with neither, the source builds every width and the entry.
#ifndef GL_PM_BITS
#define GL_PM_BITS 0x7
#define GL_PM_ENTRY 1
#endif

template <int BITS>
int gl_pm_bits(const PMCall& c);

#define GL_PM_INSTANCE(BITS) \
    template <>              \
    int gl_pm_bits<BITS>(const PMCall& c) { return run<BITS>(c); }
#if GL_PM_BITS & 0x1
GL_PM_INSTANCE(1)
#endif
#if GL_PM_BITS & 0x2
GL_PM_INSTANCE(2)
#endif
#if GL_PM_BITS & 0x4
GL_PM_INSTANCE(4)
#endif
#undef GL_PM_INSTANCE

#ifdef GL_PM_ENTRY
// Launch on `stream`. One layer in W_group_mode 1, 2 or 3 with csm 0-3: x (M,
// K) bf16, `wq` (K / epw, N) words of `bits` (1, 2, 4) codes; `scales` (K /
// gs, N) bf16 group scales or null (scale 1); `zeros` (K / gs, N) bf16 zeros z
// or null; `zscalar` one int32 zero on the device or null (no zero row: z =
// the scalar, or 0); `sx` (M) float32 per-token scales for csm 2 / 3 and `cs`
// (N) channel scales for csm 1 / 3, float32 (code 0) or bf16 (2). N a multiple
// of 8, gs a multiple of 64 dividing K, K a multiple of 64; every
// base 16-byte aligned. The plan (ops/prefill.modes_plan): `bm` (128 or 256) rows a tile,
// stages of 128 k in a ring of `stages`, `grid` blocks over
// the tiles in column-major order, the first `full` summed whole and the rest
// cut into `splits` K ranges of `k_per_split` (a multiple of 128); with
// a split, `part` holds (tiles - full) x splits x bm x 128 floats and
// `counters` one int32 a split tile, all 0, which the kernel leaves 0.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int gl_prefill_modes_persistent(const void* x, const void* wq, const void* scales,
                                           const void* zeros, const void* zscalar, const void* sx,
                                           const void* cs, void* part, void* counters, void* out,
                                           int M, int N, int K, int gs, int bits, int bm,
                                           int stages, int grid, int full, int splits,
                                           int k_per_split, int csm, int cs_code,
                                           void* stream_ptr) {
    const int tiles = (M + bm - 1) / bm * ((N + BN - 1) / BN);
    const uintptr_t bases = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wq) |
                            reinterpret_cast<uintptr_t>(scales) | reinterpret_cast<uintptr_t>(zeros);
    const long long steps = K / SK;
    const bool shape_ok = M >= 1 && N >= 8 && N % 8 == 0 && K > 0 && K % SK == 0 && gs > 0 &&
                          gs % SK == 0 && K % gs == 0 && steps * steps < (1LL << 31) &&
                          (bits == 1 || bits == 2 || bits == 4) &&
                          (bm == 128 || bm == 256) && bases % 16 == 0;
    const bool split_ok = full >= 0 && full <= tiles && splits >= 1 &&
                          (full == tiles || (splits > 1 && k_per_split > 0 &&
                                             k_per_split % (SK * SUB) == 0 &&
                                             (long long)(splits - 1) * k_per_split < K &&
                                             (long long)splits * k_per_split >= K &&
                                             part != nullptr && counters != nullptr));
    const bool codes_ok = cs_code == gl::kF32 || cs_code == gl::kBF16;
    if (!shape_ok || !split_ok || !codes_ok || grid < 1 || stages < 2 || stages > kMaxStages ||
        csm < 0 || csm > 3 || ((csm & 2) && sx == nullptr) || ((csm & 1) && cs == nullptr) ||
        (zeros != nullptr && zscalar != nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const uint32_t gmul = (1u << 31) / static_cast<uint32_t>(gs / SK) + 1u;
    const PMCall c{x, wq, scales, zeros, zscalar, sx, cs, part, counters, out, M, N, K, gs,
                   bm, stages, grid, full, splits, k_per_split, csm, cs_code, gmul,
                   static_cast<cudaStream_t>(stream_ptr)};
    if (bits == 4) return gl_pm_bits<4>(c);
    if (bits == 2) return gl_pm_bits<2>(c);
    return gl_pm_bits<1>(c);
}
#endif
