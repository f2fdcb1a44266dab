// SPDX-License-Identifier: Apache-2.0
// Causal flash attention for a prefill from cache offset 0, for Hopper:
//   out = softmax(q kᵀ / √D, causal) v
// q (B, S, Hq, D), k/v (B, S, Hkv, D), out (B, S, Hq, D), all bf16; D = 64 or
// 128, S % 64 == 0; GQA reads kv head = q head / (Hq / Hkv), copying nothing.
//
// Replaces the jax-shipped Pallas TPU kernel `flash_attention`
// (jax.experimental.pallas.ops.tpu.flash_attention), which the JAX package
// borrows at gemlite_tpu/models/llama.py:_attention_flash_causal.
//
// What bounds it: operations. Each k/v tile staged in shared memory feeds 128
// query rows, so from S = 256 on the causal products, 2·B·Hq·S²·D flops over
// the bf16 tensor-core rate, outweigh the bytes of q, k, v and out. Beside
// the products each score takes one exp2 on the special-function units: at
// D 128 that is one exp2 per 512 tensor-core flops, about half the products'
// time unless the two overlap.
//
// Design:
//   * one block per (128-row query tile, q head, batch row), the heaviest
//     tiles (nearest the end of the sequence) launched first; each query tile
//     belongs to one block and sums its key tiles in a fixed order, so the
//     result is deterministic;
//   * 384 threads: two consumer warpgroups of 64 query rows each and one
//     producer warpgroup; setmaxnreg moves registers from the producer to
//     the consumers;
//   * the producer's one elected thread loads the query tile once and then
//     128-row K and V tiles into a three-stage ring in dynamic shared memory
//     (224 KB at D 128; faster than two stages on an H100, PERF.md §6), all
//     with TMA: cp.async.bulk.tensor over 4-d maps (D, H, S, B),
//     so the zero fill of a ragged last tile stays inside its batch row, each
//     box 128 rows of 64 bf16 in the 128-byte swizzle; per stage a full
//     mbarrier for K, one for V, and an empty one;
//   * S = Q Kᵀ is wgmma m64n128k16 with Q and K both read from shared memory,
//     K-major as stored; O += P V is wgmma with A from registers: the float32
//     S accumulator fragment becomes the bf16 A fragment in place, and V is
//     read as stored, MN-major, through the B descriptor's transpose bit, so
//     nothing transposes V;
//   * P enters P V as two bf16 parts, hi = P rounded and lo = what that
//     rounding left (two register-A products over the same V), so P keeps
//     about 16 bits. Rounded once to bf16, even with each row's sum taken
//     over the rounded values, P came out about 2e-3 (mean relative) from
//     the float32 attention, against 1.4e-3 with the split (the output's own
//     bf16 rounding), but block 0 of the serve check's cached-prefix chunk
//     then sat at 6.1e-3 against its 5e-3 gate (3.5e-3 with the split); what
//     the split costs: PERF.md §6;
//   * online softmax in float32 on exp2 of scores scaled by log2(e)/√D, row
//     max and sum over four independent chains; only the diagonal tile is
//     masked;
//   * each warpgroup issues tile kt's Q Kᵀ together with tile kt - 1's P V,
//     and runs tile kt's softmax while P V is still on the tensor cores; the
//     two warpgroups, unsynchronised, fill each other's gaps (making them take
//     turns through named barriers gained nothing on an H100, PERF.md §6);
//   * every wgmma operand register is pinned before wgmma.fence and after
//     wgmma.wait, and the warpgroup index is warp-uniform: otherwise ptxas
//     serializes the wgmmas.
// Left for later: head dim 256, a persistent grid, fp8.
#include <math.h>

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int kBM = 128;                        // query rows per block
constexpr int kBN = 128;                        // key rows per tile
constexpr int kBoxCols = 64;                    // bf16 per box row: one 128-byte swizzle row
constexpr int kBoxBytes = kBN * kBoxCols * 2;   // one TMA box, 16 KB
constexpr int kStages = 3;
constexpr int kConsumers = 256;                 // two warpgroups of 64 query rows
constexpr int kThreads = kConsumers + 128;      // and one producer warpgroup
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

// Dynamic shared memory, from a 1024-byte aligned base: Q, the K ring, the V
// ring, then the mbarriers.
template <int D>
struct Smem {
    static constexpr int tile = D / kBoxCols * kBoxBytes;
    static constexpr int q = 0, k = tile, v = k + kStages * tile, bar = v + kStages * tile;
    static constexpr int bytes = bar + 8 * (1 + 3 * kStages) + 1024;   // slack to align the base
};
// mbarriers: the query tile landed; per stage, its K tile landed, its V tile
// landed, and both consumer warpgroups are done with the stage
enum Bar { kQFull = 0, kKFull = 1, kVFull = 1 + kStages, kEmpty = 1 + 2 * kStages };

// the (D / 64) boxes of 128 rows from row `row` of head `h`, batch row `b`
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int h, int row, int b) {
#pragma unroll
    for (int j = 0; j < D / kBoxCols; ++j)
        tma_load(dst + j * kBoxBytes, map, bar, j * kBoxCols, h, row, b);
}

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// S (this warpgroup's 64 rows x 128 keys) = Q Kᵀ, D / 16 k-steps: box kk / 4,
// 32 bytes into each 128-byte swizzle row per step
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint64_t dq, uint64_t dk) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = ((kk / 4) * kBoxBytes + (kk % 4) * 32) >> 4;
        wgmma_ss_n128(s, dq + off, dk + off, kk);
    }
}

// O += P V over the tile's 128 keys, P one bf16 part (hi or lo); V MN-major,
// 16 key rows of 128 bytes per k-step
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&p)[kBN / 16][4],
                                         uint64_t dv) {
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
        const uint64_t d = dv + ((kk * 16 * kBoxCols * 2) >> 4);
        if constexpr (D == 128)
            wgmma_rs_n128<1>(o, p[kk], d, 1);
        else
            wgmma_rs_n64(o, p[kk], d, 1);
    }
}

// Online softmax of one key tile for this thread's two rows, `rel` and
// rel + 8 within the query tile (the accumulator fragment: element 4j + e
// holds row rel + 8 (e / 2), key 8j + 2t + e % 2). Masks the diagonal tile,
// updates the running max m and sum l, returns O's rescale factors in alpha
// and leaves the probabilities P in s.
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool diag, int rel, int t,
                                             float sl2) {
    if (diag) {
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                if (j * 8 + t * 2 + (e & 1) > rel + (e >> 1) * 8) s[4 * j + e] = -INFINITY;
    }
    // four independent chains per row: the row's 32 values in 8 dependent steps
    float part[2][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        part[e >> 1][e & 1] = s[e];
        part[e >> 1][2 + (e & 1)] = s[4 + e];
    }
#pragma unroll
    for (int j = 2; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            part[e >> 1][(j & 1) * 2 + (e & 1)] = fmaxf(part[e >> 1][(j & 1) * 2 + (e & 1)],
                                                        s[4 * j + e]);
    float mx[2], ms[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {      // the four threads of a row share its max
        mx[r] = fmaxf(fmaxf(fmaxf(part[r][0], part[r][1]), fmaxf(part[r][2], part[r][3])), m[r]);
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = ex2((m[r] - mx[r]) * sl2);
        m[r] = mx[r];
        ms[r] = mx[r] * sl2;
    }
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
            s[4 * j + e] = ex2(fmaf(s[4 * j + e], sl2, -ms[e >> 1]));
            s[4 * j + e + 1] = ex2(fmaf(s[4 * j + e + 1], sl2, -ms[e >> 1]));
        }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        part[e >> 1][e & 1] = s[e];
        part[e >> 1][2 + (e & 1)] = s[4 + e];
    }
#pragma unroll
    for (int j = 2; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[e >> 1][(j & 1) * 2 + (e & 1)] += s[4 * j + e];
#pragma unroll
    for (int r = 0; r < 2; ++r)
        l[r] = l[r] * alpha[r] + ((part[r][0] + part[r][1]) + (part[r][2] + part[r][3]));
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&alpha)[2]) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
    }
}

// P's accumulator fragment as the bf16 A fragments of P V, one per 16 keys:
// key pairs 16kk + 2t (rows rel, rel + 8), then 16kk + 8 + 2t, as they lie;
// hi is P rounded to bf16, lo what that rounding left, rounded to bf16.
__device__ __forceinline__ void to_frag(const float (&s)[64], uint32_t (&hi)[kBN / 16][4],
                                        uint32_t (&lo)[kBN / 16][4]) {
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float a = s[8 * kk + 2 * i], b = s[8 * kk + 2 * i + 1];
            hi[kk][i] = pack_bf16(a, b);
            lo[kk][i] = pack_bf16(a - __uint_as_float(hi[kk][i] << 16),
                                  b - __uint_as_float(hi[kk][i] & 0xffff0000u));
        }
}

__device__ __forceinline__ void init_barriers(uint32_t bars) {
    mbar_init(bar_addr(bars, kQFull), 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
        mbar_init(bar_addr(bars, kKFull + s), 1);
        mbar_init(bar_addr(bars, kVFull + s), 1);
        mbar_init(bar_addr(bars, kEmpty + s), kConsumers);
    }
    mbar_init_fence();
}

// The consumer warpgroups' side of flash_attn_fwd_kernel: 64 query rows each.
// Per key tile kt, Q Kᵀ of tile kt and P V of tile kt - 1 are issued together;
// the softmax of tile kt runs while P V is still on the tensor cores.
template <int D>
__device__ __forceinline__ void consume(uint32_t base, uint32_t bars, int wg, int qt, int S,
                                        int Hq, int h, int b, __nv_bfloat16* __restrict__ out) {
    using L = Smem<D>;
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int n_kt = qt + 1;
    const int lane = threadIdx.x % 32;
    const int t = lane % 4;
    const int rel = wg * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;   // row in the query tile
    const float sl2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));
    const uint64_t dq = sw128_desc(base + L::q + wg * 64 * kBoxCols * 2, 16, 1024);
    auto dk = [&](int kt) { return sw128_desc(base + L::k + kt % kStages * L::tile, 16, 1024); };
    auto dv = [&](int kt) {
        return sw128_desc(base + L::v + kt % kStages * L::tile, kBoxBytes, 1024);
    };
    auto full = [&](int which, int kt) {
        mbar_wait(bar_addr(bars, which + kt % kStages), (kt / kStages) & 1);
    };
    float o[D / 2], s[64], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
    uint32_t hi[kBN / 16][4], lo[kBN / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    mbar_wait(bar_addr(bars, kQFull), 0);

    full(kKFull, 0);                              // tile 0: Q Kᵀ alone
    pin(s);
    wgmma_fence();
    issue_qk<D>(s, dq, dk(0));
    wgmma_commit();
    wgmma_wait<0>();
    pin(s);
    softmax_tile(s, m, l, alpha, qt == 0, rel, t, sl2);
    to_frag(s, hi, lo);
    for (int kt = 1; kt < n_kt; ++kt) {
        full(kKFull, kt);
        full(kVFull, kt - 1);
        pin(s);
        pin(o);
        pin(hi);
        pin(lo);
        wgmma_fence();
        issue_qk<D>(s, dq, dk(kt));
        wgmma_commit();
        issue_pv<D>(o, hi, dv(kt - 1));
        issue_pv<D>(o, lo, dv(kt - 1));
        wgmma_commit();
        wgmma_wait<1>();                          // Q Kᵀ done, P V may still run
        pin(s);
        softmax_tile(s, m, l, alpha, kt == qt, rel, t, sl2);
        wgmma_wait<0>();
        pin(o);
        pin(hi);
        pin(lo);
        mbar_arrive(bar_addr(bars, kEmpty + (kt - 1) % kStages));
        rescale(o, alpha);
        to_frag(s, hi, lo);
    }
    full(kVFull, n_kt - 1);                       // P V of the diagonal tile
    pin(o);
    pin(hi);
    pin(lo);
    wgmma_fence();
    issue_pv<D>(o, hi, dv(n_kt - 1));
    issue_pv<D>(o, lo, dv(n_kt - 1));
    wgmma_commit();
    wgmma_wait<0>();
    pin(o);
    pin(hi);
    pin(lo);
    mbar_arrive(bar_addr(bars, kEmpty + (n_kt - 1) % kStages));

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
    const int row0 = qt * kBM + rel, row1 = row0 + 8;
    const size_t stride = static_cast<size_t>(Hq) * D;
    __nv_bfloat16* ob = out + static_cast<size_t>(b) * S * stride + static_cast<size_t>(h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
        const int c = j * 8 + t * 2;
        if (row0 < S)
            *reinterpret_cast<uint32_t*>(ob + row0 * stride + c) =
                pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
        if (row1 < S)
            *reinterpret_cast<uint32_t*>(ob + row1 * stride + c) =
                pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attn_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                      int S, int Hq, int Hkv) {
    using L = Smem<D>;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t base = smem_base(smem_raw), bars = base + L::bar;
    const int h = blockIdx.x, b = blockIdx.y;
    const int qt = gridDim.z - 1 - blockIdx.z;    // heaviest query tiles first
    const int n_kt = qt + 1;                      // key tiles 0 .. qt, the last the diagonal
    if (threadIdx.x == 0) init_barriers(bars);
    __syncthreads();
    const int wg = warpgroup();

    if (wg == 2) {                                // the producer warpgroup
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
        if (threadIdx.x == kConsumers) {
            const int kvh = h / (Hq / Hkv);
            mbar_expect_tx(bar_addr(bars, kQFull), L::tile);
            tma_tile<D>(base + L::q, &tq, bar_addr(bars, kQFull), h, qt * kBM, b);
            for (int kt = 0; kt < n_kt; ++kt) {
                const int st = kt % kStages;
                if (kt >= kStages)                // the stage's previous tiles released
                    mbar_wait(bar_addr(bars, kEmpty + st), ((kt / kStages) & 1) ^ 1);
                mbar_expect_tx(bar_addr(bars, kKFull + st), L::tile);
                tma_tile<D>(base + L::k + st * L::tile, &tk, bar_addr(bars, kKFull + st), kvh,
                            kt * kBN, b);
                mbar_expect_tx(bar_addr(bars, kVFull + st), L::tile);
                tma_tile<D>(base + L::v + st * L::tile, &tv, bar_addr(bars, kVFull + st), kvh,
                            kt * kBN, b);
            }
        }
    } else {
        consume<D>(base, bars, wg, qt, S, Hq, h, b, out);
    }
}

// Test entries: each product alone on one tile, through the same loads,
// descriptors and fragments. S = Q Kᵀ of q, k (128, D); O = P V of p (128,
// 128) float32, split into bf16 hi and lo parts as in the kernel, and v (128,
// D); both float32 row-major.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_qk_tile_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk, float* __restrict__ s_out) {
    using L = Smem<D>;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t base = smem_base(smem_raw), bars = base + L::bar;
    if (threadIdx.x == 0) init_barriers(bars);
    __syncthreads();
    const int wg = warpgroup();
    if (wg == 2) {
        if (threadIdx.x == kConsumers) {
            mbar_expect_tx(bar_addr(bars, kQFull), L::tile);
            tma_tile<D>(base + L::q, &tq, bar_addr(bars, kQFull), 0, 0, 0);
            mbar_expect_tx(bar_addr(bars, kKFull), L::tile);
            tma_tile<D>(base + L::k, &tk, bar_addr(bars, kKFull), 0, 0, 0);
        }
        return;
    }
    const int lane = threadIdx.x % 32, t = lane % 4;
    const int rel = wg * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
    mbar_wait(bar_addr(bars, kQFull), 0);
    mbar_wait(bar_addr(bars, kKFull), 0);
    float s[64];
    pin(s);
    wgmma_fence();
    issue_qk<D>(s, sw128_desc(base + L::q + wg * 64 * kBoxCols * 2, 16, 1024),
                sw128_desc(base + L::k, 16, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    pin(s);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            s_out[(rel + (e >> 1) * 8) * kBN + j * 8 + t * 2 + (e & 1)] = s[4 * j + e];
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_pv_tile_kernel(const __grid_constant__ CUtensorMap tv, const float* __restrict__ p,
                     float* __restrict__ o_out) {
    using L = Smem<D>;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t base = smem_base(smem_raw), bars = base + L::bar;
    if (threadIdx.x == 0) init_barriers(bars);
    __syncthreads();
    const int wg = warpgroup();
    if (wg == 2) {
        if (threadIdx.x == kConsumers) {
            mbar_expect_tx(bar_addr(bars, kVFull), L::tile);
            tma_tile<D>(base + L::v, &tv, bar_addr(bars, kVFull), 0, 0, 0);
        }
        return;
    }
    const int lane = threadIdx.x % 32, t = lane % 4;
    const int rel = wg * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
    float s[64], o[D / 2];
    uint32_t hi[kBN / 16][4], lo[kBN / 16][4];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            s[4 * j + e] = p[(rel + (e >> 1) * 8) * kBN + j * 8 + t * 2 + (e & 1)];
    to_frag(s, hi, lo);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    mbar_wait(bar_addr(bars, kVFull), 0);
    pin(o);
    pin(hi);
    pin(lo);
    wgmma_fence();
    issue_pv<D>(o, hi, sw128_desc(base + L::v, kBoxBytes, 1024));
    issue_pv<D>(o, lo, sw128_desc(base + L::v, kBoxBytes, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    pin(o);
    pin(hi);
    pin(lo);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            o_out[(rel + (e >> 1) * 8) * D + j * 8 + t * 2 + (e & 1)] = o[4 * j + e];
}

// 4-d map over a contiguous (B, S, H, D) bf16 tensor, dims innermost first
// (D, H, S, B); a box is 64 columns of one head over 128 rows of one batch
// row, in the 128-byte swizzle; rows past S read as zeros
bool make_map(CUtensorMap* map, const void* ptr, int D, int H, int S, int B) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return false;
    const cuuint64_t e = 2;
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[3] = {dims[0] * e, dims[1] * dims[0] * e,
                                   dims[2] * dims[1] * dims[0] * e};
    const cuuint32_t box[4] = {kBoxCols, 1, kBN, 1}, unit[4] = {1, 1, 1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                  strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int S, int Hq,
                   int Hkv, cudaStream_t stream) {
    static std::atomic<unsigned> ready{0};
    CUtensorMap mq, mk, mv;
    if (!make_map(&mq, q, D, Hq, S, B) || !make_map(&mk, k, D, Hkv, S, B) ||
        !make_map(&mv, v, D, Hkv, S, B))
        return cudaErrorInvalidValue;
    const cudaError_t err = allow_smem(flash_attn_fwd_kernel<D>, Smem<D>::bytes, ready);
    if (err != cudaSuccess) return err;
    const dim3 grid(Hq, B, (S + kBM - 1) / kBM);
    flash_attn_fwd_kernel<D><<<grid, kThreads, Smem<D>::bytes, stream>>>(
        mq, mk, mv, static_cast<__nv_bfloat16*>(out), S, Hq, Hkv);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch_tile_test(const void* a, const void* b, void* out, bool qk,
                             cudaStream_t stream) {
    static std::atomic<unsigned> ready_qk{0}, ready_pv{0};
    CUtensorMap ma, mb;
    if (qk) {
        if (!make_map(&ma, a, D, 1, kBN, 1) || !make_map(&mb, b, D, 1, kBN, 1))
            return cudaErrorInvalidValue;
        const cudaError_t err = allow_smem(flash_qk_tile_kernel<D>, Smem<D>::bytes, ready_qk);
        if (err != cudaSuccess) return err;
        flash_qk_tile_kernel<D><<<1, kThreads, Smem<D>::bytes, stream>>>(
            ma, mb, static_cast<float*>(out));
    } else {
        if (!make_map(&mb, b, D, 1, kBN, 1)) return cudaErrorInvalidValue;
        const cudaError_t err = allow_smem(flash_pv_tile_kernel<D>, Smem<D>::bytes, ready_pv);
        if (err != cudaSuccess) return err;
        flash_pv_tile_kernel<D><<<1, kThreads, Smem<D>::bytes, stream>>>(
            mb, static_cast<const float*>(a), static_cast<float*>(out));
    }
    return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; S % 64 == 0, Hq % Hkv == 0, D in {64, 128}, 16-byte
// aligned contiguous tensors. Returns the cudaError_t.
extern "C" int gl_flash_attention(const void* q, const void* k, const void* v, void* out,
                                  int B, int S, int Hq, int Hkv, int D, void* stream_ptr) {
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if (S <= 0 || S % 64 || Hkv <= 0 || Hq % Hkv) return static_cast<int>(cudaErrorInvalidValue);
    if (D == 64) return static_cast<int>(launch<64>(q, k, v, out, B, S, Hq, Hkv, stream));
    if (D == 128) return static_cast<int>(launch<128>(q, k, v, out, B, S, Hq, Hkv, stream));
    return static_cast<int>(cudaErrorInvalidValue);
}

// Test entries on one tile: s (128, 128) = q kᵀ for q, k (128, D) bf16;
// o (128, D) = p v for p (128, 128) float32 and v (128, D) bf16.
extern "C" int gl_flash_qk_tile(const void* q, const void* k, void* s, int D, void* stream_ptr) {
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if (D == 64) return static_cast<int>(launch_tile_test<64>(q, k, s, true, stream));
    if (D == 128) return static_cast<int>(launch_tile_test<128>(q, k, s, true, stream));
    return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int gl_flash_pv_tile(const void* p, const void* v, void* o, int D, void* stream_ptr) {
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if (D == 64) return static_cast<int>(launch_tile_test<64>(p, v, o, false, stream));
    if (D == 128) return static_cast<int>(launch_tile_test<128>(p, v, o, false, stream));
    return static_cast<int>(cudaErrorInvalidValue);
}
