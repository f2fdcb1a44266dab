// SPDX-License-Identifier: Apache-2.0
// Paged decode attention: one new token per slot attends over the slot's
// cache, whose rows live in fixed-size pages named by a block table.
//   out[b, h] = softmax_t(q[b, h] · k[t] / √D) · v[t],  t < lengths[b],
//   row t of slot b = page table[b, t / ps], offset t % ps.
// q (B, Hq, D), k/v pages (Hkv, P, ps, D), out (B, Hq, D) bf16; lengths (B,)
// and table (B, pps) int32; D = 64 or 128, Hq / Hkv <= 8.
//
// Replaces the jax-shipped Pallas TPU kernel `paged_attention`
// (jax.experimental.pallas.ops.tpu.paged_attention), which the JAX package
// borrows at gemlite_tpu/models/paged_kv.py:paged_decode_attention.
//
// What bounds it: every live k and v row is read once for about 4·rep·D
// flops per row, far below the card's flops per byte, so the bytes of the
// live pages (Σ_b lengths[b]·Hkv·D·2·2, plus q and out) over the memory rate
// bound it. Scores, softmax and P·V stay in float32 on the CUDA cores, which
// keep up with the memory at that rate. Design:
//   * grid (kv head, slot, split); one block of 4 warps serves the Hq / Hkv q
//     heads that share a kv head, so each k/v row is read once for all of
//     them. Each split walks a fixed range of the slot's pages through the
//     table up to lengths[b]; splits past the slot's length exit at once;
//   * a ring of 4 stages of 32 tokens (K and V rows) in shared memory, filled
//     by cp.async 16-byte copies, keeps the next three stages in flight while
//     one is summed: one __syncthreads a stage;
//   * warp w takes tokens 8w .. 8w + 7 of a stage. Scores: D / 8 lanes read
//     a k row as 16-byte pieces, each against its slice of every q head, and
//     shuffles reduce the dot products. Each warp keeps its own running max,
//     sum and accumulator (online softmax in base 2, log2(e) / √D folded into
//     the score scale, exp2f); in P·V a lane owns D / 32 columns and reads
//     them as bf16 pairs;
//   * the four warps' states merge in warp order at the end of the split. A
//     slot whose length fits one split writes its output then and there.
//     Otherwise each live split writes its (max, sum, acc) partial and bumps
//     the (slot, kv head) arrival counter; the last of the slot's live
//     splits (counted in the kernel from lengths[b]) merges the partials in
//     split order, writes the output and leaves the counter at 0. One launch
//     a call;
//   * the split count depends only on pages_per_seq (ops/attention.py
//     paged_split_plan) and every order above only on a token's position, so
//     a slot's bits do not depend on the batch, the other slots' lengths or
//     the page ids it was given.
// The head-dim limit of the TPU call (D % 128) was a Mosaic alignment limit,
// not part of the function: D = 64 runs here too.
// Left for later: splitting a long slot more finely when the batch is small
// (the plan is fixed by pages_per_seq), and fp8 pages.
#include <atomic>

#include "gl_common.cuh"

namespace {

using gl::cp_async16;
using gl::cp_async_commit;
using gl::cp_async_wait_n;
using gl::smem_u32;

constexpr int kThreads = 128;   // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTok = 32;        // tokens a stage
constexpr int kWarpTok = kTok / kWarps;
constexpr int kStages = 4;
constexpr int kMaxRep = 8;      // q heads per kv head
constexpr int kMaxSplits = 16;  // splits of a slot (ops/attention.py paged_split_plan)
constexpr unsigned kFull = 0xffffffffu;

struct Params {
    const __nv_bfloat16* q;     // (B, Hq, D)
    const __nv_bfloat16* kp;    // (Hkv, P, ps, D)
    const __nv_bfloat16* vp;
    const int* lengths;         // (B,)
    const int* table;           // (B, pps)
    float* acc_ws;              // (B, Hq, splits, D)
    float* ml_ws;               // (B, Hq, splits, 2)
    int* counters;              // (B, Hkv), 0 between calls
    __nv_bfloat16* out;         // (B, Hq, D)
    int Hq, Hkv, P, ps, pps, splits, per_split;
};

template <int D>
constexpr int smem_bytes() {
    return kStages * 2 * kTok * D * 2 + kWarps * kMaxRep * kWarpTok * 4 + 16;
}

// stage copies: K then V rows of tokens t0 .. t0 + kTok - 1 (zeros past t_end)
template <int D>
__device__ __forceinline__ void load_stage(const Params& p, __nv_bfloat16* ks, __nv_bfloat16* vs,
                                           const __nv_bfloat16* kbase, const __nv_bfloat16* vbase,
                                           const int* trow, int t0, int t_end) {
    constexpr int kChunks = D / 8;                           // 16-byte pieces of a row
    for (int i = threadIdx.x; i < 2 * kTok * kChunks; i += kThreads) {
        const int side = i / (kTok * kChunks), tok = (i / kChunks) % kTok, c = i % kChunks;
        const int t = t0 + tok;
        const bool ok = t < t_end;
        const __nv_bfloat16* base = side ? vbase : kbase;
        const __nv_bfloat16* src =
            ok ? base + ((size_t)trow[t / p.ps] * p.ps + t % p.ps) * D + c * 8 : base;
        __nv_bfloat16* dst = (side ? vs : ks) + tok * D + c * 8;
        cp_async16(smem_u32(dst), src, ok ? 16 : 0);
    }
}

// At most 170 registers a thread, so that three blocks share an SM: at
// lengths up to 2047 that measured 0.037 ms against 0.052 at 203 registers,
// and at lengths up to 8191 0.166 against 0.158 (scripts/torch_paged_variants.py,
// H100 80GB HBM3, 700 W).
template <int D>
__global__ void __launch_bounds__(kThreads, 3) paged_decode_kernel(Params p) {
    constexpr int LPR = D / 8;                               // lanes per k row
    constexpr int TPI = 32 / LPR;                            // tokens a warp scores at once
    constexpr int DPL = D / 32;                              // P·V columns per lane
    extern __shared__ __align__(128) unsigned char smem[];
    __nv_bfloat16* kring = reinterpret_cast<__nv_bfloat16*>(smem);      // [S][kTok][D]
    __nv_bfloat16* vring = kring + kStages * kTok * D;                  // [S][kTok][D]
    float* sc = reinterpret_cast<float*>(vring + kStages * kTok * D);   // [warp][rep][kWarpTok]
    int* last_flag = reinterpret_cast<int*>(sc + kWarps * kMaxRep * kWarpTok);

    const int kvh = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
    const int rep = p.Hq / p.Hkv;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int len = min(p.lengths[b], p.pps * p.ps);
    const int span = p.per_split * p.ps;
    const int live = min(p.splits, (len + span - 1) / span);  // splits that hold tokens
    if (sp >= live) return;                                  // neither works nor arrives
    const int t_begin = sp * span, t_end = min(len, t_begin + span);
    const int steps = (t_end - t_begin + kTok - 1) / kTok;
    const float sl2 = 1.4426950408889634f / sqrtf((float)D);  // log2(e) / √D

    const __nv_bfloat16* kbase = p.kp + (size_t)kvh * p.P * p.ps * D;
    const __nv_bfloat16* vbase = p.vp + (size_t)kvh * p.P * p.ps * D;
    const int* trow = p.table + (size_t)b * p.pps;
    const int h0 = kvh * rep;                                // first q head of the block

    for (int s = 0; s < kStages - 1; ++s) {
        if (s < steps)
            load_stage<D>(p, kring + s * kTok * D, vring + s * kTok * D, kbase, vbase, trow,
                          t_begin + s * kTok, t_end);
        cp_async_commit();
    }

    // this lane's slice of every q head: columns 8 (lane % LPR) .. + 7
    const int sub = lane % LPR, tk = lane / LPR;
    float qf[kMaxRep][8];
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
        if (r < rep) {
            const uint4 w = *reinterpret_cast<const uint4*>(p.q + ((size_t)b * p.Hq + h0 + r) * D + sub * 8);
            const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float2 f = __bfloat1622float2(h2[j]);
                qf[r][2 * j] = f.x;
                qf[r][2 * j + 1] = f.y;
            }
        } else {
#pragma unroll
            for (int j = 0; j < 8; ++j) qf[r][j] = 0.f;
        }
    }
    float m[kMaxRep], l[kMaxRep], acc[kMaxRep][DPL];
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
        m[r] = -INFINITY;
        l[r] = 0.f;
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;
    }
    float* scw = sc + warp * kMaxRep * kWarpTok;

    for (int it = 0; it < steps; ++it) {
        // stage it has landed; every warp is done with stage it - 1
        cp_async_wait_n(kStages - 2);
        __syncthreads();
        const int nxt = it + kStages - 1;
        if (nxt < steps)
            load_stage<D>(p, kring + (nxt % kStages) * kTok * D, vring + (nxt % kStages) * kTok * D,
                          kbase, vbase, trow, t_begin + nxt * kTok, t_end);
        cp_async_commit();
        const __nv_bfloat16* ks = kring + (it % kStages) * kTok * D + warp * kWarpTok * D;
        const __nv_bfloat16* vs = vring + (it % kStages) * kTok * D + warp * kWarpTok * D;
        const int t_warp = t_begin + it * kTok + warp * kWarpTok;   // the warp's first token

        // scores of the warp's tokens, scaled to base 2; -inf past t_end
#pragma unroll
        for (int i = 0; i < kWarpTok / TPI; ++i) {
            const int j = i * TPI + tk;
            const uint4 w = *reinterpret_cast<const uint4*>(ks + j * D + sub * 8);
            const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&w);
            float kf[8];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float2 f = __bfloat1622float2(h2[e]);
                kf[2 * e] = f.x;
                kf[2 * e + 1] = f.y;
            }
#pragma unroll
            for (int r = 0; r < kMaxRep; ++r) {
                if (r >= rep) break;
                float dot = 0.f;
#pragma unroll
                for (int e = 0; e < 8; ++e) dot = fmaf(qf[r][e], kf[e], dot);
#pragma unroll
                for (int o = LPR / 2; o; o >>= 1) dot += __shfl_xor_sync(kFull, dot, o);
                if (sub == 0) scw[r * kWarpTok + j] = t_warp + j < t_end ? dot * sl2 : -INFINITY;
            }
        }
        __syncwarp();

        // the warp's tokens' values: lane columns DPL * lane .. + DPL - 1
        float vf[kWarpTok][DPL];
#pragma unroll
        for (int j = 0; j < kWarpTok; ++j) {
            const __nv_bfloat16* vr = vs + j * D + lane * DPL;
            if constexpr (DPL == 4) {
                const uint2 w = *reinterpret_cast<const uint2*>(vr);
                const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
                const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
                vf[j][0] = a.x; vf[j][1] = a.y; vf[j][2] = c.x; vf[j][3] = c.y;
            } else {
                const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vr));
                vf[j][0] = a.x; vf[j][1] = a.y;
            }
        }
        // online softmax per head over the warp's tokens, then P·V
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r) {
            if (r >= rep) break;
            float s[kWarpTok], mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < kWarpTok; ++j) {
                s[j] = scw[r * kWarpTok + j];
                mx = fmaxf(mx, s[j]);
            }
            const float m_new = fmaxf(m[r], mx);
            if (m_new == -INFINITY) continue;                // no token of this warp yet
            const float alpha = exp2f(m[r] - m_new);
            float sum = 0.f;
#pragma unroll
            for (int e = 0; e < DPL; ++e) acc[r][e] *= alpha;
#pragma unroll
            for (int j = 0; j < kWarpTok; ++j) {
                const float pj = exp2f(s[j] - m_new);
                sum += pj;
#pragma unroll
                for (int e = 0; e < DPL; ++e) acc[r][e] = fmaf(pj, vf[j][e], acc[r][e]);
            }
            l[r] = fmaf(l[r], alpha, sum);
            m[r] = m_new;
        }
        __syncwarp();                                        // scw is rewritten next stage
    }
    cp_async_wait_n(0);
    __syncthreads();                                         // the ring is free

    // merge the warps' states in warp order: (M, L, A) of the split per head
    float* wm = reinterpret_cast<float*>(smem);              // [warp][rep]: m, then l
    float* wl = wm + kWarps * kMaxRep;
    float* wa = wl + kWarps * kMaxRep;                       // [warp][rep][D]
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
        if (r >= rep) break;
        if (lane == 0) {
            wm[warp * kMaxRep + r] = m[r];
            wl[warp * kMaxRep + r] = l[r];
        }
#pragma unroll
        for (int e = 0; e < DPL; ++e) wa[(warp * kMaxRep + r) * D + lane * DPL + e] = acc[r][e];
    }
    __syncthreads();
    const size_t bh0 = (size_t)b * p.Hq + h0;
    for (int i = threadIdx.x; i < rep * D; i += kThreads) {
        const int r = i / D, d = i % D;
        float M = -INFINITY;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wm[w * kMaxRep + r]);
        float L = 0.f, A = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
            const float c = exp2f(wm[w * kMaxRep + r] - M);  // 0 for a warp without tokens
            L = fmaf(wl[w * kMaxRep + r], c, L);
            A = fmaf(wa[(w * kMaxRep + r) * D + d], c, A);
        }
        if (live == 1) {
            p.out[(bh0 + r) * D + d] = __float2bfloat16_rn(A / L);
        } else {
            const size_t o = (bh0 + r) * p.splits + sp;
            p.acc_ws[o * D + d] = A;
            if (d == 0) {
                p.ml_ws[o * 2] = M;
                p.ml_ws[o * 2 + 1] = L;
            }
        }
    }
    if (live == 1) return;

    // the last live split of the slot merges the partials in split order
    __threadfence();
    __syncthreads();
    int* counter = p.counters + (size_t)b * p.Hkv + kvh;
    if (threadIdx.x == 0) *last_flag = atomicAdd(counter, 1) == live - 1;
    __syncthreads();
    if (!*last_flag) return;
    __threadfence();
    float* cw = reinterpret_cast<float*>(smem);              // [rep][kMaxSplits]: weights
    float* den = cw + kMaxRep * kMaxSplits;                  // [rep]
    if (threadIdx.x < rep) {
        const size_t o = (bh0 + threadIdx.x) * p.splits;
        float M = -INFINITY;
        for (int s = 0; s < live; ++s) M = fmaxf(M, __ldcg(p.ml_ws + (o + s) * 2));
        float l = 0.f;
        for (int s = 0; s < live; ++s) {
            const float c = exp2f(__ldcg(p.ml_ws + (o + s) * 2) - M);
            cw[threadIdx.x * kMaxSplits + s] = c;
            l = fmaf(c, __ldcg(p.ml_ws + (o + s) * 2 + 1), l);
        }
        den[threadIdx.x] = l;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rep * D; i += kThreads) {
        const int r = i / D, d = i % D;
        const float* a = p.acc_ws + (bh0 + r) * p.splits * D + d;
        float num = 0.f;
#pragma unroll 4
        for (int s = 0; s < live; ++s) num = fmaf(cw[r * kMaxSplits + s], __ldcg(a + (size_t)s * D), num);
        p.out[(bh0 + r) * D + d] = __float2bfloat16_rn(num / den[r]);
    }
    if (threadIdx.x == 0) *counter = 0;
}

template <int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
    constexpr int bytes = smem_bytes<D>();
    static std::atomic<unsigned> ready{0};                   // a bit per device: attribute set
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (!(ready.load() & (1u << dev))) {
        err = cudaFuncSetAttribute(paged_decode_kernel<D>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (err != cudaSuccess) return err;
        ready.fetch_or(1u << dev);
    }
    paged_decode_kernel<D><<<dim3(p.Hkv, B, p.splits), kThreads, bytes, stream>>>(p);
    return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; lengths[b] >= 1. acc (B, Hq, splits, D) and ml (B, Hq,
// splits, 2) float32 hold the partials of slots that span several splits;
// counters (B, Hkv) int32 are 0 and left 0. One launch. Returns the
// cudaError_t.
extern "C" int gl_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                               const void* lengths, const void* table, void* acc, void* ml,
                               void* counters, void* out, int B, int Hq, int Hkv, int D, int P,
                               int ps, int pps, int splits, int per_split, void* stream_ptr) {
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if (Hq % Hkv || Hq / Hkv > kMaxRep || splits < 1 || splits > kMaxSplits ||
        (long long)splits * per_split < pps ||
        (splits > 1 && (acc == nullptr || ml == nullptr || counters == nullptr)))
        return static_cast<int>(cudaErrorInvalidValue);
    const Params p{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pages),
                   static_cast<const __nv_bfloat16*>(v_pages), static_cast<const int*>(lengths),
                   static_cast<const int*>(table), static_cast<float*>(acc),
                   static_cast<float*>(ml), static_cast<int*>(counters),
                   static_cast<__nv_bfloat16*>(out), Hq, Hkv, P, ps, pps, splits, per_split};
    if (D == 64) return static_cast<int>(launch<64>(p, B, stream));
    if (D == 128) return static_cast<int>(launch<128>(p, B, stream));
    return static_cast<int>(cudaErrorInvalidValue);
}
