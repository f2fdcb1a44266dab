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
// What bounds it: every live k and v row is read once for 2·rep·D flops per
// row, far below the card's flops per byte, so the bytes of the live pages
// (Σ_b lengths[b]·Hkv·D·2·2, plus q and out) over the memory rate bound it.
// Design:
//   * grid (kv head, slot, split); one block serves the Hq / Hkv q heads that
//     share a kv head, so each k/v page row is read once for all of them;
//   * each split walks a fixed range of the slot's pages through the table,
//     up to lengths[b], so only ceil(lengths[b] / ps) pages are read; splits
//     past the slot's length exit at once;
//   * per 64-token chunk: one thread per token forms the float32 dot products
//     with every q head (scores scaled by 1/√D in float32), a warp per head
//     updates the running max and sum, then thread d accumulates column d;
//   * each split writes its partial (max, sum, acc) to a workspace, and a
//     second launch combines the splits in split order, with no atomics;
//   * the split count depends only on pages_per_seq (ops/attention.py
//     paged_split_plan), so a slot's bits do not depend on the batch, the
//     other slots' lengths or the page ids it was given.
// The head-dim limit of the TPU call (D % 128) was a Mosaic alignment limit,
// not part of the function: D = 64 runs here too.
// Left for later: 16-byte loads spread over a warp for the k rows, bf16x2
// value loads, and a single launch when the slot fits one split.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;     // tokens per chunk
constexpr int kMaxRep = 8;     // q heads per kv head
constexpr unsigned kFull = 0xffffffffu;

template <int D>
__global__ void __launch_bounds__(D)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
                    const __nv_bfloat16* __restrict__ vp, const int* __restrict__ lengths,
                    const int* __restrict__ table, float* __restrict__ acc_ws,
                    float* __restrict__ ml_ws, int Hq, int Hkv, int P, int ps, int pps,
                    int splits, int per_split) {
    constexpr int kWarps = D / 32;
    __shared__ float qs[kMaxRep][D];
    __shared__ float prob[kMaxRep][kChunk];   // scores, then probabilities
    __shared__ int rows[kChunk];              // page row of each token of the chunk
    __shared__ float m_s[kMaxRep], l_s[kMaxRep], alpha_s[kMaxRep];

    const int kvh = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
    const int rep = Hq / Hkv;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int len = min(lengths[b], pps * ps);
    const int t_begin = sp * per_split * ps;
    const int t_end = min(len, (sp + 1) * per_split * ps);

    const __nv_bfloat16* qb = q + ((size_t)b * Hq + (size_t)kvh * rep) * D;
    for (int i = tid; i < rep * D; i += D) qs[i / D][i % D] = __bfloat162float(qb[i]);
    if (tid < kMaxRep) {
        m_s[tid] = -INFINITY;
        l_s[tid] = 0.f;
    }
    float acc[kMaxRep];
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) acc[r] = 0.f;
    const float scale = 1.f / sqrtf((float)D);
    const __nv_bfloat16* kbase = kp + (size_t)kvh * P * ps * D;
    const __nv_bfloat16* vbase = vp + (size_t)kvh * P * ps * D;
    const int* trow = table + (size_t)b * pps;
    __syncthreads();

    for (int c0 = t_begin; c0 < t_end; c0 += kChunk) {
        const int n = min(kChunk, t_end - c0);
        // scores: one thread per token, every q head of the kv head
        for (int i = tid; i < n; i += D) {
            const int t = c0 + i;
            const int row = trow[t / ps] * ps + t % ps;
            rows[i] = row;
            const uint4* kr = reinterpret_cast<const uint4*>(kbase + (size_t)row * D);
            float dot[kMaxRep];
#pragma unroll
            for (int r = 0; r < kMaxRep; ++r) dot[r] = 0.f;
            // a bounded unroll: a full one hoists every q load and spills
#pragma unroll 2
            for (int c = 0; c < D / 8; ++c) {
                const uint4 w = kr[c];
                const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const float2 f = __bfloat1622float2(h2[j]);
#pragma unroll
                    for (int r = 0; r < kMaxRep; ++r) {
                        if (r < rep) {
                            dot[r] = fmaf(qs[r][c * 8 + 2 * j], f.x, dot[r]);
                            dot[r] = fmaf(qs[r][c * 8 + 2 * j + 1], f.y, dot[r]);
                        }
                    }
                }
            }
#pragma unroll
            for (int r = 0; r < kMaxRep; ++r)
                if (r < rep) prob[r][i] = dot[r] * scale;
        }
        __syncthreads();
        // online softmax: warp w updates heads w, w + kWarps, ...
        for (int r = warp; r < rep; r += kWarps) {
            float mx = -INFINITY;
            for (int i = lane; i < n; i += 32) mx = fmaxf(mx, prob[r][i]);
#pragma unroll
            for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
            const float m_new = fmaxf(m_s[r], mx);
            float sum = 0.f;
            for (int i = lane; i < n; i += 32) {
                const float p = expf(prob[r][i] - m_new);
                prob[r][i] = p;
                sum += p;
            }
#pragma unroll
            for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
            if (lane == 0) {
                const float a = expf(m_s[r] - m_new);
                alpha_s[r] = a;
                l_s[r] = l_s[r] * a + sum;
                m_s[r] = m_new;
            }
        }
        __syncthreads();
        // values: thread d accumulates column d for every head
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r)
            if (r < rep) acc[r] *= alpha_s[r];
#pragma unroll 8
        for (int i = 0; i < n; ++i) {
            const float x = __bfloat162float(vbase[(size_t)rows[i] * D + tid]);
#pragma unroll
            for (int r = 0; r < kMaxRep; ++r)
                if (r < rep) acc[r] = fmaf(prob[r][i], x, acc[r]);
        }
        __syncthreads();
    }

    // this split's partial result; an empty split leaves (-inf, 0, 0)
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
        if (r < rep) {
            const size_t o = ((size_t)b * Hq + (size_t)kvh * rep + r) * splits + sp;
            acc_ws[o * D + tid] = acc[r];
            if (tid == 0) {
                ml_ws[o * 2] = m_s[r];
                ml_ws[o * 2 + 1] = l_s[r];
            }
        }
    }
}

// one block per (slot, q head), thread d: the splits combined in split order
template <int D>
__global__ void __launch_bounds__(D)
paged_combine_kernel(const float* __restrict__ acc_ws, const float* __restrict__ ml_ws,
                     __nv_bfloat16* __restrict__ out, int splits) {
    const size_t bh = blockIdx.x;
    const int d = threadIdx.x;
    const float* ml = ml_ws + bh * splits * 2;
    float m = -INFINITY;
    for (int s = 0; s < splits; ++s) m = fmaxf(m, ml[2 * s]);
    float num = 0.f, den = 0.f;
    for (int s = 0; s < splits; ++s) {
        if (ml[2 * s] == -INFINITY) continue;
        const float w = expf(ml[2 * s] - m);
        num = fmaf(w, acc_ws[(bh * splits + s) * D + d], num);
        den = fmaf(w, ml[2 * s + 1], den);
    }
    out[bh * D + d] = __float2bfloat16_rn(num / den);
}

template <int D>
int launch(const void* q, const void* k_pages, const void* v_pages, const void* lengths,
           const void* table, void* acc, void* ml, void* out, int B, int Hq, int Hkv, int P,
           int ps, int pps, int splits, int per_split, cudaStream_t stream) {
    paged_decode_kernel<D><<<dim3(Hkv, B, splits), D, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pages),
        static_cast<const __nv_bfloat16*>(v_pages), static_cast<const int*>(lengths),
        static_cast<const int*>(table), static_cast<float*>(acc), static_cast<float*>(ml), Hq,
        Hkv, P, ps, pps, splits, per_split);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    paged_combine_kernel<D><<<B * Hq, D, 0, stream>>>(
        static_cast<const float*>(acc), static_cast<const float*>(ml),
        static_cast<__nv_bfloat16*>(out), splits);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch both kernels on `stream`; lengths[b] >= 1. acc is (B, Hq, splits,
// D) and ml (B, Hq, splits, 2) float32 scratch. Returns the cudaError_t.
extern "C" int gl_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                               const void* lengths, const void* table, void* acc, void* ml,
                               void* out, int B, int Hq, int Hkv, int D, int P, int ps, int pps,
                               int splits, int per_split, void* stream_ptr) {
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if (D == 64)
        return launch<64>(q, k_pages, v_pages, lengths, table, acc, ml, out, B, Hq, Hkv, P, ps,
                          pps, splits, per_split, stream);
    if (D == 128)
        return launch<128>(q, k_pages, v_pages, lengths, table, acc, ml, out, B, Hq, Hkv, P, ps,
                           pps, splits, per_split, stream);
    return static_cast<int>(cudaErrorInvalidValue);
}
