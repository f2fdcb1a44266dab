// SPDX-License-Identifier: Apache-2.0
// Causal flash attention for a prefill from cache offset 0:
//   out = softmax(q kᵀ / √D, causal) v
// q (B, S, Hq, D), k/v (B, S, Hkv, D), out (B, S, Hq, D), all bf16; D = 64 or 128.
//
// Replaces the jax-shipped Pallas TPU kernel `flash_attention`
// (jax.experimental.pallas.ops.tpu.flash_attention), which the JAX package
// borrows at gemlite_tpu/models/llama.py:_attention_flash_causal.
//
// What bounds it: each k/v row staged in shared memory feeds the 64 query
// rows of the block, so at S >= 256 the causal products, 2·B·Hq·S²·D flops,
// over the bf16 tensor-core rate bound it, not the bytes of q, k, v and out.
// Design:
//   * one block per (64-row query tile, q head, batch row), four warps of 16
//     query rows; the heaviest tiles (those nearest the end of the sequence)
//     are launched first;
//   * GQA: the block reads the k/v rows of kv head = q head / (Hq / Hkv);
//     nothing is copied per q head;
//   * the block walks 64-row key/value tiles in order, from key 0 to its
//     diagonal tile, and masks only the diagonal tile;
//   * Q Kᵀ and P V run on mma.sync m16n8k16 bf16 tensor cores with float32
//     accumulators; each warp keeps its query fragments in registers, and the
//     score fragment becomes the A operand of P V in registers, so scores
//     never touch shared or device memory;
//   * P is split into a bf16 high part and a bf16 low part (P - hi), and
//     P V takes one product of each: P keeps about 16 bits. With P rounded
//     once to bf16, the near-uniform softmax of a model's first layer came
//     out 5.5e-3 (mean relative) from the float32 path after one block;
//   * online softmax in float32, a running max and sum per row; the float32
//     scores are scaled by 1/√D (folded with log2(e) for exp2);
//   * each query tile belongs to one block and sums its key tiles in a fixed
//     order, so the result is deterministic.
// Left for later: wgmma, TMA and a cp.async double buffer; V is transposed
// into shared memory with 2-byte stores instead of ldmatrix.trans.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;              // query rows per block, key rows per tile
constexpr int kWarps = kTile / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;                // bf16 padding per shared-memory row
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) as a bf16 pair `hi` and the pair of what rounding left over, `lo`
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
    __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 r = __bfloat1622float2(h);
    __nv_bfloat162 l = __floats2bfloat162_rn(a - r.x, b - r.y);
    hi = *reinterpret_cast<uint32_t*>(&h);
    lo = *reinterpret_cast<uint32_t*>(&l);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// c += a (16x16, row-major) * b (16x8, column-major), bf16 in, float32 out
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                      int S, int Hq, int Hkv) {
    constexpr int KS = D / 16;   // k-steps of Q Kᵀ
    constexpr int DN = D / 8;    // n-tiles of P V
    constexpr int C8 = D / 8;    // 16-byte chunks of a row
    __shared__ __align__(16) __nv_bfloat16 Ks[kTile][D + kPad];
    __shared__ __align__(16) __nv_bfloat16 Vt[D][kTile + kPad];

    const int qt = gridDim.x - 1 - blockIdx.x;
    const int h = blockIdx.y, b = blockIdx.z;
    const int kvh = h / (Hq / Hkv);
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int q0 = qt * kTile, wr = warp * 16;
    const size_t q_row = (size_t)Hq * D, kv_row = (size_t)Hkv * D;
    const __nv_bfloat16* qb = q + (size_t)b * S * q_row + (size_t)h * D;
    const __nv_bfloat16* kb = k + (size_t)b * S * kv_row + (size_t)kvh * D;
    const __nv_bfloat16* vb = v + (size_t)b * S * kv_row + (size_t)kvh * D;

    // the query tile goes through Ks once; each warp keeps its A fragments
    for (int i = tid; i < kTile * C8; i += kThreads) {
        const int r = i / C8, c = (i % C8) * 8;
        *reinterpret_cast<uint4*>(&Ks[r][c]) =
            *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * q_row + c);
    }
    __syncthreads();
    uint32_t qa[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
        const int c = kk * 16 + t4 * 2;
        qa[kk][0] = ld32(&Ks[wr + g][c]);
        qa[kk][1] = ld32(&Ks[wr + g + 8][c]);
        qa[kk][2] = ld32(&Ks[wr + g][c + 8]);
        qa[kk][3] = ld32(&Ks[wr + g + 8][c + 8]);
    }
    __syncthreads();

    float o[DN][4];
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
    const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
    const int row0 = q0 + wr + g, row1 = row0 + 8;     // this thread's two query rows

    for (int kt = 0; kt <= qt; ++kt) {
        const int k0 = kt * kTile;
        // K rows as they are; V transposed (Vt[d][key]) for the B operand of P V
        for (int i = tid; i < kTile * C8; i += kThreads) {
            const int r = i / C8, c = (i % C8) * 8;
            *reinterpret_cast<uint4*>(&Ks[r][c]) =
                *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + r) * kv_row + c);
        }
        for (int i = tid; i < kTile * C8; i += kThreads) {
            const int r = i % kTile, c = (i / kTile) * 8;
            const uint4 w = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * kv_row + c);
            const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
            for (int j = 0; j < 8; ++j) Vt[c + j][r] = e[j];
        }
        __syncthreads();

        // S = Q Kᵀ: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys
        float s[8][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
            s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
            for (int kk = 0; kk < KS; ++kk) {
                const int c = kk * 16 + t4 * 2;
                mma_bf16(s[nt], qa[kk], ld32(&Ks[nt * 8 + g][c]), ld32(&Ks[nt * 8 + g][c + 8]));
            }
        }
        // scale in float32 (log2 domain), mask the diagonal tile, row max
        float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float x = s[nt][e] * scale_log2;
                if (kt == qt && k0 + nt * 8 + t4 * 2 + (e & 1) > (e < 2 ? row0 : row1))
                    x = -INFINITY;
                s[nt][e] = x;
                mx[e >> 1] = fmaxf(mx[e >> 1], x);
            }
        }
        float alpha[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {      // the four threads of a row share its max
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
            alpha[i] = exp2f(m_run[i] - mx[i]);
            m_run[i] = mx[i];
            l_run[i] *= alpha[i];
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                s[nt][e] = exp2f(s[nt][e] - m_run[e >> 1]);
                l_run[e >> 1] += s[nt][e];
            }
        }
#pragma unroll
        for (int dn = 0; dn < DN; ++dn) {
            o[dn][0] *= alpha[0];
            o[dn][1] *= alpha[0];
            o[dn][2] *= alpha[1];
            o[dn][3] *= alpha[1];
        }
        // O += P V, P's accumulator fragments reused as A fragments (hi and lo)
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
            uint32_t hi[4], lo[4];
            split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
            split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
            split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
            split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
            const int c = kk * 16 + t4 * 2;
#pragma unroll
            for (int dn = 0; dn < DN; ++dn) {
                const uint32_t b0 = ld32(&Vt[dn * 8 + g][c]), b1 = ld32(&Vt[dn * 8 + g][c + 8]);
                mma_bf16(o[dn], hi, b0, b1);
                mma_bf16(o[dn], lo, b0, b1);
            }
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        l_run[i] += __shfl_xor_sync(kFull, l_run[i], 1);
        l_run[i] += __shfl_xor_sync(kFull, l_run[i], 2);
    }
    const float inv0 = 1.f / l_run[0], inv1 = 1.f / l_run[1];
    __nv_bfloat16* ob = out + (size_t)b * S * q_row + (size_t)h * D;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
        const int c = dn * 8 + t4 * 2;
        *reinterpret_cast<uint32_t*>(ob + (size_t)row0 * q_row + c) =
            pack_bf16(o[dn][0] * inv0, o[dn][1] * inv0);
        *reinterpret_cast<uint32_t*>(ob + (size_t)row1 * q_row + c) =
            pack_bf16(o[dn][2] * inv1, o[dn][3] * inv1);
    }
}

}  // namespace

// Launch on `stream`; S % 64 == 0, Hq % Hkv == 0, D in {64, 128}, 16-byte
// aligned contiguous tensors. Returns the cudaError_t.
extern "C" int gl_flash_attention(const void* q, const void* k, const void* v, void* out,
                                  int B, int S, int Hq, int Hkv, int D, void* stream_ptr) {
    const dim3 grid(S / kTile, Hq, B);
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const auto* qp = static_cast<const __nv_bfloat16*>(q);
    const auto* kp = static_cast<const __nv_bfloat16*>(k);
    const auto* vp = static_cast<const __nv_bfloat16*>(v);
    auto* op = static_cast<__nv_bfloat16*>(out);
    if (D == 64)
        flash_attn_fwd_kernel<64><<<grid, kThreads, 0, stream>>>(qp, kp, vp, op, S, Hq, Hkv);
    else if (D == 128)
        flash_attn_fwd_kernel<128><<<grid, kThreads, 0, stream>>>(qp, kp, vp, op, S, Hq, Hkv);
    else
        return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
}
