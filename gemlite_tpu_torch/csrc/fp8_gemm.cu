// SPDX-License-Identifier: Apache-2.0
// fp8 weights (W8 bit codes, e4m3 or e5m2, four to an int32 word) times bf16
// or fp8 activations: out (M, N) bf16 = epilogue(x (M, K) . W), the fp8
// weights summed as true values against x in float32, W_group_mode 0 or 2
// (one group: a column scale on the sum), then csm 1 / 2 / 3. One launch a
// call. The plain version is ops/reference.forward_fp8_ref.
//
// Three entries share two bodies:
//   gl_fp8_decode          M <= 64: replaces gemlite_tpu/ops/pallas_decode.py:
//                          pallas_decode_matmul on fp8-coded layers;
//   gl_fp8_decode_stacked  layer l of an L-layer stack, the index read on the
//                          device: replaces gemlite_tpu/ops/pallas_scan.py:
//                          pallas_decode_matmul_stacked on the same layers,
//                          with the per-layer entry's plan, so the two agree
//                          bit for bit;
//   gl_fp8_prefill         64 < M < 4096: replaces gemlite_tpu/ops/
//                          pallas_prefill.py:pallas_prefill_matmul on them.
//
// The word format: code k of column n is byte k % 4 of word (k / 4, n), so a
// word holds four consecutive k of one column, which is exactly what one
// register of the 8-bit tensor-core A fragment holds (row g, k 4t .. 4t + 3).
// With fp8 x the weights therefore feed mma / wgmma as they are stored: no
// byte moves, no conversion. With bf16 x each pair of codes is converted
// exactly to bf16 (cvt to f16x2, which holds every e4m3 and e5m2 value, then
// f32 and one exact rounding to bf16) and the products run on bf16.
//
// The decode body (what bounds it: the K N weight bytes, 17.5 us at 3.35
// TB/s for 14336 x 4096) is rows 1 and 4's design after PRs 8 and 9: the
// operands swapped (out^T = W^T . x^T: A a 16-column tile of W, B the M <= 64
// tokens as n8 tiles), a cp.async ring of 128-deep stages (the words column-
// swizzled so that a warp's 4-byte reads hit 32 banks, x rows swizzled in
// 16-byte chunks), K split over gridDim.y so that the grid fits the card in
// one wave of kDecodeMinBlocks blocks an SM (ops/fp8.decode_plan: a longer
// grid ran its last 13-29% of blocks on an idle card; 256-column blocks, with
// 1 KB runs a word row, streamed no faster; PERF.md), the splits merged by the
// last block of each column tile in split order
// (arrival counters left at 0). fp8 x runs mma.sync m16n8k32 with e4m3 /
// e5m2 operands (all four type pairs); bf16 x two m16n8k16 bf16 products a
// 32-deep block, the k order permuted inside it so that a lane converts whole
// words (lane t takes k 4t .. 4t + 3 and 16 + 4t .. 16 + 4t + 3; x is read to
// match). The fp8 tensor cores keep fewer accumulator bits than float32
// (DeepSeek-V3 report, 3.3.2): each 128-deep stage's fp8 products sum into a
// fresh fragment that is then added to the float32 sums.
//
// The prefill body (what bounds it: operations, 2 M N K over 1,979 TFLOP/s
// fp8 or 989 bf16) is row 2's design: a producer lane brings the x box (TMA,
// 128-byte swizzle, rows past M read as zeros) and the stage's word rows (one
// TMA box; with fp8 x four 32-column groups in the 128-byte swizzle,
// w_groups) into a ring; two consumer warpgroups of 64 weight columns run
// wgmma with the weights as the register A operand and x as the K-major
// shared B operand, the block's rows one (128) or two (256, as
// ops/fp8.prefill_rows picks) n128 products an A fragment. With fp8 x a
// warp's A rows take the weight columns p_col gives, so that with the
// groups' swizzle the 32 lanes of every A-fragment read hit 32 banks. fp8 x:
// 128-deep stages of m64n128k32 e4m3 / e5m2 products into a fresh
// accumulator, added to the float32 sums after each stage (the same
// promotion as the decode body; with 256 rows the first 128 rows' products,
// then the second's, in the one fresh fragment); bf16 x: 64-deep stages of
// m64n128k16 bf16 products on the converted codes. A stage's A fragments
// for the next stage are read (fp8) or built (bf16) while its products run.
// K is split by ops/fp8.prefill_plan and merged in the same launch. The grid
// runs a column tile's row tiles side by side, so they share its words in
// L2.
#include <cuda_fp8.h>

#include <atomic>

#include "gl_common.cuh"
#include "sm90_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using gl::cp_async16;
using gl::cp_async_commit;
using gl::cp_async_wait_n;
using gl::smem_u32;

enum XKind { kXbf16 = 0, kXe4m3 = 1, kXe5m2 = 2 };   // the activations
// the weight codes: 0 e4m3, 1 e5m2

// ---------------------------------------------------------------------------
// Shared pieces
// ---------------------------------------------------------------------------

// The epilogue on a float32 sum (forward_fp8_ref): mode 2 * s[n], then csm 2
// / 3 * sx[m], then csm 1 / 3 * s[n], each multiply rounded in float32.
struct Epi {
    const void* scales;       // (N) float32 or bf16 column scales, or null
    const float* sx;          // (M) per-token scales, or null
    int s_code;               // gl::kF32 or gl::kBF16
    int pre;                  // W_group_mode 2: the scale on the sum
    int csm;
};

__device__ __forceinline__ float epi_apply(const Epi& e, const void* scales, float v, int m,
                                           int n) {
    if (e.pre) v = __fmul_rn(v, gl::load_meta(scales, n, e.s_code));
    if (e.csm == 2 || e.csm == 3) v = __fmul_rn(v, e.sx[m]);
    if (e.csm == 1 || e.csm == 3) v = __fmul_rn(v, gl::load_meta(scales, n, e.s_code));
    return v;
}

// bytes 0 and 1 of `two` (fp8 codes of type W) -> bf16x2 (byte 0 low), exact
template <int W>
__device__ __forceinline__ uint32_t fp8x2_bf16x2(uint32_t two) {
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(two & 0xFFFFu), W ? __NV_E5M2 : __NV_E4M3);
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

#define GL_MMA_FP8(TA, TB)                                                                     \
    asm volatile("mma.sync.aligned.m16n8k32.row.col.f32." TA "." TB ".f32 {%0, %1, %2, %3}, " \
                 "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"                           \
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])                              \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1))

// d += a (16 x 32, row; codes of type W) . b (32 x 8, col; x of kind X), fp8
// in, float32 sums
template <int W, int X>
__device__ __forceinline__ void mma_fp8(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
    if constexpr (W == 0 && X == kXe4m3) GL_MMA_FP8("e4m3", "e4m3");
    else if constexpr (W == 0 && X == kXe5m2) GL_MMA_FP8("e4m3", "e5m2");
    else if constexpr (W == 1 && X == kXe4m3) GL_MMA_FP8("e5m2", "e4m3");
    else GL_MMA_FP8("e5m2", "e5m2");
}
#undef GL_MMA_FP8

// ---------------------------------------------------------------------------
// Decode, M <= 64 (per-layer and stacked)
// ---------------------------------------------------------------------------

constexpr int BK = 128;                  // K per ring stage
constexpr int BN = 128;                  // output columns per block: 4 warps of 32
constexpr int WR = BK / 4;               // word rows a stage
constexpr int kDecodeMinBlocks = 3;      // blocks an SM: ops/fp8.DECODE_BLOCKS_PER_SM
constexpr int kMaxStages = 6;
constexpr int kDecodeSmemMax = 112 * 1024;

struct DParams {
    const void* x;                       // (M, K) bf16 / fp8
    const uint32_t* wq;                  // ([L,] K / 4, N)
    const void* scales;                  // ([L,] N) or null
    const int* layer_idx;                // stacked entry: the layer, on the device
    int L;
    Epi epi;
    bf16* out;                           // (M, N)
    float* part;                         // (splits, M, N) float32 partials
    int* counters;                       // one per column tile, 0 between calls
    int M, N, K, k_per_split, stages;
};

__host__ __device__ constexpr int d_words_bytes() { return WR * BN * 4; }
__host__ __device__ constexpr int d_stage_bytes(int nt, int xb) {
    return d_words_bytes() + nt * 8 * BK * xb;
}

// word (r, c) of a stage: bits 3-4 of c flipped by r, so that the lanes of a
// warp (rows t, columns g and g + 8 of two m16 tiles) hit 32 banks and a
// 16-byte piece (4 columns) stays whole
__device__ __forceinline__ int w_idx(int r, int c) { return r * BN + (c ^ ((r & 3) << 3)); }
// byte offset of 16-byte chunk c of x row m (rows of BK * XB bytes)
template <int XB>
__device__ __forceinline__ int x_off(int m, int c) { return m * BK * XB + ((c ^ (m & 7)) << 4); }

template <int NT, int XB>
__device__ __forceinline__ void d_load_stage(const DParams& p, const uint32_t* wq,
                                             unsigned char* st, int n0, int k0) {
    uint32_t* ws = reinterpret_cast<uint32_t*>(st);
    unsigned char* xs = st + d_words_bytes();
    const int t = threadIdx.x;
    const uint32_t* wg = wq + (size_t)(k0 / 4) * p.N + n0;
    for (int i = t; i < WR * (BN / 4); i += BN) {
        const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
        cp_async16(smem_u32(ws + w_idx(r, c)), wg + (size_t)r * p.N + c, 16);
    }
    constexpr int CH = BK * XB / 16;     // 16-byte chunks a row
    const unsigned char* x = static_cast<const unsigned char*>(p.x);
    for (int i = t; i < NT * 8 * CH; i += BN) {
        const int m = i / CH, c = i % CH;
        const bool ok = m < p.M;
        cp_async16(smem_u32(xs + x_off<XB>(m, c)),
                   ok ? x + ((size_t)m * p.K + k0) * XB + 16 * c : x, ok ? 16 : 0);
    }
}

// One stage's products for one warp: columns wn0 + 16 i + (0..15), token tiles
// jj < nt. acc[i][jj][r]: column wn0 + 16 i + g + 8 (r / 2), token 8 jj + 2t +
// r % 2. Lane (g, t) takes word rows 8 kb + t and 8 kb + t + 4 of each 32-deep
// block kb (k 32 kb + 4t .. + 3 and 32 kb + 16 + 4t .. + 3).
template <int NT, int X, int W>
__device__ __forceinline__ void d_compute_stage(const unsigned char* st, int nt, int wn0, int lane,
                                                float (&acc)[2][NT][4]) {
    const uint32_t* ws = reinterpret_cast<const uint32_t*>(st);
    const unsigned char* xs = st + d_words_bytes();
    const int g = lane >> 2, t = lane & 3;
    if constexpr (X == kXbf16) {
#pragma unroll
        for (int kb = 0; kb < BK / 32; ++kb) {
            const int r0 = 8 * kb + t;
            uint32_t a[2][2][4];                         // [product j][m16 tile i][register]
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int c = wn0 + 16 * i + 8 * h + g;
#pragma unroll
                    for (int j = 0; j < 2; ++j) {
                        const uint32_t w = ws[w_idx(r0 + 4 * j, c)];
                        a[j][i][h] = fp8x2_bf16x2<W>(w);           // k 4t, 4t + 1 (+ 16 j)
                        a[j][i][2 + h] = fp8x2_bf16x2<W>(w >> 16);  // k 4t + 2, 4t + 3
                    }
                }
#pragma unroll
            for (int jj = 0; jj < NT; ++jj) {
                if (jj >= nt) break;
                const int m = 8 * jj + g;
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    // x[m][32 kb + 16 j + 4t .. + 3]: bytes 64 kb + 32 j + 8t
                    const uint2 xv = *reinterpret_cast<const uint2*>(
                        xs + x_off<2>(m, 4 * kb + 2 * j + (t >> 1)) + 8 * (t & 1));
#pragma unroll
                    for (int i = 0; i < 2; ++i) mma_bf16(acc[i][jj], a[j][i], xv.x, xv.y);
                }
            }
        }
    } else {
        uint32_t a[BK / 32][2][4];                       // [block kb][m16 tile i][register]
#pragma unroll
        for (int kb = 0; kb < BK / 32; ++kb)
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int c = wn0 + 16 * i + 8 * h + g;
                    a[kb][i][h] = ws[w_idx(8 * kb + t, c)];
                    a[kb][i][2 + h] = ws[w_idx(8 * kb + t + 4, c)];
                }
#pragma unroll
        for (int jj = 0; jj < NT; ++jj) {
            if (jj >= nt) break;
            const int m = 8 * jj + g;
            uint32_t b[BK / 32][2];
#pragma unroll
            for (int kb = 0; kb < BK / 32; ++kb)
#pragma unroll
                for (int j = 0; j < 2; ++j)
                    b[kb][j] =
                        *reinterpret_cast<const uint32_t*>(xs + x_off<1>(m, 2 * kb + j) + 4 * t);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                float s[4] = {0.f, 0.f, 0.f, 0.f};       // this stage's fp8 sums, then float32
#pragma unroll
                for (int kb = 0; kb < BK / 32; ++kb) mma_fp8<W, X>(s, a[kb][i], b[kb][0], b[kb][1]);
#pragma unroll
                for (int r = 0; r < 4; ++r) acc[i][jj][r] += s[r];
            }
        }
    }
}

// The block's sums, staged as tile[m][BN]: into the output with the epilogue,
// or with K split the block's partial, and the last block of the column tile
// adds the partials in split order, applies the epilogue and leaves its
// counter at 0. Not inlined: one copy serves every instance.
__device__ __noinline__ void d_finish(const DParams p, const void* scales, const float* tile,
                                      int* flag) {
    const int n0 = blockIdx.x * BN, split = blockIdx.y, nsplit = gridDim.y;
    const size_t MN = (size_t)p.M * p.N;
    if (nsplit > 1) {
        for (int e = threadIdx.x * 4; e < p.M * BN; e += blockDim.x * 4) {
            const int m = e / BN, n = n0 + e % BN;
            *reinterpret_cast<float4*>(p.part + split * MN + (size_t)m * p.N + n) =
                *reinterpret_cast<const float4*>(tile + e);
        }
        __threadfence();
        __syncthreads();
        if (threadIdx.x == 0) *flag = atomicAdd(p.counters + blockIdx.x, 1) == nsplit - 1;
        __syncthreads();
        if (!*flag) return;
        __threadfence();
    }
    for (int e = threadIdx.x * 4; e < p.M * BN; e += blockDim.x * 4) {
        const int m = e / BN, n = n0 + e % BN;
        const size_t idx = (size_t)m * p.N + n;
        float v[4];
        if (nsplit == 1) {
            const float4 tv = *reinterpret_cast<const float4*>(tile + e);
            v[0] = tv.x, v[1] = tv.y, v[2] = tv.z, v[3] = tv.w;
        } else {
            v[0] = v[1] = v[2] = v[3] = 0.f;
            for (int s0 = 0; s0 < nsplit; s0 += 8) {
                float4 r[8];
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const float4* src = reinterpret_cast<const float4*>(p.part + (s0 + j) * MN + idx);
                    r[j] = s0 + j < nsplit ? __ldcg(src) : make_float4(0.f, 0.f, 0.f, 0.f);
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
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = epi_apply(p.epi, scales, v[i], m, n + i);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
        uint2 pk;
        pk.x = *reinterpret_cast<const uint32_t*>(&lo);
        pk.y = *reinterpret_cast<const uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(p.out + idx) = pk;
    }
    if (nsplit > 1 && threadIdx.x == 0) p.counters[blockIdx.x] = 0;
}

template <int NT, int X, int W>
__device__ __forceinline__ void d_body(const DParams& p, const uint32_t* wq, const void* scales) {
    constexpr int XB = X == kXbf16 ? 2 : 1;
    extern __shared__ __align__(128) unsigned char smem[];
    __shared__ int last_flag;
    const int S = p.stages, SB = d_stage_bytes(NT, XB);
    const int lane = threadIdx.x & 31, wn0 = (threadIdx.x >> 5) * 32;
    const int g = lane >> 2, t = lane & 3;
    const int n0 = blockIdx.x * BN, k_begin = blockIdx.y * p.k_per_split;
    const int steps = (min(p.K, k_begin + p.k_per_split) - k_begin) / BK;
    const int nt = (p.M + 7) / 8;

    float acc[2][NT][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

    for (int s = 0; s < S - 1; ++s) {
        if (s < steps) d_load_stage<NT, XB>(p, wq, smem + s * SB, n0, k_begin + s * BK);
        cp_async_commit();
    }
    for (int it = 0; it < steps; ++it) {
        cp_async_wait_n(S - 2);          // stage it has landed
        __syncthreads();                 // and every warp is done with stage it - 1
        const int nxt = it + S - 1;
        if (nxt < steps) d_load_stage<NT, XB>(p, wq, smem + (nxt % S) * SB, n0, k_begin + nxt * BK);
        cp_async_commit();
        d_compute_stage<NT, X, W>(smem + (it % S) * SB, nt, wn0, lane, acc);
    }
    cp_async_wait_n(0);
    __syncthreads();                     // the ring is free
    float* tile = reinterpret_cast<float*>(smem);   // [M][BN]
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
    d_finish(p, scales, tile, &last_flag);
}

template <int NT, int X, int W>
__global__ void __launch_bounds__(BN, kDecodeMinBlocks) fp8_decode_kernel(DParams p) {
    d_body<NT, X, W>(p, p.wq, p.scales);
}

// wq (L, K / 4, N), scales (L, N); *layer_idx in [0, L)
template <int NT, int X, int W>
__global__ void __launch_bounds__(BN, kDecodeMinBlocks) fp8_decode_stacked_kernel(DParams p) {
    const int l = __ldg(p.layer_idx);
    if (l < 0 || l >= p.L) __trap();     // the caller's index is out of the stack
    const void* s = p.scales == nullptr
                        ? nullptr
                        : static_cast<const unsigned char*>(p.scales) +
                              (size_t)l * p.N * (p.epi.s_code == gl::kF32 ? 4 : 2);
    d_body<NT, X, W>(p, p.wq + (size_t)l * (p.K / 4) * p.N, s);
}

template <int NT, int X, int W>
cudaError_t d_launch(const DParams& p, int splits, cudaStream_t stream) {
    static std::atomic<unsigned> ready{0};
    constexpr int XB = X == kXbf16 ? 2 : 1;
    cudaError_t err = sm90::allow_smem(fp8_decode_kernel<NT, X, W>, kDecodeSmemMax, ready);
    if (err != cudaSuccess) return err;
    static std::atomic<unsigned> ready_stacked{0};
    err = sm90::allow_smem(fp8_decode_stacked_kernel<NT, X, W>, kDecodeSmemMax, ready_stacked);
    if (err != cudaSuccess) return err;
    const int ring = p.stages * d_stage_bytes(NT, XB), tile = p.M * BN * 4;
    const int bytes = ring > tile ? ring : tile;
    if (bytes > kDecodeSmemMax) return cudaErrorInvalidValue;
    const dim3 grid(p.N / BN, splits);
    if (p.layer_idx) fp8_decode_stacked_kernel<NT, X, W><<<grid, BN, bytes, stream>>>(p);
    else fp8_decode_kernel<NT, X, W><<<grid, BN, bytes, stream>>>(p);
    return cudaGetLastError();
}

template <int X, int W>
cudaError_t d_launch_rows(const DParams& p, int splits, cudaStream_t stream) {
    if (p.M <= 8) return d_launch<1, X, W>(p, splits, stream);
    if (p.M <= 16) return d_launch<2, X, W>(p, splits, stream);
    if (p.M <= 32) return d_launch<4, X, W>(p, splits, stream);
    return d_launch<8, X, W>(p, splits, stream);
}

// x_code / w_code / s_code are DType values (x: bf16 2, e4m3 3, e5m2 8;
// codes: e4m3 3, e5m2 8; scales: float32 0, bf16 2)
int x_kind(int x_code) {
    return x_code == gl::kBF16 ? kXbf16 : x_code == 3 ? kXe4m3 : x_code == 8 ? kXe5m2 : -1;
}
int w_kind(int w_code) { return w_code == 3 ? 0 : w_code == 8 ? 1 : -1; }

bool epi_ok(const Epi& e, int mode) {
    return (mode == 0 || mode == 2) && e.csm >= 0 && e.csm <= 3 &&
           (e.s_code == gl::kF32 || e.s_code == gl::kBF16) &&
           ((mode != 2 && e.csm != 1 && e.csm != 3) || e.scales != nullptr) &&
           (e.csm < 2 || e.sx != nullptr);
}

int d_run(DParams p, int x_code, int w_code, int mode, int splits, cudaStream_t stream) {
    const int X = x_kind(x_code), W = w_kind(w_code);
    const bool shape_ok = p.M >= 1 && p.M <= 64 && p.N >= BN && p.N % BN == 0 && p.K >= BK &&
                          p.K % BK == 0 && X >= 0 && W >= 0;
    const bool split_ok = splits >= 1 && p.k_per_split > 0 && p.k_per_split % BK == 0 &&
                          (long long)(splits - 1) * p.k_per_split < p.K &&
                          (long long)splits * p.k_per_split >= p.K &&
                          (splits == 1 || (p.part != nullptr && p.counters != nullptr));
    const uintptr_t bases = reinterpret_cast<uintptr_t>(p.x) | reinterpret_cast<uintptr_t>(p.wq);
    if (!shape_ok || !split_ok || !epi_ok(p.epi, mode) || p.stages < 2 || p.stages > kMaxStages ||
        bases % 16)
        return static_cast<int>(cudaErrorInvalidValue);
    p.epi.pre = mode == 2;
    cudaError_t err;
    if (X == kXbf16)
        err = W ? d_launch_rows<kXbf16, 1>(p, splits, stream) : d_launch_rows<kXbf16, 0>(p, splits, stream);
    else if (X == kXe4m3)
        err = W ? d_launch_rows<kXe4m3, 1>(p, splits, stream) : d_launch_rows<kXe4m3, 0>(p, splits, stream);
    else
        err = W ? d_launch_rows<kXe5m2, 1>(p, splits, stream) : d_launch_rows<kXe5m2, 0>(p, splits, stream);
    return static_cast<int>(err);
}

// ---------------------------------------------------------------------------
// Prefill, 64 < M < 4096
// ---------------------------------------------------------------------------

constexpr int kConsumers = 256;               // two warpgroups of 64 columns
constexpr int kThreads = kConsumers + 128;    // and one producer warpgroup
// 384 threads of 168 registers at launch: 2 x 128 x 240 + 128 x 24 of them
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kPrefillSmemMax = 227 * 1024;
constexpr int kTileStride = BN + 4;           // floats a row of the epilogue tile

struct PMaps {
    CUtensorMap x, w;
};

struct PParams {
    const void* scales;                       // (N) or null
    Epi epi;
    bf16* out;                                // (M, N)
    float* part;                              // (splits, M, N)
    int* counters;                            // one per output tile, 0 between calls
    int M, N, K, k_per_split, stages;
};

// K of a stage: one 128-byte swizzle row of x (64 bf16 or 128 fp8)
template <int X> __host__ __device__ constexpr int p_bk() { return X == kXbf16 ? 64 : 128; }
template <int X> __host__ __device__ constexpr int p_x_bytes(int nb) { return nb * 128 * 128; }
template <int X> __host__ __device__ constexpr int p_w_bytes() { return p_bk<X>() / 4 * BN * 4; }
// How a stage's words land, in one TMA box either way: with fp8 x four
// groups of 32 columns in the 128-byte swizzle, so that the A-fragment reads
// hit 32 banks; with bf16 x rows of 128 words, whose reads (lanes t on rows t
// / 2) are 2-way conflicted: the groups made that form 4-6% slower
// (scripts/torch_fp8_variants.py, PERF.md).
template <int X> __host__ __device__ constexpr bool w_groups() { return X != kXbf16; }

// shared memory from a 1024-byte aligned base: the x ring, the word ring
// (each stage four 32-column boxes, 1024-byte aligned), the epilogue tile
// over them once they are free, the mbarriers (full, then empty, one a
// stage) and the last-block flag. ops/fp8.prefill_smem mirrors `bytes`.
template <int X>
struct PLayout {
    int w, bars, flag, bytes;
    __host__ __device__ PLayout(int nb, int stages) {
        w = stages * p_x_bytes<X>(nb);
        const int ring = w + stages * p_w_bytes<X>(), tile = nb * 128 * kTileStride * 4;
        bars = ring > tile ? ring : tile;
        flag = bars + 16 * stages;
        bytes = flag + 16 + 1024;
    }
};

// d (64 x 128) += A (64 x 32, registers, codes W) * B (32 x 128, shared,
// K-major, x kind X), fp8 in, float32 sums; scale-d 0 overwrites d
#define GL_WGMMA_FP8(TA, TB)                                                                      \
    asm volatile(                                                                                 \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                              \
        "wgmma.mma_async.sync.aligned.m64n128k32.f32." TA "." TB " {"                             \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                  \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "        \
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "        \
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"          \
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"                                             \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),     \
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),           \
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),           \
          "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),           \
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),           \
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),           \
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),           \
          "+f"(d[62]), "+f"(d[63])                                                                \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate))

template <int W, int X>
__device__ __forceinline__ void wgmma_fp8_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                               int accumulate) {
    if constexpr (W == 0 && X == kXe4m3) GL_WGMMA_FP8("e4m3", "e4m3");
    else if constexpr (W == 0 && X == kXe5m2) GL_WGMMA_FP8("e4m3", "e5m2");
    else if constexpr (W == 1 && X == kXe4m3) GL_WGMMA_FP8("e5m2", "e4m3");
    else GL_WGMMA_FP8("e5m2", "e5m2");
}
#undef GL_WGMMA_FP8

// The producer lane: per stage, once the consumers have released it, the x
// box and the stage's word rows (one box, w_groups' layout) by TMA on the
// stage's full mbarrier.
template <int X, int NB>
__device__ __forceinline__ void p_produce(const PMaps& maps, uint32_t base, const PLayout<X>& L,
                                          int stages, int n0, int m0, int k_begin, int steps) {
    constexpr int BKX = p_bk<X>();
    const uint32_t bars = base + L.bars;
    for (int it = 0; it < steps; ++it) {
        const int st = it % stages, k0 = k_begin + it * BKX;
        const uint32_t full = sm90::bar_addr(bars, st);
        if (it >= stages)
            sm90::mbar_wait(sm90::bar_addr(bars, stages + st), ((it / stages) & 1) ^ 1);
        sm90::mbar_expect_tx(full, p_x_bytes<X>(NB) + p_w_bytes<X>());
        sm90::tma_load_2d(base + st * p_x_bytes<X>(NB), &maps.x, full, k0, m0);
        if constexpr (w_groups<X>())
            sm90::tma_load_3d(base + L.w + st * p_w_bytes<X>(), &maps.w, full, 0, k0 / 4, n0 / 32);
        else
            sm90::tma_load_2d(base + L.w + st * p_w_bytes<X>(), &maps.w, full, n0, k0 / 4);
    }
}

// Word (r, c) of a stage as TMA lands it: group c / 32 of 32-column rows of
// 128 bytes, 16-byte piece (c / 4) % 8 of row r at piece ((c / 4) % 8) ^ (r %
// 8); or row r of 128 words.
template <int X>
__device__ __forceinline__ int p_widx(int r, int c) {
    if constexpr (!w_groups<X>()) return r * BN + c;
    return (c >> 5) * (p_bk<X>() / 4) * 32 + r * 32 + ((((c >> 2) & 7) ^ (r & 7)) << 2) + (c & 3);
}

// The weight column of A row g + 8 h of consumer warp w (0 .. 7). With the
// groups (fp8 x): bits 0-1 from g, 2 from h, 3 from w, 4 from g, 5-6 from w;
// in a read, lane (g, t) takes word row t (+ a constant), and the swizzle
// spreads the 32 lanes over 32 banks. Else 16 w + g + 8 h.
template <int X>
__device__ __forceinline__ int p_col(int w, int g, int h) {
    if constexpr (!w_groups<X>()) return 16 * w + g + 8 * h;
    return 32 * (w >> 1) + 16 * (g >> 2) + 8 * (w & 1) + 4 * h + (g & 3);
}

// The A fragments of one stage for this lane (rows g, g + 8 of its warp's
// A tile: columns p_col(w, g, 0) and p_col(w, g, 1)). fp8 x: a[kk] for the
// 32-deep step kk, the words as stored (rows 8 kk + t and 8 kk + 4 + t).
// bf16 x: a[kk][2 half + h] = the codes at k 16 kk + 8 half + 2t, + 1 of
// column p_col(w, g, h), converted (bytes 2 (t & 1), + 1 of word row 4 kk +
// 2 half + t / 2).
template <int X, int W>
__device__ __forceinline__ void p_build(uint32_t (&a)[4][4], const uint8_t* g, int wofs,
                                        const int (&cols)[2], int t) {
    const uint32_t* ws = reinterpret_cast<const uint32_t*>(g + wofs);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                if constexpr (X == kXbf16) {
                    const uint32_t w = ws[p_widx<X>(4 * kk + 2 * half + (t >> 1), cols[h])];
                    a[kk][2 * half + h] = fp8x2_bf16x2<W>(w >> (16 * (t & 1)));
                } else {
                    a[kk][2 * half + h] = ws[p_widx<X>(8 * kk + 4 * half + t, cols[h])];
                }
            }
}

// The block's sums, staged as tile[m][kTileStride] for rows m0 .. m0 + bm - 1:
// into the output with the epilogue, or with K split the block's partial, and
// the last block of the tile adds the partials in split order. Consumer
// threads only. Not inlined.
__device__ __noinline__ void p_finish(const PParams p, const float* tile, int* flag, int m0,
                                      int bm) {
    const int tid = threadIdx.x, n0 = blockIdx.y * BN;
    const int split = blockIdx.z, nsplit = gridDim.z;
    const int ctr = blockIdx.x + gridDim.x * blockIdx.y;
    const int rows = min(bm, p.M - m0);
    const size_t MN = (size_t)p.M * p.N;
    if (nsplit > 1) {
        for (int e = tid * 4; e < rows * BN; e += kConsumers * 4) {
            const int m = e / BN, c = e % BN;
            *reinterpret_cast<float4*>(p.part + split * MN + (size_t)(m0 + m) * p.N + n0 + c) =
                *reinterpret_cast<const float4*>(tile + m * kTileStride + c);
        }
        __threadfence();
        sm90::named_sync<1, kConsumers>();
        if (tid == 0) *flag = atomicAdd(p.counters + ctr, 1) == nsplit - 1;
        sm90::named_sync<1, kConsumers>();
        if (!*flag) return;
        __threadfence();
    }
    for (int e = tid * 8; e < rows * BN; e += kConsumers * 8) {
        const int m = e / BN, c = e % BN, n = n0 + c;
        const size_t idx = (size_t)(m0 + m) * p.N + n;
        float v[8];
        if (nsplit == 1) {
#pragma unroll
            for (int i = 0; i < 8; ++i) v[i] = tile[m * kTileStride + c + i];
        } else {
#pragma unroll
            for (int i = 0; i < 8; ++i) v[i] = 0.f;
            for (int s0 = 0; s0 < nsplit; s0 += 4) {
                float4 r[4][2];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    r[j][0] = r[j][1] = make_float4(0.f, 0.f, 0.f, 0.f);
                    if (s0 + j >= nsplit) continue;
                    const float* src = p.part + (s0 + j) * MN + idx;
                    r[j][0] = __ldcg(reinterpret_cast<const float4*>(src));
                    r[j][1] = __ldcg(reinterpret_cast<const float4*>(src + 4));
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
        uint4 pk;
        uint32_t* w = reinterpret_cast<uint32_t*>(&pk);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float lo = epi_apply(p.epi, p.scales, v[2 * i], m0 + m, n + 2 * i);
            const float hi = epi_apply(p.epi, p.scales, v[2 * i + 1], m0 + m, n + 2 * i + 1);
            const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
            w[i] = *reinterpret_cast<const uint32_t*>(&b);
        }
        *reinterpret_cast<uint4*>(p.out + idx) = pk;
    }
    if (nsplit > 1 && tid == 0) p.counters[ctr] = 0;
}

// What a consumer thread needs across the steps of its pipeline.
template <int X, int NB>
struct PConsumer {
    uint8_t* g;
    uint32_t base, bars;
    const PLayout<X>* L;
    int S, cols[2], t, lane;

    __device__ __forceinline__ void full(int it) const {
        sm90::mbar_wait(sm90::bar_addr(bars, it % S), (it / S) & 1);
    }
    __device__ __forceinline__ void release(int it) const {
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(sm90::bar_addr(bars, S + it % S));
    }
    __device__ __forceinline__ uint64_t x_desc(int it) const {
        return sm90::sw128_desc(base + it % S * p_x_bytes<X>(NB), 16, 1024);
    }
    __device__ __forceinline__ int w_ofs(int it) const { return L->w + it % S * p_w_bytes<X>(); }
};

// One fp8 stage's products for rows 128 nb .. 128 nb + 127 of the block into
// the fresh fragment d (the first overwrites it)
template <int X, int W>
__device__ __forceinline__ void p_fp8_products(float (&d)[64], const uint32_t (&a)[4][4],
                                               uint64_t dx, int nb) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
        wgmma_fp8_n128<W, X>(d, a[kk], dx + ((nb * 128 * 128 + kk * 32) >> 4), kk);
    sm90::wgmma_commit();
}

// One stage j: issue its products from buffer CUR, build stage j + 1's A
// fragments into the other buffer while they run, wait, release the stage
// and (fp8) add its sums into the float32 accumulators. fp8 x with 256 rows:
// the fragment serves the first 128 rows' products, whose sums are added,
// then the second's, in the same fresh fragment; the next stage's fragments
// are read after both, so that one buffer's registers serve both (acc, tmp
// and one buffer fill the 240 registers; the other warpgroup's products
// cover the reads). No product is in flight where a step ends, so the steps
// may sit under a branch.
template <int X, int W, int NB, int CUR>
__device__ __forceinline__ void p_step(const PConsumer<X, NB>& c, float (&acc)[NB][64],
                                       float (&tmp)[64], uint32_t (&a)[2][4][4], int j, int steps) {
    constexpr bool kTwoHalves = X != kXbf16 && NB == 2;
    constexpr int USE = kTwoHalves ? 0 : CUR, NEXT = kTwoHalves ? 0 : 1 - CUR;   // one buffer
    const uint64_t dx = c.x_desc(j);
    sm90::pin(a[USE]);
    sm90::wgmma_fence();
    if constexpr (X == kXbf16) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int nb = 0; nb < NB; ++nb)
                sm90::wgmma_rs_n128<0>(acc[nb], a[USE][kk], dx + ((nb * 128 * 128 + kk * 32) >> 4),
                                       1);
        sm90::wgmma_commit();
    } else {
        p_fp8_products<X, W>(tmp, a[USE], dx, 0);
    }
    if (!kTwoHalves && j + 1 < steps) {
        c.full(j + 1);
        p_build<X, W>(a[NEXT], c.g, c.w_ofs(j + 1), c.cols, c.t);
    }
    sm90::wgmma_wait<0>();
    if constexpr (X == kXbf16) {
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) sm90::pin(acc[nb]);
    } else {
        sm90::pin(tmp);
    }
    if constexpr (kTwoHalves) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[0][i] += tmp[i];
        sm90::wgmma_fence();
        p_fp8_products<X, W>(tmp, a[USE], dx, 1);
        sm90::wgmma_wait<0>();
        sm90::pin(tmp);
    }
    c.release(j);
    if (kTwoHalves && j + 1 < steps) {
        c.full(j + 1);
        p_build<X, W>(a[NEXT], c.g, c.w_ofs(j + 1), c.cols, c.t);
    }
    if constexpr (X != kXbf16) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[NB - 1][i] += tmp[i];
    }
}

template <int X, int W, int NB>
__device__ __forceinline__ void p_consume(const PParams& p, uint8_t* g, uint32_t base,
                                          const PLayout<X>& L, int m0, int steps, int* flag) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int lane = threadIdx.x % 32, t = lane % 4, w = threadIdx.x / 32;
    const PConsumer<X, NB> c{g, base, base + L.bars, &L, p.stages,
                             {p_col<X>(w, lane / 4, 0), p_col<X>(w, lane / 4, 1)}, t, lane};

    float acc[NB][64];
    float tmp[64];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[nb][i] = 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) tmp[i] = 0.f;
    uint32_t a[2][4][4];                      // stage s in buffer s % 2
    c.full(0);
    p_build<X, W>(a[0], g, c.w_ofs(0), c.cols, t);
    int j = 0;
    for (; j + 1 < steps; j += 2) {
        p_step<X, W, NB, 0>(c, acc, tmp, a, j, steps);
        p_step<X, W, NB, 1>(c, acc, tmp, a, j + 1, steps);
    }
    if (j < steps) p_step<X, W, NB, 0>(c, acc, tmp, a, j, steps);

    sm90::named_sync<1, kConsumers>();        // both warpgroups are done with the ring
    float* tile = reinterpret_cast<float*>(g);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int n8 = 0; n8 < 16; ++n8)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                tile[(nb * 128 + 8 * n8 + 2 * t + (e & 1)) * kTileStride + c.cols[e >> 1]] =
                    acc[nb][4 * n8 + e];
    sm90::named_sync<1, kConsumers>();
    p_finish(p, tile, flag, m0, NB * 128);
}

template <int X, int W, int NB>
__global__ void __launch_bounds__(kThreads, 1)
fp8_prefill_kernel(const __grid_constant__ PMaps maps, const PParams p) {
    extern __shared__ uint8_t smem_raw[];
    const PLayout<X> L(NB, p.stages);
    const uint32_t base = sm90::smem_base(smem_raw), bars = base + L.bars;
    uint8_t* g = smem_raw + (base - sm90::smem_addr(smem_raw));
    const int n0 = blockIdx.y * BN, m0 = blockIdx.x * NB * 128;
    const int k_begin = blockIdx.z * p.k_per_split;
    const int steps = (min(p.K, k_begin + p.k_per_split) - k_begin) / p_bk<X>();
    if (threadIdx.x == 0) {
        for (int s = 0; s < p.stages; ++s) {
            sm90::mbar_init(sm90::bar_addr(bars, s), 1);
            sm90::mbar_init(sm90::bar_addr(bars, p.stages + s), kConsumers / 32);
        }
        sm90::mbar_init_fence();
    }
    __syncthreads();
    const int wg = sm90::warpgroup();
    if (wg == 2) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
        if (threadIdx.x == kConsumers)
            p_produce<X, NB>(maps, base, L, p.stages, n0, m0, k_begin, steps);
    } else {
        p_consume<X, W, NB>(p, g, base, L, m0, steps, reinterpret_cast<int*>(g + L.flag));
    }
}

// 2-d map over a contiguous (rows, cols) array, dims innermost first; a box
// is box_cols x box_rows; what lies past the array reads as zeros
bool make_map(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* ptr, int rows,
              int cols, int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
    const sm90::EncodeTiled encode = sm90::encode_tiled();
    if (encode == nullptr) return false;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
    const cuuint32_t unit[2] = {1, 1};
    return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// 3-d map over the (rows, cols) int32 words as (32 columns, rows, cols / 32
// groups of 32 columns): a box of (32, box_rows, 4) lands the groups one
// after another, each box_rows rows of 128 bytes in the 128-byte swizzle
// (p_widx), in one copy
bool make_word_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
    const sm90::EncodeTiled encode = sm90::encode_tiled();
    if (encode == nullptr) return false;
    const cuuint64_t dims[3] = {32, static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(cols / 32)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 4, 128};
    const cuuint32_t box[3] = {32, static_cast<cuuint32_t>(box_rows), BN / 32};
    const cuuint32_t unit[3] = {1, 1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 3, const_cast<void*>(ptr), dims, strides, box,
                  unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int X, int W, int NB>
cudaError_t p_launch(const void* x, const uint32_t* wq, const PParams& p, int splits,
                     cudaStream_t stream) {
    static std::atomic<unsigned> ready{0};
    const PLayout<X> L(NB, p.stages);
    if (L.bytes > kPrefillSmemMax) return cudaErrorInvalidValue;
    PMaps maps;
    if (!make_map(&maps.x, X == kXbf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                  X == kXbf16 ? 2 : 1, x, p.M, p.K, NB * 128, p_bk<X>(), CU_TENSOR_MAP_SWIZZLE_128B) ||
        !(w_groups<X>() ? make_word_map(&maps.w, wq, p.K / 4, p.N, p_bk<X>() / 4)
                        : make_map(&maps.w, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, wq, p.K / 4, p.N,
                                   p_bk<X>() / 4, BN, CU_TENSOR_MAP_SWIZZLE_NONE)))
        return cudaErrorInvalidValue;
    const cudaError_t err = sm90::allow_smem(fp8_prefill_kernel<X, W, NB>, kPrefillSmemMax, ready);
    if (err != cudaSuccess) return err;
    // row tiles fastest: the blocks of one column tile run side by side and
    // read its words from L2 once (column tiles first re-read them from
    // memory once per row tile: 470 MB at M 1024 on 14336 x 4096)
    const dim3 grid((p.M + NB * 128 - 1) / (NB * 128), p.N / BN, splits);
    fp8_prefill_kernel<X, W, NB><<<grid, kThreads, L.bytes, stream>>>(maps, p);
    return cudaGetLastError();
}

template <int X, int W>
cudaError_t p_launch_rows(const void* x, const uint32_t* wq, const PParams& p, int bm, int splits,
                          cudaStream_t stream) {
    return bm == 128 ? p_launch<X, W, 1>(x, wq, p, splits, stream)
                     : p_launch<X, W, 2>(x, wq, p, splits, stream);
}

}  // namespace

// Launch on `stream` (M <= 64). x (M, K) bf16 or fp8, wq (K / 4, N) fp8 bit
// codes; scales (N) float32 / bf16 for mode 2 or csm 1 / 3, sx (M) float32 for
// csm 2 / 3. N and K multiples of 128. K is cut into `splits` ranges of
// `k_per_split` (a multiple of 128, none empty); with splits > 1 the call
// needs `part`, (splits, M, N) floats, and `counters`, one int32 per column
// tile, all 0, which the kernel leaves 0. `stages` comes from
// ops/fp8.decode_plan. Returns the cudaError_t of the launch (0 on success).
extern "C" int gl_fp8_decode(const void* x, const void* wq, const void* scales, const void* sx,
                             void* part, void* counters, void* out, int M, int N, int K, int x_code,
                             int w_code, int mode, int csm, int s_code, int splits, int k_per_split,
                             int stages, void* stream_ptr) {
    const DParams p{x, static_cast<const uint32_t*>(wq), scales, nullptr, 1,
                    Epi{scales, static_cast<const float*>(sx), s_code, 0, csm},
                    static_cast<bf16*>(out), static_cast<float*>(part), static_cast<int*>(counters),
                    M, N, K, k_per_split, stages};
    return d_run(p, x_code, w_code, mode, splits, static_cast<cudaStream_t>(stream_ptr));
}

// The same for layer *layer_idx (a device pointer to one int32) of the
// L-layer stacks wq (L, K / 4, N) and scales (L, N).
extern "C" int gl_fp8_decode_stacked(const void* x, const void* wq, const void* scales,
                                     const void* sx, const void* layer_idx, void* part,
                                     void* counters, void* out, int L, int M, int N, int K,
                                     int x_code, int w_code, int mode, int csm, int s_code,
                                     int splits, int k_per_split, int stages, void* stream_ptr) {
    if (layer_idx == nullptr || L < 1) return static_cast<int>(cudaErrorInvalidValue);
    const DParams p{x, static_cast<const uint32_t*>(wq), scales, static_cast<const int*>(layer_idx), L,
                    Epi{scales, static_cast<const float*>(sx), s_code, 0, csm},
                    static_cast<bf16*>(out), static_cast<float*>(part), static_cast<int*>(counters),
                    M, N, K, k_per_split, stages};
    return d_run(p, x_code, w_code, mode, splits, static_cast<cudaStream_t>(stream_ptr));
}

// Launch on `stream` (64 < M < 4096): the operands of gl_fp8_decode; `bm`
// (128 or 256) rows of x a block; K cut into `splits` ranges of
// `k_per_split` (a multiple of the stage: 64 k with bf16 x, 128 with fp8 x);
// `stages` from ops/fp8.prefill_plan.
extern "C" int gl_fp8_prefill(const void* x, const void* wq, const void* scales, const void* sx,
                              void* part, void* counters, void* out, int M, int N, int K, int x_code,
                              int w_code, int mode, int csm, int s_code, int bm, int splits,
                              int k_per_split, int stages, void* stream_ptr) {
    const int X = x_kind(x_code), W = w_kind(w_code);
    const int bk = X == kXbf16 ? 64 : 128;
    const Epi epi{scales, static_cast<const float*>(sx), s_code, mode == 2, csm};
    const bool shape_ok = M >= 1 && N >= BN && N % BN == 0 && K >= bk && K % bk == 0 && X >= 0 &&
                          W >= 0 && (bm == 128 || bm == 256);
    const bool split_ok = splits >= 1 && k_per_split > 0 && k_per_split % bk == 0 &&
                          (long long)(splits - 1) * k_per_split < K &&
                          (long long)splits * k_per_split >= K &&
                          (splits == 1 || (part != nullptr && counters != nullptr));
    const uintptr_t bases = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wq) |
                            reinterpret_cast<uintptr_t>(out);
    if (!shape_ok || !split_ok || !epi_ok(epi, mode) || stages < 2 || stages > kMaxStages ||
        bases % 16)
        return static_cast<int>(cudaErrorInvalidValue);
    const PParams p{scales, epi, static_cast<bf16*>(out), static_cast<float*>(part),
                    static_cast<int*>(counters), M, N, K, k_per_split, stages};
    const uint32_t* w = static_cast<const uint32_t*>(wq);
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    cudaError_t err;
    if (X == kXbf16)
        err = W ? p_launch_rows<kXbf16, 1>(x, w, p, bm, splits, stream) : p_launch_rows<kXbf16, 0>(x, w, p, bm, splits, stream);
    else if (X == kXe4m3)
        err = W ? p_launch_rows<kXe4m3, 1>(x, w, p, bm, splits, stream) : p_launch_rows<kXe4m3, 0>(x, w, p, bm, splits, stream);
    else
        err = W ? p_launch_rows<kXe5m2, 1>(x, w, p, bm, splits, stream) : p_launch_rows<kXe5m2, 0>(x, w, p, bm, splits, stream);
    return static_cast<int>(err);
}
