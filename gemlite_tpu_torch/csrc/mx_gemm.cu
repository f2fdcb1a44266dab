// SPDX-License-Identifier: Apache-2.0
// MX weights (fp4 e2m1 codes eight to an int32 word, or fp8 e4m3 / e5m2 bit
// codes four to a word, with e8m0 group scales of 32, or NVFP4: fp4 codes
// with e4m3 x 0.05 scales of 16) times bf16, per-token e4m3 (csm 2) or
// micro-scaled (csm 4) activations: out (M, N) bf16 = x (M, K) . W, then the
// per-token scale (csm 2). One launch a call. The plain version is
// ops/reference.mx_forward_ref.
//
// Four entries share three bodies:
//   gl_mx_decode          M <= 64, e8m0 layers: replaces gemlite_tpu/ops/
//                         pallas_decode.py:pallas_decode_matmul on MX layers
//                         (fp4 codes and fp8 codes with block scales);
//   gl_mx_decode_stacked  layer l of an L-layer stack, the index read on the
//                         device: replaces gemlite_tpu/ops/pallas_scan.py:
//                         pallas_decode_matmul_stacked on them, on the same
//                         kernel and plan, so the two agree bit for bit;
//   gl_mx_prefill         M < 4096, every MX layer (NVFP4 from M 1, as JAX
//                         sends NVFP4 decode there): replaces gemlite_tpu/ops/
//                         pallas_prefill.py:pallas_prefill_matmul on MX
//                         layers, with x either bf16 or 1-byte e4m3 codes
//                         (per-token, csm 2, or micro-scaled with float32
//                         group scales, csm 4: the prefill_mx_csm4 route);
//   gl_mx_general         M < 4096, fp4 layers that JAX does not fold (K or N
//                         off the multiples of 128): replaces the MX codecs of
//                         gemlite_tpu/ops/pallas_gemm.py:pallas_fused_matmul
//                         (:53-80, scale codecs :116-120), under the route
//                         name general_fused, bf16 or per-token e4m3 x: for
//                         M <= 64 with e8m0 scales on the ragged decode body
//                         (a cp.async ring of 128 threads), for NVFP4 and
//                         above M 64 on the prefill body's ragged instance
//                         (ops/mx.general_plan).
//
// The ragged forms read what lies past N or K as zeros, words, scales and x
// alike (so no stale value meets a zero weight), and write no column past N.
// The prefill body's compile-time flag R makes its ragged instance; the real
// unfolded shapes (N and K among 320, 960, 2560, 2880) keep 16-byte copies
// and TMA there, and odd N falls back to narrower copies at the edge only.
// Like the folded layers, the ragged ones are bound by their weight bytes
// below M about 300 and by 2 M N K bf16 operations above.
//
// The weights (csrc/mx_common.cuh): fp4 codes become bf16 by byte permutes
// from a register table, fp8 codes exactly through fp16. The decode kernel
// sums each 32-deep group's unscaled products in a fresh float32 fragment and
// adds it times the group's e8m0 scale, a power of two, so exactly; the
// prefill kernel multiplies each exactly decoded bf16x2 pair by its group's
// e8m0 scale as one bf16x2 multiply, one rounding of the exact product: the
// bits of the float32 product rounded once, at every exponent 0-254. Either
// way the products run on the bf16 tensor cores with float32 sums, and the
// kernels compute the plain version's function up to the order of the sums;
// NVFP4's e4m3 x 0.05 scale is no power of two, and its weights are the
// float32 product rounded once to bf16 (the plain version keeps them in
// float32), as the JAX package's prefill kernel rounds them. Both decoders
// are instantiated per weight kind (and the prefill's per scale form): a
// run-time branch on the kind in the inner loops cost 40% (measured with
// scripts/torch_mx_variants.py).
//
// The decode body (what bounds it: the weight bytes, K N / 2 for fp4 plus K N /
// 32 of scales, 0.0093 ms at 3.35 TB/s for 14336 x 4096; K N + K N / 32 for
// fp8 codes) streams the weights by TMA into a ring of mbarriers. A block of
// 128 columns has four consumer warps of 32 columns and one producer warp,
// whose first lane issues each 128-deep stage (the words as one 3-d box of
// four 32-column groups in the 128-byte swizzle, the four scale rows, and x:
// the rows of M rounded up to 8 in 128-byte swizzled boxes, past M zeros) on
// the stage's "full" mbarrier with its bytes, and waits on the stage's "empty"
// mbarrier, one arrival a consumer warp, before it reuses it. The consumers
// issue no copy and meet no __syncthreads in the main loop: each waits for a
// stage, takes its products and releases it. Operands are swapped on
// mma.sync m16n8k16 bf16 (out^T = W^T . x^T: A a 16-column tile of W, decoded
// in registers, B the M <= 64 tokens as n8 tiles). Lane t of a 32-deep block
// takes whole words: fp4 codes 8t .. 8t + 7 (product j takes 4j .. 4j + 3),
// fp8 codes 4t .. 4t + 3 and 16 + 4t .. (product j takes the word of 16 j);
// x is read to match, bf16 x for fp4 codes as one 16-byte piece. A warp's A
// rows take the columns d_col gives, so that its word reads (lane (g, t) on
// word row t) hit 32 banks in the swizzle. Per-token e4m3 x converts exactly
// to bf16 as it is read. Each 32-deep group's products are summed unscaled in
// a fresh float32 fragment and added times the group's scale by one exact
// fmaf (scaling every weight instead cost 17%, scripts/torch_mx_variants.py).
// The grid (ops/mx.decode_plan) fills whole waves of three blocks an SM (the
// launch bounds'), with K split over gridDim.y into ranges of at least twice
// the ring's depth where K allows, the ring as deep as a third of the SM's
// shared memory holds (ops/mx.decode_smem); the splits are merged by the last
// block of each column tile in split order. The split depends on N and K
// only, so a row's sum does not depend on the batch and the stacked entry,
// whose maps span the whole (L, K / per_word, N) and (L, K / 32, N) stacks
// and whose producer reads the layer on the device as a row offset, equals the
// per-layer entry. What then bounds it is how many bytes the SMs keep in
// flight, against the decode chain's instructions in the consumer warps
// (PERF.md).
//
// The prefill body (what bounds it: operations, 2 M N K over 989 TFLOP/s bf16,
// from M about 300; the weight bytes below) is the W4 prefill kernel's design
// (prefill_gemm.cu): two consumer warpgroups of 64 weight columns run wgmma
// m64n128k16 with the decoded weights as the register A operand and the x tile
// as the K-major shared B operand, 128 rows of x a block up to M 128 and 256
// above (ops/prefill.row_tile), where each A fragment feeds two products, so a
// weight tile is decoded once for 256 rows; setmaxnreg moves registers from
// the producer warpgroup to them. A consumer queues stage j + 1's products
// behind stage j's and builds stage j + 2's fragments while they run. One lane
// of the producer's first warp keeps a ring of 64-deep stages in flight by
// TMA: the words, the scales and x, either the bf16 box in the 128-byte
// swizzle or, for 1-byte x, the box of e4m3 codes and their group scales. The
// code form has a second producer warpgroup, and its seven other producer
// warps convert inside the ring: once a stage has landed and its tile is free
// ("x free" mbarrier), each code times its group scale in float32, rounded
// once to bf16 (by one bf16x2 multiply where it is a power of two), into one
// of three swizzled bf16 tiles, on whose "x ready" mbarrier the consumers
// wait. So no copy waits for a conversion, and the
// csm-4 tile equals fake_quant_activations(x) bit for bit: the code form and
// the bf16 form fed the fake-quantized x take the same plan and give the same
// output. The conversion still costs the code form 1.3-1.6 times the bf16
// form's time (NVIDIA H100, PERF.md): the first version, which loaded and
// converted x in the producer before it issued a stage's copies, took 2.3
// times; three converting warps (scripts/torch_mx_variants.py), the
// consumers converting, or pairs of blocks sharing the conversion in a
// cluster were slower than seven warps (PERF.md). K is split by
// ops/mx.prefill_plan and merged in the same launch.
#include <cuda_fp8.h>

#include <atomic>

#include "gl_common.cuh"
#include "mx_common.cuh"
#include "sm90_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using gl::cp_async16;
using gl::cp_async_commit;
using gl::cp_async_wait_n;
using gl::smem_u32;

enum XKind { kXbf16 = 0, kXe4m3 = 1 };   // the activations

// bytes 0 and 1 of `two` (e4m3 codes) -> bf16x2 (byte 0 low), exact
__device__ __forceinline__ uint32_t e4m3x2_bf16x2(uint32_t two) {
    const __half2_raw h =
        __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(two & 0xFFFFu), __NV_E4M3);
    const float2 f = __half22float2(__half2(h));
    return mx::bf16x2(f.x, f.y);
}

// ---------------------------------------------------------------------------
// Decode, M <= 64 (per-layer and stacked), e8m0 scales in groups of 32
// ---------------------------------------------------------------------------

constexpr int BK = 128;                  // K per ring stage: four groups
constexpr int BN = 128;                  // output columns per block: 4 warps of 32
constexpr int SROWS = BK / 32;           // scale rows a stage
constexpr int kDecodeBlocks = 3;         // blocks an SM (ops/mx.DECODE_BLOCKS)
constexpr int kDecodeThreads = BN + 32;  // four consumer warps and the producer warp
constexpr int kDecodeMaxStages = 8;
constexpr int kDecodeSmemMax = 112 * 1024;
constexpr int kRaggedMinBlocks = 3;      // the ragged instance: blocks an SM
constexpr int kMaxStages = 6;            // the ragged decode and the prefill rings

struct DParams {
    const void* x;                       // (M, K) bf16 / e4m3
    const uint32_t* wq;                  // ([L,] K / per_word, N)
    const uint8_t* scales;               // ([L,] K / 32, N) e8m0 bits
    const float* sx;                     // (M) per-token scales, or null
    const int* layer_idx;                // stacked entry: the layer, on the device
    int L;
    bf16* out;                           // (M, N)
    float* part;                         // (splits, M, N) float32 partials
    int* counters;                       // one per column tile, 0 between calls
    int M, N, K, k_per_split, stages, wkind;
};

// The weight, scale and x maps of the TMA body.
struct DMaps {
    CUtensorMap x, w, s;
};

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
// groups of 32 columns): a box of (32, box_rows, 4) lands a block's 128
// columns as four groups one after another, each box_rows rows of 128 bytes
// in the 128-byte swizzle (d_word), in one copy
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

// The TMA body's shared memory from a 1024-byte aligned base: the x ring
// (a stage: the rows of x, M rounded up to 8, in boxes of 128-byte rows in
// the 128-byte swizzle, two boxes of 64 k for bf16), the word ring (a stage:
// four 1024-byte aligned boxes of 32 columns), the scale ring (a stage: four
// rows of 128 bytes); the epilogue tile over them once they are free. The
// mbarriers are static. ops/mx.decode_smem mirrors `bytes`.
struct DLayout {
    int xb, wb, w, s, bytes;
    __host__ __device__ DLayout(int wkind, int xbytes, int rows, int stages) {
        xb = rows * BK * xbytes;
        wb = BK / mx::per_word(wkind) * BN * 4;
        w = stages * xb;
        s = w + stages * wb;
        const int ring = s + stages * SROWS * BN, tile = rows * BN * 4;
        bytes = (ring > tile ? ring : tile) + 1024;
    }
};

// Column c (0 .. 127) of the block for A row g + 8 h of m16 tile i of warp
// w: the warp's group of 32 columns, in it 16-byte piece 4 (g / 4) + 2 i + h
// and word g % 4 of the piece. A lane (g, t) reads word row t (+ a constant)
// of that piece; the swizzle XORs the piece with the row, so the pieces (g /
// 4, t) of a read land on 8 distinct pieces and the 32 lanes on 32 banks.
__device__ __forceinline__ int d_col(int w, int g, int i, int h) {
    return 32 * w + 16 * (g >> 2) + 8 * i + 4 * h + (g & 3);
}

// word (r, c) of a stage's word boxes (WR rows a group), as TMA lands it
template <int WR>
__device__ __forceinline__ int d_word(int r, int c) {
    return (c >> 5) * WR * 32 + r * 32 + ((((c >> 2) & 7) ^ (r & 7)) << 2) + (c & 3);
}

// byte offset of x (m, k) (k < BK) in a stage of `rows` rows: boxes of 64
// (bf16) or 128 (e4m3) k, 128-byte rows, 16-byte piece p of row m at p ^ (m % 8)
template <int XB>
__device__ __forceinline__ int d_x(int rows, int m, int k) {
    constexpr int per = 128 / XB;        // k a box row
    const int kb = k % per * XB;
    return k / per * rows * 128 + m * 128 + (((kb >> 4) ^ (m & 7)) << 4) + (kb & 15);
}

// fp4 codes e and e + 4 of a word (e 0..3), unscaled, as bf16x2 (code e
// low), exact: each code's magnitude bits placed in a bf16's lowest exponent
// bits and its top mantissa bit, its sign in the sign bit (the two in one
// multiply by 0x1040 of the pair, masked), then times 2^126 by one bf16x2
// multiply, which maps the exponents onto e2m1's and the subnormal code
// (0.5) onto 0.5. Four instructions a pair, against the byte-permute
// table's nine (mx::fp4x2_bf16x2).
__device__ __forceinline__ uint32_t fp4_pair_e4(uint32_t word, int e) {
    const uint32_t u = (word >> (4 * e)) & 0x000F000Fu;
    return mx::mul_bf16x2((u * 0x1040u) & 0x81C081C0u, 0x7E807E80u);
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

// A 32-deep group's products of one m16 tile into a fresh float32 fragment,
// then times the group's (power of two) scale, exactly, into the sums
__device__ __forceinline__ void group_sum(float (&acc)[4], const uint32_t (&a0)[4],
                                          const uint32_t (&a1)[4], const uint32_t (&b)[2][2],
                                          const float (&sc)[2]) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    mma_bf16(part, a0, b[0][0], b[0][1]);
    mma_bf16(part, a1, b[1][0], b[1][1]);
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[r] = __fmaf_rn(part[r], sc[r >> 1], acc[r]);
}

// A consumer lane's byte offsets into a stage, fixed for the kernel, so that
// the main loop adds only constants: the word of A row (i, h) in word row 4 q
// + t of the first two k blocks (fp4: q = kb % 2, the rows of kb + 2 lie 1024
// bytes on; fp8: q = j, the rows of kb lie 1024 kb bytes on); its column's
// byte in a scale row; x row g's piece of k block kb, product j (row 8 jj + g
// lies 1024 jj bytes on).
template <int X, int W>
struct DLane {
    int w[2][2][2];                      // [q][i][h]
    int c;                               // d_col(w, g, 0, 0); (i, h) add 8 i + 4 h
    int x[4][2];                         // [kb][j]
    __device__ __forceinline__ DLane(int warp, int lane, int rows) {
        constexpr bool fp4 = W == mx::kFp4;
        constexpr int WR = BK / mx::per_word(W), XB = X == kXbf16 ? 2 : 1;
        const int g = lane >> 2, t = lane & 3;
        c = d_col(warp, g, 0, 0);
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int h = 0; h < 2; ++h) w[q][i][h] = 4 * d_word<WR>(4 * q + t, d_col(warp, g, i, h));
#pragma unroll
        for (int kb = 0; kb < 4; ++kb)
#pragma unroll
            for (int j = 0; j < 2; ++j)
                x[kb][j] = d_x<XB>(rows, g, 32 * kb + (fp4 ? 8 * t : 16 * j + 4 * t));
    }
};

// One stage's products for consumer warp w: acc[i][jj][r] is column d_col(w,
// g, i, r / 2), token 8 jj + 2t + r % 2. In 32-deep block kb, product j, lane
// (g, t) holds four k in its slots 2t, 2t + 1 and 2t + 8, 2t + 9, for A and B
// alike: fp4 codes 8t .. 8t + 7 of word row 4 kb + t, product j k 8t + 2j,
// + 2j + 4 and 8t + 2j + 1, + 2j + 5 (each register a code e and e + 4, as
// fp4_pair_e4 decodes them; x paired to match by byte permutes); fp8 codes
// of word row 8 kb + 4 j + t, k 32 kb + 16j + 4t .. + 3 in order.
template <int NT, int X, int W>
__device__ __forceinline__ void d_compute(const uint8_t* wst, const uint8_t* sst,
                                          const uint8_t* xst, const DLane<X, W>& o, int nt,
                                          float (&acc)[2][NT][4]) {
    constexpr bool fp4 = W == mx::kFp4;
#pragma unroll
    for (int kb = 0; kb < BK / 32; ++kb) {
        uint32_t a[2][2][4];                         // [product j][m16 tile i][register]
        float sc[2][2];                              // the group's scale of the column
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                sc[i][h] = mx::scale_f32(sst[kb * BN + o.c + 8 * i + 4 * h], false);
                if constexpr (fp4) {
                    const uint32_t word = *reinterpret_cast<const uint32_t*>(
                        wst + o.w[kb & 1][i][h] + 1024 * (kb >> 1));
#pragma unroll
                    for (int j = 0; j < 2; ++j) {
                        a[j][i][h] = fp4_pair_e4(word, 2 * j);
                        a[j][i][2 + h] = fp4_pair_e4(word, 2 * j + 1);
                    }
                } else {
#pragma unroll
                    for (int j = 0; j < 2; ++j) {
                        const uint32_t word =
                            *reinterpret_cast<const uint32_t*>(wst + o.w[j][i][h] + 1024 * kb);
                        a[j][i][h] = mx::raw_pair(word, 0, W);
                        a[j][i][2 + h] = mx::raw_pair(word, 2, W);
                    }
                }
            }
#pragma unroll
        for (int jj = 0; jj < NT; ++jj) {
            if (jj >= nt) break;
            const uint8_t* xr = xst + 1024 * jj;     // rows 8 jj .. 8 jj + 7
            uint32_t b[2][2];
            if constexpr (X == kXbf16 && fp4) {      // k 8t .. 8t + 7: one 16-byte piece
                const uint4 xv = *reinterpret_cast<const uint4*>(xr + o.x[kb][0]);
                b[0][0] = __byte_perm(xv.x, xv.z, 0x5410), b[0][1] = __byte_perm(xv.x, xv.z, 0x7632);
                b[1][0] = __byte_perm(xv.y, xv.w, 0x5410), b[1][1] = __byte_perm(xv.y, xv.w, 0x7632);
            } else if constexpr (X == kXbf16) {
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    const uint2 xv = *reinterpret_cast<const uint2*>(xr + o.x[kb][j]);
                    b[j][0] = xv.x, b[j][1] = xv.y;
                }
            } else if constexpr (fp4) {              // e4m3 codes 8t .. 8t + 7, byte e with e + 4
                const uint2 xv = *reinterpret_cast<const uint2*>(xr + o.x[kb][0]);
                b[0][0] = e4m3x2_bf16x2(__byte_perm(xv.x, xv.y, 0x40));
                b[0][1] = e4m3x2_bf16x2(__byte_perm(xv.x, xv.y, 0x51));
                b[1][0] = e4m3x2_bf16x2(__byte_perm(xv.x, xv.y, 0x62));
                b[1][1] = e4m3x2_bf16x2(__byte_perm(xv.x, xv.y, 0x73));
            } else {
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    const uint32_t xv = *reinterpret_cast<const uint32_t*>(xr + o.x[kb][j]);
                    b[j][0] = e4m3x2_bf16x2(xv), b[j][1] = e4m3x2_bf16x2(xv >> 16);
                }
            }
#pragma unroll
            for (int i = 0; i < 2; ++i) group_sum(acc[i][jj], a[0][i], a[1][i], b, sc[i]);
        }
    }
}

// The block's sums, staged as tile[m][BN]: into the output (times the
// per-token scale), or with K split the block's partial, and the last block
// of the column tile adds the partials in split order and leaves its counter
// at 0. The block's first BN threads (the consumer warps) only. Not inlined:
// one copy serves the folded instances, one the ragged ones, whose partials
// have rows of whole tiles and whose columns past N are not written.
template <bool R>
__device__ __noinline__ void d_finish(const DParams p, const float* tile, int* flag) {
    const int n0 = blockIdx.x * BN, split = blockIdx.y, nsplit = gridDim.y;
    const int ld = R ? gridDim.x * BN : p.N;         // a row of the partials
    const size_t MN = (size_t)p.M * ld;
    const int total = p.M * BN;
    if (nsplit > 1) {
        for (int e = threadIdx.x * 4; e < total; e += BN * 4) {
            const int m = e / BN, n = n0 + e % BN;
            *reinterpret_cast<float4*>(p.part + split * MN + (size_t)m * ld + n) =
                *reinterpret_cast<const float4*>(tile + e);
        }
        __threadfence();
        sm90::named_sync<1, BN>();
        if (threadIdx.x == 0) *flag = atomicAdd(p.counters + blockIdx.x, 1) == nsplit - 1;
        sm90::named_sync<1, BN>();
        if (!*flag) return;
        __threadfence();
    }
    // U groups of four values a thread at a time, the loads of up to eight
    // partials of each in flight together; each value adds the partials in
    // split order
    constexpr int U = 2;
    for (int e0 = threadIdx.x * 4; e0 < total; e0 += BN * 4 * U) {
        float v[U][4];
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
            for (int i = 0; i < 4; ++i) v[u][i] = 0.f;
        if (nsplit == 1) {
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int e = e0 + u * BN * 4;
                if (e >= total) break;
                const float4 tv = *reinterpret_cast<const float4*>(tile + e);
                v[u][0] = tv.x, v[u][1] = tv.y, v[u][2] = tv.z, v[u][3] = tv.w;
            }
        } else {
            for (int s0 = 0; s0 < nsplit; s0 += 8) {
                float4 r[U][8];
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    const int e = e0 + u * BN * 4;
                    const size_t idx = (size_t)(e / BN) * ld + n0 + e % BN;
#pragma unroll
                    for (int j = 0; j < 8; ++j) {
                        const float4* src = reinterpret_cast<const float4*>(p.part + (s0 + j) * MN + idx);
                        r[u][j] = s0 + j < nsplit && e < total ? __ldcg(src)
                                                               : make_float4(0.f, 0.f, 0.f, 0.f);
                    }
                }
#pragma unroll
                for (int u = 0; u < U; ++u)
#pragma unroll
                    for (int j = 0; j < 8; ++j) {
                        if (s0 + j >= nsplit) break;
                        v[u][0] = __fadd_rn(v[u][0], r[u][j].x);
                        v[u][1] = __fadd_rn(v[u][1], r[u][j].y);
                        v[u][2] = __fadd_rn(v[u][2], r[u][j].z);
                        v[u][3] = __fadd_rn(v[u][3], r[u][j].w);
                    }
            }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int e = e0 + u * BN * 4;
            if (e >= total) break;
            const int m = e / BN, n = n0 + e % BN;
            if (R && n >= p.N) continue;
            if (p.sx != nullptr) {
                const float s = p.sx[m];
#pragma unroll
                for (int i = 0; i < 4; ++i) v[u][i] = __fmul_rn(v[u][i], s);
            }
            bf16* o = p.out + (size_t)m * p.N + n;
            if (R && p.N % 4) {          // rows off 8-byte alignment: one value at a time
                for (int i = 0; i < 4 && n + i < p.N; ++i) o[i] = __float2bfloat16_rn(v[u][i]);
                continue;
            }
            uint2 pk;
            pk.x = mx::bf16x2(v[u][0], v[u][1]);
            pk.y = mx::bf16x2(v[u][2], v[u][3]);
            *reinterpret_cast<uint2*>(o) = pk;
        }
    }
    if (nsplit > 1 && threadIdx.x == 0) p.counters[blockIdx.x] = 0;
}

// The producer lane: for layer *layer_idx of a stack (row offsets into the
// maps, which span all L layers), per stage, once the consumers have
// released it, the stage's words, scales and x by TMA on its full mbarrier.
template <int X, int W>
__device__ __forceinline__ void d_produce(const DMaps& maps, const DParams& p, uint32_t base,
                                          const DLayout& Ly, uint32_t bars, int rows, int n0,
                                          int k_begin, int steps) {
    constexpr int epw = mx::per_word(W);
    int wrow = 0, srow = 0;
    if (p.layer_idx != nullptr) {
        const int l = __ldg(p.layer_idx);
        if (l < 0 || l >= p.L) __trap();             // the caller's index is out of the stack
        wrow = l * (p.K / epw);
        srow = l * (p.K / 32);
    }
    const int S = p.stages;
    const uint32_t bytes = Ly.xb + Ly.wb + SROWS * BN;
    for (int it = 0; it < steps; ++it) {
        const int st = it % S, k0 = k_begin + it * BK;
        const uint32_t full = sm90::bar_addr(bars, st);
        if (it >= S) sm90::mbar_wait(sm90::bar_addr(bars, S + st), ((it / S) & 1) ^ 1);
        sm90::mbar_expect_tx(full, bytes);
        sm90::tma_load_3d(base + Ly.w + st * Ly.wb, &maps.w, full, 0, wrow + k0 / epw, n0 / 32);
        sm90::tma_load_2d(base + Ly.s + st * SROWS * BN, &maps.s, full, n0, srow + k0 / 32);
        const uint32_t xs = base + st * Ly.xb;
        if constexpr (X == kXbf16) {
            sm90::tma_load_2d(xs, &maps.x, full, k0, 0);
            sm90::tma_load_2d(xs + rows * 128, &maps.x, full, k0 + 64, 0);
        } else {
            sm90::tma_load_2d(xs, &maps.x, full, k0, 0);
        }
    }
}

// The folded layers (N and K multiples of 128), per-layer and stacked alike:
// four consumer warps of 32 columns and one producer warp whose first lane
// keeps the ring of `stages` stages in flight by TMA. The consumers wait on a
// stage's full mbarrier, take its products, and release it on its empty
// mbarrier, one arrival a warp; nothing else synchronizes the main loop.
template <int NT, int X, int W>
__global__ void __launch_bounds__(kDecodeThreads, kDecodeBlocks)
mx_decode_kernel(const __grid_constant__ DMaps maps, const DParams p) {
    constexpr int XB = X == kXbf16 ? 2 : 1;
    extern __shared__ uint8_t smem_raw[];
    __shared__ __align__(8) uint64_t bar_mem[2 * kDecodeMaxStages];
    __shared__ int last_flag;
    const int rows = (p.M + 7) / 8 * 8, S = p.stages;
    const DLayout Ly(W, XB, rows, S);
    const uint32_t base = sm90::smem_base(smem_raw), bars = sm90::smem_addr(bar_mem);
    uint8_t* g = smem_raw + (base - sm90::smem_addr(smem_raw));
    const int n0 = blockIdx.x * BN, k_begin = blockIdx.y * p.k_per_split;
    const int steps = (min(p.K, k_begin + p.k_per_split) - k_begin) / BK;
    if (threadIdx.x == 0) {
        for (int s = 0; s < S; ++s) {
            sm90::mbar_init(sm90::bar_addr(bars, s), 1);              // the producer lane
            sm90::mbar_init(sm90::bar_addr(bars, S + s), BN / 32);    // one arrival a consumer warp
        }
        sm90::mbar_init_fence();
    }
    __syncthreads();
    if (threadIdx.x >= BN) {                         // the producer warp
        if (threadIdx.x == BN) d_produce<X, W>(maps, p, base, Ly, bars, rows, n0, k_begin, steps);
        return;
    }
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
    const int nt = NT == 1 ? 1 : rows / 8;
    const DLane<X, W> o(w, lane, rows);
    float acc[2][NT][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
    for (int it = 0, st = 0, phase = 0; it < steps; ++it) {
        sm90::mbar_wait(sm90::bar_addr(bars, st), phase);
        d_compute<NT, X, W>(g + Ly.w + st * Ly.wb, g + Ly.s + st * SROWS * BN, g + st * Ly.xb, o,
                            nt, acc);
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(sm90::bar_addr(bars, S + st));
        if (++st == S) st = 0, phase ^= 1;
    }
    sm90::named_sync<1, BN>();                       // every consumer is done with the ring
    float* tile = reinterpret_cast<float*>(g);       // [M][BN]
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jj = 0; jj < NT; ++jj) {
            if (jj >= nt) break;
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int m = 8 * jj + 2 * t + (r & 1);
                if (m < p.M) tile[m * BN + d_col(w, lane >> 2, i, r >> 1)] = acc[i][jj][r];
            }
        }
    sm90::named_sync<1, BN>();
    d_finish<false>(p, tile, &last_flag);
}

template <int NT, int X, int W>
cudaError_t d_launch(const DParams& p, int splits, cudaStream_t stream) {
    static std::atomic<unsigned> ready{0};
    constexpr int XB = X == kXbf16 ? 2 : 1, epw = mx::per_word(W);
    const int rows = (p.M + 7) / 8 * 8;
    const DLayout Ly(W, XB, rows, p.stages);
    if (Ly.bytes > kDecodeSmemMax) return cudaErrorInvalidValue;
    cudaError_t err = sm90::allow_smem(mx_decode_kernel<NT, X, W>, kDecodeSmemMax, ready);
    if (err != cudaSuccess) return err;
    // the maps span the whole stack (L layers of rows); x's rows past M read as zeros
    DMaps maps{};
    const bool ok =
        make_map(&maps.x, X == kXbf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                 XB, p.x, p.M, p.K, rows, 128 / XB, CU_TENSOR_MAP_SWIZZLE_128B) &&
        make_word_map(&maps.w, p.wq, p.L * (p.K / epw), p.N, BK / epw) &&
        make_map(&maps.s, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, p.scales, p.L * (p.K / 32), p.N, SROWS,
                 BN, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (!ok) return cudaErrorInvalidValue;
    const dim3 grid(p.N / BN, splits);
    mx_decode_kernel<NT, X, W><<<grid, kDecodeThreads, Ly.bytes, stream>>>(maps, p);
    return cudaGetLastError();
}

template <int X, int W>
cudaError_t d_launch_rows(const DParams& p, int splits, cudaStream_t stream) {
    return p.M <= 8 ? d_launch<1, X, W>(p, splits, stream) : d_launch<8, X, W>(p, splits, stream);
}

// x_code: DType 2 (bf16) or 3 (e4m3); w_kind: mx::WKind
int d_run(DParams p, int x_code, int splits, cudaStream_t stream) {
    const bool shape_ok = p.M >= 1 && p.M <= 64 && p.N >= BN && p.N % BN == 0 && p.K >= BK &&
                          p.K % BK == 0 && (x_code == gl::kBF16 || x_code == 3) &&
                          p.wkind >= mx::kFp4 && p.wkind <= mx::kE5m2 && p.L >= 1;
    const bool split_ok = splits >= 1 && p.k_per_split > 0 && p.k_per_split % BK == 0 &&
                          (long long)(splits - 1) * p.k_per_split < p.K &&
                          (long long)splits * p.k_per_split >= p.K &&
                          (splits == 1 || (p.part != nullptr && p.counters != nullptr));
    const uintptr_t bases = reinterpret_cast<uintptr_t>(p.x) | reinterpret_cast<uintptr_t>(p.wq) |
                            reinterpret_cast<uintptr_t>(p.scales);
    if (!shape_ok || !split_ok || p.scales == nullptr || p.stages < 2 ||
        p.stages > kDecodeMaxStages || bases % 16)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err;
    if (x_code == gl::kBF16) {
        if (p.wkind == mx::kFp4) err = d_launch_rows<kXbf16, mx::kFp4>(p, splits, stream);
        else if (p.wkind == mx::kE4m3) err = d_launch_rows<kXbf16, mx::kE4m3>(p, splits, stream);
        else err = d_launch_rows<kXbf16, mx::kE5m2>(p, splits, stream);
    } else {
        if (p.wkind == mx::kFp4) err = d_launch_rows<kXe4m3, mx::kFp4>(p, splits, stream);
        else if (p.wkind == mx::kE4m3) err = d_launch_rows<kXe4m3, mx::kE4m3>(p, splits, stream);
        else err = d_launch_rows<kXe4m3, mx::kE5m2>(p, splits, stream);
    }
    return static_cast<int>(err);
}

// ---------------------------------------------------------------------------
// The ragged decode body (the general entry at M <= 64: fp4 layers off the
// JAX fold rule, any N, K a multiple of 32): 128 threads, a cp.async ring of
// 128-deep stages, what lies past N or K read as zeros
// ---------------------------------------------------------------------------

// word (r, c) of a stage: bits 3-4 of c flipped by r, so that a warp's lanes
// (rows t, columns g and g + 8 of two m16 tiles) hit 32 banks
__device__ __forceinline__ int w_idx(int r, int c) { return r * BN + (c ^ ((r & 3) << 3)); }
// byte offset of 16-byte chunk c of x row m (rows of BK * XB bytes)
template <int XB>
__device__ __forceinline__ int x_off(int m, int c) { return m * BK * XB + ((c ^ (m & 7)) << 4); }

// a stage: word rows, the scale rows, then x rows (`rows` = M rounded up to 8)
__host__ __device__ inline int r_words_bytes() { return BK / 8 * BN * 4; }
__host__ __device__ inline int r_stage_bytes(int rows, int xb) {
    return r_words_bytes() + SROWS * BN + rows * BK * xb;
}

// The words, scales and x of a stage: what lies past N or K reads as zeros
// (cp.async with no source bytes, or a zero stored). 16-byte copies where the
// rows allow them (N % 4 for the words, N % 16 for the scales), else 4-byte
// word copies and the scales byte by byte.
template <int XB>
__device__ __forceinline__ void r_load_stage(const DParams& p, unsigned char* st, int rows,
                                             int n0, int k0) {
    constexpr int wr = BK / 8;
    const int t = threadIdx.x;
    uint32_t* ws = reinterpret_cast<uint32_t*>(st);
    unsigned char* ss = st + r_words_bytes();
    unsigned char* xs = ss + SROWS * BN;
    const int wrows = min(wr, (p.K - k0) / 8), srows = min(SROWS, (p.K - k0) / 32);
    const int cols = min(BN, p.N - n0);
    const uint32_t* wg = p.wq + (size_t)(k0 / 8) * p.N + n0;
    const uint8_t* sg = p.scales + (size_t)(k0 / 32) * p.N + n0;
    if (p.N % 4 == 0) {
        for (int i = t; i < wr * (BN / 4); i += BN) {
            const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
            const bool ok = r < wrows && c < cols;
            cp_async16(smem_u32(ws + w_idx(r, c)), ok ? wg + (size_t)r * p.N + c : p.wq, ok ? 16 : 0);
        }
    } else {
        for (int i = t; i < wr * BN; i += BN) {
            const int r = i / BN, c = i % BN;
            const bool ok = r < wrows && c < cols;
            gl::cp_async4(smem_u32(ws + w_idx(r, c)), ok ? wg + (size_t)r * p.N + c : p.wq,
                          ok ? 4 : 0);
        }
    }
    if (p.N % 16 == 0) {
        if (t < SROWS * (BN / 16)) {
            const int r = t / (BN / 16), c = (t % (BN / 16)) * 16;
            const bool ok = r < srows && c < cols;
            cp_async16(smem_u32(ss + r * BN + c), ok ? sg + (size_t)r * p.N + c : p.scales,
                       ok ? 16 : 0);
        }
    } else {
        for (int i = t; i < SROWS * BN; i += BN) {
            const int r = i / BN, c = i % BN;
            ss[i] = r < srows && c < cols ? __ldg(sg + (size_t)r * p.N + c) : 0;
        }
    }
    constexpr int CH = BK * XB / 16;     // 16-byte chunks a row
    const unsigned char* x = static_cast<const unsigned char*>(p.x);
    for (int i = t; i < rows * CH; i += BN) {
        const int m = i / CH, c = i % CH;
        const bool ok = m < p.M && k0 + 16 / XB * c < p.K;
        cp_async16(smem_u32(xs + x_off<XB>(m, c)),
                   ok ? x + ((size_t)m * p.K + k0) * XB + 16 * c : x, ok ? 16 : 0);
    }
}

// One stage's products for one warp, as d_compute but on this ring's layout:
// columns wn0 + 16 i + g + 8 h, fp4 codes only.
template <int NT, int X>
__device__ __forceinline__ void r_compute_stage(const unsigned char* st, int nt, int wn0, int lane,
                                                float (&acc)[2][NT][4]) {
    const uint32_t* ws = reinterpret_cast<const uint32_t*>(st);
    const unsigned char* ss = st + r_words_bytes();
    const unsigned char* xs = ss + SROWS * BN;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kb = 0; kb < BK / 32; ++kb) {
        uint32_t a[2][2][4];
        float sc[2][2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int c = wn0 + 16 * i + 8 * h + g;
                sc[i][h] = mx::scale_f32(ss[kb * BN + c], false);
                const uint32_t word = ws[w_idx(4 * kb + t, c)];
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    a[j][i][h] = mx::raw_pair(word >> (16 * j), 0, mx::kFp4);
                    a[j][i][2 + h] = mx::raw_pair(word >> (16 * j), 2, mx::kFp4);
                }
            }
#pragma unroll
        for (int jj = 0; jj < NT; ++jj) {
            if (jj >= nt) break;
            const int m = 8 * jj + g;
            uint32_t b[2][2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int kl = 32 * kb + 8 * t + 4 * j;
                if constexpr (X == kXbf16) {
                    const uint2 xv = *reinterpret_cast<const uint2*>(
                        xs + x_off<2>(m, kl >> 3) + 2 * (kl & 7));
                    b[j][0] = xv.x, b[j][1] = xv.y;
                } else {
                    const uint32_t xv = *reinterpret_cast<const uint32_t*>(
                        xs + x_off<1>(m, kl >> 4) + (kl & 15));
                    b[j][0] = e4m3x2_bf16x2(xv), b[j][1] = e4m3x2_bf16x2(xv >> 16);
                }
            }
#pragma unroll
            for (int i = 0; i < 2; ++i) group_sum(acc[i][jj], a[0][i], a[1][i], b, sc[i]);
        }
    }
}

template <int NT, int X>
__global__ void __launch_bounds__(BN, kRaggedMinBlocks) mx_ragged_decode_kernel(DParams p) {
    constexpr int XB = X == kXbf16 ? 2 : 1;
    extern __shared__ __align__(128) unsigned char smem[];
    __shared__ int last_flag;
    const int rows = (p.M + 7) / 8 * 8;
    const int S = p.stages, SB = r_stage_bytes(rows, XB);
    const int lane = threadIdx.x & 31, wn0 = (threadIdx.x >> 5) * 32;
    const int g = lane >> 2, t = lane & 3;
    const int n0 = blockIdx.x * BN, k_begin = blockIdx.y * p.k_per_split;
    const int span = min(p.K, k_begin + p.k_per_split) - k_begin;
    const int steps = (span + BK - 1) / BK;          // the last partly past K
    const int nt = rows / 8;

    float acc[2][NT][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

    for (int s = 0; s < S - 1; ++s) {
        if (s < steps) r_load_stage<XB>(p, smem + s * SB, rows, n0, k_begin + s * BK);
        cp_async_commit();
    }
    for (int it = 0; it < steps; ++it) {
        cp_async_wait_n(S - 2);          // stage it has landed
        __syncthreads();                 // and every warp is done with stage it - 1
        const int nxt = it + S - 1;
        if (nxt < steps) r_load_stage<XB>(p, smem + (nxt % S) * SB, rows, n0, k_begin + nxt * BK);
        cp_async_commit();
        r_compute_stage<NT, X>(smem + (it % S) * SB, nt, wn0, lane, acc);
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
    d_finish<true>(p, tile, &last_flag);
}

template <int NT, int X>
cudaError_t r_launch(const DParams& p, int splits, cudaStream_t stream) {
    static std::atomic<unsigned> ready{0};
    constexpr int XB = X == kXbf16 ? 2 : 1;
    cudaError_t err = sm90::allow_smem(mx_ragged_decode_kernel<NT, X>, kDecodeSmemMax, ready);
    if (err != cudaSuccess) return err;
    const int rows = (p.M + 7) / 8 * 8;
    const int ring = p.stages * r_stage_bytes(rows, XB), tile = p.M * BN * 4;
    const int bytes = ring > tile ? ring : tile;
    if (bytes > kDecodeSmemMax) return cudaErrorInvalidValue;
    const dim3 grid((p.N + BN - 1) / BN, splits);
    mx_ragged_decode_kernel<NT, X><<<grid, BN, bytes, stream>>>(p);
    return cudaGetLastError();
}

template <int X>
cudaError_t r_launch_rows(const DParams& p, int splits, cudaStream_t stream) {
    return p.M <= 8 ? r_launch<1, X>(p, splits, stream) : r_launch<8, X>(p, splits, stream);
}

// ---------------------------------------------------------------------------
// Prefill, M < 4096
// ---------------------------------------------------------------------------

constexpr int PBK = 64;                       // K a stage: one 128-byte row of bf16 x
constexpr int kConsumers = 256;               // two warpgroups of 64 columns
// registers a thread after setmaxnreg (producer, consumer): bf16 x, 384
// threads; e4m3 codes, 512
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
constexpr int kCodeProducerRegs = 40, kCodeConsumerRegs = 216;
constexpr int kPrefillSmemMax = 227 * 1024;
constexpr int kTileStride = BN + 4;           // floats a row of the epilogue tile
constexpr int kSStage = 512;                  // a stage's scale rows (2 or 4 of 128 bytes)
constexpr int kXBufs = 3;                     // the code form's bf16 x tiles
constexpr int kConverters = 224;              // the code form's converting threads: producer warps 1-7

// the block: two consumer warpgroups and one producer warpgroup, or for the
// code form two (one loading warp and seven converting warps)
__host__ __device__ constexpr int p_threads(int xc) { return kConsumers + (xc ? 256 : 128); }

// a stage's bf16 x tile, e4m3 codes and x group scales (4 floats a row), for
// NB blocks of 128 rows
__host__ __device__ constexpr int p_x_bytes(int nb) { return nb * 128 * PBK * 2; }
__host__ __device__ constexpr int p_c_bytes(int nb) { return nb * 128 * PBK; }
__host__ __device__ constexpr int p_xs_bytes(int nb) { return nb * 128 * 16; }

struct PParams {
    const float* xs;                          // (M, K / ags) group scales of the codes, or null
    const float* sx;                          // (M) per-token scales, or null
    bf16* out;                                // (M, N)
    float* part;                              // (splits, M, N); ragged: (splits, M, tiles 128)
    int* counters;                            // one per output tile, 0 between calls
    int M, N, K, k_per_split, stages, wkind, gs, ags;
    const uint32_t* wq;                       // the words and scales, for the ragged
    const uint8_t* scales;                    // instance's copies where TMA cannot go
};

// x: bf16 (128-byte swizzle) or e4m3 codes; xs: the codes' group scales
struct PMaps {
    CUtensorMap x, xs, w, s;
};

__host__ __device__ inline int p_w_bytes(int wkind) { return PBK / mx::per_word(wkind) * BN * 4; }

// Shared memory from a 1024-byte aligned base: the bf16 x tiles (one a stage
// for bf16 x, kXBufs for the code form), the word ring, the scale ring, and
// for the code form the codes ring and the x scale ring; the epilogue tile
// over them once they are free; the mbarriers (full and empty, one a stage;
// the code form's "x ready" and "x free", one each a tile) and the last-block
// flag. ops/mx.prefill_smem mirrors `bytes`.
struct PLayout {
    int xbufs, w, s, c, xs, bars, flag, bytes;
    __host__ __device__ PLayout(int wkind, int stages, int nb, bool codes) {
        xbufs = codes ? kXBufs : stages;
        w = xbufs * p_x_bytes(nb);
        s = w + stages * p_w_bytes(wkind);
        c = s + stages * kSStage;
        xs = c + (codes ? stages * p_c_bytes(nb) : 0);
        const int ring = xs + (codes ? stages * p_xs_bytes(nb) : 0);
        const int tile = nb * 128 * kTileStride * 4;
        bars = ring > tile ? ring : tile;
        flag = bars + 8 * (2 * stages + (codes ? 2 * kXBufs : 0));
        bytes = flag + 16 + 1024;
    }
};

__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The ragged instance's words (N % 4 != 0) or scales (N % 16 != 0) of a
// stage, whose rows TMA cannot take (its global strides are multiples of 16
// bytes), copied by the loading warp's lanes; what lies past N or K is
// stored as zeros, as TMA fills it.
template <int W>
__device__ __forceinline__ void p_copy_edge(const PParams& p, uint8_t* wt, uint8_t* st, int n0,
                                            int k0, bool words, bool scales, int lane) {
    constexpr int epw = mx::per_word(W), wr = PBK / epw;
    const int cols = min(BN, p.N - n0);
    if (words) {
        const int rows = min(wr, (p.K - k0) / epw);
        const uint32_t* wg = p.wq + (size_t)(k0 / epw) * p.N + n0;
        uint32_t* w = reinterpret_cast<uint32_t*>(wt);
        for (int i = lane; i < wr * BN; i += 32) {
            const int r = i / BN, c = i % BN;
            w[i] = r < rows && c < cols ? __ldg(wg + (size_t)r * p.N + c) : 0u;
        }
    }
    if (scales) {
        const int sr = PBK / p.gs, rows = min(sr, (p.K - k0) / p.gs);
        const uint8_t* sg = p.scales + (size_t)(k0 / p.gs) * p.N + n0;
        for (int i = lane; i < sr * BN; i += 32) {
            const int r = i / BN, c = i % BN;
            st[i] = r < rows && c < cols ? __ldg(sg + (size_t)r * p.N + c) : 0;
        }
    }
}

// The loading warp (producer warp 0): per stage, once the consumers have
// released it, one lane arms the stage's full mbarrier and issues every copy
// by TMA: the bf16 x box, or the e4m3 code box and the codes' group scales;
// the word rows; the scale rows. No copy waits for a conversion, so the ring
// keeps `stages` stages of copies in flight. The ragged instance's lanes copy
// the words or scales themselves where their rows are no multiple of 16
// bytes, and each arrives on the full mbarrier once its stores are done.
template <int XC, int W, int NB, bool R>
__device__ __forceinline__ void p_load(const PParams& p, const PMaps& maps, uint8_t* g,
                                       uint32_t base, const PLayout& L, int n0, int m0,
                                       int k_begin, int steps) {
    const int lane = threadIdx.x % 32, S = p.stages;
    const uint32_t bars = base + L.bars;
    const int wb = p_w_bytes(W), sb = PBK / p.gs * BN;
    const bool w_tma = !R || p.N % 4 == 0, s_tma = !R || p.N % 16 == 0;
    const bool xs = XC && p.xs != nullptr;
    const uint32_t bytes = (XC ? p_c_bytes(NB) + (xs ? p_xs_bytes(NB) : 0) : p_x_bytes(NB)) +
                           (w_tma ? wb : 0) + (s_tma ? sb : 0);
    for (int it = 0; it < steps; ++it) {
        const int st = it % S, k0 = k_begin + it * PBK;
        const uint32_t full = sm90::bar_addr(bars, st);
        if (it >= S) sm90::mbar_wait(sm90::bar_addr(bars, S + st), ((it / S) & 1) ^ 1);
        if (lane == 0) {
            sm90::mbar_expect_tx(full, bytes);
            if constexpr (XC) {
                sm90::tma_load_2d(base + L.c + st * p_c_bytes(NB), &maps.x, full, k0, m0);
                if (xs)   // 4 groups from a 16-byte aligned one, the stage's among them
                    sm90::tma_load_2d(base + L.xs + st * p_xs_bytes(NB), &maps.xs, full,
                                      k0 / p.ags & ~3, m0);
            } else {
                sm90::tma_load_2d(base + st * p_x_bytes(NB), &maps.x, full, k0, m0);
            }
            if (w_tma)
                sm90::tma_load_2d(base + L.w + st * wb, &maps.w, full, n0, k0 / mx::per_word(W));
            if (s_tma)
                sm90::tma_load_2d(base + L.s + st * kSStage, &maps.s, full, n0, k0 / p.gs);
        }
        if constexpr (R) {
            if (!w_tma || !s_tma)
                p_copy_edge<W>(p, g + L.w + st * wb, g + L.s + st * kSStage, n0, k0, !w_tma,
                               !s_tma, lane);
            sm90::mbar_arrive(full);
        }
    }
}

// How the code form scales its codes: NVFP4's group scale (e4m3 x 0.05) in
// float32, then one rounding to bf16; an e8m0 group scale (a power of two,
// MXFP4 / MXFP8 x) by one bf16x2 multiply of the exact pair, the same bits;
// per-token codes not at all (their scale is applied to the sums).
enum XScale { kXScaleF32 = 0, kXScalePow2 = 1, kXScaleNone = 2 };

// The code form's converting warps (producer warps 1-7), inside the ring:
// per stage, once its copies have landed and its bf16 tile is free (its "x
// free" mbarrier: the consumers released the stage kXBufs before), each
// 16-code piece of the code box times its row's group scale, rounded once to
// bf16 into the 128-byte swizzled tile: the bits of fake_quant_activations.
// Then made visible to the async proxy,
// and one arrival a warp on the tile's "x ready" mbarrier, which the
// consumers wait for before their products. While stage j is converted, the
// copies of the stages after it are in flight.
template <int NB, int XS>
__device__ __forceinline__ void p_convert(const PParams& p, uint8_t* g, uint32_t base,
                                          const PLayout& L, int k_begin, int steps) {
    // piece i of this thread: row m = ctid / 4 + kStep i, codes 16 c .. 16 c
    // + 15 (c = ctid % 4), into the tile's 16-byte chunks 2 c and 2 c + 1 of
    // row m; kStep is a multiple of 8 rows, so c, m % 8 and the swizzle stay
    // fixed and every address moves by a constant
    constexpr int kRows = NB * 128;
    constexpr int kStep = kConverters / 4, kPieces = (kRows + kStep - 1) / kStep;
    static_assert(kStep % 8 == 0, "the swizzle repeats every 8 rows");
    const int ctid = threadIdx.x - kConsumers - 32, S = p.stages;
    const int c = ctid % 4, m0 = ctid / 4;
    const int sw0 = ((2 * c) ^ (m0 % 8)) << 4, sw1 = ((2 * c + 1) ^ (m0 % 8)) << 4;
    const uint32_t bars = base + L.bars;
    const int gsh = p.ags == 32 ? 5 : 4;                    // log2 ags
    for (int it = 0; it < steps; ++it) {
        const int st = it % S, xb = it % kXBufs;
        if (it >= kXBufs)
            sm90::mbar_wait(sm90::bar_addr(bars, 2 * S + kXBufs + xb), (it / kXBufs - 1) & 1);
        sm90::mbar_wait(sm90::bar_addr(bars, st), (it / S) & 1);
        // the stage's first group in its scale box, then this thread's group
        const int gi = ((k_begin + it * PBK) >> gsh & 3) + (c << 4 >> gsh);
        const uint8_t* cs = g + L.c + st * p_c_bytes(NB) + m0 * PBK + 16 * c;
        const float* ss = reinterpret_cast<const float*>(g + L.xs + st * p_xs_bytes(NB)) + 4 * m0 + gi;
        uint8_t* xt = g + xb * p_x_bytes(NB) + m0 * 128;
#pragma unroll
        for (int i = 0; i < kPieces; ++i) {
            if (m0 + kStep * i >= kRows) break;
            const uint4 raw = *reinterpret_cast<const uint4*>(cs + kStep * PBK * i);
            const float sc = XS == kXScaleNone ? 1.f : ss[4 * kStep * i];
            const uint32_t s2 = (__float_as_uint(sc) >> 16) * 0x00010001u;   // exact for 2^k
            const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
            uint32_t o[8];
#pragma unroll
            for (int q = 0; q < 8; ++q) {
                const float2 f = mx::fp8x2_f32x2(w[q >> 1] >> (16 * (q & 1)), false);
                if constexpr (XS == kXScaleF32)
                    o[q] = mx::bf16x2(__fmul_rn(f.x, sc), __fmul_rn(f.y, sc));
                else if constexpr (XS == kXScalePow2)
                    o[q] = mx::mul_bf16x2(mx::bf16x2(f.x, f.y), s2);
                else
                    o[q] = mx::bf16x2(f.x, f.y);
            }
            *reinterpret_cast<uint4*>(xt + 128 * kStep * i + sw0) = make_uint4(o[0], o[1], o[2], o[3]);
            *reinterpret_cast<uint4*>(xt + 128 * kStep * i + sw1) = make_uint4(o[4], o[5], o[6], o[7]);
        }
        fence_proxy_async();
        __syncwarp();
        if (threadIdx.x % 32 == 0) sm90::mbar_arrive(sm90::bar_addr(bars, 2 * S + xb));
    }
}

// The A fragments of one stage for this lane (column col, and col + 8):
// a[kk][2 half + h] = the decoded weights at k 16 kk + 8 half + 2t, + 1 of
// column col + 8 h: fp4 nibbles 2t, 2t + 1 of word row 2 kk + half, fp8 bytes
// 2 (t & 1), + 1 of word row 4 kk + 2 half + t / 2; the group's scale row is
// (16 kk) / gs. Each pair is decoded exactly to bf16x2, then times its e8m0
// scale by one bf16x2 multiply (NV: NVFP4's float32 scale, one float32
// multiply a weight and one rounding).
template <int W, bool NV>
__device__ __forceinline__ void p_build(uint32_t (&a)[4][4], const uint8_t* g, int wofs, int sofs,
                                        int col, int t) {
    const uint32_t* ws = reinterpret_cast<const uint32_t*>(g + wofs) + col;
    const uint8_t* ss = g + sofs + col;
    constexpr bool fp4 = W == mx::kFp4;
    constexpr int gs = NV ? 16 : 32;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const uint32_t sbyte = ss[(16 * kk / gs) * BN + 8 * h];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const uint32_t w = fp4 ? ws[(2 * kk + half) * BN + 8 * h] >> (8 * t)
                                       : ws[(4 * kk + 2 * half + (t >> 1)) * BN + 8 * h] >> (16 * (t & 1));
                if constexpr (NV)
                    a[kk][2 * half + h] = mx::decode_pair(w, 0, W, mx::scale_f32(sbyte, true));
                else
                    a[kk][2 * half + h] = mx::decode_e8m0_pair(w, 0, W, sbyte);
            }
        }
}

// The block's sums, staged as tile[m][kTileStride] for rows m0 .. m0 + bm - 1:
// into the output (times the per-token scale), or with K split the block's
// partial, and the last block of the tile adds the partials in split order.
// Consumer threads only. Not inlined. The ragged instance's partials have
// rows of whole tiles, and its columns past N are not written.
template <bool R>
__device__ __noinline__ void p_finish(const PParams p, const float* tile, int* flag, int m0,
                                      int bm) {
    const int tid = threadIdx.x, n0 = blockIdx.y * BN;
    const int split = blockIdx.z, nsplit = gridDim.z;
    const int ctr = blockIdx.x + gridDim.x * blockIdx.y;
    const int rows = min(bm, p.M - m0);
    const int ld = R ? gridDim.y * BN : p.N;         // a row of the partials
    const size_t MN = (size_t)p.M * ld;
    if (nsplit > 1) {
        for (int e = tid * 4; e < rows * BN; e += kConsumers * 4) {
            const int m = e / BN, c = e % BN;
            *reinterpret_cast<float4*>(p.part + split * MN + (size_t)(m0 + m) * ld + n0 + c) =
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
        if (R && n >= p.N) continue;
        const size_t idx = (size_t)(m0 + m) * ld + n;
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
        if (p.sx != nullptr) {
            const float s = p.sx[m0 + m];
#pragma unroll
            for (int i = 0; i < 8; ++i) v[i] = __fmul_rn(v[i], s);
        }
        bf16* o = p.out + (size_t)(m0 + m) * p.N + n;
        if (R && p.N % 8) {              // rows off 16-byte alignment: one value at a time
            for (int i = 0; i < 8 && n + i < p.N; ++i) o[i] = __float2bfloat16_rn(v[i]);
            continue;
        }
        uint4 pk;
        pk.x = mx::bf16x2(v[0], v[1]);
        pk.y = mx::bf16x2(v[2], v[3]);
        pk.z = mx::bf16x2(v[4], v[5]);
        pk.w = mx::bf16x2(v[6], v[7]);
        *reinterpret_cast<uint4*>(o) = pk;
    }
    if (nsplit > 1 && tid == 0) p.counters[ctr] = 0;
}

// What a consumer thread needs across the steps of its pipeline.
template <int XC, int W, bool NV, int NB>
struct PConsumer {
    uint8_t* g;
    uint32_t base, bars;
    const PLayout* L;
    int S, col, t, lane;

    __device__ __forceinline__ void full(int it) const {
        sm90::mbar_wait(sm90::bar_addr(bars, it % S), (it / S) & 1);
    }
    // the code form's bf16 tile of stage it is written
    __device__ __forceinline__ void x_ready(int it) const {
        if constexpr (XC)
            sm90::mbar_wait(sm90::bar_addr(bars, 2 * S + it % kXBufs), (it / kXBufs) & 1);
    }
    // the stage is free for the producer, and the code form's tile for the
    // converting warps: one arrival a warp each
    __device__ __forceinline__ void release(int it) const {
        __syncwarp();
        if (lane == 0) {
            sm90::mbar_arrive(sm90::bar_addr(bars, S + it % S));
            if constexpr (XC) sm90::mbar_arrive(sm90::bar_addr(bars, 2 * S + kXBufs + it % kXBufs));
        }
    }
    __device__ __forceinline__ uint64_t x_desc(int it) const {
        return sm90::sw128_desc(base + it % L->xbufs * p_x_bytes(NB), 16, 1024);
    }
    __device__ __forceinline__ void build(uint32_t (&a)[4][4], int it) const {
        p_build<W, NV>(a, g, L->w + it % S * p_w_bytes(W), L->s + it % S * kSStage, col, t);
    }
};

// One stage's products: for each 16-deep step, NB n128 wgmmas over the x
// rows (128 rows of 128 bytes apart), 32 bytes into each swizzle row a step;
// each A fragment of decoded weights serves all NB of them. The accumulators
// are pinned only where no product is in flight (any instruction that
// touches them while one is makes ptxas serialize the wgmmas, note C7514);
// the fragments just built are pinned here.
template <int NB>
__device__ __forceinline__ void p_issue(float (&acc)[NB][64], uint32_t (&a)[4][4], uint64_t dx) {
    sm90::pin(a);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
            sm90::wgmma_rs_n128<0>(acc[nb], a[kk], dx + ((nb * 128 * 128 + kk * 32) >> 4), 1);
    sm90::wgmma_commit();
}

// One step of the consumer pipeline: stage j's products are in flight;
// queue stage j + 1's behind them (buffer ISSUE), wait for stage j alone,
// release it, and build stage j + 2's A fragments into stage j's buffer
// while stage j + 1's run. Every call issues: a wgmma under a branch leaves
// ptxas copying in-flight accumulators where the paths meet (note C7514), so
// the tail is unrolled.
template <int ISSUE, int XC, int W, bool NV, int NB>
__device__ __forceinline__ void p_step(const PConsumer<XC, W, NV, NB>& c, float (&acc)[NB][64],
                                       uint32_t (&a)[2][4][4], int j, int steps) {
    c.x_ready(j + 1);
    p_issue<NB>(acc, a[ISSUE], c.x_desc(j + 1));
    sm90::wgmma_wait<1>();
    sm90::pin(a[1 - ISSUE]);
    c.release(j);
    if (j + 2 < steps) {
        c.full(j + 2);
        c.build(a[1 - ISSUE], j + 2);
    }
}

// The consumer warpgroups: 64 weight columns each, all the block's rows.
template <int XC, int W, bool NV, int NB, bool R>
__device__ __forceinline__ void p_consume(const PParams& p, uint8_t* g, uint32_t base,
                                          const PLayout& L, int wg, int m0, int steps, int* flag) {
    if constexpr (XC)
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kCodeConsumerRegs));
    else
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int lane = threadIdx.x % 32, t = lane % 4;
    const int col = wg * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;   // and col + 8
    const PConsumer<XC, W, NV, NB> c{g, base, base + L.bars, &L, p.stages, col, t, lane};

    float acc[NB][64];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[nb][i] = 0.f;
    uint32_t a[2][4][4];                      // stage s in buffer s % 2
    c.full(0);
    c.build(a[0], 0);
    c.x_ready(0);
    p_issue<NB>(acc, a[0], c.x_desc(0));
    if (steps > 1) {
        c.full(1);
        c.build(a[1], 1);
    }
    int j = 0;
    for (; j + 2 < steps; j += 2) {
        p_step<1>(c, acc, a, j, steps);
        p_step<0>(c, acc, a, j + 1, steps);
    }
    if (j + 1 < steps) {                      // the last stage; both paths drain
        p_step<1>(c, acc, a, j, steps);
        sm90::wgmma_wait<0>();
    } else {
        sm90::wgmma_wait<0>();
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) sm90::pin(acc[nb]);

    sm90::named_sync<1, kConsumers>();        // both warpgroups are done with the ring
    float* tile = reinterpret_cast<float*>(g);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int n8 = 0; n8 < 16; ++n8)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                tile[(nb * 128 + 8 * n8 + 2 * t + (e & 1)) * kTileStride + col + 8 * (e >> 1)] =
                    acc[nb][4 * n8 + e];
    sm90::named_sync<1, kConsumers>();
    p_finish<R>(p, tile, flag, m0, NB * 128);
}

// XC: x as e4m3 codes; W: the weight codes; NV: NVFP4 scales (else e8m0);
// NB: 128-row blocks of x a block; R: the ragged instance.
template <int XC, int W, bool NV, int NB, bool R>
__global__ void __launch_bounds__(p_threads(XC), 1)
mx_prefill_kernel(const __grid_constant__ PMaps maps, const PParams p) {
    extern __shared__ uint8_t smem_raw[];
    const PLayout L(W, p.stages, NB, XC);
    const uint32_t base = sm90::smem_base(smem_raw), bars = base + L.bars;
    uint8_t* g = smem_raw + (base - sm90::smem_addr(smem_raw));
    const int n0 = blockIdx.y * BN, m0 = blockIdx.x * NB * 128;
    const int k_begin = blockIdx.z * p.k_per_split;
    const int span = min(p.K, k_begin + p.k_per_split) - k_begin;
    const int steps = R ? (span + PBK - 1) / PBK : span / PBK;   // ragged: the last partly past K
    if (threadIdx.x == 0) {
        for (int s = 0; s < p.stages; ++s) {
            sm90::mbar_init(sm90::bar_addr(bars, s), R ? 33 : 1);   // the TMA lane (and the copying lanes)
            sm90::mbar_init(sm90::bar_addr(bars, p.stages + s), kConsumers / 32);
        }
        if (XC)
            for (int b = 0; b < kXBufs; ++b) {
                sm90::mbar_init(sm90::bar_addr(bars, 2 * p.stages + b), kConverters / 32);
                sm90::mbar_init(sm90::bar_addr(bars, 2 * p.stages + kXBufs + b), kConsumers / 32);
            }
        sm90::mbar_init_fence();
    }
    __syncthreads();
    const int wg = sm90::warpgroup();
    if (wg >= 2) {
        if constexpr (XC)
            asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kCodeProducerRegs));
        else
            asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
        if (threadIdx.x < kConsumers + 32) {
            p_load<XC, W, NB, R>(p, maps, g, base, L, n0, m0, k_begin, steps);
        } else if constexpr (XC) {
            if (p.xs == nullptr) p_convert<NB, kXScaleNone>(p, g, base, L, k_begin, steps);
            else if (p.ags == 32) p_convert<NB, kXScalePow2>(p, g, base, L, k_begin, steps);
            else p_convert<NB, kXScaleF32>(p, g, base, L, k_begin, steps);
        }
    } else {
        p_consume<XC, W, NV, NB, R>(p, g, base, L, wg, m0, steps,
                                    reinterpret_cast<int*>(g + L.flag));
    }
}

template <int XC, int W, bool NV, int NB, bool R>
cudaError_t p_launch(const void* x, const PParams& p, int splits, cudaStream_t stream) {
    static std::atomic<unsigned> ready{0};
    constexpr int bm = NB * 128, epw = mx::per_word(W);
    const PLayout L(W, p.stages, NB, XC);
    if (L.bytes > kPrefillSmemMax) return cudaErrorInvalidValue;
    PMaps maps{};
    // x: boxes of 64 k by the block's rows; the codes' scales: 4 a row from a
    // 16-byte aligned group (TMA's least box row and its alignment), of which
    // a stage of groups of 32 uses 2
    const bool x_ok =
        XC ? make_map(&maps.x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, x, p.M, p.K, bm, PBK,
                      CU_TENSOR_MAP_SWIZZLE_NONE) &&
                 (p.xs == nullptr || make_map(&maps.xs, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, p.xs,
                                              p.M, p.K / p.ags, bm, 4, CU_TENSOR_MAP_SWIZZLE_NONE))
           : make_map(&maps.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, p.M, p.K, bm, PBK,
                      CU_TENSOR_MAP_SWIZZLE_128B);
    if (!x_ok) return cudaErrorInvalidValue;
    // the ragged instance's loading lanes copy what TMA cannot take (p_copy_edge)
    const bool w_tma = !R || p.N % 4 == 0, s_tma = !R || p.N % 16 == 0;
    if ((w_tma && !make_map(&maps.w, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, p.wq, p.K / epw, p.N,
                            PBK / epw, BN, CU_TENSOR_MAP_SWIZZLE_NONE)) ||
        (s_tma && !make_map(&maps.s, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, p.scales, p.K / p.gs, p.N,
                            PBK / p.gs, BN, CU_TENSOR_MAP_SWIZZLE_NONE)))
        return cudaErrorInvalidValue;
    const cudaError_t err =
        sm90::allow_smem(mx_prefill_kernel<XC, W, NV, NB, R>, kPrefillSmemMax, ready);
    if (err != cudaSuccess) return err;
    // row tiles fastest: the blocks of one column tile share its words in L2
    const dim3 grid((p.M + bm - 1) / bm, (p.N + BN - 1) / BN, splits);
    mx_prefill_kernel<XC, W, NV, NB, R><<<grid, p_threads(XC), L.bytes, stream>>>(maps, p);
    return cudaGetLastError();
}

template <int XC, int W, bool NV, bool R>
cudaError_t p_rows(const void* x, const PParams& p, int bm, int splits, cudaStream_t stream) {
    return bm == 128 ? p_launch<XC, W, NV, 1, R>(x, p, splits, stream)
                     : p_launch<XC, W, NV, 2, R>(x, p, splits, stream);
}

// the instance of the weight kind, the scale form (gs 16: NVFP4) and the
// plan's rows; the ragged instances take fp4 codes only
template <int XC, bool R>
cudaError_t p_run(const void* x, const PParams& p, int bm, int splits, cudaStream_t stream) {
    if (p.gs == 16) return p_rows<XC, mx::kFp4, true, R>(x, p, bm, splits, stream);
    if constexpr (R) {
        return p_rows<XC, mx::kFp4, false, R>(x, p, bm, splits, stream);
    } else {
        if (p.wkind == mx::kFp4) return p_rows<XC, mx::kFp4, false, R>(x, p, bm, splits, stream);
        if (p.wkind == mx::kE4m3) return p_rows<XC, mx::kE4m3, false, R>(x, p, bm, splits, stream);
        return p_rows<XC, mx::kE5m2, false, R>(x, p, bm, splits, stream);
    }
}

}  // namespace

// Launch on `stream` (M <= 64). x (M, K) bf16 (x_code 2) or per-token e4m3
// (x_code 3, with sx (M) float32; else sx null); wq (K / per_word, N) codes of
// w_kind (0 fp4, 1 e4m3, 2 e5m2), scales (K / 32, N) e8m0 bits. N and K
// multiples of 128. K is cut into `splits` ranges of `k_per_split` (a multiple
// of 128, none empty); with splits > 1 the call needs `part`, (splits, M, N)
// floats, and `counters`, one int32 per column tile, all 0, which the kernel
// leaves 0. `stages` comes from ops/mx.decode_plan. Returns the cudaError_t of
// the launch (0 on success).
extern "C" int gl_mx_decode(const void* x, const void* wq, const void* scales, const void* sx,
                            void* part, void* counters, void* out, int M, int N, int K, int x_code,
                            int w_kind, int splits, int k_per_split, int stages, void* stream_ptr) {
    const DParams p{x, static_cast<const uint32_t*>(wq), static_cast<const uint8_t*>(scales),
                    static_cast<const float*>(sx), nullptr, 1, static_cast<bf16*>(out),
                    static_cast<float*>(part), static_cast<int*>(counters),
                    M, N, K, k_per_split, stages, w_kind};
    return d_run(p, x_code, splits, static_cast<cudaStream_t>(stream_ptr));
}

// The same for layer *layer_idx (a device pointer to one int32) of the
// L-layer stacks wq (L, K / per_word, N) and scales (L, K / 32, N).
extern "C" int gl_mx_decode_stacked(const void* x, const void* wq, const void* scales,
                                    const void* sx, const void* layer_idx, void* part,
                                    void* counters, void* out, int L, int M, int N, int K,
                                    int x_code, int w_kind, int splits, int k_per_split,
                                    int stages, void* stream_ptr) {
    if (layer_idx == nullptr || L < 1) return static_cast<int>(cudaErrorInvalidValue);
    const DParams p{x, static_cast<const uint32_t*>(wq), static_cast<const uint8_t*>(scales),
                    static_cast<const float*>(sx), static_cast<const int*>(layer_idx), L,
                    static_cast<bf16*>(out), static_cast<float*>(part), static_cast<int*>(counters),
                    M, N, K, k_per_split, stages, w_kind};
    return d_run(p, x_code, splits, static_cast<cudaStream_t>(stream_ptr));
}

// Launch on `stream` (M < 4096). x (M, K): bf16 (x_code 2), or e4m3 codes
// (x_code 3) with `xs` (M, K / ags) float32 group scales (csm 4; ags 16 or
// 32) or null (per-token codes: csm 2, with sx (M) float32), all read by TMA;
// wq and w_kind as for gl_mx_decode; scales (K / gs, N): e8m0 bits (gs 32) or
// NVFP4 e4m3 (gs 16). `bm` (128 or 256) rows of x a block, stages of 64 k; K
// cut into `splits` ranges of `k_per_split` (a multiple of 64); `bm`, the
// split and `stages` (at least 3 for codes) from ops/mx.prefill_plan.
extern "C" int gl_mx_prefill(const void* x, const void* xs, const void* wq, const void* scales,
                             const void* sx, void* part, void* counters, void* out, int M, int N,
                             int K, int x_code, int ags, int w_kind, int gs, int bm, int splits,
                             int k_per_split, int stages, void* stream_ptr) {
    const bool codes = x_code == 3;
    const bool shape_ok = M >= 1 && N >= BN && N % BN == 0 && K >= 128 && K % 128 == 0 &&
                          (x_code == gl::kBF16 || codes) && w_kind >= mx::kFp4 &&
                          w_kind <= mx::kE5m2 && (gs == 32 || (gs == 16 && w_kind == mx::kFp4)) &&
                          (xs == nullptr || (codes && (ags == 16 || ags == 32))) &&
                          (bm == 128 || bm == 256);
    const bool split_ok = splits >= 1 && k_per_split > 0 && k_per_split % PBK == 0 &&
                          (long long)(splits - 1) * k_per_split < K &&
                          (long long)splits * k_per_split >= K &&
                          (splits == 1 || (part != nullptr && counters != nullptr));
    const uintptr_t bases = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(xs) |
                            reinterpret_cast<uintptr_t>(wq) | reinterpret_cast<uintptr_t>(scales) |
                            reinterpret_cast<uintptr_t>(out);
    if (!shape_ok || !split_ok || scales == nullptr || stages < 2 || stages > kMaxStages ||
        bases % 16)
        return static_cast<int>(cudaErrorInvalidValue);
    const PParams p{static_cast<const float*>(xs), static_cast<const float*>(sx),
                    static_cast<bf16*>(out), static_cast<float*>(part),
                    static_cast<int*>(counters), M, N, K, k_per_split, stages, w_kind, gs,
                    xs != nullptr ? ags : 32, static_cast<const uint32_t*>(wq),
                    static_cast<const uint8_t*>(scales)};
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const cudaError_t err = codes ? p_run<1, false>(x, p, bm, splits, stream)
                                  : p_run<0, false>(x, p, bm, splits, stream);
    return static_cast<int>(err);
}

// General fp4 layers (off the JAX fold rule), on the ragged instances (R) of
// the two bodies: the last column tile hangs past N and the last stage past
// K; what lies past either reads as zeros (words, scales and x alike, so no
// stale value meets a zero weight) and is not written.
//
// Launch on `stream` (M < 4096). x (M, K): bf16 (x_code 2) or per-token e4m3
// (x_code 3, with sx (M) float32; else sx null); wq (K / 8, N) fp4 codes;
// scales (K / 16, N) NVFP4 e4m3 (nvfp4 1) or (K / 32, N) e8m0 bits (nvfp4 0).
// K a multiple of 8 and of the group, any N >= 1; x, wq, scales and out
// 16-byte aligned. M <= 64 with e8m0 scales runs the decode body (stages of
// 128), else the prefill body (stages of 64, `bm` 128 or 256 rows of x a
// block; the decode body ignores `bm`); K is cut into `splits` ranges of
// `k_per_split` (a multiple of the stage, none empty) and `stages` is the
// ring, all from ops/mx.general_plan. With splits > 1 the call needs `part`,
// (splits, M, 128 ceil(N / 128)) floats, and `counters`, one int32 per output
// tile, all 0, which the kernel leaves 0.
extern "C" int gl_mx_general(const void* x, const void* wq, const void* scales, const void* sx,
                             void* part, void* counters, void* out, int M, int N, int K,
                             int x_code, int nvfp4, int bm, int splits, int k_per_split,
                             int stages, void* stream_ptr) {
    const int gs = nvfp4 ? 16 : 32;
    const uintptr_t bases = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wq) |
                            reinterpret_cast<uintptr_t>(scales) | reinterpret_cast<uintptr_t>(out);
    const bool ok = M >= 1 && M < 4096 && N >= 1 && K >= gs && K % 8 == 0 && K % gs == 0 &&
                    (x_code == gl::kBF16 || x_code == 3) && (nvfp4 == 0 || nvfp4 == 1) &&
                    x != nullptr && wq != nullptr && scales != nullptr && out != nullptr &&
                    bases % 16 == 0 && (x_code == gl::kBF16) == (sx == nullptr);
    const bool decode = M <= 64 && !nvfp4;
    const int bk = decode ? BK : PBK;
    const bool split_ok = splits >= 1 && k_per_split > 0 && k_per_split % bk == 0 &&
                          (long long)(splits - 1) * k_per_split < K &&
                          (long long)splits * k_per_split >= K &&
                          (splits == 1 || (part != nullptr && counters != nullptr));
    if (!ok || !split_ok || stages < 2 || stages > kMaxStages ||
        (!decode && bm != 128 && bm != 256))
        return static_cast<int>(cudaErrorInvalidValue);
    const uint32_t* w = static_cast<const uint32_t*>(wq);
    const uint8_t* s = static_cast<const uint8_t*>(scales);
    const bool codes = x_code == 3;
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    cudaError_t err;
    if (decode) {
        const DParams p{x, w, s, static_cast<const float*>(sx), nullptr, 1,
                        static_cast<bf16*>(out), static_cast<float*>(part),
                        static_cast<int*>(counters), M, N, K, k_per_split, stages, mx::kFp4};
        err = codes ? r_launch_rows<kXe4m3>(p, splits, stream)
                    : r_launch_rows<kXbf16>(p, splits, stream);
    } else {
        const PParams p{nullptr, static_cast<const float*>(sx), static_cast<bf16*>(out),
                        static_cast<float*>(part), static_cast<int*>(counters), M, N, K,
                        k_per_split, stages, mx::kFp4, gs, 32, w, s};
        err = codes ? p_run<1, true>(x, p, bm, splits, stream)
                    : p_run<0, true>(x, p, bm, splits, stream);
    }
    return static_cast<int>(err);
}
