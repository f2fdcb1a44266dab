// SPDX-License-Identifier: Apache-2.0
// Dequantize packed words to a dense (K, N) bf16 in one streaming pass:
// W1 / W2 / W4 / W8 integer codes in W_group_mode 1-4 with csm 0-3
// (gl_dequantize_int: float32 arithmetic in the plain version's order, one
// rounding to bf16), fp8 bit codes
// (gl_dequantize_fp8: each value converted exactly, times its column's scale
// in float32 where the layer has one (mode 2 or csm 1 / 3, the fold of
// gemlite_tpu/ops/dispatch.py:_dense_fallback_matmul), one rounding to bf16),
// or MX codes (gl_dequantize_mx: fp4 or fp8 codes times their group's e8m0
// or NVFP4 scale in float32, one rounding to bf16; csrc/mx_common.cuh).
//
// Replaces the TPU kernel gemlite_tpu/ops/pallas_prefill.py:pallas_dequantize;
// the dense product after it stays torch.matmul, as the JAX package leaves it
// to XLA. Written in CUDA C++ rather than Triton so that all the kernels of
// the path share one build.
//
// What bounds it: bytes (the words and metadata read, 2*K*N written), so the
// bound is HBM bandwidth. The integer and fp8 forms' thread reads four
// columns' words (16 bytes) and writes each row they hold 8 bytes at a time
// (for W8 codes 1.32x faster than one word a thread down a column on the
// H100); the MX form's thread one word of a column. Every access of a warp
// is coalesced.
#include <cuda_fp8.h>

#include "gl_common.cuh"
#include "mx_common.cuh"

namespace {

// The metadata of the integer form: group scales and zeros (rows of N, one
// per `*_kpg` rows of k), a scalar zero, the channel scales (csm 1 / 3), each
// with its dtype code (gl::DTypeCode), null where the layer has none.
struct IntMeta {
    const void* s;
    const void* z;
    const void* zs;                       // the scalar zero: int32 (kI32) or float
    const void* cs;                       // (N) channel scales
    int s_code, z_code, zs_code, cs_code;
    int s_kpg, z_kpg;                     // k rows per scale / zero row
};

// Integer form: one thread reads the words of four columns n .. n + 3 of
// word row kw (16 bytes, 32 / BITS codes of one group each) and writes the
// rows they hold, 8 bytes a row, as the fp8 form does, so a warp's loads and
// stores are contiguous. dequantize_full's order, each op rounded in float32
// (no contraction): mode 1 q - z, mode 2 q * s, mode 3 (q - z) * s, mode 4
// q * s + z, then times the channel scale; one rounding to bf16 at the end.
// A scalar zero enters mode 3 as an int32 (torch's .to(int32) truncates),
// modes 1 and 4 as float32.
template <int BITS, int MODE>
__global__ void dequantize_int_kernel(const uint4* __restrict__ wq,   // (K / epw, N / 4) x 4 words
                                      const IntMeta m, __nv_bfloat16* __restrict__ out, int N) {
    constexpr int EPW = 32 / BITS;
    constexpr uint32_t MASK = (1u << BITS) - 1u;
    const int q4 = blockIdx.x * blockDim.x + threadIdx.x;   // a quad of columns
    const int kw = blockIdx.y, n = 4 * q4;
    if (n >= N) return;
    const uint4 w4 = __ldg(wq + (size_t)kw * (N / 4) + q4);
    const uint32_t words[4] = {w4.x, w4.y, w4.z, w4.w};
    const int k0 = kw * EPW;
    float s[4], z[4], c[4];
    float zs = 0.f;
    if (MODE != 2 && m.z == nullptr && m.zs != nullptr) {
        zs = m.zs_code == gl::kI32 ? static_cast<float>(*static_cast<const int*>(m.zs))
                                   : gl::load_meta(m.zs, 0, m.zs_code);
        if (MODE == 3) zs = static_cast<float>(static_cast<int>(zs));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        s[i] = MODE != 1 ? gl::load_meta(m.s, (size_t)(k0 / m.s_kpg) * N + n + i, m.s_code) : 1.f;
        z[i] = MODE == 2 ? 0.f
               : m.z != nullptr ? gl::load_meta(m.z, (size_t)(k0 / m.z_kpg) * N + n + i, m.z_code)
                                : zs;
        c[i] = m.cs != nullptr ? gl::load_meta(m.cs, n + i, m.cs_code) : 1.f;
    }
#pragma unroll
    for (int j = 0; j < EPW; ++j) {
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float q = static_cast<float>((words[i] >> (BITS * j)) & MASK);
            if (MODE == 1) v[i] = __fsub_rn(q, z[i]);
            else if (MODE == 2) v[i] = __fmul_rn(q, s[i]);
            else if (MODE == 3) v[i] = __fmul_rn(__fsub_rn(q, z[i]), s[i]);
            else v[i] = __fadd_rn(__fmul_rn(q, s[i]), z[i]);
            if (m.cs != nullptr) v[i] = __fmul_rn(v[i], c[i]);
        }
        const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
        uint2 pk;
        pk.x = *reinterpret_cast<const uint32_t*>(&lo);
        pk.y = *reinterpret_cast<const uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(out + (size_t)(k0 + j) * N + n) = pk;
    }
}

template <int BITS>
cudaError_t launch_int(const uint4* wq, const IntMeta& m, __nv_bfloat16* out, int N, int K,
                       int mode, cudaStream_t stream) {
    const dim3 grid((N / 4 + 127) / 128, K / (32 / BITS));
    if (mode == 1) dequantize_int_kernel<BITS, 1><<<grid, 128, 0, stream>>>(wq, m, out, N);
    else if (mode == 2) dequantize_int_kernel<BITS, 2><<<grid, 128, 0, stream>>>(wq, m, out, N);
    else if (mode == 3) dequantize_int_kernel<BITS, 3><<<grid, 128, 0, stream>>>(wq, m, out, N);
    else dequantize_int_kernel<BITS, 4><<<grid, 128, 0, stream>>>(wq, m, out, N);
    return cudaGetLastError();
}

// fp8 form: one thread reads four words (columns n .. n + 3 of word row kw,
// 16 bytes) and writes the four k rows they hold, 8 bytes a row, so a warp's
// loads and stores are contiguous.
template <int W>
__global__ void dequantize_fp8_kernel(const uint4* __restrict__ wq,   // (K / 4, N / 4) x 4 words
                                      const void* __restrict__ scales, int s_f32,
                                      __nv_bfloat16* __restrict__ out, int N) {
    const int q = blockIdx.x * blockDim.x + threadIdx.x;   // a quad of columns
    const int kw = blockIdx.y;
    if (4 * q >= N) return;
    const uint4 w = __ldg(wq + (size_t)kw * (N / 4) + q);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
    float s[4] = {1.f, 1.f, 1.f, 1.f};
    if (scales != nullptr) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
            s[c] = s_f32 ? static_cast<const float*>(scales)[4 * q + c]
                         : __bfloat162float(static_cast<const __nv_bfloat16*>(scales)[4 * q + c]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        float v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const __half_raw h =
                __nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>((words[c] >> (8 * j)) & 0xFFu),
                                        W ? __NV_E5M2 : __NV_E4M3);
            v[c] = __half2float(__half(h));
            if (scales != nullptr) v[c] = __fmul_rn(v[c], s[c]);
        }
        const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
        uint2 pk;
        pk.x = *reinterpret_cast<const uint32_t*>(&lo);
        pk.y = *reinterpret_cast<const uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(out + (size_t)(4 * kw + j) * N + 4 * q) = pk;
    }
}

// MX form: one thread reads one word of column n (8 fp4 or 4 fp8 codes, all
// in one group) and writes its values down the column.
__global__ void dequantize_mx_kernel(const uint32_t* __restrict__ wq,    // (K / per_word, N)
                                     const uint8_t* __restrict__ scales,  // (K / gs, N)
                                     __nv_bfloat16* __restrict__ out,     // (K, N)
                                     int N, int wkind, int gs) {
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    const int kw = blockIdx.y, epw = mx::per_word(wkind);
    if (n >= N) return;
    const uint32_t word = __ldg(wq + (size_t)kw * N + n);
    const float s = mx::scale_f32(__ldg(scales + (size_t)(kw * epw / gs) * N + n), gs == 16);
    for (int j = 0; j < epw; ++j)
        out[(size_t)(kw * epw + j) * N + n] =
            __float2bfloat16_rn(__fmul_rn(mx::code_f32(word, j, wkind), s));
}

}  // namespace

// Launch on `stream`: MX codes of w_kind (0 fp4, 1 e4m3, 2 e5m2) in (K /
// per_word, N) words; scales (K / gs, N) e8m0 bits (gs 32) or NVFP4 e4m3 (gs
// 16, fp4 only). Returns the cudaError_t of the launch.
extern "C" int gl_dequantize_mx(const void* wq, const void* scales, void* out, int N, int K,
                                int w_kind, int gs, void* stream_ptr) {
    if (N < 1 || K < 32 || K % 32 || w_kind < mx::kFp4 || w_kind > mx::kE5m2 ||
        (gs != 32 && !(gs == 16 && w_kind == mx::kFp4)) || wq == nullptr || scales == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((N + 255) / 256, K / mx::per_word(w_kind));
    dequantize_mx_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
        static_cast<const uint32_t*>(wq), static_cast<const uint8_t*>(scales),
        static_cast<__nv_bfloat16*>(out), N, w_kind, gs);
    return static_cast<int>(cudaGetLastError());
}

// Launch on `stream`: fp8 codes (w_code: DType 3 e4m3, 8 e5m2) in (K / 4, N)
// words, N a multiple of 4, 16-byte aligned; `scales` (N) float32 (s_code 0)
// or bf16 (2), or null for none. Returns the cudaError_t of the launch.
extern "C" int gl_dequantize_fp8(const void* wq, const void* scales, void* out, int N, int K,
                                 int w_code, int s_code, void* stream_ptr) {
    if (N < 4 || N % 4 || K < 4 || K % 4 || (w_code != 3 && w_code != 8) ||
        (scales != nullptr && s_code != 0 && s_code != 2) || reinterpret_cast<uintptr_t>(wq) % 16 ||
        reinterpret_cast<uintptr_t>(out) % 8)
        return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((N / 4 + 127) / 128, K / 4);
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const uint4* w = static_cast<const uint4*>(wq);
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
    if (w_code == 8)
        dequantize_fp8_kernel<1><<<grid, 128, 0, stream>>>(w, scales, s_code == 0, o, N);
    else
        dequantize_fp8_kernel<0><<<grid, 128, 0, stream>>>(w, scales, s_code == 0, o, N);
    return static_cast<int>(cudaGetLastError());
}

// Launch on `stream`: integer codes of `bits` (1, 2, 4, 8) in (K / epw, N)
// words, N a multiple of 4, 16-byte aligned (the output 8-byte aligned),
// W_group_mode `mode` 1-4. `scales` / `zeros`: (K / s_kpg, N) and
// (K / z_kpg, N) rows, dtype codes s_code / z_code (float32, fp16, bf16), null
// where the mode reads none (mode 1: no scales; mode 2: no zeros); `zscalar`
// one zero on the device (int32, or a float code) in place of a zero row;
// `cs` (N) channel scales (csm 1 / 3) or null. Every k row group must hold
// whole words (s_kpg and z_kpg multiples of 32 / bits). Returns the
// cudaError_t of the launch.
extern "C" int gl_dequantize_int(const void* wq, const void* scales, const void* zeros,
                                 const void* zscalar, const void* cs, void* out, int N, int K,
                                 int bits, int mode, int s_code, int z_code, int zs_code,
                                 int cs_code, int s_kpg, int z_kpg, void* stream_ptr) {
    const bool bits_ok = bits == 1 || bits == 2 || bits == 4 || bits == 8;
    const int epw = bits_ok ? 32 / bits : 1;
    const bool needs_s = mode != 1, needs_z = mode != 2;
    const auto kpg_ok = [&](int kpg) { return kpg >= epw && kpg % epw == 0 && K % kpg == 0; };
    if (!bits_ok || mode < 1 || mode > 4 || N < 4 || N % 4 || K < epw || K % epw ||
        wq == nullptr || reinterpret_cast<uintptr_t>(wq) % 16 || reinterpret_cast<uintptr_t>(out) % 8 ||
        (needs_s && (scales == nullptr || !kpg_ok(s_kpg))) ||
        (needs_z && (zeros == nullptr) == (zscalar == nullptr)) ||
        (zeros != nullptr && !kpg_ok(z_kpg)))
        return static_cast<int>(cudaErrorInvalidValue);
    const IntMeta m{needs_s ? scales : nullptr, needs_z ? zeros : nullptr,
                    needs_z ? zscalar : nullptr, cs, s_code, z_code, zs_code, cs_code,
                    s_kpg > 0 ? s_kpg : 1, z_kpg > 0 ? z_kpg : 1};
    const uint4* w = static_cast<const uint4*>(wq);
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
    const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    cudaError_t err;
    if (bits == 1) err = launch_int<1>(w, m, o, N, K, mode, stream);
    else if (bits == 2) err = launch_int<2>(w, m, o, N, K, mode, stream);
    else if (bits == 4) err = launch_int<4>(w, m, o, N, K, mode, stream);
    else err = launch_int<8>(w, m, o, N, K, mode, stream);
    return static_cast<int>(err);
}
