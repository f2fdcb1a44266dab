#!/usr/bin/env python3
# SPDX-License-Identifier: Apache-2.0
"""Time variants of the dequantize kernel's integer form on one NVIDIA card.

    python3 scripts/torch_dequantize_variants.py [--old-source DIR]

``committed`` is ``gemlite_tpu_torch/csrc/dequantize.cu`` as it stands (a
thread reads four columns' words, 16 bytes, and writes each row they hold 8
bytes at a time); ``one_word`` is the same source with the integer form's
kernel and launch replaced by one thread a word of one column, its values
written down the column (the W4 form's pattern, ``ONE_WORD``). Both run on
chip_smoke.py's DEQUANT_INT_FORMS at its MODES_SHAPES and on a W4 gs 128
mode-4 layer, each checked bit for bit against ``dequantize_full``. With
``--old-source DIR`` (an earlier tree's ``gemlite_tpu_torch/csrc``, e.g. the
parent commit's unpacked under ``_archive/``) the W4 mode-4 rows also time
that tree's ``gl_dequantize_w4`` on the same layer (``w4_ms``). Times are
chip_smoke.Timer's (median of 20, L2 flushed), each variant timed twice in
turns. One JSON line a case, then the card's name and power limit.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from gemlite_tpu_torch.ops import build  # noqa: E402
from gemlite_tpu_torch.ops import dequantize as mod  # noqa: E402

OUT_DIR = build.BUILD_DIR / "variants"
_KERNEL_START = "// Integer form: one thread reads the words of four columns n .. n + 3 of"
_KERNEL_END = "// fp8 form: one thread reads four words"
ONE_WORD = r'''// Integer form, one word a thread of column n, its values down the column.
template <int BITS, int MODE>
__global__ void dequantize_int_kernel(const uint32_t* __restrict__ wq,   // (K / epw, N)
                                      const IntMeta m, __nv_bfloat16* __restrict__ out, int N) {
    constexpr int EPW = 32 / BITS;
    constexpr uint32_t MASK = (1u << BITS) - 1u;
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    const int kw = blockIdx.y;
    if (n >= N) return;
    const uint32_t word = __ldg(wq + (size_t)kw * N + n);
    const int k0 = kw * EPW;
    float s = 1.f, z = 0.f, c = 1.f;
    if (MODE != 1) s = gl::load_meta(m.s, (size_t)(k0 / m.s_kpg) * N + n, m.s_code);
    if (MODE != 2) {
        if (m.z != nullptr) {
            z = gl::load_meta(m.z, (size_t)(k0 / m.z_kpg) * N + n, m.z_code);
        } else if (m.zs != nullptr) {
            if (m.zs_code == gl::kI32) z = static_cast<float>(*static_cast<const int*>(m.zs));
            else z = gl::load_meta(m.zs, 0, m.zs_code);
            if (MODE == 3) z = static_cast<float>(static_cast<int>(z));
        }
    }
    if (m.cs != nullptr) c = gl::load_meta(m.cs, n, m.cs_code);
#pragma unroll
    for (int j = 0; j < EPW; ++j) {
        const float q = static_cast<float>((word >> (BITS * j)) & MASK);
        float v;
        if (MODE == 1) v = __fsub_rn(q, z);
        else if (MODE == 2) v = __fmul_rn(q, s);
        else if (MODE == 3) v = __fmul_rn(__fsub_rn(q, z), s);
        else v = __fadd_rn(__fmul_rn(q, s), z);
        if (m.cs != nullptr) v = __fmul_rn(v, c);
        out[(size_t)(k0 + j) * N + n] = __float2bfloat16_rn(v);
    }
}

template <int BITS>
cudaError_t launch_int(const uint32_t* wq, const IntMeta& m, __nv_bfloat16* out, int N, int K,
                       int mode, cudaStream_t stream) {
    const dim3 grid((N + 255) / 256, K / (32 / BITS));
    if (mode == 1) dequantize_int_kernel<BITS, 1><<<grid, 256, 0, stream>>>(wq, m, out, N);
    else if (mode == 2) dequantize_int_kernel<BITS, 2><<<grid, 256, 0, stream>>>(wq, m, out, N);
    else if (mode == 3) dequantize_int_kernel<BITS, 3><<<grid, 256, 0, stream>>>(wq, m, out, N);
    else dequantize_int_kernel<BITS, 4><<<grid, 256, 0, stream>>>(wq, m, out, N);
    return cudaGetLastError();
}

'''


def one_word_source(src: str) -> str:
    i, j = src.find(_KERNEL_START), src.find(_KERNEL_END)
    entry = src.find('extern "C" int gl_dequantize_int(')
    cast = "    const uint4* w = static_cast<const uint4*>(wq);"
    at = src.find(cast, entry)
    if min(i, j, entry, at) < 0:
        raise SystemExit("the integer form's kernel no longer matches this script's edit")
    src = (src[:at] + "    const uint32_t* w = static_cast<const uint32_t*>(wq);" +
           src[at + len(cast):])
    return src[:i] + ONE_WORD + src[j:]


def compile_lib(name: str, src: str, include: Path) -> ctypes.CDLL:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    cu, so = OUT_DIR / f"dequantize_{name}.cu", OUT_DIR / f"dequantize_{name}.so"
    cu.write_text(src)
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(include), "-o", str(so),
                          str(cu)], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{res.stdout}{res.stderr}")
    return ctypes.CDLL(str(so))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old-source", type=Path, default=None,
                    help="an earlier tree's csrc: time its gl_dequantize_w4 on the W4 mode-4 rows")
    args = ap.parse_args()
    src = (build.SRC_DIR / "dequantize.cu").read_text()
    variants = {"committed": src, "one_word": one_word_source(src)}
    if not torch.cuda.is_available():
        print("torch_dequantize_variants: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    import chip_smoke
    libs = {name: compile_lib(name, s, build.SRC_DIR) for name, s in variants.items()}
    old_w4 = None
    if args.old_source is not None:
        old_w4 = compile_lib("old", (args.old_source / "dequantize.cu").read_text(),
                             args.old_source).gl_dequantize_w4
        old_w4.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        old_w4.restype = ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = chip_smoke.Timer()
    cases = [(f, N, K) for f in chip_smoke.DEQUANT_INT_FORMS for N, K in chip_smoke.MODES_SHAPES]
    cases += [("w4_gs128_mode4", N, K) for N, K in chip_smoke.MODES_SHAPES]
    saved = mod._lib
    try:
        for form, N, K in cases:
            layer = (chip_smoke.random_layer(N, K, gen) if form == "w4_gs128_mode4" else
                     chip_smoke.dequant_int_layer(form, N, K, gen))
            call = (layer.W_q, layer.scales, layer.zeros, layer.meta)
            want = mod.dequantize_full(*call)
            row = {"form": form, "N": N, "K": K}
            for turn in range(2):
                for name, lib in libs.items():
                    fn = lib.gl_dequantize_int
                    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
                    fn.restype = ctypes.c_int
                    mod._lib = lambda n, p, i, f=fn: f
                    if turn == 0:
                        row[f"{name}_equal"] = bool(torch.equal(mod.dequantize_int(*call), want))
                    row.setdefault(f"{name}_ms", []).append(
                        timer.ms(lambda: mod.dequantize_int(*call)))
                if old_w4 is not None and form == "w4_gs128_mode4":
                    out = torch.empty((K, N), dtype=torch.bfloat16, device="cuda")

                    def w4_call():
                        build.check(old_w4(layer.W_q.data_ptr(), layer.scales.data_ptr(),
                                           layer.zeros.data_ptr(), out.data_ptr(), N, K,
                                           layer.meta.group_size,
                                           torch.cuda.current_stream().cuda_stream),
                                    "gl_dequantize_w4")
                        return out
                    if turn == 0:
                        row["w4_equal"] = bool(torch.equal(w4_call(), want))
                    row.setdefault("w4_ms", []).append(timer.ms(w4_call))
            mod._lib = saved
            print(json.dumps(row), flush=True)
    finally:
        mod._lib = saved
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
