#!/usr/bin/env python3
# SPDX-License-Identifier: Apache-2.0
"""Time design variants of the port's fp8 kernels on one NVIDIA card.

    python3 scripts/torch_fp8_variants.py [--variants committed columns_first ...]

Each variant is the committed ``gemlite_tpu_torch/csrc/fp8_gemm.cu`` with a few
lines replaced (the text substitutions in ``VARIANTS``), built with the
package's nvcc flags into ``gemlite_tpu_torch/_build/variants/`` and run with
the committed plans (``ops/fp8.decode_plan`` / ``prefill_plan``):

  committed      the source as it is;
  columns_first  the prefill grid with the column tiles fastest, as first
                 written (each row tile then reads the words from memory);
  no_promotion   the fp8 products summed straight into the float32
                 accumulators, without the fresh fragment a 128-deep stage
                 that the committed kernels add into them: the error this
                 costs, at K 4096 and 14336.

Every case reports max|a-b| / max|b| against the plain float32 result
(``ops/reference.forward_fp8_ref``); ``columns_first`` must equal the
committed kernel bit for bit (only the order of the blocks changes). Times
are medians of 20 launches with the L2 cache flushed before each
(``chip_smoke.Timer``). One JSON line per variant and case, then the card's
name and power limit. A substitution that no longer matches the source fails
the script before anything runs.
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
from gemlite_tpu_torch.ops import fp8 as mod  # noqa: E402

SOURCE = build.SRC_DIR / "fp8_gemm.cu"
OUT_DIR = build.BUILD_DIR / "variants"
SHAPES = ((14336, 4096), (4096, 14336), (4096, 4096), (1024, 4096))     # (N, K)
PREFILL_CASES = [(kind, M, N, K) for kind in ("a8w8_fp8", "a16w8_fp8") for N, K in SHAPES
                 for M in (128, 1024, 2048)]
DECODE_CASES = [("a8w8_fp8", M, N, K) for N, K in SHAPES[:2] for M in (8, 64)]

VARIANTS = {
    "committed": ([], True),
    "columns_first": ([
        ("    const int tid = threadIdx.x, n0 = blockIdx.y * BN;",
         "    const int tid = threadIdx.x, n0 = blockIdx.x * BN;"),
        ("    const int n0 = blockIdx.y * BN, m0 = blockIdx.x * NB * 128;",
         "    const int n0 = blockIdx.x * BN, m0 = blockIdx.y * NB * 128;"),
        ("    const dim3 grid((p.M + NB * 128 - 1) / (NB * 128), p.N / BN, splits);",
         "    const dim3 grid(p.N / BN, (p.M + NB * 128 - 1) / (NB * 128), splits);"),
    ], True),
    "no_promotion": ([
        ("            wgmma_fp8_n128<W, X>(tmp, a[CUR][kk], dx + ((kk * 32) >> 4), kk);",
         "            wgmma_fp8_n128<W, X>(acc[0], a[CUR][kk], dx + ((kk * 32) >> 4), 1);"),
        ("        for (int i = 0; i < 64; ++i) acc[0][i] += tmp[i];", ""),
        ("                for (int kb = 0; kb < BK / 32; ++kb) mma_fp8<W, X>(s, a[kb][i], b[kb][0], "
         "b[kb][1]);",
         "                for (int kb = 0; kb < BK / 32; ++kb) mma_fp8<W, X>(acc[i][jj], a[kb][i], "
         "b[kb][0], b[kb][1]);"),
        ("                for (int r = 0; r < 4; ++r) acc[i][jj][r] += s[r];", ""),
    ], False),
}


def variant_source(name: str) -> str:
    src = SOURCE.read_text()
    for old, new in VARIANTS[name][0]:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old.strip()!r} matches {src.count(old)} times")
        src = src.replace(old, new)
    return src


def build_variants(names) -> dict:
    """{name: ctypes library}, every variant compiled at once."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = OUT_DIR / f"fp8_gemm_{name}.cu"
        cu.write_text(variant_source(name))
        so = OUT_DIR / f"fp8_gemm_{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.SRC_DIR), "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(so))
        for fn, ptrs, ints in (("gl_fp8_prefill", 7, 12), ("gl_fp8_decode", 7, 11)):
            f = getattr(lib, fn)
            f.argtypes = [ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints + [ctypes.c_void_p]
            f.restype = ctypes.c_int
        libs[name] = lib
    return libs


def call(lib, kind: str, layer, x, sx):
    """One launch of a variant's decode (M <= 64) or prefill entry with the
    committed plan, as ops/fp8 launches the committed one."""
    meta = layer.meta
    M, N, K = x.shape[0], meta.out_features, meta.in_features
    xb = 2 if kind == "a16w8_fp8" else 1
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
    s_code = 0 if layer.scales.dtype == torch.float32 else 2
    sxp = None if sx is None else sx.data_ptr()
    head = (x.data_ptr(), layer.W_q.data_ptr(), layer.scales.data_ptr(), sxp)
    tail = (meta.input_dtype, meta.w_code_dtype, meta.W_group_mode, meta.channel_scale_mode, s_code)
    if M <= 64:
        p = mod.decode_plan(M, N, K, xb)
        ints, fl = p.tiles, p.splits * M * N if p.splits > 1 else 0
        part, cnt = mod._split("variants_decode", fl, ints, x.device, stream)
        err = lib.gl_fp8_decode(*head, part, cnt, out.data_ptr(), M, N, K, *tail, p.splits,
                                p.k_per_split, p.stages, stream)
    else:
        p = mod.prefill_plan(M, N, K, xb)
        ints, fl = p.tiles_n * p.tiles_m, p.splits * M * N if p.splits > 1 else 0
        part, cnt = mod._split("variants_prefill", fl, ints, x.device, stream)
        err = lib.gl_fp8_prefill(*head, part, cnt, out.data_ptr(), M, N, K, *tail, p.bm, p.splits,
                                 p.k_per_split, p.stages, stream)
    build.check(err, "fp8_gemm variant")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_fp8_variants: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from gemlite_tpu_torch.ops.reference import forward_fp8_ref

    for name in args.variants:                      # fail on a stale substitution first
        variant_source(name)
    libs = build_variants(args.variants)
    timer = smoke.Timer()
    gen = torch.Generator(device="cuda").manual_seed(12)
    layers = {}
    for kind, M, N, K in DECODE_CASES + PREFILL_CASES:
        if (kind, N, K) not in layers:
            layers.clear()
            torch.cuda.empty_cache()
            layers[(kind, N, K)] = smoke.fp8_layer(kind, N, K, gen)
        layer = layers[(kind, N, K)]
        x, sx = smoke.fp8_inputs(layer, M, gen)
        want = forward_fp8_ref(x, layer.W_q, layer.scales, sx, smoke.with_f32_out(layer.meta))
        committed = call(libs["committed"], kind, layer, x, sx) if "committed" in libs else None
        for name, lib in libs.items():
            got = call(lib, kind, layer, x, sx)
            torch.cuda.synchronize()
            row = {"variant": name, "kernel": "decode" if M <= 64 else "prefill", "form": kind,
                   "M": M, "N": N, "K": K, "rel_err": smoke.rel_err(got, want),
                   "ms": timer.ms(lambda: call(lib, kind, layer, x, sx))}
            if VARIANTS[name][1] and committed is not None:
                row["equals_committed"] = bool(torch.equal(got, committed))
            print(json.dumps(row), flush=True)
    print(smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
