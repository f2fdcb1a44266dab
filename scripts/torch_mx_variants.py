#!/usr/bin/env python3
# SPDX-License-Identifier: Apache-2.0
"""Time design variants of the port's MX kernels on one NVIDIA card.

    python3 scripts/torch_mx_variants.py [--variants committed weight_scale ...]
                                         [--old-source DIR]

Each variant is the committed ``gemlite_tpu_torch/csrc/mx_gemm.cu`` with a few
lines replaced (the text substitutions in ``VARIANTS``), built with the
package's nvcc flags into ``gemlite_tpu_torch/_build/variants/`` and run with
the committed plans (``ops/mx.decode_plan`` / ``prefill_plan``) on A16W4_MXFP
layers (fp4 codes, e8m0 scales of 32, bf16 x):

  committed     the source as it is;
  weight_scale  the decode kernel scales each weight before the products
                (float32 multiply, one rounding to bf16) instead of each
                group's float32 sum after them: the cost of the per-weight
                multiply (the result agrees within rounding, not bit for bit);
  no_scale      the group scale taken as 1.0, neither read nor decoded (the
                result is wrong): the cost of the scales;
  no_decode     the raw words handed to the tensor cores as bf16 pairs, with
                no decode and no prefill scale (the result is wrong): the
                cost of the decode, against the copies and the products.

With ``--old-source DIR`` (an earlier tree's ``gemlite_tpu_torch/csrc``,
e.g. unpacked by ``git archive`` into ``_archive/``) it also builds that
tree's ``mx_gemm.cu`` beside the committed one (``chip_smoke.start_old_mx_build``)
and times the general entry (``gl_mx_general``, fp4 layers off the JAX fold
rule) of both trees on the same A16W4_MXFP layers and inputs: SmolLM2-360M's
block linears and gpt-oss-20b's 2880x2880 at M 1 / 8 / 64 / 128 / 1024, the
committed entry's ``general_plan`` and a dense bf16 matmul on the
dequantized weight beside them (variant "general").

Before the decoders were instantiated per weight kind (their first version
branched on the kind in the inner loops), a variant that fixed the kind at
compile time took the decode at M 8 on 14336x4096 from 0.0999 to 0.0575 ms
(PERF.md).

Every case reports max|a-b| / max|b| against the plain float32 result
(``ops/reference.mx_forward_ref``). Times are medians of 20 launches with the L2 cache
flushed before each (``chip_smoke.Timer``). One JSON line per variant and
case, then the card's name and power limit. A substitution that no longer
matches the source fails the script before anything runs.
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
from gemlite_tpu_torch.ops import mx as mod  # noqa: E402

SOURCE = build.SRC_DIR / "mx_gemm.cu"
OUT_DIR = build.BUILD_DIR / "variants"
SHAPES = ((14336, 4096), (4096, 4096))     # (N, K)
CASES = [(M, N, K) for N, K in SHAPES for M in (1, 8, 64, 128, 1024)]
GENERAL_SHAPES = ((2560, 960), (2880, 2880), (960, 960), (320, 960), (960, 2560))
GENERAL_CASES = [(M, N, K) for N, K in GENERAL_SHAPES for M in (1, 8, 64, 128, 1024)]

_DECODE_A = ("                    a[j][i][h] = mx::raw_pair(w, 0, W);\n"
             "                    a[j][i][2 + h] = mx::raw_pair(w, 2, W);")
_DECODE_ACC = ("                    acc[i][jj][r] = __fmaf_rn(part[r], sc[i][r >> 1], "
               "acc[i][jj][r]);")
_PREFILL_A = "                a[kk][2 * half + h] = mx::decode_pair(w, 0, W, s);"
VARIANTS = {
    "committed": ([], True),
    "weight_scale": ([
        (_DECODE_A, "                    a[j][i][h] = mx::decode_pair(w, 0, W, sc[i][h]);\n"
                    "                    a[j][i][2 + h] = mx::decode_pair(w, 2, W, sc[i][h]);"),
        (_DECODE_ACC, "                    acc[i][jj][r] += part[r];"),
    ], False),
    "no_scale": ([
        ("                sc[i][h] = mx::scale_f32(ss[kb * BN + c], false);",
         "                sc[i][h] = 1.f;"),
        ("            const float s = mx::scale_f32(ss[(16 * kk / gs) * BN + 8 * h], nvfp4);",
         "            const float s = 1.f;"),
    ], False),
    "no_decode": ([
        (_DECODE_A, "                    a[j][i][h] = w;\n                    a[j][i][2 + h] = w >> 8;"),
        (_PREFILL_A, "                a[kk][2 * half + h] = w;"),
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
        cu = OUT_DIR / f"mx_gemm_{name}.cu"
        cu.write_text(variant_source(name))
        so = OUT_DIR / f"mx_gemm_{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.SRC_DIR), "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(so))
        for fn, ptrs, ints in (("gl_mx_decode", 7, 8), ("gl_mx_prefill", 8, 10)):
            f = getattr(lib, fn)
            f.argtypes = [ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints + [ctypes.c_void_p]
            f.restype = ctypes.c_int
        libs[name] = lib
    return libs


def call(lib, layer, x):
    """One launch of a variant's decode (M <= 64) or prefill entry with the
    committed plan, as ops/mx launches the committed one (bf16 x)."""
    meta = layer.meta
    M, N, K = x.shape[0], meta.out_features, meta.in_features
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
    s = layer.scales.view(torch.uint8)
    if M <= 64:
        p = mod.decode_plan(M, N, K, 0, 2)
        part, cnt = mod._split("variants_decode", p.splits * M * N if p.splits > 1 else 0,
                               p.tiles, x.device, stream)
        err = lib.gl_mx_decode(x.data_ptr(), layer.W_q.data_ptr(), s.data_ptr(), None, part, cnt,
                               out.data_ptr(), M, N, K, 2, 0, p.splits, p.k_per_split, p.stages,
                               stream)
    else:
        p = mod.prefill_plan(M, N, K, 0)
        part, cnt = mod._split("variants_prefill", p.splits * M * N if p.splits > 1 else 0,
                               p.tiles_n * p.tiles_m, x.device, stream)
        err = lib.gl_mx_prefill(x.data_ptr(), None, layer.W_q.data_ptr(), s.data_ptr(), None, part,
                                cnt, out.data_ptr(), M, N, K, 2, 0, 0, meta.group_size, p.splits,
                                p.k_per_split, p.stages, stream)
    build.check(err, "mx_gemm variant")
    return out


def general_rows(timer, old, gen) -> None:
    """The committed general entry against an earlier tree's (``old``), one
    JSON line a case."""
    import chip_smoke as smoke
    from gemlite_tpu_torch.ops.dequantize import dequantize_full
    from gemlite_tpu_torch.ops.reference import mx_forward_ref

    for N, K in GENERAL_SHAPES:
        layer = smoke.mx_layer("a16w4_mxfp", N, K, gen)
        meta = layer.meta
        dense = dequantize_full(layer.W_q, layer.scales, None, meta)
        for M in (m for m, n, k in GENERAL_CASES if (n, k) == (N, K)):
            x = (torch.randn((M, K), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
            want = mx_forward_ref(x, layer.W_q, layer.scales, None, None, smoke.with_f32_out(meta))
            got = mod.mx_general(x, layer.W_q, layer.scales, None, meta)
            was = old(x, layer.W_q, layer.scales, None, meta)
            torch.cuda.synchronize()
            row = {"variant": "general", "form": "a16w4_mxfp", "M": M, "N": N, "K": K,
                   "plan": mod.general_plan(M, N, K, False)._asdict(),
                   "rel_err": smoke.rel_err(got, want), "old_rel_err": smoke.rel_err(was, want),
                   "ms": timer.ms(lambda: mod.mx_general(x, layer.W_q, layer.scales, None, meta)),
                   "old_ms": timer.ms(lambda: old(x, layer.W_q, layer.scales, None, meta)),
                   "dense_ms": timer.ms(lambda: torch.matmul(x, dense))}
            print(json.dumps(row), flush=True)
        del layer, dense
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--old-source", type=Path, default=None,
                    help="an earlier tree's gemlite_tpu_torch/csrc, for the general entry")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_mx_variants: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from gemlite_tpu_torch.ops.reference import mx_forward_ref

    for name in args.variants:                      # fail on a stale substitution first
        variant_source(name)
    old = smoke.start_old_mx_build(args.old_source) if args.old_source else None
    libs = build_variants(args.variants)
    timer = smoke.Timer()
    gen = torch.Generator(device="cuda").manual_seed(13)
    if old is not None:
        general_rows(timer, old(), gen)
    layers = {}
    for M, N, K in CASES if libs else ():
        if (N, K) not in layers:
            layers.clear()
            torch.cuda.empty_cache()
            layers[(N, K)] = smoke.mx_layer("a16w4_mxfp", N, K, gen)
        layer = layers[(N, K)]
        x = (torch.randn((M, K), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
        want = mx_forward_ref(x, layer.W_q, layer.scales, None, None,
                              smoke.with_f32_out(layer.meta))
        committed = call(libs["committed"], layer, x) if "committed" in libs else None
        for name, lib in libs.items():
            got = call(lib, layer, x)
            torch.cuda.synchronize()
            row = {"variant": name, "kernel": "decode" if M <= 64 else "prefill",
                   "form": "a16w4_mxfp", "M": M, "N": N, "K": K,
                   "rel_err": smoke.rel_err(got, want),
                   "ms": timer.ms(lambda: call(lib, layer, x))}
            if VARIANTS[name][1] and committed is not None:
                row["equals_committed"] = bool(torch.equal(got, committed))
            print(json.dumps(row), flush=True)
    print(smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
