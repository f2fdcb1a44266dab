#!/usr/bin/env python3
# SPDX-License-Identifier: Apache-2.0
"""Time design variants of the port's MX kernels on one NVIDIA card.

    python3 scripts/torch_mx_variants.py [--variants committed weight_scale ...]
                                         [--old-source DIR] [--decode-only]

Each variant is the committed ``gemlite_tpu_torch/csrc/mx_gemm.cu``, or with
``--old-source DIR`` an earlier tree's (``DIR`` is that tree's
``gemlite_tpu_torch/csrc``, e.g. unpacked by ``git archive`` into
``_archive/``), with a few lines replaced (the text substitutions in
``VARIANTS``), built with the package's nvcc flags into
``gemlite_tpu_torch/_build/variants/`` and run with the committed plans
(``ops/mx.decode_plan`` / ``prefill_plan``; an earlier tree's prefill entry
with the plan it had, 128 rows a block) on A16W4_MXFP layers (fp4 codes,
e8m0 scales of 32, bf16 x):

  committed     the source as it is;
  weight_scale  the decode kernel scales each weight before the products
                (float32 multiply, one rounding to bf16) instead of each
                group's float32 sum after them: the cost of the per-weight
                multiply (the result agrees within rounding, not bit for bit);
  no_scale      the group scale taken as 1.0, neither read nor decoded (the
                result is wrong): the cost of the scales;
  no_decode     the raw words handed to the tensor cores as bf16 pairs, with
                no decode and no prefill scale (the result is wrong): the
                cost of the decode, against the copies and the products;
  copies_only   the decode's consumer warps wait for each stage and release
                it without reading it (the result is zeros): the TMA weight
                stream alone, whose rate ("copy_tb_s": the weight, scale and
                x bytes over the time) bounds the decode body;
  blocks2       the decode kernel's launch bounds and plan for two blocks an
                SM (``DECODE_BLOCKS`` 2, a ring budget of 108 KB) in place of
                three (bit for bit where the split is the same);
  blocks4       for four blocks an SM (a ring budget of 52 KB);
  split8        the decode plan with 8 K splits (whole stages) in place of
                its whole-wave rule (bit for bit where the split is the same);
  deep_ring     3 splits (the rule's at 14336 x 4096) with a ring as deep as
                the budget allows, past half the block's stages;
  empty         the decode kernel with no stage: its launch, barriers, tile
                and split merge alone (the result is zeros);
  compute_only  the decode's producer fills the ring once and stops; the
                consumers take every step's products on the stage that step
                would have used (the result is wrong): the decode and the
                products alone, against copies_only's stream;
  no_convert    the code form's converting warps wait for each stage and
                mark its tile ready without writing it (the result is
                wrong): the cost of the ring's synchronization alone;
  convert_copy  they copy the codes into the tile with no conversion and no
                scale (the result is wrong): the cost of the arithmetic,
                against the shared-memory traffic;
  three_converters  the code form with one producer warpgroup: three
                converting warps instead of seven (bit for bit the committed
                result);
  alu_convert   the converting warps place each code's bits in a float32 by
                integer shifts and masks (times 2^120: the code's value), in
                place of the e4m3 -> f16 -> f32 conversions, and multiply by
                the group scale in float32 (bit for bit the committed result
                on codes that are not NaN);
  alu_round     and round the products to bf16 by integer arithmetic in place
                of the bf16x2 conversion (the same, where the scale is no NaN);
  no_scale_mul  the converting warps skip the multiply by the group scale (the
                result is wrong): its cost;
  trunc_pack    they truncate the float32 products (NVFP4 x) to bf16 by a
                byte permute in place of the rounding bf16x2 conversion (the
                result is wrong): the conversion's cost;
  alu_unpack    they place each pair of codes in an f16x2 by a byte permute,
                a shift and masks, times 2^8 (exact), in place of the e4m3x2
                -> f16x2 conversion (bit for bit the committed result on codes
                that are not NaN): the conversion instruction's cost;
  parent        the earlier tree's source as it is, with the plans it took
                (needs --old-source: the parent commit's csrc, whose entries
                take the current C signatures; its decode plan is
                ``chip_smoke.parent_mx_decode_plan``).

The csm-4 cases (A4W4_NVFP_dynamic and A4W4_MXFP_dynamic on 14336x4096 at M
128 / 256 / 1024 / 2048: e4m3 codes and float32 group scales in,
``quant.scale_activations_mx``) run every variant's prefill entry in its code
form, in its bf16 form fed the fake-quantized x ("bf16_form_ms"), which an
exact variant's code form equals bit for bit, and in its code form without
the group scales ("unscaled_ms": the per-token form's copies and
arithmetic).

With ``--old-source DIR`` it also builds that tree's ``mx_gemm.cu`` beside
the committed one (``chip_smoke.start_old_mx_build``) and times the general
entry (``gl_mx_general``, fp4 layers off the JAX fold rule) of both trees on
the same A16W4_MXFP layers and inputs: SmolLM2-360M's block linears and
gpt-oss-20b's 2880x2880 at M 1 / 8 / 64 / 128 / 1024, the committed entry's
``general_plan`` and a dense bf16 matmul on the dequantized weight beside
them (variant "general").

Before the decoders were instantiated per weight kind (their first version
branched on the kind in the inner loops), a variant that fixed the kind at
compile time took the decode at M 8 on 14336x4096 from 0.0999 to 0.0575 ms
(PERF.md).

Every case reports max|a-b| / max|b| against the plain float32 result
(``ops/reference.mx_forward_ref``). Times are medians of 20 launches with the L2 cache
flushed before each (``chip_smoke.Timer``); the decode cases also under a
read flush ("read_flush_ms": no dirty line written back while the kernel
runs). ``--decode-only`` runs the decode cases (M <= 64) and, with
``--old-source``, the general entry's at M <= 64, and no csm-4 or prefill
case. One JSON line per variant and
case, then the card's name and power limit. A substitution that no longer
matches the source fails the script before anything runs.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple, Optional

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

_DECODE_A = ("                        a[j][i][h] = fp4_pair_e4(word, 2 * j);\n"
             "                        a[j][i][2 + h] = fp4_pair_e4(word, 2 * j + 1);")
_DECODE_ACC = "    for (int r = 0; r < 4; ++r) acc[r] = __fmaf_rn(part[r], sc[r >> 1], acc[r]);"
_DECODE_COMPUTE = (
    "        d_compute<NT, X, W>(g + Ly.w + st * Ly.wb, g + Ly.s + st * SROWS * BN, g + st * Ly.xb, o,\n"
    "                            nt, acc);\n")
_DECODE_BLOCKS = "constexpr int kDecodeBlocks = 3;"
_PRODUCER_WAIT = ("        if (it >= S) sm90::mbar_wait(sm90::bar_addr(bars, S + st), ((it / S) & 1) ^ 1);\n"
                  "        sm90::mbar_expect_tx(full, bytes);")
_CONSUMER_WAIT = "        sm90::mbar_wait(sm90::bar_addr(bars, st), phase);"
_PREFILL_A = "                    a[kk][2 * half + h] = mx::decode_e8m0_pair(w, 0, W, sbyte);"
_CONVERT_PIECE = """            uint32_t o[8];
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
"""
_F32_MUL = "                    o[q] = mx::bf16x2(__fmul_rn(f.x, sc), __fmul_rn(f.y, sc));"
_POW2_MUL = "                    o[q] = mx::mul_bf16x2(mx::bf16x2(f.x, f.y), s2);"
_ALU_CONVERT = """            uint32_t o[8];
#pragma unroll
            for (int q = 0; q < 8; ++q) {
                const uint32_t b = w[q >> 1] >> (16 * (q & 1));
                const float lo = __uint_as_float((b & 0x80u) << 24 | (b & 0x7Fu) << 20);
                const float hi = __uint_as_float((b & 0x8000u) << 16 | (b & 0x7F00u) << 12);
                o[q] = mx::bf16x2(__fmul_rn(__fmul_rn(lo, 0x1p120f), sc),
                                  __fmul_rn(__fmul_rn(hi, 0x1p120f), sc));
            }
"""
_ALU_ROUND = """            uint32_t o[8];
#pragma unroll
            for (int q = 0; q < 8; ++q) {
                const uint32_t b = w[q >> 1] >> (16 * (q & 1));
                const uint32_t lo = __float_as_uint(__fmul_rn(
                    __fmul_rn(__uint_as_float((b & 0x80u) << 24 | (b & 0x7Fu) << 20), 0x1p120f), sc));
                const uint32_t hi = __float_as_uint(__fmul_rn(
                    __fmul_rn(__uint_as_float((b & 0x8000u) << 16 | (b & 0x7F00u) << 12), 0x1p120f), sc));
                o[q] = __byte_perm(lo + 0x7FFFu + ((lo >> 16) & 1u), hi + 0x7FFFu + ((hi >> 16) & 1u),
                                   0x7632);
            }
"""
_THREE = [
    ("constexpr int kCodeProducerRegs = 40, kCodeConsumerRegs = 216;",
     "constexpr int kCodeProducerRegs = 56, kCodeConsumerRegs = 224;"),
    ("constexpr int kConverters = 224;", "constexpr int kConverters = 96;"),
    ("return kConsumers + (xc ? 256 : 128);", "return kConsumers + 128;"),
]
_CONVERT_LOOP = "            if (m0 + kStep * i >= kRows) break;"
# name -> (substitutions, bit for bit the base's result, base: "committed" or "old")
VARIANTS = {
    "committed": ([], True, "committed"),
    "weight_scale": ([
        (_DECODE_A, "                        const uint32_t s2 = mx::e8m0_bf16x2(sst[kb * BN + o.c + 8 * i + 4 * h]);\n"
                    "                        a[j][i][h] = mx::mul_bf16x2(fp4_pair_e4(word, 2 * j), s2);\n"
                    "                        a[j][i][2 + h] = mx::mul_bf16x2(fp4_pair_e4(word, 2 * j + 1), s2);"),
        (_DECODE_ACC, "    for (int r = 0; r < 4; ++r) acc[r] += part[r];"),
    ], False, "committed"),
    "no_scale": ([
        ("                sc[i][h] = mx::scale_f32(sst[kb * BN + o.c + 8 * i + 4 * h], false);",
         "                sc[i][h] = 1.f;"),
        (_PREFILL_A, "                    a[kk][2 * half + h] = mx::raw_pair(w, 0, W);"),
    ], False, "committed"),
    "no_decode": ([
        (_DECODE_A, "                        a[j][i][h] = word >> (8 * j);\n"
                    "                        a[j][i][2 + h] = word >> (8 * j + 4);"),
        (_PREFILL_A, "                    a[kk][2 * half + h] = w;"),
    ], False, "committed"),
    "copies_only": ([(_DECODE_COMPUTE, "")], False, "committed"),
    "blocks2": ([(_DECODE_BLOCKS, "constexpr int kDecodeBlocks = 2;")], True, "committed"),
    "blocks4": ([(_DECODE_BLOCKS, "constexpr int kDecodeBlocks = 4;")], True, "committed"),
    "split8": ([], True, "committed"),
    "deep_ring": ([], True, "committed"),
    "empty": ([("    const int steps = (min(p.K, k_begin + p.k_per_split) - k_begin) / BK;\n"
                "    if (threadIdx.x == 0) {\n        for (int s = 0; s < S; ++s) {\n"
                "            sm90::mbar_init(sm90::bar_addr(bars, s), 1);",
                "    const int steps = 0;\n"
                "    if (threadIdx.x == 0) {\n        for (int s = 0; s < S; ++s) {\n"
                "            sm90::mbar_init(sm90::bar_addr(bars, s), 1);")], False, "committed"),
    "compute_only": ([(_PRODUCER_WAIT, "        if (it >= S) break;\n        sm90::mbar_expect_tx(full, bytes);"),
                      (_CONSUMER_WAIT, "        if (it < S) sm90::mbar_wait(sm90::bar_addr(bars, st), phase);")],
                     False, "committed"),
    "no_convert": ([(_CONVERT_LOOP, "            break;")],
                   False, "committed"),
    "convert_copy": ([(_CONVERT_PIECE, """            const uint32_t o[8] = {w[0], w[1], w[2], w[3], w[0], w[1], w[2], w[3]};
            (void)sc;
            (void)s2;
""")], False, "committed"),
    "three_converters": (_THREE, True, "committed"),
    "alu_convert": ([(_CONVERT_PIECE, _ALU_CONVERT)], True, "committed"),
    "no_scale_mul": ([(_F32_MUL, "                    o[q] = mx::bf16x2(f.x, f.y);"),
                      (_POW2_MUL, "                    o[q] = mx::bf16x2(f.x, f.y);")],
                     False, "committed"),
    "alu_unpack": ([("                const float2 f = mx::fp8x2_f32x2(w[q >> 1] >> (16 * (q & 1)), false);",
                     """                const uint32_t t = __byte_perm(w[q >> 1] >> (16 * (q & 1)), 0u, 0x1404);
                const uint32_t h = (t & 0x80008000u) | ((t >> 1) & 0x3F803F80u);
                uint32_t hv;
                asm("mul.rn.f16x2 %0, %1, %2;" : "=r"(hv) : "r"(h), "r"(0x5C005C00u));
                const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&hv));""")],
                   True, "committed"),
    "trunc_pack": ([(_F32_MUL, "                    o[q] = __byte_perm(__float_as_uint(__fmul_rn(f.x, sc)),\n"
                                "                                       __float_as_uint(__fmul_rn(f.y, sc)), 0x7632);")],
                   False, "committed"),
    "alu_round": ([(_CONVERT_PIECE, _ALU_ROUND)], True, "committed"),
    "parent": ([], True, "old"),
}
def _decode_split(n: int, deep: bool = False):
    """ops/mx.decode_plan with ``n`` K splits of whole stages (fewer where K
    has fewer stages) in place of its whole-wave rule, its ring rule kept
    (``deep``: a ring of up to all the block's stages)."""
    base = mod.decode_plan

    def plan(M, N, K, kind, x_bytes):
        p = base(M, N, K, kind, x_bytes)
        steps = K // mod.BK
        per = -(-steps // min(n, steps))
        most = per // 2 if per >= 4 and not deep else per
        stages = max(2, min(mod.DECODE_MAX_STAGES,
                            mod.DECODE_BUDGET // mod._decode_stage(kind, x_bytes, M), most))
        return p._replace(splits=-(-steps // per), k_per_split=per * mod.BK, stages=stages,
                          smem=mod.decode_smem(kind, x_bytes, M, stages))
    return plan


# a variant's plan settings (ops/mx attributes) where its layout differs
PLAN_ATTRS = {"split8": {"decode_plan": _decode_split(8)},
              "deep_ring": {"decode_plan": _decode_split(3, deep=True)},"blocks2": {"DECODE_BLOCKS": 2, "DECODE_RESIDENT": 2 * 132,
                          "DECODE_BUDGET": 108 * 1024},
              "blocks4": {"DECODE_BLOCKS": 4, "DECODE_RESIDENT": 4 * 132,
                          "DECODE_BUDGET": 52 * 1024}}
CSM4_FORMS = ("a4w4_nvfp", "a4w4_mxfp")
CSM4_MS = (128, 256, 1024, 2048)


class Variant(NamedTuple):
    lib: ctypes.CDLL
    old: bool                # an earlier tree's entries, with the plans it took
    plan: dict = {}          # ops/mx attributes its plan takes


def variant_source(name: str, old_source: Optional[Path]) -> str:
    base = VARIANTS[name][2]
    if base == "old" and old_source is None:
        raise RuntimeError(f"variant {name} changes an earlier tree's source: give --old-source")
    src = (SOURCE if base == "committed" else old_source / "mx_gemm.cu").read_text()
    for old, new in VARIANTS[name][0]:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old.strip()!r} matches {src.count(old)} times")
        src = src.replace(old, new)
    return src


def build_variants(names, old_source: Optional[Path]) -> dict:
    """{name: Variant}, every variant compiled at once."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        old = VARIANTS[name][2] == "old"
        cu = OUT_DIR / f"mx_gemm_{name}.cu"
        cu.write_text(variant_source(name, old_source))
        so = OUT_DIR / f"mx_gemm_{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(old_source if old else build.SRC_DIR),
               "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so, old)
    libs = {}
    for name, (proc, so, old) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(so))
        for fn, ptrs, ints in (("gl_mx_decode", 7, 8), ("gl_mx_prefill", 8, 11)):
            f = getattr(lib, fn)
            f.argtypes = [ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints + [ctypes.c_void_p]
            f.restype = ctypes.c_int
        libs[name] = Variant(lib, old, PLAN_ATTRS.get(name, {}))
    return libs


class plan_attrs:
    """ops/mx's plan settings of a variant, set while open."""

    def __init__(self, v: Variant):
        self.v = v

    def __enter__(self):
        self.saved = {a: getattr(mod, a) for a in self.v.plan}
        for a, value in self.v.plan.items():
            setattr(mod, a, value)

    def __exit__(self, *exc):
        for a, value in self.saved.items():
            setattr(mod, a, value)


def call_prefill(v: Variant, layer, x, gscales=None, scaled=True):
    """One launch of a variant's prefill entry: bf16 x, or e4m3 codes with
    their group scales (csm 4; ``scaled`` False: without them), on the
    committed plan (the parent's prefill plan is the same)."""
    meta = layer.meta
    M, N, K = x.shape[0], meta.out_features, meta.in_features
    codes = gscales is not None
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
    with plan_attrs(v):
        p = mod.prefill_plan(M, N, K, 0, x_codes=codes)
    part, cnt = mod._split("variants_prefill", p.splits * M * N if p.splits > 1 else 0,
                           p.tiles_n * p.tiles_m, x.device, stream)
    err = v.lib.gl_mx_prefill(x.data_ptr(), gscales.data_ptr() if codes and scaled else None,
                              layer.W_q.data_ptr(), layer.scales.view(torch.uint8).data_ptr(), None,
                              part, cnt, out.data_ptr(), M, N, K, 3 if codes else 2,
                              K // gscales.shape[1] if codes and scaled else 0, 0,
                              meta.group_size, p.bm, p.splits, p.k_per_split, p.stages, stream)
    build.check(err, "mx_gemm variant (prefill)")
    return out


def csm4_rows(timer, libs, gen) -> None:
    """Every variant's code form and its bf16 form fed the fake-quantized x,
    one JSON line a variant and case."""
    import chip_smoke as smoke
    from gemlite_tpu_torch.ops.reference import fake_quant_activations
    from gemlite_tpu_torch.quant import scale_activations_mx

    N, K = SHAPES[0]
    for form in CSM4_FORMS:
        layer = smoke.mx_layer(form, N, K, gen)
        for M in CSM4_MS:
            x = (torch.randn((M, K), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
            codes, gs = scale_activations_mx(x, layer.meta.input_dtype)
            fq = fake_quant_activations(x, layer.meta.input_dtype)
            for name, v in libs.items():
                got, fed = call_prefill(v, layer, codes, gs), call_prefill(v, layer, fq)
                torch.cuda.synchronize()
                row = {"variant": name, "kernel": "prefill_csm4", "form": form, "M": M, "N": N,
                       "K": K, "ms": timer.ms(lambda: call_prefill(v, layer, codes, gs)),
                       "bf16_form_ms": timer.ms(lambda: call_prefill(v, layer, fq)),
                       "unscaled_ms": timer.ms(lambda: call_prefill(v, layer, codes, gs, False))}
                if VARIANTS[name][1]:
                    row["equals_bf16_form_fed_fake_quant"] = bool(torch.equal(got, fed))
                print(json.dumps(row), flush=True)
        del layer
        torch.cuda.empty_cache()


def call(v: Variant, layer, x):
    """One launch of a variant's decode (M <= 64) or prefill entry, as ops/mx
    launches the committed one (bf16 x)."""
    if x.shape[0] > 64:
        return call_prefill(v, layer, x)
    import chip_smoke as smoke
    meta = layer.meta
    M, N, K = x.shape[0], meta.out_features, meta.in_features
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
    if v.old:
        tiles, splits, kps, stages = smoke.parent_mx_decode_plan(M, N, K, 0, 2)
    else:
        with plan_attrs(v):
            p = mod.decode_plan(M, N, K, 0, 2)
        tiles, splits, kps, stages = p.tiles, p.splits, p.k_per_split, p.stages
    part, cnt = mod._split("variants_decode", splits * M * N if splits > 1 else 0, tiles,
                           x.device, stream)
    err = v.lib.gl_mx_decode(x.data_ptr(), layer.W_q.data_ptr(),
                             layer.scales.view(torch.uint8).data_ptr(), None, part, cnt,
                             out.data_ptr(), M, N, K, 2, 0, splits, kps, stages, stream)
    build.check(err, "mx_gemm variant (decode)")
    return out


def general_rows(timer, old, gen, max_m: int = 4096) -> None:
    """The committed general entry against an earlier tree's (``old``), one
    JSON line a case."""
    import chip_smoke as smoke
    from gemlite_tpu_torch.ops.dequantize import dequantize_full
    from gemlite_tpu_torch.ops.reference import mx_forward_ref

    for N, K in GENERAL_SHAPES:
        layer = smoke.mx_layer("a16w4_mxfp", N, K, gen)
        meta = layer.meta
        dense = dequantize_full(layer.W_q, layer.scales, None, meta)
        for M in (m for m, n, k in GENERAL_CASES if (n, k) == (N, K) and m <= max_m):
            x = (torch.randn((M, K), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
            want = mx_forward_ref(x, layer.W_q, layer.scales, None, None, smoke.with_f32_out(meta))
            got = mod.mx_general(x, layer.W_q, layer.scales, None, meta)
            was = old.general(x, layer.W_q, layer.scales, None, meta)
            torch.cuda.synchronize()
            row = {"variant": "general", "form": "a16w4_mxfp", "M": M, "N": N, "K": K,
                   "plan": mod.general_plan(M, N, K, False)._asdict(),
                   "rel_err": smoke.rel_err(got, want), "old_rel_err": smoke.rel_err(was, want),
                   "ms": timer.ms(lambda: mod.mx_general(x, layer.W_q, layer.scales, None, meta)),
                   "old_ms": timer.ms(lambda: old.general(x, layer.W_q, layer.scales, None,
                                                          meta)),
                   "dense_ms": timer.ms(lambda: torch.matmul(x, dense))}
            print(json.dumps(row), flush=True)
        del layer, dense
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="*", default=[n for n, v in VARIANTS.items()
                                                      if v[2] == "committed"])
    ap.add_argument("--old-source", type=Path, default=None,
                    help="an earlier tree's gemlite_tpu_torch/csrc: its general entry beside "
                         "the committed one, and the variants of its source")
    ap.add_argument("--decode-only", action="store_true",
                    help="the decode cases alone (and the general entry's at M <= 64)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_mx_variants: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from gemlite_tpu_torch.ops.reference import mx_forward_ref

    for name in args.variants:                      # fail on a stale substitution first
        variant_source(name, args.old_source)
    old = smoke.start_old_mx_build(args.old_source) if args.old_source else None
    libs = build_variants(args.variants, args.old_source)
    timer = smoke.Timer()
    gen = torch.Generator(device="cuda").manual_seed(13)
    if old is not None:
        general_rows(timer, old(), gen, 64 if args.decode_only else 4096)
    if not args.decode_only:
        csm4_rows(timer, libs, gen)
    layers = {}
    for M, N, K in CASES if libs else ():
        if args.decode_only and M > 64:
            continue
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
            if M <= 64:
                row["read_flush_ms"] = timer.ms(lambda: call(lib, layer, x), flush="read")
                # the weight and scale bytes the call streams, over its time
                row["copy_tb_s"] = (K * N // 2 + K * N // 32) / row["ms"] / 1e9
            if VARIANTS[name][1] and committed is not None:
                row["equals_committed"] = bool(torch.equal(got, committed))
            print(json.dumps(row), flush=True)
    print(smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
