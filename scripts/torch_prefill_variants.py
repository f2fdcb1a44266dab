#!/usr/bin/env python3
# SPDX-License-Identifier: Apache-2.0
"""Time design variants of the port's W1/W2/W4 prefill kernel on one NVIDIA card.

    python3 scripts/torch_prefill_variants.py [--variants committed stages3 ...]
    python3 scripts/torch_prefill_variants.py --modes [--modes-variants stages_64 ...]

With ``--modes`` it times variants of the mode 1-3 form's persistent kernel
(``csrc/prefill_modes.cu``): its plan with a name set otherwise (one ring
stage fewer, no K split of the last wave), text edits (64-deep stages; and,
timing only, no dequantization, no products, the copies alone), and
``parent``, prefill_gemm.cu's mode 1-3
instances on the mode-4 ``plan`` (the kernel the persistent one replaced on
these shapes), on chip_smoke.py's MODES_FORMS at its MODES_SHAPES and M 128 /
1024 / 2048; a checked variant within 5e-3 of ``forward_f32_epilogue``; a
dense bf16 matmul on the dequantized weight beside them; the same L2 flush
and medians.

Each variant is the committed ``gemlite_tpu_torch/csrc/prefill_gemm.cu`` with a
few lines replaced (the text substitutions in ``VARIANTS``) and the wrapper's
plan run with some of its names set otherwise (ring depth, row tile, the split
rule), built with the package's nvcc flags into
``gemlite_tpu_torch/_build/variants/``. A checked variant must equal the plain
float32 result within 5e-3 at every case, and the committed kernel bit for bit
where its plan cuts K as the committed plan does; a timing variant (``checked``
False) drops a phase of the kernel on purpose. Times are medians of 20
launches with the L2 cache flushed by a 64 MiB write before each
(``chip_smoke.Timer``). Beside the committed kernel the script times a dense
bf16 ``torch.matmul`` of the same shape and ``torch._weight_int4pack_mm`` on
the same W4 layer (``chip_smoke.int4pack_mm``). One JSON line per variant and
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
from gemlite_tpu_torch.ops import prefill as mod  # noqa: E402

SOURCE = build.SRC_DIR / "prefill_gemm.cu"
OUT_DIR = build.BUILD_DIR / "variants"
GROUP = 128
SHAPES = ((14336, 4096), (4096, 14336), (4096, 4096), (1024, 4096))
CASES = [(4, M, N, K) for N, K in SHAPES for M in (128, 1024, 2048)] + \
        [(bits, 128, 14336, 4096) for bits in (2, 1)]

_BUILD_FIRST = "        build_stage<BITS>(a[1], g, L, 1 % c.S, col, t, c.sel);"
_BUILD = "        build_stage<BITS>(a[1 - ISSUE], c.g, *c.L, (j + 2) % c.S, c.col, c.t, c.sel);"
_ISSUE_FIRST = "    issue_stage<NB>(acc, a[0], c.x_desc<NB>(0));"
_ISSUE = "    issue_stage<NB>(acc, a[ISSUE], c.x_desc<NB>(j + 1));"
_BYTES = "    const uint32_t bytes = x_bytes(NB) + (p.tma_wm ? words_bytes(BITS) + kMetaBytes : 0);"
_TMA_X = "            tma_load_2d(base + st * x_bytes(NB), &maps.x, full, k0, m0);\n"
_DEQUANT = "dequant_pair(code_pair<BITS>(w, shift, sel), s2[h], m2[h], z2[h]);"


def _fill_rule(M, N, K, gs, bits):
    """The least split whose grid covers every SM (at least 132 blocks)."""
    p = _committed_plan(M, N, K, gs, bits)
    steps = K // mod.BK
    for s in range(1, steps + 1):
        per = -(-steps // s)
        if -(-steps // per) == s and p.tiles_n * p.tiles_m * s >= mod.SMS:
            return p._replace(splits=s, k_per_split=per * mod.BK)
    return p


def _scaled_split(factor):
    def rule(M, N, K, gs, bits):
        p = _committed_plan(M, N, K, gs, bits)
        steps = K // mod.BK
        s = max(1, min(steps, round(p.splits * factor)))
        per = -(-steps // s)
        return p._replace(splits=-(-steps // per), k_per_split=per * mod.BK)
    return rule


def _row_tile(bm):
    def rule(M, N, K, gs, bits):
        saved = mod.row_tile
        mod.row_tile = lambda _M: bm
        try:
            return _committed_plan(M, N, K, gs, bits)
        finally:
            mod.row_tile = saved
    return rule


_committed_plan = mod.plan

# name: (substitutions, names of ops/prefill set for the run, checked)
VARIANTS = {
    "committed": ([], {}, True),
    # rings of at most 3, 4 and 6 stages instead of 5
    "stages3": ([], {"MAX_STAGES": 3}, True),
    "stages4": ([], {"MAX_STAGES": 4}, True),
    "stages6": ([], {"MAX_STAGES": 6}, True),
    # one n128 row tile at every M, and two (256 rows) at every M
    "bm128": ([], {"plan": _row_tile(128)}, True),
    "bm256": ([], {"plan": _row_tile(256)}, True),
    # the K split: the least that fills all 132 SMs, twice and half the planned one
    "split_fill": ([], {"plan": _fill_rule}, True),
    "split_x2": ([], {"plan": _scaled_split(2.0)}, True),
    "split_half": ([], {"plan": _scaled_split(0.5)}, True),
    # one stage in flight: wait for stage j + 1's products too before building on
    "wait_all": ([("    wgmma_wait<1>();\n    pin(a[1 - ISSUE]);",
                   "    wgmma_wait<0>();\n    pin(a[1 - ISSUE]);")], {}, True),
    # timing only: no dequantization (raw 128 + q into the products)
    "no_dequant": ([(_DEQUANT, "code_pair<BITS>(w, shift, sel);")], {}, False),
    # timing only: no products (copies and dequantization)
    "no_mma": ([(_ISSUE_FIRST, ""), (_ISSUE, "")], {}, False),
    # timing only: the copies alone (no dequantization, no products)
    "copies_only": ([(_ISSUE_FIRST, ""), (_ISSUE, ""), (_BUILD_FIRST, ""), (_BUILD, "")],
                    {}, False),
    # timing only: the x boxes alone, and the words and metadata alone
    "x_only": ([(_ISSUE_FIRST, ""), (_ISSUE, ""), (_BUILD_FIRST, ""), (_BUILD, ""),
                (_BYTES, "    const uint32_t bytes = x_bytes(NB);"),
                ("            if (p.tma_wm) {", "            if (false) {"),
                ("        if (!p.tma_wm) {", "        if (false) {")], {}, False),
    "words_only": ([(_ISSUE_FIRST, ""), (_ISSUE, ""), (_BUILD_FIRST, ""), (_BUILD, ""),
                    (_BYTES, "    const uint32_t bytes = p.tma_wm ? words_bytes(BITS) + kMetaBytes : 0;"),
                    (_TMA_X, "")], {}, False),
    # timing only: the first stage's copies, then dequantization and products alone
    "compute_only": ([("    for (int it = 0; it < steps; ++it) {\n        const int st = it % S, k0",
                       "    for (int it = 0; it < 1; ++it) {\n        const int st = it % S, k0"),
                      ("        c.full(1);\n", ""), ("        c.full(j + 2);\n", "")],
                     {}, False),
}


def variant_source(src: str, subs) -> str:
    for old, new in subs:
        if src.count(old) != 1:
            raise SystemExit(f"substitution does not match the source once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build_variants(sources: dict) -> dict:
    """{name: (gl_prefill, ptxas lines on spills)}, one nvcc per variant, all at once."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cu, so = OUT_DIR / f"prefill_{name}.cu", OUT_DIR / f"prefill_{name}.so"
        cu.write_text(src)
        procs[name] = (subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.SRC_DIR),
                                         "-o", str(so), str(cu)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    out = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        fn = ctypes.CDLL(str(so)).gl_prefill
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        spills = sorted({ln.strip() for ln in log.splitlines()
                         if "spill" in ln and " 0 bytes spill" not in ln})
        out[name] = (fn, spills)
    return out


def _modes_operands(x, layer, sx):
    meta = layer.meta
    out = torch.empty((x.shape[0], meta.out_features), dtype=torch.bfloat16, device=x.device)
    return mod.w4.modes_operands(layer.W_q, layer.scales, layer.zeros, sx, meta, x.shape[0]), out


def _parent_modes(x, layer, sx):
    """prefill_gemm.cu's mode 1-3 instances on the mode-4 plan."""
    operands, out = _modes_operands(x, layer, sx)
    return mod.prefill_modes_ragged(x, layer.W_q, operands, out, layer.meta, mod.w4.stream())


def _persistent_modes(lib, x, layer, sx, p):
    """``lib`` (a gl_prefill_modes_persistent) on plan ``p``, as
    ops/prefill.prefill_modes launches it."""
    meta, M = layer.meta, x.shape[0]
    N, K, gs = meta.out_features, meta.in_features, meta.group_size
    (s, z, zs, sxx, cs), out = _modes_operands(x, layer, sx)
    stream = mod.w4.stream()
    part = cnt = None
    floats, ints = mod.modes_workspace(p)
    if floats:
        cnt, part = build.split_state("prefill_modes", x.device, ints, floats, stream)
    ptr = mod.w4.pointer
    build.check(lib(x.data_ptr(), layer.W_q.data_ptr(), ptr(s), ptr(z), ptr(zs), ptr(sxx),
                    ptr(cs), ptr(part), ptr(cnt), out.data_ptr(), M, N, K, gs, meta.W_nbits,
                    p.bm, p.stages, p.grid, p.full, p.splits, p.k_per_split,
                    meta.channel_scale_mode, mod.w4.scale_code(cs), stream), "prefill_modes")
    return out


def _modes_variant(name):
    """The plan of a persistent-kernel variant, or None for ``parent``."""
    def plan(M, N, K, gs, bits):
        p = mod.modes_plan(M, N, K, gs, bits)
        if name == "no_split":
            p = p._replace(full=p.tiles, splits=1, k_per_split=K, grid=min(mod.SMS, p.tiles))
        if name == "stages_less":
            p = p._replace(stages=max(2, p.stages - 1))
        return p
    return None if name == "parent" else plan


_MODES_DEQUANT = ("                a[kk][2 * half + h] = dequant_pair_shift(\n"
                  "                    code_pair<BITS>(ws[kl / EPW * BN + 8 * h], shift, c.sel), "
                  "s2[h], z2[h]);")
_MODES_MMA = ("        if constexpr (NB == 2)\n"
              "            wgmma_rs_n256(reinterpret_cast<float(&)[128]>(acc), a[kk], "
              "dx + ((kk * 32) >> 4));\n"
              "        else\n"
              "            wgmma_rs_n128<0>(acc[0], a[kk], dx + ((kk * 32) >> 4), 1);")
_NO_DEQUANT = (_MODES_DEQUANT, "                a[kk][2 * half + h] = code_pair<BITS>(ws[kl / EPW * BN "
                               "+ 8 * h], shift, c.sel) ^ s2[h] ^ z2[h];")
_NO_MMA = [(_MODES_MMA, "        (void)dx;")]
# text edits of prefill_modes.cu: stages of 64 k (checked), and timing only
# (their sums are not the layer's) no dequantization, no products, the copies
# alone
MODES_TEXT = {"stages_64": [("constexpr int SUB = 2;", "constexpr int SUB = 1;")],
              "no_dequant": [_NO_DEQUANT], "no_mma": _NO_MMA,
              "copies_only": [_NO_DEQUANT] + _NO_MMA}
MODES_CHECKED_TEXT = ("stages_64",)
MODES_VARIANTS = ("committed", "no_split", "stages_less", "parent") + tuple(MODES_TEXT)


def build_modes_text(names) -> dict:
    """{name: gl_prefill_modes_persistent of prefill_modes.cu with MODES_TEXT[name]'s edits}."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = (build.SRC_DIR / "prefill_modes.cu").read_text()
    procs = {}
    for name in names:
        cu, so = OUT_DIR / f"prefill_modes_{name}.cu", OUT_DIR / f"prefill_modes_{name}.so"
        cu.write_text(variant_source(src, MODES_TEXT[name]))
        procs[name] = (subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.SRC_DIR),
                                         "-o", str(so), str(cu)], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), so)
    out = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        fn = ctypes.CDLL(str(so)).gl_prefill_modes_persistent
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out[name] = fn
    return out


def main_modes(names) -> int:
    import chip_smoke
    from gemlite_tpu_torch import DType
    from gemlite_tpu_torch.dtypes import to_torch_dtype
    from gemlite_tpu_torch.ops.dequantize import dequantize_full
    from gemlite_tpu_torch.ops.reference import forward_f32_epilogue
    from gemlite_tpu_torch.quant import scale_activations_per_token
    texts = build_modes_text([n for n in names if n in MODES_TEXT])
    committed_lib = mod._lib_persistent()
    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = chip_smoke.Timer()
    for form in chip_smoke.MODES_FORMS:
        for N, K in chip_smoke.MODES_SHAPES:
            layer = chip_smoke.modes_layer(form, N, K, gen)
            meta = layer.meta
            dense = dequantize_full(layer.W_q, layer.scales, layer.zeros, meta)
            for M in chip_smoke.MODES_PREFILL_MS:
                xb = (torch.randn((M, K), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
                xq, sx = (scale_activations_per_token(xb, to_torch_dtype(meta.input_dtype))
                          if meta.scaled_activations else (xb, None))
                x = xq.to(torch.bfloat16)
                args = (layer.W_q, layer.scales, layer.zeros, sx)
                want = forward_f32_epilogue(xq, *args, meta._replace(output_dtype=DType.FP32.value))
                row = {"form": form, "M": M, "N": N, "K": K,
                       "dense_bf16_matmul_ms": timer.ms(lambda: torch.matmul(x, dense))}
                for name in names:
                    plan = _modes_variant(name)
                    if plan is None:
                        fn = (lambda: _parent_modes(x, layer, sx))
                    else:
                        p = plan(M, N, K, meta.group_size, meta.W_nbits)
                        fn = (lambda p=p, lib=texts.get(name, committed_lib):
                              _persistent_modes(lib, x, layer, sx, p))
                    got = fn()
                    err = float((got.float() - want).abs().max() / want.abs().max())
                    checked = name not in texts or name in MODES_CHECKED_TEXT
                    if err > 5e-3 and checked:
                        raise RuntimeError(f"{name} is wrong at {(form, M, N, K)}: rel {err}")
                    row[name] = {"ms": timer.ms(fn), "rel_err": err, "checked": checked,
                                 "plan": None if plan is None else p._asdict()}
                print(json.dumps(row), flush=True)
            del layer, dense
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS))
    ap.add_argument("--modes", action="store_true",
                    help="time the mode 1-3 form's plan variants (MODES_VARIANTS) instead")
    ap.add_argument("--modes-variants", nargs="+", default=list(MODES_VARIANTS),
                    choices=MODES_VARIANTS)
    args = ap.parse_args()
    if args.modes:
        if not torch.cuda.is_available():
            print("torch_prefill_variants: no CUDA device; this script runs only on the card",
                  file=sys.stderr)
            return 2
        return main_modes(args.modes_variants)
    src = SOURCE.read_text()
    sources = {name: variant_source(src, VARIANTS[name][0]) for name in args.variants}
    if not torch.cuda.is_available():
        print("torch_prefill_variants: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    import chip_smoke
    from gemlite_tpu_torch import DType
    built = build_variants(sources)
    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = chip_smoke.Timer()
    layers = {(bits, N, K): chip_smoke.random_layer(N, K, gen, bits) for bits, _, N, K in CASES}
    xs = {(M, K): (torch.randn((M, K), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
          for _, M, _, K in CASES}
    committed = {}
    lib = mod._lib
    saved = {k: getattr(mod, k) for _, consts, _ in VARIANTS.values() for k in consts}
    try:
        for name in args.variants:
            _, consts, checked = VARIANTS[name]
            mod._lib = lambda f=built[name][0]: f
            for k, v in saved.items():
                setattr(mod, k, consts.get(k, v))
            for bits, M, N, K in CASES:
                layer, x = layers[(bits, N, K)], xs[(M, K)]
                call = (x, layer.W_q, layer.scales, layer.zeros, layer.meta)
                got = mod.prefill_matmul(*call)
                p = mod.plan(M, N, K, GROUP, bits)
                if name == "committed":
                    committed[(bits, M, N, K)] = (got, p.k_per_split)
                ref, ref_split = committed.get((bits, M, N, K), (None, None))
                same = bool(torch.equal(got, ref)) if ref_split == p.k_per_split else None
                want = mod.prefill_matmul_plain(*call[:4], layer.meta._replace(
                    output_dtype=DType.FP32.value))
                err = float((got.float() - want).abs().max() / want.abs().max())
                if checked and (err > 5e-3 or same is False):
                    raise RuntimeError(f"{name} is wrong at {(bits, M, N, K)}: rel {err}, "
                                       f"equal to committed {same}")
                w_bytes = K * N * bits / 8 + 2 * 2 * (K // GROUP) * N
                row = {"variant": name, "bits": bits, "M": M, "N": N, "K": K,
                       "names": sorted(consts), "plan": p._asdict(), "spills": built[name][1],
                       "checked": checked, "rel_err": err, "equals_committed": same,
                       "ms": timer.ms(lambda: mod.prefill_matmul(*call)),
                       "bound_ms": max((w_bytes + 2 * M * K + 2 * M * N) / 3.35e12,
                                       2.0 * M * N * K / 989e12) * 1e3}
                if name == "committed":
                    dense = torch.randn((K, N), generator=gen, device="cuda").to(torch.bfloat16)
                    row["dense_bf16_matmul_ms"] = timer.ms(lambda: torch.matmul(x, dense))
                    if bits == 4:
                        library = chip_smoke.int4pack_mm(*call[1:4], K)
                        row["library_ms"] = timer.ms(lambda: library(x))
                    del dense
                print(json.dumps(row), flush=True)
    finally:
        mod._lib = lib
        for k, v in saved.items():
            setattr(mod, k, v)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
