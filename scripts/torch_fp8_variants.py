#!/usr/bin/env python3
# SPDX-License-Identifier: Apache-2.0
"""Time design variants of the port's fp8 kernels on one NVIDIA card.

    python3 scripts/torch_fp8_variants.py [--variants committed no_promotion ...]
                                          [--old-source DIR]

Each variant is the committed ``gemlite_tpu_torch/csrc/fp8_gemm.cu``, or with
``--old-source DIR`` an earlier tree's (``DIR`` is that tree's
``gemlite_tpu_torch/csrc``, e.g. unpacked by ``git archive`` into
``_archive/``), with a few lines replaced (the text substitutions in
``VARIANTS``), built with the package's nvcc flags into
``gemlite_tpu_torch/_build/variants/`` and run with the committed plans
(``ops/fp8.decode_plan`` / ``prefill_plan``), the earlier tree's
(``chip_smoke.old_fp8_plan``) or the decode plan a variant names:

  committed      the source as it is;
  columns_first  the prefill grid with the column tiles fastest (each row
                 tile then reads the words from memory; bit for bit the
                 committed result);
  no_promotion   the fp8 products summed straight into the float32
                 accumulators, without the fresh fragment a 128-deep stage
                 that the committed kernels add into them: the error this
                 costs at K 4096 and 14336, on the 256-row prefill blocks too;
  regs_224       the prefill's consumers at 224 registers, its producer at
                 56, as the kernel first had them (bit for bit the committed
                 result);
  plain_words    the prefill's word stage as one box of 128-word rows, read
                 on 16 neighbouring columns a warp, as the kernel first had it and as
                 the committed bf16 form has it, with fp8 x too (bit for bit
                 the committed result; the reads conflict 4-way);
  grouped_bf16   the fp8 form's swizzled groups with bf16 x too (bit for bit
                 the committed result; conflict-free reads, and 4-6% slower:
                 NVIDIA H100 80GB HBM3, 700 W; PERF.md);
  rows_128, rows_256  the prefill on 128 or 256 rows a block at every M
                 (bit for bit the committed result where the split is the
                 same);
  copies         the decode kernel's copies alone, no products (the result
                 is wrong): the committed decode's stream;
  parent         the earlier tree's source as it is (needs --old-source, as
                 do the variants below);
  parent_free_reads  its prefill consumers read the word tile at the
                 addresses the decode body's swizzle gives (bits 3-4 of the
                 column flipped by bits 0-1 of the word row), so that the 32
                 lanes of a read hit 32 banks, while TMA still lands the tile
                 unswizzled (the result is wrong): what the bank conflicts of
                 its A-fragment reads cost;
  parent_regs_240  its prefill consumers at 240 registers, its producer at
                 24 (bit for bit its result);
  parent_copies  its decode kernel's copies alone (the result is wrong), on
                 its plan: 128 columns a block, 448 blocks on 14336x4096;
  parent_copies_396  the same on at most 3 x 132 blocks, the blocks that fit
                 the card at once (3 an SM);
  parent_396     its whole decode kernel on that plan;
  parent_copies_256  its decode copies with 256 columns a block (8 warps, 1 KB
                 runs a word row; the prefill of this build is not run) on
                 448 blocks, two stages a block;
  parent_copies_256_396  the same on at most 396 blocks (3 an SM);
  parent_copies_256_264  the same on at most 264 blocks (2 an SM), three
                 stages a block.

Every case reports max|a-b| / max|b| against the plain float32 result
(``ops/reference.forward_fp8_ref``); an exact variant must equal the
committed kernel (an earlier tree's exact variant: that tree's kernel) bit
for bit. Times are medians of 20 launches with the L2 cache flushed before
each (``chip_smoke.Timer``). One JSON line per variant and case, then the
card's name and power limit. A substitution that no longer matches its
source fails the script before anything runs.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from gemlite_tpu_torch.ops import build  # noqa: E402
from gemlite_tpu_torch.ops import fp8 as mod  # noqa: E402

SOURCE = build.SRC_DIR / "fp8_gemm.cu"
OUT_DIR = build.BUILD_DIR / "variants"
SHAPES = ((14336, 4096), (4096, 14336), (4096, 4096), (1024, 4096))     # (N, K)
PREFILL_CASES = [(kind, M, N, K) for kind in ("a8w8_fp8", "a16w8_fp8") for N, K in SHAPES[:2]
                 for M in (128, 256, 1024, 2048)]
DECODE_CASES = [(kind, M, N, K) for kind in ("a8w8_fp8", "a16w8_fp8") for N, K in SHAPES
                for M in (1, 8, 64)]


class Variant(NamedTuple):
    subs: Tuple[Tuple[str, str], ...]
    exact: bool                  # the result equals the unchanged source's bit for bit
    base: str                    # "committed" or "old"
    kernels: Tuple[str, ...]     # the entries it runs
    decode: Optional[Tuple[int, int, int]] = None   # (columns, most blocks, smem budget)
    rows: Optional[int] = None   # the prefill's rows a block, in place of the plan's


_COMPUTE = "        d_compute_stage<NT, X, W>(smem + (it % S) * SB, nt, wn0, lane, acc);\n"
_OLD_BN = ("constexpr int BN = 128;                  // output columns per block: 4 warps of 32",
           "constexpr int BN = 256;")
_OLD_READS = (
    ("                    const uint32_t w = ws[(4 * kk + 2 * half + (t >> 1)) * BN + 8 * h];",
     "                    const uint32_t w = ws[(4 * kk + 2 * half + (t >> 1)) * BN +\n"
     "                                          (((col + 8 * h) ^ ((2 * half + (t >> 1)) << 3)) - "
     "col)];"),
    ("                    a[kk][2 * half + h] = ws[(8 * kk + 4 * half + t) * BN + 8 * h];",
     "                    a[kk][2 * half + h] = ws[(8 * kk + 4 * half + t) * BN +\n"
     "                                             (((col + 8 * h) ^ (t << 3)) - col)];"))
BOTH = ("decode", "prefill")
VARIANTS = {
    "committed": Variant((), True, "committed", BOTH),
    "columns_first": Variant((
        ("    const int tid = threadIdx.x, n0 = blockIdx.y * BN;",
         "    const int tid = threadIdx.x, n0 = blockIdx.x * BN;"),
        ("    const int n0 = blockIdx.y * BN, m0 = blockIdx.x * NB * 128;",
         "    const int n0 = blockIdx.x * BN, m0 = blockIdx.y * NB * 128;"),
        ("    const dim3 grid((p.M + NB * 128 - 1) / (NB * 128), p.N / BN, splits);",
         "    const dim3 grid(p.N / BN, (p.M + NB * 128 - 1) / (NB * 128), splits);"),
    ), True, "committed", ("prefill",)),
    "no_promotion": Variant((
        ("        wgmma_fp8_n128<W, X>(d, a[kk], dx + ((nb * 128 * 128 + kk * 32) >> 4), kk);",
         "        wgmma_fp8_n128<W, X>(d, a[kk], dx + ((nb * 128 * 128 + kk * 32) >> 4), 1);"),
        ("        p_fp8_products<X, W>(tmp, a[USE], dx, 0);",
         "        p_fp8_products<X, W>(acc[0], a[USE], dx, 0);"),
        ("        for (int i = 0; i < 64; ++i) acc[0][i] += tmp[i];", ""),
        ("        p_fp8_products<X, W>(tmp, a[USE], dx, 1);",
         "        p_fp8_products<X, W>(acc[NB - 1], a[USE], dx, 1);"),
        ("        for (int i = 0; i < 64; ++i) acc[NB - 1][i] += tmp[i];", ""),
        ("                for (int kb = 0; kb < BK / 32; ++kb) mma_fp8<W, X>(s, a[kb][i], b[kb][0], "
         "b[kb][1]);",
         "                for (int kb = 0; kb < BK / 32; ++kb) mma_fp8<W, X>(acc[i][jj], a[kb][i], "
         "b[kb][0], b[kb][1]);"),
        ("                for (int r = 0; r < 4; ++r) acc[i][jj][r] += s[r];", ""),
    ), False, "committed", BOTH),
    "regs_224": Variant((("constexpr int kProducerRegs = 24, kConsumerRegs = 240;",
                          "constexpr int kProducerRegs = 56, kConsumerRegs = 224;"),),
                        True, "committed", ("prefill",)),
    "plain_words": Variant((("template <int X> __host__ __device__ constexpr bool w_groups() "
                             "{ return X != kXbf16; }",
                             "template <int X> __host__ __device__ constexpr bool w_groups() "
                             "{ return false; }"),), True, "committed", ("prefill",)),
    "grouped_bf16": Variant((("template <int X> __host__ __device__ constexpr bool w_groups() "
                              "{ return X != kXbf16; }",
                              "template <int X> __host__ __device__ constexpr bool w_groups() "
                              "{ return true; }"),), True, "committed", ("prefill",)),
    "rows_128": Variant((), True, "committed", ("prefill",), rows=128),
    "rows_256": Variant((), True, "committed", ("prefill",), rows=256),
    "copies": Variant(((_COMPUTE, ""),), False, "committed", ("decode",)),
    "parent": Variant((), True, "old", BOTH),
    "parent_free_reads": Variant(_OLD_READS, False, "old", ("prefill",)),
    "parent_regs_240": Variant((("constexpr int kProducerRegs = 56, kConsumerRegs = 224;",
                                 "constexpr int kProducerRegs = 24, kConsumerRegs = 240;"),),
                               True, "old", ("prefill",)),
    "parent_copies": Variant(((_COMPUTE, ""),), False, "old", ("decode",)),
    "parent_copies_396": Variant(((_COMPUTE, ""),), False, "old", ("decode",),
                                 (128, 396, 72 * 1024)),
    "parent_396": Variant((), False, "old", ("decode",), (128, 396, 72 * 1024)),
    "parent_copies_256": Variant(((_COMPUTE, ""), _OLD_BN), False, "old", ("decode",),
                                 (256, 448, 72 * 1024)),
    "parent_copies_256_396": Variant(((_COMPUTE, ""), _OLD_BN), False, "old", ("decode",),
                                     (256, 396, 72 * 1024)),
    "parent_copies_256_264": Variant(((_COMPUTE, ""), _OLD_BN), False, "old", ("decode",),
                                     (256, 264, 108 * 1024)),
}


def variant_source(name: str, old_source: Optional[Path]) -> str:
    v = VARIANTS[name]
    if v.base == "old" and old_source is None:
        raise RuntimeError(f"variant {name} changes an earlier tree's source: give --old-source")
    src = (SOURCE if v.base == "committed" else old_source / "fp8_gemm.cu").read_text()
    for old, new in v.subs:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old.strip()!r} matches {src.count(old)} times")
        src = src.replace(old, new)
    return src


def build_variants(names, old_source: Optional[Path]) -> dict:
    """{name: ctypes library}, every distinct source compiled at once."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs, by_text = {}, {}
    for name in names:
        text = variant_source(name, old_source)
        if text in by_text:
            continue
        by_text[text] = name
        old = VARIANTS[name].base == "old"
        cu = OUT_DIR / f"fp8_gemm_{name}.cu"
        cu.write_text(text)
        so = OUT_DIR / f"fp8_gemm_{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(old_source if old else build.SRC_DIR),
               "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    built = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log[-4000:]}")
        print(json.dumps({"variant": name, "built": True, "spills": spill_report(log)}), flush=True)
        lib = ctypes.CDLL(str(so))
        for fn, ptrs, ints in (("gl_fp8_prefill", 7, 12), ("gl_fp8_decode", 7, 11)):
            f = getattr(lib, fn)
            f.argtypes = [ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints + [ctypes.c_void_p]
            f.restype = ctypes.c_int
        built[name] = lib
    return {name: built[by_text[variant_source(name, old_source)]] for name in names}


def spill_report(log: str) -> list:
    """The kernels that ptxas reports spilling (-Xptxas=-v), with the spill."""
    out, fn = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else line.strip()
        elif "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
            out.append(f"{fn}: {line.split(':', 1)[-1].strip()}")
    return out


def decode_plan_for(cols: int, most: int, budget: int, M: int, N: int, K: int, xb: int):
    """A decode plan for a variant: ``cols`` columns a block, K cut in
    128-deep stages, at least two a split, into the most splits that keep
    the grid at ``most`` blocks or fewer, the deepest ring within
    ``budget``. Returns (column tiles, splits, k_per_split, stages)."""
    tiles, steps = N // cols, K // 128
    splits = max(1, min(steps // 2, most // tiles))
    per = -(-steps // splits)
    rows = next(nt for nt in (1, 2, 4, 8) if M <= 8 * nt)
    stages = max(2, min(6, budget // (32 * cols * 4 + rows * 8 * 128 * xb)))
    return tiles, -(-steps // per), per * 128, stages


def call(name: str, lib, kind: str, layer, x, sx):
    """One launch of a variant's decode (M <= 64) or prefill entry with the
    plan its tree takes, or the decode plan the variant names."""
    import chip_smoke as smoke
    meta = layer.meta
    M, N, K = x.shape[0], meta.out_features, meta.in_features
    xb = 2 if kind == "a16w8_fp8" else 1
    kernel = "fp8_decode" if M <= 64 else "fp8_prefill"
    v = VARIANTS[name]
    if v.decode is not None and kernel == "fp8_decode":
        plan = decode_plan_for(*v.decode, M, N, K, xb)
    elif v.base == "old":
        plan = smoke.old_fp8_plan(kernel, M, N, K, xb)
    elif kernel == "fp8_decode":
        p = mod.decode_plan(M, N, K, xb)
        plan = (p.tiles, p.splits, p.k_per_split, p.stages)
    else:
        p = mod.prefill_plan(M, N, K, xb, bm=v.rows)
        plan = (p.bm, p.splits, p.k_per_split, p.stages)
    return smoke.old_fp8_call(lib, kernel, x, layer.W_q, layer.scales, sx, meta, plan), plan


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="*", default=[n for n, v in VARIANTS.items()
                                                      if v.base == "committed"])
    ap.add_argument("--old-source", type=Path, default=None,
                    help="an earlier tree's gemlite_tpu_torch/csrc: the variants of its source")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_fp8_variants: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from gemlite_tpu_torch.ops.reference import forward_fp8_ref

    names = list(args.variants)
    for base, ref in (("committed", "committed"), ("old", "parent")):   # what exact ones equal
        if ref not in names and any(VARIANTS[n].base == base and VARIANTS[n].exact
                                    for n in names):
            names.insert(0, ref)
    for name in names:                              # fail on a stale substitution first
        variant_source(name, args.old_source)
    libs = build_variants(names, args.old_source)
    timer = smoke.Timer()
    gen = torch.Generator(device="cuda").manual_seed(12)
    layers = {}
    for kind, M, N, K in DECODE_CASES + PREFILL_CASES:
        kernel = "decode" if M <= 64 else "prefill"
        names = [n for n in libs if kernel in VARIANTS[n].kernels]
        if not names:
            continue
        if (kind, N, K) not in layers:
            layers.clear()
            torch.cuda.empty_cache()
            layers[(kind, N, K)] = smoke.fp8_layer(kind, N, K, gen)
        layer = layers[(kind, N, K)]
        x, sx = smoke.fp8_inputs(layer, M, gen)
        want = forward_fp8_ref(x, layer.W_q, layer.scales, sx, smoke.with_f32_out(layer.meta))
        ref = {VARIANTS[n].base: call(n, libs[n], kind, layer, x, sx)[0]
               for n in ("committed", "parent") if n in names}
        for name in names:
            got, plan = call(name, libs[name], kind, layer, x, sx)
            torch.cuda.synchronize()
            row = {"variant": name, "kernel": kernel, "form": kind, "M": M, "N": N, "K": K,
                   "plan": plan, "blocks": plan[0] * plan[1] if kernel == "decode" else None,
                   "rel_err": smoke.rel_err(got, want),
                   "ms": timer.ms(lambda: call(name, libs[name], kind, layer, x, sx))}
            if VARIANTS[name].exact:
                row["equals_unchanged"] = bool(torch.equal(got, ref[VARIANTS[name].base]))
            print(json.dumps(row), flush=True)
    print(smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
