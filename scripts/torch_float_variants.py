#!/usr/bin/env python3
# SPDX-License-Identifier: Apache-2.0
"""Time design variants of the general fused kernel's float path on one NVIDIA card.

    python3 scripts/torch_float_variants.py [--variants committed split_x2 ...]
                                            [--old-source DIR]

Each variant is the committed ``gemlite_tpu_torch/csrc/fused_float.cu`` with a
few lines replaced (the text substitutions in ``VARIANTS``) and the wrapper's
plan replaced where named, built with the package's nvcc flags into
``gemlite_tpu_torch/_build/variants/``. Only the int8-weight, bf16 instances
are built (the A16W8 layers it times: the source's int8-weight form alone,
``-DGL_FF_FORMS=0x01``, and its bf16 instances), which keeps each nvcc short. A checked
variant must equal the plain float32 result within 5e-3 at every case, and
the committed kernel bit for bit where its plan is the committed one; a
timing variant (``checked`` False) drops a phase of the kernel on purpose.
Times are medians of 20 launches with the L2 cache flushed by a 64 MiB write
before each (``chip_smoke.Timer``). Beside the committed kernel the script
times a dense bf16 ``torch.matmul`` on the dequantized weight. With
``--old-source DIR`` it also builds ``DIR/fused_gemm.cu`` (an earlier tree's
general kernel, whose ``gl_fused_gemm`` takes the same arguments) and times
its float path on the same layers. One JSON line per variant and case, then
the card's name and power limit. A substitution that no longer matches the
source fails the script before anything runs.
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

from gemlite_tpu_torch import DType  # noqa: E402
from gemlite_tpu_torch.ops import build  # noqa: E402
from gemlite_tpu_torch.ops import fused as mod  # noqa: E402

SOURCE = build.SRC_DIR / "fused_float.cu"
OUT_DIR = build.BUILD_DIR / "variants"
SHAPES = ((14336, 4096), (4096, 14336), (4096, 4096), (1024, 4096))
CASES = [(M, 14336, 4096) for M in (1, 8, 64, 128, 1024)] + \
        [(M, N, K) for N, K in SHAPES[1:] for M in (8, 128)]

# every variant builds the int8-weight form alone (ONLY_I8, the source's part
# defines) and of it the bf16 instances
ONLY_I8 = ("-DGL_FF_FORMS=0x01", "-DGL_FF_ENTRY=1", "-DGL_FF_LINKED=0x01")
_ONLY_I8_BF16 = [
    ("    if (x_code == gl::kF16)\n        return nt == 1 ? launch<F, __half, __half, 1>(p, splits, stream)\n"
     "                       : launch<F, __half, __half, 16>(p, splits, stream);\n"
     "    if (x_code == gl::kI8)\n        return nt == 1 ? launch<F, bf16, int8_t, 1>(p, splits, stream)\n"
     "                       : launch<F, bf16, int8_t, 16>(p, splits, stream);\n", ""),
]
_MMA = ("                mma16816<CT>(acc[0][jj], a[0][0], xb[0], xb[1]);\n"
        "                mma16816<CT>(acc[1][jj], a[0][1], xb[0], xb[1]);\n"
        "                mma16816<CT>(acc[0][jj], a[1][0], xb[2], xb[3]);\n"
        "                mma16816<CT>(acc[1][jj], a[1][1], xb[2], xb[3]);\n")
_KB = "    constexpr int kUnroll = GEN ? 1 : BK / KB;"
_TILE = "        return nt == 1 ? launch<F, bf16, bf16, 1>(p, splits, stream) : launch<F, bf16, bf16, 16>(p, splits, stream);"
_FAST = "                d[f] = fmaf(m, s[c], nbs[c]);\n"
_COMPUTE = ("        compute_stage<F, CT, XT, NT, GEN>(p, smem + (it % S) * SB, k_begin + it * BK, k_end, nt, wn0,\n"
            "                                          lane, zs, acc);\n")
_LOADS = "        if (nxt < steps) load_stage<F, XT>(p, smem + (nxt % S) * SB, m0, n0, k_begin + nxt * BK, k_end);\n"
_BLOCKS = "template <int NT> constexpr int min_blocks() { return NT == 1 ? 4 : 2; }"


def _split_rule(factor):
    def rule(M, N, K):
        p = _committed_plan(M, N, K)
        steps = -(-K // mod.FLOAT_BK)
        s = max(1, min(steps, round(p.splits * factor)))
        per = -(-steps // s)
        s = -(-steps // per)
        return p._replace(splits=s, k_per_split=K if s == 1 else per * mod.FLOAT_BK)
    return rule


def _nt16(M, N, K):
    """16 token tiles a block at every M (no 8-row instance)."""
    p = _committed_plan(max(M, 9), N, K)
    return p._replace(tiles_m=-(-M // 128))


def _nt8(M, N, K):
    """8 token tiles (64 rows) a block where the plan takes 16."""
    p = _committed_plan(M, N, K)
    return p if p.nt == 1 else p._replace(nt=8, tiles_m=-(-M // 64))


_committed_plan = mod.float_plan

# name: (substitutions, names of ops/fused set for the run, checked)
VARIANTS = {
    "committed": ([], {}, True),
    # the K split: twice and half the planned one, and none
    "split_x2": ([], {"float_plan": _split_rule(2.0)}, True),
    "split_half": ([], {"float_plan": _split_rule(0.5)}, True),
    "split_none": ([], {"float_plan": _split_rule(0.0)}, True),
    # 128-row blocks at M <= 8 too
    "nt16_always": ([], {"float_plan": _nt16}, True),
    # 64-row blocks above M 8
    "tile64": ([(_TILE, _TILE.replace("bf16, bf16, 16>", "bf16, bf16, 8>")),
                ("(nt == 16 || (nt == 1", "(nt == 8 || (nt == 1")], {"float_plan": _nt8}, True),
    # the k blocks of a stage in a loop for modes 0 and 2 too
    "kb_loop": ([(_KB, "    constexpr int kUnroll = 1;")], {}, True),
    # registers and shared memory for 6 (128-row tiles: 3) blocks an SM
    "blocks_more": ([(_BLOCKS, "template <int NT> constexpr int min_blocks() { return NT == 1 ? 6 : 3; }")],
                    {}, True),
    # for 3 (128-row tiles: 1) blocks an SM: deeper rings
    "blocks_fewer": ([(_BLOCKS, "template <int NT> constexpr int min_blocks() { return NT == 1 ? 3 : 1; }")],
                     {}, True),
    # timing only: no dequantization (the magic floats straight into the products)
    "no_dequant": ([(_FAST, "                d[f] = v[c][f];\n")], {}, False),
    # timing only: no products
    "no_mma": ([(_MMA, "")], {}, False),
    # timing only: the copies alone
    "copies_only": ([(_COMPUTE, "")], {}, False),
    # timing only: the first stage's copies, then dequantization and products alone
    "compute_only": ([(_LOADS, "")], {}, False),
}


def variant_source(src: str, subs) -> str:
    for old, new in list(subs) + _ONLY_I8_BF16:
        if src.count(old) != 1:
            raise SystemExit(f"substitution does not match the source once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def _spawn(src_path: Path, so: Path, include: Path, defines=()):
    return subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, *defines, "-I", str(include),
                             "-o", str(so), str(src_path)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build_variants(sources: dict, old_source):
    """{name: (entry, ptxas lines on spills)}, one nvcc per variant, all at once;
    "old" is the earlier tree's gl_fused_gemm."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cu, so = OUT_DIR / f"float_{name}.cu", OUT_DIR / f"float_{name}.so"
        cu.write_text(src)
        procs[name] = (_spawn(cu, so, build.SRC_DIR, ONLY_I8), so, "gl_fused_float", 17)
    if old_source is not None:
        so = OUT_DIR / "float_old.so"
        procs["old"] = (_spawn(old_source / "fused_gemm.cu", so, old_source), so, "gl_fused_gemm", 17)
    out = {}
    for name, (proc, so, entry, ints) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        fn = getattr(ctypes.CDLL(str(so)), entry)
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        spills = sorted({ln.strip() for ln in log.splitlines()
                         if "spill" in ln and " 0 bytes spill" not in ln})
        out[name] = (fn, spills)
    return out


def old_call(fn, x, layer):
    """The earlier tree's float path: gl_fused_gemm with int_path 0."""
    meta, K, N, M = layer.meta, layer.meta.in_features, layer.meta.out_features, x.shape[0]
    out = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
    err = fn(x.data_ptr(), layer.W_q.data_ptr(), layer.scales.data_ptr(), None, None, None,
             out.data_ptr(), None, None, M, N, K, meta.input_dtype, 0, meta.W_nbits,
             meta.elements_per_sample, DType.INT8.value, meta.W_group_mode, meta.channel_scale_mode,
             K, K, DType.FP32.value, 0, meta.output_dtype, 1, K,
             torch.cuda.current_stream().cuda_stream)
    build.check(err, "old fused_gemm")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS))
    ap.add_argument("--old-source", type=Path, default=None,
                    help="csrc directory of an earlier tree: time its float path too")
    args = ap.parse_args()
    src = SOURCE.read_text()
    sources = {name: variant_source(src, VARIANTS[name][0]) for name in args.variants}
    if not torch.cuda.is_available():
        print("torch_float_variants: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    import chip_smoke
    from gemlite_tpu_torch.helper import A16W8_INT8
    built = build_variants(sources, args.old_source)
    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = chip_smoke.Timer()
    layers = {(N, K): A16W8_INT8(device="cuda", dtype=torch.bfloat16).from_weights(
        torch.randn((N, K), generator=gen, device="cuda") * 0.02) for _, N, K in CASES}
    xs = {(M, K): (torch.randn((M, K), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
          for M, _, K in CASES}
    committed = {}
    lib = mod._lib
    saved = {k: getattr(mod, k) for _, consts, _ in VARIANTS.values() for k in consts}
    try:
        for name in args.variants:
            _, consts, checked = VARIANTS[name]
            mod._lib = lambda source, f=built[name][0]: f
            for k, v in saved.items():
                setattr(mod, k, consts.get(k, v))
            for M, N, K in CASES:
                layer, x = layers[(N, K)], xs[(M, K)]
                call = (x, layer.W_q, layer.scales, layer.zeros, None, layer.meta)
                got = mod.fused_gemm_float(*call)
                p = mod.float_plan(M, N, K)
                if name == "committed":
                    committed[(M, N, K)] = got
                same = bool(torch.equal(got, committed[(M, N, K)])) \
                    if p == _committed_plan(M, N, K) and (M, N, K) in committed else None
                want = mod.fused_matmul_plain(*call[:5], layer.meta._replace(
                    output_dtype=DType.FP32.value))
                err = float((got.float() - want).abs().max() / want.abs().max())
                if checked and (err > 5e-3 or same is False):
                    raise RuntimeError(f"{name} is wrong at {(M, N, K)}: rel {err}, "
                                       f"equal to committed {same}")
                w_bytes = K * N + 4 * N
                row = {"variant": name, "M": M, "N": N, "K": K, "names": sorted(consts),
                       "plan": p._asdict(), "spills": built[name][1], "checked": checked,
                       "rel_err": err, "equals_committed": same,
                       "ms": timer.ms(lambda: mod.fused_gemm_float(*call)),
                       "bound_ms": max((w_bytes + 2 * M * K + 2 * M * N) / 3.35e12,
                                       2.0 * M * N * K / 989e12) * 1e3}
                if name == "committed":
                    dense = (layer.W_q.float() * layer.scales.float()).to(torch.bfloat16)
                    row["dense_bf16_matmul_ms"] = timer.ms(lambda: torch.matmul(x, dense))
                    if "old" in built:
                        old = old_call(built["old"][0], x, layer)
                        row["old_rel_err"] = float((old.float() - want).abs().max() / want.abs().max())
                        row["old_ms"] = timer.ms(lambda: old_call(built["old"][0], x, layer), iters=5)
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
