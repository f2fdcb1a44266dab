#!/usr/bin/env python3
# SPDX-License-Identifier: Apache-2.0
"""Time design variants of the port's int8 decode kernel on one NVIDIA card.

    python3 scripts/torch_int8_variants.py [--variants committed stages3 ...]

Each variant is the committed ``gemlite_tpu_torch/csrc/int8_decode.cu`` with a
few lines replaced (the text substitutions in ``VARIANTS``) and the wrapper's
split plan run with some of its constants set otherwise, built with the
package's nvcc flags into ``gemlite_tpu_torch/_build/variants/``. A checked variant
must equal ``int8_decode_plain`` bit for bit at every timed case; a timing
variant (``checked`` False) drops a phase of the kernel on purpose. Each case
is timed twice: with the L2 cache flushed by a 64 MiB write before each
launch (``chip_smoke.Timer``, which leaves the cache full of dirty lines that
are written back while the kernel reads), and by a 64 MiB read (clean lines).
``torch._int_mm`` at the same shape is timed both ways as the yardstick. One
JSON line per variant and case, then the card's name and power limit. A
substitution that no longer matches the source fails the script before
anything runs.
"""

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gemlite_tpu_torch.ops import build  # noqa: E402
from gemlite_tpu_torch.ops import int8_decode as mod  # noqa: E402

SOURCE = build.SRC_DIR / "int8_decode.cu"
OUT_DIR = build.BUILD_DIR / "variants"
# (N, K) x M for the A8W8 (i8_dense) layer, then a float-group layer
CASES = [(M, N, K) for N, K in ((14336, 4096), (4096, 4096), (4096, 14336), (1024, 4096))
         for M in (1, 8, 64)]
_MMA = "            sub_step<SK>(xt, bt, s, nt, wn0, lane, acc);\n"
_CONVERT = "        to_kmajor<KIND>(raw + (it % S) * RB, bt);\n"

# name: (substitutions, constants of ops/int8_decode set for the run, checked)
VARIANTS = {
    "committed": ([], {}, True),
    # the split plan without its cap on the last block's partials
    "uncapped_splits": ([], {"PARTIAL_WORDS": 1 << 30}, True),
    # a ring of at most 3 stages instead of 5
    "stages3": ([("constexpr int kMaxStages = 5;", "constexpr int kMaxStages = 3;")], {}, True),
    # two blocks per SM, 110 KB each (3-5 stages)
    "two_blocks": ([("constexpr int kSmemBudget = 74 * 1024;",
                     "constexpr int kSmemBudget = 110 * 1024;")], {"BLOCKS_PER_SM": 2}, True),
    # one block per SM with 220 KB: a 6-stage ring
    "one_block_6_stages": ([("constexpr int kSmemBudget = 74 * 1024;",
                             "constexpr int kSmemBudget = 220 * 1024;"),
                            ("constexpr int kMaxStages = 5;", "constexpr int kMaxStages = 6;")],
                           {"BLOCKS_PER_SM": 1}, True),
    # timing only: no mma (the copies and the K-major turn alone)
    "no_mma": ([(_MMA, "")], {}, False),
    # timing only: no K-major turn (the copies and the mma on stale tiles)
    "no_convert": ([(_CONVERT, "")], {}, False),
    # timing only: the copies alone
    "copies_only": ([(_MMA, ""), (_CONVERT, "")], {}, False),
}


def variant_source(src: str, subs) -> str:
    for old, new in subs:
        if src.count(old) != 1:
            raise SystemExit(f"substitution does not match the source once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build_variants(sources: dict) -> dict:
    """{name: the loaded gl_int8_decode}, one nvcc per variant, all at once."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cu, so = OUT_DIR / f"int8_{name}.cu", OUT_DIR / f"int8_{name}.so"
        cu.write_text(src)
        procs[name] = (subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.SRC_DIR),
                                         "-o", str(so), str(cu)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    fns = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        fn = ctypes.CDLL(str(so)).gl_int8_decode
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 15 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS))
    args = ap.parse_args()
    src = SOURCE.read_text()
    sources = {name: variant_source(src, VARIANTS[name][0]) for name in args.variants}
    if not torch.cuda.is_available():
        print("torch_int8_variants: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    from gemlite_tpu_torch.helper import A8W8_INT8_dynamic
    fns = build_variants(sources)
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def ms(fn, clean: bool, iters=20):
        for _ in range(3):
            fn()
        times = []
        for _ in range(iters):
            if clean:
                flush.sum()
            else:
                flush.zero_()
            torch.cuda._sleep(4_000_000)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    layers = {}
    for N, K in {(N, K) for _, N, K in CASES}:
        w = torch.randn((N, K), generator=gen, device="cuda") * 0.02
        layers[(N, K)] = A8W8_INT8_dynamic(device="cuda", dtype=torch.bfloat16).from_weights(w)
    lib = mod._lib
    saved = {k: getattr(mod, k) for _, consts, _ in VARIANTS.values() for k in consts}
    try:
        for name in args.variants:
            _, consts, checked = VARIANTS[name]
            mod._lib = lambda fn_name="gl_int8_decode", f=fns[name]: f
            for k, v in saved.items():
                setattr(mod, k, consts.get(k, v))
            for M, N, K in CASES:
                layer = layers[(N, K)]
                x = torch.randint(-128, 128, (M, K), generator=gen, device="cuda").to(torch.int8)
                sx = torch.rand((M, 1), generator=gen, device="cuda") * 2.0 ** -7 + 2.0 ** -8
                call = (x, layer.W_q, layer.scales, layer.zeros, sx, layer.meta)
                exact = None
                if checked:
                    exact = torch.equal(mod.int8_decode(*call), mod.int8_decode_plain(*call))
                    if not exact:
                        raise RuntimeError(f"{name} differs from the plain version at {(M, N, K)}")
                Mp = max(32, -(-M // 8) * 8)
                a = torch.randint(-128, 128, (Mp, K), generator=gen, device="cuda").to(torch.int8)
                b = layer.W_q.t().contiguous().t()
                print(json.dumps({
                    "variant": name, "M": M, "N": N, "K": K, "constants": consts,
                    "splits": mod.plan(M, N, K, 0).splits, "bit_exact": exact,
                    "ms_dirty_flush": ms(lambda: mod.int8_decode(*call), False),
                    "ms_clean_flush": ms(lambda: mod.int8_decode(*call), True),
                    "int_mm_dirty": ms(lambda: torch._int_mm(a, b), False),
                    "int_mm_clean": ms(lambda: torch._int_mm(a, b), True),
                    "bound_ms": (K * N + M * K + 2 * M * N + 4 * (M + N)) / 3.35e12 * 1e3}),
                    flush=True)
    finally:
        mod._lib = lib
        for k, v in saved.items():
            setattr(mod, k, v)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
