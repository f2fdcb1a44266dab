#!/usr/bin/env python3
# SPDX-License-Identifier: Apache-2.0
"""Time design variants of the port's paged decode kernel on one NVIDIA card.

    python3 scripts/torch_paged_variants.py [--variants committed two_blocks ...]

Each variant is the committed ``gemlite_tpu_torch/csrc/paged_attention.cu``
with a few lines replaced (the text substitutions in ``VARIANTS``), built with
the package's nvcc flags into ``gemlite_tpu_torch/_build/variants/``. A
checked variant must match the float32 plain version within 5e-3 (max|a-b| /
max|b|); a timing variant (``checked`` False) drops a phase on purpose. Each
is timed at the two rows of ``chip_smoke.py``'s kernels_attn phase (8 slots
of lengths 1-2047 with 16 pages each, and up to 8191 with 64; page 128, 32/8
heads, D 128; median of 20 launches, the L2 cache flushed by a 64 MiB write
before each), beside one scaled_dot_product_attention call over a padded
copy. One JSON line per variant and row, then the card's name and power
limit. A substitution that no longer matches the source fails the script
before anything runs.
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

from gemlite_tpu_torch.ops import attention as A  # noqa: E402
from gemlite_tpu_torch.ops import build  # noqa: E402

REL_TOL = 5e-3
SOURCE = build.SRC_DIR / "paged_attention.cu"
OUT_DIR = build.BUILD_DIR / "variants"
ROWS = (((1, 127, 128, 129, 500, 1000, 1500, 2047), 16),
        ((1, 1000, 2047, 3000, 4096, 5000, 6500, 8191), 64))
_WARP_T0 = "        const int t_warp = t_begin + it * kTok + warp * kWarpTok;   // the warp's first token\n"
_SOFTMAX = "        // online softmax per head over the warp's tokens, then P·V\n"

# name: (substitutions, checked)
VARIANTS = {
    "committed": ([], True),
    # no register cap (203 registers at D 128): two blocks share an SM
    "two_blocks": ([("__launch_bounds__(kThreads, 3) paged_decode_kernel",
                     "__launch_bounds__(kThreads) paged_decode_kernel")], True),
    # timing only: the copies and the scores (no values, softmax or P·V)
    "no_softmax_pv": ([(_SOFTMAX, "        __syncwarp();\n        continue;\n" + _SOFTMAX)], False),
    # timing only: the copies alone
    "copies_only": ([(_WARP_T0, _WARP_T0 + "        if (it >= 0) continue;\n")], False),
}


def variant_source(src: str, subs) -> str:
    for old, new in subs:
        if src.count(old) != 1:
            raise SystemExit(f"substitution does not match the source once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build_variants(sources: dict) -> dict:
    """{name: (the loaded gl_paged_decode, ptxas lines)}, one nvcc per variant."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cu, so = OUT_DIR / f"paged_{name}.cu", OUT_DIR / f"paged_{name}.so"
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
        fn = ctypes.CDLL(str(so)).gl_paged_decode
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = (fn, [ln.strip()[-60:] for ln in log.splitlines() if "registers" in ln])
    return fns


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS))
    args = ap.parse_args()
    src = SOURCE.read_text()
    sources = {name: variant_source(src, VARIANTS[name][0]) for name in args.variants}
    if not torch.cuda.is_available():
        print("torch_paged_variants: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    fns = build_variants(sources)
    gen = torch.Generator(device="cuda").manual_seed(6)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    Hq, Hkv, D, ps = 32, 8, 128, 128

    def ms(fn, iters=20):
        for _ in range(3):
            fn()
        times = []
        for _ in range(iters):
            flush.zero_()
            torch.cuda._sleep(4_000_000)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def bf16(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    lib = A._paged_lib
    try:
        for lengths_b, pps in ROWS:
            B = len(lengths_b)
            P = B * pps + 1
            k_pages, v_pages, q = bf16((Hkv, P, ps, D)), bf16((Hkv, P, ps, D)), bf16((B, Hq, D))
            table = ((torch.randperm(B * pps, generator=gen, device="cuda") + 1)
                     .reshape(B, pps).to(torch.int32))
            lengths = torch.tensor(lengths_b, dtype=torch.int32, device="cuda")
            want = A.paged_decode_attention_plain(q.float(), k_pages.float(), v_pages.float(),
                                                  lengths, table)
            T = max(lengths_b)
            kc, vc = (A.gather_pages(p, table)[:, :T].transpose(1, 2).contiguous()
                      for p in (k_pages, v_pages))
            mask = (torch.arange(T, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
            sdpa_ms = ms(lambda: sdpa(q[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True))
            live = sum(lengths_b)
            bound = (live * Hkv * D * 2 * 2 + 2 * B * Hq * D * 2) / 3.35e12 * 1e3
            for name in args.variants:
                fn, ptxas = fns[name]
                A._paged_lib = lambda f=fn: f
                err = None
                if VARIANTS[name][1]:
                    got = A.paged_decode_attention_kernel(q, k_pages, v_pages, lengths, table)
                    err = float((got.float() - want).abs().max() / want.abs().max())
                    if not err <= REL_TOL:
                        raise RuntimeError(f"{name} disagrees at pps {pps}: {err}")
                print(json.dumps({
                    "variant": name, "lengths": list(lengths_b), "pages_per_seq": pps,
                    "ms": [ms(lambda: A.paged_decode_attention_kernel(q, k_pages, v_pages,
                                                                      lengths, table))
                           for _ in range(2)],
                    "sdpa_ms": sdpa_ms, "bound_ms": bound, "max_rel_err": err,
                    "ptxas": ptxas}), flush=True)
            del k_pages, v_pages, kc, vc
            torch.cuda.empty_cache()
    finally:
        A._paged_lib = lib
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
