#!/usr/bin/env python3
# SPDX-License-Identifier: Apache-2.0
"""Time design variants of the port's causal flash kernel on one NVIDIA card.

    python3 scripts/torch_flash_variants.py [--seqs 1024 2048 8192]

Each variant is the committed ``gemlite_tpu_torch/csrc/flash_attention.cu``
with a few lines replaced (the text substitutions in ``VARIANTS``), built with
the package's nvcc flags into ``gemlite_tpu_torch/_build/variants/``. A
variant is first held to the plain version (max|a-b| / max|b| <= 5e-3 against
the float32 result, and the same bits on a second call) at D 64 and 128 over
full, half-tile and GQA shapes; ``no_softmax`` skips that, since it drops the
softmax on purpose to time the products and the pipeline alone. Then each
variant is timed against one ``scaled_dot_product_attention`` call at B 1,
32/8 heads, D 128 and each S of ``--seqs`` (median of 20 launches, the L2
cache flushed before each, twice). One JSON line per variant and S, then the
card's name and power limit. A substitution that no longer matches the
source fails the script before anything runs.
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

from gemlite_tpu_torch.ops import attention, build  # noqa: E402

REL_TOL = 5e-3
SOURCE = build.SRC_DIR / "flash_attention.cu"
OUT_DIR = build.BUILD_DIR / "variants"

_EXP_LOOP = '''            s[4 * j + e] = ex2(fmaf(s[4 * j + e], sl2, -ms[e >> 1]));
            s[4 * j + e + 1] = ex2(fmaf(s[4 * j + e + 1], sl2, -ms[e >> 1]));'''
_QK0 = '''    full(kKFull, 0);                              // tile 0: Q Kᵀ alone
    pin(s);
    wgmma_fence();
    issue_qk<D>(s, dq, dk(0));
    wgmma_commit();
'''
_LOOP_ISSUE = '''        issue_pv<D>(o, hi, dv(kt - 1));
        issue_pv<D>(o, lo, dv(kt - 1));
        wgmma_commit();
'''
_TAIL_ISSUE = '''    issue_pv<D>(o, hi, dv(n_kt - 1));
    issue_pv<D>(o, lo, dv(n_kt - 1));
    wgmma_commit();
'''
_TURNS = '''__device__ __forceinline__ void turn_wait(int wg) {
    asm volatile("bar.sync %0, %1;\\n" ::"r"(1 + wg), "n"(kConsumers) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
    asm volatile("bar.arrive %0, %1;\\n" ::"r"(2 - wg), "n"(kConsumers) : "memory");
}

__device__ __forceinline__ uint32_t bar_addr'''

# name: (substitutions, checked against the plain version)
VARIANTS = {
    "committed": ([], True),
    # a two-stage K/V ring (160 KB at D 128) instead of three
    "two_stages": ([("constexpr int kStages = 3;", "constexpr int kStages = 2;")], True),
    # P rounded once to bf16, l summed over the rounded values, one P V product
    "p_rounded_once": ([
        (_EXP_LOOP, '''            const uint32_t w = pack_bf16(ex2(fmaf(s[4 * j + e], sl2, -ms[e >> 1])),
                                         ex2(fmaf(s[4 * j + e + 1], sl2, -ms[e >> 1])));
            s[4 * j + e] = __uint_as_float(w << 16);
            s[4 * j + e + 1] = __uint_as_float(w & 0xffff0000u);'''),
        ("        issue_pv<D>(o, lo, dv(kt - 1));\n", ""),
        ("    issue_pv<D>(o, lo, dv(n_kt - 1));\n", ""),
        ('''            lo[kk][i] = pack_bf16(a - __uint_as_float(hi[kk][i] << 16),
                                  b - __uint_as_float(hi[kk][i] & 0xffff0000u));''',
         "            lo[kk][i] = 0;"),
    ], True),
    # the two consumer warpgroups take turns issuing their products
    # (named barriers 1 and 2), warpgroup 0 first
    "turns": ([
        ("__device__ __forceinline__ uint32_t bar_addr", _TURNS),
        (_QK0, "    if (wg == 1) turn_pass(wg);\n" + _QK0.replace(
            "    pin(s);\n", "    turn_wait(wg);\n    pin(s);\n", 1) + "    turn_pass(wg);\n"),
        ("        full(kVFull, kt - 1);\n", "        full(kVFull, kt - 1);\n        turn_wait(wg);\n"),
        (_LOOP_ISSUE, _LOOP_ISSUE + "        turn_pass(wg);\n"),
        ("    full(kVFull, n_kt - 1);                       // P V of the diagonal tile\n",
         "    full(kVFull, n_kt - 1);                       // P V of the diagonal tile\n"
         "    turn_wait(wg);\n"),
        (_TAIL_ISSUE, _TAIL_ISSUE + "    if (wg == 0) turn_pass(wg);\n"),
    ], True),
    # keep a stale row max unless the max grew by more than 2^8, and skip
    # O's rescale when neither of the thread's rows moved
    "lazy_rescale": ([
        ('''        alpha[r] = ex2((m[r] - mx[r]) * sl2);
        m[r] = mx[r];
        ms[r] = mx[r] * sl2;''', '''        if ((mx[r] - m[r]) * sl2 > 8.f) {
            alpha[r] = ex2((m[r] - mx[r]) * sl2);
            m[r] = mx[r];
        } else {
            alpha[r] = 1.f;
        }
        ms[r] = m[r] * sl2;'''),
        ("        rescale(o, alpha);\n",
         "        if (alpha[0] != 1.f || alpha[1] != 1.f) rescale(o, alpha);\n"),
    ], True),
    # timing only: the softmax leaves the scores as they are
    "no_softmax": ([("                                             float sl2) {\n",
                     "                                             float sl2) {\n    return;\n")],
                   False),
}


def variant_source(src: str, subs) -> str:
    for old, new in subs:
        if src.count(old) != 1:
            raise SystemExit(f"substitution does not match the source once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build_variant(name: str, src: str):
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    cu, so = OUT_DIR / f"{name}.cu", OUT_DIR / f"{name}.so"
    cu.write_text(src)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{log}")
    fn = ctypes.CDLL(str(so)).gl_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    warnings = sum("C75" in line for line in log.splitlines())   # wgmma serialization notes
    spills = [line.strip() for line in log.splitlines() if "spill" in line and " 0 bytes spill" not in line]

    def run(q, k, v):
        out = torch.empty_like(q)
        build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), q.shape[0],
                       q.shape[1], q.shape[2], k.shape[2], q.shape[3],
                       torch.cuda.current_stream().cuda_stream), name)
        return out
    return run, warnings, spills


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seqs", type=int, nargs="+", default=[1024, 2048, 8192])
    args = ap.parse_args()
    src = SOURCE.read_text()
    sources = {name: variant_source(src, subs) for name, (subs, _) in VARIANTS.items()}
    if not torch.cuda.is_available():
        print("torch_flash_variants: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def bf16(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

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

    for name, (_, checked) in VARIANTS.items():
        run, warnings, spills = build_variant(name, sources[name])
        worst = None
        if checked:
            worst = 0.0
            for D in (64, 128):
                for B, S, Hq, Hkv in ((1, 256, 4, 2), (2, 2048, 2, 2), (1, 192, 4, 2),
                                      (2, 384, 8, 1)):
                    q, k, v = bf16((B, S, Hq, D)), bf16((B, S, Hkv, D)), bf16((B, S, Hkv, D))
                    got = run(q, k, v)
                    want = attention.causal_attention_plain(q.float(), k.float(), v.float())
                    err = float((got.float() - want).abs().max() / want.abs().max())
                    if not err <= REL_TOL or not torch.equal(run(q, k, v), got):
                        raise RuntimeError(f"{name} disagrees at {(B, S, Hq, Hkv, D)}: {err}")
                    worst = max(worst, err)
        for S in args.seqs:
            q, k, v = bf16((1, S, 32, 128)), bf16((1, S, 8, 128)), bf16((1, S, 8, 128))
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            print(json.dumps({
                "variant": name, "S": S, "ms": [ms(lambda: run(q, k, v)) for _ in range(2)],
                "sdpa_ms": ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)),
                "bound_ms": 2.0 * 32 * S * S * 128 / 989e12 * 1e3, "max_rel_err": worst,
                "ptxas_wgmma_notes": warnings, "spills": spills}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
