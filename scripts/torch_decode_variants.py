#!/usr/bin/env python3
# SPDX-License-Identifier: Apache-2.0
"""Time design variants of the port's W1/W2/W4 decode kernel on one NVIDIA card.

    python3 scripts/torch_decode_variants.py [--variants committed stages3 ...]

Each variant is the committed ``gemlite_tpu_torch/csrc/decode_gemv.cu`` with a
few lines replaced (the text substitutions in ``VARIANTS``) and the wrapper's
plan run with some of its constants set otherwise, built with the package's
nvcc flags into ``gemlite_tpu_torch/_build/variants/``. A checked variant must
equal the plain float32 result within 5e-3 at every case, and the committed
kernel bit for bit where its plan splits K as the committed plan does; a timing variant
(``checked`` False) drops a phase of the kernel on purpose. Each case is
timed twice: with the L2 cache flushed by a 64 MiB write before each launch
(``chip_smoke.Timer``, which leaves the cache full of dirty lines that are
written back while the kernel reads), and by a 64 MiB read (clean lines). One
JSON line per variant and case, then the card's name and power limit. A
substitution that no longer matches the source fails the script before
anything runs.

The TMA variant (``tma_words``) brings each stage's word rows with one bulk
copy a row (``cp.async.bulk`` on an mbarrier per stage, issued by one
thread) into rows padded by 8 words instead of swizzled; x and the metadata
stay on cp.async. It fills no zeros, so it is right only where every stage
is whole (the cases here: N a multiple of 128, K of 256).
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
from gemlite_tpu_torch.ops import decode as mod  # noqa: E402

SOURCE = build.SRC_DIR / "decode_gemv.cu"
OUT_DIR = build.BUILD_DIR / "variants"
GROUP = 128
CASES = [(4, M, N, K) for N, K in ((14336, 4096), (4096, 4096), (4096, 14336), (1024, 4096))
         for M in (1, 8, 64)] + [(bits, 8, 14336, 4096) for bits in (2, 1)]

_COMPUTE = "        compute_stage<NT, BITS>(p, smem + (it % S) * SB,"
_TILE = "constexpr int BN = 128; "
_BLOCKS = "constexpr int kMinBlocks = 4;"
_TMA = [
    ("constexpr int kSmemMax = 112 * 1024;     // the most shared memory a launch may take\n",
     "constexpr int kSmemMax = 112 * 1024;\n__shared__ uint64_t tma_bar[kMaxStages];\n"),
    ("__device__ __forceinline__ int w_idx(int r, int c) { return r * BN + (c ^ ((r & 3) << 3)); }",
     "__device__ __forceinline__ int w_idx(int r, int c) { return r * (BN + 8) + c; }"),
    ("return word_rows(bits) * BN * 4; }", "return word_rows(bits) * (BN + 8) * 4; }"),
    ("    if (p.wvec == 16) {\n", """    if (p.wvec == 16) {
        extern __shared__ __align__(128) unsigned char smem[];
        const int sidx = (int)((st - smem) / stage_bytes(BITS, NT, p.mrows));
        if (t == 0) {
            const int cols = min(BN, p.N - n0);
            const unsigned bar = smem_u32(&tma_bar[sidx]);
            asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\\n"
                         :: "r"(bar), "r"(rv * cols * 4) : "memory");
            for (int r = 0; r < rv; ++r)
                asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                             "[%0], [%1], %2, [%3];\\n"
                             :: "r"(smem_u32(ws + w_idx(r, 0))), "l"(wg + (size_t)r * p.N),
                                "r"(cols * 4), "r"(bar) : "memory");
        }
    } else if (false) {
"""),
    ("    for (int s = 0; s < S - 1; ++s) {\n", """    if (threadIdx.x == 0) {
        for (int s = 0; s < S; ++s)
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\\n" :: "r"(smem_u32(&tma_bar[s])));
        asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
    }
    __syncthreads();
    for (int s = 0; s < S - 1; ++s) {
"""),
    (_COMPUTE, """        asm volatile("{\\n.reg .pred P1;\\nLAB_WAIT:\\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\\n"
                     "@!P1 bra LAB_WAIT;\\n}\\n"
                     :: "r"(smem_u32(&tma_bar[it % S])), "r"((it / S) & 1) : "memory");
""" + _COMPUTE),
]

# name: (substitutions, constants of ops/decode set for the run, checked)
VARIANTS = {
    "committed": ([], {}, True),
    # rings of at most 2, 3 and 4 stages instead of 5
    "stages2": ([], {"MAX_STAGES": 2}, True),
    "stages3": ([], {"MAX_STAGES": 3}, True),
    "stages4": ([], {"MAX_STAGES": 4}, True),
    # 256-column tiles (8 warps, two blocks an SM, 112 KB of ring each)
    "tile256": ([(_TILE, "constexpr int BN = 256; "), (_BLOCKS, "constexpr int kMinBlocks = 2;")],
                {"TILE": 256, "SMEM_BUDGET": 112 * 1024}, True),
    # three blocks an SM with 72 KB of ring each, the K split for about two
    "three_blocks": ([(_BLOCKS, "constexpr int kMinBlocks = 3;")],
                     {"SMEM_BUDGET": 72 * 1024, "TARGET_BLOCKS": 2 * 132}, True),
    # two blocks an SM with 110 KB of ring each, the K split for about two
    "two_blocks": ([(_BLOCKS, "constexpr int kMinBlocks = 2;")],
                   {"SMEM_BUDGET": 110 * 1024, "TARGET_BLOCKS": 2 * 132}, True),
    # the word rows by TMA bulk copies on mbarriers
    "tma_words": (_TMA, {}, True),
    # timing only: no dequantization (raw 128 + q into the mma)
    "no_dequant": ([("const uint32_t w = fma_bf16x2(fma_bf16x2(v, s2[i][h], m2[i][h]), 0x3F803F80u,\n"
                     "                                                  z2[i][h]);",
                     "const uint32_t w = v;")], {}, False),
    # timing only: the prologue's stages and then compute alone (no refills)
    "compute_only": ([("        if (nxt < steps)\n            load_stage",
                       "        if (false)\n            load_stage")], {}, False),
    # timing only: the copies alone (no dequantization, no mma)
    "copies_only": ([(_COMPUTE, "        if (false) " + _COMPUTE.strip())], {}, False),
}


def variant_source(src: str, subs) -> str:
    for old, new in subs:
        if src.count(old) != 1:
            raise SystemExit(f"substitution does not match the source once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build_variants(sources: dict) -> dict:
    """{name: (gl_decode, ptxas report)}, one nvcc per variant, all at once."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cu, so = OUT_DIR / f"decode_{name}.cu", OUT_DIR / f"decode_{name}.so"
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
        fn = ctypes.CDLL(str(so)).gl_decode
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        spills = sorted({ln.strip() for ln in log.splitlines() if "spill" in ln and " 0 bytes spill" not in ln})
        out[name] = (fn, spills)
    return out


def random_layer(bits: int, N: int, K: int, gen):
    from gemlite_tpu_torch import DType, GemLiteLinear
    codes = torch.randint(0, 2 ** bits, (N, K), generator=gen, device="cuda", dtype=torch.uint8)
    G = N * K // GROUP
    scales = (torch.rand((G, 1), generator=gen, device="cuda") * 2e-3 + 1e-3).to(torch.bfloat16)
    zeros = torch.randint(0, 2 ** bits, (G, 1), generator=gen, device="cuda").to(torch.bfloat16)
    return GemLiteLinear(bits, GROUP, K, N, DType.BF16, DType.BF16, device="cuda").pack(
        codes, scales, zeros)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS))
    args = ap.parse_args()
    src = SOURCE.read_text()
    sources = {name: variant_source(src, VARIANTS[name][0]) for name in args.variants}
    if not torch.cuda.is_available():
        print("torch_decode_variants: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    from gemlite_tpu_torch import DType
    built = build_variants(sources)
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

    layers = {(bits, N, K): random_layer(bits, N, K, gen) for bits, _, N, K in CASES}
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
                got = mod.decode_matmul(*call)
                p = mod.plan(M, N, K, GROUP, bits)
                if name == "committed":
                    committed[(bits, M, N, K)] = (got, p.k_per_split)
                ref, ref_split = committed.get((bits, M, N, K), (None, None))
                # the same K split sums in the same order: the same bits
                same = bool(torch.equal(got, ref)) if ref_split == p.k_per_split else None
                want = mod.decode_matmul_plain(*call[:4], layer.meta._replace(
                    output_dtype=DType.FP32.value))
                err = float((got.float() - want).abs().max() / want.abs().max())
                if checked and (err > 5e-3 or same is False):
                    raise RuntimeError(f"{name} is wrong at {(bits, M, N, K)}: rel {err}, "
                                       f"equal to committed {same}")
                w_bytes = K * N * bits / 8 + 2 * 2 * (K // GROUP) * N
                print(json.dumps({
                    "variant": name, "bits": bits, "M": M, "N": N, "K": K, "constants":
                    {k: str(v) for k, v in consts.items()}, "plan": p._asdict(),
                    "spills": built[name][1], "checked": checked, "rel_err": err,
                    "equals_committed": same,
                    "ms_dirty_flush": ms(lambda: mod.decode_matmul(*call), False),
                    "ms_clean_flush": ms(lambda: mod.decode_matmul(*call), True),
                    "bound_ms": (w_bytes + 2 * M * K + 2 * M * N) / 3.35e12 * 1e3,
                    # yardstick: one PyTorch reduction reading the same words
                    "amax_words_ms": ms(lambda: torch.amax(layer.W_q), False)
                    if name == "committed" else None}), flush=True)
    finally:
        mod._lib = lib
        for k, v in saved.items():
            setattr(mod, k, v)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
