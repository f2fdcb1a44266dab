#!/usr/bin/env python3
# SPDX-License-Identifier: Apache-2.0
"""The mode-4 W1/W2/W4 decode, stacked decode and prefill kernels of this
tree against an earlier tree's, on the card: bit for bit, and timed in
turns (earlier, current, current, earlier) in one process.

    python3 scripts/torch_w4_parent_check.py --old-source DIR

``DIR`` holds the earlier tree's ``decode_gemv.cu``, ``prefill_gemm.cu``
and their headers (e.g. that tree's ``gemlite_tpu_torch/csrc`` unpacked by
``git archive`` under ``_archive/``); its entries ``gl_decode``,
``gl_decode_stacked`` and ``gl_prefill`` must take this tree's arguments.
Both trees run on this tree's plans (``ops/decode.plan``,
``ops/prefill.plan``), timed as ``chip_smoke.py`` times its kernels
(``Timer``: median of 20, L2 flushed, the host's enqueue hidden behind a
spin kernel). Prints one JSON line a case and a summary line; exits 1 when
any output differs.
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

SHAPES = ((4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336))    # (N, K)
DECODE_MS = (1, 8, 33, 64)
PREFILL_MS = (65, 128, 256, 1024, 2048)
LAYERS = 4


def build_old(src: Path):
    from gemlite_tpu_torch.ops import build
    out_dir = build.BUILD_DIR / "old_w4"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("decode_gemv", "prefill_gemm"):
        so = out_dir / f"{name}.so"
        procs[name] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(src), "-o", str(so),
             str(src / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"the earlier {name}.cu failed to build:\n{log[-4000:]}")
        libs[name] = ctypes.CDLL(str(so))
    for lib, fn, ptrs, ints in ((libs["decode_gemv"], "gl_decode", 7, 9),
                                (libs["decode_gemv"], "gl_decode_stacked", 8, 10),
                                (libs["prefill_gemm"], "gl_prefill", 7, 9)):
        getattr(lib, fn).argtypes = [ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints + [ctypes.c_void_p]
        getattr(lib, fn).restype = ctypes.c_int
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-source", type=Path, required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from gemlite_tpu_torch.ops import build, decode, prefill, scan
    from chip_smoke import Timer, card_line, random_stack
    libs = build_old(args.old_source.resolve())
    ms = Timer().ms
    card = card_line()
    gen = torch.Generator(device="cuda").manual_seed(3)
    stream = torch.cuda.current_stream().cuda_stream
    cases, differ = 0, []
    shapes = [(4, N, K) for N, K in SHAPES] + [(b, 14336, 4096) for b in (2, 1)]
    for bits, N, K in shapes:
        W, S, Z, meta = random_stack(LAYERS, N, K, bits, gen)
        gs = meta.group_size
        idx = torch.tensor(LAYERS - 1, dtype=torch.int32, device="cuda")
        for M in DECODE_MS + PREFILL_MS:
            x = (torch.randn((M, K), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
            args_l = (W[1], S[1], Z[1])
            if M <= 64:
                p = decode.plan(M, N, K, gs, bits)

                def old():
                    part, cnt = decode.split_buffers(M, N, p, x.device, stream)
                    out = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
                    build.check(libs["decode_gemv"].gl_decode(
                        x.data_ptr(), *(t.data_ptr() for t in args_l), part, cnt, out.data_ptr(),
                        M, N, K, gs, bits, p.splits, p.k_per_split, p.stages, p.mrows, stream),
                        "old gl_decode")
                    return out

                def old_stacked():
                    part, cnt = decode.split_buffers(M, N, p, x.device, stream)
                    out = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
                    build.check(libs["decode_gemv"].gl_decode_stacked(
                        x.data_ptr(), W.data_ptr(), S.data_ptr(), Z.data_ptr(), idx.data_ptr(),
                        part, cnt, out.data_ptr(), LAYERS, M, N, K, gs, bits, p.splits,
                        p.k_per_split, p.stages, p.mrows, stream), "old gl_decode_stacked")
                    return out

                new = lambda: decode.decode_matmul(x, *args_l, meta)              # noqa: E731
                new_stacked = lambda: scan.decode_matmul_stacked(x, W, S, Z, meta, idx)  # noqa: E731
                pairs = [("decode", old, new), ("decode_stacked", old_stacked, new_stacked)]
            else:
                p = prefill.plan(M, N, K, gs, bits)

                def old():
                    part, cnt = prefill._split_buffers(M, N, p, x.device, stream)
                    out = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
                    build.check(libs["prefill_gemm"].gl_prefill(
                        x.data_ptr(), *(t.data_ptr() for t in args_l), part, cnt, out.data_ptr(),
                        M, N, K, gs, bits, p.bm, p.splits, p.k_per_split, p.stages, stream),
                        "old gl_prefill")
                    return out

                pairs = [("prefill", old, lambda: prefill.prefill_matmul(x, *args_l, meta))]
            for kernel, old_fn, new_fn in pairs:
                equal = bool(torch.equal(old_fn(), new_fn()))
                t = [ms(old_fn), ms(new_fn), ms(new_fn), ms(old_fn)]
                row = {"kernel": kernel, "bits": bits, "M": M, "N": N, "K": K, "equal": equal,
                       "old_ms": statistics.mean((t[0], t[3])),
                       "new_ms": statistics.mean((t[1], t[2])), "card": card}
                print(json.dumps(row), flush=True)
                cases += 1
                if not equal:
                    differ.append(row)
        del W, S, Z
    print(json.dumps({"cases": cases, "differ": len(differ), "card": card}), flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
