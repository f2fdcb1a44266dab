#!/usr/bin/env python3
# SPDX-License-Identifier: Apache-2.0
"""Host-clock time of one decode step of the engine on one NVIDIA card:
Llama-3-8B at its published widths and 32 layers, W4 gs=128, random weights
drawn on the card from a seeded generator, 8 slots all decoding on the dense
cache, unrolled and with ``scan_layers=True``; eagerly and, where the engine
has graphs, captured.

    python3 scripts/torch_step_timing.py [--tree DIR] [--steps N]

``--tree``: the root of the checkout whose ``gemlite_tpu_torch`` is timed
(default: this one). An engine without the ``graphs`` option (a tree from
before the captured decode step) is timed eagerly only. Each step is timed
alone (``torch.cuda.synchronize()`` on both sides) after two warm-up steps.
Prints one JSON line per engine (median and quartiles of the step's wall
time in ms), then the card's name and power limit. Needs a CUDA card.
"""

import argparse
import dataclasses
import inspect
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

PROMPT_LENS = (17, 31, 48, 64, 80, 96, 112, 128)      # chip_smoke.py's serve prompts


def model(pkg, torch):
    """32 W4 blocks drawn and quantized one at a time, then the embedding
    and the head, as chip_smoke.full_depth_llama draws them."""
    cfg = pkg.LlamaConfig.llama3_8b(num_layers=32, max_seq_len=512)
    gen = torch.Generator(device="cuda").manual_seed(0)
    one = dataclasses.replace(cfg, num_layers=1, vocab_size=8)
    blocks = []
    for _ in range(cfg.num_layers):
        dense = {"blocks": pkg.init_llama(one, generator=gen, device="cuda")["blocks"]}
        blocks.append(pkg.quantize_llama(dense, W_nbits=4, group_size=128,
                                         device="cuda")["blocks"][0])
    params = pkg.init_llama(dataclasses.replace(cfg, num_layers=0), generator=gen, device="cuda")
    params["blocks"] = blocks
    return cfg, params


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--steps", type=int, default=24)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_step_timing: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import gemlite_tpu_torch as pkg
    from gemlite_tpu_torch.ops import build
    build.build(("decode_gemv", "prefill_gemm"))
    cfg, params = model(pkg, torch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in PROMPT_LENS]
    has_graphs = "graphs" in inspect.signature(pkg.ContinuousBatchingEngine).parameters
    for scan in (False, True):
        for graphs in ((False, True) if has_graphs else (None,)):
            kw = {} if graphs is None else {"graphs": graphs}
            eng = pkg.ContinuousBatchingEngine(params, cfg, max_batch=8, paged=False,
                                               scan_layers=scan, device="cuda", **kw)
            for p in prompts:
                eng.submit(pkg.Request(prompt_tokens=p, max_new_tokens=args.steps + 4))
            for _ in range(3):                     # admissions, the capture, warm-up
                eng.step()
            times = []
            for _ in range(args.steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.step()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            q = statistics.quantiles(times, n=4)
            print(json.dumps({"tree": args.tree, "scan_layers": scan,
                              "graphs": bool(getattr(eng, "graphs", False)),
                              "steps": args.steps, "median_ms": statistics.median(times),
                              "q1_ms": q[0], "q3_ms": q[2]}), flush=True)
            del eng
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
