#!/usr/bin/env python3
# SPDX-License-Identifier: Apache-2.0
"""Wall time of ``quantize_llama`` on one NVIDIA card at Llama-3-8B widths:
dense bf16 blocks drawn on the card from a seeded generator, quantized as
W4 gs=128 (the default processor) and as W8 (channel-wise), one block at a
time.

    python3 scripts/torch_quant_timing.py [--tree DIR] [--layers N]

``--tree``: the root of the checkout whose ``gemlite_tpu_torch`` is timed
(default: this one). One block is quantized first to warm up, then each of
``--layers`` blocks is timed alone (``torch.cuda.synchronize()`` on both
sides). Prints one JSON line per configuration (seconds a block, each and
their median, and a SHA-256 of the packed bytes, equal between trees that
pack the same bytes), then the card's name and power limit. Needs a CUDA
card.
"""

import argparse
import dataclasses
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def packed_digest(torch, blocks) -> str:
    h = hashlib.sha256()
    for blk in blocks:
        for part in ("attn", "mlp"):
            for name in sorted(blk[part]):
                for k, v in sorted(blk[part][name].state_dict().items()):
                    if isinstance(v, torch.Tensor):
                        t = v.detach().cpu().contiguous()
                        h.update(k.encode())
                        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--layers", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_quant_timing: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import gemlite_tpu_torch as pkg
    cfg = pkg.LlamaConfig.llama3_8b(num_layers=1, max_seq_len=512)
    one = dataclasses.replace(cfg, vocab_size=8)
    gen = torch.Generator(device="cuda").manual_seed(0)
    dense = [{"blocks": pkg.init_llama(one, generator=gen, device="cuda")["blocks"]}
             for _ in range(args.layers + 1)]
    for label, kw in (("w4_gs128", {"W_nbits": 4, "group_size": 128}),
                      ("w8_channelwise", {"W_nbits": 8})):
        secs, blocks = [], []
        for i, d in enumerate(dense):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            q = pkg.quantize_llama(d, device="cuda", **kw)
            torch.cuda.synchronize()
            if i:                                  # block 0 warms up
                secs.append(time.perf_counter() - t0)
                blocks.append(q["blocks"][0])
        print(json.dumps({"tree": args.tree, "config": label, "layers": args.layers,
                          "s_per_block": secs, "median_s": statistics.median(secs),
                          "packed_sha256": packed_digest(torch, blocks)}), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
