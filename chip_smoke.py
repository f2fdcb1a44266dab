#!/usr/bin/env python3
# SPDX-License-Identifier: Apache-2.0
"""Drive the PyTorch port (gemlite_tpu_torch) once on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  device   the card's name and power limit (nvidia-smi);
  build    compile the three CUDA kernels from gemlite_tpu_torch/csrc;
  kernels  each kernel against its plain PyTorch version at Llama-3-8B shapes:
           relative error max|a-b| / max|b| <= 5e-3 against the plain
           version's float32 result, median CUDA-event device times with the
           L2 cache flushed between launches, and the bound;
  layer    GemLiteLinear A16W4 gs=128 4096x4096 at M in {1, 64, 128, 4096},
           routed to decode, decode, prefill, dequantize;
  serve    Llama-3-8B widths cut to 4 of 32 layers, random bf16 weights from a
           seeded generator, quantized to W4 gs=128 on the card, served by
           ContinuousBatchingEngine(max_batch=8) on 8 greedy requests; tokens
           must equal a bare prefill/decode loop, and the first step must
           match the plain path on the CPU stage by stage (first_step_check);
  profile  device time by kernel over a short serving run.
Then a "kernels" line and, last, {"ok": true, "device": {...}}. Any failed
phase raises and the script exits non-zero without that last line. It needs
one CUDA card and refuses to run without one.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REL_TOL = 5e-3          # the bound the JAX kernel tests use
SHAPES = ((4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336))   # (N, K)
GROUP = 128
# published dense peaks: (HBM bytes/s, bf16 tensor-core flop/s)
PEAKS = {"H100 SXM": (3.35e12, 989e12), "H100 PCIe": (2.0e12, 756e12),
         "H200": (4.8e12, 989e12)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def peaks(name: str):
    if "H200" in name:
        return PEAKS["H200"]
    if "H100" in name:
        return PEAKS["H100 PCIe" if "PCIe" in name else "H100 SXM"]
    raise RuntimeError(f"no published peaks known for {name!r}")


class Timer:
    """Median CUDA-event time of fn on the device.

    A 64 MiB write before each launch leaves the 50 MB L2 cache cold, as a
    layer finds it when the other layers' weights have passed through. A spin
    kernel then holds the stream while the host enqueues fn, so that the
    events time the device work and not the host's launch overhead."""

    SPIN_CYCLES = 4_000_000      # about 2 ms at 1.98 GHz

    def __init__(self):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters: int = 20) -> float:
        for _ in range(3):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def with_f32_out(meta):
    """The layer meta with a float32 output: the plain version then returns its
    float32 accumulator, and a kernel's bf16 output is held against it (a bf16
    reference would add its own rounding, one bf16 step, to the error)."""
    from gemlite_tpu_torch import DType
    return meta._replace(output_dtype=DType.FP32.value)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def random_layer(N: int, K: int, gen: torch.Generator):
    """A16W4 gs=128 layer from random codes and HQQ-like bf16 metadata."""
    from gemlite_tpu_torch import DType, GemLiteLinear
    W_q = torch.randint(0, 16, (N, K), generator=gen, device="cuda", dtype=torch.uint8)
    G = N * K // GROUP
    scales = (torch.rand((G, 1), generator=gen, device="cuda") * 2e-3 + 1e-3).to(torch.bfloat16)
    zeros = torch.randint(0, 16, (G, 1), generator=gen, device="cuda").to(torch.bfloat16)
    return GemLiteLinear(4, GROUP, K, N, DType.BF16, DType.BF16, device="cuda").pack(
        W_q, scales, zeros)


def phase_build():
    from gemlite_tpu_torch.ops import build
    t0 = time.perf_counter()
    reports = build.build()
    seconds = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln] for name, log in reports.items()}
    emit({"phase": "build", "ok": True, "seconds": seconds, "sources": list(build.KERNEL_SOURCES),
          "compiled_now": sorted(reports), "ptxas": ptxas})


def kernel_bound(bytes_moved: float, flops: float, peak):
    bw, fl = peak
    t_bytes, t_ops = bytes_moved / bw * 1e3, flops / fl * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(card: str, peak, timer: Timer) -> dict:
    """Each kernel against its plain version; returns the rows at the shapes
    the kernels line reports."""
    from gemlite_tpu_torch.ops.decode import decode_matmul, decode_matmul_plain
    from gemlite_tpu_torch.ops.dequantize import dequantize_full, dequantize_weights
    from gemlite_tpu_torch.ops.prefill import prefill_matmul, prefill_matmul_plain

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for N, K in SHAPES:
        layer = random_layer(N, K, gen)
        meta, args = layer.meta, (layer.W_q, layer.scales, layer.zeros)
        w_bytes = K * N / 2 + 2 * 2 * (K // GROUP) * N
        dense_w = torch.randn((K, N), generator=gen, device="cuda").to(torch.bfloat16)
        cases = [("decode", M, decode_matmul, decode_matmul_plain) for M in (1, 8, 64)]
        cases += [("prefill", M, prefill_matmul, prefill_matmul_plain) for M in (128, 1024)]
        for name, M, kern, plain in cases:
            x = (torch.randn((M, K), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
            got, want = kern(x, *args, meta), plain(x, *args, with_f32_out(meta))
            torch.cuda.synchronize()
            err = rel_err(got, want)
            bound, by = kernel_bound(w_bytes + 2 * M * K + 2 * M * N, 2.0 * M * N * K, peak)
            row = {"kernel": name, "M": M, "N": N, "K": K, "rel_err": err,
                   "max_abs_err": max_abs(got, want),
                   "ms": timer.ms(lambda: kern(x, *args, meta)),
                   "plain_ms": timer.ms(lambda: plain(x, *args, meta), iters=5),
                   "dense_bf16_matmul_ms": timer.ms(lambda: torch.matmul(x, dense_w)),
                   "bound_ms": bound, "bound_by": by, "card": card}
            emit(row)
            if not err <= REL_TOL:
                raise RuntimeError(f"{name} kernel disagrees with its plain version: {row}")
            rows.append(row)
        del dense_w
        if (N, K) == (14336, 4096):
            got = dequantize_weights(*args, meta)
            want = dequantize_full(*args, meta)
            torch.cuda.synchronize()
            err = rel_err(got, want)
            bound, by = kernel_bound(w_bytes + 2 * K * N, 2.0 * K * N, peak)
            row = {"kernel": "dequantize", "M": 0, "N": N, "K": K, "rel_err": err,
                   "max_abs_err": max_abs(got, want),
                   "ms": timer.ms(lambda: dequantize_weights(*args, meta)),
                   "plain_ms": timer.ms(lambda: dequantize_full(*args, meta), iters=5),
                   "bound_ms": bound, "bound_by": by, "card": card}
            emit(row)
            if not err <= REL_TOL:
                raise RuntimeError(f"dequantize kernel disagrees with its plain version: {row}")
            rows.append(row)
    emit({"phase": "kernels", "ok": True, "checked": len(rows), "card": card})
    pick = {"decode": (8, 14336, 4096), "prefill": (128, 14336, 4096),
            "dequantize": (0, 14336, 4096)}
    return {r["kernel"]: r for r in rows if (r["M"], r["N"], r["K"]) == pick[r["kernel"]]}


def counters():
    from gemlite_tpu_torch.ops.decode import decode_matmul
    from gemlite_tpu_torch.ops.dequantize import dequantize_weights
    from gemlite_tpu_torch.ops.prefill import prefill_matmul
    return {"decode": decode_matmul, "prefill": prefill_matmul,
            "dequantize": dequantize_weights}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


def phase_layer(card: str) -> dict:
    """GemLiteLinear through all three routes; returns the launch counts."""
    from gemlite_tpu_torch.ops import dispatch
    from gemlite_tpu_torch.ops.dequantize import dequantize_full
    from gemlite_tpu_torch.ops.reference import forward_meta

    gen = torch.Generator(device="cuda").manual_seed(2)
    layer = random_layer(4096, 4096, gen)
    xs = {M: (torch.randn((M, 4096), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
          for M in (1, 64, 128, 4096)}
    reset_counts()
    dispatch.KERNEL_TRACE.clear()
    outs = {M: layer(x) for M, x in xs.items()}
    torch.cuda.synchronize()
    counts = read_counts()
    routes = list(dispatch.KERNEL_TRACE)
    if routes != ["decode", "decode", "prefill", "dequantize"]:
        raise RuntimeError(f"layer routes {routes}")
    errs = {}
    args = (layer.W_q, layer.scales, layer.zeros)
    for M, x in xs.items():
        if M >= 4096:
            want = torch.matmul(x.float(), dequantize_full(*args, layer.meta).float())
        else:
            want = forward_meta(x, *args, None, with_f32_out(layer.meta))
        errs[M] = rel_err(outs[M], want)
    ok = all(e <= REL_TOL for e in errs.values()) and min(counts.values()) >= 1
    emit({"phase": "layer", "ok": ok, "routes": routes, "rel_err": errs,
          "launches": counts, "card": card})
    if not ok:
        raise RuntimeError(f"layer phase failed: rel_err {errs}, launches {counts}")
    return counts


def _params_to_cpu(params):
    from gemlite_tpu_torch import GemLiteLinear

    def conv(node):
        if isinstance(node, GemLiteLinear):
            return GemLiteLinear.from_state_dict(
                {k: v.cpu() for k, v in node.state_dict().items()}, device="cpu")
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, list):
            return [conv(v) for v in node]
        return node.cpu()

    return conv(params)


def bare_loop(params, cfg, prompts, n_new, buckets, decode_buckets):
    """Greedy generation with the model API alone, in the engine's shapes:
    each prompt prefilled in its bucket into its own cache stripe, then all
    sequences decoded together. (A batch-1 loop would run the attention and
    lm_head matmuls at other shapes, where cuBLAS may sum in another order.)"""
    from gemlite_tpu_torch.models.llama import (init_kv_cache, llama_decode_step_batched,
                                                llama_forward)
    from gemlite_tpu_torch.serving import _next_bucket
    B = len(prompts)
    kv = init_kv_cache(cfg, B, device="cuda")
    out = []
    for i, p in enumerate(prompts):
        padded = torch.zeros((1, _next_bucket(len(p), buckets)), dtype=torch.int32, device="cuda")
        padded[0, :len(p)] = torch.tensor(p, dtype=torch.int32)
        logits, _ = llama_forward(params, cfg, padded, kv=kv[:, :, i:i + 1], cache_len=0)
        out.append([int(torch.argmax(logits[0, len(p) - 1]))])
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device="cuda")
    for _ in range(n_new - 1):
        t_act = _next_bucket(int(lens.max()) + 1, decode_buckets)
        tok = torch.tensor([[o[-1]] for o in out], dtype=torch.int32, device="cuda")
        logits, _ = llama_decode_step_batched(params, cfg, tok, kv, lens, t_active=t_act)
        nxt = torch.argmax(logits[:, 0].float(), dim=-1).cpu().tolist()
        for o, t in zip(out, nxt):
            o.append(int(t))
        lens = lens + 1
    return out


def _mean_max(a: torch.Tensor, b: torch.Tensor) -> dict:
    a, b = a.float().cpu(), b.float().cpu()
    return {"mean_rel": float((a - b).abs().mean() / b.abs().mean()),
            "max_rel": float((a - b).abs().max() / b.abs().max())}


def first_step_check(params, cfg, prompt) -> dict:
    """The first prefill step on the card's kernels against the plain path on
    the CPU, stage by stage from the same input: each block, then the final
    norm and lm_head, gets the CPU's output of the stage before. Each stage is
    held to mean|a-b| / mean|b| <= 5e-3, the form of the JAX kernel tests'
    bound (tests/test_decode_kernel.py:72): with bf16 outputs the two
    summation orders round some elements one bf16 step apart, which the max
    form would count as a relative error of up to 2^-7. The end-to-end logits
    of the two paths are reported beside: the random-weight network carries
    each stage's small difference on and magnifies it."""
    from gemlite_tpu_torch.models import llama as L
    from gemlite_tpu_torch.ops import dispatch

    cpu = _params_to_cpu(params)
    tok = torch.tensor([prompt], dtype=torch.int32)
    pos = torch.arange(len(prompt), dtype=torch.int32)[None]
    out = {}
    x = cpu["embed"][tok]
    dispatch.KERNEL_TRACE.clear()
    for i in range(cfg.num_layers):
        want = L._block_forward(cpu["blocks"][i], cfg, x, pos, None, i, 0)
        got = L._block_forward(params["blocks"][i], cfg, x.cuda(), pos.cuda(), None, i, 0)
        out[f"block{i}"] = _mean_max(got, want)
        x = want
    h = L._rms_norm(x, cpu["ln_f"], cfg.norm_eps)
    out["head"] = _mean_max(L._apply(params["lm_head"], h.cuda())[0, -1],
                            L._apply(cpu["lm_head"], h)[0, -1])
    routes = sorted(set(dispatch.KERNEL_TRACE))
    if routes != ["decode", "plain_decode"]:
        raise RuntimeError(f"first step ran {routes}")
    out["end_to_end"] = _mean_max(L.llama_forward(params, cfg, tok.cuda())[0, -1],
                                  L.llama_forward(cpu, cfg, tok)[0, -1])
    return out


def profile_serve(params, cfg, prompts, card: str):
    """Where the device time goes in a short serving run: kernel times from
    torch.profiler (CUDA activity only, so no operator is counted twice), and
    the device's busy share against the wall time of the same run made
    without the profiler."""
    from torch.profiler import ProfilerActivity, profile
    from gemlite_tpu_torch import ContinuousBatchingEngine

    def serve():
        eng = ContinuousBatchingEngine(params, cfg, max_batch=8, device="cuda")
        eng.generate(prompts, max_new_tokens=8)
        torch.cuda.synchronize()

    serve()
    t0 = time.perf_counter()
    serve()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        serve()
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count) for ev in prof.key_averages()
                   if ev.self_device_time_total > 0), reverse=True)
    total_ms = sum(r[0] for r in rows) / 1e3
    groups = {"decode_kernel": 0.0, "prefill_kernel": 0.0, "other": 0.0}
    for us, key, _ in rows:
        k = "decode_kernel" if ("decode_w4" in key or "splitk_reduce" in key) else \
            "prefill_kernel" if "prefill_w4" in key else "other"
        groups[k] += us / 1e3
    emit({"phase": "profile", "ok": True, "what": "8 requests x 8 new tokens, 4 of 32 layers",
          "wall_ms_unprofiled": wall_ms, "device_ms": total_ms,
          "device_busy_share": total_ms / wall_ms, "device_ms_by_group": groups,
          "top": [{"kernel": k[:90], "device_ms": us / 1e3, "calls": n} for us, k, n in rows[:12]],
          "card": card})


def phase_serve(card: str) -> dict:
    from gemlite_tpu_torch import (ContinuousBatchingEngine, LlamaConfig, Request, init_llama,
                                   quantize_llama)

    cfg = LlamaConfig.llama3_8b(num_layers=4, max_seq_len=512)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = quantize_llama(init_llama(cfg, generator=gen, device="cuda"),
                            W_nbits=4, group_size=128, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (17, 31, 48, 64, 80, 96, 112, 128)]
    n_new = 32

    eng = ContinuousBatchingEngine(params, cfg, max_batch=8, device="cuda")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in prompts:
        eng.submit(Request(prompt_tokens=p, max_new_tokens=n_new))
    results = eng.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = read_counts()
    stats = eng.stats()
    by_prompt = {tuple(r.prompt_tokens): r for r in results}
    got = [by_prompt[tuple(p)].output_tokens for p in prompts]

    # launches the path must make: 7 linears per layer per forward; prompts of
    # up to 64 tokens prefill on the decode kernel (buckets 32/64), the rest on
    # the prefill kernel (bucket 128); every decode step runs the decode kernel
    per_fwd = 7 * cfg.num_layers
    short = sum(len(p) <= 64 for p in prompts)
    expect = {"decode": per_fwd * (short + stats["decode_steps"]),
              "prefill": per_fwd * (len(prompts) - short), "dequantize": 0}

    want = bare_loop(params, cfg, prompts, n_new, eng.buckets, eng.decode_buckets)
    same = got == want

    first_step = first_step_check(params, cfg, prompts[0])
    first_ok = all(v["mean_rel"] <= REL_TOL for k, v in first_step.items() if k != "end_to_end")
    ok = same and counts == expect and first_ok
    ttft = [r.ttft_s for r in results]
    emit({"phase": "serve", "ok": ok, "model": "Llama-3-8B widths, 4 of 32 layers (depth cut)",
          "requests": len(prompts), "prompt_lens": [len(p) for p in prompts],
          "new_tokens": n_new, "setup_s": setup_s, "wall_s": wall_s,
          "tokens_out": stats["tokens_out"], "tokens_per_s_host_clock": stats["tokens_out"] / wall_s,
          "ttft_s": {"median": statistics.median(ttft), "max": max(ttft)},
          "stats_4_of_32_layers": stats, "launches": counts, "launches_expected": expect,
          "engine_equals_bare_loop": same, "first_step_kernel_vs_plain": first_step,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card})
    if not same:
        raise RuntimeError(f"engine tokens differ from the bare loop:\n{got}\n{want}")
    if counts != expect:
        raise RuntimeError(f"kernel launches {counts}, expected {expect}")
    if not first_ok:
        raise RuntimeError(f"first step: kernel path vs plain path {first_step}")
    profile_serve(params, cfg, prompts, card)
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import gemlite_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    card = card_line()
    name = torch.cuda.get_device_name(0)
    peak = peaks(name)
    emit({"phase": "device", "ok": True, "name": name, "nvidia_smi": card,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "peak_bytes_per_s": peak[0], "peak_bf16_flops": peak[1]})
    t_start = time.perf_counter()
    phase_build()
    timer = Timer()
    picked = phase_kernels(card, peak, timer)
    layer_counts = phase_layer(card)
    serve_counts = phase_serve(card)

    sources = {"decode": ("gemlite_tpu_torch/csrc/decode_gemv.cu",
                          "gemlite_tpu/ops/pallas_decode.py:619", serve_counts),
               "prefill": ("gemlite_tpu_torch/csrc/prefill_gemm.cu",
                           "gemlite_tpu/ops/pallas_prefill.py:570", serve_counts),
               "dequantize": ("gemlite_tpu_torch/csrc/dequantize.cu",
                              "gemlite_tpu/ops/pallas_prefill.py:353", layer_counts)}
    kernels = []
    for name_k, (src, replaces, counts) in sources.items():
        r = picked[name_k]
        kernels.append({"name": name_k, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": counts[name_k],
                        "launches_path": "serve" if counts is serve_counts else "layer",
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None,
                        "shape": {"M": r["M"], "N": r["N"], "K": r["K"]}})
    if any(k["launches"] < 1 for k in kernels):
        raise RuntimeError(f"a kernel of the path never launched: {kernels}")
    emit({"seconds": time.perf_counter() - t_start, "card": card})
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
