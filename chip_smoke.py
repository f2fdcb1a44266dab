#!/usr/bin/env python3
# SPDX-License-Identifier: Apache-2.0
"""Drive the PyTorch port (gemlite_tpu_torch) once on one NVIDIA card.

    python3 chip_smoke.py [--old-mx-source DIR] [--old-fp8-source DIR] [--old-prefill-source DIR]

Phases, each printing one JSON line:
  device   the card's name and power limit (nvidia-smi);
  build    compile the eleven CUDA sources from gemlite_tpu_torch/csrc
           (decode_gemv.cu holds the per-layer and stacked decode, in mode 4
           and modes 1-3, prefill_modes.cu the persistent mode 1-3 prefill,
           fp8_gemm.cu the fp8 decode, stacked decode and prefill, mx_gemm.cu
           the MX decode, stacked decode, prefill and general entries), one
           nvcc each at once, prefill_modes.cu, fused_float.cu and
           int8_decode.cu in parts (ops/build.KERNEL_PARTS); the wall and
           each source's and part's seconds;
  kernels  each kernel against its plain PyTorch version at Llama-3-8B shapes
           (decode at M 1 / 8 / 64, prefill at M 128 / 1024 / 2048, and W2 /
           W1 prefill at M 128 on 14336x4096): relative error max|a-b| /
           max|b| <= 5e-3 against the plain version's float32 result, median
           CUDA-event device times with the L2 cache flushed between
           launches, and the bound; the decode and prefill kernels' plans and
           one device operation a call (the kernel nodes of a CUDA graph
           that captures the call); beside them a dense bf16 matmul and, as
           the library yardstick, torch._weight_int4pack_mm on the same W4
           layer (checked against the plain version within 5e-3);
  layer    GemLiteLinear A16W4 gs=128 4096x4096 at M in {1, 64, 128, 4096},
           routed to decode, decode, prefill, dequantize;
  serve    Llama-3-8B widths cut to 4 of 32 layers, random bf16 weights from a
           seeded generator, quantized to W4 gs=128 on the card, served by
           ContinuousBatchingEngine(max_batch=8, paged=False) on 8 greedy
           requests, its prefill and decode steps captured in CUDA graphs
           (the engine's default on the card); tokens must equal a bare
           prefill/decode loop, launches the schedule with every replay
           counted, every decode step and every prefill after the first of
           its bucket a replay, and the first step must match the plain path
           on the CPU stage by stage (first_step_check); the capture time
           (decode and prefill apart) and the graph pool's memory. Every
           serve phase below holds the same replay gates;
  profile  device time by kernel over a short serving run, captured and
           eager (profile_eager): cold (a fresh engine, its captures in the
           run) and warm (the same requests again on that engine, every step
           a replay): wall, device time, busy share and TTFT;
  serve_spec  speculative decoding on serve's W4 model, gamma 4, serve's 8
           requests, 32 new tokens: (1) a self-draft, greedy, dense: the
           first burst's verify step against its draft steps block by block
           (each block fed the verify path's input, mean form <= 5e-3), tau
           = 4 x the largest |draft - verify logit| at the same positions,
           every rejection at a near-tie (verify top-2 gap < tau); (2) a
           Llama-3.2-1B-width draft (2 of 16 layers, W4 gs 128), greedy, on
           the dense and the paged engines: captured = eager token for
           token, and against the plain captured engine equal or parted
           only where the plain path's top-2 gap is under tau; (3) a
           self-draft at temperature 0.8, two runs from one seed equal.
           Launches equal the schedule (gamma + 1 draft steps and one verify
           a burst), linears only on decode / prefill, no plain attention;
           acceptance, tokens a step, tokens/s beside the plain captured
           engine, captures and graph pool reported;
  kernels_attn  the causal flash kernel (B=1, S in {256, 1024, 2048, 4096,
           8192}, 32/8 heads, D=128; 8192 is Llama-3-8B's published context)
           and the paged decode kernel (8 slots of lengths 1 to 2047 with 16
           pages each, and 8 slots up to 8191 with 64 pages each; page size
           128, a shuffled table with the trash page) against their plain
           versions within 5e-3 (max form, float32 plain result, flash one
           kv-head group at a time), paged decode in one device operation a
           call; times, bounds and scaled_dot_product_attention as the
           yardstick; the kernels line reports flash at S 2048 and paged
           decode at lengths up to 2047;
  serve_paged   the same W4 model at max_seq_len 2048 served by the default
           engine (paged, prefix cache, captured decode step; page 128, 64
           pages, max_batch 8) on
           10 requests, two of which reuse a 640-token prefix: tokens of the
           first 8 equal a bare paged loop, 10 prefix-cache page hits, the
           cached requests' chunk matches a one-shot prefill stage by stage,
           launches equal the schedule, and the first step of the 300-token
           prompt (bucket 512, on the flash kernel) matches the plain path;
  profile_paged device time by kernel over a short paged serving run;
  kernels_a8   the int8 decode kernel (every weight form, its plan and one
           device operation a call) and the general
           fused kernel (int path over int8 weights at M 128 / 1024 on the
           four 8B shapes and over packed W2 / W4 / W1 codes at M 128 / 1024,
           with its plan and launches per call) against their plain
           versions: bit for bit where the sum is integer, else max|a-b| /
           max|b| <= 5e-3; times, bounds and torch._int_mm. Then the float
           path (csrc/fused_float.cu): A16W8 in-loop bf16 at M 1 / 8 / 64 /
           128 / 1024 on the four 8B shapes, the other float forms and W4 gs
           32 mode 4 at M 8 / 128 on 14336x4096, each within 5e-3 of its
           plain version in one device operation a call, beside a dense bf16
           matmul on the dequantized weight (the library yardstick) and, where
           the card's torch has one, torch._weight_int8pack_mm;
  layer_a8w8   A8W8_INT8_dynamic(bf16) 4096x4096 at M in {1, 64, 65, 128,
           4096}, routed to int8_exact, int8_exact, general_fused,
           general_fused, dense_fallback;
  serve_a8w8   the same 4-layer model quantized with A8W8_INT8_dynamic(bf16),
           served as in "serve": tokens equal the bare loop, the linears run
           only on int8_exact and general_fused, launches equal the schedule,
           and the first step matches the plain path on the CPU;
  profile_a8w8 device time by kernel over a short A8W8 serving run;
  serve_a16w8  the same 4-layer model quantized with A16W8_INT8(bf16) (int8
           weights, float32 channel scales in the K loop), served as in
           "serve": every linear on the general fused kernel's float path at
           every M, tokens equal the bare loop, launches equal the schedule,
           the first step matches the plain path on the CPU;
  profile_a16w8 device time by kernel over a short A16W8 serving run;
  kernels_fp8  the fp8 kernels (csrc/fp8_gemm.cu) against their plain
           version (ops/reference.forward_fp8_ref) within 5e-3: decode at M 1
           / 8 / 64 and prefill at M 128 / 256 / 1024 / 2048 on the four 8B
           shapes, for A8W8_FP8 (e4m3 x) and A16W8_FP8 (bf16 x); with
           --old-fp8-source DIR (an earlier tree's csrc) each decode and
           prefill row also times that tree's entry (old_ms), bit for bit
           equal to the current one where both take the same K split; the fp8
           dequantize on
           14336x4096, equal to dequantize_full bit for bit; the stacked
           decode over a 32-layer A16W8_FP8 stack at layers 0 / 17 / 31, each
           equal to the per-layer kernel bit for bit; the float path with fp8
           x (A8W4 gs 64) at M 8 / 128. Plans, one device operation a call,
           times, bounds, and torch._scaled_mm (row-wise scales) or a dense
           bf16 matmul as the yardstick;
  layer_fp8    A8W8_FP8_dynamic(bf16) 4096x4096 at M in {1, 64, 65, 128,
           4096}, routed to decode, decode, prefill, prefill, dequantize;
  serve_fp8    the 4-layer model quantized with A8W8_FP8_dynamic(bf16),
           served as in "serve": tokens equal the bare loop, the linears run
           only on the fp8 decode and prefill kernels, launches equal the
           schedule, the first step matches the plain path on the CPU;
  profile_fp8  device time by kernel over a short A8W8_FP8 serving run;
  kernels_modes  the decode and prefill kernels' mode 1-3 form
           (gl_decode_modes / gl_prefill_modes_persistent) on A8W4 and A8W2
           gs 64 (mode 3, csm 2, e4m3 x), A8W4 channel-wise with post_scale
           (mode 1, csm 3), channel-wise A16W4 (mode 3) and A16W158 (mode 1,
           scalar zero) at 14336x4096 and 4096x14336, decode at M 1 / 8 /
           64, prefill at M 128 / 1024 / 2048: within 5e-3 of the plain
           version (forward_f32_epilogue, float32 result), one device
           operation a call, the plan, times under a write and a read flush
           and bounds beside a dense bf16 matmul and, in the same call, row
           5f (the route these layers took before), the fp8 x conversion to
           bf16 and, with --old-prefill-source DIR (an earlier tree's csrc),
           that tree's gl_prefill_modes (parent_ms; equals_parent where
           neither cuts K); then the prefill at M 128 / 1024 / 2048 on a
           vocabulary head of 32001 x 4096 (A8W4 gs 64; N not a multiple of
           8, so prefill_gemm.cu's mode 1-3 instances, prefill_modes_ragged,
           run in place of the persistent kernel), checked and timed alike;
  kernels_dequantize_int  the dequantize kernel's integer form
           (gl_dequantize_int) on A8W4 / A8W2 gs 64, channel-wise A16W4
           (post_scale), A16W158, W2 gs 64 and W8 gs 128 (mode 4) at both
           shapes, equal to dequantize_full bit for bit, one device operation
           a call, times and bounds; the layer at M 4096 and 8192 (A8W4 gs
           64, W8 gs 128 on 14336x4096) routed dequantize, equal bit for bit
           to the route's plain version (dequantize_full, then the dense
           matmul and per-token scale of ops/dispatch._dense) and within
           5e-3 of the float32 product; dequantize plus the dense matmul
           timed beside row 5f;
  serve_a8w4   the 4-layer model quantized with A8W4_HQQ_INT_dynamic(bf16)
           gs 64, served as in "serve": tokens equal the bare loop, the
           linears run only on the mode 1-3 decode and prefill forms,
           launches equal the schedule, the first step matches the plain path
           on the CPU; profiled in profile_a8w4;
  serve_scan_cw  the 4-layer model quantized channel-wise (A16W4 with
           post_scale: W_group_mode 1, csm 1), served captured on the dense
           cache unrolled and with scan_layers=True: equal tokens and first
           two decode steps' logits, the scan run's decode steps on the
           stacked mode 1-3 entry (decode_modes_stacked), launches and routes
           as scheduled;
  kernels_mx   the MX kernels (csrc/mx_gemm.cu, the MX form of
           csrc/dequantize.cu) against their plain version
           (ops/reference.mx_forward_ref) within 5e-3: decode at M 1 / 8 / 64
           and prefill at M 128 / 1024 on the four 8B shapes (and M 256 / 2048
           on 14336x4096) for A16W4_MXFP, A16W8_MXFP (e4m3; e5m2 on
           14336x4096) and A8W8_MXFP_dynamic, NVFP4 on the prefill kernel at
           M 8 / 128; the csm-4 form (e4m3 codes and group scales in) at M
           128 / 256 / 1024 / 2048 for MXFP4 and NVFP4, equal bit for bit to
           the bf16 form fed fake_quant_activations; the MX dequantize
           on 14336x4096 equal to dequantize_full bit for bit; the stacked
           decode over a 32-layer A16W4_MXFP stack at layers 0 / 17 / 31,
           equal to the per-layer kernel bit for bit. Plans, one device
           operation a call, times, bounds and a dense bf16 matmul on the
           dequantized weight as the yardstick; the decode rows on
           14336x4096 are timed under a read flush of the L2 too
           ("read_flush_ms": no dirty line written back while they run);
  layer_mx     each of the six MX processors at 4096x4096, M in {1, 64, 65,
           128, 4096}, on the JAX router's routes (decode / prefill /
           prefill_mx_csm4 / dequantize);
           kernels_mx also holds the general MX entry (row 5-MX: fp4 layers
           off the JAX fold rule, on the ragged decode / prefill bodies as
           ops/mx.general_plan picks, the plan in each row) within 5e-3 at
           SmolLM2-360M's shapes (960x960, 320x960, 2560x960, 960x2560) and
           2880x2880, M 1 / 8 / 64 / 128 / 1024, for A16W4_MXFP,
           A8W4_MXFP_dynamic, A4W4_MXFP_dynamic (fake-quantized x) and
           A4W4_NVFP_dynamic; with --old-mx-source DIR (an earlier tree's
           csrc, e.g. the parent commit's) each decode, stacked, prefill,
           csm-4 and general row also times that tree's entry with the plan
           it took (old_ms; old_read_flush_ms beside read_flush_ms), bit for
           bit equal to the current one where both take the same rows and
           split;
  serve_mxfp4, serve_nvfp4  the 4-layer model quantized with A16W4_MXFP
           and A4W4_NVFP_dynamic, served as in "serve": tokens equal the bare
           loop, the linears run only on the MX routes, launches equal the
           schedule, the first step matches the plain path on the CPU; each
           profiled (profile_mxfp4, profile_nvfp4);
  serve_mx_unfolded  SmolLM2-360M's widths (hidden 960, intermediate 2560,
           15/5 heads of 64, vocab 49152) cut to 4 of 32 layers, random
           weights, A16W4_MXFP: every linear off the fold rule, so on the
           general MX entry (route general_fused) at every M; served as in
           "serve" and profiled (profile_mx_unfolded);
  kernels_scan the stacked decode kernel over stacks of 32 random layers: W4
           at the four 8B shapes, M in {1, 8, 64}, W4 at the fused shapes
           6144x4096 (wqkv) and 28672x4096 (gate_up), M = 8, and W2 / W1 (gs
           128) at 4096x4096 and 14336x4096, M = 8; layers 0, 17 and 31 each
           equal the
           per-layer decode kernel on that layer bit for bit and the plain
           version within 5e-3 (max form, float32 plain result); no host sync
           under torch.cuda.set_sync_debug_mode("error"); times and bounds
           (one layer's bytes), a dense bf16 matmul beside them,
           torch._weight_int4pack_mm on the timed layer at W4, the plan and
           one device operation a call, and the per-layer decode kernel at
           W1/W2; then the stacked mode 1-3 entry over 32-layer channel-wise
           A16W4 stacks (post_scale at 14336x4096 M 1 / 8 / 64 and 4096x14336
           M 8, mode 3 at 14336x4096 M 8), each checked layer equal to the
           per-layer mode 1-3 entry bit for bit and within 5e-3 of
           forward_f32_epilogue;
  serve_scan    Llama-3-8B at full widths and its full 32 layers, random
           weights drawn and quantized (W4 gs=128) one block at a time on the
           card, apart and fused (wqkv, gate_up), the serve phase's 8
           requests served on the dense cache seven ways: eager
           (graphs=False) and captured, each unrolled, scan_layers=True and
           fused with scan_layers=True, and fused unrolled eagerly. Tokens
           must be equal within the unfused runs and within the fused ones,
           and so must the logits of the first two decode steps (the graph's
           output on the captured runs: its eager first step, then its first
           replay); launches equal the schedule (the stacked kernel 7 or 4 x
           32 per decode step), routes only decode, prefill and
           decode_stacked. Whether the fused runs' tokens equal the unfused
           ones is reported: their K splits differ (ops/decode.plan depends
           on N), so their sums round apart. The warm TTFT of the 128-token
           prompt sent alone again to the eager and the captured unrolled
           engines (a replay there) beside its device time. Host-clock throughput, TTFT,
           capture time, graph pool, peak memory, and torch.profiler windows
           of 8 decode steps: eager unrolled and scan (profile_scan_unrolled,
           profile_scan_scan), captured scan, unrolled and fused scan
           (profile_scan_captured, _captured_unrolled, _captured_fused).
  checkpoint_8b (after serve_spec) serve's dense model exported by
           export_hf_llama as an HF checkpoint (two shards and an index) into
           a temporary directory (raises when the disk is short), imported by
           load_hf_llama bit for bit, quantized to W4 gs=128 into serve's
           bytes, saved and loaded by save_model / load_model with the bytes
           unchanged, and served on serve's 8 requests with serve's tokens;
           each file's size and each step's seconds;
  real_weights  the repo's trained checkpoint (checkpoints/tiny_en_5m: a
           byte-level Llama, 6 layers, hidden 256, 4/2 heads of 64) imported
           on the card, in thirteen configurations (dense bf16, A16W8, A8W8,
           W8, W4 gs 128 / 64, W2 gs 32, A16W8_FP8, A8W8_FP8,
           A8W4_HQQ_INT_dynamic gs 64, A16W4_MXFP, A8W8_MXFP_dynamic,
           A4W4_NVFP_dynamic): loss_fn's nll on PARITY.md's eval (256
           held-out windows of 512 bytes) in batches of 4 windows (M 2048),
           the first 16 as one batch (M 8192), and those 16 through the plain
           versions on the CPU: |card - CPU| <= 2e-3 nats/byte (1% relative
           for W2 gs 32), beside PARITY.md's JAX-package value, each model
           quantized on the card equal byte for byte to the CPU's; A8W4 gs 64
           also on its first 4 windows (M 2048, the mode 1-3 prefill form)
           against the CPU; W4 gs 128, A8W8, A16W8_FP8, A16W4_MXFP and A8W4
           gs 64 serve 8 held-out prompts (64-400 bytes, 32 greedy tokens)
           on the paged, dense and (W4, A16W8_FP8,
           A16W4_MXFP) scan engines, each equal to its bare loop; the W8 gs
           128 model with a W4 gs 128 draft, gamma 4, 96 greedy tokens, on
           the dense and paged speculative engines: tokens equal the plain
           engine's or part at a near-tie (its own tau, from one self-draft
           burst of the W8 model), acceptance and tokens a step beside the
           JAX package's record (SERVING.md section 7); every kernel of the
           kernels line launches but the general MX entry (no linear of the
           checkpoint is off the fold rule) and the stacked mode 1-3 entry
           (no configuration is channel-wise A16Wn: serve_scan_cw runs it);
  patch_model   an nn.Module tree of bf16 nn.Linears at an 8B block's seven
           shapes and an 8B lm_head, patched with A16W8_INT8,
           A8W8_INT8_dynamic and A8W8_FP8_dynamic: the lm_head skipped, each
           output at M 8 and 128 within 2e-2 (norm-relative; 5e-2 with fp8 x
           and w) of the float nn.Linear on the expected route,
           forward_manual equal to forward under every family name;
  warmup   warmup(A16W4_HQQ_INT) over the four 8B shapes at the buckets 1 to
           1024 on the decode and prefill kernels; later first calls build
           and load no library.
Then a "kernels" line and, last, {"ok": true, "device": {...}}. Any failed
phase raises and the script exits non-zero without that last line. It needs
one CUDA card and refuses to run without one.
"""

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REL_TOL = 5e-3          # the bound the JAX kernel tests use
SHAPES = ((4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336))   # (N, K)
GROUP = 128
# published dense peaks: (HBM bytes/s, bf16 tensor-core flop/s, int8 tensor-core op/s)
PEAKS = {"H100 SXM": (3.35e12, 989e12, 1979e12), "H100 PCIe": (2.0e12, 756e12, 1513e12),
         "H200": (4.8e12, 989e12, 1979e12)}


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also gets the seconds since the script
    started (``t_s``)."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T0}
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
    layer finds it when the other layers' weights have passed through
    (``flush="read"``: a 64 MiB read instead, which leaves clean lines, so
    that no dirty line is written back while fn runs). A spin kernel then
    holds the stream while the host enqueues fn, so that the events time the
    device work and not the host's launch overhead."""

    SPIN_CYCLES = 4_000_000      # about 2 ms at 1.98 GHz

    def __init__(self):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters: int = 20, flush: str = "write") -> float:
        for _ in range(3):
            fn()
        times = []
        words = self.flush.view(torch.int64)
        for _ in range(iters):
            if flush == "read":
                words.max()
            else:
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


def random_layer(N: int, K: int, gen: torch.Generator, bits: int = 4, gs: int = GROUP):
    """A16Wn layer in mode 4 (W4 gs=128 unless told) from random codes and
    HQQ-like bf16 metadata."""
    from gemlite_tpu_torch import DType, GemLiteLinear
    W_q = torch.randint(0, 2 ** bits, (N, K), generator=gen, device="cuda", dtype=torch.uint8)
    G = N * K // gs
    scales = (torch.rand((G, 1), generator=gen, device="cuda") * 2e-3 + 1e-3).to(torch.bfloat16)
    zeros = torch.randint(0, 2 ** bits, (G, 1), generator=gen, device="cuda").to(torch.bfloat16)
    return GemLiteLinear(bits, gs, K, N, DType.BF16, DType.BF16, device="cuda").pack(
        W_q, scales, zeros)


def int4pack_mm(W_q, scales, zeros, K: int):
    """torch._weight_int4pack_mm (tinygemm) on a mode-4 W4 layer: the library
    yardstick of the W4 kernels, timed here and used nowhere in the port.
    It computes (q - 8) * s + zero per group, so zero = z' + 8 s for HQQ's
    q * s + z' (z' = -z * s); zero rounds to bf16, the only change of
    function. Returns x -> (M, N) bf16."""
    from gemlite_tpu_torch.ops.reference import unpack_rows_ref
    q = unpack_rows_ref(W_q, 4, 8, K).t().to(torch.uint8)          # (N, K) codes
    packed = torch._convert_weight_to_int4pack((q[:, ::2] << 4 | q[:, 1::2]).contiguous(), 8)
    zero = (zeros.float() + 8 * scales.float()).to(torch.bfloat16)
    sz = torch.stack([scales, zero], -1).contiguous()             # (K / gs, N, 2)
    return lambda x: torch._weight_int4pack_mm(x, packed, GROUP, sz)


def phase_build():
    from gemlite_tpu_torch.ops import build
    t0 = time.perf_counter()
    per_source = {}
    reports = build.build(seconds=per_source)
    seconds = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln] for name, log in reports.items()}
    emit({"phase": "build", "ok": True, "seconds": seconds, "sources": list(build.KERNEL_SOURCES),
          "compiled_now": sorted(reports), "seconds_by_source": per_source, "ptxas": ptxas})


def kernel_bound(bytes_moved: float, flops: float, peak, ops_rate=None):
    """(ms, "bytes" | "operations"): the larger of bytes over the memory rate
    and operations over ``ops_rate`` (default: the bf16 tensor-core rate)."""
    bw, fl = peak[0], peak[1] if ops_rate is None else ops_rate
    t_bytes, t_ops = bytes_moved / bw * 1e3, flops / fl * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


PREFILL_MS = (128, 1024, 2048)       # 2048: the engine's largest prefill bucket
PREFILL_LOW_BITS_SHAPE = (14336, 4096)


def phase_kernels(card: str, peak, timer: Timer) -> dict:
    """Each kernel against its plain version; returns the rows at the shapes
    the kernels line reports."""
    from gemlite_tpu_torch.ops import decode, prefill
    from gemlite_tpu_torch.ops.dequantize import dequantize_full, dequantize_weights

    plans = {decode.decode_matmul: decode.plan, prefill.prefill_matmul: prefill.plan}
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for bits, N, K in [(4, N, K) for N, K in SHAPES] + [(b, *PREFILL_LOW_BITS_SHAPE) for b in (2, 1)]:
        layer = random_layer(N, K, gen, bits)
        meta, args = layer.meta, (layer.W_q, layer.scales, layer.zeros)
        w_bytes = K * N * bits / 8 + 2 * 2 * (K // GROUP) * N
        dense_w = torch.randn((K, N), generator=gen, device="cuda").to(torch.bfloat16)
        library = int4pack_mm(*args, K) if bits == 4 else None
        cases = [("prefill", M, prefill.prefill_matmul, prefill.prefill_matmul_plain)
                 for M in (PREFILL_MS if bits == 4 else (128,))]
        if bits == 4:
            cases = [("decode", M, decode.decode_matmul, decode.decode_matmul_plain)
                     for M in (1, 8, 64)] + cases
        for name, M, kern, plain in cases:
            x = (torch.randn((M, K), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
            got, want = kern(x, *args, meta), plain(x, *args, with_f32_out(meta))
            torch.cuda.synchronize()
            err = rel_err(got, want)
            bound, by = kernel_bound(w_bytes + 2 * M * K + 2 * M * N, 2.0 * M * N * K, peak)
            row = {"kernel": name, "bits": bits, "M": M, "N": N, "K": K, "rel_err": err,
                   "max_abs_err": max_abs(got, want),
                   "ms": timer.ms(lambda: kern(x, *args, meta)),
                   "plain_ms": timer.ms(lambda: plain(x, *args, meta), iters=5),
                   "dense_bf16_matmul_ms": timer.ms(lambda: torch.matmul(x, dense_w)),
                   "library_ms": timer.ms(lambda: library(x)) if library else None,
                   "library_rel_err": rel_err(library(x), want) if library else None,
                   "bound_ms": bound, "bound_by": by,
                   "plan": plans[kern](M, N, K, GROUP, bits)._asdict(),
                   "device_ops_per_call": device_ops_per_call(lambda: kern(x, *args, meta)),
                   "card": card}
            emit(row)
            if not err <= REL_TOL:
                raise RuntimeError(f"{name} kernel disagrees with its plain version: {row}")
            if not (row["library_rel_err"] or 0) <= REL_TOL:
                raise RuntimeError(f"{name}: the library call computes another function: {row}")
            if row["device_ops_per_call"] != 1:
                raise RuntimeError(f"{name}: one call took several device operations: {row}")
            rows.append(row)
        del dense_w, library
        if (bits, N, K) == (4, 14336, 4096):
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
    pick = {"decode": (4, 8, 14336, 4096), "prefill": (4, 128, 14336, 4096),
            "dequantize": (4, 0, 14336, 4096)}
    return {r["kernel"]: r for r in rows
            if (r.get("bits", 4), r["M"], r["N"], r["K"]) == pick[r["kernel"]]}


def counters():
    """Every wrapper that counts its launches, by name (the engine adds a
    captured step's counts at each replay)."""
    from gemlite_tpu_torch.graphs import COUNTED
    return COUNTED


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


class RouteLog:
    """The routes of the quantized linears and of attention noted while
    open (the wrappers' own traces are bounded and cleared by others)."""

    def __enter__(self):
        from gemlite_tpu_torch.ops import attention, dispatch
        self.linears, self.attention = set(), set()
        self._mods = (dispatch, attention)
        self._notes = (dispatch._note, attention._note)
        dispatch._note = lambda n: (self.linears.add(n), self._notes[0](n))
        attention._note = lambda n: (self.attention.add(n), self._notes[1](n))
        return self

    def __exit__(self, *exc):
        self._mods[0]._note, self._mods[1]._note = self._notes

    def report(self) -> dict:
        return {"linears": sorted(self.linears), "attention": sorted(self.attention)}


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
    ok = all(e <= REL_TOL for e in errs.values()) and \
        min(counts[k] for k in ("decode", "prefill", "dequantize_int")) >= 1
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


def first_step_check(params, cfg, prompt, route="decode", bucket=None) -> dict:
    """The first prefill step on the card's kernels against the plain path on
    the CPU, stage by stage from the same input: each block, then the final
    norm and lm_head, gets the CPU's output of the stage before. Each stage is
    held to mean|a-b| / mean|b| <= 5e-3, the form of the JAX kernel tests'
    bound (tests/test_decode_kernel.py:72): with bf16 outputs the two
    summation orders round some elements one bf16 step apart, which the max
    form would count as a relative error of up to 2^-7. The end-to-end logits
    of the two paths are reported beside: the random-weight network carries
    each stage's small difference on and magnifies it. With ``bucket`` the
    prompt is padded to the engine's bucket, and a bucket of 256 or more
    attends on the flash kernel (its plain version on the CPU)."""
    from gemlite_tpu_torch.models import llama as L
    from gemlite_tpu_torch.ops import attention, dispatch

    cpu = _params_to_cpu(params)
    S, last = bucket or len(prompt), len(prompt) - 1
    tok = torch.zeros((1, S), dtype=torch.int32)
    tok[0, :len(prompt)] = torch.tensor(prompt, dtype=torch.int32)
    pos = torch.arange(S, dtype=torch.int32)[None]
    out = {}
    x = cpu["embed"][tok]
    dispatch.KERNEL_TRACE.clear()
    attention.ATTENTION_TRACE.clear()
    for i in range(cfg.num_layers):
        want = L._block_forward(cpu["blocks"][i], cfg, x, pos, None, i, 0)
        got = L._block_forward(params["blocks"][i], cfg, x.cuda(), pos.cuda(), None, i, 0)
        out[f"block{i}"] = _mean_max(got, want)
        x = want
    h = L._rms_norm(x, cpu["ln_f"], cfg.norm_eps)
    out["head"] = _mean_max(L._apply(params["lm_head"], h.cuda())[0, last],
                            L._apply(cpu["lm_head"], h)[0, last])
    routes = sorted(set(dispatch.KERNEL_TRACE))
    if routes != sorted([route, f"plain_{route}"]):
        raise RuntimeError(f"first step ran {routes}")
    flash = L._can_use_flash(torch.empty((1, S, cfg.num_heads, cfg.head_dim), device="meta"))
    attn = sorted(set(attention.ATTENTION_TRACE))
    if attn != (["flash", "plain_flash"] if flash else ["xla"]):
        raise RuntimeError(f"first step attended by {attn}")
    out["end_to_end"] = _mean_max(L.llama_forward(params, cfg, tok.cuda())[0, last],
                                  L.llama_forward(cpu, cfg, tok)[0, last])
    return out


def linear_step_check(params, cfg, prompt, route) -> dict:
    """The first prefill step linear by linear: the plain path runs on the
    CPU, hooks record the input and output of each block linear, and the
    card's layer is fed that same input; each output is held to mean|a-b| /
    mean|b| <= 5e-3 (``first_step_check``'s form). This is the stage check
    of a model whose activations are micro-scaled to fp4 (csm 4): there a
    block-level check cannot hold, since the fake quantization of x is
    discontinuous and a random-weight block carries any difference into
    whole-step flips of codes and group scales (measured on the CPU with an
    A4W4 8B block: one bf16 ulp on 1% of the block's input moves its output
    by 16-22%, mean form). Fed the same input, a linear fake-quantizes it to
    the same codes on the card and on the CPU, so what is compared is the
    kernel against its plain version."""
    from gemlite_tpu_torch import GemLiteLinear
    from gemlite_tpu_torch.models import llama as L
    from gemlite_tpu_torch.ops import dispatch

    cpu = _params_to_cpu(params)
    records, hooks = [], []
    for i, blk in enumerate(cpu["blocks"]):
        for grp in ("attn", "mlp"):
            for name, lin in blk[grp].items():
                if isinstance(lin, GemLiteLinear):
                    hooks.append(lin.register_forward_hook(
                        lambda m, inp, out, key=(i, grp, name): records.append(
                            (key, inp[0].detach(), out.detach()))))
    tok = torch.tensor([prompt], dtype=torch.int32)
    dispatch.KERNEL_TRACE.clear()
    try:
        L.llama_forward(cpu, cfg, tok)
    finally:
        for h in hooks:
            h.remove()
    out = {}
    for (i, grp, name), x, want in records:
        out[f"block{i}.{name}"] = _mean_max(params["blocks"][i][grp][name](x.cuda()), want)
    routes = sorted(set(dispatch.KERNEL_TRACE))
    if routes != sorted([route, f"plain_{route}"]):
        raise RuntimeError(f"the linear stages ran {routes}")
    return out


W4_GROUPS = {"decode_kernel": ("decode_mma_kernel",), "prefill_kernel": ("prefill_wgmma",)}


def device_times(prof, groups) -> dict:
    """Device time of a profiler window: in all, by kernel group (a group
    takes the kernels whose names hold one of its substrings), and the top
    kernels. CUDA activity only, so no operator is counted twice."""
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count) for ev in prof.key_averages()
                   if ev.self_device_time_total > 0), reverse=True)
    by_group = {g: 0.0 for g in list(groups) + ["other"]}
    for us, key, _ in rows:
        g = next((g for g, subs in groups.items() if any(sub in key for sub in subs)), "other")
        by_group[g] += us / 1e3
    return {"device_ms": sum(r[0] for r in rows) / 1e3, "device_ms_by_group": by_group,
            "top": [{"kernel": k[:240], "device_ms": us / 1e3, "calls": n}
                    for us, k, n in rows[:12]]}


def profile_serve(params, cfg, prompts, card: str, phase="profile", groups=W4_GROUPS,
                  what="8 requests x 8 new tokens, 4 of 32 layers", engine_kw=None):
    """Where the device time goes in a short serving run: kernel times from
    torch.profiler (CUDA activity only, so no operator is counted twice), and
    the device's busy share against the wall time of the same run made
    without the profiler; with the prefill and decode steps captured
    (``phase``) and eager (``phase``_eager). Cold: a fresh engine, its
    captures inside the run (reported, and subtracted in
    ``wall_ms_less_capture``). Warm: the same requests a third time on the
    engine of the cold run (on the paged cache the second pass hits the
    prefix cache, and its remainders take chunk widths that the cold run
    did not): its wall, device time, busy share and TTFT. On the captured
    engine the warm pass captures nothing, and every prefill and decode
    step of the engine's life after the first of its key is a replay."""
    from torch.profiler import ProfilerActivity, profile
    from gemlite_tpu_torch import ContinuousBatchingEngine

    def engine(graphs):
        return ContinuousBatchingEngine(params, cfg, max_batch=8, device="cuda", graphs=graphs,
                                        **(engine_kw or {"paged": False}))

    def serve(eng):
        res = serve_requests(eng, prompts, 8)
        torch.cuda.synchronize()
        return [r.ttft_s * 1e3 for r in res]

    for graphs, name in ((True, phase), (False, f"{phase}_eager")):
        serve(engine(graphs))
        eng = engine(graphs)
        t0 = time.perf_counter()
        ttft = serve(eng)
        wall_ms = (time.perf_counter() - t0) * 1e3
        stats = eng.stats()
        serve(eng)
        before = eng.stats()
        t0 = time.perf_counter()
        warm_ttft_ms = serve(eng)
        warm_ms = (time.perf_counter() - t0) * 1e3
        new_captures = sum(eng.stats()[k] - before[k] for k in ("graph_captures",
                                                               "prefill_captures"))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            serve(eng)
        warm_times = device_times(prof, groups)
        end_stats = eng.stats()
        replays_ok = not graphs or (new_captures == 0 and captured_throughout(end_stats)
                                    and prefills_captured(end_stats))
        del eng
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            serve(engine(graphs))
        times = device_times(prof, groups)
        emit({"phase": name, "ok": replays_ok, "what": what, "graphs": graphs,
              "wall_ms_unprofiled": wall_ms, "device_busy_share": times["device_ms"] / wall_ms,
              "wall_ms_less_capture": wall_ms - (stats["capture_s"]
                                                 + stats["prefill_capture_s"]) * 1e3,
              **times, "decode_steps": stats["decode_steps"],
              "ttft_ms": {"median": statistics.median(ttft), "max": max(ttft)},
              "graphs_report": graph_report(stats),
              "warm": {"wall_ms_unprofiled": warm_ms, "device_ms": warm_times["device_ms"],
                       "device_busy_share": warm_times["device_ms"] / warm_ms,
                       "wall_over_device": warm_ms / warm_times["device_ms"],
                       "ttft_ms": {"median": statistics.median(warm_ttft_ms),
                                   "max": max(warm_ttft_ms)},
                       "device_ms_by_group": warm_times["device_ms_by_group"],
                       "top": warm_times["top"], "captures_in_pass": new_captures},
              "card": card})
        if not replays_ok:
            raise RuntimeError(f"{name}: a prefill or decode step of a key seen before was "
                               f"not a replay: {graph_report(end_stats)}")


SERVE_PROMPT_LENS = (17, 31, 48, 64, 80, 96, 112, 128)


KERNEL_OF = {"decode": "decode", "prefill": "prefill", "int8_exact": "int8_decode",
             "general_fused": "fused_gemm"}


def captured_throughout(stats: dict) -> bool:
    """True when every decode step but the first of each graph was a replay."""
    return (stats["graph_captures"] >= 1
            and stats["graph_replays"] == stats["decode_steps"] - stats["graph_captures"])


def prefills_captured(stats: dict) -> bool:
    """True when every prefill and prompt chunk but the first of each key
    (one-shot bucket or chunk width) was a replay of that key's graph."""
    return (stats["prefill_captures"] >= 1
            and stats["prefill_replays"] == (stats["prefills"] + stats["prefill_chunks"]
                                             - stats["prefill_captures"]))


def graph_report(stats: dict) -> dict:
    """The engine's captures: the decode steps' and bursts' (how many, their
    time, replays), the prefill steps' apart, and the memory of the graph
    pool they share."""
    return {"captures": stats["graph_captures"], "capture_s": stats["capture_s"],
            "replays": stats["graph_replays"], "prefill_captures": stats["prefill_captures"],
            "prefill_capture_s": stats["prefill_capture_s"],
            "prefill_replays": stats["prefill_replays"],
            "pool_mb": stats.get("graph_pool_bytes", 0) / 2**20}


def prefill_capture_s(eng) -> dict:
    """Each prefill graph's capture seconds, by its key (one-shot bucket or
    chunk width)."""
    return {f"{kind} {width}": g.capture_s for (kind, width), g in eng._prefill_graphs.items()}


def serve_requests(eng, prompts, n_new: int) -> list:
    """Submit greedy requests and run the engine until they finish; returns
    their results in prompt order."""
    from gemlite_tpu_torch import Request
    reqs = [Request(prompt_tokens=p, max_new_tokens=n_new) for p in prompts]
    for r in reqs:
        eng.submit(r)
    by_id = {r.request_id: r for r in eng.run()}
    return [by_id[r.request_id] for r in reqs]


def warm_ttft(eng, prompt, groups, n: int = 5) -> dict:
    """TTFT of one prompt sent alone to an engine that has prefilled its
    bucket before (on a captured engine a replay): the host clock from
    submit to the first token (one token asked for), n times, and the
    device time of one more such request from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    before = eng.stats()["prefill_captures"]
    torch.cuda.synchronize()
    ttft = [serve_requests(eng, [prompt], 1)[0].ttft_s * 1e3 for _ in range(n)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        serve_requests(eng, [prompt], 1)
        torch.cuda.synchronize()
    device_ms = device_times(prof, groups)["device_ms"]
    med = statistics.median(ttft)
    return {"prompt_len": len(prompt), "ttft_ms_median": med, "ttft_ms": ttft,
            "device_ms": device_ms, "ttft_over_device": med / device_ms,
            "captures_in_pass": eng.stats()["prefill_captures"] - before}


def serve_and_check(phase: str, params, cfg, card: str, setup_s: float, short_route: str,
                    long_route: str, profile_phase: str, profile_groups,
                    kernel_of=KERNEL_OF, linear_stages: bool = False,
                    model: str = "Llama-3-8B widths, 4 of 32 layers (depth cut)") -> dict:
    """8 greedy requests through ContinuousBatchingEngine(max_batch=8) on the
    dense cache (paged=False). Tokens
    must equal the bare loop; launches must equal the schedule (prompts of up
    to 64 tokens and every decode step on ``short_route``'s kernel, longer
    prompts on ``long_route``'s; ``kernel_of`` names the launch count of each
    route); the quantized linears must take no other route; the first step
    must match the plain path on the CPU, block by block, or with
    ``linear_stages`` (micro-scaled activations) linear by linear
    (``linear_step_check``; the block-level numbers are then reported
    beside it)."""
    from gemlite_tpu_torch import ContinuousBatchingEngine, Request

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in SERVE_PROMPT_LENS]
    n_new = 32

    eng = ContinuousBatchingEngine(params, cfg, max_batch=8, paged=False, device="cuda")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with RouteLog() as log:
        for p in prompts:
            eng.submit(Request(prompt_tokens=p, max_new_tokens=n_new))
        results = eng.run()
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    routes_seen = log.linears
    counts = read_counts()
    stats = eng.stats()
    by_prompt = {tuple(r.prompt_tokens): r for r in results}
    got = [by_prompt[tuple(p)].output_tokens for p in prompts]

    # launches the path must make: 7 linears per layer per forward; prompts of
    # up to 64 tokens prefill at M <= 64 (buckets 32/64), the rest at M = 128
    # (bucket 128); every decode step runs at M = 8
    per_fwd = 7 * cfg.num_layers
    short = sum(len(p) <= 64 for p in prompts)
    expect = {k: 0 for k in counts}
    expect[kernel_of[short_route]] += per_fwd * (short + stats["decode_steps"])
    expect[kernel_of[long_route]] += per_fwd * (len(prompts) - short)
    routes_ok = routes_seen == {short_route, long_route}

    want = bare_loop(params, cfg, prompts, n_new, eng.buckets, eng.decode_buckets)
    same = got == want

    first_step = first_step_check(params, cfg, prompts[0], route=short_route)
    gated = linear_step_check(params, cfg, prompts[0], short_route) if linear_stages else first_step
    first_ok = all(v["mean_rel"] <= REL_TOL for k, v in gated.items() if k != "end_to_end")
    graphs_ok = captured_throughout(stats) and prefills_captured(stats)
    ok = same and counts == expect and first_ok and routes_ok and graphs_ok
    ttft = [r.ttft_s for r in results]
    emit({"phase": phase, "ok": ok, "model": model,
          "requests": len(prompts), "prompt_lens": [len(p) for p in prompts],
          "new_tokens": n_new, "setup_s": setup_s, "wall_s": wall_s,
          "tokens_out": stats["tokens_out"], "tokens_per_s_host_clock": stats["tokens_out"] / wall_s,
          "ttft_s": {"median": statistics.median(ttft), "max": max(ttft)},
          "stats_4_of_32_layers": stats, "graphs": graph_report(stats),
          "prefill_capture_s_by_key": prefill_capture_s(eng),
          "launches": counts, "launches_expected": expect, "routes": sorted(routes_seen),
          "engine_equals_bare_loop": same, "first_step_kernel_vs_plain": first_step,
          "first_step_gate": "linear by linear" if linear_stages else "block by block",
          **({"first_step_linears_kernel_vs_plain": gated} if linear_stages else {}),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card})
    if not same:
        raise RuntimeError(f"engine tokens differ from the bare loop:\n{got}\n{want}")
    if counts != expect:
        raise RuntimeError(f"kernel launches {counts}, expected {expect}")
    if not routes_ok:
        raise RuntimeError(f"quantized linears took routes {sorted(routes_seen)}")
    if not first_ok:
        raise RuntimeError(f"first step: kernel path vs plain path {gated}")
    if not graphs_ok:
        raise RuntimeError(f"the prefill and decode steps did not run on graphs: {stats}")
    profile_serve(params, cfg, prompts, card, phase=profile_phase, groups=profile_groups)
    return counts, got


def phase_serve(card: str, cfg, dense):
    """Returns the launch counts, the W4 params (serve_paged and
    checkpoint_8b reuse them) and the tokens served (checkpoint_8b's gate)."""
    from gemlite_tpu_torch import quantize_llama

    t0 = time.perf_counter()
    params = quantize_llama(dense, W_nbits=4, group_size=128, device="cuda")
    torch.cuda.synchronize()
    counts, tokens = serve_and_check("serve", params, cfg, card, time.perf_counter() - t0,
                                     "decode", "prefill", "profile", W4_GROUPS)
    return counts, params, tokens


def dense_llama():
    """Llama-3-8B widths cut to 4 of 32 layers, random bf16 weights from a
    seeded generator on the card; both serve phases quantize this one init."""
    from gemlite_tpu_torch import LlamaConfig, init_llama
    cfg = LlamaConfig.llama3_8b(num_layers=4, max_seq_len=512)
    gen = torch.Generator(device="cuda").manual_seed(0)
    return cfg, init_llama(cfg, generator=gen, device="cuda")


A8_GROUPS = {"int8_decode_kernel": ("int8_decode",),
             "fused_gemm_kernel": ("fused_gemm", "int_mma")}
INT8_FORMS = ("u8_scalar_zero", "u8_channel_zeros", "u8_group_zeros", "w4_group_zeros",
              "w2_bitnet_cw")
# packed codes on the general fused kernel's int path: BitNet's scalar-zero
# shift (W2, mode 1) and W4 / W1 codes without a zero (mode 0)
INT_PATH_PACKED_FORMS = ("w2_bitnet_cw", "w4_cw_mode0", "w1_cw_mode0")
# the general fused kernel's float path: A16W8 as the processor makes it
# (in-loop bf16) at every M on the 8B shapes, the other forms at M 8 / 128
FLOAT_MAIN = "a16w8_in_loop_bf16"
FLOAT_MAIN_MS = (1, 8, 64, 128, 1024)
FLOAT_FORMS = ("a16w8_post_scale_bf16", "w4_mode3_bf16", "bitnet_w2_bf16", "a16w8_in_loop_fp16",
               "w4_gs32_mode4_bf16")
FLOAT_FORM_MS = (8, 128)


def a8w8_layer(N: int, K: int, gen: torch.Generator):
    from gemlite_tpu_torch.helper import A8W8_INT8_dynamic
    w = torch.randn((N, K), generator=gen, device="cuda") * 0.02
    return A8W8_INT8_dynamic(device="cuda", dtype=torch.bfloat16).from_weights(w)


def int8_form_layer(name: str, N: int, K: int, gen: torch.Generator):
    """An INT8-activation layer of one weight form of the int8 decode kernel."""
    from gemlite_tpu_torch import DType, GemLiteLinear
    from gemlite_tpu_torch.helper import A8W158_INT_dynamic
    if name == "w2_bitnet_cw":
        w = torch.randint(-1, 2, (N, K), generator=gen, device="cuda").float()
        return A8W158_INT_dynamic(device="cuda", dtype=torch.bfloat16).from_weights(w, 0.01)
    if name in ("w4_cw_mode0", "w1_cw_mode0"):
        bits = 4 if name == "w4_cw_mode0" else 1
        codes = torch.randint(0, 2 ** bits, (N, K), generator=gen, device="cuda").to(torch.uint8)
        scales = torch.rand((N, 1), generator=gen, device="cuda") * 2.0 ** -9 + 2.0 ** -10
        return GemLiteLinear(bits, None, K, N, DType.INT8, DType.BF16, scaled_activations=True,
                             device="cuda").pack(codes, scales, None)
    nbits, gs, zk = {"u8_scalar_zero": (8, None, "scalar"), "u8_channel_zeros": (8, None, "channel"),
                     "u8_group_zeros": (8, GROUP, "group"), "w4_group_zeros": (4, GROUP, "group")}[name]
    codes = torch.randint(0, 2 ** nbits, (N, K), generator=gen, device="cuda").to(torch.uint8)
    G = 1 if gs is None else K // gs
    scales = torch.rand((N, G), generator=gen, device="cuda") * 2.0 ** -9 + 2.0 ** -10
    z = {"scalar": 128,
         "channel": torch.randint(0, 256, (N, 1), generator=gen, device="cuda").float(),
         "group": torch.randint(0, 2 ** nbits, (N, G), generator=gen, device="cuda").float()}[zk]
    return GemLiteLinear(nbits, gs, K, N, DType.INT8, DType.BF16, scaled_activations=True,
                         device="cuda").pack(codes, scales, z, fma_mode=False)


def float_form_layer(name: str, N: int, K: int, gen: torch.Generator):
    """A float-activation layer that the W4 kernels do not take."""
    from gemlite_tpu_torch.helper import A16W158_INT, A16W8_INT8
    w = torch.randn((N, K), generator=gen, device="cuda") * 0.02
    if name == "a16w8_in_loop_bf16":           # mode 2, float32 channel scales
        return A16W8_INT8(device="cuda", dtype=torch.bfloat16).from_weights(w)
    if name == "a16w8_post_scale_bf16":        # mode 0, csm 1
        return A16W8_INT8(device="cuda", dtype=torch.bfloat16, post_scale=True).from_weights(w)
    if name == "a16w8_in_loop_fp16":           # mode 2, fp16
        return A16W8_INT8(device="cuda", dtype=torch.float16).from_weights(w)
    if name == "bitnet_w2_bf16":               # W2, mode 1 with scalar zero 1, csm 1
        t = torch.randint(-1, 2, (N, K), generator=gen, device="cuda").float()
        return A16W158_INT(device="cuda", dtype=torch.bfloat16).from_weights(t, 0.01)
    from gemlite_tpu_torch import DType, GemLiteLinear   # W4 gs=128 mode 3 (fma_mode=False),
    gs = 32 if name == "w4_gs32_mode4_bf16" else GROUP    # or gs 32 mode 4
    W_q = torch.randint(0, 16, (N, K), generator=gen, device="cuda", dtype=torch.uint8)
    scales = (torch.rand((N * K // gs, 1), generator=gen, device="cuda") * 2e-3 + 1e-3)
    zeros = torch.randint(0, 16, (N * K // gs, 1), generator=gen, device="cuda").float()
    return GemLiteLinear(4, gs, K, N, DType.BF16, DType.BF16, device="cuda").pack(
        W_q, scales.to(torch.bfloat16), zeros.to(torch.bfloat16), fma_mode=gs != GROUP)


def layer_bytes(layer) -> int:
    return sum(t.numel() * t.element_size() for t in (layer.W_q, layer.scales, layer.zeros)
               if t is not None)


def int8_x(M: int, K: int, gen: torch.Generator):
    """int8 activation codes and their per-token scales."""
    x = torch.randint(-128, 128, (M, K), generator=gen, device="cuda").to(torch.int8)
    sx = torch.rand((M, 1), generator=gen, device="cuda") * 2.0 ** -7 + 2.0 ** -8
    return x, sx


def int_mm_ms(timer: Timer, M: int, N: int, K: int, w: torch.Tensor, gen) -> float:
    """torch._int_mm at the same shape, the library yardstick for the int rows.
    It needs more than 16 rows in multiples of 8, so M is padded to
    max(32, M rounded up to 8); it has no scale epilogue (csm 3)."""
    Mp = max(32, -(-M // 8) * 8)
    a = torch.randint(-128, 128, (Mp, K), generator=gen, device="cuda").to(torch.int8)
    b = w.t().contiguous().t()               # (K, N), column-major
    return timer.ms(lambda: torch._int_mm(a, b))


def device_ops_per_call(fn) -> int:
    """The device operations (kernel, memcpy and memset nodes) of one fn(),
    counted in a CUDA graph that captures it after a warm-up call
    (``build.graph_ops``)."""
    from gemlite_tpu_torch.ops import build
    return len(build.graph_ops(fn))


def phase_kernels_a8(card: str, peak, timer: Timer) -> dict:
    """The int8 decode kernel and the general fused kernel against their plain
    versions; returns the rows the kernels line reports."""
    from gemlite_tpu_torch.ops.fused import fused_gemm, fused_matmul_plain, int_path, int_plan
    from gemlite_tpu_torch.ops.int8_decode import form, int8_decode, int8_decode_plain, plan

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []

    def check(name, form_name, M, layer, kern, plain, args, exact, ops_rate, library=None):
        meta = layer.meta
        N, K = meta.out_features, meta.in_features
        got = kern(*args, meta)
        want = plain(*args, meta if exact else with_f32_out(meta))
        torch.cuda.synchronize()
        err = rel_err(got, want)
        x_bytes = args[0].numel() * args[0].element_size()
        bound, by = kernel_bound(layer_bytes(layer) + x_bytes + 4 * M + M * N * got.element_size(),
                                 2.0 * M * N * K, peak, ops_rate)
        row = {"kernel": name, "form": form_name, "M": M, "N": N, "K": K,
               "bit_exact": bool(torch.equal(got, want)) if exact else None, "rel_err": err,
               "max_abs_err": max_abs(got, want),
               "ms": timer.ms(lambda: kern(*args, meta)),
               "plain_ms": timer.ms(lambda: plain(*args, meta), iters=3),
               "bound_ms": bound, "bound_by": by, "library_ms": library, "card": card}
        if kern is fused_gemm and int_path(meta):
            row["int_plan"] = int_plan(M, N, K)._asdict()      # launches per call, split
        if kern is int8_decode:
            f = form(meta, layer.scales, layer.zeros)
            row["plan"] = plan(M, N, K, f.gs_loop, f.float_groups)._asdict()
            row["device_ops_per_call"] = device_ops_per_call(lambda: kern(*args, meta))
        emit(row)
        if (exact and not row["bit_exact"]) or not err <= REL_TOL:
            raise RuntimeError(f"{name} kernel disagrees with its plain version: {row}")
        if kern is int8_decode and row["device_ops_per_call"] != 1:
            raise RuntimeError(f"{name}: one call took several device operations: {row}")
        rows.append(row)

    for N, K in SHAPES:
        layer = a8w8_layer(N, K, gen)
        for name, Ms, kern, plain in (("int8_decode", (1, 8, 64), int8_decode, int8_decode_plain),
                                      ("fused_gemm", (128, 1024), fused_gemm, fused_matmul_plain)):
            for M in Ms:
                x, sx = int8_x(M, K, gen)
                check(name, "i8_dense", M, layer, kern, plain,
                      (x, layer.W_q, layer.scales, None, sx), True, peak[2],
                      int_mm_ms(timer, M, N, K, layer.W_q, gen))
        del layer
    N, K = 4096, 4096
    for name in INT8_FORMS:
        layer = int8_form_layer(name, N, K, gen)
        x, sx = int8_x(8, K, gen)
        exact = not form(layer.meta, layer.scales, layer.zeros).float_groups
        check("int8_decode", name, 8, layer, int8_decode, int8_decode_plain,
              (x, layer.W_q, layer.scales, layer.zeros, sx), exact, peak[2])
    N, K = 14336, 4096
    for name in INT_PATH_PACKED_FORMS:
        layer = int8_form_layer(name, N, K, gen)
        for M in (128, 1024):
            x, sx = int8_x(M, K, gen)
            check("fused_gemm", name, M, layer, fused_gemm, fused_matmul_plain,
                  (x, layer.W_q, layer.scales, layer.zeros, sx), True, peak[2])
    rows += float_rows(card, peak, timer, gen)
    emit({"phase": "kernels_a8", "ok": True, "checked": len(rows), "card": card})
    pick = {"int8_decode": ("i8_dense", 8, 14336, 4096), "fused_gemm": ("i8_dense", 128, 14336, 4096),
            "fused_gemm_float": (FLOAT_MAIN, 8, 14336, 4096)}
    return {r["kernel"]: r for r in rows
            if (r["form"], r["M"], r["N"], r["K"]) == pick[r["kernel"]]}


def int8pack_probe():
    """torch._weight_int8pack_mm on a small case: None where the card's torch
    has a CUDA kernel for it, else the error it raises."""
    x = torch.randn((8, 64), device="cuda").to(torch.bfloat16)
    w = torch.randint(-127, 128, (32, 64), device="cuda").to(torch.int8)
    try:
        torch._weight_int8pack_mm(x, w, torch.ones(32, device="cuda", dtype=torch.bfloat16))
        torch.cuda.synchronize()
        return None
    except (RuntimeError, NotImplementedError) as exc:
        return f"{type(exc).__name__}: {str(exc).splitlines()[0][:200]}"


def float_rows(card: str, peak, timer: Timer, gen) -> list:
    """The general fused kernel's float path against its plain version, one
    device operation a call, beside a dense bf16 matmul on the dequantized
    weight and, for the int8 forms where the card's torch has it,
    torch._weight_int8pack_mm (x @ q^T * s: the scale after the sum)."""
    from gemlite_tpu_torch.ops.dequantize import dequantize_full
    from gemlite_tpu_torch.ops.fused import float_plan, fused_gemm_float, fused_matmul_plain

    probe = int8pack_probe()
    emit({"probe": "torch._weight_int8pack_mm", "cuda_kernel": probe is None, "error": probe})
    cases = [(FLOAT_MAIN, M, N, K) for N, K in SHAPES for M in FLOAT_MAIN_MS]
    cases += [(name, M, 14336, 4096) for name in FLOAT_FORMS for M in FLOAT_FORM_MS]
    rows, layers = [], {}
    for name, M, N, K in cases:
        if (name, N, K) not in layers:
            layers.clear()
            torch.cuda.empty_cache()
            layer = float_form_layer(name, N, K, gen)
            dense = dequantize_full(layer.W_q, layer.scales, layer.zeros, layer.meta,
                                    torch.float16 if "fp16" in name else torch.bfloat16)
            int8pack = None
            if probe is None and layer.meta.elements_per_sample == 1:
                w_nk, s_n = layer.W_q.t().contiguous(), layer.scales.reshape(-1).to(dense.dtype)
                int8pack = (lambda x, w=w_nk, s=s_n: torch._weight_int8pack_mm(x, w, s))
            layers[(name, N, K)] = (layer, dense, int8pack)
        layer, dense, int8pack = layers[(name, N, K)]
        meta = layer.meta
        x = (torch.randn((M, K), generator=gen, device="cuda") * 0.5).to(dense.dtype)
        args = (x, layer.W_q, layer.scales, layer.zeros, None)
        got, want = fused_gemm_float(*args, meta), fused_matmul_plain(*args, with_f32_out(meta))
        torch.cuda.synchronize()
        err = rel_err(got, want)
        bound, by = kernel_bound(layer_bytes(layer) + 2 * M * K + 2 * M * N, 2.0 * M * N * K, peak)
        row = {"kernel": "fused_gemm_float", "form": name, "M": M, "N": N, "K": K,
               "rel_err": err, "max_abs_err": max_abs(got, want),
               "ms": timer.ms(lambda: fused_gemm_float(*args, meta)),
               "plain_ms": timer.ms(lambda: fused_matmul_plain(*args, meta), iters=3),
               "bound_ms": bound, "bound_by": by,
               "library_ms": timer.ms(lambda: torch.matmul(x, dense)),
               "library": "dense bf16 matmul on the dequantized weight",
               "int8pack_mm_ms": timer.ms(lambda: int8pack(x)) if int8pack else None,
               "int8pack_mm_rel_err": rel_err(int8pack(x), want) if int8pack else None,
               "plan": float_plan(M, N, K)._asdict(),
               "device_ops_per_call": device_ops_per_call(lambda: fused_gemm_float(*args, meta)),
               "card": card}
        emit(row)
        if not err <= REL_TOL:
            raise RuntimeError(f"float path disagrees with its plain version: {row}")
        if row["device_ops_per_call"] != 1:
            raise RuntimeError(f"float path: one call took several device operations: {row}")
        rows.append(row)
    layers.clear()
    return rows


def phase_layer_a8w8(card: str) -> dict:
    """An A8W8 GemLiteLinear through its routes; M <= 128 must equal the plain
    path on the CPU bit for bit, M = 4096 the float32 product within 5e-3."""
    from gemlite_tpu_torch import GemLiteLinear
    from gemlite_tpu_torch.ops import dispatch
    from gemlite_tpu_torch.quant import scale_activations_per_token

    gen = torch.Generator(device="cuda").manual_seed(4)
    layer = a8w8_layer(4096, 4096, gen)
    cpu_layer = GemLiteLinear.from_state_dict({k: v.cpu() for k, v in layer.state_dict().items()},
                                              device="cpu")
    xs = {M: (torch.randn((M, 4096), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
          for M in (1, 64, 65, 128, 4096)}
    reset_counts()
    dispatch.KERNEL_TRACE.clear()
    outs = {M: layer(x) for M, x in xs.items()}
    torch.cuda.synchronize()
    counts = read_counts()
    routes = list(dispatch.KERNEL_TRACE)
    want_routes = ["int8_exact", "int8_exact", "general_fused", "general_fused", "dense_fallback"]
    exact = {M: bool(torch.equal(outs[M].cpu(), cpu_layer(xs[M].cpu()))) for M in xs if M <= 128}
    xq, sx = scale_activations_per_token(xs[4096])
    ref = (xq.float() @ layer.W_q.float()) * sx * layer.scales.reshape(1, -1).float()
    err_4096 = rel_err(outs[4096], ref)
    ok = (routes == want_routes and all(exact.values()) and err_4096 <= REL_TOL
          and counts["int8_decode"] == 2 and counts["fused_gemm"] == 2)
    emit({"phase": "layer_a8w8", "ok": ok, "routes": routes, "bit_exact_vs_cpu": exact,
          "rel_err_4096": err_4096, "launches": counts, "card": card})
    if not ok:
        raise RuntimeError("layer_a8w8 phase failed")
    return counts


A16W8_GROUPS = {"fused_float_kernel": ("fused_float",)}


def phase_serve_a16w8(card: str, cfg, dense) -> dict:
    """The 4-layer model as A16W8 (int8 weights, channel scales in the K
    loop): every linear at every M on the float path."""
    from gemlite_tpu_torch import quantize_llama
    from gemlite_tpu_torch.helper import A16W8_INT8

    t0 = time.perf_counter()
    params = quantize_llama(dense, processor=A16W8_INT8(device="cuda", dtype=torch.bfloat16))
    torch.cuda.synchronize()
    return serve_and_check("serve_a16w8", params, cfg, card, time.perf_counter() - t0,
                           "general_fused", "general_fused", "profile_a16w8", A16W8_GROUPS,
                           kernel_of={"general_fused": "fused_gemm_float"})[0]


def phase_serve_a8w8(card: str, cfg, dense) -> dict:
    from gemlite_tpu_torch import quantize_llama
    from gemlite_tpu_torch.helper import A8W8_INT8_dynamic

    t0 = time.perf_counter()
    params = quantize_llama(dense, processor=A8W8_INT8_dynamic(device="cuda",
                                                               dtype=torch.bfloat16))
    torch.cuda.synchronize()
    return serve_and_check("serve_a8w8", params, cfg, card, time.perf_counter() - t0,
                           "int8_exact", "general_fused", "profile_a8w8", A8_GROUPS)[0]

FP8_GROUPS = {"fp8_decode_kernel": ("fp8_decode",), "fp8_prefill_kernel": ("fp8_prefill",)}
FP8_DECODE_MS = (1, 8, 64)
FP8_PREFILL_MS = (128, 256, 1024, 2048)
FP8_FLOAT_MS = (8, 128)              # row 5f with fp8 x (A8W4 gs 64)
FP8_SHAPE = (14336, 4096)            # the kernels line's fp8 rows


def fp8_layer(kind: str, N: int, K: int, gen: torch.Generator):
    """An fp8-coded layer: A8W8_FP8_dynamic (fp8 x, csm 3) or A16W8_FP8 (bf16
    x, mode 2), e4m3, from random weights quantized on the card."""
    from gemlite_tpu_torch.helper import A16W8_FP8, A8W8_FP8_dynamic
    w = torch.randn((N, K), generator=gen, device="cuda") * 0.02
    proc = A8W8_FP8_dynamic if kind == "a8w8_fp8" else A16W8_FP8
    return proc(device="cuda", dtype=torch.bfloat16).from_weights(w)


def fp8_inputs(layer, M: int, gen: torch.Generator):
    """(x as the fp8 kernels take it, per-token scales or None): bf16 x
    quantized per token to e4m3 for a scaled-activation layer."""
    from gemlite_tpu_torch.quant import scale_activations_per_token
    x = (torch.randn((M, layer.in_features), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
    if layer.scaled_activations:
        return scale_activations_per_token(x, torch.float8_e4m3fn)
    return x, None


def scaled_mm_call(layer, x, sx):
    """torch._scaled_mm with row-wise scales on an A8W8_FP8 layer: the
    library yardstick of the fp8 rows, timed here and used nowhere in the
    port. It takes M in multiples of 16, so x is padded (zero rows, unit
    scales) outside the timed call; returns (call, M)."""
    from gemlite_tpu_torch.ops.reference import unpack_rows_ref
    M, K = x.shape
    w = unpack_rows_ref(layer.W_q, 8, 4, K).t().contiguous().view(torch.float8_e4m3fn)   # (N, K)
    Mp = -(-M // 16) * 16
    xp = torch.zeros((Mp, K), dtype=x.dtype, device=x.device)
    xp[:M] = x
    sp = torch.ones((Mp, 1), dtype=torch.float32, device=x.device)
    sp[:M] = sx
    s_w = layer.scales.reshape(1, -1).float().contiguous()
    return lambda: torch._scaled_mm(xp, w.t(), scale_a=sp, scale_b=s_w, out_dtype=torch.bfloat16)


def fp8_bytes(layer, M: int) -> float:
    """What an fp8 call must move: the words, the column scales, x, the
    per-token scales and the bf16 output."""
    xb = 2 if layer.input_dtype.value == 2 else 1
    return layer_bytes(layer) + M * layer.in_features * xb + 4 * M + 2 * M * layer.out_features


def phase_kernels_fp8(card: str, peak, timer: Timer, old_fp8=None) -> dict:
    """The fp8 kernels against their plain versions (ops/reference.
    forward_fp8_ref, float32 result) within 5e-3, at the four 8B shapes:
    decode at M 1 / 8 / 64 and prefill at M 128 / 256 / 1024 / 2048 for
    A8W8_FP8 (fp8 x) and A16W8_FP8 (bf16 x); given ``old_fp8``
    (``start_old_fp8_build``), each decode and prefill row also times the
    earlier tree's entry on the same inputs (``old_ms``) and, where both take
    the same K split, requires its output bit for bit; the fp8 form of the
    dequantize kernel on
    14336x4096, equal to dequantize_full bit for bit; the stacked decode
    entry on a 32-layer A16W8_FP8 stack of 14336x4096 at layers 0 / 17 / 31,
    equal to the per-layer kernel bit for bit; row 5f with fp8 x (A8W4 gs
    64, 14336x4096) at M 8 / 128. Each in one device operation a call, with
    its plan, CUDA-event time, bound (bytes over 3.35 TB/s or 2 M N K over
    the fp8 rate for fp8 x, the bf16 rate for bf16 x) and yardstick:
    torch._scaled_mm with row-wise scales for A8W8_FP8, a dense bf16 matmul
    on the dequantized weight for the others. Returns the kernels line's
    rows."""
    from gemlite_tpu_torch.helper import A8W4_HQQ_INT_dynamic, _warmup_quantize
    from gemlite_tpu_torch.ops import fp8
    from gemlite_tpu_torch.ops.dequantize import dequantize_full, dequantize_weights
    from gemlite_tpu_torch.ops.fused import float_plan, fused_gemm_float, fused_matmul_plain
    from gemlite_tpu_torch.ops.reference import forward_fp8_ref
    from gemlite_tpu_torch.quant import scale_activations_per_token

    gen = torch.Generator(device="cuda").manual_seed(8)
    rows = []
    old = old_fp8() if old_fp8 is not None else None

    def record(row, got, want, exact=False):
        emit(row)
        if exact and not torch.equal(got, want):
            raise RuntimeError(f"{row['kernel']} differs from its reference bit for bit: {row}")
        if row.get("equals_old") is False:
            raise RuntimeError(f"{row['kernel']} differs from the earlier tree's entry on the "
                               f"same split: {row}")
        if not row["rel_err"] <= REL_TOL:
            raise RuntimeError(f"{row['kernel']} disagrees with its plain version: {row}")
        if row.get("device_ops_per_call", 1) != 1:
            raise RuntimeError(f"{row['kernel']}: one call took several device operations: {row}")
        rows.append(row)

    for kind in ("a8w8_fp8", "a16w8_fp8"):
        ops_rate = peak[2] if kind == "a8w8_fp8" else peak[1]
        for N, K in SHAPES:
            layer = fp8_layer(kind, N, K, gen)
            meta = layer.meta
            dense = dequantize_full(layer.W_q, layer.scales, None, meta)
            for name, Ms, kern, plan in (("fp8_decode", FP8_DECODE_MS, fp8.fp8_decode,
                                          fp8.decode_plan),
                                         ("fp8_prefill", FP8_PREFILL_MS, fp8.fp8_prefill,
                                          fp8.prefill_plan)):
                for M in Ms:
                    x, sx = fp8_inputs(layer, M, gen)
                    args = (x, layer.W_q, layer.scales, sx)
                    got = kern(*args, meta)
                    want = forward_fp8_ref(*args, with_f32_out(meta))
                    torch.cuda.synchronize()
                    if kind == "a8w8_fp8":
                        library = scaled_mm_call(layer, x, sx)
                        lib_name = "torch._scaled_mm, row-wise scales (M padded to 16)"
                        try:
                            lib_out = library()[:M]
                        except (RuntimeError, NotImplementedError) as exc:   # the card's torch
                            lib_name += f": {type(exc).__name__}: {str(exc)[:120]}"
                            library = lib_out = None
                    else:
                        library = lambda x=x: torch.matmul(x, dense)    # noqa: E731
                        lib_out = library()
                        lib_name = "dense bf16 matmul on the dequantized weight"
                    bound, by = kernel_bound(fp8_bytes(layer, M), 2.0 * M * N * K, peak, ops_rate)
                    row = {"kernel": name, "form": kind, "M": M, "N": N, "K": K,
                           "rel_err": rel_err(got, want), "max_abs_err": max_abs(got, want),
                           "ms": timer.ms(lambda: kern(*args, meta)),
                           "plain_ms": timer.ms(lambda: forward_fp8_ref(*args, meta), iters=3),
                           "bound_ms": bound, "bound_by": by,
                           "library_ms": timer.ms(library) if library else None,
                           "library": lib_name,
                           "library_rel_err": rel_err(lib_out, want) if library else None,
                           "plan": plan(M, N, K, 1 if kind == "a8w8_fp8" else 2)._asdict(),
                           "device_ops_per_call": device_ops_per_call(lambda: kern(*args, meta)),
                           "card": card}
                    if old is not None:
                        old_fn = getattr(old, name[4:])
                        old_out = old_fn(*args, meta)
                        xb = 1 if kind == "a8w8_fp8" else 2
                        row["old_plan"] = old_fp8_plan(name, M, N, K, xb)
                        row["old_rel_err"] = rel_err(old_out, want)
                        row["old_ms"] = timer.ms(lambda: old_fn(*args, meta))
                        p = plan(M, N, K, xb)
                        if (p.splits, p.k_per_split) == row["old_plan"][1:3]:
                            row["equals_old"] = bool(torch.equal(got, old_out))
                    record(row, got, want)
            if (N, K) == FP8_SHAPE and kind == "a8w8_fp8":
                got = dequantize_weights(layer.W_q, layer.scales, None, meta)
                want = dequantize_full(layer.W_q, layer.scales, None, meta)
                bound, by = kernel_bound(layer_bytes(layer) + 2 * K * N, 1.0 * K * N, peak)
                row = {"kernel": "dequantize_fp8", "form": kind, "M": 0, "N": N, "K": K,
                       "rel_err": rel_err(got, want), "max_abs_err": max_abs(got, want),
                       "ms": timer.ms(lambda: dequantize_weights(layer.W_q, layer.scales, None,
                                                                 meta)),
                       "plain_ms": timer.ms(lambda: dequantize_full(layer.W_q, layer.scales, None,
                                                                    meta), iters=3),
                       "bound_ms": bound, "bound_by": by, "library_ms": None,
                       "library": "none: no single PyTorch call converts the fp8 codes and "
                                  "folds the channel scale (the plain version takes several)",
                       "device_ops_per_call": device_ops_per_call(
                           lambda: dequantize_weights(layer.W_q, layer.scales, None, meta)),
                       "card": card}
                record(row, got, want, exact=True)
            del layer, dense

    # the stacked entry: a 32-layer A16W8_FP8 stack, every checked layer equal
    # to the per-layer kernel bit for bit
    N, K = FP8_SHAPE
    layers = [fp8_layer("a16w8_fp8", N, K, gen) for _ in range(SCAN_LAYERS)]
    meta = layers[0].meta
    W = torch.stack([lyr.W_q for lyr in layers])
    S = torch.stack([lyr.scales for lyr in layers])
    dense = dequantize_full(layers[SCAN_CHECKED[1]].W_q, layers[SCAN_CHECKED[1]].scales, None, meta)
    for M in FP8_DECODE_MS:
        x, _ = fp8_inputs(layers[0], M, gen)
        for li in SCAN_CHECKED:
            idx = torch.tensor(li, dtype=torch.int32, device="cuda")
            got = fp8.fp8_decode_stacked(x, W, S, meta, idx)
            per_layer = fp8.fp8_decode(x, layers[li].W_q, layers[li].scales, None, meta)
            want = forward_fp8_ref(x, layers[li].W_q, layers[li].scales, None, with_f32_out(meta))
            torch.cuda.synchronize()
            bound, by = kernel_bound(fp8_bytes(layers[li], M), 2.0 * M * N * K, peak)
            timed = li == SCAN_CHECKED[1]
            row = {"kernel": "fp8_decode_stacked", "form": "a16w8_fp8", "layer": li,
                   "layers": SCAN_LAYERS, "M": M, "N": N, "K": K,
                   "equals_per_layer": bool(torch.equal(got, per_layer)),
                   "rel_err": rel_err(got, want), "max_abs_err": max_abs(got, want),
                   "ms": timer.ms(lambda: fp8.fp8_decode_stacked(x, W, S, meta, idx)) if timed
                   else None,
                   "per_layer_ms": timer.ms(lambda: fp8.fp8_decode(
                       x, layers[li].W_q, layers[li].scales, None, meta)) if timed else None,
                   "plain_ms": timer.ms(lambda: forward_fp8_ref(
                       x, layers[li].W_q, layers[li].scales, None, meta), iters=3) if timed
                   else None,
                   "bound_ms": bound, "bound_by": by,
                   "library_ms": timer.ms(lambda: torch.matmul(x, dense)) if timed else None,
                   "library": "dense bf16 matmul on the layer's dequantized weight",
                   "plan": fp8.decode_plan(M, N, K, 2)._asdict(),
                   "device_ops_per_call": device_ops_per_call(
                       lambda: fp8.fp8_decode_stacked(x, W, S, meta, idx)),
                   "card": card}
            record(row, got, per_layer, exact=True)
    del layers, W, S, dense
    torch.cuda.empty_cache()

    # row 5f with fp8 x: A8W4 gs 64 (mode 3, bf16 scales and zeros, csm 2)
    w = torch.randn((N, K), generator=gen, device="cuda") * 0.02
    layer = _warmup_quantize(A8W4_HQQ_INT_dynamic(device="cuda", dtype=torch.bfloat16), w, 64)
    meta = layer.meta
    dense = dequantize_full(layer.W_q, layer.scales, layer.zeros, meta)
    del w
    for M in FP8_FLOAT_MS:
        xb = (torch.randn((M, K), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
        x, sx = scale_activations_per_token(xb, torch.float8_e4m3fn)
        args = (x, layer.W_q, layer.scales, layer.zeros, sx)
        got, want = fused_gemm_float(*args, meta), fused_matmul_plain(*args, with_f32_out(meta))
        xd = x.to(torch.bfloat16)
        torch.cuda.synchronize()
        bound, by = kernel_bound(layer_bytes(layer) + M * K + 4 * M + 2 * M * N, 2.0 * M * N * K,
                                 peak)
        row = {"kernel": "fused_gemm_float_fp8x", "form": "a8w4_gs64_fp8x", "M": M, "N": N,
               "K": K, "rel_err": rel_err(got, want), "max_abs_err": max_abs(got, want),
               "ms": timer.ms(lambda: fused_gemm_float(*args, meta)),
               "plain_ms": timer.ms(lambda: fused_matmul_plain(*args, meta), iters=3),
               "bound_ms": bound, "bound_by": by,
               "library_ms": timer.ms(lambda: torch.matmul(xd, dense)),
               "library": "dense bf16 matmul on the dequantized weight (x converted outside)",
               "plan": float_plan(M, N, K)._asdict(),
               "device_ops_per_call": device_ops_per_call(lambda: fused_gemm_float(*args, meta)),
               "card": card}
        record(row, got, want)
    del layer, dense
    torch.cuda.empty_cache()
    emit({"phase": "kernels_fp8", "ok": True, "checked": len(rows), "card": card})
    pick = {"fp8_decode": ("a8w8_fp8", 8), "fp8_prefill": ("a8w8_fp8", 128),
            "dequantize_fp8": ("a8w8_fp8", 0), "fp8_decode_stacked": ("a16w8_fp8", 8),
            "fused_gemm_float_fp8x": ("a8w4_gs64_fp8x", 8)}
    return {r["kernel"]: r for r in rows
            if (r["form"], r["M"]) == pick[r["kernel"]] and (r["N"], r["K"]) == FP8_SHAPE
            and r.get("layer", SCAN_CHECKED[1]) == SCAN_CHECKED[1]}


def phase_layer_fp8(card: str) -> dict:
    """An A8W8_FP8_dynamic(bf16) GemLiteLinear 4096x4096 through its routes:
    decode at M 1 / 64, prefill at M 65 / 128, the fp8 dequantize kernel
    then a dense bf16 matmul at M 4096; each within 5e-3 of its plain
    version (the fp8 forward below 4096; at 4096 the bf16 product with the
    plain folded weight, then the per-token scale in float32, rounded where
    ``ops/dispatch._dense`` rounds). Returns the launch counts."""
    from gemlite_tpu_torch.ops import dispatch
    from gemlite_tpu_torch.ops.dequantize import dequantize_full
    from gemlite_tpu_torch.ops.reference import forward_fp8_ref
    from gemlite_tpu_torch.quant import scale_activations_per_token

    gen = torch.Generator(device="cuda").manual_seed(9)
    layer = fp8_layer("a8w8_fp8", 4096, 4096, gen)
    xs = {M: (torch.randn((M, 4096), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
          for M in (1, 64, 65, 128, 4096)}
    reset_counts()
    dispatch.KERNEL_TRACE.clear()
    outs = {M: layer(x) for M, x in xs.items()}
    torch.cuda.synchronize()
    counts = read_counts()
    routes = list(dispatch.KERNEL_TRACE)
    errs = {}
    for M, x in xs.items():
        xq, sx = scale_activations_per_token(x, torch.float8_e4m3fn)
        if M >= 4096:
            w = dequantize_full(layer.W_q, layer.scales, None, layer.meta)
            want = torch.matmul(xq.to(torch.bfloat16), w).float() * sx
        else:
            want = forward_fp8_ref(xq, layer.W_q, layer.scales, sx, with_f32_out(layer.meta))
        errs[M] = rel_err(outs[M], want)
    ok = (routes == ["decode", "decode", "prefill", "prefill", "dequantize"]
          and all(e <= REL_TOL for e in errs.values())
          and (counts["fp8_decode"], counts["fp8_prefill"], counts["dequantize"]) == (2, 2, 1))
    emit({"phase": "layer_fp8", "ok": ok, "routes": routes, "rel_err": errs, "launches": counts,
          "card": card})
    if not ok:
        raise RuntimeError(f"layer_fp8 phase failed: routes {routes}, rel_err {errs}, "
                           f"launches {counts}")
    return counts


def phase_serve_fp8(card: str, cfg, dense) -> dict:
    """The 4-layer model quantized with A8W8_FP8_dynamic(bf16) (e4m3 weights,
    float32 channel scales, e4m3 activations per token) served as in
    "serve": every linear on the fp8 decode kernel up to M 64, on the fp8
    prefill kernel above."""
    from gemlite_tpu_torch import quantize_llama
    from gemlite_tpu_torch.helper import A8W8_FP8_dynamic

    t0 = time.perf_counter()
    params = quantize_llama(dense, processor=A8W8_FP8_dynamic(device="cuda",
                                                              dtype=torch.bfloat16))
    torch.cuda.synchronize()
    return serve_and_check("serve_fp8", params, cfg, card, time.perf_counter() - t0,
                           "decode", "prefill", "profile_fp8", FP8_GROUPS,
                           kernel_of={"decode": "fp8_decode", "prefill": "fp8_prefill"})[0]


MODES_GROUPS = {"decode_modes_kernel": ("decode_modes_kernel",),
                "prefill_modes_kernel": ("prefill_modes_kernel",),
                "copies (x to bf16 among them)": ("copy_kernel",)}
MODES_SHAPES = ((14336, 4096), (4096, 14336))
MODES_DECODE_MS = (1, 8, 64)
MODES_PREFILL_MS = (128, 1024, 2048)
MODES_FORMS = ("a8w4_gs64", "a8w2_gs64", "a8w4_cw_post", "a16w4_cw", "a16w158")
# a vocabulary head whose N is not a multiple of 8 (Llama-2's 32000 tokens and
# an added pad token, at Llama-2-7B's width): the mode 1-3 prefill's words and
# metadata are then out of TMA's reach, and prefill_modes_ragged runs
RAGGED_SHAPE = (32001, 4096)


def modes_layer(form: str, N: int, K: int, gen: torch.Generator):
    """A layer of the decode and prefill kernels' mode 1-3 form, from random
    weights quantized on the card: A8W4 / A8W2_HQQ_INT_dynamic gs 64 (mode 3,
    csm 2, e4m3 x), A8W4 channel-wise with post_scale (mode 1, csm 3),
    channel-wise A16W4 (mode 3, csm 0; with post_scale mode 1, csm 1) and
    A16W158_INT (W2, mode 1, scalar zero, float32 channel scale)."""
    from gemlite_tpu_torch.helper import (A16W158_INT, A16Wn, A8W2_HQQ_INT_dynamic,
                                          A8W4_HQQ_INT_dynamic)
    from gemlite_tpu_torch.quant import quantize_int_weights
    bf16 = torch.bfloat16
    if form == "a16w158":
        w = torch.randint(-1, 2, (N, K), generator=gen, device="cuda").float()
        return A16W158_INT(device="cuda", dtype=bf16).from_weights(w, 0.01)
    w = torch.randn((N, K), generator=gen, device="cuda") * 0.02
    bits, gs = (2, 64) if form == "a8w2_gs64" else (4, 64 if form == "a8w4_gs64" else K)
    W_q, s, z = quantize_int_weights(w, bits, gs)
    if form in ("a16w4_cw", "a16w4_cw_post"):
        return A16Wn(device="cuda", dtype=bf16, post_scale=form == "a16w4_cw_post").from_weights(
            W_q, s, z, bits, gs)
    proc = A8W2_HQQ_INT_dynamic if bits == 2 else A8W4_HQQ_INT_dynamic
    return proc(device="cuda", dtype=bf16, post_scale=form == "a8w4_cw_post").from_weights(
        W_q, s, z)


def start_old_prefill_build(src_dir: Path):
    """Start nvcc on an earlier tree's ``prefill_gemm.cu`` (``src_dir`` holds
    it and its headers, e.g. the parent commit's ``gemlite_tpu_torch/csrc``
    unpacked under ``_archive/``) into ``gemlite_tpu_torch/_build/old/``,
    beside the current build. Returns a function that waits for it and
    returns ``modes(x, W_q, scales, zeros, scales_x, meta)``: that tree's
    ``gl_prefill_modes`` on the mode-4 entry's plan (``ops/prefill.plan``),
    its split scratch apart from the current kernels'. The current mode 1-3
    prefill is timed against it in the same call."""
    import atexit
    import ctypes
    from gemlite_tpu_torch.ops import build
    out_dir = build.BUILD_DIR / "old"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "prefill_gemm_old.so"
    proc = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-I", str(src_dir), "-o", str(so),
                             str(src_dir / "prefill_gemm.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    atexit.register(proc.kill)

    def ready():
        from gemlite_tpu_torch.ops import prefill, w4
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"the earlier prefill_gemm.cu failed to build:\n{log[-4000:]}")
        fn = ctypes.CDLL(str(so)).gl_prefill_modes
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def modes(x, W_q, scales, zeros, scales_x, meta):
            M, N, K, gs = x.shape[0], meta.out_features, meta.in_features, meta.group_size
            s, z, zs, sx, cs = w4.modes_operands(W_q, scales, zeros, scales_x, meta, M)
            p = prefill.plan(M, N, K, gs, meta.W_nbits)
            stream = w4.stream()
            part = cnt = None
            floats, ints = prefill.workspace(M, N, p)
            if floats:
                cnt, part = build.split_state("prefill_gemm_old", x.device, ints, floats, stream)
            out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
            ptr = w4.pointer
            build.check(fn(x.data_ptr(), W_q.data_ptr(), ptr(s), ptr(z), ptr(zs), ptr(sx),
                           ptr(cs), ptr(part), ptr(cnt), out.data_ptr(), M, N, K, gs,
                           meta.W_nbits, p.bm, p.splits, p.k_per_split, p.stages,
                           meta.channel_scale_mode, w4.scale_code(cs), stream),
                        "prefill_gemm (earlier tree)")
            return out
        return modes
    return ready


def phase_kernels_modes(card: str, peak, timer: Timer, old_prefill=None) -> dict:
    """The decode and prefill kernels' mode 1-3 form (``gl_decode_modes`` /
    ``gl_prefill_modes``) on MODES_FORMS at 14336x4096 and 4096x14336: decode
    at M 1 / 8 / 64, prefill at M 128 / 1024 / 2048, each within 5e-3 (max
    form) of its plain version's float32 result (``forward_f32_epilogue``)
    and reported against ``forward_meta`` (mean form), in one device
    operation a call; its time beside the bound, a dense bf16 matmul on the
    dequantized weight (x in bf16) and, in the same call, the general fused
    kernel's float path on the same layer and x (fp8 codes for A8Wn): the
    route these layers took before (row 5f). The plain version is timed on
    the kernels line's rows (A8W4 gs 64, 14336x4096, M 8 and 128). Each row
    carries its call's plan (the prefill rows ``modes_plan``, the persistent
    kernel's) and a time under a read flush of the L2 beside the write
    flush's; with ``old_prefill`` (``start_old_prefill_build``) each prefill
    row also times that tree's ``gl_prefill_modes`` (``parent_ms``), equal
    to the current kernel bit for bit where neither cuts K
    (``equals_parent``). Then A8W4 gs 64 on RAGGED_SHAPE at the prefill Ms,
    checked and timed alike: there ``prefill_modes_ragged`` launches
    (``gl_prefill_modes`` on the mode-4 entry's ``plan``), the persistent
    kernel does not."""
    from gemlite_tpu_torch.dtypes import to_torch_dtype
    from gemlite_tpu_torch.ops import decode, prefill
    from gemlite_tpu_torch.ops.dequantize import dequantize_full
    from gemlite_tpu_torch.ops.fused import fused_gemm_float
    from gemlite_tpu_torch.ops.reference import forward_f32_epilogue, forward_meta
    from gemlite_tpu_torch.quant import scale_activations_per_token

    gen = torch.Generator(device="cuda").manual_seed(20)
    rows = []
    picked = {("decode_modes", 8), ("prefill_modes", 128), ("prefill_modes_ragged", 128)}
    cases = [(form, N, K, MODES_DECODE_MS + MODES_PREFILL_MS)
             for form in MODES_FORMS for N, K in MODES_SHAPES]
    cases.append(("a8w4_gs64", *RAGGED_SHAPE, MODES_PREFILL_MS))
    counted = {"decode_modes": decode.decode_modes, "prefill_modes": prefill.prefill_modes,
               "prefill_modes_ragged": prefill.prefill_modes_ragged}
    for form, N, K, Ms in cases:
        ragged = (N, K) == RAGGED_SHAPE
        layer = modes_layer(form, N, K, gen)
        meta = layer.meta
        dense = dequantize_full(layer.W_q, layer.scales, layer.zeros, meta).to(torch.bfloat16)
        fp8 = meta.scaled_activations
        for M in Ms:
            kernel = ("decode_modes" if M <= 64 else
                      "prefill_modes_ragged" if ragged else "prefill_modes")
            fn = decode.decode_modes if M <= 64 else prefill.prefill_modes
            xb = (torch.randn((M, K), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
            xq, sx = (scale_activations_per_token(xb, to_torch_dtype(meta.input_dtype))
                      if fp8 else (xb, None))
            x = xq.to(torch.bfloat16)
            args = (layer.W_q, layer.scales, layer.zeros, sx)
            before = {k: f.launches for k, f in counted.items()}
            got = fn(x, *args, meta)
            launched = [k for k, f in counted.items() if f.launches != before[k]]
            if launched != [kernel]:
                raise RuntimeError(f"{(form, M, N, K)} launched {launched}, not {kernel}")
            want = forward_f32_epilogue(xq, *args, with_f32_out(meta))
            meta_ref = forward_meta(xq, *args, with_f32_out(meta))
            torch.cuda.synchronize()
            err = rel_err(got, want)
            x_bytes = M * K * (1 if fp8 else 2) + (4 * M if fp8 else 0)
            bound, by = kernel_bound(layer_bytes(layer) + x_bytes + 2 * M * N,
                                     2.0 * M * N * K, peak)
            timed_plain = form == "a8w4_gs64" and (N, K) in (MODES_SHAPES[0], RAGGED_SHAPE) \
                and (kernel, M) in picked
            row = {"kernel": kernel, "form": form, "mode": meta.W_group_mode,
                   "csm": meta.channel_scale_mode, "M": M, "N": N, "K": K,
                   "rel_err": err, "max_abs_err": max_abs(got, want),
                   "forward_meta_mean_rel": _mean_max(got, meta_ref)["mean_rel"],
                   "ms": timer.ms(lambda: fn(x, *args, meta)),
                   "row_5f_ms": None if ragged else
                   timer.ms(lambda: fused_gemm_float(xq, *args, meta)),
                   "x_to_bf16_ms": timer.ms(lambda: xq.to(torch.bfloat16)) if fp8 else None,
                   "plain_ms": timer.ms(lambda: forward_f32_epilogue(xq, *args, meta), iters=3)
                   if timed_plain else None,
                   "bound_ms": bound, "bound_by": by,
                   "library_ms": timer.ms(lambda: torch.matmul(x, dense)),
                   "library": "dense bf16 matmul on the dequantized weight (x in bf16)",
                   "read_flush_ms": timer.ms(lambda: fn(x, *args, meta), flush="read"),
                   "plan": (decode.modes_plan(M, meta) if M <= 64 else
                            (prefill.plan if ragged else prefill.modes_plan)(
                                M, N, K, meta.group_size, meta.W_nbits))._asdict(),
                   "device_ops_per_call": device_ops_per_call(lambda: fn(x, *args, meta)),
                   "card": card}
            if old_prefill is not None and M > 64 and not ragged:
                old = old_prefill(x, *args, meta)
                unsplit = (row["plan"]["full"] == row["plan"]["tiles_n"] * row["plan"]["tiles_m"]
                           and prefill.plan(M, N, K, meta.group_size, meta.W_nbits).splits == 1)
                row["parent_ms"] = timer.ms(lambda: old_prefill(x, *args, meta))
                row["parent_plan"] = prefill.plan(M, N, K, meta.group_size,
                                                  meta.W_nbits)._asdict()
                row["equals_parent"] = bool(torch.equal(old, got)) if unsplit else None
                if row["equals_parent"] is False:
                    raise RuntimeError(f"{kernel} differs from the parent's where neither "
                                       f"cuts K: {row}")
            emit(row)
            if not err <= REL_TOL:
                raise RuntimeError(f"{kernel} disagrees with its plain version: {row}")
            if row["device_ops_per_call"] != 1:
                raise RuntimeError(f"{kernel}: one call took several device operations: {row}")
            rows.append(row)
        del layer, dense
        torch.cuda.empty_cache()
    emit({"phase": "kernels_modes", "ok": True, "checked": len(rows), "card": card})
    return {r["kernel"]: r for r in rows if r["plain_ms"] is not None}


DEQUANT_INT_FORMS = ("a8w4_gs64", "a8w2_gs64", "a16w4_cw_post", "a16w158", "w2_gs64", "w8_gs128")
DEQUANT_LAYER_FORMS = ("a8w4_gs64", "w8_gs128")
DEQUANT_LAYER_MS = (4096, 8192)


def dequant_int_layer(form: str, N: int, K: int, gen: torch.Generator):
    """A layer of the dequantize kernel's integer form: the mode 1-3 forms of
    modes_layer, or W2 gs 64 / W8 gs 128 in mode 4 (random codes)."""
    if form == "w2_gs64":
        return random_layer(N, K, gen, bits=2, gs=64)
    if form == "w8_gs128":
        return random_layer(N, K, gen, bits=8, gs=128)
    return modes_layer(form, N, K, gen)


def phase_kernels_dequantize_int(card: str, peak, timer: Timer) -> dict:
    """The dequantize kernel's integer form (``gl_dequantize_int``, row 3's
    mode 1-3, W1/W2 and W8 forms) on DEQUANT_INT_FORMS at both MODES_SHAPES:
    equal to ``dequantize_full`` bit for bit, its time beside the bound
    (words, metadata and the 2 K N bytes of bf16 output over the memory
    rate) and the plain version's time; no library call dequantizes grouped
    HQQ codes. Then the layer at M 4096 and 8192 (A8W4 gs 64, W8 gs 128 on
    14336x4096): routed ``dequantize``, equal bit for bit to the route's
    plain version (``dequantize_full``, then ``ops/dispatch._dense``) and
    within 5e-3 (max form) of the float32 product (``rel_err_f32``; beside
    it, and timed beside ``_dense``, the product with its sums rounded to
    bf16 before the per-token scale), and the dequantize kernel plus the
    dense matmul (``_dense``)
    timed beside row 5f (``fused_gemm_float``, the route these layers took
    before) in the same call."""
    from gemlite_tpu_torch.dtypes import to_torch_dtype
    from gemlite_tpu_torch.ops import dispatch
    from gemlite_tpu_torch.ops.dequantize import dequantize_full, dequantize_int
    from gemlite_tpu_torch.ops.fused import fused_gemm_float
    from gemlite_tpu_torch.quant import scale_activations_per_token

    gen = torch.Generator(device="cuda").manual_seed(23)
    rows, layer_rows = [], []
    for form in DEQUANT_INT_FORMS:
        for N, K in MODES_SHAPES:
            layer = dequant_int_layer(form, N, K, gen)
            meta = layer.meta
            args = (layer.W_q, layer.scales, layer.zeros, meta)
            got, want = dequantize_int(*args), dequantize_full(*args)
            torch.cuda.synchronize()
            bound, by = kernel_bound(layer_bytes(layer) + 2 * K * N, 0.0, peak)
            row = {"kernel": "dequantize_int", "form": form, "bits": meta.W_nbits,
                   "mode": meta.W_group_mode, "csm": meta.channel_scale_mode, "M": 0, "N": N,
                   "K": K, "bit_equal": bool(torch.equal(got, want)),
                   "max_abs_err": max_abs(got, want),
                   "ms": timer.ms(lambda: dequantize_int(*args)),
                   "plain_ms": timer.ms(lambda: dequantize_full(*args), iters=5),
                   "bound_ms": bound, "bound_by": by, "library_ms": None,
                   "library": "none: no single PyTorch call dequantizes grouped HQQ codes",
                   "device_ops_per_call": device_ops_per_call(lambda: dequantize_int(*args)),
                   "card": card}
            emit(row)
            if not row["bit_equal"]:
                raise RuntimeError(f"dequantize_int differs from dequantize_full: {row}")
            if row["device_ops_per_call"] != 1:
                raise RuntimeError(f"dequantize_int: one call took several device operations: "
                                   f"{row}")
            rows.append(row)
            if form in DEQUANT_LAYER_FORMS and (N, K) == MODES_SHAPES[0]:
                for M in DEQUANT_LAYER_MS:
                    xb = (torch.randn((M, K), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
                    xq, sx = (scale_activations_per_token(xb, to_torch_dtype(meta.input_dtype))
                              if meta.scaled_activations else (xb, None))
                    dispatch.KERNEL_TRACE.clear()
                    out = layer(xb)
                    routes = list(dispatch.KERNEL_TRACE)
                    plain = dispatch._dense(xq, want, meta, sx)
                    ref = torch.matmul(xq.float(), want.float())
                    if sx is not None:
                        ref = ref * sx.reshape(-1, 1).float()

                    def bf16_sums():           # the sums rounded to bf16 before the scale
                        out = torch.matmul(xq.to(torch.bfloat16), want)
                        return out if sx is None else \
                            (out.float() * sx.reshape(-1, 1).float()).to(torch.bfloat16)
                    torch.cuda.synchronize()
                    lrow = {"kernel": "dequantize_int_layer", "form": form, "M": M, "N": N,
                            "K": K, "routes": routes,
                            "equals_plain_route": bool(torch.equal(out, plain)),
                            "rel_err_f32": rel_err(out, ref),
                            "rel_err_f32_bf16_sums": rel_err(bf16_sums(), ref),
                            "dense_ms": timer.ms(lambda: dispatch._dense(xq, want, meta, sx),
                                                 iters=10),
                            "dense_bf16_sums_ms": timer.ms(bf16_sums, iters=10),
                            "dequantize_plus_dense_ms": timer.ms(lambda: dispatch._dense(
                                xq, dequantize_int(*args), meta, sx), iters=10),
                            "layer_ms": timer.ms(lambda: layer(xb), iters=10),
                            "row_5f_ms": timer.ms(lambda: fused_gemm_float(
                                xq, layer.W_q, layer.scales, layer.zeros, sx, meta), iters=10),
                            "card": card}
                    emit(lrow)
                    del out, ref, plain
                    if routes != ["dequantize"] or not lrow["equals_plain_route"] or \
                            not lrow["rel_err_f32"] <= REL_TOL:
                        raise RuntimeError(f"the layer at M {M} is off its route, its plain "
                                           f"version or the float32 product: {lrow}")
                    layer_rows.append(lrow)
            del layer, got, want
            torch.cuda.empty_cache()
    emit({"phase": "kernels_dequantize_int", "ok": True, "checked": len(rows) + len(layer_rows),
          "card": card})
    return {"dequantize_int": next(r for r in rows if r["form"] == "a8w4_gs64"
                                   and (r["N"], r["K"]) == MODES_SHAPES[0])}


def phase_serve_a8w4(card: str, cfg, dense) -> dict:
    """The 4-layer model quantized with A8W4_HQQ_INT_dynamic(bf16) gs 64
    (mode 3 with bf16 scales and zeros, e4m3 activations per token) served
    as in "serve": every linear on the decode kernel's mode 1-3 form up to M
    64 and on the prefill kernel's above, fp8 x going in as its bf16 image."""
    from gemlite_tpu_torch import quantize_llama
    from gemlite_tpu_torch.helper import A8W4_HQQ_INT_dynamic

    t0 = time.perf_counter()
    params = quantize_llama(dense, processor=A8W4_HQQ_INT_dynamic(device="cuda",
                                                                  dtype=torch.bfloat16),
                            group_size=64)
    torch.cuda.synchronize()
    return serve_and_check("serve_a8w4", params, cfg, card, time.perf_counter() - t0,
                           "decode", "prefill", "profile_a8w4", MODES_GROUPS,
                           kernel_of={"decode": "decode_modes", "prefill": "prefill_modes"})[0]


def channelwise_llama(dense, post: bool = True):
    """The 4-layer model's block linears quantized channel-wise (W4, each row
    of a linear one group: quant.quantize_int_weights at gs = K) and packed
    by ``A16Wn(post_scale=post)``: mode 1 / csm 1 (the channel scale after
    the K loop), or mode 3 / csm 0."""
    from gemlite_tpu_torch.helper import A16Wn
    from gemlite_tpu_torch.quant import quantize_int_weights
    proc = A16Wn(device="cuda", dtype=torch.bfloat16, post_scale=post)
    blocks = []
    for blk in dense["blocks"]:
        nb = {"attn": {}, "mlp": {}, "ln_attn": blk["ln_attn"], "ln_mlp": blk["ln_mlp"]}
        for grp in ("attn", "mlp"):
            for name, w in blk[grp].items():
                K = w.shape[1]
                W_q, s, z = quantize_int_weights(w.to(torch.float32), 4, K)
                nb[grp][name] = proc.from_weights(W_q, s, z, 4, K)
        blocks.append(nb)
    return dict(dense, blocks=blocks)


def phase_serve_scan_cw(card: str, cfg, dense) -> dict:
    """The 4-layer model quantized channel-wise (A16W4 with post_scale: mode
    1 / csm 1) served on the dense cache with its decode step captured,
    unrolled and with scan_layers=True: the scan engine's decode steps take
    the stacked mode 1-3 entry (decode_modes_stacked), the unrolled engine's
    the per-layer one, and the two give the same tokens and the same logits
    on the first two steps. Launches as scheduled. Returns the scan run's
    launch counts."""
    from gemlite_tpu_torch import ContinuousBatchingEngine, Request

    t0 = time.perf_counter()
    params = channelwise_llama(dense)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    meta = params["blocks"][0]["mlp"]["down"].meta
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in SERVE_PROMPT_LENS]
    n_new = 32
    runs = {}
    for name, scan in (("captured_unrolled", False), ("captured_scan", True)):
        eng = ContinuousBatchingEngine(params, cfg, max_batch=8, paged=False, scan_layers=scan,
                                       device="cuda")
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with RouteLog() as log:
            for p in prompts:
                eng.submit(Request(prompt_tokens=p, max_new_tokens=n_new))
            logits = []
            for _ in range(2):
                eng.step()
                logits.append(eng.last_logits.clone())
            results = eng.run()
            torch.cuda.synchronize()
        by_prompt = {tuple(r.prompt_tokens): r for r in results}
        stats = eng.stats()
        per_fwd, short = 7 * cfg.num_layers, sum(len(p) <= 64 for p in prompts)
        counts = read_counts()
        expect = {k: 0 for k in counts}
        expect["prefill_modes"] = per_fwd * (len(prompts) - short)
        if scan:
            expect["decode_modes"] = per_fwd * short
            expect["decode_modes_stacked"] = per_fwd * stats["decode_steps"]
        else:
            expect["decode_modes"] = per_fwd * (short + stats["decode_steps"])
        runs[name] = {"tokens": [by_prompt[tuple(p)].output_tokens for p in prompts],
                      "logits": logits, "counts": counts, "expect": expect, "stats": stats,
                      "routes": log.linears, "wall_s": time.perf_counter() - t0, "scan": scan}
        del eng
    same = runs["captured_scan"]["tokens"] == runs["captured_unrolled"]["tokens"]
    logits_equal = all(torch.equal(a, b) for a, b in zip(runs["captured_scan"]["logits"],
                                                         runs["captured_unrolled"]["logits"]))
    counts_ok = all(r["counts"] == r["expect"] for r in runs.values())
    routes_ok = all(r["routes"] == ({"decode", "prefill", "decode_stacked"} if r["scan"]
                                    else {"decode", "prefill"}) for r in runs.values())
    graphs_ok = all(captured_throughout(r["stats"]) and prefills_captured(r["stats"])
                    for r in runs.values())
    ok = same and logits_equal and counts_ok and routes_ok and graphs_ok
    emit({"phase": "serve_scan_cw", "ok": ok,
          "model": "Llama-3-8B widths, 4 of 32 layers (depth cut), channel-wise A16W4 "
                   "(post_scale: W_group_mode 1, csm 1)",
          "meta": {"W_group_mode": meta.W_group_mode, "csm": meta.channel_scale_mode},
          "requests": len(prompts), "new_tokens": n_new, "setup_s": setup_s,
          "tokens_equal": same, "first_two_decode_logits_equal": logits_equal,
          **{name: {"wall_s": r["wall_s"], "tokens_out": r["stats"]["tokens_out"],
                    "tokens_per_s_host_clock": r["stats"]["tokens_out"] / r["wall_s"],
                    "decode_steps": r["stats"]["decode_steps"], "graphs": graph_report(r["stats"]),
                    "launches": r["counts"], "launches_expected": r["expect"],
                    "routes": sorted(r["routes"])} for name, r in runs.items()},
          "card": card})
    if not ok:
        raise RuntimeError("serve_scan_cw: the channel-wise scan engine failed its checks: "
                           f"tokens {same}, logits {logits_equal}, launches {counts_ok}, "
                           f"routes {routes_ok}, graphs {graphs_ok}")
    return runs["captured_scan"]["counts"]


MX_GROUPS = {"mx_decode_kernel": ("mx_decode",), "mx_prefill_kernel": ("mx_prefill",)}
MX_DECODE_MS = (1, 8, 64)
MX_PREFILL_MS = (128, 1024)
MX_PREFILL_WIDE_MS = (128, 256, 1024, 2048)   # on MX_SHAPE: the 256-row blocks from M 129
MX_NVFP4_MS = (8, 128)               # NVFP4 has no decode form: M <= 64 runs the prefill kernel
MX_SHAPE = (14336, 4096)             # the kernels line's MX rows
# the general entry: SmolLM2-360M's block linears (hidden 960, intermediate
# 2560, 5 kv heads of 64) and gpt-oss-20b's hidden width, off the fold rule
MX_GENERAL_SHAPES = ((960, 960), (320, 960), (2560, 960), (960, 2560), (2880, 2880))
MX_GENERAL_MS = (1, 8, 64, 128, 1024)
MX_GENERAL_FORMS = ("a16w4_mxfp", "a8w4_mxfp", "a4w4_mxfp", "a4w4_nvfp")
MX_GENERAL_ROW_SHAPE = (2560, 960)   # the kernels line's row: SmolLM2's gate / up at M 8
MX_FORMS = {"a16w4_mxfp": ("A16W4_MXFP", {}), "a16w8_mxfp": ("A16W8_MXFP", {}),
            "a16w8_mxfp_e5m2": ("A16W8_MXFP", {"fp8": torch.float8_e5m2}),
            "a8w8_mxfp": ("A8W8_MXFP_dynamic", {}), "a8w4_mxfp": ("A8W4_MXFP_dynamic", {}),
            "a4w4_mxfp": ("A4W4_MXFP_dynamic", {}), "a4w4_nvfp": ("A4W4_NVFP_dynamic", {})}


def mx_layer(form: str, N: int, K: int, gen: torch.Generator):
    """An MX layer of ``form`` from random N(0, 0.02) weights quantized on the
    card by the processor's from_linear."""
    from types import SimpleNamespace
    from gemlite_tpu_torch import mx
    name, kw = MX_FORMS[form]
    w = torch.randn((N, K), generator=gen, device="cuda") * 0.02
    return getattr(mx, name)(device="cuda", **kw).from_linear(SimpleNamespace(weight=w, bias=None),
                                                              del_orig=False)


def mx_inputs(layer, M: int, gen: torch.Generator):
    """(x as the decode / prefill kernels take it, per-token scales or None,
    the kernel's meta): bf16 x; e4m3 per token for csm 2; for csm 4 the
    fake-quantized bf16 x and csm 0, as the router hands it to them."""
    from gemlite_tpu_torch.ops.reference import fake_quant_activations
    from gemlite_tpu_torch.quant import scale_activations_per_token
    x = (torch.randn((M, layer.in_features), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
    meta = layer.meta
    if meta.channel_scale_mode == 2:
        return (*scale_activations_per_token(x, torch.float8_e4m3fn), meta)
    if meta.channel_scale_mode == 4:
        return fake_quant_activations(x, meta.input_dtype), None, meta._replace(channel_scale_mode=0)
    return x, None, meta


def parent_mx_decode_plan(M: int, N: int, K: int, kind: int, x_bytes: int):
    """The MX decode plan of the tree before the decode body streamed its
    weights by TMA (``start_old_mx_build``): 128-column blocks, K cut in
    units of 256 so that about 4 x 132 blocks run, a ring of 128-deep
    stages in 72 KB (2-6 stages). Returns (column tiles, splits,
    k_per_split, stages)."""
    tiles, unit = N // 128, 256
    units = -(-K // unit)
    splits = max(1, min(units, -(-4 * 132 // tiles)))
    per = -(-units // splits)
    rows = -(-M // 8) * 8
    stage = 128 // (8 if kind == 0 else 4) * 128 * 4 + 4 * 128 + rows * 128 * x_bytes
    stages = max(2, min(6, 72 * 1024 // stage))
    return tiles, -(-units // per), min(K, per * unit), stages


def start_old_mx_build(src_dir: Path):
    """Start nvcc on an earlier tree's ``mx_gemm.cu`` (``src_dir`` holds it
    and its headers, e.g. the parent commit's ``gemlite_tpu_torch/csrc``
    unpacked under ``_archive/``) into ``gemlite_tpu_torch/_build/old/``,
    beside the current build. Returns a function that waits for it and
    returns that tree's entries with the C signatures and plans they had
    before the decode body streamed its weights by TMA: ``decode(x, W_q,
    scales, sx, meta)``, ``decode_stacked(x, W_q, scales, meta, layer_idx)``
    (``parent_mx_decode_plan``), ``prefill(x, W_q, scales, sx, meta)``,
    ``csm4(codes, group_scales, W_q, scales, meta)`` (``ops/mx.prefill_plan``),
    ``general(x, W_q, scales, sx, meta)`` (``ops/mx.general_plan``), and
    ``plan(kernel, M, N, K, meta)``, the (rows or column tiles, splits,
    k_per_split, stages) that tree's call took. The current entries are timed
    against them in the same call."""
    import atexit
    import ctypes
    from types import SimpleNamespace
    from gemlite_tpu_torch.ops import build
    out_dir = build.BUILD_DIR / "old"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "mx_gemm_old.so"
    proc = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-I", str(src_dir), "-o", str(so),
                             str(src_dir / "mx_gemm.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    atexit.register(proc.kill)

    def ready():
        from gemlite_tpu_torch import DType
        from gemlite_tpu_torch.ops import mx
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"the earlier mx_gemm.cu failed to build:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(so))
        for fn, ptrs, ints in (("gl_mx_prefill", 8, 11), ("gl_mx_general", 7, 9),
                               ("gl_mx_decode", 7, 8), ("gl_mx_decode_stacked", 8, 9)):
            getattr(lib, fn).argtypes = ([ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints
                                         + [ctypes.c_void_p])
            getattr(lib, fn).restype = ctypes.c_int

        def plan(kernel, M, N, K, meta):
            nvfp4 = meta.input_dtype == DType.NVFP4.value
            if kernel in ("mx_decode", "mx_decode_stacked"):
                xb = 1 if meta.channel_scale_mode == 2 else 2
                return parent_mx_decode_plan(M, N, K, mx.w_kind(meta), xb)
            if kernel == "mx_general":
                p = mx.general_plan(M, N, K, nvfp4)
                return p.bm, p.splits, p.k_per_split, p.stages
            codes = kernel == "mx_prefill_csm4" or meta.channel_scale_mode == 2
            p = mx.prefill_plan(M, N, K, mx.w_kind(meta), x_codes=codes)
            return p.bm, p.splits, p.k_per_split, p.stages

        def scratch(kernel, M, N, splits, tiles):
            stream = torch.cuda.current_stream().cuda_stream
            part, cnt = mx._split("old_" + kernel, splits * M * N if splits > 1 else 0, tiles,
                                  torch.device("cuda"), stream)
            return part, cnt, stream

        def prefill(x, W_q, scales, sx, meta, xs=None):
            M, N, K = x.shape[0], meta.out_features, meta.in_features
            codes = x.dtype == torch.float8_e4m3fn
            kernel = "mx_prefill_csm4" if xs is not None else "mx_prefill"
            bm, splits, kps, stages = plan(kernel, M, N, K, meta)
            part, cnt, stream = scratch("mx_prefill", M, N, splits, -(-M // bm) * (N // 128))
            out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
            err = lib.gl_mx_prefill(
                x.data_ptr(), None if xs is None else xs.data_ptr(), W_q.data_ptr(),
                scales.view(torch.uint8).data_ptr(), None if sx is None else sx.data_ptr(), part,
                cnt, out.data_ptr(), M, N, K, 3 if codes else 2,
                0 if xs is None else K // xs.shape[1], mx.w_kind(meta), meta.group_size, bm,
                splits, kps, stages, stream)
            build.check(err, "the earlier gl_mx_prefill")
            return out

        def general(x, W_q, scales, sx, meta):
            M, N, K = x.shape[0], meta.out_features, meta.in_features
            bm, splits, kps, stages = plan("mx_general", M, N, K, meta)
            tiles_n = -(-N // 128)
            part, cnt, stream = scratch("mx_general", M, tiles_n * 128, splits,
                                        -(-M // bm) * tiles_n)
            out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
            err = lib.gl_mx_general(x.data_ptr(), W_q.data_ptr(), scales.view(torch.uint8).data_ptr(),
                                    None if sx is None else sx.data_ptr(), part, cnt,
                                    out.data_ptr(), M, N, K,
                                    3 if x.dtype == torch.float8_e4m3fn else 2,
                                    int(meta.input_dtype == DType.NVFP4.value), bm, splits, kps,
                                    stages, stream)
            build.check(err, "the earlier gl_mx_general")
            return out

        def decode(x, W_q, scales, sx, meta, layer_idx=None):
            M, N, K = x.shape[0], meta.out_features, meta.in_features
            tiles, splits, kps, stages = plan("mx_decode", M, N, K, meta)
            part, cnt, stream = scratch("mx_decode", M, N, splits, tiles)
            out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
            head = (x.data_ptr(), W_q.data_ptr(), scales.view(torch.uint8).data_ptr(),
                    None if sx is None else sx.data_ptr())
            tail = (M, N, K, 3 if x.dtype == torch.float8_e4m3fn else 2, mx.w_kind(meta), splits,
                    kps, stages, stream)
            if layer_idx is None:
                err = lib.gl_mx_decode(*head, part, cnt, out.data_ptr(), *tail)
            else:
                err = lib.gl_mx_decode_stacked(*head, layer_idx.data_ptr(), part, cnt,
                                               out.data_ptr(), W_q.shape[0], *tail)
            build.check(err, "the earlier gl_mx_decode")
            return out

        return SimpleNamespace(
            prefill=prefill, general=general, plan=plan, decode=decode,
            decode_stacked=lambda x, W_q, scales, meta, idx: decode(x, W_q, scales, None, meta,
                                                                    idx),
            csm4=lambda codes, gscales, W_q, scales, meta: prefill(codes, W_q, scales, None, meta,
                                                                   xs=gscales))
    return ready


def old_fp8_plan(kernel: str, M: int, N: int, K: int, x_bytes: int):
    """The plan an earlier tree's fp8 entry took before the fp8-x prefill took
    256-row blocks and the decode grid one wave (``start_old_fp8_build``): the prefill's rows (128 with fp8 x, 256 with
    bf16 x from M 129), split and ring as ``ops/fp8.prefill_plan`` gives them
    for those rows; the decode's 128-column blocks, K cut in units of 256 so
    that about 4 x 132 blocks run, and a ring of 72 KB. Returns (rows or
    column tiles, splits, k_per_split, stages)."""
    from gemlite_tpu_torch.ops import fp8
    if kernel == "fp8_prefill":
        p = fp8.prefill_plan(M, N, K, x_bytes, bm=128 if x_bytes == 1 or M <= 128 else 256)
        return p.bm, p.splits, p.k_per_split, p.stages
    tiles, unit = N // 128, 256
    units = -(-K // unit)
    splits = max(1, min(units, -(-4 * 132 // tiles)))
    per = -(-units // splits)
    rows = next(nt for nt in (1, 2, 4, 8) if M <= 8 * nt)
    stages = max(2, min(6, 72 * 1024 // (16384 + rows * 8 * 128 * x_bytes)))
    return tiles, -(-units // per), min(K, per * unit), stages


def start_old_fp8_build(src_dir: Path):
    """Start nvcc on an earlier tree's ``fp8_gemm.cu`` (``src_dir`` holds it
    and its headers, e.g. that tree's ``gemlite_tpu_torch/csrc`` unpacked
    under ``_archive/``) into ``gemlite_tpu_torch/_build/old/``, beside the
    current build. Returns a function that waits for it and returns that
    tree's entries with the plans it took (``old_fp8_plan``):
    ``decode(x, W_q, scales, sx, meta)`` and ``prefill(x, W_q, scales, sx,
    meta)``. The current entries are timed against them in the same call."""
    import atexit
    import ctypes
    from types import SimpleNamespace
    from gemlite_tpu_torch.ops import build
    out_dir = build.BUILD_DIR / "old"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "fp8_gemm_old.so"
    proc = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-I", str(src_dir), "-o", str(so),
                             str(src_dir / "fp8_gemm.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    atexit.register(proc.kill)

    def ready():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"the earlier fp8_gemm.cu failed to build:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(so))
        for fn, ptrs, ints in (("gl_fp8_decode", 7, 11), ("gl_fp8_prefill", 7, 12)):
            getattr(lib, fn).argtypes = ([ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints
                                         + [ctypes.c_void_p])
            getattr(lib, fn).restype = ctypes.c_int
        return SimpleNamespace(
            decode=lambda *a: old_fp8_call(lib, "fp8_decode", *a),
            prefill=lambda *a: old_fp8_call(lib, "fp8_prefill", *a))
    return ready


def old_fp8_call(lib, kernel: str, x, W_q, scales, sx, meta, plan=None):
    """One launch of a built ``fp8_gemm.cu`` (an earlier tree's, or a variant
    of one) with the C signatures the fp8 entries have kept: ``plan`` (rows or column
    tiles, splits, k_per_split, stages), by default ``old_fp8_plan``'s."""
    from gemlite_tpu_torch import DType
    from gemlite_tpu_torch.ops import build, fp8
    M, N, K = x.shape[0], meta.out_features, meta.in_features
    xb = 2 if meta.input_dtype == DType.BF16.value else 1
    lead, splits, kps, stages = plan or old_fp8_plan(kernel, M, N, K, xb)
    tiles = lead if kernel == "fp8_decode" else -(-M // lead) * (N // 128)
    stream = torch.cuda.current_stream().cuda_stream
    part, cnt = fp8._split("old_" + kernel, splits * M * N if splits > 1 else 0, tiles, x.device,
                           stream)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    s_code = DType.FP32.value if scales.dtype == torch.float32 else DType.BF16.value
    head = (x.data_ptr(), W_q.data_ptr(), scales.data_ptr(), None if sx is None else sx.data_ptr(),
            part, cnt, out.data_ptr(), M, N, K, meta.input_dtype, meta.w_code_dtype,
            meta.W_group_mode, meta.channel_scale_mode, s_code)
    if kernel == "fp8_decode":
        err = lib.gl_fp8_decode(*head, splits, kps, stages, stream)
    else:
        err = lib.gl_fp8_prefill(*head, lead, splits, kps, stages, stream)
    build.check(err, f"the earlier gl_{kernel}")
    return out


def same_plan(old, kernel, M, N, K, meta, x_codes=False) -> bool:
    """True when the current entry takes the earlier tree's rows and split
    (``start_old_mx_build``), so that both sum in one order."""
    from gemlite_tpu_torch import DType
    from gemlite_tpu_torch.ops import mx
    if kernel in ("mx_decode", "mx_decode_stacked"):
        d = mx.decode_plan(M, N, K, mx.w_kind(meta), 1 if x_codes else 2)
        return (d.tiles, d.splits, d.k_per_split) == old.plan(kernel, M, N, K, meta)[:3]
    if kernel == "mx_general":
        p = mx.general_plan(M, N, K, meta.input_dtype == DType.NVFP4.value)
    else:
        p = mx.prefill_plan(M, N, K, mx.w_kind(meta), x_codes=x_codes)
    return (p.bm, p.splits, p.k_per_split) == old.plan(kernel, M, N, K, meta)[:3]


def phase_kernels_mx(card: str, peak, timer: Timer, old_mx=None) -> dict:
    """The MX kernels (csrc/mx_gemm.cu, the MX form of csrc/dequantize.cu)
    against their plain version (ops/reference.mx_forward_ref, float32 result)
    within 5e-3: decode at M 1 / 8 / 64 and prefill at M 128 / 1024 on the
    four 8B shapes for A16W4_MXFP, A16W8_MXFP (e4m3; e5m2 on 14336x4096) and
    A8W8_MXFP_dynamic (per-token e4m3 x), and on 14336x4096 at M 256 / 2048
    too (the 256-row blocks); NVFP4 on the prefill kernel at M 8 / 128; the
    csm-4 form at M 128 / 256 / 1024 / 2048 for A4W4_MXFP and A4W4_NVFP on
    14336x4096, equal bit for bit to the bf16 form fed fake_quant_activations;
    the stacked decode over a 32-layer A16W4_MXFP stack of 14336x4096 at
    layers 0 / 17 / 31, equal to the per-layer kernel bit for bit; the MX
    dequantize on 14336x4096 (MXFP4, MXFP8, NVFP4), equal to dequantize_full
    bit for bit. Each in one device operation a call, with its plan,
    CUDA-event time with the L2 flushed, bound (bytes over 3.35 TB/s or 2 M N
    K over the bf16 rate) and a dense bf16 matmul on the dequantized weight
    as the yardstick. The general entry's rows carry ``general_plan`` (the
    body, split and ring). The decode rows on 14336x4096 are also timed
    under a read flush (``read_flush_ms``). Given ``old_mx``
    (``start_old_mx_build``), every decode, stacked (the timed layer),
    prefill, csm-4 and general row also times an earlier tree's entry on the
    same inputs (``old_ms``), and where both take the same rows and split its
    output must equal the current one bit for bit. Returns the kernels line's
    rows."""
    from gemlite_tpu_torch.ops import mx
    from gemlite_tpu_torch.ops.dequantize import dequantize_full, dequantize_weights
    from gemlite_tpu_torch.ops.reference import fake_quant_activations, mx_forward_ref
    from gemlite_tpu_torch.quant import scale_activations_mx

    gen = torch.Generator(device="cuda").manual_seed(10)
    rows = []
    old = old_mx() if old_mx is not None else None

    def record(row, got, want, exact=False):
        emit(row)
        if exact and not torch.equal(got, want):
            raise RuntimeError(f"{row['kernel']} differs from its reference bit for bit: {row}")
        if row.get("equals_old") is False:
            raise RuntimeError(f"{row['kernel']} differs from the earlier tree's entry on the "
                               f"same plan: {row}")
        if not row["rel_err"] <= REL_TOL:
            raise RuntimeError(f"{row['kernel']} disagrees with its plain version: {row}")
        if row.get("device_ops_per_call", 1) != 1:
            raise RuntimeError(f"{row['kernel']}: one call took several device operations: {row}")
        rows.append(row)

    def call_row(name, form, layer, M, kern, x, sx, meta, plan, timed=True, old_fn=None):
        N, K = layer.out_features, layer.in_features
        args = (x, layer.W_q, layer.scales, sx)
        got = kern(*args, meta)
        old_out = old_fn(*args, meta) if old_fn is not None else None
        want = mx_forward_ref(x, layer.W_q, layer.scales, None, sx, with_f32_out(meta))
        dense = dequantize_full(layer.W_q, layer.scales, None, meta)
        xb = x.to(torch.bfloat16)
        torch.cuda.synchronize()
        bound, by = kernel_bound(layer_bytes(layer) + M * K * x.element_size() + 2 * M * N,
                                 2.0 * M * N * K, peak)
        row = {"kernel": name, "form": form, "M": M, "N": N, "K": K,
               "rel_err": rel_err(got, want), "max_abs_err": max_abs(got, want),
               "ms": timer.ms(lambda: kern(*args, meta)) if timed else None,
               "plain_ms": timer.ms(lambda: mx_forward_ref(x, layer.W_q, layer.scales, None, sx,
                                                           meta), iters=3) if timed else None,
               "bound_ms": bound, "bound_by": by,
               "library_ms": timer.ms(lambda: torch.matmul(xb, dense)) if timed else None,
               "library": "dense bf16 matmul on the dequantized weight (x converted outside)",
               "plan": plan._asdict() if plan is not None else None,
               "device_ops_per_call": device_ops_per_call(lambda: kern(*args, meta)),
               "card": card}
        if old_fn is not None:
            row["old_rel_err"] = rel_err(old_out, want)
            row["old_ms"] = timer.ms(lambda: old_fn(*args, meta))
            row["old_plan"] = old.plan(name, M, N, K, meta)
            if same_plan(old, name, M, N, K, meta, x.dtype == torch.float8_e4m3fn):
                row["equals_old"] = bool(torch.equal(got, old_out))
        if name == "mx_decode" and (N, K) == MX_SHAPE and timed:
            # the L2 flushed by a read: no dirty line is written back during the call
            row["read_flush_ms"] = timer.ms(lambda: kern(*args, meta), flush="read")
            if old_fn is not None:
                row["old_read_flush_ms"] = timer.ms(lambda: old_fn(*args, meta), flush="read")
        record(row, got, want)

    for form in ("a16w4_mxfp", "a16w8_mxfp", "a8w8_mxfp", "a4w4_nvfp", "a16w8_mxfp_e5m2"):
        for N, K in (SHAPES if form != "a16w8_mxfp_e5m2" else (MX_SHAPE,)):
            layer = mx_layer(form, N, K, gen)
            kind = mx.w_kind(layer.meta)
            if form != "a4w4_nvfp":
                for M in MX_DECODE_MS:
                    x, sx, meta = mx_inputs(layer, M, gen)
                    call_row("mx_decode", form, layer, M, mx.mx_decode, x, sx, meta,
                             mx.decode_plan(M, N, K, kind, x.element_size()),
                             old_fn=old.decode if old is not None else None)
            wide = MX_PREFILL_WIDE_MS if (N, K) == MX_SHAPE else MX_PREFILL_MS
            for M in (MX_NVFP4_MS if form == "a4w4_nvfp" else wide):
                x, sx, meta = mx_inputs(layer, M, gen)
                call_row("mx_prefill", form, layer, M, mx.mx_prefill, x, sx, meta,
                         mx.prefill_plan(M, N, K, kind, x.dtype == torch.float8_e4m3fn),
                         old_fn=old.prefill if old is not None else None)
            del layer
    torch.cuda.empty_cache()

    # the csm-4 form: e4m3 codes and float32 group scales in, bit for bit the
    # bf16 form fed fake_quant_activations(x)
    N, K = MX_SHAPE
    for form in ("a4w4_mxfp", "a4w4_nvfp"):
        layer = mx_layer(form, N, K, gen)
        meta, meta0 = layer.meta, layer.meta._replace(channel_scale_mode=0)
        dense = dequantize_full(layer.W_q, layer.scales, None, meta0)
        for M in MX_PREFILL_WIDE_MS:
            xr = (torch.randn((M, K), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
            codes, s = scale_activations_mx(xr, meta.input_dtype)
            fq = fake_quant_activations(xr, meta.input_dtype)
            got = mx.mx_prefill_csm4(codes, s, layer.W_q, layer.scales, meta)
            fed = mx.mx_prefill(fq, layer.W_q, layer.scales, None, meta0)
            want = mx_forward_ref(fq, layer.W_q, layer.scales, None, None, with_f32_out(meta0))
            torch.cuda.synchronize()
            bound, by = kernel_bound(layer_bytes(layer) + M * K + 4 * s.numel() + 2 * M * N,
                                     2.0 * M * N * K, peak)
            row = {"kernel": "mx_prefill_csm4", "form": form, "M": M, "N": N, "K": K,
                   "equals_bf16_form_fed_fake_quant": bool(torch.equal(got, fed)),
                   "rel_err": rel_err(got, want), "max_abs_err": max_abs(got, want),
                   "ms": timer.ms(lambda: mx.mx_prefill_csm4(codes, s, layer.W_q, layer.scales,
                                                             meta)),
                   "bf16_form_ms": timer.ms(lambda: mx.mx_prefill(fq, layer.W_q, layer.scales,
                                                                  None, meta0)),
                   "plain_ms": timer.ms(lambda: mx_forward_ref(fq, layer.W_q, layer.scales, None,
                                                               None, meta0), iters=3),
                   "bound_ms": bound, "bound_by": by,
                   "library_ms": timer.ms(lambda: torch.matmul(fq, dense)),
                   "library": "dense bf16 matmul of the fake-quantized x on the dequantized weight",
                   "plan": mx.prefill_plan(M, N, K, 0, x_codes=True)._asdict(),
                   "device_ops_per_call": device_ops_per_call(
                       lambda: mx.mx_prefill_csm4(codes, s, layer.W_q, layer.scales, meta)),
                   "card": card}
            if old is not None:
                was = old.csm4(codes, s, layer.W_q, layer.scales, meta)
                row["old_ms"] = timer.ms(lambda: old.csm4(codes, s, layer.W_q, layer.scales, meta))
                row["old_plan"] = old.plan("mx_prefill_csm4", M, N, K, meta)
                if same_plan(old, "mx_prefill_csm4", M, N, K, meta, True):
                    row["equals_old"] = bool(torch.equal(got, was))
            record(row, got, fed, exact=True)
        del layer, dense

    # the MX dequantize: bit for bit dequantize_full
    for form in ("a16w4_mxfp", "a16w8_mxfp", "a4w4_nvfp"):
        layer = mx_layer(form, N, K, gen)
        args = (layer.W_q, layer.scales, None, layer.meta)
        got, want = dequantize_weights(*args), dequantize_full(*args)
        torch.cuda.synchronize()
        bound, by = kernel_bound(layer_bytes(layer) + 2 * K * N, 1.0 * K * N, peak)
        row = {"kernel": "dequantize_mx", "form": form, "M": 0, "N": N, "K": K,
               "rel_err": rel_err(got, want), "max_abs_err": max_abs(got, want),
               "ms": timer.ms(lambda: dequantize_weights(*args)),
               "plain_ms": timer.ms(lambda: dequantize_full(*args), iters=3),
               "bound_ms": bound, "bound_by": by, "library_ms": None,
               "library": "none: no single PyTorch call decodes fp4 / fp8 codes and folds the "
                          "group scales (the plain version takes several)",
               "device_ops_per_call": device_ops_per_call(lambda: dequantize_weights(*args)),
               "card": card}
        record(row, got, want, exact=True)
        del layer

    # the stacked entry: a 32-layer A16W4_MXFP stack, every checked layer equal
    # to the per-layer kernel bit for bit
    Ws, Ss, metas, checked = [], [], set(), {}
    for li in range(SCAN_LAYERS):
        layer = mx_layer("a16w4_mxfp", N, K, gen)
        Ws.append(layer.W_q)
        Ss.append(layer.scales)
        metas.add(tuple(layer.meta))
        if li in SCAN_CHECKED:
            checked[li] = layer
    if len(metas) != 1:
        raise RuntimeError(f"the stack's layers have several metas: {metas}")
    W, S = torch.stack(Ws), torch.stack(Ss)
    del Ws, Ss
    meta = checked[0].meta
    dense = dequantize_full(checked[SCAN_CHECKED[1]].W_q, checked[SCAN_CHECKED[1]].scales, None,
                            meta)
    for M in MX_DECODE_MS:
        x, _, _ = mx_inputs(checked[0], M, gen)
        for li in SCAN_CHECKED:
            lyr = checked[li]
            idx = torch.tensor(li, dtype=torch.int32, device="cuda")
            got = mx.mx_decode_stacked(x, W, S, meta, idx)
            per_layer = mx.mx_decode(x, lyr.W_q, lyr.scales, None, meta)
            want = mx_forward_ref(x, lyr.W_q, lyr.scales, None, None, with_f32_out(meta))
            torch.cuda.synchronize()
            bound, by = kernel_bound(layer_bytes(lyr) + 2 * M * K + 2 * M * N, 2.0 * M * N * K,
                                     peak)
            timed = li == SCAN_CHECKED[1]
            row = {"kernel": "mx_decode_stacked", "form": "a16w4_mxfp", "layer": li,
                   "layers": SCAN_LAYERS, "M": M, "N": N, "K": K,
                   "equals_per_layer": bool(torch.equal(got, per_layer)),
                   "rel_err": rel_err(got, want), "max_abs_err": max_abs(got, want),
                   "ms": timer.ms(lambda: mx.mx_decode_stacked(x, W, S, meta, idx)) if timed
                   else None,
                   "per_layer_ms": timer.ms(lambda: mx.mx_decode(x, lyr.W_q, lyr.scales, None,
                                                                 meta)) if timed else None,
                   "plain_ms": timer.ms(lambda: mx_forward_ref(x, lyr.W_q, lyr.scales, None, None,
                                                               meta), iters=3) if timed else None,
                   "bound_ms": bound, "bound_by": by,
                   "library_ms": timer.ms(lambda: torch.matmul(x, dense)) if timed else None,
                   "library": "dense bf16 matmul on the layer's dequantized weight",
                   "plan": mx.decode_plan(M, N, K, 0, 2)._asdict(),
                   "device_ops_per_call": device_ops_per_call(
                       lambda: mx.mx_decode_stacked(x, W, S, meta, idx)),
                   "card": card}
            if old is not None and timed:
                row["old_ms"] = timer.ms(lambda: old.decode_stacked(x, W, S, meta, idx))
                row["old_plan"] = old.plan("mx_decode_stacked", M, N, K, meta)
                if same_plan(old, "mx_decode_stacked", M, N, K, meta):
                    row["equals_old"] = bool(torch.equal(got, old.decode_stacked(x, W, S, meta,
                                                                                 idx)))
            record(row, got, per_layer, exact=True)
    del checked, W, S, dense
    torch.cuda.empty_cache()

    # the general entry (row 5-MX): fp4 layers off the JAX fold rule at
    # SmolLM2-360M's shapes and gpt-oss-20b's 2880, on the ragged decode or
    # prefill body as general_plan picks
    for form in MX_GENERAL_FORMS:
        for N, K in MX_GENERAL_SHAPES:
            layer = mx_layer(form, N, K, gen)
            for M in MX_GENERAL_MS:
                x, sx, meta = mx_inputs(layer, M, gen)
                call_row("mx_general", form, layer, M, mx.mx_general, x, sx, meta,
                         mx.general_plan(M, N, K, form == "a4w4_nvfp"),
                         old_fn=old.general if old is not None else None)
            del layer
    emit({"phase": "kernels_mx", "ok": True, "checked": len(rows), "card": card})
    pick = {"mx_decode": ("a16w4_mxfp", 8), "mx_prefill": ("a16w4_mxfp", 128),
            "mx_prefill_csm4": ("a4w4_nvfp", 128), "dequantize_mx": ("a16w4_mxfp", 0),
            "mx_decode_stacked": ("a16w4_mxfp", 8), "mx_general": ("a16w4_mxfp", 8)}
    shape = {"mx_general": MX_GENERAL_ROW_SHAPE}
    return {r["kernel"]: r for r in rows
            if (r["form"], r["M"]) == pick[r["kernel"]]
            and (r["N"], r["K"]) == shape.get(r["kernel"], MX_SHAPE)
            and r.get("layer", SCAN_CHECKED[1]) == SCAN_CHECKED[1]}


MX_LAYER_ROUTES = {
    "a16w4_mxfp": ["decode", "decode", "prefill", "prefill", "dequantize"],
    "a16w8_mxfp": ["decode", "decode", "prefill", "prefill", "dequantize"],
    "a8w8_mxfp": ["decode", "decode", "prefill", "prefill", "dequantize"],
    "a8w4_mxfp": ["decode", "decode", "prefill", "prefill", "dequantize"],
    "a4w4_mxfp": ["decode", "decode", "prefill_mx_csm4", "prefill_mx_csm4", "dequantize"],
    "a4w4_nvfp": ["prefill", "prefill", "prefill_mx_csm4", "prefill_mx_csm4", "dequantize"]}


def phase_layer_mx(card: str) -> dict:
    """Each of the six MX processors' layers at 4096x4096 through its routes
    at M 1 / 64 / 65 / 128 / 4096 (the JAX router's, under the port's names),
    each within 5e-3 of its plain path: x quantized as the forward does it,
    then the plain product (at M 4096 the dense product with the folded bf16
    weight, the sums in float32 as the route keeps them). Returns the launch
    counts."""
    from gemlite_tpu_torch.ops import dispatch
    from gemlite_tpu_torch.ops.dequantize import dequantize_full
    from gemlite_tpu_torch.ops.reference import fake_quant_activations, mx_forward_ref
    from gemlite_tpu_torch.quant import scale_activations_per_token

    gen = torch.Generator(device="cuda").manual_seed(11)
    reset_counts()
    report, bad = {}, []
    for form, routes_want in MX_LAYER_ROUTES.items():
        layer = mx_layer(form, 4096, 4096, gen)
        meta = layer.meta
        dispatch.KERNEL_TRACE.clear()
        errs = {}
        for M in (1, 64, 65, 128, 4096):
            x = (torch.randn((M, 4096), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
            out = layer(x)
            sx, m0 = None, meta
            if meta.channel_scale_mode == 2:
                x, sx = scale_activations_per_token(x, torch.float8_e4m3fn)
            elif meta.channel_scale_mode == 4:
                x, m0 = fake_quant_activations(x, meta.input_dtype), meta._replace(
                    channel_scale_mode=0)
            if M >= 4096:
                want = x.float() @ dequantize_full(layer.W_q, layer.scales, None, m0).float()
                want = want * sx if sx is not None else want
            else:
                want = mx_forward_ref(x, layer.W_q, layer.scales, None, sx, with_f32_out(m0))
            errs[M] = rel_err(out, want)
        torch.cuda.synchronize()
        routes = list(dispatch.KERNEL_TRACE)
        report[form] = {"routes": routes, "rel_err": errs}
        if routes != routes_want or max(errs.values()) > REL_TOL:
            bad.append(form)
        del layer
    counts = read_counts()
    ok = not bad and min(counts[k] for k in ("mx_decode", "mx_prefill", "mx_prefill_csm4",
                                             "dequantize")) >= 1
    emit({"phase": "layer_mx", "ok": ok, "shape": [4096, 4096], "M": [1, 64, 65, 128, 4096],
          "processors": report, "launches": counts, "card": card})
    if not ok:
        raise RuntimeError(f"layer_mx phase failed for {bad}: {report}, launches {counts}")
    return counts


def phase_serve_mx(card: str, cfg, dense, form: str) -> dict:
    """The 4-layer model quantized on the card with A16W4_MXFP (serve_mxfp4:
    the MX decode kernel up to M 64, the MX prefill kernel above) or
    A4W4_NVFP_dynamic (serve_nvfp4: the MX prefill kernel on fake-quantized x
    up to M 64, its csm-4 form above), served as in "serve"; NVFP4's first
    step is checked linear by linear (``linear_step_check``)."""
    from gemlite_tpu_torch import quantize_llama
    from gemlite_tpu_torch import mx

    proc, phase, short, long_, kernel_of = {
        "a16w4_mxfp": (mx.A16W4_MXFP, "serve_mxfp4", "decode", "prefill",
                       {"decode": "mx_decode", "prefill": "mx_prefill"}),
        "a4w4_nvfp": (mx.A4W4_NVFP_dynamic, "serve_nvfp4", "prefill", "prefill_mx_csm4",
                      {"prefill": "mx_prefill", "prefill_mx_csm4": "mx_prefill_csm4"})}[form]
    t0 = time.perf_counter()
    params = quantize_llama(dense, processor=proc(device="cuda"))
    torch.cuda.synchronize()
    return serve_and_check(phase, params, cfg, card, time.perf_counter() - t0, short, long_,
                           phase.replace("serve", "profile"), MX_GROUPS, kernel_of=kernel_of,
                           linear_stages=form == "a4w4_nvfp")[0]


def smollm2_llama():
    """SmolLM2-360M's widths (its published config.json: hidden 960,
    intermediate 2560, 15/5 heads of 64, vocab 49152, rope_theta 100000) cut
    to 4 of its 32 layers, random bf16 weights from a seeded generator."""
    from gemlite_tpu_torch import LlamaConfig, init_llama
    cfg = LlamaConfig(vocab_size=49152, hidden_size=960, intermediate_size=2560, num_layers=4,
                      num_heads=15, num_kv_heads=5, head_dim=64, rope_theta=100000.0,
                      max_seq_len=512)
    gen = torch.Generator(device="cuda").manual_seed(16)
    return cfg, init_llama(cfg, generator=gen, device="cuda")


def phase_serve_mx_unfolded(card: str) -> dict:
    """SmolLM2-360M's widths quantized on the card with A16W4_MXFP: every
    block linear has K 960 or N 960 / 320, off the JAX fold rule, so every
    linear at every M runs the general MX entry (route general_fused): the
    ragged decode body at M <= 64, the ragged prefill body above. Served as
    in "serve"; returns the launch counts. The profile's "mx_general" group
    takes both bodies' kernels (no other MX entry runs here)."""
    from gemlite_tpu_torch import mx, quantize_llama
    from gemlite_tpu_torch.ops.mx import jax_folds

    cfg, dense = smollm2_llama()
    t0 = time.perf_counter()
    params = quantize_llama(dense, processor=mx.A16W4_MXFP(device="cuda"))
    torch.cuda.synchronize()
    folded = [f"block{i}.{n}" for i, blk in enumerate(params["blocks"])
              for grp in ("attn", "mlp") for n, lin in blk[grp].items() if jax_folds(lin.meta)]
    if folded:
        raise RuntimeError(f"serve_mx_unfolded: linears on the fold rule: {folded}")
    del dense
    return serve_and_check("serve_mx_unfolded", params, cfg, card, time.perf_counter() - t0,
                           "general_fused", "general_fused", "profile_mx_unfolded",
                           {"mx_general": ("mx_decode_kernel", "mx_prefill_kernel")},
                           kernel_of={"general_fused": "mx_general"},
                           model="SmolLM2-360M widths, 4 of 32 layers (depth cut), A16W4_MXFP")[0]


ATTN_GROUPS = {"flash_kernel": ("flash_attn",),
               "paged_decode_kernel": ("paged_decode",), **W4_GROUPS}
FLASH_SEQS = (256, 1024, 2048, 4096, 8192)
FLASH_REPORTED = 2048       # the flash row of the kernels line
PAGED_LENGTHS = (1, 127, 128, 129, 500, 1000, 1500, 2047)     # the kernels line's row
# Llama-3-8B's published context: 8 slots up to 8191 tokens, 64 pages each
PAGED_LONG_LENGTHS = (1, 1000, 2047, 3000, 4096, 5000, 6500, 8191)


def phase_kernels_attn(card: str, peak, timer: Timer) -> dict:
    """The flash and paged decode kernels against their plain versions at the
    8B attention shapes (32 q heads, 8 kv heads, D 128); returns the rows the
    kernels line reports. The yardstick is one scaled_dot_product_attention
    call: over (B, H, S, D) copies of q/k/v for flash, and for paged decode
    over a contiguous copy of each slot's cache padded to the longest slot,
    with a mask (no single PyTorch call reads pages)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    from gemlite_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(6)
    Hq, Hkv, D = 32, 8, 128
    rows = {}

    def bf16(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    def check(name, shape, kern, plain, plain_f32, library, bytes_moved, flops):
        got, want = kern(), plain_f32()
        torch.cuda.synchronize()
        err = rel_err(got, want)
        bound, by = kernel_bound(bytes_moved, flops, peak)
        row = {"kernel": name, "shape": shape, "rel_err": err, "max_abs_err": max_abs(got, want),
               "ms": timer.ms(kern), "plain_ms": timer.ms(plain, iters=5),
               "library_ms": timer.ms(library), "bound_ms": bound, "bound_by": by, "card": card}
        emit(row)
        if not err <= REL_TOL:
            raise RuntimeError(f"{name} kernel disagrees with its plain version: {row}")
        return row

    def plain_by_group(q, k, v):
        """The float32 plain result one kv head and its q heads at a time (at
        S 8192 all heads' scores at once would take 26 GB)."""
        r = q.shape[2] // k.shape[2]
        return torch.cat([A.causal_attention_plain(q[:, :, g * r:(g + 1) * r].float(),
                                                   k[:, :, g:g + 1].float(),
                                                   v[:, :, g:g + 1].float())
                          for g in range(k.shape[2])], dim=2)

    for S in FLASH_SEQS:
        q, k, v = bf16((1, S, Hq, D)), bf16((1, S, Hkv, D)), bf16((1, S, Hkv, D))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        row = check("flash", {"B": 1, "S": S, "Hq": Hq, "Hkv": Hkv, "D": D},
                    lambda: A.flash_attention_causal(q, k, v),
                    lambda: A.causal_attention_plain(q, k, v),
                    lambda: plain_by_group(q, k, v),
                    lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True),
                    2 * S * (2 * Hq + 2 * Hkv) * D, 2.0 * Hq * S * S * D)
        if S == FLASH_REPORTED:
            rows["flash"] = row
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()

    for lengths_b, pps in ((PAGED_LENGTHS, 16), (PAGED_LONG_LENGTHS, 64)):
        ps, B = 128, len(lengths_b)
        P = B * pps + 1                               # page 0 is the trash page
        k_pages, v_pages, q = bf16((Hkv, P, ps, D)), bf16((Hkv, P, ps, D)), bf16((B, Hq, D))
        table = (torch.randperm(B * pps, generator=gen, device="cuda") + 1).reshape(B, pps)
        table = table.to(torch.int32)
        lengths = torch.tensor(lengths_b, dtype=torch.int32, device="cuda")
        T = max(lengths_b)
        kc, vc = (A.gather_pages(p, table)[:, :T].transpose(1, 2).contiguous()
                  for p in (k_pages, v_pages))
        mask = (torch.arange(T, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
        live = sum(lengths_b)
        row = check(
            "paged_decode", {"B": B, "lengths": list(lengths_b), "page_size": ps,
                             "pages_per_seq": pps, "pages": P, "Hq": Hq, "Hkv": Hkv, "D": D},
            lambda: A.paged_decode_attention_kernel(q, k_pages, v_pages, lengths, table),
            lambda: A.paged_decode_attention_plain(q, k_pages, v_pages, lengths, table),
            lambda: A.paged_decode_attention_plain(q.float(), k_pages.float(), v_pages.float(),
                                                   lengths, table),
            lambda: sdpa(q[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True),
            live * Hkv * D * 2 * 2 + 2 * B * Hq * D * 2, 4.0 * live * Hq * D)
        row["device_ops_per_call"] = device_ops_per_call(
            lambda: A.paged_decode_attention_kernel(q, k_pages, v_pages, lengths, table))
        emit({"kernel": "paged_decode", "lengths": list(lengths_b),
              "device_ops_per_call": row["device_ops_per_call"]})
        if row["device_ops_per_call"] != 1:
            raise RuntimeError(f"paged decode: one call took several device operations: {row}")
        if lengths_b == PAGED_LENGTHS:
            rows["paged_decode"] = row
        del k_pages, v_pages, kc, vc
        torch.cuda.empty_cache()
    emit({"phase": "kernels_attn", "ok": True, "checked": len(FLASH_SEQS) + 2, "card": card})
    return rows


def bare_paged_loop(params, cfg, prompts, n_new, buckets, page_size):
    """Greedy generation with the model API on the paged cache, in the
    engine's shapes: each prompt one-shot prefilled in its bucket through its
    own table row, then all slots decoded together (paged decode kernel)."""
    from gemlite_tpu_torch.models.llama import llama_decode_step_batched, llama_forward
    from gemlite_tpu_torch.models.paged_kv import init_paged_kv
    from gemlite_tpu_torch.serving import _next_bucket
    kv = init_paged_kv(cfg, len(prompts), page_size, device="cuda")   # slot b: its own pages
    out = []
    for i, p in enumerate(prompts):
        padded = torch.zeros((1, _next_bucket(len(p), buckets)), dtype=torch.int32, device="cuda")
        padded[0, :len(p)] = torch.tensor(p, dtype=torch.int32)
        logits, _ = llama_forward(params, cfg, padded, kv=kv.with_table(kv.table[i:i + 1]),
                                  cache_len=0)
        out.append([int(torch.argmax(logits[0, len(p) - 1]))])
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device="cuda")
    for _ in range(n_new - 1):
        tok = torch.tensor([[o[-1]] for o in out], dtype=torch.int32, device="cuda")
        logits, _ = llama_decode_step_batched(params, cfg, tok, kv, lens)
        for o, t in zip(out, torch.argmax(logits[:, 0].float(), dim=-1).cpu().tolist()):
            o.append(int(t))
        lens = lens + 1
    return out


def cached_stage_check(params, cfg, prompt, matched: int, buckets) -> dict:
    """A cached request's chunk against a one-shot prefill of the same
    prompt, stage by stage from the same input, both on the card. At each
    block the one-shot path (its bucket, flash) writes the block's k/v into
    a fresh paged cache; the chunk path then prefills the tail at the runtime
    offset ``matched`` over those pages, as the engine does over attached
    pages, and the two outputs at the tail are held to mean rel 5e-3. The
    one-shot output feeds the next block on both paths, as in
    first_step_check: end to end the random-weight network magnifies each
    stage's difference."""
    from gemlite_tpu_torch.models import llama as L
    from gemlite_tpu_torch.models.paged_kv import init_paged_kv
    from gemlite_tpu_torch.serving import _next_bucket

    S, n = _next_bucket(len(prompt), buckets), len(prompt)
    C = _next_bucket(n - matched, buckets)
    tok = torch.zeros((1, S), dtype=torch.int32, device="cuda")
    tok[0, :n] = torch.tensor(prompt, dtype=torch.int32)
    pos = torch.arange(S, dtype=torch.int32, device="cuda")[None]
    kv = init_paged_kv(cfg, 1, 128, device="cuda")
    offset = torch.tensor(matched, dtype=torch.int32)
    x, out = params["embed"][tok], {}
    for i, blk in enumerate(params["blocks"]):
        full = L._block_forward(blk, cfg, x, pos, kv, i, 0)
        part = L._block_forward(blk, cfg, x[:, matched:matched + C], pos[:, matched:matched + C],
                                kv, i, offset)
        out[f"block{i}"] = _mean_max(part[:, :n - matched], full[:, matched:n])
        x = full
    h = L._rms_norm(x, params["ln_f"], cfg.norm_eps)
    out["head"] = _mean_max(L._apply(params["lm_head"], h[:, matched:matched + C])[0, n - 1 - matched],
                            L._apply(params["lm_head"], h)[0, n - 1])
    return out


PAGED_PROMPT_LENS = (40, 100, 200, 256, 300, 520, 700, 1000)
PAGED_TAILS = (30, 200)          # after the 700-token prompt's first 640 tokens (5 pages)


def phase_serve_paged(card: str, cfg, params) -> dict:
    """The W4 model at max_seq_len 2048 on the default engine: paged, prefix
    cache, page 128, 64 pages (the worst case is 8 x 16 + 1 = 129). Gates:
    (a) requests 1-8 equal the bare paged loop token for token; (b) requests
    9-10 attach 5 cached pages each (10 hits), and their chunk over the
    attached pages matches a one-shot prefill of the same prompt stage by
    stage within mean rel 5e-3 (cached_stage_check; the engine's first-token
    logits against the one-shot's are reported beside); (c) the launches of all seven kernels and the
    prefill pieces equal the schedule; (d) the first step of the 300-token
    prompt in its bucket of 512 (flash) matches the plain path on the CPU;
    (e) the decode steps ran on one graph, and every prefill piece after
    the first of its key (bucket or chunk width) was a replay."""
    import dataclasses
    from gemlite_tpu_torch import ContinuousBatchingEngine, Request
    from gemlite_tpu_torch.models.llama import llama_forward
    from gemlite_tpu_torch.serving import _next_bucket

    cfg = dataclasses.replace(cfg, max_seq_len=2048)
    rng = np.random.default_rng(7)
    firsts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in PAGED_PROMPT_LENS]
    repeats = [firsts[6][:640] + rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in PAGED_TAILS]
    n_new = 32
    engine_kw = dict(paged=True, page_size=128, total_pages=64, prefix_cache=True)
    eng = ContinuousBatchingEngine(params, cfg, max_batch=8, device="cuda", **engine_kw)

    first_logits, schedule = {}, []
    prefill = eng._prefill

    def recording(tokens, slot, offset, true_len, chunk):
        logits = prefill(tokens, slot, offset, true_len, chunk)
        # the last piece's are kept (a copy: the next replay of the key rewrites them)
        first_logits[eng.slot_req[slot].request_id] = logits.clone()
        schedule.append([int(tokens.shape[1]), "chunk" if chunk else "one_shot"])
        return logits

    eng._prefill = recording
    reqs = [Request(prompt_tokens=p, max_new_tokens=n_new) for p in firsts + repeats]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with RouteLog() as log:
        for r in reqs:
            eng.submit(r)
        results = eng.run()
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    seen = {"linears": log.linears, "attention": log.attention}
    counts = read_counts()
    stats = eng.stats()
    by_id = {r.request_id: r for r in results}
    got = [by_id[r.request_id].output_tokens for r in reqs]

    # (c) the schedule: one-shot pieces in their buckets, the two remainders as chunks
    one_shot = [_next_bucket(len(p), eng.buckets) for p in firsts]
    chunks = [_next_bucket(n, eng.buckets) for n in PAGED_TAILS]
    want_schedule = [[w, "one_shot"] for w in one_shot] + [[w, "chunk"] for w in chunks]
    per_fwd = 7 * cfg.num_layers
    widths = one_shot + chunks
    expect = {k: 0 for k in counts}
    expect["decode"] = per_fwd * (sum(w <= 64 for w in widths) + stats["decode_steps"])
    expect["prefill"] = per_fwd * sum(w > 64 for w in widths)
    expect["flash"] = cfg.num_layers * sum(w >= 256 for w in one_shot)
    expect["paged_decode"] = cfg.num_layers * stats["decode_steps"]
    routes_ok = seen == {"linears": {"decode", "prefill"},
                         "attention": {"flash", "paged_decode", "xla"}}

    # (a) requests 1-8 against the bare paged loop
    same = got[:8] == bare_paged_loop(params, cfg, firsts, n_new, eng.buckets, 128)
    # (b) prefix hits, and the cached requests' first-token logits
    hits = eng.prefix_cache_stats()["hit_pages"]
    cached, cached_e2e = {}, {}
    for r, p in zip(reqs[8:], repeats):
        cached[len(p)] = cached_stage_check(params, cfg, p, 640, eng.buckets)
        padded = torch.zeros((1, _next_bucket(len(p), eng.buckets)), dtype=torch.int32,
                             device="cuda")
        padded[0, :len(p)] = torch.tensor(p, dtype=torch.int32)
        one = llama_forward(params, cfg, padded)[0, len(p) - 1]
        cached_e2e[len(p)] = _mean_max(first_logits[r.request_id][0], one)
    cached_ok = all(v["mean_rel"] <= REL_TOL for st in cached.values() for v in st.values())
    again = bare_paged_loop(params, cfg, repeats + firsts[:6], n_new, eng.buckets, 128)[:2]
    # (d) the first step of the 300-token prompt, bucket 512, on the flash kernel
    first_step = first_step_check(params, cfg, firsts[4], route="prefill",
                                  bucket=_next_bucket(len(firsts[4]), eng.buckets))
    first_ok = all(v["mean_rel"] <= REL_TOL for k, v in first_step.items() if k != "end_to_end")
    graphs_ok = (captured_throughout(stats) and stats["graph_captures"] == 1
                 and prefills_captured(stats))
    ok = (same and hits == 10 and cached_ok and counts == expect and schedule == want_schedule
          and routes_ok and first_ok and graphs_ok)
    ttft = [r.ttft_s for r in results]
    emit({"phase": "serve_paged", "ok": ok,
          "model": "Llama-3-8B widths, 4 of 32 layers (depth cut), max_seq_len 2048",
          "engine": engine_kw, "requests": len(reqs), "prompt_lens": [len(r.prompt_tokens)
                                                                     for r in reqs],
          "new_tokens": n_new, "wall_s": wall_s, "tokens_out": stats["tokens_out"],
          "tokens_per_s_host_clock": stats["tokens_out"] / wall_s,
          "ttft_s": {"median": statistics.median(ttft), "max": max(ttft)},
          "stats_4_of_32_layers": stats, "graphs": graph_report(stats),
          "prefill_capture_s_by_key": prefill_capture_s(eng), "prefill_schedule": schedule,
          "launches": counts, "launches_expected": expect,
          "routes": {k: sorted(v) for k, v in seen.items()},
          "engine_equals_bare_paged_loop": same, "prefix_hit_pages": hits,
          "cached_chunk_vs_one_shot_stages": cached,
          "cached_first_token_logits_vs_one_shot": cached_e2e,
          "cached_tokens_equal_one_shot_loop": got[8:] == again,
          "first_step_kernel_vs_plain": first_step,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card})
    if not same:
        raise RuntimeError("paged engine tokens differ from the bare paged loop")
    if hits != 10 or not cached_ok:
        raise RuntimeError(f"prefix cache: {hits} hit pages, chunk stages {cached}")
    if counts != expect or schedule != want_schedule:
        raise RuntimeError(f"launches {counts} (expected {expect}), prefill pieces {schedule}")
    if not routes_ok:
        raise RuntimeError(f"routes {seen}")
    if not first_ok:
        raise RuntimeError(f"first step: kernel path vs plain path {first_step}")
    if not graphs_ok:
        raise RuntimeError(f"the paged decode steps did not run on one graph, or a prefill "
                           f"of a key seen before was not a replay: {stats}")
    profile_serve(params, cfg, firsts + repeats, card, phase="profile_paged", groups=ATTN_GROUPS,
                  what="10 requests (two reuse a 640-token prefix) x 8 new tokens, paged, "
                       "4 of 32 layers", engine_kw=engine_kw)
    return counts


SCAN_LAYERS = 32
SCAN_CHECKED = (0, 17, 31)
FUSED_SHAPES = ((6144, 4096), (28672, 4096))     # wqkv and gate_up of quantize_llama(fuse=True)
SCAN_GROUPS = {"stacked_decode_kernel": ("decode_mma_stacked",),
               "decode_kernel": ("decode_mma_kernel",), "prefill_kernel": ("prefill_wgmma",)}


def random_stack(L: int, N: int, K: int, bits: int, gen: torch.Generator):
    """L random mode-4 layers stacked: (L, K / epw, N) words of random codes,
    (L, K / gs, N) bf16 scales and pre-folded zeros -z * s, and their meta."""
    from gemlite_tpu_torch import DType, LayerMeta
    epw = 32 // bits
    W_q = torch.empty((L, K // epw, N), dtype=torch.int32, device="cuda")
    for l in range(L):
        W_q[l] = torch.randint(-2 ** 31, 2 ** 31, (K // epw, N), generator=gen, device="cuda",
                               dtype=torch.int64).to(torch.int32)
    s = torch.rand((L, K // GROUP, N), generator=gen, device="cuda") * 2e-3 + 1e-3
    z = torch.randint(0, 2 ** bits, (L, K // GROUP, N), generator=gen, device="cuda").float()
    meta = LayerMeta(scaled_activations=0, W_nbits=bits, group_size=GROUP,
                     unpack_mask=2 ** bits - 1, elements_per_sample=epw,
                     input_dtype=DType.BF16.value, output_dtype=DType.BF16.value,
                     acc_dtype=DType.FP32.value, meta_dtype=DType.BF16.value,
                     channel_scale_mode=0, W_group_mode=4, data_contiguous=1,
                     in_features=K, out_features=N, zero_is_scalar=0)
    scales = s.to(torch.bfloat16)
    return W_q, scales, (-z * scales.float()).to(torch.bfloat16), meta


def random_cw_stack(L: int, N: int, K: int, bits: int, post: bool, gen: torch.Generator):
    """L random channel-wise A16Wn layers stacked as models/scan_llama stacks
    them (each row of W one group, as ``A16Wn.from_weights`` packs it): with
    ``post`` mode 1 / csm 1 (the channel scale after the K loop), else mode
    3 / csm 0; (L, K / epw, N) words of random codes, (L, 1, N) bf16 scales
    and zeros, and their meta."""
    from gemlite_tpu_torch import DType, LayerMeta
    W_q, _, _, _ = random_stack(L, N, K, bits, gen)
    scales = (torch.rand((L, 1, N), generator=gen, device="cuda") * 2e-3 + 1e-3).to(torch.bfloat16)
    zeros = torch.randint(0, 2 ** bits, (L, 1, N), generator=gen, device="cuda").to(torch.bfloat16)
    meta = LayerMeta(scaled_activations=0, W_nbits=bits, group_size=K,
                     unpack_mask=2 ** bits - 1, elements_per_sample=32 // bits,
                     input_dtype=DType.BF16.value, output_dtype=DType.BF16.value,
                     acc_dtype=DType.FP32.value, meta_dtype=DType.BF16.value,
                     channel_scale_mode=1 if post else 0, W_group_mode=1 if post else 3,
                     data_contiguous=1, in_features=K, out_features=N, zero_is_scalar=0)
    return W_q, scales, zeros, meta


MODES_STACK_CASES = ((True, 14336, 4096, (1, 8, 64)), (False, 14336, 4096, (8,)),
                     (True, 4096, 14336, (8,)))


def modes_stacked_rows(card: str, peak, timer: Timer) -> list:
    """The stacked mode 1-3 entry (gl_decode_modes_stacked) over 32-layer
    channel-wise A16W4 stacks: each checked layer equal to the per-layer
    mode 1-3 entry (gl_decode_modes) on that layer bit for bit and to its
    plain version (forward_f32_epilogue) within 5e-3, no host sync around its
    launches, one device operation a call."""
    from gemlite_tpu_torch.ops.decode import decode_modes, modes_plan
    from gemlite_tpu_torch.ops.reference import forward_f32_epilogue
    from gemlite_tpu_torch.ops.scan import decode_matmul_stacked, decode_matmul_stacked_plain

    gen = torch.Generator(device="cuda").manual_seed(18)
    ids = torch.arange(SCAN_LAYERS, dtype=torch.int32, device="cuda")
    timed = SCAN_CHECKED[1]
    rows = []
    for post, N, K, Ms in MODES_STACK_CASES:
        W_q, scales, zeros, meta = random_cw_stack(SCAN_LAYERS, N, K, 4, post, gen)
        stack = (W_q, scales, zeros)
        layer = {l: (W_q[l], scales[l], zeros[l]) for l in SCAN_CHECKED}
        dense_w = torch.randn((K, N), generator=gen, device="cuda").to(torch.bfloat16)
        for M in Ms:
            x = (torch.randn((M, K), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = {l: decode_matmul_stacked(x, *stack, meta, ids[l]) for l in SCAN_CHECKED}
            finally:
                torch.cuda.set_sync_debug_mode(0)
            per = {l: decode_modes(x, *layer[l], None, meta) for l in SCAN_CHECKED}
            want = {l: forward_f32_epilogue(x, *layer[l], None, with_f32_out(meta))
                    for l in SCAN_CHECKED}
            torch.cuda.synchronize()
            equal = all(torch.equal(got[l], per[l]) for l in SCAN_CHECKED)
            err = max(rel_err(got[l], want[l]) for l in SCAN_CHECKED)
            bound, by = kernel_bound(K * N / 2 + 2 * 2 * N + 2 * M * K + 2 * M * N,
                                     2.0 * M * N * K, peak)
            row = {"kernel": "decode_modes_stacked", "form": "a16w4_cw_post" if post
                   else "a16w4_cw", "mode": meta.W_group_mode, "csm": meta.channel_scale_mode,
                   "bits": 4, "M": M, "N": N, "K": K, "layers": SCAN_LAYERS,
                   "layers_checked": list(SCAN_CHECKED), "equals_per_layer_kernel": equal,
                   "rel_err": err,
                   "max_abs_err": max(max_abs(got[l], want[l]) for l in SCAN_CHECKED),
                   "ms": timer.ms(lambda: decode_matmul_stacked(x, *stack, meta, ids[timed])),
                   "per_layer_ms": timer.ms(lambda: decode_modes(x, *layer[timed], None, meta)),
                   "plain_ms": timer.ms(lambda: decode_matmul_stacked_plain(
                       x, *stack, meta, timed), iters=5),
                   "bound_ms": bound, "bound_by": by,
                   "library_ms": timer.ms(lambda: torch.matmul(x, dense_w)),
                   "library": "dense bf16 matmul of the same shape",
                   "plan": modes_plan(M, meta)._asdict(),
                   "device_ops_per_call": device_ops_per_call(
                       lambda: decode_matmul_stacked(x, *stack, meta, ids[timed])),
                   "card": card}
            emit(row)
            if not equal or not err <= REL_TOL or row["device_ops_per_call"] != 1:
                raise RuntimeError(f"stacked mode 1-3 decode check failed: {row}")
            rows.append(row)
        del W_q, scales, zeros, stack, layer, dense_w
    return rows


def phase_kernels_scan(card: str, peak, timer: Timer) -> dict:
    """The stacked decode kernel over 32-layer stacks: at each checked layer
    it must equal the per-layer decode kernel on that layer bit for bit and
    its plain version within 5e-3, with no host sync around its launches;
    then its mode 1-3 form (``modes_stacked_rows``). Returns the rows the
    kernels line reports."""
    from gemlite_tpu_torch.ops.decode import decode_matmul, decode_matmul_plain, plan
    from gemlite_tpu_torch.ops.scan import decode_matmul_stacked, decode_matmul_stacked_plain

    gen = torch.Generator(device="cuda").manual_seed(8)
    ids = torch.arange(SCAN_LAYERS, dtype=torch.int32, device="cuda")
    timed = SCAN_CHECKED[1]
    rows = []
    cases = [(4, N, K, (1, 8, 64)) for N, K in SHAPES]
    cases += [(4, N, K, (8,)) for N, K in FUSED_SHAPES]
    cases += [(bits, N, K, (8,)) for bits in (2, 1) for N, K in ((4096, 4096), (14336, 4096))]
    for bits, N, K, Ms in cases:
        W_q, scales, zeros, meta = random_stack(SCAN_LAYERS, N, K, bits, gen)
        stack = (W_q, scales, zeros)
        layer = {l: (W_q[l], scales[l], zeros[l]) for l in SCAN_CHECKED}
        dense_w = torch.randn((K, N), generator=gen, device="cuda").to(torch.bfloat16)
        library = int4pack_mm(*layer[timed], K) if bits == 4 else None
        for M in Ms:
            x = (torch.randn((M, K), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = {l: decode_matmul_stacked(x, *stack, meta, ids[l]) for l in SCAN_CHECKED}
            finally:
                torch.cuda.set_sync_debug_mode(0)
            per = {l: decode_matmul(x, *layer[l], meta) for l in SCAN_CHECKED}
            want = {l: decode_matmul_plain(x, *layer[l], with_f32_out(meta)) for l in SCAN_CHECKED}
            torch.cuda.synchronize()
            equal = all(torch.equal(got[l], per[l]) for l in SCAN_CHECKED)
            err = max(rel_err(got[l], want[l]) for l in SCAN_CHECKED)
            layer_bytes_ = K * N * bits / 8 + 2 * 2 * (K // GROUP) * N
            bound, by = kernel_bound(layer_bytes_ + 2 * M * K + 2 * M * N, 2.0 * M * N * K, peak)
            row = {"kernel": "decode_stacked", "bits": bits, "M": M, "N": N, "K": K,
                   "layers": SCAN_LAYERS, "layers_checked": list(SCAN_CHECKED),
                   "equals_per_layer_kernel": equal, "rel_err": err,
                   "max_abs_err": max(max_abs(got[l], want[l]) for l in SCAN_CHECKED),
                   "ms": timer.ms(lambda: decode_matmul_stacked(x, *stack, meta, ids[timed])),
                   "plain_ms": timer.ms(lambda: decode_matmul_stacked_plain(
                       x, *stack, meta, timed), iters=5),
                   "dense_bf16_matmul_ms": timer.ms(lambda: torch.matmul(x, dense_w)),
                   "bound_ms": bound, "bound_by": by,
                   "library_ms": timer.ms(lambda: library(x)) if library else None,
                   "library_rel_err": rel_err(library(x), want[timed]) if library else None,
                   "plan": plan(M, N, K, GROUP, bits)._asdict(),
                   "device_ops_per_call": device_ops_per_call(
                       lambda: decode_matmul_stacked(x, *stack, meta, ids[timed])),
                   "card": card}
            if bits != 4:
                row["per_layer_ms"] = timer.ms(lambda: decode_matmul(x, *layer[timed], meta))
                row["per_layer_plain_ms"] = timer.ms(
                    lambda: decode_matmul_plain(x, *layer[timed], meta), iters=5)
                row["per_layer_rel_err"] = max(rel_err(per[l], want[l]) for l in SCAN_CHECKED)
            emit(row)
            if not equal or not err <= REL_TOL or not row.get("per_layer_rel_err", 0) <= REL_TOL \
                    or not (row["library_rel_err"] or 0) <= REL_TOL \
                    or row["device_ops_per_call"] != 1:
                raise RuntimeError(f"stacked decode kernel check failed: {row}")
            rows.append(row)
        del W_q, scales, zeros, stack, layer, dense_w, library
    modes = modes_stacked_rows(card, peak, timer)
    emit({"phase": "kernels_scan", "ok": True, "checked": len(rows) + len(modes), "card": card})
    return {"decode_stacked": next(r for r in rows if (r["bits"], r["M"], r["N"], r["K"])
                                   == (4, 8, 14336, 4096)),
            "decode_modes_stacked": next(r for r in modes if (r["form"], r["M"], r["N"], r["K"])
                                         == ("a16w4_cw_post", 8, 14336, 4096))}


def full_depth_llama():
    """Llama-3-8B at its published widths and its 32 layers: random bf16
    weights from a seeded generator on the card, drawn one block at a time
    and quantized to W4 gs=128 twice, apart and fused (``fuse=True``), so
    that no more than one dense block is alive beside the packed models.
    Returns (cfg, params, fused params); the two share the embedding and the
    head."""
    import dataclasses
    from gemlite_tpu_torch import LlamaConfig, init_llama, quantize_llama
    cfg = LlamaConfig.llama3_8b(num_layers=SCAN_LAYERS, max_seq_len=512)
    gen = torch.Generator(device="cuda").manual_seed(0)
    one = dataclasses.replace(cfg, num_layers=1, vocab_size=8)
    blocks = {False: [], True: []}
    for _ in range(cfg.num_layers):
        dense = {"blocks": init_llama(one, generator=gen, device="cuda")["blocks"]}
        for fuse, out in blocks.items():
            out.append(quantize_llama(dense, W_nbits=4, group_size=GROUP, fuse=fuse,
                                      device="cuda")["blocks"][0])
        del dense
    params = init_llama(dataclasses.replace(cfg, num_layers=0), generator=gen, device="cuda")
    return cfg, dict(params, blocks=blocks[False]), dict(params, blocks=blocks[True])


def profile_steps(eng, card: str, phase: str, n_steps: int = 8) -> None:
    """Device time by kernel over ``n_steps`` decode steps of an engine whose
    slots are all decoding, and the busy share against the wall time of as
    many steps run without the profiler; beside it the CUDA-event time of
    that unprofiled window."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        eng.step()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n_steps):
        eng.step()
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
    times = device_times(prof, SCAN_GROUPS)
    stats = eng.stats()
    emit({"phase": phase, "ok": True, "graphs": eng.graphs, "scan_layers": eng._stacked is not None,
          "decode_steps": n_steps, "batch": eng.max_batch, "layers": eng.cfg.num_layers,
          "wall_ms_unprofiled": wall_ms, "wall_ms_per_step": wall_ms / n_steps,
          "event_ms_per_step": start.elapsed_time(end) / n_steps,
          "device_busy_share": times["device_ms"] / wall_ms, **times,
          "graphs_report": graph_report(stats), "card": card})


def fused_packs_apart(params, fused) -> dict:
    """Per fused linear, whether every block's fused words, scales and zeros
    are the separate layers' side by side along N, as the CPU test
    (tests/test_torch_fuse.py) finds them: the quantizer works group by
    group, but its reductions may round apart on another number of rows."""
    out = {}
    for grp, name, parts in (("attn", "wqkv", ("wq", "wk", "wv")),
                             ("mlp", "gate_up", ("gate", "up"))):
        out[name] = all(
            torch.equal(getattr(fb[grp][name], t),
                        torch.cat([getattr(pb[grp][q], t) for q in parts], dim=-1))
            for fb, pb in zip(fused["blocks"], params["blocks"]) for t in ("W_q", "scales", "zeros"))
    return out


# the serve_scan runs: (name, fused, scan_layers, graphs); warm TTFT of the
# 128-token prompt (bucket 128) on the unrolled runs, eager and captured
WARM_TTFT_RUNS = ("eager_unrolled", "captured_unrolled")
SCAN_RUNS = (("eager_unrolled", False, False, False), ("eager_scan", False, True, False),
             ("eager_fused_unrolled", True, False, False), ("eager_fused_scan", True, True, False),
             ("captured_unrolled", False, False, True), ("captured_scan", False, True, True),
             ("captured_fused_scan", True, True, True))


def phase_serve_scan(card: str) -> dict:
    """The serve phase's traffic on the 32-layer 8B model, apart and fused,
    served eagerly and captured, unrolled and over stacked layers: equal
    tokens and bit-equal logits of the first two decode steps within the
    unfused runs and within the fused runs, launches and routes as
    scheduled, the captured runs' prefills replays after the first of each
    bucket; the warm TTFT of the 128-token prompt on the unrolled runs.
    Returns the captured scan run's launch counts."""
    from gemlite_tpu_torch import ContinuousBatchingEngine, Request

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params, fused = full_depth_llama()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    model_gb = torch.cuda.memory_allocated() / 1e9
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in SERVE_PROMPT_LENS]
    n_new = 32
    runs = {}
    for name, is_fused, scan, graphs in SCAN_RUNS:
        t0 = time.perf_counter()
        eng = ContinuousBatchingEngine(fused if is_fused else params, cfg, max_batch=8,
                                       paged=False, scan_layers=scan, graphs=graphs, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with RouteLog() as log:
            for p in prompts:
                eng.submit(Request(prompt_tokens=p, max_new_tokens=n_new))
            logits = []
            for _ in range(2):          # admissions and the first decode step, then the next
                eng.step()
                logits.append(eng.last_logits.clone())
            results = eng.run()
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        routes = log.linears
        by_prompt = {tuple(r.prompt_tokens): r for r in results}
        runs[name] = {"tokens": [by_prompt[tuple(p)].output_tokens for p in prompts],
                      "logits": logits, "counts": read_counts(), "routes": routes,
                      "stats": eng.stats(), "wall_s": wall_s, "init_s": init_s,
                      "ttft": [r.ttft_s for r in results], "fused": is_fused, "scan": scan,
                      "graphs": graphs, "capture_s_by_key": prefill_capture_s(eng)}
        if name in WARM_TTFT_RUNS:
            # the 128-token prompt again, alone, into the warm engine
            runs[name]["warm_ttft"] = warm_ttft(eng, prompts[-1], SCAN_GROUPS)
        del eng
    short = sum(len(p) <= 64 for p in prompts)
    expect = {}
    for name, r in runs.items():
        per_fwd = (4 if r["fused"] else 7) * cfg.num_layers
        steps = r["stats"]["decode_steps"]
        e = {k: 0 for k in r["counts"]}
        e["prefill"] = per_fwd * (len(prompts) - short)
        if r["scan"]:
            e["decode"], e["decode_stacked"] = per_fwd * short, per_fwd * steps
        else:
            e["decode"] = per_fwd * (short + steps)
        expect[name] = e
    groups = {"unfused": [n for n, r in runs.items() if not r["fused"]],
              "fused": [n for n, r in runs.items() if r["fused"]]}
    same = {g: all(runs[n]["tokens"] == runs[names[0]]["tokens"] for n in names)
            for g, names in groups.items()}
    logits_equal = {g: all(torch.equal(a, b) for n in names
                           for a, b in zip(runs[n]["logits"], runs[names[0]]["logits"]))
                    for g, names in groups.items()}
    counts_ok = all(runs[n]["counts"] == expect[n] for n in runs)
    routes_ok = all(r["routes"] == ({"decode", "prefill", "decode_stacked"} if r["scan"]
                                    else {"decode", "prefill"}) for r in runs.values())
    graphs_ok = all(captured_throughout(r["stats"]) and prefills_captured(r["stats"])
                    if r["graphs"] else
                    r["stats"]["graph_captures"] == r["stats"]["prefill_captures"] == 0
                    for r in runs.values())
    graphs_ok = graphs_ok and all(runs[n]["warm_ttft"]["captures_in_pass"] == 0
                                  for n in WARM_TTFT_RUNS)
    ref, fref = runs["eager_unrolled"], runs["eager_fused_unrolled"]
    fused_vs_unfused = {
        "packed_side_by_side": fused_packs_apart(params, fused),
        "tokens_equal": fref["tokens"] == ref["tokens"],
        "tokens_differing": sum(a != b for x, y in zip(fref["tokens"], ref["tokens"])
                                for a, b in zip(x, y)),
        "first_decode_logits_max_abs_diff": max_abs(fref["logits"][0], ref["logits"][0])}
    ok = all(same.values()) and all(logits_equal.values()) and counts_ok and routes_ok and graphs_ok
    emit({"phase": "serve_scan", "ok": ok,
          "model": "Llama-3-8B, published widths and all 32 layers, W4 gs=128, apart and fused",
          "requests": len(prompts), "prompt_lens": [len(p) for p in prompts],
          "new_tokens": n_new, "max_batch": 8, "paged": False, "setup_s": setup_s,
          "models_gb": model_gb, "tokens_equal": same,
          "first_two_decode_logits_equal": logits_equal, "fused_vs_unfused": fused_vs_unfused,
          **{name: {"wall_s": r["wall_s"], "engine_init_s": r["init_s"],
                    "tokens_out": r["stats"]["tokens_out"],
                    "tokens_per_s_host_clock": r["stats"]["tokens_out"] / r["wall_s"],
                    "ttft_s": {"median": statistics.median(r["ttft"]), "max": max(r["ttft"])},
                    "decode_steps": r["stats"]["decode_steps"], "graphs": graph_report(r["stats"]),
                    "launches": r["counts"], "launches_expected": expect[name],
                    "routes": sorted(r["routes"]),
                    "prefill_capture_s_by_key": r["capture_s_by_key"],
                    **({"warm_ttft": r["warm_ttft"]} if "warm_ttft" in r else {})}
             for name, r in runs.items()},
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card})
    if not all(same.values()):
        raise RuntimeError(f"tokens differ within a group of runs: {same}")
    if not all(logits_equal.values()):
        raise RuntimeError(f"the first decode steps' logits differ within a group: {logits_equal}")
    if not counts_ok:
        raise RuntimeError(f"launches {[runs[n]['counts'] for n in runs]}, expected {expect}")
    if not routes_ok:
        raise RuntimeError(f"routes {[sorted(runs[n]['routes']) for n in runs]}")
    if not graphs_ok:
        raise RuntimeError(f"graphs {[graph_report(runs[n]['stats']) for n in runs]}")
    for phase, is_fused, scan, graphs in (("profile_scan_unrolled", False, False, False),
                                          ("profile_scan_scan", False, True, False),
                                          ("profile_scan_captured", False, True, True),
                                          ("profile_scan_captured_unrolled", False, False, True),
                                          ("profile_scan_captured_fused", True, True, True)):
        eng = ContinuousBatchingEngine(fused if is_fused else params, cfg, max_batch=8,
                                       paged=False, scan_layers=scan, graphs=graphs, device="cuda")
        for p in prompts:
            eng.submit(Request(prompt_tokens=p, max_new_tokens=n_new))
        eng.step()                              # admits and prefills all 8, then one decode
        profile_steps(eng, card, phase)
        del eng
    return runs["captured_scan"]["counts"]


REPO = Path(__file__).resolve().parent
TINY_CKPT = REPO / "checkpoints" / "tiny_en_5m"
NLL_TOL = 2e-3             # nats/byte, card against the plain port on the CPU
NLL_REL_TOL_W2 = 1e-2      # W2 gs 32 (nll about 2.76) sits in the chaotic regime
# PARITY.md's nll/byte on the same eval, computed by the JAX package (its
# backend is not recorded there); A8W8 has no row
PARITY_NLL = {"dense_bf16": 0.1972, "a16w8": 0.1976, "w8_gs128": 0.1973, "w4_gs128": 0.3076,
              "w4_gs64": 0.2740, "w2_gs32": 2.7584, "a8w8": None, "a16w8_fp8": None,
              "a8w8_fp8": None, "a8w4_gs64": None, "a16w4_mxfp": None, "a8w8_mxfp": None,
              "a4w4_nvfp": None}
# the engines serve these (the stacked kernel takes W4, A16W8_FP8 and A16W4_MXFP;
# A8W4 serves on the decode and prefill kernels' mode 1-3 form)
RW_SERVED = {"w4_gs128": True, "a8w8": False, "a16w8_fp8": True, "a16w4_mxfp": True,
             "a8w4_gs64": False}
EVAL_WINDOWS, EVAL_SEQ, EVAL_BATCH, EVAL_CHECKED = 256, 512, 4, 16
# the configurations whose M 2048 batches (the first 4 windows) are held to
# the CPU plain port too: A8W4's run the prefill kernel's mode 1-3 form there,
# and its M 8192 batch the general fused kernel
RW_GATED_M2048 = ("a8w4_gs64",)
RW_PROMPT_LENS = (64, 100, 150, 200, 256, 300, 350, 400)
RW_PROMPT_START = 140_000   # past the eval's 256 x 512 bytes


def real_weight_configs(dense, device: str):
    """PARITY.md's rows, A8W8, the FP8 slice's A16W8_FP8, A8W8_FP8_dynamic and
    A8W4_HQQ_INT_dynamic gs 64, and the MX slice's A16W4_MXFP,
    A8W8_MXFP_dynamic and A4W4_NVFP_dynamic, each built from the imported
    dense model on its device."""
    from gemlite_tpu_torch import mx, quantize_llama
    from gemlite_tpu_torch.helper import (A16W8_FP8, A16W8_INT8, A8W4_HQQ_INT_dynamic,
                                          A8W8_FP8_dynamic, A8W8_INT8_dynamic)
    bf16 = torch.bfloat16
    return {
        "dense_bf16": lambda: dense,
        "a16w8": lambda: quantize_llama(dense, processor=A16W8_INT8(device=device, dtype=bf16)),
        "a8w8": lambda: quantize_llama(dense, processor=A8W8_INT8_dynamic(device=device,
                                                                         dtype=bf16)),
        "w8_gs128": lambda: quantize_llama(dense, W_nbits=8, group_size=128, device=device),
        "w4_gs128": lambda: quantize_llama(dense, W_nbits=4, group_size=128, device=device),
        "w4_gs64": lambda: quantize_llama(dense, W_nbits=4, group_size=64, device=device),
        "w2_gs32": lambda: quantize_llama(dense, W_nbits=2, group_size=32, device=device),
        "a16w8_fp8": lambda: quantize_llama(dense, processor=A16W8_FP8(device=device, dtype=bf16)),
        "a8w8_fp8": lambda: quantize_llama(dense, processor=A8W8_FP8_dynamic(device=device,
                                                                           dtype=bf16)),
        "a8w4_gs64": lambda: quantize_llama(dense, processor=A8W4_HQQ_INT_dynamic(
            device=device, dtype=bf16), group_size=64),
        "a16w4_mxfp": lambda: quantize_llama(dense, processor=mx.A16W4_MXFP(device=device)),
        "a8w8_mxfp": lambda: quantize_llama(dense, processor=mx.A8W8_MXFP_dynamic(device=device)),
        "a4w4_nvfp": lambda: quantize_llama(dense, processor=mx.A4W4_NVFP_dynamic(device=device)),
    }


def eval_nll(params, cfg, windows: torch.Tensor, batch: int) -> float:
    """Mean next-byte nll (nats) over (R, S + 1) windows, ``batch`` windows
    a call to loss_fn."""
    from gemlite_tpu_torch import loss_fn
    total = 0.0
    for i in range(0, windows.shape[0], batch):
        w = windows[i:i + batch]
        total += float(loss_fn(params, cfg, w[:, :-1], w[:, 1:])) * w.shape[0]
    return total / windows.shape[0]


def serve_real(params, cfg, prompts, n_new: int, scan: bool) -> dict:
    """The paged engine (the default: prefix cache on, page 128), the dense
    engine and, for a layer the stacked kernel takes, the scan engine, all
    captured, each against its bare loop token for token."""
    from gemlite_tpu_torch import ContinuousBatchingEngine
    runs = {"paged": dict(), "dense": dict(paged=False)}
    if scan:
        runs["scan"] = dict(paged=False, scan_layers=True)
    out = {}
    for name, kw in runs.items():
        eng = ContinuousBatchingEngine(params, cfg, max_batch=8, device="cuda", **kw)
        t0 = time.perf_counter()
        got = eng.generate(prompts, max_new_tokens=n_new)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        if name == "paged":
            want = bare_paged_loop(params, cfg, prompts, n_new, eng.buckets, eng.page_size)
        else:
            want = bare_loop(params, cfg, prompts, n_new, eng.buckets, eng.decode_buckets)
        stats = eng.stats()
        out[name] = {"equal_bare_loop": got == want, "wall_s": wall_s,
                     "graphs": graph_report(stats),
                     "captured": captured_throughout(stats) and prefills_captured(stats),
                     "tokens": got}
    return out


def phase_real_weights(card: str) -> None:
    """The repo's trained checkpoint (checkpoints/tiny_en_5m, a byte-level
    Llama: 6 layers, hidden 256, 4/2 heads of 64) imported on the card by
    load_hf_llama, in thirteen configurations: the nll of PARITY.md's eval (256
    held-out windows of 512 bytes) by loss_fn in batches of 4 windows (M
    2048), the first 16 windows again as one batch (M 8192), and the same 16
    through the plain versions on the CPU (the same packed layers copied
    there): |card - CPU| <= 2e-3 nats/byte (1% relative for W2 gs 32). The
    layers quantized on the card must equal, byte for byte, those quantized
    from the same weights on the CPU (which equal the JAX package's:
    tests/test_torch_real_weights.py). A8W4 gs 64 (RW_GATED_M2048) is also
    held to the CPU on its first 4 windows at M 2048, where its linears run
    the prefill kernel's mode 1-3 form (its M 8192 batch the dequantize kernel).
    Then W4 gs 128, A8W8, A16W8_FP8, A16W4_MXFP and A8W4 gs 64 serve 8
    held-out prompts of 64-400 bytes, 32 greedy tokens each, on the paged,
    dense and (W4,
    A16W8_FP8, A16W4_MXFP) scan engines, each equal to its bare loop, and
    the W8 gs 128 model with its W4 gs 128 draft on the speculative engines
    (``serve_real_spec``). Every kernel of the kernels line but the general
    MX entry (no tiny_en_5m linear is off the fold rule) must launch. Returns
    each configuration's launch counts."""
    from gemlite_tpu_torch import load_hf_llama

    reset_counts()
    t0 = time.perf_counter()
    dense, cfg = load_hf_llama(str(TINY_CKPT), device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    data = np.frombuffer((TINY_CKPT / "holdout.txt").read_bytes(), np.uint8)
    windows = torch.from_numpy(np.stack(
        [data[i * EVAL_SEQ:(i + 1) * EVAL_SEQ + 1] for i in range(EVAL_WINDOWS)]).astype(
            np.int64)).cuda()
    checked_cpu = windows[:EVAL_CHECKED].cpu()
    rows, failed, served = {}, [], {}
    on_cpu = real_weight_configs(_params_to_cpu(dense), "cpu")
    for name, build_params in real_weight_configs(dense, "cuda").items():
        before = read_counts()
        t0 = time.perf_counter()
        params = build_params()
        torch.cuda.synchronize()
        quant_s = time.perf_counter() - t0
        params_cpu = _params_to_cpu(params)
        same_bytes = trees_equal(params_cpu, on_cpu[name]())
        with torch.no_grad():
            t0 = time.perf_counter()
            with RouteLog() as card_routes:
                nll = eval_nll(params, cfg, windows, EVAL_BATCH)
                nll16 = eval_nll(params, cfg, windows[:EVAL_CHECKED], EVAL_CHECKED)
            eval_s = time.perf_counter() - t0
            nll4 = eval_nll(params, cfg, windows[:EVAL_BATCH], EVAL_BATCH)
            with RouteLog() as cpu_routes:
                nll16_cpu = eval_nll(params_cpu, cfg, checked_cpu, EVAL_CHECKED)
                nll4_cpu = eval_nll(params_cpu, cfg, checked_cpu[:EVAL_BATCH], EVAL_BATCH)
        gap = abs(nll16 - nll16_cpu)
        bound = NLL_REL_TOL_W2 * nll16_cpu if name == "w2_gs32" else NLL_TOL
        if name in RW_GATED_M2048:
            gap = max(gap, abs(nll4 - nll4_cpu))
        plain_on_card = [r for r in card_routes.linears | card_routes.attention
                         if r.startswith("plain")]
        rows[name] = {"nll": nll, "bits_per_byte": nll / float(np.log(2)),
                      "nll_first16_m8192": nll16, "nll_first16_cpu_plain": nll16_cpu,
                      "card_minus_cpu": nll16 - nll16_cpu, "gate": bound,
                      "nll_first4_m2048": nll4, "nll_first4_cpu_plain": nll4_cpu,
                      "card_minus_cpu_m2048": nll4 - nll4_cpu,
                      "gated_at_m2048": name in RW_GATED_M2048,
                      "jax_package_parity_md": PARITY_NLL[name],
                      "packed_on_card_equals_cpu": same_bytes,
                      "routes_card": card_routes.report(), "routes_cpu": cpu_routes.report(),
                      "quantize_s": quant_s, "eval_s": eval_s}
        if gap > bound or plain_on_card or not same_bytes or not np.isfinite(nll):
            failed.append(name)
        if name in RW_SERVED:
            prompts = [data[RW_PROMPT_START + 12_000 * i:RW_PROMPT_START + 12_000 * i + n].tolist()
                       for i, n in enumerate(RW_PROMPT_LENS)]
            served[name] = serve_real(params, cfg, prompts, 32, scan=RW_SERVED[name])
        rows[name]["launches"] = {k: v - before[k] for k, v in read_counts().items()
                                  if v != before[k]}
        del params
    spec_prompts = [data[RW_PROMPT_START + 12_000 * i:RW_PROMPT_START + 12_000 * i + n].tolist()
                    for i, n in enumerate(RW_PROMPT_LENS)]
    spec = serve_real_spec(dense, cfg, spec_prompts)
    counts = read_counts()
    runs_ok = all(r["equal_bare_loop"] and r["captured"] for s in served.values()
                  for r in s.values())
    sample = served["w4_gs128"]["paged"]["tokens"][0]
    text = bytes(data[RW_PROMPT_START:RW_PROMPT_START + RW_PROMPT_LENS[0]]).decode(
        "utf-8", "replace")
    # every tiny_en_5m linear folds (K and N multiples of 128), so the general
    # MX entry cannot run here: serve_mx_unfolded is its path, and the mode 1-3
    # prefill runs only its persistent kernel (prefill_modes_ragged takes N off
    # 8: kernels_modes runs it); no configuration here is channel-wise A16Wn,
    # whose stacked entry serve_scan_cw runs
    silent = [k for k, v in counts.items()
              if v < 1 and k not in ("mx_general", "decode_modes_stacked",
                                     "prefill_modes_ragged")]
    ok = not failed and runs_ok and spec["ok"] and not silent
    emit({"phase": "real_weights", "ok": ok,
          "model": "checkpoints/tiny_en_5m (trained byte-level Llama, 6 layers, hidden 256, "
                   "4/2 heads of 64)",
          "eval": f"{EVAL_WINDOWS} x {EVAL_SEQ} held-out bytes, batches of {EVAL_BATCH} "
                  f"windows; first {EVAL_CHECKED} as one batch, on the card and on the CPU",
          "load_s": load_s, "configs": rows,
          "serve": {k: {e: {kk: vv for kk, vv in r.items() if kk != "tokens"}
                        for e, r in v.items()} for k, v in served.items()},
          "prompt_lens": list(RW_PROMPT_LENS), "new_tokens": 32,
          "continuation_w4_gs128_paged": {"prompt": text, "generated": bytes(sample).decode(
              "utf-8", "replace")},
          "spec_w8_target_w4_draft": spec, "launches": counts, "card": card})
    if failed:
        raise RuntimeError(f"real_weights: card nll against the plain port failed for {failed}: "
                           f"{ {k: rows[k] for k in failed} }")
    if not runs_ok:
        raise RuntimeError("real_weights: engine tokens differ from the bare loops")
    if not spec["ok"]:
        raise RuntimeError(f"real_weights: speculative decoding failed: {spec}")
    if silent:
        raise RuntimeError(f"real_weights: kernels never launched: {silent} in {counts}")
    return {name: row["launches"] for name, row in rows.items()}


SPEC_G = 4
SPEC_NEW = 32


def llama32_1b_draft():
    """Llama-3.2-1B's widths (hidden 2048, intermediate 8192, 32/8 heads of
    64, vocab 128256, rope_theta 500000) cut to 2 of its 16 layers, random
    weights from its own seed, W4 gs 128 on the card: the draft of serve_spec."""
    from gemlite_tpu_torch import LlamaConfig, init_llama, quantize_llama
    dcfg = LlamaConfig(vocab_size=128256, hidden_size=2048, intermediate_size=8192, num_layers=2,
                       num_heads=32, num_kv_heads=8, head_dim=64, rope_theta=500000.0,
                       max_seq_len=512)
    gen = torch.Generator(device="cuda").manual_seed(1)
    dense = init_llama(dcfg, generator=gen, device="cuda")
    return quantize_llama(dense, W_nbits=4, group_size=128, device="cuda"), dcfg


def bare_prefill(params, cfg, prompts, buckets, page_size=None):
    """Each prompt prefilled in its bucket as the engine does, into its own
    stripe of a dense cache or, with ``page_size``, its own pages: (kv, lens
    (B,), the logits (B, V) at each prompt's last position)."""
    from gemlite_tpu_torch.models.llama import init_kv_cache, llama_forward
    from gemlite_tpu_torch.models.paged_kv import init_paged_kv
    from gemlite_tpu_torch.serving import _next_bucket
    if page_size:
        kv = init_paged_kv(cfg, len(prompts), page_size, device="cuda")  # slot b: its own pages
    else:
        kv = init_kv_cache(cfg, len(prompts), device="cuda")
    last = []
    for i, p in enumerate(prompts):
        padded = torch.zeros((1, _next_bucket(len(p), buckets)), dtype=torch.int32, device="cuda")
        padded[0, :len(p)] = torch.tensor(p, dtype=torch.int32)
        view = kv.with_table(kv.table[i:i + 1]) if page_size else kv[:, :, i:i + 1]
        logits, _ = llama_forward(params, cfg, padded, kv=view, cache_len=0)
        last.append(logits[0, len(p) - 1])
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device="cuda")
    return kv, lens, torch.stack(last)


def cache_copy(kv):
    from gemlite_tpu_torch.models.paged_kv import PagedKV
    return PagedKV(kv.pages.clone(), kv.table, kv.page_size) if isinstance(kv, PagedKV) \
        else kv.clone()


def self_draft_burst(params, cfg, prompts, buckets, decode_buckets, g, page_size=None,
                     blocks=True) -> dict:
    """The first burst of a self-draft (draft = target), greedy, on the model
    API: g decode steps drafting their argmax, then the verify step over the
    slot's token and its drafts, each on its own copy of the prefilled cache:
    dense, or with ``page_size`` paged, where the decode steps attend on the
    paged decode kernel as the plain engine's do and the verify step over the
    gathered pages. ``max_dlogit``: the largest |draft logit - verify logit|
    at the same positions (M B and M B (g + 1) reach the argmax by different
    sums); tau = 4 x that, the bound of a near-tie on the cache the
    comparison runs on. With ``blocks`` (dense), each block is also fed the verify path's
    input at every position, once as the verify step (S g + 1) and once as g +
    1 decode steps (S 1), and the two outputs are held to mean|a-b| / mean|b|
    <= 5e-3 (``first_step_check``'s form)."""
    from gemlite_tpu_torch.models import llama as L
    from gemlite_tpu_torch.serving import _next_bucket
    kv, lens, last = bare_prefill(params, cfg, prompts, buckets, page_size)
    tok = torch.argmax(last.float(), dim=-1).to(torch.int32)[:, None]
    t_act = _next_bucket(int(lens.max()) + g + 1, decode_buckets)
    dkv, dl, t, dlogits, drafts = cache_copy(kv), lens, tok, [], []
    for _ in range(g):
        lg, _ = L.llama_decode_step_batched(params, cfg, t, dkv, dl,
                                            t_active=None if page_size else t_act)
        dlogits.append(lg[:, 0].float())
        t = torch.argmax(lg[:, 0].float(), dim=-1).to(torch.int32)[:, None]
        drafts.append(t)
        dl = dl + 1
    seq = torch.cat([tok] + drafts, dim=1)
    vlogits, _ = L.llama_verify_step(params, cfg, seq, cache_copy(kv), lens, t_active=t_act)
    delta = float((vlogits[:, :g].float() - torch.stack(dlogits, dim=1)).abs().max())
    out = {"cache": "paged" if page_size else "dense", "t_active": t_act, "max_dlogit": delta,
           "tau": 4 * delta}
    if blocks:
        stages = {}
        x = params["embed"][seq]
        pos = lens[:, None] + torch.arange(g + 1, dtype=torch.int32, device="cuda")[None]
        kv_v, kv_d = kv.clone(), kv.clone()
        for i, blk in enumerate(params["blocks"]):
            out_v = L._block_forward(blk, cfg, x, pos, kv_v, i, lens, t_act)
            out_d = torch.cat([L._block_forward(blk, cfg, x[:, j:j + 1], pos[:, j:j + 1], kv_d, i,
                                                lens + j, t_act) for j in range(g + 1)], dim=1)
            stages[f"block{i}"] = _mean_max(out_d, out_v)
            x = out_v
        h = L._rms_norm(x, params["ln_f"], cfg.norm_eps)
        stages["head"] = _mean_max(torch.cat([L._apply(params["lm_head"], h[:, j:j + 1])
                                              for j in range(g + 1)], dim=1),
                                   L._apply(params["lm_head"], h))
        out["stages"] = stages
        out["stages_ok"] = all(v["mean_rel"] <= REL_TOL for v in stages.values())
    return out


def plain_gaps(params, cfg, prompts, outs, buckets, decode_buckets, page_size=None):
    """The top-2 logit gap of the plain greedy path at every generated
    position: a bare loop in the engine's shapes on its cache (dense, or
    paged with ``page_size``), fed ``outs`` (the plain engine's tokens).
    gaps[i][k] is the gap of the logits that chose outs[i][k]."""
    from gemlite_tpu_torch.models.llama import llama_decode_step_batched
    from gemlite_tpu_torch.serving import _next_bucket

    def gap(rows):
        top = torch.topk(rows.float(), 2, dim=-1).values
        return (top[:, 0] - top[:, 1]).tolist()

    kv, lens, last = bare_prefill(params, cfg, prompts, buckets, page_size)
    gaps = [[d] for d in gap(last)]
    for k in range(1, max(len(o) for o in outs)):
        t_act = None if page_size else _next_bucket(int(lens.max()) + 1, decode_buckets)
        tok = torch.tensor([[o[min(k - 1, len(o) - 1)]] for o in outs], dtype=torch.int32,
                           device="cuda")
        logits, _ = llama_decode_step_batched(params, cfg, tok, kv, lens, t_active=t_act)
        for i, d in enumerate(gap(logits[:, 0])):
            gaps[i].append(d)
        lens = lens + 1
    return gaps


def parted(spec_tokens, plain_tokens, gaps, tau) -> list:
    """Every request whose spec tokens part from the plain engine's: the first
    parted position and the plain path's top-2 gap there, against tau."""
    cases = []
    for i, (a, b) in enumerate(zip(spec_tokens, plain_tokens)):
        if a != b:
            k = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
            cases.append({"request": i, "position": k, "plain_gap": gaps[i][k],
                          "near_tie": gaps[i][k] < tau})
    return cases


def spec_serve(eng, prompts, n_new, temperature=0.0, rejection_gaps=False) -> dict:
    """Serve ``prompts`` on a speculative engine step by step, reading after
    each burst its packed result (the burst's own download, already on the
    host) to count proposals and acceptances of the active slots; with
    ``rejection_gaps`` also the verify logits' top-2 gap at every rejected
    position. Returns tokens, counters and the host-clock time."""
    from gemlite_tpu_torch import Request
    reqs = [Request(prompt_tokens=p, max_new_tokens=n_new, temperature=temperature)
            for p in prompts]
    for r in reqs:
        eng.submit(r)
    B, g = eng.max_batch, eng.spec_tokens
    proposed = accepted = bursts = 0
    rejections = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.queue or eng.num_active:
        active = [r is not None and eng.slot_pending[i] is None for i, r in enumerate(eng.slot_req)]
        before = eng._counters["spec_steps"]
        eng.step()
        if eng._counters["spec_steps"] == before:
            continue
        bursts += 1
        n_acc = eng._spec_static["packed"].tolist()[B * g + B:]
        for slot in range(B):
            if not active[slot]:
                continue
            proposed += g
            accepted += n_acc[slot]
            if rejection_gaps and n_acc[slot] < g:
                top = torch.topk(eng.last_logits[slot, n_acc[slot]].float(), 2).values
                rejections.append({"burst": bursts, "slot": slot, "position": n_acc[slot],
                                   "verify_gap": float(top[0] - top[1])})
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    finished = {r.request_id: r.output_tokens for r in eng.finished}
    eng.finished = []
    stats = eng.stats()
    return {"tokens": [finished[r.request_id] for r in reqs], "wall_s": wall_s,
            "tokens_out": stats["tokens_out"], "tokens_per_s_host_clock": stats["tokens_out"] / wall_s,
            "steps": stats["steps"], "spec_steps": stats["spec_steps"],
            "decode_steps": stats["decode_steps"],
            "tokens_per_engine_step": stats["tokens_out"] / max(stats["steps"], 1),
            "acceptance": accepted / max(proposed, 1),
            "accepted_per_burst": accepted / max(proposed // g, 1),
            "graphs": graph_report(stats), "rejections": rejections,
            "prefills_ok": (prefills_captured(stats) if eng.graphs
                            else stats["prefill_captures"] == 0)}


def spec_schedule(cfg, dcfg, prompts, run: dict, g: int, paged: bool) -> dict:
    """The launches a spec run must make: 7 linears a layer a forward; the
    target and the draft prefill every prompt (M <= 64 on the decode kernel,
    the 128 bucket on the prefill kernel); a burst is g + 1 draft decode steps
    and one verify over B (g + 1) = 40 rows, all on the decode kernel; a
    plain step one decode step of the target (and, paged, one paged decode a
    layer)."""
    L, dL = 7 * cfg.num_layers, 7 * dcfg.num_layers
    short = sum(len(p) <= 64 for p in prompts)
    long_ = len(prompts) - short
    want = {k: 0 for k in read_counts()}
    want["decode"] = (L * (short + run["decode_steps"] + run["spec_steps"])
                      + dL * (short + (g + 1) * run["spec_steps"]))
    want["prefill"] = (L + dL) * long_
    if paged:
        want["paged_decode"] = cfg.num_layers * run["decode_steps"]
    return want


def phase_serve_spec(card: str, cfg, params) -> dict:
    """Speculative decoding on serve's 4-layer Llama-3-8B-width W4 gs 128
    target, gamma 4, max_batch 8, serve's 8 requests, 32 new tokens.

    1. Self-draft (draft = target), greedy, on the dense cache: the first
       burst's verify step against its draft steps block by block (each block
       fed the verify path's input; mean form <= 5e-3); tau = 4 x the largest
       |draft logit - verify logit| at the same positions; every rejection of
       the captured engine at a near-tie (the verify logits' top-2 gap < tau).
    2. A Llama-3.2-1B-width draft (2 of 16 layers, W4 gs 128), greedy, on the
       dense cache and on the paged engine: captured = eager (graphs=False)
       token for token; against the plain captured engine equal, or where a
       request parts, the plain path's top-2 gap at the first parted
       position < tau of that cache (on the paged one the plain engine
       attends on the paged decode kernel, the verify step over the
       gathered pages: its tau comes from a self-draft burst there).
    3. Self-draft at temperature 0.8: two runs from one seed equal, every
       token in the vocabulary.
    Every run: launches equal the schedule (``spec_schedule``), linears only
    on the decode and prefill kernels, no plain attention; on the captured
    engines every prefill after the first of its bucket a replay of a graph
    that holds the target's and the draft's prefill. Reported: the
    acceptance, tokens a step, host-clock tokens/s beside the plain captured
    engine, captures, capture time and graph pool. Returns the launch counts
    of the 1B-draft dense run."""
    from gemlite_tpu_torch import ContinuousBatchingEngine
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in SERVE_PROMPT_LENS]
    g = SPEC_G
    t0 = time.perf_counter()
    draft = llama32_1b_draft()
    draft_s = time.perf_counter() - t0

    def engine(dr=None, **kw):
        if dr is not None:
            kw.update(draft=dr, spec_tokens=g)
        return ContinuousBatchingEngine(params, cfg, max_batch=8, device="cuda", **kw)

    probe = engine()
    buckets, decode_buckets, page_size = probe.buckets, probe.decode_buckets, probe.page_size
    del probe
    burst = self_draft_burst(params, cfg, prompts, buckets, decode_buckets, g)
    burst_paged = self_draft_burst(params, cfg, prompts, buckets, decode_buckets, g, page_size,
                                   blocks=False)
    tau = burst["tau"]
    taus = {"dense": tau, "paged": burst_paged["tau"]}

    runs, bad, counts_1b = {}, [], None
    plans = (("self_greedy_dense", (params, cfg), dict(paged=False), 0.0),
             ("draft1b_dense", draft, dict(paged=False), 0.0),
             ("draft1b_dense_eager", draft, dict(paged=False, graphs=False), 0.0),
             ("draft1b_paged", draft, dict(), 0.0),
             ("draft1b_paged_eager", draft, dict(graphs=False), 0.0),
             ("self_sampled_a", (params, cfg), dict(paged=False, seed=5), 0.8),
             ("self_sampled_b", (params, cfg), dict(paged=False, seed=5), 0.8))
    for name, dr, kw, temp in plans:
        eng = engine(dr, **kw)
        reset_counts()
        with RouteLog() as log:
            run = spec_serve(eng, prompts, SPEC_NEW, temp, rejection_gaps=name == "self_greedy_dense")
        counts = read_counts()
        want = spec_schedule(cfg, dr[1], prompts, run, g, paged=eng.paged)
        run.update(launches=counts, launches_expected=want, routes=log.report(),
                   launches_ok=counts == want,
                   routes_ok=set(log.linears) <= {"decode", "prefill"}
                   and not any(a.startswith("plain") for a in log.attention))
        if name.startswith("draft1b") and not name.endswith("eager") and "dense" in name:
            counts_1b = counts
        if not (run["launches_ok"] and run["routes_ok"] and run["prefills_ok"]):
            bad.append(name)
        runs[name] = run
        del eng

    plain = {}
    for kind, kw in (("dense", dict(paged=False)), ("paged", dict())):
        eng = engine(**kw)
        t0 = time.perf_counter()
        toks = eng.generate(prompts, max_new_tokens=SPEC_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = eng.stats()
        plain[kind] = {"tokens": toks, "wall_s": wall,
                       "tokens_per_s_host_clock": st["tokens_out"] / wall,
                       "tokens_per_engine_step": st["tokens_out"] / st["steps"],
                       "graphs": graph_report(st)}
        del eng
    gaps = {k: plain_gaps(params, cfg, prompts, v["tokens"], buckets, decode_buckets,
                          page_size if k == "paged" else None) for k, v in plain.items()}

    # 1. self-draft: every rejection at a near-tie of the verify logits
    rej = runs["self_greedy_dense"]["rejections"]
    far = [r for r in rej if not r["verify_gap"] < tau]
    if not burst["stages_ok"] or far:
        bad.append("self_greedy_dense")
    # 2. 1B draft: captured = eager; against the plain engine, near ties only
    cases = {}
    for kind in ("dense", "paged"):
        cap, eag = runs[f"draft1b_{kind}"], runs[f"draft1b_{kind}_eager"]
        if cap["tokens"] != eag["tokens"]:
            bad.append(f"draft1b_{kind}: captured != eager")
        cases[kind] = parted(cap["tokens"], plain[kind]["tokens"], gaps[kind], taus[kind])
        if not all(c["near_tie"] for c in cases[kind]):
            bad.append(f"draft1b_{kind}: parted from the plain engine off a near-tie")
    # 3. sampled self-draft: one seed, one answer
    sa, sb = runs["self_sampled_a"]["tokens"], runs["self_sampled_b"]["tokens"]
    if sa != sb or not all(0 <= t < cfg.vocab_size for o in sa for t in o):
        bad.append("self_sampled")

    def summary(r):
        return {k: v for k, v in r.items() if k not in ("tokens",)}

    emit({"phase": "serve_spec", "ok": not bad, "failed": bad,
          "target": "serve's Llama-3-8B widths, 4 of 32 layers (depth cut), W4 gs 128",
          "draft_1b": "Llama-3.2-1B widths, 2 of 16 layers (depth cut), W4 gs 128, seed 1",
          "gamma": g, "requests": len(prompts), "new_tokens": SPEC_NEW,
          "draft_quantize_s": draft_s,
          "self_draft_first_burst": burst, "self_draft_first_burst_paged": burst_paged,
          "tau": taus,
          "self_draft_rejections": len(rej), "self_draft_rejections_off_near_tie": far,
          "parted_from_plain": cases, "runs": {k: summary(v) for k, v in runs.items()},
          "plain": {k: summary(v) for k, v in plain.items()}, "card": card})
    if bad:
        raise RuntimeError(f"serve_spec failed: {bad}")
    return counts_1b


RW_SPEC_NEW = 96
# the JAX package's record (SERVING.md section 7, its own engine counters):
# W8 target, W4 draft, gamma 4, 8 slots x 96 greedy tokens
JAX_SPEC_RECORD = {"tokens_per_engine_step": 25.6, "accepted_per_burst": 2.2}


def serve_real_spec(dense, cfg, prompts) -> dict:
    """tiny_en_5m's W8 gs 128 target with its W4 gs 128 draft, gamma 4, 8
    slots, 96 greedy tokens, on the dense and the paged engines (captured):
    tokens equal the plain engine's, or where a request parts, the plain
    path's top-2 gap at the first parted position is under this model's tau
    (4 x the largest |draft - verify logit| of one self-draft burst of the W8
    target on that cache). Acceptance and tokens a step are reported beside
    the JAX package's record, ungated."""
    from gemlite_tpu_torch import ContinuousBatchingEngine, quantize_llama
    from gemlite_tpu_torch.ops.dispatch import KERNEL_ROUTES
    w8 = quantize_llama(dense, W_nbits=8, group_size=128, device="cuda")
    w4 = quantize_llama(dense, W_nbits=4, group_size=128, device="cuda")
    probe = ContinuousBatchingEngine(w8, cfg, max_batch=8, device="cuda")
    buckets, decode_buckets, page_size = probe.buckets, probe.decode_buckets, probe.page_size
    del probe
    out, ok = {"jax_package_record": JAX_SPEC_RECORD}, True
    for kind, kw in (("dense", dict(paged=False)), ("paged", dict())):
        ps = page_size if kind == "paged" else None
        burst = self_draft_burst(w8, cfg, prompts, buckets, decode_buckets, SPEC_G, ps,
                                 blocks=False)
        tau = burst["tau"]
        with RouteLog() as log:
            eng = ContinuousBatchingEngine(w8, cfg, max_batch=8, device="cuda", draft=(w4, cfg),
                                           spec_tokens=SPEC_G, **kw)
            run = spec_serve(eng, prompts, RW_SPEC_NEW)
        del eng
        plain = ContinuousBatchingEngine(w8, cfg, max_batch=8, device="cuda", **kw)
        t0 = time.perf_counter()
        want = plain.generate(prompts, max_new_tokens=RW_SPEC_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = plain.stats()
        del plain
        cases = parted(run["tokens"], want, plain_gaps(w8, cfg, prompts, want, buckets,
                                                       decode_buckets, ps), tau)
        routes_ok = (set(log.linears) <= set(KERNEL_ROUTES)
                     and not any(a.startswith("plain") for a in log.attention))
        ok = ok and routes_ok and all(c["near_tie"] for c in cases)
        out[kind] = {**{k: v for k, v in run.items() if k != "tokens"},
                     "self_draft_burst_w8": burst, "tau": tau,
                     "equal_plain_engine": run["tokens"] == want, "parted_from_plain": cases,
                     "routes": log.report(), "routes_ok": routes_ok,
                     "plain_tokens_per_s_host_clock": st["tokens_out"] / wall,
                     "plain_tokens_per_engine_step": st["tokens_out"] / st["steps"]}
    out["ok"] = ok
    return out


def tree_nbytes(tree) -> int:
    from gemlite_tpu_torch import GemLiteLinear
    if isinstance(tree, GemLiteLinear):
        return sum(t.numel() * t.element_size() for t in tree.state_dict().values())
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    return 0 if tree is None else tree.numel() * tree.element_size()


def trees_equal(a, b) -> bool:
    """Bit for bit: every tensor, and every layer's metadata and tensors."""
    from gemlite_tpu_torch import GemLiteLinear
    if isinstance(a, GemLiteLinear):
        sa, sb = a.state_dict(), b.state_dict()
        return (isinstance(b, GemLiteLinear) and a.get_meta_args() == b.get_meta_args()
                and sorted(sa) == sorted(sb) and all(trees_equal(sa[k], sb[k]) for k in sa))
    if isinstance(a, dict):
        return isinstance(b, dict) and sorted(a) == sorted(b) and all(
            trees_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(trees_equal(x, y) for x, y in zip(a, b))
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


CKPT_SHARD_BYTES = 2_500_000_000     # the 3.85 GB export in two shards


def phase_checkpoint_8b(card: str, cfg, dense, w4_params, serve_tokens) -> None:
    """The slice at full width (4 of 32 layers): serve's dense model exported
    as an HF checkpoint (two shards and an index), imported back bit for
    bit, quantized to W4 gs 128 into the bytes of serve's model, saved and
    loaded as one npz with the bytes unchanged, and served on serve's 8
    requests with serve's tokens. Raises when the disk is short."""
    import shutil
    import tempfile
    from gemlite_tpu_torch import (ContinuousBatchingEngine, export_hf_llama, load_hf_llama,
                                   load_model, quantize_llama, save_model)

    hf_bytes = tree_nbytes(dense)
    need = hf_bytes + tree_nbytes(w4_params) + (1 << 30)
    root = tempfile.mkdtemp()
    try:
        free = shutil.disk_usage(root).free
        if free < need:
            raise RuntimeError(f"checkpoint_8b needs {need} bytes of disk under {root}, "
                               f"{free} are free")
        hf_dir, npz = os.path.join(root, "hf"), os.path.join(root, "w4.npz")
        seconds, sizes = {}, {}
        t0 = time.perf_counter()
        files = export_hf_llama(dense, cfg, hf_dir, max_shard_bytes=CKPT_SHARD_BYTES)
        seconds["export"] = time.perf_counter() - t0
        sizes.update({os.path.basename(f): os.path.getsize(f) for f in files})
        index = os.path.join(hf_dir, "model.safetensors.index.json")
        sizes["model.safetensors.index.json"] = os.path.getsize(index)
        t0 = time.perf_counter()
        loaded, cfg2 = load_hf_llama(hf_dir, device="cuda")
        torch.cuda.synchronize()
        seconds["load_hf"] = time.perf_counter() - t0
        import_equal = trees_equal(dense, loaded) and cfg2 == cfg
        t0 = time.perf_counter()
        q = quantize_llama(loaded, W_nbits=4, group_size=128, device="cuda")
        torch.cuda.synchronize()
        seconds["quantize"] = time.perf_counter() - t0
        del loaded
        quant_equal = trees_equal(w4_params, q)
        t0 = time.perf_counter()
        save_model(q, npz)
        seconds["save_model"] = time.perf_counter() - t0
        sizes["w4.npz"] = os.path.getsize(npz)
        t0 = time.perf_counter()
        back = load_model(npz, device="cuda")
        torch.cuda.synchronize()
        seconds["load_model"] = time.perf_counter() - t0
        del q
        reload_equal = trees_equal(w4_params, back)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in SERVE_PROMPT_LENS]
        eng = ContinuousBatchingEngine(back, cfg, max_batch=8, paged=False, device="cuda")
        tokens_equal = eng.generate(prompts, max_new_tokens=32) == serve_tokens
        del eng, back
    finally:
        shutil.rmtree(root, ignore_errors=True)
    ok = len(files) == 2 and import_equal and quant_equal and reload_equal and tokens_equal
    emit({"phase": "checkpoint_8b", "ok": ok,
          "model": "Llama-3-8B widths, 4 of 32 layers (depth cut), serve's random bf16 weights",
          "bytes": sizes, "hf_bytes_expected": hf_bytes, "seconds": seconds,
          "import_bit_equal": import_equal, "quantized_bytes_equal_serve": quant_equal,
          "reloaded_bytes_equal": reload_equal, "tokens_equal_serve": tokens_equal,
          "disk_free_bytes": free, "card": card})
    if not ok:
        raise RuntimeError(f"checkpoint_8b failed: shards {len(files)}, import {import_equal}, "
                           f"quantize {quant_equal}, reload {reload_equal}, "
                           f"tokens {tokens_equal}")


# the seven linears of a Llama-3-8B block (N, K), by their HF names
BLOCK_8B = {"self_attn.q_proj": (4096, 4096), "self_attn.k_proj": (1024, 4096),
            "self_attn.v_proj": (1024, 4096), "self_attn.o_proj": (4096, 4096),
            "mlp.gate_proj": (14336, 4096), "mlp.up_proj": (14336, 4096),
            "mlp.down_proj": (4096, 14336)}
PATCH_MS = (8, 128)
PATCH_REL_TOL = 2e-2        # ||patched - float|| / ||float||: quantization error
# e4m3 rounds x and w each to 3 mantissa bits (about 2.5% rms a value), so
# the product's error is about 3.6%: tests/test_layer.py and
# tests/test_helpers.py hold the JAX package's fp8 layers to 8e-2
PATCH_REL_TOL_FP8 = 5e-2


def block_8b_model(seed: int):
    """An nn.Module tree of bf16 nn.Linears at an 8B block's shapes and an
    8B lm_head, initialised by torch from ``seed``."""
    from torch import nn
    torch.manual_seed(seed)

    def lin(shape):
        return nn.Linear(shape[1], shape[0], bias=False, device="cuda", dtype=torch.bfloat16)

    model = nn.Module()
    model.layers = nn.ModuleList([nn.Module()])
    for group in ("self_attn", "mlp"):
        setattr(model.layers[0], group, nn.ModuleDict(
            {k.split(".")[1]: lin(v) for k, v in BLOCK_8B.items() if k.startswith(group)}))
    model.lm_head = lin((128256, 4096))
    return model


def phase_patch_model(card: str) -> None:
    """patch_model over the 8B block tree with A16W8_INT8, A8W8_INT8_dynamic
    and A8W8_FP8_dynamic: every block linear replaced and the lm_head
    skipped; at M 8 and 128 each output within 2e-2 (norm-relative; 5e-2 for
    fp8 x and w) of the float nn.Linear on the same input, on the expected
    routes (A16W8: the float path; A8W8: int8 decode at M 8, the int path at
    M 128; A8W8_FP8: the fp8 decode and prefill kernels); forward_manual
    under each family name equal to forward bit for bit."""
    from gemlite_tpu_torch import GEMLITE_MATMUL_TYPES, GemLiteLinear, patch_model
    from gemlite_tpu_torch.helper import A16W8_INT8, A8W8_FP8_dynamic, A8W8_INT8_dynamic

    expected = {"A16W8_INT8": ({8: "general_fused", 128: "general_fused"},
                               {"fused_gemm_float": 2 * len(BLOCK_8B)}),
                "A8W8_INT8_dynamic": ({8: "int8_exact", 128: "general_fused"},
                                      {"int8_decode": len(BLOCK_8B), "fused_gemm": len(BLOCK_8B)}),
                "A8W8_FP8_dynamic": ({8: "decode", 128: "prefill"},
                                     {"fp8_decode": len(BLOCK_8B), "fp8_prefill": len(BLOCK_8B)})}
    tolerance = {"A16W8_INT8": PATCH_REL_TOL, "A8W8_INT8_dynamic": PATCH_REL_TOL,
                 "A8W8_FP8_dynamic": PATCH_REL_TOL_FP8}
    gen = torch.Generator(device="cuda").manual_seed(5)
    xs = {M: torch.randn((M, 14336), generator=gen, device="cuda").to(torch.bfloat16)
          for M in PATCH_MS}
    report, bad = {}, []
    for name, proc in (("A16W8_INT8", A16W8_INT8(device="cuda", dtype=torch.bfloat16)),
                       ("A8W8_INT8_dynamic", A8W8_INT8_dynamic(device="cuda",
                                                               dtype=torch.bfloat16)),
                       ("A8W8_FP8_dynamic", A8W8_FP8_dynamic(device="cuda",
                                                             dtype=torch.bfloat16))):
        ref, model = block_8b_model(11), block_8b_model(11)
        t0 = time.perf_counter()
        patch_model(model, proc)
        torch.cuda.synchronize()
        patch_s = time.perf_counter() - t0
        errs, routes, manual_equal = {}, {}, True
        reset_counts()
        for full, (N, K) in BLOCK_8B.items():
            group, key = full.split(".")
            lin = getattr(model.layers[0], group)[key]
            float_lin = getattr(ref.layers[0], group)[key]
            if not isinstance(lin, GemLiteLinear):
                bad.append(f"{name}: {full} not replaced")
                continue
            for M, x in xs.items():
                with RouteLog() as log, torch.no_grad():
                    got = lin(x[:, :K])
                    want = float_lin(x[:, :K])
                routes[f"{key}@{M}"] = log.report()["linears"]
                errs[f"{key}@{M}"] = float((got.float() - want.float()).norm()
                                           / want.float().norm())
                if log.report()["linears"] != [expected[name][0][M]]:
                    bad.append(f"{name}: {full} at M {M} took {log.report()['linears']}")
        counts = {k: v for k, v in read_counts().items() if v}
        for full in BLOCK_8B:
            group, key = full.split(".")
            lin = getattr(model.layers[0], group)[key]
            for M, x in xs.items():
                out = lin(x[:, :lin.in_features])
                manual_equal &= all(torch.equal(lin.forward_manual(x[:, :lin.in_features], f),
                                                out) for f in GEMLITE_MATMUL_TYPES)
        skipped = isinstance(model.lm_head, torch.nn.Linear)
        if max(errs.values()) > tolerance[name] or counts != expected[name][1] or \
                not manual_equal or not skipped:
            bad.append(f"{name}: max rel err {max(errs.values())}, launches {counts}, "
                       f"forward_manual equal {manual_equal}, lm_head skipped {skipped}")
        report[name] = {"patch_s": patch_s, "rel_err": errs, "tolerance": tolerance[name],
                        "routes": routes,
                        "launches": counts, "forward_manual_equals_forward": manual_equal,
                        "lm_head_skipped": skipped}
        del ref, model
    emit({"phase": "patch_model", "ok": not bad, "shapes": BLOCK_8B, "M": list(PATCH_MS),
          "processors": report, "card": card})
    if bad:
        raise RuntimeError(f"patch_model failed: {bad}")


def phase_warmup(card: str) -> None:
    """warmup(A16W4_HQQ_INT) over the four 8B shapes at the default buckets
    (1 to 1024): each layer on the decode kernel up to M 64 and on the
    prefill kernel above; a first call at M 5 and 700 after it builds and
    loads no kernel library."""
    from gemlite_tpu_torch import warmup
    from gemlite_tpu_torch.helper import A16W4_HQQ_INT
    from gemlite_tpu_torch.ops import build

    calls = []
    real_build = build.build
    build.build = lambda *a, **k: (calls.append(a), real_build(*a, **k))[1]
    try:
        with RouteLog() as log:
            t0 = time.perf_counter()
            layers = warmup(A16W4_HQQ_INT(device="cuda", dtype=torch.bfloat16), SHAPES,
                            device="cuda")
            warmup_s = time.perf_counter() - t0
        libs = set(build._LIBS)
        warm_calls = len(calls)
        gen = torch.Generator(device="cuda").manual_seed(6)
        t0 = time.perf_counter()
        for layer in layers:
            for M in (5, 700):
                layer(torch.randn((M, layer.in_features), generator=gen, device="cuda").to(
                    torch.bfloat16))
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        no_build = len(calls) == warm_calls and set(build._LIBS) == libs
    finally:
        build.build = real_build
    ok = no_build and log.report()["linears"] == ["decode", "prefill"]
    emit({"phase": "warmup", "ok": ok, "processor": "A16W4_HQQ_INT(bf16)", "shapes": SHAPES,
          "seconds": warmup_s, "routes": log.report()["linears"],
          "first_calls_after_s": first_s, "first_calls_built_nothing": no_build,
          "libraries_loaded": sorted(libs), "card": card})
    if not ok:
        raise RuntimeError(f"warmup: routes {log.report()}, a later first call built or loaded "
                           f"a library: {not no_build}")


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Drive the PyTorch port once on one NVIDIA card.")
    ap.add_argument("--old-mx-source", type=Path, default=None,
                    help="an earlier tree's gemlite_tpu_torch/csrc (the parent commit's): "
                         "kernels_mx also times its MX decode, stacked decode, prefill, csm-4 "
                         "and general entries beside the current ones (old_ms)")
    ap.add_argument("--old-prefill-source", type=Path, default=None,
                    help="an earlier tree's gemlite_tpu_torch/csrc (the parent commit's): "
                         "kernels_modes also times its gl_prefill_modes beside the current "
                         "mode 1-3 prefill (parent_ms)")
    ap.add_argument("--old-fp8-source", type=Path, default=None,
                    help="an earlier tree's gemlite_tpu_torch/csrc: kernels_fp8 also times its "
                         "fp8 decode and prefill entries beside the current ones (old_ms)")
    args = ap.parse_args()
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
    old_mx = start_old_mx_build(args.old_mx_source) if args.old_mx_source else None
    old_fp8 = start_old_fp8_build(args.old_fp8_source) if args.old_fp8_source else None
    old_prefill = (start_old_prefill_build(args.old_prefill_source)
                   if args.old_prefill_source else None)
    phase_build()
    timer = Timer()
    picked = phase_kernels(card, peak, timer)
    layer_counts = phase_layer(card)
    cfg, dense = dense_llama()
    serve_counts, w4_params, serve_tokens = phase_serve(card, cfg, dense)
    phase_serve_spec(card, cfg, w4_params)
    phase_checkpoint_8b(card, cfg, dense, w4_params, serve_tokens)
    picked.update(phase_kernels_attn(card, peak, timer))
    paged_counts = phase_serve_paged(card, cfg, w4_params)
    del w4_params
    picked.update(phase_kernels_a8(card, peak, timer))
    phase_layer_a8w8(card)
    a8_counts = phase_serve_a8w8(card, cfg, dense)
    a16_counts = phase_serve_a16w8(card, cfg, dense)
    picked.update(phase_kernels_fp8(card, peak, timer, old_fp8))
    fp8_layer_counts = phase_layer_fp8(card)
    fp8_counts = phase_serve_fp8(card, cfg, dense)
    picked.update(phase_kernels_modes(card, peak, timer, old_prefill and old_prefill()))
    picked.update(phase_kernels_dequantize_int(card, peak, timer))
    modes_counts = phase_serve_a8w4(card, cfg, dense)
    scan_cw_counts = phase_serve_scan_cw(card, cfg, dense)
    picked.update(phase_kernels_mx(card, peak, timer, old_mx))
    mx_layer_counts = phase_layer_mx(card)
    mxfp4_counts = phase_serve_mx(card, cfg, dense, "a16w4_mxfp")
    nvfp4_counts = phase_serve_mx(card, cfg, dense, "a4w4_nvfp")
    del dense
    unfolded_counts = phase_serve_mx_unfolded(card)
    picked.update(phase_kernels_scan(card, peak, timer))
    scan_counts = phase_serve_scan(card)
    rw_counts = phase_real_weights(card)
    phase_patch_model(card)
    phase_warmup(card)

    # name -> (source, the TPU kernel it replaces, the run whose launches count,
    # that run's name, the wrapper's counter)
    fp8_src = "gemlite_tpu_torch/csrc/fp8_gemm.cu"
    mx_src = "gemlite_tpu_torch/csrc/mx_gemm.cu"
    sources = {"decode": ("gemlite_tpu_torch/csrc/decode_gemv.cu",
                          "gemlite_tpu/ops/pallas_decode.py:619", serve_counts, "serve", "decode"),
               "prefill": ("gemlite_tpu_torch/csrc/prefill_gemm.cu",
                           "gemlite_tpu/ops/pallas_prefill.py:570", serve_counts, "serve",
                           "prefill"),
               "dequantize": ("gemlite_tpu_torch/csrc/dequantize.cu",
                              "gemlite_tpu/ops/pallas_prefill.py:353", layer_counts, "layer",
                              "dequantize_int"),
               "int8_decode": ("gemlite_tpu_torch/csrc/int8_decode.cu",
                               "gemlite_tpu/ops/pallas_int8.py:286", a8_counts, "serve_a8w8",
                               "int8_decode"),
               "fused_gemm": ("gemlite_tpu_torch/csrc/fused_gemm.cu",
                              "gemlite_tpu/ops/pallas_gemm.py:294", a8_counts, "serve_a8w8",
                              "fused_gemm"),
               "fused_gemm_float": ("gemlite_tpu_torch/csrc/fused_float.cu",
                                    "gemlite_tpu/ops/pallas_gemm.py:294", a16_counts,
                                    "serve_a16w8", "fused_gemm_float"),
               "flash": ("gemlite_tpu_torch/csrc/flash_attention.cu",
                         "gemlite_tpu/models/llama.py:292", paged_counts, "serve_paged", "flash"),
               "paged_decode": ("gemlite_tpu_torch/csrc/paged_attention.cu",
                                "gemlite_tpu/models/paged_kv.py:124", paged_counts, "serve_paged",
                                "paged_decode"),
               "decode_stacked": ("gemlite_tpu_torch/csrc/decode_gemv.cu",
                                  "gemlite_tpu/ops/pallas_scan.py:70", scan_counts, "serve_scan",
                                  "decode_stacked"),
               "fp8_decode": (fp8_src, "gemlite_tpu/ops/pallas_decode.py:619", fp8_counts,
                              "serve_fp8", "fp8_decode"),
               "fp8_prefill": (fp8_src, "gemlite_tpu/ops/pallas_prefill.py:570", fp8_counts,
                               "serve_fp8", "fp8_prefill"),
               "dequantize_int": ("gemlite_tpu_torch/csrc/dequantize.cu",
                                  "gemlite_tpu/ops/pallas_prefill.py:353",
                                  rw_counts["a8w4_gs64"], "real_weights (a8w4_gs64)",
                                  "dequantize_int"),
               "dequantize_fp8": ("gemlite_tpu_torch/csrc/dequantize.cu",
                                  "gemlite_tpu/ops/pallas_prefill.py:353", fp8_layer_counts,
                                  "layer_fp8", "dequantize"),
               "fp8_decode_stacked": (fp8_src, "gemlite_tpu/ops/pallas_scan.py:70",
                                      rw_counts["a16w8_fp8"], "real_weights (a16w8_fp8)",
                                      "fp8_decode_stacked"),
               "fused_gemm_float_fp8x": ("gemlite_tpu_torch/csrc/fused_float.cu",
                                         "gemlite_tpu/ops/pallas_gemm.py:294",
                                         rw_counts["a8w4_gs64"], "real_weights (a8w4_gs64)",
                                         "fused_gemm_float"),
               "decode_modes": ("gemlite_tpu_torch/csrc/decode_gemv.cu",
                                "gemlite_tpu/ops/pallas_decode.py:619", modes_counts,
                                "serve_a8w4", "decode_modes"),
               "prefill_modes": ("gemlite_tpu_torch/csrc/prefill_modes.cu",
                                 "gemlite_tpu/ops/pallas_prefill.py:570", modes_counts,
                                 "serve_a8w4", "prefill_modes"),
               "prefill_modes_ragged": ("gemlite_tpu_torch/csrc/prefill_gemm.cu",
                                        "gemlite_tpu/ops/pallas_prefill.py:570", modes_counts,
                                        "serve_a8w4", "prefill_modes_ragged"),
               "decode_modes_stacked": ("gemlite_tpu_torch/csrc/decode_gemv.cu",
                                        "gemlite_tpu/ops/pallas_scan.py:70", scan_cw_counts,
                                        "serve_scan_cw", "decode_modes_stacked"),
               "mx_decode": (mx_src, "gemlite_tpu/ops/pallas_decode.py:619", mxfp4_counts,
                             "serve_mxfp4", "mx_decode"),
               "mx_decode_stacked": (mx_src, "gemlite_tpu/ops/pallas_scan.py:70",
                                     rw_counts["a16w4_mxfp"], "real_weights (a16w4_mxfp)",
                                     "mx_decode_stacked"),
               "mx_prefill": (mx_src, "gemlite_tpu/ops/pallas_prefill.py:570", mxfp4_counts,
                              "serve_mxfp4", "mx_prefill"),
               "mx_prefill_csm4": (mx_src, "gemlite_tpu/ops/pallas_prefill.py:570", nvfp4_counts,
                                   "serve_nvfp4", "mx_prefill_csm4"),
               "dequantize_mx": ("gemlite_tpu_torch/csrc/dequantize.cu",
                                 "gemlite_tpu/ops/pallas_prefill.py:353", mx_layer_counts,
                                 "layer_mx", "dequantize"),
               "mx_general": (mx_src, "gemlite_tpu/ops/pallas_gemm.py:439", unfolded_counts,
                              "serve_mx_unfolded", "mx_general")}
    # row 5f with fp8 x: since the dequantize kernel took A8Wn at M >= 4096,
    # no path that this script drives reaches it (its A8W4 run must show 0);
    # every layer of the paths has N a multiple of 8, so the mode 1-3 prefill
    # runs only the persistent kernel there (prefill_modes_ragged: 0)
    off_path = {"fused_gemm_float_fp8x", "prefill_modes_ragged"}
    for path, counts in (("serve_a8w4", modes_counts), ("real_weights (a8w4_gs64)",
                                                        rw_counts["a8w4_gs64"])):
        if counts.get("fused_gemm_float", 0):
            raise RuntimeError(f"row 5f ran in {path}: {counts}")
    for path, counts in [("serve_a8w4", modes_counts), ("serve_scan_cw", scan_cw_counts),
                         *((f"real_weights ({k})", c) for k, c in rw_counts.items())]:
        if counts.get("prefill_modes_ragged", 0):
            raise RuntimeError(f"prefill_modes_ragged ran in {path}: {counts}")
    kernels = []
    for name_k, (src, replaces, counts, path, counter) in sources.items():
        r = picked[name_k]
        kernels.append({"name": name_k, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": counts.get(counter, 0), "launches_path": path,
                        "on_path": name_k not in off_path,
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
                        "shape": r.get("shape") or {k: r[k] for k in ("bits", "form", "M", "N", "K")
                                                    if k in r}})
    if any(k["launches"] < 1 for k in kernels if k["on_path"]):
        raise RuntimeError(f"a kernel of the path never launched: {kernels}")
    emit({"seconds": time.perf_counter() - t_start, "card": card})
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
