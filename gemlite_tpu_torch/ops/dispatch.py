# SPDX-License-Identifier: Apache-2.0
"""Regime router (counterpart of ``gemlite_tpu/ops/dispatch.py:128-240``).

By the flattened batch size M, in the JAX router's order:
    M <= 64          int8_exact (INT8 layers), decode, prefill, general_fused
    64 < M < 4096    prefill, general_fused
    M >= 4096        dequantize kernel, then a dense ``torch.matmul``; else
                     (``dense_fallback``) the plain ``dequantize_full`` and a
                     dense ``torch.matmul``; csm 4 off the MX layers:
                     general_fused

The decode and prefill kernels take bf16 layers of W1, W2 and W4 codes in
W_group_mode 4, and in modes 1-3 with csm 0-3 (their mode 1-3 form,
``w4.serves_modes``), as the JAX decode and prefill kernels do; the
dequantize kernel takes the integer-code layers that JAX's
``pallas_dequantize`` takes (``ops/dequantize.jax_dequantizes``: W1, W2,
W4 and W8 codes in modes 1-4, csm 0-3). Layers of fp8 bit codes
(``A16W8_FP8``, ``A8W8_FP8_dynamic``) take the fp8 kernels under the same
route names (``ops/fp8.py``): decode at M <= 64, prefill below 4096, the fp8
form of the dequantize kernel then a dense matmul from 4096, and never the
general fused kernel, whose JAX gate refuses them
(``pallas_gemm.py:can_use_pallas``). fp8 x over integer codes
(``A8Wn_HQQ_INT_dynamic``) takes the mode 1-3 form of decode and prefill
below 4096, x converted to its bf16 image (exact) beside the per-token
quantization; so do channel-wise ``A16Wn`` and ``A16W158_INT``. From M 4096
these take the dequantize kernel, as in JAX. Below 4096, a float layer that
the JAX package sends to one of its kernels but whose form the port's decode
and prefill kernels do not cover yet (W8 codes, fp16 x, groups the prefill
kernel does not take) runs on the general fused kernel here; non-packed int8
weights (A16W8) run on it below M 4096 in both packages, on its float path
(``fused_gemm_float``). ``dense_fallback`` is kept for the layers that the
JAX package itself dequantizes without a Pallas kernel.

MX layers (``ops/mx.py``) take the MX kernels under the same route names:
micro-scaled x (csm 4) at 64 < M < 4096 goes in as e4m3 codes and group
scales (``prefill_mx_csm4``); everywhere else it is fake-quantized with
plain torch ops (JAX does this in XLA) and the layer routes as csm 0:
decode at M <= 64 (NVFP4: prefill, as in JAX), prefill below 4096, the MX
form of the dequantize kernel then a dense matmul from 4096. An fp4 MX
layer that JAX does not fold takes ``general_fused`` below M 4096, on the
port's general MX kernel (``ops/mx.mx_general``), where JAX runs its general
fused kernel or, for most such shapes, its oracle (a route difference: the
same function on a kernel), and ``dense_fallback`` from M 4096, as in JAX.
An fp8-coded one has no kernel below 4096 in either package and raises on
the card.

On the card a layer that no kernel serves raises ``NotImplementedError``
naming the form: no plain version of a kernel ever runs there. On the CPU
the same routes run the kernels' plain versions and are noted as
``plain_<route>``; a layer no kernel would take is noted ``plain_oracle``.
The scan path's stacked linears (``models/scan_llama.py``) note
``decode_stacked`` or ``plain_decode_stacked``.
"""

import torch

from ..dtypes import DType, to_torch_dtype
from .decode import can_use_decode, can_use_decode_modes, decode_matmul, decode_modes
from .dequantize import can_use_dequantize, dequantize_full, dequantize_weights
from .fp8 import fp8_coded, fp8_decode, fp8_prefill, serves_fp8
from .fused import can_use_fused, fused_gemm
from .int8_decode import can_use_int8_decode, int8_decode
from .mx import jax_folds, mx_coded, mx_decode, mx_general, mx_prefill, mx_refusal
from .prefill import can_use_prefill, can_use_prefill_modes, prefill_matmul, prefill_modes
from ..quant import scale_activations_mx
from .reference import fake_quant_activations, forward_meta

__all__ = ["KERNEL_TRACE", "KERNEL_ROUTES", "last_kernel", "fused_matmul"]

# Route of every dispatch, in order; callers clear it around the calls they
# check. Bounded so that an unchecked caller cannot grow it without limit.
KERNEL_TRACE: list = []
# the routes that run a hand-written kernel for the matmul
KERNEL_ROUTES = ("decode", "prefill", "dequantize", "int8_exact", "general_fused",
                 "decode_stacked", "prefill_mx_csm4")
_TRACE_LIMIT = 4096


def _note(name: str) -> None:
    if len(KERNEL_TRACE) < _TRACE_LIMIT:
        KERNEL_TRACE.append(name)


def last_kernel() -> str:
    return KERNEL_TRACE[-1] if KERNEL_TRACE else ""


def _mx_route(meta, M: int):
    """An MX layer's route at M rows, or None: micro-scaled x (csm 4) takes
    ``prefill_mx_csm4`` at 64 < M < 4096 on a layer JAX folds (JAX's gate,
    ``pallas_prefill.py:can_use_prefill_kernel(mx_x=True)``), and otherwise
    the routes of csm 0."""
    if meta.channel_scale_mode == 4 and 64 < M < 4096 and jax_folds(meta):
        return "prefill_mx_csm4"
    if not jax_folds(meta):
        if M >= 4096:
            return "dense_fallback"
        return "general_fused" if meta.W_nbits == 4 else None
    if M >= 4096:
        return "dequantize"
    if M <= 64 and meta.input_dtype != DType.NVFP4.value:
        return "decode"
    return "prefill"


def _route(meta, M: int):
    if mx_coded(meta):
        return _mx_route(meta, M)
    if fp8_coded(meta):
        if not serves_fp8(meta):
            return None
        return "decode" if M <= 64 else "prefill" if M < 4096 else "dequantize"
    if M >= 4096:
        if can_use_dequantize(meta):
            return "dequantize"
        if meta.channel_scale_mode != 4:
            return "dense_fallback"
        return "general_fused" if can_use_fused(meta) else None
    if M <= 64:
        if meta.input_dtype == DType.INT8.value and can_use_int8_decode(meta, M):
            return "int8_exact"
        if can_use_decode(meta, M) or can_use_decode_modes(meta, M):
            return "decode"
    if can_use_prefill(meta, M) or can_use_prefill_modes(meta, M):
        return "prefill"
    return "general_fused" if can_use_fused(meta) else None


def _dense(x, w, meta, scales_x):
    """x @ w on the tensor cores, x in bf16, with float32 sums; then the
    per-token scale (csm 2/3) in float32 and one rounding to the output
    dtype, as ``gemlite_tpu/ops/dispatch.py:_dense_fallback_matmul`` does
    with ``preferred_element_type=float32``. Without a per-token scale and
    with bf16 out, the bf16 product (float32 sums rounded once) is the same
    function."""
    x = x.to(torch.bfloat16)
    out_dtype = to_torch_dtype(DType(meta.output_dtype))
    scaled = meta.channel_scale_mode in (2, 3) and scales_x is not None
    if not scaled and out_dtype == torch.bfloat16:
        return torch.matmul(x, w)
    # on the CPU in float32, where products of bf16 values are exact
    acc = (torch.mm(x, w, out_dtype=torch.float32) if x.is_cuda
           else torch.matmul(x.to(torch.float32), w.to(torch.float32)))
    if scaled:
        acc = acc * scales_x.reshape(-1, 1).to(torch.float32)
    return acc.to(out_dtype)


def fused_matmul(x: torch.Tensor, W_q, scales, zeros, meta, scales_x=None) -> torch.Tensor:
    """out (M, N) = x (M, K) @ dequant(W_q) through the kernel of M's regime.
    ``scales_x`` (M, 1) are the per-token scales of a dynamically quantized x."""
    M = x.shape[0]
    route = _route(meta, M)
    on_cpu = x.device.type == "cpu"
    if route is None:
        if not on_cpu:
            why = (mx_refusal(meta._replace(channel_scale_mode=0), M,
                              "prefill" if jax_folds(meta) else "general") if mx_coded(meta)
                   else "csm 4 belongs to MX input dtypes, and fp8 codes need K and N "
                        "multiples of 128 and one group or none")
            raise NotImplementedError(f"no kernel serves M={M} with {meta}: {why}")
        _note("plain_oracle")
        return forward_meta(x, W_q, scales, zeros, scales_x, meta)
    _note(f"plain_{route}" if on_cpu else route)
    if mx_coded(meta):
        if route == "prefill_mx_csm4":
            return mx_prefill(None, W_q, scales, None, meta,
                              x_codes=scale_activations_mx(x, meta.input_dtype))
        if meta.channel_scale_mode == 4:
            x = fake_quant_activations(x, meta.input_dtype, meta.output_dtype)
            meta = meta._replace(channel_scale_mode=0)
        if route in ("decode", "prefill"):
            return (mx_decode if route == "decode" else mx_prefill)(x, W_q, scales, scales_x, meta)
        if route == "general_fused":
            return mx_general(x, W_q, scales, scales_x, meta)
    if route == "int8_exact":
        return int8_decode(x, W_q, scales, zeros, scales_x, meta)
    if fp8_coded(meta) and route in ("decode", "prefill"):
        return (fp8_decode if route == "decode" else fp8_prefill)(x, W_q, scales, scales_x, meta)
    if route in ("decode", "prefill") and meta.W_group_mode != 4:
        if x.dtype != torch.bfloat16:
            x = x.to(torch.bfloat16)              # fp8 codes: their exact bf16 image
        modes = decode_modes if route == "decode" else prefill_modes
        return modes(x, W_q, scales, zeros, scales_x, meta)
    if route == "decode":
        return decode_matmul(x, W_q, scales, zeros, meta)
    if route == "prefill":
        return prefill_matmul(x, W_q, scales, zeros, meta)
    if route == "general_fused":
        return fused_gemm(x, W_q, scales, zeros, scales_x, meta)
    if route == "dequantize":
        return _dense(x, dequantize_weights(W_q, scales, zeros, meta), meta, scales_x)
    return _dense(x, dequantize_full(W_q, scales, zeros, meta), meta, scales_x)
