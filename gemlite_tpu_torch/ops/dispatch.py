# SPDX-License-Identifier: Apache-2.0
"""Regime router (counterpart of ``gemlite_tpu/ops/dispatch.py:128-240``).

By the flattened batch size M:
    M <= 64          decode kernel
    64 < M < 4096    prefill kernel
    M >= 4096        dequantize kernel, then a dense ``torch.matmul``

On the card a layer that none of the three kernels serves raises
``NotImplementedError`` naming the kernel queued for it: no plain version ever
runs there. On the CPU the same routes run the kernels' plain versions and are
noted as ``plain_<route>``; a layer the kernels would refuse is noted
``plain_oracle``.
"""

import torch

from ..dtypes import DType, to_torch_dtype
from .decode import can_use_decode, decode_matmul
from .dequantize import can_use_dequantize, dequantize_weights
from .prefill import can_use_prefill, prefill_matmul
from .reference import forward_meta

__all__ = ["KERNEL_TRACE", "KERNEL_ROUTES", "last_kernel", "fused_matmul"]

# Route of every dispatch, in order; callers clear it around the calls they
# check. Bounded so that an unchecked caller cannot grow it without limit.
KERNEL_TRACE: list = []
KERNEL_ROUTES = ("decode", "prefill", "dequantize")
_TRACE_LIMIT = 4096


def _note(name: str) -> None:
    if len(KERNEL_TRACE) < _TRACE_LIMIT:
        KERNEL_TRACE.append(name)


def last_kernel() -> str:
    return KERNEL_TRACE[-1] if KERNEL_TRACE else ""


def _route(meta, M: int):
    if M <= 64:
        return "decode" if can_use_decode(meta, M) else None
    if M < 4096:
        return "prefill" if can_use_prefill(meta, M) else None
    return "dequantize" if can_use_dequantize(meta) else None


def _dense(x, w, meta):
    out = torch.matmul(x.to(torch.bfloat16), w)
    return out.to(to_torch_dtype(DType(meta.output_dtype)))


def fused_matmul(x: torch.Tensor, W_q, scales, zeros, meta) -> torch.Tensor:
    """out (M, N) = x (M, K) @ dequant(W_q) through the kernel of M's regime."""
    route = _route(meta, x.shape[0])
    on_cpu = x.device.type == "cpu"
    if route is None:
        if not on_cpu:
            raise NotImplementedError(
                f"no kernel serves M={x.shape[0]} with {meta}: queued are the general "
                "fused kernel (pallas_fused_matmul) and the exact int8 decode kernel")
        _note("plain_oracle")
        return forward_meta(x, W_q, scales, zeros, None, meta)
    _note(f"plain_{route}" if on_cpu else route)
    if route == "decode":
        return decode_matmul(x, W_q, scales, zeros, meta)
    if route == "prefill":
        return prefill_matmul(x, W_q, scales, zeros, meta)
    return _dense(x, dequantize_weights(W_q, scales, zeros, meta), meta)
