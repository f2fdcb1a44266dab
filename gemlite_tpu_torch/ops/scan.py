# SPDX-License-Identifier: Apache-2.0
"""Stacked decode kernel: layer ``l`` of an L-layer stack of W1/W2/W4 mode-4
layers for M <= 64 (``csrc/decode_gemv.cu``, entry ``gl_decode_stacked``),
of W1/W2/W4 layers in W_group_mode 1-3 with csm 0 or 1 (channel-wise
``A16Wn``, with or without ``post_scale``; ``csrc/decode_modes.cu``, entry
``gl_decode_modes_stacked``, wrapper ``decode_modes_stacked``; where TMA
cannot read the operands, ``decode_gemv.cu``'s ``gl_decode_modes_ragged_stacked``,
wrapper ``decode_modes_ragged_stacked``, counted apart), of fp8-coded layers
with unscaled x (``A16W8_FP8``; ``csrc/fp8_gemm.cu``,
entry ``gl_fp8_decode_stacked``, wrapper ``ops/fp8.fp8_decode_stacked``), or
of weight-only MX layers (``A16W4_MXFP``, ``A16W8_MXFP``; ``csrc/mx_gemm.cu``,
entry ``gl_mx_decode_stacked``, wrapper ``ops/mx.mx_decode_stacked``).

Replaces ``gemlite_tpu/ops/pallas_scan.py:pallas_decode_matmul_stacked``. The
TPU kernel takes the layer index as a scalar-prefetch operand read by its
index maps; here the index is a 0-d int32 tensor on the card, and each block
of the kernel reads it and offsets its weight, scale and zero pointers, so the
host never reads it and one launch entry serves every layer. The body is the
per-layer decode kernel's, with the same plan (``ops/decode.plan``,
``decode.modes_plan`` for modes 1-3) and split state, so at layer ``l`` the
two agree bit for bit.

The plain version is ``forward_meta`` on ``W_q[l]``, ``scales[l]`` and
``zeros[l]`` (``forward_f32_epilogue`` for modes 1-3, the per-layer mode 1-3
form's plain version). On a CPU tensor the wrapper runs it; on a CUDA tensor
it launches the kernel or raises.
"""

from typing import Optional

import torch

from ..dtypes import DType
from . import build, w4
from . import decode
from .decode import can_use_decode, can_use_decode_modes, plan, split_buffers
from .fp8 import fp8_coded, fp8_decode_stacked, fp8_refusal
from .mx import mx_coded, mx_decode_stacked, mx_refusal
from .reference import forward_f32_epilogue, forward_meta

__all__ = ["can_use_stacked_decode", "stacked_decode_refusal", "decode_matmul_stacked",
           "decode_matmul_stacked_plain", "decode_modes_stacked", "decode_modes_ragged_stacked"]


def stacked_decode_refusal(meta, M: int) -> Optional[str]:
    """Why the stacked kernel does not take ``meta`` at M rows, or None.

    The decode kernel's gate (its mode-4 and mode 1-3 forms) minus scalar
    zeros and minus every layer whose activations are quantized per token
    (INT8 input, csm 2/3): the stacked path carries no per-token scales. The
    JAX gate (``pallas_scan.py:can_use_stacked_decode``) admits the latter and
    then fails at trace time."""
    if mx_coded(meta) and meta.channel_scale_mode == 4:
        return "its activations are micro-scaled (csm 4), and the stacked path has no x scales"
    if meta.scaled_activations or meta.input_dtype == DType.INT8.value \
            or meta.channel_scale_mode in (2, 3):
        return "its activations are quantized per token, and the stacked path has no scales_x"
    if meta.zero_is_scalar:
        return "its zero is a scalar"
    if mx_coded(meta):
        return mx_refusal(meta, M, "decode")
    if fp8_coded(meta):
        if not 0 < M <= 64:
            return f"the fp8 decode kernel takes M <= 64 rows, not M={M}"
        return fp8_refusal(meta, M)
    if not (can_use_decode(meta, M) or can_use_decode_modes(meta, M)):
        return (f"the decode kernel takes M <= 64 rows of bf16 W1/W2/W4 layers in "
                f"W_group_mode 1-4, not M={M} with W_nbits={meta.W_nbits}, "
                f"W_group_mode={meta.W_group_mode}, group_size={meta.group_size}")
    return None


def can_use_stacked_decode(meta, M: int) -> bool:
    return stacked_decode_refusal(meta, M) is None


def _layer(t, layer_idx):
    """Layer ``layer_idx`` of the stack ``t``: a view for an int, and for a
    one-element tensor an ``index_select``, which does not read the index
    on the host. ``None`` (a stack the layers lack) stays None."""
    if t is None:
        return None
    L = t.shape[0]
    try:
        if isinstance(layer_idx, torch.Tensor):
            return t.index_select(0, layer_idx.reshape(1).to(torch.long))[0]
        if 0 <= layer_idx < L:
            return t[layer_idx]
    except IndexError:
        pass
    raise IndexError(f"layer_idx {int(layer_idx)} outside the stack of {L} layers")


def _modes_form(meta) -> bool:
    """An integer-code layer in W_group_mode 1-3 (the stacked mode 1-3 entry's)."""
    return meta.W_group_mode in (1, 2, 3) and not (mx_coded(meta) or fp8_coded(meta))


def decode_matmul_stacked_plain(x, W_q, scales, zeros, meta, layer_idx):
    layer = (_layer(t, layer_idx) for t in (W_q, scales, zeros))
    if _modes_form(meta):
        return forward_f32_epilogue(x, *layer, None, meta)
    return forward_meta(x, *layer, None, meta)


def _layer_index(layer_idx, x):
    if not (isinstance(layer_idx, torch.Tensor) and layer_idx.device == x.device
            and layer_idx.dtype == torch.int32 and layer_idx.numel() == 1):
        raise ValueError("layer_idx: want a one-element int32 tensor on the card, got "
                         f"{layer_idx!r}")
    return layer_idx


def decode_modes_stacked(x: torch.Tensor, W_q, scales, zeros, meta, layer_idx) -> torch.Tensor:
    """out (M, N) bf16 = csm(x (M, K) @ dequant(W_q[layer_idx])) for M <= 64
    on a stack of layers in W_group_mode 1-3 with csm 0 or 1: ``W_q`` (L, K /
    epw, N) int32, ``scales`` and ``zeros`` (L, K / gs, N) bf16 where the
    mode has them, the csm-1 channel scales in ``scales`` as (L, 1, N); x
    bf16. The per-layer form's kernel and plan (``decode.modes_plan``, or on
    the ragged route ``decode.ragged_modes_plan``), so layer ``l`` equals
    ``decode.decode_modes`` on it bit for bit."""
    if x.device.type == "cpu":
        return decode_matmul_stacked_plain(x, W_q, scales, zeros, meta, layer_idx)
    M = x.shape[0]
    why = stacked_decode_refusal(meta, M)
    if why is not None or not _modes_form(meta):
        raise NotImplementedError("stacked mode 1-3 decode kernel does not take this layer: "
                                  f"{why or f'W_group_mode {meta.W_group_mode}'}")
    layer_idx = _layer_index(layer_idx, x)
    N, K = meta.out_features, meta.in_features
    x = w4.activations(x, K)
    operands = w4.modes_operands(W_q, scales, zeros, None, meta, M, layers=W_q.shape[0])
    stream = w4.stream()
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if not decode.modes_tma(N, meta.W_nbits, x, W_q, *operands[:2]):
        return decode_modes_ragged_stacked(x, W_q, operands, out, meta, stream, layer_idx)
    decode.tma_call(decode._fn("decode_modes", "gl_decode_modes_stacked", 9, 13), x, 2, W_q,
                    operands, out, meta, stream, layer_idx)
    decode_modes_stacked.launches += 1
    return out


def decode_modes_ragged_stacked(x, W_q, operands, out, meta, stream, layer_idx) -> torch.Tensor:
    """decode_modes_stacked's kernel where TMA cannot read the stacks
    (``decode.modes_tma``): ``gl_decode_modes_ragged_stacked``, the stacked
    mode 1-3 instance of ``decode_gemv.cu``, on ``decode.ragged_modes_plan``,
    so layer ``l`` equals ``decode.decode_modes_ragged`` on it bit for bit;
    counted apart from it. Writes ``out`` and returns it."""
    decode.ragged_call(x, W_q, operands, out, meta, stream, layer_idx)
    decode_modes_ragged_stacked.launches += 1
    return out


decode_modes_ragged_stacked.launches = 0
decode_modes_stacked.launches = 0


def decode_matmul_stacked(x: torch.Tensor, W_q, scales, zeros, meta, layer_idx) -> torch.Tensor:
    """out (M, N) bf16 = x (M, K) @ dequant(W_q[layer_idx]) for M <= 64.

    ``W_q`` (L, K / epw, N) int32, ``scales`` and ``zeros`` (L, K / gs, N)
    bf16; ``layer_idx`` a 0-d int32 tensor on x's device (an int on the
    CPU too). On the card the index is never read by the host. Layers in
    W_group_mode 1-3 go to ``decode_modes_stacked``."""
    if x.device.type == "cpu":
        return decode_matmul_stacked_plain(x, W_q, scales, zeros, meta, layer_idx)
    if _modes_form(meta):
        return decode_modes_stacked(x, W_q, scales, zeros, meta, layer_idx)
    if mx_coded(meta) or fp8_coded(meta):
        why = stacked_decode_refusal(meta, x.shape[0])
        if why is not None:
            raise NotImplementedError(f"stacked decode kernel does not take this layer: {why}")
        if mx_coded(meta):
            return mx_decode_stacked(x, W_q, scales, meta, layer_idx)
        return fp8_decode_stacked(x, W_q, scales, meta, layer_idx)
    M = x.shape[0]
    why = stacked_decode_refusal(meta, M)
    if why is not None:
        raise NotImplementedError(f"stacked decode kernel does not take this layer: {why}")
    layer_idx = _layer_index(layer_idx, x)
    N, K, gs = meta.out_features, meta.in_features, meta.group_size
    L = W_q.shape[0]
    x = w4.activations(x, K)
    w4.check_operands(W_q, scales, zeros, meta, layers=L)
    p = plan(M, N, K, gs, meta.W_nbits)
    stream = w4.stream()
    part, cnt = split_buffers(M, N, p, x.device, stream)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    err = decode._fn("decode_gemv", "gl_decode_stacked", 8, 10)(
        x.data_ptr(), W_q.data_ptr(), scales.data_ptr(), zeros.data_ptr(), layer_idx.data_ptr(),
        part, cnt, out.data_ptr(), L, M, N, K, gs, meta.W_nbits, p.splits, p.k_per_split,
        p.stages, p.mrows, stream)
    build.check(err, "decode_gemv (stacked)")
    decode_matmul_stacked.launches += 1
    return out


decode_matmul_stacked.launches = 0
