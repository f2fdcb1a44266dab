# SPDX-License-Identifier: Apache-2.0
"""Processors that turn quantized or float weights into a packed
``GemLiteLinear`` (counterpart of ``gemlite_tpu/helper.py``).

In this slice: the weight-only grouped INT processors ``A16Wn`` /
``A16Wn_HQQ_INT`` and their W8/W4/W2/W1 presets.
"""

from typing import Optional

import torch

from .core import GemLiteLinear, resolve_device, tensor_from_numpy
from .dtypes import TORCH_TO_DTYPE
from .quant import quantize_int_weights

__all__ = ["A16Wn", "A16Wn_HQQ_INT", "A16W8_HQQ_INT", "A16W4_HQQ_INT",
           "A16W2_HQQ_INT", "A16W1_HQQ_INT"]

_FLOAT_DTYPES = (torch.float16, torch.bfloat16, torch.float32)


def _float_dtype_of(t: torch.Tensor, override=None) -> torch.dtype:
    if override is not None:
        return override
    return t.dtype if t.dtype in _FLOAT_DTYPES else torch.bfloat16


class A16Wn:
    """16-bit activations x packed grouped-INT Wn weights.

    ``dtype`` is the activation and scale dtype; by default the scales'
    own float dtype. ``device=None`` means the card."""

    def __init__(self, device=None, dtype: Optional[torch.dtype] = None,
                 post_scale: bool = False):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.post_scale = post_scale

    def from_weights(self, W_q, scales, zeros, W_nbits: int, group_size: int, bias=None,
                     quant_type: str = "INT") -> GemLiteLinear:
        if quant_type != "INT":
            raise NotImplementedError(f"queued: quant_type {quant_type} (MX processors)")
        W_q = tensor_from_numpy(W_q)
        scales = tensor_from_numpy(scales)
        zeros = tensor_from_numpy(zeros)
        dtype = _float_dtype_of(scales, self.dtype)
        gem_dtype = TORCH_TO_DTYPE[dtype]
        out_features, in_features = W_q.shape
        layer = GemLiteLinear(W_nbits, group_size=group_size, in_features=in_features,
                              out_features=out_features, input_dtype=gem_dtype,
                              output_dtype=gem_dtype, device=self.device)
        if bias is not None:
            bias = tensor_from_numpy(bias).to(dtype)
        layer.pack(W_q.to(torch.uint8), scales.to(dtype), zeros.to(dtype), bias=bias)
        if group_size == in_features:
            if self.post_scale:       # shift in the loop, channel scale after
                layer.W_group_mode, layer.channel_scale_mode = 1, 1
            else:                     # full grouped dequant in the loop
                layer.W_group_mode, layer.channel_scale_mode = 3, 0
        return layer


class A16Wn_HQQ_INT(A16Wn):
    def __init__(self, device=None, dtype: Optional[torch.dtype] = None,
                 W_nbits: Optional[int] = None):
        super().__init__(device, dtype)
        self.W_nbits = W_nbits

    def from_weights(self, W_q, scales, zeros, bias=None) -> GemLiteLinear:
        group_size = tensor_from_numpy(W_q).numel() // tensor_from_numpy(scales).numel()
        return super().from_weights(W_q, scales, zeros, self.W_nbits, group_size, bias, "INT")

    def from_float_weights(self, weight, bias=None, group_size: int = 128, iters: int = 12,
                           clip_grid=None) -> GemLiteLinear:
        """Quantize float weights with quant.quantize_int_weights, then pack."""
        W_q, scales, zeros = quantize_int_weights(
            tensor_from_numpy(weight), self.W_nbits, group_size, iters=iters,
            clip_grid=clip_grid)
        return self.from_weights(W_q, scales, zeros, bias)


class A16W8_HQQ_INT(A16Wn_HQQ_INT):
    def __init__(self, device=None, dtype=None):
        super().__init__(device, dtype, W_nbits=8)


class A16W4_HQQ_INT(A16Wn_HQQ_INT):
    def __init__(self, device=None, dtype=None):
        super().__init__(device, dtype, W_nbits=4)


class A16W2_HQQ_INT(A16Wn_HQQ_INT):
    def __init__(self, device=None, dtype=None):
        super().__init__(device, dtype, W_nbits=2)


class A16W1_HQQ_INT(A16Wn_HQQ_INT):
    def __init__(self, device=None, dtype=None):
        super().__init__(device, dtype, W_nbits=1)


def _warmup_quantize(processor, w, group_size: int, **quant_kwargs) -> GemLiteLinear:
    """Group-quantize a float matrix for a Wn processor (W8 is channel-wise)."""
    nb = processor.W_nbits
    w = tensor_from_numpy(w)
    gs = group_size if nb <= 4 else w.shape[1]
    W_q, scales, zeros = quantize_int_weights(w, nb, gs, **quant_kwargs)
    return processor.from_weights(W_q, scales, zeros, bias=None)
