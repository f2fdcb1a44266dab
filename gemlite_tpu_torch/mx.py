# SPDX-License-Identifier: Apache-2.0
"""MX microscaling (OCP MXFP8 / MXFP4) and NVFP4 layers (counterpart of
``gemlite_tpu/mx.py``).

Weights are fp8 (e4m3 / e5m2) codes or fp4 (e2m1) codes with power-of-two
e8m0 group scales (groups of 32), or NVFP4 fp4 codes with e4m3 scales times
the meta-scale 0.05 (groups of 16). Activations stay bf16 / fp16
(``A16Wn_MXFP``), are quantized per token to e4m3 (``A8Wn_MXFP_dynamic``,
csm 2), or are micro-scaled like the weights (csm 4: ``A4W4_MXFP_dynamic``,
``A4W4_NVFP_dynamic``, ``A8Wn_MXFP_dynamic(post_scale=False)``).

The layers pack in the reference layout (w_layout 0): fp4 codes eight to an
int32 word along K, fp8 codes as bit codes four to a word, e8m0 scales as
uint8 (G, N), NVFP4 scales as float8_e4m3fn (G, N). The MX kernels
(``ops/mx.py``, ``csrc/mx_gemm.cu``) decode them on the card; the plain
version of every one of them is ``mx_forward_ref``.
"""

from typing import Optional

import torch

from .core import GemLiteLinear, resolve_device, tensor_from_numpy
from .dtypes import DType, TORCH_TO_DTYPE
from .ops.reference import fake_quant_activations, mx_dequantize_weight_ref, mx_forward_ref
from .quant import WeightQuantizerMXFP, mx_group_size

__all__ = ["mxfp_quantize_weight", "pack_mxfp_layer", "fake_quant_activations",
           "mx_dequantize_weight_ref", "mx_forward_ref",
           "A16Wn_MXFP", "A16W8_MXFP", "A16W4_MXFP",
           "A8Wn_MXFP_dynamic", "A8W8_MXFP_dynamic", "A8W4_MXFP_dynamic",
           "A4W4_MXFP_dynamic", "A4W4_NVFP_dynamic"]


def mxfp_quantize_weight(W, W_nbits: int, fp8_dtype=torch.float8_e4m3fn, nvfp4: bool = False,
                         window_size: int = 0, flush_subnormals: bool = True):
    """float (N, K) -> (W_q, scales) in MX storage form, on W's device:
    MXFP8 fp8 (N, K) and e8m0 bits (N, K // 32); MXFP4 uint8 fp4 codes (N, K)
    and e8m0 bits (N, K // 32); NVFP4 uint8 fp4 codes (N, K) and e4m3 (N, K
    // 16). ``flush_subnormals`` (MXFP8): fp8 subnormal codes round to 0 or
    the smallest normal."""
    W = tensor_from_numpy(W).to(torch.float32)
    N, K = W.shape
    q = WeightQuantizerMXFP(compute_dtype=torch.float32)
    if nvfp4:
        W_q, scales = q.quantize_nvfp4(W, window_size=window_size, index=True)
        gs = 16
    elif W_nbits == 8:
        W_q, scales = q.quantize_mxfp8(W, index=True, mx_fp8_dtype=fp8_dtype,
                                       flush_subnormals=flush_subnormals)
        gs = 32
    elif W_nbits == 4:
        W_q, scales = q.quantize_mxfp4(W, window_size=window_size, index=True)
        gs = 32
    else:
        raise ValueError(f"MXFP supports W_nbits in (4, 8), got {W_nbits}")
    return W_q.reshape(N, K), scales.reshape(N, K // gs)


def pack_mxfp_layer(W_q, scales, W_nbits: int, dtype=None, bias=None,
                    scaled_activations: bool = False, input_dtype=None,
                    device=None) -> GemLiteLinear:
    """A GemLiteLinear of MX-quantized weights: ``input_dtype`` defaults to
    MXFP16 / MXBF16 (weight-only) by ``dtype`` (default bf16); the dynamic
    processors pass MXFP8, MXFP4 or NVFP4."""
    dev = resolve_device(device)
    W_q = tensor_from_numpy(W_q).to(dev)
    scales = tensor_from_numpy(scales).to(dev)
    N, K = W_q.shape
    dtype = torch.bfloat16 if dtype is None else dtype
    if input_dtype is None:
        input_dtype = DType.MXFP16 if dtype == torch.float16 else DType.MXBF16
    layer = GemLiteLinear(W_nbits, group_size=K // scales.shape[-1], in_features=K,
                          out_features=N, input_dtype=DType(input_dtype),
                          output_dtype=TORCH_TO_DTYPE[dtype],
                          scaled_activations=scaled_activations, device=dev)
    if bias is not None:
        bias = tensor_from_numpy(bias).to(dtype)
    layer.pack(W_q, scales, zeros=None, bias=bias)
    return layer


# ---------------------------------------------------------------------------
# Processors (``gemlite_tpu/mx.py:230-371``). ``device=None`` means the card.
# ---------------------------------------------------------------------------

def _weight_bias(linear_layer):
    from .helper import _weight_bias_of
    return _weight_bias_of(linear_layer)


def _cleanup(linear_layer, del_orig: bool) -> None:
    from .helper import cleanup_linear
    cleanup_linear(linear_layer, del_orig)


class A16Wn_MXFP:
    """Weight-only MXFP8 / MXFP4: activations stay fp16 / bf16.
    ``flush_subnormals`` (MXFP8): round fp8 subnormal weight codes at
    quantize time (False keeps every code)."""

    def __init__(self, device=None, dtype: Optional[torch.dtype] = None, W_nbits=None,
                 fp8=torch.float8_e4m3fn, flush_subnormals: bool = True):
        self.flush_subnormals = flush_subnormals
        self.device = resolve_device(device)
        self.dtype = torch.bfloat16 if dtype is None else dtype
        self.W_nbits = W_nbits
        self.mx_fp8_dtype = fp8

    def from_weights(self, W_q, scales, bias=None) -> GemLiteLinear:
        return pack_mxfp_layer(W_q, scales, self.W_nbits, dtype=self.dtype, bias=bias,
                               scaled_activations=False, device=self.device)

    def from_linear(self, linear_layer, del_orig: bool = True) -> GemLiteLinear:
        w, bias = _weight_bias(linear_layer)
        W_q, scales = mxfp_quantize_weight(w.to(self.device), self.W_nbits, self.mx_fp8_dtype,
                                           flush_subnormals=self.flush_subnormals)
        _cleanup(linear_layer, del_orig)
        return self.from_weights(W_q, scales, bias)


class A16W8_MXFP(A16Wn_MXFP):
    def __init__(self, device=None, dtype=None, fp8=torch.float8_e4m3fn,
                 flush_subnormals: bool = True):
        super().__init__(device, dtype, W_nbits=8, fp8=fp8, flush_subnormals=flush_subnormals)


class A16W4_MXFP(A16Wn_MXFP):
    def __init__(self, device=None, dtype=None):
        super().__init__(device, dtype, W_nbits=4)


class A8Wn_MXFP_dynamic:
    """MXFP8 activations x MXFP8 / MXFP4 weights: ``post_scale=True`` quantizes
    x per token to e4m3 (csm 2), ``post_scale=False`` micro-scales it (csm 4)."""

    def __init__(self, device=None, dtype=None, post_scale: bool = True,
                 fp8=torch.float8_e4m3fn, W_nbits=None, flush_subnormals: bool = True):
        if W_nbits not in (4, 8):
            raise ValueError(f"W_nbits must be 4 or 8, not {W_nbits}")
        self.device = resolve_device(device)
        self.dtype = torch.bfloat16 if dtype is None else dtype
        self.mx_fp8_dtype = fp8
        self.post_scale = post_scale
        self.W_nbits = W_nbits
        self.flush_subnormals = flush_subnormals

    def from_weights(self, weight, bias=None, scales=None) -> GemLiteLinear:
        if scales is None:
            raise ValueError("pre-quantized weights and scales are required; use from_linear()")
        layer = pack_mxfp_layer(weight, scales, self.W_nbits, dtype=self.dtype, bias=bias,
                                scaled_activations=True, input_dtype=DType.MXFP8,
                                device=self.device)
        layer.W_group_mode = 2
        layer.channel_scale_mode = 2 if self.post_scale else 4
        return layer

    def from_linear(self, linear_layer, del_orig: bool = True) -> GemLiteLinear:
        w, bias = _weight_bias(linear_layer)
        W_q, scales = mxfp_quantize_weight(w.to(self.device), self.W_nbits, self.mx_fp8_dtype,
                                           flush_subnormals=self.flush_subnormals)
        _cleanup(linear_layer, del_orig)
        return self.from_weights(W_q, bias=bias, scales=scales)


class A8W8_MXFP_dynamic(A8Wn_MXFP_dynamic):
    def __init__(self, device=None, dtype=None, post_scale: bool = True,
                 fp8=torch.float8_e4m3fn, flush_subnormals: bool = True):
        super().__init__(device, dtype, post_scale, fp8, W_nbits=8,
                         flush_subnormals=flush_subnormals)


class A8W4_MXFP_dynamic(A8Wn_MXFP_dynamic):
    def __init__(self, device=None, dtype=None, post_scale: bool = True,
                 fp8=torch.float8_e4m3fn):
        super().__init__(device, dtype, post_scale, fp8, W_nbits=4)


class _A4W4:
    """fp4 activations x fp4 weights, both micro-scaled (csm 4)."""

    input_dtype = DType.MXFP4
    nvfp4 = False

    def __init__(self, device=None, dtype=None):
        self.device = resolve_device(device)
        self.dtype = torch.bfloat16 if dtype is None else dtype
        self.W_nbits = 4
        self.group_size = mx_group_size(self.input_dtype)

    def from_weights(self, weight, bias=None, scales=None) -> GemLiteLinear:
        if scales is None:
            raise ValueError("pre-quantized weights and scales are required; use from_linear()")
        layer = pack_mxfp_layer(weight, scales, 4, dtype=self.dtype, bias=bias,
                                scaled_activations=True, input_dtype=self.input_dtype,
                                device=self.device)
        layer.channel_scale_mode = 4
        return layer

    def from_linear(self, linear_layer, del_orig: bool = True) -> GemLiteLinear:
        w, bias = _weight_bias(linear_layer)
        W_q, scales = mxfp_quantize_weight(w.to(self.device), 4, nvfp4=self.nvfp4)
        _cleanup(linear_layer, del_orig)
        return self.from_weights(W_q, bias=bias, scales=scales)


class A4W4_MXFP_dynamic(_A4W4):
    """MXFP4 activations x MXFP4 weights (groups of 32, e8m0 scales)."""


class A4W4_NVFP_dynamic(_A4W4):
    """NVFP4 activations x NVFP4 weights (groups of 16, e4m3 scales x 0.05)."""

    input_dtype = DType.NVFP4
    nvfp4 = True
