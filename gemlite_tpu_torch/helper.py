# SPDX-License-Identifier: Apache-2.0
"""Processors that turn quantized or float weights into a packed
``GemLiteLinear``, and the integration helpers around them (counterpart of
``gemlite_tpu/helper.py``).

Ported: the weight-only grouped INT processors ``A16Wn`` / ``A16Wn_HQQ_INT``
and their W8/W4/W2/W1 presets; the channel-wise 8-bit ``A16W8`` (int8, or
fp8 with ``fp8=``: ``A16W8_INT8``, ``A16W8_FP8``); the dynamic 8-bit
``A8W8_dynamic`` (``A8W8_INT8_dynamic``, ``A8W8_FP8_dynamic``); the fp8
activations over packed grouped-INT weights of ``A8Wn_HQQ_INT_dynamic``
(``A8W4_HQQ_INT_dynamic``, ``A8W2_HQQ_INT_dynamic``); BitNet
``A16W158_INT`` and ``A8W158_INT_dynamic``; ``from_linear`` /
``from_bitlinear``, ``cleanup_linear``, ``patch_model`` (replaces the linears
of an ``nn.Module`` tree or a plain object tree) and ``warmup``; the MX
processors live in ``mx.py`` (``A16Wn.from_weights(quant_type="MXFP")``
packs MX codes too). ``from_hqqlinear`` needs the ``hqq`` package.
"""

import gc
from typing import Optional

import numpy as np
import torch

from .core import GemLiteLinear, resolve_device, tensor_from_numpy
from .dtypes import DType, TORCH_TO_DTYPE
from .quant import quantize_int_weights
from .utils.m_bucket import _BUCKETS

__all__ = ["A16W8", "A16W8_INT8", "A16W8_FP8", "A16Wn", "A16Wn_HQQ_INT",
           "A16W8_HQQ_INT", "A16W4_HQQ_INT", "A16W2_HQQ_INT", "A16W1_HQQ_INT",
           "A8W8_dynamic", "A8W8_INT8_dynamic", "A8W8_FP8_dynamic",
           "A8Wn_HQQ_INT_dynamic", "A8W4_HQQ_INT_dynamic", "A8W2_HQQ_INT_dynamic",
           "A16W158_INT", "A8W158_INT_dynamic", "cleanup_linear", "patch_model", "warmup"]

_FLOAT_DTYPES = (torch.float16, torch.bfloat16, torch.float32)
DEFAULT_FP8 = torch.float8_e4m3fn


def _float_dtype_of(t: torch.Tensor, override=None) -> torch.dtype:
    if override is not None:
        return override
    return t.dtype if t.dtype in _FLOAT_DTYPES else torch.bfloat16


def _flush_fp8_subnormal_codes(W_q: torch.Tensor) -> torch.Tensor:
    """Round fp8 subnormal codes to the nearest of {0, +-min normal} (a
    mantissa above half the range goes up, the rest to a signed zero), so
    that the stored codes are subnormal-free and ``pack()`` sets
    ``fp8_nosub`` (``gemlite_tpu/helper.py:_flush_fp8_subnormal_codes``).
    Pass ``flush_subnormals=False`` to a processor to keep every code."""
    bits = W_q.view(torch.uint8)
    e5m2 = W_q.dtype == torch.float8_e5m2
    exp_m, man_m, half = (0x7C, 0x03, 2) if e5m2 else (0x78, 0x07, 4)
    sub = ((bits & exp_m) == 0) & ((bits & man_m) != 0)
    if not bool(sub.any()):
        return W_q
    sign = bits & 0x80
    snapped = torch.where((bits & man_m) > half, sign | (man_m + 1), sign)
    return torch.where(sub, snapped, bits).to(torch.uint8).view(W_q.dtype)


def _channelwise_quant_8bit(weight: torch.Tensor, fp8: Optional[torch.dtype] = None,
                            flush_subnormals: bool = True):
    """Symmetric per-output-channel 8-bit quantization (absmax / max), in
    float32: (W_q (N, K) int8, or ``fp8`` rounded to nearest even, scales
    float32 (N, 1)) (``gemlite_tpu/helper.py:_channelwise_quant_8bit``)."""
    if fp8 is not None:
        info = torch.finfo(fp8)
        min_val, max_val = float(info.min), float(info.max)
    else:
        min_val, max_val = -128.0, 127.0
    w = weight.to(torch.float32)
    amax = w.abs().amax(dim=1, keepdim=True)
    # a tensor divisor: CUDA divides by a Python scalar through its reciprocal
    scales = (amax / torch.full_like(amax, max_val)).clamp_min(1e-6)
    W_q = torch.clamp(w / scales, min_val, max_val)
    if fp8 is not None:
        W_q = W_q.to(fp8)
        if flush_subnormals:
            W_q = _flush_fp8_subnormal_codes(W_q)
    else:
        W_q = torch.round(W_q).to(torch.int8)
    return W_q, scales


def _host_tensor(t):
    """A tensor (detached) or numpy array -> tensor; None stays None."""
    if t is None or isinstance(t, torch.Tensor):
        return None if t is None else t.detach()
    return tensor_from_numpy(t)


def _weight_bias_of(linear_layer):
    """(weight (N, K), bias) of an ``nn.Linear``-like object."""
    return _host_tensor(linear_layer.weight), _host_tensor(getattr(linear_layer, "bias", None))


def cleanup_linear(linear_layer, del_orig: bool = True) -> None:
    """Drop the original layer's weight references so its float copy can be
    freed (with ``del_orig=False`` nothing is dropped, and nothing collected)."""
    if not del_orig:
        return
    for attr in ("weight", "bias", "weight_scale", "W_q", "meta"):
        if hasattr(linear_layer, attr):
            try:
                setattr(linear_layer, attr, None)
            except (AttributeError, TypeError):
                pass
    gc.collect()


class _FromLinear:
    """``from_linear`` of the processors that quantize a float weight
    themselves."""

    def from_linear(self, linear_layer, del_orig: bool = True) -> GemLiteLinear:
        w, b = _weight_bias_of(linear_layer)
        out = self.from_weights(w, b)
        cleanup_linear(linear_layer, del_orig)
        return out


class _FromBitLinear:
    """``from_bitlinear`` of the BitNet processors: a layer with ``weight`` in
    {-1, 0, +1}, ``weight_scale`` and ``bias``."""

    def from_bitlinear(self, linear_layer, del_orig: bool = True) -> GemLiteLinear:
        out = self.from_weights(linear_layer.weight, linear_layer.weight_scale,
                                linear_layer.bias)
        cleanup_linear(linear_layer, del_orig)
        return out


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
        if quant_type not in ("INT", "MXFP"):
            raise ValueError(f"invalid quant_type {quant_type}")
        if quant_type == "MXFP":
            from .mx import pack_mxfp_layer
            return pack_mxfp_layer(W_q, scales, W_nbits, dtype=self.dtype, bias=bias,
                                   scaled_activations=False, device=self.device)
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


class A16W8(_FromLinear):
    """16-bit activations x 8-bit weights, channel-wise scales (float32, or
    the activation dtype without ``fp32_scale``): int8 weights, or with
    ``fp8`` (``torch.float8_e4m3fn`` / ``torch.float8_e5m2``) fp8 weights
    stored as bit codes; scaled inside the K loop (W_group_mode 2) or, with
    ``post_scale``, after it (csm 1)."""

    def __init__(self, device=None, dtype: Optional[torch.dtype] = None,
                 fp8: Optional[torch.dtype] = None, fp32_scale: bool = True,
                 post_scale: bool = False, flush_subnormals: bool = True):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.fp8 = fp8
        self.fp32_scale = fp32_scale
        self.post_scale = post_scale
        self.flush_subnormals = flush_subnormals

    def from_weights(self, weight, bias=None, scales=None) -> GemLiteLinear:
        weight = tensor_from_numpy(weight).to(self.device)
        if scales is None:
            dtype = _float_dtype_of(weight, self.dtype)
            W_q, scales = _channelwise_quant_8bit(weight, self.fp8, self.flush_subnormals)
        else:
            if weight.element_size() != 1:
                raise ValueError("pre-quantized weight must be 8-bit")
            scales = tensor_from_numpy(scales).to(self.device)
            dtype = _float_dtype_of(scales, self.dtype)
            W_q = weight
        out_features, in_features = W_q.shape
        gem_dtype = TORCH_TO_DTYPE[dtype]
        layer = GemLiteLinear(8, group_size=in_features, in_features=in_features,
                              out_features=out_features, input_dtype=gem_dtype,
                              output_dtype=gem_dtype, device=self.device)
        if bias is not None:
            bias = tensor_from_numpy(bias).to(dtype)
        scales = scales.to(torch.float32 if self.fp32_scale else dtype)
        layer.pack(W_q, scales, zeros=None, bias=bias)
        if self.post_scale:
            layer.W_group_mode, layer.channel_scale_mode = 0, 1
        else:
            layer.W_group_mode, layer.channel_scale_mode = 2, 0
        return layer


class A16W8_INT8(A16W8):
    def __init__(self, device=None, dtype: Optional[torch.dtype] = None,
                 fp32_scale: bool = True, post_scale: bool = False):
        super().__init__(device, dtype, fp8=None, fp32_scale=fp32_scale, post_scale=post_scale)


class A16W8_FP8(A16W8):
    def __init__(self, device=None, dtype: Optional[torch.dtype] = None,
                 fp8: torch.dtype = DEFAULT_FP8, fp32_scale: bool = True,
                 post_scale: bool = False, flush_subnormals: bool = True):
        super().__init__(device, dtype, fp8=fp8, fp32_scale=fp32_scale, post_scale=post_scale,
                         flush_subnormals=flush_subnormals)


class A8W8_dynamic(_FromLinear):
    """Dynamic 8-bit activations (per-token scales, computed in the forward)
    x 8-bit weights with channel-wise scales: int8 x int8 with an exact
    int32 K sum, or with ``fp8`` fp8 activations x fp8 weights (bit codes)
    with a float32 sum; W_group_mode 0, csm 3, both scales applied after the
    sum. ``dtype`` is the output dtype."""

    def __init__(self, device=None, dtype: Optional[torch.dtype] = None,
                 fp8: Optional[torch.dtype] = None, fp32_scale: bool = True,
                 flush_subnormals: bool = True):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.fp8 = fp8
        self.fp32_scale = fp32_scale
        self.flush_subnormals = flush_subnormals

    def from_weights(self, weight, bias=None, scales=None) -> GemLiteLinear:
        weight = tensor_from_numpy(weight).to(self.device)
        input_dtype = TORCH_TO_DTYPE[self.fp8] if self.fp8 is not None else DType.INT8
        if scales is None:
            dtype = _float_dtype_of(weight, self.dtype)
            W_q, scales = _channelwise_quant_8bit(weight, self.fp8, self.flush_subnormals)
        else:
            if weight.element_size() != 1:
                raise ValueError("pre-quantized weight must be 8-bit")
            scales = tensor_from_numpy(scales).to(self.device)
            dtype = _float_dtype_of(scales, self.dtype)
            W_q = weight
        out_features, in_features = W_q.shape
        layer = GemLiteLinear(8, group_size=in_features, in_features=in_features,
                              out_features=out_features, input_dtype=input_dtype,
                              output_dtype=TORCH_TO_DTYPE[dtype], scaled_activations=True,
                              device=self.device)
        if bias is not None:
            bias = tensor_from_numpy(bias).to(dtype)
        layer.pack(W_q, scales.to(torch.float32 if self.fp32_scale else dtype), zeros=None,
                   bias=bias)
        layer.W_group_mode, layer.channel_scale_mode = 0, 3
        return layer


class A8W8_INT8_dynamic(A8W8_dynamic):
    def __init__(self, device=None, dtype: Optional[torch.dtype] = None):
        super().__init__(device, dtype, fp8=None)


class A8W8_FP8_dynamic(A8W8_dynamic):
    def __init__(self, device=None, dtype: Optional[torch.dtype] = None,
                 fp8: torch.dtype = DEFAULT_FP8, flush_subnormals: bool = True):
        super().__init__(device, dtype, fp8=fp8, flush_subnormals=flush_subnormals)


A8W8_int8_dynamic = A8W8_INT8_dynamic
A8W8_fp8_dynamic = A8W8_FP8_dynamic


class A8Wn_HQQ_INT_dynamic(A16Wn):
    """Dynamic fp8 activations (per-token scales) x packed grouped-INT Wn
    weights (W_group_mode 3 with bf16 scales and zeros, no fma fold; csm 2;
    at gs = K, mode 3 or with ``post_scale`` mode 1 and csm 3). Off the int
    path the fp8 x is computed in bf16."""

    def __init__(self, device=None, dtype: Optional[torch.dtype] = None,
                 post_scale: bool = False, fp8: torch.dtype = DEFAULT_FP8,
                 fp32_scale: bool = False, W_nbits: Optional[int] = None):
        if W_nbits is None:
            raise ValueError("W_nbits must be 8, 4, 2 or 1")
        super().__init__(device, dtype, post_scale)
        self.fp8 = fp8
        self.fp32_scale = fp32_scale
        self.W_nbits = W_nbits

    def from_weights(self, W_q, scales, zeros, bias=None) -> GemLiteLinear:
        W_q = tensor_from_numpy(W_q)
        scales = tensor_from_numpy(scales)
        zeros = tensor_from_numpy(zeros)
        group_size = W_q.numel() // scales.numel()
        dtype = _float_dtype_of(scales, self.dtype)
        out_features, in_features = W_q.shape
        layer = GemLiteLinear(self.W_nbits, group_size=group_size, in_features=in_features,
                              out_features=out_features, input_dtype=TORCH_TO_DTYPE[self.fp8],
                              output_dtype=TORCH_TO_DTYPE[dtype], scaled_activations=True,
                              device=self.device)
        if bias is not None:
            bias = tensor_from_numpy(bias).to(dtype)
        layer.pack(W_q.to(torch.uint8), scales.to(torch.float32 if self.fp32_scale else dtype),
                   zeros.to(dtype), bias=bias, fma_mode=False)
        if group_size == in_features:
            if self.post_scale:
                layer.W_group_mode, layer.channel_scale_mode = 1, 3
            else:
                layer.W_group_mode, layer.channel_scale_mode = 3, 2
        return layer

    def from_hqqlinear(self, hqq_layer, del_orig: bool = True) -> GemLiteLinear:
        """An ``hqq`` ``HQQLinear`` (axis 1) unpacked and packed here; raises
        ``ImportError`` without the ``hqq`` package."""
        try:
            import hqq  # noqa: F401
        except ImportError as e:
            raise ImportError("This processor requires the `hqq` package.") from e
        if hqq_layer.meta["axis"] != 1:
            raise ValueError("Only axis==1 is supported.")
        W_q = _host_tensor(hqq_layer.unpack(dtype=None)).reshape(hqq_layer.meta["shape"])
        scales = _host_tensor(hqq_layer.meta["scale"])
        zeros = _host_tensor(hqq_layer.meta["zero"])
        bias = _host_tensor(hqq_layer.bias) if hqq_layer.bias is not None else None
        cleanup_linear(hqq_layer, del_orig)
        return self.from_weights(W_q, scales, zeros, bias)


class A8W4_HQQ_INT_dynamic(A8Wn_HQQ_INT_dynamic):
    def __init__(self, device=None, dtype=None, post_scale=False, fp8=DEFAULT_FP8,
                 fp32_scale=False):
        super().__init__(device, dtype, post_scale, fp8, fp32_scale, W_nbits=4)


class A8W2_HQQ_INT_dynamic(A8Wn_HQQ_INT_dynamic):
    def __init__(self, device=None, dtype=None, post_scale=False, fp8=DEFAULT_FP8,
                 fp32_scale=False):
        super().__init__(device, dtype, post_scale, fp8, fp32_scale, W_nbits=2)


class A16W158_INT(_FromBitLinear):
    """BitNet b1.58: ternary weights {-1, 0, +1} stored as 2-bit codes
    ``w + 1`` with the scalar zero 1 (W_group_mode 1), one weight scale
    broadcast to a float32 channel scale column."""

    def __init__(self, device=None, dtype: Optional[torch.dtype] = None):
        self.device = resolve_device(device)
        self.dtype = dtype

    def _build(self, weight, weight_scale, bias, input_dtype, channel_scale_mode,
               scaled_activations) -> GemLiteLinear:
        weight = tensor_from_numpy(weight).to(self.device)
        dtype = _float_dtype_of(weight, self.dtype)
        gem_dtype = TORCH_TO_DTYPE[dtype]
        out_features, in_features = weight.shape
        W_q = (weight + 1).to(torch.uint8)
        ws = float(torch.as_tensor(weight_scale).reshape(-1)[0])
        scales = torch.full((out_features, 1), ws, device=self.device, dtype=torch.float32)
        if bias is not None:
            bias = tensor_from_numpy(bias).to(dtype)
        layer = GemLiteLinear(2, group_size=in_features, in_features=in_features,
                              out_features=out_features,
                              input_dtype=input_dtype if input_dtype is not None else gem_dtype,
                              output_dtype=gem_dtype, scaled_activations=scaled_activations,
                              device=self.device)
        layer.pack(W_q, scales=scales, zeros=1, bias=bias)
        layer.W_group_mode, layer.channel_scale_mode = 1, channel_scale_mode
        return layer

    def from_weights(self, weight, weight_scale, bias=None) -> GemLiteLinear:
        return self._build(weight, weight_scale, bias, None, 1, False)


class A8W158_INT_dynamic(A16W158_INT):
    def from_weights(self, weight, weight_scale, bias=None) -> GemLiteLinear:
        return self._build(weight, weight_scale, bias, DType.INT8, 3, True)


# ---------------------------------------------------------------------------
# Model patching and warm-up (``gemlite_tpu/helper.py:488-644``)
# ---------------------------------------------------------------------------

def _is_linear_like(m) -> bool:
    """A callable with a 2-d ``weight``; an embedding table is not a linear."""
    if isinstance(m, torch.nn.Embedding):
        return False
    shape = getattr(getattr(m, "weight", None), "shape", None)
    return shape is not None and len(shape) == 2 and callable(m)


def patch_model(model, processor, skip_modules=("lm_head", "vision", "visual"),
                group_size: int = 64, device=None):
    """Replace every linear-like layer of ``model`` with ``processor``'s
    ``from_linear`` of it, in place, and return ``model``.

    An ``nn.Module`` is walked through ``named_children`` and its children
    replaced through ``setattr`` (``GemLiteLinear`` is a module); any other
    object through its attributes, lists and tuples included. A layer whose
    dotted name holds one of ``skip_modules`` is left as it is. ``device``:
    where the new layers go (None: the processor's device). A processor
    without ``from_linear`` goes through ``HQQLinear`` with ``group_size``,
    which needs the ``hqq`` package (``ImportError`` without it)."""
    if not hasattr(processor, "from_linear"):
        try:
            import hqq  # noqa: F401
        except ImportError as e:
            raise ImportError("This processor requires the `hqq` package.") from e
        raise NotImplementedError(f"queued: from_hqqlinear ({type(processor).__name__}, "
                                  f"group_size={group_size})")
    dev = None if device is None else resolve_device(device)

    def convert(layer, name):
        if any(s in name for s in skip_modules):
            return layer
        out = processor.from_linear(layer)
        return out if dev is None else out.to(dev)

    def walk(mod, prefix=""):
        if isinstance(mod, torch.nn.Module):
            for name, child in list(mod.named_children()):
                full = f"{prefix}.{name}" if prefix else name
                if _is_linear_like(child):
                    setattr(mod, name, convert(child, full))
                else:
                    walk(child, full)
            return
        for name, child in list(vars(mod).items()):
            if child is None or isinstance(child, (int, float, str, bool)):
                continue
            full = f"{prefix}.{name}" if prefix else name
            if _is_linear_like(child):
                setattr(mod, name, convert(child, full))
            elif isinstance(child, (list, tuple)):
                new = []
                for i, c in enumerate(child):
                    if _is_linear_like(c):
                        new.append(convert(c, f"{full}.{i}"))
                    else:
                        if hasattr(c, "__dict__"):
                            walk(c, f"{full}.{i}")
                        new.append(c)
                setattr(mod, name, type(child)(new))
            elif hasattr(child, "__dict__"):
                walk(child, full)

    walk(model)
    return model


DEFAULT_WARMUP_BATCHES = sorted(set(_BUCKETS))[::-1]


def warmup(processor, shapes, batch_sizes=None, group_size: int = 64,
           dtype: torch.dtype = torch.bfloat16, device=None):
    """Build one layer a (out_features, in_features) shape from seeded random
    weights, as ``processor`` makes it, and run it once at each batch size
    (default: the M buckets up to 1024, largest first). On the card that
    builds and loads every kernel library the layers' routes use and
    launches each route once, so that a first real call pays for neither.
    Returns the layers."""
    dev = resolve_device(device)
    if batch_sizes is None:
        batch_sizes = [b for b in DEFAULT_WARMUP_BATCHES if b <= 1024]
    rng = np.random.default_rng(0)
    layers = []
    for out_features, in_features in shapes:
        w = torch.from_numpy(rng.normal(size=(out_features, in_features)).astype(np.float32)
                             * 0.02).to(dev)
        layer = _warmup_layer(processor, w, group_size)
        layers.append(layer)
        for bs in batch_sizes:
            x = torch.from_numpy(rng.normal(size=(bs, in_features)) * 0.1).to(dev, dtype)
            layer(x)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return layers


def _warmup_layer(processor, w: torch.Tensor, group_size: int) -> GemLiteLinear:
    """One layer from a float matrix by the processor's own constructor:
    BitNet through ``from_bitlinear`` on the signs, a processor that
    quantizes itself (A16W8, A8W8, every MX processor: its module is ``.mx``)
    through ``from_linear``, a grouped Wn one through the HQQ-style
    quantizer (``gemlite_tpu/helper.py:_warmup_layer``)."""
    if hasattr(processor, "from_bitlinear"):
        class _Bit:
            weight = torch.sign(w)
            weight_scale = float(w.abs().mean() + 1e-8)
            bias = None

        return processor.from_bitlinear(_Bit(), del_orig=False)
    if type(processor).__module__.endswith(".mx") or getattr(processor, "W_nbits", None) is None:
        class _Lin:
            weight = w
            bias = None

        return processor.from_linear(_Lin(), del_orig=False)
    return _warmup_quantize(processor, w, group_size)
