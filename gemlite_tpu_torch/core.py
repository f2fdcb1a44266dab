# SPDX-License-Identifier: Apache-2.0
"""Layer API and functional forward (counterpart of ``gemlite_tpu/core.py``).

``GemLiteLinear`` is an ``nn.Module`` holding the packed weights and group
metadata as registered buffers, plus the reference 12-int metadata vector.
The port always packs the reference LSB-first layout (``w_layout=0``); layers
packed by the JAX package in its plane-folded layout are unfolded on load.
INT8- and FP8-activation layers (``scaled_activations``) quantize x per
token in the forward and hand its scales to the router. fp8 weights
(``float8_e4m3fn`` / ``float8_e5m2``) are stored as their bit codes, four to
an int32 word, and marked by ``w_code_dtype``. MX layers (input dtypes MXFP16,
MXBF16, MXFP8, MXFP4, NVFP4; ``mx.py``) keep fp4 codes eight to a word and
their group scales as e8m0 bits (uint8) or e4m3 (NVFP4), W_group_mode 2; an
MXFP8 layer with csm 2 quantizes x per token to e4m3, and micro-scaled x
(csm 4) goes to the router as it is. The JAX package's TPU codecs of MX
layers (the plane fold, ``mx_x2``, ``mx_flat``) are undone on load.
"""

import json
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from .bitpack import (fold_plane_count, pack_weights_over_cols,
                      unfold_codes_for_planes, unpack_over_rows)
from .dtypes import (FP8_INT8_DTYPES, DType, TORCH_TO_DTYPE, is_mx_dtype, npz_decode_array,
                     npz_encode_array, to_torch_dtype)
from .ops.dispatch import fused_matmul
from .quant import fp4x2_remap_packed, scale_activations_per_token

__all__ = ["GEMLITE_MATMUL_TYPES", "GEMLITE_MATMUL_TYPES_MAPPING", "GemLiteLinear",
           "LayerMeta", "forward_functional", "get_matmul_type", "resolve_device",
           "tensor_from_numpy"]

GEMLITE_ACC_DTYPE = {DType.FP16: DType.FP32, DType.BF16: DType.FP32,
                     DType.FP32: DType.FP32, DType.FP8: DType.FP32, DType.FP8e5: DType.FP32,
                     DType.INT8: DType.INT32, DType.MXFP16: DType.FP32,
                     DType.MXBF16: DType.FP32, DType.MXFP8: DType.FP32, DType.MXFP4: DType.FP32,
                     DType.NVFP4: DType.FP32}
# input dtypes whose activations are never quantized in the forward
_FLOAT_INPUTS = (DType.FP16, DType.BF16, DType.FP32, DType.MXFP16, DType.MXBF16)

_FP8_WEIGHTS = {torch.float8_e4m3fn: DType.FP8, torch.float8_e5m2: DType.FP8e5}


def _fp8_codes_subnormal_free(codes_or_packed: torch.Tensor, e5m2: bool) -> bool:
    """True when no stored fp8 bit code is subnormal (E = 0, M != 0), on the
    uint8 codes or the packed int32 words (packing only moves the bytes)
    (``gemlite_tpu/core.py:_fp8_codes_subnormal_free``)."""
    b = codes_or_packed.contiguous().view(torch.uint8)
    exp_m, man_m = (0x7C, 0x03) if e5m2 else (0x78, 0x07)
    return not bool((((b & exp_m) == 0) & ((b & man_m) != 0)).any())


def _mx_scales(scales: torch.Tensor, input_dtype: DType) -> torch.Tensor:
    """An MX layer's group scales as stored: e8m0 exponent bits (uint8) from
    uint8, float8_e8m0fnu or power-of-two floats; NVFP4's as e4m3."""
    if input_dtype == DType.NVFP4:
        return scales.to(torch.float8_e4m3fn)
    if scales.dtype == torch.uint8:
        return scales
    if scales.dtype == torch.float8_e8m0fnu:
        return scales.view(torch.uint8)
    from .quant import _f32_pow2_to_e8m0_bits
    return _f32_pow2_to_e8m0_bits(scales)


# Kernel family names, in the reference's order: their index is the
# ``matmul_type`` of forward_functional (``gemlite_tpu/core.py:62-68``).
GEMLITE_MATMUL_TYPES = ["GEMV", "GEMV_REVSPLITK", "GEMV_SPLITK", "GEMM_SPLITK", "GEMM"]
GEMLITE_MATMUL_TYPES_MAPPING = {name: i for i, name in enumerate(GEMLITE_MATMUL_TYPES)}


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Raises when no card is present and the caller
    did not ask for the CPU: the plain versions are never a silent fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                           "the plain PyTorch versions on the CPU")
    return dev


_FP8_NUMPY = {"float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2,
              "float8_e8m0fnu": torch.float8_e8m0fnu}


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """numpy array (bfloat16 and fp8 arrays from ml_dtypes included) or
    tensor -> tensor.

    A bfloat16 or fp8 numpy array is read through its bit view, so no
    ml_dtypes import is needed here."""
    if isinstance(a, torch.Tensor):
        return a.to(device) if device is not None else a
    a = np.asarray(a)
    if not a.flags.writeable:      # e.g. the buffer of a JAX array
        a = a.copy()
    shape = a.shape                # np.ascontiguousarray makes a 0-d array 1-d
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).astype(np.int16))
        t = t.view(torch.bfloat16).reshape(shape)
    elif a.dtype.name in _FP8_NUMPY:
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint8))
        t = t.view(_FP8_NUMPY[a.dtype.name]).reshape(shape)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a)).reshape(shape)
    return t.to(device) if device is not None else t


def get_matmul_type(batch_size: int, W_nbits: int, mx_dtype: bool = False) -> str:
    """Kernel family name by flattened batch size (reference API parity)."""
    if batch_size > 64:
        return "GEMM"
    if batch_size > 1:
        return "GEMM_SPLITK"
    if mx_dtype:
        return "GEMM_SPLITK"
    return "GEMV_REVSPLITK" if W_nbits < 8 else "GEMV_SPLITK"


class LayerMeta(NamedTuple):
    """Static layer configuration: fields [0:12] are the reference metadata
    vector in the reference order; the rest are shapes and the zero form."""

    scaled_activations: int
    W_nbits: int
    group_size: int
    unpack_mask: int
    elements_per_sample: int
    input_dtype: int
    output_dtype: int
    acc_dtype: int
    meta_dtype: int
    channel_scale_mode: int
    W_group_mode: int
    data_contiguous: int
    in_features: int = 0
    out_features: int = 0
    zero_is_scalar: int = 0
    # fp8 weight codes: the DType value of the stored bit codes (FP8 for
    # e4m3fn, FP8e5 for e5m2), 0 for integer codes
    w_code_dtype: int = 0
    # 1 when a pack-time scan found no subnormal fp8 code (the JAX plane
    # kernels' fast decode; the port's kernels decode every code exactly)
    fp8_nosub: int = 0

    @property
    def meta_args(self):
        return list(self[:12])


def forward_functional(x: torch.Tensor, bias, tensor_args, meta: LayerMeta,
                       matmul_type: int = -1) -> torch.Tensor:
    """Fused forward: x (..., K) -> (..., N) through the regime router. An
    INT8 layer with ``scaled_activations`` quantizes x per token first
    (``gemlite_tpu/core.py:forward_functional``).

    ``matmul_type`` indexes GEMLITE_MATMUL_TYPES (-1: the family of M). In
    the JAX package a family only sets the general kernel's preferred block
    and config lookup, and M still chooses the route; the port's plans are
    fixed per M, so the route and the result are M's whatever the family."""
    if not -1 <= matmul_type < len(GEMLITE_MATMUL_TYPES):
        raise IndexError(f"matmul_type {matmul_type} names no kernel family")
    W_q, scales, zeros = tensor_args
    out_shape = x.shape[:-1] + (meta.out_features,)
    scales_x = None
    if meta.scaled_activations and DType(meta.input_dtype) in FP8_INT8_DTYPES:
        x, scales_x = scale_activations_per_token(x, to_torch_dtype(meta.input_dtype))
    elif (meta.scaled_activations and meta.input_dtype == DType.MXFP8.value
          and meta.channel_scale_mode == 2):
        x, scales_x = scale_activations_per_token(x, torch.float8_e4m3fn)
    out = fused_matmul(x.reshape(-1, x.shape[-1]), W_q, scales, zeros, meta, scales_x)
    out = out.reshape(out_shape)
    if bias is not None:
        out = out + bias
    return out


# non-packed weight dtype -> the W_nbits it stands for
_NON_PACKED_BITS = {torch.int8: 8, torch.float16: 16, torch.bfloat16: 16}


def _as_tensor(a, device):
    return None if a is None else tensor_from_numpy(a).to(device)


class GemLiteLinear(nn.Module):
    """Quantized linear layer: ``pack()`` once, then call it like a module.

    Packs float-, INT8- and FP8-activation layers over W1/W2/W4/W8 codes, fp8
    bit codes, or non-packed int8 / fp16 / bf16 weights: W_group_mode 0-4,
    channel_scale_mode 0-3, the fma fold of mode 4 (``zeros := -z*s``
    computed in float32 and stored in the zeros' dtype); and MX layers (fp4
    or fp8 codes with group scales, mode 2; csm 2 or 4 set by the MX
    processors)."""

    SUPPORTED_BITS = (1, 2, 4, 8, 16)
    SUPPORTED_DTYPES = (DType.FP16, DType.BF16, DType.FP32, DType.FP8, DType.FP8e5, DType.INT8,
                        DType.MXFP16, DType.MXBF16, DType.MXFP8, DType.MXFP4, DType.NVFP4)
    MIN_SIZE = 32

    def __init__(self, W_nbits: int = 4, group_size: Optional[int] = 64,
                 in_features: Optional[int] = None, out_features: Optional[int] = None,
                 input_dtype: DType = DType.BF16, output_dtype: DType = DType.BF16,
                 acc_dtype: Optional[DType] = None, scaled_activations: bool = False,
                 device=None):
        super().__init__()
        if W_nbits not in self.SUPPORTED_BITS:
            raise NotImplementedError(f"only W_nbits in {self.SUPPORTED_BITS} are ported")
        if input_dtype not in self.SUPPORTED_DTYPES:
            raise NotImplementedError(f"queued: input dtype {input_dtype}")
        if in_features is not None and out_features is not None:
            if in_features % self.MIN_SIZE or (group_size is not None and in_features % group_size):
                raise NotImplementedError(
                    f"Invalid input shapes {in_features}, {out_features}: in_features must be "
                    f"divisible by {self.MIN_SIZE} and by group_size.")
        if group_size is not None and group_size < 16:
            raise NotImplementedError("Only group_size >= 16 is supported.")
        self.device = resolve_device(device)
        self.W_nbits = W_nbits
        self.group_size = 1 if group_size is None else group_size
        self.in_features = in_features
        self.out_features = out_features
        self.unpack_mask = 2 ** W_nbits - 1
        self.elements_per_sample = None
        self.input_dtype = input_dtype
        self.output_dtype = output_dtype
        self.meta_dtype = input_dtype
        self.acc_dtype = GEMLITE_ACC_DTYPE[input_dtype] if acc_dtype is None else acc_dtype
        # float activations are never dynamically quantized
        self.scaled_activations = bool(scaled_activations) and input_dtype not in _FLOAT_INPUTS
        self.channel_scale_mode = 0
        self.W_group_mode = -1
        self.data_contiguous = True
        self.zero_is_scalar = False
        self.w_code_dtype = 0
        self.fp8_nosub = 0
        for name in ("W_q", "scales", "zeros", "bias"):
            self.register_buffer(name, None)

    def pack(self, W_q, scales=None, zeros=None, bias=None, fma_mode: bool = True,
             contiguous: Optional[bool] = None):
        """Pack (N, K) uint8 codes, (N, K) fp8 weights (W_nbits 8: their bit
        codes, four to an int32 word, ``w_code_dtype`` set), or non-packed
        (N, K) int8 / fp16 / bf16 weights, and (G, 1)-shaped group metadata.

        Follows the decision tree of ``gemlite_tpu/core.py:pack``; packed
        words stay in the LSB-first layout (w_layout=0), non-packed weights
        are stored transposed (K, N) with ``elements_per_sample=1``. An MX
        layer needs its group scales: e8m0 bits (uint8, float8_e8m0fnu or
        power-of-two floats) or, for NVFP4, e4m3 values; they are stored
        (G, N), with W_group_mode 2 and csm 0."""
        dev = self.device
        W_q = tensor_from_numpy(W_q).to(dev)
        if zeros is not None and self.input_dtype == DType.INT8:
            zf = tensor_from_numpy(zeros)
            if zf.is_floating_point() and bool((zf != torch.round(zf)).any()):
                raise ValueError("INT8 inputs are not compatible with floating-point zeros.")
        if self.out_features is None or self.in_features is None:
            self.out_features, self.in_features = W_q.shape
        N = self.out_features
        self.w_code_dtype = self.fp8_nosub = 0
        if self.W_nbits == 8 and W_q.dtype in _FP8_WEIGHTS:
            self.w_code_dtype = _FP8_WEIGHTS[W_q.dtype].value
            W_q = W_q.view(torch.uint8)
            self.fp8_nosub = int(_fp8_codes_subnormal_free(
                W_q, e5m2=self.w_code_dtype == DType.FP8e5.value))
        if W_q.dtype == torch.uint8:
            self.W_q, self.elements_per_sample = pack_weights_over_cols(
                W_q.reshape(N, self.in_features), self.W_nbits, 32, transpose=True)
            if contiguous is None:
                contiguous = not is_mx_dtype(self.input_dtype)
        elif W_q.dtype in _NON_PACKED_BITS:
            if _NON_PACKED_BITS[W_q.dtype] != self.W_nbits:
                raise ValueError(f"{W_q.dtype} weights require W_nbits="
                                 f"{_NON_PACKED_BITS[W_q.dtype]}")
            self.W_q = W_q.reshape(N, self.in_features).T.contiguous()
            self.elements_per_sample = 1
            contiguous = False if contiguous is None else contiguous
        else:
            raise ValueError(f"Cannot pack W_q with dtype {W_q.dtype}")
        self.data_contiguous = bool(contiguous)
        self.bias = _as_tensor(bias, dev)
        scales = _as_tensor(scales, dev)

        self.W_group_mode = -1
        self.channel_scale_mode = 0
        if scales is None and zeros is None:
            self.W_group_mode = 0
        self.scales = None if scales is None else scales.reshape(N, -1).T.contiguous()
        channelwise = self.scales is not None and self.scales.numel() == N

        self.zero_is_scalar = zeros is not None and np.ndim(zeros) == 0
        if zeros is None:
            self.zeros = None
            if self.W_group_mode == -1:
                self.W_group_mode = 2 if self.scales is not None else 0
        elif self.zero_is_scalar:
            self.zeros = torch.tensor(int(zeros), dtype=torch.int32, device=dev)
            self.W_group_mode = 3 if self.scales is not None else 1
        else:
            z = _as_tensor(zeros, dev)
            if fma_mode and not channelwise:
                zf = -z.to(torch.float32) * scales.to(torch.float32)
                self.zeros = zf.to(z.dtype).reshape(N, -1).T.contiguous()
                self.W_group_mode = 4
            else:
                self.zeros = z.reshape(N, -1).T.contiguous()
                self.W_group_mode = 3

        # post-accumulation channel scaling overrides
        if channelwise:
            self.channel_scale_mode = 3 if self.scaled_activations else 1
            self.W_group_mode = 1 if self.zeros is not None else 0
        elif self.scaled_activations:
            self.channel_scale_mode = 2

        if is_mx_dtype(self.input_dtype):
            if self.scales is None:
                raise ValueError(f"{self.input_dtype} layers require block scales: pack() "
                                 "expects the e8m0 / fp8 scales of WeightQuantizerMXFP")
            self.scales = _mx_scales(self.scales, self.input_dtype)
            self.W_group_mode, self.channel_scale_mode = 2, 0
        self._upgrade_fp8_nosub()
        if self.scales is not None and self.scales.dtype in TORCH_TO_DTYPE:
            self.meta_dtype = TORCH_TO_DTYPE[self.scales.dtype]
        return self

    def _upgrade_fp8_nosub(self):
        """fp8_nosub 1 -> 2 for a mode-2 layer whose e8m0 (uint8) block-scale
        exponents keep the JAX prefill kernel's scaled fold finite
        (``gemlite_tpu/core.py:_upgrade_fp8_nosub``): MXFP8 layers. The
        port's kernels decode every code exactly and do not read the flag;
        it is kept so that the state reads as the JAX package's."""
        if (self.fp8_nosub == 1 and self.W_group_mode == 2 and self.scales is not None
                and self.scales.dtype == torch.uint8):
            gap = 112 if self.w_code_dtype == DType.FP8e5.value else 120
            e = self.scales
            if e.numel() and int(e.min()) >= 1 and int(e.max()) <= 254 - gap:
                self.fp8_nosub = 2

    @property
    def meta(self) -> LayerMeta:
        return LayerMeta(
            scaled_activations=int(self.scaled_activations),
            W_nbits=self.W_nbits,
            group_size=self.group_size,
            unpack_mask=self.unpack_mask,
            elements_per_sample=self.elements_per_sample,
            input_dtype=self.input_dtype.value,
            output_dtype=self.output_dtype.value,
            acc_dtype=self.acc_dtype.value,
            meta_dtype=self.meta_dtype.value,
            channel_scale_mode=self.channel_scale_mode,
            W_group_mode=self.W_group_mode,
            data_contiguous=int(self.data_contiguous),
            in_features=self.in_features,
            out_features=self.out_features,
            zero_is_scalar=int(self.zero_is_scalar),
            w_code_dtype=int(self.w_code_dtype),
            fp8_nosub=int(self.fp8_nosub),
        )

    def get_meta_args(self):
        """The reference 12-int metadata vector."""
        return self.meta.meta_args

    def get_tensor_args(self):
        return [self.W_q, self.scales, self.zeros]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return forward_functional(x, self.bias, self.get_tensor_args(), self.meta)

    def forward_manual(self, x: torch.Tensor, matmul_type: str = "GEMM") -> torch.Tensor:
        """``forward`` under a kernel family's name (``KeyError`` for a name
        not in GEMLITE_MATMUL_TYPES). M picks the route as in ``forward``, so
        the result equals ``forward``'s (see ``forward_functional``)."""
        return forward_functional(x, self.bias, self.get_tensor_args(), self.meta,
                                  GEMLITE_MATMUL_TYPES_MAPPING[matmul_type])

    # ------------------------------------------------------------------
    # Serialization in the JAX package's format: the metadata vector, the
    # original shape and the arrays.
    # ------------------------------------------------------------------
    def state_dict(self, *args, **kwargs):
        """The layer in the JAX package's format. Called with arguments, as a
        parent module's state_dict calls it, it is nn.Module's (buffers only)."""
        if args or kwargs:
            return super().state_dict(*args, **kwargs)
        sd = {
            "metadata": torch.tensor(self.get_meta_args(), dtype=torch.int32),
            "orig_shape": torch.tensor([self.out_features, self.in_features], dtype=torch.int32),
            "W_q": self.W_q,
        }
        for name in ("scales", "zeros", "bias"):
            if getattr(self, name) is not None:
                sd[name] = getattr(self, name)
        for name in ("w_code_dtype", "fp8_nosub"):
            if getattr(self, name):
                sd[name] = torch.tensor(getattr(self, name), dtype=torch.int32)
        return sd

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        """Load a state dict of this package or of the JAX package (numpy
        arrays). A plane-folded JAX layer (``w_layout`` 1 or 2) is unfolded to
        w_layout=0, with the logic of ``GemLiteLinear.to_reference_layout``;
        fp8 bit codes keep their ``w_code_dtype`` and ``fp8_nosub`` (a file
        without the flag is scanned, as the JAX package does)."""
        sd = dict(state_dict)
        meta = [int(v) for v in np.asarray(sd["metadata"])]
        (scaled_activations, self.W_nbits, self.group_size, self.unpack_mask,
         self.elements_per_sample, input_dtype, output_dtype, acc_dtype, meta_dtype,
         self.channel_scale_mode, self.W_group_mode, data_contiguous) = meta
        if DType(input_dtype) not in self.SUPPORTED_DTYPES:
            raise NotImplementedError(f"layer metadata {meta}: the *nuz fp8 inputs are "
                                      "refused, as the JAX kernels refuse them")
        self.scaled_activations = bool(scaled_activations)
        self.data_contiguous = bool(data_contiguous)
        self.input_dtype = DType(input_dtype)
        self.output_dtype = DType(output_dtype)
        self.acc_dtype = DType(acc_dtype)
        self.meta_dtype = DType(meta_dtype)
        self.out_features, self.in_features = (int(v) for v in np.asarray(sd["orig_shape"]))
        dev = self.device
        W_q = tensor_from_numpy(sd["W_q"]).to(dev)
        w_layout = int(np.asarray(sd.get("w_layout", 0)))
        if w_layout:
            W_q = self._unfold(W_q, w_layout)
        # the x2 fp4 codebook (JAX mx_x2): the remap is its own inverse, and
        # the stored e8m0 exponents were lowered by one; mx_flat is a flag
        mx_x2 = int(np.asarray(sd.get("mx_x2", 0)))
        if mx_x2:
            W_q = fp4x2_remap_packed(W_q)
        self.W_q = W_q
        self.w_code_dtype = int(np.asarray(sd.get("w_code_dtype", 0)))
        if "fp8_nosub" in sd:
            self.fp8_nosub = int(np.asarray(sd["fp8_nosub"]))
        elif self.w_code_dtype:
            self.fp8_nosub = int(_fp8_codes_subnormal_free(
                W_q, e5m2=self.w_code_dtype == DType.FP8e5.value))
        else:
            self.fp8_nosub = 0
        self.scales = _as_tensor(sd.get("scales"), dev)
        if is_mx_dtype(input_dtype) and self.scales is not None:
            self.scales = _mx_scales(self.scales, self.input_dtype)
            if mx_x2:
                self.scales = self.scales + 1
        self.zeros = _as_tensor(sd.get("zeros"), dev)
        self.zero_is_scalar = self.zeros is not None and self.zeros.ndim == 0
        self.bias = _as_tensor(sd.get("bias"), dev)
        self._upgrade_fp8_nosub()
        return self

    def _unfold(self, W_q: torch.Tensor, w_layout: int) -> torch.Tensor:
        """Plane-folded words -> w_layout 0, by the JAX fold unit
        (``gemlite_tpu/core.py:_plane_fold_unit``): 32 for NVFP4, the group
        for other MX layers and for 1 < group < K, else 512."""
        K = self.in_features
        if self.input_dtype == DType.NVFP4:
            fold_gs = 32
        elif is_mx_dtype(self.input_dtype) or 1 < self.group_size < K:
            fold_gs = self.group_size
        else:
            fold_gs = 512
        codes = unpack_over_rows(W_q, self.W_nbits, K).T
        codes = unfold_codes_for_planes(codes, fold_plane_count(self.W_nbits, w_layout), fold_gs)
        return pack_weights_over_cols(codes, self.W_nbits, 32, transpose=True)[0]

    @classmethod
    def from_state_dict(cls, state_dict, device=None) -> "GemLiteLinear":
        meta = [int(v) for v in np.asarray(state_dict["metadata"])]
        out_f, in_f = (int(v) for v in np.asarray(state_dict["orig_shape"]))
        group_size = meta[2] if meta[2] > 1 else None      # 1: packed without groups
        layer = cls(meta[1], group_size, in_f, out_f, input_dtype=DType(meta[5]),
                    output_dtype=DType(meta[6]), scaled_activations=bool(meta[0]),
                    device=device)
        return layer.load_state_dict(state_dict)

    def save(self, path: str) -> None:
        """One npz of ``state_dict()``, bf16 / fp8 arrays as bit views named
        in a ``__dtypes__`` entry (the JAX package's ``GemLiteLinear.save``)."""
        arrays, markers = {}, {}
        for k, v in self.state_dict().items():
            arrays[k], marker = npz_encode_array(v)
            if marker:
                markers[k] = marker
        if markers:
            arrays["__dtypes__"] = np.frombuffer(json.dumps(markers).encode(), dtype=np.uint8)
        np.savez(path, **arrays)

    @classmethod
    def load(cls, path: str, device=None) -> "GemLiteLinear":
        """A layer that ``save`` wrote, in this package or the JAX package
        (plane-folded layers unfold), on ``device``."""
        dev = resolve_device(device)
        with np.load(path, allow_pickle=False) as data:
            sd = {k: data[k] for k in data.files}
        markers = json.loads(bytes(sd.pop("__dtypes__")).decode()) if "__dtypes__" in sd else {}
        sd = {k: npz_decode_array(v, markers.get(k)) for k, v in sd.items()}
        return cls.from_state_dict(sd, device=dev)

    def _apply(self, fn, recurse=True):
        out = super()._apply(fn, recurse)
        if self.W_q is not None:
            self.device = self.W_q.device
        return out

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"W_nbits={self.W_nbits}, group_size={self.group_size}")
