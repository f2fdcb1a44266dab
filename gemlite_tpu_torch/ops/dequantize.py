# SPDX-License-Identifier: Apache-2.0
"""Dequantize kernel: packed W4 words of mode 4, fp8 bit codes with their
column scale folded in, or MX codes with their group scale folded in, ->
dense (K, N) bf16 in one pass (``csrc/dequantize.cu``, entries
``gl_dequantize_w4``, ``gl_dequantize_fp8`` and ``gl_dequantize_mx``).

Replaces ``gemlite_tpu/ops/pallas_prefill.py:pallas_dequantize``. The plain
version, ``dequantize_full``, is a copy of ``gemlite_tpu/autograd.py``'s, with
fp8 codes read as their fp8 values (the JAX copy reads the bytes as integer
codes; its Pallas kernel, which serves the JAX router's fp8 layers, reads
them as fp8), and MX codes as ``ops/reference.mx_dequantize_weight_ref``
reads them. On a CPU tensor the wrapper runs the plain version; on a CUDA
tensor it launches the kernel or raises.
"""

import ctypes

import torch

from ..dtypes import DType
from . import build, w4
from .fp8 import fp8_coded, serves_fp8
from .mx import _weights, mx_coded, mx_refusal, w_kind
from .reference import dequantize_ref, fp8_values, mx_dequantize_weight_ref, unpack_rows_ref

__all__ = ["can_use_dequantize", "dequantize_weights", "dequantize_full"]


def _serves_mx(meta) -> bool:
    """An MX layer the MX kernels take, the layer's csm aside (x is quantized
    outside the dequantize kernel)."""
    return mx_coded(meta) and mx_refusal(meta._replace(channel_scale_mode=0)) is None


def can_use_dequantize(meta) -> bool:
    if mx_coded(meta):
        return _serves_mx(meta)
    return w4.serves(meta) or serves_fp8(meta)


def dequantize_full(W_q, scales, zeros, meta, dtype=torch.bfloat16) -> torch.Tensor:
    """Packed layer state -> dense (K, N): dequantized in float32, channel
    scales (csm 1/3) folded in, one cast to ``dtype`` at the end."""
    if mx_coded(meta):
        return mx_dequantize_weight_ref(W_q, scales, meta).to(dtype)
    if fp8_coded(meta):
        b = fp8_values(W_q, meta)
        if meta.W_group_mode == 2 or meta.channel_scale_mode in (1, 3):
            s = scales.reshape(-1, meta.out_features).to(torch.float32)
            b = b * torch.repeat_interleave(s, meta.in_features // s.shape[0], dim=0)
        return b.to(dtype)
    b = unpack_rows_ref(W_q, meta.W_nbits, meta.elements_per_sample, meta.in_features)
    b = dequantize_ref(
        b, scales if meta.W_group_mode in (2, 3, 4) else None,
        zeros if meta.W_group_mode in (1, 3, 4) else None,
        W_group_mode=meta.W_group_mode, meta_dtype=DType.FP32,
        zero_is_scalar=bool(meta.zero_is_scalar)).to(torch.float32)
    if meta.channel_scale_mode in (1, 3) and scales is not None:
        b = b * scales.reshape(1, -1).to(torch.float32)
    return b.to(dtype)


def _lib(name: str = "gl_dequantize_w4", pointers: int = 4, ints: int = 3):
    fn = getattr(build.load("dequantize"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _dequantize_fp8(W_q: torch.Tensor, scales, meta) -> torch.Tensor:
    N, K = meta.out_features, meta.in_features
    if not (W_q.is_cuda and W_q.dtype == torch.int32 and tuple(W_q.shape) == (K // 4, N)
            and W_q.is_contiguous() and W_q.data_ptr() % 16 == 0):
        raise ValueError(f"W_q: want a contiguous, 16-byte aligned CUDA int32 tensor of shape "
                         f"{(K // 4, N)}, got {W_q.dtype} {tuple(W_q.shape)}")
    s = None
    if meta.W_group_mode == 2 or meta.channel_scale_mode in (1, 3):
        s = scales.contiguous()
        if not (s.is_cuda and s.numel() == N and s.dtype in (torch.float32, torch.bfloat16)):
            raise ValueError(f"scales: want {N} float32 / bf16 column scales on the card")
    out = torch.empty((K, N), dtype=torch.bfloat16, device=W_q.device)
    s_code = DType.BF16.value if s is not None and s.dtype == torch.bfloat16 else DType.FP32.value
    err = _lib("gl_dequantize_fp8", 3, 4)(W_q.data_ptr(), None if s is None else s.data_ptr(),
                                          out.data_ptr(), N, K, meta.w_code_dtype, s_code,
                                          w4.stream())
    build.check(err, "dequantize (fp8)")
    return out


def dequantize_weights(W_q: torch.Tensor, scales, zeros, meta) -> torch.Tensor:
    """Dense (K, N) bf16 weight of a packed layer."""
    if W_q.device.type == "cpu":
        return dequantize_full(W_q, scales, zeros, meta)
    if not can_use_dequantize(meta):
        raise NotImplementedError(f"dequantize kernel does not take {meta}")
    if mx_coded(meta):
        W_q, s = _weights(W_q, scales, meta)
        N, K = meta.out_features, meta.in_features
        out = torch.empty((K, N), dtype=torch.bfloat16, device=W_q.device)
        err = _lib("gl_dequantize_mx", 3, 4)(W_q.data_ptr(), s.data_ptr(), out.data_ptr(), N, K,
                                             w_kind(meta), meta.group_size, w4.stream())
        build.check(err, "dequantize (mx)")
        dequantize_weights.launches += 1
        return out
    if fp8_coded(meta):
        out = _dequantize_fp8(W_q, scales, meta)
        dequantize_weights.launches += 1
        return out
    w4.check_operands(W_q, scales, zeros, meta)
    N, K = meta.out_features, meta.in_features
    out = torch.empty((K, N), dtype=torch.bfloat16, device=W_q.device)
    err = _lib()(W_q.data_ptr(), scales.data_ptr(), zeros.data_ptr(), out.data_ptr(),
                 N, K, meta.group_size, w4.stream())
    build.check(err, "dequantize")
    dequantize_weights.launches += 1
    return out


dequantize_weights.launches = 0
