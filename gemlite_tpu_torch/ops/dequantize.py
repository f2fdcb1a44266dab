# SPDX-License-Identifier: Apache-2.0
"""Dequantize kernel: packed W4 words -> dense (K, N) bf16 in one pass
(``csrc/dequantize.cu``, CUDA C++ rather than Triton so that the three kernels
share one build).

Replaces ``gemlite_tpu/ops/pallas_prefill.py:pallas_dequantize``. The plain
version, ``dequantize_full``, is a copy of ``gemlite_tpu/autograd.py``'s. On a
CPU tensor the wrapper runs the plain version; on a CUDA tensor it launches
the kernel or raises.
"""

import ctypes

import torch

from ..dtypes import DType
from . import build, w4
from .reference import dequantize_ref, unpack_rows_ref

__all__ = ["can_use_dequantize", "dequantize_weights", "dequantize_full"]


def can_use_dequantize(meta) -> bool:
    return w4.serves(meta)


def dequantize_full(W_q, scales, zeros, meta, dtype=torch.bfloat16) -> torch.Tensor:
    """Packed layer state -> dense (K, N): dequantized in float32, channel
    scales (csm 1/3) folded in, one cast to ``dtype`` at the end."""
    b = unpack_rows_ref(W_q, meta.W_nbits, meta.elements_per_sample, meta.in_features)
    b = dequantize_ref(
        b, scales if meta.W_group_mode in (2, 3, 4) else None,
        zeros if meta.W_group_mode in (1, 3, 4) else None,
        W_group_mode=meta.W_group_mode, meta_dtype=DType.FP32,
        zero_is_scalar=bool(meta.zero_is_scalar)).to(torch.float32)
    if meta.channel_scale_mode in (1, 3) and scales is not None:
        b = b * scales.reshape(1, -1).to(torch.float32)
    return b.to(dtype)


def _lib():
    fn = build.load("dequantize").gl_dequantize_w4
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def dequantize_weights(W_q: torch.Tensor, scales, zeros, meta) -> torch.Tensor:
    """Dense (K, N) bf16 weight of a packed layer."""
    if W_q.device.type == "cpu":
        return dequantize_full(W_q, scales, zeros, meta)
    if not can_use_dequantize(meta):
        raise NotImplementedError(f"dequantize kernel does not take {meta}")
    w4.check_operands(W_q, scales, zeros, meta)
    N, K = meta.out_features, meta.in_features
    out = torch.empty((K, N), dtype=torch.bfloat16, device=W_q.device)
    err = _lib()(W_q.data_ptr(), scales.data_ptr(), zeros.data_ptr(), out.data_ptr(),
                 N, K, meta.group_size, w4.stream())
    build.check(err, "dequantize")
    dequantize_weights.launches += 1
    return out


dequantize_weights.launches = 0
