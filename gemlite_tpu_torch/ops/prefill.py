# SPDX-License-Identifier: Apache-2.0
"""Prefill kernel: fused W4 dequantize + bf16 tensor-core GEMM for
64 < M < 4096 (``csrc/prefill_gemm.cu``).

Replaces ``gemlite_tpu/ops/pallas_prefill.py:pallas_prefill_matmul``. The plain
version is ``ops/reference.forward_meta``. On a CPU tensor the wrapper runs the
plain version; on a CUDA tensor it launches the kernel or raises.
"""

import ctypes

import torch

from . import build, w4
from .reference import forward_meta

__all__ = ["can_use_prefill", "prefill_matmul", "prefill_matmul_plain"]

BK = 64   # the kernel's K step; a step must not straddle a quantization group


def can_use_prefill(meta, M: int) -> bool:
    return 64 < M < 4096 and w4.serves(meta, min_group=BK)


def prefill_matmul_plain(x, W_q, scales, zeros, meta):
    return forward_meta(x, W_q, scales, zeros, None, meta)


def _lib():
    fn = build.load("prefill_gemm").gl_prefill_w4
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def prefill_matmul(x: torch.Tensor, W_q, scales, zeros, meta) -> torch.Tensor:
    """out (M, N) bf16 = x (M, K) @ dequant(W_q) for 64 < M < 4096."""
    if x.device.type == "cpu":
        return prefill_matmul_plain(x, W_q, scales, zeros, meta)
    M = x.shape[0]
    if not can_use_prefill(meta, M):
        raise NotImplementedError(f"prefill kernel does not take M={M} with {meta}")
    N, K = meta.out_features, meta.in_features
    x = w4.activations(x, K)
    w4.check_operands(W_q, scales, zeros, meta)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    err = _lib()(x.data_ptr(), W_q.data_ptr(), scales.data_ptr(), zeros.data_ptr(),
                 out.data_ptr(), M, N, K, meta.group_size, w4.stream())
    build.check(err, "prefill_gemm")
    prefill_matmul.launches += 1
    return out


prefill_matmul.launches = 0
