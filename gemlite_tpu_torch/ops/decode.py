# SPDX-License-Identifier: Apache-2.0
"""Decode kernel: W1/W2/W4 GEMV / split-K for M <= 64 (``csrc/decode_gemv.cu``,
entry ``gl_decode``).

Replaces ``gemlite_tpu/ops/pallas_decode.py:pallas_decode_matmul`` on the
mode-4 bf16 layers that ``A16Wn_HQQ_INT(dtype=bf16)`` makes. The plain
version is ``ops/reference.forward_meta``. On a CPU tensor the wrapper runs the
plain version; on a CUDA tensor it launches the kernel or raises. The stacked
entry over (L, ...) weights is ``ops/scan.py``.
"""

import ctypes

import torch

from . import build, w4
from .reference import forward_meta

__all__ = ["DECODE_BITS", "can_use_decode", "decode_matmul", "decode_matmul_plain",
           "split_plan"]

MAX_M = 64
DECODE_BITS = (1, 2, 4)
_COLS_PER_BLOCK = 128


def can_use_decode(meta, M: int) -> bool:
    return 0 < M <= MAX_M and w4.serves(meta, bits=DECODE_BITS)


def split_plan(N: int, K: int, gs: int):
    """(splits, k_per_split): K cut on group boundaries so that the grid holds
    about two blocks per SM. Depends on N and K only, never on M, so a row's
    sum is the same whatever the batch."""
    return build.split_k(-(-N // _COLS_PER_BLOCK), K, gs)


def decode_matmul_plain(x, W_q, scales, zeros, meta):
    return forward_meta(x, W_q, scales, zeros, None, meta)


def _lib():
    fn = build.load("decode_gemv").gl_decode
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def decode_matmul(x: torch.Tensor, W_q, scales, zeros, meta) -> torch.Tensor:
    """out (M, N) bf16 = x (M, K) @ dequant(W_q) for M <= 64."""
    if x.device.type == "cpu":
        return decode_matmul_plain(x, W_q, scales, zeros, meta)
    M = x.shape[0]
    if not can_use_decode(meta, M):
        raise NotImplementedError(f"decode kernel does not take M={M} with {meta}")
    N, K, gs = meta.out_features, meta.in_features, meta.group_size
    x = w4.activations(x, K)
    w4.check_operands(W_q, scales, zeros, meta)
    splits, k_per_split = split_plan(N, K, gs)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    partial = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    err = _lib()(x.data_ptr(), W_q.data_ptr(), scales.data_ptr(), zeros.data_ptr(),
                 partial.data_ptr() if partial is not None else None, out.data_ptr(),
                 M, N, K, gs, meta.W_nbits, splits, k_per_split, w4.stream())
    build.check(err, "decode_gemv")
    decode_matmul.launches += 1
    return out


decode_matmul.launches = 0
