# SPDX-License-Identifier: Apache-2.0
"""Dequantize kernel: W1 / W2 / W4 / W8 integer codes in W_group_mode 1-4
with their channel scale folded in, fp8 bit codes with their column scale
folded in, or MX codes with their group scale folded in, -> dense (K, N)
bf16 in one pass (``csrc/dequantize.cu``, entries ``gl_dequantize_int``,
``gl_dequantize_fp8`` and ``gl_dequantize_mx``).

It takes the integer-code layers that the JAX package dequantizes with
``pallas_dequantize`` at M >= 4096 (``jax_dequantizes``: the layers it folds
at pack time that its prefill gate at block_m 8 admits); the JAX package
dequantizes the other ones with plain XLA, as the port's router does
(``dense_fallback``).

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

from ..dtypes import DTYPE_TO_TORCH, DType
from . import build, w4
from .fp8 import fp8_coded, serves_fp8
from .mx import _weights, mx_coded, mx_refusal, w_kind
from .reference import dequantize_ref, fp8_values, mx_dequantize_weight_ref, unpack_rows_ref

__all__ = ["can_use_dequantize", "dequantize_weights", "dequantize_full", "dequantize_int",
           "jax_folds", "jax_dequantizes"]

# the block depths pallas_dequantize tries, in its order (pallas_prefill.py:_dequantize_blocks)
_JAX_BLOCK_K = (2048, 1024, 512, 4096, 256, 128)


def _serves_mx(meta) -> bool:
    """An MX layer the MX kernels take, the layer's csm aside (x is quantized
    outside the dequantize kernel)."""
    return mx_coded(meta) and mx_refusal(meta._replace(channel_scale_mode=0)) is None


def _fold_unit(meta):
    """The JAX package's fold unit of an integer-code layer
    (``gemlite_tpu/core.py:_plane_fold_unit``), or None where it keeps the
    reference layout: no fold for int8 x, modes outside 1-4, csm 4, W_nbits
    outside 1 / 2 / 4 / 8, and shapes its plane kernels do not take."""
    K, N, nbits, gs = meta.in_features, meta.out_features, meta.W_nbits, meta.group_size
    if (meta.input_dtype == DType.INT8.value or meta.W_group_mode not in (1, 2, 3, 4)
            or meta.channel_scale_mode == 4 or nbits not in (1, 2, 4, 8)
            or meta.elements_per_sample != 32 // nbits):
        return None
    F = gs if 1 < gs < K else 512
    planes = 4 if nbits == 8 else 16 // nbits
    if F > 512 or K % F or F % planes or (F // planes) % 8 or N % 128 or K % 128:
        return None
    return F


def jax_folds(meta) -> bool:
    """True for an integer-code layer that the JAX package folds at pack time;
    the ones it keeps in the reference layout its Pallas dequantize kernel
    refuses, and at M >= 4096 it dequantizes them with plain XLA."""
    return _fold_unit(meta) is not None


def jax_dequantizes(meta) -> bool:
    """True for an integer-code layer that the JAX package dequantizes with
    ``pallas_dequantize`` (``pallas_prefill.py:can_use_dequantize``, W_lo
    aside): it folds the layer, x is at most 2 bytes, some block depth of
    ``_dequantize_blocks`` holds whole fold units, and the prefill gate at
    block_m 8 takes that depth's groups (a block of several groups holds a
    multiple of 8 of them)."""
    F = _fold_unit(meta)
    x_dtype = DTYPE_TO_TORCH.get(meta.input_dtype)
    if F is None or x_dtype is None or x_dtype.itemsize > 2:
        return False
    K, gs = meta.in_features, meta.group_size
    bk = next((b for b in _JAX_BLOCK_K if K % b == 0 and b % F == 0), 0)
    if not bk:
        return False
    if 1 < gs < K:
        c, G = bk // gs, K // gs
        if 1 < c < G and c % 8:
            return False
    return True


def _int_coded(meta) -> bool:
    """An integer-code layer that ``gl_dequantize_int`` computes: W1 / W2 /
    W4 / W8 codes in int32 words, modes 1-4, csm 0-3, N a multiple of 4 and
    groups of whole words. The router sends it the ones of
    ``jax_dequantizes``; called directly it takes any of them."""
    nbits, gs = meta.W_nbits, meta.group_size
    return (not fp8_coded(meta) and not mx_coded(meta) and not getattr(meta, "w_code_dtype", 0)
            and nbits in (1, 2, 4, 8) and meta.elements_per_sample == 32 // nbits
            and meta.W_group_mode in (1, 2, 3, 4) and meta.channel_scale_mode in (0, 1, 2, 3)
            and meta.out_features % 4 == 0
            and (gs >= meta.in_features or gs % (32 // nbits) == 0))


def can_use_dequantize(meta) -> bool:
    """The layers the router sends to the dequantize kernel: JAX's."""
    if mx_coded(meta):
        return _serves_mx(meta)
    return serves_fp8(meta) or (_int_coded(meta) and jax_dequantizes(meta))


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


def _lib(name: str, pointers: int, ints: int):
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


def _meta_code(t) -> int:
    """The gl_common.cuh dtype code of a float32, fp16 or bf16 tensor."""
    codes = {torch.float32: DType.FP32.value, torch.float16: DType.FP16.value,
             torch.bfloat16: DType.BF16.value}
    if t.dtype not in codes:
        raise ValueError(f"metadata: want float32, fp16 or bf16, got {t.dtype}")
    return codes[t.dtype]


def _group_rows(t, name: str, meta):
    """A (G, N) metadata tensor on the card, contiguous, and the k rows a
    group row covers."""
    N, K = meta.out_features, meta.in_features
    if not (t.is_cuda and t.numel() % N == 0 and K % max(1, t.numel() // N) == 0):
        raise ValueError(f"{name}: want a CUDA tensor of (G, {N}) rows with G dividing {K}, "
                         f"got {tuple(t.shape)} on {t.device}")
    t = t.contiguous()
    _meta_code(t)
    return t, K // (t.numel() // N)


def dequantize_int(W_q: torch.Tensor, scales, zeros, meta) -> torch.Tensor:
    """Dense (K, N) bf16 weight of an integer-code layer (``gl_dequantize_int``;
    its own launch count). On a CPU tensor the plain version,
    ``dequantize_full``."""
    if W_q.device.type == "cpu":
        return dequantize_full(W_q, scales, zeros, meta)
    if not _int_coded(meta):
        raise NotImplementedError(f"dequantize kernel (int) does not take {meta}")
    N, K, mode = meta.out_features, meta.in_features, meta.W_group_mode
    shape = (K // meta.elements_per_sample, N)
    if not (W_q.is_cuda and W_q.dtype == torch.int32 and tuple(W_q.shape) == shape):
        raise ValueError(f"W_q: want a CUDA int32 tensor of shape {shape}, got {W_q.dtype} "
                         f"{tuple(W_q.shape)} on {W_q.device}")
    W_q = W_q.contiguous()
    if W_q.data_ptr() % 16:                   # the kernel reads four columns' words at once
        W_q = W_q.clone()
    s = z = zs = cs = None
    s_kpg = z_kpg = 0
    if mode != 1:
        s, s_kpg = _group_rows(scales, "scales", meta)
    if mode != 2:
        if meta.zero_is_scalar:
            zs = torch.as_tensor(zeros)
            if not (zs.is_cuda and zs.numel() == 1):
                raise ValueError(f"zeros: want one scalar zero on the card, got {zs}")
            if zs.dtype != torch.int32:
                _meta_code(zs)
        else:
            z, z_kpg = _group_rows(zeros, "zeros", meta)
    if meta.channel_scale_mode in (1, 3):
        cs = scales.contiguous()
        if not (cs.is_cuda and cs.numel() == N):
            raise ValueError(f"scales: want {N} channel scales on the card, got "
                             f"{tuple(cs.shape)}")
    code = lambda t: 0 if t is None else _meta_code(t)
    zs_code = DType.INT32.value if zs is not None and zs.dtype == torch.int32 else code(zs)
    out = torch.empty((K, N), dtype=torch.bfloat16, device=W_q.device)
    ptr = w4.pointer
    err = _lib("gl_dequantize_int", 6, 10)(
        W_q.data_ptr(), ptr(s), ptr(z), ptr(zs), ptr(cs), out.data_ptr(), N, K, meta.W_nbits,
        mode, code(s), code(z), zs_code, code(cs), s_kpg, z_kpg, w4.stream())
    build.check(err, "dequantize (int)")
    dequantize_int.launches += 1
    return out


dequantize_int.launches = 0


def dequantize_weights(W_q: torch.Tensor, scales, zeros, meta) -> torch.Tensor:
    """Dense (K, N) bf16 weight of a packed layer: of every layer the router
    sends to ``dequantize`` (``can_use_dequantize``), and of any integer-code
    layer ``dequantize_int`` computes."""
    if W_q.device.type == "cpu":
        return dequantize_full(W_q, scales, zeros, meta)
    if not (can_use_dequantize(meta) or _int_coded(meta)):
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
    return dequantize_int(W_q, scales, zeros, meta)


dequantize_weights.launches = 0
