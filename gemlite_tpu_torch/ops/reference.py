# SPDX-License-Identifier: Apache-2.0
"""Plain PyTorch versions of the fused forward: the port's numerics oracle.

These are the plain versions the hand-written kernels are held against (the
counterpart of ``gemlite_tpu/ops/reference.py``). The dispatch runs them only
for tensors on the CPU.

W_group_mode, per K-group dequantization of the weight:
    0: none (raw codes)
    1: b - zeros                   (shift only)
    2: b * scales                  (symmetric grouped)
    3: (b - zeros) * scales        (cast order depends on zero_is_scalar)
    4: b * scales + zeros          (fma; zeros pre-folded to -z*s at pack)

channel_scale_mode, epilogue on the (M, N) accumulator:
    0: none   1: * scales_w[None, :]   2: * scales_x[:, None]   3: both

fp8 bit codes (``w_code_dtype``): the bytes are the fp8 weights themselves,
summed against x in float32 and scaled after the dot (``forward_fp8_ref``).
"""

import torch

from ..bitpack import unpack_over_rows
from ..dtypes import DType, to_torch_dtype

__all__ = ["unpack_rows_ref", "dequantize_ref", "int_matmul", "forward_ref", "forward_meta",
           "fp8_values", "forward_fp8_ref"]


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of two integer matrices, as a float64 matmul cast
    to int32. Exact wherever every partial sum stays below 2^53: with int8 x
    and codes below 2^8 each term is below 2^15, so any K below 2^38 is
    exact. The CPU runs a float64 matmul fast, where an int64 matmul at 8B
    widths takes minutes."""
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)


def unpack_rows_ref(W_q_packed: torch.Tensor, W_nbits: int, elements_per_sample: int,
                    out_rows: int) -> torch.Tensor:
    """Unpack a w_layout=0 (Kp, N) word matrix to (K, N) uint8 codes."""
    if elements_per_sample == 1:
        return W_q_packed
    return unpack_over_rows(W_q_packed, W_nbits, out_rows)


def _broadcast_group_meta(meta: torch.Tensor, K: int) -> torch.Tensor:
    """(G, N) group metadata -> (K, N) by repeating each group's row."""
    reps = K // meta.shape[0]
    return meta if reps == 1 else torch.repeat_interleave(meta, reps, dim=0)


def dequantize_ref(b: torch.Tensor, scales, zeros, *, W_group_mode: int, meta_dtype,
                   zero_is_scalar: bool = False) -> torch.Tensor:
    """Dequantize unpacked (K, N) codes.

    Every elementwise op runs in ``meta_dtype`` and rounds to it, in the cast
    order of ``gemlite_tpu/ops/reference.py:dequantize_ref``: mode 4 in bf16
    rounds once after the multiply and once after the add."""
    meta_dtype = to_torch_dtype(meta_dtype)
    K = b.shape[0]
    if W_group_mode == 0:
        return b
    s = _broadcast_group_meta(scales, K).to(meta_dtype) if scales is not None else None
    if isinstance(zeros, torch.Tensor) and not zero_is_scalar and zeros.ndim == 2:
        z = _broadcast_group_meta(zeros, K).to(meta_dtype)
    else:
        z = zeros
    if W_group_mode == 1:
        return b.to(meta_dtype) - torch.as_tensor(z).to(meta_dtype)
    if W_group_mode == 2:
        return b.to(meta_dtype) * s
    if W_group_mode == 3:
        if zero_is_scalar:
            zi = torch.as_tensor(z, device=b.device).to(torch.int32)
            return (b.to(torch.int32) - zi).to(meta_dtype) * s
        return (b.to(meta_dtype) - z) * s
    if W_group_mode == 4:
        return b.to(meta_dtype) * s + z
    raise ValueError(f"invalid W_group_mode {W_group_mode}")


def forward_ref(x: torch.Tensor, W_q_packed: torch.Tensor, scales, zeros, scales_x, *,
                W_nbits: int, group_size: int, elements_per_sample: int,
                W_group_mode: int, channel_scale_mode: int, input_dtype: int,
                output_dtype: int, acc_dtype: int, meta_dtype: int,
                zero_is_scalar: bool = False) -> torch.Tensor:
    """out = channel_scale(x @ dequant(unpack(W_q))).

    x (M, K); W_q_packed (K // elements_per_sample, N) w_layout=0 words, or
    (K, N) raw weights when elements_per_sample == 1; scales/zeros (G, N);
    scales_x (M, 1) or None. The dequantized weight is cast to float32 and the
    dot runs in float32 (the JAX oracle's order), or exactly in int32 for int8
    x against integer weights with an INT32 accumulator
    (``gemlite_tpu/ops/reference.py:157-169``); the epilogue runs in
    meta_dtype. Returns (M, N) in output_dtype."""
    out_dtype = to_torch_dtype(output_dtype)
    meta_t = to_torch_dtype(meta_dtype)
    K = x.shape[-1]
    b = unpack_rows_ref(W_q_packed, W_nbits, elements_per_sample, K)
    b = dequantize_ref(b, scales, zeros, W_group_mode=W_group_mode,
                       meta_dtype=meta_dtype if W_group_mode > 0 else DType.FP32,
                       zero_is_scalar=zero_is_scalar)
    if (DType(acc_dtype) == DType.INT32 and not b.is_floating_point()
            and not x.is_floating_point()):
        acc = int_matmul(x.to(torch.int8), b.to(torch.int8))
    else:
        acc = x.to(torch.float32) @ b.to(torch.float32)
    if not meta_t.is_floating_point:
        meta_t = torch.float32
    if channel_scale_mode == 1:
        acc = acc.to(meta_t) * scales.reshape(1, -1).to(meta_t)
    elif channel_scale_mode == 2:
        acc = acc.to(meta_t) * scales_x.reshape(-1, 1).to(meta_t)
    elif channel_scale_mode == 3:
        acc = (acc.to(meta_t) * scales_x.reshape(-1, 1).to(meta_t)
               * scales.reshape(1, -1).to(meta_t))
    elif channel_scale_mode == 4:
        raise NotImplementedError("queued: csm 4 (MX grouped activation scales)")
    return acc.to(out_dtype)


def fp8_values(W_q: torch.Tensor, meta) -> torch.Tensor:
    """The (K, N) float32 values of a layer's fp8 bit codes: the unpacked
    bytes read as ``float8_e4m3fn`` / ``float8_e5m2``, converted exactly."""
    codes = unpack_over_rows(W_q, 8, meta.in_features)
    return codes.view(to_torch_dtype(meta.w_code_dtype)).to(torch.float32)


def forward_fp8_ref(x: torch.Tensor, W_q: torch.Tensor, scales, scales_x, meta) -> torch.Tensor:
    """out = csm(x @ W) for fp8 bit codes, the plain version of every fp8
    kernel (``gemlite_tpu/ops/pallas_decode.py:400-406``): the fp8 weights
    are true values, summed against x (bf16 or fp8, exact in float32) in
    float32; mode 2 multiplies each group's sum by its (1, N) scale row and
    adds the groups in order; then csm 1 (* scales), 2 (* scales_x) or 3
    (* scales_x, then * scales), each multiply in float32. Returns (M, N)
    in the output dtype."""
    K, N = meta.in_features, meta.out_features
    w = fp8_values(W_q, meta)
    xf = x.to(torch.float32)
    if meta.W_group_mode == 2:
        s = scales.reshape(-1, N).to(torch.float32)
        gs = K // s.shape[0]
        acc = None
        for g in range(s.shape[0]):
            part = (xf[:, g * gs:(g + 1) * gs] @ w[g * gs:(g + 1) * gs]) * s[g:g + 1]
            acc = part if acc is None else acc + part
    elif meta.W_group_mode == 0:
        acc = xf @ w
    else:
        raise ValueError(f"fp8 codes are true values: W_group_mode 0 or 2, not {meta.W_group_mode}")
    csm = meta.channel_scale_mode
    if csm in (2, 3):
        acc = acc * scales_x.reshape(-1, 1).to(torch.float32)
    if csm in (1, 3):
        acc = acc * scales.reshape(1, -1).to(torch.float32)
    elif csm == 4:
        raise NotImplementedError("queued: csm 4 (MX grouped activation scales)")
    return acc.to(to_torch_dtype(meta.output_dtype))


def forward_meta(x, W_q, scales, zeros, scales_x, meta) -> torch.Tensor:
    """forward_ref with its static arguments taken from a LayerMeta (for fp8
    bit codes, ``forward_fp8_ref``)."""
    if getattr(meta, "w_code_dtype", 0):
        return forward_fp8_ref(x, W_q, scales, scales_x, meta)
    return forward_ref(
        x, W_q, scales, zeros, scales_x,
        W_nbits=meta.W_nbits, group_size=meta.group_size,
        elements_per_sample=meta.elements_per_sample, W_group_mode=meta.W_group_mode,
        channel_scale_mode=meta.channel_scale_mode, input_dtype=meta.input_dtype,
        output_dtype=meta.output_dtype, acc_dtype=meta.acc_dtype,
        meta_dtype=meta.meta_dtype, zero_is_scalar=bool(meta.zero_is_scalar))
