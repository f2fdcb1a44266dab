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

MX layers (``gemlite_tpu/mx.py:113-216``): each fp4 / fp8 code's value times
its group's scale in float32, the dot in float32 (``mx_forward_ref``); with
micro-scaled activations (csm 4) x is first rounded to its MX grid in bf16
(``fake_quant_activations``), as the JAX oracle does.
"""

import torch

from ..bitpack import unpack_over_rows
from ..dtypes import DType, is_mx_dtype, to_torch_dtype
from ..quant import (NVFP4_META_SCALE, _f32, _pow2_ceil, e8m0_bits_to_f32, fp4_dequant,
                     mx_group_size, round_to_fp4)

__all__ = ["unpack_rows_ref", "dequantize_ref", "int_matmul", "forward_ref", "forward_meta",
           "forward_f32_epilogue",
           "fp8_values", "forward_fp8_ref", "fake_quant_activations", "mx_scales_f32",
           "mx_codes", "mx_dequantize_weight_ref", "mx_forward_ref"]


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
        raise ValueError("csm 4 (micro-scaled activations) is for MX layers: mx_forward_ref")
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
        raise ValueError("csm 4 (micro-scaled activations) is for MX layers: mx_forward_ref")
    return acc.to(to_torch_dtype(meta.output_dtype))


def forward_meta(x, W_q, scales, zeros, scales_x, meta) -> torch.Tensor:
    """forward_ref with its static arguments taken from a LayerMeta (for fp8
    bit codes, ``forward_fp8_ref``; for MX layers ``mx_forward_ref``, after
    rounding x to its MX grid where the activations are micro-scaled, as the
    JAX package's ``ops/dispatch.py:_ref_kernel`` does)."""
    if is_mx_dtype(meta.input_dtype):
        if meta.channel_scale_mode == 4:
            x = fake_quant_activations(x, meta.input_dtype, meta.output_dtype)
            meta = meta._replace(channel_scale_mode=0)
        return mx_forward_ref(x, W_q, scales, zeros, scales_x, meta)
    if getattr(meta, "w_code_dtype", 0):
        return forward_fp8_ref(x, W_q, scales, scales_x, meta)
    return forward_ref(
        x, W_q, scales, zeros, scales_x,
        W_nbits=meta.W_nbits, group_size=meta.group_size,
        elements_per_sample=meta.elements_per_sample, W_group_mode=meta.W_group_mode,
        channel_scale_mode=meta.channel_scale_mode, input_dtype=meta.input_dtype,
        output_dtype=meta.output_dtype, acc_dtype=meta.acc_dtype,
        meta_dtype=meta.meta_dtype, zero_is_scalar=bool(meta.zero_is_scalar))


def forward_f32_epilogue(x, W_q, scales, zeros, scales_x, meta) -> torch.Tensor:
    """forward_meta of an integer-code layer with its channel scales applied
    in float32: forward_ref's dequantization and float32 dot, then csm 2 / 3
    times the per-token scales and csm 1 / 3 times the channel scales
    (``scales``), each a float32 multiply, and one rounding to the output
    dtype. This is how the JAX decode and prefill kernels finish
    (``gemlite_tpu/ops/pallas_decode.py:436-445``) and the plain version of
    the port's mode 1-3 decode and prefill forms; forward_meta rounds the
    sums and scales to the meta dtype before it multiplies."""
    acc = forward_ref(
        x, W_q, scales, zeros, None,
        W_nbits=meta.W_nbits, group_size=meta.group_size,
        elements_per_sample=meta.elements_per_sample, W_group_mode=meta.W_group_mode,
        channel_scale_mode=0, input_dtype=meta.input_dtype, output_dtype=DType.FP32.value,
        acc_dtype=meta.acc_dtype, meta_dtype=meta.meta_dtype,
        zero_is_scalar=bool(meta.zero_is_scalar))
    csm = meta.channel_scale_mode
    if csm in (2, 3):
        acc = acc * scales_x.reshape(-1, 1).to(torch.float32)
    if csm in (1, 3):
        acc = acc * scales.reshape(1, -1).to(torch.float32)
    return acc.to(to_torch_dtype(meta.output_dtype))


def fake_quant_activations(x: torch.Tensor, input_dtype,
                           compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x rounded to the micro-scaled grid of ``input_dtype`` (MXFP8, MXFP4 or
    NVFP4) and returned dequantized in ``compute_dtype``; the values times
    their scales are exact in float32, then rounded once."""
    d = DType(input_dtype)
    g = x.reshape(-1, x.shape[-1]).to(torch.float32).reshape(-1, mx_group_size(d))
    amax = g.abs().amax(dim=1, keepdim=True)
    if d == DType.MXFP8:
        scales, _ = _pow2_ceil(amax / _f32(448.0, amax))
        out = torch.clamp(g / scales, -448.0, 448.0).to(torch.float8_e4m3fn).to(
            torch.float32) * scales
    elif d == DType.MXFP4:
        scales, _ = _pow2_ceil(amax / _f32(6.0, amax))
        out = round_to_fp4(g / scales)[0] * scales
    elif d == DType.NVFP4:
        ideal = amax / _f32(6.0, amax) / _f32(NVFP4_META_SCALE, amax)
        s8 = torch.clamp(ideal, 0, 448.0).to(torch.float8_e4m3fn)
        full = torch.clamp_min(s8.to(torch.float32) * NVFP4_META_SCALE, 1e-6)
        out = round_to_fp4(g / full)[0] * full
    else:
        raise ValueError(f"not an MX activation dtype: {d}")
    return out.reshape(x.shape).to(to_torch_dtype(compute_dtype))


def mx_scales_f32(scales: torch.Tensor, meta) -> torch.Tensor:
    """(G, N) group scales as float32: e8m0 bits decoded, or NVFP4's e4m3
    times 0.05 (a float32 multiply)."""
    if DType(meta.input_dtype) == DType.NVFP4:
        return scales.to(torch.float32) * NVFP4_META_SCALE
    return e8m0_bits_to_f32(scales)


def mx_codes(W_q: torch.Tensor, meta) -> torch.Tensor:
    """(K, N) float32 values of a w_layout-0 layer's codes: fp4 codebook
    values, or fp8 bit codes read as e4m3 / e5m2."""
    K = meta.in_features
    if meta.W_nbits == 4:
        return fp4_dequant(unpack_over_rows(W_q, 4, K))
    codes = unpack_over_rows(W_q, 8, K)
    fp8 = torch.float8_e5m2 if meta.w_code_dtype == DType.FP8e5.value else torch.float8_e4m3fn
    return codes.view(fp8).to(torch.float32)


def mx_dequantize_weight_ref(W_q: torch.Tensor, scales: torch.Tensor, meta) -> torch.Tensor:
    """Packed MX weights -> the full (K, N) float32 matrix: each code's value
    times its group's scale in float32."""
    K = meta.in_features
    s = mx_scales_f32(scales, meta)
    return mx_codes(W_q, meta) * torch.repeat_interleave(s, K // s.shape[0], dim=0)


def mx_forward_ref(x: torch.Tensor, W_q, scales, zeros, scales_x, meta) -> torch.Tensor:
    """The plain MX forward: x (already in the compute dtype, fake-quantized
    when micro-scaled) in float32 against the float32 weights, times the
    per-token scales (csm 2), in the output dtype."""
    acc = x.to(torch.float32) @ mx_dequantize_weight_ref(W_q, scales, meta)
    if meta.channel_scale_mode == 2 and scales_x is not None:
        acc = acc * scales_x.reshape(-1, 1).to(torch.float32)
    return acc.to(to_torch_dtype(meta.output_dtype))
