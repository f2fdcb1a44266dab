# SPDX-License-Identifier: Apache-2.0
"""What the W1/W2/W4 kernels take, checked in one place.

The decode (per-layer and stacked), prefill and dequantize kernels read the
same layer format: bf16 activations and output, codes in w_layout=0 int32
words of shape (K / epw, N) with epw = 32 / W_nbits, W_group_mode 4 with bf16
(K / gs, N) scales and pre-folded zeros, no channel scale. The decode and
prefill kernels read W1, W2 and W4 codes; dequantize reads W4.

The per-layer decode and prefill kernels also have a mode 1-3 form
(``serves_modes``), for the layers the JAX router sends to its decode and
prefill kernels in those modes: W_group_mode 1, 2 or 3 with bf16 group
scales (or none) and bf16 grouped or int32 scalar zeros (or none), channel
scale mode 0-3, bf16 or fp8 x (fp8 x goes in as its bf16 image, which is
exact). A layer outside both formats is served by no kernel of these.
"""

import torch

from ..dtypes import DType

BF16 = DType.BF16.value
FP32 = DType.FP32.value
FP8_X = (DType.FP8.value, DType.FP8e5.value)
# the dtype codes of the epilogue's scales (gl_common.cuh: kF32, kBF16)
SCALE_CODES = {torch.float32: 0, torch.bfloat16: 2}


def serves(meta, min_group: int = 8, bits=(4,)) -> bool:
    """True when the layer is in the format the kernels read, with W_nbits in
    ``bits`` and a group size that is a multiple of ``min_group`` and of the
    codes per word."""
    K = meta.in_features
    if meta.W_nbits not in bits:
        return False
    epw = 32 // meta.W_nbits
    return (meta.elements_per_sample == epw
            and meta.W_group_mode == 4 and meta.channel_scale_mode == 0
            and not meta.zero_is_scalar and not meta.scaled_activations
            and meta.input_dtype == BF16 and meta.output_dtype == BF16
            and meta.meta_dtype == BF16
            and meta.group_size % max(min_group, epw) == 0 and K % meta.group_size == 0)


def serves_modes(meta, min_group: int = 8, bits=(4,)) -> bool:
    """True for a layer in the kernels' mode 1-3 form: W_nbits in ``bits``
    in int32 words, W_group_mode 1, 2 or 3, csm 0-3 (csm 1 / 3 read the
    layer's scales as its channel scale, so they come with mode 1; csm 2 / 3
    with fp8 x and its per-token scales), bf16 or fp8 x, bf16 out, and a
    group size that is a multiple of ``min_group`` and of the codes per word
    (gs = K: one group). The weights are dequantized in bf16, which is the
    plain version's arithmetic where the scales and grouped zeros are bf16
    (meta dtype bf16) and where the only shift is a scalar zero (exact)."""
    K, mode, csm = meta.in_features, meta.W_group_mode, meta.channel_scale_mode
    if meta.W_nbits not in bits or mode not in (1, 2, 3) or csm not in (0, 1, 2, 3):
        return False
    epw = 32 // meta.W_nbits
    if meta.elements_per_sample != epw or getattr(meta, "w_code_dtype", 0):
        return False
    fp8 = meta.input_dtype in FP8_X
    if not (meta.input_dtype == BF16 or fp8) or meta.output_dtype != BF16:
        return False
    if (csm in (1, 3) and mode != 1) or (csm in (2, 3) and not (fp8 and meta.scaled_activations)):
        return False
    scalar_shift_only = mode == 1 and meta.zero_is_scalar
    if meta.meta_dtype != BF16 and not (scalar_shift_only and meta.meta_dtype == FP32):
        return False
    gs = meta.group_size
    return gs % max(min_group, epw) == 0 and K % gs == 0


def _meta_rows(t, name, rows, N):
    """A (rows, N) bf16 metadata tensor as the kernels read it: contiguous,
    converted to bf16 where it is stored wider (the plain version rounds it
    to the bf16 meta dtype before its first use)."""
    if not (t.is_cuda and t.numel() == rows * N):
        raise ValueError(f"{name}: want a CUDA tensor of {rows} x {N} values, got "
                         f"{tuple(t.shape)} on {t.device}")
    return t.to(torch.bfloat16).reshape(rows, N).contiguous()


def _scale_vector(t, name, n):
    """n float32 or bf16 scales, contiguous (other dtypes as float32)."""
    if not (t.is_cuda and t.numel() == n):
        raise ValueError(f"{name}: want a CUDA tensor of {n} values, got "
                         f"{tuple(t.shape)} on {t.device}")
    if t.dtype not in SCALE_CODES:
        t = t.to(torch.float32)
    return t.reshape(n).contiguous()


def modes_operands(W_q, scales, zeros, scales_x, meta, M: int, layers=None):
    """The operands of a mode 1-3 call, checked: (group scales, zeros,
    scalar zero, float32 per-token scales, float32 or bf16 channel scales),
    each None where the form reads none. Raises unless W_q is what the
    kernels dereference. ``layers``: the stacked entry's L, whose operands
    carry a leading layer axis (the metadata (L, K / gs, N), the channel
    scales (L, 1, N)), returned flattened over it."""
    K, N, gs = meta.in_features, meta.out_features, meta.group_size
    mode, csm = meta.W_group_mode, meta.channel_scale_mode
    L = layers or 1
    shape = (() if layers is None else (layers,)) + (K // meta.elements_per_sample, N)
    if not (W_q.is_cuda and W_q.dtype == torch.int32 and tuple(W_q.shape) == shape
            and W_q.is_contiguous()):
        raise ValueError(f"W_q: want a contiguous CUDA int32 tensor of shape {shape}, "
                         f"got {W_q.dtype} {tuple(W_q.shape)} on {W_q.device}")
    s = _meta_rows(scales, "scales", L * (K // gs), N) if mode in (2, 3) else None
    z = zs = None
    if mode in (1, 3):
        if meta.zero_is_scalar:
            zs = torch.as_tensor(zeros, device=W_q.device).to(torch.int32).reshape(())
        else:
            z = _meta_rows(zeros, "zeros", L * (K // gs), N)
    sx = _scale_vector(scales_x, "scales_x", M).to(torch.float32) if csm in (2, 3) else None
    cs = _scale_vector(scales, "scales", L * N) if csm in (1, 3) else None
    return s, z, zs, sx, cs


def check_operands(W_q, scales, zeros, meta, layers=None) -> None:
    """Raise unless the weight tensors are what the kernels dereference:
    (K / epw, N) words and (K / gs, N) metadata, each with a leading
    ``layers`` axis when given."""
    K, N, gs = meta.in_features, meta.out_features, meta.group_size
    lead = () if layers is None else (layers,)
    want = {"W_q": (W_q, torch.int32, lead + (K // meta.elements_per_sample, N)),
            "scales": (scales, torch.bfloat16, lead + (K // gs, N)),
            "zeros": (zeros, torch.bfloat16, lead + (K // gs, N))}
    for name, (t, dtype, shape) in want.items():
        if not (t.is_cuda and t.dtype == dtype and tuple(t.shape) == shape
                and t.is_contiguous()):
            raise ValueError(f"{name}: want a contiguous CUDA {dtype} tensor of shape {shape}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def activations(x: torch.Tensor, K: int) -> torch.Tensor:
    """x as a contiguous (M, K) bf16 CUDA tensor whose rows are 16-byte aligned."""
    if not x.is_cuda or x.ndim != 2 or x.shape[1] != K or x.dtype != torch.bfloat16:
        raise ValueError(f"x: want a CUDA (M, {K}) bf16 tensor, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    return x


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def pointer(t):
    return None if t is None else t.data_ptr()


def scale_code(t) -> int:
    """The dtype code (gl_common.cuh) of a float32 or bf16 scale vector."""
    return 0 if t is None else SCALE_CODES[t.dtype]
