# SPDX-License-Identifier: Apache-2.0
"""What the mode-4 kernels take, checked in one place.

The decode (per-layer and stacked), prefill and dequantize kernels read the
same layer format: bf16 activations and output, codes in w_layout=0 int32
words of shape (K / epw, N) with epw = 32 / W_nbits, W_group_mode 4 with bf16
(K / gs, N) scales and pre-folded zeros, no channel scale. The decode and
prefill kernels read W1, W2 and W4 codes; dequantize reads W4. A layer
outside that format is served by no kernel of these.
"""

import torch

from ..dtypes import DType

BF16 = DType.BF16.value


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
