# SPDX-License-Identifier: Apache-2.0
"""What the three W4 kernels take, checked in one place.

The decode, prefill and dequantize kernels read the same layer format: bf16
activations and output, W_nbits 4 codes in w_layout=0 int32 words of shape
(K / 8, N), W_group_mode 4 with bf16 (K / gs, N) scales and pre-folded zeros,
no channel scale. A layer outside that format is served by no kernel yet.
"""

import torch

from ..dtypes import DType

BF16 = DType.BF16.value


def serves(meta, min_group: int = 8) -> bool:
    """True when the layer is in the format the W4 kernels read."""
    K = meta.in_features
    return (meta.W_nbits == 4 and meta.elements_per_sample == 8
            and meta.W_group_mode == 4 and meta.channel_scale_mode == 0
            and not meta.zero_is_scalar and not meta.scaled_activations
            and meta.input_dtype == BF16 and meta.output_dtype == BF16
            and meta.meta_dtype == BF16
            and meta.group_size % min_group == 0 and K % meta.group_size == 0)


def check_operands(W_q, scales, zeros, meta) -> None:
    """Raise unless the weight tensors are what the kernels dereference."""
    K, N, gs = meta.in_features, meta.out_features, meta.group_size
    want = {"W_q": (W_q, torch.int32, (K // 8, N)),
            "scales": (scales, torch.bfloat16, (K // gs, N)),
            "zeros": (zeros, torch.bfloat16, (K // gs, N))}
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
