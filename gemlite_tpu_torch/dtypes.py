# SPDX-License-Identifier: Apache-2.0
"""Dtype identity for the PyTorch port.

``DType`` keeps the exact integer values of ``gemlite_tpu.dtypes.DType``: the
values travel inside the 12-int layer metadata vector, so a layer packed by
either package reads the same in the other.
"""

from enum import Enum

import numpy as np
import torch

__all__ = ["DType", "DTYPE_TO_TORCH", "TORCH_TO_DTYPE", "FP8_DTYPES", "FP8_INT8_DTYPES",
           "to_torch_dtype", "is_mx_dtype", "get_dtype_range", "npz_encode_array",
           "npz_decode_array"]


class DType(Enum):
    """Logical dtype ids (values identical to the JAX package's enum)."""

    FP32 = 0
    FP16 = 1
    BF16 = 2
    FP8 = 3
    FP8e4 = 3  # alias for FP8
    INT8 = 4
    UINT8 = 5
    INT32 = 6
    UINT32 = 7
    FP8e5 = 8
    INT16 = 9
    UINT16 = 10
    INT64 = 11
    FP8e4nuz = 12
    FP8e5nuz = 13
    MXFP16 = 14
    MXBF16 = 15
    MXFP8 = 16
    MXFP4 = 17
    NVFP4 = 18
    E8M0 = 19


# enum value -> torch storage dtype, for the types torch has
DTYPE_TO_TORCH = {
    0: torch.float32,
    1: torch.float16,
    2: torch.bfloat16,
    3: torch.float8_e4m3fn,
    4: torch.int8,
    5: torch.uint8,
    6: torch.int32,
    8: torch.float8_e5m2,
    9: torch.int16,
    11: torch.int64,
    12: torch.float8_e4m3fnuz,
    13: torch.float8_e5m2fnuz,
}

TORCH_TO_DTYPE = {
    torch.float32: DType.FP32,
    torch.float16: DType.FP16,
    torch.bfloat16: DType.BF16,
    torch.int8: DType.INT8,
    torch.uint8: DType.UINT8,
    torch.int32: DType.INT32,
    torch.int16: DType.INT16,
    torch.float8_e4m3fn: DType.FP8,
    torch.float8_e5m2: DType.FP8e5,
    torch.float8_e4m3fnuz: DType.FP8e4nuz,
    torch.float8_e5m2fnuz: DType.FP8e5nuz,
}

MX_DTYPES = (DType.MXFP16, DType.MXBF16, DType.MXFP8, DType.MXFP4, DType.NVFP4)
# the fp8 activation dtypes a layer takes (``gemlite_tpu/dtypes.py:113``
# less the ``*nuz`` flavours, which the JAX kernels refuse too)
FP8_DTYPES = (DType.FP8, DType.FP8e5)
FP8_INT8_DTYPES = (DType.INT8,) + FP8_DTYPES


def to_torch_dtype(dtype) -> torch.dtype:
    """DType | int | torch.dtype -> torch.dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    value = dtype.value if isinstance(dtype, DType) else int(dtype)
    if value not in DTYPE_TO_TORCH:
        raise NotImplementedError(f"no torch storage dtype for {DType(value)}")
    return DTYPE_TO_TORCH[value]


def is_mx_dtype(dtype) -> bool:
    value = dtype.value if isinstance(dtype, DType) else int(dtype)
    return value in {d.value for d in MX_DTYPES}


def get_dtype_range(dtype):
    """(min, max) of a torch dtype (or DType) as Python floats: for int8,
    (-128.0, 127.0), for e4m3fn (-448.0, 448.0), the range dynamic
    activation quantization clips to."""
    d = to_torch_dtype(dtype)
    info = torch.finfo(d) if d.is_floating_point else torch.iinfo(d)
    return float(info.min), float(info.max)


# ---------------------------------------------------------------------------
# npz-safe serialization (``gemlite_tpu/dtypes.py:130-172``): numpy has no
# bfloat16 or fp8, so such a tensor is stored as its bit view with a marker
# naming the dtype, and restored by the same view on load. The markers are the
# JAX package's (ml_dtypes' names), so files cross between the packages.
# ---------------------------------------------------------------------------

# marker -> (torch dtype, signed torch view, numpy bit dtype the file holds)
_NPZ_BIT_VIEWS = {
    "bfloat16": (torch.bfloat16, torch.int16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, torch.uint8, np.uint8),
    "float8_e4m3fnuz": (torch.float8_e4m3fnuz, torch.uint8, np.uint8),
    "float8_e5m2fnuz": (torch.float8_e5m2fnuz, torch.uint8, np.uint8),
    "float8_e8m0fnu": (torch.float8_e8m0fnu, torch.uint8, np.uint8),
}
_NPZ_MARKER_OF = {dt: name for name, (dt, _, _) in _NPZ_BIT_VIEWS.items()}


def npz_encode_array(x):
    """A tensor (any device) or numpy array of a native dtype -> (numpy array
    that np.savez stores as is, the dtype marker or None)."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x), None
    x = x.detach().cpu()
    marker = _NPZ_MARKER_OF.get(x.dtype)
    if marker is None:
        return x.numpy(), None
    _, view, bits = _NPZ_BIT_VIEWS[marker]
    return x.contiguous().view(view).numpy().view(bits), marker


def npz_decode_array(arr, marker=None) -> torch.Tensor:
    """Inverse of ``npz_encode_array``: a CPU tensor on the array's memory
    (on a copy when the array is read-only)."""
    shape = np.shape(arr)                  # np.ascontiguousarray makes a 0-d array 1-d
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    if marker:
        entry = _NPZ_BIT_VIEWS.get(marker)
        if entry is None:
            raise ValueError(f"unknown checkpoint dtype marker {marker!r}")
        dtype, view, _ = entry
        bits = arr.view(np.int16 if view == torch.int16 else np.uint8)
        return torch.from_numpy(bits).view(dtype).reshape(shape)
    return torch.from_numpy(arr).reshape(shape)
