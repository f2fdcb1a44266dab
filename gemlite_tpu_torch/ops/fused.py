# SPDX-License-Identifier: Apache-2.0
"""General fused kernel: dequantize a weight tile, then a tensor-core GEMM
(``csrc/fused_gemm.cu``).

Replaces ``gemlite_tpu/ops/pallas_gemm.py:pallas_fused_matmul`` for every
integer-code form its gate admits: x in fp16 / bf16 / fp32 / int8; W1/2/4/8
codes in LSB-first int32 words, or non-packed int8 / fp16 / bf16 weights;
W_group_mode 0-4 with scalar or grouped zeros; channel_scale_mode 0-3.

    int path   int8 x, W_group_mode 0, or 1 with a scalar zero, codes that
               fit int8 (not packed W8): int8 x int8 -> int32, exact, in one
               launch whose tiles and K split ``int_plan`` chooses
    else       the weight dequantized in the compute dtype (bf16 for int8 x;
               float32 for float32 x), rounded after every op as the JAX
               kernel's ``meta_f32=False`` arithmetic does, float32 sums

The epilogue scales the accumulator in float32 (csm 1/2/3). The MX codecs
(fp4 codes, e8m0 / nvfp4 scales) and csm 4 wait for the MX slice.

The plain version, ``fused_matmul_plain``, repeats that arithmetic. On a CPU
tensor the wrapper runs it; on a CUDA tensor it launches the kernel or raises.
"""

import ctypes
from typing import NamedTuple

import torch

from ..dtypes import DType, is_mx_dtype, to_torch_dtype
from . import build
from .reference import int_matmul, unpack_rows_ref

__all__ = ["IntPlan", "can_use_fused", "fused_gemm", "fused_matmul_plain", "int_path", "int_plan"]

BK = 32                   # the kernel's K step
_FLOAT_INPUTS = (DType.FP16.value, DType.BF16.value, DType.FP32.value)
_META_DTYPES = {torch.float32: DType.FP32.value, torch.float16: DType.FP16.value,
                torch.bfloat16: DType.BF16.value}
_W_DTYPES = {torch.int32: DType.INT32.value, torch.int8: DType.INT8.value,
             torch.float16: DType.FP16.value, torch.bfloat16: DType.BF16.value}


def can_use_fused(meta) -> bool:
    """The layers the kernel serves (``pallas_gemm.py:can_use_pallas`` for
    integer codes, without the TPU's block rules)."""
    if is_mx_dtype(meta.input_dtype) or meta.channel_scale_mode not in (0, 1, 2, 3):
        return False
    if meta.input_dtype not in _FLOAT_INPUTS + (DType.INT8.value,):
        return False
    e = meta.elements_per_sample
    packed = meta.W_nbits in (1, 2, 4, 8) and e == 32 // meta.W_nbits
    if not (packed or (e == 1 and meta.W_nbits in (8, 16))):
        return False
    return meta.W_group_mode in (0, 1, 2, 3, 4) and meta.in_features % BK == 0


def int_path(meta) -> bool:
    """int8 x int8 -> int32 (``pallas_gemm.py:324-333``): raw or scalar-shifted
    codes that fit int8; packed W8 codes span 0..255 and do not."""
    return (meta.input_dtype == DType.INT8.value
            and meta.W_group_mode in (0, 1)
            and (meta.W_group_mode == 0 or bool(meta.zero_is_scalar))
            and meta.acc_dtype == DType.INT32.value
            and (meta.elements_per_sample == 1 or meta.W_nbits < 8))


def compute_dtype(meta) -> torch.dtype:
    """The dtype of the dot off the int path: the input's float dtype, bf16
    for int8 x."""
    if meta.input_dtype in _FLOAT_INPUTS:
        return to_torch_dtype(meta.input_dtype)
    return torch.bfloat16


def _group_rows(t, K):
    """(G, N) metadata -> (K, N), each group's row repeated."""
    return torch.repeat_interleave(t, K // t.shape[0], dim=0) if t.shape[0] != K else t


def _dequant(b, scales, zeros, meta, md):
    """Codes (K, N) -> weights in ``md``, one rounding per op
    (``pallas_gemm.py:159-185``)."""
    mode, K = meta.W_group_mode, meta.in_features
    if mode == 0:
        return b.to(md)
    scalar = bool(meta.zero_is_scalar)
    s = _group_rows(scales.reshape(-1, meta.out_features), K).to(md) if mode in (2, 3, 4) else None
    if zeros is not None and not scalar:
        z = _group_rows(zeros.reshape(-1, meta.out_features), K).to(md)
    else:
        z = zeros
    if mode == 1:
        return b.to(md) - (z.to(md) if scalar else z)
    if mode == 2:
        return b.to(md) * s
    if mode == 3:
        if scalar:
            return (b.to(torch.int32) - z.to(torch.int32)).to(md) * s
        return (b.to(md) - z) * s
    return b.to(md) * s + z


def _epilogue(acc, scales, scales_x, meta):
    csm = meta.channel_scale_mode
    if csm == 1:
        acc = acc * scales.reshape(1, -1).to(torch.float32)
    elif csm == 2:
        acc = acc * scales_x.reshape(-1, 1).to(torch.float32)
    elif csm == 3:
        acc = acc * scales_x.reshape(-1, 1).to(torch.float32) * scales.reshape(1, -1).to(torch.float32)
    return acc.to(to_torch_dtype(meta.output_dtype))


def fused_matmul_plain(x, W_q, scales, zeros, scales_x, meta) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch."""
    K = meta.in_features
    b = unpack_rows_ref(W_q, meta.W_nbits, meta.elements_per_sample, K)
    if int_path(meta):
        w = b.to(torch.int32)
        if meta.W_group_mode == 1:
            w = w - zeros.to(torch.int32)
        acc = int_matmul(x.to(torch.int8), w.to(torch.int8)).to(torch.float32)
    else:
        cd = compute_dtype(meta)
        w = _dequant(b, scales, zeros, meta, cd).to(cd)
        acc = x.to(cd).to(torch.float32) @ w.to(torch.float32)
    return _epilogue(acc, scales, scales_x, meta)


INT_TILE = 128            # the int path's output tile, 128 x 128
INT_BK = 128              # its K step
SMS = 132                 # H100 SXM streaming multiprocessors
FILL = 3 * SMS // 4       # below this many tiles the int path splits K


class IntPlan(NamedTuple):
    """The int path's grid for one call: ``tiles_m`` x ``tiles_n`` output
    tiles of 128 x 128, each summed over ``splits`` K ranges of
    ``k_per_split`` (the last may be shorter), all in ``launches`` kernel
    launches. A split call adds its partial sums into ``acc_bytes`` of int32
    accumulator, which the call leaves zero for the next."""
    tiles_m: int
    tiles_n: int
    splits: int
    k_per_split: int
    launches: int
    acc_bytes: int


def int_plan(M: int, N: int, K: int) -> IntPlan:
    """Tiles and split of the int path, from M, N and K alone. With at least
    ``FILL`` tiles each block streams its whole K range; with fewer, K is
    cut in whole K steps so that about one block runs per SM: every split
    adds its sums into the tile's accumulator, and the last to finish applies
    the epilogue, in the same launch.
    Integer sums are exact in any order, so the output bits never depend on
    the plan."""
    tm, tn = -(-M // INT_TILE), -(-N // INT_TILE)
    tiles, units = tm * tn, -(-K // INT_BK)
    splits = 1 if tiles >= FILL else max(1, min(units, SMS // tiles))
    per = -(-units // splits)
    splits = -(-units // per)
    if splits == 1:
        return IntPlan(tm, tn, 1, K, 1, 0)
    return IntPlan(tm, tn, splits, per * INT_BK, 1, 4 * tiles * INT_TILE * INT_TILE)


def _split_state(device: torch.device, tiles: int):
    """(accumulator, counters) pointers of the split int path: int32 tiles of
    128 x 128 and one arrival counter per output tile, in the zeroed int32
    scratch of ``build.split_state``; every call leaves both 0, so a call
    writes no scratch of its own."""
    n = max(tiles, FILL)
    ints, _ = build.split_state("fused_gemm", device, n * (INT_TILE * INT_TILE + 1), 0)
    return ints.data_ptr(), ints.data_ptr() + 4 * n * INT_TILE * INT_TILE


def _lib():
    fn = build.load("fused_gemm").gl_fused_gemm
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 17 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _meta_arg(t, name):
    """A metadata tensor the kernel reads: float32, fp16 or bf16, contiguous."""
    if t is None:
        return None
    if t.dtype not in _META_DTYPES:
        t = t.to(torch.float32)
    if not t.is_cuda:
        raise ValueError(f"{name}: want a CUDA tensor, got one on {t.device}")
    return t.contiguous()


def fused_gemm(x: torch.Tensor, W_q, scales, zeros, scales_x, meta) -> torch.Tensor:
    """out (M, N) = csm(x (M, K) @ dequant(W_q)) for any M."""
    if x.device.type == "cpu":
        return fused_matmul_plain(x, W_q, scales, zeros, scales_x, meta)
    if not can_use_fused(meta):
        raise NotImplementedError(f"general fused kernel does not take {meta}: the MX codecs "
                                  "and csm 4 wait for the MX slice")
    M = x.shape[0]
    N, K = meta.out_features, meta.in_features
    x_dtype = to_torch_dtype(meta.input_dtype)
    if x.dtype != x_dtype or tuple(x.shape) != (M, K):
        raise ValueError(f"x: want a CUDA (M, {K}) {x_dtype} tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    e = meta.elements_per_sample
    if not (W_q.is_cuda and W_q.dtype in _W_DTYPES and tuple(W_q.shape) == (K // e, N)
            and W_q.is_contiguous() and (e == 1) == (W_q.dtype != torch.int32)):
        raise ValueError(f"W_q: want a contiguous CUDA ({K // e}, {N}) tensor, got "
                         f"{W_q.dtype} {tuple(W_q.shape)}")
    mode, csm = meta.W_group_mode, meta.channel_scale_mode
    scalar = bool(meta.zero_is_scalar)
    s = _meta_arg(scales, "scales") if (mode in (2, 3, 4) or csm in (1, 3)) else None
    z = _meta_arg(zeros, "zeros") if (mode in (1, 3, 4) and not scalar) else None
    zs = zeros.to(torch.int32).reshape(()) if (mode in (1, 3) and scalar) else None
    sx = scales_x.to(torch.float32).contiguous() if csm in (2, 3) else None
    if (mode in (2, 3, 4) or csm in (1, 3)) and s is None or \
            (mode in (1, 3, 4) and z is None and zs is None) or (csm in (2, 3) and sx is None):
        raise ValueError(f"missing metadata for {meta}")
    gs_s = K // (s.numel() // N) if (s is not None and mode in (2, 3, 4)) else K
    gs_z = K // (z.numel() // N) if z is not None else K
    out = torch.empty((M, N), dtype=to_torch_dtype(meta.output_dtype), device=x.device)
    ip = int_path(meta)
    plan = int_plan(M, N, K) if ip else IntPlan(0, 0, 1, K, 1, 0)
    ws = cnt = None
    if plan.splits > 1:
        ws, cnt = _split_state(x.device, plan.tiles_m * plan.tiles_n)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _lib()(ptr(x), ptr(W_q), ptr(s), ptr(z), ptr(zs), ptr(sx), ptr(out), ws, cnt,
                 M, N, K, meta.input_dtype, int(ip), meta.W_nbits, e,
                 _W_DTYPES[W_q.dtype], mode, csm, gs_s, gs_z,
                 _META_DTYPES[s.dtype] if s is not None else 0,
                 _META_DTYPES[z.dtype] if z is not None else 0, meta.output_dtype,
                 plan.splits, plan.k_per_split, torch.cuda.current_stream().cuda_stream)
    build.check(err, "fused_gemm")
    fused_gemm.launches += 1
    return out


fused_gemm.launches = 0
