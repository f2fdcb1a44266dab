# SPDX-License-Identifier: Apache-2.0
"""General fused kernel: dequantize a weight tile, then a tensor-core GEMM
(``csrc/fused_gemm.cu`` and ``csrc/fused_float.cu``).

Replaces ``gemlite_tpu/ops/pallas_gemm.py:pallas_fused_matmul`` for every
integer-code form its gate admits: x in fp16 / bf16 / fp32 / int8; W1/2/4/8
codes in LSB-first int32 words, or non-packed int8 / fp16 / bf16 weights;
W_group_mode 0-4 with scalar or grouped zeros; channel_scale_mode 0-3.

    int path    int8 x, W_group_mode 0, or 1 with a scalar zero, codes that
                fit int8 (not packed W8): int8 x int8 -> int32, exact, in one
                launch whose tiles and K split ``int_plan`` chooses
                (``fused_gemm.cu``)
    float path  bf16 / fp16 x, or int8 x off the int path, or fp8 x
                (e4m3 / e5m2) over W4 / W2 codes (both computed in bf16):
                the weights dequantized in the compute dtype, rounded
                after every op as the JAX kernel's ``meta_f32=False``
                arithmetic does, products on the tensor cores with float32
                sums, in one launch whose token tile and K split
                ``float_plan`` chooses (``fused_float.cu``, wrapper
                ``fused_gemm_float``)
    float32 x   dequantized and summed in float32 (``fused_gemm.cu``)

The epilogue scales the accumulator in float32 (csm 1/2/3). The MX codecs
(fp4 codes, e8m0 / nvfp4 scales) and csm 4 wait for the MX slice.

The plain version, ``fused_matmul_plain``, repeats that arithmetic. On a CPU
tensor the wrappers run it; on a CUDA tensor they launch a kernel or raise.
"""

import ctypes
from typing import NamedTuple

import torch

from ..dtypes import DType, is_mx_dtype, to_torch_dtype
from . import build
from .reference import int_matmul, unpack_rows_ref

__all__ = ["FloatPlan", "IntPlan", "can_use_fused", "float_plan", "fused_gemm", "fused_gemm_float",
           "fused_matmul_plain", "int_path", "int_plan"]

BK = 32                   # K must be whole steps of this
_FLOAT_INPUTS = (DType.FP16.value, DType.BF16.value, DType.FP32.value)
_FP8_INPUTS = (DType.FP8.value, DType.FP8e5.value)
_BYTE_INPUTS = (DType.INT8.value,) + _FP8_INPUTS      # computed in bf16
_META_DTYPES = {torch.float32: DType.FP32.value, torch.float16: DType.FP16.value,
                torch.bfloat16: DType.BF16.value}
_W_DTYPES = {torch.int32: DType.INT32.value, torch.int8: DType.INT8.value,
             torch.float16: DType.FP16.value, torch.bfloat16: DType.BF16.value}


def can_use_fused(meta) -> bool:
    """The layers the kernel serves (``pallas_gemm.py:can_use_pallas`` for
    integer codes, without the TPU's block rules)."""
    if is_mx_dtype(meta.input_dtype) or meta.channel_scale_mode not in (0, 1, 2, 3):
        return False
    if meta.input_dtype not in _FLOAT_INPUTS + _BYTE_INPUTS:
        return False
    if getattr(meta, "w_code_dtype", 0):
        return False                       # fp8 bit codes: the fp8 kernels (ops/fp8.py)
    if meta.input_dtype in _FP8_INPUTS and meta.elements_per_sample not in (8, 16):
        return False                       # fp8 x: W4 / W2 codes (A8W4 / A8W2) only
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
    for int8 and fp8 x."""
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


FLOAT_TILE_N = 128        # the float path's output columns a block
FLOAT_BK = 128            # its K step (a ring stage)
MIN_SPLIT_STAGES = 4      # the fewest stages a split of the float path takes


class FloatPlan(NamedTuple):
    """The float path's grid for one call: ``tiles_m`` x ``tiles_n`` output
    tiles of ``8 nt`` rows x 128 columns, each summed over ``splits`` K ranges
    of ``k_per_split`` (the last may be shorter), in one launch. A split call
    writes ``splits`` float32 partials of the output, which the last block of
    each tile adds in split order."""
    nt: int
    tiles_m: int
    tiles_n: int
    splits: int
    k_per_split: int

    @property
    def bm(self) -> int:
        return 8 * self.nt

    @property
    def blocks(self) -> int:
        return self.tiles_m * self.tiles_n * self.splits

    @property
    def launches(self) -> int:
        return 1


def float_plan(M: int, N: int, K: int) -> FloatPlan:
    """Token tile and split of the float path, from M, N and K alone. Up to
    M 8 a block holds one token tile of 8 rows, else 16 tiles (128 rows). With
    at least one tile an SM each block streams its whole K range; with fewer,
    K is cut in whole 128-deep stages, no split shorter than
    ``MIN_SPLIT_STAGES`` stages, so that about four light blocks (two of 128
    rows) run per SM, and no more splits than K / (8 M): the float32
    partials they write and read (8 M N bytes a split) stay below an int8
    weight's K N bytes. The output bits depend only on the plan."""
    nt = 1 if M <= 8 else 16
    tm, tn = -(-M // (8 * nt)), -(-N // FLOAT_TILE_N)
    tiles, steps = tm * tn, -(-K // FLOAT_BK)
    target = (4 if nt == 1 else 2) * SMS
    splits = 1 if tiles >= SMS else max(1, min(target // tiles, steps // MIN_SPLIT_STAGES,
                                               K // (8 * M)))
    per = -(-steps // splits)
    splits = -(-steps // per)
    return FloatPlan(nt, tm, tn, splits, K if splits == 1 else per * FLOAT_BK)


def float_workspace(M: int, N: int, plan: FloatPlan):
    """(float32 partials, arrival counters) a call of the plan needs."""
    if plan.splits == 1:
        return 0, 0
    return plan.splits * M * N, plan.tiles_m * plan.tiles_n


def _split_state(device: torch.device, tiles: int):
    """(accumulator, counters) pointers of the split int path: int32 tiles of
    128 x 128 and one arrival counter per output tile, in the zeroed int32
    scratch of ``build.split_state``; every call leaves both 0, so a call
    writes no scratch of its own."""
    n = max(tiles, FILL)
    ints, _ = build.split_state("fused_gemm", device, n * (INT_TILE * INT_TILE + 1), 0)
    return ints.data_ptr(), ints.data_ptr() + 4 * n * INT_TILE * INT_TILE


def _lib(source: str):
    """``gl_<source>`` of ``csrc/<source>.cu``: both entries take nine
    pointers, 17 ints and the stream."""
    fn = getattr(build.load(source), f"gl_{source}")
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


def _ptr(t):
    return None if t is None else t.data_ptr()


def _kernel_args(x, W_q, scales, zeros, scales_x, meta):
    """The checked operands of a CUDA call: (x, W_q, s, z, zero scalar, sx,
    gs_s, gs_z, out), raising on what the kernels do not take."""
    if not can_use_fused(meta):
        raise NotImplementedError(f"general fused kernel does not take {meta}: MX layers run "
                                  "on the MX kernels (ops/mx.py); this kernel's MX codecs (row "
                                  "5-MX, for MX layers JAX does not fold) are not ported")
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
    return x, W_q, s, z, zs, sx, gs_s, gs_z, out


def _codes(W_q, s, z):
    """(w_code, s_code, z_code): the DType values of the stored tensors."""
    return (_W_DTYPES[W_q.dtype], _META_DTYPES[s.dtype] if s is not None else 0,
            _META_DTYPES[z.dtype] if z is not None else 0)


def fused_gemm_float(x: torch.Tensor, W_q, scales, zeros, scales_x, meta) -> torch.Tensor:
    """The float path alone: out (M, N) = csm(x (M, K) @ dequant(W_q)) with x
    in bf16 / fp16, or int8 off the int path, or fp8, in one launch of
    ``csrc/fused_float.cu`` planned by ``float_plan``."""
    if x.device.type == "cpu":
        return fused_matmul_plain(x, W_q, scales, zeros, scales_x, meta)
    if int_path(meta) or meta.input_dtype not in (DType.BF16.value,
                                                  DType.FP16.value) + _BYTE_INPUTS:
        raise ValueError(f"the float path does not take {meta}: the int path and float32 x "
                         "run on fused_gemm")
    x, W_q, s, z, zs, sx, gs_s, gs_z, out = _kernel_args(x, W_q, scales, zeros, scales_x, meta)
    M, N, K = x.shape[0], meta.out_features, meta.in_features
    plan = float_plan(M, N, K)
    part = cnt = None
    floats, ints = float_workspace(M, N, plan)
    stream = torch.cuda.current_stream().cuda_stream
    if plan.splits > 1:
        counters, partials = build.split_state("fused_float", x.device, ints, floats, stream)
        part, cnt = partials.data_ptr(), counters.data_ptr()
    w_code, s_code, z_code = _codes(W_q, s, z)
    err = _lib("fused_float")(_ptr(x), _ptr(W_q), _ptr(s), _ptr(z), _ptr(zs), _ptr(sx), _ptr(out), part,
                       cnt, M, N, K, meta.input_dtype, meta.W_nbits, meta.elements_per_sample,
                       w_code, meta.W_group_mode, meta.channel_scale_mode, gs_s, gs_z, s_code,
                       z_code, meta.output_dtype, plan.nt, plan.splits, plan.k_per_split, stream)
    build.check(err, "fused_float")
    fused_gemm_float.launches += 1
    return out


fused_gemm_float.launches = 0


def fused_gemm(x: torch.Tensor, W_q, scales, zeros, scales_x, meta) -> torch.Tensor:
    """out (M, N) = csm(x (M, K) @ dequant(W_q)) for any M: the int path,
    float32 x, or the float path (``fused_gemm_float``)."""
    if x.device.type == "cpu":
        return fused_matmul_plain(x, W_q, scales, zeros, scales_x, meta)
    ip = int_path(meta)
    if not ip and meta.input_dtype != DType.FP32.value and can_use_fused(meta):
        return fused_gemm_float(x, W_q, scales, zeros, scales_x, meta)
    x, W_q, s, z, zs, sx, gs_s, gs_z, out = _kernel_args(x, W_q, scales, zeros, scales_x, meta)
    M, N, K = x.shape[0], meta.out_features, meta.in_features
    plan = int_plan(M, N, K) if ip else IntPlan(0, 0, 1, K, 1, 0)
    ws = cnt = None
    if plan.splits > 1:
        ws, cnt = _split_state(x.device, plan.tiles_m * plan.tiles_n)
    w_code, s_code, z_code = _codes(W_q, s, z)
    err = _lib("fused_gemm")(_ptr(x), _ptr(W_q), _ptr(s), _ptr(z), _ptr(zs), _ptr(sx), _ptr(out), ws, cnt,
                 M, N, K, meta.input_dtype, int(ip), meta.W_nbits, meta.elements_per_sample,
                 w_code, meta.W_group_mode, meta.channel_scale_mode, gs_s, gs_z, s_code, z_code,
                 meta.output_dtype, plan.splits, plan.k_per_split,
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, "fused_gemm")
    fused_gemm.launches += 1
    return out


fused_gemm.launches = 0
