# SPDX-License-Identifier: Apache-2.0
"""Exact int8 decode kernel: int8 x against integer weights, int32 sums,
for M <= 64 (``csrc/int8_decode.cu``).

Replaces ``gemlite_tpu/ops/pallas_int8.py:pallas_int8_decode``. It serves
INT8-activation layers over three weight forms:

    i8_dense    non-packed int8 (K, N) weights (A8W8)
    u8_packed   W8 codes in int32 words, ``code - 128`` as int8 and a
                ``(128 - z) * sum(x)`` correction
    nibble      W4 / W2 codes in int32 words (grouped mode 3, channel-wise)

with W_group_mode 0 / 1 / 3 (integer zeros: scalar, per channel or per
group) and channel_scale_mode 0-3. The sum over K is exact in int32, except
that grouped mode-3 layers scale each group's exact int32 sum by its float32
scale and add the groups in float32 (see ``Form.float_groups``).

The plain version, ``int8_decode_plain``, repeats that arithmetic in the same
order. On a CPU tensor the wrapper runs it; on a CUDA tensor it launches the
kernel or raises.
"""

import ctypes
import math
from typing import NamedTuple

import torch

from ..dtypes import DType, to_torch_dtype
from . import build
from .reference import int_matmul, unpack_rows_ref

__all__ = ["DecodePlan", "can_use_int8_decode", "int8_decode", "int8_decode_plain",
           "int8_mma_tile", "plan", "w_kind"]

MAX_M = 64
_KINDS = {"i8_dense": 0, "u8_packed": 1, "nibble4": 2, "nibble2": 3}
_STEP_K = {"i8_dense": 4, "u8_packed": 4, "nibble4": 8, "nibble2": 16}
_SPLIT_UNIT = 32           # K must be a multiple of this (the gate)
BN = 128                   # the kernel's output columns per block
BK = 128                   # its K step
SMS = 132                  # H100 SXM streaming multiprocessors
BLOCKS_PER_SM = 3          # blocks that share an SM (shared memory <= 74 KB each)
FGROUP_BLOCKS_PER_SM = 2   # float-group instances take about 224 registers a thread
# the last block of a column tile adds at most this many 4-byte partials (128 KB)
PARTIAL_WORDS = 1 << 15
_META_CODES = {torch.float32: DType.FP32.value, torch.float16: DType.FP16.value,
               torch.bfloat16: DType.BF16.value, torch.int32: DType.INT32.value}


def w_kind(meta):
    """The weight form (``pallas_int8.py:_w_kind``), nibbles by width."""
    if meta.elements_per_sample == 1 and meta.W_nbits == 8:
        return "i8_dense"
    if meta.elements_per_sample == 4 and meta.W_nbits == 8:
        return "u8_packed"
    if meta.W_nbits in (2, 4) and meta.elements_per_sample == 32 // meta.W_nbits:
        return f"nibble{meta.W_nbits}"
    return None


def _gs_eff(meta) -> int:
    gs, K = meta.group_size, meta.in_features
    return gs if 1 < gs < K else 0


def can_use_int8_decode(meta, M: int) -> bool:
    """The layers the kernel serves (the gate of ``pallas_int8.py:72``,
    without the TPU's block and sublane rules)."""
    if meta.input_dtype != DType.INT8.value or not 0 < M <= MAX_M:
        return False
    kind = w_kind(meta)
    if kind is None or meta.W_group_mode not in (0, 1, 3) or meta.channel_scale_mode not in (0, 1, 2, 3):
        return False
    N, K = meta.out_features, meta.in_features
    if N % 4 or K % _SPLIT_UNIT:
        return False
    gs = _gs_eff(meta)
    if gs:
        # grouped dense int8 stays off this kernel, as on the TPU
        return kind != "i8_dense" and K % gs == 0 and gs % _STEP_K[kind] == 0
    return True


class Form(NamedTuple):
    """How a layer's metadata enters the sum.

    zero_mode: 0 none, 1 scalar (int32 scalar tensor), 2 per channel (1, N),
    3 per group (G, N). gs_loop: the K span whose correction ``(off8 - z) *
    sum(x)`` is taken together (a group, or 0 for the whole split).
    float_groups: grouped mode-3 scales, so each group's exact int32 sum is
    scaled in float32 and the groups are added in float32, in k order within
    a split and then split after split. flat_scale: channel-wise mode-3
    scales, applied once to the exact int32 sum over K."""

    kind: str
    off8: int
    zero_mode: int
    gs_loop: int
    float_groups: bool
    flat_scale: bool


def form(meta, scales, zeros) -> Form:
    N = meta.out_features
    kind = w_kind(meta)
    has_zeros = zeros is not None and meta.W_group_mode in (1, 3)
    has_gscales = scales is not None and meta.W_group_mode == 3
    if not has_zeros:
        zero_mode = 0
    elif meta.zero_is_scalar:
        zero_mode = 1
    else:
        zero_mode = 2 if zeros.numel() == N else 3
    grouped_scales = has_gscales and scales.numel() > N
    gs_loop = _gs_eff(meta) if (zero_mode == 3 or grouped_scales) else 0
    return Form(kind=kind, off8=128 if kind == "u8_packed" else 0, zero_mode=zero_mode,
                gs_loop=gs_loop, float_groups=grouped_scales,
                flat_scale=has_gscales and not grouped_scales)


class DecodePlan(NamedTuple):
    """The kernel's grid for one call: ``tiles`` blocks of 128 output columns,
    each summing all M rows over ``splits`` K ranges of ``k_per_split`` (the
    last may be shorter), all in ``launches`` launches; ``sk`` is the K of
    one sum step (32 or 16 on mma.sync, 4 on __dp4a)."""
    tiles: int
    splits: int
    k_per_split: int
    sk: int
    launches: int


def plan(M: int, N: int, K: int, gs_loop: int, float_groups: bool = False) -> DecodePlan:
    """Tiles, K split and sum step, from the shape and the form. K is cut in
    whole units of lcm(group, 128) (128 without groups) so that as many
    blocks as share an SM (``BLOCKS_PER_SM``, ``FGROUP_BLOCKS_PER_SM`` for
    float groups) run on every SM at once, all in one wave. Integer sums
    split no further than the last block can add ``PARTIAL_WORDS`` partials
    of its M rows; float groups ignore M, so their float32 order never
    depends on the batch."""
    tiles = -(-N // BN)
    unit = math.lcm(gs_loop, BK) if gs_loop else BK
    units = -(-K // unit)
    per_sm = FGROUP_BLOCKS_PER_SM if float_groups else BLOCKS_PER_SM
    splits = max(1, min(units, per_sm * SMS // tiles))
    if not float_groups:
        splits = min(splits, max(1, PARTIAL_WORDS // (-(-M // 8) * 8 * BN)))
    per = -(-units // splits)
    splits = -(-units // per)
    sk = 32 if gs_loop % 32 == 0 else (16 if gs_loop % 16 == 0 else 4)
    return DecodePlan(tiles, splits, min(K, per * unit), sk, 1)


def workspace(M: int, N: int, p: DecodePlan):
    """(partials, arrival counters) that a call needs, in 4-byte elements: a
    split call writes each split's (M, N) int32 sums, or float32 group sums,
    and counts arrivals per column tile. The counters are 0 between calls."""
    if p.splits == 1:
        return 0, 0
    return p.splits * M * N, p.tiles


def _epilogue(v, scales, scales_x, meta, f: Form):
    """float32 (M, N) -> output: flat mode-3 scale, then csm 1/2/3 in float32."""
    if f.flat_scale:
        v = v * scales.reshape(1, -1).to(torch.float32)
    csm = meta.channel_scale_mode
    if csm == 1:
        v = v * scales.reshape(1, -1).to(torch.float32)
    elif csm == 2:
        v = v * scales_x.reshape(-1, 1).to(torch.float32)
    elif csm == 3:
        v = v * scales_x.reshape(-1, 1).to(torch.float32) * scales.reshape(1, -1).to(torch.float32)
    return v.to(to_torch_dtype(meta.output_dtype))


def int8_decode_plain(x, W_q, scales, zeros, scales_x, meta) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: int32-exact sums (a float64
    matmul, exact here), the float32 group order of the kernel, its epilogue."""
    f = form(meta, scales, zeros)
    N, K = meta.out_features, meta.in_features
    M = x.shape[0]
    codes = unpack_rows_ref(W_q, meta.W_nbits, meta.elements_per_sample, K).to(torch.int64)
    xi = x.to(torch.int64)
    if f.zero_mode == 0:
        z = torch.zeros((), dtype=torch.int64, device=x.device)
    elif f.zero_mode == 1:
        z = zeros.to(torch.int64)
    else:
        z = zeros.reshape(-1, N).to(torch.int64)            # (1, N) or (G, N)
    if not f.gs_loop:
        raw = int_matmul(xi, codes).to(torch.int64)
        v = (raw - z.reshape(1, -1) * xi.sum(dim=1, keepdim=True)).to(torch.float32) \
            if f.zero_mode else raw.to(torch.float32)
        return _epilogue(v, scales, scales_x, meta, f)
    gs = f.gs_loop
    G = K // gs
    xg = xi.reshape(M, G, gs).permute(1, 0, 2)             # (G, M, gs)
    raw = (xg.to(torch.float64) @ codes.reshape(G, gs, N).to(torch.float64)).to(torch.int64)
    zg = z.reshape(-1, 1, N) if f.zero_mode >= 2 else z
    corr = raw - zg * xg.sum(dim=2, keepdim=True)          # (G, M, N)
    if not f.float_groups:
        return _epilogue(corr.sum(dim=0).to(torch.float32), scales, scales_x, meta, f)
    contrib = corr.to(torch.float32) * scales.reshape(G, 1, N).to(torch.float32)
    pl = plan(M, N, K, gs, float_groups=True)
    splits, per = pl.splits, pl.k_per_split // gs
    v = None
    for sp in range(splits):
        part = torch.zeros((M, N), dtype=torch.float32, device=x.device)
        for g in range(sp * per, min(G, (sp + 1) * per)):
            part = part + contrib[g]
        v = part if v is None else v + part
    return _epilogue(v, scales, scales_x, meta, f)


def _lib(name="gl_int8_decode"):
    fn = getattr(build.load("int8_decode"), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 15 + [ctypes.c_void_p]
                       if name == "gl_int8_decode" else
                       [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _meta_arg(t):
    """A metadata tensor the kernel reads as stored (float32, fp16, bf16 or
    int32), else converted to float32; contiguous."""
    if t is None:
        return None
    if t.dtype not in _META_CODES:
        t = t.to(torch.float32)
    return t.contiguous()


def int8_decode(x: torch.Tensor, W_q, scales, zeros, scales_x, meta) -> torch.Tensor:
    """out (M, N) = csm(x_i8 (M, K) @ dequant_int(W_q)) for M <= 64."""
    if x.device.type == "cpu":
        return int8_decode_plain(x, W_q, scales, zeros, scales_x, meta)
    M = x.shape[0]
    if not can_use_int8_decode(meta, M):
        raise NotImplementedError(f"int8 decode kernel does not take M={M} with {meta}")
    N, K = meta.out_features, meta.in_features
    f = form(meta, scales, zeros)
    if x.dtype != torch.int8 or tuple(x.shape) != (M, K):
        raise ValueError(f"x: want a CUDA (M, {K}) int8 tensor, got {x.dtype} {tuple(x.shape)}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    want_w = (torch.int8, (K, N)) if f.kind == "i8_dense" else \
        (torch.int32, (K // meta.elements_per_sample, N))
    if not (W_q.is_cuda and W_q.dtype == want_w[0] and tuple(W_q.shape) == want_w[1]
            and W_q.is_contiguous() and W_q.data_ptr() % 4 == 0):
        raise ValueError(f"W_q: want a contiguous CUDA {want_w[0]} tensor of shape {want_w[1]}")
    csm = meta.channel_scale_mode
    s = _meta_arg(scales) if (f.float_groups or f.flat_scale or csm in (1, 3)) else None
    z = _meta_arg(zeros) if f.zero_mode else None
    sx = scales_x.to(torch.float32).contiguous() if csm in (2, 3) else None
    if (csm in (2, 3) and (sx is None or sx.numel() != M)) or \
            (s is None and (f.float_groups or f.flat_scale or csm in (1, 3))):
        raise ValueError(f"missing scales for {meta}")
    p = plan(M, N, K, f.gs_loop, f.float_groups)
    words, counters = workspace(M, N, p)
    part = cnt = None
    if p.splits > 1:
        ibuf, fbuf = build.split_state("int8_decode", x.device, counters, words)
        part, cnt = fbuf.data_ptr(), ibuf.data_ptr()
    out = torch.empty((M, N), dtype=to_torch_dtype(meta.output_dtype), device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _lib()(ptr(x), ptr(W_q), ptr(z), ptr(s), ptr(sx), part, cnt,
                 ptr(out), M, N, K, _KINDS[f.kind], f.gs_loop, p.splits, p.k_per_split,
                 f.zero_mode, f.off8, int(f.float_groups), int(f.flat_scale), csm,
                 _META_CODES[s.dtype] if s is not None else 0,
                 _META_CODES[z.dtype] if z is not None else 0, meta.output_dtype,
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, "int8_decode")
    int8_decode.launches += 1
    return out


int8_decode.launches = 0


def int8_mma_tile(w: torch.Tensor, x: torch.Tensor, sk: int = 32) -> torch.Tensor:
    """The kernel's sum step alone on one tile: (8, 16) int32 = x (8, 32) int8
    @ w (32, 16) int8, through its staging, ldmatrix, ``sk``-deep step (32 or
    16 on mma.sync, 4 on __dp4a) and fragment mapping (a test entry)."""
    if w.shape != (32, 16) or x.shape != (8, 32) or w.dtype != torch.int8 or x.dtype != torch.int8:
        raise ValueError("want w (32, 16) and x (8, 32) int8")
    if x.device.type == "cpu":
        return int_matmul(x, w).to(torch.int32)
    out = torch.empty((8, 16), dtype=torch.int32, device=x.device)
    err = _lib("gl_int8_mma_tile")(w.contiguous().data_ptr(), x.contiguous().data_ptr(),
                                   out.data_ptr(), sk, torch.cuda.current_stream().cuda_stream)
    build.check(err, "int8_mma_tile")
    return out
