# SPDX-License-Identifier: Apache-2.0
"""fp8 weight kernels: W8 fp8 bit codes (e4m3 / e5m2, four to an int32 word)
times bf16 or fp8 activations, one launch a call (``csrc/fp8_gemm.cu``).

    decode          M <= 64, entry ``gl_fp8_decode``: replaces
                    ``gemlite_tpu/ops/pallas_decode.py:pallas_decode_matmul``
                    on fp8-coded layers (``fp8_coded``, gate ``:499-528``)
    decode_stacked  layer ``l`` of an (L, ...) stack, ``l`` read on the
                    device, entry ``gl_fp8_decode_stacked``: replaces
                    ``gemlite_tpu/ops/pallas_scan.py:pallas_decode_matmul_stacked``
                    on them; the per-layer plan, so the two agree bit for bit
    prefill         64 < M < 4096, entry ``gl_fp8_prefill``: replaces
                    ``gemlite_tpu/ops/pallas_prefill.py:pallas_prefill_matmul``
                    on them

The fp8 weights are true values, summed against x in float32 and scaled
after the dot: W_group_mode 0, or 2 with one group (the column scale on the
sum), then csm 1 / 2 / 3 (``gemlite_tpu/ops/pallas_decode.py:400-406``). At
M >= 4096 the router dequantizes them (``ops/dequantize.py``, the fp8 form of
``csrc/dequantize.cu``) and runs a dense bf16 matmul, as the JAX router
does. The plain version of every entry is ``ops/reference.forward_fp8_ref``.
On a CPU tensor a wrapper runs it; on a CUDA tensor it launches the kernel
or raises. ``decode_plan`` and ``prefill_plan`` own the kernels' grids and
rings: the CUDA side only checks that what it is given fits.
"""

import ctypes
from typing import NamedTuple, Optional

import torch

from ..dtypes import DType, is_mx_dtype, to_torch_dtype
from . import build
from .prefill import STAGE_US, estimate_us
from .reference import forward_fp8_ref

__all__ = ["DecodeFp8Plan", "PrefillFp8Plan", "fp8_coded", "serves_fp8", "fp8_refusal",
           "decode_plan", "prefill_plan", "prefill_smem", "fp8_decode", "fp8_decode_stacked",
           "fp8_prefill"]

BK = 128                   # the decode stage; the prefill stage with fp8 x (64 with bf16 x)
TILE = 128                 # output columns a block
SMS = 132                  # H100 SXM streaming multiprocessors
DECODE_BLOCKS_PER_SM = 3   # the decode kernel's kDecodeMinBlocks (its launch bounds)
DECODE_BUDGET = 72 * 1024  # decode: one block's shared memory, so that three fit an SM's 228 KB
DECODE_RESIDENT = DECODE_BLOCKS_PER_SM * SMS   # decode blocks the card holds at once
MAX_STAGES = 6
PREFILL_STAGES = 5
PREFILL_SMEM_MAX = 227 * 1024
# fp8 x: a 256-row stage's time over a 128-row one's (scripts/torch_fp8_variants.py
# rows_128 / rows_256 on 14336x4096 and 4096x14336, NVIDIA H100 80GB HBM3; PERF.md)
ROWS_256_STAGE = 1.87
CODES = (DType.FP8.value, DType.FP8e5.value)
X_DTYPES = (DType.BF16.value,) + CODES


def fp8_coded(meta) -> bool:
    """True when W_q holds fp8 bit codes, four to an int32 word, outside an MX
    layer (``gemlite_tpu/ops/pallas_decode.py:fp8_coded``; MXFP8 layers take
    the MX kernels, ``ops/mx.py``)."""
    return (meta.W_nbits == 8 and meta.elements_per_sample == 4
            and getattr(meta, "w_code_dtype", 0) != 0 and not is_mx_dtype(meta.input_dtype))


def fp8_refusal(meta, M: Optional[int] = None) -> Optional[str]:
    """Why the fp8 kernels do not take ``meta`` (at M rows), or None: fp8
    codes, W_group_mode 0 or 2 with one group, csm 0-3, bf16 or fp8 (e4m3 /
    e5m2) x, bf16 out, float32 or bf16 scales, K and N multiples of 128."""
    if not fp8_coded(meta):
        return "its weights are not fp8 bit codes"
    if meta.w_code_dtype not in CODES:
        return f"its codes are DType {meta.w_code_dtype}, not e4m3 or e5m2"
    if meta.W_group_mode not in (0, 2) or meta.channel_scale_mode not in (0, 1, 2, 3):
        return (f"W_group_mode {meta.W_group_mode} / csm {meta.channel_scale_mode}: fp8 codes "
                "are true values (mode 0, or 2), csm 0-3")
    if meta.W_group_mode == 2 and meta.group_size != meta.in_features:
        return ("grouped mode-2 fp8 codes outside an MX layer: no processor makes them, and "
                "no kernel of either package takes them (MXFP8 layers: ops/mx.py)")
    if meta.input_dtype not in X_DTYPES or meta.output_dtype != DType.BF16.value:
        return (f"x DType {meta.input_dtype} -> out DType {meta.output_dtype}, not bf16 / fp8 "
                "-> bf16")
    if meta.meta_dtype not in (DType.FP32.value, DType.BF16.value):
        return f"scales of DType {meta.meta_dtype}, not float32 / bf16"
    if meta.in_features % TILE or meta.out_features % TILE:
        return f"K {meta.in_features} and N {meta.out_features} must be multiples of {TILE}"
    if M is not None and not 0 < M < 4096:
        return f"M {M}: the fp8 kernels take M < 4096 (above it the dequantize kernel)"
    return None


def serves_fp8(meta, M: Optional[int] = None) -> bool:
    return fp8_refusal(meta, M) is None


class DecodeFp8Plan(NamedTuple):
    """The decode kernel's grid: ``tiles`` blocks of 128 columns, each summing
    all M rows over ``splits`` K ranges of ``k_per_split`` (the last may be
    shorter), in one launch; a ring of ``stages`` 128-deep stages; ``smem``
    bytes of shared memory."""
    tiles: int
    splits: int
    k_per_split: int
    stages: int
    smem: int

    @property
    def launches(self) -> int:
        return 1


def _row_tiles(M: int) -> int:
    return next(nt for nt in (1, 2, 4, 8) if M <= 8 * nt)


def _x_bytes(meta) -> int:
    return 2 if meta.input_dtype == DType.BF16.value else 1


def decode_plan(M: int, N: int, K: int, x_bytes: int) -> DecodeFp8Plan:
    """K cut in 128-deep stages, at least two a split, into the most splits
    that keep the grid within whole waves of ``DECODE_RESIDENT`` blocks (one
    wave wherever the column tiles fit it): a fractional last wave ran its
    blocks on an otherwise idle card. The split depends on N and K only,
    never on M, so a row's sum runs in the same order at any batch and the
    stacked entry equals the per-layer one."""
    tiles, steps = N // TILE, K // BK
    waves = -(-tiles // DECODE_RESIDENT)
    splits = max(1, min(steps // 2, waves * DECODE_RESIDENT // tiles))
    per = -(-steps // splits)
    stage = BK // 4 * TILE * 4 + _row_tiles(M) * 8 * BK * x_bytes
    stages = max(2, min(MAX_STAGES, DECODE_BUDGET // stage))
    smem = max(stages * stage, M * TILE * 4)
    return DecodeFp8Plan(tiles, -(-steps // per), per * BK, stages, smem)


class PrefillFp8Plan(NamedTuple):
    """The prefill kernel's grid: ``tiles_n`` blocks of 128 weight columns by
    ``tiles_m`` blocks of ``bm`` rows, each summing ``splits`` K ranges of
    ``k_per_split``, in one launch; a ring of ``stages`` stages of ``bk``;
    ``smem`` bytes of shared memory."""
    bm: int
    bk: int
    tiles_n: int
    tiles_m: int
    splits: int
    k_per_split: int
    stages: int
    smem: int

    @property
    def blocks(self) -> int:
        return self.tiles_n * self.tiles_m * self.splits

    @property
    def launches(self) -> int:
        return 1


def prefill_smem(bm: int, bk: int, x_bytes: int, stages: int) -> int:
    """Shared memory of a block (the kernel's PLayout): the ring of x boxes
    (128-byte rows) and word rows (one box a stage; with fp8 x four groups of
    32 columns in the 128-byte swizzle), the float32 epilogue tile over it,
    the mbarriers, the flag and 1024 bytes of slack to align the base."""
    stage = bm * bk * x_bytes + bk // 4 * TILE * 4
    return max(stages * stage, bm * (TILE + 4) * 4) + 16 * stages + 16 + 1024


def _prefill_split(M: int, N: int, K: int, bm: int, bk: int):
    """(tiles_n, tiles_m, splits, stages a split): the K split of least
    ``ops/prefill.estimate_us`` over whole stages a split (a 128-deep fp8
    stage costs about what a 64-deep bf16 one does)."""
    tiles_n, tiles_m = N // TILE, -(-M // bm)
    steps = K // bk
    best = None
    for s in range(1, steps + 1):
        per = -(-steps // s)
        if -(-steps // per) != s:
            continue
        t = estimate_us(M, N, tiles_n * tiles_m, steps, s, bm)
        if best is None or t < best[0]:
            best = (t, s, per)
    return tiles_n, tiles_m, best[1], best[2]


def _prefill_us(M: int, N: int, K: int, bm: int, bk: int) -> float:
    """``ops/prefill.estimate_us`` of the fp8-x kernel on ``bm`` rows a block
    at its split, a 256-row stage at ``ROWS_256_STAGE`` times a 128-row one
    (its two products share the A fragment) in place of twice."""
    tiles_n, tiles_m, splits, per = _prefill_split(M, N, K, bm, bk)
    waves = -(-tiles_n * tiles_m * splits // SMS)
    t = estimate_us(M, N, tiles_n * tiles_m, K // bk, splits, bm)
    if bm == 256:
        t -= waves * per * (STAGE_US[256] - ROWS_256_STAGE * STAGE_US[128])
    return t


def prefill_rows(M: int, N: int, K: int, x_bytes: int) -> int:
    """Rows of x a block: 128 up to M 128. Above, bf16 x takes 256 (two
    products share each A fragment and its conversion); fp8 x the rows of
    least ``_prefill_us``: 256 rows halve the blocks but take 1.87 times as
    long, so 128 win where their grid fills its last wave better (as at M
    1024 on 14336x4096) or needs fewer splits."""
    if M <= 128:
        return 128
    if x_bytes == 2:
        return 256
    return min((128, 256), key=lambda bm: _prefill_us(M, N, K, bm, BK))


def prefill_plan(M: int, N: int, K: int, x_bytes: int, bm: Optional[int] = None) -> PrefillFp8Plan:
    """Rows (``prefill_rows``, unless ``bm`` is given: to time an earlier
    tree's kernel or a variant, or to hold the 256-row instances in the card
    tests), K split (``_prefill_split``) and the deepest ring that fits."""
    bk = 128 if x_bytes == 1 else 64
    bm = bm or prefill_rows(M, N, K, x_bytes)
    tiles_n, tiles_m, splits, per = _prefill_split(M, N, K, bm, bk)
    stages = max(s for s in range(2, PREFILL_STAGES + 1)
                 if prefill_smem(bm, bk, x_bytes, s) <= PREFILL_SMEM_MAX)
    return PrefillFp8Plan(bm, bk, tiles_n, tiles_m, splits, per * bk, stages,
                          prefill_smem(bm, bk, x_bytes, stages))


def _fn(name: str, pointers: int, ints: int):
    fn = getattr(build.load("fp8_gemm"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _operands(x, W_q, scales, scales_x, meta, M: int, layers=None):
    """Checked operands of a CUDA call: (x, scales pointer, s_code, scales_x
    pointer), raising on what the kernels do not take."""
    why = fp8_refusal(meta, M)
    if why is not None:
        raise NotImplementedError(f"fp8 kernels do not take this layer: {why}")
    N, K = meta.out_features, meta.in_features
    x_dtype = to_torch_dtype(meta.input_dtype)
    if not x.is_cuda or x.dtype != x_dtype or tuple(x.shape) != (M, K):
        raise ValueError(f"x: want a CUDA (M, {K}) {x_dtype} tensor, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    lead = () if layers is None else (layers,)
    if not (W_q.is_cuda and W_q.dtype == torch.int32 and tuple(W_q.shape) == lead + (K // 4, N)
            and W_q.is_contiguous() and W_q.data_ptr() % 16 == 0):
        raise ValueError(f"W_q: want a contiguous, 16-byte aligned CUDA int32 tensor of shape "
                         f"{lead + (K // 4, N)}, got {W_q.dtype} {tuple(W_q.shape)}")
    need_s = meta.W_group_mode == 2 or meta.channel_scale_mode in (1, 3)
    s_ptr, s_code = None, DType.FP32.value
    if need_s:
        if (scales is None or scales.numel() != (layers or 1) * N or not scales.is_cuda
                or scales.dtype not in (torch.float32, torch.bfloat16)
                or not scales.is_contiguous()):
            raise ValueError(f"scales: want a contiguous CUDA float32 / bf16 tensor of "
                             f"{(layers or 1) * N} values")
        s_ptr = scales.data_ptr()
        s_code = DType.FP32.value if scales.dtype == torch.float32 else DType.BF16.value
    sx = None
    if meta.channel_scale_mode in (2, 3):
        if scales_x is None or scales_x.numel() != M:
            raise ValueError(f"scales_x: want {M} per-token scales")
        sx = scales_x.to(torch.float32).contiguous()
    return x, s_ptr, s_code, sx


def _split(owner: str, floats: int, ints: int, device, stream):
    if not floats:
        return None, None
    ibuf, fbuf = build.split_state(owner, device, ints, floats, stream)
    return fbuf.data_ptr(), ibuf.data_ptr()


def _decode(x, W_q, scales, scales_x, meta, layer_idx=None, layers=None):
    M = x.shape[0]
    N, K = meta.out_features, meta.in_features
    x, s_ptr, s_code, sx = _operands(x, W_q, scales, scales_x, meta, M, layers)
    p = decode_plan(M, N, K, _x_bytes(meta))
    stream = torch.cuda.current_stream().cuda_stream
    part, cnt = _split("fp8_decode", p.splits * M * N if p.splits > 1 else 0, p.tiles, x.device,
                       stream)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    tail = (meta.input_dtype, meta.w_code_dtype, meta.W_group_mode, meta.channel_scale_mode,
            s_code, p.splits, p.k_per_split, p.stages, stream)
    sx_ptr = None if sx is None else sx.data_ptr()
    if layer_idx is None:
        err = _fn("gl_fp8_decode", 7, 11)(x.data_ptr(), W_q.data_ptr(), s_ptr, sx_ptr, part, cnt,
                                          out.data_ptr(), M, N, K, *tail)
    else:
        err = _fn("gl_fp8_decode_stacked", 8, 12)(x.data_ptr(), W_q.data_ptr(), s_ptr, sx_ptr,
                                                  layer_idx.data_ptr(), part, cnt, out.data_ptr(),
                                                  layers, M, N, K, *tail)
    build.check(err, "fp8_gemm (decode)")
    return out


def fp8_decode(x: torch.Tensor, W_q, scales, scales_x, meta) -> torch.Tensor:
    """out (M, N) bf16 = epilogue(x (M, K) @ W) for M <= 64 and fp8 codes."""
    if x.device.type == "cpu":
        return forward_fp8_ref(x, W_q, scales, scales_x, meta)
    if not 0 < x.shape[0] <= 64:
        raise NotImplementedError(f"the fp8 decode kernel takes M <= 64, not {x.shape[0]}")
    out = _decode(x, W_q, scales, scales_x, meta)
    fp8_decode.launches += 1
    return out


fp8_decode.launches = 0


def fp8_decode_stacked(x: torch.Tensor, W_q, scales, meta, layer_idx) -> torch.Tensor:
    """Layer ``layer_idx`` of the stacks ``W_q`` (L, K / 4, N) and ``scales``
    (L, 1, N) for M <= 64, unscaled x (the stacked path carries no per-token
    scales). ``layer_idx``: a one-element int32 tensor on the card (an int on
    the CPU too), never read by the host on the card."""
    if x.device.type == "cpu":
        li = int(layer_idx)
        return forward_fp8_ref(x, W_q[li], None if scales is None else scales[li], None, meta)
    if not 0 < x.shape[0] <= 64:
        raise NotImplementedError(f"the fp8 decode kernel takes M <= 64, not {x.shape[0]}")
    if meta.channel_scale_mode in (2, 3):
        raise NotImplementedError("the stacked path carries no per-token scales")
    if not (isinstance(layer_idx, torch.Tensor) and layer_idx.device == x.device
            and layer_idx.dtype == torch.int32 and layer_idx.numel() == 1):
        raise ValueError("layer_idx: want a one-element int32 tensor on the card, got "
                         f"{layer_idx!r}")
    out = _decode(x, W_q, scales, None, meta, layer_idx, W_q.shape[0])
    fp8_decode_stacked.launches += 1
    return out


fp8_decode_stacked.launches = 0


def fp8_prefill(x: torch.Tensor, W_q, scales, scales_x, meta) -> torch.Tensor:
    """out (M, N) bf16 = epilogue(x (M, K) @ W) for 64 < M < 4096 and fp8
    codes."""
    if x.device.type == "cpu":
        return forward_fp8_ref(x, W_q, scales, scales_x, meta)
    M, N, K = x.shape[0], meta.out_features, meta.in_features
    out = _prefill(x, W_q, scales, scales_x, meta, prefill_plan(M, N, K, _x_bytes(meta)))
    fp8_prefill.launches += 1
    return out


def _prefill(x, W_q, scales, scales_x, meta, p: PrefillFp8Plan) -> torch.Tensor:
    """One launch of the prefill kernel on the plan ``p`` (``fp8_prefill``
    gives ``prefill_plan``'s; the card tests force 256 rows with it)."""
    M, N = x.shape[0], meta.out_features
    x, s_ptr, s_code, sx = _operands(x, W_q, scales, scales_x, meta, M)
    stream = torch.cuda.current_stream().cuda_stream
    part, cnt = _split("fp8_prefill", p.splits * M * N if p.splits > 1 else 0,
                       p.tiles_n * p.tiles_m, x.device, stream)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    err = _fn("gl_fp8_prefill", 7, 12)(
        x.data_ptr(), W_q.data_ptr(), s_ptr, None if sx is None else sx.data_ptr(), part, cnt,
        out.data_ptr(), M, N, meta.in_features, meta.input_dtype, meta.w_code_dtype,
        meta.W_group_mode, meta.channel_scale_mode, s_code, p.bm, p.splits, p.k_per_split,
        p.stages, stream)
    build.check(err, "fp8_gemm (prefill)")
    return out


fp8_prefill.launches = 0
