# SPDX-License-Identifier: Apache-2.0
"""MX weight kernels: fp4 (e2m1) or fp8 (e4m3 / e5m2) codes with e8m0 group
scales of 32, or NVFP4 (fp4 codes, e4m3 x 0.05 scales of 16), times bf16,
per-token e4m3 or micro-scaled activations, one launch a call
(``csrc/mx_gemm.cu``, its decoder in ``csrc/mx_common.cuh``).

    decode           M <= 64, e8m0 layers, entry ``gl_mx_decode``: replaces
                     ``gemlite_tpu/ops/pallas_decode.py:pallas_decode_matmul``
                     on MX layers (gate ``:499-528``)
    decode_stacked   layer ``l`` of an (L, ...) stack, ``l`` read on the
                     device, entry ``gl_mx_decode_stacked``: replaces
                     ``gemlite_tpu/ops/pallas_scan.py:pallas_decode_matmul_stacked``
                     on them, with the per-layer plan (bit for bit equal)
    prefill          M < 4096 (NVFP4 from M 1), entry ``gl_mx_prefill``:
                     replaces ``gemlite_tpu/ops/pallas_prefill.py:pallas_prefill_matmul``
                     on MX layers (gate ``:456-532``)
    prefill_csm4     the same entry fed e4m3 codes and float32 group scales
                     (``quant.scale_activations_mx``): the JAX router's
                     ``prefill_mx_csm4`` (``gemlite_tpu/ops/dispatch.py:140-154``)

At M >= 4096 the router dequantizes MX layers (``ops/dequantize.py``, the MX
form of ``csrc/dequantize.cu``) and runs a dense bf16 matmul, as JAX does.
The plain version of every entry is ``ops/reference.mx_forward_ref``. On a
CPU tensor a wrapper runs it; on a CUDA tensor it launches the kernel or
raises. ``decode_plan``, ``prefill_plan`` and ``general_plan`` own the
kernels' grids and rings: the CUDA side only checks that what it is given
fits.

    general          M < 4096, fp4 layers of any N and of K a multiple of 8
                     and of the group, entry ``gl_mx_general``: replaces the
                     MX codecs of ``gemlite_tpu/ops/pallas_gemm.py:
                     pallas_fused_matmul`` (``:53-80``, scale codecs
                     ``:116-120``) under the route name ``general_fused``, on
                     the ragged instances of the decode body (M <= 64, e8m0)
                     and of the prefill body (NVFP4, and M > 64), as
                     ``general_plan`` picks them

The decode and prefill kernels take the layers the JAX package folds into its
plane layout (``jax_folds``: K and N multiples of 128), with bf16 activations
and output. A layer JAX does not fold runs on its general fused kernel there
or on its oracle, and on the general kernel here when its codes are fp4. An
fp8-coded layer off the fold rule has no kernel in either package (JAX runs
its oracle): on the card it raises, as does an fp16 (MXFP16) layer, for which
no instance is built.
"""

import ctypes
from typing import NamedTuple, Optional

import torch

from ..dtypes import DType, is_mx_dtype, to_torch_dtype
from . import build
from .prefill import estimate_us, row_tile
from .reference import mx_forward_ref

__all__ = ["DecodeMxPlan", "PrefillMxPlan", "GeneralMxPlan", "mx_coded", "jax_folds",
           "mx_refusal", "serves_mx", "decode_plan", "decode_smem", "ragged_decode_plan",
           "prefill_plan", "prefill_smem",
           "general_plan", "mx_decode", "mx_decode_stacked", "mx_prefill", "mx_prefill_csm4",
           "mx_general", "w_kind"]

BK = 128                   # the decode stage
TILE = 128                 # output columns a block
SMS = 132                  # H100 SXM streaming multiprocessors
DECODE_BLOCKS = 3          # decode: blocks an SM (the kernel's launch bounds, kDecodeBlocks)
DECODE_RESIDENT = DECODE_BLOCKS * SMS
DECODE_BUDGET = 72 * 1024  # decode: one block's ring, three blocks an SM
DECODE_MAX_STAGES = 8
RAGGED_TARGET_BLOCKS = 4 * SMS   # the ragged decode body: about four blocks an SM
RAGGED_BUDGET = 72 * 1024        # its ring, three blocks an SM
MAX_STAGES = 6             # the ragged decode body's and the prefill's rings
PREFILL_BK = 64
PREFILL_STAGES = 5
PREFILL_SMEM_MAX = 227 * 1024
PREFILL_XBUFS = 3          # the code form's bf16 x tiles (the kernel's kXBufs)
FP8_CODES = {DType.FP8.value: 1, DType.FP8e5.value: 2}     # w_code_dtype -> w_kind


def mx_coded(meta) -> bool:
    """True for a layer of MX input dtype (its codes are fp4 or fp8 with group
    scales)."""
    return is_mx_dtype(meta.input_dtype)


def w_kind(meta) -> int:
    """The kernels' weight kind: 0 fp4 codes, 1 e4m3, 2 e5m2."""
    return 0 if meta.W_nbits == 4 else FP8_CODES[meta.w_code_dtype]


def _nvfp4(meta) -> bool:
    return meta.input_dtype == DType.NVFP4.value


def jax_folds(meta) -> bool:
    """True when the JAX package folds this MX layer into its plane layout
    (``gemlite_tpu/core.py:_plane_fold_unit``): fp4 or fp8 codes, the fold
    unit (32 for NVFP4, else the group) a whole number of plane rows of 8,
    K and N multiples of 128. JAX's decode, prefill and dequantize kernels
    serve exactly these MX layers; the others take its general fused kernel."""
    K, N = meta.in_features, meta.out_features
    if meta.W_nbits not in (4, 8) or meta.elements_per_sample != 32 // meta.W_nbits:
        return False
    F = 32 if _nvfp4(meta) else meta.group_size
    planes = 4 if meta.W_nbits == 4 else 2
    return not (K % F or F % planes or (F // planes) % 8 or N % 128 or K % 128)


def mx_refusal(meta, M: Optional[int] = None, route: str = "prefill") -> Optional[str]:
    """Why the MX kernel of ``route`` ("decode", "prefill", "prefill_csm4" or
    "general") does not take ``meta`` at M rows, or None."""
    if not mx_coded(meta):
        return "it is not an MX layer"
    nvfp4 = _nvfp4(meta)
    if meta.W_group_mode != 2:
        return f"W_group_mode {meta.W_group_mode}: MX layers are mode 2"
    if meta.W_nbits == 4 and meta.elements_per_sample == 8:
        if meta.w_code_dtype:
            return f"fp4 codes marked as fp8 (w_code_dtype {meta.w_code_dtype})"
    elif meta.W_nbits == 8 and meta.elements_per_sample == 4 and meta.w_code_dtype in FP8_CODES:
        if nvfp4:
            return "NVFP4 with fp8 codes"
    else:
        return (f"W_nbits {meta.W_nbits} / {meta.elements_per_sample} a word / w_code_dtype "
                f"{meta.w_code_dtype}: MX codes are fp4 eight a word or fp8 four a word")
    if nvfp4 and (meta.group_size != 16 or meta.meta_dtype != DType.FP8.value):
        return "NVFP4 takes groups of 16 with e4m3 scales"
    if not nvfp4 and (meta.group_size != 32 or meta.meta_dtype != DType.UINT8.value):
        return (f"group {meta.group_size} with scales of DType {meta.meta_dtype}: e8m0 MX "
                "layers take groups of 32 with uint8 exponent bits")
    if not jax_folds(meta):
        if meta.W_nbits != 4:
            return (f"fp8 codes with K {meta.in_features} / N {meta.out_features} off the JAX "
                    "fold rule: JAX has no kernel for such a layer, only its oracle (its "
                    "general fused kernel refuses fp8 codes, pallas_gemm.py:225-231), and the "
                    "port has none either")
        if route != "general":
            return (f"K {meta.in_features} / N {meta.out_features} off the JAX fold rule: "
                    "such fp4 layers take the general kernel (route general_fused)")
    if meta.input_dtype == DType.MXFP16.value or meta.output_dtype != DType.BF16.value:
        return (f"input DType {meta.input_dtype} -> output DType {meta.output_dtype}: the MX "
                "kernels are built for bf16 activations and output only (no fp16 instance)")
    csm = meta.channel_scale_mode
    if csm not in (0, 2, 4) or (csm == 2 and meta.input_dtype != DType.MXFP8.value):
        return f"csm {csm} with input DType {meta.input_dtype}"
    if route == "general":
        if csm == 4:
            return "csm 4 x reaches the general kernel fake-quantized (csm 0)"
        if meta.W_nbits != 4:
            return "the general kernel takes fp4 codes only"
        if M is not None and not 0 < M < 4096:
            return f"M {M}: the general kernel takes M < 4096 (above it a dense matmul)"
    elif route == "decode":
        if nvfp4:
            return ("NVFP4 has no decode form: JAX sends its M <= 64 calls to the prefill "
                    "kernel, and so does the port")
        if csm == 4:
            return "csm 4 x reaches the decode kernel fake-quantized (csm 0)"
        if M is not None and not 0 < M <= 64:
            return f"the MX decode kernel takes M <= 64, not {M}"
    else:
        if (route == "prefill_csm4") != (csm == 4):
            return f"csm {csm} on the {route} form"
        if M is not None and not 0 < M < 4096:
            return f"M {M}: the MX prefill kernel takes M < 4096 (above it the dequantize kernel)"
    return None


def serves_mx(meta, M: Optional[int] = None, route: str = "prefill") -> bool:
    return mx_refusal(meta, M, route) is None


class DecodeMxPlan(NamedTuple):
    """The decode kernel's grid: ``tiles`` blocks of 128 columns (the last may
    hang past N in the ragged body), each summing
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


def _words_bytes(kind: int, depth: int) -> int:
    return depth // (8 if kind == 0 else 4) * TILE * 4


def decode_smem(kind: int, x_bytes: int, M: int, stages: int) -> int:
    """Shared memory of a decode block (the kernel's ``DLayout``): a ring of
    stages, each the rows of x (M rounded up to 8) of 128 k, the word box
    and four scale rows of 128 bytes; the float32 epilogue tile over it; 1024
    bytes of slack to align the base."""
    return max(stages * _decode_stage(kind, x_bytes, M), -(-M // 8) * 8 * TILE * 4) + 1024


def _decode_stage(kind: int, x_bytes: int, M: int) -> int:
    return -(-M // 8) * 8 * BK * x_bytes + _words_bytes(kind, BK) + BK // 32 * TILE


def decode_plan(M: int, N: int, K: int, kind: int, x_bytes: int) -> DecodeMxPlan:
    """The folded layers' decode grid: K cut in 128-deep stages, at least two
    a split, into the most splits that keep the grid within whole waves of
    ``DECODE_RESIDENT`` blocks (one wave wherever the column tiles fit it): a
    fractional last wave runs its blocks on an otherwise idle card. The split
    depends on N and K only, never on M or the form of x, so a row's sum runs
    in the same order at any batch and the stacked entry equals the
    per-layer one. The ring is the deepest that fits ``DECODE_BUDGET``
    (three blocks an SM), at least two stages, and at most half the block's
    stages (so the prologue is a small share of its life) or, for a block
    of two or three stages, all of them."""
    tiles, steps = N // TILE, K // BK
    waves = -(-tiles // DECODE_RESIDENT)
    splits = max(1, min(steps // 2, waves * DECODE_RESIDENT // tiles))
    per = -(-steps // splits)
    most = per // 2 if per >= 4 else per
    stages = max(2, min(DECODE_MAX_STAGES, DECODE_BUDGET // _decode_stage(kind, x_bytes, M),
                        most))
    return DecodeMxPlan(tiles, -(-steps // per), per * BK, stages,
                        decode_smem(kind, x_bytes, M, stages))


def ragged_decode_plan(M: int, N: int, K: int) -> DecodeMxPlan:
    """The ragged decode body's grid (fp4 codes, ring sized for bf16 x): K
    cut in units of 256 so that about ``RAGGED_TARGET_BLOCKS`` blocks run at
    once (a split is whole stages; K may end inside the last); the split
    depends on N and K only. A stage: the word rows, four scale rows and M
    rounded up to 8 rows of x (the kernel's ``r_stage_bytes``)."""
    tiles = -(-N // TILE)
    unit = 2 * BK
    units = -(-K // unit)
    splits = max(1, min(units, -(-RAGGED_TARGET_BLOCKS // tiles)))
    per = -(-units // splits)
    splits = -(-units // per)
    rows = -(-M // 8) * 8
    stage = _words_bytes(0, BK) + BK // 32 * TILE + rows * BK * 2
    stages = max(2, min(MAX_STAGES, RAGGED_BUDGET // stage))
    smem = max(stages * stage, M * TILE * 4)
    return DecodeMxPlan(tiles, splits, min(-(-K // BK) * BK, per * unit), stages, smem)


class PrefillMxPlan(NamedTuple):
    """The prefill kernel's grid: ``tiles_n`` blocks of 128 weight columns by
    ``tiles_m`` blocks of ``bm`` rows, each summing ``splits`` K ranges of
    ``k_per_split`` (the last may be shorter, and in the ragged instance end
    inside a stage), in one launch; a ring of ``stages`` stages of ``bk``;
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


def prefill_smem(kind: int, stages: int, bm: int = 128, x_codes: bool = False) -> int:
    """Shared memory of a block (the kernel's PLayout): the bf16 x tiles (bm
    rows of 128 bytes; one a stage, or ``PREFILL_XBUFS`` for e4m3 x), the
    rings of word rows and 512-byte scale rows, for e4m3 x the rings of code
    boxes (bm rows of 64 bytes) and of their group scales (bm rows of 16
    bytes); the float32 epilogue tile (rows of 128 + 4 floats) over them; the
    mbarriers (two a stage, and two a bf16 tile for e4m3 x), the flag and
    1024 bytes of slack to align the base."""
    xbufs = PREFILL_XBUFS if x_codes else stages
    ring = xbufs * bm * PREFILL_BK * 2 + stages * (_words_bytes(kind, PREFILL_BK) + 512)
    if x_codes:
        ring += stages * (bm * PREFILL_BK + bm * 16)
    bars = 2 * stages + (2 * PREFILL_XBUFS if x_codes else 0)
    return max(ring, bm * (TILE + 4) * 4) + 8 * bars + 16 + 1024


def prefill_plan(M: int, N: int, K: int, kind: int, x_codes: bool = False,
                 bm: Optional[int] = None) -> PrefillMxPlan:
    """``bm`` rows of x a block (``ops/prefill.row_tile``: 128 up to M 128,
    256 above, unless given), the K split of least ``ops/prefill.estimate_us``
    over whole 64-deep stages, and the deepest ring that fits for the form of
    x (``x_codes``: e4m3 codes). The rows and the split do not depend on the
    form of x, so the code form sums in the bf16 form's order. A last stage
    partly past K (the ragged instance) counts as a whole one. ``bm`` is
    given only to time an earlier tree's kernel, which took 128 rows."""
    bm, bk = bm or row_tile(M), PREFILL_BK
    tiles_n, tiles_m = -(-N // TILE), -(-M // bm)
    steps = -(-K // bk)
    best = None
    for s in range(1, steps + 1):
        per = -(-steps // s)
        if -(-steps // per) != s:
            continue
        t = estimate_us(M, N, tiles_n * tiles_m, steps, s, bm)
        if best is None or t < best[0]:
            best = (t, s, per)
    _, splits, per = best
    stages = max(s for s in range(2, PREFILL_STAGES + 1)
                 if prefill_smem(kind, s, bm, x_codes) <= PREFILL_SMEM_MAX)
    return PrefillMxPlan(bm, bk, tiles_n, tiles_m, splits, per * bk, stages,
                         prefill_smem(kind, stages, bm, x_codes))


class GeneralMxPlan(NamedTuple):
    """The general entry's plan: ``body`` "decode" (the MX decode body's
    ragged instance: one block of all M rows, rounded up to 8, a column tile)
    or "prefill" (the MX prefill body's ragged instance: blocks of ``bm``
    rows); ``tiles_n`` column tiles of 128 (the last may hang past N) by
    ``tiles_m`` row tiles; ``splits`` K ranges of ``k_per_split`` (a multiple
    of ``bk``; the last may be shorter and end inside a stage); a ring of
    ``stages`` stages of ``bk``; ``smem`` bytes of shared memory, enough for
    bf16 and e4m3 x alike."""
    body: str
    bm: int
    bk: int
    tiles_n: int
    tiles_m: int
    splits: int
    k_per_split: int
    stages: int
    smem: int

    @property
    def launches(self) -> int:
        return 1


def general_plan(M: int, N: int, K: int, nvfp4: bool) -> GeneralMxPlan:
    """M <= 64 with e8m0 scales: the ragged decode body with its split and
    the ring for bf16 x (e4m3 x needs less). NVFP4 at every M, and e8m0
    above M 64: the prefill body with ``prefill_plan``'s rows, split and ring,
    as the folded NVFP4 layers run from M 1. It does not depend on the form
    of x."""
    if M <= 64 and not nvfp4:
        d = ragged_decode_plan(M, N, K)
        return GeneralMxPlan("decode", -(-M // 8) * 8, BK, d.tiles, 1, d.splits, d.k_per_split,
                             d.stages, d.smem)
    p = prefill_plan(M, N, K, 0)
    return GeneralMxPlan("prefill", p.bm, p.bk, p.tiles_n, p.tiles_m, p.splits, p.k_per_split,
                         p.stages, max(prefill_smem(0, p.stages, p.bm, c) for c in (False, True)))


def _fn(name: str, pointers: int, ints: int):
    fn = getattr(build.load("mx_gemm"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _weights(W_q, scales, meta, layers=None):
    """The checked weight operands: (W_q, scales as uint8 bytes)."""
    N, K = meta.out_features, meta.in_features
    lead = () if layers is None else (layers,)
    epw = meta.elements_per_sample
    if not (W_q.is_cuda and W_q.dtype == torch.int32 and tuple(W_q.shape) == lead + (K // epw, N)
            and W_q.is_contiguous() and W_q.data_ptr() % 16 == 0):
        raise ValueError(f"W_q: want a contiguous, 16-byte aligned CUDA int32 tensor of shape "
                         f"{lead + (K // epw, N)}, got {W_q.dtype} {tuple(W_q.shape)}")
    want = torch.float8_e4m3fn if _nvfp4(meta) else torch.uint8
    G = K // meta.group_size
    if not (scales is not None and scales.is_cuda and scales.dtype == want
            and tuple(scales.shape) == lead + (G, N) and scales.is_contiguous()
            and scales.data_ptr() % 16 == 0):
        raise ValueError(f"scales: want a contiguous CUDA {want} tensor of shape {lead + (G, N)}")
    return W_q, scales.view(torch.uint8)


def _check(meta, M: int, route: str):
    why = mx_refusal(meta, M, route)
    if why is not None:
        raise NotImplementedError(f"the MX {route} kernel does not take this layer: {why}")


def _x(x, meta, M: int):
    """x as the kernels read it: bf16, or e4m3 per token for csm 2 -> (x, x_code)."""
    want = torch.float8_e4m3fn if meta.channel_scale_mode == 2 else torch.bfloat16
    K = meta.in_features
    if not (x.is_cuda and x.dtype == want and tuple(x.shape) == (M, K)):
        raise ValueError(f"x: want a CUDA (M, {K}) {want} tensor, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    return _aligned(x), (3 if want == torch.float8_e4m3fn else DType.BF16.value)


def _sx(scales_x, meta, M: int):
    if meta.channel_scale_mode != 2:
        return None
    if scales_x is None or scales_x.numel() != M:
        raise ValueError(f"scales_x: want {M} per-token scales")
    return scales_x.to(torch.float32).contiguous()


def _split(owner: str, floats: int, ints: int, device, stream):
    if not floats:
        return None, None
    ibuf, fbuf = build.split_state(owner, device, ints, floats, stream)
    return fbuf.data_ptr(), ibuf.data_ptr()


def _decode(x, W_q, scales, scales_x, meta, layer_idx=None, layers=None):
    M = x.shape[0]
    N, K = meta.out_features, meta.in_features
    _check(meta, M, "decode")
    x, x_code = _x(x, meta, M)
    W_q, s = _weights(W_q, scales, meta, layers)
    sx = _sx(scales_x, meta, M)
    p = decode_plan(M, N, K, w_kind(meta), 2 if x_code == DType.BF16.value else 1)
    stream = torch.cuda.current_stream().cuda_stream
    part, cnt = _split("mx_decode", p.splits * M * N if p.splits > 1 else 0, p.tiles, x.device,
                       stream)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    tail = (x_code, w_kind(meta), p.splits, p.k_per_split, p.stages, stream)
    sx_ptr = None if sx is None else sx.data_ptr()
    if layer_idx is None:
        err = _fn("gl_mx_decode", 7, 8)(x.data_ptr(), W_q.data_ptr(), s.data_ptr(), sx_ptr, part,
                                        cnt, out.data_ptr(), M, N, K, *tail)
    else:
        err = _fn("gl_mx_decode_stacked", 8, 9)(x.data_ptr(), W_q.data_ptr(), s.data_ptr(), sx_ptr,
                                                layer_idx.data_ptr(), part, cnt, out.data_ptr(),
                                                layers, M, N, K, *tail)
    build.check(err, "mx_gemm (decode)")
    return out


def mx_decode(x: torch.Tensor, W_q, scales, scales_x, meta) -> torch.Tensor:
    """out (M, N) bf16 = x (M, K) @ W, times the per-token scales (csm 2), for
    M <= 64 and an e8m0 MX layer."""
    if x.device.type == "cpu":
        return mx_forward_ref(x, W_q, scales, None, scales_x, meta)
    out = _decode(x, W_q, scales, scales_x, meta)
    mx_decode.launches += 1
    return out


mx_decode.launches = 0


def mx_decode_stacked(x: torch.Tensor, W_q, scales, meta, layer_idx) -> torch.Tensor:
    """Layer ``layer_idx`` of the stacks ``W_q`` (L, K / epw, N) and ``scales``
    (L, K / 32, N) for M <= 64, bf16 x (the stacked path carries no
    per-token scales). ``layer_idx``: a one-element int32 tensor on the card
    (an int on the CPU too), never read by the host on the card."""
    if x.device.type == "cpu":
        li = int(layer_idx)
        return mx_forward_ref(x, W_q[li], scales[li], None, None, meta)
    if meta.channel_scale_mode != 0:
        raise NotImplementedError("the stacked path takes bf16 x only (csm 0)")
    if not (isinstance(layer_idx, torch.Tensor) and layer_idx.device == x.device
            and layer_idx.dtype == torch.int32 and layer_idx.numel() == 1):
        raise ValueError("layer_idx: want a one-element int32 tensor on the card, got "
                         f"{layer_idx!r}")
    out = _decode(x, W_q, scales, None, meta, layer_idx, W_q.shape[0])
    mx_decode_stacked.launches += 1
    return out


mx_decode_stacked.launches = 0


def _prefill(x, x_scales, W_q, scales, scales_x, meta, route: str):
    M = x.shape[0]
    N, K = meta.out_features, meta.in_features
    _check(meta, M, route)
    W_q, s = _weights(W_q, scales, meta)
    ags = 0
    if route == "prefill_csm4":
        ags = 16 if _nvfp4(meta) else 32
        if not (x.is_cuda and x.dtype == torch.float8_e4m3fn and tuple(x.shape) == (M, K)):
            raise ValueError(f"codes: want a CUDA (M, {K}) float8_e4m3fn tensor, got {x.dtype} "
                             f"{tuple(x.shape)}")
        if not (x_scales.is_cuda and x_scales.dtype == torch.float32
                and tuple(x_scales.shape) == (M, K // ags)):
            raise ValueError(f"group scales: want a CUDA ({M}, {K // ags}) float32 tensor")
        x, x_code, xs, sx = _aligned(x), 3, _aligned(x_scales), None
    else:
        x, x_code = _x(x, meta, M)
        xs, sx = None, _sx(scales_x, meta, M)
    p = prefill_plan(M, N, K, w_kind(meta), x_codes=x_code == 3)
    stream = torch.cuda.current_stream().cuda_stream
    part, cnt = _split("mx_prefill", p.splits * M * N if p.splits > 1 else 0,
                       p.tiles_n * p.tiles_m, x.device, stream)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    err = _fn("gl_mx_prefill", 8, 11)(
        x.data_ptr(), None if xs is None else xs.data_ptr(), W_q.data_ptr(), s.data_ptr(),
        None if sx is None else sx.data_ptr(), part, cnt, out.data_ptr(), M, N, K, x_code, ags,
        w_kind(meta), meta.group_size, p.bm, p.splits, p.k_per_split, p.stages, stream)
    build.check(err, f"mx_gemm ({route})")
    return out


def mx_prefill(x: torch.Tensor, W_q, scales, scales_x, meta, x_codes=None) -> torch.Tensor:
    """out (M, N) bf16 = x (M, K) @ W, times the per-token scales (csm 2), for
    M < 4096. ``x_codes``: the micro-scaled form of x, (e4m3 codes (M, K),
    float32 group scales (M, K / ags)) from ``quant.scale_activations_mx``,
    for a csm-4 layer (``mx_prefill_csm4``); x is then not read."""
    if x_codes is not None:
        return mx_prefill_csm4(*x_codes, W_q, scales, meta)
    if x.device.type == "cpu":
        return mx_forward_ref(x, W_q, scales, None, scales_x, meta)
    out = _prefill(x, None, W_q, scales, scales_x, meta, "prefill")
    mx_prefill.launches += 1
    return out


mx_prefill.launches = 0


def mx_prefill_csm4(codes: torch.Tensor, group_scales: torch.Tensor, W_q, scales,
                    meta) -> torch.Tensor:
    """The csm-4 form: x as e4m3 codes (M, K) and float32 group scales (M, K /
    ags); each code times its scale, rounded once to bf16, is
    ``fake_quant_activations(x)``, so the result equals the bf16 form fed
    that bit for bit."""
    if codes.device.type == "cpu":
        ags = codes.shape[1] // group_scales.shape[1]
        x = (codes.to(torch.float32) * torch.repeat_interleave(group_scales, ags, dim=1)).to(
            to_torch_dtype(meta.output_dtype))
        return mx_forward_ref(x, W_q, scales, None, None, meta._replace(channel_scale_mode=0))
    out = _prefill(codes, group_scales, W_q, scales, None, meta, "prefill_csm4")
    mx_prefill_csm4.launches += 1
    return out


mx_prefill_csm4.launches = 0


def mx_general(x: torch.Tensor, W_q, scales, scales_x, meta) -> torch.Tensor:
    """out (M, N) bf16 = x (M, K) @ W, times the per-token scales (csm 2), for
    M < 4096 and an fp4 layer of any N and K: the layers JAX does not fold,
    on the body ``general_plan`` picks. x is bf16, or e4m3 per token for csm
    2; micro-scaled x (csm 4) arrives fake-quantized with csm 0, as the router
    hands it over."""
    if x.device.type == "cpu":
        return mx_forward_ref(x, W_q, scales, None, scales_x, meta)
    M = x.shape[0]
    N, K = meta.out_features, meta.in_features
    _check(meta, M, "general")
    x, x_code = _x(x, meta, M)
    W_q, s = _weights(W_q, scales, meta)
    sx = _sx(scales_x, meta, M)
    nvfp4 = _nvfp4(meta)
    p = general_plan(M, N, K, nvfp4)
    stream = torch.cuda.current_stream().cuda_stream
    part, cnt = _split("mx_general", p.splits * M * p.tiles_n * TILE if p.splits > 1 else 0,
                       p.tiles_n * p.tiles_m, x.device, stream)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    err = _fn("gl_mx_general", 7, 9)(
        x.data_ptr(), W_q.data_ptr(), s.data_ptr(), None if sx is None else sx.data_ptr(), part,
        cnt, out.data_ptr(), M, N, K, x_code, int(nvfp4), p.bm, p.splits, p.k_per_split,
        p.stages, stream)
    build.check(err, "mx_gemm (general)")
    mx_general.launches += 1
    return out


mx_general.launches = 0
