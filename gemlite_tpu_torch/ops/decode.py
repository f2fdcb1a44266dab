# SPDX-License-Identifier: Apache-2.0
"""Decode kernel: W1/W2/W4 x bf16 for M <= 64 on the bf16 tensor cores, one
launch a call (``csrc/decode_gemv.cu``, entries ``gl_decode`` and
``gl_decode_modes``).

Replaces ``gemlite_tpu/ops/pallas_decode.py:pallas_decode_matmul`` on the
mode-4 bf16 layers that ``A16Wn_HQQ_INT(dtype=bf16)`` makes
(``decode_matmul``) and, in its mode 1-3 form (``decode_modes``), on the
layers in W_group_mode 1-3 that the JAX router sends to that kernel:
``A8Wn_HQQ_INT_dynamic`` (fp8 x, as its exact bf16 image), channel-wise
``A16Wn`` and ``A16W158_INT``. The plain version of the mode-4 entry is
``ops/reference.forward_meta``, of the mode 1-3 form
``reference.forward_f32_epilogue`` (forward_meta with its channel scales in
float32, as the kernel and the JAX kernel apply them). On a CPU tensor a
wrapper runs its plain version; on a CUDA tensor it launches the kernel or
raises. The stacked entry over (L, ...) mode-4 weights is ``ops/scan.py``;
all take their grid from ``plan``, which owns the kernel's grid and ring:
the CUDA side only checks that what it is given fits.
"""

import ctypes
import math
from typing import NamedTuple

import torch

from . import build, w4
from .reference import forward_f32_epilogue, forward_meta

__all__ = ["DECODE_BITS", "DecodePlan", "can_use_decode", "can_use_decode_modes", "decode_matmul",
           "decode_matmul_plain", "decode_modes", "decode_modes_plain", "plan", "split_buffers",
           "workspace"]

MAX_M = 64
DECODE_BITS = (1, 2, 4)
BK = 128                   # the kernel's K per ring stage
SMS = 132                  # H100 SXM streaming multiprocessors
TARGET_BLOCKS = 4 * SMS    # about four blocks an SM: warps to hide the dequantization's latency
TILE = 128                 # the kernel's output columns per block
MAX_STAGES = 6
SMEM_BUDGET = 54 * 1024    # one block's ring: four blocks an SM
SMEM_MAX = 112 * 1024      # the most a launch may take (the kernel's kSmemMax)
MIN_SPLIT_K = 2 * BK       # K of a split at the least (with the group: lcm(gs, this))


def can_use_decode(meta, M: int) -> bool:
    return 0 < M <= MAX_M and w4.serves(meta, bits=DECODE_BITS)


def can_use_decode_modes(meta, M: int) -> bool:
    return 0 < M <= MAX_M and w4.serves_modes(meta, bits=DECODE_BITS)


class DecodePlan(NamedTuple):
    """The kernel's grid for one call: ``tiles`` blocks of ``tile`` output
    columns, each summing all M rows over ``splits`` K ranges of
    ``k_per_split`` (the last may be shorter), in one launch; a ring of
    ``stages`` 128-deep stages, each holding ``mrows`` group rows of scales
    and zeros; ``smem`` bytes of shared memory."""
    tiles: int
    splits: int
    k_per_split: int
    stages: int
    mrows: int
    smem: int

    @property
    def tile(self) -> int:
        return TILE

    @property
    def launches(self) -> int:
        return 1


def _row_tiles(M: int) -> int:
    """The n8 tiles of rows the kernel instance holds (its NT): 1, 2, 4 or 8."""
    return next(nt for nt in (1, 2, 4, 8) if M <= 8 * nt)


def groups_per_stage(gs: int) -> int:
    """Group rows that one 128-deep stage can touch (the kernel checks the
    plan's ``mrows`` against the same count)."""
    if gs % BK == 0:
        return 1
    return BK // gs if BK % gs == 0 else BK // gs + 2


def plan(M: int, N: int, K: int, gs: int, bits: int, one_group: bool = False) -> DecodePlan:
    """Tiles, K split and ring, from the shape. K is cut in whole units of
    lcm(gs, 256) (two stages at least, which keeps the last block's sum of
    partials short) so that about ``TARGET_BLOCKS`` blocks run at once, all
    in one wave. The split depends on N, K and gs only, never on M, so a
    row's sum runs in the same order at any batch and the stacked entry
    equals the per-layer entry. ``one_group``: a channel-wise layer of the
    mode 1-3 form (gs = K), whose one metadata row serves every k: its units
    are 256 deep and a stage holds that one row (JAX's ``_effective_gs``
    takes such a layer as one group a k-step too)."""
    tiles = -(-N // TILE)
    unit = MIN_SPLIT_K if one_group else math.lcm(gs, MIN_SPLIT_K)
    units = -(-K // unit)
    splits = max(1, min(units, -(-TARGET_BLOCKS // tiles)))
    per = -(-units // splits)
    splits = -(-units // per)
    mrows = 1 if one_group else groups_per_stage(gs)
    # a stage: the words, the x chunk of every n8 tile of rows, scale and zero rows
    stage = BK * bits // 32 * TILE * 4 + _row_tiles(M) * 8 * BK * 2 + 2 * mrows * TILE * 2
    stages = max(2, min(MAX_STAGES, SMEM_BUDGET // stage))   # small groups at M > 32: over budget
    smem = max(stages * stage, M * TILE * 4)                   # the ring, then the output tile
    return DecodePlan(tiles, splits, min(K, per * unit), stages, mrows, smem)


def workspace(M: int, N: int, p: DecodePlan):
    """(float32 partials, int32 arrival counters) that a call needs: a split
    call writes each split's (M, N) sums and counts arrivals per column
    tile. The counters are 0 between calls."""
    if p.splits == 1:
        return 0, 0
    return p.splits * M * N, p.tiles


def decode_matmul_plain(x, W_q, scales, zeros, meta):
    return forward_meta(x, W_q, scales, zeros, None, meta)


def decode_modes_plain(x, W_q, scales, zeros, scales_x, meta):
    return forward_f32_epilogue(x, W_q, scales, zeros, scales_x, meta)


def _lib():
    fn = build.load("decode_gemv").gl_decode
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _lib_modes():
    fn = build.load("decode_gemv").gl_decode_modes
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def modes_plan(M: int, meta) -> DecodePlan:
    """``plan`` for a mode 1-3 layer: channel-wise layers as one group."""
    K, gs = meta.in_features, meta.group_size
    return plan(M, meta.out_features, K, gs, meta.W_nbits, one_group=gs == K)


def split_buffers(M: int, N: int, p: DecodePlan, device, stream: int):
    """(partials, counters) pointers of a call on ``stream`` from the split
    state the two entries share (per device and stream), or (None, None)
    with one split."""
    floats, ints = workspace(M, N, p)
    if not floats:
        return None, None
    ibuf, fbuf = build.split_state("decode_gemv", device, ints, floats, stream)
    return fbuf.data_ptr(), ibuf.data_ptr()


def decode_matmul(x: torch.Tensor, W_q, scales, zeros, meta) -> torch.Tensor:
    """out (M, N) bf16 = x (M, K) @ dequant(W_q) for M <= 64."""
    if x.device.type == "cpu":
        return decode_matmul_plain(x, W_q, scales, zeros, meta)
    M = x.shape[0]
    if not can_use_decode(meta, M):
        raise NotImplementedError(f"decode kernel does not take M={M} with {meta}")
    N, K, gs = meta.out_features, meta.in_features, meta.group_size
    x = w4.activations(x, K)
    w4.check_operands(W_q, scales, zeros, meta)
    p = plan(M, N, K, gs, meta.W_nbits)
    stream = w4.stream()
    part, cnt = split_buffers(M, N, p, x.device, stream)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    err = _lib()(x.data_ptr(), W_q.data_ptr(), scales.data_ptr(), zeros.data_ptr(), part, cnt,
                 out.data_ptr(), M, N, K, gs, meta.W_nbits, p.splits, p.k_per_split, p.stages,
                 p.mrows, stream)
    build.check(err, "decode_gemv")
    decode_matmul.launches += 1
    return out


decode_matmul.launches = 0


def decode_modes(x: torch.Tensor, W_q, scales, zeros, scales_x, meta) -> torch.Tensor:
    """out (M, N) bf16 = csm(x (M, K) @ dequant(W_q)) for M <= 64 on a layer
    in W_group_mode 1-3 (``w4.serves_modes``); x in bf16 (on the CPU also
    fp8, which the plain version reads exactly)."""
    if x.device.type == "cpu":
        return decode_modes_plain(x, W_q, scales, zeros, scales_x, meta)
    M = x.shape[0]
    if not can_use_decode_modes(meta, M):
        raise NotImplementedError(f"decode kernel does not take M={M} with {meta}")
    N, K = meta.out_features, meta.in_features
    x = w4.activations(x, K)
    s, z, zs, sx, cs = w4.modes_operands(W_q, scales, zeros, scales_x, meta, M)
    p = modes_plan(M, meta)
    stream = w4.stream()
    part, cnt = split_buffers(M, N, p, x.device, stream)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    ptr = w4.pointer
    err = _lib_modes()(x.data_ptr(), W_q.data_ptr(), ptr(s), ptr(z), ptr(zs), ptr(sx), ptr(cs),
                       part, cnt, out.data_ptr(), M, N, K, meta.group_size, meta.W_nbits,
                       p.splits, p.k_per_split, p.stages, p.mrows, meta.channel_scale_mode,
                       w4.scale_code(cs), stream)
    build.check(err, "decode_gemv")
    decode_modes.launches += 1
    return out


decode_modes.launches = 0
