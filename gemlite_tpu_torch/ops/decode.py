# SPDX-License-Identifier: Apache-2.0
"""Decode kernels: W1/W2/W4 x bf16 or e4m3 for M <= 64 on the bf16 tensor
cores, one launch a call (``csrc/decode_gemv.cu``, entry ``gl_decode``;
``csrc/decode_modes.cu``, entry ``gl_decode_modes``).

Replaces ``gemlite_tpu/ops/pallas_decode.py:pallas_decode_matmul`` on the
mode-4 bf16 layers that ``A16Wn_HQQ_INT(dtype=bf16)`` makes
(``decode_matmul``) and, in its mode 1-3 form (``decode_modes``), on the
layers in W_group_mode 1-3 that the JAX router sends to that kernel:
``A8Wn_HQQ_INT_dynamic`` (e4m3 x read as codes; e5m2 x as its exact bf16
image), channel-wise ``A16Wn`` and ``A16W158_INT``. The mode 1-3 form runs
the TMA kernel of ``decode_modes.cu`` on ``modes_plan`` where ``modes_tma``
holds, and elsewhere (N not a multiple of 8, a base not 16-byte aligned)
``decode_modes_ragged``, the mode 1-3 instances of ``decode_gemv.cu`` on
``ragged_modes_plan``, counted apart. The plain version of the mode-4 entry
is ``ops/reference.forward_meta``, of the mode 1-3 form
``reference.forward_f32_epilogue`` (forward_meta with its channel scales in
float32, as the kernels and the JAX kernel apply them). On a CPU tensor a
wrapper runs its plain version; on a CUDA tensor it launches a kernel or
raises. The stacked entries over (L, ...) weights are ``ops/scan.py``; all
take their grid from ``plan`` or ``modes_plan``, which own the kernels'
grids and rings: the CUDA side only checks that what it is given fits.
"""

import ctypes
import math
from typing import NamedTuple

import torch

from . import build, w4
from .reference import forward_f32_epilogue, forward_meta

__all__ = ["DECODE_BITS", "DecodePlan", "ModesPlan", "can_use_decode", "can_use_decode_modes",
           "decode_matmul", "decode_matmul_plain", "decode_modes", "decode_modes_plain",
           "decode_modes_ragged", "modes_plan", "modes_smem", "modes_tma", "modes_workspace",
           "modes_x", "plan", "ragged_call", "ragged_modes_plan", "split_buffers", "tma_call",
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
# the mode 1-3 TMA kernel (csrc/decode_modes.cu)
MODES_BLOCKS = 3           # blocks an SM (the kernel's launch bounds, kBlocks)
MODES_RESIDENT = MODES_BLOCKS * SMS
MODES_BUDGET = 72 * 1024   # one block's ring and metadata slots: three blocks an SM
MODES_MAX_STAGES = 8
MODES_MAX_META_ROWS = 32


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


def _fn(source: str, name: str, pointers: int, ints: int):
    fn = getattr(build.load(source), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


class ModesPlan(NamedTuple):
    """The mode 1-3 TMA kernel's grid for one call: ``tiles`` blocks of 128
    output columns (the last may hang past N), each summing all M rows over
    ``splits`` K ranges of ``k_per_split`` (the last may be shorter and end
    inside a stage), in one launch; a ring of ``stages`` 128-deep stages
    with ``mrows`` group rows of scales and zeros each, or with ``once`` one
    row loaded once a block (gs = K); ``smem`` bytes of shared memory."""
    tiles: int
    splits: int
    k_per_split: int
    stages: int
    mrows: int
    once: bool
    smem: int

    @property
    def tile(self) -> int:
        return TILE

    @property
    def launches(self) -> int:
        return 1


def modes_smem(bits: int, x_bytes: int, M: int, stages: int, mrows: int, once: bool) -> int:
    """Shared memory of a block of the TMA kernel (its ``Layout``): a ring of
    stages, each the rows of x (M rounded up to 8) of 128 k and the word box;
    the metadata slots (``mrows`` rows of 128 scales and of 128 zeros; one a
    stage, or one); the float32 epilogue tile over them; 1024 bytes of slack
    to align the base."""
    rows = -(-M // 8) * 8
    ring = stages * (rows * BK * x_bytes + BK * bits // 32 * TILE * 4)
    ring += (1 if once else stages) * 2 * mrows * TILE * 2
    return max(ring, rows * TILE * 4) + 1024


def modes_plan(M: int, meta, x_bytes: int = 2) -> ModesPlan:
    """The TMA kernel's grid for a mode 1-3 layer at M rows of x of
    ``x_bytes`` (2: bf16, 1: e4m3). K is cut in 128-deep stages, a whole
    number of groups a split (lcm(gs, 128) deep, or any stage for a
    channel-wise layer, gs = K, whose one row serves every k) and at least
    two stages a split, into the most splits that keep the grid within whole
    waves of ``MODES_RESIDENT`` blocks (one wave wherever the column tiles
    fit it). The split depends on N, K and gs only, never on M or the form
    of x, so a row's sum runs in the same order at any batch and for either
    form, and the stacked entry equals the per-layer one. The ring is the
    deepest that fits ``MODES_BUDGET`` (three blocks an SM), at least two
    stages, and at most half the block's stages (so the prologue is a small
    share of its life) or, for a block of two or three stages, all of
    them."""
    N, K, gs, bits = meta.out_features, meta.in_features, meta.group_size, meta.W_nbits
    once = gs == K
    tiles, steps = -(-N // TILE), -(-K // BK)
    unit = 1 if once else math.lcm(gs, BK) // BK          # stages a group boundary recurs
    units = -(-steps // unit)
    least = -(-2 // unit)                                 # units of two stages
    waves = -(-tiles // MODES_RESIDENT)
    splits = max(1, min(units // least, waves * MODES_RESIDENT // tiles))
    per = -(-units // splits)
    stages_per = per * unit
    mrows = 1 if once else groups_per_stage(gs)
    most = stages_per // 2 if stages_per >= 4 else stages_per
    fit = max(s for s in range(1, MODES_MAX_STAGES + 1)
              if s == 1 or modes_smem(bits, x_bytes, M, s, mrows, once) - 1024 <= MODES_BUDGET)
    stages = max(2, min(MODES_MAX_STAGES, fit, most))
    return ModesPlan(tiles, -(-units // per), stages_per * BK, stages, mrows, once,
                     modes_smem(bits, x_bytes, M, stages, mrows, once))


def ragged_modes_plan(M: int, meta) -> DecodePlan:
    """``plan`` for a mode 1-3 layer on the ragged route (``decode_gemv.cu``'s
    M3 instances): channel-wise layers as one group."""
    K, gs = meta.in_features, meta.group_size
    return plan(M, meta.out_features, K, gs, meta.W_nbits, one_group=gs == K)


def modes_workspace(M: int, N: int, p: ModesPlan):
    """(float32 partials, int32 arrival counters) of a TMA call, as ``workspace``."""
    return (0, 0) if p.splits == 1 else (p.splits * M * N, p.tiles)


def modes_tma(N: int, bits: int, *operands) -> bool:
    """True when the TMA kernel takes a call: N a multiple of 8 (of 32 for W1
    codes, whose 512-byte word boxes TMA lands in the 128-byte swizzle only
    as one 3-d box) and every operand (None aside) 16-byte aligned."""
    return (N % (32 if bits == 1 else 8) == 0
            and all(t is None or t.data_ptr() % 16 == 0 for t in operands))


def modes_x(x: torch.Tensor, K: int):
    """x as the TMA kernel reads it -> (x, x_code): bf16 (2) or e4m3 codes
    (3, K a multiple of 16), contiguous with 16-byte aligned rows; other fp8
    x (e5m2), and e4m3 x with K off 16, as its exact bf16 image."""
    if not x.is_cuda or x.ndim != 2 or x.shape[1] != K:
        raise ValueError(f"x: want a CUDA (M, {K}) tensor, got {x.dtype} {tuple(x.shape)} "
                         f"on {x.device}")
    if x.dtype == torch.float8_e4m3fn and K % 16 == 0:
        x = x.contiguous()
        return (x.clone() if x.data_ptr() % 16 else x), 3
    if x.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        x = x.to(torch.bfloat16)
    return w4.activations(x, K), 2


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
    err = _fn("decode_gemv", "gl_decode", 7, 9)(
        x.data_ptr(), W_q.data_ptr(), scales.data_ptr(), zeros.data_ptr(), part, cnt,
        out.data_ptr(), M, N, K, gs, meta.W_nbits, p.splits, p.k_per_split, p.stages, p.mrows,
        stream)
    build.check(err, "decode_gemv")
    decode_matmul.launches += 1
    return out


decode_matmul.launches = 0


def decode_modes(x: torch.Tensor, W_q, scales, zeros, scales_x, meta) -> torch.Tensor:
    """out (M, N) bf16 = csm(x (M, K) @ dequant(W_q)) for M <= 64 on a layer
    in W_group_mode 1-3 (``w4.serves_modes``); x bf16 or fp8 (``modes_x``).
    The TMA kernel runs ``modes_plan`` where ``modes_tma`` holds; elsewhere
    ``decode_modes_ragged`` runs."""
    if x.device.type == "cpu":
        return decode_modes_plain(x, W_q, scales, zeros, scales_x, meta)
    M = x.shape[0]
    if not can_use_decode_modes(meta, M):
        raise NotImplementedError(f"decode kernel does not take M={M} with {meta}")
    N, K = meta.out_features, meta.in_features
    x, x_code = modes_x(x, K)
    operands = w4.modes_operands(W_q, scales, zeros, scales_x, meta, M)
    s, z, zs, sx, cs = operands
    stream = w4.stream()
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if not modes_tma(N, meta.W_nbits, x, W_q, s, z):
        return decode_modes_ragged(x if x_code == 2 else x.to(torch.bfloat16), W_q, operands, out,
                                   meta, stream)
    tma_call(_fn("decode_modes", "gl_decode_modes", 10, 12), x, x_code, W_q, operands, out, meta,
             stream)
    decode_modes.launches += 1
    return out


def tma_call(fn, x, x_code, W_q, operands, out, meta, stream, layer_idx=None) -> None:
    """One launch of ``fn`` (``gl_decode_modes``, or an entry of its
    signature built from another source; with ``layer_idx``, a 0-d int32
    tensor on the card, ``gl_decode_modes_stacked`` on layer ``layer_idx``
    of the (L, ...) stacks) on ``modes_plan``'s grid: x as ``modes_x``
    gives it, ``operands`` as ``w4.modes_operands`` does."""
    M, K = x.shape
    N = meta.out_features
    s, z, zs, sx, cs = operands
    p = modes_plan(M, meta, 2 if x_code == 2 else 1)
    floats, ints = modes_workspace(M, N, p)
    part = cnt = None
    if floats:
        cnt, part = build.split_state("decode_modes", x.device, ints, floats, stream)
    ptr = w4.pointer
    tail = (M, N, K, meta.group_size, meta.W_nbits, x_code, p.splits, p.k_per_split, p.stages,
            p.mrows, meta.channel_scale_mode, w4.scale_code(cs), stream)
    if layer_idx is None:
        err = fn(x.data_ptr(), W_q.data_ptr(), ptr(s), ptr(z), ptr(zs), ptr(sx), ptr(cs),
                 ptr(part), ptr(cnt), out.data_ptr(), *tail)
    else:
        err = fn(x.data_ptr(), W_q.data_ptr(), ptr(s), ptr(z), ptr(cs), layer_idx.data_ptr(),
                 ptr(part), ptr(cnt), out.data_ptr(), W_q.shape[0], *tail)
    build.check(err, "decode_modes" if layer_idx is None else "decode_modes (stacked)")


def ragged_call(x, W_q, operands, out, meta, stream, layer_idx=None) -> None:
    """One launch of ``decode_gemv.cu``'s mode 1-3 instances on
    ``ragged_modes_plan``: ``gl_decode_modes_ragged``, or with ``layer_idx``
    (as ``tma_call``) ``gl_decode_modes_ragged_stacked``; x bf16."""
    M, K = x.shape
    N = meta.out_features
    s, z, zs, sx, cs = operands
    p = ragged_modes_plan(M, meta)
    part, cnt = split_buffers(M, N, p, x.device, stream)
    ptr = w4.pointer
    tail = (M, N, K, meta.group_size, meta.W_nbits, p.splits, p.k_per_split, p.stages, p.mrows,
            meta.channel_scale_mode, w4.scale_code(cs), stream)
    if layer_idx is None:
        err = _fn("decode_gemv", "gl_decode_modes_ragged", 10, 11)(
            x.data_ptr(), W_q.data_ptr(), ptr(s), ptr(z), ptr(zs), ptr(sx), ptr(cs), part, cnt,
            out.data_ptr(), *tail)
    else:
        err = _fn("decode_gemv", "gl_decode_modes_ragged_stacked", 9, 12)(
            x.data_ptr(), W_q.data_ptr(), ptr(s), ptr(z), ptr(cs), layer_idx.data_ptr(), part,
            cnt, out.data_ptr(), W_q.shape[0], *tail)
    build.check(err, "decode_gemv (ragged modes)" if layer_idx is None
                else "decode_gemv (stacked ragged modes)")


def decode_modes_ragged(x, W_q, operands, out, meta, stream) -> torch.Tensor:
    """decode_modes' kernel for the layers whose words or metadata TMA cannot
    read (``modes_tma``: N not a multiple of 8, W1 with N not a multiple of
    32, or a base not 16-byte aligned), as JAX's
    decode kernel takes any N: ``gl_decode_modes_ragged``, the mode 1-3
    instances of ``decode_gemv.cu``, on ``ragged_modes_plan``; x bf16.
    ``operands`` are ``w4.modes_operands``; writes ``out`` and returns it."""
    ragged_call(w4.activations(x, x.shape[1]), W_q, operands, out, meta, stream)
    decode_modes_ragged.launches += 1
    return out


decode_modes_ragged.launches = 0
decode_modes.launches = 0
