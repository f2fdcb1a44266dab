# SPDX-License-Identifier: Apache-2.0
"""Prefill kernel: W1/W2/W4 x bf16 for 64 < M < 4096 on Hopper's ``wgmma``,
one launch a call (``csrc/prefill_gemm.cu``, entries ``gl_prefill`` and
``gl_prefill_modes``; ``csrc/prefill_modes.cu``, entry
``gl_prefill_modes_persistent``).

Replaces ``gemlite_tpu/ops/pallas_prefill.py:pallas_prefill_matmul`` on the
bf16 layers of W1, W2 and W4 codes that the JAX router sends to its prefill
kernel: mode 4 (``prefill_matmul``) and, in the mode 1-3 form
(``prefill_modes``, the layers of ``w4.serves_modes``), A8Wn, channel-wise
A16W158. The mode 1-3 form runs the persistent kernel of
``prefill_modes.cu`` on ``modes_plan`` where ``persistent`` holds (words
and metadata by TMA), and elsewhere (N not a multiple of 8, or a base not
16-byte aligned) ``prefill_modes_ragged``, the mode 1-3 instances of
``prefill_gemm.cu`` on ``plan``, counted apart. The plain versions
are ``ops/reference.forward_meta`` and, for the mode 1-3 form,
``reference.forward_f32_epilogue``. On a CPU tensor a wrapper runs its plain
version; on a CUDA tensor it launches a kernel or raises. ``plan`` and
``modes_plan`` own the kernels' grids and rings: the CUDA side only checks
that what it is given fits.
"""

import ctypes
from typing import NamedTuple

import torch

from . import build, w4
from .reference import forward_f32_epilogue, forward_meta

__all__ = ["PREFILL_BITS", "ModesPlan", "PrefillPlan", "can_use_prefill", "can_use_prefill_modes",
           "modes_plan", "modes_smem_bytes", "modes_workspace", "plan",
           "prefill_matmul", "prefill_matmul_plain", "prefill_modes", "prefill_modes_plain",
           "prefill_modes_ragged",
           "smem_bytes", "workspace"]

PREFILL_BITS = (1, 2, 4)
BK = 64                    # the kernel's K per ring stage; a stage never straddles a group
TILE = 128                 # weight columns per block: two consumer warpgroups of 64
SMS = 132                  # H100 SXM streaming multiprocessors; one block each
MAX_STAGES = 5             # ring depth (the kernel takes 2-6)
SMEM_MAX = 227 * 1024      # the most shared memory a block may take (the kernel's kSmemMax)
# The split cost model (microseconds, H100): a 64-deep stage of BM rows on
# the tensor cores, a block's fixed cost (ring fill, epilogue), the rate at
# which the last block of a tile reads the partials, and the rate at which
# all partials are written and read back.
STAGE_US = {128: 0.40, 256: 0.80}
BLOCK_US = 2.0
MERGE_BYTES_PER_US = 1.0e5
PARTIAL_BYTES_PER_US = 3.0e6


def can_use_prefill(meta, M: int) -> bool:
    return 64 < M < 4096 and w4.serves(meta, min_group=BK, bits=PREFILL_BITS)


def can_use_prefill_modes(meta, M: int) -> bool:
    return 64 < M < 4096 and w4.serves_modes(meta, min_group=BK, bits=PREFILL_BITS)


class PrefillPlan(NamedTuple):
    """The kernel's grid for one call: ``tiles_n`` blocks of 128 weight
    columns by ``tiles_m`` blocks of ``bm`` rows of x, each summing
    ``splits`` K ranges of ``k_per_split`` (the last may be shorter), in one
    launch; a ring of ``stages`` 64-deep stages, each holding one group row
    of scales and zeros; ``smem`` bytes of shared memory."""
    bm: int
    tiles_n: int
    tiles_m: int
    splits: int
    k_per_split: int
    stages: int
    smem: int

    @property
    def tile(self) -> int:
        return TILE

    @property
    def mrows(self) -> int:
        """Group rows a stage holds: one, since gs is a multiple of 64."""
        return 1

    @property
    def blocks(self) -> int:
        return self.tiles_n * self.tiles_m * self.splits

    @property
    def launches(self) -> int:
        return 1


def row_tile(M: int) -> int:
    """Rows of x a block takes: one n128 product up to M 128, two above."""
    return 128 if M <= 128 else 256


def smem_bytes(bm: int, bits: int, stages: int) -> int:
    """Shared memory of a block (the kernel's Layout): the ring of x boxes,
    word rows and a scale and a zero row; the float32 epilogue tile (rows of
    128 + 4 floats) over it; the mbarriers, the flag and 1024 bytes of slack
    to align the base."""
    stage = bm * BK * 2 + BK * bits // 32 * TILE * 4 + 2 * TILE * 2
    return max(stages * stage, bm * (TILE + 4) * 4) + 16 * stages + 16 + 1024


def estimate_us(M: int, N: int, tiles: int, steps: int, splits: int, bm: int) -> float:
    """The split cost model: whole waves of one block an SM, each block
    ``ceil(steps / splits)`` stages and its fixed cost; with a split, each
    block's partial write, the last block's read of every partial of its
    tile, and all partials through memory."""
    per = -(-steps // splits)
    waves = -(-tiles * splits // SMS)
    tile_bytes = bm * TILE * 4
    t = waves * (per * STAGE_US[bm] + BLOCK_US)
    if splits > 1:
        t += waves * tile_bytes / MERGE_BYTES_PER_US
        t += splits * tile_bytes / MERGE_BYTES_PER_US
        t += 2 * splits * M * N * 4 / PARTIAL_BYTES_PER_US
    return t


def plan(M: int, N: int, K: int, gs: int, bits: int) -> PrefillPlan:
    """Row tile, K split and ring, from the shape. The split is the one of
    least ``estimate_us`` over whole 64-deep stages a split (ties go to
    fewer splits); it depends on M's tiles, never on the data."""
    bm = row_tile(M)
    tiles_n, tiles_m = -(-N // TILE), -(-M // bm)
    steps = K // BK
    best = None
    for s in range(1, steps + 1):
        per = -(-steps // s)
        if -(-steps // per) != s:               # the same ranges as fewer splits
            continue
        t = estimate_us(M, N, tiles_n * tiles_m, steps, s, bm)
        if best is None or t < best[0]:
            best = (t, s, per)
    _, splits, per = best
    stages = max(s for s in range(2, MAX_STAGES + 1) if smem_bytes(bm, bits, s) <= SMEM_MAX)
    return PrefillPlan(bm, tiles_n, tiles_m, splits, per * BK, stages,
                       smem_bytes(bm, bits, stages))


def workspace(M: int, N: int, p: PrefillPlan):
    """(float32 partials, int32 arrival counters) that a call needs: a split
    call writes each split's (M, N) sums and counts arrivals per output
    tile. The counters are 0 between calls."""
    if p.splits == 1:
        return 0, 0
    return p.splits * M * N, p.tiles_n * p.tiles_m


MODES_META_ROWS = 8        # group rows of a metadata chunk (the kernel's kMetaRows)
MODES_MAX_STAGES = 8       # the persistent kernel's most stages (kMaxStages)
MODES_STAGE_STEPS = 2      # 64-deep steps a stage (the kernel's SUB)


class ModesPlan(NamedTuple):
    """The persistent mode 1-3 kernel's work for one call: ``tiles_n`` x
    ``tiles_m`` output tiles of 128 weight columns by ``bm`` rows of x, in
    column-major order of their row tiles; the first ``full`` summed whole,
    each of the rest cut into ``splits`` K ranges of ``k_per_split``; ``grid``
    blocks, one an SM at most, block b taking units b, b + grid, ...; a ring
    of ``stages`` stages of 128 k; ``smem`` bytes of shared memory."""
    bm: int
    tiles_n: int
    tiles_m: int
    full: int
    splits: int
    k_per_split: int
    stages: int
    grid: int
    smem: int

    @property
    def tiles(self) -> int:
        return self.tiles_n * self.tiles_m

    @property
    def units(self) -> int:
        return self.full + (self.tiles - self.full) * self.splits

    def unit(self, u: int, K: int):
        """(tile, split, first k, end k) of unit ``u``, as the kernel takes it."""
        if u < self.full:
            return u, 0, 0, K
        v = u - self.full
        split = v % self.splits
        kb = split * self.k_per_split
        return self.full + v // self.splits, split, kb, min(K, kb + self.k_per_split)

    def tile_origin(self, tile: int):
        """(first row of x, first weight column) of a tile."""
        return tile % self.tiles_m * self.bm, tile // self.tiles_m * TILE


def modes_smem_bytes(bm: int, bits: int, stages: int) -> int:
    """Shared memory of a block of the persistent kernel (its Layout): the
    ring of stages (two x boxes of 64 k by bm rows, then 128 k of word rows),
    two metadata chunks of scale and zero rows, the mbarriers, the flag and
    1024 bytes of slack to align the base."""
    stage = MODES_STAGE_STEPS * (bm * BK * 2 + BK * bits // 32 * TILE * 4)
    meta = 2 * (2 * MODES_META_ROWS * TILE * 2)
    return stages * stage + meta + 8 * (2 * stages + 4) + 16 + 1024


def modes_plan(M: int, N: int, K: int, gs: int, bits: int) -> ModesPlan:
    """Row tile, stage depth, ring and work list of the persistent kernel,
    from the shape alone. Whole waves of tiles run whole; the tiles of the
    last, partial wave are cut along K into as many ranges as fill the SMs
    (each range at least two stages deep), so that a block's share of the
    work differs from another's by at most one range."""
    bm = row_tile(M)
    tiles_n, tiles_m = -(-N // TILE), -(-M // bm)
    tiles = tiles_n * tiles_m
    steps = K // BK
    full, splits, per = tiles, 1, steps
    rem = tiles % SMS
    if rem:
        want = min(SMS // rem, max(1, steps // (2 * MODES_STAGE_STEPS)))
        if want > 1:
            per = -(-(-(-steps // want)) // MODES_STAGE_STEPS) * MODES_STAGE_STEPS
            splits = -(-steps // per)
            if splits > 1:
                full = tiles - rem
            else:
                per = steps
    units = full + (tiles - full) * splits
    stages = max(s for s in range(2, MODES_MAX_STAGES + 1)
                 if modes_smem_bytes(bm, bits, s) <= SMEM_MAX)
    return ModesPlan(bm, tiles_n, tiles_m, full, splits, per * BK, stages, min(SMS, units),
                     modes_smem_bytes(bm, bits, stages))


def modes_workspace(p: ModesPlan):
    """(float32 partials, int32 arrival counters) of a persistent call: each
    split tile's ranges write (bm, 128) partials, one counter a split tile,
    0 between calls."""
    split_tiles = p.tiles - p.full
    return split_tiles * p.splits * p.bm * TILE, split_tiles


def prefill_matmul_plain(x, W_q, scales, zeros, meta):
    return forward_meta(x, W_q, scales, zeros, None, meta)


def prefill_modes_plain(x, W_q, scales, zeros, scales_x, meta):
    return forward_f32_epilogue(x, W_q, scales, zeros, scales_x, meta)


def _lib():
    fn = build.load("prefill_gemm").gl_prefill
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _lib_modes():
    fn = build.load("prefill_gemm").gl_prefill_modes
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _lib_persistent():
    fn = build.load("prefill_modes").gl_prefill_modes_persistent
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _split_buffers(M: int, N: int, p: PrefillPlan, device, stream: int):
    floats, ints = workspace(M, N, p)
    if not floats:
        return None, None
    ibuf, fbuf = build.split_state("prefill_gemm", device, ints, floats, stream)
    return fbuf.data_ptr(), ibuf.data_ptr()


def prefill_matmul(x: torch.Tensor, W_q, scales, zeros, meta) -> torch.Tensor:
    """out (M, N) bf16 = x (M, K) @ dequant(W_q) for 64 < M < 4096."""
    if x.device.type == "cpu":
        return prefill_matmul_plain(x, W_q, scales, zeros, meta)
    M = x.shape[0]
    if not can_use_prefill(meta, M):
        raise NotImplementedError(f"prefill kernel does not take M={M} with {meta}")
    N, K, gs = meta.out_features, meta.in_features, meta.group_size
    x = w4.activations(x, K)
    w4.check_operands(W_q, scales, zeros, meta)
    p = plan(M, N, K, gs, meta.W_nbits)
    stream = w4.stream()
    part, cnt = _split_buffers(M, N, p, x.device, stream)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    err = _lib()(x.data_ptr(), W_q.data_ptr(), scales.data_ptr(), zeros.data_ptr(), part, cnt,
                 out.data_ptr(), M, N, K, gs, meta.W_nbits, p.bm, p.splits, p.k_per_split,
                 p.stages, stream)
    build.check(err, "prefill_gemm")
    prefill_matmul.launches += 1
    return out


prefill_matmul.launches = 0


def persistent(N: int, *operands) -> bool:
    """True when the persistent kernel takes a call: N a multiple of 8 and
    every operand (None aside) 16-byte aligned, so that TMA brings them."""
    return N % 8 == 0 and all(t is None or t.data_ptr() % 16 == 0 for t in operands)


def prefill_modes(x: torch.Tensor, W_q, scales, zeros, scales_x, meta) -> torch.Tensor:
    """out (M, N) bf16 = csm(x (M, K) @ dequant(W_q)) for 64 < M < 4096 on a
    layer in W_group_mode 1-3 (``w4.serves_modes``); x in bf16 (on the CPU
    also fp8, which the plain version reads exactly). The persistent kernel
    runs ``modes_plan`` where ``persistent`` holds; elsewhere
    ``prefill_modes_ragged`` runs."""
    if x.device.type == "cpu":
        return prefill_modes_plain(x, W_q, scales, zeros, scales_x, meta)
    M = x.shape[0]
    if not can_use_prefill_modes(meta, M):
        raise NotImplementedError(f"prefill kernel does not take M={M} with {meta}")
    N, K, gs = meta.out_features, meta.in_features, meta.group_size
    x = w4.activations(x, K)
    operands = w4.modes_operands(W_q, scales, zeros, scales_x, meta, M)
    s, z, zs, sx, cs = operands
    stream = w4.stream()
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if not persistent(N, x, W_q, s, z):
        return prefill_modes_ragged(x, W_q, operands, out, meta, stream)
    ptr = w4.pointer
    p = modes_plan(M, N, K, gs, meta.W_nbits)
    part = cnt = None
    floats, ints = modes_workspace(p)
    if floats:
        cnt, part = build.split_state("prefill_modes", x.device, ints, floats, stream)
    err = _lib_persistent()(
        x.data_ptr(), W_q.data_ptr(), ptr(s), ptr(z), ptr(zs), ptr(sx), ptr(cs), ptr(part),
        ptr(cnt), out.data_ptr(), M, N, K, gs, meta.W_nbits, p.bm, p.stages, p.grid,
        p.full, p.splits, p.k_per_split, meta.channel_scale_mode, w4.scale_code(cs), stream)
    build.check(err, "prefill_modes")
    prefill_modes.launches += 1
    return out


def prefill_modes_ragged(x, W_q, operands, out, meta, stream) -> torch.Tensor:
    """prefill_modes' kernel for the layers whose words or metadata TMA
    cannot read (N not a multiple of 8, or a base not 16-byte aligned), as
    JAX's prefill kernel takes any N: ``gl_prefill_modes``, the mode 1-3
    instances of ``prefill_gemm.cu``, on the mode-4 entry's ``plan``.
    ``operands`` are ``w4.modes_operands``; writes ``out`` and returns it."""
    M, K = x.shape
    N, gs = meta.out_features, meta.group_size
    s, z, zs, sx, cs = operands
    ptr = w4.pointer
    p = plan(M, N, K, gs, meta.W_nbits)
    part, cnt = _split_buffers(M, N, p, x.device, stream)
    err = _lib_modes()(x.data_ptr(), W_q.data_ptr(), ptr(s), ptr(z), ptr(zs), ptr(sx),
                       ptr(cs), part, cnt, out.data_ptr(), M, N, K, gs, meta.W_nbits, p.bm,
                       p.splits, p.k_per_split, p.stages, meta.channel_scale_mode,
                       w4.scale_code(cs), stream)
    build.check(err, "prefill_gemm")
    prefill_modes_ragged.launches += 1
    return out


prefill_modes_ragged.launches = 0
prefill_modes.launches = 0
