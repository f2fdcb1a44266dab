# SPDX-License-Identifier: Apache-2.0
"""Prefill kernel: W1/W2/W4 x bf16 for 64 < M < 4096 on Hopper's ``wgmma``,
one launch a call (``csrc/prefill_gemm.cu``, entries ``gl_prefill`` and
``gl_prefill_modes``).

Replaces ``gemlite_tpu/ops/pallas_prefill.py:pallas_prefill_matmul`` on the
bf16 layers of W1, W2 and W4 codes that the JAX router sends to its prefill
kernel: mode 4 (``prefill_matmul``) and, in the mode 1-3 form
(``prefill_modes``, the layers of ``w4.serves_modes``), A8Wn, channel-wise
A16Wn and A16W158. The plain versions are ``ops/reference.forward_meta``
and, for the mode 1-3 form, ``reference.forward_f32_epilogue``. On a CPU
tensor a wrapper runs its plain version; on a CUDA tensor it launches the
kernel or raises. ``plan`` owns the kernel's grid and ring: the CUDA side
only checks that what it is given fits.
"""

import ctypes
from typing import NamedTuple

import torch

from . import build, w4
from .reference import forward_f32_epilogue, forward_meta

__all__ = ["PREFILL_BITS", "PrefillPlan", "can_use_prefill", "can_use_prefill_modes", "plan",
           "prefill_matmul", "prefill_matmul_plain", "prefill_modes", "prefill_modes_plain",
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


def prefill_modes(x: torch.Tensor, W_q, scales, zeros, scales_x, meta) -> torch.Tensor:
    """out (M, N) bf16 = csm(x (M, K) @ dequant(W_q)) for 64 < M < 4096 on a
    layer in W_group_mode 1-3 (``w4.serves_modes``); x in bf16 (on the CPU
    also fp8, which the plain version reads exactly). The plan is the
    mode-4 entry's: the split cost model does not depend on the mode."""
    if x.device.type == "cpu":
        return prefill_modes_plain(x, W_q, scales, zeros, scales_x, meta)
    M = x.shape[0]
    if not can_use_prefill_modes(meta, M):
        raise NotImplementedError(f"prefill kernel does not take M={M} with {meta}")
    N, K, gs = meta.out_features, meta.in_features, meta.group_size
    x = w4.activations(x, K)
    s, z, zs, sx, cs = w4.modes_operands(W_q, scales, zeros, scales_x, meta, M)
    p = plan(M, N, K, gs, meta.W_nbits)
    stream = w4.stream()
    part, cnt = _split_buffers(M, N, p, x.device, stream)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    ptr = w4.pointer
    err = _lib_modes()(x.data_ptr(), W_q.data_ptr(), ptr(s), ptr(z), ptr(zs), ptr(sx), ptr(cs),
                       part, cnt, out.data_ptr(), M, N, K, gs, meta.W_nbits, p.bm, p.splits,
                       p.k_per_split, p.stages, meta.channel_scale_mode, w4.scale_code(cs),
                       stream)
    build.check(err, "prefill_gemm")
    prefill_modes.launches += 1
    return out


prefill_modes.launches = 0
