# SPDX-License-Identifier: Apache-2.0
"""The persistent mode 1-3 prefill kernel's plan (``ops/prefill.modes_plan``)
on the CPU: its work list walked as the kernel walks it (block b takes units
b, b + grid, ...; ``ModesPlan.unit`` is the kernel's ``Unit``).

* every output tile is covered exactly once: its units' K ranges are
  disjoint, in split order, and make up [0, K), each a whole number of
  stages but the last;
* the split depends only on the shape: the plan is a function of (M, N, K,
  gs, bits), whole waves of tiles are never cut, and a block's work
  differs from another's by at most one K range;
* a block's shared memory (``modes_smem_bytes``, the kernel's Layout) fits
  227 KB, with at least two stages and at most eight;
* over M 65-4095 on both of chip_smoke.py's MODES_SHAPES (14336x4096,
  4096x14336) and the tiny_en_5m checkpoint's shapes, for W1 / W2 / W4, gs 64
  and channel-wise;
* ``persistent`` sends a call to the persistent kernel exactly when TMA can
  read its operands, whatever its group size, and the kernel's group row of
  a step (``group_row`` in prefill_modes.cu, a multiply-high) equals the
  floor division over every step and group size its entry admits.
"""

import numpy as np
import pytest
import torch

from gemlite_tpu_torch.ops.prefill import (BK, MODES_STAGE_STEPS, SMEM_MAX, SMS, TILE,
                                           modes_plan, modes_smem_bytes, modes_workspace,
                                           persistent, row_tile)

MODES_SHAPES = ((14336, 4096), (4096, 14336))
TINY_SHAPES = ((256, 256), (128, 256), (768, 256), (256, 768))   # q, k / v, gate / up, down
MS = (65, 100, 128, 129, 256, 300, 512, 777, 1024, 1500, 2048, 3000, 4095)


def _cases():
    for N, K in MODES_SHAPES + TINY_SHAPES:
        for M in MS:
            for gs in (64, K):
                yield M, N, K, gs


def _walk(p, K):
    """{tile: [(split, kb, ke)]} and each block's K total, in the kernel's order."""
    tiles, work = {}, [0] * p.grid
    for b in range(p.grid):
        for u in range(b, p.units, p.grid):
            tile, split, kb, ke = p.unit(u, K)
            tiles.setdefault(tile, []).append((split, kb, ke))
            work[b] += ke - kb
    return tiles, work


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_every_tile_once(bits):
    for M, N, K, gs in _cases():
        p = modes_plan(M, N, K, gs, bits)
        assert p.bm == row_tile(M)
        assert p.tiles_n * TILE >= N > (p.tiles_n - 1) * TILE
        assert p.tiles_m * p.bm >= M > (p.tiles_m - 1) * p.bm
        tiles, _ = _walk(p, K)
        assert sorted(tiles) == list(range(p.tiles))
        origins = {p.tile_origin(t) for t in tiles}
        assert len(origins) == p.tiles
        for t, ranges in tiles.items():
            ranges.sort()
            assert [s for s, _, _ in ranges] == list(range(len(ranges)))
            assert len(ranges) == (1 if t < p.full else p.splits)
            assert ranges[0][1] == 0 and ranges[-1][2] == K
            for (_, _, end), (_, start, _) in zip(ranges, ranges[1:]):
                assert end == start and start % (BK * MODES_STAGE_STEPS) == 0
            assert all(kb < ke for _, kb, ke in ranges)


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_split_fixed_by_the_shape(bits):
    for M, N, K, gs in _cases():
        p = modes_plan(M, N, K, gs, bits)
        assert p == modes_plan(M, N, K, gs, bits)
        assert p.grid == min(SMS, p.units)
        waves, rem = divmod(p.tiles, SMS)
        if p.full < p.tiles:                          # only the last partial wave is cut
            assert p.full == waves * SMS and p.tiles - p.full == rem
            assert p.splits > 1 and rem * p.splits <= SMS
            stage = BK * MODES_STAGE_STEPS
            assert p.k_per_split % stage == 0 and p.k_per_split >= 2 * stage
            assert (p.splits - 1) * p.k_per_split < K <= p.splits * p.k_per_split
        else:
            assert p.splits == 1 and p.k_per_split == K
        _, work = _walk(p, K)
        assert max(work) - min(work) <= (p.k_per_split if p.full < p.tiles else K)


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_shared_memory_fits(bits):
    for bm in (128, 256):
        p = modes_plan(129 if bm == 256 else 128, 14336, 4096, 64, bits)
        assert p.bm == bm
        assert 2 <= p.stages <= 8 and p.smem <= SMEM_MAX
        assert p.smem == modes_smem_bytes(bm, bits, p.stages)
        assert p.stages == 8 or modes_smem_bytes(bm, bits, p.stages + 1) > SMEM_MAX


def test_workspace_covers_the_split_tiles():
    for M, N, K, gs in _cases():
        p = modes_plan(M, N, K, gs, 4)
        floats, ints = modes_workspace(p)
        assert ints == p.tiles - p.full
        assert floats == ints * p.splits * p.bm * TILE


def test_8b_plans():
    """The kernels line's shapes: whole waves run whole, the last partial
    wave cut in two at M 1024 on 14336x4096 (448 tiles: 3 waves and 52),
    and the 32 column tiles of 4096x14336 at M 128 in four K ranges."""
    p = modes_plan(1024, 14336, 4096, 64, 4)
    assert (p.bm, p.tiles, p.full, p.splits, p.k_per_split, p.grid) == (256, 448, 396, 2, 2048,
                                                                         132)
    p = modes_plan(128, 4096, 14336, 64, 4)
    assert (p.bm, p.tiles, p.full, p.splits, p.k_per_split, p.grid) == (128, 32, 0, 4, 3584, 128)
    p = modes_plan(2048, 14336, 4096, 64, 4)
    assert (p.tiles, p.full, p.splits, p.grid) == (896, 896, 1, 132)


def test_persistent_takes_what_tma_reads():
    """N a multiple of 8 and 16-byte aligned bases; the group size does not
    matter (prefill_modes_ragged takes the rest)."""
    base = torch.zeros(64, dtype=torch.int32)
    assert persistent(1024, base, None, base[4:])
    assert not persistent(1028, base)
    assert not persistent(1024, base, base[1:])


@pytest.mark.parametrize("d", [1, 2, 3, 5, 7, 21, 64, 224, 1000, 46340])
def test_group_row_is_floor_division(d):
    """prefill_modes.cu's group_row(i, gmul) = umulhi(2 i, 2^31 / d + 1),
    for d 64-deep steps a group, over every step i < K / 64 of the largest
    K its entry admits ((K / 64)^2 < 2^31)."""
    i = np.arange(int((2 ** 31 - 1) ** 0.5), dtype=np.uint64)
    gmul = np.uint64((1 << 31) // d + 1)
    assert np.array_equal((2 * i * gmul) >> np.uint64(32), i // np.uint64(d))
