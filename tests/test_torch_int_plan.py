# SPDX-License-Identifier: Apache-2.0
"""The general fused kernel's int-path plan (``ops/fused.int_plan``), on the
CPU: at the four Llama-3-8B linear shapes and M in {65, 128, 1024, 4095} the
tiles cover the output, the K ranges cover K in whole K steps, the plan is a
function of M, N and K alone, and every call is one launch. The kernel
itself is checked on the card (tests/test_torch_kernels.py)."""

import pytest

from gemlite_tpu_torch.ops import build, fused
from gemlite_tpu_torch.ops.fused import INT_BK, INT_TILE, IntPlan, int_plan

SHAPES = ((4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336))   # (N, K)
MS = (65, 128, 1024, 4095)
CASES = [(M, N, K) for N, K in SHAPES for M in MS]

# splits per (N, K) at M = 65 / 128 / 1024 / 4095: one block per SM where
# the tiles alone leave SMs idle, else none
SPLITS = {(4096, 4096): (4, 4, 1, 1), (1024, 4096): (16, 16, 2, 1),
          (14336, 4096): (1, 1, 1, 1), (4096, 14336): (4, 4, 1, 1)}


@pytest.mark.parametrize("M,N,K", CASES)
def test_int_plan_tiles_cover_the_output(M, N, K):
    p = int_plan(M, N, K)
    assert (p.tiles_m - 1) * INT_TILE < M <= p.tiles_m * INT_TILE
    assert (p.tiles_n - 1) * INT_TILE < N <= p.tiles_n * INT_TILE


@pytest.mark.parametrize("M,N,K", CASES)
def test_int_plan_k_ranges_cover_k_in_whole_steps(M, N, K):
    p = int_plan(M, N, K)
    if p.splits == 1:
        assert p.k_per_split == K
        return
    assert p.k_per_split % INT_BK == 0
    assert (p.splits - 1) * p.k_per_split < K <= p.splits * p.k_per_split
    ranges = [(s * p.k_per_split, min(K, (s + 1) * p.k_per_split)) for s in range(p.splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    assert all(a < b and a % INT_BK == 0 for a, b in ranges)


@pytest.mark.parametrize("M,N,K", CASES)
def test_int_plan_launches_and_scratch(M, N, K):
    """One launch per call, split or not; a split adds into an int32
    accumulator of one 128 x 128 tile per output tile, kept zero between
    calls."""
    p = int_plan(M, N, K)
    assert p.splits == SPLITS[(N, K)][MS.index(M)]
    assert p.launches == 1
    tiles = p.tiles_m * p.tiles_n
    assert p.acc_bytes == (0 if p.splits == 1 else 4 * tiles * INT_TILE ** 2)
    if p.splits > 1:
        assert tiles < fused.FILL and tiles * p.splits <= fused.SMS


@pytest.mark.parametrize("M,N,K", CASES)
def test_int_plan_depends_on_shape_only(M, N, K, monkeypatch):
    """The same plan at any call, whatever state the module holds."""
    first = int_plan(M, N, K)
    monkeypatch.setattr(build, "_SPLIT_STATE", {"stale": None})
    assert isinstance(first, IntPlan) and int_plan(M, N, K) == first
    assert int_plan(M, N, K)._asdict() == first._asdict()


@pytest.mark.parametrize("M,N,K", [(1, 200, 96), (65, 256, 96), (1000, 200, 256), (3, 96, 4096)])
def test_int_plan_small_and_ragged_shapes(M, N, K):
    """Shapes of the card tests: K below one step, N off the tile."""
    p = int_plan(M, N, K)
    assert p.tiles_m * INT_TILE >= M and p.tiles_n * INT_TILE >= N
    assert p.splits * p.k_per_split >= K and p.launches == 1
    assert p.splits <= -(-K // INT_BK)
