# SPDX-License-Identifier: Apache-2.0
"""The general MX entry's plan (``ops/mx.general_plan``) on the CPU.

The general entry (``gl_mx_general``, route ``general_fused``) serves the fp4
MX layers that the JAX package does not fold (K or N off the multiples of
128) on the ragged instances of the MX decode body (M <= 64 with e8m0 scales)
and of the MX prefill body (NVFP4 at every M, e8m0 above M 64). The plan says
which body runs, its tiles, its K split and its ring; the CUDA entry only
checks that what it is given fits. Held here, for SmolLM2-360M's block
linears, gpt-oss-20b's hidden width and two ragged shapes, at M 1-4095:

* the body per M and scale form;
* ceil(N / 128) column tiles, the row tiles of the body;
* splits of whole stages that cover K exactly, none empty, a last stage
  partly past K where K is no multiple of the stage;
* a ring that fits the body's shared memory, for bf16 and e4m3 x alike (the
  plan does not depend on the form of x).
"""

import pytest

from gemlite_tpu_torch.ops import mx
from gemlite_tpu_torch.ops.prefill import row_tile

# (N, K): SmolLM2-360M's q / o, k / v, gate / up and down; gpt-oss-20b's
# hidden width; a ragged N that keeps 16-byte word rows; an odd N with K
# ending half-way through a prefill stage
SHAPES = [(960, 960), (320, 960), (2560, 960), (960, 2560), (2880, 2880), (1000, 1024),
          (37, 224)]
MS = [1, 8, 64, 65, 128, 1024, 4095]
FORMS = {"e8m0": False, "nvfp4": True}
SMEM_MAX = 227 * 1024          # a block's shared memory on the H100
DECODE_SMEM_MAX = 112 * 1024   # the decode body's cap (mx_gemm.cu kDecodeSmemMax)

cases = pytest.mark.parametrize("form", sorted(FORMS))
shapes = pytest.mark.parametrize("N,K", SHAPES)
ms = pytest.mark.parametrize("M", MS)


def _plan(M, N, K, form):
    return mx.general_plan(M, N, K, FORMS[form])


@cases
@shapes
@ms
def test_body_per_m_and_form(form, N, K, M):
    p = _plan(M, N, K, form)
    want = "decode" if M <= 64 and form == "e8m0" else "prefill"
    assert p.body == want
    assert p.bk == (mx.BK if want == "decode" else mx.PREFILL_BK)
    assert p.launches == 1


@cases
@shapes
@ms
def test_tiles(form, N, K, M):
    p = _plan(M, N, K, form)
    assert p.tiles_n == -(-N // 128)
    assert (p.tiles_n - 1) * 128 < N <= p.tiles_n * 128
    if p.body == "decode":
        assert p.tiles_m == 1 and p.bm == -(-M // 8) * 8      # one block of all M rows
    else:
        assert p.bm == row_tile(M) and p.tiles_m == -(-M // p.bm)


@cases
@shapes
@ms
def test_splits_cover_k(form, N, K, M):
    """Ranges [s kps, min(K, (s + 1) kps)) of whole stages, none empty, K
    covered exactly (the entry's split check)."""
    p = _plan(M, N, K, form)
    assert p.splits >= 1 and p.k_per_split > 0 and p.k_per_split % p.bk == 0
    ranges = [(s * p.k_per_split, min(K, (s + 1) * p.k_per_split)) for s in range(p.splits)]
    assert all(a < b for a, b in ranges)
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(p.splits - 1))
    assert p.splits * p.k_per_split >= K > (p.splits - 1) * p.k_per_split


@cases
@shapes
@ms
def test_ragged_last_stage(form, N, K, M):
    """Every split but the last is whole stages; the last split's last stage
    is K % bk deep where K is no multiple of the stage (the kernel's steps
    round up and read zeros past K), else a whole stage."""
    p = _plan(M, N, K, form)
    start = (p.splits - 1) * p.k_per_split
    span = K - start
    steps = -(-span // p.bk)
    last = span - (steps - 1) * p.bk
    assert start % p.bk == 0
    assert last == (K % p.bk or p.bk)
    if K % p.bk:
        assert 0 < last < p.bk


@cases
@shapes
@ms
def test_ring_fits_the_block(form, N, K, M):
    p = _plan(M, N, K, form)
    assert 2 <= p.stages <= mx.MAX_STAGES
    assert p.smem <= SMEM_MAX
    if p.body == "decode":
        assert p.smem <= DECODE_SMEM_MAX
    else:
        assert p.smem == max(mx.prefill_smem(0, p.stages, p.bm, codes) for codes in (False, True))


@cases
@shapes
@ms
def test_one_plan_for_bf16_and_e4m3_x(form, N, K, M):
    """The plan takes no form of x: the decode body's split equals
    ``ragged_decode_plan``'s, and its ring (sized for bf16 x) holds the
    stages of 1- and 2-byte x alike; the prefill body's rows, split and ring are
    ``prefill_plan``'s for bf16 x and for e4m3 codes alike, and its shared
    memory holds either form's layout."""
    p = _plan(M, N, K, form)
    if p.body == "prefill":
        for codes in (False, True):
            q = mx.prefill_plan(M, N, K, 0, x_codes=codes)
            assert (p.bm, p.tiles_n, p.tiles_m, p.splits, p.k_per_split, p.stages) == (
                q.bm, q.tiles_n, q.tiles_m, q.splits, q.k_per_split, q.stages)
            assert q.smem <= p.smem
        return
    rows = -(-M // 8) * 8
    d = mx.ragged_decode_plan(M, N, K)
    assert (d.tiles, d.splits, d.k_per_split) == (p.tiles_n, p.splits, p.k_per_split)
    for x_bytes in (1, 2):
        stage = mx.BK // 8 * mx.TILE * 4 + mx.BK // 32 * mx.TILE + rows * mx.BK * x_bytes
        assert max(p.stages * stage, M * mx.TILE * 4) <= p.smem


def test_folded_shapes_keep_their_plans():
    """On the folded shapes the general plan's prefill split is the folded
    prefill kernel's (its ragged instance changes nothing where N and K are
    multiples of 128). Its decode body is the ragged cp.async body, which
    keeps its own plan (``ragged_decode_plan``: K in units of 256, about four
    blocks an SM), apart from the folded decode kernel's whole-wave TMA plan."""
    for N, K in [(4096, 4096), (14336, 4096), (4096, 14336)]:
        for M in (1, 8, 64):
            d = mx.ragged_decode_plan(M, N, K)
            assert tuple(mx.general_plan(M, N, K, False))[3:] == (d.tiles, 1, d.splits,
                                                                 d.k_per_split, d.stages, d.smem)
        for M in (65, 1024):
            p = mx.prefill_plan(M, N, K, 0)
            assert tuple(mx.general_plan(M, N, K, False))[1:-1] == tuple(p)[:-1]
