# SPDX-License-Identifier: Apache-2.0
"""The MX prefill kernel's plan (``ops/mx.prefill_plan``, ``prefill_smem``) on
the CPU.

The prefill body (``gl_mx_prefill``, and the ragged instances behind
``gl_mx_general``) takes 128 rows of x a block up to M 128 and 256 above, as
the W4 prefill kernel does (``ops/prefill.row_tile``), splits K by that
kernel's cost model, and picks the deepest ring that fits for the form of x:
bf16 x in one tile a stage, or e4m3 codes (csm 2 and csm 4), whose ring holds
the code boxes and their group scales and whose three bf16 tiles the
producer converts into. Held here:

* ``bm`` follows ``row_tile`` and the splits cover K;
* ``prefill_smem`` equals the bytes of the kernel's layout (``PLayout`` in
  ``csrc/mx_gemm.cu``, written out again below with its alignments) and fits
  227 KB at every weight kind, ring depth, ``bm`` and form the plan picks;
* the bf16 and e4m3 forms get the same rows and split (so the same order of
  sums) at every M from 65 to 4095;
* ``general_plan``'s prefill body equals ``prefill_plan``'s.
"""

import pytest

from gemlite_tpu_torch.ops import mx
from gemlite_tpu_torch.ops.prefill import row_tile

SMEM_MAX = 227 * 1024            # a block's shared memory on the H100
KINDS = {"fp4": 0, "e4m3": 1, "e5m2": 2}
# Llama-3-8B's four shapes, SmolLM2-360M's gate / up, gpt-oss-20b's hidden
# width and a ragged shape (the general entry's prefill body)
SHAPES = [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336), (2560, 960), (2880, 2880),
          (37, 224)]
MS = [1, 8, 64, 65, 128, 129, 256, 300, 1024, 2048, 4095]
FORMS = {"bf16": False, "e4m3": True}


def layout_bytes(kind: int, stages: int, bm: int, codes: bool) -> int:
    """The kernel's shared memory, region by region from a 1024-byte aligned
    base, each TMA destination checked against its alignment (1024 bytes for
    the 128-byte swizzle, else 128)."""
    x_tile = bm * 64 * 2                         # bm rows of 64 bf16
    words = 64 // (8 if kind == 0 else 4) * 128 * 4
    tiles = 3 if codes else stages
    off, regions = 0, []
    for name, count, size, align in (("x", tiles, x_tile, 1024), ("words", stages, words, 128),
                                     ("scales", stages, 512, 128),
                                     ("codes", stages if codes else 0, bm * 64, 128),
                                     ("x scales", stages if codes else 0, bm * 16, 128)):
        for i in range(count):
            assert (off + i * size) % align == 0, (name, i)
        regions.append((name, off))
        off += count * size
    tile = bm * (128 + 4) * 4                    # the float32 epilogue tile, over the ring
    bars = max(off, tile)
    assert bars % 8 == 0
    flag = bars + 8 * (2 * stages + (2 * 3 if codes else 0))   # and x ready, x free a tile
    return flag + 16 + 1024


def _fits(kind, stages, bm, codes):
    return mx.prefill_smem(kind, stages, bm, codes) <= SMEM_MAX


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("N,K", SHAPES)
@pytest.mark.parametrize("M", MS)
def test_rows_follow_row_tile_and_splits_cover_k(kind, form, N, K, M):
    p = mx.prefill_plan(M, N, K, KINDS[kind], x_codes=FORMS[form])
    assert p.bm == row_tile(M) and p.bk == mx.PREFILL_BK and p.launches == 1
    assert p.tiles_n == -(-N // 128) and p.tiles_m == -(-M // p.bm)
    assert p.k_per_split % p.bk == 0
    ranges = [(s * p.k_per_split, min(K, (s + 1) * p.k_per_split)) for s in range(p.splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == K and all(a < b for a, b in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(p.splits - 1))


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("bm", [128, 256])
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("stages", [2, 3, 4, 5])
def test_smem_is_the_kernel_layout(kind, bm, form, stages):
    codes = FORMS[form]
    assert mx.prefill_smem(KINDS[kind], stages, bm, codes) == layout_bytes(KINDS[kind], stages,
                                                                          bm, codes)


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("M", [65, 128, 129, 1024])
def test_ring_is_the_deepest_that_fits(kind, form, M):
    codes = FORMS[form]
    p = mx.prefill_plan(M, 14336, 4096, KINDS[kind], x_codes=codes)
    assert p.smem == mx.prefill_smem(KINDS[kind], p.stages, p.bm, codes) <= SMEM_MAX
    assert 2 <= p.stages <= mx.PREFILL_STAGES
    assert p.stages == mx.PREFILL_STAGES or not _fits(KINDS[kind], p.stages + 1, p.bm, codes)


# every M of the prefill kernel above the decode range, in chunks
M_CHUNKS = [range(a, min(a + 512, 4096)) for a in range(65, 4096, 512)]


@pytest.mark.parametrize("N,K", SHAPES[:4] + SHAPES[5:6])
@pytest.mark.parametrize("chunk", range(len(M_CHUNKS)))
def test_both_forms_take_the_same_rows_and_split(N, K, chunk):
    """Same rows, split and so order of sums for bf16 x and e4m3 codes, which
    keeps the csm-4 form bit for bit the bf16 form fed the fake-quantized x;
    only the ring depth may differ (fp8 words with codes at 256 rows)."""
    for M in M_CHUNKS[chunk]:
        a = mx.prefill_plan(M, N, K, 0)
        for kind in KINDS.values():
            b = mx.prefill_plan(M, N, K, kind, x_codes=True)
            assert (a.bm, a.tiles_n, a.tiles_m, a.splits, a.k_per_split) == (
                b.bm, b.tiles_n, b.tiles_m, b.splits, b.k_per_split), M


@pytest.mark.parametrize("nvfp4", [False, True])
@pytest.mark.parametrize("N,K", SHAPES)
@pytest.mark.parametrize("M", MS)
def test_general_prefill_body_is_prefill_plan(nvfp4, N, K, M):
    g = mx.general_plan(M, N, K, nvfp4)
    if g.body == "decode":
        assert M <= 64 and not nvfp4
        return
    for codes in (False, True):
        p = mx.prefill_plan(M, N, K, 0, x_codes=codes)
        assert (g.bm, g.bk, g.tiles_n, g.tiles_m, g.splits, g.k_per_split, g.stages) == tuple(p)[:-1]
        assert p.smem <= g.smem <= SMEM_MAX
