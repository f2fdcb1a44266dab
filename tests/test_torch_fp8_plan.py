# SPDX-License-Identifier: Apache-2.0
"""The fp8 kernels' plans (``ops/fp8.decode_plan``, ``prefill_plan``,
``prefill_rows``, ``prefill_smem``) and the word ring's swizzle
(``w_idx`` in ``csrc/fp8_gemm.cu``), on the CPU.

* The prefill takes 128 rows of x a block up to M 128; above, 256 with bf16
  x, and with fp8 x the rows of least modelled time (a 256-row stage at 1.87
  times a 128-row one), which match the measured faster choice at the named
  shapes.
* ``prefill_smem`` equals the kernel's ``PLayout`` written out below, each
  ring slot at the 1024 bytes a TMA box in the 128-byte swizzle needs, fits
  227 KB, and the ring is the deepest that fits.
* Both plans' splits cover K exactly, in whole stages.
* The decode grid fits whole waves of ``DECODE_RESIDENT`` blocks (one wave at
  these shapes), each block's shared memory lets three share an SM, and its
  split depends on neither M nor the form of x (so the stacked entry equals
  the per-layer one and a row's sum runs in one order at any batch).
* The prefill's word stage with fp8 x as its TMA box lands it (four groups
  of 32 columns in the 128-byte swizzle, ``p_widx``) and its warps' columns
  (``p_col``): every column once, and every A-fragment read hits 32 banks;
  with bf16 x (rows of 128 words, 16 neighbouring columns a warp) a read's
  lanes touch each bank for at most two words; the decode's ``w_idx``
  swizzle gives 32 banks too.
The kernels themselves are checked on the card (tests/test_torch_fp8_kernels.py).
"""

import pytest

from gemlite_tpu_torch.ops import fp8

SMEM_MAX = 227 * 1024            # a block's shared memory on the H100
SM_SMEM = 228 * 1024             # an SM's, less 1 KB the card keeps for each block
SMS = 132
# Llama-3-8B's four shapes and Mistral-7B's wqkv (6144 x 4096)
SHAPES = [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336), (6144, 4096)]
PREFILL_MS = [65, 128, 129, 200, 256, 300, 512, 1024, 2048, 4095]
DECODE_MS = [1, 7, 8, 33, 64]
X_BYTES = {"fp8": 1, "bf16": 2}


def w_idx(r: int, c: int) -> int:
    """csrc/fp8_gemm.cu w_idx (decode): bits 3-4 of the column flipped by
    bits 0-1 of the word row."""
    return r * 128 + (c ^ ((r & 3) << 3))


def p_widx(r: int, c: int, rows: int) -> int:
    """csrc/fp8_gemm.cu p_widx (prefill): word (r, c) of a stage of four
    32-column groups of ``rows`` rows."""
    return (c >> 5) * rows * 32 + r * 32 + ((((c >> 2) & 7) ^ (r & 7)) << 2) + (c & 3)


def p_col(w: int, g: int, h: int) -> int:
    """csrc/fp8_gemm.cu p_col: the weight column of A row g + 8 h of
    consumer warp w."""
    return 32 * (w >> 1) + 16 * (g >> 2) + 8 * (w & 1) + 4 * h + (g & 3)


def swizzle_128b(byte: int) -> int:
    """CU_TENSOR_MAP_SWIZZLE_128B on a byte offset from a 1024-byte aligned
    base: bits 4-6 XORed with bits 7-9 (the 16-byte piece by the 128-byte row
    within each 1024 bytes)."""
    return byte ^ (((byte >> 7) & 7) << 4)


def layout_bytes(bm: int, bk: int, x_bytes: int, stages: int) -> int:
    """PLayout, region by region from a 1024-byte aligned base."""
    x_box = bm * bk * x_bytes                   # bm rows of 128 bytes
    words = bk // 4 * 128 * 4                   # bk / 4 word rows of 128 columns
    assert bk * x_bytes == 128
    for i in range(stages):
        assert (i * x_box) % 1024 == 0          # the 128-byte swizzle repeats every 1024
    w = stages * x_box
    for i in range(stages):
        assert (w + i * words) % 1024 == 0      # one word box a stage, in the same swizzle
    tile = bm * (128 + 4) * 4                   # the float32 epilogue tile, over the ring
    bars = max(w + stages * words, tile)
    assert bars % 8 == 0
    flag = bars + 16 * stages                   # full and empty mbarriers, 8 bytes each
    return flag + 16 + 1024


@pytest.mark.parametrize("x", sorted(X_BYTES))
@pytest.mark.parametrize("N,K", SHAPES)
@pytest.mark.parametrize("M", PREFILL_MS)
def test_prefill_row_rule(x, N, K, M):
    xb = X_BYTES[x]
    p = fp8.prefill_plan(M, N, K, xb)
    assert p.bm == fp8.prefill_rows(M, N, K, xb)
    if M <= 128 or xb == 2:
        assert p.bm == (128 if M <= 128 else 256)
    else:
        other = 384 - p.bm
        assert fp8._prefill_us(M, N, K, p.bm, 128) <= fp8._prefill_us(M, N, K, other, 128)
    assert p.tiles_n == N // 128 and p.tiles_m == -(-M // p.bm) and p.launches == 1
    assert p.bk == (128 if xb == 1 else 64)


@pytest.mark.parametrize("M,N,K,bm", [(256, 14336, 4096, 256), (1024, 14336, 4096, 128),
                                      (2048, 14336, 4096, 256), (256, 4096, 14336, 128),
                                      (1024, 4096, 14336, 256), (2048, 4096, 14336, 256),
                                      (1024, 1024, 4096, 128)])
def test_prefill_rows_at_measured_shapes(M, N, K, bm):
    """fp8 x, the faster rows measured (scripts/torch_fp8_variants.py,
    rows_128 / rows_256; PERF.md): 14336x4096 at M 256 takes 256 rows though
    its 112 blocks leave 20 SMs idle, at M 1024 128 (7 full waves beat 3.4
    of 1.87 times the length); 4096x14336 at M 256 128 (one wave, 2 splits
    against 4); 1024x4096 at M 1024 128 (64 blocks); bf16 x takes 256 rows
    at each."""
    assert fp8.prefill_plan(M, N, K, 1).bm == bm
    assert fp8.prefill_plan(M, N, K, 2).bm == 256


@pytest.mark.parametrize("x", sorted(X_BYTES))
@pytest.mark.parametrize("N,K", SHAPES)
@pytest.mark.parametrize("M", PREFILL_MS)
def test_prefill_smem_is_the_layout(x, N, K, M):
    xb = X_BYTES[x]
    p = fp8.prefill_plan(M, N, K, xb)
    assert p.smem == fp8.prefill_smem(p.bm, p.bk, xb, p.stages) == \
        layout_bytes(p.bm, p.bk, xb, p.stages)
    assert p.smem <= SMEM_MAX and 2 <= p.stages <= fp8.PREFILL_STAGES
    deeper = p.stages + 1
    assert deeper > fp8.PREFILL_STAGES or layout_bytes(p.bm, p.bk, xb, deeper) > SMEM_MAX


@pytest.mark.parametrize("x", sorted(X_BYTES))
@pytest.mark.parametrize("N,K", SHAPES)
@pytest.mark.parametrize("M", PREFILL_MS)
def test_prefill_splits_cover_k(x, N, K, M):
    p = fp8.prefill_plan(M, N, K, X_BYTES[x])
    assert p.k_per_split % p.bk == 0
    ranges = [(s * p.k_per_split, min(K, (s + 1) * p.k_per_split)) for s in range(p.splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == K and all(a < b for a, b in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(p.splits - 1))


@pytest.mark.parametrize("x", sorted(X_BYTES))
@pytest.mark.parametrize("N,K", SHAPES)
@pytest.mark.parametrize("M", DECODE_MS)
def test_decode_whole_waves(x, N, K, M):
    p = fp8.decode_plan(M, N, K, X_BYTES[x])
    blocks = p.tiles * p.splits
    assert p.tiles == N // 128 and p.launches == 1
    assert blocks <= fp8.DECODE_RESIDENT == fp8.DECODE_BLOCKS_PER_SM * SMS
    # the wave is at least half full, unless every split already holds the
    # least two stages
    assert 2 * blocks > fp8.DECODE_RESIDENT or p.splits == K // fp8.BK // 2
    assert p.smem <= fp8.DECODE_BUDGET
    assert fp8.DECODE_BLOCKS_PER_SM * (p.smem + 1024) <= SM_SMEM
    ranges = [(s * p.k_per_split, min(K, (s + 1) * p.k_per_split)) for s in range(p.splits)]
    assert ranges[-1][1] == K and all(b - a >= 2 * fp8.BK for a, b in ranges[:-1])
    assert all(a < b for a, b in ranges) and p.k_per_split % fp8.BK == 0


@pytest.mark.parametrize("N,K", SHAPES)
def test_decode_split_independent_of_m_and_x(N, K):
    splits = {(fp8.decode_plan(M, N, K, xb).splits, fp8.decode_plan(M, N, K, xb).k_per_split)
              for M in range(1, 65) for xb in (1, 2)}
    assert len(splits) == 1


@pytest.mark.parametrize("N,K,blocks", [(14336, 4096, 336), (4096, 14336, 384),
                                        (4096, 4096, 352), (1024, 4096, 128)])
def test_decode_blocks_at_8b_shapes(N, K, blocks):
    """The parent's plan launched 448 / 448 / 512 / 128 blocks (1.13 / 1.13 /
    1.29 / 0.32 waves of 396)."""
    p = fp8.decode_plan(8, N, K, 1)
    assert p.tiles * p.splits == blocks


@pytest.mark.parametrize("rows", [16, 32])
def test_prefill_stage_is_the_tma_box(rows):
    """p_widx puts word (r, c) where the 3-d box (32 columns, rows, 4
    groups) lands it: group c / 32 after group, rows of 128 bytes, at the
    128-byte swizzle of its byte offset."""
    seen = set()
    for r in range(rows):
        for c in range(128):
            byte = ((c >> 5) * rows + r) * 128 + (c & 31) * 4
            assert 4 * p_widx(r, c, rows) == swizzle_128b(byte)
            seen.add(p_widx(r, c, rows))
    assert seen == set(range(rows * 128))


def test_prefill_columns_cover_the_tile():
    cols = [p_col(w, g, h) for w in range(8) for g in range(8) for h in range(2)]
    assert sorted(cols) == list(range(128))
    for w in range(8):                              # warpgroup w // 4 holds 64 of them
        assert {p_col(w, g, h) for g in range(8) for h in range(2)} <= \
            set(range(64 * (w // 4), 64 * (w // 4) + 64))


def _banks_free(words) -> bool:
    """No two lanes of a warp read different words of one bank."""
    by_bank = {}
    for wd in words:
        by_bank.setdefault(wd % 32, set()).add(wd)
    return all(len(v) == 1 for v in by_bank.values())


@pytest.mark.parametrize("warp", range(8))
def test_prefill_fragment_reads_conflict_free(warp):
    """p_build with fp8 x: lane (g, t) of consumer warp `warp` reads column
    p_col(warp, g, h) at word row 8 kk + 4 half + t (32 rows a stage)."""
    for kk in range(4):
        for half in range(2):
            for h in range(2):
                words = [p_widx(8 * kk + 4 * half + lane % 4, p_col(warp, lane // 4, h), 32)
                         for lane in range(32)]
                assert _banks_free(words) and len({wd % 32 for wd in words}) == 32, (kk, half, h)


@pytest.mark.parametrize("warp", range(8))
def test_prefill_bf16_reads_two_way(warp):
    """p_build with bf16 x: rows of 128 words; lane (g, t) reads column 16
    warp + g + 8 h at word row 4 kk + 2 half + t / 2: lanes t, t ^ 1 share a
    word, and each bank serves two words (the 2-way conflict kept)."""
    for kk in range(4):
        for half in range(2):
            for h in range(2):
                words = [(4 * kk + 2 * half + lane % 4 // 2) * 128 + 16 * warp + lane // 4 + 8 * h
                         for lane in range(32)]
                by_bank = {}
                for wd in words:
                    by_bank.setdefault(wd % 32, set()).add(wd)
                assert len(set(words)) == 16 and all(len(v) == 2 for v in by_bank.values())


@pytest.mark.parametrize("warp", range(4))
def test_decode_fragment_reads_conflict_free(warp):
    """d_compute_stage: lane (g, t) reads word rows 8 kb + t (+ 4) at columns
    32 warp + 16 i + 8 h + g."""
    for kb in range(4):
        for i in range(2):
            for h in range(2):
                for j in range(2):
                    words = [w_idx(8 * kb + lane % 4 + 4 * j,
                                   32 * warp + 16 * i + 8 * h + lane // 4) for lane in range(32)]
                    assert len({wd % 32 for wd in words}) == 32
