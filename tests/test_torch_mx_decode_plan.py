# SPDX-License-Identifier: Apache-2.0
"""The MX decode kernel's plan (``ops/mx.decode_plan``, ``decode_smem``) and
its TMA layouts (``d_col``, ``d_word`` and ``d_x`` in ``csrc/mx_gemm.cu``),
on the CPU.

* The grid fits whole waves of ``DECODE_RESIDENT`` blocks (three an SM, the
  launch bounds'), at the Llama-3-8B shapes, the fused wqkv / gate_up
  shapes and tiny_en_5m's shapes: one wave wherever the column tiles fit
  it, and at least half a wave unless every split already holds the least
  two stages.
* Its split is the same at every M <= 64 and for either form of x, so the
  stacked entry equals the per-layer one and a row's sum runs in one order
  at any batch; the splits cover K exactly in whole stages.
* Its shared memory is the kernel's ``DLayout`` written out below (each ring
  slot that TMA fills in the 128-byte swizzle 1024-byte aligned), and three
  blocks of it, with their static mbarriers and the 1 KB the card keeps for
  each block, fit an SM; the ring is the deepest that fits the budget, at
  most half the block's stages where it holds four or more, at least two.
* Each block holds at least twice its ring's depth in stages wherever its
  split holds four stages or more.
* The word box as TMA lands it (four groups of 32 columns in the 128-byte
  swizzle) and the consumer warps' columns (``d_col``): every column of the
  block once, and every A-fragment word read (fp4: word row 4 kb + t; fp8:
  8 kb + 4 j + t) hits 32 banks.
* The x box (rows of 128 bytes in the same swizzle): each lane's bytes are
  the k its fragment takes, and the ragged body's plan still covers the
  unfolded shapes at M <= 64.
* ``fp4_pair_e4`` (codes e and e + 4 of a word to bf16x2 by one multiply,
  one mask and one bf16x2 multiply by 2^126) gives every fp4 code's value
  and sign exactly, for every word pattern of the pair.

The kernel itself is checked on the card (tests/test_torch_mx_kernels.py).
"""

import math
import struct

import pytest

from gemlite_tpu_torch.ops import mx

SM_SMEM = 228 * 1024          # an SM's shared memory on the H100
RESERVED = 1024               # what the card keeps for each block
STATIC = 8 * 2 * mx.DECODE_MAX_STAGES + 4   # the mbarriers and the last-block flag
SMS = 132
# Llama-3-8B's four shapes, its fused wqkv and gate_up, tiny_en_5m's four
SHAPES = [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336), (6144, 4096),
          (28672, 4096), (256, 256), (128, 256), (768, 256), (256, 768)]
MS = [1, 7, 8, 16, 33, 64]
KINDS = {"fp4": 0, "e4m3": 1, "e5m2": 2}
X_BYTES = {"bf16": 2, "e4m3": 1}

shapes = pytest.mark.parametrize("N,K", SHAPES)
kinds = pytest.mark.parametrize("kind", sorted(KINDS))


def layout_bytes(kind: int, x_bytes: int, rows: int, stages: int) -> int:
    """DLayout, region by region from a 1024-byte aligned base."""
    xb = rows * 128 * x_bytes
    wb = 128 // (8 if kind == 0 else 4) * 128 * 4
    for i in range(stages):
        for box in range(128 * x_bytes // 128):
            assert (i * xb + box * rows * 128) % 1024 == 0     # each x box
    w = stages * xb
    for i in range(stages):
        for grp in range(4):
            assert (w + i * wb + grp * wb // 4) % 1024 == 0    # each 32-column group
    s = w + stages * wb
    assert s % 128 == 0
    ring = s + stages * 4 * 128
    return max(ring, rows * 128 * 4) + 1024


def swizzle_128b(byte: int) -> int:
    """CU_TENSOR_MAP_SWIZZLE_128B on a byte offset from a 1024-byte aligned
    base: bits 4-6 XORed with bits 7-9."""
    return byte ^ (((byte >> 7) & 7) << 4)


def d_col(w: int, g: int, i: int, h: int) -> int:
    return 32 * w + 16 * (g >> 2) + 8 * i + 4 * h + (g & 3)


def d_word(r: int, c: int, wr: int) -> int:
    return (c >> 5) * wr * 32 + r * 32 + ((((c >> 2) & 7) ^ (r & 7)) << 2) + (c & 3)


def d_x(rows: int, m: int, k: int, xb: int) -> int:
    per = 128 // xb
    kb = k % per * xb
    return k // per * rows * 128 + m * 128 + (((kb >> 4) ^ (m & 7)) << 4) + (kb & 15)


@pytest.mark.parametrize("x", sorted(X_BYTES))
@kinds
@shapes
def test_whole_waves_and_one_split_at_every_m(x, kind, N, K):
    plans = [mx.decode_plan(M, N, K, KINDS[kind], X_BYTES[x]) for M in MS]
    p = plans[0]
    blocks = p.tiles * p.splits
    assert p.tiles == N // 128 and p.launches == 1
    waves = -(-p.tiles // mx.DECODE_RESIDENT)
    assert mx.DECODE_RESIDENT == mx.DECODE_BLOCKS * SMS
    assert blocks <= waves * mx.DECODE_RESIDENT
    assert 2 * blocks > mx.DECODE_RESIDENT or p.splits == max(1, K // mx.BK // 2)
    for q in plans + [mx.decode_plan(8, N, K, 1 - KINDS[kind] % 2, 3 - X_BYTES[x])]:
        assert (q.tiles, q.splits, q.k_per_split) == (p.tiles, p.splits, p.k_per_split)
    ranges = [(s * p.k_per_split, min(K, (s + 1) * p.k_per_split)) for s in range(p.splits)]
    assert p.k_per_split % mx.BK == 0 and ranges[0][0] == 0 and ranges[-1][1] == K
    assert all(a < b for a, b in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(p.splits - 1))


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("x", sorted(X_BYTES))
@kinds
@shapes
def test_ring_fits_three_blocks_an_sm(M, x, kind, N, K):
    k, xb = KINDS[kind], X_BYTES[x]
    p = mx.decode_plan(M, N, K, k, xb)
    rows = -(-M // 8) * 8
    assert p.smem == mx.decode_smem(k, xb, M, p.stages) == layout_bytes(k, xb, rows, p.stages)
    assert mx.DECODE_BLOCKS * (p.smem + STATIC + RESERVED) <= SM_SMEM
    assert p.smem - 1024 <= mx.DECODE_BUDGET
    assert 2 <= p.stages <= mx.DECODE_MAX_STAGES
    per = p.k_per_split // mx.BK
    if per >= 4:       # at least twice the ring's depth in stages
        assert per >= 2 * p.stages
    else:
        assert p.stages <= max(2, per)
    deeper = p.stages + 1
    assert (deeper > mx.DECODE_MAX_STAGES or (per >= 4 and 2 * deeper > per) or deeper > per
            or layout_bytes(k, xb, rows, deeper) - 1024 > mx.DECODE_BUDGET)


def test_the_8b_mlp_shapes_keep_about_half_a_stage_ring_of_weights_in_flight():
    """At 14336 x 4096 (fp4 codes, M 8, bf16 x) the plan's 336 blocks fill
    85% of one wave of 396 with 11 stages each and a ring of 5 (43.5 KB of
    words and scales a block in flight, about 110-130 KB an SM)."""
    p = mx.decode_plan(8, 14336, 4096, 0, 2)
    assert (p.tiles, p.splits, p.k_per_split, p.stages) == (112, 3, 1408, 5)
    q = mx.decode_plan(8, 4096, 14336, 0, 2)
    assert (q.tiles, q.splits, q.k_per_split, q.stages) == (32, 12, 1280, 5)


@kinds
def test_word_box_and_columns_hit_32_banks(kind):
    """Every column of the block once across the four warps' A rows; every
    word read of a product (a fixed m16 tile i and half h) lands the 32
    lanes on 32 banks, as TMA swizzles the box."""
    wr = 128 // (8 if KINDS[kind] == 0 else 4)
    cols = sorted(d_col(w, g, i, h) for w in range(4) for g in range(8) for i in range(2)
                  for h in range(2))
    assert cols == list(range(128))
    # the box as TMA lands it: group c // 32, row r, 128-byte rows, swizzled
    for r in range(wr):
        for c in range(128):
            plain = (c >> 5) * wr * 128 + r * 128 + (c & 31) * 4
            assert swizzle_128b(plain) == 4 * d_word(r, c, wr)
    for w in range(4):
        for i in range(2):
            for h in range(2):
                for kb in range(4):
                    for j in range(2):
                        banks = set()
                        for lane in range(32):
                            g, t = lane >> 2, lane & 3
                            r = 4 * kb + t if KINDS[kind] == 0 else 8 * kb + 4 * j + t
                            banks.add(d_word(r, d_col(w, g, i, h), wr) % 32)
                        assert len(banks) == 32


@pytest.mark.parametrize("x", sorted(X_BYTES))
@pytest.mark.parametrize("rows", [8, 16, 64])
def test_x_box_offsets(x, rows):
    """Byte (m, k) of a stage's x as TMA lands it (boxes of 128-byte rows in
    the 128-byte swizzle, two boxes of 64 k for bf16) is d_x's offset, and
    the 16-byte piece a bf16 / fp4 lane reads (k 8t .. 8t + 7) is whole."""
    xb = X_BYTES[x]
    per = 128 // xb
    for m in range(rows):
        for k in range(0, 128, 2):
            plain = k // per * rows * 128 + m * 128 + (k % per) * xb
            assert swizzle_128b(plain) == d_x(rows, m, k, xb)
    if xb == 2:
        for m in range(rows):
            for kb in range(4):
                for t in range(4):
                    base = d_x(rows, m, 32 * kb + 8 * t, 2)
                    assert base % 16 == 0
                    assert [d_x(rows, m, 32 * kb + 8 * t + e, 2) for e in range(8)] == \
                        [base + 2 * e for e in range(8)]


@pytest.mark.parametrize("M", [1, 8, 64])
@pytest.mark.parametrize("N,K", [(960, 960), (320, 960), (2560, 960), (960, 2560),
                                 (2880, 2880), (37, 224)])
def test_ragged_body_keeps_its_plan(M, N, K):
    """The general entry's M <= 64 form stays on the ragged cp.async body,
    with the parent's split: ceil(N / 128) tiles, whole 128-deep stages
    that cover K (the last may end inside one), a ring of 2-6 stages."""
    p = mx.general_plan(M, N, K, False)
    d = mx.ragged_decode_plan(M, N, K)
    assert p.body == "decode" and p.tiles_n == d.tiles == -(-N // 128)
    assert (p.splits, p.k_per_split, p.stages) == (d.splits, d.k_per_split, d.stages)
    assert 2 <= p.stages <= mx.MAX_STAGES and p.k_per_split % mx.BK == 0
    assert (p.splits - 1) * p.k_per_split < K <= p.splits * p.k_per_split


FP4 = [0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0]


def _bf16(bits: int) -> float:
    return struct.unpack("<f", struct.pack("<I", bits << 16))[0]


@pytest.mark.parametrize("e", range(4))
def test_fp4_pair_decode_is_exact(e):
    """csrc/mx_gemm.cu fp4_pair_e4: ((word >> 4e) & 0x000F000F) * 0x1040,
    masked to the magnitude and sign bits, then times 2^126 (a bf16x2
    multiply whose product is exact, so float arithmetic gives its bits)."""
    for lo in range(16):
        for hi in range(16):
            for rest in (0x00000000, 0xFFFFFFFF, 0x5A5A5A5A):
                word = (rest & ~((0xF << (4 * e)) | (0xF << (4 * e + 16)))) & 0xFFFFFFFF
                word |= lo << (4 * e) | hi << (4 * e + 16)
                u = (word >> (4 * e)) & 0x000F000F
                r = (u * 0x1040) & 0xFFFFFFFF & 0x81C081C0
                for half, code in ((r & 0xFFFF, lo), (r >> 16, hi)):
                    got = _bf16(half) * 2.0 ** 126
                    want = FP4[code & 7]
                    assert abs(got) == want and (math.copysign(1, got) < 0) == bool(code & 8)
