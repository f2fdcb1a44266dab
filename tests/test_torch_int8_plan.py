# SPDX-License-Identifier: Apache-2.0
"""The int8 decode kernel's plan (``ops/int8_decode.plan``) and the paged
decode kernel's live splits (``ops/attention.paged_live_splits``), on the CPU.

* Row 4: at the four Llama-3-8B linear shapes and M in {1, 8, 33, 64}, and at
  ragged shapes, the column tiles cover N, the K ranges cover K in whole
  128-deep steps or whole groups (a float-group range never cuts a group),
  a float-group plan does not depend on M, an integer plan splits no
  further than the last block's partials allow, every call is one launch,
  and the workspace is what the split needs.
* The kernel turns the weights K-major in natural k order (the byte
  permutes of ``csrc/int8_decode.cu:to_kmajor``, emulated here on the stored
  words): the result equals the plain unpacking for every weight kind, so the
  int32 sums are those of ``int8_decode_plain``.
* Paged decode: the live splits of a slot follow its length, and the plan
  its table's width alone.
The kernels themselves are checked on the card (tests/test_torch_kernels.py).
"""

import math

import numpy as np
import pytest
import torch

from gemlite_tpu_torch import DType, GemLiteLinear
from gemlite_tpu_torch.ops import attention, int8_decode as mod
from gemlite_tpu_torch.ops.reference import unpack_rows_ref

SHAPES = ((4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336))   # (N, K)
MS = (1, 8, 33, 64)
RAGGED = ((256, 512), (200, 256), (1024, 4064), (4, 32), (132, 96))
GROUPS = (0, 16, 20, 24, 48, 128, 256)
CASES = [(N, K, 0) for N, K in SHAPES + RAGGED] + \
        [(N, K, gs) for N, K in ((4096, 4096), (1024, 4096), (256, 1920)) for gs in GROUPS
         if gs and K % gs == 0] + [(256, 640, 20), (256, 768, 24)]

# splits per (N, K) without groups at M 8 and 64: about three blocks per SM
# in one wave, and at M 64 no more than 4 partials of 64 rows a column tile
SPLITS = {(4096, 4096): (11, 4), (1024, 4096): (32, 4), (14336, 4096): (3, 3),
          (4096, 14336): (12, 4)}


@pytest.mark.parametrize("N,K,gs", CASES)
def test_plan_tiles_cover_the_columns(N, K, gs):
    p = mod.plan(64, N, K, gs)
    assert (p.tiles - 1) * mod.BN < N <= p.tiles * mod.BN
    assert p.launches == 1


@pytest.mark.parametrize("N,K,gs,float_groups",
                         [c + (False,) for c in CASES] + [c + (True,) for c in CASES if c[2]])
def test_plan_k_ranges_cover_k_in_whole_steps_or_groups(N, K, gs, float_groups):
    for M in MS:
        p = mod.plan(M, N, K, gs, float_groups)
        ranges = [(s * p.k_per_split, min(K, (s + 1) * p.k_per_split)) for s in range(p.splits)]
        assert ranges[0][0] == 0 and ranges[-1][1] == K
        assert all(a < b for a, b in ranges)              # no empty range: every block arrives
        unit = math.lcm(gs, mod.BK) if gs else mod.BK
        assert all(a % unit == 0 for a, _ in ranges)      # whole steps, whole groups
        if gs:
            assert all(a % gs == 0 and b % gs == 0 for a, b in ranges)
        assert p.k_per_split % 16 == 0                    # x copies stay 16-byte aligned
        per_sm = mod.FGROUP_BLOCKS_PER_SM if float_groups else mod.BLOCKS_PER_SM
        assert p.tiles * p.splits <= max(p.tiles, per_sm * mod.SMS)   # one wave


@pytest.mark.parametrize("N,K", SHAPES)
def test_plan_splits_at_the_8b_shapes(N, K):
    assert (mod.plan(8, N, K, 0).splits, mod.plan(64, N, K, 0).splits) == SPLITS[(N, K)]


@pytest.mark.parametrize("N,K,gs", CASES)
def test_plan_sum_step_fits_the_groups(N, K, gs):
    """32-deep mma steps where groups are whole 32s, 16 where whole 16s,
    else the 4-deep __dp4a step; every step divides the group."""
    sk = mod.plan(8, N, K, gs).sk
    assert sk == (32 if gs % 32 == 0 else 16 if gs % 16 == 0 else 4)
    assert gs % sk == 0


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("N,K,gs", CASES)
def test_plan_depends_on_shape_only_and_workspace(M, N, K, gs):
    """A float-group plan is the same at every M (so the float32 group order
    never depends on the batch); an integer plan splits no more at a larger
    M, and its last block adds at most PARTIAL_WORDS partials (or there is
    one split); the scratch a split call needs."""
    if gs:
        fp = mod.plan(M, N, K, gs, float_groups=True)
        assert all(mod.plan(m, N, K, gs, float_groups=True) == fp for m in MS)
    p = mod.plan(M, N, K, gs)
    assert all(mod.plan(M, N, K, gs) == p for _ in range(2))
    assert all(mod.plan(m, N, K, gs).splits >= p.splits for m in MS if m <= M)
    assert p.splits == 1 or p.splits * (-(-M // 8) * 8) * mod.BN <= mod.PARTIAL_WORDS
    words, counters = mod.workspace(M, N, p)
    if p.splits == 1:
        assert (words, counters) == (0, 0)
    else:
        assert (words, counters) == (p.splits * M * N, p.tiles)


# ---------------------------------------------------------------------------
# the K-major turn in natural k order (to_kmajor's byte permutes)
# ---------------------------------------------------------------------------

def byte_perm(a, b, sel):
    """CUDA __byte_perm(a, b, sel) on uint32 arrays (selector nibbles 0-7)."""
    src = [(a >> (8 * i)) & 0xFF for i in range(4)] + [(b >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros_like(a)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << (8 * i)
    return out


def kmajor(W, kind, K):
    """(K, N) int8 in natural k order, from the stored weights, as to_kmajor
    builds it: a 4 x 4 byte transpose of int8 rows; W8 words ^ 0x80; W4 / W2
    words unpacked by masks, shifts and byte permutes."""
    W = W.numpy()
    if kind == "i8_dense":
        K4, N = K // 4, W.shape[1]
        assert N % 4 == 0
        r = [W[j::4].view(np.uint8).reshape(K4, N // 4, 4).copy().view(np.uint32)[..., 0]
             .astype(np.uint32) for j in range(4)]          # rows k = 4g + j, 4 columns a word
        a, b = byte_perm(r[0], r[1], 0x5140), byte_perm(r[2], r[3], 0x5140)
        c, d = byte_perm(r[0], r[1], 0x7362), byte_perm(r[2], r[3], 0x7362)
        cols = [byte_perm(a, b, 0x5410), byte_perm(a, b, 0x7632),
                byte_perm(c, d, 0x5410), byte_perm(c, d, 0x7632)]  # column 4q + j: 4 k
        words = np.stack(cols, axis=-1).reshape(K4, N)      # [k / 4][n]
    else:
        w = W.view(np.uint32).astype(np.uint32)
        if kind == "u8_packed":
            words = w ^ np.uint32(0x80808080)
        elif kind == "nibble4":
            lo, hi = w & np.uint32(0x0F0F0F0F), (w >> 4) & np.uint32(0x0F0F0F0F)
            words = np.stack([byte_perm(lo, hi, 0x5140), byte_perm(lo, hi, 0x7362)], axis=1)
            words = words.reshape(-1, w.shape[1])
        else:
            t = [(w >> (2 * i)) & np.uint32(0x03030303) for i in range(4)]
            p01, p23 = byte_perm(t[0], t[1], 0x5140), byte_perm(t[2], t[3], 0x5140)
            q01, q23 = byte_perm(t[0], t[1], 0x7362), byte_perm(t[2], t[3], 0x7362)
            words = np.stack([byte_perm(p01, p23, 0x5410), byte_perm(p01, p23, 0x7632),
                              byte_perm(q01, q23, 0x5410), byte_perm(q01, q23, 0x7632)], axis=1)
            words = words.reshape(-1, w.shape[1])
    b = words[:, None, :] >> (8 * np.arange(4, dtype=np.uint32))[None, :, None]
    return torch.from_numpy((b & 0xFF).astype(np.uint8).reshape(K, -1).view(np.int8))


@pytest.mark.parametrize("nbits,kind", [(8, "i8_dense"), (8, "u8_packed"), (4, "nibble4"),
                                        (2, "nibble2")])
def test_kmajor_turn_is_natural_k_order(nbits, kind):
    """The K-major tile holds code - off8 in natural k order for every weight
    kind, so the kernel's x . w sums are the plain version's int32 sums."""
    N, K = 64, 256
    rng = np.random.default_rng(nbits)
    if kind == "i8_dense":
        W_q = torch.from_numpy(rng.integers(-128, 128, (K, N)).astype(np.int8))
        codes, off8 = W_q.to(torch.int32), 0
    else:
        codes_nk = rng.integers(0, 2 ** nbits, (N, K)).astype(np.uint8)
        layer = GemLiteLinear(nbits, None, K, N, DType.INT8, DType.BF16, scaled_activations=True,
                              device="cpu").pack(codes_nk, np.ones((N, 1), np.float32), None)
        assert mod.w_kind(layer.meta) == kind
        W_q, off8 = layer.W_q, 128 if kind == "u8_packed" else 0
        codes = unpack_rows_ref(W_q, nbits, layer.meta.elements_per_sample, K).to(torch.int32)
    got = kmajor(W_q, kind, K).to(torch.int32)
    assert torch.equal(got, codes - off8)
    x = torch.from_numpy(rng.integers(-128, 128, (8, K)).astype(np.int64))
    assert torch.equal(x @ got.to(torch.int64) + off8 * x.sum(1, keepdim=True),
                       x @ codes.to(torch.int64))


# ---------------------------------------------------------------------------
# paged decode: live splits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pps", [1, 16, 17, 64, 128])
@pytest.mark.parametrize("ps", [16, 128])
def test_paged_live_splits_follow_the_length(pps, ps):
    splits, per = attention.paged_split_plan(pps)
    assert splits * per >= pps > (splits - 1) * per and splits <= 16
    span = per * ps
    for length in (1, ps - 1, ps, ps + 1, span, span + 1, pps * ps - 1, pps * ps, pps * ps + 5):
        live = attention.paged_live_splits(length, ps, pps)
        assert 1 <= live <= splits
        tokens = min(length, pps * ps)
        # the live splits hold every token, and each holds at least one
        assert (live - 1) * span < tokens <= live * span


def test_paged_plan_depends_on_the_table_width_only():
    for pps in (16, 64):
        plan = attention.paged_split_plan(pps)
        assert all(attention.paged_split_plan(pps) == plan for _ in range(3))
        assert attention.paged_live_splits(8191, 128, 64) == 16
        assert attention.paged_live_splits(2047, 128, 16) == 16
        assert attention.paged_live_splits(100, 128, pps) == 1
