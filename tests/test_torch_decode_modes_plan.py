# SPDX-License-Identifier: Apache-2.0
"""The mode 1-3 decode kernel's plan (``ops/decode.modes_plan``,
``modes_smem``) and its TMA layouts (``m_col``, ``m_word``, ``m_x`` and the
``Lane`` offsets in ``csrc/decode_modes.cu``), on the CPU.

* The grid fits whole waves of ``MODES_RESIDENT`` blocks (three an SM, the
  launch bounds'), at the Llama-3-8B shapes, the fused wqkv / gate_up
  shapes and tiny_en_5m's shapes: one wave wherever the column tiles fit
  it, and at least half a wave unless every split already holds the least
  two stages.
* Its split is the same at every M <= 64 and for bf16 and e4m3 x, covers K
  exactly in whole stages, each split a whole number of groups.
* Its shared memory is the kernel's ``Layout`` written out below (each slot
  TMA fills in the 128-byte swizzle 1024-byte aligned), and three blocks of
  it, with their static mbarriers and the 1 KB the card keeps for each
  block, fit an SM; the ring is the deepest the budget holds, at most half
  a split's stages where it holds four or more, at least two.
* The word box as TMA lands it, and the consumer lanes' reads of it: every
  column once across the warps, each 32-deep block's word at the lane's
  offset (``(w ^ X(kb)) + 32 RS kb``) equal to ``m_word``, and the distinct
  words of a read in distinct banks for W1, W2 and W4.
* The metadata box rows cover every group a stage touches at gs 24 / 32 /
  48 / 64 / 96 / 128 / 256 and K, and the kernel's group row (a shift for a
  power of two) equals floor division.
* e4m3 -> bf16 (through fp16 and float32) is exact for all 256 codes, and
  the byte pairs the e4m3 form builds are the bf16 form's.
* An emulated product through the landed stages and the lane map (codes,
  ``dequant_pair_shift``'s roundings, the split in split order, the float32
  epilogue) equals ``forward_f32_epilogue`` within float32 rounding.

The kernel itself is checked on the card (tests/test_torch_modes_kernels.py).
"""

import math

import numpy as np
import pytest
import torch

from gemlite_tpu_torch import DType, GemLiteLinear
from gemlite_tpu_torch.ops import decode
from gemlite_tpu_torch.ops.reference import forward_f32_epilogue, unpack_rows_ref

SM_SMEM = 228 * 1024          # an SM's shared memory on the H100
RESERVED = 1024               # what the card keeps for each block
STATIC = 8 * 2 * decode.MODES_MAX_STAGES + 4   # the mbarriers and the last-block flag
SMS = 132
BK = 128
# Llama-3-8B's four shapes, its fused wqkv and gate_up, tiny_en_5m's four
SHAPES = [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336), (6144, 4096),
          (28672, 4096), (256, 256), (128, 256), (768, 256), (256, 768)]
MS = [1, 7, 8, 16, 33, 64]
GROUPS = [32, 64, 128, 0]     # 0: gs = K (channel-wise)
X_BYTES = {"bf16": 2, "e4m3": 1}


class Meta:
    """The fields of a layer's meta that modes_plan reads."""

    def __init__(self, N, K, gs, bits):
        self.out_features, self.in_features, self.group_size, self.W_nbits = N, K, gs or K, bits


def layout_bytes(bits, x_bytes, rows, stages, mrows, once):
    """Layout, region by region from a 1024-byte aligned base."""
    xb = rows * BK * x_bytes
    wb = BK * bits // 32 * 128 * 4
    for i in range(stages):
        for box in range(BK * x_bytes // 128):
            assert (i * xb + box * rows * 128) % 1024 == 0     # each x box
    w = stages * xb
    for i in range(stages):
        assert (w + i * wb) % 1024 == 0                         # each word box
        if bits > 1:
            for grp in range(4):                                # the 2-d boxes
                assert (w + i * wb + grp * wb // 4) % 1024 == 0
    m = w + stages * wb
    mb = 2 * mrows * 128 * 2
    for i in range(1 if once else stages):
        assert (m + i * mb) % 128 == 0 and (m + i * mb + mb // 2) % 128 == 0
    ring = m + (1 if once else stages) * mb
    return max(ring, rows * 128 * 4) + 1024


def swizzle_128b(byte):
    """CU_TENSOR_MAP_SWIZZLE_128B on a byte offset from a 1024-byte aligned
    base: bits 4-6 XORed with bits 7-9."""
    return byte ^ (((byte >> 7) & 7) << 4)


def m_col(w, g, i, h):
    return 32 * w + 16 * (g >> 2) + 8 * i + 4 * h + (g & 3)


def m_word(wr, r, c):
    R = (c >> 5) * wr + r
    return R * 32 + ((((c >> 2) & 7) ^ (R & 7)) << 2) + (c & 3)


def m_x(rows, m, k, xb):
    per = 128 // xb
    kb = k % per * xb
    return k // per * rows * 128 + m * 128 + (((kb >> 4) ^ (m & 7)) << 4) + (kb & 15)


def lane_word(bits, w, g, t, i, h, kb):
    """The word index lane (g, t) of warp w reads for A row (i, h) in 32-deep
    block kb, as the kernel computes it from its fixed offset."""
    epw = 32 // bits
    rs = 32 // epw
    w0 = m_word(128 // epw, 8 * t // epw, m_col(w, g, i, h))
    return (w0 ^ (((rs * kb) & 7) << 2)) + 32 * rs * kb


def groups_touched(gs, K, p):
    """Every (stage, group rows it touches) of the plan's splits."""
    for s in range(p.splits):
        k_begin = s * p.k_per_split
        k_end = min(K, k_begin + p.k_per_split)
        for k0 in range(k_begin, k_end, BK):
            yield k0, {k // gs - k0 // gs for k in range(k0, min(k0 + BK, k_end), 8)}


@pytest.mark.parametrize("x", sorted(X_BYTES))
@pytest.mark.parametrize("bits", [1, 2, 4])
@pytest.mark.parametrize("gs", GROUPS)
@pytest.mark.parametrize("N,K", SHAPES)
def test_whole_waves_and_one_split_at_every_m(x, bits, gs, N, K):
    plans = [decode.modes_plan(M, Meta(N, K, gs, bits), X_BYTES[x]) for M in MS]
    p = plans[0]
    gs = gs or K
    blocks = p.tiles * p.splits
    assert p.tiles == -(-N // 128) and p.launches == 1
    waves = -(-p.tiles // decode.MODES_RESIDENT)
    assert decode.MODES_RESIDENT == decode.MODES_BLOCKS * SMS
    assert blocks <= waves * decode.MODES_RESIDENT
    unit = BK if gs == K else math.lcm(gs, BK)
    least = max(2 * BK, unit)
    assert 2 * blocks > decode.MODES_RESIDENT or p.k_per_split <= least or p.splits == 1
    other = decode.modes_plan(8, Meta(N, K, gs, bits), 3 - X_BYTES[x])
    for q in plans + [other]:
        assert (q.tiles, q.splits, q.k_per_split, q.mrows, q.once) == \
            (p.tiles, p.splits, p.k_per_split, p.mrows, p.once)
    ranges = [(s * p.k_per_split, min(K, (s + 1) * p.k_per_split)) for s in range(p.splits)]
    assert p.k_per_split % BK == 0 and ranges[0][0] == 0 and ranges[-1][1] == K
    assert all(a < b for a, b in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(p.splits - 1))
    assert p.k_per_split % unit == 0
    assert p.splits == 1 or p.k_per_split >= 2 * BK
    assert p.once == (gs == K)
    assert decode.modes_workspace(8, N, p) == ((0, 0) if p.splits == 1 else
                                               (p.splits * 8 * N, p.tiles))


# (bits, gs) the gate admits: gs a multiple of 8 and of the codes per word
RING_FORMS = [(bits, gs) for bits in (1, 2, 4) for gs in (24, 32, 64, 128, 0)
              if gs % max(8, 32 // bits) == 0]


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("x", sorted(X_BYTES))
@pytest.mark.parametrize("bits,gs", RING_FORMS)
@pytest.mark.parametrize("N,K", [(4096, 4096), (14336, 4096), (4096, 14336), (256, 768)])
def test_ring_fits_three_blocks_an_sm(M, x, bits, gs, N, K):
    if gs and K % gs:
        gs = math.gcd(gs, K)
    xb = X_BYTES[x]
    p = decode.modes_plan(M, Meta(N, K, gs, bits), xb)
    rows = -(-M // 8) * 8
    assert p.smem == decode.modes_smem(bits, xb, M, p.stages, p.mrows, p.once) == \
        layout_bytes(bits, xb, rows, p.stages, p.mrows, p.once)
    assert decode.MODES_BLOCKS * (p.smem + STATIC + RESERVED) <= SM_SMEM
    assert p.smem - 1024 <= decode.MODES_BUDGET
    assert 2 <= p.stages <= decode.MODES_MAX_STAGES
    assert p.mrows <= decode.MODES_MAX_META_ROWS
    per = p.k_per_split // BK
    if per >= 4:       # at least twice the ring's depth in stages
        assert per >= 2 * p.stages
    else:
        assert p.stages <= max(2, per)
    deeper = p.stages + 1
    assert (deeper > decode.MODES_MAX_STAGES or (per >= 4 and 2 * deeper > per) or deeper > per
            or layout_bytes(bits, xb, rows, deeper, p.mrows, p.once) - 1024 > decode.MODES_BUDGET)


def test_the_8b_mlp_shapes_fill_one_wave():
    """At 14336 x 4096 (A8W4 gs 64, M 8) 336 blocks of one wave of 396, 11
    stages each; at 4096 x 14336 384 blocks of 10 stages."""
    p = decode.modes_plan(8, Meta(14336, 4096, 64, 4), 1)
    assert (p.tiles, p.splits, p.k_per_split, p.mrows) == (112, 3, 1408, 2)
    q = decode.modes_plan(8, Meta(4096, 14336, 64, 4), 1)
    assert (q.tiles, q.splits, q.k_per_split) == (32, 12, 1280)


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_word_box_and_lane_reads_hit_distinct_banks(bits):
    """Every column of the block once across the four warps' A rows; the box
    as TMA lands it (four groups of WR rows of 128 bytes in the 128-byte
    swizzle from a 1024-byte aligned base) puts word (r, c) at m_word; each
    lane's word of block kb from its fixed offset is m_word's at its row;
    and the distinct words of every read land on distinct banks."""
    epw = 32 // bits
    wr = 128 // epw
    cols = sorted(m_col(w, g, i, h) for w in range(4) for g in range(8) for i in range(2)
                  for h in range(2))
    assert cols == list(range(128))
    for r in range(wr):
        for c in range(128):
            plain = (c >> 5) * wr * 128 + r * 128 + (c & 31) * 4
            assert swizzle_128b(plain) == 4 * m_word(wr, r, c)
            if bits > 1:       # a 2-d box of 32 columns at a 1024-byte aligned offset
                grp = (c >> 5) * wr * 128
                assert grp + swizzle_128b(r * 128 + (c & 31) * 4) == 4 * m_word(wr, r, c)
    for w in range(4):
        for i in range(2):
            for h in range(2):
                for kb in range(4):
                    words = {}
                    for lane in range(32):
                        g, t = lane >> 2, lane & 3
                        row = (32 * kb + 8 * t) // epw
                        got = lane_word(bits, w, g, t, i, h, kb)
                        assert got == m_word(wr, row, m_col(w, g, i, h))
                        words[got] = got % 32
                    assert len(set(words.values())) == len(words)


@pytest.mark.parametrize("gs,K", [(24, 768), (32, 1024), (48, 1536), (64, 4096), (96, 768),
                                  (128, 4096), (256, 4096), (4096, 4096), (64, 2112),
                                  (2112, 2112)])
def test_metadata_rows_cover_each_stage(gs, K):
    """The stage's box of mrows group rows from row k0 // gs holds every
    group its k touch, and the kernel's group row (a shift for a power of
    two) is floor division."""
    for bits in (1, 2, 4):
        if gs % max(8, 32 // bits):
            continue
        p = decode.modes_plan(8, Meta(1024, K, gs, bits))
        for k0, rows in groups_touched(gs, K, p):
            assert max(rows) < p.mrows and min(rows) == 0
            if gs & (gs - 1) == 0:
                shift = gs.bit_length() - 1
                for k in range(k0, min(k0 + BK, K), 8):
                    assert (k >> shift) - (k0 >> shift) == k // gs - k0 // gs


@pytest.mark.parametrize("x", sorted(X_BYTES))
@pytest.mark.parametrize("rows", [8, 16, 64])
def test_x_box_offsets(x, rows):
    """Byte (m, k) of a stage's x as TMA lands it is m_x's offset, and the
    piece a lane reads (k 8t .. 8t + 7: 16 bytes of bf16, 8 of e4m3) is
    whole and aligned."""
    xb = X_BYTES[x]
    per = 128 // xb
    for m in range(rows):
        for k in range(128):
            plain = k // per * rows * 128 + m * 128 + (k % per) * xb
            assert swizzle_128b(plain) == m_x(rows, m, k, xb)
        for kb in range(4):
            for t in range(4):
                base = m_x(rows, m, 32 * kb + 8 * t, xb)
                assert base % (8 * xb) == 0
                assert [m_x(rows, m, 32 * kb + 8 * t + e, xb) for e in range(8)] == \
                    [base + xb * e for e in range(8)]


def test_e4m3_to_bf16_is_exact_for_every_code():
    """Every e4m3 code through fp16 and float32 to bf16 (the kernel's
    e4m3x2_bf16x2) keeps its value: NaN stays NaN, the rest round trip."""
    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(torch.float8_e4m3fn)
    f = codes.to(torch.float32)
    via = codes.to(torch.float16).to(torch.float32).to(torch.bfloat16).to(torch.float32)
    nan = torch.isnan(f)
    assert int(nan.sum()) == 2
    assert bool(torch.isnan(via[nan]).all())
    assert torch.equal(via[~nan], f[~nan])


def _byte_perm(a, b, sel):
    both = a | (b << 32)
    return sum(((both >> (8 * ((sel >> (4 * i)) & 7))) & 0xFF) << (8 * i) for i in range(4))


def test_e4m3_pairs_match_the_bf16_pairs():
    """The e4m3 form's byte permutes (0x40, 0x51, 0x62, 0x73 of the lane's 8
    codes) pair x[e] with x[e + 4] as the bf16 form's (0x5410 / 0x7632 of
    the 16-byte piece) do."""
    codes = list(range(8))
    lo = sum(c << (8 * c) for c in codes[:4])
    hi = sum(c << (8 * (c - 4)) for c in codes[4:])
    e4 = [_byte_perm(lo, hi, sel) & 0xFFFF for sel in (0x40, 0x51, 0x62, 0x73)]
    got = [(v & 0xFF, v >> 8) for v in e4]
    words = [codes[2 * i] | (codes[2 * i + 1] << 16) for i in range(4)]   # bf16 "values" = k
    bf = [_byte_perm(words[0], words[2], 0x5410), _byte_perm(words[0], words[2], 0x7632),
          _byte_perm(words[1], words[3], 0x5410), _byte_perm(words[1], words[3], 0x7632)]
    want = [(v & 0xFFFF, v >> 16) for v in bf]
    assert got == want == [(0, 4), (1, 5), (2, 6), (3, 7)]


# ---- the product through the landed stages and the lane map, emulated ----

def _lanes(bits):
    """Every (warp, g, t, i, h) of a block as arrays, with its column and its
    fixed word offset and shift."""
    w, g, t, i, h = (a.ravel() for a in np.meshgrid(range(4), range(8), range(4), range(2),
                                                    range(2), indexing="ij"))
    return w, g, t, i, h, m_col(w, g, i, h)


def lane_codes(box, bits, kb, lanes):
    """The codes each lane builds from the landed word box in block kb: (k in
    the stage, column, code) arrays, by the kernel's shift, spread and mask."""
    w, g, t, i, h, c = lanes
    epw = 32 // bits
    rs = 32 // epw
    w0 = np.array([m_word(128 // epw, 8 * tt // epw, cc) for tt, cc in zip(t, c)])
    u = box[(w0 ^ (((rs * kb) & 7) << 2)) + 32 * rs * kb] >> (bits * ((8 * t) % epw))
    if bits == 2:
        u = (u & 0xFF) | ((u & 0xFF00) << 8)
    elif bits == 1:
        u = (u & 0xF) | ((u & 0xF0) << 12)
    ks, cs, qs = [], [], []
    for e in range(4):
        for half, kk in ((0, e), (16, e + 4)):
            ks.append(32 * kb + 8 * t + kk)
            cs.append(c)
            qs.append((u >> (bits * e + half)) & ((1 << bits) - 1))
    return np.concatenate(ks), np.concatenate(cs), np.concatenate(qs)


def emulate(x, W_q, scales, zeros, scales_x, meta, M):
    """out (M, N) float32 the kernel's way: each stage's words landed in the
    swizzled box (zeros past K or N), each lane's codes taken from its word
    at its offset by the kernel's shift, spread and mask (and checked against
    the stored codes), each weight (q - z) rounded to bf16, then times s
    rounded to bf16; float32 sums a split, the partials added in split order,
    then the csm scales in float32."""
    bits, gs, K, N = meta.W_nbits, meta.group_size, meta.in_features, meta.out_features
    mode, csm = meta.W_group_mode, meta.channel_scale_mode
    epw = 32 // bits
    wr = BK // epw
    p = decode.modes_plan(M, meta)
    words = (W_q.to(torch.int64) & 0xFFFFFFFF).numpy()
    codes_ref = unpack_rows_ref(W_q, bits, epw, K).to(torch.int64).numpy()
    Np = p.tiles * 128
    one = torch.ones((K // gs, N), dtype=torch.bfloat16)
    s_rows = one if mode == 1 else scales.reshape(K // gs, N).to(torch.bfloat16)
    if mode == 2:
        z_rows = one * 0
    elif meta.zero_is_scalar:
        z_rows = one * float(zeros)
    else:
        z_rows = zeros.reshape(K // gs, N).to(torch.bfloat16)
    lanes = _lanes(bits)
    slot = np.array([[m_word(wr, r, c) for c in range(128)] for r in range(wr)])
    parts = []
    for s in range(p.splits):
        k_begin, k_end = s * p.k_per_split, min(K, (s + 1) * p.k_per_split)
        acc = torch.zeros((M, Np), dtype=torch.float32)
        for k0 in range(k_begin, k_end, BK):
            for n0 in range(0, Np, 128):
                box = np.zeros(wr * 128, dtype=np.int64)          # the landed word box
                rows = min(wr, K // epw - k0 // epw)
                cols = min(128, N - n0)
                box[slot[:rows, :cols]] = words[k0 // epw:k0 // epw + rows, n0:n0 + cols]
                q = torch.zeros((BK, 128), dtype=torch.int64)
                for kb in range(4):
                    if k0 + 32 * kb >= k_end:
                        break
                    ks, cs, qs = lane_codes(box, bits, kb, lanes)
                    q[ks, cs] = torch.from_numpy(qs)
                depth, n1 = min(BK, k_end - k0), min(n0 + 128, N)
                qv = q[:depth, :n1 - n0]
                assert torch.equal(qv, torch.from_numpy(codes_ref[k0:k0 + depth, n0:n1]))
                grp = torch.arange(k0, k0 + depth) // gs
                d = (qv.to(torch.float32) - z_rows[grp, n0:n1].float()).to(torch.bfloat16)
                wdeq = (d.float() * s_rows[grp, n0:n1].float()).to(torch.bfloat16)
                prod = x[:, k0:k0 + depth].double() @ wdeq.double()
                acc[:, n0:n1] = (acc[:, n0:n1].double() + prod).float()
        parts.append(acc[:, :N])
    out = parts[0]
    if p.splits > 1:
        out = torch.zeros((M, N), dtype=torch.float32)
        for part in parts:
            out = out + part
    if csm in (2, 3):
        out = out * scales_x.reshape(-1, 1).to(torch.float32)
    if csm in (1, 3):
        out = out * scales.reshape(1, -1).to(torch.float32)
    return out


def _layer(bits, gs, K, N, mode, seed):
    from gemlite_tpu_torch.helper import A16Wn
    from gemlite_tpu_torch.quant import quantize_int_weights
    rng = np.random.default_rng(seed)
    if mode == "cw_post":
        w = torch.from_numpy((rng.normal(size=(N, K)) * 0.02).astype(np.float32))
        W_q, s, z = quantize_int_weights(w, bits, K)
        return A16Wn(device="cpu", dtype=torch.bfloat16, post_scale=True).from_weights(
            W_q, s, z, bits, K)
    W_q = torch.from_numpy(rng.integers(0, 2 ** bits, size=(N, K)).astype(np.uint8))
    G = N * K // gs
    s = torch.from_numpy((rng.uniform(0.5, 1.5, size=(G, 1)) * 2.0 ** -6).astype(np.float32))
    z = torch.from_numpy(rng.integers(0, 2 ** bits, size=(G, 1)).astype(np.float32) + 0.25)
    layer = GemLiteLinear(bits, gs, K, N, DType.BF16, DType.BF16, device="cpu")
    if mode == 2:
        return layer.pack(W_q, s.to(torch.bfloat16), None)
    if mode == "scalar":
        return layer.pack(W_q, s.to(torch.bfloat16), 2 ** (bits - 1))
    return layer.pack(W_q, s.to(torch.bfloat16), z.to(torch.bfloat16), fma_mode=False)


@pytest.mark.parametrize("bits,gs,K,N,mode,M", [
    (4, 64, 512, 256, 3, 8), (4, 32, 384, 128, 3, 3), (2, 64, 512, 160, 3, 8),
    (1, 128, 768, 128, 3, 1), (4, 128, 256, 128, 2, 17), (2, 128, 512, 128, "scalar", 8),
    (4, 64, 576, 128, 3, 8), (4, 0, 1024, 256, "cw_post", 8), (2, 0, 512, 128, "cw_post", 33)])
def test_emulated_product_matches_forward_f32_epilogue(bits, gs, K, N, mode, M):
    layer = _layer(bits, gs, K, N, mode, seed=bits * 100 + gs + M)
    meta = layer.meta._replace(output_dtype=DType.FP32.value)
    assert meta.W_group_mode in (1, 2, 3) and meta.group_size == (gs or K)
    x = torch.from_numpy((np.random.default_rng(M).normal(size=(M, K)) * 0.5).astype(np.float32))
    x = x.to(torch.bfloat16)
    args = (layer.W_q, layer.scales, layer.zeros, None)
    got = emulate(x, *args, meta, M)
    want = forward_f32_epilogue(x, *args, meta)
    unscaled = meta._replace(channel_scale_mode=0)
    w = forward_f32_epilogue(torch.eye(K, dtype=torch.bfloat16), *args, unscaled).abs()
    bound = 2 * K * 2.0 ** -24 * (x.float().abs() @ w)
    if meta.channel_scale_mode in (1, 3):
        bound = bound * layer.scales.reshape(1, -1).float().abs() + want.abs() * 2.0 ** -23
    assert got.shape == want.shape == (M, N)
    assert bool(((got - want).abs() <= bound + 1e-30).all())
    assert math.isfinite(float(got.abs().max()))
