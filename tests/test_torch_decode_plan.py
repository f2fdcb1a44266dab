# SPDX-License-Identifier: Apache-2.0
"""The W1/W2/W4 decode kernel's plan (``ops/decode.py``) and arithmetic
(``csrc/decode_gemv.cu``, emulated here in torch), on the CPU.

* ``plan`` at the four Llama-3-8B linear shapes and ragged ones, for M in
  {1, 3, 8, 16, 17, 33, 64} and 1, 2 and 4 bits: the column tiles cover N,
  the K ranges cover K on group boundaries and in whole stage pairs, the
  split does not depend on M, every call is one launch, the ring fits the
  kernel's shared memory, and the workspace is what the split needs.
* The lane-to-k permutation inside each 32-deep block (``lane_k``) is a
  bijection, and the codes each lane takes from the stored words, directly
  and through the kernel's pair building (``lane_pairs``), are the plain
  unpacking's codes at those k.
* The bf16x2 dequantization (``dequant_bf16x2``: 0x4300 | q, then two fmas,
  each one rounding of an exact result) equals ``dequantize_ref`` for every
  code, random scales and zeros, zeros far smaller and far larger than q * s.
* The permuted product on stored words (``decode_matmul_emulated``) equals
  ``forward_meta`` within float32 rounding of a K-term sum.
The kernel itself is checked on the card (tests/test_torch_kernels.py).
"""

import math

import numpy as np
import pytest
import torch

from gemlite_tpu_torch import DType, GemLiteLinear
from gemlite_tpu_torch.ops import decode as mod
from gemlite_tpu_torch.ops.reference import dequantize_ref, forward_meta, unpack_rows_ref

SHAPES = ((4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336))   # (N, K)
FUSED_SHAPES = ((6144, 4096), (28672, 4096))   # wqkv and gate_up of quantize_llama(fuse=True)
RAGGED = ((256, 512), (200, 256), (132, 96))
MS = (1, 3, 8, 16, 17, 33, 64)
# (N, K, gs): the 8B shapes at gs 128, ragged shapes, and groups that are
# not whole stages (8, 24, 48 at W4; 16 at W2; 256 for all)
CASES = [(N, K, 128) for N, K in SHAPES] + [(256, 512, 128), (200, 256, 64), (132, 96, 32)] + \
        [(256, 768, 24), (256, 1536, 48), (200, 512, 8), (256, 512, 16), (1024, 4096, 256)] + \
        [(N, K, 128) for N, K in FUSED_SHAPES]
# the cases the gate admits: gs a multiple of 8 and of the codes per word
PLAN_CASES = [(N, K, gs, bits) for N, K, gs in CASES for bits in (1, 2, 4)
              if gs % max(8, 32 // bits) == 0 and K % gs == 0]


# ---- the kernel's arithmetic, emulated ----

def lane_k(bits: int):
    """For lane (g, t) of the kernel, mma j (0, 1) and element f (0..3) of
    its fragments (logical k 2t, 2t + 1, 2t + 8, 2t + 9 of the m16n8k16
    step), the physical k inside the 32-deep block and where that code is
    stored: (k, word row inside the block, bit shift). The lane takes codes
    8t .. 8t + 7 and pairs code c with c + 4, so element (j, f) is code
    2j + f // 2 + 4 (f % 2). Returns a dict {(t, j, f): (k, row, shift)}."""
    epw = 32 // bits
    out = {}
    for t in range(4):
        row, shift = (8 * t) // epw, bits * ((8 * t) % epw)
        for j in range(2):
            for f in range(4):
                code = 2 * j + f // 2 + 4 * (f % 2)
                out[(t, j, f)] = (8 * t + code, row, shift + bits * code)
    return out


def _from_bits(b: torch.Tensor) -> torch.Tensor:
    return (b & 0xFFFF).to(torch.int32).to(torch.int16).view(torch.bfloat16)


def dequant_bf16x2(codes: torch.Tensor, s: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The kernel's dequantization of codes (any shape, 0..15) with bf16
    scales and zeros of the same shape: 128 + q built as the bf16 bits 0x4300
    | q, fma(128 + q, s, -128 s) and fma(t, 1, z), each an exact result
    rounded once to bf16 (exact in float64 here, then one rounding: float64
    holds each exact result, or rounds it with 53 >= 2 * 8 + 2 bits, which
    leaves the bf16 rounding correct)."""
    v = _from_bits(0x4300 | codes.to(torch.int32)).double()
    s64, z64 = s.double(), z.double()
    m = (s64 * -128.0).to(torch.bfloat16).double()           # -128 s, exact
    t = (v * s64 + m).to(torch.bfloat16)                     # one rounding of q * s
    return (t.double() + z64).to(torch.bfloat16)             # one rounding of t + z


def lane_pairs(word: torch.Tensor, bits: int, t: int):
    """The four code pairs of lane t as the kernel builds them from its word
    (int64 values of uint32 words): shifted to the lane's 8 codes, spread so
    that code c sits 16 bits above code c - 4, then pair e = (u >> bits e) &
    mask | 0x43004300. Returns [(low, high)] * 4: the codes of each half."""
    epw = 32 // bits
    u = word >> (bits * ((8 * t) % epw))
    if bits == 2:
        u = (u & 0xFF) | ((u & 0xFF00) << 8)
    elif bits == 1:
        u = (u & 0xF) | ((u & 0xF0) << 12)
    mask2 = ((1 << bits) - 1) * 0x00010001
    pairs = []
    for e in range(4):
        v = ((u >> (bits * e)) & mask2) | 0x43004300
        pairs.append(((v & 0xFFFF) - 0x4300, (v >> 16) - 0x4300))
    return pairs


def decode_matmul_emulated(x, W_q, scales, zeros, meta) -> torch.Tensor:
    """out (M, N) float32 = x @ dequant(W_q) the kernel's way, on stored words:
    each 32-deep block's codes built lane by lane into pairs (``lane_pairs``),
    dequantized by ``dequant_bf16x2``, placed in the fragments' logical k
    order (``lane_k``), against x paired the same way, in 16-deep products
    with sums in float32 (one split, no tail)."""
    bits, gs, K, N = meta.W_nbits, meta.group_size, meta.in_features, meta.out_features
    epw = 32 // bits
    words = W_q.to(torch.int64) & 0xFFFFFFFF
    xf = x.to(torch.float32)
    out = torch.zeros((x.shape[0], N), dtype=torch.float32)
    lanes = lane_k(bits)
    for k0 in range(0, K, 32):
        for j in range(2):
            a = torch.empty((16, N), dtype=torch.bfloat16)   # A^T: logical k x columns
            xb = torch.empty((x.shape[0], 16), dtype=torch.float32)
            for t in range(4):
                pairs = lane_pairs(words[k0 // epw + (8 * t) // epw], bits, t)
                for f in range(4):
                    k = lanes[(t, j, f)][0]
                    codes = pairs[2 * j + f // 2][f % 2]      # pair e feeds mma e // 2
                    g = (k0 + k) // gs
                    logical = 2 * t + (f & 1) + 8 * (f >> 1)
                    a[logical] = dequant_bf16x2(codes, scales[g], zeros[g])
                    xb[:, logical] = xf[:, k0 + k]
            out = out + xb @ a.to(torch.float32)
    return out


# ---- the tests ----

@pytest.mark.parametrize("N,K,gs,bits", PLAN_CASES)
def test_plan_covers_the_shape_and_ignores_M(N, K, gs, bits):
    plans = {M: mod.plan(M, N, K, gs, bits) for M in MS}
    assert len({(p.splits, p.k_per_split) for p in plans.values()}) == 1
    for M, p in plans.items():
        assert p.tile == 128
        assert (p.tiles - 1) * p.tile < N <= p.tiles * p.tile
        assert (p.splits - 1) * p.k_per_split < K <= p.splits * p.k_per_split
        assert p.k_per_split % gs == 0
        assert p.splits == 1 or p.k_per_split % (2 * mod.BK) == 0
        assert p.launches == 1
        assert 2 <= p.stages <= mod.MAX_STAGES and M * p.tile * 4 <= p.smem <= mod.SMEM_MAX
        assert p.smem <= mod.SMEM_BUDGET or p.stages == 2      # small groups at large M
        assert p.mrows >= -(-mod.BK // gs) and (p.mrows == 1 or gs < mod.BK)
        want = (0, 0) if p.splits == 1 else (p.splits * M * N, p.tiles)
        assert mod.workspace(M, N, p) == want
    p = plans[8]
    if (N, K) in SHAPES:
        # about four blocks an SM, all in one wave
        assert p.splits * p.tiles <= 4 * mod.SMS
        assert p.splits * p.tiles >= 2 * mod.SMS or p.k_per_split == 2 * mod.BK


def test_plan_splits_at_the_8b_shapes():
    got = {(N, K): mod.plan(8, N, K, 128, 4).splits for N, K in SHAPES}
    assert got == {(4096, 4096): 16, (1024, 4096): 16, (14336, 4096): 4, (4096, 14336): 14}


def test_plan_splits_at_the_fused_8b_shapes():
    """The scan path's fused stacks: wqkv in 8 splits of 512 (48 column
    tiles), gate_up in 3 of 1536 (224 tiles: 672 blocks, past the four an SM
    the plan aims at, since it rounds the split count up)."""
    got = {(N, K): mod.plan(8, N, K, 128, 4)[:3] for N, K in FUSED_SHAPES}
    assert got == {(6144, 4096): (48, 8, 512), (28672, 4096): (224, 3, 1536)}


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_lane_map_is_a_bijection_on_each_block(bits):
    lanes = lane_k(bits)
    epw = 32 // bits
    assert sorted(k for k, _, _ in lanes.values()) == list(range(32))
    for (t, j, f), (k, row, shift) in lanes.items():
        # the lane's 8 codes, code c paired with c + 4 in one register
        assert k == 8 * t + 2 * j + f // 2 + 4 * (f % 2)
        assert row * epw + shift // bits == k and shift % bits == 0 and shift < 32
    # each mma's 16 logical k (2t, 2t + 1, 2t + 8, 2t + 9 over t) once
    logical = {(j, 2 * t + (f & 1) + 8 * (f >> 1)) for t, j, f in lanes}
    assert len(logical) == 32


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_lanes_take_the_stored_codes(bits):
    K, N = 256, 24
    rng = np.random.default_rng(bits)
    words = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, size=(K * bits // 32, N),
                                          dtype=np.int64).astype(np.int32))
    codes = unpack_rows_ref(words, bits, 32 // bits, K).to(torch.int64)
    w64 = words.to(torch.int64) & 0xFFFFFFFF
    epw = 32 // bits
    for k0 in range(0, K, 32):
        for (t, j, f), (k, row, shift) in lane_k(bits).items():
            got = (w64[k0 // epw + row] >> shift) & ((1 << bits) - 1)
            assert torch.equal(got, codes[k0 + k]), (k0, t, j, f)
            # the kernel's pairs (shift, spread, mask) hold the same code
            pair = lane_pairs(w64[k0 // epw + row], bits, t)[2 * j + f // 2][f % 2]
            assert torch.equal(pair, codes[k0 + k]), (k0, t, j, f)


def _bf16(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("zeros", ["hqq", "tiny", "huge", "mixed"])
def test_dequant_bf16x2_equals_the_reference(zeros):
    """Every code 0..15 against random scales over many binades and zeros of
    the kind named: HQQ's -z * s, zeros 2^-30 of q * s (the add rounds q * s
    alone), 2^20 of it (the add keeps the zero), and a mix with signs."""
    rng = np.random.default_rng(7)
    N = 512
    codes = torch.arange(16).reshape(16, 1).expand(16, N).contiguous()
    s = _bf16(np.broadcast_to(rng.uniform(0.5, 2.0, N) * 2.0 ** rng.integers(-14, 5, N), (16, N)))
    sf = s.float().numpy()
    z = {"hqq": -rng.integers(0, 16, (16, N)) * sf,
         "tiny": rng.uniform(-1, 1, (16, N)) * sf * 2.0 ** -30,
         "huge": rng.uniform(-1, 1, (16, N)) * sf * 2.0 ** 20,
         "mixed": rng.uniform(-1, 1, (16, N)) * sf * 2.0 ** rng.integers(-24, 12, (16, N))}[zeros]
    z = _bf16(z)
    got = dequant_bf16x2(codes, s, z)
    want = dequantize_ref(codes.to(torch.uint8), s, z, W_group_mode=4, meta_dtype=DType.BF16)
    assert got.dtype == want.dtype == torch.bfloat16
    assert torch.equal(got.float(), want.float())


def _layer(bits, N, K, gs, seed):
    rng = np.random.default_rng(seed)
    W_q = rng.integers(0, 2 ** bits, size=(N, K)).astype(np.uint8)
    scales = (rng.uniform(0.5, 1.5, size=(N * K // gs, 1)) * 2.0 ** -6).astype(np.float32)
    zeros = rng.integers(0, 2 ** bits, size=(N * K // gs, 1)).astype(np.float32)
    return GemLiteLinear(bits, gs, K, N, DType.BF16, DType.BF16, device="cpu").pack(
        torch.from_numpy(W_q), torch.from_numpy(scales).to(torch.bfloat16),
        torch.from_numpy(zeros).to(torch.bfloat16))


@pytest.mark.parametrize("M", [1, 8, 17])
@pytest.mark.parametrize("bits,gs", [(4, 16), (4, 128), (2, 16), (1, 32), (4, 24), (4, 48),
                                     (2, 96)])
def test_emulated_product_matches_forward_meta(bits, gs, M):
    N, K = 40, 256 if 256 % gs == 0 else 768
    layer = _layer(bits, N, K, gs, seed=bits * 100 + gs + M)
    x = torch.from_numpy((np.random.default_rng(M).normal(size=(M, K)) * 0.5).astype(np.float32))
    x = x.to(torch.bfloat16)
    args = (layer.W_q, layer.scales, layer.zeros)
    meta = layer.meta._replace(output_dtype=DType.FP32.value)
    got = decode_matmul_emulated(x, *args, meta)
    want = forward_meta(x, *args, None, meta)
    # float32 sums of K terms in two orders: each within K * 2^-24 of sum |x w|
    w = dequantize_ref(unpack_rows_ref(layer.W_q, bits, 32 // bits, K), layer.scales,
                       layer.zeros, W_group_mode=4, meta_dtype=DType.BF16).float()
    bound = K * 2.0 ** -24 * (x.float().abs() @ w.abs())
    assert got.shape == want.shape == (M, N)
    assert bool(((got - want).abs() <= bound).all())
    assert math.isfinite(float(got.abs().max()))
