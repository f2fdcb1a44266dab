# SPDX-License-Identifier: Apache-2.0
"""The W1/W2/W4 prefill kernel's plan (``ops/prefill.py``) and arithmetic
(``csrc/prefill_gemm.cu``, emulated here in torch), on the CPU.

* ``plan`` at the four Llama-3-8B linear shapes and ragged ones, for M from
  65 to 4095 and 1, 2 and 4 bits: the column tiles, row tiles and K ranges
  cover the shape once, every 64-deep stage lies inside one group, every
  call is one launch, the ring fits the kernel's shared memory, the split is
  the one of least modelled time, and the workspace is what the split needs.
* The lane-to-k map inside each 16-deep step (``lane_code``: natural k
  order, the mma.sync A fragment) takes the stored codes, and the kernel's
  pair building (``code_pair``: a byte permute for W4, shifts for W2 and W1)
  gives the bf16x2 128 + q of those codes.
* The pairs dequantized by the kernel's two bf16x2 fmas equal
  ``dequantize_ref`` bit for bit, for every code and for HQQ, tiny, huge and
  mixed zeros.
* The product built from stored words the kernel's way, split and merged in
  split order (``prefill_matmul_emulated``), equals ``forward_meta`` within
  float32 rounding of a K-term sum.
The kernel itself is checked on the card (tests/test_torch_kernels.py).
"""

import math

import numpy as np
import pytest
import torch

from gemlite_tpu_torch import DType, GemLiteLinear
from gemlite_tpu_torch.ops import prefill as mod
from gemlite_tpu_torch.ops.reference import dequantize_ref, forward_meta, unpack_rows_ref
from test_torch_decode_plan import _bf16, dequant_bf16x2

SHAPES = ((4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336))   # (N, K)
MS = (65, 100, 128, 129, 200, 256, 1000, 1024, 2048, 4095)
# (N, K, gs): the 8B shapes at gs 128, ragged shapes, groups of 64 and 256
CASES = [(N, K, 128) for N, K in SHAPES] + \
        [(256, 512, 128), (200, 256, 64), (129, 1024, 256), (130, 192, 64), (1, 64, 64)]
PLAN_CASES = [(N, K, gs, bits) for N, K, gs in CASES for bits in mod.PREFILL_BITS]


# ---- the kernel's arithmetic, emulated ----

def lane_code(bits: int, t: int, kk: int, half: int):
    """Where lane t's pair of register ``2 half + h`` in the 16-deep step kk
    lies, as the kernel computes it: (word row in the stage, bit shift of the
    lower code). The pair holds k = 16 kk + 8 half + 2t and k + 1."""
    epw = 32 // bits
    kl = 16 * kk + 8 * half
    return kl // epw, bits * (kl % epw) + 2 * bits * t


def byte_perm(x: torch.Tensor, y: torch.Tensor, sel: int) -> torch.Tensor:
    """CUDA's __byte_perm(x, y, sel) on int64 tensors of uint32 values (the
    selector's nibbles 0..7, no sign replication)."""
    out = torch.zeros_like(x)
    for i in range(4):
        s = (sel >> (4 * i)) & 7
        src = x if s < 4 else y
        out |= ((src >> (8 * (s % 4))) & 0xFF) << (8 * i)
    return out


def code_pair(w: torch.Tensor, bits: int, shift: int, t: int) -> torch.Tensor:
    """The kernel's bf16x2 bits 0x4300 | q of the pair (as int64)."""
    if bits == 4:
        sel = t | (t + 4) << 8
        return (byte_perm(w, w >> 4, sel) & 0x000F000F) | 0x43004300
    m = (1 << bits) - 1
    y = w >> shift
    return (y & m) | (((y << (16 - bits)) & 0xFFFFFFFF) & (m << 16)) | 0x43004300


def _halves(v: torch.Tensor):
    return (v & 0xFFFF) - 0x4300, (v >> 16) - 0x4300


def stage_a(words: torch.Tensor, bits: int, s: torch.Tensor, z: torch.Tensor, kk: int):
    """A^T (16, N) bf16 of one 16-deep step of a stage, built lane by lane:
    ``words`` the stage's word rows (int64, (64 / epw, N)), s and z the
    stage's group row (N,) bf16."""
    a = torch.empty((16, words.shape[1]), dtype=torch.bfloat16)
    for t in range(4):
        for half in range(2):
            row, shift = lane_code(bits, t, kk, half)
            lo, hi = _halves(code_pair(words[row], bits, shift, t))
            k = 8 * half + 2 * t
            a[k] = dequant_bf16x2(lo, s, z)
            a[k + 1] = dequant_bf16x2(hi, s, z)
    return a


def prefill_matmul_emulated(x, W_q, scales, zeros, meta, splits: int) -> torch.Tensor:
    """out (M, N) float32 = x @ dequant(W_q) the kernel's way on stored words:
    each split sums its 64-deep stages of 16-deep products in float32; the
    partials are added in split order."""
    bits, gs, K, N = meta.W_nbits, meta.group_size, meta.in_features, meta.out_features
    epw = 32 // bits
    words = W_q.to(torch.int64) & 0xFFFFFFFF
    xf = x.to(torch.float32)
    steps = K // mod.BK
    per = -(-steps // splits)
    parts = []
    for sp in range(splits):
        acc = torch.zeros((x.shape[0], N), dtype=torch.float32)
        for st in range(sp * per, min(steps, (sp + 1) * per)):
            k0 = st * mod.BK
            w = words[k0 // epw:(k0 + mod.BK) // epw]
            g = k0 // gs
            for kk in range(4):
                a = stage_a(w, bits, scales[g], zeros[g], kk)
                acc = acc + xf[:, k0 + 16 * kk:k0 + 16 * kk + 16] @ a.to(torch.float32)
        parts.append(acc)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


# ---- the plan ----

@pytest.mark.parametrize("N,K,gs,bits", PLAN_CASES)
def test_plan_covers_the_shape(N, K, gs, bits):
    for M in MS:
        p = mod.plan(M, N, K, gs, bits)
        assert p.tile == 128 and p.bm == (128 if M <= 128 else 256)
        assert (p.tiles_n - 1) * p.tile < N <= p.tiles_n * p.tile
        assert (p.tiles_m - 1) * p.bm < M <= p.tiles_m * p.bm
        assert (p.splits - 1) * p.k_per_split < K <= p.splits * p.k_per_split
        assert p.k_per_split % mod.BK == 0
        # every stage of every split lies inside one group: one group row a stage
        for sp in range(p.splits):
            for k0 in range(sp * p.k_per_split, min(K, (sp + 1) * p.k_per_split), mod.BK):
                assert k0 // gs == (k0 + mod.BK - 1) // gs
        assert p.mrows == 1 and p.launches == 1
        assert p.blocks == p.tiles_n * p.tiles_m * p.splits
        assert 2 <= p.stages <= mod.MAX_STAGES
        assert p.smem == mod.smem_bytes(p.bm, bits, p.stages) <= mod.SMEM_MAX
        want = (0, 0) if p.splits == 1 else (p.splits * M * N, p.tiles_n * p.tiles_m)
        assert mod.workspace(M, N, p) == want


@pytest.mark.parametrize("M", [65, 128, 129, 1024, 2048, 4095])
@pytest.mark.parametrize("N,K", SHAPES + ((200, 256),))
def test_plan_takes_the_least_modelled_time(N, K, M):
    """The split is the least ``estimate_us`` over every split count that
    cuts K into whole stages (ties to fewer splits), and the ring is the
    deepest that fits."""
    p = mod.plan(M, N, K, 128, 4)
    tiles, steps = p.tiles_n * p.tiles_m, K // mod.BK
    cuts = [s for s in range(1, steps + 1) if -(-steps // -(-steps // s)) == s]
    est = {s: mod.estimate_us(M, N, tiles, steps, s, p.bm) for s in cuts}
    best = min(est.values())
    assert est[p.splits] == best
    assert p.splits == min(s for s in cuts if est[s] == best)
    assert p.k_per_split == -(-steps // p.splits) * mod.BK
    deeper = mod.smem_bytes(p.bm, 4, p.stages + 1)
    assert p.stages == mod.MAX_STAGES or deeper > mod.SMEM_MAX


def test_plan_at_the_8b_shapes():
    """At M 128 every 8B shape runs in one wave of one block an SM; from M
    1024 on the large shapes need no split."""
    got = {(N, K, M): (mod.plan(M, N, K, 128, 4).splits, mod.plan(M, N, K, 128, 4).blocks)
           for N, K in SHAPES for M in (128, 1024, 2048)}
    for (N, K, M), (splits, blocks) in got.items():
        if M == 128:
            assert blocks <= mod.SMS
        if M >= 1024 and N * K >= 4096 * 4096:
            assert splits == 1, (N, K, M)


def test_prefill_takes_w1_w2_w4_mode4_only():
    from gemlite_tpu_torch.ops.prefill import can_use_prefill
    for bits in mod.PREFILL_BITS:
        layer = _layer(bits, 64, 256, 64, seed=bits)
        assert can_use_prefill(layer.meta, 65) and can_use_prefill(layer.meta, 4095)
        assert not can_use_prefill(layer.meta, 64) and not can_use_prefill(layer.meta, 4096)
    # groups that are no multiple of 64 would straddle a stage
    assert not can_use_prefill(_layer(4, 64, 256, 32, seed=0).meta, 128)
    assert not can_use_prefill(_layer(4, 64, 256, 128, seed=0, fma=False).meta, 128)


# ---- the lanes and the bf16x2 build ----

@pytest.mark.parametrize("bits", [1, 2, 4])
def test_lane_map_takes_the_stored_codes(bits):
    """Each pair of each lane, as the kernel addresses it, holds the codes at
    k and k + 1 in natural order, and the 4 lanes x 2 halves x 2 codes of a
    16-deep step cover its 16 k once."""
    K, N = 256, 24
    rng = np.random.default_rng(bits)
    words = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, size=(K * bits // 32, N),
                                          dtype=np.int64).astype(np.int32))
    codes = unpack_rows_ref(words, bits, 32 // bits, K).to(torch.int64)
    w64 = words.to(torch.int64) & 0xFFFFFFFF
    epw = 32 // bits
    for k0 in range(0, K, mod.BK):
        for kk in range(4):
            seen = []
            for t in range(4):
                for half in range(2):
                    row, shift = lane_code(bits, t, kk, half)
                    k = k0 + 16 * kk + 8 * half + 2 * t
                    assert row * epw + (shift // bits) == k - k0
                    w = w64[k0 // epw + row]
                    for i in range(2):
                        got = (w >> (shift + bits * i)) & ((1 << bits) - 1)
                        assert torch.equal(got, codes[k + i]), (k0, kk, t, half, i)
                        seen.append(k + i - k0 - 16 * kk)
                    lo, hi = _halves(code_pair(w, bits, shift, t))
                    assert torch.equal(lo, codes[k]) and torch.equal(hi, codes[k + 1])
            assert sorted(seen) == list(range(16))


@pytest.mark.parametrize("zeros", ["hqq", "tiny", "huge", "mixed"])
@pytest.mark.parametrize("bits", [1, 2, 4])
def test_built_pairs_dequantize_as_the_reference(bits, zeros):
    """Every code through the kernel's pair build and its two bf16x2 fmas,
    against random scales over many binades and zeros of the kind named:
    HQQ's -z * s, zeros 2^-30 of q * s, 2^20 of it, and a mix with signs."""
    rng = np.random.default_rng(11 + bits)
    N = 512
    n_codes = 2 ** bits
    # one word per column holding code c at every slot: the pair at any
    # lane is (c, c)
    c = torch.arange(N) % n_codes
    word = torch.zeros(N, dtype=torch.int64)
    for slot in range(32 // bits):
        word |= c << (bits * slot)
    s = _bf16(rng.uniform(0.5, 2.0, N) * 2.0 ** rng.integers(-14, 5, N))
    sf = s.float().numpy()
    z = {"hqq": -rng.integers(0, n_codes, N) * sf,
         "tiny": rng.uniform(-1, 1, N) * sf * 2.0 ** -30,
         "huge": rng.uniform(-1, 1, N) * sf * 2.0 ** 20,
         "mixed": rng.uniform(-1, 1, N) * sf * 2.0 ** rng.integers(-24, 12, N)}[zeros]
    z = _bf16(z)
    want = dequantize_ref(c.to(torch.uint8), s, z, W_group_mode=4, meta_dtype=DType.BF16)
    for t in range(4):
        for half in range(2):
            _, shift = lane_code(bits, t, 0, half)
            lo, hi = _halves(code_pair(word, bits, shift, t))
            for q in (lo, hi):
                got = dequant_bf16x2(q, s, z)
                assert torch.equal(got.float(), want.float())


# ---- the product ----

def _layer(bits, N, K, gs, seed, fma=True):
    rng = np.random.default_rng(seed)
    W_q = rng.integers(0, 2 ** bits, size=(N, K)).astype(np.uint8)
    scales = (rng.uniform(0.5, 1.5, size=(N * K // gs, 1)) * 2.0 ** -6).astype(np.float32)
    zeros = rng.integers(0, 2 ** bits, size=(N * K // gs, 1)).astype(np.float32)
    return GemLiteLinear(bits, gs, K, N, DType.BF16, DType.BF16, device="cpu").pack(
        torch.from_numpy(W_q), torch.from_numpy(scales).to(torch.bfloat16),
        torch.from_numpy(zeros).to(torch.bfloat16), fma_mode=fma)


@pytest.mark.parametrize("M", [65, 130])
@pytest.mark.parametrize("bits,gs,K,splits", [(4, 64, 256, 1), (4, 128, 512, 3), (2, 64, 256, 2),
                                              (2, 256, 512, 1), (1, 64, 384, 4),
                                              (1, 128, 256, 2)])
def test_emulated_product_matches_forward_meta(bits, gs, K, splits, M):
    N = 40
    layer = _layer(bits, N, K, gs, seed=bits * 100 + gs + M + splits)
    x = torch.from_numpy((np.random.default_rng(M).normal(size=(M, K)) * 0.5).astype(np.float32))
    x = x.to(torch.bfloat16)
    args = (layer.W_q, layer.scales, layer.zeros)
    meta = layer.meta._replace(output_dtype=DType.FP32.value)
    got = prefill_matmul_emulated(x, *args, meta, splits)
    want = forward_meta(x, *args, None, meta)
    # float32 sums of K terms in two orders: each within K * 2^-24 of sum |x w|
    w = dequantize_ref(unpack_rows_ref(layer.W_q, bits, 32 // bits, K), layer.scales,
                       layer.zeros, W_group_mode=4, meta_dtype=DType.BF16).float()
    bound = K * 2.0 ** -24 * (x.float().abs() @ w.abs())
    assert got.shape == want.shape == (M, N)
    assert bool(((got - want).abs() <= bound).all())
    assert math.isfinite(float(got.abs().max()))
