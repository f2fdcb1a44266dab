# SPDX-License-Identifier: Apache-2.0
"""The general fused kernel's float path: its plan (``ops/fused.float_plan``)
and arithmetic (``csrc/fused_float.cu``, emulated here in numpy and torch), on
the CPU.

* ``float_plan`` at the four Llama-3-8B linear shapes and ragged ones, for M
  from 1 to 4095: the tiles cover the output, the K ranges cover K in whole
  128-deep stages, no split is shorter than ``MIN_SPLIT_STAGES`` stages, the
  plan is a function of M, N and K alone, and every call is one launch.
* The kernel's shared-memory maps: the raw weight tile's word swizzle and
  the x tile's unit placement are bijections that keep 16-byte pieces whole,
  and the reads of one warp instruction hit distinct banks.
* ``float_emulated`` runs the kernel block by block on stored weights: the
  ring stages' raw tiles, x tiles and group rows as the copies place them,
  each lane's reads (byte permutes of int8 rows, 16-bit halves, packed-word
  shifts), the metadata index of each lookup, the dequantization of each
  mode (the fma on a code in a float's mantissa, checked exact before its
  rounding; each op rounded as the plain version rounds it), the m16n8k16
  fragment map of A and B, the K split and its merge in split order, and
  the csm epilogue.
  Every weight the lanes build equals ``fused._dequant`` bit for bit at its
  (k, n), every x element its (m, k), and the product equals
  ``fused_matmul_plain`` within float32 rounding of a K-term sum, for every
  form the float path takes.
The kernel itself is checked on the card (tests/test_torch_kernels.py).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gemlite_tpu_torch import DType, GemLiteLinear
from gemlite_tpu_torch.helper import A16W158_INT, A16W8_INT8
from gemlite_tpu_torch.ops import build, fused as mod
from gemlite_tpu_torch.ops.fused import FloatPlan, float_plan, fused_matmul_plain
from gemlite_tpu_torch.ops.reference import unpack_rows_ref

BK, BN = mod.FLOAT_BK, mod.FLOAT_TILE_N
SHAPES = ((4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336))   # (N, K)
MS = (1, 2, 8, 9, 17, 64, 65, 128, 129, 1000, 1024, 2048, 4095)
PLAN_CASES = [(M, N, K) for N, K in SHAPES + ((256, 512), (200, 256), (129, 96), (1000, 640))
              for M in MS]

# the kernel's weight forms: k per element, bytes per element, bits, J
FORMS = {"i8": (1, 1, 8, 2), "w16": (1, 2, 16, 2), "w8": (4, 4, 8, 2), "w4": (8, 4, 4, 2),
         "w2": (16, 4, 2, 4), "w1": (32, 4, 1, 8)}
BIAS = {"i8": 32896.0, "w16": 0.0}                     # else 2^15


# ---- the plan ----

@pytest.mark.parametrize("M,N,K", PLAN_CASES)
def test_float_plan_covers_the_output_and_k(M, N, K):
    p = float_plan(M, N, K)
    assert p.nt == (1 if M <= 8 else 16) and p.bm == 8 * p.nt
    assert (p.tiles_m - 1) * p.bm < M <= p.tiles_m * p.bm
    assert (p.tiles_n - 1) * BN < N <= p.tiles_n * BN
    assert (p.splits - 1) * p.k_per_split < K <= p.splits * p.k_per_split
    assert p.launches == 1 and p.blocks == p.tiles_m * p.tiles_n * p.splits
    if p.splits > 1:
        assert p.k_per_split % BK == 0
        assert p.k_per_split // BK >= mod.MIN_SPLIT_STAGES
        assert p.tiles_m * p.tiles_n < mod.SMS
        assert p.blocks <= (4 if p.nt == 1 else 2) * mod.SMS
        assert p.splits * 8 * M <= K                     # partials below an int8 weight's bytes
    assert mod.float_workspace(M, N, p) == ((0, 0) if p.splits == 1 else
                                            (p.splits * M * N, p.tiles_m * p.tiles_n))


@pytest.mark.parametrize("M,N,K", PLAN_CASES)
def test_float_plan_depends_on_shape_only(M, N, K, monkeypatch):
    first = float_plan(M, N, K)
    monkeypatch.setattr(build, "_SPLIT_STATE", {"stale": None})
    assert isinstance(first, FloatPlan) and float_plan(M, N, K) == first


def test_float_plan_at_the_8b_shapes():
    """M 8 fills the card with light blocks of one token tile; from M 1024
    the large shapes' tiles fill it with no split."""
    assert float_plan(8, 14336, 4096) == FloatPlan(1, 1, 112, 4, 1024)
    assert float_plan(8, 4096, 4096).blocks == 256
    for N, K in SHAPES:
        if N * K >= 4096 * 4096:
            assert float_plan(1024, N, K).splits == 1
            assert float_plan(4095, N, K).splits == 1


# ---- shared-memory maps ----

def raw_word(form, r, w):
    """csrc/fused_float.cu raw_word: word w of stored row r of a stage."""
    e, eb, _, J = FORMS[form]
    rpl = 4 * J // e
    return r * (BN * eb // 4) + (w ^ (((r // rpl) & 3) << 3))


def x_unit(J, xb, m, u):
    """csrc/fused_float.cu x_unit: where 8-k unit u of x row m lands."""
    kb, r = u // (2 * J), u % (2 * J)
    t, pp = r // (J // 2), r % (J // 2)
    P = kb * 2 * J + 4 * pp + t
    return P ^ (((m & 1) << 2) if xb == 2 else ((m & 3) << 2))


@pytest.mark.parametrize("form", list(FORMS))
def test_raw_tile_swizzle(form):
    """A bijection on each row's words that moves whole 16-byte pieces, and
    the words of one lane read instruction (rows of lanes t = 0..3, the
    columns of lanes g = 0..7, in each warp) land in distinct banks within a
    read phase (32 lanes of 4 bytes, 16 of 8, 8 of 16)."""
    e, eb, _, J = FORMS[form]
    rows, rw = BK // e, BN * eb // 4
    phys = np.array([[raw_word(form, r, w) for w in range(rw)] for r in range(rows)])
    assert sorted(phys.ravel()) == list(range(rows * rw))
    assert ((phys[:, ::4] % 4) == 0).all() and (phys[:, 1::4] == phys[:, ::4] + 1).all()
    width = {1: 1, 2: 2, 4: 4}[eb]                   # words a lane reads
    lanes_per_phase = 32 // width
    for w in range(4):
        for kb in range(BK // (16 * J)):
            for j in range(J):
                for f in range(4 if e == 1 else 1):
                    banks = {}
                    for lane in range(32):
                        g, t = lane >> 2, lane & 3
                        kl = kb * 16 * J + 4 * J * t
                        r = kl + 4 * j + f if e == 1 else (kl // 4 + j if form == "w8" else kl // e)
                        col = (32 * w + 4 * g) * eb // 4
                        words = [phys[r, col] + i for i in range(width)]
                        banks.setdefault(lane // lanes_per_phase, []).extend(x % 32 for x in words)
                    for b in banks.values():
                        assert len(set(b)) == len(b), (form, w, kb, j, f)


@pytest.mark.parametrize("J", [2, 4, 8])
@pytest.mark.parametrize("xb", [2, 1])
def test_x_tile_placement(J, xb):
    """Units of each row are placed by a bijection; the lanes of a read phase
    (8 lanes of 16 bytes for 2-byte x, 16 of 8 bytes for int8 x) read
    distinct banks; lane t's pair pp is the unit of k 4 J t + 8 pp of its
    block."""
    for m in range(16):
        assert sorted(x_unit(J, xb, m, u) for u in range(16)) == list(range(16))
    ub = 8 * xb
    for kb in range(BK // (16 * J)):
        for pp in range(J // 2):
            for jj in range(2):
                phases = {}
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    m = 8 * jj + g
                    u = (kb * 16 * J + 4 * J * t + 8 * pp) // 8
                    P = x_unit(J, xb, m, u)
                    assert P == (kb * 2 * J + 4 * pp + t) ^ ((m & 1) << 2 if xb == 2 else (m & 3) << 2)
                    start = (m * 16 + P) * ub // 4            # word address
                    phase = lane // (8 if xb == 2 else 16)
                    phases.setdefault(phase, []).extend((start + i) % 32 for i in range(ub // 4))
                for b in phases.values():
                    assert len(set(b)) == len(b)


# ---- the emulated kernel ----

def _ct_round(v: torch.Tensor, ct) -> torch.Tensor:
    return v.to(torch.float32).to(ct).to(torch.float32)


def _form(meta):
    e, nbits = meta.elements_per_sample, meta.W_nbits
    if e == 1:
        return "i8" if nbits == 8 else "w16"
    return {8: "w8", 4: "w4", 2: "w2", 1: "w1"}[nbits]


def _stage_rows(gs, K):
    """csrc/fused_float.cu stage_rows: group rows a stage can touch."""
    rows = 1 if gs % BK == 0 else (BK // gs if BK % gs == 0 else BK // gs + 2)
    return min(rows, K // gs)


def _meta_q(form, gs_s, gs_z):
    """k that share one metadata lookup: a lane's run, a step, or one."""
    J = FORMS[form][3]
    if gs_s % (4 * J) == 0 and gs_z % (4 * J) == 0:
        return 4 * J
    return 4 if gs_s % 4 == 0 and gs_z % 4 == 0 else 1


def _raw_word_np(form, r, w):
    e, eb, _, J = FORMS[form]
    return r * (BN * eb // 4) + (w ^ (((r // (4 * J // e)) & 3) << 3))


# (w, g, t) index arrays of the 128 threads, and a fragment's k of a lane's value f
W_ = np.arange(4)[:, None, None]
G_ = np.arange(8)[None, :, None]
T_ = np.arange(4)[None, None, :]
KIDX = np.array([[2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9] for t in range(4)])   # [t][f]


def _lane_values(form, words, kl, j, col, w_dtype):
    """(w, g, t, column c, value f) float32: 2^15 + code (+ 128 for int8)
    for codes, the stored value for 16-bit weights, read as the lanes read
    them from the stage's words."""
    e, eb, bits, J = FORMS[form]
    out = np.zeros((4, 8, 4, 4, 4), np.float64)
    if form in ("i8", "w16"):
        for f in range(4):
            r = kl + 4 * j + f
            if form == "i8":
                word = words[_raw_word_np(form, r, col >> 2)].astype(np.int64)
                for c in range(4):
                    out[..., c, f] = 32768 + (((word >> (8 * c)) & 0xFF) ^ 0x80)
            else:
                base = _raw_word_np(form, r, col >> 1)
                for c in range(4):
                    half = (words[base + (c >> 1)].astype(np.int64) >> (16 * (c & 1))) & 0xFFFF
                    h16 = torch.from_numpy(half.astype(np.uint16).view(np.int16).copy())
                    out[..., c, f] = h16.view(w_dtype).to(torch.float64).numpy()
    else:
        row = kl // 4 + j if form == "w8" else kl // e
        base = _raw_word_np(form, row, col)
        for c in range(4):
            word = words[base + c].astype(np.int64)
            for f in range(4):
                sh = 8 * f if form == "w8" else bits * (4 * j + f)
                out[..., c, f] = 32768 + ((word >> sh) & ((1 << bits) - 1))
    return torch.from_numpy(out).to(torch.float32)


def _build_a(form, mode, v, s, z, zs, scalar, bias, ct):
    """csrc/fused_float.cu build_a<MODE>: one step's weights from the lane
    values, each rounded as dq_general rounds it; the products before their
    one rounding are checked exact in float32."""
    b = _ct_round(v, ct) if form == "w16" else v - bias
    m = b if form == "w16" else v

    def product():                                   # fma(m, s, -bias s): must be exact
        exact = m.double() * s.double() - bias * s.double()
        assert torch.equal(exact.float().double(), exact)
        return exact.float()
    if mode in (0, 2):
        d = product()
    elif mode == 1:
        d = b - z
    elif mode == 3:
        if scalar:
            raw = v if form == "w16" else b
            t = _ct_round((raw.to(torch.int32) - zs).to(torch.float32), ct)
        else:
            t = _ct_round(b - z, ct)
        d = t * s
    else:
        d = _ct_round(product(), ct) + z
    return _ct_round(d, ct)


def _dq_general(raw, mode, s, z, zs, scalar, ct):
    """csrc/fused_float.cu dq_general: every op rounded to ct."""
    b = _ct_round(raw, ct)
    if mode == 0:
        return b
    if mode == 1:
        return _ct_round(b - z, ct)
    if mode == 2:
        return _ct_round(b * s, ct)
    if mode == 3:
        if scalar:
            return _ct_round(_ct_round((raw.to(torch.int32) - zs).to(torch.float32), ct) * s, ct)
        return _ct_round(_ct_round(b - z, ct) * s, ct)
    return _ct_round(_ct_round(b * s, ct) + z, ct)


def float_emulated(x, W_q, scales, zeros, scales_x, meta, plan=None):
    """csm(x @ dequant(W_q)) the kernel's way, in the meta's output dtype.
    Also returns the weights the lanes built, (K, N), and the x they fed to
    the products, (M, K), float32; a position built twice must be equal."""
    M, K, N = x.shape[0], meta.in_features, meta.out_features
    plan = plan or float_plan(M, N, K)
    form = _form(meta)
    e, eb, bits, J = FORMS[form]
    bias, KB = BIAS.get(form, 32768.0), 16 * J
    ct = mod.compute_dtype(meta)
    mode = meta.W_group_mode
    scalar = bool(meta.zero_is_scalar)
    s_all = scales.reshape(-1, N) if mode >= 2 else None
    z_all = zeros.reshape(-1, N) if mode in (1, 3, 4) and not scalar else None
    gs_s = K // s_all.shape[0] if s_all is not None else K
    gs_z = K // z_all.shape[0] if z_all is not None else K
    srows = _stage_rows(gs_s, K) if s_all is not None else 0
    zrows = _stage_rows(gs_z, K) if z_all is not None else 0
    meta_q = _meta_q(form, gs_s, gs_z)
    zs = int(zeros.reshape(())) if scalar and mode in (1, 3) else 0
    xb = 1 if x.dtype == torch.int8 else 2
    wbytes = W_q.contiguous().view(torch.uint8).reshape(K // e, N * eb).numpy()
    xf = x.to(torch.float32)
    xrows = 8 * min(plan.nt, -(-M // 8))
    rows, rb = BK // e, BN * eb
    rr, bb = np.meshgrid(np.arange(rows), np.arange(rb), indexing="ij")
    raw_map = _raw_word_np(form, rr, bb >> 2) * 4 + (bb & 3)          # (row, byte) -> byte
    w_seen = torch.full((K, N), float("nan"))
    x_seen = torch.full((M, K), float("nan"))
    col = 32 * W_ + 4 * G_                                # the lane's first column in the block

    def record(seen, idx, vals):
        prev = seen[idx]
        assert bool((torch.isnan(prev) | (prev == vals)).all())
        seen[idx] = vals

    out = torch.zeros((M, N))
    for split in range(plan.splits):
        k_begin = split * plan.k_per_split
        k_end = min(K, k_begin + plan.k_per_split)
        part = torch.zeros((M, N))
        for tm in range(plan.tiles_m):
            m0 = tm * plan.bm
            nt = min(plan.nt, -(-(M - m0) // 8))
            for tn in range(plan.tiles_n):
                n0 = tn * BN
                acc = torch.zeros((4, 2, plan.nt, 16, 8))      # w, i, jj, A row, token
                for k0 in range(k_begin, k_end, BK):
                    # the stage as the copies place it
                    rv, cbv = min(rows, (k_end - k0) // e), min(rb, (N - n0) * eb)
                    smem = np.zeros(rows * rb, np.uint8)
                    smem[raw_map[:rv, :cbv]] = wbytes[k0 // e:k0 // e + rv, n0 * eb:n0 * eb + cbv]
                    words = smem.view(np.uint32)
                    xs = torch.zeros((plan.bm * 16, 8))   # rows past xrows: never read
                    for m in range(min(xrows, M - m0)):
                        for u in range(min(16, (k_end - k0) // 8)):
                            xs[m * 16 + x_unit(J, xb, m, u)] = xf[m0 + m, k0 + 8 * u:k0 + 8 * u + 8]

                    def staged(t_all, gs, nrows):
                        g0 = k0 // gs
                        gv = min(nrows, (k_end - 1) // gs - g0 + 1)
                        buf = torch.zeros((nrows, BN))
                        buf[:gv, :N - n0] = t_all[g0:g0 + gv, n0:n0 + BN].to(torch.float32)
                        return buf, g0
                    ss, gs0 = staged(s_all, gs_s, srows) if srows else (None, 0)
                    zsm, gz0 = staged(z_all, gs_z, zrows) if zrows else (None, 0)
                    cidx = torch.from_numpy(np.broadcast_to(col, (4, 8, 4)).copy())[..., None] + \
                        torch.arange(4)
                    for kb in range(BK // KB):
                        if k0 + kb * KB >= k_end:
                            break
                        kl = kb * KB + 4 * J * T_                # the lane's first k in the stage
                        s = torch.ones((4, 8, 4, 4))
                        z = torch.full((4, 8, 4, 4), float(_ct_round(torch.tensor(float(zs)), ct))
                                       if scalar else 0.0)

                        def lookup(kk):
                            nonlocal s, z
                            for buf, gs, g0, n in ((ss, gs_s, gs0, srows), (zsm, gs_z, gz0, zrows)):
                                if not n:
                                    continue
                                r = np.broadcast_to((k0 + kk) // gs - g0, (4, 8, 4))
                                assert r.min() >= 0 and r.max() < n
                                r = torch.from_numpy(r.copy())[..., None].expand(-1, -1, -1, 4)
                                v = _ct_round(buf[r, cidx], ct)
                                if buf is ss:
                                    s = v
                                else:
                                    z = v
                        if srows or zrows:
                            lookup(kl)
                        for pp in range(J // 2):
                            # the lanes' x of the pair: (jj, g, t, 8)
                            m = (8 * np.arange(plan.nt)[:, None, None] + G_[0][None])   # (nt, 8, 1)
                            P = (kb * 2 * J + 4 * pp + T_[0][None]) ^ \
                                (((m & 1) << 2) if xb == 2 else ((m & 3) << 2))
                            xv = _ct_round(xs[torch.from_numpy(m * 16 + P)], ct)
                            xv[nt:] = 0
                            kx = k0 + kl[0, 0][None, None, :, None] + 8 * pp + np.arange(8)
                            mx = m0 + m[..., None] + 0 * kx
                            ok = torch.from_numpy((mx < M) & (kx < k_end) &
                                                  (np.arange(plan.nt)[:, None, None, None] < nt))
                            record(x_seen, (torch.from_numpy(mx)[ok], torch.from_numpy(kx + 0 * mx)[ok]),
                                   xv[ok])
                            for h in range(2):
                                j = 2 * pp + h
                                if j > 0 and meta_q == 4:
                                    lookup(kl + 4 * j)
                                v = _lane_values(form, words, kl, j, col, W_q.dtype)
                                d = torch.zeros_like(v)
                                for f in range(4):
                                    if meta_q != 1:
                                        d[..., f] = _build_a(form, mode, v[..., f], s, z, zs, scalar,
                                                             bias, ct)
                                    else:                # a lookup and dq_general a weight
                                        lookup(kl + 4 * j + f)
                                        d[..., f] = _dq_general(v[..., f] - bias, mode, s, z, zs,
                                                                scalar, ct)
                                kw = np.broadcast_to(k0 + kl[..., None, None] + 4 * j + np.arange(4),
                                                     (4, 8, 4, 4, 4))
                                nw = np.broadcast_to(n0 + col[..., None, None] + np.arange(4)[:, None],
                                                     (4, 8, 4, 4, 4))
                                ok = torch.from_numpy((kw < k_end) & (nw < N))
                                record(w_seen, (torch.from_numpy(kw.copy())[ok],
                                                torch.from_numpy(nw.copy())[ok]), d[ok])
                                # the fragments: A[w, i, row, k] (row g: column 4g + 2i, row g + 8:
                                # 4g + 2i + 1), B[jj, k, token]
                                A = torch.zeros((4, 2, 16, 16))
                                B = torch.zeros((plan.nt, 16, 8))
                                for t in range(4):
                                    for f in range(4):
                                        for c in range(4):
                                            A[:, c >> 1, 8 * (c & 1):8 * (c & 1) + 8, KIDX[t, f]] = d[:, :, t, c, f]
                                        B[:, KIDX[t, f], :] = xv[:, :, t, 4 * h + f]
                                prod = torch.einsum("wirk,jkn->wijrn", A.double(), B.double())
                                acc = (acc.double() + prod).float()
                # the block's sums to (m, n): A row r of tile i is column 4 (r % 8) + 2i + r // 8
                for i in range(2):
                    for r in range(16):
                        n = n0 + 32 * np.arange(4) + 4 * (r % 8) + 2 * i + r // 8
                        for jj in range(nt):
                            mm = m0 + 8 * jj + np.arange(8)
                            for wi in range(4):
                                if n[wi] < N:
                                    keep = mm < M
                                    part[mm[keep], n[wi]] = acc[wi, i, jj, r][torch.from_numpy(keep)]
        out = out + part                                 # split order
    return mod._epilogue(out, scales, scales_x, meta), w_seen, x_seen


# ---- the forms ----

# every form the float path takes: (W_nbits, group size, fma_mode, metadata
# dtype, x dtype) for the GemLiteLinear-packed ones
PACKED_FORMS = {
    "w4_mode3_bf16": (4, 128, False, torch.bfloat16, DType.BF16),
    "w4_gs32_mode4_bf16": (4, 32, True, torch.bfloat16, DType.BF16),
    "w1_gs64_mode4_fp16": (1, 64, True, torch.float16, DType.FP16),
    "w8_packed_mode3_bf16": (8, 64, False, torch.float32, DType.BF16),
    "w2_gs20_mode4_bf16": (2, 20, True, torch.bfloat16, DType.BF16),
    "w4_int8x_mode3": (4, 64, False, torch.bfloat16, DType.INT8),
    "w8_gs18_mode4_bf16": (8, 18, True, torch.bfloat16, DType.BF16),
}
FLOAT_PATH_FORMS = ("a16w8_in_loop_bf16", "a16w8_post_scale_bf16", "a16w8_in_loop_fp16",
                    "bitnet_w2_bf16") + tuple(PACKED_FORMS) + ("f16_weights_bf16x",
                                                               "bf16_weights_scalar_zero")


def form_k(name: str, K: int) -> int:
    """K for the form: groups of 18 need a multiple of 18 and 32 (576 per 640)."""
    return K // 640 * 576 if "gs18" in name else K


def float_layer(name, N, K, rng, device="cpu"):
    """A layer (W_q / scales / zeros / meta) of one float-path form, from the
    numpy generator ``rng``, on ``device``."""
    w = torch.from_numpy((rng.normal(size=(N, K)) * 0.02).astype(np.float32))
    if name == "a16w8_in_loop_bf16":                   # int8, mode 2, float32 channel scales
        return A16W8_INT8(device=device, dtype=torch.bfloat16).from_weights(w)
    if name == "a16w8_post_scale_bf16":                # int8, mode 0, csm 1
        return A16W8_INT8(device=device, dtype=torch.bfloat16, post_scale=True).from_weights(w)
    if name == "a16w8_in_loop_fp16":
        return A16W8_INT8(device=device, dtype=torch.float16).from_weights(w)
    if name == "bitnet_w2_bf16":                       # W2, mode 1, scalar zero, csm 1
        t = torch.from_numpy(rng.integers(-1, 2, size=(N, K)).astype(np.float32))
        return A16W158_INT(device=device, dtype=torch.bfloat16).from_weights(t, 0.01)
    if name in PACKED_FORMS:
        bits, gs, fma, dt, xdt = PACKED_FORMS[name]
        codes = torch.from_numpy(rng.integers(0, 2 ** bits, size=(N, K)).astype(np.uint8))
        G = N * K // gs
        scales = torch.from_numpy((rng.uniform(0.5, 1.5, size=(G, 1)) * 2.0 ** -6).astype(np.float32))
        zeros = torch.from_numpy(rng.integers(0, 2 ** bits, size=(G, 1)).astype(np.float32))
        layer = GemLiteLinear(bits, gs, K, N, xdt, DType.FP16 if xdt == DType.FP16 else DType.BF16,
                              scaled_activations=xdt == DType.INT8, device=device)
        return layer.pack(codes, scales.to(dt), zeros.to(dt), fma_mode=fma)
    a = A16W8_INT8(device=device, dtype=torch.bfloat16).from_weights(w)
    if name == "f16_weights_bf16x":                    # fp16 weights, mode 2, rounded to bf16
        W = (a.W_q.to(torch.float32) * 1.37).to(torch.float16)
        return SimpleNamespace(W_q=W, scales=a.scales, zeros=None, meta=a.meta._replace(W_nbits=16))
    assert name == "bf16_weights_scalar_zero"          # bf16 weights, mode 3, scalar zero 3
    return SimpleNamespace(W_q=a.W_q.to(torch.bfloat16), scales=a.scales,
                           zeros=torch.tensor(3, dtype=torch.int32, device=device),
                           meta=a.meta._replace(W_nbits=16, W_group_mode=3, zero_is_scalar=1))


def float_x(rng, M, K, meta, device="cpu"):
    """(x, per-token scales or None) for the layer's input dtype."""
    if meta.input_dtype == DType.INT8.value:
        x = torch.from_numpy(rng.integers(-128, 128, size=(M, K)).astype(np.int8))
        sx = torch.from_numpy((rng.uniform(1, 2, size=(M, 1)) * 2.0 ** -8).astype(np.float32))
        return x.to(device), sx.to(device)
    dt = torch.float16 if meta.input_dtype == DType.FP16.value else torch.bfloat16
    x = torch.from_numpy((rng.normal(size=(M, K)) * 0.5).astype(np.float32)).to(dt)
    return x.to(device), None


@pytest.mark.parametrize("M,N,K,plan", [
    (5, 200, 640, None),                                # one token tile, 2 column tiles, ragged N
    (70, 136, 640, None),                               # two row tiles of 64
    (8, 128, 1280, FloatPlan(1, 1, 1, 2, 640)),         # a K split of 5 + 5 stages
])
@pytest.mark.parametrize("name", FLOAT_PATH_FORMS)
def test_emulated_kernel_matches_the_plain_version(name, M, N, K, plan):
    K = form_k(name, K)
    rng = np.random.default_rng([M, N, K, FLOAT_PATH_FORMS.index(name)])
    layer = float_layer(name, N, K, rng)
    meta = layer.meta
    assert mod.can_use_fused(meta) and not mod.int_path(meta)
    x, sx = float_x(rng, M, K, meta)
    args = (layer.W_q, layer.scales, layer.zeros, sx)
    m32 = meta._replace(output_dtype=DType.FP32.value)
    got, w_seen, x_seen = float_emulated(x, *args, m32, plan)
    # every weight and x element the lanes built, bit for bit
    ct = mod.compute_dtype(meta)
    b = unpack_rows_ref(layer.W_q, meta.W_nbits, meta.elements_per_sample, K)
    w = mod._dequant(b, layer.scales, layer.zeros, meta, ct).to(ct).to(torch.float32)
    assert not torch.isnan(w_seen).any() and torch.equal(w_seen, w)
    assert not torch.isnan(x_seen).any() and torch.equal(x_seen, x.to(ct).to(torch.float32))
    # the product: float32 sums of K terms in two orders
    want = fused_matmul_plain(x, *args, m32)
    scale = torch.ones((M, N))
    if meta.channel_scale_mode in (1, 3):
        scale = scale * layer.scales.reshape(1, -1).float().abs()
    if meta.channel_scale_mode in (2, 3):
        scale = scale * sx.reshape(-1, 1).abs()
    bound = K * 2.0 ** -23 * (x.to(ct).float().abs() @ w.abs()) * scale + 1e-30
    assert got.shape == want.shape == (M, N)
    assert bool(((got - want).abs() <= bound).all())
    assert torch.isfinite(got).all()
