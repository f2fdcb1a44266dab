# SPDX-License-Identifier: Apache-2.0
"""Attention kernels: causal flash prefill (``csrc/flash_attention.cu``) and
single-token paged decode (``csrc/paged_attention.cu``).

The JAX package borrows both from jax: ``flash_attention``
(``gemlite_tpu/models/llama.py:_attention_flash_causal``) and
``paged_attention`` (``gemlite_tpu/models/paged_kv.py:paged_decode_attention``).
Beside each kernel stands its plain PyTorch version: the causal masked
attention, and the gather through the block table followed by a masked
softmax (the counterpart of ``paged_kv.py:_decode_attention_ref``). On a CPU
tensor a wrapper runs the plain version; on a CUDA tensor it launches the
kernel or raises.

``ATTENTION_TRACE`` records how each attention ran, apart from the linears'
``KERNEL_TRACE``: ``flash`` and ``paged_decode`` on the card,
``plain_flash`` and ``plain_paged_decode`` on the CPU, and ``xla`` where the
JAX package itself attends in plain XLA (short prefills, prompt chunks,
speculative verify, dense-cache decode).
"""

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from . import build

__all__ = ["ATTENTION_TRACE", "attention", "xla_attention", "causal_attention_plain",
           "flash_attention_emulated", "FlashPlan", "flash_plan", "flash_attention_causal",
           "flash_qk_tile", "flash_pv_tile", "gather_pages", "paged_decode_attention_plain",
           "paged_decode_attention_kernel", "paged_live_splits", "paged_split_plan"]

ATTENTION_TRACE: list = []
_TRACE_LIMIT = 4096
FLASH_S_UNIT = 64        # the flash kernel takes S in multiples of this
FLASH_TILE = 128         # query rows of a block and key rows of a tile
FLASH_STAGES = 3         # K/V tiles in the shared-memory ring
FLASH_THREADS = 384      # two consumer warpgroups and one producer warpgroup
SMEM_LIMIT = 232448      # dynamic shared memory a block may use on an H100 (227 KB)
HEAD_DIMS = (64, 128)    # the kernels' template instances
_MAX_SPLITS = 16


def _note(name: str) -> None:
    if len(ATTENTION_TRACE) < _TRACE_LIMIT:
        ATTENTION_TRACE.append(name)


def attention(q, k, v, mask):
    """q: (B, S, Hq, D); k/v: (B, T, Hkv, D); mask (B, S, T) bool. GQA by
    head-group repeat; float32 scores and softmax; out in v's dtype."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    q = q.reshape(B, S, Hkv, Hq // Hkv, D)
    scores = torch.einsum("bshrd,bthd->bhrst", q.to(torch.float32),
                          k.to(torch.float32)) / np.sqrt(D)
    scores = torch.where(mask[:, None, None, :, :], scores, -1e30)   # no host-made tensor
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhrst,bthd->bshrd", probs, v.to(torch.float32))
    return out.reshape(B, S, Hq, D).to(v.dtype)


def xla_attention(q, k, v, mask):
    """``attention`` where the JAX package attends in plain XLA; noted ``xla``."""
    _note("xla")
    return attention(q, k, v, mask)


def causal_attention_plain(q, k, v):
    """Plain version of the flash kernel: q (B, S, Hq, D), k/v (B, S, Hkv, D)."""
    B, S = q.shape[:2]
    t = torch.arange(S, device=q.device)
    return attention(q, k, v, (t[None, :] <= t[:, None])[None].expand(B, S, S))


P_ROUNDINGS = ("bf16", "hi_lo")


def flash_attention_emulated(q, k, v, tile: int = FLASH_TILE, p_round: str = "hi_lo"):
    """The flash kernel's arithmetic in plain float32, for tests: the online
    softmax over ``tile``-row query and key tiles (keys from 0 to the
    diagonal tile, which alone is masked), exp2 of scores scaled by
    log2(e)/√D, and P rounded before P V: ``"hi_lo"``, as the kernel does,
    splits P into a bf16 high part and a bf16 low part and sums l over P
    itself; ``"bf16"`` rounds P once and sums l over the rounded values.
    Returns (B, S, Hq, D) in q's dtype, as the kernel does."""
    if p_round not in P_ROUNDINGS:
        raise ValueError(f"p_round {p_round!r}: one of {P_ROUNDINGS}")
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    qf = q.float().reshape(B, S, Hkv, Hq // Hkv, D).permute(0, 2, 3, 1, 4)
    kf, vf = (t.float().permute(0, 2, 1, 3)[:, :, None] for t in (k, v))
    scale = float(np.log2(np.e) / np.sqrt(D))
    out = torch.empty_like(qf)
    pos = torch.arange(S, device=q.device)

    def bf16(x):
        return x.to(torch.bfloat16).float()

    for q0 in range(0, S, tile):
        qi = qf[..., q0:q0 + tile, :]
        m = torch.full(qi.shape[:-1], -torch.inf, device=q.device)
        l = torch.zeros_like(m)
        o = torch.zeros_like(qi)
        for k0 in range(0, q0 + 1, tile):
            s = qi @ kf[..., k0:k0 + tile, :].transpose(-1, -2)
            if k0 == q0:
                s = s.masked_fill(pos[k0:k0 + tile][None, :] > pos[q0:q0 + tile][:, None],
                                  -torch.inf)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2((m - m_new) * scale)
            p = torch.exp2(s * scale - (m_new * scale)[..., None])
            vj = vf[..., k0:k0 + tile, :]
            if p_round == "bf16":
                p = bf16(p)
                pv = p @ vj
            else:
                hi = bf16(p)
                pv = hi @ vj + bf16(p - hi) @ vj
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + pv
            m = m_new
        out[..., q0:q0 + tile, :] = o / l[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D).to(q.dtype)


@dataclass(frozen=True)
class FlashPlan:
    """The flash kernel's launch (``csrc/flash_attention.cu``): grid (Hq, B,
    query tiles), block (x, y, z) taking head x, batch row y and tile
    ``tiles - 1 - z``, so the heaviest tiles (those nearest the end of the
    sequence, with the most key tiles) start first; the ring's dynamic shared
    memory; and the valid query rows of each tile (a ragged S % 128 == 64
    leaves the last tile half full)."""
    grid: tuple
    threads: int
    smem_bytes: int
    tile_rows: tuple

    def order(self):
        """(tile, head, batch) of each block in launch order (x fastest)."""
        Hq, B, n = self.grid
        return [(n - 1 - z, h, b) for z in range(n) for b in range(B) for h in range(Hq)]


def flash_plan(B: int, S: int, Hq: int, D: int) -> FlashPlan:
    """The launch the flash kernel makes for q (B, S, Hq, D); raises on a
    shape it does not take."""
    _head_dim(D)
    if S <= 0 or S % FLASH_S_UNIT:
        raise ValueError(f"flash attention: S={S} is not a multiple of {FLASH_S_UNIT}")
    tiles = -(-S // FLASH_TILE)
    tile_bytes = FLASH_TILE * D * 2                   # one Q, K or V tile in bf16
    barriers = 8 * (1 + 3 * FLASH_STAGES)
    smem = tile_bytes * (1 + 2 * FLASH_STAGES) + barriers + 1024   # 1024: base alignment
    rows = tuple(min(FLASH_TILE, S - t * FLASH_TILE) for t in range(tiles))
    return FlashPlan((Hq, B, tiles), FLASH_THREADS, smem, rows)


def _flash_fn(name: str, n_ptr: int, n_int: int):
    fn = getattr(build.load("flash_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _bf16_cuda(name, t, ndim):
    if not t.is_cuda or t.dtype != torch.bfloat16 or t.ndim != ndim:
        raise ValueError(f"{name}: want a CUDA bf16 tensor of {ndim} dims, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    return t.contiguous()


def _head_dim(D: int) -> None:
    if D not in HEAD_DIMS:
        raise NotImplementedError(f"head_dim {D}: the attention kernels take {HEAD_DIMS}; "
                                  "head_dim 256 is queued (ROADMAP Queue B)")


def flash_attention_causal(q, k, v):
    """Causal softmax(q kᵀ / √D) v for a prefill from cache offset 0.

    q (B, S, Hq, D), k/v (B, S, Hkv, D), the layout the model holds; GQA by
    kv head = q head // (Hq / Hkv), without copying k/v per q head. Returns
    (B, S, Hq, D) in v's dtype (bf16 on the card)."""
    if q.device.type == "cpu":
        _note("plain_flash")
        return causal_attention_plain(q, k, v)
    q, k, v = (_bf16_cuda(n, t, 4) for n, t in (("q", q), ("k", k), ("v", v)))
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    _head_dim(D)
    if k.shape != (B, S, Hkv, D) or v.shape != k.shape or Hq % Hkv:
        raise ValueError(f"flash attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    flash_plan(B, S, Hq, D)                     # raises unless S % 64 == 0
    _note("flash")
    out = torch.empty_like(q)
    err = _flash_fn("gl_flash_attention", 4, 5)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, Hq, Hkv, D,
        torch.cuda.current_stream().cuda_stream)
    build.check(err, "flash_attention")
    flash_attention_causal.launches += 1
    return out


flash_attention_causal.launches = 0


def flash_qk_tile(q, k):
    """Test entry: the flash kernel's Q Kᵀ alone on one tile. q, k (128, D)
    bf16 -> (128, 128) float32, unscaled and unmasked."""
    if q.device.type == "cpu":
        return q.float() @ k.float().T
    q, k = _bf16_cuda("q", q, 2), _bf16_cuda("k", k, 2)
    _head_dim(q.shape[1])
    if q.shape != (FLASH_TILE, q.shape[1]) or k.shape != q.shape:
        raise ValueError(f"flash_qk_tile: q {tuple(q.shape)}, k {tuple(k.shape)}")
    s = torch.empty((FLASH_TILE, FLASH_TILE), dtype=torch.float32, device=q.device)
    build.check(_flash_fn("gl_flash_qk_tile", 3, 1)(
        q.data_ptr(), k.data_ptr(), s.data_ptr(), q.shape[1],
        torch.cuda.current_stream().cuda_stream), "flash_qk_tile")
    return s


def flash_pv_tile(p, v):
    """Test entry: the flash kernel's P V alone on one tile, P from registers
    as its bf16 high and low parts (two products) and V as stored. p (128,
    128) float32, v (128, D) bf16 -> (128, D) float32."""
    if p.device.type == "cpu":
        hi = p.to(torch.bfloat16).float()
        return hi @ v.float() + (p - hi).to(torch.bfloat16).float() @ v.float()
    v = _bf16_cuda("v", v, 2)
    D = v.shape[1]
    _head_dim(D)
    if (p.dtype != torch.float32 or not p.is_cuda or p.shape != (FLASH_TILE, FLASH_TILE)
            or v.shape != (FLASH_TILE, D)):
        raise ValueError(f"flash_pv_tile: p {p.dtype} {tuple(p.shape)}, v {tuple(v.shape)}")
    p = p.contiguous()
    o = torch.empty((FLASH_TILE, D), dtype=torch.float32, device=v.device)
    build.check(_flash_fn("gl_flash_pv_tile", 3, 1)(
        p.data_ptr(), v.data_ptr(), o.data_ptr(), D,
        torch.cuda.current_stream().cuda_stream), "flash_pv_tile")
    return o


def gather_pages(pages, table):
    """pages (Hkv, P, ps, D) of one layer and side, table (B, n) -> the
    (B, n * ps, Hkv, D) rows the table names, in order."""
    Hkv, _, ps, D = pages.shape
    B, n = table.shape
    return pages[:, table.long()].reshape(Hkv, B, n * ps, D).movedim(0, 2)


def paged_decode_attention_plain(q, k_pages, v_pages, lengths, table):
    """Plain version of the paged decode kernel: q (B, Hq, D), k/v pages
    (Hkv, P, ps, D), lengths (B,) valid tokens per slot, table (B, pps)."""
    k, v = gather_pages(k_pages, table), gather_pages(v_pages, table)
    T = k.shape[1]
    mask = (torch.arange(T, device=q.device)[None, :] < lengths.to(q.device)[:, None])[:, None, :]
    return attention(q[:, None], k, v, mask)[:, 0].to(q.dtype)


def paged_split_plan(pages_per_seq: int):
    """(splits, pages_per_split): a slot's page range cut in at most 16
    splits. It depends on the table's width only, never on the batch or the
    lengths, so a slot's result does not depend on its neighbours."""
    per = -(-pages_per_seq // _MAX_SPLITS)
    return -(-pages_per_seq // per), per


def paged_live_splits(length: int, page_size: int, pages_per_seq: int) -> int:
    """The splits of ``paged_split_plan`` that hold tokens of a slot of this
    length: the kernel runs and counts only these, and a slot with one live
    split writes its output without a partial."""
    splits, per = paged_split_plan(pages_per_seq)
    length = min(length, pages_per_seq * page_size)
    return min(splits, -(-length // (per * page_size)))


def _paged_lib():
    fn = build.load("paged_attention").gl_paged_decode
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def paged_decode_attention_kernel(q, k_pages, v_pages, lengths, table):
    """One-token attention of each slot over its pages up to ``lengths[b]``
    (which counts the token just written; at least 1).

    q (B, Hq, D) bf16; k/v pages (Hkv, P, ps, D) bf16; lengths (B,) int32;
    table (B, pps) int32 of page ids. Returns (B, Hq, D) in q's dtype. The
    kernel reads only the ceil(lengths[b] / ps) pages of each slot."""
    if q.device.type == "cpu":
        _note("plain_paged_decode")
        return paged_decode_attention_plain(q, k_pages, v_pages, lengths, table)
    q = _bf16_cuda("q", q, 3)
    k_pages, v_pages = _bf16_cuda("k_pages", k_pages, 4), _bf16_cuda("v_pages", v_pages, 4)
    B, Hq, D = q.shape
    Hkv, P, ps, _ = k_pages.shape
    _head_dim(D)
    if (k_pages.shape[3] != D or v_pages.shape != k_pages.shape or Hq % Hkv
            or Hq // Hkv > 8):
        raise ValueError(f"paged decode: q {tuple(q.shape)}, pages {tuple(k_pages.shape)} "
                         "(up to 8 q heads per kv head)")
    for name, t, shape in (("lengths", lengths, (B,)), ("table", table, (B, table.shape[-1]))):
        if not t.is_cuda or t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want a CUDA int32 tensor of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    lengths, table = lengths.contiguous(), table.contiguous()
    pps = table.shape[1]
    splits, per_split = paged_split_plan(pps)
    _note("paged_decode")
    acc = ml = counters = None
    if splits > 1:                  # partials (B, Hq, splits, D + 2), counters (B, Hkv)
        ibuf, fbuf = build.split_state("paged_decode", q.device, B * Hkv, B * Hq * splits * (D + 2))
        acc, ml, counters = (fbuf.data_ptr(), fbuf.data_ptr() + 4 * B * Hq * splits * D,
                             ibuf.data_ptr())
    out = torch.empty_like(q)
    err = _paged_lib()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), lengths.data_ptr(),
                       table.data_ptr(), acc, ml, counters, out.data_ptr(),
                       B, Hq, Hkv, D, P, ps, pps, splits, per_split,
                       torch.cuda.current_stream().cuda_stream)
    build.check(err, "paged_attention")
    paged_decode_attention_kernel.launches += 1
    return out


paged_decode_attention_kernel.launches = 0
