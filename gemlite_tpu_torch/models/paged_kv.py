# SPDX-License-Identifier: Apache-2.0
"""Paged KV cache and paged decode attention (counterpart of
``gemlite_tpu/models/paged_kv.py``).

* Cache layout ``pages (L, 2, Hkv, total_pages, page_size, D)``, as in the
  JAX package.
* A runtime block table ``(B, pages_per_seq) int32``: slots own any pages the
  engine's free list hands out, so ``total_pages`` may be smaller than
  ``B * pages_per_seq``.
* Decode reads only each slot's own live pages, on the paged decode kernel
  (``ops/attention.paged_decode_attention_kernel``).

Unlike the JAX package's functional updates, ``paged_write`` writes the pages
in place: every ``PagedKV`` made by ``with_table`` shares one pages tensor.
The engine keeps one table tensor for its lifetime and copies its host table
into it (``load_table``), so that a captured decode step, which reads the
tensor it saw at capture, sees every change.
"""

import torch

from ..core import resolve_device
from ..ops.attention import gather_pages, paged_decode_attention_kernel

__all__ = ["PagedKV", "init_paged_kv", "paged_write", "paged_gather", "paged_decode_attention"]


class PagedKV:
    """Paged KV cache: ``pages (L, 2, Hkv, P, ps, D)`` and block table
    ``table (B, pages_per_seq) int32``."""

    def __init__(self, pages: torch.Tensor, table: torch.Tensor, page_size: int):
        self.pages = pages
        self.table = table
        self.page_size = page_size

    def with_table(self, table: torch.Tensor) -> "PagedKV":
        """The same pages seen through another table (a view, not a copy)."""
        return PagedKV(self.pages, table, self.page_size)

    def load_table(self, table) -> None:
        """Copy a block table of the same shape (a numpy array or a tensor)
        into ``table`` in place."""
        self.table.copy_(torch.as_tensor(table))


def init_paged_kv(cfg, batch: int, page_size: int = 128, total_pages: int = 0,
                  device=None) -> PagedKV:
    """Zeroed pages and an identity block table (slot b owns pages
    ``[b * pps, (b + 1) * pps)``). With ``total_pages < batch * pps`` the
    table starts all zero and the engine's allocator hands out pages."""
    if cfg.max_seq_len % page_size:
        raise ValueError(f"page_size {page_size} does not divide max_seq_len {cfg.max_seq_len}")
    dev = resolve_device(device)
    pps = cfg.max_seq_len // page_size
    P = total_pages or batch * pps
    pages = torch.zeros((cfg.num_layers, 2, cfg.num_kv_heads, P, page_size, cfg.head_dim),
                        dtype=cfg.dtype, device=dev)
    if P >= batch * pps:
        table = (torch.arange(batch, dtype=torch.int32, device=dev)[:, None] * pps
                 + torch.arange(pps, dtype=torch.int32, device=dev)[None, :])
    else:
        table = torch.zeros((batch, pps), dtype=torch.int32, device=dev)
    return PagedKV(pages, table, page_size)


def paged_write(kv: PagedKV, layer_idx: int, k, v, pos) -> PagedKV:
    """Scatter ``k``/``v`` (B, S, Hkv, D) into the pages, in place, at the
    per-token cache positions ``pos`` (B, S) through the block table.
    Positions past the table's last page write to page 0.

    ``pages[layer, 0][:, pg, off]`` keeps the adjacent advanced indices in
    place in PyTorch, so the slice is (Hkv, B, S, D); numpy and JAX put the
    (B, S) dims in front of the same expression with the layer index in it."""
    ps = kv.page_size
    pos = pos.long()
    idx = pos // ps
    pps = kv.table.shape[1]
    # an idle slot's stale offset may run past its table (JAX drops those
    # rows of its scatter): they go to page 0, the engine's trash page
    pg = torch.gather(kv.table.long(), 1, idx.clamp(max=pps - 1))   # (B, S) page ids
    pg = torch.where(idx < pps, pg, torch.zeros_like(pg))
    off = pos % ps
    kv.pages[layer_idx, 0][:, pg, off] = k.to(kv.pages.dtype).permute(2, 0, 1, 3)
    kv.pages[layer_idx, 1][:, pg, off] = v.to(kv.pages.dtype).permute(2, 0, 1, 3)
    return kv


def paged_gather(kv: PagedKV, layer_idx: int, t_active: int = 0):
    """Contiguous (B, T, Hkv, D) k/v gathered through the block table, for
    masked multi-token reads (prompt chunks, speculative verify).
    ``t_active`` bounds T to a live-KV bucket."""
    table = kv.table
    if t_active:
        table = table[:, :-(-t_active // kv.page_size)]
    return gather_pages(kv.pages[layer_idx, 0], table), gather_pages(kv.pages[layer_idx, 1], table)


def paged_decode_attention(q, kv: PagedKV, layer_idx: int, lengths):
    """Single-token decode attention over the paged cache. q (B, Hq, D);
    lengths (B,) int32 valid tokens per slot, counting the one just written.
    Reads only ceil(lengths[b] / page_size) pages of each slot."""
    return paged_decode_attention_kernel(q, kv.pages[layer_idx, 0], kv.pages[layer_idx, 1],
                                         lengths, kv.table)
