# SPDX-License-Identifier: Apache-2.0
"""Bit packing of low-bit codes into integer words, least-significant first.

Within a word, element ``j`` sits at bits ``[j*W_nbits, (j+1)*W_nbits)``: the
layout the JAX package calls ``w_layout=0``. 64-bit packing requests are stored
as 32-bit words, whose little-endian byte stream is identical.

The ``unfold_*`` functions undo the JAX package's plane fold (``w_layout=1/2``)
so that layers packed there can be read here; the port never folds.
"""

import torch

__all__ = [
    "pack_weights_over_cols",
    "pack_weights_over_rows",
    "unpack_over_cols",
    "unpack_over_rows",
    "fold_plane_count",
    "unfold_codes_for_planes",
    "unfold_rows_for_planes",
]

_WORD_DTYPE = {8: torch.uint8, 16: torch.int16, 32: torch.int32}


def _normalize_bitwidth(W_nbits: int, packing_bitwidth: int):
    if packing_bitwidth not in (8, 16, 32, 64):
        raise ValueError(f"unsupported packing width {packing_bitwidth}")
    if W_nbits not in (8, 4, 2, 1):
        raise ValueError(f"unsupported W_nbits {W_nbits}")
    if packing_bitwidth == 64:
        packing_bitwidth = 32
    return packing_bitwidth, packing_bitwidth // W_nbits


def _or_planes(planes):
    out = planes[0]
    for p in planes[1:]:
        out = out | p
    return out


def pack_weights_over_cols(W_q: torch.Tensor, W_nbits: int, packing_bitwidth: int = 32,
                           transpose: bool = True):
    """Pack an (N, K) code matrix along K.

    Returns ``(packed, elements_per_sample)``; with ``transpose=True`` the packed
    matrix is ``(K // elements_per_sample, N)``, the layout the kernels read."""
    packing_bitwidth, elems = _normalize_bitwidth(W_nbits, packing_bitwidth)
    rows, cols = W_q.shape
    if cols % elems:
        raise ValueError(f"cols ({cols}) must be divisible by {elems}")
    v = W_q.to(torch.int32).reshape(rows, cols // elems, elems)
    packed = _or_planes([v[:, :, j] << (j * W_nbits) for j in range(elems)])
    packed = packed.to(_WORD_DTYPE[packing_bitwidth])
    if transpose:
        packed = packed.T.contiguous()
    return packed, elems


def pack_weights_over_rows(W_q: torch.Tensor, W_nbits: int, packing_bitwidth: int = 32,
                           transpose: bool = False):
    """Pack a (R, C) code matrix along R -> (R // elements_per_sample, C)."""
    packing_bitwidth, elems = _normalize_bitwidth(W_nbits, packing_bitwidth)
    rows, cols = W_q.shape
    if rows % elems:
        raise ValueError(f"rows ({rows}) must be divisible by {elems}")
    v = W_q.to(torch.int32).reshape(rows // elems, elems, cols)
    packed = _or_planes([v[:, j, :] << (j * W_nbits) for j in range(elems)])
    packed = packed.to(_WORD_DTYPE[packing_bitwidth])
    if transpose:
        packed = packed.T.contiguous()
    return packed, elems


def unpack_over_cols(W_q_packed: torch.Tensor, W_nbits: int, num_output_cols: int,
                     dtype=torch.uint8):
    """Inverse of pack_weights_over_cols before its transpose: (R, Cp) -> (R, C)."""
    rows, cols_p = W_q_packed.shape
    elems = num_output_cols // cols_p
    mask = (1 << W_nbits) - 1
    shifts = torch.arange(elems, dtype=torch.int32, device=W_q_packed.device) * W_nbits
    v = W_q_packed.to(torch.int32)[:, :, None]
    return ((v >> shifts[None, None, :]) & mask).to(dtype).reshape(rows, num_output_cols)


def unpack_over_rows(W_q_packed: torch.Tensor, W_nbits: int, num_output_rows: int,
                     dtype=torch.uint8):
    """Inverse of pack_weights_over_rows: (Rp, C) -> (R, C)."""
    rows_p, cols = W_q_packed.shape
    elems = num_output_rows // rows_p
    mask = (1 << W_nbits) - 1
    shifts = torch.arange(elems, dtype=torch.int32, device=W_q_packed.device) * W_nbits
    v = W_q_packed.to(torch.int32)[:, None, :]
    return ((v >> shifts[None, :, None]) & mask).to(dtype).reshape(num_output_rows, cols)


def fold_plane_count(W_nbits: int, w_layout: int) -> int:
    """Planes per word of the JAX package's fold: 4 byte planes for
    ``w_layout=2``; for ``w_layout=1`` 16 // W_nbits halfword planes (2 for
    8-bit codes)."""
    if w_layout == 2:
        return 4
    return 2 if W_nbits == 8 else 16 // W_nbits


def unfold_codes_for_planes(codes: torch.Tensor, n_planes: int, fold_gs: int):
    """Put folded (N, K) codes back into natural K order."""
    n, k = codes.shape
    t = fold_gs // n_planes
    return codes.reshape(n, k // fold_gs, t, n_planes).transpose(2, 3).reshape(n, k)


def unfold_rows_for_planes(b: torch.Tensor, n_planes: int, fold_gs: int):
    """unfold_codes_for_planes for the (K, N) orientation (rows = K)."""
    k, n = b.shape
    t = fold_gs // n_planes
    return b.reshape(k // fold_gs, t, n_planes, n).transpose(1, 2).reshape(k, n)
