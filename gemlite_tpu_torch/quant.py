# SPDX-License-Identifier: Apache-2.0
"""Grouped INT weight quantizer and dynamic activation quantizer
(counterparts of ``gemlite_tpu/quant.py``).

Both run on torch tensors on any device, in float32, with the JAX package's
steps, so the codes agree with it. The weight quantizer's row means add in
numpy's order (``_row_mean``; numpy's own call on the CPU) and it divides by
tensors, never by a Python
scalar, so its codes, scales and zeros equal the JAX package's bit for bit on
the CPU and on the card.
"""

import numpy as np
import torch

from .dtypes import get_dtype_range, to_torch_dtype

__all__ = ["quantize_int_weights", "scale_activations_per_token"]


def scale_activations_per_token(x: torch.Tensor, w_dtype=torch.int8, fp32_scale: bool = True):
    """Per-token (per-row) symmetric dynamic quantization
    (``gemlite_tpu/quant.py:scale_activations_per_token``).

    x (..., K) float -> (x_q (..., K) in ``w_dtype`` (int8, e4m3fn or e5m2;
    a torch dtype or a ``DType``), scales (M, 1) float32): scale = row absmax
    / max_val, clamped to >= 1e-6; the codes are x / scale clipped to the
    type's range, rounded half to even (an integer type by ``round``, an fp8
    type by its cast). With ``fp32_scale`` the chain runs in float32, else
    in x's own dtype. Plain PyTorch on every device, as the JAX package
    computes it with plain jnp."""
    w_dtype = to_torch_dtype(w_dtype)
    min_val, max_val = get_dtype_range(w_dtype)
    xf = x.reshape(-1, x.shape[-1])
    if fp32_scale:
        xf = xf.to(torch.float32)
    amax = xf.abs().amax(dim=1, keepdim=True)
    # divide by a tensor on the same device: CUDA divides by a Python scalar
    # as a multiply by its reciprocal, which can land one ulp off
    scales = torch.maximum(amax / torch.full_like(amax, max_val), torch.full_like(amax, 1e-6))
    q = torch.clamp(xf / scales, min_val, max_val)
    if not w_dtype.is_floating_point:
        q = torch.round(q)
    return q.to(w_dtype).reshape(x.shape), scales.to(torch.float32)


_NP_BUFSIZE = 8192      # numpy's reduction buffer: a longer row is summed in chunks
_NP_BLOCK = 128         # numpy's pairwise sum splits rows longer than this


def _pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """Row sums of (G, n) float32 in numpy's pairwise order (``pairwise_sum``
    of its add loop): below 8 one running sum, up to 128 eight running sums
    combined as a tree, then the rest added; longer rows split in two at a
    multiple of 8. Halves of equal length are summed as one batch of 2G rows,
    so a row of 128 * 2^k costs about 25 + k launches, not 25 * 2^k."""
    G, n = x.shape
    if n < 8:
        res = torch.zeros_like(x[:, :1])
        for i in range(n):
            res = res + x[:, i:i + 1]
        return res
    if n <= _NP_BLOCK:
        m = n - n % 8
        r = x[:, 0:8]
        for i in range(8, m, 8):
            r = r + x[:, i:i + 8]
        r = r[:, 0::2] + r[:, 1::2]          # (r0 + r1), (r2 + r3), ...
        r = r[:, 0::2] + r[:, 1::2]
        res = r[:, 0:1] + r[:, 1:2]
        for i in range(m, n):
            res = res + x[:, i:i + 1]
        return res
    n2 = n // 2
    n2 -= n2 % 8
    if 2 * n2 == n:
        halves = _pairwise_sum(x.reshape(2 * G, n2)).reshape(G, 2)
        return halves[:, 0:1] + halves[:, 1:2]
    return _pairwise_sum(x[:, :n2]) + _pairwise_sum(x[:, n2:])


def _row_mean(x: torch.Tensor) -> torch.Tensor:
    """``np.mean(x, axis=1, keepdims=True)`` of (G, n) float32, bit for bit:
    numpy itself on a CPU tensor (one call; the emulation's many small ops
    crawl when several processes share the host's cores), the emulation on
    the card."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.mean(x.contiguous().numpy(), axis=1, keepdims=True))
    return _row_mean_emulated(x)


def _row_mean_emulated(x: torch.Tensor) -> torch.Tensor:
    """numpy's row mean in torch ops on any device: the pairwise sum of each
    8192-long chunk, the chunks added in order, the sum divided by n in
    float64 and rounded to float32 (numpy divides by its intp count)."""
    n = x.shape[1]
    total = None
    for i in range(0, n, _NP_BUFSIZE):
        part = _pairwise_sum(x[:, i:i + _NP_BUFSIZE])
        total = part if total is None else total + part
    return (total.to(torch.float64) / n).to(torch.float32)


def quantize_int_weights(weight, W_nbits: int = 4, group_size: int = 128, iters: int = 12,
                         optimize: bool = True, clip_grid=None):
    """Grouped asymmetric INT quantization with alternating error refinement.

    Min-max init, an optional range-shrink search over ``clip_grid``, then
    ``iters`` rounds of (a) a per-group least-squares refit of (scale, zero)
    to the current codes and (b) re-rounding; each group keeps its lowest-MSE
    iterate. Returns ``(W_q uint8 (N, K), scales f32 (G, 1), zeros f32 (G, 1))``
    on the weight's device, with dequant = (W_q - zeros) * scales."""
    W = torch.as_tensor(weight).to(torch.float32)
    orig_shape = W.shape
    g = W.reshape(-1, group_size)
    qmax = float(2 ** W_nbits - 1)

    lo = g.amin(dim=1, keepdim=True)
    hi = g.amax(dim=1, keepdim=True)
    qmax_t = torch.full_like(lo, qmax)      # CUDA divides by a Python scalar as a multiply
    s = torch.clamp((hi - lo) / qmax_t, min=1e-8)
    z = -lo / s

    def quant(s, z):
        return torch.clamp(torch.round(g / s + z), 0, qmax)

    def err(q, s, z):
        return _row_mean((g - (q - z) * s) ** 2)

    def keep_better(best, cand):
        keep = cand[0] < best[0]
        return tuple(torch.where(keep, c, b) for c, b in zip(cand, best))

    q = quant(s, z)
    best = (err(q, s, z), q, s, z)
    if clip_grid is not None:
        mid = (lo + hi) / 2.0
        for r in clip_grid:
            if r == 1.0:
                continue
            lo_r = mid + (lo - mid) * r
            hi_r = mid + (hi - mid) * r
            s_r = torch.clamp((hi_r - lo_r) / qmax_t, min=1e-8)
            z_r = -lo_r / s_r
            q_r = quant(s_r, z_r)
            best = keep_better(best, (err(q_r, s_r, z_r), q_r, s_r, z_r))
        q, s, z = best[1:]
    if optimize:
        wm = _row_mean(g)                    # the weights do not change, nor their means
        gc = g - wm
        for _ in range(iters):
            qm = _row_mean(q)
            qc = q - qm
            var = _row_mean(qc ** 2)
            cov = _row_mean(qc * gc)
            s_new = torch.where(var > 1e-12, cov / torch.clamp(var, min=1e-12), s)
            s_new = torch.where(s_new.abs() > 1e-8, s_new, s)
            z_new = -(wm - s_new * qm) / s_new
            q_new = quant(s_new, z_new)
            best = keep_better(best, (err(q_new, s_new, z_new), q_new, s_new, z_new))
            q, s, z = best[1:]

    _, q, s, z = best
    return q.reshape(orig_shape).to(torch.uint8), s, z
