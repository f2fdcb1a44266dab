# SPDX-License-Identifier: Apache-2.0
"""Grouped INT weight quantizer and dynamic activation quantizer
(counterparts of ``gemlite_tpu/quant.py``).

Both run on torch tensors on any device, in float32, with the JAX package's
steps, so the codes agree with it.
"""

import torch

from .dtypes import get_dtype_range

__all__ = ["quantize_int_weights", "scale_activations_per_token"]


def scale_activations_per_token(x: torch.Tensor, w_dtype=torch.int8):
    """Per-token (per-row) symmetric dynamic quantization.

    x (..., K) float -> (x_q (..., K) in ``w_dtype``, scales (M, 1) float32):
    scale = row absmax / max_val in float32, clamped to >= 1e-6; the codes are
    x / scale clipped to the type's range and, for an integer type, rounded
    half to even. Plain PyTorch on every device, as the JAX package computes
    it with plain jnp."""
    min_val, max_val = get_dtype_range(w_dtype)
    xf = x.reshape(-1, x.shape[-1]).to(torch.float32)
    amax = xf.abs().amax(dim=1, keepdim=True)
    # divide by a tensor on the same device: CUDA divides by a Python scalar
    # as a multiply by its reciprocal, which can land one ulp off
    scales = (amax / torch.full_like(amax, max_val)).clamp_min(1e-6)
    q = torch.clamp(xf / scales, min_val, max_val)
    if not w_dtype.is_floating_point:
        q = torch.round(q)
    return q.to(w_dtype).reshape(x.shape), scales


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
    s = torch.clamp((hi - lo) / qmax, min=1e-8)
    z = -lo / s

    def quant(s, z):
        return torch.clamp(torch.round(g / s + z), 0, qmax)

    def err(q, s, z):
        return ((g - (q - z) * s) ** 2).mean(dim=1, keepdim=True)

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
            s_r = torch.clamp((hi_r - lo_r) / qmax, min=1e-8)
            z_r = -lo_r / s_r
            q_r = quant(s_r, z_r)
            best = keep_better(best, (err(q_r, s_r, z_r), q_r, s_r, z_r))
        q, s, z = best[1:]
    if optimize:
        for _ in range(iters):
            qm = q.mean(dim=1, keepdim=True)
            wm = g.mean(dim=1, keepdim=True)
            var = ((q - qm) ** 2).mean(dim=1, keepdim=True)
            cov = ((q - qm) * (g - wm)).mean(dim=1, keepdim=True)
            s_new = torch.where(var > 1e-12, cov / torch.clamp(var, min=1e-12), s)
            s_new = torch.where(s_new.abs() > 1e-8, s_new, s)
            z_new = -(wm - s_new * qm) / s_new
            q_new = quant(s_new, z_new)
            best = keep_better(best, (err(q_new, s_new, z_new), q_new, s_new, z_new))
            q, s, z = best[1:]

    _, q, s, z = best
    return q.reshape(orig_shape).to(torch.uint8), s, z
