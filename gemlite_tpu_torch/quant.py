# SPDX-License-Identifier: Apache-2.0
"""Grouped INT weight quantizer, dynamic activation quantizers and the MX
weight quantizer (counterparts of ``gemlite_tpu/quant.py``).

All run on torch tensors on any device, in float32, with the JAX package's
steps, so the codes agree with it. The INT weight quantizer's row means add
in numpy's order (``_row_mean``; numpy's own call on the CPU); every
quantizer divides by tensors, never by a Python scalar (CUDA divides by a
scalar through its reciprocal), so codes, scales and zeros equal the JAX
package's bit for bit on the CPU and on the card. The MXFP4 weight
quantizer's scale goes through XLA's inexact f32 log2 and exp2 in the JAX
package; the port reproduces their results from ``xla_f32``'s tables.

MX formats (the OCP microscaling spec, and NVIDIA's NVFP4): fp8 (e4m3 /
e5m2) or fp4 (e2m1) codes in groups of 32 with a power-of-two e8m0 scale
(stored as its exponent bits, uint8), or fp4 codes in groups of 16 with an
e4m3 scale times the global meta-scale 0.05 (NVFP4).
"""

import numpy as np
import torch

from . import xla_f32
from .dtypes import DType, get_dtype_range, to_torch_dtype

__all__ = ["quantize_int_weights", "scale_activations_per_token", "scale_activations_mxfp8",
           "scale_activations_mxfp4", "scale_activations_nvfp4", "scale_activations_mx",
           "WeightQuantizerMXFP", "FP4_VALUES", "NVFP4_META_SCALE", "e8m0_bits_to_f32",
           "round_to_fp4", "fp4_index", "fp4_dequant", "fp4x2_remap_packed"]


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


# ---------------------------------------------------------------------------
# MX microscaling (``gemlite_tpu/quant.py:60-398``)
# ---------------------------------------------------------------------------

_E8M0_EPS_EXP = -30          # the smallest scale exponent (eps 2^-30)
NVFP4_META_SCALE = 0.05      # NVFP4's global meta-scale

# fp4 (e2m1) codebook: index = sign << 3 | magnitude rank
FP4_VALUES = np.array([0, 0.5, 1, 1.5, 2, 3, 4, 6, -0.0, -0.5, -1, -1.5, -2, -3, -4, -6],
                      dtype=np.float32)
_FP4_POS = FP4_VALUES[:8]
# decision thresholds between consecutive positive fp4 values
_FP4_THRESHOLDS = ((_FP4_POS[:-1] + _FP4_POS[1:]) / 2).astype(np.float32)


_CONSTS: dict = {}


def _const(name: str, values: np.ndarray, device) -> torch.Tensor:
    """A small constant table on ``device``, made once: the forward's
    fake-quantization runs inside a captured CUDA graph, where no host
    array may be copied to the card."""
    key = (name, torch.device(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.as_tensor(values, device=device)
    return t


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    """A float32 tensor of x shaped like ``like``, on its device: the divisor
    of a division that must round as the JAX package's does."""
    return torch.full_like(like, x, dtype=torch.float32)


def _pow2_ceil(v: torch.Tensor):
    """Smallest power of two >= v (float32), as (scale, biased exponent
    int32), from v's bits: its exponent, plus 1 if any mantissa bit is set,
    clamped to [127 - 30, 254]."""
    xi = v.to(torch.float32).contiguous().view(torch.int32)
    exp = ((xi >> 23) & 0xFF) + ((xi & 0x7FFFFF) != 0).to(torch.int32)
    exp = torch.clamp(exp, 127 + _E8M0_EPS_EXP, 254)
    return (exp << 23).view(torch.float32), exp


def _f32_pow2_to_e8m0_bits(scales: torch.Tensor) -> torch.Tensor:
    """Power-of-two float32 scales -> e8m0 exponent bits (uint8); a scale
    that is no power of two rounds to the nearest one, half up."""
    xi = scales.to(torch.float32).contiguous().view(torch.int32)
    exp = ((xi >> 23) & 0xFF) + ((xi & 0x7FFFFF) >= 0x400000).to(torch.int32)
    return torch.clamp(exp, 0, 254).to(torch.uint8)


def e8m0_bits_to_f32(u8: torch.Tensor) -> torch.Tensor:
    """e8m0 exponent bits (uint8) -> 2^(v - 127) as float32 (bits 0 -> 0.0,
    as the JAX package's bitcast decodes them)."""
    return (u8.to(torch.int32) << 23).view(torch.float32)


def _group_view(x: torch.Tensor, group_size: int) -> torch.Tensor:
    """(..., K) -> (rows, group_size); K must be a whole number of groups
    (a group never spans two tokens)."""
    xf = x.reshape(-1, x.shape[-1])
    if xf.shape[-1] % group_size:
        raise ValueError(f"K={xf.shape[-1]} is not a multiple of group_size={group_size}")
    return xf.reshape(-1, group_size)


def round_to_fp4(x: torch.Tensor):
    """Nearest fp4 (e2m1) value of each element, as (value, magnitude index):
    the index counts the thresholds |x| exceeds, so a tie goes to the smaller
    magnitude; the value carries x's sign (a small negative x gives -0.0)."""
    idx = torch.bucketize(x.abs(), _const("fp4_thresholds", _FP4_THRESHOLDS, x.device))
    mag = _const("fp4_magnitudes", _FP4_POS, x.device)[idx]
    return mag * torch.sign(x), idx


def fp4_index(x_fp4: torch.Tensor) -> torch.Tensor:
    """fp4 values -> uint8 codebook indices (sign << 3 | magnitude rank); -0.0
    keeps sign code 8."""
    idx = torch.bucketize(x_fp4.abs(), _const("fp4_thresholds", _FP4_THRESHOLDS, x_fp4.device))
    return (idx | (torch.signbit(x_fp4).to(idx.dtype) << 3)).to(torch.uint8)


def fp4_dequant(idx: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 codebook indices -> fp4 values."""
    return _const("fp4_values", FP4_VALUES, idx.device).to(dtype)[idx.to(torch.long)]


def fp4x2_remap_packed(W_q_packed: torch.Tensor) -> torch.Tensor:
    """The JAX package's x2 re-encode of packed fp4 nibbles (codes 0 <-> 1 and
    8 <-> 9 swapped; ``gemlite_tpu/quant.py:fp4x2_remap_packed``). It is its
    own inverse: the port applies it once more to a layer that carries
    ``mx_x2``, to get the plain codes back."""
    w = W_q_packed
    if w.dtype != torch.int32:
        raise ValueError(f"want int32 words, got {w.dtype}")
    u = w & 0x66666666
    t = (u | (u >> 1)) & 0x22222222
    flip = ((t ^ 0x22222222) >> 1) & 0x11111111
    return w ^ flip


def _xla_ceil_log2(v: torch.Tensor) -> torch.Tensor:
    """ceil(log2(v)) of positive float32 v as the JAX package computes it
    (XLA's log(v) * (1 / ln 2), then ceil), as int32: the exact ceiling from
    v's bits, corrected where ``xla_f32`` lists XLA's result as one off."""
    bits = v.to(torch.float32).contiguous().view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127
    m = bits & 0x7FFFFF
    out = e + (m != 0).to(torch.int32)
    lo, hi = xla_f32.CEIL_LOG2_RANGE
    runs = torch.zeros(hi - lo, dtype=torch.int32, device=v.device)
    for k, n in xla_f32.CEIL_LOG2_BELOW.items():
        runs[k - lo] = n
    inside = (e >= lo) & (e < hi)
    n = runs[torch.clamp(e, lo, hi - 1) - lo]
    out = torch.where(inside & (m >= 1) & (m <= n), e, out)
    above = [int(np.array([2.0 ** k], np.float32).view(np.int32)[0]) + o
             for k, offs in xla_f32.CEIL_LOG2_ABOVE.items() for o in offs]
    hit = torch.isin(bits, torch.tensor(above, dtype=torch.int32, device=v.device))
    return torch.where(hit, out + 1, out)


def _xla_exp2(k: torch.Tensor) -> torch.Tensor:
    """exp2 of integer-valued float32 k as the JAX package computes it (XLA's
    exp(k * ln 2)): the exact power of two's bits, plus ``xla_f32``'s ulps.
    Powers below 2^-126 come out as 2^-126: the callers take the larger of
    the result and 2^-30."""
    ki = torch.clamp(k.to(torch.int32), -126, 128)
    lo, hi = xla_f32.EXP2_RANGE
    ulps = torch.zeros(hi - lo, dtype=torch.int32, device=k.device)
    for kk, d in xla_f32.EXP2_ULPS.items():
        ulps[kk - lo] = d
    bits = (ki + 127) << 23
    bits = bits + torch.where((ki >= lo) & (ki < hi), ulps[torch.clamp(ki, lo, hi - 1) - lo], 0)
    return bits.view(torch.float32)


def scale_activations_mxfp8(x: torch.Tensor, w_dtype=torch.float8_e4m3fn):
    """MXFP8 dynamic quantization, groups of 32 with e8m0 scales: (x_q fp8 of
    x's shape, scales (M, K // 32) uint8 e8m0 bits)."""
    w_dtype = to_torch_dtype(w_dtype)
    min_val, max_val = get_dtype_range(w_dtype)
    g = _group_view(x, 32).to(torch.float32)
    amax = g.abs().amax(dim=1, keepdim=True)
    scales, exp = _pow2_ceil(amax / _f32(max_val, amax))
    q = torch.clamp(g / scales, min_val, max_val).to(w_dtype)
    M = g.numel() // x.shape[-1]
    return q.reshape(x.shape), exp.to(torch.uint8).reshape(M, -1)


def _pack_nibbles(idx: torch.Tensor, shape) -> torch.Tensor:
    """(rows, K) uint8 codes -> (..., K // 2) bytes, the even code in the low
    nibble."""
    idx = idx.reshape(-1, shape[-1])
    packed = idx[:, 0::2] | (idx[:, 1::2] << 4)
    return packed.reshape(tuple(shape[:-1]) + (shape[-1] // 2,))


def scale_activations_mxfp4(x: torch.Tensor):
    """MXFP4 dynamic quantization, groups of 32 with e8m0 scales: (fp4 codes
    two to a byte, low nibble first, (..., K // 2) uint8; scales (M, K // 32)
    uint8 e8m0 bits)."""
    g = _group_view(x, 32).to(torch.float32)
    amax = g.abs().amax(dim=1, keepdim=True)
    scales, exp = _pow2_ceil(amax / _f32(6.0, amax))
    vals, _ = round_to_fp4(g / scales)
    M = g.numel() // x.shape[-1]
    return _pack_nibbles(fp4_index(vals), x.shape), exp.to(torch.uint8).reshape(M, -1)


def _nvfp4_scales(amax: torch.Tensor):
    """(e4m3 scales, float32 full scales) of groups with absmax ``amax``: the
    ideal amax / 6 / 0.05 cast to e4m3, then times 0.05, at least 1e-6."""
    ideal = amax / _f32(6.0, amax) / _f32(NVFP4_META_SCALE, amax)
    s8 = torch.clamp(ideal, 0, 448.0).to(torch.float8_e4m3fn)
    return s8, torch.clamp_min(s8.to(torch.float32) * NVFP4_META_SCALE, 1e-6)


def scale_activations_nvfp4(x: torch.Tensor):
    """NVFP4 dynamic quantization, groups of 16 with e4m3 scales times 0.05:
    (fp4 codes two to a byte (..., K // 2) uint8, scales (M, K // 16)
    float8_e4m3fn)."""
    g = _group_view(x, 16).to(torch.float32)
    amax = g.abs().amax(dim=1, keepdim=True)
    s8, full = _nvfp4_scales(amax)
    vals, _ = round_to_fp4(g / full)
    M = g.numel() // x.shape[-1]
    return _pack_nibbles(fp4_index(vals), x.shape), s8.reshape(M, -1)


def mx_group_size(input_dtype) -> int:
    """Activation group of a micro-scaled input dtype: 16 for NVFP4, else 32."""
    return 16 if DType(input_dtype) == DType.NVFP4 else 32


def scale_activations_mx(x: torch.Tensor, input_dtype):
    """Micro-scaled activations for the in-kernel csm-4 prefill form
    (counterpart of ``gemlite_tpu/quant.py:scale_activations_mx_transposed``,
    without its transpose, a TPU sublane choice): ``(codes, scales)``.

    * ``codes`` (M, K) float8_e4m3fn: each group's quantized values (fp4
      values are exact in e4m3, so one container serves MXFP8, MXFP4 and
      NVFP4), row-major as the prefill kernel reads x;
    * ``scales`` (M, K // ags) float32, ags 16 for NVFP4 else 32: e8m0
      powers of two, or NVFP4's e4m3 scale times 0.05.

    Contract: ``(codes.float() * scales repeated over each group).to(bf16)``
    equals ``mx.fake_quant_activations(x, input_dtype)`` bit for bit."""
    d = DType(input_dtype)
    ags = mx_group_size(d)
    xf = x.reshape(-1, x.shape[-1]).to(torch.float32)
    M, K = xf.shape
    g = _group_view(xf, ags)
    amax = g.abs().amax(dim=1, keepdim=True)
    if d == DType.MXFP8:
        scales, _ = _pow2_ceil(amax / _f32(448.0, amax))
        q = torch.clamp(g / scales, -448.0, 448.0).to(torch.float8_e4m3fn)
    elif d == DType.MXFP4:
        scales, _ = _pow2_ceil(amax / _f32(6.0, amax))
        q = round_to_fp4(g / scales)[0].to(torch.float8_e4m3fn)
    elif d == DType.NVFP4:
        _, scales = _nvfp4_scales(amax)
        q = round_to_fp4(g / scales)[0].to(torch.float8_e4m3fn)
    else:
        raise ValueError(f"not an MX activation dtype: {d}")
    return q.reshape(M, K), scales.reshape(M, K // ags)


def _mean_last(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis in XLA's order on the CPU: one running sum
    from the first element to the last, then divided by the count."""
    total = x[..., 0]
    for i in range(1, x.shape[-1]):
        total = total + x[..., i]
    return total / _f32(float(x.shape[-1]), total)


def _flush_fp8_subnormal_codes(W_q: torch.Tensor) -> torch.Tensor:
    from .helper import _flush_fp8_subnormal_codes as flush
    return flush(W_q)


class WeightQuantizerMXFP:
    """Offline MX weight quantizer (``gemlite_tpu/quant.py:WeightQuantizerMXFP``):
    MXFP8, MXFP4 and NVFP4, the last two with an optional search over scale
    candidates (``window_size``). Each returns ``(W_q, scales)`` over groups
    of the flattened weight: with ``index`` fp8 codes or uint8 fp4 codebook
    indices, else their float32 values."""

    def __init__(self, compute_dtype=torch.bfloat16, device=None):
        self.compute_dtype = compute_dtype
        self.device = device

    def quantize_mxfp8(self, W, index: bool = False, mx_fp8_dtype=torch.float8_e4m3fn,
                       flush_subnormals: bool = True):
        """Groups of 32, e8m0 scale = the power of two at or above amax / max;
        with ``flush_subnormals`` (and ``index``) fp8 subnormal codes round to
        0 or the smallest normal, so that the layer is subnormal-free."""
        mx_fp8_dtype = to_torch_dtype(mx_fp8_dtype)
        min_val, max_val = get_dtype_range(mx_fp8_dtype)
        Wf = torch.as_tensor(W).reshape(-1, 32).to(torch.float32)
        amax = Wf.abs().amax(dim=1, keepdim=True)
        scales, exp = _pow2_ceil(amax / _f32(max_val, amax))
        W_q = torch.clamp(Wf / scales, min_val, max_val).to(mx_fp8_dtype)
        if flush_subnormals and index:
            W_q = _flush_fp8_subnormal_codes(W_q)
        if not index:
            W_q = W_q.to(torch.float32)
        return W_q, exp.to(torch.uint8)

    def quantize_mxfp4(self, W, window_size: int = 0, index: bool = False):
        """Groups of 32, scale 2^ceil(log2(amax / 6)) (XLA's log2 and exp2,
        reproduced), or with ``window_size`` the power of two within that
        many of it whose codes give the least mean |error|."""
        eps = 2.0 ** _E8M0_EPS_EXP
        Wf = torch.as_tensor(W).reshape(-1, 32).to(torch.float32)
        amax = Wf.abs().amax(dim=1, keepdim=True)
        log2_ideal = _xla_ceil_log2(torch.clamp_min(amax / _f32(6.0, amax), 1e-38)).to(
            torch.float32)
        if window_size == 0:
            scales = _xla_exp2(log2_ideal)
        else:
            offsets = torch.arange(-window_size, window_size + 1, dtype=torch.float32,
                                   device=Wf.device)
            cand = torch.clamp_min(_xla_exp2(log2_ideal + offsets[None, :]), eps)   # (G, W)
            q, _ = round_to_fp4(Wf[:, None, :] / cand[:, :, None])
            err = _mean_last(torch.abs(Wf[:, None, :] - q * cand[:, :, None]))
            best = torch.argmin(err, dim=1, keepdim=True)
            scales = torch.take_along_dim(cand, best, dim=1)
        scales = torch.clamp_min(scales, eps)
        W_q, _ = round_to_fp4(Wf / scales)
        scales_e8m0 = _f32_pow2_to_e8m0_bits(scales)
        if index:
            W_q = fp4_index(W_q)
        return W_q, scales_e8m0

    def quantize_nvfp4(self, W, window_size: int = 0, index: bool = False):
        """Groups of 16, e4m3 scale = amax / 6 / 0.05, or with ``window_size``
        the candidate (the scale times a power of two within that many of 1,
        kept in [1e-6, 448]) whose codes give the least mean |error|."""
        eps = 1e-6
        Wf = torch.as_tensor(W).reshape(-1, 16).to(torch.float32)
        amax = Wf.abs().amax(dim=1, keepdim=True)
        scales, _ = _nvfp4_scales(amax)
        if window_size > 0:
            base = scales.to(torch.float32)
            offsets = torch.arange(-window_size, window_size + 1, dtype=torch.float32,
                                   device=Wf.device)
            cand = torch.clamp(torch.clamp_min(base * _xla_exp2(offsets)[None, :], eps), 0, 448.0)
            full = cand * NVFP4_META_SCALE
            q, _ = round_to_fp4(Wf[:, None, :] / full[:, :, None])
            err = _mean_last(torch.abs(Wf[:, None, :] - q * full[:, :, None]))
            best = torch.argmin(err, dim=1, keepdim=True)
            scales = torch.take_along_dim(cand, best, dim=1).to(torch.float8_e4m3fn)
        scales_full = torch.clamp_min(scales.to(torch.float32) * NVFP4_META_SCALE, eps)
        W_q, _ = round_to_fp4(Wf / scales_full)
        if index:
            W_q = fp4_index(W_q)
        return W_q, scales

    def dequantize(self, W_q, scales, shape=None, dtype=None):
        """codes (fp4 indices as uint8, or fp8) times their group scales (e8m0
        bits as uint8, or float) -> ``dtype`` (default: compute_dtype)."""
        if W_q.dtype == torch.uint8:
            W_q = fp4_dequant(W_q)
        if scales.dtype == torch.uint8:
            scales = e8m0_bits_to_f32(scales)
        gs = W_q.numel() // scales.numel()
        out = W_q.reshape(-1, gs).to(torch.float32) * scales.reshape(-1, 1).to(torch.float32)
        if shape is not None:
            out = out.reshape(shape)
        return out.to(self.compute_dtype if dtype is None else dtype)
