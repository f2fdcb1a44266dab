# SPDX-License-Identifier: Apache-2.0
"""The dequantize kernel's integer form (``gl_dequantize_int``: W1 / W2 / W4
/ W8 codes in W_group_mode 1-4, csm 0-3) against gemlite_tpu on the CPU.

The same seeded numpy weights go into both packages, at N, K <= 512:

* the port's plain version (``dequantize_full``) equals JAX's
  ``pallas_dequantize`` (interpret mode) bit for bit, except where the
  metadata is float32 or a channel scale is folded in: there JAX's
  build rounds in its own order, and every value is within one bf16 step,
  |a - b| <= 2^-7 |b|;
* the kernel's arithmetic, emulated here in float32 numpy in the order the
  CUDA code runs it (mode 3: q - z, then times s, each rounded; then the
  channel scale; one rounding to bf16), equals ``dequantize_full`` bit for
  bit on every form; before that rounding its float32 values equal
  ``dequantize_full``'s float32 ones, while those of the order (q s) - (z s)
  do not;
* routes: the port's gate (``can_use_dequantize``) admits every layer that
  JAX's ``pallas_prefill.can_use_dequantize`` admits, and at M 4096 the
  port routes ``dequantize`` exactly there, ``dense_fallback`` on the
  layers JAX dequantizes with plain XLA (both packages note
  ``dense_fallback`` for the latter; JAX notes it for the former too, around
  its Pallas kernel). At M 4095 the port's route is JAX's, or
  ``general_fused`` where its prefill kernel does not take the form yet (W8
  codes, float32 metadata);
* the layer's output at M 4096 is within mean|a-b| / mean|b| <= 3e-3 of
  JAX's (the bound of tests/test_torch_modes.py).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from gemlite_tpu import DType as JDType, GemLiteLinear as JLinear
from gemlite_tpu import helper as jh
from gemlite_tpu.ops import dispatch as jdispatch
from gemlite_tpu.ops.pallas_prefill import can_use_dequantize as jax_can_use_dequantize
from gemlite_tpu.ops.pallas_prefill import pallas_dequantize
from gemlite_tpu.quant import quantize_int_weights as jquant
from gemlite_tpu_torch import DType, GemLiteLinear
from gemlite_tpu_torch import helper as th
from gemlite_tpu_torch.core import tensor_from_numpy
from gemlite_tpu_torch.ops import dispatch
from gemlite_tpu_torch.ops.dequantize import (can_use_dequantize, dequantize_full,
                                              dequantize_int, jax_dequantizes, jax_folds)
from gemlite_tpu_torch.ops.reference import unpack_rows_ref

from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

N, K = 256, 512
ONE_STEP = 2.0 ** -7          # one bf16 step, relative
MEAN_REL = 3e-3
E4M3 = (jnp.float8_e4m3fn, torch.float8_e4m3fn)


def _hqq(rng, N_, K_, bits, gs, f32=False, zeros=True):
    """Codes, scales and zeros as the HQQ processors hand them over; float32
    metadata with zeros off the integers when ``f32``."""
    W_q = rng.integers(0, 2 ** bits, size=(N_, K_)).astype(np.uint8)
    G = N_ * K_ // gs
    dt = np.float32 if f32 else ml_dtypes.bfloat16
    s = (rng.uniform(0.5, 1.5, size=(G, 1)) * 2.0 ** -6).astype(dt)
    z = (rng.integers(0, 2 ** bits, size=(G, 1)) + (0.37 if f32 else 0.0)).astype(dt)
    return W_q, s, z if zeros else None


def _pack(W_q, s, z, bits, gs, **kw):
    N_, K_ = W_q.shape
    jl = JLinear(bits, gs, K_, N_, JDType.BF16, JDType.BF16).pack(W_q, s, z, **kw)
    tl = GemLiteLinear(bits, gs, K_, N_, DType.BF16, DType.BF16, device="cpu").pack(
        W_q, None if s is None else tensor_from_numpy(s),
        z if z is None or np.ndim(z) == 0 else tensor_from_numpy(z), **kw)
    return jl, tl


def _hqq_pair(bits, gs, fma=True, f32=False, zeros=True, shape=(N, K)):
    def make(rng):
        return _pack(*_hqq(rng, *shape, bits, gs, f32, zeros), bits, gs, fma_mode=fma)
    return make


def _channelwise(bits, zeros):
    """Scales (and zeros) of one group a row: W_group_mode 1 (or 0), csm 1."""
    def make(rng):
        W_q = rng.integers(0, 2 ** bits, size=(N, K)).astype(np.uint8)
        s = (rng.uniform(0.5, 1.5, size=(N, 1)) * 2.0 ** -6).astype(ml_dtypes.bfloat16)
        z = rng.integers(0, 2 ** bits, size=(N, 1)).astype(ml_dtypes.bfloat16) if zeros else None
        return _pack(W_q, s, z, bits, K)
    return make


def _scalar_zero(with_scales):
    """W2 codes with the scalar zero 1: mode 3 with group scales, or mode 1
    (a shift alone)."""
    def make(rng):
        W_q, s, _ = _hqq(rng, N, K, 2, 64)
        return _pack(W_q, s if with_scales else None, 1, 2, 64 if with_scales else K)
    return make


def _a8(bits, gs, post=False):
    def make(rng):
        w = (rng.normal(size=(N, K)) * 0.05).astype(np.float32)
        W_q, s, z = (np.asarray(a) for a in jquant(w, bits, gs))
        jl = jh.A8Wn_HQQ_INT_dynamic(dtype=jnp.bfloat16, post_scale=post, fp8=E4M3[0],
                                     W_nbits=bits).from_weights(W_q, s, z)
        tl = th.A8Wn_HQQ_INT_dynamic(device="cpu", dtype=torch.bfloat16, post_scale=post,
                                     fp8=E4M3[1], W_nbits=bits).from_weights(W_q, s, z)
        return jl, tl
    return make


def _a16w4_cw(rng):
    w = (rng.normal(size=(N, K)) * 0.05).astype(np.float32)
    W_q, s, z = (np.asarray(a) for a in jquant(w, 4, K))
    return (jh.A16Wn(dtype=jnp.bfloat16, post_scale=False).from_weights(W_q, s, z, 4, K),
            th.A16Wn(device="cpu", dtype=torch.bfloat16, post_scale=False).from_weights(
                W_q, s, z, 4, K))


def _a16w158(rng):
    w = rng.integers(-1, 2, size=(N, K)).astype(np.float32)
    return (jh.A16W158_INT(dtype=jnp.bfloat16).from_weights(w, 0.01),
            th.A16W158_INT(device="cpu", dtype=torch.bfloat16).from_weights(
                torch.from_numpy(w), 0.01))


# name -> (layer maker, (mode, csm) the port packs, the port's route at M 4095)
FORMS = {
    "w4_gs64_mode4": (_hqq_pair(4, 64), (4, 0), "prefill"),
    "w2_gs64_mode4": (_hqq_pair(2, 64), (4, 0), "prefill"),
    "w1_gs128_mode4": (_hqq_pair(1, 128), (4, 0), "prefill"),
    "w8_gs128_mode4": (_hqq_pair(8, 128), (4, 0), "general_fused"),
    "w8_gs64_mode3": (_hqq_pair(8, 64, fma=False), (3, 0), "general_fused"),
    "w4_gs64_mode3": (_hqq_pair(4, 64, fma=False), (3, 0), "prefill"),
    "w2_gs128_mode3": (_hqq_pair(2, 128, fma=False), (3, 0), "prefill"),
    "w1_gs256_mode3": (_hqq_pair(1, 256, fma=False), (3, 0), "prefill"),
    "w4_gs128_mode3_f32": (_hqq_pair(4, 128, fma=False, f32=True), (3, 0), "general_fused"),
    "w4_gs64_mode4_f32": (_hqq_pair(4, 64, f32=True), (4, 0), "general_fused"),
    "w4_gs64_mode2": (_hqq_pair(4, 64, zeros=False), (2, 0), "prefill"),
    "w4_cw_mode1_csm1": (_channelwise(4, True), (1, 1), "prefill"),
    "w2_scalar_mode3": (_scalar_zero(True), (3, 0), "prefill"),
    "w2_shift_mode1": (_scalar_zero(False), (1, 0), "prefill"),
    "a16w158": (_a16w158, (1, 1), "prefill"),
    "a16w4_cw": (_a16w4_cw, (3, 0), "prefill"),
    "a8w4_gs64": (_a8(4, 64), (3, 2), "prefill"),
    "a8w2_gs64": (_a8(2, 64), (3, 2), "prefill"),
    "a8w1_gs128": (_a8(1, 128), (3, 2), "prefill"),
    "a8w4_cw_post": (_a8(4, K, post=True), (1, 3), "prefill"),
}
# layers the JAX package dequantizes with plain XLA at M >= 4096: a fold unit
# past 512 (gs 1024), N off 128, a block of two groups (K 640 at gs 64: the
# prefill gate wants 8 groups a block), no metadata mode (channel scale alone)
XLA_FORMS = {
    "w4_gs1024": _hqq_pair(4, 1024, shape=(128, 2048)),
    "w4_n192": _hqq_pair(4, 128, shape=(192, 256)),
    "w4_k640_gs64": _hqq_pair(4, 64, shape=(128, 640)),
    "w4_cw_mode0_csm1": _channelwise(4, False),
}
_LAYERS = {}


def _layers(name):
    if name not in _LAYERS:
        rng = np.random.default_rng(sorted({**FORMS, **XLA_FORMS}).index(name))
        make = FORMS[name][0] if name in FORMS else XLA_FORMS[name]
        _LAYERS[name] = make(rng)
    return _LAYERS[name]


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy()


@pytest.mark.parametrize("name", sorted(FORMS))
def test_plain_version_matches_jax_pallas_dequantize(name):
    jl, tl = _layers(name)
    meta = tl.meta
    assert (meta.W_group_mode, meta.channel_scale_mode) == FORMS[name][1]
    assert jax_can_use_dequantize(jl.meta, N, K) and can_use_dequantize(meta)
    want = np.asarray(pallas_dequantize(jl.W_q, jl.scales, jl.zeros, jl.meta,
                                        interpret=True).astype(jnp.float32))
    got = dequantize_full(tl.W_q, tl.scales, tl.zeros, meta).float().numpy()
    assert got.shape == want.shape == (K, N)
    if meta.meta_dtype == DType.FP32.value or meta.channel_scale_mode in (1, 3):
        assert np.all(np.abs(got - want) <= ONE_STEP * np.abs(want)), name
    else:
        assert np.array_equal(got, want), name
    # the wrapper runs the plain version on the CPU
    assert torch.equal(dequantize_int(tl.W_q, tl.scales, tl.zeros, meta),
                       dequantize_full(tl.W_q, tl.scales, tl.zeros, meta))


def _kernel_emulated(W_q, scales, zeros, meta, order="kernel", dtype=torch.bfloat16):
    """gl_dequantize_int's arithmetic in float32 numpy: each word's group row
    at its first k, the scalar zero truncated to an integer in mode 3, every
    op rounded (numpy float32 does not contract), the channel scale last,
    one rounding to ``dtype``. ``order="scaled_zero"``: mode 3 as q s - z s."""
    mode, Kf = meta.W_group_mode, meta.in_features
    q = unpack_rows_ref(W_q, meta.W_nbits, meta.elements_per_sample, Kf).numpy().astype(np.float32)
    f32 = np.float32

    def rows(t):
        t = t.float().numpy().reshape(-1, meta.out_features)
        return np.repeat(t, Kf // t.shape[0], axis=0).astype(f32)

    s = rows(scales) if mode != 1 else f32(1)
    if mode == 2:
        z = f32(0)
    elif meta.zero_is_scalar:
        z = f32(torch.as_tensor(zeros).float().item())
        if mode == 3:
            z = f32(int(z))
    else:
        z = rows(zeros)
    if mode == 1:
        v = q - z
    elif mode == 2:
        v = q * s
    elif mode == 3:
        v = (q - z) * s if order == "kernel" else (q * s) - (z * s)
    else:
        v = (q * s) + z
    if meta.channel_scale_mode in (1, 3):
        v = v * scales.float().numpy().reshape(1, -1).astype(f32)
    return torch.from_numpy(np.ascontiguousarray(v, dtype=f32)).to(dtype)


@pytest.mark.parametrize("name", sorted(FORMS))
def test_kernel_order_equals_dequantize_full(name):
    _, tl = _layers(name)
    args = (tl.W_q, tl.scales, tl.zeros, tl.meta)
    assert np.array_equal(_bf16_bits(_kernel_emulated(*args)), _bf16_bits(dequantize_full(*args)))


def test_mode3_order_is_decided_by_the_data():
    """(q - z) s and q s - z s round apart in float32 on float32 metadata:
    the kernel takes the first, dequantize_full's order."""
    _, tl = _layers("w4_gs128_mode3_f32")
    args = (tl.W_q, tl.scales, tl.zeros, tl.meta)
    want = dequantize_full(*args, dtype=torch.float32)
    assert torch.equal(_kernel_emulated(*args, dtype=torch.float32), want)
    assert not torch.equal(_kernel_emulated(*args, order="scaled_zero", dtype=torch.float32),
                           want)


def _jax_route(jl, M, K_):
    jdispatch.KERNEL_TRACE.clear()
    jax.eval_shape(jl, jax.ShapeDtypeStruct((M, K_), jnp.bfloat16))
    return list(jdispatch.KERNEL_TRACE)


@pytest.mark.parametrize("M", [4095, 4096])
@pytest.mark.parametrize("name", sorted(FORMS) + sorted(XLA_FORMS))
def test_routes_match_jax(name, M):
    jl, tl = _layers(name)
    meta = tl.meta
    N_, K_ = meta.out_features, meta.in_features
    jax_kernel = jax_can_use_dequantize(jl.meta, N_, K_)
    assert jax_folds(meta) == bool(getattr(jl, "w_layout", 0))
    assert can_use_dequantize(meta) == jax_dequantizes(meta) == jax_kernel == (name in FORMS)
    jroute = _jax_route(jl, M, K_)
    route = dispatch._route(meta, M)
    if M == 4096:
        assert jroute == ["dense_fallback"]
        assert route == ("dequantize" if jax_kernel else "dense_fallback")
    elif name in FORMS:
        assert jroute == ["prefill"]
        assert route == FORMS[name][2]


@pytest.mark.parametrize("name", sorted(FORMS) + sorted(XLA_FORMS))
def test_outputs_at_m4096_match_jax(name):
    jl, tl = _layers(name)
    K_ = tl.meta.in_features
    x = np.random.default_rng(5).normal(size=(4096, K_)).astype(np.float32)
    want = np.asarray(jl(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    dispatch.KERNEL_TRACE.clear()
    got = tl(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    assert dispatch.KERNEL_TRACE == ["plain_dequantize" if name in FORMS else
                                     "plain_dense_fallback"]
    assert np.abs(got - want).mean() <= MEAN_REL * np.abs(want).mean(), name
