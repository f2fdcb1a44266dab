# SPDX-License-Identifier: Apache-2.0
"""The decode and prefill kernels' mode 1-3 form against gemlite_tpu on the
CPU.

The layers the JAX router sends to its decode kernel (M <= 64) and its
prefill kernel (64 < M < 4096) in W_group_mode 1, 2 or 3: A8W4 / A8W2 /
A8W1_HQQ_INT_dynamic (grouped mode 3 with csm 2; channel-wise mode 3 / csm 2,
or with ``post_scale`` mode 1 / csm 3; e4m3 and e5m2 x), channel-wise
A16W4 (mode 3 / csm 0, or mode 1 / csm 1) and A16W158_INT (W2, mode 1,
scalar zero, csm 1). The same seeded numpy weights go into both packages:

* the port's route (``ops/dispatch.KERNEL_TRACE``, ``plain_`` dropped)
  equals the JAX router's (``decode_plane`` is the port's ``decode``) at M
  1, 8, 64, 65, 128 and 4095; at M 4096 JAX dequantizes with its Pallas
  kernel inside ``dense_fallback``, the port with its dequantize kernel
  (``dequantize``). JAX's route is
  read from its notes under ``jax.eval_shape``, which runs its router and
  computes nothing;
* the outputs equal JAX's (eager, its Pallas kernels in interpret mode)
  within mean|a-b| / mean|b| <= 3e-3, the bound tests/test_torch_fp8.py
  holds the fp8 forms to: JAX sums x against the raw codes and applies each
  group's zero and scale to the group's sum, the port dequantizes each
  weight in bf16 (forward_meta's rounding), so the two round apart;
* the plain version of the form (``forward_f32_epilogue``) equals the
  general fused kernel's plain version (the parent's route) bit for bit, so
  the CPU outputs did not move with the route;
* a channel-wise layer's decode plan splits K (its one metadata row serves
  every k), while the mode-4 plan is the one it was.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemlite_tpu import helper as jh
from gemlite_tpu.ops import dispatch as jdispatch
from gemlite_tpu.quant import quantize_int_weights as jquant
from gemlite_tpu_torch import helper as th
from gemlite_tpu_torch.dtypes import to_torch_dtype
from gemlite_tpu_torch.ops import decode, dispatch, prefill
from gemlite_tpu_torch.ops.fused import fused_matmul_plain
from gemlite_tpu_torch.ops.reference import forward_f32_epilogue
from gemlite_tpu_torch.quant import scale_activations_per_token

from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

N, K = 256, 512
MEAN_REL = 3e-3
ROUTE_MS = (1, 8, 64, 65, 128, 4095, 4096)
OUTPUT_MS = (1, 8, 128)
E4M3 = (jnp.float8_e4m3fn, torch.float8_e4m3fn)
E5M2 = (jnp.float8_e5m2, torch.float8_e5m2)


def _a8(bits, gs, post=False, fp8=E4M3):
    return (gs, lambda: jh.A8Wn_HQQ_INT_dynamic(dtype=jnp.bfloat16, post_scale=post, fp8=fp8[0],
                                                W_nbits=bits),
            lambda: th.A8Wn_HQQ_INT_dynamic(device="cpu", dtype=torch.bfloat16, post_scale=post,
                                            fp8=fp8[1], W_nbits=bits), bits)


def _a16(bits, post):
    return (K, lambda: jh.A16Wn(dtype=jnp.bfloat16, post_scale=post),
            lambda: th.A16Wn(device="cpu", dtype=torch.bfloat16, post_scale=post), bits)


# name -> (group size, JAX processor, port processor, W_nbits); "bitnet" apart
FORMS = {
    "a8w4_gs64": _a8(4, 64), "a8w4_gs128": _a8(4, 128), "a8w2_gs64": _a8(2, 64),
    "a8w2_gs128": _a8(2, 128), "a8w1_gs128": _a8(1, 128),
    "a8w4_cw": _a8(4, K), "a8w4_cw_post": _a8(4, K, post=True),
    "a8w2_cw_post": _a8(2, K, post=True),
    "a8w4_gs64_e5m2": _a8(4, 64, fp8=E5M2), "a8w4_cw_post_e5m2": _a8(4, K, post=True, fp8=E5M2),
    "a16w4_cw": _a16(4, False), "a16w4_cw_post": _a16(4, True),
    "a16w158": None,
}
_LAYERS = {}


def _layers(name):
    """(JAX layer, port layer) of one form, from one seeded weight quantized
    once (by the JAX package's quantizer) and packed by both processors."""
    if name not in _LAYERS:
        rng = np.random.default_rng(sorted(FORMS).index(name))
        if name == "a16w158":
            w = rng.integers(-1, 2, size=(N, K)).astype(np.float32)
            jl = jh.A16W158_INT(dtype=jnp.bfloat16).from_weights(w, 0.01)
            tl = th.A16W158_INT(device="cpu", dtype=torch.bfloat16).from_weights(
                torch.from_numpy(w), 0.01)
        else:
            gs, jp, tp, bits = FORMS[name]
            w = (rng.normal(size=(N, K)) * 0.05).astype(np.float32)
            W_q, s, z = (np.asarray(a) for a in jquant(w, bits, gs))
            if name.startswith("a16"):
                jl = jp().from_weights(W_q, s, z, bits, gs)
                tl = tp().from_weights(W_q, s, z, bits, gs)
            else:
                jl = jp().from_weights(W_q, s, z)
                tl = tp().from_weights(W_q, s, z)
        _LAYERS[name] = (jl, tl)
    return _LAYERS[name]


def _x(M, seed=0):
    return (np.random.default_rng([M, seed]).normal(size=(M, K))).astype(np.float32)


def _jax_route(jl, M):
    jdispatch.KERNEL_TRACE.clear()
    jax.eval_shape(jl, jax.ShapeDtypeStruct((M, K), jnp.bfloat16))
    return list(jdispatch.KERNEL_TRACE)


def _port_forward(tl, x):
    dispatch.KERNEL_TRACE.clear()
    out = tl(torch.from_numpy(x).to(torch.bfloat16))
    return out, [r.removeprefix("plain_") for r in dispatch.KERNEL_TRACE]


@pytest.mark.parametrize("M", ROUTE_MS)
@pytest.mark.parametrize("name", sorted(FORMS))
def test_routes_match_jax(name, M):
    jl, tl = _layers(name)
    meta = tl.meta
    assert meta.W_group_mode in (1, 2, 3)
    jroute = _jax_route(jl, M)
    _, route = _port_forward(tl, _x(M))
    if M < 4096:
        assert jroute == ["decode_plane" if M <= 64 else "prefill"]
        assert route == ["decode" if M <= 64 else "prefill"]
    else:                    # JAX notes its Pallas dequantize under dense_fallback
        assert jroute == ["dense_fallback"]
        assert route == ["dequantize"]


@pytest.mark.parametrize("M", OUTPUT_MS)
@pytest.mark.parametrize("name", sorted(FORMS))
def test_outputs_match_jax(name, M):
    jl, tl = _layers(name)
    x = _x(M, seed=1)
    want = np.asarray(jl(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    got, _ = _port_forward(tl, x)
    got = got.float().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).mean() <= MEAN_REL * np.abs(want).mean(), name


@pytest.mark.parametrize("name", sorted(FORMS))
def test_plain_version_equals_the_general_kernels(name):
    """The form's plain version equals fused_matmul_plain (what these layers
    ran before they had a decode and prefill form) bit for bit, at a decode
    and a prefill M; and the wrappers run it on the CPU."""
    _, tl = _layers(name)
    meta = tl.meta
    for M in (8, 128):
        x = torch.from_numpy(_x(M, seed=2)).to(torch.bfloat16)
        sx = None
        if meta.scaled_activations:
            x, sx = scale_activations_per_token(x, to_torch_dtype(meta.input_dtype))
        args = (x, tl.W_q, tl.scales, tl.zeros, sx, meta)
        want = fused_matmul_plain(*args)
        assert torch.equal(forward_f32_epilogue(*args), want)
        wrapper = decode.decode_modes if M <= 64 else prefill.prefill_modes
        assert torch.equal(wrapper(*args), want)


def test_refused_forms_keep_the_general_kernel():
    """Forms the mode 1-3 form does not take keep their route: float32 group
    scales (the plain version dequantizes in float32), fp16 x, and groups
    of 32 above M 64 (the prefill kernel's stages are 64 deep)."""
    w = torch.from_numpy((np.random.default_rng(3).normal(size=(N, K)) * 0.05).astype(np.float32))
    W_q, s, z = jquant(w.numpy(), 4, 64)
    f32 = th.A8W4_HQQ_INT_dynamic(device="cpu", dtype=torch.bfloat16,
                                  fp32_scale=True).from_weights(*map(np.asarray, (W_q, s, z)))
    W_q, s, z = (np.asarray(a) for a in jquant(w.numpy(), 4, K))
    fp16 = th.A16Wn(device="cpu", dtype=torch.float16).from_weights(W_q, s, z, 4, K)
    W_q, s, z = (np.asarray(a) for a in jquant(w.numpy(), 4, 32))
    gs32 = th.A8W4_HQQ_INT_dynamic(device="cpu", dtype=torch.bfloat16).from_weights(W_q, s, z)
    for layer, routes in ((f32, ["general_fused"] * 2), (fp16, ["general_fused"] * 2),
                          (gs32, ["decode", "general_fused"])):
        got = [_port_forward(layer, _x(M))[1][0] for M in (8, 128)]
        assert got == routes, layer.meta


@pytest.mark.parametrize("N_,K_", [(4096, 4096), (14336, 4096), (4096, 14336), (1024, 4096)])
def test_channelwise_decode_plan_splits_k(N_, K_):
    """A channel-wise mode 1-3 layer's decode plan cuts K in 256-deep units
    (more than one split at the 8B shapes, one wave of about four blocks an
    SM), each stage holding the one metadata row; the mode-4 plan of the same
    shape at gs 128 is unchanged by the flag's default."""
    meta = _layers("a8w4_cw_post")[1].meta._replace(in_features=K_, out_features=N_,
                                                     group_size=K_)
    for M in (1, 8, 64):
        p = decode.modes_plan(M, meta)
        assert p.splits > 1 and p.mrows == 1 and p.k_per_split % 256 == 0
        assert p.splits * p.k_per_split >= K_ > (p.splits - 1) * p.k_per_split
        assert p.tiles * p.splits <= decode.TARGET_BLOCKS + p.tiles
        assert p.smem <= decode.SMEM_MAX
        assert decode.plan(M, N_, K_, 128, 4) == decode.plan(M, N_, K_, 128, 4, one_group=False)
    one = decode.plan(8, N_, K_, K_, 4)
    assert one.splits == 1                     # a mode-4 gs = K plan: as before
