# SPDX-License-Identifier: Apache-2.0
"""The port's scan engine on channel-wise A16Wn layers (W_group_mode 1-3)
against gemlite_tpu's, on the CPU.

JAX's stacked gate (``gemlite_tpu/ops/pallas_scan.py:can_use_stacked_decode``)
is its decode gate minus scalar zeros, so its scan engine serves the
channel-wise layers of ``A16Wn`` (mode 3 / csm 0, and with ``post_scale``
mode 1 / csm 1, whose channel scale the kernel reads as ``scales`` with the
layer axis). The port's stacked entry ``ops/scan.decode_modes_stacked``
serves them too:

* the two packages' stacked gates agree on mode-4 layers and on the mode
  1-3 forms the processors make, at M 1, 8 and 64. One difference is
  asserted as such: JAX admits per-token x (A8Wn, csm 2 / 3), which its
  stacked kernel then fails to trace (no per-token scales on that path); the
  port refuses it, as it refuses scalar zeros (A16W158) like JAX;
* the stacked plain version equals the per-layer mode 1-3 decode form's
  plain version (``decode.decode_modes``) bit for bit at every layer index,
  and JAX's stacked kernel in interpret mode within the decode-route bound
  of tests/test_torch_scan.py (mean|a-b| / mean|b| < 5e-3);
* ``ContinuousBatchingEngine(scan_layers=True)`` on a channel-wise model
  (every linear quantized with its whole row as one group, packed by both
  packages from the same codes) gives the unrolled engine's tokens and the
  JAX scan engine's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemlite_tpu import helper as jh
from gemlite_tpu.models import llama as jllama
from gemlite_tpu.ops.pallas_decode import select_decode_config
from gemlite_tpu.ops.pallas_scan import can_use_stacked_decode as j_can_use_stacked
from gemlite_tpu.ops.pallas_scan import pallas_decode_matmul_stacked
from gemlite_tpu.quant import quantize_int_weights as jquant
from gemlite_tpu.serving import ContinuousBatchingEngine as JEngine
from gemlite_tpu_torch import ContinuousBatchingEngine, params_from_jax_numpy
from gemlite_tpu_torch import helper as th
from gemlite_tpu_torch.models import llama as tllama
from gemlite_tpu_torch.ops import decode, dispatch
from gemlite_tpu_torch.ops.scan import (can_use_stacked_decode, decode_matmul_stacked,
                                        stacked_decode_refusal)

from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

REL = 5e-3          # tests/test_torch_scan.py's bound for the stacked decode route
L, N, K, M = 3, 256, 512, 8
GATE_MS = (1, 8, 64)
TINY = dict(hidden_size=256, intermediate_size=512, num_layers=2, num_heads=4, num_kv_heads=2,
            head_dim=64, max_seq_len=64, vocab_size=128)


def _pack(w, bits, gs, kind, post=False):
    """(JAX layer, port layer) of one float weight, quantized once by the JAX
    package's quantizer and packed by both packages' processors."""
    W_q, s, z = (np.asarray(a) for a in jquant(w, bits, gs))
    if kind == "a16":
        return (jh.A16Wn(dtype=jnp.bfloat16, post_scale=post).from_weights(W_q, s, z, bits, gs),
                th.A16Wn(device="cpu", dtype=torch.bfloat16, post_scale=post).from_weights(
                    W_q, s, z, bits, gs))
    if kind == "hqq":
        return (jh.A16Wn_HQQ_INT(dtype=jnp.bfloat16, W_nbits=bits).from_weights(W_q, s, z),
                th.A16Wn_HQQ_INT(device="cpu", dtype=torch.bfloat16, W_nbits=bits).from_weights(
                    W_q, s, z))
    return (jh.A8Wn_HQQ_INT_dynamic(dtype=jnp.bfloat16, post_scale=post,
                                    W_nbits=bits).from_weights(W_q, s, z),
            th.A8Wn_HQQ_INT_dynamic(device="cpu", dtype=torch.bfloat16, post_scale=post,
                                    W_nbits=bits).from_weights(W_q, s, z))


# name -> (W_nbits, group size, processor kind, post_scale); "a16w158" apart
GATE_FORMS = {
    "w4_gs128": (4, 128, "hqq", False), "w2_gs64": (2, 64, "hqq", False),
    "a16w4_cw": (4, K, "a16", False), "a16w4_cw_post": (4, K, "a16", True),
    "a16w2_cw": (2, K, "a16", False), "a16w2_cw_post": (2, K, "a16", True),
    "a16w1_cw_post": (1, K, "a16", True),
    "a8w4_gs64": (4, 64, "a8", False), "a8w4_cw": (4, K, "a8", False),
    "a8w4_cw_post": (4, K, "a8", True), "a16w158": None,
}
CW_FORMS = ("a16w4_cw", "a16w4_cw_post", "a16w2_cw", "a16w2_cw_post")
_LAYERS = {}


def _layers(name, seed=0):
    key = (name, seed)
    if key not in _LAYERS:
        rng = np.random.default_rng([sorted(GATE_FORMS).index(name), seed])
        if name == "a16w158":
            w = rng.integers(-1, 2, size=(N, K)).astype(np.float32)
            _LAYERS[key] = (jh.A16W158_INT(dtype=jnp.bfloat16).from_weights(w, 0.01),
                            th.A16W158_INT(device="cpu", dtype=torch.bfloat16).from_weights(
                                torch.from_numpy(w), 0.01))
        else:
            bits, gs, kind, post = GATE_FORMS[name]
            w = (rng.normal(size=(N, K)) * 0.05).astype(np.float32)
            _LAYERS[key] = _pack(w, bits, gs, kind, post)
    return _LAYERS[key]


@pytest.mark.parametrize("M_", GATE_MS)
@pytest.mark.parametrize("name", sorted(GATE_FORMS))
def test_stacked_gate_agrees_with_jax(name, M_):
    jl, tl = _layers(name)
    jmeta, meta = jl.meta, tl.meta
    want = bool(j_can_use_stacked(jmeta, M_, N, K, select_decode_config(jmeta, M_, N, K)))
    got = can_use_stacked_decode(meta, M_)
    if meta.channel_scale_mode in (2, 3):
        # the JAX gate admits per-token x and its stacked kernel fails at
        # trace time; the port refuses it at the gate
        assert want and not got
        assert "quantized per token" in stacked_decode_refusal(meta, M_)
        return
    assert got == want, (name, meta.W_group_mode, meta.channel_scale_mode, meta.zero_is_scalar)
    if meta.zero_is_scalar:
        assert not got and "scalar" in stacked_decode_refusal(meta, M_)


def _stack(name):
    """L layers of one channel-wise form from L seeds: (JAX stacks, port
    stacks, JAX meta, port meta, port layers)."""
    pairs = [_layers(name, seed) for seed in range(L)]
    jst = tuple(jnp.stack([getattr(j, a) for j, _ in pairs]) for a in ("W_q", "scales", "zeros"))
    tst = tuple(torch.stack([getattr(t, a) for _, t in pairs]) for a in ("W_q", "scales", "zeros"))
    return jst, tst, pairs[0][0].meta, pairs[0][1].meta, [t for _, t in pairs]


def _x(seed=1):
    return (np.random.default_rng(seed).normal(size=(M, K)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("layer", range(L))
@pytest.mark.parametrize("name", CW_FORMS)
def test_stacked_plain_equals_per_layer_and_jax(name, layer):
    jst, tst, jmeta, meta, layers = _stack(name)
    assert meta.W_group_mode in (1, 3) and can_use_stacked_decode(meta, M)
    x = _x()
    xt = torch.from_numpy(x).to(torch.bfloat16)
    for idx in (layer, torch.tensor(layer, dtype=torch.int32)):
        got = decode_matmul_stacked(xt, *tst, meta, idx)
        lyr = layers[layer]
        want = decode.decode_modes(xt, lyr.W_q, lyr.scales, lyr.zeros, None, lyr.meta)
        assert got.dtype == torch.bfloat16 and got.shape == (M, N)
        assert torch.equal(got, want)
    cfg = select_decode_config(jmeta, M, N, K)
    jout = pallas_decode_matmul_stacked(jnp.asarray(x, jnp.bfloat16), *jst, None, jmeta,
                                        jnp.int32(layer), cfg, interpret=True)
    jout = np.asarray(jout.astype(jnp.float32))
    rel = np.abs(got.float().numpy() - jout).mean() / (np.abs(jout).mean() + 1e-6)
    assert rel < REL, rel


def _channelwise_model(post: bool, bits: int = 4):
    """A tiny Llama whose block linears are channel-wise A16Wn (each row of
    a linear one group), quantized by the JAX package's quantizer and packed
    by its processor: (JAX config, JAX params)."""
    jcfg = jllama.LlamaConfig.tiny(**TINY)
    params = jllama.init_llama(jcfg, seed=0)
    blocks = []
    for blk in params["blocks"]:
        nb = {"attn": dict(blk["attn"]), "mlp": dict(blk["mlp"]),
              "ln_attn": blk["ln_attn"], "ln_mlp": blk["ln_mlp"]}
        for grp in ("attn", "mlp"):
            for name, w in blk[grp].items():
                w = np.asarray(w, np.float32)
                W_q, s, z = (np.asarray(a) for a in jquant(w, bits, w.shape[1]))
                nb[grp][name] = jh.A16Wn(dtype=jnp.bfloat16, post_scale=post).from_weights(
                    W_q, s, z, bits, w.shape[1])
        blocks.append(nb)
    return jcfg, {**params, "blocks": blocks}


@pytest.mark.parametrize("post", [False, True])
def test_channelwise_scan_engine_equals_unrolled_engine_and_jax(post):
    jcfg, jq = _channelwise_model(post)
    params = params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jq), device="cpu")
    meta = params["blocks"][0]["mlp"]["down"].meta
    assert (meta.W_group_mode, meta.channel_scale_mode) == ((1, 1) if post else (3, 0))
    cfg = tllama.LlamaConfig.tiny(**TINY)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in (5, 9, 14)]
    kw = dict(max_batch=2, paged=False, prefill_buckets=(16,))
    scan = ContinuousBatchingEngine(params, cfg, scan_layers=True, device="cpu", **kw)
    dispatch.KERNEL_TRACE.clear()
    got = scan.generate(prompts, max_new_tokens=5)
    assert "plain_decode_stacked" in dispatch.KERNEL_TRACE
    unrolled = ContinuousBatchingEngine(params, cfg, device="cpu", **kw)
    assert got == unrolled.generate(prompts, max_new_tokens=5)
    assert JEngine(jq, jcfg, scan_layers=True, **kw).generate(prompts, max_new_tokens=5) == got
