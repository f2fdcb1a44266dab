# SPDX-License-Identifier: Apache-2.0
"""An A16W8 model (int8 weights, float32 channel scales in the K loop, bf16
activations) in the port against gemlite_tpu on the CPU.

The JAX package's init_llama weights are carried across as numpy
(``params_from_jax_numpy``), and each package quantizes them with its own
``A16W8_INT8(bf16)``: the packed int8 weights and scales equal, every linear
of the port runs the general fused kernel's float path (its plain version
here) at prefill and decode, and the logits of a 70-token prefill and 4
decode steps agree within rtol/atol 2e-2, the bound of tests/test_llama.py
for bf16 logits summed in different but equally valid orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemlite_tpu.helper import A16W8_INT8 as JA16W8
from gemlite_tpu.models import llama as jllama
from gemlite_tpu_torch import ContinuousBatchingEngine, params_from_jax_numpy
from gemlite_tpu_torch.helper import A16W8_INT8
from gemlite_tpu_torch.models import llama as tllama
from gemlite_tpu_torch.ops import dispatch

TOL = 2e-2


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(jnp.asarray(t, jnp.float32))


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = jllama.LlamaConfig.tiny(), tllama.LlamaConfig.tiny()
    jparams = jllama.init_llama(jcfg, seed=0)
    jq = jllama.quantize_llama(jparams, processor=JA16W8(dtype=jnp.bfloat16))
    dense = params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    tq = tllama.quantize_llama(dense, processor=A16W8_INT8(device="cpu", dtype=torch.bfloat16))
    carried = params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jq), device="cpu")
    return jcfg, tcfg, jq, tq, carried


def test_a16w8_layers_equal_jax(models):
    """The port's own A16W8 packing equals the JAX package's, layer by layer."""
    _, _, _, tq, carried = models
    for blk in range(len(tq["blocks"])):
        for grp, name in tllama._LINEAR_KEYS:
            a, b = tq["blocks"][blk][grp][name], carried["blocks"][blk][grp][name]
            assert a.get_meta_args() == b.get_meta_args()
            assert a.W_q.dtype == torch.int8 and a.meta.elements_per_sample == 1
            assert (a.meta.W_group_mode, a.meta.channel_scale_mode) == (2, 0)
            assert torch.equal(a.W_q, b.W_q) and torch.equal(a.scales, b.scales), (blk, name)


def test_a16w8_prefill_and_decode_logits_match_jax(models):
    jcfg, tcfg, jq, tq, _ = models
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, size=(1, 70)).astype(np.int32)
    prefill = jax.jit(jllama.llama_prefill, static_argnums=1)
    decode = jax.jit(jllama.llama_decode_step, static_argnums=1)
    jkv = jllama.init_kv_cache(jcfg, 1)
    jlog, jkv = prefill(jq, jcfg, jnp.asarray(tokens), jkv)
    tkv = tllama.init_kv_cache(tcfg, 1, device="cpu")
    dispatch.KERNEL_TRACE.clear()
    tlog, tkv = tllama.llama_prefill(tq, tcfg, torch.from_numpy(tokens), tkv)
    assert set(dispatch.KERNEL_TRACE) == {"plain_general_fused"}
    np.testing.assert_allclose(_np(tlog), _np(jlog), rtol=TOL, atol=TOL)
    pos = tokens.shape[1]
    for _ in range(4):
        tok = int(np.argmax(_np(jlog)[0, -1]))
        dispatch.KERNEL_TRACE.clear()
        jlog, jkv = decode(jq, jcfg, jnp.asarray([[tok]], jnp.int32), jkv, jnp.int32(pos))
        tlog, tkv = tllama.llama_decode_step(tq, tcfg, torch.tensor([[tok]]), tkv, pos)
        assert set(dispatch.KERNEL_TRACE) == {"plain_general_fused"}
        np.testing.assert_allclose(_np(tlog), _np(jlog), rtol=TOL, atol=TOL)
        pos += 1


def test_a16w8_engine_equals_the_bare_loop(models):
    """The engine's greedy tokens on the A16W8 model equal a bare
    prefill / decode loop of the model API."""
    _, tcfg, _, tq, _ = models
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tcfg.vocab_size, size=n).tolist() for n in (9, 40, 70)]
    eng = ContinuousBatchingEngine(tq, tcfg, max_batch=4, prefill_buckets=(16, 64, 128),
                                   device="cpu")
    got = eng.generate(prompts, max_new_tokens=5)
    for p, out in zip(prompts, got):
        kv = tllama.init_kv_cache(tcfg, 1, device="cpu")
        logits, kv = tllama.llama_prefill(tq, tcfg, torch.tensor([p]), kv)
        want = [int(torch.argmax(logits[0, -1]))]
        for pos in range(len(p), len(p) + 4):
            logits, kv = tllama.llama_decode_step(tq, tcfg, torch.tensor([[want[-1]]]), kv, pos)
            want.append(int(torch.argmax(logits[0, -1])))
        assert out == want
