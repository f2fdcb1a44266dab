# SPDX-License-Identifier: Apache-2.0
"""The port's Llama against gemlite_tpu.models.llama on LlamaConfig.tiny (CPU).

A JAX init_llama + quantize_llama tree carried through params_from_jax_numpy
gives the port's logits for prefill plus 4 decode steps within rtol/atol 2e-2,
the bound of tests/test_llama.py for bf16 logits that went through different
but equally valid summation orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemlite_tpu.models import llama as jllama
from gemlite_tpu_torch import params_from_jax_numpy
from gemlite_tpu_torch.models import llama as tllama

TOL = 2e-2


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny()
    tcfg = tllama.LlamaConfig.tiny()
    jparams = jllama.init_llama(jcfg, seed=0)
    jq = jllama.quantize_llama(jparams, W_nbits=4, group_size=64)
    carried = params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jq), device="cpu")
    return jcfg, tcfg, jparams, jq, carried


def _f32(a):
    return np.asarray(a.astype(jnp.float32)) if hasattr(a, "astype") and not \
        isinstance(a, torch.Tensor) else a.float().numpy()


def _bits(a):
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def test_init_equals_jax(models):
    _, tcfg, jparams, _, _ = models
    tparams = tllama.init_llama(tcfg, seed=0, device="cpu")
    for key in ("embed", "lm_head", "ln_f"):
        assert np.array_equal(_bits(jparams[key]), _bits(tparams[key])), key
    for jb, tb in zip(jparams["blocks"], tparams["blocks"], strict=True):
        for grp, name in tllama._LINEAR_KEYS:
            assert np.array_equal(_bits(jb[grp][name]), _bits(tb[grp][name])), (grp, name)
        for key in ("ln_attn", "ln_mlp"):
            assert np.array_equal(_bits(jb[key]), _bits(tb[key])), key


def test_quantize_llama_equals_carried(models):
    """The port's own quantize_llama packs the same bytes as the JAX one."""
    _, tcfg, _, _, carried = models
    own = tllama.quantize_llama(tllama.init_llama(tcfg, seed=0, device="cpu"),
                                W_nbits=4, group_size=64, device="cpu")
    for grp, name in tllama._LINEAR_KEYS:
        a, b = own["blocks"][1][grp][name], carried["blocks"][1][grp][name]
        assert a.get_meta_args() == b.get_meta_args()
        for t in ("W_q", "scales", "zeros"):
            assert torch.equal(getattr(a, t), getattr(b, t)), (name, t)


def test_prefill_and_decode_logits_match_jax(models):
    jcfg, tcfg, _, jq, carried = models
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, size=(1, 12)).astype(np.int32)
    prefill = jax.jit(jllama.llama_prefill, static_argnums=1)
    decode = jax.jit(jllama.llama_decode_step, static_argnums=1)
    jkv = jllama.init_kv_cache(jcfg, 1)
    jlog, jkv = prefill(jq, jcfg, jnp.asarray(tokens), jkv)
    tkv = tllama.init_kv_cache(tcfg, 1, device="cpu")
    tlog, tkv = tllama.llama_prefill(carried, tcfg, torch.from_numpy(tokens), tkv)
    np.testing.assert_allclose(_f32(tlog), _f32(jlog), rtol=TOL, atol=TOL)
    pos = tokens.shape[1]
    for _ in range(4):
        tok = int(np.argmax(_f32(jlog)[0, -1]))
        jlog, jkv = decode(jq, jcfg, jnp.asarray([[tok]], jnp.int32), jkv, jnp.int32(pos))
        tlog, tkv = tllama.llama_decode_step(carried, tcfg, torch.tensor([[tok]]), tkv, pos)
        np.testing.assert_allclose(_f32(tlog), _f32(jlog), rtol=TOL, atol=TOL)
        pos += 1


def test_no_cache_forward_equals_prefill(models):
    _, tcfg, _, _, carried = models
    tokens = torch.randint(0, tcfg.vocab_size, (2, 9), generator=torch.Generator().manual_seed(0))
    full = tllama.llama_forward(carried, tcfg, tokens)
    kv = tllama.init_kv_cache(tcfg, 2, device="cpu")
    cached, _ = tllama.llama_prefill(carried, tcfg, tokens, kv)
    torch.testing.assert_close(full.float(), cached.float(), rtol=TOL, atol=TOL)


def test_per_slot_offsets_match_single_sequences(models):
    """Batched decode at per-slot offsets equals each sequence decoded alone,
    and the verify step equals consecutive decode steps."""
    _, tcfg, _, _, carried = models
    g = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, tcfg.vocab_size, (1, n), generator=g) for n in (5, 11)]
    kv_b = tllama.init_kv_cache(tcfg, 2, device="cpu")
    singles = []
    for i, p in enumerate(prompts):
        tllama.llama_prefill(carried, tcfg, p, kv_b[:, :, i:i + 1])
        kv1 = tllama.init_kv_cache(tcfg, 1, device="cpu")
        tllama.llama_prefill(carried, tcfg, p, kv1)
        logit, _ = tllama.llama_decode_step(carried, tcfg, torch.tensor([[3]]), kv1, p.shape[1])
        singles.append(logit[0, 0])
    lens = torch.tensor([5, 11], dtype=torch.int32)
    batched, _ = tllama.llama_decode_step_batched(carried, tcfg, torch.tensor([[3], [3]]), kv_b,
                                                  lens, t_active=64)
    for i in range(2):
        torch.testing.assert_close(batched[i, 0].float(), singles[i].float(), rtol=TOL, atol=TOL)

    kv_v = tllama.init_kv_cache(tcfg, 1, device="cpu")
    tllama.llama_prefill(carried, tcfg, prompts[0], kv_v)
    kv_d = kv_v.clone()
    seq = torch.tensor([[3, 7, 9]])
    ver, _ = tllama.llama_verify_step(carried, tcfg, seq, kv_v, torch.tensor([5], dtype=torch.int32))
    for j in range(3):
        step, _ = tllama.llama_decode_step(carried, tcfg, seq[:, j:j + 1], kv_d, 5 + j)
        torch.testing.assert_close(ver[0, j].float(), step[0, 0].float(), rtol=TOL, atol=TOL)


def test_cache_write_outside_the_cache_raises(models):
    _, tcfg, _, _, carried = models
    kv = tllama.init_kv_cache(tcfg, 1, device="cpu")
    with pytest.raises(ValueError, match="outside the cache"):
        tllama.llama_forward(carried, tcfg, torch.zeros((1, 4), dtype=torch.long), kv=kv,
                             cache_len=tcfg.max_seq_len - 2)
