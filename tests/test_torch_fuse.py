# SPDX-License-Identifier: Apache-2.0
"""Fused ``wqkv`` / ``gate_up`` layers (``quantize_llama(fuse=True)``) in the
port against gemlite_tpu.models.llama on a tiny config (CPU).

* the port's ``fuse=True`` packs the JAX package's bytes and metadata, for
  the HQQ W4 default and for A8W8;
* a JAX ``fuse=True`` model carried across gives the JAX logits for prefill
  plus 4 decode steps within rtol/atol 2e-2, the bound of
  tests/test_torch_llama.py;
* a fused layer packs the separate layers' bytes side by side along N;
* the dense and paged engines serve a fused model with the tokens of the
  unfused one;
* ``stack_blocks`` stacks fused layers and refuses blocks that mix fused and
  separate ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemlite_tpu import helper as jhelper
from gemlite_tpu.models import llama as jllama
from gemlite_tpu_torch import ContinuousBatchingEngine, params_from_jax_numpy
from gemlite_tpu_torch import helper as thelper
from gemlite_tpu_torch.models import llama as tllama
from gemlite_tpu_torch.models.scan_llama import stack_blocks

TOL = 2e-2
FUSED_KEYS = (("attn", "wqkv"), ("attn", "wo"), ("mlp", "gate_up"), ("mlp", "down"))
PROCESSORS = ("w4", "a8w8")


def _quantize(mod, params, proc, fuse, **kw):
    if proc == "w4":
        return mod.quantize_llama(params, W_nbits=4, group_size=64, fuse=fuse, **kw)
    if mod is jllama:
        p = jhelper.A8W8_INT8_dynamic(dtype=jnp.bfloat16)
    else:
        p = thelper.A8W8_INT8_dynamic(device="cpu", dtype=torch.bfloat16)
    return mod.quantize_llama(params, processor=p, fuse=fuse, **kw)


@pytest.fixture(scope="module", params=PROCESSORS)
def models(request):
    proc = request.param
    jcfg, tcfg = jllama.LlamaConfig.tiny(), tllama.LlamaConfig.tiny()
    jq = _quantize(jllama, jllama.init_llama(jcfg, seed=0), proc, True)
    carried = params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jq), device="cpu")
    own = _quantize(tllama, tllama.init_llama(tcfg, seed=0, device="cpu"), proc, True,
                    device="cpu")
    return jcfg, tcfg, jq, carried, own, proc


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a.astype(jnp.float32))


@pytest.mark.parametrize("grp,name", FUSED_KEYS)
def test_fuse_packs_the_jax_bytes(models, grp, name):
    _, _, _, carried, own, _ = models
    for i in range(len(own["blocks"])):
        a, b = own["blocks"][i][grp][name], carried["blocks"][i][grp][name]
        assert set(own["blocks"][i][grp]) == set(carried["blocks"][i][grp])
        assert a.get_meta_args() == b.get_meta_args()
        for t in ("W_q", "scales", "zeros"):
            x, y = getattr(a, t), getattr(b, t)
            assert (x is None) == (y is None), (i, name, t)
            if x is not None:
                assert torch.equal(x, y), (i, name, t)


def test_fused_logits_match_jax(models):
    jcfg, tcfg, jq, carried, _, _ = models
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, size=(1, 12)).astype(np.int32)
    prefill = jax.jit(jllama.llama_prefill, static_argnums=1)
    decode = jax.jit(jllama.llama_decode_step, static_argnums=1)
    jlog, jkv = prefill(jq, jcfg, jnp.asarray(tokens), jllama.init_kv_cache(jcfg, 1))
    tlog, tkv = tllama.llama_prefill(carried, tcfg, torch.from_numpy(tokens),
                                     tllama.init_kv_cache(tcfg, 1, device="cpu"))
    np.testing.assert_allclose(_f32(tlog), _f32(jlog), rtol=TOL, atol=TOL)
    pos = tokens.shape[1]
    for _ in range(4):
        tok = int(np.argmax(_f32(jlog)[0, -1]))
        jlog, jkv = decode(jq, jcfg, jnp.asarray([[tok]], jnp.int32), jkv, jnp.int32(pos))
        tlog, tkv = tllama.llama_decode_step(carried, tcfg, torch.tensor([[tok]]), tkv, pos)
        np.testing.assert_allclose(_f32(tlog), _f32(jlog), rtol=TOL, atol=TOL)
        pos += 1


@pytest.mark.parametrize("proc", PROCESSORS)
def test_fused_layer_is_the_separate_layers_side_by_side(proc):
    cfg = tllama.LlamaConfig.tiny()
    dense = tllama.init_llama(cfg, seed=1, device="cpu")
    fused = _quantize(tllama, dense, proc, True, device="cpu")["blocks"][0]
    apart = _quantize(tllama, dense, proc, False, device="cpu")["blocks"][0]
    for grp, name, parts in (("attn", "wqkv", ("wq", "wk", "wv")), ("mlp", "gate_up", ("gate", "up"))):
        f = fused[grp][name]
        assert f.out_features == sum(apart[grp][p].out_features for p in parts)
        for t in ("W_q", "scales", "zeros"):
            want = [getattr(apart[grp][p], t) for p in parts]
            if want[0] is None or want[0].ndim == 0:
                assert all(torch.equal(getattr(f, t), w) for w in want) if want[0] is not None \
                    else getattr(f, t) is None
                continue
            assert torch.equal(getattr(f, t), torch.cat(want, dim=-1)), (name, t)


def _tiny_fused_pair(max_seq_len):
    cfg = tllama.LlamaConfig.tiny(max_seq_len=max_seq_len)
    dense = tllama.init_llama(cfg, seed=0, device="cpu")
    return cfg, (_quantize(tllama, dense, "w4", fuse, device="cpu") for fuse in (False, True))


@pytest.mark.parametrize("paged", [False, True])
def test_engines_serve_a_fused_model(paged):
    cfg, (apart, fused) = _tiny_fused_pair(512 if paged else 128)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in (5, 20, 70)]
    kw = dict(max_batch=2, prefill_buckets=(32, 64, 128), paged=paged, device="cpu")
    if paged:
        kw["page_size"] = 16
    want = ContinuousBatchingEngine(apart, cfg, **kw).generate(prompts, max_new_tokens=5)
    got = ContinuousBatchingEngine(fused, cfg, **kw).generate(prompts, max_new_tokens=5)
    assert got == want


def test_scan_stack_still_refuses_fused_layers():
    """A fused model stacks its fused layers (tests/test_torch_scan.py holds
    them against the JAX package); blocks that mix fused and separate layers
    are still refused."""
    _, (apart, fused) = _tiny_fused_pair(128)
    mixed = dict(fused, blocks=[fused["blocks"][0], apart["blocks"][1]])
    with pytest.raises(ValueError, match=r"block 1 lacks attn\.\['wqkv'\]"):
        stack_blocks(mixed)
    stacked = stack_blocks(fused)
    assert sorted(stacked["attn"]) == ["wo", "wqkv"] and sorted(stacked["mlp"]) == ["down", "gate_up"]
