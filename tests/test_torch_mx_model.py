# SPDX-License-Identifier: Apache-2.0
"""MX models in the port against gemlite_tpu on the CPU.

* ``quantize_llama`` with ``A16W4_MXFP``, ``A16W8_MXFP``,
  ``A8W8_MXFP_dynamic`` and ``A8W4_MXFP_dynamic`` (the four MX processors
  the JAX package's ``quantize_llama`` takes) packs the JAX package's
  bytes, layer by layer, once JAX's tree is carried into the port
  (``params_from_jax_numpy`` unfolds the planes and undoes the x2 codebook);
* the logits of a 70-token prefill and 3 decode steps of the two-layer tiny
  model agree within rtol / atol 2e-2 (tests/test_llama.py's bound for bf16
  logits), JAX run eagerly as in tests/test_torch_fp8_model.py;
* the repo's trained ``tiny_en_5m``: the nll of 2 held-out windows within
  2e-3 nats/byte of the JAX package's for A16W4_MXFP (JAX jitted: it
  quantizes no activation) and A8W8_MXFP_dynamic (JAX eager: under
  ``jax.jit`` XLA rewrites the per-token ``amax / 448``);
  A4W4_NVFP_dynamic has no JAX value, as JAX's quantize_llama raises for it;
* whole-model files cross both ways: JAX's ``save_model`` file of an
  A16W4_MXFP model (plane-folded, x2 codebook) loads as the port's own
  model, and the port's file loads in JAX with the bytes of JAX's layers
  in the reference layout;
* the engines: greedy tokens of the dense, paged and scan engines equal a
  bare prefill / decode loop for an A16W4_MXFP model (the scan engine on the
  stacked decode route), the dense and paged ones for A4W4_NVFP_dynamic,
  whose micro-scaled activations the scan engine refuses at construction.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemlite_tpu import checkpoint as jckpt
from gemlite_tpu import importers as jimp
from gemlite_tpu import mx as jmx
from gemlite_tpu.models import llama as jllama
from gemlite_tpu_torch import ContinuousBatchingEngine, load_model, params_from_jax_numpy, save_model
from gemlite_tpu_torch import importers as timp
from gemlite_tpu_torch import mx as tmx
from gemlite_tpu_torch.models import llama as tllama
from gemlite_tpu_torch.ops import dispatch

from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 2e-2
NLL_TOL = 2e-3
CKPT = Path(__file__).resolve().parent.parent / "checkpoints" / "tiny_en_5m"
PROCESSORS = {
    "a16w4_mxfp": (jmx.A16W4_MXFP, tmx.A16W4_MXFP),
    "a16w8_mxfp": (jmx.A16W8_MXFP, tmx.A16W8_MXFP),
    "a8w8_mxfp": (jmx.A8W8_MXFP_dynamic, tmx.A8W8_MXFP_dynamic),
    "a8w4_mxfp": (jmx.A8W4_MXFP_dynamic, tmx.A8W4_MXFP_dynamic),
}
_MODELS = {}


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _models(name):
    """(JAX config, port config, JAX model, port model, the JAX model carried
    into the port) of the tiny two-layer Llama, each quantized by its own
    package with ``name``'s processor."""
    if name not in _MODELS:
        jp, tp = PROCESSORS[name]
        jcfg, tcfg = jllama.LlamaConfig.tiny(), tllama.LlamaConfig.tiny()
        jparams = jllama.init_llama(jcfg, seed=0)
        jq = jllama.quantize_llama(jparams, processor=jp())
        dense = params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
        tq = tllama.quantize_llama(dense, processor=tp(device="cpu"), device="cpu")
        carried = params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jq), device="cpu")
        _MODELS[name] = (jcfg, tcfg, jq, tq, carried)
    return _MODELS[name]


@pytest.mark.parametrize("name", sorted(PROCESSORS))
def test_quantize_llama_packs_jax_bytes(name):
    *_, tq, carried = _models(name)
    for blk in range(len(tq["blocks"])):
        for grp, lin in tllama._LINEAR_KEYS:
            a, b = tq["blocks"][blk][grp][lin], carried["blocks"][blk][grp][lin]
            assert a.meta == b.meta, (blk, lin)
            assert torch.equal(a.W_q, b.W_q), (blk, lin)
            assert torch.equal(a.scales.view(torch.uint8), b.scales.view(torch.uint8)), (blk, lin)


@pytest.mark.parametrize("name", ["a16w4_mxfp", "a8w8_mxfp"])
def test_prefill_and_decode_logits_match_jax(name):
    jcfg, tcfg, jq, tq, _ = _models(name)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, size=(1, 70)).astype(np.int32)
    jkv = jllama.init_kv_cache(jcfg, 1)
    with jax.disable_jit():
        jlog, jkv = jllama.llama_prefill(jq, jcfg, jnp.asarray(tokens), jkv)
    tkv = tllama.init_kv_cache(tcfg, 1, device="cpu")
    dispatch.KERNEL_TRACE.clear()
    tlog, tkv = tllama.llama_prefill(tq, tcfg, torch.from_numpy(tokens), tkv)
    assert set(dispatch.KERNEL_TRACE) == {"plain_prefill"}
    np.testing.assert_allclose(_np(tlog), _np(jlog), rtol=TOL, atol=TOL)
    pos = tokens.shape[1]
    for _ in range(3):
        tok = int(np.argmax(_np(jlog)[0, -1]))
        with jax.disable_jit():
            jlog, jkv = jllama.llama_decode_step(jq, jcfg, jnp.asarray([[tok]], jnp.int32), jkv,
                                                 jnp.int32(pos))
        dispatch.KERNEL_TRACE.clear()
        tlog, tkv = tllama.llama_decode_step(tq, tcfg, torch.tensor([[tok]]), tkv, pos)
        assert set(dispatch.KERNEL_TRACE) == {"plain_decode"}
        np.testing.assert_allclose(_np(tlog), _np(jlog), rtol=TOL, atol=TOL)
        pos += 1


@pytest.fixture(scope="module")
def ckpt():
    jparams, jcfg = jimp.load_hf_llama(str(CKPT))
    tparams, tcfg = timp.load_hf_llama(str(CKPT), device="cpu")
    data = np.frombuffer((CKPT / "holdout.txt").read_bytes(), np.uint8)
    windows = np.stack([data[i * 128:(i + 1) * 128 + 1] for i in range(2)]).astype(np.int32)
    return jparams, jcfg, tparams, tcfg, windows


@pytest.mark.parametrize("name", ["a16w4_mxfp", "a8w8_mxfp"])
def test_tiny_en_5m_nll_matches_jax(ckpt, name):
    jparams, jcfg, tparams, tcfg, w = ckpt
    jp, tp = PROCESSORS[name]
    jq = jllama.quantize_llama(jparams, processor=jp())
    tq = tllama.quantize_llama(tparams, processor=tp(device="cpu"), device="cpu")
    args = (jq, jcfg, jnp.asarray(w[:, :-1]), jnp.asarray(w[:, 1:]))
    if name == "a8w8_mxfp":              # per-token x scales: eagerly, as explained above
        with jax.disable_jit():
            jloss = float(jllama.loss_fn(*args))
    else:
        jloss = float(jax.jit(jllama.loss_fn, static_argnums=1)(*args))
    tloss = float(tllama.loss_fn(tq, tcfg, torch.from_numpy(w[:, :-1]), torch.from_numpy(w[:, 1:])))
    print(f"tiny_en_5m {name}: nll/byte JAX (eager) {jloss:.6f} port {tloss:.6f}")
    assert 0.05 < tloss < 1.5
    assert abs(tloss - jloss) <= NLL_TOL, (tloss, jloss)


@pytest.mark.parametrize("name", ["a16w4_mxfp", "a8w8_mxfp"])
def test_model_files_cross_both_ways(name, tmp_path):
    _, _, jq, tq, _ = _models(name)
    jckpt.save_model(jq, str(tmp_path / "jax.npz"))
    loaded = load_model(str(tmp_path / "jax.npz"), device="cpu")
    save_model(tq, str(tmp_path / "port.npz"))
    back = jckpt.load_model(str(tmp_path / "port.npz"))
    for blk in range(len(tq["blocks"])):
        for grp, lin in tllama._LINEAR_KEYS:
            a, b = tq["blocks"][blk][grp][lin], loaded["blocks"][blk][grp][lin]
            assert a.meta == b.meta and torch.equal(a.W_q, b.W_q), (blk, lin)
            assert torch.equal(a.scales.view(torch.uint8), b.scales.view(torch.uint8))
            jl, jb = jq["blocks"][blk][grp][lin], back["blocks"][blk][grp][lin]
            assert jb.get_meta_args() == jl.get_meta_args() and not jb.w_layout
            ref = params_from_jax_numpy({"l": jax.tree_util.tree_map(np.asarray, jb)},
                                        device="cpu")["l"]
            assert torch.equal(ref.W_q, a.W_q) and torch.equal(ref.scales, a.scales)


def _bare_loop(params, cfg, prompt, n):
    kv = tllama.init_kv_cache(cfg, 1, device="cpu")
    logits, kv = tllama.llama_prefill(params, cfg, torch.tensor([prompt]), kv)
    out = [int(torch.argmax(logits[0, -1]))]
    for pos in range(len(prompt), len(prompt) + n - 1):
        logits, kv = tllama.llama_decode_step(params, cfg, torch.tensor([[out[-1]]]), kv, pos)
        out.append(int(torch.argmax(logits[0, -1])))
    return out


@pytest.fixture(scope="module")
def nvfp4_model():
    cfg = tllama.LlamaConfig.tiny()
    dense = tllama.init_llama(cfg, device="cpu")
    return cfg, tllama.quantize_llama(dense, processor=tmx.A4W4_NVFP_dynamic(device="cpu"))


@pytest.mark.parametrize("name", ["a16w4_mxfp", "a4w4_nvfp"])
def test_engines_equal_the_bare_loop(name, nvfp4_model):
    if name == "a4w4_nvfp":
        tcfg, tq = nvfp4_model
    else:
        _, tcfg, _, tq, _ = _models(name)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tcfg.vocab_size, size=n).tolist() for n in (9, 70)]
    want = [_bare_loop(tq, tcfg, p, 4) for p in prompts]
    kw = dict(max_batch=2, prefill_buckets=(16, 128), device="cpu")
    runs = {"dense": dict(paged=False), "paged": dict(page_size=16)}
    if name == "a16w4_mxfp":
        runs["scan"] = dict(paged=False, scan_layers=True)
    for engine, extra in runs.items():
        dispatch.KERNEL_TRACE.clear()
        got = ContinuousBatchingEngine(tq, tcfg, **kw, **extra).generate(prompts, 4)
        assert got == want, engine
        if engine == "scan":
            assert "plain_decode_stacked" in dispatch.KERNEL_TRACE


def test_scan_engine_refuses_micro_scaled_activations(nvfp4_model):
    tcfg, tq = nvfp4_model
    with pytest.raises(ValueError, match="micro-scaled"):
        ContinuousBatchingEngine(tq, tcfg, max_batch=2, paged=False, scan_layers=True,
                                 prefill_buckets=(16,), device="cpu")
