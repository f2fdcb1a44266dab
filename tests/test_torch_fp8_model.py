# SPDX-License-Identifier: Apache-2.0
"""FP8 models in the port against gemlite_tpu on the CPU.

* ``quantize_llama`` with ``A8W8_FP8_dynamic``, ``A16W8_FP8`` and
  ``A8W4_HQQ_INT_dynamic`` packs the JAX package's bytes, and the logits of
  a 70-token prefill and 3 decode steps of the two-layer tiny model agree
  within rtol / atol 2e-2 (tests/test_llama.py's bound for bf16 logits),
  JAX run eagerly, as below. Measured on this model: eagerly, the
  ``A8W8_FP8_dynamic`` prefill logits differ by at most 4.9e-4 and the
  decode logits not at all, and the ``A16W8_FP8`` ones by mean|a-b| /
  mean|b| 0.7%; under ``jax.jit`` the ``A8W8_FP8_dynamic`` logits move by
  mean|a-b| / mean|b| 3.4%, with 0.03% of them out of the band;
* the repo's trained ``tiny_en_5m`` quantized with ``A8W8_FP8_dynamic`` and
  ``A16W8_FP8``: the nll of 2 held-out windows within 2e-3 nats/byte of the
  JAX package's (the bound of tests/test_torch_real_weights.py), JAX run
  eagerly: under ``jax.jit`` XLA rewrites the per-token scale ``amax / 448``
  as ``amax * (1 / 448)``, which moves half the scales by an ulp and 0.08%
  of the e4m3 codes (the port's bytes are those of the function as written,
  which JAX computes eagerly), and the jitted nll then sits 3.5e-3 below;
* the engine: greedy tokens equal a bare prefill / decode loop; on the scan
  path an ``A16W8_FP8`` model serves the unrolled engine's tokens through the
  stacked decode route, and an ``A8W8_FP8_dynamic`` model (per-token scales,
  which the stacked path does not carry) is refused at construction.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemlite_tpu import helper as jh
from gemlite_tpu import importers as jimp
from gemlite_tpu.models import llama as jllama
from gemlite_tpu_torch import ContinuousBatchingEngine, params_from_jax_numpy
from gemlite_tpu_torch import helper as th
from gemlite_tpu_torch import importers as timp
from gemlite_tpu_torch.models import llama as tllama
from gemlite_tpu_torch.ops import dispatch

from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 2e-2
NLL_TOL = 2e-3
CKPT = Path(__file__).resolve().parent.parent / "checkpoints" / "tiny_en_5m"
PROCESSORS = {
    "a8w8_fp8": (lambda: jh.A8W8_FP8_dynamic(dtype=jnp.bfloat16),
                 lambda: th.A8W8_FP8_dynamic(device="cpu", dtype=torch.bfloat16)),
    "a16w8_fp8": (lambda: jh.A16W8_FP8(dtype=jnp.bfloat16),
                  lambda: th.A16W8_FP8(device="cpu", dtype=torch.bfloat16)),
    "a8w4_gs64": (lambda: jh.A8W4_HQQ_INT_dynamic(dtype=jnp.bfloat16),
                  lambda: th.A8W4_HQQ_INT_dynamic(device="cpu", dtype=torch.bfloat16)),
}
_MODELS = {}


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _models(name):
    """(JAX config, port config, JAX model, port model, the JAX model carried
    into the port) of the tiny two-layer Llama, each quantized by its own
    package with ``name``'s processor at group size 64."""
    if name not in _MODELS:
        jp, tp = PROCESSORS[name]
        jcfg, tcfg = jllama.LlamaConfig.tiny(), tllama.LlamaConfig.tiny()
        jparams = jllama.init_llama(jcfg, seed=0)
        jq = jllama.quantize_llama(jparams, processor=jp(), group_size=64)
        dense = params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
        tq = tllama.quantize_llama(dense, processor=tp(), group_size=64, device="cpu")
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
            for t in ("W_q", "scales", "zeros"):
                x, y = getattr(a, t), getattr(b, t)
                assert (x is None and y is None) or torch.equal(x, y), (blk, lin, t)


@pytest.mark.parametrize("name", ["a8w8_fp8", "a16w8_fp8"])
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


@pytest.mark.parametrize("name", ["a8w8_fp8", "a16w8_fp8"])
def test_tiny_en_5m_nll_matches_jax(ckpt, name):
    jparams, jcfg, tparams, tcfg, w = ckpt
    jp, tp = PROCESSORS[name]
    jq = jllama.quantize_llama(jparams, processor=jp())
    tq = tllama.quantize_llama(tparams, processor=tp(), device="cpu")
    with jax.disable_jit():
        jloss = float(jllama.loss_fn(jq, jcfg, jnp.asarray(w[:, :-1]), jnp.asarray(w[:, 1:])))
    tloss = float(tllama.loss_fn(tq, tcfg, torch.from_numpy(w[:, :-1]), torch.from_numpy(w[:, 1:])))
    print(f"tiny_en_5m {name}: nll/byte JAX (eager) {jloss:.6f} port {tloss:.6f}")
    assert 0.05 < tloss < 1.0
    assert abs(tloss - jloss) <= NLL_TOL, (tloss, jloss)


def _bare_loop(params, cfg, prompt, n):
    kv = tllama.init_kv_cache(cfg, 1, device="cpu")
    logits, kv = tllama.llama_prefill(params, cfg, torch.tensor([prompt]), kv)
    out = [int(torch.argmax(logits[0, -1]))]
    for pos in range(len(prompt), len(prompt) + n - 1):
        logits, kv = tllama.llama_decode_step(params, cfg, torch.tensor([[out[-1]]]), kv, pos)
        out.append(int(torch.argmax(logits[0, -1])))
    return out


def test_a8w8_fp8_engine_equals_the_bare_loop():
    _, tcfg, _, tq, _ = _models("a8w8_fp8")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tcfg.vocab_size, size=n).tolist() for n in (9, 70)]
    eng = ContinuousBatchingEngine(tq, tcfg, max_batch=2, prefill_buckets=(16, 128),
                                   device="cpu")
    got = eng.generate(prompts, max_new_tokens=4)
    assert got == [_bare_loop(tq, tcfg, p, 4) for p in prompts]


def test_scan_engine_a16w8_fp8_and_a8w8_fp8_refused():
    _, tcfg, _, tq, _ = _models("a16w8_fp8")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, tcfg.vocab_size, size=n).tolist() for n in (5, 12)]
    kw = dict(max_batch=2, paged=False, prefill_buckets=(16,), device="cpu")
    dispatch.KERNEL_TRACE.clear()
    scan = ContinuousBatchingEngine(tq, tcfg, scan_layers=True, **kw).generate(prompts, 4)
    assert "plain_decode_stacked" in dispatch.KERNEL_TRACE
    assert scan == ContinuousBatchingEngine(tq, tcfg, **kw).generate(prompts, 4)
    assert scan == [_bare_loop(tq, tcfg, p, 4) for p in prompts]
    _, _, _, a8, _ = _models("a8w8_fp8")
    with pytest.raises(ValueError, match="quantized per token"):
        ContinuousBatchingEngine(a8, tcfg, scan_layers=True, **kw)
