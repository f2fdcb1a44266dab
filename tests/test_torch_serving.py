# SPDX-License-Identifier: Apache-2.0
"""The port's ContinuousBatchingEngine on the dense KV cache (``paged=False``)
on a tiny quantized Llama (CPU); tests/test_torch_paged_kv.py covers the
paged cache and prefix caching.

* engine output == the port's bare greedy prefill/decode loop, through slot
  recycling and chunked prefill;
* engine output == the JAX package's bare loop (greedy only: JAX's PRNG
  stream is not reproduced, so sampling is tested for determinism per seed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemlite_tpu.models import llama as jllama
from gemlite_tpu_torch import ContinuousBatchingEngine, Request, params_from_jax_numpy
from gemlite_tpu_torch.models import llama as tllama

TINY = dict(vocab_size=128, hidden_size=128, intermediate_size=256, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=32, max_seq_len=64)


@pytest.fixture(scope="module")
def model():
    jcfg = jllama.LlamaConfig.tiny(**TINY)
    jq = jllama.quantize_llama(jllama.init_llama(jcfg, seed=0), W_nbits=4, group_size=32)
    params = params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jq), device="cpu")
    return params, tllama.LlamaConfig.tiny(**TINY), jq, jcfg


def reference_generate(params, cfg, prompt, n_new):
    """Single-sequence greedy generation with the port's model API."""
    kv = tllama.init_kv_cache(cfg, 1, device="cpu")
    tokens = torch.tensor([prompt], dtype=torch.int32)
    logits, kv = tllama.llama_prefill(params, cfg, tokens, kv)
    out = [int(torch.argmax(logits[0, -1]))]
    pos = len(prompt)
    for _ in range(n_new - 1):
        logits, kv = tllama.llama_decode_step(params, cfg, torch.tensor([[out[-1]]]), kv, pos)
        out.append(int(torch.argmax(logits[0, -1])))
        pos += 1
    return out


def jax_reference_generate(jq, jcfg, prompt, n_new):
    """tests/test_serving.py's reference_generate, jitted."""
    prefill = jax.jit(jllama.llama_prefill, static_argnums=1)
    decode = jax.jit(jllama.llama_decode_step, static_argnums=1)
    kv = jllama.init_kv_cache(jcfg, 1)
    logits, kv = prefill(jq, jcfg, jnp.asarray(np.asarray(prompt, np.int32)[None, :]), kv)
    out = [int(jnp.argmax(logits[0, -1]))]
    pos = len(prompt)
    for _ in range(n_new - 1):
        logits, kv = decode(jq, jcfg, jnp.asarray([[out[-1]]], jnp.int32), kv, jnp.int32(pos))
        out.append(int(jnp.argmax(logits[0, -1])))
        pos += 1
    return out


def _prompts(seed, lengths, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).tolist() for n in lengths]


def test_engine_matches_bare_loop_and_jax(model):
    params, cfg, jq, jcfg = model
    prompts = _prompts(0, (5, 9, 17), cfg.vocab_size)
    want = [reference_generate(params, cfg, p, 6) for p in prompts]
    eng = ContinuousBatchingEngine(params, cfg, max_batch=4, prefill_buckets=(8, 16, 32),
                                   paged=False, device="cpu")
    assert eng.generate(prompts, max_new_tokens=6) == want
    assert [jax_reference_generate(jq, jcfg, p, 6) for p in prompts] == want


def test_slot_recycling_more_requests_than_slots(model):
    params, cfg, _, _ = model
    prompts = _prompts(1, [4 + i for i in range(7)], cfg.vocab_size)
    reqs = [Request(prompt_tokens=p, max_new_tokens=3 + (i % 3)) for i, p in enumerate(prompts)]
    eng = ContinuousBatchingEngine(params, cfg, max_batch=2, prefill_buckets=(8, 16),
                                   paged=False, device="cpu")
    for r in reqs:
        eng.submit(r)
    by_id = {r.request_id: r for r in eng.run()}
    assert len(by_id) == 7
    for req in reqs:
        assert by_id[req.request_id].output_tokens == reference_generate(
            params, cfg, req.prompt_tokens, req.max_new_tokens)
    assert eng.stats()["prefills"] == 7


def test_chunked_prefill_matches_bare_loop(model):
    params, cfg, _, _ = model
    long_p, short_p = _prompts(4, (21, 5), cfg.vocab_size)
    eng = ContinuousBatchingEngine(params, cfg, max_batch=4, prefill_buckets=(8, 16, 32),
                                   prefill_chunk=8, paged=False, device="cpu")
    eng.submit(Request(prompt_tokens=short_p, max_new_tokens=6))
    eng.step()                     # the short prompt decodes while the long one chunks in
    eng.submit(Request(prompt_tokens=long_p, max_new_tokens=6))
    got = {tuple(r.prompt_tokens): r.output_tokens for r in eng.run()}
    assert got[tuple(long_p)] == reference_generate(params, cfg, long_p, 6)
    assert got[tuple(short_p)] == reference_generate(params, cfg, short_p, 6)
    assert eng.stats()["prefill_chunks"] == 3


def test_chunk_width_clamped_near_the_cache_end(model):
    """A 62-token prompt in 24-token chunks: the third chunk would write past
    the 64-row cache, so it shrinks to the power of two that fits."""
    params, cfg, _, _ = model
    (p,) = _prompts(5, (62,), cfg.vocab_size)
    eng = ContinuousBatchingEngine(params, cfg, max_batch=1, prefill_buckets=(8, 16, 32),
                                   prefill_chunk=24, paged=False, device="cpu")
    (r,) = eng.generate([p], max_new_tokens=4)
    assert r == reference_generate(params, cfg, p, 1)      # the cache is full after one
    assert eng.stats()["prefill_chunks"] == 3


def test_late_arrival_and_eos(model):
    params, cfg, _, _ = model
    p1, p2 = _prompts(2, (6, 7), cfg.vocab_size)
    eng = ContinuousBatchingEngine(params, cfg, max_batch=4, prefill_buckets=(8, 16),
                                   paged=False, device="cpu")
    eng.submit(Request(prompt_tokens=p1, max_new_tokens=8))
    for _ in range(3):
        eng.step()
    eng.submit(Request(prompt_tokens=p2, max_new_tokens=8))
    got = {tuple(r.prompt_tokens): r.output_tokens for r in eng.run()}
    assert got[tuple(p2)] == reference_generate(params, cfg, p2, 8)

    full = reference_generate(params, cfg, p1, 8)
    eos = full[2]
    eng = ContinuousBatchingEngine(params, cfg, max_batch=2, eos_id=eos, prefill_buckets=(8,),
                                   paged=False, device="cpu")
    eng.submit(Request(prompt_tokens=p1, max_new_tokens=8))
    r = eng.run()[0]
    assert r.finish_reason == "eos" and r.output_tokens == full[:full.index(eos) + 1]


def test_sampling_is_deterministic_per_seed(model):
    params, cfg, _, _ = model
    prompts = _prompts(3, (5, 9), cfg.vocab_size)

    def run(seed):
        eng = ContinuousBatchingEngine(params, cfg, max_batch=2, prefill_buckets=(16,),
                                       seed=seed, paged=False, device="cpu")
        return eng.generate(prompts, max_new_tokens=8, temperature=1.0)

    assert run(5) == run(5)
    assert all(0 <= t < cfg.vocab_size for out in run(6) for t in out)


@pytest.mark.parametrize("paged", [False, True])
def test_chunks_beside_a_decoding_slot_keep_their_rows(model, paged):
    """Prompts prefilled in chunks of 8 while another slot decodes. A chunk
    moves its slot's offset past the one the decode step's device lens hold
    for that idle slot; the engine uploads the host's lens again after every
    chunk, so the idle slot's stale write lands past its prompt, not on the
    chunk's first row. The tokens equal one-shot prefills'. (The JAX engine
    keeps its device lens across chunks and overwrites that row: ROADMAP
    Queue C.)"""
    params, cfg, _, _ = model
    prompts = _prompts(3, (21, 6, 30), cfg.vocab_size)
    eng = ContinuousBatchingEngine(params, cfg, max_batch=4, prefill_chunk=8,
                                   prefill_buckets=(8, 16, 32), paged=paged, device="cpu")
    got = eng.generate(prompts, max_new_tokens=4)
    assert eng.stats()["prefill_chunks"] == 7
    assert got == [reference_generate(params, cfg, p, 4) for p in prompts]


@pytest.mark.parametrize("kwargs", [{"scan_layers": True}, {"mesh": object()}])
def test_queued_options_raise(model, kwargs):
    """mesh= is queued; scan_layers=True is ported for the dense cache only
    (tests/test_torch_scan.py), so with the default paged=True it raises as
    the JAX engine does. draft= is ported (tests/test_torch_spec.py)."""
    params, cfg, _, _ = model
    if "scan_layers" in kwargs:
        with pytest.raises(ValueError, match="paged=False"):
            ContinuousBatchingEngine(params, cfg, device="cpu", **kwargs)
        return
    with pytest.raises(NotImplementedError, match="queued"):
        ContinuousBatchingEngine(params, cfg, device="cpu", **kwargs)


def test_prompt_checks(model):
    params, cfg, _, _ = model
    eng = ContinuousBatchingEngine(params, cfg, device="cpu")
    with pytest.raises(ValueError):
        eng.submit(Request(prompt_tokens=[]))
    with pytest.raises(ValueError):
        eng.submit(Request(prompt_tokens=list(range(cfg.max_seq_len))))
