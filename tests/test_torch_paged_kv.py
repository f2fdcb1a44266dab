# SPDX-License-Identifier: Apache-2.0
"""The port's paged KV cache and prefix caching against the JAX package (CPU).

* ``paged_write`` / ``paged_gather`` store and read the same bits as JAX's,
  per-slot offsets and a shuffled table included;
* the plain paged decode attention equals JAX ``paged_decode_attention`` off
  the TPU (its ``_decode_attention_ref``) within max|a-b| <= 1e-5 on float32
  inputs (both sum in float32, in different orders);
* a paged forward (one-shot prefill, chunk at a cache offset, decode) gives
  the JAX package's logits within 2e-2, the bound of tests/test_llama.py;
* the paged engine's tokens equal the JAX paged engine's and the port's own
  dense engine's, a prompt of 256 tokens or more included;
* the host logic (mirroring tests/test_paged_kv.py and
  tests/test_prefix_cache.py): oversubscribed pools, exhaustion, the trash
  page, prefix hits, refcounts, LRU eviction, the near-max cap and hash
  collisions. Each scenario's tokens equal the dense engine's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemlite_tpu.models import llama as jllama
from gemlite_tpu.models import paged_kv as jpkv
from gemlite_tpu.serving import ContinuousBatchingEngine as JaxEngine
from gemlite_tpu_torch import (ContinuousBatchingEngine, Request, paged_kv_from_jax_numpy,
                               params_from_jax_numpy)
from gemlite_tpu_torch.models import llama as tllama
from gemlite_tpu_torch.models import paged_kv as tpkv
from gemlite_tpu_torch.ops import attention

ATOL = 1e-5
LOGIT_TOL = 2e-2


def _bits(a):
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def _table(kind, B, pps, rng):
    """Identity page ids, or each slot's pages drawn without repeats from
    1..B*pps with page 0 left as the trash page."""
    if kind == "identity":
        return (np.arange(B)[:, None] * pps + np.arange(pps)[None, :]).astype(np.int32)
    return (rng.permutation(B * pps)[:B * pps] + 1).reshape(B, pps).astype(np.int32)


@pytest.mark.parametrize("kind", ["identity", "shuffled"])
def test_write_gather_roundtrip_equals_jax(kind):
    cfg = jllama.LlamaConfig.tiny(max_seq_len=64)
    B, S, ps = 3, 10, 8
    rng = np.random.default_rng(5)
    table = _table(kind, B, cfg.max_seq_len // ps, rng)
    jkv = jpkv.init_paged_kv(cfg, B, page_size=ps, total_pages=B * 8 + 1).with_table(
        jnp.asarray(table))
    tkv = paged_kv_from_jax_numpy(np.asarray(jkv.pages), table, ps, device="cpu")
    k, v = (rng.normal(size=(B, S, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32)
            for _ in range(2))
    pos = np.array([[0], [5], [41]]) + np.arange(S)[None, :]           # per-slot offsets
    jkv = jpkv.paged_write(jkv, 1, jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
                           jnp.asarray(pos))
    out = tpkv.paged_write(tkv, 1, torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16(),
                           torch.from_numpy(pos))
    assert out is tkv                                                  # in place
    assert np.array_equal(_bits(tkv.pages), _bits(jkv.pages))
    for t_active in (0, 24):
        for a, b in zip(tpkv.paged_gather(tkv, 1, t_active), jpkv.paged_gather(jkv, 1, t_active)):
            assert np.array_equal(_bits(a), _bits(b))
    k_all, _ = tpkv.paged_gather(tkv, 1)
    for b, o in enumerate((0, 5, 41)):
        assert torch.equal(k_all[b, o:o + S], torch.from_numpy(k).bfloat16()[b])


@pytest.mark.parametrize("D", [64, 128])
def test_plain_paged_decode_matches_jax(D):
    """Lengths 1, ps-1, ps, ps+1 and full; GQA rep 2; a shuffled table."""
    rng = np.random.default_rng(D)
    ps, pps, Hkv, Hq = 16, 4, 2, 4
    lengths = np.array([1, ps - 1, ps, ps + 1, pps * ps], np.int32)
    B = len(lengths)
    P = B * pps + 1
    table = _table("shuffled", B, pps, rng)
    k_pages, v_pages = (rng.normal(size=(Hkv, P, ps, D)).astype(np.float32) for _ in range(2))
    q = rng.normal(size=(B, Hq, D)).astype(np.float32)
    pages = np.stack([np.stack([k_pages, v_pages])])                 # (1, 2, Hkv, P, ps, D)
    want = np.asarray(jpkv.paged_decode_attention(
        jnp.asarray(q), jpkv.PagedKV(jnp.asarray(pages), jnp.asarray(table), ps), 0,
        jnp.asarray(lengths)))
    tkv = paged_kv_from_jax_numpy(pages, table, ps, device="cpu")
    got = tpkv.paged_decode_attention(torch.from_numpy(q), tkv, 0, torch.from_numpy(lengths))
    assert got.dtype == torch.float32 and got.shape == (B, Hq, D)
    assert float(np.abs(got.numpy() - want).max()) <= ATOL


@pytest.fixture(scope="module")
def tiny512():
    """LlamaConfig.tiny(max_seq_len=512), W4 gs=64, in both packages."""
    jcfg = jllama.LlamaConfig.tiny(max_seq_len=512)
    jq = jllama.quantize_llama(jllama.init_llama(jcfg, seed=0), W_nbits=4, group_size=64)
    params = params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jq), device="cpu")
    return jq, jcfg, params, tllama.LlamaConfig.tiny(max_seq_len=512)


def _logits(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a.astype(jnp.float32))


def test_paged_forward_matches_jax(tiny512):
    """Slot 1 of two: one-shot prefill of 24 tokens, a 16-token chunk at cache
    offset 24, then a batched decode step, on a shuffled table."""
    jq, jcfg, params, tcfg = tiny512
    rng = np.random.default_rng(1)
    ps = 16
    pps = tcfg.max_seq_len // ps
    table = _table("shuffled", 2, pps, rng)
    jkv = jpkv.init_paged_kv(jcfg, 2, page_size=ps, total_pages=2 * pps + 1).with_table(
        jnp.asarray(table))
    tkv = paged_kv_from_jax_numpy(np.asarray(jkv.pages), table, ps, device="cpu")
    toks = rng.integers(0, jcfg.vocab_size, size=(1, 40)).astype(np.int32)

    j1 = jkv.with_table(jkv.table[1:2])
    jl, j1 = jllama.llama_forward(jq, jcfg, jnp.asarray(toks[:, :24]), kv=j1, cache_len=0)
    t1 = tkv.with_table(tkv.table[1:2])
    tl, _ = tllama.llama_forward(params, tcfg, torch.from_numpy(toks[:, :24]), kv=t1, cache_len=0)
    np.testing.assert_allclose(_logits(tl), _logits(jl), rtol=LOGIT_TOL, atol=LOGIT_TOL)

    jl, j1 = jllama.llama_forward(jq, jcfg, jnp.asarray(toks[:, 24:]), kv=j1,
                                  cache_len=jnp.int32(24))
    tl, _ = tllama.llama_forward(params, tcfg, torch.from_numpy(toks[:, 24:]), kv=t1,
                                 cache_len=torch.tensor(24, dtype=torch.int32))
    np.testing.assert_allclose(_logits(tl), _logits(jl), rtol=LOGIT_TOL, atol=LOGIT_TOL)

    jkv = j1.with_table(jkv.table)
    step = np.array([[3], [int(toks[0, -1])]], np.int32)
    lens = np.array([0, 40], np.int32)
    jl, _ = jllama.llama_decode_step_batched(jq, jcfg, jnp.asarray(step), jkv, jnp.asarray(lens))
    tl, _ = tllama.llama_decode_step_batched(params, tcfg, torch.from_numpy(step), tkv,
                                             torch.from_numpy(lens))
    np.testing.assert_allclose(_logits(tl)[1], _logits(jl)[1], rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_paged_engine_matches_jax_and_dense(tiny512, monkeypatch):
    jq, jcfg, params, tcfg = tiny512
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, jcfg.vocab_size, size=n).tolist() for n in (7, 40, 300, 20)]
    notes = []
    note = attention._note
    monkeypatch.setattr(attention, "_note", lambda name: (notes.append(name), note(name)))
    eng = ContinuousBatchingEngine(params, tcfg, max_batch=3, page_size=16, device="cpu")
    got = eng.generate(prompts, max_new_tokens=4)
    assert "plain_flash" in notes and "plain_paged_decode" in notes
    dense = ContinuousBatchingEngine(params, tcfg, max_batch=3, paged=False, device="cpu")
    assert got == dense.generate(prompts, max_new_tokens=4)
    jeng = JaxEngine(jq, jcfg, max_batch=3, page_size=16)
    assert got == [[int(t) for t in out] for out in jeng.generate(prompts, max_new_tokens=4)]


# ---------------------------------------------------------------------------
# host logic: allocator, trash page, prefix cache
# ---------------------------------------------------------------------------

TINY = dict(vocab_size=128, hidden_size=128, intermediate_size=256, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=32, max_seq_len=64)


@pytest.fixture(scope="module")
def tiny64():
    cfg = tllama.LlamaConfig.tiny(**TINY)
    return tllama.quantize_llama(tllama.init_llama(cfg, seed=0, device="cpu"),
                                 group_size=32, device="cpu"), cfg


def _engine(model, **kw):
    params, cfg = model
    kw = {"max_batch": 2, "prefill_buckets": (8, 16, 32), "page_size": 8, **kw}
    return ContinuousBatchingEngine(params, cfg, device="cpu", **kw)


def _rand(seed, *lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, size=n).tolist() for n in lengths]


def _shared(seed, prefix_len, *tails):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, 128, size=prefix_len).tolist()
    return [prefix + rng.integers(0, 128, size=n).tolist() for n in tails]


def _stat(key, op, value):
    return lambda eng: op(eng.prefix_cache_stats()[key], value)


# name: (engine kwargs, batches of prompts each served by one generate(),
#        new tokens, check on the engine afterwards)
SCENARIOS = {
    "oversubscribed_pool_recycles_pages": (
        dict(max_batch=3, page_size=16, total_pages=13, prefill_buckets=(8, 16, 32)),
        [_rand(5, 3, 19, 7, 12, 4, 16)], 8, lambda eng: len(eng.free_pages) + len(
            eng.prefix_cache) == 12),
    "exhausted_pool_requeues_the_request": (
        dict(total_pages=9, prefix_cache=False), [_rand(10, 17, 17, 17)], 3,
        lambda eng: sorted(eng.free_pages) == list(range(1, 9))),
    "repeat_prompt_hits_the_cache": (
        {}, [_rand(0, 21), _rand(0, 21)], 5,
        lambda eng: eng.prefix_cache_stats() == {"hit_pages": 2, "new_pages": 2,
                                                 "cached_pages": 2}),
    "shared_prefix_divergent_tails": (
        {}, [_shared(1, 16, 3, 7, 12)], 4, _stat("hit_pages", int.__ge__, 2)),
    "concurrent_sharers_keep_refcounts": (
        {}, [_shared(2, 16, 3, 5)], 8,
        lambda eng: all(v == 0 for v in eng.page_refs.values())
        and eng.prefix_cache_stats()["cached_pages"] >= 2),
    "lru_eviction_under_a_small_pool": (
        dict(max_batch=1, total_pages=9), [[p] for p in _rand(3, *range(17, 23))], 3,
        _stat("cached_pages", int.__le__, 8)),
    "near_max_rematch_caps_the_match": (
        {}, [_rand(6, 60), _rand(6, 60)], 3, _stat("hit_pages", int.__ge__, 0)),
    "near_max_prompt_nondividing_chunk": (
        dict(max_batch=1, prefill_buckets=(8, 16, 32, 64), prefill_chunk=20, prefix_cache=False),
        [_rand(8, 63)], 1, lambda eng: eng.stats()["prefill_chunks"] == 4),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_paged_engine_scenario_equals_dense(tiny64, name):
    kw, batches, n_new, check = SCENARIOS[name]
    dense_kw = {k: v for k, v in kw.items() if k not in ("page_size", "total_pages",
                                                          "prefix_cache")}
    eng, dense = _engine(tiny64, **kw), _engine(tiny64, paged=False, **dense_kw)
    for prompts in batches:
        assert eng.generate(prompts, max_new_tokens=n_new) == dense.generate(
            prompts, max_new_tokens=n_new)
    assert check(eng), eng.prefix_cache_stats()


def test_exhausted_pool_raises_when_nothing_runs(tiny64):
    eng = _engine(tiny64, page_size=16, total_pages=3)
    eng.submit(Request(prompt_tokens=list(range(1, 60)), max_new_tokens=4))
    with pytest.raises(RuntimeError, match="exhausted"):
        eng.run()


def test_trash_page_isolates_stale_writes(tiny64):
    """A finished slot's table row points at the trash page: its stale decode
    writes do not reach the other slot's pages."""
    short, long_ = _rand(7, 6, 9)
    eng = _engine(tiny64, page_size=16)
    eng.submit(Request(prompt_tokens=short, max_new_tokens=2))          # finishes early
    eng.submit(Request(prompt_tokens=long_, max_new_tokens=12))
    res = {tuple(r.prompt_tokens): r.output_tokens for r in eng.run()}
    assert (eng.page_table == 0).all()
    assert res[tuple(long_)] == _engine(tiny64, page_size=16).generate([long_], 12)[0]


def test_cached_admission_prefills_only_the_remainder(tiny64):
    (prompt,) = _rand(4, 20)
    eng = _engine(tiny64)
    eng.generate([prompt], max_new_tokens=2)
    eng.submit(Request(prompt_tokens=prompt, max_new_tokens=2))
    eng._admit()
    slot = next(i for i, r in enumerate(eng.slot_req) if r is not None)
    assert eng.slot_len[slot] == 16 and len(eng.slot_pending[slot]) == 4
    assert eng._remainder_chunk(4) == 8 and eng._remainder_chunk(100) == 32
    eng.run()
    assert eng.stats()["prefix_cache"]["hit_pages"] == 2


def test_hash_collision_never_attaches(tiny64):
    """An entry with the prompt's hash but other tokens is not attached."""
    (prompt,) = _rand(9, 20)
    eng = _engine(tiny64)
    h0 = eng._chain_hashes(prompt, eng.page_size, 1)[0]
    eng.prefix_cache[h0] = (3, tuple([999] * eng.page_size))
    eng.submit(Request(prompt_tokens=prompt, max_new_tokens=1))
    eng._admit()
    assert eng.prefix_stats["hit_pages"] == 0
    assert all(3 not in pages for pages in eng.slot_pages)
    eng.prefix_cache.clear()
    assert len(eng.run()[0].output_tokens) == 1
