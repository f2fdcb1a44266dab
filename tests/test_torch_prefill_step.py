# SPDX-License-Identifier: Apache-2.0
"""The engine's prefill step, the one the card captures in a CUDA graph, on
the CPU (where it runs eagerly, as the card runs it with ``graphs=False``).

* It reads nothing on the host: under ``no_host_reads`` around every call of
  the prefill step (and of the decode step and the burst), the dense, paged,
  scan, paged with prefix hits and chunked prompts, and draft engines serve
  the JAX engine's greedy tokens.
* Its logits row and its cache writes equal the parent path's bit for bit:
  ``llama_forward`` on a view of the slot's stripe or table row at a host
  offset, for several slots, buckets (flash at 256), chunk offsets and true
  lengths; every other slot's stripe or pages stay as they were.
* At the model level a chunk at a 0-d offset tensor equals the host-int
  offset bit for bit, on the dense and the paged cache.
* The keys an engine steps through: one per one-shot bucket and one per
  chunk width, the power-of-two clamp near the cache end included.
* On the CPU the prefill counters stay 0, and the decode counters keep
  counting decode steps.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

from gemlite_tpu.models import llama as jllama
from gemlite_tpu.serving import ContinuousBatchingEngine as JEngine
from gemlite_tpu_torch import ContinuousBatchingEngine, Request, params_from_jax_numpy
from gemlite_tpu_torch.models import llama as tllama
from gemlite_tpu_torch.models.paged_kv import PagedKV
from test_torch_graph_step import _guard, no_host_reads
from test_torch_scan import TINY as SCAN_TINY
from test_torch_scan import _carried, _jax_model
from test_torch_serving import TINY as SERVE_TINY
from test_torch_spec import G as SPEC_G
from test_torch_spec import _mk_model
from test_torch_spec import _prompts as spec_prompts
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _guard_prefill(eng):
    """Run every call of the engine's prefill step under no_host_reads;
    returns the (width, chunk) of each call."""
    step = eng._prefill_step
    calls = []

    def guarded(width, chunk):
        with no_host_reads():
            out = step(width, chunk)
        calls.append((width, chunk))
        return out

    eng._prefill_step = guarded
    return calls


@contextlib.contextmanager
def _guarded_burst(eng):
    step = eng._spec_step

    def guarded(t_active):
        with no_host_reads():
            return step(t_active)

    eng._spec_step = guarded
    yield


def _serve_model():
    jcfg = jllama.LlamaConfig.tiny(**SERVE_TINY)
    jq = jllama.quantize_llama(jllama.init_llama(jcfg, seed=0), W_nbits=4, group_size=32)
    params = params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jq), device="cpu")
    return params, tllama.LlamaConfig.tiny(**SERVE_TINY), jq, jcfg


def _prompts(seed, lengths, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).tolist() for n in lengths]


def _shared_prompts():
    """A 20-token prompt, then two that share its first 16 tokens (two pages
    of 8: prefix hits, remainders chunk-prefilled), then one of 40 tokens
    prefilled in chunks of 16."""
    rng = np.random.default_rng(11)
    head = rng.integers(0, 128, size=20).tolist()
    return [head, head[:16] + rng.integers(0, 128, size=5).tolist(),
            head[:16] + rng.integers(0, 128, size=12).tolist(),
            rng.integers(0, 128, size=40).tolist()]


# case: the prompts and engine settings of tests/test_torch_graph_step.py
# (dense, paged: tests/test_torch_serving.py's model; scan: test_torch_scan's),
# one slot with prefix hits and chunks (no other slot decodes beside a chunk:
# the JAX engine overwrites a row there, ROADMAP Queue C), and
# tests/test_torch_spec.py's draft
CASES = ("dense", "paged", "scan", "prefix_chunks", "draft")


@pytest.mark.parametrize("case", CASES)
def test_prefill_step_reads_nothing_on_the_host(case):
    draft = None
    if case in ("dense", "paged", "prefix_chunks"):
        params, cfg, jq, jcfg = _serve_model()
        if case == "prefix_chunks":
            prompts, n_new = _shared_prompts(), 4
            kw = dict(max_batch=1, prefill_buckets=(8, 16, 32), page_size=8, prefill_chunk=16)
        else:
            prompts, n_new = _prompts(0, (5, 9, 17), cfg.vocab_size), 6
            kw = dict(max_batch=2, prefill_buckets=(8, 16, 32), paged=case == "paged")
            if case == "paged":
                kw["page_size"] = 8
    elif case == "scan":
        jcfg, jq = _jax_model()
        params, cfg = _carried(jq), tllama.LlamaConfig.tiny(**SCAN_TINY)
        prompts, n_new = _prompts(4, (5, 9, 14), cfg.vocab_size), 5
        kw = dict(max_batch=2, paged=False, prefill_buckets=(16,), scan_layers=True)
    else:
        (params, cfg, jq, jcfg), d = _mk_model(seed=0), _mk_model(seed=1, layers=1, heads=2,
                                                                  hidden=64)
        prompts, n_new = spec_prompts(), 12
        kw = dict(max_batch=4, spec_tokens=SPEC_G, paged=False)
        draft = d
    eng = ContinuousBatchingEngine(params, cfg, device="cpu",
                                   draft=draft and (draft[0], draft[1]), **kw)
    calls, decodes = _guard_prefill(eng), _guard(eng)
    with _guarded_burst(eng) if draft else contextlib.nullcontext():
        got = eng.generate(prompts, max_new_tokens=n_new)
    st = eng.stats()
    assert len(calls) == st["prefills"] + st["prefill_chunks"] > 0
    assert len(decodes) == st["decode_steps"]
    assert st["prefill_captures"] == st["prefill_replays"] == 0
    if case == "prefix_chunks":
        assert eng.prefix_cache_stats()["hit_pages"] == 4
        assert any(chunk for _, chunk in calls)
    if draft:
        assert st["spec_steps"] > 0
        kw["draft"] = (draft[2], draft[3])
    want = JEngine(jq, jcfg, **kw).generate(prompts, max_new_tokens=n_new)
    assert got == [[int(t) for t in out] for out in want]


@pytest.fixture(scope="module")
def tiny512():
    """A 2-layer model at max_seq_len 512, so that a bucket of 256 takes the
    flash branch (its plain version on the CPU)."""
    cfg = tllama.LlamaConfig.tiny(**{**SERVE_TINY, "max_seq_len": 512})
    params = tllama.quantize_llama(tllama.init_llama(cfg, seed=0, device="cpu"),
                                   group_size=32, device="cpu")
    return params, cfg


# (slot, width, offset, true length, chunk)
PIECES = ((1, 8, 0, 5, False), (2, 32, 0, 20, False), (0, 256, 0, 200, False),
          (2, 16, 24, 10, True), (0, 8, 40, 8, True), (1, 32, 480, 32, True))


@pytest.mark.parametrize("paged", [False, True])
def test_prefill_step_equals_the_slot_view_path(tiny512, paged):
    """Each piece through the engine's step and through ``llama_forward`` on
    the slot's view at the host offset (the parent's ``_prefill``), on a
    cache of random values (on the paged cache, a shuffled table with page 0
    for trash): the logits row, the first token and the whole cache bit for
    bit, so every other slot's stripe or pages are untouched."""
    params, cfg = tiny512
    B = 3
    gen = torch.Generator().manual_seed(5)
    eng = ContinuousBatchingEngine(params, cfg, max_batch=B, paged=paged, page_size=16,
                                   prefill_buckets=(8, 16, 32, 256), device="cpu")
    if paged:
        pps = eng.pages_per_seq
        eng.page_table[:] = (torch.randperm(B * pps, generator=gen) + 1).reshape(B, pps).numpy()
        eng.kv.load_table(eng.page_table)
        cache = eng.kv.pages
    else:
        cache = eng.kv
    cache.copy_(torch.randn(cache.shape, generator=gen).to(cache.dtype))
    rng = np.random.default_rng(6)
    for slot, width, offset, true_len, chunk in PIECES:
        eng.slot_req[slot] = Request(prompt_tokens=[0])
        padded = np.zeros((1, width), np.int32)
        padded[0, :true_len] = rng.integers(0, cfg.vocab_size, size=true_len)
        ref = cache.clone()
        if paged:
            kv = PagedKV(ref, eng.kv.table.clone(), eng.page_size)
            kv = kv.with_table(kv.table[slot:slot + 1])
        else:
            kv = ref[:, :, slot:slot + 1]
        logits, _ = tllama.llama_forward(params, cfg, torch.from_numpy(padded), kv=kv,
                                         cache_len=offset)
        want = logits[:, true_len - 1, :]
        got = eng._prefill(padded, slot, offset, true_len, chunk)
        assert torch.equal(got, want)
        assert int(eng._pf_static["token"][0]) == int(torch.argmax(want.float()))
        assert torch.equal(cache, ref)


@pytest.mark.parametrize("paged", [False, True])
def test_chunk_at_a_tensor_offset_equals_the_host_offset(tiny512, paged):
    params, cfg = tiny512
    gen = torch.Generator().manual_seed(7)
    B = 1 if paged else 2
    tokens = torch.randint(0, cfg.vocab_size, (B, 16), generator=gen)
    if paged:
        ps, pps = 16, cfg.max_seq_len // 16
        pages = torch.randn((cfg.num_layers, 2, cfg.num_kv_heads, 2 * pps + 1, ps,
                             cfg.head_dim), generator=gen).to(cfg.dtype)
        table = (torch.randperm(2 * pps, generator=gen)[:pps] + 1).to(torch.int32)[None]
        caches = [PagedKV(pages.clone(), table, ps) for _ in range(2)]
        state = [c.pages for c in caches]
    else:
        kv = torch.randn((cfg.num_layers, 2, B, cfg.max_seq_len, cfg.num_kv_heads,
                          cfg.head_dim), generator=gen).to(cfg.dtype)
        caches = state = [kv.clone(), kv.clone()]
    for offset in (24, 100, 496):
        host, _ = tllama.llama_forward(params, cfg, tokens, kv=caches[0], cache_len=offset)
        dev, _ = tllama.llama_forward(params, cfg, tokens, kv=caches[1],
                                      cache_len=torch.tensor(offset, dtype=torch.int32))
        assert torch.equal(host, dev)
        assert torch.equal(state[0], state[1])


def test_engine_steps_through_one_key_per_bucket_and_chunk_width(tiny512):
    """Prompts of 5 and 12 tokens take the one-shot buckets 8 and 16; one of
    60 tokens in chunks of 24 takes 24 at offsets 0 and 24, then, with 16
    rows left in a cache of 64, the power-of-two clamp 16."""
    params, cfg = tiny512
    cfg = tllama.LlamaConfig.tiny(**{**SERVE_TINY, "max_seq_len": 64})
    eng = ContinuousBatchingEngine(params, cfg, max_batch=3, prefill_buckets=(8, 16, 32),
                                   prefill_chunk=24, paged=False, device="cpu")
    keys = []
    run = eng._run_step

    def recording(key, fn, prefill=False):
        if prefill:
            keys.append(key)
        return run(key, fn, prefill)

    eng._run_step = recording
    out = eng.generate(_prompts(8, (5, 12, 60), cfg.vocab_size), max_new_tokens=3)
    assert [len(o) for o in out] == [3, 3, 3]
    assert keys == [("prefill", 8), ("prefill", 16), ("chunk", 24), ("chunk", 24),
                    ("chunk", 16)]
    st = eng.stats()
    assert st["prefills"] == 2 and st["prefill_chunks"] == 3


def test_prefill_counters_stay_zero_on_the_cpu(tiny512):
    params, cfg = tiny512
    eng = ContinuousBatchingEngine(params, cfg, max_batch=2, prefill_buckets=(8, 16),
                                   prefill_chunk=16, device="cpu")
    eng.generate(_prompts(9, (5, 30), cfg.vocab_size), max_new_tokens=4)
    st = eng.stats()
    assert not eng.graphs and not eng._prefill_graphs and not eng._graphs
    assert (st["prefill_captures"], st["prefill_replays"], st["prefill_capture_s"]) == (0, 0, 0.0)
    assert (st["graph_captures"], st["graph_replays"], st["capture_s"]) == (0, 0, 0.0)
    assert st["prefills"] == 1 and st["prefill_chunks"] == 2 and st["decode_steps"] >= 3
