# SPDX-License-Identifier: Apache-2.0
"""The engine's decode step, the one the card captures in a CUDA graph, on
the CPU (where it runs eagerly, as the card runs it with ``graphs=False``).

* It reads nothing on the host: with ``Tensor.item``, ``__bool__``,
  ``__int__``, ``__float__``, ``__index__``, ``tolist``, ``numpy`` and
  ``cpu`` patched to raise around every call of the step, the dense
  unrolled, dense scan, fused scan and paged engines still serve the JAX
  engine's greedy tokens.
* The sampler picks argmax wherever the temperature is 0, for mixed
  temperatures too, and its draws are deterministic per seed.
* The paged engine keeps one block table tensor through admissions, page
  growth and finishes, holding the host's table.
* The static buffers: at each step the host's tokens, lengths and active
  mask are in them, and the step advances the lengths by ``active``.
* ``graphs=True`` raises on the CPU.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemlite_tpu.models import llama as jllama
from gemlite_tpu.serving import ContinuousBatchingEngine as JEngine
from gemlite_tpu_torch import ContinuousBatchingEngine, Request, params_from_jax_numpy
from gemlite_tpu_torch.models import llama as tllama
from gemlite_tpu_torch.serving import _next_bucket, sample_tokens
from test_torch_scan import TINY as SCAN_TINY
from test_torch_scan import _carried, _jax_model
from test_torch_serving import TINY as SERVE_TINY

HOST_READS = ("item", "__bool__", "__int__", "__float__", "__index__", "tolist", "numpy", "cpu")


@contextlib.contextmanager
def no_host_reads():
    """Every way a tensor's value reaches the host raises inside."""
    saved = {name: getattr(torch.Tensor, name) for name in HOST_READS}

    def refuse(name):
        def read(*args, **kwargs):
            raise AssertionError(f"the decode step read a tensor on the host (Tensor.{name})")
        return read

    for name in HOST_READS:
        setattr(torch.Tensor, name, refuse(name))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


def _guard(eng):
    """Run every call of the engine's decode step under no_host_reads."""
    step = eng._decode_step
    calls = []

    def guarded(t_active):
        with no_host_reads():
            out = step(t_active)
        calls.append(t_active)
        return out

    eng._decode_step = guarded
    return calls


@pytest.fixture(scope="module")
def serve_model():
    """tests/test_torch_serving.py's model: W4 gs 32, in both packages."""
    jcfg = jllama.LlamaConfig.tiny(**SERVE_TINY)
    jq = jllama.quantize_llama(jllama.init_llama(jcfg, seed=0), W_nbits=4, group_size=32)
    params = params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jq), device="cpu")
    return params, tllama.LlamaConfig.tiny(**SERVE_TINY), jq, jcfg


def _prompts(seed, lengths, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).tolist() for n in lengths]


@pytest.mark.parametrize("case", ["dense", "paged", "scan", "fused_scan"])
def test_step_reads_nothing_on_the_host(serve_model, case):
    """The prompts and token counts of the JAX comparisons in
    tests/test_torch_serving.py (dense, and paged on the same model) and
    tests/test_torch_scan.py (scan)."""
    if case in ("dense", "paged"):
        params, cfg, jq, jcfg = serve_model
        prompts, n_new = _prompts(0, (5, 9, 17), cfg.vocab_size), 6
        kw = dict(max_batch=2, prefill_buckets=(8, 16, 32), paged=case == "paged")
        if case == "paged":
            kw["page_size"] = 8
    else:
        jcfg, jq = _jax_model(fuse=case == "fused_scan")
        params, cfg = _carried(jq), tllama.LlamaConfig.tiny(**SCAN_TINY)
        prompts, n_new = _prompts(4, (5, 9, 14), cfg.vocab_size), 5
        kw = dict(max_batch=2, paged=False, prefill_buckets=(16,), scan_layers=True)
    eng = ContinuousBatchingEngine(params, cfg, device="cpu", **kw)
    calls = _guard(eng)
    got = eng.generate(prompts, max_new_tokens=n_new)
    assert len(calls) == eng.stats()["decode_steps"] > 0
    assert eng.stats()["graph_captures"] == 0 and not eng.graphs
    want = JEngine(jq, jcfg, **kw).generate(prompts, max_new_tokens=n_new)
    assert got == [[int(t) for t in out] for out in want]


def test_sampler_takes_argmax_where_temperature_is_zero():
    logits = torch.from_numpy(np.random.default_rng(0).normal(size=(6, 50)).astype(np.float32))
    temps = torch.tensor([0.0, 1.0, 0.0, 2.0, 0.5, 0.0])
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    draws = []
    for seed in (1, 1, 2):
        g = torch.Generator().manual_seed(seed)
        draws.append(torch.stack([sample_tokens(logits, temps, g) for _ in range(40)]))
    for d in draws:
        assert d.dtype == torch.int32
        assert torch.equal(d[:, temps == 0], greedy[temps == 0].expand(40, -1))
    assert torch.equal(draws[0], draws[1])                  # the same seed, the same draws
    assert not torch.equal(draws[0], draws[2])
    hot = draws[0][:, temps > 0]
    assert bool((hot != greedy[temps > 0]).any())           # T > 0 does not always take argmax
    cold = sample_tokens(logits, torch.full((6,), 1e-4), torch.Generator().manual_seed(3))
    assert torch.equal(cold, greedy)                        # a tiny temperature is argmax


def test_sampling_engine_is_deterministic_per_seed(serve_model):
    params, cfg, _, _ = serve_model
    prompts = _prompts(3, (5, 9, 12), cfg.vocab_size)

    def run(seed):
        eng = ContinuousBatchingEngine(params, cfg, max_batch=3, prefill_buckets=(16,),
                                       seed=seed, paged=False, device="cpu")
        for p, t in zip(prompts, (0.0, 1.0, 0.7)):
            eng.submit(Request(prompt_tokens=p, max_new_tokens=8, temperature=t))
        return {tuple(r.prompt_tokens): r.output_tokens for r in eng.run()}

    a = run(7)
    assert a == run(7)
    greedy = ContinuousBatchingEngine(params, cfg, max_batch=3, prefill_buckets=(16,),
                                      paged=False, device="cpu").generate(prompts[:1], 8)[0]
    assert a[tuple(prompts[0])] == greedy                   # the T = 0 request stays greedy


def test_paged_table_is_one_tensor(serve_model):
    """Admissions, page growth past a page boundary, finishes and slot reuse
    all go into the one table tensor the engine made, which holds the host's
    table at every prefill and decode step."""
    params, cfg, _, _ = serve_model
    eng = ContinuousBatchingEngine(params, cfg, max_batch=2, page_size=8,
                                   prefill_buckets=(8, 16, 32), device="cpu")
    table, ptr = eng.kv.table, eng.kv.table.data_ptr()
    seen = []

    def checking(fn):
        def run(*args):
            assert eng.kv.table is table and table.data_ptr() == ptr
            assert torch.equal(table, torch.from_numpy(eng.page_table))
            seen.append(tuple(len(pages) for pages in eng.slot_pages))
            return fn(*args)
        return run

    eng._decode, eng._prefill = checking(eng._decode), checking(eng._prefill)
    for n, p in enumerate(_prompts(6, (5, 12, 7, 20, 3), cfg.vocab_size)):
        eng.submit(Request(prompt_tokens=p, max_new_tokens=4 + 3 * n))
    assert len(eng.run()) == 5
    assert max(max(s) for s in seen) >= 3 and any(0 in s for s in seen)


def test_static_buffers_hold_the_host_state(serve_model):
    """At every step the static buffers hold the host's tokens and lengths
    for the active slots and the host's active mask (refilled after each
    admission and finish), and the step advances the lengths by active."""
    params, cfg, _, _ = serve_model
    eng = ContinuousBatchingEngine(params, cfg, max_batch=3, prefill_buckets=(8, 16, 32),
                                   paged=False, device="cpu")
    st = eng._static
    decode = eng._decode
    checked = {"steps": 0, "refills": 0}

    def watched(t_active):
        active = np.array([r is not None and eng.slot_pending[i] is None
                           for i, r in enumerate(eng.slot_req)])
        lens = eng.slot_len + np.array([max(len(o) - 1, 0) for o in eng.slot_out], np.int32)
        assert np.array_equal(st["active"].numpy(), active.astype(np.int32))
        assert np.array_equal(st["lens"].numpy()[active], lens[active])
        assert np.array_equal(st["tokens"].numpy()[active, 0], eng.slot_last[active])
        assert t_active == _next_bucket(int(lens[active].max()) + 1, eng.decode_buckets)
        before = st["lens"].clone()
        out = decode(t_active)
        assert torch.equal(st["lens"], before + st["active"])
        checked["steps"] += 1
        return out

    eng._decode = watched
    prompts = _prompts(9, (4, 6, 9, 5, 7), cfg.vocab_size)
    lens = (3, 9, 5, 7, 4)
    for p, n in zip(prompts, lens):
        eng.submit(Request(prompt_tokens=p, max_new_tokens=n))
    while eng.queue or eng.num_active:
        dirty = eng._dev_dirty or (eng.queue and eng.num_active < eng.max_batch)
        eng.step()
        checked["refills"] += bool(dirty)
    assert checked["steps"] == eng.stats()["decode_steps"] and checked["refills"] >= 3


def test_graphs_need_the_card(serve_model):
    params, cfg, _, _ = serve_model
    with pytest.raises(ValueError, match="graphs=True needs the card"):
        ContinuousBatchingEngine(params, cfg, paged=False, graphs=True, device="cpu")
    eng = ContinuousBatchingEngine(params, cfg, paged=False, graphs=False, device="cpu")
    assert not eng.graphs and eng.stats()["graph_captures"] == 0
