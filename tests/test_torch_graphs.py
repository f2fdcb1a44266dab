# SPDX-License-Identifier: Apache-2.0
"""The engine's captured decode step on the card.

Card-only: each test skips where no CUDA device is present. On the card:

    python -m pytest --noconftest -m requires_cuda tests/test_torch_graphs.py -q

* The captured engine (the default on the card) serves the tokens of the
  eager engine (``graphs=False``) and of a bare prefill/decode loop, on the
  dense cache unrolled, scan and fused scan, and on the paged cache with
  prefix hits and recycled slots.
* After each replay the launch counts, the route traces and the logits are
  those of the same eager step.
* A replay makes no host sync (``torch.cuda.set_sync_debug_mode("error")``)
  and leaves the split scratch's int32 part 0.
* A capture that fails raises.
* The speculative burst (``draft=``): captured bursts give the eager ones'
  tokens, greedy and sampled; a burst's replay makes no host sync, and a
  burst downloads one tensor.

The model: ``LlamaConfig.tiny`` widened to hidden 1024, intermediate 2048 and
head_dim 128, so that the decode kernel splits K and the paged decode kernel
takes its heads; W4 gs 64.
"""

import numpy as np
import pytest
import torch

from gemlite_tpu_torch import (ContinuousBatchingEngine, LlamaConfig, Request, init_llama,
                               quantize_llama)
from gemlite_tpu_torch import serving
from gemlite_tpu_torch.graphs import COUNTED
from gemlite_tpu_torch.models.llama import (init_kv_cache, llama_decode_step_batched,
                                            llama_forward)
from gemlite_tpu_torch.models.paged_kv import init_paged_kv
from gemlite_tpu_torch.ops import attention, dispatch

pytestmark = pytest.mark.requires_cuda

CFG = dict(vocab_size=512, hidden_size=1024, intermediate_size=2048, num_layers=2, num_heads=8,
           num_kv_heads=2, head_dim=128, max_seq_len=512)
ENGINES = {"dense": dict(paged=False), "scan": dict(paged=False, scan_layers=True),
           "fused_scan": dict(paged=False, scan_layers=True), "paged": dict(page_size=16)}
BUCKETS = (32, 64, 128, 256, 512)


@pytest.fixture(scope="module")
def models():
    """(cfg, {fuse: params}): one random init quantized apart and fused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = LlamaConfig.tiny(**CFG)
    dense = init_llama(cfg, seed=0, device="cuda")
    return cfg, {fuse: quantize_llama(dense, group_size=64, fuse=fuse, device="cuda")
                 for fuse in (False, True)}


def _engine(models, case, **kw):
    cfg, params = models
    return ContinuousBatchingEngine(params[case == "fused_scan"], cfg, max_batch=3,
                                    prefill_buckets=BUCKETS, device="cuda",
                                    **ENGINES[case], **kw)


def _bare(eng, prompts, n_new):
    """Greedy generation with the model API in the engine's shapes: each
    prompt prefilled in its bucket into its own cache stripe or table row,
    then every slot decoded together."""
    params, cfg, B = eng.params, eng.cfg, len(prompts)
    if eng.paged:
        kv = init_paged_kv(cfg, B, eng.page_size, device="cuda")      # slot b: its own pages

        def slot(i):
            return kv.with_table(kv.table[i:i + 1])
    else:
        kv = init_kv_cache(cfg, B, device="cuda")

        def slot(i):
            return kv[:, :, i:i + 1]
    out = []
    for i, p in enumerate(prompts):
        padded = torch.zeros((1, serving._next_bucket(len(p), eng.buckets)), dtype=torch.int32,
                             device="cuda")
        padded[0, :len(p)] = torch.tensor(p, dtype=torch.int32)
        logits, _ = llama_forward(params, cfg, padded, kv=slot(i), cache_len=0)
        out.append([int(torch.argmax(logits[0, len(p) - 1]))])
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device="cuda")
    for _ in range(n_new - 1):
        t_act = None if eng.paged else serving._next_bucket(int(lens.max()) + 1,
                                                            eng.decode_buckets)
        tok = torch.tensor([[o[-1]] for o in out], dtype=torch.int32, device="cuda")
        logits, _ = llama_decode_step_batched(params, cfg, tok, kv, lens, t_active=t_act)
        for o, t in zip(out, torch.argmax(logits[:, 0].float(), dim=-1).tolist()):
            o.append(int(t))
        lens = lens + 1
    return out


def _rounds(vocab):
    """Three rounds of three prompts: short ones (the dense cache's bucket
    256), long ones (bucket 512; one of 300 tokens on the flash kernel), then
    two that share that prompt's first 288 tokens (18 pages of 16: prefix
    hits on the paged cache) and a short one, in recycled slots."""
    rng = np.random.default_rng(0)

    def r(n):
        return rng.integers(0, vocab, size=n).tolist()

    short, long_ = [r(20), r(70), r(9)], [r(300), r(100), r(40)]
    return short, long_, [long_[0][:288] + r(5), long_[0][:288] + r(40), r(12)]


@pytest.mark.parametrize("case", list(ENGINES))
def test_captured_engine_equals_eager_engine_and_bare_loop(models, case):
    rounds = _rounds(models[0].vocab_size)
    runs = {}
    for graphs in (False, True):
        eng = _engine(models, case, graphs=graphs)
        runs[graphs] = (eng, [eng.generate(prompts, max_new_tokens=6) for prompts in rounds])
    (eager, want), (captured, got) = runs[False], runs[True]
    assert captured.graphs and not eager.graphs
    assert got == want
    assert got[:2] == [_bare(captured, prompts, 6) for prompts in rounds[:2]]
    st = captured.stats()
    assert st["graph_captures"] == (1 if case == "paged" else 2)      # one graph a bucket
    assert st["graph_replays"] == st["decode_steps"] - st["graph_captures"] > 0
    assert st["graph_pool_bytes"] > 0 and eager.stats()["graph_captures"] == 0
    if case == "paged":
        hits = captured.prefix_cache_stats()["hit_pages"]
        assert hits == eager.prefix_cache_stats()["hit_pages"] == 36


@pytest.mark.parametrize("case", ["dense", "scan", "paged"])
def test_replays_count_and_trace_like_eager_steps(models, case):
    """Step by step, the launches, traces and logits of the captured engine
    equal the eager engine's: the first step captures, the rest replay."""
    prompts = _rounds(models[0].vocab_size)[1]
    rows = {}
    for graphs in (False, True):
        eng = _engine(models, case, graphs=graphs)
        for p in prompts:
            eng.submit(Request(prompt_tokens=p, max_new_tokens=8))
        rows[graphs] = []
        for _ in range(6):
            before = {name: f.launches for name, f in COUNTED.items()}
            eng.step()
            torch.cuda.synchronize()
            rows[graphs].append(({name: f.launches - before[name] for name, f in COUNTED.items()},
                                 list(dispatch.KERNEL_TRACE), list(attention.ATTENTION_TRACE),
                                 eng.last_logits.clone()))
        assert eng.stats()["graph_replays"] == (5 if graphs else 0)
    for (c0, k0, a0, l0), (c1, k1, a1, l1) in zip(rows[False], rows[True]):
        assert c0 == c1 and k0 == k1 and a0 == a1
        assert torch.equal(l0, l1)
    steps = rows[True][1:]
    kernel = "decode_stacked" if case == "scan" else "decode"
    assert all(c[kernel] == 7 * 2 for c, _, _, _ in steps)
    assert all(c["paged_decode"] == (2 if case == "paged" else 0) for c, _, _, _ in steps)


@pytest.mark.parametrize("case", ["dense", "scan", "paged"])
def test_replay_has_no_host_sync_and_leaves_scratch_zero(models, case):
    eng = _engine(models, case)
    for p in _rounds(models[0].vocab_size)[1]:
        eng.submit(Request(prompt_tokens=p, max_new_tokens=16))
    eng.step()                                     # admissions, then the capture
    (t_active, graph), = eng._graphs.items()
    ints = [t for t in graph.scratch if t.dtype == torch.int32]
    assert ints                                    # the K splits' arrival counters
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(4):
            eng._decode(t_active)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert eng.stats()["graph_replays"] == 4
    assert all(int(t.abs().sum()) == 0 for t in ints)


def test_a_capture_that_fails_raises(models, monkeypatch):
    """A host read inside the step cannot be captured: the engine raises and
    keeps no graph; it runs nothing eagerly in the graph's place."""
    sample = serving.sample_tokens

    def reading(logits, temps, generator):
        float(logits.float().sum())                # a host sync
        return sample(logits, temps, generator)

    eng = _engine(models, "dense")
    monkeypatch.setattr(serving, "sample_tokens", reading)
    eng.submit(Request(prompt_tokens=[1, 2, 3], max_new_tokens=4))
    with pytest.raises(RuntimeError):
        eng.step()
    assert not eng._graphs and eng.stats()["graph_replays"] == 0
    monkeypatch.undo()
    torch.cuda.synchronize()                       # the card still runs work
    other = _engine(models, "dense")
    assert len(other.generate([[4, 5, 6]], max_new_tokens=3)[0]) == 3


@pytest.mark.parametrize("case", ["dense", "paged"])
def test_captured_burst_equals_eager_burst(models, case):
    """Speculative decoding with a 1-layer draft of the same widths: the
    captured bursts give the eager bursts' tokens (greedy, and sampled from
    one seed), each burst one graph per live-KV bucket from the shared pool."""
    cfg, params = models
    dcfg = LlamaConfig.tiny(**{**CFG, "num_layers": 1})
    draft = (quantize_llama(init_llama(dcfg, seed=1, device="cuda"), group_size=64,
                            device="cuda"), dcfg)
    rounds = _rounds(cfg.vocab_size)[:2]
    runs = {}
    for graphs in (False, True):
        for temp in (0.0, 0.8):
            eng = _engine(models, case, graphs=graphs, draft=draft, spec_tokens=4, seed=3)
            runs[graphs, temp] = (eng, [eng.generate(p, max_new_tokens=12, temperature=temp)
                                        for p in rounds])
    for temp in (0.0, 0.8):
        assert runs[True, temp][1] == runs[False, temp][1]
    captured = runs[True, 0.0][0]
    st = captured.stats()
    assert st["spec_steps"] > 0 and st["graph_captures"] >= 1
    assert st["graph_replays"] == st["spec_steps"] + st["decode_steps"] - st["graph_captures"]
    assert any(k[0] == "spec" for k in captured._graphs if isinstance(k, tuple))


def test_burst_replay_has_no_host_sync_and_one_download(models, monkeypatch):
    cfg, params = models
    eng = _engine(models, "paged", draft=(params[False], cfg), spec_tokens=4)
    for p in _rounds(cfg.vocab_size)[0]:
        eng.submit(Request(prompt_tokens=p, max_new_tokens=40))
    eng.step()                                     # admissions, then the burst's capture
    (key, graph), = [(k, g) for k, g in eng._graphs.items() if isinstance(k, tuple)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            eng._spec(key[1])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    downloads = []
    tolist = torch.Tensor.tolist
    monkeypatch.setattr(torch.Tensor, "tolist", lambda t: downloads.append(t.shape) or tolist(t))
    before = eng.stats()["spec_steps"]
    eng.step()
    assert eng.stats()["spec_steps"] == before + 1
    assert downloads == [torch.Size([3 * (4 + 2)])]
