# SPDX-License-Identifier: Apache-2.0
"""The engine's captured prefill step on the card.

Card-only: each test skips where no CUDA device is present. On the card:

    python -m pytest --noconftest -m requires_cuda tests/test_torch_prefill_graphs.py -q

* The captured engine (the default on the card) serves the tokens of the
  eager engine (``graphs=False``), and each prefill's logits row equals the
  eager one bit for bit, on the dense cache, the paged cache (a slot's pages
  differ between a key's capture and its replays), chunked prompts (the
  power-of-two clamp near the cache end included), prefix hits, and a
  draft, and for A16W4, A8W8, A16W8, A8W8_FP8, A8W4, A16W4_MXFP and
  A4W4_NVFP layers at the buckets 32-2048 (the csm-4 quantizer, the per-token
  quantizers and row 5's int path under capture).
* Every key is captured once and every later prefill of it is a replay; the
  launch counts of the whole run equal the eager engine's.
* A prefill on a replayed key allocates nothing (the allocator's count of
  allocations is unchanged), and a replay makes no host sync.

The model: ``LlamaConfig.tiny`` widened to hidden 1024, intermediate 2048 and
head_dim 128 (test_torch_graphs.py's widths), 2 layers, max_seq_len 4096.
"""

import numpy as np
import pytest
import torch

from gemlite_tpu_torch import ContinuousBatchingEngine, LlamaConfig, init_llama, quantize_llama
from gemlite_tpu_torch import helper, mx
from gemlite_tpu_torch.graphs import COUNTED

pytestmark = pytest.mark.requires_cuda

CFG = dict(vocab_size=512, hidden_size=1024, intermediate_size=2048, num_layers=2, num_heads=8,
           num_kv_heads=2, head_dim=128, max_seq_len=4096)
BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)
LENGTHS = (20, 50, 100, 200, 300, 600, 1500)          # one prompt a bucket


@pytest.fixture(scope="module")
def dense():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = LlamaConfig.tiny(**CFG)
    return cfg, init_llama(cfg, seed=0, device="cuda")


@pytest.fixture(scope="module")
def w4(dense):
    cfg, d = dense
    return cfg, quantize_llama(d, group_size=64, device="cuda")


def _prompts(seed, lengths, vocab=CFG["vocab_size"]):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).tolist() for n in lengths]


def _serve(params, cfg, rounds, graphs, n_new=4, **kw):
    """The rounds of prompts through one engine; returns the engine, the
    tokens, each prefill's logits row with its key, the slot's table row
    (paged) and the allocations it made, and the launch counts. On the
    paged cache the free list is turned around between rounds, so that a
    round's slots take other pages than the round before."""
    kw = {"max_batch": 4, "prefill_buckets": BUCKETS, "paged": False, **kw}
    eng = ContinuousBatchingEngine(params, cfg, device="cuda", graphs=graphs, **kw)
    pieces = []
    prefill = eng._prefill

    def recording(tokens, slot, offset, true_len, chunk):
        key = ("chunk" if chunk else "prefill", tokens.shape[1])
        replay = key in eng._prefill_graphs
        before = torch.cuda.memory_stats().get("allocation.all.allocated", 0)
        row = eng.page_table[slot].copy() if eng.paged else None
        logits = prefill(tokens, slot, offset, true_len, chunk)
        allocs = torch.cuda.memory_stats().get("allocation.all.allocated", 0) - before
        pieces.append((key, logits.clone(), row, replay, allocs))
        return logits

    eng._prefill = recording
    before = {name: f.launches for name, f in COUNTED.items()}
    tokens = []
    for prompts in rounds:
        tokens.append(eng.generate(prompts, max_new_tokens=n_new))
        if eng.paged:
            eng.free_pages.reverse()
    torch.cuda.synchronize()
    launches = {name: f.launches - before[name] for name, f in COUNTED.items()}
    return eng, tokens, pieces, launches


def _check_pair(params, cfg, rounds, **kw):
    """Captured against eager: tokens, logits rows bit for bit, launches, one
    capture a key, replays for every later piece of a key, no allocation
    in a replayed prefill, no host sync in a replay. Returns the captured
    run's pieces."""
    eager, want, wpieces, wl = _serve(params, cfg, rounds, False, **kw)
    eng, got, pieces, launches = _serve(params, cfg, rounds, True, **kw)
    assert got == want
    assert [k for k, *_ in pieces] == [k for k, *_ in wpieces]
    for (_, a, *_), (_, b, *_) in zip(pieces, wpieces):
        assert torch.equal(a, b)
    assert launches == wl
    st, keys = eng.stats(), {k for k, *_ in pieces}
    assert st["prefill_captures"] == len(eng._prefill_graphs) == len(keys)
    assert st["prefill_replays"] == len(pieces) - len(keys) > 0
    assert st["prefill_replays"] == st["prefills"] + st["prefill_chunks"] - len(keys)
    assert st["graph_replays"] == st["decode_steps"] + st["spec_steps"] - st["graph_captures"]
    assert eager.stats()["prefill_captures"] == 0
    assert all(allocs == 0 for _, _, _, replay, allocs in pieces if replay)
    ints = eng._pf_static["ints"]
    for graph in eng._prefill_graphs.values():
        ints.zero_()
        ints[1] = 1                        # slot 0, true length 1, offset 0
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            graph.replay()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    return pieces


ENGINES = {
    "dense": dict(),
    "paged": dict(paged=True, page_size=64, prefix_cache=False),
    "chunked": dict(prefill_chunk=384),
    "prefix": dict(paged=True, page_size=64, prefill_chunk=256),
    "draft": dict(spec_tokens=4),
}


@pytest.mark.parametrize("case", list(ENGINES))
def test_captured_prefill_equals_eager_prefill(w4, case):
    cfg, params = w4
    kw = dict(ENGINES[case])
    if case == "chunked":
        # 3840 rows in chunks of 384, then 160 with 256 rows left: the clamp
        rounds = [_prompts(1, (20, 700, 4000)), _prompts(2, (900, 30, 3999))]
    elif case == "prefix":
        base = _prompts(3, (700,))[0]
        rounds = [[base, _prompts(4, (40,))[0]],
                  [base[:640] + t for t in _prompts(5, (30, 200))] + [base]]
    else:
        rounds = [_prompts(6, LENGTHS[:4]), _prompts(7, LENGTHS[3:]), _prompts(8, LENGTHS[:4])]
    if case == "draft":
        dcfg = LlamaConfig.tiny(**{**CFG, "num_layers": 1})
        kw["draft"] = (quantize_llama(init_llama(dcfg, seed=1, device="cuda"), group_size=64,
                                      device="cuda"), dcfg)
    pieces = _check_pair(params, cfg, rounds, **kw)
    keys = [k for k, *_ in pieces]
    if case == "paged":
        # a key's replays write through other pages than its capture did
        rows = {}
        for key, _, row, _, _ in pieces:
            rows.setdefault(key, []).append(tuple(row))
        assert any(len(set(r)) > 1 for r in rows.values())
    if case == "chunked":
        assert ("chunk", 384) in keys and ("chunk", 256) in keys
    if case == "prefix":
        assert any(k[0] == "chunk" for k in keys)


PROCESSORS = {
    "a8w8": lambda: dict(processor=helper.A8W8_INT8_dynamic(device="cuda", dtype=torch.bfloat16)),
    "a16w8": lambda: dict(processor=helper.A16W8_INT8(device="cuda", dtype=torch.bfloat16)),
    "a8w8_fp8": lambda: dict(processor=helper.A8W8_FP8_dynamic(device="cuda",
                                                               dtype=torch.bfloat16)),
    "a8w4": lambda: dict(processor=helper.A8W4_HQQ_INT_dynamic(device="cuda",
                                                               dtype=torch.bfloat16),
                         group_size=64),
    "a16w4_mxfp": lambda: dict(processor=mx.A16W4_MXFP(device="cuda")),
    "a4w4_nvfp": lambda: dict(processor=mx.A4W4_NVFP_dynamic(device="cuda")),
}


@pytest.mark.parametrize("form", list(PROCESSORS))
def test_captured_prefill_of_every_layer_form(dense, form):
    """A16W4 is the engine cases' model; the other forms at every bucket."""
    cfg, d = dense
    params = quantize_llama(d, **PROCESSORS[form]())
    rounds = [_prompts(9, LENGTHS[:4]), _prompts(10, LENGTHS[3:]), _prompts(11, LENGTHS)]
    _check_pair(params, cfg, rounds, max_batch=7)
