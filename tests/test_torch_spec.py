# SPDX-License-Identifier: Apache-2.0
"""Speculative decoding (``draft=``) in the port's engine against the JAX
package's, on the CPU, at tests/test_serving.py's ``_mk_model`` sizes: a
target of 2 layers at hidden 128 and a draft of 1 layer at hidden 64, W4 gs
32, vocab 128, max_seq_len 64.

* Greedy spec tokens equal the JAX spec engine's and the port's plain
  engine's, on the dense and the paged caches (JAX's spec engine runs twice,
  in a module fixture), and with chunked prefill.
* A self-draft (draft = target) keeps every draft: 9 tokens in 2 engine
  steps, greedy and at temperature 0.8; the draft cache has no hole after a
  full acceptance; sampled runs repeat per seed.
* ``spec_dist`` equals JAX's ``_spec_dist`` within 1e-6; ``spec_accept``
  equals a numpy copy of JAX's acceptance and fix-token arithmetic
  (``gemlite_tpu/serving.py:515-535``) on the same p, q, drafts and uniforms;
  20,000 seeded first tokens over a vocabulary of 8 follow p within 0.015.
* A finished slot whose stale offset lies within g + 1 rows of the cache end
  beside a running slot: no index error, the plain engine's tokens.
* The guard rails: ``scan_layers`` with a draft, a draft cache shorter than
  the target's, and ``mesh=`` raise; prefix caching is off with a draft.
* The burst reads nothing on the host and the engine downloads one tensor a
  burst.

Sampled tokens are not compared with JAX: the port draws from a
``torch.Generator`` and does not reproduce JAX's PRNG stream.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemlite_tpu.models import llama as jllama
from gemlite_tpu.serving import ContinuousBatchingEngine as JEngine
from gemlite_tpu_torch import ContinuousBatchingEngine, Request, params_from_jax_numpy
from gemlite_tpu_torch.models import llama as tllama
from gemlite_tpu_torch.serving import spec_accept, spec_dist
from test_torch_graph_step import no_host_reads
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

G = 3
MAX_NEW = 12


def _mk_model(seed=0, layers=2, heads=4, hidden=128):
    """tests/test_serving.py's ``_mk_model``, in both packages."""
    kw = dict(vocab_size=128, hidden_size=hidden, intermediate_size=2 * hidden,
              num_layers=layers, num_heads=heads, num_kv_heads=heads // 2,
              head_dim=hidden // heads, max_seq_len=64)
    jcfg = jllama.LlamaConfig.tiny(**kw)
    jq = jllama.quantize_llama(jllama.init_llama(jcfg, seed=seed), W_nbits=4, group_size=32)
    params = params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jq), device="cpu")
    return params, tllama.LlamaConfig.tiny(**kw), jq, jcfg


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 128, size=n).tolist() for n in (5, 9, 3)]


@pytest.fixture(scope="module")
def models():
    """(target, draft) in both packages, and JAX's greedy spec tokens on its
    dense and paged engines."""
    target, draft = _mk_model(seed=0), _mk_model(seed=1, layers=1, heads=2, hidden=64)
    jax_tokens = {}
    for paged in (False, True):
        eng = JEngine(target[2], target[3], max_batch=4, draft=(draft[2], draft[3]),
                      spec_tokens=G, paged=paged)
        jax_tokens[paged] = eng.generate(_prompts(), max_new_tokens=MAX_NEW)
    return target, draft, jax_tokens


def _spec(target, draft, **kw):
    kw = {"max_batch": 4, "spec_tokens": G, **kw}
    return ContinuousBatchingEngine(target[0], target[1], draft=(draft[0], draft[1]),
                                    device="cpu", **kw)


def _plain(target, **kw):
    return ContinuousBatchingEngine(target[0], target[1], **{"max_batch": 4, **kw},
                                    device="cpu")


@pytest.mark.parametrize("paged", [False, True])
def test_greedy_spec_equals_jax_and_plain_engine(models, paged):
    target, draft, jax_tokens = models
    eng = _spec(target, draft, paged=paged)
    got = eng.generate(_prompts(), max_new_tokens=MAX_NEW)
    assert got == jax_tokens[paged]
    assert got == _plain(target, paged=paged).generate(_prompts(), max_new_tokens=MAX_NEW)
    stats = eng.stats()
    assert stats["spec_steps"] >= 1 and stats["tokens_out"] == 3 * MAX_NEW


@pytest.mark.parametrize("paged", [False, True])
def test_chunked_prefill_with_a_draft(models, paged):
    """Prompts prefilled in chunks of 8 into both caches, the draft's at the
    same runtime offsets: the plain engine's tokens."""
    target, draft, _ = models
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 128, size=n).tolist() for n in (21, 6, 30)]
    kw = dict(paged=paged, prefill_chunk=8, prefill_buckets=(8, 16, 32))
    eng = _spec(target, draft, **kw)
    got = eng.generate(prompts, max_new_tokens=10)
    assert got == _plain(target, **kw).generate(prompts, max_new_tokens=10)
    assert eng.stats()["prefill_chunks"] >= 6 and eng.stats()["spec_steps"] >= 1


def _steps_to_finish(eng, req):
    eng.submit(req)
    steps = 0
    while eng.num_active or eng.queue:
        eng.step()
        steps += 1
    out, eng.finished = eng.finished, []
    return steps, out[0].output_tokens


@pytest.mark.parametrize("temperature,seed", [(0.0, 2), (0.8, 4)])
def test_self_draft_accepts_everything(temperature, seed):
    """Draft = target: every draft is kept, so 9 tokens take 2 engine steps
    (the prefill's token and a burst of 4, then a burst of 4)."""
    target = _mk_model(seed=seed)
    eng = ContinuousBatchingEngine(target[0], target[1], max_batch=2, draft=(target[0], target[1]),
                                   spec_tokens=3, seed=7, device="cpu")
    steps, out = _steps_to_finish(eng, Request(prompt_tokens=[5, 6, 7], max_new_tokens=9,
                                               temperature=temperature))
    assert steps == 2 and len(out) == 9
    assert all(0 <= t < 128 for t in out)
    if temperature == 0.0:
        assert [out] == _plain(target, max_batch=2).generate([[5, 6, 7]], max_new_tokens=9)


def test_draft_cache_has_no_hole_after_full_acceptance():
    target = _mk_model(seed=4)
    eng = ContinuousBatchingEngine(target[0], target[1], max_batch=1, draft=(target[0], target[1]),
                                   spec_tokens=G, device="cpu")
    eng.submit(Request(prompt_tokens=[1, 2, 3], max_new_tokens=4 + G))
    eng.step()                  # the prefill's token and one burst of g + 1
    rows = eng.draft_kv[0, 0, 0, 3:3 + G + 1].float()
    assert (rows.abs().sum(dim=(1, 2)) > 0).all()


def test_sampled_spec_repeats_per_seed(models):
    target, draft, _ = models

    def run(seed):
        eng = _spec(target, draft, max_batch=1, spec_tokens=2, seed=seed)
        return eng.generate([[3, 1, 4]], max_new_tokens=8, temperature=0.7)[0]

    a, b = run(0), run(0)
    assert a == b and len(a) == 8
    assert all(0 <= t < 128 for t in a + run(1))


def test_spec_dist_equals_jax():
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(6, 128)) * 3).astype(np.float32)
    temps = np.array([0.0, 0.7, 1.0, 0.0, 0.3, 2.0], np.float32)
    want = np.asarray(JEngine._spec_dist(jnp.asarray(logits), jnp.asarray(temps)))
    got = spec_dist(torch.from_numpy(logits), torch.from_numpy(temps)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _numpy_accept(p, q, drafts, u, noise, temps):
    """gemlite_tpu/serving.py:515-535 in numpy, the categorical draw as
    Gumbel-max with the given noise."""
    B, g = drafts.shape
    V = p.shape[-1]
    p_d = np.take_along_axis(p[:, :g], drafts[..., None], axis=2)[..., 0]
    q_d = np.take_along_axis(q, drafts[..., None], axis=2)[..., 0]
    acc = (u * q_d < p_d).astype(np.int32)
    n_acc = np.sum(np.cumprod(acc, axis=1), axis=1)
    qz = np.concatenate([q, np.zeros((B, 1, V), np.float32)], 1)
    p_at = np.take_along_axis(p, n_acc[:, None, None], axis=1)[:, 0]
    q_at = np.take_along_axis(qz, n_acc[:, None, None], axis=1)[:, 0]
    res = np.clip(p_at - q_at, 0.0, None) + np.float32(1e-30)
    fix_sampled = np.argmax(np.log(res) + noise, axis=-1)
    fix = np.where(temps > 0, fix_sampled, np.argmax(res, axis=-1))
    return n_acc.astype(np.int32), fix.astype(np.int32)


@pytest.mark.parametrize("greedy_share", [0.0, 0.5, 1.0])
def test_spec_accept_equals_jax_arithmetic(greedy_share):
    """Distributions from JAX's ``_spec_dist`` of random logits; drafts that
    are the draft's argmax in half the rows and random tokens in the rest."""
    rng = np.random.default_rng(int(greedy_share * 10))
    B, g, V = 64, 4, 32
    temps = np.where(rng.random(B) < greedy_share, 0.0, rng.uniform(0.3, 1.5, B)).astype(
        np.float32)
    plog = (rng.normal(size=(B, g + 1, V)) * 2).astype(np.float32)
    qlog = (plog[:, :g] + rng.normal(size=(B, g, V)) * 0.5).astype(np.float32)
    dist = lambda lg, t: np.asarray(JEngine._spec_dist(jnp.asarray(lg), jnp.asarray(t)))
    p = dist(plog.reshape(-1, V), np.repeat(temps, g + 1)).reshape(B, g + 1, V)
    q = dist(qlog.reshape(-1, V), np.repeat(temps, g)).reshape(B, g, V)
    drafts = np.where(rng.random((B, g)) < 0.5, q.argmax(-1),
                      rng.integers(0, V, (B, g))).astype(np.int32)
    u = rng.random((B, g)).astype(np.float32)
    noise = rng.gumbel(size=(B, V)).astype(np.float32)
    want = _numpy_accept(p, q, drafts, u, noise, temps)
    got = spec_accept(*(torch.tensor(a) for a in (p, q, drafts, u, noise, temps)))
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert 0 < want[0].mean() < g


def test_first_token_follows_the_target_distribution():
    """Drafts drawn from q, kept or replaced by ``spec_accept``: the first
    emitted token of 20,000 seeded draws follows p within 0.015."""
    gen = torch.Generator().manual_seed(0)
    R, V = 20_000, 8
    p = torch.tensor([0.30, 0.05, 0.20, 0.0, 0.15, 0.10, 0.12, 0.08])
    q = torch.tensor([0.10, 0.25, 0.05, 0.20, 0.15, 0.05, 0.10, 0.10])
    drafts = torch.multinomial(q, R, replacement=True, generator=gen).to(torch.int32)[:, None]
    u = torch.rand((R, 1), generator=gen)
    noise = -torch.log(-torch.log(torch.rand((R, V), generator=gen)))
    n_acc, fix = spec_accept(p.expand(R, 2, V), q.expand(R, 1, V), drafts, u, noise,
                             torch.ones(R))
    first = torch.where(n_acc > 0, drafts[:, 0], fix)
    freq = torch.bincount(first.long(), minlength=V).float() / R
    assert float((freq - p).abs().max()) < 0.015
    assert 0 < float((n_acc > 0).float().mean()) < 1


@pytest.mark.parametrize("paged", [False, True])
def test_stale_slot_near_the_cache_end(models, paged):
    """A request that finishes at its prefill leaves its slot's offset at 60
    of 64 rows; the running slot's bursts write g + 1 rows at that stale
    offset too, past the cache: dropped into the stripe's last row or the
    trash page. No index error, and the running request gets the plain
    engine's tokens."""
    target, draft, _ = models
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 128, size=60).tolist(), rng.integers(0, 128, size=5).tolist()]
    reqs = [Request(prompt_tokens=prompts[0], max_new_tokens=1),
            Request(prompt_tokens=prompts[1], max_new_tokens=MAX_NEW)]
    eng = _spec(target, draft, max_batch=2, spec_tokens=4, paged=paged, page_size=16)
    for r in reqs:
        eng.submit(r)
    got = {r.request_id: r.output_tokens for r in eng.run()}
    assert eng.stats()["spec_steps"] >= 1
    want = _plain(target, max_batch=2, paged=paged, page_size=16).generate(
        prompts, max_new_tokens=MAX_NEW)
    assert got[reqs[1].request_id] == want[1]
    assert got[reqs[0].request_id] == want[0][:1]


def test_near_the_cache_end_plain_steps_keep_the_tokens(models):
    """A prompt of 50 of 64 rows: bursts while g + 1 rows fit, then plain
    decode steps to the cap, as in the JAX engine; the plain engine's tokens."""
    target, draft, _ = models
    prompt = np.random.default_rng(6).integers(0, 128, size=50).tolist()
    eng = _spec(target, draft, max_batch=1, spec_tokens=4, paged=False)
    got = eng.generate([prompt], max_new_tokens=20)
    stats = eng.stats()
    assert stats["spec_steps"] >= 1 and stats["decode_steps"] >= 1
    assert got == _plain(target, max_batch=1, paged=False).generate([prompt], max_new_tokens=20)


def test_guard_rails(models):
    target, draft, _ = models
    with pytest.raises(ValueError, match="scan_layers"):
        _spec(target, draft, paged=False, scan_layers=True)
    short = dataclasses.replace(draft[1], max_seq_len=32)
    with pytest.raises(ValueError, match="max_seq_len"):
        ContinuousBatchingEngine(target[0], target[1], draft=(draft[0], short), device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        _spec(target, draft, mesh=object())
    eng = _spec(target, draft, paged=True)
    assert not eng.use_prefix and eng.spec_tokens == G
    assert tuple(eng.draft_kv.shape) == (1, 2, 4, 64, 1, 32)     # dense, even on a paged target
    assert eng.stats()["spec_steps"] == 0
    assert _plain(target).spec_tokens == 0


def test_burst_reads_nothing_on_the_host_and_downloads_once(models, monkeypatch):
    target, draft, _ = models
    eng = _spec(target, draft, paged=True)
    step = eng._spec_step

    def guarded(t_active):
        with no_host_reads():
            return step(t_active)

    eng._spec_step = guarded
    downloads = []
    tolist = torch.Tensor.tolist
    monkeypatch.setattr(torch.Tensor, "tolist", lambda t: downloads.append(t.shape) or tolist(t))
    for p in _prompts():
        eng.submit(Request(prompt_tokens=p, max_new_tokens=MAX_NEW))
    eng.step()                                  # admissions (their first tokens) and a burst
    downloads.clear()
    while eng.num_active:
        before = eng.stats()["spec_steps"]
        eng.step()
        if eng.stats()["spec_steps"] > before:
            assert downloads == [torch.Size([4 * (G + 2)])]
        downloads.clear()
    assert eng.stats()["spec_steps"] >= 2
