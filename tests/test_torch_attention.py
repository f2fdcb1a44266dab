# SPDX-License-Identifier: Apache-2.0
"""The port's attention paths against the JAX package's (CPU).

* the plain version of the flash kernel (the causal masked attention) equals
  the JAX package's causal ``_attention``, what JAX runs off the TPU, within
  max|a-b| <= 1e-5 on float32 inputs (the two sum in float32 in different
  orders);
* the flash gate is the JAX gate without its backend test;
* each attention path of the model notes its route in ``ATTENTION_TRACE``:
  only a one-shot prefill at the static offset 0 takes flash (a prompt chunk
  at a runtime offset 0 does not, as in the JAX engine), and only a paged
  decode step takes the paged decode kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemlite_tpu.models import llama as jllama
from gemlite_tpu_torch.models import llama as tllama
from gemlite_tpu_torch.models.paged_kv import init_paged_kv
from gemlite_tpu_torch.ops import attention

ATOL = 1e-5


def _qkv(seed, B, S, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, h, D)).astype(np.float32) for h in (Hq, Hkv, Hkv)]


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [256, 384])
def test_causal_plain_matches_jax_attention(S, D):
    q, k, v = _qkv(S + D, 2, S, 4, 2, D)
    t = np.arange(S)
    mask = np.broadcast_to(t[None, :] <= t[:, None], (2, S, S))
    want = np.asarray(jllama._attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        jnp.asarray(mask)))
    got = attention.flash_attention_causal(*(torch.from_numpy(a) for a in (q, k, v)))
    assert got.dtype == torch.float32 and got.shape == (2, S, 4, D)
    assert float(np.abs(got.numpy() - want).max()) <= ATOL


@pytest.mark.parametrize("S,D,want", [(256, 128, True), (384, 64, True), (2048, 256, True),
                                      (128, 128, False), (320, 128, False), (256, 32, False),
                                      (1, 128, False)])
def test_flash_gate(S, D, want):
    """S >= 256, S % 128 == 0, D in (64, 128, 256): JAX llama.py:_can_use_flash
    without ``jax.default_backend() == "tpu"``."""
    assert tllama._can_use_flash(torch.zeros((1, S, 2, D))) is want


def test_plain_versions_note_their_routes():
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, 1, 256, 4, 2, 64))
    pages = torch.zeros((2, 3, 16, 64))
    attention.ATTENTION_TRACE.clear()
    attention.flash_attention_causal(q, k, v)
    attention.paged_decode_attention_kernel(q[:, 0], pages, pages,
                                            torch.tensor([1], dtype=torch.int32),
                                            torch.tensor([[1, 2]], dtype=torch.int32))
    assert attention.ATTENTION_TRACE == ["plain_flash", "plain_paged_decode"]


@pytest.fixture(scope="module")
def tiny_model():
    cfg = tllama.LlamaConfig.tiny(num_layers=2, max_seq_len=512)
    params = tllama.quantize_llama(tllama.init_llama(cfg, seed=0, device="cpu"),
                                   group_size=64, device="cpu")
    return params, cfg


def _route(params, cfg, case):
    """Run one model call of the named kind; return its attention notes."""
    tok = lambda S, B=1: torch.arange(B * S).reshape(B, S) % cfg.vocab_size  # noqa: E731
    kv_dense = tllama.init_kv_cache(cfg, 1, device="cpu")
    kv_paged = init_paged_kv(cfg, 2, page_size=16, device="cpu")
    attention.ATTENTION_TRACE.clear()
    if case == "no_cache_256":
        tllama.llama_forward(params, cfg, tok(256))
    elif case == "no_cache_128":
        tllama.llama_forward(params, cfg, tok(128))
    elif case == "dense_prefill_256":
        tllama.llama_forward(params, cfg, tok(256), kv=kv_dense, cache_len=0)
    elif case == "dense_chunk_256_at_runtime_0":
        tllama.llama_forward(params, cfg, tok(256), kv=kv_dense, cache_len=torch.tensor(0))
    elif case == "dense_decode":
        tllama.llama_decode_step_batched(params, cfg, tok(1), kv_dense,
                                         torch.tensor([5], dtype=torch.int32), t_active=256)
    elif case == "paged_prefill_256":
        tllama.llama_forward(params, cfg, tok(256), kv=kv_paged.with_table(kv_paged.table[:1]),
                             cache_len=0)
    elif case == "paged_prefill_128":
        tllama.llama_forward(params, cfg, tok(128), kv=kv_paged.with_table(kv_paged.table[:1]),
                             cache_len=0)
    elif case == "paged_chunk_256_at_runtime_0":
        tllama.llama_forward(params, cfg, tok(256), kv=kv_paged.with_table(kv_paged.table[:1]),
                             cache_len=torch.tensor(0))
    elif case == "paged_decode":
        tllama.llama_decode_step_batched(params, cfg, tok(1, 2), kv_paged,
                                         torch.tensor([5, 9], dtype=torch.int32))
    elif case == "paged_verify":
        tllama.llama_verify_step(params, cfg, tok(3, 2), kv_paged,
                                 torch.tensor([5, 9], dtype=torch.int32))
    return sorted(set(attention.ATTENTION_TRACE)), len(attention.ATTENTION_TRACE)


@pytest.mark.parametrize("case,route", [
    ("no_cache_256", "plain_flash"), ("no_cache_128", "xla"),
    ("dense_prefill_256", "plain_flash"), ("dense_chunk_256_at_runtime_0", "xla"),
    ("dense_decode", "xla"), ("paged_prefill_256", "plain_flash"),
    ("paged_prefill_128", "xla"), ("paged_chunk_256_at_runtime_0", "xla"),
    ("paged_decode", "plain_paged_decode"), ("paged_verify", "xla")])
def test_model_attention_routes(tiny_model, case, route):
    params, cfg = tiny_model
    assert _route(params, cfg, case) == ([route], cfg.num_layers)
