# SPDX-License-Identifier: Apache-2.0
"""The flash kernel's arithmetic and launch plan, on the CPU.

* ``flash_attention_emulated`` (the kernel's tile-wise online softmax in
  float32, P rounded as the kernel rounds it) against the JAX package's
  causal ``_attention`` (``gemlite_tpu/models/llama.py``), on bf16 inputs made
  from a seed with numpy: random q/k/v, near-uniform softmax (q and k scaled
  to 1e-2), and the first layer of a tiny ``LlamaConfig`` with random
  weights. Tolerance: mean|a-b| / mean|b| <= 5e-3, the stage gate of the
  serve checks; the rounding the kernel keeps (P split into bf16 high and
  low parts) stays within half of it. The output's own rounding to bf16
  accounts for about 1.4e-3 of each case; P rounded once to bf16 (l summed
  over the rounded values) adds about 0.6e-3 here, which the serve check's
  cached-prefix stage on the card amplified past its gate.
* ``flash_plan``: the ring fits a block's shared memory, every (tile, head,
  batch) is launched once with the heaviest tiles first, and a ragged
  S % 128 == 64 leaves a half tile.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemlite_tpu.models import llama as jllama
from gemlite_tpu_torch.ops import attention

REL_TOL = 5e-3
KEPT = "hi_lo"           # the rounding of P in csrc/flash_attention.cu


def _mean_rel(got, want):
    return float(np.abs(got - want).mean() / np.abs(want).mean())


def _reference(q, k, v):
    """JAX ``_attention`` with the causal mask on the float32 values of the
    bf16 inputs."""
    B, S = q.shape[:2]
    t = np.arange(S)
    mask = np.broadcast_to(t[None, :] <= t[:, None], (B, S, S))
    return np.asarray(jllama._attention(*(jnp.asarray(x.float().numpy()) for x in (q, k, v)),
                                        jnp.asarray(mask)))


def _random_qkv(seed, B, S, Hq, Hkv, D, qk_scale=1.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, S, h, D)).astype(np.float32) for h in (Hq, Hkv, Hkv))
    return [torch.from_numpy(x).to(torch.bfloat16) for x in (q * qk_scale, k * qk_scale, v)]


def _first_layer_qkv(D, S):
    """q, k, v of layer 0 of a tiny Llama (random weights, std 0.02) on
    random tokens: the near-uniform softmax of a model's first layer."""
    cfg = jllama.LlamaConfig.tiny(head_dim=D, max_seq_len=S)
    params = jllama.init_llama(cfg, seed=0)
    blk = params["blocks"][0]
    tokens = jnp.asarray(np.random.default_rng(1).integers(0, cfg.vocab_size, size=(2, S)))
    h = jllama._rms_norm(params["embed"][tokens], blk["ln_attn"], cfg.norm_eps)
    pos = jnp.broadcast_to(jnp.arange(S)[None], (2, S))

    def proj(w, heads):
        return (h @ w.T).reshape(2, S, heads, D)

    q = jllama._rope(proj(blk["attn"]["wq"], cfg.num_heads), pos, cfg.rope_theta)
    k = jllama._rope(proj(blk["attn"]["wk"], cfg.num_kv_heads), pos, cfg.rope_theta)
    v = proj(blk["attn"]["wv"], cfg.num_kv_heads)
    return [torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
            for x in (q, k, v)]


def _check(q, k, v, p_round):
    got = attention.flash_attention_emulated(q, k, v, p_round=p_round)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    err = _mean_rel(got.float().numpy(), _reference(q, k, v))
    assert err <= REL_TOL
    if p_round == KEPT:
        assert err <= REL_TOL / 2, f"the kept rounding leaves no margin: {err:.2e}"
    return err


@pytest.mark.parametrize("p_round", attention.P_ROUNDINGS)
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [256, 384])
def test_emulated_matches_jax_random(S, D, p_round):
    _check(*_random_qkv(S + D, 2, S, 4, 2, D), p_round)


@pytest.mark.parametrize("p_round", attention.P_ROUNDINGS)
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [256, 384])
def test_emulated_matches_jax_near_uniform(S, D, p_round):
    _check(*_random_qkv(S + D + 1, 2, S, 4, 2, D, qk_scale=1e-2), p_round)


@pytest.mark.parametrize("p_round", attention.P_ROUNDINGS)
@pytest.mark.parametrize("D", [64, 128])
def test_emulated_matches_jax_first_layer(D, p_round):
    _check(*_first_layer_qkv(D, 384), p_round)


def test_emulated_rounding_is_the_kernels():
    """bf16 rounds P once (l over the rounded P), hi_lo keeps about 16 bits
    of P: on random inputs the split comes out closer; any other rounding
    is refused."""
    q, k, v = _random_qkv(7, 1, 256, 4, 2, 64)
    want = _reference(q, k, v)
    errs = {r: _mean_rel(attention.flash_attention_emulated(q, k, v, p_round=r).float().numpy(),
                         want) for r in attention.P_ROUNDINGS}
    assert errs["hi_lo"] < errs["bf16"]
    with pytest.raises(ValueError):
        attention.flash_attention_emulated(q, k, v, p_round="fp8")


@pytest.mark.parametrize("D", [64, 128])
def test_plan_fits_shared_memory(D):
    plan = attention.flash_plan(1, 8192, 32, D)
    assert plan.smem_bytes <= attention.SMEM_LIMIT <= 227 * 1024
    assert plan.smem_bytes >= (1 + 2 * attention.FLASH_STAGES) * attention.FLASH_TILE * D * 2
    assert plan.threads == 384


@pytest.mark.parametrize("B,S,Hq", [(1, 64, 8), (1, 256, 4), (2, 384, 2), (3, 1024, 5),
                                    (1, 8192, 32)])
def test_plan_covers_every_block_once_heaviest_first(B, S, Hq):
    plan = attention.flash_plan(B, S, Hq, 128)
    tiles = -(-S // 128)
    order = plan.order()
    assert plan.grid == (Hq, B, tiles)
    assert len(order) == len(set(order)) == B * Hq * tiles
    assert set(order) == {(t, h, b) for t in range(tiles) for h in range(Hq) for b in range(B)}
    work = [t + 1 for t, _, _ in order]                 # key tiles a block sums
    assert work == sorted(work, reverse=True)


@pytest.mark.parametrize("S,rows", [(64, (64,)), (128, (128,)), (192, (128, 64)),
                                    (320, (128, 128, 64)), (384, (128, 128, 128))])
def test_plan_half_tile(S, rows):
    assert attention.flash_plan(1, S, 4, 64).tile_rows == rows


@pytest.mark.parametrize("B,S,Hq,D", [(1, 100, 4, 64), (1, 0, 4, 128), (1, 256, 4, 256),
                                      (1, 256, 4, 32)])
def test_plan_refuses(B, S, Hq, D):
    with pytest.raises((ValueError, NotImplementedError)):
        attention.flash_plan(B, S, Hq, D)


def test_tile_entries_plain_on_cpu():
    """The product test entries on CPU tensors are the plain products."""
    rng = np.random.default_rng(3)
    q, k = (torch.from_numpy(rng.normal(size=(128, 64)).astype(np.float32)).to(torch.bfloat16)
            for _ in range(2))
    p = torch.from_numpy(rng.random((128, 128)).astype(np.float32))
    assert torch.equal(attention.flash_qk_tile(q, k), q.float() @ k.float().T)
    got = attention.flash_pv_tile(p, k)
    assert float((got - p @ k.float()).abs().max() / (p @ k.float()).abs().max()) <= 1e-4

