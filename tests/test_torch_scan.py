# SPDX-License-Identifier: Apache-2.0
"""The port's scan-over-layers decode against gemlite_tpu's, on the CPU.

* The stacked kernel's plain version against JAX
  ``pallas_decode_matmul_stacked`` (interpret mode) at W4, W2 and W1, every
  layer, within the decode-route bound of tests/test_torch_layer.py
  (mean|a-b| / mean|b| < 5e-3), and equal bit for bit to the per-layer decode
  route's plain version, the index given as an int or a 0-d int32 tensor.
* ``llama_decode_step_scan`` against the JAX scan step (logits and KV) within
  the port's llama parity bound (rtol/atol 2e-2), and equal bit for bit to the
  port's own ``llama_decode_step_batched``.
* The scan engine's greedy tokens equal the unrolled engine's and the JAX scan
  engine's; its guard rails; its routes.
* Fused ``wqkv`` / ``gate_up`` layers (``quantize_llama(fuse=True)``) of a JAX
  model carried across stack to the bytes of JAX's ``stack_blocks``; the
  fused scan step matches JAX's within the same bound and equals the port's
  unrolled step bit for bit; the fused scan engine serves the fused unrolled
  engine's and the JAX scan engine's tokens.

The JAX gate admits scaled-activation metas (A8W8) and then fails at trace
time; the port refuses them at construction, and no test matches JAX there.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from gemlite_tpu import DType as JDType, GemLiteLinear as JLinear
from gemlite_tpu.helper import A16Wn_HQQ_INT as JHQQ
from gemlite_tpu.models import llama as jllama
from gemlite_tpu.models import scan_llama as jscan
from gemlite_tpu.ops.pallas_decode import select_decode_config
from gemlite_tpu.ops.pallas_scan import can_use_stacked_decode as j_can_use_stacked
from gemlite_tpu.ops.pallas_scan import pallas_decode_matmul_stacked
from gemlite_tpu.serving import ContinuousBatchingEngine as JEngine
from gemlite_tpu_torch import (A8W8_INT8_dynamic, ContinuousBatchingEngine, DType, GemLiteLinear,
                               params_from_jax_numpy)
from gemlite_tpu_torch.core import tensor_from_numpy
from gemlite_tpu_torch.helper import A8Wn_HQQ_INT_dynamic, A16W158_INT, A16Wn_HQQ_INT
from gemlite_tpu_torch.models import llama as tllama
from gemlite_tpu_torch.models import scan_llama as tscan
from gemlite_tpu_torch.ops import dispatch
from gemlite_tpu_torch.ops.decode import decode_matmul
from gemlite_tpu_torch.ops.scan import can_use_stacked_decode, decode_matmul_stacked

REL = 5e-3          # tests/test_torch_layer.py's bound for the decode route
TOL = 2e-2          # tests/test_torch_llama.py's bound for bf16 logits
L, N, K, GS, M = 3, 256, 256, 128, 8
TINY = dict(hidden_size=256, intermediate_size=512, num_layers=2, num_heads=4, num_kv_heads=2,
            head_dim=64, max_seq_len=64, vocab_size=128)


def _stacks(W_nbits, seed=0):
    """L layers from the same numpy codes and bf16 metadata, packed by both
    packages: (JAX stacks, port stacks, JAX meta, port meta)."""
    rng = np.random.default_rng(seed)
    jl, tl = [], []
    for _ in range(L):
        W_q = rng.integers(0, 2 ** W_nbits, size=(N, K)).astype(np.uint8)
        scales = (rng.uniform(0.5, 1.5, size=(N * K // GS, 1)) * 2.0 ** -6).astype(
            ml_dtypes.bfloat16)
        zeros = rng.integers(0, 2 ** W_nbits, size=(N * K // GS, 1)).astype(ml_dtypes.bfloat16)
        jl.append(JLinear(W_nbits, GS, K, N, JDType.BF16, JDType.BF16).pack(W_q, scales, zeros))
        tl.append(GemLiteLinear(W_nbits, GS, K, N, DType.BF16, DType.BF16, device="cpu").pack(
            W_q, tensor_from_numpy(scales), tensor_from_numpy(zeros)))
    jst = tuple(jnp.stack([getattr(l, a) for l in jl]) for a in ("W_q", "scales", "zeros"))
    tst = tuple(torch.stack([getattr(l, a) for l in tl]) for a in ("W_q", "scales", "zeros"))
    return jst, tst, jl[0].meta, tl[0].meta, tl


def _x(seed=1):
    return (np.random.default_rng(seed).normal(size=(M, K)) * 0.1).astype(np.float32)


def _rel(got, want):
    return float(np.mean(np.abs(got - want)) / (np.mean(np.abs(want)) + 1e-6))


@pytest.mark.parametrize("layer", range(L))
@pytest.mark.parametrize("W_nbits", [4, 2, 1])
def test_stacked_plain_matches_jax_stacked_kernel(W_nbits, layer):
    jst, tst, jmeta, tmeta, _ = _stacks(W_nbits)
    cfg = select_decode_config(jmeta, M, N, K)
    assert j_can_use_stacked(jmeta, M, N, K, cfg) and can_use_stacked_decode(tmeta, M)
    x = _x()
    want = pallas_decode_matmul_stacked(jnp.asarray(x, jnp.bfloat16), *jst, None, jmeta,
                                        jnp.int32(layer), cfg, interpret=True)
    got = decode_matmul_stacked(torch.from_numpy(x).to(torch.bfloat16), *tst, tmeta,
                                torch.tensor(layer, dtype=torch.int32))
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert _rel(got.float().numpy(), np.asarray(want.astype(jnp.float32))) < REL


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("W_nbits", [4, 2, 1])
def test_stacked_plain_equals_per_layer_decode(W_nbits, as_tensor):
    _, tst, _, tmeta, layers = _stacks(W_nbits, seed=2)
    x = torch.from_numpy(_x(3)).to(torch.bfloat16)
    for l, layer in enumerate(layers):
        idx = torch.tensor(l, dtype=torch.int32) if as_tensor else l
        got = decode_matmul_stacked(x, *tst, tmeta, idx)
        want = decode_matmul(x, layer.W_q, layer.scales, layer.zeros, layer.meta)
        assert torch.equal(got, want), l


def _jax_model(W_nbits=4, seed=0, fuse=False):
    jcfg = jllama.LlamaConfig.tiny(**TINY)
    jq = jllama.quantize_llama(jllama.init_llama(jcfg, seed=seed),
                               processor=JHQQ(W_nbits=W_nbits, dtype=jnp.bfloat16),
                               group_size=GS, fuse=fuse)
    return jcfg, jq


def _carried(jq):
    return params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jq), device="cpu")


def _prefilled_jax(jcfg, jq, B=2, S0=8, seed=3):
    rng = np.random.default_rng(seed)
    prompt = jnp.asarray(rng.integers(0, jcfg.vocab_size, size=(B, S0)), jnp.int32)
    _, kv = jllama.llama_prefill(jq, jcfg, prompt, jllama.init_kv_cache(jcfg, B))
    tok = rng.integers(0, jcfg.vocab_size, size=(B, 1)).astype(np.int32)
    return kv, np.full((B,), S0, np.int32), tok


@pytest.mark.parametrize("W_nbits", [4, 2])
def test_scan_step_matches_jax_scan_step(W_nbits):
    jcfg, jq = _jax_model(W_nbits)
    jkv, lens, tok = _prefilled_jax(jcfg, jq)
    tkv = tensor_from_numpy(np.asarray(jkv))          # before JAX's step: JAX kv is immutable
    want_logits, want_kv = jscan.llama_decode_step_scan(
        jscan.stack_blocks(jq), jq, jcfg, jnp.asarray(tok), jkv, jnp.asarray(lens))
    params = _carried(jq)
    cfg = tllama.LlamaConfig.tiny(**TINY)
    got_logits, got_kv = tscan.llama_decode_step_scan(
        tscan.stack_blocks(params), params, cfg, torch.from_numpy(tok), tkv,
        torch.from_numpy(lens))
    np.testing.assert_allclose(got_logits.float().numpy(),
                               np.asarray(want_logits.astype(jnp.float32)), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_kv.float().numpy(), np.asarray(want_kv.astype(jnp.float32)),
                               rtol=TOL, atol=TOL)


FUSED_STACKS = (("attn", "wqkv"), ("attn", "wo"), ("mlp", "gate_up"), ("mlp", "down"))


@pytest.mark.parametrize("grp,name", FUSED_STACKS)
def test_fused_stacks_equal_jax_stacks(grp, name):
    """Scales and zeros stack to JAX's bytes; each layer of the stacked words
    equals that layer of JAX's stack carried across (the carry unfolds the JAX
    package's plane-folded words into the port's layout)."""
    jcfg, jq = _jax_model(fuse=True)
    want = jscan.stack_blocks(jq)[grp][name]
    got = tscan.stack_blocks(_carried(jq))[grp][name]
    assert got.bias is None and want.bias is None
    for t in ("scales", "zeros"):
        assert torch.equal(getattr(got, t), tensor_from_numpy(np.asarray(getattr(want, t))))
    for l in range(jcfg.num_layers):
        node = SimpleNamespace(W_q=np.asarray(want.W_q[l]), scales=np.asarray(want.scales[l]),
                               zeros=np.asarray(want.zeros[l]), bias=None, meta=want.meta)
        layer = params_from_jax_numpy(node, device="cpu")
        assert tuple(got.meta) == tuple(layer.meta)
        assert torch.equal(got.W_q[l], layer.W_q), l


@pytest.mark.parametrize("W_nbits", [4, 2])
def test_fused_scan_step_matches_jax_and_unrolled(W_nbits):
    jcfg, jq = _jax_model(W_nbits, fuse=True)
    jkv, lens, tok = _prefilled_jax(jcfg, jq)
    tkv = tensor_from_numpy(np.asarray(jkv))
    kv_unrolled = tkv.clone()
    want_logits, want_kv = jscan.llama_decode_step_scan(
        jscan.stack_blocks(jq), jq, jcfg, jnp.asarray(tok), jkv, jnp.asarray(lens))
    params = _carried(jq)
    cfg = tllama.LlamaConfig.tiny(**TINY)
    dispatch.KERNEL_TRACE.clear()
    got_logits, got_kv = tscan.llama_decode_step_scan(
        tscan.stack_blocks(params), params, cfg, torch.from_numpy(tok), tkv,
        torch.from_numpy(lens))
    assert dispatch.KERNEL_TRACE == ["plain_decode_stacked"] * (4 * cfg.num_layers)
    np.testing.assert_allclose(got_logits.float().numpy(),
                               np.asarray(want_logits.astype(jnp.float32)), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_kv.float().numpy(), np.asarray(want_kv.astype(jnp.float32)),
                               rtol=TOL, atol=TOL)
    unrolled, _ = tllama.llama_decode_step_batched(params, cfg, torch.from_numpy(tok),
                                                   kv_unrolled, torch.from_numpy(lens))
    assert torch.equal(got_logits, unrolled) and torch.equal(got_kv, kv_unrolled)


def test_fused_scan_engine_equals_fused_unrolled_engine_and_jax():
    jcfg, jq = _jax_model(fuse=True)
    params = _carried(jq)
    cfg = tllama.LlamaConfig.tiny(**TINY)
    rng = np.random.default_rng(4)           # the prompts of the unfused engine test above
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in (5, 9, 14)]
    kw = dict(max_batch=2, paged=False, prefill_buckets=(16,))
    scan = ContinuousBatchingEngine(params, cfg, scan_layers=True, device="cpu", **kw)
    assert sorted(scan._stacked["attn"]) == ["wo", "wqkv"]
    got = scan.generate(prompts, max_new_tokens=5)
    unrolled = ContinuousBatchingEngine(params, cfg, device="cpu", **kw)
    assert got == unrolled.generate(prompts, max_new_tokens=5)
    assert JEngine(jq, jcfg, scan_layers=True, **kw).generate(prompts, max_new_tokens=5) == got


def _port_model(W_nbits=4, processor=None):
    cfg = tllama.LlamaConfig.tiny(**TINY)
    dense = tllama.init_llama(cfg, seed=0, device="cpu")
    if processor is None:
        processor = A16Wn_HQQ_INT(device="cpu", dtype=torch.bfloat16, W_nbits=W_nbits)
    return cfg, tllama.quantize_llama(dense, processor=processor, group_size=GS, device="cpu")


@pytest.mark.parametrize("W_nbits", [4, 2, 1])
def test_scan_step_equals_unrolled_step(W_nbits):
    cfg, params = _port_model(W_nbits)
    B, S0 = 3, 7
    g = torch.Generator().manual_seed(W_nbits)
    prompt = torch.randint(0, cfg.vocab_size, (B, S0), generator=g)
    kv = tllama.init_kv_cache(cfg, B, device="cpu")
    tllama.llama_prefill(params, cfg, prompt, kv)
    kv_scan = kv.clone()
    lens = torch.tensor([S0, S0 - 2, S0 - 5], dtype=torch.int32)   # per-slot offsets
    tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=g)
    want, _ = tllama.llama_decode_step_batched(params, cfg, tok, kv, lens, t_active=32)
    got, _ = tscan.llama_decode_step_scan(tscan.stack_blocks(params), params, cfg, tok, kv_scan,
                                          lens, t_active=32)
    assert torch.equal(got, want)
    assert torch.equal(kv_scan, kv)


def test_scan_engine_equals_unrolled_engine_and_jax():
    jcfg, jq = _jax_model()
    params = params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jq), device="cpu")
    cfg = tllama.LlamaConfig.tiny(**TINY)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in (5, 9, 14)]
    kw = dict(max_batch=2, paged=False, prefill_buckets=(16,))
    scan = ContinuousBatchingEngine(params, cfg, scan_layers=True, device="cpu", **kw)
    unrolled = ContinuousBatchingEngine(params, cfg, device="cpu", **kw)
    got = scan.generate(prompts, max_new_tokens=5)
    assert got == unrolled.generate(prompts, max_new_tokens=5)
    assert JEngine(jq, jcfg, scan_layers=True, **kw).generate(prompts, max_new_tokens=5) == got


def test_scan_step_routes_every_linear_to_the_stacked_kernel():
    cfg, params = _port_model()
    kv = tllama.init_kv_cache(cfg, 2, device="cpu")
    dispatch.KERNEL_TRACE.clear()
    tscan.llama_decode_step_scan(tscan.stack_blocks(params), params, cfg,
                                 torch.tensor([[1], [2]]), kv,
                                 torch.tensor([3, 4], dtype=torch.int32))
    assert dispatch.KERNEL_TRACE == ["plain_decode_stacked"] * (7 * cfg.num_layers)


def _mixed_params():
    cfg, params = _port_model()
    params["blocks"][1]["mlp"]["down"] = _port_model(2)[1]["blocks"][1]["mlp"]["down"]
    return cfg, params


def _fused_params():
    """Block 0 holds a fused ``wqkv`` that block 1 lacks."""
    cfg, params = _port_model()
    params["blocks"][0]["attn"]["wqkv"] = params["blocks"][0]["attn"]["wq"]
    return cfg, params


def _bitnet_params():
    """Every block linear A16W158 (ternary codes, a scalar zero)."""
    cfg = tllama.LlamaConfig.tiny(**TINY)
    params = tllama.init_llama(cfg, seed=0, device="cpu")
    proc = A16W158_INT(device="cpu", dtype=torch.bfloat16)
    for blk in params["blocks"]:
        for grp in ("attn", "mlp"):
            for name, w in blk[grp].items():
                blk[grp][name] = proc.from_weights(torch.sign(w.to(torch.float32)), 0.01)
    return cfg, params


@pytest.mark.parametrize("case", ["paged", "mixed_metas", "dense_blocks", "a8w8", "a8w4",
                                  "scalar_zeros", "fused", "layer_index"])
def test_scan_guard_rails(case):
    if case == "paged":
        cfg, params = _port_model()
        with pytest.raises(ValueError, match="paged=False"):
            ContinuousBatchingEngine(params, cfg, scan_layers=True, paged=True, device="cpu")
    elif case == "mixed_metas":
        cfg, params = _mixed_params()
        with pytest.raises(ValueError, match="identical layer metas"):
            ContinuousBatchingEngine(params, cfg, scan_layers=True, paged=False, device="cpu")
    elif case == "dense_blocks":
        cfg = tllama.LlamaConfig.tiny(**TINY)
        with pytest.raises(ValueError, match="all-quantized"):
            tscan.stack_blocks(tllama.init_llama(cfg, device="cpu"))
    elif case == "a8w8":
        cfg, params = _port_model(processor=A8W8_INT8_dynamic(device="cpu",
                                                              dtype=torch.bfloat16))
        with pytest.raises(ValueError, match="quantized per token"):
            ContinuousBatchingEngine(params, cfg, scan_layers=True, paged=False, device="cpu")
    elif case == "a8w4":               # mode 3, per-token fp8 x (csm 2)
        cfg, params = _port_model(processor=A8Wn_HQQ_INT_dynamic(
            device="cpu", dtype=torch.bfloat16, W_nbits=4))
        with pytest.raises(ValueError, match="quantized per token"):
            ContinuousBatchingEngine(params, cfg, scan_layers=True, paged=False, device="cpu")
    elif case == "scalar_zeros":       # A16W158: mode 1 with a scalar zero, as JAX refuses
        cfg, params = _bitnet_params()
        with pytest.raises(ValueError, match="its zero is a scalar"):
            ContinuousBatchingEngine(params, cfg, scan_layers=True, paged=False, device="cpu")
    elif case == "fused":
        cfg, params = _fused_params()
        with pytest.raises(ValueError, match=r"block 1 lacks attn\.\['wqkv'\]"):
            tscan.stack_blocks(params)
    else:
        _, tst, _, tmeta, _ = _stacks(4)
        x = torch.zeros((M, K), dtype=torch.bfloat16)
        with pytest.raises(IndexError, match="outside the stack"):
            decode_matmul_stacked(x, *tst, tmeta, torch.tensor(L, dtype=torch.int32))
