# SPDX-License-Identifier: Apache-2.0
"""The port on the repo's trained checkpoint, ``checkpoints/tiny_en_5m`` (a
byte-level Llama: 6 layers, hidden 256, intermediate 768, 4/2 heads of 64),
against the JAX package on the CPU (its Pallas kernels in interpret mode).

* ``quantize_llama`` packs the same bytes and metadata as the JAX package's
  for W4 gs 64, W4 gs 128 and W8 (channel-wise HQQ, PARITY.md's "W8 gs=128");
* ``loss_fn`` on 2 held-out windows of 128 bytes within ``NLL_TOL`` nats/byte
  of the JAX ``loss_fn`` for dense bf16, W4 gs 64, W8, A16W8 and A8W8;
* the port's dense and paged engines give the JAX engine's greedy tokens
  for 2 held-out prompts.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemlite_tpu import importers as jimp
from gemlite_tpu.helper import A16W8_INT8 as JA16W8, A8W8_INT8_dynamic as JA8W8
from gemlite_tpu.models import llama as jllama
from gemlite_tpu.serving import ContinuousBatchingEngine as JaxEngine
from gemlite_tpu_torch import ContinuousBatchingEngine, params_from_jax_numpy
from gemlite_tpu_torch import importers as timp
from gemlite_tpu_torch.helper import A16W8_INT8, A8W8_INT8_dynamic
from gemlite_tpu_torch.models import llama as tllama

from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

CKPT = Path(__file__).resolve().parent.parent / "checkpoints" / "tiny_en_5m"
NLL_TOL = 2e-3
SEQ, WINDOWS = 128, 2


@pytest.fixture(scope="module")
def ckpt():
    jparams, jcfg = jimp.load_hf_llama(str(CKPT))
    tparams, tcfg = timp.load_hf_llama(str(CKPT), device="cpu")
    data = np.frombuffer((CKPT / "holdout.txt").read_bytes(), np.uint8)
    windows = np.stack([data[i * SEQ:(i + 1) * SEQ + 1] for i in range(WINDOWS)]).astype(np.int32)
    return {"jax": (jparams, jcfg), "port": (tparams, tcfg), "windows": windows, "data": data,
            "models": {}}


def _build(ckpt, kind):
    """(JAX params, port params) of one configuration, each quantized by its
    own package; cached for the module."""
    if kind in ckpt["models"]:
        return ckpt["models"][kind]
    (jp, _), (tp, _) = ckpt["jax"], ckpt["port"]
    if kind == "dense":
        pair = (jp, tp)
    elif kind.startswith("w"):
        bits, gs = {"w4_gs64": (4, 64), "w4_gs128": (4, 128), "w8": (8, 128)}[kind]
        pair = (jllama.quantize_llama(jp, W_nbits=bits, group_size=gs),
                tllama.quantize_llama(tp, W_nbits=bits, group_size=gs, device="cpu"))
    elif kind == "a16w8":
        pair = (jllama.quantize_llama(jp, processor=JA16W8(dtype=jnp.bfloat16)),
                tllama.quantize_llama(tp, processor=A16W8_INT8(device="cpu",
                                                                dtype=torch.bfloat16)))
    else:
        pair = (jllama.quantize_llama(jp, processor=JA8W8(dtype=jnp.bfloat16)),
                tllama.quantize_llama(tp, processor=A8W8_INT8_dynamic(device="cpu",
                                                                       dtype=torch.bfloat16)))
    ckpt["models"][kind] = pair
    return pair


@pytest.mark.parametrize("kind", ["w4_gs64", "w4_gs128", "w8"])
def test_quantize_llama_packs_jax_bytes(ckpt, kind):
    jq, tq = _build(ckpt, kind)
    carried = params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jq), device="cpu")
    for a, b in zip(tq["blocks"], carried["blocks"], strict=True):
        for grp, name in tllama._LINEAR_KEYS:
            x, y = a[grp][name], b[grp][name]
            assert x.get_meta_args() == y.get_meta_args(), name
            for t in ("W_q", "scales", "zeros"):
                assert torch.equal(getattr(x, t), getattr(y, t)), (name, t)


@pytest.mark.parametrize("kind", ["dense", "w4_gs64", "w8", "a16w8", "a8w8"])
def test_loss_matches_jax(ckpt, kind):
    jq, tq = _build(ckpt, kind)
    jcfg, tcfg = ckpt["jax"][1], ckpt["port"][1]
    w = ckpt["windows"]
    jloss = float(jax.jit(jllama.loss_fn, static_argnums=1)(
        jq, jcfg, jnp.asarray(w[:, :-1]), jnp.asarray(w[:, 1:])))
    tloss = float(tllama.loss_fn(tq, tcfg, torch.from_numpy(w[:, :-1]),
                                 torch.from_numpy(w[:, 1:])))
    assert 0.05 < tloss < 1.0          # a trained model on its held-out text
    assert abs(tloss - jloss) <= NLL_TOL, (tloss, jloss)


@pytest.fixture(scope="module")
def served(ckpt):
    """The JAX engine's greedy tokens for two held-out prompts (40 and 61
    bytes, cut at other offsets than the loss windows; one prefill bucket)
    on W4 gs 64, on its dense cache (its paged engine gives the same tokens
    and takes longer to compile here)."""
    jq, tq = _build(ckpt, "w4_gs64")
    data = ckpt["data"]
    prompts = [data[1000:1040].tolist(), data[5000:5061].tolist()]
    jeng = JaxEngine(jq, ckpt["jax"][1], max_batch=2, page_size=16, prefill_buckets=(64,),
                     paged=False)
    want = [[int(t) for t in out] for out in jeng.generate(prompts, max_new_tokens=8)]
    return tq, prompts, want


@pytest.mark.parametrize("paged", [False, True])
def test_engine_tokens_match_jax(ckpt, served, paged):
    tq, prompts, want = served
    eng = ContinuousBatchingEngine(tq, ckpt["port"][1], max_batch=2, paged=paged,
                                   page_size=16, prefill_buckets=(64,), device="cpu")
    assert eng.generate(prompts, max_new_tokens=8) == want
