# SPDX-License-Identifier: Apache-2.0
"""The port's checkpoints (``gemlite_tpu_torch/checkpoint.py`` and
``GemLiteLinear.save`` / ``load``) against the JAX package's, on the CPU.

* the port's ``save_model`` -> ``load_model`` gives back every tensor and
  layer bit for bit (W4, W2, A8W8, A16W8, fused ``wqkv`` / ``gate_up``, bf16
  and fp8 dense leaves, keys holding '/' and '%', lists, tuples and None),
  and older JAX files whose layer nodes list plain keys load too;
* a file the JAX package's ``save_model`` wrote loads in the port equal, bit
  for bit, to ``params_from_jax_numpy`` of the same tree;
* a file the port wrote loads in the JAX package, whose logits agree with
  the port's within ``TOL`` (tests/test_torch_llama.py's bound);
* ``GemLiteLinear.save`` / ``load`` in both directions.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemlite_tpu import GemLiteLinear as JLinear
from gemlite_tpu.checkpoint import load_model as jax_load_model
from gemlite_tpu.checkpoint import save_model as jax_save_model
from gemlite_tpu.helper import A16W4_HQQ_INT as JA16W4, A16W8_INT8 as JA16W8
from gemlite_tpu.helper import A8W8_INT8_dynamic as JA8W8
from gemlite_tpu.models import llama as jllama
from gemlite_tpu_torch import GemLiteLinear, load_model, params_from_jax_numpy, save_model
from gemlite_tpu_torch.helper import A16W4_HQQ_INT, A16W8_INT8, A8W8_INT8_dynamic
from gemlite_tpu_torch.models import llama as tllama
from gemlite_tpu_torch.quant import quantize_int_weights

from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 2e-2


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).contiguous().view(torch.uint8)


def assert_tree_equal(a, b, path="root"):
    """Every tensor equal bit for bit, with its dtype and shape; every layer
    with the same metadata, shape and tensors."""
    if isinstance(a, GemLiteLinear):
        assert isinstance(b, GemLiteLinear), path
        assert a.get_meta_args() == b.get_meta_args(), path
        assert (a.out_features, a.in_features) == (b.out_features, b.in_features), path
        sa, sb = a.state_dict(), b.state_dict()
        assert sorted(sa) == sorted(sb), path
        for k in sa:
            assert_tree_equal(sa[k], sb[k], f"{path}/{k}")
    elif isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{path}/{i}")
    elif a is None:
        assert b is None, path
    else:
        assert isinstance(b, torch.Tensor), path
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype)
        assert torch.equal(_bits(a), _bits(b)), path


CFG = tllama.LlamaConfig.tiny()


@pytest.fixture(scope="module")
def dense():
    return tllama.init_llama(CFG, seed=0, device="cpu")


def _quantized(dense, kind):
    if kind == "w4_gs64":
        return tllama.quantize_llama(dense, W_nbits=4, group_size=64, device="cpu")
    if kind == "w2_gs32":
        return tllama.quantize_llama(dense, W_nbits=2, group_size=32, device="cpu")
    if kind == "w4_fused":
        return tllama.quantize_llama(dense, W_nbits=4, group_size=64, fuse=True, device="cpu")
    if kind == "a8w8":
        return tllama.quantize_llama(dense, processor=A8W8_INT8_dynamic(
            device="cpu", dtype=torch.bfloat16))
    if kind == "a16w8":
        return tllama.quantize_llama(dense, processor=A16W8_INT8(
            device="cpu", dtype=torch.bfloat16))
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["w4_gs64", "w2_gs32", "w4_fused", "a8w8", "a16w8"])
def test_model_round_trip(dense, kind, tmp_path):
    params = _quantized(dense, kind)
    save_model(params, str(tmp_path / "m.npz"))
    back = load_model(str(tmp_path / "m.npz"), device="cpu")
    assert_tree_equal(params, back)
    tokens = torch.tensor([[3, 1, 4, 1, 5, 9, 2, 6]], dtype=torch.int32)
    assert torch.equal(tllama.llama_forward(params, CFG, tokens),
                       tllama.llama_forward(back, CFG, tokens))


def test_leaves_keys_and_containers_round_trip(tmp_path):
    """bf16 and fp8 leaves as bit views, keys with '/' and '%' escaped, a
    tuple, a list, None and a 0-d tensor."""
    g = torch.Generator().manual_seed(0)
    tree = {
        "model.layers.0/q_proj": torch.randn((8, 8), generator=g).to(torch.bfloat16),
        "100%": torch.randn((4, 4), generator=g).to(torch.float8_e4m3fn),
        "e5m2": torch.randn((4, 4), generator=g).to(torch.float8_e5m2),
        "f32": torch.arange(6, dtype=torch.float32),
        "nested": [(torch.tensor(7, dtype=torch.int32), None), {"a/b": torch.ones(3)}],
    }
    save_model(tree, str(tmp_path / "t.npz"))
    back = load_model(str(tmp_path / "t.npz"), device="cpu")
    assert_tree_equal(tree, back)
    with np.load(tmp_path / "t.npz") as data:
        manifest = json.loads(bytes(data["__manifest__"]).decode())
        assert data["root/model.layers.0%2Fq_proj"].dtype == np.uint16
    assert manifest["root/100%25"] == {"array": "float8_e4m3fn"}
    assert manifest["root/nested/0"] == {"tuple": 2}


def test_legacy_manifest_loads(tmp_path):
    """A JAX file from before the per-key markers: a layer node lists its
    keys, every array in a native numpy dtype (float32 metadata here)."""
    layer = A16W8_INT8(device="cpu", dtype=torch.float32).from_weights(
        torch.randn((64, 128), generator=torch.Generator().manual_seed(1)) * 0.02)
    sd = layer.state_dict()
    arrays = {f"root/lin/{k}": v.numpy() for k, v in sd.items()}
    manifest = {"root": {"dict": ["lin"]}, "root/lin": {"__gemlite_linear__": sorted(sd)}}
    arrays["__manifest__"] = np.frombuffer(json.dumps(manifest).encode(), dtype=np.uint8)
    np.savez(tmp_path / "legacy.npz", **arrays)
    back = load_model(str(tmp_path / "legacy.npz"), device="cpu")
    assert_tree_equal({"lin": layer}, back)


def _jax_model(kind):
    jcfg = jllama.LlamaConfig.tiny()
    jparams = jllama.init_llama(jcfg, seed=0)
    if kind == "w4_gs64":
        return jllama.quantize_llama(jparams, W_nbits=4, group_size=64), jcfg
    if kind == "w2_gs32":
        return jllama.quantize_llama(jparams, W_nbits=2, group_size=32), jcfg
    if kind == "w8":
        return jllama.quantize_llama(jparams, W_nbits=8, group_size=64), jcfg
    if kind == "w4_fused":
        return jllama.quantize_llama(jparams, W_nbits=4, group_size=64, fuse=True), jcfg
    if kind == "a8w8":
        return jllama.quantize_llama(jparams, processor=JA8W8(dtype=jnp.bfloat16)), jcfg
    if kind == "a16w8":
        return jllama.quantize_llama(jparams, processor=JA16W8(dtype=jnp.bfloat16)), jcfg
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["w4_gs64", "w2_gs32", "w8", "w4_fused", "a8w8", "a16w8"])
def test_jax_file_loads_as_params_from_jax_numpy(kind, tmp_path):
    """Plane-folded JAX layers (W4/W2 on halfword planes, W8 on byte planes)
    unfold on load exactly as params_from_jax_numpy unfolds them."""
    jq, _ = _jax_model(kind)
    jax_save_model(jq, str(tmp_path / "j.npz"))
    got = load_model(str(tmp_path / "j.npz"), device="cpu")
    want = params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jq), device="cpu")
    assert_tree_equal(want, got)


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


@pytest.mark.parametrize("kind", ["w4_gs64", "w4_fused", "a8w8", "a16w8"])
def test_port_file_loads_in_jax(dense, kind, tmp_path):
    """Every layer the port writes is in w_layout 0, which the JAX package's
    load_state_dict takes; the JAX model it loads gives the port's logits."""
    params = _quantized(dense, kind)
    save_model(params, str(tmp_path / "p.npz"))
    jq = jax_load_model(str(tmp_path / "p.npz"))
    jcfg = jllama.LlamaConfig.tiny()
    tokens = np.random.default_rng(0).integers(0, CFG.vocab_size, size=(2, 12)).astype(np.int32)
    want = jax.jit(jllama.llama_forward, static_argnums=1)(jq, jcfg, jnp.asarray(tokens))
    got = tllama.llama_forward(params, CFG, torch.from_numpy(tokens))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL, atol=TOL)


def _layer_pair(kind):
    """The same layer made by both packages' processors."""
    w = (np.random.default_rng(3).normal(size=(96, 256)) * 0.02).astype(np.float32)
    if kind == "a8w8":
        return (A8W8_INT8_dynamic(device="cpu", dtype=torch.bfloat16).from_weights(
            torch.from_numpy(w)), JA8W8(dtype=jnp.bfloat16).from_weights(w))
    W_q, s, z = quantize_int_weights(torch.from_numpy(w), 4, 64)
    return (A16W4_HQQ_INT(device="cpu", dtype=torch.bfloat16).from_weights(W_q, s, z),
            JA16W4(dtype=jnp.bfloat16).from_weights(W_q.numpy(), s.numpy(), z.numpy()))


@pytest.mark.parametrize("kind", ["w4_gs64", "a8w8"])
def test_layer_save_load_both_ways(kind, tmp_path):
    ours, theirs = _layer_pair(kind)
    x = (torch.randn((3, 256), generator=torch.Generator().manual_seed(4)) * 0.5).to(
        torch.bfloat16)
    ours.save(str(tmp_path / "ours.npz"))
    back = GemLiteLinear.load(str(tmp_path / "ours.npz"), device="cpu")
    assert_tree_equal(ours, back)
    assert torch.equal(back(x), ours(x))
    with np.load(tmp_path / "ours.npz") as data:
        markers = json.loads(bytes(data["__dtypes__"]).decode()) if "__dtypes__" in data else {}
    assert all(m == "bfloat16" for m in markers.values())

    # port file -> JAX layer: the same arrays (w_layout 0 carries no key)
    jl = JLinear.load(str(tmp_path / "ours.npz"))
    for k, v in ours.state_dict().items():
        assert np.array_equal(np.ascontiguousarray(jl.state_dict()[k]).reshape(-1).view(np.uint8),
                              _bits(v).numpy()), k
    # JAX file -> port layer: equal to the JAX layer carried by its numpy view
    theirs.save(str(tmp_path / "theirs.npz"))
    got = GemLiteLinear.load(str(tmp_path / "theirs.npz"), device="cpu")
    want = params_from_jax_numpy({"l": jax.tree_util.tree_map(np.asarray, theirs)},
                                 device="cpu")["l"]
    assert_tree_equal(want, got)
    assert_tree_equal(ours, got)
