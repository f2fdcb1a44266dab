# SPDX-License-Identifier: Apache-2.0
"""The port's HF importers (``gemlite_tpu_torch/importers.py``) against the
JAX package's ``gemlite_tpu/importers.py``, on the CPU.

* safetensors files written by either package read equal in the other (BF16,
  F32, I8, F8), and the two writers write the same bytes;
* ``load_hf_llama("checkpoints/tiny_en_5m")`` equals the JAX import bit for bit;
* sharded checkpoints (an index and two shards), tied embeddings, the
  export -> load round trip, ``pytorch_model.bin`` and the config mapping;
* ``from_transformers`` against a tiny ``LlamaForCausalLM``'s logits.
"""

import json
import os
import shutil
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from gemlite_tpu import importers as jimp
from gemlite_tpu_torch import importers as timp
from gemlite_tpu_torch.models import llama as tllama

from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

CKPT = Path(__file__).resolve().parent.parent / "checkpoints" / "tiny_en_5m"


def _np_tensors():
    rng = np.random.default_rng(0)
    return {
        "bf16": rng.normal(size=(5, 8)).astype(np.float32).astype(ml_dtypes.bfloat16),
        "f32": rng.normal(size=(3, 7)).astype(np.float32),
        "i8": rng.integers(-128, 128, size=(4, 6)).astype(np.int8),
        "f8": rng.normal(size=(6, 2)).astype(np.float32).astype(ml_dtypes.float8_e4m3fn),
        "e5m2": rng.normal(size=(9,)).astype(np.float32).astype(ml_dtypes.float8_e5m2),
    }


def _torch_of(a: np.ndarray) -> torch.Tensor:
    dt = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn,
          "float8_e5m2": torch.float8_e5m2}.get(a.dtype.name)
    if dt is None:
        return torch.from_numpy(a.copy())
    bits = np.int16 if dt == torch.bfloat16 else np.uint8
    return torch.from_numpy(a.view(bits).copy()).view(dt)


def _same(t: torch.Tensor, a: np.ndarray) -> bool:
    want = _torch_of(np.asarray(a))
    return (t.dtype == want.dtype and t.shape == want.shape
            and torch.equal(t.reshape(-1).view(torch.uint8), want.reshape(-1).view(torch.uint8)))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_safetensors_cross_read(writer, tmp_path):
    arrays = _np_tensors()
    meta = {"format": "pt"}
    jpath, tpath = tmp_path / "j.safetensors", tmp_path / "t.safetensors"
    jimp.write_safetensors(str(jpath), arrays, metadata=meta)
    timp.write_safetensors(str(tpath), {k: _torch_of(a) for k, a in arrays.items()},
                           metadata=meta)
    assert jpath.read_bytes() == tpath.read_bytes()
    if writer == "jax":
        got = timp.read_safetensors(str(jpath))
        assert sorted(got) == sorted(arrays)
        assert all(_same(got[k], arrays[k]) for k in arrays)
        sub = timp.read_safetensors(str(jpath), names={"f32"})
        assert list(sub) == ["f32"] and _same(sub["f32"], arrays["f32"])
    else:
        got = jimp.read_safetensors(str(tpath))
        assert all(got[k].dtype == arrays[k].dtype and
                   np.array_equal(got[k].view(np.uint8), arrays[k].view(np.uint8))
                   for k in arrays)


def _bits(t):
    return t.reshape(-1).view(torch.uint8)


def _assert_params_equal_jax(tparams, jparams):
    def eq(t, j):
        assert _same(t, np.asarray(j))

    for key in ("embed", "ln_f", "lm_head"):
        eq(tparams[key], jparams[key])
    for tb, jb in zip(tparams["blocks"], jparams["blocks"], strict=True):
        for grp in ("attn", "mlp"):
            for name in jb[grp]:
                eq(tb[grp][name], jb[grp][name])
        eq(tb["ln_attn"], jb["ln_attn"])
        eq(tb["ln_mlp"], jb["ln_mlp"])


def test_tiny_en_5m_imports_as_in_jax():
    tparams, tcfg = timp.load_hf_llama(str(CKPT), device="cpu")
    jparams, jcfg = jimp.load_hf_llama(str(CKPT))
    for f in ("vocab_size", "hidden_size", "intermediate_size", "num_layers", "num_heads",
              "num_kv_heads", "head_dim", "rope_theta", "norm_eps", "max_seq_len"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert tcfg.dtype == torch.bfloat16
    _assert_params_equal_jax(tparams, jparams)
    assert (tcfg.num_layers, tcfg.hidden_size, tcfg.head_dim) == (6, 256, 64)


def _random_dense(num_layers=2):
    cfg = tllama.LlamaConfig.tiny(num_layers=num_layers)
    return tllama.init_llama(cfg, seed=1, device="cpu"), cfg


def _assert_params_equal(a, b):
    for key in ("embed", "ln_f", "lm_head"):
        assert torch.equal(_bits(a[key]), _bits(b[key])), key
    for x, y in zip(a["blocks"], b["blocks"], strict=True):
        for grp in ("attn", "mlp"):
            for name in x[grp]:
                assert torch.equal(_bits(x[grp][name]), _bits(y[grp][name])), name
        for key in ("ln_attn", "ln_mlp"):
            assert torch.equal(_bits(x[key]), _bits(y[key])), key


def test_export_load_round_trip(tmp_path):
    params, cfg = _random_dense()
    files = timp.export_hf_llama(params, cfg, str(tmp_path))
    assert [os.path.basename(f) for f in files] == ["model.safetensors"]
    back, cfg2 = timp.load_hf_llama(str(tmp_path), device="cpu")
    assert cfg2 == cfg
    _assert_params_equal(params, back)
    # the JAX importer reads the port's export as its own
    jparams, _ = jimp.load_hf_llama(str(tmp_path))
    _assert_params_equal_jax(back, jparams)


def test_sharded_index(tmp_path):
    """Two shards and model.safetensors.index.json: whole tensors in order,
    a new shard when the next tensor would pass the limit."""
    params, cfg = _random_dense()
    sd_bytes = sum(t.numel() * t.element_size() for t in
                   timp._hf_state_dict(params, torch.bfloat16, False).values())
    files = timp.export_hf_llama(params, cfg, str(tmp_path), max_shard_bytes=sd_bytes * 2 // 3)
    assert [os.path.basename(f) for f in files] == ["model-00001-of-00002.safetensors",
                                                    "model-00002-of-00002.safetensors"]
    index = json.loads((tmp_path / "model.safetensors.index.json").read_text())
    assert index["metadata"]["total_size"] == sd_bytes
    assert set(index["weight_map"].values()) == {os.path.basename(f) for f in files}
    back, _ = timp.load_hf_llama(str(tmp_path), device="cpu")
    _assert_params_equal(params, back)
    jparams, _ = jimp.load_hf_llama(str(tmp_path))
    _assert_params_equal_jax(back, jparams)


def test_tied_embeddings(tmp_path):
    params, cfg = _random_dense(num_layers=1)
    timp.export_hf_llama(params, cfg, str(tmp_path), tie_word_embeddings=True)
    assert "lm_head.weight" not in timp.read_safetensors(str(tmp_path / "model.safetensors"))
    assert json.loads((tmp_path / "config.json").read_text())["tie_word_embeddings"]
    back, _ = timp.load_hf_llama(str(tmp_path), device="cpu")
    assert back["lm_head"] is back["embed"]
    assert torch.equal(_bits(back["embed"]), _bits(params["embed"]))


def test_resolution_order_and_bin(tmp_path):
    """Any *.safetensors when model.safetensors is absent; pytorch_model.bin
    (read with weights_only) when no safetensors is; FileNotFoundError when
    neither is there."""
    params, cfg = _random_dense(num_layers=1)
    timp.export_hf_llama(params, cfg, str(tmp_path))
    os.rename(tmp_path / "model.safetensors", tmp_path / "weights.safetensors")
    _assert_params_equal(params, timp.load_hf_llama(str(tmp_path), device="cpu")[0])
    sd = timp.read_safetensors(str(tmp_path / "weights.safetensors"))
    os.remove(tmp_path / "weights.safetensors")
    torch.save({k[len("model."):] if k.startswith("model.") else k: v for k, v in sd.items()},
               tmp_path / "pytorch_model.bin")
    _assert_params_equal(params, timp.load_hf_llama(str(tmp_path), device="cpu")[0])
    os.remove(tmp_path / "pytorch_model.bin")
    with pytest.raises(FileNotFoundError):
        timp.load_hf_state_dict(str(tmp_path))


@pytest.mark.parametrize("hf", [
    {"model_type": "llama", "head_dim": 64, "max_position_embeddings": 8192},
    {"model_type": "mistral", "max_position_embeddings": 1024},
    {"model_type": "qwen2", "rope_theta": 1e6, "rms_norm_eps": 1e-6},
    {"num_key_value_heads": None},
])
def test_config_mapping(hf, tmp_path):
    """Field by field as the JAX package maps it: head_dim defaults to
    hidden / heads, max_seq_len to min(max_position_embeddings, 2048)."""
    base = {"vocab_size": 300, "hidden_size": 256, "intermediate_size": 512,
            "num_hidden_layers": 3, "num_attention_heads": 4, "num_key_value_heads": 2}
    base.update(hf)
    if base["num_key_value_heads"] is None:
        del base["num_key_value_heads"]
    (tmp_path / "config.json").write_text(json.dumps(base))
    t = timp.load_hf_config(str(tmp_path))
    j = jimp.load_hf_config(str(tmp_path))
    for f in ("vocab_size", "hidden_size", "intermediate_size", "num_layers", "num_heads",
              "num_kv_heads", "head_dim", "rope_theta", "norm_eps", "max_seq_len"):
        assert getattr(t, f) == getattr(j, f), f
    assert timp.load_hf_config(str(tmp_path), max_seq_len=77, dtype=torch.float32) == \
        tllama.LlamaConfig(**{**t.__dict__, "max_seq_len": 77, "dtype": torch.float32})


def test_unsupported_model_type(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "gpt2"}))
    with pytest.raises(ValueError, match="llama-family"):
        timp.load_hf_config(str(tmp_path))


def test_quantized_params_do_not_export(tmp_path):
    params, cfg = _random_dense(num_layers=1)
    q = tllama.quantize_llama(params, group_size=64, device="cpu")
    with pytest.raises(TypeError, match="quantized layer"):
        timp.export_hf_llama(q, cfg, str(tmp_path))


def test_from_transformers_logits(monkeypatch):
    """The imported model's float32 logits against the transformers forward
    of the same tiny LlamaForCausalLM: mean |a - b| / mean |b| < 5e-4 and
    argmax agreement above 99%, tests/test_importers.py's bars."""
    monkeypatch.setenv("USE_TF", "0")       # transformers would import TensorFlow too
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512,
        rope_theta=10000.0, rms_norm_eps=1e-5, tie_word_embeddings=False)
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(hf_cfg).eval()
    params, cfg = timp.from_transformers(model, dtype=torch.float32, device="cpu")
    assert cfg.max_seq_len == 512 and cfg.head_dim == 32
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 256, size=(2, 48)))
    with torch.no_grad():
        want = model(tokens).logits.float()
    got = tllama.llama_forward(params, cfg, tokens.to(torch.int32)).float()
    assert float((got - want).abs().mean() / want.abs().mean()) < 5e-4
    assert float((got.argmax(-1) == want.argmax(-1)).float().mean()) > 0.99


def test_checkpoint_dir_is_read_only_input(tmp_path):
    """Importing copies the bytes it reads: writing to an imported tensor
    leaves the file as it was."""
    shutil.copytree(CKPT, tmp_path / "ck")
    before = (tmp_path / "ck" / "model.safetensors").read_bytes()
    params, _ = timp.load_hf_llama(str(tmp_path / "ck"), device="cpu")
    params["embed"].zero_()
    assert (tmp_path / "ck" / "model.safetensors").read_bytes() == before
