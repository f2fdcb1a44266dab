# SPDX-License-Identifier: Apache-2.0
"""HuggingFace Llama checkpoints in and out of the port (counterpart of
``gemlite_tpu/importers.py``):

    params, cfg = load_hf_llama("checkpoints/tiny_en_5m")         # dense bf16, on the card
    qparams = quantize_llama(params, W_nbits=4, group_size=128)

Reads HF directories with ``*.safetensors`` (one file, or shards named by
``model.safetensors.index.json``) and ``config.json``, or a
``pytorch_model.bin`` state dict; imports an in-memory ``transformers``
model (``from_transformers``, which imports nothing of ``transformers``);
writes dense params back as an HF checkpoint (``export_hf_llama``).

The safetensors format is [u64 header length][JSON header][raw little-endian
buffer]. The reader copies each tensor's bytes from the file once into host
memory it owns (no read-only memory map), views them in torch (numpy has no
bf16), and the importer moves each tensor to the device once.
"""

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .core import GemLiteLinear, resolve_device, tensor_from_numpy
from .models.llama import LlamaConfig

__all__ = ["read_safetensors", "write_safetensors", "load_hf_config", "load_hf_state_dict",
           "import_state_dict", "load_hf_llama", "export_hf_llama", "from_transformers"]

# safetensors dtype tag <-> torch dtype
_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U64": torch.uint64, "U32": torch.uint32, "U16": torch.uint16, "U8": torch.uint8,
    "BOOL": torch.bool, "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2,
}
_ST_TAGS = {dt: tag for tag, dt in _ST_DTYPES.items()}


def read_safetensors(path: str, names=None) -> Dict[str, torch.Tensor]:
    """A .safetensors file -> {name: CPU tensor} (the tensors in ``names``,
    or all of them)."""
    with open(path, "rb") as f:
        header_len = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(header_len))
        entries = sorted(((info["data_offsets"][0], name, info) for name, info in header.items()
                          if name != "__metadata__" and (names is None or name in names)),
                         key=lambda e: e[0])
        out = {}
        for start, name, info in entries:
            tag = info["dtype"]
            if tag not in _ST_DTYPES:
                raise ValueError(f"Unsupported safetensors dtype {tag!r} for {name!r}")
            end = info["data_offsets"][1]
            raw = torch.empty(end - start, dtype=torch.uint8)
            f.seek(8 + header_len + start)
            if f.readinto(raw.numpy()) != end - start:
                raise ValueError(f"{path}: {name!r} runs past the end of the file")
            out[name] = raw.view(_ST_DTYPES[tag]).reshape(info["shape"])
    return out


def _host_bytes(t) -> np.ndarray:
    """The little-endian bytes of a tensor (any device), as a uint8 array."""
    t = t.detach().contiguous().cpu()
    return t.reshape(-1).view(torch.uint8).numpy()


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor],
                      metadata: Optional[Dict[str, str]] = None) -> None:
    """Write {name: tensor} (any device) as a .safetensors file; the header is
    padded with spaces to a multiple of 8 bytes, as HF pads it."""
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = metadata
    offset = 0
    for name, t in tensors.items():
        tag = _ST_TAGS.get(t.dtype)
        if tag is None:
            raise ValueError(f"Unsupported dtype {t.dtype} for {name!r}")
        size = t.numel() * t.element_size()
        header[name] = {"dtype": tag, "shape": list(t.shape),
                        "data_offsets": [offset, offset + size]}
        offset += size
    hjson = json.dumps(header).encode()
    hjson += b" " * ((-len(hjson)) % 8)
    with open(path, "wb") as f:
        f.write(len(hjson).to_bytes(8, "little"))
        f.write(hjson)
        for t in tensors.values():
            f.write(memoryview(_host_bytes(t)))


def _hf_state_dict(params: Dict, dtype: torch.dtype, tie_word_embeddings: bool) -> Dict:
    def a(name, v):
        if isinstance(v, GemLiteLinear):
            raise TypeError(f"{name} is a quantized layer: export_hf_llama writes dense params "
                            "(save quantized ones with checkpoint.save_model)")
        return v.detach().to(dtype)

    sd = {"model.embed_tokens.weight": a("embed", params["embed"]),
          "model.norm.weight": a("ln_f", params["ln_f"])}
    if not tie_word_embeddings:
        sd["lm_head.weight"] = a("lm_head", params["lm_head"])
    for i, blk in enumerate(params["blocks"]):
        L = f"model.layers.{i}."
        for hf, (grp, key) in (("self_attn.q_proj", ("attn", "wq")),
                               ("self_attn.k_proj", ("attn", "wk")),
                               ("self_attn.v_proj", ("attn", "wv")),
                               ("self_attn.o_proj", ("attn", "wo")),
                               ("mlp.gate_proj", ("mlp", "gate")),
                               ("mlp.up_proj", ("mlp", "up")),
                               ("mlp.down_proj", ("mlp", "down"))):
            sd[f"{L}{hf}.weight"] = a(f"blocks.{i}.{grp}.{key}", blk[grp][key])
        sd[L + "input_layernorm.weight"] = a(f"blocks.{i}.ln_attn", blk["ln_attn"])
        sd[L + "post_attention_layernorm.weight"] = a(f"blocks.{i}.ln_mlp", blk["ln_mlp"])
    return sd


def _shards(sd: Dict, max_shard_bytes: Optional[int]) -> List[Dict]:
    """Whole tensors in order, a new shard whenever the next tensor would take
    the current one past ``max_shard_bytes``."""
    shards, size = [{}], 0
    for name, t in sd.items():
        nbytes = t.numel() * t.element_size()
        if max_shard_bytes is not None and shards[-1] and size + nbytes > max_shard_bytes:
            shards.append({})
            size = 0
        shards[-1][name] = t
        size += nbytes
    return shards


def export_hf_llama(params: Dict, cfg: LlamaConfig, path: str,
                    dtype: torch.dtype = torch.bfloat16, tie_word_embeddings: bool = False,
                    max_shard_bytes: Optional[int] = None) -> List[str]:
    """Write dense params as an HF Llama checkpoint (``config.json`` and the
    weights), the inverse of ``load_hf_llama``. With ``max_shard_bytes`` the
    weights go into shards ``model-0000i-of-0000n.safetensors`` named by
    ``model.safetensors.index.json`` whenever they need more than one.
    Quantized layers are not exported: ``checkpoint.save_model`` saves them.
    Returns the paths of the weight files written."""
    os.makedirs(path, exist_ok=True)
    sd = _hf_state_dict(params, dtype, tie_word_embeddings)
    shards = _shards(sd, max_shard_bytes)
    files = []
    if len(shards) == 1:
        files.append(os.path.join(path, "model.safetensors"))
        write_safetensors(files[0], sd, metadata={"format": "pt"})
    else:
        weight_map = {}
        for i, shard in enumerate(shards):
            fname = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
            files.append(os.path.join(path, fname))
            write_safetensors(files[-1], shard, metadata={"format": "pt"})
            weight_map.update({name: fname for name in shard})
        total = sum(t.numel() * t.element_size() for t in sd.values())
        with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
            json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f, indent=2)
    hf_cfg = {
        "architectures": ["LlamaForCausalLM"],
        "model_type": "llama",
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.norm_eps,
        "max_position_embeddings": cfg.max_seq_len,
        "hidden_act": "silu",
        "tie_word_embeddings": tie_word_embeddings,
        "torch_dtype": {torch.float32: "float32", torch.float16: "float16"}.get(dtype,
                                                                              "bfloat16"),
        "bos_token_id": 1, "eos_token_id": 2,
    }
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)
    return files


def _config(get, max_seq_len, dtype) -> LlamaConfig:
    """An HF config's fields (``get(name, default)``) -> LlamaConfig."""
    heads = get("num_attention_heads", None)
    return LlamaConfig(
        vocab_size=get("vocab_size", None),
        hidden_size=get("hidden_size", None),
        intermediate_size=get("intermediate_size", None),
        num_layers=get("num_hidden_layers", None),
        num_heads=heads,
        num_kv_heads=get("num_key_value_heads", None) or heads,
        head_dim=get("head_dim", None) or get("hidden_size", None) // heads,
        rope_theta=float(get("rope_theta", 10000.0)),
        norm_eps=float(get("rms_norm_eps", 1e-5)),
        max_seq_len=(max_seq_len if max_seq_len is not None
                     else min(int(get("max_position_embeddings", 2048)), 2048)),
        dtype=dtype if dtype is not None else torch.bfloat16,
    )


def load_hf_config(path: str, max_seq_len: Optional[int] = None,
                   dtype: Optional[torch.dtype] = None) -> LlamaConfig:
    """An HF ``config.json`` of the Llama family (llama, mistral, qwen2) ->
    LlamaConfig. ``head_dim`` defaults to hidden / heads, ``max_seq_len`` to
    min(max_position_embeddings, 2048), ``dtype`` to bf16."""
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    mt = hf.get("model_type", "llama")
    if mt not in ("llama", "mistral", "qwen2"):
        raise ValueError(f"Unsupported model_type {mt!r} (llama-family only)")
    return _config(hf.get, max_seq_len, dtype)


def load_hf_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Every weight of an HF checkpoint directory, as CPU tensors: the shards
    of ``model.safetensors.index.json``, else ``model.safetensors``, else
    every ``*.safetensors``, else ``pytorch_model.bin``."""
    idx = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(idx):
        with open(idx) as f:
            weight_map = json.load(f)["weight_map"]
        by_file: Dict[str, set] = {}
        for name, fname in weight_map.items():
            by_file.setdefault(fname, set()).add(name)
        sd = {}
        for fname, names in by_file.items():
            sd.update(read_safetensors(os.path.join(path, fname), names))
        return sd
    single = os.path.join(path, "model.safetensors")
    if os.path.exists(single):
        return read_safetensors(single)
    anyst = [f for f in sorted(os.listdir(path)) if f.endswith(".safetensors")]
    if anyst:
        sd = {}
        for f in anyst:
            sd.update(read_safetensors(os.path.join(path, f)))
        return sd
    binp = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(binp):
        return torch.load(binp, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"No safetensors / pytorch_model.bin under {path}")


def import_state_dict(sd: Dict[str, Any], cfg: LlamaConfig, device=None) -> Dict:
    """HF Llama weight names -> the params dict of ``models/llama.py``, each
    tensor in ``cfg.dtype`` on ``device``. The ``model.`` prefix is optional;
    without ``lm_head.weight`` the head is the embedding (tied)."""
    dev = resolve_device(device)

    def arr(name):
        v = sd[name]
        v = v.detach() if isinstance(v, torch.Tensor) else tensor_from_numpy(v)
        return v.to(device=dev, dtype=cfg.dtype)

    prefix = "model." if "model.embed_tokens.weight" in sd else ""
    blocks = []
    for i in range(cfg.num_layers):
        L = f"{prefix}layers.{i}."
        blocks.append({
            "attn": {"wq": arr(L + "self_attn.q_proj.weight"),
                     "wk": arr(L + "self_attn.k_proj.weight"),
                     "wv": arr(L + "self_attn.v_proj.weight"),
                     "wo": arr(L + "self_attn.o_proj.weight")},
            "mlp": {"gate": arr(L + "mlp.gate_proj.weight"),
                    "up": arr(L + "mlp.up_proj.weight"),
                    "down": arr(L + "mlp.down_proj.weight")},
            "ln_attn": arr(L + "input_layernorm.weight"),
            "ln_mlp": arr(L + "post_attention_layernorm.weight"),
        })
    embed = arr(prefix + "embed_tokens.weight")
    lm_head = arr("lm_head.weight") if "lm_head.weight" in sd else embed
    return {"embed": embed, "blocks": blocks, "ln_f": arr(prefix + "norm.weight"),
            "lm_head": lm_head}


def load_hf_llama(path: str, max_seq_len: Optional[int] = None,
                  dtype: Optional[torch.dtype] = None, device=None) -> Tuple[Dict, LlamaConfig]:
    """An HF checkpoint directory -> (dense params on ``device``, cfg). Follow
    with ``quantize_llama`` or a processor for a quantized model."""
    dev = resolve_device(device)
    cfg = load_hf_config(path, max_seq_len=max_seq_len, dtype=dtype)
    return import_state_dict(load_hf_state_dict(path), cfg, device=dev), cfg


def from_transformers(model, max_seq_len: Optional[int] = None,
                      dtype: Optional[torch.dtype] = None,
                      device=None) -> Tuple[Dict, LlamaConfig]:
    """An in-memory ``transformers`` LlamaForCausalLM (read through its
    ``config`` and ``state_dict()``) -> (dense params on ``device``, cfg)."""
    dev = resolve_device(device)
    hf = model.config
    cfg = _config(lambda name, default: getattr(hf, name, default), max_seq_len, dtype)
    return import_state_dict(model.state_dict(), cfg, device=dev), cfg
