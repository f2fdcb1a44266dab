# SPDX-License-Identifier: Apache-2.0
"""Llama-3-style transformer on quantized GemLite linears (counterpart of
``gemlite_tpu/models/llama.py``).

Parameters are a plain dict with the JAX package's structure, so a JAX tree
maps onto it key for key (see ``interop.params_from_jax_numpy``). The KV cache
is one dense tensor (L, 2, B, T, Hkv, D) or a ``PagedKV``
(``models/paged_kv.py``); both are written in place.

Ported: the no-cache, dense-cache and paged-cache forward, prefill, decode and
verify steps, over layers from any ported processor (``quantize_llama``), and
the forward loss (``loss_fn``). A one-shot prefill of 256 tokens or more
attends on the causal flash kernel, a paged decode step on the paged decode
kernel (``ops/attention.py``). Not yet ported: tensor-parallel sharding and
the training step.

``cache_len`` tells the attention paths apart as the JAX package's static and
traced offsets do: a Python int is a static offset, and only offset 0 takes
the flash kernel; a 0-d tensor is a runtime offset (a prompt chunk), which
never does; a (B,) tensor holds per-slot offsets (decode, verify). A tensor
offset is read on the device only: positions and cache rows are computed
from it there, so a step over it can be captured in a CUDA graph.

``slot`` (a (1,) index tensor, dense cache only) names the stripe a
one-row call writes and reads in the whole cache, as the JAX engine's
``dynamic_slice_in_dim`` on a device slot does: the rows are written by
``index_put_`` and masked attention reads the stripe by ``index_select``.
"""

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..core import GemLiteLinear, resolve_device
from ..helper import A16Wn_HQQ_INT, _warmup_layer, _warmup_quantize
from ..ops.attention import flash_attention_causal as _attention_flash_causal
from ..ops.attention import xla_attention
from .paged_kv import PagedKV, paged_decode_attention, paged_gather, paged_write

__all__ = [
    "LlamaConfig", "init_llama", "quantize_llama", "init_kv_cache",
    "llama_forward", "llama_prefill", "llama_decode_step",
    "llama_decode_step_batched", "llama_verify_step", "loss_fn",
]


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 2048
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def llama3_8b(**kw):
        return LlamaConfig(**kw)

    @staticmethod
    def tiny(**kw):
        base = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
                    num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                    max_seq_len=128)
        base.update(kw)
        return LlamaConfig(**base)


_LINEAR_KEYS = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
                ("mlp", "gate"), ("mlp", "up"), ("mlp", "down"))


def init_llama(cfg: LlamaConfig, seed: int = 0, generator: Optional[torch.Generator] = None,
               device=None) -> Dict:
    """Random dense params.

    Without ``generator`` the draws come from ``numpy.random.default_rng(seed)``
    in the JAX package's order, so a model equals the JAX ``init_llama(cfg,
    seed)`` bit for bit. With a ``torch.Generator`` (for model-sized widths) the
    draws are made on the generator's device instead."""
    dev = resolve_device(device)
    H, I = cfg.hidden_size, cfg.intermediate_size
    QD = cfg.num_heads * cfg.head_dim
    KD = cfg.num_kv_heads * cfg.head_dim
    rng = np.random.default_rng(seed) if generator is None else None

    def mat(n, k, std=0.02):
        if rng is not None:
            a = (rng.normal(size=(n, k)) * std).astype(np.float32)
            return torch.from_numpy(a).to(cfg.dtype).to(dev)
        a = torch.randn((n, k), generator=generator, device=generator.device,
                        dtype=torch.float32)
        return a.mul_(std).to(cfg.dtype).to(dev)

    def ones():
        return torch.ones(H, dtype=cfg.dtype, device=dev)

    blocks = []
    for _ in range(cfg.num_layers):
        blocks.append({
            "attn": {"wq": mat(QD, H), "wk": mat(KD, H), "wv": mat(KD, H), "wo": mat(H, QD)},
            "mlp": {"gate": mat(I, H), "up": mat(I, H), "down": mat(H, I)},
            "ln_attn": ones(),
            "ln_mlp": ones(),
        })
    return {"embed": mat(cfg.vocab_size, H, std=0.01), "blocks": blocks,
            "ln_f": ones(), "lm_head": mat(cfg.vocab_size, H, std=0.01)}


def quantize_llama(params: Dict, processor=None, W_nbits: int = 4, group_size: int = 128,
                   quantize_lm_head: bool = False, fuse: bool = False,
                   dtype: torch.dtype = torch.bfloat16, device=None, **quant_kwargs) -> Dict:
    """Replace every block linear (and optionally lm_head) with a packed
    GemLiteLinear. The default processor is ``A16Wn_HQQ_INT(W_nbits,
    dtype=bf16)``: scales and zeros are stored in bf16, as the JAX package's
    default does, which makes every layer a W_group_mode 4 bf16 layer that the
    decode, prefill and dequantize kernels serve. A processor without
    ``W_nbits`` (``A16W8_INT8``, ``A8W8_INT8_dynamic``, ``A16W8_FP8``,
    ``A8W8_FP8_dynamic``) quantizes the float weight itself through
    ``from_weights``; one with ``W_nbits`` (``A16Wn_HQQ_INT``,
    ``A8Wn_HQQ_INT_dynamic``) gets the HQQ-style quantizer's codes at
    ``group_size`` (``helper._warmup_quantize``, as in JAX). An MX processor
    (module ``.mx``, all six) quantizes the float weight through
    ``from_linear``, the rule of the JAX package's ``helper._warmup_layer``;
    JAX's own ``quantize_llama`` tests ``mx_fp8_dtype`` instead, which the
    A4W4 processors lack, and raises a TypeError for them (ROADMAP Queue C).

    ``fuse=True`` concatenates q/k/v into one ``wqkv`` layer and gate/up into
    one ``gate_up`` layer in float32 before quantizing, as the JAX package
    does: groups run along K within each output row, so the fused layer packs
    the separate layers' bytes side by side, and a block runs four linears
    instead of seven."""
    if processor is None:
        processor = A16Wn_HQQ_INT(device=device, dtype=dtype, W_nbits=W_nbits)

    def q(w):
        if type(processor).__module__.endswith(".mx"):
            return _warmup_layer(processor, w.to(torch.float32), group_size)
        if getattr(processor, "W_nbits", None) is not None:
            return _warmup_quantize(processor, w.to(torch.float32), group_size, **quant_kwargs)
        return processor.from_weights(w.to(torch.float32), None)

    out = dict(params)
    out["blocks"] = []
    for blk in params["blocks"]:
        nb = {"attn": dict(blk["attn"]), "mlp": dict(blk["mlp"]),
              "ln_attn": blk["ln_attn"], "ln_mlp": blk["ln_mlp"]}
        if fuse:
            a, m = blk["attn"], blk["mlp"]
            wqkv = torch.cat([a["wq"].to(torch.float32), a["wk"].to(torch.float32),
                              a["wv"].to(torch.float32)], dim=0)
            gate_up = torch.cat([m["gate"].to(torch.float32), m["up"].to(torch.float32)], dim=0)
            nb["attn"] = {"wqkv": q(wqkv), "wo": q(a["wo"])}
            nb["mlp"] = {"gate_up": q(gate_up), "down": q(m["down"])}
        else:
            for grp, name in _LINEAR_KEYS:
                nb[grp][name] = q(blk[grp][name])
        out["blocks"].append(nb)
    if quantize_lm_head:
        out["lm_head"] = q(params["lm_head"])
    return out


def init_kv_cache(cfg: LlamaConfig, batch: int, device=None) -> torch.Tensor:
    shape = (cfg.num_layers, 2, batch, cfg.max_seq_len, cfg.num_kv_heads, cfg.head_dim)
    return torch.zeros(shape, dtype=cfg.dtype, device=resolve_device(device))


def _rms_norm(x, w, eps):
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def _apply(layer, x):
    """Quantized layer or dense (N, K) matrix."""
    if isinstance(layer, GemLiteLinear):
        return layer(x)
    return x @ layer.T.to(x.dtype)


def _rope(x, positions, theta):
    """x: (B, S, H, D); positions: (B, S)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def _can_use_flash(q) -> bool:
    """Prefill flash-attention gate of the JAX package without its backend
    test: S >= 256, S % 128 == 0, D in (64, 128, 256). The kernel takes D 64
    and 128; D 256 raises on the card (ROADMAP Queue B)."""
    _, S, _, D = q.shape
    return S >= 256 and S % 128 == 0 and D in (64, 128, 256)


def _masked_over(k_all, v_all, q, pos):
    """Attention of q at cache positions pos (B, S) over the gathered or
    dense cache k_all/v_all (B, T, Hkv, D), causal by position."""
    B, S = pos.shape
    T = k_all.shape[1]
    t_idx = torch.arange(T, device=q.device)[None, None, :]
    mask = (t_idx <= pos[:, :, None]).expand(B, S, T)
    return xla_attention(q, k_all, v_all, mask)


def _block_forward(blk, cfg, x, positions, kv, layer_idx, cache_len, t_active=None, slot=None):
    """x: (B, S, H). kv: the dense cache (L, 2, B, T, Hkv, D) or a PagedKV,
    either written in place, or None. cache_len: valid cache length before
    this call, an int (static), a 0-d tensor (a prompt chunk's offset) or a
    (B,) tensor of per-slot offsets. t_active: bound on the live cache length
    that masked attention reads. slot: a (1,) index of the dense cache's
    stripe that this one-row call writes and reads."""
    B, S, _ = x.shape
    h = _rms_norm(x, blk["ln_attn"], cfg.norm_eps)
    if "wqkv" in blk["attn"]:
        QD, KD = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
        qkv = _apply(blk["attn"]["wqkv"], h)
        q, k, v = qkv[..., :QD], qkv[..., QD:QD + KD], qkv[..., QD + KD:]
    else:
        q, k, v = (_apply(blk["attn"][n], h) for n in ("wq", "wk", "wv"))
    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)

    per_slot = isinstance(cache_len, torch.Tensor) and cache_len.ndim == 1
    # flash only for a prefill at the static offset 0 (JAX llama.py:352, :402)
    one_shot = S > 1 and isinstance(cache_len, int) and cache_len == 0
    steps = torch.arange(S, device=x.device)
    if per_slot:
        pos = cache_len.to(torch.long)[:, None] + steps[None, :]
    elif isinstance(cache_len, torch.Tensor):
        pos = (cache_len.to(torch.long) + steps)[None, :].expand(B, S)
    else:
        pos = (int(cache_len) + steps)[None, :].expand(B, S)

    if isinstance(kv, PagedKV):
        paged_write(kv, layer_idx, k, v, pos)
        if one_shot and _can_use_flash(q):
            attn = _attention_flash_causal(q, k, v)
        elif S == 1 and per_slot:
            attn = paged_decode_attention(q[:, 0], kv, layer_idx,
                                          (cache_len + 1).to(torch.int32))[:, None]
        else:
            # prompt chunk or verify: masked attention over the gathered pages
            k_all, v_all = paged_gather(kv, layer_idx, t_active or 0)
            attn = _masked_over(k_all, v_all, q, pos)
    elif kv is not None:
        T = kv.shape[3]
        if per_slot:
            # per-slot offsets (continuous-batching decode, speculative verify).
            # An idle slot's stale offset may run past the cache: JAX drops
            # those rows of its scatter; here they land on the stripe's last
            # row, which no active slot holds (the engine finishes a slot
            # before its length reaches max_seq_len - 1)
            bidx = torch.arange(B, device=x.device)[:, None]
            wpos = pos.clamp(max=T - 1)
            kv[layer_idx, 0].index_put_((bidx, wpos), k.to(kv.dtype))
            kv[layer_idx, 1].index_put_((bidx, wpos), v.to(kv.dtype))
        else:
            if not isinstance(cache_len, torch.Tensor):
                start = int(cache_len)
                if not 0 <= start <= T - S:
                    raise ValueError(f"cache write [{start}, {start + S}) "
                                     f"outside the cache of {T} rows")
            if isinstance(cache_len, torch.Tensor) or slot is not None:
                # a device offset or slot: the rows are written at device
                # indices (the caller keeps them inside the cache)
                rows = (slot.to(torch.long) if slot is not None
                        else torch.arange(B, device=x.device))[:, None]
                kv[layer_idx, 0].index_put_((rows, pos), k.to(kv.dtype))
                kv[layer_idx, 1].index_put_((rows, pos), v.to(kv.dtype))
            else:
                kv[layer_idx, 0, :, start:start + S] = k.to(kv.dtype)
                kv[layer_idx, 1, :, start:start + S] = v.to(kv.dtype)
        if one_shot and _can_use_flash(q):
            # offset 0: causal over the first S rows is causal over k/v
            attn = _attention_flash_causal(q, k, v)
        else:
            k_all, v_all = kv[layer_idx, 0], kv[layer_idx, 1]
            if t_active is not None and t_active < T:
                k_all, v_all = k_all[:, :t_active], v_all[:, :t_active]
            if slot is not None:
                k_all, v_all = k_all.index_select(0, slot), v_all.index_select(0, slot)
            attn = _masked_over(k_all, v_all, q, pos)
    elif _can_use_flash(q):
        attn = _attention_flash_causal(q, k, v)
    else:
        attn = _masked_over(k, v, q, pos)

    x = x + _apply(blk["attn"]["wo"], attn.reshape(B, S, -1))

    h = _rms_norm(x, blk["ln_mlp"], cfg.norm_eps)
    if "gate_up" in blk["mlp"]:
        gu = _apply(blk["mlp"]["gate_up"], h)
        g, u = gu[..., :gu.shape[-1] // 2], gu[..., gu.shape[-1] // 2:]
    else:
        g, u = _apply(blk["mlp"]["gate"], h), _apply(blk["mlp"]["up"], h)
    h = (torch.nn.functional.silu(g.to(torch.float32)) * u.to(torch.float32)).to(x.dtype)
    return x + _apply(blk["mlp"]["down"], h)


def llama_forward(params, cfg: LlamaConfig, tokens, kv=None, cache_len=0, positions=None,
                  t_active=None, slot=None):
    """tokens (B, S) -> logits (B, S, V). With kv (dense or PagedKV), writes
    the cache at cache_len (in place) and attends over it; returns (logits,
    kv). cache_len: an int, a 0-d tensor (a prompt chunk) or (B,) offsets.
    slot: a (1,) index tensor naming the dense cache's stripe that a one-row
    call (B = 1) writes and reads, in place of a view of that stripe."""
    B, S = tokens.shape
    if positions is None:
        if isinstance(cache_len, torch.Tensor):
            off = cache_len[:, None] if cache_len.ndim == 1 else cache_len.to(torch.int32)
        else:
            off = int(cache_len)
        positions = (off + torch.arange(S, dtype=torch.int32, device=tokens.device)[None, :])
        positions = positions.expand(B, S)
    x = params["embed"][tokens]
    for i, blk in enumerate(params["blocks"]):
        x = _block_forward(blk, cfg, x, positions, kv, i, cache_len, t_active=t_active,
                           slot=slot)
    x = _rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = _apply(params["lm_head"], x)
    return (logits, kv) if kv is not None else logits


def llama_prefill(params, cfg, tokens, kv):
    return llama_forward(params, cfg, tokens, kv=kv, cache_len=0)


def llama_decode_step(params, cfg, token, kv, cache_len: int):
    """token (B, 1) at one shared cache offset -> (logits (B, 1, V), kv)."""
    return llama_forward(params, cfg, token, kv=kv, cache_len=cache_len)


def llama_verify_step(params, cfg, tokens, kv, cache_lens, t_active=None):
    """tokens (B, S) decoded in one forward at per-slot offsets cache_lens (B,)."""
    S = tokens.shape[1]
    positions = cache_lens[:, None].to(torch.int32) + torch.arange(
        S, dtype=torch.int32, device=tokens.device)[None, :]
    return llama_forward(params, cfg, tokens, kv=kv, cache_len=cache_lens,
                         positions=positions, t_active=t_active)


def llama_decode_step_batched(params, cfg, token, kv, cache_lens, t_active=None):
    """Continuous-batching decode: token (B, 1), cache_lens (B,) — every slot
    advances one token at its own offset; attention reads t_active rows."""
    positions = cache_lens[:, None].to(torch.int32)
    return llama_forward(params, cfg, token, kv=kv, cache_len=cache_lens,
                         positions=positions, t_active=t_active)


def loss_fn(params, cfg: LlamaConfig, tokens, targets) -> torch.Tensor:
    """Mean next-token negative log-likelihood (nats) of ``targets`` (B, S)
    given ``tokens`` (B, S), from a float32 log-softmax of the logits
    (``gemlite_tpu/models/llama.py:loss_fn``). Forward only."""
    logits = llama_forward(params, cfg, tokens)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.gather(logp, -1, targets[..., None].to(torch.long)).mean()
