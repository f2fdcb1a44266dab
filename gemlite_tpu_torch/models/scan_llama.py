# SPDX-License-Identifier: Apache-2.0
"""Scan-over-layers Llama decode (counterpart of
``gemlite_tpu/models/scan_llama.py``).

The JAX package builds its decode step as one ``lax.scan`` over a layer axis,
so that the compiled program does not grow with the layer count. PyTorch runs
eagerly and compiles nothing per step, so here the step is a Python loop over
the layers with the same structure:

* every block linear's packed tensors are stacked into (L, ...) buffers once
  at load time (``stack_blocks``), the fused ``wqkv`` / ``gate_up`` layers of
  ``quantize_llama(fuse=True)`` too, as the JAX package stacks them;
* each linear kind then runs through one launch entry over its whole stack,
  the stacked decode kernel (``ops/scan.py``), which reads the layer index on
  the device from one ``torch.arange(L)`` made per step; the host never reads
  an index and no weight slice is copied;
* the KV cache keeps its dense (L, 2, B, T, Hkv, D) layout; layer ``l``
  writes its slot rows in place and reads its view, as the unrolled step does.

The step takes the same norms, rotary embedding and masked attention as
``llama_decode_step_batched`` and equals it bit for bit on the CPU, and on the
card too where the stacked kernel equals the per-layer one. Prefill stays
unrolled.
"""

from typing import Dict

import torch

from ..core import GemLiteLinear
from ..ops import dispatch
from ..ops.scan import decode_matmul_stacked
from .llama import LlamaConfig, _apply, _masked_over, _rms_norm, _rope

__all__ = ["StackedLinear", "stack_blocks", "llama_decode_step_scan"]

_ATTN_KEYS = ("wq", "wk", "wv", "wo", "wqkv")
_MLP_KEYS = ("gate", "up", "down", "gate_up")


class StackedLinear:
    """One block linear's packed tensors across all L blocks, each stacked to
    (L, ...), and the one meta they share."""

    def __init__(self, meta, W_q, scales, zeros, bias):
        self.meta = meta
        self.W_q = W_q
        self.scales = scales
        self.zeros = zeros
        self.bias = bias


def _stack(tensors):
    return None if tensors[0] is None else torch.stack(tensors)


def _stack_linears(layers) -> StackedLinear:
    """Stack one named linear across the blocks; all metas must agree."""
    meta0 = layers[0].meta
    for lyr in layers[1:]:
        if tuple(lyr.meta) != tuple(meta0):
            raise ValueError("scan requires identical layer metas across blocks "
                             "(same shape, codec, modes)")
    return StackedLinear(meta0, _stack([l.W_q for l in layers]),
                         _stack([l.scales for l in layers]), _stack([l.zeros for l in layers]),
                         _stack([l.bias for l in layers]))


def stack_blocks(params: Dict) -> Dict:
    """The stacked parameters of a quantized model's blocks: the linears that
    block 0 holds (separate or fused), each a packed ``GemLiteLinear`` with
    one meta across the layers (true for any model ``quantize_llama``
    quantizes with one processor); the norm weights stacked to (L, H).
    Raises ``ValueError`` when a later block lacks one of block 0's linears
    or holds one that is not quantized."""
    blocks = params["blocks"]
    keys = {grp: [k for k in names if k in blocks[0][grp]]
            for grp, names in (("attn", _ATTN_KEYS), ("mlp", _MLP_KEYS))}
    for i, blk in enumerate(blocks):
        for grp, names in keys.items():
            missing = [k for k in names if k not in blk[grp]]
            if missing:
                raise ValueError(f"stack_blocks: block {i} lacks {grp}.{missing}, which "
                                 "block 0 holds")
            if not all(isinstance(blk[grp][k], GemLiteLinear) for k in names):
                raise ValueError("stack_blocks requires all-quantized blocks")
    return {
        **{grp: {k: _stack_linears([b[grp][k] for b in blocks]) for k in names}
           for grp, names in keys.items()},
        "ln_attn": torch.stack([b["ln_attn"] for b in blocks]),
        "ln_mlp": torch.stack([b["ln_mlp"] for b in blocks]),
    }


def _stacked_apply(stk: StackedLinear, x, layer_idx):
    """x (B, S, H) -> (B, S, N) through layer ``layer_idx`` (a 0-d int32
    tensor) of the stack; noted in ``KERNEL_TRACE`` as the router notes a
    linear."""
    B, S, H = x.shape
    dispatch._note("plain_decode_stacked" if x.device.type == "cpu" else "decode_stacked")
    out = decode_matmul_stacked(x.reshape(B * S, H), stk.W_q, stk.scales, stk.zeros, stk.meta,
                                layer_idx)
    out = out.reshape(B, S, -1)
    if stk.bias is not None:
        out = out + stk.bias[layer_idx.reshape(1)]        # (1, N): no host read
    return out


def llama_decode_step_scan(stacked: Dict, params: Dict, cfg: LlamaConfig, token, kv,
                           cache_lens, t_active=None):
    """Continuous-batching decode step over the stacked layers.

    token (B, 1); cache_lens (B,) per-slot offsets; kv the dense (L, 2, B, T,
    Hkv, D) cache, written in place. Returns (logits (B, 1, V), kv), the
    contract of ``llama_decode_step_batched``."""
    if not isinstance(kv, torch.Tensor) or kv.ndim != 6:
        raise ValueError("the scan step runs on the dense KV cache (L, 2, B, T, Hkv, D)")
    B, S = token.shape
    dev = token.device
    positions = cache_lens[:, None].to(torch.int32)
    pos = cache_lens.to(torch.long)[:, None] + torch.arange(S, device=dev)[None, :]
    bidx = torch.arange(B, device=dev)[:, None]
    layer_ids = torch.arange(cfg.num_layers, dtype=torch.int32, device=dev)
    T = kv.shape[3]
    QD, KD = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    att, mlp = stacked["attn"], stacked["mlp"]
    x = params["embed"][token]
    for l in range(cfg.num_layers):
        lidx = layer_ids[l]
        h = _rms_norm(x, stacked["ln_attn"][l], cfg.norm_eps)
        if "wqkv" in att:
            qkv = _stacked_apply(att["wqkv"], h, lidx)
            q, k, v = qkv[..., :QD], qkv[..., QD:QD + KD], qkv[..., QD + KD:]
        else:
            q, k, v = (_stacked_apply(att[n], h, lidx) for n in ("wq", "wk", "wv"))
        q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
        k = k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
        v = v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)
        kv[l, 0].index_put_((bidx, pos), k.to(kv.dtype))
        kv[l, 1].index_put_((bidx, pos), v.to(kv.dtype))
        k_all, v_all = kv[l, 0], kv[l, 1]
        if t_active is not None and t_active < T:
            k_all, v_all = k_all[:, :t_active], v_all[:, :t_active]
        attn = _masked_over(k_all, v_all, q, pos)
        x = x + _stacked_apply(att["wo"], attn.reshape(B, S, -1), lidx)

        h = _rms_norm(x, stacked["ln_mlp"][l], cfg.norm_eps)
        if "gate_up" in mlp:
            gu = _stacked_apply(mlp["gate_up"], h, lidx)
            g, u = gu[..., :gu.shape[-1] // 2], gu[..., gu.shape[-1] // 2:]
        else:
            g, u = _stacked_apply(mlp["gate"], h, lidx), _stacked_apply(mlp["up"], h, lidx)
        h = (torch.nn.functional.silu(g.to(torch.float32)) * u.to(torch.float32)).to(x.dtype)
        x = x + _stacked_apply(mlp["down"], h, lidx)
    x = _rms_norm(x, params["ln_f"], cfg.norm_eps)
    return _apply(params["lm_head"], x), kv
