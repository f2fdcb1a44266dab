# SPDX-License-Identifier: Apache-2.0
"""Carry a model's weights from the JAX package into the port.

``params_from_jax_numpy`` takes a JAX Llama param tree whose arrays have gone
through ``np.asarray`` (``jax.tree_util.tree_map(np.asarray, params)``) and
returns the port's param dict. Quantized layers are recognised by their
attributes (``W_q``, ``scales``, ``zeros``, ``bias`` and a ``meta`` named
tuple), so this module imports nothing of the JAX package. Plane-folded
layers (``w_layout`` 1/2) are unfolded to the port's w_layout=0.
``paged_kv_from_jax_numpy`` carries a JAX ``PagedKV``'s pages and table.
"""

from typing import Any

import numpy as np

from .core import GemLiteLinear, resolve_device, tensor_from_numpy
from .models.paged_kv import PagedKV

__all__ = ["params_from_jax_numpy", "paged_kv_from_jax_numpy"]


def _is_jax_layer(node) -> bool:
    return hasattr(node, "W_q") and hasattr(getattr(node, "meta", None), "_asdict")


def _layer_from_jax(node, device) -> GemLiteLinear:
    meta = {k: int(v) for k, v in node.meta._asdict().items()}
    sd = {
        "metadata": np.asarray(list(meta.values())[:12], np.int32),
        "orig_shape": np.asarray([meta["out_features"], meta["in_features"]], np.int32),
        "W_q": np.asarray(node.W_q),
        "w_layout": meta.get("w_layout", 0),
    }
    for key in ("w_code_dtype", "fp8_nosub", "mx_flat", "mx_x2"):
        sd[key] = meta.get(key, 0)
    for key in ("scales", "zeros", "bias"):
        value = getattr(node, key)
        if value is not None:
            sd[key] = np.asarray(value)
    return GemLiteLinear.from_state_dict(sd, device=device)


def params_from_jax_numpy(tree: Any, device=None) -> Any:
    """JAX param tree (numpy leaves) -> port param dict on ``device``."""
    dev = resolve_device(device)

    def convert(node):
        if _is_jax_layer(node):
            return _layer_from_jax(node, dev)
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(convert(v) for v in node)
        if node is None:
            return None
        return tensor_from_numpy(node, dev)

    return convert(tree)


def paged_kv_from_jax_numpy(pages, table, page_size: int, device=None) -> PagedKV:
    """A JAX ``PagedKV``'s ``pages`` (L, 2, Hkv, P, ps, D) and ``table`` (B,
    pps), as numpy arrays, -> the port's ``PagedKV`` on ``device``."""
    dev = resolve_device(device)
    return PagedKV(tensor_from_numpy(np.asarray(pages), dev),
                   tensor_from_numpy(np.asarray(table, np.int32), dev), int(page_size))
