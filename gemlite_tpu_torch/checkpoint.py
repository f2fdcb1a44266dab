# SPDX-License-Identifier: Apache-2.0
"""Whole-model checkpoints: a parameter tree with quantized layers in one file
(counterpart of ``gemlite_tpu/checkpoint.py``, in its exact format).

One ``.npz`` holds every tensor under a path key (``root/blocks/0/attn/wq/W_q``)
and a ``__manifest__`` uint8 entry, the JSON of the tree: a ``dict`` node
lists its sorted keys, ``list`` / ``tuple`` nodes their lengths, ``none`` a
None, ``array`` a tensor's dtype or bit-view marker, and a
``__gemlite_linear__`` node a ``GemLiteLinear`` as the per-key markers of its
``state_dict()``. ``/`` and ``%`` in dict keys are escaped. bf16 and fp8
tensors are stored as bit views (``dtypes.npz_encode_array``).

Files cross between the packages both ways: a file the JAX package wrote
loads here (plane-folded layers unfold through ``load_state_dict``), and a
file written here (every layer in w_layout 0, the reference layout) loads in
the JAX package. Older JAX files whose layer nodes list plain keys load too.
"""

import json
from typing import Any

import numpy as np

from .core import GemLiteLinear, resolve_device
from .dtypes import _NPZ_BIT_VIEWS, npz_decode_array, npz_encode_array

__all__ = ["save_model", "load_model"]

_GEMLITE_TAG = "__gemlite_linear__"


def _esc(key: str) -> str:
    """Escape the path separator, so a key holding '/' (an HF-style flat name)
    cannot collide with a nested path."""
    if not isinstance(key, str):
        raise TypeError(f"checkpoint dict keys must be str, got {type(key)!r}")
    return key.replace("%", "%25").replace("/", "%2F")


def _flatten(obj, path, arrays, manifest):
    if isinstance(obj, GemLiteLinear):
        sd = obj.state_dict()          # the zero-argument form: the layer's own format
        tag = {}
        for k in sorted(sd):
            arrays[f"{path}/{_esc(k)}"], tag[k] = npz_encode_array(sd[k])
        manifest[path] = {_GEMLITE_TAG: tag}
    elif isinstance(obj, dict):
        manifest[path] = {"dict": sorted(obj.keys())}
        for k in obj:
            _flatten(obj[k], f"{path}/{_esc(k)}", arrays, manifest)
    elif isinstance(obj, (list, tuple)):
        manifest[path] = {"list" if isinstance(obj, list) else "tuple": len(obj)}
        for i, v in enumerate(obj):
            _flatten(v, f"{path}/{i}", arrays, manifest)
    elif obj is None:
        manifest[path] = {"none": True}
    else:
        arrays[path], marker = npz_encode_array(obj)
        manifest[path] = {"array": marker or str(arrays[path].dtype)}


def _unflatten(path, arrays, manifest, device):
    node = manifest[path]
    if _GEMLITE_TAG in node:
        tag = node[_GEMLITE_TAG]
        if isinstance(tag, dict):
            sd = {k: npz_decode_array(arrays[f"{path}/{_esc(k)}"], m) for k, m in tag.items()}
        else:   # a legacy manifest: a plain key list, native numpy dtypes
            sd = {k: npz_decode_array(arrays[f"{path}/{_esc(k)}"]) for k in tag}
        return GemLiteLinear.from_state_dict(sd, device=device)
    if "dict" in node:
        return {k: _unflatten(f"{path}/{_esc(k)}", arrays, manifest, device)
                for k in node["dict"]}
    if "list" in node:
        return [_unflatten(f"{path}/{i}", arrays, manifest, device) for i in range(node["list"])]
    if "tuple" in node:
        return tuple(_unflatten(f"{path}/{i}", arrays, manifest, device)
                     for i in range(node["tuple"]))
    if "none" in node:
        return None
    marker = node["array"] if node["array"] in _NPZ_BIT_VIEWS else None
    return npz_decode_array(arrays[path], marker).to(device)


def save_model(params: Any, path: str) -> None:
    """Save a tree of dicts, lists, tuples, tensors and ``GemLiteLinear``s to
    one ``.npz`` (np.savez appends the suffix when ``path`` lacks it)."""
    arrays, manifest = {}, {}
    _flatten(params, "root", arrays, manifest)
    arrays["__manifest__"] = np.frombuffer(json.dumps(manifest).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_model(path: str, device=None) -> Any:
    """The tree that ``save_model`` (of this package or the JAX package)
    wrote, every tensor and layer on ``device`` (None: the card)."""
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files}
    manifest = json.loads(bytes(arrays.pop("__manifest__")).decode())
    return _unflatten("root", arrays, manifest, dev)
