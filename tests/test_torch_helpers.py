# SPDX-License-Identifier: Apache-2.0
"""The port's integration helpers (``patch_model``, ``warmup``,
``from_linear`` / ``from_bitlinear``, ``cleanup_linear``) and
``GemLiteLinear.forward_manual`` against the JAX package's, on the CPU.

* ``patch_model`` over a torch module tree packs the same bytes and metadata
  as the JAX ``patch_model`` over an equal tree (A16W8_INT8, A8W8_INT8_dynamic,
  A16W8_FP8, A8W8_FP8_dynamic); a patched layer's output lies within 2e-2
  (norm-relative) of the float linear's, 5e-2 with fp8 weights (e4m3 keeps
  3 mantissa bits: about 2.5% rms a rounded value; tests/test_helpers.py holds
  the JAX package's fp8 processors to 8e-2);
  it walks plain object trees (lists and tuples too), honours
  ``skip_modules`` and raises ``ImportError`` for a processor that needs hqq;
* ``warmup`` builds the JAX ``_warmup_layer``'s layer and runs every bucket;
* ``forward_manual`` under each family name equals ``forward`` bit for bit;
* the port's M buckets equal the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from gemlite_tpu import helper as jhelper
from gemlite_tpu.utils import m_bucket as jbucket
from gemlite_tpu_torch import GEMLITE_MATMUL_TYPES, DType, GemLiteLinear, params_from_jax_numpy
from gemlite_tpu_torch import helper as thelper
from gemlite_tpu_torch.core import forward_functional
from gemlite_tpu_torch.ops import dispatch
from gemlite_tpu_torch.quant import quantize_int_weights
from gemlite_tpu_torch.utils import m_bucket as tbucket

from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)


class Block(nn.Module):
    """The seven linears of a Llama block at a narrow width."""

    def __init__(self, H=128, I=256, KV=64):
        super().__init__()
        self.attn = nn.ModuleDict({"q_proj": nn.Linear(H, H, bias=False),
                                   "k_proj": nn.Linear(H, KV, bias=False),
                                   "v_proj": nn.Linear(H, KV, bias=False),
                                   "o_proj": nn.Linear(H, H, bias=True)})
        self.mlp = nn.ModuleDict({"gate_proj": nn.Linear(H, I, bias=False),
                                  "up_proj": nn.Linear(H, I, bias=False),
                                  "down_proj": nn.Linear(I, H, bias=False)})


class Tiny(nn.Module):
    def __init__(self, seed=0):
        super().__init__()
        torch.manual_seed(seed)
        self.embed = nn.Embedding(64, 128)
        self.layers = nn.ModuleList([Block(), Block()])
        self.lm_head = nn.Linear(128, 64, bias=False)


LINEAR_NAMES = [f"layers.{i}.{g}.{n}" for i in range(2)
                for g, ns in (("attn", ("q_proj", "k_proj", "v_proj", "o_proj")),
                              ("mlp", ("gate_proj", "up_proj", "down_proj"))) for n in ns]


def _get(model, dotted):
    for part in dotted.split("."):
        model = getattr(model, part)
    return model


def _carry(jlayer) -> GemLiteLinear:
    return params_from_jax_numpy({"l": jax.tree_util.tree_map(np.asarray, jlayer)},
                                 device="cpu")["l"]


def _assert_layers_equal(a: GemLiteLinear, b: GemLiteLinear):
    assert a.get_meta_args() == b.get_meta_args()
    sa, sb = a.state_dict(), b.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k


PROCESSORS = {
    "A16W8_INT8": (lambda: thelper.A16W8_INT8(device="cpu", dtype=torch.bfloat16),
                   lambda: jhelper.A16W8_INT8(dtype=jnp.bfloat16)),
    "A8W8_INT8_dynamic": (lambda: thelper.A8W8_INT8_dynamic(device="cpu", dtype=torch.bfloat16),
                          lambda: jhelper.A8W8_INT8_dynamic(dtype=jnp.bfloat16)),
    "A16W8_FP8": (lambda: thelper.A16W8_FP8(device="cpu", dtype=torch.bfloat16),
                  lambda: jhelper.A16W8_FP8(dtype=jnp.bfloat16)),
    "A8W8_FP8_dynamic": (lambda: thelper.A8W8_FP8_dynamic(device="cpu", dtype=torch.bfloat16),
                         lambda: jhelper.A8W8_FP8_dynamic(dtype=jnp.bfloat16)),
}
VS_FLOAT = {"A16W8_FP8": 5e-2, "A8W8_FP8_dynamic": 5e-2}     # else 2e-2


@pytest.mark.parametrize("name", sorted(PROCESSORS))
def test_patch_model_packs_jax_bytes(name):
    ours, theirs = Tiny(), Tiny()
    make_t, make_j = PROCESSORS[name]
    assert thelper.patch_model(ours, make_t()) is ours
    jhelper.patch_model(theirs, make_j())
    for dotted in LINEAR_NAMES:
        got = _get(ours, dotted)
        assert isinstance(got, GemLiteLinear), dotted
        assert dotted in dict(ours.named_modules())     # registered as a child
        _assert_layers_equal(got, _carry(_get(theirs, dotted)))
    assert isinstance(ours.lm_head, nn.Linear) and isinstance(ours.embed, nn.Embedding)
    x = torch.randn((8, 128), generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    ref = Tiny().layers[0].attn["o_proj"]
    got = ours.layers[0].attn["o_proj"](x).float()
    with torch.no_grad():
        want = ref(x.float())
    assert float((got - want).norm() / want.norm()) < VS_FLOAT.get(name, 2e-2)


def test_patch_model_skip_modules_and_device():
    model = Tiny()
    thelper.patch_model(model, PROCESSORS["A16W8_INT8"][0](), skip_modules=("mlp", "lm_head"),
                        device="cpu")
    for dotted in LINEAR_NAMES:
        kind = nn.Linear if ".mlp." in dotted else GemLiteLinear
        assert isinstance(_get(model, dotted), kind), dotted
    assert model.layers[1].attn["v_proj"].W_q.device.type == "cpu"


def test_patch_model_object_tree():
    """A plain object tree: attributes, lists and tuples of linears and of
    objects that hold linears; other values stay as they are."""
    torch.manual_seed(0)

    class Holder:
        def __init__(self):
            self.proj = nn.Linear(128, 64, bias=False)
            self.label = "holder"

    class Root:
        def __init__(self):
            self.first = nn.Linear(128, 128, bias=False)
            self.items = [nn.Linear(128, 64, bias=False), 3, Holder()]
            self.pair = (Holder(), nn.Linear(128, 32, bias=False))
            self.lm_head = nn.Linear(128, 16, bias=False)
            self.count = 2

    root = thelper.patch_model(Root(), PROCESSORS["A8W8_INT8_dynamic"][0]())
    assert isinstance(root.first, GemLiteLinear)
    assert isinstance(root.items, list) and isinstance(root.items[0], GemLiteLinear)
    assert root.items[1] == 3 and isinstance(root.items[2].proj, GemLiteLinear)
    assert root.items[2].label == "holder"
    assert isinstance(root.pair, tuple) and isinstance(root.pair[0].proj, GemLiteLinear)
    assert isinstance(root.pair[1], GemLiteLinear) and root.pair[1].out_features == 32
    assert isinstance(root.lm_head, nn.Linear) and root.count == 2


def test_patch_model_hqq_processor_needs_hqq():
    """A processor without from_linear (the grouped HQQ ones) goes through
    HQQLinear, which needs the hqq package."""
    model = Tiny()
    with pytest.raises(ImportError, match="hqq"):
        thelper.patch_model(model, thelper.A16W4_HQQ_INT(device="cpu"))
    assert isinstance(model.layers[0].attn["q_proj"], nn.Linear)


def test_from_linear_kernel_convention_and_cleanup():
    """from_linear drops the original's references unless del_orig=False."""
    proc = PROCESSORS["A16W8_INT8"][0]()
    lin = nn.Linear(128, 96, bias=True)
    a = proc.from_linear(lin, del_orig=False)
    assert lin.weight is not None and lin.bias is not None
    b = proc.from_linear(lin)
    _assert_layers_equal(a, b)
    assert lin.weight is None and lin.bias is None


@pytest.mark.parametrize("cls", ["A16W158_INT", "A8W158_INT_dynamic"])
def test_from_bitlinear(cls):
    rng = np.random.default_rng(0)

    class BitLinear:
        weight = torch.from_numpy(rng.integers(-1, 2, size=(64, 128)).astype(np.float32))
        weight_scale = 0.0123
        bias = None

    proc = getattr(thelper, cls)(device="cpu", dtype=torch.bfloat16)
    want = proc.from_weights(BitLinear.weight, BitLinear.weight_scale)
    bit = BitLinear()
    _assert_layers_equal(proc.from_bitlinear(bit), want)
    assert bit.weight is None and bit.weight_scale is None
    jl = getattr(jhelper, cls)(dtype=jnp.bfloat16).from_weights(
        BitLinear.weight.numpy(), BitLinear.weight_scale)
    _assert_layers_equal(want, _carry(jl))


WARMUP_PROCESSORS = {
    "A16W4_HQQ_INT": (lambda: thelper.A16W4_HQQ_INT(device="cpu", dtype=torch.bfloat16),
                      lambda: jhelper.A16W4_HQQ_INT(dtype=jnp.bfloat16)),
    "A8W4_HQQ_INT_dynamic": (lambda: thelper.A8W4_HQQ_INT_dynamic(device="cpu",
                                                                  dtype=torch.bfloat16),
                             lambda: jhelper.A8W4_HQQ_INT_dynamic(dtype=jnp.bfloat16)),
    **PROCESSORS,
}


@pytest.mark.parametrize("name", sorted(WARMUP_PROCESSORS))
def test_warmup_layers_and_buckets(name):
    """One layer a shape, the JAX _warmup_layer's layer for the same seeded
    draw, run once at each bucket up to 1024 (largest first) on its route."""
    make_t, make_j = WARMUP_PROCESSORS[name]
    shapes = [(256, 128), (64, 256)]
    dispatch.KERNEL_TRACE.clear()
    layers = thelper.warmup(make_t(), shapes, device="cpu")
    buckets = [b for b in thelper.DEFAULT_WARMUP_BATCHES if b <= 1024]
    assert buckets == sorted(buckets, reverse=True) and buckets[0] == 1024 and buckets[-1] == 1
    assert [(l.out_features, l.in_features) for l in layers] == shapes
    assert len(dispatch.KERNEL_TRACE) == len(shapes) * len(buckets)
    assert all(r.startswith("plain_") for r in dispatch.KERNEL_TRACE)
    w = (np.random.default_rng(0).normal(size=shapes[0]).astype(np.float32) * 0.02)
    _assert_layers_equal(layers[0], _carry(jhelper._warmup_layer(make_j(), w, 64)))


def test_warmup_needs_a_device_and_takes_batch_sizes():
    proc = thelper.A16W4_HQQ_INT(device="cpu", dtype=torch.bfloat16)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            thelper.warmup(proc, [(128, 128)])
    dispatch.KERNEL_TRACE.clear()
    thelper.warmup(proc, [(128, 128)], batch_sizes=[3, 65], device="cpu")
    assert dispatch.KERNEL_TRACE == ["plain_decode", "plain_prefill"]


def _w4_layer():
    w = torch.randn((256, 128), generator=torch.Generator().manual_seed(2)) * 0.02
    W_q, s, z = quantize_int_weights(w, 4, 64)
    return thelper.A16W4_HQQ_INT(device="cpu", dtype=torch.bfloat16).from_weights(W_q, s, z)


@pytest.mark.parametrize("family", GEMLITE_MATMUL_TYPES)
def test_forward_manual_equals_forward(family):
    """The family name sets no route in the port: M does, as in forward."""
    layer = _w4_layer()
    for M in (1, 8, 100):
        x = (torch.randn((M, 128), generator=torch.Generator().manual_seed(M)) * 0.5).to(
            torch.bfloat16)
        dispatch.KERNEL_TRACE.clear()
        got = layer.forward_manual(x, family)
        want = layer(x)
        assert torch.equal(got, want)
        assert dispatch.KERNEL_TRACE[0] == dispatch.KERNEL_TRACE[1]


def test_forward_manual_unknown_family():
    layer = _w4_layer()
    x = torch.zeros((2, 128), dtype=torch.bfloat16)
    with pytest.raises(KeyError):
        layer.forward_manual(x, "GEMM_SPLITK_FAST")
    with pytest.raises(IndexError):
        forward_functional(x, None, layer.get_tensor_args(), layer.meta, len(GEMLITE_MATMUL_TYPES))
    assert layer.meta.input_dtype == DType.BF16.value


@pytest.mark.parametrize("max_m", [4096, 1024, 512, 256])
def test_buckets_equal_jax(max_m):
    assert tbucket._bucket_values(max_m) == jbucket._bucket_values(max_m)
    assert tbucket._BUCKETS == jbucket._BUCKETS
    assert thelper.DEFAULT_WARMUP_BATCHES == jhelper.DEFAULT_WARMUP_BATCHES
