# SPDX-License-Identifier: Apache-2.0
"""The fp8 kernels against their plain versions, on the card.

Card-only: each test skips where no CUDA device is present. On the card:

    python -m pytest --noconftest -m requires_cuda tests/test_torch_fp8_kernels.py -q

Tolerance: max|a-b| / max|b| <= 5e-3 against the plain version's float32
result (``ops/reference.forward_fp8_ref``), the JAX kernel tests' bound; the
stacked decode entry equals the per-layer one bit for bit, and the
dequantize kernel equals ``dequantize_full`` bit for bit (one product and
one rounding a value in both). The 256-row prefill blocks with fp8 x are
held at ragged M on 14336x4096, on the plan forced to 256 rows where
``prefill_plan`` would take 128.
"""

import pytest
import torch

from gemlite_tpu_torch import DType
from gemlite_tpu_torch.helper import (A16W8_FP8, A8W4_HQQ_INT_dynamic, A8W8_FP8_dynamic,
                                      _warmup_quantize)
from gemlite_tpu_torch.ops import build, dispatch
from gemlite_tpu_torch.ops.dequantize import dequantize_full, dequantize_weights
from gemlite_tpu_torch.ops.fp8 import (_prefill, decode_plan, fp8_decode, fp8_decode_stacked,
                                       fp8_prefill, prefill_plan)
from gemlite_tpu_torch.ops.fused import fused_gemm_float, fused_matmul_plain
from gemlite_tpu_torch.ops.reference import forward_fp8_ref
from gemlite_tpu_torch.quant import scale_activations_per_token

pytestmark = pytest.mark.requires_cuda
REL = 5e-3
SHAPES_8B = [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336)]   # (N, K)
# the four weight forms: (processor, the x dtype the layer takes)
FORMS = {
    "a8w8_e4m3": lambda: A8W8_FP8_dynamic(device="cuda", dtype=torch.bfloat16),
    "a8w8_e5m2": lambda: A8W8_FP8_dynamic(device="cuda", dtype=torch.bfloat16,
                                          fp8=torch.float8_e5m2),
    "a16w8_e4m3": lambda: A16W8_FP8(device="cuda", dtype=torch.bfloat16),
    "a16w8_e5m2_post": lambda: A16W8_FP8(device="cuda", dtype=torch.bfloat16,
                                         fp8=torch.float8_e5m2, post_scale=True),
}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _layer(gen, form, N, K):
    w = torch.randn((N, K), generator=gen, device="cuda") * 0.02
    return FORMS[form]().from_weights(w)


def _inputs(gen, layer, M):
    """(x as the kernel takes it, per-token scales or None)."""
    x = (torch.randn((M, layer.in_features), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
    if layer.scaled_activations:
        from gemlite_tpu_torch.dtypes import to_torch_dtype
        return scale_activations_per_token(x, to_torch_dtype(layer.input_dtype))
    return x, None


def _plain(layer, x, sx):
    return forward_fp8_ref(x, layer.W_q, layer.scales, sx,
                           layer.meta._replace(output_dtype=DType.FP32.value))


def _rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("M", [1, 7, 8, 33, 64])
def test_fp8_decode_matches_plain(gen, form, M):
    layer = _layer(gen, form, 1024, 2048)
    x, sx = _inputs(gen, layer, M)
    out = fp8_decode(x, layer.W_q, layer.scales, sx, layer.meta)
    assert out.dtype == torch.bfloat16 and out.shape == (M, 1024)
    assert _rel(out, _plain(layer, x, sx)) <= REL


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("M", [65, 128, 200, 257, 1024])
def test_fp8_prefill_matches_plain(gen, form, M):
    layer = _layer(gen, form, 1024, 2048)
    x, sx = _inputs(gen, layer, M)
    out = fp8_prefill(x, layer.W_q, layer.scales, sx, layer.meta)
    assert _rel(out, _plain(layer, x, sx)) <= REL


@pytest.mark.parametrize("N,K", SHAPES_8B)
@pytest.mark.parametrize("form", ["a8w8_e4m3", "a16w8_e4m3"])
def test_fp8_kernels_8b_shapes(gen, form, N, K):
    """Decode at M 1 / 8 / 64 and prefill at M 128 / 1024 on the Llama-3-8B
    shapes; the relative error at K 4096 and 14336 is printed (the fp8 sums
    are moved into float32 every 128 of K)."""
    layer = _layer(gen, form, N, K)
    for M, fn in ((1, fp8_decode), (8, fp8_decode), (64, fp8_decode), (128, fp8_prefill),
                  (1024, fp8_prefill)):
        x, sx = _inputs(gen, layer, M)
        err = _rel(fn(x, layer.W_q, layer.scales, sx, layer.meta), _plain(layer, x, sx))
        print(f"fp8 {form} N {N} K {K} M {M}: max rel err {err:.3e}")
        assert err <= REL, (M, err)


@pytest.mark.parametrize("M", [1, 8, 64])
def test_fp8_stacked_equals_per_layer(gen, M):
    layers = [_layer(gen, "a16w8_e4m3", 1024, 4096) for _ in range(3)]
    W = torch.stack([l.W_q for l in layers])
    S = torch.stack([l.scales for l in layers])
    x, _ = _inputs(gen, layers[0], M)
    for i, lyr in enumerate(layers):
        idx = torch.tensor(i, dtype=torch.int32, device="cuda")
        stacked = fp8_decode_stacked(x, W, S, lyr.meta, idx)
        assert torch.equal(stacked, fp8_decode(x, lyr.W_q, lyr.scales, None, lyr.meta))


@pytest.mark.parametrize("M", [129, 256, 300, 1024, 2048, 4095])
@pytest.mark.parametrize("form", ["a8w8_e4m3", "a8w8_e5m2"])
def test_fp8_prefill_256_rows(gen, form, M):
    """fp8 x (e4m3 and e5m2 codes and x) on 256-row blocks at ragged M: rows
    past M read as zeros and are never written."""
    layer = _layer(gen, form, 14336, 4096)
    x, sx = _inputs(gen, layer, M)
    out = _prefill(x, layer.W_q, layer.scales, sx, layer.meta,
                   prefill_plan(M, 14336, 4096, 1, bm=256))
    assert out.shape == (M, 14336)
    assert _rel(out, _plain(layer, x, sx)) <= REL


@pytest.mark.parametrize("N,K", SHAPES_8B)
@pytest.mark.parametrize("form", ["a8w8_e4m3", "a16w8_e4m3"])
def test_fp8_prefill_swizzled_ring_8b_shapes(gen, form, N, K):
    """The word ring (fp8 x: four 32-column groups in the 128-byte swizzle,
    read on p_col's columns; bf16 x: rows of 128 words) at the 8B shapes, at
    M 256 and 2048 (M 128 and 1024 in test_fp8_kernels_8b_shapes), on the
    rows the plan picks."""
    layer = _layer(gen, form, N, K)
    for M in (256, 2048):
        x, sx = _inputs(gen, layer, M)
        err = _rel(fp8_prefill(x, layer.W_q, layer.scales, sx, layer.meta), _plain(layer, x, sx))
        assert err <= REL, (M, err)


@pytest.mark.parametrize("M", [1, 8, 64])
def test_fp8_stacked_equals_per_layer_8b(gen, M):
    """The stacked decode equals the per-layer decode bit for bit on the
    whole-wave plan of 14336x4096 (three splits)."""
    layers = [_layer(gen, "a16w8_e4m3", 14336, 4096) for _ in range(2)]
    assert decode_plan(M, 14336, 4096, 2).splits == 3
    W = torch.stack([l.W_q for l in layers])
    S = torch.stack([l.scales for l in layers])
    x, _ = _inputs(gen, layers[0], M)
    for i, lyr in enumerate(layers):
        idx = torch.tensor(i, dtype=torch.int32, device="cuda")
        stacked = fp8_decode_stacked(x, W, S, lyr.meta, idx)
        assert torch.equal(stacked, fp8_decode(x, lyr.W_q, lyr.scales, None, lyr.meta))


@pytest.mark.parametrize("form", ["a8w8_e4m3", "a16w8_e4m3"])
def test_fp8_prefill_one_launch_256_rows(gen, form):
    layer = _layer(gen, form, 14336, 4096)
    for M in (256, 2048):
        x, sx = _inputs(gen, layer, M)
        assert prefill_plan(M, 14336, 4096, 1 if sx is not None else 2).bm == 256
        assert build.graph_ops(lambda: fp8_prefill(x, layer.W_q, layer.scales, sx,
                                                   layer.meta)) == ["kernel"]


@pytest.mark.parametrize("form", ["a8w8_e4m3", "a16w8_e5m2_post", "a16w8_e4m3"])
def test_fp8_dequantize_equals_plain(gen, form):
    layer = _layer(gen, form, 1024, 2048)
    got = dequantize_weights(layer.W_q, layer.scales, layer.zeros, layer.meta)
    assert torch.equal(got, dequantize_full(layer.W_q, layer.scales, layer.zeros, layer.meta))


@pytest.mark.parametrize("M", [1, 8, 128, 300])
@pytest.mark.parametrize("fp8", [torch.float8_e4m3fn, torch.float8_e5m2])
def test_fused_float_fp8_x(gen, M, fp8):
    """Row 5f with fp8 x (A8W4 gs 64, mode 3, csm 2) against its plain version."""
    w = torch.randn((1024, 2048), generator=gen, device="cuda") * 0.02
    layer = _warmup_quantize(A8W4_HQQ_INT_dynamic(device="cuda", dtype=torch.bfloat16, fp8=fp8),
                             w, 64)
    xb = (torch.randn((M, 2048), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
    x, sx = scale_activations_per_token(xb, fp8)
    out = fused_gemm_float(x, layer.W_q, layer.scales, layer.zeros, sx, layer.meta)
    want = fused_matmul_plain(x, layer.W_q, layer.scales, layer.zeros, sx,
                              layer.meta._replace(output_dtype=DType.FP32.value))
    assert _rel(out, want) <= REL


def test_fp8_one_launch_a_call(gen):
    layer = _layer(gen, "a8w8_e4m3", 4096, 4096)
    for M, fn in ((8, fp8_decode), (128, fp8_prefill)):
        x, sx = _inputs(gen, layer, M)
        assert build.graph_ops(lambda: fn(x, layer.W_q, layer.scales, sx, layer.meta)) == ["kernel"]
    assert build.graph_ops(lambda: dequantize_weights(layer.W_q, layer.scales, None,
                                                      layer.meta)) == ["kernel"]


def test_fp8_layer_routes(gen):
    """An A8W8_FP8_dynamic layer runs decode, prefill and dequantize by M,
    within 5e-3 of its plain path."""
    layer = _layer(gen, "a8w8_e4m3", 4096, 4096)
    for M, route in ((1, "decode"), (64, "decode"), (65, "prefill"), (128, "prefill"),
                     (4096, "dequantize")):
        x = (torch.randn((M, 4096), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
        dispatch.KERNEL_TRACE.clear()
        out = layer(x)
        assert dispatch.KERNEL_TRACE == [route]
        xq, sx = scale_activations_per_token(x, torch.float8_e4m3fn)
        if route == "dequantize":            # the route's plain version: the folded bf16 weight
            w = dequantize_full(layer.W_q, layer.scales, None, layer.meta).float()
            want = (xq.float() @ w) * sx
        else:
            want = _plain(layer, xq, sx)
        assert _rel(out, want) <= REL, M


def test_patch_model_and_warmup_a8w8_fp8(gen):
    """patch_model with A8W8_FP8_dynamic over an 8B block's seven linear
    shapes: at M 8 each output on the fp8 decode kernel, at M 128 on the fp8
    prefill kernel, within 5e-2 (norm-relative) of the float nn.Linear (e4m3
    rounds x and w to 3 mantissa bits, about 3.6% rms on the product: the
    JAX package's tests hold its fp8 processors to 8e-2); warmup runs every
    bucket up to 1024 on those two kernels."""
    from torch import nn
    from gemlite_tpu_torch import patch_model, warmup
    shapes = [(4096, 4096), (1024, 4096), (1024, 4096), (4096, 4096), (14336, 4096),
              (14336, 4096), (4096, 14336)]
    model = nn.Sequential(*[nn.Linear(k, n, bias=False, device="cuda", dtype=torch.bfloat16)
                            for n, k in shapes])
    ref = [lin.weight.detach().clone() for lin in model]
    patch_model(model, A8W8_FP8_dynamic(device="cuda", dtype=torch.bfloat16), skip_modules=())
    for lin, w in zip(model, ref):
        for M, route in ((8, "decode"), (128, "prefill")):
            x = torch.randn((M, lin.in_features), generator=gen, device="cuda").to(torch.bfloat16)
            dispatch.KERNEL_TRACE.clear()
            got = lin(x).float()
            assert dispatch.KERNEL_TRACE == [route]
            want = x.float() @ w.float().t()
            assert float((got - want).norm() / want.norm()) < 5e-2
    dispatch.KERNEL_TRACE.clear()
    warmup(A8W8_FP8_dynamic(device="cuda", dtype=torch.bfloat16), [(4096, 4096)], device="cuda")
    assert set(dispatch.KERNEL_TRACE) == {"decode", "prefill"}
