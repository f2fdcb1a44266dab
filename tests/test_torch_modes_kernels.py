# SPDX-License-Identifier: Apache-2.0
"""The decode and prefill kernels' mode 1-3 form against its plain version,
on the card.

Card-only: each test skips where no CUDA device is present. On the card:

    python -m pytest --noconftest -m requires_cuda tests/test_torch_modes_kernels.py -q

Tolerance: max|a-b| / max|b| <= 5e-3 against the plain version's float32
result (``ops/reference.forward_f32_epilogue``: forward_meta's per-op bf16
dequantization and float32 dot, the channel scales in float32), the JAX
kernel tests' bound; against ``forward_meta`` itself, which rounds the sums
and the scales to bf16 before it multiplies, mean|a-b| / mean|b| <= 5e-3
(the form of chip_smoke.py's first-step check: a bf16 rounding of its own a
value). Forms: A8W4 / A8W2 / A8W1 (grouped mode 3, csm 2; channel-wise
mode 3 / csm 2 and mode 1 / csm 3; e4m3 and e5m2 x), channel-wise A16W4
(mode 3 / csm 0, mode 1 / csm 1), A16W158 (W2, mode 1, scalar zero, float32
channel scale), and packed by hand: mode 2 (scales, no zeros) and mode 3
with a scalar zero. Shapes: the 8B ones, ragged N (odd columns take the
2-byte metadata loads) and a K that ends inside a decode stage.

The decode form's TMA kernel (``gl_decode_modes``, ``csrc/decode_modes.cu``)
reads e4m3 x itself: equal bit for bit to the same call on its bf16 image, at
every form and M 1-64; N off 32 takes its four 2-d word boxes (W2 / W4); N
off 8 and W1 off 32 take the ragged route (``decode_modes_ragged``, counted
apart), also on the 32001 x 4096 vocabulary head; a captured replay equals
the eager call, and the split counters stay 0.

The stacked form (``ops/scan.decode_modes_stacked``, ``gl_decode_modes_stacked``)
over stacks of channel-wise A16W4 / A16W2 layers (mode 3 / csm 0, mode 1 /
csm 1, the channel scales bf16 or float32) and W4 mode 2: each layer equal to
the per-layer form on it bit for bit at M 1-64, one launch and no
allocation but the output, a captured replay equal to eager.
"""

import pytest
import torch

from gemlite_tpu_torch import DType, GemLiteLinear
from gemlite_tpu_torch.dtypes import to_torch_dtype
from gemlite_tpu_torch.helper import A16W158_INT, A16Wn, A8Wn_HQQ_INT_dynamic
from gemlite_tpu_torch.ops import build, dispatch
from gemlite_tpu_torch.ops.decode import decode_modes, decode_modes_ragged, modes_plan
from gemlite_tpu_torch.ops.dequantize import dequantize_full, dequantize_int
from gemlite_tpu_torch.ops.fused import fused_gemm_float
from gemlite_tpu_torch.ops.prefill import (modes_plan as prefill_modes_plan, prefill_modes,
                                            prefill_modes_ragged)
from gemlite_tpu_torch.ops.reference import forward_f32_epilogue, forward_meta
from gemlite_tpu_torch.ops.scan import (decode_matmul_stacked, decode_modes_ragged_stacked,
                                        decode_modes_stacked)
from gemlite_tpu_torch.quant import quantize_int_weights, scale_activations_per_token

pytestmark = pytest.mark.requires_cuda
REL = 5e-3
SHAPES_8B = [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336)]   # (N, K)
E4M3, E5M2 = torch.float8_e4m3fn, torch.float8_e5m2
# name -> (bits, gs (0: K), how the layer is packed)
FORMS = {
    "a8w4_gs64": (4, 64, "a8"), "a8w4_gs128_e5m2": (4, 128, "a8_e5m2"), "a8w2_gs64": (2, 64, "a8"),
    "a8w1_gs128": (1, 128, "a8"), "a8w4_cw": (4, 0, "a8"), "a8w4_cw_post": (4, 0, "a8_post"),
    "a16w4_cw": (4, 0, "a16"), "a16w4_cw_post": (4, 0, "a16_post"), "a16w158": (2, 0, "bitnet"),
    "w4_mode2_gs64": (4, 64, "mode2"), "w2_mode3_scalar_zero_gs128": (2, 128, "scalar_zero"),
}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _layer(gen, form, N, K):
    bits, gs, how = FORMS[form] if form in FORMS else STACK_FORMS[form]
    gs = gs or K
    if how == "bitnet":
        w = torch.randint(-1, 2, (N, K), generator=gen, device="cuda").float()
        return A16W158_INT(device="cuda", dtype=torch.bfloat16).from_weights(w, 0.01)
    w = torch.randn((N, K), generator=gen, device="cuda") * 0.02
    W_q, s, z = quantize_int_weights(w, bits, gs)
    if how.startswith("a8"):
        return A8Wn_HQQ_INT_dynamic(device="cuda", dtype=torch.bfloat16, W_nbits=bits,
                                    post_scale=how == "a8_post",
                                    fp8=E5M2 if how == "a8_e5m2" else E4M3).from_weights(W_q, s, z)
    if how.startswith("a16"):
        return A16Wn(device="cuda", dtype=torch.bfloat16, post_scale=how == "a16_post").from_weights(
            W_q, s, z, bits, gs)
    layer = GemLiteLinear(bits, gs, K, N, DType.BF16, DType.BF16, device="cuda")
    s = s.to(torch.bfloat16)
    W_q = W_q.to(torch.uint8)
    return layer.pack(W_q, s, None) if how == "mode2" else layer.pack(W_q, s, 2 ** (bits - 1))


def _inputs(gen, layer, M):
    """(x as the kernels take it: bf16, the bf16 image of fp8 codes for a
    scaled-activation layer; x as the plain versions take it; scales_x)."""
    x = (torch.randn((M, layer.in_features), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
    if not layer.scaled_activations:
        return x, x, None
    xq, sx = scale_activations_per_token(x, to_torch_dtype(layer.input_dtype))
    return xq.to(torch.bfloat16), xq, sx


def _rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def _mean_rel(a, b):
    return float((a.float() - b.float()).abs().mean() / b.float().abs().mean())


def _check(gen, form, M, N, K):
    layer = _layer(gen, form, N, K)
    meta = layer.meta
    assert meta.W_group_mode in (1, 2, 3)
    x, xp, sx = _inputs(gen, layer, M)
    args = (layer.W_q, layer.scales, layer.zeros, sx)
    out = (decode_modes if M <= 64 else prefill_modes)(x, *args, meta)
    f32 = meta._replace(output_dtype=DType.FP32.value)
    want = forward_f32_epilogue(xp, *args, f32)
    torch.cuda.synchronize()
    assert out.shape == (M, N) and out.dtype == torch.bfloat16
    assert _rel(out, want) <= REL, (form, M, N, K)
    assert _mean_rel(out, forward_meta(xp, *args, f32)) <= REL


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("M", [1, 7, 8, 33, 64, 65, 128, 300, 1024, 2048])
def test_modes_match_plain(gen, form, M):
    _check(gen, form, M, 1024, 2048)


@pytest.mark.parametrize("form", ["a8w4_gs64", "a8w4_cw_post", "a16w158"])
@pytest.mark.parametrize("M", [1, 8, 64, 128, 1024, 2048])
@pytest.mark.parametrize("N,K", SHAPES_8B)
def test_modes_8b_shapes(gen, form, M, N, K):
    _check(gen, form, M, N, K)


@pytest.mark.parametrize("form", ["a8w4_gs64", "a8w2_gs64", "a16w4_cw_post", "a16w158"])
@pytest.mark.parametrize("N", [129, 130, 200])
@pytest.mark.parametrize("M", [1, 33, 65, 129])
def test_modes_ragged_columns(gen, form, N, M):
    _check(gen, form, M, N, 1024)


@pytest.mark.parametrize("form", ["a8w4_gs64", "a16w158"])
@pytest.mark.parametrize("N", [129, 130, 200, 1024])
def test_prefill_modes_ragged_kernel_only_for_ragged_columns(gen, form, N):
    """N not a multiple of 8 takes prefill_gemm.cu's mode 1-3 instances
    (prefill_modes_ragged, counted apart), N 1024 the persistent kernel."""
    layer = _layer(gen, form, N, 1024)
    x, _, sx = _inputs(gen, layer, 300)
    before = (prefill_modes.launches, prefill_modes_ragged.launches)
    prefill_modes(x, layer.W_q, layer.scales, layer.zeros, sx, layer.meta)
    got = (prefill_modes.launches - before[0], prefill_modes_ragged.launches - before[1])
    assert got == ((0, 1) if N % 8 else (1, 0)), (form, N)


@pytest.mark.parametrize("form", ["a8w4_mode3", "w4_mode2"])
@pytest.mark.parametrize("M", [65, 128, 1024])
@pytest.mark.parametrize("gs,K", [(192, 1344), (192, 4032), (320, 3840)])
def test_persistent_prefill_groups_not_a_power_of_two(gen, form, M, gs, K):
    """The persistent kernel at group sizes of 64 times 3 and 5 (a step's
    group row by multiply-high), K an odd number of 64-deep steps at 1344 /
    4032: within the bound of forward_f32_epilogue, in its own launch."""
    N = 1024
    w = torch.randn((N, K), generator=gen, device="cuda") * 0.02
    W_q, s, z = quantize_int_weights(w, 4, gs)
    if form == "a8w4_mode3":
        layer = A8Wn_HQQ_INT_dynamic(device="cuda", dtype=torch.bfloat16, W_nbits=4).from_weights(
            W_q, s, z)
    else:
        layer = GemLiteLinear(4, gs, K, N, DType.BF16, DType.BF16, device="cuda").pack(
            W_q.to(torch.uint8), s.to(torch.bfloat16), None)
    meta = layer.meta
    assert meta.group_size == gs and meta.W_group_mode in (2, 3)
    x, xp, sx = _inputs(gen, layer, M)
    args = (layer.W_q, layer.scales, layer.zeros, sx)
    before = prefill_modes.launches
    out = prefill_modes(x, *args, meta)
    want = forward_f32_epilogue(xp, *args, meta._replace(output_dtype=DType.FP32.value))
    torch.cuda.synchronize()
    assert prefill_modes.launches == before + 1
    assert _rel(out, want) <= REL, (form, M, gs, K)


@pytest.mark.parametrize("form", ["a8w4_gs64", "a8w4_cw", "w4_mode2_gs64"])
@pytest.mark.parametrize("M", [1, 8, 64])
def test_decode_modes_k_ends_inside_a_stage(gen, form, M):
    """K 2112 = 16.5 stages of 128: the last stage is half past the end."""
    _check(gen, form, M, 512, 2112)


A8_FORMS = ("a8w4_gs64", "a8w4_gs128_e5m2", "a8w2_gs64", "a8w1_gs128", "a8w4_cw",
            "a8w4_cw_post")


# the 8B shapes, and K 2112 (16.5 stages) where the group divides it, else 2176
FP8_X_CASES = [(form, N, K) for form in A8_FORMS
               for N, K in ((14336, 4096), (4096, 14336),
                            (1024, 2176 if FORMS[form][1] == 128 else 2112))]


@pytest.mark.parametrize("form,N,K", FP8_X_CASES)
@pytest.mark.parametrize("M", [1, 8, 16, 33, 64])
def test_decode_modes_fp8_x_equals_its_bf16_image(gen, form, N, K, M):
    """The TMA kernel on the fp8 codes (e4m3 read in the kernel, e5m2 as its
    bf16 image) equals the same call on the codes' bf16 image bit for bit,
    in one launch of decode_modes, and is within the bound of the plain
    version."""
    layer = _layer(gen, form, N, K)
    meta = layer.meta
    x, xq, sx = _inputs(gen, layer, M)
    assert xq.dtype in (E4M3, E5M2)
    args = (layer.W_q, layer.scales, layer.zeros, sx)
    before = (decode_modes.launches, decode_modes_ragged.launches)
    got = decode_modes(xq, *args, meta)
    assert (decode_modes.launches - before[0], decode_modes_ragged.launches - before[1]) == (1, 0)
    want = decode_modes(x, *args, meta)
    plain = forward_f32_epilogue(xq, *args, meta._replace(output_dtype=DType.FP32.value))
    torch.cuda.synchronize()
    assert torch.equal(got, want), (form, M, N, K)
    assert _rel(got, plain) <= REL


@pytest.mark.parametrize("form,N", [("a8w4_gs64", 129), ("a8w4_gs64", 200), ("a8w4_gs64", 1000),
                                    ("a8w2_gs64", 1000), ("a8w1_gs128", 1000),
                                    ("a8w1_gs128", 1024), ("a16w158", 130), ("a16w158", 1000),
                                    ("a16w4_cw_post", 1024)])
@pytest.mark.parametrize("M", [1, 8, 64])
def test_decode_modes_ragged_kernel_only_where_tma_cannot_read(gen, form, N, M):
    """N off 8, and W1 codes with N off 32, take decode_gemv.cu's mode 1-3
    instances (decode_modes_ragged, counted apart); N 1000 at W2 / W4 the TMA
    kernel's four 2-d word boxes; each within the bound of the plain version."""
    layer = _layer(gen, form, N, 1024)
    meta = layer.meta
    x, xp, sx = _inputs(gen, layer, M)
    args = (layer.W_q, layer.scales, layer.zeros, sx)
    before = (decode_modes.launches, decode_modes_ragged.launches)
    out = decode_modes(x, *args, meta)
    got = (decode_modes.launches - before[0], decode_modes_ragged.launches - before[1])
    ragged = N % 8 or (meta.W_nbits == 1 and N % 32)
    assert got == ((0, 1) if ragged else (1, 0)), (form, N)
    want = forward_f32_epilogue(xp, *args, meta._replace(output_dtype=DType.FP32.value))
    torch.cuda.synchronize()
    assert _rel(out, want) <= REL, (form, N, M)


@pytest.mark.parametrize("form", ["a8w4_gs64", "a16w158"])
@pytest.mark.parametrize("M", [1, 8, 64])
def test_decode_modes_ragged_vocabulary_head(gen, form, M):
    """A 32001 x 4096 vocabulary head (N off 8) on the ragged route."""
    N, K = 32001, 4096
    layer = _layer(gen, form, N, K)
    x, xp, sx = _inputs(gen, layer, M)
    args = (layer.W_q, layer.scales, layer.zeros, sx)
    before = decode_modes_ragged.launches
    out = decode_modes(x, *args, layer.meta)
    want = forward_f32_epilogue(xp, *args, layer.meta._replace(output_dtype=DType.FP32.value))
    torch.cuda.synchronize()
    assert decode_modes_ragged.launches == before + 1
    assert _rel(out, want) <= REL


@pytest.mark.parametrize("form", ["a8w4_gs64", "a8w4_cw_post", "a16w158"])
def test_decode_modes_captured_replay_equals_eager(gen, form):
    """A CUDA graph of the TMA kernel's call, replayed on new x, equals the
    eager call on that x bit for bit; the split counters stay 0."""
    layer = _layer(gen, form, 14336, 4096)
    x, xq, sx = _inputs(gen, layer, 8)
    xin = xq.clone()
    args = (layer.W_q, layer.scales, layer.zeros)
    call = (lambda: decode_modes(xin, *args, sx, layer.meta))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        call()
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = call()
    _, xq2, _ = _inputs(gen, layer, 8)
    xin.copy_(xq2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, call())
    for key, (ints, _) in build._SPLIT_STATE.items():
        if key[0] == "decode_modes":
            assert int(ints.abs().sum()) == 0


@pytest.mark.parametrize("form,M,N,K", [
    ("a8w4_gs64", 8, 14336, 4096), ("a8w4_cw_post", 8, 4096, 14336), ("a16w158", 1, 4096, 4096),
    ("a8w4_gs64", 128, 14336, 4096), ("a8w2_gs64", 1024, 4096, 14336),
    ("a16w4_cw_post", 300, 1024, 4096)])
def test_modes_one_launch_a_call(gen, form, M, N, K):
    """One call: one kernel (no memset, no merge launch), no allocation but
    the output, two calls equal bit for bit, the split state left 0; a
    channel-wise decode splits K."""
    layer = _layer(gen, form, N, K)
    x, _, sx = _inputs(gen, layer, M)
    fn = decode_modes if M <= 64 else prefill_modes
    call = (lambda: fn(x, layer.W_q, layer.scales, layer.zeros, sx, layer.meta))
    want = call()
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    got = [call()]
    assert torch.cuda.memory_stats()["allocation.all.allocated"] - before == 1
    assert build.graph_ops(lambda: got.append(call())) == ["kernel"]
    assert all(torch.equal(g, want) for g in got)
    for owner in ("decode_gemv", "decode_modes", "prefill_gemm", "prefill_modes"):
        for key, (ints, _) in build._SPLIT_STATE.items():
            if key[0] == owner:
                assert int(ints.abs().sum()) == 0
    if M <= 64 and layer.meta.group_size == K:
        assert modes_plan(M, layer.meta).splits > 1


@pytest.mark.parametrize("form", ["a8w4_gs64", "a8w2_gs64", "a8w4_cw_post", "a16w4_cw",
                                  "a16w158"])
def test_modes_routes_on_the_card(gen, form):
    """Through the layer: decode at M 1 / 64, prefill at 65 / 4095, and from
    4096 the dequantize kernel's integer form and a dense matmul, as
    scheduled (row 5f never); each output within the bound of its route's
    plain version."""
    layer = _layer(gen, form, 1024, 2048)
    routes, counts = [], []
    for M, route in ((1, "decode"), (64, "decode"), (65, "prefill"), (4095, "prefill"),
                     (4096, "dequantize")):
        x = (torch.randn((M, 2048), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
        launches = (decode_modes, prefill_modes, dequantize_int, fused_gemm_float)
        before = tuple(f.launches for f in launches)
        dispatch.KERNEL_TRACE.clear()
        out = layer(x)
        torch.cuda.synchronize()
        routes.append(dispatch.KERNEL_TRACE[-1])
        counts.append(tuple(f.launches - b for f, b in zip(launches, before)))
        xp, sx = x, None
        if layer.scaled_activations:
            xp, sx = scale_activations_per_token(x, to_torch_dtype(layer.input_dtype))
        want = forward_f32_epilogue(xp, layer.W_q, layer.scales, layer.zeros, sx,
                                    layer.meta._replace(output_dtype=DType.FP32.value))
        assert _rel(out, want) <= REL, (form, M)
    assert routes == ["decode", "decode", "prefill", "prefill", "dequantize"]
    assert counts == [(1, 0, 0, 0), (1, 0, 0, 0), (0, 1, 0, 0), (0, 1, 0, 0), (0, 0, 1, 0)]


PERSISTENT_FORMS = ("a8w4_gs64", "a8w2_gs64", "a8w1_gs128", "a8w4_cw_post", "a16w4_cw",
                    "a16w158", "w4_mode2_gs64", "w2_mode3_scalar_zero_gs128")


@pytest.mark.parametrize("form", PERSISTENT_FORMS)
@pytest.mark.parametrize("M,N,K", [(128, 14336, 4096), (1024, 14336, 4096), (2048, 14336, 4096),
                                   (128, 4096, 14336), (1024, 4096, 14336), (300, 1024, 4096),
                                   (65, 768, 256), (4095, 256, 768)])
def test_persistent_prefill_stages(gen, form, M, N, K):
    """The persistent kernel (gl_prefill_modes_persistent) on whole tiles and
    K-split tail waves, at 128 and 256 rows a tile: within the bound of
    forward_f32_epilogue, its split counters left 0."""
    layer = _layer(gen, form, N, K)
    meta = layer.meta
    x, xp, sx = _inputs(gen, layer, M)
    args = (layer.W_q, layer.scales, layer.zeros, sx)
    p = prefill_modes_plan(M, N, K, meta.group_size, meta.W_nbits)
    out = prefill_modes(x, *args, meta)
    want = forward_f32_epilogue(xp, *args, meta._replace(output_dtype=DType.FP32.value))
    torch.cuda.synchronize()
    assert _rel(out, want) <= REL, (form, M, N, K, p)
    for key, (ints, _) in build._SPLIT_STATE.items():
        if key[0] == "prefill_modes":
            assert int(ints.abs().sum()) == 0


DEQUANT_FORMS = ("a8w4_gs64", "a8w2_gs64", "a8w1_gs128", "a8w4_cw_post", "a16w4_cw",
                 "a16w4_cw_post", "a16w158", "w4_mode2_gs64", "w2_mode3_scalar_zero_gs128",
                 "w4_gs128_mode4", "w2_gs64_mode4", "w8_gs128_mode4", "w4_gs128_mode3_f32")


def _dequant_layer(gen, form, N, K):
    if form in FORMS:
        return _layer(gen, form, N, K)
    bits, gs = {"w4_gs128_mode4": (4, 128), "w2_gs64_mode4": (2, 64), "w8_gs128_mode4": (8, 128),
                "w4_gs128_mode3_f32": (4, 128)}[form]
    W_q = torch.randint(0, 2 ** bits, (N, K), generator=gen, device="cuda", dtype=torch.uint8)
    G = N * K // gs
    dt = torch.float32 if form.endswith("f32") else torch.bfloat16
    s = (torch.rand((G, 1), generator=gen, device="cuda") * 2e-3 + 1e-3).to(dt)
    z = (torch.randint(0, 2 ** bits, (G, 1), generator=gen, device="cuda") + 0.3).to(dt)
    return GemLiteLinear(bits, gs, K, N, DType.BF16, DType.BF16, device="cuda").pack(
        W_q, s, z, fma_mode=form.find("mode4") > 0)


@pytest.mark.parametrize("form", DEQUANT_FORMS)
@pytest.mark.parametrize("N,K", [(14336, 4096), (4096, 14336), (768, 256), (1024, 2048)])
def test_dequantize_int_bit_equal(gen, form, N, K):
    """The dequantize kernel's integer form (gl_dequantize_int) equals
    dequantize_full bit for bit, in one launch a call, also on layers the
    router keeps off it (channel-wise at K 256: the JAX package does not
    fold them)."""
    layer = _dequant_layer(gen, form, N, K)
    args = (layer.W_q, layer.scales, layer.zeros, layer.meta)
    before = dequantize_int.launches
    got = dequantize_int(*args)
    assert dequantize_int.launches == before + 1
    assert torch.equal(got, dequantize_full(*args)), (form, N, K)
    assert build.graph_ops(lambda: dequantize_int(*args)) == ["kernel"]


STACK_FORMS = {"a16w4_cw": (4, 0, "a16"), "a16w4_cw_post": (4, 0, "a16_post"),
               "a16w2_cw_post": (2, 0, "a16_post"), "w4_mode2_gs64": (4, 64, "mode2")}


def _stack(gen, form, N, K, L, f32_cs=False):
    """L layers of one form (FORMS' packing), stacked as models/scan_llama
    stacks them: (stacked W_q, scales, zeros, meta, layers)."""
    layers = [_layer(gen, form, N, K) for _ in range(L)]
    if f32_cs:
        for lyr in layers:
            lyr.scales = lyr.scales.float()
    st = [None if getattr(layers[0], a) is None else torch.stack([getattr(l, a) for l in layers])
          for a in ("W_q", "scales", "zeros")]
    return (*st, layers[0].meta, layers)


@pytest.mark.parametrize("form,f32_cs", [("a16w4_cw", False), ("a16w4_cw_post", False),
                                         ("a16w4_cw_post", True), ("a16w2_cw_post", False),
                                         ("w4_mode2_gs64", False)])
@pytest.mark.parametrize("M", [1, 8, 16, 33, 64])
@pytest.mark.parametrize("N,K", [(14336, 4096), (4096, 14336), (1024, 2048)])
def test_stacked_modes_equal_per_layer(gen, form, f32_cs, M, N, K):
    L = 4
    W_q, scales, zeros, meta, layers = _stack(gen, form, N, K, L, f32_cs)
    x = (torch.randn((M, K), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
    for l in (0, 2, L - 1):
        idx = torch.tensor([l], dtype=torch.int32, device="cuda")
        got = decode_matmul_stacked(x, W_q, scales, zeros, meta, idx)
        lyr = layers[l]
        want = decode_modes(x, lyr.W_q, lyr.scales, lyr.zeros, None, lyr.meta)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (form, M, N, K, l)
        plain = forward_f32_epilogue(x, lyr.W_q, lyr.scales, lyr.zeros, None,
                                     meta._replace(output_dtype=DType.FP32.value))
        assert _rel(got, plain) <= REL


@pytest.mark.parametrize("form", ["a16w4_cw_post", "w4_mode2_gs64"])
@pytest.mark.parametrize("N", [1001, 1004])
def test_stacked_modes_ragged_counted_apart(gen, form, N):
    """Where TMA cannot read the stacks (N off 8) the stacked entry runs
    gl_decode_modes_ragged_stacked, counted on decode_modes_ragged_stacked
    alone, and layer l equals the per-layer ragged route on it bit for bit."""
    L, M, K = 3, 8, 2048
    W_q, scales, zeros, meta, layers = _stack(gen, form, N, K, L)
    x = (torch.randn((M, K), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
    idx = torch.tensor([1], dtype=torch.int32, device="cuda")
    counters = (decode_modes_stacked, decode_modes_ragged_stacked, decode_modes_ragged)
    before = [c.launches for c in counters]
    got = decode_matmul_stacked(x, W_q, scales, zeros, meta, idx)
    assert [c.launches - b for c, b in zip(counters, before)] == [0, 1, 0]
    lyr = layers[1]
    want = decode_modes(x, lyr.W_q, lyr.scales, lyr.zeros, None, lyr.meta)
    torch.cuda.synchronize()
    assert decode_modes_ragged.launches == before[2] + 1
    assert torch.equal(got, want), (form, N)


def test_stacked_modes_one_launch_and_replay(gen):
    """One kernel a call, no allocation but the output, the split state
    left 0, the launch counted on decode_modes_stacked, and a CUDA graph's
    replay at another layer index equal to the eager call there."""
    W_q, scales, zeros, meta, layers = _stack(gen, "a16w4_cw_post", 14336, 4096, 8)
    x = (torch.randn((8, 4096), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
    idx = torch.tensor([3], dtype=torch.int32, device="cuda")
    call = (lambda: decode_matmul_stacked(x, W_q, scales, zeros, meta, idx))
    want = call()
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    n0 = decode_modes_stacked.launches
    got = [call()]
    assert torch.cuda.memory_stats()["allocation.all.allocated"] - before == 1
    assert decode_modes_stacked.launches == n0 + 1
    assert build.graph_ops(lambda: got.append(call())) == ["kernel"]
    assert all(torch.equal(g, want) for g in got)
    for key, (ints, _) in build._SPLIT_STATE.items():
        if key[0] in ("decode_gemv", "decode_modes"):
            assert int(ints.abs().sum()) == 0
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        call()
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = call()
    idx.fill_(6)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, call())
    lyr = layers[6]
    assert torch.equal(out, decode_modes(x, lyr.W_q, lyr.scales, lyr.zeros, None, lyr.meta))
