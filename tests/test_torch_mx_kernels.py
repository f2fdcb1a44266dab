# SPDX-License-Identifier: Apache-2.0
"""The MX kernels against their plain versions, on the card.

Card-only: each test skips where no CUDA device is present. On the card:

    python -m pytest --noconftest -m requires_cuda tests/test_torch_mx_kernels.py -q

Tolerance: max|a-b| / max|b| <= 5e-3 against the plain version's float32
result (``ops/reference.mx_forward_ref``), the JAX kernel tests' bound; the
stacked decode entry equals the per-layer one bit for bit, the dequantize
kernel equals ``dequantize_full`` bit for bit (one product and one rounding
a value in both), and the csm-4 form equals the bf16 form fed
``fake_quant_activations(x)`` bit for bit. The prefill kernel's decoded
weights (e8m0 scales applied as one bf16x2 multiply) are probed with one-hot
rows of x over scales that sweep every exponent 0-254: its output equals
``dequantize_full``'s bf16 weights bit for bit. The 256-row blocks (M above
128) are held at ragged M. The general entry (fp4 layers off
the JAX fold rule: K and N not multiples of 128) is held to the same 5e-3
at SmolLM2-360M's shapes, gpt-oss-20b's 2880 and ragged ones, on both of
its bodies (``ops/mx.general_plan``: the ragged decode body at M <= 64 with
e8m0 scales, the ragged prefill body above and for NVFP4), across the switch
at M 64 / 65, with K split, and replayed from a CUDA graph bit for bit as
its eager call.

The decode entries (``gl_mx_decode`` / ``gl_mx_decode_stacked``: a TMA
weight stream into an mbarrier ring, on ``ops/mx.decode_plan``'s whole-wave
grid) are held at every form, M 1 / 8 / 16 / 33 / 64, the 8B shapes and a K
whose last split is shorter than the others, against ``mx_forward_ref``; the
stacked entry equals the per-layer one bit for bit on each of those; a call
is one kernel with no allocation but the output and leaves the split state
0; a CUDA graph's replay (at another layer index, for the stacked entry)
equals the eager call.
"""

import pytest
import torch

from gemlite_tpu_torch import DType
from gemlite_tpu_torch.mx import (A16W4_MXFP, A16W8_MXFP, A4W4_MXFP_dynamic, A4W4_NVFP_dynamic,
                                  A8W4_MXFP_dynamic, A8W8_MXFP_dynamic)
from gemlite_tpu_torch.ops import build, dispatch
from gemlite_tpu_torch.ops.dequantize import dequantize_full, dequantize_weights
from gemlite_tpu_torch.ops.mx import (decode_plan, general_plan, mx_decode, mx_decode_stacked,
                                     mx_general, mx_prefill, mx_prefill_csm4, prefill_plan,
                                     w_kind)
from gemlite_tpu_torch.ops.reference import fake_quant_activations, mx_forward_ref
from gemlite_tpu_torch.quant import scale_activations_mx, scale_activations_per_token

pytestmark = pytest.mark.requires_cuda
REL = 5e-3
SHAPES_8B = [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336)]   # (N, K)
FORMS = {
    "a16w4_mxfp": lambda: A16W4_MXFP(device="cuda"),
    "a16w8_mxfp_e4m3": lambda: A16W8_MXFP(device="cuda"),
    "a16w8_mxfp_e5m2": lambda: A16W8_MXFP(device="cuda", fp8=torch.float8_e5m2),
    "a8w8_mxfp": lambda: A8W8_MXFP_dynamic(device="cuda"),
    "a8w4_mxfp": lambda: A8W4_MXFP_dynamic(device="cuda"),
    "a4w4_mxfp": lambda: A4W4_MXFP_dynamic(device="cuda"),
    "a4w4_nvfp": lambda: A4W4_NVFP_dynamic(device="cuda"),
}
DECODE_FORMS = ["a16w4_mxfp", "a16w8_mxfp_e4m3", "a16w8_mxfp_e5m2", "a8w8_mxfp", "a8w4_mxfp"]


class _Lin:
    def __init__(self, w):
        self.weight, self.bias = w, None


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _layer(gen, form, N, K):
    w = torch.randn((N, K), generator=gen, device="cuda") * 0.02
    return FORMS[form]().from_linear(_Lin(w), del_orig=False)


def _inputs(gen, layer, M):
    """(x as the decode / prefill kernels take it, per-token scales or None,
    the kernel's meta): e4m3 per token for csm 2, fake-quantized bf16 for csm 4."""
    x = (torch.randn((M, layer.in_features), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
    meta = layer.meta
    if meta.channel_scale_mode == 2:
        xq, sx = scale_activations_per_token(x, torch.float8_e4m3fn)
        return xq, sx, meta
    if meta.channel_scale_mode == 4:
        return fake_quant_activations(x, meta.input_dtype), None, meta._replace(channel_scale_mode=0)
    return x, None, meta


def _plain(layer, x, sx, meta):
    return mx_forward_ref(x, layer.W_q, layer.scales, None, sx,
                          meta._replace(output_dtype=DType.FP32.value))


def _rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


@pytest.mark.parametrize("form", DECODE_FORMS + ["a4w4_mxfp"])
@pytest.mark.parametrize("M", [1, 7, 8, 9, 33, 64])
def test_mx_decode_matches_plain(gen, form, M):
    layer = _layer(gen, form, 1024, 2048)
    x, sx, meta = _inputs(gen, layer, M)
    out = mx_decode(x, layer.W_q, layer.scales, sx, meta)
    assert out.dtype == torch.bfloat16 and out.shape == (M, 1024)
    assert _rel(out, _plain(layer, x, sx, meta)) <= REL


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("M", [1, 8, 65, 128, 200, 257, 1024])
def test_mx_prefill_matches_plain(gen, form, M):
    layer = _layer(gen, form, 1024, 2048)
    x, sx, meta = _inputs(gen, layer, M)
    out = mx_prefill(x, layer.W_q, layer.scales, sx, meta)
    assert out.dtype == torch.bfloat16 and out.shape == (M, 1024)
    assert _rel(out, _plain(layer, x, sx, meta)) <= REL


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("M", [129, 255, 257, 383, 1000, 2047, 4095])
def test_mx_prefill_256_rows_ragged_m(gen, form, M):
    """The 256-row instances (bf16 x, per-token e4m3 codes, every weight
    kind, NVFP4) at M that end inside a block, against the plain version."""
    layer = _layer(gen, form, 1024, 2048)
    x, sx, meta = _inputs(gen, layer, M)
    assert prefill_plan(M, 1024, 2048, w_kind(meta), x.dtype == torch.float8_e4m3fn).bm == 256
    out = mx_prefill(x, layer.W_q, layer.scales, sx, meta)
    assert _rel(out, _plain(layer, x, sx, meta)) <= REL


# value of each fp4 code (bit 3 the sign), and each kind's code of 1.0
FP4_VALUES = [0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0]
FP4_VALUES = FP4_VALUES + [-v for v in FP4_VALUES]
ONE = {"a16w4_mxfp": 2, "a16w8_mxfp_e4m3": 0x38, "a16w8_mxfp_e5m2": 0x3C}


def _probe_weights(form, K, N, seed):
    """(W_q, scales) of a (K, N) layer: random finite codes and e8m0 scales
    (K / 32, N) sweeping exponents 0-254 across the groups, each code whose
    value times its scale would pass bf16's largest finite value replaced by
    the code of 1.0 (a one-hot product with an infinite weight is NaN)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    fp4 = form == "a16w4_mxfp"
    codes = rng.integers(0, 16 if fp4 else 256, size=(K, N))
    if fp4:
        values = np.array(FP4_VALUES)[codes]
    else:
        fp8 = torch.float8_e4m3fn if form == "a16w8_mxfp_e4m3" else torch.float8_e5m2
        values = torch.from_numpy(codes.astype(np.uint8)).view(fp8).float().numpy()
    exps = (np.arange(K // 32 * N) % 255).reshape(K // 32, N)
    bound = np.ldexp(1.0, 255 - np.repeat(exps, 32, axis=0))     # |v| 2^(e - 127) < 2^128
    bad = ~np.isfinite(values) | (np.abs(values) >= bound)
    codes = np.where(bad, ONE[form], codes)
    bits, epw = (4, 8) if fp4 else (8, 4)
    words = np.zeros((K // epw, N), np.uint64)
    for e in range(epw):
        words |= codes[e::epw].astype(np.uint64) << np.uint64(bits * e)
    W_q = torch.from_numpy(words.astype(np.uint32).view(np.int32)).cuda()
    return W_q, torch.from_numpy(exps.astype(np.uint8)).cuda()


@pytest.mark.parametrize("form", ["a16w4_mxfp", "a16w8_mxfp_e4m3", "a16w8_mxfp_e5m2"])
@pytest.mark.parametrize("M", [128, 256])
def test_mx_prefill_one_hot_decodes_dequantize_full(gen, form, M):
    """x = the identity (M = K rows of one-hot vectors), so out = the decoded
    weights, bf16 after float32 sums of one product and zeros: bit for bit
    ``dequantize_full``'s, at every e8m0 exponent 0-254 (the subnormal edge
    included), on the 128-row and the 256-row instance."""
    K, N = M, 256
    layer = _layer(gen, form, N, K)
    W_q, scales = _probe_weights(form, K, N, seed=M)
    assert W_q.shape == layer.W_q.shape and scales.shape == layer.scales.shape
    x = torch.eye(M, K, device="cuda", dtype=torch.bfloat16)
    assert prefill_plan(M, N, K, w_kind(layer.meta)).bm == M
    out = mx_prefill(x, W_q, scales, None, layer.meta)
    want = dequantize_full(W_q, scales, None, layer.meta)
    assert want.dtype == torch.bfloat16 and tuple(want.shape) == (K, N)
    assert bool(want.float().abs().isfinite().all())
    bad = (out != want).nonzero()
    assert bad.numel() == 0, (f"{bad.shape[0]} weights differ, first at (k, n) "
                              f"{bad[0].tolist()}: {out[tuple(bad[0])]} != {want[tuple(bad[0])]}, "
                              f"exponent {int(scales[bad[0, 0] // 32, bad[0, 1]])}")


@pytest.mark.parametrize("form", ["a4w4_mxfp", "a4w4_nvfp"])
@pytest.mark.parametrize("N", [384, 640])
@pytest.mark.parametrize("M", [65, 300])
def test_csm4_form_odd_column_tiles(gen, form, N, M):
    """An odd number of column tiles: the code form runs unclustered (each
    block converts all its rows), still bit for bit the fake-quant-fed form."""
    layer = _layer(gen, form, N, 1024)
    x = (torch.randn((M, 1024), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
    codes, scales = scale_activations_mx(x, layer.input_dtype)
    got = mx_prefill_csm4(codes, scales, layer.W_q, layer.scales, layer.meta)
    fq = fake_quant_activations(x, layer.input_dtype)
    want = mx_prefill(fq, layer.W_q, layer.scales, None, layer.meta._replace(channel_scale_mode=0))
    assert torch.equal(got, want)


@pytest.mark.parametrize("form", ["a4w4_mxfp", "a4w4_nvfp"])
@pytest.mark.parametrize("M", [65, 128, 129, 256, 300, 1024, 2048])
def test_csm4_form_equals_fake_quant_fed_form(gen, form, M):
    layer = _layer(gen, form, 1024, 2048)
    x = (torch.randn((M, 2048), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
    codes, scales = scale_activations_mx(x, layer.input_dtype)
    got = mx_prefill_csm4(codes, scales, layer.W_q, layer.scales, layer.meta)
    fq = fake_quant_activations(x, layer.input_dtype)
    want = mx_prefill(fq, layer.W_q, layer.scales, None, layer.meta._replace(channel_scale_mode=0))
    assert torch.equal(got, want)


@pytest.mark.parametrize("N,K", SHAPES_8B)
@pytest.mark.parametrize("form", ["a16w4_mxfp", "a8w8_mxfp", "a4w4_nvfp"])
def test_mx_kernels_8b_shapes(gen, form, N, K):
    layer = _layer(gen, form, N, K)
    for M in (1, 8, 64, 128, 1024):
        x, sx, meta = _inputs(gen, layer, M)
        kern = mx_decode if M <= 64 and form != "a4w4_nvfp" else mx_prefill
        assert _rel(kern(x, layer.W_q, layer.scales, sx, meta), _plain(layer, x, sx, meta)) <= REL


@pytest.mark.parametrize("form", ["a16w4_mxfp", "a16w8_mxfp_e4m3"])
@pytest.mark.parametrize("M", [1, 8, 64])
def test_mx_stacked_equals_per_layer(gen, form, M):
    layers = [_layer(gen, form, 1024, 4096) for _ in range(3)]
    W = torch.stack([lyr.W_q for lyr in layers])
    S = torch.stack([lyr.scales for lyr in layers])
    x, _, meta = _inputs(gen, layers[0], M)
    for li, lyr in enumerate(layers):
        idx = torch.tensor(li, dtype=torch.int32, device="cuda")
        got = mx_decode_stacked(x, W, S, meta, idx)
        assert torch.equal(got, mx_decode(x, lyr.W_q, lyr.scales, None, meta))


@pytest.mark.parametrize("form", ["a16w4_mxfp", "a16w8_mxfp_e4m3", "a16w8_mxfp_e5m2", "a4w4_nvfp"])
def test_mx_dequantize_equals_plain(gen, form):
    layer = _layer(gen, form, 1024, 2048)
    args = (layer.W_q, layer.scales, None, layer.meta)
    assert torch.equal(dequantize_weights(*args), dequantize_full(*args))


def test_mx_one_launch_a_call(gen):
    for form in ("a16w4_mxfp", "a4w4_nvfp"):
        layer = _layer(gen, form, 4096, 4096)
        meta = layer.meta._replace(channel_scale_mode=0)
        x8 = (torch.randn((8, 4096), generator=gen, device="cuda")).to(torch.bfloat16)
        x128 = (torch.randn((128, 4096), generator=gen, device="cuda")).to(torch.bfloat16)
        calls = [lambda: mx_prefill(x128, layer.W_q, layer.scales, None, meta),
                 lambda: dequantize_weights(layer.W_q, layer.scales, None, meta)]
        if form == "a16w4_mxfp":
            calls.append(lambda: mx_decode(x8, layer.W_q, layer.scales, None, meta))
        else:
            codes, s = scale_activations_mx(x128, layer.input_dtype)
            calls.append(lambda: mx_prefill_csm4(codes, s, layer.W_q, layer.scales, layer.meta))
        for fn in calls:
            assert build.graph_ops(fn) == ["kernel"]


ROUTES = {"a16w4_mxfp": ["decode", "decode", "decode", "prefill", "prefill", "dequantize"],
          "a16w8_mxfp_e4m3": ["decode", "decode", "decode", "prefill", "prefill", "dequantize"],
          "a8w8_mxfp": ["decode", "decode", "decode", "prefill", "prefill", "dequantize"],
          "a8w4_mxfp": ["decode", "decode", "decode", "prefill", "prefill", "dequantize"],
          "a4w4_mxfp": ["decode", "decode", "decode", "prefill_mx_csm4", "prefill_mx_csm4",
                        "dequantize"],
          "a4w4_nvfp": ["prefill", "prefill", "prefill", "prefill_mx_csm4", "prefill_mx_csm4",
                        "dequantize"]}


@pytest.mark.parametrize("form", sorted(ROUTES))
def test_mx_layer_routes(gen, form):
    """Each MX processor's layer at M 1 / 8 / 64 / 65 / 128 / 4096 runs the
    JAX package's routes, each within 5e-3 of its plain version."""
    layer = _layer(gen, form, 4096, 4096)
    got = []
    for M in (1, 8, 64, 65, 128, 4096):
        x = (torch.randn((M, 4096), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
        dispatch.KERNEL_TRACE.clear()
        out = layer(x)
        got += dispatch.KERNEL_TRACE
        want = _layer_plain(layer, x)
        assert _rel(out, want) <= REL, (form, M)
    assert got == ROUTES[form]


def _layer_plain(layer, x):
    """The layer's plain path at x's M: x quantized as the forward does, then
    the float32 product with the plain weight (the bf16-rounded weight at M
    4096, where the route dequantizes)."""
    meta = layer.meta
    sx = None
    if meta.channel_scale_mode == 2:
        x, sx = scale_activations_per_token(x, torch.float8_e4m3fn)
    elif meta.channel_scale_mode == 4:
        x = fake_quant_activations(x, meta.input_dtype)
        meta = meta._replace(channel_scale_mode=0)
    if x.shape[0] >= 4096:
        w = dequantize_full(layer.W_q, layer.scales, None, meta).float()
        out = x.float() @ w
        return out * sx if sx is not None else out
    return _plain(layer, x, sx, meta)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_card_quantizes_the_cpu_bytes(gen, form):
    w = torch.randn((1024, 2048), generator=gen, device="cuda") * 0.02
    w[0, :32] = 6.0 * 2.0 ** -7 * (1 + 2.0 ** -23)       # an amax one ulp above 6 * 2^k
    a = FORMS[form]().from_linear(_Lin(w), del_orig=False)
    proc = FORMS[form]()
    proc.device = torch.device("cpu")
    b = proc.from_linear(_Lin(w.cpu()), del_orig=False)
    assert a.get_meta_args() == b.get_meta_args()
    assert torch.equal(a.W_q.cpu(), b.W_q)
    assert torch.equal(a.scales.cpu().view(torch.uint8), b.scales.view(torch.uint8))


def test_patch_model_and_warmup_mx(gen):
    """patch_model with A16W4_MXFP and A4W4_NVFP_dynamic over an 8B block's
    linear shapes: each output on the expected route within 2e-1
    (norm-relative) of the float nn.Linear (fp4 keeps one mantissa bit: the
    JAX package's NVFP4 end-to-end test holds it to 2e-1); warmup runs every
    bucket up to 1024 on the MX routes."""
    from torch import nn
    from gemlite_tpu_torch import patch_model, warmup
    shapes = [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336)]
    for proc, routes in ((A16W4_MXFP(device="cuda"), {8: "decode", 128: "prefill"}),
                         (A4W4_NVFP_dynamic(device="cuda"), {8: "prefill", 128: "prefill_mx_csm4"})):
        model = nn.Sequential(*[nn.Linear(k, n, bias=False, device="cuda", dtype=torch.bfloat16)
                                for n, k in shapes])
        ref = [lin.weight.detach().clone() for lin in model]
        patch_model(model, proc, skip_modules=())
        for lin, w in zip(model, ref):
            for M, route in routes.items():
                x = torch.randn((M, lin.in_features), generator=gen, device="cuda").to(torch.bfloat16)
                dispatch.KERNEL_TRACE.clear()
                got = lin(x).float()
                assert dispatch.KERNEL_TRACE == [route]
                want = x.float() @ w.float().t()
                assert float((got - want).norm() / want.norm()) < 2e-1
        dispatch.KERNEL_TRACE.clear()
        warmup(proc, [(4096, 4096)], device="cuda")
        assert set(dispatch.KERNEL_TRACE) == set(routes.values())


GENERAL_FORMS = ["a16w4_mxfp", "a8w4_mxfp", "a4w4_mxfp", "a4w4_nvfp"]
# (N, K): SmolLM2-360M's block linears, gpt-oss-20b's hidden width, and ragged
# shapes: N 1000 ends inside a 128-column tile on 16-byte word rows, N 37 off
# them (the bodies copy by thread there), and K 224 ends inside a stage
GENERAL_SHAPES = [(960, 960), (320, 960), (2560, 960), (960, 2560), (2880, 2880), (1000, 1024),
                  (37, 224)]


@pytest.mark.parametrize("form", GENERAL_FORMS)
@pytest.mark.parametrize("N,K", GENERAL_SHAPES)
@pytest.mark.parametrize("M", [1, 8, 40, 64, 128, 1024, 4095])
def test_mx_general_matches_plain(gen, form, N, K, M):
    layer = _layer(gen, form, N, K)
    x, sx, meta = _inputs(gen, layer, M)
    out = mx_general(x, layer.W_q, layer.scales, sx, meta)
    assert out.dtype == torch.bfloat16 and out.shape == (M, N)
    assert _rel(out, _plain(layer, x, sx, meta)) <= REL


def test_mx_general_one_launch_a_call_and_routes(gen):
    """One kernel a call; an unfolded fp4 layer routes general_fused below M
    4096 and dense_fallback from it; an unfolded fp8-coded layer raises."""
    layer = _layer(gen, "a16w4_mxfp", 2560, 960)
    x = torch.randn((8, 960), generator=gen, device="cuda").to(torch.bfloat16)
    assert build.graph_ops(lambda: mx_general(x, layer.W_q, layer.scales, None,
                                              layer.meta)) == ["kernel"]
    dispatch.KERNEL_TRACE.clear()
    for M in (1, 64, 65, 1024, 4096):
        xm = (torch.randn((M, 960), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
        assert _rel(layer(xm), _layer_plain(layer, xm)) <= REL, M
    assert dispatch.KERNEL_TRACE == ["general_fused"] * 4 + ["dense_fallback"]
    fp8 = _layer(gen, "a16w8_mxfp_e4m3", 2560, 960)
    with pytest.raises(NotImplementedError, match="oracle"):
        fp8(x)


def _split_state_is_zero(owner):
    """The arrival counters a split call leaves 0."""
    states = [ints for key, (ints, _) in build._SPLIT_STATE.items() if key[0] == owner]
    assert states and all(int(t.abs().sum()) == 0 for t in states)


@pytest.mark.parametrize("form", GENERAL_FORMS)
@pytest.mark.parametrize("N,K", GENERAL_SHAPES)
@pytest.mark.parametrize("M", [64, 65])
def test_mx_general_body_switch(gen, form, N, K, M):
    """M 64 runs the decode body for e8m0 layers, M 65 the prefill body; NVFP4
    takes the prefill body at both. Each within 5e-3 of the plain version."""
    layer = _layer(gen, form, N, K)
    x, sx, meta = _inputs(gen, layer, M)
    nvfp4 = form == "a4w4_nvfp"
    assert general_plan(M, N, K, nvfp4).body == ("decode" if M <= 64 and not nvfp4 else "prefill")
    out = mx_general(x, layer.W_q, layer.scales, sx, meta)
    assert _rel(out, _plain(layer, x, sx, meta)) <= REL


# (M, N, K) whose general plan splits K: decode body, prefill body at small M
# (NVFP4), at M 128 and at M 1024, and a ragged N
SPLIT_CASES = [(8, 2560, 960), (64, 960, 2560), (8, 2880, 2880), (128, 2880, 2880),
               (1024, 960, 2560), (65, 1000, 1024)]


@pytest.mark.parametrize("form", GENERAL_FORMS)
@pytest.mark.parametrize("M,N,K", SPLIT_CASES)
def test_mx_general_split_k(gen, form, M, N, K):
    p = general_plan(M, N, K, form == "a4w4_nvfp")
    if p.splits == 1:
        pytest.fail(f"the plan of {(M, N, K)} no longer splits K: {p}")
    layer = _layer(gen, form, N, K)
    x, sx, meta = _inputs(gen, layer, M)
    out = mx_general(x, layer.W_q, layer.scales, sx, meta)
    torch.cuda.synchronize()
    assert _rel(out, _plain(layer, x, sx, meta)) <= REL
    _split_state_is_zero("mx_general")


@pytest.mark.parametrize("form", ["a16w4_mxfp", "a4w4_nvfp"])
@pytest.mark.parametrize("M", [8, 1024])
def test_mx_general_one_device_operation(gen, form, M):
    layer = _layer(gen, form, 2560, 960)
    x, sx, meta = _inputs(gen, layer, M)
    assert build.graph_ops(lambda: mx_general(x, layer.W_q, layer.scales, sx, meta)) == ["kernel"]


@pytest.mark.parametrize("M,N,K", [(8, 2560, 960), (128, 2880, 2880)])
def test_mx_general_captured_replay_equals_eager(gen, M, N, K):
    """The call captured in a CUDA graph on a side stream (after a warm-up
    call there, which grows that stream's split scratch), as the engine
    captures its decode step: each replay on a new x equals the eager call
    on it bit for bit, counts no launch, and leaves the counters 0."""
    layer = _layer(gen, "a16w4_mxfp", N, K)
    assert general_plan(M, N, K, False).splits > 1
    xs = [(torch.randn((M, K), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
          for _ in range(3)]
    x = xs[0].clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        mx_general(x, layer.W_q, layer.scales, None, layer.meta)
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = mx_general(x, layer.W_q, layer.scales, None, layer.meta)
    launches = mx_general.launches
    for xi in xs:
        x.copy_(xi)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, mx_general(xi, layer.W_q, layer.scales, None, layer.meta))
    assert mx_general.launches == launches + len(xs)          # the eager calls only
    _split_state_is_zero("mx_general")


# (N, K): the 8B shapes and K 4480 (35 stages: its last split is shorter)
TMA_DECODE_SHAPES = SHAPES_8B + [(1024, 4480)]


@pytest.mark.parametrize("N,K", TMA_DECODE_SHAPES)
@pytest.mark.parametrize("M", [1, 8, 16, 33, 64])
@pytest.mark.parametrize("form", DECODE_FORMS)
def test_mx_decode_tma_matches_plain_and_stacked(gen, form, M, N, K):
    """The decode entry against its plain version; the stacked entry over a
    3-layer stack of the same form equals the per-layer entry bit for bit at
    each layer."""
    layers = [_layer(gen, form, N, K) for _ in range(3)]
    x, sx, meta = _inputs(gen, layers[0], M)
    if K == 4480:
        p = decode_plan(M, N, K, w_kind(meta), x.element_size())
        assert p.splits > 1 and K - (p.splits - 1) * p.k_per_split < p.k_per_split
    W = torch.stack([lyr.W_q for lyr in layers])
    S = torch.stack([lyr.scales for lyr in layers])
    for li, lyr in enumerate(layers):
        out = mx_decode(x, lyr.W_q, lyr.scales, sx, meta)
        torch.cuda.synchronize()
        assert out.dtype == torch.bfloat16 and out.shape == (M, N)
        assert _rel(out, _plain(lyr, x, sx, meta)) <= REL, (form, M, N, K, li)
        if meta.channel_scale_mode == 0:         # the stacked path takes bf16 x
            idx = torch.tensor([li], dtype=torch.int32, device="cuda")
            got = mx_decode_stacked(x, W, S, meta, idx)
            torch.cuda.synchronize()
            assert torch.equal(got, out), (form, M, N, K, li)


@pytest.mark.parametrize("form", ["a16w4_mxfp", "a16w8_mxfp_e4m3", "a8w8_mxfp"])
@pytest.mark.parametrize("M", [1, 8, 64])
def test_mx_decode_tma_one_launch_and_replay(gen, form, M):
    """One kernel a call, no allocation but the output, the split state left
    0, two calls bit-equal, and a CUDA graph's replay equal to the eager
    call; for the stacked entry the replay at another layer index equals
    the per-layer call on that layer."""
    N, K = 14336, 4096
    layers = [_layer(gen, form, N, K) for _ in range(2)]
    x, sx, meta = _inputs(gen, layers[0], M)
    call = (lambda: mx_decode(x, layers[0].W_q, layers[0].scales, sx, meta))
    want = call()
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    got = [call()]
    assert torch.cuda.memory_stats()["allocation.all.allocated"] - before == 1
    assert build.graph_ops(lambda: got.append(call())) == ["kernel"]
    assert all(torch.equal(g, want) for g in got)
    _split_state_is_zero("mx_decode")
    if meta.channel_scale_mode:
        return
    W = torch.stack([lyr.W_q for lyr in layers])
    S = torch.stack([lyr.scales for lyr in layers])
    idx = torch.tensor([0], dtype=torch.int32, device="cuda")
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        mx_decode_stacked(x, W, S, meta, idx)
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = mx_decode_stacked(x, W, S, meta, idx)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    idx.fill_(1)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, mx_decode(x, layers[1].W_q, layers[1].scales, None, meta))
