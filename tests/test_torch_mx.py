# SPDX-License-Identifier: Apache-2.0
"""MX layers (MXFP8, MXFP4, NVFP4) in the port against gemlite_tpu on the CPU.

* The weight quantizers (MXFP8 with flush on and off, e4m3 and e5m2; MXFP4
  and NVFP4 with window 0 and 2, with group maxima a few ulps either side of
  6 * 2^k), the activation quantizers and the micro-scaled quantizer of the
  csm-4 prefill form pack the JAX package's bytes. The MXFP4 scale goes
  through XLA's f32 log2 and exp2 in JAX, which the port reproduces from
  ``gemlite_tpu_torch/xla_f32.py``.
* The csm-4 contract: codes times group scales, rounded once to bf16, equal
  ``fake_quant_activations(x)`` bit for bit, in both packages.
* Each of the six processors packs JAX's bytes, scales and 12-int metadata
  (JAX's layer brought to the reference layout with ``to_reference_layout``
  and its x2 fp4 codebook undone), routes as JAX does at M 1 / 8 / 64 / 65 /
  128 / 4096 (``decode`` for JAX's ``decode_plane``, ``dequantize`` for its
  ``dense_fallback`` on a layer it folds), and computes within mean|a-b| /
  mean|b| < 1e-3 of JAX, the bound of JAX's own MX kernel tests
  (tests/test_mx_kernels.py), or 5e-3 for NVFP4 on JAX's prefill kernel, the
  bound that file gives NVFP4: JAX's kernel rounds NVFP4's e4m3 x 0.05
  scaled weights to bf16, the port's CPU path (the plain version) does not.
* Layer files cross both ways, JAX files with ``w_layout`` 1, ``mx_x2`` 1 and
  ``mx_flat`` 1 included; the e8m0 exponents are raised back only where the
  file carries ``mx_x2``.
* JAX's csm-4 prefill gate (``can_use_prefill_kernel(mx_x=True)`` with the
  config its router would use) agrees with the port's route at the 8B
  shapes for M 65-4095.
* The JAX package's ``quantize_llama`` raises a TypeError for the A4W4
  processors; the port quantizes them (ROADMAP Queue C).
* Layers off the JAX fold rule (SmolLM2-360M's 2560x960 and 960x2560) of the
  four fp4 processors compute within the same bounds of JAX at M 1 / 64 / 65
  / 4096. JAX runs them on its general fused kernel (2560x960 at M <= 64) or
  its oracle (the rest below 4096), the port on its general MX kernel
  (``plain_general_fused`` here) at every M below 4096: a route difference,
  the same function on a kernel. From 4096 both take ``dense_fallback``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemlite_tpu import mx as jmx
from gemlite_tpu import quant as jq
from gemlite_tpu.config import config_signature, ensure_default_config, lookup_config
from gemlite_tpu.core import GemLiteLinear as JLinear
from gemlite_tpu.dtypes import DType as JDType
from gemlite_tpu.models import llama as jllama
from gemlite_tpu.ops import dispatch as jdispatch
from gemlite_tpu.ops.pallas_prefill import can_use_prefill_kernel, select_prefill_config
from gemlite_tpu.utils import m_bucket
from gemlite_tpu_torch import GemLiteLinear, LayerMeta, mx as tmx, quant as tq
from gemlite_tpu_torch.models import llama as tllama
from gemlite_tpu_torch.ops import dispatch as tdispatch
from gemlite_tpu_torch.ops import mx as tmx_ops

from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

N, K = 256, 512
TOL = 1e-3
TOL_NVFP4_KERNEL = 5e-3
PROCESSORS = {
    "A16W4_MXFP": (jmx.A16W4_MXFP, tmx.A16W4_MXFP),
    "A16W8_MXFP": (jmx.A16W8_MXFP, tmx.A16W8_MXFP),
    "A8W8_MXFP_dynamic": (jmx.A8W8_MXFP_dynamic, tmx.A8W8_MXFP_dynamic),
    "A8W4_MXFP_dynamic": (jmx.A8W4_MXFP_dynamic, tmx.A8W4_MXFP_dynamic),
    "A4W4_MXFP_dynamic": (jmx.A4W4_MXFP_dynamic, tmx.A4W4_MXFP_dynamic),
    "A4W4_NVFP_dynamic": (jmx.A4W4_NVFP_dynamic, tmx.A4W4_NVFP_dynamic),
}
MS = (1, 8, 64, 65, 128, 4096)
# the JAX router's routes (KERNEL_TRACE) and the port's, by processor, at MS
JAX_ROUTES = {"A16W4_MXFP": ["decode_plane"] * 3 + ["prefill"] * 2 + ["dense_fallback"],
              "A16W8_MXFP": ["decode_plane"] * 3 + ["prefill"] * 2 + ["dense_fallback"],
              "A8W8_MXFP_dynamic": ["decode_plane"] * 3 + ["prefill"] * 2 + ["dense_fallback"],
              "A8W4_MXFP_dynamic": ["decode_plane"] * 3 + ["prefill"] * 2 + ["dense_fallback"],
              "A4W4_MXFP_dynamic": ["decode_plane"] * 3 + ["prefill_mx_csm4"] * 2
              + ["dense_fallback"],
              "A4W4_NVFP_dynamic": ["prefill"] * 3 + ["prefill_mx_csm4"] * 2 + ["dense_fallback"]}
PORT_NAME = {"decode_plane": "decode", "prefill": "prefill", "prefill_mx_csm4": "prefill_mx_csm4",
             "dense_fallback": "dequantize"}
SHAPES_8B = ((4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336), (6144, 4096),
             (28672, 4096))


def _np(a):
    """An array of either package as numpy; fp8 and e8m0 as their bytes."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype in (torch.float8_e4m3fn, torch.float8_e5m2, torch.float8_e8m0fnu):
            return a.view(torch.uint8).numpy()
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    if "float8" in a.dtype.name:
        return a.view(np.uint8)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _weights(seed=0, group=32, n=N, k=K):
    """Seeded N(0, 0.02) weights, the first value of some groups set so that
    the group's max lies a few ulps either side of 6 * 2^k (and of its NVFP4
    and MXFP8 ideals), where the JAX package's log2 and exp2 round."""
    w = (np.random.default_rng(seed).normal(size=(n, k)) * 0.02).astype(np.float32)
    g = w.reshape(-1, group)
    r = 0
    for e in range(-12, -3):
        for d in range(-4, 5):
            base = np.array([6.0 * 2.0 ** e], np.float32).view(np.int32)[0]
            g[r, 0] = np.array([base + d], np.int32).view(np.float32)[0]
            r += 2
    return g.reshape(n, k)


def _layers(name, seed=0):
    jp, tp = PROCESSORS[name]
    w = _weights(seed)
    jl = jp().from_linear(types.SimpleNamespace(weight=w, bias=None), del_orig=False)
    tl = tp(device="cpu").from_linear(types.SimpleNamespace(weight=torch.from_numpy(w), bias=None),
                                      del_orig=False)
    return jl, tl


def _jax_reference_layout(jl):
    """JAX's layer's (W_q, scales) in the reference layout with plain fp4
    codes: ``to_reference_layout``, then its x2 codebook undone."""
    jl.to_reference_layout()
    W = np.asarray(jl.W_q)
    s = _np(jl.scales)
    if jl.mx_x2:
        W = np.asarray(jq.fp4x2_remap_packed(jnp.asarray(W)))
        s = s + 1
    return W, s


@pytest.mark.parametrize("fp8", ["e4m3", "e5m2"])
@pytest.mark.parametrize("flush", [True, False])
def test_mxfp8_quantizer_matches_jax(fp8, flush):
    jd, td = ((jnp.float8_e4m3fn, torch.float8_e4m3fn) if fp8 == "e4m3"
              else (jnp.float8_e5m2, torch.float8_e5m2))
    w = _weights(1)
    a = jq.WeightQuantizerMXFP(compute_dtype=jnp.float32).quantize_mxfp8(
        jnp.asarray(w), index=True, mx_fp8_dtype=jd, flush_subnormals=flush)
    b = tq.WeightQuantizerMXFP(compute_dtype=torch.float32).quantize_mxfp8(
        torch.from_numpy(w), index=True, mx_fp8_dtype=td, flush_subnormals=flush)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(_np(y), _np(x))


@pytest.mark.parametrize("window", [0, 2])
@pytest.mark.parametrize("kind", ["mxfp4", "nvfp4"])
def test_fp4_quantizers_match_jax(kind, window):
    w = _weights(2, group=16 if kind == "nvfp4" else 32)
    a = getattr(jq.WeightQuantizerMXFP(compute_dtype=jnp.float32), f"quantize_{kind}")(
        jnp.asarray(w), window_size=window, index=True)
    b = getattr(tq.WeightQuantizerMXFP(compute_dtype=torch.float32), f"quantize_{kind}")(
        torch.from_numpy(w), window_size=window, index=True)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(_np(y), _np(x))


def test_xla_log2_and_exp2_are_reproduced():
    """The port's ceil(log2) and exp2 equal jnp's on every bit pattern within
    64 of a power of two from 2^-34 to 2^40, and on integers -40 to 128."""
    bases = np.array([2.0 ** e for e in range(-34, 41)], np.float32).view(np.int32)
    bits = (bases[:, None] + np.arange(-64, 65)[None, :]).reshape(-1).astype(np.int32)
    v = bits.view(np.float32)
    want = np.ceil(np.asarray(jnp.log2(jnp.asarray(v)))).astype(np.int32)
    np.testing.assert_array_equal(tq._xla_ceil_log2(torch.from_numpy(v)).numpy(), want)
    k = np.arange(-40, 129).astype(np.float32)
    np.testing.assert_array_equal(tq._xla_exp2(torch.from_numpy(k)).numpy().view(np.int32),
                                  np.asarray(jnp.exp2(jnp.asarray(k))).view(np.int32))


@pytest.mark.parametrize("kind", ["mxfp8", "mxfp4", "nvfp4"])
def test_activation_quantizers_match_jax(kind):
    x = (np.random.default_rng(3).normal(size=(8, K)) * 1.5).astype(np.float32)
    a = getattr(jq, f"scale_activations_{kind}")(jnp.asarray(x))
    b = getattr(tq, f"scale_activations_{kind}")(torch.from_numpy(x))
    for u, v in zip(a, b):
        np.testing.assert_array_equal(_np(v), _np(u))


@pytest.mark.parametrize("dtype", ["MXFP8", "MXFP4", "NVFP4"])
def test_csm4_contract_bit_for_bit(dtype):
    """codes x group scales, rounded once to bf16, equal fake_quant_activations
    in the port and in JAX; the port's codes and scales are JAX's, untransposed."""
    x = (np.random.default_rng(4).normal(size=(24, K)) * 0.7).astype(np.float32)
    codes, scales = tq.scale_activations_mx(torch.from_numpy(x), tmx.DType[dtype])
    ags = K // scales.shape[1]
    assert ags == (16 if dtype == "NVFP4" else 32)
    rebuilt = (codes.float() * torch.repeat_interleave(scales, ags, dim=1)).to(torch.bfloat16)
    port = tmx.fake_quant_activations(torch.from_numpy(x), tmx.DType[dtype])
    assert torch.equal(rebuilt.view(torch.int16), port.view(torch.int16))
    jfq = jmx.fake_quant_activations(jnp.asarray(x), JDType[dtype])
    np.testing.assert_array_equal(_np(port), _np(jfq))
    jc, js = jq.scale_activations_mx_transposed(jnp.asarray(x), JDType[dtype])
    np.testing.assert_array_equal(_np(codes), _np(jc).T)
    np.testing.assert_array_equal(scales.numpy(), np.asarray(js).T)


@pytest.mark.parametrize("name", sorted(PROCESSORS))
def test_processor_packs_jax_bytes(name):
    jl, tl = _layers(name)
    assert tl.get_meta_args() == jl.get_meta_args()
    assert (tl.w_code_dtype, tl.fp8_nosub) == (jl.w_code_dtype, jl.fp8_nosub)
    W, s = _jax_reference_layout(jl)
    np.testing.assert_array_equal(tl.W_q.numpy(), W)
    np.testing.assert_array_equal(_np(tl.scales), s)


def _rel(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float(np.abs(a - b).mean() / np.abs(b).mean())


@pytest.mark.parametrize("name", sorted(PROCESSORS))
def test_forward_routes_and_matches_jax(name):
    jl, tl = _layers(name)
    rng = np.random.default_rng(5)
    jroutes, troutes = [], []
    for M in MS:
        x = (rng.normal(size=(M, K)) * 0.5).astype(np.float32)
        jdispatch.KERNEL_TRACE.clear()
        tdispatch.KERNEL_TRACE.clear()
        want = jl(jnp.asarray(x, jnp.bfloat16))
        got = tl(torch.from_numpy(x).to(torch.bfloat16))
        jroutes += jdispatch.KERNEL_TRACE
        troutes += tdispatch.KERNEL_TRACE
        on_kernel = name == "A4W4_NVFP_dynamic" and M < 4096
        assert _rel(got, want) < (TOL_NVFP4_KERNEL if on_kernel else TOL), M
    assert jroutes == JAX_ROUTES[name]
    assert troutes == ["plain_" + PORT_NAME[r] for r in JAX_ROUTES[name]]


@pytest.mark.parametrize("name", sorted(PROCESSORS))
def test_layer_files_cross_both_ways(name, tmp_path):
    jl, tl = _layers(name)
    x = torch.from_numpy((np.random.default_rng(6).normal(size=(8, K)) * 0.5).astype(
        np.float32)).to(torch.bfloat16)
    # JAX's file (plane-folded, x2 codebook, mx_flat) loads as the port's layer
    jl.save(str(tmp_path / "jax.npz"))
    sd = dict(np.load(tmp_path / "jax.npz"))
    assert int(sd.get("w_layout", 0)) == 1
    loaded = GemLiteLinear.load(str(tmp_path / "jax.npz"), device="cpu")
    assert loaded.get_meta_args() == tl.get_meta_args()
    assert torch.equal(loaded.W_q, tl.W_q)
    assert torch.equal(loaded.scales.view(torch.uint8), tl.scales.view(torch.uint8))
    assert torch.equal(loaded(x), tl(x))
    # the port's file loads in JAX: the same bytes as JAX's own layer brought
    # to the reference layout, and JAX's forward on it agrees with the port's
    tl.save(str(tmp_path / "port.npz"))
    back = JLinear.load(str(tmp_path / "port.npz"))
    assert back.get_meta_args() == tl.get_meta_args() and not back.w_layout
    W, s = _jax_reference_layout(_layers(name)[0])
    np.testing.assert_array_equal(np.asarray(back.W_q), W)
    np.testing.assert_array_equal(_np(back.scales), s)
    assert _rel(tl(x), back(jnp.asarray(_np(x), jnp.bfloat16))) < TOL_NVFP4_KERNEL


@pytest.mark.parametrize("min_exp", [1, 2])
def test_x2_undone_only_where_flagged(min_exp):
    """A JAX MXFP4 layer is re-encoded to its x2 codebook only when every e8m0
    exponent is at least 2; the port raises the exponents back only on a
    layer whose file says so."""
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 16, size=(N, K)).astype(np.uint8)
    scales = rng.integers(min_exp, 140, size=(N, K // 32)).astype(np.uint8)
    scales[0, 0] = min_exp
    jl = jmx.pack_mxfp_layer(codes, scales, 4)
    assert jl.mx_x2 == (min_exp >= 2)
    tl = tmx.pack_mxfp_layer(torch.from_numpy(codes), torch.from_numpy(scales), 4, device="cpu")
    sd = {k: np.asarray(v) for k, v in jl.state_dict().items()}
    loaded = GemLiteLinear.from_state_dict(sd, device="cpu")
    assert torch.equal(loaded.W_q, tl.W_q) and torch.equal(loaded.scales, tl.scales)
    assert int(loaded.scales.min()) == min_exp


def test_fp4x2_remap_is_its_own_inverse():
    w = torch.from_numpy(np.random.default_rng(8).integers(-2 ** 31, 2 ** 31, size=(64, 32),
                                                           dtype=np.int64).astype(np.int32))
    assert torch.equal(tq.fp4x2_remap_packed(tq.fp4x2_remap_packed(w)), w)
    np.testing.assert_array_equal(tq.fp4x2_remap_packed(w).numpy(),
                                  np.asarray(jq.fp4x2_remap_packed(jnp.asarray(w.numpy()))))


def _jax_csm4_gate(jm, M, N_, K_):
    """Whether JAX's router takes ``prefill_mx_csm4`` (ops/dispatch.py:140-154):
    its prefill gate with ``mx_x=True`` under the config it would use."""
    sig = config_signature(m_bucket.get_closest_m(M), N_, K_, jm.group_size, jm.elements_per_sample,
                           jdispatch.autotune_type_id(jm))
    cfg = lookup_config("GEMM", sig)
    pcfg = cfg if cfg is not None else select_prefill_config(jm, M, N_, K_)
    return can_use_prefill_kernel(jm, M, N_, K_, pcfg, mx_x=True)


@pytest.mark.parametrize("name", ["A4W4_MXFP_dynamic", "A4W4_NVFP_dynamic"])
def test_csm4_gate_agrees_with_jax_at_8b_shapes(name):
    ensure_default_config()
    jl, _ = _layers(name)
    for N_, K_ in SHAPES_8B:
        jm = jl.meta._replace(in_features=K_, out_features=N_)
        tm = LayerMeta(*[int(v) for v in jm[:12]], in_features=K_, out_features=N_)
        for M in list(range(65, 4096, 211)) + [128, 1024, 2048, 4095]:
            port = tdispatch._route(tm, M) == "prefill_mx_csm4"
            assert port == _jax_csm4_gate(jm, M, N_, K_), (N_, K_, M)


@pytest.mark.parametrize("name", ["A4W4_MXFP_dynamic", "A4W4_NVFP_dynamic"])
def test_jax_quantize_llama_a4w4_defect_is_not_copied(name):
    """JAX's quantize_llama tests ``mx_fp8_dtype`` (which the A4W4 processors
    lack) and falls through to from_weights(W_q, scales, zeros, bias=None):
    a TypeError. The port routes every MX processor through from_linear."""
    jcfg, tcfg = jllama.LlamaConfig.tiny(num_layers=1), tllama.LlamaConfig.tiny(num_layers=1)
    jp, tp = PROCESSORS[name]
    with pytest.raises(TypeError, match="multiple values for argument 'bias'"):
        jllama.quantize_llama(jllama.init_llama(jcfg, seed=0), processor=jp())
    q = tllama.quantize_llama(tllama.init_llama(tcfg, device="cpu"), processor=tp(device="cpu"))
    lin = q["blocks"][0]["attn"]["wq"]
    assert isinstance(lin, GemLiteLinear) and lin.channel_scale_mode == 4


UNFOLDED_MS = (1, 64, 65, 4096)
# JAX's routes on unfolded fp4 layers at UNFOLDED_MS, by (N, K)
JAX_UNFOLDED_ROUTES = {(2560, 960): ["general_fused", "general_fused", "oracle", "dense_fallback"],
                       (960, 2560): ["oracle", "oracle", "oracle", "dense_fallback"]}


@pytest.mark.parametrize("nk", sorted(JAX_UNFOLDED_ROUTES))
@pytest.mark.parametrize("name", ["A16W4_MXFP", "A8W4_MXFP_dynamic", "A4W4_MXFP_dynamic",
                                  "A4W4_NVFP_dynamic"])
def test_unfolded_fp4_layers_route_general_and_match_jax(name, nk):
    n, k = nk
    jp, tp = PROCESSORS[name]
    w = _weights(3, n=n, k=k)
    jl = jp().from_linear(types.SimpleNamespace(weight=w, bias=None), del_orig=False)
    tl = tp(device="cpu").from_linear(types.SimpleNamespace(weight=torch.from_numpy(w), bias=None),
                                      del_orig=False)
    assert tl.get_meta_args() == jl.get_meta_args()
    assert not tmx_ops.jax_folds(tl.meta)
    rng = np.random.default_rng(6)
    jroutes, troutes = [], []
    for M in UNFOLDED_MS:
        x = (rng.normal(size=(M, k)) * 0.5).astype(np.float32)
        jdispatch.KERNEL_TRACE.clear()
        tdispatch.KERNEL_TRACE.clear()
        want = jl(jnp.asarray(x, jnp.bfloat16))
        got = tl(torch.from_numpy(x).to(torch.bfloat16))
        jroutes += jdispatch.KERNEL_TRACE
        troutes += tdispatch.KERNEL_TRACE
        # JAX's general fused kernel rounds NVFP4's scaled weights to bf16
        on_kernel = name == "A4W4_NVFP_dynamic" and jroutes[-1] == "general_fused"
        assert _rel(got, want) < (TOL_NVFP4_KERNEL if on_kernel else TOL), M
    assert jroutes == JAX_UNFOLDED_ROUTES[nk]
    # the route difference: JAX's oracle runs on the port's general kernel
    assert troutes == ["plain_" + ("dense_fallback" if r == "dense_fallback" else "general_fused")
                       for r in jroutes]


def test_unfolded_fp8_layer_has_no_kernel():
    """An fp8-coded MX layer off the fold rule: JAX runs its oracle, the port
    its plain version on the CPU and, on the card, raises (no kernel)."""
    jp, tp = PROCESSORS["A16W8_MXFP"]
    w = _weights(4, n=960, k=960)
    jl = jp().from_linear(types.SimpleNamespace(weight=w, bias=None), del_orig=False)
    tl = tp(device="cpu").from_linear(types.SimpleNamespace(weight=torch.from_numpy(w), bias=None),
                                      del_orig=False)
    x = (np.random.default_rng(7).normal(size=(8, 960)) * 0.5).astype(np.float32)
    jdispatch.KERNEL_TRACE.clear()
    tdispatch.KERNEL_TRACE.clear()
    want = jl(jnp.asarray(x, jnp.bfloat16))
    got = tl(torch.from_numpy(x).to(torch.bfloat16))
    assert jdispatch.KERNEL_TRACE == ["oracle"] and tdispatch.KERNEL_TRACE == ["plain_oracle"]
    assert _rel(got, want) < TOL
    assert tdispatch._route(tl.meta, 8) is None
    why = tmx_ops.mx_refusal(tl.meta, 8, "general")
    assert "oracle" in why and "fp8" in why
