# SPDX-License-Identifier: Apache-2.0
"""The FP8 slice of the port against gemlite_tpu on the CPU, layer by layer.

The same seeded numpy weights and activations go through the JAX package
(its Pallas kernels in interpret mode) and the port (its plain versions):

* ``A16W8_FP8``, ``A8W8_FP8_dynamic`` (e4m3, and e5m2 through ``fp8=``) and
  ``A8W4`` / ``A8W2_HQQ_INT_dynamic``: the packed words (JAX's plane-folded
  layout unfolded), the 12-int metadata, ``w_code_dtype``, ``fp8_nosub``,
  scales, zeros and bias equal; the subnormal flush on and off;
* ``scale_activations_per_token``: the codes' bytes and the scales equal for
  e4m3, e5m2 and int8, with ``fp32_scale`` on and off;
* ``forward`` at M 1, 8, 64, 65, 128 and 4096 within mean|a-b| / mean|b| <=
  3e-3, the bound tests/test_layer.py holds the JAX fp8 kernels to against
  their oracle (``test_a8w8_fp8_reaches_plane_kernels``); the route equals
  the JAX ``KERNEL_TRACE`` name (JAX's ``decode_plane`` is the port's
  ``decode``, its ``dense_fallback``, which dequantizes these layers with
  ``pallas_dequantize``, the port's ``dequantize``); A8Wn takes the decode
  and prefill kernels' mode 1-3 form below M 4096 and the general fused
  kernel at 4096, a route difference asserted as such;
* layer files cross both ways: a JAX-saved fp8 layer loads in the port with
  equal outputs, and a port-saved one loads in JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemlite_tpu import GemLiteLinear as JLinear
from gemlite_tpu import helper as jh
from gemlite_tpu.ops import dispatch as jdispatch
from gemlite_tpu.quant import scale_activations_per_token as j_scale
from gemlite_tpu_torch import GemLiteLinear, helper as th
from gemlite_tpu_torch.ops import dispatch
from gemlite_tpu_torch.ops.fp8 import decode_plan, prefill_plan, prefill_rows, serves_fp8
from gemlite_tpu_torch.quant import scale_activations_per_token as t_scale

from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

N, K = 256, 512
MEAN_REL = 3e-3
JAX_ROUTE = {"decode_plane": "decode", "dense_fallback": "dequantize"}
FP8 = {"e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
       "e5m2": (jnp.float8_e5m2, torch.float8_e5m2)}


def _weight(seed=0, tiny=True):
    """(N, K) float32 weights; with ``tiny`` a few entries small enough to
    quantize to fp8 subnormals (e4m3 and e5m2 alike)."""
    w = (np.random.default_rng(seed).normal(size=(N, K)) * 0.05).astype(np.float32)
    if tiny:
        amax = np.abs(w).max(axis=1)
        for j, f in enumerate((3e-6, 1e-5, 2e-5, -1e-5, 1e-9, -2e-9, 5e-10)):
            w[:, 3 * j] = amax * f
    return w


# name -> (JAX processor, port processor, how the layer is made)
PROCESSORS = {
    "a8w8_e4m3": (lambda: jh.A8W8_FP8_dynamic(dtype=jnp.bfloat16),
                  lambda: th.A8W8_FP8_dynamic(device="cpu", dtype=torch.bfloat16), "weights"),
    "a8w8_e5m2": (lambda: jh.A8W8_FP8_dynamic(dtype=jnp.bfloat16, fp8=jnp.float8_e5m2),
                  lambda: th.A8W8_FP8_dynamic(device="cpu", dtype=torch.bfloat16,
                                              fp8=torch.float8_e5m2), "weights"),
    "a8w8_e4m3_keep_subnormals": (
        lambda: jh.A8W8_FP8_dynamic(dtype=jnp.bfloat16, flush_subnormals=False),
        lambda: th.A8W8_FP8_dynamic(device="cpu", dtype=torch.bfloat16, flush_subnormals=False),
        "weights"),
    "a8w8_fp8_alias": (lambda: jh.A8W8_fp8_dynamic(dtype=jnp.bfloat16),
                       lambda: th.A8W8_fp8_dynamic(device="cpu", dtype=torch.bfloat16), "weights"),
    "a16w8_e4m3": (lambda: jh.A16W8_FP8(dtype=jnp.bfloat16),
                   lambda: th.A16W8_FP8(device="cpu", dtype=torch.bfloat16), "weights"),
    "a16w8_e5m2_keep_subnormals": (
        lambda: jh.A16W8_FP8(dtype=jnp.bfloat16, fp8=jnp.float8_e5m2, flush_subnormals=False),
        lambda: th.A16W8_FP8(device="cpu", dtype=torch.bfloat16, fp8=torch.float8_e5m2,
                             flush_subnormals=False), "weights"),
    "a16w8_post_bf16_scale": (
        lambda: jh.A16W8_FP8(dtype=jnp.bfloat16, post_scale=True, fp32_scale=False),
        lambda: th.A16W8_FP8(device="cpu", dtype=torch.bfloat16, post_scale=True,
                             fp32_scale=False), "weights"),
    "a16w8_fp8_arg": (lambda: jh.A16W8(dtype=jnp.bfloat16, fp8=jnp.float8_e4m3fn),
                      lambda: th.A16W8(device="cpu", dtype=torch.bfloat16,
                                       fp8=torch.float8_e4m3fn), "weights"),
    "a8w4_gs64": (lambda: jh.A8W4_HQQ_INT_dynamic(dtype=jnp.bfloat16),
                  lambda: th.A8W4_HQQ_INT_dynamic(device="cpu", dtype=torch.bfloat16), 64),
    "a8w2_gs64": (lambda: jh.A8W2_HQQ_INT_dynamic(dtype=jnp.bfloat16),
                  lambda: th.A8W2_HQQ_INT_dynamic(device="cpu", dtype=torch.bfloat16), 64),
    "a8w4_gsK_post": (lambda: jh.A8W4_HQQ_INT_dynamic(dtype=jnp.bfloat16, post_scale=True),
                      lambda: th.A8W4_HQQ_INT_dynamic(device="cpu", dtype=torch.bfloat16,
                                                      post_scale=True), K),
}
_LAYERS = {}


def _layers(name):
    """(JAX layer, port layer) of one processor on ``_weight()``, with a bias."""
    if name not in _LAYERS:
        jp, tp, how = PROCESSORS[name]
        w = _weight()
        bias = np.random.default_rng(1).normal(size=N).astype(np.float32) * 0.1
        if how == "weights":
            jl = jp().from_weights(w, bias=bias)
            tl = tp().from_weights(torch.from_numpy(w), bias=torch.from_numpy(bias))
        else:
            from gemlite_tpu.quant import quantize_int_weights as jq
            from gemlite_tpu_torch.quant import quantize_int_weights as tq
            W_q, s, z = jq(w, jp().W_nbits, how)
            jl = jp().from_weights(W_q, s, z, bias=bias)
            W_q, s, z = tq(torch.from_numpy(w), tp().W_nbits, how)
            tl = tp().from_weights(W_q, s, z, bias=torch.from_numpy(bias))
        _LAYERS[name] = (jl, tl)
    return _LAYERS[name]


def _carried(jl, device="cpu"):
    return GemLiteLinear.from_state_dict({k: np.asarray(v) for k, v in jl.state_dict().items()},
                                         device=device)


@pytest.mark.parametrize("name", sorted(PROCESSORS))
def test_processor_packs_jax_bytes(name):
    jl, tl = _layers(name)
    cl = _carried(jl)
    assert tl.get_meta_args() == jl.get_meta_args() == cl.get_meta_args()
    assert tl.meta == cl.meta
    assert (tl.w_code_dtype, tl.fp8_nosub) == (jl.meta.w_code_dtype, jl.meta.fp8_nosub)
    for t in ("W_q", "scales", "zeros", "bias"):
        a, b = getattr(tl, t), getattr(cl, t)
        assert (a is None) == (b is None), t
        if a is not None:
            assert a.dtype == b.dtype and torch.equal(a, b), t


@pytest.mark.parametrize("fmt", sorted(FP8))
@pytest.mark.parametrize("flush", [True, False])
def test_subnormal_flush(fmt, flush):
    """The fp8 codes with and without the flush: the same bytes in both
    packages, ``fp8_nosub`` set exactly when no subnormal code is left."""
    jdt, tdt = FP8[fmt]
    w = _weight(seed=3)
    jl = jh.A16W8_FP8(dtype=jnp.bfloat16, fp8=jdt, flush_subnormals=flush).from_weights(w)
    tl = th.A16W8_FP8(device="cpu", dtype=torch.bfloat16, fp8=tdt,
                      flush_subnormals=flush).from_weights(torch.from_numpy(w))
    assert torch.equal(_carried(jl).W_q, tl.W_q)
    assert tl.fp8_nosub == jl.meta.fp8_nosub == int(flush)
    b = tl.W_q.view(torch.uint8)
    exp_m, man_m = (0x78, 0x07) if fmt == "e4m3" else (0x7C, 0x03)
    assert bool((((b & exp_m) == 0) & ((b & man_m) != 0)).any()) == (not flush)


@pytest.mark.parametrize("target", ["e4m3", "e5m2", "int8"])
@pytest.mark.parametrize("fp32_scale", [True, False])
def test_scale_activations_per_token_bytes(target, fp32_scale):
    jdt, tdt = FP8.get(target, (jnp.int8, torch.int8))
    x = (np.random.default_rng(2).normal(size=(33, 256)) * 3).astype(np.float32)
    x[5] = 0.0                                   # a zero row: the 1e-6 floor
    x[7, :4] = (4e3, -6e4, 1e-3, 2.5)             # wide rows clip
    qj, sj = j_scale(jnp.asarray(x, jnp.bfloat16), jdt, fp32_scale=fp32_scale)
    qt, st = t_scale(torch.from_numpy(x).to(torch.bfloat16), tdt, fp32_scale=fp32_scale)
    assert qt.dtype == tdt and st.dtype == torch.float32
    assert np.array_equal(np.asarray(qj).view(np.uint8), qt.view(torch.uint8).numpy())
    assert np.array_equal(np.asarray(sj), st.numpy())


FORWARD = ["a8w8_e4m3", "a8w8_e5m2", "a16w8_e4m3", "a16w8_post_bf16_scale", "a8w4_gs64"]


@pytest.mark.parametrize("name", FORWARD)
@pytest.mark.parametrize("M", [1, 8, 64, 65, 128, 4096])
def test_forward_matches_jax(name, M):
    jl, tl = _layers(name)
    x = (np.random.default_rng(M).normal(size=(M, K))).astype(np.float32)
    jdispatch.KERNEL_TRACE.clear()
    want = np.asarray(jl(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    jroute = [JAX_ROUTE.get(r, r) for r in jdispatch.KERNEL_TRACE]
    dispatch.KERNEL_TRACE.clear()
    got = tl(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    route = [r.removeprefix("plain_") for r in dispatch.KERNEL_TRACE]
    assert route == jroute == [("decode" if M <= 64 else "prefill") if M < 4096
                               else "dequantize"]
    assert np.abs(got - want).mean() <= MEAN_REL * np.abs(want).mean(), name


@pytest.mark.parametrize("name", ["a8w8_e4m3", "a16w8_e5m2_keep_subnormals", "a8w2_gs64"])
def test_layer_files_cross_both_ways(name, tmp_path):
    jl, tl = _layers(name)
    x = (np.random.default_rng(5).normal(size=(8, K))).astype(np.float32)
    jl.save(str(tmp_path / "jax.npz"))
    from_jax = GemLiteLinear.load(str(tmp_path / "jax.npz"), device="cpu")
    assert from_jax.meta == tl.meta and torch.equal(from_jax.W_q, tl.W_q)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    assert torch.equal(from_jax(xt), tl(xt))
    tl.save(str(tmp_path / "port.npz"))
    from_port = JLinear.load(str(tmp_path / "port.npz"))
    assert from_port.meta.w_code_dtype == jl.meta.w_code_dtype
    assert from_port.meta.fp8_nosub == jl.meta.fp8_nosub
    xj = jnp.asarray(x, jnp.bfloat16)
    a = np.asarray(from_port(xj).astype(jnp.float32))
    b = np.asarray(jl(xj).astype(jnp.float32))
    assert np.abs(a - b).mean() <= MEAN_REL * np.abs(b).mean()


def test_fp8_gate_and_plans():
    """The kernels' gate (fp8 codes, mode 0 / 2 with one group, K and N
    multiples of 128) and plans: the decode split never depends on M, the
    prefill ring fits the card's shared memory."""
    _, a8 = _layers("a8w8_e4m3")
    _, a16 = _layers("a16w8_e4m3")
    _, a8w4 = _layers("a8w4_gs64")
    assert serves_fp8(a8.meta) and serves_fp8(a16.meta) and not serves_fp8(a8w4.meta)
    assert not serves_fp8(a8.meta._replace(out_features=200))
    assert not serves_fp8(a16.meta._replace(group_size=128))       # grouped mode 2: MX
    assert not serves_fp8(a8.meta, 4096)
    for n, k in ((4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336)):
        plans = [decode_plan(m, n, k, xb) for m in (1, 8, 33, 64) for xb in (1, 2)]
        assert len({(p.splits, p.k_per_split) for p in plans}) == 1
        assert all(p.smem <= 112 * 1024 and p.k_per_split % 128 == 0 for p in plans)
        for m in (65, 128, 1024, 4095):
            for xb in (1, 2):
                p = prefill_plan(m, n, k, xb)
                assert p.smem <= 227 * 1024 and p.k_per_split % p.bk == 0
                assert p.splits * p.k_per_split >= k > (p.splits - 1) * p.k_per_split
                if m <= 128 or xb == 2:
                    assert p.bm == (128 if m <= 128 else 256)
                else:      # fp8 x: the rows of least modelled time
                    assert p.bm == prefill_rows(m, n, k, xb) in (128, 256)


def test_a8wn_from_hqqlinear_and_patch_model_need_hqq():
    """A8Wn quantizes no float weight itself: ``from_hqqlinear`` and
    ``patch_model`` go through the ``hqq`` package, absent here, as in JAX."""
    proc = th.A8W4_HQQ_INT_dynamic(device="cpu", dtype=torch.bfloat16)
    with pytest.raises(ImportError, match="hqq"):
        proc.from_hqqlinear(object())
    with pytest.raises(ImportError, match="hqq"):
        th.patch_model(torch.nn.Sequential(torch.nn.Linear(128, 128)), proc)
    with pytest.raises(ValueError, match="W_nbits"):
        th.A8Wn_HQQ_INT_dynamic(device="cpu")


def test_unfolded_fp8_layer_at_m4096_is_not_the_jax_defect():
    """JAX's M >= 4096 route dequantizes an fp8 layer that it could not
    plane-fold (K 256: channel-wise fold unit 512) with ``dequantize_full``,
    which reads the fp8 bytes as integer codes (a defect of the reference,
    ROADMAP Queue C). The port reads them as fp8: its output stays within
    the fp8 quantization error of the float product (8e-2, the bound of
    tests/test_layer.py for A8W8-FP8)."""
    w = (np.random.default_rng(4).normal(size=(256, 256)) * 0.05).astype(np.float32)
    jl = jh.A8W8_FP8_dynamic(dtype=jnp.bfloat16).from_weights(w)
    assert jl.meta.w_layout == 0
    tl = th.A8W8_FP8_dynamic(device="cpu", dtype=torch.bfloat16).from_weights(torch.from_numpy(w))
    x = np.random.default_rng(5).normal(size=(4096, 256)).astype(np.float32)
    dispatch.KERNEL_TRACE.clear()
    got = tl(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    assert dispatch.KERNEL_TRACE == ["plain_dequantize"]
    ref = x @ w.T
    assert np.abs(got - ref).mean() <= 8e-2 * np.abs(ref).mean()


def test_stacked_fp8_decode_matches_jax():
    """The stacked entry's plain version on three A16W8_FP8 layers against
    JAX ``pallas_decode_matmul_stacked`` (interpret mode) at every layer,
    within the decode bound above, and equal bit for bit to the per-layer
    decode's plain version (the index as a 0-d int32 tensor)."""
    from gemlite_tpu.ops.pallas_scan import pallas_decode_matmul_stacked
    from gemlite_tpu_torch.ops.fp8 import fp8_decode, fp8_decode_stacked
    jls, tls = [], []
    for seed in range(3):
        w = _weight(seed=10 + seed, tiny=False)
        jls.append(jh.A16W8_FP8(dtype=jnp.bfloat16).from_weights(w))
        tls.append(_carried(jls[-1]))
    jW, jS = jnp.stack([l.W_q for l in jls]), jnp.stack([l.scales for l in jls])
    tW, tS = torch.stack([l.W_q for l in tls]), torch.stack([l.scales for l in tls])
    x = (np.random.default_rng(7).normal(size=(8, K))).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    for i in range(3):
        want = np.asarray(pallas_decode_matmul_stacked(
            jnp.asarray(x, jnp.bfloat16), jW, jS, None, None, jls[0].meta,
            jnp.int32(i)).astype(jnp.float32))
        got = fp8_decode_stacked(xt, tW, tS, tls[i].meta, torch.tensor(i, dtype=torch.int32))
        assert torch.equal(got, fp8_decode(xt, tls[i].W_q, tls[i].scales, None, tls[i].meta))
        assert np.abs(got.float().numpy() - want).mean() <= MEAN_REL * np.abs(want).mean()
