# SPDX-License-Identifier: Apache-2.0
"""GemLiteLinear in the port against gemlite_tpu's, on the CPU.

* Packed bytes and the 12-int metadata equal the JAX layer's after
  ``to_reference_layout()`` (the JAX package plane-folds its words).
* The port's forward (the kernels' plain versions) matches the JAX dispatch
  output, with the JAX kernel tests' bound: mean|a-b| / mean|b| < 5e-3. The
  JAX decode kernel sums raw codes and corrects per group, so its bf16
  outputs differ from the port's in the last place.
* A JAX state dict in the folded layout loads into the port.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from gemlite_tpu import DType as JDType, GemLiteLinear as JLinear
from gemlite_tpu.ops import dispatch as jdispatch
from gemlite_tpu.ops.pallas_prefill import can_use_dequantize as jax_can_use_dequantize
from gemlite_tpu_torch import DType, GemLiteLinear
from gemlite_tpu_torch.core import tensor_from_numpy
from gemlite_tpu_torch.ops import dispatch
from gemlite_tpu_torch.ops.dequantize import jax_folds

REL = 5e-3


def _hqq(rng, N, K, W_nbits, gs):
    """Codes, bf16 scales and bf16 zeros as the HQQ processors hand them over."""
    W_q = rng.integers(0, 2 ** W_nbits, size=(N, K)).astype(np.uint8)
    G = N * K // gs
    scales = (rng.uniform(0.5, 1.5, size=(G, 1)) * 2.0 ** -6).astype(ml_dtypes.bfloat16)
    zeros = rng.integers(0, 2 ** W_nbits, size=(G, 1)).astype(ml_dtypes.bfloat16)
    return W_q, scales, zeros


def _pair(W_q, scales, zeros, W_nbits, gs, **pack_kw):
    N, K = W_q.shape
    jl = JLinear(W_nbits, gs, K, N, JDType.BF16, JDType.BF16).pack(W_q, scales, zeros, **pack_kw)
    tl = GemLiteLinear(W_nbits, gs, K, N, DType.BF16, DType.BF16, device="cpu").pack(
        W_q, None if scales is None else tensor_from_numpy(scales),
        zeros if zeros is None or np.ndim(zeros) == 0 else tensor_from_numpy(zeros), **pack_kw)
    return jl, tl


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _tbits(t):
    return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("fma", [True, False])
@pytest.mark.parametrize("gs", [32, 64, 128])
@pytest.mark.parametrize("W_nbits", [2, 4, 8])
def test_packed_bytes_and_meta_equal_jax(W_nbits, gs, fma):
    rng = np.random.default_rng(W_nbits * 1000 + gs)
    jl, tl = _pair(*_hqq(rng, 128, 256, W_nbits, gs), W_nbits, gs, fma_mode=fma)
    assert tl.get_meta_args() == jl.get_meta_args()
    assert tl.W_group_mode == (4 if fma else 3)
    jl.to_reference_layout()
    assert np.array_equal(np.asarray(jl.W_q), tl.W_q.numpy())
    assert np.array_equal(_bits(jl.scales), _tbits(tl.scales))
    assert np.array_equal(_bits(jl.zeros), _tbits(tl.zeros))


def _jax_forward(jl, x):
    jdispatch.KERNEL_TRACE.clear()
    y = jl(jnp.asarray(x, jnp.bfloat16))
    return np.asarray(y.astype(jnp.float32)), list(jdispatch.KERNEL_TRACE)


def _port_forward(tl, x):
    dispatch.KERNEL_TRACE.clear()
    y = tl(torch.from_numpy(x).to(torch.bfloat16))
    return y.float().numpy(), list(dispatch.KERNEL_TRACE)


def _rel(got, want):
    return float(np.mean(np.abs(got - want)) / (np.mean(np.abs(want)) + 1e-6))


@pytest.mark.parametrize("W_nbits", [4, 2, 1])
@pytest.mark.parametrize("fma", [True, False])
@pytest.mark.parametrize("M,route", [(1, "decode"), (8, "decode"), (128, "prefill"),
                                     (4096, "dequantize")])
def test_forward_matches_jax_dispatch(M, route, fma, W_nbits):
    rng = np.random.default_rng(M + 10 * (4 - W_nbits))
    N, K, gs = 256, 512, 128
    jl, tl = _pair(*_hqq(rng, N, K, W_nbits, gs), W_nbits, gs, fma_mode=fma)
    x = (rng.normal(size=(M, K)) * 0.2).astype(np.float32)
    want, jtrace = _jax_forward(jl, x)
    got, trace = _port_forward(tl, x)
    # the decode and prefill kernels take W1/W2/W4 in mode 4 and, in their
    # mode 1-3 form, mode 3 (fma off), as the JAX decode and prefill kernels
    # do; the dequantize kernel takes every one of them at M >= 4096, where
    # the JAX package dequantizes with its Pallas kernel
    assert trace == [f"plain_{route}"]
    if route == "decode":
        assert jtrace == ["decode_plane"]
    assert _rel(got, want) < REL, _rel(got, want)


@pytest.mark.parametrize("W_nbits,gs,N,K", [(4, 128, 256, 512), (2, 64, 128, 256),
                                            (8, 128, 128, 256), (4, 1024, 128, 2048),
                                            (4, 128, 192, 256), (4, 256, 128, 256),
                                            (4, 1024, 128, 1024)])
def test_dense_fallback_only_where_jax_dequantizes_without_pallas(W_nbits, gs, N, K):
    """At M >= 4096 the port takes the plain dequantize (dense_fallback) only
    for the layers the JAX package keeps in the reference layout, which its
    Pallas dequantize kernel refuses; the rest run on the dequantize kernel,
    as they run on JAX's."""
    rng = np.random.default_rng(W_nbits * 7 + gs)
    jl, tl = _pair(*_hqq(rng, N, K, W_nbits, gs), W_nbits, gs, fma_mode=False)
    assert jax_folds(tl.meta) == (jl.w_layout != 0)
    assert jax_can_use_dequantize(jl.meta, N, K) == (jl.w_layout != 0)
    _, trace = _port_forward(tl, np.zeros((4096, K), np.float32))
    assert trace == ["plain_dense_fallback" if jl.w_layout == 0 else "plain_dequantize"]


@pytest.mark.parametrize("case", ["symmetric", "channelwise", "channelwise_zero",
                                  "scalar_zero", "shift_only", "no_meta"])
def test_decision_tree_equals_jax(case):
    """pack()'s modes for float activations: W_group_mode 0-3, csm 0/1,
    scalar zeros. Metadata vector equal, outputs within the bound."""
    rng = np.random.default_rng(7)
    N, K = 128, 256
    W_nbits, gs = (2, 64) if case in ("scalar_zero", "shift_only") else (4, 64)
    W_q, scales, zeros = _hqq(rng, N, K, W_nbits, gs)
    if case == "symmetric":
        zeros = None
    elif case in ("channelwise", "channelwise_zero"):
        gs = K
        scales = (rng.uniform(0.5, 1.5, size=(N, 1)) * 2.0 ** -6).astype(ml_dtypes.bfloat16)
        zeros = (rng.integers(0, 16, size=(N, 1)).astype(ml_dtypes.bfloat16)
                 if case == "channelwise_zero" else None)
    elif case == "scalar_zero":
        zeros = 1
    elif case == "shift_only":
        scales, zeros, gs = None, 1, K
    else:
        scales, zeros = None, None
    jl, tl = _pair(W_q, scales, zeros, W_nbits, gs)
    assert tl.get_meta_args() == jl.get_meta_args()
    assert bool(tl.zero_is_scalar) == bool(jl.zero_is_scalar)
    x = (rng.normal(size=(4, K)) * 0.2).astype(np.float32)
    want, _ = _jax_forward(jl, x)
    got, _ = _port_forward(tl, x)
    assert _rel(got, want) < REL, _rel(got, want)


def test_jax_folded_state_dict_loads():
    """A JAX layer packed in its plane-folded layout (w_layout=1) loads into
    the port as w_layout=0 bytes, with the same forward."""
    rng = np.random.default_rng(3)
    jl, tl = _pair(*_hqq(rng, 256, 512, 4, 128), 4, 128)
    sd = jl.state_dict()
    assert int(sd["w_layout"]) == 1
    loaded = GemLiteLinear.from_state_dict(sd, device="cpu")
    assert loaded.get_meta_args() == jl.get_meta_args()
    jl.to_reference_layout()
    assert np.array_equal(loaded.W_q.numpy(), np.asarray(jl.W_q))
    x = torch.from_numpy((rng.normal(size=(8, 512)) * 0.2).astype(np.float32)).to(torch.bfloat16)
    assert torch.equal(loaded(x), tl(x))
    # and the port's own state dict round-trips
    again = GemLiteLinear.from_state_dict(tl.state_dict(), device="cpu")
    assert torch.equal(again(x), tl(x))

