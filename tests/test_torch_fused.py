# SPDX-License-Identifier: Apache-2.0
"""The general fused kernel's plain version against ``pallas_fused_matmul``
(interpret mode) on the CPU.

One case per W_nbits {1, 2, 4, 8} x W_group_mode {0..4} x csm {0..3} that
``can_use_pallas`` admits and pack() can make (mode 3/4 take no channel
scale), with scalar zeros where a mode shifts (mode 4 folds grouped zeros).
Modes 0/1 run with int8 x, so the int path (int8 x int8 -> int32) runs
wherever the codes fit int8: there the outputs equal bit for bit. The rest
dequantize in bf16 and sum in float32 in another order: within the bound of
tests/test_kernels.py, mean|a-b| / mean|b| < 5e-3. Each case runs M = 65
and M = 128 on N x K = 256 x 512.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemlite_tpu.core import GEMLITE_ACC_DTYPE, LayerMeta as JMeta
from gemlite_tpu.bitpack import pack_weights_over_cols
from gemlite_tpu.dtypes import DType as JDType
from gemlite_tpu.ops.pallas_gemm import can_use_pallas, pallas_fused_matmul, select_default_config
from gemlite_tpu_torch import DType, LayerMeta
from gemlite_tpu_torch.core import tensor_from_numpy
from gemlite_tpu_torch.ops import dispatch
from gemlite_tpu_torch.ops.fused import can_use_fused, fused_gemm, int_path

N, K, GS = 256, 512, 128
REL = 5e-3

CASES = [(nb, mode, csm) for nb in (1, 2, 4, 8) for mode in range(5) for csm in range(4)
         if not (mode in (3, 4) and csm in (1, 3))]


def _case(W_nbits, mode, csm, input_dtype, rng, w_nonpacked=None):
    """(W_q, scales, zeros) as numpy, the JAX meta and the port meta."""
    gs = K if csm in (1, 3) else GS
    G = K // gs
    if w_nonpacked is None:
        codes = rng.integers(0, 2 ** W_nbits, size=(N, K)).astype(np.uint8)
        W_q, elems = pack_weights_over_cols(codes, W_nbits, 32)
        W_q = np.asarray(W_q)
    else:
        W_q, elems = np.ascontiguousarray(w_nonpacked.T), 1
    scales = (rng.normal(size=(G, N)) * 0.01).astype(np.float32)
    zeros = np.asarray(7, np.int32) if mode in (1, 3) else None
    if mode == 4:
        zeros = (-rng.integers(0, 2 ** W_nbits, size=(G, N)) * scales).astype(np.float32)
    fields = dict(scaled_activations=int(csm in (2, 3)), W_nbits=W_nbits, group_size=gs,
                  unpack_mask=2 ** W_nbits - 1, elements_per_sample=elems,
                  input_dtype=input_dtype.value, output_dtype=DType.FP32.value,
                  acc_dtype=GEMLITE_ACC_DTYPE[JDType(input_dtype.value)].value,
                  meta_dtype=DType.FP32.value, channel_scale_mode=csm, W_group_mode=mode,
                  data_contiguous=1, in_features=K, out_features=N,
                  zero_is_scalar=int(mode in (1, 3)))
    return W_q, scales, zeros, JMeta(**fields, packing_bitwidth=32), LayerMeta(**fields)


def _x(rng, M, input_dtype):
    if input_dtype == DType.INT8:
        return rng.integers(-128, 128, size=(M, K)).astype(np.int8)
    return (rng.normal(size=(M, K)) * 0.1).astype(np.float32)


def _run_both(W_q, scales, zeros, jmeta, tmeta, x, sx):
    """(port plain, JAX pallas) outputs as float32 numpy."""
    mode, csm = tmeta.W_group_mode, tmeta.channel_scale_mode
    s_in = scales if mode in (2, 3, 4) or csm in (1, 3) else None
    z_in = zeros if mode in (1, 3, 4) else None
    sx_in = sx if csm in (2, 3) else None
    jx = jnp.asarray(x) if x.dtype == np.int8 else jnp.asarray(x, {
        DType.BF16.value: jnp.bfloat16, DType.FP16.value: jnp.float16,
        DType.FP32.value: jnp.float32}[tmeta.input_dtype])
    M = x.shape[0]
    cfg = select_default_config(jmeta, M, N, K)
    assert can_use_pallas(jmeta, M, N, K, cfg), cfg
    want = pallas_fused_matmul(jx, jnp.asarray(W_q), None if s_in is None else jnp.asarray(s_in),
                               None if z_in is None else jnp.asarray(z_in),
                               None if sx_in is None else jnp.asarray(sx_in), jmeta, cfg)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32)) if x.dtype != np.int8 else x)
    tx = tx.to({DType.BF16.value: torch.bfloat16, DType.FP16.value: torch.float16,
                DType.FP32.value: torch.float32, DType.INT8.value: torch.int8}[tmeta.input_dtype])

    def t(a):
        return None if a is None else tensor_from_numpy(np.asarray(a))

    assert can_use_fused(tmeta)
    got = fused_gemm(tx, t(W_q), t(s_in), t(z_in), t(sx_in), tmeta)
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


def _check(got, want, exact):
    if exact:
        assert np.array_equal(got, want)
    else:
        rel = float(np.mean(np.abs(got - want)) / (np.mean(np.abs(want)) + 1e-6))
        assert rel < REL, rel


@pytest.mark.parametrize("W_nbits,mode,csm", CASES)
def test_plain_matches_pallas_fused(W_nbits, mode, csm):
    rng = np.random.default_rng(W_nbits * 100 + mode * 10 + csm)
    input_dtype = DType.INT8 if mode in (0, 1) else DType.BF16
    W_q, scales, zeros, jmeta, tmeta = _case(W_nbits, mode, csm, input_dtype, rng)
    exact = int_path(tmeta)
    assert exact == (input_dtype == DType.INT8 and W_nbits < 8)
    for M in (65, 128):
        x = _x(rng, M, input_dtype)
        sx = (np.abs(rng.normal(size=(M, 1))) + 0.5).astype(np.float32)
        _check(*_run_both(W_q, scales, zeros, jmeta, tmeta, x, sx), exact)


@pytest.mark.parametrize("name", ["a16w8_fp16_post_scale", "a16w8_bf16_in_loop",
                                  "a8w8_nonpacked_int_path", "w4_fp32", "w16_bf16"])
def test_plain_matches_pallas_fused_other_forms(name):
    """Non-packed int8 and bf16 weights, fp16 and float32 x."""
    rng = np.random.default_rng(len(name))
    w8 = rng.integers(-100, 100, size=(N, K)).astype(np.int8)
    input_dtype, W_nbits, mode, csm, w_np = {
        "a16w8_fp16_post_scale": (DType.FP16, 8, 0, 1, w8),
        "a16w8_bf16_in_loop": (DType.BF16, 8, 2, 0, w8),
        "a8w8_nonpacked_int_path": (DType.INT8, 8, 0, 3, w8),
        "w4_fp32": (DType.FP32, 4, 4, 0, None),
        "w16_bf16": (DType.BF16, 16, 0, 1,
                     (rng.normal(size=(N, K)) * 0.05).astype(jnp.bfloat16))}[name]
    W_q, scales, zeros, jmeta, tmeta = _case(W_nbits, mode, csm, input_dtype, rng, w_np)
    if mode == 2:                         # A16W8 in-loop: channel scales as (1, N) groups
        scales = np.abs(scales[:1]) * 0.1
        jmeta = jmeta._replace(group_size=K)
        tmeta = tmeta._replace(group_size=K)
    for M in (65, 128):
        x = _x(rng, M, input_dtype)
        sx = (np.abs(rng.normal(size=(M, 1))) + 0.5).astype(np.float32)
        _check(*_run_both(W_q, scales, zeros, jmeta, tmeta, x, sx), int_path(tmeta))


def test_dispatch_routes_float_fallback_layers_to_general_fused():
    """Layers the W4 kernels do not take (here A16W8 in-loop, bf16) route to
    the general fused kernel at every M below 4096."""
    from gemlite_tpu_torch.helper import A16W8_INT8
    w = torch.from_numpy((np.random.default_rng(0).normal(size=(N, K)) * 0.05).astype(np.float32))
    layer = A16W8_INT8(device="cpu", dtype=torch.bfloat16).from_weights(w)
    dispatch.KERNEL_TRACE.clear()
    for M in (1, 64, 65, 4096):
        layer(torch.zeros((M, K), dtype=torch.bfloat16))
    assert dispatch.KERNEL_TRACE == ["plain_general_fused"] * 3 + ["plain_dense_fallback"]
