# SPDX-License-Identifier: Apache-2.0
"""The port's grouped INT quantizer against gemlite_tpu.quant (CPU).

Both compute in float32, and the port's row means add in numpy's pairwise
order (``quant._row_mean``: numpy's own call on the CPU, an emulation in
torch ops on the card), so codes, scales and zeros are equal bit for
bit (tests/test_torch_real_weights.py holds the same on the trained
checkpoint, whose channel-wise W8 rows of 256 and 768 once rounded apart).
"""

import numpy as np
import pytest
import torch

from gemlite_tpu.quant import quantize_int_weights as jax_quantize
from gemlite_tpu_torch.helper import A16W4_HQQ_INT
from gemlite_tpu_torch.quant import _row_mean, _row_mean_emulated, quantize_int_weights


@pytest.mark.parametrize("W_nbits,gs", [(4, 128), (4, 64), (2, 32), (8, 128)])
def test_codes_equal_jax(W_nbits, gs):
    w = (np.random.default_rng(0).normal(size=(256, 512)) * 0.02).astype(np.float32)
    jq, js, jz = jax_quantize(w, W_nbits, gs)
    tq, ts, tz = quantize_int_weights(torch.from_numpy(w), W_nbits, gs)
    differing = float((np.asarray(jq) != tq.numpy()).mean())
    assert differing == 0.0, differing
    assert np.array_equal(ts.numpy(), js) and np.array_equal(tz.numpy(), jz)


def test_clip_grid_codes_equal_jax():
    w = (np.random.default_rng(1).normal(size=(128, 256)) * 0.02).astype(np.float32)
    grid = (1.0, 0.9, 0.8)
    jq, js, jz = jax_quantize(w, 2, 64, clip_grid=grid)
    tq, ts, tz = quantize_int_weights(torch.from_numpy(w), 2, 64, clip_grid=grid)
    assert np.array_equal(np.asarray(jq), tq.numpy())
    assert np.array_equal(ts.numpy(), js) and np.array_equal(tz.numpy(), jz)


@pytest.mark.parametrize("n", [1, 3, 8, 13, 64, 100, 128, 129, 256, 768, 1000, 8192, 8200, 14336])
def test_row_mean_is_numpys(n):
    """The emulation the card runs, on rows below 8, tails after the 8-wide
    blocks, the pairwise split above 128 (halves of equal length and not),
    and the 8192-long chunks of numpy's reduction buffer; and the CPU path."""
    rng = np.random.default_rng(n)
    a = (rng.normal(size=(64, n)) * rng.uniform(0.01, 10.0, size=(64, 1))).astype(np.float32)
    want = np.mean(a, axis=1, keepdims=True)
    assert np.array_equal(_row_mean_emulated(torch.from_numpy(a)).numpy(), want)
    assert np.array_equal(_row_mean(torch.from_numpy(a)).numpy(), want)


def test_processor_dequantizes_close_to_float():
    w = torch.from_numpy((np.random.default_rng(2).normal(size=(128, 256)) * 0.02)
                         .astype(np.float32))
    layer = A16W4_HQQ_INT(device="cpu", dtype=torch.bfloat16).from_float_weights(w, group_size=64)
    assert layer.W_group_mode == 4 and layer.meta_dtype.name == "BF16"
    x = torch.eye(256, dtype=torch.bfloat16)
    w_hat = layer(x).float().T            # (N, K) dequantized weight
    err = (w_hat - w).abs().mean() / w.abs().mean()
    assert err < 0.15, float(err)
