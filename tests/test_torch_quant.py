# SPDX-License-Identifier: Apache-2.0
"""The port's grouped INT quantizer against gemlite_tpu.quant (CPU).

Codes must be equal: the differing fraction is held at 0 on the seeded
(256, 512) matrix. Both sides compute in float32, numpy and torch sum the
group means in different orders, so scales and zeros agree to float32
rounding (rtol 1e-5); on other seeds a code can flip where a group's
refit lands on a rounding tie (seen: 1 code in 131072, seed 2, W4 gs=128).
"""

import numpy as np
import pytest
import torch

from gemlite_tpu.quant import quantize_int_weights as jax_quantize
from gemlite_tpu_torch.helper import A16W4_HQQ_INT
from gemlite_tpu_torch.quant import quantize_int_weights


@pytest.mark.parametrize("W_nbits,gs", [(4, 128), (4, 64), (2, 32), (8, 128)])
def test_codes_equal_jax(W_nbits, gs):
    w = (np.random.default_rng(0).normal(size=(256, 512)) * 0.02).astype(np.float32)
    jq, js, jz = jax_quantize(w, W_nbits, gs)
    tq, ts, tz = quantize_int_weights(torch.from_numpy(w), W_nbits, gs)
    differing = float((np.asarray(jq) != tq.numpy()).mean())
    assert differing == 0.0, differing
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-5)
    np.testing.assert_allclose(tz.numpy(), jz, rtol=1e-5, atol=1e-5)


def test_clip_grid_codes_equal_jax():
    w = (np.random.default_rng(1).normal(size=(128, 256)) * 0.02).astype(np.float32)
    grid = (1.0, 0.9, 0.8)
    jq, _, _ = jax_quantize(w, 2, 64, clip_grid=grid)
    tq, _, _ = quantize_int_weights(torch.from_numpy(w), 2, 64, clip_grid=grid)
    assert np.array_equal(np.asarray(jq), tq.numpy())


def test_processor_dequantizes_close_to_float():
    w = torch.from_numpy((np.random.default_rng(2).normal(size=(128, 256)) * 0.02)
                         .astype(np.float32))
    layer = A16W4_HQQ_INT(device="cpu", dtype=torch.bfloat16).from_float_weights(w, group_size=64)
    assert layer.W_group_mode == 4 and layer.meta_dtype.name == "BF16"
    x = torch.eye(256, dtype=torch.bfloat16)
    w_hat = layer(x).float().T            # (N, K) dequantized weight
    err = (w_hat - w).abs().mean() / w.abs().mean()
    assert err < 0.15, float(err)
