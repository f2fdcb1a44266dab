# SPDX-License-Identifier: Apache-2.0
"""The three CUDA kernels against their plain versions, on the card.

Card-only: each test skips where no CUDA device is present. On the card:

    python -m pytest --noconftest -m requires_cuda tests/test_torch_kernels.py -q

(``--noconftest``: the suite's conftest sets JAX up, which the card's machine
does not need.) Tolerance: max|a-b| / max|b| <= 5e-3 against the plain
version's float32 result, the JAX kernel tests' bound.
"""

import pytest
import torch

from gemlite_tpu_torch import (ContinuousBatchingEngine, DType, GemLiteLinear, LlamaConfig,
                               init_llama, quantize_llama)
from gemlite_tpu_torch.ops import dispatch
from gemlite_tpu_torch.ops.decode import decode_matmul
from gemlite_tpu_torch.ops.dequantize import dequantize_full, dequantize_weights
from gemlite_tpu_torch.ops.prefill import prefill_matmul
from gemlite_tpu_torch.ops.reference import forward_meta

pytestmark = pytest.mark.requires_cuda
REL = 5e-3


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _layer(gen, N, K, gs=128, fma=True):
    W_q = torch.randint(0, 16, (N, K), generator=gen, device="cuda", dtype=torch.uint8)
    G = N * K // gs
    scales = (torch.rand((G, 1), generator=gen, device="cuda") * 2e-2 + 1e-2).to(torch.bfloat16)
    zeros = torch.randint(0, 16, (G, 1), generator=gen, device="cuda").to(torch.bfloat16)
    return GemLiteLinear(4, gs, K, N, DType.BF16, DType.BF16, device="cuda").pack(
        W_q, scales, zeros, fma_mode=fma)


def _x(gen, M, K):
    return (torch.randn((M, K), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)


def _plain_f32(layer, x):
    return forward_meta(x, layer.W_q, layer.scales, layer.zeros, None,
                        layer.meta._replace(output_dtype=DType.FP32.value))


def _rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


@pytest.mark.parametrize("N,K", [(256, 512), (200, 256), (1024, 4096)])
@pytest.mark.parametrize("M", [1, 3, 8, 33, 64])
def test_decode_kernel(gen, M, N, K):
    layer = _layer(gen, N, K)
    x = _x(gen, M, K)
    got = decode_matmul(x, layer.W_q, layer.scales, layer.zeros, layer.meta)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert _rel(got, _plain_f32(layer, x)) <= REL


def test_decode_rows_do_not_depend_on_batch(gen):
    """A row's sum runs in the same order at any M, and repeats bit for bit."""
    layer = _layer(gen, 512, 1024)
    x = _x(gen, 8, 1024)
    args = (layer.W_q, layer.scales, layer.zeros, layer.meta)
    full = decode_matmul(x, *args)
    assert torch.equal(decode_matmul(x[:1], *args)[0], full[0])
    assert torch.equal(decode_matmul(x, *args), full)


@pytest.mark.parametrize("N,K", [(256, 512), (200, 256), (4096, 1024)])
@pytest.mark.parametrize("M", [65, 128, 200, 1000])
def test_prefill_kernel(gen, M, N, K):
    layer = _layer(gen, N, K)
    x = _x(gen, M, K)
    got = prefill_matmul(x, layer.W_q, layer.scales, layer.zeros, layer.meta)
    torch.cuda.synchronize()
    assert got.shape == (M, N)
    assert _rel(got, _plain_f32(layer, x)) <= REL


@pytest.mark.parametrize("N,K", [(256, 512), (200, 256)])
def test_dequantize_kernel_is_exact(gen, N, K):
    layer = _layer(gen, N, K)
    args = (layer.W_q, layer.scales, layer.zeros, layer.meta)
    assert torch.equal(dequantize_weights(*args), dequantize_full(*args))


def test_routes_and_no_fallback(gen):
    layer = _layer(gen, 256, 512)
    dispatch.KERNEL_TRACE.clear()
    for M in (1, 64, 65, 4096):
        layer(_x(gen, M, 512))
    assert dispatch.KERNEL_TRACE == ["decode", "decode", "prefill", "dequantize"]
    mode3 = _layer(gen, 256, 512, fma=False)
    with pytest.raises(NotImplementedError, match="queued"):
        mode3(_x(gen, 4, 512))


def test_engine_runs_on_the_kernels(gen):
    """A tiny model served on the card: every linear on a kernel (the engine
    raises otherwise), a 70-token prompt on the prefill kernel."""
    cfg = LlamaConfig.tiny()
    params = quantize_llama(init_llama(cfg, seed=0, device="cuda"), group_size=64,
                            device="cuda")
    before = (decode_matmul.launches, prefill_matmul.launches)
    eng = ContinuousBatchingEngine(params, cfg, max_batch=2, prefill_buckets=(32, 64, 128),
                                   device="cuda")
    out = eng.generate([[1, 2, 3, 4, 5], list(range(7, 77))], max_new_tokens=4)
    assert [len(o) for o in out] == [4, 4]
    assert decode_matmul.launches > before[0] and prefill_matmul.launches > before[1]
