# SPDX-License-Identifier: Apache-2.0
"""The CUDA kernels against their plain versions, on the card.

Card-only: each test skips where no CUDA device is present. On the card:

    python -m pytest --noconftest -m requires_cuda tests/test_torch_kernels.py -q

(``--noconftest``: the suite's conftest sets JAX up, which the card's machine
does not need.) Tolerance: max|a-b| / max|b| <= 5e-3 against the plain
version's float32 result, the JAX kernel tests' bound; the int8 decode kernel
and the general fused kernel's int path equal their plain versions bit for bit.
"""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gemlite_tpu_torch import (ContinuousBatchingEngine, DType, GemLiteLinear, LlamaConfig,
                               init_llama, quantize_llama)
from gemlite_tpu_torch.helper import (A16W158_INT, A16W8_INT8, A8W158_INT_dynamic,
                                      A8W8_INT8_dynamic)
from gemlite_tpu_torch.ops import attention, build, dispatch
from gemlite_tpu_torch.ops.decode import decode_matmul
from gemlite_tpu_torch.ops.dequantize import dequantize_full, dequantize_weights
from gemlite_tpu_torch.ops import fused
from gemlite_tpu_torch.ops.fused import (fused_gemm, fused_gemm_float, fused_matmul_plain, int_path,
                                         int_plan)
from gemlite_tpu_torch.ops import int8_decode as int8_mod
from gemlite_tpu_torch.ops.int8_decode import int8_decode, int8_decode_plain, int8_mma_tile
from gemlite_tpu_torch.ops.prefill import prefill_matmul
from gemlite_tpu_torch.ops.reference import forward_meta, int_matmul
from gemlite_tpu_torch.ops.scan import decode_matmul_stacked
from test_torch_float_plan import FLOAT_PATH_FORMS, float_layer, float_x, form_k

pytestmark = pytest.mark.requires_cuda
REL = 5e-3


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _layer(gen, N, K, gs=128, fma=True, bits=4):
    W_q = torch.randint(0, 2 ** bits, (N, K), generator=gen, device="cuda", dtype=torch.uint8)
    G = N * K // gs
    scales = (torch.rand((G, 1), generator=gen, device="cuda") * 2e-2 + 1e-2).to(torch.bfloat16)
    zeros = torch.randint(0, 2 ** bits, (G, 1), generator=gen, device="cuda").to(torch.bfloat16)
    return GemLiteLinear(bits, gs, K, N, DType.BF16, DType.BF16, device="cuda").pack(
        W_q, scales, zeros, fma_mode=fma)


def _x(gen, M, K):
    return (torch.randn((M, K), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)


def _plain_f32(layer, x):
    return forward_meta(x, layer.W_q, layer.scales, layer.zeros, None,
                        layer.meta._replace(output_dtype=DType.FP32.value))


def _rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def _split_state_is_zero(owner):
    """The int32 split state (accumulators, counters) a kernel leaves 0."""
    states = [ints for key, (ints, _) in build._SPLIT_STATE.items() if key[0] == owner]
    assert all(int(t.abs().sum()) == 0 for t in states)


def _one_call_allocs(fn):
    """(what one fn() returns, the allocations it made), after a synchronize."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    out = fn()
    return out, torch.cuda.memory_stats()["allocation.all.allocated"] - before


@pytest.mark.parametrize("N,K", [(256, 512), (200, 256), (1024, 4096), (14336, 4096),
                                 (4096, 14336)])
@pytest.mark.parametrize("M", [1, 3, 8, 16, 17, 33, 48, 64])
def test_decode_kernel(gen, M, N, K):
    layer = _layer(gen, N, K)
    x = _x(gen, M, K)
    got = decode_matmul(x, layer.W_q, layer.scales, layer.zeros, layer.meta)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert _rel(got, _plain_f32(layer, x)) <= REL


@pytest.mark.parametrize("N", [132, 130, 129])
@pytest.mark.parametrize("M", [1, 8, 64])
@pytest.mark.parametrize("bits", [1, 4])
def test_decode_kernel_ragged_columns(gen, bits, M, N):
    """Columns that are no multiple of 8 (scales in 4-byte pieces), of 4
    (words in 4-byte pieces) and odd (scales by plain loads)."""
    layer = _layer(gen, N, 256, gs=64, bits=bits)
    x = _x(gen, M, 256)
    got = decode_matmul(x, layer.W_q, layer.scales, layer.zeros, layer.meta)
    torch.cuda.synchronize()
    assert got.shape == (M, N)
    assert _rel(got, _plain_f32(layer, x)) <= REL


def test_decode_rows_do_not_depend_on_batch(gen):
    """A row's sum runs in the same order at any M, and repeats bit for bit."""
    layer = _layer(gen, 512, 1024)
    x = _x(gen, 8, 1024)
    args = (layer.W_q, layer.scales, layer.zeros, layer.meta)
    full = decode_matmul(x, *args)
    assert torch.equal(decode_matmul(x[:1], *args)[0], full[0])
    assert torch.equal(decode_matmul(x, *args), full)


@pytest.mark.parametrize("N,K", [(256, 512), (200, 256), (1024, 4096)])
@pytest.mark.parametrize("M", [1, 8, 64])
@pytest.mark.parametrize("bits", [1, 2])
def test_decode_kernel_w1_w2(gen, bits, M, N, K):
    layer = _layer(gen, N, K, bits=bits)
    x = _x(gen, M, K)
    got = decode_matmul(x, layer.W_q, layer.scales, layer.zeros, layer.meta)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert _rel(got, _plain_f32(layer, x)) <= REL


@pytest.mark.parametrize("bits,gs,K,splits", [
    (4, 16, 512, 2), (4, 128, 512, 2), (2, 16, 512, 2), (2, 64, 512, 2), (1, 32, 512, 2),
    (1, 128, 512, 2), (4, 24, 2304, 3), (4, 48, 2304, 3), (2, 96, 2304, 3)])
def test_decode_kernel_one_hot_rows_are_the_weights(gen, bits, gs, K, splits):
    """x rows e_k for every k (every code position of every word and every
    group): each output row is row k of the dequantized weights bit for bit,
    through the kernel's lane permutation, its bf16x2 dequantization and its
    split. Groups of 24, 48 and 96 do not divide the 128-deep stage, so
    stages start inside a group and hold up to 128 / gs + 2 group rows."""
    from gemlite_tpu_torch.ops import decode as dec
    from gemlite_tpu_torch.ops.reference import dequantize_ref, unpack_rows_ref
    N = 200
    layer = _layer(gen, N, K, gs=gs, bits=bits)
    assert dec.plan(64, N, K, gs, bits).splits == splits
    w = dequantize_ref(unpack_rows_ref(layer.W_q, bits, 32 // bits, K), layer.scales,
                       layer.zeros, W_group_mode=4, meta_dtype=DType.BF16)
    eye = torch.eye(K, dtype=torch.bfloat16, device="cuda")
    for k0 in range(0, K, 64):
        got = decode_matmul(eye[k0:k0 + 64], layer.W_q, layer.scales, layer.zeros, layer.meta)
        torch.cuda.synchronize()
        assert torch.equal(got.float(), w[k0:k0 + 64].float()), k0


@pytest.mark.parametrize("M", [1, 17, 64])
@pytest.mark.parametrize("bits,gs", [(4, 24), (4, 48), (2, 96), (1, 96)])
def test_decode_kernel_groups_across_stages(gen, bits, gs, M):
    """Groups that do not divide the 128-deep stage, over three K ranges and
    a ragged column tile: the kernel against the plain version."""
    layer = _layer(gen, 200, 2304, gs=gs, bits=bits)
    x = _x(gen, M, 2304)
    got = decode_matmul(x, layer.W_q, layer.scales, layer.zeros, layer.meta)
    torch.cuda.synchronize()
    assert got.shape == (M, 200)
    assert _rel(got, _plain_f32(layer, x)) <= REL


@pytest.mark.parametrize("M,N,K", [(8, 14336, 4096), (64, 14336, 4096), (1, 4096, 4096),
                                   (33, 4096, 14336), (17, 1024, 4096), (8, 200, 96)])
@pytest.mark.parametrize("stacked", [False, True])
def test_decode_launches_as_planned(gen, stacked, M, N, K):
    """One call of either entry: one kernel (no reduce launch, no memset),
    no allocation but the output, the split state left at 0."""
    from gemlite_tpu_torch.ops import decode as dec
    gs = 32 if K % 128 else 128
    layer = _layer(gen, N, K, gs=gs)
    x = _x(gen, M, K)
    if stacked:
        stacks = tuple(torch.stack([t, t]) for t in (layer.W_q, layer.scales, layer.zeros))
        idx = torch.ones((), dtype=torch.int32, device="cuda")

        def call():
            return decode_matmul_stacked(x, *stacks, layer.meta, idx)
    else:
        def call():
            return decode_matmul(x, layer.W_q, layer.scales, layer.zeros, layer.meta)
    p = dec.plan(M, N, K, gs, 4)
    want = call()                                         # builds, allocates the split state
    got, allocs = _one_call_allocs(lambda: [call()])
    device_ops = build.graph_ops(lambda: got.append(call()))
    assert len(device_ops) == p.launches == 1, device_ops
    assert allocs == 1                                    # the output alone
    assert all(torch.equal(g, want) for g in got)
    _split_state_is_zero("decode_gemv")


def _stack(gen, L, N, K, bits):
    layers = [_layer(gen, N, K, bits=bits) for _ in range(L)]
    return layers, tuple(torch.stack([getattr(l, a) for l in layers])
                         for a in ("W_q", "scales", "zeros"))


@pytest.mark.parametrize("M", [1, 8, 64])
@pytest.mark.parametrize("bits", [1, 2, 4])
def test_stacked_decode_kernel(gen, bits, M):
    """Layer l of the stack equals the per-layer kernel on layer l bit for
    bit, and its plain version within the bound."""
    L, N, K = 4, 1024, 4096
    layers, stacks = _stack(gen, L, N, K, bits)
    x = _x(gen, M, K)
    ids = torch.arange(L, dtype=torch.int32, device="cuda")
    for l, layer in enumerate(layers):
        got = decode_matmul_stacked(x, *stacks, layer.meta, ids[l])
        per_layer = decode_matmul(x, layer.W_q, layer.scales, layer.zeros, layer.meta)
        torch.cuda.synchronize()
        assert got.shape == (M, N) and torch.equal(got, per_layer), l
        assert _rel(got, _plain_f32(layer, x)) <= REL


@pytest.mark.parametrize("N", [6144, 28672])
def test_stacked_decode_kernel_fused_shapes(gen, N):
    """The fused wqkv (6144) and gate_up (28672) stacks of Llama-3-8B at K
    4096: each layer bit for bit the per-layer kernel, within the bound of
    its plain version."""
    L, K = 3, 4096
    layers, stacks = _stack(gen, L, N, K, 4)
    x = _x(gen, 8, K)
    ids = torch.arange(L, dtype=torch.int32, device="cuda")
    for l, layer in enumerate(layers):
        got = decode_matmul_stacked(x, *stacks, layer.meta, ids[l])
        per_layer = decode_matmul(x, layer.W_q, layer.scales, layer.zeros, layer.meta)
        torch.cuda.synchronize()
        assert got.shape == (8, N) and torch.equal(got, per_layer), l
        assert _rel(got, _plain_f32(layer, x)) <= REL


def test_stacked_decode_reads_no_index_on_the_host(gen):
    layers, stacks = _stack(gen, 3, 512, 1024, 4)
    x = _x(gen, 8, 1024)
    ids = torch.arange(3, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [decode_matmul_stacked(x, *stacks, layers[0].meta, ids[l]) for l in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for layer, out in zip(layers, outs):
        assert torch.equal(out, decode_matmul(x, layer.W_q, layer.scales, layer.zeros,
                                              layer.meta))


@pytest.mark.parametrize("N,K", [(256, 512), (200, 256), (4096, 1024)])
@pytest.mark.parametrize("M", [65, 128, 129, 200, 256, 1000, 1024, 2048, 4095])
def test_prefill_kernel(gen, M, N, K):
    layer = _layer(gen, N, K)
    x = _x(gen, M, K)
    got = prefill_matmul(x, layer.W_q, layer.scales, layer.zeros, layer.meta)
    torch.cuda.synchronize()
    assert got.shape == (M, N)
    assert _rel(got, _plain_f32(layer, x)) <= REL


@pytest.mark.parametrize("M", [128, 1024, 2048])
@pytest.mark.parametrize("N,K", [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336)])
def test_prefill_kernel_8b_shapes(gen, N, K, M):
    layer = _layer(gen, N, K)
    x = _x(gen, M, K)
    got = prefill_matmul(x, layer.W_q, layer.scales, layer.zeros, layer.meta)
    torch.cuda.synchronize()
    assert got.shape == (M, N)
    assert _rel(got, _plain_f32(layer, x)) <= REL


@pytest.mark.parametrize("M", [65, 300])
@pytest.mark.parametrize("N", [256, 200, 132, 130, 129, 1000])
@pytest.mark.parametrize("bits,gs", [(4, 64), (4, 256), (2, 64), (2, 256), (1, 64), (1, 256)])
def test_prefill_kernel_forms(gen, bits, gs, N, M):
    """W1/W2/W4, groups of 64 and 256 (a group row over one or four
    stages), and ragged columns: N 256, 200 and 1000 bring words and
    metadata by TMA (zeros past N), 132 by 16-byte (words) and 4-byte
    (metadata) cp.async pieces, 130 by 4-byte pieces, 129 (odd) by 4-byte
    words and 2-byte metadata loads."""
    K = 1024
    layer = _layer(gen, N, K, gs=gs, bits=bits)
    x = _x(gen, M, K)
    got = prefill_matmul(x, layer.W_q, layer.scales, layer.zeros, layer.meta)
    torch.cuda.synchronize()
    assert got.shape == (M, N)
    assert _rel(got, _plain_f32(layer, x)) <= REL


@pytest.mark.parametrize("bits,gs,K,N", [
    (4, 64, 1024, 200), (4, 128, 2048, 256), (2, 64, 1024, 129), (2, 256, 2048, 200),
    (1, 64, 1024, 200), (1, 128, 1024, 130)])
def test_prefill_kernel_one_hot_rows_are_the_weights(gen, bits, gs, K, N):
    """x rows e_k for every k (every code position of every word and every
    group), 128 rows a call: each output row is row k of the dequantized
    weights bit for bit, through the kernel's lanes, its bf16x2
    dequantization and its split."""
    from gemlite_tpu_torch.ops import prefill as pre
    from gemlite_tpu_torch.ops.reference import dequantize_ref, unpack_rows_ref
    layer = _layer(gen, N, K, gs=gs, bits=bits)
    assert pre.plan(128, N, K, gs, bits).splits > 1
    w = dequantize_ref(unpack_rows_ref(layer.W_q, bits, 32 // bits, K), layer.scales,
                       layer.zeros, W_group_mode=4, meta_dtype=DType.BF16)
    eye = torch.eye(K, dtype=torch.bfloat16, device="cuda")
    for k0 in range(0, K, 128):
        got = prefill_matmul(eye[k0:k0 + 128], layer.W_q, layer.scales, layer.zeros, layer.meta)
        torch.cuda.synchronize()
        assert torch.equal(got.float(), w[k0:k0 + 128].float()), k0


@pytest.mark.parametrize("M,N,K", [(128, 14336, 4096), (128, 4096, 14336), (128, 1024, 4096),
                                   (1024, 4096, 4096), (2048, 1024, 4096), (200, 200, 256)])
def test_prefill_launches_as_planned(gen, M, N, K):
    """One call: one kernel (no reduce launch, no memset), no allocation but
    the output, the split state left at 0."""
    from gemlite_tpu_torch.ops import prefill as pre
    layer = _layer(gen, N, K)
    x = _x(gen, M, K)

    def call():
        return prefill_matmul(x, layer.W_q, layer.scales, layer.zeros, layer.meta)
    p = pre.plan(M, N, K, 128, 4)
    want = call()                                         # builds, allocates the split state
    got, allocs = _one_call_allocs(lambda: [call()])
    device_ops = build.graph_ops(lambda: got.append(call()))
    assert len(device_ops) == p.launches == 1, device_ops
    assert allocs == 1                                    # the output alone
    assert all(torch.equal(g, want) for g in got)
    _split_state_is_zero("prefill_gemm")


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
    dispatch.KERNEL_TRACE.clear()
    mode3(_x(gen, 4, 512))
    mode3(_x(gen, 4096, 512))
    assert dispatch.KERNEL_TRACE == ["decode", "dequantize"]   # the mode 1-3 forms, as in JAX
    mode3.channel_scale_mode = 4          # MX activation scales on a non-MX layer
    with pytest.raises(NotImplementedError, match="csm 4 belongs to MX input dtypes"):
        mode3(_x(gen, 4, 512))


@pytest.mark.parametrize("bits", [1, 2])
def test_w1_w2_prefill_routes_to_the_kernel(gen, bits):
    """W1/W2 mode-4 layers at 64 < M < 4096 run on the prefill kernel, as
    the JAX router sends them to its prefill kernel."""
    layer = _layer(gen, 256, 512, bits=bits)
    before = prefill_matmul.launches
    dispatch.KERNEL_TRACE.clear()
    x = _x(gen, 65, 512)
    got = layer(x)
    assert dispatch.KERNEL_TRACE == ["prefill"]
    assert prefill_matmul.launches == before + 1
    assert _rel(got, _plain_f32(layer, x)) <= REL


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


def test_scan_engine_runs_on_the_stacked_kernel(gen):
    """scan_layers=True on the card: every decode step on the stacked kernel,
    the tokens those of the unrolled engine."""
    cfg = LlamaConfig.tiny()
    params = quantize_llama(init_llama(cfg, seed=0, device="cuda"), group_size=64,
                            device="cuda")
    prompts = [[1, 2, 3, 4, 5], list(range(7, 40))]
    kw = dict(max_batch=2, paged=False, prefill_buckets=(32, 64, 128), device="cuda")
    want = ContinuousBatchingEngine(params, cfg, **kw).generate(prompts, max_new_tokens=4)
    before = decode_matmul_stacked.launches
    eng = ContinuousBatchingEngine(params, cfg, scan_layers=True, **kw)
    assert eng.generate(prompts, max_new_tokens=4) == want
    assert decode_matmul_stacked.launches == before + 7 * cfg.num_layers * \
        eng.stats()["decode_steps"]


# ---------------------------------------------------------------------------
# the int8 decode kernel and the general fused kernel
# ---------------------------------------------------------------------------

def _int8_layer(gen, name, N, K):
    """An INT8-activation layer of one weight form, packed on the card."""
    if name == "i8_dense":
        w = torch.randn((N, K), generator=gen, device="cuda") * 0.05
        return A8W8_INT8_dynamic(device="cuda", dtype=torch.bfloat16).from_weights(w)
    if name == "w2_bitnet_cw":
        w = torch.randint(-1, 2, (N, K), generator=gen, device="cuda").float()
        return A8W158_INT_dynamic(device="cuda", dtype=torch.bfloat16).from_weights(w, 0.01)
    if name == "w4_cw_mode0":                            # W4 codes, no zero, channel scales
        codes = torch.randint(0, 16, (N, K), generator=gen, device="cuda").to(torch.uint8)
        scales = torch.rand((N, 1), generator=gen, device="cuda") * 2.0 ** -9 + 2.0 ** -10
        return GemLiteLinear(4, None, K, N, DType.INT8, DType.BF16, scaled_activations=True,
                             device="cuda").pack(codes, scales, None)
    nbits, gs, zk = {"u8_scalar_zero": (8, None, "scalar"), "u8_channel_zeros": (8, None, "channel"),
                     "u8_group_zeros": (8, 128, "group"), "w4_group_zeros": (4, 128, "group")}[name]
    codes = torch.randint(0, 2 ** nbits, (N, K), generator=gen, device="cuda").to(torch.uint8)
    G = 1 if gs is None else K // gs
    scales = torch.rand((N, G), generator=gen, device="cuda") * 2.0 ** -9 + 2.0 ** -10
    z = {"scalar": 128,
         "channel": torch.randint(0, 256, (N, 1), generator=gen, device="cuda").float(),
         "group": torch.randint(0, 2 ** nbits, (N, G), generator=gen, device="cuda").float()}[zk]
    return GemLiteLinear(nbits, gs, K, N, DType.INT8, DType.BF16, scaled_activations=True,
                         device="cuda").pack(codes, scales, z, fma_mode=False)


INT8_FORMS = ("i8_dense", "u8_scalar_zero", "u8_channel_zeros", "u8_group_zeros",
              "w4_group_zeros", "w2_bitnet_cw")


def _xq(gen, M, K):
    x = torch.randint(-128, 128, (M, K), generator=gen, device="cuda").to(torch.int8)
    sx = torch.rand((M, 1), generator=gen, device="cuda") * 2.0 ** -7 + 2.0 ** -8
    return x, sx


@pytest.mark.parametrize("N,K", [(256, 512), (1024, 4096), (4096, 14336)])
@pytest.mark.parametrize("M", [1, 3, 8, 16, 17, 33, 48, 64])
@pytest.mark.parametrize("name", INT8_FORMS)
def test_int8_decode_kernel_is_bit_exact(gen, name, M, N, K):
    """Integer sums, and float group sums in the plain version's order."""
    layer = _int8_layer(gen, name, N, K)
    x, sx = _xq(gen, M, K)
    args = (x, layer.W_q, layer.scales, layer.zeros, sx, layer.meta)
    got = int8_decode(*args)
    torch.cuda.synchronize()
    assert got.shape == (M, N) and torch.equal(got, int8_decode_plain(*args))


# groups that are not whole 32-deep mma steps: 16 and 48 take m16n8k16, 20
# and 24 the __dp4a step (ops/int8_decode.plan's sk)
ODD_GROUPS = [(8, 16, 512), (4, 16, 512), (2, 16, 512), (8, 48, 768), (8, 20, 640), (4, 24, 768)]


@pytest.mark.parametrize("nbits,gs,K", ODD_GROUPS)
@pytest.mark.parametrize("M", [1, 8, 17, 64])
def test_int8_decode_kernel_odd_groups_are_bit_exact(gen, nbits, gs, K, M):
    N = 256
    codes = torch.randint(0, 2 ** nbits, (N, K), generator=gen, device="cuda").to(torch.uint8)
    scales = torch.rand((N, K // gs), generator=gen, device="cuda") * 2.0 ** -9 + 2.0 ** -10
    z = torch.randint(0, 2 ** nbits, (N, K // gs), generator=gen, device="cuda").float()
    layer = GemLiteLinear(nbits, gs, K, N, DType.INT8, DType.BF16, scaled_activations=True,
                          device="cuda").pack(codes, scales, z, fma_mode=False)
    f = int8_mod.form(layer.meta, layer.scales, layer.zeros)
    assert f.gs_loop == gs and int8_mod.can_use_int8_decode(layer.meta, M)
    assert int8_mod.plan(M, N, K, gs, f.float_groups).sk == (16 if gs % 16 == 0 else 4)
    x, sx = _xq(gen, M, K)
    args = (x, layer.W_q, layer.scales, layer.zeros, sx, layer.meta)
    got = int8_decode(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, int8_decode_plain(*args))


@pytest.mark.parametrize("sk", [32, 16, 4])
def test_int8_mma_tile(gen, sk):
    """The swapped operands on one tile: A a 16-column x 32-k tile of W
    (turned K-major in shared memory), B an 8-row x 32-k tile of x, and the
    fragment's (column, row) mapping, against torch."""
    w = torch.randint(-128, 128, (32, 16), generator=gen, device="cuda").to(torch.int8)
    x = torch.randint(-128, 128, (8, 32), generator=gen, device="cuda").to(torch.int8)
    got = int8_mma_tile(w, x, sk)
    torch.cuda.synchronize()
    assert torch.equal(got, int_matmul(x, w))


@pytest.mark.parametrize("name,M,N,K", [("i8_dense", 8, 14336, 4096), ("i8_dense", 64, 4096, 4096),
                                        ("i8_dense", 1, 1024, 4096), ("i8_dense", 64, 4096, 14336),
                                        ("u8_group_zeros", 8, 4096, 4096),
                                        ("w4_group_zeros", 64, 1024, 4096)])
def test_int8_decode_launches_as_planned(gen, name, M, N, K):
    """One call: one kernel (no memset, no epilogue launch), no allocation but
    the output, and the split sums and arrival counters left at 0."""
    layer = _int8_layer(gen, name, N, K)
    x, sx = _xq(gen, M, K)
    args = (x, layer.W_q, layer.scales, layer.zeros, sx, layer.meta)
    f = int8_mod.form(layer.meta, layer.scales, layer.zeros)
    p = int8_mod.plan(M, N, K, f.gs_loop, f.float_groups)
    want = int8_decode(*args)                             # builds, allocates the split state
    torch.cuda.synchronize()
    got, allocs = _one_call_allocs(lambda: [int8_decode(*args)])
    device_ops = build.graph_ops(lambda: got.append(int8_decode(*args)))
    assert len(device_ops) == p.launches == 1, device_ops
    assert allocs == 1                                    # the output alone
    assert all(torch.equal(g, want) for g in got)
    _split_state_is_zero("int8_decode")


def test_int8_decode_rows_do_not_depend_on_batch(gen):
    layer = _int8_layer(gen, "w4_group_zeros", 512, 1024)
    x, sx = _xq(gen, 8, 1024)
    args = (layer.W_q, layer.scales, layer.zeros)
    full = int8_decode(x, *args, sx, layer.meta)
    assert torch.equal(int8_decode(x[:1], *args, sx[:1], layer.meta)[0], full[0])


INT_PATH_FORMS = ("i8_dense", "w2_bitnet_cw", "w4_cw_mode0", "w1_cw_mode0", "f16_whole",
                  "bf16_whole")
# the int path's plan edges (ops/fused.int_plan): 112 tiles and no split
# (14336 x 4096), 16 splits (1024 x 4096), a K that is no multiple of the
# 128-deep step, split into ranges whose last is short (352 = 2 x 128 + 96),
# M = 4095 (32 row tiles), and N that leaves the weight rows 4-byte or
# 1-byte aligned (200, 101)
INT_PATH_CASES = ([(M, N, K) for N, K in ((256, 512), (200, 256), (4096, 1024), (256, 96))
                   for M in (1, 65, 128, 200, 1000)]
                  + [(128, 14336, 4096), (128, 1024, 4096), (65, 4096, 352), (300, 200, 4064),
                     (4095, 1024, 4096), (70, 101, 256)])


def _int_path_layer(gen, name, N, K):
    """_int8_layer, plus W1 codes without a zero and non-packed fp16 / bf16
    weights holding whole values (int8 x, int32 sums)."""
    if name == "w1_cw_mode0":
        codes = torch.randint(0, 2, (N, K), generator=gen, device="cuda").to(torch.uint8)
        scales = torch.rand((N, 1), generator=gen, device="cuda") * 2.0 ** -9 + 2.0 ** -10
        return GemLiteLinear(1, None, K, N, DType.INT8, DType.BF16, scaled_activations=True,
                             device="cuda").pack(codes, scales, None)
    if name in ("f16_whole", "bf16_whole"):
        layer = _int8_layer(gen, "i8_dense", N, K)
        dtype = torch.float16 if name == "f16_whole" else torch.bfloat16
        return SimpleNamespace(W_q=layer.W_q.to(dtype), scales=layer.scales, zeros=layer.zeros,
                               meta=layer.meta._replace(W_nbits=16))
    return _int8_layer(gen, name, N, K)


@pytest.mark.parametrize("M,N,K", INT_PATH_CASES)
@pytest.mark.parametrize("name", INT_PATH_FORMS)
def test_fused_kernel_int_path_is_bit_exact(gen, name, M, N, K):
    """Non-packed int8, fp16 and bf16 weights, and packed W1/W2/W4 codes with
    and without the scalar-zero shift; ragged M, N and K, and every kind of
    plan: one launch whatever the split."""
    layer = _int_path_layer(gen, name, N, K)
    assert int_path(layer.meta)
    x, sx = _xq(gen, M, K)
    args = (x, layer.W_q, layer.scales, layer.zeros, sx, layer.meta)
    got = fused_gemm(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, fused_matmul_plain(*args))


@pytest.mark.parametrize("M,N,K", [(128, 14336, 4096), (1024, 4096, 4096), (128, 1024, 4096),
                                   (128, 4096, 14336)])
def test_fused_kernel_int_path_launches_as_planned(gen, M, N, K):
    """One call: the planned launches (one kernel, no memset, no second
    pass), no allocation but the output, and the split accumulator and
    arrival counters left at 0."""
    layer = _int8_layer(gen, "i8_dense", N, K)
    x, sx = _xq(gen, M, K)
    args = (x, layer.W_q, layer.scales, layer.zeros, sx, layer.meta)
    plan = int_plan(M, N, K)
    want = fused_gemm(*args)                              # builds, allocates the split state
    torch.cuda.synchronize()
    got, allocs = _one_call_allocs(lambda: [fused_gemm(*args)])
    device_ops = build.graph_ops(lambda: got.append(fused_gemm(*args)))
    assert len(device_ops) == plan.launches == 1, device_ops
    assert allocs == 1                                    # the output alone
    assert all(torch.equal(g, want) for g in got)
    _split_state_is_zero("fused_gemm")


def _float_layer(gen, name, N, K):
    w = torch.randn((N, K), generator=gen, device="cuda") * 0.05
    if name == "a16w8_post_scale":
        return A16W8_INT8(device="cuda", dtype=torch.bfloat16, post_scale=True).from_weights(w)
    if name == "a16w8_in_loop_fp16":
        return A16W8_INT8(device="cuda", dtype=torch.float16).from_weights(w)
    if name == "bitnet_bf16":
        w = torch.randint(-1, 2, (N, K), generator=gen, device="cuda").float()
        return A16W158_INT(device="cuda", dtype=torch.bfloat16).from_weights(w, 0.01)
    if name == "w4_fp32":
        layer = _layer(gen, N, K)
        return GemLiteLinear.from_state_dict(
            {**layer.state_dict(), "metadata": torch.tensor(
                [0, 4, 128, 15, 8, 0, 0, 0, 2, 0, 4, 1], dtype=torch.int32)}, device="cuda")
    return _layer(gen, N, K, fma=False)                  # W4 mode 3, bf16


@pytest.mark.parametrize("N,K", [(256, 512), (200, 256), (1024, 4096)])
@pytest.mark.parametrize("M", [1, 65, 300])
@pytest.mark.parametrize("name", ["a16w8_post_scale", "a16w8_in_loop_fp16", "bitnet_bf16",
                                  "w4_mode3", "w4_fp32"])
def test_fused_kernel_float_path(gen, name, M, N, K):
    layer = _float_layer(gen, name, N, K)
    x = (torch.randn((M, K), generator=gen, device="cuda") * 0.5).to(
        {0: torch.float32, 1: torch.float16, 2: torch.bfloat16}[layer.meta.input_dtype])
    args = (layer.W_q, layer.scales, layer.zeros, None)
    got = fused_gemm(x, *args, layer.meta)
    torch.cuda.synchronize()
    want = fused_matmul_plain(x, *args, layer.meta._replace(output_dtype=DType.FP32.value))
    assert got.shape == (M, N) and _rel(got, want) <= REL


def _float_case(name, M, N, K):
    """A float-path layer of the form on the card, x and its per-token scales."""
    K = form_k(name, K)
    rng = np.random.default_rng([M, N, K, FLOAT_PATH_FORMS.index(name)])
    layer = float_layer(name, N, K, rng, device="cuda")
    x, sx = float_x(rng, M, K, layer.meta, device="cuda")
    return layer, (x, layer.W_q, layer.scales, layer.zeros, sx)


def _float_check(layer, args):
    got = fused_gemm_float(*args, layer.meta)
    torch.cuda.synchronize()
    want = fused_matmul_plain(*args, layer.meta._replace(output_dtype=DType.FP32.value))
    assert got.shape == want.shape and got.dtype == fused.to_torch_dtype(layer.meta.output_dtype)
    assert _rel(got, want) <= REL


@pytest.mark.parametrize("M", [1, 8, 64, 65, 128, 1024, 4095])
@pytest.mark.parametrize("name", FLOAT_PATH_FORMS)
def test_fused_float_kernel(gen, name, M):
    """Every form of the float path (csrc/fused_float.cu): int8 / 16-bit /
    packed W1-W8 weights, modes 0-4, scalar and grouped zeros, groups that
    hold a lane's run, a step (gs 20) or neither (gs 18), fp16, int8 x; N 1000
    ends in a ragged column tile, K 1280 (1152) in five stages."""
    _float_check(*_float_case(name, M, 1000, 1280))


@pytest.mark.parametrize("N", [129, 130, 132, 200])
@pytest.mark.parametrize("M", [1, 8, 33, 128])
@pytest.mark.parametrize("name", ["a16w8_in_loop_bf16", "f16_weights_bf16x", "w4_gs32_mode4_bf16",
                                  "w1_gs64_mode4_fp16", "bitnet_w2_bf16"])
def test_fused_float_kernel_ragged_columns(gen, name, M, N):
    """Rows that are no multiple of 16 bytes (4-byte copies), of 4 (plain
    loads) and odd column counts (2-byte metadata loads, scalar stores)."""
    _float_check(*_float_case(name, M, N, 256))


@pytest.mark.parametrize("M", [1, 8, 64, 128, 1024])
@pytest.mark.parametrize("N,K", [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336)])
def test_fused_float_kernel_8b_shapes(gen, N, K, M):
    _float_check(*_float_case("a16w8_in_loop_bf16", M, N, K))


@pytest.mark.parametrize("name,M,N,K", [
    ("a16w8_in_loop_bf16", 8, 14336, 4096), ("a16w8_in_loop_bf16", 128, 14336, 4096),
    ("a16w8_in_loop_bf16", 64, 4096, 4096), ("a16w8_in_loop_bf16", 1024, 1024, 4096),
    ("w4_gs32_mode4_bf16", 8, 4096, 14336), ("bitnet_w2_bf16", 128, 1024, 4096),
    ("w4_int8x_mode3", 33, 1024, 1280), ("w8_gs18_mode4_bf16", 4095, 200, 1280)])
def test_fused_float_launches_as_planned(gen, name, M, N, K):
    """One call: one kernel (no memset, no merge launch), no allocation but
    the output, two calls equal bit for bit, the arrival counters left 0."""
    layer, args = _float_case(name, M, N, K)
    p = fused.float_plan(M, N, form_k(name, K))
    want = fused_gemm_float(*args, layer.meta)            # builds, allocates the split state
    torch.cuda.synchronize()
    got, allocs = _one_call_allocs(lambda: [fused_gemm_float(*args, layer.meta)])
    device_ops = build.graph_ops(lambda: got.append(fused_gemm_float(*args, layer.meta)))
    assert len(device_ops) == p.launches == 1, device_ops
    assert allocs == 1                                    # the output alone
    assert all(torch.equal(g, want) for g in got)
    _split_state_is_zero("fused_float")


def test_a16w8_routes_to_the_float_path(gen):
    """An A16W8 layer runs the float path at every M below 4096, as JAX's
    router sends it to its general kernel, and dense_fallback at 4096."""
    layer, _ = _float_case("a16w8_in_loop_bf16", 1, 512, 1024)
    before = fused_gemm_float.launches
    dispatch.KERNEL_TRACE.clear()
    for M in (1, 8, 64, 65, 4095, 4096):
        layer(_x(gen, M, 1024))
    assert dispatch.KERNEL_TRACE == ["general_fused"] * 5 + ["dense_fallback"]
    assert fused_gemm_float.launches == before + 5


def test_a16w8_engine_runs_on_the_float_path(gen):
    """A tiny A16W8 model served on the card: every linear on the float
    path, short and long prompts and decode."""
    cfg = LlamaConfig.tiny()
    params = quantize_llama(init_llama(cfg, seed=0, device="cuda"),
                            processor=A16W8_INT8(device="cuda", dtype=torch.bfloat16))
    before = fused_gemm_float.launches
    eng = ContinuousBatchingEngine(params, cfg, max_batch=2, prefill_buckets=(32, 64, 128),
                                   device="cuda")
    out = eng.generate([[1, 2, 3, 4, 5], list(range(7, 77))], max_new_tokens=4)
    assert [len(o) for o in out] == [4, 4]
    assert fused_gemm_float.launches - before == 7 * cfg.num_layers * (2 + eng.stats()["decode_steps"])


def test_a8w8_engine_runs_on_the_kernels(gen):
    """A tiny A8W8 model served on the card: short prompts and decode on the
    int8 decode kernel, a 70-token prompt on the general fused kernel."""
    cfg = LlamaConfig.tiny()
    params = quantize_llama(init_llama(cfg, seed=0, device="cuda"),
                            processor=A8W8_INT8_dynamic(device="cuda", dtype=torch.bfloat16))
    before = (int8_decode.launches, fused_gemm.launches)
    eng = ContinuousBatchingEngine(params, cfg, max_batch=2, prefill_buckets=(32, 64, 128),
                                   device="cuda")
    out = eng.generate([[1, 2, 3, 4, 5], list(range(7, 77))], max_new_tokens=4)
    assert [len(o) for o in out] == [4, 4]
    assert int8_decode.launches > before[0] and fused_gemm.launches > before[1]


# ---------------------------------------------------------------------------
# the attention kernels: causal flash prefill and paged decode
# ---------------------------------------------------------------------------

def _attn_in(gen, shape):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("B,S,Hq,Hkv", [(1, 256, 4, 2), (1, 1024, 4, 1), (2, 2048, 2, 2),
                                        (1, 64, 8, 2), (1, 4096, 4, 2), (2, 384, 8, 1),
                                        (1, 192, 4, 2)])
def test_flash_kernel(gen, B, S, Hq, Hkv, D):
    """S 64 and 192 end in a half tile of 64 query rows."""
    q, k, v = (_attn_in(gen, (B, S, h, D)) for h in (Hq, Hkv, Hkv))
    got = attention.flash_attention_causal(q, k, v)
    torch.cuda.synchronize()
    want = attention.causal_attention_plain(q.float(), k.float(), v.float())
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, Hq, D)
    assert _rel(got, want) <= REL


@pytest.mark.parametrize("D", [64, 128])
def test_flash_qk_tile(gen, D):
    """Q Kᵀ alone on one tile: TMA's 128-byte swizzle and the K-major wgmma
    descriptors of Q and K (float32 sums of bf16 products, in another order)."""
    q, k = _attn_in(gen, (128, D)), _attn_in(gen, (128, D))
    got = attention.flash_qk_tile(q, k)
    torch.cuda.synchronize()
    assert _rel(got, q.float() @ k.float().T) <= 1e-5


@pytest.mark.parametrize("D", [64, 128])
def test_flash_pv_tile(gen, D):
    """P V alone on one tile: P from the accumulator fragment in registers as
    bf16 high and low parts, V read as stored through the MN-major
    (transposed) B descriptor. The two parts keep about 16 bits of P."""
    p = torch.rand((128, 128), generator=gen, device="cuda")
    v = _attn_in(gen, (128, D))
    got = attention.flash_pv_tile(p, v)
    torch.cuda.synchronize()
    assert _rel(got, p @ v.float()) <= 1e-4


def test_flash_kernel_is_deterministic(gen):
    q, k, v = (_attn_in(gen, (1, 1024, h, 128)) for h in (8, 2, 2))
    a = attention.flash_attention_causal(q, k, v)
    assert torch.equal(attention.flash_attention_causal(q, k, v), a)


def _paged_case(gen, lengths, ps, Hq, Hkv, D, pps):
    """Pages with a trash page 0 and each slot's pages at shuffled ids."""
    B = len(lengths)
    P = B * pps + 1
    k_pages, v_pages = (_attn_in(gen, (Hkv, P, ps, D)) for _ in range(2))
    perm = torch.randperm(B * pps, generator=gen, device="cuda") + 1
    table = perm.reshape(B, pps).to(torch.int32)
    q = _attn_in(gen, (B, Hq, D))
    return q, k_pages, v_pages, torch.tensor(lengths, dtype=torch.int32, device="cuda"), table


PAGED_LENGTHS = [1, 127, 128, 129, 500, 1000, 1500, 2047]


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("ps,pps,Hq,Hkv", [(128, 16, 8, 2), (16, 128, 4, 4), (128, 16, 8, 1)])
def test_paged_decode_kernel(gen, ps, pps, Hq, Hkv, D):
    args = _paged_case(gen, PAGED_LENGTHS, ps, Hq, Hkv, D, pps)
    got = attention.paged_decode_attention_kernel(*args)
    torch.cuda.synchronize()
    q, k_pages, v_pages, lengths, table = args
    want = attention.paged_decode_attention_plain(q.float(), k_pages.float(), v_pages.float(),
                                                  lengths, table)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert _rel(got, want) <= REL


def test_paged_decode_rows_do_not_depend_on_batch_or_page_ids(gen):
    """A slot's result is the same bits alone, in a batch, and with its
    pages moved to other ids."""
    q, k_pages, v_pages, lengths, table = _paged_case(gen, PAGED_LENGTHS, 128, 8, 2, 128, 16)
    full = attention.paged_decode_attention_kernel(q, k_pages, v_pages, lengths, table)
    b = 6
    moved = table[b:b + 1].flip(1).contiguous()          # the same pages, other ids
    k2, v2 = k_pages.clone(), v_pages.clone()
    k2[:, moved[0].long()] = k_pages[:, table[b].long()]
    v2[:, moved[0].long()] = v_pages[:, table[b].long()]
    alone = attention.paged_decode_attention_kernel(q[b:b + 1], k2, v2, lengths[b:b + 1], moved)
    assert torch.equal(alone[0], full[b])
    assert torch.equal(attention.paged_decode_attention_kernel(q, k_pages, v_pages, lengths,
                                                               table), full)


@pytest.mark.parametrize("lengths,pps", [(PAGED_LENGTHS, 16), ([1, 5, 60, 128], 16),
                                         ([1, 3000, 8191, 700], 64)])
def test_paged_decode_launches_as_planned(gen, lengths, pps):
    """One call: one kernel (no combine launch), whether a slot fits one split
    or spans several, no allocation but the output, and the arrival counters
    left at 0."""
    args = _paged_case(gen, lengths, 128, 8, 2, 128, pps)
    want = attention.paged_decode_attention_kernel(*args)   # builds, allocates the split state
    torch.cuda.synchronize()
    got, allocs = _one_call_allocs(lambda: [attention.paged_decode_attention_kernel(*args)])
    device_ops = build.graph_ops(lambda: got.append(attention.paged_decode_attention_kernel(*args)))
    assert len(device_ops) == 1, device_ops
    assert allocs == 1                                    # the output alone
    assert all(torch.equal(g, want) for g in got)
    _split_state_is_zero("paged_decode")


def test_paged_engine_runs_the_attention_kernels(gen):
    """The default (paged, prefix-cached) engine on the card: a 300-token
    prompt prefills on the flash kernel, every decode step on the paged
    decode kernel, and the repeated prompt hits the prefix cache and
    prefills its remainder as a chunk, which takes no flash launch."""
    cfg = LlamaConfig.tiny(max_seq_len=512)
    params = quantize_llama(init_llama(cfg, seed=0, device="cuda"), group_size=64,
                            device="cuda")
    before = (attention.flash_attention_causal.launches,
              attention.paged_decode_attention_kernel.launches)
    eng = ContinuousBatchingEngine(params, cfg, max_batch=2, page_size=16, device="cuda")
    prompt = list(range(1, 301))
    assert [len(o) for o in eng.generate([prompt, [5, 6, 7]], max_new_tokens=4)] == [4, 4]
    assert len(eng.generate([prompt], max_new_tokens=4)[0]) == 4
    assert eng.prefix_cache_stats()["hit_pages"] == 18
    assert attention.flash_attention_causal.launches == before[0] + cfg.num_layers
    assert attention.paged_decode_attention_kernel.launches > before[1]


# ---------------------------------------------------------------------------
# checkpoints/tiny_en_5m on the card: its trained weights at its shapes (N 128
# / 256 / 768, K 256 / 768; 4/2 heads of 64), through every row it runs
# ---------------------------------------------------------------------------

TINY_CKPT = Path(__file__).resolve().parent.parent / "checkpoints" / "tiny_en_5m"
# one linear of each shape: (group, name) -> (N, K)
TINY_LINEARS = {("attn", "wq"): (256, 256), ("attn", "wk"): (128, 256),
                ("mlp", "gate"): (768, 256), ("mlp", "down"): (256, 768)}


@pytest.fixture(scope="module")
def tiny_en_5m():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gemlite_tpu_torch import load_hf_llama
    return load_hf_llama(str(TINY_CKPT), device="cuda")


def _tiny_weight(tiny_en_5m, key):
    params, _ = tiny_en_5m
    return params["blocks"][3][key[0]][key[1]].float()


TINY_ROUTES = {1: "decode", 8: "decode", 64: "decode", 2048: "prefill", 8192: "dequantize"}


@pytest.mark.parametrize("M", sorted(TINY_ROUTES))
@pytest.mark.parametrize("gs", [64, 128])
@pytest.mark.parametrize("key", sorted(TINY_LINEARS))
def test_tiny_en_5m_w4_rows(gen, tiny_en_5m, key, gs, M):
    """Rows 1, 2 and 3 on the trained W4 layers: each M on its kernel, within
    REL of the plain version (the dequantized dense product at M 8192)."""
    from gemlite_tpu_torch.helper import A16W4_HQQ_INT, _warmup_quantize
    layer = _warmup_quantize(A16W4_HQQ_INT(device="cuda", dtype=torch.bfloat16),
                             _tiny_weight(tiny_en_5m, key), gs)
    assert (layer.out_features, layer.in_features) == TINY_LINEARS[key]
    x = _x(gen, M, layer.in_features)
    dispatch.KERNEL_TRACE.clear()
    got = layer(x)
    torch.cuda.synchronize()
    assert dispatch.KERNEL_TRACE == [TINY_ROUTES[M]]
    if M >= 4096:
        args = (layer.W_q, layer.scales, layer.zeros, layer.meta)
        want = x.float() @ dequantize_full(*args).float()
    else:
        want = _plain_f32(layer, x)
    assert _rel(got, want) <= REL


def _tiny_float_layer(tiny_en_5m, key, form):
    from gemlite_tpu_torch.helper import A16W2_HQQ_INT, A16W8_HQQ_INT, _warmup_quantize
    w = _tiny_weight(tiny_en_5m, key)
    if form == "a16w8":
        return A16W8_INT8(device="cuda", dtype=torch.bfloat16).from_weights(w)
    proc = (A16W8_HQQ_INT if form == "w8_channel" else A16W2_HQQ_INT)(device="cuda",
                                                                       dtype=torch.bfloat16)
    return _warmup_quantize(proc, w, 32)


@pytest.mark.parametrize("M", [1, 8, 2048])
@pytest.mark.parametrize("form", ["a16w8", "w8_channel", "w2_gs32"])
@pytest.mark.parametrize("key", sorted(TINY_LINEARS))
def test_tiny_en_5m_float_path(gen, tiny_en_5m, key, form, M):
    """Row 5f on the trained A16W8 and W8 (channel-wise HQQ) layers, which no
    decode or prefill gate takes, and on W2 gs 32 above M 64 (the prefill
    kernel wants groups of 64; the decode kernel takes it at M <= 64). Each
    route is held to its own plain version, as above: the float path's
    dequantizes in the compute dtype (fused_matmul_plain)."""
    layer = _tiny_float_layer(tiny_en_5m, key, form)
    x = _x(gen, M, layer.in_features)
    route = "decode" if form == "w2_gs32" and M <= 64 else "general_fused"
    dispatch.KERNEL_TRACE.clear()
    before = fused_gemm_float.launches
    got = layer(x)
    torch.cuda.synchronize()
    assert dispatch.KERNEL_TRACE == [route]
    assert fused_gemm_float.launches == before + (route == "general_fused")
    if route == "decode":
        want = _plain_f32(layer, x)
    else:
        want = fused_matmul_plain(x, layer.W_q, layer.scales, layer.zeros, None,
                                  layer.meta._replace(output_dtype=DType.FP32.value))
    assert _rel(got, want) <= REL


@pytest.mark.parametrize("M", [1, 8, 64, 2048])
@pytest.mark.parametrize("key", sorted(TINY_LINEARS))
def test_tiny_en_5m_a8w8_is_bit_exact(gen, tiny_en_5m, key, M):
    """Rows 4 (M <= 64) and 5's int path (M 2048) on the trained A8W8
    layers, bit for bit against their plain versions."""
    layer = A8W8_INT8_dynamic(device="cuda", dtype=torch.bfloat16).from_weights(
        _tiny_weight(tiny_en_5m, key))
    x, sx = _xq(gen, M, layer.in_features)
    args = (x, layer.W_q, layer.scales, layer.zeros, sx, layer.meta)
    if M <= 64:
        assert torch.equal(int8_decode(*args), int8_decode_plain(*args))
    else:
        assert int_path(layer.meta)
        assert torch.equal(fused_gemm(*args), fused_matmul_plain(*args))


@pytest.mark.parametrize("B", [4, 16])
def test_tiny_en_5m_flash(gen, B):
    """B1 at the eval's shape: windows of 512 bytes, 4/2 heads of 64."""
    q, k, v = (_attn_in(gen, (B, 512, h, 64)) for h in (4, 2, 2))
    got = attention.flash_attention_causal(q, k, v)
    torch.cuda.synchronize()
    want = attention.causal_attention_plain(q.float(), k.float(), v.float())
    assert got.shape == (B, 512, 4, 64) and _rel(got, want) <= REL


def test_tiny_en_5m_paged_decode(gen):
    """B2 at the served shape: 8 slots of up to 432 tokens (400-byte prompts
    and 32 new bytes), page 128, 4 pages a slot, 4/2 heads of 64."""
    args = _paged_case(gen, [64, 100, 150, 200, 256, 300, 350, 432], 128, 4, 2, 64, 4)
    got = attention.paged_decode_attention_kernel(*args)
    torch.cuda.synchronize()
    q, k_pages, v_pages, lengths, table = args
    want = attention.paged_decode_attention_plain(q.float(), k_pages.float(), v_pages.float(),
                                                  lengths, table)
    assert _rel(got, want) <= REL
