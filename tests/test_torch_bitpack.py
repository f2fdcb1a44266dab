# SPDX-License-Identifier: Apache-2.0
"""The port's bit packing equals gemlite_tpu.bitpack exactly (CPU)."""

import numpy as np
import pytest
import torch

import gemlite_tpu.bitpack as jbp
import gemlite_tpu_torch.bitpack as tbp


def _codes(W_nbits, shape=(64, 256), seed=0):
    return np.random.default_rng(seed).integers(0, 2 ** W_nbits, size=shape).astype(np.uint8)


@pytest.mark.parametrize("packing_bitwidth", [8, 16, 32, 64])
@pytest.mark.parametrize("W_nbits", [1, 2, 4, 8])
def test_pack_unpack_equal_jax(W_nbits, packing_bitwidth):
    codes = _codes(W_nbits)
    for transpose in (True, False):
        jp, je = jbp.pack_weights_over_cols(codes, W_nbits, packing_bitwidth, transpose=transpose)
        tp, te = tbp.pack_weights_over_cols(torch.from_numpy(codes), W_nbits, packing_bitwidth,
                                            transpose=transpose)
        assert je == te
        assert np.array_equal(np.asarray(jp), tp.numpy())
        assert str(np.asarray(jp).dtype) == str(tp.numpy().dtype)
    jr, _ = jbp.pack_weights_over_rows(codes, W_nbits, packing_bitwidth)
    tr, _ = tbp.pack_weights_over_rows(torch.from_numpy(codes), W_nbits, packing_bitwidth)
    assert np.array_equal(np.asarray(jr), tr.numpy())

    words, _ = tbp.pack_weights_over_cols(torch.from_numpy(codes), W_nbits, packing_bitwidth,
                                          transpose=False)
    got = tbp.unpack_over_cols(words, W_nbits, codes.shape[1])
    assert np.array_equal(got.numpy(), np.asarray(jbp.unpack_over_cols(np.asarray(words.numpy()),
                                                                       W_nbits, codes.shape[1])))
    assert np.array_equal(got.numpy(), codes)
    assert np.array_equal(tbp.unpack_over_rows(tr, W_nbits, codes.shape[0]).numpy(), codes)


@pytest.mark.parametrize("W_nbits,w_layout", [(1, 1), (2, 1), (4, 1), (8, 1), (8, 2)])
@pytest.mark.parametrize("fold_gs", [64, 128])
def test_unfold_equals_jax(W_nbits, w_layout, fold_gs):
    n_planes = jbp.fold_plane_count(W_nbits, w_layout)
    assert tbp.fold_plane_count(W_nbits, w_layout) == n_planes
    codes = _codes(W_nbits, shape=(32, 256), seed=1)
    folded = np.asarray(jbp.fold_codes_for_planes(codes, n_planes, fold_gs))
    got = tbp.unfold_codes_for_planes(torch.from_numpy(folded), n_planes, fold_gs)
    assert np.array_equal(got.numpy(), np.asarray(jbp.unfold_codes_for_planes(folded, n_planes,
                                                                              fold_gs)))
    assert np.array_equal(got.numpy(), codes)
    rows = tbp.unfold_rows_for_planes(torch.from_numpy(np.ascontiguousarray(folded.T)),
                                      n_planes, fold_gs)
    assert np.array_equal(rows.numpy(), np.asarray(jbp.unfold_rows_for_planes(
        np.ascontiguousarray(folded.T), n_planes, fold_gs)))
