# SPDX-License-Identifier: Apache-2.0
"""Batch-size (M) buckets (the port's copy of what ``helper.warmup`` reads
from ``gemlite_tpu/utils/m_bucket.py``): powers of two, and from 32 on the
midpoints 3p / 2 and 3p / 4, up to ``M_MAXVAL``."""

M_MAXVAL = 4096


def _bucket_values(max_m: int):
    vals = set()
    p = 1
    while p <= max_m:
        vals.add(p)
        if p >= 32 and p * 2 <= max_m:
            vals.add((p + p * 2) // 2)
            vals.add((p + p * 2) // 4)
        p *= 2
    return sorted(vals)


_BUCKETS = _bucket_values(M_MAXVAL)
