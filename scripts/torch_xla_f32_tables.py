#!/usr/bin/env python3
# SPDX-License-Identifier: Apache-2.0
"""Write gemlite_tpu_torch/xla_f32.py: where the JAX package's f32 log2 and
exp2 (XLA on the CPU) differ from the exact results, over the range the MXFP4
weight quantizer uses.

    JAX_PLATFORMS=cpu python3 scripts/torch_xla_f32_tables.py

``WeightQuantizerMXFP.quantize_mxfp4`` (gemlite_tpu/quant.py) takes the
scale 2^ceil(log2(amax / 6)) through ``jnp.log2`` (XLA: log(v) * (1 / ln 2))
and ``jnp.exp2`` (XLA: exp(k * ln 2)). Neither is exact: the ceil of the
log2 is one off for some values a few ulps from a power of two, and exp2 of
an integer k is off by a few ulps for k outside [-14, 12]. The JAX package's
codes follow those values, so the port reproduces them from the tables this
script writes, and packs the same bytes on every device. Run it again only if
the JAX package's XLA changes its f32 log or exp.
"""

from pathlib import Path

import numpy as np

import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")

K_RANGE = range(-34, 128)      # log2 arguments from 2^-34 (below 2^-30 the scale is eps)
EXP_RANGE = range(-40, 129)
NEAR = 256                     # bit patterns each side of a power of two (the widest run is 61)
OUT = Path(__file__).resolve().parent.parent / "gemlite_tpu_torch" / "xla_f32.py"


def main() -> None:
    below, above = {}, {}
    for k in K_RANGE:
        base = int(np.array([2.0 ** k], np.float32).view(np.int32)[0])
        off = np.arange(-NEAR, NEAR + 1)
        bits = (base + off).astype(np.int32)
        xla = np.ceil(np.asarray(jnp.log2(jnp.asarray(bits.view(np.float32))))).astype(np.int64)
        exact = ((bits >> 23) & 0xFF).astype(np.int64) - 127 + ((bits & 0x7FFFFF) != 0)
        low = off[xla - exact == -1]
        if len(low):
            if list(low) != list(range(1, len(low) + 1)):
                raise RuntimeError(f"k={k}: the low ceilings are no run above 2^k: {low}")
            below[k] = len(low)
        high = off[xla - exact == 1]
        if len(high):
            above[k] = [int(o) for o in high]
        if np.any(np.abs(xla - exact) > 1):
            raise RuntimeError(f"k={k}: a ceiling off by more than one")
    ks = np.array(list(EXP_RANGE), np.float32)
    got = np.asarray(jnp.exp2(jnp.asarray(ks))).view(np.int32).astype(np.int64)
    exact = np.array([2.0 ** k for k in EXP_RANGE], np.float32).view(np.int32).astype(np.int64)
    exp2_ulps = {int(k): int(d) for k, d in zip(ks, got - exact) if d}

    def fmt(d):
        items = [f"{k}: {v}" for k, v in d.items()]
        lines, line = [], "    "
        for it in items:
            if len(line) + len(it) + 2 > 96:
                lines.append(line.rstrip())
                line = "    "
            line += it + ", "
        lines.append(line.rstrip())
        return "{\n" + "\n".join(lines) + "\n}"

    OUT.write_text(f'''# SPDX-License-Identifier: Apache-2.0
"""Where the JAX package's f32 log2 and exp2 (XLA on the CPU) differ from the
exact results, for the MXFP4 weight quantizer (``quant._xla_ceil_log2``,
``quant._xla_exp2``). Written by ``scripts/torch_xla_f32_tables.py``; do not
edit by hand.

``CEIL_LOG2_BELOW[k] = n``: for the n f32 bit patterns just above 2^k (bits
of 2^k plus 1 .. n), ceil(log2(v)) is k, not k + 1.
``CEIL_LOG2_ABOVE[k]``: the offsets, in bit patterns from 2^k, at which
ceil(log2(v)) is one more than the exact ceiling.
``EXP2_ULPS[k]``: exp2(k) for an integer k is the exact power's bit pattern
plus this many ulps (absent: exact).
"""

CEIL_LOG2_RANGE = ({K_RANGE.start}, {K_RANGE.stop})
EXP2_RANGE = ({EXP_RANGE.start}, {EXP_RANGE.stop})

CEIL_LOG2_BELOW = {fmt(below)}

CEIL_LOG2_ABOVE = {fmt(above)}

EXP2_ULPS = {fmt(exp2_ulps)}
''')
    print(f"wrote {OUT}: {len(below)} runs below, {len(above)} points above, "
          f"{len(exp2_ulps)} inexact exp2")


if __name__ == "__main__":
    main()
