# SPDX-License-Identifier: Apache-2.0
"""Kernels and their router: ``dispatch`` routes each linear by batch size to
``int8_decode``, ``decode``, ``prefill``, ``fused`` (the general kernel) or
``dequantize``; ``scan`` holds the stacked decode kernel of the scan path;
``build`` compiles ``csrc/``; ``reference`` holds the plain oracle."""
