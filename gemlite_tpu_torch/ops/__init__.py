# SPDX-License-Identifier: Apache-2.0
"""Kernels and their router: ``dispatch`` routes each linear by batch size to
``decode``, ``prefill`` or ``dequantize``; ``build`` compiles ``csrc/``;
``reference`` holds the plain versions."""
