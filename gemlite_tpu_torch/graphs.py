# SPDX-License-Identifier: Apache-2.0
"""A step function captured once in a CUDA graph and replayed, with what its
capture recorded: the launch counts and the route traces.

The JAX engine compiles its decode step once per bucket (``jax.jit`` of
``gemlite_tpu/serving.py:_decode_impl``); the port's engine captures the same
step in a CUDA graph (``serving.ContinuousBatchingEngine``) and replays it, so
that a step costs one launch from the host instead of one per operation.

The wrappers count their launches (``<wrapper>.launches``) and note their
routes (``KERNEL_TRACE``, ``ATTENTION_TRACE``) in Python, which runs only
while the graph is captured. So a capture records how many launches of each
wrapper the step made and the traces it left, and takes the counts back (a
capture launches nothing); each replay adds the recorded counts and leaves
the traces as one eager call of the step would.
"""

import time
from typing import Callable, Optional

import torch

from .ops import build
from .ops.attention import ATTENTION_TRACE, flash_attention_causal, paged_decode_attention_kernel
from .ops.decode import decode_matmul, decode_modes, decode_modes_ragged
from .ops.dequantize import dequantize_int, dequantize_weights
from .ops.dispatch import KERNEL_TRACE
from .ops.fused import fused_gemm, fused_gemm_float
from .ops.fp8 import fp8_decode, fp8_decode_stacked, fp8_prefill
from .ops.int8_decode import int8_decode
from .ops.mx import mx_decode, mx_decode_stacked, mx_general, mx_prefill, mx_prefill_csm4
from .ops.prefill import prefill_matmul, prefill_modes, prefill_modes_ragged
from .ops.scan import decode_matmul_stacked, decode_modes_ragged_stacked, decode_modes_stacked

__all__ = ["COUNTED", "CapturedStep", "pool_bytes"]

# every wrapper that counts the launches of its kernel, by name
COUNTED = {"decode": decode_matmul, "prefill": prefill_matmul, "decode_modes": decode_modes,
           "decode_modes_ragged": decode_modes_ragged, "prefill_modes": prefill_modes,
           "prefill_modes_ragged": prefill_modes_ragged, "decode_stacked": decode_matmul_stacked,
           "decode_modes_stacked": decode_modes_stacked,
           "decode_modes_ragged_stacked": decode_modes_ragged_stacked,
           "dequantize": dequantize_weights, "dequantize_int": dequantize_int,
           "int8_decode": int8_decode, "fused_gemm": fused_gemm,
           "fused_gemm_float": fused_gemm_float, "flash": flash_attention_causal,
           "paged_decode": paged_decode_attention_kernel, "fp8_decode": fp8_decode,
           "fp8_prefill": fp8_prefill, "fp8_decode_stacked": fp8_decode_stacked,
           "mx_decode": mx_decode, "mx_decode_stacked": mx_decode_stacked,
           "mx_prefill": mx_prefill, "mx_prefill_csm4": mx_prefill_csm4,
           "mx_general": mx_general}


def pool_bytes(pool) -> int:
    """The device memory that the segments of a graph memory pool hold."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


class CapturedStep:
    """``fn()`` captured in one CUDA graph on ``stream``, its memory from
    ``pool`` (a ``torch.cuda.graph_pool_handle()`` that several graphs may
    share, as long as they replay one at a time).

    The caller runs ``fn`` once on ``stream`` first: that call builds the
    kernels and grows their split scratch (``build.split_state``, per
    stream) to what ``fn`` needs. The capture keeps a reference to every
    split tensor of the stream and raises if one is replaced while it runs.
    ``generator``: a CUDA ``torch.Generator`` that ``fn`` draws from,
    registered with the graph so that each replay draws anew. ``check()``
    runs on the traces the capture left and raises to refuse the graph. A
    capture that fails raises; nothing falls back to an eager call.

    The capture calls ``capture_begin`` / ``capture_end`` itself rather than
    entering ``torch.cuda.graph``, whose ``gc.collect()`` and
    ``torch.cuda.empty_cache()`` would hand the caching allocator's free
    blocks back to CUDA in the middle of serving, to be allocated again by
    the next steps."""

    def __init__(self, fn: Callable, stream: torch.cuda.Stream, pool,
                 generator: Optional[torch.Generator] = None, check: Optional[Callable] = None):
        before = {name: f.launches for name, f in COUNTED.items()}
        KERNEL_TRACE.clear()
        ATTENTION_TRACE.clear()
        scratch = build.split_tensors(stream.cuda_stream)
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        try:
            with torch.cuda.stream(stream):
                self.graph.capture_begin(pool=pool)
                try:
                    self.output = fn()
                finally:
                    self.graph.capture_end()
        finally:
            self.launches = {name: f.launches - before[name] for name, f in COUNTED.items()
                             if f.launches != before[name]}
            for name, f in COUNTED.items():
                f.launches = before[name]
        self.capture_s = time.perf_counter() - t0
        self.kernel_trace, self.attention_trace = list(KERNEL_TRACE), list(ATTENTION_TRACE)
        self.scratch = build.split_tensors(stream.cuda_stream)
        if [id(t) for t in self.scratch] != [id(t) for t in scratch]:
            raise RuntimeError("split scratch grew while the step was captured: run the step "
                               "on the capture stream first")
        if check is not None:
            check()

    def replay(self):
        """Run the graph on the current stream; returns what ``fn`` returned
        at capture, which the replay has rewritten."""
        self.graph.replay()
        for name, n in self.launches.items():
            COUNTED[name].launches += n
        KERNEL_TRACE[:] = self.kernel_trace
        ATTENTION_TRACE[:] = self.attention_trace
        return self.output
