# SPDX-License-Identifier: Apache-2.0
"""gemlite-tpu for PyTorch on an NVIDIA H100.

A second implementation of the JAX package ``gemlite_tpu`` (its reference):
low-bit packed linears whose matmuls run on hand-written sm_90a kernels, a
Llama model and a continuous-batching engine. It imports no JAX.

Entry points take ``device=None``, which means the card; they raise when no
card is present unless given ``device="cpu"``, where the kernels' plain
PyTorch versions run instead.
"""

from .bitpack import (pack_weights_over_cols, pack_weights_over_rows, unpack_over_cols,
                      unpack_over_rows)
from .checkpoint import load_model, save_model
from .core import (GEMLITE_MATMUL_TYPES, GEMLITE_MATMUL_TYPES_MAPPING, GemLiteLinear, LayerMeta,
                   forward_functional, get_matmul_type)
from .dtypes import DType
from .helper import (A16Wn, A16Wn_HQQ_INT, A16W8_HQQ_INT, A16W4_HQQ_INT, A16W2_HQQ_INT,
                     A16W1_HQQ_INT, A16W8, A16W8_INT8, A16W8_FP8, A8W8_dynamic,
                     A8W8_INT8_dynamic, A8W8_FP8_dynamic, A8Wn_HQQ_INT_dynamic,
                     A8W4_HQQ_INT_dynamic, A8W2_HQQ_INT_dynamic, A16W158_INT,
                     A8W158_INT_dynamic, patch_model, warmup)
from .importers import export_hf_llama, from_transformers, load_hf_llama
from .mx import (A16Wn_MXFP, A16W8_MXFP, A16W4_MXFP, A8Wn_MXFP_dynamic, A8W8_MXFP_dynamic,
                 A8W4_MXFP_dynamic, A4W4_MXFP_dynamic, A4W4_NVFP_dynamic)
from .interop import paged_kv_from_jax_numpy, params_from_jax_numpy
from .models import (LlamaConfig, init_kv_cache, init_llama, llama_decode_step,
                     llama_decode_step_batched, llama_forward, llama_prefill,
                     llama_verify_step, loss_fn, quantize_llama)
from .serving import ContinuousBatchingEngine, GenerationResult, Request

__version__ = "0.1.0"
