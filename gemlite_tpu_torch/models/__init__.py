# SPDX-License-Identifier: Apache-2.0
from .llama import (
    LlamaConfig,
    init_llama,
    quantize_llama,
    llama_forward,
    llama_prefill,
    llama_decode_step,
    llama_decode_step_batched,
    llama_verify_step,
    init_kv_cache,
    loss_fn,
)
