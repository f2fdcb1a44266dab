# SPDX-License-Identifier: Apache-2.0
"""Continuous-batching serving engine (counterpart of ``gemlite_tpu/serving.py``).

* A fixed pool of ``max_batch`` slots. By default (``paged=True``, as in the
  JAX engine) the KV cache lives in fixed-size pages named by a block table
  (``models/paged_kv.py``): pages come from a free list as sequences grow and
  go back when a slot finishes, and ``total_pages`` may be smaller than the
  worst case. Page 0 is a trash page: a finished slot's table row points at
  it, so the stale writes of inactive slots never reach a live page. With
  ``paged=False`` each slot owns a stripe of one dense cache.
* Prefix caching (``prefix_cache=True``, paged only): a prompt's full pages
  are registered under a hash chain of their tokens, and a later prompt with
  the same prefix attaches them read-only and prefills only the remainder.
  Writes land only at positions past the matched prefix, so sharing needs no
  copy. Pages are refcounted; cached pages no slot uses are reclaimed, least
  recently used first, when the free list runs dry.
* Prompts are prefilled slot-locally, padded to power-of-two buckets; prompts
  longer than ``prefill_chunk`` (or than the largest bucket), and the
  remainders of cached prefixes, are prefilled one chunk per engine step at a
  runtime offset, interleaved with decode of the other slots. A one-shot
  prefill of 256 tokens or more attends on the flash kernel; chunks never do,
  as in the JAX engine.
* The prefill step (``_prefill_step``, the counterpart of the JAX engine's
  ``_prefill_impl`` / ``_prefill_chunk_impl``, and with a draft of
  ``_dprefill_impl`` / ``_dprefill_chunk_impl``) reads the padded tokens, the
  slot, the true length, the chunk offset and the temperature from static
  device buffers. It writes the slot's cache (the dense stripe through a
  device index, the paged slot through its table row taken on the device),
  picks the last valid row's logits by a device index and samples the first
  token on the device; the host downloads that one int. With a draft, the
  draft's prefill of the same piece is part of the step.
* Every engine step runs one batched decode over all slots. Paged decode
  reads each slot's own pages up to its length on the paged decode kernel;
  the dense cache reads the live-KV bucket. Inactive slots write their k/v to
  the trash page (paged) or a stale row of their stripe (dense).
* The decode step (``_decode_step``, the counterpart of the JAX engine's
  ``_decode_impl``) reads its inputs from static device buffers (tokens,
  lengths, temperatures, active mask), samples on the device, and writes the
  next tokens and ``lengths + active`` back into them; the host copies its
  own values in only after an admission or a finish, and reads one (B,)
  tensor a step. The step reads nothing on the host.
* On the card the engine captures those steps in CUDA graphs, as the JAX
  engine jits them: the decode step in one graph per live-KV bucket on the
  dense cache (unrolled or scan) and one on the paged cache, the prefill
  step in one graph per one-shot bucket and one per chunk width, all from
  one memory pool, each captured at the first step that needs it, right
  after that step ran eagerly on the capture stream (its result is the
  step's), and replayed from then on (``graphs.CapturedStep``).
  ``graphs=False`` runs the same steps eagerly; on the CPU there are no
  graphs and the steps run eagerly. A capture or replay that fails raises.
  The decode graphs and bursts count in ``graph_captures`` /
  ``graph_replays`` / ``capture_s``, the prefill graphs in
  ``prefill_captures`` / ``prefill_replays`` / ``prefill_capture_s``.
* ``scan_layers=True`` (dense cache only, as in the JAX engine) stacks the
  block linears once at construction (``models/scan_llama.stack_blocks``) and
  runs every decode step over the stacks: each linear kind through one launch
  entry, the stacked decode kernel, which reads the layer index on the device.
  Prefill stays unrolled. Every stacked linear must be one the stacked kernel
  takes at ``max_batch`` rows; the engine checks that at construction and
  raises ``ValueError`` otherwise (an A8W8 model, for one).
* Speculative decoding (``draft=(draft_params, draft_cfg)``, ``spec_tokens``
  = gamma, as in the JAX engine): the draft keeps a dense cache of its own
  (even when the target's is paged) and is prefilled beside the target on
  the same padded tokens. While every active slot has room for gamma + 1
  more rows, an engine step is one burst (``_spec_step``, the counterpart of
  the JAX engine's ``_spec_impl``): gamma draft decode steps, one more that
  writes the last drafted token's k/v, one verify step of the target over
  (B, gamma + 1) positions, then rejection sampling (``spec_accept``: token
  i is kept with probability min(1, p_i / q_i), the first rejected one is
  drawn from the residual (p - q)+, or from p when all are kept; greedy
  slots use one-hot p and q, which is exact greedy prefix matching). The
  burst packs drafts, fix tokens and accepted counts in one int32 tensor,
  the one download of a burst. On the card it is captured in one CUDA graph
  per live-KV bucket from the same pool, as the decode step is. Near the
  cache end the engine takes plain decode steps, which the draft cache
  misses, as in JAX. Prefix caching is off while a draft is attached;
  ``scan_layers`` refuses a draft.
* On the card the engine checks after every eager prefill, decode step and
  burst, and at every capture, that each quantized linear ran on a
  hand-written kernel (``KERNEL_ROUTES``: decode, prefill, dequantize,
  int8_exact, general_fused, decode_stacked or prefill_mx_csm4) and that no
  attention ran a plain version (``ATTENTION_TRACE``).

Mesh sharding is not ported yet and raises. Sampling is greedy, or
temperature sampling by the Gumbel-max trick from a ``torch.Generator``
seeded with ``seed`` (it does not reproduce JAX's stream).
"""

import itertools
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .core import resolve_device
from .graphs import CapturedStep, pool_bytes
from .models.llama import (init_kv_cache, llama_decode_step_batched, llama_forward,
                           llama_verify_step)
from .models.paged_kv import init_paged_kv
from .models.scan_llama import llama_decode_step_scan, stack_blocks
from .ops.attention import ATTENTION_TRACE
from .ops.dispatch import KERNEL_ROUTES, KERNEL_TRACE
from .ops.scan import stacked_decode_refusal

__all__ = ["Request", "ContinuousBatchingEngine", "GenerationResult", "sample_tokens",
           "spec_dist", "spec_accept"]


@dataclass
class Request:
    prompt_tokens: Any                       # 1D int array/list
    max_new_tokens: int = 64
    temperature: float = 0.0                 # 0 => greedy
    request_id: int = field(default_factory=itertools.count().__next__)


@dataclass
class GenerationResult:
    request_id: int
    prompt_tokens: List[int]
    output_tokens: List[int]
    finish_reason: str                       # "eos" | "length"
    ttft_s: float = 0.0                      # submit -> first token (host clock)
    total_s: float = 0.0                     # submit -> finish
    decode_tps: float = 0.0                  # tokens/s after the first token


def sample_tokens(logits: torch.Tensor, temps: torch.Tensor, generator: torch.Generator):
    """(B,) int32 tokens from logits (B, V): argmax where temps == 0, else a
    draw from softmax(logits / T) as argmax(logits / T + Gumbel noise), the
    noise from ``generator``. Both are computed every call and picked on the
    device, as the JAX engine's ``_decode_impl`` picks them."""
    logits = logits.to(torch.float32)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    scaled = logits / torch.clamp(temps, min=1e-6)[:, None] - torch.log(-torch.log(u))
    sampled = torch.argmax(scaled, dim=-1).to(torch.int32)
    return torch.where(temps > 0, sampled, greedy)


def _gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u))


def spec_dist(logits: torch.Tensor, temps: torch.Tensor) -> torch.Tensor:
    """Per-slot proposal / verification distribution (B, V) float32:
    softmax(logits / T) for sampled slots (T > 0), the one-hot argmax for
    greedy ones (``gemlite_tpu/serving.py:_spec_dist``)."""
    logits = logits.to(torch.float32)
    soft = torch.softmax(logits / torch.clamp(temps, min=1e-6)[:, None], dim=-1)
    hard = torch.nn.functional.one_hot(torch.argmax(logits, dim=-1),
                                       logits.shape[-1]).to(torch.float32)
    return torch.where((temps > 0)[:, None], soft, hard)


def spec_accept(p, q, drafts, u, noise, temps):
    """Rejection sampling of a burst (``gemlite_tpu/serving.py:515-535``):
    target distributions p (B, g + 1, V), draft distributions q (B, g, V),
    drafted tokens (B, g), uniforms u (B, g) and Gumbel noise (B, V) for the
    fix token's draw. Draft i is kept while u_i q_i(d_i) < p_i(d_i); the
    first rejected position's fix token is drawn from (p - q)+ + 1e-30, or
    from p when all g are kept, by Gumbel-max for sampled slots and argmax for
    greedy ones. Returns (n_acc (B,) int32, fix (B,) int32)."""
    B, g = drafts.shape
    V = p.shape[-1]
    d = drafts.to(torch.long)[..., None]
    p_d = torch.gather(p[:, :g], 2, d)[..., 0]
    q_d = torch.gather(q, 2, d)[..., 0]
    acc = (u * q_d < p_d).to(torch.int32)
    n_acc = torch.cumprod(acc, dim=1).sum(dim=1)
    at = n_acc.to(torch.long)[:, None, None].expand(B, 1, V)
    qz = torch.cat([q, torch.zeros((B, 1, V), dtype=q.dtype, device=q.device)], dim=1)
    res = torch.clamp(torch.gather(p, 1, at)[:, 0] - torch.gather(qz, 1, at)[:, 0], min=0.0)
    res = res + 1e-30
    sampled = torch.argmax(torch.log(res) + noise, dim=-1)
    fix = torch.where(temps > 0, sampled, torch.argmax(res, dim=-1))
    return n_acc.to(torch.int32), fix.to(torch.int32)


def _next_bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class ContinuousBatchingEngine:
    """Slot-based continuous batching over a quantized Llama param dict.

    ``graphs``: capture the prefill step, the decode step and the
    speculative burst in CUDA graphs (the default on the card) or run them
    eagerly (``False``, the counterpart of ``jax.disable_jit``); ``True`` on
    the CPU raises.
    ``draft=(draft_params, draft_cfg)``: a smaller model of the same
    vocabulary that proposes ``spec_tokens`` tokens a burst."""

    def __init__(self, params, cfg, max_batch: int = 8, eos_id: Optional[int] = None,
                 prefill_buckets=(32, 64, 128, 256, 512, 1024, 2048), seed: int = 0,
                 prefill_chunk: Optional[int] = None, draft=None, spec_tokens: int = 4,
                 paged: bool = True, page_size: int = 128, total_pages: Optional[int] = None,
                 prefix_cache: bool = True, mesh=None, scan_layers: bool = False,
                 device=None, graphs: Optional[bool] = None):
        if mesh is not None:
            raise NotImplementedError("queued: mesh-sharded serving (mesh=)")
        if scan_layers and paged:
            raise ValueError("scan_layers requires paged=False (the paged decode kernel "
                             "takes no layer index)")
        if scan_layers and draft is not None:
            raise ValueError("scan_layers does not cover the speculative verify step; "
                             "drop draft=")
        if draft is not None and draft[1].max_seq_len < cfg.max_seq_len:
            raise ValueError(f"draft max_seq_len {draft[1].max_seq_len} must cover the target "
                             f"cache ({cfg.max_seq_len})")
        self.device = resolve_device(device)
        on_card = self.device.type == "cuda"
        if graphs and not on_card:
            raise ValueError("graphs=True needs the card: the CPU has no CUDA graphs, and the "
                             "engine runs its decode step there eagerly")
        self.graphs = on_card if graphs is None else bool(graphs)
        for what, p in (("params", params), ("draft params", draft and draft[0])):
            if p and p["embed"].device.type != self.device.type:
                raise ValueError(f"{what} live on {p['embed'].device}, the engine on "
                                 f"{self.device}")
        self._stacked = stack_blocks(params) if scan_layers else None
        if self._stacked is not None:
            for grp in ("attn", "mlp"):
                for name, stk in self._stacked[grp].items():
                    why = stacked_decode_refusal(stk.meta, max_batch)
                    if why is not None:
                        raise ValueError(f"scan_layers: the stacked decode kernel does not take "
                                         f"{grp}.{name} at max_batch={max_batch}: {why}")
        self.params = params
        self.cfg = cfg
        self.max_batch = max_batch
        self.eos_id = eos_id
        self.buckets = tuple(b for b in sorted(prefill_buckets) if b <= cfg.max_seq_len)
        if not self.buckets:
            raise ValueError(f"no prefill bucket fits max_seq_len={cfg.max_seq_len}; "
                             "pass prefill_buckets with at least one value <= it")
        self.prefill_chunk = prefill_chunk
        self.paged = paged
        if paged:
            # the largest power-of-two divisor of max_seq_len <= page_size
            page_size = min(page_size, cfg.max_seq_len)
            while cfg.max_seq_len % page_size:
                page_size //= 2
            self.page_size = page_size
            self.pages_per_seq = cfg.max_seq_len // page_size
            n_pages = (total_pages if total_pages is not None
                       else max_batch * self.pages_per_seq + 1)
            if n_pages < 2:
                raise ValueError("total_pages: need the trash page and at least one page")
            self.kv = init_paged_kv(cfg, max_batch, page_size, total_pages=n_pages,
                                    device=self.device)
            self.page_table = np.zeros((max_batch, self.pages_per_seq), np.int32)  # all trash
            self.kv.load_table(self.page_table)     # the one table tensor of the engine's life
            self.free_pages: List[int] = list(range(n_pages - 1, 0, -1))
            self.slot_pages: List[List[int]] = [[] for _ in range(max_batch)]
            self._table_dirty = False
        else:
            self.kv = init_kv_cache(cfg, max_batch, device=self.device)
        # speculative decoding: the draft's own dense cache, on every engine
        self.draft = draft
        self.spec_tokens = spec_tokens if draft is not None else 0
        self.draft_kv = (init_kv_cache(draft[1], max_batch, device=self.device)
                         if draft is not None else None)
        # a draft would miss the prefix that a cached prompt skips
        self.use_prefix = bool(prefix_cache) and paged and draft is None
        # hash -> (page id, page tokens): the tokens are compared on a match,
        # so a hash collision never attaches another prompt's KV
        self.prefix_cache: "OrderedDict[int, tuple]" = OrderedDict()
        self.page_refs: Dict[int, int] = {}                  # page id -> live slots
        self.slot_shared: List[set] = [set() for _ in range(max_batch)]
        self.prefix_stats = {"hit_pages": 0, "new_pages": 0}
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._check_kernels = on_card

        # the decode step's static inputs, written back by the step itself
        dev = self.device
        self._static = {"tokens": torch.zeros((max_batch, 1), dtype=torch.int32, device=dev),
                        "lens": torch.zeros(max_batch, dtype=torch.int32, device=dev),
                        "temps": torch.zeros(max_batch, dtype=torch.float32, device=dev),
                        "active": torch.zeros(max_batch, dtype=torch.int32, device=dev)}
        # the burst's static inputs and its packed result
        # [drafts (B * g) | fix (B) | n_acc (B)]
        self._spec_static = None if draft is None else {
            "tokens": torch.zeros((max_batch, 1), dtype=torch.int32, device=dev),
            "lens": torch.zeros(max_batch, dtype=torch.int32, device=dev),
            "temps": torch.zeros(max_batch, dtype=torch.float32, device=dev),
            "packed": torch.zeros(max_batch * (self.spec_tokens + 2), dtype=torch.int32,
                                  device=dev)}
        self._dev_dirty = True
        # the prefill step's static inputs, [slot, true length, chunk offset,
        # padded tokens] in one int32 row as wide as the largest bucket and
        # the request's temperature, and the first token it samples
        self._pf_static = {
            "ints": torch.zeros(3 + self.buckets[-1], dtype=torch.int32, device=dev),
            "temp": torch.zeros(1, dtype=torch.float32, device=dev),
            "token": torch.zeros(1, dtype=torch.int32, device=dev)}
        # decode graphs by t_active bucket, bursts by ("spec", t_active)
        self._graphs: Dict[Any, CapturedStep] = {}
        # prefill graphs by ("prefill", bucket) and ("chunk", width)
        self._prefill_graphs: Dict[Any, CapturedStep] = {}
        self._capture_stream = torch.cuda.Stream(dev) if self.graphs else None
        self._pool = torch.cuda.graph_pool_handle() if self.graphs else None
        # the last decode step's (B, V) logits, the last burst's verify
        # logits (B, g + 1, V), or the last prefill's (1, V) logits row
        self.last_logits: Optional[torch.Tensor] = None

        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self.slot_len = np.zeros(max_batch, np.int32)        # valid cache length
        self.slot_out: List[List[int]] = [[] for _ in range(max_batch)]
        self.slot_last = np.zeros(max_batch, np.int32)       # last sampled token
        self.slot_pending: List[Optional[np.ndarray]] = [None] * max_batch
        self.queue: List[Request] = []
        self.finished: List[GenerationResult] = []
        self._req_times: Dict[int, List[Optional[float]]] = {}
        self._counters = {"steps": 0, "decode_steps": 0, "spec_steps": 0, "prefills": 0,
                          "prefill_chunks": 0, "tokens_out": 0, "graph_captures": 0,
                          "graph_replays": 0, "capture_s": 0.0, "prefill_captures": 0,
                          "prefill_replays": 0, "prefill_capture_s": 0.0,
                          "start": time.monotonic()}

        # decode attention reads only the live-KV bucket
        self.decode_buckets = []
        b = 256
        while b < cfg.max_seq_len:
            self.decode_buckets.append(b)
            b *= 2
        self.decode_buckets.append(cfg.max_seq_len)

    # ------------------------------------------------------------------
    # paged-KV page allocator and prefix cache (host side)
    # ------------------------------------------------------------------
    def _evict_prefix_pages(self) -> bool:
        """Reclaim the least recently used cached page no slot uses."""
        for h, (pid, _) in list(self.prefix_cache.items()):
            if self.page_refs.get(pid, 0) == 0:
                del self.prefix_cache[h]
                self.page_refs.pop(pid, None)
                self.free_pages.append(pid)
                return True
        return False

    def _ensure_pages(self, slot: int, n_tokens: int):
        """Grow the slot's page set to cover ``n_tokens`` cache positions."""
        if not self.paged:
            return
        need = -(-int(n_tokens) // self.page_size)
        own = self.slot_pages[slot]
        while len(own) < need:
            if not self.free_pages and not self._evict_prefix_pages():
                raise RuntimeError("paged KV pool exhausted: raise total_pages (the pool "
                                   "is oversubscribed below the worst-case footprint)")
            p = self.free_pages.pop()
            self.page_table[slot, len(own)] = p
            own.append(p)
            self._table_dirty = True

    def _free_slot_pages(self, slot: int):
        if not self.paged or not self.slot_pages[slot]:
            return
        shared = self.slot_shared[slot]
        for pid in self.slot_pages[slot]:
            if pid in shared:
                # cached page: other slots, or the cache at refcount 0, keep it
                self.page_refs[pid] = max(0, self.page_refs.get(pid, 1) - 1)
            else:
                self.free_pages.append(pid)
        self.slot_pages[slot] = []
        self.slot_shared[slot] = set()
        self.page_table[slot, :] = 0              # stale writes land in the trash page
        self._table_dirty = True

    @staticmethod
    def _chain_hashes(prompt, ps: int, n_pages: int):
        h, out = 0, []
        for i in range(n_pages):
            h = hash((h, tuple(int(t) for t in prompt[i * ps:(i + 1) * ps])))
            out.append(h)
        return out

    def _match_prefix(self, slot: int, prompt) -> int:
        """Attach the cached pages of the longest token-exact prompt prefix
        (full pages, at least one token left to prefill), capped so that the
        remainder's padded chunks stay inside max_seq_len. Returns the number
        of matched tokens."""
        ps = self.page_size
        own = self.slot_pages[slot]
        if own:
            raise RuntimeError(f"prefix attach on slot {slot}, which holds pages")
        for i, h in enumerate(self._chain_hashes(prompt, ps, (len(prompt) - 1) // ps)):
            entry = self.prefix_cache.get(h)
            if entry is None:
                break
            pid, page_toks = entry
            if page_toks != tuple(int(t) for t in prompt[i * ps:(i + 1) * ps]):
                break                                # hash collision: do not attach
            self.prefix_cache.move_to_end(h)         # LRU touch
            self.page_refs[pid] = self.page_refs.get(pid, 0) + 1
            self.page_table[slot, i] = pid
            own.append(pid)
            self.slot_shared[slot].add(pid)
            self._table_dirty = True
            self.prefix_stats["hit_pages"] += 1
        # every chunk writes its full padded width from a page-aligned offset:
        # matched + ceil(rem / C) * C must not pass max_seq_len
        while own:
            matched = len(own) * ps
            rem = len(prompt) - matched
            C = self._remainder_chunk(rem)
            if matched + (-(-rem // C)) * C <= self.cfg.max_seq_len:
                break
            pid = own.pop()
            self.page_table[slot, len(own)] = 0
            self.slot_shared[slot].discard(pid)
            self.page_refs[pid] = max(0, self.page_refs.get(pid, 1) - 1)
            self.prefix_stats["hit_pages"] -= 1
        return len(own) * ps

    def _register_prefix(self, slot: int, prompt):
        """Publish the full pages of a prefilled prompt for reuse; pages it
        attached from the cache are already there."""
        if not self.use_prefix:
            return
        ps = self.page_size
        own = self.slot_pages[slot]
        for i, h in enumerate(self._chain_hashes(prompt, ps, len(prompt) // ps)):
            if i >= len(own):
                break
            pid = own[i]
            if h in self.prefix_cache or pid in self.slot_shared[slot]:
                continue
            self.prefix_cache[h] = (pid, tuple(int(t) for t in prompt[i * ps:(i + 1) * ps]))
            self.page_refs[pid] = self.page_refs.get(pid, 0) + 1
            self.slot_shared[slot].add(pid)
            self.prefix_stats["new_pages"] += 1

    def prefix_cache_stats(self) -> Dict[str, int]:
        """{'hit_pages', 'new_pages', 'cached_pages'} since the engine started."""
        return dict(self.prefix_stats, cached_pages=len(self.prefix_cache))

    def _sync_table(self):
        if self.paged and self._table_dirty:
            self.kv.load_table(self.page_table)
            self._table_dirty = False

    # ------------------------------------------------------------------
    # device work
    # ------------------------------------------------------------------
    def _check_routes(self):
        """On the card, raise unless every quantized linear noted in the
        traces ran on one of the kernels of ``KERNEL_ROUTES`` and no
        attention ran a plain version."""
        if not self._check_kernels:
            return
        bad = sorted(set(KERNEL_TRACE) - set(KERNEL_ROUTES))
        if bad:
            raise RuntimeError(f"linears ran off the kernels: routes {bad}")
        plain = sorted({n for n in ATTENTION_TRACE if n.startswith("plain_")})
        if plain:
            raise RuntimeError(f"attention ran its plain version on the card: {plain}")

    def _checked(self, fn, *args, **kw):
        """Run one model call eagerly, then ``_check_routes``."""
        KERNEL_TRACE.clear()
        ATTENTION_TRACE.clear()
        out = fn(*args, **kw)
        self._check_routes()
        return out

    def _prefill(self, tokens: np.ndarray, slot: int, offset: int, true_len: int, chunk: bool):
        """One padded prompt piece (1, C) into the slot's cache at ``offset``:
        a one-shot prefill (offset 0, ``chunk`` False) or a prompt chunk. The
        host's values go into the static buffers, then the prefill step runs,
        a graph for each one-shot bucket and each chunk width. Returns the
        logits (1, V) at the piece's last valid position; the first token
        the step sampled waits in the static ``token`` for ``_first_token``."""
        C = tokens.shape[1]
        if not 0 <= offset <= self.cfg.max_seq_len - C:
            raise ValueError(f"prefill write [{offset}, {offset + C}) outside the cache of "
                             f"{self.cfg.max_seq_len} rows")
        st = self._pf_static
        host = np.empty(3 + C, np.int32)
        host[:3] = slot, true_len, offset
        host[3:] = tokens[0]
        st["ints"][:3 + C].copy_(torch.from_numpy(host))
        st["temp"].fill_(self.slot_req[slot].temperature)
        key = ("chunk" if chunk else "prefill", C)
        return self._run_step(key, lambda: self._prefill_step(C, chunk), prefill=True)

    def _prefill_step(self, width: int, chunk: bool):
        """The prefill step over the static buffers: the slot's piece of
        ``width`` tokens through the model at offset 0 (one-shot, flash from
        256 tokens) or at the device offset (a chunk), its k/v into the
        slot's stripe or pages, the logits (1, V) of its last valid row by a
        device index, the first token sampled from them into ``token``, and
        with a draft the draft's prefill of the same piece. Reads nothing on
        the host. Returns the logits row."""
        st = self._pf_static
        slot, true_len = st["ints"][0:1], st["ints"][1:2]
        cache_len = st["ints"][2] if chunk else 0
        tokens = st["ints"][3:3 + width].view(1, width)
        if self.paged:
            kv = self.kv.with_table(self.kv.table.index_select(0, slot))
            logits, _ = llama_forward(self.params, self.cfg, tokens, kv=kv, cache_len=cache_len)
        else:
            logits, _ = llama_forward(self.params, self.cfg, tokens, kv=self.kv,
                                      cache_len=cache_len, slot=slot)
        last = logits.index_select(1, true_len - 1)[:, 0]
        st["token"].copy_(sample_tokens(last, st["temp"], self.generator))
        if self.draft is not None:
            llama_forward(self.draft[0], self.draft[1], tokens, kv=self.draft_kv,
                          cache_len=cache_len, slot=slot)
        return last

    def _decode_step(self, t_active):
        """The decode step: every slot advances one token from the static
        buffers (``t_active``: the live-KV bucket of the dense cache, None on
        the paged one), the next tokens sampled on the device and written back
        into ``tokens`` with ``lens + active`` into ``lens``. Inactive slots
        write their k/v to a stale row or the trash page and do not advance.
        Reads nothing on the host. Returns the logits (B, V)."""
        st = self._static
        if self._stacked is not None:
            logits, _ = llama_decode_step_scan(self._stacked, self.params, self.cfg, st["tokens"],
                                               self.kv, st["lens"], t_active=t_active)
        else:
            logits, _ = llama_decode_step_batched(self.params, self.cfg, st["tokens"], self.kv,
                                                  st["lens"], t_active=t_active)
        logits = logits[:, 0, :]
        st["tokens"].copy_(sample_tokens(logits, st["temps"], self.generator)[:, None])
        st["lens"].add_(st["active"])
        return logits

    def _spec_step(self, t_active):
        """The speculative burst over every slot from the static buffers
        (``t_active``: the live-KV bucket, on both caches): gamma draft decode
        steps, each drafting a token from q = ``spec_dist`` of the draft's
        logits (Gumbel-max over log(q + 1e-30), argmax for greedy slots), one
        more draft step that writes the last drafted token's k/v, one verify
        step of the target over the slot's token and its g drafts, then
        ``spec_accept``. Writes the packed [drafts | fix | n_acc] into
        ``packed``; reads nothing on the host. Returns the verify logits
        (B, g + 1, V)."""
        st = self._spec_static
        g, (dparams, dcfg) = self.spec_tokens, self.draft
        tokens, lens, temps = st["tokens"], st["lens"], st["temps"]
        B, dev = tokens.shape[0], tokens.device
        tok, dl, drafts, qs = tokens, lens, [], []
        for _ in range(g):
            dlogits, _ = llama_decode_step_batched(dparams, dcfg, tok, self.draft_kv, dl,
                                                   t_active=t_active)
            q = spec_dist(dlogits[:, 0], temps)
            sampled = torch.argmax(torch.log(q + 1e-30) + _gumbel(q.shape, self.generator, dev),
                                   dim=-1)
            tok = torch.where(temps > 0, sampled, torch.argmax(q, dim=-1)).to(torch.int32)[:, None]
            drafts.append(tok)
            qs.append(q)
            dl = dl + 1
        # the last drafted token's k/v into the draft cache: after a full
        # acceptance the next burst starts past it
        llama_decode_step_batched(dparams, dcfg, tok, self.draft_kv, dl, t_active=t_active)
        drafts = torch.cat(drafts, dim=1)                                    # (B, g)
        logits, _ = llama_verify_step(self.params, self.cfg, torch.cat([tokens, drafts], dim=1),
                                      self.kv, lens, t_active=t_active)     # (B, g + 1, V)
        V = logits.shape[-1]
        p = spec_dist(logits.reshape(B * (g + 1), V),
                      temps.repeat_interleave(g + 1)).reshape(B, g + 1, V)
        u = torch.rand((B, g), generator=self.generator, device=dev)
        n_acc, fix = spec_accept(p, torch.stack(qs, dim=1), drafts, u,
                                 _gumbel((B, V), self.generator, dev), temps)
        st["packed"].copy_(torch.cat([drafts.reshape(-1), fix, n_acc]))
        return logits

    def _run_step(self, key, fn, prefill: bool = False):
        """Run one step function: replay its graph; at its first call run it
        eagerly on the capture stream (its result is this call's) and capture
        it; with graphs off, run it eagerly. ``prefill``: a prefill step,
        kept and counted apart from the decode steps and bursts."""
        graphs = self._prefill_graphs if prefill else self._graphs
        kind = "prefill" if prefill else "graph"
        if not self.graphs:
            out = self._checked(fn)
        elif key in graphs:
            out = graphs[key].replay()
            self._counters[f"{kind}_replays"] += 1
        else:
            main, side = torch.cuda.current_stream(self.device), self._capture_stream
            side.wait_stream(main)
            with torch.cuda.stream(side):
                out = self._checked(fn)
                graph = CapturedStep(fn, side, self._pool, self.generator, self._check_routes)
            main.wait_stream(side)
            out.record_stream(main)
            graphs[key] = graph
            self._counters[f"{kind}_captures"] += 1
            self._counters["prefill_capture_s" if prefill else "capture_s"] += graph.capture_s
        self.last_logits = out
        return out

    def _decode(self, t_active):
        """One decode step, a graph for each live-KV bucket."""
        return self._run_step(t_active, lambda: self._decode_step(t_active))

    def _spec(self, t_active):
        """One speculative burst, a graph for each live-KV bucket."""
        return self._run_step(("spec", t_active), lambda: self._spec_step(t_active))

    # ------------------------------------------------------------------
    # host-side scheduler
    # ------------------------------------------------------------------
    def submit(self, request: Request):
        n = int(np.asarray(request.prompt_tokens).reshape(-1).shape[0])
        if n == 0:
            raise ValueError("empty prompt")
        if n >= self.cfg.max_seq_len:
            raise ValueError(f"prompt length {n} >= max_seq_len {self.cfg.max_seq_len}; "
                             "the cache has no room for generated tokens")
        self._req_times[request.request_id] = [time.monotonic(), None]
        self.queue.append(request)

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self.slot_req)

    def _first_token(self, slot: int):
        """The token that the slot's last prefill step sampled (one int
        downloaded), then the prefix registration and a finish check."""
        req = self.slot_req[slot]
        tok = int(self._pf_static["token"][0])
        self.slot_out[slot] = [tok]
        self.slot_last[slot] = tok
        self._mark_first_token(req)
        self._counters["tokens_out"] += 1
        self._register_prefix(slot, np.asarray(req.prompt_tokens, np.int32).reshape(-1))
        self._maybe_finish(slot, tok)

    def _claim(self, slot: int, req: Request, cache_len: int, pending):
        """Give the slot to req; ``pending`` tokens wait for chunked prefill."""
        self.slot_req[slot] = req
        self.slot_len[slot] = cache_len
        self.slot_out[slot] = []
        self.slot_pending[slot] = pending

    def _admit(self):
        """Fill free slots from the queue with slot-local prefill."""
        if self.queue and any(r is None for r in self.slot_req):
            self._dev_dirty = True
        for slot in range(self.max_batch):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            prompt = np.asarray(req.prompt_tokens, np.int32).reshape(-1)
            if self.use_prefix and len(prompt) > self.page_size:
                matched = self._match_prefix(slot, prompt)
                if matched:
                    # cached prefix attached read-only: chunk-prefill the rest
                    self._claim(slot, req, matched, prompt[matched:])
                    continue
            if len(prompt) > self.buckets[-1] or (
                    self.prefill_chunk and len(prompt) > self.prefill_chunk):
                self._claim(slot, req, 0, prompt)      # chunks advance in step()
                continue
            Lb = _next_bucket(len(prompt), self.buckets)
            try:
                self._ensure_pages(slot, Lb)           # the pad rows are written too
            except RuntimeError:
                self._free_slot_pages(slot)            # readmission starts empty
                if self.num_active == 0:
                    raise                              # nothing running can free pages
                self.queue.insert(0, req)              # retry once running slots finish
                break
            self._sync_table()
            padded = np.zeros((1, Lb), np.int32)
            padded[0, :len(prompt)] = prompt
            self._claim(slot, req, len(prompt), None)
            self._prefill(padded, slot, 0, len(prompt), False)
            self._counters["prefills"] += 1
            self._first_token(slot)

    def _remainder_chunk(self, rem: int) -> int:
        C = self.prefill_chunk or _next_bucket(max(rem, 1), self.buckets)
        return min(C, self.buckets[-1])

    def _advance_prefills(self):
        """One prompt chunk per mid-prefill slot."""
        for slot in range(self.max_batch):
            pend = self.slot_pending[slot]
            if pend is None:
                continue
            C = self._remainder_chunk(len(pend))
            head = int(self.cfg.max_seq_len) - int(self.slot_len[slot])
            if C > head:
                # the padded chunk writes all C rows: keep it inside the cache
                C = 1 << (max(head, 1).bit_length() - 1)
            chunk, rest = pend[:C], pend[C:]
            padded = np.zeros((1, C), np.int32)
            padded[0, :len(chunk)] = chunk
            self._ensure_pages(slot, int(self.slot_len[slot]) + C)
            self._sync_table()
            self._prefill(padded, slot, int(self.slot_len[slot]), len(chunk), True)
            self._counters["prefill_chunks"] += 1
            self.slot_len[slot] += len(chunk)
            # the decode step's lens still hold this slot's offset before the
            # chunk: its stale write there would land on a prompt row now
            # (the JAX engine keeps them, and overwrites that row)
            self._dev_dirty = True
            if len(rest):
                self.slot_pending[slot] = rest
                continue
            self.slot_pending[slot] = None
            self._first_token(slot)

    def _mark_first_token(self, req: Request):
        t = self._req_times.get(req.request_id)
        if t is not None and t[1] is None:
            t[1] = time.monotonic()

    def _maybe_finish(self, slot: int, tok: int):
        req = self.slot_req[slot]
        if req is None:
            return
        done_eos = self.eos_id is not None and tok == self.eos_id
        done_len = len(self.slot_out[slot]) >= req.max_new_tokens
        over_cap = int(self.slot_len[slot]) + len(self.slot_out[slot]) >= \
            self.cfg.max_seq_len - 1
        if done_eos or done_len or over_cap:
            now = time.monotonic()
            sub, first = self._req_times.pop(req.request_id, [now, None])
            first = first if first is not None else now
            n_out = len(self.slot_out[slot])
            self.finished.append(GenerationResult(
                request_id=req.request_id,
                prompt_tokens=[int(t) for t in np.asarray(req.prompt_tokens).reshape(-1)],
                output_tokens=list(self.slot_out[slot]),
                finish_reason="eos" if done_eos else "length",
                ttft_s=first - sub,
                total_s=now - sub,
                decode_tps=(n_out - 1) / (now - first) if n_out > 1 and now > first else 0.0,
            ))
            self.slot_req[slot] = None
            self.slot_out[slot] = []
            self.slot_pending[slot] = None
            self._dev_dirty = True
            self._free_slot_pages(slot)

    def step(self):
        """Admit pending requests, advance prompt chunks, then advance every
        decoding slot one token."""
        self._counters["steps"] += 1
        self._admit()
        self._advance_prefills()
        active = np.array([r is not None and self.slot_pending[i] is None
                           for i, r in enumerate(self.slot_req)])
        if not active.any():
            return
        # position of the token being decoded: prompt_len + generated - 1
        lens = self.slot_len + np.array([max(len(o) - 1, 0) for o in self.slot_out], np.int32)
        temps = [r.temperature if r is not None else 0.0 for r in self.slot_req]
        g = self.spec_tokens
        max_len = int(lens[active].max())
        if g and max_len + g + 1 < self.cfg.max_seq_len:
            self._burst(active, lens, temps, g, max_len)
            return
        for slot in range(self.max_batch):
            if active[slot]:
                self._ensure_pages(slot, int(lens[slot]) + 1)
        self._sync_table()
        # paged decode reads each slot's own pages up to its length; the dense
        # cache reads the live-KV bucket
        t_act = None if self.paged else _next_bucket(max_len + 1, self.decode_buckets)
        st = self._static
        if self._dev_dirty:
            # after an admission or a finish the host's values replace the
            # ones the last step left in the static buffers
            st["tokens"].copy_(torch.from_numpy(self.slot_last.reshape(-1, 1)))
            st["lens"].copy_(torch.from_numpy(lens))
            st["temps"].copy_(torch.tensor(temps, dtype=torch.float32))
            st["active"].copy_(torch.from_numpy(active.astype(np.int32)))
            self._dev_dirty = False
        self._decode(t_act)
        nxt = st["tokens"].view(-1).tolist()                # the one download of a step
        self._counters["decode_steps"] += 1
        for slot in range(self.max_batch):
            if not active[slot]:
                continue
            tok = int(nxt[slot])
            self.slot_out[slot].append(tok)
            self.slot_last[slot] = tok
            self._counters["tokens_out"] += 1
            self._maybe_finish(slot, tok)

    def _burst(self, active, lens, temps, g: int, max_len: int):
        """One speculative burst: room for g + 1 rows in every active slot's
        pages, the host's tokens, lengths and temperatures into the burst's
        buffers, the burst, one download, then each slot's kept drafts and
        fix token through ``_maybe_finish``, stopping at a finish."""
        for slot in range(self.max_batch):
            if active[slot]:
                self._ensure_pages(slot, int(lens[slot]) + g + 1)
        self._sync_table()
        st = self._spec_static
        st["tokens"].copy_(torch.from_numpy(self.slot_last.reshape(-1, 1)))
        st["lens"].copy_(torch.from_numpy(lens))
        st["temps"].copy_(torch.tensor(temps, dtype=torch.float32))
        self._spec(_next_bucket(max_len + g + 1, self.decode_buckets))
        packed = st["packed"].tolist()                      # the one download of a burst
        B = self.max_batch
        self._counters["spec_steps"] += 1
        self._dev_dirty = True              # the decode step's buffers are stale now
        for slot in range(B):
            if not active[slot]:
                continue
            na = packed[B * g + B + slot]
            for tok in packed[slot * g:slot * g + na] + [packed[B * g + slot]]:
                self.slot_out[slot].append(tok)
                self.slot_last[slot] = tok
                self._counters["tokens_out"] += 1
                self._maybe_finish(slot, tok)
                if self.slot_req[slot] is None:         # finished mid-burst
                    break

    def stats(self) -> Dict[str, Any]:
        """Engine counters since construction, with host-clock throughput."""
        c = dict(self._counters)
        elapsed = time.monotonic() - c.pop("start")
        c["elapsed_s"] = elapsed
        c["tokens_per_s"] = c["tokens_out"] / elapsed if elapsed > 0 else 0.0
        if self.use_prefix:
            c["prefix_cache"] = self.prefix_cache_stats()
        if self.graphs:
            c["graph_pool_bytes"] = pool_bytes(self._pool)
        return c

    def run(self, max_steps: int = 10_000) -> List[GenerationResult]:
        """Drive until every queued and active request finishes."""
        for _ in range(max_steps):
            if not self.queue and self.num_active == 0:
                break
            self.step()
        out, self.finished = self.finished, []
        return out

    def generate(self, prompts, max_new_tokens: int = 64,
                 temperature: float = 0.0) -> List[List[int]]:
        """Submit a batch of prompts, run to completion, return the output
        token lists in prompt order."""
        reqs = [Request(prompt_tokens=p, max_new_tokens=max_new_tokens,
                        temperature=temperature) for p in prompts]
        for r in reqs:
            self.submit(r)
        by_id = {r.request_id: r for r in self.run()}
        missing = [r.request_id for r in reqs if r.request_id not in by_id]
        if missing:
            raise RuntimeError(f"{len(missing)} request(s) unfinished after run()'s step "
                               "budget: call run(max_steps=...) with a larger budget")
        return [by_id[r.request_id].output_tokens for r in reqs]
