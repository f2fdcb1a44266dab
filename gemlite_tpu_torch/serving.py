# SPDX-License-Identifier: Apache-2.0
"""Continuous-batching serving engine (counterpart of ``gemlite_tpu/serving.py``).

* A fixed pool of ``max_batch`` slots, each owning a stripe of one dense KV
  cache (B = max_batch, T = max_seq_len), written in place.
* Prompts are prefilled slot-locally, padded to power-of-two buckets; prompts
  longer than ``prefill_chunk`` (or than the largest bucket) are prefilled one
  chunk per engine step, interleaved with decode of the other slots.
* Every engine step runs one batched decode over all slots. Inactive slots
  write their k/v at a stale row of their own stripe, which is overwritten on
  readmission and never attended. Attention reads only the live-KV bucket.
* Between admissions and finishes the per-slot decode state (tokens, lengths,
  temperatures, active mask) stays on the device.
* On the card the engine checks after every prefill and decode step that each
  quantized linear ran on a hand-written kernel (``KERNEL_ROUTES``: decode,
  prefill, dequantize, int8_exact or general_fused).

Unlike the JAX engine, the default is ``paged=False``: the paged cache, the
speculative draft, scan-over-layers decode and mesh sharding are not ported
yet and raise. Sampling is greedy, or temperature sampling from a
``torch.Generator`` seeded with ``seed`` (it does not reproduce JAX's stream).
"""

import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .core import resolve_device
from .models.llama import init_kv_cache, llama_decode_step_batched, llama_forward
from .ops.dispatch import KERNEL_ROUTES, KERNEL_TRACE

__all__ = ["Request", "ContinuousBatchingEngine", "GenerationResult"]


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


def _next_bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class ContinuousBatchingEngine:
    """Slot-based continuous batching over a quantized Llama param dict."""

    def __init__(self, params, cfg, max_batch: int = 8, eos_id: Optional[int] = None,
                 prefill_buckets=(32, 64, 128, 256, 512, 1024, 2048), seed: int = 0,
                 prefill_chunk: Optional[int] = None, draft=None, paged: bool = False,
                 mesh=None, scan_layers: bool = False, device=None):
        if paged:
            raise NotImplementedError("queued: the paged KV cache (paged=True)")
        if draft is not None:
            raise NotImplementedError("queued: speculative decoding (draft=)")
        if scan_layers:
            raise NotImplementedError("queued: scan-over-layers decode (scan_layers=True)")
        if mesh is not None:
            raise NotImplementedError("queued: mesh-sharded serving (mesh=)")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the engine on "
                             f"{self.device}")
        self.params = params
        self.cfg = cfg
        self.max_batch = max_batch
        self.eos_id = eos_id
        self.buckets = tuple(b for b in sorted(prefill_buckets) if b <= cfg.max_seq_len)
        if not self.buckets:
            raise ValueError(f"no prefill bucket fits max_seq_len={cfg.max_seq_len}; "
                             "pass prefill_buckets with at least one value <= it")
        self.prefill_chunk = prefill_chunk
        self.kv = init_kv_cache(cfg, max_batch, device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._check_kernels = self.device.type == "cuda"

        self._dev: Optional[Dict[str, torch.Tensor]] = None
        self._dev_dirty = True

        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self.slot_len = np.zeros(max_batch, np.int32)        # valid cache length
        self.slot_out: List[List[int]] = [[] for _ in range(max_batch)]
        self.slot_last = np.zeros(max_batch, np.int32)       # last sampled token
        self.slot_pending: List[Optional[np.ndarray]] = [None] * max_batch
        self.queue: List[Request] = []
        self.finished: List[GenerationResult] = []
        self._req_times: Dict[int, List[Optional[float]]] = {}
        self._counters = {"steps": 0, "decode_steps": 0, "prefills": 0,
                          "prefill_chunks": 0, "tokens_out": 0,
                          "start": time.monotonic()}

        # decode attention reads only the live-KV bucket
        self.decode_buckets = []
        b = 256
        while b < cfg.max_seq_len:
            self.decode_buckets.append(b)
            b *= 2
        self.decode_buckets.append(cfg.max_seq_len)

    # ------------------------------------------------------------------
    # device work
    # ------------------------------------------------------------------
    def _checked(self, fn, *args, **kw):
        """Run one model call; on the card, raise unless every quantized
        linear in it ran on one of the kernels of ``KERNEL_ROUTES``."""
        KERNEL_TRACE.clear()
        out = fn(*args, **kw)
        if self._check_kernels:
            bad = sorted(set(KERNEL_TRACE) - set(KERNEL_ROUTES))
            if bad:
                raise RuntimeError(f"linears ran off the kernels: routes {bad}")
        return out

    def _prefill(self, tokens: np.ndarray, slot: int, cache_len: int, true_len: int):
        """One padded prompt piece (1, C) into the slot's stripe at cache_len;
        returns the logits (1, V) at its last valid position."""
        t = torch.as_tensor(tokens, device=self.device)
        kv_slot = self.kv[:, :, slot:slot + 1]           # a view: written in place
        logits, _ = self._checked(llama_forward, self.params, self.cfg, t, kv=kv_slot,
                                  cache_len=cache_len)
        return logits[:, true_len - 1, :]

    def _decode(self, tokens, cache_lens, temps, active, t_active):
        logits, _ = self._checked(llama_decode_step_batched, self.params, self.cfg, tokens,
                                  self.kv, cache_lens, t_active=t_active)
        nxt = self._sample(logits[:, 0, :], temps)
        return nxt, cache_lens + active

    def _sample(self, logits: torch.Tensor, temps: torch.Tensor) -> torch.Tensor:
        """Greedy where temps == 0, else a draw from softmax(logits / T)."""
        logits = logits.to(torch.float32)
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)
        if not bool((temps > 0).any()):
            return greedy
        probs = torch.softmax(logits / torch.clamp(temps, min=1e-6)[:, None], dim=-1)
        sampled = torch.multinomial(probs, 1, generator=self.generator)[:, 0].to(torch.int32)
        return torch.where(temps > 0, sampled, greedy)

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

    def _first_token(self, slot: int, logits: torch.Tensor):
        req = self.slot_req[slot]
        temps = torch.tensor([req.temperature], dtype=torch.float32, device=self.device)
        tok = int(self._sample(logits, temps)[0])
        self.slot_out[slot] = [tok]
        self.slot_last[slot] = tok
        self._mark_first_token(req)
        self._counters["tokens_out"] += 1
        self._maybe_finish(slot, tok)

    def _admit(self):
        """Fill free slots from the queue with slot-local prefill."""
        if self.queue and any(r is None for r in self.slot_req):
            self._dev_dirty = True
        for slot in range(self.max_batch):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            prompt = np.asarray(req.prompt_tokens, np.int32).reshape(-1)
            self.slot_req[slot] = req
            self.slot_len[slot] = 0
            self.slot_out[slot] = []
            if len(prompt) > self.buckets[-1] or (
                    self.prefill_chunk and len(prompt) > self.prefill_chunk):
                # chunked admission: chunks advance in step()
                self.slot_pending[slot] = prompt
                continue
            Lb = _next_bucket(len(prompt), self.buckets)
            padded = np.zeros((1, Lb), np.int32)
            padded[0, :len(prompt)] = prompt
            logits = self._prefill(padded, slot, 0, len(prompt))
            self._counters["prefills"] += 1
            self.slot_len[slot] = len(prompt)
            self._first_token(slot, logits)

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
            logits = self._prefill(padded, slot, int(self.slot_len[slot]), len(chunk))
            self._counters["prefill_chunks"] += 1
            self.slot_len[slot] += len(chunk)
            if len(rest):
                self.slot_pending[slot] = rest
                continue
            self.slot_pending[slot] = None
            self._dev_dirty = True           # slot joins the decode batch
            self._first_token(slot, logits)

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
        max_len = int(lens[active].max())
        t_act = _next_bucket(max_len + 1, self.decode_buckets)
        if self._dev is not None and not self._dev_dirty:
            tokens, lens_d = self._dev["tokens"], self._dev["lens"]
            temps_d, act_d = self._dev["temps"], self._dev["active"]
        else:
            dev = self.device
            tokens = torch.as_tensor(self.slot_last.reshape(-1, 1), device=dev)
            lens_d = torch.as_tensor(lens, device=dev)
            temps_d = torch.tensor([r.temperature if r is not None else 0.0
                                    for r in self.slot_req], dtype=torch.float32, device=dev)
            act_d = torch.as_tensor(active.astype(np.int32), device=dev)
        nxt_d, lens_next = self._decode(tokens, lens_d, temps_d, act_d, t_act)
        self._dev = {"tokens": nxt_d[:, None], "lens": lens_next, "temps": temps_d,
                     "active": act_d}
        self._dev_dirty = False
        nxt = nxt_d.cpu().numpy()
        self._counters["decode_steps"] += 1
        for slot in range(self.max_batch):
            if not active[slot]:
                continue
            tok = int(nxt[slot])
            self.slot_out[slot].append(tok)
            self.slot_last[slot] = tok
            self._counters["tokens_out"] += 1
            self._maybe_finish(slot, tok)

    def stats(self) -> Dict[str, Any]:
        """Engine counters since construction, with host-clock throughput."""
        c = dict(self._counters)
        elapsed = time.monotonic() - c.pop("start")
        c["elapsed_s"] = elapsed
        c["tokens_per_s"] = c["tokens_out"] / elapsed if elapsed > 0 else 0.0
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
