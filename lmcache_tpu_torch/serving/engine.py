"""Continuous-batching serving engine with KV-cache reuse.

Port of ``lmcache_tpu/serving/engine.py::ServingEngine`` (the dense path):

- ONE resident KV pool ``[L, 2, B, H_kv, S + 1, D]`` (head-major); requests
  own slots of it. The model writes K/V into the pool **in place** (the JAX
  engine donates and replaces it), and prefill runs directly on the slot's
  view of the pool, so there is no staged slot copy to write back;
- ``kv_dtype="int8"`` keeps the pool at int8 with one fp32 scale per (layer,
  K/V, slot, token), half the bytes: the model quantizes what it writes,
  attention dequantizes inside its kernel, an injected cache chunk is
  quantized on the way in and a stored slot is dequantized to the model
  dtype on the way out;
- decode is one batched step over every slot each iteration; idle and
  still-prefilling rows park their write at position ``S`` (the pool's one
  spare position), so prefill and decode interleave without corrupting KV;
- prefill runs per request in segments of at most ``prefill_chunk`` tokens
  under a per-step token budget. Segments have their exact length (the JAX
  engine pads tails to power-of-two buckets only to bound XLA compiles);
- cache reuse: on admission the prompt's cached prefix is streamed from the
  LMCacheEngine into the slot and only the suffix is prefilled; on
  completion the prompt KV is stored back without blocking. The storage
  tier copies the slot's KV on the caller's stream before ``put`` returns,
  so a slot can be reused at once.

Greedy decoding gives the JAX engine's tokens. Sampled decoding draws from a
``torch.Generator`` per request (seeded from ``SamplingParams.seed``, else
from the engine's own generator): reproducible within the port, not equal
to ``jax.random``'s draws.

Not ported yet (ROADMAP, module item 7): ``decode_block > 1``,
``spec_lookahead``, ``mesh``, CacheBlend ``context_chunks`` requests and
``logprobs``; each raises ``ValueError``.
"""

import time
from typing import List, Optional

import numpy as np
import torch

from lmcache_tpu_torch import kv
from lmcache_tpu_torch.cache_engine import LMCacheEngine
from lmcache_tpu_torch.logging_utils import init_logger
from lmcache_tpu_torch.models import llama
from lmcache_tpu_torch.serving.request import (Request, RequestState,
                                               SamplingParams)
from lmcache_tpu_torch.utils import resolve_device

logger = init_logger(__name__)

_NOT_PORTED = "not ported yet (ROADMAP, module item 7)"


def _sampling_mode(requests) -> str:
    """Work tier for ``_sample_tokens``: ``"greedy"`` when every row decodes
    at temperature 0 (argmax only), ``"temp"`` when sampled rows exist but
    none restricts top-k/top-p, ``"full"`` otherwise. Rows below the mode
    are still exact (a temperature-0 row takes the argmax)."""
    mode = "greedy"
    for r in requests:
        s = r.sampling
        if s.top_k > 0 or s.top_p < 1.0:
            return "full"
        if s.temperature > 0.0:
            mode = "temp"
    return mode


def _sample_tokens(logits, temps, generators, topks, topps, *,
                   mode: str = "full") -> torch.Tensor:
    """Per-row sampling: temperature / top-k / top-p, as the JAX engine's
    ``_sample_tokens``.

    Args:
        logits: [B, V] float32.
        temps: B floats; 0 => greedy.
        generators: B ``torch.Generator``s on ``logits``' device (rows at
            temperature 0 may have None). Each request owns one, so its
            stream does not depend on what else shares the batch.
        topks: B ints; 0 => no top-k restriction.
        topps: B floats; 1.0 => no nucleus restriction.
    Returns [B] int64 token ids.
    """
    toks = torch.argmax(logits, dim=-1)
    if mode == "greedy":
        return toks
    for i, t in enumerate(temps):
        if t <= 0.0:
            continue
        lg = logits[i]
        if mode == "full":
            k, p = topks[i], topps[i]
            sorted_desc = torch.sort(lg, descending=True).values
            # top-k: k-th largest value as the cutoff (k == 0 -> none)
            if k > 0:
                kcut = sorted_desc[min(k, lg.numel()) - 1]
                lg = torch.where(lg < kcut, float("-inf"), lg)
            # top-p over the k-restricted distribution: keep the smallest
            # descending-prob prefix whose mass reaches p
            if p < 1.0:
                sorted_k = torch.sort(lg, descending=True).values
                probs = torch.softmax(sorted_k, dim=-1)
                keep = (torch.cumsum(probs, dim=-1) - probs) < p
                pcut = torch.min(torch.where(keep, sorted_k, float("inf")))
                lg = torch.where(lg < pcut, float("-inf"), lg)
        probs = torch.softmax(lg / max(t, 1e-6), dim=-1)
        toks[i] = torch.multinomial(probs, 1, generator=generators[i])[0]
    return toks


class ServingEngine:

    def __init__(
        self,
        cfg: llama.LlamaConfig,
        params,
        *,
        max_batch: int = 8,
        max_seq: Optional[int] = None,
        cache_engine: Optional[LMCacheEngine] = None,
        eos_token_id: Optional[int] = None,
        save_decode_cache: bool = False,
        eager_store: bool = False,
        device="cuda",
        kv_dtype: str = "native",
        decode_block: int = 1,
        prefill_chunk: int = 512,
        prefill_token_budget: Optional[int] = None,
        admission_window: int = 8,
        max_admission_bypass: int = 64,
        spec_lookahead: int = 0,
        mesh=None,
    ):
        for name, unported in (("decode_block > 1", decode_block > 1),
                               ("spec_lookahead", bool(spec_lookahead)),
                               ("mesh", mesh is not None)):
            if unported:
                raise ValueError(f"{name} is {_NOT_PORTED}")
        if kv_dtype not in ("native", "int8"):
            raise ValueError(f"Invalid kv_dtype: {kv_dtype}")
        self._check_config(cfg)
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.B = max_batch
        self.S = max_seq or cfg.max_seq_len
        self.cache_engine = cache_engine
        self.eos_token_id = eos_token_id
        self.save_decode_cache = save_decode_cache
        # publish the prompt KV to the cache tiers the moment prefill
        # completes (TTFT time) instead of at request completion
        self.eager_store = eager_store
        self.kv_dtype = kv_dtype
        # pool slack past S: parked idle-row writes land here (the batched
        # decode step writes every row)
        self._write_horizon = max(decode_block, spec_lookahead + 1)
        self.kv_pool = self._alloc_pool()
        self._forward = (llama.forward_quantized if kv_dtype == "int8"
                         else llama.forward)
        self.free_slots = list(range(self.B))
        self.waiting: List[Request] = []
        self.prefilling: List[Request] = []
        self.running: List[Request] = []
        self.finished: List[Request] = []
        # seeds the per-request generators of requests without a seed
        self._rng = torch.Generator().manual_seed(0)
        self._slot_gens: List[Optional[torch.Generator]] = [None] * self.B
        self.prefill_chunk = prefill_chunk
        # per-step prefill token budget, spent across several prefilling
        # requests oldest-first
        self.prefill_token_budget = prefill_token_budget or prefill_chunk
        # admission scans this many waiting requests for one that fits
        # (bounded head-of-line bypass); after max_admission_bypass
        # consecutive bypasses the window collapses to FIFO
        self.admission_window = admission_window
        self.max_admission_bypass = max_admission_bypass
        self._head_bypasses = 0

    def _check_config(self, cfg: llama.LlamaConfig) -> None:
        """Refuse a config this engine's forward does not run."""
        llama.check_supported(cfg)

    def _alloc_pool(self):
        """Allocate the engine's KV residence (dense slot pool, a tensor or
        for ``kv_dtype="int8"`` the ``{"sym", "scale"}`` dict), with
        ``S + _write_horizon`` positions per slot: idle / still-prefilling
        rows park their decode write at position S. Overridden by
        PagedServingEngine to build the page arena instead, which keeps the
        full ``[L, 2, B, H_kv, S_max, D]`` pool out of paged startup."""
        new = (llama.new_quantized_kv_cache if self.kv_dtype == "int8"
               else llama.new_kv_cache)
        return new(self.cfg, self.B, self.S + self._write_horizon,
                   device=self.device)

    def _slot_view(self, slot: int):
        """One slot of the pool as a batch-1 pool (views, no copy)."""
        if self.kv_dtype == "int8":
            return {name: t[:, :, slot:slot + 1]
                    for name, t in self.kv_pool.items()}
        return self.kv_pool[:, :, slot:slot + 1]

    # -- public API ---------------------------------------------------------

    def add_request(self, req: Request) -> Request:
        if req.context_chunks is not None:
            raise ValueError(f"context_chunks (CacheBlend) is {_NOT_PORTED}")
        if req.sampling.logprobs > 0:
            raise ValueError(f"logprobs is {_NOT_PORTED}")
        total = req.num_prompt_tokens + req.sampling.max_new_tokens
        if total > self.S:
            raise ValueError(
                f"prompt + max_new_tokens ({total}) > max_seq ({self.S})")
        self.waiting.append(req)
        return req

    def has_work(self) -> bool:
        return bool(self.waiting or self.prefilling or self.running)

    def run(self) -> List[Request]:
        """Drive until all requests finish; returns them."""
        while self.has_work():
            self.step()
        return self.finished

    def generate(self, prompts, sampling=None) -> List[Request]:
        """Convenience: submit a batch of prompts and run to completion."""
        reqs = [Request(p, sampling or SamplingParams()) for p in prompts]
        for r in reqs:
            self.add_request(r)
        self.run()
        return reqs

    # -- scheduler ----------------------------------------------------------

    def step(self) -> None:
        """One continuous-batching iteration: admit what fits, spend the
        prefill token budget oldest-first, then one batched decode step for
        every running request."""
        self._admit_from_window()
        if self.waiting and not self.running and not self.prefilling:
            self._on_admission_stall(self.waiting[0])
        budget = self.prefill_token_budget
        for req in list(self.prefilling):
            if budget <= 0:
                break
            budget -= self._advance_prefill(req, budget)
        if self.running:
            self._decode_all()

    def _admit_from_window(self) -> None:
        """Admit requests while slots are free: the first admissible
        request among ``waiting[:admission_window]``, oldest-first, with a
        bounded number of bypasses of a blocked head."""
        while self.free_slots and self.waiting:
            window = self.waiting[:self.admission_window]
            idx = next((i for i, r in enumerate(window)
                        if self._can_admit(r)), None)
            if idx is None:
                return
            if idx > 0:
                if self._head_bypasses >= self.max_admission_bypass:
                    return  # FIFO freeze: wait for the head to fit
                self._head_bypasses += 1
            else:
                self._head_bypasses = 0
            self._begin_admit(self.waiting.pop(idx))

    def _can_admit(self, req: Request) -> bool:
        """Resource check beyond a free slot (paged: arena pages)."""
        return True

    def _on_admission_stall(self, req: Request) -> None:
        """Nothing running or prefilling, yet the head request cannot be
        admitted. The dense engine cannot reach this (a free slot is the
        only resource); the paged engine raises MemoryError."""
        raise RuntimeError(
            f"scheduler stall: request {req.request_id} inadmissible "
            f"with an idle engine")

    # -- internals ----------------------------------------------------------

    def _assign_slot_generator(self, req: Request) -> None:
        """Pin the slot's generator: the request's seed when given
        (reproducible stream), else a fresh seed from the engine's
        generator."""
        seed = req.sampling.seed or int(
            torch.randint(1, 2**62, (1,), generator=self._rng))
        self._slot_gens[req.slot] = torch.Generator(
            device=self.device).manual_seed(seed)

    def _sample_row(self, logits, req: Request) -> int:
        """Sample one token for ``req`` from a [V] logits vector."""
        s = req.sampling
        return int(_sample_tokens(logits[None], [s.temperature],
                                  [self._slot_gens[req.slot]], [s.top_k],
                                  [s.top_p], mode=_sampling_mode([req]))[0])

    def _begin_admit(self, req: Request) -> None:
        """Assign a slot, inject the cached prefix, and enqueue the
        request for incremental prefill. Resumed (preempted) requests
        re-enter here: ``all_tokens`` includes their decoded tokens, whose
        KV the preemptor stored to the cache tiers."""
        req.slot = self.free_slots.pop(0)
        req.state = RequestState.RUNNING
        self._on_slot_assigned(req)
        cached = self._stream_inject(req, req.all_tokens)
        req.cached_prefix_len = cached
        req.prefill_pos = cached
        self.prefilling.append(req)

    def _on_slot_assigned(self, req: Request) -> None:
        """Hook: per-request residence setup (paged: page allocation)."""

    def _on_prefill_complete(self, req: Request) -> None:
        """Hook: the request's prompt KV is fully resident (paged:
        register its pages for prefix sharing)."""

    def _advance_prefill(self, req: Request, budget: Optional[int] = None
                         ) -> int:
        """Prefill one segment of ``req`` — at most ``prefill_chunk``
        tokens, capped by the remaining step ``budget``; the final segment
        finishes the prefill. Returns the number of prompt tokens
        consumed."""
        tokens = req.all_tokens
        pos = req.prefill_pos
        take = self.prefill_chunk if budget is None else min(
            self.prefill_chunk, budget)
        seg = tokens[pos:pos + take]
        logits = self._prefill_segment(req, pos, seg)
        req.prefill_pos = pos + len(seg)
        if req.prefill_pos == len(tokens):
            self._finish_prefill(req, logits)
        return len(seg)

    def _prefill_segment(self, req: Request, pos: int, seg: np.ndarray):
        """Run one prefill segment ``[pos, pos + len(seg))`` of exactly
        its length on the request's slot of the pool (written in place).
        Returns the logits [V] of the segment's last token."""
        tokens = torch.as_tensor(seg, dtype=torch.long,
                                 device=self.device)[None]
        start = torch.tensor([pos], dtype=torch.int32, device=self.device)
        logits, _ = self._forward(self.params, self.cfg, tokens, start,
                                  self._slot_view(req.slot),
                                  last_logit_only=True)
        return logits[0, -1]

    def _finish_prefill(self, req: Request, logits) -> None:
        """The prompt KV is resident: store it now under ``eager_store``,
        sample the first token from the last segment's ``logits`` and move
        the request to decoding."""
        self.prefilling.remove(req)
        self._on_prefill_complete(req)
        if self.eager_store and self.cache_engine is not None:
            np_ = req.num_prompt_tokens
            self.cache_engine.store(req.all_tokens[:np_],
                                    self._read_slot(req.slot, np_),
                                    blocking=False)
        self._assign_slot_generator(req)
        req.output_tokens.append(self._sample_row(logits, req))
        if req.ttft_s is None:
            req.ttft_s = time.perf_counter() - req.arrival_s
        self.running.append(req)
        self._maybe_finish(req)

    def _read_slot(self, slot: int, n: int) -> torch.Tensor:
        """KV blob [L, 2, n, H, D] (wire fmt) of one slot: a VIEW of the
        pool, which the storage tier copies before ``put`` returns. An int8
        pool is dequantized to the model dtype (a new tensor)."""
        if self.kv_dtype != "int8":
            return llama.cache_to_blob(self.kv_pool, slot, n)
        return llama.quantized_cache_to_blob(
            self.kv_pool, slot, n, llama.torch_dtype(self.cfg))

    def _inject(self, blob: torch.Tensor, slot: int, pos: int) -> None:
        """Write a wire blob [L, 2, t, H, D] into ``slot`` at token offset
        ``pos``, in place; an int8 pool quantizes it on the way in."""
        into = (llama.blob_into_quantized_cache if self.kv_dtype == "int8"
                else llama.blob_into_cache)
        into(self.kv_pool, blob, slot, pos)

    def _stream_inject(self, req: Request, tokens: np.ndarray) -> int:
        """Retrieve the cached prefix of ``tokens`` as a stream of chunks
        and copy each into the request's slot as it arrives. At least the
        last token is left to prefill (its logits give the first new
        token). Returns the number of cached tokens injected."""
        if self.cache_engine is None:
            return 0
        limit = len(tokens) - 1
        cached = 0
        stream = self.cache_engine.retrieve_stream(tokens)
        try:
            for blob, pos, n in stream:
                take = min(n, limit - pos)
                if take <= 0:
                    break
                if take < n:
                    blob = kv.slice_blob_tokens(blob, "vllm", 0, take)
                self._inject(blob, req.slot, pos)
                cached = pos + take
                if take < n:
                    break
        finally:
            stream.close()
        return cached

    def _decode_all(self) -> None:
        """One batched decode step for every slot (idle rows parked)."""
        last = np.zeros((self.B, 1), np.int64)
        # the next write of a running request is at prompt + n - 1 after n
        # sampled tokens; idle / prefilling rows park at S
        start = np.full(self.B, self.S, np.int32)
        temps = [0.0] * self.B
        topks = [0] * self.B
        topps = [1.0] * self.B
        for r in self.running:
            last[r.slot, 0] = r.output_tokens[-1]
            start[r.slot] = r.num_prompt_tokens + len(r.output_tokens) - 1
            temps[r.slot] = r.sampling.temperature
            topks[r.slot] = r.sampling.top_k
            topps[r.slot] = r.sampling.top_p
        logits, _ = self._forward(self.params, self.cfg,
                                  torch.as_tensor(last, device=self.device),
                                  torch.as_tensor(start, device=self.device),
                                  self.kv_pool)
        toks = _sample_tokens(logits[:, 0], temps, self._slot_gens, topks,
                              topps,
                              mode=_sampling_mode(self.running)).tolist()
        for r in list(self.running):
            r.output_tokens.append(int(toks[r.slot]))
            self._maybe_finish(r)

    def _maybe_finish(self, req: Request) -> None:
        if not req.is_finished(self.eos_token_id):
            return
        req.state = RequestState.FINISHED
        req.finish_s = time.perf_counter()
        self.running = [r for r in self.running if r is not req]
        self.finished.append(req)
        self._store_back(req)
        self.free_slots.append(req.slot)

    def _store_back(self, req: Request) -> None:
        """Store the finished request's KV into the cache tiers without
        blocking (reference lmcache_store_kv semantics)."""
        if self.cache_engine is None:
            return
        n = req.total_len if self.save_decode_cache else req.num_prompt_tokens
        # the pool holds KV for total_len - 1 tokens (the newest sampled
        # token was never forwarded)
        n = min(n, req.total_len - 1)
        if n <= 0:
            return
        self.cache_engine.store(req.all_tokens[:n],
                                self._read_slot(req.slot, n),
                                blocking=False)
