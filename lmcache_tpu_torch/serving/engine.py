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
  so a slot can be reused at once;
- chunks that reach the engine off its device (CacheGen host chunks from
  the remote tier, still range-coded, or host tensors) are injected in
  groups of ``inject_group_chunks``: one upload, one range-decoder launch
  and one dequantization per group, the decode of group k+1 issued before
  group k is injected. Chunks already on the engine's device inject at once;
- CacheBlend: a request with ``context_chunks`` (independently cached text
  chunks, such as retrieved documents and a question) is admitted by
  :class:`lmcache_tpu_torch.blend.CacheBlender` instead of a prefill: the
  chunks' KV is reused at any position, ``blend_recompute_ratio`` of the
  tokens are recomputed, the healed KV is injected into the slot and
  decoding starts at once. Healed KV is approximate, so it is never stored
  back under the exact prefix hashes.

- multi-token decode, as in the JAX engine: ``decode_block > 1`` runs that
  many decode steps with sampling on the device and one device-to-host copy
  of the ``[B, decode_block]`` tokens (stops are applied on the host after
  the block; the tokens past a stop are dropped); ``spec_lookahead = K``
  verifies K prompt-lookup proposals (``_ngram_propose`` over the last
  ``spec_ngram`` tokens) of each greedy request in one ``K + 1``-token
  forward and keeps the accepted ones, exactly the tokens sequential greedy
  decode gives. The two are mutually exclusive. A batch holding a
  ``logprobs`` request takes the single step, and a batch with no greedy
  request takes the single step instead of the verification;
- ``SamplingParams.logprobs = n`` records each sampled token's logprob and
  the top ``n`` alternatives (``Request.logprobs``).

Greedy decoding gives the JAX engine's tokens. Sampled decoding draws from a
``torch.Generator`` per request (seeded from ``SamplingParams.seed``, else
from the engine's own generator), one draw a token whatever the decode mode:
reproducible within the port, not equal to ``jax.random``'s draws.

``mesh`` (``lmcache_tpu_torch.parallel.make_mesh``): one engine a rank, every
rank running the same scheduler over the same requests with the parameters
of ``parallel.shard_params``. The pool holds this rank's kv heads on "model"
(every head where they do not divide it) and, where ``max_batch`` divides
"data", the slots of this rank's data index: a slot's prefill runs on its
owners only, whose last logits are then broadcast over "data", and a
batched step computes each rank's own rows and gathers the logits over
"data", so every rank samples every row from the same seeded generator and
picks the same token. The cache tiers: a ``cache_engine`` a rank, over the
metadata of ``parallel.shard_metadata`` (``world_size`` the "model" size,
``worker_id`` the rank's "model" index), stores and retrieves the rank's
head slice of the slots it owns; the ranks agree on the hit length before
they inject. CacheBlend (``context_chunks``) blends each rank's head slice
(``blend.py``) on the slot's owners.
"""

import time
from typing import List, Optional

import numpy as np
import torch

from lmcache_tpu_torch import kv
from lmcache_tpu_torch.cache_engine import LMCacheEngine
from lmcache_tpu_torch.logging_utils import init_logger
from lmcache_tpu_torch.models import llama
from lmcache_tpu_torch.parallel.mesh import axis
from lmcache_tpu_torch.serving.request import (Request, RequestState,
                                               SamplingParams)
from lmcache_tpu_torch.storage.serde.cachegen_serde import (
    finish_host_chunks, staging, upload)
from lmcache_tpu_torch.utils import resolve_device

logger = init_logger(__name__)


def _ngram_propose(tokens: np.ndarray, ngram: int, k: int) -> np.ndarray:
    """Prompt-lookup speculation: if the last ``ngram`` tokens occurred
    earlier in the sequence, propose the ``k`` tokens that followed their
    most recent occurrence (the JAX engine's ``_ngram_propose``)."""
    t = np.asarray(tokens, np.int32).reshape(-1)
    n = min(ngram, len(t) - 1)
    if n <= 0 or len(t) < n + 2:
        return t[:0]
    tail = t[-n:]
    # candidate windows strictly before the tail's own position
    body = t[:len(t) - 1]
    win = np.lib.stride_tricks.sliding_window_view(body, n)
    hits = np.nonzero((win == tail).all(axis=1))[0]
    if hits.size == 0:
        return t[:0]
    j = int(hits[-1]) + n  # position right after the latest match
    return t[j:j + k]


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
        # torch.multinomial's one-sample draw, argmax(p / q) with q ~ Exp(1)
        # from the row's generator, without its checks that read the
        # probabilities back to the host
        q = torch.empty_like(probs).exponential_(1, generator=generators[i])
        toks[i] = torch.argmax(probs / q)
    return toks


def _token_logprobs(logits, toks, n: int):
    """The sampled tokens' logprobs and the top-``n`` alternatives (ids and
    logprobs, best first), as the JAX engine's ``_token_logprobs``: logits
    [B, V] raw, toks [B]."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    chosen = lp.gather(-1, toks.reshape(-1, 1).to(lp.device).long())[:, 0]
    top_lp, top_id = torch.topk(lp, n, dim=-1)
    return chosen, top_id, top_lp


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
        spec_ngram: int = 3,
        mesh=None,
        blend_recompute_ratio: float = 0.15,
    ):
        if kv_dtype not in ("native", "int8"):
            raise ValueError(f"Invalid kv_dtype: {kv_dtype}")
        if spec_lookahead and decode_block > 1:
            raise ValueError(
                "spec_lookahead and decode_block > 1 are mutually "
                "exclusive multi-token mechanisms")
        self.mesh = mesh
        self._check_config(cfg)
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self._tp, self._dp = axis(mesh, "model"), axis(mesh, "data")
        self.B = max_batch
        # with "data" splitting the slots, this rank keeps slots
        # [_slot0, _slot0 + _local_B) of the pool
        self._local_B = self.B
        if self._splits_slots():
            self._local_B = self.B // self._dp.size
        self._slot0 = (self._dp.index * self._local_B
                       if self._local_B < self.B else 0)
        self.S = max_seq or cfg.max_seq_len
        self.cache_engine = cache_engine
        self.eos_token_id = eos_token_id
        self.save_decode_cache = save_decode_cache
        # publish the prompt KV to the cache tiers the moment prefill
        # completes (TTFT time) instead of at request completion
        self.eager_store = eager_store
        self.kv_dtype = kv_dtype
        self.spec_lookahead = spec_lookahead
        self.spec_ngram = spec_ngram
        self.decode_block = decode_block
        # pool slack past S: parked idle-row writes land here (the batched
        # decode step writes every row), and so do the writes of a block or
        # a verification past a request's last token
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
        self._blend_ratio = blend_recompute_ratio
        self._blender = None
        self._check_shard_metadata()
        if self._tp.size > 1 and not self._heads_split() and isinstance(
                cfg, llama.LlamaConfig):
            logger.warning(
                "n_kv_heads (%d) does not divide the mesh's model axis "
                "(%d): every rank gathers q, k and v and holds the whole "
                "pool", cfg.n_kv_heads, self._tp.size)

    def _check_config(self, cfg: llama.LlamaConfig) -> None:
        """Refuse a config this engine's forward does not run."""
        llama.check_supported(cfg)

    # -- the mesh -------------------------------------------------------------

    def _splits_slots(self) -> bool:
        """Whether "data" splits the slots between the data ranks (the
        dense pools); a paged arena is replicated over "data"."""
        return self._dp.size > 1 and self.B % self._dp.size == 0

    def _heads_split(self) -> bool:
        """Whether each rank holds a head slice of the KV."""
        return llama.kv_heads(self.cfg, self.mesh) < self.cfg.n_kv_heads

    def _check_shard_metadata(self) -> None:
        """A rank that stores a head slice does so under its own key
        namespace: the cache engine's metadata must name this rank's
        "model" index as its worker among the "model" size."""
        if self.cache_engine is None or not self._heads_split():
            return
        meta = self.cache_engine.metadata
        if (meta.world_size, meta.worker_id) != (self._tp.size,
                                                 self._tp.index):
            raise ValueError(
                f"this rank stores head slice {self._tp.index} of "
                f"{self._tp.size}; its cache engine's metadata says worker "
                f"{meta.worker_id} of {meta.world_size} "
                f"(parallel.shard_metadata)")

    def _owns(self, slot: int) -> bool:
        """Whether this rank holds ``slot`` of the pool."""
        return self._slot0 <= slot < self._slot0 + self._local_B

    def _local(self, slot: int) -> int:
        """``slot``'s row in this rank's pool."""
        return slot - self._slot0

    def _share_row(self, logits, slot: int):
        """The logits [V] of a row computed by ``slot``'s owners, on every
        rank (a broadcast over "data" where it splits the slots)."""
        if self._local_B == self.B:
            return logits
        if logits is None:
            logits = torch.empty(self.cfg.vocab_size, dtype=torch.float32,
                                 device=self.device)
        return self._dp.broadcast(logits.contiguous(),
                                  slot // self._local_B)

    def _world_min(self, n: int) -> int:
        """The least ``n`` over every rank of the mesh."""
        if self.mesh is None:
            return n
        t = torch.tensor([n], dtype=torch.int64, device=self.device)
        torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MIN)
        return int(t)

    def _hit_limit(self, req: Request, tokens: np.ndarray,
                   limit: int) -> int:
        """The tokens a retrieve may inject: at most ``limit``, and on a
        mesh at most every rank's hit length, so that every rank injects
        (and for an int8 pool quantizes, with a sum over "model") the same
        chunks."""
        if self.mesh is None:
            return limit
        hits = (self.cache_engine.lookup(tokens) if self._owns(req.slot)
                else len(tokens))
        return min(limit, self._world_min(hits))

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
                   device=self.device, mesh=self.mesh)

    def _slot_view(self, slot: int):
        """One slot of the pool as a batch-1 pool (views, no copy)."""
        b = self._local(slot)
        if self.kv_dtype == "int8":
            return {name: t[:, :, b:b + 1]
                    for name, t in self.kv_pool.items()}
        return self.kv_pool[:, :, b:b + 1]

    def _get_blender(self):
        if self._blender is None:
            if self.cache_engine is None:
                raise ValueError(
                    "context_chunks requests need a cache_engine")
            self._blender = self._new_blender()
        return self._blender

    def _new_blender(self):
        """The blender of this engine's model family."""
        from lmcache_tpu_torch.blend import CacheBlender
        return CacheBlender(self.cfg, self.params, self.cache_engine,
                            recompute_ratio=self._blend_ratio, mesh=self.mesh)

    # -- public API ---------------------------------------------------------

    def add_request(self, req: Request) -> Request:
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

    def _record_row_logprobs(self, req: Request, logits_row, tok: int):
        """Attach the sampled token's logprob and the top-n alternatives to
        the request (nothing unless ``sampling.logprobs > 0``); logits_row
        is the [V] raw logits the token was sampled from."""
        n = req.sampling.logprobs
        if n <= 0:
            return
        chosen, ids, lps = _token_logprobs(logits_row[None],
                                           torch.tensor([tok]), n)
        if req.logprobs is None:
            req.logprobs = []
        req.logprobs.append({
            "token": int(tok),
            "logprob": float(chosen[0]),
            "top": list(zip(ids[0].tolist(), lps[0].tolist())),
        })

    def _begin_admit(self, req: Request) -> None:
        """Assign a slot, inject the cached prefix, and enqueue the
        request for incremental prefill. Resumed (preempted) requests
        re-enter here: ``all_tokens`` includes their decoded tokens, whose
        KV the preemptor stored to the cache tiers."""
        req.slot = self.free_slots.pop(0)
        req.state = RequestState.RUNNING
        self._on_slot_assigned(req)
        if req.context_chunks is not None:
            self._admit_blend(req)
            return
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
        logits = (self._prefill_segment(req, pos, seg)
                  if self._owns(req.slot) else None)
        req.prefill_pos = pos + len(seg)
        if req.prefill_pos == len(tokens):
            self._finish_prefill(req, self._share_row(logits, req.slot))
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
                                  last_logit_only=True, mesh=self.mesh)
        return logits[0, -1]

    def _finish_prefill(self, req: Request, logits) -> None:
        """The prompt KV is resident: store it now under ``eager_store``,
        sample the first token from the last segment's ``logits`` and move
        the request to decoding."""
        self.prefilling.remove(req)
        self._on_prefill_complete(req)
        if (self.eager_store and self.cache_engine is not None
                and self._owns(req.slot)):
            np_ = req.num_prompt_tokens
            self.cache_engine.store(req.all_tokens[:np_],
                                    self._read_slot(req.slot, np_),
                                    blocking=False)
        self._assign_slot_generator(req)
        tok = self._sample_row(logits, req)
        req.output_tokens.append(tok)
        self._record_row_logprobs(req, logits, tok)
        if req.ttft_s is None:
            req.ttft_s = time.perf_counter() - req.arrival_s
        self.running.append(req)
        self._maybe_finish(req)

    def _read_slot(self, slot: int, n: int) -> torch.Tensor:
        """KV blob [L, 2, n, H, D] (wire fmt) of one slot: a VIEW of the
        pool, which the storage tier copies before ``put`` returns. An int8
        pool is dequantized to the model dtype (a new tensor)."""
        b = self._local(slot)
        if self.kv_dtype != "int8":
            return llama.cache_to_blob(self.kv_pool, b, n)
        return llama.quantized_cache_to_blob(
            self.kv_pool, b, n, llama.torch_dtype(self.cfg))

    def _inject(self, blob: torch.Tensor, slot: int, pos: int) -> None:
        """Write a wire blob [L, 2, t, H, D] into ``slot`` at token offset
        ``pos``, in place; an int8 pool quantizes it on the way in (a
        token's absmax over every rank's heads on a mesh)."""
        if self.kv_dtype == "int8":
            llama.blob_into_quantized_cache(
                self.kv_pool, blob, self._local(slot), pos,
                llama.head_absmax(self.cfg, self._tp))
        else:
            llama.blob_into_cache(self.kv_pool, blob, self._local(slot), pos)

    # chunks per grouped upload + decode + inject in _stream_inject: large
    # enough to amortize the per-group launches, small enough that the first
    # inject does not wait for the whole prefix
    inject_group_chunks = 16

    def _group_key(self, blob):
        """Chunks that may share one batched inject: host chunks of one
        geometry, or host tensors of one shape (the trailing short chunk
        starts its own group)."""
        if hasattr(blob, "to_blob"):
            return ("host", blob.T, blob.g, blob.N, blob.L, blob.H, blob.D)
        if isinstance(blob, torch.Tensor):
            return ("tensor", tuple(blob.shape), blob.dtype)
        raise ValueError(f"the cache tier handed back a "
                         f"{type(blob).__name__}: neither a tensor nor a "
                         f"host chunk")

    def _finish_group(self, group) -> torch.Tensor:
        """A token-consecutive group of pending chunks as ONE blob on the
        engine's device: host chunks in one range-decode + dequantize
        batch, host tensors concatenated into one staging buffer (pinned for
        the card) and uploaded without blocking the host."""
        if hasattr(group[0], "to_blob"):
            return finish_host_chunks(group, device=self.device)
        shape = list(group[0].shape)
        shape[2] = sum(t.shape[2] for t in group)
        host = staging(shape, group[0].dtype, self.device)
        torch.cat(group, dim=2, out=host)
        return upload(host, self.device)

    def _grouped_stream(self, stream, limit: int, align: int, inject_at):
        """Walk a ``retrieve_stream`` and inject what it yields: chunks on
        the engine's device at once, others in groups of
        ``inject_group_chunks`` (:meth:`_finish_group`). The decode of group
        k+1 is issued before group k is injected, so the device's queue
        holds decode(k) decode(k+1) inject(k) decode(k+2) inject(k+1) ...
        Each group's payload and tables are uploaded from pinned host memory
        without blocking, so the host goes on to fetch and parse group k+2
        while the card decodes and injects the groups before it, on the one
        stream. Each chunk is
        cut to ``limit`` tokens and to a multiple of ``align``. Returns the
        position just past the last injected token (None if none)."""
        pending, pending_pos, pending_key = [], 0, None
        staged = None  # finished but not yet injected (blob, pos)
        cached = None

        def flush():
            nonlocal pending, pending_key, staged
            if not pending:
                return
            blob = self._finish_group(pending)
            if staged is not None:
                inject_at(*staged)
            staged = (blob, pending_pos)
            pending, pending_key = [], None

        try:
            for blob, pos, n in stream:
                take = min(n, limit - pos) // align * align
                if take <= 0:
                    break
                if take < n:
                    blob = kv.slice_blob_tokens(blob, "vllm", 0, take)
                if (isinstance(blob, torch.Tensor)
                        and blob.device == self.device):
                    flush()
                    inject_at(blob, pos)
                else:
                    key = self._group_key(blob)
                    if pending and key != pending_key:
                        flush()
                    if not pending:
                        pending_pos, pending_key = pos, key
                    pending.append(blob)
                    if len(pending) >= self.inject_group_chunks:
                        flush()
                cached = pos + take
                if take < n:
                    break
        finally:
            stream.close()
        flush()
        if staged is not None:
            inject_at(*staged)
        return cached

    def _stream_inject(self, req: Request, tokens: np.ndarray) -> int:
        """Retrieve the cached prefix of ``tokens`` as a stream of chunks
        and inject it into the request's slot (:meth:`_grouped_stream`). At
        least the last token is left to prefill (its logits give the first
        new token). Returns the number of cached tokens injected."""
        if self.cache_engine is None:
            return 0
        limit = self._hit_limit(req, tokens, len(tokens) - 1)
        cached = None
        if self._owns(req.slot):
            cached = self._grouped_stream(
                self.cache_engine.retrieve_stream(tokens), limit, 1,
                lambda blob, pos: self._inject(blob, req.slot, pos))
        if self.mesh is None:
            return cached or 0
        return self._world_min((cached or 0) if self._owns(req.slot)
                               else len(tokens))

    def _admit_blend(self, req: Request) -> None:
        """Admit a chunked-context request through CacheBlend: reuse each
        chunk's independently cached KV (any position), heal a selected
        fraction, inject the result and start decoding: no full prefill.
        Where "data" splits the slots, the slot's owners blend and broadcast
        the last logits, as a prefill does."""
        blender = self._get_blender()
        logits = None
        if self._owns(req.slot):
            logits, kv_blob, _ = blender.blend(req.context_chunks)
            self._inject_blend(req, kv_blob)
        total, n_rec = blender.counts(req.context_chunks)
        req.blended_tokens_recomputed = n_rec
        req.cached_prefix_len = total - n_rec
        logits = self._share_row(logits, req.slot)
        self._assign_slot_generator(req)
        tok = self._sample_row(logits, req)
        req.output_tokens.append(tok)
        self._record_row_logprobs(req, logits, tok)
        req.ttft_s = time.perf_counter() - req.arrival_s
        self.running.append(req)
        self._maybe_finish(req)

    def _inject_blend(self, req: Request, blob: torch.Tensor) -> None:
        """Write a blended prompt's wire blob into the request's slot."""
        self._inject(blob, req.slot, 0)

    # -- decode ---------------------------------------------------------------

    def _prepare_decode(self) -> None:
        """Hook run before each decode step (paged: grow the running
        requests' pages to the step's write horizon, preempting if the arena
        is full)."""

    def _step_context(self) -> tuple:
        """What the batched forward takes after the pool, uploaded once for
        a step or a whole block (paged: the page tables)."""
        return ()

    def _batch_forward(self, tokens, start, ctx) -> torch.Tensor:
        """The batched forward over every slot: tokens [B, T] and start [B]
        on the device; returns logits [B, T, V]. The KV of the tokens is
        written at ``start`` in place."""
        logits, _ = self._forward(self.params, self.cfg, tokens, start,
                                  self.kv_pool, *ctx, mesh=self.mesh)
        return logits

    def _gather_rows(self):
        """Per-slot decode inputs: the newest token [B, 1] and the next
        write position [B] (after n sampled tokens the pool holds prompt +
        n - 1 of them; idle and prefilling rows park at S), and the sampling
        parameters."""
        last = np.zeros((self.B, 1), np.int64)
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
        return last, start, temps, topks, topps

    def _device(self, a) -> torch.Tensor:
        """A host array's copy on the engine's device: to the card from
        pinned memory, queued without blocking the host."""
        t = torch.as_tensor(a)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _decode_all(self) -> None:
        """One decode step for every running request: a verification
        (``spec_lookahead``), a block of ``decode_block`` steps, or one
        batched step (idle rows parked)."""
        self._prepare_decode()
        if not self.running:  # every running request was preempted
            return
        # a logprobs request needs each step's [B, V] logits on the host;
        # the block and the verification sample on the device
        need_lp = any(r.sampling.logprobs > 0 for r in self.running)
        if (self.spec_lookahead and not need_lp and any(
                r.sampling.temperature == 0.0 for r in self.running)):
            # only greedy requests verify exactly; an all-sampled batch
            # takes the one-token step instead of a K+1-token forward
            self._decode_speculative()
            return
        if self.decode_block > 1 and not need_lp:
            self._decode_block()
            return
        last, start, temps, topks, topps = self._gather_rows()
        logits = self._batch_forward(self._device(last), self._device(start),
                                     self._step_context())[:, 0]
        toks = _sample_tokens(logits, temps, self._slot_gens, topks, topps,
                              mode=_sampling_mode(self.running)).tolist()
        for r in list(self.running):
            tok = toks[r.slot]
            r.output_tokens.append(tok)
            if need_lp:
                self._record_row_logprobs(r, logits[r.slot], tok)
            self._maybe_finish(r)

    def _decode_block(self) -> None:
        """``decode_block`` decode steps with the sampling on the device: no
        host sync between steps (each step's tokens feed the next on the
        device, the positions advance there), then one device-to-host copy
        of the ``[B, decode_block]`` tokens. A request that stops mid-block
        drops the tokens past its stop; their KV writes lie past its last
        token, where the next occupant of the slot writes first."""
        last, start, temps, topks, topps = self._gather_rows()
        mode = _sampling_mode(self.running)
        ctx = self._step_context()
        tok, pos = self._device(last), self._device(start)
        steps = []
        for j in range(self.decode_block):
            logits = self._batch_forward(tok, pos + j, ctx)[:, 0]
            nxt = _sample_tokens(logits, temps, self._slot_gens, topks,
                                 topps, mode=mode)
            steps.append(nxt)
            tok = nxt[:, None]
        toks = torch.stack(steps, dim=1).tolist()  # [B, decode_block]
        for r in list(self.running):
            for t in toks[r.slot]:
                r.output_tokens.append(t)
                if r.is_finished(self.eos_token_id):
                    break
            self._maybe_finish(r)

    def _spec_forward(self, inp: np.ndarray, start: np.ndarray):
        """The verification forward: inp [B, K + 1] (the newest token and
        the proposals) written at start [B]; logits [B, K + 1, V]."""
        return self._batch_forward(self._device(inp), self._device(start),
                                   self._step_context())

    def _decode_speculative(self) -> None:
        """Prompt-lookup speculative decode: ONE verification forward gives
        1 + the accepted proposals for each greedy request.

        The inputs are [newest sampled token, proposal_1..K]; the forward
        writes their KV at start..start+K and returns logits for every
        position. Proposal j is accepted while it equals the model's own
        greedy prediction at position j - 1, so the accepted tokens (and
        their KV, already written) are what sequential decode gives; the
        rejected positions hold KV past the request's last token, which the
        next step overwrites before any query can attend it. Sampled rows
        propose nothing and take one token from the first position's
        logits, one draw of their generator as in a single step."""
        K = self.spec_lookahead
        last, start, temps, topks, topps = self._gather_rows()
        inp = np.zeros((self.B, K + 1), np.int64)
        inp[:, 0] = last[:, 0]
        n_prop = np.zeros(self.B, np.int64)
        for r in self.running:
            if r.sampling.temperature == 0.0:  # exact verification: greedy
                prop = _ngram_propose(r.all_tokens, self.spec_ngram, K)
                inp[r.slot, 1:1 + len(prop)] = prop
                n_prop[r.slot] = len(prop)
        logits = self._spec_forward(inp, start)
        toks0 = _sample_tokens(logits[:, 0], temps, self._slot_gens, topks,
                               topps, mode=_sampling_mode(self.running))
        greedy = torch.argmax(logits, dim=-1)  # [B, K + 1]
        toks0, greedy = toks0.tolist(), greedy.tolist()
        for r in list(self.running):
            b = r.slot
            emitted = [toks0[b]]
            j = 1
            while j <= n_prop[b] and inp[b, j] == emitted[-1]:
                emitted.append(greedy[b][j])
                j += 1
            r.spec_proposed += int(n_prop[b])
            r.spec_accepted += j - 1
            for tok in emitted:
                r.output_tokens.append(tok)
                if r.is_finished(self.eos_token_id):
                    break
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
        if (self.cache_engine is None or req.context_chunks is not None
                or not self._owns(req.slot)):
            # healed blend KV is approximate: stored under the exact prefix
            # hashes, later prompts would reuse it as exact
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
