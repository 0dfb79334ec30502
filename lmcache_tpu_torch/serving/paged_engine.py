"""Paged serving engine: continuous batching over a shared page arena.

Port of ``lmcache_tpu/serving/paged_engine.py::PagedServingEngine``. The
dense engine (``serving/engine.py``) reserves ``S_max`` tokens of device
memory per slot; this one allocates fixed-size pages on demand from one
global arena (``models/paged.py`` and the paged-attention kernels), so memory
is bounded by the tokens actually resident:

- admission needs fresh pages for the unshared part of the prompt only and
  backpressures when the arena is full; an arena that can never hold the
  head request raises ``MemoryError``;
- requests with a common prompt prefix share the same physical pages
  (refcounted; freed pages keep their content and prefix registration until
  they are reallocated, so the arena is also a cache);
- decode pages grow on demand; when the arena cannot satisfy a growth the
  latest-admitted request is preempted into the cache tiers and resumes
  later from them;
- the arena is bf16 (``kv_dtype="native"``) or int8 with per-token scales
  (``kv_dtype="int8"``, half the bytes), written **in place**;
- a CacheBlend request (``context_chunks``) is healed by the blender and
  its KV scattered onto fresh pages, padded to whole pages (the pad lies
  past ``kv_len`` and is masked). Blend pages are never shared as an exact
  prefix, stored back, or preempted: healed KV cannot be restored exactly.

Page size divides the cache-engine chunk_size, so a retrieved cache chunk is
written as whole pages with one scatter; chunks off the engine's device
(CacheGen host chunks from the remote tier) are decoded and scattered in
groups, as in the dense engine.

Not ported yet, each raises ``ValueError``: ``decode_block > 1``,
``spec_lookahead`` and ``logprobs`` (ROADMAP, module item 7) and ``mesh``
(module item 16).
"""

from typing import Dict, List, Optional

import numpy as np
import torch

from lmcache_tpu_torch.cache_engine import LMCacheEngine
from lmcache_tpu_torch.chunks import prefix_chunk_hashes
from lmcache_tpu_torch.logging_utils import init_logger
from lmcache_tpu_torch.models import llama
from lmcache_tpu_torch.models.paged import (PageAllocator, forward_paged,
                                            forward_paged_quantized,
                                            new_paged_kv_pool,
                                            new_quantized_paged_pool,
                                            pages_needed)
from lmcache_tpu_torch.ops.quantized_attention import quantize_tokens
from lmcache_tpu_torch.serving.engine import (ServingEngine, _sample_tokens,
                                              _sampling_mode)
from lmcache_tpu_torch.serving.request import Request, RequestState

logger = init_logger(__name__)


class PagedServingEngine(ServingEngine):

    def __init__(
        self,
        cfg: llama.LlamaConfig,
        params,
        *,
        max_batch: int = 8,
        max_seq: Optional[int] = None,
        num_pages: int = 256,
        page_size: int = 64,
        cache_engine: Optional[LMCacheEngine] = None,
        eos_token_id: Optional[int] = None,
        save_decode_cache: bool = False,
        eager_store: bool = False,
        device="cuda",
        mesh=None,
        decode_block: int = 1,
        prefill_chunk: int = 512,
        kv_dtype: str = "native",  # "native" | "int8" (half-size arena)
        spec_lookahead: int = 0,
        prefill_token_budget: Optional[int] = None,
        admission_window: int = 8,
        max_admission_bypass: int = 64,
        blend_recompute_ratio: float = 0.15,
    ):
        if mesh is not None:
            raise ValueError(
                "mesh is not ported yet (ROADMAP, module item 16)")
        if (cache_engine is not None
                and cache_engine.chunk_size % page_size != 0):
            raise ValueError("page_size must divide the cache chunk_size")
        # _alloc_pool (called from super().__init__) reads these to build
        # the page arena; the dense pool is never materialized
        self.page_size = page_size
        self.num_pages = num_pages
        super().__init__(cfg, params, max_batch=max_batch, max_seq=max_seq,
                         cache_engine=cache_engine,
                         eos_token_id=eos_token_id,
                         save_decode_cache=save_decode_cache,
                         eager_store=eager_store, device=device,
                         kv_dtype=kv_dtype, decode_block=decode_block,
                         prefill_chunk=prefill_chunk,
                         prefill_token_budget=prefill_token_budget,
                         admission_window=admission_window,
                         max_admission_bypass=max_admission_bypass,
                         spec_lookahead=spec_lookahead,
                         blend_recompute_ratio=blend_recompute_ratio)
        self._forward = (forward_paged_quantized
                         if kv_dtype == "int8" else forward_paged)

    def _check_config(self, cfg: llama.LlamaConfig) -> None:
        llama.check_supported(cfg)

    def _alloc_pool(self):
        """Build the page arena instead of the dense slot pool, and the
        scheduler state around it (allocator, page tables, prefix-sharing
        index)."""
        # page-table width covers S + write-horizon positions: idle rows
        # park decode writes at >= S; those land in the null page
        self.NP = -(-(self.S + self._write_horizon) // self.page_size)
        self.allocator = PageAllocator(self.num_pages)
        # host-side page tables; row per slot, null page 0 as padding
        self.page_tables = np.zeros((self.B, self.NP), np.int32)
        self._req_pages: Dict[int, List[int]] = {}
        # prefix sharing: rolling page-granularity prefix hash -> resident
        # page id (registered once a request's prefill completes; evicted
        # when the page is reallocated)
        self._resident: Dict[str, int] = {}
        self._page_hash: Dict[int, str] = {}  # page id -> hash
        self._req_shared: Dict[int, int] = {}  # tokens on shared pages
        return self._alloc_arena()

    def _alloc_arena(self):
        """The arena tensor (bf16/fp32) or int8 dict."""
        if self.kv_dtype == "int8":
            return new_quantized_paged_pool(self.cfg, self.num_pages,
                                            self.page_size,
                                            device=self.device)
        return new_paged_kv_pool(self.cfg, self.num_pages, self.page_size,
                                 device=self.device)

    def _page_ids(self, pages: List[int]) -> torch.Tensor:
        return torch.as_tensor(pages, dtype=torch.long, device=self.device)

    def _inject_pages(self, blob: torch.Tensor, pages: List[int]) -> None:
        """Write a wire blob [L, 2, n*page, H, D] onto whole pages of the
        arena, in place (quantizing per token for an int8 arena). The
        relayout touches one chunk's pages, never the arena."""
        L, _, _, H, D = blob.shape
        n, pg = len(pages), self.page_size
        ids = self._page_ids(pages)
        blob = blob.to(self.device)
        if self.kv_dtype == "int8":
            sym, scl = quantize_tokens(blob, (3, 4))  # scl [L, 2, n*page]
            sym = sym.reshape(L, 2, n, pg, H, D).permute(0, 1, 2, 4, 3, 5)
            self.kv_pool["sym"][:, :, ids] = sym
            self.kv_pool["scale"][:, :, ids] = scl.reshape(L, 2, n, pg)
            return
        paged = blob.reshape(L, 2, n, pg, H, D).permute(0, 1, 2, 4, 3, 5)
        self.kv_pool[:, :, ids] = paged.to(self.kv_pool.dtype)

    def _read_pages(self, pages: List[int]) -> torch.Tensor:
        """Gather whole pages into a wire blob [L, 2, n*page, H, D]
        (dequantized for an int8 arena): a COPY of the pages, not a view."""
        ids = self._page_ids(pages)
        if self.kv_dtype == "int8":
            g = self.kv_pool["sym"][:, :, ids].float()  # [L,2,n,H,page,D]
            s = self.kv_pool["scale"][:, :, ids]  # [L, 2, n, page]
            g = (g * s[:, :, :, None, :, None]).to(
                llama.torch_dtype(self.cfg))
        else:
            g = self.kv_pool[:, :, ids]
        L, _, n, H, pg, D = g.shape
        return g.permute(0, 1, 2, 4, 3, 5).reshape(L, 2, n * pg, H, D)

    def _read_slot(self, slot: int, n: int) -> torch.Tensor:
        """KV blob [L, 2, n, H, D] of the request in ``slot``, gathered
        from its pages."""
        pages = self.page_tables[slot, :pages_needed(n, self.page_size)]
        return self._read_pages(pages.tolist())[:, :, :n]

    # -- scheduler hooks -----------------------------------------------------

    def _page_hashes(self, req: Request, tokens: np.ndarray):
        """Rolling page-granularity prefix hashes of the request's tokens,
        memoized on the request: _can_admit runs every scheduler step while
        the request waits."""
        cached = getattr(req, "_page_hash_cache", None)
        if cached is not None and cached[0] == len(tokens):
            return cached[1]
        hashes = prefix_chunk_hashes(tokens, self.page_size)
        req._page_hash_cache = (len(tokens), hashes)
        return hashes

    def _match_resident_prefix(self, req: Request, tokens: np.ndarray):
        """Longest run of already-resident pages whose rolling prefix hash
        matches this prompt. Capped so that at least one token is always
        recomputed (the prefill must yield next-token logits), which also
        keeps a request's writes past its shared pages. Blend requests
        never match: their admission takes no shared pages."""
        if (req.context_chunks is not None or tokens is None
                or len(tokens) < 2):
            return []
        max_pages = (len(tokens) - 1) // self.page_size
        shared = []
        for h in self._page_hashes(req, tokens)[:max_pages]:
            page = self._resident.get(h)
            if page is None:
                break
            shared.append(page)
        return shared

    def _admission_pages(self, req: Request, tokens) -> int:
        """Pages a request needs AT ADMISSION. With a cache engine,
        prompt-only (decode pages grow on demand; exhaustion preempts into
        the tiers). Without one, preemption is impossible, so the full
        worst-case prompt+max_new footprint is reserved up front."""
        n = len(tokens)
        if self.cache_engine is None:
            n += req.sampling.max_new_tokens
        return pages_needed(n, self.page_size)

    def _alloc_pages(self, n):
        """Allocate fresh pages, evicting any stale prefix-cache
        registrations they still carry."""
        pages = self.allocator.alloc(n)
        for p in pages:
            h = self._page_hash.pop(p, None)
            if h is not None and self._resident.get(h) == p:
                del self._resident[h]
        return pages

    def _can_admit(self, req: Request) -> bool:
        """Admission needs FRESH pages for the unshared part of the prompt
        only: shared-prefix pages are already resident (live, or
        freed-but-unrecycled), and decode pages are allocated on demand."""
        tokens = req.all_tokens
        matched = self._match_resident_prefix(req, tokens)
        fresh = self._admission_pages(req, tokens) - len(matched)
        # reclaiming free-but-cached matches also consumes free-list slots
        reclaimed = sum(1 for p in matched
                        if self.allocator.refcount(p) == 0)
        return fresh + reclaimed <= self.allocator.num_free

    def _on_admission_stall(self, req: Request) -> None:
        raise MemoryError(
            f"request {req.request_id} needs "
            f"{self._admission_pages(req, req.all_tokens)} pages; "
            f"arena has {self.allocator.num_free} and nothing is running")

    def _on_slot_assigned(self, req: Request) -> None:
        tokens = req.all_tokens
        shared = self._match_resident_prefix(req, tokens)
        if shared:
            # live pages take an extra reference; freed-but-cached pages
            # are pulled back out of the free list content-intact
            live = [p for p in shared if self.allocator.refcount(p) > 0]
            cached = [p for p in shared if self.allocator.refcount(p) == 0]
            self.allocator.share(live)
            self.allocator.reclaim(cached)
        own = self._alloc_pages(
            self._admission_pages(req, tokens) - len(shared))
        pages = shared + own
        self._req_pages[req.request_id] = pages
        self._req_shared[req.request_id] = len(shared) * self.page_size
        self.page_tables[req.slot] = 0
        self.page_tables[req.slot, :len(pages)] = pages

    def _tables(self, rows) -> torch.Tensor:
        """Upload page-table rows for one step."""
        return torch.as_tensor(np.ascontiguousarray(rows),
                               device=self.device)

    def _prefill_segment(self, req: Request, pos: int, seg: np.ndarray):
        """One prefill segment of exactly its length against the request's
        pages (written in place). Returns the logits [V] of its last
        token."""
        tokens = torch.as_tensor(seg, dtype=torch.long,
                                 device=self.device)[None]
        start = torch.tensor([pos], dtype=torch.int32, device=self.device)
        logits, _ = self._forward(
            self.params, self.cfg, tokens, start, self.kv_pool,
            self._tables(self.page_tables[req.slot:req.slot + 1]),
            last_logit_only=True)
        return logits[0, -1]

    # -- decode-page growth + preemption -------------------------------------

    def _pick_victim(self, requester: Request) -> Optional[Request]:
        """Latest-admitted running request, possibly the requester itself
        (the newest request yields so older ones finish). Blend requests
        are never preempted: their healed KV cannot be stored and restored
        exactly."""
        for r in reversed(self.running):
            if r.context_chunks is None:
                return r
        return None

    def _preempt(self, victim: Request) -> None:
        """Evict a running request: persist its computed KV (prompt +
        decoded tokens) to the cache tiers, free its pages and slot, and
        push it to the FRONT of the waiting queue. On re-admission the
        prefix is restored via retrieve and the rest is recomputed, so
        greedy output is unchanged (bit for bit in fp32)."""
        n = victim.total_len - 1  # the arena holds KV for total-1 tokens
        # durable before the pages are reused
        self.cache_engine.store(victim.all_tokens[:n],
                                self._read_slot(victim.slot, n),
                                blocking=True)
        self.running.remove(victim)
        self._release(victim)
        self.free_slots.append(victim.slot)
        victim.slot = None
        victim.state = RequestState.WAITING
        victim.num_preemptions += 1
        self.waiting.insert(0, victim)
        logger.info("Preempted request %s at %d tokens (arena full)",
                    victim.request_id, n)

    def _ensure_decode_pages(self) -> None:
        """Before a decode step, grow every running request's page list to
        cover the token the step will write; when the arena cannot satisfy
        a growth, preempt victims until it can."""
        db = self._write_horizon
        for r in list(self.running):
            if r not in self.running:  # preempted by an earlier growth
                continue
            cap = r.num_prompt_tokens + r.sampling.max_new_tokens
            target = min(
                r.num_prompt_tokens + len(r.output_tokens) - 1 + db, cap)
            pages = self._req_pages[r.request_id]
            need = pages_needed(target, self.page_size) - len(pages)
            if need <= 0:
                continue
            preempted_self = False
            while need > self.allocator.num_free:
                victim = self._pick_victim(r)
                if victim is None or self.cache_engine is None:
                    raise MemoryError(
                        f"arena exhausted: request {r.request_id} needs "
                        f"{need} more pages, {self.allocator.num_free} "
                        f"free, and no preemptable victim"
                        + ("" if self.cache_engine is not None
                           else " (no cache engine to evict into)"))
                self._preempt(victim)
                if victim is r:
                    preempted_self = True
                    break  # the requester yielded; skip its growth
            if preempted_self:
                continue
            start_idx = len(pages)
            new = self._alloc_pages(need)
            self.page_tables[r.slot, start_idx:start_idx + need] = new
            pages.extend(new)

    # -- internals ----------------------------------------------------------

    def _stream_inject(self, req: Request, tokens: np.ndarray) -> int:
        """Streamed cache retrieval onto whole pages, in groups as the dense
        engine's (:meth:`ServingEngine._grouped_stream`). page_size divides
        chunk_size, so every streamed chunk starts page-aligned and only
        the final, clipped chunk can end off a page: its partial page is
        dropped (prefill recomputes it), and it ends its group. Tokens on
        shared resident pages are skipped in the tier stream. Returns the
        number of cached tokens injected."""
        shared_tok = self._req_shared.get(req.request_id, 0)
        if self.cache_engine is None:
            return shared_tok
        pages = self._req_pages[req.request_id]
        mask = None
        if shared_tok:
            # the shared-prefix pages already hold live KV
            mask = np.ones(len(tokens), bool)
            mask[:shared_tok] = False

        def scatter(blob, pos):
            first = pos // self.page_size
            n_pages = blob.shape[2] // self.page_size
            self._inject_pages(blob, pages[first:first + n_pages])

        cached = self._grouped_stream(
            self.cache_engine.retrieve_stream(tokens, mask=mask),
            len(tokens) - 1, self.page_size, scatter)
        return shared_tok if cached is None else cached

    def _inject_blend(self, req: Request, blob: torch.Tensor) -> None:
        """Scatter a blended prompt's wire blob onto the request's first
        pages, zero-padded to whole pages: the pad lies past ``kv_len``,
        where attention masks it, and decode overwrites it token by
        token."""
        pages = self._req_pages[req.request_id]
        T = blob.shape[2]
        n_pages = pages_needed(T, self.page_size)
        pad = n_pages * self.page_size - T
        if pad:
            blob = torch.nn.functional.pad(blob, (0, 0, 0, 0, 0, pad))
        self._inject_pages(blob, pages[:n_pages])

    def _decode_all(self) -> None:
        """One batched decode step over every slot through the page
        tables; idle rows park at position S, whose page-table row is all
        null pages."""
        self._ensure_decode_pages()
        if not self.running:  # every running request was preempted
            return
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
        logits, _ = self._forward(
            self.params, self.cfg,
            torch.as_tensor(last, device=self.device),
            torch.as_tensor(start, device=self.device), self.kv_pool,
            self._tables(self.page_tables))
        toks = _sample_tokens(logits[:, 0], temps, self._slot_gens, topks,
                              topps,
                              mode=_sampling_mode(self.running)).tolist()
        for r in list(self.running):
            r.output_tokens.append(int(toks[r.slot]))
            self._maybe_finish(r)

    def _store_back(self, req: Request) -> None:
        super()._store_back(req)  # skips blend requests
        self._release(req)

    def _on_prefill_complete(self, req: Request) -> None:
        """Register the request's fully-written prompt pages in the
        resident-prefix index so later same-prefix requests share them
        (page i is immutable once positions [i*page, (i+1)*page) are
        prefilled: decode writes only past the prompt)."""
        if req.context_chunks is not None:
            return  # blend KV is approximate: never share it as exact
        tokens = req.all_tokens
        pages = self._req_pages[req.request_id]
        hashes = self._page_hashes(req, tokens)
        for i in range(len(tokens) // self.page_size):
            p = pages[i]
            if p in self._page_hash:
                continue  # already registered (a shared page)
            self._page_hash[p] = hashes[i]
            self._resident.setdefault(hashes[i], p)

    def _release(self, req: Request) -> None:
        pages = self._req_pages.pop(req.request_id, None)
        self._req_shared.pop(req.request_id, None)
        if pages:
            # arena-as-cache: freed pages KEEP their prefix-index
            # registrations until _alloc_pages hands them out again
            self.allocator.free(pages)
            self.page_tables[req.slot] = 0
