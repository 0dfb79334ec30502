"""Request lifecycle types for the serving engine (a copy of
``lmcache_tpu/serving/request.py``)."""

import itertools
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, List, Optional

import numpy as np

_req_counter = itertools.count()


class RequestState(Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"


@dataclass
class SamplingParams:
    max_new_tokens: int = 64
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0  # 0 => no top-k restriction
    top_p: float = 1.0  # 1.0 => no nucleus restriction
    stop_token_ids: tuple = ()
    seed: int = 0  # != 0 => reproducible per-request sample stream
    # number of top-logprob alternatives to record per generated token
    # (0 => off). Engines take the single-step decode path for batches
    # containing logprobs requests (block/speculative decode sample on
    # device and never materialize per-step logits on the host).
    logprobs: int = 0


@dataclass(eq=False)  # identity semantics: requests live in scheduler lists
class Request:
    prompt_tokens: np.ndarray
    sampling: SamplingParams = field(default_factory=SamplingParams)
    request_id: int = field(default_factory=lambda: next(_req_counter))
    state: RequestState = RequestState.WAITING
    output_tokens: List[int] = field(default_factory=list)
    slot: Optional[int] = None  # KV-pool slot while RUNNING
    cached_prefix_len: int = 0  # tokens reused from the cache engine
    prefill_pos: Optional[int] = None  # next token to prefill (in-flight)
    num_preemptions: int = 0  # times evicted to the cache tiers
    spec_proposed: int = 0  # speculative tokens proposed (prompt-lookup)
    spec_accepted: int = 0  # speculative tokens accepted by verification
    # CacheBlend: the prompt as independently-cached text chunks (RAG
    # docs + question). The port's engine refuses such requests until the
    # CacheBlend slice; prompt_tokens may be empty and is derived from the
    # chunks.
    context_chunks: Optional[List[np.ndarray]] = None
    blended_tokens_recomputed: Optional[int] = None
    arrival_s: float = field(default_factory=time.perf_counter)
    ttft_s: Optional[float] = None  # set when the first token lands
    finish_s: Optional[float] = None
    # why generation ended: "stop" when a stop condition (EOS /
    # stop_token_ids / stop string) fired, "length" when truncated by
    # max_new_tokens. Set the moment is_finished first fires, so a stop
    # hit exactly at the max_new_tokens boundary reports "stop"
    # (OpenAI semantics; ADVICE r2 #3).
    finish_reason: Optional[str] = None
    # optional text-level stop detector installed by the API layer
    # (the engine is tokenizer-agnostic; detokenization lives there).
    # Called with the output token list after each appended token;
    # returns the CHARACTER offset of the completed text at which a
    # stop string begins, or None. The API truncates returned text at
    # ``stop_text_offset``.
    stop_checker: Optional[Callable[[List[int]], Optional[int]]] = None
    stop_text_offset: Optional[int] = None
    # per-token logprob records (when sampling.logprobs > 0): dicts of
    # {"token": id, "logprob": float, "top": [(id, lp), ...]}
    logprobs: Optional[List[dict]] = None
    per_step_logits: bool = False  # engine hint set at admission

    def __post_init__(self):
        if self.context_chunks is not None:
            self.context_chunks = [
                np.asarray(c, dtype=np.int32).reshape(-1)
                for c in self.context_chunks
            ]
            if len(np.asarray(self.prompt_tokens).reshape(-1)) == 0:
                self.prompt_tokens = np.concatenate(self.context_chunks)
        self.prompt_tokens = np.asarray(self.prompt_tokens,
                                        dtype=np.int32).reshape(-1)

    @property
    def num_prompt_tokens(self) -> int:
        return len(self.prompt_tokens)

    @property
    def total_len(self) -> int:
        return self.num_prompt_tokens + len(self.output_tokens)

    @property
    def all_tokens(self) -> np.ndarray:
        return np.concatenate(
            [self.prompt_tokens,
             np.asarray(self.output_tokens, np.int32)])

    def is_finished(self, eos_token_id: Optional[int] = None) -> bool:
        # stop conditions are checked BEFORE the length cap so a stop
        # hit exactly at max_new_tokens reports finish_reason "stop"
        if self.output_tokens:
            last = self.output_tokens[-1]
            if (last in self.sampling.stop_token_ids
                    or (eos_token_id is not None and last == eos_token_id)):
                self.finish_reason = self.finish_reason or "stop"
                return True
            if self.stop_checker is not None:
                off = self.stop_checker(self.output_tokens)
                if off is not None:
                    self.stop_text_offset = off
                    self.finish_reason = self.finish_reason or "stop"
                    return True
        if len(self.output_tokens) >= self.sampling.max_new_tokens:
            self.finish_reason = self.finish_reason or "length"
            return True
        return False
