"""Shared types: cache keys, device selection, tracing annotations.

``CacheEngineKey`` is identical to ``lmcache_tpu.utils.CacheEngineKey``,
``to_string`` included, so both packages name a chunk the same way. Hot
functions are annotated with ``torch.profiler.record_function`` ranges.
"""

import functools
from dataclasses import dataclass
from typing import Any, Callable, Union

import torch

from lmcache_tpu_torch.logging_utils import init_logger

logger = init_logger(__name__)


@dataclass(frozen=True)
class CacheEngineKey:
    """Globally-unique address of one KV chunk.

    The fields bake the deployment identity into the key so that only
    compatible deployments share chunks (reference: lmcache/utils.py:12-39).
    ``world_size``/``worker_id`` address the head-shard.
    """

    fmt: str
    model_name: str
    world_size: int
    worker_id: int
    chunk_hash: str

    def __hash__(self):
        return hash((self.fmt, self.model_name, self.world_size,
                     self.worker_id, self.chunk_hash))

    def to_string(self) -> str:
        return (f"{self.fmt}@{self.model_name}@{self.world_size}"
                f"@{self.worker_id}@{self.chunk_hash}")

    @staticmethod
    def from_string(s: str) -> "CacheEngineKey":
        parts = s.split("@")
        if len(parts) != 5:
            raise ValueError(f"Invalid key string: {s!r}")
        return CacheEngineKey(parts[0], parts[1], int(parts[2]),
                              int(parts[3]), parts[4])


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (the default) raises
    when no GPU is present: code runs on the CPU only when the caller asks
    for it with ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _lmcache_trace_annotate(func: Callable) -> Callable:
    """Annotate a hot function with a named profiler range
    (``torch.profiler.record_function``), visible in torch.profiler traces.
    """
    name = f"lmcache_tpu_torch::{func.__qualname__}"

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(name):
            return func(*args, **kwargs)

    return wrapper


def nbytes_of(obj: Any) -> int:
    """Byte size of a numpy array or torch tensor (0 for anything else)."""
    nbytes = getattr(obj, "nbytes", None)
    if nbytes is not None:
        return int(nbytes)
    return 0
