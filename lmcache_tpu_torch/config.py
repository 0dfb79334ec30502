"""Configuration for the port's cache engine.

A copy of ``lmcache_tpu/config.py`` for the tiers this package has: an
immutable engine config (how to cache) separate from the engine metadata
(identity of the deployment, baked into every cache key).

``local_device`` is ``"cuda"`` (KV chunks held in GPU memory as torch
tensors) or ``"cpu"`` (host DRAM). The disk tier and the remote tier are
not ported yet: a disk path or a ``remote_url`` raises
``NotImplementedError`` (ROADMAP, module item 8: disk, remote and hybrid
tiers).
"""

from dataclasses import dataclass
from typing import Optional

_NOT_PORTED = ("not ported yet (ROADMAP, module item 8: disk, remote and "
               "hybrid tiers)")


@dataclass(frozen=True)
class LMCacheEngineMetadata:
    """Identity of the serving deployment this cache belongs to.

    KV chunks are only shareable between deployments with identical metadata
    (same model, same sharding, same kv layout) — the metadata fields are
    baked into every cache key.
    """

    model_name: str
    world_size: int
    worker_id: int
    fmt: str  # "vllm" ([L,2,T,H,D]) or "huggingface" ([L,2,H,T,D])
    dtype: str = "bf16"

    def __post_init__(self):
        if self.fmt not in ("vllm", "huggingface"):
            raise ValueError(f"Invalid KV format: {self.fmt}")


@dataclass(frozen=True)
class LMCacheEngineConfig:
    chunk_size: int = 256
    local_device: str = "cuda"  # "cuda" | "cpu"
    remote_url: Optional[str] = None
    save_decode_cache: bool = False
    # Max bytes held by the in-memory local tier before LRU eviction
    # (None = unbounded, matching reference behavior).
    local_capacity_bytes: Optional[int] = None

    def __post_init__(self):
        if self.remote_url is not None:
            raise NotImplementedError(f"remote_url: {_NOT_PORTED}")
        if self.local_device not in ("cuda", "cpu"):
            raise NotImplementedError(
                f"local_device {self.local_device!r}: {_NOT_PORTED}")

    @staticmethod
    def from_defaults(**kwargs) -> "LMCacheEngineConfig":
        return LMCacheEngineConfig(**kwargs)

    @staticmethod
    def from_file(file_path: str) -> "LMCacheEngineConfig":
        """Load the config from a YAML file (the reference's schema)."""
        import yaml
        with open(file_path, "r") as fin:
            raw = yaml.safe_load(fin) or {}
        return LMCacheEngineConfig(
            chunk_size=raw.get("chunk_size", 256),
            local_device=raw.get("local_device", "cuda"),
            remote_url=raw.get("remote_url", None),
            save_decode_cache=raw.get("save_decode_cache", False),
            local_capacity_bytes=raw.get("local_capacity_bytes", None),
        )


class GlobalConfig:
    """Process-global switches (reference: lmcache/config.py:130-139)."""

    enable_debug: bool = False

    @classmethod
    def set_debug(cls, enable: bool) -> None:
        cls.enable_debug = enable

    @classmethod
    def is_debug(cls) -> bool:
        return cls.enable_debug
