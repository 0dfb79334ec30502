"""Configuration for the port's cache engine.

A copy of ``lmcache_tpu/config.py``: an immutable engine config (how to
cache) separate from the engine metadata (identity of the deployment, baked
into every cache key).

``local_device`` is ``"cuda"`` (KV chunks held in GPU memory as torch
tensors), ``"cpu"`` (host DRAM), a directory (the disk tier: one raw
container a chunk) or None. ``remote_url`` names a cache server
(``lm://host:port``; :mod:`lmcache_tpu_torch.server`) or a redis store
(``redis://``, ``redis-sentinel://``), written through the serde
``remote_serde`` (``"raw"``, ``"raw_zstd"``, ``"safetensors"`` or
``"cachegen"``). With both, the tier is the hybrid one: the local tier in
front of the remote one, warmed at start by a bounded prefetch
(``hybrid_prefetch_*``).

CacheGen's range coding runs where ``cachegen_device_encode`` (store) and
``cachegen_device_decode`` (retrieve) say: ``"auto"`` runs the Hopper
kernels for data on the card and their plain versions for CPU tensors,
``"off"`` runs the host C++ coder. ``"on"`` is an alias of ``"auto"``, kept
so that the JAX package's config files load unchanged.

``remote_device`` selects the platform of the remote tier as
``local_device`` does for the local one: CacheGen chunks fetched by
``LMCacheEngine.retrieve`` are decoded there (``"cpu"`` runs the codec on
the host, as the CPU tests do). The serving engines pass their own device
and do not read it.
"""

import re
from dataclasses import dataclass
from typing import Optional

CODER_MODES = ("auto", "on", "off")
_URL_RE = re.compile(r"(.*)://(.*):(\d+)")
_FILE_RE = re.compile(r"file://(.*)")


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
    # the mesh axis that the KV heads are sharded over
    # (lmcache_tpu_torch.parallel): a worker stores its head slice under
    # ``worker_id`` = its index on that axis, ``world_size`` = the axis size
    kv_shard_axis: str = "model"

    def __post_init__(self):
        if self.fmt not in ("vllm", "huggingface"):
            raise ValueError(f"Invalid KV format: {self.fmt}")


@dataclass(frozen=True)
class LMCacheEngineConfig:
    chunk_size: int = 256
    local_device: Optional[str] = "cuda"  # "cuda" | "cpu" | disk path | None
    remote_url: Optional[str] = None  # "<proto>://host:port"
    # "raw" | "raw_zstd" | "safetensors" | "cachegen"
    remote_serde: Optional[str] = "raw"
    pipelined_backend: bool = False
    save_decode_cache: bool = False
    # Max bytes held by the in-memory local tier before LRU eviction
    # (None = unbounded, matching reference behavior).
    local_capacity_bytes: Optional[int] = None
    cachegen_device_decode: str = "auto"  # "auto" | "off" ("on" = "auto")
    cachegen_device_encode: str = "auto"  # "auto" | "off" ("on" = "auto")
    remote_device: str = "cuda"  # "cuda" | "cpu"
    # CacheBlend: fraction of tokens to recompute when blending non-prefix
    # chunks (see lmcache_tpu_torch/blend.py)
    blend_recompute_ratio: float = 0.15
    # the hybrid tier's startup prefetch (as the JAX package's): at most
    # this many chunks, newest first (None = unbounded, 0 = none), and at
    # most ``hybrid_prefetch_bytes`` bytes (and ``local_capacity_bytes``);
    # the rest fills on first use. ``hybrid_prefetch_async`` runs it on a
    # thread (``backend.wait_prefetch()`` joins it)
    hybrid_prefetch_chunks: Optional[int] = 1024
    hybrid_prefetch_bytes: Optional[int] = None
    hybrid_prefetch_async: bool = False

    def __post_init__(self):
        if self.local_device is None and self.remote_url is None:
            raise ValueError("need one of local_device and remote_url")
        for name in ("cachegen_device_decode", "cachegen_device_encode"):
            if getattr(self, name) not in CODER_MODES:
                raise ValueError(f"{name} must be one of {CODER_MODES}: "
                                 f"{getattr(self, name)!r}")
        if self.remote_device not in ("cuda", "cpu"):
            raise ValueError(f"Invalid remote_device: {self.remote_device}")

    @staticmethod
    def from_defaults(**kwargs) -> "LMCacheEngineConfig":
        return LMCacheEngineConfig(**kwargs)

    @staticmethod
    def from_legacy(
        chunk_size: int = 256,
        backend: str = "cuda",
        remote_serde: Optional[str] = "raw",
        pipelined_backend: bool = False,
        save_decode_cache: bool = False,
    ) -> "LMCacheEngineConfig":
        """Single-string backend spec: device name, file:// path, or URL."""
        local_device: Optional[str] = None
        remote_url: Optional[str] = None
        if backend in ("cpu", "cuda"):
            local_device = backend
        elif _FILE_RE.match(backend):
            local_device = backend[len("file://"):]
        elif _URL_RE.match(backend):
            remote_url = backend
        else:
            raise ValueError(f"Invalid backend spec: {backend}")
        return LMCacheEngineConfig(
            chunk_size=chunk_size,
            local_device=local_device,
            remote_url=remote_url,
            remote_serde=remote_serde,
            pipelined_backend=pipelined_backend,
            save_decode_cache=save_decode_cache,
        )

    @staticmethod
    def from_file(file_path: str) -> "LMCacheEngineConfig":
        """Load the config from a YAML file (the reference's schema, and the
        JAX package's files): ``"tpu"``, the JAX package's accelerator tier,
        reads as ``"cuda"``; a ``file://`` path loses its prefix; a
        ``remote_url`` must be ``proto://host:port``."""
        import yaml
        with open(file_path, "r") as fin:
            raw = yaml.safe_load(fin) or {}

        local_device = raw.get("local_device", None)
        if local_device is not None:
            if local_device in ("cpu", "cuda", "tpu"):
                if local_device == "tpu":
                    local_device = "cuda"
            elif _FILE_RE.match(local_device):
                local_device = local_device[len("file://"):]
            else:
                raise ValueError(
                    f"Invalid local storage device: {local_device}")

        remote_url = raw.get("remote_url", None)
        if remote_url is not None and not _URL_RE.match(remote_url):
            raise ValueError(f"Invalid remote storage url: {remote_url}")

        return LMCacheEngineConfig(
            chunk_size=raw.get("chunk_size", 256),
            local_device=local_device,
            remote_url=remote_url,
            remote_serde=raw.get("remote_serde", "raw"),
            pipelined_backend=raw.get("pipelined_backend", False),
            save_decode_cache=raw.get("save_decode_cache", False),
            local_capacity_bytes=raw.get("local_capacity_bytes", None),
            cachegen_device_decode=raw.get("cachegen_device_decode", "auto"),
            cachegen_device_encode=raw.get("cachegen_device_encode", "auto"),
            remote_device=raw.get("remote_device", "cuda"),
            blend_recompute_ratio=raw.get("blend_recompute_ratio", 0.15),
            hybrid_prefetch_chunks=raw.get("hybrid_prefetch_chunks", 1024),
            hybrid_prefetch_bytes=raw.get("hybrid_prefetch_bytes", None),
            hybrid_prefetch_async=raw.get("hybrid_prefetch_async", False),
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
