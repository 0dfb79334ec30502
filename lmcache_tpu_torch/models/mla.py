"""Multi-head Latent Attention (DeepSeek-V2/V3 family) in PyTorch: the port
of ``lmcache_tpu/models/mla.py``.

MLA compresses a token's whole KV state into one latent vector ``c`` of
``kv_lora_rank`` dims plus one MQA rope key of ``qk_rope_head_dim`` dims;
per-head keys and values are linear functions of ``c``, so attention runs in
latent space ("weight absorption") and **the latent is the cache**: at
DeepSeek-V2-Lite geometry 576 values a token and layer.

- parameters are a plain dict of tensors mirroring the JAX pytree: ``embed``,
  ``final_norm``, ``lm_head`` and the stacked blocks ``dense_layers`` (layers
  ``[0, first_k_dense_replace)``) and ``moe_layers`` (the rest), applied as
  ``x @ W``; :func:`params_from_jax` carries a JAX tree across unchanged
  (``router_bias`` in fp32);
- the latent pool is one tensor ``[L, B, S, r + p]`` (int8: ``{"sym" int8,
  "scale" fp32 [L, B, S]}``), the paged arena ``[L, P, page, Cp]`` with
  ``Cp = latent_pad_dim(cfg)`` (int8: scales ``[L, P, page]``). The forwards
  write the new tokens' latents **in place** (the JAX functions return new
  arrays) and attend through the kernels of
  :mod:`lmcache_tpu_torch.ops.latent_attention` and
  :mod:`lmcache_tpu_torch.ops.paged_latent_attention`, which read a layer's
  slice in place: the Hopper kernel on CUDA tensors (the query cast to the
  pool's dtype first), the plain version on CPU tensors;
- the layer loop is a Python loop over both blocks (the JAX file's two
  ``lax.scan``s). The routed experts run only on the tokens routed to them
  (scattered into padded per-expert blocks, one batched product a weight),
  the same function as the JAX file's every-expert scan, whose unselected
  experts are weighted by exactly 0;
- :func:`forward_train` is the differentiable step that training runs
  (``tools/train_quality_model.py``): no pool, the plain attention over the
  step's own latents, each layer optionally recomputed in the backward pass;
- :func:`cache_to_blob` emits the wire blob ``[L, 1, T, 1, r + p]``, so
  latent blobs flow through chunking, serde, every tier and the server
  unchanged. The paged arenas' lane pad never reaches the wire.

:meth:`MLAConfig.from_hf` and :func:`load_hf` read a local HuggingFace
checkpoint directory through :mod:`lmcache_tpu_torch.models.hf_checkpoint`,
without ``transformers``.

With ``mesh`` (``lmcache_tpu_torch.parallel``; the JAX file's
``_shard_latent_attend`` and ``_shard_paged_latent_attend``) each rank holds
the parameters of ``parallel.shard_params``: the query projection
(``wq``/``wq_b``) and the absorbed ``w_kb_k``/``w_kb_v`` of its ``H / tp``
query heads, its rows of ``wo`` and its columns of the MLPs and experts. The
latent pool or arena has no head axis and is replicated over "model" (every
rank writes the same latents); the latent kernels run on the rank's heads,
and the output projection and the MLPs are summed over "model".
"""

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from lmcache_tpu_torch.models import experts, hf_checkpoint
from lmcache_tpu_torch.models.llama import (_gather_rows, _positions,
                                            _rms_norm, _rope, _rows,
                                            _tensor_from_numpy, torch_dtype)
from lmcache_tpu_torch.ops.latent_attention import (
    dequantize_latents, latent_attention_reference, latent_flash_attention,
    quantize_latents, quantized_latent_flash_attention)
from lmcache_tpu_torch.ops.paged_latent_attention import (
    paged_latent_attention_dma, quantized_paged_latent_attention_dma)
from lmcache_tpu_torch.parallel.mesh import (Axis, axis, data_rows,
                                             latent_cache_sharding,
                                             local_shape)
from lmcache_tpu_torch.utils import resolve_device

Params = Dict[str, Any]
_ONE = Axis()  # the one-rank "model" axis of a forward without a mesh


def _yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    if scale <= 1.0:
        return 1.0
    return 0.1 * mscale * float(np.log(scale)) + 1.0


@dataclass(frozen=True)
class MLAConfig:
    vocab_size: int = 102400
    dim: int = 2048
    n_layers: int = 27
    n_heads: int = 16
    hidden_dim: int = 10944
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    max_seq_len: int = 163840
    dtype: str = "bfloat16"
    # --- MLA geometry ---------------------------------------------------
    # low-rank query path; None = direct q_proj (DeepSeek-V2-Lite)
    q_lora_rank: Optional[int] = None
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # V2 checkpoints store rope channels as adjacent pairs
    rope_interleaved: bool = True
    # "v2" (softmax gate, plain qk scale) or "v3" (sigmoid noaux_tc gate,
    # mscale_all_dim squared folded into the scale)
    arch: str = "v2"
    # --- MoE ------------------------------------------------------------
    n_routed_experts: Optional[int] = None  # None = all-dense MLPs
    n_shared_experts: Optional[int] = None
    n_experts_per_tok: int = 6
    moe_hidden_dim: Optional[int] = None  # expert width
    first_k_dense_replace: int = 0  # layers [0, k) use dense MLPs
    routed_scaling_factor: float = 1.0
    topk_method: str = "greedy"  # greedy | group_limited_greedy | noaux_tc
    n_group: Optional[int] = None
    topk_group: Optional[int] = None
    norm_topk_prob: bool = False
    # --- yarn context extension -----------------------------------------
    rope_scaling_type: Optional[str] = None  # only "yarn" is used
    rope_scaling_factor: float = 1.0
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 1.0
    rope_mscale_all_dim: float = 0.0
    rope_attention_factor: Optional[float] = None
    rope_original_max_seq: Optional[int] = None

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """Cached values per token and layer."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def sm_scale(self) -> float:
        s = float(self.qk_head_dim) ** -0.5
        if (self.arch == "v3" and self.rope_scaling_type == "yarn"
                and self.rope_mscale_all_dim):
            m = _yarn_mscale(self.rope_scaling_factor,
                             self.rope_mscale_all_dim)
            s *= m * m
        return s

    @property
    def rope_scaling_spec(self):
        """``llama.rope_inv_freq``'s spec tuple with DeepSeek's attention
        factor (the mscale ratio) resolved, as the JAX property."""
        if self.rope_scaling_type is None:
            return None
        af = self.rope_attention_factor
        if af is None and self.rope_mscale and self.rope_mscale_all_dim:
            af = (_yarn_mscale(self.rope_scaling_factor, self.rope_mscale)
                  / _yarn_mscale(self.rope_scaling_factor,
                                 self.rope_mscale_all_dim))
        return ("yarn", self.rope_scaling_factor, 1.0, 4.0,
                self.rope_original_max_seq or self.max_seq_len,
                self.rope_beta_fast, self.rope_beta_slow, af)

    def moe_layer(self, i: int) -> bool:
        return (self.n_routed_experts is not None
                and i >= self.first_k_dense_replace)

    @property
    def n_dense_layers(self) -> int:
        if self.n_routed_experts is None:
            return self.n_layers
        return min(self.first_k_dense_replace, self.n_layers)

    @staticmethod
    def tiny(**over) -> "MLAConfig":
        kw = dict(vocab_size=512, dim=256, n_layers=4, n_heads=4,
                  hidden_dim=512, max_seq_len=1024, dtype="float32",
                  kv_lora_rank=64, qk_nope_head_dim=32,
                  qk_rope_head_dim=16, v_head_dim=32)
        kw.update(over)
        return MLAConfig(**kw)

    @staticmethod
    def deepseek_v2_lite() -> "MLAConfig":
        # deepseek-ai/DeepSeek-V2-Lite: direct q_proj, 64 routed + 2
        # shared experts, first layer dense, softmax greedy gate, yarn 40x
        return MLAConfig(
            vocab_size=102400, dim=2048, n_layers=27, n_heads=16,
            hidden_dim=10944, rope_theta=10000.0, max_seq_len=163840,
            q_lora_rank=None, kv_lora_rank=512, qk_nope_head_dim=128,
            qk_rope_head_dim=64, v_head_dim=128,
            n_routed_experts=64, n_shared_experts=2, n_experts_per_tok=6,
            moe_hidden_dim=1408, first_k_dense_replace=1,
            routed_scaling_factor=1.0, topk_method="greedy",
            norm_topk_prob=False,
            rope_scaling_type="yarn", rope_scaling_factor=40.0,
            rope_beta_fast=32.0, rope_beta_slow=1.0, rope_mscale=0.707,
            rope_mscale_all_dim=0.707, rope_original_max_seq=4096)

    @staticmethod
    def deepseek_v2() -> "MLAConfig":
        # deepseek-ai/DeepSeek-V2: q_lora 1536, 160 routed experts in 8
        # groups (top-3 groups), 2 shared, group_limited_greedy
        return MLAConfig(
            vocab_size=102400, dim=5120, n_layers=60, n_heads=128,
            hidden_dim=12288, rope_theta=10000.0, max_seq_len=163840,
            q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
            qk_rope_head_dim=64, v_head_dim=128,
            n_routed_experts=160, n_shared_experts=2, n_experts_per_tok=6,
            moe_hidden_dim=1536, first_k_dense_replace=1,
            routed_scaling_factor=16.0, topk_method="group_limited_greedy",
            n_group=8, topk_group=3, norm_topk_prob=False,
            rope_scaling_type="yarn", rope_scaling_factor=40.0,
            rope_beta_fast=32.0, rope_beta_slow=1.0, rope_mscale=1.0,
            rope_mscale_all_dim=1.0, rope_original_max_seq=4096)

    @staticmethod
    def deepseek_v3() -> "MLAConfig":
        # deepseek-ai/DeepSeek-V3/R1: sigmoid noaux_tc router with
        # e_score_correction_bias, 256 routed experts in 8 groups
        return MLAConfig(
            vocab_size=129280, dim=7168, n_layers=61, n_heads=128,
            hidden_dim=18432, rope_theta=10000.0, max_seq_len=163840,
            q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
            qk_rope_head_dim=64, v_head_dim=128, arch="v3",
            n_routed_experts=256, n_shared_experts=1, n_experts_per_tok=8,
            moe_hidden_dim=2048, first_k_dense_replace=3,
            routed_scaling_factor=2.5, topk_method="noaux_tc",
            n_group=8, topk_group=4, norm_topk_prob=True,
            rope_scaling_type="yarn", rope_scaling_factor=40.0,
            rope_beta_fast=32.0, rope_beta_slow=1.0, rope_mscale=1.0,
            rope_mscale_all_dim=1.0, rope_original_max_seq=4096)

    @staticmethod
    def from_hf(model_name: str) -> "MLAConfig":
        """Read the architecture from a local HuggingFace deepseek_v2/v3
        checkpoint directory's ``config.json`` (:mod:`hf_checkpoint`, no
        ``transformers``)."""
        hc = hf_checkpoint.read_config(model_name)
        model_type = getattr(hc, "model_type", "")
        if model_type not in ("deepseek_v2", "deepseek_v3"):
            raise ValueError(f"not an MLA architecture: {model_type!r}")
        if getattr(hc, "moe_layer_freq", 1) != 1:
            raise NotImplementedError("moe_layer_freq != 1 not supported")
        arch = "v3" if model_type == "deepseek_v3" else "v2"
        scaling = {}
        rs = getattr(hc, "rope_scaling", None)
        if rs:
            kind = rs.get("rope_type") or rs.get("type")
            if kind not in ("yarn",):
                raise NotImplementedError(
                    f"rope_scaling type {kind!r} not supported for MLA")
            scaling = dict(
                rope_scaling_type="yarn",
                rope_scaling_factor=float(rs.get("factor", 1.0)),
                rope_beta_fast=float(rs.get("beta_fast", 32.0)),
                rope_beta_slow=float(rs.get("beta_slow", 1.0)),
                rope_mscale=float(rs.get("mscale", 1.0)),
                rope_mscale_all_dim=float(rs.get("mscale_all_dim", 0.0)),
                rope_attention_factor=rs.get("attention_factor"),
                rope_original_max_seq=rs.get(
                    "original_max_position_embeddings",
                    hc.max_position_embeddings),
            )
        topk_method = getattr(hc, "topk_method",
                              "noaux_tc" if arch == "v3" else "greedy")
        return MLAConfig(
            **scaling,
            vocab_size=hc.vocab_size,
            dim=hc.hidden_size,
            n_layers=hc.num_hidden_layers,
            n_heads=hc.num_attention_heads,
            hidden_dim=hc.intermediate_size,
            norm_eps=hc.rms_norm_eps,
            rope_theta=getattr(hc, "rope_theta", 10000.0),
            max_seq_len=hc.max_position_embeddings,
            q_lora_rank=getattr(hc, "q_lora_rank", None),
            kv_lora_rank=hc.kv_lora_rank,
            qk_nope_head_dim=hc.qk_nope_head_dim,
            qk_rope_head_dim=hc.qk_rope_head_dim,
            v_head_dim=hc.v_head_dim,
            rope_interleaved=bool(getattr(hc, "rope_interleave", True)),
            arch=arch,
            n_routed_experts=getattr(hc, "n_routed_experts", None),
            n_shared_experts=getattr(hc, "n_shared_experts", None),
            n_experts_per_tok=getattr(hc, "num_experts_per_tok", 6) or 6,
            moe_hidden_dim=getattr(hc, "moe_intermediate_size", None),
            first_k_dense_replace=getattr(hc, "first_k_dense_replace", 0),
            routed_scaling_factor=float(
                getattr(hc, "routed_scaling_factor", 1.0)),
            topk_method=topk_method,
            n_group=getattr(hc, "n_group", None),
            topk_group=getattr(hc, "topk_group", None),
            norm_topk_prob=bool(getattr(hc, "norm_topk_prob", False)),
        )


def check_supported(cfg) -> None:
    """Raise for a config the MLA forwards do not run."""
    if not isinstance(cfg, MLAConfig):
        raise TypeError(f"an MLAConfig is needed, not {type(cfg).__name__}")
    if cfg.topk_method not in ("greedy", "group_limited_greedy", "noaux_tc"):
        raise ValueError(f"unknown topk_method {cfg.topk_method!r}")


# ---------------------------------------------------------------------------
# Latent pools
# ---------------------------------------------------------------------------


def latent_cache_shape(cfg: MLAConfig, batch: int, max_len: int,
                       mesh=None) -> Tuple[int, ...]:
    """The shape of this rank's block of the latent pool [L, B, S, r + p]
    on ``mesh`` (``parallel.latent_cache_sharding``): its share of the
    batch rows on "data" (every row where they do not divide it), every
    latent."""
    return local_shape((cfg.n_layers, batch, max_len, cfg.latent_dim),
                       latent_cache_sharding(), mesh)


def new_latent_cache(cfg: MLAConfig, batch: int, max_len: int,
                     device="cuda", mesh=None) -> torch.Tensor:
    """Latent pool ``[L, B, S, r + p]``, zeroed: per (layer, token) one
    normalized latent (first r dims) and one roped MQA key (last p dims).
    There is no head axis: that is the compression. On ``mesh``, this rank's
    block (:func:`latent_cache_shape`)."""
    return torch.zeros(latent_cache_shape(cfg, batch, max_len, mesh),
                       dtype=torch_dtype(cfg), device=resolve_device(device))


def new_quantized_latent_cache(cfg: MLAConfig, batch: int, max_len: int,
                               device="cuda",
                               mesh=None) -> Dict[str, torch.Tensor]:
    """Int8 latent pool: ``{"sym" [L, B, S, r + p] int8, zeroed, "scale"
    [L, B, S] fp32, initialised to 1}`` (one scale per token over the latent
    dim), read by the int8 latent kernel. ``mesh`` as in
    :func:`new_latent_cache`."""
    dev = resolve_device(device)
    shape = latent_cache_shape(cfg, batch, max_len, mesh)
    return {
        "sym": torch.zeros(shape, dtype=torch.int8, device=dev),
        "scale": torch.ones(shape[:3], dtype=torch.float32, device=dev),
    }


def latent_pad_dim(cfg: MLAConfig) -> int:
    """Latent dim of the PAGED arenas, padded to a multiple of 128 as in the
    JAX package (its DMA kernels copy 128-lane-aligned rows), so arenas carry
    across one for one. The pad columns are zero; the port's kernels read
    only the first ``cfg.latent_dim`` columns, and wire blobs and the dense
    pool stay at the logical width."""
    return -(-cfg.latent_dim // 128) * 128


def pad_latents(cfg: MLAConfig, x: torch.Tensor) -> torch.Tensor:
    """Zero-pad the trailing latent dim to :func:`latent_pad_dim`."""
    pad = latent_pad_dim(cfg) - x.shape[-1]
    return x if pad == 0 else F.pad(x, (0, pad))


def new_paged_latent_pool(cfg: MLAConfig, num_pages: int, page_size: int,
                          device="cuda") -> torch.Tensor:
    """Paged latent arena ``[L, P, page, pad128(r + p)]``, zeroed. Page 0 is
    the null page that padding page-table entries (and parked writes) point
    at."""
    return torch.zeros(
        (cfg.n_layers, num_pages, page_size, latent_pad_dim(cfg)),
        dtype=torch_dtype(cfg), device=resolve_device(device))


def new_quantized_paged_latent_pool(cfg: MLAConfig, num_pages: int,
                                    page_size: int,
                                    device="cuda") -> Dict[str, torch.Tensor]:
    """Int8 paged latent arena: ``{"sym" [L, P, page, pad128(r + p)] int8,
    "scale" [L, P, page] fp32, initialised to 1}``."""
    dev = resolve_device(device)
    return {
        "sym": torch.zeros(
            (cfg.n_layers, num_pages, page_size, latent_pad_dim(cfg)),
            dtype=torch.int8, device=dev),
        "scale": torch.ones((cfg.n_layers, num_pages, page_size),
                            dtype=torch.float32, device=dev),
    }


def cache_to_blob(cache: torch.Tensor, b: int = 0,
                  n: Optional[int] = None) -> torch.Tensor:
    """One batch row as a wire blob ``[L, 1, n, 1, r + p]`` (the vllm fmt's
    token axis 2). A VIEW of the pool: the storage tier copies what it
    keeps."""
    g = cache[:, b] if n is None else cache[:, b, :n]
    return g[:, None, :, None, :]


def blob_into_cache(cache: torch.Tensor, blob: torch.Tensor, b: int = 0,
                    pos: int = 0) -> torch.Tensor:
    """Write a latent wire blob into the pool at token ``pos`` of batch row
    ``b``, in place; returns ``cache``."""
    t = blob.shape[2]
    cache[:, b, pos:pos + t] = blob[:, 0, :, 0, :].to(cache.dtype)
    return cache


def quantized_cache_to_blob(cache: Dict[str, torch.Tensor], b: int = 0,
                            n: Optional[int] = None,
                            dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """One batch row of the int8 pool, dequantized to ``dtype``, as a wire
    blob ``[L, 1, n, 1, r + p]``: a new tensor, not a view."""
    sym, scale = cache["sym"][:, b], cache["scale"][:, b]
    if n is not None:
        sym, scale = sym[:, :n], scale[:, :n]
    return dequantize_latents(sym, scale, dtype)[:, None, :, None, :]


def blob_into_quantized_cache(cache: Dict[str, torch.Tensor],
                              blob: torch.Tensor, b: int = 0,
                              pos: int = 0) -> Dict[str, torch.Tensor]:
    """Quantize a latent wire blob per (layer, token), as the model
    quantizes what it writes, into the int8 pool at token ``pos`` of batch
    row ``b``, in place; returns ``cache``."""
    t = blob.shape[2]
    sym, scale = quantize_latents(blob[:, 0, :, 0, :].to(cache["sym"].device))
    cache["sym"][:, b, pos:pos + t] = sym
    cache["scale"][:, b, pos:pos + t] = scale
    return cache


def latent_pool_from_jax(pool_or_dict, device="cuda"):
    """Carry a JAX latent pool (``new_latent_cache`` ``[L, B, S, C]`` in its
    dtype, or the int8 ``{"sym", "scale"}`` dict), given as numpy arrays,
    onto ``device`` unchanged, so both packages can run one step on the same
    state."""
    dev = resolve_device(device)
    if isinstance(pool_or_dict, dict):
        return {"sym": _tensor_from_numpy(pool_or_dict["sym"], torch.int8,
                                          dev),
                "scale": _tensor_from_numpy(pool_or_dict["scale"],
                                            torch.float32, dev)}
    a = np.asarray(pool_or_dict)
    dt = (torch.bfloat16 if a.dtype.name == "bfloat16"
          else getattr(torch, a.dtype.name))
    return _tensor_from_numpy(a, dt, dev)


def paged_latent_pool_from_jax(pool_or_dict, device="cuda"):
    """Carry a JAX paged latent arena (``[L, P, page, Cp]``, or the int8
    dict with scales ``[L, P, page]``), given as numpy arrays, onto
    ``device`` unchanged: the port's arena has the same layout."""
    return latent_pool_from_jax(pool_or_dict, device)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _attn_param_shapes(cfg: MLAConfig):
    H = cfg.n_heads
    shapes = {
        "attn_norm": (cfg.dim,),
        "mlp_norm": (cfg.dim,),
        "wkv_a": (cfg.dim, cfg.latent_dim),
        "kv_a_norm": (cfg.kv_lora_rank,),
        # absorbed kv_b factors: the key half as [H, nope, r] (q_nope ->
        # latent), the value half as [H, r, v]
        "w_kb_k": (H, cfg.qk_nope_head_dim, cfg.kv_lora_rank),
        "w_kb_v": (H, cfg.kv_lora_rank, cfg.v_head_dim),
        "wo": (H * cfg.v_head_dim, cfg.dim),
    }
    if cfg.q_lora_rank is None:
        shapes["wq"] = (cfg.dim, H * cfg.qk_head_dim)
    else:
        shapes["wq_a"] = (cfg.dim, cfg.q_lora_rank)
        shapes["q_a_norm"] = (cfg.q_lora_rank,)
        shapes["wq_b"] = (cfg.q_lora_rank, H * cfg.qk_head_dim)
    return shapes


def init_params(cfg: MLAConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Params:
    """Random weights in the JAX tree's layout: normal / sqrt(fan_in), norms
    at 1, ``router_bias`` (noaux_tc) at 0 in fp32. Draws come from
    ``generator`` (on ``device``), default a fresh one seeded 0; each layer's
    slice is drawn in fp32 and cast at once, so the fp32 draws never hold a
    whole stack."""
    check_supported(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    dt = torch_dtype(cfg)
    kd, km = cfg.n_dense_layers, cfg.n_layers - cfg.n_dense_layers
    mh = cfg.moe_hidden_dim or cfg.hidden_dim

    def w(shape, fan_in):
        out = torch.empty(shape, dtype=dt, device=dev)
        for i in range(shape[0]):
            x = torch.randn(shape[1:], generator=generator, device=dev)
            out[i] = (x * fan_in**-0.5).to(dt)
        return out

    def attn_block(n):
        out = {}
        for name, shape in _attn_param_shapes(cfg).items():
            if name.endswith("norm"):
                out[name] = torch.ones((n,) + shape, dtype=dt, device=dev)
            else:
                out[name] = w((n,) + shape, shape[-2])
        return out

    params: Params = {
        "embed": w((cfg.vocab_size, cfg.dim), cfg.dim),
        "final_norm": torch.ones((cfg.dim,), dtype=dt, device=dev),
        "lm_head": w((cfg.dim, cfg.vocab_size), cfg.dim),
    }
    if kd:
        dense = attn_block(kd)
        dense["w_gate"] = w((kd, cfg.dim, cfg.hidden_dim), cfg.dim)
        dense["w_up"] = w((kd, cfg.dim, cfg.hidden_dim), cfg.dim)
        dense["w_down"] = w((kd, cfg.hidden_dim, cfg.dim), cfg.hidden_dim)
        params["dense_layers"] = dense
    if km:
        E, ns = cfg.n_routed_experts, cfg.n_shared_experts or 0
        moe = attn_block(km)
        moe["router"] = w((km, cfg.dim, E), cfg.dim)
        if cfg.topk_method == "noaux_tc":
            moe["router_bias"] = torch.zeros((km, E), dtype=torch.float32,
                                             device=dev)
        moe["e_gate"] = w((km, E, cfg.dim, mh), cfg.dim)
        moe["e_up"] = w((km, E, cfg.dim, mh), cfg.dim)
        moe["e_down"] = w((km, E, mh, cfg.dim), mh)
        if ns:
            moe["s_gate"] = w((km, cfg.dim, mh * ns), cfg.dim)
            moe["s_up"] = w((km, cfg.dim, mh * ns), cfg.dim)
            moe["s_down"] = w((km, mh * ns, cfg.dim), mh * ns)
        params["moe_layers"] = moe
    return params


def params_from_jax(tree_of_numpy: Params, cfg: MLAConfig,
                    device="cuda") -> Params:
    """Carry a JAX MLA param tree (``embed``, ``final_norm``, ``lm_head``,
    stacked ``dense_layers`` and ``moe_layers``), given as numpy arrays, onto
    the port's parameters unchanged: in ``cfg.dtype`` on ``device``,
    ``router_bias`` in fp32."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = torch_dtype(cfg)

    def conv(name, x):
        if isinstance(x, dict):
            return {k: conv(k, v) for k, v in x.items()}
        return _tensor_from_numpy(
            x, torch.float32 if name == "router_bias" else dt, dev)

    return conv("", tree_of_numpy)


def load_hf(model_name: str, cfg: Optional[MLAConfig] = None,
            device="cuda") -> Tuple[MLAConfig, Params]:
    """Convert a local HuggingFace DeepSeek-V2/V3 checkpoint directory into
    the two-block stacked parameters of ``cfg`` (default
    ``MLAConfig.from_hf``) on ``device``, without ``transformers``: each
    tensor to fp32, then to ``cfg.dtype`` (``router_bias`` stays fp32),
    stacked per layer on the device one tensor at a time. Returns
    ``(cfg, params)``."""
    if cfg is None:
        cfg = MLAConfig.from_hf(model_name)
    check_supported(cfg)
    ld = hf_checkpoint.Loader(model_name, resolve_device(device),
                              torch_dtype(cfg))
    H, n, r = cfg.n_heads, cfg.qk_nope_head_dim, cfg.kv_lora_rank
    v = cfg.v_head_dim
    t, vec = ld.t, ld.fp32

    def attn_block(idxs):
        p = "model.layers.{}."
        out = {
            "attn_norm": ld.stack(
                lambda i: vec(p.format(i) + "input_layernorm.weight"), idxs),
            "mlp_norm": ld.stack(
                lambda i: vec(p.format(i)
                              + "post_attention_layernorm.weight"), idxs),
            "wkv_a": ld.stack(
                lambda i: t(p.format(i)
                            + "self_attn.kv_a_proj_with_mqa.weight"), idxs),
            "kv_a_norm": ld.stack(
                lambda i: vec(p.format(i)
                              + "self_attn.kv_a_layernorm.weight"), idxs),
            "wo": ld.stack(
                lambda i: t(p.format(i) + "self_attn.o_proj.weight"), idxs),
        }

        def kb(i):  # kv_b_proj [H*(n+v), r] -> [H, n + v, r]
            return vec(p.format(i) + "self_attn.kv_b_proj.weight").reshape(
                H, n + v, r)

        out["w_kb_k"], out["w_kb_v"] = ld.split(
            kb, idxs, [lambda x: x[:, :n, :],
                       lambda x: x[:, n:, :].transpose(1, 2)])
        if cfg.q_lora_rank is None:
            out["wq"] = ld.stack(
                lambda i: t(p.format(i) + "self_attn.q_proj.weight"), idxs)
        else:
            out["wq_a"] = ld.stack(
                lambda i: t(p.format(i) + "self_attn.q_a_proj.weight"), idxs)
            out["q_a_norm"] = ld.stack(
                lambda i: vec(p.format(i)
                              + "self_attn.q_a_layernorm.weight"), idxs)
            out["wq_b"] = ld.stack(
                lambda i: t(p.format(i) + "self_attn.q_b_proj.weight"), idxs)
        return out

    kd = cfg.n_dense_layers
    dense_idx = list(range(kd))
    moe_idx = list(range(kd, cfg.n_layers))
    params: Params = {
        "embed": ld.one(vec("model.embed_tokens.weight")),
        "final_norm": ld.one(vec("model.norm.weight")),
        "lm_head": ld.lm_head(),
    }
    if dense_idx:
        dense = attn_block(dense_idx)
        for key, hf in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                        ("w_down", "down_proj")):
            dense[key] = ld.stack(
                lambda i, hf=hf: t(f"model.layers.{i}.mlp.{hf}.weight"),
                dense_idx)
        params["dense_layers"] = dense
    if moe_idx:
        moe = attn_block(moe_idx)
        moe["router"] = ld.stack(
            lambda i: t(f"model.layers.{i}.mlp.gate.weight"), moe_idx)
        bias_name = "model.layers.{}.mlp.gate.e_score_correction_bias"
        if bias_name.format(moe_idx[0]) in ld:
            moe["router_bias"] = ld.stack(
                lambda i: vec(bias_name.format(i)), moe_idx,
                dtype=torch.float32)
        for key, hf in (("e_gate", "gate_proj"), ("e_up", "up_proj"),
                        ("e_down", "down_proj")):
            moe[key] = ld.stack2(
                lambda i, e, hf=hf: t(
                    f"model.layers.{i}.mlp.experts.{e}.{hf}.weight"),
                moe_idx, cfg.n_routed_experts)
        if cfg.n_shared_experts:
            for key, hf in (("s_gate", "gate_proj"), ("s_up", "up_proj"),
                            ("s_down", "down_proj")):
                moe[key] = ld.stack(
                    lambda i, hf=hf: t(
                        f"model.layers.{i}.mlp.shared_experts.{hf}.weight"),
                    moe_idx)
        params["moe_layers"] = moe
    ld.close()
    return cfg, params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _mla_project(x, lp, cfg: MLAConfig, positions):
    """Shared MLA projections of one layer: (q_full [B, T, H, r + p] fp32,
    the absorbed query, of the heads whose projections ``lp`` holds; new_tok
    [B, T, r + p], the tokens' latent rows)."""
    B, T = x.shape[:2]
    H, n, r = lp["w_kb_k"].shape[0], cfg.qk_nope_head_dim, cfg.kv_lora_rank
    h = _rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    if cfg.q_lora_rank is None:
        q = h @ lp["wq"]
    else:
        q = _rms_norm(h @ lp["wq_a"], lp["q_a_norm"], cfg.norm_eps)
        q = q @ lp["wq_b"]
    q = q.reshape(B, T, H, cfg.qk_head_dim)
    q_nope, q_pe = q[..., :n], q[..., n:]

    ckv = h @ lp["wkv_a"]  # [B, T, r + p]
    c = _rms_norm(ckv[..., :r], lp["kv_a_norm"], cfg.norm_eps)
    spec = cfg.rope_scaling_spec
    q_pe = _rope(q_pe, positions, cfg.rope_theta,
                 interleaved=cfg.rope_interleaved, scaling=spec)
    k_pe = _rope(ckv[..., None, r:], positions, cfg.rope_theta,
                 interleaved=cfg.rope_interleaved, scaling=spec)[:, :, 0]
    new_tok = torch.cat([c, k_pe], dim=-1)

    # absorb the per-head key factor into the query: q.(W_k c) = (W_k^T q).c
    q_lat = torch.einsum("bthn,hnr->bthr", q_nope.float(),
                         lp["w_kb_k"].float())
    return torch.cat([q_lat, q_pe.float()], dim=-1), new_tok


def _context_out(ctx, lp, cfg: MLAConfig, x):
    """Latent-space context [B, T, H, r] -> the attention output
    [B, T, H * v] in the model dtype (``w_kb_v`` applied in fp32)."""
    B, T = x.shape[:2]
    attn = torch.einsum("bthr,hrv->bthv", ctx.float(), lp["w_kb_v"].float())
    return attn.to(x.dtype).reshape(B, T, -1)


def _mla_attention(x, lp, cfg: MLAConfig, cache_l, start_pos, positions,
                   kv_len):
    """Absorbed-latent MLA attention of one layer against ``cache_l`` ([B, S,
    C], or the int8 ``{"sym", "scale"}`` views), into which the new tokens'
    latents are written first, in place. Without a pool (``cache_l`` None: a
    training step of :func:`forward_train`, every row from position 0) the
    queries attend over the step's own latents with the plain attention,
    which autograd differentiates."""
    B = x.shape[0]
    r = cfg.kv_lora_rank
    q_full, new_tok = _mla_project(x, lp, cfg, positions)
    kw = dict(rank=r, scale=cfg.sm_scale)
    if cache_l is None:
        ctx = latent_attention_reference(q_full, new_tok, start_pos, kv_len,
                                         **kw)
        return _context_out(ctx, lp, cfg, x)
    rows = torch.arange(B, device=x.device)[:, None]
    if isinstance(cache_l, dict):
        sym, scl = cache_l["sym"], cache_l["scale"]
        n_sym, n_sc = quantize_latents(new_tok)
        sym[rows, positions] = n_sym
        scl[rows, positions] = n_sc
        ctx = quantized_latent_flash_attention(
            q_full.to(torch_dtype(cfg)), sym, scl, start_pos, kv_len, **kw)
    else:
        cache_l[rows, positions] = new_tok.to(cache_l.dtype)
        ctx = latent_flash_attention(q_full.to(cache_l.dtype), cache_l,
                                     start_pos, kv_len, **kw)
    return _context_out(ctx, lp, cfg, x)


def _gate(h, lp, cfg: MLAConfig):
    """Routing of tokens ``h [N, dim]``: (expert ids [N, k], weights [N, k]
    fp32), the selection of the JAX file's ``_gate``: V2's softmax gate,
    greedy or group-limited; V3's sigmoid ``noaux_tc`` with its selection
    bias. The weights are the ORIGINAL scores of the selected experts."""
    E, k = cfg.n_routed_experts, cfg.n_experts_per_tok
    logits = h.float() @ lp["router"].float()  # [N, E]
    if cfg.arch == "v3":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    sel = scores
    if cfg.topk_method != "greedy":
        # group-limited selection: score each group, keep the best
        # topk_group groups, zero the rest
        G = cfg.n_group
        if cfg.topk_method == "noaux_tc":
            sel = scores + lp["router_bias"].float()
        grouped = sel.reshape(sel.shape[:-1] + (G, E // G))
        if cfg.topk_method == "noaux_tc":
            gscore = torch.topk(grouped, 2, dim=-1).values.sum(dim=-1)
        else:
            gscore = grouped.amax(dim=-1)
        gidx = torch.topk(gscore, cfg.topk_group, dim=-1).indices
        gmask = torch.zeros_like(gscore).scatter_(-1, gidx, 1.0)
        sel = (grouped * gmask[..., None]).reshape(sel.shape)
    topi = torch.topk(sel, k, dim=-1).indices
    topw = torch.gather(scores, -1, topi)
    if cfg.norm_topk_prob:
        topw = topw / (topw.sum(dim=-1, keepdim=True) + 1e-20)
    return topi, topw * cfg.routed_scaling_factor


def _swiglu(h, w_gate, w_up, w_down):
    """silu(h W_g) * (h W_u) in fp32, cast to h's dtype, then W_d."""
    gate = F.silu((h @ w_gate).float())
    up = (h @ w_up).float()
    return (gate * up).to(h.dtype) @ w_down


def _routed_experts(hf, topi, topw, lp, cfg: MLAConfig):
    """Routed experts of tokens ``hf [N, dim]`` routed to ``topi [N, k]``
    with weights ``topw``: the (token, expert) pairs in padded per-expert
    blocks (:func:`experts.dispatch`), each weight one batched product over
    the E blocks, and every token sums its k weighted outputs in fp32.
    Returns [N, dim] fp32."""
    k = topi.shape[1]
    x, slot = experts.dispatch(hf, topi, cfg.n_routed_experts)
    gate = F.silu(torch.bmm(x, lp["e_gate"]).float())
    up = torch.bmm(x, lp["e_up"]).float()
    y = torch.bmm((gate * up).to(hf.dtype), lp["e_down"])
    return (topw[..., None] * experts.gather(y, slot, k).float()).sum(dim=1)


def _moe_mlp(h, lp, cfg: MLAConfig, tp: Axis = _ONE):
    """Routed experts plus the always-on shared experts. The routed experts
    run on the tokens routed to them only (:func:`_routed_experts`), their
    weighted outputs summed in fp32: the JAX scan's function, which runs
    every expert on every token and weights the unselected ones by exactly
    0. On a "model" axis ``tp`` both are column- then row-parallel, one sum
    over the axis."""
    shape = h.shape
    hf = h.reshape(-1, shape[-1])
    topi, topw = _gate(hf, lp, cfg)
    out = _routed_experts(hf, topi, topw, lp, cfg).to(h.dtype).reshape(shape)
    if cfg.n_shared_experts:
        out = out + _swiglu(h, lp["s_gate"], lp["s_up"], lp["s_down"])
    return tp.sum(out)


def _mlp_residual(x, attn, lp, cfg: MLAConfig, moe: bool,
                  tp: Axis = _ONE):
    """The rest of a layer after attention: output projection and residual,
    then the dense or MoE MLP and its residual (on a "model" axis ``tp``,
    each row-parallel product summed over it)."""
    x = x + tp.sum(attn @ lp["wo"])
    h = _rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    if moe:
        return x + _moe_mlp(h, lp, cfg, tp)
    return x + tp.sum(_swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"]))


def _layer(x, lp, cfg: MLAConfig, cache_l, start_pos, positions, kv_len,
           moe: bool, tp: Axis = _ONE):
    """One decoder layer over ``cache_l`` (None: a training step)."""
    attn = _mla_attention(x, lp, cfg, cache_l, start_pos, positions, kv_len)
    return _mlp_residual(x, attn, lp, cfg, moe, tp)


def model_axis(cfg: MLAConfig, mesh) -> Axis:
    """The mesh's "model" axis, whose size must divide the query heads: the
    latent kernels run on a rank's ``H / tp`` heads."""
    tp = axis(mesh, "model")
    if cfg.n_heads % tp.size:
        raise ValueError(
            f"n_heads ({cfg.n_heads}) must divide the mesh's model axis "
            f"({tp.size}) for the latent kernels")
    return tp


def _layers(params, cfg: MLAConfig):
    """(layer index, its parameters, whether it is an MoE layer), in order:
    the dense block, then the MoE block."""
    kd = cfg.n_dense_layers
    for name, n0, n in (("dense_layers", 0, kd),
                        ("moe_layers", kd, cfg.n_layers - kd)):
        for i in range(n):
            yield (n0 + i, {k: w[i] for k, w in params[name].items()},
                   name == "moe_layers")


def _logits(x, params, cfg: MLAConfig, last_logit_only):
    if last_logit_only:
        x = x[:, -1:]
    x = _rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["lm_head"]).float()


@torch.no_grad()
def forward(
    params: Params,
    cfg: MLAConfig,
    tokens: torch.Tensor,  # int [B, T]
    start_pos: torch.Tensor,  # int [B]
    latent_cache,  # [L, B, S, r + p] or the int8 {"sym", "scale"} pool
    *,
    last_logit_only: bool = False,
    mesh=None,
):
    """One forward step (prefill when T > 1, decode when T == 1), with the
    latent pool as the only recurrent state; the contract of
    ``llama.forward``: the new tokens' latents are written **in place** at
    ``start_pos[b]`` (the pool may be a view, such as one slot of a serving
    pool; an int8 pool quantizes them per token), and cached-prefix reuse is
    ``blob_into_cache`` + a call with the suffix. Returns (logits
    [B, T, vocab] fp32, the pool); with ``last_logit_only`` the lm_head runs
    on the final position only.

    With ``mesh``, ``params`` are this rank's (``parallel.shard_params``)
    and ``latent_cache`` its block of the pool
    (``parallel.latent_cache_sharding``: its share of the batch rows on
    "data" where ``tokens``' B divides it, else every row; every latent on
    "model"); ``tokens`` and ``start_pos`` are the whole step's, and every
    rank returns the whole step's logits, as ``llama.forward`` does."""
    check_supported(cfg)
    tp = model_axis(cfg, mesh)
    T = tokens.shape[1]
    quant = isinstance(latent_cache, dict)
    pool = latent_cache["sym"] if quant else latent_cache
    dev = pool.device
    rows = data_rows(tokens.shape[0], pool.shape[1], mesh)
    tokens, start_pos = _rows(tokens, start_pos, rows)
    start_pos, positions, kv_len = _positions(start_pos, T, dev)
    x = params["embed"][tokens.to(dev).long()]
    for li, lp, moe in _layers(params, cfg):
        cache_l = ({k: v[li] for k, v in latent_cache.items()} if quant
                   else latent_cache[li])
        x = _layer(x, lp, cfg, cache_l, start_pos, positions, kv_len, moe,
                   tp)
    return (_gather_rows(_logits(x, params, cfg, last_logit_only), rows,
                         mesh), latent_cache)


def forward_train(params: Params, cfg: MLAConfig, tokens: torch.Tensor, *,
                  remat: bool = True) -> torch.Tensor:
    """The differentiable forward that training runs, the JAX file's
    ``forward(..., use_pallas=False, remat=remat)`` over a fresh latent
    pool: every row starts at position 0, so each layer attends over the
    step's own latents and no pool is written. With ``remat`` each layer is
    recomputed in the backward pass (``torch.utils.checkpoint``), so that
    one layer's ``[B, H, T, T]`` fp32 scores are live at a time. ``tokens``
    int [B, T] on the parameters' device; returns logits [B, T, vocab]
    fp32."""
    check_supported(cfg)
    B, T = tokens.shape
    dev = params["embed"].device
    start_pos, positions, kv_len = _positions(
        torch.zeros(B, dtype=torch.int32, device=dev), T, dev)
    x = params["embed"][tokens.to(dev).long()]
    for _, lp, moe in _layers(params, cfg):
        args = (x, lp, cfg, None, start_pos, positions, kv_len, moe)
        x = (torch.utils.checkpoint.checkpoint(_layer, *args,
                                               use_reentrant=False)
             if remat else _layer(*args))
    return _logits(x, params, cfg, False)


def _mla_attention_paged(x, lp, cfg: MLAConfig, pool_l, table, pidx, poff,
                         start_pos, positions, kv_len):
    """:func:`_mla_attention` against one layer of the paged latent arena:
    the new tokens' latent rows (lane-padded) are scattered into the pages
    named by the table, in place; attention gathers the pages inside the
    kernel, reading the first ``cfg.latent_dim`` columns."""
    q_full, new_tok = _mla_project(x, lp, cfg, positions)
    new_tok = pad_latents(cfg, new_tok)
    kw = dict(rank=cfg.kv_lora_rank, scale=cfg.sm_scale)
    if isinstance(pool_l, dict):
        # zero pad columns quantize to 0 and leave the absmax as it is
        sym, scl = pool_l["sym"], pool_l["scale"]
        n_sym, n_sc = quantize_latents(new_tok)
        sym[pidx, poff] = n_sym
        scl[pidx, poff] = n_sc
        ctx = quantized_paged_latent_attention_dma(
            q_full.to(torch_dtype(cfg)), sym, scl, table, start_pos, kv_len,
            **kw)
    else:
        # idle decode rows all land in the null page 0 (duplicate indices,
        # order undefined, never read unmasked by a live row)
        pool_l[pidx, poff] = new_tok.to(pool_l.dtype)
        ctx = paged_latent_attention_dma(q_full.to(pool_l.dtype), pool_l,
                                         table, start_pos, kv_len, **kw)
    return _context_out(ctx, lp, cfg, x)


@torch.no_grad()
def forward_paged(
    params: Params,
    cfg: MLAConfig,
    tokens: torch.Tensor,  # int [B, T]
    start_pos: torch.Tensor,  # int [B]
    latent_pool,  # [L, P, page, Cp] or the int8 {"sym", "scale"} arena
    page_table: torch.Tensor,  # int [B, NP]
    *,
    last_logit_only: bool = False,
    mesh=None,
):
    """:func:`forward` against the shared paged latent arena: the new
    tokens' latent rows are scattered **in place** into the pages named by
    ``page_table`` (quantized per token for an int8 arena) and attention
    reads the pages through the table inside the kernel
    (``paged_latent_attention_dma``). Returns (logits fp32, the arena). With
    ``mesh``, ``params`` are this rank's and the arena is replicated over
    both axes (the JAX engine's ``P()``): every rank writes the same latent
    rows, attends with its ``H / tp`` heads and computes every row of the
    step."""
    check_supported(cfg)
    tp = model_axis(cfg, mesh)
    B, T = tokens.shape
    quant = isinstance(latent_pool, dict)
    arena = latent_pool["sym"] if quant else latent_pool
    dev, page = arena.device, arena.shape[2]
    start_pos, positions, kv_len = _positions(start_pos, T, dev)
    table = page_table.to(device=dev, dtype=torch.int32).contiguous()
    # per-(batch, new-token) page id and in-page offset
    pidx = torch.gather(table.long(), 1, positions // page)
    poff = positions % page
    x = params["embed"][tokens.to(dev).long()]
    for li, lp, moe in _layers(params, cfg):
        pool_l = ({k: v[li] for k, v in latent_pool.items()} if quant
                  else latent_pool[li])
        attn = _mla_attention_paged(x, lp, cfg, pool_l, table, pidx, poff,
                                    start_pos, positions, kv_len)
        x = _mlp_residual(x, attn, lp, cfg, moe, tp)
    return _logits(x, params, cfg, last_logit_only), latent_pool
