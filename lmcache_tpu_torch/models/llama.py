"""LLaMA-family transformer in PyTorch: the port of
``lmcache_tpu/models/llama.py`` for the dense llama path.

- parameters are a plain dict of tensors mirroring the JAX pytree, layers
  **stacked** on a leading ``[L, ...]`` axis (``params["layers"]["wq"][l]``),
  applied as ``x @ W``; :func:`params_from_jax` carries a JAX tree across
  unchanged;
- the layer loop is a Python loop (the JAX file's ``lax.scan``);
- the KV cache is one tensor ``[L, 2, B, H_kv, S_max, D]`` — HEAD-major,
  read by the attention kernel with no relayout. :func:`forward` writes the
  new tokens' K/V into it **in place** (JAX returns a new, donated buffer);
  ``cache_to_blob``/``blob_into_cache`` convert to/from the token-major
  cache-engine blob ``[L, 2, T, H_kv, D]``;
- attention is :func:`lmcache_tpu_torch.ops.flash_attention`, fed directly
  from the cache: the Hopper kernel on CUDA tensors, the plain version on CPU
  tensors. Prefill-with-cached-prefix and decode are one code path with
  different ``T``;
- :func:`forward_quantized` is the same step over an int8 pool
  ``{"sym" [L, 2, B, H_kv, S, D] int8, "scale" [L, 2, B, S] fp32}``: the new
  tokens are quantized per (layer, token) and written first, then attention
  reads the pool through
  :func:`lmcache_tpu_torch.ops.quantized_flash_attention`;
- each layer attends under its own window: none, or ``cfg.sliding_window``
  where ``cfg.layer_windows()`` says the layer is local (uniform for Mistral
  and Phi-3, alternating for Gemma and GPT-OSS, 3 local to 1 global for
  Llama-4), sliding or chunked (``cfg.local_attention_kind``), with the score
  softcap and the attention sinks of the config;
- a layer is the JAX file's block structure: :func:`_attn_input` (pre-norm,
  or the raw residual for OLMo-2), :func:`_qkv_heads` (flat or per-head q/k
  norms, the layer's rope frequencies, Llama-4's L2 q/k norm and NoPE query
  temperature, each by the layer's is-global flag), attention,
  :func:`_attn_residual` and :func:`_mlp_residual` (sandwich norms, dense or
  MoE MLP). The MoE MLP (Mixtral, Qwen3-MoE, GPT-OSS, Llama-4) runs each
  token's routed experts only, in padded per-expert blocks
  (``models/experts.py``, shared with the MLA model): the JAX scan's
  function, whose unselected experts give exactly 0.

``LlamaConfig`` is a copy of the JAX dataclass with its presets, so every
config of the JAX package can be built here, and every preset runs on the
dense and the paged forwards. The HuggingFace loaders
(``LlamaConfig.from_hf``, ``load_hf``) are not ported yet (ROADMAP, module
item 6b).
"""

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from lmcache_tpu_torch.models import experts
from lmcache_tpu_torch.ops.attention import flash_attention, mha_reference
from lmcache_tpu_torch.ops.quantized_attention import (
    quantize_tokens, quantized_attention_reference, quantized_flash_attention)
from lmcache_tpu_torch.utils import resolve_device

Params = Dict[str, Any]


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    hidden_dim: int = 11008
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_seq_len: int = 16384
    dtype: str = "bfloat16"
    # qkv projection bias (Qwen family; reference CacheGen family table
    # includes Qwen-7B, cachegen_basics.py:36)
    attention_bias: bool = False
    # sliding-window attention (Mistral family); None = full causal
    sliding_window: "Optional[int]" = None
    # partial rotary (GLM family — the reference CacheGen table includes
    # glm, cachegen_basics.py): rotate only the first rotary_dim of each
    # head; None = full head_dim. GLM also pairs adjacent channels
    # ("interleaved") instead of llama's half-split.
    rotary_dim: "Optional[int]" = None
    rope_interleaved: bool = False
    # RoPE frequency scaling for context extension. "linear" divides
    # every frequency by the factor (longchat's rope condensation);
    # "llama3" rescales only low-frequency channels with a smooth
    # interpolation band (llama-3.1's scheme); "yarn" is NTK-by-parts
    # interpolation with an attention-temperature mscale (Qwen long-
    # context). Flat fields (not a dict) keep the config hashable for
    # jit static args.
    rope_scaling_type: "Optional[str]" = None  # linear|llama3|yarn|longrope
    rope_scaling_factor: float = 1.0
    rope_low_freq_factor: float = 1.0  # llama3
    rope_high_freq_factor: float = 4.0  # llama3
    rope_beta_fast: float = 32.0  # yarn
    rope_beta_slow: float = 1.0  # yarn
    rope_attention_factor: "Optional[float]" = None  # yarn/longrope mscale
    rope_original_max_seq: "Optional[int]" = None
    # longrope (Phi-3 family): per-dim frequency dividers [rd/2], chosen
    # ONCE at config time (long_factor when the deployment context
    # exceeds the pretraining context, else short_factor). HF switches
    # factor sets dynamically on the running seq_len, which silently
    # invalidates every already-cached K the moment a sequence crosses
    # the boundary — a static per-deployment choice is what keeps cached
    # chunks reusable (and is what serving engines do).
    rope_freq_factors: "Optional[Tuple[float, ...]]" = None

    @property
    def rope_scaling_spec(self):
        """Hashable tuple for the rope helpers; None when unscaled."""
        if self.rope_scaling_type is None:
            return None
        return (self.rope_scaling_type, self.rope_scaling_factor,
                self.rope_low_freq_factor, self.rope_high_freq_factor,
                self.rope_original_max_seq, self.rope_beta_fast,
                self.rope_beta_slow, self.rope_attention_factor,
                self.rope_freq_factors)
    # sandwich norms (Glm4-0414 family, HF `glm4` arch): extra RMSNorms
    # on the attention and MLP *outputs* before the residual add
    # (post_self_attn_layernorm / post_mlp_layernorm in modeling_glm4)
    post_norms: bool = False
    # pre-norms on the block INPUTS (llama convention). OLMo-2 norms
    # only the outputs: pre_norms=False + post_norms=True reproduces
    # x + norm(attn(x)) / x + norm(mlp(x)) (modeling_olmo2)
    pre_norms: bool = True
    # RMSNorm over the FULL projected q/k vectors ([H*D]) before the
    # head reshape and rope (OLMo-2) — unlike qk_norm's per-head norm
    qk_norm_flat: bool = False
    # per-head RMSNorm on q and k before RoPE (Qwen3 family)
    qk_norm: bool = False
    # sparse mixture-of-experts MLP (Mixtral / Qwen3-MoE families);
    # None = dense SwiGLU. norm_topk_prob renormalizes the selected
    # experts' probabilities — mathematically identical to Mixtral's
    # softmax-over-top-k-logits (softmax restricted to a subset ==
    # renormalized softmax), so one flag covers both families.
    n_experts: "Optional[int]" = None
    n_experts_per_tok: int = 2
    moe_hidden_dim: "Optional[int]" = None  # expert width; None=hidden_dim
    norm_topk_prob: bool = True
    # decoupled head dim (Qwen3-4B-class: head_dim != dim // n_heads);
    # None = dim // n_heads
    head_dim_override: "Optional[int]" = None
    # --- Gemma-family traits -------------------------------------------
    # MLP activation on the gate projection: "silu" (llama SwiGLU) or
    # "gelu_tanh" (Gemma's GeGLU, HF hidden_activation
    # "gelu_pytorch_tanh")
    mlp_act: str = "silu"
    # RMSNorm multiplies by (1 + weight) in float32 (Gemma convention;
    # weights are deltas around identity)
    norm_one_offset: bool = False
    # embeddings scaled by sqrt(dim) after lookup (Gemma)
    embed_scale: bool = False
    # attention scores bounded to (-cap, cap) via cap*tanh(s/cap)
    # before masking (Gemma-2 attn_logit_softcapping)
    attn_logit_softcap: "Optional[float]" = None
    # final lm_head logits bounded the same way (Gemma-2
    # final_logit_softcapping)
    final_logit_softcap: "Optional[float]" = None
    # attention score scale = query_pre_attn_scalar**-0.5 instead of
    # head_dim**-0.5 (Gemma-2; e.g. 27B uses dim/n_heads != head_dim)
    query_pre_attn_scalar: "Optional[float]" = None
    # alternating local/global attention: with pattern p, layer i uses
    # FULL attention iff (i + 1) % p == 0 and the sliding window
    # otherwise (Gemma-2: p=2; Gemma-3: p=6). None = every layer slides
    # when sliding_window is set (Mistral).
    sliding_window_pattern: "Optional[int]" = None
    # explicit per-layer is-global map [L] (HF `layer_types` lists:
    # True = full_attention). Overrides sliding_window_pattern.
    global_layer_map: "Optional[Tuple[bool, ...]]" = None
    # dual-theta rotary (Gemma-3): sliding layers rope at this base
    # frequency with NO context-extension scaling; global layers keep
    # rope_theta + rope_scaling (HF rope_local_base_freq)
    rope_local_theta: "Optional[float]" = None
    # --- Llama-4 family traits (iRoPE) ---------------------------------
    # local-attention kind for non-global layers: "sliding" (trailing
    # window of sliding_window positions, Mistral/Gemma) or "chunked"
    # (block-diagonal chunks of sliding_window positions, Llama-4
    # attention_chunk_size)
    local_attention_kind: str = "sliding"
    # global (full-attention) layers carry NO positional encoding —
    # identity rotation — while local layers rope normally (Llama-4
    # no_rope_layers; from_hf verifies the HF masks align)
    nope_on_global_layers: bool = False
    # weightless L2 norm on q and k AFTER rope, rope layers only
    # (Llama-4 use_qk_norm — unlike qk_norm's learned RMS before rope)
    qk_l2_norm: bool = False
    # NoPE-layer query temperature (arXiv:2501.19399, Llama-4):
    # q *= 1 + attn_scale * log1p(floor((pos + 1) / attn_floor_scale))
    attn_temperature_tuning: bool = False
    attn_floor_scale: float = 8192.0
    attn_scale: float = 0.1
    # MoE routing style: "softmax_topk" (Mixtral/Qwen3: softmax probs,
    # top-k, optional renorm, output-weighted), "llama4" (top-k on
    # LOGITS, sigmoid gates scaling the expert INPUT, plus an always-on
    # shared expert of width hidden_dim; moe_hidden_dim = routed width),
    # or "gpt_oss" (biased router, softmax over the top-k logits,
    # biased experts with the clamped gated activation
    # (up+1) * gate * sigmoid(1.702 * gate), gate/up clamped at
    # moe_act_limit)
    moe_style: str = "softmax_topk"
    moe_act_limit: float = 7.0  # gpt_oss swiglu clamp
    # --- GPT-OSS family traits -----------------------------------------
    # learned per-head attention-sink logits joined to every softmax
    # normalization and then dropped (params["layers"]["sinks"] [L, H])
    attn_sinks: bool = False
    # bias on the attention OUTPUT projection (GPT-OSS o_proj; HF
    # zero-inits it so random-weight parity can't see a dropped load —
    # released checkpoints carry trained values)
    attention_out_bias: bool = False

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or self.dim // self.n_heads

    @property
    def sm_scale(self) -> "Optional[float]":
        """Attention score scale override; None = 1/sqrt(head_dim)."""
        if self.query_pre_attn_scalar is None:
            return None
        return float(self.query_pre_attn_scalar)**-0.5

    def layer_windows(self) -> np.ndarray:
        """Per-layer bool [L]: True where the layer attends GLOBALLY
        (full causal), False where it uses the sliding window. All-True
        when no window is configured; all-False (every layer windowed)
        for Mistral-style uniform windows."""
        if self.sliding_window is None:
            return np.ones(self.n_layers, bool)
        if self.global_layer_map is not None:
            if len(self.global_layer_map) != self.n_layers:
                raise ValueError(
                    f"global_layer_map has {len(self.global_layer_map)} "
                    f"entries for {self.n_layers} layers")
            return np.asarray(self.global_layer_map, bool)
        if self.sliding_window_pattern is None:
            return np.zeros(self.n_layers, bool)
        p = self.sliding_window_pattern
        return np.asarray(
            [(i + 1) % p == 0 for i in range(self.n_layers)], bool)

    @staticmethod
    def tiny(**over) -> "LlamaConfig":
        """Small config for tests — geometry chosen to still exercise GQA
        and 128-lane tiling."""
        kw = dict(vocab_size=512, dim=256, n_layers=4, n_heads=4,
                  n_kv_heads=2, hidden_dim=512, max_seq_len=1024,
                  dtype="float32")
        kw.update(over)
        return LlamaConfig(**kw)

    @staticmethod
    def tinyllama_1_1b() -> "LlamaConfig":
        return LlamaConfig(vocab_size=32000, dim=2048, n_layers=22,
                           n_heads=32, n_kv_heads=4, hidden_dim=5632,
                           max_seq_len=2048, rope_theta=10000.0)

    @staticmethod
    def llama2_7b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def longchat_7b_16k() -> "LlamaConfig":
        # llama-2-7b arch with 16k context via linear rope condensation
        # (factor 8 over the 2k base — the reference's CacheGen eval
        # model, lmcache/serde/cachegen_basics.py:36)
        return LlamaConfig(max_seq_len=16384, rope_theta=10000.0,
                           rope_scaling_type="linear",
                           rope_scaling_factor=8.0,
                           rope_original_max_seq=2048)

    @staticmethod
    def mistral_7b() -> "LlamaConfig":
        return LlamaConfig(vocab_size=32000, dim=4096, n_layers=32,
                           n_heads=32, n_kv_heads=8, hidden_dim=14336,
                           rope_theta=1000000.0, max_seq_len=32768,
                           sliding_window=4096)

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig(vocab_size=128256, dim=4096, n_layers=32,
                           n_heads=32, n_kv_heads=8, hidden_dim=14336,
                           rope_theta=500000.0, max_seq_len=8192)

    @staticmethod
    def llama3_1_8b() -> "LlamaConfig":
        # llama-3.1-8b: llama3 geometry + frequency-dependent rope
        # scaling to 128k (the reference CacheGen family table's
        # llama-3.1 entry)
        return LlamaConfig(vocab_size=128256, dim=4096, n_layers=32,
                           n_heads=32, n_kv_heads=8, hidden_dim=14336,
                           rope_theta=500000.0, max_seq_len=131072,
                           rope_scaling_type="llama3",
                           rope_scaling_factor=8.0,
                           rope_low_freq_factor=1.0,
                           rope_high_freq_factor=4.0,
                           rope_original_max_seq=8192)

    @staticmethod
    def qwen_7b() -> "LlamaConfig":
        # Qwen/Qwen2-7B geometry; attention_bias=True is the family trait
        return LlamaConfig(vocab_size=152064, dim=3584, n_layers=28,
                           n_heads=28, n_kv_heads=4, hidden_dim=18944,
                           rope_theta=1000000.0, max_seq_len=32768,
                           attention_bias=True)

    @staticmethod
    def glm4_9b() -> "LlamaConfig":
        # THUDM/glm-4-9b-chat geometry (HF `glm` arch): multi-query
        # attention (2 kv heads), qkv bias, interleaved partial rotary
        return LlamaConfig(vocab_size=151552, dim=4096, n_layers=40,
                           n_heads=32, n_kv_heads=2, hidden_dim=13696,
                           rope_theta=10000.0, max_seq_len=131072,
                           attention_bias=True, rotary_dim=64,
                           rope_interleaved=True)

    @staticmethod
    def qwen3_8b() -> "LlamaConfig":
        # Qwen/Qwen3-8B: per-head q/k RMSNorm before RoPE, no qkv bias
        return LlamaConfig(vocab_size=151936, dim=4096, n_layers=36,
                           n_heads=32, n_kv_heads=8, hidden_dim=12288,
                           rope_theta=1000000.0, max_seq_len=40960,
                           qk_norm=True)

    @staticmethod
    def qwen3_4b() -> "LlamaConfig":
        # Qwen/Qwen3-4B: head_dim (128) decoupled from dim/n_heads (80)
        return LlamaConfig(vocab_size=151936, dim=2560, n_layers=36,
                           n_heads=32, n_kv_heads=8, hidden_dim=9728,
                           rope_theta=1000000.0, max_seq_len=40960,
                           qk_norm=True, head_dim_override=128)

    @staticmethod
    def mixtral_8x7b() -> "LlamaConfig":
        # mistralai/Mixtral-8x7B: 8 SwiGLU experts, top-2 routing
        return LlamaConfig(vocab_size=32000, dim=4096, n_layers=32,
                           n_heads=32, n_kv_heads=8, hidden_dim=14336,
                           rope_theta=1000000.0, max_seq_len=32768,
                           n_experts=8, n_experts_per_tok=2)

    @staticmethod
    def qwen3_moe_30b_a3b() -> "LlamaConfig":
        # Qwen/Qwen3-30B-A3B: 128 narrow experts, top-8, qk-norm
        return LlamaConfig(vocab_size=151936, dim=2048, n_layers=48,
                           n_heads=32, n_kv_heads=4, hidden_dim=6144,
                           rope_theta=1000000.0, max_seq_len=40960,
                           qk_norm=True, head_dim_override=128,
                           n_experts=128, n_experts_per_tok=8,
                           moe_hidden_dim=768)

    @staticmethod
    def glm4_0414_9b() -> "LlamaConfig":
        # THUDM/GLM-4-9B-0414 (HF `glm4` arch): glm4_9b geometry plus
        # the family's sandwich norms on attention/MLP outputs
        return LlamaConfig(vocab_size=151552, dim=4096, n_layers=40,
                           n_heads=32, n_kv_heads=2, hidden_dim=13696,
                           rope_theta=10000.0, max_seq_len=32768,
                           attention_bias=True, rotary_dim=64,
                           rope_interleaved=True, post_norms=True)

    @staticmethod
    def gemma2_9b() -> "LlamaConfig":
        # google/gemma-2-9b: GeGLU, (1+w) norms, scaled embeddings,
        # sandwich norms, alternating 4k-local/global attention,
        # score + logit softcaps, decoupled head_dim 256
        return LlamaConfig(vocab_size=256000, dim=3584, n_layers=42,
                           n_heads=16, n_kv_heads=8, hidden_dim=14336,
                           rope_theta=10000.0, max_seq_len=8192,
                           norm_eps=1e-6, head_dim_override=256,
                           mlp_act="gelu_tanh", norm_one_offset=True,
                           embed_scale=True, post_norms=True,
                           attn_logit_softcap=50.0,
                           final_logit_softcap=30.0,
                           query_pre_attn_scalar=256.0,
                           sliding_window=4096,
                           sliding_window_pattern=2)

    @staticmethod
    def gemma3_4b() -> "LlamaConfig":
        # google/gemma-3-4b (text stack): gemma-2 traits minus the
        # softcaps, plus per-head qk-norm, 5-local:1-global attention
        # (pattern 6, 1k window), and dual-theta rotary — sliding layers
        # at 10k base, global layers at 1M with linear factor-8 scaling
        return LlamaConfig(vocab_size=262208, dim=2560, n_layers=34,
                           n_heads=8, n_kv_heads=4, hidden_dim=10240,
                           rope_theta=1000000.0, max_seq_len=131072,
                           norm_eps=1e-6, head_dim_override=256,
                           mlp_act="gelu_tanh", norm_one_offset=True,
                           embed_scale=True, post_norms=True,
                           qk_norm=True, query_pre_attn_scalar=256.0,
                           sliding_window=1024,
                           sliding_window_pattern=6,
                           rope_local_theta=10000.0,
                           rope_scaling_type="linear",
                           rope_scaling_factor=8.0,
                           rope_original_max_seq=131072)

    @staticmethod
    def llama4_scout_17b_16e() -> "LlamaConfig":
        # meta-llama/Llama-4-Scout-17B-16E: iRoPE — 3 chunked-attention
        # rope layers then 1 NoPE full-attention layer (pattern 4),
        # 8192-token chunks, post-rope L2 qk-norm, NoPE query
        # temperature, 16-expert sigmoid top-1 MoE with a shared expert
        return LlamaConfig(vocab_size=202048, dim=5120, n_layers=48,
                           n_heads=40, n_kv_heads=8, hidden_dim=8192,
                           rope_theta=500000.0, max_seq_len=10485760,
                           rope_interleaved=True, sliding_window=8192,
                           sliding_window_pattern=4,
                           local_attention_kind="chunked",
                           nope_on_global_layers=True, qk_l2_norm=True,
                           attn_temperature_tuning=True,
                           n_experts=16, n_experts_per_tok=1,
                           moe_hidden_dim=8192, moe_style="llama4",
                           rope_scaling_type="llama3",
                           rope_scaling_factor=8.0,
                           rope_low_freq_factor=1.0,
                           rope_high_freq_factor=4.0,
                           rope_original_max_seq=8192)

    @staticmethod
    def olmo2_7b() -> "LlamaConfig":
        # allenai/OLMo-2-1124-7B: norms on the block OUTPUTS only
        # (x + norm(attn(x))), full-width qk-norms before the head
        # reshape, otherwise llama geometry
        return LlamaConfig(vocab_size=100352, dim=4096, n_layers=32,
                           n_heads=32, n_kv_heads=32, hidden_dim=11008,
                           rope_theta=500000.0, max_seq_len=4096,
                           pre_norms=False, post_norms=True,
                           qk_norm_flat=True)

    @staticmethod
    def gpt_oss_20b() -> "LlamaConfig":
        # openai/gpt-oss-20b: per-head attention SINKS joined to every
        # softmax, alternating 128-token sliding / full layers
        # (pattern 2), biased qkv, yarn rope to 128k, and a 32-expert
        # top-4 MoE with biased clamped-GLU experts
        return LlamaConfig(vocab_size=201088, dim=2880, n_layers=24,
                           n_heads=64, n_kv_heads=8, hidden_dim=2880,
                           head_dim_override=64, rope_theta=150000.0,
                           max_seq_len=131072, attention_bias=True,
                           attention_out_bias=True,
                           attn_sinks=True, sliding_window=128,
                           sliding_window_pattern=2,
                           n_experts=32, n_experts_per_tok=4,
                           moe_hidden_dim=2880, moe_style="gpt_oss",
                           rope_scaling_type="yarn",
                           rope_scaling_factor=32.0,
                           rope_beta_fast=32.0, rope_beta_slow=1.0,
                           rope_original_max_seq=4096)

    @staticmethod
    def phi3_mini_4k() -> "LlamaConfig":
        # microsoft/Phi-3-mini-4k-instruct: MHA (32/32 heads), fused
        # qkv/gate_up checkpoints, 2047-token sliding window. The 128k
        # variants add longrope scaling (load via from_hf — the per-dim
        # factor lists live in the checkpoint config).
        return LlamaConfig(vocab_size=32064, dim=3072, n_layers=32,
                           n_heads=32, n_kv_heads=32, hidden_dim=8192,
                           rope_theta=10000.0, max_seq_len=4096,
                           sliding_window=2047)



_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def torch_dtype(cfg: LlamaConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


_MOE_STYLES = ("softmax_topk", "gpt_oss", "llama4")


def check_supported(cfg: LlamaConfig) -> None:
    """Raise ``ValueError`` for a trait value no forward runs: an unknown
    ``local_attention_kind``, ``moe_style`` or ``mlp_act``. Every
    ``LlamaConfig`` preset runs on the dense and the paged forwards alike:
    per-layer windows, sliding or chunked, the score softcap, attention
    sinks, the per-layer rope and query traits and the three MoE styles, as
    in the JAX package."""
    if cfg.local_attention_kind not in ("sliding", "chunked"):
        raise ValueError(
            f"unknown local_attention_kind {cfg.local_attention_kind!r}")
    if cfg.n_experts and cfg.moe_style not in _MOE_STYLES:
        raise ValueError(f"unknown moe_style {cfg.moe_style!r} (one of "
                         f"{_MOE_STYLES})")
    if cfg.mlp_act not in ("silu", "gelu_tanh"):
        raise ValueError(f"unknown mlp_act {cfg.mlp_act!r}")


# a weight of more elements than this is drawn a leading index at a time, so
# that its fp32 draw never needs its whole size at once (Qwen3-MoE's experts:
# 9.7e9 elements a weight); a smaller one is drawn in one call
_DRAW_WHOLE = 2**31


def init_params(cfg: LlamaConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Params:
    """Random weights in the JAX tree's layout (``init_params`` of the JAX
    file): normal / sqrt(fan_in), norms at identity (1, or 0 for the
    ``(1 + w)`` families), biases and sinks at 0. The keys follow the
    config: ``attn_norm``/``mlp_norm`` under ``pre_norms``, the dense MLP
    ``w_gate``/``w_up``/``w_down`` without experts (and as Llama-4's shared
    expert), ``router`` and ``e_gate``/``e_up``/``e_down`` [L, E, ...] with
    experts (GPT-OSS: ``router_b``, ``e_bg``/``e_bu``/``e_bd``),
    ``post_attn_norm``/``post_mlp_norm``, ``q_norm``/``k_norm`` per head
    (``qk_norm``) or flat (``qk_norm_flat``), ``sinks``. Draws come from
    ``generator`` (which must live on ``device``), default a fresh one
    seeded 0."""
    check_supported(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    dt = torch_dtype(cfg)
    L, dim, hd = cfg.n_layers, cfg.dim, cfg.head_dim
    nh, nkv, hid = cfg.n_heads, cfg.n_kv_heads, cfg.hidden_dim

    def w(shape, fan_in):
        if math.prod(shape) <= _DRAW_WHOLE:
            x = torch.randn(shape, generator=generator, device=dev)
            return (x * fan_in**-0.5).to(dt)
        out = torch.empty(shape, dtype=dt, device=dev)
        for i in range(shape[0]):
            x = torch.randn(shape[1:], generator=generator, device=dev)
            out[i] = (x * fan_in**-0.5).to(dt)
        return out

    def norm(shape):
        return (torch.zeros if cfg.norm_one_offset else torch.ones)(
            shape, dtype=dt, device=dev)

    def zeros(shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    layers = {
        "wq": w((L, dim, nh * hd), dim),
        "wk": w((L, dim, nkv * hd), dim),
        "wv": w((L, dim, nkv * hd), dim),
        "wo": w((L, nh * hd, dim), nh * hd),
    }
    if cfg.pre_norms:
        layers["attn_norm"] = norm((L, dim))
        layers["mlp_norm"] = norm((L, dim))
    if not cfg.n_experts or cfg.moe_style == "llama4":
        # the dense MLP, or Llama-4's always-on shared expert
        layers["w_gate"] = w((L, dim, hid), dim)
        layers["w_up"] = w((L, dim, hid), dim)
        layers["w_down"] = w((L, hid, dim), hid)
    if cfg.n_experts:
        E, mh = cfg.n_experts, cfg.moe_hidden_dim or hid
        layers["router"] = w((L, dim, E), dim)
        layers["e_gate"] = w((L, E, dim, mh), dim)
        layers["e_up"] = w((L, E, dim, mh), dim)
        layers["e_down"] = w((L, E, mh, dim), mh)
        if cfg.moe_style == "gpt_oss":
            layers["router_b"] = zeros((L, E))
            layers["e_bg"] = zeros((L, E, mh))
            layers["e_bu"] = zeros((L, E, mh))
            layers["e_bd"] = zeros((L, E, dim))
    if cfg.attention_bias:
        for name, n in (("bq", nh * hd), ("bk", nkv * hd), ("bv", nkv * hd)):
            layers[name] = zeros((L, n))
    if cfg.attention_out_bias:
        layers["bo"] = zeros((L, dim))
    if cfg.post_norms:
        layers["post_attn_norm"] = norm((L, dim))
        layers["post_mlp_norm"] = norm((L, dim))
    if cfg.qk_norm:
        layers["q_norm"] = norm((L, hd))
        layers["k_norm"] = norm((L, hd))
    if cfg.qk_norm_flat:
        layers["q_norm"] = norm((L, nh * hd))
        layers["k_norm"] = norm((L, nkv * hd))
    if cfg.attn_sinks:
        layers["sinks"] = zeros((L, nh))
    return {
        "embed": w((cfg.vocab_size, dim), dim),
        "layers": layers,
        "final_norm": norm((dim,)),
        "lm_head": w((dim, cfg.vocab_size), dim),
    }


def _tensor_from_numpy(a, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.array(a)  # a private, writable copy
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret bits
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def params_from_jax(tree_of_numpy: Params, cfg: LlamaConfig,
                    device="cuda") -> Params:
    """Carry a JAX llama param tree (``lmcache_tpu.models.llama``: keys
    ``embed``, ``layers.{wq, wk, wv, wo, attn_norm, mlp_norm, w_gate, w_up,
    w_down, sinks, ...}``, ``final_norm``, ``lm_head``), given as numpy
    arrays, onto the port's parameters unchanged, in ``cfg.dtype`` on
    ``device``."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = torch_dtype(cfg)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return _tensor_from_numpy(x, dt, dev)

    return conv(tree_of_numpy)


def paged_pool_from_jax(pool_or_dict, device="cuda"):
    """Carry a JAX page arena (``lmcache_tpu.models.paged``), given as numpy
    arrays, onto ``device`` unchanged: a bf16/fp32 arena
    ``[L, 2, P, H_kv, page, D]`` keeps its dtype, an int8 arena
    ``{"sym" int8 [L, 2, P, H_kv, page, D], "scale" f32 [L, 2, P, page]}``
    stays a dict. The result is the port's arena
    (``lmcache_tpu_torch.models.paged``), so both packages can run one step
    on the same pages."""
    if isinstance(pool_or_dict, dict):
        return quantized_pool_from_jax(pool_or_dict, device)
    dev = resolve_device(device)
    a = np.asarray(pool_or_dict)
    dt = torch.bfloat16 if a.dtype.name == "bfloat16" else getattr(
        torch, a.dtype.name)
    return _tensor_from_numpy(a, dt, dev)


def quantized_pool_from_jax(pool: Dict[str, Any],
                            device="cuda") -> Dict[str, torch.Tensor]:
    """Carry a JAX int8 pool, given as numpy arrays, onto ``device``
    unchanged: the dense ``new_quantized_kv_cache`` pool ``{"sym" int8
    [L, 2, B, H_kv, S, D], "scale" f32 [L, 2, B, S]}`` or the int8 page
    arena of :func:`paged_pool_from_jax` (the same keys). The result is the
    port's pool, so both packages can run one step on the same symbols."""
    dev = resolve_device(device)
    return {
        "sym": _tensor_from_numpy(pool["sym"], torch.int8, dev),
        "scale": _tensor_from_numpy(pool["scale"], torch.float32, dev),
    }


def new_kv_cache(cfg: LlamaConfig, batch: int, max_len: int,
                 device="cuda") -> torch.Tensor:
    """Fresh KV cache [L, 2, B, H_kv, S, D] — HEAD-major, zeroed.

    The live pool is head-major so the attention kernel reads it directly;
    the cache-blob wire format stays token-major ([L, 2, T, H, D], the
    reference's vllm fmt) and is transposed once per chunk at the
    inject/read boundary, not per step.
    """
    return torch.zeros(
        (cfg.n_layers, 2, batch, cfg.n_kv_heads, max_len, cfg.head_dim),
        dtype=torch_dtype(cfg), device=resolve_device(device))


def new_quantized_kv_cache(cfg: LlamaConfig, batch: int, max_len: int,
                           device="cuda") -> Dict[str, torch.Tensor]:
    """Int8 KV pool: {"sym" [L, 2, B, H_kv, S, D] int8, zeroed, "scale"
    [L, 2, B, S] fp32, initialised to 1}. Half the bytes of the
    :func:`new_kv_cache` pool; read by the kernel that dequantizes inside
    attention (``ops/quantized_attention.py``). One symmetric scale per
    (layer, token), the CacheGen quantization granularity; head-major
    symbols for the same reason as :func:`new_kv_cache`."""
    dev = resolve_device(device)
    L, Hkv, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    return {
        "sym": torch.zeros((L, 2, batch, Hkv, max_len, D), dtype=torch.int8,
                           device=dev),
        "scale": torch.ones((L, 2, batch, max_len), dtype=torch.float32,
                            device=dev),
    }


def cache_to_blob(cache: torch.Tensor, b: int = 0,
                  n: "Optional[int]" = None) -> torch.Tensor:
    """One batch row of the head-major pool as a wire-format cache blob
    [L, 2, n, H, D] (the reference's vllm fmt). A VIEW of the pool: it
    changes when the pool is written (the storage tier copies what it
    keeps)."""
    g = cache[:, :, b] if n is None else cache[:, :, b, :, :n]
    return g.transpose(2, 3)


def blob_into_cache(cache: torch.Tensor, blob: torch.Tensor, b: int = 0,
                    pos: int = 0) -> torch.Tensor:
    """Write a wire blob [L, 2, t, H, D] into the head-major pool at token
    offset ``pos`` of batch row ``b``, in place; returns ``cache``."""
    t = blob.shape[2]
    cache[:, :, b, :, pos:pos + t] = blob.transpose(2, 3)
    return cache


def quantized_cache_to_blob(cache: Dict[str, torch.Tensor], b: int = 0,
                            n: "Optional[int]" = None,
                            dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """One batch row of the int8 pool, dequantized to ``dtype``, as a
    wire-format cache blob [L, 2, n, H, D]: a new tensor, not a view."""
    sym, scale = cache["sym"][:, :, b], cache["scale"][:, :, b]
    if n is not None:
        sym, scale = sym[:, :, :, :n], scale[:, :, :n]
    deq = (sym.float() * scale[:, :, None, :, None]).to(dtype)
    return deq.transpose(2, 3)


def blob_into_quantized_cache(cache: Dict[str, torch.Tensor],
                              blob: torch.Tensor, b: int = 0,
                              pos: int = 0) -> Dict[str, torch.Tensor]:
    """Quantize a wire blob [L, 2, t, H, D] per (layer, K/V, token) over its
    (H, D) axes, as the model quantizes what it writes, and write symbols
    and scales into the int8 pool at token offset ``pos`` of batch row
    ``b``, in place; returns ``cache``."""
    t = blob.shape[2]
    sym, scale = quantize_tokens(blob.to(cache["sym"].device), (3, 4))
    cache["sym"][:, :, b, :, pos:pos + t] = sym.transpose(2, 3)
    cache["scale"][:, :, b, pos:pos + t] = scale
    return cache


def _rms_norm(x, weight, eps, one_offset=False):
    x32 = x.float()
    rms = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    if one_offset:
        return (x32 * rms * (1.0 + weight.float())).to(x.dtype)
    return (x32 * rms).to(x.dtype) * weight


def _act(x, kind):
    """Gate activation: llama SwiGLU's silu or Gemma GeGLU's tanh-gelu."""
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown mlp_act {kind!r}")


def rope_inv_freq(theta, rd, scaling=None, device=None):
    """Rotary inverse frequencies [rd/2] (fp32) and the attention-temperature
    scale, with optional context-extension scaling
    (``LlamaConfig.rope_scaling_spec``): ``linear``, ``llama3``, ``yarn``
    and ``longrope``, as in the JAX file's ``rope_inv_freq``."""
    inv_freq = 1.0 / (theta**(
        torch.arange(0, rd, 2, dtype=torch.float32, device=device) / rd))
    if scaling is None:
        return inv_freq, 1.0
    kind, factor, low, high, orig_max = scaling[:5]
    if kind == "linear":
        return inv_freq / factor, 1.0
    if kind == "llama3":
        wavelen = 2.0 * math.pi / inv_freq
        scaled = torch.where(wavelen > orig_max / low, inv_freq / factor,
                             inv_freq)
        smooth = (orig_max / wavelen - low) / (high - low)
        interp = (1.0 - smooth) / factor * inv_freq + smooth * inv_freq
        mid = (wavelen <= orig_max / low) & (wavelen >= orig_max / high)
        return torch.where(mid, interp, scaled), 1.0
    if kind == "yarn":
        beta_fast, beta_slow, attn_factor = scaling[5:8]
        if attn_factor is not None:
            mscale = attn_factor
        elif factor > 1.0:
            mscale = 0.1 * float(np.log(factor)) + 1.0
        else:
            mscale = 1.0

        def correction_dim(beta):
            return (rd * np.log(orig_max / (beta * 2.0 * np.pi))
                    / (2.0 * np.log(theta)))

        lo = max(int(np.floor(correction_dim(beta_fast))), 0)
        hi = min(int(np.ceil(correction_dim(beta_slow))), rd - 1)
        ramp = torch.clamp(
            (torch.arange(rd // 2, dtype=torch.float32, device=device) - lo)
            / max(hi - lo, 1e-3), 0.0, 1.0)
        extrap_w = 1.0 - ramp  # 1 where extrapolated (high freq)
        return (inv_freq / factor * (1.0 - extrap_w)
                + inv_freq * extrap_w), mscale
    if kind == "longrope":
        attn_factor, freq_factors = scaling[7:9]
        if attn_factor is not None:
            mscale = attn_factor
        elif factor > 1.0:
            mscale = float(np.sqrt(1.0 + np.log(factor) / np.log(orig_max)))
        else:
            mscale = 1.0
        ext = torch.as_tensor(freq_factors, dtype=torch.float32,
                              device=device)
        if ext.shape != inv_freq.shape:
            raise ValueError(
                f"longrope needs {inv_freq.shape[0]} per-dim factors, "
                f"got {ext.shape[0]}")
        return inv_freq / ext, mscale
    raise ValueError(f"unknown rope scaling type {kind!r}")


def _rope(x, positions, theta, rotary_dim=None, interleaved=False,
          scaling=None, freqs=None):
    """HF-convention rotary embedding. x: [B, T, H, D]; positions: [B, T].
    ``rotary_dim`` rotates only the leading channels; ``interleaved`` pairs
    channels (2i, 2i+1) instead of the llama half-split (i, i + D/2).
    ``freqs=(inv_freq, mscale)`` overrides the frequencies that ``theta``
    and ``scaling`` give (the per-layer rope of :func:`_layer_rope_freqs`)."""
    D = x.shape[-1]
    rd = rotary_dim or D
    xr = x[..., :rd].float()
    if freqs is not None:
        inv_freq, mscale = freqs
    else:
        inv_freq, mscale = rope_inv_freq(theta, rd, scaling, device=x.device)
    angles = positions[..., None].float() * inv_freq  # [B, T, rd/2]
    if interleaved:
        cos = torch.repeat_interleave(torch.cos(angles), 2, dim=-1)
        sin = torch.repeat_interleave(torch.sin(angles), 2, dim=-1)
        x1, x2 = xr[..., 0::2], xr[..., 1::2]
        rotated = torch.stack([-x2, x1], dim=-1).reshape(xr.shape)
    else:
        cos = torch.cat([torch.cos(angles)] * 2, dim=-1)
        sin = torch.cat([torch.sin(angles)] * 2, dim=-1)
        x1, x2 = xr[..., :rd // 2], xr[..., rd // 2:]
        rotated = torch.cat([-x2, x1], dim=-1)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    out = (xr * (cos * mscale) + rotated * (sin * mscale)).to(x.dtype)
    if rd == D:
        return out
    return torch.cat([out, x[..., rd:]], dim=-1)


def _layer_rope_freqs(cfg, g, device=None):
    """Per-layer rotary ``(inv_freq, mscale)`` for the families whose rope
    differs by layer type (the JAX file's ``_layer_rope_freqs``):

    - dual theta (Gemma-3): sliding layers rope at ``rope_local_theta`` with
      no context-extension scaling, global layers at ``rope_theta`` with the
      configured scaling;
    - iRoPE (Llama-4, ``nope_on_global_layers``): global layers carry no
      positional encoding (zero frequencies: the rotation is the identity),
      local layers rope normally.

    ``g`` is the layer's is-global flag."""
    rd = cfg.rotary_dim or cfg.head_dim
    inv, ms = rope_inv_freq(cfg.rope_theta, rd, cfg.rope_scaling_spec,
                            device=device)
    if cfg.nope_on_global_layers:
        return (torch.zeros_like(inv), 1.0) if g else (inv, ms)
    if g:
        return inv, ms
    return rope_inv_freq(cfg.rope_local_theta, rd, None, device=device)[0], 1.0


def _l2_norm(x, eps):
    """Weightless L2 (RMS without a scale) norm in fp32 (Llama-4's
    ``Llama4TextL2Norm``)."""
    x32 = x.float()
    return (x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True)
                              + eps)).to(x.dtype)


def _embed(params, cfg, tokens):
    """Token embedding lookup, with Gemma's sqrt(dim) scaling."""
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.dim), dtype=x.dtype)
    return x


def _lm_logits(x, params, cfg):
    """Final-norm + lm_head, with Gemma-2's logit softcap."""
    x = _rms_norm(x, params["final_norm"], cfg.norm_eps,
                  cfg.norm_one_offset)
    logits = (x @ params["lm_head"]).float()
    if cfg.final_logit_softcap is not None:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _attn_input(x, lp, cfg):
    """The block input to the attention projections: pre-normed (the llama
    convention) or raw (OLMo-2 norms the outputs only)."""
    if not cfg.pre_norms:
        return x
    return _rms_norm(x, lp["attn_norm"], cfg.norm_eps, cfg.norm_one_offset)


def _qkv(h, lp, cfg):
    """The q/k/v projections with the family's optional bias (Qwen, GLM,
    GPT-OSS)."""
    q, k, v = h @ lp["wq"], h @ lp["wk"], h @ lp["wv"]
    if cfg.attention_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    return q, k, v


def _qkv_heads(h, lp, cfg, positions, g=None):
    """q [B, T, H, D], k and v [B, T, H_kv, D] of one layer from its
    attention input ``h`` (:func:`_attn_input`): the projections, OLMo-2's
    full-width q/k norms before the head reshape, Qwen3's and Gemma-3's
    per-head q/k norms before RoPE, RoPE at the layer's frequencies
    (:func:`_layer_rope_freqs`), then Llama-4's L2 q/k norm on rope layers
    and its query temperature on NoPE layers. ``g`` is the layer's is-global
    flag, which the per-layer traits need."""
    B, T = h.shape[:2]
    hd = cfg.head_dim
    q, k, v = _qkv(h, lp, cfg)
    if cfg.qk_norm_flat:
        q = _rms_norm(q, lp["q_norm"], cfg.norm_eps, cfg.norm_one_offset)
        k = _rms_norm(k, lp["k_norm"], cfg.norm_eps, cfg.norm_one_offset)
    q = q.reshape(B, T, cfg.n_heads, hd)
    k = k.reshape(B, T, cfg.n_kv_heads, hd)
    v = v.reshape(B, T, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = _rms_norm(q, lp["q_norm"], cfg.norm_eps, cfg.norm_one_offset)
        k = _rms_norm(k, lp["k_norm"], cfg.norm_eps, cfg.norm_one_offset)
    per_layer = cfg.rope_local_theta is not None or cfg.nope_on_global_layers
    if ((per_layer or cfg.qk_l2_norm or cfg.attn_temperature_tuning)
            and g is None):
        raise ValueError(
            "per-layer attention traits (rope_local_theta / "
            "nope_on_global_layers / qk_l2_norm / attn_temperature_tuning) "
            "need the layer's is-global flag")
    freqs = _layer_rope_freqs(cfg, g, h.device) if per_layer else None
    q = _rope(q, positions, cfg.rope_theta, cfg.rotary_dim,
              cfg.rope_interleaved, cfg.rope_scaling_spec, freqs=freqs)
    k = _rope(k, positions, cfg.rope_theta, cfg.rotary_dim,
              cfg.rope_interleaved, cfg.rope_scaling_spec, freqs=freqs)
    if cfg.qk_l2_norm and not g:
        # after rope, on rope layers only (global = NoPE)
        q, k = _l2_norm(q, cfg.norm_eps), _l2_norm(k, cfg.norm_eps)
    if cfg.attn_temperature_tuning and g:
        # NoPE-layer query temperature (arXiv:2501.19399):
        # 1 + attn_scale * log1p(floor((pos + 1) / floor_scale))
        scales = 1.0 + cfg.attn_scale * torch.log1p(torch.floor(
            (positions.float() + 1.0) / cfg.attn_floor_scale))
        q = (q.float() * scales[:, :, None, None]).to(q.dtype)
    return q, k, v


def _attn_residual(x, attn_flat, lp, cfg):
    """Residual add of the attention block's output (``attn_flat``
    [B, T, H*D]): the output projection (GPT-OSS: with its bias), then the
    sandwich norm on it where the family has one (Gemma-2/3, GLM-4-0414,
    OLMo-2)."""
    y = attn_flat.to(x.dtype) @ lp["wo"]
    if cfg.attention_out_bias:
        y = y + lp["bo"]
    if cfg.post_norms:
        y = _rms_norm(y, lp["post_attn_norm"], cfg.norm_eps,
                      cfg.norm_one_offset)
    return x + y


def _router_logits(h, lp, cfg):
    """fp32 router logits ``[N, E]`` of tokens ``h [N, dim]`` (GPT-OSS: with
    the router's bias)."""
    logits = (h @ lp["router"]).float()
    if cfg.moe_style == "gpt_oss":
        logits = logits + lp["router_b"].float()
    return logits


def _route_weights(logits, ids, cfg):
    """The fp32 weights ``[N, k]`` of experts ``ids [N, k]`` under the
    family's routing: ``softmax_topk`` their softmax probabilities over all
    experts (renormalized over the k with ``norm_topk_prob``), ``gpt_oss`` a
    softmax over their k logits, ``llama4`` the sigmoid of their logits (a
    gate on the expert's input)."""
    if cfg.moe_style == "softmax_topk":
        w = torch.gather(torch.softmax(logits, dim=-1), -1, ids)
        if cfg.norm_topk_prob:
            w = w / w.sum(dim=-1, keepdim=True)
        return w
    chosen = torch.gather(logits, -1, ids)
    if cfg.moe_style == "gpt_oss":
        return torch.softmax(chosen, dim=-1)
    return torch.sigmoid(chosen)


def _route(h, lp, cfg):
    """Routing of tokens ``h [N, dim]``: (expert ids [N, k], weights [N, k]
    fp32), the selection of the JAX file's ``_moe_mlp``: the top k of the
    softmax probabilities (``softmax_topk``) or of the logits (``gpt_oss``,
    ``llama4``), weighted by :func:`_route_weights`."""
    logits = _router_logits(h, lp, cfg)
    sel = (torch.softmax(logits, dim=-1) if cfg.moe_style == "softmax_topk"
           else logits)
    ids = torch.topk(sel, cfg.n_experts_per_tok, dim=-1).indices
    return ids, _route_weights(logits, ids, cfg)


# bytes the padded expert blocks of one dispatch may take: a dispatch of n
# tokens holds up to E * n rows (every token at one expert, as a skewed
# router sends them), each with its bf16 input and output (4 * dim bytes)
# and about 14 * moe_hidden bytes of fp32 and bf16 activations; a prefill
# dispatches its tokens in slices that fit (Qwen3-30B-A3B: 1771 tokens)
MOE_DISPATCH_BYTES = 4 << 30


def _moe_mlp(h, lp, cfg):
    """The sparse-MoE MLP of tokens ``h [..., dim]``: each token's routed
    experts only (:func:`experts.dispatch`, the expert weights one batched
    product each), the JAX file's every-expert scan, whose unselected
    experts give exactly 0, in the work of the routed pairs.

    - ``softmax_topk`` (Mixtral, Qwen3-MoE): gated experts, the outputs
      weighted by the routing probabilities;
    - ``gpt_oss``: biased experts with the clamped activation
      ``(up + 1) * gate * sigmoid(1.702 * gate)`` (gate at most
      ``moe_act_limit``, up within it), weighted outputs;
    - ``llama4``: the sigmoid gate scales the expert's INPUT, the outputs
      are summed unweighted, plus the always-on shared expert on the dense
      ``w_gate``/``w_up``/``w_down``.

    All tokens are routed at once (:func:`_route`); the experts then run on
    slices of at most ``MOE_DISPATCH_BYTES`` of padded blocks. The sum over
    experts is fp32, cast to ``h``'s dtype once."""
    shape = h.shape
    hf = h.reshape(-1, shape[-1])
    ids, wts = _route(hf, lp, cfg)
    row_bytes = 4 * cfg.dim + 14 * lp["e_gate"].shape[-1]
    step = max(experts.EXPERT_ROWS,
               MOE_DISPATCH_BYTES // (cfg.n_experts * row_bytes))
    out = [_expert_slice(hf[i:i + step], ids[i:i + step], wts[i:i + step],
                         lp, cfg) for i in range(0, hf.shape[0], step)]
    return torch.cat(out).reshape(shape)


def _expert_slice(hf, ids, wts, lp, cfg):
    """:func:`_moe_mlp` of tokens ``hf [n, dim]`` routed to ``ids`` with
    weights ``wts``: [n, dim] in ``hf``'s dtype."""
    k, dt = ids.shape[1], hf.dtype
    if cfg.moe_style == "llama4":
        x, slot = experts.dispatch(hf, ids, cfg.n_experts, scale=wts)
    else:
        x, slot = experts.dispatch(hf, ids, cfg.n_experts)
    gate = torch.bmm(x, lp["e_gate"]).float()
    up = torch.bmm(x, lp["e_up"]).float()
    if cfg.moe_style == "gpt_oss":
        limit = cfg.moe_act_limit
        gate = (gate + lp["e_bg"][:, None].float()).clamp(max=limit)
        up = (up + lp["e_bu"][:, None].float()).clamp(-limit, limit)
        act = (up + 1.0) * (gate * torch.sigmoid(gate * 1.702))
        y = (torch.bmm(act.to(dt), lp["e_down"]).float()
             + lp["e_bd"][:, None].float())
    else:
        y = torch.bmm((_act(gate, cfg.mlp_act) * up).to(dt), lp["e_down"])
    pairs = experts.gather(y, slot, k).float()  # [n, k, dim]
    if cfg.moe_style == "llama4":
        shared = _act((hf @ lp["w_gate"]).float(), cfg.mlp_act)
        shared = ((shared * (hf @ lp["w_up"]).float()).to(dt)
                  @ lp["w_down"]).float()
        out = shared + pairs.sum(dim=1)
    else:
        out = (wts[..., None] * pairs).sum(dim=1)
    return out.to(dt)


def _mlp_residual(x, lp, cfg):
    """The MLP block and its residual: pre-normed input (raw for OLMo-2),
    the gated dense MLP or the MoE MLP (``cfg.n_experts``), and the sandwich
    norm on its output where the family has one."""
    h = (_rms_norm(x, lp["mlp_norm"], cfg.norm_eps, cfg.norm_one_offset)
         if cfg.pre_norms else x)
    if cfg.n_experts:
        y = _moe_mlp(h, lp, cfg)
    else:
        gate = _act((h @ lp["w_gate"]).float(), cfg.mlp_act)
        up = (h @ lp["w_up"]).float()
        y = (gate * up).to(x.dtype) @ lp["w_down"]
    if cfg.post_norms:
        y = _rms_norm(y, lp["post_mlp_norm"], cfg.norm_eps,
                      cfg.norm_one_offset)
    return x + y


def _block(x, attn, lp, cfg):
    """The rest of a layer after attention (``attn`` [B, T, H, D]): the
    attention residual, then the MLP block's."""
    B, T = x.shape[:2]
    x = _attn_residual(x, attn.reshape(B, T, -1), lp, cfg)
    return _mlp_residual(x, lp, cfg)


def _layer_windows(cfg):
    """Per layer, the window its attention runs under: None where the layer
    attends globally, ``cfg.sliding_window`` where it is local (the JAX
    file's ``_attend_dispatch``, without its compiled branches)."""
    return [None if g else cfg.sliding_window for g in cfg.layer_windows()]


def _layer_globals(cfg):
    """Per layer, the is-global flag that the JAX forwards' layer scan hands
    the per-layer traits (``_attend_dispatch``'s ``layer_globals``):
    ``cfg.layer_windows()`` where the layers mix local and global, all False
    where the pattern is uniform."""
    wins = cfg.layer_windows()
    if wins.all() or not wins.any():
        return [False] * cfg.n_layers
    return [bool(g) for g in wins]


def _layer_plan(cfg):
    """(layer index, its window, its is-global flag) for every layer."""
    return list(zip(range(cfg.n_layers), _layer_windows(cfg),
                    _layer_globals(cfg)))


def _attention_options(cfg, lp, window):
    """The options of one layer's attention call."""
    return dict(sm_scale=cfg.sm_scale, sliding_window=window,
                window_kind=cfg.local_attention_kind,
                logit_softcap=cfg.attn_logit_softcap,
                sinks=lp["sinks"].float() if cfg.attn_sinks else None)


def _positions(start_pos, T, dev):
    """(start_pos int32 [B] on ``dev``, positions int64 [B, T], kv_len)."""
    start_pos = start_pos.to(device=dev, dtype=torch.int32)
    positions = start_pos[:, None] + torch.arange(
        T, device=dev, dtype=torch.int32)[None, :]
    return start_pos, positions.long(), start_pos + T


def _layer(x, lp, cfg, kc, vc, positions, start_pos, kv_len, window, g,
           use_kernel):
    """One decoder layer (window ``window``, is-global flag ``g``); writes
    this step's K/V into ``kc``/``vc`` ([B, H_kv, S, D] views of the pool)
    in place."""
    B = x.shape[0]
    q, k, v = _qkv_heads(_attn_input(x, lp, cfg), lp, cfg, positions, g)

    # scatter [B, T, H, D] into the head-major pool at each row's offset
    rows = torch.arange(B, device=x.device)[:, None]
    kc[rows, :, positions] = k.to(kc.dtype)
    vc[rows, :, positions] = v.to(vc.dtype)

    opts = _attention_options(cfg, lp, window)
    if use_kernel:
        attn = flash_attention(q, kc, vc, start_pos, kv_len,
                               kv_head_major=True, **opts)
    else:
        attn = mha_reference(q, kc.transpose(1, 2), vc.transpose(1, 2),
                             start_pos, kv_len, **opts)
    return _block(x, attn, lp, cfg)


def _layer_quantized(x, lp, cfg, sym, scale, positions, start_pos, kv_len,
                     window, g, use_kernel):
    """:func:`_layer` over one layer of the int8 pool (``sym``
    [2, B, H_kv, S, D], ``scale`` [2, B, S]): the new tokens are quantized
    and written first, and attention reads them back quantized like every
    older token."""
    B = x.shape[0]
    q, k, v = _qkv_heads(_attn_input(x, lp, cfg), lp, cfg, positions, g)

    rows = torch.arange(B, device=x.device)[:, None]
    for i, new in enumerate((k, v)):
        new_sym, new_scale = quantize_tokens(new, (2, 3))  # [B,T,H,D], [B,T]
        sym[i][rows, :, positions] = new_sym
        scale[i][rows, positions] = new_scale

    opts = _attention_options(cfg, lp, window)
    if use_kernel:
        attn = quantized_flash_attention(q, sym[0], sym[1], scale[0],
                                         scale[1], start_pos, kv_len,
                                         kv_head_major=True, **opts)
    else:
        attn = quantized_attention_reference(
            q, sym[0].transpose(1, 2), sym[1].transpose(1, 2), scale[0],
            scale[1], start_pos, kv_len, **opts)
    return _block(x, attn, lp, cfg)


@torch.no_grad()
def forward(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # int [B, T]
    start_pos: torch.Tensor,  # int [B] — write offset / #cached tokens
    kv_cache: torch.Tensor,  # [L, 2, B, H_kv, S, D] (head-major pool)
    *,
    use_kernel: bool = True,
    last_logit_only: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One forward step (prefill when T>1, decode when T==1).

    The tokens' KV is written **in place** into ``kv_cache`` at
    ``start_pos[b]`` (which may be a view, such as one slot of a serving
    pool) and the queries attend to everything up to ``start_pos[b] + T``.
    Cached-prefix reuse = writing retrieved chunks into the cache and
    calling this with only the suffix tokens. Returns (logits
    [B, T, vocab] fp32, kv_cache); with ``last_logit_only`` the lm_head runs
    on the final position only (logits [B, 1, vocab]). ``use_kernel=False``
    (the JAX function's ``use_pallas=False``) computes attention with the
    plain version on whatever device the cache lives on.
    """
    check_supported(cfg)
    T = tokens.shape[1]
    dev = kv_cache.device
    start_pos, positions, kv_len = _positions(start_pos, T, dev)
    x = _embed(params, cfg, tokens.to(dev))
    lps = params["layers"]
    for li, window, g in _layer_plan(cfg):
        lp = {name: w[li] for name, w in lps.items()}
        x = _layer(x, lp, cfg, kv_cache[li, 0], kv_cache[li, 1], positions,
                   start_pos, kv_len, window, g, use_kernel)
    if last_logit_only:
        x = x[:, -1:]
    return _lm_logits(x, params, cfg), kv_cache


@torch.no_grad()
def forward_quantized(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # int [B, T]
    start_pos: torch.Tensor,  # int [B]
    kv_cache: Dict[str, torch.Tensor],  # new_quantized_kv_cache()
    *,
    use_kernel: bool = True,
    last_logit_only: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`forward` over an int8 KV pool, dequantized inside attention.

    The new tokens' K/V are quantized per (layer, token) and written **in
    place** (symbols and scales) before the layer's attention, which reads
    the whole pool, the new tokens included, as int8. The pool's tensors may
    be views, such as one slot of a serving pool. Returns (logits fp32,
    kv_cache).
    """
    check_supported(cfg)
    T = tokens.shape[1]
    sym_pool, scale_pool = kv_cache["sym"], kv_cache["scale"]
    dev = sym_pool.device
    start_pos, positions, kv_len = _positions(start_pos, T, dev)
    x = _embed(params, cfg, tokens.to(dev))
    lps = params["layers"]
    for li, window, g in _layer_plan(cfg):
        lp = {name: w[li] for name, w in lps.items()}
        x = _layer_quantized(x, lp, cfg, sym_pool[li], scale_pool[li],
                             positions, start_pos, kv_len, window, g,
                             use_kernel)
    if last_logit_only:
        x = x[:, -1:]
    return _lm_logits(x, params, cfg), kv_cache
