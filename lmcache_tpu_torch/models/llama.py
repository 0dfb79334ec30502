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
- :func:`forward_train` is the differentiable step that training runs
  (``tools/train_quality_model.py``): no pool, the plain attention over the
  step's own K/V, each layer optionally recomputed in the backward pass;
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
dense and the paged forwards. ``LlamaConfig.from_hf`` and :func:`load_hf`
read a local HuggingFace checkpoint directory (``config.json`` and the
safetensors or ``pytorch_model.bin`` files) through
:mod:`lmcache_tpu_torch.models.hf_checkpoint`, without ``transformers``.
"""

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from lmcache_tpu_torch.models import experts, hf_checkpoint
from lmcache_tpu_torch.ops.attention import flash_attention, mha_reference
from lmcache_tpu_torch.ops.quantized_attention import (
    quantize_tokens, quantized_attention_reference, quantized_flash_attention)
from lmcache_tpu_torch.parallel.mesh import (Axis, axis, data_rows,
                                             kv_cache_sharding, local_shape,
                                             take_slice)
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

    @staticmethod
    def from_hf(model_name: str) -> "LlamaConfig":
        """Read the architecture from a local HuggingFace checkpoint
        directory's ``config.json`` (:mod:`hf_checkpoint`: the attributes
        ``AutoConfig`` would give, without ``transformers``). A multimodal
        wrapper (Gemma-3, Llama-4) nests the text stack's config; we serve
        the text stack."""
        hc = hf_checkpoint.text_config(hf_checkpoint.read_config(model_name))

        def _check_all_sparse(hc):
            n = (getattr(hc, "num_experts", None)
                 or getattr(hc, "num_local_experts", None))
            if n and (getattr(hc, "mlp_only_layers", None)
                      or getattr(hc, "decoder_sparse_step", 1) != 1):
                raise NotImplementedError(
                    "mixed dense/sparse MoE layouts (mlp_only_layers / "
                    "decoder_sparse_step != 1) are not supported; every "
                    "layer is modeled as sparse")
            return n
        model_type = getattr(hc, "model_type", "")
        head_dim = getattr(hc, "head_dim", None) or (
            hc.hidden_size // hc.num_attention_heads)
        # Llama-4 (iRoPE): chunked local attention, NoPE global layers,
        # post-rope L2 qk-norm, NoPE query temperature, sigmoid MoE with
        # a shared expert
        is_llama4 = model_type == "llama4_text"
        is_gpt_oss = model_type == "gpt_oss"
        layer_types = getattr(hc, "layer_types", None)
        chunked = bool(layer_types and "chunked_attention" in layer_types)
        window = getattr(hc, "sliding_window", None)
        if chunked:
            window = int(hc.attention_chunk_size)
        nope_global = False
        no_rope = getattr(hc, "no_rope_layers", None)
        if is_llama4 and no_rope is not None:
            # no_rope_layers[i] == 1 means the layer USES rope; rope-on
            # must coincide with chunked (non-global) layers for the single
            # is-global flag to drive both
            want = [t != "full_attention" for t in layer_types]
            if [bool(r) for r in no_rope] != want:
                raise NotImplementedError(
                    "no_rope_layers does not align with layer_types; "
                    "independent NoPE/global masks are not supported")
            nope_global = not all(no_rope)
        if is_llama4:
            step = getattr(hc, "interleave_moe_layer_step", 1)
            moe_layers = getattr(hc, "moe_layers", None)
            if step != 1 or (moe_layers is not None
                             and len(moe_layers) != hc.num_hidden_layers):
                raise NotImplementedError(
                    "mixed dense/MoE llama4 layouts "
                    "(interleave_moe_layer_step != 1) are not supported")
        rotary_dim = None
        factor = getattr(hc, "partial_rotary_factor", 1.0)
        if factor and factor != 1.0:
            rotary_dim = int(head_dim * factor)
        scaling = {}
        rs = getattr(hc, "rope_scaling", None)
        if rs:
            kind = rs.get("rope_type") or rs.get("type")
            if kind == "default":
                pass
            elif kind in ("linear", "llama3", "yarn"):
                scaling = dict(
                    rope_scaling_type=kind,
                    rope_scaling_factor=float(rs.get("factor", 1.0)),
                    rope_low_freq_factor=float(
                        rs.get("low_freq_factor", 1.0)),
                    rope_high_freq_factor=float(
                        rs.get("high_freq_factor", 4.0)),
                    rope_beta_fast=float(rs.get("beta_fast", 32.0)),
                    rope_beta_slow=float(rs.get("beta_slow", 1.0)),
                    rope_attention_factor=rs.get("attention_factor"),
                    rope_original_max_seq=rs.get(
                        "original_max_position_embeddings",
                        hc.max_position_embeddings),
                )
            elif kind == "longrope":
                # Phi-3 keeps original_max_position_embeddings at the top
                # level and derives factor from the context ratio; the
                # factor set is chosen once per deployment (long when the
                # target context exceeds the pretraining context)
                orig = int(
                    getattr(hc, "original_max_position_embeddings", None)
                    or rs.get("original_max_position_embeddings")
                    or hc.max_position_embeddings)
                factor = hc.max_position_embeddings / orig
                ext = (rs["long_factor"] if hc.max_position_embeddings
                       > orig else rs["short_factor"])
                scaling = dict(
                    rope_scaling_type="longrope",
                    rope_scaling_factor=float(factor),
                    rope_attention_factor=rs.get("attention_factor"),
                    rope_original_max_seq=orig,
                    rope_freq_factors=tuple(float(f) for f in ext),
                )
            else:
                # silent mispositioning corrupts every cached chunk: fail
                # loudly on schemes we don't implement
                raise NotImplementedError(
                    f"rope_scaling type {kind!r} is not supported")
        return LlamaConfig(
            **scaling,
            vocab_size=hc.vocab_size,
            dim=hc.hidden_size,
            n_layers=hc.num_hidden_layers,
            n_heads=hc.num_attention_heads,
            n_kv_heads=getattr(hc, "num_key_value_heads",
                               hc.num_attention_heads),
            # llama4: the routed experts AND the shared expert are
            # intermediate_size wide (intermediate_size_mlp is only for
            # the dense layers refused above)
            hidden_dim=hc.intermediate_size,
            norm_eps=hc.rms_norm_eps,
            rope_theta=getattr(hc, "rope_theta", 10000.0),
            max_seq_len=hc.max_position_embeddings,
            attention_bias=bool(
                getattr(hc, "attention_bias", False)
                or model_type == "qwen2"),
            sliding_window=window,
            local_attention_kind="chunked" if chunked else "sliding",
            nope_on_global_layers=nope_global,
            qk_l2_norm=bool(is_llama4 and getattr(hc, "use_qk_norm",
                                                  False)),
            attn_temperature_tuning=bool(
                getattr(hc, "attn_temperature_tuning", False)),
            attn_floor_scale=float(getattr(hc, "floor_scale", 8192.0)),
            attn_scale=float(getattr(hc, "attn_scale", 0.1)),
            moe_style=("llama4" if is_llama4 else
                       "gpt_oss" if is_gpt_oss else "softmax_topk"),
            moe_act_limit=float(getattr(hc, "swiglu_limit", 7.0)),
            attn_sinks=is_gpt_oss,
            attention_out_bias=bool(
                is_gpt_oss and getattr(hc, "attention_bias", False)),
            rotary_dim=rotary_dim,
            # the glm/glm4 and llama4 families pair adjacent channels
            rope_interleaved=model_type in ("glm", "glm4",
                                            "llama4_text"),
            post_norms=model_type in ("glm4", "gemma2", "gemma3_text",
                                      "olmo2"),
            pre_norms=model_type != "olmo2",
            qk_norm=model_type in ("qwen3", "qwen3_moe", "gemma3_text"),
            qk_norm_flat=model_type == "olmo2",
            head_dim_override=(
                head_dim if head_dim != hc.hidden_size
                // hc.num_attention_heads else None),
            # every MoE layer is modeled as sparse (mixed layouts refused
            # above); qwen3_moe: num_experts, mixtral: num_local_experts
            n_experts=_check_all_sparse(hc),
            n_experts_per_tok=getattr(hc, "num_experts_per_tok", 2),
            moe_hidden_dim=(hc.intermediate_size
                            if (is_llama4 or is_gpt_oss) else
                            getattr(hc, "moe_intermediate_size", None)),
            norm_topk_prob=bool(getattr(hc, "norm_topk_prob", True)),
            # Gemma family: GeGLU, (1+w) norms, scaled embeddings; gemma2
            # adds sandwich norms, alternating local/global attention,
            # softcaps and query_pre_attn_scalar; gemma3 drops the softcaps
            # and adds qk-norm, layer_types and dual-theta rotary
            mlp_act=("gelu_tanh"
                     if model_type in ("gemma", "gemma2", "gemma3_text")
                     else "silu"),
            norm_one_offset=model_type in ("gemma", "gemma2",
                                           "gemma3_text"),
            embed_scale=model_type in ("gemma", "gemma2", "gemma3_text"),
            attn_logit_softcap=getattr(hc, "attn_logit_softcapping", None),
            final_logit_softcap=getattr(hc, "final_logit_softcapping",
                                        None),
            query_pre_attn_scalar=getattr(hc, "query_pre_attn_scalar",
                                          None),
            sliding_window_pattern=(2 if model_type == "gemma2" else
                                    getattr(hc, "sliding_window_pattern",
                                            None)),
            global_layer_map=(tuple(t == "full_attention"
                                    for t in hc.layer_types)
                              if getattr(hc, "layer_types", None)
                              else None),
            rope_local_theta=getattr(hc, "rope_local_base_freq", None),
        )



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


def load_hf(model_name: str, cfg: Optional[LlamaConfig] = None,
            device="cuda") -> Tuple[LlamaConfig, Params]:
    """Convert a local HuggingFace llama-family checkpoint directory into
    the stacked parameters of ``cfg`` (default ``LlamaConfig.from_hf``) on
    ``device``: the JAX ``load_hf``'s mapping, read from the files without
    ``transformers`` (:class:`hf_checkpoint.Loader`). Each tensor goes to
    fp32, then to ``cfg.dtype``, and is stacked per layer on the device one
    tensor at a time. Returns ``(cfg, params)``."""
    if cfg is None:
        cfg = LlamaConfig.from_hf(model_name)
    check_supported(cfg)
    ld = hf_checkpoint.Loader(model_name, resolve_device(device),
                              torch_dtype(cfg))
    idx = range(cfg.n_layers)

    def stack(fmt):  # torch Linear [out, in] -> x @ W
        return ld.stack(lambda i: ld.t(fmt.format(i)), idx)

    def stack_vec(fmt):
        return ld.stack(lambda i: ld.fp32(fmt.format(i)), idx)

    def split(fmt, *parts, read=ld.t):  # a fused tensor, read once a layer
        return ld.split(lambda i: read(fmt.format(i)), idx, parts)

    if "model.layers.0.self_attn.qkv_proj.weight" in ld:
        # Phi-3 fuses [q; k; v] into one projection: split the output
        # columns as HF Phi3Attention slices qkv
        nq = cfg.n_heads * cfg.head_dim
        nkv = cfg.n_kv_heads * cfg.head_dim
        fused = "model.layers.{}.self_attn.qkv_proj.weight"
        wq, wk, wv = split(fused, lambda f: f[:, :nq],
                           lambda f: f[:, nq:nq + nkv],
                           lambda f: f[:, nq + nkv:])
    else:
        wq = stack("model.layers.{}.self_attn.q_proj.weight")
        wk = stack("model.layers.{}.self_attn.k_proj.weight")
        wv = stack("model.layers.{}.self_attn.v_proj.weight")
    layers = {
        "wq": wq,
        "wk": wk,
        "wv": wv,
        "wo": stack("model.layers.{}.self_attn.o_proj.weight"),
    }
    if cfg.pre_norms:
        layers["attn_norm"] = stack_vec(
            "model.layers.{}.input_layernorm.weight")
        layers["mlp_norm"] = stack_vec(
            "model.layers.{}.post_attention_layernorm.weight")
    if (cfg.n_experts and
            "model.layers.0.feed_forward.experts.gate_up_proj" in ld):
        # Llama-4: fused 3-D experts already in x @ W orientation
        # ([E, dim, 2*mh] gate_up, [E, mh, dim] down), plus the always-on
        # shared expert and a router Linear
        mh = cfg.moe_hidden_dim
        gu = "model.layers.{}.feed_forward.experts.gate_up_proj"
        layers["router"] = stack(
            "model.layers.{}.feed_forward.router.weight")
        layers["e_gate"], layers["e_up"] = split(
            gu, lambda x: x[..., :mh], lambda x: x[..., mh:], read=ld.fp32)
        layers["e_down"] = stack_vec(
            "model.layers.{}.feed_forward.experts.down_proj")
        for key, hf in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                        ("w_down", "down_proj")):
            layers[key] = stack(
                "model.layers.{}.feed_forward.shared_expert."
                + hf + ".weight")
    elif (cfg.n_experts and
          "model.layers.0.mlp.experts.gate_up_proj" in ld):
        # GPT-OSS: fused 3-D experts in x @ W orientation with INTERLEAVED
        # gate/up columns (gate = [..., ::2]) and biases, plus a biased
        # router Linear
        gu = "model.layers.{}.mlp.experts.gate_up_proj"
        layers["router"] = stack("model.layers.{}.mlp.router.weight")
        layers["router_b"] = stack_vec("model.layers.{}.mlp.router.bias")
        gate, up = (lambda x: x[..., 0::2]), (lambda x: x[..., 1::2])
        layers["e_gate"], layers["e_up"] = split(gu, gate, up, read=ld.fp32)
        layers["e_bg"], layers["e_bu"] = split(gu + "_bias", gate, up,
                                               read=ld.fp32)
        layers["e_down"] = stack_vec(
            "model.layers.{}.mlp.experts.down_proj")
        layers["e_bd"] = stack_vec(
            "model.layers.{}.mlp.experts.down_proj_bias")
    elif cfg.n_experts:
        # Qwen3-MoE: mlp.gate (router) + mlp.experts.{e}.{gate,up,down}_proj;
        # Mixtral: block_sparse_moe.gate + experts.{e}.{w1,w3,w2}
        if "model.layers.0.block_sparse_moe.gate.weight" in ld:
            router = "model.layers.{}.block_sparse_moe.gate.weight"
            names = ("w1", "w3", "w2")  # gate, up, down
            expert = "model.layers.{}.block_sparse_moe.experts.{}.{}.weight"
        else:
            router = "model.layers.{}.mlp.gate.weight"
            names = ("gate_proj", "up_proj", "down_proj")
            expert = "model.layers.{}.mlp.experts.{}.{}.weight"
        layers["router"] = stack(router)
        for key, hf in zip(("e_gate", "e_up", "e_down"), names):
            layers[key] = ld.stack2(
                lambda i, e, hf=hf: ld.t(expert.format(i, e, hf)), idx,
                cfg.n_experts)
    elif "model.layers.0.mlp.gate_up_proj.weight" in ld:
        # the GLM family fuses [gate; up] into one projection: split it
        fused = "model.layers.{}.mlp.gate_up_proj.weight"
        layers["w_gate"], layers["w_up"] = split(
            fused, lambda f: f[:, :cfg.hidden_dim],
            lambda f: f[:, cfg.hidden_dim:])
        layers["w_down"] = stack("model.layers.{}.mlp.down_proj.weight")
    else:
        layers["w_gate"] = stack("model.layers.{}.mlp.gate_proj.weight")
        layers["w_up"] = stack("model.layers.{}.mlp.up_proj.weight")
        layers["w_down"] = stack("model.layers.{}.mlp.down_proj.weight")
    if cfg.attention_bias:
        layers["bq"] = stack_vec("model.layers.{}.self_attn.q_proj.bias")
        layers["bk"] = stack_vec("model.layers.{}.self_attn.k_proj.bias")
        layers["bv"] = stack_vec("model.layers.{}.self_attn.v_proj.bias")
    if cfg.attention_out_bias:
        layers["bo"] = stack_vec("model.layers.{}.self_attn.o_proj.bias")
    if cfg.post_norms and not cfg.pre_norms:
        # OLMo-2: the ONLY norms are on the block outputs
        layers["post_attn_norm"] = stack_vec(
            "model.layers.{}.post_attention_layernorm.weight")
        layers["post_mlp_norm"] = stack_vec(
            "model.layers.{}.post_feedforward_layernorm.weight")
    elif cfg.post_norms:
        if "model.layers.0.pre_feedforward_layernorm.weight" in ld:
            # Gemma-2 sandwich naming: the pre-MLP norm is
            # pre_feedforward_layernorm and post_attention_layernorm is the
            # attention OUTPUT norm (not the pre-MLP norm as in llama)
            layers["mlp_norm"] = stack_vec(
                "model.layers.{}.pre_feedforward_layernorm.weight")
            layers["post_attn_norm"] = stack_vec(
                "model.layers.{}.post_attention_layernorm.weight")
            layers["post_mlp_norm"] = stack_vec(
                "model.layers.{}.post_feedforward_layernorm.weight")
        else:
            layers["post_attn_norm"] = stack_vec(
                "model.layers.{}.post_self_attn_layernorm.weight")
            layers["post_mlp_norm"] = stack_vec(
                "model.layers.{}.post_mlp_layernorm.weight")
    if cfg.qk_norm or cfg.qk_norm_flat:
        layers["q_norm"] = stack_vec("model.layers.{}.self_attn.q_norm.weight")
        layers["k_norm"] = stack_vec("model.layers.{}.self_attn.k_norm.weight")
    if cfg.attn_sinks:
        layers["sinks"] = stack_vec("model.layers.{}.self_attn.sinks")
    params = {
        "embed": ld.one(ld.fp32("model.embed_tokens.weight")),
        "layers": layers,
        "final_norm": ld.one(ld.fp32("model.norm.weight")),
        "lm_head": ld.lm_head(),
    }
    ld.close()
    return cfg, params


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


def kv_cache_shape(cfg: LlamaConfig, batch: int, max_len: int,
                   mesh=None) -> Tuple[int, ...]:
    """The shape of this rank's block of the head-major pool [L, 2, B, H_kv,
    S, D] on ``mesh`` (``parallel.kv_cache_sharding``): its share of the
    batch rows on "data" and of the kv heads on "model", each whole where
    it does not divide its axis (:func:`_gathers`)."""
    return local_shape((cfg.n_layers, 2, batch, cfg.n_kv_heads, max_len,
                        cfg.head_dim), kv_cache_sharding(), mesh)


def kv_heads(cfg: LlamaConfig, mesh=None) -> int:
    """The kv heads of this rank's block of a pool or an arena on
    ``mesh``."""
    return kv_cache_shape(cfg, 1, 1, mesh)[3]


def new_kv_cache(cfg: LlamaConfig, batch: int, max_len: int,
                 device="cuda", mesh=None) -> torch.Tensor:
    """Fresh KV cache [L, 2, B, H_kv, S, D] — HEAD-major, zeroed.

    The live pool is head-major so the attention kernel reads it directly;
    the cache-blob wire format stays token-major ([L, 2, T, H, D], the
    reference's vllm fmt) and is transposed once per chunk at the
    inject/read boundary, not per step. On ``mesh``, this rank's block
    (:func:`kv_cache_shape`).
    """
    return torch.zeros(kv_cache_shape(cfg, batch, max_len, mesh),
                       dtype=torch_dtype(cfg), device=resolve_device(device))


def new_quantized_kv_cache(cfg: LlamaConfig, batch: int, max_len: int,
                           device="cuda",
                           mesh=None) -> Dict[str, torch.Tensor]:
    """Int8 KV pool: {"sym" [L, 2, B, H_kv, S, D] int8, zeroed, "scale"
    [L, 2, B, S] fp32, initialised to 1}. Half the bytes of the
    :func:`new_kv_cache` pool; read by the kernel that dequantizes inside
    attention (``ops/quantized_attention.py``). One symmetric scale per
    (layer, token), the CacheGen quantization granularity; head-major
    symbols for the same reason as :func:`new_kv_cache`. ``mesh`` as
    there (the scales are head-free)."""
    dev = resolve_device(device)
    shape = kv_cache_shape(cfg, batch, max_len, mesh)
    return {
        "sym": torch.zeros(shape, dtype=torch.int8, device=dev),
        "scale": torch.ones(shape[:3] + shape[4:5], dtype=torch.float32,
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
                              pos: int = 0, reduce_absmax=None
                              ) -> Dict[str, torch.Tensor]:
    """Quantize a wire blob [L, 2, t, H, D] per (layer, K/V, token) over its
    (H, D) axes, as the model quantizes what it writes, and write symbols
    and scales into the int8 pool at token offset ``pos`` of batch row
    ``b``, in place; returns ``cache``. ``reduce_absmax`` as in
    ``quantize_tokens`` where the blob is a head slice (:func:`head_absmax`).
    """
    t = blob.shape[2]
    sym, scale = quantize_tokens(blob.to(cache["sym"].device), (3, 4),
                                 reduce_absmax)
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


_ONE = Axis()  # the one-rank "model" axis of a forward without a mesh


def _gathers(cfg, tp: Axis) -> bool:
    """Whether this layer's heads are gathered over the mesh's "model" axis:
    where its kv heads do not divide the axis (the JAX package then falls
    back to its unwrapped kernel, which gathers the pool), every rank holds
    every head, attends over the whole pool and applies its rows of ``wo``
    to its columns of the output."""
    return tp.size > 1 and cfg.n_kv_heads % tp.size != 0


def _rms_norm_columns(x, weight, eps, one_offset, tp: Axis):
    """:func:`_rms_norm` of a vector whose columns are split over ``tp``
    (OLMo-2's full-width q/k norms on a head slice): the sum of squares
    summed over the axis, this rank's columns of ``weight``."""
    x32 = x.float()
    width = x.shape[-1] * tp.size
    ss = tp.sum(torch.sum(x32 * x32, dim=-1, keepdim=True))
    rms = torch.rsqrt(ss / width + eps)
    w = take_slice(weight, -1, tp.index, tp.size, "qk_norm_flat")
    if one_offset:
        return (x32 * rms * (1.0 + w.float())).to(x.dtype)
    return (x32 * rms).to(x.dtype) * w


def _qkv_heads(h, lp, cfg, positions, g=None, tp: Axis = _ONE):
    """q [B, T, H, D], k and v [B, T, H_kv, D] of one layer from its
    attention input ``h`` (:func:`_attn_input`): the projections, OLMo-2's
    full-width q/k norms before the head reshape, Qwen3's and Gemma-3's
    per-head q/k norms before RoPE, RoPE at the layer's frequencies
    (:func:`_layer_rope_freqs`), then Llama-4's L2 q/k norm on rope layers
    and its query temperature on NoPE layers. ``g`` is the layer's is-global
    flag, which the per-layer traits need. With the parameters of
    ``parallel.shard_params`` on a "model" axis ``tp``, this rank's heads
    (H / tp and H_kv / tp), or every head where :func:`_gathers`."""
    B, T = h.shape[:2]
    hd = cfg.head_dim
    q, k, v = _qkv(h, lp, cfg)
    if _gathers(cfg, tp):
        q, k, v = (tp.gather(t, -1) for t in (q, k, v))
    if cfg.qk_norm_flat:
        if tp.size > 1 and not _gathers(cfg, tp):
            q = _rms_norm_columns(q, lp["q_norm"], cfg.norm_eps,
                                  cfg.norm_one_offset, tp)
            k = _rms_norm_columns(k, lp["k_norm"], cfg.norm_eps,
                                  cfg.norm_one_offset, tp)
        else:
            q = _rms_norm(q, lp["q_norm"], cfg.norm_eps, cfg.norm_one_offset)
            k = _rms_norm(k, lp["k_norm"], cfg.norm_eps, cfg.norm_one_offset)
    q = q.reshape(B, T, -1, hd)
    k = k.reshape(B, T, -1, hd)
    v = v.reshape(B, T, -1, hd)
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


def _attn_residual(x, attn_flat, lp, cfg, tp: Axis = _ONE):
    """Residual add of the attention block's output (``attn_flat``
    [B, T, H*D]): the output projection (GPT-OSS: with its bias), then the
    sandwich norm on it where the family has one (Gemma-2/3, GLM-4-0414,
    OLMo-2). On a "model" axis ``tp`` the projection is row-parallel: this
    rank's heads times its rows of ``wo``, summed over the axis, the bias
    added once after."""
    if _gathers(cfg, tp):
        attn_flat = take_slice(attn_flat, -1, tp.index, tp.size, "wo")
    y = tp.sum(attn_flat.to(x.dtype) @ lp["wo"])
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


def _moe_mlp(h, lp, cfg, tp: Axis = _ONE):
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
    experts is fp32, cast to ``h``'s dtype once. On a "model" axis ``tp``
    the experts are column- then row-parallel (each rank its columns of the
    expert width), their outputs summed over the axis."""
    shape = h.shape
    hf = h.reshape(-1, shape[-1])
    ids, wts = _route(hf, lp, cfg)
    row_bytes = 4 * cfg.dim + 14 * lp["e_gate"].shape[-1]
    step = max(experts.EXPERT_ROWS,
               MOE_DISPATCH_BYTES // (cfg.n_experts * row_bytes))
    out = [_expert_slice(hf[i:i + step], ids[i:i + step], wts[i:i + step],
                         lp, cfg, tp.index == 0)
           for i in range(0, hf.shape[0], step)]
    return tp.sum(torch.cat(out).reshape(shape))


def _expert_slice(hf, ids, wts, lp, cfg, add_down_bias=True):
    """:func:`_moe_mlp` of tokens ``hf [n, dim]`` routed to ``ids`` with
    weights ``wts``: [n, dim] in ``hf``'s dtype (a rank's part of it on a
    "model" axis, where one rank adds GPT-OSS's down-projection bias)."""
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
        y = torch.bmm(act.to(dt), lp["e_down"]).float()
        if add_down_bias:
            y = y + lp["e_bd"][:, None].float()
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


def _mlp_residual(x, lp, cfg, tp: Axis = _ONE):
    """The MLP block and its residual: pre-normed input (raw for OLMo-2),
    the gated dense MLP or the MoE MLP (``cfg.n_experts``), and the sandwich
    norm on its output where the family has one. On a "model" axis ``tp``
    the MLP is column- then row-parallel, one sum over the axis."""
    h = (_rms_norm(x, lp["mlp_norm"], cfg.norm_eps, cfg.norm_one_offset)
         if cfg.pre_norms else x)
    if cfg.n_experts:
        y = _moe_mlp(h, lp, cfg, tp)
    else:
        gate = _act((h @ lp["w_gate"]).float(), cfg.mlp_act)
        up = (h @ lp["w_up"]).float()
        y = tp.sum((gate * up).to(x.dtype) @ lp["w_down"])
    if cfg.post_norms:
        y = _rms_norm(y, lp["post_mlp_norm"], cfg.norm_eps,
                      cfg.norm_one_offset)
    return x + y


def _block(x, attn, lp, cfg, tp: Axis = _ONE):
    """The rest of a layer after attention (``attn`` [B, T, H, D]): the
    attention residual, then the MLP block's."""
    B, T = x.shape[:2]
    x = _attn_residual(x, attn.reshape(B, T, -1), lp, cfg, tp)
    return _mlp_residual(x, lp, cfg, tp)


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


def _attention_options(cfg, lp, window, tp: Axis = _ONE):
    """The options of one layer's attention call (on a "model" axis, the
    sinks of this rank's heads, or of every head where they are
    gathered)."""
    sinks = None
    if cfg.attn_sinks:
        sinks = lp["sinks"].float()
        if _gathers(cfg, tp):
            sinks = tp.gather(sinks, -1)
    return dict(sm_scale=cfg.sm_scale, sliding_window=window,
                window_kind=cfg.local_attention_kind,
                logit_softcap=cfg.attn_logit_softcap, sinks=sinks)


def _positions(start_pos, T, dev):
    """(start_pos int32 [B] on ``dev``, positions int64 [B, T], kv_len)."""
    start_pos = start_pos.to(device=dev, dtype=torch.int32)
    positions = start_pos[:, None] + torch.arange(
        T, device=dev, dtype=torch.int32)[None, :]
    return start_pos, positions.long(), start_pos + T


def _layer(x, lp, cfg, kc, vc, positions, start_pos, kv_len, window, g,
           use_kernel, tp: Axis = _ONE):
    """One decoder layer (window ``window``, is-global flag ``g``); writes
    this step's K/V into ``kc``/``vc`` ([B, H_kv, S, D] views of the pool,
    this rank's heads on a "model" axis ``tp``) in place. Without a pool
    (``kc`` None: a training step of :func:`forward_train`, every row from
    position 0) the queries attend over the step's own K/V with the plain
    attention, which autograd differentiates."""
    B = x.shape[0]
    q, k, v = _qkv_heads(_attn_input(x, lp, cfg), lp, cfg, positions, g, tp)
    opts = _attention_options(cfg, lp, window, tp)
    if kc is None:
        attn = mha_reference(q, k, v, start_pos, kv_len, **opts)
        return _block(x, attn, lp, cfg)

    # scatter [B, T, H, D] into the head-major pool at each row's offset
    rows = torch.arange(B, device=x.device)[:, None]
    kc[rows, :, positions] = k.to(kc.dtype)
    vc[rows, :, positions] = v.to(vc.dtype)

    if use_kernel:
        attn = flash_attention(q, kc, vc, start_pos, kv_len,
                               kv_head_major=True, **opts)
    else:
        attn = mha_reference(q, kc.transpose(1, 2), vc.transpose(1, 2),
                             start_pos, kv_len, **opts)
    return _block(x, attn, lp, cfg, tp)


def head_absmax(cfg, tp: Axis):
    """The ``reduce_absmax`` of ``quantize_tokens`` for this rank's K/V: the
    absmax of a token over every rank's heads where they are split (one
    scale a token, head-free, as in the JAX package), None otherwise."""
    return tp.max if tp.size > 1 and not _gathers(cfg, tp) else None


def _layer_quantized(x, lp, cfg, sym, scale, positions, start_pos, kv_len,
                     window, g, use_kernel, tp: Axis = _ONE):
    """:func:`_layer` over one layer of the int8 pool (``sym``
    [2, B, H_kv, S, D], ``scale`` [2, B, S]): the new tokens are quantized
    and written first, and attention reads them back quantized like every
    older token."""
    B = x.shape[0]
    q, k, v = _qkv_heads(_attn_input(x, lp, cfg), lp, cfg, positions, g, tp)

    rows = torch.arange(B, device=x.device)[:, None]
    for i, new in enumerate((k, v)):
        # [B, T, H, D], [B, T]
        new_sym, new_scale = quantize_tokens(new, (2, 3),
                                             head_absmax(cfg, tp))
        sym[i][rows, :, positions] = new_sym
        scale[i][rows, positions] = new_scale

    opts = _attention_options(cfg, lp, window, tp)
    if use_kernel:
        attn = quantized_flash_attention(q, sym[0], sym[1], scale[0],
                                         scale[1], start_pos, kv_len,
                                         kv_head_major=True, **opts)
    else:
        attn = quantized_attention_reference(
            q, sym[0].transpose(1, 2), sym[1].transpose(1, 2), scale[0],
            scale[1], start_pos, kv_len, **opts)
    return _block(x, attn, lp, cfg, tp)


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
    mesh=None,
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

    With ``mesh`` (``parallel.make_mesh``), ``params`` are this rank's
    (``parallel.shard_params``) and ``kv_cache`` its block of the pool
    (``parallel.kv_cache_sharding``): its kv heads on "model" (every head
    where they do not divide it), and its share of the batch rows on "data"
    where ``tokens``' B divides it, else every row. ``tokens`` and
    ``start_pos`` are the whole step's on every rank; each rank attends over
    its heads with the unchanged kernel, the output projection and the MLP
    are summed over "model", and the logits of the rows split over "data"
    are gathered, so every rank returns the whole step's logits.
    """
    check_supported(cfg)
    T = tokens.shape[1]
    dev = kv_cache.device
    rows = data_rows(tokens.shape[0], kv_cache.shape[2], mesh)
    tokens, start_pos = _rows(tokens, start_pos, rows)
    tp = axis(mesh, "model")
    start_pos, positions, kv_len = _positions(start_pos, T, dev)
    x = _embed(params, cfg, tokens.to(dev))
    lps = params["layers"]
    for li, window, g in _layer_plan(cfg):
        lp = {name: w[li] for name, w in lps.items()}
        x = _layer(x, lp, cfg, kv_cache[li, 0], kv_cache[li, 1], positions,
                   start_pos, kv_len, window, g, use_kernel, tp)
    if last_logit_only:
        x = x[:, -1:]
    return _gather_rows(_lm_logits(x, params, cfg), rows, mesh), kv_cache


def _rows(tokens, start_pos, rows):
    """The rows of the step that this rank computes (all where None)."""
    if rows is None:
        return tokens, start_pos
    return tokens[rows], start_pos[rows]


def _gather_rows(logits, rows, mesh):
    """Every row's logits on every rank where "data" split the rows."""
    if rows is None:
        return logits
    return axis(mesh, "data").gather(logits, 0)


def forward_train(params: Params, cfg: LlamaConfig, tokens: torch.Tensor,
                  *, remat: bool = True) -> torch.Tensor:
    """The differentiable forward that training runs, the JAX file's
    ``forward(..., use_pallas=False, remat=remat)`` over a fresh pool: every
    row starts at position 0, so each layer attends over the step's own K/V
    (:func:`_layer` without a pool) and no pool is written. With ``remat``
    each layer runs under ``torch.utils.checkpoint`` and is recomputed in
    the backward pass, so that one layer's ``[B, H, T, T]`` fp32 scores are
    live at a time, not every layer's (``jax.checkpoint`` in the JAX file).
    ``tokens`` int [B, T] on the parameters' device; returns logits
    [B, T, vocab] fp32."""
    check_supported(cfg)
    B, T = tokens.shape
    dev = params["embed"].device
    start_pos, positions, kv_len = _positions(
        torch.zeros(B, dtype=torch.int32, device=dev), T, dev)
    x = _embed(params, cfg, tokens.to(dev))
    lps = params["layers"]
    for li, window, g in _layer_plan(cfg):
        lp = {name: w[li] for name, w in lps.items()}
        args = (x, lp, cfg, None, None, positions, start_pos, kv_len, window,
                g, False)
        x = (torch.utils.checkpoint.checkpoint(_layer, *args,
                                               use_reentrant=False)
             if remat else _layer(*args))
    return _lm_logits(x, params, cfg)


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
    mesh=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`forward` over an int8 KV pool, dequantized inside attention.

    The new tokens' K/V are quantized per (layer, token) and written **in
    place** (symbols and scales) before the layer's attention, which reads
    the whole pool, the new tokens included, as int8. The pool's tensors may
    be views, such as one slot of a serving pool. Returns (logits fp32,
    kv_cache). ``mesh`` as in :func:`forward`: the symbols hold this rank's
    heads, the scales are head-free (a token's absmax is taken over every
    rank's heads), both hold this rank's rows.
    """
    check_supported(cfg)
    T = tokens.shape[1]
    sym_pool, scale_pool = kv_cache["sym"], kv_cache["scale"]
    dev = sym_pool.device
    rows = data_rows(tokens.shape[0], sym_pool.shape[2], mesh)
    tokens, start_pos = _rows(tokens, start_pos, rows)
    tp = axis(mesh, "model")
    start_pos, positions, kv_len = _positions(start_pos, T, dev)
    x = _embed(params, cfg, tokens.to(dev))
    lps = params["layers"]
    for li, window, g in _layer_plan(cfg):
        lp = {name: w[li] for name, w in lps.items()}
        x = _layer_quantized(x, lp, cfg, sym_pool[li], scale_pool[li],
                             positions, start_pos, kv_len, window, g,
                             use_kernel, tp)
    if last_logit_only:
        x = x[:, -1:]
    return _gather_rows(_lm_logits(x, params, cfg), rows, mesh), kv_cache


@torch.no_grad()
def forward_ring(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # int [B, T], the whole prompt on every rank
    mesh,
    *,
    seq_axis: str = "data",
    head_axis: Optional[str] = "model",
    last_logit_only: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Context-parallel FULL prefill (sequence parallelism), the JAX file's
    ``forward_ring``: the token axis is split over ``mesh``'s ``seq_axis``,
    each rank embedding, projecting and running the MLP on its contiguous
    block of ``T / p`` tokens, and attention runs as ring attention
    (:func:`lmcache_tpu_torch.parallel.ring_attention.ring_body`), the KV
    blocks passed around the ring, so that no rank holds more than two
    blocks of KV. It composes with tensor parallelism on ``head_axis``
    (``params`` of ``parallel.shard_params``). Every family trait rides the
    ring: windows (blocks outside a layer's window skip their compute),
    per-layer rope and query traits by the layer's is-global flag, qk
    norms, softcaps, sinks and MoE.

    Returns this rank's ``(logits [B, T / p, vocab] fp32, kv_cache [L, 2, B,
    H_kv', T / p, D])``: its block of the logits and of the head-major
    cache, whose chunks it can store per shard. With ``last_logit_only`` the
    logits of the prompt's last token [B, 1, vocab] on every rank. ``T``
    must divide the ``seq_axis`` size."""
    from lmcache_tpu_torch.parallel.ring_attention import ring_body
    check_supported(cfg)
    B, T = tokens.shape
    seq = axis(mesh, seq_axis)
    tp = axis(mesh, head_axis) if head_axis else _ONE
    if T % seq.size:
        raise ValueError(f"T ({T}) must divide the {seq_axis!r} axis size "
                         f"({seq.size})")
    Tl = T // seq.size
    dev = params["embed"].device
    local = tokens[:, seq.index * Tl:(seq.index + 1) * Tl].to(dev)
    positions = (seq.index * Tl + torch.arange(Tl, device=dev))[None].expand(
        B, Tl)
    q_off = torch.zeros(B, dtype=torch.int32, device=dev)
    kv_len = torch.full((B,), T, dtype=torch.int32, device=dev)
    globals_ = cfg.layer_windows()
    x = _embed(params, cfg, local)
    blocks = []
    lps = params["layers"]
    for li in range(cfg.n_layers):
        g = bool(globals_[li])
        lp = {name: w[li] for name, w in lps.items()}
        q, k, v = _qkv_heads(_attn_input(x, lp, cfg), lp, cfg, positions, g,
                             tp)
        opts = _attention_options(cfg, lp, cfg.sliding_window, tp)
        attn = ring_body(q, k, v, q_off, kv_len, seq,
                         scale=(opts["sm_scale"] if opts["sm_scale"]
                                is not None else 1.0 / cfg.head_dim**0.5),
                         logit_softcap=opts["logit_softcap"],
                         sliding_window=cfg.sliding_window,
                         window_kind=cfg.local_attention_kind,
                         is_global=g, sinks=opts["sinks"])
        x = _block(x, attn, lp, cfg, tp)
        blocks.append(torch.stack((k.transpose(1, 2), v.transpose(1, 2))))
    if last_logit_only:
        logits = _lm_logits(x[:, -1:], params, cfg).contiguous()
        return seq.broadcast(logits, seq.size - 1), torch.stack(blocks)
    return _lm_logits(x, params, cfg), torch.stack(blocks)
