"""The port's HuggingFace loaders (``LlamaConfig.from_hf``/``load_hf``,
``MLAConfig.from_hf``/``load_hf``, ``models/hf_checkpoint.py``) against the
JAX package's, on the CPU.

One tiny model of each ``model_type`` the JAX ``from_hf`` maps is built with
``transformers`` from a fixed seed and saved with ``save_pretrained``; its
config must read as the JAX ``from_hf`` reads it, field for field; its
parameters, in fp32 and in bf16, must equal ``params_from_jax`` of the JAX
``load_hf`` bit for bit; and the port's forward must give the HF model's
logits within the JAX tests' 3e-3. The multimodal wrappers (``gemma3``,
``llama4``) nest the text stack's config and prefix its tensor names
(``language_model.``), which the JAX ``load_hf`` cannot read: their
parameters are held against the JAX ``load_hf`` of the text stack's own
checkpoint. Hand-written minimal ``config.json`` files hold the attributes
the loaders read to what ``AutoConfig`` gives."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
transformers = pytest.importorskip("transformers")

from lmcache_tpu.models import llama as jl  # noqa: E402
from lmcache_tpu.models import mla as jm  # noqa: E402
from lmcache_tpu_torch.models import hf_checkpoint  # noqa: E402
from lmcache_tpu_torch.models import llama as tl  # noqa: E402
from lmcache_tpu_torch.models import mla as tm  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 3e-3  # the JAX package's HF parity tolerance (fp32)

_ATTN = dict(attention_dropout=0.0, pad_token_id=0)
_SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=256,
              rms_norm_eps=1e-5, rope_theta=10000.0,
              tie_word_embeddings=False)
_MOE_E = 4
_MLA = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
            moe_intermediate_size=64, num_hidden_layers=3,
            num_attention_heads=4, num_key_value_heads=4,
            max_position_embeddings=256, rms_norm_eps=1e-6,
            kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=16,
            v_head_dim=32, first_k_dense_replace=1, n_routed_experts=8,
            num_experts_per_tok=2, tie_word_embeddings=False,
            attention_bias=False, **_ATTN)
_YARN = dict(rope_type="yarn", factor=4.0, beta_fast=32.0, beta_slow=1.0,
             mscale=1.0, mscale_all_dim=1.0,
             original_max_position_embeddings=64)

# name -> (config class, model class, config kwargs, how it is saved);
# geometries from tests/test_model.py and tests/test_mla.py
MODELS = {
    "llama": ("LlamaConfig", "LlamaForCausalLM", dict(_SMALL), {}),
    "llama-shards": ("LlamaConfig", "LlamaForCausalLM", dict(_SMALL),
                     {"max_shard_size": "40KB"}),
    "llama-bin": ("LlamaConfig", "LlamaForCausalLM", dict(_SMALL),
                  {"safe_serialization": False}),
    "mistral": ("MistralConfig", "MistralForCausalLM",
                dict(_SMALL, sliding_window=16, **_ATTN), {"bf16": True}),
    "qwen2": ("Qwen2Config", "Qwen2ForCausalLM",
              dict(_SMALL, **_ATTN), {"f16": True}),
    "qwen3": ("Qwen3Config", "Qwen3ForCausalLM",
              dict(_SMALL, hidden_size=128, intermediate_size=256,
                   head_dim=64, attention_bias=False, **_ATTN), {}),
    "qwen3_moe": ("Qwen3MoeConfig", "Qwen3MoeForCausalLM",
                  dict(_SMALL, hidden_size=128, intermediate_size=256,
                       head_dim=32, attention_bias=False,
                       num_experts=_MOE_E, num_experts_per_tok=2,
                       moe_intermediate_size=64, norm_topk_prob=True,
                       decoder_sparse_step=1, mlp_only_layers=[], **_ATTN),
                  {}),
    "mixtral": ("MixtralConfig", "MixtralForCausalLM",
                dict(_SMALL, hidden_size=128, intermediate_size=64,
                     num_local_experts=_MOE_E, num_experts_per_tok=2,
                     sliding_window=None, **_ATTN), {}),
    "gemma": ("GemmaConfig", "GemmaForCausalLM",
              dict(_SMALL, head_dim=16, rms_norm_eps=1e-6,
                   tie_word_embeddings=True, **_ATTN), {}),
    "gemma2": ("Gemma2Config", "Gemma2ForCausalLM",
               dict(_SMALL, num_hidden_layers=4, head_dim=16,
                    rms_norm_eps=1e-6, query_pre_attn_scalar=24.0,
                    sliding_window=16, attn_logit_softcapping=50.0,
                    final_logit_softcapping=30.0,
                    attn_implementation="eager", **_ATTN), {}),
    "gemma3": ("Gemma3TextConfig", "Gemma3ForCausalLM",
               dict(_SMALL, num_hidden_layers=6, head_dim=16,
                    rms_norm_eps=1e-6, rope_theta=1000000.0,
                    rope_local_base_freq=10000.0,
                    rope_scaling={"rope_type": "linear", "factor": 4.0},
                    query_pre_attn_scalar=24.0, sliding_window=8,
                    tie_word_embeddings=True, attn_implementation="eager",
                    **_ATTN), {"nest": "gemma3"}),
    "glm": ("GlmConfig", "GlmForCausalLM",
            dict(_SMALL, hidden_size=256, head_dim=64,
                 partial_rotary_factor=0.5, attention_bias=True, **_ATTN),
            {}),
    "glm4": ("Glm4Config", "Glm4ForCausalLM",
             dict(_SMALL, hidden_size=256, head_dim=64,
                  partial_rotary_factor=0.5, attention_bias=True, **_ATTN),
             {}),
    "olmo2": ("Olmo2Config", "Olmo2ForCausalLM", dict(_SMALL, **_ATTN), {}),
    "phi3": ("Phi3Config", "Phi3ForCausalLM",
             dict(_SMALL, max_position_embeddings=256,
                  original_max_position_embeddings=32,
                  rope_scaling={"type": "longrope", "short_factor": [1.0] * 8,
                                "long_factor": [1.5, 2.0, 2.5, 3.0, 4.0, 5.0,
                                                6.5, 8.0]},
                  sliding_window=None, resid_pdrop=0.0, embd_pdrop=0.0,
                  **_ATTN), {}),
    "llama4": ("Llama4TextConfig", "Llama4ForCausalLM",
               dict(_SMALL, num_hidden_layers=4, intermediate_size=32,
                    intermediate_size_mlp=64, head_dim=16, rope_scaling=None,
                    attention_chunk_size=8, num_local_experts=_MOE_E,
                    num_experts_per_tok=1, use_qk_norm=True,
                    attn_temperature_tuning=True, floor_scale=8.0,
                    attn_scale=0.1, attention_bias=False,
                    attn_implementation="eager", **_ATTN),
               {"nest": "llama4"}),
    "gpt_oss": ("GptOssConfig", "GptOssForCausalLM",
                dict(_SMALL, intermediate_size=32, num_hidden_layers=4,
                     head_dim=16, rope_scaling=None, sliding_window=8,
                     num_local_experts=_MOE_E, num_experts_per_tok=2,
                     attention_bias=True, attn_implementation="eager",
                     **_ATTN), {}),
    "deepseek_v2": ("DeepseekV2Config", "DeepseekV2ForCausalLM",
                    dict(_MLA, q_lora_rank=None, n_shared_experts=2,
                         topk_method="greedy", norm_topk_prob=False), {}),
    "deepseek_v3": ("DeepseekV3Config", "DeepseekV3ForCausalLM",
                    dict(_MLA, q_lora_rank=48, n_shared_experts=1,
                         n_group=4, topk_group=2, norm_topk_prob=True,
                         routed_scaling_factor=2.5, rope_scaling=_YARN,
                         rope_interleave=True), {}),
}
MLA = ("deepseek_v2", "deepseek_v3")


def _perturb(name, model):
    """Move the weights that HF initializes at identity or zero (norms,
    biases, sinks, the V3 correction bias) off it, so that a dropped or
    misplaced load cannot pass."""
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for key, p in model.named_parameters():
            if p.ndim == 1 or key.endswith("sinks"):
                p.add_(0.1 * torch.randn(p.shape, generator=g))
        for key, b in model.named_buffers():
            if key.endswith("e_score_correction_bias"):
                b.copy_(0.5 * torch.randn(b.shape, generator=g))


def _nest(text_dir, out_dir, wrapper):
    """A multimodal wrapper's checkpoint of a saved text stack: config.json
    nesting the text config under text_config, tensors renamed as such
    checkpoints store them (language_model.model.*)."""
    from safetensors.torch import load_file, save_file
    os.makedirs(out_dir)
    with open(os.path.join(text_dir, "config.json")) as f:
        text_cfg = json.load(f)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump({"model_type": wrapper, "text_config": text_cfg}, f)
    sd = load_file(os.path.join(text_dir, "model.safetensors"))
    save_file({"language_model." + k: v for k, v in sd.items()},
              os.path.join(out_dir, "model.safetensors"))


class Saved:
    """One tiny HF model: its checkpoint directory (``path``), the text
    stack's own (``jax_path``, what the JAX loader reads) and its logits on
    ``ids``."""

    def __init__(self, name, root):
        cfg_cls, model_cls, kw, how = MODELS[name]
        hf_cfg = getattr(transformers, cfg_cls)(**kw)
        torch.manual_seed(sum(map(ord, name)))
        model = getattr(transformers, model_cls)(hf_cfg).eval().float()
        _perturb(name, model)
        self.path = self.jax_path = os.path.join(root, name)
        if how.get("bf16") or how.get("f16"):
            dt = torch.bfloat16 if how.get("bf16") else torch.float16
            model.to(dt).save_pretrained(self.path)
            model.float()
        else:
            model.save_pretrained(
                self.path, max_shard_size=how.get("max_shard_size", "5GB"),
                safe_serialization=how.get("safe_serialization", True))
        if how.get("nest"):
            self.path = os.path.join(root, name + "-nested")
            _nest(self.jax_path, self.path, how["nest"])
        self.vocab = hf_cfg.vocab_size
        self.ids = np.random.default_rng(3).integers(0, self.vocab, (2, 40))
        with torch.no_grad():
            self.logits = model(torch.from_numpy(self.ids)).logits.numpy()


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    root = tmp_path_factory.mktemp("hf")
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = Saved(name, str(root))
        return cache[name]

    return get


def _packages(name):
    return (jm, tm) if name in MLA else (jl, tl)


def _asdict(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_config_equals_jax(saved, name):
    s = saved(name)
    jpkg, tpkg = _packages(name)
    cls = "MLAConfig" if name in MLA else "LlamaConfig"
    want = getattr(jpkg, cls).from_hf(s.path)
    got = getattr(tpkg, cls).from_hf(s.path)
    assert _asdict(got) == _asdict(want)


def _bits(t):
    return t.contiguous().view({2: torch.int16, 4: torch.int32}[
        t.element_size()])


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_params_equal_jax(saved, name, dtype):
    s = saved(name)
    jpkg, tpkg = _packages(name)
    cls = "MLAConfig" if name in MLA else "LlamaConfig"
    jcfg = dataclasses.replace(getattr(jpkg, cls).from_hf(s.jax_path),
                               dtype=dtype)
    tcfg = dataclasses.replace(getattr(tpkg, cls).from_hf(s.path),
                               dtype=dtype)
    _, jparams = jpkg.load_hf(s.jax_path, jcfg)
    want = tpkg.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    got_cfg, got = tpkg.load_hf(s.path, tcfg, device="cpu")
    assert got_cfg == tcfg
    want, got = _flat(want), _flat(got)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].shape == want[key].shape, key
        assert torch.equal(_bits(got[key]), _bits(want[key])), key


@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_matches_hf(saved, name):
    """The port's forward (fp32, plain attention on the CPU) over the
    loaded weights gives the HF model's logits."""
    s = saved(name)
    _, tpkg = _packages(name)
    B, T = s.ids.shape
    tokens = torch.as_tensor(s.ids, dtype=torch.long)
    start = torch.zeros(B, dtype=torch.int32)
    if name in MLA:
        cfg = dataclasses.replace(tm.MLAConfig.from_hf(s.path),
                                  dtype="float32")
        _, params = tm.load_hf(s.path, cfg, device="cpu")
        cache = tm.new_latent_cache(cfg, B, T, device="cpu")
        logits, _ = tm.forward(params, cfg, tokens, start, cache)
    else:
        cfg = dataclasses.replace(tl.LlamaConfig.from_hf(s.path),
                                  dtype="float32")
        _, params = tl.load_hf(s.path, cfg, device="cpu")
        cache = tl.new_kv_cache(cfg, B, T, device="cpu")
        logits, _ = tl.forward(params, cfg, tokens, start, cache)
    np.testing.assert_allclose(logits.numpy(), s.logits, atol=TOL, rtol=TOL)


# -- hand-written config.json files ------------------------------------------

# the attributes the JAX from_hf functions read
READ = tuple("""
    num_experts num_local_experts mlp_only_layers decoder_sparse_step
    model_type head_dim hidden_size num_attention_heads layer_types
    sliding_window attention_chunk_size no_rope_layers
    interleave_moe_layer_step moe_layers num_hidden_layers
    partial_rotary_factor rope_scaling original_max_position_embeddings
    max_position_embeddings vocab_size num_key_value_heads intermediate_size
    rms_norm_eps rope_theta attention_bias use_qk_norm
    attn_temperature_tuning floor_scale attn_scale swiglu_limit
    num_experts_per_tok moe_intermediate_size norm_topk_prob
    attn_logit_softcapping final_logit_softcapping query_pre_attn_scalar
    sliding_window_pattern rope_local_base_freq moe_layer_freq topk_method
    q_lora_rank kv_lora_rank qk_nope_head_dim qk_rope_head_dim v_head_dim
    rope_interleave n_routed_experts n_shared_experts first_k_dense_replace
    routed_scaling_factor n_group topk_group tie_word_embeddings
    """.split())
_ABSENT = object()

# minimal files: each leaves out every optional key
MINIMAL = {mt: {"model_type": mt} for mt in (
    "llama", "mistral", "qwen2", "qwen3", "qwen3_moe", "mixtral", "gemma",
    "gemma2", "gemma3", "gemma3_text", "glm", "glm4", "olmo2", "phi3",
    "llama4", "llama4_text", "gpt_oss", "deepseek_v2", "deepseek_v3")}
# the places where the raw JSON and AutoConfig disagree
TRAPS = {
    # Qwen2.5's files: the window is off unless use_sliding_window
    "qwen2.5-window-off": {"model_type": "qwen2", "num_hidden_layers": 4,
                           "sliding_window": 131072,
                           "use_sliding_window": False,
                           "max_window_layers": 2},
    "qwen2-window-on": {"model_type": "qwen2", "num_hidden_layers": 4,
                        "sliding_window": 64, "use_sliding_window": True,
                        "max_window_layers": 2},
    "qwen3-moe-window-off": {"model_type": "qwen3_moe",
                             "num_hidden_layers": 4, "sliding_window": 64},
    "gemma3-no-layer-types": {"model_type": "gemma3_text",
                              "num_hidden_layers": 8},
    "gemma3-pattern": {"model_type": "gemma3_text", "num_hidden_layers": 8,
                       "sliding_window_pattern": 4},
    "gemma3-bidirectional": {"model_type": "gemma3_text",
                             "num_hidden_layers": 4, "sliding_window": 512,
                             "use_bidirectional_attention": True},
    "gemma3-nested": {"model_type": "gemma3", "text_config": {
        "num_hidden_layers": 12, "sliding_window": 1024}},
    "llama4-nested": {"model_type": "llama4", "text_config": {
        "num_hidden_layers": 8, "attention_chunk_size": 256}},
    "rope-type-old-spelling": {"model_type": "llama", "rope_scaling": {
        "type": "linear", "factor": 4.0}},
    "llama3-rope": {"model_type": "llama", "rope_scaling": {
        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
        "high_freq_factor": 4.0, "original_max_position_embeddings": 8192}},
    "no-kv-heads": {"model_type": "llama", "hidden_size": 512,
                    "num_attention_heads": 8, "num_key_value_heads": None},
    "no-head-dim": {"model_type": "mistral", "hidden_size": 512,
                    "num_attention_heads": 8},
    "mixtral-window": {"model_type": "mixtral", "sliding_window": 4096},
    "phi3-su": {"model_type": "phi3", "hidden_size": 64,
                "num_attention_heads": 4, "max_position_embeddings": 128,
                "original_max_position_embeddings": 32, "rope_scaling": {
                    "type": "su", "short_factor": [1.0] * 8,
                    "long_factor": [2.0] * 8}},
    "deepseek-v3-int-yarn": {"model_type": "deepseek_v3", "rope_scaling": {
        "type": "yarn", "factor": 40, "beta_fast": 32, "beta_slow": 1,
        "mscale": 1.0, "mscale_all_dim": 1.0,
        "original_max_position_embeddings": 4096}},
}
# each NotImplementedError / ValueError of the JAX from_hf functions
REFUSALS = {
    "mixed-sparse-mlp-only": ({"model_type": "qwen3_moe",
                               "num_hidden_layers": 4,
                               "mlp_only_layers": [0]}, NotImplementedError),
    "mixed-sparse-step": ({"model_type": "qwen3_moe", "num_hidden_layers": 4,
                           "decoder_sparse_step": 2}, NotImplementedError),
    "llama4-no-rope-misaligned": ({"model_type": "llama4_text",
                                   "num_hidden_layers": 4,
                                   "no_rope_layers": [1, 0, 1, 1],
                                   "layer_types": ["chunked_attention"] * 3
                                   + ["full_attention"]},
                                  NotImplementedError),
    "llama4-interleaved-moe": ({"model_type": "llama4_text",
                                "num_hidden_layers": 4,
                                "interleave_moe_layer_step": 2},
                               NotImplementedError),
    "rope-dynamic": ({"model_type": "llama", "rope_scaling": {
        "rope_type": "dynamic", "factor": 2.0}}, NotImplementedError),
    "mla-moe-layer-freq": ({"model_type": "deepseek_v2",
                            "moe_layer_freq": 2}, NotImplementedError),
    "mla-rope-linear": ({"model_type": "deepseek_v2", "rope_scaling": {
        "rope_type": "linear", "factor": 2.0}}, NotImplementedError),
    "mla-not-mla": ({"model_type": "llama"}, ValueError),
}


def _write(tmp_path, raw):
    with open(tmp_path / "config.json", "w") as f:
        json.dump(raw, f)
    return str(tmp_path)


def _is_mla(raw):
    return raw["model_type"].startswith("deepseek")


@pytest.mark.parametrize("raw", list(MINIMAL.values()) + list(TRAPS.values()),
                         ids=list(MINIMAL) + list(TRAPS))
def test_minimal_config_reads_as_autoconfig(tmp_path, raw):
    """Every attribute the loaders read has AutoConfig's value (present or
    absent alike), and from_hf gives the JAX from_hf's config."""
    path = _write(tmp_path, raw)
    hc = transformers.AutoConfig.from_pretrained(path)
    hc = getattr(hc, "text_config", None) or hc
    mine = hf_checkpoint.text_config(hf_checkpoint.read_config(path))
    for key in READ:
        assert getattr(mine, key, _ABSENT) == getattr(hc, key, _ABSENT), key
    jpkg, tpkg = (jm, tm) if _is_mla(raw) else (jl, tl)
    cls = "MLAConfig" if _is_mla(raw) else "LlamaConfig"
    try:
        want = getattr(jpkg, cls).from_hf(path)
    except (NotImplementedError, ValueError) as e:
        with pytest.raises(type(e)):
            getattr(tpkg, cls).from_hf(path)
        return
    assert _asdict(getattr(tpkg, cls).from_hf(path)) == _asdict(want)


def test_traps_read_as_autoconfig_does(tmp_path):
    """The values the raw JSON gets wrong, spelled out."""
    def read(raw):
        d = tmp_path / str(len(os.listdir(tmp_path)))
        d.mkdir()
        return tl.LlamaConfig.from_hf(_write(d, raw))

    assert read(TRAPS["qwen2.5-window-off"]).sliding_window is None
    on = read(TRAPS["qwen2-window-on"])
    assert on.sliding_window == 64
    assert on.global_layer_map == (True, True, False, False)
    g3 = read(TRAPS["gemma3-no-layer-types"])
    assert g3.global_layer_map == (False,) * 5 + (True,) + (False,) * 2
    assert read(TRAPS["gemma3-bidirectional"]).sliding_window == 257
    assert read(TRAPS["rope-type-old-spelling"]).rope_scaling_type == "linear"
    assert read(TRAPS["no-kv-heads"]).n_kv_heads == 8
    assert read(TRAPS["no-head-dim"]).head_dim == 64
    assert read(MINIMAL["mistral"]).sliding_window == 4096
    assert read(MINIMAL["mixtral"]).sliding_window is None


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_match_jax(tmp_path, name):
    raw, exc = REFUSALS[name]
    path = _write(tmp_path, raw)
    for pkg in ((jm, tm) if name.startswith("mla") else (jl, tl)):
        cls = "MLAConfig" if name.startswith("mla") else "LlamaConfig"
        with pytest.raises(exc):
            getattr(pkg, cls).from_hf(path)


def test_hub_id_and_missing_directory_raise(tmp_path):
    for fn in (tl.LlamaConfig.from_hf, tm.MLAConfig.from_hf):
        with pytest.raises(ValueError, match="DeepSeek-V2-Lite"):
            fn("deepseek-ai/DeepSeek-V2-Lite")
    with pytest.raises(ValueError, match="config.json"):
        tl.LlamaConfig.from_hf(str(tmp_path))
    with pytest.raises(ValueError, match="no weights"):
        tl.load_hf(_write(tmp_path, {"model_type": "llama"}),
                   tl.LlamaConfig.tiny(), device="cpu")


def test_staged_read_equals_the_file(saved):
    """A tensor read through a staging buffer a few bytes at a time (the
    card's path, whose pieces do not divide the tensors) equals the one
    read straight into its result and the ``safetensors`` package's."""
    from safetensors.torch import load_file
    path = os.path.join(saved("llama").path, "model.safetensors")
    ref = load_file(path)
    f = hf_checkpoint._SafetensorsFile(path)
    cpu = torch.device("cpu")
    try:
        for key, want in ref.items():
            for staging in (None, lambda: torch.empty(7, dtype=torch.uint8)):
                got = f.read(key, cpu, staging)
                assert got.dtype == want.dtype and torch.equal(got, want)
    finally:
        f.close()


def test_load_needs_cuda_unless_asked(saved):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tl.load_hf(saved("llama").path)


# a subprocess in which importing transformers, safetensors, aiohttp, jax or
# lmcache_tpu raises: the loaders read both weight formats, the HTTP front
# answers a completion and the hooks store and retrieve
_BLOCKED = """
import sys
class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("transformers", "safetensors", "aiohttp",
                                  "jax", "jaxlib", "lmcache_tpu"):
            raise ImportError("refused: " + name)
sys.meta_path.insert(0, Refuse())
import http.client, json
import numpy as np, torch
from lmcache_tpu_torch import LMCacheEngineConfig, integration as itg
from lmcache_tpu_torch.models import llama
from lmcache_tpu_torch.serving import ServingEngine
from lmcache_tpu_torch.serving.api import APIServer
out = {}
for path in sys.argv[1:]:
    cfg, params = llama.load_hf(path, device="cpu")
    out[path] = float(params["lm_head"].float().sum())
srv = APIServer(ServingEngine(cfg, params, max_batch=1, max_seq=32,
                              device="cpu"))
srv.start()
port = srv.listen()
conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
conn.request("POST", "/v1/completions",
             json.dumps({"prompt": [1, 2, 3], "max_tokens": 2}))
resp = json.loads(conn.getresponse().read())
srv.stop()
itg.init_lmcache_engine("m", config=LMCacheEngineConfig(local_device="cpu",
                                                        chunk_size=4))
tokens = np.arange(9, dtype=np.int32)
step = itg.StepInput(tokens=tokens, is_prefill=True)
itg.lmcache_store_kv(step, torch.ones((1, 2, 9, 1, 4)))
itg._engine().engine_.flush()
hit = itg.lmcache_retrieve_kv(step).num_computed_tokens
itg.close_lmcache_engine()
bad = sorted(m.split(".")[0] for m in sys.modules
             if m.split(".")[0] in ("transformers", "safetensors", "aiohttp",
                                    "jax", "lmcache_tpu"))
print(json.dumps({"sums": list(out.values()),
                  "tokens": len(resp["choices"][0]["tokens"]),
                  "hit": hit, "bad": bad}))
"""


def test_loaders_server_and_hooks_run_with_hf_packages_blocked(saved):
    paths = [saved("llama").path, saved("llama-bin").path]
    proc = subprocess.run([sys.executable, "-c", _BLOCKED, *paths], cwd=ROOT,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == [] and out["tokens"] == 2 and out["hit"] == 8
    assert out["sums"] == [
        float(tl.load_hf(p, device="cpu")[1]["lm_head"].float().sum())
        for p in paths]
