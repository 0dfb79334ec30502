"""Local HuggingFace checkpoint directories, read without ``transformers``.

The loaders of :mod:`lmcache_tpu_torch.models.llama` and
:mod:`lmcache_tpu_torch.models.mla` read a checkpoint directory through this
module: ``config.json`` and the weight files, nothing else. Nothing is
downloaded: a hub id, or any path that is not a directory, raises
``ValueError``.

- :func:`read_config` gives the attributes that
  ``transformers.AutoConfig.from_pretrained`` would give for the keys the
  loaders read: the file's own keys, the defaults of the ``model_type``'s
  configuration class for the keys it leaves out, and the values those
  classes derive in ``__init__`` (``_DEFAULTS`` and ``_derive``, copied from
  transformers 4.57.6). The places where the raw JSON and ``AutoConfig``
  disagree: Qwen2/Qwen3/Qwen3-MoE drop ``sliding_window`` unless
  ``use_sliding_window``; Qwen2/Qwen3, Gemma-2/3, Llama-4 and GPT-OSS compute
  ``layer_types`` when the file has none (Gemma-3 from
  ``sliding_window_pattern``, default 6); Gemma-3 halves the window under
  ``use_bidirectional_attention``; ``num_key_value_heads`` and ``head_dim``
  default per class; the old ``rope_scaling["type"]`` spelling is copied to
  ``"rope_type"``. A multimodal wrapper (``gemma3``, ``llama4``) nests the
  text stack's config under ``text_config``, read as a config of its own.
- :class:`Weights` reads tensors by name from ``model.safetensors`` or the
  shards of ``model.safetensors.index.json`` (the format parsed by hand: an
  8-byte little-endian header length, a JSON header, then the raw bytes;
  dtypes ``F32``, ``F16``, ``BF16``), or from ``pytorch_model.bin`` (and its
  index) through ``torch.load(weights_only=True, mmap=True)``. A tensor is
  read only when it is asked for, onto the device in the file's dtype: a
  safetensors tensor bound for the card goes through a pinned staging
  buffer of 64 MiB a piece at a time, so the host never holds the state
  dict nor even one whole tensor. :class:`Loader` converts each tensor on
  the device and stacks it per layer.
"""

import copy
import json
import os
import struct
from typing import Dict, Optional, Tuple

import torch

CONFIG_FILE = "config.json"

# multimodal wrappers: their text stack's model_type
_TEXT_OF = {"gemma3": "gemma3_text", "llama4": "llama4_text"}

_COMMON = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
               num_hidden_layers=32, num_attention_heads=32,
               num_key_value_heads=None, max_position_embeddings=2048,
               rms_norm_eps=1e-6, rope_theta=10000.0, rope_scaling=None,
               attention_bias=False, tie_word_embeddings=False)


def _cls(*absent, **over):
    """A class's defaults: the common ones less ``absent`` (parameters the
    class does not have), with ``over``."""
    out = {**_COMMON, **over}
    for key in absent:
        del out[key]
    return out


_QWEN_WINDOW = dict(use_sliding_window=False, sliding_window=4096,
                    max_window_layers=28, layer_types=None)

# per model_type: the __init__ defaults of its configuration class for the
# keys the loaders read (and the keys its derived values come from); a
# class without the parameter has no entry, and the attribute then exists
# only where the file sets it
_DEFAULTS: Dict[str, dict] = {
    "llama": _cls(head_dim=None),
    "mistral": _cls("rope_scaling", "attention_bias",
                    intermediate_size=14336, num_key_value_heads=8,
                    head_dim=None, max_position_embeddings=4096 * 32,
                    sliding_window=4096),
    "qwen2": _cls("attention_bias", vocab_size=151936,
                  intermediate_size=22016, num_key_value_heads=32,
                  max_position_embeddings=32768, **_QWEN_WINDOW),
    "qwen3": _cls(vocab_size=151936, intermediate_size=22016,
                  num_key_value_heads=32, head_dim=128,
                  max_position_embeddings=32768, **_QWEN_WINDOW),
    "qwen3_moe": _cls(vocab_size=151936, hidden_size=2048,
                      intermediate_size=6144, num_hidden_layers=24,
                      num_key_value_heads=4, max_position_embeddings=32768,
                      use_sliding_window=False, sliding_window=4096,
                      decoder_sparse_step=1, moe_intermediate_size=768,
                      num_experts_per_tok=8, num_experts=128,
                      norm_topk_prob=False, mlp_only_layers=None),
    "mixtral": _cls("rope_scaling", "attention_bias",
                    intermediate_size=14336, num_key_value_heads=8,
                    head_dim=None, max_position_embeddings=4096 * 32,
                    rms_norm_eps=1e-5, rope_theta=1e6, sliding_window=None,
                    num_experts_per_tok=2, num_local_experts=8),
    "gemma": _cls("rope_scaling", vocab_size=256000, hidden_size=3072,
                  intermediate_size=24576, num_hidden_layers=28,
                  num_attention_heads=16, num_key_value_heads=16,
                  head_dim=256, max_position_embeddings=8192,
                  tie_word_embeddings=True),
    "gemma2": _cls("rope_scaling", vocab_size=256000, hidden_size=2304,
                   intermediate_size=9216, num_hidden_layers=26,
                   num_attention_heads=8, num_key_value_heads=4,
                   head_dim=256, max_position_embeddings=8192,
                   tie_word_embeddings=True, query_pre_attn_scalar=256,
                   sliding_window=4096, layer_types=None,
                   final_logit_softcapping=30.0,
                   attn_logit_softcapping=50.0),
    "gemma3_text": _cls(vocab_size=262_208, hidden_size=2304,
                        intermediate_size=9216, num_hidden_layers=26,
                        num_attention_heads=8, num_key_value_heads=4,
                        head_dim=256, max_position_embeddings=131_072,
                        rope_theta=1_000_000.0, tie_word_embeddings=True,
                        query_pre_attn_scalar=256, sliding_window=4096,
                        layer_types=None, final_logit_softcapping=None,
                        attn_logit_softcapping=None,
                        rope_local_base_freq=10_000.0,
                        use_bidirectional_attention=False),
    "glm": _cls("rope_scaling", vocab_size=151552,
                intermediate_size=13696, num_hidden_layers=40,
                num_key_value_heads=2, partial_rotary_factor=0.5, head_dim=128,
                max_position_embeddings=131072, rms_norm_eps=0.00000015625,
                attention_bias=True),
    "olmo2": _cls(vocab_size=50304, rms_norm_eps=1e-5),
    "phi3": _cls("attention_bias", vocab_size=32064, hidden_size=3072,
                 intermediate_size=8192, max_position_embeddings=4096,
                 original_max_position_embeddings=4096, rms_norm_eps=1e-5,
                 partial_rotary_factor=1.0, sliding_window=None),
    "llama4_text": _cls(vocab_size=202048, hidden_size=5120,
                        intermediate_size=8192, num_hidden_layers=48,
                        num_attention_heads=40, num_key_value_heads=8,
                        head_dim=128, max_position_embeddings=4096 * 32,
                        rms_norm_eps=1e-5, rope_theta=500000,
                        num_experts_per_tok=1, num_local_experts=16,
                        moe_layers=None, interleave_moe_layer_step=1,
                        use_qk_norm=True, no_rope_layers=None,
                        no_rope_layer_interval=4, attention_chunk_size=8192,
                        layer_types=None, attn_temperature_tuning=True,
                        floor_scale=8192, attn_scale=0.1),
    "gpt_oss": _cls(vocab_size=201088, hidden_size=2880,
                    intermediate_size=2880, num_hidden_layers=36,
                    num_attention_heads=64, num_key_value_heads=8,
                    head_dim=64, max_position_embeddings=131072,
                    rms_norm_eps=1e-5, rope_theta=150000.0,
                    rope_scaling={"rope_type": "yarn", "factor": 32.0,
                                  "beta_fast": 32.0, "beta_slow": 1.0,
                                  "truncate": False,
                                  "original_max_position_embeddings": 4096},
                    num_local_experts=128, sliding_window=128,
                    num_experts_per_tok=4, layer_types=None),
    "deepseek_v2": _cls(first_k_dense_replace=0, kv_lora_rank=512,
                        q_lora_rank=1536, n_group=None, n_routed_experts=64,
                        n_shared_experts=2, qk_nope_head_dim=128,
                        qk_rope_head_dim=64, routed_scaling_factor=1.0,
                        topk_group=None, topk_method="greedy",
                        v_head_dim=128, num_experts_per_tok=None,
                        norm_topk_prob=False, moe_intermediate_size=1407),
    "deepseek_v3": _cls(vocab_size=129280, hidden_size=7168,
                        intermediate_size=18432, moe_intermediate_size=2048,
                        num_hidden_layers=61, num_attention_heads=128,
                        num_key_value_heads=128, n_shared_experts=1,
                        n_routed_experts=256, routed_scaling_factor=2.5,
                        kv_lora_rank=512, q_lora_rank=1536,
                        qk_rope_head_dim=64, v_head_dim=128,
                        qk_nope_head_dim=128, n_group=8, topk_group=4,
                        num_experts_per_tok=8, first_k_dense_replace=3,
                        norm_topk_prob=True, max_position_embeddings=4096,
                        rope_interleave=True),
}
_DEFAULTS["glm4"] = dict(_DEFAULTS["glm"])
# wrappers: the text stack is a config of its own (text_config)
_DEFAULTS["gemma3"] = dict(tie_word_embeddings=True)
_DEFAULTS["llama4"] = dict(tie_word_embeddings=False)

# "num_key_value_heads": None becomes num_attention_heads
_KV_HEADS_BC = ("llama", "mistral", "qwen2", "qwen3", "mixtral", "olmo2",
                "phi3", "llama4_text", "gpt_oss", "deepseek_v2",
                "deepseek_v3")
# "head_dim": None becomes hidden_size // num_attention_heads
_HEAD_DIM_BC = ("llama", "llama4_text", "gpt_oss")
# the old rope_scaling["type"] is copied to "rope_type"
_ROPE_TYPE_BC = ("llama", "qwen2", "qwen3", "qwen3_moe", "gpt_oss",
                 "deepseek_v2", "deepseek_v3")


def _alternating(n, pattern):
    return ["sliding_attention" if (i + 1) % pattern else "full_attention"
            for i in range(n)]


def _derive(mt: str, a: dict, raw: dict) -> None:
    """The values the configuration class of ``mt`` derives in its
    ``__init__`` (transformers 4.57.6), in place."""
    if mt in _KV_HEADS_BC and a.get("num_key_value_heads") is None:
        a["num_key_value_heads"] = a["num_attention_heads"]
    if mt in _HEAD_DIM_BC and a.get("head_dim") is None:
        a["head_dim"] = a["hidden_size"] // a["num_attention_heads"]
    if mt in ("deepseek_v2", "deepseek_v3"):
        a["head_dim"] = a["qk_rope_head_dim"]
    rs = a.get("rope_scaling")
    if mt in _ROPE_TYPE_BC and rs is not None and "type" in rs:
        rs["rope_type"] = rs["type"]
    if mt == "deepseek_v3" and rs is not None:
        for key in ("beta_fast", "beta_slow", "factor"):
            if key in rs:
                rs[key] = float(rs[key])
    if mt == "phi3" and rs is not None and rs.get("type") in ("su", "yarn"):
        rs["type"] = "longrope"
    if mt in ("qwen2", "qwen3", "qwen3_moe") and not a["use_sliding_window"]:
        a["sliding_window"] = None
    if mt in ("qwen2", "qwen3") and a["layer_types"] is None:
        a["layer_types"] = [
            "sliding_attention" if a["sliding_window"] is not None
            and i >= a["max_window_layers"] else "full_attention"
            for i in range(a["num_hidden_layers"])]
    if mt == "qwen3_moe" and a["mlp_only_layers"] is None:
        a["mlp_only_layers"] = []
    if mt in ("gemma2", "gpt_oss") and a["layer_types"] is None:
        a["layer_types"] = _alternating(a["num_hidden_layers"], 2)
    if mt == "gpt_oss":
        a["attention_bias"] = True
    if mt == "gemma3_text":
        if a["use_bidirectional_attention"]:
            a["sliding_window"] = a["sliding_window"] // 2 + 1
        if a["layer_types"] is None:
            a["layer_types"] = _alternating(
                a["num_hidden_layers"], raw.get("sliding_window_pattern", 6))
    if mt == "llama4_text":
        a["attention_bias"] = False
        n = a["num_hidden_layers"]
        if not a["no_rope_layers"]:
            a["no_rope_layers"] = [
                int((i + 1) % a["no_rope_layer_interval"] != 0)
                for i in range(n)]
        if a["moe_layers"] is None:
            step = a["interleave_moe_layer_step"]
            a["moe_layers"] = list(range(step - 1, n, step))
        if a["layer_types"] is None:
            a["layer_types"] = ["chunked_attention" if r else "full_attention"
                                for r in a["no_rope_layers"]]


class CheckpointConfig:
    """The attributes of one checkpoint config, read as
    ``getattr(config, name, default)`` as the JAX loaders read an
    ``AutoConfig``; a wrapper's text stack is ``text_config``."""

    def __init__(self, attrs: dict):
        self.__dict__.update(attrs)

    def __repr__(self):
        return f"CheckpointConfig({self.__dict__!r})"


def _build(mt: str, raw: dict) -> CheckpointConfig:
    attrs = copy.deepcopy(_DEFAULTS[mt])
    attrs.update(copy.deepcopy(raw))
    attrs["model_type"] = raw.get("model_type", mt)
    if mt in _TEXT_OF:
        text = attrs.get("text_config") or {}
        attrs["text_config"] = _build(_TEXT_OF[mt], text)
    else:
        _derive(mt, attrs, raw)
    return CheckpointConfig(attrs)


def checkpoint_dir(path) -> str:
    """``path`` as a local checkpoint directory, or ``ValueError``: the
    loaders read local directories only and download nothing."""
    path = os.fspath(path)
    if not os.path.isdir(path):
        raise ValueError(
            f"{path!r} is not a local checkpoint directory: the loaders read "
            f"a directory holding {CONFIG_FILE} and the weight files (a hub "
            f"id is not downloaded)")
    return path


def read_config(path) -> CheckpointConfig:
    """The config of the checkpoint directory ``path``, with the attributes
    ``AutoConfig.from_pretrained`` would give for its ``model_type``."""
    path = checkpoint_dir(path)
    name = os.path.join(path, CONFIG_FILE)
    if not os.path.isfile(name):
        raise ValueError(f"{path!r} holds no {CONFIG_FILE}")
    with open(name) as f:
        raw = json.load(f)
    mt = raw.get("model_type")
    if mt not in _DEFAULTS:
        raise ValueError(
            f"{name}: model_type {mt!r} is not one the loaders map (one of "
            f"{sorted(_DEFAULTS)})")
    return _build(mt, raw)


def text_config(hc: CheckpointConfig) -> CheckpointConfig:
    """The text stack's config: a wrapper's ``text_config``, else ``hc``."""
    sub = getattr(hc, "text_config", None)
    return sub if sub is not None else hc


# -- weights ----------------------------------------------------------------

_ST_DTYPES = {"F32": torch.float32, "F16": torch.float16,
              "BF16": torch.bfloat16}
_ST_INDEX = "model.safetensors.index.json"
_ST_SINGLE = "model.safetensors"
_PT_INDEX = "pytorch_model.bin.index.json"
_PT_SINGLE = "pytorch_model.bin"


# the host buffer a safetensors tensor bound for the card passes through,
# a piece at a time: the host holds this much of the checkpoint, not a tensor
_STAGING_BYTES = 64 << 20


def _read_exactly(f, view: memoryview) -> None:
    """Fill ``view`` from the unbuffered file ``f`` at its position."""
    got = 0
    while got < len(view):
        n = f.readinto(view[got:])
        if not n:
            raise OSError(f"{f.name}: the file ends {len(view) - got} bytes "
                          f"early")
        got += n


class _SafetensorsFile:
    """One ``.safetensors`` file: its header parsed, each tensor read from
    the file when it is asked for."""

    def __init__(self, name: str):
        self.name = name
        self._f = open(name, "rb", buffering=0)
        (n,) = struct.unpack("<Q", self._f.read(8))
        header = json.loads(self._f.read(n))
        header.pop("__metadata__", None)
        self._base = 8 + n
        self.entries = header

    def read(self, key: str, device: torch.device,
             staging=None) -> torch.Tensor:
        """``key`` in the file's dtype on ``device``: read straight into
        the result, or, given ``staging`` (a function giving a uint8 host
        buffer, pinned for the card), through it one piece at a time."""
        e = self.entries[key]
        if e["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{self.name}: tensor {key!r} has dtype "
                             f"{e['dtype']!r} (one of {sorted(_ST_DTYPES)})")
        begin, end = e["data_offsets"]
        out = torch.empty(end - begin, dtype=torch.uint8, device=device)
        self._f.seek(self._base + begin)
        if staging is None:
            _read_exactly(self._f, memoryview(out.numpy()))
        else:
            buf = staging()
            for at in range(0, end - begin, len(buf)):
                piece = min(len(buf), end - begin - at)
                _read_exactly(self._f, memoryview(buf.numpy())[:piece])
                out[at:at + piece].copy_(buf[:piece])
        return out.view(_ST_DTYPES[e["dtype"]]).view(tuple(e["shape"]))

    def close(self) -> None:
        self._f.close()


class Weights:
    """The tensors of a checkpoint directory by name, each read from its
    file when it is asked for, onto a device in the file's dtype."""

    def __init__(self, path):
        path = checkpoint_dir(path)
        self.path = path
        self._files: Dict[str, object] = {}
        self._staging: Optional[torch.Tensor] = None
        files = os.listdir(path)
        if _ST_INDEX in files:
            self._where = self._index(_ST_INDEX)
        elif _ST_SINGLE in files:
            self._where = {k: _ST_SINGLE for k in
                           self._open(_ST_SINGLE).entries}
        elif _PT_INDEX in files:
            self._where = self._index(_PT_INDEX)
        elif _PT_SINGLE in files:
            self._where = {k: _PT_SINGLE for k in self._open(_PT_SINGLE)}
        else:
            raise ValueError(
                f"{path!r} holds no weights ({_ST_SINGLE}, {_ST_INDEX}, "
                f"{_PT_SINGLE} or {_PT_INDEX})")

    def _index(self, name: str) -> Dict[str, str]:
        with open(os.path.join(self.path, name)) as f:
            return dict(json.load(f)["weight_map"])

    def _open(self, fname: str):
        if fname not in self._files:
            full = os.path.join(self.path, fname)
            if fname.endswith(".safetensors"):
                self._files[fname] = _SafetensorsFile(full)
            else:
                self._files[fname] = torch.load(
                    full, map_location="cpu", weights_only=True, mmap=True)
        return self._files[fname]

    def _pinned(self) -> torch.Tensor:
        if self._staging is None:
            self._staging = torch.empty(_STAGING_BYTES, dtype=torch.uint8,
                                        pin_memory=True)
        return self._staging

    def __contains__(self, key: str) -> bool:
        return key in self._where

    def get(self, key: str, device="cpu") -> torch.Tensor:
        """``key`` on ``device`` in the file's dtype, a tensor of its own."""
        if key not in self._where:
            raise KeyError(f"{self.path}: no tensor {key!r}")
        f = self._open(self._where[key])
        device = torch.device(device)
        if isinstance(f, _SafetensorsFile):
            return f.read(key, device,
                          None if device.type == "cpu" else self._pinned)
        return f[key].to(device, copy=True)

    def close(self) -> None:
        """Close the files and free the staging buffer."""
        for f in self._files.values():
            if isinstance(f, _SafetensorsFile):
                f.close()
        self._files.clear()
        self._staging = None


# where a multimodal checkpoint keeps its text stack: the on-disk names
# (language_model.model.*) and transformers' in-memory ones
_TEXT_PREFIXES = ("model.", "language_model.model.", "model.language_model.")
_HEAD_NAMES = ("lm_head.weight", "language_model.lm_head.weight")


def text_stack_names(weights: Weights) -> Tuple[str, Optional[str]]:
    """(the prefix that stands for ``model.`` in the text stack's tensor
    names, the name of its ``lm_head`` weight or None)."""
    for prefix in _TEXT_PREFIXES:
        if prefix + "embed_tokens.weight" in weights:
            break
    else:
        raise ValueError(f"{weights.path}: no embed_tokens.weight under "
                         f"any of {_TEXT_PREFIXES}")
    head = next((h for h in _HEAD_NAMES if h in weights), None)
    return prefix, head


class Loader:
    """A checkpoint's text stack read into stacked parameters on a device.

    Tensor names are given as the JAX loaders give them
    (``model.layers.{i}...``, ``model.embed_tokens.weight``); :meth:`name`
    maps them onto the file's text stack. Each tensor is copied to the
    device in the file's dtype, goes to fp32 there (what
    ``from_pretrained(torch_dtype=float32)`` gives) and is cast into its
    slot of the stacked parameter in the parameter's dtype (rounding to
    nearest even, as the JAX cast does). On the way to the card a tensor
    passes through a pinned staging buffer of ``_STAGING_BYTES``, the
    host's only copy."""

    def __init__(self, path, device: torch.device, dtype: torch.dtype):
        self.config = read_config(path)
        if getattr(self.config, "quantization_config", None) is not None:
            raise NotImplementedError(
                f"{path!r}: quantized checkpoints (quantization_config) are "
                f"not read")
        self.weights = Weights(path)
        self.prefix, self.head = text_stack_names(self.weights)
        self.device, self.dtype = device, dtype
        self.tied = bool(getattr(text_config(self.config),
                                 "tie_word_embeddings", False))

    def name(self, key: str) -> str:
        if key.startswith("model."):
            return self.prefix + key[len("model."):]
        return key

    def __contains__(self, key: str) -> bool:
        return self.name(key) in self.weights

    def fp32(self, key: str) -> torch.Tensor:
        """The tensor in fp32 on the device."""
        return self.weights.get(self.name(key), self.device).float()

    def t(self, key: str) -> torch.Tensor:
        """A ``[out, in]`` Linear weight as ``[in, out]`` (we apply
        ``x @ W``), fp32 on the device."""
        return self.fp32(key).T

    def one(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        out = torch.empty(x.shape, dtype=dtype or self.dtype,
                          device=self.device)
        return out.copy_(x)

    def split(self, get, idxs, parts, dtype=None):
        """One ``[len(idxs), ...]`` stack for each function in ``parts``,
        each of ``part(get(i))``: a fused tensor is read once a layer."""
        outs = [None] * len(parts)
        for j, i in enumerate(idxs):
            x = get(i)
            for k, part in enumerate(parts):
                y = part(x)
                if outs[k] is None:
                    outs[k] = torch.empty((len(idxs),) + tuple(y.shape),
                                          dtype=dtype or self.dtype,
                                          device=self.device)
                outs[k][j].copy_(y)
        return outs

    def stack(self, get, idxs, dtype=None) -> torch.Tensor:
        """``[len(idxs), ...]`` of ``get(i)`` for each index."""
        return self.split(get, idxs, [lambda x: x], dtype)[0]

    def stack2(self, get, idxs, n) -> torch.Tensor:
        """``[len(idxs), n, ...]`` of ``get(i, e)`` (per-expert tensors)."""
        out = None
        for j, i in enumerate(idxs):
            for e in range(n):
                x = get(i, e)
                if out is None:
                    out = torch.empty((len(idxs), n) + tuple(x.shape),
                                      dtype=self.dtype, device=self.device)
                out[j, e].copy_(x)
        return out

    def lm_head(self) -> torch.Tensor:
        """``[dim, vocab]``: the checkpoint's lm_head, or the embedding
        where the config ties them (or the file has no head)."""
        return self.one(self.t("model.embed_tokens.weight"
                               if self.tied or self.head is None
                               else self.head))

    def close(self) -> None:
        self.weights.close()
