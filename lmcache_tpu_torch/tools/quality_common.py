"""The in-repo trained quality checkpoints and their evaluation corpus.

Port of ``tools/quality_common.py``: the configs, the corpus, and the
checkpoint files that ``tools/eval_quality.py`` reads and
``tools/train_quality_model.py`` writes. The two checkpoints are retrieval
models trained on a copy-with-offset corpus: each sequence is
``s[t] = s[t - R]`` for ``t >= R`` over a base of ``R`` distinct tokens, so
a trained model predicts position ``t >= R`` only by retrieving the KV
written ``R`` positions earlier. Damage that a codec does to cached KV then
breaks the prediction, and the perplexity delta measures it.

- ``checkpoints/quality_8l.npz``: an 8-layer llama-config model (D 64, 4
  query heads over 2 KV heads), :func:`quality_config`;
- ``checkpoints/quality_mla_4l.npz``: a 4-layer MLA model (latent 128 + 32,
  4 heads), :func:`quality_mla_config`.

Both are float16 npz files of the JAX parameter trees, leaves named by
their ``"/"``-joined paths. :func:`load_params` rebuilds the tree and
carries it onto the port's parameters in the config's dtype on ``device``;
:func:`save_params` writes the port's parameters back in that format, which
the JAX tool's ``load_params`` reads too. The corpus functions are numpy
copies of the JAX tool's, so the tokens and batches of a seed are the JAX
tool's.
"""

import os

import numpy as np
import torch

from lmcache_tpu_torch.models import llama, mla

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CKPT_PATH = os.path.join(_ROOT, "checkpoints", "quality_8l.npz")
MLA_CKPT_PATH = os.path.join(_ROOT, "checkpoints", "quality_mla_4l.npz")

# at least the largest evaluation's R (ctx 8192 + cont 64 -> R 2048 after
# the cap): base tokens must be distinct, so that retrieval is the only
# signal
VOCAB = 8192


def quality_config(dtype: str = "float32") -> llama.LlamaConfig:
    """The dense checkpoint's model: 8 layers, GQA 4 q / 2 kv, D 64."""
    return llama.LlamaConfig(
        vocab_size=VOCAB, dim=256, n_layers=8, n_heads=4, n_kv_heads=2,
        hidden_dim=512, max_seq_len=16384, dtype=dtype)


def quality_mla_config(dtype: str = "float32") -> mla.MLAConfig:
    """The MLA checkpoint's model: 4 layers, 4 heads, latent 128 + 32."""
    return mla.MLAConfig(
        vocab_size=VOCAB, dim=256, n_layers=4, n_heads=4,
        hidden_dim=512, max_seq_len=16384, q_lora_rank=None,
        kv_lora_rank=128, qk_nope_head_dim=64, qk_rope_head_dim=32,
        v_head_dim=64, dtype=dtype)


def make_sequence(rng: np.random.Generator, total: int,
                  repeat: int) -> np.ndarray:
    """One copy-task sequence: a base of ``repeat`` distinct random tokens,
    then ``s[t] = s[t - repeat]``."""
    if repeat > VOCAB:
        raise ValueError(f"repeat {repeat} > vocab {VOCAB}: base tokens "
                         "could not be unique")
    base = rng.permutation(VOCAB)[:repeat].astype(np.int32)
    reps = -(-total // repeat)
    return np.tile(base, reps)[:total]


def make_eval_tokens(rng: np.random.Generator, total: int) -> np.ndarray:
    """An evaluation sequence with retrieval distance ``total // 2``,
    capped at 2048, the top of the distances the models were trained on."""
    return make_sequence(rng, total, min(total // 2, 2048))


def make_train_batch(rng: np.random.Generator, batch: int, total: int,
                     repeat: int) -> np.ndarray:
    """[batch, total] independent copy-task rows with one shared
    ``repeat``."""
    # argsort of uniform noise = a batch of random permutations
    base = np.argsort(rng.random((batch, VOCAB)), axis=1)[:, :repeat]
    reps = -(-total // repeat)
    return np.tile(base, (1, reps))[:, :total].astype(np.int32)


def target_mask(total: int, repeat: int) -> np.ndarray:
    """[total - 1] bool: the next-token targets that the copy rule
    determines (``t + 1 >= repeat``). The base segment's targets are iid
    noise with nothing to learn, so the loss leaves them out."""
    t = np.arange(total - 1)
    return (t + 1) >= repeat


def flatten(params: dict) -> dict:
    """{``"/"``-joined key path: tensor} of every leaf of a parameter
    tree, in key order: the names of the checkpoint files."""
    flat = {}
    for key, value in params.items():
        if isinstance(value, dict):
            flat.update({f"{key}/{k}": v for k, v in flatten(value).items()})
        else:
            flat[key] = value
    return flat


def save_params(params: dict, path: str) -> None:
    """Write the port's parameters (llama or MLA) as the JAX tool does:
    each leaf under its :func:`flatten` name, as float16, in one compressed
    npz at ``path``. :func:`load_tree` and the JAX tool's ``load_params``
    read it."""
    flat = {name: t.detach().to("cpu", torch.float32).numpy().astype(
        np.float16) for name, t in flatten(params).items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **flat)


def load_tree(path: str = CKPT_PATH) -> dict:
    """The checkpoint's parameter tree of numpy arrays (float16)."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} missing (tools/train_quality_model.py writes it; the "
            "repository holds it)")
    tree: dict = {}
    with np.load(path) as z:
        for name in z.files:
            node = tree
            parts = name.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[name]
    return tree


def load_params(cfg, path: str = None, device="cuda") -> dict:
    """The checkpoint of ``cfg``'s model (a ``LlamaConfig`` or an
    ``MLAConfig``) as the port's parameters, in ``cfg.dtype`` on
    ``device``."""
    if isinstance(cfg, mla.MLAConfig):
        return mla.params_from_jax(load_tree(path or MLA_CKPT_PATH), cfg,
                                   device=device)
    return llama.params_from_jax(load_tree(path or CKPT_PATH), cfg,
                                 device=device)


def load_mla_checkpoint(ctx: int, cont: int, seed: int,
                        dtype: str = "float32", device="cuda"):
    """(cfg, params, tokens) of the trained MLA gate; the tokens come from
    seed ``12345 + seed``, as in the JAX tool."""
    cfg = quality_mla_config(dtype)
    params = load_params(cfg, device=device)
    rng = np.random.default_rng(12345 + seed)
    return cfg, params, make_eval_tokens(rng, ctx + cont)
