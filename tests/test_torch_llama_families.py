"""The ten ``LlamaConfig`` presets whose traits go beyond the llama block
(Qwen3-4B and 8B, Qwen3-MoE, Mixtral, Gemma-2, Gemma-3, GLM-4-0414, OLMo-2,
GPT-OSS, Llama-4), each at ``LlamaConfig.tiny(n_layers=2)`` widths with its preset's
traits, through the port's dense and paged forwards against the JAX
package's (``use_pallas=False``), on the CPU in fp32.

A preset's traits are kept and its geometry cut to the tiny widths: a
window of 16 keys (so that the 24-token prompt runs past it), both a local
and a global layer where the preset mixes them, experts narrowed to 64
columns and at most 16 of them, and Llama-4's temperature floor at 16
positions (so that its query scale moves within the prompt). The weights are
drawn with numpy into the JAX ``init_params`` tree's keys and shapes, carried
across with ``params_from_jax``, every bias, sink and norm weight nonzero so
that a dropped one shows. The
tolerance is ``tests/test_torch_llama.py``'s ``ATOL``. Over an int8 arena the
K/V that get quantized come out of each framework's own products, which
differ by fp32 summation order, so a value on a rounding tie may land on the
neighbouring symbol (``tests/test_torch_paged.py``). There the first
layer's symbols are held to that file's rule (within 1, in at most
``MAX_SYMBOL_FLIPS`` of them, scales within ``RTOL_SCALE``). A flipped symbol
moves that layer's attention output, so the second layer's inputs differ by
more than fp32 rounding (4e-5 relative in the Gemma cases, whose sqrt(dim)
embedding scale and (1 + w) norms carry it): its symbols are held within 1
in at most ``MAX_SYMBOL_FLIPS_DEEP`` of them, its scales within
``RTOL_SCALE_DEEP`` (an eighth of the one step, 1/127 of a token's absmax,
that a flip moves a value by), and the logits within ``ATOL_INT8``, what
such flips move them by (5.2e-4 for Gemma-2's).

The routing of the three MoE styles is held apart on a router whose top-k
leaves no near tie, so the chosen experts must agree exactly.

A preset's JAX forwards are compiled once for its three cases: the dense
and the bf16 arena's, held to ``ATOL``, in one jit with XLA's backend
optimizations off (``FAST_COMPILE``: a shorter compile, whose results
differ from the optimized program's by fp32 rounding, far inside
``ATOL``), the int8 arena's in the optimized program: such rounding puts
more of its K/V on rounding ties than the symbol rule above allows."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from lmcache_tpu.models import llama as jl  # noqa: E402
from lmcache_tpu.models import paged as jp  # noqa: E402
from lmcache_tpu_torch.models import llama as tl  # noqa: E402
from lmcache_tpu_torch.models import paged as tp  # noqa: E402

ATOL = 1e-4
ATOL_INT8 = 2e-3
MAX_SYMBOL_FLIPS = 1e-4  # share of a layer's symbols
MAX_SYMBOL_FLIPS_DEEP = 1e-3
RTOL_SCALE = 1e-5
RTOL_SCALE_DEEP = 1e-3
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
B, T, S = 2, 24, 32
PAGE, NUM_PAGES = 16, 6
TABLE = np.asarray([[3, 1], [2, 5]], np.int32)
TINY = dict(vocab_size=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
            hidden_dim=512, max_seq_len=1024, dtype="float32")
# preset -> what its tiny version changes beyond TINY
FAMILIES = {
    "qwen3_4b": {},
    "qwen3_8b": {},
    "qwen3_moe_30b_a3b": dict(n_experts=16, moe_hidden_dim=64),
    "mixtral_8x7b": dict(moe_hidden_dim=64),
    "gemma2_9b": dict(sliding_window=16),
    "gemma3_4b": dict(sliding_window=16, global_layer_map=(False, True)),
    "glm4_0414_9b": dict(rotary_dim=32),
    "olmo2_7b": {},
    "gpt_oss_20b": dict(n_experts=8, moe_hidden_dim=64, sliding_window=16),
    "llama4_scout_17b_16e": dict(n_experts=4, moe_hidden_dim=64,
                                 sliding_window=16,
                                 global_layer_map=(False, True),
                                 attn_floor_scale=16.0),
}
# parameters that are not matrices: biases, sinks and norm weights
VECTORS = ("bq", "bk", "bv", "bo", "sinks", "router_b", "e_bg", "e_bu",
           "e_bd", "attn_norm", "mlp_norm", "post_attn_norm",
           "post_mlp_norm", "q_norm", "k_norm")


def tiny_config(name):
    preset = getattr(jl.LlamaConfig, name)()
    return dataclasses.replace(preset, **{**TINY, **FAMILIES[name]})


def _draw(rng, key, shape, ident):
    """A leaf of the tree: a matrix normal / sqrt(fan in), a norm weight
    around its identity, a bias or sink around 0."""
    if key in VECTORS or key == "final_norm":
        base = ident if key.endswith("norm") else 0.0
        return (base + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    fan_in = shape[-1] if key == "embed" else shape[-2]
    return (rng.standard_normal(shape) * fan_in**-0.5).astype(np.float32)


@functools.lru_cache(maxsize=None)
def model(name):
    """(JAX config, JAX params, port config, port params, tokens): the keys
    and shapes of the JAX ``init_params`` tree (traced, not run), drawn from
    a seeded numpy generator, every bias, sink and norm weight nonzero."""
    jcfg = tiny_config(name)
    shapes = jax.eval_shape(
        lambda: jl.init_params(jax.random.PRNGKey(7), jcfg))
    rng = np.random.default_rng(11)
    ident = 0.0 if jcfg.norm_one_offset else 1.0
    tree = {key: _draw(rng, key, leaf.shape, ident)
            for key, leaf in shapes.items() if key != "layers"}
    tree["layers"] = {key: _draw(rng, key, leaf.shape, ident)
                      for key, leaf in shapes["layers"].items()}
    tcfg = tl.LlamaConfig(**dataclasses.asdict(jcfg))
    tparams = tl.params_from_jax(tree, tcfg, device="cpu")
    tokens = rng.integers(0, jcfg.vocab_size, (B, T), dtype=np.int32)
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, tparams, tokens


@functools.lru_cache(maxsize=None)
def _jax_forwards(name):
    """{path: (logits, pool)} of the JAX forwards: the dense and the bf16
    arena's in one jit (``FAST_COMPILE``), the int8 arena's in another."""
    jcfg, jparams, _, _, tokens = model(name)
    args = (jparams, jnp.asarray(tokens), jnp.zeros(B, jnp.int32))
    table = jnp.asarray(TABLE)

    def dense_and_paged(p, t, z, cache, pool):
        return (jl.forward(p, jcfg, t, z, cache, use_pallas=False),
                jp.forward_paged(p, jcfg, t, z, pool, table,
                                 use_pallas=False))

    dense, paged = jax.jit(dense_and_paged, compiler_options=FAST_COMPILE)(
        *args, jl.new_kv_cache(jcfg, B, S),
        jp.new_paged_kv_pool(jcfg, NUM_PAGES, PAGE))
    int8 = jax.jit(lambda p, t, z, pool: jp.forward_paged_quantized(
        p, jcfg, t, z, pool, table, use_pallas=False))(
            *args, jp.new_quantized_paged_pool(jcfg, NUM_PAGES, PAGE))
    return {path: (np.asarray(logits), jax.tree.map(np.asarray, pool))
            for path, (logits, pool) in (("dense", dense),
                                          ("paged_bf16", paged),
                                          ("paged_int8", int8))}


def _port_forward(name, path):
    _, _, tcfg, tparams, tokens = model(name)
    tok = torch.from_numpy(tokens).long()
    zero = torch.zeros(B, dtype=torch.int32)
    if path == "dense":
        logits, pool = tl.forward(tparams, tcfg, tok, zero,
                                  tl.new_kv_cache(tcfg, B, S, device="cpu"))
    else:
        quant = path == "paged_int8"
        fwd = tp.forward_paged_quantized if quant else tp.forward_paged
        new = tp.new_quantized_paged_pool if quant else tp.new_paged_kv_pool
        logits, pool = fwd(tparams, tcfg, tok, zero,
                           new(tcfg, NUM_PAGES, PAGE, device="cpu"),
                           torch.from_numpy(TABLE))
    return logits.numpy(), jax.tree.map(lambda t: t.numpy(), pool)


@pytest.mark.parametrize("path", ["dense", "paged_bf16", "paged_int8"])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_matches_jax(name, path):
    """The port's forward on the preset's traits equals the JAX forward of
    the same path (dense pool, bf16 arena, int8 arena), logits and the KV
    it wrote."""
    tlog, tpool = _port_forward(name, path)
    jlog, jpool = _jax_forwards(name)[path]
    if path != "paged_int8":
        np.testing.assert_allclose(tlog, jlog, atol=ATOL, rtol=ATOL)
        np.testing.assert_allclose(tpool, jpool, atol=ATOL, rtol=0)
        return
    diff = np.abs(tpool["sym"].astype(np.int32) - jpool["sym"])
    assert diff.max() <= 1
    for layer, flips, rtol in ((0, MAX_SYMBOL_FLIPS, RTOL_SCALE),
                               (1, MAX_SYMBOL_FLIPS_DEEP, RTOL_SCALE_DEEP)):
        assert (diff[layer] != 0).mean() <= flips
        np.testing.assert_allclose(tpool["scale"][layer],
                                   jpool["scale"][layer], rtol=rtol, atol=0)
    np.testing.assert_allclose(tlog, jlog, atol=ATOL_INT8, rtol=ATOL_INT8)


def _jax_top_k(h, lp, cfg):
    """The router logits and the experts that the JAX ``_moe_mlp`` selects,
    by its own arithmetic."""
    logits = (h @ lp["router"]).astype(jnp.float32)
    if cfg.moe_style == "gpt_oss":
        logits = logits + lp["router_b"].astype(jnp.float32)
    sel = (jax.nn.softmax(logits, axis=-1)
           if cfg.moe_style == "softmax_topk" else logits)
    return logits, jax.lax.top_k(sel, cfg.n_experts_per_tok)[1]


@pytest.mark.parametrize("name", ["qwen3_moe_30b_a3b", "gpt_oss_20b",
                                  "llama4_scout_17b_16e"],
                         ids=["softmax_topk", "gpt_oss", "llama4"])
def test_routing_matches_jax(name):
    """Each routing style picks the JAX selection's experts, on a router
    scaled up so that the k-th and the next expert stand well apart for
    every token, and its MoE MLP equals the JAX one."""
    jcfg, jparams, tcfg, tparams, _ = model(name)
    jlp = jax.tree.map(lambda a: a[0], jparams["layers"])
    tlp = {k: v[0] for k, v in tparams["layers"].items()}
    router = np.asarray(jlp["router"]) * 8.0
    jlp = {**jlp, "router": jnp.asarray(router)}
    tlp = {**tlp, "router": torch.from_numpy(router)}
    h = np.random.default_rng(12).standard_normal((40, jcfg.dim)).astype(
        np.float32)
    logits, jids = jax.jit(functools.partial(_jax_top_k, cfg=jcfg),
                           compiler_options=FAST_COMPILE)(jnp.asarray(h), jlp)
    # the selection is monotone in the logits: no near tie there
    ranked = -np.sort(-np.asarray(logits), axis=-1)
    k = jcfg.n_experts_per_tok
    assert (ranked[:, k - 1] - ranked[:, k]).min() > 1e-3
    tids, tw = tl._route(torch.from_numpy(h), tlp, tcfg)
    np.testing.assert_array_equal(np.sort(tids.numpy(), axis=-1),
                                  np.sort(np.asarray(jids), axis=-1))
    assert tw.dtype == torch.float32 and tw.shape == tids.shape
    want = jax.jit(functools.partial(jl._moe_mlp, cfg=jcfg),
                   compiler_options=FAST_COMPILE)(jnp.asarray(h), jlp)
    got = tl._moe_mlp(torch.from_numpy(h), tlp, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)


@pytest.mark.parametrize("name", ["qwen3_moe_30b_a3b", "gpt_oss_20b",
                                  "llama4_scout_17b_16e"],
                         ids=["softmax_topk", "gpt_oss", "llama4"])
def test_moe_slices_give_each_token_the_same_output(name, monkeypatch):
    """Tokens dispatched in slices (a byte budget that fits 16 tokens a
    slice, as a long prefill is dispatched) get the outputs they get in one
    dispatch, routed once for all of them."""
    _, _, tcfg, tparams, _ = model(name)
    lp = {k: v[1] for k, v in tparams["layers"].items()}
    h = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (2, 20, tcfg.dim)).astype(np.float32))
    whole = tl._moe_mlp(h, lp, tcfg)
    row_bytes = 4 * tcfg.dim + 14 * lp["e_gate"].shape[-1]
    monkeypatch.setattr(tl, "MOE_DISPATCH_BYTES",
                        16 * tcfg.n_experts * row_bytes)
    calls = []
    dispatch = tl.experts.dispatch
    monkeypatch.setattr(tl.experts, "dispatch",
                        lambda hf, *a, **kw: calls.append(len(hf))
                        or dispatch(hf, *a, **kw))
    sliced = tl._moe_mlp(h, lp, tcfg)
    assert calls == [16, 16, 8]
    torch.testing.assert_close(sliced, whole, atol=1e-6, rtol=1e-6)
