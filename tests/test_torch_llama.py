"""The port's llama forward against the JAX package's, on the same weights
(JAX ``init_params`` carried across with ``params_from_jax``) and tokens,
on the CPU in fp32."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from lmcache_tpu.models import llama as jl  # noqa: E402
from lmcache_tpu_torch.models import llama as tl  # noqa: E402

B, T, S = 2, 24, 64
ATOL = 1e-4


@pytest.fixture(scope="module")
def model():
    jcfg = jl.LlamaConfig.tiny(n_layers=2)
    jparams = jl.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = tl.LlamaConfig(**dataclasses.asdict(jcfg))
    tparams = tl.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, T),
                                               dtype=np.int32)
    return jcfg, jparams, tcfg, tparams, tokens


def _jax_forward(jcfg, jparams, tokens, start, cache, use_pallas):
    return jl.forward(jparams, jcfg, jnp.asarray(tokens),
                      jnp.asarray(start, jnp.int32), cache,
                      use_pallas=use_pallas)


def _port_forward(tcfg, tparams, tokens, start, cache, **kw):
    return tl.forward(tparams, tcfg, torch.from_numpy(tokens).long(),
                      torch.as_tensor(start, dtype=torch.int32), cache, **kw)


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["reference", "pallas_interpret"])
def test_full_prefill_logits(model, use_pallas):
    jcfg, jparams, tcfg, tparams, tokens = model
    jlog, jcache = _jax_forward(jcfg, jparams, tokens, np.zeros(B),
                                jl.new_kv_cache(jcfg, B, S), use_pallas)
    tlog, tcache = _port_forward(tcfg, tparams, tokens, np.zeros(B),
                                 tl.new_kv_cache(tcfg, B, S, device="cpu"))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL,
                               rtol=ATOL)
    np.testing.assert_allclose(tcache.numpy(), np.asarray(jcache),
                               atol=ATOL, rtol=ATOL)


def test_last_logit_only(model):
    _, _, tcfg, tparams, tokens = model
    full, _ = _port_forward(tcfg, tparams, tokens, np.zeros(B),
                            tl.new_kv_cache(tcfg, B, S, device="cpu"))
    last, _ = _port_forward(tcfg, tparams, tokens, np.zeros(B),
                            tl.new_kv_cache(tcfg, B, S, device="cpu"),
                            last_logit_only=True)
    assert last.shape == (B, 1, tcfg.vocab_size)
    np.testing.assert_allclose(last.numpy(), full[:, -1:].numpy(),
                               atol=1e-5, rtol=1e-5)


def test_prefix_reuse_equals_full_forward(model):
    """Inject a cached prefix blob, then forward only the suffix."""
    jcfg, jparams, tcfg, tparams, tokens = model
    P = 16
    full, cache = _port_forward(tcfg, tparams, tokens, np.zeros(B),
                                tl.new_kv_cache(tcfg, B, S, device="cpu"))
    reuse = tl.new_kv_cache(tcfg, B, S, device="cpu")
    for b in range(B):
        tl.blob_into_cache(reuse, tl.cache_to_blob(cache, b, P).clone(), b)
    suffix, _ = _port_forward(tcfg, tparams, tokens[:, P:], np.full(B, P),
                              reuse)
    np.testing.assert_allclose(suffix.numpy(), full[:, P:].numpy(),
                               atol=1e-5, rtol=1e-5)
    jfull, _ = _jax_forward(jcfg, jparams, tokens, np.zeros(B),
                            jl.new_kv_cache(jcfg, B, S), False)
    np.testing.assert_allclose(suffix.numpy(), np.asarray(jfull)[:, P:],
                               atol=ATOL, rtol=ATOL)


def test_ragged_decode_step(model):
    """A batched decode step with a different position per row, against
    the JAX decode step and the port's own longer prefill."""
    jcfg, jparams, tcfg, tparams, tokens = model
    lens = np.array([T - 1, 10])
    start = lens.copy()
    nxt = tokens[np.arange(B), lens][:, None]
    jcache = jl.new_kv_cache(jcfg, B, S)
    tcache = tl.new_kv_cache(tcfg, B, S, device="cpu")
    for b, n in enumerate(lens):
        one = np.zeros(B, np.int32)
        _, jc = _jax_forward(jcfg, jparams, tokens[b:b + 1, :n], one[:1],
                             jcache[:, :, b:b + 1], False)
        jcache = jcache.at[:, :, b:b + 1].set(jc)
        _port_forward(tcfg, tparams, tokens[b:b + 1, :n], one[:1],
                      tcache[:, :, b:b + 1])
    jstep, _ = _jax_forward(jcfg, jparams, nxt, start, jcache, False)
    tstep, _ = _port_forward(tcfg, tparams, nxt, start, tcache)
    np.testing.assert_allclose(tstep.numpy(), np.asarray(jstep), atol=ATOL,
                               rtol=ATOL)
    for b, n in enumerate(lens):
        ref, _ = _port_forward(tcfg, tparams, tokens[b:b + 1, :n + 1],
                               np.zeros(1),
                               tl.new_kv_cache(tcfg, 1, S, device="cpu"))
        np.testing.assert_allclose(tstep[b, 0].numpy(), ref[0, -1].numpy(),
                                   atol=1e-5, rtol=1e-5)


def test_cache_to_blob_round_trip(model):
    jcfg, jparams, tcfg, tparams, tokens = model
    _, jcache = _jax_forward(jcfg, jparams, tokens, np.zeros(B),
                             jl.new_kv_cache(jcfg, B, S), False)
    tcache = torch.from_numpy(np.asarray(jcache).copy())
    blob = tl.cache_to_blob(tcache, 1, T)
    np.testing.assert_array_equal(blob.numpy(),
                                  np.asarray(jl.cache_to_blob(jcache, 1, T)))
    back = tl.blob_into_cache(tl.new_kv_cache(tcfg, B, S, device="cpu"),
                              blob, b=0, pos=5)
    jback = jl.blob_into_cache(jl.new_kv_cache(jcfg, B, S),
                               jnp.asarray(blob.numpy()), b=0, pos=5)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback))


@pytest.mark.parametrize("cfg_name", ["longchat_7b_16k", "llama3_1_8b",
                                      "gpt_oss_20b"])
def test_rope_inv_freq_scaling(cfg_name):
    cfg = getattr(jl.LlamaConfig, cfg_name)()
    rd = cfg.head_dim
    jinv, jms = jl.rope_inv_freq(cfg.rope_theta, rd, cfg.rope_scaling_spec)
    tinv, tms = tl.rope_inv_freq(cfg.rope_theta, rd, cfg.rope_scaling_spec)
    np.testing.assert_allclose(tinv.numpy(), np.asarray(jinv), rtol=1e-6)
    assert tms == pytest.approx(float(jms))


def test_rotary_variants_match_jax():
    """Partial interleaved rotary (GLM) and linear scaling on one input."""
    x = np.random.default_rng(3).standard_normal((2, 5, 4, 64)).astype(
        np.float32)
    pos = np.arange(10, dtype=np.int32).reshape(2, 5) * 7
    spec = ("linear", 4.0, 1.0, 4.0, 2048, 32.0, 1.0, None, None)
    for kw in (dict(rotary_dim=32, interleaved=True), dict(scaling=spec)):
        jr = jl._rope(jnp.asarray(x), jnp.asarray(pos), 10000.0, **kw)
        tr = tl._rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0,
                      **kw)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5,
                                   rtol=1e-5)


PRESETS = sorted(
    name for name, fn in vars(jl.LlamaConfig).items()
    if isinstance(fn, staticmethod) and name not in ("tiny", "from_hf"))


@pytest.mark.parametrize("name", PRESETS)
def test_every_preset_is_served(name):
    """Every ``LlamaConfig`` preset of the JAX package is a port config that
    the dense and the paged forwards take (no trait refused), with the same
    fields."""
    tcfg = getattr(tl.LlamaConfig, name)()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(
        getattr(jl.LlamaConfig, name)())
    tl.check_supported(tcfg)


@pytest.mark.parametrize("trait", [
    dict(attention_bias=True, attention_out_bias=True),
    dict(mlp_act="gelu_tanh", norm_one_offset=True, embed_scale=True,
         final_logit_softcap=30.0, query_pre_attn_scalar=48.0),
    dict(rotary_dim=32, rope_interleaved=True),
    dict(head_dim_override=128),
    dict(rope_scaling_type="llama3", rope_scaling_factor=8.0,
         rope_original_max_seq=64),
], ids=["qkv_bias", "gemma_traits", "partial_rotary", "head_dim",
        "llama3_rope"])
def test_ported_traits_match_jax(trait):
    """Family traits that forward() runs, each against the JAX forward on
    the same weights (biases made nonzero so that a dropped one shows)."""
    jcfg = jl.LlamaConfig.tiny(n_layers=2, **trait)
    jparams = jl.init_params(jax.random.PRNGKey(1), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(5)
    for name in ("bq", "bk", "bv", "bo"):
        if name in tree["layers"]:
            tree["layers"][name] = rng.standard_normal(
                tree["layers"][name].shape).astype(np.float32) * 0.1
    tcfg = tl.LlamaConfig(**dataclasses.asdict(jcfg))
    tparams = tl.params_from_jax(tree, tcfg, device="cpu")
    tokens = rng.integers(0, jcfg.vocab_size, (B, T), dtype=np.int32)
    jlog, _ = _jax_forward(jcfg, jax.tree.map(jnp.asarray, tree), tokens,
                           np.zeros(B), jl.new_kv_cache(jcfg, B, S), False)
    tlog, _ = _port_forward(tcfg, tparams, tokens, np.zeros(B),
                            tl.new_kv_cache(tcfg, B, S, device="cpu"))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL,
                               rtol=ATOL)
