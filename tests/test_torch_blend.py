"""CacheBlend (``lmcache_tpu_torch/blend.py``) and the engines' blend
admission against the JAX package, on the CPU in fp32: the same weights
(JAX ``init_params`` carried across), the same chunks, a CPU cache engine on
each side.

Anchors, as in ``tests/test_blend.py``: the RoPE shift equals roping at the
shifted position; ``recompute_ratio=1.0`` is an exact full prefill; partial
recompute is closer to the full prefill than naive reuse. Beyond those, the
port's logits, healed KV and selected tokens equal the JAX function's within
fp32 rounding (2e-5; the two frameworks sum their fp32 products in other
orders), and the engines give the JAX engines' greedy tokens.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import lmcache_tpu as jpkg  # noqa: E402
from lmcache_tpu import blend as jblend  # noqa: E402
from lmcache_tpu.models import llama as jl  # noqa: E402
from lmcache_tpu.serving import PagedServingEngine as JPaged  # noqa: E402
from lmcache_tpu.serving import Request as JRequest  # noqa: E402
from lmcache_tpu.serving import SamplingParams as JSampling  # noqa: E402
from lmcache_tpu.serving import ServingEngine as JEngine  # noqa: E402
import lmcache_tpu_torch as tpkg  # noqa: E402
from lmcache_tpu_torch import blend as tblend  # noqa: E402
from lmcache_tpu_torch.models import llama as tl  # noqa: E402
from lmcache_tpu_torch.serving import (PagedServingEngine, Request,  # noqa
                                       SamplingParams, ServingEngine)


# every test of this file on one torch thread (an autouse fixture)
from torch_test_helpers import one_torch_thread  # noqa: E402,F401


ATOL = 2e-5  # port vs JAX, both fp32
GOLD = 2e-3  # blend at ratio 1.0 vs a full prefill (the JAX tests' bound)


def _port(jcfg, jparams):
    tcfg = tl.LlamaConfig(**dataclasses.asdict(jcfg))
    return tcfg, tl.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                    device="cpu")


@pytest.fixture(scope="module")
def setup():
    jcfg = jl.LlamaConfig.tiny(n_layers=3)
    jparams = jl.init_params(jax.random.PRNGKey(11), jcfg)
    return (jcfg, jparams) + _port(jcfg, jparams)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _blob(tcfg, tparams, tokens):
    """The port's standalone prefill of a chunk, as a wire blob."""
    cache = tl.new_kv_cache(tcfg, 1, len(tokens), device="cpu")
    tl.forward(tparams, tcfg, _t(tokens).long()[None],
               torch.zeros(1, dtype=torch.int32), cache)
    return tl.cache_to_blob(cache, 0, len(tokens)).contiguous()


@functools.lru_cache(maxsize=None)
def _jax_prefill(jcfg):
    """The JAX forward of ``jcfg`` from position 0 under one jit: prompts of
    one length share its compile."""
    return jax.jit(lambda p, t, c: jl.forward(
        p, jcfg, t, jnp.zeros(1, jnp.int32), c, use_pallas=False))


def _golden(jcfg, jparams, tokens):
    """The JAX full prefill: (last logits, KV wire blob)."""
    cache = jl.new_kv_cache(jcfg, 1, len(tokens))
    logits, cache = _jax_prefill(jcfg)(jparams, jnp.asarray(tokens)[None],
                                       cache)
    return np.asarray(logits[0, -1]), np.asarray(jl.cache_to_blob(cache))


def _jax_blobs(jcfg, jparams, chunks):
    return [_golden(jcfg, jparams, c)[1] for c in chunks]


def test_rope_shift_identity(setup):
    _, _, tcfg, _ = setup
    rng = np.random.default_rng(0)
    T, H, D = 8, 2, 64
    x = torch.from_numpy(rng.standard_normal((1, T, H, D)).astype(
        np.float32))
    at5 = tl._rope(x, torch.arange(5, 5 + T)[None], tcfg.rope_theta)
    at0 = tl._rope(x, torch.arange(T)[None], tcfg.rope_theta)
    shifted = tblend.rope_shift_keys(at0[0], torch.full((T,), 5.0),
                                     tcfg.rope_theta)
    torch.testing.assert_close(shifted, at5[0], atol=1e-5, rtol=0)
    want = jblend.rope_shift_keys(jnp.asarray(at0[0].numpy()),
                                  jnp.full((T,), 5.0), tcfg.rope_theta)
    np.testing.assert_allclose(shifted.numpy(), np.asarray(want), atol=1e-6)


def test_blend_shift_respects_rope_scaling():
    """The shift spins at the scaled frequencies (llama3) and does not
    apply yarn's mscale again: keys roped at 0 and shifted by 9 equal keys
    roped at 9, as in the JAX package."""
    rng = np.random.default_rng(23)
    T, H, D = 8, 2, 32
    x = torch.from_numpy(rng.standard_normal((1, T, H, D)).astype(
        np.float32))
    for scaling in (("llama3", 8.0, 1.0, 4.0, 64),
                    ("yarn", 4.0, 1.0, 4.0, 64, 32.0, 1.0, None)):
        at9 = tl._rope(x, torch.arange(9, 9 + T)[None], 10000.0,
                       scaling=scaling)
        at0 = tl._rope(x, torch.arange(T)[None], 10000.0, scaling=scaling)
        shifted = tblend.rope_shift_keys(at0[0], torch.full((T,), 9.0),
                                         10000.0, scaling=scaling)
        torch.testing.assert_close(shifted, at9[0], atol=1e-5, rtol=1e-5)
        want = jblend.rope_shift_keys(jnp.asarray(at0[0].numpy()),
                                      jnp.full((T,), 9.0), 10000.0,
                                      scaling=scaling)
        np.testing.assert_allclose(shifted.numpy(), np.asarray(want),
                                   atol=1e-6)
        if scaling[0] == "llama3":  # an unscaled shift is wrong
            bad = tblend.rope_shift_keys(at0[0], torch.full((T,), 9.0),
                                         10000.0)
            assert (bad - at9[0]).abs().max() > 1e-3


@pytest.fixture(scope="module")
def blend_case(setup):
    jcfg, jparams, tcfg, tparams = setup
    rng = np.random.default_rng(1)
    chunks = [rng.integers(0, jcfg.vocab_size, n, dtype=np.int32)
              for n in (24, 32, 24)]
    full = np.concatenate(chunks)
    golden_logits, golden_kv = _golden(jcfg, jparams, full)
    blended = tblend.assemble_chunks(
        [_blob(tcfg, tparams, c) for c in chunks], tcfg.rope_theta)
    jblended = jblend.assemble_chunks(_jax_blobs(jcfg, jparams, chunks),
                                      jcfg.rope_theta)
    np.testing.assert_allclose(blended.numpy(), np.asarray(jblended),
                               atol=ATOL)
    return full, golden_logits, golden_kv, blended, jblended


def test_full_recompute_is_exact(setup, blend_case):
    jcfg, jparams, tcfg, tparams = setup
    full, golden_logits, golden_kv, blended, _ = blend_case
    logits, kv = tblend.blend_prefill(tparams, tcfg, _t(full), blended,
                                      len(full))
    np.testing.assert_allclose(logits.numpy(), golden_logits, atol=GOLD,
                               rtol=GOLD)
    np.testing.assert_allclose(kv.numpy(), golden_kv, atol=GOLD)


@pytest.mark.parametrize("frac", [0.0, 0.2, 0.5])
def test_partial_recompute_matches_jax_and_beats_naive(setup, blend_case,
                                                       frac):
    """The port selects the JAX function's tokens and returns its logits
    and healed KV; partial recompute is closer to the full prefill than
    naive reuse (only the last token recomputed)."""
    jcfg, jparams, tcfg, tparams = setup
    full, golden_logits, _, blended, jblended = blend_case
    T = len(full)
    n_rec = max(1, int(frac * T))
    logits, kv = tblend.blend_prefill(tparams, tcfg, _t(full), blended,
                                      n_rec)
    jlogits, jkv = jblend.blend_prefill(jparams, jcfg, jnp.asarray(full),
                                        jblended, n_rec)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(kv.numpy(), np.asarray(jkv), atol=ATOL)

    def err(lg):
        g = golden_logits / np.linalg.norm(golden_logits)
        return np.linalg.norm(g - lg / np.linalg.norm(lg))

    naive, _ = tblend.blend_prefill(tparams, tcfg, _t(full), blended, 1)
    exact, _ = tblend.blend_prefill(tparams, tcfg, _t(full), blended, T)
    assert err(exact.numpy()) < 1e-3
    if n_rec > 1:
        assert err(logits.numpy()) < err(naive.numpy())


def test_select_tokens_breaks_ties_as_jax_top_k():
    dev = torch.tensor([0.0, 0.0, 3.0, 0.0, 1.0, 0.0, 2.0])
    assert tblend.select_tokens(dev, 4).tolist() == [0, 2, 4, 6]
    _, want = jax.lax.top_k(jnp.asarray(dev.numpy()).at[6].set(jnp.inf), 4)
    assert sorted(np.asarray(want).tolist()) == [0, 2, 4, 6]


def _cache_engines(dtype, name, chunk_size=256):
    def make(pkg, **kw):
        return pkg.LMCacheEngine(
            pkg.LMCacheEngineConfig.from_defaults(
                local_device="cpu", chunk_size=chunk_size, **kw),
            pkg.LMCacheEngineMetadata(model_name=name, world_size=1,
                                      worker_id=0, fmt="vllm", dtype=dtype))
    return make(jpkg), make(tpkg)


def test_cache_blender_end_to_end(setup):
    jcfg, jparams, tcfg, tparams = setup
    rng = np.random.default_rng(2)
    jce, tce = _cache_engines(jcfg.dtype, "tiny")
    jb = jblend.CacheBlender(jcfg, jparams, jce, recompute_ratio=0.2)
    tb = tblend.CacheBlender(tcfg, tparams, tce, recompute_ratio=0.2)
    docs = [rng.integers(0, jcfg.vocab_size, 16, dtype=np.int32)
            for _ in range(3)]
    _, _, info1 = tb.blend([docs[0], docs[1], docs[2]])
    assert info1["misses"] == 3
    # reordered reuse: every chunk hits, each at another position
    logits2, kv2, info2 = tb.blend([docs[2], docs[0], docs[1]])
    assert info2["misses"] == 0 and info2["recomputed_tokens"] == 10
    assert kv2.shape == (tcfg.n_layers, 2, 48, tcfg.n_kv_heads,
                         tcfg.head_dim)
    key = tb._key(docs[0])
    assert key == tblend.CacheEngineKey(
        "blend", "tiny", 1, 0, key.chunk_hash)
    assert key.to_string() == jb._key(docs[0]).to_string()
    jb.blend([docs[0], docs[1], docs[2]])
    jlogits2, jkv2, jinfo2 = jb.blend([docs[2], docs[0], docs[1]])
    assert jinfo2 == info2
    np.testing.assert_allclose(logits2.numpy(), np.asarray(jlogits2),
                               atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(kv2.numpy(), np.asarray(jkv2), atol=ATOL)
    golden, _ = _golden(jcfg, jparams, np.concatenate(
        [docs[2], docs[0], docs[1]]))
    g = golden / np.linalg.norm(golden)
    lg = logits2.numpy() / np.linalg.norm(logits2.numpy())
    assert float(g @ lg) > 0.9
    jce.close()
    tce.close()


# the JAX test's families, then windows, softcap and sinks, each with the
# traits it exercises beyond the llama block (None: none of them)
FAMILIES = [
    (dict(attention_bias=True), None),  # Qwen-style
    (dict(attention_bias=True, rotary_dim=32, rope_interleaved=True),
     None),  # GLM-style
    (dict(attention_bias=True, rotary_dim=32, rope_interleaved=True,
          post_norms=True), "post_norms"),  # Glm4-0414-style
    (dict(qk_norm=True), "qk_norm"),  # Qwen3-style
    (dict(n_experts=4, n_experts_per_tok=2, moe_hidden_dim=64),
     "n_experts"),  # Mixtral-style
    (dict(qk_norm=True, norm_one_offset=True, post_norms=True,
          mlp_act="gelu_tanh", embed_scale=True, query_pre_attn_scalar=24.0,
          sliding_window=16, global_layer_map=(False, True),
          rope_theta=1000000.0, rope_local_theta=10000.0),
     "qk_norm"),  # Gemma-3-style
    (dict(rope_interleaved=True, sliding_window=16,
          global_layer_map=(False, True), local_attention_kind="chunked",
          nope_on_global_layers=True, qk_l2_norm=True,
          attn_temperature_tuning=True, attn_floor_scale=16.0),
     "rope_local_theta|nope_on_global_layers|qk_l2_norm"),  # Llama-4 iRoPE
    (dict(pre_norms=False, post_norms=True, qk_norm_flat=True),
     "qk_norm_flat|post_norms|pre_norms"),  # OLMo-2-style
    (dict(norm_one_offset=True, mlp_act="gelu_tanh", embed_scale=True,
          query_pre_attn_scalar=24.0, sliding_window=16,
          global_layer_map=(False, True), attn_logit_softcap=50.0,
          final_logit_softcap=30.0), None),  # Gemma-2-style
    (dict(rope_interleaved=True, sliding_window=16,
          global_layer_map=(False, True), local_attention_kind="chunked"),
     None),  # chunked local layers
    (dict(attention_bias=True, attention_out_bias=True, sliding_window=16,
          sliding_window_pattern=2, attn_sinks=True), None),  # GPT-OSS-style
]


def _per_layer_rope(cfg):
    """The per-layer rope arguments of ``assemble_chunks`` (both packages),
    as their ``CacheBlender._assemble`` gives them."""
    if cfg.rope_local_theta is None and not cfg.nope_on_global_layers:
        return {}
    return dict(local_theta=cfg.rope_local_theta,
                global_layers=tuple(cfg.layer_windows()),
                nope_global=cfg.nope_on_global_layers)


@pytest.mark.parametrize("family_kw,traits", FAMILIES)
def test_blend_exact_anchor_other_families(family_kw, traits):
    """Ratio 1.0 equals a full prefill for every family (``traits``: those
    of its traits beyond the llama block that it exercises, if any: sandwich
    and q/k norms, MoE, dual-theta and iRoPE rope), and the port's blend
    equals the JAX blend, the chunks assembled at each layer's own rope
    frequencies."""
    jcfg = jl.LlamaConfig.tiny(n_layers=2, **family_kw)
    jparams = jl.init_params(jax.random.PRNGKey(5), jcfg)
    tcfg = tl.LlamaConfig(**dataclasses.asdict(jcfg))
    tparams = tl.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
    rng = np.random.default_rng(8)
    docs = [rng.integers(0, jcfg.vocab_size, 24, dtype=np.int32)
            for _ in range(3)]
    full = np.concatenate(docs)
    blended = tblend.assemble_chunks(
        [_blob(tcfg, tparams, d) for d in docs], tcfg.rope_theta,
        tcfg.rotary_dim, tcfg.rope_interleaved, tcfg.rope_scaling_spec,
        **_per_layer_rope(tcfg))
    logits, kv = tblend.blend_prefill(tparams, tcfg, _t(full), blended,
                                      len(full))
    gold_logits, gold_kv = _golden(jcfg, jparams, full)
    np.testing.assert_allclose(logits.numpy(), gold_logits, atol=GOLD,
                               rtol=GOLD)
    np.testing.assert_allclose(kv.numpy(), gold_kv, atol=GOLD, rtol=GOLD)
    jblended = jblend.assemble_chunks(
        _jax_blobs(jcfg, jparams, docs), jcfg.rope_theta, jcfg.rotary_dim,
        jcfg.rope_interleaved, jcfg.rope_scaling_spec,
        **_per_layer_rope(jcfg))
    n_rec = len(full) // 4
    jlogits, jkv = jblend.blend_prefill(jparams, jcfg, jnp.asarray(full),
                                        jblended, n_rec)
    logits, kv = tblend.blend_prefill(tparams, tcfg, _t(full), blended,
                                      n_rec)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(kv.numpy(), np.asarray(jkv), atol=1e-4)


@pytest.mark.parametrize("family_kw", [
    dict(),  # uniform rope
    dict(sliding_window=16, global_layer_map=(False, True), rope_theta=1e6,
         rope_local_theta=1e4),  # Gemma-3 dual theta
    dict(rope_interleaved=True, sliding_window=16,
         global_layer_map=(False, True), local_attention_kind="chunked",
         nope_on_global_layers=True),  # Llama-4 iRoPE
])
def test_assemble_shift_selects_per_layer_freqs(family_kw):
    """Chunk A unshifted, chunk B's keys rotated by A's length at every
    layer at that layer's rope frequencies (uniform; Gemma-3's local theta
    on sliding layers; none on Llama-4's NoPE global layers), values
    untouched, as the JAX assemble does."""
    jcfg = jl.LlamaConfig.tiny(n_layers=2, **family_kw)
    jparams = jl.init_params(jax.random.PRNGKey(9), jcfg)
    tcfg, tparams = _port(jcfg, jparams)
    rng = np.random.default_rng(10)
    tA = 24
    A = rng.integers(0, jcfg.vocab_size, tA, dtype=np.int32)
    B = rng.integers(0, jcfg.vocab_size, 24, dtype=np.int32)
    blobA, blobB = _blob(tcfg, tparams, A), _blob(tcfg, tparams, B)
    per_layer = _per_layer_rope(tcfg)
    blended = tblend.assemble_chunks(
        [blobA, blobB], tcfg.rope_theta, tcfg.rotary_dim,
        tcfg.rope_interleaved, tcfg.rope_scaling_spec, **per_layer)
    assert torch.equal(blended[:, :, :tA], blobA)
    assert torch.equal(blended[:, 1, tA:], blobB[:, 1])
    rd = tcfg.rotary_dim or tcfg.head_dim
    for layer, g in enumerate(tcfg.layer_windows()):
        inv = (tl._layer_rope_freqs(tcfg, bool(g))[0] if per_layer
               else tl.rope_inv_freq(tcfg.rope_theta, rd,
                                     tcfg.rope_scaling_spec)[0])
        want = tl._rope(blobB[layer, 0][None], torch.full((1, 24), float(tA)),
                        tcfg.rope_theta, tcfg.rotary_dim,
                        tcfg.rope_interleaved, freqs=(inv, 1.0))[0]
        torch.testing.assert_close(blended[layer, 0, tA:], want, atol=2e-5,
                                   rtol=2e-5)
        if per_layer and g and tcfg.nope_on_global_layers:
            assert torch.equal(blended[layer, 0, tA:], blobB[layer, 0])
    jblended = jblend.assemble_chunks(
        [blobA.numpy(), blobB.numpy()], jcfg.rope_theta, jcfg.rotary_dim,
        jcfg.rope_interleaved, jcfg.rope_scaling_spec,
        **_per_layer_rope(jcfg))
    np.testing.assert_allclose(blended.numpy(), np.asarray(jblended),
                               atol=1e-6)


# -- the engines ----------------------------------------------------------

def _naive_greedy(tcfg, tparams, prompt, n):
    eng = ServingEngine(tcfg, tparams, max_batch=1, max_seq=256,
                        device="cpu")
    [r] = eng.generate([prompt], SamplingParams(max_new_tokens=n))
    return r.output_tokens


@pytest.mark.parametrize("kv_dtype,ratio", [("native", 1.0),
                                            ("native", 0.15),
                                            ("int8", 1.0)])
def test_blend_request(setup, kv_dtype, ratio):
    """context_chunks requests admit through CacheBlend and keep decoding,
    with the JAX engine's tokens; at ratio 1.0 (an exact prefill) the
    native pool gives plain greedy decoding's tokens."""
    jcfg, jparams, tcfg, tparams = setup
    rng = np.random.default_rng(9)
    docs = [rng.integers(0, jcfg.vocab_size, 24, dtype=np.int32)
            for _ in range(3)]
    jce, tce = _cache_engines(jcfg.dtype, f"tiny-blend-{kv_dtype}")
    kw = dict(max_batch=2, max_seq=256, kv_dtype=kv_dtype,
              blend_recompute_ratio=ratio)
    jeng = JEngine(jcfg, jparams, cache_engine=jce, use_pallas=False, **kw)
    teng = ServingEngine(tcfg, tparams, cache_engine=tce, device="cpu",
                         **kw)
    jreq = JRequest(np.empty(0, np.int32), JSampling(max_new_tokens=5),
                    context_chunks=docs)
    treq = Request(np.empty(0, np.int32), SamplingParams(max_new_tokens=5),
                   context_chunks=docs)
    jeng.add_request(jreq)
    jeng.run()
    teng.add_request(treq)
    teng.run()
    assert treq.output_tokens == jreq.output_tokens
    assert treq.num_prompt_tokens == 72
    assert treq.blended_tokens_recomputed == int(np.ceil(ratio * 72))
    assert treq.cached_prefix_len == jreq.cached_prefix_len
    if kv_dtype == "native" and ratio == 1.0:
        assert treq.output_tokens == _naive_greedy(
            tcfg, tparams, np.concatenate(docs), 5)
    jce.close()
    tce.close()


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_paged_blend_request(setup, kv_dtype):
    """CacheBlend admission onto pages (72 tokens: 4.5 pages, padded to 5),
    with the JAX paged engine's tokens; every page returns to the arena."""
    jcfg, jparams, tcfg, tparams = setup
    rng = np.random.default_rng(5)
    docs = [rng.integers(0, jcfg.vocab_size, 24, dtype=np.int32)
            for _ in range(3)]
    jce, tce = _cache_engines(jcfg.dtype, f"tiny-pb-{kv_dtype}",
                              chunk_size=16)
    kw = dict(max_batch=2, max_seq=256, num_pages=32, page_size=16,
              kv_dtype=kv_dtype, blend_recompute_ratio=1.0)
    jeng = JPaged(jcfg, jparams, cache_engine=jce, use_pallas=False, **kw)
    teng = PagedServingEngine(tcfg, tparams, cache_engine=tce, device="cpu",
                              **kw)
    out = []
    for eng, R, S in ((jeng, JRequest, JSampling),
                      (teng, Request, SamplingParams)):
        req = R(np.empty(0, np.int32), S(max_new_tokens=5),
                context_chunks=docs)
        eng.add_request(req)
        eng.run()
        out.append(req.output_tokens)
        assert eng.allocator.num_free == 31  # all pages returned
    assert out[1] == out[0]
    if kv_dtype == "native":
        assert out[1] == _naive_greedy(tcfg, tparams, np.concatenate(docs),
                                       5)
    jce.close()
    tce.close()


def test_blend_admission_near_full_arena(setup):
    """A blend request whose first chunk is a resident prefix takes no
    shared pages, so it backpressures until the running request frees its
    pages instead of over-admitting."""
    _, _, tcfg, tparams = setup
    _, tce = _cache_engines(tcfg.dtype, "tiny-blendadm", chunk_size=16)
    eng = PagedServingEngine(tcfg, tparams, max_batch=2, max_seq=128,
                             num_pages=7, page_size=16, cache_engine=tce,
                             device="cpu", blend_recompute_ratio=1.0)
    prompt = lambda n, s: np.random.default_rng(s).integers(  # noqa: E731
        0, tcfg.vocab_size, n, dtype=np.int32)
    common = prompt(48, 33)  # 3 pages once resident
    a = Request(common.copy(), SamplingParams(max_new_tokens=30))
    eng.add_request(a)
    while not a.output_tokens:
        eng.step()  # a runs: its 3 prompt pages are registered
    b = Request(np.empty(0, np.int32), SamplingParams(max_new_tokens=4),
                context_chunks=[common.copy(), prompt(16, 34)])
    eng.add_request(b)
    assert not eng._can_admit(b)  # 4 pages needed, 3 free
    eng.run()
    assert len(a.output_tokens) == 30 and len(b.output_tokens) == 4
    tce.close()


def test_blend_storeback_skipped(setup):
    """Healed blend KV is never stored back under the exact prefix hashes
    (the blender stores chunk KV at the backend level only), and a blend
    request is never preempted."""
    _, _, tcfg, tparams = setup
    _, tce = _cache_engines(tcfg.dtype, "tiny-blend-sb")
    stored = []
    store = tce.store

    def spy(tokens, kv, **kw):
        stored.append(len(np.asarray(tokens).reshape(-1)))
        return store(tokens, kv, **kw)

    tce.store = spy
    eng = ServingEngine(tcfg, tparams, max_batch=1, max_seq=256,
                        cache_engine=tce, device="cpu",
                        blend_recompute_ratio=1.0)
    docs = [np.random.default_rng(20 + i).integers(
        0, tcfg.vocab_size, 24, dtype=np.int32) for i in range(3)]
    req = Request(np.empty(0, np.int32), SamplingParams(max_new_tokens=4),
                  context_chunks=docs)
    eng.add_request(req)
    eng.run()
    assert stored == []
    assert len(req.output_tokens) == 4
    paged = PagedServingEngine(tcfg, tparams, max_batch=2, max_seq=256,
                               num_pages=32, page_size=16, device="cpu",
                               cache_engine=tce)
    blend = Request(np.empty(0, np.int32), SamplingParams(),
                    context_chunks=docs)
    paged.running = [Request(docs[0]), blend]
    assert paged._pick_victim(blend) is paged.running[0]
    tce.close()
