"""The port's ServingEngine against the JAX package's, on the CPU in fp32:
the same weights (JAX ``init_params`` carried across), the same prompts and
a CPU cache engine on each side. Greedy tokens and cached prefix lengths
must be identical; sampled output must be reproducible under one seed."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import lmcache_tpu as jpkg  # noqa: E402
from lmcache_tpu.models import llama as jl  # noqa: E402
from lmcache_tpu.serving import Request as JRequest  # noqa: E402
from lmcache_tpu.serving import SamplingParams as JSampling  # noqa: E402
from lmcache_tpu.serving import ServingEngine as JEngine  # noqa: E402
import lmcache_tpu_torch as tpkg  # noqa: E402
from lmcache_tpu_torch.models import llama as tl  # noqa: E402
from lmcache_tpu_torch.serving import Request, SamplingParams  # noqa: E402
from lmcache_tpu_torch.serving import ServingEngine  # noqa: E402
from torch_test_helpers import (FakeMesh,  # noqa: E402,F401
                                one_torch_thread)

CHUNK = 16
ENGINE_KW = dict(max_batch=2, max_seq=128, prefill_chunk=16)


@pytest.fixture(scope="module")
def model():
    jcfg = jl.LlamaConfig.tiny(n_layers=2)
    jparams = jl.init_params(jax.random.PRNGKey(7), jcfg)
    tcfg = tl.LlamaConfig(**dataclasses.asdict(jcfg))
    tparams = tl.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
    return jcfg, jparams, tcfg, tparams


def _prompts(vocab):
    """Three prompts: two share a 40-token prefix, the third is unrelated."""
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, vocab, 40, dtype=np.int32)
    return [
        np.concatenate([prefix, rng.integers(0, vocab, 13, dtype=np.int32)]),
        np.concatenate([prefix, rng.integers(0, vocab, 21, dtype=np.int32)]),
        rng.integers(0, vocab, 35, dtype=np.int32),
    ]


def _meta(pkg, dtype):
    return pkg.LMCacheEngineMetadata(model_name="tiny", world_size=1,
                                     worker_id=0, fmt="vllm", dtype=dtype)


def _port_engine(tcfg, tparams, **kw):
    ce = tpkg.LMCacheEngine(
        tpkg.LMCacheEngineConfig(local_device="cpu", chunk_size=CHUNK),
        _meta(tpkg, tcfg.dtype))
    return ServingEngine(tcfg, tparams, cache_engine=ce, device="cpu",
                         **ENGINE_KW, **kw), ce


def _waves(eng, ce, prompts, sampling, n=2):
    out = []
    for _ in range(n):
        reqs = eng.generate(prompts, sampling)
        ce.engine_.flush()  # the store-back of this wave lands first
        out.append([(r.output_tokens, r.cached_prefix_len) for r in reqs])
    return out


def test_greedy_tokens_and_cache_hits_match_jax_engine(model):
    jcfg, jparams, tcfg, tparams = model
    prompts = _prompts(jcfg.vocab_size)
    jce = jpkg.LMCacheEngine(
        jpkg.LMCacheEngineConfig.from_defaults(local_device="cpu",
                                               chunk_size=CHUNK),
        _meta(jpkg, jcfg.dtype))
    jeng = JEngine(jcfg, jparams, cache_engine=jce, use_pallas=False,
                   **ENGINE_KW)
    jwaves = _waves(jeng, jce, prompts, JSampling(max_new_tokens=6))
    teng, tce = _port_engine(tcfg, tparams)
    twaves = _waves(teng, tce, prompts, SamplingParams(max_new_tokens=6))
    jce.close()
    tce.close()

    assert twaves == jwaves
    # every wave-2 request reuses the KV that wave 1 stored back
    assert all(c > 0 for _, c in twaves[1])
    assert [t for t, _ in twaves[1]] == [t for t, _ in twaves[0]]
    assert len(teng.free_slots) == ENGINE_KW["max_batch"]
    assert not teng.running and not teng.prefilling


def test_suffix_prefill_over_injected_prefix(model):
    """New prompts on a stored prefix hit its whole chunks (32 of 40
    tokens) and prefill a multi-token suffix over the injected KV: the
    tokens equal those of an engine without a cache tier and of the JAX
    engine in the same state."""
    jcfg, jparams, tcfg, tparams = model
    prompts = _prompts(jcfg.vocab_size)
    rng = np.random.default_rng(1)
    fresh = [np.concatenate([prompts[0][:40],
                             rng.integers(0, jcfg.vocab_size, n,
                                          dtype=np.int32)])
             for n in (20, 30)]
    sp = SamplingParams(max_new_tokens=6)
    jce = jpkg.LMCacheEngine(
        jpkg.LMCacheEngineConfig.from_defaults(local_device="cpu",
                                               chunk_size=CHUNK),
        _meta(jpkg, jcfg.dtype))
    jeng = JEngine(jcfg, jparams, cache_engine=jce, use_pallas=False,
                   **ENGINE_KW)
    _waves(jeng, jce, prompts, JSampling(max_new_tokens=6), n=1)
    [jfresh] = _waves(jeng, jce, fresh, JSampling(max_new_tokens=6), n=1)
    teng, tce = _port_engine(tcfg, tparams)
    _waves(teng, tce, prompts, sp, n=1)
    [tfresh] = _waves(teng, tce, fresh, sp, n=1)
    jce.close()
    tce.close()
    uncached = ServingEngine(tcfg, tparams, device="cpu", **ENGINE_KW)

    assert [c for _, c in tfresh] == [32, 32]
    assert tfresh == jfresh
    assert [t for t, _ in tfresh] == [
        r.output_tokens for r in uncached.generate(fresh, sp)]


def test_sampled_output_reproducible_under_one_seed(model):
    _, _, tcfg, tparams = model
    prompts = _prompts(tcfg.vocab_size)
    sp = SamplingParams(max_new_tokens=8, temperature=0.9, top_k=40,
                        top_p=0.9, seed=1234)
    runs = []
    for _ in range(2):
        eng = ServingEngine(tcfg, tparams, device="cpu", **ENGINE_KW)
        runs.append([r.output_tokens for r in eng.generate(prompts, sp)])
    assert runs[0] == runs[1]
    greedy = ServingEngine(tcfg, tparams, device="cpu", **ENGINE_KW)
    g = [r.output_tokens
         for r in greedy.generate(prompts, SamplingParams(max_new_tokens=8))]
    assert runs[0] != g  # the draws did something


def test_eager_store_publishes_at_prefill_complete(model):
    _, _, tcfg, tparams = model
    prompt = _prompts(tcfg.vocab_size)[0]
    eng, ce = _port_engine(tcfg, tparams, eager_store=True)
    req = eng.add_request(Request(prompt, SamplingParams(max_new_tokens=5)))
    while not req.output_tokens:  # the first token ends the prefill
        eng.step()
    ce.engine_.flush()
    assert ce.lookup(prompt) == len(prompt)
    eng.run()
    ce.close()


@pytest.mark.parametrize("kw", [dict(mesh=FakeMesh(1, 2, 1))], ids=["mesh"])
def test_unported_options_raise(model, kw):
    """On a mesh that splits the kv heads, a cache engine whose metadata
    does not name this rank's head slice is refused (the mesh itself runs:
    tests/test_torch_parallel.py), as is an unknown kv_dtype."""
    _, _, tcfg, tparams = model
    ce = tpkg.LMCacheEngine(
        tpkg.LMCacheEngineConfig(local_device="cpu"),
        tpkg.LMCacheEngineMetadata(model_name="m", world_size=1,
                                   worker_id=0, fmt="vllm"))
    with pytest.raises(ValueError, match="head slice 1 of 2"):
        ServingEngine(tcfg, tparams, device="cpu", cache_engine=ce, **kw)
    with pytest.raises(ValueError, match="Invalid kv_dtype"):
        ServingEngine(tcfg, tparams, device="cpu", kv_dtype="fp8")


def test_blend_request_raises(model):
    """CacheBlend is ported (tests/test_torch_blend.py); as in the JAX
    engine, a blend request is refused at admission when the engine has no
    cache tier to keep the chunks in."""
    jcfg, jparams, tcfg, tparams = model
    eng = ServingEngine(tcfg, tparams, device="cpu", **ENGINE_KW)
    req = Request(np.arange(4, dtype=np.int32), SamplingParams(),
                  context_chunks=[np.arange(4, dtype=np.int32)])
    eng.add_request(req)
    with pytest.raises(ValueError, match="need a cache_engine"):
        eng.run()
    jeng = _jax_engine(jcfg, jparams, max_batch=1, max_seq=128)
    jeng.add_request(JRequest(np.arange(4, dtype=np.int32),
                              context_chunks=[np.arange(4, dtype=np.int32)]))
    with pytest.raises(ValueError, match="need a cache_engine"):
        jeng.run()


# ------------------------------------------------------- the int8 pool ---


def _jax_engine(jcfg, jparams, jce=None, **kw):
    return JEngine(jcfg, jparams, cache_engine=jce, use_pallas=False, **kw)


def test_int8_pool_layout_and_horizon(model):
    _, _, tcfg, tparams = model
    eng = ServingEngine(tcfg, tparams, device="cpu", kv_dtype="int8",
                        max_batch=3, max_seq=40)
    L, Hkv, D = tcfg.n_layers, tcfg.n_kv_heads, tcfg.head_dim
    assert eng.kv_pool["sym"].shape == (L, 2, 3, Hkv, 41, D)
    assert eng.kv_pool["sym"].dtype == torch.int8
    assert eng.kv_pool["scale"].shape == (L, 2, 3, 41)
    assert (eng.kv_pool["scale"] == 1).all()  # fresh scales are 1, not 0
    view = eng._slot_view(1)
    assert view["sym"].shape == (L, 2, 1, Hkv, 41, D)
    assert view["sym"].data_ptr() == eng.kv_pool["sym"][:, :, 1:2].data_ptr()


def test_int8_greedy_tokens_match_jax_int8_engine(model):
    """The cases of ``tests/test_serving_int8.py``: the int8 engine gives
    the JAX int8 engine's greedy tokens, which on this model are the native
    engine's too."""
    jcfg, jparams, tcfg, tparams = model
    prompt = np.random.default_rng(0).integers(0, jcfg.vocab_size, 25,
                                               dtype=np.int32)
    kw = dict(max_batch=2, max_seq=128)
    [rj] = _jax_engine(jcfg, jparams, kv_dtype="int8", **kw).generate(
        [prompt], JSampling(max_new_tokens=6))
    sp = SamplingParams(max_new_tokens=6)
    [ri] = ServingEngine(tcfg, tparams, device="cpu", kv_dtype="int8",
                         **kw).generate([prompt], sp)
    [rn] = ServingEngine(tcfg, tparams, device="cpu", **kw).generate(
        [prompt], sp)
    assert ri.output_tokens == rj.output_tokens
    assert ri.output_tokens == rn.output_tokens


def test_int8_cache_reuse_matches_jax(model):
    """Store-back dequantizes, the inject re-quantizes what the tier
    returns: 69 of 70 tokens hit and the greedy tokens stay, as in the JAX
    engine."""
    jcfg, jparams, tcfg, tparams = model
    prompt = np.random.default_rng(1).integers(0, jcfg.vocab_size, 70,
                                               dtype=np.int32)
    kw = dict(max_batch=2, max_seq=128)
    jce = jpkg.LMCacheEngine(
        jpkg.LMCacheEngineConfig.from_defaults(local_device="cpu",
                                               chunk_size=CHUNK),
        _meta(jpkg, jcfg.dtype))
    jeng = _jax_engine(jcfg, jparams, jce, kv_dtype="int8", **kw)
    jwaves = _waves(jeng, jce, [prompt], JSampling(max_new_tokens=5))
    jce.close()
    tce = tpkg.LMCacheEngine(
        tpkg.LMCacheEngineConfig(local_device="cpu", chunk_size=CHUNK),
        _meta(tpkg, tcfg.dtype))
    teng = ServingEngine(tcfg, tparams, cache_engine=tce, device="cpu",
                         kv_dtype="int8", **kw)
    twaves = _waves(teng, tce, [prompt], SamplingParams(max_new_tokens=5))
    tce.close()
    assert twaves == jwaves
    assert twaves[1][0][1] == 69
    assert twaves[1][0][0] == twaves[0][0][0]


def test_int8_batched_waves_match_jax_int8_engine(model):
    """Three prompts over two slots in 16-token segments, two waves: the
    batched decode step parks idle rows at the horizon while another slot
    prefills, and wave 2 is served from the tier."""
    jcfg, jparams, tcfg, tparams = model
    prompts = _prompts(jcfg.vocab_size)
    jce = jpkg.LMCacheEngine(
        jpkg.LMCacheEngineConfig.from_defaults(local_device="cpu",
                                               chunk_size=CHUNK),
        _meta(jpkg, jcfg.dtype))
    jeng = _jax_engine(jcfg, jparams, jce, kv_dtype="int8", **ENGINE_KW)
    jwaves = _waves(jeng, jce, prompts, JSampling(max_new_tokens=6))
    jce.close()
    teng, tce = _port_engine(tcfg, tparams, kv_dtype="int8")
    twaves = _waves(teng, tce, prompts, SamplingParams(max_new_tokens=6))
    tce.close()
    assert twaves == jwaves
    assert all(c > 0 for _, c in twaves[1])


def test_int8_inject_and_read_slot_round_trip(model):
    """The quantizing inject takes absmax over the blob's (H, D) axes per
    (layer, K/V, token); ``_read_slot`` dequantizes to the model dtype.
    Reading back what was injected is within half a quantization step, and
    injecting that again changes no symbol (a fixed point in fp32)."""
    _, _, tcfg, tparams = model
    eng = ServingEngine(tcfg, tparams, device="cpu", kv_dtype="int8",
                        max_batch=2, max_seq=64)
    L, Hkv, D = tcfg.n_layers, tcfg.n_kv_heads, tcfg.head_dim
    blob = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (L, 2, 20, Hkv, D)).astype(np.float32))
    eng._inject(blob, 1, 5)
    absmax = blob.abs().amax(dim=(3, 4))
    torch.testing.assert_close(eng.kv_pool["scale"][:, :, 1, 5:25],
                               absmax / 127.0, rtol=0, atol=0)
    assert (eng.kv_pool["scale"][:, :, 0] == 1).all()
    assert (eng.kv_pool["scale"][:, :, 1, :5] == 1).all()
    back = eng._read_slot(1, 25)
    assert back.shape == (L, 2, 25, Hkv, D) and back.dtype == torch.float32
    assert ((back[:, :, 5:] - blob).abs()
            <= absmax[..., None, None] / 254 + 1e-6).all()
    sym = eng.kv_pool["sym"].clone()
    eng._inject(back[:, :, 5:], 1, 5)
    assert (eng.kv_pool["sym"] == sym).all()


def test_windowed_tiny_mistral_served_by_both_pools(model):
    """A uniform sliding window that cuts (prompts of 40 and 23 tokens plus
    8 new ones against a window of 16): the dense engine, native and int8
    pool, gives the JAX engine's greedy tokens."""
    jcfg = jl.LlamaConfig.tiny(n_layers=2, sliding_window=16)
    jparams = jl.init_params(jax.random.PRNGKey(2), jcfg)
    tcfg = tl.LlamaConfig(**dataclasses.asdict(jcfg))
    tparams = tl.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, jcfg.vocab_size, n, dtype=np.int32)
               for n in (40, 23)]
    full = ServingEngine(
        tl.LlamaConfig(**dataclasses.asdict(jl.LlamaConfig.tiny(n_layers=2))),
        tparams, device="cpu", **ENGINE_KW).generate(
            prompts, SamplingParams(max_new_tokens=8))
    for kv_dtype in ("native", "int8"):
        jout = _jax_engine(jcfg, jparams, kv_dtype=kv_dtype,
                           **ENGINE_KW).generate(
                               prompts, JSampling(max_new_tokens=8))
        tout = ServingEngine(tcfg, tparams, device="cpu", kv_dtype=kv_dtype,
                             **ENGINE_KW).generate(
                                 prompts, SamplingParams(max_new_tokens=8))
        assert ([r.output_tokens for r in tout]
                == [r.output_tokens for r in jout])
        # the window is load-bearing
        assert ([r.output_tokens for r in tout]
                != [r.output_tokens for r in full])
