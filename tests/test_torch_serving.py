"""The port's ServingEngine against the JAX package's, on the CPU in fp32:
the same weights (JAX ``init_params`` carried across), the same prompts and
a CPU cache engine on each side. Greedy tokens and cached prefix lengths
must be identical; sampled output must be reproducible under one seed."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import lmcache_tpu as jpkg  # noqa: E402
from lmcache_tpu.models import llama as jl  # noqa: E402
from lmcache_tpu.serving import SamplingParams as JSampling  # noqa: E402
from lmcache_tpu.serving import ServingEngine as JEngine  # noqa: E402
import lmcache_tpu_torch as tpkg  # noqa: E402
from lmcache_tpu_torch.models import llama as tl  # noqa: E402
from lmcache_tpu_torch.serving import Request, SamplingParams  # noqa: E402
from lmcache_tpu_torch.serving import ServingEngine  # noqa: E402

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


@pytest.mark.parametrize("kw", [dict(kv_dtype="int8"), dict(decode_block=4),
                                dict(spec_lookahead=2), dict(mesh=object())],
                         ids=["int8", "decode_block", "spec", "mesh"])
def test_unported_options_raise(model, kw):
    _, _, tcfg, tparams = model
    with pytest.raises(ValueError, match="not ported yet"):
        ServingEngine(tcfg, tparams, device="cpu", **kw)


def test_blend_request_raises(model):
    _, _, tcfg, tparams = model
    eng = ServingEngine(tcfg, tparams, device="cpu", **ENGINE_KW)
    req = Request(np.arange(4, dtype=np.int32), SamplingParams(),
                  context_chunks=[np.arange(4, dtype=np.int32)])
    with pytest.raises(ValueError, match="not ported yet"):
        eng.add_request(req)
