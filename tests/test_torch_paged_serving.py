"""The port's PagedServingEngine against the JAX package's, on the CPU in
fp32: the same weights (JAX ``init_params`` carried across), the same
prompts, a CPU cache engine on each side where one is used. Greedy tokens,
cached prefix lengths, preemption counts and the arena's free pages must be
identical in both packages (exact: no tolerance)."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import lmcache_tpu as jpkg  # noqa: E402
from lmcache_tpu import serving as jserving  # noqa: E402
from lmcache_tpu.models import llama as jl  # noqa: E402
import lmcache_tpu_torch as tpkg  # noqa: E402
from lmcache_tpu_torch import serving as tserving  # noqa: E402
from lmcache_tpu_torch.models import llama as tl  # noqa: E402
from torch_test_helpers import (FakeMesh,  # noqa: E402,F401
                                one_torch_thread)

CHUNK = PAGE = 16


@pytest.fixture(scope="module")
def sides():
    """The two packages behind one interface: ``paged(**kw)``,
    ``dense(**kw)``, ``cache_engine(name)``, ``Request``, ``Sampling``."""
    jcfg = jl.LlamaConfig.tiny(n_layers=2)
    jparams = jl.init_params(jax.random.PRNGKey(7), jcfg)
    tcfg = tl.LlamaConfig(**dataclasses.asdict(jcfg))
    tparams = tl.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")

    def meta(pkg, name, dtype):
        return pkg.LMCacheEngineMetadata(model_name=name, world_size=1,
                                         worker_id=0, fmt="vllm", dtype=dtype)

    j = SimpleNamespace(
        name="jax", vocab=jcfg.vocab_size,
        paged=lambda **kw: jserving.PagedServingEngine(
            jcfg, jparams, page_size=PAGE, use_pallas=False, **kw),
        dense=lambda **kw: jserving.ServingEngine(
            jcfg, jparams, use_pallas=False, **kw),
        cache_engine=lambda name: jpkg.LMCacheEngine(
            jpkg.LMCacheEngineConfig.from_defaults(local_device="cpu",
                                                   chunk_size=CHUNK),
            meta(jpkg, name, jcfg.dtype)),
        Request=jserving.Request, Sampling=jserving.SamplingParams,
        int8_dtype=lambda eng: eng.kv_pool["sym"].dtype.name)
    t = SimpleNamespace(
        name="torch", vocab=tcfg.vocab_size,
        paged=lambda **kw: tserving.PagedServingEngine(
            tcfg, tparams, page_size=PAGE, device="cpu", **kw),
        dense=lambda **kw: tserving.ServingEngine(
            tcfg, tparams, device="cpu", **kw),
        cache_engine=lambda name: tpkg.LMCacheEngine(
            tpkg.LMCacheEngineConfig(local_device="cpu", chunk_size=CHUNK),
            meta(tpkg, name, tcfg.dtype)),
        Request=tserving.Request, Sampling=tserving.SamplingParams,
        int8_dtype=lambda eng: str(eng.kv_pool["sym"].dtype).split(".")[-1])
    return j, t, tcfg, tparams


def _prompt(vocab, n, seed):
    return np.random.default_rng(seed).integers(0, vocab, n, dtype=np.int32)


def _tokens(reqs):
    return [list(r.output_tokens) for r in reqs]


def _both(sides, scenario):
    """Run ``scenario(side)`` on the JAX package and on the port; the two
    results must be equal. Returns the port's."""
    j, t = sides[0], sides[1]
    want, got = scenario(j), scenario(t)
    assert got == want
    return got


def test_paged_matches_dense(sides):
    def scenario(s):
        prompts = [_prompt(s.vocab, n, i) for i, n in enumerate((21, 45, 9))]
        golden = s.dense(max_batch=2, max_seq=256).generate(
            prompts, s.Sampling(max_new_tokens=6))
        eng = s.paged(max_batch=2, max_seq=256, num_pages=32)
        out = eng.generate(prompts, s.Sampling(max_new_tokens=6))
        assert _tokens(out) == _tokens(golden)
        return _tokens(out), eng.allocator.num_free

    assert _both(sides, scenario)[1] == 31  # all pages back in the arena


def test_cache_reuse_through_the_tiers(sides):
    def scenario(s):
        prompt = _prompt(s.vocab, 70, 1)
        ce = s.cache_engine("tiny-paged")
        eng = s.paged(max_batch=2, max_seq=256, num_pages=64,
                      cache_engine=ce)
        [first] = eng.generate([prompt], s.Sampling(max_new_tokens=5))
        ce.engine_.flush()
        # a fresh engine on the same tier: no resident pages, so the prefix
        # comes back by retrieve + _inject_pages
        eng2 = s.paged(max_batch=2, max_seq=256, num_pages=64,
                       cache_engine=ce)
        [second] = eng2.generate([prompt], s.Sampling(max_new_tokens=5))
        ce.close()
        assert second.output_tokens == first.output_tokens
        return _tokens([first, second]), second.cached_prefix_len

    # 70 tokens cached; capped to 69, then page-aligned down to 64
    assert _both(sides, scenario)[1] == 64


def test_resident_prefix_sharing(sides):
    """The second request shares the first one's pages (refcount 2) and
    takes none of those tokens from a cache tier: there is none."""
    def scenario(s):
        common = _prompt(s.vocab, 64, 10)  # 4 pages
        pa = np.concatenate([common, _prompt(s.vocab, 16, 11)])
        pb = np.concatenate([common, _prompt(s.vocab, 16, 12)])
        eng = s.paged(max_batch=2, max_seq=256, num_pages=32)
        a = s.Request(pa, s.Sampling(max_new_tokens=30))
        eng.add_request(a)
        while not a.output_tokens:
            eng.step()
        pages_a = list(eng._req_pages[a.request_id])
        b = s.Request(pb, s.Sampling(max_new_tokens=4))
        eng.add_request(b)
        eng.step()  # admits b
        pages_b = list(eng._req_pages[b.request_id])
        assert pages_b[:4] == pages_a[:4] and pages_b[4] not in pages_a
        rc = [eng.allocator.refcount(p) for p in pages_a[:4]]
        shared = eng._req_shared[b.request_id]
        eng.run()
        solo = s.dense(max_batch=1, max_seq=256)
        golden = [solo.generate([p], s.Sampling(max_new_tokens=n))[0]
                  for p, n in ((pa, 30), (pb, 4))]
        assert _tokens([a, b]) == _tokens(golden)
        return (_tokens([a, b]), rc, shared, b.cached_prefix_len,
                eng.allocator.num_free)

    _, rc, shared, cached, free = _both(sides, scenario)
    assert rc == [2, 2, 2, 2] and shared == 64 and cached == 64
    assert free == 31  # everything freed exactly once


def test_wholly_resident_prompt_of_whole_pages(sides):
    """A prompt that is an exact multiple of the page size and wholly
    resident: the match is capped one page short, so the request recomputes
    its last page and writes only pages of its own while it reads the
    shared ones."""
    def scenario(s):
        prompt = _prompt(s.vocab, 64, 20)  # exactly 4 pages
        eng = s.paged(max_batch=2, max_seq=256, num_pages=32)
        [a] = eng.generate([prompt], s.Sampling(max_new_tokens=5))
        a_pages = [p for p, h in eng._page_hash.items()]
        b = s.Request(prompt, s.Sampling(max_new_tokens=5))
        eng.add_request(b)
        eng.step()
        own = eng._req_pages[b.request_id][3:]
        assert not set(own) & set(a_pages)
        eng.run()
        assert b.output_tokens == a.output_tokens
        return _tokens([a, b]), b.cached_prefix_len, eng.allocator.num_free

    assert _both(sides, scenario)[1:] == (48, 31)


def test_arena_as_cache_and_eviction_on_realloc(sides):
    def scenario(s):
        eng = s.paged(max_batch=1, max_seq=128, num_pages=8)
        p1 = _prompt(s.vocab, 48, 22)
        [a] = eng.generate([p1], s.Sampling(max_new_tokens=4))
        [again] = eng.generate([p1], s.Sampling(max_new_tokens=4))
        # churn: a prompt large enough to recycle every free page
        eng.generate([_prompt(s.vocab, 96, 23)], s.Sampling(max_new_tokens=4))
        [b] = eng.generate([p1], s.Sampling(max_new_tokens=4))
        assert a.output_tokens == again.output_tokens == b.output_tokens
        return _tokens([a]), again.cached_prefix_len, b.cached_prefix_len

    # freed pages are reclaimed zero-copy; recycled ones are not served
    assert _both(sides, scenario)[1:] == (32, 0)


def test_arena_backpressure(sides):
    """More work than pages: requests run (partly) one after another but
    all finish, and the arena never double-allocates."""
    def scenario(s):
        prompts = [_prompt(s.vocab, 40, 30 + i) for i in range(4)]
        # each request needs ceil((40+8)/16) = 3 pages; 7 are usable
        eng = s.paged(max_batch=4, max_seq=128, num_pages=8)
        out = eng.generate(prompts, s.Sampling(max_new_tokens=8))
        golden = s.dense(max_batch=4, max_seq=128).generate(
            prompts, s.Sampling(max_new_tokens=8))
        assert _tokens(out) == _tokens(golden)
        return _tokens(out), eng.allocator.num_free

    assert _both(sides, scenario)[1] == 7


def test_arena_too_small_raises(sides):
    for s in sides[:2]:
        eng = s.paged(max_batch=1, max_seq=128, num_pages=2)
        eng.add_request(s.Request(np.arange(40, dtype=np.int32),
                                  s.Sampling(max_new_tokens=8)))
        with pytest.raises(MemoryError, match="needs 3 pages"):
            eng.run()


def test_preemption_exact_resume(sides):
    """Decode growth exhausts the arena: the newest request is evicted to
    the cache tier and resumes later with the greedy output of an arena
    large enough, bit for bit in fp32."""
    def scenario(s):
        pa, pb = _prompt(s.vocab, 40, 5), _prompt(s.vocab, 40, 6)
        ce = s.cache_engine("tiny-preempt")
        eng = s.paged(max_batch=2, max_seq=128, num_pages=8,
                      cache_engine=ce)
        a = s.Request(pa, s.Sampling(max_new_tokens=40))
        b = s.Request(pb, s.Sampling(max_new_tokens=40))
        eng.add_request(a)
        eng.add_request(b)
        eng.run()
        ce.close()
        roomy = s.paged(max_batch=2, max_seq=128, num_pages=32)
        golden = roomy.generate([pa, pb], s.Sampling(max_new_tokens=40))
        assert _tokens([a, b]) == _tokens(golden)
        assert [r.num_preemptions for r in golden] == [0, 0]
        return (_tokens([a, b]), a.num_preemptions, b.num_preemptions,
                b.cached_prefix_len, eng.allocator.num_free)

    _, pre_a, pre_b, _, free = _both(sides, scenario)
    assert pre_a == 0 and pre_b >= 1  # 7 pages cannot hold both at 80 tokens
    assert free == 7  # all pages returned


def test_no_cache_engine_reserves_worst_case(sides):
    """Without a cache tier preemption is impossible: admission reserves
    prompt + max_new, so over-commit backpressures instead of failing in
    mid-decode, and only a request that can never fit raises."""
    def scenario(s):
        eng = s.paged(max_batch=2, max_seq=128, num_pages=8)
        reqs = eng.generate([_prompt(s.vocab, 40, 7), _prompt(s.vocab, 40, 8)],
                            s.Sampling(max_new_tokens=40))
        eng2 = s.paged(max_batch=2, max_seq=128, num_pages=8)
        eng2.add_request(s.Request(_prompt(s.vocab, 80, 9),
                                   s.Sampling(max_new_tokens=40)))  # 8 > 7
        with pytest.raises(MemoryError):
            eng2.run()
        return _tokens(reqs), eng.allocator.num_free

    toks, free = _both(sides, scenario)
    assert [len(t) for t in toks] == [40, 40] and free == 7


def test_int8_arena_matches_jax_int8_engine(sides):
    """int8 page arena: the JAX int8 paged engine's greedy tokens, and cache
    reuse through quantize-on-inject."""
    def scenario(s):
        prompt = _prompt(s.vocab, 70, 7)
        ce = s.cache_engine("tiny-pq")
        eng = s.paged(max_batch=2, max_seq=256, num_pages=32,
                      cache_engine=ce, kv_dtype="int8")
        assert s.int8_dtype(eng) == "int8"
        [r1] = eng.generate([prompt], s.Sampling(max_new_tokens=6))
        ce.engine_.flush()
        eng2 = s.paged(max_batch=2, max_seq=256, num_pages=32,
                       cache_engine=ce, kv_dtype="int8")
        [r2] = eng2.generate([prompt], s.Sampling(max_new_tokens=6))
        ce.close()
        return (_tokens([r1, r2]), r2.cached_prefix_len,
                eng.allocator.num_free)

    toks, cached, free = _both(sides, scenario)
    assert cached == 64 and free == 31
    assert toks[0] == toks[1]


def test_int8_preemption_resumes(sides):
    """Preemption out of an int8 arena stores dequantized KV and
    re-quantizes it on resume; both packages take the same path."""
    def scenario(s):
        ce = s.cache_engine("tiny-pq-preempt")
        eng = s.paged(max_batch=2, max_seq=128, num_pages=8,
                      cache_engine=ce, kv_dtype="int8")
        reqs = eng.generate([_prompt(s.vocab, 40, 15),
                             _prompt(s.vocab, 40, 16)],
                            s.Sampling(max_new_tokens=40))
        ce.close()
        return (_tokens(reqs), [r.num_preemptions for r in reqs],
                eng.allocator.num_free)

    _, pre, free = _both(sides, scenario)
    assert pre[1] >= 1 and free == 7


def test_read_pages_is_a_copy_and_inject_round_trips(sides):
    _, t, tcfg, _ = sides
    for kv_dtype in ("native", "int8"):
        eng = t.paged(max_batch=1, max_seq=64, num_pages=6,
                      kv_dtype=kv_dtype)
        rng = np.random.default_rng(0)
        blob = torch.from_numpy(rng.standard_normal(
            (tcfg.n_layers, 2, 2 * PAGE, tcfg.n_kv_heads,
             tcfg.head_dim)).astype(np.float32))
        eng._inject_pages(blob, [4, 2])
        back = eng._read_pages([4, 2])
        if kv_dtype == "native":
            torch.testing.assert_close(back, blob, atol=0, rtol=0)
            back.zero_()
            torch.testing.assert_close(eng._read_pages([4, 2]), blob,
                                       atol=0, rtol=0)
        else:  # one quantization step: half a step of absmax / 127
            step = blob.abs().amax(dim=(3, 4), keepdim=True) / 127
            assert ((back - blob).abs() <= step / 2 + 1e-6).all()
        eng.page_tables[0, :2] = [4, 2]
        torch.testing.assert_close(eng._read_slot(0, 20), back[:, :, :20]
                                   if kv_dtype == "int8" else blob[:, :, :20],
                                   atol=0, rtol=0)


@pytest.mark.parametrize("kw, item", [(dict(mesh=FakeMesh(1, 2, 1)),
                                       "shard_metadata")], ids=["mesh"])
def test_unported_options_raise(sides, kw, item):
    """On a mesh that splits the kv heads, a cache engine whose metadata
    does not name this rank's head slice is refused (it would store the
    slice under another worker's keys)."""
    t = sides[1]
    with pytest.raises(ValueError, match=f"head slice 1 of 2.*{item}"):
        t.paged(num_pages=8, cache_engine=t.cache_engine("m"), **kw)


def test_unported_requests_and_chunks_raise(sides):
    t = sides[1]
    # CacheBlend is ported (tests/test_torch_blend.py): without a cache
    # tier a blend request is refused at admission, as in the JAX engine
    blend = t.Request(np.arange(4, dtype=np.int32),
                      t.Sampling(max_new_tokens=4),
                      context_chunks=[np.arange(4, dtype=np.int32)])
    no_tier = t.paged(max_batch=1, max_seq=64, num_pages=8)
    no_tier.add_request(blend)
    with pytest.raises(ValueError, match="need a cache_engine"):
        no_tier.run()
    eng = t.paged(max_batch=1, max_seq=64, num_pages=8)

    class HostChunkTier:  # hands back neither a tensor nor a host chunk
        chunk_size = CHUNK

        def retrieve_stream(self, tokens, mask=None):
            yield object(), 0, CHUNK

    eng.cache_engine = HostChunkTier()
    eng.add_request(t.Request(np.arange(40, dtype=np.int32),
                              t.Sampling(max_new_tokens=4)))
    with pytest.raises(ValueError, match="neither a tensor nor a host chunk"):
        eng.run()


def test_page_size_must_divide_chunk_size(sides):
    t = sides[1]
    ce = t.cache_engine("tiny-bad-page")
    with pytest.raises(ValueError, match="page_size must divide"):
        tserving.PagedServingEngine(sides[2], sides[3], page_size=24,
                                    cache_engine=ce, device="cpu")
    ce.close()


def test_default_device_raises_without_cuda(sides):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserving.PagedServingEngine(sides[2], sides[3], num_pages=8)


def test_phi3_geometry_runs_on_the_paged_engine_only(sides):
    """A D 96 model with a sliding window: the paged engine serves it (the
    window bites: 40 + 8 tokens against a window of 24), the JAX paged
    engine gives the same tokens, and so does the dense engine, which runs
    the window too."""
    jcfg = jl.LlamaConfig.tiny(n_layers=2, dim=384, sliding_window=24)
    jparams = jl.init_params(jax.random.PRNGKey(9), jcfg)
    tcfg = tl.LlamaConfig(**dataclasses.asdict(jcfg))
    tparams = tl.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
    prompts = [_prompt(jcfg.vocab_size, n, 40 + n) for n in (40, 23)]
    kw = dict(max_batch=2, max_seq=128, num_pages=16, page_size=PAGE)
    for kv_dtype in ("native", "int8"):
        jout = jserving.PagedServingEngine(
            jcfg, jparams, use_pallas=False, kv_dtype=kv_dtype,
            **kw).generate(prompts, jserving.SamplingParams(max_new_tokens=8))
        tout = tserving.PagedServingEngine(
            tcfg, tparams, device="cpu", kv_dtype=kv_dtype,
            **kw).generate(prompts, tserving.SamplingParams(max_new_tokens=8))
        assert _tokens(tout) == _tokens(jout)
        dense = tserving.ServingEngine(
            tcfg, tparams, device="cpu", kv_dtype=kv_dtype, max_batch=2,
            max_seq=128).generate(
                prompts, tserving.SamplingParams(max_new_tokens=8))
        assert _tokens(dense) == _tokens(tout)
