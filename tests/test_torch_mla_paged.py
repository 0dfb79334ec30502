"""The port's MLAPagedServingEngine against the JAX package's, on the CPU in
fp32: the same weights (the JAX ``init_params`` carried across), the same
prompts, a CPU cache engine on each side where one is used. Greedy tokens,
cached prefix lengths, free pages and preemption counts must be identical
in both packages (exact: no tolerance), over the native and the int8 latent
arena; the paged engine must also give the dense MLA engine's tokens."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import lmcache_tpu as jpkg  # noqa: E402
from lmcache_tpu import serving as jserving  # noqa: E402
from lmcache_tpu.models import mla as jm  # noqa: E402
import lmcache_tpu_torch as tpkg  # noqa: E402
from lmcache_tpu_torch import serving as tserving  # noqa: E402
from lmcache_tpu_torch.models import mla as tm  # noqa: E402
from torch_test_helpers import (FakeMesh,  # noqa: E402,F401
                                one_torch_thread)

CHUNK = PAGE = 16


@pytest.fixture(scope="module")
def sides():
    """The two packages behind one interface: ``paged(**kw)``,
    ``dense(**kw)``, ``cache_engine(name)``, ``Request``, ``Sampling``."""
    jcfg = jm.MLAConfig.tiny(n_layers=3, n_routed_experts=4,
                             n_shared_experts=1, n_experts_per_tok=2,
                             moe_hidden_dim=64, first_k_dense_replace=1)
    jparams = jm.init_params(jax.random.PRNGKey(7), jcfg)
    tcfg = tm.MLAConfig(**dataclasses.asdict(jcfg))
    tparams = tm.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")

    def meta(pkg, name):
        return pkg.LMCacheEngineMetadata(model_name=name, world_size=1,
                                         worker_id=0, fmt="vllm",
                                         dtype=jcfg.dtype)

    j = SimpleNamespace(
        vocab=jcfg.vocab_size,
        paged=lambda **kw: jserving.MLAPagedServingEngine(
            jcfg, jparams, page_size=PAGE, use_pallas=False, **kw),
        dense=lambda **kw: jserving.MLAServingEngine(
            jcfg, jparams, use_pallas=False, **kw),
        cache_engine=lambda name: jpkg.LMCacheEngine(
            jpkg.LMCacheEngineConfig.from_defaults(local_device="cpu",
                                                   chunk_size=CHUNK),
            meta(jpkg, name)),
        Request=jserving.Request, Sampling=jserving.SamplingParams)
    t = SimpleNamespace(
        vocab=tcfg.vocab_size,
        paged=lambda **kw: tserving.MLAPagedServingEngine(
            tcfg, tparams, page_size=PAGE, device="cpu", **kw),
        dense=lambda **kw: tserving.MLAServingEngine(
            tcfg, tparams, device="cpu", **kw),
        cache_engine=lambda name: tpkg.LMCacheEngine(
            tpkg.LMCacheEngineConfig(local_device="cpu", chunk_size=CHUNK),
            meta(tpkg, name)),
        Request=tserving.Request, Sampling=tserving.SamplingParams)
    return j, t, tcfg, tparams


def _prompt(vocab, n, seed):
    return np.random.default_rng(seed).integers(0, vocab, n, dtype=np.int32)


def _tokens(reqs):
    return [list(r.output_tokens) for r in reqs]


def _both(sides, scenario):
    want, got = scenario(sides[0]), scenario(sides[1])
    assert got == want
    return got


def test_paged_matches_dense_engine(sides):
    def scenario(s):
        prompts = [_prompt(s.vocab, n, i)
                   for i, n in enumerate((21, 33, 9, 17))]
        golden = s.dense(max_batch=2, max_seq=128).generate(
            prompts, s.Sampling(max_new_tokens=6))
        eng = s.paged(max_batch=2, max_seq=128, num_pages=32)
        out = eng.generate(prompts, s.Sampling(max_new_tokens=6))
        assert _tokens(out) == _tokens(golden)
        return _tokens(out), eng.allocator.num_free

    assert _both(sides, scenario)[1] == 31  # all pages back in the arena


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_cache_reuse_onto_fresh_pages(sides, kv_dtype):
    """A fresh engine on the same tier: the prefix comes back by retrieve and
    page injection (padded, and re-quantized for the int8 arena)."""
    def scenario(s):
        prompt = _prompt(s.vocab, 40, 11)
        ce = s.cache_engine(f"mla-paged-{kv_dtype}")
        eng = s.paged(max_batch=2, max_seq=128, num_pages=32,
                      cache_engine=ce, kv_dtype=kv_dtype)
        [first] = eng.generate([prompt], s.Sampling(max_new_tokens=6))
        ce.engine_.flush()
        eng2 = s.paged(max_batch=2, max_seq=128, num_pages=32,
                       cache_engine=ce, kv_dtype=kv_dtype)
        [again] = eng2.generate([prompt], s.Sampling(max_new_tokens=6))
        ce.close()
        assert again.output_tokens == first.output_tokens
        return (_tokens([first, again]), again.cached_prefix_len,
                eng2.allocator.num_free)

    assert _both(sides, scenario)[1:] == (32, 31)


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_preemption_resumes_exactly(sides, kv_dtype):
    """An arena too small for both requests' decode growth preempts the
    newer one into the tier; it resumes and ends with a solo run's tokens."""
    def scenario(s):
        pa, pb = _prompt(s.vocab, 40, 31), _prompt(s.vocab, 40, 32)
        ce = s.cache_engine(f"mla-paged-preempt-{kv_dtype}")
        eng = s.paged(max_batch=2, max_seq=128, num_pages=8,
                      cache_engine=ce, kv_dtype=kv_dtype)
        a = s.Request(pa, s.Sampling(max_new_tokens=40))
        b = s.Request(pb, s.Sampling(max_new_tokens=40))
        eng.add_request(a)
        eng.add_request(b)
        eng.run()
        ce.close()
        solo = s.paged(max_batch=1, max_seq=128, num_pages=16,
                       kv_dtype=kv_dtype)
        golden = [solo.generate([p], s.Sampling(max_new_tokens=40))[0]
                  for p in (pa, pb)]
        if kv_dtype == "native":
            assert _tokens([a, b]) == _tokens(golden)
        return (_tokens([a, b]), [a.num_preemptions, b.num_preemptions],
                eng.allocator.num_free, _tokens(golden))

    _, preemptions, free, _ = _both(sides, scenario)
    assert preemptions[1] >= 1 and free == 7


def test_prefix_sharing_of_latent_pages(sides):
    def scenario(s):
        shared = _prompt(s.vocab, 32, 21)  # two whole pages
        pa = np.concatenate([shared, _prompt(s.vocab, 8, 22)])
        pb = np.concatenate([shared, _prompt(s.vocab, 8, 23)])
        eng = s.paged(max_batch=2, max_seq=128, num_pages=32)
        a = s.Request(pa, s.Sampling(max_new_tokens=4))
        eng.add_request(a)
        while not a.output_tokens:
            eng.step()
        pages_a = list(eng._req_pages[a.request_id])
        b = s.Request(pb, s.Sampling(max_new_tokens=4))
        eng.add_request(b)
        eng.step()
        pages_b = list(eng._req_pages[b.request_id])
        assert pages_b[:2] == pages_a[:2] and pages_b[2] != pages_a[2]
        shared_tok = eng._req_shared[b.request_id]
        eng.run()
        return _tokens([a, b]), shared_tok, b.cached_prefix_len

    assert _both(sides, scenario)[1:] == (32, 32)


def test_arena_layout_and_page_blobs(sides):
    """The arena is lane-padded ([L, P, page, 128] for C = 80); injected
    pages carry a zero pad, read pages the logical width, and the int8
    arena quantizes per token over the padded row."""
    _, _, cfg, params = sides
    C, Cp = cfg.latent_dim, tm.latent_pad_dim(cfg)
    blob = torch.randn((3, 1, 2 * PAGE, 1, C))
    for kv_dtype in ("native", "int8"):
        eng = tserving.MLAPagedServingEngine(
            cfg, params, max_seq=64, num_pages=6, page_size=PAGE,
            kv_dtype=kv_dtype, device="cpu")
        pool = eng.kv_pool["sym"] if kv_dtype == "int8" else eng.kv_pool
        assert pool.shape == (3, 6, PAGE, Cp)
        eng._inject_pages(blob, [4, 2])
        assert (pool[:, [4, 2], :, C:] == 0).all()
        back = eng._read_pages([4, 2])
        assert back.shape == blob.shape
        if kv_dtype == "native":
            assert torch.equal(back, blob)
        else:
            sym, scl = tm.quantize_latents(blob[:, 0, :, 0])
            assert torch.equal(pool[:, [4, 2]].reshape(3, 2 * PAGE, Cp)[
                ..., :C], sym)
            assert torch.equal(eng.kv_pool["scale"][:, [4, 2]].reshape(
                3, 2 * PAGE), scl)


def test_unsupported_modes_raise(sides):
    _, _, cfg, params = sides

    def engine(**kw):
        return tserving.MLAPagedServingEngine(
            cfg, params, max_seq=64, num_pages=8, page_size=PAGE,
            device="cpu", **kw)

    with pytest.raises(ValueError, match="kv_dtype"):
        engine(kv_dtype="int4")
    # a mesh whose "model" axis does not divide the query heads
    with pytest.raises(ValueError, match="divide the mesh"):
        engine(mesh=FakeMesh(1, 3, 0))
    ce = tpkg.LMCacheEngine(
        tpkg.LMCacheEngineConfig(local_device="cpu", chunk_size=24),
        tpkg.LMCacheEngineMetadata(model_name="m", world_size=1, worker_id=0,
                                   fmt="vllm", dtype=cfg.dtype))
    with pytest.raises(ValueError, match="divide"):
        engine(cache_engine=ce)
    ce.close()
    req = tserving.Request(_prompt(cfg.vocab_size, 8, 0),
                           tserving.SamplingParams(max_new_tokens=2))
    # CacheBlend over MLA is ported (tests/test_torch_blend_mla.py):
    # without a cache tier a blend request is refused at admission
    req.context_chunks = [req.prompt_tokens]
    eng = engine()
    eng.add_request(req)
    with pytest.raises(ValueError, match="need a cache_engine"):
        eng.run()
