"""The port's MLAServingEngine against the JAX package's, on the CPU in fp32:
the same weights (the JAX ``init_params`` carried across), the same prompts,
a CPU cache engine on each side where one is used. Greedy tokens and cached
prefix lengths must be identical in both packages (exact: no tolerance),
over the native and the int8 latent pool."""

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

CHUNK = 16


@pytest.fixture(scope="module")
def sides():
    """The two packages behind one interface: ``engine(**kw)``,
    ``cache_engine(name)``, ``Sampling``. The model has a dense first layer
    and an MoE tail, as the JAX engine's tests use."""
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
        engine=lambda **kw: jserving.MLAServingEngine(
            jcfg, jparams, use_pallas=False, **kw),
        cache_engine=lambda name: jpkg.LMCacheEngine(
            jpkg.LMCacheEngineConfig.from_defaults(local_device="cpu",
                                                   chunk_size=CHUNK),
            meta(jpkg, name)),
        Sampling=jserving.SamplingParams)
    t = SimpleNamespace(
        vocab=tcfg.vocab_size,
        engine=lambda **kw: tserving.MLAServingEngine(
            tcfg, tparams, device="cpu", **kw),
        cache_engine=lambda name: tpkg.LMCacheEngine(
            tpkg.LMCacheEngineConfig(local_device="cpu", chunk_size=CHUNK),
            meta(tpkg, name)),
        Sampling=tserving.SamplingParams)
    return j, t, tcfg, tparams


def _prompt(vocab, n, seed):
    return np.random.default_rng(seed).integers(0, vocab, n, dtype=np.int32)


def _tokens(reqs):
    return [list(r.output_tokens) for r in reqs]


def _both(sides, scenario):
    """Run ``scenario(side)`` on the JAX package and on the port; the two
    results must be equal. Returns the port's."""
    want, got = scenario(sides[0]), scenario(sides[1])
    assert got == want
    return got


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_more_requests_than_slots(sides, kv_dtype):
    def scenario(s):
        prompts = [_prompt(s.vocab, n, i) for i, n in enumerate((5, 17, 9))]
        eng = s.engine(max_batch=2, max_seq=64, kv_dtype=kv_dtype)
        out = eng.generate(prompts, s.Sampling(max_new_tokens=5))
        assert sorted(eng.free_slots) == [0, 1] and not eng.running
        return _tokens(out)

    _both(sides, scenario)


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_cache_reuse_through_the_tier(sides, kv_dtype):
    """The prompt's latent chunks are stored back, then injected into a
    fresh slot (re-quantized for the int8 pool): the same tokens."""
    def scenario(s):
        prompt = _prompt(s.vocab, 40, 11)
        ce = s.cache_engine(f"tiny-mla-{kv_dtype}")
        eng = s.engine(max_batch=2, max_seq=64, cache_engine=ce,
                       kv_dtype=kv_dtype)
        [first] = eng.generate([prompt], s.Sampling(max_new_tokens=5))
        ce.engine_.flush()  # the store-back does not block
        [again] = eng.generate([prompt], s.Sampling(max_new_tokens=5))
        ce.close()
        assert again.output_tokens == first.output_tokens
        return _tokens([first, again]), [first.cached_prefix_len,
                                         again.cached_prefix_len]

    assert _both(sides, scenario)[1] == [0, 39]


def test_int8_pool_layout_and_slot_blobs(sides):
    """The int8 pool is symbols and per-token scales; a slot reads back as a
    model-dtype latent wire blob [L, 1, n, 1, C] and injects as the model
    quantizes."""
    _, _, cfg, params = sides
    eng = tserving.MLAServingEngine(cfg, params, max_batch=2, max_seq=32,
                                    kv_dtype="int8", device="cpu")
    pool = eng.kv_pool
    assert pool["sym"].dtype == torch.int8
    assert pool["sym"].shape == (3, 2, 33, cfg.latent_dim)
    assert pool["scale"].shape == (3, 2, 33)
    blob = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, 1, 20, 1, cfg.latent_dim)).astype(np.float32))
    eng._inject(blob, 1, 4)
    back = eng._read_slot(1, 24)
    assert back.shape == (3, 1, 24, 1, cfg.latent_dim)
    assert back.dtype == torch.float32
    step = blob.abs().amax(dim=-1, keepdim=True) / 127
    assert ((back[:, :, 4:] - blob).abs() <= step / 2 + 1e-7).all()
    native = tserving.MLAServingEngine(cfg, params, max_batch=2, max_seq=32,
                                       device="cpu")
    native._inject(blob, 0, 2)
    assert torch.equal(native._read_slot(0, 22)[:, :, 2:], blob)


def test_unsupported_modes_raise(sides):
    _, _, cfg, params = sides
    with pytest.raises(ValueError, match="kv_dtype"):
        tserving.MLAServingEngine(cfg, params, max_seq=64, kv_dtype="int4",
                                  device="cpu")
    with pytest.raises(ValueError, match="divide the mesh"):
        tserving.MLAServingEngine(cfg, params, max_seq=64, device="cpu",
                                  mesh=FakeMesh(1, 3, 0))
    eng = tserving.MLAServingEngine(cfg, params, max_seq=64, device="cpu")
    req = tserving.Request(_prompt(cfg.vocab_size, 8, 0),
                           tserving.SamplingParams(max_new_tokens=2))
    # CacheBlend over MLA is ported (tests/test_torch_blend_mla.py):
    # without a cache tier a blend request is refused at admission
    req.context_chunks = [req.prompt_tokens]
    eng.add_request(req)
    with pytest.raises(ValueError, match="need a cache_engine"):
        eng.run()
    with pytest.raises(TypeError, match="MLAConfig"):
        tserving.MLAServingEngine(tpkg.models.LlamaConfig.tiny(), params,
                                  max_seq=64, device="cpu")
