"""CacheBlend for MLA models (``lmcache_tpu_torch/blend_mla.py``) and the
MLA engines' blend admission against the JAX package, on the CPU in fp32:
the same weights (JAX ``init_params`` carried across), the same chunks.

Anchors, as in ``tests/test_blend_mla.py``: layer-0 latents shifted by
delta equal the latents prefilled at delta, the compressed slice untouched;
``recompute_ratio=1.0`` is an exact full prefill (a dense first layer, then
MoE layers through the port's padded expert blocks); partial recompute is
closer to the full prefill than naive reuse. Beyond those, the port's
logits and healed latents equal the JAX function's within 1e-4 (the MLA
model tests' bound: the JAX MoE runs every expert on every token, the port
only the routed ones), and the engines give the JAX engines' greedy tokens.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import lmcache_tpu as jpkg  # noqa: E402
from lmcache_tpu import blend_mla as jbm  # noqa: E402
from lmcache_tpu.models import mla as jm  # noqa: E402
from lmcache_tpu.serving import MLAServingEngine as JDense  # noqa: E402
from lmcache_tpu.serving import Request as JRequest  # noqa: E402
from lmcache_tpu.serving import SamplingParams as JSampling  # noqa: E402
from lmcache_tpu.serving.mla_paged_engine import \
    MLAPagedServingEngine as JPaged  # noqa: E402
import lmcache_tpu_torch as tpkg  # noqa: E402
from lmcache_tpu_torch import blend_mla as tbm  # noqa: E402
from lmcache_tpu_torch.models import mla as tm  # noqa: E402
from lmcache_tpu_torch.serving import (MLAPagedServingEngine,  # noqa: E402
                                       MLAServingEngine, Request,
                                       SamplingParams)


# every test of this file on one torch thread (an autouse fixture)
from torch_test_helpers import one_torch_thread  # noqa: E402,F401


ATOL = 1e-4
GOLD = 2e-3  # blend at ratio 1.0 vs a full prefill (the JAX tests' bound)


@pytest.fixture(scope="module")
def setup():
    # a dense first layer, then MoE: pass 2 crosses the dense/MoE boundary
    jcfg = jm.MLAConfig.tiny(n_layers=3, n_routed_experts=4,
                             n_shared_experts=1, n_experts_per_tok=2,
                             moe_hidden_dim=64, first_k_dense_replace=1)
    jparams = jm.init_params(jax.random.PRNGKey(7), jcfg)
    tcfg = tm.MLAConfig(**dataclasses.asdict(jcfg))
    tparams = tm.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
    return jcfg, jparams, tcfg, tparams


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _prefill(tcfg, tparams, tokens, start=0):
    cache = tm.new_latent_cache(tcfg, 1, start + len(tokens), device="cpu")
    logits, _ = tm.forward(tparams, tcfg, _t(tokens).long()[None],
                           torch.tensor([start], dtype=torch.int32), cache)
    return logits, cache


def _blob(tcfg, tparams, tokens):
    return tm.cache_to_blob(_prefill(tcfg, tparams, tokens)[1], 0,
                            len(tokens)).contiguous()


def _jax_prefill(jcfg, jparams, tokens):
    cache = jm.new_latent_cache(jcfg, 1, len(tokens))
    logits, cache = jm.forward(jparams, jcfg, jnp.asarray(tokens)[None],
                               jnp.zeros(1, jnp.int32), cache,
                               use_pallas=False)
    return logits, cache


def test_latent_shift_matches_shifted_prefill(setup):
    jcfg, _, tcfg, tparams = setup
    tokens = np.random.default_rng(0).integers(0, tcfg.vocab_size, 12,
                                               dtype=np.int32)
    delta = 17
    lat0 = _prefill(tcfg, tparams, tokens)[1][0, 0, :12]
    latd = _prefill(tcfg, tparams, tokens, start=delta)[1][0, 0,
                                                           delta:delta + 12]
    shifted = tbm.shift_latent_positions(lat0, torch.full((12,),
                                                          float(delta)), tcfg)
    torch.testing.assert_close(shifted, latd, atol=1e-5, rtol=0)
    r = tcfg.kv_lora_rank
    assert torch.equal(shifted[..., :r], lat0[..., :r])
    want = jbm.shift_latent_positions(jnp.asarray(lat0.numpy()),
                                      jnp.full((12,), float(delta)), jcfg)
    np.testing.assert_allclose(shifted.numpy(), np.asarray(want), atol=1e-6)


@pytest.fixture(scope="module")
def blend_case(setup):
    jcfg, jparams, tcfg, tparams = setup
    rng = np.random.default_rng(1)
    chunks = [rng.integers(0, tcfg.vocab_size, n, dtype=np.int32)
              for n in (24, 32, 24)]
    full = np.concatenate(chunks)
    logits, cache = _jax_prefill(jcfg, jparams, full)
    blended = tbm.assemble_latent_chunks(
        [_blob(tcfg, tparams, c) for c in chunks], tcfg)
    jblended = jbm.assemble_latent_chunks(
        [np.asarray(jm.cache_to_blob(_jax_prefill(jcfg, jparams, c)[1], 0,
                                     len(c))) for c in chunks], jcfg)
    np.testing.assert_allclose(blended.numpy(), np.asarray(jblended),
                               atol=ATOL)
    return (full, np.asarray(logits[0, -1]), np.asarray(cache[:, 0]),
            blended, jblended)


def test_full_recompute_is_exact(setup, blend_case):
    _, _, tcfg, tparams = setup
    full, golden_logits, golden_lat, blended, _ = blend_case
    logits, lat = tbm.mla_blend_prefill(tparams, tcfg, _t(full), blended,
                                        len(full))
    np.testing.assert_allclose(logits.numpy(), golden_logits, atol=GOLD,
                               rtol=GOLD)
    np.testing.assert_allclose(lat.numpy(), golden_lat, atol=GOLD)


@pytest.mark.parametrize("frac", [0.2, 1.0])
def test_partial_recompute_matches_jax_and_beats_naive(setup, blend_case,
                                                       frac):
    jcfg, jparams, tcfg, tparams = setup
    full, golden_logits, _, blended, jblended = blend_case
    T = len(full)
    n_rec = max(2, int(frac * T))
    logits, lat = tbm.mla_blend_prefill(tparams, tcfg, _t(full), blended,
                                        n_rec)
    jlogits, jlat = jbm.mla_blend_prefill(jparams, jcfg, jnp.asarray(full),
                                          jblended, n_rec)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(lat.numpy(), np.asarray(jlat), atol=ATOL)

    def err(lg):
        g = golden_logits / np.linalg.norm(golden_logits)
        return np.linalg.norm(g - lg / np.linalg.norm(lg))

    naive, _ = tbm.mla_blend_prefill(tparams, tcfg, _t(full), blended, 1)
    if n_rec == T:
        assert err(logits.numpy()) < 1e-3
    else:
        assert err(logits.numpy()) < err(naive.numpy())


def _cache_engines(dtype, name, chunk_size=256):
    def make(pkg):
        return pkg.LMCacheEngine(
            pkg.LMCacheEngineConfig.from_defaults(local_device="cpu",
                                                  chunk_size=chunk_size),
            pkg.LMCacheEngineMetadata(model_name=name, world_size=1,
                                      worker_id=0, fmt="vllm", dtype=dtype))
    return make(jpkg), make(tpkg)


def test_blender_reuses_cached_chunks(setup):
    """A second blend of the same chunks fetches every blob (misses == 0)
    and gives the same logits, the JAX blender's."""
    jcfg, jparams, tcfg, tparams = setup
    rng = np.random.default_rng(2)
    jce, tce = _cache_engines(tcfg.dtype, "mla-blend")
    tb = tbm.MLACacheBlender(tcfg, tparams, tce, recompute_ratio=0.25)
    jb = jbm.MLACacheBlender(jcfg, jparams, jce, recompute_ratio=0.25)
    docs = [rng.integers(0, tcfg.vocab_size, 16, dtype=np.int32)
            for _ in range(3)]
    logits1, blob1, info1 = tb.blend(docs)
    assert info1["misses"] == 3
    logits2, blob2, info2 = tb.blend(docs)
    assert info2["misses"] == 0
    assert torch.equal(logits1, logits2)
    assert blob1.shape == (tcfg.n_layers, 1, 48, 1, tcfg.latent_dim)
    jlogits, jblob, jinfo = jb.blend(docs)
    assert jinfo["recomputed_tokens"] == info2["recomputed_tokens"] == 12
    np.testing.assert_allclose(logits2.numpy(), np.asarray(jlogits),
                               atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(blob2.numpy(), np.asarray(jblob), atol=ATOL)
    jce.close()
    tce.close()


def _greedy(tcfg, tparams, prompt, n):
    toks = list(prompt)
    for _ in range(n):
        logits, _ = _prefill(tcfg, tparams, np.asarray(toks, np.int32))
        toks.append(int(logits[0, -1].argmax()))
    return toks[len(prompt):]


def _serve(eng, R, S, docs):
    req = R(np.empty(0, np.int32), S(max_new_tokens=5), context_chunks=docs)
    eng.add_request(req)
    eng.run()
    return req


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_blend_request_dense_engine(setup, kv_dtype):
    """context_chunks requests admit through MLA CacheBlend on the dense
    latent engine with the JAX engine's tokens; ratio 1.0 over the native
    pool gives plain greedy decoding's."""
    jcfg, jparams, tcfg, tparams = setup
    rng = np.random.default_rng(9)
    docs = [rng.integers(0, tcfg.vocab_size, 24, dtype=np.int32)
            for _ in range(3)]
    jce, tce = _cache_engines(tcfg.dtype, f"mla-blend-dense-{kv_dtype}")
    kw = dict(max_batch=2, max_seq=256, kv_dtype=kv_dtype,
              blend_recompute_ratio=1.0)
    jreq = _serve(JDense(jcfg, jparams, cache_engine=jce, use_pallas=False,
                         **kw), JRequest, JSampling, docs)
    treq = _serve(MLAServingEngine(tcfg, tparams, cache_engine=tce,
                                   device="cpu", **kw),
                  Request, SamplingParams, docs)
    assert treq.output_tokens == jreq.output_tokens
    assert treq.blended_tokens_recomputed == 72
    if kv_dtype == "native":
        assert treq.output_tokens == _greedy(tcfg, tparams,
                                             np.concatenate(docs), 5)
    jce.close()
    tce.close()


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_blend_request_paged_engine(setup, kv_dtype):
    """context_chunks requests admit through MLA CacheBlend onto the paged
    latent arena (72 tokens padded to 5 pages) with the JAX engine's
    tokens, and every page returns to the arena."""
    jcfg, jparams, tcfg, tparams = setup
    rng = np.random.default_rng(11)
    docs = [rng.integers(0, tcfg.vocab_size, 24, dtype=np.int32)
            for _ in range(3)]
    jce, tce = _cache_engines(tcfg.dtype, f"mla-blend-paged-{kv_dtype}")
    kw = dict(max_batch=2, max_seq=256, num_pages=24, page_size=16,
              kv_dtype=kv_dtype, blend_recompute_ratio=1.0)
    jreq = _serve(JPaged(jcfg, jparams, cache_engine=jce, use_pallas=False,
                         **kw), JRequest, JSampling, docs)
    teng = MLAPagedServingEngine(tcfg, tparams, cache_engine=tce,
                                 device="cpu", **kw)
    treq = _serve(teng, Request, SamplingParams, docs)
    assert treq.output_tokens == jreq.output_tokens
    assert teng.allocator.num_free == 23
    if kv_dtype == "native":
        assert treq.output_tokens == _greedy(tcfg, tparams,
                                             np.concatenate(docs), 5)
    jce.close()
    tce.close()
