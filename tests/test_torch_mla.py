"""The port's MLA model (``lmcache_tpu_torch.models.mla``) against the JAX
package's, on the CPU in fp32: the same weights (the JAX ``init_params``
carried across with ``params_from_jax``), the same tokens and pools. Logits
and the written latent pool must agree within 1e-4 for a prefill and then a
decode step, for every gate (``greedy``, ``group_limited_greedy`` and V3's
``noaux_tc`` with yarn and a low-rank query), over the native and the int8
pool (int8 symbols exactly), and the paged forward must agree with the dense
one and with the JAX paged forward."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from lmcache_tpu.models import mla as jm  # noqa: E402
from lmcache_tpu.ops import latent_attention as jla  # noqa: E402
from lmcache_tpu_torch.models import mla as tm  # noqa: E402
from torch_test_helpers import (FakeMesh,  # noqa: E402,F401
                                one_torch_thread)

ATOL = 1e-4
TINY = dict(n_layers=3, n_routed_experts=4, n_shared_experts=1,
            n_experts_per_tok=2, moe_hidden_dim=64, first_k_dense_replace=1)
GATES = {
    "greedy": {},
    "group_limited_greedy": dict(topk_method="group_limited_greedy",
                                 n_group=2, topk_group=1),
    "v3_noaux_tc_yarn": dict(
        arch="v3", topk_method="noaux_tc", n_routed_experts=8, n_group=4,
        topk_group=2, norm_topk_prob=True, routed_scaling_factor=2.5,
        q_lora_rank=48, rope_scaling_type="yarn", rope_scaling_factor=40.0,
        rope_mscale=1.0, rope_mscale_all_dim=1.0, rope_original_max_seq=64),
}


@pytest.fixture(scope="module", params=sorted(GATES))
def model(request):
    """(JAX cfg, JAX params, port cfg, port params) of one gate; V3's
    selection bias is made non-zero so that it steers the groups."""
    jcfg = jm.MLAConfig.tiny(**dict(TINY, **GATES[request.param]))
    jparams = jm.init_params(jax.random.PRNGKey(7), jcfg)
    if "router_bias" in jparams["moe_layers"]:
        bias = np.random.default_rng(3).standard_normal(
            jparams["moe_layers"]["router_bias"].shape) * 0.1
        jparams["moe_layers"]["router_bias"] = jnp.asarray(bias, jnp.float32)
    tcfg = tm.MLAConfig(**dataclasses.asdict(jcfg))
    tparams = tm.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
    return jcfg, jparams, tcfg, tparams


def _np(x):
    if isinstance(x, dict):
        return {k: np.asarray(v) for k, v in x.items()}
    return np.asarray(x)


def _pools_agree(got, want):
    """Written pools: latents within ATOL; int8 symbols equal, scales
    within one part in 1e5."""
    if isinstance(want, dict):
        np.testing.assert_array_equal(got["sym"].numpy(), want["sym"])
        np.testing.assert_allclose(got["scale"].numpy(), want["scale"],
                                   rtol=1e-5)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("quant", [False, True], ids=["native", "int8"])
def test_forward_prefill_then_decode_matches_jax(model, quant):
    jcfg, jparams, tcfg, tparams = model
    B, T, S = 2, 12, 32
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    start = np.asarray([0, 3], np.int32)
    if quant:
        jc = jm.new_quantized_latent_cache(jcfg, B, S)
        tc = tm.new_quantized_latent_cache(tcfg, B, S, device="cpu")
    else:
        jc = jm.new_latent_cache(jcfg, B, S)
        tc = tm.new_latent_cache(tcfg, B, S, device="cpu")
    for step in range(2):
        jl, jc = jm.forward(jparams, jcfg, jnp.asarray(toks),
                            jnp.asarray(start), jc)
        tl, tc2 = tm.forward(tparams, tcfg, torch.as_tensor(toks),
                             torch.as_tensor(start), tc)
        assert tc2 is tc  # written in place
        assert tl.shape == (B, toks.shape[1], jcfg.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=ATOL)
        _pools_agree(tc, _np(jc))
        # then one decode token per row
        start = start + toks.shape[1]
        toks = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)


@pytest.mark.parametrize("quant", [False, True], ids=["native", "int8"])
def test_forward_paged_matches_dense_and_jax(model, quant):
    """The paged forward on a lane-padded arena equals the dense forward
    (logits, and the pages' latents vs the slots'), and the JAX paged
    forward; its arena carries across with paged_latent_pool_from_jax."""
    jcfg, jparams, tcfg, tparams = model
    B, T, page, P, NP = 2, 12, 8, 16, 6
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    start = np.zeros(B, np.int32)
    table = np.zeros((B, NP), np.int32)
    table[0, :2] = [5, 2]
    table[1, :2] = [9, 4]
    new = (tm.new_quantized_paged_latent_pool if quant
           else tm.new_paged_latent_pool)
    jnew = (jm.new_quantized_paged_latent_pool if quant
            else jm.new_paged_latent_pool)
    pool = new(tcfg, P, page, device="cpu")
    dense = (tm.new_quantized_latent_cache if quant
             else tm.new_latent_cache)(tcfg, B, 32, device="cpu")
    dl, _ = tm.forward(tparams, tcfg, torch.as_tensor(toks),
                       torch.as_tensor(start), dense)
    pl_, _ = tm.forward_paged(tparams, tcfg, torch.as_tensor(toks),
                              torch.as_tensor(start), pool,
                              torch.as_tensor(table))
    np.testing.assert_allclose(pl_.numpy(), dl.numpy(), atol=ATOL, rtol=ATOL)
    # compiled, XLA's CPU backend writes the int8 quantizer's absmax / 127
    # as a product with the reciprocal, so a compiled JAX scale can sit one
    # fp32 ulp from the division the sources state and a symbol on a
    # rounding tie can move (these tokens put one there); the port is held
    # to the JAX function as written
    def as_written():
        return jax.disable_jit() if quant else contextlib.nullcontext()

    with as_written():
        jl, jpool = jm.forward_paged(jparams, jcfg, jnp.asarray(toks),
                                     jnp.asarray(start), jnew(jcfg, P, page),
                                     jnp.asarray(table))
    np.testing.assert_allclose(pl_.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=ATOL)
    _pools_agree(pool, _np(jpool))
    # the JAX arena carried across: one decode step on each side
    carried = tm.paged_latent_pool_from_jax(_np(jpool), device="cpu")
    t1 = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
    s1 = start + T
    with as_written():
        jl1, _ = jm.forward_paged(jparams, jcfg, jnp.asarray(t1),
                                  jnp.asarray(s1), jpool, jnp.asarray(table))
    tl1, _ = tm.forward_paged(tparams, tcfg, torch.as_tensor(t1),
                              torch.as_tensor(s1), carried,
                              torch.as_tensor(table))
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), atol=ATOL,
                               rtol=ATOL)


def test_params_and_pools_carry_across_unchanged():
    jcfg = jm.MLAConfig.tiny(**dict(TINY, **GATES["v3_noaux_tc_yarn"]))
    jparams = jm.init_params(jax.random.PRNGKey(1), jcfg)
    tcfg = tm.MLAConfig(**dataclasses.asdict(jcfg))
    tree = jax.tree.map(np.asarray, jparams)
    tparams = tm.params_from_jax(tree, tcfg, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    for path, leaf in flat:
        got = tparams
        for key in path:
            got = got[key.key]
        assert got.dtype == torch.float32  # the tiny config's dtype
        np.testing.assert_array_equal(got.numpy(), leaf)
    # the port's own init draws the same tree layout and shapes
    own = tm.init_params(tcfg, device="cpu")
    assert (jax.tree.map(np.shape, tree)
            == jax.tree.map(lambda t: tuple(t.shape), own))
    # a bf16 config keeps router_bias in fp32
    bf = dataclasses.replace(tcfg, dtype="bfloat16")
    assert tm.params_from_jax(tree, bf, device="cpu")["moe_layers"][
        "router_bias"].dtype == torch.float32
    # pools: the tensor and the int8 dict
    jc = jm.new_latent_cache(jcfg, 2, 8) + 0.5
    assert torch.equal(tm.latent_pool_from_jax(np.asarray(jc), "cpu"),
                       torch.full((3, 2, 8, jcfg.latent_dim), 0.5))
    jq = jm.new_quantized_paged_latent_pool(jcfg, 4, 8)
    tq = tm.paged_latent_pool_from_jax(_np(jq), "cpu")
    assert tq["sym"].dtype == torch.int8 and tq["sym"].shape == (
        3, 4, 8, tm.latent_pad_dim(tcfg))
    assert tm.latent_pad_dim(tcfg) == jm.latent_pad_dim(jcfg) == 128


def test_blobs_round_trip_through_both_pools():
    """cache_to_blob / blob_into_cache on the native pool and their int8
    counterparts: the wire blob is [L, 1, T, 1, C], the native round trip
    exact, the int8 one quantizes as the JAX engine's inject does."""
    cfg = tm.MLAConfig.tiny(n_layers=2)
    rng = np.random.default_rng(2)
    blob = torch.as_tensor(rng.standard_normal(
        (2, 1, 10, 1, cfg.latent_dim)).astype(np.float32))
    pool = tm.new_latent_cache(cfg, 3, 16, device="cpu")
    tm.blob_into_cache(pool, blob, 1, 4)
    view = tm.cache_to_blob(pool, 1, 14)
    assert view.shape == (2, 1, 14, 1, cfg.latent_dim)
    assert view.data_ptr() == pool[:, 1].data_ptr()  # a view
    assert torch.equal(view[:, :, 4:], blob)
    qpool = tm.new_quantized_latent_cache(cfg, 3, 16, device="cpu")
    tm.blob_into_quantized_cache(qpool, blob, 2, 0)
    with jax.disable_jit():
        jsym, _ = jla.quantize_latents(jnp.asarray(blob.numpy()[:, 0, :, 0]))
    np.testing.assert_array_equal(qpool["sym"][:, 2, :10].numpy(),
                                  np.asarray(jsym))
    out = tm.quantized_cache_to_blob(qpool, 2, 10, torch.float32)
    assert out.shape == blob.shape
    np.testing.assert_allclose(out.numpy(), blob.numpy(),
                               atol=float(blob.abs().max()) / 127)


def test_config_properties_and_presets_match_jax():
    for name in ("tiny", "deepseek_v2_lite", "deepseek_v2", "deepseek_v3"):
        jcfg, tcfg = getattr(jm.MLAConfig, name)(), getattr(tm.MLAConfig,
                                                            name)()
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        for prop in ("qk_head_dim", "latent_dim", "sm_scale",
                     "rope_scaling_spec", "n_dense_layers"):
            assert getattr(jcfg, prop) == getattr(tcfg, prop), (name, prop)
    lite = tm.MLAConfig.deepseek_v2_lite()
    assert lite.latent_dim == 576 and tm.latent_pad_dim(lite) == 640


def test_unported_parts_raise():
    cfg = tm.MLAConfig.tiny(n_layers=1)
    with pytest.raises(ValueError, match="not a local checkpoint"):
        tm.MLAConfig.from_hf("deepseek-ai/DeepSeek-V2-Lite")
    with pytest.raises(ValueError, match="not a local checkpoint"):
        tm.load_hf("deepseek-ai/DeepSeek-V2-Lite")
    params = tm.init_params(cfg, device="cpu")
    toks = torch.zeros((1, 2), dtype=torch.long)
    zero = torch.zeros(1, dtype=torch.int32)
    # a mesh whose "model" axis does not divide the query heads: the latent
    # kernels run on a rank's H / tp heads (tests/test_torch_parallel.py)
    mesh = FakeMesh(1, 3, 0)
    with pytest.raises(ValueError, match="divide the mesh"):
        tm.forward(params, cfg, toks, zero,
                   tm.new_latent_cache(cfg, 1, 8, device="cpu"), mesh=mesh)
    with pytest.raises(ValueError, match="divide the mesh"):
        tm.forward_paged(params, cfg, toks, zero,
                         tm.new_paged_latent_pool(cfg, 2, 8, device="cpu"),
                         torch.ones((1, 1), dtype=torch.int32),
                         mesh=mesh)
    with pytest.raises(TypeError, match="MLAConfig"):
        tm.check_supported(object())

