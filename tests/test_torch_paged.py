"""The port's paged model (``models/paged.py``) against the JAX package's on
the CPU in fp32: the same weights, the same page arena (carried across with
``paged_pool_from_jax``) and the same page table go through one prefill step
and one decode step of both. Logits agree within ``ATOL_LOGITS`` (``use_pallas
=False``) or ``ATOL_INTERPRET`` (the Pallas kernels in interpret mode), and
the updated arenas are equal.

For an int8 arena the quantization rule itself is held to the last bit on
identical inputs (``test_quantize_tokens_matches_jax_rule``: symbols equal,
scales bit-equal). In the two-step comparison the K/V that get quantized come
out of each framework's own matrix products, which differ by fp32 summation
order, so a value that sits on a rounding tie may land on the neighbouring
symbol: symbols may differ by 1 in at most ``MAX_SYMBOL_FLIPS`` of the arena,
scales agree within ``RTOL_SCALE`` in the first layer and
``RTOL_SCALE_DEEP`` in later layers (their inputs went through the earlier
layers' attention)."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from lmcache_tpu.models import llama as jl  # noqa: E402
from lmcache_tpu.models import paged as jp  # noqa: E402
from lmcache_tpu_torch.models import llama as tl  # noqa: E402
from lmcache_tpu_torch.models import paged as tp  # noqa: E402
from torch_test_helpers import (FakeMesh,  # noqa: E402,F401
                                one_torch_thread)

ATOL_LOGITS = 1e-4
ATOL_INTERPRET = 2e-3
ATOL_ARENA = 1e-5
RTOL_SCALE = 1e-6
RTOL_SCALE_DEEP = 1e-5
MAX_SYMBOL_FLIPS = 1e-4  # share of the arena's symbols

PAGE, NUM_PAGES, NP = 16, 12, 4
CONFIGS = {
    "d64": dict(),  # dim 256 / 4 heads: the streaming kernels' head dim
    "d96": dict(dim=384),  # the one-page-per-step kernels' head dim
    "d64_window": dict(sliding_window=24),
    "d96_window": dict(dim=384, sliding_window=24),
}


def _model(name):
    jcfg = jl.LlamaConfig.tiny(n_layers=2, **CONFIGS[name])
    jparams = jl.init_params(jax.random.PRNGKey(3), jcfg)
    tcfg = tl.LlamaConfig(**dataclasses.asdict(jcfg))
    tparams = tl.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
    return jcfg, jparams, tcfg, tparams


def _arena(cfg, quant, seed=0):
    """A numpy arena that already holds something on every page."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, 2, NUM_PAGES, cfg.n_kv_heads, PAGE, cfg.head_dim)
    if quant:
        return {"sym": rng.integers(-127, 128, shape).astype(np.int8),
                "scale": rng.uniform(0.01, 0.05, shape[:3] + (PAGE,)).astype(
                    np.float32)}
    return rng.standard_normal(shape).astype(np.float32)


def _two_steps(name, quant, use_pallas):
    """Prefill 37 and 20 tokens at offsets 0 and 16 (over a page of
    existing KV), then decode one token; returns both packages' logits of
    both steps and their final arenas as numpy."""
    jcfg, jparams, tcfg, tparams = _model(name)
    rng = np.random.default_rng(1)
    arena = _arena(jcfg, quant)
    table = np.asarray([[3, 7, 1, 9], [2, 11, 5, 4]], np.int32)
    tok = rng.integers(0, jcfg.vocab_size, (2, 37)).astype(np.int32)
    tok[1, 20:] = 0
    start = np.asarray([0, 16], np.int32)
    nxt = rng.integers(0, jcfg.vocab_size, (2, 1)).astype(np.int32)

    jfwd = jp.forward_paged_quantized if quant else jp.forward_paged
    tfwd = tp.forward_paged_quantized if quant else tp.forward_paged
    jpool = jax.tree.map(jnp.asarray, arena)
    tpool = tl.paged_pool_from_jax(arena, device="cpu")
    jl1, jpool = jfwd(jparams, jcfg, jnp.asarray(tok), jnp.asarray(start),
                      jpool, jnp.asarray(table), use_pallas=use_pallas)
    jl2, jpool = jfwd(jparams, jcfg, jnp.asarray(nxt),
                      jnp.asarray(start + 37), jpool, jnp.asarray(table),
                      use_pallas=use_pallas)
    tl1, out = tfwd(tparams, tcfg, torch.from_numpy(tok),
                    torch.from_numpy(start), tpool, torch.from_numpy(table))
    assert out is tpool  # updated in place
    tl2, _ = tfwd(tparams, tcfg, torch.from_numpy(nxt),
                  torch.from_numpy(start + 37), tpool,
                  torch.from_numpy(table), last_logit_only=True)
    return ([np.asarray(jl1), np.asarray(jl2)], [tl1.numpy(), tl2.numpy()],
            jax.tree.map(np.asarray, jpool),
            jax.tree.map(lambda t: t.numpy(), tpool))


def _same_arena(jpool, tpool, quant):
    if quant:
        diff = np.abs(tpool["sym"].astype(np.int32) - jpool["sym"])
        assert diff.max() <= 1
        assert (diff != 0).mean() <= MAX_SYMBOL_FLIPS
        np.testing.assert_allclose(tpool["scale"][0], jpool["scale"][0],
                                   rtol=RTOL_SCALE, atol=0)
        np.testing.assert_allclose(tpool["scale"][1:], jpool["scale"][1:],
                                   rtol=RTOL_SCALE_DEEP, atol=0)
    else:
        np.testing.assert_allclose(tpool, jpool, atol=ATOL_ARENA, rtol=0)


@pytest.mark.parametrize("quant", [False, True], ids=["native", "int8"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_paged_matches_jax(name, quant):
    jlog, tlog, jpool, tpool = _two_steps(name, quant, use_pallas=False)
    for j, t in zip(jlog, tlog):
        np.testing.assert_allclose(t, j, atol=ATOL_LOGITS, rtol=ATOL_LOGITS)
    _same_arena(jpool, tpool, quant)


@pytest.mark.parametrize("name, quant", [("d64", False), ("d96_window", True)],
                         ids=["d64_native_dma", "d96_window_int8_grid"])
def test_forward_paged_matches_jax_pallas_interpret(name, quant):
    """``use_pallas=True`` on the CPU runs the Pallas kernel the head dim
    selects in interpret mode: the streaming kernel for D 64, the
    one-page-per-step kernel for D 96."""
    jlog, tlog, jpool, tpool = _two_steps(name, quant, use_pallas=True)
    for j, t in zip(jlog, tlog):
        np.testing.assert_allclose(t, j, atol=ATOL_INTERPRET,
                                   rtol=ATOL_INTERPRET)
    _same_arena(jpool, tpool, quant)


def test_kernel_choice_follows_head_dim():
    for D, streams in ((64, True), (128, True), (256, True), (32, True),
                       (96, False), (80, False), (192, False)):
        cfg = tl.LlamaConfig.tiny(dim=4 * D)
        assert cfg.head_dim == D
        assert tp._streams(cfg) is streams


def test_paged_matches_dense_forward():
    """Within the port: the paged forward over a fresh arena gives the dense
    forward's logits, and the pages hold the dense cache's rows."""
    _, _, cfg, params = _model("d64")
    rng = np.random.default_rng(2)
    B, T = 2, 40
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T)))
    zero = torch.zeros(B, dtype=torch.int32)
    dense_logits, cache = tl.forward(
        params, cfg, tokens, zero, tl.new_kv_cache(cfg, B, NP * PAGE,
                                                   device="cpu"))
    pool = tp.new_paged_kv_pool(cfg, NUM_PAGES, PAGE, device="cpu")
    alloc = tp.PageAllocator(NUM_PAGES)
    table = torch.tensor([alloc.alloc(NP) for _ in range(B)],
                         dtype=torch.int32)
    logits, _ = tp.forward_paged(params, cfg, tokens, zero, pool, table)
    torch.testing.assert_close(logits, dense_logits, atol=ATOL_LOGITS,
                               rtol=ATOL_LOGITS)
    # use_kernel=False names the plain attention outright (what a CPU
    # arena gets anyway); it rewrites the same K/V and gives the same logits
    plain, _ = tp.forward_paged(params, cfg, tokens, zero, pool, table,
                                use_kernel=False)
    torch.testing.assert_close(plain, logits, atol=0, rtol=0)
    for b in range(B):
        for j in range(NP):
            lo, hi = j * PAGE, min((j + 1) * PAGE, T)
            if hi > lo:
                torch.testing.assert_close(
                    pool[:, :, int(table[b, j]), :, :hi - lo],
                    cache[:, :, b, :, lo:hi], atol=ATOL_ARENA, rtol=0)


def test_new_pools():
    cfg = tl.LlamaConfig.tiny(n_layers=3)
    pool = tp.new_paged_kv_pool(cfg, 5, 16, device="cpu")
    assert pool.shape == (3, 2, 5, cfg.n_kv_heads, 16, cfg.head_dim)
    assert pool.dtype == torch.float32 and not pool.any()
    q = tp.new_quantized_paged_pool(cfg, 5, 16, device="cpu")
    assert q["sym"].shape == pool.shape and q["sym"].dtype == torch.int8
    assert q["scale"].shape == (3, 2, 5, 16)
    assert (q["scale"] == 1).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tp.new_paged_kv_pool(cfg, 5, 16)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tp.new_quantized_paged_pool(cfg, 5, 16)


def test_quantize_tokens_matches_jax_rule():
    """Half-to-even rounding, an all-zero token's scale of 1/127, clipping:
    symbols equal and scales equal to the last bit."""
    rng = np.random.default_rng(4)
    t = rng.standard_normal((2, 5, 2, 8)).astype(np.float32)
    t[0, 1] = 0.0  # absmax 0
    t[1, 2] = np.round(t[1, 2] * 4) / 8 * 127  # ties after the division
    t32 = jnp.asarray(t)
    absmax = jnp.max(jnp.abs(t32), axis=(2, 3))
    scale = jnp.where(absmax == 0.0, 1.0, absmax) / 127.0
    sym = jnp.clip(jnp.round(t32 / scale[:, :, None, None]), -127,
                   127).astype(jnp.int8)
    tsym, tscale = tp.quantize_tokens(torch.from_numpy(t), (2, 3))
    np.testing.assert_array_equal(tsym.numpy(), np.asarray(sym))
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(scale))
    assert float(tscale[0, 1]) == np.float32(1.0) / np.float32(127.0)


def test_allocator():
    alloc = tp.PageAllocator(8)
    assert alloc.num_free == 7  # page 0 reserved
    a = alloc.alloc(3)
    assert len(set(a)) == 3 and 0 not in a
    alloc.free(a)
    assert alloc.num_free == 7
    with pytest.raises(MemoryError):
        alloc.alloc(8)
    assert tp.pages_needed(65, 32) == 3
    assert tp.pages_needed(64, 32) == 2


def test_allocator_sharing_and_reclaim_match_jax():
    """The same operations on both packages' allocators give the same pages,
    refcounts and free counts."""
    ja, ta = jp.PageAllocator(8), tp.PageAllocator(8)
    log = []
    for alloc in (ja, ta):
        a = alloc.alloc(3)
        alloc.share(a[:2])
        freed1 = alloc.free(a)  # the shared pages stay live
        rc = [alloc.refcount(p) for p in a]
        freed2 = alloc.free(a[:2])
        alloc.reclaim([a[0]])  # content intact: pulled back by id
        b = alloc.alloc(2)  # least-recently-freed first
        log.append((a, freed1, rc, freed2, b, alloc.num_free,
                    alloc.refcount(a[0])))
        with pytest.raises(ValueError):
            alloc.reclaim([a[0]])  # live: share() it instead
        with pytest.raises(ValueError):
            alloc.share([7])  # never allocated
        with pytest.raises(ValueError):
            alloc.free([0])  # the null page
    assert log[0] == log[1]
    assert log[1][1] == [log[1][0][2]] and log[1][2] == [1, 1, 0]


@pytest.mark.parametrize("quant", [False, True], ids=["native", "int8"])
def test_options_left_out_raise(quant):
    fwd = tp.forward_paged_quantized if quant else tp.forward_paged
    new = tp.new_quantized_paged_pool if quant else tp.new_paged_kv_pool
    tok = torch.zeros((1, 2), dtype=torch.long)
    zero = torch.zeros(1, dtype=torch.int32)
    table = torch.ones((1, 2), dtype=torch.int32)

    def run(mesh=None, **trait):
        cfg = tl.LlamaConfig.tiny(n_layers=1, **trait)
        params = tl.init_params(tl.LlamaConfig.tiny(n_layers=1),
                                device="cpu")
        return fwd(params, cfg, tok, zero, new(cfg, 4, 16, device="cpu"),
                   table, mesh=mesh)

    # a one-rank mesh computes what no mesh computes, bit for bit
    assert torch.equal(run(mesh=FakeMesh(1, 1, 0))[0], run()[0])
    with pytest.raises(ValueError, match="moe_style"):
        run(n_experts=4, moe_style="expert_choice")
    assert run(sliding_window=8)[0].shape == (1, 2, 512)


def test_phi3_is_served_by_the_paged_path_only():
    cfg = tl.LlamaConfig.phi3_mini_4k()
    assert cfg.head_dim == 96 and not tp._streams(cfg)
    # the dense forwards run its window as well by now; what stays with the
    # paged path is the choice of kernel by head dim
    tl.check_supported(cfg)
    assert tp._streams(tl.LlamaConfig.tinyllama_1_1b())
