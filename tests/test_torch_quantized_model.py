"""The port's ``forward_quantized`` (int8 dense pool) and its windowed dense
``forward`` against the JAX package's, on the same weights (JAX
``init_params`` carried across with ``params_from_jax``) and tokens, on the
CPU in fp32.

Tolerances. Logits of the bf16-free dense forward: 1e-4, as
``tests/test_torch_llama.py``. The int8 pool: the K/V that get quantized
come out of each framework's own matrix products, which differ by fp32
summation order, and the compiled JAX forward computes ``absmax / 127`` as a
product with the reciprocal, so the scales agree within ``RTOL_SCALE`` in
the first layer and ``RTOL_SCALE_DEEP`` in later layers (their inputs went
through the earlier layers' attention), as in ``tests/test_torch_paged.py``;
a value on a rounding tie may then land on the neighbouring symbol, in at
most ``MAX_SYMBOL_FLIPS`` of the pool; the logits agree within
``ATOL_INT8`` (one flipped symbol moves a K or V entry by one step of
about 0.03).
"""

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
ATOL_INT8 = 2e-3
RTOL_SCALE = 1e-6
RTOL_SCALE_DEEP = 1e-5
MAX_SYMBOL_FLIPS = 1e-4


def _model(seed=0, **traits):
    jcfg = jl.LlamaConfig.tiny(n_layers=2, **traits)
    jparams = jl.init_params(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    if "sinks" in tree["layers"]:  # zero-initialised: make them count
        tree["layers"]["sinks"] = np.random.default_rng(seed).standard_normal(
            tree["layers"]["sinks"].shape).astype(np.float32) * 2.0
    tcfg = tl.LlamaConfig(**dataclasses.asdict(jcfg))
    tparams = tl.params_from_jax(tree, tcfg, device="cpu")
    tokens = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (B, T), dtype=np.int32)
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, tparams, tokens


@pytest.fixture(scope="module")
def model():
    return _model()


def _jq(jcfg, jparams, tokens, start, pool, use_pallas=False):
    return jl.forward_quantized(jparams, jcfg, jnp.asarray(tokens),
                                jnp.asarray(start, jnp.int32), pool,
                                use_pallas=use_pallas)


def _tq(tcfg, tparams, tokens, start, pool, **kw):
    return tl.forward_quantized(tparams, tcfg,
                                torch.from_numpy(tokens).long(),
                                torch.as_tensor(start, dtype=torch.int32),
                                pool, **kw)


def _hold_pool(tpool, jpool, n_tokens):
    """Symbols equal up to the tie allowance, scales within theirs."""
    tsym, jsym = tpool["sym"].numpy(), np.asarray(jpool["sym"])
    diff = np.abs(tsym.astype(np.int32) - jsym.astype(np.int32))
    assert diff.max() <= 1
    assert (diff != 0).sum() <= MAX_SYMBOL_FLIPS * diff.size
    tsc, jsc = tpool["scale"].numpy(), np.asarray(jpool["scale"])
    np.testing.assert_allclose(tsc[0], jsc[0], rtol=RTOL_SCALE, atol=0)
    np.testing.assert_allclose(tsc[1:], jsc[1:], rtol=RTOL_SCALE_DEEP,
                               atol=0)
    assert (tsc[..., n_tokens:] == 1).all()  # unwritten scales stay 1


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["reference", "pallas_interpret"])
def test_forward_quantized_prefill(model, use_pallas):
    jcfg, jparams, tcfg, tparams, tokens = model
    jlog, jpool = _jq(jcfg, jparams, tokens, np.zeros(B),
                      jl.new_quantized_kv_cache(jcfg, B, S), use_pallas)
    tpool = tl.new_quantized_kv_cache(tcfg, B, S, device="cpu")
    tlog, out = _tq(tcfg, tparams, tokens, np.zeros(B), tpool)
    assert out is tpool  # written in place
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=ATOL_INT8, rtol=ATOL_INT8)
    _hold_pool(tpool, jpool, T)


def test_forward_quantized_prefill_over_a_prefix_and_decode(model):
    """Prefill 16 tokens, then the other 8 over them, then one ragged
    decode step, each against the JAX function on its own pool."""
    jcfg, jparams, tcfg, tparams, tokens = model
    P = 16
    jpool = jl.new_quantized_kv_cache(jcfg, B, S)
    tpool = tl.new_quantized_kv_cache(tcfg, B, S, device="cpu")
    _, jpool = _jq(jcfg, jparams, tokens[:, :P], np.zeros(B), jpool)
    _tq(tcfg, tparams, tokens[:, :P], np.zeros(B), tpool)
    jlog, jpool = _jq(jcfg, jparams, tokens[:, P:], np.full(B, P), jpool)
    tlog, _ = _tq(tcfg, tparams, tokens[:, P:], np.full(B, P), tpool)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=ATOL_INT8, rtol=ATOL_INT8)
    _hold_pool(tpool, jpool, T)
    # the suffix attends to the quantized prefix: equal to one full prefill
    full, _ = _tq(tcfg, tparams, tokens, np.zeros(B),
                  tl.new_quantized_kv_cache(tcfg, B, S, device="cpu"))
    np.testing.assert_allclose(tlog.numpy(), full[:, P:].numpy(), atol=1e-5,
                               rtol=1e-5)

    nxt = np.asarray([[7], [300]], np.int32)
    start = np.asarray([T, 10], np.int32)  # row 1 rewinds: ragged decode
    jstep, jpool = _jq(jcfg, jparams, nxt, start, jpool)
    tstep, _ = _tq(tcfg, tparams, nxt, start, tpool)
    assert tstep.shape == (B, 1, tcfg.vocab_size)
    np.testing.assert_allclose(tstep.numpy(), np.asarray(jstep),
                               atol=ATOL_INT8, rtol=ATOL_INT8)
    _hold_pool(tpool, jpool, T + 1)


def test_forward_quantized_attends_to_the_quantized_new_tokens(model):
    """The new tokens are written quantized first and read back from the
    pool: the logits differ from attention over their unquantized K/V (the
    dense forward), and equal the plain attention over the pool."""
    _, _, tcfg, tparams, tokens = model
    qlog, pool = _tq(tcfg, tparams, tokens, np.zeros(B),
                     tl.new_quantized_kv_cache(tcfg, B, S, device="cpu"))
    dlog, _ = tl.forward(tparams, tcfg, torch.from_numpy(tokens).long(),
                         torch.zeros(B, dtype=torch.int32),
                         tl.new_kv_cache(tcfg, B, S, device="cpu"))
    assert 1e-4 < (qlog - dlog).abs().max() < 0.5
    plain, _ = _tq(tcfg, tparams, tokens, np.zeros(B),
                   tl.new_quantized_kv_cache(tcfg, B, S, device="cpu"),
                   use_kernel=False, last_logit_only=True)
    np.testing.assert_allclose(plain.numpy(), qlog[:, -1:].numpy(),
                               atol=1e-5, rtol=1e-5)


def test_forward_quantized_on_a_slot_view_parks_idle_rows(model):
    """A slot view of a larger pool is written in place, and a decode row
    parked at the horizon (position S) leaves positions below S alone."""
    _, _, tcfg, tparams, tokens = model
    pool = tl.new_quantized_kv_cache(tcfg, 3, S + 1, device="cpu")
    view = {k: v[:, :, 1:2] for k, v in pool.items()}
    _tq(tcfg, tparams, tokens[:1], np.zeros(1), view)
    assert pool["sym"][:, :, 1, :, :T].any()
    assert not pool["sym"][:, :, 0].any() and not pool["sym"][:, :, 2].any()
    before = {k: v.clone() for k, v in pool.items()}
    step = np.asarray([[1], [2], [3]], np.int32)
    _tq(tcfg, tparams, step, np.asarray([S, T, S]), pool)
    for name in ("sym", "scale"):
        ax = -2 if name == "sym" else -1
        changed = (pool[name] != before[name]).movedim(ax, 0).flatten(1).any(1)
        assert changed[S] and changed[T] and int(changed.sum()) == 2


def test_quantized_pool_from_jax(model):
    jcfg, jparams, tcfg, tparams, tokens = model
    _, jpool = _jq(jcfg, jparams, tokens, np.zeros(B),
                   jl.new_quantized_kv_cache(jcfg, B, S))
    tpool = tl.quantized_pool_from_jax(jax.tree.map(np.asarray, jpool),
                                       device="cpu")
    assert tpool["sym"].dtype == torch.int8
    assert tpool["scale"].dtype == torch.float32
    np.testing.assert_array_equal(tpool["sym"].numpy(),
                                  np.asarray(jpool["sym"]))
    np.testing.assert_array_equal(tpool["scale"].numpy(),
                                  np.asarray(jpool["scale"]))
    # one decode step of both packages on the same symbols
    nxt = tokens[:, :1]
    jstep, _ = _jq(jcfg, jparams, nxt, np.full(B, T), jpool)
    tstep, _ = _tq(tcfg, tparams, nxt, np.full(B, T), tpool)
    np.testing.assert_allclose(tstep.numpy(), np.asarray(jstep), atol=ATOL,
                               rtol=ATOL)
    fresh = tl.new_quantized_kv_cache(tcfg, B, S, device="cpu")
    jfresh = jl.new_quantized_kv_cache(jcfg, B, S)
    for name in ("sym", "scale"):
        assert fresh[name].shape == jfresh[name].shape
        np.testing.assert_array_equal(fresh[name].numpy(),
                                      np.asarray(jfresh[name]))


# the attention patterns of the dense forwards; the window cuts (24 tokens
# against windows of 8 and 16)
PATTERNS = {
    "uniform_window": dict(sliding_window=8),
    "alternating": dict(sliding_window=8, sliding_window_pattern=2),
    "layer_map": dict(sliding_window=8, global_layer_map=(True, False)),
    "chunked": dict(sliding_window=16, local_attention_kind="chunked"),
    "chunked_alternating": dict(sliding_window=16, sliding_window_pattern=2,
                                local_attention_kind="chunked"),
    "softcap": dict(attn_logit_softcap=5.0, query_pre_attn_scalar=16.0),
    "sinks": dict(attn_sinks=True, sliding_window=8,
                  sliding_window_pattern=2),
}


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_dense_forward_patterns_match_jax(name):
    """Prefill, then a prefill over it, then decode, against the JAX
    ``forward(use_pallas=False)``."""
    jcfg, jparams, tcfg, tparams, tokens = _model(3, **PATTERNS[name])
    P = 16
    jcache = jl.new_kv_cache(jcfg, B, S)
    tcache = tl.new_kv_cache(tcfg, B, S, device="cpu")
    for toks, start in ((tokens[:, :P], np.zeros(B)),
                        (tokens[:, P:], np.full(B, P)),
                        (tokens[:, :1], np.full(B, T))):
        jlog, jcache = jl.forward(jparams, jcfg, jnp.asarray(toks),
                                  jnp.asarray(start, jnp.int32), jcache,
                                  use_pallas=False)
        tlog, _ = tl.forward(tparams, tcfg, torch.from_numpy(toks).long(),
                             torch.as_tensor(start, dtype=torch.int32),
                             tcache)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(tcache.numpy(), np.asarray(jcache),
                               atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("name", ["uniform_window", "alternating", "chunked",
                                  "softcap", "sinks"])
def test_forward_quantized_patterns_match_jax(name):
    jcfg, jparams, tcfg, tparams, tokens = _model(4, **PATTERNS[name])
    jlog, jpool = _jq(jcfg, jparams, tokens, np.zeros(B),
                      jl.new_quantized_kv_cache(jcfg, B, S))
    tpool = tl.new_quantized_kv_cache(tcfg, B, S, device="cpu")
    tlog, _ = _tq(tcfg, tparams, tokens, np.zeros(B), tpool)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=ATOL_INT8, rtol=ATOL_INT8)
    _hold_pool(tpool, jpool, T)


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_patterns_change_the_logits(name):
    """Each pattern is load-bearing: the same weights without it give other
    logits (so a dropped option would show above)."""
    _, _, tcfg, tparams, tokens = _model(3, **PATTERNS[name])
    plain_cfg = tl.LlamaConfig.tiny(n_layers=2)
    args = (torch.from_numpy(tokens).long(),
            torch.zeros(B, dtype=torch.int32))
    with_it, _ = tl.forward(tparams, tcfg, *args,
                            tl.new_kv_cache(tcfg, B, S, device="cpu"))
    without, _ = tl.forward(tparams, plain_cfg, *args,
                            tl.new_kv_cache(plain_cfg, B, S, device="cpu"))
    assert (with_it - without).abs().max() > 1e-3


def test_layer_windows_follow_the_jax_dispatch():
    for traits, want in (
            (dict(), [None, None, None, None]),
            (dict(sliding_window=8), [8, 8, 8, 8]),
            (dict(sliding_window=8, sliding_window_pattern=2),
             [8, None, 8, None]),
            (dict(sliding_window=8, sliding_window_pattern=4),
             [8, 8, 8, None]),
            (dict(sliding_window=8,
                  global_layer_map=(True, False, False, True)),
             [None, 8, 8, None])):
        tcfg = tl.LlamaConfig.tiny(**traits)
        assert tl._layer_windows(tcfg) == want
        jcfg = jl.LlamaConfig.tiny(**traits)
        assert [None if g else jcfg.sliding_window
                for g in jcfg.layer_windows()] == want


def test_init_params_carries_sinks():
    cfg = tl.LlamaConfig.tiny(n_layers=3, attn_sinks=True)
    params = tl.init_params(cfg, device="cpu")
    assert params["layers"]["sinks"].shape == (3, cfg.n_heads)
    assert not params["layers"]["sinks"].any()
    assert "sinks" not in tl.init_params(tl.LlamaConfig.tiny(n_layers=1),
                                         device="cpu")["layers"]


def test_int8_dense_mistral_window_end_to_end():
    """forward_quantized under a window tracks the dense forward under the
    same window (int8 noise) and differs from the windowless int8 forward."""
    jcfg, jparams, tcfg, tparams, _ = _model(2, sliding_window=16)
    tokens = np.random.default_rng(12).integers(0, tcfg.vocab_size, (B, 40),
                                                dtype=np.int32)
    args = (torch.from_numpy(tokens).long(),
            torch.zeros(B, dtype=torch.int32))
    ref, _ = tl.forward(tparams, tcfg, *args,
                        tl.new_kv_cache(tcfg, B, S, device="cpu"))
    out, _ = tl.forward_quantized(
        tparams, tcfg, *args,
        tl.new_quantized_kv_cache(tcfg, B, S, device="cpu"))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=0.5, rtol=0.1)
    jout, _ = _jq(jcfg, jparams, tokens, np.zeros(B),
                  jl.new_quantized_kv_cache(jcfg, B, S))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                               atol=ATOL_INT8, rtol=ATOL_INT8)
    full_cfg = tl.LlamaConfig.tiny(n_layers=2)
    full, _ = tl.forward_quantized(
        tparams, full_cfg, *args,
        tl.new_quantized_kv_cache(full_cfg, B, S, device="cpu"))
    assert not np.allclose(out.numpy(), full.numpy(), atol=0.05)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bfloat16", "float16"])
def test_int8_pool_survives_store_back_and_inject(dtype):
    """K/V that were quantized from 16-bit values come back symbol for
    symbol and scale for scale when the pool is stored dequantized to that
    type and injected again: a token's absmax, and with it 127 * scale, is
    exact in the type, and |symbol| * 2**-9 stays below half a step."""
    cfg = tl.LlamaConfig.tiny(n_layers=2)
    rng = np.random.default_rng(5)
    blob = torch.from_numpy(rng.standard_normal(
        (cfg.n_layers, 2, T, cfg.n_kv_heads, cfg.head_dim)).astype(
            np.float32)).to(dtype)
    blob[0, 1, 3] = 0  # an all-zero token: scale 1 / 127, symbols 0
    first = tl.blob_into_quantized_cache(
        tl.new_quantized_kv_cache(cfg, B, S, device="cpu"), blob, b=1, pos=8)
    again = tl.blob_into_quantized_cache(
        tl.new_quantized_kv_cache(cfg, B, S, device="cpu"),
        tl.quantized_cache_to_blob(first, 1, 8 + T, dtype)[:, :, 8:], b=1,
        pos=8)
    assert first["sym"][:, :, 1, :, 8:8 + T].abs().max() == 127
    assert first["scale"][0, 1, 1, 8 + 3] == np.float32(1) / np.float32(127)
    assert torch.equal(again["sym"], first["sym"])
    assert torch.equal(again["scale"], first["scale"])
