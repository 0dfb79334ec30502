"""The port's flash_attention and flash_attention_dma on CPU (their plain
path) against the JAX package's mha_reference and its Pallas kernels in
interpret mode, on the same numpy inputs (fp32), with every option: sliding
and chunked windows, softcap, sinks, kv_slot."""

import ctypes

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from lmcache_tpu.ops import attention as jattn  # noqa: E402
from lmcache_tpu_torch.ops import attention as tattn  # noqa: E402

# (T, S, q_offset, kv_len) per scenario, batch of 2
SCENARIOS = {
    "prefill": (24, 64, [0, 0], [24, 24]),
    "prefix": (16, 64, [40, 20], [56, 36]),
    "decode": (1, 64, [63, 10], [64, 11]),
    "ragged": (8, 64, [0, 30], [5, 38]),
}


def _inputs(scenario, G, D, seed=0):
    T, S, q_off, kv_len = SCENARIOS[scenario]
    Hkv, B = 2, 2
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, G * Hkv, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)  # head-major
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    return (q, k, v, np.asarray(q_off, np.int32),
            np.asarray(kv_len, np.int32))


def _port(q, k, v, q_off, kv_len, **kw):
    out = tattn.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(q_off), torch.from_numpy(kv_len),
        kv_head_major=True, **kw)
    return out.numpy()


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_matches_jax_reference(scenario, G, D):
    q, k, v, q_off, kv_len = _inputs(scenario, G, D)
    ref = jattn.mha_reference(
        jnp.asarray(q), jnp.asarray(k.transpose(0, 2, 1, 3)),
        jnp.asarray(v.transpose(0, 2, 1, 3)), jnp.asarray(q_off),
        jnp.asarray(kv_len))
    np.testing.assert_allclose(_port(q, k, v, q_off, kv_len),
                               np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_matches_jax_flash_interpret(scenario, G, D):
    q, k, v, q_off, kv_len = _inputs(scenario, G, D, seed=1)
    out = jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_off),
        jnp.asarray(kv_len), kv_head_major=True, interpret=True)
    np.testing.assert_allclose(_port(q, k, v, q_off, kv_len),
                               np.asarray(out), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("q_off, kv_len", [([100, 0], [400, 300]),
                                           ([0, 50], [300, 120])],
                         ids=["prefix", "ragged"])
def test_matches_jax_flash_dma_interpret(q_off, kv_len):
    """The JAX package's manual-DMA variant of the same contract
    (head-major, causal, windowless; S a multiple of its K block) agrees
    with the port as well."""
    rng = np.random.default_rng(3)
    B, Hkv, G, D, S, T = 2, 2, 2, 64, 512, 300
    q = rng.standard_normal((B, T, G * Hkv, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    q_off, kv_len = (np.asarray(a, np.int32) for a in (q_off, kv_len))
    out = jattn.flash_attention_dma(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_off),
        jnp.asarray(kv_len), block_k=128, interpret=True)
    np.testing.assert_allclose(_port(q, k, v, q_off, kv_len),
                               np.asarray(out), atol=1e-4, rtol=1e-4)


def test_token_major_and_sm_scale():
    q, k, v, q_off, kv_len = _inputs("prefix", 4, 64, seed=2)
    tm = tattn.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k).transpose(1, 2),
        torch.from_numpy(v).transpose(1, 2), torch.from_numpy(q_off),
        torch.from_numpy(kv_len), sm_scale=0.07).numpy()
    ref = jattn.mha_reference(
        jnp.asarray(q), jnp.asarray(k.transpose(0, 2, 1, 3)),
        jnp.asarray(v.transpose(0, 2, 1, 3)), jnp.asarray(q_off),
        jnp.asarray(kv_len), sm_scale=0.07)
    np.testing.assert_allclose(tm, np.asarray(ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_port(q, k, v, q_off, kv_len, sm_scale=0.07),
                               tm, atol=0, rtol=0)


def test_cpu_path_counts_no_kernel_launch():
    q, k, v, q_off, kv_len = _inputs("decode", 4, 64)
    before = sum(tattn.flash_attention.launches.values())
    _port(q, k, v, q_off, kv_len)
    assert sum(tattn.flash_attention.launches.values()) == before


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    """The argument checks run before any launch (no card needed)."""
    q, k, v, q_off, kv_len = (torch.from_numpy(a)
                              for a in _inputs("prefix", 4, 64))
    with pytest.raises(ValueError, match="bfloat16"):
        tattn._check_cuda_args(q, k, v, q_off, kv_len, 2, 2, 64)
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    with pytest.raises(ValueError, match="unit stride"):
        tattn._check_cuda_args(qb, kb.transpose(2, 3), vb, q_off, kv_len,
                               2, 2, 64)
    with pytest.raises(ValueError, match="int32"):
        tattn._check_cuda_args(qb, kb, vb, q_off.long(), kv_len, 2, 2, 64)
    tattn._check_cuda_args(qb, kb, vb, q_off, kv_len, 2, 2, 64)


# ------------------------------------------------------------- the options ---
# Tolerances: 2e-5 against the JAX mha_reference (the same arithmetic in
# fp32, another summation order) and 1e-4 against the Pallas kernels in
# interpret mode, as above.


def _token_major_inputs(seed, B, T, H, D, Hkv, S):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, H, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32))


def _port_tm(q, k, v, q_off, kv_len, **kw):
    """The port's entry point on token-major K/V."""
    kw = {n: torch.from_numpy(np.asarray(a)) if n in ("sinks", "kv_slot")
          else a for n, a in kw.items()}
    return tattn.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(q_off), torch.from_numpy(kv_len), **kw).numpy()


def _both_jax(q, k, v, q_off, kv_len, block_k=256, **kw):
    """(mha_reference, flash_attention in interpret mode) of the JAX
    package on token-major K/V."""
    args = [jnp.asarray(a) for a in (q, k, v, q_off, kv_len)]
    kw = {n: jnp.asarray(a) if n == "sinks" else a for n, a in kw.items()}
    ref = jattn.mha_reference(*args, **kw)
    out = jattn.flash_attention(*args, block_q=128, block_k=block_k,
                                interpret=True, **kw)
    return np.asarray(ref), np.asarray(out)


def _hold(got, ref, out):
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, out, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("W", [16, 100, 128, 300])
@pytest.mark.parametrize("T,q_off", [(1, (700, 40)), (16, (100, 380)),
                                     (128, (0, 250))])
def test_sliding_window_matches_jax(W, T, q_off):
    q, k, v = _token_major_inputs(W + T, 2, T, 4, 64, 2, 768)
    q_off = np.asarray(q_off, np.int32)
    kv_len = q_off + T
    ref, out = _both_jax(q, k, v, q_off, kv_len, sliding_window=W)
    _hold(_port_tm(q, k, v, q_off, kv_len, sliding_window=W), ref, out)


def test_window_smaller_than_a_tile_at_the_sequence_start():
    q, k, v = _token_major_inputs(9, 1, 8, 2, 64, 1, 512)
    q_off = np.asarray([3], np.int32)
    kv_len = q_off + 8
    ref, out = _both_jax(q, k, v, q_off, kv_len, block_k=128,
                         sliding_window=4)
    _hold(_port_tm(q, k, v, q_off, kv_len, sliding_window=4), ref, out)


@pytest.mark.parametrize("C,T,q_off", [(64, 16, (100, 380)),
                                       (100, 128, (0, 250)),
                                       (128, 1, (700, 40))])
def test_chunked_window_matches_jax(C, T, q_off):
    q, k, v = _token_major_inputs(C + T, 2, T, 4, 64, 2, 768)
    q_off = np.asarray(q_off, np.int32)
    kv_len = q_off + T
    kw = dict(sliding_window=C, window_kind="chunked")
    ref, out = _both_jax(q, k, v, q_off, kv_len, **kw)
    got = _port_tm(q, k, v, q_off, kv_len, **kw)
    _hold(got, ref, out)
    # a chunk is not a trailing window of the same size
    slide = _port_tm(q, k, v, q_off, kv_len, sliding_window=C)
    assert np.abs(slide - got).max() > 1e-3


@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("T", [1, 48])
def test_softcap_matches_jax(window, T):
    q, k, v = _token_major_inputs(T + (window or 0), 2, T, 4, 64, 2, 384)
    q_off = np.asarray([200, 40], np.int32)
    kv_len = q_off + T
    kw = dict(sliding_window=window, sm_scale=0.21, logit_softcap=30.0)
    ref, out = _both_jax(q, k, v, q_off, kv_len, block_k=128, **kw)
    got = _port_tm(q, k, v, q_off, kv_len, **kw)
    _hold(got, ref, out)
    # the cap is load-bearing: the uncapped output differs
    plain = _port_tm(q, k, v, q_off, kv_len, sliding_window=window)
    assert np.abs(plain - got).max() > 1e-3


@pytest.mark.parametrize("kw", [
    dict(), dict(sliding_window=48),
    dict(sliding_window=64, window_kind="chunked", logit_softcap=20.0),
], ids=["full", "window", "chunked_softcap"])
@pytest.mark.parametrize("T,q_off", [(1, (300, 0)), (40, (100, 0))])
def test_sinks_match_jax(kw, T, q_off):
    """Sink logits large enough to take real mass, alone and combined with
    the other options; the second sequence starts at position 0."""
    q, k, v = _token_major_inputs(21 + T, 2, T, 8, 64, 2, 384)
    sinks = np.random.default_rng(5).standard_normal(8).astype(
        np.float32) * 3.0
    q_off = np.asarray(q_off, np.int32)
    kv_len = q_off + T
    ref, out = _both_jax(q, k, v, q_off, kv_len, block_k=128, sinks=sinks,
                         **kw)
    got = _port_tm(q, k, v, q_off, kv_len, sinks=sinks, **kw)
    _hold(got, ref, out)
    assert np.abs(_port_tm(q, k, v, q_off, kv_len, **kw) - got).max() > 1e-3


@pytest.mark.parametrize("slot", [0, 2, 3])
@pytest.mark.parametrize("W", [None, 48])
def test_kv_slot_matches_jax(slot, W):
    """One sequence attends to row ``kv_slot[0]`` of a head-major pool."""
    rng = np.random.default_rng(13)
    Bp, T, H, D, Hkv, S = 4, 16, 4, 64, 2, 256
    pool_k = rng.standard_normal((Bp, Hkv, S, D)).astype(np.float32)
    pool_v = rng.standard_normal((Bp, Hkv, S, D)).astype(np.float32)
    q = rng.standard_normal((1, T, H, D)).astype(np.float32)
    q_off = np.asarray([100], np.int32)
    kv_len = q_off + T
    ref = jattn.mha_reference(
        jnp.asarray(q), jnp.asarray(pool_k[slot:slot + 1].transpose(
            0, 2, 1, 3)), jnp.asarray(pool_v[slot:slot + 1].transpose(
                0, 2, 1, 3)), jnp.asarray(q_off), jnp.asarray(kv_len),
        sliding_window=W)
    out = jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(pool_k), jnp.asarray(pool_v),
        jnp.asarray(q_off), jnp.asarray(kv_len), kv_head_major=True,
        sliding_window=W, kv_slot=jnp.asarray([slot], jnp.int32),
        block_k=128, interpret=True)
    got = _port_tm(q, pool_k, pool_v, q_off, kv_len, kv_head_major=True,
                   sliding_window=W, kv_slot=np.asarray([slot], np.int32))
    _hold(got, np.asarray(ref), np.asarray(out))


def test_flash_attention_dma_matches_jax_and_flash_attention():
    """The port's streamed entry point against the JAX one in interpret
    mode, and equal to the port's flash_attention on the same inputs."""
    rng = np.random.default_rng(3)
    B, Hkv, G, D, S, T = 2, 2, 2, 64, 512, 300
    q = rng.standard_normal((B, T, G * Hkv, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    q_off = np.asarray([100, 0], np.int32)
    kv_len = np.asarray([100 + T, T], np.int32)
    out = jattn.flash_attention_dma(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_off),
        jnp.asarray(kv_len), block_k=128, interpret=True)
    args = [torch.from_numpy(a) for a in (q, k, v, q_off, kv_len)]
    before = sum(tattn.flash_attention_dma.launches.values())
    got = tattn.flash_attention_dma(*args, sm_scale=None).numpy()
    assert sum(tattn.flash_attention_dma.launches.values()) == before
    np.testing.assert_allclose(got, np.asarray(out), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(got, _port(q, k, v, q_off, kv_len))


def test_mha_reference_dead_rows_and_sinks():
    """A query that sees no key: uniform over V as in the JAX reference, 0
    with ``zero_dead_rows`` (the kernels' answer), 0 with sinks."""
    q, k, v = _token_major_inputs(2, 1, 4, 2, 64, 1, 32)
    q_off, kv_len = np.asarray([0], np.int32), np.asarray([0], np.int32)
    args = [torch.from_numpy(a) for a in (q, k, v, q_off, kv_len)]
    ref = jattn.mha_reference(*[jnp.asarray(a) for a in
                                (q, k, v, q_off, kv_len)])
    np.testing.assert_allclose(tattn.mha_reference(*args).numpy(),
                               np.asarray(ref), atol=2e-5, rtol=2e-5)
    assert not tattn.mha_reference(*args, zero_dead_rows=True).any()
    assert not tattn.mha_reference(*args, sinks=torch.zeros(2)).any()


@pytest.mark.parametrize("kw, match", [
    (dict(window_kind="banded"), "window_kind"),
    (dict(sliding_window=0), "sliding_window"),
    (dict(logit_softcap=-1.0), "logit_softcap"),
    (dict(sinks=torch.zeros(3)), "sinks"),
    (dict(kv_slot=torch.zeros(1, dtype=torch.int32)), "kv_slot"),
], ids=["kind", "window", "softcap", "sinks", "kv_slot"])
def test_bad_option_values_raise(kw, match):
    q, k, v, q_off, kv_len = (torch.from_numpy(a)
                              for a in _inputs("prefix", 4, 64))
    with pytest.raises(ValueError, match=match):
        tattn.flash_attention(q, k, v, q_off, kv_len, kv_head_major=True,
                              **kw)


def test_cuda_argument_block_holds_the_options():
    """The ctypes argument block, as the CUDA path fills it (no card
    needed): strides of a head-major slot view, the option fields, and the
    checks on the option tensors."""
    pool = torch.zeros((2, 3, 4, 96, 64), dtype=torch.bfloat16)
    q = torch.zeros((1, 5, 16, 64), dtype=torch.bfloat16)
    out = torch.empty_like(q)
    one = torch.ones(1, dtype=torch.int32)
    sinks = torch.zeros(16)
    a, Hkv, S = tattn.fill_args(q, pool[0], pool[1], out, one, one, True,
                                None, 128, "chunked", 50.0, sinks, one)
    assert (Hkv, S, a.T, a.G, a.S) == (4, 96, 5, 4, 96)
    assert (a.window, a.chunked) == (128, 1)
    assert a.softcap == 50.0 and a.scale == pytest.approx(0.125)
    assert (a.kb, a.kh, a.ks) == pool[0].stride()[:3]
    assert a.sinks == sinks.data_ptr() and a.kv_slot == one.data_ptr()
    tattn._check_cuda_args(q, pool[0], pool[1], one, one, 1, Hkv, S,
                           pool_rows=True)
    with pytest.raises(ValueError, match="does not fit"):
        tattn._check_cuda_args(q, pool[0], pool[1], one, one, 1, Hkv, S)
    with pytest.raises(ValueError, match="sinks"):
        tattn.fill_args(q, pool[0], pool[1], out, one, one, True, None,
                        sinks=sinks.double())
    with pytest.raises(ValueError, match="head dim 256"):
        big = torch.zeros((1, 2, 8, 256), dtype=torch.bfloat16)
        tattn._check_cuda_args(big, big, big, one, one, 1, 2, 8,
                               head_dims=(64, 96, 128))
    # the page-table fields, set for a paged arena only, come last
    assert ctypes.sizeof(tattn.FlashArgs) == (10 * 8 + 7 * 4 + 4 + 16 * 8
                                              + 8 + 4 * 4)
    assert not a.page_table and (a.NP, a.P, a.page, a.box) == (0, 0, 0, 0)
