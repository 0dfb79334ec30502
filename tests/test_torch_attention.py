"""The port's flash_attention on CPU (its plain path) against the JAX
package's mha_reference and its Pallas flash_attention in interpret mode,
on the same numpy inputs (fp32)."""

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
