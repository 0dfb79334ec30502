"""The port's MLA latent attention (kernel rows 8, 9 and 10) against the JAX
package, on the CPU: the plain versions against the JAX ``*_reference``
functions (fp32, atol 2e-5: the same sums in another order) and against the
Pallas kernels run in interpret mode (atol 2e-3: the kernels' online
softmax), dense and paged, native and int8, with a stale cache past
``kv_len`` and shuffled page tables. The same inputs, made from a seed with
numpy, go to both packages. The CUDA kernels themselves are held against the
plain versions on the card (``tests/test_torch_cuda_kernels.py``)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from lmcache_tpu.ops import latent_attention as jla  # noqa: E402
from lmcache_tpu.ops import paged_latent_attention as jpla  # noqa: E402
from lmcache_tpu_torch.ops import latent_attention as tla  # noqa: E402
from lmcache_tpu_torch.ops import paged_latent_attention as tpla  # noqa: E402

REF_ATOL = 2e-5
PALLAS_ATOL = 2e-3
H, R, P_ROPE = 4, 64, 16
C = R + P_ROPE  # 80, as MLAConfig.tiny
CP = 128  # its lane-padded arena width
SCALE = 0.13


def _t(a):
    return torch.from_numpy(np.array(a))  # a private, writable copy


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=atol)


def _dense_inputs(seed, B, T, S, q_off, quant):
    """q [B, T, H, C], latents [B, S, C] whose rows past each kv_len are
    stale (large values that must stay masked), int32 offsets."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, C)).astype(np.float32)
    lat = rng.standard_normal((B, S, C)).astype(np.float32)
    q_off = np.asarray(q_off, np.int32)
    kv_len = q_off + T
    for b, n in enumerate(kv_len):
        lat[b, n:] = 1e4
    if quant:
        with jax.disable_jit():
            sym, sc = jla.quantize_latents(jnp.asarray(lat))
        return q, (np.asarray(sym), np.asarray(sc)), q_off, kv_len
    return q, (lat,), q_off, kv_len


DENSE_CASES = {
    # (B, T, S, q_offset)
    "decode_ragged": (3, 1, 96, [95, 10, 0]),
    "prefill_over_prefix": (2, 9, 64, [30, 0]),
}


@pytest.mark.parametrize("quant", [False, True], ids=["native", "int8"])
@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_dense_plain_version_matches_jax_reference(case, quant):
    B, T, S, q_off = DENSE_CASES[case]
    q, lat, qo, kl = _dense_inputs(1, B, T, S, q_off, quant)
    kw = dict(rank=R, scale=SCALE)
    if quant:
        want = jla.quantized_latent_attention_reference(
            jnp.asarray(q), *map(jnp.asarray, lat), jnp.asarray(qo),
            jnp.asarray(kl), **kw)
        got = tla.quantized_latent_attention_reference(
            _t(q), *map(_t, lat), _t(qo), _t(kl), **kw)
        entry = tla.quantized_latent_flash_attention
    else:
        want = jla.latent_attention_reference(
            jnp.asarray(q), jnp.asarray(lat[0]), jnp.asarray(qo),
            jnp.asarray(kl), **kw)
        got = tla.latent_attention_reference(_t(q), _t(lat[0]), _t(qo),
                                             _t(kl), **kw)
        entry = tla.latent_flash_attention
    assert got.shape == (B, T, H, R) and got.dtype == torch.float32
    _close(got, want, REF_ATOL)
    # the entry point takes the plain version for CPU tensors, and counts
    # no kernel launch
    before = dict(entry.launches)
    _close(entry(_t(q), *map(_t, lat), _t(qo), _t(kl), **kw), want, REF_ATOL)
    assert dict(entry.launches) == before


@pytest.mark.parametrize("quant", [False, True], ids=["native", "int8"])
def test_dense_plain_version_matches_the_pallas_kernel(quant):
    """One shape (the interpret mode compiles per shape): a prefill over a
    cached prefix whose (head, token) rows cross the kernel's row blocks."""
    B, T, S = 2, 5, 300
    q, lat, qo, kl = _dense_inputs(2, B, T, S, [37, 200], quant)
    kw = dict(rank=R, scale=SCALE)
    if quant:
        want = jla.quantized_latent_flash_attention(
            jnp.asarray(q), *map(jnp.asarray, lat), jnp.asarray(qo),
            jnp.asarray(kl), block_q=1, block_k=128, interpret=True, **kw)
        got = tla.quantized_latent_flash_attention(
            _t(q), *map(_t, lat), _t(qo), _t(kl), **kw)
    else:
        want = jla.latent_flash_attention(
            jnp.asarray(q), jnp.asarray(lat[0]), jnp.asarray(qo),
            jnp.asarray(kl), block_q=1, block_k=128, interpret=True, **kw)
        got = tla.latent_flash_attention(_t(q), _t(lat[0]), _t(qo), _t(kl),
                                         **kw)
    _close(got, want, PALLAS_ATOL)


def test_quantize_latents_is_symbol_exact():
    """The port's quantizer is the JAX function as written (run under
    ``jax.disable_jit``; compiled, XLA's CPU backend writes ``absmax / 127``
    as a product with the reciprocal, one fp32 ulp off), zero tokens
    included."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((3, 40, C)) * rng.uniform(0.01, 30, (3, 40, 1))
         ).astype(np.float32)
    x[1, 7] = 0.0
    with jax.disable_jit():
        sym, sc = jla.quantize_latents(jnp.asarray(x))
    tsym, tsc = tla.quantize_latents(_t(x))
    assert tsym.dtype == torch.int8 and tsc.dtype == torch.float32
    np.testing.assert_array_equal(tsym.numpy(), np.asarray(sym))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(sc))
    np.testing.assert_array_equal(
        tla.dequantize_latents(tsym, tsc).numpy(),
        np.asarray(jla.dequantize_latents(sym, sc)))


def test_dead_rows_give_zero_from_the_entry_points():
    """A sequence that sees no key: the JAX reference averages the values
    uniformly, the port's entry points (and kernels) give 0 as the Pallas
    kernels do."""
    q, lat, qo, _ = _dense_inputs(4, 2, 3, 32, [0, 5], False)
    kl = np.asarray([0, 8], np.int32)
    out = tla.latent_flash_attention(_t(q), _t(lat[0]), _t(qo), _t(kl),
                                     rank=R, scale=SCALE)
    assert (out[0] == 0).all()
    want = jla.latent_attention_reference(
        jnp.asarray(q), jnp.asarray(lat[0]), jnp.asarray(qo),
        jnp.asarray(kl), rank=R, scale=SCALE)
    _close(out[1], np.asarray(want)[1], REF_ATOL)


# ------------------------------------------------------------- paged rows ---

def _paged_inputs(seed, B, T, page, q_off, quant, P=24):
    """A lane-padded arena [P, page, CP] (pad columns zero, rows past each
    kv_len stale), a shuffled page table whose dead slots hold live ids of
    other sequences, queries at the logical width C and zero-padded to CP
    (what the JAX forward passes)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, C)).astype(np.float32)
    pool = rng.standard_normal((P, page, CP)).astype(np.float32)
    pool[..., C:] = 0.0
    q_off = np.asarray(q_off, np.int32)
    kv_len = q_off + T
    NP = -(-int(kv_len.max()) // page) + 1
    ids = rng.permutation(np.arange(1, P))[:B * NP].reshape(B, NP)
    table = ids.astype(np.int32)
    for b, n in enumerate(kv_len):
        live = -(-int(n) // page)
        off = int(n) % page
        if off:
            pool[table[b, live - 1], off:, :C] = 1e4  # stale tail
        table[b, live:] = table[(b + 1) % B, 0]
    q_pad = np.pad(q, ((0, 0), (0, 0), (0, 0), (0, CP - C)))
    if quant:
        with jax.disable_jit():
            sym, sc = jla.quantize_latents(jnp.asarray(pool))
        arena = (np.asarray(sym), np.asarray(sc))
    else:
        arena = (pool,)
    return q, q_pad, arena, table, q_off, kv_len


PAGED_CASES = {
    # (B, T, page, q_offset)
    "decode_ragged": (3, 1, 16, [60, 17, 0]),
    "prefill_over_prefix": (2, 7, 16, [40, 3]),
}
# (port entry, JAX entry, int8)
PAGED_ENTRIES = {
    "grid_native": ("paged_latent_attention", False),
    "grid_int8": ("quantized_paged_latent_attention", True),
    "dma_native": ("paged_latent_attention_dma", False),
    "dma_int8": ("quantized_paged_latent_attention_dma", True),
}


@pytest.mark.parametrize("quant", [False, True], ids=["native", "int8"])
@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_paged_plain_versions_match_jax_reference(case, quant):
    B, T, page, q_off = PAGED_CASES[case]
    q, q_pad, arena, table, qo, kl = _paged_inputs(5, B, T, page, q_off,
                                                   quant)
    kw = dict(rank=R, scale=SCALE)
    jref = (jpla.quantized_paged_latent_attention_reference if quant
            else jpla.paged_latent_attention_reference)
    tref = (tpla.quantized_paged_latent_attention_reference if quant
            else tpla.paged_latent_attention_reference)
    want = jref(jnp.asarray(q_pad), *map(jnp.asarray, arena),
                jnp.asarray(table), jnp.asarray(qo), jnp.asarray(kl), **kw)
    # the port's query at the logical width, or padded as the JAX one
    for qq in (q, q_pad):
        got = tref(_t(qq), *map(_t, arena), _t(table), _t(qo), _t(kl), **kw)
        _close(got, want, REF_ATOL)


@pytest.mark.parametrize("kind", sorted(PAGED_ENTRIES))
def test_paged_entry_points_match_the_pallas_kernels(kind):
    """Each of the four paged entry points on CPU tensors (its plain
    version) against its Pallas kernel in interpret mode, one shape each:
    decode rows over ragged lengths and a shuffled table."""
    name, quant = PAGED_ENTRIES[kind]
    q, q_pad, arena, table, qo, kl = _paged_inputs(6, 3, 1, 16, [60, 17, 0],
                                                   quant)
    kw = dict(rank=R, scale=SCALE)
    want = getattr(jpla, name)(jnp.asarray(q_pad), *map(jnp.asarray, arena),
                               jnp.asarray(table), jnp.asarray(qo),
                               jnp.asarray(kl), interpret=True, **kw)
    entry = getattr(tpla, name)
    before = dict(entry.launches)
    got = entry(_t(q), *map(_t, arena), _t(table), _t(qo), _t(kl), **kw)
    assert got.shape == (3, 1, H, R)
    assert dict(entry.launches) == before
    _close(got, want, PALLAS_ATOL)


def test_paged_dead_rows_give_zero():
    q, _, arena, table, qo, kl = _paged_inputs(7, 2, 2, 16, [0, 9], False)
    kl = np.asarray([0, 11], np.int32)
    out = tpla.paged_latent_attention_dma(_t(q), _t(arena[0]), _t(table),
                                          _t(qo), _t(kl), rank=R,
                                          scale=SCALE)
    assert (out[0] == 0).all() and (out[1] != 0).any()
