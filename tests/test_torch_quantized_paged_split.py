"""The key-split decode of ``quantized_paged_attention`` and
``quantized_paged_attention_dma`` over int8 arenas (kernel rows 5 and 7 at
T * G <= ``DECODE_ROWS`` rows) in its plain version:
``quantized_paged_split_partials_reference`` then
``attention.combine_partials_reference``
(``lmcache_tpu_torch/ops/paged_attention.py``), held in fp32 against the
port's int8 paged plain version and the JAX package's
``quantized_paged_attention_reference`` and Pallas
``quantized_paged_attention`` / ``quantized_paged_attention_dma``
(interpret mode), on the same numpy inputs from a seed; and the int8 rule
that sizes the TMA box of the prefill body.

Tolerances: 2e-5 against the plain versions (fp32 on both sides, sums in
another order: partials over 256-key splits, combined); 2e-3 against the
Pallas kernels (their online softmax, with the scales applied to score and
probability columns, against the materialized one)."""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from lmcache_tpu.ops import paged_attention as jpa  # noqa: E402
from lmcache_tpu_torch.ops import attention as tattn  # noqa: E402
from lmcache_tpu_torch.ops import paged_attention as tpa  # noqa: E402

SPLIT = tattn.SPLIT_KEYS
TOL = 2e-5
PALLAS_TOL = 2e-3
HKV = 2

# name -> (T, page, q_offset, kv_len, window); batch of len(q_offset)
CASES = {
    # keys cut by the split points, one row of exactly one split, one of
    # one key and one that sees no key
    "ragged": (1, 16, [599, 255, 0, 0], [600, 256, 1, 0], None),
    # a window across split edges, and one inside a split
    "window": (1, 32, [700, 300], [701, 301], 300),
    # two tokens a row group (16 rows at G 8), windowed
    "two_tokens": (2, 16, [510, 100], [512, 102], 200),
    # a window across one split edge over few page slots (the Pallas
    # kernels in interpret mode step over every slot)
    "short": (1, 32, [300, 40], [301, 41], 100),
}


def _t(a):
    return torch.from_numpy(np.array(a))  # a private, writable copy


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=atol)


def _inputs(case, D, G, seed=0):
    """q [B, T, H, D], int8 K/V arenas [P, H_kv, page, D] and their fp32
    scale pools [P, page], whose entries past each kv_len are stale (huge
    symbols' scales), a shuffled page table whose dead slots hold live ids
    of another sequence, int32 offsets."""
    T, page, q_off, kv_len, window = CASES[case]
    B = len(q_off)
    rng = np.random.default_rng(seed)
    NP = -(-max(kv_len) // page) + 1
    P = B * NP + 2
    q = rng.standard_normal((B, T, G * HKV, D)).astype(np.float32)
    syms = [rng.integers(-127, 128, (P, HKV, page, D)).astype(np.int8)
            for _ in range(2)]
    scales = [rng.uniform(0.01, 0.05, (P, page)).astype(np.float32)
              for _ in range(2)]
    table = rng.permutation(np.arange(1, P))[:B * NP].reshape(
        B, NP).astype(np.int32)
    for b, n in enumerate(kv_len):
        live = -(-n // page)
        if n % page:
            for sc in scales:
                sc[table[b, live - 1], n % page:] = 1e4  # stale tail
        table[b, live:] = table[(b + 1) % B, 0]
    return (q, *syms, *scales, table, np.asarray(q_off, np.int32),
            np.asarray(kv_len, np.int32)), window


def _split(arrays, window):
    return tpa.quantized_paged_split_attention_reference(
        *map(_t, arrays), sliding_window=window).numpy()


@pytest.mark.parametrize("G", [1, 8])
@pytest.mark.parametrize("D", [64, 96])
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_then_combine_matches_the_plain_version(case, D, G):
    """Against the port's int8 paged plain version (0 for a row that sees
    no key)."""
    arrays, window = _inputs(case, D, G)
    want = tpa.quantized_paged_attention_reference(
        *map(_t, arrays), sliding_window=window).numpy()
    _close(_split(arrays, window), want, TOL)


@pytest.mark.parametrize("case, D, G", [("ragged", 64, 8),
                                        ("two_tokens", 96, 1)])
def test_split_then_combine_matches_the_jax_reference(case, D, G):
    """Against the JAX reference, which averages a row that sees no key
    uniformly: only the rows with keys are compared (two cases: the
    reference compiles its operations per shape)."""
    arrays, window = _inputs(case, D, G)
    got = _split(arrays, window)
    jwant = np.asarray(jpa.quantized_paged_attention_reference(
        *map(jnp.asarray, arrays), sliding_window=window))
    live = arrays[-1] > 0
    _close(got[live], jwant[live], TOL)
    assert not got[~live].any()


@pytest.mark.parametrize("name, D, G", [
    ("quantized_paged_attention", 96, 1),
    ("quantized_paged_attention_dma", 64, 8)])
def test_split_then_combine_matches_the_pallas_kernel(name, D, G):
    """One shape each (the interpret mode compiles per shape), under a
    window across a split edge: Phi-3's head dim and group (row 5), and
    tinyllama's (row 7)."""
    arrays, window = _inputs("short", D, G, seed=3)
    want = getattr(jpa, name)(*map(jnp.asarray, arrays),
                              sliding_window=window, interpret=True)
    _close(_split(arrays, window), want, PALLAS_TOL)


def test_partials_do_not_depend_on_the_batch():
    """A sequence's partials alone and beside others of other lengths: the
    same splits live, the same values."""
    arrays, window = _inputs("window", 96, 1)
    q, ks, vs, kc, vc, table, qo, kl = arrays
    together = tpa.quantized_paged_split_partials_reference(
        *map(_t, arrays), sliding_window=window)
    for b in range(len(qo)):
        alone = tpa.quantized_paged_split_partials_reference(
            _t(q[b:b + 1]), _t(ks), _t(vs), _t(kc), _t(vc),
            _t(table[b:b + 1]), _t(qo[b:b + 1]), _t(kl[b:b + 1]),
            sliding_window=window)
        for a, t in zip(alone, together):
            torch.testing.assert_close(a, t[b:b + 1], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("case", ["ragged", "two_tokens"])
def test_nan_scales_past_kv_len_stay_out(case):
    """NaN in the scales of every entry past a sequence's kv_len (the rest
    of its last page, and every page no live slot names): the split gives
    finite numbers, equal to those of zero scales there."""
    arrays, window = _inputs(case, 64, 8)
    q, ks, vs, kc, vc, table, qo, kl = arrays
    page = ks.shape[2]
    live = np.zeros(kc.shape, bool)
    for b, n in enumerate(kl):
        for j in range(-(-int(n) // page)):
            live[table[b, j], :max(0, min(page, int(n) - j * page))] = True
    nan = [np.where(live, sc, np.float32("nan")) for sc in (kc, vc)]
    zero = [np.where(live, sc, np.float32(0)) for sc in (kc, vc)]
    got = _split((q, ks, vs, *nan, table, qo, kl), window)
    assert np.isfinite(got).all()
    _close(got, _split((q, ks, vs, *zero, table, qo, kl), window), TOL)


@pytest.mark.parametrize("D", [64, 96, 128, 256])
@pytest.mark.parametrize("page", [16, 48, 64, 128, 256])
def test_int8_box_rows_divide_the_tile_and_the_page(D, page):
    """The int8 body's tile is not bf16's (16 KB of symbols a side at D 128
    and 256): its TMA box never crosses a page, is whole 16-row steps (an
    int8 box of 16 rows of D >= 64 bytes meets TMA's alignment) and is the
    largest such divisor of the int8 tile."""
    tile = tpa.tile_keys(D, quant=True)
    assert tile == {64: 128, 96: 128, 128: 64, 256: 32}[D]
    assert tile * D <= 16384
    d = tpa.box_rows(D, page, quant=True)
    assert tile % d == 0 and page % d == 0 and d % 16 == 0
    assert d * D >= 1024
    assert d == math.gcd(tile, page)
    assert all(tile % e or page % e for e in range(d + 1, tile + 1))
