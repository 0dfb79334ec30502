"""The key-split decode of ``paged_latent_attention_dma`` (kernel row 10 at
T * H <= ``SPLIT_ROWS`` rows) in its plain version:
``paged_latent_split_partials_reference`` then ``combine_partials_reference``
(``lmcache_tpu_torch/ops/paged_latent_attention.py``), held in fp32 against
the port's paged plain versions and the JAX package's
``paged_latent_attention_reference`` /
``quantized_paged_latent_attention_reference`` and Pallas
``paged_latent_attention_dma`` and its int8 twin (interpret mode), on the
same numpy inputs from a seed; and the host-side rules that size the grid,
place the split points and choose the split and the TMA box."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from lmcache_tpu.ops import latent_attention as jla  # noqa: E402
from lmcache_tpu.ops import paged_latent_attention as jpla  # noqa: E402
from lmcache_tpu_torch.ops import paged_latent_attention as tpla  # noqa: E402

SPLIT = tpla.LATENT_SPLIT_KEYS
# fp32 on both sides, sums in another order
TOL = 2e-5
# the Pallas kernels' online softmax against the materialized one
PALLAS_TOL = 2e-3
H, R, P_ROPE = 4, 64, 16
C = R + P_ROPE  # 80, as MLAConfig.tiny
CP = 128  # its lane-padded arena width
SCALE = 0.13
PAGE = 64

# name -> (T, q_offset, kv_len); batch of len(q_offset), rows T * H
CASES = {
    "cut": (1, [1099, 600], [1100, 601]),
    "one_split": (1, [SPLIT - 1, 100], [SPLIT, 101]),
    "one_past_a_split": (1, [SPLIT, 3], [SPLIT + 1, 4]),
    "ragged_with_empty": (1, [700, 0, 1023], [701, 0, 1024]),
    "kv_len_one": (1, [0, 1099], [1, 1100]),
    "two_tokens": (2, [1000, 510], [1002, 512]),
}


def _t(a):
    return torch.from_numpy(np.array(a))  # a private, writable copy


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=atol)


def _inputs(case, quant, seed=0):
    """q [B, T, H, C] and zero-padded to CP (what the JAX forward passes), a
    lane-padded arena [P, page, CP] whose rows past each kv_len are stale,
    a shuffled page table whose dead slots hold live ids of another
    sequence, int32 offsets."""
    T, q_off, kv_len = CASES[case]
    B = len(q_off)
    rng = np.random.default_rng(seed)
    NP = -(-max(kv_len) // PAGE) + 1
    P = B * NP + 2
    q = rng.standard_normal((B, T, H, C)).astype(np.float32)
    pool = rng.standard_normal((P, PAGE, CP)).astype(np.float32)
    pool[..., C:] = 0.0
    table = rng.permutation(np.arange(1, P))[:B * NP].reshape(
        B, NP).astype(np.int32)
    for b, n in enumerate(kv_len):
        live = -(-n // PAGE)
        if n % PAGE:
            pool[table[b, live - 1], n % PAGE:, :C] = 1e4  # stale tail
        table[b, live:] = table[(b + 1) % B, 0]
    q_pad = np.pad(q, ((0, 0), (0, 0), (0, 0), (0, CP - C)))
    if quant:
        with jax.disable_jit():
            sym, sc = jla.quantize_latents(jnp.asarray(pool))
        arena = (np.asarray(sym), np.asarray(sc))
    else:
        arena = (pool,)
    return (q, q_pad, arena, table, np.asarray(q_off, np.int32),
            np.asarray(kv_len, np.int32))


def _split(q, arena, table, qo, kl):
    sc = {"scale_pool": _t(arena[1])} if len(arena) == 2 else {}
    return tpla.paged_latent_split_attention_reference(
        _t(q), _t(arena[0]), _t(table), _t(qo), _t(kl), rank=R, scale=SCALE,
        **sc).numpy()


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_then_combine_matches_the_references(case, quant):
    """Against the port's paged plain version (0 for a row that sees no
    key) and the JAX reference (which averages such a row uniformly: only
    the rows with keys are compared)."""
    q, q_pad, arena, table, qo, kl = _inputs(case, quant)
    got = _split(q, arena, table, qo, kl)
    kw = dict(rank=R, scale=SCALE)
    tref = (tpla.quantized_paged_latent_attention_reference if quant
            else tpla.paged_latent_attention_reference)
    want = tref(_t(q), *map(_t, arena), _t(table), _t(qo), _t(kl),
                zero_dead_rows=True, **kw).numpy()
    _close(got, want, TOL)
    jref = (jpla.quantized_paged_latent_attention_reference if quant
            else jpla.paged_latent_attention_reference)
    jwant = np.asarray(jref(jnp.asarray(q_pad), *map(jnp.asarray, arena),
                            jnp.asarray(table), jnp.asarray(qo),
                            jnp.asarray(kl), **kw))
    live = kl > 0
    _close(got[live], jwant[live], TOL)
    assert not got[~live].any()


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_split_then_combine_matches_the_pallas_kernel(quant):
    """One shape each (the interpret mode compiles per shape): decode rows
    whose keys several splits cut, and a row of one key."""
    q, q_pad, arena, table, qo, kl = _inputs("kv_len_one", quant, seed=3)
    name = ("quantized_paged_latent_attention_dma" if quant
            else "paged_latent_attention_dma")
    want = getattr(jpla, name)(jnp.asarray(q_pad), *map(jnp.asarray, arena),
                               jnp.asarray(table), jnp.asarray(qo),
                               jnp.asarray(kl), rank=R, scale=SCALE,
                               interpret=True)
    _close(_split(q, arena, table, qo, kl), want, PALLAS_TOL)


@pytest.mark.parametrize("case", ["cut", "one_split", "one_past_a_split",
                                  "ragged_with_empty"])
def test_partials_follow_the_split_points(case):
    """A row's partial is live (l > 0) exactly in the splits that
    ``split_ranges`` gives its keys, empty ones carry (m = -1e30, l = 0,
    O = 0), and the grid is ``n_splits`` of the table's width."""
    q, _, arena, table, qo, kl = _inputs(case, False)
    part_o, part_ml = tpla.paged_latent_split_partials_reference(
        _t(q), _t(arena[0]), _t(table), _t(qo), _t(kl), rank=R, scale=SCALE)
    S = table.shape[1] * PAGE
    n = tpla.n_splits(S)
    assert part_o.shape == (len(qo), n, H, R)
    for b in range(len(qo)):
        live = {s for s, _, _ in tpla.split_ranges(S, 0, int(kl[b]) - 1)}
        for s in range(n):
            l = part_ml[b, s, :, 1]
            if s in live:
                assert (l > 0).all()
            else:
                assert (l == 0).all() and (part_ml[b, s, :, 0] == -1e30).all()
                assert not part_o[b, s].any()


def test_partials_do_not_depend_on_the_batch():
    """A sequence's partials alone and beside others of other lengths: the
    same splits live, the same values."""
    q, _, arena, table, qo, kl = _inputs("ragged_with_empty", True)
    args = dict(rank=R, scale=SCALE, scale_pool=_t(arena[1]))
    together = tpla.paged_latent_split_partials_reference(
        _t(q), _t(arena[0]), _t(table), _t(qo), _t(kl), **args)
    for b in range(len(qo)):
        alone = tpla.paged_latent_split_partials_reference(
            _t(q[b:b + 1]), _t(arena[0]), _t(table[b:b + 1]),
            _t(qo[b:b + 1]), _t(kl[b:b + 1]), **args)
        assert torch.equal(alone[1][..., 1] > 0, together[1][b:b + 1, ..., 1]
                           > 0)
        for a, t in zip(alone, together):
            torch.testing.assert_close(a, t[b:b + 1], atol=1e-6, rtol=1e-6)


def test_the_combine_skips_empty_partials():
    """The combine's plain version gives 0 for a row whose every partial is
    empty, and ignores what an empty partial's O holds."""
    q, _, arena, table, qo, kl = _inputs("ragged_with_empty", False)
    part_o, part_ml = tpla.paged_latent_split_partials_reference(
        _t(q), _t(arena[0]), _t(table), _t(qo), _t(kl), rank=R, scale=SCALE)
    out = tpla.combine_partials_reference(part_o, part_ml, 1, H)
    noisy = part_o.clone()
    noisy[part_ml[..., 1] == 0] = 123.0
    torch.testing.assert_close(
        tpla.combine_partials_reference(noisy, part_ml, 1, H), out)
    assert not out[1].any() and out[0].abs().sum() > 0
    # on CPU tensors the entry point is the plain version, in bf16
    got = tpla.combine_partials(part_o, part_ml, 1, H)
    assert got.dtype == torch.bfloat16 and not tpla.combine_partials.launches
    torch.testing.assert_close(got.float(), out, atol=2e-2, rtol=2.0**-7)


@pytest.mark.parametrize("S", [0, 1, SPLIT - 1, SPLIT, SPLIT + 1, 16448])
def test_grid_is_sized_from_the_table_width(S):
    n = tpla.n_splits(S)
    assert n == max(1, -(-S // SPLIT))
    covered = [k for s in range(n)
               for k in range(s * SPLIT, min(S, (s + 1) * SPLIT))]
    assert covered == list(range(S))


def test_split_ranges_cut_at_absolute_multiples():
    S = 3 * SPLIT + 7
    assert tpla.split_ranges(S, 5, S, split=2 * SPLIT) == [
        (0, 5, 2 * SPLIT - 1), (1, 2 * SPLIT, S - 1)]
    assert tpla.split_ranges(S, 0, -1) == []
    assert tpla.split_ranges(S, 0, SPLIT - 1) == [(0, 0, SPLIT - 1)]
    assert tpla.split_ranges(S, 0, SPLIT) == [(0, 0, SPLIT - 1),
                                              (1, SPLIT, SPLIT)]
    assert tpla.split_ranges(S, 5, S + 100) == [
        (0, 5, SPLIT - 1), (1, SPLIT, 2 * SPLIT - 1),
        (2, 2 * SPLIT, 3 * SPLIT - 1), (3, 3 * SPLIT, S - 1)]


def test_split_and_tile_choices():
    """The split is whole tiles, 256 keys for each row block of 64 rows;
    decode at every preset's head count takes the split, a prefill segment
    does not."""
    assert SPLIT % tpla.STREAM_TILE == 0
    assert tpla.split_keys(1, 4) == tpla.split_keys(1, 16) == SPLIT == 256
    assert tpla.split_keys(1, 128) == tpla.split_keys(2, 64) == 2 * SPLIT
    assert tpla.takes_split(1, 16) and tpla.takes_split(1, 128)
    assert tpla.takes_split(4, 16)
    assert not tpla.takes_split(512, 16) and not tpla.takes_split(2, 128)


@pytest.mark.parametrize("page", [1, 7, 12, 16, 24, 32, 48, 64, 128, 256])
def test_box_rows_divide_the_tile_and_the_page(page):
    d = tpla.box_rows(tpla.STREAM_TILE, page)
    assert tpla.STREAM_TILE % d == 0 and page % d == 0
    assert all(tpla.STREAM_TILE % e or page % e for e in range(d + 1, 33))
    # row 9: its tile is the page, a page a box
    if page % 16 == 0:
        assert tpla.box_rows(page, page) == page
