"""The key-split decode of ``paged_attention`` and ``paged_attention_dma``
over bf16 arenas (kernel rows 4 and 6 at T * G <= ``DECODE_ROWS`` rows) in
its plain version: ``paged_split_partials_reference`` then
``attention.combine_partials_reference``
(``lmcache_tpu_torch/ops/paged_attention.py``), held in fp32 against the
port's paged plain version and the JAX package's
``paged_attention_reference`` and Pallas ``paged_attention`` /
``paged_attention_dma`` (interpret mode), on the same numpy inputs from a
seed; and the host-side rules that choose the split, size its grid, place
its split points and size the TMA box of the prefill body."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from lmcache_tpu.ops import paged_attention as jpa  # noqa: E402
from lmcache_tpu_torch.ops import attention as tattn  # noqa: E402
from lmcache_tpu_torch.ops import paged_attention as tpa  # noqa: E402

SPLIT = tattn.SPLIT_KEYS
# fp32 on both sides, sums in another order
TOL = 2e-5
# the Pallas kernels' online softmax against the materialized one
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
}


def _t(a):
    return torch.from_numpy(np.array(a))  # a private, writable copy


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=atol)


def _inputs(case, D, G, seed=0):
    """q [B, T, H, D], K/V arenas [P, H_kv, page, D] whose rows past each
    kv_len are stale, a shuffled page table whose dead slots hold live ids
    of another sequence, int32 offsets."""
    T, page, q_off, kv_len, window = CASES[case]
    B = len(q_off)
    rng = np.random.default_rng(seed)
    NP = -(-max(kv_len) // page) + 1
    P = B * NP + 2
    q = rng.standard_normal((B, T, G * HKV, D)).astype(np.float32)
    pools = [rng.standard_normal((P, HKV, page, D)).astype(np.float32)
             for _ in range(2)]
    table = rng.permutation(np.arange(1, P))[:B * NP].reshape(
        B, NP).astype(np.int32)
    for b, n in enumerate(kv_len):
        live = -(-n // page)
        if n % page:
            for pool in pools:
                pool[table[b, live - 1], :, n % page:] = 1e4  # stale tail
        table[b, live:] = table[(b + 1) % B, 0]
    return (q, *pools, table, np.asarray(q_off, np.int32),
            np.asarray(kv_len, np.int32)), window


def _split(arrays, window):
    return tpa.paged_split_attention_reference(
        *map(_t, arrays), sliding_window=window).numpy()


@pytest.mark.parametrize("G", [1, 8])
@pytest.mark.parametrize("D", [64, 96])
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_then_combine_matches_the_plain_version(case, D, G):
    """Against the port's paged plain version (0 for a row that sees no
    key)."""
    arrays, window = _inputs(case, D, G)
    want = tpa.paged_attention_reference(*map(_t, arrays),
                                         sliding_window=window).numpy()
    _close(_split(arrays, window), want, TOL)


@pytest.mark.parametrize("case, D, G", [("ragged", 64, 8),
                                        ("two_tokens", 96, 1)])
def test_split_then_combine_matches_the_jax_reference(case, D, G):
    """Against the JAX reference, which averages a row that sees no key
    uniformly: only the rows with keys are compared (two cases: the
    reference compiles its operations per shape)."""
    arrays, window = _inputs(case, D, G)
    got = _split(arrays, window)
    jwant = np.asarray(jpa.paged_attention_reference(
        *map(jnp.asarray, arrays), sliding_window=window))
    live = arrays[-1] > 0
    _close(got[live], jwant[live], TOL)
    assert not got[~live].any()


@pytest.mark.parametrize("name, D, G", [("paged_attention", 96, 1),
                                        ("paged_attention_dma", 64, 8)])
def test_split_then_combine_matches_the_pallas_kernel(name, D, G):
    """One shape each (the interpret mode compiles per shape), under a
    window across split edges: Phi-3's head dim and group, and
    tinyllama's."""
    arrays, window = _inputs("window", D, G, seed=3)
    want = getattr(jpa, name)(*map(jnp.asarray, arrays),
                              sliding_window=window, interpret=True)
    _close(_split(arrays, window), want, PALLAS_TOL)


@pytest.mark.parametrize("case", ["ragged", "window"])
def test_partials_follow_the_split_points(case):
    """A row's partial is live (l > 0) exactly in the splits that
    ``split_ranges`` gives its keys (under the window too), empty ones carry
    (m = -1e30, l = 0, O = 0), and the grid is ``n_splits`` of the table's
    width."""
    arrays, window = _inputs(case, 64, 8)
    part_o, part_ml = tpa.paged_split_partials_reference(
        *map(_t, arrays), sliding_window=window)
    q_off, kv_len = arrays[-2], arrays[-1]
    NP, page = arrays[3].shape[1], arrays[1].shape[2]
    S = NP * page
    n = tattn.n_splits(S)
    assert part_o.shape == (len(q_off), HKV, n, 8, 64)
    for b in range(len(q_off)):
        hi = min(int(q_off[b]), int(kv_len[b]) - 1)
        lo = max(int(q_off[b]) - window + 1, 0) if window else 0
        live = {s for s, _, _ in tattn.split_ranges(S, lo, hi)}
        for s in range(n):
            l = part_ml[b, :, s, :, 1]
            if s in live:
                assert (l > 0).all()
            else:
                assert (l == 0).all()
                assert (part_ml[b, :, s, :, 0] == -1e30).all()
                assert not part_o[b, :, s].any()


def test_partials_do_not_depend_on_the_batch():
    """A sequence's partials alone and beside others of other lengths: the
    same splits live, the same values."""
    arrays, window = _inputs("window", 96, 1)
    q, kp, vp, table, qo, kl = arrays
    together = tpa.paged_split_partials_reference(*map(_t, arrays),
                                                  sliding_window=window)
    for b in range(len(qo)):
        alone = tpa.paged_split_partials_reference(
            _t(q[b:b + 1]), _t(kp), _t(vp), _t(table[b:b + 1]),
            _t(qo[b:b + 1]), _t(kl[b:b + 1]), sliding_window=window)
        for a, t in zip(alone, together):
            torch.testing.assert_close(a, t[b:b + 1], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("T, G, split", [
    (1, 1, True), (1, 8, True), (2, 8, True), (16, 1, True), (3, 5, True),
    (3, 8, False), (17, 1, False), (512, 1, False), (1, 32, False)])
def test_which_launches_split(T, G, split):
    """Every decode step of tinyllama (G 8) and Phi-3 (G 1) splits; a
    prefill segment runs the prefill body."""
    assert tpa.takes_split(T, G) is split


@pytest.mark.parametrize("NP, page", [(1, 16), (16, 16), (17, 16), (35, 64),
                                      (65, 64), (257, 64), (3, 256)])
def test_grid_is_sized_from_the_table_width(NP, page):
    """The split count comes from ``NP * page`` alone (tinyllama's table of
    35 pages of 64, Phi-3's 65, the 16k decode's 257)."""
    n = tattn.n_splits(NP * page)
    assert n == max(1, -(-NP * page // SPLIT))
    assert (n - 1) * SPLIT < NP * page <= n * SPLIT


def test_split_ranges_under_a_window():
    """Phi-3's window (2047) at a serving decode row: the splits start at
    absolute multiples of ``SPLIT_KEYS``, the first one mid-split at the
    window's first key, the ones before the window are empty."""
    S, qpos, W = 65 * 64, 3010, 2047
    ranges = tattn.split_ranges(S, qpos - W + 1, qpos)
    assert ranges[0] == (3, 964, 1023)
    assert ranges[-1] == (11, 2816, 3010)
    assert [s for s, _, _ in ranges] == list(range(3, 12))
    assert all(lo % SPLIT == 0 for _, lo, _ in ranges[1:])


@pytest.mark.parametrize("D", [64, 96, 128, 256])
@pytest.mark.parametrize("page", [16, 48, 64, 128, 256])
def test_box_rows_divide_the_tile_and_the_page(D, page):
    """A TMA box never crosses a page and is whole 16-row steps of the
    panels' swizzle: the largest such divisor of the body's tile."""
    tile = tpa.tile_keys(D)
    assert tile == (64 if D == 256 else 128)
    d = tpa.box_rows(D, page)
    assert tile % d == 0 and page % d == 0 and d % 16 == 0
    assert all(tile % e or page % e for e in range(d + 1, tile + 1))
