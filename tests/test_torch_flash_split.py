"""The key-split decode of ``flash_attention`` (kernel row 1 at T * G <= 16
rows) in its plain version: ``split_partials_reference`` then
``combine_partials_reference`` (``lmcache_tpu_torch/ops/attention.py``),
held in fp32 against the port's ``mha_reference`` and the JAX package's
``mha_reference`` and Pallas ``flash_attention`` (interpret mode), on the
same numpy inputs from a seed; and the host-side rule that sizes the grid
and places the split points."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from lmcache_tpu.ops import attention as jattn  # noqa: E402
from lmcache_tpu_torch.ops import attention as tattn  # noqa: E402

SPLIT = tattn.SPLIT_KEYS
# fp32 on both sides, sums in another order
TOL = 1e-5

# name -> (T, G, D, S, q_offset, kv_len, options); batch of len(q_offset),
# H_kv 2, rows T * G <= 16. S = 1100 keys is cut by several splits; the
# "one_split" row sees exactly one split, "one_past_a_split" one key more.
CASES = {
    "cut": (1, 4, 32, 1100, [1099, 600], [1100, 601], {}),
    "one_split": (1, 4, 32, 1100, [SPLIT - 1, 100], [SPLIT, 101], {}),
    "one_past_a_split": (1, 4, 32, 1100, [SPLIT, 3], [SPLIT + 1, 4], {}),
    "ragged_with_empty": (1, 2, 16, 1100, [700, 0, 1023], [701, 0, 1024],
                          {}),
    "two_tokens_g8": (2, 8, 16, 1100, [1000, 511], [1002, 513], {}),
    "window_across_an_edge": (1, 4, 32, 1100, [1000, 300], [1001, 301],
                              dict(sliding_window=SPLIT + 88)),
    "window_inside_a_split": (1, 4, 32, 1100, [1000, 300], [1001, 301],
                              dict(sliding_window=SPLIT // 5)),
    "chunks_are_splits": (1, 4, 32, 1600, [2 * SPLIT, 3 * SPLIT - 1],
                          [2 * SPLIT + 1, 3 * SPLIT],
                          dict(sliding_window=SPLIT, window_kind="chunked")),
    "chunks_across_edges": (1, 4, 32, 1600, [1200, 899], [1201, 900],
                            dict(sliding_window=300,
                                 window_kind="chunked")),
    "softcap": (1, 4, 32, 1100, [1099, 600], [1100, 601],
                dict(logit_softcap=5.0, sm_scale=0.3)),
    "sinks": (1, 4, 32, 1100, [1099, 600], [1100, 601], dict(sinks=True)),
    "sinks_window_empty": (1, 4, 32, 1100, [1000, 0], [1001, 0],
                           dict(sinks=True, sliding_window=700)),
}
# the cases also run through the JAX Pallas kernel (one compile each)
PALLAS = ("cut", "ragged_with_empty", "window_across_an_edge",
          "chunks_across_edges", "sinks")


def _inputs(case, seed=0):
    T, G, D, S, q_off, kv_len, opts = CASES[case]
    B, Hkv = len(q_off), 2
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, G * Hkv, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    opts = dict(opts)
    if opts.get("sinks"):
        opts["sinks"] = (rng.standard_normal(G * Hkv) * 2).astype(np.float32)
    return (q, k, v, np.asarray(q_off, np.int32),
            np.asarray(kv_len, np.int32), opts)


def _torch_kw(opts):
    return {n: torch.from_numpy(a) if n == "sinks" else a
            for n, a in opts.items()}


def _split(q, k, v, q_off, kv_len, opts):
    return tattn.split_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v, q_off, kv_len)),
        **_torch_kw(opts)).numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_then_combine_matches_the_references(case):
    q, k, v, q_off, kv_len, opts = _inputs(case)
    got = _split(q, k, v, q_off, kv_len, opts)
    port = tattn.mha_reference(
        *(torch.from_numpy(a) for a in (q, k, v, q_off, kv_len)),
        zero_dead_rows=True, **_torch_kw(opts)).numpy()
    np.testing.assert_allclose(got, port, atol=TOL, rtol=TOL)
    # a sequence that sees no key gives 0 (the JAX reference spreads such
    # a row evenly over the masked keys)
    dead = kv_len == 0
    assert (got[dead] == 0).all()
    live = ~dead
    args = [jnp.asarray(a) for a in (q, k, v, q_off, kv_len)]
    jkw = {n: jnp.asarray(a) if n == "sinks" else a for n, a in opts.items()}
    ref = np.asarray(jattn.mha_reference(*args, **jkw))
    np.testing.assert_allclose(got[live], ref[live], atol=TOL, rtol=TOL)
    if case in PALLAS:
        out = np.asarray(jattn.flash_attention(
            *args, block_q=16, block_k=256, interpret=True, **jkw))
        np.testing.assert_allclose(got[live], out[live], atol=TOL, rtol=TOL)


def test_kv_slot_attends_to_the_pool_row():
    """``kv_slot``: the one sequence's partials come from pool row
    ``kv_slot[0]``, as the JAX kernel reads it."""
    rng = np.random.default_rng(7)
    Hkv, G, D, S, rows = 2, 4, 32, 1100, 3
    q = rng.standard_normal((1, 1, G * Hkv, D)).astype(np.float32)
    k = rng.standard_normal((rows, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((rows, Hkv, S, D)).astype(np.float32)
    q_off, kv_len = np.asarray([900], np.int32), np.asarray([901], np.int32)
    slot = np.asarray([2], np.int32)
    got = tattn.split_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k[2:3]).transpose(1, 2),
        torch.from_numpy(v[2:3]).transpose(1, 2), torch.from_numpy(q_off),
        torch.from_numpy(kv_len)).numpy()
    out = np.asarray(jattn.flash_attention(
        *(jnp.asarray(a) for a in (q, k, v, q_off, kv_len)),
        kv_head_major=True, kv_slot=jnp.asarray(slot), block_q=16,
        block_k=256, interpret=True))
    np.testing.assert_allclose(got, out, atol=TOL, rtol=TOL)
    port = tattn.flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v, q_off, kv_len)),
        kv_head_major=True, kv_slot=torch.from_numpy(slot)).numpy()
    np.testing.assert_allclose(got, port, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("S, want", [
    (0, 1), (1, 1), (SPLIT - 1, 1), (SPLIT, 1), (SPLIT + 1, 2),
    (2113, -(-2113 // SPLIT)), (16385, 16384 // SPLIT + 1)])
def test_the_grid_is_sized_from_S(S, want):
    assert tattn.n_splits(S) == want


@pytest.mark.parametrize("lo, hi", [
    (0, 0), (0, SPLIT - 1), (0, SPLIT), (300, 1100), (SPLIT, 2 * SPLIT - 1),
    (1000, 16383), (5, 4)])
def test_split_points_depend_on_the_row_range_only(lo, hi):
    """A row's splits tile its own range at absolute multiples of
    SPLIT_KEYS, the same in any buffer that holds the range."""
    ranges = [tattn.split_ranges(S, lo, hi)
              for S in (hi + 1, hi + 1000, 2 * hi + 2)]
    assert ranges[0] == ranges[1] == ranges[2]
    if lo > hi:
        assert ranges[0] == []
        return
    keys = [k for _, a, b in ranges[0] for k in range(a, b + 1)]
    assert keys == list(range(lo, hi + 1))
    for s, a, b in ranges[0]:
        assert s * SPLIT <= a <= b < (s + 1) * SPLIT
        assert s < tattn.n_splits(hi + 1)


def test_partials_follow_the_split_points_and_not_the_batch():
    """The plain partials: a row's live splits are exactly
    ``split_ranges`` of its keys, and its partials are the same bits alone
    and among other sequences of other lengths."""
    q, k, v, q_off, kv_len, _ = _inputs("ragged_with_empty", seed=3)
    t = [torch.from_numpy(a) for a in (q, k, v, q_off, kv_len)]
    part_o, part_ml = tattn.split_partials_reference(*t)
    S = k.shape[1]
    for b in range(len(q_off)):
        live = [s for s, _, _ in tattn.split_ranges(S, 0,
                                                    int(kv_len[b]) - 1)]
        has = (part_ml[b, :, :, :, 1] > 0).any(dim=-1).any(dim=0)
        assert has.nonzero().flatten().tolist() == live
        alone_o, alone_ml = tattn.split_partials_reference(
            *(x[b:b + 1] for x in t))
        assert torch.equal(alone_o, part_o[b:b + 1])
        assert torch.equal(alone_ml, part_ml[b:b + 1])


def test_combine_skips_empty_partials_whatever_their_O():
    """An empty partial (l = 0) adds nothing and makes no NaN, whatever
    its O holds; a row whose partials are all empty gives 0 (with sinks
    too)."""
    rng = np.random.default_rng(5)
    B, Hkv, n, T, G, D = 2, 2, 4, 1, 4, 16
    part_o = torch.from_numpy(
        rng.standard_normal((B, Hkv, n, T * G, D)).astype(np.float32))
    m = torch.from_numpy(
        rng.standard_normal((B, Hkv, n, T * G)).astype(np.float32))
    l = torch.from_numpy(
        rng.random((B, Hkv, n, T * G)).astype(np.float32) + 1)
    empty = torch.zeros_like(l, dtype=torch.bool)
    empty[:, :, 1] = True
    empty[1, 0, :, 2] = True
    m, l = m.masked_fill(empty, -1e30), l.masked_fill(empty, 0)
    part_ml = torch.stack([m, l], dim=-1)
    clean = tattn.combine_partials_reference(part_o.masked_fill(
        empty[..., None], 0), part_ml, T, G)
    dirty = tattn.combine_partials_reference(part_o.masked_fill(
        empty[..., None], float("nan")), part_ml, T, G)
    assert torch.equal(clean, dirty)
    assert (dirty[1, 0, 2] == 0).all()
    keep = ~empty[..., None]
    want = ((part_o * keep) * torch.exp(m - m.amax(2, keepdim=True))[
        ..., None]).sum(2) / (l * torch.exp(m - m.amax(2, keepdim=True))).sum(
            2)[..., None]
    np.testing.assert_allclose(
        dirty[0].reshape(Hkv, G, D).numpy(),
        want[0, :, :].reshape(Hkv, G, D).numpy(), atol=TOL, rtol=TOL)
    sinks = torch.from_numpy(rng.standard_normal(Hkv * G).astype(np.float32))
    with_sinks = tattn.combine_partials_reference(
        part_o.masked_fill(empty[..., None], float("nan")), part_ml, T, G,
        sinks=sinks)
    assert torch.isfinite(with_sinks).all()
    assert (with_sinks[1, 0, 2] == 0).all()


def test_the_cpu_wrapper_runs_the_plain_combine():
    """``combine_partials`` on CPU tensors: the plain version in bf16, and
    no kernel launch counted."""
    q, k, v, q_off, kv_len, _ = _inputs("cut", seed=4)
    t = [torch.from_numpy(a) for a in (q, k, v, q_off, kv_len)]
    part_o, part_ml = tattn.split_partials_reference(*t)
    before = sum(tattn.combine_partials.launches.values())
    out = tattn.combine_partials(part_o, part_ml, 1, 4)
    assert sum(tattn.combine_partials.launches.values()) == before
    assert out.dtype == torch.bfloat16
    ref = tattn.combine_partials_reference(part_o, part_ml, 1, 4)
    assert torch.equal(out, ref.bfloat16())
