"""The int8 key-split decode of ``quantized_flash_attention`` (kernel row 3
at T * G <= 16 rows) in its plain version: ``quantized_split_partials_
reference`` then ``combine_partials_reference``
(``lmcache_tpu_torch/ops/quantized_attention.py``), held in fp32 against the
JAX package's ``quantized_attention_reference`` and Pallas
``quantized_flash_attention`` (interpret mode), on the same numpy inputs
from a seed, quantized by the JAX quantizer run as written.

Tolerances: 2e-5 against the JAX reference (the same fp32 arithmetic in
another order: partials over 256-key splits, combined); 2e-4 against the
interpret-mode kernel, which applies the scales to score and probability
columns instead of to K and V (the tolerance of the port's own int8
tests)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from lmcache_tpu.ops import quantized_attention as jq  # noqa: E402
from lmcache_tpu_torch.ops import attention as tattn  # noqa: E402
from lmcache_tpu_torch.ops import quantized_attention as tq  # noqa: E402

SPLIT = tattn.SPLIT_KEYS
ATOL_REF = 2e-5
ATOL_KERNEL = 2e-4

# name -> (T, G, D, S, q_offset, kv_len, options); batch of len(q_offset),
# H_kv 2, rows T * G <= 16, S = 700 cut by three splits; rows that end on,
# or one past, a split edge, and windows inside, across and past the keys
CASES = {
    "cut": (1, 4, 32, 700, [699, 300], [700, 301], {}),
    "one_past_a_split": (1, 4, 32, 700, [SPLIT, 3], [SPLIT + 1, 4], {}),
    "ragged_with_empty": (1, 2, 16, 700, [600, 0], [601, 0], {}),
    "two_tokens_g8": (2, 8, 16, 700, [500, SPLIT - 1], [502, SPLIT + 1],
                      {}),
    "window_across_an_edge": (1, 4, 32, 700, [650, 300], [651, 301],
                              dict(sliding_window=SPLIT + 40)),
    "chunks_across_edges": (1, 4, 32, 700, [610, 299], [611, 300],
                            dict(sliding_window=300,
                                 window_kind="chunked")),
    "softcap": (1, 4, 32, 700, [699, 300], [700, 301],
                dict(logit_softcap=5.0, sm_scale=0.3)),
    "sinks": (1, 4, 32, 700, [699, 300], [700, 301], dict(sinks=True)),
    "g1": (1, 1, 64, 700, [699, 511], [700, 512], {}),
    "g8": (1, 8, 64, 700, [699, 2 * SPLIT - 1], [700, 2 * SPLIT], {}),
    "three_tokens_g5": (3, 5, 16, 700, [600, 2 * SPLIT - 2],
                        [603, 2 * SPLIT + 1], {}),
    "chunks_are_splits": (1, 4, 32, 700, [2 * SPLIT, 2 * SPLIT - 1],
                          [2 * SPLIT + 1, 2 * SPLIT],
                          dict(sliding_window=SPLIT, window_kind="chunked")),
    "window_softcap_sinks": (1, 4, 32, 700, [650, 40], [651, 41],
                             dict(sliding_window=300, logit_softcap=8.0,
                                  sinks=True)),
    "window_past_the_row": (1, 4, 32, 700, [650, 40], [651, 41],
                            dict(sliding_window=2000)),
}
# the cases also run through the JAX Pallas kernel (one compile each)
PALLAS = ("cut", "window_across_an_edge", "sinks")


def _inputs(case, seed=0):
    """q fp32, the JAX quantizer's symbols and scales (run as written) of
    token-major K/V, q_offset, kv_len, options."""
    T, G, D, S, q_off, kv_len, opts = CASES[case]
    B, Hkv = len(q_off), 2
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, G * Hkv, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    with jax.disable_jit():
        sym = [np.array(a) for a in jq.quantize_kv_for_cache(
            jnp.asarray(k), jnp.asarray(v))]
    opts = dict(opts)
    if opts.get("sinks"):
        opts["sinks"] = (rng.standard_normal(G * Hkv) * 2).astype(np.float32)
    return (q, *sym, np.asarray(q_off, np.int32),
            np.asarray(kv_len, np.int32), opts)


@pytest.mark.parametrize("case", sorted(CASES))
def test_int8_split_then_combine_matches_the_references(case):
    *arrays, opts = _inputs(case)
    topts = {n: torch.from_numpy(a) if n == "sinks" else a
             for n, a in opts.items()}
    got = tq.quantized_split_attention_reference(
        *(torch.from_numpy(a) for a in arrays), **topts).numpy()
    port = tq.quantized_attention_reference(
        *(torch.from_numpy(a) for a in arrays), zero_dead_rows=True,
        **topts).numpy()
    np.testing.assert_allclose(got, port, atol=ATOL_REF, rtol=ATOL_REF)
    kv_len = arrays[-1]
    dead = kv_len == 0
    assert (got[dead] == 0).all()  # the JAX reference spreads such a row
    live = ~dead
    jargs = [jnp.asarray(a) for a in arrays]
    jkw = {n: jnp.asarray(a) if n == "sinks" else a for n, a in opts.items()}
    ref = np.asarray(jq.quantized_attention_reference(*jargs, **jkw))
    np.testing.assert_allclose(got[live], ref[live], atol=ATOL_REF,
                               rtol=ATOL_REF)
    if case in PALLAS:
        out = np.asarray(jq.quantized_flash_attention(
            *jargs, block_q=16, block_k=256, interpret=True, **jkw))
        np.testing.assert_allclose(got[live], out[live], atol=ATOL_KERNEL,
                                   rtol=ATOL_KERNEL)


def test_int8_partials_follow_the_split_points_and_not_the_batch():
    """A row's live splits are exactly ``split_ranges`` of its keys, and its
    partials are the same bits alone and among other sequences."""
    *arrays, _ = _inputs("ragged_with_empty", seed=3)
    t = [torch.from_numpy(a) for a in arrays]
    part_o, part_ml = tq.quantized_split_partials_reference(*t)
    S, kv_len = arrays[1].shape[1], arrays[-1]
    assert part_o.shape[2] == tattn.n_splits(S)
    for b in range(len(kv_len)):
        live = [s for s, _, _ in tattn.split_ranges(S, 0,
                                                    int(kv_len[b]) - 1)]
        has = (part_ml[b, :, :, :, 1] > 0).any(dim=-1).any(dim=0)
        assert has.nonzero().flatten().tolist() == live
        alone_o, alone_ml = tq.quantized_split_partials_reference(
            *(x[b:b + 1] for x in t))
        assert torch.equal(alone_o, part_o[b:b + 1])
        assert torch.equal(alone_ml, part_ml[b:b + 1])


def test_the_cpu_wrapper_runs_the_plain_version_for_a_decode():
    """``quantized_flash_attention`` on CPU tensors at decode: the plain
    version, head-major K/V, no kernel launch counted."""
    *arrays, _ = _inputs("cut", seed=4)
    q, k, v, ks, vs, qo, kl = (torch.from_numpy(a) for a in arrays)
    before = sum(tq.quantized_flash_attention.launches.values())
    out = tq.quantized_flash_attention(
        q, k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous(),
        ks, vs, qo, kl, kv_head_major=True)
    assert sum(tq.quantized_flash_attention.launches.values()) == before
    want = tq.quantized_split_attention_reference(q, k, v, ks, vs, qo, kl)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=ATOL_REF,
                               rtol=ATOL_REF)
