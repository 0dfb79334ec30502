"""The port's cache engine against the JAX package's: identical chunk hashes
and keys, and the same hit masks and KV from store/retrieve on the CPU
tier."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import lmcache_tpu as jpkg  # noqa: E402
from lmcache_tpu.chunks import prefix_chunk_hashes as j_hashes  # noqa: E402
from lmcache_tpu.utils import CacheEngineKey as JKey  # noqa: E402
import lmcache_tpu_torch as tpkg  # noqa: E402
from lmcache_tpu_torch.chunks import prefix_chunk_hashes as t_hashes  # noqa
from lmcache_tpu_torch.utils import CacheEngineKey as TKey  # noqa: E402

CHUNK = 16


@pytest.mark.parametrize("n, skip", [(0, 0), (16, 0), (100, 0), (100, 3),
                                     (257, 1)])
def test_prefix_chunk_hashes_identical(n, skip):
    tokens = np.random.default_rng(n).integers(0, 32000, n, dtype=np.int32)
    expect = j_hashes(tokens, CHUNK, skip)
    assert t_hashes(tokens, CHUNK, skip) == expect
    assert t_hashes(torch.from_numpy(tokens), CHUNK, skip) == expect
    assert t_hashes(tokens.tolist(), CHUNK, skip) == expect


def test_cache_engine_key_identical():
    args = ("vllm", "tinyllama-1.1b", 4, 2, "ab" * 32)
    assert TKey(*args).to_string() == JKey(*args).to_string()
    assert TKey.from_string(JKey(*args).to_string()) == TKey(*args)


def _engines():
    meta = dict(model_name="m", world_size=1, worker_id=0, fmt="vllm")
    j = jpkg.LMCacheEngine(
        jpkg.LMCacheEngineConfig.from_defaults(local_device="cpu",
                                               chunk_size=CHUNK),
        jpkg.LMCacheEngineMetadata(**meta))
    t = tpkg.LMCacheEngine(
        tpkg.LMCacheEngineConfig(local_device="cpu", chunk_size=CHUNK),
        tpkg.LMCacheEngineMetadata(**meta))
    return j, t


@pytest.fixture
def stored():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 32000, 100, dtype=np.int32)
    blob = rng.standard_normal((2, 2, 100, 2, 8)).astype(np.float32)
    j, t = _engines()
    assert j.store(tokens, blob) == t.store(tokens, torch.from_numpy(blob))
    yield tokens, blob, j, t
    j.close()
    t.close()


def _retrieve_both(j, t, tokens, mask=None):
    jb, jm = j.retrieve(tokens, mask, return_tuple=False)
    tb, tm = t.retrieve(tokens, mask, return_tuple=False)
    np.testing.assert_array_equal(tm, jm)
    if jb is None:
        assert tb is None
    else:
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    return tb, tm


def test_full_hit_includes_partial_last_chunk(stored):
    tokens, blob, j, t = stored
    tb, tm = _retrieve_both(j, t, tokens)
    assert tm.all()
    np.testing.assert_array_equal(tb.numpy(), blob)
    assert t.lookup(tokens) == j.lookup(tokens) == 100


def test_longer_prompt_stops_before_partial_chunk(stored):
    tokens, blob, j, t = stored
    longer = np.concatenate([tokens, np.arange(30, dtype=np.int32)])
    tb, tm = _retrieve_both(j, t, longer)
    assert tm.sum() == 96
    np.testing.assert_array_equal(tb.numpy(), blob[:, :, :96])


def test_suffix_mask_skips_prefix(stored):
    tokens, blob, j, t = stored
    mask = np.ones(100, bool)
    mask[:40] = False  # the caller already has 40 tokens: 2 chunks + 8
    tb, tm = _retrieve_both(j, t, tokens, mask)
    assert not tm[:40].any() and tm[40:].all()
    np.testing.assert_array_equal(tb.numpy(), blob[:, :, 40:])


def test_miss(stored):
    _, _, j, t = stored
    other = np.arange(50, dtype=np.int32)
    tb, tm = _retrieve_both(j, t, other)
    assert tb is None and not tm.any()
    assert t.lookup(other) == j.lookup(other) == 0


def test_skip_existing_and_tuple_form(stored):
    tokens, blob, j, t = stored
    longer = np.concatenate([tokens[:96], np.arange(40, dtype=np.int32)])
    lblob = np.random.default_rng(1).standard_normal(
        (2, 2, 136, 2, 8)).astype(np.float32)
    # 6 leading chunks already stored: only the 3 new ones are written
    assert t.store(longer, torch.from_numpy(lblob)) == j.store(
        longer, lblob) == 3
    jt, jm = j.retrieve(longer)
    tt, tm = t.retrieve(longer)
    np.testing.assert_array_equal(tm, jm)
    for (jk, jv), (tk, tv) in zip(jt, tt):
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_nonblocking_put_snapshots_the_callers_tensor():
    """The tier copies before put returns: a pool view overwritten right
    after a non-blocking store still retrieves the stored values."""
    _, t = _engines()
    tokens = np.arange(32, dtype=np.int32)
    pool = torch.randn(2, 2, 32, 2, 8)
    want = pool.clone()
    t.store(tokens, pool, blocking=False)
    pool.zero_()
    t.engine_.flush()
    blob, mask = t.retrieve(tokens, return_tuple=False)
    assert mask.all()
    torch.testing.assert_close(blob, want, atol=0, rtol=0)
    t.close()


def test_unported_tiers_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpkg.LMCacheEngineConfig(local_device="/tmp/kv")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpkg.LMCacheEngineConfig(local_device="cpu",
                                 remote_url="lm://localhost:65000")


def test_builder_keeps_one_engine_per_instance_id():
    cfg = tpkg.LMCacheEngineConfig(local_device="cpu", chunk_size=CHUNK)
    meta = tpkg.LMCacheEngineMetadata(model_name="m", world_size=1,
                                      worker_id=0, fmt="vllm")
    builder = tpkg.LMCacheEngineBuilder
    e = builder.get_or_create("torch-builder", cfg, meta)
    try:
        assert builder.get_or_create("torch-builder", cfg, meta) is e
        assert builder.get("torch-builder") is e
        with pytest.raises(ValueError, match="different"):
            builder.get_or_create(
                "torch-builder",
                tpkg.LMCacheEngineConfig(local_device="cpu", chunk_size=8),
                meta)
    finally:
        builder.destroy("torch-builder")
    assert builder.get("torch-builder") is None


def test_local_tier_evicts_least_recently_used_under_budget():
    from lmcache_tpu_torch.storage.local_backend import LMCLocalBackend
    chunk = torch.zeros(2, 2, CHUNK, 2, 8)  # 2 KiB in fp32
    tier = LMCLocalBackend("cpu", capacity_bytes=2 * chunk.nbytes)
    keys = [TKey("vllm", "m", 1, 0, f"{i:064x}") for i in range(3)]
    tier.put(keys[0], chunk)
    tier.put(keys[1], chunk)
    assert tier.get(keys[0]) is not None  # touch: keys[1] is now oldest
    tier.put(keys[2], chunk)
    assert [tier.contains(k) for k in keys] == [True, False, True]
    assert tier.evictions == 1 and tier.total_bytes == 2 * chunk.nbytes
    tier.close()


def test_config_from_file(tmp_path):
    path = tmp_path / "lmcache.yaml"
    path.write_text("chunk_size: 128\nlocal_device: cpu\n"
                    "local_capacity_bytes: 4096\n")
    cfg = tpkg.LMCacheEngineConfig.from_file(str(path))
    assert (cfg.chunk_size, cfg.local_device,
            cfg.local_capacity_bytes) == (128, "cpu", 4096)
