"""The port's disk and hybrid tiers, its ``raw_zstd`` and ``safetensors``
serdes and its redis connectors, against the JAX package, on the CPU
(mirroring ``tests/test_backends.py`` and ``tests/test_serde.py``).

The hybrid cases run over the port's cache server, started once for the
module; the redis cases over the in-memory fake that ``tests/conftest.py``
installs as the ``redis`` module, which both packages' connectors share.
"""

import os
import socket
import subprocess
import sys
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import lmcache_tpu as jpkg
import lmcache_tpu_torch as tpkg
from lmcache_tpu.storage import CreateStorageBackend as JCreate
from lmcache_tpu.storage.connector import CreateConnector as JConnector
from lmcache_tpu.storage.local_backend import LMCLocalDiskBackend as JDisk
from lmcache_tpu.storage.serde import CreateSerde as JSerde
from lmcache_tpu.utils import CacheEngineKey as JKey
from lmcache_tpu_torch.storage import CreateStorageBackend
from lmcache_tpu_torch.storage.connector import CreateConnector
from lmcache_tpu_torch.storage.hybrid_backend import LMCHybridBackend
from lmcache_tpu_torch.storage.local_backend import (LMCLocalBackend,
                                                     LMCLocalDiskBackend)
from lmcache_tpu_torch.storage.remote_backend import LMCRemoteBackend
from lmcache_tpu_torch.storage.serde import CreateSerde
from lmcache_tpu_torch.utils import CacheEngineKey

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
META = tpkg.LMCacheEngineMetadata("test-model", 1, 0, "vllm")
JMETA = jpkg.LMCacheEngineMetadata("test-model", 1, 0, "vllm")
DTYPES = ("float32", "float16", "bfloat16")


def make_key(i=0):
    return CacheEngineKey("vllm", "test-model", 1, 0, f"hash{i}")


def blobs(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(
        rng.standard_normal((2, 2, 8, 2, 4)).astype(np.float32))
        for _ in range(n)]


def same(a, b) -> bool:
    return torch.equal(torch.as_tensor(a), torch.as_tensor(b))


@pytest.fixture(scope="module")
def server():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "lmcache_tpu_torch.server", "localhost",
         str(port), "cpu"], cwd=ROOT)
    try:
        deadline = time.time() + 30
        while True:
            try:
                socket.create_connection(("localhost", port), 0.5).close()
                break
            except OSError:
                if time.time() > deadline or proc.poll() is not None:
                    raise RuntimeError("cache server failed to start")
                time.sleep(0.1)
        yield f"lm://localhost:{port}"
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def hybrid_cfg(url, **kw):
    return tpkg.LMCacheEngineConfig(local_device="cpu", remote_url=url,
                                    remote_device="cpu", **kw)


# -- the disk tier ------------------------------------------------------------

def test_factory_builds_every_tier(tmp_path, server, autorelease):
    cases = [
        (dict(local_device="cpu"), LMCLocalBackend),
        (dict(local_device=str(tmp_path / "d")), LMCLocalDiskBackend),
        (dict(local_device=None, remote_url=server), LMCRemoteBackend),
        (dict(local_device=str(tmp_path / "h"), remote_url=server),
         LMCHybridBackend),
    ]
    for kw, cls in cases:
        backend = autorelease(CreateStorageBackend(
            tpkg.LMCacheEngineConfig(**kw), META))
        assert type(backend) is cls
    assert isinstance(backend.local, LMCLocalDiskBackend)


def test_disk_put_get_and_restart_replay(tmp_path, autorelease):
    path = str(tmp_path / "disk")
    b1 = autorelease(LMCLocalDiskBackend(path))
    data = blobs(2)
    b1.put(make_key(0), data[0])
    b1.put(make_key(1), data[1], blocking=False)
    b1.close()
    # a key whose file is gone is dropped from the replayed index
    os.remove(b1._key_to_path(make_key(1)))
    with open(os.path.join(path, "keys.idx"), "a") as f:
        f.write("not a key\n")
    b2 = autorelease(LMCLocalDiskBackend(path))
    assert b2.contains(make_key(0)) and not b2.contains(make_key(1))
    got = b2.get(make_key(0))
    assert got.device.type == "cpu" and same(got, data[0])
    assert b2.get(make_key(1)) is None


class _ShortReads:
    """An unbuffered file whose reads return at most ``step`` bytes, and
    nothing once ``limit`` bytes have been read."""

    def __init__(self, f, step, limit):
        self.f, self.step, self.left = f, step, limit

    def readinto(self, buf):
        n = self.f.readinto(buf[:min(self.step, self.left)])
        self.left -= n
        return n

    def __getattr__(self, name):
        return getattr(self.f, name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.f.close()


@pytest.mark.parametrize("limit", [None, 100], ids=["short", "truncated"])
def test_disk_get_reads_the_whole_file(tmp_path, monkeypatch, autorelease,
                                       limit):
    """A read may return fewer bytes than asked: ``get`` loops until the
    container is whole, and raises where the file ends before its size."""
    from lmcache_tpu_torch.storage import local_backend
    backend = autorelease(LMCLocalDiskBackend(str(tmp_path / "disk")))
    data = blobs(1)[0]
    backend.put(make_key(0), data)
    size = os.path.getsize(backend._key_to_path(make_key(0)))
    monkeypatch.setattr(
        local_backend, "open",
        lambda *a, **kw: _ShortReads(open(*a, **kw), 7, limit or size),
        raising=False)
    if limit is None:
        assert same(backend.get(make_key(0)), data)
    else:
        with pytest.raises(OSError, match="ended after 100 of"):
            backend.get(make_key(0))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_disk_directories_cross_between_the_packages(tmp_path, writer,
                                                     autorelease):
    """A directory one package's disk tier wrote, the other reads after a
    restart: the same file names, index lines and containers."""
    path = str(tmp_path / "disk")
    data = [b.to(torch.bfloat16) for b in blobs(3, seed=5)]
    keys = [make_key(i) for i in range(3)]
    if writer == "jax":
        jd = JDisk(path)
        for k, b in zip(keys, data):
            jd.put(JKey.from_string(k.to_string()),
                   b.view(torch.int16).numpy().view(ml_dtypes.bfloat16))
        jd.close()
        reader = autorelease(LMCLocalDiskBackend(path))
        for k, b in zip(keys, data):
            assert same(reader.get(k), b)
    else:
        td = autorelease(LMCLocalDiskBackend(path))
        for k, b in zip(keys, data):
            td.put(k, b, blocking=False)
        td.close()
        jd = JDisk(path)
        for k, b in zip(keys, data):
            got = jd.get(JKey.from_string(k.to_string()))
            assert got.dtype == ml_dtypes.bfloat16
            np.testing.assert_array_equal(
                got.view(np.uint16), b.view(torch.int16).numpy().view(
                    np.uint16))
        jd.close()


def test_disk_tier_under_the_cache_engine_snapshots_the_callers_tensor(
        tmp_path):
    """A non-blocking store of a pool view that is overwritten at once
    still writes the stored values, and a fresh engine on the directory
    retrieves them."""
    cfg = tpkg.LMCacheEngineConfig(local_device=str(tmp_path / "kv"),
                                   chunk_size=16)
    tokens = np.arange(40, dtype=np.int32)
    pool = torch.randn(2, 2, 40, 2, 8)
    want = pool.clone()
    a = tpkg.LMCacheEngine(cfg, META)
    assert a.store(tokens, pool, blocking=False) == 3
    pool.zero_()
    a.close()
    b = tpkg.LMCacheEngine(cfg, META)
    blob, mask = b.retrieve(tokens, return_tuple=False)
    assert mask.all() and same(blob, want)
    b.close()


# -- the hybrid tier ----------------------------------------------------------

def test_hybrid_write_through_and_fill(server, autorelease):
    backend = autorelease(CreateStorageBackend(hybrid_cfg(server), META))
    key, blob = make_key(200), blobs(1)[0]
    backend.put(key, blob)
    backend.remote.flush()
    assert backend.remote.contains(key)
    # a fresh hybrid on the same server prefetches the key at startup
    backend2 = autorelease(CreateStorageBackend(hybrid_cfg(server), META))
    assert backend2.local.contains(key)
    assert same(backend2.get(key), blob)


def test_hybrid_batched_get_asks_the_remote_for_local_misses(server,
                                                             autorelease):
    backend = autorelease(CreateStorageBackend(
        hybrid_cfg(server, hybrid_prefetch_chunks=0), META))
    (a, b), keys = blobs(2, seed=3), [make_key(300), make_key(301)]
    backend.local.put(keys[0], a)
    backend.remote.put(keys[1], b)  # the remote only: a read-through
    asked = []
    batched_get = backend.remote.batched_get

    def recording(ks):
        ks = list(ks)
        asked.append(ks)
        return batched_get(ks)

    backend.remote.batched_get = recording
    results = list(backend.batched_get(keys + [make_key(302)]))
    assert same(results[0], a) and same(results[1], b)
    assert results[2] is None
    assert asked == [[keys[1], make_key(302)]]
    backend.local.flush()  # the read-through fill is a non-blocking put
    assert backend.local.contains(keys[1])
    assert same(backend.local.get(keys[1]), b)


def test_hybrid_cachegen_chunks_are_decoded_before_the_local_tier(
        server, autorelease):
    """Over the CacheGen serde the remote tier yields undecoded host chunks;
    the prefetch and the read-through fill store decoded blobs, equal to
    the remote path's own decode of the same containers."""
    cfg = hybrid_cfg(server, remote_serde="cachegen",
                     hybrid_prefetch_chunks=1)
    meta = tpkg.LMCacheEngineMetadata("cg-model", 1, 0, "vllm")
    seeder = autorelease(CreateStorageBackend(cfg, meta))
    keys = [CacheEngineKey("vllm", "cg-model", 1, 0, f"h{i}")
            for i in range(2)]
    for k, b in zip(keys, blobs(2, seed=4)):
        seeder.put(k, b)
    seeder.flush()
    want = [seeder.remote.get(k) for k in keys]
    fresh = autorelease(CreateStorageBackend(cfg, meta))
    assert [fresh.local.contains(k) for k in keys] == [False, True]
    got = list(fresh.batched_get(keys))
    fresh.flush()
    for k, g, w in zip(keys, got, want):
        assert isinstance(g, torch.Tensor) and same(g, w)
        assert same(fresh.local.get(k), w)


def test_hybrid_prefetch_is_bounded(server, autorelease):
    seeder = autorelease(CreateStorageBackend(hybrid_cfg(server), META))
    data = blobs(6, seed=9)
    keys = [make_key(500 + i) for i in range(6)]
    for k, blob in zip(keys, data):
        seeder.put(k, blob)
    seeder.remote.flush()

    def warmed(**kw):
        b = autorelease(CreateStorageBackend(hybrid_cfg(server, **kw),
                                             META))
        b.wait_prefetch()
        return b, [b.local.contains(k) for k in keys]

    # the chunk budget: the 2 newest chunks
    b, w = warmed(hybrid_prefetch_chunks=2)
    assert w == [False] * 4 + [True] * 2
    assert same(b.get(keys[0]), data[0])  # a cold chunk reads through
    # the byte budget stops once the newest-first fetch reaches it
    _, w = warmed(hybrid_prefetch_chunks=None,
                  hybrid_prefetch_bytes=data[0].nbytes)
    assert w == [False] * 5 + [True]
    # the local tier's capacity bounds it too
    _, w = warmed(hybrid_prefetch_chunks=None,
                  local_capacity_bytes=2 * data[0].nbytes)
    assert w == [False] * 4 + [True] * 2
    _, w = warmed(hybrid_prefetch_chunks=0)
    assert not any(w)
    _, w = warmed(hybrid_prefetch_async=True)
    assert all(w)


def test_hybrid_flush_makes_async_puts_durable(server, autorelease):
    b1 = autorelease(CreateStorageBackend(hybrid_cfg(server), META))
    key, blob = make_key(700), blobs(1, seed=9)[0]
    b1.put(key, blob, blocking=False)
    b1.flush()
    b2 = autorelease(CreateStorageBackend(
        hybrid_cfg(server, hybrid_prefetch_chunks=0), META))
    assert b2.contains(key) and same(b2.get(key), blob)


def test_hybrid_over_a_jax_written_store(server, autorelease):
    """Containers the JAX package's hybrid tier wrote through to the server
    warm the port's hybrid tier."""
    jb = JCreate(jpkg.LMCacheEngineConfig(local_device="cpu",
                                          remote_url=server), JMETA)
    key, blob = make_key(800), blobs(1, seed=11)[0]
    jb.put(JKey.from_string(key.to_string()), blob.numpy())
    jb.close()
    tb = autorelease(CreateStorageBackend(hybrid_cfg(server), META))
    assert tb.local.contains(key) and same(tb.get(key), blob)


# -- raw_zstd and safetensors -------------------------------------------------

def _jax_array(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("serde", ["raw_zstd", "safetensors", "safetensor"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_serde_containers_cross_between_the_packages(serde, dtype):
    cfg = tpkg.LMCacheEngineConfig(local_device="cpu")
    s, d = CreateSerde(serde, cfg, META)
    js, jd = JSerde(serde, jpkg.LMCacheEngineConfig(local_device="cpu"),
                    JMETA)
    x = blobs(1, seed=2)[0].mul(30).to(getattr(torch, dtype))
    want = js.to_bytes(_jax_array(x))
    got = s.to_bytes(x)
    assert got == want
    back = d.from_bytes(want)
    assert back.dtype == x.dtype and same(back, x)
    jback = jd.from_bytes(got)
    assert jback.dtype.name == dtype
    np.testing.assert_array_equal(jback.view(np.uint8),
                                  _jax_array(x).view(np.uint8))


def test_raw_zstd_through_the_remote_tier(server, autorelease):
    cfg = tpkg.LMCacheEngineConfig(local_device=None, remote_url=server,
                                   remote_serde="raw_zstd")
    backend = autorelease(CreateStorageBackend(cfg, META))
    key, blob = make_key(900), torch.zeros(2, 2, 8, 2, 4)
    backend.put(key, blob)
    raw = backend.connection.get(key.to_string())
    assert len(raw) < blob.nbytes and same(backend.get(key), blob)


@pytest.mark.parametrize("serde,package", [("raw_zstd", "zstandard"),
                                           ("safetensors", "safetensors")])
def test_serde_without_its_package_raises(serde, package, monkeypatch):
    cfg = tpkg.LMCacheEngineConfig(local_device="cpu")
    s, _ = CreateSerde(serde, cfg, META)
    monkeypatch.setitem(sys.modules, package, None)
    with pytest.raises(ImportError, match=package):
        s.to_bytes(torch.zeros(4))


# -- redis and sentinel -------------------------------------------------------

@pytest.mark.parametrize("url", ["redis://localhost:6379",
                                 "redis-sentinel://localhost:26379,"
                                 "localhost:26380"])
def test_redis_connectors_share_the_jax_connectors_store(url):
    t, j = CreateConnector(url), JConnector(url)
    assert type(t).__name__ == type(j).__name__
    t.set("a", b"1")
    j.set("b", b"22")
    assert j.get("a") == b"1" and t.get("b") == b"22"
    assert sorted(t.list()) == sorted(j.list()) == ["a", "b"]
    assert t.batched_exists(["a", "x", "b"]) == j.batched_exists(
        ["a", "x", "b"]) == [True, False, True]
    assert t.exists("a") and not t.exists("x")
    assert t.batched_exists([]) == []
    t.close()
    j.close()


def test_redis_remote_tier(autorelease):
    cfg = tpkg.LMCacheEngineConfig(local_device=None,
                                   remote_url="redis://localhost:6379")
    backend = autorelease(CreateStorageBackend(cfg, META))
    key, blob = make_key(), blobs(1)[0]
    backend.put(key, blob)
    assert backend.contains(key) and same(backend.get(key), blob)
    assert key in backend.list()
    jb = JCreate(jpkg.LMCacheEngineConfig(
        local_device=None, remote_url="redis://localhost:6379"), JMETA)
    np.testing.assert_array_equal(
        np.asarray(jb.get(JKey.from_string(key.to_string()))), blob.numpy())
    jb.close()


def test_redis_without_the_package_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "redis", None)
    for url in ("redis://localhost:6379", "redis-sentinel://h:1,h:2"):
        with pytest.raises(ImportError, match="redis-py is required"):
            CreateConnector(url)
    with pytest.raises(ValueError, match="Multiple hosts"):
        CreateConnector("redis://h:1,h:2")
