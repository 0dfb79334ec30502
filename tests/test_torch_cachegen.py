"""The port's CacheGen serde against the JAX package's, byte for byte.

The same KV blobs, made from a seed with numpy, go through the JAX
``CacheGenSerializer`` (host C++ coder, ``cachegen_device_encode="off"``)
and the port's (its plain range encoder on CPU tensors): the containers
must be equal, for both KV formats, full and short chunks (channel groups
1, 4, 8), K/V and latent (N = 1) blobs, ``to_bytes`` and
``to_bytes_batch``. A container written by either package and finished by
the other gives the same blob, bit for bit. The raw serde's containers are
equal too.
"""

import dataclasses

import ml_dtypes
import numpy as np
import pytest
import torch

from lmcache_tpu.config import LMCacheEngineConfig as JaxConfig
from lmcache_tpu.config import LMCacheEngineMetadata as JaxMeta
from lmcache_tpu.storage.serde import cachegen_serde as jcs
from lmcache_tpu.storage.serde import raw_serde as jraw
from lmcache_tpu_torch import LMCacheEngineConfig, LMCacheEngineMetadata
from lmcache_tpu_torch import kv
from lmcache_tpu_torch.storage.serde import cachegen_serde as tcs
from lmcache_tpu_torch.storage.serde import raw_serde as traw

MODEL = "tinyllama-1.1b"


def _jax_serde(fmt, dtype="float32"):
    cfg = dataclasses.replace(
        JaxConfig.from_defaults(remote_serde="cachegen"),
        cachegen_device_encode="off", cachegen_device_decode="off")
    meta = JaxMeta(model_name=MODEL, world_size=1, worker_id=0, fmt=fmt,
                   dtype=dtype)
    return jcs.CacheGenSerializer(cfg, meta), jcs.CacheGenDeserializer(cfg,
                                                                       meta)


def _port_serde(fmt, mode="auto", dtype="float32"):
    cfg = LMCacheEngineConfig(local_device=None, remote_url="lm://localhost:1",
                              remote_serde="cachegen", remote_device="cpu",
                              cachegen_device_encode=mode,
                              cachegen_device_decode=mode)
    meta = LMCacheEngineMetadata(model_name=MODEL, world_size=1, worker_id=0,
                                 fmt=fmt, dtype=dtype)
    return tcs.CacheGenSerializer(cfg, meta), tcs.CacheGenDeserializer(cfg,
                                                                       meta)


def _blob(fmt, L, T, H, D, N=2, seed=0, bf16=False):
    """(numpy blob for the JAX side, tensor for the port) of one chunk."""
    rng = np.random.default_rng(seed)
    shape = (L, N, T, H, D) if fmt == "vllm" else (L, N, H, T, D)
    x = (rng.standard_normal(shape) * rng.random(shape[:3] + (1, 1))
         ).astype(np.float32)
    if bf16:
        return x.astype(ml_dtypes.bfloat16), torch.from_numpy(x).bfloat16()
    return x, torch.from_numpy(x.copy())


# (T, channel group g): a full chunk and the short chunks of
# tests/test_cachegen.py::test_cachegen_short_chunk_grouping
CHUNKS = [(256, 1), (64, 4), (32, 8)]


@pytest.mark.parametrize("fmt", ["vllm", "huggingface"])
@pytest.mark.parametrize("T, g", CHUNKS, ids=[f"T{t}_g{g}" for t, g in CHUNKS])
def test_to_bytes_equals_the_jax_container(fmt, T, g):
    L, H, D = 3, 2, 32
    jblob, tblob = _blob(fmt, L, T, H, D, seed=T)
    want = _jax_serde(fmt)[0].to_bytes(jblob)
    got = _port_serde(fmt)[0].to_bytes(tblob)
    assert got == want
    assert tcs._parse_container(got).g == g


def test_bf16_container_names_its_dtype_like_jax():
    """The dtype string is numpy's ("bfloat16"), not torch's."""
    jblob, tblob = _blob("vllm", 2, 64, 2, 32, seed=4, bf16=True)
    want = _jax_serde("vllm", "bf16")[0].to_bytes(jblob)
    got = _port_serde("vllm", dtype="bf16")[0].to_bytes(tblob)
    assert got == want
    assert b"bfloat16" in got[:20]


def test_latent_container_equals_the_jax_container():
    """An MLA latent blob [L, 1, T, 1, r+p]: container v3, N = 1, the
    latent bin schedule and at least 4 channels a group."""
    jblob, tblob = _blob("vllm", 2, 64, 1, 48, N=1, seed=9)
    want = _jax_serde("vllm")[0].to_bytes(jblob)
    got = _port_serde("vllm")[0].to_bytes(tblob)
    assert got == want
    chunk = tcs._parse_container(got)
    assert (chunk.N, chunk.g) == (1, 4)


@pytest.mark.parametrize("fmt", ["vllm", "huggingface"])
def test_to_bytes_batch_equals_the_jax_containers(fmt):
    """Three full chunks and a short trailing one: the batch is byte for
    byte the JAX batch and the port's own per-chunk containers."""
    L, H, D = 2, 2, 32
    pairs = [_blob(fmt, L, 64, H, D, seed=s) for s in range(3)]
    pairs.append(_blob(fmt, L, 22, H, D, seed=7))
    want = _jax_serde(fmt)[0].to_bytes_batch([j for j, _ in pairs])
    ser = _port_serde(fmt)[0]
    got = ser.to_bytes_batch([t for _, t in pairs])
    assert got == want
    assert got == [ser.to_bytes(t) for _, t in pairs]


def test_host_coder_mode_writes_the_same_containers():
    """cachegen_device_encode="off" (the port's own copy of the C++
    coder) writes what the plain encoder writes."""
    _, tblob = _blob("vllm", 2, 64, 2, 32, seed=1)
    assert (_port_serde("vllm", mode="off")[0].to_bytes(tblob)
            == _port_serde("vllm")[0].to_bytes(tblob))


def _containers(fmt, writer, n_full=3, short=22, seed=0):
    """Containers of a run of chunks: n_full chunks of 64 tokens and a
    short trailing chunk, written by ``writer`` ("jax" or "port")."""
    blobs = [_blob(fmt, 2, 64, 2, 32, seed=seed + s) for s in range(n_full)]
    blobs.append(_blob(fmt, 2, short, 2, 32, seed=seed + 9))
    if writer == "jax":
        return _jax_serde(fmt)[0].to_bytes_batch([j for j, _ in blobs])
    return _port_serde(fmt)[0].to_bytes_batch([t for _, t in blobs])


@pytest.mark.parametrize("fmt", ["vllm", "huggingface"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_either_container_finishes_to_the_same_blob(writer, fmt):
    """finish_host_chunks on a uniform run, finish_mixed_chunks over a
    short trailing chunk, with the first chunk sliced from token 5 and the
    last cut to 17 tokens (slice_tokens): the port's blob equals the JAX
    package's, bit for bit, for containers written by either package."""
    bss = _containers(fmt, writer)
    jde, tde = _jax_serde(fmt)[1], _port_serde(fmt)[1]
    jch = [jde.from_bytes_host(bs) for bs in bss]
    tch = [tde.from_bytes_host(bs) for bs in bss]
    want = np.asarray(jcs.finish_host_chunks(jch[:3]))
    got = tcs.finish_host_chunks(tch[:3])
    assert np.array_equal(got.numpy(), want)
    jrun = [jch[0].slice_tokens(5)] + jch[1:3] + [jch[3].slice_tokens(0, 17)]
    trun = [kv.slice_blob_tokens(tch[0], fmt, 5)] + tch[1:3] + [
        kv.slice_blob_tokens(tch[3], fmt, 0, 17)]
    assert [kv.num_tokens_in_blob(c, fmt) for c in trun] == [59, 64, 64, 17]
    want = np.asarray(jcs.finish_mixed_chunks(jrun))
    got = kv.concat_blobs(trun, fmt)
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
    # the host coder's decode ("off") gives the plain decoder's blob
    assert torch.equal(tcs.finish_mixed_chunks(trun, mode="off"), got)


def test_from_bytes_and_to_blob_decode_one_container():
    bs = _containers("vllm", "jax", n_full=1)[0]
    want = np.asarray(_jax_serde("vllm")[1].from_bytes(bs))
    de = _port_serde("vllm")[1]
    assert np.array_equal(de.from_bytes(bs).numpy(), want)
    assert np.array_equal(kv.ensure_blob(de.from_bytes_host(bs)).numpy(),
                          want)


def test_corrupt_containers_raise():
    bs = _containers("vllm", "port", n_full=1)[0]
    with pytest.raises(ValueError, match="Not an LMCG"):
        tcs._parse_container(b"XXXX" + bs[4:])
    with pytest.raises(ValueError, match="Corrupt"):
        tcs._parse_container(bs[:-10])


@pytest.mark.parametrize("where", ["zero-width bin", "nonzero start"])
def test_container_with_a_bad_cdf_raises(where):
    """A CDF that does not rise strictly from 0 is refused before any
    decode: a zero-width bin could collapse the decoder's range."""
    buf = bytearray(_containers("vllm", "port", n_full=1)[0])
    cdf = tcs._parse_container(buf).cdf  # a writable view into buf
    if where == "zero-width bin":
        cdf[1, 5, 7] = cdf[1, 5, 6]
    else:
        cdf[0, 3, 0] = 1
    with pytest.raises(ValueError, match="CDF row"):
        tcs._parse_container(buf)
    with pytest.raises(ValueError, match="CDF row"):
        _port_serde("vllm")[1].from_bytes(bytes(buf))


# ------------------------------------------------------------ raw serde ---

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "int8"])
def test_raw_container_equals_the_jax_container(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 2, 16, 2, 8)).astype(np.float32) * 40
    if dtype == "int8":
        x = np.clip(x, -127, 127)
    jx = x.astype(ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype)
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    want = jraw.encode_array(jx)
    got = traw.encode_array(t)
    assert got == want
    back = traw.decode_array(want)
    assert back.dtype == t.dtype and torch.equal(back, t)
    assert np.array_equal(np.asarray(jraw.decode_array(got)).view(np.uint8),
                          jx.view(np.uint8))


def test_raw_zstd_and_safetensors_round_trip():
    """The serdes that the port refused before: each container decodes in
    the other package, and the JAX package's zstd container in the port's
    raw decoder."""
    from lmcache_tpu.storage.serde import CreateSerde as JSerde
    from lmcache_tpu_torch.storage.serde import CreateSerde
    cfg = LMCacheEngineConfig(local_device=None,
                              remote_url="lm://localhost:1",
                              remote_device="cpu")
    meta = LMCacheEngineMetadata(model_name=MODEL, world_size=1, worker_id=0,
                                 fmt="vllm")
    jcfg = JaxConfig(local_device=None, remote_url="lm://localhost:1")
    jmeta = JaxMeta(model_name=MODEL, world_size=1, worker_id=0, fmt="vllm")
    x = torch.arange(64, dtype=torch.float32).reshape(2, 2, 2, 2, 4)
    for name in ("raw_zstd", "safetensors"):
        s, d = CreateSerde(name, cfg, meta)
        js, jd = JSerde(name, jcfg, jmeta)
        assert torch.equal(d.from_bytes(s.to_bytes(x)), x)
        np.testing.assert_array_equal(jd.from_bytes(s.to_bytes(x)),
                                      x.numpy())
        assert torch.equal(d.from_bytes(js.to_bytes(x.numpy())), x)
    zstd = jraw.encode_array(np.zeros(4, np.float32), compress_level=3)
    assert torch.equal(traw.decode_array(zstd), torch.zeros(4))