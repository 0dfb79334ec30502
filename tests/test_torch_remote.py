"""The port's remote tier and the grouped host-chunk inject of both engines,
on the CPU, against a cache server the module starts once
(``python -m lmcache_tpu_torch.server``).

- raw containers round-trip exactly through the server;
- a store with the CacheGen serde and a fresh pipelined instance: the
  grouped, range-coded inject puts exactly the KV of ``retrieve()`` +
  ``_inject`` into the pool (the dense native and int8 pools, the paged
  bf16/fp32 and int8 arenas), with ``inject_group_chunks = 2`` so that the
  group boundaries move;
- a store-back with ``blocking=False`` whose slot is reused at once stores
  the old request's KV;
- the JAX package's engine serves a prompt from containers the port wrote,
  with the port engine's tokens.
"""

import dataclasses
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import lmcache_tpu as jpkg  # noqa: E402
from lmcache_tpu.models import llama as jl  # noqa: E402
from lmcache_tpu.serving import SamplingParams as JSampling  # noqa: E402
from lmcache_tpu.serving import ServingEngine as JEngine  # noqa: E402
import lmcache_tpu_torch as tpkg  # noqa: E402
from lmcache_tpu_torch import kv  # noqa: E402
from lmcache_tpu_torch.chunks import prefix_chunk_hashes  # noqa: E402
from lmcache_tpu_torch.models import llama as tl  # noqa: E402
from lmcache_tpu_torch.serving import PagedServingEngine  # noqa: E402
from lmcache_tpu_torch.serving import Request, SamplingParams  # noqa: E402
from lmcache_tpu_torch.serving import ServingEngine  # noqa: E402


# every test of this file on one torch thread (an autouse fixture)
from torch_test_helpers import one_torch_thread  # noqa: E402,F401


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 16
PROMPT = 70  # four whole chunks and a trailing chunk of 6 tokens


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


@pytest.fixture(scope="module")
def model():
    jcfg = jl.LlamaConfig.tiny(n_layers=2)
    jparams = jl.init_params(jax.random.PRNGKey(3), jcfg)
    tcfg = tl.LlamaConfig(**dataclasses.asdict(jcfg))
    tparams = tl.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
    return jcfg, jparams, tcfg, tparams


def _cache_engine(url, name, dtype, serde="cachegen", pipelined=True,
                  mode="auto"):
    cfg = tpkg.LMCacheEngineConfig(
        local_device=None, remote_url=url, remote_serde=serde,
        chunk_size=CHUNK, pipelined_backend=pipelined, remote_device="cpu",
        cachegen_device_decode=mode, cachegen_device_encode=mode)
    return tpkg.LMCacheEngine(cfg, tpkg.LMCacheEngineMetadata(
        model_name=name, world_size=1, worker_id=0, fmt="vllm", dtype=dtype))


def _prompt(vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, PROMPT,
                                                dtype=np.int32)


def _seed_store(url, name, tcfg, tparams, prompt):
    """Store the prompt's KV (one prefill) through a separate instance."""
    cache = tl.new_kv_cache(tcfg, 1, 128, device="cpu")
    _, cache = tl.forward(tparams, tcfg, torch.as_tensor(prompt)[None].long(),
                          torch.zeros(1, dtype=torch.int32), cache)
    ce = _cache_engine(url, name, tcfg.dtype, pipelined=False)
    assert ce.store(prompt, tl.cache_to_blob(cache, 0, len(prompt)),
                    blocking=True) == 5
    ce.close()


def _admit(eng, prompt):
    """Admit one request and run it to the end of its prefill (it keeps its
    slot and pages: it has a token left to decode)."""
    req = Request(prompt, SamplingParams(max_new_tokens=8))
    eng.add_request(req)
    while not (eng.running or req.output_tokens):
        eng.step()
    return req


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_raw_serde_round_trips_exactly(server, dtype, pipelined):
    ce = _cache_engine(server, f"raw-{dtype}-{pipelined}", "float32",
                       serde="raw", pipelined=pipelined)
    try:
        tokens = np.arange(40, dtype=np.int32)
        blob = torch.randn(2, 2, 40, 2, 8,
                           generator=torch.Generator().manual_seed(0)).to(
                               dtype)
        assert ce.store(tokens, blob, blocking=True) == 3
        got, mask = ce.retrieve(tokens, return_tuple=False)
        assert mask.all() and got.dtype == dtype and torch.equal(got, blob)
        assert ce.lookup(tokens) == 40
    finally:
        ce.close()


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_grouped_inject_equals_retrieve_dense(server, model, kv_dtype):
    """The grouped host-chunk inject (range decode of two chunks a group)
    puts exactly the KV of retrieve() + _inject into the pool."""
    _, _, tcfg, tparams = model
    name = f"dense-grouped-{kv_dtype}"
    prompt = _prompt(tcfg.vocab_size, 11)
    _seed_store(server, name, tcfg, tparams, prompt)
    ce = _cache_engine(server, name, tcfg.dtype)
    ref = _cache_engine(server, name, tcfg.dtype, pipelined=False, mode="off")
    try:
        eng = ServingEngine(tcfg, tparams, max_batch=2, max_seq=128,
                            cache_engine=ce, device="cpu", kv_dtype=kv_dtype)
        eng.inject_group_chunks = 2
        groups = []
        finish = eng._finish_group
        eng._finish_group = lambda g: groups.append(len(g)) or finish(g)
        req = _admit(eng, prompt)
        # all 70 tokens are stored; the engine recomputes >= 1 token
        assert req.cached_prefix_len == PROMPT - 1
        assert groups == [2, 2, 1]  # the short trailing chunk ends alone
        blob, mask = ref.retrieve(prompt, return_tuple=False)
        assert int(mask.sum()) == PROMPT
        eng._inject(blob, 1, 0)  # slot 1 is free
        pool = eng.kv_pool
        if kv_dtype == "int8":
            for name_, t in pool.items():
                got, want = t[:, :, req.slot], t[:, :, 1]
                n = PROMPT - 1
                if name_ == "sym":
                    got, want = got[..., :n, :], want[..., :n, :]
                else:
                    got, want = got[..., :n], want[..., :n]
                assert torch.equal(got, want)
        else:
            assert torch.equal(pool[:, :, req.slot, :, :PROMPT - 1],
                               pool[:, :, 1, :, :PROMPT - 1])
        eng.run()
    finally:
        ce.close()
        ref.close()


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_grouped_inject_equals_retrieve_paged(server, model, kv_dtype):
    """The same on the paged engine: whole pages only (page 8), so the
    inject stops at 64 tokens; the pages hold what retrieve() +
    _inject_pages writes."""
    _, _, tcfg, tparams = model
    name = f"paged-grouped-{kv_dtype}"
    prompt = _prompt(tcfg.vocab_size, 12)
    _seed_store(server, name, tcfg, tparams, prompt)
    ce = _cache_engine(server, name, tcfg.dtype)
    ref = _cache_engine(server, name, tcfg.dtype, pipelined=False, mode="off")
    try:
        eng = PagedServingEngine(tcfg, tparams, max_batch=2, max_seq=128,
                                 num_pages=40, page_size=8, cache_engine=ce,
                                 device="cpu", kv_dtype=kv_dtype)
        eng.inject_group_chunks = 2
        req = _admit(eng, prompt)
        assert req.cached_prefix_len == 64
        pages = eng._req_pages[req.request_id][:8]
        got = eng._read_pages(pages)
        blob, _ = ref.retrieve(prompt, return_tuple=False)
        spare = eng._alloc_pages(8)
        eng._inject_pages(blob[:, :, :64], spare)
        assert torch.equal(got, eng._read_pages(spare))
        eng.run()
    finally:
        ce.close()
        ref.close()


def test_nonblocking_store_back_keeps_the_old_requests_kv(server, model):
    """ServingEngine._store_back hands the tier a view of the pool with
    blocking=False. The tier's encode is held until the slot's next request
    has overwritten the slot: the containers must still be the old
    request's KV."""
    _, _, tcfg, tparams = model
    ce = _cache_engine(server, "store-back", tcfg.dtype, pipelined=False)
    backend = ce.engine_
    gate = threading.Event()
    encode = backend.serializer.to_bytes_batch

    def held(blobs):
        assert gate.wait(timeout=30)
        return encode(blobs)

    backend.serializer.to_bytes_batch = held
    kept = []
    store = ce.store

    def keep_and_store(tokens, kv_tensors, **kw):
        kept.append((np.array(tokens), kv_tensors.clone()))
        return store(tokens, kv_tensors, **kw)

    ce.store = keep_and_store
    try:
        eng = ServingEngine(tcfg, tparams, max_batch=1, max_seq=128,
                            cache_engine=ce, device="cpu")
        a = _prompt(tcfg.vocab_size, 21)[:48]
        b = _prompt(tcfg.vocab_size, 22)[:48]
        eng.generate([a], SamplingParams(max_new_tokens=2))
        (tokens_a, blob_a), = kept
        req_b = _admit(eng, b)  # reuses slot 0, overwrites A's KV
        assert not torch.equal(tl.cache_to_blob(eng.kv_pool, 0, 48),
                               blob_a)
        gate.set()
        backend.flush()
        eng.run()
        assert req_b.cached_prefix_len == 0
        keys = [ce._make_key(h, "vllm")
                for h in prefix_chunk_hashes(tokens_a, CHUNK)]
        stored = [backend.connection.get(k.to_string()) for k in keys]
        want = encode(kv.chunk_blob(blob_a, "vllm", CHUNK))
        assert stored == want
    finally:
        gate.set()
        ce.close()


def test_jax_engine_serves_from_the_ports_containers(server, model):
    """Slice-level parity: the port engine stores a prompt through its
    remote CacheGen tier; a fresh port engine and a fresh JAX engine each
    serve the prompt again from those containers: same cached prefix, same
    greedy tokens."""
    jcfg, jparams, tcfg, tparams = model
    name = "cross-package"
    prompt = _prompt(tcfg.vocab_size, 31)
    sp = SamplingParams(max_new_tokens=6)

    ce = _cache_engine(server, name, tcfg.dtype)
    eng = ServingEngine(tcfg, tparams, max_batch=1, max_seq=128,
                        cache_engine=ce, device="cpu")
    eng.generate([prompt], sp)
    ce.engine_.flush()
    port = ServingEngine(tcfg, tparams, max_batch=1, max_seq=128,
                         cache_engine=ce, device="cpu")
    [r_port] = port.generate([prompt], sp)
    ce.close()

    jce = jpkg.LMCacheEngine(
        dataclasses.replace(
            jpkg.LMCacheEngineConfig.from_defaults(
                local_device=None, remote_url=server,
                remote_serde="cachegen", chunk_size=CHUNK,
                pipelined_backend=True),
            cachegen_device_decode="off", cachegen_device_encode="off"),
        jpkg.LMCacheEngineMetadata(model_name=name, world_size=1,
                                   worker_id=0, fmt="vllm",
                                   dtype=jcfg.dtype))
    try:
        jeng = JEngine(jcfg, jparams, max_batch=1, max_seq=128,
                       cache_engine=jce, use_pallas=False)
        [r_jax] = jeng.generate([prompt],
                                JSampling(max_new_tokens=6))
    finally:
        jce.close()
    assert r_port.cached_prefix_len == r_jax.cached_prefix_len > 0
    assert list(r_port.output_tokens) == list(r_jax.output_tokens)
