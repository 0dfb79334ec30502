"""The port's native transport (``lmcache_tpu_torch.net``, the C++ client of
``net/csrc/lmtc_net.cc`` built by ``g++`` at first use) and the connector
over it, on the CPU, against the port's cache server (started once for the
module) and the JAX package's (the ``lmserver_process`` fixture):

- a round trip of PUT, GET and EXIST through the native client;
- interop both ways with the Python client, and with the JAX package's
  server and native client;
- ``LMCServerConnector`` raising where the native transport cannot be
  built or cannot connect, and ``use_native=False`` taking the Python
  client for every command;
- a reconnect once when the server restarts;
- the grouped, range-coded remote inject through the native transport
  putting exactly the KV of ``retrieve()`` into the pool, as through the
  Python one.
"""

import dataclasses
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from lmcache_tpu.models import llama as jl  # noqa: E402
from lmcache_tpu.net import NativeSocketClient as JNative  # noqa: E402
from lmcache_tpu.storage.connector.lm_connector import (  # noqa: E402
    LMCServerConnector as JConnector)
import lmcache_tpu_torch as tpkg  # noqa: E402
from lmcache_tpu_torch import net as tnet  # noqa: E402
from lmcache_tpu_torch.models import llama as tl  # noqa: E402
from lmcache_tpu_torch.serving import (Request, SamplingParams,  # noqa: E402
                                       ServingEngine)
from lmcache_tpu_torch.storage.connector import lm_connector  # noqa: E402
from lmcache_tpu_torch.storage.connector.lm_connector import (  # noqa: E402
    LMCServerConnector)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 16
PROMPT = 70  # four whole chunks and a trailing chunk of 6 tokens


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start_server(port):
    proc = subprocess.Popen(
        [sys.executable, "-m", "lmcache_tpu_torch.server", "localhost",
         str(port), "cpu"], cwd=ROOT)
    deadline = time.time() + 30
    while True:
        try:
            socket.create_connection(("localhost", port), 0.5).close()
            return proc
        except OSError:
            if time.time() > deadline or proc.poll() is not None:
                proc.kill()
                raise RuntimeError("cache server failed to start")
            time.sleep(0.05)


def _stop(proc):
    proc.terminate()
    proc.wait(timeout=10)


@pytest.fixture(scope="module")
def server():
    port = _free_port()
    proc = _start_server(port)
    try:
        yield port
    finally:
        _stop(proc)


def _payload(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def test_native_round_trip(server):
    c = tnet.NativeSocketClient("localhost", server)
    try:
        big = _payload(3 << 20, 0)
        c.set("rt-big", big)
        c.set("rt-empty", b"")
        got = c.get("rt-big")
        assert isinstance(got, memoryview) and got == big
        assert np.frombuffer(got, np.uint8).flags.writeable  # no copy made
        assert len(c.get("rt-empty")) == 0
        assert c.get("rt-missing") is None
        assert c.exists("rt-big") and not c.exists("rt-missing")
    finally:
        c.close()


@pytest.mark.parametrize("writer", ["native", "python"])
def test_native_and_python_clients_interoperate(server, writer):
    native = LMCServerConnector("localhost", server)
    python = LMCServerConnector("localhost", server, use_native=False)
    try:
        assert native.native is not None and python.native is None
        w, r = (native, python) if writer == "native" else (python, native)
        data = _payload(70001, 1)
        w.set(f"io-{writer}", data)
        assert r.get(f"io-{writer}") == data
        assert r.exists(f"io-{writer}")
        assert r.batched_exists([f"io-{writer}", "io-none"]) == [True, False]
        assert f"io-{writer}" in r.list()
    finally:
        native.close()
        python.close()


@pytest.mark.parametrize("lmserver_process", ["cpu"], indirect=True)
def test_interop_with_the_jax_server_and_client(lmserver_process, server):
    """The port's native client against the JAX package's server, and the
    JAX package's native client against the port's server."""
    data = _payload(50000, 2)
    port_client = tnet.NativeSocketClient("localhost",
                                          lmserver_process.port_)
    jax_client = JNative("localhost", server)
    try:
        port_client.set("jx-a", data)
        assert port_client.get("jx-a") == data
        assert JConnector("localhost", lmserver_process.port_,
                          use_native=False).get("jx-a") == data
        jax_client.set("jx-b", data)
        assert tnet.NativeSocketClient("localhost", server).get(
            "jx-b") == data
        assert jax_client.get("jx-b") == data
        assert port_client.exists("jx-a") and jax_client.exists("jx-b")
    finally:
        port_client.close()
        jax_client.close()


def test_native_transport_raises_when_it_cannot_build_or_connect(
        server, monkeypatch, tmp_path):
    with socket.socket() as s:  # a port nothing listens on
        s.bind(("localhost", 0))
        closed = s.getsockname()[1]
    with pytest.raises(ConnectionError, match="connect"):
        tnet.NativeSocketClient("localhost", closed)

    monkeypatch.setattr(tnet, "CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(tnet, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnet, "_lib", None)
    monkeypatch.setattr(tnet, "_build_error", None)
    assert not tnet.native_transport_available()
    with pytest.raises(RuntimeError, match="could not be built"):
        LMCServerConnector("localhost", server)
    with pytest.raises(RuntimeError, match="could not be built"):
        tpkg.LMCacheEngine(
            tpkg.LMCacheEngineConfig(local_device=None,
                                     remote_url=f"lm://localhost:{server}"),
            tpkg.LMCacheEngineMetadata(model_name="no-build", world_size=1,
                                       worker_id=0, fmt="vllm",
                                       dtype="float32"))
    # the Python client needs no build
    python = LMCServerConnector("localhost", server, use_native=False)
    python.set("nb", b"abc")
    assert python.get("nb") == b"abc"
    python.close()


def test_use_native_false_takes_the_python_client(server, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the native client was used")

    monkeypatch.setattr(lm_connector, "NativeSocketClient", refuse)
    c = LMCServerConnector("localhost", server, use_native=False)
    try:
        c.set("py", b"xyz")
        got = c.get("py")
        assert type(got) is bytes and got == b"xyz"
        assert c.exists("py") and c.get("py-missing") is None
        assert c.ping()
    finally:
        c.close()
    with pytest.raises(AssertionError, match="native client was used"):
        LMCServerConnector("localhost", server)


def test_native_client_reconnects_once_after_a_server_restart():
    port = _free_port()
    proc = _start_server(port)
    c = tnet.NativeSocketClient("localhost", port)
    try:
        c.set("before", b"1")
        _stop(proc)
        proc = _start_server(port)  # same port, empty store
        c.set("after", b"22")  # the dead connection is replaced once
        assert c.get("after") == b"22" and c.get("before") is None
        _stop(proc)
        with pytest.raises(ConnectionError):
            c.get("after")
    finally:
        c.close()
        if proc.poll() is None:
            _stop(proc)


@pytest.fixture(scope="module")
def model():
    jcfg = jl.LlamaConfig.tiny(n_layers=2)
    jparams = jl.init_params(jax.random.PRNGKey(3), jcfg)
    tcfg = tl.LlamaConfig(**dataclasses.asdict(jcfg))
    return tcfg, tl.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                    device="cpu")


def _tier(port, name, dtype, transport, pipelined=True, mode="auto"):
    ce = tpkg.LMCacheEngine(
        tpkg.LMCacheEngineConfig(
            local_device=None, remote_url=f"lm://localhost:{port}",
            remote_serde="cachegen", chunk_size=CHUNK,
            pipelined_backend=pipelined, remote_device="cpu",
            cachegen_device_decode=mode, cachegen_device_encode=mode),
        tpkg.LMCacheEngineMetadata(model_name=name, world_size=1,
                                   worker_id=0, fmt="vllm", dtype=dtype))
    if transport == "python":
        ce.engine_.connection.close()
        ce.engine_.connection = LMCServerConnector("localhost", port,
                                                   use_native=False)
    assert (ce.engine_.connection.native is None) == (transport == "python")
    return ce


@pytest.mark.parametrize("transport", ["native", "python"])
def test_grouped_inject_through_each_transport_equals_retrieve(
        server, model, transport):
    """The grouped host-chunk inject (two chunks a group) of containers
    fetched through ``transport`` puts exactly the KV of retrieve() with
    the host decoder (fetched through the other transport) into the pool."""
    tcfg, tparams = model
    name = f"native-grouped-{transport}"
    prompt = np.random.default_rng(11).integers(0, tcfg.vocab_size, PROMPT,
                                                dtype=np.int32)
    cache = tl.new_kv_cache(tcfg, 1, 128, device="cpu")
    _, cache = tl.forward(tparams, tcfg, torch.as_tensor(prompt)[None].long(),
                          torch.zeros(1, dtype=torch.int32), cache)
    other = "python" if transport == "native" else "native"
    seed = _tier(server, name, tcfg.dtype, other, pipelined=False)
    assert seed.store(prompt, tl.cache_to_blob(cache, 0, PROMPT),
                      blocking=True) == 5
    seed.close()
    ce = _tier(server, name, tcfg.dtype, transport)
    ref = _tier(server, name, tcfg.dtype, other, pipelined=False, mode="off")
    try:
        eng = ServingEngine(tcfg, tparams, max_batch=2, max_seq=128,
                            cache_engine=ce, device="cpu")
        eng.inject_group_chunks = 2
        req = Request(prompt, SamplingParams(max_new_tokens=4))
        eng.add_request(req)
        while not req.output_tokens:
            eng.step()
        assert req.cached_prefix_len == PROMPT - 1
        blob, mask = ref.retrieve(prompt, return_tuple=False)
        assert int(mask.sum()) == PROMPT
        eng._inject(blob, 1 - req.slot, 0)
        n = PROMPT - 1
        assert torch.equal(eng.kv_pool[:, :, req.slot, :, :n],
                           eng.kv_pool[:, :, 1 - req.slot, :, :n])
        eng.run()
    finally:
        ce.close()
        ref.close()
